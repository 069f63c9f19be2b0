"""Online TTS server CLI: dynamic-batching HTTP synthesis on one device
(counterpart of ``kantts_tpu/bin/serve_tts.py``).

Loads the acoustic model and vocoder checkpoints once, then serves
``POST /tts``, ``POST /tts/stream`` and ``GET /healthz``, coalescing
concurrent traffic into batched calls (serve/service.py).

    python -m kantts_tpu_torch.bin.serve_tts --am_ckpt AM.pt \
        --voc_ckpt VOC.pt --port 8272 --max_batch 8 --max_wait_ms 20 \
        [--warmup_text 'ni3 hao3'] [--device cuda|cpu]

    curl -s localhost:8272/tts -d '{"text": "ni3 hao3"}' \
         -H 'Content-Type: application/json' > out.wav

SIGTERM drains: the server stops accepting, in-flight batches finish, and
the process exits 0.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from kantts_tpu_torch.serve import TTSService, make_http_server


def main(argv=None):
    parser = argparse.ArgumentParser(description="dynamic-batching TTS server")
    parser.add_argument("--am_ckpt", type=str, required=True)
    parser.add_argument("--voc_ckpt", type=str, required=True)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8272)
    parser.add_argument("--frontend", type=str, default=None,
                        help="text front-end (see text_to_wav --frontend); "
                             "default: the in-tree hanzi+pinyin front-end")
    parser.add_argument("--speaker", type=str, default="F7")
    parser.add_argument("--lang", type=str, default="PinYin")
    parser.add_argument("--se_file", type=str, default=None,
                        help="speaker embedding (.npy) of an SE voice")
    parser.add_argument("--max_batch", type=int, default=8,
                        help="utterances per batched call (the fixed batch dim)")
    parser.add_argument("--max_wait_ms", type=float, default=20.0,
                        help="batching window after the first request")
    parser.add_argument("--int8", action="store_true",
                        help="int8 W8A8 vocoding (not ported yet: raises)")
    parser.add_argument("--warmup_text", type=str, default=None,
                        help="synthesize this text once before binding the "
                             "port, so the first live request skips the "
                             "cold start (e.g. 'ni3 hao3')")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    service = TTSService.from_checkpoints(
        args.am_ckpt, args.voc_ckpt, frontend=args.frontend,
        se_file=args.se_file, int8=args.int8, device=args.device,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        speaker=args.speaker, lang=args.lang)
    try:
        if args.warmup_text:
            logging.info("warmup: synthesizing %r ...", args.warmup_text)
            dt = service.warmup(args.warmup_text)
            logging.info("warmup done in %.1fs", dt)
        httpd = make_http_server(service, args.host, args.port)
    except BaseException:
        service.close()
        raise
    logging.info("serving on http://%s:%d (POST /tts, POST /tts/stream, "
                 "GET /healthz) on %s; max_batch=%d window=%.0fms", args.host,
                 httpd.server_address[1], service.device, args.max_batch,
                 args.max_wait_ms)
    # SIGTERM (the orchestrator's stop signal) drains like Ctrl-C: stop
    # accepting, finish in-flight batches, exit 0. shutdown() must run off
    # the serve_forever thread, hence the helper thread.
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=httpd.shutdown, daemon=True).start())
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
        logging.info("drained and stopped")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
