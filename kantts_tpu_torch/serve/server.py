"""HTTP front for TTSService: stdlib-only, threading request handlers
(counterpart of ``kantts_tpu/serve/server.py``).

Endpoints:
- ``POST /tts``: body is JSON ``{"text": "...", "symbols": ["..."]}``
  (one of the two keys) or a raw ``text/plain`` utterance. Response:
  ``audio/wav`` (PCM16).
- ``POST /tts/stream``: same request body (``text`` only); response is a
  chunked-transfer stream of raw little-endian PCM16 mono samples
  (``application/octet-stream`` with ``X-Audio-Format: pcm_s16le`` and
  ``X-Sample-Rate`` headers): audio starts after the first vocoder chunk,
  not after whole-utterance synthesis. Causal checkpoints only.
- ``GET /healthz``: JSON service stats (requests/batches/utterances/...).

Handler threads block inside ``TTSService.synthesize`` while the single
coordinator thread batches across them: the HTTP concurrency level is the
batching opportunity.
"""

from __future__ import annotations

import io
import json
import logging
import struct
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """float32 [-1, 1] waveform -> in-memory PCM16 WAV file bytes."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def make_http_server(service, host: str = "127.0.0.1",
                     port: int = 8272) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer serving ``service``; the caller owns the
    serve_forever() loop (bin/serve_tts.py runs it; tests drive it from a
    background thread and shut it down)."""

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for chunked transfer on /tts/stream; _reply always sets
        # Content-Length so keep-alive stays correct on the other routes
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging, not stderr
            logging.info("serve: " + fmt, *args)

        def _reply(self, code: int, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj):
            self._reply(code, json.dumps(obj).encode("utf-8"),
                        "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply_json(200, {"ok": True, **service.stats_snapshot()})
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/tts/stream":
                self._do_stream()
                return
            if self.path != "/tts":
                self._reply_json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    payload = json.loads(raw.decode("utf-8"))
                    if not isinstance(payload, dict):
                        raise ValueError(
                            "JSON body must be an object with a 'text' or "
                            "'symbols' key")
                    if "symbols" in payload:
                        sr, wav = service.synthesize_symbols(
                            list(payload["symbols"]))
                    else:
                        sr, wav = service.synthesize(
                            str(payload["text"]),
                            speaker=payload.get("speaker"),
                            lang=payload.get("lang"))
                else:
                    sr, wav = service.synthesize(raw.decode("utf-8").strip())
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._reply_json(400, {"error": repr(e)})
                return
            except Exception as e:  # synthesis failure: surface, keep serving
                logging.exception("synthesis failed")
                self._reply_json(500, {"error": repr(e)})
                return
            self._reply(200, wav_bytes(wav, sr), "audio/wav")

        def _do_stream(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    payload = json.loads(raw.decode("utf-8"))
                    if not isinstance(payload, dict):
                        raise ValueError(
                            "JSON body must be an object with a 'text' key")
                    text = str(payload["text"])
                    speaker, lang = payload.get("speaker"), payload.get("lang")
                else:
                    text = raw.decode("utf-8").strip()
                    speaker = lang = None
                # service.stream validates eagerly, so request errors still
                # map to a clean 400; past this point the 200 is committed
                # and a failure can only truncate the chunk stream
                chunks = service.stream(text, speaker=speaker, lang=lang)
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._reply_json(400, {"error": repr(e)})
                return
            except Exception as e:
                logging.exception("stream setup failed")
                self._reply_json(500, {"error": repr(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("X-Audio-Format", "pcm_s16le")
            self.send_header("X-Sample-Rate", str(service.sample_rate))
            self.send_header("X-Channels", "1")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for chunk in chunks:
                    pcm = (np.clip(chunk[:, 0], -1.0, 1.0)
                           * 32767.0).astype("<i2").tobytes()
                    self.wfile.write(f"{len(pcm):X}\r\n".encode() + pcm
                                     + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except Exception:
                logging.exception("stream truncated")
                self.close_connection = True

    return ThreadingHTTPServer((host, port), Handler)


def parse_wav_bytes(data: bytes):
    """Inverse of wav_bytes, for clients/tests: -> (sample_rate, float32)."""
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        pcm = struct.unpack(f"<{n}h", w.readframes(n))
    return sr, np.asarray(pcm, dtype=np.float32) / 32767.0
