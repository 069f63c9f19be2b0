"""Export and run TTS serving artifacts (counterpart of
``kantts_tpu/bin/export_tts.py``).

``export``: package an acoustic-model and vocoder checkpoint pair as
exported programs (``infer/exported.py``). ``synth``: synthesize from an
artifact, the serving side: no model class is built, only the programs.

    python -m kantts_tpu_torch.bin.export_tts export --am_ckpt AM.pt \
        --voc_ckpt VOC.pt --output_dir ART [--max_input_len 96] \
        [--max_output_len N] [--chunked N | --int8] [--platforms cpu,cuda] \
        [--device cuda|cpu]
    python -m kantts_tpu_torch.bin.export_tts synth --artifact ART \
        --symbols_file S --output_dir OUT [--se_file SE.npy] [--device cuda|cpu]

``--symbols_file`` holds ``utt_id<TAB>symbol sequence`` lines (the metafile
format). Both run on the card unless ``--device cpu`` is passed.
"""

from __future__ import annotations

import argparse
import logging
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="TTS serving artifacts")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_exp = sub.add_parser("export", help="checkpoints -> serving artifact")
    p_exp.add_argument("--am_ckpt", required=True)
    p_exp.add_argument("--voc_ckpt", required=True)
    p_exp.add_argument("--output_dir", required=True)
    p_exp.add_argument("--max_input_len", type=int, default=96,
                       help="symbol budget (inputs pad to it)")
    p_exp.add_argument("--max_output_len", type=int, default=None,
                       help="mel budget (default: 24 frames a symbol)")
    p_exp.add_argument("--chunked", type=int, default=0, metavar="N",
                       help="chunked-batch vocoder epilogue (causal fullband)")
    p_exp.add_argument("--int8", action="store_true",
                       help="the int8 W8A8 vocoder (same checkpoint; see "
                            "infer_hifigan --int8)")
    p_exp.add_argument("--platforms", default="cpu,cuda",
                       help="comma-separated devices the artifact may load on")
    p_exp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the checkpoints load and the programs trace")

    p_syn = sub.add_parser("synth", help="artifact + symbols -> wavs")
    p_syn.add_argument("--artifact", required=True)
    p_syn.add_argument("--symbols_file", required=True,
                       help="utt\\tsymbol-sequence lines (metafile format)")
    p_syn.add_argument("--output_dir", required=True)
    p_syn.add_argument("--se_file", default=None,
                       help="speaker embedding .npy for SE artifacts")
    p_syn.add_argument("--device", default="cuda", choices=("cuda", "cpu"))

    args = parser.parse_args(argv)
    if args.cmd == "export":
        from kantts_tpu_torch.infer.exported import export_fused_tts

        t0 = time.perf_counter()
        meta = export_fused_tts(
            args.am_ckpt, args.voc_ckpt, args.output_dir,
            max_input_len=args.max_input_len, max_output_len=args.max_output_len,
            n_chunks=args.chunked, platforms=tuple(args.platforms.split(",")),
            int8=args.int8, device=args.device)
        logging.info("Exported %s (platforms %s, %d frames) to %s in %.1fs",
                     meta["kind"], meta["platforms"], meta["max_output_len"],
                     args.output_dir, time.perf_counter() - t0)
        return

    import numpy as np

    from kantts_tpu_torch.infer.exported import ExportedTTS
    from kantts_tpu_torch.utils.audio import save_wav

    tts = ExportedTTS(args.artifact, device=args.device)
    se = np.load(args.se_file) if args.se_file else None
    os.makedirs(args.output_dir, exist_ok=True)
    sr = tts.meta["sampling_rate"]
    with open(args.symbols_file, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            utt_id, symbols = line.strip().split("\t", 1)
            t0 = time.perf_counter()
            wav, _ = tts.synthesize(symbols, se=se)
            dt = time.perf_counter() - t0
            save_wav(wav, os.path.join(args.output_dir, f"{utt_id}.wav"), sr)
            logging.info("%s: %.2fs audio in %.3fs (%.0fx RT)", utt_id,
                         len(wav) / sr, dt, len(wav) / sr / max(dt, 1e-9))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
