"""End-to-end text to wav: front-end -> SAM-BERT mels -> HiFi-GAN wavs ->
one wav per text line, its sentences joined with 0.28 s of silence and a
0.05 s tail (counterpart of ``kantts_tpu/bin/text_to_wav.py``).

    python -m kantts_tpu_torch.bin.text_to_wav --txt TEXT --am_ckpt AM.pt \
        --voc_ckpt VOC.pt --output_dir OUT [--am_batch B] \
        [--chunked N | --voc_batch B] [--device cuda|cpu]

The checkpoints are the port's own (``models/builder.py``). The last line
of standard output is a JSON object with the run's counts and times.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from kantts_tpu_torch.bin.infer_hifigan import hifigan_infer
from kantts_tpu_torch.bin.infer_sambert import am_infer
from kantts_tpu_torch.serve.service import resolve_frontend
from kantts_tpu_torch.utils.audio import read_wav, save_wav
from kantts_tpu_torch.utils.device import resolve_device, synchronize


def concat_process(chunk_wav_dir: str, output_dir: str,
                   gap_seconds: float = 0.28, tail_seconds: float = 0.05):
    """Join per-sentence wavs named ``{group}_{index}_mel.wav`` into one
    ``{group}.wav`` per group."""
    groups = {}
    for path in sorted(glob.glob(os.path.join(chunk_wav_dir, "*.wav"))):
        stem = os.path.splitext(os.path.basename(path))[0]
        stem = stem[:-len("_mel")] if stem.endswith("_mel") else stem
        group, _, index = stem.rpartition("_")
        if group and index.isdigit():
            groups.setdefault(group, []).append((int(index), path))
        else:
            groups.setdefault(stem, []).append((0, path))
    os.makedirs(output_dir, exist_ok=True)
    for group, parts in groups.items():
        parts.sort()
        pieces, sr = [], None
        for i, (_, path) in enumerate(parts):
            this_sr, wav = read_wav(path)
            sr = sr or this_sr
            pieces.append(wav)
            if i != len(parts) - 1:
                pieces.append(np.zeros(int(gap_seconds * sr), dtype=np.float32))
        pieces.append(np.zeros(int(tail_seconds * sr), dtype=np.float32))
        save_wav(np.concatenate(pieces), os.path.join(output_dir, f"{group}.wav"), sr)


def text_to_wav(output_dir: str, am_ckpt: str, voc_ckpt: str,
                text_file: Optional[str] = None,
                symbols_file: Optional[str] = None,
                frontend: Optional[str] = None, speaker: str = "F7",
                lang: str = "PinYin", am_batch: int = 1, chunked: int = 0,
                voc_batch: int = 1,
                device: Union[str, torch.device] = "cuda",
                se_file: Optional[str] = None) -> dict:
    """Runs on ``device``: "cuda" (the default, which raises without a card)
    or "cpu". ``se_file`` is an SE voice's speaker embedding. Returns the
    run's counts and times: mel frames and seconds of the acoustic model,
    audio and seconds of the vocoder, and the wall time of the whole path."""
    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    synchronize(device)
    t0 = time.perf_counter()
    symbols_path = symbols_file or os.path.join(output_dir, "symbols.lst")
    if symbols_file is None:
        fe = resolve_frontend(frontend)
        with open(text_file, encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
        with open(symbols_path, "w", encoding="utf-8") as f:
            for i, seqs in enumerate(fe.text_to_symbols(texts, speaker=speaker,
                                                        lang=lang)):
                for j, seq in enumerate([seqs] if isinstance(seqs, str) else seqs):
                    f.write(f"{i}_{j}\t{seq}\n")

    am = am_infer(symbols_path, am_ckpt, output_dir, batch=am_batch,
                  device=device, se_file=se_file)
    mel_list = os.path.join(output_dir, "mel.lst")
    with open(mel_list, "w") as f:
        for mel in sorted(glob.glob(os.path.join(output_dir, "feat", "*_mel.npy"))):
            f.write(mel + "\n")
    chunk_dir = os.path.join(output_dir, "wav_chunks")
    voc = hifigan_infer(mel_list, voc_ckpt, chunk_dir, device=device,
                        chunked=chunked, batch=voc_batch)
    concat_process(chunk_dir, os.path.join(output_dir, "res_wavs"))
    synchronize(device)
    total = time.perf_counter() - t0
    return {"device": str(device), "am_frames": am["frames"],
            "am_seconds": am["seconds"], "audio_seconds": voc["audio_seconds"],
            "voc_seconds": voc["seconds"], "total_seconds": total}


def main(argv=None):
    parser = argparse.ArgumentParser(description="text/symbols -> wav")
    parser.add_argument("--txt", type=str, default=None, help="raw text file")
    parser.add_argument("--symbols_file", type=str, default=None,
                        help="precomputed symbol sequences (utt\\tsymbols)")
    parser.add_argument("--frontend", type=str, default=None,
                        help="default: built-in hanzi+pinyin front-end; "
                             "'lexicon:readings.tsv', 'pinyin', or a module "
                             "exposing text_to_symbols()")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--am_ckpt", type=str, required=True)
    parser.add_argument("--voc_ckpt", type=str, required=True)
    parser.add_argument("--speaker", type=str, default="F7")
    parser.add_argument("--se_file", type=str, default=None,
                        help="speaker embedding (.npy) of an SE voice")
    parser.add_argument("--lang", type=str, default="PinYin")
    parser.add_argument("--am_batch", type=int, default=1, metavar="B",
                        help="utterances per acoustic forward")
    parser.add_argument("--chunked", type=int, default=0, metavar="N",
                        help="chunked-batch vocoder synthesis (see "
                             "infer_hifigan --chunked)")
    parser.add_argument("--voc_batch", type=int, default=1, metavar="B",
                        help="cross-utterance batched vocoder synthesis "
                             "(see infer_hifigan --batch)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if (args.txt is None) == (args.symbols_file is None):
        parser.error("give exactly one of --txt and --symbols_file")
    stats = text_to_wav(args.output_dir, args.am_ckpt, args.voc_ckpt, args.txt,
                        args.symbols_file, args.frontend, args.speaker,
                        args.lang, am_batch=args.am_batch, chunked=args.chunked,
                        voc_batch=args.voc_batch, device=args.device,
                        se_file=args.se_file)
    print(json.dumps(stats))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
