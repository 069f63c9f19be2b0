"""Streaming text-to-wav: symbols/pinyin -> mel -> fixed-latency waveform
chunks, with first-chunk latency reporting (counterpart of
``kantts_tpu/bin/stream_tts.py``).

The acoustic forward runs once per sentence and the causal vocoder emits
exact chunks (infer/streaming.py), so audio starts after
    first_chunk_latency = t_acoustic + t_vocoder(chunk)
instead of after whole-utterance synthesis. Writes one wav per sentence and
``streaming_report.json`` (audio seconds, first-chunk latency and RTF per
sentence).

    python -m kantts_tpu_torch.bin.stream_tts --txt in.txt --am_ckpt AM.pt \
        --voc_ckpt VOC.pt --output_dir OUT [--chunk_seconds 0.3] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Iterator, Optional, Union

import numpy as np
import torch

from kantts_tpu_torch.bin.infer_hifigan import load_vocoder
from kantts_tpu_torch.bin.infer_sambert import am_synthesis, load_am
from kantts_tpu_torch.infer.streaming import stream_synthesis
from kantts_tpu_torch.serve.service import resolve_frontend
from kantts_tpu_torch.utils.audio import save_wav
from kantts_tpu_torch.utils.device import resolve_device


class StreamingTTS:
    """Loaded pipeline on ``device``; synthesize() yields waveform chunks as
    they become available."""

    def __init__(self, am_ckpt: str, voc_ckpt: str,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.am_model, self.ling_unit = load_am(am_ckpt, self.device)
        self.voc_model, self.voc_config = load_vocoder(voc_ckpt, self.device)
        if self.voc_model.out_channels != 1:
            raise ValueError("streaming synthesis supports single-band "
                             "causal generators (PQMF multiband is "
                             "whole-utterance only)")
        if not self.voc_model.causal:
            raise ValueError("streaming synthesis requires a causal "
                             "generator config (hifigan_v1_*)")
        if self.voc_model.nsf_params is not None:
            raise ValueError("streaming synthesis does not support NSF "
                             "generators (the harmonic source phase is a "
                             "whole-utterance cumsum)")
        self.sampling_rate = (self.voc_config.get("audio_config", {})
                              .get("sampling_rate", 16000))
        self.hop = int(np.prod(self.voc_model.upsample_scales))

    def synthesize(self, symbol_seq: str, chunk_frames: int = 24
                   ) -> Iterator[np.ndarray]:
        """Yield (chunk_samples, 1) float32 waveform chunks for one
        sentence's symbol sequence."""
        _, mel, _, _, _ = am_synthesis(symbol_seq, self.am_model, self.ling_unit)
        yield from stream_synthesis(self.voc_model, mel, chunk_frames=chunk_frames)

    def warmup(self, symbol_seq: str, chunk_frames: int = 24) -> None:
        """Run both models once, so that first-chunk latency excludes the
        device's cold start."""
        for _ in self.synthesize(symbol_seq, chunk_frames):
            pass


def stream_tts(output_dir: str, am_ckpt: str, voc_ckpt: str,
               text_file: Optional[str] = None,
               symbols_file: Optional[str] = None,
               frontend: Optional[str] = None, speaker: str = "F7",
               lang: str = "PinYin", chunk_seconds: float = 0.3,
               warmup: bool = True,
               device: Union[str, torch.device] = "cuda") -> list:
    """-> the report: per sentence, audio seconds, first-chunk latency and
    RTF (wall clock, the last chunk copied to the host)."""
    tts = StreamingTTS(am_ckpt, voc_ckpt, device)
    os.makedirs(output_dir, exist_ok=True)
    frame_seconds = tts.hop / tts.sampling_rate
    chunk_frames = max(1, int(round(chunk_seconds / frame_seconds)))

    if symbols_file is not None:
        seqs = []
        with open(symbols_file, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) == 2:
                    seqs.append((parts[0], parts[1]))
    else:
        fe = resolve_frontend(frontend)
        with open(text_file, encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
        seqs = [
            (f"{i}_{j}", seq)
            for i, subs in enumerate(fe.text_to_symbols(texts, speaker=speaker,
                                                        lang=lang))
            for j, seq in enumerate([subs] if isinstance(subs, str) else subs)
        ]
    if not seqs:
        raise ValueError("no sentences to synthesize")

    if warmup:
        tts.warmup(seqs[0][1], chunk_frames)

    report = []
    for utt_id, seq in seqs:
        t0 = time.perf_counter()
        chunks = []
        first_latency = None
        for chunk in tts.synthesize(seq, chunk_frames):
            if first_latency is None:
                first_latency = time.perf_counter() - t0
            chunks.append(chunk)
        total = time.perf_counter() - t0
        wav = np.concatenate(chunks)[:, 0]
        audio_s = len(wav) / tts.sampling_rate
        save_wav(wav, os.path.join(output_dir, f"{utt_id}.wav"),
                 tts.sampling_rate)
        report.append({"utt": utt_id, "audio_seconds": audio_s,
                       "first_chunk_latency_s": first_latency,
                       "rtf": total / audio_s, "device": str(tts.device)})
        logging.info("%s: %.2fs audio, first chunk in %.1f ms, RTF %.4f",
                     utt_id, audio_s, first_latency * 1e3, total / audio_s)

    with open(os.path.join(output_dir, "streaming_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description="streaming text/symbols -> wav")
    parser.add_argument("--txt", type=str, default=None)
    parser.add_argument("--symbols_file", type=str, default=None)
    parser.add_argument("--frontend", type=str, default=None)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--am_ckpt", type=str, required=True)
    parser.add_argument("--voc_ckpt", type=str, required=True)
    parser.add_argument("--speaker", type=str, default="F7")
    parser.add_argument("--lang", type=str, default="PinYin")
    parser.add_argument("--chunk_seconds", type=float, default=0.3)
    parser.add_argument("--no_warmup", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if (args.txt is None) == (args.symbols_file is None):
        parser.error("give exactly one of --txt and --symbols_file")
    stream_tts(args.output_dir, args.am_ckpt, args.voc_ckpt, args.txt,
               args.symbols_file, args.frontend, args.speaker, args.lang,
               args.chunk_seconds, warmup=not args.no_warmup, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
