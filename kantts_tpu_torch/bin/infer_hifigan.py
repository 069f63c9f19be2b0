"""HiFi-GAN vocoder inference: mel npy files -> PCM16 wavs (counterpart of
``kantts_tpu/bin/infer_hifigan.py``).

Weight norm is folded on load. Each mel is zero-padded to a multiple of
``frame_bucket`` frames, synthesized, and cut to ``frames * hop`` samples,
as the JAX package does: a non-causal generator sees the padded frames near
the end, so the padding is part of its output. Three paths:

- plain: one mel per generator call (B=1);
- ``--chunked N``: each mel split into N causal-context windows run as one
  batch (``infer/chunked.py``; causal generators only);
- ``--batch B``: B mels per call, longest first, each group padded to its
  bucket and the batch padded with zero mels.

An NSF generator's input has its uv channel binarised (``binarize``); its
source draws from a ``torch.Generator`` seeded 0 anew for every call, as
the JAX package passes every call the key 0. A multi-band generator's
sub-bands are synthesised by its PQMF filter bank (not with ``--chunked``).

``--int8`` vocodes with int8 W8A8 interior convs (the same float32
checkpoint; kernel K2 on the card), in float32 around them whatever the
config's ``mixed_precision``. Its activation scales are per example, so
``--batch`` gives each utterance what it gets alone; ``--chunked`` is
refused, since a window's scales differ from the whole utterance's.

    python -m kantts_tpu_torch.bin.infer_hifigan --ckpt VOC.pt \
        --input_mel MELS --output_dir OUT [--chunked N | --batch B] [--int8] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import time
from typing import Union

import numpy as np
import torch

from kantts_tpu_torch.infer.chunked import chunked_apply
from kantts_tpu_torch.models.builder import build_pqmf, load_checkpoint
from kantts_tpu_torch.models.hifigan.layers import fold_weight_norm, quantize_weights
from kantts_tpu_torch.utils.audio import save_wav
from kantts_tpu_torch.utils.device import resolve_device, synchronize

INT8_CHUNKED = ("--chunked and --int8 are mutually exclusive: chunked "
                "inference is built on bit-exact windowing, and int8's "
                "dynamic per-example activation scales differ between a "
                "window and the full utterance")


def load_vocoder(ckpt: str, device: torch.device, quant: bool = False):
    """-> (generator with weight norm folded, in eval mode on ``device``,
    its config). ``quant``: the int8 generator, its weights quantized."""
    model, config = load_checkpoint(ckpt, device, quant=quant)
    model = fold_weight_norm(model)
    return (quantize_weights(model) if quant else model), config


def binarize(mel: np.ndarray, threshold: float = 0.6) -> np.ndarray:
    """A copy of an NSF mel (T, C) with its uv channel set to 0/1."""
    res_mel = mel.copy()
    res_mel[:, -1] = np.where(mel[:, -1] < threshold, 0.0, 1.0)
    return res_mel


def vocode(model, pqmf, mel: torch.Tensor, chunked: int = 0) -> torch.Tensor:
    """mel (B, T, C) on the generator's device -> wav (B, T * hop, 1): the
    plain or chunked generator call, then ``pqmf``'s synthesis; an NSF
    source draws from a fresh ``torch.Generator`` seeded 0."""
    rng = torch.Generator(device=mel.device).manual_seed(0)
    if chunked:
        return chunked_apply(model, mel, chunked, rng=rng)
    y = model(mel, generator=rng)
    return pqmf.synthesis(y) if pqmf is not None else y


def bucket_pad(mels, frame_bucket: int, batch: int) -> np.ndarray:
    """(T_i, C) mels -> (batch, L, C) float32, L the longest T_i rounded up
    to a multiple of ``frame_bucket``; each mel zero-padded at its end, the
    batch filled with zero mels."""
    L = int(np.ceil(max(m.shape[0] for m in mels) / frame_bucket) * frame_bucket)
    n_mels = mels[0].shape[1]
    return np.stack(
        [np.pad(m, [(0, L - m.shape[0]), (0, 0)]).astype(np.float32) for m in mels]
        + [np.zeros((L, n_mels), dtype=np.float32)] * (batch - len(mels)))


def hifigan_infer(input_mel: str, ckpt: str, output_dir: str,
                  device: Union[str, torch.device] = "cuda",
                  frame_bucket: int = 100, chunked: int = 0, batch: int = 1,
                  int8: bool = False) -> dict:
    """``input_mel`` is a directory of ``*.npy`` mels or a list file;
    ``device`` is "cuda" (the default, which raises without a card) or
    "cpu". Returns {"audio_seconds", "seconds"} over the generator calls
    (the clock read after a device sync)."""
    device = resolve_device(device)
    if batch > 1 and chunked:
        raise SystemExit("--chunked (single-utterance latency) and --batch "
                         "(cross-utterance throughput) are mutually exclusive")
    model, config = load_vocoder(ckpt, device, quant=int8)
    pqmf = build_pqmf(config)
    if chunked and (not model.causal or pqmf is not None):
        raise SystemExit("--chunked requires a causal, fullband generator")
    if chunked and int8:
        raise SystemExit(INT8_CHUNKED)
    if pqmf is not None:
        pqmf = pqmf.to(device)
    nsf = model.nsf_params is not None
    sampling_rate = config["audio_config"]["sampling_rate"]
    os.makedirs(output_dir, exist_ok=True)
    if os.path.isdir(input_mel):
        mel_files = sorted(glob.glob(os.path.join(input_mel, "*.npy")))
    else:
        with open(input_mel) as f:
            mel_files = [line.strip() for line in f if line.strip()]

    items = []
    for mel_file in mel_files:
        utt_id = os.path.splitext(os.path.basename(mel_file))[0]
        mel = np.load(mel_file)
        if mel.shape[0] == 0:
            logging.warning("%s: empty mel, skipping", utt_id)
            continue
        items.append((utt_id, binarize(mel) if nsf else mel))
    if batch > 1:
        # longest first, so that a group shares its bucket
        items.sort(key=lambda it: -it[1].shape[0])
    batch = max(batch, 1)

    audio_seconds, seconds = 0.0, 0.0
    for g0 in range(0, len(items), batch):
        group = items[g0:g0 + batch]
        mel_in = torch.from_numpy(bucket_pad([m for _, m in group], frame_bucket,
                                             batch)).to(device)
        synchronize(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            y = vocode(model, pqmf, mel_in, chunked).float().cpu().numpy()
        elapsed = time.perf_counter() - t0
        hop = y.shape[1] // mel_in.shape[1]
        secs = 0.0
        for (utt_id, mel), wav in zip(group, y):
            wav = wav[:mel.shape[0] * hop, 0]
            save_wav(wav, os.path.join(output_dir, f"{utt_id}.wav"), sampling_rate)
            secs += wav.shape[0] / sampling_rate
        logging.info("%s: %.2fs audio in %.3fs (RTF %.4f)",
                     ",".join(u for u, _ in group), secs, elapsed, elapsed / secs)
        audio_seconds += secs
        seconds += elapsed
    return {"audio_seconds": audio_seconds, "seconds": seconds}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--input_mel", type=str, required=True,
                        help="directory of mel npys or a list file")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--chunked", type=int, default=0, metavar="N",
                        help="split each utterance into N causal-context "
                             "windows synthesized as one batch (causal "
                             "fullband generators only)")
    parser.add_argument("--batch", type=int, default=1, metavar="B",
                        help="cross-utterance batched synthesis: utterances "
                             "per generator call")
    parser.add_argument("--int8", action="store_true",
                        help="int8 W8A8 on the interior conv stacks (same "
                             "float32 checkpoint; not with --chunked)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    hifigan_infer(args.input_mel, args.ckpt, args.output_dir, device=args.device,
                  chunked=args.chunked, batch=args.batch, int8=args.int8)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
