"""HiFi-GAN vocoder inference, plain path: mel npy files -> PCM16 wavs
(counterpart of ``kantts_tpu/bin/infer_hifigan.py`` without its chunked,
batched and int8 paths).

Weight norm is folded on load. Each mel runs alone (B=1) at its own length:
the generator is causal, so no padding is needed.

    python -m kantts_tpu_torch.bin.infer_hifigan --ckpt VOC.pt \
        --input_mel MELS --output_dir OUT [--device cuda|cpu]
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

from kantts_tpu_torch.models.builder import load_checkpoint
from kantts_tpu_torch.models.hifigan.layers import fold_weight_norm
from kantts_tpu_torch.utils.audio import save_wav
from kantts_tpu_torch.utils.device import resolve_device, synchronize


def hifigan_infer(input_mel: str, ckpt: str, output_dir: str,
                  device: Union[str, torch.device] = "cuda") -> dict:
    """``input_mel`` is a directory of ``*.npy`` mels or a list file;
    ``device`` is "cuda" (the default, which raises without a card) or
    "cpu". Returns {"audio_seconds", "seconds"} over the generator calls
    (the clock read after a device sync)."""
    device = resolve_device(device)
    model, config = load_checkpoint(ckpt, device)
    fold_weight_norm(model)
    sampling_rate = config["audio_config"]["sampling_rate"]
    os.makedirs(output_dir, exist_ok=True)
    if os.path.isdir(input_mel):
        mel_files = sorted(glob.glob(os.path.join(input_mel, "*.npy")))
    else:
        with open(input_mel) as f:
            mel_files = [line.strip() for line in f if line.strip()]

    audio_seconds, seconds = 0.0, 0.0
    for mel_file in mel_files:
        utt_id = os.path.splitext(os.path.basename(mel_file))[0]
        mel = np.load(mel_file)
        if mel.shape[0] == 0:
            logging.warning("%s: empty mel, skipping", utt_id)
            continue
        synchronize(device)
        t0 = time.perf_counter()
        with torch.no_grad():
            wav = model(torch.from_numpy(mel.astype(np.float32))[None].to(device))
        wav = wav[0, :, 0].cpu().numpy()
        elapsed = time.perf_counter() - t0
        save_wav(wav, os.path.join(output_dir, f"{utt_id}.wav"), sampling_rate)
        secs = wav.shape[0] / sampling_rate
        logging.info("%s: %.2fs audio in %.3fs (RTF %.4f)", utt_id, secs,
                     elapsed, elapsed / secs)
        audio_seconds += secs
        seconds += elapsed
    return {"audio_seconds": audio_seconds, "seconds": seconds}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--input_mel", type=str, required=True,
                        help="directory of mel npys or a list file")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    hifigan_infer(args.input_mel, args.ckpt, args.output_dir, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
