"""Synthetic training corpora made with numpy from a seed. The repository
holds no recorded corpus: these let training run end to end without one.

``write_mas_corpus``: a SAM-BERT MAS corpus in the layout that
``data.dataset.AMDataset`` reads: ``raw_metafile.txt`` of symbol
sequences, and per utterance ``mel/``, frame-level ``f0/`` and ``energy/``
arrays; no ``duration/`` directory, so the dataset runs in MAS mode. Each
phone has its own random mel template, held over a random number of frames
with a little noise, so that the text-to-mel alignment is there to be
learnt; pitch and energy are constant over each phone.

``write_voc_corpus``: a vocoder corpus in the layout that
``data.dataset.VocDataset`` reads: ``wav/*.wav`` of harmonic tones and
their ``mel/*.npy``, made by the port's ``MelSpectrogramExtractor`` at the
values of ``kantts_tpu/configs/audio_config_16k.yaml``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import yaml

from kantts_tpu_torch.dsp.mel import MelSpectrogramExtractor
from kantts_tpu_torch.utils.audio import save_wav

PHONES = ("n_c", "i_c", "h_c", "ao_c", "sh_c", "in_c", "j_c", "ie_c", "b_c",
          "a_c", "d_c", "e_c", "g_c", "ai_c", "m_c", "en_c")
TONES = ("tone1", "tone2", "tone3", "tone4", "tone5")


def write_mas_corpus(root: str, n_utts: int, symbols: Tuple[int, int],
                     frames: Tuple[int, int], n_mels: int = 80, seed: int = 0
                     ) -> None:
    """Write ``n_utts`` utterances under ``root``, each with a symbol count
    and a frame count drawn uniformly from the inclusive ranges ``symbols``
    and ``frames``."""
    rng = np.random.RandomState(seed)
    for sub in ("mel", "f0", "energy"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    templates = rng.randn(len(PHONES), n_mels).astype(np.float32)
    lines = []
    for i in range(n_utts):
        n_sym = rng.randint(symbols[0], symbols[1] + 1)
        n_frames = rng.randint(frames[0], frames[1] + 1)
        if n_frames < n_sym:
            raise ValueError(f"{n_frames} frames cannot hold {n_sym} symbols")
        ids = rng.randint(0, len(PHONES), n_sym)
        durs = 1 + rng.multinomial(n_frames - n_sym, np.full(n_sym, 1.0 / n_sym))
        mel = (np.repeat(templates[ids], durs, axis=0)
               + 0.1 * rng.randn(n_frames, n_mels)).astype(np.float32)
        utt = f"utt{i:04d}"
        np.save(os.path.join(root, "mel", f"{utt}.npy"), mel)
        for sub in ("f0", "energy"):
            np.save(os.path.join(root, sub, f"{utt}.npy"),
                    np.repeat(rng.rand(n_sym) + 0.5, durs).astype(np.float32))
        tokens = []
        for j, p in enumerate(ids):
            flag = "s_begin" if j % 2 == 0 else "s_end"
            ws = "word_begin" if j % 2 == 0 else "word_end"
            tokens.append(f"{{{PHONES[p]}${TONES[rng.randint(len(TONES))]}"
                          f"${flag}${ws}$emotion_neutral$F7}}")
        lines.append(f"{utt}\t{' '.join(tokens)}")
    with open(os.path.join(root, "raw_metafile.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "audio_config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump({"audio_config": {"sampling_rate": 16000, "hop_length": 200,
                                         "win_length": 1000, "n_fft": 2048,
                                         "n_mels": n_mels}}, f)


# the feature values of kantts_tpu/configs/audio_config_16k.yaml
AUDIO_16K = {"sampling_rate": 16000, "n_fft": 2048, "hop_length": 200,
             "win_length": 1000, "n_mels": 80, "fmin": 0.0, "fmax": 8000.0,
             "max_norm": 1.0, "min_level_db": -100.0, "ref_level_db": 20,
             "symmetric": False}


def write_voc_corpus(root: str, n_utts: int, seconds: Tuple[float, float],
                     seed: int = 0) -> None:
    """Write ``n_utts`` utterances under ``root``, each of a length drawn
    uniformly from the range ``seconds``: a tone whose f0 glides around a
    random base of 90-260 Hz, with 6 harmonics at amplitudes 1/k, an
    envelope rising and falling over the utterance with a slow tremolo, and
    a little white noise; peak near 0.5. Then ``audio_config.yaml``;
    ``get_voc_datasets`` writes ``train.lst``/``valid.lst`` itself."""
    sr, hop = AUDIO_16K["sampling_rate"], AUDIO_16K["hop_length"]
    rng = np.random.RandomState(seed)
    for sub in ("wav", "mel"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    extract = MelSpectrogramExtractor(
        sr, AUDIO_16K["n_fft"], hop, AUDIO_16K["win_length"], AUDIO_16K["n_mels"],
        AUDIO_16K["max_norm"], AUDIO_16K["min_level_db"],
        AUDIO_16K["ref_level_db"], AUDIO_16K["fmin"], AUDIO_16K["fmax"],
        AUDIO_16K["symmetric"])
    for i in range(n_utts):
        n = int(rng.uniform(*seconds) * sr)
        t = np.arange(n) / sr
        f0 = rng.uniform(90, 260) * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.3, 2)
                                                        * t + rng.uniform(0, 6.3)))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        tone = sum(np.sin(k * phase + rng.uniform(0, 6.3)) / k for k in range(1, 7))
        envelope = (np.sqrt(np.clip(np.sin(np.pi * t / t[-1]), 0.0, None))
                    * (1 + 0.3 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)))
        wav = tone * envelope + 0.02 * rng.randn(n)
        wav = (0.5 * wav / np.abs(wav).max()).astype(np.float32)
        utt = f"utt{i:04d}"
        save_wav(wav, os.path.join(root, "wav", f"{utt}.wav"), sr)
        mel = extract(wav)
        if len(mel) * hop < n:
            raise AssertionError(f"{utt}: {len(mel)} frames for {n} samples")
        np.save(os.path.join(root, "mel", f"{utt}.npy"), mel.astype(np.float32))
    with open(os.path.join(root, "audio_config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump({"audio_config": dict(AUDIO_16K)}, f)
