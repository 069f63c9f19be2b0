"""A synthetic MAS training corpus made with numpy from a seed, in the layout
that ``kantts_tpu.data.AMDataset`` reads: ``raw_metafile.txt`` of symbol
sequences, and per utterance ``mel/``, frame-level ``f0/`` and ``energy/``
arrays; no ``duration/`` directory, so the dataset runs in MAS mode.

Each phone has its own random mel template, held over a random number of
frames with a little noise, so that the text-to-mel alignment is there to be
learnt; pitch and energy are constant over each phone. The repository holds
no recorded corpus: this one lets training run end to end without one.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import yaml

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
