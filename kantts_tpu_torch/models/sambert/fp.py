"""Filled-pause insertion: splice encoded filler syllables into the text
hidden sequence (a copy of ``kantts_tpu/models/sambert/fp.py``).

The split between host and device:

- HOST (numpy, in the collate or in ``sambert_infer_fp``): an INSERTION PLAN that
  gives every output slot either the index of an original token or a
  (filler_class, phase) pair. Its length is a bucket.
- DEVICE: one gather and one select apply the plan (``apply_fp_insertion``);
  the three filler-syllable triples come from the text encoder run over the
  ``get_fpdict`` token triples.

Emotion and speaker sequences are only length-extended by wrap-around, as
in KAN-TTS: their per-position alignment is not shifted (ids are constant
over an utterance in practice).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def fp_classes_from_predictions(fp_p: np.ndarray, input_masks: np.ndarray
                                ) -> np.ndarray:
    """Argmax FP class per token from the predictor's probabilities, zeroed
    on padding."""
    cls = np.argmax(fp_p, axis=-1)
    cls = np.where(input_masks, 0, cls)
    return cls.astype(np.int32)


def build_fp_insertion_plan(
    fp_classes: np.ndarray,
    input_lengths: np.ndarray,
    out_len: Optional[int] = None,
    bucket: int = 16,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """fp_classes: (B, T_in) in {0..3}; 0 = no filler. A class c>0 at token j
    inserts the 3-slot filler BEFORE token j.

    Returns (src_idx (B, L), filler_class (B, L), filler_phase (B, L),
    inter_lengths (B,), L). Slots with filler_class == 0 take original token
    src_idx; others take filler_bank[filler_class - 1, filler_phase].
    """
    B, T_in = fp_classes.shape
    inter_lengths = np.asarray(
        [int(input_lengths[b]) + 3 * int((fp_classes[b, : input_lengths[b]] > 0).sum())
         for b in range(B)],
        dtype=np.int32,
    )
    if out_len is None:
        out_len = int(np.ceil(max(int(inter_lengths.max()), 1) / bucket) * bucket)

    src_idx = np.zeros((B, out_len), dtype=np.int32)
    filler_class = np.zeros((B, out_len), dtype=np.int32)
    filler_phase = np.zeros((B, out_len), dtype=np.int32)

    for b in range(B):
        pos = 0
        for j in range(int(input_lengths[b])):
            c = int(fp_classes[b, j])
            if c > 0:
                for phase in range(3):
                    if pos >= out_len:
                        break
                    filler_class[b, pos] = c
                    filler_phase[b, pos] = phase
                    pos += 1
            if pos >= out_len:
                break
            src_idx[b, pos] = j
            pos += 1
        # padding slots keep src_idx 0 / class 0; they are masked downstream
    return src_idx, filler_class, filler_phase, inter_lengths, out_len


def apply_fp_insertion(
    text_hid: torch.Tensor,
    filler_bank: torch.Tensor,
    src_idx: torch.Tensor,
    filler_class: torch.Tensor,
    filler_phase: torch.Tensor,
) -> torch.Tensor:
    """The plan applied on the device.

    text_hid: (B, T_in, D); filler_bank: (3, 3, D) [class-1, phase, D].
    Returns (B, L, D)."""
    gathered = torch.take_along_dim(text_hid, src_idx.long()[..., None], dim=1)
    fillers = filler_bank[(filler_class.long() - 1).clamp(0, 2),
                          filler_phase.long()]  # (B, L, D)
    return torch.where((filler_class > 0)[..., None], fillers.to(gathered.dtype),
                       gathered)


def extend_wraparound(x: np.ndarray, out_len: int) -> np.ndarray:
    """Length-extend id sequences by wrap-around repetition."""
    B, T = x.shape[0], x.shape[1]
    idx = np.arange(out_len) % T
    return x[:, idx]
