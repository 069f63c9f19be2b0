"""Fused text-to-wav inference: acoustic decode then vocoder on one device
(counterpart of ``kantts_tpu/infer/e2e.py``).

The CLI pipeline is file-mediated: SAM-BERT writes mel npy files, HiFi-GAN
reads them back. Here symbol ids go in and a waveform comes out, and the mel
tensor never leaves the device between the two models.

    wav, n_valid_frames = fused_infer(am_model, generator, ling, emo, spk,
                                      lengths, max_output_len)

``wav`` is (B, max_output_len * hop, 1); the valid prefix of item i is
``n_valid_frames[i] * hop`` samples. Results equal running ``sambert_infer``
and the generator back to back (tests/test_torch_port_stream.py). An NSF
vocoder's source draws from a ``torch.Generator`` seeded ``rng_seed`` on
the mel's device, as ``bin/infer_hifigan.py::vocode`` draws; the serving
artifact (``infer/exported.py``) draws the same numbers.
"""

from __future__ import annotations

import torch

from kantts_tpu_torch.infer.chunked import chunked_apply
from kantts_tpu_torch.models.sambert.sambert import sambert_infer


@torch.inference_mode()
def fused_infer(am_model, generator, ling, emo, spk, lengths,
                max_output_len: int, n_chunks: int = 0, rng_seed: int = 0):
    """-> (wav (B, max_output_len * hop, 1), LR_length_rounded (B,)).
    ``n_chunks > 0`` vocodes through ``chunked_apply`` (B=1, causal
    generators only)."""
    res = sambert_infer(am_model, ling, emo, spk, lengths, max_output_len)
    mel = res["postnet_outputs"]
    rng = torch.Generator(device=mel.device).manual_seed(rng_seed)
    wav = (chunked_apply(generator, mel, n_chunks, rng=rng) if n_chunks
           else generator(mel, generator=rng))
    return wav, res["LR_length_rounded"]
