"""Serving artifacts: exported TTS programs (counterpart of
``kantts_tpu/infer/exported.py``).

``export_fused_tts`` packages an acoustic model and a vocoder checkpoint as
a directory that a serving host runs with no model class loaded:

    programs/encode.pt2           encoder, tokenizers, pitch/energy
    programs/duration_step.pt2    one step of the duration LSTM
    programs/regulate.pt2         durations, length regulator, memory, bands,
                                  the memory-side keys and values
    programs/decode_step.pt2      one PNCA decoder step (caches in place)
    programs/postnet_vocoder.pt2  postnet, then the vocoder
    config.yaml                   the stamped acoustic-model config
    meta.json                     shapes, hop, sampling rate, flags

Each program is a ``torch.export`` program of one inference stage of
``models/sambert/sambert.py`` (the functions ``sambert_infer`` runs), saved
with ``torch.export.save``; the weights are the programs' state. The JAX
package exports the whole text-to-wav program as one graph, its loops as
``lax.scan``; a traced Python loop unrolls instead (96 duration steps and
768 decoder steps of 12 layers at the default budget), so here
``ExportedTTS`` drives the two loops from the host, one program call a
step. Shapes are fixed by the symbol and frame budgets; the lengths are
data, and no program depends on their values.

An int8 artifact (``int8=True``) holds the int8 vocoder: the operator
``kantts::int8_conv1d`` (``ops/int8_conv.py``) is a node of the vocoder's
program, which dispatches to kernel K2 on the card. An NSF vocoder's
program takes its source's draws as inputs (``phase``, ``noise``), which
``ExportedTTS`` makes from a ``torch.Generator`` seeded ``rng_seed``, in
the order the live vocoder draws them.

The programs are traced on the export device; ``ExportedTTS`` moves them to
its own device when it loads them, one of ``meta["platforms"]``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from kantts_tpu_torch.infer.symbols import encode_symbol_inputs

PROGRAM_DIR = "programs"
PROGRAMS = ("encode", "duration_step", "regulate", "decode_step", "postnet_vocoder")
CONFIG_FILE = "config.yaml"
META_FILE = "meta.json"


def _subtree(module: nn.Module, paths) -> nn.Module:
    """A shallow copy of ``module`` that holds only the submodules on the
    dotted ``paths`` (each whole where its path ends), sharing their
    parameters: a stage's program then carries only the weights it uses."""
    view = copy.copy(module)
    view._modules = {}
    for name, child in module._modules.items():
        rest = [p[len(name) + 1:] for p in paths if p.startswith(name + ".")]
        if name in paths:
            view._modules[name] = child
        elif rest:
            view._modules[name] = _subtree(child, rest)
    return view


class _Encode(nn.Module):
    def __init__(self, am):
        super().__init__()
        self.am = am

    def forward(self, ling, emo, spk, lengths):
        from kantts_tpu_torch.models.sambert.sambert import infer_encode

        return infer_encode(self.am, ling, emo, spk, lengths)[:4]


class _DurationStep(nn.Module):
    def __init__(self, am):
        super().__init__()
        self.am = am

    def forward(self, prev, cond_t, h, c):
        from kantts_tpu_torch.models.sambert.sambert import infer_duration_step

        return infer_duration_step(self.am, prev, cond_t, h, c)


class _Regulate(nn.Module):
    def __init__(self, am, max_output_len: int):
        super().__init__()
        self.am, self.max_output_len = am, max_output_len

    def forward(self, text_aug, emo_hid, spk_hid, log_dur, lengths):
        from kantts_tpu_torch.models.sambert.sambert import infer_regulate

        reg = infer_regulate(self.am, text_aug, emo_hid, spk_hid, log_dur, lengths,
                             self.max_output_len)
        return (reg["memory"], reg["h_k"], reg["h_v"], reg["bw_step"],
                reg["mem_pad_mask"], reg["LR_length"])


class _DecodeStep(nn.Module):
    def __init__(self, am):
        super().__init__()
        self.am = am

    def forward(self, t, prev, memory, h_k, h_v, cache_k, cache_v, band_width,
                mem_pad_mask):
        return self.am.mel_decoder.mel_dec.step(t, prev, memory, h_k, h_v, cache_k,
                                                cache_v, band_width, band_width,
                                                mem_pad_mask)


class _PostnetVocoder(nn.Module):
    def __init__(self, am, generator, max_output_len: int, n_chunks: int):
        super().__init__()
        self.am, self.generator = am, generator
        self.max_output_len, self.n_chunks = max_output_len, n_chunks

    def forward(self, dec_outputs, LR_length, phase=None, noise=None):
        from kantts_tpu_torch.infer.chunked import chunked_apply
        from kantts_tpu_torch.models.sambert.sambert import infer_postnet

        _, mel = infer_postnet(self.am, dec_outputs, LR_length, self.max_output_len)
        gen = self.generator
        exc = None
        if gen.nsf_params is not None:
            exc = gen.source_module(mel[:, :, -2:-1], mel[:, :, -1:], phase=phase,
                                    noise=noise)
        if self.n_chunks:
            return chunked_apply(gen, mel, self.n_chunks, excitation=exc)
        return gen(mel, excitation=exc)


def _export(module: nn.Module, args: tuple, path: str) -> dict:
    """torch.export ``module`` on ``args`` and save it -> {nodes, seconds,
    parameters}."""
    t0 = time.perf_counter()
    with torch.no_grad(), warnings.catch_warnings():
        # nn.LSTM refreshes its list of weight references while traced
        warnings.filterwarnings("ignore", message="The tensor attributes .*_flat_weights")
        program = torch.export.export(module, args)
    seconds = time.perf_counter() - t0
    torch.export.save(program, path)
    return {"nodes": len(program.graph.nodes), "seconds": seconds,
            "parameters": sum(t.numel() for t in program.state_dict.values())}


def export_fused_tts(am_ckpt: str, voc_ckpt: str, out_dir: str,
                     max_input_len: int = 96, max_output_len: Optional[int] = None,
                     n_chunks: int = 0, frames_per_symbol: int = 24,
                     platforms=("cpu", "cuda"), int8: bool = False,
                     device="cuda") -> dict:
    """Export the symbols -> waveform programs as a serving artifact.

    max_input_len: the symbol budget (inputs pad to it).
    max_output_len: the mel-frame budget; by default
        ``ceil(max_input_len * frames_per_symbol / r) * r``, as the CLIs set it.
    n_chunks: the vocoder through the chunked-batch path (causal fullband).
    platforms: the devices the artifact may be loaded on.
    int8: the int8 W8A8 vocoder (not with ``n_chunks``).
    device: where the checkpoints are loaded and the programs traced.

    Returns the meta dict (also written to meta.json), with each program's
    node count and export seconds under ``"export"``."""
    import yaml

    from kantts_tpu_torch.bin.infer_hifigan import load_vocoder
    from kantts_tpu_torch.bin.infer_sambert import load_am
    from kantts_tpu_torch.models.builder import build_pqmf
    from kantts_tpu_torch.models.sambert.pnca import pnca_caches
    from kantts_tpu_torch.models.sambert.sambert import (
        infer_duration_state,
        infer_encode,
        infer_regulate,
    )
    from kantts_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    unknown = set(platforms) - {"cpu", "cuda"}
    if unknown:
        raise ValueError(f"platforms are cpu and cuda, got {sorted(unknown)}")
    am, ling_unit = load_am(am_ckpt, device)
    generator, voc_config = load_vocoder(voc_ckpt, device, quant=int8)
    if build_pqmf(voc_config) is not None:
        raise ValueError(
            "export_fused_tts supports fullband generators only "
            "(out_channels=1); multiband serving should export the mel "
            "program and run PQMF synthesis host-side")
    if int8 and n_chunks:
        raise ValueError("int8 and the chunked epilogue are mutually "
                         "exclusive (see infer_hifigan --int8)")
    r = am.r
    if max_output_len is None:
        max_output_len = int(np.ceil(max_input_len * frames_per_symbol / r) * r)
    if max_output_len % r:
        raise ValueError(f"max_output_len must be a multiple of r={r}")

    se_enable = bool(am.config.get("SE", False))
    n_ling = 1 if ling_unit.using_byte() else 4
    L = max_input_len
    ling = torch.zeros((1, L, n_ling), dtype=torch.long, device=device)
    emo = torch.zeros((1, L), dtype=torch.long, device=device)
    spk = (torch.zeros((1, L, int(am.config["speaker_units"])), device=device)
           if se_enable else torch.zeros((1, L), dtype=torch.long, device=device))
    lengths = torch.full((1,), L, dtype=torch.int32, device=device)
    hop = int(np.prod(generator.upsample_scales))
    nsf = generator.nsf_params is not None

    prog_dir = os.path.join(out_dir, PROGRAM_DIR)
    os.makedirs(prog_dir, exist_ok=True)
    stats = {}

    def path(name):
        return os.path.join(prog_dir, f"{name}.pt2")

    # each stage holds the part of the acoustic model it runs
    n_dec = len(am.mel_decoder.mel_dec.pnca)
    views = {
        "encode": _subtree(am, ["text_encoder", "spk_tokenizer", "emo_tokenizer",
                                "variance_adaptor.pitch_predictor",
                                "variance_adaptor.energy_predictor",
                                "variance_adaptor.pitch_emb",
                                "variance_adaptor.energy_emb"]),
        "duration_step": _subtree(am, ["variance_adaptor.duration_predictor"]),
        "regulate": _subtree(am, [f"mel_decoder.mel_dec.pnca.{i}.pnca_attn.w_h_kv"
                                  for i in range(n_dec)]),
        "decode_step": _subtree(am, ["mel_decoder"]),
        "postnet_vocoder": _subtree(am, ["mel_postnet"]),
    }
    with torch.no_grad():
        # example inputs of each stage come from the stage before
        enc = infer_encode(am, ling, emo, spk, lengths)[:4]
        stats["encode"] = _export(_Encode(views["encode"]), (ling, emo, spk, lengths),
                                  path("encode"))
        prev, h, c = infer_duration_state(am, enc[3])
        stats["duration_step"] = _export(_DurationStep(views["duration_step"]),
                                         (prev, enc[3][:, :1], h, c),
                                         path("duration_step"))
        log_dur = torch.zeros((1, L), device=device)
        reg_args = (enc[0], enc[1], enc[2], log_dur, lengths)
        reg = infer_regulate(am, *reg_args[:4], lengths, max_output_len)
        stats["regulate"] = _export(_Regulate(views["regulate"], max_output_len),
                                    reg_args, path("regulate"))
        cache_k, cache_v = pnca_caches(am.mel_decoder, reg["memory"])
        frame = torch.zeros((1, 1, am.d_mel), device=device)
        step_args = (torch.zeros((), dtype=torch.long, device=device), frame,
                     reg["memory"], reg["h_k"], reg["h_v"], cache_k, cache_v,
                     reg["bw_step"], reg["mem_pad_mask"])
        stats["decode_step"] = _export(_DecodeStep(views["decode_step"]), step_args,
                                       path("decode_step"))
        dec_outputs = torch.zeros((1, max_output_len // r, am.d_mel * r), device=device)
        voc_args: Tuple = (dec_outputs, reg["LR_length"])
        if nsf:
            H = generator.source_module.n_harmonics
            voc_args += (torch.zeros((1, 1, H), device=device),
                         torch.zeros((1, max_output_len * hop, H), device=device))
        stats["postnet_vocoder"] = _export(
            _PostnetVocoder(views["postnet_vocoder"], generator, max_output_len,
                            n_chunks), voc_args, path("postnet_vocoder"))

    with open(os.path.join(out_dir, CONFIG_FILE), "w") as f:
        yaml.safe_dump(_stamped_config(am_ckpt), f)
    meta = {
        "kind": "fused_text_to_wav",
        "platforms": list(platforms),
        "max_input_len": int(max_input_len),
        "max_output_len": int(max_output_len),
        "n_chunks": int(n_chunks),
        "outputs_per_step": int(r),
        "n_ling": int(n_ling),
        "se_enable": se_enable,
        "se_dim": int(am.config["speaker_units"]) if se_enable else 0,
        "hop_total": hop,
        "sampling_rate": int(voc_config.get("audio_config", {}).get(
            "sampling_rate", 16000)),
        "nsf_enable": nsf,
        "int8": bool(int8),
        "num_mels": int(am.d_mel),
        "nsf_harmonics": int(generator.source_module.n_harmonics) if nsf else 0,
        "duration_lstm": [int(h.shape[0]), int(h.shape[2])],
        "programs": {name: f"{PROGRAM_DIR}/{name}.pt2" for name in PROGRAMS},
        "torch_version": torch.__version__,
        "export": stats,
    }
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def _stamped_config(am_ckpt: str) -> dict:
    """The acoustic model's config as its checkpoint carries it."""
    return torch.load(am_ckpt, map_location="cpu", weights_only=True)["config"]


class ExportedTTS:
    """Load and run a serving artifact written by ``export_fused_tts``.

    Needs only the artifact directory and the port's model-free modules: the
    programs are ``torch.export`` programs (no model class is built), the
    linguistic unit comes from the bundled config. ``device`` is "cuda"
    (the default, which raises without a card) or "cpu", one of
    ``meta["platforms"]``."""

    def __init__(self, artifact_dir: str, device="cuda"):
        # the int8 operator must be registered before a program that calls
        # it is loaded
        import kantts_tpu_torch.ops.int8_conv  # noqa: F401
        from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit
        from kantts_tpu_torch.utils.config import load_yaml
        from kantts_tpu_torch.utils.device import resolve_device

        with open(os.path.join(artifact_dir, META_FILE)) as f:
            self.meta = json.load(f)
        device = torch.device(device)
        if device.type not in self.meta["platforms"]:
            raise ValueError(f"the artifact was exported for {self.meta['platforms']}"
                             f", not {device.type}")
        self.device = resolve_device(device)
        self.programs = {}
        for name in PROGRAMS:
            program = torch.export.load(os.path.join(artifact_dir,
                                                     self.meta["programs"][name]))
            self.programs[name] = _to_device(program, self.device).module()
        self.ling_unit = KanTtsLinguisticUnit(
            load_yaml(os.path.join(artifact_dir, CONFIG_FILE)))

    @torch.no_grad()
    def synthesize(self, symbol_seq: str, se: Optional[np.ndarray] = None,
                   rng_seed: int = 0):
        """One utterance: a symbol sequence (metafile format) -> (float32 wav
        of ``n_frames * hop_total`` samples, n_frames)."""
        meta, dev, p = self.meta, self.device, self.programs
        if meta["se_enable"] and se is None:
            raise ValueError("artifact was exported with SE d-vector "
                             "speakers; pass se=")
        ling, emo, spk, lengths = encode_symbol_inputs(
            self.ling_unit, symbol_seq, meta["max_input_len"], meta["n_ling"],
            se=se if meta["se_enable"] else None)
        ling, emo = (torch.from_numpy(a).long().to(dev) for a in (ling, emo))
        spk = torch.from_numpy(spk).to(dev)
        spk = spk if meta["se_enable"] else spk.long()
        lengths = torch.from_numpy(lengths).to(dev)

        text_aug, emo_hid, spk_hid, dur_cond = p["encode"](ling, emo, spk, lengths)
        L = meta["max_input_len"]
        prev = dur_cond.new_zeros((1, 1, 1))
        n_layers, hidden = meta["duration_lstm"]
        h = dur_cond.new_zeros((n_layers, 1, hidden))
        c = torch.zeros_like(h)
        log_dur = dur_cond.new_empty((1, L))
        for t in range(L):
            prev, h, c = p["duration_step"](prev, dur_cond[:, t:t + 1], h, c)
            log_dur[:, t] = prev[:, 0, 0]
        memory, h_k, h_v, band_width, mem_pad_mask, LR_length = p["regulate"](
            text_aug, emo_hid, spk_hid, log_dur, lengths)

        T = memory.shape[1]
        cache_k = h_k.new_zeros((h_k.shape[0], 1, h_k.shape[2], T, h_k.shape[4]))
        cache_v = torch.zeros_like(cache_k)
        steps = torch.arange(T, device=dev)
        n_mels = meta["num_mels"]
        frame = memory.new_zeros((1, 1, n_mels))
        dec_outputs = memory.new_empty((1, T, n_mels * meta["outputs_per_step"]))
        for t in range(T):
            out = p["decode_step"](steps[t], frame, memory, h_k, h_v, cache_k,
                                   cache_v, band_width, mem_pad_mask)
            dec_outputs[:, t] = out[:, 0]
            frame = out[:, :, -n_mels:]

        args = (dec_outputs, LR_length)
        if meta["nsf_enable"]:
            rng = torch.Generator(device=dev).manual_seed(rng_seed)
            H = meta["nsf_harmonics"]
            phase = (torch.rand((1, 1, H), generator=rng, device=dev) * 2.0
                     - 1.0) * math.pi
            noise = torch.randn((1, meta["max_output_len"] * meta["hop_total"], H),
                                generator=rng, device=dev)
            args += (phase, noise)
        wav = p["postnet_vocoder"](*args)
        n_frames = int(LR_length[0])
        return wav[0, :n_frames * meta["hop_total"], 0].float().cpu().numpy(), n_frames


def _to_device(program, device: torch.device):
    """The program with its state and constants on ``device``."""
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, str(device))
