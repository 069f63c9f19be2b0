"""Model assembly from a config, with weights made from a seed, and the
port's checkpoint format (counterpart of the sambert, sybert and hifigan
builders in ``kantts_tpu/models/builder.py``).

A checkpoint is ``torch.save({"model": state_dict, "config": config, ...})``:
the config travels inside the file, so loading needs no YAML parser. A
training checkpoint adds ``optimizer``, ``scheduler`` (their state dicts)
and ``steps``; a GAN training checkpoint nests them as ``{"generator": ...,
"discriminator": {class name: ...}}``. ``load_checkpoint`` reads the model
(the generator of a GAN checkpoint) from any kind.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from kantts_tpu_torch.models.hifigan.discriminators import (
    DISCRIMINATOR_CLASSES,
    NormConv,
)
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.hifigan.layers import WeightNormParams
from kantts_tpu_torch.models.pqmf import PQMF
from kantts_tpu_torch.models.sambert.adaptors import VarRnnARPredictor
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT, KanTtsTextsyBERT
from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit
from kantts_tpu_torch.train.optim import optimizer_builder
from kantts_tpu_torch.utils.config import load_yaml


def _unit_params(config: Dict[str, Any], section: str) -> Dict[str, Any]:
    """The params of ``config["Model"][section]``, with the vocabulary sizes
    of the config's linguistic unit filled in."""
    params = dict(config["Model"][section]["params"])
    if "linguistic_unit" in config:
        params.update(KanTtsLinguisticUnit(config).get_unit_size())
    return params


def sambert_params(config: Dict[str, Any]) -> Dict[str, Any]:
    """The KanTtsSAMBERT params of a full config, with the vocabulary sizes
    of its linguistic unit filled in, and ``compute_dtype: bfloat16`` where
    the config sets ``mixed_precision`` (unless the params name one)."""
    params = _unit_params(config, "KanTtsSAMBERT")
    if config.get("mixed_precision", False):
        params.setdefault("compute_dtype", "bfloat16")
    return params


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int) -> None:
    """Fill every parameter from a ``torch.Generator`` seeded with ``seed``:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for linear, conv and LSTM weights and
    biases, N(0, 1) for embeddings and spectral-norm vectors, LayerNorm at
    identity, weight-norm gains at the norm of their direction, and the
    duration head's bias at its configured value. The draw is made on the
    CPU, so it does not depend on the device."""
    gen = torch.Generator().manual_seed(seed)

    def uniform_(p: torch.Tensor, fan_in: int) -> None:
        bound = 1.0 / math.sqrt(fan_in)
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))

    def gain_(g: torch.Tensor, v: torch.Tensor) -> None:
        g.copy_(torch.linalg.vector_norm(v, dim=tuple(range(1, v.ndim)),
                                         keepdim=True))

    for m in model.modules():
        if isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen))
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            uniform_(m.weight, fan_in)
            if m.bias is not None:
                uniform_(m.bias, fan_in)
        elif isinstance(m, nn.LSTM):
            for p in m.parameters(recurse=False):
                uniform_(p, m.hidden_size)
        elif isinstance(m, WeightNormParams):
            fan_in = m.weight_v[0].numel()
            uniform_(m.weight_v, fan_in)
            gain_(m.weight_g, m.weight_v)
            if m.bias is not None:
                uniform_(m.bias, fan_in)
        elif isinstance(m, NormConv):
            fan_in = m.direction[0].numel()
            uniform_(m.direction, fan_in)
            if m.norm == "weight":
                gain_(m.weight_g, m.weight_v)
            elif m.norm == "spectral":
                m.weight_u.copy_(torch.randn(m.weight_u.shape, generator=gen))
            if m.bias is not None:
                uniform_(m.bias, fan_in)
    for m in model.modules():  # after the loop above has drawn its fc
        if isinstance(m, VarRnnARPredictor):
            m.fc.bias.fill_(m.fc_bias_init)


def build_sambert(config: Dict[str, Any], seed: int = 0) -> KanTtsSAMBERT:
    model = KanTtsSAMBERT(sambert_params(config))
    init_parameters(model, seed)
    return model.eval()


def _trainable(model: nn.Module, config: Dict[str, Any], section: str,
               device: torch.device) -> Dict[str, Any]:
    """``model`` on ``device`` in train mode, with the optimizer, scheduler
    and gradient clip of ``config`` (``Model.<section>.optimizer`` and
    ``.scheduler``, top-level ``grad_norm``)."""
    model = model.to(device).train()
    part = config["Model"][section]
    optimizer, scheduler, clip = optimizer_builder(
        model.parameters(), part["optimizer"], part.get("scheduler"),
        config.get("grad_norm"))
    return {"model": model, "optimizer": optimizer, "scheduler": scheduler,
            "clip": clip}


def sambert_model_builder(config: Dict[str, Any], seed: int = 0,
                          device: torch.device = torch.device("cpu")
                          ) -> Dict[str, Any]:
    """SAM-BERT for training: ``_trainable`` of ``Model.KanTtsSAMBERT``."""
    return _trainable(build_sambert(config, seed), config, "KanTtsSAMBERT", device)


def sybert_params(config: Dict[str, Any]) -> Dict[str, Any]:
    """The KanTtsTextsyBERT params of a full config, with the vocabulary
    sizes of its linguistic unit filled in. ``mixed_precision`` sets no
    compute dtype here: the JAX package's sybert builder passes none."""
    return _unit_params(config, "KanTtsTextsyBERT")


def build_sybert(config: Dict[str, Any], seed: int = 0) -> KanTtsTextsyBERT:
    model = KanTtsTextsyBERT(sybert_params(config))
    init_parameters(model, seed)
    return model.eval()


def sybert_model_builder(config: Dict[str, Any], seed: int = 0,
                         device: torch.device = torch.device("cpu")
                         ) -> Dict[str, Any]:
    """Textsy-BERT for training: ``_trainable`` of ``Model.KanTtsTextsyBERT``."""
    return _trainable(build_sybert(config, seed), config, "KanTtsTextsyBERT", device)


def vocoder_dtype(config: Dict[str, Any]) -> Optional[torch.dtype]:
    """The compute dtype of a HiFi-GAN config's generator and
    discriminators: bf16 with ``mixed_precision``, else None (float32).
    bf16 with a multi-band generator raises NotImplementedError: the JAX
    package cannot run it either (its PQMF synthesis convolves a bf16 signal
    with float32 filters and fails with a TypeError)."""
    if not config.get("mixed_precision", False):
        return None
    if config["Model"]["Generator"]["params"].get("out_channels", 1) > 1:
        raise NotImplementedError("mixed_precision (bf16) with a multi-band "
                                  "generator (out_channels > 1, PQMF)")
    return torch.bfloat16


def build_pqmf(config: Dict[str, Any]) -> Optional[PQMF]:
    """The PQMF filter bank of a multi-band generator (``out_channels`` > 1,
    one sub-band per channel), else None."""
    subbands = config["Model"]["Generator"]["params"].get("out_channels", 1)
    return PQMF(subbands=subbands) if subbands > 1 else None


def hifigan_model_builder(config: Dict[str, Any], seed: int = 0) -> Generator:
    model = Generator(**config["Model"]["Generator"]["params"],
                      dtype=vocoder_dtype(config))
    init_parameters(model, seed)
    return model.eval()


def hifigan_gan_builder(config: Dict[str, Any], seed: int = 0,
                        device: torch.device = torch.device("cpu")
                        ) -> Dict[str, Any]:
    """The generator and the discriminators of ``config`` on ``device`` in
    train mode, each with the optimizer, scheduler and gradient clip of its
    section (``Model.<name>.optimizer`` and ``.scheduler``; top-level
    ``generator_grad_norm`` and ``discriminator_grad_norm``). The
    discriminators are keyed by class name, in the JAX package's order;
    discriminator i is drawn from seed + 1 + i. ``pqmf`` is the filter bank
    of a multi-band generator (``build_pqmf``), or None. Every network
    computes in ``vocoder_dtype(config)``."""
    model_cfg = config["Model"]
    generator = hifigan_model_builder(config, seed).to(device).train()
    discriminators = {}
    for i, name in enumerate(n for n in DISCRIMINATOR_CLASSES if n in model_cfg):
        disc = DISCRIMINATOR_CLASSES[name](**model_cfg[name].get("params", {}),
                                           dtype=generator.dtype)
        init_parameters(disc, seed + 1 + i)
        discriminators[name] = disc.to(device).train()

    def family(name: str, module: nn.Module, grad_norm_key: str):
        return optimizer_builder(module.parameters(), model_cfg[name]["optimizer"],
                                 model_cfg[name].get("scheduler"),
                                 config.get(grad_norm_key, -1))

    gen_opt, gen_sched, gen_clip = family("Generator", generator,
                                          "generator_grad_norm")
    disc_parts = {name: family(name, d, "discriminator_grad_norm")
                  for name, d in discriminators.items()}
    pqmf = build_pqmf(config)
    return {
        "generator": generator, "discriminators": discriminators,
        "pqmf": pqmf.to(device) if pqmf is not None else None,
        "gen_optimizer": gen_opt, "gen_scheduler": gen_sched, "gen_clip": gen_clip,
        "disc_optimizers": {n: p[0] for n, p in disc_parts.items()},
        "disc_schedulers": {n: p[1] for n, p in disc_parts.items()},
        "disc_clips": {n: p[2] for n, p in disc_parts.items()},
    }


def model_builder(config: Dict[str, Any], seed: int = 0) -> nn.Module:
    """Dispatch on ``config["model_type"]``; the model is in eval mode."""
    builders = {"sambert": build_sambert, "sybert": build_sybert,
                "hifigan": hifigan_model_builder}
    return builders[config["model_type"]](config, seed)


def save_checkpoint(path: str, model: Union[nn.Module, Mapping[str, Any]],
                    config: Dict[str, Any], **training_state: Any) -> None:
    """``model`` is a module or a (nested) dict of state dicts. Write to a
    temporary file in the target directory, then rename it into place, so
    that a crash mid-write never leaves a torn checkpoint."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    state = model.state_dict() if isinstance(model, nn.Module) else model
    torch.save({"model": state, "config": config, **training_state}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, device: torch.device,
                    config: Union[None, str, Dict[str, Any]] = None
                    ) -> Tuple[nn.Module, Dict[str, Any]]:
    """-> (model in eval mode on ``device``, config). From a ``train_hifigan``
    checkpoint the model is its generator.

    With ``config`` (a config dict, or the path of its YAML) the file may be
    a reference KAN-TTS checkpoint, which carries no config:
    ``{"model": state dict}`` for SAM-BERT and Textsy-BERT,
    ``{"model": {"generator": ..., "discriminator": ...}}`` for HiFi-GAN.
    Names keep the reference's layout; the ``module.`` prefix of a model
    saved from inside ``DistributedDataParallel`` is stripped."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if config is None:
        config = payload["config"]
    elif isinstance(config, str):
        config = load_yaml(config)
    state = payload["model"]
    if config["model_type"] == "hifigan" and "generator" in state:
        state = state["generator"]
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items()}
    model = model_builder(config)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval(), config
