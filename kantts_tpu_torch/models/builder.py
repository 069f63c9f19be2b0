"""Model assembly from a config, with weights made from a seed, and the
port's checkpoint format (counterpart of the sambert and hifigan builders
in ``kantts_tpu/models/builder.py``).

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
from typing import Any, Dict, Mapping, Tuple, Union

import torch
from torch import nn

from kantts_tpu_torch.models.hifigan.discriminators import (
    DISCRIMINATOR_CLASSES,
    NormConv,
)
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.hifigan.layers import WeightNormParams
from kantts_tpu_torch.models.sambert.adaptors import VarRnnARPredictor
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT
from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit
from kantts_tpu_torch.train.optim import optimizer_builder


def sambert_params(config: Dict[str, Any]) -> Dict[str, Any]:
    """The KanTtsSAMBERT params of a full config, with the vocabulary sizes
    of its linguistic unit filled in."""
    params = dict(config["Model"]["KanTtsSAMBERT"]["params"])
    if "linguistic_unit" in config:
        params.update(KanTtsLinguisticUnit(config).get_unit_size())
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


def sambert_model_builder(config: Dict[str, Any], seed: int = 0,
                          device: torch.device = torch.device("cpu")
                          ) -> Dict[str, Any]:
    """The model on ``device`` in train mode, with the optimizer, scheduler
    and gradient clip of ``config`` (``Model.KanTtsSAMBERT.optimizer`` and
    ``.scheduler``, top-level ``grad_norm``)."""
    model = build_sambert(config, seed).to(device).train()
    section = config["Model"]["KanTtsSAMBERT"]
    optimizer, scheduler, clip = optimizer_builder(
        model.parameters(), section["optimizer"], section.get("scheduler"),
        config.get("grad_norm"))
    return {"model": model, "optimizer": optimizer, "scheduler": scheduler,
            "clip": clip}


def check_vocoder_ported(config: Dict[str, Any]) -> None:
    """Raise NotImplementedError naming each part of a HiFi-GAN config that
    the port does not have: bf16 compute, NSF, PQMF (more than one output
    channel) and MultiSpecDiscriminator."""
    gen = config["Model"]["Generator"]["params"]
    missing = [name for name, present in (
        ("mixed_precision (bf16)", config.get("mixed_precision", False)),
        ("NSF (nsf_params)", gen.get("nsf_params") is not None),
        ("PQMF (out_channels > 1)", gen.get("out_channels", 1) > 1),
        ("MultiSpecDiscriminator", "MultiSpecDiscriminator" in config["Model"]),
    ) if present]
    if missing:
        raise NotImplementedError("not ported to kantts_tpu_torch yet: "
                                  + ", ".join(missing))


def hifigan_model_builder(config: Dict[str, Any], seed: int = 0) -> Generator:
    model = Generator(**config["Model"]["Generator"]["params"])
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
    discriminator i is drawn from seed + 1 + i."""
    check_vocoder_ported(config)
    model_cfg = config["Model"]
    generator = hifigan_model_builder(config, seed).to(device).train()
    discriminators = {}
    for i, name in enumerate(n for n in DISCRIMINATOR_CLASSES if n in model_cfg):
        disc = DISCRIMINATOR_CLASSES[name](**model_cfg[name].get("params", {}))
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
    return {
        "generator": generator, "discriminators": discriminators,
        "gen_optimizer": gen_opt, "gen_scheduler": gen_sched, "gen_clip": gen_clip,
        "disc_optimizers": {n: p[0] for n, p in disc_parts.items()},
        "disc_schedulers": {n: p[1] for n, p in disc_parts.items()},
        "disc_clips": {n: p[2] for n, p in disc_parts.items()},
    }


def model_builder(config: Dict[str, Any], seed: int = 0) -> nn.Module:
    """Dispatch on ``config["model_type"]``; the model is in eval mode."""
    builders = {"sambert": build_sambert, "hifigan": hifigan_model_builder}
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


def load_checkpoint(path: str, device: torch.device
                    ) -> Tuple[nn.Module, Dict[str, Any]]:
    """-> (model in eval mode on ``device``, config). From a ``train_hifigan``
    checkpoint the model is its generator."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    config = payload["config"]
    state = payload["model"]
    if config["model_type"] == "hifigan" and "generator" in state:
        state = state["generator"]
    model = model_builder(config)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval(), config
