"""Model assembly from a config, with weights made from a seed, and the
port's checkpoint format (counterpart of the sambert and hifigan builders
in ``kantts_tpu/models/builder.py``).

A checkpoint is ``torch.save({"model": state_dict, "config": config, ...})``:
the config travels inside the file, so loading needs no YAML parser. A
training checkpoint adds ``optimizer``, ``scheduler`` (their state dicts)
and ``steps``; ``load_checkpoint`` reads the model from either kind.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Tuple

import torch
from torch import nn

from kantts_tpu.text.ling_unit import KanTtsLinguisticUnit
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.hifigan.layers import WeightNormParams
from kantts_tpu_torch.models.sambert.adaptors import VarRnnARPredictor
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT
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
    biases, N(0, 1) for embeddings, LayerNorm at identity, weight-norm gains
    at the norm of their direction, and the duration head's bias at its
    configured value. The draw is made on the CPU, so it does not depend on
    the device."""
    gen = torch.Generator().manual_seed(seed)

    def uniform_(p: torch.Tensor, fan_in: int) -> None:
        bound = 1.0 / math.sqrt(fan_in)
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))

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
            m.weight_g.copy_(torch.linalg.vector_norm(
                m.weight_v, dim=(1, 2), keepdim=True))
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


def hifigan_model_builder(config: Dict[str, Any], seed: int = 0) -> Generator:
    model = Generator(**config["Model"]["Generator"]["params"])
    init_parameters(model, seed)
    return model.eval()


def model_builder(config: Dict[str, Any], seed: int = 0) -> nn.Module:
    """Dispatch on ``config["model_type"]``; the model is in eval mode."""
    builders = {"sambert": build_sambert, "hifigan": hifigan_model_builder}
    return builders[config["model_type"]](config, seed)


def save_checkpoint(path: str, model: nn.Module, config: Dict[str, Any],
                    **training_state: Any) -> None:
    """Write to a temporary file in the target directory, then rename it into
    place, so that a crash mid-write never leaves a torn checkpoint."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"model": model.state_dict(), "config": config, **training_state},
               tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, device: torch.device
                    ) -> Tuple[nn.Module, Dict[str, Any]]:
    """-> (model in eval mode on ``device``, config)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    config = payload["config"]
    model = model_builder(config)
    model.load_state_dict(payload["model"], strict=True)
    return model.to(device).eval(), config
