"""Train Textsy-BERT, the masked-LM pretrainer of the SAM-BERT text encoder
(counterpart of ``kantts_tpu/bin/train_sybert.py``).

    python -m kantts_tpu_torch.bin.train_sybert --model_config CFG.yaml \
        --root_dir DATA [DATA ...] --stage_dir STAGE [--resume_path CKPT] \
        [--device cuda|cpu]

Each dataset directory holds ``raw_metafile.txt`` (symbol sequences; the
first run splits it into ``bert_train.lst`` and ``bert_valid.lst``) and an
``audio_config.yaml``, which is merged under the model config; the config
is stamped and written to ``STAGE/config.yaml``, and the vocabulary sizes
come from the linguistic unit. Checkpoints go to
``STAGE/ckpt/checkpoint_{steps}.ckpt`` in the port's format;
``train_sambert --resume_bert_path`` warm-starts a SAM-BERT text encoder
from one, and ``--resume_path`` continues from one at the step after it,
with its optimizer and schedule.

Data parallelism: launched through torchrun, every process trains on its
own card (``cuda:LOCAL_RANK``, NCCL; gloo with ``--device cpu``) on its
shard of each batch, so ``batch_size`` is per process; the loss is the
global batch's, and rank 0 alone writes the stage directory:

    torchrun --nproc_per_node N -m kantts_tpu_torch.bin.train_sybert ...
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence, Union

import torch

from kantts_tpu_torch.data.dataset import (
    DataLoader,
    DistributedSampler,
    get_bert_text_datasets,
)
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import sybert_model_builder
from kantts_tpu_torch.parallel import mesh
from kantts_tpu_torch.train.steps import make_sybert_step
from kantts_tpu_torch.train.trainer import (
    TextsyBertTrainer,
    collective_timer,
    primary_log,
    run,
    stamped_config,
)
from kantts_tpu_torch.utils.config import load_merged_config
from kantts_tpu_torch.utils.device import resolve_device


def train(model_config: str, root_dir: Union[str, Sequence[str]], stage_dir: str,
          resume_path: Optional[str] = None,
          device: str = "cuda") -> TextsyBertTrainer:
    """Train until ``train_max_steps``; returns the trainer. ``device`` is
    "cuda" (the default, which raises without a card) or "cpu". Under
    torchrun's environment the process joins its process group first."""
    device = resolve_device(device)
    mesh.distributed_init(device)
    roots = [root_dir] if isinstance(root_dir, str) else list(root_dir)
    for root in roots:
        if not os.path.exists(root):
            raise ValueError(f"root_dir {root} not found")
    os.makedirs(stage_dir, exist_ok=True)
    with primary_log(stage_dir):
        return _train(model_config, roots, stage_dir, resume_path, device)


def _train(model_config, roots, stage_dir, resume_path, device) -> TextsyBertTrainer:
    logging.info("data parallel: %s", mesh.describe())
    config = stamped_config(load_merged_config(roots[0], model_config), stage_dir)
    train_dataset, valid_dataset = mesh.primary_first(lambda: get_bert_text_datasets(
        [os.path.join(d, "raw_metafile.txt") for d in roots], roots, config,
        config.get("allow_cache", False)))
    logging.info("train + valid: %d + %d", len(train_dataset), len(valid_dataset))
    config["Model"]["KanTtsTextsyBERT"]["params"].update(
        train_dataset.ling_unit.get_unit_size())

    lengths_max = mesh.lengths_max()  # every rank pads as the global batch
    train_loader = DataLoader(
        train_dataset, config["batch_size"],
        sampler=DistributedSampler(len(train_dataset), mesh.world_size(),
                                   mesh.rank(), shuffle=True),
        num_workers=config.get("num_workers", 0), lengths_max=lengths_max)
    valid_loader = DataLoader(
        valid_dataset, config["batch_size"],
        sampler=DistributedSampler(len(valid_dataset), mesh.world_size(),
                                   mesh.rank(), shuffle=False),
        drop_last=False, lengths_max=lengths_max)

    seed = config.get("seed", 0)
    torch.manual_seed(mesh.rank_seed(seed))  # dropout, this rank's own
    built = sybert_model_builder(config, seed, device)
    model, optimizer, scheduler = built["model"], built["optimizer"], built["scheduler"]
    criterion = criterion_builder(config)
    timer = collective_timer()
    trainer = TextsyBertTrainer(
        config, model, optimizer, scheduler,
        make_sybert_step(model, criterion, optimizer, scheduler, built["clip"],
                         timer=timer),
        make_sybert_step(model, criterion, optimizer, scheduler, built["clip"],
                         train=False, timer=timer),
        train_loader, valid_loader, stage_dir, device,
        max_steps=config.get("train_max_steps"),
        save_interval=config.get("save_interval_steps", 10000),
        valid_interval=config.get("eval_interval_steps", 10000),
        log_interval=config.get("log_interval_steps", 1000), timer=timer)
    if resume_path is not None:
        trainer.load_checkpoint(resume_path, restore_training_state=True)
        logging.info("Resumed from %s at step %d", resume_path, trainer.steps)
    mesh.replicate([model])
    return run(trainer)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train Textsy-BERT (PyTorch)")
    parser.add_argument("--model_config", type=str, required=True)
    parser.add_argument("--root_dir", type=str, required=True, nargs="+")
    parser.add_argument("--stage_dir", type=str, required=True)
    parser.add_argument("--resume_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    try:
        train(args.model_config, args.root_dir, args.stage_dir, args.resume_path,
              args.device)
    finally:
        mesh.destroy()


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s, %(levelname)-4s [%(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S", level=logging.INFO)
    main()
