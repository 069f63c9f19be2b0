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
from kantts_tpu_torch.train.steps import make_sybert_step
from kantts_tpu_torch.train.trainer import TextsyBertTrainer
from kantts_tpu_torch.utils.config import load_merged_config, stamp_and_dump
from kantts_tpu_torch.utils.device import resolve_device
from kantts_tpu_torch.utils.log import log_to_file


def train(model_config: str, root_dir: Union[str, Sequence[str]], stage_dir: str,
          resume_path: Optional[str] = None,
          device: str = "cuda") -> TextsyBertTrainer:
    """Train until ``train_max_steps``; returns the trainer. ``device`` is
    "cuda" (the default, which raises without a card) or "cpu"."""
    device = resolve_device(device)
    roots = [root_dir] if isinstance(root_dir, str) else list(root_dir)
    for root in roots:
        if not os.path.exists(root):
            raise ValueError(f"root_dir {root} not found")
    os.makedirs(stage_dir, exist_ok=True)
    with log_to_file(os.path.join(stage_dir, "stdout.log")):
        return _train(model_config, roots, stage_dir, resume_path, device)


def _train(model_config, roots, stage_dir, resume_path, device) -> TextsyBertTrainer:
    config = stamp_and_dump(load_merged_config(roots[0], model_config), stage_dir)
    train_dataset, valid_dataset = get_bert_text_datasets(
        [os.path.join(d, "raw_metafile.txt") for d in roots], roots, config,
        config.get("allow_cache", False))
    logging.info("train + valid: %d + %d", len(train_dataset), len(valid_dataset))
    config["Model"]["KanTtsTextsyBERT"]["params"].update(
        train_dataset.ling_unit.get_unit_size())

    train_loader = DataLoader(
        train_dataset, config["batch_size"],
        sampler=DistributedSampler(len(train_dataset), shuffle=True),
        num_workers=config.get("num_workers", 0))
    valid_loader = DataLoader(
        valid_dataset, config["batch_size"],
        sampler=DistributedSampler(len(valid_dataset), shuffle=False),
        drop_last=False)

    seed = config.get("seed", 0)
    torch.manual_seed(seed)  # dropout
    built = sybert_model_builder(config, seed, device)
    model, optimizer, scheduler = built["model"], built["optimizer"], built["scheduler"]
    criterion = criterion_builder(config)
    trainer = TextsyBertTrainer(
        config, model, optimizer, scheduler,
        make_sybert_step(model, criterion, optimizer, scheduler, built["clip"]),
        make_sybert_step(model, criterion, optimizer, scheduler, built["clip"],
                         train=False),
        train_loader, valid_loader, stage_dir, device,
        max_steps=config.get("train_max_steps"),
        save_interval=config.get("save_interval_steps", 10000),
        valid_interval=config.get("eval_interval_steps", 10000),
        log_interval=config.get("log_interval_steps", 1000))
    if resume_path is not None:
        trainer.load_checkpoint(resume_path, restore_training_state=True)
        logging.info("Resumed from %s at step %d", resume_path, trainer.steps)

    try:
        trainer.train()
    except (Exception, KeyboardInterrupt):
        logging.exception("training failed at step %d", trainer.steps)
        trainer.save_checkpoint(
            os.path.join(trainer.ckpt_dir, f"checkpoint-{trainer.steps}.ckpt"))
        logging.info("Saved crash checkpoint at step %d", trainer.steps)
        raise
    return trainer


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train Textsy-BERT (PyTorch)")
    parser.add_argument("--model_config", type=str, required=True)
    parser.add_argument("--root_dir", type=str, required=True, nargs="+")
    parser.add_argument("--stage_dir", type=str, required=True)
    parser.add_argument("--resume_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    train(args.model_config, args.root_dir, args.stage_dir, args.resume_path,
          args.device)


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s, %(levelname)-4s [%(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S", level=logging.INFO)
    main()
