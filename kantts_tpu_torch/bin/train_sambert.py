"""Train the SAM-BERT acoustic model (counterpart of
``kantts_tpu/bin/train_sambert.py``).

    python -m kantts_tpu_torch.bin.train_sambert --model_config CFG.yaml \
        --root_dir DATA [DATA ...] --stage_dir STAGE [--resume_path CKPT] \
        [--device cuda|cpu]

The dataset directory's ``audio_config.yaml`` is merged under the model
config, which is stamped and written to ``STAGE/config.yaml``; the
vocabulary sizes come from the linguistic unit. One process trains on one
device. Checkpoints go to ``STAGE/ckpt/checkpoint_{steps}.ckpt`` and load in
``bin/text_to_wav.py --am_ckpt`` as they are; ``--resume_path`` continues
from one at the step after it, with its optimizer and schedule.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence, Union

import torch

from kantts_tpu_torch.data.dataset import DataLoader, DistributedSampler, get_am_datasets
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import sambert_model_builder
from kantts_tpu_torch.train.steps import make_sambert_step
from kantts_tpu_torch.train.trainer import SambertTrainer
from kantts_tpu_torch.utils.config import load_merged_config, stamp_and_dump
from kantts_tpu_torch.utils.device import resolve_device
from kantts_tpu_torch.utils.log import log_to_file


def train(model_config: str, root_dir: Union[str, Sequence[str]], stage_dir: str,
          resume_path: Optional[str] = None,
          resume_bert_path: Optional[str] = None,
          device: str = "cuda") -> SambertTrainer:
    """Train until ``train_max_steps``; returns the trainer. ``device`` is
    "cuda" (the default, which raises without a card) or "cpu"."""
    if resume_bert_path is not None:
        raise NotImplementedError("--resume_bert_path: Textsy-BERT is not "
                                  "ported to kantts_tpu_torch yet")
    device = resolve_device(device)
    roots = [root_dir] if isinstance(root_dir, str) else list(root_dir)
    for root in roots:
        if not os.path.exists(root):
            raise ValueError(f"root_dir {root} not found")
    os.makedirs(stage_dir, exist_ok=True)
    with log_to_file(os.path.join(stage_dir, "stdout.log")):
        return _train(model_config, roots, stage_dir, resume_path, device)


def _train(model_config, roots, stage_dir, resume_path, device) -> SambertTrainer:
    config = stamp_and_dump(load_merged_config(roots[0], model_config), stage_dir)
    params = config["Model"]["KanTtsSAMBERT"]["params"]
    train_dataset, valid_dataset = get_am_datasets(
        [os.path.join(d, "raw_metafile.txt") for d in roots], roots, config,
        config.get("allow_cache", False),
        input_bucket=int(config.get("input_bucket", 16)),
        frame_bucket=int(config.get("frame_bucket", 96)))
    logging.info("train + valid: %d + %d", len(train_dataset), len(valid_dataset))
    params.update(train_dataset.ling_unit.get_unit_size())

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
    built = sambert_model_builder(config, seed, device)
    model, optimizer, scheduler = built["model"], built["optimizer"], built["scheduler"]
    criterion = criterion_builder(config)
    with_mas = params.get("MAS", False)
    generator = torch.Generator(device=device).manual_seed(seed)
    train_step = make_sambert_step(model, criterion, optimizer, scheduler,
                                   built["clip"], with_mas, generator=generator)
    eval_step = make_sambert_step(model, criterion, optimizer, scheduler,
                                  built["clip"], with_mas, train=False)
    trainer = SambertTrainer(
        config, model, optimizer, scheduler, train_step, eval_step,
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
    parser = argparse.ArgumentParser(description="Train SAM-BERT (PyTorch)")
    parser.add_argument("--model_config", type=str, required=True)
    parser.add_argument("--root_dir", type=str, required=True, nargs="+")
    parser.add_argument("--stage_dir", type=str, required=True)
    parser.add_argument("--resume_path", type=str, default=None)
    parser.add_argument("--resume_bert_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    train(args.model_config, args.root_dir, args.stage_dir, args.resume_path,
          args.resume_bert_path, args.device)


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s, %(levelname)-4s [%(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S", level=logging.INFO)
    main()
