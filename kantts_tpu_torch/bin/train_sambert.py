"""Train the SAM-BERT acoustic model (counterpart of
``kantts_tpu/bin/train_sambert.py``).

    python -m kantts_tpu_torch.bin.train_sambert --model_config CFG.yaml \
        --root_dir DATA [DATA ...] --stage_dir STAGE [--resume_path CKPT] \
        [--resume_bert_path SYBERT_CKPT] [--device cuda|cpu]

The dataset directory's ``audio_config.yaml`` is merged under the model
config, which is stamped and written to ``STAGE/config.yaml``; the
vocabulary sizes come from the linguistic unit. One process trains on one
device. Checkpoints go to ``STAGE/ckpt/checkpoint_{steps}.ckpt`` and load in
``bin/text_to_wav.py --am_ckpt`` as they are; ``--resume_path`` continues
from one at the step after it, with its optimizer and schedule. Then
``--resume_bert_path`` warm-starts the text encoder from a ``train_sybert``
checkpoint (every ``text_encoder.*`` tensor whose name and shape match). An
FP voice (``FP: true``) trains on ``am_fprm_*.lst`` with its filler triples.

Data parallelism: launched through torchrun, every process trains on its
own card (``cuda:LOCAL_RANK``, NCCL; gloo with ``--device cpu``) on its
shard of each batch, so ``batch_size`` is per process and the global batch
is ``batch_size`` x the world size; every loss is the global batch's, and
rank 0 alone writes the stage directory:

    torchrun --nproc_per_node N -m kantts_tpu_torch.bin.train_sambert ...
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
from kantts_tpu_torch.parallel import mesh
from kantts_tpu_torch.train.steps import make_sambert_step
from kantts_tpu_torch.train.trainer import (
    SambertTrainer,
    array_to_device,
    collective_timer,
    load_sambert_encoder_from_sybert,
    primary_log,
    run,
    stamped_config,
)
from kantts_tpu_torch.utils.config import load_merged_config
from kantts_tpu_torch.utils.device import resolve_device


def train(model_config: str, root_dir: Union[str, Sequence[str]], stage_dir: str,
          resume_path: Optional[str] = None,
          resume_bert_path: Optional[str] = None,
          device: str = "cuda") -> SambertTrainer:
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
        return _train(model_config, roots, stage_dir, resume_path,
                      resume_bert_path, device)


def _train(model_config, roots, stage_dir, resume_path, resume_bert_path,
           device) -> SambertTrainer:
    logging.info("data parallel: %s", mesh.describe())
    config = stamped_config(load_merged_config(roots[0], model_config), stage_dir)
    params = config["Model"]["KanTtsSAMBERT"]["params"]
    train_dataset, valid_dataset = mesh.primary_first(lambda: get_am_datasets(
        [os.path.join(d, "raw_metafile.txt") for d in roots], roots, config,
        config.get("allow_cache", False), se_enable=params.get("SE", False),
        input_bucket=int(config.get("input_bucket", 16)),
        frame_bucket=int(config.get("frame_bucket", 96))))
    logging.info("train + valid: %d + %d", len(train_dataset), len(valid_dataset))
    params.update(train_dataset.ling_unit.get_unit_size())

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
    built = sambert_model_builder(config, seed, device)
    model, optimizer, scheduler = built["model"], built["optimizer"], built["scheduler"]
    criterion = criterion_builder(config)
    with_mas = params.get("MAS", False)
    generator = torch.Generator(device=device).manual_seed(mesh.rank_seed(seed))
    fp_dict_lings = (array_to_device(train_dataset.fp_dict_lings, device)
                     if params.get("FP", False) else None)
    timer = collective_timer()
    train_step = make_sambert_step(model, criterion, optimizer, scheduler,
                                   built["clip"], with_mas, generator=generator,
                                   fp_dict_lings=fp_dict_lings, timer=timer)
    eval_step = make_sambert_step(model, criterion, optimizer, scheduler,
                                  built["clip"], with_mas, train=False,
                                  fp_dict_lings=fp_dict_lings, timer=timer)
    trainer = SambertTrainer(
        config, model, optimizer, scheduler, train_step, eval_step,
        train_loader, valid_loader, stage_dir, device,
        fp_dict_lings=fp_dict_lings,
        max_steps=config.get("train_max_steps"),
        save_interval=config.get("save_interval_steps", 10000),
        valid_interval=config.get("eval_interval_steps", 10000),
        log_interval=config.get("log_interval_steps", 1000), timer=timer)
    if resume_path is not None:
        trainer.load_checkpoint(resume_path, restore_training_state=True)
        logging.info("Resumed from %s at step %d", resume_path, trainer.steps)
    if resume_bert_path is not None:
        trainer.warm_started = load_sambert_encoder_from_sybert(model, resume_bert_path)
        logging.info("Warm-started the text encoder from %s: %d tensors copied",
                     resume_bert_path, len(trainer.warm_started))
    mesh.replicate([model])
    return run(trainer)


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
    try:
        train(args.model_config, args.root_dir, args.stage_dir, args.resume_path,
              args.resume_bert_path, args.device)
    finally:
        mesh.destroy()


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s, %(levelname)-4s [%(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S", level=logging.INFO)
    main()
