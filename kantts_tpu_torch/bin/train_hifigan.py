"""Train the HiFi-GAN vocoder (counterpart of
``kantts_tpu/bin/train_hifigan.py``).

    python -m kantts_tpu_torch.bin.train_hifigan --model_config CFG.yaml \
        --root_dir DATA [DATA ...] --stage_dir STAGE [--resume_path CKPT] \
        [--resume_training_state] [--device cuda|cpu]

The dataset directory's ``audio_config.yaml`` is merged under the model
config, which is stamped and written to ``STAGE/config.yaml``. Each
``DATA`` holds ``wav/`` and ``mel/``; ``train.lst``/``valid.lst`` are written
there when missing. One process trains on one device: the generator and the
discriminator families of the config, each with its own optimizer and
schedule. Checkpoints go to ``STAGE/ckpt/checkpoint_{steps}.ckpt`` and serve
through ``bin/text_to_wav.py --voc_ckpt`` as they are.

``--resume_path`` loads weights only by default (a fine-tune start: fresh
optimizers, step 1); with ``--resume_training_state`` it also restores both
optimizers, the schedules and the step, and continues at the next step.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from kantts_tpu_torch.data.dataset import DataLoader, DistributedSampler, get_voc_datasets
from kantts_tpu_torch.losses import criterion_builder
from kantts_tpu_torch.models.builder import check_vocoder_ported, hifigan_gan_builder
from kantts_tpu_torch.train.steps import make_gan_eval_step, make_gan_step
from kantts_tpu_torch.train.trainer import GanTrainer
from kantts_tpu_torch.utils.config import load_merged_config, stamp_and_dump
from kantts_tpu_torch.utils.device import resolve_device
from kantts_tpu_torch.utils.log import log_to_file


class VocLoader(DataLoader):
    """Random crops drawn from this loader's own RandomState, so that a run's
    batches depend only on its seed."""

    def __init__(self, dataset, batch_size, sampler, seed=1234, **kwargs):
        self._crop_rng = np.random.RandomState(seed)
        super().__init__(
            dataset, batch_size, sampler,
            collate_fn=lambda b: dataset.collate_fn(b, self._crop_rng),
            **kwargs,
        )


def train(model_config: str, root_dir: Union[str, Sequence[str]], stage_dir: str,
          resume_path: Optional[str] = None, resume_training_state: bool = False,
          device: str = "cuda") -> GanTrainer:
    """Train until ``train_max_steps``; returns the trainer. ``device`` is
    "cuda" (the default, which raises without a card) or "cpu"."""
    device = resolve_device(device)
    roots = [root_dir] if isinstance(root_dir, str) else list(root_dir)
    for root in roots:
        if not os.path.exists(root):
            raise ValueError(f"root_dir {root} not found")
    os.makedirs(stage_dir, exist_ok=True)
    with log_to_file(os.path.join(stage_dir, "stdout.log")):
        return _train(model_config, roots, stage_dir, resume_path,
                      resume_training_state, device)


def _train(model_config, roots, stage_dir, resume_path, resume_training_state,
           device) -> GanTrainer:
    config = stamp_and_dump(load_merged_config(roots[0], model_config), stage_dir)
    check_vocoder_ported(config)
    train_dataset, valid_dataset = get_voc_datasets(config, roots)
    logging.info("train + valid: %d + %d", len(train_dataset), len(valid_dataset))
    train_loader = VocLoader(
        train_dataset, config["batch_size"],
        DistributedSampler(len(train_dataset), shuffle=True),
        num_workers=config.get("num_workers", 0))
    valid_loader = VocLoader(
        valid_dataset, config["batch_size"],
        DistributedSampler(len(valid_dataset), shuffle=False), drop_last=False)

    built = hifigan_gan_builder(config, config.get("seed", 0), device)
    generator, discriminators = built["generator"], built["discriminators"]
    criterion = criterion_builder(config)

    def make_step(train_generator: bool, include_adversarial: bool):
        return make_gan_step(
            generator, discriminators, criterion, built["gen_optimizer"],
            built["gen_scheduler"], built["disc_optimizers"],
            built["disc_schedulers"], built["gen_clip"], built["disc_clips"],
            train_generator=train_generator,
            include_adversarial=include_adversarial)

    trainer = GanTrainer(
        config, generator, discriminators, built["gen_optimizer"],
        built["gen_scheduler"], built["disc_optimizers"], built["disc_schedulers"],
        make_step, make_gan_eval_step(generator, discriminators, criterion),
        train_loader, valid_loader, stage_dir, device,
        sampling_rate=config["audio_config"]["sampling_rate"],
        max_steps=config.get("train_max_steps"),
        save_interval=config.get("save_interval_steps", 10000),
        valid_interval=config.get("eval_interval_steps", 10000),
        log_interval=config.get("log_interval_steps", 1000))
    if resume_path is not None:
        trainer.load_checkpoint(resume_path,
                                restore_training_state=resume_training_state)
        if resume_training_state:
            logging.info("Resumed from %s at step %d", resume_path, trainer.steps)
        else:
            logging.info("Loaded weights from %s (fine-tune start)", resume_path)

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
    parser = argparse.ArgumentParser(description="Train HiFi-GAN (PyTorch)")
    parser.add_argument("--model_config", type=str, required=True)
    parser.add_argument("--root_dir", type=str, required=True, nargs="+")
    parser.add_argument("--stage_dir", type=str, required=True)
    parser.add_argument("--resume_path", type=str, default=None)
    parser.add_argument("--resume_training_state", action="store_true",
                        help="restore the step, the optimizers and the schedules "
                        "from --resume_path (a true resume, not a fine-tune)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    train(args.model_config, args.root_dir, args.stage_dir, args.resume_path,
          args.resume_training_state, args.device)


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s, %(levelname)-4s [%(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S", level=logging.INFO)
    main()
