"""Tiny voices and mixes for the CPU tests: the configurations' structure
(causal HiFi-GAN with the repeat and transposed paths, MRF blocks, NSF)
at widths and lengths a CPU run holds."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def tiny_cfg(name: str) -> dict:
    cfg = copy.deepcopy(load("configs", f"{name}.json"))
    p = cfg["hifigan"]["Model"]["Generator"]["params"]
    p.update(channels=16, upsample_scales=[2, 3], upsample_kernal_sizes=[4, 6],
             resblock_kernel_sizes=[3, 5], resblock_dilations=[[1, 3], [1, 3]])
    cfg["audio_config"].update(sampling_rate=2400, hop_length=6)
    if "nsf_params" in p:
        p["nsf_params"] = {"nb_harmonics": 3, "sampling_rate": 2400}
    return cfg


def tiny_mix(name: str, batch: int = 3) -> dict:
    mix = copy.deepcopy(load("traffic", f"{name}.json"))
    mix.update(batch=batch, frame_bucket=10)
    mix["lengths"].update(min_s=0.02, mean_s=0.12, max_s=0.2, pool=64, strata=8)
    mix["mel"]["bank_frames"] = 512
    mix["check"] = {"calls": 2, "first_calls": 3}
    return mix


def tiny_gan_cfg() -> dict:
    """voice16k_mas with a narrow generator, narrow discriminators of the
    same structure (MSD with its db3 scales and spectral norm on scale 0,
    MPD) and a short mel loss."""
    cfg = tiny_cfg("voice16k_mas")
    cfg["audio_config"].update(n_fft=128, win_length=64, fmin=0.0, fmax=1200.0)
    model = cfg["hifigan"]["Model"]
    msd = model["MultiScaleDiscriminator"]["params"]["discriminator_params"]
    msd.update(channels=8, max_downsample_channels=32, max_groups=4,
               kernel_sizes=[5, 9, 5, 3], downsample_scales=[2, 2, 1])
    mpd = model["MultiPeriodDiscriminator"]["params"]
    mpd["periods"] = [2, 3]
    mpd["discriminator_params"].update(channels=4, max_downsample_channels=16,
                                       downsample_scales=[3, 3, 1])
    cfg["hifigan"]["Loss"]["mel_loss"]["params"].update(
        fs=2400, fft_size=128, hop_size=6, win_length=64, num_mels=20, fmin=0, fmax=1200)
    return cfg


def tiny_gan_mix(batch: int = 4) -> dict:
    return {"batch": batch, "path": "gan_train", "batch_max_steps": 600,
            "corpus": {"utterances": 12, "seconds": [0.3, 0.6]}}
