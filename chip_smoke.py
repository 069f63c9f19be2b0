"""Smoke run of kantts_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds kernel K1 (the MAS Viterbi, kantts_tpu_torch/csrc/mas.cu) from the
checkout and drives the port at the full width of sambert_16k_MAS and
hifigan_v1_16k, with weights made from a seed:

  0. device: the card's name and power limit; raises without a CUDA card;
  1. build K1;
  2. K1 against its plain PyTorch version, exact, at the train shape
     (32 x 576 x 128) and the long bucket (2 x 4800 x 800);
  3. the teacher-forced MAS forward (B=8, T_in 96, T_mel 576) through K1;
  4. training through ``kantts_tpu_torch.bin.train_sambert`` on a synthetic
     MAS corpus (72 utterances of 60-90 symbols and 400-570 frames, made
     with numpy): 40 steps at B=32 with K1 in every step, an exact resume
     from step 20 to step 24, and the CLI for 2 steps in a subprocess; then
     one train step timed at B=32, T_in 96, T_mel 576, and a forward and
     backward at B=4 held against the CPU's;
  5. vocoder GAN training through ``kantts_tpu_torch.bin.train_hifigan`` at
     the full width of hifigan_v1_16k (MPD, MSD with the DWT and spectral
     norm, B=16, 9600-sample crops) on a synthetic corpus of 48 harmonic
     tones of 1.2-3 s: 40 steps, a resume of the full training state from
     step 20 to 24, the CLI for 2 steps in a subprocess; then one GAN step
     timed at 16 x 9600 with its host syncs and a profile, and a step at
     B=2 held against the CPU's;
  6. text -> wav through ``python -m kantts_tpu_torch.bin.text_to_wav`` on
     4 tone-numbered pinyin lines, then the same path timed in this
     process, and the card's acoustic model and vocoder held against the
     CPU's on a short input;
  7. text -> wav with the checkpoints of step 40 of both trainings.

Each phase prints lines of its own and raises on failure. Before the last
line it prints a JSON object on the kernels; the last line is
{"ok": true, "device": {...}}. TF32 is off for matmuls and cuDNN, so every
comparison and every time is in float32.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TEXTS = ["ni3 hao3 , huan1 ying2 lai2 dao4 bei3 jing1 .",
         "jin1 tian1 tian1 qi4 hen3 hao3 , wo3 men5 qu4 gong1 yuan2 san4 bu4 ba5 .",
         "zhe4 shi4 yi2 ge4 yu3 yin1 he2 cheng2 de5 ce4 shi4 .",
         "qing3 zai4 shuo1 yi2 bian4 , xie4 xie5 ."]
HOP = 200  # samples per mel frame of hifigan_v1_16k: prod(10, 5, 2, 2)
# the keys of kantts_tpu/configs/sambert_16k_MAS.yaml that the train phase
# shortens; every width and every other key is the published config's
TRAIN_KEYS = dict(train_max_steps=40, save_interval_steps=20,
                  eval_interval_steps=20, log_interval_steps=20)
TRAIN_SHAPE = (32, 96, 576)  # B, T_in, T_mel of the timed train step
EPOCH = 50  # card vs CPU: the binarization loss at half weight
# the same for kantts_tpu/configs/hifigan_v1_16k.yaml
GAN_KEYS = dict(train_max_steps=40, save_interval_steps=20,
                eval_interval_steps=20, log_interval_steps=20)
GAN_SHAPE = (16, 9600)  # B, samples of the timed GAN step: the published crop


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn`` over n calls after one warmup call, from
    CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_device() -> str:
    """-> the card's name and power limit, as nvidia-smi gives them."""
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        yaml=importlib.util.find_spec("yaml") is not None,
        jieba=importlib.util.find_spec("jieba") is not None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from kantts_tpu_torch.ops.mas import b_mas_cuda

    b_mas_cuda.build()
    ptxas = [ln.strip() for ln in b_mas_cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(b_mas_cuda.build_seconds, 3), ptxas=ptxas)


def ragged_map(rng, B, T_mel, T_text):
    import torch

    attn = rng.rand(B, 1, T_mel, T_text).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    in_lens = rng.randint(T_text // 2, T_text + 1, B).astype(np.int32)
    out_lens = rng.randint(T_mel // 2, T_mel + 1, B).astype(np.int32)
    in_lens[0], out_lens[0] = T_text, T_mel
    return (torch.from_numpy(attn).cuda(), torch.from_numpy(in_lens).cuda(),
            torch.from_numpy(out_lens).cuda())


def compare_k1(attn, in_lens, out_lens, n_time: int):
    """-> (max_abs_err, k1 ms, plain ms); raises unless exactly equal."""
    import torch

    from kantts_tpu_torch.models.sambert.alignment import b_mas_torch
    from kantts_tpu_torch.ops.mas import b_mas_cuda

    hard = b_mas_cuda(attn, in_lens, out_lens)
    ref = b_mas_torch(attn, in_lens, out_lens)
    torch.cuda.synchronize()
    err = (hard - ref).abs().max().item()
    if not torch.equal(hard, ref):
        raise AssertionError(f"K1 differs from b_mas_torch: max |diff| {err}")
    if not torch.equal(hard.sum(dim=(1, 2, 3)), out_lens.float()):
        raise AssertionError("K1: one aligned column per valid mel frame expected")
    k1_ms = cuda_ms(lambda: b_mas_cuda(attn, in_lens, out_lens), n_time)
    plain_ms = cuda_ms(lambda: b_mas_torch(attn, in_lens, out_lens), n_time)
    return err, k1_ms, plain_ms


def phase_k1():
    rng = np.random.RandomState(0)
    errs = []
    for B, T_mel, T_text, n in ((32, 576, 128, 5), (2, 4800, 800, 2)):
        err, k1_ms, plain_ms = compare_k1(*ragged_map(rng, B, T_mel, T_text), n)
        errs.append(err)
        log("k1", shape=f"{B}x{T_mel}x{T_text}", equal=True, k1_ms=round(k1_ms, 4),
            plain_ms=round(plain_ms, 4))
    return max(errs)


def mas_batch(cfg, B=8, T_in=96, T_mel=576, seed=0):
    """A MAS training batch made with numpy: ragged lengths, frame-level
    prosody targets and a normalised random attention prior."""
    import torch

    rng = np.random.RandomState(seed)
    in_lens = rng.randint(T_in // 2, T_in, B)
    out_lens = rng.randint(T_mel // 6, T_mel // 3 + 1, B) * 3
    in_lens[0], out_lens[0] = T_in, T_mel
    prior = np.abs(rng.randn(B, T_mel, T_in)).astype(np.float32) + 0.1
    prior /= prior.sum(axis=2, keepdims=True)
    ling = np.stack([rng.randint(0, cfg[k], (B, T_in))
                     for k in ("sy", "tone", "syllable_flag", "word_segment")], -1)
    arrays = dict(
        inputs_ling=ling, inputs_emotion=rng.randint(0, cfg["emotion"], (B, T_in)),
        inputs_speaker=rng.randint(0, cfg["speaker"], (B, T_in)),
        input_lengths=in_lens, output_lengths=out_lens,
        mel_targets=rng.randn(B, T_mel, cfg["num_mels"]).astype(np.float32),
        pitch_targets=np.abs(rng.randn(B, T_mel)).astype(np.float32),
        energy_targets=np.abs(rng.randn(B, T_mel)).astype(np.float32),
        attn_priors=prior)
    return {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in arrays.items()}


def phase_mas_forward():
    """-> (K1 launches in the forward, K1 ms and plain ms at its shape)."""
    import torch

    from kantts_tpu_torch.configs import get_config
    from kantts_tpu_torch.models.builder import build_sambert, sambert_params
    from kantts_tpu_torch.models.sambert.alignment import b_mas_torch
    from kantts_tpu_torch.ops.mas import b_mas_cuda

    config = get_config("sambert_16k_MAS")
    model = build_sambert(config, seed=0).cuda()
    batch = mas_batch(sambert_params(config))
    b_mas_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        res = model(**batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = b_mas_cuda.launches
    if launches < 1:
        raise AssertionError("the MAS forward did not launch K1")

    hard = res["attn_hard"]
    if not torch.equal(hard, b_mas_torch(res["attn_soft"], batch["input_lengths"],
                                         batch["output_lengths"])):
        raise AssertionError("MAS forward: K1's alignment differs from b_mas_torch")
    mas_durs = hard.sum(dim=2)[:, 0, :]
    if not torch.equal(mas_durs.sum(dim=1), batch["output_lengths"].float()):
        raise AssertionError("MAS durations do not sum to the output lengths")
    for key in ("dec_outputs", "postnet_outputs", "log_duration_predictions",
                "pitch_predictions", "energy_predictions", "attn_soft"):
        if not torch.isfinite(res[key]).all():
            raise AssertionError(f"MAS forward: {key} is not finite")
    B, T_mel = batch["mel_targets"].shape[:2]
    if res["postnet_outputs"].shape != (B, T_mel, 80):
        raise AssertionError(f"MAS forward: mel {tuple(res['postnet_outputs'].shape)}")
    _, k1_ms, plain_ms = compare_k1(res["attn_soft"].contiguous(),
                                    batch["input_lengths"].int(),
                                    batch["output_lengths"].int(), 5)
    log("mas_forward", shape=f"B={B} T_in={hard.shape[-1]} T_mel={T_mel}",
        k1_launches=launches, forward_s=round(seconds, 4),
        k1_ms=round(k1_ms, 4), plain_ms=round(plain_ms, 4))
    return launches, k1_ms, plain_ms


def check_wavs(out_dir: str) -> int:
    """Every sentence wav is finite, non-empty, in [-1, 1] and HOP samples
    per mel frame; one joined wav per text line. -> number of sentences."""
    from scipy.io import wavfile

    chunks = sorted(glob.glob(os.path.join(out_dir, "wav_chunks", "*.wav")))
    if not chunks:
        raise AssertionError("text_to_wav wrote no wav")
    for path in chunks:
        sr, pcm = wavfile.read(path)
        wav = pcm.astype(np.float32) / 32768.0
        stem = os.path.splitext(os.path.basename(path))[0]
        frames = np.load(os.path.join(out_dir, "feat", f"{stem}.npy")).shape[0]
        if not (sr == 16000 and wav.size > 0 and np.isfinite(wav).all()
                and np.abs(wav).max() <= 1.0 and wav.size == HOP * frames):
            raise AssertionError(f"{path}: sr {sr}, {wav.size} samples for "
                                 f"{frames} frames")
    joined = glob.glob(os.path.join(out_dir, "res_wavs", "*.wav"))
    if len(joined) != len(TEXTS):
        raise AssertionError(f"{len(joined)} joined wavs for {len(TEXTS)} lines")
    return len(chunks)


def phase_text_to_wav(tmp: str):
    import torch

    from kantts_tpu_torch.bin.text_to_wav import text_to_wav
    from kantts_tpu_torch.configs import get_config
    from kantts_tpu_torch.models.builder import model_builder, save_checkpoint

    am_cfg = get_config("sambert_16k_MAS")
    # random weights predict ~0 frames per phone; this bias gives about 8,
    # so utterances get realistic lengths
    am_cfg["Model"]["KanTtsSAMBERT"]["params"]["dur_pred_bias_init"] = 2.2
    voc_cfg = get_config("hifigan_v1_16k")
    am_ckpt, voc_ckpt = os.path.join(tmp, "am.pt"), os.path.join(tmp, "voc.pt")
    save_checkpoint(am_ckpt, model_builder(am_cfg, seed=1), am_cfg)
    save_checkpoint(voc_ckpt, model_builder(voc_cfg, seed=2), voc_cfg)
    text = os.path.join(tmp, "text.txt")
    with open(text, "w", encoding="utf-8") as f:
        f.write("\n".join(TEXTS) + "\n")

    out_cli = os.path.join(tmp, "cli")
    proc = subprocess.run(
        [sys.executable, "-m", "kantts_tpu_torch.bin.text_to_wav", "--txt", text,
         "--am_ckpt", am_ckpt, "--voc_ckpt", voc_ckpt, "--output_dir", out_cli,
         "--am_batch", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"text_to_wav exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    if cold["device"] != "cuda":
        raise AssertionError(f"text_to_wav ran on {cold['device']}")
    n_sent = check_wavs(out_cli)
    log("text_to_wav_cli", sentences=n_sent, am_frames=cold["am_frames"],
        audio_s=round(cold["audio_seconds"], 3),
        first_call_total_s=round(cold["total_seconds"], 3))

    device = torch.device("cuda")
    warm = text_to_wav(os.path.join(tmp, "warm"), am_ckpt, voc_ckpt, text,
                       am_batch=4, device=device)
    check_wavs(os.path.join(tmp, "warm"))
    log("text_to_wav_timed", am_batch=4, am_frames=warm["am_frames"],
        am_frames_per_s=round(warm["am_frames"] / warm["am_seconds"], 1),
        am_s=round(warm["am_seconds"], 4), voc_s=round(warm["voc_seconds"], 4),
        audio_s=round(warm["audio_seconds"], 3),
        rtf_models=round((warm["am_seconds"] + warm["voc_seconds"])
                         / warm["audio_seconds"], 5),
        rtf_wall=round(warm["total_seconds"] / warm["audio_seconds"], 5))
    return am_ckpt, voc_ckpt


def phase_card_vs_cpu(am_ckpt: str, voc_ckpt: str):
    """The card's acoustic model and vocoder against the same port on the
    CPU, on one short utterance; durations are the card's, fed to both, so
    that a rounding flip cannot fork the comparison. Tolerance 1e-3: both
    run float32 (no TF32); what differs is the order of sums, compounded
    through 12 decoder layers over the autoregressive decode."""
    import torch

    from kantts_tpu_torch.bin.infer_sambert import encode_symbol_inputs, load_am
    from kantts_tpu_torch.bin.text_to_wav import resolve_frontend
    from kantts_tpu_torch.models.builder import load_checkpoint
    from kantts_tpu_torch.models.hifigan.layers import fold_weight_norm
    from kantts_tpu_torch.models.sambert.sambert import sambert_infer

    am_gpu, ling_unit = load_am(am_ckpt, torch.device("cuda"))
    am_cpu, _ = load_am(am_ckpt, torch.device("cpu"))
    voc_gpu, _ = load_checkpoint(voc_ckpt, torch.device("cuda"))
    voc_cpu, _ = load_checkpoint(voc_ckpt, torch.device("cpu"))
    fold_weight_norm(voc_gpu)
    fold_weight_norm(voc_cpu)
    symbols = resolve_frontend("pinyin").text_to_symbols([TEXTS[3]])[0][0]
    L_in = int(np.ceil(len(ling_unit.encode_symbol_sequence(symbols)[0]) / 32) * 32)
    ling, emo, spk, lens = (torch.from_numpy(a) for a in encode_symbol_inputs(
        ling_unit, symbols, L_in))
    args = (ling.long(), emo.long(), spk.long(), lens)
    with torch.no_grad():
        res = sambert_infer(am_gpu, *(a.cuda() for a in args), L_in * 24)
        durs = torch.floor(res["duration_predictions"] + 0.5)
        budget = int(np.ceil(durs.sum().item() / 3) * 3)
        mel_gpu = sambert_infer(am_gpu, *(a.cuda() for a in args), budget,
                                duration_override=durs)["postnet_outputs"]
        mel_cpu = sambert_infer(am_cpu, *args, budget,
                                duration_override=durs.cpu())["postnet_outputs"]
        mel_err = (mel_gpu.cpu() - mel_cpu).abs().max().item()
        wav_gpu = voc_gpu(mel_cpu.cuda()).cpu()
        wav_cpu = voc_cpu(mel_cpu)
        wav_err = (wav_gpu - wav_cpu).abs().max().item()
    if not (mel_err <= 1e-3 and wav_err <= 1e-3):
        raise AssertionError(f"card vs CPU: mel {mel_err}, wav {wav_err} > 1e-3")
    log("card_vs_cpu", frames=budget, mel_max_abs_err=mel_err,
        wav_max_abs_err=wav_err, tol=1e-3)


def train_config(path: str, name: str = "sambert_16k_MAS", **keys) -> str:
    """kantts_tpu/configs/{name}.yaml with ``keys`` replaced, written to
    ``path``."""
    import yaml

    with open(os.path.join(ROOT, "kantts_tpu", "configs", f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(keys)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def ckpt_path(stage: str, steps: int) -> str:
    return os.path.join(stage, "ckpt", f"checkpoint_{steps}.ckpt")


def phase_train(tmp: str):
    """Full-width MAS training through train_sambert's train(): 40 steps,
    a resume from step 20 to 24, and 2 steps of the CLI in a subprocess.
    -> (the 40-step trainer, K1 launches in its run)."""
    import torch

    from kantts_tpu_torch.bin.train_sambert import train
    from kantts_tpu_torch.ops.mas import b_mas_cuda
    from kantts_tpu_torch.utils.corpus import write_mas_corpus

    data = os.path.join(tmp, "corpus")
    write_mas_corpus(data, 72, (60, 90), (400, 570), seed=0)
    stage = os.path.join(tmp, "train")
    steps = TRAIN_KEYS["train_max_steps"]
    b_mas_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = train(train_config(os.path.join(stage, "model.yaml"), **TRAIN_KEYS),
                    data, stage)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = b_mas_cuda.launches
    if trainer.steps_taken != steps:
        raise AssertionError(f"{trainer.steps_taken} train steps, expected {steps}")
    if launches < steps:
        raise AssertionError(f"K1 launched {launches} times in {steps} train steps")
    for kind, at, means in trainer.history:
        bad = {k: v for k, v in means.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"{kind} metrics at step {at} not finite: {bad}")
    for at in (20, 40):
        if not os.path.exists(ckpt_path(stage, at)):
            raise AssertionError(f"no checkpoint at step {at}")
    first, last = (torch.load(ckpt_path(stage, at), map_location="cpu",
                              weights_only=True)["model"] for at in (20, 40))
    moved, _ = moved_share(first, last)
    if moved < 0.9 * len(first):
        raise AssertionError(f"only {moved} of {len(first)} tensors moved "
                             "between steps 20 and 40")
    total = {f"{kind}@{at}": round(m[f"{kind}/TotalLoss"], 4)
             for kind, at, m in trainer.history}
    log("train", steps=steps, batch=trainer.config["batch_size"],
        seconds=round(seconds, 3), k1_launches=launches,
        steps_per_s_21_to_40=round(trainer.history[-1][2]["train/steps_per_sec"], 3),
        total_loss=json.dumps(total).replace(" ", ""),
        tensors_moved_20_to_40=f"{moved}/{len(first)}")

    resumed = os.path.join(tmp, "train_resumed")
    t0 = time.perf_counter()
    again = train(train_config(os.path.join(resumed, "model.yaml"),
                               **dict(TRAIN_KEYS, train_max_steps=24)),
                  data, resumed, resume_path=ckpt_path(stage, 20))
    if again.steps_taken != 4 or not os.path.exists(ckpt_path(resumed, 24)):
        raise AssertionError(f"resume from 20 to 24 ran {again.steps_taken} steps")
    if again.scheduler.last_epoch != 24:
        raise AssertionError(f"resumed schedule at {again.scheduler.last_epoch}")
    log("train_resume", from_step=20, to_step=24, steps_run=again.steps_taken,
        seconds=round(time.perf_counter() - t0, 3))
    del again

    cli = os.path.join(tmp, "train_cli")
    cfg = train_config(os.path.join(cli, "model.yaml"),
                       **dict(TRAIN_KEYS, train_max_steps=2))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kantts_tpu_torch.bin.train_sambert",
         "--model_config", cfg, "--root_dir", data, "--stage_dir", cli],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or not os.path.exists(ckpt_path(cli, 2)):
        raise RuntimeError(f"train_sambert exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    log("train_cli", steps=2, seconds=round(time.perf_counter() - t0, 3))
    return trainer, launches


def gan_config(path: str, **keys) -> str:
    return train_config(path, "hifigan_v1_16k", **dict(GAN_KEYS, **keys))


def moved_share(first: dict, last: dict) -> tuple:
    """-> (tensors that differ, tensors) between two state dicts."""
    import torch

    return sum(not torch.equal(first[k], last[k]) for k in first), len(first)


def phase_voc_train(tmp: str):
    """Full-width GAN training through train_hifigan's train(): 40 steps, a
    resume of the full training state from step 20 to 24, and 2 steps of
    the CLI in a subprocess. -> the 40-step trainer."""
    import torch

    from kantts_tpu_torch.bin.train_hifigan import train
    from kantts_tpu_torch.utils.corpus import write_voc_corpus

    data = os.path.join(tmp, "voc_corpus")
    t0 = time.perf_counter()
    write_voc_corpus(data, 48, (1.2, 3.0), seed=0)
    corpus_s = time.perf_counter() - t0
    stage = os.path.join(tmp, "voc_train")
    steps = GAN_KEYS["train_max_steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = train(gan_config(os.path.join(stage, "model.yaml")), data, stage,
                    device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if trainer.steps_taken != steps:
        raise AssertionError(f"{trainer.steps_taken} GAN steps, expected {steps}")
    for kind, at, means in trainer.history:
        bad = {k: v for k, v in means.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"GAN {kind} metrics at step {at} not finite: {bad}")
    for at in (20, 40):
        if not os.path.exists(ckpt_path(stage, at)):
            raise AssertionError(f"no GAN checkpoint at step {at}")
    first, last = (torch.load(ckpt_path(stage, at), map_location="cpu",
                              weights_only=True)["model"] for at in (20, 40))
    moved = {"generator": moved_share(first["generator"], last["generator"])}
    for name in first["discriminator"]:
        moved[name] = moved_share(first["discriminator"][name],
                                  last["discriminator"][name])
        # a one-element u (a conv_post's) is +-1 after its first update
        us = [k for k, v in first["discriminator"][name].items()
              if k.endswith("weight_u") and v.numel() > 1]
        stuck = [k for k in us if torch.equal(first["discriminator"][name][k],
                                              last["discriminator"][name][k])]
        if stuck:
            raise AssertionError(f"{name}: spectral vectors did not move: {stuck}")
    for name, (n, total) in moved.items():
        if n < 0.9 * total:
            raise AssertionError(f"{name}: only {n} of {total} tensors moved "
                                 "between steps 20 and 40")
    n_params = {name: sum(p.numel() for p in m.parameters()) for name, m in
                [("generator", trainer.generator), *trainer.discriminators.items()]}
    means = {f"{kind}@{at}": {k.split("/")[1]: round(v, 4) for k, v in m.items()
                              if k.split("/")[1] in ("mel_loss", "generator_loss",
                                                     "discriminator_loss")}
             for kind, at, m in trainer.history}
    log("voc_train", steps=steps, batch=trainer.config["batch_size"],
        crop=trainer.config["batch_max_steps"], corpus_s=round(corpus_s, 3),
        seconds=round(seconds, 3),
        steps_per_s_21_to_40=round(trainer.history[-1][2]["train/steps_per_sec"], 3),
        params=json.dumps(n_params).replace(" ", ""),
        losses=json.dumps(means).replace(" ", ""),
        tensors_moved_20_to_40=json.dumps(
            {k: f"{n}/{t}" for k, (n, t) in moved.items()}).replace(" ", ""))

    resumed = os.path.join(tmp, "voc_resumed")
    t0 = time.perf_counter()
    again = train(gan_config(os.path.join(resumed, "model.yaml"), train_max_steps=24),
                  data, resumed, resume_path=ckpt_path(stage, 20),
                  resume_training_state=True, device="cuda")
    if again.steps_taken != 4 or not os.path.exists(ckpt_path(resumed, 24)):
        raise AssertionError(f"GAN resume from 20 to 24 ran {again.steps_taken} steps")
    schedules = [again.gen_scheduler.last_epoch] + [
        s.last_epoch for s in again.disc_schedulers.values()]
    if schedules != [24] * len(schedules):
        raise AssertionError(f"resumed GAN schedules at {schedules}")
    log("voc_train_resume", from_step=20, to_step=24, steps_run=again.steps_taken,
        schedules=",".join(map(str, schedules)),
        seconds=round(time.perf_counter() - t0, 3))
    del again

    cli = os.path.join(tmp, "voc_cli")
    cfg = gan_config(os.path.join(cli, "model.yaml"), train_max_steps=2)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kantts_tpu_torch.bin.train_hifigan",
         "--model_config", cfg, "--root_dir", data, "--stage_dir", cli,
         "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or not os.path.exists(ckpt_path(cli, 2)):
        raise RuntimeError(f"train_hifigan exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    log("voc_train_cli", steps=2, seconds=round(time.perf_counter() - t0, 3))
    return trainer


def gan_batch(trainer, batch: int, device):
    """``batch`` crops of the longest training utterances, from a seeded
    RandomState: (wav (B, 9600, 1), mel (B, 48, 80)) on ``device``."""
    from kantts_tpu_torch.train.trainer import array_to_device

    ds = trainer.train_loader.dataset
    items = sorted((ds[i] for i in range(len(ds))), key=lambda it: -len(it[0]))
    wav, mel = ds.collate_fn(items[:batch], np.random.RandomState(0))
    return array_to_device(wav, device), array_to_device(mel, device)


def profile_steps(step, n: int) -> dict:
    """``torch.profiler`` over n calls of ``step`` between synchronizes.
    -> wall ms, device busy ms (the union of kernel and copy intervals), and
    the ten device operations with the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, end = 0.0, -1.0
    by_name = collections.Counter()
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] += stop - start
    total = sum(by_name.values())
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "device_ops": len(spans), "device_op_ms": total / 1e3,
            "top": [(name[:60], round(us / 1e3, 3), round(us / total, 4))
                    for name, us in by_name.most_common(10)] if total else []}


def phase_gan_step(trainer):
    """One GAN step (both gates open) at B=16 x 9600, timed: 5 warmup steps,
    then 20 steps each between two synchronizes; host syncs of one step;
    a profile of 3 warm steps."""
    import torch

    batch = gan_batch(trainer, GAN_SHAPE[0], torch.device("cuda"))
    if tuple(batch[0].shape) != (*GAN_SHAPE, 1):
        raise AssertionError(f"timing batch {tuple(batch[0].shape)}")
    step = trainer.step_fn()
    for _ in range(5):
        step(*batch)
    torch.cuda.synchronize()
    syncs = host_syncs(lambda: step(*batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(*batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    bad = {k: v.item() for k, v in metrics.items() if not torch.isfinite(v)}
    if bad:
        raise AssertionError(f"timed GAN step: metrics not finite: {bad}")
    ms = float(np.median(times)) * 1e3
    B, T = GAN_SHAPE
    log("gan_step", shape=f"B={B}xT={T}", median_ms=round(ms, 3),
        min_ms=round(min(times) * 1e3, 3), max_ms=round(max(times) * 1e3, 3),
        gan_train_step_audio_s_per_s=round(B * T / 16000 / (ms / 1e3), 3),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
        host_syncs=len(syncs), sync_sites=",".join(
            f"{site}x{n}" for site, n in collections.Counter(syncs).items()))
    prof = profile_steps(lambda: step(*batch), 3)
    log("gan_step_profile", steps=3, wall_ms=round(prof["wall_ms"], 3),
        device_busy_ms=round(prof["busy_ms"], 3),
        device_busy_share=round(prof["busy_ms"] / prof["wall_ms"], 4),
        device_ops_per_step=prof["device_ops"] // 3,
        top=json.dumps(prof["top"]).replace(" ", ""))


def phase_gan_card_vs_cpu(trainer):
    """The GAN at full width, B=2, on the card and on the CPU from the same
    seeded weights and batch: the generator loss and its backward (the
    generator's gradient norm), the fake regenerated, the discriminator
    loss and its backward (the discriminators' gradient norm). Tolerance:
    losses rtol 1e-5, gradient norms rtol 1e-3 (float32 with TF32 off on
    both; the order of sums differs)."""
    import torch

    from kantts_tpu_torch.losses import criterion_builder
    from kantts_tpu_torch.models.builder import hifigan_gan_builder
    from kantts_tpu_torch.train.optim import global_grad_norm
    from kantts_tpu_torch.train.steps import discriminator_losses, generator_losses

    criterion = criterion_builder(trainer.config)
    out = {}
    for device in (torch.device("cuda"), torch.device("cpu")):
        built = hifigan_gan_builder(trainer.config, seed=0, device=device)
        gen, discs = built["generator"], built["discriminators"]
        wav, mel = gan_batch(trainer, 2, device)
        gen_loss, _ = generator_losses(gen, discs, criterion, wav, mel, True)
        gen_loss.backward()
        g_norm = global_grad_norm(gen.parameters())
        for d in discs.values():
            d.zero_grad(set_to_none=True)
        with torch.no_grad():
            y_fake = gen(mel).transpose(1, 2)
        dis_loss, _ = discriminator_losses(discs, criterion, wav.transpose(1, 2),
                                           y_fake)
        dis_loss.backward()
        d_norm = global_grad_norm([p for d in discs.values() for p in d.parameters()])
        out[device.type] = [gen_loss.item(), dis_loss.item(), g_norm.item(),
                            d_norm.item()]
    card, cpu = np.array(out["cuda"]), np.array(out["cpu"])
    rel = np.abs(card - cpu) / np.abs(cpu)
    log("gan_card_vs_cpu", shape="B={}xT={}".format(*wav.shape[:2]),
        gen_loss=card[0], gen_loss_cpu=cpu[0],
        dis_loss=card[1], dis_loss_cpu=cpu[1], gen_grad_norm=card[2],
        gen_grad_norm_cpu=cpu[2], dis_grad_norm=card[3], dis_grad_norm_cpu=cpu[3],
        rel_errs=",".join(f"{r:.3g}" for r in rel), tol="1e-5,1e-5,1e-3,1e-3")
    if not (np.isfinite(card).all() and (rel <= [1e-5, 1e-5, 1e-3, 1e-3]).all()):
        raise AssertionError(f"GAN card vs CPU: card {card}, CPU {cpu}")


def longest_items(trainer, n: int):
    """The n utterances of the training set with the most mel frames."""
    ds = trainer.train_loader.dataset
    return sorted((ds[i] for i in range(len(ds))), key=lambda it: -it[1].shape[0])[:n]


def host_syncs(fn) -> list:
    """Run ``fn`` once under ``torch.cuda.set_sync_debug_mode("warn")``.
    -> one entry per host sync: the innermost line of the port on the Python
    stack when it happened (a sync inside backward shows the line that
    called backward), or the three innermost frames when no line of the
    port is on the stack."""
    import traceback

    import torch

    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]
        ours = [f for f in stack if f"{os.sep}kantts_tpu_torch{os.sep}" in f.filename]
        sites.append(f"{os.path.relpath(ours[-1].filename, ROOT)}:{ours[-1].lineno}"
                     if ours else "<-".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                                            for f in stack[-3:][::-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def phase_train_step(trainer) -> float:
    """One train step at B=32, T_in 96, T_mel 576, timed: 5 warmup steps,
    then 20 steps each between two synchronizes. K1's time inside the step
    comes from CUDA events around ``mas_align``; host syncs are what
    ``torch.cuda.set_sync_debug_mode`` reports for one step. -> K1 ms."""
    import torch

    import kantts_tpu_torch.models.sambert.sambert as sambert_module
    from kantts_tpu_torch.train.trainer import batch_to_device

    ds = trainer.train_loader.dataset
    batch = batch_to_device(ds.collate_fn(longest_items(trainer, TRAIN_SHAPE[0])),
                            torch.device("cuda"))
    shape = (*batch["input_lings"].shape[:2], batch["mel_targets"].shape[1])
    if shape != TRAIN_SHAPE:
        raise AssertionError(f"timing batch {shape}, expected {TRAIN_SHAPE}")
    step = trainer.train_step_fn
    for _ in range(5):
        step(batch, 0)
    torch.cuda.synchronize()

    syncs = host_syncs(lambda: step(batch, 0))

    events = []
    mas_align = sambert_module.mas_align

    def timed_mas_align(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = mas_align(*args)
        end.record()
        events.append((start, end))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    sambert_module.mas_align = timed_mas_align
    try:
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(batch, 0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        sambert_module.mas_align = mas_align
    if not np.isfinite(metrics["TotalLoss"].item()):
        raise AssertionError("timed train step: loss not finite")
    ms = float(np.median(times)) * 1e3
    k1_ms = float(np.median([s.elapsed_time(e) for s, e in events]))
    B, _, T_mel = TRAIN_SHAPE
    log("train_step", shape="B={}xT_in={}xT_mel={}".format(*TRAIN_SHAPE),
        median_ms=round(ms, 3), min_ms=round(min(times) * 1e3, 3),
        max_ms=round(max(times) * 1e3, 3),
        train_step_mel_frames_per_s=round(B * T_mel / (ms / 1e3), 1),
        k1_ms=round(k1_ms, 4), k1_share=round(k1_ms / ms, 5),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
        host_syncs=len(syncs), sync_sites=",".join(
            f"{site}x{n}" for site, n in collections.Counter(syncs).items()))
    return k1_ms


def phase_train_card_vs_cpu(trainer):
    """One forward and backward at full width, B=4, on the card and on the
    CPU: the same seeded weights and batch, train() mode with every
    dropout's p at 0, the binarization loss at epoch 50. The CPU side takes
    the card's hard alignment, so that a rounding flip in the Viterbi cannot
    fork the comparison; whether its own alignment agrees is printed.
    Tolerance: total loss rtol 1e-4, global grad norm rtol 1e-3 (float32
    with TF32 off on both; the order of sums differs, and CUDA's CTC
    backward accumulates with atomics)."""
    import copy

    import torch
    from torch import nn

    import kantts_tpu_torch.models.sambert.sambert as sambert_module
    from kantts_tpu_torch.losses import criterion_builder
    from kantts_tpu_torch.models.builder import build_sambert
    from kantts_tpu_torch.train.optim import global_grad_norm
    from kantts_tpu_torch.train.steps import sambert_losses
    from kantts_tpu_torch.train.trainer import batch_to_device

    batch_np = trainer.train_loader.dataset.collate_fn(longest_items(trainer, 4))
    criterion = criterion_builder(trainer.config)
    cpu_model = build_sambert(trainer.config, seed=0)
    card_model = copy.deepcopy(cpu_model).cuda()
    mas_align = sambert_module.mas_align
    hard = {}

    def card_mas(*args):
        hard["card"] = mas_align(*args)
        return hard["card"]

    def cpu_mas(*args):
        hard["cpu"] = mas_align(*args)
        return hard["card"].cpu()

    out = {}
    for name, model, device, align in (
            ("card", card_model, torch.device("cuda"), card_mas),
            ("cpu", cpu_model, torch.device("cpu"), cpu_mas)):
        for m in model.modules():
            if isinstance(m, nn.Dropout):
                m.p = 0.0
        model.train()
        sambert_module.mas_align = align
        try:
            loss, _ = sambert_losses(model, criterion,
                                     batch_to_device(batch_np, device), EPOCH, True)
            loss.backward()
        finally:
            sambert_module.mas_align = mas_align
        out[name] = (loss.item(), global_grad_norm(model.parameters()).item())
    (loss_card, norm_card), (loss_cpu, norm_cpu) = out["card"], out["cpu"]
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    norm_rel = abs(norm_card - norm_cpu) / abs(norm_cpu)
    log("train_card_vs_cpu", shape=f"B=4xT_in={batch_np['input_lings'].shape[1]}"
                                   f"xT_mel={batch_np['mel_targets'].shape[1]}",
        loss_card=loss_card, loss_cpu=loss_cpu, loss_rel_err=loss_rel,
        grad_norm_card=norm_card, grad_norm_cpu=norm_cpu, grad_norm_rel_err=norm_rel,
        cpu_alignment_equal=bool(torch.equal(hard["cpu"], hard["card"].cpu())),
        tol="1e-4,1e-3")
    if not (np.isfinite([loss_card, norm_card]).all() and loss_rel <= 1e-4
            and norm_rel <= 1e-3):
        raise AssertionError(f"train card vs CPU: loss {loss_card} vs {loss_cpu}, "
                             f"grad norm {norm_card} vs {norm_cpu}")


def phase_train_to_serve(tmp: str, am_ckpt: str, voc_ckpt: str):
    """text_to_wav with both trained checkpoints: the acoustic model and the
    generator of the GAN checkpoint."""
    import torch

    from kantts_tpu_torch.bin.text_to_wav import text_to_wav

    out = os.path.join(tmp, "from_trained")
    stats = text_to_wav(out, am_ckpt, voc_ckpt, os.path.join(tmp, "text.txt"),
                        am_batch=4, device=torch.device("cuda"))
    log("train_to_serve", am_checkpoint=os.path.relpath(am_ckpt, tmp),
        voc_checkpoint=os.path.relpath(voc_ckpt, tmp),
        sentences=check_wavs(out), am_frames=stats["am_frames"],
        audio_s=round(stats["audio_seconds"], 3))


def main() -> int:
    smi = phase_device()
    phase_build()
    max_err = phase_k1()
    fwd_launches, k1_ms, plain_ms = phase_mas_forward()
    with tempfile.TemporaryDirectory(prefix="kantts_smoke_") as tmp:
        trainer, train_launches = phase_train(tmp)
        k1_step_ms = phase_train_step(trainer)
        phase_train_card_vs_cpu(trainer)
        del trainer
        voc_trainer = phase_voc_train(tmp)
        phase_gan_step(voc_trainer)
        phase_gan_card_vs_cpu(voc_trainer)
        del voc_trainer
        am_ckpt, voc_ckpt = phase_text_to_wav(tmp)
        phase_card_vs_cpu(am_ckpt, voc_ckpt)
        phase_train_to_serve(tmp, ckpt_path(os.path.join(tmp, "train"), 40),
                             ckpt_path(os.path.join(tmp, "voc_train"), 40))
    import torch

    print(json.dumps({"kernels": [{
        "name": "K1 mas_width1 (MAS Viterbi)", "route": "cuda",
        "source": "kantts_tpu_torch/csrc/mas.cu",
        "replaces": "kantts_tpu/ops/mas_pallas.py:91",
        "launches": fwd_launches + train_launches,
        "launches_by_path": {"mas_forward": fwd_launches,
                             "train_sambert": train_launches},
        "max_abs_err": max_err, "ms": k1_ms, "plain_ms": plain_ms,
        "ms_in_train_step": k1_step_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
