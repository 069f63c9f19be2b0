"""Smoke run of kantts_tpu_torch on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --k1-before OLD/mas.cu   # K1 before/after only
    python3 chip_smoke.py --k2-before OLD/int8_conv.cu   # K2 before/after only
    python3 chip_smoke.py --ddp-worker RANK PORT OUT   # one rank of phase 13 (b)
    python3 chip_smoke.py --int8-export   # phase 14 alone, on seeded checkpoints
    python3 chip_smoke.py --tools   # phase 15 alone, on a 2-step GAN trainer
    python3 chip_smoke.py --trace-kernels OUT.json VOC_CKPT   # phase 15 (b)
    python3 chip_smoke.py --profiler-drops REPS   # how often the profiler loses records

Builds kernels K1 (the MAS Viterbi, kantts_tpu_torch/csrc/mas.cu) and K2
(the int8 vocoder conv, kantts_tpu_torch/csrc/int8_conv.cu) from the
checkout and drives the port at the full width of sambert_16k_MAS and
hifigan_v1_16k, with weights made from a seed:

  0. device: the card's name and power limit; raises without a CUDA card;
  1. build K1 and K2, one nvcc each, at once;
  2. K1 against its plain PyTorch version, exact, in both of its variants,
     on maps with NaN, +-inf, zero and negative cells, ties, and lengths of
     0, 1 and the full size, at widths 13, 97, 1000 and 1100; then timed
     at the train shape (32 x 576 x 128) and the long bucket
     (2 x 4800 x 800), and both variants side by side across widths (the
     crossover);
  3. the teacher-forced MAS forward (B=8, T_in 96, T_mel 576) through K1,
     and K1 timed on its soft attention;
  4. training through ``kantts_tpu_torch.bin.train_sambert`` on a synthetic
     MAS corpus (72 utterances of 60-90 symbols and 400-570 frames, made
     with numpy): 40 steps at B=32 with K1 in every step and an exact
     resume from step 20 to step 24; then one train step timed at B=32,
     T_in 96, T_mel 576, and a forward and backward at B=4 held against the
     CPU's; the CLI for 2 steps runs in a subprocess after phase 15, beside
     phase 5's;
  5. vocoder GAN training through ``kantts_tpu_torch.bin.train_hifigan`` at
     the full width of hifigan_v1_16k (MPD, MSD with the DWT and spectral
     norm, B=16, 9600-sample crops) on a synthetic corpus of 48 harmonic
     tones of 1.2-3 s: 40 steps and a resume of the full training state
     from step 20 to 24; then one GAN step timed at 16 x 9600 with its host
     syncs and a profile, and a step at B=2 held against the CPU's; then
     phase 15, and the CLIs of phases 4 and 5 for 2 steps each, in two
     subprocesses at once;
  6. text -> wav through ``python -m kantts_tpu_torch.bin.text_to_wav`` on
     4 tone-numbered pinyin lines, then ``infer_sambert`` and
     ``infer_hifigan`` through their CLIs at once (all three with no
     ``--device``, which means the card), then the path timed in this process, and the
     card's acoustic model and vocoder held against the CPU's on a short
     input;
  7. text -> wav with the checkpoints of step 40 of both trainings;
  8. serve: ``TTSService`` (max_batch 8, 20 ms window) behind the HTTP
     server on the seeded checkpoints of phase 6: 8 concurrent ``/tts``
     requests from 8 threads, each within 1 PCM16 step of ``text_to_wav``'s
     output for its text, in fewer batches than utterances; 2 ``/tts/stream``
     requests within 1 step of ``/tts``; first-chunk latency; the
     ``serve_tts`` CLI in a subprocess, drained by SIGTERM with exit code 0;
     ``stream_tts`` and ``infer_hifigan --chunked 8`` / ``--batch 4`` through
     their CLIs; the vocoder at B=1 on 5 s, plain vs chunked-8; and
     hifigan_noncausal_v1_16k through the bucketed ``hifigan_infer``, card vs
     CPU. K1 must not launch on this path.
  9. nsf: the NSF voice at the published widths of sambert_nsf_24k and
     hifigan_v1_nsf_24k, seeded, with a (2, 1) ``mvn.npy`` that the run
     writes: (a) ``text_to_wav`` with no ``--device``, 24 kHz wavs of
     frames * 240 samples; (b) the generator card vs CPU on 250 frames with
     one excitation injected into both, and the ``SourceModule`` card vs CPU
     on 5 s with its draws injected, against a tolerance derived from f32
     rounding; (c) ``infer_hifigan --chunked 8`` against plain, in-process
     within 1e-5 and through the CLI within 1 PCM16 step; (d) ``TTSService``
     answering 4 ``/tts`` requests, the vocoder's input mels denormalised,
     and ``stream`` refusing NSF; (e) 10 GAN steps of hifigan_v1_nsf_24k
     at B=16 x 9600 through ``train_hifigan`` on 24 kHz tones with exact
     f0 and uv, a timed step with its host syncs, and a step at B=2 card vs
     CPU with the excitation injected; (f) a multi-band GAN in a layout
     of this script's own (hifigan_v1_16k with 4 PQMF sub-bands, upsampling
     5, 5, 2, the MultiSpecDiscriminator at its defaults, the published
     sub-band STFT loss): 5 steps and a step card vs CPU; (g) 5 steps of
     sambert_nsf_24k through ``train_sambert`` on a duration corpus with
     frame f0 and uv; (h) the NSF vocoder at B=1 on 5 s, plain and
     chunked-8, by CUDA events, and the ``SourceModule``'s share of the
     plain call from ``torch.profiler``. K1 must not launch on this path.
 10. bf16, SE and byte: (a) full-width hifigan_v1_16k with
     ``mixed_precision``, seeded: bf16 on the card against f32 on the card
     (e_ref) and against bf16 on the CPU on 250 frames, and at B=1 on 5 s
     plain and chunked-8 in both dtypes by CUDA events, chunked-8 against
     plain in bf16; (b) 10 bf16 GAN steps through ``train_hifigan`` on
     phase 5's corpus, float32 parameters and Adam moments after, the step
     at 16 x 9600 timed beside the f32 step with host syncs and the
     convolutions' share from ``torch.profiler``, a step at B=1 card vs CPU;
     (c) 5 bf16 steps of sambert_16k_MAS through ``train_sambert`` (K1 in
     each), the step at 32 x 96 x 576 timed beside f32, acoustic inference
     at B=8 bf16 against f32, a forward and backward at B=4 card vs CPU; (d)
     ``text_to_wav`` on both bf16 checkpoints with no ``--device``; (e) the
     byte voice, sambert_16k_MAS_byte at full width: byte symbols of 4 hanzi
     lines from ``turn_text_into_bytes`` through ``text_to_wav
     --symbols_file`` with phase 6's vocoder, 5 MAS train steps on a byte
     corpus (K1 in each), the forward card vs CPU; (f) the SE voice,
     sambert_se_nsf_global_16k and hifigan_noncausal_nsf_global_v1_16k with
     a seeded 192-d ``se.npy``: ``text_to_wav --se_file``, ``TTSService``
     with ``se_file`` answering 4 ``/tts`` requests, 5 train steps on an SE
     corpus, the forward card vs CPU; K1 must not launch there. Every bf16
     result on the card lies within e_ref of the CPU's, e_ref = max
     |bf16 - f32| of the same module on the card on the same inputs.
 11. FP and Textsy-BERT at the published widths of sybert.yaml and
     sambert_fp_8k.yaml: (a) ``train_sybert`` on a 64-line synthetic symbol
     corpus, 20 steps at B=32, a resume from step 10 to 12, the CLI for 2
     steps in a subprocess with no ``--device``, one step timed with its
     host syncs, and a step at B=4 card vs CPU (loss, error rate, gradient
     norm, 1e-3 relative); (b) ``train_sambert`` on a synthetic 8 kHz FP
     corpus (fillers at the start, in the middle and at the end), 20 steps
     at B=16 warm-started from (a)'s checkpoint (every ``text_encoder``
     tensor but ``ling_proj`` copied), a resume from 10 to 12, one step
     timed with its host syncs and a profile, a forward and backward at
     B=4 card vs CPU (total loss, ``fp_loss``, gradient norm); (c)
     ``sambert_infer_fp`` at B=4 card vs CPU on (b)'s checkpoint and on the
     voice at its seeded init (whose predictor places fillers): the FP
     classes equal (the smallest top-1 minus top-2 margin printed), the
     spliced lengths equal, mels within 1e-3; then ``text_to_wav`` with no
     ``--device`` on the FP voice and a seeded hifigan_v1_8k (8 kHz wavs
     of frames * 100 samples). K1 must not launch on this path.
 12. preprocessing: (a) a synthetic raw voice of 50 utterances of 2-6 s at
     16 kHz (``write_voice_dir``, seed 0: harmonic finals on tone contours,
     noise initials, pauses, near-silent edges, a spread of loudness) with
     its prosody and interval files, and a seeded D-TDNN ``se.model`` at
     the reference's default widths; (b) ``python -m
     kantts_tpu_torch.bin.process_data`` on it with the SE audio config and
     no ``--device``: each stage's wall seconds and audio seconds per
     second, a small badlist, every kept utterance with its mel, f0, frame
     f0/uv, energy, durations and speaker embedding, durations summing to
     the mel frames; (c) ``process_data`` on a 16-utterance subset on the
     card and on the CPU: wavs, f0, uv, durations, metafiles, splits and
     the badlist equal, mels within 1e-5 / std, energy 1e-5 relative,
     speaker embeddings 1e-4 of their largest; (d) the full-width D-TDNN on
     one utterance, ms per call by CUDA events and card vs CPU; (e)
     ``train_sambert`` (sambert_16k_MAS, 4 steps at B=16 on 32 utterances of
     (b)'s am_train.lst, K1 in each) and ``train_hifigan`` (hifigan_v1_16k,
     4 steps at 16 x 9600) on (b)'s output. K1 launches in (e)'s acoustic
     training only.
 13. data parallelism: (a) ``train_sambert`` for 8 steps at B=32 on phase
     4's corpus, three runs side by side: twice plain and once under
     ``python -m torch.distributed.run --standalone --nproc_per_node 1``
     (NCCL, world size 1), the torchrun run's parameters within twice the
     plain runs' gap (on them when that is 0); (b) two ranks on cuda:0
     over gloo with CUDA tensors (``--ddp-worker`` processes): a full-width
     MAS step on 16 of 32 ragged items each, padded to the lengths the
     ranks agree on, and a hifigan_v1_16k GAN step on 8 of 16 x 9600 each,
     the ranks' states bit-equal after, and rank 0 holding each against the
     one-process step on the global batch (metrics 1e-4, gradients 1e-5 of
     their norm, parameters atol 2e-5 / rtol 1e-4 but for entries whose
     gradient is within that rule of zero, which Adam's first step may move
     by ~lr: reported); (c) this process at world size 1 on NCCL: the AM
     step at 32 x 96 x 576 and the GAN step at 16 x 9600 beside the plain
     steps, in turns, with the collectives' ms a step, the gradient bytes
     and the host syncs. K1 launches in (b) and (c).
 14. int8 and the serving artifact, on phase 6's seeded checkpoints: (a)
     K2 against its plain version, exact (the scales, the int8 activations
     read back through a 1x1 identity conv, the int32 sums, the outputs),
     at every distinct shape of hifigan_v1_16k's 104 int8 convs on 400
     frames at B=1 and B=8 with the generator's own packed int8 weights,
     each timed beside cuDNN's float32 conv and im2col + ``torch._int_mm``
     (and at B=1 the plain version), then at T=1, a T off the tile, zeros,
     saturated input, |acc| > 2^24, a static scale at B=1 and B=8, the
     non-causal conv and transposed conv, C_in off 32 (a conv and a
     transposed conv with k=7, s=3), T shorter than a tile, and more tiles
     than the cooperative grid has blocks; (b) the int8 vocoder at B=1 on
     5 s against float32 (SNR, ms, 104 K2 launches a call; K2's device
     launches and ms a call are profiled in phase 15 (b)'s fresh process,
     here one window is only logged), both vocoders at B=8 by CUDA
     events, B=4 batch invariance and static calibrated chunked-8, bit for
     bit, and card vs CPU within the two quantization errors and the
     float32 gap; (c) ``infer_hifigan --int8``
     and ``serve_tts --int8`` through their CLIs with no ``--device``; (d)
     ``export_tts export`` at its default 96 symbols and a 384-frame budget,
     float32 and ``--int8``, two processes at once: seconds and bytes; (e)
     ``export_tts synth`` in a process that cannot import the model
     classes, ``ExportedTTS`` within 1e-5 of ``fused_infer`` on the card
     (float32 and int8), first and warm times, a 24-symbol artifact card
     vs CPU, and the node count of the whole fused program exported as one
     graph. K1 must not launch.
 15. the trainers' tooling, run right after phase 5 on its full-width
     hifigan_v1_16k GAN trainer: (a) a synchronous checkpoint save beside
     two asynchronous ones (the train loop's stall, the seconds until the
     file lands, the bytes), the files equal bit for bit, then 4 steps
     with a save every 2, once sync and once async, with the loop's save
     phase seconds; (b) in a process of its own (``--trace-kernels``),
     beside the CLIs of phases 4 and 5: one K1 call (``mas_align`` at B=1,
     576 x 96) and one int8 vocoder call at B=1 on phase 5's step-40
     generator under ``utils/profiling.trace``, whose Chrome trace must
     name K1's ``mas_*`` kernels and K2's 104 ``i8_conv_kernel`` launches;
     then, once the CLIs have ended, the int8 call's wall ms between two
     synchronises beside its CUDA-event ms, and the call under
     ``torch.profiler`` (104 K2 device launches, no other K2 kernel, K2's
     device ms beside the call's wall ms); (c) whether tensorboardX,
     tensorboard and matplotlib are installed, and phase 4's and 5's eval artifacts as the
     trainers wrote them with what there is (the ``.npy`` and wav files;
     PNGs only with matplotlib, TensorBoard events only with a writer).
     K1 launches in (b).

Each phase prints lines of its own, and ``[phase_seconds]`` lines with
each phase's wall seconds and the run's total, and raises on failure.
Where a phase drives a CLI whose output it checks later, the CLI starts
in a subprocess (``Cli``) and its start-up overlaps the phase's untimed
work (checks against the CPU, short training runs), never a timed step. Before the last
line it prints a JSON object on the kernels; the last line is
{"ok": true, "device": {...}}. TF32 is off for matmuls and cuDNN, so every
comparison and every time outside phase 10's bf16 runs is in float32.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
TEXTS = ["ni3 hao3 , huan1 ying2 lai2 dao4 bei3 jing1 .",
         "jin1 tian1 tian1 qi4 hen3 hao3 , wo3 men5 qu4 gong1 yuan2 san4 bu4 ba5 .",
         "zhe4 shi4 yi2 ge4 yu3 yin1 he2 cheng2 de5 ce4 shi4 .",
         "qing3 zai4 shuo1 yi2 bian4 , xie4 xie5 ."]
HOP = 200  # samples per mel frame of hifigan_v1_16k: prod(10, 5, 2, 2)
CONFIGS = os.path.join(ROOT, "kantts_tpu_torch", "resources", "configs")
# the keys of sambert_16k_MAS.yaml that the train phase shortens; every
# width and every other key is the published config's
TRAIN_KEYS = dict(train_max_steps=40, save_interval_steps=20,
                  eval_interval_steps=20, log_interval_steps=20)
TRAIN_SHAPE = (32, 96, 576)  # B, T_in, T_mel of the timed train step
EPOCH = 50  # card vs CPU: the binarization loss at half weight
# the same for hifigan_v1_16k.yaml
GAN_KEYS = dict(train_max_steps=40, save_interval_steps=20,
                eval_interval_steps=20, log_interval_steps=20)
GAN_SHAPE = (16, 9600)  # B, samples of the timed GAN step: the published crop
NSF_SR, NSF_HOP = 24000, 240  # hifigan_v1_nsf_24k: prod(8, 5, 3, 2) samples a frame
# the keys of hifigan_v1_nsf_24k.yaml, of the multi-band variant of
# hifigan_v1_16k.yaml and of sambert_nsf_24k.yaml that phase 9 shortens
NSF_GAN_KEYS = dict(train_max_steps=10, save_interval_steps=10,
                    eval_interval_steps=10, log_interval_steps=5)
SHORT_KEYS = dict(train_max_steps=5, save_interval_steps=5, eval_interval_steps=5,
                  log_interval_steps=5)
MVN = [[170.0], [40.0]]  # the f0 mean and std of the NSF acoustic model's mvn.npy


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


class Cli:
    """A ``python -m ...`` entry point started in a subprocess now and
    checked later (``result``), so that its start-up (seconds of imports
    and CUDA set-up) overlaps this process's work in between. Started runs
    are stopped by ``stop_all`` if the smoke fails first."""

    running: list = []

    def __init__(self, name: str, args: list, env=None):
        self.name, self.t0 = name, time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)
        Cli.running.append(self)

    def result(self, timeout: float = 600, fails: bool = False) -> str:
        """Wait for the run; -> its stdout; raises with its output if it
        failed (with ``fails``, if it did not). ``seconds`` is then the wall
        from its start."""
        out, err = self.proc.communicate(timeout=timeout)
        Cli.running.remove(self)
        self.seconds = time.perf_counter() - self.t0
        if (self.proc.returncode != 0) != fails:
            raise RuntimeError(f"{self.name} exited {self.proc.returncode}:\n"
                               f"{out[-4000:]}\n{err[-4000:]}")
        return out

    @classmethod
    def stop_all(cls) -> None:
        for cli in cls.running:
            cli.proc.kill()
            cli.proc.wait()
        cls.running.clear()


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
    """Build K1 and K2 at once, one nvcc each, in two threads."""
    import threading

    from kantts_tpu_torch.ops.int8_conv import int8_conv_cuda
    from kantts_tpu_torch.ops.mas import b_mas_cuda

    errors = []

    def build(kernel):
        try:
            kernel.build()
        except BaseException as e:  # re-raised below, in this thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(k,))
               for k in (b_mas_cuda, int8_conv_cuda)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, kernel in (("K1", b_mas_cuda), ("K2", int8_conv_cuda)):
        ptxas = [ln.strip() for ln in kernel.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build", kernel=name, seconds=round(kernel.build_seconds, 3), ptxas=ptxas)
    log("build", wall_seconds=round(time.perf_counter() - t0, 3))


def ragged_map(rng, B, T_mel, T_text):
    import torch

    attn = rng.rand(B, 1, T_mel, T_text).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    in_lens = rng.randint(T_text // 2, T_text + 1, B).astype(np.int32)
    out_lens = rng.randint(T_mel // 2, T_mel + 1, B).astype(np.int32)
    in_lens[0], out_lens[0] = T_text, T_mel
    return (torch.from_numpy(attn).cuda(), torch.from_numpy(in_lens).cuda(),
            torch.from_numpy(out_lens).cuda())


def special_map(case: str, B: int, T_mel: int, T_text: int, seed: int = 7):
    """NaN, +-inf, zero and negative cells; a map of few values (ties
    everywhere); lengths of 0, 1 and the full size."""
    import torch

    rng = np.random.RandomState(seed)
    attn = rng.rand(B, 1, T_mel, T_text).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    in_lens = rng.randint(1, T_text + 1, B).astype(np.int32)
    out_lens = rng.randint(1, T_mel + 1, B).astype(np.int32)
    in_lens[0], out_lens[0] = T_text, T_mel
    if case == "nan":
        attn[0, 0, 5:9, 2:5] = np.nan
        attn[1, 0, 0, 0] = np.nan
        attn[2, 0, T_mel // 3:, 1] = np.nan
    elif case == "inf_zero_negative":
        attn[0, 0, 3:6, :4] = 0.0
        attn[1, 0, 7, 3] = np.inf
        attn[2, 0, 9:11, 2:6] = -0.5
        attn[3, 0, 4, :] = -np.inf
    elif case == "ties":
        attn = np.round(attn * T_text / 2) / (T_text / 2)
    elif case == "edge_lengths":
        in_lens[:5] = [0, 1, T_text, 1, T_text]
        out_lens[:5] = [T_mel, T_mel, 0, 1, 1]
    return tuple(torch.from_numpy(a).cuda()
                 for a in (attn.astype(np.float32), in_lens, out_lens))


def k1_bound(B: int, T_mel: int, T_text: int):
    """-> (least ms on an H100 SXM, what bounds it): the map read once and
    the output written once at 3.35 TB/s, or one log, one add and one
    compare per cell at 67 TFLOP/s in float32."""
    cells = B * T_mel * T_text
    bytes_ms = (2 * cells * 4 + 2 * B * 4) / 3.35e12 * 1e3
    ops_ms = 3 * cells / 67e12 * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


PROFILE_WINDOWS = 4  # profiled windows kernel_ms may take before it gives up


def profile_window(fn, names, n: int) -> dict:
    """n calls of ``fn`` under torch.profiler -> {kernel name: [device us of
    each of its records]} for the kernels whose names contain one of
    ``names``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    durs = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and any(k in e.name for k in names):
            durs[e.name].append(e.time_range.end - e.time_range.start)
    return durs


def kernel_ms(fn, names, n: int) -> float:
    """Device milliseconds of one call of ``fn``, over n calls under
    torch.profiler: the sum, over the kernels whose names contain one of
    ``names``, of each one's mean duration (the kernels alone, without the
    host's cost of the call).

    CUPTI now and then loses the records of a whole window, or of most of
    it (``--profiler-drops`` counts how often). Such a window is logged and
    profiled again, up to PROFILE_WINDOWS in all; then it raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_WINDOWS):
        durs = profile_window(fn, names, n)
        # the profiler can drop a kernel at the edge of its window
        if durs and all(n - 1 <= len(d) <= n for d in durs.values()):
            return sum(sum(d) / len(d) for d in durs.values()) / 1e3
        seen.append([(k[:40], len(d)) for k, d in durs.items()])
        log("profiler_drop", kernels=",".join(names), calls=n, seen=json.dumps(seen[-1]))
    raise AssertionError(f"profiler saw {seen} launches of {names} in {n} calls, "
                         f"in each of {PROFILE_WINDOWS} windows")


def phase_profiler_drops(reps: int) -> dict:
    """How often torch.profiler loses kernel records: ``reps`` rounds of
    phase 2's crossover windows (10 calls of K1 in each variant at B=8,
    T_mel 576, T_text 96-1024) -> {records of K1 seen in a window: windows}.
    A warp-variant call launches one kernel, a block-variant call two."""
    import torch

    from kantts_tpu_torch.ops.mas import b_mas_cuda

    rng = np.random.RandomState(0)
    hist = collections.Counter()
    for _ in range(reps):
        for T_text in (96, 128, 256, 512, 800, 1024):
            args = ragged_map(rng, 8, 576, T_text)
            for variant in (1, 2):
                fn = lambda: b_mas_cuda(*args, variant=variant)  # noqa: E731
                fn()
                torch.cuda.synchronize()
                durs = profile_window(fn, K1_KERNELS, 10)
                hist[sum(len(d) for d in durs.values())] += 1
    log("profiler_drops", windows=sum(hist.values()),
        records_per_window=json.dumps(dict(sorted(hist.items()))))
    return dict(hist)


K1_KERNELS = ("mas_score_kernel", "mas_warp_kernel", "mas_block_kernel")


def compare_k1(attn, in_lens, out_lens, n_time: int) -> dict:
    """K1 against b_mas_torch, exactly; raises unless equal. -> the max
    |diff|, K1's device ms per launch (profiler), the wrapper's ms per call
    and b_mas_torch's (CUDA events), and the variant the library chose."""
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
    B, _, T_mel, T_text = attn.shape
    return {"max_abs_err": err,
            "ms": kernel_ms(lambda: b_mas_cuda(attn, in_lens, out_lens),
                            K1_KERNELS, 2 * n_time),
            "call_ms": cuda_ms(lambda: b_mas_cuda(attn, in_lens, out_lens), n_time),
            "plain_ms": cuda_ms(lambda: b_mas_torch(attn, in_lens, out_lens), n_time),
            "variant": b_mas_cuda.variant(T_mel, T_text)}


def phase_k1() -> dict:
    """K1 bit-equal to b_mas_torch on maps with NaN, +-inf, zero and
    negative cells, ties and edge lengths, at odd widths and batches, in
    both variants; then timed at the train shape and the long bucket, and
    both variants side by side across widths. -> results by shape name."""
    import torch

    from kantts_tpu_torch.models.sambert.alignment import b_mas_torch
    from kantts_tpu_torch.ops.mas import b_mas_cuda

    checked = 0
    for case in ("nan", "inf_zero_negative", "ties", "edge_lengths"):
        for shape in ((5, 40, 13), (9, 70, 97), (6, 33, 1000), (5, 30, 1100)):
            for variant in (0, 1, 2) if shape[2] <= 1024 else (0,):
                attn, in_lens, out_lens = special_map(case, *shape)
                hard = b_mas_cuda(attn, in_lens, out_lens, variant=variant)
                if not torch.equal(hard, b_mas_torch(attn, in_lens, out_lens)):
                    raise AssertionError(f"K1 ({case}, {shape}, variant {variant}) "
                                         "differs from b_mas_torch")
                checked += 1
    log("k1_special_maps", maps=checked, equal=True)

    rng = np.random.RandomState(0)
    out = {}
    for name, (B, T_mel, T_text), n in (("train", (32, 576, 128), 10),
                                        ("long_bucket", (2, 4800, 800), 2)):
        res = compare_k1(*ragged_map(rng, B, T_mel, T_text), n)
        res["bound_ms"], res["bound_by"] = k1_bound(B, T_mel, T_text)
        out[name] = res
        log("k1", shape=f"{B}x{T_mel}x{T_text}", equal=True, variant=res["variant"],
            ms=round(res["ms"], 5), call_ms=round(res["call_ms"], 5),
            plain_ms=round(res["plain_ms"], 4), bound_ms=round(res["bound_ms"], 5),
            bound_by=res["bound_by"])

    # the crossover: both variants at B=8, T_mel 576, and at the long bucket
    for B, T_mel, widths in ((8, 576, (96, 128, 256, 512, 800, 1024)),
                             (2, 4800, (800,))):
        for T_text in widths:
            args = ragged_map(rng, B, T_mel, T_text)
            times = {v: kernel_ms(lambda: b_mas_cuda(*args, variant=i), K1_KERNELS, 10)
                     for i, v in ((1, "warp"), (2, "block"))}
            log("k1_variants", shape=f"{B}x{T_mel}x{T_text}",
                warp_ms=round(times["warp"], 5), block_ms=round(times["block"], 5),
                faster=min(times, key=times.get),
                library_takes=b_mas_cuda.variant(T_mel, T_text))
    return out


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
    """-> (K1 launches in the forward, compare_k1's results at its shape on
    the forward's own soft attention)."""
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
    k1 = compare_k1(res["attn_soft"].contiguous(), batch["input_lengths"].int(),
                    batch["output_lengths"].int(), 10)
    k1["bound_ms"], k1["bound_by"] = k1_bound(B, T_mel, hard.shape[-1])
    log("mas_forward", shape=f"B={B} T_in={hard.shape[-1]} T_mel={T_mel}",
        k1_launches=launches, forward_s=round(seconds, 4), variant=k1["variant"],
        k1_ms=round(k1["ms"], 5), k1_call_ms=round(k1["call_ms"], 5),
        plain_ms=round(k1["plain_ms"], 4), bound_ms=round(k1["bound_ms"], 5))
    return launches, k1


def check_wavs(out_dir: str, sr_want: int = 16000, hop: int = HOP) -> int:
    """Every sentence wav is at ``sr_want``, finite, non-empty, in [-1, 1]
    and ``hop`` samples per mel frame; one joined wav per text line. ->
    number of sentences."""
    from scipy.io import wavfile

    chunks = sorted(glob.glob(os.path.join(out_dir, "wav_chunks", "*.wav")))
    if not chunks:
        raise AssertionError("text_to_wav wrote no wav")
    for path in chunks:
        sr, pcm = wavfile.read(path)
        wav = pcm.astype(np.float32) / 32768.0
        stem = os.path.splitext(os.path.basename(path))[0]
        frames = np.load(os.path.join(out_dir, "feat", f"{stem}.npy")).shape[0]
        if not (sr == sr_want and wav.size > 0 and np.isfinite(wav).all()
                and np.abs(wav).max() <= 1.0 and wav.size == hop * frames):
            raise AssertionError(f"{path}: sr {sr}, {wav.size} samples for "
                                 f"{frames} frames")
    joined = glob.glob(os.path.join(out_dir, "res_wavs", "*.wav"))
    if len(joined) != len(TEXTS):
        raise AssertionError(f"{len(joined)} joined wavs for {len(TEXTS)} lines")
    return len(chunks)


def seeded_checkpoints(tmp: str):
    """Full-width sambert_16k_MAS (seed 1) and hifigan_v1_16k (seed 2)
    checkpoints, and TEXTS in ``tmp/text.txt``. -> (am_ckpt, voc_ckpt)."""
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
    with open(os.path.join(tmp, "text.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(TEXTS) + "\n")
    return am_ckpt, voc_ckpt


def phase_text_to_wav(tmp: str):
    import torch

    from kantts_tpu_torch.bin.text_to_wav import text_to_wav

    am_ckpt, voc_ckpt = seeded_checkpoints(tmp)
    text = os.path.join(tmp, "text.txt")

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

    # the two stages' own CLIs, also with no --device: the card; at once
    am_out, voc_out = os.path.join(tmp, "am_cli"), os.path.join(tmp, "voc_cli_wavs")
    runs = [Cli(module, ["-m", f"kantts_tpu_torch.bin.{module}", *args]) for module, args in (
            ("infer_sambert", ["--sentence", os.path.join(out_cli, "symbols.lst"),
                               "--ckpt", am_ckpt, "--output_dir", am_out,
                               "--batch", "4"]),
            ("infer_hifigan", ["--ckpt", voc_ckpt, "--input_mel",
                               os.path.join(out_cli, "feat"), "--output_dir", voc_out]))]
    for cli in runs:
        cli.result()
        log(f"{cli.name}_cli", seconds_beside_the_other=round(cli.seconds, 3))
    mels = glob.glob(os.path.join(am_out, "feat", "*_mel.npy"))
    wavs = glob.glob(os.path.join(voc_out, "*.wav"))
    if not len(mels) == len(wavs) == n_sent:
        raise AssertionError(f"stage CLIs: {len(mels)} mels, {len(wavs)} wavs for "
                             f"{n_sent} sentences")

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
    from kantts_tpu_torch.models.builder import load_checkpoint
    from kantts_tpu_torch.models.hifigan.layers import fold_weight_norm
    from kantts_tpu_torch.models.sambert.sambert import sambert_infer
    from kantts_tpu_torch.serve.service import resolve_frontend

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


def train_config(path: str, name: str = "sambert_16k_MAS", params=None,
                 **keys) -> str:
    """The port's copy of {name}.yaml with ``keys`` replaced (and the model's
    ``params`` updated), written to ``path``."""
    import yaml

    with open(os.path.join(CONFIGS, f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(keys)
    if params:
        for section in cfg["Model"].values():
            section["params"].update(params)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def ckpt_path(stage: str, steps: int) -> str:
    return os.path.join(stage, "ckpt", f"checkpoint_{steps}.ckpt")


def phase_train(tmp: str):
    """Full-width MAS training through train_sambert's train(): 40 steps
    and a resume from step 20 to 24 (the CLI runs in ``phase_train_clis``).
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
    return trainer, launches


def phase_train_clis(tmp: str, voc_ckpt: str) -> dict:
    """Phases 4 and 5's CLIs, ``train_sambert`` (no ``--device``) and
    ``train_hifigan`` for 2 steps each on their phase's corpus, and phase
    15 (b), ``trace_kernels`` on ``voc_ckpt`` (``--trace-kernels``), in
    three subprocesses at once, after both phases' timed steps. -> (b)'s
    result, with the K1 launches of its process."""
    finish_trace = start_tracer(tmp, voc_ckpt)
    runs = {}
    for module, cfg in (("train_sambert", train_config(
            os.path.join(tmp, "train_cli", "model.yaml"),
            **dict(TRAIN_KEYS, train_max_steps=2))),
                        ("train_hifigan", gan_config(
            os.path.join(tmp, "voc_cli", "model.yaml"), train_max_steps=2))):
        data = os.path.join(tmp, "corpus" if module == "train_sambert" else "voc_corpus")
        device = [] if module == "train_sambert" else ["--device", "cuda"]
        runs[module] = Cli(module, ["-m", f"kantts_tpu_torch.bin.{module}",
                                    "--model_config", cfg, "--root_dir", data,
                                    "--stage_dir", os.path.dirname(cfg), *device])
    for module, cli in runs.items():
        cli.result()
        stage = os.path.join(tmp, "train_cli" if module == "train_sambert" else "voc_cli")
        if not os.path.exists(ckpt_path(stage, 2)):
            raise AssertionError(f"{module} CLI: no checkpoint at step 2")
        log("train_cli" if module == "train_sambert" else "voc_train_cli", steps=2,
            seconds_beside_the_other=round(cli.seconds, 3))
    return finish_trace()


def start_tracer(tmp: str, voc_ckpt: str):
    """Phase 15 (b), ``trace_kernels`` in a process of its own, started. ->
    a function to call once no other process is on the card: it lets the
    tracer go on to its timings, waits for it and returns its result."""
    out = os.path.join(tmp, "trace", "trace_kernels.json")
    go = os.path.join(tmp, "trace_go")
    cli = Cli("trace_kernels", [os.path.join(ROOT, "chip_smoke.py"), "--trace-kernels",
                                out, voc_ckpt, go])

    def finish() -> dict:
        open(go, "w").close()
        cli.result()
        with open(out) as f:
            trace = json.load(f)
        log("trace", seconds_of_its_process=round(cli.seconds, 3),
            **{k: (round(v, 4) if isinstance(v, float) else json.dumps(v)
                   if isinstance(v, (list, dict)) else v) for k, v in trace.items()})
        return trace

    return finish


def gan_config(path: str, **keys) -> str:
    return train_config(path, "hifigan_v1_16k", **dict(GAN_KEYS, **keys))


def moved_share(first: dict, last: dict) -> tuple:
    """-> (tensors that differ, tensors) between two state dicts."""
    import torch

    return sum(not torch.equal(first[k], last[k]) for k in first), len(first)


def phase_voc_train(tmp: str):
    """Full-width GAN training through train_hifigan's train(): 40 steps and
    a resume of the full training state from step 20 to 24 (the CLI runs
    in ``phase_train_clis``). -> the 40-step trainer."""
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
    return trainer


def tree_leaves(tree, key=()):
    """(path, leaf) of each leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, key + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, key + (i,))
    else:
        yield key, tree


def same_checkpoint(a: str, b: str) -> int:
    """Both files loaded on the host, every leaf equal and every tensor
    bit for bit (dtype, shape, bytes). -> the tensors compared."""
    import torch

    la, lb = (dict(tree_leaves(torch.load(p, map_location="cpu", weights_only=True)))
              for p in (a, b))
    if la.keys() != lb.keys():
        raise AssertionError(f"{a} and {b} hold other entries: "
                             f"{sorted(map(str, la.keys() ^ lb.keys()))[:5]}")
    n = 0
    for key, va in la.items():
        vb = lb[key]
        if isinstance(va, torch.Tensor):
            if (va.dtype != vb.dtype or va.shape != vb.shape or not torch.equal(
                    va.reshape(-1).view(torch.uint8), vb.reshape(-1).view(torch.uint8))):
                raise AssertionError(f"{a} and {b} differ at {key}")
            n += 1
        elif va != vb:
            raise AssertionError(f"{a} and {b} differ at {key}: {va} != {vb}")
    return n


def save_stretch(trainer, steps: int, async_save: bool) -> dict:
    """``steps`` more train steps of ``trainer`` with the loop's phase timers
    on (what ``KANTTS_TRAIN_PROFILE=1`` turns on), a save every 2 steps
    (the newest kept), sync or async, no eval and no log interval. -> the
    seconds of the loop's save phase and step phase, and the wall seconds
    of ``train()``, whose end waits for the last write."""
    import torch

    trainer.config.update(async_checkpoint=async_save, keep_last_checkpoints=1)
    trainer.profile = True
    trainer.phase_seconds = collections.defaultdict(float)
    trainer.save_interval, trainer.valid_interval, trainer.log_interval = 2, 0, 10 ** 9
    first = trainer.steps
    trainer.max_steps, trainer.finish_training = first + steps - 1, False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kept = sorted(os.listdir(trainer.ckpt_dir))
    if trainer.steps != first + steps or f"checkpoint_{first + steps - 1}.ckpt" not in kept:
        raise AssertionError(f"save stretch: at step {trainer.steps}, kept {kept}")
    return {"steps": f"{first}-{first + steps - 1}", "saves": steps // 2,
            "save_s": trainer.phase_seconds["save"],
            "step_s": trainer.phase_seconds["step"], "wall_s": wall}


def trace_kernels(tmp: str, voc_ckpt: str, go: str) -> dict:
    """Phase 15 (b), in a fresh process (``--trace-kernels``): torch.profiler
    in the smoke's own process, after phases 2 and 5 had profiled, lost
    K1's records in every window of one run and in the first of another,
    while a fresh process's first window holds them. One K1 call (``mas_align``, the MAS forward's, at B=1 on a
    576 x 96 map) and one int8 vocoder call at B=1 on INT8_FRAMES under
    ``profiling.trace``: the Chrome trace it writes must name K1's
    ``mas_*`` kernels and 104 ``i8_conv_kernel`` launches (a window whose
    records CUPTI lost is traced again, up to PROFILE_WINDOWS). Then, once
    ``go`` exists (the parent writes it when the card has no other process
    on it), the int8 call's wall ms between two synchronises beside its
    CUDA-event ms, and ``k2_profile`` of the same call: K2's device
    launches and ms a call are profiled here, in a fresh process, because the smoke's own
    process loses K2's records too by phase 14 (``k2_profile_in_process``
    logs how many)."""
    import torch

    from kantts_tpu_torch.bin.infer_hifigan import load_vocoder
    from kantts_tpu_torch.models.sambert.alignment import mas_align
    from kantts_tpu_torch.utils import profiling

    gen8, _ = load_vocoder(voc_ckpt, torch.device("cuda"), quant=True)
    attn, in_lens, out_lens = ragged_map(np.random.RandomState(16), 1, 576, 96)
    mel = torch.from_numpy(np.random.RandomState(17).randn(
        1, INT8_FRAMES, 80).astype(np.float32)).cuda()

    def calls():
        # CUPTI may drop the records at the edges of a window: a small
        # kernel of no interest goes first and last
        mel.sum()
        mas_align(attn, in_lens, out_lens)
        gen8(mel)
        mel.sum()

    with torch.inference_mode():
        calls()  # warm
        seen = []
        for _ in range(PROFILE_WINDOWS):
            with profiling.trace(os.path.join(tmp, "trace")) as prof:
                calls()
            with open(prof.path) as f:
                kernels = [e["name"] for e in json.load(f)["traceEvents"]
                           if e.get("cat") == "kernel"]
            k1 = sorted({re.search(r"mas_\w+", k)[0] for k in kernels if "mas_" in k})
            k2 = sum("i8_conv_kernel" in k for k in kernels)
            if k1 and k2 == 104:
                break
            seen.append((k1, k2))
            log("profiler_drop", kernels="mas_,i8_conv_kernel", seen=json.dumps(seen[-1]))
        else:
            raise AssertionError(f"profiling.trace saw {seen} (K1 kernels, K2 launches)")
        deadline = time.perf_counter() + 900
        while not os.path.exists(go):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"no {go} within 900 s")
            time.sleep(0.05)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen8(mel)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        event_ms = cuda_ms(lambda: gen8(mel), 10)
    return {"trace_bytes": os.path.getsize(prof.path), "trace_kernels": len(kernels),
            "k1_kernels": k1, "k2_launches_in_trace": k2,
            "timed_ms": wall_ms, "cuda_event_ms": event_ms,
            "windows": len(seen) + 1, "k2_profile": k2_profile(gen8, mel)}


def tools_trainer(tmp: str):
    """Phase 15 alone (``--tools``): phase 5's corpus and a full-width
    hifigan_v1_16k trainer after 2 steps (a save and an eval at step 2).
    -> (the trainer, {"train_hifigan": (its stage, 2)})."""
    from kantts_tpu_torch.bin.train_hifigan import train
    from kantts_tpu_torch.utils.corpus import write_voc_corpus

    data, stage = os.path.join(tmp, "voc_corpus"), os.path.join(tmp, "voc_train")
    write_voc_corpus(data, 48, (1.2, 3.0), seed=0)
    keys = dict(train_max_steps=2, save_interval_steps=2, eval_interval_steps=2,
                log_interval_steps=2)
    trainer = train(gan_config(os.path.join(stage, "model.yaml"), **keys), data, stage,
                    device="cuda")
    return trainer, {"train_hifigan": (stage, 2)}


def phase_tools(tmp: str, trainer, checked: dict) -> dict:
    """Phase 15, on phase 5's full-width hifigan_v1_16k GAN trainer: (a) one
    synchronous save (seconds, bytes), then two asynchronous ones (the
    first allocates the pinned host buffers, the second reuses them): the
    train loop's stall (snapshot and submit) and the seconds until the file
    lands, each file bit for bit equal to the synchronous one; then 4 steps
    with a save every 2, sync, and 4 more, async, the loop's save phase
    seconds of each; (b) ``trace_kernels`` runs in a process of its own
    (``phase_train_clis``); (c) whether tensorboardX,
    tensorboard and matplotlib are installed, and that the trainers ran
    with what there is: in each stage of ``checked`` ({name: (stage,
    step)}) the eval's ``.npy`` and wav files, the PNGs only where the
    trainer draws them (matplotlib) and TensorBoard events only where it
    has a writer. The phase's saves go to a directory of its own, so that
    no pruning reaches phase 5's checkpoints. -> the numbers and K1's
    launches."""
    import importlib.util

    import torch

    from kantts_tpu_torch.ops.mas import b_mas_cuda

    t_phase = time.perf_counter()
    b_mas_cuda.launches = 0
    out = os.path.join(tmp, "tools")
    os.makedirs(out)
    ckpt_dir, trainer.ckpt_dir = trainer.ckpt_dir, os.path.join(out, "ckpt")
    res = {}
    sync = os.path.join(out, "sync.ckpt")
    # one config for the three files: save_checkpoint(path) is synchronous
    # whatever it says, and the interval saves (allow_async) follow it
    trainer.config["async_checkpoint"] = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_checkpoint(sync)
    res["sync_save_s"] = time.perf_counter() - t0
    res["bytes"] = os.path.getsize(sync)
    for i in (1, 2):
        path = os.path.join(out, f"async_{i}.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save_checkpoint(path, allow_async=True)
        res[f"async_{i}_stall_s"] = time.perf_counter() - t0
        trainer.wait_for_checkpoints()
        res[f"async_{i}_landed_s"] = time.perf_counter() - t0
        res["tensors_equal"] = same_checkpoint(sync, path)
        os.remove(path)
    os.remove(sync)
    log("checkpoint_save", **{k: round(v, 4) if isinstance(v, float) else v
                              for k, v in res.items()})
    for name, async_save in (("sync", False), ("async", True)):
        res[f"stretch_{name}"] = save_stretch(trainer, 4, async_save)
        log("save_stretch", mode=name, **{k: round(v, 4) if isinstance(v, float) else v
                                          for k, v in res[f"stretch_{name}"].items()})

    trainer.ckpt_dir = ckpt_dir

    installed = {m: importlib.util.find_spec(m) is not None
                 for m in ("tensorboardX", "tensorboard", "matplotlib")}
    if trainer.plots != installed["matplotlib"]:
        raise AssertionError(f"plots {trainer.plots} with matplotlib {installed}")
    for name, (stage, step) in checked.items():
        files = set(os.listdir(os.path.join(stage, f"intermediate_results_{step}")))
        want = ({"0_ref.wav", "0_gen.wav"} if name == "train_hifigan" else
                {"coarse_mel.npy", "output_mel.npy", "target_mel.npy", "0_mel.npy"})
        pngs = {f for f in files if f.endswith(".png")}
        events = glob.glob(os.path.join(stage, "log", "events.out.tfevents.*"))
        if (not want <= files or bool(pngs) != trainer.plots
                or bool(events) != (trainer.writer is not None)):
            raise AssertionError(f"{name}: intermediate results {sorted(files)}, "
                                 f"events {events}, installed {installed}")
        res[f"{name}_artifacts"] = {"files": len(files), "pngs": len(pngs),
                                    "event_files": len(events)}
    res["installed"] = dict(installed, writer=type(trainer.writer).__module__)
    res["k1_launches"] = b_mas_cuda.launches
    res["seconds"] = time.perf_counter() - t_phase
    log("tools", installed=json.dumps(installed).replace(" ", ""),
        **{k: json.dumps(res[k]).replace(" ", "") for k in res if k.endswith("_artifacts")},
        k1_launches=res["k1_launches"], phase_s=round(res["seconds"], 3))
    return res


def gan_batch(trainer, batch: int, device):
    """``batch`` crops of the longest training utterances, from a seeded
    RandomState: (wav (B, 9600, 1), mel (B, frames, channels)) on
    ``device``."""
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


def phase_gan_step(trainer, name: str = "gan_step", n_timed: int = 10,
                   profile: bool = True):
    """One GAN step (both gates open) at B=16 x 9600, timed: 5 warmup steps,
    then ``n_timed`` steps each between two synchronizes; host syncs of one
    step; with ``profile``, a profile of 3 warm steps."""
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
    for _ in range(n_timed):
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
    sr = trainer.config["audio_config"]["sampling_rate"]
    log(name, shape=f"B={B}xT={T}", sampling_rate=sr, median_ms=round(ms, 3),
        min_ms=round(min(times) * 1e3, 3), max_ms=round(max(times) * 1e3, 3),
        gan_train_step_audio_s_per_s=round(B * T / sr / (ms / 1e3), 3),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
        host_syncs=len(syncs), sync_sites=",".join(
            f"{site}x{n}" for site, n in collections.Counter(syncs).items()))
    if not profile:
        return
    prof = profile_steps(lambda: step(*batch), 3)
    log("gan_step_profile", steps=3, wall_ms=round(prof["wall_ms"], 3),
        device_busy_ms=round(prof["busy_ms"], 3),
        device_busy_share=round(prof["busy_ms"] / prof["wall_ms"], 4),
        device_ops_per_step=prof["device_ops"] // 3,
        top=json.dumps(prof["top"]).replace(" ", ""))


def gan_losses_and_norms(config, wav, mel, excitation=None) -> list:
    """[generator loss, discriminator loss, the generator's and the
    discriminators' gradient norms] of one step's two backward passes on
    ``config``'s GAN seeded as train_hifigan seeds it, on wav's device. An
    NSF generator takes ``excitation`` in place of its draws; a multi-band
    generator's sub-bands go through its PQMF."""
    import torch

    from kantts_tpu_torch.losses import criterion_builder
    from kantts_tpu_torch.models.builder import hifigan_gan_builder
    from kantts_tpu_torch.train.optim import global_grad_norm
    from kantts_tpu_torch.train.steps import discriminator_losses, generator_losses

    class Injected(torch.nn.Module):
        def __init__(self, gen, excitation):
            super().__init__()
            self.gen, self.excitation = gen, excitation

        def forward(self, mel, generator=None):
            return self.gen(mel, excitation=self.excitation)

    built = hifigan_gan_builder(config, seed=0, device=wav.device)
    gen, discs, pqmf = built["generator"], built["discriminators"], built["pqmf"]
    criterion = criterion_builder(config)
    gen_in = gen if excitation is None else Injected(gen, excitation.to(wav.device))
    gen_loss, _ = generator_losses(gen_in, discs, criterion, wav, mel, True, pqmf)
    gen_loss.backward()
    g_norm = global_grad_norm(gen.parameters())
    for d in discs.values():
        d.zero_grad(set_to_none=True)
    with torch.no_grad():
        y_fake = gen_in(mel)
        y_fake = (pqmf.synthesis(y_fake) if pqmf is not None else y_fake).transpose(1, 2)
    dis_loss, _ = discriminator_losses(discs, criterion, wav.transpose(1, 2), y_fake)
    dis_loss.backward()
    d_norm = global_grad_norm([p for d in discs.values() for p in d.parameters()])
    return [gen_loss.item(), dis_loss.item(), g_norm.item(), d_norm.item()]


def phase_gan_card_vs_cpu(trainer, name: str = "gan_card_vs_cpu"):
    """The GAN of ``trainer.config`` at full width, B=2, on the card and on
    the CPU from the same seeded weights and batch: the generator loss and
    its backward (the generator's gradient norm), the fake regenerated, the
    discriminator loss and its backward (the discriminators' gradient
    norm). An NSF generator's noise cannot match across devices, so one
    excitation, drawn on the CPU, is injected into both; a multi-band
    generator's sub-bands go through its PQMF. Tolerance: losses rtol 1e-5,
    gradient norms rtol 1e-3 (float32 with TF32 off on both; the order of
    sums differs)."""
    import torch

    from kantts_tpu_torch.models.builder import hifigan_model_builder

    wav, mel = gan_batch(trainer, 2, torch.device("cpu"))
    excitation = None
    gen = hifigan_model_builder(trainer.config, seed=0)
    if gen.nsf_params is not None:
        with torch.no_grad():
            excitation = gen(mel, excitation_only=True,
                             generator=torch.Generator().manual_seed(0))
    cpu = np.array(gan_losses_and_norms(trainer.config, wav, mel, excitation))
    card = np.array(gan_losses_and_norms(trainer.config, wav.cuda(), mel.cuda(),
                                         excitation))
    rel = np.abs(card - cpu) / np.abs(cpu)
    log(name, shape="B={}xT={}".format(*wav.shape[:2]),
        gen_loss=card[0], gen_loss_cpu=cpu[0],
        dis_loss=card[1], dis_loss_cpu=cpu[1], gen_grad_norm=card[2],
        gen_grad_norm_cpu=cpu[2], dis_grad_norm=card[3], dis_grad_norm_cpu=cpu[3],
        rel_errs=",".join(f"{r:.3g}" for r in rel), tol="1e-5,1e-5,1e-3,1e-3",
        excitation_injected=excitation is not None,
        pqmf=trainer.config["Model"]["Generator"]["params"].get("out_channels", 1) > 1)
    if not (np.isfinite(card).all() and (rel <= [1e-5, 1e-5, 1e-3, 1e-3]).all()):
        raise AssertionError(f"{name}: card {card}, CPU {cpu}")


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


def sambert_loss_and_norm(config, batch_np, device, hard=None) -> tuple:
    """One forward and backward of ``config``'s seeded SAM-BERT (train mode,
    every dropout's p at 0, binarization loss at epoch 50) on a collated
    batch. ``hard``: a hard alignment that replaces MAS's own (so that a
    rounding flip in the Viterbi cannot fork a comparison). -> (total loss,
    global gradient norm, MAS's own hard alignment or None)."""
    import torch
    from torch import nn

    import kantts_tpu_torch.models.sambert.sambert as sambert_module
    from kantts_tpu_torch.losses import criterion_builder
    from kantts_tpu_torch.models.builder import build_sambert
    from kantts_tpu_torch.train.optim import global_grad_norm
    from kantts_tpu_torch.train.steps import sambert_losses
    from kantts_tpu_torch.train.trainer import batch_to_device

    model = build_sambert(config, seed=0).to(device)
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    model.train()
    mas_align = sambert_module.mas_align
    used = {}

    def align(*args):
        used["own"] = mas_align(*args)
        return used["own"] if hard is None else hard.to(device)

    with_mas = model.mas_enable
    sambert_module.mas_align = align
    try:
        loss, _ = sambert_losses(model, criterion_builder(config),
                                 batch_to_device(batch_np, device), EPOCH, with_mas)
        loss.backward()
    finally:
        sambert_module.mas_align = mas_align
    return loss.item(), global_grad_norm(model.parameters()).item(), used.get("own")


def phase_train_card_vs_cpu(trainer):
    """One forward and backward at full width, B=4, on the card and on the
    CPU (``sambert_loss_and_norm``): the same seeded weights and batch. The
    CPU side takes the card's hard alignment, so that a rounding flip in the
    Viterbi cannot fork the comparison; whether its own alignment agrees is
    printed. Tolerance: total loss rtol 1e-4, global grad norm rtol 1e-3
    (float32 with TF32 off on both; the order of sums differs, and CUDA's
    CTC backward accumulates with atomics)."""
    import torch

    batch_np = trainer.train_loader.dataset.collate_fn(longest_items(trainer, 4))
    loss_card, norm_card, hard = sambert_loss_and_norm(trainer.config, batch_np,
                                                       torch.device("cuda"))
    loss_cpu, norm_cpu, own_cpu = sambert_loss_and_norm(trainer.config, batch_np,
                                                        torch.device("cpu"), hard)
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    norm_rel = abs(norm_card - norm_cpu) / abs(norm_cpu)
    log("train_card_vs_cpu", shape=f"B=4xT_in={batch_np['input_lings'].shape[1]}"
                                   f"xT_mel={batch_np['mel_targets'].shape[1]}",
        loss_card=loss_card, loss_cpu=loss_cpu, loss_rel_err=loss_rel,
        grad_norm_card=norm_card, grad_norm_cpu=norm_cpu, grad_norm_rel_err=norm_rel,
        cpu_alignment_equal=bool(torch.equal(own_cpu, hard.cpu())),
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


def pcm_steps(a: np.ndarray, b: np.ndarray) -> int:
    """Max difference, in PCM16 steps, of two int16 waveforms of one length."""
    if a.shape != b.shape:
        raise AssertionError(f"waveforms of {a.shape} and {b.shape} samples")
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def joined_chunks(out_dir: str, line: int) -> np.ndarray:
    """The int16 sentence wavs that text_to_wav wrote for text line ``line``
    (``wav_chunks/{line}_{j}_mel.wav``), joined as the service joins them:
    0.28 s of zeros between sentences, 0.05 s after the last."""
    from scipy.io import wavfile

    paths = sorted(glob.glob(os.path.join(out_dir, "wav_chunks", f"{line}_*_mel.wav")),
                   key=lambda p: int(os.path.basename(p).split("_")[1]))
    pieces = []
    for i, path in enumerate(paths):
        pieces.append(wavfile.read(path)[1])
        pieces.append(np.zeros(int((0.28 if i != len(paths) - 1 else 0.05) * 16000),
                               dtype=np.int16))
    return np.concatenate(pieces)


def post(port: int, path: str, text: str):
    """-> (wall seconds, response body) of one POST with a JSON text body."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps({"text": text}).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = resp.read()
    return time.perf_counter() - t0, body


# a CLI module run as ``python -m`` would run it, in a process whose PyTorch
# computes float32 as this one does (TF32 off for matmuls and cuDNN); an
# int8 path re-quantizes after any float32 difference, so its CLIs are held
# to this process's output in the same arithmetic
CLI_F32 = ("import runpy, sys, torch\n"
           "torch.backends.cuda.matmul.allow_tf32 = False\n"
           "torch.backends.cudnn.allow_tf32 = False\n"
           "sys.argv = sys.argv[1:]\n"
           "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n")


def serve_subprocess(am_ckpt: str, voc_ckpt: str, expect: np.ndarray,
                     args=(), f32_flags: bool = False) -> dict:
    """``python -m kantts_tpu_torch.bin.serve_tts`` with no --device: warm up,
    bind port 0, answer one /tts request (held to ``expect``, the in-process
    service's PCM of TEXTS[3] requested alone, so at the same shapes), drain
    and exit 0 on SIGTERM. The child runs with NVIDIA_TF32_OVERRIDE=0, the
    float32 this process set up in phase_device: PyTorch's default lets
    cuDNN use TF32, which moves this comparison past one PCM16 step.
    ``args`` go to the CLI as well; ``f32_flags`` runs it under ``CLI_F32``."""
    import signal
    import threading

    t0 = time.perf_counter()
    launcher = ["-c", CLI_F32] if f32_flags else ["-m"]
    proc = subprocess.Popen(
        [sys.executable, *launcher, "kantts_tpu_torch.bin.serve_tts", "--am_ckpt", am_ckpt,
         "--voc_ckpt", voc_ckpt, "--port", "0", "--warmup_text", TEXTS[3], *args],
        cwd=ROOT, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, NVIDIA_TF32_OVERRIDE="0"))
    lines = []
    try:
        port = None
        for line in proc.stderr:
            lines.append(line)
            if "serving on http://" in line:
                port = int(line.split("serving on http://")[1].split(" ")[0]
                           .rsplit(":", 1)[1])
                break
        if port is None:
            raise RuntimeError(f"serve_tts did not start (exit {proc.wait(60)}):\n"
                               + "".join(lines[-40:]))
        drain = threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True)
        drain.start()
        up_s = time.perf_counter() - t0
        seconds, body = post(port, "/tts", TEXTS[3])
        steps = pcm_steps(np.frombuffer(body[44:], dtype="<i2"), expect)
        if steps > 1:
            raise AssertionError(f"serve_tts: {steps} PCM steps from the service")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        drain.join(timeout=30)
        if code != 0 or not any("drained and stopped" in ln for ln in lines):
            raise RuntimeError(f"serve_tts exited {code} on SIGTERM:\n"
                               + "".join(lines[-40:]))
        if not any("on cuda" in ln for ln in lines):
            raise AssertionError("serve_tts did not serve on the card")
        return {"start_to_serving_s": up_s, "request_s": seconds, "pcm_steps": steps,
                "exit_code": code}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def vocoder_b1_times(voc_ckpt: str) -> dict:
    """The generator at B=1 on 400 mel frames (5 s), plain and chunked into
    8 windows, by CUDA events, in turns plain, chunked, chunked, plain; and
    both chunked and streamed (0.3 s chunks) held to plain at 1e-5."""
    import torch

    from kantts_tpu_torch.bin.infer_hifigan import load_vocoder
    from kantts_tpu_torch.infer.chunked import chunked_apply
    from kantts_tpu_torch.infer.streaming import stream_synthesis

    gen, _ = load_vocoder(voc_ckpt, torch.device("cuda"))
    mel = torch.from_numpy(np.random.RandomState(5).randn(1, 400, 80)
                           .astype(np.float32)).cuda()
    runs = {"plain": lambda: gen(mel), "chunked8": lambda: chunked_apply(gen, mel, 8)}
    times = collections.defaultdict(list)
    with torch.inference_mode():
        plain = runs["plain"]()
        err = (plain - runs["chunked8"]()).abs().max().item()
        streamed = np.concatenate(list(stream_synthesis(gen, mel[0].cpu().numpy(),
                                                        chunk_frames=24)))
        stream_err = float(np.abs(streamed - plain[0].cpu().numpy()).max())
        for name in ("plain", "chunked8", "chunked8", "plain"):
            times[name].append(cuda_ms(runs[name], 10))
    if not (err <= 1e-5 and stream_err <= 1e-5):
        raise AssertionError(f"vocoder vs plain: chunked-8 {err}, streamed {stream_err}")
    return {f"{k}_ms": float(np.mean(v)) for k, v in times.items()} | {
        "chunked8_max_abs_err": err, "stream_max_abs_err": stream_err}


def noncausal_card_vs_cpu(tmp: str) -> dict:
    """F1's path: hifigan_noncausal_v1_16k at full width from a seed through
    the bucketed hifigan_infer, on the card and on the CPU, on a 250-frame
    mel (padded to the 300-frame bucket). -> the PCM steps between them, and
    how far the unpadded forward's last frames are from the bucketed ones
    (what F1 was)."""
    import torch
    from scipy.io import wavfile

    from kantts_tpu_torch.bin.infer_hifigan import hifigan_infer, load_vocoder
    from kantts_tpu_torch.models.builder import hifigan_model_builder, save_checkpoint
    from kantts_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(os.path.join(CONFIGS, "hifigan_noncausal_v1_16k.yaml"))
    cfg["audio_config"] = {"sampling_rate": 16000}
    ckpt = os.path.join(tmp, "noncausal", "voc.pt")
    save_checkpoint(ckpt, hifigan_model_builder(cfg, seed=3), cfg)
    mel_dir = os.path.join(tmp, "noncausal", "mels")
    os.makedirs(mel_dir)
    mel = np.random.RandomState(6).randn(250, 80).astype(np.float32)
    np.save(os.path.join(mel_dir, "utt.npy"), mel)
    pcm = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(tmp, "noncausal", device)
        hifigan_infer(mel_dir, ckpt, out, device=device)
        pcm[device] = wavfile.read(os.path.join(out, "utt.wav"))[1]
    gen, _ = load_vocoder(ckpt, torch.device("cuda"))
    with torch.inference_mode():
        unpadded = gen(torch.from_numpy(mel[None]).cuda())[0, :, 0].cpu().numpy()
    tail = np.abs(unpadded * 32767.0 - pcm["cuda"].astype(np.float64))
    steps = pcm_steps(pcm["cuda"], pcm["cpu"])
    if steps > 1 or pcm["cuda"].shape != (250 * HOP,):
        raise AssertionError(f"noncausal vocoder: card vs CPU {steps} PCM steps, "
                             f"{pcm['cuda'].shape} samples")
    return {"card_vs_cpu_pcm_steps": steps,
            "unpadded_vs_bucketed_max_abs": float(tail.max() / 32767.0),
            "unpadded_differing_samples": int((tail > 2).sum())}


SERVE_REQUESTS = 8  # /tts requests from 8 threads: one wave of the 8 clients


def phase_serve(tmp: str, am_ckpt: str, voc_ckpt: str) -> dict:
    """The online serving path on the card at full width: TTSService
    (max_batch 8, window 20 ms) behind make_http_server; SERVE_REQUESTS
    concurrent /tts requests from 8 threads, each held to text_to_wav's output for its
    text; 2 /tts/stream requests held to /tts; first-chunk latency; the
    serve_tts CLI drained by SIGTERM, beside stream_tts and infer_hifigan
    --chunked 8 / --batch 4 through their CLIs; the vocoder at B=1 plain vs
    chunked-8; F1's non-causal path card vs CPU. K1 must not launch."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from kantts_tpu_torch.bin import infer_hifigan, stream_tts
    from kantts_tpu_torch.bin.text_to_wav import text_to_wav
    from kantts_tpu_torch.ops.mas import b_mas_cuda
    from kantts_tpu_torch.serve import TTSService, make_http_server

    if torch.backends.cudnn.benchmark:
        raise AssertionError("cudnn.benchmark is on: results would vary by run")
    t_phase = time.perf_counter()
    b_mas_cuda.launches = 0
    text = os.path.join(tmp, "text.txt")
    offline = os.path.join(tmp, "serve_offline")
    text_to_wav(offline, am_ckpt, voc_ckpt, text, am_batch=8)
    want = [joined_chunks(offline, i) for i in range(len(TEXTS))]

    t0 = time.perf_counter()
    service = TTSService.from_checkpoints(am_ckpt, voc_ckpt, max_batch=8,
                                          max_wait_ms=20)
    load_s = time.perf_counter() - t0
    httpd = None
    try:
        warmup_s = service.warmup(TEXTS[0])
        httpd = make_http_server(service, "127.0.0.1", 0)
        port = httpd.server_address[1]
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()

        order = [i % len(TEXTS) for i in range(SERVE_REQUESTS)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            replies = list(pool.map(lambda i: post(port, "/tts", TEXTS[i]), order))
        wall = time.perf_counter() - t0
        pcm = {}
        steps = []
        for i, (_, body) in zip(order, replies):
            got = np.frombuffer(body[44:], dtype="<i2")
            steps.append(pcm_steps(got, want[i]))
            pcm[i] = got
        if max(steps) > 1:
            raise AssertionError(f"/tts vs text_to_wav: PCM steps {steps}")
        health = json.loads(urllib_get(port, "/healthz"))
        if not health["batches"] < health["utterances"]:
            raise AssertionError(f"no batching: {health}")
        lat = np.array([s for s, _ in replies])
        audio_s = sum(len(pcm[i]) for i in order) / 16000

        stream_steps = []
        for i in (1, 3):
            _, body = post(port, "/tts/stream", TEXTS[i])
            stream_steps.append(pcm_steps(np.frombuffer(body, dtype="<i2"), pcm[i]))
        if max(stream_steps) > 1:
            raise AssertionError(f"/tts/stream vs /tts: PCM steps {stream_steps}")

        first_chunk = []
        for _ in range(2):
            t0 = time.perf_counter()
            chunks = service.stream(TEXTS[3])
            next(chunks)
            first_chunk.append(time.perf_counter() - t0)
            for _ in chunks:
                pass
        _, body = post(port, "/tts", TEXTS[3])  # alone: the CLI's shapes
        expect = np.frombuffer(body[44:], dtype="<i2")
        log("serve", requests=SERVE_REQUESTS, threads=8, max_batch=8, max_wait_ms=20,
            batches=health["batches"], utterances=health["utterances"],
            pcm_steps_vs_text_to_wav=max(steps), stream_pcm_steps_vs_tts=max(stream_steps),
            latency_p50_s=round(float(np.percentile(lat, 50)), 4),
            latency_p95_s=round(float(np.percentile(lat, 95)), 4),
            service_p50_ms=health.get("latency_p50_ms"),
            service_p95_ms=health.get("latency_p95_ms"),
            audio_s=round(audio_s, 3), wall_s=round(wall, 3),
            served_audio_s_per_s=round(audio_s / wall, 3),
            first_chunk_latency_s=",".join(f"{s:.4f}" for s in first_chunk),
            chunk_s=0.3, load_s=round(load_s, 3), warmup_s=round(warmup_s, 3),
            alone_vs_batched_pcm_steps=pcm_steps(expect, pcm[3]))
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        service.close()

    # the serve_tts CLI in a thread, beside stream_tts and infer_hifigan
    # below; the vocoder's timings wait for it
    cli = {}

    def serve_cli():
        try:
            cli["result"] = serve_subprocess(am_ckpt, voc_ckpt, expect)
        except BaseException as e:  # raised below, in this thread
            cli["error"] = e

    cli_thread = threading.Thread(target=serve_cli)
    cli_thread.start()

    # stream_tts (on the last line: each sentence runs at B=1, ~5 s on the
    # host) and infer_hifigan through their CLIs, with no --device
    stream_out = os.path.join(tmp, "stream_tts")
    last_line = os.path.join(tmp, "last_line.txt")
    with open(last_line, "w", encoding="utf-8") as f:
        f.write(TEXTS[3] + "\n")
    stream_tts.main(["--txt", last_line, "--am_ckpt", am_ckpt, "--voc_ckpt", voc_ckpt,
                     "--output_dir", stream_out])
    with open(os.path.join(stream_out, "streaming_report.json")) as f:
        report = json.load(f)
    from scipy.io import wavfile

    stream_cli_steps = [pcm_steps(
        wavfile.read(os.path.join(stream_out, f"{r['utt']}.wav"))[1],
        wavfile.read(os.path.join(offline, "wav_chunks", "3_0_mel.wav"))[1])
        for r in report]
    if [r["utt"] for r in report] != ["0_0"] or report[0]["device"] != "cuda" \
            or max(stream_cli_steps) > 1:
        raise AssertionError(f"stream_tts: {report}, PCM steps {stream_cli_steps}")
    log("stream_tts_cli", sentences=len(report),
        first_chunk_latency_s=",".join(f"{r['first_chunk_latency_s']:.4f}"
                                       for r in report),
        rtf=",".join(f"{r['rtf']:.4f}" for r in report),
        pcm_steps_vs_text_to_wav=max(stream_cli_steps))

    voc_steps = {}
    for name, flag in (("chunked8", ["--chunked", "8"]), ("batch4", ["--batch", "4"])):
        out = os.path.join(tmp, f"voc_{name}")
        infer_hifigan.main(["--ckpt", voc_ckpt, "--input_mel",
                            os.path.join(offline, "feat"), "--output_dir", out, *flag])
        voc_steps[name] = max(pcm_steps(
            wavfile.read(path)[1],
            wavfile.read(os.path.join(offline, "wav_chunks", os.path.basename(path)))[1])
            for path in glob.glob(os.path.join(out, "*.wav")))
        if len(glob.glob(os.path.join(out, "*.wav"))) != len(want) or voc_steps[name] > 1:
            raise AssertionError(f"infer_hifigan {flag}: {voc_steps[name]} PCM steps")
    cli_thread.join()
    if "error" in cli:
        raise cli["error"]
    log("serve_tts_cli", beside="stream_tts,infer_hifigan",
        **{k: round(v, 3) if isinstance(v, float) else v for k, v in cli["result"].items()})
    times = vocoder_b1_times(voc_ckpt)
    f1 = noncausal_card_vs_cpu(tmp)
    if b_mas_cuda.launches != 0:
        raise AssertionError(f"the serving path launched K1 {b_mas_cuda.launches} times")
    log("serve_vocoder", infer_hifigan_pcm_steps=json.dumps(voc_steps).replace(" ", ""),
        b1_5s_plain_ms=round(times["plain_ms"], 4),
        b1_5s_chunked8_ms=round(times["chunked8_ms"], 4),
        chunked8_max_abs_err=times["chunked8_max_abs_err"],
        stream_max_abs_err=times["stream_max_abs_err"],
        noncausal=json.dumps(f1).replace(" ", ""), k1_launches=b_mas_cuda.launches,
        phase_s=round(time.perf_counter() - t_phase, 3))
    return {"k1_launches": b_mas_cuda.launches}


def urllib_get(port: int, path: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return resp.read()


def nsf_mel(rng, frames: int) -> np.ndarray:
    """(1, frames, 82): a random mel, f0 of 80-300 Hz, uv 0/1 (30% unvoiced)."""
    mel = rng.randn(1, frames, 82).astype(np.float32)
    mel[..., -2] = rng.uniform(80.0, 300.0, (1, frames))
    mel[..., -1] = (rng.rand(1, frames) > 0.3).astype(np.float32)
    return mel


def nsf_checkpoints(tmp: str):
    """Seeded full-width sambert_nsf_24k (duration bias 2.2, as phase 6) and
    hifigan_v1_nsf_24k, with the acoustic model's ``mvn.npy`` two
    directories above its checkpoint. -> (AM checkpoint, vocoder's)."""
    from kantts_tpu_torch.models.builder import model_builder, save_checkpoint
    from kantts_tpu_torch.utils.config import load_yaml

    am_cfg = load_yaml(os.path.join(CONFIGS, "sambert_nsf_24k.yaml"))
    am_cfg["Model"]["KanTtsSAMBERT"]["params"]["dur_pred_bias_init"] = 2.2
    voc_cfg = load_yaml(os.path.join(CONFIGS, "hifigan_v1_nsf_24k.yaml"))
    voc_cfg.update(load_yaml(os.path.join(CONFIGS, "audio_config_24k.yaml")))
    stage = os.path.join(tmp, "nsf", "am")
    am_ckpt = os.path.join(stage, "ckpt", "am.pt")
    save_checkpoint(am_ckpt, model_builder(am_cfg, seed=1), am_cfg)
    np.save(os.path.join(stage, "mvn.npy"), np.array(MVN, dtype=np.float32))
    voc_ckpt = os.path.join(tmp, "nsf", "voc.pt")
    save_checkpoint(voc_ckpt, model_builder(voc_cfg, seed=2), voc_cfg)
    return am_ckpt, voc_ckpt


def check_nsf_mels(mels) -> None:
    """The mels an NSF vocoder gets: 82 channels, f0 >= 30 Hz, uv 0 or 1."""
    for mel in mels:
        if not (mel.shape[1] == 82 and (mel[:, -2] >= 30).all()
                and set(np.unique(mel[:, -1])) <= {0.0, 1.0}):
            raise AssertionError(f"NSF vocoder input: {mel.shape}, f0 min "
                                 f"{mel[:, -2].min()}, uv {np.unique(mel[:, -1])}")


def nsf_text_to_wav(tmp: str, am_ckpt: str, voc_ckpt: str):
    """(a) The 4-line text_to_wav CLI, with no --device, started. -> a
    function that waits for it, checks its wavs and mels and returns its
    output dir."""
    text = os.path.join(tmp, "nsf", "text.txt")
    with open(text, "w", encoding="utf-8") as f:
        f.write("\n".join(TEXTS) + "\n")
    out = os.path.join(tmp, "nsf", "cli")
    cli = Cli("NSF text_to_wav", [
        "-m", "kantts_tpu_torch.bin.text_to_wav", "--txt", text, "--am_ckpt", am_ckpt,
        "--voc_ckpt", voc_ckpt, "--output_dir", out, "--am_batch", "4"])

    def finish() -> str:
        stats = json.loads(cli.result().strip().splitlines()[-1])
        if stats["device"] != "cuda":
            raise AssertionError(f"NSF text_to_wav ran on {stats['device']}")
        n_sent = check_wavs(out, NSF_SR, NSF_HOP)
        check_nsf_mels(np.load(p) for p in glob.glob(os.path.join(out, "feat", "*_mel.npy")))
        log("nsf_text_to_wav_cli", sentences=n_sent, sampling_rate=NSF_SR,
            am_frames=stats["am_frames"], audio_s=round(stats["audio_seconds"], 3),
            first_call_total_s=round(stats["total_seconds"], 3))
        return out

    return finish


def source_tolerance(src, pitch) -> float:
    """The card-vs-CPU bound of the NSF source on these inputs, from f32
    rounding (PERF.md §6): the phase of harmonic h is the fractional
    part of a float32 running sum (``SourceModule.phase_cycles``: the
    frames' advances mod 1, so at most T); CUDA's scan and the CPU's sum
    round differently, and the bound allows 64 roundings of 2^-24 S_h,max
    each, S_h,max that sum's largest value (the card's scan reaches a
    prefix through a few dozen partial sums). A phase error e moves
    alpha sin(.) by at most alpha 2 pi e, and the ffn mixes the harmonics
    with weights w_h, tanh adding nothing: tol = alpha 2 pi sum_h |w_h| 64
    2^-24 S_h,max."""
    import torch

    harmonics = torch.arange(1, src.n_harmonics + 1, dtype=torch.float64)
    step = pitch.double() * harmonics / src.sampling_rate
    s_max = torch.cumsum(torch.remainder(step * src.upsample_ratio, 1.0),
                         dim=1).amax(dim=(0, 1))
    w = src.ffn[0].weight().detach()[0, :, 0].abs().double().cpu()
    return float(src.alpha * 2 * np.pi * (w * 64 * 2.0 ** -24 * s_max).sum())


def cycle_gap(a, b) -> float:
    """The largest distance between two phases in cycles, modulo 1."""
    import torch

    d = (a.double() - b.double()).abs()
    return torch.minimum(d, 1 - d).max().item()


def nsf_card_vs_cpu(voc_ckpt: str) -> dict:
    """(b) The full-width NSF generator on 250 frames, card vs CPU, one
    excitation (drawn on the CPU) injected into both, tolerance 1e-3 as
    phase 6's vocoder; then the SourceModule alone on 5 s (500 frames,
    120,000 samples), card vs CPU with its phase and noise injected, held
    to ``source_tolerance``. Printed beside it: the phase gap card vs CPU,
    each device's phase against a float64 sum, and, for the record, what a
    sample-by-sample float32 cumsum on the card is off by."""
    import torch

    from kantts_tpu_torch.bin.infer_hifigan import load_vocoder

    gen = {d: load_vocoder(voc_ckpt, torch.device(d))[0] for d in ("cuda", "cpu")}
    rng = np.random.RandomState(9)
    mel = torch.from_numpy(nsf_mel(rng, 250))
    with torch.inference_mode():
        exc = gen["cpu"](mel, excitation_only=True,
                         generator=torch.Generator().manual_seed(0))
        wav_cpu = gen["cpu"](mel, excitation=exc)
        wav_gpu = gen["cuda"](mel.cuda(), excitation=exc.cuda()).cpu()
    wav_err = (wav_gpu - wav_cpu).abs().max().item()

    five = torch.from_numpy(nsf_mel(rng, 500))
    pitch, uv = five[..., -2:-1], five[..., -1:]
    src = gen["cpu"].source_module
    H, sr = src.n_harmonics, src.sampling_rate
    g = torch.Generator().manual_seed(1)
    phase = (torch.rand((1, 1, H), generator=g) * 2 - 1) * np.pi
    noise = torch.randn((1, 500 * NSF_HOP, H), generator=g)
    with torch.inference_mode():
        out_cpu = src(pitch, uv, phase=phase, noise=noise)
        out_gpu = gen["cuda"].source_module(pitch.cuda(), uv.cuda(), phase=phase.cuda(),
                                            noise=noise.cuda()).cpu()
        cycles = {d: gen[d].source_module.phase_cycles(pitch.to(d)).cpu()
                  for d in ("cuda", "cpu")}
        f64 = (pitch.double().repeat_interleave(NSF_HOP, dim=1)
               * torch.arange(1, H + 1, dtype=torch.float64) / sr)
        exact = torch.remainder(torch.cumsum(f64, dim=1), 1.0)
        naive = torch.remainder(torch.cumsum(f64.float().cuda(), dim=1), 1.0).cpu()
    src_err = (out_gpu - out_cpu).abs().max().item()
    tol = source_tolerance(src, pitch)
    gaps = {"phase_gap_cycles": cycle_gap(cycles["cuda"], cycles["cpu"]),
            "card_phase_vs_f64_cycles": cycle_gap(cycles["cuda"], exact),
            "cpu_phase_vs_f64_cycles": cycle_gap(cycles["cpu"], exact),
            "card_sample_scan_vs_f64_cycles": cycle_gap(naive, exact)}
    log("nsf_card_vs_cpu", generator_frames=250, generator_max_abs_err=wav_err,
        generator_tol=1e-3, source_samples=500 * NSF_HOP, source_max_abs_err=src_err,
        source_tol=tol, **gaps)
    if not (wav_err <= 1e-3 and src_err <= tol):
        raise AssertionError(f"NSF card vs CPU: generator {wav_err} (tol 1e-3), "
                             f"source {src_err} (tol {tol})")
    return {"generator_max_abs_err": wav_err, "source_max_abs_err": src_err,
            "source_tol": tol, **gaps}


def nsf_chunked_and_times(tmp: str, voc_ckpt: str, feat_dir: str) -> dict:
    """(c) ``infer_hifigan --chunked 8`` against plain: in-process on 5 s
    within 1e-5 (both draw from the key 0 on the same shapes), and through
    the CLI within 1 PCM16 step; (h) the vocoder at B=1 on 5 s, plain and
    chunked-8, by CUDA events in turns plain, chunked, chunked, plain, and
    the SourceModule's share of a plain call's device time from
    torch.profiler."""
    import torch
    from scipy.io import wavfile
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from kantts_tpu_torch.bin import infer_hifigan
    from kantts_tpu_torch.bin.infer_hifigan import load_vocoder, vocode

    gen, _ = load_vocoder(voc_ckpt, torch.device("cuda"))
    mel = torch.from_numpy(nsf_mel(np.random.RandomState(10), 500)).cuda()
    runs = {"plain": lambda: vocode(gen, None, mel),
            "chunked8": lambda: vocode(gen, None, mel, 8)}
    times = collections.defaultdict(list)
    with torch.inference_mode():
        err = (runs["plain"]() - runs["chunked8"]()).abs().max().item()
        for name in ("plain", "chunked8", "chunked8", "plain"):
            times[name].append(cuda_ms(runs[name], 10))
        source = gen.source_module.forward

        def labelled(*args, **kwargs):
            with record_function("nsf_source_module"):
                return source(*args, **kwargs)

        gen.source_module.forward = labelled
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    runs["plain"]()
                torch.cuda.synchronize()
        finally:
            del gen.source_module.forward
    events = prof.events()
    total_us = sum(e.time_range.end - e.time_range.start for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    source_us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                    for e in events if e.name == "nsf_source_module"
                    and e.device_type == DeviceType.CPU)
    with torch.inference_mode():  # the same share from CUDA events
        source_ms = cuda_ms(lambda: gen.source_module(
            mel[..., -2:-1], mel[..., -1:],
            generator=torch.Generator(device=mel.device).manual_seed(0)), 10)
    if err > 1e-5:
        raise AssertionError(f"NSF chunked-8 vs plain: {err} > 1e-5")

    outs = {}
    for name, flag in (("plain", []), ("chunked8", ["--chunked", "8"])):
        outs[name] = os.path.join(tmp, "nsf", f"voc_{name}")
        infer_hifigan.main(["--ckpt", voc_ckpt, "--input_mel", feat_dir,
                            "--output_dir", outs[name], *flag])
    paths = sorted(glob.glob(os.path.join(outs["plain"], "*.wav")))
    if not paths:
        raise AssertionError("NSF infer_hifigan wrote no wav")
    steps = max(pcm_steps(wavfile.read(p)[1], wavfile.read(
        os.path.join(outs["chunked8"], os.path.basename(p)))[1]) for p in paths)
    if steps > 1:
        raise AssertionError(f"NSF infer_hifigan --chunked 8: {steps} PCM steps")
    result = {f"{k}_ms": float(np.mean(v)) for k, v in times.items()}
    result.update(chunked8_max_abs_err=err, cli_pcm_steps=steps,
                  source_share=source_us / total_us if total_us else None,
                  source_ms=source_us / 3e3, device_ms=total_us / 3e3,
                  source_event_share=source_ms / result["plain_ms"])
    log("nsf_vocoder", b1_5s_plain_ms=round(result["plain_ms"], 4),
        b1_5s_chunked8_ms=round(result["chunked8_ms"], 4), chunked8_max_abs_err=err,
        chunked8_tol=1e-5, cli_files=len(paths), cli_pcm_steps=steps,
        profiled_device_ms_per_call=round(result["device_ms"], 4),
        source_module_device_ms=round(result["source_ms"], 4),
        source_module_share=(round(result["source_share"], 5)
                             if result["source_share"] is not None else "not measured"),
        source_module_event_ms=round(source_ms, 4),
        source_module_event_share=round(result["source_event_share"], 5))
    return result


def nsf_serve(am_ckpt: str, voc_ckpt: str, se_file=None, sr: int = NSF_SR,
              hop: int = NSF_HOP, name: str = "nsf_serve") -> dict:
    """(d) TTSService on the NSF pair behind the HTTP server: 4 concurrent
    /tts requests at ``sr`` (24 kHz), each finite, in [-1, 1] and as long as
    its sentences' frames plus the gaps; the vocoder's input mels
    denormalised (f0 >= 30, uv 0/1); ``stream`` refuses NSF. The noise
    depends on the batch's shape, so no response is held to another run's.
    ``se_file``: an SE acoustic model's speaker embedding (phase 10)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from kantts_tpu_torch.serve import TTSService, make_http_server
    from kantts_tpu_torch.serve.server import parse_wav_bytes

    service = TTSService.from_checkpoints(am_ckpt, voc_ckpt, se_file=se_file,
                                          max_batch=8, max_wait_ms=20)
    if (service.se is not None) != (se_file is not None):
        raise AssertionError(f"{name}: the service's speaker embedding is {service.se}")
    httpd = None
    try:
        seen = []
        vocode_batch = service._vocode_batch

        def spy(mels):
            seen.extend(mels)
            return vocode_batch(mels)

        service._vocode_batch = spy
        httpd = make_http_server(service, "127.0.0.1", 0)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            replies = list(pool.map(lambda i: post(port, "/tts", TEXTS[i]), range(4)))
        wall = time.perf_counter() - t0
        check_nsf_mels(seen)
        sentence_samples = 0
        for i, (_, body) in enumerate(replies):
            got_sr, wav = parse_wav_bytes(body)
            n_sent = len(service._text_to_seqs(TEXTS[i], None, None))
            pad = int(0.28 * got_sr) * (n_sent - 1) + int(0.05 * got_sr)
            if not (got_sr == sr and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
                    and (len(wav) - pad) % hop == 0 and len(wav) > pad):
                raise AssertionError(f"{name} /tts {i}: sr {got_sr}, {len(wav)} samples")
            sentence_samples += len(wav) - pad
        if sentence_samples != hop * sum(m.shape[0] for m in seen):
            raise AssertionError(f"{name} /tts: {sentence_samples} samples for "
                                 f"{sum(m.shape[0] for m in seen)} frames")
        try:
            service.stream(TEXTS[0])
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("TTSService.stream accepted an NSF voice")
        health = service.stats_snapshot()
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        service.close()
    log(name, requests=4, batches=health["batches"],
        utterances=health["utterances"], sampling_rate=sr,
        audio_s=round(sentence_samples / sr, 3), wall_s=round(wall, 3),
        f0_min=round(float(min(m[:, -2].min() for m in seen)), 3),
        stream_refused=json.dumps(refused[:40]))
    return {"batches": health["batches"]}


def nsf_gan_train(tmp: str) -> None:
    """(e) hifigan_v1_nsf_24k as published, 10 steps at B=16 x 9600 through
    train_hifigan on 24 kHz tones whose frame f0 and uv are exact; then the
    timed step and the step at B=2 card vs CPU (excitation injected)."""
    import torch

    from kantts_tpu_torch.bin.train_hifigan import train
    from kantts_tpu_torch.utils.corpus import write_voc_corpus

    data = os.path.join(tmp, "nsf", "voc_corpus")
    t0 = time.perf_counter()
    write_voc_corpus(data, 24, (0.8, 1.6), seed=0, sampling_rate=NSF_SR, nsf=True)
    corpus_s = time.perf_counter() - t0
    stage = os.path.join(tmp, "nsf", "voc_train")
    t0 = time.perf_counter()
    trainer = train(train_config(os.path.join(stage, "model.yaml"), "hifigan_v1_nsf_24k",
                                 **NSF_GAN_KEYS), data, stage, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_run(trainer, stage, NSF_GAN_KEYS["train_max_steps"])
    if trainer.generator.nsf_params is None or trainer.config["batch_size"] != GAN_SHAPE[0]:
        raise AssertionError("phase 9 did not train the published NSF vocoder")
    log("nsf_voc_train", steps=trainer.steps_taken, batch=trainer.config["batch_size"],
        crop=trainer.config["batch_max_steps"], corpus_s=round(corpus_s, 3),
        seconds=round(seconds, 3),
        generator_params=sum(p.numel() for p in trainer.generator.parameters()),
        losses=gan_losses(trainer))
    phase_gan_step(trainer, "nsf_gan_step", n_timed=10, profile=False)
    phase_gan_card_vs_cpu(trainer, "nsf_gan_card_vs_cpu")


def check_run(trainer, stage: str, steps: int) -> None:
    """The run took ``steps`` steps with finite metrics and saved there."""
    if trainer.steps_taken != steps or not os.path.exists(ckpt_path(stage, steps)):
        raise AssertionError(f"{stage}: {trainer.steps_taken} steps, expected {steps}")
    for kind, at, means in trainer.history:
        bad = {k: v for k, v in means.items() if not np.isfinite(v)}
        if bad:
            raise AssertionError(f"{stage}: {kind} metrics at step {at} not finite: {bad}")


def gan_losses(trainer) -> str:
    return json.dumps({f"{kind}@{at}": {k.split("/")[1]: round(v, 4)
                                        for k, v in m.items() if "loss" in k}
                       for kind, at, m in trainer.history}).replace(" ", "")


def mb_gan_train(tmp: str) -> None:
    """(f) The multi-band layout, this script's own (no shipped config has
    one): hifigan_v1_16k.yaml with 4 PQMF sub-bands and upsampling 5, 5, 2
    (hop 50 a band), the MultiSpecDiscriminator at its defaults beside MSD
    and MPD, and the sub-band STFT loss with the published parameters; 5
    steps on phase 5's corpus, then a step card vs CPU."""
    import yaml

    from kantts_tpu_torch.bin.train_hifigan import train

    stage = os.path.join(tmp, "mb_train")
    path = gan_config(os.path.join(stage, "model.yaml"), **SHORT_KEYS)
    with open(path) as f:
        cfg = yaml.safe_load(f)
    model = cfg["Model"]
    model["Generator"]["params"].update(out_channels=4, upsample_scales=[5, 5, 2],
                                        upsample_kernal_sizes=[10, 10, 4])
    model["MultiSpecDiscriminator"] = {
        "params": {}, "optimizer": model["Generator"]["optimizer"],
        "scheduler": model["Generator"]["scheduler"]}
    cfg["Loss"]["subband_stft_loss"]["enable"] = True
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.perf_counter()
    trainer = train(path, os.path.join(tmp, "voc_corpus"), stage, device="cuda")
    seconds = time.perf_counter() - t0
    check_run(trainer, stage, SHORT_KEYS["train_max_steps"])
    means = trainer.history[-1][2]
    if "train/sub_spectral_convergence_loss" not in means or \
            "MultiSpecDiscriminator" not in trainer.discriminators:
        raise AssertionError(f"multi-band run: {sorted(means)}")
    log("mb_voc_train", layout="this script's own: hifigan_v1_16k, out_channels 4, "
        "upsample 5x5x2, MultiSpecDiscriminator defaults, published subband_stft_loss",
        steps=trainer.steps_taken, batch=trainer.config["batch_size"],
        seconds=round(seconds, 3), losses=gan_losses(trainer))
    phase_gan_card_vs_cpu(trainer, "mb_gan_card_vs_cpu")


def nsf_am_train(tmp: str) -> None:
    """(g) sambert_nsf_24k as published, 5 steps at B=32 through
    train_sambert on a duration corpus with frame f0 and uv (82 mel
    channels)."""
    import torch

    from kantts_tpu_torch.bin.train_sambert import train
    from kantts_tpu_torch.utils.corpus import write_am_corpus

    data = os.path.join(tmp, "nsf", "am_corpus")
    write_am_corpus(data, 40, (60, 90), (400, 570), seed=0, durations=True, nsf=True,
                    sampling_rate=NSF_SR)
    stage = os.path.join(tmp, "nsf", "am_train")
    t0 = time.perf_counter()
    trainer = train(train_config(os.path.join(stage, "model.yaml"), "sambert_nsf_24k",
                                 **SHORT_KEYS), data, stage)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps = SHORT_KEYS["train_max_steps"]
    if trainer.steps_taken != steps or not os.path.exists(ckpt_path(stage, steps)):
        raise AssertionError(f"NSF AM: {trainer.steps_taken} steps, expected {steps}")
    if not (trainer.model.d_mel == 82 and trainer.train_loader.dataset.with_duration):
        raise AssertionError("NSF AM: not an 82-channel duration model")
    for kind, at, means in trainer.history:
        if not all(np.isfinite(v) for v in means.values()):
            raise AssertionError(f"NSF AM {kind} metrics at step {at}: {means}")
    log("nsf_am_train", steps=steps, batch=trainer.config["batch_size"],
        seconds=round(seconds, 3), total_loss=json.dumps(
            {f"{k}@{a}": round(m[f"{k}/TotalLoss"], 4) for k, a, m in trainer.history}
        ).replace(" ", ""))


def phase_nsf(tmp: str) -> dict:
    """Phase 9, (a)-(h) above. K1 must not launch."""
    import torch

    from kantts_tpu_torch.ops.mas import b_mas_cuda

    t_phase = time.perf_counter()
    b_mas_cuda.launches = 0
    am_ckpt, voc_ckpt = nsf_checkpoints(tmp)
    finish_cli = nsf_text_to_wav(tmp, am_ckpt, voc_ckpt)
    gaps = nsf_card_vs_cpu(voc_ckpt)  # beside the CLI
    cli = finish_cli()
    times = nsf_chunked_and_times(tmp, voc_ckpt, os.path.join(cli, "feat"))
    nsf_serve(am_ckpt, voc_ckpt)
    nsf_gan_train(tmp)
    torch.cuda.empty_cache()
    mb_gan_train(tmp)
    nsf_am_train(tmp)
    if b_mas_cuda.launches != 0:
        raise AssertionError(f"the NSF path launched K1 {b_mas_cuda.launches} times")
    log("nsf", k1_launches=0, phase_s=round(time.perf_counter() - t_phase, 3))
    return {"k1_launches": b_mas_cuda.launches, **gaps, **times}


# ------------------------------------------------------------- phase 10

HANZI = ["你好，欢迎来到北京。", "今天天气很好，我们去公园散步吧。",
         "这是一个语音合成的测试。", "请再说一遍，谢谢。"]
SE_UNITS = 192  # speaker_units of sambert_se_nsf_global_16k
AM_INFER_FRAMES = 576  # the frame budget of phase 10's acoustic inference at B=8
# phase 10's 5-step SAM-BERT runs; allow_cache makes each item's
# beta-binomial prior (~0.5 s of host time at these lengths) once, not per pass
CACHED_SHORT_KEYS = dict(SHORT_KEYS, allow_cache=True)
BF16_GAN_KEYS = dict(mixed_precision=True, train_max_steps=10, save_interval_steps=10,
                     eval_interval_steps=10, log_interval_steps=5)


def within_e_ref(name: str, card16, cpu16, card16_vs_32) -> dict:
    """The bf16 rule (PERF.md): e_ref = max |bf16 - f32| of the same module on
    the card on the same inputs; the card's bf16 result lies within e_ref of
    the CPU's bf16 result. Each argument is an array, or a list of scalars
    held one by one. -> the gaps and e_refs; raises on a miss."""
    card16, cpu16, e_ref = (np.atleast_1d(np.asarray(a, dtype=np.float64))
                            for a in (card16, cpu16, card16_vs_32))
    gaps = np.abs(card16 - cpu16).reshape(len(e_ref), -1).max(axis=1)
    if not (np.isfinite(card16).all() and (gaps <= e_ref).all()):
        raise AssertionError(f"{name}: bf16 card vs CPU {gaps} > e_ref {e_ref}")
    return {"gap": gaps.tolist(), "e_ref": e_ref.tolist()}


def all_float32(modules, optimizers) -> None:
    """bf16 compute leaves every parameter and optimizer moment float32."""
    import torch

    bad = [n for m in modules for n, p in m.named_parameters() if p.dtype != torch.float32]
    bad += [k for opt in optimizers for st in opt.state.values() for k, v in st.items()
            if torch.is_tensor(v) and v.is_floating_point() and v.dtype != torch.float32]
    if bad:
        raise AssertionError(f"bf16 run left non-float32 state: {bad[:5]}")


def bf16_vocoder() -> dict:
    """(a) Full-width hifigan_v1_16k with ``mixed_precision``, seeded: on
    250 frames bf16 on the card against f32 on the card (e_ref) and against
    bf16 on the CPU (within e_ref); at B=1 on 5 s, plain and chunked-8 in
    both dtypes by CUDA events in turns, and chunked-8 against plain in
    bf16 within 2 e_ref of the plain call (PERF.md §6: the window
    batch makes cuDNN round in another order, and two bf16 results, each
    within e_ref of f32, are within 2 e_ref of each other)."""
    import torch

    from kantts_tpu_torch.configs import get_config
    from kantts_tpu_torch.infer.chunked import chunked_apply
    from kantts_tpu_torch.models.builder import model_builder

    cfg = get_config("hifigan_v1_16k")
    cfg16 = dict(cfg, mixed_precision=True)
    gen = {"f32": model_builder(cfg, seed=2).cuda(),
           "bf16": model_builder(cfg16, seed=2).cuda()}
    cpu16 = model_builder(cfg16, seed=2)
    mel = torch.from_numpy(np.random.RandomState(11).randn(1, 250, 80).astype(np.float32))
    with torch.inference_mode():
        y = {dt: g(mel.cuda()).float().cpu() for dt, g in gen.items()}
        y_cpu = cpu16(mel).float()
    if gen["bf16"].conv_pre.dtype != torch.bfloat16:
        raise AssertionError("mixed_precision did not give a bf16 generator")
    e_ref = (y["bf16"] - y["f32"]).abs().max().item()
    card_cpu = within_e_ref("bf16 generator, 250 frames", y["bf16"], y_cpu, e_ref)

    mel5 = torch.from_numpy(np.random.RandomState(5).randn(1, 400, 80)
                            .astype(np.float32)).cuda()
    runs = {f"{dt}_{how}": (lambda g=g, how=how: chunked_apply(g, mel5, 8)
                            if how == "chunked8" else g(mel5))
            for dt, g in gen.items() for how in ("plain", "chunked8")}
    times = collections.defaultdict(list)
    with torch.inference_mode():
        out = {k: f().float() for k, f in runs.items()}
        for k in ("f32_plain", "bf16_plain", "f32_chunked8", "bf16_chunked8",
                  "bf16_chunked8", "f32_chunked8", "bf16_plain", "f32_plain"):
            times[k].append(cuda_ms(runs[k], 10))
    e_ref5 = (out["bf16_plain"] - out["f32_plain"]).abs().max().item()
    chunk16 = (out["bf16_chunked8"] - out["bf16_plain"]).abs().max().item()
    chunk32 = (out["f32_chunked8"] - out["f32_plain"]).abs().max().item()
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    log("bf16_vocoder", frames=250, e_ref=e_ref, card_vs_cpu_bf16=card_cpu["gap"][0],
        b1_5s_f32_plain_ms=round(ms["f32_plain"], 4),
        b1_5s_bf16_plain_ms=round(ms["bf16_plain"], 4),
        b1_5s_f32_chunked8_ms=round(ms["f32_chunked8"], 4),
        b1_5s_bf16_chunked8_ms=round(ms["bf16_chunked8"], 4),
        plain_bf16_over_f32=round(ms["bf16_plain"] / ms["f32_plain"], 4),
        chunked8_bf16_over_f32=round(ms["bf16_chunked8"] / ms["f32_chunked8"], 4),
        e_ref_5s=e_ref5, chunked8_vs_plain_bf16=chunk16, chunked8_bf16_tol=2 * e_ref5,
        chunked8_vs_plain_f32=chunk32)
    if not (chunk16 <= 2 * e_ref5 and chunk32 <= 1e-5):
        raise AssertionError(f"chunked-8 vs plain: bf16 {chunk16} (2 e_ref "
                             f"{2 * e_ref5}), f32 {chunk32} (1e-5)")
    return {"e_ref": e_ref, "card_vs_cpu": card_cpu["gap"][0], "ms": ms,
            "chunked8_vs_plain_bf16": chunk16, "e_ref_5s": e_ref5}


def conv_share(prof) -> tuple:
    """-> (device ms of the kernels that convolution operators launch, device
    ms of all kernels) in a profile: the self device time of every operator
    whose name holds "convolution" (cuDNN's forward, transposed and backward
    kernels), against the sum over all device kernels."""
    from torch.autograd import DeviceType

    conv_us = sum(getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0)
                  for e in prof.key_averages() if "convolution" in e.key)
    total_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    return conv_us / 1e3, total_us / 1e3


def share(part: float, whole: float):
    return round(part / whole, 4) if whole else "not measured"


def gan_step_of(config):
    """A GAN step on the card from ``config``, seeded as train_hifigan seeds
    it."""
    import torch

    from kantts_tpu_torch.losses import criterion_builder
    from kantts_tpu_torch.models.builder import hifigan_gan_builder
    from kantts_tpu_torch.train.steps import make_gan_step

    b = hifigan_gan_builder(config, 0, torch.device("cuda"))
    return make_gan_step(b["generator"], b["discriminators"], criterion_builder(config),
                         b["gen_optimizer"], b["gen_scheduler"], b["disc_optimizers"],
                         b["disc_schedulers"], b["gen_clip"], b["disc_clips"],
                         pqmf=b["pqmf"]), b


def bf16_gan(tmp: str) -> str:
    """(b) 10 bf16 GAN steps of hifigan_v1_16k through train_hifigan on
    phase 5's corpus, float32 parameters and Adam moments after; one step
    at 16 x 9600 timed beside the f32 step in turns, each with its host
    syncs and the convolutions' share of its device time from
    torch.profiler; a step at B=1 on the card against the CPU under the
    bf16 rule. -> the bf16 GAN checkpoint of step 10."""
    import torch

    from kantts_tpu_torch.bin.train_hifigan import train

    stage = os.path.join(tmp, "bf16_voc_train")
    t0 = time.perf_counter()
    trainer = train(gan_config(os.path.join(stage, "model.yaml"), **BF16_GAN_KEYS),
                    os.path.join(tmp, "voc_corpus"), stage, device="cuda")
    seconds = time.perf_counter() - t0
    check_run(trainer, stage, BF16_GAN_KEYS["train_max_steps"])
    all_float32([trainer.generator, *trainer.discriminators.values()],
                [trainer.gen_optimizer, *trainer.disc_optimizers.values()])
    if trainer.generator.dtype != torch.bfloat16:
        raise AssertionError("train_hifigan did not train in bf16")
    log("bf16_voc_train", steps=trainer.steps_taken, batch=trainer.config["batch_size"],
        seconds=round(seconds, 3), params_and_moments="float32",
        losses=gan_losses(trainer))

    config16 = trainer.config
    config32 = dict(config16, mixed_precision=False)
    batch = gan_batch(trainer, GAN_SHAPE[0], torch.device("cuda"))
    small = gan_batch(trainer, 1, torch.device("cuda"))
    del trainer
    torch.cuda.empty_cache()
    steps = {"f32": gan_step_of(config32)[0], "bf16": gan_step_of(config16)[0]}
    result = {}
    for dt, step in steps.items():
        for _ in range(3):
            step(*batch)
        torch.cuda.synchronize()
        result[f"{dt}_host_syncs"] = len(host_syncs(lambda: step(*batch)))
    times = collections.defaultdict(list)
    for dt in ("f32", "bf16", "bf16", "f32"):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps[dt](*batch)
            torch.cuda.synchronize()
            times[dt].append(time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile

    for dt, step in steps.items():
        result[f"{dt}_ms"] = float(np.median(times[dt])) * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step(*batch)
            torch.cuda.synchronize()
        conv_ms, device_ms = conv_share(prof)
        result[f"{dt}_conv_ms"], result[f"{dt}_device_ms"] = conv_ms / 2, device_ms / 2
    del steps
    torch.cuda.empty_cache()
    log("bf16_gan_step", shape="B={}xT={}".format(*GAN_SHAPE),
        f32_median_ms=round(result["f32_ms"], 3), bf16_median_ms=round(result["bf16_ms"], 3),
        bf16_over_f32=round(result["bf16_ms"] / result["f32_ms"], 4),
        f32_device_ms=round(result["f32_device_ms"], 3),
        bf16_device_ms=round(result["bf16_device_ms"], 3),
        f32_conv_ms=round(result["f32_conv_ms"], 3),
        bf16_conv_ms=round(result["bf16_conv_ms"], 3),
        f32_conv_share=share(result["f32_conv_ms"], result["f32_device_ms"]),
        bf16_conv_share=share(result["bf16_conv_ms"], result["bf16_device_ms"]),
        f32_host_syncs=result["f32_host_syncs"], bf16_host_syncs=result["bf16_host_syncs"])

    wav, mel = small
    card16 = gan_losses_and_norms(config16, wav, mel)
    card32 = gan_losses_and_norms(config32, wav, mel)
    cpu16 = gan_losses_and_norms(config16, wav.cpu(), mel.cpu())
    e_ref = np.abs(np.array(card16) - np.array(card32))
    rule = within_e_ref("bf16 GAN step, B=1", card16, cpu16, e_ref)
    log("bf16_gan_card_vs_cpu", shape="B={}xT={}".format(*wav.shape[:2]),
        quantities="gen_loss,dis_loss,gen_grad_norm,dis_grad_norm",
        card_bf16=",".join(f"{v:.6g}" for v in card16),
        cpu_bf16=",".join(f"{v:.6g}" for v in cpu16),
        card_f32=",".join(f"{v:.6g}" for v in card32),
        gaps=",".join(f"{v:.3g}" for v in rule["gap"]),
        e_refs=",".join(f"{v:.3g}" for v in rule["e_ref"]))
    return ckpt_path(stage, BF16_GAN_KEYS["train_max_steps"]), result


def time_alternating(runs: dict, order, n: int) -> dict:
    """Median milliseconds of each run, n timed calls a turn, each call
    between two synchronizes, the turns in ``order``."""
    import torch

    times = collections.defaultdict(list)
    for name in order:
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return {name: float(np.median(v)) * 1e3 for name, v in times.items()}


def bf16_sambert(tmp: str):
    """(c) 5 bf16 steps of sambert_16k_MAS through train_sambert on a
    34-utterance MAS corpus of phase 4's kind (K1 in each); the train step at 32 x 96 x 576 timed beside f32;
    acoustic inference at B=8 on a 576-frame budget, bf16 against f32 (mel
    gap and time, the f32 durations fed to both); and a forward and backward at B=4 on the
    card against the CPU under the bf16 rule. -> (the bf16 checkpoint of
    step 5, K1 launches in the 5 steps, results)."""
    import torch

    from kantts_tpu_torch.bin.infer_sambert import encode_symbol_inputs
    from kantts_tpu_torch.bin.train_sambert import train
    from kantts_tpu_torch.configs import get_config
    from kantts_tpu_torch.models.builder import build_sambert, sambert_model_builder
    from kantts_tpu_torch.models.sambert.sambert import sambert_infer
    from kantts_tpu_torch.ops.mas import b_mas_cuda
    from kantts_tpu_torch.serve.service import resolve_frontend
    from kantts_tpu_torch.losses import criterion_builder
    from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit
    from kantts_tpu_torch.train.steps import make_sambert_step
    from kantts_tpu_torch.train.trainer import batch_to_device
    from kantts_tpu_torch.utils.corpus import write_mas_corpus

    stage = os.path.join(tmp, "bf16_train")
    steps = SHORT_KEYS["train_max_steps"]
    data = os.path.join(tmp, "bf16_corpus")
    write_mas_corpus(data, 34, (60, 90), (400, 570), seed=1)
    b_mas_cuda.launches = 0
    t0 = time.perf_counter()
    trainer = train(train_config(os.path.join(stage, "model.yaml"), mixed_precision=True,
                                 **CACHED_SHORT_KEYS), data, stage)
    seconds = time.perf_counter() - t0
    launches = b_mas_cuda.launches
    if trainer.steps_taken != steps or not os.path.exists(ckpt_path(stage, steps)):
        raise AssertionError(f"bf16 AM: {trainer.steps_taken} steps, expected {steps}")
    if launches < steps:
        raise AssertionError(f"bf16 AM: K1 launched {launches} times in {steps} steps")
    if trainer.model.mel_decoder.dtype != torch.bfloat16:
        raise AssertionError("train_sambert did not train in bf16")
    all_float32([trainer.model], [trainer.optimizer])
    for kind, at, means in trainer.history:
        if not all(np.isfinite(v) for v in means.values()):
            raise AssertionError(f"bf16 AM {kind} metrics at step {at}: {means}")
    log("bf16_am_train", steps=steps, batch=trainer.config["batch_size"],
        seconds=round(seconds, 3), k1_launches=launches, params_and_moments="float32",
        total_loss=json.dumps({f"{k}@{a}": round(m[f"{k}/TotalLoss"], 4)
                               for k, a, m in trainer.history}).replace(" ", ""))

    config16 = trainer.config
    config32 = dict(config16, mixed_precision=False)
    ds = trainer.train_loader.dataset
    batch_np = ds.collate_fn(longest_items(trainer, TRAIN_SHAPE[0]))
    small_np = ds.collate_fn(longest_items(trainer, 4))
    del trainer
    batch = batch_to_device(batch_np, torch.device("cuda"))
    shape = (*batch["input_lings"].shape[:2], batch["mel_targets"].shape[1])
    if shape != TRAIN_SHAPE:
        raise AssertionError(f"timing batch {shape}, expected {TRAIN_SHAPE}")
    runs = {}
    for dt, cfg in (("f32", config32), ("bf16", config16)):
        built = sambert_model_builder(cfg, 0, torch.device("cuda"))
        step = make_sambert_step(built["model"], criterion_builder(cfg),
                                 built["optimizer"], built["scheduler"], built["clip"],
                                 True)
        for _ in range(3):
            step(batch, EPOCH)
        runs[dt] = lambda step=step: step(batch, EPOCH)
    step_ms = time_alternating(runs, ("f32", "bf16", "bf16", "f32"), 5)
    del runs
    torch.cuda.empty_cache()

    am_cfg = get_config("sambert_16k_MAS")
    am_cfg["Model"]["KanTtsSAMBERT"]["params"]["dur_pred_bias_init"] = 2.2
    models = {"f32": build_sambert(am_cfg, seed=1).cuda(),
              "bf16": build_sambert(dict(am_cfg, mixed_precision=True), seed=1).cuda()}
    lu = KanTtsLinguisticUnit(am_cfg)
    seqs = [s for line in resolve_frontend("pinyin").text_to_symbols(TEXTS) for s in line]
    seqs = (seqs * 8)[:8]
    L_in = 32 * -(-max(len(lu.encode_symbol_sequence(s)[0]) - 1 for s in seqs) // 32)
    parts = [encode_symbol_inputs(lu, s, L_in) for s in seqs]
    args = [torch.from_numpy(np.concatenate([p[i] for p in parts])).cuda()
            for i in range(4)]
    args = [a.long() for a in args[:3]] + [args[3]]
    with torch.no_grad():
        ref = sambert_infer(models["f32"], *args, AM_INFER_FRAMES)
        durs = torch.floor(ref["duration_predictions"] + 0.5)
        infer = {dt: (lambda m=m: sambert_infer(m, *args, AM_INFER_FRAMES,
                                                duration_override=durs))
                 for dt, m in models.items()}
        mel = {dt: f()["postnet_outputs"].float() for dt, f in infer.items()}
        infer_ms = time_alternating(infer, ("bf16", "f32"), 1)
    mel_gap = (mel["bf16"] - mel["f32"]).abs().max().item()
    mel_scale = mel["f32"].abs().max().item()
    del models
    log("bf16_am_step_and_infer", step_shape="B={}xT_in={}xT_mel={}".format(*TRAIN_SHAPE),
        f32_step_median_ms=round(step_ms["f32"], 3),
        bf16_step_median_ms=round(step_ms["bf16"], 3),
        step_bf16_over_f32=round(step_ms["bf16"] / step_ms["f32"], 4),
        infer_b8_f32_ms=round(infer_ms["f32"], 3), infer_b8_bf16_ms=round(infer_ms["bf16"], 3),
        infer_bf16_over_f32=round(infer_ms["bf16"] / infer_ms["f32"], 4),
        infer_mel_gap=mel_gap, infer_mel_max_abs_f32=mel_scale, infer_mel_tol=0.1 * mel_scale)
    if not mel_gap <= 0.1 * mel_scale:
        raise AssertionError(f"bf16 AM inference: mel gap {mel_gap} > 0.1 x {mel_scale}")

    loss16, norm16, hard = sambert_loss_and_norm(config16, small_np, torch.device("cuda"))
    loss32, norm32, _ = sambert_loss_and_norm(config32, small_np, torch.device("cuda"), hard)
    cpu_loss, cpu_norm, _ = sambert_loss_and_norm(config16, small_np, torch.device("cpu"),
                                                  hard)
    rule = within_e_ref("bf16 AM forward+backward, B=4", [loss16, norm16],
                        [cpu_loss, cpu_norm], [abs(loss16 - loss32), abs(norm16 - norm32)])
    log("bf16_am_card_vs_cpu", shape="B=4xT_in={}xT_mel={}".format(
        small_np["input_lings"].shape[1], small_np["mel_targets"].shape[1]),
        loss_card=loss16, loss_cpu=cpu_loss, loss_card_f32=loss32, grad_norm_card=norm16,
        grad_norm_cpu=cpu_norm, grad_norm_card_f32=norm32,
        gaps=",".join(f"{v:.3g}" for v in rule["gap"]),
        e_refs=",".join(f"{v:.3g}" for v in rule["e_ref"]))
    return ckpt_path(stage, steps), launches, {"step_ms": step_ms, "infer_ms": infer_ms,
                                               "mel_gap": mel_gap}


def am_forward_card_vs_cpu(name: str, config, batch_np) -> float:
    """The teacher-forced forward of ``config``'s seeded SAM-BERT (eval mode)
    on a collated batch, on the card and on the CPU, the CPU fed the card's
    hard alignment under MAS. Tolerance 1e-3, as phase 6's: float32 on both,
    the order of sums differs. -> max |diff| of the postnet mel."""
    import torch

    import kantts_tpu_torch.models.sambert.sambert as sambert_module
    from kantts_tpu_torch.models.builder import build_sambert
    from kantts_tpu_torch.train.steps import sambert_forward
    from kantts_tpu_torch.train.trainer import batch_to_device

    model = build_sambert(config, seed=0)
    mas_align = sambert_module.mas_align
    hard, out = {}, {}
    for device in ("cuda", "cpu"):
        def align(*args, device=device):
            if device == "cuda":
                hard["card"] = mas_align(*args)
            return hard["card"].to(device)

        sambert_module.mas_align = align
        try:
            with torch.no_grad():
                out[device] = sambert_forward(model.to(device).eval(),
                                              batch_to_device(batch_np, torch.device(device))
                                              )["postnet_outputs"].cpu()
        finally:
            sambert_module.mas_align = mas_align
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    log(name, shape="B={}xT_in={}xT_mel={}".format(
        *batch_np["input_lings"].shape[:2], batch_np["mel_targets"].shape[1]),
        mel_max_abs_err=err, tol=1e-3)
    if not (np.isfinite(out["cuda"]).all() and err <= 1e-3):
        raise AssertionError(f"{name}: card vs CPU {err} > 1e-3")
    return err


def short_am_train(tmp: str, name: str, stage_name: str, data: str):
    """5 steps of ``name`` as published through train_sambert on ``data``.
    -> (trainer, K1 launches, seconds)."""
    from kantts_tpu_torch.bin.train_sambert import train
    from kantts_tpu_torch.ops.mas import b_mas_cuda

    stage = os.path.join(tmp, stage_name)
    b_mas_cuda.launches = 0
    t0 = time.perf_counter()
    trainer = train(train_config(os.path.join(stage, "model.yaml"), name,
                                 **CACHED_SHORT_KEYS), data, stage)
    seconds = time.perf_counter() - t0
    steps = SHORT_KEYS["train_max_steps"]
    if trainer.steps_taken != steps or not os.path.exists(ckpt_path(stage, steps)):
        raise AssertionError(f"{name}: {trainer.steps_taken} steps, expected {steps}")
    for kind, at, means in trainer.history:
        if not all(np.isfinite(v) for v in means.values()):
            raise AssertionError(f"{name} {kind} metrics at step {at}: {means}")
    return trainer, b_mas_cuda.launches, seconds


def text_to_wav_cli(out: str, am_ckpt: str, voc_ckpt: str, *args):
    """``python -m kantts_tpu_torch.bin.text_to_wav`` with no --device,
    started. -> a function that waits for it and returns its printed
    stats."""
    cli = Cli("text_to_wav", ["-m", "kantts_tpu_torch.bin.text_to_wav", "--am_ckpt",
                              am_ckpt, "--voc_ckpt", voc_ckpt, "--output_dir", out, *args])

    def finish() -> dict:
        stats = json.loads(cli.result().strip().splitlines()[-1])
        if stats["device"] != "cuda":
            raise AssertionError(f"text_to_wav ran on {stats['device']}")
        return stats

    return finish


def byte_voice(tmp: str, voc_ckpt: str) -> int:
    """(e) Full-width sambert_16k_MAS_byte, seeded (duration bias 2.2): byte
    symbols of 4 hanzi lines from ``turn_text_into_bytes``, then
    ``text_to_wav --symbols_file`` with phase 6's vocoder; 5 MAS train
    steps on a byte corpus, K1 in each; the forward card vs CPU at B=4.
    -> K1 launches in the 5 steps."""
    from kantts_tpu_torch.models.builder import model_builder, save_checkpoint
    from kantts_tpu_torch.preprocess.script_convertor import turn_text_into_bytes
    from kantts_tpu_torch.utils.config import load_yaml
    from kantts_tpu_torch.utils.corpus import write_am_corpus

    root = os.path.join(tmp, "byte")
    os.makedirs(root)
    text, symbols = os.path.join(root, "hanzi.txt"), os.path.join(root, "symbols.lst")
    with open(text, "w", encoding="utf-8") as f:
        f.write("".join(f"{i}\t{line}\n" for i, line in enumerate(HANZI)))
    turn_text_into_bytes(text, symbols, "F7")
    cfg = load_yaml(os.path.join(CONFIGS, "sambert_16k_MAS_byte.yaml"))
    cfg["Model"]["KanTtsSAMBERT"]["params"]["dur_pred_bias_init"] = 2.2
    am_ckpt = os.path.join(root, "am.pt")
    save_checkpoint(am_ckpt, model_builder(cfg, seed=1), cfg)
    out = os.path.join(root, "cli")
    finish_cli = text_to_wav_cli(out, am_ckpt, voc_ckpt, "--symbols_file", symbols)

    data = os.path.join(root, "corpus")  # the training, beside the CLI
    write_am_corpus(data, 24, (60, 90), (400, 570), seed=0, byte=True)
    trainer, launches, seconds = short_am_train(tmp, "sambert_16k_MAS_byte",
                                                "byte_train", data)
    stats = finish_cli()
    n_sent = check_wavs(out)
    with open(symbols, encoding="utf-8") as f:
        n_bytes = [len(line.split("\t")[1].split()) for line in f]
    log("byte_text_to_wav_cli", sentences=n_sent, bytes_per_line=n_bytes,
        am_frames=stats["am_frames"], audio_s=round(stats["audio_seconds"], 3))
    if not trainer.model.text_encoder.using_byte or launches < SHORT_KEYS["train_max_steps"]:
        raise AssertionError(f"byte AM: using_byte {trainer.model.text_encoder.using_byte}, "
                             f"K1 launches {launches}")
    log("byte_am_train", steps=trainer.steps_taken, batch=trainer.config["batch_size"],
        seconds=round(seconds, 3), k1_launches=launches)
    items = trainer.train_loader.dataset.collate_fn(longest_items(trainer, 4))
    am_forward_card_vs_cpu("byte_am_card_vs_cpu", trainer.config, items)
    return launches


def se_voice(tmp: str) -> int:
    """(f) Full-width sambert_se_nsf_global_16k and
    hifigan_noncausal_nsf_global_v1_16k, seeded, with a seeded 192-d
    ``se.npy``: ``text_to_wav --se_file`` (no --device); ``TTSService`` with
    ``se_file`` answering 4 ``/tts`` requests; 5 train steps on an SE
    corpus; the forward card vs CPU at B=4. K1 must not launch. -> K1's
    launches (0)."""
    from kantts_tpu_torch.models.builder import model_builder, save_checkpoint
    from kantts_tpu_torch.ops.mas import b_mas_cuda
    from kantts_tpu_torch.utils.config import load_yaml
    from kantts_tpu_torch.utils.corpus import write_am_corpus

    root = os.path.join(tmp, "se")
    os.makedirs(root)
    b_mas_cuda.launches = 0
    am_cfg = load_yaml(os.path.join(CONFIGS, "sambert_se_nsf_global_16k.yaml"))
    am_cfg["Model"]["KanTtsSAMBERT"]["params"]["dur_pred_bias_init"] = 2.2
    voc_cfg = load_yaml(os.path.join(CONFIGS, "hifigan_noncausal_nsf_global_v1_16k.yaml"))
    voc_cfg["audio_config"] = {"sampling_rate": 16000}
    am_ckpt, voc_ckpt = os.path.join(root, "am.pt"), os.path.join(root, "voc.pt")
    save_checkpoint(am_ckpt, model_builder(am_cfg, seed=1), am_cfg)
    save_checkpoint(voc_ckpt, model_builder(voc_cfg, seed=2), voc_cfg)
    se_file = os.path.join(root, "se.npy")
    np.save(se_file, np.random.RandomState(12).randn(SE_UNITS).astype(np.float32))
    text = os.path.join(root, "text.txt")
    with open(text, "w", encoding="utf-8") as f:
        f.write("\n".join(TEXTS) + "\n")
    out = os.path.join(root, "cli")
    finish_cli = text_to_wav_cli(out, am_ckpt, voc_ckpt, "--txt", text, "--se_file",
                                 se_file, "--am_batch", "4")
    nsf_serve(am_ckpt, voc_ckpt, se_file=se_file, sr=16000, hop=HOP, name="se_serve")
    stats = finish_cli()
    n_sent = check_wavs(out)
    check_nsf_mels(np.load(p) for p in glob.glob(os.path.join(out, "feat", "*_mel.npy")))
    log("se_text_to_wav_cli", sentences=n_sent, am_frames=stats["am_frames"],
        audio_s=round(stats["audio_seconds"], 3))

    data = os.path.join(root, "corpus")
    write_am_corpus(data, 40, (60, 90), (400, 570), seed=0, durations=True, nsf=True,
                    se_units=SE_UNITS)
    trainer, _, seconds = short_am_train(tmp, "sambert_se_nsf_global_16k", "se_train",
                                         data)
    if not (trainer.model.se_enable and trainer.model.d_mel == 82):
        raise AssertionError("SE AM: not an 82-channel SE model")
    log("se_am_train", steps=trainer.steps_taken, batch=trainer.config["batch_size"],
        seconds=round(seconds, 3))
    items = trainer.train_loader.dataset.collate_fn(longest_items(trainer, 4))
    if items["input_speakers"].shape[-1] != SE_UNITS:
        raise AssertionError(f"SE batch speakers {items['input_speakers'].shape}")
    am_forward_card_vs_cpu("se_am_card_vs_cpu", trainer.config, items)
    if b_mas_cuda.launches != 0:
        raise AssertionError(f"the SE path launched K1 {b_mas_cuda.launches} times")
    return b_mas_cuda.launches


def phase_bf16_se_byte(tmp: str, voc_ckpt: str) -> dict:
    """Phase 10, (a)-(f) above. -> K1 launches by path, and results."""
    import torch

    t_phase = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    voc = timed("a", bf16_vocoder)
    gan_ckpt, gan = timed("b", bf16_gan, tmp)
    am_ckpt, bf16_launches, am = timed("c", bf16_sambert, tmp)
    out = os.path.join(tmp, "bf16_cli")
    finish_cli = text_to_wav_cli(out, am_ckpt, gan_ckpt, "--txt",
                                 os.path.join(tmp, "text.txt"), "--am_batch", "4")
    byte_launches = timed("e", byte_voice, tmp, voc_ckpt)  # beside (d)'s CLI
    stats = timed("d", finish_cli)
    log("bf16_text_to_wav_cli", sentences=check_wavs(out), am_frames=stats["am_frames"],
        audio_s=round(stats["audio_seconds"], 3))
    se_launches = timed("f", se_voice, tmp)
    log("bf16_se_byte", k1_launches_bf16=bf16_launches, k1_launches_byte=byte_launches,
        k1_launches_se=se_launches, seconds=json.dumps(seconds).replace(" ", ""),
        phase_s=round(time.perf_counter() - t_phase, 3))
    return {"k1_launches": {"bf16_train_sambert": bf16_launches,
                            "byte_train_sambert": byte_launches, "se": se_launches},
            "vocoder": voc, "gan": gan, "am": am}


FP_SR, FP_HOP = 8000, 100  # hifigan_v1_8k: prod(5, 5, 2, 2) samples a frame
# the keys of sybert.yaml and sambert_fp_8k.yaml that phase 11 shortens
FP_KEYS = dict(train_max_steps=20, save_interval_steps=10, eval_interval_steps=10,
               log_interval_steps=10)
# the FP voice's duration head starts at ~8 frames a phone, as phase 10's
# seeded voices do: 20 steps in NoamLR's warmup leave it near its init
FP_PARAMS = {"dur_pred_bias_init": 2.2}


def resume_10_to_12(tmp: str, train, name: str, data: str, stage: str,
                    params=None) -> float:
    """A resume of ``stage``'s run of ``name`` from step 10 to 12 through
    ``train``. -> seconds."""
    resumed = os.path.join(tmp, f"{name}_resumed")
    t0 = time.perf_counter()
    again = train(train_config(os.path.join(resumed, "model.yaml"), name, params,
                               **dict(FP_KEYS, train_max_steps=12)),
                  data, resumed, resume_path=ckpt_path(stage, 10))
    if (again.steps_taken != 2 or again.scheduler.last_epoch != 12
            or not os.path.exists(ckpt_path(resumed, 12))):
        raise AssertionError(f"{name} resume 10 -> 12: {again.steps_taken} steps, "
                             f"schedule at {again.scheduler.last_epoch}")
    return round(time.perf_counter() - t0, 3)


def sybert_cli(tmp: str, data: str):
    """2 steps of ``python -m kantts_tpu_torch.bin.train_sybert`` with no
    --device, started. -> a function that waits for it and returns its
    seconds."""
    stage = os.path.join(tmp, "sybert_cli")
    cfg = train_config(os.path.join(stage, "model.yaml"), "sybert",
                       **dict(FP_KEYS, train_max_steps=2))
    cli = Cli("train_sybert", ["-m", "kantts_tpu_torch.bin.train_sybert",
                               "--model_config", cfg, "--root_dir", data,
                               "--stage_dir", stage])

    def finish() -> float:
        cli.result()
        if not os.path.exists(ckpt_path(stage, 2)):
            raise AssertionError("train_sybert CLI: no checkpoint at step 2")
        return round(cli.seconds, 3)

    return finish


def timed_step(name: str, step, batch, n: int = 10, profile: bool = False) -> float:
    """``step(batch)``: 3 warmup calls, then n calls each between two
    synchronizes; the host syncs of one call; with ``profile`` a profile of
    3 warm calls. -> median ms."""
    import torch

    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    syncs = host_syncs(lambda: step(batch))
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    bad = {k: v.item() for k, v in metrics.items() if not torch.isfinite(v)}
    if bad:
        raise AssertionError(f"{name}: metrics not finite: {bad}")
    ms = float(np.median(times)) * 1e3
    fields = {}
    if profile:
        prof = profile_steps(lambda: step(batch), 3)
        fields = dict(device_busy_ms_3_steps=round(prof["busy_ms"], 3),
                      device_busy_share=round(prof["busy_ms"] / prof["wall_ms"], 4),
                      device_ops_per_step=prof["device_ops"] // 3,
                      top=json.dumps(prof["top"][:6]).replace(" ", ""))
    log(name, shape="x".join(str(d) for d in batch["input_lings"].shape[:2]),
        median_ms=round(ms, 3), min_ms=round(min(times) * 1e3, 3),
        max_ms=round(max(times) * 1e3, 3),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
        host_syncs=len(syncs), sync_sites=",".join(
            f"{site}x{k}" for site, k in collections.Counter(syncs).items()),
        **fields)
    return ms


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def sybert_card_vs_cpu(config, batch_np) -> None:
    """One forward and backward of the seeded Textsy-BERT (dropout 0) at
    B=4 on the card and on the CPU: loss, error rate and global gradient
    norm each within 1e-3 relative (float32, TF32 off; phase 6's rule)."""
    import torch
    from torch import nn

    from kantts_tpu_torch.losses import criterion_builder
    from kantts_tpu_torch.models.builder import build_sybert
    from kantts_tpu_torch.train.optim import global_grad_norm
    from kantts_tpu_torch.train.steps import sybert_losses
    from kantts_tpu_torch.train.trainer import batch_to_device

    out = {}
    for device in ("cuda", "cpu"):
        model = build_sybert(config, seed=0).to(device)
        for m in model.modules():
            if isinstance(m, nn.Dropout):
                m.p = 0.0
        loss, metrics = sybert_losses(model.train(), criterion_builder(config),
                                      batch_to_device(batch_np, torch.device(device)))
        loss.backward()
        out[device] = (loss.item(), metrics["error_rate"].item(),
                       global_grad_norm(model.parameters()).item())
    errs = [rel(a, b) for a, b in zip(out["cuda"], out["cpu"])]
    log("sybert_card_vs_cpu", shape="x".join(map(str, batch_np["input_lings"].shape[:2])),
        card=out["cuda"], cpu=out["cpu"], rel_err=errs, tol=1e-3)
    if not (np.isfinite(out["cuda"]).all() and max(errs) <= 1e-3):
        raise AssertionError(f"Textsy-BERT card vs CPU: {out}")


def fp_card_vs_cpu(config, batch_np, fp_dict_lings) -> None:
    """One forward and backward of the seeded FP SAM-BERT (dropout 0) at B=4
    on the card and on the CPU: total loss and ``fp_loss`` rtol 1e-4, the
    global gradient norm rtol 1e-3 (phase 4's rule)."""
    import torch
    from torch import nn

    from kantts_tpu_torch.losses import criterion_builder
    from kantts_tpu_torch.models.builder import build_sambert
    from kantts_tpu_torch.train.optim import global_grad_norm
    from kantts_tpu_torch.train.steps import sambert_losses
    from kantts_tpu_torch.train.trainer import array_to_device, batch_to_device

    out = {}
    for device in (torch.device("cuda"), torch.device("cpu")):
        model = build_sambert(config, seed=0).to(device)
        for m in model.modules():
            if isinstance(m, nn.Dropout):
                m.p = 0.0
        loss, metrics = sambert_losses(
            model.train(), criterion_builder(config), batch_to_device(batch_np, device),
            0, False, fp_dict_lings=array_to_device(fp_dict_lings, device))
        loss.backward()
        out[device.type] = (loss.item(), metrics["fp_loss"].item(),
                            global_grad_norm(model.parameters()).item())
    errs = [rel(a, b) for a, b in zip(out["cuda"], out["cpu"])]
    log("fp_train_card_vs_cpu", shape="B={}xT_in={}xL={}xT_mel={}".format(
        *batch_np["input_lings"].shape[:2], batch_np["durations"].shape[1],
        batch_np["mel_targets"].shape[1]),
        card=out["cuda"], cpu=out["cpu"], rel_err=errs, tol="1e-4,1e-4,1e-3")
    if not (np.isfinite(out["cuda"]).all() and errs[0] <= 1e-4 and errs[1] <= 1e-4
            and errs[2] <= 1e-3):
        raise AssertionError(f"FP train card vs CPU: {out}")


def fp_infer_card_vs_cpu(voice: str, am_ckpt: str, batch_np, fp_dict_lings) -> dict:
    """``sambert_infer_fp`` at B=4 on the card and on the CPU. The FP classes
    (argmax on the host) must agree; the smallest top-1 minus top-2 margin
    over valid tokens says how near a tie came. Then the spliced lengths
    must agree, and the mels within 1e-3 once both sides decode the same
    rounded durations: where floor(d + 0.5) rounds a duration apart, both
    re-decode the card's (the spliced hiddens through ``insert_fp`` and
    ``sambert_infer``'s ``duration_override``)."""
    import torch

    from kantts_tpu_torch.models.builder import load_checkpoint
    from kantts_tpu_torch.models.sambert.fp import fp_classes_from_predictions
    from kantts_tpu_torch.models.sambert.sambert import sambert_infer, sambert_infer_fp
    from kantts_tpu_torch.utils.mask import get_mask_from_lengths

    L_in = batch_np["input_lings"].shape[1]
    budget = L_in * 6
    args = {dev: [torch.from_numpy(batch_np[k]).long().to(dev)
                  for k in ("input_lings", "input_emotions", "input_speakers",
                            "valid_input_lengths")]
                 + [torch.from_numpy(fp_dict_lings).long().to(dev)]
            for dev in ("cuda", "cpu")}
    models = {dev: load_checkpoint(am_ckpt, torch.device(dev))[0] for dev in args}
    res, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = {k: v.cpu() for k, v in
                    sambert_infer_fp(models[dev], *args[dev], budget).items()}
        seconds[dev] = round(time.perf_counter() - t0, 3)
    masks = get_mask_from_lengths(args["cpu"][3], L_in).numpy()
    classes = {dev: fp_classes_from_predictions(r["fp_predictions"].numpy(), masks)
               for dev, r in res.items()}
    top2 = np.sort(res["cuda"]["fp_predictions"].numpy(), axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0])[~masks].min())
    same_classes = bool((classes["cuda"] == classes["cpu"]).all())
    log("fp_infer_classes", voice=voice, shape=f"B=4xT_in={L_in}", budget=budget,
        fillers_card=int((classes["cuda"] > 0).sum()),
        fillers_cpu=int((classes["cpu"] > 0).sum()), classes_equal=same_classes,
        min_top1_top2_margin=margin, seconds=json.dumps(seconds).replace(" ", ""))
    if not same_classes:
        raise AssertionError(f"FP classes differ card vs CPU (margin {margin})")
    if not torch.equal(res["cuda"]["valid_inter_lengths"].long(),
                       res["cpu"]["valid_inter_lengths"].long()):
        raise AssertionError("spliced lengths differ card vs CPU")
    durs = {dev: torch.floor(r["duration_predictions"] + 0.5) for dev, r in res.items()}
    rounding_equal = bool(torch.equal(durs["cuda"], durs["cpu"]))
    mel = {dev: r["postnet_outputs"] for dev, r in res.items()}
    if not rounding_equal:
        for dev in ("cuda", "cpu"):
            m, (ling, emo, spk, lens, fpd) = models[dev], args[dev]
            with torch.no_grad():
                text_hid, _, _ = m.encode(ling, get_mask_from_lengths(lens, L_in))
                plan = [torch.from_numpy(np.asarray(a)).to(dev) for a in
                        _fp_plan(classes["cuda"], lens.cpu().numpy())]
                hid, e, s = m.insert_fp(text_hid, emo, spk, plan, fpd)
                mel[dev] = sambert_infer(m, ling, e, s, plan[3], budget,
                                         text_hid_override=hid,
                                         duration_override=durs["cuda"].to(dev)
                                         )["postnet_outputs"].cpu()
    err = (mel["cuda"] - mel["cpu"]).abs().max().item()
    frames = res["cuda"]["LR_length_rounded"].tolist()
    log("fp_infer_card_vs_cpu", voice=voice,
        inter_lengths=res["cuda"]["valid_inter_lengths"].tolist(),
        frames=frames, rounded_durations_equal=rounding_equal,
        dur_max_abs_err=(res["cuda"]["duration_predictions"]
                         - res["cpu"]["duration_predictions"]).abs().max().item(),
        mel_max_abs_err=err, tol=1e-3)
    if not (np.isfinite(mel["cuda"].numpy()).all() and err <= 1e-3):
        raise AssertionError(f"sambert_infer_fp card vs CPU: mel {err} > 1e-3")
    return {"margin": margin, "mel_max_abs_err": err, "seconds": seconds,
            "fillers": int((classes["cuda"] > 0).sum())}


def _fp_plan(classes, lengths):
    from kantts_tpu_torch.models.sambert.fp import build_fp_insertion_plan

    return build_fp_insertion_plan(classes, lengths)[:4]


def phase_fp_sybert(tmp: str) -> dict:
    """Phase 11, (a)-(c) above. -> K1's launches (0) and results."""
    import torch

    from kantts_tpu_torch.bin import train_sambert, train_sybert
    from kantts_tpu_torch.models.builder import model_builder, save_checkpoint
    from kantts_tpu_torch.ops.mas import b_mas_cuda
    from kantts_tpu_torch.train.trainer import batch_to_device
    from kantts_tpu_torch.utils.config import load_yaml
    from kantts_tpu_torch.utils.corpus import write_fp_corpus, write_text_corpus

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    root = os.path.join(tmp, "fp")
    b_mas_cuda.launches = 0

    # (a) Textsy-BERT
    text = os.path.join(root, "text_corpus")
    write_text_corpus(text, 64, (60, 90), seed=0)
    stage = os.path.join(root, "sybert")
    t0 = time.perf_counter()
    bert = train_sybert.train(train_config(os.path.join(stage, "model.yaml"), "sybert",
                                           **FP_KEYS), text, stage)
    seconds = {"sybert_train": round(time.perf_counter() - t0, 3)}
    check_run(bert, stage, FP_KEYS["train_max_steps"])
    losses = {f"{kind}@{at}": round(m[f"{kind}/loss"], 5) for kind, at, m in bert.history}
    log("sybert_train", steps=bert.steps_taken, batch=bert.config["batch_size"],
        seconds=seconds["sybert_train"], loss=json.dumps(losses).replace(" ", ""))
    seconds["sybert_resume"] = resume_10_to_12(root, train_sybert.train, "sybert",
                                               text, stage)
    ds = bert.train_loader.dataset
    items = sorted((ds[i] for i in range(len(ds))), key=lambda x: -len(x[0]))
    bert_batch = ds.collate_fn(items[:bert.config["batch_size"]])
    sybert_step_ms = timed_step("sybert_step", bert.train_step_fn,
                                batch_to_device(bert_batch, cuda))
    # the CLI runs beside the checks and the FP training, not the timed steps
    finish_sybert_cli = sybert_cli(root, text)
    sybert_card_vs_cpu(bert.config, ds.collate_fn(items[:4]))
    bert_ckpt = ckpt_path(stage, FP_KEYS["train_max_steps"])
    del bert

    # (b) the warm start and FP training
    data = os.path.join(root, "fp_corpus")
    write_fp_corpus(data, 40, (40, 70), (300, 450), seed=0, sampling_rate=FP_SR)
    stage = os.path.join(root, "fp_train")
    t0 = time.perf_counter()
    am = train_sambert.train(train_config(os.path.join(stage, "model.yaml"),
                                          "sambert_fp_8k", FP_PARAMS, **FP_KEYS),
                             data, stage, resume_bert_path=bert_ckpt)
    seconds["fp_train"] = round(time.perf_counter() - t0, 3)
    check_run(am, stage, FP_KEYS["train_max_steps"])
    encoder = [k for k in am.model.state_dict() if k.startswith("text_encoder.")
               and not k.startswith("text_encoder.ling_proj.")]
    if sorted(am.warm_started) != sorted(encoder):
        raise AssertionError(f"warm start copied {len(am.warm_started)} tensors, "
                             f"expected {len(encoder)}")
    fp_losses = {f"{kind}@{at}": round(m[f"{kind}/fp_loss"], 5)
                 for kind, at, m in am.history}
    log("fp_train", steps=am.steps_taken, batch=am.config["batch_size"],
        seconds=seconds["fp_train"], warm_started_tensors=len(am.warm_started),
        fp_loss=json.dumps(fp_losses).replace(" ", ""))
    seconds["fp_resume"] = resume_10_to_12(root, train_sambert.train, "sambert_fp_8k",
                                           data, stage, FP_PARAMS)
    seconds["sybert_cli_beside"] = finish_sybert_cli()
    ds = am.train_loader.dataset
    fp_dict = ds.fp_dict_lings
    items = longest_items(am, am.config["batch_size"])
    fp_step_ms = timed_step("fp_step", lambda b: am.train_step_fn(b, 0),
                            batch_to_device(ds.collate_fn(items), cuda), profile=True)
    fp_card_vs_cpu(am.config, ds.collate_fn(items[:4]), fp_dict)
    am_ckpt = ckpt_path(stage, FP_KEYS["train_max_steps"])
    infer_batch = ds.collate_fn(items[:4])
    del am
    torch.cuda.empty_cache()

    # (c) FP inference (the trained voice, and the voice at its seeded init,
    # whose predictor still places fillers), then text -> wav
    seeded, fp_cfg = os.path.join(root, "fp_seeded.pt"), load_yaml(
        os.path.join(stage, "config.yaml"))
    save_checkpoint(seeded, model_builder(fp_cfg, seed=0), fp_cfg)
    voc_cfg = load_yaml(os.path.join(CONFIGS, "hifigan_v1_8k.yaml"))
    voc_cfg["audio_config"] = load_yaml(
        os.path.join(CONFIGS, "audio_config_8k.yaml"))["audio_config"]
    voc_ckpt = os.path.join(root, "voc_8k.pt")
    save_checkpoint(voc_ckpt, model_builder(voc_cfg, seed=2), voc_cfg)
    text_file = os.path.join(root, "text.txt")
    with open(text_file, "w", encoding="utf-8") as f:
        f.write("\n".join(TEXTS) + "\n")
    out = os.path.join(root, "cli")
    t0 = time.perf_counter()
    finish_cli = text_to_wav_cli(out, am_ckpt, voc_ckpt, "--txt", text_file,
                                 "--am_batch", "4")
    infer = {voice: fp_infer_card_vs_cpu(voice, ckpt, infer_batch, fp_dict)
             for voice, ckpt in (("step_20", am_ckpt), ("seeded", seeded))}
    if infer["seeded"]["fillers"] == 0:
        raise AssertionError("the seeded FP voice spliced no filler: the splice "
                             "did not run card vs CPU")
    stats = finish_cli()
    seconds["text_to_wav_beside"] = round(time.perf_counter() - t0, 3)
    log("fp_text_to_wav_cli", sentences=check_wavs(out, FP_SR, FP_HOP),
        am_frames=stats["am_frames"], audio_s=round(stats["audio_seconds"], 3))
    if b_mas_cuda.launches != 0:
        raise AssertionError(f"the FP and Textsy-BERT path launched K1 "
                             f"{b_mas_cuda.launches} times")
    log("fp_sybert", k1_launches=b_mas_cuda.launches,
        seconds=json.dumps(seconds).replace(" ", ""),
        phase_s=round(time.perf_counter() - t_phase, 3))
    return {"k1_launches": b_mas_cuda.launches, "sybert_step_ms": sybert_step_ms,
            "fp_step_ms": fp_step_ms, "infer": infer}


# Phase 12: preprocessing. The corpus: 200 synthetic utterances of 2-6 s at
# 16 kHz with interval files (write_voice_dir, seed 0); the keys of
# sambert_16k_MAS.yaml and hifigan_v1_16k.yaml that its training shortens.
VOICE_UTTS, VOICE_SECONDS, SUBSET_UTTS = 50, (2.0, 6.0), 16
PRE_KEYS = dict(train_max_steps=4, save_interval_steps=4, eval_interval_steps=4,
                log_interval_steps=4)
PRE_AM_BATCH = 16
# the acoustic model trains on this many of (b)'s am_train.lst: on all 195
# the loader's prefetch built ~73 s of beta-binomial priors for 4 steps
PRE_AM_UTTS = 32
STAGES = ("amp_normalize", "duration", "trim", "mel", "calibration", "pitch",
          "energy", "speaker_embedding", "metafiles")


def audio_seconds(wav_dir: str) -> float:
    from scipy.io import wavfile

    total = 0.0
    for path in glob.glob(os.path.join(wav_dir, "*.wav")):
        sr, data = wavfile.read(path, mmap=True)
        total += len(data) / sr
    return total


def check_processed(out: str) -> list:
    """Every utterance not in the badlist has its features and speaker
    embedding, the corpus has its mean embedding, the durations sum to the
    mel frames, and the frame-level f0, uv and energy have the mel's
    length. -> the badlist."""
    with open(os.path.join(out, "badlist.txt")) as f:
        bad = [line.strip() for line in f if line.strip()]
    utts = sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(out, "wav", "*.wav")))
    kept = [u for u in utts if u not in bad]
    subs = ["mel", "f0", "frame_f0", "frame_uv", "energy", "frame_energy",
            "duration", "se"]
    for utt in kept:
        missing = [s for s in subs if not os.path.exists(os.path.join(out, s, utt + ".npy"))]
        if missing:
            raise AssertionError(f"{utt} lacks {missing}")
        frames = np.load(os.path.join(out, "mel", utt + ".npy")).shape[0]
        durs = np.load(os.path.join(out, "duration", utt + ".npy"))
        if int(durs.sum()) != frames:
            raise AssertionError(f"{utt}: durations sum to {durs.sum()}, mel has {frames}")
        for sub in ("frame_f0", "frame_uv", "frame_energy"):
            n = len(np.load(os.path.join(out, sub, utt + ".npy")))
            if n != frames:
                raise AssertionError(f"{utt}: {sub} has {n} frames, mel {frames}")
    if not os.path.exists(os.path.join(out, "se", "se.npy")):
        raise AssertionError("no se/se.npy")
    return bad


def subset_voice(voice: str, sub: str, n: int) -> None:
    """The first n utterances of ``voice`` as a voice of their own."""
    import shutil

    for d in ("wav", "interval", "prosody"):
        os.makedirs(os.path.join(sub, d), exist_ok=True)
    utts = [f"utt{i:04d}" for i in range(n)]
    for utt in utts:
        shutil.copy(os.path.join(voice, "wav", utt + ".wav"), os.path.join(sub, "wav"))
        shutil.copy(os.path.join(voice, "interval", utt + ".interval"),
                    os.path.join(sub, "interval"))
    with open(os.path.join(voice, "prosody", "prosody.txt"), encoding="utf-8") as f:
        lines = f.readlines()
    with open(os.path.join(sub, "prosody", "prosody.txt"), "w", encoding="utf-8") as f:
        f.writelines(lines[:2 * n])


def mel_float64(wav: np.ndarray, audio: dict) -> tuple:
    """The feature-extraction mel of ``wav`` in float64 (numpy), from the
    float32 window and filterbank: the value that the float32 extractors
    round; and each element's bound for a float32 extractor: the mel rule's
    1e-5 plus a float32 FFT's rounding, ~eps * log2(n_fft) of the frame's
    largest coefficient, carried through the mel's log and normalisation
    (a bin far below its frame's largest gets a wider bound)."""
    from kantts_tpu_torch.dsp.mel import mel_filterbank
    from kantts_tpu_torch.dsp.stft import hann_window, pad_center

    n_fft, hop = audio["n_fft"], audio["hop_length"]
    window = pad_center(hann_window(audio["win_length"]), n_fft).astype(np.float64)
    x = np.pad(wav.astype(np.float64), n_fft // 2, mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft)[::hop]
    spec = np.abs(np.fft.rfft(frames * window, axis=1))
    fb = mel_filterbank(audio["sampling_rate"], n_fft, audio["n_mels"], audio["fmin"],
                        audio["fmax"]).astype(np.float64)
    mel = spec @ fb.T
    S = 20.0 * np.log10(np.maximum(mel, 1e-5)) - audio["ref_level_db"]
    max_norm, min_db = audio["max_norm"], audio["min_level_db"]
    scale = (2 if audio["symmetric"] else 1) * max_norm / -min_db
    kappa = spec.max(axis=1, keepdims=True) * fb.sum(axis=1) / np.maximum(mel, 1e-5)
    bound = 1e-5 + scale * 20.0 / np.log(10.0) * np.log2(n_fft) * np.finfo(
        np.float32).eps * kappa
    if audio["symmetric"]:
        return np.clip(scale * (S - min_db) - max_norm, -max_norm, max_norm), bound
    return np.clip(scale * (S - min_db), 0, max_norm), bound


def am_subset(data: str, dst: str, n: int) -> str:
    """``data`` with its ``am_train.lst`` cut to the first n lines (the
    features linked, not copied). -> ``dst``."""
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(data):
        if name != "am_train.lst":
            os.symlink(os.path.join(data, name), os.path.join(dst, name))
    with open(os.path.join(data, "am_train.lst"), encoding="utf-8") as f:
        lines = f.readlines()[:n]
    with open(os.path.join(dst, "am_train.lst"), "w", encoding="utf-8") as f:
        f.writelines(lines)
    return dst


def preprocess_card_vs_cpu(sub: str, tmp: str, se_model: str) -> dict:
    """(c) ``process_data`` with no device (the card) and with the CPU on the
    subset: exact where the host computes. Where the device computes: the
    mels of the processed wavs on each side within ``mel_float64``'s bound
    of their float64 value (the feature-extraction mel's 1e-5 and a float32
    FFT's rounding), so card and CPU within twice that; the written
    (normalised) mels within that and the statistics' 2e-6 carried through
    the normalisation; energy 1e-5 relative; speaker embeddings 1e-4 of
    their largest. -> the gaps (the mels' as shares of their bounds)."""
    import filecmp

    import torch

    from kantts_tpu_torch.bin.process_data import process_data
    from kantts_tpu_torch.dsp.mel import MelSpectrogramExtractor
    from kantts_tpu_torch.utils.audio import read_wav
    from kantts_tpu_torch.utils.config import load_yaml

    config = os.path.join(CONFIGS, "audio_config_se_16k.yaml")
    outs = {"card": os.path.join(tmp, "card"), "cpu": os.path.join(tmp, "cpu")}
    seconds = {}
    for side, out in outs.items():
        t0 = time.perf_counter()
        if side == "card":
            process_data(sub, out, config, "F7", se_model=se_model)
        else:
            process_data(sub, out, config, "F7", se_model=se_model, device="cpu")
        seconds[side] = round(time.perf_counter() - t0, 3)
    card, cpu = outs["card"], outs["cpu"]
    exact = ["raw_metafile.txt", "Script.xml", "train.lst", "valid.lst", "am_train.lst",
             "am_valid.lst", "badlist.txt"]
    for sub_dir in ("wav", "f0", "frame_f0", "frame_uv", "duration", "raw_duration"):
        exact += [os.path.join(sub_dir, n) for n in sorted(os.listdir(os.path.join(cpu, sub_dir)))
                  if not n.endswith(".txt") or sub_dir == "f0"]
    for rel_path in exact:
        if not filecmp.cmp(os.path.join(card, rel_path), os.path.join(cpu, rel_path),
                           shallow=False):
            raise AssertionError(f"card and CPU differ on {rel_path}")
    audio = load_yaml(config)["audio_config"]
    args = [audio[k] for k in ("sampling_rate", "n_fft", "hop_length", "win_length",
                               "n_mels", "max_norm", "min_level_db", "ref_level_db",
                               "fmin", "fmax", "symmetric")]
    extract = {"card": MelSpectrogramExtractor(*args, device="cuda"),
               "cpu": MelSpectrogramExtractor(*args)}
    gaps = {"mel_card_f64": 0.0, "mel_cpu_f64": 0.0, "mel": 0.0, "mel_abs": 0.0,
            "written_mel": 0.0, "energy_rel": 0.0, "se_rel": 0.0}
    gaps["mel_stats"] = max(float(np.abs(np.loadtxt(os.path.join(card, "mel", n))
                                         - np.loadtxt(os.path.join(cpu, "mel", n))).max())
                            for n in ("mel_mean.txt", "mel_std.txt"))
    std = np.loadtxt(os.path.join(cpu, "mel", "mel_std.txt"))
    stats = {side: [np.loadtxt(os.path.join(out, "energy", f"energy_{s}.txt"))
                    for s in ("mean", "std")] for side, out in outs.items()}
    for path in sorted(glob.glob(os.path.join(cpu, "mel", "utt*.npy"))):
        name = os.path.basename(path)
        wav = read_wav(os.path.join(cpu, "wav", name[:-4] + ".wav"))[1]
        mels = {side: e(wav) for side, e in extract.items()}
        f64, bound = mel_float64(wav, audio)
        for side, key in (("card", "mel_card_f64"), ("cpu", "mel_cpu_f64")):
            gaps[key] = max(gaps[key], float((np.abs(mels[side] - f64) / bound).max()))
        diff = np.abs(mels["card"] - mels["cpu"])
        gaps["mel"] = max(gaps["mel"], float((diff / (2 * bound)).max()))
        gaps["mel_abs"] = max(gaps["mel_abs"], float(diff.max()))
        a, b = np.load(path), np.load(os.path.join(card, "mel", name))
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"mel {name}: NaN positions differ")
        # a written mel is (mel - mean) / std: the mels' error and the
        # statistics' error carried through the normalisation
        ratio = np.abs(a - b) * std / (2 * bound + 2e-6 * (1.0 + np.abs(a)))
        gaps["written_mel"] = max(gaps["written_mel"], float(np.nanmax(ratio)))
        for sub_dir in ("energy", "frame_energy"):
            raw = []
            for side, out in outs.items():
                x = np.load(os.path.join(out, sub_dir, name))
                mean, e_std = stats[side]
                raw.append(np.where(x == 0.0, 0.0, x * e_std + mean))
            gaps["energy_rel"] = max(gaps["energy_rel"], float(
                (np.abs(raw[0] - raw[1]) / (np.abs(raw[1]) + 0.1)).max()))
    for name in sorted(os.listdir(os.path.join(cpu, "se"))):
        a, b = (np.load(os.path.join(out, "se", name)) for out in (cpu, card))
        gaps["se_rel"] = max(gaps["se_rel"], float(np.abs(a - b).max() / np.abs(a).max()))
    del extract
    torch.cuda.empty_cache()
    bounds = {"mel_card_f64": 1.0, "mel_cpu_f64": 1.0, "mel": 1.0, "written_mel": 1.0,
              "energy_rel": 1e-5, "se_rel": 1e-4, "mel_stats": 2e-6}
    log("preprocess_card_vs_cpu", utts=SUBSET_UTTS, exact_files=len(exact),
        seconds=json.dumps(seconds).replace(" ", ""),
        gaps=json.dumps({k: float(f"{v:.3g}") for k, v in gaps.items()}).replace(" ", ""),
        bounds=json.dumps(bounds).replace(" ", ""))
    over = {k: v for k, v in gaps.items() if v > bounds.get(k, np.inf)}
    if over:
        raise AssertionError(f"card vs CPU preprocessing gaps over their bounds: {over}")
    return gaps


def dtdnn_times(model_sd, wav_path: str) -> dict:
    """(d) The full-width D-TDNN on the fbank of an utterance's first 3 s: ms
    per call on the card by CUDA events, and the card against the CPU."""
    import torch

    from kantts_tpu_torch.preprocess.se_processor import DTDNN, kaldi_fbank
    from kantts_tpu_torch.utils.audio import read_wav

    sr, wav = read_wav(wav_path)
    wav = wav[:3 * sr]
    feat = kaldi_fbank(wav, sr, num_mel_bins=80)
    feat = torch.from_numpy((feat - feat.mean(axis=0, keepdims=True))[None])
    card, cpu = DTDNN(model_sd).cuda(), DTDNN(model_sd)
    x = feat.cuda()
    with torch.no_grad():
        ms = cuda_ms(lambda: card(x), 20)
        prof = profile_steps(lambda: card(x), 3)
        a, b = card(x).cpu().numpy(), cpu(feat).numpy()
    gap = float(np.abs(a - b).max() / np.abs(b).max())
    if gap > 1e-4:
        raise AssertionError(f"D-TDNN card vs CPU {gap} of max |embedding|")
    log("dtdnn", seconds_of_audio=round(len(wav) / sr, 3), frames=feat.shape[1],
        ms_per_call=round(ms, 4), card_vs_cpu_rel=float(f"{gap:.3g}"),
        device_busy_ms_3_calls=round(prof["busy_ms"], 3),
        device_ops_per_call=prof["device_ops"] // 3,
        top=json.dumps(prof["top"][:5]).replace(" ", ""))
    return {"ms": ms, "gap": gap, "frames": int(feat.shape[1])}


def phase_preprocess(tmp: str) -> dict:
    """Phase 12, (a)-(e) above. -> K1's launches on this path and results."""
    import torch

    from kantts_tpu_torch.bin import train_hifigan, train_sambert
    from kantts_tpu_torch.ops.mas import b_mas_cuda
    from kantts_tpu_torch.preprocess.se_processor import DTDNN
    from kantts_tpu_torch.utils.corpus import dtdnn_state_dict, write_voice_dir

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "preprocess")
    b_mas_cuda.launches = 0

    # (a) the raw voice and a seeded full-width D-TDNN
    voice = os.path.join(root, "voice")
    t0 = time.perf_counter()
    write_voice_dir(voice, VOICE_UTTS, VOICE_SECONDS, seed=0)
    se_model = os.path.join(root, "se.model")
    sd = dtdnn_state_dict(0)
    torch.save(sd, se_model)
    audio_s = audio_seconds(os.path.join(voice, "wav"))
    log("voice", utts=VOICE_UTTS, audio_s=round(audio_s, 3),
        seconds=round(time.perf_counter() - t0, 3),
        dtdnn_params=sum(p.numel() for p in DTDNN(sd).parameters()))

    # (b) the CLI with no --device
    out = os.path.join(root, "data")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "kantts_tpu_torch.bin.process_data",
         "--voice_input_dir", voice, "--voice_output_dir", out, "--audio_config",
         os.path.join(CONFIGS, "audio_config_se_16k.yaml"), "--speaker", "F7",
         "--se_model", se_model],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"process_data exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    with open(os.path.join(out, "data_process_stdout.log")) as f:
        logged = f.read()
    stage_line = [ln for ln in logged.splitlines() if "Stage seconds: " in ln][-1]
    stages = {k: float(v) for k, v in (kv.split("=") for kv in
                                       stage_line.split("Stage seconds: ")[1].split())}
    if tuple(stages) != STAGES:
        raise AssertionError(f"stages {tuple(stages)}, expected {STAGES}")
    if "Badlist:" not in logged:
        raise AssertionError("process_data logged no badlist")
    bad = check_processed(out)
    if len(bad) > VOICE_UTTS // 20:
        raise AssertionError(f"{len(bad)} of {VOICE_UTTS} utterances in the badlist: {bad}")
    with open(os.path.join(out, "am_train.lst")) as f:
        am_train = f.read().splitlines()
    log("process_data", wall_s=round(wall, 3), audio_s=round(audio_s, 3),
        audio_s_per_s=round(audio_s / wall, 2), badlist=json.dumps(bad).replace(" ", ""),
        am_train=len(am_train),
        stage_s=json.dumps({k: round(v, 3) for k, v in stages.items()}).replace(" ", ""),
        stage_audio_s_per_s=json.dumps({k: round(audio_s / max(v, 1e-9), 1)
                                        for k, v in stages.items()}).replace(" ", ""))

    # (c) card against CPU on a subset; (d) the D-TDNN alone
    sub = os.path.join(root, "subset")
    subset_voice(voice, sub, SUBSET_UTTS)
    gaps = preprocess_card_vs_cpu(sub, root, se_model)
    dtdnn = dtdnn_times(sd, os.path.join(voice, "wav", "utt0000.wav"))
    if b_mas_cuda.launches != 0:
        raise AssertionError(f"preprocessing launched K1 {b_mas_cuda.launches} times")

    # (e) both trainers on (b)'s output
    seconds = {}
    stage = os.path.join(root, "am_train")
    t0 = time.perf_counter()
    am_data = am_subset(out, os.path.join(root, "am_data"), PRE_AM_UTTS)
    am = train_sambert.train(train_config(os.path.join(stage, "model.yaml"),
                                          batch_size=PRE_AM_BATCH, **PRE_KEYS), am_data,
                             stage)
    torch.cuda.synchronize()
    seconds["am_train"] = round(time.perf_counter() - t0, 3)
    check_run(am, stage, PRE_KEYS["train_max_steps"])
    am_launches = b_mas_cuda.launches
    if am_launches < PRE_KEYS["train_max_steps"]:
        raise AssertionError(f"K1 launched {am_launches} times in "
                             f"{PRE_KEYS['train_max_steps']} steps")
    log("preprocess_am_train", steps=am.steps_taken, batch=am.config["batch_size"],
        seconds=seconds["am_train"], k1_launches=am_launches,
        train_items=len(am.train_loader.dataset),
        total_loss=json.dumps({f"{kind}@{at}": round(m[f"{kind}/TotalLoss"], 4)
                               for kind, at, m in am.history}).replace(" ", ""))
    del am
    stage = os.path.join(root, "voc_train")
    t0 = time.perf_counter()
    voc = train_hifigan.train(gan_config(os.path.join(stage, "model.yaml"), **PRE_KEYS),
                              out, stage, device="cuda")
    torch.cuda.synchronize()
    seconds["voc_train"] = round(time.perf_counter() - t0, 3)
    check_run(voc, stage, PRE_KEYS["train_max_steps"])
    log("preprocess_voc_train", steps=voc.steps_taken, batch=voc.config["batch_size"],
        crop=voc.config["batch_max_steps"], seconds=seconds["voc_train"],
        train_items=len(voc.train_loader.dataset), losses=gan_losses(voc))
    del voc
    torch.cuda.empty_cache()
    if b_mas_cuda.launches != am_launches:
        raise AssertionError("K1 launched outside the acoustic training")
    log("preprocess", k1_launches=b_mas_cuda.launches,
        seconds=json.dumps(seconds).replace(" ", ""),
        phase_s=round(time.perf_counter() - t_phase, 3))
    return {"k1_launches": b_mas_cuda.launches, "stages": stages, "wall": wall,
            "audio_s": audio_s, "gaps": gaps, "dtdnn": dtdnn}


def old_k1(src: str):
    """Build an earlier K1 source with the same nvcc flags; it has the first
    K1's C interface (the caller zeroes the output and passes a uint8
    backpointer scratch). -> a callable with that wrapper's work around the
    launch: a zeroed output, a scratch, the launch."""
    import ctypes

    import torch

    from kantts_tpu_torch.ops.nvcc import BUILD_DIR, NVCC_FLAGS, find_nvcc

    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, "libkantts_mas_before.so")
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.kantts_mas_width1.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.kantts_mas_width1.restype = ctypes.c_int

    def call(attn, in_lens, out_lens):
        B, _, T_mel, T_text = attn.shape
        out = torch.zeros_like(attn)
        take = torch.empty((B, T_mel, T_text), dtype=torch.uint8, device=attn.device)
        err = lib.kantts_mas_width1(attn.data_ptr(), in_lens.data_ptr(),
                                    out_lens.data_ptr(), out.data_ptr(), take.data_ptr(),
                                    B, T_mel, T_text,
                                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier K1 launch failed: cudaError {err}")
        return out

    return call


def phase_k1_before(src: str) -> list:
    """The earlier K1 (``src``) and this one on the same maps, in the order
    earlier, this, this, earlier: device ms per launch (profiler) and ms per
    wrapper call (CUDA events), at the three shapes of the main path."""
    import torch

    from kantts_tpu_torch.ops.mas import b_mas_cuda

    before = old_k1(src)
    rng = np.random.RandomState(0)
    rows = []
    for B, T_mel, T_text in ((32, 576, 128), (2, 4800, 800), (8, 576, 96)):
        args = ragged_map(rng, B, T_mel, T_text)
        if not torch.equal(before(*args), b_mas_cuda(*args)):
            raise AssertionError("the earlier K1 and this one differ")
        n = 2 if T_mel > 1000 else 10
        runs = {"before": [], "after": []}
        for who in ("before", "after", "after", "before"):
            fn = before if who == "before" else b_mas_cuda
            names = ("mas_width1_kernel",) if who == "before" else K1_KERNELS
            runs[who].append((kernel_ms(lambda: fn(*args), names, n),
                              cuda_ms(lambda: fn(*args), n)))
        row = {"shape": f"{B}x{T_mel}x{T_text}",
               "variant": b_mas_cuda.variant(T_mel, T_text),
               "bound_ms": k1_bound(B, T_mel, T_text)[0]}
        for who, vals in runs.items():
            row[f"{who}_ms"] = [v[0] for v in vals]
            row[f"{who}_call_ms"] = [v[1] for v in vals]
        log("k1_before_after", **{k: (json.dumps(v) if isinstance(v, list) else v)
                                  for k, v in row.items()})
        rows.append(row)
    return rows


# ---------------------------------------------------------- phase 13: ddp

DDP_KEYS = dict(train_max_steps=8, save_interval_steps=8, eval_interval_steps=8,
                log_interval_steps=2)
DDP_AM = (32, 96, 576)  # the global MAS batch of (b) and (c): B, T_in, T_mel
DDP_TIMED = 6  # timed steps in each of (c)'s four blocks
ADAM_EPS_SCALE = 100.0  # |g| up to this x Adam's eps is at eps's scale
ADAM_EXEMPT_MAX = 16  # entries of a step that may pass by Adam's eps


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, world: int, port: int, local_rank: int) -> dict:
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def state_gap(a: dict, b: dict) -> float:
    """Largest |a - b| over the floating tensors of two nested state dicts."""
    import torch

    gap = 0.0
    for k, v in a.items():
        if isinstance(v, dict):
            gap = max(gap, state_gap(v, b[k]))
        elif torch.is_tensor(v) and v.is_floating_point():
            gap = max(gap, float((v - b[k]).abs().max()))
        elif torch.is_tensor(v) and not torch.equal(v, b[k]):
            raise AssertionError(f"{k} differs")
    return gap


def read_lines(proc, lines: list) -> "threading.Thread":
    """A thread that appends (seconds since ``proc`` started, line) for each
    line of ``proc``'s output."""
    import threading

    t0 = time.perf_counter()

    def read():
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line))

    thread = threading.Thread(target=read, daemon=True)
    thread.start()
    return thread


def cli_profile(lines: list, exit_s: float) -> dict:
    """The seconds of a profiled (``KANTTS_TRAIN_PROFILE=1``) CLI run, split
    by the lines' arrival: ``start`` up to the process group's line
    (launcher, imports, rendezvous), ``to_first_log`` from there to the first
    log interval's line (datasets, build, the broadcast, the first steps),
    the logged windows' phase sums (every later interval), and ``end`` from
    the last window to the exit."""
    def first(text):
        return next(t for t, ln in lines if text in ln)

    start = first("data parallel:")
    phases, windows = {}, [(t, ln) for t, ln in lines if "phase_seconds" in ln]
    for _, ln in windows:
        for field in ln.split("phase_seconds", 1)[1].split():
            k, v = field.split("=")
            phases[k] = phases.get(k, 0.0) + float(v)
    first_log = first(f"(Steps: {DDP_KEYS['log_interval_steps']})")
    return dict(exit=exit_s, start=round(start, 3),
                to_first_log=round(first_log - start, 3),
                logged_steps=len(windows) * DDP_KEYS["log_interval_steps"],
                end=round(exit_s - windows[-1][0], 3),
                **{k: round(v, 4) for k, v in phases.items()})


def ddp_cli(tmp: str) -> dict:
    """(a) train_sambert for 8 steps at B=32 on phase 4's corpus, three runs
    side by side on the card, each with ``KANTTS_TRAIN_PROFILE=1``: twice
    plain and once under torchrun (NCCL, world size 1); the step-8
    checkpoints of the plain runs against each other give the card's own
    gap, and the torchrun run must lie within twice it of the first (exactly
    on it when the gap is 0). Each run's seconds are split by
    ``cli_profile``."""
    import torch

    data = os.path.join(tmp, "corpus")
    steps = DDP_KEYS["train_max_steps"]
    env = dict(os.environ, KANTTS_TRAIN_PROFILE="1")
    procs = {}
    for name, launcher in (("plain_1", []), ("plain_2", []),
                           ("torchrun", ["-m", "torch.distributed.run", "--standalone",
                                         "--nproc_per_node", "1"])):
        stage = os.path.join(tmp, f"ddp_cli_{name}")
        cfg = train_config(os.path.join(stage, "model.yaml"), **DDP_KEYS)
        proc = subprocess.Popen(
            [sys.executable, *launcher, "-m", "kantts_tpu_torch.bin.train_sambert",
             "--model_config", cfg, "--root_dir", data, "--stage_dir", stage],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines = []
        procs[name] = (stage, proc, lines, read_lines(proc, lines), time.perf_counter())
    runs = {}
    try:
        for name, (stage, proc, lines, reader, t0) in procs.items():
            proc.wait(timeout=300)
            exit_s = time.perf_counter() - t0
            reader.join(timeout=30)
            if proc.returncode != 0 or not os.path.exists(ckpt_path(stage, steps)):
                raise RuntimeError(f"{name} train_sambert exited {proc.returncode}:\n"
                                   f"{''.join(ln for _, ln in lines)[-4000:]}")
            with open(os.path.join(stage, "stdout.log")) as f:
                group = [ln.split("] ", 1)[1].strip() for ln in f if "data parallel:" in ln]
            runs[name] = dict(seconds=cli_profile(lines, round(exit_s, 3)), group=group,
                              model=torch.load(ckpt_path(stage, steps), map_location="cpu",
                                               weights_only=True)["model"])
    finally:
        for _, proc, _, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if runs["torchrun"]["group"] != ["data parallel: rank 0 of 1 over nccl"]:
        raise AssertionError(f"torchrun run's group: {runs['torchrun']['group']}")
    plain_gap = state_gap(runs["plain_1"]["model"], runs["plain_2"]["model"])
    ddp_gap = state_gap(runs["torchrun"]["model"], runs["plain_1"]["model"])
    seconds = {k: r["seconds"] for k, r in runs.items()}
    log("ddp_cli", steps=DDP_KEYS["train_max_steps"], batch=32,
        seconds=json.dumps(seconds).replace(" ", ""),
        plain_vs_plain_max_abs=plain_gap, torchrun_vs_plain_max_abs=ddp_gap,
        rule="torchrun <= 2 x plain (0 when plain is 0)")
    if not (ddp_gap <= 2.0 * plain_gap):
        raise AssertionError(f"torchrun run {ddp_gap} from plain, plain runs {plain_gap}")
    return {"plain_gap": plain_gap, "ddp_gap": ddp_gap, "seconds": seconds}


def ddp_am_items(B: int, T_in: int, T_mel: int, seed: int = 0) -> list:
    """B MAS items of ragged lengths (the first at T_in x T_mel), as the AM
    dataset gives them to ``padded_batch``."""
    from kantts_tpu_torch.models.builder import sambert_params

    import yaml

    with open(os.path.join(CONFIGS, "sambert_16k_MAS.yaml")) as f:
        unit = sambert_params(yaml.safe_load(f))
    rng = np.random.RandomState(seed)
    items = []
    for b in range(B):
        n = T_in if b == 0 else int(rng.randint(T_in // 2, T_in))
        m = T_mel if b == 0 else int(rng.randint(T_mel // 6, T_mel // 3 + 1)) * 3
        prior = np.abs(rng.randn(m, n)).astype(np.float32) + 0.1
        items.append(dict(
            ling=np.stack([rng.randint(1, unit[k], n) for k in
                           ("sy", "tone", "syllable_flag", "word_segment")], -1),
            emo=rng.randint(1, unit["emotion"], n), spk=rng.randint(1, unit["speaker"], n),
            mel=rng.randn(m, 80).astype(np.float32),
            pitch=np.abs(rng.randn(m)).astype(np.float32),
            energy=np.abs(rng.randn(m)).astype(np.float32),
            prior=prior / prior.sum(-1, keepdims=True)))
    return items


def padded_batch(items: list, lengths) -> dict:
    """A MAS batch of ``items``, zero-padded to ``lengths`` (T_in, T_mel), on
    the card."""
    import torch

    T_in, T_mel = lengths

    def pad(arrays, length):
        return np.stack([np.pad(a, [(0, length - len(a))] + [(0, 0)] * (a.ndim - 1))
                         for a in arrays])

    arrays = dict(
        input_lings=pad([it["ling"] for it in items], T_in),
        input_emotions=pad([it["emo"] for it in items], T_in),
        input_speakers=pad([it["spk"] for it in items], T_in),
        valid_input_lengths=np.array([len(it["emo"]) for it in items]),
        valid_output_lengths=np.array([len(it["mel"]) for it in items]),
        mel_targets=pad([it["mel"] for it in items], T_mel),
        pitch_contours=pad([it["pitch"] for it in items], T_mel),
        energy_contours=pad([it["energy"] for it in items], T_mel),
        attn_priors=np.stack([np.pad(it["prior"], ((0, T_mel - len(it["prior"])),
                                                   (0, T_in - it["prior"].shape[1])))
                              for it in items]))
    return {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}


def am_lengths(items) -> tuple:
    return (max(len(it["emo"]) for it in items),
            -(-max(len(it["mel"]) for it in items) // 3) * 3)


def ddp_gan_batch(B: int, T: int, seed: int = 1):
    """B tone crops of T samples and random mels of T / 200 frames."""
    import torch

    rng = np.random.RandomState(seed)
    t = np.arange(T) / 16000.0
    f0 = rng.uniform(100, 300, (B, 1))
    wav = (0.5 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.randn(B, T)).astype(np.float32)
    mel = rng.randn(B, T // HOP, 80).astype(np.float32)
    return torch.from_numpy(wav[..., None]).cuda(), torch.from_numpy(mel).cuda()


def ddp_models(kind: str, data_parallel, timer=None):
    """The seeded full-width model(s) of ``kind`` ("am": sambert_16k_MAS,
    "gan": hifigan_v1_16k) with dropout off, and their train step. ->
    (step, modules, the largest ``eps`` of their Adam optimizers)."""
    import torch
    import yaml

    from kantts_tpu_torch.losses import criterion_builder
    from kantts_tpu_torch.models.builder import hifigan_gan_builder, sambert_model_builder
    from kantts_tpu_torch.train.steps import make_gan_step, make_sambert_step

    cuda = torch.device("cuda")
    name = "sambert_16k_MAS" if kind == "am" else "hifigan_v1_16k"
    with open(os.path.join(CONFIGS, f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    if kind == "am":
        built = sambert_model_builder(cfg, 0, cuda)
        modules, optimizers = [built["model"]], [built["optimizer"]]
        step = make_sambert_step(built["model"], criterion_builder(cfg),
                                 built["optimizer"], built["scheduler"], built["clip"],
                                 True, data_parallel=data_parallel, timer=timer)
    else:
        b = hifigan_gan_builder(cfg, 0, cuda)
        modules = [b["generator"], *b["discriminators"].values()]
        optimizers = [b["gen_optimizer"], *b["disc_optimizers"].values()]
        step = make_gan_step(b["generator"], b["discriminators"], criterion_builder(cfg),
                             b["gen_optimizer"], b["gen_scheduler"],
                             b["disc_optimizers"], b["disc_schedulers"], b["gen_clip"],
                             b["disc_clips"], data_parallel=data_parallel, timer=timer)
    for m in modules:
        for sub in m.modules():
            if isinstance(sub, torch.nn.Dropout):
                sub.p = 0.0
    eps = max(g["eps"] for o in optimizers for g in o.param_groups)
    return step, modules, eps


def snapshot(modules) -> tuple:
    """-> (every parameter and buffer, every gradient) of ``modules``, cloned."""
    state, grads = {}, {}
    for i, m in enumerate(modules):
        state.update({f"{i}.{k}": v.detach().clone() for k, v in m.state_dict().items()})
        grads.update({f"{i}.{k}": p.grad.detach().clone()
                      for k, p in m.named_parameters() if p.grad is not None})
    return state, grads


def compare_steps(name: str, got: tuple, want: tuple, eps: float) -> dict:
    """A data-parallel step (metrics, state, grads) against the one-process
    step on the global batch, by the CPU test's rule: metrics within 1e-4
    (relative above 1); gradients within 1e-5 of their global norm;
    parameters and buffers atol 2e-5 / rtol 1e-4. Adam's first step moves an
    entry by lr * g / (|g| + eps), so where g is at eps's scale (both sums
    within ``ADAM_EPS_SCALE`` x the optimizer's ``eps``) or where the two sums
    differ in sign (|g| within their gap), two sums of one gradient may
    move it apart by up to 2 lr. Every such entry outside the tolerance is
    counted and at most ``ADAM_EXEMPT_MAX`` pass; any other entry outside it
    fails."""
    import torch

    (m_got, s_got, g_got), (m_want, s_want, g_want) = got, want
    worst_metric = max(abs(float(m_got[k]) - float(v)) / max(1.0, abs(float(v)))
                       for k, v in m_want.items())
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in g_want.values()])))
    worst_grad = max(float((g_got[k] - g).abs().max()) for k, g in g_want.items())
    exempt, listed, bad = 0, [], []
    for k, v in s_want.items():
        if not v.is_floating_point():
            if not torch.equal(s_got[k], v):
                bad.append(k)
            continue
        off = ~torch.isclose(s_got[k], v, rtol=1e-4, atol=2e-5)
        if not off.any():
            continue
        g, h = g_want.get(k), g_got.get(k)
        if g is None:
            bad.append(k)
            continue
        at_eps = torch.maximum(g.abs(), h.abs()) <= ADAM_EPS_SCALE * eps
        unsigned = g.abs() <= (h - g).abs()
        free = off & (at_eps | unsigned)
        exempt += int(free.sum())
        for i in free.nonzero()[:4].tolist():
            i = tuple(i)
            listed.append(f"{k}{list(i)}:g={float(h[i]):.3g}/{float(g[i]):.3g},"
                          f"dp={float(s_got[k][i] - v[i]):.3g}")
        if (off & ~free).any():
            bad.append(k)
    result = dict(max_metric_err=worst_metric, max_grad_err=worst_grad,
                  grad_norm=norm, grad_err_over_norm=worst_grad / norm,
                  params_off=len(bad), adam_exempt=exempt, adam_eps=eps)
    log(name, **{k: (round(v, 9) if isinstance(v, float) else v)
                 for k, v in result.items()}, adam_exempt_listed=";".join(listed))
    if (worst_metric > 1e-4 or worst_grad > 1e-5 * norm or bad
            or exempt > ADAM_EXEMPT_MAX):
        raise AssertionError(f"{name}: {result}, off: {bad[:8]}")
    return dict(result, adam_exempt_listed=listed)


def state_checksum(modules) -> list:
    """Per tensor, the sum of its bits read as int32 words and its float64
    sum: equal lists mean bit-equal tensors, but for a collision."""
    import torch

    out = []
    for m in modules:
        for v in m.state_dict().values():
            flat = v.detach().contiguous().reshape(-1)
            words = flat.view(torch.int32) if flat.element_size() == 4 else flat.long()
            out.append((int(words.long().sum()), float(flat.double().sum())))
    return out


def ddp_worker(rank: int, port: int, out: str) -> int:
    """(b) one of two ranks on cuda:0 over gloo with CUDA tensors: a
    full-width MAS step on its 16 of the 32 items (padded to the lengths the
    ranks agree on) and a hifigan_v1_16k GAN step on its 8 of 16 crops, the
    ranks' states checked bit-equal; rank 0 then runs each step on the
    global batch in one process and compares. K1's launches are those of
    this rank's own data-parallel steps, read before any reference step."""
    import torch
    import torch.distributed as dist

    from kantts_tpu_torch.ops.mas import b_mas_cuda
    from kantts_tpu_torch.parallel import mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(torchrun_env(rank, 2, port, 0))
    mesh.distributed_init("cuda", backend="gloo")
    results = {"k1_launches": 0}
    items = ddp_am_items(*DDP_AM)
    half = DDP_AM[0] // 2
    mine = items[rank * half:(rank + 1) * half]
    agreed = mesh.lengths_max()(am_lengths(mine))
    wav, mel = ddp_gan_batch(*GAN_SHAPE)
    gan_half = GAN_SHAPE[0] // 2
    for kind, args, global_args in (
            ("am", (padded_batch(mine, agreed), 0), (padded_batch(items, agreed), 0)),
            ("gan", (wav[rank * gan_half:(rank + 1) * gan_half],
                     mel[rank * gan_half:(rank + 1) * gan_half]), (wav, mel))):
        step, modules, eps = ddp_models(kind, None)
        mesh.replicate(modules)
        b_mas_cuda.launches = 0
        metrics = step(*args)
        results["k1_launches"] += b_mas_cuda.launches
        torch.cuda.synchronize()
        sums = [None, None]
        dist.all_gather_object(sums, state_checksum(modules))
        if sums[0] != sums[1]:
            raise AssertionError(f"{kind}: the ranks' states differ after the step")
        if rank == 0:
            got = ({k: v.item() for k, v in metrics.items()}, *snapshot(modules))
            del step, modules
            ref_step, ref_modules, _ = ddp_models(kind, False)
            ref_metrics = ref_step(*global_args)
            want = ({k: v.item() for k, v in ref_metrics.items()}, *snapshot(ref_modules))
            results[kind] = compare_steps(f"ddp_two_ranks_{kind}", got, want, eps)
            del ref_step, ref_modules, got, want
        torch.cuda.empty_cache()
    with open(os.path.join(out, f"ddp_rank{rank}.json"), "w") as f:
        json.dump(results, f)
    mesh.destroy()
    return 0


def ddp_two_ranks(tmp: str) -> dict:
    """(b): two ``ddp_worker`` processes. -> rank 0's results and the K1
    launches of both."""
    out = os.path.join(tmp, "ddp_two_ranks")
    os.makedirs(out, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-worker",
                               str(rank), str(port), out], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        print(text, end="", flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"ddp worker {rank} exited {p.returncode}")
    res = [json.load(open(os.path.join(out, f"ddp_rank{r}.json"))) for r in range(2)]
    launches = [r["k1_launches"] for r in res]
    log("ddp_two_ranks", seconds=round(time.perf_counter() - t0, 3), k1_launches=launches)
    if 0 in launches:
        raise AssertionError(f"K1 did not launch in a rank's data-parallel step: {launches}")
    return dict(res[0], k1_launches=sum(launches))


def timed_blocks(steps: dict, args, n: int) -> dict:
    """Each step in turns a, b, b, a (2 warmup calls, then n calls between
    two CUDA events). -> {name: [ms per step of each block]}."""
    import torch

    times = {name: [] for name in steps}
    names = list(steps)
    for name in names + names[::-1]:
        for _ in range(2):
            steps[name](*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            steps[name](*args)
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / n)
    return times


def counted(step, tally: list):
    """``step``, with K1's launches inside each of its calls (the count set
    to 0 just before the call and read just after) added to ``tally[0]``."""
    from kantts_tpu_torch.ops.mas import b_mas_cuda

    def run(*args):
        b_mas_cuda.launches = 0
        out = step(*args)
        tally[0] += b_mas_cuda.launches
        return out

    return run


def ddp_timing() -> dict:
    """(c) the AM step at 32 x 96 x 576 and the GAN step at 16 x 9600 at
    world size 1 over NCCL (this process joins through torchrun's
    environment) against the plain step: ms per step from CUDA events (the
    mean of each step's two blocks), the collectives' ms per step
    (``CollectiveTimer``'s CUDA events around every collective of the step,
    the gradients' flattening and copy back included: the median over the
    timed steps) and the gradient bytes they reduce, host syncs of one
    step, and K1's launches in the data-parallel steps alone."""
    import torch

    from kantts_tpu_torch.parallel import mesh

    os.environ.update(torchrun_env(0, 1, free_port(), 0))
    try:
        mesh.distributed_init("cuda")
        if not (mesh.is_distributed() and mesh.world_size() == 1):
            raise AssertionError("no process group of one")
        out = {"backend": torch.distributed.get_backend()}
        items = ddp_am_items(*DDP_AM)
        am_batch = (padded_batch(items, am_lengths(items)), 0)
        for kind, args in (("am", am_batch), ("gan", ddp_gan_batch(*GAN_SHAPE))):
            timer = mesh.CollectiveTimer()
            plain, _, _ = ddp_models(kind, False)
            ddp, modules, _ = ddp_models(kind, None, timer)
            tally = [0]
            ddp = counted(ddp, tally)
            plain(*args)
            ddp(*args)  # NCCL makes its communicator at the first collective
            per_step = len(timer.take_intervals())
            times = timed_blocks({"plain": plain, "ddp": ddp}, args, DDP_TIMED)
            spans = timer.take_intervals()
            allreduce_ms = float(np.median([sum(spans[i:i + per_step]) for i in
                                            range(0, len(spans), per_step)])) * 1e3
            grad_bytes = sum(p.grad.numel() * p.grad.element_size() for m in modules
                             for p in m.parameters() if p.grad is not None)
            syncs = {name: len(host_syncs(lambda s=s: s(*args)))
                     for name, s in (("plain", plain), ("ddp", ddp))}
            plain_ms, ddp_ms = (float(np.mean(times[k])) for k in ("plain", "ddp"))
            out[kind] = dict(plain_ms=plain_ms, ddp_ms=ddp_ms,
                             allreduce_ms=allreduce_ms, collectives_per_step=per_step,
                             grad_bytes=grad_bytes,
                             allreduce_share=allreduce_ms / ddp_ms,
                             host_syncs_plain=syncs["plain"], host_syncs_ddp=syncs["ddp"],
                             k1_launches=tally[0])
            log(f"ddp_step_{kind}", backend=out["backend"],
                blocks_ms=json.dumps({k: [round(t, 3) for t in v]
                                      for k, v in times.items()}).replace(" ", ""),
                **{k: round(v, 4) if isinstance(v, float) else v
                   for k, v in out[kind].items()})
            if syncs["ddp"] > syncs["plain"]:
                raise AssertionError(f"{kind}: the data-parallel step adds host syncs: {syncs}")
            if kind == "am" and tally[0] == 0:
                raise AssertionError("K1 did not launch in the data-parallel AM step")
            del plain, ddp, modules
            torch.cuda.empty_cache()
        return out
    finally:
        mesh.destroy()
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(key, None)


def phase_ddp(tmp: str) -> dict:
    """Phase 13: (a) the CLI under torchrun against plain, (b) two ranks
    against one process, (c) the steps at world size 1 on NCCL, timed. ->
    K1's launches in the data-parallel steps of (b) and (c) and results."""
    t_phase = time.perf_counter()
    cli = ddp_cli(tmp)
    two = ddp_two_ranks(tmp)
    timing = ddp_timing()
    launches = two["k1_launches"] + timing["am"]["k1_launches"]
    seconds = time.perf_counter() - t_phase
    log("ddp", seconds=round(seconds, 3), k1_launches=launches)
    return {"k1_launches": launches, "cli": cli, "two_ranks": two, "timing": timing,
            "seconds": seconds}


# ------------------------------------------------------------------ phase 16

TP_KEYS = dict(train_max_steps=2, save_interval_steps=2, eval_interval_steps=2,
               log_interval_steps=1, tensor_parallel=2)
TP_TIMED = 3  # timed TP steps of (a), after the checked one and a warm-up
SP_FRAMES = 400  # (c), (g): 5 s at hop 200, the vocoder's B=1 shape
PP_SHAPE = (32, 96)  # (d): B, T of the pipelined encoder, the AM step's text batch
PP_MICRO = 4
# (e): each voice the JAX CLI shards -> (its config, top-level keys); its batch
# is (a)'s 32 x 96 x 576 (bytes for the byte voice), phase 10's SE corpus at
# 32 x 96 x 576, phase 11's FP corpus at 16 x 96 x 480
TP_VOICES = {"bf16": ("sambert_16k_MAS", {"mixed_precision": True}),
             "byte": ("sambert_16k_MAS_byte", {}),
             "fp": ("sambert_fp_8k", {}),
             "se_nsf": ("sambert_se_nsf_global_16k", {}),
             "warm": ("sambert_16k_MAS", {})}
TP_VOICE_TIMED = 2  # timed TP and plain steps of each voice, after a warm-up
TP_CRASH_STEP = 2  # (f): the step the CLI is interrupted at on both ranks
NSF_SP = ("hifigan_v1_nsf_24k", "hifigan_noncausal_nsf_v1_16k")  # (g)
NSF_SP_DRAW = 9  # the seed of (g)'s source draws


def tp_am(grid=None, timer=None, voice=None, tmp=None, fp_dict=None):
    """Seeded full-width sambert_16k_MAS on the card with dropout off (as in
    ``ddp_models``), or the (e) ``voice`` of ``TP_VOICES`` (the warm start's
    encoder copied from ``tmp``'s Textsy-BERT checkpoint first, as
    ``train_sambert`` copies it before it shards); with ``grid``, sharded
    over its model group with the tensor-parallel clip. Its clip records the
    pre-clip norm of the first step into ``seen`` (and for (a) the whole
    pre-clip gradients). -> (step, model, optimizer, cfg, seen)."""
    import torch
    import yaml

    from kantts_tpu_torch.losses import criterion_builder
    from kantts_tpu_torch.models.builder import sambert_model_builder, sambert_params
    from kantts_tpu_torch.parallel import tp
    from kantts_tpu_torch.train.steps import make_sambert_step
    from kantts_tpu_torch.train.trainer import load_sambert_encoder_from_sybert

    name, keys = TP_VOICES[voice] if voice else ("sambert_16k_MAS", {})
    with open(os.path.join(CONFIGS, f"{name}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(keys)
    built = sambert_model_builder(cfg, 0, torch.device("cuda"))
    model, optimizer = built["model"], built["optimizer"]
    for sub in model.modules():
        if isinstance(sub, torch.nn.Dropout):
            sub.p = 0.0
    if voice == "warm":
        copied = load_sambert_encoder_from_sybert(model, os.path.join(tmp, "tp_bert.ckpt"))
        if not copied:
            raise AssertionError("the warm start copied nothing")
    clip = built["clip"]
    if grid is not None:
        tp.shard_module(model, grid, optimizer, timer)
        clip = tp.make_clip(model, cfg["grad_norm"])
    seen = {}

    def recorded_clip():
        if not seen:
            if voice is None:
                seen["grads"] = tp.gather_grads(model)
            seen["norm"] = float(clip())
            return
        clip()

    step = make_sambert_step(model, criterion_builder(cfg), optimizer, built["scheduler"],
                             recorded_clip, sambert_params(cfg).get("MAS", False),
                             fp_dict_lings=fp_dict, data_parallel=grid is not None,
                             group=grid.data_group if grid is not None else None)
    return step, model, optimizer, cfg, seen


def tp_voice_batch(voice: str, tmp: str):
    """(e)'s batch of ``voice`` on the card -> (step args, fp_dict_lings or
    None, (B, T_in, T_mel)): (a)'s MAS batch, with bytes (and the byte
    unit's emotions and speakers) for the byte voice; the SE and FP voices
    the longest items of phase 10's and phase 11's corpora through the AM
    dataset (``tp_voice_corpora``)."""
    import torch

    from kantts_tpu_torch.data.dataset import get_am_datasets
    from kantts_tpu_torch.models.builder import sambert_params
    from kantts_tpu_torch.train.trainer import array_to_device, batch_to_device
    from kantts_tpu_torch.utils.config import load_merged_config

    name, keys = TP_VOICES[voice]
    cuda = torch.device("cuda")
    if voice in ("fp", "se_nsf"):
        corpus = os.path.join(tmp, *(("fp", "fp_corpus") if voice == "fp"
                                     else ("se", "corpus")))
        cfg = load_merged_config(corpus, os.path.join(CONFIGS, f"{name}.yaml"))
        params = cfg["Model"]["KanTtsSAMBERT"]["params"]
        ds, _ = get_am_datasets([os.path.join(corpus, "raw_metafile.txt")], [corpus], cfg,
                                se_enable=params.get("SE", False))
        items = sorted((ds[i] for i in range(len(ds))),
                       key=lambda it: -it[1].shape[0])[:cfg["batch_size"]]
        batch = batch_to_device(ds.collate_fn(items), cuda)
        fp_dict = array_to_device(ds.fp_dict_lings, cuda) if voice == "fp" else None
    else:
        items = ddp_am_items(*DDP_AM)
        if voice == "byte":
            import yaml

            with open(os.path.join(CONFIGS, f"{name}.yaml")) as f:
                unit = sambert_params(yaml.safe_load(f))
            rng = np.random.RandomState(9)
            for it in items:
                n = len(it["emo"])
                it.update(ling=rng.randint(1, unit["byte_index"], (n, 1)),
                          emo=rng.randint(1, unit["emotion"], n),
                          spk=rng.randint(1, unit["speaker"], n))
        batch, fp_dict = padded_batch(items, am_lengths(items)), None
    shape = (int(batch["mel_targets"].shape[0]), int(batch["input_lings"].shape[1]),
             int(batch["mel_targets"].shape[1]))
    return (batch, 0), fp_dict, shape


def tp_voice_corpora(tmp: str) -> None:
    """The corpora and checkpoint (e) reads: phase 10's SE corpus and phase
    11's FP corpus, each written as that phase writes it unless it ran, and
    a seeded full-width Textsy-BERT checkpoint for the warm start."""
    import yaml

    from kantts_tpu_torch.models.builder import save_checkpoint, sybert_model_builder
    from kantts_tpu_torch.utils.corpus import write_am_corpus, write_fp_corpus

    se = os.path.join(tmp, "se", "corpus")
    if not os.path.isdir(se):
        write_am_corpus(se, 40, (60, 90), (400, 570), seed=0, durations=True, nsf=True,
                        se_units=SE_UNITS)
    fp = os.path.join(tmp, "fp", "fp_corpus")
    if not os.path.isdir(fp):
        write_fp_corpus(fp, 40, (40, 70), (300, 450), seed=0, sampling_rate=FP_SR)
    with open(os.path.join(CONFIGS, "sybert.yaml")) as f:
        cfg = yaml.safe_load(f)
    save_checkpoint(os.path.join(tmp, "tp_bert.ckpt"), sybert_model_builder(cfg, 4)["model"],
                    cfg)


class K1Maps:
    """Inside the block, the inputs and output of the first K1 call that
    ``mas_align`` makes (the map the step handed it); the launches stay
    K1's own count."""

    def __enter__(self):
        from kantts_tpu_torch.models.sambert import alignment

        self.alignment, self.real, self.first = alignment, alignment.b_mas_cuda, None

        def recorded(attn, in_lens, out_lens):
            hard = self.real(attn, in_lens, out_lens)
            if self.first is None:
                self.first = (attn.clone(), in_lens.clone(), out_lens.clone(), hard.clone())
            return hard

        alignment.b_mas_cuda = recorded
        return self

    def __exit__(self, *exc):
        self.alignment.b_mas_cuda = self.real

    def exact(self):
        """K1 equal to ``b_mas_torch`` on the recorded map, or None without
        a call."""
        import torch

        from kantts_tpu_torch.models.sambert.alignment import b_mas_torch

        if self.first is None:
            return None
        attn, in_lens, out_lens, hard = self.first
        return bool(torch.equal(hard, b_mas_torch(attn, in_lens, out_lens)))


def nsf_sp_generator(name: str):
    """(g)'s seeded NSF vocoder of ``name`` at its config's widths, on the
    card."""
    import yaml

    from kantts_tpu_torch.models.builder import hifigan_model_builder

    with open(os.path.join(CONFIGS, f"{name}.yaml")) as f:
        return hifigan_model_builder(yaml.safe_load(f), 3).cuda().eval()


def wall_ms(fn, n: int) -> float:
    """ms per call of ``fn`` by the host clock between device syncs (the
    parallel calls wait on host collectives, so CUDA events alone would miss
    their host side)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def sp_generator(causal: bool):
    """The seeded hifigan_v1_16k generator (its config's widths), causal or
    not, on the card."""
    import yaml

    from kantts_tpu_torch.models.builder import hifigan_model_builder

    with open(os.path.join(CONFIGS, "hifigan_v1_16k.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["Model"]["Generator"]["params"]["causal"] = causal
    return hifigan_model_builder(cfg, 3).cuda().eval()


def pp_encoder_and_inputs():
    """sambert_16k's text encoder widths (8 FFT layers, d_model 128, 8 heads,
    FFN 1024) with its input at d_model (the stacked layers must be alike),
    seeded, and a ragged (32, 96) batch."""
    import torch

    from kantts_tpu_torch.models.sambert.sambert import SelfAttentionEncoder

    torch.manual_seed(5)
    enc = SelfAttentionEncoder(128, 8, 128, 8, 16, 1024, 0.0, 0.0, 0.0, 800).cuda().eval()
    B, T = PP_SHAPE
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(B, T, 128).astype(np.float32)).cuda()
    lengths = torch.from_numpy(rng.randint(T // 2, T + 1, B)).cuda()
    lengths[0] = T
    mask = torch.arange(T, device=x.device)[None, :] >= lengths[:, None]
    return enc, x, mask


def tp_worker(rank: int, port: int, out: str) -> int:
    """One of two ranks on cuda:0 over gloo with CUDA tensors, a 1 x 2 grid.
    (a) a tensor-parallel step of full-width sambert_16k_MAS on the 32 x 96
    x 576 batch of phase 13 (whole pre-clip gradients, parameters after it)
    and the gathered checkpoint; (e) one tensor-parallel step of each
    ``TP_VOICES`` voice (its loss, pre-clip norm, and K1 exact on the map
    the step handed it); (c) the sequence-parallel hifigan_v1_16k call on
    400 frames, causal and not; (g) the two NSF vocoders of ``NSF_SP``
    sequence-parallel on 400 frames, the source given and drawn on rank 0
    and broadcast; (d) the 2-stage pipelined encoder, forward and backward.
    Once the parent writes ``go`` (the CLIs beside them have ended): 2 +
    ``TP_TIMED`` more steps of (a), timed with the model group's
    collectives, one step's host syncs, 1 + ``TP_VOICE_TIMED`` steps of each
    voice, then (c), (g) and (d) timed. K1's launches are counted inside
    every TP step. Then rank 0 alone runs the references: the one-process
    steps on the same batches, the plain load of the checkpoint, the
    unsharded vocoder calls and the sequential encoder, each timed."""
    import torch
    import torch.distributed as dist

    from kantts_tpu_torch.models.builder import checkpoint_payload, load_checkpoint, save_checkpoint
    from kantts_tpu_torch.parallel import mesh, pp, tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(torchrun_env(rank, 2, port, 0))
    mesh.distributed_init("cuda", backend="gloo")
    grid = mesh.make_mesh_2d(1, 2)
    tmp = os.path.dirname(out)
    res = {}
    # (a)
    items = ddp_am_items(*DDP_AM)
    args = (padded_batch(items, am_lengths(items)), 0)
    timer = mesh.CollectiveTimer()
    step, model, optimizer, cfg, seen = tp_am(grid, timer)
    tally = [0]
    step = counted(step, tally)
    metrics = {k: v.item() for k, v in step(*args).items()}
    first = dict(metrics=metrics, grads=seen["grads"], norm=seen["norm"],
                 state={k: v.clone() for k, v in tp.gather_state_dict(model).items()})
    ckpt = os.path.join(out, "tp_checkpoint.ckpt")
    whole, whole_optimizer = tp.gather_training_state(model, optimizer)
    payload = checkpoint_payload(whole, cfg, optimizer=whole_optimizer)
    saved = {k: v.clone() for k, v in payload["model"].items()}
    if rank == 0:
        save_checkpoint(ckpt, payload["model"], cfg, optimizer=payload["optimizer"])
    del payload
    # (e)
    voices, voice_steps = {}, {}
    for voice in TP_VOICES:
        v_args, fp_dict, shape = tp_voice_batch(voice, tmp)
        v_step, _, _, _, v_seen = tp_am(grid, None, voice, tmp, fp_dict)
        v_tally = [0]
        v_step = counted(v_step, v_tally)
        with K1Maps() as maps:
            loss = v_step(*v_args)["TotalLoss"].item()
        voices[voice] = dict(shape=shape, loss=loss, norm=v_seen["norm"], k1_exact=maps.exact())
        voice_steps[voice] = (v_step, v_args, v_tally)
    # (c)
    mel = torch.from_numpy(np.random.RandomState(8).randn(1, SP_FRAMES, 80)
                           .astype(np.float32)).cuda()
    gens = {causal: sp_generator(causal) for causal in (True, False)}
    with torch.no_grad():
        sp = {causal: tp.sequence_parallel_apply(gen, mel) for causal, gen in gens.items()}
    # (g)
    nsf_mel_ = torch.from_numpy(nsf_mel(np.random.RandomState(10), SP_FRAMES)).cuda()
    nsf_gens = {name: nsf_sp_generator(name) for name in NSF_SP}

    def draws():
        return torch.Generator(device="cuda").manual_seed(NSF_SP_DRAW)

    with torch.no_grad():
        excitation = {name: gen(nsf_mel_, excitation_only=True, generator=draws())
                      for name, gen in nsf_gens.items()}
        nsf_sp = {name: dict(
            given=tp.sequence_parallel_apply(gen, nsf_mel_, excitation=excitation[name]),
            broadcast=tp.sequence_parallel_apply(gen, nsf_mel_, rng=draws()))
            for name, gen in nsf_gens.items()}
    # (d)
    enc, x, mask = pp_encoder_and_inputs()
    pipe = pp.make_pipe_mesh(2)

    def pipelined():
        enc.zero_grad(set_to_none=True)
        out_ = pp.sambert_encoder_pipeline(enc, x, mask, pipe, PP_MICRO)
        out_.square().sum().backward()
        return out_

    pp_out = pipelined().detach()
    pp_grads = {}
    for k, p in enc.named_parameters():
        g = p.grad.clone()
        if k.startswith("fft."):  # each stage holds its own layers' share
            dist.all_reduce(g)
        pp_grads[k] = g
    # the timings, once the CLIs have left the card (the parent writes go)
    while not os.path.exists(os.path.join(out, "go")):
        time.sleep(0.2)
    timer.take_intervals()
    step(*args)  # warm-up; its collectives give the count a step
    per_step = len(timer.take_intervals())
    res["tp_ms"] = wall_ms(lambda: step(*args), TP_TIMED)
    spans = timer.take_intervals()[per_step:]  # wall_ms's own first call
    res["collective_ms"] = float(np.median([sum(spans[i:i + per_step]) for i in
                                            range(0, len(spans), per_step)])) * 1e3
    res["collectives_per_step"] = per_step
    res["host_syncs_tp"] = len(host_syncs(lambda: step(*args)))
    res["k1_launches"] = tally[0]
    del step, model, optimizer
    for voice, (v_step, v_args, v_tally) in voice_steps.items():
        voices[voice]["tp_ms"] = wall_ms(lambda: v_step(*v_args), TP_VOICE_TIMED)
        voices[voice]["k1_launches"] = v_tally[0]
        voices[voice]["tp_steps"] = 2 + TP_VOICE_TIMED
    res["voices"] = voices
    del voice_steps, v_step
    torch.cuda.empty_cache()
    with torch.no_grad():
        for causal, gen in gens.items():
            res[f"sp_ms_{causal}"] = wall_ms(lambda: tp.sequence_parallel_apply(gen, mel), 5)
        for name, gen in nsf_gens.items():
            res[f"nsf_sp_ms_{name}"] = wall_ms(lambda: tp.sequence_parallel_apply(
                gen, nsf_mel_, excitation=excitation[name]), 5)
    res["pp_ms"] = wall_ms(pipelined, 3)
    dist.barrier()
    mesh.destroy()
    if rank == 1:
        with open(os.path.join(out, "tp_rank1.json"), "w") as f:
            json.dump(res, f)
        return 0

    # the references, rank 0 alone
    ref_step, ref_model, _, _, ref_seen = tp_am()
    ref_metrics = {k: v.item() for k, v in ref_step(*args).items()}
    grads, norm = ref_seen["grads"], ref_seen["norm"]
    worst_grad = max(float((first["grads"][k] - g).abs().max()) for k, g in grads.items())
    worst_param = max(float((first["state"][k] - v).abs().max())
                      for k, v in ref_model.state_dict().items() if v.is_floating_point())
    loss_rel = abs(metrics["TotalLoss"] - ref_metrics["TotalLoss"]) / abs(ref_metrics["TotalLoss"])
    res.update(loss_rel=loss_rel, grad_err_over_norm=worst_grad / norm, grad_norm=norm,
               norm_rel=abs(first["norm"] - norm) / norm, max_param_err=worst_param,
               plain_ms=wall_ms(lambda: ref_step(*args), TP_TIMED),
               host_syncs_plain=len(host_syncs(lambda: ref_step(*args))))
    plain, _ = load_checkpoint(ckpt, torch.device("cuda"))
    res["checkpoint_bit_equal"] = (plain.state_dict().keys() == saved.keys() and all(
        torch.equal(v, saved[k]) for k, v in plain.state_dict().items()))
    del ref_step, ref_model, plain, first
    torch.cuda.empty_cache()
    for voice, got in voices.items():
        v_args, fp_dict, _ = tp_voice_batch(voice, tmp)
        v_step, _, _, _, v_seen = tp_am(None, None, voice, tmp, fp_dict)
        loss = v_step(*v_args)["TotalLoss"].item()
        got.update(plain_loss=loss, plain_norm=v_seen["norm"],
                   loss_rel=abs(got["loss"] - loss) / abs(loss),
                   norm_rel=abs(got["norm"] - v_seen["norm"]) / v_seen["norm"],
                   plain_ms=wall_ms(lambda: v_step(*v_args), TP_VOICE_TIMED))
        if voice == "bf16":  # its f32 twin is (a)'s one-process step
            got["e_ref"] = abs(loss - ref_metrics["TotalLoss"])
            got["gap_over_e_ref"] = abs(got["loss"] - loss) / got["e_ref"]
        del v_step
        torch.cuda.empty_cache()
    for causal, gen in gens.items():
        with torch.no_grad():
            want = gen(mel)
            res[f"sp_max_abs_err_{causal}"] = float((sp[causal] - want).abs().max())
            res[f"unsharded_ms_{causal}"] = wall_ms(lambda: gen(mel), 5)
    for name, gen in nsf_gens.items():
        with torch.no_grad():
            want = gen(nsf_mel_, excitation=excitation[name])
            for route, got in nsf_sp[name].items():
                res[f"nsf_sp_max_abs_err_{name}_{route}"] = float((got - want).abs().max())
            res[f"nsf_sp_routes_equal_{name}"] = bool(torch.equal(
                nsf_sp[name]["given"], nsf_sp[name]["broadcast"]))
            res[f"nsf_unsharded_ms_{name}"] = wall_ms(
                lambda: gen(nsf_mel_, excitation=excitation[name]), 5)
    got_grads = pp_grads

    def sequential():
        enc.zero_grad(set_to_none=True)
        out_, _ = enc(x, mask)
        out_.square().sum().backward()
        return out_

    want = sequential().detach()
    res["pp_max_abs_err"] = float((pp_out - want).abs().max())
    gnorm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in enc.parameters()])))
    res["pp_grad_err_over_norm"] = max(float((got_grads[k] - p.grad).abs().max())
                                       for k, p in enc.named_parameters()) / gnorm
    res["sequential_ms"] = wall_ms(sequential, 3)
    with open(os.path.join(out, "tp_rank0.json"), "w") as f:
        json.dump(res, f)
    return 0


def tp_two_ranks(tmp: str, before_timing) -> dict:
    """(a), (c), (d): two ``tp_worker`` processes; once ``before_timing()``
    has returned (the CLI beside them has ended), they time. -> rank 0's
    results and both ranks' K1 launches."""
    out = os.path.join(tmp, "tp_two_ranks")
    os.makedirs(out, exist_ok=True)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-worker",
                               str(rank), str(port), out], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    logs = []
    try:
        before = before_timing()
        open(os.path.join(out, "go"), "w").close()
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(text, end="", flush=True)
            raise RuntimeError(f"tp worker {rank} exited {p.returncode}")
    res = [json.load(open(os.path.join(out, f"tp_rank{r}.json"))) for r in range(2)]
    for voice, got in res[0]["voices"].items():
        got["k1_launches"] = [r["voices"][voice]["k1_launches"] for r in res]
        got["tp_ms_rank1"] = res[1]["voices"][voice]["tp_ms"]
    return dict(res[0], k1_launches=[r["k1_launches"] for r in res],
                tp_ms_rank1=res[1]["tp_ms"], **before)


def audited_train(argv) -> int:
    """``--audited-train STAGE ARGS``: ``train_sambert.main(ARGS)`` with every
    write under STAGE recorded into ``STAGE.writes_rankR.json`` (R: this
    rank), for (b)'s check that rank 1 writes nothing."""
    import logging

    from kantts_tpu_torch.bin import train_sambert

    stage, rest = os.path.abspath(argv[0]), argv[1:]
    writes = []

    def audit(event, args):
        if event in ("open", "os.mkdir", "os.rename", "os.replace", "os.remove"):
            path = args[0]
            if event == "open" and (not isinstance(args[1], str)
                                    or not set(args[1]) & set("wax+")):
                return
            if isinstance(path, str) and os.path.abspath(path).startswith(stage + os.sep):
                writes.append(f"{event} {os.path.relpath(path, stage)}")

    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s, %(levelname)-4s [%(filename)s:%(lineno)d] "
                               "%(message)s")
    sys.addaudithook(audit)
    train_sambert.main(rest)
    with open(f"{stage}.writes_rank{os.environ.get('RANK', '0')}.json", "w") as f:
        json.dump(writes, f)
    return 0


def interrupted_train(argv) -> int:
    """``--interrupted-train STAGE STEP ARGS``: ``train_sambert.main(ARGS)``
    with a ``KeyboardInterrupt`` raised from the trainer on every rank as
    step STEP starts, once rank 0 has saved the model state gathered there
    to ``STAGE.gathered.pt`` and the wall time of the interrupt to
    ``STAGE.interrupt_time`` ((f)). The interrupt leaves ``train_sambert``
    (its crash handler included) and this process as it leaves the CLI, so
    torchrun sees the workers fail and stops the rest when the first one
    exits."""
    import logging

    import torch

    from kantts_tpu_torch.bin import train_sambert
    from kantts_tpu_torch.parallel import tp
    from kantts_tpu_torch.train.trainer import SambertTrainer

    stage, at, rest = os.path.abspath(argv[0]), int(argv[1]), argv[2:]
    train_step = SambertTrainer.train_step

    def interrupted(self, batch):
        if self.steps == at:
            state = {k: v.cpu() for k, v in tp.gather_state_dict(self.model).items()}
            if os.environ.get("RANK", "0") == "0":
                torch.save(state, f"{stage}.gathered.pt")
                with open(f"{stage}.interrupt_time", "w") as f:
                    f.write(repr(time.time()))
            raise KeyboardInterrupt
        return train_step(self, batch)

    SambertTrainer.train_step = interrupted
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s, %(levelname)-4s [%(filename)s:%(lineno)d] "
                               "%(message)s")
    train_sambert.main(rest)
    raise AssertionError(f"train_sambert ran past step {at}")


def tp_crash_cli(tmp: str):
    """(f): F6 on the card. The tensor-parallel CLI under torchrun (two gloo
    ranks on the card, B=32 on phase 4's corpus), started now, interrupted
    on both ranks at ``TP_CRASH_STEP``, so that torchrun exits as it does
    for the interrupted CLI (not 0). -> finish(), which checks the whole
    crash checkpoint (no slice left, its bytes and seconds from the
    interrupt to its landing, loaded plain bit-equal to the state gathered
    at the interrupt), then resumes the CLI from it under
    ``tensor_parallel: 2`` for step ``TP_CRASH_STEP`` + 1. -> its results."""
    stage = os.path.join(tmp, "tp_crash")
    corpus = os.path.join(tmp, "corpus")
    env = dict(os.environ, KANTTS_DIST_BACKEND="gloo")
    torchrun = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2"]
    cfg = train_config(os.path.join(tmp, "tp_crash_model.yaml"), **TP_KEYS)
    crash_cli = Cli("tp_crash", [*torchrun, os.path.abspath(__file__), "--interrupted-train",
                                 stage, str(TP_CRASH_STEP), "--model_config", cfg,
                                 "--root_dir", corpus, "--stage_dir", stage], env=env)
    return lambda: tp_crash_checks(tmp, stage, crash_cli, torchrun, env)


def tp_crash_checks(tmp: str, stage: str, crash_cli, torchrun, env) -> dict:
    """(f)'s checks once ``crash_cli`` has ended, and the resume."""
    import torch

    from kantts_tpu_torch.models.builder import load_checkpoint

    corpus = os.path.join(tmp, "corpus")
    crash_cli.result(timeout=300, fails=True)
    crash = os.path.join(stage, "ckpt", f"checkpoint-{TP_CRASH_STEP}.ckpt")
    left = sorted(os.listdir(os.path.join(stage, "ckpt")))
    if left != [os.path.basename(crash)]:
        raise AssertionError(f"tp_crash left {left}")
    with open(f"{stage}.interrupt_time") as f:
        landed_s = os.path.getmtime(crash) - float(f.read())
    gathered = torch.load(f"{stage}.gathered.pt", weights_only=True)
    model, _ = load_checkpoint(crash, torch.device("cuda"))
    state = model.state_dict()
    bit_equal = state.keys() == gathered.keys() and all(
        torch.equal(v.cpu(), gathered[k]) for k, v in state.items())
    heads = model.text_encoder.ling_enc.fft[0].slf_attn.n_head
    del model, state
    with open(os.path.join(stage, "stdout.log")) as f:
        joined = (f"Saved crash checkpoint at step {TP_CRASH_STEP}, joined from 2 slices"
                  in f.read())
    resumed = os.path.join(tmp, "tp_resume")
    cfg = train_config(os.path.join(tmp, "tp_resume_model.yaml"), **dict(
        TP_KEYS, train_max_steps=TP_CRASH_STEP + 1, save_interval_steps=TP_CRASH_STEP + 1,
        eval_interval_steps=TP_CRASH_STEP + 1))
    resume_cli = Cli("tp_resume", [*torchrun, "-m", "kantts_tpu_torch.bin.train_sambert",
                                   "--model_config", cfg, "--root_dir", corpus,
                                   "--stage_dir", resumed, "--resume_path", crash], env=env)
    resume_cli.result(timeout=300)
    with open(os.path.join(resumed, "stdout.log")) as f:
        log_text = f.read()
    res = dict(crash_bytes=os.path.getsize(crash), landed_s=round(landed_s, 3),
               bit_equal=bit_equal, heads=heads, joined=joined,
               resumed_at=f"Resumed from {crash} at step {TP_CRASH_STEP + 1}" in log_text,
               resumed_ckpt=os.path.exists(ckpt_path(resumed, TP_CRASH_STEP + 1)),
               crash_cli_rc=crash_cli.proc.returncode, crash_cli_s=round(crash_cli.seconds, 3),
               resume_cli_s=round(resume_cli.seconds, 3))
    if not (bit_equal and joined and heads == 8 and res["resumed_at"] and res["resumed_ckpt"]):
        raise AssertionError(f"tp_crash: {res}")
    return res


def tp_cli(tmp: str):
    """(b): ``train_sambert`` under torchrun, two ranks on the card over gloo
    (``KANTTS_DIST_BACKEND``), ``tensor_parallel: 2``, 2 steps at B=32 on
    phase 4's corpus, started now. -> finish() -> its results."""
    import torch

    stage = os.path.join(tmp, "tp_cli")
    cfg = train_config(os.path.join(tmp, "tp_cli_model.yaml"), **TP_KEYS)
    cli = Cli("tp_cli", ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                         "2", os.path.abspath(__file__), "--audited-train", stage,
                         "--model_config", cfg, "--root_dir", os.path.join(tmp, "corpus"),
                         "--stage_dir", stage],
              env=dict(os.environ, KANTTS_DIST_BACKEND="gloo"))

    def finish() -> dict:
        from kantts_tpu_torch.models.builder import load_checkpoint

        cli.result(timeout=300)
        writes = [json.load(open(f"{stage}.writes_rank{r}.json")) for r in range(2)]
        with open(os.path.join(stage, "stdout.log")) as f:
            log_text = f.read()
        if writes[1] or not any("checkpoint_2.ckpt" in w for w in writes[0]):
            raise AssertionError(f"tp_cli writes: rank 0 {writes[0][:8]}, rank 1 {writes[1][:8]}")
        if "tensor parallel: 2-way over the model group" not in log_text:
            raise AssertionError("tp_cli ran without tensor parallelism")
        model, _ = load_checkpoint(ckpt_path(stage, 2), torch.device("cuda"))
        heads = model.text_encoder.ling_enc.fft[0].slf_attn.n_head
        losses = [float(ln.rsplit("=", 1)[1].strip(" .\n")) for ln in log_text.splitlines()
                  if "train/TotalLoss" in ln]
        if heads != 8 or len(losses) != 2 or not all(np.isfinite(losses)):
            raise AssertionError(f"tp_cli: heads {heads}, losses {losses}")
        return dict(seconds=round(cli.seconds, 3), losses=losses, rank0_writes=len(writes[0]))

    return finish


def phase_model_parallel(tmp: str) -> dict:
    """Phase 16: (b) and (f)'s interrupted tensor-parallel CLIs started, the
    checks of (a), (e), (c), (g) and (d) on two ranks beside them, (f)
    checked and its resume run, (b) checked, then (a), (e), (c), (g) and
    (d) timed with the card to themselves. -> K1's launches in the TP steps of (a) and
    (e), and the results."""
    t_phase = time.perf_counter()
    tp_voice_corpora(tmp)
    finish_cli, finish_crash = tp_cli(tmp), tp_crash_cli(tmp)
    res = tp_two_ranks(tmp, lambda: dict(crash=finish_crash(), cli=finish_cli()))
    seconds = time.perf_counter() - t_phase
    nested = ("cli", "crash", "voices")
    log("model_parallel", seconds=round(seconds, 3),
        **{k: (round(v, 9) if isinstance(v, float) else v) for k, v in res.items()
           if k not in nested}, **{k: json.dumps(res[k]).replace(" ", "") for k in nested})
    for voice, got in res["voices"].items():
        log("tp_voice", voice=voice, **{k: (json.dumps(v).replace(" ", "")
                                            if isinstance(v, (list, dict)) else v)
                                        for k, v in got.items()})
    failures = []
    if 0 in res["k1_launches"]:
        failures.append(f"K1 did not launch in a rank's TP steps: {res['k1_launches']}")
    for voice, got in res["voices"].items():
        mas = voice != "fp" and voice != "se_nsf"
        if got["k1_launches"] != [got["tp_steps"] if mas else 0] * 2:
            failures.append(f"{voice}: K1 launched {got['k1_launches']} times in "
                            f"{got['tp_steps']} TP steps a rank")
        if got["k1_exact"] is not (True if mas else None):
            failures.append(f"{voice}: K1 against b_mas_torch on the step's map: "
                            f"{got['k1_exact']}")
        if voice == "bf16":
            close = got["gap_over_e_ref"] <= 0.5 and got["norm_rel"] <= 1e-3
        else:
            close = got["loss_rel"] <= 1e-5 and got["norm_rel"] <= 1e-5
        if not (close and np.isfinite(got["loss"])):
            failures.append(f"{voice}: the TP step is off the one-process step")
    for name in NSF_SP:
        if not all(res[f"nsf_sp_max_abs_err_{name}_{route}"] <= 1e-6
                   for route in ("given", "broadcast")):
            failures.append(f"NSF sequence-parallel vocoding of {name} is off the "
                            "unsharded call")
    if not (res["loss_rel"] <= 1e-5 and res["grad_err_over_norm"] <= 1e-5
            and res["max_param_err"] <= 3e-4 and res["checkpoint_bit_equal"]):
        failures.append("the TP step is off the one-process step")
    if not all(res[f"sp_max_abs_err_{c}"] <= 1e-4 for c in (True, False)):
        failures.append("sequence-parallel vocoding is off the unsharded call")
    if not (res["pp_max_abs_err"] <= 1e-4 and res["pp_grad_err_over_norm"] <= 1e-5):
        failures.append("the pipelined encoder is off the sequential one")
    if failures:
        raise AssertionError("; ".join(failures))
    return dict(res, k1_launches=sum(res["k1_launches"]) + sum(
        sum(got["k1_launches"]) for got in res["voices"].values()), seconds=seconds)


# ------------------------------------------------------------------ phase 14

INT8_FRAMES = 400  # 5 s at hop 200: the B=1 shape of K2's checks and timings
INT8_CPU_FRAMES = 100  # the int8 vocoder card vs CPU, short for the CPU
SMALL_ARTIFACT = (24, 144)  # symbols, frames of the artifact run card vs CPU
EXPORT_FRAMES = 384  # the exported artifacts' budget: 128 decoder steps
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def int8_conv_shapes(gen, mel) -> list:
    """One call of the int8 generator on ``mel``, its int8 convs recorded
    in call order: -> [(module, input shape)]."""
    import torch

    from kantts_tpu_torch.models.hifigan.generator import int8_convs

    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: calls.append((mod, tuple(inp[0].shape))))
        for m in int8_convs(gen).values()]
    try:
        with torch.inference_mode():
            gen(mel)
    finally:
        for h in hooks:
            h.remove()
    return calls


def conv_geometry(mod, shape) -> dict:
    """The int8_conv1d arguments of an int8 conv module at input ``shape``."""
    k = mod.w_q.shape[2]
    if mod.transposed:
        return dict(transposed=True, stride=mod.stride, dilation=1,
                    pad_left=mod.padding, pad_right=mod.padding, causal=mod.causal,
                    C_in=shape[1], C_out=mod.w_q.shape[1], k=k, T=shape[2])
    causal = mod.pads[1] == 0 and mod.pads[0] > 0
    return dict(transposed=False, stride=mod.stride, dilation=mod.dilation,
                pad_left=mod.pads[0], pad_right=mod.pads[1], causal=causal,
                C_in=shape[1], C_out=mod.w_q.shape[0], k=k, T=shape[2])


def k2_bound(g: dict, B: int = 1) -> tuple:
    """-> (bound ms, "bytes" or "operations", ops ms, bytes ms) of one int8
    conv: the input
    read once in float32, the int8 weights and two float32 per-channel
    vectors, the float32 output written once; 2 C_in k operations an output
    (a conv) or an input (a transposed conv), at the int8 tensor-core peak."""
    from kantts_tpu_torch.ops.int8_conv import out_len

    T_out = out_len(g["T"], g["k"], g["stride"], g["dilation"], g["pad_left"],
                    g["pad_right"], g["transposed"], g["causal"])
    macs = B * g["C_in"] * g["C_out"] * g["k"] * (g["T"] if g["transposed"] else T_out)
    nbytes = (4 * B * g["C_in"] * g["T"] + g["C_out"] * g["C_in"] * g["k"]
              + 8 * g["C_out"] + 4 * B * g["C_out"] * T_out)
    ops_ms, bytes_ms = 2 * macs / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", \
        ops_ms, bytes_ms


def int_mm_call(g: dict, q, w_q):
    """The library yardstick of one int8 conv on its quantized input ``q``
    (B, C_in, T) int8: the im2col (a conv) and one ``torch._int_mm``, with
    the overlap-add of a transposed conv (kernel a multiple of its stride);
    None where ``_int_mm`` refuses the shape. The port never calls it."""
    import torch
    import torch.nn.functional as F

    B, C, T = q.shape
    k, s, d = g["k"], g["stride"], g["dilation"]
    if g["transposed"]:
        if k % s:
            return None
        a = q.permute(0, 2, 1).reshape(B * T, C).contiguous()
        w = w_q.reshape(C, g["C_out"] * k)

        def call():
            y = torch._int_mm(a, w).reshape(B, T, g["C_out"], k // s, s)
            full = torch.zeros((B, g["C_out"], (T + k // s - 1) * s), dtype=torch.int32,
                               device=q.device)
            for m in range(k // s):  # tap group m lands m frames later
                full[:, :, m * s:(m + T) * s] += y[:, :, :, m].permute(0, 2, 1, 3).reshape(
                    B, g["C_out"], T * s)
            return full
    else:
        qp = F.pad(q, (g["pad_left"], g["pad_right"]))
        T_out = (T + g["pad_left"] + g["pad_right"] - d * (k - 1) - 1) // s + 1
        w = w_q.reshape(g["C_out"], C * k).t()

        def call():
            cols = torch.stack([qp[:, :, j * d:j * d + (T_out - 1) * s + 1:s]
                                for j in range(k)], dim=2)
            return torch._int_mm(cols.permute(0, 3, 1, 2).reshape(B * T_out, C * k), w)
    try:
        call()
    except RuntimeError as e:
        return str(e).splitlines()[0][:120]
    return call


K2_BATCHES = (1, 8)  # B=1, and the service's vocoder batch (max_batch 8)


def k2_call_args(g: dict) -> tuple:
    """The geometry arguments of ``int8_conv1d`` after (x, w_p, s_w, bias,
    s_static); the plain version takes them without the kernel size."""
    return (g["k"], g["stride"], g["dilation"], g["pad_left"], g["pad_right"],
            g["transposed"], g["causal"])


def k2_distinct(gen) -> tuple:
    """The int8 convs of one call of ``gen`` at B=1 on INT8_FRAMES -> (the
    number of calls, [{"g": geometry, "mod": module, "count": calls}] of the
    distinct shapes)."""
    import torch

    mel = torch.from_numpy(np.random.RandomState(14).randn(
        1, INT8_FRAMES, 80).astype(np.float32)).cuda()
    calls = int8_conv_shapes(gen, mel)
    distinct = {}
    for mod, shape in calls:
        g = conv_geometry(mod, shape)
        distinct.setdefault(tuple(sorted(g.items())), {"g": g, "mod": mod, "count": 0})[
            "count"] += 1
    return len(calls), list(distinct.values())


def k2_int8_values(x, s_static):
    """The int8 values K2 quantizes x to, read back exactly: the int32 sums
    of K2's 1x1 conv with the identity weight are the values themselves."""
    import torch

    from kantts_tpu_torch.ops.int8_conv import int8_conv_cuda, pack_weight

    C = x.shape[1]
    eye = torch.eye(C, dtype=torch.int8, device=x.device)[:, :, None]
    ones = torch.ones(C, device=x.device)
    return int8_conv_cuda(x, pack_weight(eye, False), ones, None, s_static, 1, 1, 1, 0, 0,
                          False, False, sums=True)


def k2_exact(g: dict, x, w_q, w_p, s_w, bias, s_static=None) -> tuple:
    """Hold K2 to the plain version on x, exactly: the scales it used, its
    int8 values, its int32 sums and its float32 outputs. -> the largest
    |int32 sum| and the largest |output difference|, which is 0."""
    import torch

    from kantts_tpu_torch.ops.int8_conv import (
        int8_conv_cuda,
        int8_conv_torch,
        int8_sums_torch,
        quantize_sym,
        scales,
    )

    args = k2_call_args(g)
    s_got = torch.empty(x.shape[0], device=x.device)
    sums = int8_conv_cuda(x, w_p, s_w, bias, s_static, *args, sums=True, s_out=s_got)
    out = int8_conv_cuda(x, w_p, s_w, bias, s_static, *args)
    q_got = k2_int8_values(x, s_static)
    s_ref = scales(x, s_static)
    q_ref = quantize_sym(x, s_ref[:, None, None])
    sums_ref = int8_sums_torch(q_ref, w_q, *args[1:])
    out_ref = int8_conv_torch(x, w_q, s_w, bias, s_static, *args[1:])
    torch.cuda.synchronize()
    errs = [float((s_got != s_ref).sum()), float((q_got != q_ref.int()).sum()),
            float((sums.long() - sums_ref.long()).abs().max()),
            float((out - out_ref).abs().max())]
    if any(errs) or out.shape != out_ref.shape:
        raise AssertionError(f"K2 vs plain at {g}, B={x.shape[0]}: scales, int8 values, "
                             f"sums, outputs differ by {errs}")
    return float(sums_ref.abs().max()), errs[3]


def k2_checks(gen) -> dict:
    """(a) K2 against its plain version on the card, exact (0 on the scales,
    the int8 activations, the int32 sums and the outputs), at every
    distinct shape of the generator's int8 convs on INT8_FRAMES at B=1 and
    B=8, with the module's own packed int8 weights; each timed by CUDA
    events beside cuDNN's float32 conv on the same float32 weights and
    im2col + ``torch._int_mm`` (the GEMM alone, on the quantized input),
    and at B=1 beside the plain version. Then the edge cases: T=1, a T off
    the tile, an all-zero input, a saturated one, |acc| > 2^24, a static
    scale at B=1 and B=8, the non-causal conv and transposed conv, C_in not
    a multiple of 32, T shorter than a tile, and more output tiles than the
    cooperative grid has blocks."""
    import torch
    import torch.nn.functional as F

    from kantts_tpu_torch.models.hifigan.layers import effective_weight
    from kantts_tpu_torch.ops.int8_conv import (
        int8_conv_cuda,
        int8_conv_torch,
        pack_weight,
        quantize_sym,
        quantize_weight,
        scales,
    )

    rng = np.random.RandomState(14)
    n_calls, distinct = k2_distinct(gen)
    out_errs = []

    def exact(*args, **kw) -> float:
        acc, err = k2_exact(*args, **kw)
        out_errs.append(err)
        return acc

    shapes = {B: [] for B in K2_BATCHES}
    for B in K2_BATCHES:
        for entry in distinct:
            g, mod = entry["g"], entry["mod"]
            x = torch.from_numpy(rng.randn(B, g["C_in"], g["T"]).astype(np.float32)).cuda()
            w32 = effective_weight(mod.params).detach()
            bias = mod.params.bias.detach()
            exact(g, x, mod.w_q, mod.w_p, mod.s_w, bias)
            args = k2_call_args(g)
            lib = int_mm_call(g, quantize_sym(x, scales(x, None)[:, None, None]), mod.w_q)
            if g["transposed"]:
                def cudnn():
                    return F.conv_transpose1d(x, w32, bias, g["stride"])
            else:
                def cudnn():
                    return F.conv1d(F.pad(x, (g["pad_left"], g["pad_right"])), w32, bias,
                                    g["stride"], 0, g["dilation"])
            with torch.inference_mode():
                ms = cuda_ms(lambda: int8_conv_cuda(x, mod.w_p, mod.s_w, bias, None, *args),
                             10)
                plain_ms = (cuda_ms(lambda: int8_conv_torch(x, mod.w_q, mod.s_w, bias, None,
                                                            *args[1:]), 5)
                            if B == 1 else None)
                cudnn_ms = cuda_ms(cudnn, 10)
                library_ms = cuda_ms(lib, 10) if callable(lib) else None
            bound_ms, bound_by, ops_ms, bytes_ms = k2_bound(g, B)
            shapes[B].append({
                "conv": ("convT" if g["transposed"] else "conv")
                + f" {g['C_in']}->{g['C_out']} k{g['k']} s{g['stride']} "
                f"d{g['dilation']} T{g['T']}",
                "B": B, "count": entry["count"], "ms": ms, "plain_ms": plain_ms,
                "cudnn_f32_ms": cudnn_ms, "library_ms": library_ms,
                "library_refused": None if callable(lib) else lib,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "ops_ms": ops_ms, "bytes_ms": bytes_ms, "share_of_bound": bound_ms / ms})
            del x

    # edge cases at the widest stage's widths
    edge = {}
    g0 = dict(transposed=False, stride=1, dilation=3, pad_left=18, pad_right=0,
              causal=True, C_in=128, C_out=128, k=7, T=1)
    w = torch.from_numpy(rng.randn(128, 128, 7).astype(np.float32)).cuda()
    w_q, s_w = quantize_weight(w, False)
    w_p = pack_weight(w_q, False)
    b = torch.from_numpy(rng.randn(128).astype(np.float32)).cuda()
    for name, T, fill in (("T1", 1, None), ("T4037", 4037, None), ("zeros", 300, 0.0),
                          ("saturated", 300, "sat")):
        x = torch.from_numpy(rng.randn(2, 128, T).astype(np.float32)).cuda()
        if fill == 0.0:
            x.zero_()
        elif fill == "sat":
            x = torch.where(x >= 0, 1e3, -1e3).float()
        edge[name] = exact(dict(g0, T=T), x, w_q, w_p, s_w, b)
    big = dict(g0, C_in=256, k=7, dilation=1, pad_left=6, T=50)
    wb = torch.ones((128, 256, 7), device="cuda")
    wb[:, 100, 3] = 126.0 / 127.0
    wb_q, wb_s = quantize_weight(wb, False)
    xb = torch.ones((1, 256, 50), device="cuda")
    edge["acc_over_2^24"] = exact(big, xb, wb_q, pack_weight(wb_q, False), wb_s, None)
    if not edge["acc_over_2^24"] > 2 ** 24:
        raise AssertionError(f"the |acc| case reached {edge['acc_over_2^24']}")
    s_static = torch.tensor(0.01, device="cuda")
    for B in K2_BATCHES:
        edge[f"static_scale_B{B}"] = exact(dict(g0, T=500), torch.from_numpy(
            rng.randn(B, 128, 500).astype(np.float32)).cuda(), w_q, w_p, s_w, b,
            s_static=s_static)
    same = dict(g0, causal=False, pad_left=9, pad_right=9, T=333)
    edge["same_padded"] = exact(same, torch.from_numpy(
        rng.randn(1, 128, 333).astype(np.float32)).cuda(), w_q, w_p, s_w, b)
    wt = torch.from_numpy(rng.randn(64, 32, 10).astype(np.float32)).cuda()
    wt_q, wt_s = quantize_weight(wt, True)
    for causal in (True, False):
        gt = dict(transposed=True, stride=5, dilation=1, pad_left=2, pad_right=2,
                  causal=causal, C_in=64, C_out=32, k=10, T=77)
        edge[f"transposed_causal_{causal}"] = exact(gt, torch.from_numpy(
            rng.randn(2, 64, 77).astype(np.float32)).cuda(), wt_q,
            pack_weight(wt_q, True, 5), wt_s, None)
    # C_in off 32: a conv 20 -> 24 and a transposed conv 36 -> 20, k=7 s=3
    w20 = torch.from_numpy(rng.randn(24, 20, 5).astype(np.float32)).cuda()
    w20_q, w20_s = quantize_weight(w20, False)
    edge["C_in20"] = exact(dict(g0, C_in=20, C_out=24, k=5, dilation=2, pad_left=8,
                                   T=333), torch.from_numpy(rng.randn(3, 20, 333).astype(
                                       np.float32)).cuda(), w20_q,
                              pack_weight(w20_q, False), w20_s, None)
    w36 = torch.from_numpy(rng.randn(36, 20, 7).astype(np.float32)).cuda()
    w36_q, w36_s = quantize_weight(w36, True)
    edge["C_in36_transposed_k7_s3"] = exact(
        dict(transposed=True, stride=3, dilation=1, pad_left=2, pad_right=2, causal=False,
             C_in=36, C_out=20, k=7, T=50),
        torch.from_numpy(rng.randn(2, 36, 50).astype(np.float32)).cuda(), w36_q,
        pack_weight(w36_q, True, 3), w36_s, None)
    # the 16-channel stage: T shorter than one tile (256 positions), and at
    # B=8 on 80000 samples more tiles than the grid has blocks
    w16 = torch.from_numpy(rng.randn(16, 16, 11).astype(np.float32)).cuda()
    w16_q, w16_s = quantize_weight(w16, False)
    w16_p = pack_weight(w16_q, False)
    g16 = dict(g0, C_in=16, C_out=16, k=11, dilation=5, pad_left=50)
    edge["T100_one_short_tile"] = exact(dict(g16, T=100), torch.from_numpy(
        rng.randn(2, 16, 100).astype(np.float32)).cuda(), w16_q, w16_p, w16_s, b[:16])
    x16 = torch.from_numpy(rng.randn(8, 16, 80000).astype(np.float32)).cuda()
    edge["tiles_over_grid"] = exact(dict(g16, T=80000), x16, w16_q, w16_p, w16_s,
                                       b[:16])
    grid = [v[1] for k, v in int8_conv_cuda._plans.items()
            if k[1:4] == (16, 16, 11) and k[5] == 5][0]
    edge["tiles_over_grid_tiles_per_block"] = 8 * -(-80000 // 256) / grid
    if not edge["tiles_over_grid_tiles_per_block"] > 1:
        raise AssertionError(f"the tiles-over-grid case has {grid} blocks")
    return {"calls": n_calls, "shapes": shapes, "edge_max_abs_acc": edge,
            "max_abs_err": max(out_errs)}


def k2_sums(rows: list) -> dict:
    """Per-call sums (each shape times its convs a call) of a batch's rows."""
    keys = ("ms", "plain_ms", "bound_ms", "cudnn_f32_ms", "library_ms", "ops_ms",
            "bytes_ms")
    res = {key: (sum(r[key] * r["count"] for r in rows)
                 if all(r[key] is not None for r in rows) else None) for key in keys}
    res["bound_by"] = "operations" if res["ops_ms"] >= res["bytes_ms"] else "bytes"
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    return res


def k2_profile(gen, mel) -> dict:
    """One int8 vocoder call under torch.profiler: K2's device launches (one
    kernel a conv, and no other K2 kernel: no amax, no quantize) and their
    device ms, beside the call's wall ms by CUDA events. A window whose
    records the profiler lost is profiled again (``kernel_ms``)."""
    import torch

    with torch.inference_mode():
        wall = cuda_ms(lambda: gen(mel), 5)
        seen = []
        for _ in range(PROFILE_WINDOWS):
            durs = profile_window(lambda: gen(mel), ("i8_",), 1)
            n = sum(len(d) for d in durs.values())
            if n == 104:
                break
            seen.append(n)
            log("profiler_drop", kernels="i8_", calls=1, seen=n)
        else:
            raise AssertionError(f"profiler saw {seen} K2 launches in a call")
    others = [name for name in durs if "i8_conv_kernel" not in name]
    if others:
        raise AssertionError(f"K2 kernels other than the conv in a call: {others}")
    return {"device_launches": n, "device_ms": sum(sum(d) for d in durs.values()) / 1e3,
            "wall_ms": wall, "kernels": sorted(durs)}


def k2_records_here(gen, mel) -> dict:
    """One int8 vocoder call under torch.profiler in this process, logged
    and not checked: by phase 14 the smoke's own process has given windows
    short of K2's 104 records (78-84 in a first window, 83 in each of four),
    where a fresh process's hold them all (``trace_kernels`` checks them
    there). -> K2's kernel records, the cooperative launch calls the
    runtime recorded, and the start of the first of each, in us from the
    window's origin: a first record well after the first launch says the
    window lost its first kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        gen(mel)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and "i8_" in e.name]
    calls = [e for e in events if e.device_type == DeviceType.CPU
             and "LaunchCooperativeKernel" in e.name]
    return {"records": len(kernels), "launch_calls": len(calls),
            "first_record_us": min((e.time_range.start for e in kernels), default=None),
            "first_launch_us": min((e.time_range.start for e in calls), default=None)}


def int8_vocoder(voc_ckpt: str) -> dict:
    """(b) The int8 vocoder at B=1 on INT8_FRAMES against float32: SNR,
    ms of both by CUDA events in turns, K2's launches a call, and one call
    under torch.profiler, logged only (``k2_records_here``); both at B=8 (the service's
    vocoder batch) by CUDA events in turns; B=4 batch
    invariance and static calibrated chunked-8 against plain static, bit
    for bit with cuDNN's float32 edge convs, as the port runs them
    (PyTorch's own CUDA conv sums an output in an order that depends on
    the shape: its gaps are reported beside); the card against the CPU on
    INT8_CPU_FRAMES within e_q (card) + the float32 gap + e_q (CPU), e_q =
    max |int8 - f32| on a device."""
    import torch

    from kantts_tpu_torch.bin.infer_hifigan import load_vocoder
    from kantts_tpu_torch.infer.chunked import chunked_apply
    from kantts_tpu_torch.models.hifigan.generator import (
        Generator,
        calibrate_quant_scales,
    )
    from kantts_tpu_torch.models.hifigan.layers import quantize_weights
    from kantts_tpu_torch.ops.int8_conv import int8_conv_cuda

    dev = torch.device("cuda")
    gen32, cfg = load_vocoder(voc_ckpt, dev)
    gen8, _ = load_vocoder(voc_ckpt, dev, quant=True)
    rng = np.random.RandomState(15)
    mels = torch.from_numpy(rng.randn(4, INT8_FRAMES, 80).astype(np.float32)).cuda()
    mels[1:] *= torch.tensor([3.0, 0.3, 10.0], device=dev)[:, None, None]
    mel = mels[:1]
    res = {}
    with torch.inference_mode():
        int8_conv_cuda.launches = 0
        y8 = gen8(mel)
        torch.cuda.synchronize()
        res["k2_launches_per_call"] = int8_conv_cuda.launches
        y32 = gen32(mel)
        res["snr_db"] = float(10 * torch.log10((y32 ** 2).sum() / ((y8 - y32) ** 2).sum()))
        res["max_abs_int8_vs_f32"] = float((y8 - y32).abs().max())
        times = collections.defaultdict(list)
        runs = {"f32": lambda: gen32(mel), "int8": lambda: gen8(mel)}
        for name in ("f32", "int8", "int8", "f32"):
            times[name].append(cuda_ms(runs[name], 10))
        res.update({f"{k}_ms": float(np.mean(v)) for k, v in times.items()})
        mels8 = torch.from_numpy(rng.randn(8, INT8_FRAMES, 80).astype(np.float32)).cuda()
        runs8 = {"f32": lambda: gen32(mels8), "int8": lambda: gen8(mels8)}
        times8 = collections.defaultdict(list)
        for name in ("f32", "int8", "int8", "f32"):
            times8[name].append(cuda_ms(runs8[name], 5))
        res.update({f"{k}_b8_ms": float(np.mean(v)) for k, v in times8.items()})
        del mels8
    res["k2_profile_in_process"] = k2_records_here(gen8, mel)
    with torch.inference_mode():
        res["batch4_gap"] = float((gen8(mels)[:1] - y8).abs().max())
        with torch.backends.cudnn.flags(enabled=False):
            alone = gen8(mel)
            res["native_conv_batch4_gap"] = float((gen8(mels)[:1] - alone).abs().max())

        static = Generator(**cfg["Model"]["Generator"]["params"], quant=True,
                           quant_static=True).to(dev).eval()
        missing, unexpected = static.load_state_dict(gen32.state_dict(), strict=False)
        if unexpected or not all(k.endswith(".s_x") for k in missing):
            raise AssertionError(f"static generator: {missing} {unexpected}")
        quantize_weights(static)
        calibrate_quant_scales(static, [mel])
        res["static_chunked8_gap"] = float(
            (chunked_apply(static, mel, 8) - static(mel)).abs().max())
        with torch.backends.cudnn.flags(enabled=False):
            res["native_conv_static_chunked8_gap"] = float(
                (chunked_apply(static, mel, 8) - static(mel)).abs().max())
    if res["k2_launches_per_call"] != 104:
        raise AssertionError(f"K2 launched {res['k2_launches_per_call']} times a call")
    if res["batch4_gap"] or res["static_chunked8_gap"]:
        raise AssertionError(f"int8 exactness: {res}")
    if not res["snr_db"] > 20:
        raise AssertionError(f"int8 vocoder SNR {res['snr_db']} dB")

    # card vs CPU: one rounding flip of an activation (from the float32
    # edge convs' different sums) re-quantizes what follows it, so two int8
    # runs differ by up to their quantization errors: the bound is the
    # triangle e_q (card) + float32 gap + e_q (CPU)
    cpu = torch.device("cpu")
    gen8_cpu, _ = load_vocoder(voc_ckpt, cpu, quant=True)
    gen32_cpu, _ = load_vocoder(voc_ckpt, cpu)
    short = mel[:, :INT8_CPU_FRAMES].cpu()
    with torch.inference_mode():
        y8_cpu, y32_cpu = gen8_cpu(short), gen32_cpu(short)
        y8_card, y32_card = gen8(short.cuda()).cpu(), gen32(short.cuda()).cpu()
    gap = {"int8": float((y8_card - y8_cpu).abs().max()),
           "f32": float((y32_card - y32_cpu).abs().max()),
           "e_q_cpu": float((y8_cpu - y32_cpu).abs().max()),
           "e_q_card": float((y8_card - y32_card).abs().max())}
    res.update({f"card_vs_cpu_{k}": v for k, v in gap.items()})
    bound = gap["e_q_card"] + gap["f32"] + gap["e_q_cpu"]
    if not gap["int8"] <= bound:
        raise AssertionError(f"int8 vocoder card vs CPU {gap['int8']} > {bound}")
    return res


def int8_clis(tmp: str, am_ckpt: str, voc_ckpt: str) -> dict:
    """(c) ``infer_hifigan --int8`` and ``serve_tts --int8`` through their
    CLIs with no --device (run under ``CLI_F32``), each held to this
    process's int8 path within 1 PCM16 step."""
    import torch
    from scipy.io import wavfile

    from kantts_tpu_torch.bin.infer_hifigan import hifigan_infer
    from kantts_tpu_torch.ops.int8_conv import int8_conv_cuda
    from kantts_tpu_torch.serve import TTSService, wav_bytes

    mel_dir = os.path.join(tmp, "int8_mels")
    os.makedirs(mel_dir)
    rng = np.random.RandomState(16)
    for name, T in (("a", 400), ("b", 250)):
        np.save(os.path.join(mel_dir, f"{name}.npy"), rng.randn(T, 80).astype(np.float32))
    # the CLI runs while this process makes its reference
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", CLI_F32, "kantts_tpu_torch.bin.infer_hifigan", "--ckpt",
         voc_ckpt, "--input_mel", mel_dir, "--output_dir", os.path.join(tmp, "int8_cli"),
         "--int8"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, NVIDIA_TF32_OVERRIDE="0"))
    int8_conv_cuda.launches = 0
    hifigan_infer(mel_dir, voc_ckpt, os.path.join(tmp, "int8_here"), device="cuda",
                  int8=True)
    launches = {"infer_hifigan": int8_conv_cuda.launches}

    service = TTSService.from_checkpoints(am_ckpt, voc_ckpt, int8=True, max_batch=1,
                                          device="cuda")
    try:
        int8_conv_cuda.launches = 0
        sr, wav = service.synthesize(TEXTS[3])
        launches["service"] = int8_conv_cuda.launches
        try:
            next(iter(service.stream(TEXTS[3])))
            raise AssertionError("stream served int8")
        except ValueError as e:
            if "int8" not in str(e):
                raise
    finally:
        service.close()
    expect = np.frombuffer(wav_bytes(wav, sr)[44:], dtype="<i2")
    cli = serve_subprocess(am_ckpt, voc_ckpt, expect, ["--int8", "--max_batch", "1"],
                           f32_flags=True)
    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"infer_hifigan --int8 exited {proc.returncode}:\n{err[-4000:]}")
    cli_s = time.perf_counter() - t0
    steps = max(pcm_steps(wavfile.read(os.path.join(tmp, "int8_cli", f"{n}.wav"))[1],
                          wavfile.read(os.path.join(tmp, "int8_here", f"{n}.wav"))[1])
                for n in ("a", "b"))
    if steps > 1:
        raise AssertionError(f"infer_hifigan --int8 CLI: {steps} PCM steps")
    if not all(launches.values()):
        raise AssertionError(f"int8 paths without K2: {launches}")
    return {"infer_hifigan_cli_s_while_serving": cli_s, "infer_hifigan_pcm_steps": steps,
            "serve_tts": cli, "k2_launches": launches}


def export_cli(am_ckpt: str, voc_ckpt: str, out: str, *args) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "kantts_tpu_torch.bin.export_tts", "export",
         "--am_ckpt", am_ckpt, "--voc_ckpt", voc_ckpt, "--output_dir", out, *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


SYNTH_BLOCKED = """
import os, sys
import numpy as np
for name in ("jax", "kantts_tpu", "kantts_tpu_torch.models"):
    sys.modules[name] = None
import kantts_tpu_torch.utils.audio as audio
from kantts_tpu_torch.bin import export_tts
out = {}
save = audio.save_wav

def capture(wav, path, sr):
    out[os.path.basename(path)[:-4]] = np.array(wav)
    save(wav, path, sr)

audio.save_wav = capture
export_tts.main(["synth", "--artifact", sys.argv[1], "--symbols_file", sys.argv[2],
                 "--output_dir", sys.argv[3]])
np.savez(os.path.join(sys.argv[3], "floats.npz"), **out)
assert not any(sys.modules.get(m) for m in sys.modules
               if m.startswith("kantts_tpu_torch.models"))
"""


def whole_program_export(am_ckpt: str, voc_ckpt: str) -> dict:
    """torch.export of the whole fused program at full width and a small
    budget (4 symbols; 3 and 6 frames, 1 and 2 decoder steps): node counts
    and seconds, and the growth a decoder step."""
    import torch

    from kantts_tpu_torch.bin.infer_hifigan import load_vocoder
    from kantts_tpu_torch.bin.infer_sambert import load_am
    from kantts_tpu_torch.models.sambert.sambert import sambert_infer

    dev = torch.device("cuda")
    am, _ = load_am(am_ckpt, dev)
    gen, _ = load_vocoder(voc_ckpt, dev)
    L = 4
    args = (torch.zeros((1, L, 4), dtype=torch.long, device=dev),
            torch.zeros((1, L), dtype=torch.long, device=dev),
            torch.zeros((1, L), dtype=torch.long, device=dev),
            torch.full((1,), L, dtype=torch.int32, device=dev))
    class Fused(torch.nn.Module):
        def __init__(self, budget):
            super().__init__()
            self.am, self.gen, self.budget = am, gen, budget

        def forward(self, ling, emo, spk, lengths):
            mel = sambert_infer(self.am, ling, emo, spk, lengths, self.budget)
            return self.gen(mel["postnet_outputs"])

    res = {}
    for budget in (3, 6):
        t0 = time.perf_counter()
        with torch.no_grad(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            program = torch.export.export(Fused(budget), args)
        res[budget] = {"nodes": len(program.graph.nodes),
                       "seconds": time.perf_counter() - t0}
    res["nodes_per_decoder_step"] = res[6]["nodes"] - res[3]["nodes"]
    return res


def exported_artifacts(tmp: str, am_ckpt: str, voc_ckpt: str) -> dict:
    """(d) ``export_tts export`` at the CLI's 96 symbols and EXPORT_FRAMES
    (its 2304-frame default cut to a sixth: the artifact and ``fused_infer``
    decode the whole budget, whatever the utterance, so each run below
    takes a sixth of the time), float32 and --int8, two subprocesses at
    once with no --device:
    seconds and bytes; meanwhile, in this process, the whole-program
    export's size and a small artifact (24 symbols, 144 frames) card vs
    CPU. (e) ``export_tts synth`` in a subprocess that cannot import
    ``kantts_tpu_torch.models``, beside this process's runs: ``ExportedTTS``
    on the card held to ``fused_infer`` within 1e-5 (float32 and int8), its
    first call and a warm utterance beside a warm ``fused_infer``."""
    import torch

    from kantts_tpu_torch.bin.infer_hifigan import load_vocoder
    from kantts_tpu_torch.bin.infer_sambert import load_am
    from kantts_tpu_torch.infer.e2e import fused_infer
    from kantts_tpu_torch.infer.exported import ExportedTTS, export_fused_tts
    from kantts_tpu_torch.infer.symbols import encode_symbol_inputs
    from kantts_tpu_torch.ops.int8_conv import int8_conv_cuda
    from kantts_tpu_torch.serve.service import resolve_frontend

    arts = {"f32": os.path.join(tmp, "art_f32"), "int8": os.path.join(tmp, "art_int8")}
    t0 = time.perf_counter()
    budget = ("--max_output_len", str(EXPORT_FRAMES))
    procs = {"f32": export_cli(am_ckpt, voc_ckpt, arts["f32"], *budget),
             "int8": export_cli(am_ckpt, voc_ckpt, arts["int8"], "--int8", *budget)}
    res = {"whole_program": whole_program_export(am_ckpt, voc_ckpt)}

    # card vs CPU on a small artifact, so that the CPU run stays short
    small = os.path.join(tmp, "art_small")
    export_fused_tts(am_ckpt, voc_ckpt, small, *SMALL_ARTIFACT, device="cuda")
    short = resolve_frontend("pinyin").text_to_symbols([TEXTS[3]])[0][0]
    card = ExportedTTS(small).synthesize(short)
    cpu = ExportedTTS(small, device="cpu").synthesize(short)
    res["small_card_vs_cpu"] = {"frames": [card[1], cpu[1]],
                                "max_abs": float(np.abs(card[0] - cpu[0]).max())}
    if card[1] != cpu[1] or res["small_card_vs_cpu"]["max_abs"] > 1e-3:
        raise AssertionError(f"small artifact card vs CPU: {res['small_card_vs_cpu']}")

    res["export"] = {}
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"export_tts export ({name}) exited {proc.returncode}:\n"
                               f"{out[-4000:]}")
        with open(os.path.join(arts[name], "meta.json")) as f:
            meta = json.load(f)
        if (meta["max_output_len"], meta["max_input_len"], meta["int8"]) != (
                EXPORT_FRAMES, 96, name == "int8"):
            raise AssertionError(f"artifact {name}: {meta}")
        res["export"][name] = {
            "wall_s_beside_the_other_work": time.perf_counter() - t0,
            "trace_s": sum(v["seconds"] for v in meta["export"].values()),
            "nodes": {k: v["nodes"] for k, v in meta["export"].items()},
            "parameters": sum(v["parameters"] for v in meta["export"].values()),
            "bytes": dir_bytes(arts[name])}

    seq = resolve_frontend("pinyin").text_to_symbols([TEXTS[0]])[0][0]
    sym_file = os.path.join(tmp, "export_symbols.txt")
    with open(sym_file, "w", encoding="utf-8") as f:
        f.write(f"u0\t{seq}\n")
    # the synth CLI runs beside this process's artifact and fused_infer runs
    t0 = time.perf_counter()
    synth_dir = os.path.join(tmp, "export_synth")
    synth = subprocess.Popen([sys.executable, "-c", SYNTH_BLOCKED, arts["f32"], sym_file,
                              synth_dir], cwd=ROOT, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True,
                             env=dict(os.environ, NVIDIA_TF32_OVERRIDE="0"))

    dev = torch.device("cuda")
    am, ling_unit = load_am(am_ckpt, dev)
    ling, emo, spk, lengths = (torch.from_numpy(a).to(dev) for a in
                               encode_symbol_inputs(ling_unit, seq, 96))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    wavs, errs, ms = {}, {}, {}
    for name in ("f32", "int8"):
        gen = load_vocoder(voc_ckpt, dev, quant=name == "int8")[0]
        t0 = time.perf_counter()
        tts = ExportedTTS(arts[name])
        res[f"load_{name}_s"] = time.perf_counter() - t0
        int8_conv_cuda.launches = 0
        (wav, n), ms[f"{name}_artifact_first_ms"] = timed(lambda: tts.synthesize(seq))
        if name == "f32":
            (wav, n), ms["f32_artifact_warm_ms"] = timed(lambda: tts.synthesize(seq))
        (live, n_live), ms[f"{name}_fused_infer_ms"] = timed(
            lambda: fused_infer(am, gen, ling.long(), emo.long(), spk.long(), lengths,
                                EXPORT_FRAMES))
        if name == "int8":
            res["k2_launches"] = int8_conv_cuda.launches
        if int(n_live[0]) != n:
            raise AssertionError(f"artifact {n} frames, fused_infer {n_live}")
        wavs[name] = wav
        errs[f"{name}_vs_fused_infer"] = float(np.abs(
            wav - live[0, :n * tts.meta["hop_total"], 0].cpu().numpy()).max())
        del tts, gen
    _, err = synth.communicate(timeout=600)
    if synth.returncode != 0:
        raise RuntimeError(f"export_tts synth exited {synth.returncode}:\n{err[-4000:]}")
    res["synth_cli_s_beside_the_other_work"] = time.perf_counter() - t0
    cli_wav = np.load(os.path.join(synth_dir, "floats.npz"))["u0"]
    errs["synth_cli_vs_here"] = float(np.abs(cli_wav - wavs["f32"]).max())
    res.update(max_abs=errs, ms=ms, frames=n, int8_vs_f32_rel=float(
        np.linalg.norm(wavs["int8"] - wavs["f32"]) / np.linalg.norm(wavs["f32"])))
    if max(errs.values()) > 1e-5 or not res["int8_vs_f32_rel"] < 0.05:
        raise AssertionError(f"artifact on the card: {errs}, int8 rel "
                             f"{res['int8_vs_f32_rel']}")
    return res


def phase_int8_export(tmp: str, am_ckpt: str, voc_ckpt: str) -> dict:
    """Phase 14: int8 vocoding on K2 and the serving artifact, at the full
    width of hifigan_v1_16k and sambert_16k_MAS (phase 6's seeded
    checkpoints): (a) ``k2_checks``, (b) ``int8_vocoder``, (c) ``int8_clis``,
    (d) and (e) ``exported_artifacts``. K2's launches are counted over (b)'s
    int8 vocoder call and (e)'s int8 artifact and int8 ``fused_infer`` runs;
    K1 must not launch."""
    import torch

    from kantts_tpu_torch.bin.infer_hifigan import load_vocoder
    from kantts_tpu_torch.ops.int8_conv import int8_conv_cuda
    from kantts_tpu_torch.ops.mas import b_mas_cuda

    t_phase = time.perf_counter()
    b_mas_cuda.launches = 0
    gen8, _ = load_vocoder(voc_ckpt, torch.device("cuda"), quant=True)
    checks = k2_checks(gen8)
    per_call = {}
    for B, rows in checks["shapes"].items():
        for shape in rows:
            log("k2_shape", **{k: (round(v, 5) if isinstance(v, float) else v)
                               for k, v in shape.items()})
        per_call[B] = k2_sums(rows)
        log("k2_per_call", B=B, **{k: (round(v, 5) if isinstance(v, float) else v)
                                   for k, v in per_call[B].items()})
    log("k2_edge", calls=checks["calls"], **checks["edge_max_abs_acc"])
    del gen8
    t = time.perf_counter()
    voc = int8_vocoder(voc_ckpt)
    log("int8_vocoder", seconds=round(time.perf_counter() - t, 3), **voc)
    t = time.perf_counter()
    clis = int8_clis(tmp, am_ckpt, voc_ckpt)
    log("int8_clis", seconds=round(time.perf_counter() - t, 3),
        infer_hifigan_pcm_steps=clis["infer_hifigan_pcm_steps"],
        infer_hifigan_cli_s_while_serving=round(clis["infer_hifigan_cli_s_while_serving"], 3),
        **{f"serve_{k}": (round(v, 3) if isinstance(v, float) else v)
           for k, v in clis["serve_tts"].items()})
    t = time.perf_counter()
    art = exported_artifacts(tmp, am_ckpt, voc_ckpt)
    log("export", seconds=round(time.perf_counter() - t, 3),
        **{k: json.dumps(v) if isinstance(v, dict) else v for k, v in art.items()})
    if b_mas_cuda.launches:
        raise AssertionError(f"K1 launched {b_mas_cuda.launches} times in phase 14")
    seconds = time.perf_counter() - t_phase
    log("int8_export", seconds=round(seconds, 3))
    return {"k2": checks, "vocoder": voc, "clis": clis, "export": art,
            "seconds": seconds, "per_call": per_call,
            "launches_by_path": {"int8_vocoder": voc["k2_launches_per_call"],
                                 **clis["k2_launches"],
                                 "int8_artifact_and_fused_infer": art["k2_launches"]},
            "distinct_shapes": len(checks["shapes"][1])}


def old_k2(src: str):
    """Build an earlier K2 source with the same nvcc flags; it has the first
    K2's C interface (a quantize call of one or two launches into a padded
    channels-last int8 buffer, then a conv launch, from w_q). -> a callable
    with that wrapper's work around the launches."""
    import ctypes

    import torch

    from kantts_tpu_torch.ops.int8_conv import out_len
    from kantts_tpu_torch.ops.nvcc import BUILD_DIR, NVCC_FLAGS, find_nvcc

    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, "libkantts_int8_conv_before.so")
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kantts_i8_quantize_act.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.kantts_i8_quantize_act.restype = i
    lib.kantts_i8_conv.argtypes = [p] * 6 + [i] * 12 + [p]
    lib.kantts_i8_conv.restype = i
    lib.kantts_i8_partials.argtypes = [ctypes.c_longlong]
    lib.kantts_i8_partials.restype = i

    def call(x, w_q, s_w, bias, s_static, k, stride, dilation, pad_left, pad_right,
             transposed, causal):
        B, C, T = x.shape
        pads = (0, 0) if transposed else (pad_left, pad_right)
        Cp = -(-C // 4) * 4
        Tp = T + pads[0] + pads[1]
        stream = torch.cuda.current_stream().cuda_stream
        q = torch.empty((B, Tp, Cp), dtype=torch.int8, device=x.device)
        s_x = torch.empty(B, dtype=torch.float32, device=x.device)
        partial = (torch.empty(B * lib.kantts_i8_partials(C * T), device=x.device)
                   if s_static is None else None)
        err = lib.kantts_i8_quantize_act(
            x.data_ptr(), None if partial is None else partial.data_ptr(),
            None if s_static is None else s_static.data_ptr(), s_x.data_ptr(),
            q.data_ptr(), B, C, T, Cp, pads[0], pads[1], stream)
        C_out = w_q.shape[1] if transposed else w_q.shape[0]
        T_out = out_len(T, k, stride, dilation, pad_left, pad_right, transposed, causal)
        out = torch.empty((B, C_out, T_out), device=x.device)
        err = err or lib.kantts_i8_conv(
            q.data_ptr(), w_q.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), 0, B, C, Cp, Tp,
            C_out, k, T_out, stride, dilation, int(transposed),
            (0 if causal else pad_left) if transposed else 0, stream)
        if err != 0:
            raise RuntimeError(f"earlier K2 launch failed: cudaError {err}")
        return out

    return call


def phase_k2_before(src: str) -> dict:
    """The earlier K2 (``src``) and this one on the 56 distinct int8 conv
    shapes of a seeded hifigan_v1_16k at B=1 and B=8 on INT8_FRAMES, each
    output held equal, then ms per call by CUDA events in the order earlier,
    this, this, earlier; -> the sums over the 104 convs of a vocoder call,
    with the library call (im2col + ``torch._int_mm``) and the bound."""
    import torch

    from kantts_tpu_torch.bin.infer_hifigan import load_vocoder
    from kantts_tpu_torch.configs import get_config
    from kantts_tpu_torch.models.builder import model_builder, save_checkpoint
    from kantts_tpu_torch.ops.int8_conv import int8_conv_cuda, quantize_sym, scales

    before = old_k2(src)
    with tempfile.TemporaryDirectory(prefix="kantts_smoke_") as tmp:
        cfg = get_config("hifigan_v1_16k")
        path = os.path.join(tmp, "voc.pt")
        save_checkpoint(path, model_builder(cfg, seed=2), cfg)
        gen8, _ = load_vocoder(path, torch.device("cuda"), quant=True)
    _, distinct = k2_distinct(gen8)
    rng = np.random.RandomState(17)
    res = {}
    for B in K2_BATCHES:
        sums = collections.defaultdict(float)
        for entry in distinct:
            g, mod = entry["g"], entry["mod"]
            x = torch.from_numpy(rng.randn(B, g["C_in"], g["T"]).astype(np.float32)).cuda()
            bias = mod.params.bias.detach()
            args = k2_call_args(g)
            runs = {"before": lambda: before(x, mod.w_q, mod.s_w, bias, None, *args),
                    "after": lambda: int8_conv_cuda(x, mod.w_p, mod.s_w, bias, None,
                                                    *args)}
            with torch.inference_mode():
                if not torch.equal(runs["before"](), runs["after"]()):
                    raise AssertionError(f"the earlier K2 and this one differ at {g}, B={B}")
                times = collections.defaultdict(list)
                for who in ("before", "after", "after", "before"):
                    times[who].append(cuda_ms(runs[who], 10))
                lib = int_mm_call(g, quantize_sym(x, scales(x, None)[:, None, None]),
                                  mod.w_q)
                library_ms = cuda_ms(lib, 10) if callable(lib) else None
            n = entry["count"]
            for who, v in times.items():
                sums[f"{who}_ms"] += n * float(np.mean(v))
                sums[f"{who}_ms_first"] += n * v[0]
                sums[f"{who}_ms_second"] += n * v[1]
            sums["library_ms"] += n * library_ms if library_ms is not None else float("nan")
            sums["bound_ms"] += n * k2_bound(g, B)[0]
            del x
        sums = dict(sums)
        sums["speedup"] = sums["before_ms"] / sums["after_ms"]
        log("k2_before_after", B=B, **{k: round(v, 5) for k, v in sums.items()})
        res[B] = sums
    return res


def main(argv) -> int:
    if argv[:1] == ["--ddp-worker"]:
        return ddp_worker(int(argv[1]), int(argv[2]), argv[3])
    if argv[:1] == ["--tp-worker"]:
        return tp_worker(int(argv[1]), int(argv[2]), argv[3])
    if argv[:1] == ["--audited-train"]:
        return audited_train(argv[1:])
    if argv[:1] == ["--interrupted-train"]:
        return interrupted_train(argv[1:])
    smi = phase_device()
    phase_build()
    if argv[:1] == ["--k1-before"]:
        print(json.dumps({"k1_before_after": phase_k1_before(argv[1])}))
        print(smi)
        return 0
    if argv[:1] == ["--k2-before"]:
        print(json.dumps({"k2_before_after": phase_k2_before(argv[1])}))
        print(smi)
        return 0
    if argv[:1] == ["--profiler-drops"]:
        print(json.dumps({"profiler_drops": phase_profiler_drops(int(argv[1]))}))
        print(smi)
        return 0
    if argv[:1] == ["--trace-kernels"]:
        from kantts_tpu_torch.ops.mas import b_mas_cuda

        res = trace_kernels(os.path.dirname(argv[1]), argv[2], argv[3])
        with open(argv[1], "w") as f:
            json.dump(dict(res, k1_launches=b_mas_cuda.launches), f)
        return 0
    if argv[:1] == ["--tools"]:
        with tempfile.TemporaryDirectory(prefix="kantts_smoke_") as tmp, \
                contextlib.ExitStack() as stack:
            stack.callback(Cli.stop_all)
            trainer, checked = tools_trainer(tmp)
            res = phase_tools(tmp, trainer, checked)
            res["trace"] = start_tracer(tmp, ckpt_path(*checked["train_hifigan"]))()
        print(json.dumps({"tools": res}))
        print(smi)
        return 0
    if argv[:1] == ["--model-parallel"]:
        from kantts_tpu_torch.utils.corpus import write_mas_corpus

        with tempfile.TemporaryDirectory(prefix="kantts_smoke_") as tmp, \
                contextlib.ExitStack() as stack:
            stack.callback(Cli.stop_all)
            write_mas_corpus(os.path.join(tmp, "corpus"), 72, (60, 90), (400, 570), seed=0)
            res = phase_model_parallel(tmp)
        print(json.dumps({"model_parallel": res}))
        print(smi)
        return 0
    if argv[:1] == ["--int8-export"]:
        with tempfile.TemporaryDirectory(prefix="kantts_smoke_") as tmp:
            res = phase_int8_export(tmp, *seeded_checkpoints(tmp))
        print(json.dumps({"int8_export": {k: res[k] for k in (
            "per_call", "launches_by_path", "seconds")},
            "k2_profile_in_process": res["vocoder"]["k2_profile_in_process"],
            "max_abs_err": res["k2"]["max_abs_err"]}))
        print(smi)
        return 0
    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 3)
        log("phase_seconds", name=name, seconds=seconds[name])
        return out

    k1 = phase("2_k1", phase_k1)
    fwd_launches, k1["mas_forward"] = phase("3_mas_forward", phase_mas_forward)
    with tempfile.TemporaryDirectory(prefix="kantts_smoke_") as tmp, \
            contextlib.ExitStack() as stack:
        stack.callback(Cli.stop_all)
        trainer, train_launches = phase("4_train", phase_train, tmp)
        k1_step_ms = phase("4_train_step", phase_train_step, trainer)
        phase("4_train_card_vs_cpu", phase_train_card_vs_cpu, trainer)
        del trainer
        voc_trainer = phase("5_voc_train", phase_voc_train, tmp)
        phase("5_gan_step", phase_gan_step, voc_trainer)
        phase("5_gan_card_vs_cpu", phase_gan_card_vs_cpu, voc_trainer)
        tools = phase("15_tools", phase_tools, tmp, voc_trainer, {
            "train_hifigan": (os.path.join(tmp, "voc_train"), GAN_KEYS["train_max_steps"]),
            "train_sambert": (os.path.join(tmp, "train"), TRAIN_KEYS["train_max_steps"])})
        del voc_trainer
        trace = phase("4_5_train_clis", phase_train_clis, tmp,
                      ckpt_path(os.path.join(tmp, "voc_train"), GAN_KEYS["train_max_steps"]))
        tools["trace"] = trace
        tools["k1_launches"] += trace["k1_launches"]
        am_ckpt, voc_ckpt = phase("6_text_to_wav", phase_text_to_wav, tmp)
        phase("6_card_vs_cpu", phase_card_vs_cpu, am_ckpt, voc_ckpt)
        phase("7_train_to_serve", phase_train_to_serve, tmp,
              ckpt_path(os.path.join(tmp, "train"), 40),
              ckpt_path(os.path.join(tmp, "voc_train"), 40))
        serve = phase("8_serve", phase_serve, tmp, am_ckpt, voc_ckpt)
        nsf = phase("9_nsf", phase_nsf, tmp)
        bf16 = phase("10_bf16_se_byte", phase_bf16_se_byte, tmp, voc_ckpt)
        fp = phase("11_fp_sybert", phase_fp_sybert, tmp)
        pre = phase("12_preprocess", phase_preprocess, tmp)
        ddp = phase("13_ddp", phase_ddp, tmp)
        mp_ = phase("16_model_parallel", phase_model_parallel, tmp)
        int8 = phase("14_int8_export", phase_int8_export, tmp, am_ckpt, voc_ckpt)
    log("phase_seconds", total=round(time.perf_counter() - T_START, 3),
        phases=json.dumps(seconds).replace(" ", ""))
    import torch

    train = k1["train"]
    b1, b8 = int8["per_call"][1], int8["per_call"][8]
    print(json.dumps({"kernels": [{
        "name": "K1 mas_width1 (MAS Viterbi)", "route": "cuda",
        "source": "kantts_tpu_torch/csrc/mas.cu",
        "replaces": "kantts_tpu/ops/mas_pallas.py:91",
        "launches": (fwd_launches + train_launches
                     + sum(bf16["k1_launches"].values()) + pre["k1_launches"]
                     + ddp["k1_launches"] + tools["k1_launches"] + mp_["k1_launches"]),
        "launches_by_path": {"mas_forward": fwd_launches,
                             "train_sambert": train_launches,
                             "serve": serve["k1_launches"],
                             "nsf": nsf["k1_launches"], **bf16["k1_launches"],
                             "fp_sybert": fp["k1_launches"],
                             "preprocess": pre["k1_launches"],
                             "ddp": ddp["k1_launches"],
                             "tools": tools["k1_launches"],
                             "tp": mp_["k1_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
        "ms": train["ms"], "plain_ms": train["plain_ms"],
        "bound_ms": train["bound_ms"], "bound_by": train["bound_by"],
        "library_ms": None, "variant": train["variant"],
        "ms_in_train_step": k1_step_ms,
        "shapes": {name: {k: r[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                            "bound_by", "variant")}
                   for name, r in k1.items()}}, {
        "name": "K2 int8_conv1d (int8 W8A8 vocoder conv)", "route": "cuda",
        "source": "kantts_tpu_torch/csrc/int8_conv.cu",
        "replaces": "no TPU kernel (XLA int8 conv, "
                    "kantts_tpu/models/hifigan/layers.py:161)",
        "launches": sum(int8["launches_by_path"].values()),
        "launches_by_path": int8["launches_by_path"],
        "max_abs_err": int8["k2"]["max_abs_err"],
        "ms": b1["ms"], "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
        "bound_by": b1["bound_by"], "library_ms": b1["library_ms"],
        "cudnn_f32_ms": b1["cudnn_f32_ms"],
        "per": "one hifigan_v1_16k call at B=1 on 400 frames: the sum over its "
               "104 int8 convs",
        "b8": {k: b8[k] for k in ("ms", "bound_ms", "bound_by", "library_ms",
                                  "cudnn_f32_ms")},
        "device_launches_per_call": tools["trace"]["k2_profile"]["device_launches"],
        "device_ms_per_call": tools["trace"]["k2_profile"]["device_ms"],
        "distinct_shapes": int8["distinct_shapes"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
