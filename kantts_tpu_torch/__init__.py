"""kantts_tpu_torch: the PyTorch/CUDA port of ``kantts_tpu`` for NVIDIA
Hopper.

Ported so far: the serving path (text -> SAM-BERT -> HiFi-GAN -> wav),
SAM-BERT training with MAS, whose Viterbi runs in the hand-written CUDA
kernel K1 (``csrc/mas.cu``), and HiFi-GAN GAN training. Host-side code that
imports no JAX (``kantts_tpu.text``, ``kantts_tpu.data``,
``kantts_tpu.utils.{audio,config,log,torch_convert}``) is reused from
``kantts_tpu``; this package imports neither JAX nor Flax.
"""

__version__ = "0.1.0"
