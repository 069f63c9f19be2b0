"""kantts_tpu_torch: the PyTorch/CUDA port of ``kantts_tpu`` for NVIDIA
Hopper.

The slice ported so far is the serving path (text -> SAM-BERT -> HiFi-GAN ->
wav) and the SAM-BERT teacher-forced forward with MAS, whose Viterbi runs in
the hand-written CUDA kernel K1 (``csrc/mas.cu``). Host-side code that
imports no JAX (``kantts_tpu.text``, ``kantts_tpu.utils.audio``,
``kantts_tpu.utils.torch_convert``) is reused from ``kantts_tpu``; this
package imports neither JAX nor Flax.
"""

__version__ = "0.1.0"
