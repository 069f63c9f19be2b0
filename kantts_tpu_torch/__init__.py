"""kantts_tpu_torch: the PyTorch/CUDA port of ``kantts_tpu`` for NVIDIA
Hopper.

Ported so far: the serving path (text -> SAM-BERT -> HiFi-GAN -> wav),
offline and online (``serve/``: dynamic micro-batching behind an HTTP
server; ``infer/``: exact streaming and chunked vocoding), SAM-BERT training with MAS, whose Viterbi runs in the hand-written CUDA
kernel K1 (``csrc/mas.cu``), HiFi-GAN GAN training, and the preprocessing
that turns recordings into their corpora (``bin/process_data.py``), int8
W8A8 vocoding on the hand-written CUDA kernel K2 (``csrc/int8_conv.cu``)
and the serving artifact (``infer/exported.py``, ``bin/export_tts.py``). The
package stands alone: it imports torch and never JAX, Flax, optax or
anything of ``kantts_tpu``. The host-side modules it needs (``text/``,
``preprocess/{script_convertor,audio_utils}.py``, ``native/pitch.cpp``,
``data/``, ``utils/{audio,config,log,torch_convert,metrics}.py`` and the
front-end's ``resources/``) are its own copies, under the JAX package's
relative names. Every entry point runs on the card
unless the caller asks for the CPU (``device="cpu"``, ``--device cpu``).
"""

__version__ = "0.1.0"
