"""kantts_tpu_torch: the PyTorch/CUDA port of ``kantts_tpu`` for NVIDIA
Hopper.

Ported so far: the serving path (text -> SAM-BERT -> HiFi-GAN -> wav),
offline and online (``serve/``: dynamic micro-batching behind an HTTP
server; ``infer/``: exact streaming and chunked vocoding), SAM-BERT training with MAS, whose Viterbi runs in the hand-written CUDA
kernel K1 (``csrc/mas.cu``), and HiFi-GAN GAN training. The package stands
alone: it imports torch and never JAX, Flax, optax or anything of
``kantts_tpu``. The host-side modules it needs (``text/``,
``preprocess/script_convertor.py``, ``data/``, ``utils/{audio,config,log,
torch_convert}.py`` and the front-end's ``resources/``) are its own copies,
under the JAX package's relative names. Every entry point runs on the card
unless the caller asks for the CPU (``device="cpu"``, ``--device cpu``).
"""

__version__ = "0.1.0"
