"""The benchmark of kantts_tpu_torch on an NVIDIA H100 (``run.py``)."""
