"""Vocoder inference variants: exact streaming, chunked-batch, and the fused
acoustic + vocoder path."""
