"""Quantized KV cache, prefill/decode engine and the continuous scheduler."""
