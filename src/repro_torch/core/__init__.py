"""Quantization math, the wire codec, collectives and the gradient compressors."""
