"""Quantization math and the wire codec (serving subset)."""
