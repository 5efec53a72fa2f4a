"""Decoder-only LM layers, the model forward, and ResNet-18."""
