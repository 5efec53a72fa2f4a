"""Decoder-only LM layers and the model forward (dense attention stacks)."""
