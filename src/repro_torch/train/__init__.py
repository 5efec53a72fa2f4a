"""Optimizers and the data-parallel training step over simulated workers."""
