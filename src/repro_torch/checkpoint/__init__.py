"""Checkpoints of training state: path-keyed leaves, zlib, restart-safe."""
