"""Deterministic synthetic datasets, drawn on the device from a seed."""
