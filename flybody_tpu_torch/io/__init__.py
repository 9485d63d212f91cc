"""Checkpoints, reference-trajectory datasets and STAC clip conversion."""
