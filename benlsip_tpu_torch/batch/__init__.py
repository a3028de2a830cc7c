"""Batched solving and the mixed-precision pipeline."""
