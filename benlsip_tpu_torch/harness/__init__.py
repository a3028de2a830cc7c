"""Sweep harness: checkpointed sweeps and solves, metrics, profiling."""
