"""Utilities of nerve_tpu_torch: metrics, synthetic data, checkpoints."""
