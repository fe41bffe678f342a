"""Schedulers and resampling ops (PyTorch)."""
