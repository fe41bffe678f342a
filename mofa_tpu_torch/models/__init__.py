"""Model modules of the port (PyTorch, diffusers / transformers names)."""
