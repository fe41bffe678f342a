"""Frame-parallel inference over torch.distributed (parallel/activation.py)."""
