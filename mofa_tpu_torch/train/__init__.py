"""Training of the MOFA adapter (stage 1): loss, state, checkpoints, data."""
