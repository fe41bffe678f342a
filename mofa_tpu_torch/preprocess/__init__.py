"""Host-side preprocessing of user inputs (PyTorch / numpy)."""
