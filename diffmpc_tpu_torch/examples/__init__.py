"""Command-line examples of the PyTorch port (``python -m
diffmpc_tpu_torch.examples.<name>``)."""
