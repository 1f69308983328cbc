"""Command-line probes of the port (``python -m bigdl_tpu_torch.scripts.<name>``)."""
