"""Scripts of the port, run as ``python -m ecckd_tpu_torch.scripts.<name>``."""
