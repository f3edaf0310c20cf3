"""Entry points run as ``python -m ray_tpu_torch.scripts.<name>``."""
