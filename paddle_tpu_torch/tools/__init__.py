"""Measurement scripts of the port, run on a CUDA card from the
repository root with ``python3 -m paddle_tpu_torch.tools.<name>``."""
