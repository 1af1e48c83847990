"""Measuring tools of the port, run as ``python -m avvad_tpu_torch.tools.<name>``."""
