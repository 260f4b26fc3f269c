"""Drivers of the port (``python -m gaus_slam_tpu_torch.scripts.<name>``)."""
