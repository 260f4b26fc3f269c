"""Command-line probes of the port (``python -m gaus_slam_tpu_torch.tools.<name>``)."""
