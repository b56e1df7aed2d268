"""Measurement tools of the port (``python -m mvskit_tpu_torch.tools.<name>``)."""
