"""Operator tools of the port (``python -m fast_tffm_tpu_torch.tools.<name>``)."""
