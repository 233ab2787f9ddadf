"""Worked examples of the port (``python -m desire_tpu_torch.examples.<name>``)."""
