"""Runnable examples of the port (`python -m ransacflow_tpu_torch.examples.<name>`)."""
