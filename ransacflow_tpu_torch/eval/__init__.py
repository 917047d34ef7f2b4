"""Evaluation hooks of the port (see `ransacflow_tpu/eval`)."""
