"""Tensor ops of the port (see the package docstring)."""
