"""Port of ferrum_tpu/sampling (see the package docstring)."""
