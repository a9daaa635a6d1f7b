"""Port of ferrum_tpu/ops (see the package docstring)."""
