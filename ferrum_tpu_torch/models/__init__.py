"""Port of ferrum_tpu/models (see the package docstring)."""
