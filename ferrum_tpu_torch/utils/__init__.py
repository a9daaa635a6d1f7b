"""Port of ferrum_tpu/utils (see the package docstring)."""
