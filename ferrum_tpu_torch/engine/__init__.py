"""Port of ferrum_tpu/engine (see the package docstring)."""
