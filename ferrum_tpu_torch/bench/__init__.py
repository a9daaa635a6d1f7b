"""Port of ferrum_tpu/bench (see the package docstring)."""
