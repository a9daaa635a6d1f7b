"""Port of ferrum_tpu/scheduler (see the package docstring)."""
