"""Port of ferrum_tpu/kv (see the package docstring)."""
