"""See the package docstring of boxer_tpu_torch."""
