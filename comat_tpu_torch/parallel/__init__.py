"""See the package docstring of comat_tpu_torch."""
