"""The benchmark of navierstokes_tpu_torch (README.md)."""
