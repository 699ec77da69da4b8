"""Benchmark entry points of the port, each `python -m
navierstokes_tpu_torch.bench.<tool>`: spmv_bench, transient_bench,
gmres_decomp, create_mat, layout_census, accuracy_drift, ca_bench; and
their timing (`timing.py`)."""
