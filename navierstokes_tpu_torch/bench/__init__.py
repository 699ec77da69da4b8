"""Benchmark entry points of the port (`spmv_bench`) and their timing."""
