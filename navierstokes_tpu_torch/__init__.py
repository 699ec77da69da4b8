"""navierstokes_tpu_torch — the PyTorch and CUDA port of navierstokes_tpu.

The JAX package `navierstokes_tpu` stays the reference.  This package runs
its flagship transient solve (Stokes initialization, then backward-Euler
steps with Newton and GMRES on the two-level component-plane
preconditioner) with PyTorch on an NVIDIA H100, the plane SpMV as the
hand-written CUDA kernel `csrc/plane_dia.cu`.  It imports neither `jax` nor
`navierstokes_tpu`, and it imports without `nvcc` or `triton`: kernels are
built at their first CUDA launch.
"""

from navierstokes_tpu_torch.config import NewtonConfig, NSConfig, SolverConfig

__version__ = "0.1.0"

__all__ = ["NewtonConfig", "NSConfig", "SolverConfig", "__version__"]
