"""Process setup of the port's CLIs (counterpart of
`jamun_tpu/utils/jax_setup.py`).

JAX's `setup_jax` does two things: it turns on the persistent compilation
cache and pins f32 matmuls to "highest". The port's kernels already keep
their builds in `jamun_tpu_torch/_build/` (`ops/cuda/build.py`), so only the
precision half has work to do here (`ops/precision.pin_matmul_precision`).
"""

from __future__ import annotations

from jamun_tpu_torch.ops.precision import pin_matmul_precision

__all__ = ["setup_torch"]


def setup_torch() -> None:
    """Pin the matmul precision policy for the process (no TF32, f32
    matmuls at "highest", 16-bit GEMMs accumulating in f32)."""
    pin_matmul_precision()
