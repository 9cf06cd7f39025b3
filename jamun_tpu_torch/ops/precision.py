"""The matmul precision policy (counterpart of `jamun_tpu/ops/precision.py`).

By compute dtype: an f32 model runs true f32 matmuls, no TF32 (JAX sets
"highest" for the same reason: the TPU's default would round f32 operands
to bf16); a bf16 model multiplies bf16 operands and accumulates in f32, as
one MXU pass does in JAX. PyTorch has no per-call precision argument, so
the policy is global: `pin_matmul_precision` sets it (`utils/torch_setup.
setup_torch` calls it, and so both CLIs). The hand-written kernels do not read these flags: their f32
builds run f32 FMAs and their bf16 builds accumulate in f32.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["matmul_precision", "pin_matmul_precision"]

_16_BIT = (torch.bfloat16, torch.float16)
_NAMES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def matmul_precision(dtype: Union[torch.dtype, str, None]) -> str:
    """The precision of a matmul whose operands are `dtype` (a torch dtype,
    the arch files' "bfloat16", or None for f32): "highest" (true f32) for
    f32 and wider, "bf16-inputs-f32-accumulate" / "f16-inputs-f32-accumulate"
    for the 16-bit types."""
    if isinstance(dtype, str):
        dtype = _NAMES[dtype]
    if dtype in _16_BIT:
        return ("bf16" if dtype == torch.bfloat16 else "f16") + "-inputs-f32-accumulate"
    return "highest"


def pin_matmul_precision() -> None:
    """Set the policy globally: no TF32 in cuBLAS or cuDNN, f32 matmuls at
    "highest", and no 16-bit partial sums in cuBLAS's reduced-precision
    reductions (16-bit GEMMs accumulate in f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
