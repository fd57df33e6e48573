"""Process-wide float32 matmul settings of the port, set in one place.

The JAX package pins HIGH/HIGHEST matmul precision because one-pass bf16
products broke the corridor scenes (ROADMAP.md "precision" notes); TF32 on
the GPU keeps about the same ~10 mantissa bits and is the same hazard. So
float32 products and convolutions run in full float32.
"""

from __future__ import annotations

import torch


def apply() -> None:
    """Pin full-f32 matmuls: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def pinned() -> bool:
    """True when the settings of :func:`apply` are in force."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")
