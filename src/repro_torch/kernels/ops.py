"""Public wrappers for the package's kernels, with the JAX package's names
and signatures (``repro.kernels.ops``).

Every wrapper dispatches by the device of the tensor it is given: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel or the call raises. There is no fallback from one to
the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from .dequant_u8 import dequant_u8_fwd


def dequant_u8(x, scale, bias, *, out_dtype=torch.float32, block_rows: int = 256):
    """x (..., C) uint8 -> (..., C) float, ``(x*scale + bias)``.

    ``block_rows`` is accepted for signature parity with the JAX package and
    not used: the CUDA kernel's launch geometry is its own (16-byte vectors
    over the flat array, a grid sized to the card)."""
    del block_rows
    return dequant_u8_fwd(x, scale, bias, out_dtype=out_dtype)


def dequant_rows(x, scale, bias, *, out_dtype=torch.float32, block_rows: Optional[int] = None):
    """``dequant_u8`` as the device feed calls it (and the cold start will).
    ``block_rows`` sized the TPU grid in the JAX package; here it is accepted
    and not used, as in ``dequant_u8``."""
    del block_rows
    return dequant_u8_fwd(x, scale, bias, out_dtype=out_dtype)
