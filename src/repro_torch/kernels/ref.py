"""Plain PyTorch versions of the package's kernels: what each kernel computes,
written with no code shared with the kernel, so the tests catch a kernel
that computes something else. The CPU path of every wrapper runs these."""

from __future__ import annotations

import torch


def dequant_u8_ref(x, scale, bias, out_dtype=torch.float32):
    """``(x * scale + bias)`` over the last axis of ``x``: float32 multiply,
    then float32 add (two separately rounded ops, as numpy's host decode),
    then one round to ``out_dtype``."""
    prod = x.to(torch.float32) * scale
    return (prod + bias).to(out_dtype)
