"""The precision a reference computes its matrix products in.

``EXACT`` leaves every operand as it is: the reference in f32, with TF32
off for matrix products and convolutions (``exact_f32()``). ``FP8`` rounds
both operands of every product to float8 e4m3 with one scale a tensor
(its largest magnitude onto e4m3's 448), the step below bf16 that would
tempt a later change: it is the control that the comparison has to fail.
The rounding passes the gradient straight through, so a training step's
backward runs on the rounded forward.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (rounded - t).detach()


PRECISIONS = {"f32": exact, "fp8": fp8}


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def linear(x: torch.Tensor, w: torch.Tensor, b, q) -> torch.Tensor:
    """``x @ w.T + b`` with both operands through ``q``."""
    y = torch.matmul(q(x), q(w).t())
    return y if b is None else y + b


def matmul(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return torch.matmul(q(a), q(b))
