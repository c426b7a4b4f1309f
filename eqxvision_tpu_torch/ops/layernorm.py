"""Last-axis LayerNorm (eqxvision_tpu/ops/layernorm.py).

``layer_norm`` normalises over the last axis with the mean and the centred
variance in f32, applies the optional affine in f32 (the weight and bias
read in their stored type and widened), and rounds once to the input's
type. A CUDA tensor goes through a hand-written Hopper kernel
(``csrc/layer_norm.cu``), a CPU tensor through ``layer_norm_reference``; no
other device is accepted, and on CUDA nothing falls back to the plain
version. The gradient recomputes through the plain version, as the JAX
package's custom VJP does.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _native
from .attention import _DTYPE_CODES, export_op, recompute_grads


def layer_norm_reference(
    x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], eps: float
) -> torch.Tensor:
    """Plain version: f32 mean and centred variance over the last axis,
    affine in f32, output in x's type (an f64 input computes in f64)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.to(xf.dtype) + bias.to(xf.dtype)
    return y.to(x.dtype)


def _launch_kernel(x, weight, bias, eps):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if weight is not None:
        if weight.dtype not in _DTYPE_CODES or bias.dtype != weight.dtype:
            raise TypeError(
                f"layer_norm kernel takes a float32 or bfloat16 weight and a bias of the same type, "
                f"got {weight.dtype} and {bias.dtype}"
            )
        if weight.device != x.device or bias.device != x.device:
            raise ValueError(f"layer_norm: weight and bias must be on {x.device} with x")
        weight, bias = weight.contiguous(), bias.contiguous()
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    d = x.shape[-1]
    lib = _native.library()
    with torch.cuda.device(x.device):
        err = lib.eqx_layer_norm(
            x.data_ptr(), None if weight is None else weight.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), x.numel() // d, d, eps, _DTYPE_CODES[x.dtype],
            0 if weight is None else _DTYPE_CODES[weight.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err:
        _native.check(err, f"layer_norm kernel on x {tuple(x.shape)} {x.dtype}")
    layer_norm.launches += 1
    return out


def _forward(x, weight, bias, eps):
    if x.device.type == "cuda":
        return _launch_kernel(x, weight, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    raise ValueError(f"layer_norm runs on cuda (kernel) or cpu (plain torch), not {x.device}")


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.static = (eps,)
        return _forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(ctx, layer_norm_reference, grad_out, n_static=1)


def layer_norm(
    x: torch.Tensor, weight: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any leading shape).

    ``weight`` and ``bias`` are both (D,) or both None (no affine). Counterpart
    of the JAX package's ``layer_norm`` and its Pallas kernel ``_ln_kernel``;
    the 128-lane gate and the row-block fall-back there are the TPU's tiling
    devices and have no counterpart: the kernel takes any D and row count.
    ``layer_norm.launches`` counts kernel launches.
    """
    if x.ndim == 0:
        raise ValueError("layer_norm needs at least one axis")
    if (weight is None) != (bias is None):
        raise ValueError("layer_norm takes both weight and bias, or neither")
    d = x.shape[-1]
    if weight is not None and (tuple(weight.shape) != (d,) or tuple(bias.shape) != (d,)):
        raise ValueError(
            f"expected weight and bias of shape ({d},), got {tuple(weight.shape)} and {tuple(bias.shape)}"
        )
    if torch.compiler.is_exporting():
        return _layer_norm_op(x, weight, bias, float(eps))
    return _LayerNorm.apply(x, weight, bias, float(eps))


layer_norm.launches = 0
_layer_norm_op = export_op(
    "layer_norm", "(Tensor x, Tensor? weight, Tensor? bias, float eps) -> Tensor", _launch_kernel,
    layer_norm_reference, lambda x, weight, bias, eps: x.new_empty(x.shape),
)
