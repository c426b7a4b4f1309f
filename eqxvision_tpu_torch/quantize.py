"""Int8 quantization for serving (eqxvision_tpu/quantize.py).

Per-output-channel symmetric int8: a layer's weight ``w`` becomes ``q =
clip(round(w / s), -127, 127)`` with ``s = max|w| / 127`` over each output
channel (1 where the channel is all zero), computed in f32; ``torch.round``
rounds half to even, as ``jnp.round`` does, so the int8 tensors are the JAX
package's. The scale commutes through the contraction, so it is applied to
the f32 accumulator, never to the weight: ``(x @ q) * s == x @ (q * s)``.

- ``QuantLinear`` (weight-only): the int8 weight is cast to x's type (exact:
  bf16 holds every integer up to 256), the product accumulated in f32,
  scaled, the bias added, and the sum rounded once to x's type, as
  ``nn.Linear.preactivation`` does.
- ``QuantConv2d`` (weight-only): the convolution runs in f32 on the upcast
  int8 weight and input, which f32 holds exactly, then the scale and the
  bias, then one rounding: the JAX layer's f32 accumulation. A bf16
  convolution would round before the scale (ROADMAP C.19).
- ``DynActInt8Linear`` (w8a8): each row of x is quantized to int8 by its
  own max-abs scale at every call, and the product is int8 x int8 -> int32
  (``torch._int_mm``), rescaled by the row and channel scales. On the card
  cuBLAS's int8 GEMM takes more than 16 rows and k and n that are multiples
  of 8, so the operands are padded with zero rows and columns, which add
  nothing to the sums (ROADMAP C.20). An f32 product would not be exact:
  127^2 * 3072 is past 2^24.

The modules swap in for the port's ``nn.Linear`` and ``nn.Conv2d`` under the
same names; their state-dict entries are ``qweight`` (int8, the (out, in) or
OIHW layout), ``scale`` (f32, kept f32 through casts of the model) and
``bias``. ``weight`` is the dequantized ``q * s`` in f32 for callers that
read the matrix instead of calling the layer (Swin's fused kernels, which
cast it to x's type). A ViT or ConvNeXt block whose Linears are quantized
calls them, on the unfused route (LayerNorm kernel, the layers, the
fused-qkv attention kernel), as the JAX model does; the fused halves, which
read ``.weight``, would compute another function.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .nn.conv import Conv2d, conv2d_nhwc
from .nn.linear import Linear, wide_product
from .nn.norm import apply_keeping_f32


class _Quantized(nn.Module):
    """Holds ``qweight`` and ``scale`` as buffers and keeps ``scale`` f32
    when the module is cast, as the JAX quantizer's scales stay f32."""

    def __init__(self, qweight: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("qweight", qweight)
        self.register_buffer("scale", scale)
        self.bias = None if bias is None else nn.Parameter(bias.detach().clone(), requires_grad=False)

    def _apply(self, fn, recurse=True):
        return apply_keeping_f32(self, fn, recurse, ("scale",))

    def _scale_shape(self):
        return (-1,) + (1,) * (self.qweight.ndim - 1)

    @property
    def weight(self) -> torch.Tensor:
        """The dequantized weight, ``q * s`` in f32, in the stored layout."""
        return self.qweight.float() * self.scale.reshape(self._scale_shape())

    def _epilogue(self, y: torch.Tensor) -> torch.Tensor:
        y = y * self.scale.to(y.dtype)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class QuantLinear(_Quantized):
    """Weight-only int8 ``nn.Linear``: int8 (out, in) weight, f32 scales."""

    def __init__(self, qweight, scale, bias, in_features: int, out_features: int):
        super().__init__(qweight, scale, bias)
        self.in_features, self.out_features = int(in_features), int(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.preactivation(x).to(x.dtype)

    def preactivation(self, x: torch.Tensor) -> torch.Tensor:
        """f32 accumulator, times the scale, plus the bias, unrounded."""
        return self._epilogue(wide_product(x, self.qweight.to(x.dtype)))


class QuantConv2d(_Quantized):
    """Weight-only int8 ``nn.Conv2d`` on NHWC: int8 OIHW weight, f32 scales."""

    def __init__(self, qweight, scale, bias, stride, padding, dilation, groups: int):
        super().__init__(qweight, scale, bias)
        self.out_channels, cin, kh, kw = qweight.shape
        self.in_channels = cin * int(groups)
        self.kernel_size = (kh, kw)
        self.stride, self.padding, self.dilation, self.groups = tuple(stride), padding, tuple(dilation), int(groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wide = torch.promote_types(x.dtype, torch.float32)
        y = conv2d_nhwc(x.to(wide), self.qweight.to(wide), None, self.stride, self.padding, self.dilation, self.groups)
        return self._epilogue(y).to(x.dtype)


class DynActInt8Linear(QuantLinear):
    """w8a8 ``nn.Linear``: int8 weights and per-row dynamically quantized
    int8 activations, an int8 x int8 -> int32 product."""

    def preactivation(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        sx = xf.abs().amax(dim=-1, keepdim=True) / 127.0  # per row
        sx = torch.where(sx == 0, 1.0, sx)
        xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
        y32 = int8_matmul(xq.reshape(-1, x.shape[-1]), self.qweight).reshape(*x.shape[:-1], self.out_features)
        y = y32.float() * (sx * self.scale)
        return y if self.bias is None else y + self.bias.float()


def int8_matmul(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``a @ q.T`` for int8 ``a`` (m, k) and ``q`` (n, k), exact in int32.
    On the card the operands are padded to cuBLAS's int8 shapes (m > 16;
    k and n multiples of 8) with zeros, and the product cropped."""
    if a.device.type != "cuda":
        return torch._int_mm(a, q.t())
    m, k = a.shape
    n = q.shape[0]
    mp, kp, np_ = max(-(-m // 8) * 8, 32), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        q = F.pad(q, (0, kp - k, 0, np_ - n))
    y = torch._int_mm(a, q.t())
    return y if (mp, np_) == (m, n) else y[:m, :n]


def _quantize(w: torch.Tensor):
    """Per-output-channel (axis 0) symmetric int8 of ``w``, in f32."""
    w = w.detach().float()
    scale = w.abs().amax(dim=tuple(range(1, w.ndim))) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(w / scale.reshape((-1,) + (1,) * (w.ndim - 1))), -127, 127).to(torch.int8)
    return q, scale


def quantize_linear(lin: Linear) -> QuantLinear:
    """Per-output-channel symmetric int8 of one ``nn.Linear``."""
    q, scale = _quantize(lin.weight)
    return QuantLinear(q, scale, lin.bias, lin.in_features, lin.out_features)


def quantize_conv2d(conv: Conv2d) -> QuantConv2d:
    """Per-output-channel symmetric int8 of one ``nn.Conv2d``."""
    q, scale = _quantize(conv.weight)
    return QuantConv2d(q, scale, conv.bias, conv.stride, conv.padding, conv.dilation, conv.groups)


def _swap(node: nn.Module, fn: Callable[[nn.Module], Optional[nn.Module]]) -> None:
    for name, child in list(node.named_children()):
        new = fn(child)
        if new is None:
            _swap(child, fn)
        else:
            setattr(node, name, new)


def quantize_dynamic_int8(model: nn.Module, *, predicate: Optional[Callable[[nn.Module], bool]] = None) -> nn.Module:
    """A copy of ``model`` with each (selected) ``nn.Linear`` replaced by a
    w8a8 ``DynActInt8Linear``. Inference only."""

    def fn(m):
        if isinstance(m, Linear) and (predicate is None or predicate(m)):
            lin = quantize_linear(m)
            return DynActInt8Linear(lin.qweight, lin.scale, m.bias, m.in_features, m.out_features)
        return None

    model = copy.deepcopy(model)
    _swap(model, fn)
    return model


def quantize_weights_int8(
    model: nn.Module, *, convs: bool = False, predicate: Optional[Callable[[nn.Module], bool]] = None
) -> nn.Module:
    """A copy of ``model`` with each (selected) ``nn.Linear`` and, with
    ``convs=True``, ``nn.Conv2d`` replaced by ``QuantLinear`` /
    ``QuantConv2d``. ``predicate(layer)`` narrows the selection. Layers that
    are already quantized (``quantize_dynamic_int8``'s) stay as they are.
    Fold the BatchNorms first (``ops.fold_batchnorm``), so that the folded
    affine lands in the quantized weights."""

    def fn(m):
        if isinstance(m, Linear) and (predicate is None or predicate(m)):
            return quantize_linear(m)
        if convs and isinstance(m, Conv2d) and (predicate is None or predicate(m)):
            return quantize_conv2d(m)
        return None

    model = copy.deepcopy(model)
    _swap(model, fn)
    return model
