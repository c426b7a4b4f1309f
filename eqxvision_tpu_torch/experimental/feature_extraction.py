"""Intermediate feature extraction (eqxvision_tpu/experimental/feature_extraction.py).

``intermediate_layer_getter(model, where)`` gives a module whose call runs
the whole of ``model`` and returns ``(final_output, [tapped outputs])``, the
taps in ``where``'s order. ``where`` returns submodules (``lambda m:
[m.layer3, m.layer4]``) or integer indices into an ``nn.Sequential``
(``lambda m: [4, 16]``).

A tap is a forward hook on its target module. The getter's call pushes a
collection onto a ``contextvars`` stack and each tap writes into its own
getter's collection on that stack, so taps are scoped to the call: two
calls in two threads, or two getters over the same modules, never mix
taps, and outside a getter's call the hooks do nothing. The getter is a
view of ``model``: it shares the model's own dictionaries of children,
parameters and buffers, so every ``state_dict()`` name is the model's
(``backbone.layer3.0.conv1.weight``, ``backbone.16.0.weight``, as
torchvision's getter names them), and ``.to()``, a cast, ``train()`` and
``ops.fold_batchnorm``'s slot swaps reach the model. The hooks stay on the
model's modules.
"""
from __future__ import annotations

import contextvars
from typing import Callable, Sequence, Tuple

import torch
from torch import nn

_collector_stack: contextvars.ContextVar[Tuple[tuple, ...]] = contextvars.ContextVar(
    "eqxvision_tpu_torch_feature_taps", default=()
)


class _Tap:
    """Forward hook: write the module's output into its getter's
    collection, the innermost one of that getter on the stack. A class,
    not a closure: a deep copy (``ops.fold_batchnorm``'s) then points the
    copied hooks at the copied getter."""

    def __init__(self, getter: "IntermediateLayerGetter", index: int):
        self.getter = getter
        self.index = index

    def __call__(self, module, args, output):
        for owner, taps in reversed(_collector_stack.get()):
            if owner is self.getter:
                taps[self.index] = output
                return


class IntermediateLayerGetter(nn.Module):
    """Calls the wrapped model; returns ``(final, [tapped outputs])``."""

    def __init__(self, model: nn.Module, targets: Sequence[nn.Module]):
        super().__init__()
        self.__dict__["model"] = model  # outside the module tree: the names stay the model's own
        self._modules = model._modules
        self._parameters = model._parameters
        self._buffers = model._buffers
        self._non_persistent_buffers_set = model._non_persistent_buffers_set
        self.n_taps = len(targets)
        self.training = model.training
        for i, target in enumerate(targets):
            target.register_forward_hook(_Tap(self, i))

    def train(self, mode: bool = True):
        super().train(mode)
        self.model.training = mode
        return self

    def forward(self, x: torch.Tensor):
        taps: dict = {}
        token = _collector_stack.set(_collector_stack.get() + ((self, taps),))
        try:
            out = self.model(x)
        finally:
            _collector_stack.reset(token)
        return out, [taps.get(i) for i in range(self.n_taps)]


def intermediate_layer_getter(model: nn.Module, where: Callable) -> IntermediateLayerGetter:
    """Wrap ``model`` so that a call returns ``(final_output, [tapped
    outputs])``; ``where(model)`` names the taps."""
    targets = where(model)
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if all(isinstance(t, int) for t in targets):
        if not isinstance(model, nn.Sequential):
            raise ValueError("integer indices require a Sequential model")
        targets = [model[i] for i in targets]
    found = {id(m) for m in model.modules()}
    if any(id(t) not in found for t in targets):
        raise ValueError("target layer not found in model")
    return IntermediateLayerGetter(model, list(targets))


class AuxData:  # pragma: no cover - compat shell
    """Compat shell for the reference's mutable activation cell. The
    functional design has no retained cells; use
    ``intermediate_layer_getter``, which returns activations directly."""

    def __init__(self, *_, **__):
        raise NotImplementedError(
            "AuxData side-channel cells were replaced by functional returns: "
            "intermediate_layer_getter(model, where)(x) -> (final, [activations])."
        )
