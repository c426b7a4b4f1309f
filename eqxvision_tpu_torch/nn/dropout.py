"""Dropout (eqxvision_tpu/nn/dropout.py).

``torch.nn.Dropout`` has the JAX layer's semantics (inverted scaling, a
no-op at p=0 and in eval mode), so it is used as it is. Its mask comes from
torch's default generator of the input's device; the JAX layer takes a key.
"""
from torch.nn import Dropout

__all__ = ["Dropout"]
