"""eqxvision_tpu_torch: the PyTorch + CUDA port of eqxvision_tpu.

The JAX package is the reference; each ported module sits at the same path
here. Public layouts stay the JAX package's (batched NHWC images); modules
are ``nn.Module``s with torch's parameter names and layouts, build on the
card unless the caller names another ``device``, and initialise from an
explicit ``torch.Generator``. Kernels the
JAX package wrote in Pallas for the TPU are hand-written CUDA for Hopper
(``csrc/``), built at first use; importing the package builds nothing and
never imports JAX.
"""

__version__ = "0.1.0"

from . import core, data, experimental, layers, models, nn, ops, parallel, weights
from .models import create_model, list_models

__all__ = ["core", "create_model", "data", "experimental", "layers", "list_models", "models", "nn", "ops", "parallel",
           "weights"]
