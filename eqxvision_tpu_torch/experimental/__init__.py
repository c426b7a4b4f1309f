"""Experimental utilities (eqxvision_tpu/experimental)."""
from .feature_extraction import AuxData, IntermediateLayerGetter, intermediate_layer_getter

__all__ = ["AuxData", "IntermediateLayerGetter", "intermediate_layer_getter"]
