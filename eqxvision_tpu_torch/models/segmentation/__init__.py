from ._utils import _SimpleSegmentationModel, resize_bilinear
from .deeplabv3 import ASPP, DeepLabHead, DeepLabV3, deeplabv3
from .fcn import FCN, FCNHead, fcn
from .lraspp import LRASPP, LRASPPHead, lraspp_mobilenet_v3_large

__all__ = ["ASPP", "DeepLabHead", "DeepLabV3", "FCN", "FCNHead", "LRASPP", "LRASPPHead", "deeplabv3", "fcn",
           "lraspp_mobilenet_v3_large", "resize_bilinear"]
