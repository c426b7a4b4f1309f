from .classification import *  # noqa: F401,F403
from .segmentation import *  # noqa: F401,F403
from .registry import create_model, list_models
