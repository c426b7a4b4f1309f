"""What the benchmark counts of a ViT: its multiply-adds from its shapes."""
from __future__ import annotations

from typing import Dict

from ..reference import vit as reference

REFERENCE = reference


def tokens(cfg: Dict) -> int:
    return (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1


def forward_macs(cfg: Dict) -> int:
    """Multiply-adds of one image's forward: the patch projection, each
    block's qkv, QK^T, PV, proj, fc1 and fc2, and the head."""
    d, p, c = cfg["embed_dim"], cfg["patch_size"], cfg["in_chans"]
    hidden = int(d * cfg["mlp_ratio"])
    n = tokens(cfg)
    patch = (n - 1) * d * c * p * p
    block = n * d * 3 * d + 2 * n * n * d + n * d * d + 2 * n * d * hidden
    return patch + cfg["depth"] * block + d * cfg["num_classes"]


def model_kwargs(cfg: Dict, drop_path: float = 0.0) -> Dict:
    """``create_model`` keywords: the configuration's sizes and a
    stochastic-depth rate."""
    return {"img_size": cfg["image_size"], "patch_size": cfg["patch_size"], "in_chans": cfg["in_chans"],
            "embed_dim": cfg["embed_dim"], "depth": cfg["depth"], "num_heads": cfg["num_heads"],
            "mlp_ratio": cfg["mlp_ratio"], "num_classes": cfg["num_classes"], "qkv_bias": cfg["qkv_bias"],
            "drop_path_rate": drop_path}
