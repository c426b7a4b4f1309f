"""What the benchmark counts of a Swin v1: its multiply-adds from its
shapes."""
from __future__ import annotations

from typing import Dict

from ..reference import swin as reference

REFERENCE = reference


def _maps(cfg: Dict):
    """(stage, depth, heads, width, side of the map) of each stage."""
    side = cfg["image_size"] // cfg["patch_size"]
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        yield s, depth, heads, cfg["embed_dim"] * 2**s, side // 2**s


def _padded(side: int, w: int) -> int:
    return -(-side // w) * w


def forward_macs(cfg: Dict) -> int:
    """Multiply-adds of one image's forward: the patch projection, each
    block's qkv, QK^T and PV inside its windows (on the padded map), proj,
    fc1 and fc2, the mergings' reductions, and the head."""
    p, w = cfg["patch_size"], cfg["window_size"]
    side0 = cfg["image_size"] // p
    total = side0 * side0 * cfg["embed_dim"] * cfg["in_chans"] * p * p
    maps = list(_maps(cfg))
    for s, depth, heads, c, side in maps:
        t = side * side
        tp = _padded(side, w) ** 2
        hidden = int(c * cfg["mlp_ratio"])
        block = tp * c * 3 * c + 2 * tp * w * w * c + tp * c * c + 2 * t * c * hidden
        total += depth * block
        if s < len(maps) - 1:
            total += (side // 2) ** 2 * 4 * c * 2 * c
    return total + maps[-1][3] * cfg["num_classes"]


def model_kwargs(cfg: Dict, drop_path: float = 0.0) -> Dict:
    """``create_model`` keywords: the configuration's sizes and a
    stochastic-depth rate."""
    p, w = cfg["patch_size"], cfg["window_size"]
    return {"patch_size": (p, p), "embed_dim": cfg["embed_dim"], "depths": tuple(cfg["depths"]),
            "num_heads": tuple(cfg["num_heads"]), "window_size": (w, w), "mlp_ratio": cfg["mlp_ratio"],
            "num_classes": cfg["num_classes"], "stochastic_depth_prob": drop_path}
