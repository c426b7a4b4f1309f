"""The plain references against the port at tiny widths on the CPU: the ViT
and Swin forwards in f32, the eval preprocessing, and training steps,
whose replay by the reference (the augmentation's draws, stochastic
depth's masks, AdamW) is exact when the program computes in f32."""
from __future__ import annotations

import time

import pytest
import torch

from portbench.families import swin as swin_family
from portbench.families import vit as vit_family
from portbench.harness import infer, inputs, spec, train
from portbench.reference.precision import exact

VIT = {"image_size": 32, "patch_size": 8, "in_chans": 3, "embed_dim": 32, "depth": 2, "num_heads": 2,
       "mlp_ratio": 4.0, "num_classes": 10, "qkv_bias": True, "ln_eps": 1e-6, "factory": "vit_base"}
# a 3-stage Swin whose last map (7 x 7) is one window, where the shift is dropped; every map a
# multiple of the window, as at 224 px (where a map needs padding, the port masks the padded keys
# and torchvision does not)
SWIN = {"image_size": 112, "patch_size": 4, "in_chans": 3, "embed_dim": 16, "depths": [2, 2, 2],
        "num_heads": [1, 2, 4], "window_size": 7, "mlp_ratio": 4.0, "num_classes": 10, "factory": "swin_t"}


@pytest.mark.parametrize("family,cfg", [(vit_family, VIT), (swin_family, SWIN)])
def test_forward_matches_the_port_in_f32(family, cfg):
    from eqxvision_tpu_torch.models import create_model

    model = create_model(cfg["factory"], device="cpu", generator=torch.Generator().manual_seed(0),
                         **family.model_kwargs(cfg)).eval()
    side = cfg["image_size"]
    weights = inputs.make_weights(family.REFERENCE.param_shapes(cfg), 3, "cpu", torch.float32)
    inputs.load_into(model, weights)
    x = torch.randn(3, side, side, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ours = family.REFERENCE.forward(weights, x, cfg, exact)
        theirs = model(x)
    assert torch.allclose(ours, theirs, rtol=1e-4, atol=1e-4), (ours - theirs).abs().max()


def test_preprocessing_matches_the_eval_pipeline():
    from eqxvision_tpu_torch.ops.preprocessing import imagenet_eval_pipeline

    x = torch.randint(0, 256, (2, 40, 52, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(2))
    for resize, crop in ((40, 32), (36, 32), (48, 40)):
        ours = infer.preprocess(x, resize, crop)
        theirs = imagenet_eval_pipeline(x, resize_size=resize, crop_size=crop)
        assert torch.allclose(ours, theirs, atol=2e-5), (resize, crop)


TRAIN = {"config": {k: VIT[k] for k in ("image_size", "patch_size", "embed_dim", "depth", "num_heads", "num_classes")},
         "traffic": {"batch": 4, "canvas": 40, "crop": 32, "pool_batches": 3, "compute_dtype": "float32"},
         "limits": {"loss_gap": {"limit": 1e-5}, "grad_norm_gap": {"limit": 1e-5}, "change_norm_gap": {"limit": 1e-5}}}


@pytest.mark.parametrize("workload", ["vit_base.train_b128", "vit_base.train_dp4"])
def test_training_replay_is_exact_in_f32(workload):
    if workload not in {w for w in _workloads()}:
        pytest.skip(f"{workload} is not a cell of BENCHMARK.json")
    cell = spec.load_cell(workload, overrides=TRAIN)
    out = train.run(cell, 2**62 + 5, 0.3, False, "cpu", time.time(), overrides=TRAIN)
    assert out["correct"], out["checks"]


def _workloads():
    import json

    return [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
