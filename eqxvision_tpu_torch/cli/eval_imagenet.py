"""ImageNet-val evaluation (scripts/eval_imagenet.py's flags, plus ``--device``).

Host threads decode the images into uint8 canvases (``data.ImageFolderLoader``),
``data.device_prefetch`` copies them to the device ahead of the step, and the
resize, centre crop and normalisation run there before the model
(``ops.imagenet_eval_pipeline``). Serving transforms, in this order:

- ``--fold-ln``: the LayerNorm affines folded into the weights after them
  (ViT and ConvNeXt; ``ops.fold_layernorm``), in f32, before any cast;
- ``--bf16``: weights and activations in bf16;
- ``--int8``: the BatchNorms folded (``ops.fold_batchnorm``), then the
  Linears and convolutions quantized, weight-only (``quantize_weights_int8``
  with ``convs=True``);
- ``--int8-act``: the Linears quantized w8a8 (``quantize_dynamic_int8``).
  It is applied before ``--int8``'s quantizer, which leaves quantized layers
  as they are: with both flags the Linears are w8a8 and the convolutions
  weight-only int8 (the JAX CLI drops ``--int8-act`` under ``--int8``).

``--tta five_crop|ten_crop`` averages the softmax over the crops of the
resized image. One JSON line a batch, then a summary line.

On the CPU, with a folder of images:

  python -m eqxvision_tpu_torch.cli.eval_imagenet --device cpu \\
      --model resnet18 --data-dir /path/to/val --batch-size 4 --resize 40 --crop 32

On the card (the default ``--device cuda``; it raises where there is none):

  python -m eqxvision_tpu_torch.cli.eval_imagenet --model vit_base \\
      --data-dir /data/imagenet/val --torch-weights vit_base.pth --bf16 --int8

``build_model(args)`` and ``make_step(args)`` are the CLI's two halves, so
that a caller can drive the step on uint8 batches of its own.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch import nn

from ..data import ImageFolderLoader, device_prefetch
from ..models import create_model
from ..models._common import resolve_device
from ..observability import annotate
from ..ops import fold_batchnorm, fold_layernorm
from ..ops.preprocessing import five_crop, imagenet_eval_pipeline, normalize, resize_shorter_side, ten_crop
from ..quantize import quantize_dynamic_int8, quantize_weights_int8


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m eqxvision_tpu_torch.cli.eval_imagenet")
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--pretrained", action="store_true")
    ap.add_argument("--torch-weights", default=None)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--resize", type=int, default=256)
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--int8", action="store_true", help="weight-only int8 (BatchNorm folded first; serving config)")
    ap.add_argument("--int8-act", action="store_true",
                    help="w8a8: int8 weights and per-row dynamic int8 activations on the Linears")
    ap.add_argument("--fold-ln", action="store_true",
                    help="fold pre-norm LayerNorm affines into the weights after them (ViT, ConvNeXt; exact)")
    ap.add_argument("--tta", choices=["five_crop", "ten_crop"], default=None,
                    help="multi-crop test-time augmentation (softmax averaged)")
    return ap


def build_model(args: argparse.Namespace) -> nn.Module:
    """The model on ``args.device`` in eval mode, with the serving
    transforms the flags ask for, in the module docstring's order."""
    kwargs = {"device": args.device}
    if args.torch_weights:
        kwargs["torch_weights"] = args.torch_weights
    model = create_model(args.model, pretrained=args.pretrained, **kwargs).eval()
    if args.fold_ln:
        model = fold_layernorm(model)  # in f32, so that each folded product is rounded once
    if args.bf16:
        model = model.to(torch.bfloat16)
    if args.int8:
        model = fold_batchnorm(model)  # the affine lands in the quantized weights
    if args.int8_act:
        model = quantize_dynamic_int8(model)
    if args.int8:
        model = quantize_weights_int8(model, convs=True)
    return model


def make_step(args: argparse.Namespace):
    """``step(model, images_u8, labels) -> (top1, top5)``: the correct counts
    of a batch of uint8 NHWC canvases as 0-d tensors on the device.
    ``step.scores(model, images_u8)`` gives what they rank: the logits, or
    with ``--tta`` the softmax averaged over the crops."""
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    crop_fn = {"five_crop": five_crop, "ten_crop": ten_crop}.get(args.tta)

    @torch.inference_mode()
    def scores(model, images_u8):
        with annotate("eqxvision.eval.scores"):
            if crop_fn is None:
                with annotate("eqxvision.eval.preprocess"):
                    x = imagenet_eval_pipeline(images_u8, resize_size=args.resize, crop_size=args.crop, dtype=dtype)
                return model(x)
            # the classic multi-crop protocol: crops of the resized image (not of the centre crop)
            with annotate("eqxvision.eval.preprocess"):
                crops = crop_fn(normalize(resize_shorter_side(images_u8, args.resize)).to(dtype), args.crop)
            k, n = crops.shape[:2]
            probs = torch.softmax(model(crops.reshape(k * n, *crops.shape[2:])).float(), dim=-1)
            return probs.reshape(k, n, -1).mean(0)

    @torch.inference_mode()
    def step(model, images_u8, labels):
        s = scores(model, images_u8)
        top1 = (s.argmax(-1) == labels).sum()
        top5 = (s.topk(5, dim=-1).indices == labels[:, None]).any(-1).sum()
        return top1, top5

    step.scores = scores
    return step


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(args)
    step = make_step(args)
    loader = ImageFolderLoader(args.data_dir, batch_size=args.batch_size, side=args.resize, num_workers=args.workers,
                               limit=args.limit or None)
    c1 = c5 = n = 0
    t_start = time.time()
    for imgs, labels in device_prefetch(loader, 2, device):
        t1, t5 = step(model, imgs, labels)
        c1 += int(t1)
        c5 += int(t5)
        n += len(labels)
        print(json.dumps({"event": "batch", "seen": n, "top1": round(c1 / n, 5), "top5": round(c5 / n, 5),
                          "imgs_per_sec": round(n / (time.time() - t_start), 1)}), flush=True)
    print(json.dumps({"event": "summary", "model": args.model, "top1": round(c1 / max(n, 1), 5),
                      "top5": round(c5 / max(n, 1), 5), "images": n,
                      "elapsed_s": round(time.time() - t_start, 1)}), flush=True)


if __name__ == "__main__":
    main()
