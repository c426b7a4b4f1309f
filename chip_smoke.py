"""Drive the PyTorch port's inference, training and serving paths once on one NVIDIA card (several ranks in phase 10).

Run from the root of the repository: ``python3 chip_smoke.py``. It needs a
CUDA card and exits non-zero without one; it imports nothing of JAX.
``python3 chip_smoke.py --only-parallel`` builds the kernels and runs
phase 10 alone (on as many cards as are visible), with no result line.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``eqxvision_tpu_torch/csrc`` with nvcc (one
   process per source, in parallel) and prints the build time and the
   compiler's report. Then the GEMMs of the three fused halves
   (``csrc/gemm_bf16.cuh``: bf16, and f32 by split TF32): their registers
   and spills from that report (a spill fails the run), and each
   instantiation driven through its op at the main path's shapes (vit_base
   b256 fc1, fc2, qkv and proj; convnext_tiny b128 stage 1 fc1 and fc2;
   swin_t stage 3 qkv at b128 on a ragged map with padding rows), in bf16
   and f32, its device time, rate and bound beside ``F.linear`` on the same
   operands in the same type.
3. Holds each kernel against its plain torch version on the card at the
   shapes its paths give it, and times both with CUDA events in turns
   (plain, kernel, kernel, plain): the fused-qkv attention (the attention
   stage of ``csrc/attention_stage.cuh``, whose 32 wgmma and 8 f32
   instantiations' registers and spills it prints first, failing on a
   spill or on wgmma
   serialised by ptxas (C7520), and its design at each case) at ViT-B/16's
   shapes, at 384 px, a ragged L above 256 and L = 1024 with head dim 128;
   the window attention (its window stage's and cosine f32 kernels'
   registers and spills first, failing on a spill or on wgmma serialised by
   ptxas) at every stage shape of ``swin_t`` (224 px) and ``swin_v2_t``
   (256 px) at b128 in bf16 and f32, with the path each takes and SDPA and
   the bound beside each, on qkv whose buffer holds NaN after the last
   window, and with NaN and inf planted in a row of q or k, and the whole
   Swin block at their C <= 192 stages, each also with a head biased 300
   log-units below the others; a ragged input (odd window count from padding, a window
   wider than the padded side) through the NHWC entry points; the
   LayerNorm at vit_base b256's and convnext_tiny b128's shapes, rows
   shifted by 1e3 and no affine; the public attention at swin_t stage 1's
   shape, vit_base b256's without and with a (12, 197, 197) bias,
   vit_base 384 px b32's (577 tokens) with and without a bias, a ragged
   one, a head 300 log-units down and a -inf bias over a row's first 256
   keys, with the kernel each case takes and, for the cases on the
   stage's wgmma or f32 kernel, the kernel name the profiler saw, beside
   SDPA in the same type;
   the fused MLP half at every convnext_tiny b128 stage and vit_base b256,
   convnext_large's C = 1536, rows shifted by 1e3 and a ragged row count,
   beside the unfused torch composition it replaces; the fused ViT
   attention half at vit_base b256, a ragged L above 256, vit_base at
   384 px (577 tokens), without a qkv bias and with rows shifted by 1e3,
   beside the unfused torch composition (with SDPA) it replaces, and at
   vit_base b256 its attention stage's device time beside SDPA, bf16 and
   f32; the fused
   Swin v1 attention half at swin_t stages 3 and 4 and swin_b stage 2
   (b128), a ragged map whose windows hold padding tokens and a head 300
   log-units down, beside the unfused composition (with SDPA) it replaces.
   Then ``Linear`` and ``Conv2d`` (plain, strided, depthwise, and ResNet's
   7x7 stride-2 stem, a 1x1 and ResNeXt's grouped 3x3, each with the bias
   of a folded BatchNorm) with f32 and with bf16 parameters on a bf16 input
   against the same function in f64: the bias is added to the f32
   accumulator and rounded once. Then ``nn.BatchNorm`` at inference at
   resnet50 b128 stage shapes, bf16 and f32, against the JAX layer's
   formula spelled out in f32 (f64 for f32), with its time beside it.
4. Serves ``vit_base``, ``swin_t`` (224 px), ``swin_v2_t`` (256 px) and
   ``convnext_tiny``, random weights from a seed: f32 logits of a batch of
   2 against the same weights on the CPU's plain path and the f32 forward's
   time at the largest batch, then bf16 requests
   of several batch sizes with every kernel's launch count set to 0 before
   each path and read after it, then each request's ms and images/s. Then
   calls the public attention as a user would, counts reset the same way.
5. Serves the conv trunks, which run no kernel of the port (cuDNN
   convolutions, ``F.batch_norm``, torch's pools): ``resnet50`` at b1, b8
   and b128, ``alexnet`` at b1 and b8 and ``vgg16_bn`` at b8, every launch
   count 0. A BatchNorm built fresh normalises nothing, so the models with
   BatchNorms first take their running statistics from one training-mode
   forward on a seeded batch, and the f32 card-vs-CPU check sees every
   BatchNorm. Then resnet50 with its BatchNorms folded into its
   convolutions (``ops.fold_batchnorm``): folded against unfolded f32
   logits, and both bf16 forwards at b128 timed in turns.
6. Serves the mobile families, which run no kernel of the port either
   (cuDNN depthwise and grouped convolutions, squeeze-excitation, the
   mobile activations as torch ops): ``mobilenet_v3_large`` and
   ``efficientnet_b0`` at b1, b8 and b256 (the JAX bench's rows),
   ``mobilenet_v2`` and ``regnet_y_400mf`` at b8, each calibrated as above
   (each BatchNorm keeps its own momentum), every launch count 0.
7. Serves the rest of the model zoo, which runs no kernel of the port
   either: ``googlenet`` (``transform_input``) and ``shufflenet_v2_x1_0``
   at b1 and b8, ``densenet121`` and ``squeezenet1_1`` at b8 (224 px), then
   the segmentation models at 520 px: ``deeplabv3`` as the JAX bench's row
   builds it (dilated ResNet-50 tapped at layer3 and layer4, the FCN aux
   head on 1024 channels) at b1 and b8, ``fcn`` (the same taps and aux
   head) and ``lraspp_mobilenet_v3_large`` at b8; each calibrated, every
   launch count 0. A segmentation model's f32 maps are held against the
   CPU at b1 and 260 px (full width and depth; the CPU forward of a
   dilated ResNet-50 at 520 px would take much of the run's time), and
   each bf16 request's maps must be finite, (b, 520, 520, 21) each, the
   aux map beside the main one where there is an aux head.
8. Trains, through ``parallel.make_train_step`` with bf16 compute and f32
   masters, three steps each at b64 from uint8 256 px canvases augmented on
   the card as the training CLI does (crop 224, flip, label smoothing 0.1,
   mixup 0.2 or cutmix 1.0): ``resnet50`` with SGD (no kernel of the port),
   ``vit_base`` with drop path 0.1, remat and AdamW (K1 in blocks 1-11, the
   two fused halves in block 0, K6; the recompute's launches counted), and
   ``swin_t`` with AdamW (K3 and K6 in every block). Each step's loss must
   be finite and its launches the expected ones; each model's forward and
   backward + optimiser ms by CUDA events, images/s, peak memory, and a
   fourth step's device time with its kernels' plain recompute in the
   backward (torch.profiler). Around resnet50's fourth step, one EMA update
   against its closed form, then the EMA weights through the eval step with
   ten-crop TTA against the crops' averaged softmax. Then the cost of
   ``Linear.preactivation``'s widening to f32 under grad at vit_base's fc1,
   and one f32 vit_base b4 step on the card (kernels on, TF32 off) against
   the same step on the CPU's plain path: the loss and every updated
   parameter within their stated bounds.

9. Serves through the eval CLI (``cli.eval_imagenet``'s ``build_model`` and
   ``make_step``, seeded uint8 256 px canvases cropped to 224, bf16, full
   width and depth): resnet50 ``--int8`` (BatchNorm folded, every conv and
   the fc int8) at b128, its f32 scores against the CPU's and its bf16
   logits against the unquantized model's; vit_base (LayerNorm affines drawn
   away from 1 and 0) ``--fold-ln`` (f32 against unfolded within 1e-3, then
   b1/8/128 on both fused halves), ``--int8`` (K1 12 and K6 25 launches a
   forward, the halves none) and ``--int8 --int8-act`` (cuBLAS's int8 GEMM
   kernels by profiler name) at b1/8/128; swin_t ``--int8`` at b8 and one
   ten-crop step; ``resize_pos_embed(vit_base, 384)`` (f32 card against CPU,
   b32 bf16 on the halves at 577 tokens); ``get_last_self_attention`` at b8
   against the CPU; vit_base b8 bf16 and resnet50 b8 behind a baked uint8
   preprocess exported, saved, loaded and run, equal to eager, the loaded
   ViT launching the port's kernels (counts and profiler names); and
   ``checked_call`` naming the conv with a planted NaN. Each request's ms
   and images/s beside the card's name and power limit.
10. Trains on several ranks (4 ranks placed by ``parallel.launch.placement``:
   one a card over NCCL with four cards or more, else round-robin on the
   cards over gloo, all four on one card where there is one; the kernels
   built by this process first, which the ranks load): vit_base on a 2
   data x 2 model mesh (every block split, 6 heads a rank), three bf16
   AdamW steps at global b64 with drop path 0.1 and remat, each rank's
   launches asserted (K1 with 6 heads, K6, no fused half); one f32
   vit_base b8 SGD step on the 2 x 2 mesh against the one-card step
   (``check_train_f32``'s bounds, parameters joined by shard); swin_t on
   the 2 x 2 mesh, one bf16 step (K3 on local heads, K6, no whole block or
   half); resnet50 on 4 data ranks with synchronised BatchNorm, three bf16
   SGD steps, then its running statistics from one f32 training forward
   against one card's on the same global batch. Each model's ms a step,
   images/s and peak memory a rank beside the card's name and power limit
   (ranks sharing a card give no multi-card speed). Then the entry point
   ``entry.dryrun_multichip(4)`` on the cards, placed the same way: both
   losses finite. Any rank's failure fails the run.

Every device time read from a profiler trace comes from a trace that holds
the kernels asked for: an empty one is taken again, and fails the run if it
stays empty.

Any failed check raises. The line before the last is a JSON summary of the
kernels; the last line is the JSON result.
"""
import ctypes
import functools
import importlib
import json
import math
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# H100 SXM data sheet: device memory rate, dense peak per input type
# (bf16 on the tensor cores, f32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Matrix products per input type: bf16's tensor-core peak; for f32, the
# least time for products accurate to f32, split TF32's three TF32 products
# at the 495 TFLOP/s TF32 peak (495 / 3), whatever design a kernel takes.
PRODUCT_FLOPS = {torch.bfloat16: 989e12, torch.float32: 165e12}

# bf16 kernel vs the f32 plain version on the same bf16-rounded inputs:
# the bounds of tests/test_hw_parity.py for the TPU kernels.
QKV_BF16_BOUND = 0.02
WINDOW_BF16_BOUND = {False: 0.02, True: 0.12}  # v1, v2 (logit scale up to 100 amplifies q/k rounding)
BLOCK_BF16_BOUND = {False: 0.05, True: 0.12}
# f32 kernel vs f32 plain version. The f32 GEMM of the fused halves and the
# f32 attention stage multiply by split TF32: each operand x is hi + lo,
# both TF32 rounded to nearest, with |x - hi - lo| <= 2^-22 |x|, and each
# product is hi hi + hi lo + lo hi in f32 (lo lo, at most 2^-22 of it, is
# dropped), so a product errs by about 2^-21 of |a| |b|, against 2^-24 for
# an f32 FMA, and a dot product of n terms by about 2^-21 sqrt(n) of its
# terms' magnitude: about 1e-6 on outputs of size ~1 at n = 3072. (The
# tensor cores' accumulator rounds toward zero, a bias that over K = 3072
# reached 1e-4, so the GEMM sums each 32-deep k-tile's products in f32.) The
# other f32 kernels run true f32 FMAs and differ in summation order and
# expf, about 1e-6. The whole block sums four products of up to 768 terms
# and two LayerNorms.
F32_BOUND = 1e-4
# f32 logits on the card vs the CPU's plain path, same weights and input:
# f32 sums in another order on two devices, through 12 blocks whose dot
# products run over up to 3072 terms.
LOGIT_BOUND = 1e-3
# Fused-qkv attention (B, L, heads, head dim): vit_base at b1, b8 and b256; a
# ragged L; vit_base at 384 px (577 tokens: two passes, K and V resident); a
# ragged L above 256 (two blocks of keys); L = 1024 at head dim 128 (K and V
# loaded block by block).
QKV_CASES = [(1, 197, 12, 64), (8, 197, 12, 64), (256, 197, 12, 64), (4, 50, 3, 64), (2, 577, 12, 64),
             (2, 257, 6, 64), (1, 1024, 2, 128)]
SWIN = {  # name: (image size, window, embed dim, heads per stage)
    "swin_t": (224, 7, 96, (3, 6, 12, 24)),
    "swin_v2_t": (256, 8, 96, (3, 6, 12, 24)),
}
SWIN_BATCH = 128
VIT_REQUESTS = (1, 8, 256)
SWIN_REQUESTS = (1, 8, 128)
CONVNEXT_REQUESTS = (1, 8, 128)
RESNET_REQUESTS = (1, 8, 128)
ALEXNET_REQUESTS = (1, 8)
VGG_REQUESTS = (8,)
MOBILE_REQUESTS = (1, 8, 256)  # mobilenet_v3_large and efficientnet_b0: b256 is the JAX bench's batch
ZOO_REQUESTS = (1, 8)
SEG_SIZE, SEG_CHECK_SIZE, SEG_CLASSES = 520, 260, 21
# deeplabv3 and fcn as the JAX bench's deeplabv3_r50_520 row builds them: the
# default taps (layer3, layer4) with the FCN aux head on layer3's 1024 channels
SEG_MODELS = {"deeplabv3": ((1, 8), dict(aux_in_channels=1024)), "fcn": ((8,), dict(aux_in_channels=1024)),
              "lraspp_mobilenet_v3_large": ((8,), {})}
CALIBRATION_BATCH = 16
# resnet50 b128 BatchNorm inputs: stage 1's 3x3 output, stage 1's and stage 4's block outputs
BN_CASES = {"resnet50 b128 layer1 bn2": (128, 56, 56, 64), "resnet50 b128 layer1 bn3": (128, 56, 56, 256),
            "resnet50 b128 layer4 bn3": (128, 7, 7, 2048)}
# LayerNorm (rows, D): vit_base b256 (197 tokens), convnext_tiny b128 stage 1
# (56 x 56) and stage 3 (14 x 14), and the 128-row classifier norm.
LN_CASES = {"vit_base b256": (50432, 768), "convnext_tiny b128 stage 1": (401408, 96),
            "convnext_tiny b128 stage 3": (25088, 384), "classifier b128": (128, 768)}
LN_BF16_BOUND = 0.02  # one bf16 rounding of outputs below 8, against the f32 plain version
# Fused MLP half (rows, C, the residual is x): every convnext_tiny b128
# stage, vit_base b256, convnext_large stage 4 (C = 1536) at b8, a ragged
# row count. Hidden is 4C.
MLP_CASES = {
    "convnext_tiny b128 stage 1": (401408, 96, False), "convnext_tiny b128 stage 2": (100352, 192, False),
    "convnext_tiny b128 stage 3": (25088, 384, False), "convnext_tiny b128 stage 4": (6272, 768, False),
    "vit_base b256": (50432, 768, True), "convnext_large b8 stage 4": (392, 1536, False),
    "ragged": (1000, 192, False),
}
# bf16 kernel vs the f32 plain version on the same bf16-rounded inputs: the
# whole-block v1 bound of tests/test_hw_parity.py, which covers the same
# LayerNorm + MLP + residual chain.
MLP_BF16_BOUND = 0.05
# Fused ViT attention half (B, L, D, heads): vit_base b256; a ragged L above
# 256 (two blocks of 256 keys: the stage's two passes); vit_base at 384 px
# (577 tokens: two passes, K and V resident).
ATTN_HALF_CASES = {"vit_base b256": (256, 197, 768, 12), "ragged": (8, 257, 384, 6),
                   "vit_base 384 px b4": (4, 577, 768, 12)}
# bf16: the whole-block v1 bound, two products around an attention.
ATTN_HALF_BF16_BOUND = 0.05
# Rows shifted by 1e3: the outputs (x plus the branch) lie near 1e3, where
# bf16 rounds to a step of 4 (bound: half of it plus the bf16 bound) and
# f32 to a step of 6.1e-5, to which the row mean itself rounds.
ATTN_HALF_SHIFTED_BOUND = {torch.bfloat16: 2.05, torch.float32: 2e-4}
# Fused Swin v1 attention half (B, map side, C, heads): swin_t stages 3 and
# 4 and swin_b stage 2 at b128 (window 7; the 7 x 7 map is one window, so
# unshifted); a ragged 10 x 10 map, padded to 14 x 14, whose windows hold
# padding tokens. Every one takes the shifted layout where it has one.
WINDOW_HALF_CASES = {"swin_t b128 stage 3": (128, 14, 384, 12), "swin_t b128 stage 4": (128, 7, 768, 24),
                     "swin_b b128 stage 2": (128, 28, 256, 8), "ragged 10 x 10": (8, 10, 384, 12)}
# bf16: the whole-block v1 bound, two products around an attention.
WINDOW_HALF_BF16_BOUND = 0.05
# bf16 GEMMs of the fused halves at the main path's shapes, driven through
# their ops: (GEMM, op case, kernel instantiation <kNormA, kEpi, with the
# row mask>, M, N, K). The op cases are vit_base b256's MLP and attention
# halves, convnext_tiny b128 stage 1's MLP half, and swin_t stage 3's
# attention half at b128 on a ragged 10 x 10 map (windows with padding rows).
GEMM_OPS = {"vit_base b256 MLP": ("mlp", (50432, 768, True)), "vit_base b256 attention": ("attn", (256, 197, 768, 12)),
            "convnext_tiny b128 stage 1 MLP": ("mlp", (401408, 96, False)),
            "swin_t b128 stage 3 attention, ragged 10 x 10": ("window", (128, 10, 384, 12))}
GEMM_CASES = [
    ("fc1 + LayerNorm + gelu", "vit_base b256 MLP", "<true, 1, false,", 50432, 3072, 768),
    ("fc2 + residual", "vit_base b256 MLP", "<false, 2, false,", 50432, 768, 3072),
    ("qkv + LayerNorm", "vit_base b256 attention", "<true, 0, false,", 50432, 2304, 768),
    ("proj + residual", "vit_base b256 attention", "<false, 2, false,", 50432, 768, 768),
    ("fc1 + LayerNorm + gelu", "convnext_tiny b128 stage 1 MLP", "<true, 1, false,", 401408, 384, 96),
    ("fc2 + layer scale + residual", "convnext_tiny b128 stage 1 MLP", "<false, 2, false,", 401408, 96, 384),
    ("qkv + LayerNorm, padding rows masked, rounded bias", "swin_t b128 stage 3 attention, ragged 10 x 10",
     "<true, 3, true,", 25088, 1152, 384),
]
# Training: TRAIN_STEPS bf16 steps a model at b TRAIN_BATCH, uint8 canvases of
# TRAIN_CANVAS px cropped to TRAIN_CROP on the card. Each model: its
# optimiser, learning rate and weight decay, remat, the launches a step (with
# remat the forward's twice) of fused-qkv, window attention, whole block,
# LayerNorm, public attention, MLP half, attention half, Swin attention half,
# and its factory's arguments. vit_base with drop path 0.1: block 0 (drop
# path 0) on the two fused halves, blocks 1-11 on K1 between K6s, the final
# norm on K6. swin_t in training runs every block unfused: K3 in all 12, K6 in
# the 24 block norms, the stem, 3 mergings and the final norm.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CANVAS, TRAIN_CROP = 64, 3, 256, 224
TRAIN = {
    "resnet50": dict(opt="sgd", lr=0.025, weight_decay=1e-4, remat=False, expected=(0,) * 8, ema=True),
    "vit_base": dict(opt="adamw", lr=1e-3, weight_decay=0.05, remat=True, expected=(22, 0, 0, 46, 0, 2, 2, 0),
                     drop_path_rate=0.1),
    "swin_t": dict(opt="adamw", lr=1e-3, weight_decay=0.05, remat=False, expected=(0, 12, 0, 29, 0, 0, 0, 0)),
}
# The backward nodes of the kernels' autograd functions, each of which
# recomputes through the kernel's plain version.
KERNEL_BACKWARDS = ("_FusedQkvAttentionBackward", "_WindowQkvAttentionBackward", "_FusedSwinBlockBackward",
                    "_LayerNormBackward", "_AttentionBackward", "_FusedMlpHalfBackward", "_FusedAttentionHalfBackward",
                    "_FusedWindowAttentionHalfBackward")
# The f32 train step on the card against the CPU: each gradient within 1e-3
# of its tensor's largest, the logit bound's relative size (the same f32 sums
# in another order on two devices, through the same 12 blocks and back).
TRAIN_F32_BATCH, TRAIN_GRAD_BOUND = 4, 1e-3
# Two f32 forwards of one image at other batch sizes (80 crops at once, 8 at
# a time) differ by about 1e-6 of a probability; a random resnet50's ten-crop
# averages lie near 1/1000 and within 1e-4 of each other, so a tie is a gap
# below 1e-5 of the top probability.
EVAL_TIE = 1e-5
# Linear and Conv2d with f32 parameters on a bf16 input, against the same
# function in f64: one rounding of the f32 accumulator plus the bias is at
# most half a bf16 step (taken at magnitude 1 for the smaller outputs), and
# the f32 sum in another order may move a value across a rounding midpoint
# by a few f32 steps.
BIAS_LAYER_STEPS = 0.51


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _time_ms(fn, iters):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _turns(plain, kernel, iters):
    """Mean kernel and plain times over turns plain, kernel, kernel, plain."""
    with torch.inference_mode():
        t = [_time_ms(fn, iters) for fn in (plain, kernel, kernel, plain)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def _bound_ms(n_bytes, flops, dtype, products=True):
    """Least time the card could take: bytes over the memory rate or
    operations over the peak for the type (of matrix products, or of
    elementwise work where ``products`` is false), whichever is larger."""
    peak = (PRODUCT_FLOPS if products else PEAK_FLOPS)[dtype]
    mem, ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (max(mem, ops), "bytes" if mem >= ops else "operations")


def _compare(out, ref, bound, what):
    torch.cuda.synchronize()
    _check(out.shape == ref.shape, f"{what}: shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    _check(bool(torch.isfinite(out).all()), f"{what}: output not finite")
    err = (out.float() - ref.float()).abs().max().item()
    _check(err < bound, f"{what}: max|kernel - plain_f32| {err} >= {bound}")
    return err


def _report(name, shape, dtype, err, bound, ms, plain_ms, turns, extra=""):
    print(
        f"{name} {shape} {str(dtype)[6:]}: max|kernel-plain_f32| {err:.3e} (bound {bound}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (turns plain/kernel/kernel/plain {', '.join(f'{t:.4f}' for t in turns)}){extra}"
    )


def _ptxas_report(log, pattern, name):
    """(kernel, registers, spill bytes) of each kernel in ptxas's report
    whose mangled name matches ``pattern``, named by ``name(match)``."""
    found, kernel, spills = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(pattern, line)
            kernel = None if m is None else name(m)
        elif kernel and "spill stores" in line:
            spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif kernel and "registers" in line:
            found.append((kernel, int(re.search(r"Used (\d+) registers", line).group(1)), spills))
            kernel = None
    return found


def _flag(digit):
    return "true" if digit == "1" else "false"


def _stage_build_report(log):
    """The attention-stage kernels (csrc/attention_stage.cuh), named by their
    template arguments: the wgmma stage's head dim, one pass and bias, the
    CUDA-core stage's type and output columns a lane, the f32 stage's head
    dim rounded up to 16 and cosine mode (Swin v2's, the window entry's)."""
    def name(m):
        if m.group(1) == "wgmma":
            return f"attention_stage_wgmma<{m.group(2)}, {_flag(m.group(3))}, {_flag(m.group(4))}>"
        if m.group(1) == "fma":
            return f"attention_stage_fma<{'float' if m.group(5) == 'f' else 'bf16'}, {m.group(6)}>"
        return f"attention_stage_f32<{m.group(7)}, {_flag(m.group(8))}>"

    return _ptxas_report(
        log, r"attention_stage_(wgmma|fma|f32)I(?:Li(\d+)ELb([01])ELb([01])E|(f|13__nv_bfloat16)Li(\d)E|"
             r"Li(\d+)ELb([01])EE)", name)


WINDOW_MODES = {"0": "K3 v1", "1": "K3 cosine", "2": "K2 rows", "3": "K2 rows, no bias"}


def _window_build_report(log):
    """The window kernels of csrc/window_attention.cu: the window stage by
    type, head dim and mode (K3/K4 v1 or cosine; K2's rows with a bias or
    without), and the bf16 CUDA-core kernel."""
    def name(m):
        if m.group(1):
            kind = "float" if m.group(1) == "f" else "bf16"
            return f"window_stage<{kind}, {m.group(2)}, {WINDOW_MODES[m.group(3)]}>"
        return "window_attention_kernel"

    return _ptxas_report(log, r"window_stageI(f|13__nv_bfloat16)Li(\d+)ELi(\d)E|(window_attention_kernel)E", name)


def check_fused_qkv(attention, lib, log):
    """The attention stage (csrc/attention_stage.cuh) through K1's entry:
    each instantiation's registers and spills from ptxas (a spill in a bf16
    wgmma or an f32 instantiation, or wgmma serialised by ptxas (C7520) in
    a bf16 one, fails the run) and the bf16 design at the cases' shapes;
    then fused_qkv_attention vs its plain version, and at b256 SDPA on the
    same q, k, v in the same type. Returns the b256 bf16 numbers (the shape
    of vit_base's calls)."""
    # K1's source and the attention half's each build the 16 without the bias, the public attention's all 32
    report = sorted(set(_stage_build_report(log)))
    _check(len({k for k, _, _ in report if k.startswith("attention_stage_wgmma")}) == 32,
           f"attention-stage kernels in the build log: {report}")
    for kernel, regs, spills in report:
        print(f"{kernel}: {regs} registers, {spills} bytes of spill stores and loads (ptxas -v)")
    _check(all(spills == 0 for k, _, spills in report if k.startswith(("attention_stage_wgmma", "attention_stage_f32"))),
           "a bf16 wgmma or an f32 attention-stage kernel spills")
    # K1's, the half's and K2's sources build the 8 head dims plain; the window entry's the 4 up to 64 in both modes
    _check(len({k for k, _, _ in report if k.startswith("attention_stage_f32")}) == 12,
           f"f32 attention-stage kernels in the build log: {report}")
    serialised = [line for line in log.splitlines() if "C7520" in line]
    print(f"ptxas C7520 (wgmma serialised) lines: {len(serialised)}")
    _check(not any("attention_stage_wgmma" in line for line in serialised),
           f"ptxas serialises a bf16 attention-stage kernel's wgmma: {serialised}")
    for l, dh in sorted({(l, dh) for _, l, _, dh in QKV_CASES}):
        cfg = (ctypes.c_int * 5)()
        _check(lib.eqx_fused_qkv_attention_config(l, dh, cfg) == 0, f"attention stage config at L {l}, Dh {dh}")
        print(f"attention stage bf16 at L {l}, head dim {dh}: {cfg[0]} blocks an SM, {cfg[1]} bytes of shared "
              f"memory a block, {cfg[2]} key rows of K and V, {'one pass' if cfg[3] else 'two passes'}, "
              f"K and V {'resident' if cfg[4] else 'loaded block by block'}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = None
    for b, l, h, dh in QKV_CASES:
        scale = dh**-0.5
        qkv32 = torch.randn(b, l, 3 * h * dh, device="cuda", generator=gen)
        for dtype, bound in ((torch.bfloat16, QKV_BF16_BOUND), (torch.float32, F32_BOUND)):
            qkv = qkv32.to(dtype)
            with torch.no_grad():
                out = attention.fused_qkv_attention(qkv, h, scale)
                ref = attention.fused_qkv_attention_reference(qkv.float(), h, scale)
            err = _compare(out, ref, bound, f"fused_qkv_attention {(b, l, h, dh)} {dtype}")
            ms, plain_ms, turns = _turns(
                lambda: attention.fused_qkv_attention_reference(qkv, h, scale),
                lambda: attention.fused_qkv_attention(qkv, h, scale), 20,
            )
            extra = ""
            if b == 256:
                q, k, v = qkv.view(b, l, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)
                with torch.inference_mode():
                    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
                e = qkv.element_size()
                bound_ms, bound_by = _bound_ms(4 * b * l * h * dh * e, 4 * b * h * l * l * dh, dtype)
                if dtype == torch.bfloat16:
                    main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=library_ms)
                extra = f"; library (SDPA) {library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})"
            _report("fused_qkv_attention", (b, l, h, dh), dtype, err, bound, ms, plain_ms, turns, extra)
    return main


def _stage_shapes(name):
    """(stage, nW, L, C, H, shifted) of each stage of a Swin model at b128."""
    size, win, dim, heads = SWIN[name]
    side = size // 4
    for s, h in enumerate(heads):
        nw = (-(-side // win)) ** 2
        yield s + 1, nw, win * win, dim * 2**s, h, side > win
        side = -(-side // 2)


def _window_inputs(nw, L, c, h, shifted, v2, dtype, gen):
    """qkv, bias and v2 logit scales as tests/test_hw_parity.py draws them:
    q/k/v of std 0.5 (its x @ W), logit scales 100, 0.02 and 10 by head."""
    qkv = (0.5 * torch.randn(SWIN_BATCH, nw, L, 3 * c, device="cuda", generator=gen)).to(dtype)
    bias = torch.randn(nw if shifted else 1, h, L, L, device="cuda", generator=gen)
    if shifted:
        bias[:, :, : L // 2, L // 2 :] -= 100.0  # a shift mask's -100 between regions
    gs = torch.tensor([100.0, 0.02, 10.0], device="cuda").repeat(h // 3 + 1)[:h] if v2 else None
    return qkv, bias, (1.0 if v2 else (c // h) ** -0.5), gs


WINDOW_PATHS = {0: "the bf16 CUDA-core kernel", 1: "the bf16 window stage (TMA ring, wgmma)",
                2: "the f32 attention stage (split TF32, mma.sync)",
                3: "the f32 window stage (TMA ring, split TF32 on mma.sync)"}
# Non-finite values planted in q or k: the f32 patterns of tests/test_torch_kernels_cuda.py
# (the card's NaN, the CPU's NaN, inf) and their bf16 counterparts.
NON_FINITE_BITS = {torch.float32: {"nan-7fffffff": 0x7FFFFFFF, "nan-7fc00000": 0x7FC00000, "inf": 0x7F800000},
                   torch.bfloat16: {"nan-7fff": 0x7FFF, "nan-7fc0": 0x7FC0, "inf": 0x7F80}}


def _device_ms(fn, names=None, iters=10):
    """Device time of one call of ``fn`` (torch.profiler, mean over ``iters``
    calls): its CUDA kernels whose names hold one of ``names``, or all of
    them. Fails where the trace holds no such kernel after
    ``_device_kernels``' retries: an empty trace is no measurement."""
    kernels = _device_kernels(fn, iters, names)
    _check(bool(kernels), f"the profiler saw no kernel{'' if names is None else f' named like {names}'} in "
                          f"{iters + 1} calls, three times")
    return sum(kernels.values())


def _window_f64(qkv, bias, h, scale, gs=None):
    """window_qkv_attention's function in f64: the f32 kernels' yardstick
    (the plain version computes in f32)."""
    b, nw, L, three_c = qkv.shape
    c = three_c // 3
    q, k, v = qkv.double().view(b, nw, L, 3, h, c // h).permute(3, 0, 1, 4, 2, 5).unbind(0)
    if gs is not None:
        q = F.normalize(q, dim=-1, eps=1e-12) * gs.double().view(h, 1, 1)
        k = F.normalize(k, dim=-1, eps=1e-12)
    s = q @ k.transpose(-1, -2) * scale + bias.double()
    return (torch.softmax(s, dim=-1) @ v).transpose(2, 3).reshape(b, nw, L, c)


def _window_yardstick(attention, qkv, bias, h, scale, gs):
    """The plain version at the kernel's bound: f32 for a bf16 kernel, f64 for an f32 one."""
    if qkv.dtype == torch.float32:
        return _window_f64(qkv, bias, h, scale, gs)
    return attention.window_qkv_attention_reference(qkv.float(), bias, h, scale, gs)


def check_window_attention(attention, lib, log):
    """window_qkv_attention (csrc/window_attention.cu): the window stage's and
    the f32 stage's cosine kernels' registers and spills from ptxas (a spill
    in a window-stage kernel, or its wgmma serialised by ptxas (C7520), fails
    the run); then at every stage shape of swin_t and swin_v2_t at b128, in
    bf16 and f32, the path each takes, the kernel against its plain version
    (bf16: the plain version in f32; f32: in f64), both timed in turns by
    CUDA events (where a kernel is shorter than the wrapper's host cost a
    call, the events read the host), the kernel's device time by
    torch.profiler, and SDPA on the same q, k, v with the bias as a float
    mask laid out before the call (v2: q and k normalised and q scaled
    before the call), events and device time, with the bound; a head 300
    log-units down; qkv as the front rows of a buffer whose
    later rows hold NaN; NaN and inf planted in one row of one window's q and
    of its k. Returns swin_t stage 3 bf16's numbers."""
    report = sorted(set(_window_build_report(log)) |
                    {r for r in _stage_build_report(log) if r[0].startswith("attention_stage_f32") and "true" in r[0]})
    for kernel, regs, spills in report:
        print(f"{kernel}: {regs} registers, {spills} bytes of spill stores and loads (ptxas -v)")
    # bf16 at head dims 16, 32, 48 and 64, f32 at 16 and 32, each in four modes
    _check(len({k for k, _, _ in report if k.startswith("window_stage<")}) == 24,
           f"window-stage kernels in the build log: {report}")
    _check(all(spills == 0 for k, _, spills in report if k.startswith("window_stage<")),
           "a window-stage kernel spills")
    serialised = [line for line in log.splitlines() if "C7520" in line and "window_stage" in line]
    _check(not serialised, f"ptxas serialises a window-stage kernel's wgmma: {serialised}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    main = None
    for name in SWIN:
        v2 = name.startswith("swin_v2")
        for stage, nw, L, c, h, shifted in _stage_shapes(name):
            n = SWIN_BATCH * nw
            for dtype in (torch.bfloat16, torch.float32):
                qkv, bias, scale, gs = _window_inputs(nw, L, c, h, shifted, v2, dtype, gen)
                bound = WINDOW_BF16_BOUND[v2] if dtype == torch.bfloat16 else F32_BOUND
                cfg = (ctypes.c_int * 5)()
                _check(lib.eqx_window_attention_config(L, c // h, int(dtype == torch.bfloat16), int(v2), n * h, cfg)
                       == 0, f"window attention config {name} stage {stage}")
                path = WINDOW_PATHS[cfg[0]]
                if cfg[0] in (1, 3):
                    path += (f": {cfg[3]} blocks of {-(-n * h // cfg[3])} tiles or fewer, {cfg[1]} an SM, {cfg[2]} "
                             f"bytes of shared memory a block, a ring of {cfg[4]}")
                _check(cfg[0] == (1 if dtype == torch.bfloat16 else 3), f"{name} stage {stage} {dtype}: path {path}")
                with torch.no_grad():
                    out = attention.window_qkv_attention(qkv, bias, h, scale, gs)
                    ref = _window_yardstick(attention, qkv, bias, h, scale, gs)
                what = f"window_qkv_attention {name} stage {stage}"
                err = _compare(out, ref, bound, f"{what} {dtype}")
                del ref
                ms, plain_ms, turns = _turns(
                    lambda: attention.window_qkv_attention_reference(qkv, bias, h, scale, gs),
                    lambda: attention.window_qkv_attention(qkv, bias, h, scale, gs), 10,
                )
                q, k, v = (t.contiguous() for t in qkv.view(n, L, 3, h, c // h).permute(2, 0, 3, 1, 4).unbind(0))
                if v2:
                    q = (F.normalize(q.float(), dim=-1) * gs.view(h, 1, 1)).to(dtype)
                    k = F.normalize(k.float(), dim=-1).to(dtype)
                mask = bias.to(dtype).expand(SWIN_BATCH, nw, h, L, L).reshape(n, h, L, L)
                sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)  # noqa: E731
                with torch.inference_mode():
                    library_ms = _time_ms(sdpa, 10)
                device_ms = _device_ms(lambda: attention.window_qkv_attention(qkv, bias, h, scale, gs),
                                       ("window_stage", "window_attention_kernel", "attention_stage_f32"))
                library_device_ms = _device_ms(sdpa)
                del q, k, v, mask
                e = qkv.element_size()
                n_bytes = qkv.numel() * e + out.numel() * e + bias.numel() * 4
                bound_ms, bound_by = _bound_ms(n_bytes, 4 * n * h * L * L * (c // h), dtype)
                if (name, stage, dtype) == ("swin_t", 3, torch.bfloat16):
                    main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=library_ms)
                _report(what, (SWIN_BATCH, nw, L, c, h), dtype, err, bound, ms, plain_ms, turns,
                        f"; kernel device time {device_ms:.4f} ms (profiler); library (SDPA, float mask"
                        f"{', q and k normalised' if v2 else ''}, laid out before the call) {library_ms:.4f} ms, device "
                        f"{library_device_ms:.4f}; bound {bound_ms:.4f} ms ({bound_by}); path: {path}")

    for dtype, bound in ((torch.bfloat16, WINDOW_BF16_BOUND[False]), (torch.float32, F32_BOUND)):
        # a head biased 300 log-units below the others: finite, and equal to the plain version
        qkv, bias, scale, gs = _window_inputs(4, 49, 384, 12, True, False, dtype, gen)
        bias[:, 5] -= 300.0
        with torch.no_grad():
            out = attention.window_qkv_attention(qkv, bias, 12, scale)
            err = _compare(out, _window_yardstick(attention, qkv, bias, 12, scale, None), bound,
                           f"window_qkv_attention, head 300 below, {dtype}")
        print(f"window_qkv_attention {str(dtype)[6:]} with one head 300 log-units below the others: finite, "
              f"max|diff| {err:.3e} (bound {bound})")
        # qkv as the front rows of a larger buffer whose later rows hold NaN: no row past the last window is read
        rows = qkv.numel() // qkv.shape[-1]
        buf = torch.full((rows + 4096, qkv.shape[-1]), float("nan"), device="cuda", dtype=dtype)
        buf[:rows] = qkv.view(rows, -1)
        front = buf[:rows].view(qkv.shape)
        with torch.no_grad():
            err = _compare(attention.window_qkv_attention(front, bias, 12, scale),
                           _window_yardstick(attention, qkv, bias, 12, scale, None), bound,
                           f"window_qkv_attention, NaN rows after the windows, {dtype}")
        print(f"window_qkv_attention {str(dtype)[6:]} on the front rows of a buffer whose later rows hold NaN: "
              f"finite, max|diff| {err:.3e} (bound {bound})")
        del buf, front
        # NaN or inf in one row of image 1, window 2's q (reaches that row of head 2) or k (all of that window's
        # head 2)
        for operand, col in (("q", 0), ("k", 384)):
            for bits_name, bits in NON_FINITE_BITS[dtype].items():
                x = qkv.clone()
                x.view(torch.int32 if dtype == torch.float32 else torch.int16)[1, 2, 7, col + 2 * 32 + 3] = bits
                with torch.no_grad():
                    out = attention.window_qkv_attention(x, bias, 12, scale)
                    ref = _window_yardstick(attention, x, bias, 12, scale, None)
                torch.cuda.synchronize()
                reach = torch.zeros_like(out, dtype=torch.bool)
                reach[1, 2, (7 if operand == "q" else slice(None)), 64:96] = True
                bad, got = ~torch.isfinite(ref), ~torch.isfinite(out)
                _check(bool(bad.any()) and bool(got[bad].all()),
                       f"window_qkv_attention {dtype} {bits_name} in {operand}: a non-finite plain output came out finite")
                _check(not bool(got[~reach].any()), f"window_qkv_attention {dtype} {bits_name} in {operand}: "
                       f"non-finite outputs outside the (window, head) it reaches")
                err = (out[~reach].double() - ref[~reach].double()).abs().max().item()
                _check(err < bound, f"window_qkv_attention {dtype} {bits_name} in {operand}: max|diff| {err}")
                print(f"window_qkv_attention {str(dtype)[6:]} with {bits_name} in a row of {operand}: non-finite at "
                      f"{int(got.sum())} outputs (plain version {int(bad.sum())}, reachable {int(reach.sum())}), "
                      f"the rest within {err:.3e}")
    return main


def _block_inputs(c, h, nw, L, shifted, v2, dtype, gen, W):
    def r(*shape, s=0.1, base=0.0):
        return base + s * torch.randn(*shape, device="cuda", generator=gen)

    hidden = 4 * c
    # weights at the models' init scale, 1/sqrt(fan_in) up to a constant
    p = W.SwinBlockParams(
        r(c, base=1.0), r(c), r(3 * c, c, s=c**-0.5).to(dtype), r(3 * c), r(c, c, s=c**-0.5).to(dtype), r(c),
        r(c, base=1.0), r(c), r(hidden, c, s=c**-0.5).to(dtype), r(hidden), r(c, hidden, s=hidden**-0.5).to(dtype), r(c),
    )
    x = r(SWIN_BATCH, nw, L, c, s=0.5).to(dtype)
    bias = torch.randn(nw if shifted else 1, h, L, L, device="cuda", generator=gen)
    if shifted:
        bias[:, :, : L // 2, L // 2 :] -= 100.0
    # v2: the init logit scale 10, the case tests/test_hw_parity.py bounds for the whole block
    gs = torch.full((h,), 10.0, device="cuda") if v2 else None
    return x, p, bias, gs


def _map_block_inputs(c, h, side, win, v2, dtype, gen):
    """The NHWC entry's keywords at a stage: weights at the models' init
    scale, a relative-position bias of std 1, v2's logit scale 10."""
    def r(*shape, s=0.1, base=0.0):
        return base + s * torch.randn(*shape, device="cuda", generator=gen)

    hidden = 4 * c
    kw = dict(
        norm1_w=r(c, base=1.0), norm1_b=r(c), qkv_weight=r(3 * c, c, s=c**-0.5).to(dtype), qkv_bias=r(3 * c),
        proj_weight=r(c, c, s=c**-0.5).to(dtype), proj_bias=r(c), norm2_w=r(c, base=1.0), norm2_b=r(c),
        fc1_weight=r(hidden, c, s=c**-0.5).to(dtype), fc1_bias=r(hidden),
        fc2_weight=r(c, hidden, s=hidden**-0.5).to(dtype), fc2_bias=r(c),
        relative_position_bias=r(1, h, win * win, win * win, s=1.0),
    )
    if v2:
        kw["qkv_bias"][c : 2 * c] = 0.0
        kw["logit_scale"] = torch.full((h, 1, 1), math.log(10.0), device="cuda")
    return r(SWIN_BATCH, side, side, c, s=0.5).to(dtype), kw


def _block_build_report(log):
    """The whole-block kernels, named by their template arguments (proj
    width, cosine attention), and the f32 path's split of the weights."""
    return _ptxas_report(log, r"swin_block_(bf16|f32)_kernelILi(\d+)ELb([01])E|split_weights_kernel",
                         lambda m: "split_weights_kernel" if m.group(1) is None
                         else f"swin_block_{m.group(1)}_kernel<{m.group(2)}, {_flag(m.group(3))}>")


def _block_reference(W, x, p, bias, h, scale, v2, gs):
    """The block's plain version on windows: in f32 for a bf16 x, in f64 for
    an f32 x (the f32 kernel's yardstick)."""
    t = torch.float64 if x.dtype == torch.float32 else torch.float32
    return W.fused_swin_block_reference(x.to(t), W.SwinBlockParams(*(q.to(t) for q in p)), bias.to(t), h, scale,
                                        1e-5, v2, None if gs is None else gs.to(t))


def check_block(W, log):
    """The whole-block kernel. On (N, nW, L, C) windows against its plain
    version at the whole-block stages (C <= 192) of swin_t and swin_v2_t at
    b128, bf16 (against the plain version in f32) and f32 (in f64), a head
    300 log-units down, and NaN and inf through the f32 kernel. Then the
    NHWC entry (fused_swin_block_v1/_v2: one launch that reads the windows
    from the map) at the same four stage shapes, bf16 and f32: against the
    plain path on the same map (f32 for bf16, f64 for f32), and timed in
    turns against that plain path in the input's type (pad, roll, partition,
    the block on windows, and back) beside its bound; with each design's
    windows per block (G), weight stages and blocks per SM, and each
    instantiation's registers and spills from ptxas. Returns swin_t stage 1
    bf16's numbers."""
    from eqxvision_tpu_torch import _native

    report = sorted(set(_block_build_report(log)))
    _check(len(report) == 13, f"whole-block kernels in the build log: {report}")
    for kernel, regs, spills in report:
        print(f"{kernel}: {regs} registers, {spills} bytes of spill stores and loads (ptxas -v)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name in SWIN:
        v2 = name.startswith("swin_v2")
        for stage, nw, L, c, h, shifted in _stage_shapes(name):
            if c > W.BLOCK_MAX_CHANNELS:
                continue
            for dtype in (torch.bfloat16, torch.float32):
                x, p, bias, gs = _block_inputs(c, h, nw, L, shifted, v2, dtype, gen, W)
                scale = 1.0 if v2 else (c // h) ** -0.5
                bound = BLOCK_BF16_BOUND[v2] if dtype == torch.bfloat16 else F32_BOUND
                with torch.no_grad():
                    out = W.fused_swin_block(x, p, bias, h, scale, 1e-5, v2, gs)
                    ref = _block_reference(W, x, p, bias, h, scale, v2, gs)
                err = _compare(out, ref, bound, f"fused_swin_block windows {name} stage {stage} {dtype}")
                what = f"fused_swin_block on windows {name} stage {stage}"
                if (name, stage, dtype) != ("swin_t", 1, torch.float32):
                    print(f"{what} {(SWIN_BATCH, nw, L, c, h)} {str(dtype)[6:]}: max|kernel-plain| {err:.3e} "
                          f"(plain in {'f32' if dtype == torch.bfloat16 else 'f64'}; bound {bound})")
                    continue
                # the f32 kernel's time (the NHWC entry below is bf16's)
                ms, plain_ms, turns = _turns(
                    lambda: W.fused_swin_block_reference(x, p, bias, h, scale, 1e-5, v2, gs),
                    lambda: W.fused_swin_block(x, p, bias, h, scale, 1e-5, v2, gs), 5)
                tokens, hidden = x.numel() // c, 4 * c
                n_bytes = 2 * x.numel() * 4 + (4 * c * c + 2 * c * hidden) * 4 + bias.numel() * 4
                flops = 2 * tokens * (4 * c * c + 2 * c * hidden) + 4 * SWIN_BATCH * nw * L * L * c
                bound_ms, bound_by = _bound_ms(n_bytes, flops, dtype)
                _report(what + " (kernel vs plain in f64)", (SWIN_BATCH, nw, L, c, h), dtype, err, bound, ms,
                        plain_ms, turns,
                        f"; bound {bound_ms:.4f} ms ({bound_by})")

    for dtype, bound in ((torch.bfloat16, BLOCK_BF16_BOUND[False]), (torch.float32, F32_BOUND)):
        x, p, bias, gs = _block_inputs(96, 3, 64, 49, True, False, dtype, gen, W)
        bias[:, 1] -= 300.0
        with torch.no_grad():
            out = W.fused_swin_block(x, p, bias, 3, 32**-0.5)
            ref = _block_reference(W, x, p, bias, 3, 32**-0.5, False, None)
            err = _compare(out, ref, bound, f"fused_swin_block, head 300 below, {dtype}")
        print(f"fused_swin_block {str(dtype)[6:]} with one head 300 log-units below the others: finite, "
              f"max|diff| {err:.3e} (bound {bound})")

    # NaN and inf through the f32 kernel (split TF32 keeps them in hi): the
    # card's NaN and an inf in one token of a window of image 1, the CPU's
    # NaN in one weight of fc2 (v1) and of qkv (v2); the output is
    # non-finite wherever the f64 plain version is, within the bound elsewhere
    for v2, where, bits in ((False, "x", 0x7FFFFFFF), (True, "x", 0x7F800000), (False, "fc2_w", 0x7FC00000),
                            (True, "qkv_w", 0x7FC00000)):
        L = 64 if v2 else 49
        x, p, bias, gs = _block_inputs(96, 3, 64, L, True, v2, torch.float32, gen, W)
        target = x[1, 3, 10] if where == "x" else getattr(p, where)[2]
        target.view(torch.int32)[5] = bits
        scale = 1.0 if v2 else 32**-0.5
        with torch.no_grad():
            out = W.fused_swin_block(x, p, bias, 3, scale, 1e-5, v2, gs)
            ref = _block_reference(W, x, p, bias, 3, scale, v2, gs)
        torch.cuda.synchronize()
        bad = ~torch.isfinite(ref)
        _check(bool(bad.any()) and bool((~torch.isfinite(out))[bad].all()),
               f"fused_swin_block f32 {'v2' if v2 else 'v1'} {where} {bits:#x}: finite where the plain version is not")
        clean = torch.isfinite(ref)  # none where the value reaches every token (a v2 weight)
        err = (out.double() - ref)[clean].abs().max().item() if bool(clean.any()) else 0.0
        _check(err < F32_BOUND, f"fused_swin_block f32 {where} {bits:#x}: clean outputs off by {err}")
        print(f"fused_swin_block f32 {'v2' if v2 else 'v1'} with {bits:#010x} in {where}: non-finite on "
              f"{int(bad.sum())} outputs where f64 is ({int((~torch.isfinite(out)).sum())} in all), "
              f"max|diff| elsewhere {err:.3e} (bound {F32_BOUND})")

    lib = _native.library()
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        for name in SWIN:
            size, win, dim, heads = SWIN[name]
            v2 = name.startswith("swin_v2")
            fn = W.fused_swin_block_v2 if v2 else W.fused_swin_block_v1
            side = size // 4
            for stage, h in enumerate(heads, 1):
                c = dim * 2 ** (stage - 1)
                if c > W.BLOCK_MAX_CHANNELS:
                    break
                shift = win // 2 if side > win else 0
                geometry = dict(window_size=(win, win), shift_size=(shift, shift), num_heads=h)
                x, kw = _map_block_inputs(c, h, side, win, v2, dtype, gen)
                ref_type = torch.float64 if f32 else torch.float32
                kw_ref = {k: v.to(ref_type) for k, v in kw.items()}
                with torch.no_grad():
                    out = fn(x, **kw, **geometry)
                    ref = W._block_map_reference(
                        x.to(ref_type), *_map_reference_args(W, kw_ref, c, h, win, shift, side, v2))
                bound = F32_BOUND if f32 else BLOCK_BF16_BOUND[v2]
                err = _compare(out, ref, bound, f"fused_swin_block NHWC {name} stage {stage} {dtype}")
                plain_args = _map_reference_args(W, kw, c, h, win, shift, side, v2)
                ms, plain_ms, turns = _turns(lambda: W._block_map_reference(x, *plain_args),
                                             lambda: fn(x, **kw, **geometry), 10)
                tokens, hidden, L = x.numel() // c, 4 * c, win * win
                n_windows = SWIN_BATCH * (-(-side // win)) ** 2
                bias_rows = (-(-side // win)) ** 2 if shift else 1
                e = x.element_size()
                n_bytes = ((2 * x.numel() + (4 * c * c + 2 * c * hidden)) * e + bias_rows * h * L * L * 4
                           + (9 * c + hidden) * 4)
                # the products on this run's tokens, and the attention on its windows of L tokens
                flops = 2 * tokens * (4 * c * c + 2 * c * hidden) + 4 * n_windows * L * L * c
                bound_ms, bound_by = _bound_ms(n_bytes, flops, dtype)
                info = (ctypes.c_int * 4)()
                config = lib.eqx_swin_block_f32_config if f32 else lib.eqx_swin_block_config
                _native.check(config(c, h, info), "eqx_swin_block_config")
                extra = (f"; bound {bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB); "
                         f"G = {info[0]} windows a block, {info[1]} weight stages, {info[2]} bytes of shared memory, "
                         f"{info[3]} block(s) per SM")
                _report(f"fused_swin_block NHWC {name} stage {stage} (plain: pad, roll, partition, block, back; "
                        f"kernel vs plain in {'f64' if f32 else 'f32'})",
                        (SWIN_BATCH, side, side, c, h), dtype, err, bound, ms, plain_ms, turns, extra)
                if (name, stage, dtype) == ("swin_t", 1, torch.bfloat16):
                    main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=None)
                side = -(-side // 2)
    print("fused_swin_block library_ms: null; no single PyTorch call computes a whole Swin block")
    return main


def _map_reference_args(W, kw, c, h, win, shift, side, v2):
    """The positional arguments after x of the plain NHWC path
    (``W._block_map_reference``) for the entry's keywords."""
    qkv_bias = W._v2_qkv_bias(kw["qkv_bias"], c) if v2 else kw["qkv_bias"]
    params = W.SwinBlockParams(kw["norm1_w"], kw["norm1_b"], kw["qkv_weight"], qkv_bias, kw["proj_weight"],
                               kw["proj_bias"], kw["norm2_w"], kw["norm2_b"], kw["fc1_weight"], kw["fc1_bias"],
                               kw["fc2_weight"], kw["fc2_bias"])
    geo = W.window_geometry(side, side, (win, win), (shift, shift))
    bias = W._window_bias(kw["relative_position_bias"], (win, win), h, geo)
    gs = W._cosine_gs(kw["logit_scale"], h) if v2 else None
    scale = 1.0 if v2 else (c // h) ** -0.5
    return (bias, gs, *params, h, scale, 1e-5, v2, (win, win), (shift, shift))


def _ln_inputs(rows, d, dtype, gen, shift=0.0, affine=True):
    """x of std 2 (plus ``shift``); weights in [0.5, 1] and biases of std
    0.2 in the input's type, as a bf16 model holds its LayerNorm parameters.
    The outputs stay below 8, where one bf16 step is at most 2**-5, within
    LN_BF16_BOUND of the f32 plain version after one rounding."""
    x = (shift + 2.0 * torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    if not affine:
        return x, None, None
    w = (0.5 + 0.5 * torch.rand(d, device="cuda", generator=gen)).to(dtype)
    return x, w, (0.2 * torch.randn(d, device="cuda", generator=gen)).to(dtype)


def check_layer_norm(LN):
    """layer_norm kernel vs its plain version at the shapes of the ViT and
    ConvNeXt paths, bf16 and f32, with and without affine, and rows shifted
    by 1e3; returns convnext_tiny stage 1 bf16's numbers. The f32 kernel is
    held against the plain version in f64, so that its own f32 sums are the
    only error; the bf16 one against the plain version in f32."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    main = None
    cases = [(name, shape, 0.0, True) for name, shape in LN_CASES.items()]
    cases += [("convnext_tiny b128 stage 3, rows shifted by 1e3", LN_CASES["convnext_tiny b128 stage 3"], 1e3, True),
              ("vit_base b256, no affine", LN_CASES["vit_base b256"], 0.0, False)]
    for name, (rows, d), shift, affine in cases:
        for dtype, bound in ((torch.bfloat16, LN_BF16_BOUND), (torch.float32, F32_BOUND)):
            x, w, b = _ln_inputs(rows, d, dtype, gen, shift, affine)
            wide = torch.float64 if dtype == torch.float32 else torch.float32
            with torch.no_grad():
                out = LN.layer_norm(x, w, b, 1e-6)
                ref = LN.layer_norm_reference(x.to(wide), *(None if t is None else t.to(wide) for t in (w, b)), 1e-6)
            err = _compare(out, ref, bound, f"layer_norm {name} {dtype}")
            ms, plain_ms, turns = _turns(
                lambda: LN.layer_norm_reference(x, w, b, 1e-6), lambda: LN.layer_norm(x, w, b, 1e-6), 20,
            )
            with torch.inference_mode():
                library_ms = _time_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-6), 20)
            e = x.element_size()
            n_bytes = 2 * x.numel() * e + (0 if w is None else 2 * d * e)
            # f32 arithmetic on the CUDA cores whatever the input type
            bound_ms, bound_by = _bound_ms(n_bytes, 8 * x.numel(), torch.float32, products=False)
            if (name, dtype) == ("convnext_tiny b128 stage 1", torch.bfloat16):
                main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms)
            _report(f"layer_norm {name}", (rows, d), dtype, err, bound, ms, plain_ms, turns,
                    f"; library (F.layer_norm) {library_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    return main


def _mlp_inputs(rows, c, residual_is_x, dtype, gen, shift=0.0):
    """x of std 1 (plus ``shift``), a residual of std 1, LayerNorm affine
    near (1, 0), weights at the models' init scale (1/sqrt(fan_in)) and a
    layer scale of 0.5 where the residual is not x (ConvNeXt), all in the
    input's type, as a bf16 model holds them."""
    hidden = 4 * c

    def r(*shape, s=1.0, base=0.0):
        return (base + s * torch.randn(*shape, device="cuda", generator=gen)).to(dtype)

    x = r(rows, c, base=shift)
    residual = x if residual_is_x else r(rows, c)
    params = (r(c, s=0.1, base=1.0), r(c, s=0.1), r(hidden, c, s=c**-0.5), r(hidden, s=0.1),
              r(c, hidden, s=hidden**-0.5), r(c, s=0.1), None if residual_is_x else r(c, s=0.1, base=0.5))
    return x, residual, params


def _mlp_composition(x, residual, lnw, lnb, w1, b1, w2, b2, ls, eps=1e-6):
    """The unfused torch composition the op replaces, in x's type."""
    y = F.linear(F.gelu(F.linear(F.layer_norm(x, (x.shape[-1],), lnw, lnb, eps), w1, b1)), w2, b2)
    return residual + (y if ls is None else y * ls)


def check_mlp_half(M):
    """fused_mlp_half kernel vs its plain version at the shapes of the
    ConvNeXt and ViT paths, bf16 and f32, with rows shifted by 1e3 and a
    ragged row count; beside it the unfused torch composition (a reference:
    no single PyTorch call computes this function). The f32 kernel is held
    against the plain version in f64, so that its own f32 sums are the only
    error; the bf16 one against the plain version in f32. Returns vit_base
    b256 bf16's numbers."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    main = None
    cases = [(name, case, 0.0) for name, case in MLP_CASES.items()]
    cases.append(("convnext_tiny b128 stage 3, x shifted by 1e3", MLP_CASES["convnext_tiny b128 stage 3"], 1e3))
    for name, (rows, c, residual_is_x), shift in cases:
        for dtype, bound in ((torch.bfloat16, MLP_BF16_BOUND), (torch.float32, F32_BOUND)):
            x, residual, params = _mlp_inputs(rows, c, residual_is_x, dtype, gen, shift)
            wide = torch.float64 if dtype == torch.float32 else torch.float32
            with torch.no_grad():
                out = M.fused_mlp_half(x, residual, *params)
                ref = M.mlp_half_reference(x.to(wide), residual.to(wide),
                                           *(None if t is None else t.to(wide) for t in params))
            err = _compare(out, ref, bound, f"fused_mlp_half {name} {dtype}")
            iters = 10 if dtype == torch.bfloat16 else 2
            ms, plain_ms, turns = _turns(
                lambda: M.mlp_half_reference(x, residual, *params), lambda: M.fused_mlp_half(x, residual, *params),
                iters,
            )
            with torch.inference_mode():
                composition_ms = _time_ms(lambda: _mlp_composition(x, residual, *params), iters)
            e = x.element_size()
            n_bytes = (2 if residual_is_x else 3) * x.numel() * e + sum(t.numel() * e for t in params if t is not None)
            bound_ms, bound_by = _bound_ms(n_bytes, 4 * rows * c * 4 * c, dtype)
            if (name, dtype) == ("vit_base b256", torch.bfloat16):
                main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None)
            _report(f"fused_mlp_half {name}", (rows, c, 4 * c), dtype, err, bound, ms, plain_ms, turns,
                    f"; reference: unfused torch composition {composition_ms:.4f} ms; "
                    f"bound {bound_ms:.4f} ms ({bound_by})")
    print("fused_mlp_half library_ms: null; no single PyTorch call computes the MLP half")
    return main


def _attn_half_inputs(b, l, d, dtype, gen, shift=0.0, qkv_bias=True):
    """x of std 1 (plus ``shift``), LayerNorm affine near (1, 0) and weights
    at the models' init scale (1/sqrt(fan_in)), all in the input's type, as
    a bf16 model holds them."""

    def r(*shape, s=1.0, base=0.0):
        return (base + s * torch.randn(*shape, device="cuda", generator=gen)).to(dtype)

    params = (r(d, s=0.1, base=1.0), r(d, s=0.1), r(3 * d, d, s=d**-0.5), r(3 * d, s=0.1) if qkv_bias else None,
              r(d, d, s=d**-0.5), r(d, s=0.1))
    return r(b, l, d, base=shift), params


def _attn_half_qkv(x, lnw, lnb, wqkv, bqkv, heads):
    """q, k and v (B, H, L, Dh) as views of the unfused composition's qkv."""
    b, l, d = x.shape
    qkv = F.linear(F.layer_norm(x, (d,), lnw, lnb, 1e-6), wqkv, bqkv)
    return qkv.view(b, l, 3, heads, d // heads).permute(2, 0, 3, 1, 4).unbind(0)


def _attn_half_composition(x, lnw, lnb, wqkv, bqkv, wproj, bproj, heads):
    """The unfused torch composition the op replaces, in x's type, with SDPA
    as its attention."""
    b, l, d = x.shape
    o = F.scaled_dot_product_attention(*_attn_half_qkv(x, lnw, lnb, wqkv, bqkv, heads))
    return x + F.linear(o.transpose(1, 2).reshape(b, l, d), wproj, bproj)


def check_attention_half(AH):
    """fused_attention_half kernel vs its plain version at vit_base's
    shapes, a ragged L above 256 and 577 tokens, bf16 and f32, plus no qkv
    bias and rows shifted by 1e3; beside it the unfused torch composition
    (a reference: no single PyTorch call computes this function) and, at
    vit_base b256 in both types, SDPA on the same qkv (the attention stage's
    yardstick).
    The f32 kernel is held against the plain version in f64, the bf16 one
    against the plain version in f32. Returns vit_base b256 bf16's numbers."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(8)
    main = None
    cases = [(name, case, 0.0, True) for name, case in ATTN_HALF_CASES.items()]
    cases += [("ragged, no qkv bias", ATTN_HALF_CASES["ragged"], 0.0, False),
              ("ragged, x shifted by 1e3", ATTN_HALF_CASES["ragged"], 1e3, True)]
    for name, (b, l, d, heads), shift, qkv_bias in cases:
        for dtype in (torch.bfloat16, torch.float32):
            bound = (ATTN_HALF_SHIFTED_BOUND[dtype] if shift else
                     ATTN_HALF_BF16_BOUND if dtype == torch.bfloat16 else F32_BOUND)
            x, params = _attn_half_inputs(b, l, d, dtype, gen, shift, qkv_bias)
            wide = torch.float64 if dtype == torch.float32 else torch.float32
            scale = (d // heads) ** -0.5
            with torch.no_grad():
                out = AH.fused_attention_half(x, *params, heads)
                ref = AH.attention_half_reference(x.to(wide), *(None if t is None else t.to(wide) for t in params),
                                                  heads, scale)
            err = _compare(out, ref, bound, f"fused_attention_half {name} {dtype}")
            iters = 10 if dtype == torch.bfloat16 else 2
            ms, plain_ms, turns = _turns(
                lambda: AH.attention_half_reference(x, *params, heads, scale),
                lambda: AH.fused_attention_half(x, *params, heads), iters,
            )
            with torch.inference_mode():
                composition_ms = _time_ms(lambda: _attn_half_composition(x, *params, heads), iters)
            e = x.element_size()
            n_bytes = 2 * x.numel() * e + sum(t.numel() * e for t in params if t is not None)
            flops = 2 * b * l * d * 4 * d + 4 * b * l * l * d
            bound_ms, bound_by = _bound_ms(n_bytes, flops, dtype)
            extra = ""
            if name == "vit_base b256":
                with torch.inference_mode():
                    q, k, v = _attn_half_qkv(x, *params[:4], heads)
                    sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters)
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(iters):
                            AH.fused_attention_half(x, *params, heads)
                        torch.cuda.synchronize()
                stage_ms = sum(e.device_time_total for e in prof.key_averages()
                               if "attention_stage" in e.key) / 1e3 / iters
                _check(stage_ms > 0, "fused_attention_half: no attention-stage kernel in the profile")
                if dtype == torch.bfloat16:
                    main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=None)
                extra = (f"; its attention stage {stage_ms:.4f} ms of device time (torch.profiler), SDPA alone on "
                         f"the same qkv {sdpa_ms:.4f} ms")
            _report(f"fused_attention_half {name}", (b, l, d, heads), dtype, err, bound, ms, plain_ms, turns,
                    f"; reference: unfused torch composition with SDPA {composition_ms:.4f} ms; "
                    f"bound {bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB){extra}")
    print("fused_attention_half library_ms: null; no single PyTorch call computes the attention half")
    return main


def _window_half_inputs(b, side, c, heads, dtype, gen, W, WH):
    """Windows of an NHWC map of std 1 (padded, shifted by half a window
    where the map has more than one, partitioned), the window bias (a
    relative-position bias plus the shift mask), the padding flags, and
    LayerNorm affine near (1, 0) and weights at the models' init scale, all
    in the input's type, as a bf16 model holds them."""

    def r(*shape, s=1.0, base=0.0):
        return (base + s * torch.randn(*shape, device="cuda", generator=gen)).to(dtype)

    win = (7, 7)
    x, geo = W._to_windows(r(b, side, side, c), win, (3, 3))
    rel = torch.randn(1, heads, 49, 49, device="cuda", generator=gen)
    bias = W._window_bias(rel, win, heads, geo)
    valid = WH._valid_rows_on(x.device, geo, *win)
    params = (r(c, s=0.1, base=1.0), r(c, s=0.1), r(3 * c, c, s=c**-0.5), r(3 * c, s=0.1), r(c, c, s=c**-0.5),
              r(c, s=0.1))
    return x.contiguous(), params, bias, valid


def _window_half_composition(x, lnw, lnb, wqkv, bqkv, wproj, bproj, bias, heads):
    """The unfused torch composition the op replaces on windows, in x's
    type, with SDPA (the bias as a float mask) as its attention."""
    n, nw, L, c = x.shape
    qkv = F.linear(F.layer_norm(x, (c,), lnw, lnb, 1e-5), wqkv, bqkv)
    q, k, v = qkv.view(n * nw, L, 3, heads, c // heads).permute(2, 0, 3, 1, 4).unbind(0)
    mask = bias.to(x.dtype).expand(n, nw, heads, L, L).reshape(n * nw, heads, L, L)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return x + F.linear(o.transpose(1, 2).reshape(n, nw, L, c), wproj, bproj)


def check_window_attention_half(W, WH):
    """fused_window_attention_half kernel vs its plain version at swin_t
    stages 3 and 4 and swin_b stage 2 (b128), a ragged map with padding
    tokens and a head 300 log-units down, bf16 and f32; beside it the
    unfused torch composition with SDPA (a reference: no single PyTorch call
    computes this function). The f32 kernel is held against the plain
    version in f64, the bf16 one against the plain version in f32. Returns
    swin_t stage 3 bf16's numbers."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    main = None
    cases = [(name, case, False) for name, case in WINDOW_HALF_CASES.items()]
    cases.append(("swin_t b128 stage 3, head 300 below", WINDOW_HALF_CASES["swin_t b128 stage 3"], True))
    for name, (b, side, c, heads), low_head in cases:
        for dtype in (torch.bfloat16, torch.float32):
            bound = WINDOW_HALF_BF16_BOUND if dtype == torch.bfloat16 else F32_BOUND
            x, params, bias, valid = _window_half_inputs(b, side, c, heads, dtype, gen, W, WH)
            if low_head:
                bias[:, heads // 2] -= 300.0
            wide = torch.float64 if dtype == torch.float32 else torch.float32
            scale = (c // heads) ** -0.5
            with torch.no_grad():
                out = WH.fused_window_attention_half(x, *params, bias, heads, scale, 1e-5, valid)
                ref = WH.window_attention_half_reference(x.to(wide), *(t.to(wide) for t in params), bias, heads,
                                                         scale, 1e-5, valid)
            err = _compare(out, ref, bound, f"fused_window_attention_half {name} {dtype}")
            if low_head:
                print(f"fused_window_attention_half {str(dtype)[6:]} with one head 300 log-units below the others: "
                      f"finite, max|diff| {err:.3e} (bound {bound})")
                continue
            iters = 10 if dtype == torch.bfloat16 else 2
            ms, plain_ms, turns = _turns(
                lambda: WH.window_attention_half_reference(x, *params, bias, heads, scale, 1e-5, valid),
                lambda: WH.fused_window_attention_half(x, *params, bias, heads, scale, 1e-5, valid), iters,
            )
            with torch.inference_mode():
                composition_ms = _time_ms(lambda: _window_half_composition(x, *params, bias, heads), iters)
            e, rows, L = x.element_size(), x.numel() // c, x.shape[2]
            n_bytes = 2 * x.numel() * e + sum(t.numel() * e for t in params) + bias.numel() * 4
            flops = 2 * rows * c * 4 * c + 4 * rows * L * c
            bound_ms, bound_by = _bound_ms(n_bytes, flops, dtype)
            if (name, dtype) == ("swin_t b128 stage 3", torch.bfloat16):
                main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None)
            _report(f"fused_window_attention_half {name}", tuple(x.shape) + (heads,), dtype, err, bound, ms, plain_ms,
                    turns, f"; reference: unfused torch composition with SDPA {composition_ms:.4f} ms; "
                    f"bound {bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB)")
    print("fused_window_attention_half library_ms: null; no single PyTorch call computes the attention half")
    return main


def _gemm_build_report(log):
    """The GEMM kernels of gemm_bf16.cuh (bf16, and f32 by split TF32), named
    by their type and template arguments."""
    return _ptxas_report(log, r"gemm_(bf16|f32)_kernelILb(\d)ELi(\d)ELb(\d)ELi(\d+)E",
                         lambda m: f"gemm_{m.group(1)}_kernel<{_flag(m.group(2))}, {m.group(3)}, {_flag(m.group(4))}, "
                                   f"{m.group(5)}>")


def check_gemm(M, AH, W, WH, log):
    """The GEMMs of the three fused halves (gemm_bf16.cuh), bf16 and f32,
    driven through their ops at the main path's shapes: each op against its
    plain version (bf16 against f32, f32 against f64), then each GEMM's
    device time per call from torch.profiler, its rate, its bound, and
    F.linear on the same operands in the same type (a yardstick the port
    never calls; TF32 off). Fails on a GEMM kernel that spills."""
    from torch.profiler import ProfilerActivity, profile

    report = sorted(set(_gemm_build_report(log)))  # each source that includes the header builds its own copy
    _check(any(k.startswith("gemm_bf16") for k, _, _ in report), "no gemm_bf16_kernel in the build log")
    _check(any(k.startswith("gemm_f32") for k, _, _ in report), "no gemm_f32_kernel in the build log")
    for inst, regs, spills in report:
        print(f"{inst}: {regs} registers, {spills} bytes spilled (ptxas -v)")
    _check(all(spills == 0 for _, _, spills in report), "a GEMM kernel spills")

    gen = torch.Generator(device="cuda").manual_seed(12)
    for dtype in (torch.bfloat16, torch.float32):
        iters = 10 if dtype == torch.bfloat16 else 3
        wide = torch.float64 if dtype == torch.float32 else torch.float32
        prefix = "gemm_bf16_kernel<" if dtype == torch.bfloat16 else "gemm_f32_kernel<"
        for op_name, (kind, case) in GEMM_OPS.items():
            if kind == "mlp":
                x, residual, params = _mlp_inputs(*case, dtype, gen)
                call = lambda: M.fused_mlp_half(x, residual, *params)  # noqa: E731
                ref = M.mlp_half_reference(x.to(wide), residual.to(wide),
                                           *(None if t is None else t.to(wide) for t in params))
                rows, c = case[:2]
                hidden = torch.randn(rows, 4 * c, device="cuda", generator=gen).to(dtype)
                operands = {"<true, 1, false,": (x, params[2], params[3]),
                            "<false, 2, false,": (hidden, params[4], params[5])}
                bound = MLP_BF16_BOUND
            elif kind == "attn":
                b, l, d, heads = case
                x, params = _attn_half_inputs(b, l, d, dtype, gen)
                call = lambda: AH.fused_attention_half(x, *params, heads)  # noqa: E731
                ref = AH.attention_half_reference(x.to(wide), *(t.to(wide) for t in params), heads, (d // heads) ** -0.5)
                o = torch.randn(b * l, d, device="cuda", generator=gen).to(dtype)
                operands = {"<true, 0, false,": (x, params[2], params[3]), "<false, 2, false,": (o, params[4], params[5])}
                bound = ATTN_HALF_BF16_BOUND
            else:
                b, side, c, heads = case
                x, params, bias, valid = _window_half_inputs(b, side, c, heads, dtype, gen, W, WH)
                scale = (c // heads) ** -0.5
                call = lambda: WH.fused_window_attention_half(x, *params, bias, heads, scale, 1e-5, valid)  # noqa: E731
                ref = WH.window_attention_half_reference(x.to(wide), *(t.to(wide) for t in params), bias, heads, scale,
                                                         1e-5, valid)
                operands = {"<true, 3, true,": (x, params[2], params[3])}
                bound = WINDOW_HALF_BF16_BOUND
            bound = bound if dtype == torch.bfloat16 else F32_BOUND
            with torch.inference_mode():
                err = _compare(call(), ref, bound, f"check_gemm {op_name} {dtype}")
                del ref
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(iters):
                        call()
                    torch.cuda.synchronize()
            kernels = {e.key: e.device_time_total / 1e3 / e.count for e in prof.key_averages()
                       if prefix in e.key and e.count}
            print(f"check_gemm {op_name} {str(dtype)[6:]}: op against its plain version max|diff| {err:.3e} "
                  f"(bound {bound})")
            for gemm, case_op, inst, m, n, k in GEMM_CASES:
                if case_op != op_name:
                    continue
                hits = [(key, ms) for key, ms in kernels.items() if inst in key]
                _check(len(hits) == 1, f"check_gemm {op_name} {dtype} {gemm}: kernels {list(kernels)}")
                key, ms = hits[0]
                a, w, bvec = operands[inst]
                with torch.inference_mode():
                    library_ms = _time_ms(lambda: F.linear(a.reshape(-1, a.shape[-1]), w, bvec), iters)
                flops = 2 * m * n * k
                e = a.element_size()
                n_bytes = e * (m * k + n * k + m * n * (2 if inst.startswith("<false, 2") else 1) + n)
                bound_ms, bound_by = _bound_ms(n_bytes, flops, dtype)
                tile = key[key.index(prefix) + len(prefix) - 1:key.index(">") + 1]
                print(f"gemm {gemm} {str(dtype)[6:]} {prefix[:-1]}{tile} at {op_name} (M {m}, N {n}, K {k}): "
                      f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s; bound {bound_ms:.4f} ms ({bound_by}); library "
                      f"(F.linear, same operands) {library_ms:.4f} ms, {flops / library_ms / 1e9:.1f} TFLOP/s")
            del x, params, operands, call


def _folded_conv(cin, cout, k, stride, padding, groups, gen):
    """A bias-free Conv2d and a BatchNorm with running statistics and affine
    away from (0, 1), folded by ``ops.fold_batchnorm`` into one conv whose
    bias, beta - mean g, is large beside its products (means about 8)."""
    from eqxvision_tpu_torch.nn import BatchNorm, Conv2d
    from eqxvision_tpu_torch.ops import fold_batchnorm

    conv = Conv2d(cin, cout, k, stride, padding, groups=groups, use_bias=False, generator=gen, device="cuda")
    bn = BatchNorm(cout, device="cuda")
    with torch.no_grad():
        bn.running_mean.copy_(8.0 * torch.randn(cout, generator=gen))
        bn.running_var.copy_(torch.rand(cout, generator=gen) * 1.5 + 0.5)
        bn.weight.copy_(1.0 + 0.3 * torch.randn(cout, generator=gen))
        bn.bias.copy_(0.2 * torch.randn(cout, generator=gen))
    return fold_batchnorm(torch.nn.Sequential(conv, bn).eval())[0]


def check_bias_layers():
    """Linear and Conv2d (plain, strided, depthwise) on a bf16 input, with
    f32 parameters and with bf16 ones, at Swin's and ConvNeXt's shapes, and
    ResNet's convolutions with a folded BatchNorm's bias (the 7x7 stride-2
    stem, a 1x1, ResNeXt's grouped 3x3), against the same function in f64
    on the same operands: each output is the f32 accumulator plus the bias,
    rounded once, so within half a bf16 step of the f64 value. Prints the
    share of outputs that differ from the f64 value rounded once to bf16. A
    bf16 Conv2d with a bf16 bias is one cuDNN call that rounds twice, a
    standing choice (ROADMAP C.9): its steps and share are printed, not
    bounded."""
    from eqxvision_tpu_torch.nn import Conv2d, Linear

    gen = torch.Generator().manual_seed(10)
    layers = {
        "Linear 384 -> 1152 (swin_t stage 3 qkv)": (Linear(384, 1152, generator=gen, device="cuda"), (8, 196, 384)),
        "Conv2d 4x4 stride 4 (swin_t stem)": (Conv2d(3, 96, 4, 4, generator=gen, device="cuda"), (8, 224, 224, 3)),
        "Conv2d 3x3 padding 1": (Conv2d(96, 96, 3, 1, 1, generator=gen, device="cuda"), (8, 56, 56, 96)),
        "Conv2d 7x7 depthwise (convnext_tiny stage 1)": (
            Conv2d(96, 96, 7, 1, 3, groups=96, generator=gen, device="cuda"), (8, 56, 56, 96)),
    }
    with torch.no_grad():
        for layer, _ in layers.values():
            layer.bias.mul_(64.0)  # biases large beside the products, where rounding them first shows most
    layers.update({
        "Conv2d 7x7 stride 2 + folded BN (resnet50 stem)": (_folded_conv(3, 64, 7, 2, 3, 1, gen), (8, 224, 224, 3)),
        "Conv2d 1x1 + folded BN (resnet50 layer1 conv3)": (_folded_conv(64, 256, 1, 1, 0, 1, gen), (8, 56, 56, 64)),
        "Conv2d 3x3 groups 32 + folded BN (resnext50 layer1 conv2)": (
            _folded_conv(128, 128, 3, 1, 1, 32, gen), (8, 56, 56, 128)),
    })
    for name, (layer, shape) in layers.items():
        for params in (torch.float32, torch.bfloat16):
            layer = layer.to(params)
            with torch.no_grad():
                x = torch.randn(*shape, device="cuda", generator=torch.Generator(device="cuda").manual_seed(11))
                x = x.to(torch.bfloat16)
                out = layer(x)
                w64, b64 = layer.weight.to(torch.bfloat16).double(), layer.bias.double()
                if isinstance(layer, Linear):
                    ref = F.linear(x.double(), w64, b64)
                else:
                    (top, _), (left, _) = layer.padding
                    ref = F.conv2d(x.double().permute(0, 3, 1, 2), w64, b64, layer.stride, (top, left),
                                   layer.dilation, layer.groups).permute(0, 2, 3, 1)
            torch.cuda.synchronize()
            what = f"{name}, {str(params)[6:]} parameters"
            _check(out.dtype == torch.bfloat16 and out.shape == ref.shape, f"{what}: output {out.dtype} {tuple(out.shape)}")
            # one bf16 step at each output's magnitude, taken at 1 below it (f32 sums err in absolute terms)
            step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1.0))) - 7)
            steps = ((out.double() - ref).abs() / step).max().item()
            share = (out != ref.to(torch.bfloat16)).double().mean().item()
            twice = isinstance(layer, Conv2d) and params == torch.bfloat16
            bound = "not bounded: rounded twice, ROADMAP C.9" if twice else f"bound {BIAS_LAYER_STEPS}"
            print(f"{what}, bf16 input {tuple(shape)}: at most {steps:.4f} bf16 steps from the f64 value "
                  f"({bound}); {share:.4%} of outputs differ from it rounded once")
            if not twice:
                _check(steps <= BIAS_LAYER_STEPS,
                       f"{what}: {steps} bf16 steps from the f64 value (bound {BIAS_LAYER_STEPS})")


def check_batchnorm():
    """``nn.BatchNorm`` at inference (one ``F.batch_norm`` call) on the
    resnet50 b128 shapes, against the JAX layer's formula spelled out:
    scale = rsqrt(var + eps) w and shift = b - mean scale in f32, x scale +
    shift in f32, rounded once (in f64 for an f32 input). bf16 outputs at
    most one bf16 step (at 1 below magnitude 1) from it, the share that
    differs printed; f32 within 1e-5 of f64. Both timed in turns: the
    formula makes three passes over the map, the call one."""
    from eqxvision_tpu_torch.nn import BatchNorm

    gen = torch.Generator(device="cuda").manual_seed(12)
    for name, shape in BN_CASES.items():
        c = shape[-1]
        bn = BatchNorm(c, device="cuda").eval()
        with torch.no_grad():
            bn.running_mean.copy_(torch.randn(c, device="cuda", generator=gen))
            bn.running_var.copy_(torch.rand(c, device="cuda", generator=gen) + 0.5)
            bn.weight.copy_(1.0 + 0.3 * torch.randn(c, device="cuda", generator=gen))
            bn.bias.copy_(0.2 * torch.randn(c, device="cuda", generator=gen))
        x32 = torch.randn(*shape, device="cuda", generator=gen) * 2.0 + 1.0
        for dtype in (torch.bfloat16, torch.float32):
            layer, x = bn.to(dtype), x32.to(dtype)

            def formula(wide=torch.float32):
                scale = torch.rsqrt(layer.running_var.to(wide) + layer.eps) * layer.weight.to(wide)
                shift = layer.bias.to(wide) - layer.running_mean.to(wide) * scale
                return (x.to(wide) * scale + shift).to(dtype)

            with torch.inference_mode():
                out, ref = layer(x), formula()
                ms, plain_ms, turns = _turns(formula, lambda: layer(x), 10)
                if dtype == torch.float32:
                    ref = formula(torch.float64)
            torch.cuda.synchronize()
            _check(out.shape == ref.shape and out.dtype == dtype and out.is_contiguous(), f"BatchNorm {name} malformed")
            if dtype == torch.bfloat16:
                # one bf16 step at each output's magnitude, taken at 1 below it: both sides compute
                # x * scale + shift-sized terms in f32, whose rounding errs in absolute terms
                refd = ref.double()
                step = torch.exp2(torch.floor(torch.log2(refd.abs().clamp_min(1.0))) - 7)
                steps = ((out.double() - refd).abs() / step).max().item()
                share = (out != ref).double().mean().item()
                _check(steps <= 1.0, f"BatchNorm {name} bf16: {steps} bf16 steps from the JAX formula")
                err = f"at most {steps:.4f} bf16 steps from the JAX formula, {share:.4%} of outputs differ"
            else:
                diff = (out.double() - ref.double()).abs().max().item()
                _check(diff < 1e-5, f"BatchNorm {name} f32: {diff} from the formula in f64")
                err = f"max|diff| {diff:.3e} from the formula in f64 (bound 1e-5)"
            bound_ms = _bound_ms(2 * x.numel() * x.element_size(), 0, dtype)[0]
            print(f"BatchNorm {name} {tuple(shape)} {str(dtype)[6:]}: {err}; F.batch_norm {ms:.4f} ms, the formula "
                  f"in f32 (three passes) {plain_ms:.4f} ms (turns {', '.join(f'{t:.4f}' for t in turns)}); bound "
                  f"{bound_ms:.4f} ms (bytes)")


def _attn_inputs(lead, n, dh, bias_lead, dtype, gen):
    q, k, v = (torch.randn(*lead, n, dh, device="cuda", generator=gen).to(dtype) for _ in range(3))
    bias = None if bias_lead is None else torch.randn(*bias_lead, n, n, device="cuda", generator=gen)
    return q, k, v, bias


# Public attention: (q lead dims, N, Dh, bias lead dims or None). swin_t
# stage 1 through the op, B = 128 * 64 * 3 with the (192, 49, 49) window and
# head bias shared over the batch (the window stage, one head a window: 192
# slabs, which the 528 blocks of the bf16 grid do not divide); vit_base b256 with
# no bias and with a BEiT-style (12, 197, 197) relative-position bias (the
# attention stage, one pass); vit_base at 384 px b32 (577 tokens: two
# passes, K and V resident) with and without a (12, 577, 577) bias; a
# ragged one (head dim 8: the stage's CUDA-core kernel).
ATTN_CASES = {"swin_t stage 1": ((128, 192), 49, 32, (1, 192)), "vit_base b256": ((256, 12), 197, 64, None),
              "vit_base b256 rel-pos bias": ((256, 12), 197, 64, (12,)),
              "vit_base 384 px b32": ((32, 12), 577, 64, (12,)),
              "vit_base 384 px b32, no bias": ((32, 12), 577, 64, None), "ragged": ((2, 2), 17, 8, (2,))}
ATTN_KERNELS = {0: "the attention stage's CUDA-core kernel", 1: "the bf16 window stage (TMA ring, wgmma)",
                2: "the attention stage's wgmma kernel", 3: "the attention stage's f32 kernel (split TF32)",
                4: "the f32 window stage (TMA ring, split TF32 on mma.sync)"}
# The kernel names torch.profiler must see on each path.
ATTN_PROFILED = {1: "window_stage", 2: "attention_stage_wgmma", 3: "attention_stage_f32", 4: "window_stage"}


def _device_kernels(fn, iters=10, names=None):
    """{name: device ms a call} of the CUDA kernels fn launches whose names
    hold one of ``names`` (all where None; torch.profiler, mean over
    ``iters`` calls after one warm-up). A trace without them is the
    profiler's loss, not the call's (every call launches one): taken again,
    up to three times; {} if it stays empty."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        found = {e.key: e.device_time_total / 1e3 / iters for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total
                 and (names is None or any(n in e.key for n in names))}
        if found:
            return found
    return {}


def check_attention(A, lib):
    """The public attention kernel vs its plain version, with the kernel it
    takes at each case (eqx_attention_config), the kernels the profiler saw
    on the window stage (its kernel and no other, so not the short-row kernel
    it replaced), the wgmma stage or the f32 stage, the device time by
    torch.profiler beside CUDA events; returns swin_t stage 1 bf16's numbers
    with vit_base b256's, without and with the bias, beside them."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    main, extra = None, {}
    for name, (lead, n, dh, bias_lead) in ATTN_CASES.items():
        for dtype, bound in ((torch.bfloat16, QKV_BF16_BOUND), (torch.float32, F32_BOUND)):
            q, k, v, bias = _attn_inputs(lead, n, dh, bias_lead, dtype, gen)
            scale = dh**-0.5
            cfg = (ctypes.c_int * 6)()
            batch = q.numel() // (n * dh)
            _check(lib.eqx_attention_config(n, dh, int(dtype == torch.bfloat16), int(bias is not None), batch, cfg)
                   == 0, f"attention config {name}")
            design = ATTN_KERNELS[cfg[0]]
            if cfg[0] in (1, 4):
                design += (f" ({cfg[3]} blocks of {-(-batch // cfg[3])} rows or fewer, {cfg[1]} an SM, {cfg[2]} bytes "
                           f"of shared memory a block, a ring of {cfg[4]})")
            if cfg[0] == 2:
                design += (f" ({cfg[1]} blocks an SM, {cfg[2]} bytes of shared memory, {cfg[3]} key rows, "
                           f"{'one pass' if cfg[4] else 'two passes'}, K and V "
                           f"{'resident' if cfg[5] else 'loaded block by block'})")
            with torch.no_grad():
                out = A.attention(q, k, v, bias, scale)
                ref = A.attention_reference(q.float(), k.float(), v.float(), bias, scale)
            err = _compare(out, ref, bound, f"attention {name} {dtype}")
            kernels = _device_kernels(lambda: A.attention(q, k, v, bias, scale))
            _check(bool(kernels), f"attention {name} {dtype}: the profiler saw no kernel, three times")
            device_ms = sum(t for key, t in kernels.items() if "window_stage" in key or "attention_stage" in key)
            if cfg[0] in ATTN_PROFILED:
                seen = sorted(kernels)
                expected = ATTN_PROFILED[cfg[0]]
                only = cfg[0] in (1, 4)  # the window stage reads the tensors as given: no copy kernel either
                _check(any(expected in k for k in seen) and not any("_fma" in k for k in seen)
                       and (not only or all(expected in k for k in seen)),
                       f"attention {name} {dtype}: kernels {seen}, expected {expected}{' alone' if only else ''}")
                design += f"; profiler: {[k for k in seen if expected in k]}"
            ms, plain_ms, turns = _turns(
                lambda: A.attention_reference(q, k, v, bias, scale), lambda: A.attention(q, k, v, bias, scale), 10,
            )
            mask = None if bias is None else bias.to(dtype).expand(*lead, n, n).contiguous()
            with torch.inference_mode():
                library_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), 10)
            e = q.element_size()
            n_bytes = 4 * q.numel() * e + (0 if bias is None else bias.numel() * 4)
            bound_ms, bound_by = _bound_ms(n_bytes, 4 * batch * n * n * dh, dtype)
            numbers = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=library_ms)
            if (name, dtype) == ("swin_t stage 1", torch.bfloat16):
                main = numbers
            elif dtype == torch.bfloat16 and name.startswith("vit_base b256"):
                extra[name.replace(" ", "_").replace("-", "_")] = numbers
            how = "no mask" if bias is None else "expanded float mask laid out before the call"
            _report(f"attention {name}", tuple(q.shape), dtype, err, bound, ms, plain_ms, turns,
                    f"; kernel device time {device_ms:.4f} ms (profiler); library (SDPA, {how}) {library_ms:.4f} ms; "
                    f"bound {bound_ms:.4f} ms ({bound_by}); {design}")

    # one head biased 300 log-units below the others: finite, and equal to the plain version
    for dtype, bound in ((torch.bfloat16, QKV_BF16_BOUND), (torch.float32, F32_BOUND)):
        q, k, v, bias = _attn_inputs((4, 3), 49, 32, (3,), dtype, gen)
        bias[1] -= 300.0
        with torch.no_grad():
            out = A.attention(q, k, v, bias)
            err = _compare(out, A.attention_reference(q.float(), k.float(), v.float(), bias), bound,
                           f"attention, head 300 below, {dtype}")
        print(f"attention {str(dtype)[6:]} with one head 300 log-units below the others: finite, "
              f"max|diff| {err:.3e} (bound {bound})")

    # a bias of -inf on keys 0-255 of some rows (the two-pass kernel's first block) and finite after them
    for dtype, bound in ((torch.bfloat16, QKV_BF16_BOUND), (torch.float32, F32_BOUND)):
        q, k, v, bias = _attn_inputs((2, 3), 300, 64, (3,), dtype, gen)
        bias[1, :40, :256] = float("-inf")
        with torch.no_grad():
            out = A.attention(q, k, v, bias)
            err = _compare(out, A.attention_reference(q.float(), k.float(), v.float(), bias), bound,
                           f"attention, -inf bias over the first 256 keys, {dtype}")
        print(f"attention {str(dtype)[6:]} {tuple(q.shape)}, rows with a -inf bias over keys 0-255: finite, "
              f"max|diff| {err:.3e} (bound {bound})")
    return {**main, **extra}


def check_ragged(W):
    """The NHWC entry points on an input whose padding gives an odd window
    count (3) and whose padded width one window covers (no shift there),
    card (kernels) against CPU (plain versions), f32."""
    gen = torch.Generator().manual_seed(3)
    c, h, win = 96, 3, (7, 7)
    x = torch.randn(2, 20, 6, c, generator=gen) * 0.5

    def r(*shape, base=0.0):
        return base + 0.1 * torch.randn(*shape, generator=gen)

    kw = dict(
        norm1_w=r(c, base=1.0), norm1_b=r(c), qkv_weight=r(3 * c, c), qkv_bias=r(3 * c), proj_weight=r(c, c),
        proj_bias=r(c), relative_position_bias=torch.randn(1, h, 49, 49, generator=gen), norm2_w=r(c, base=1.0),
        norm2_b=r(c), fc1_weight=r(4 * c, c), fc1_bias=r(4 * c), fc2_weight=r(c, 4 * c), fc2_bias=r(c),
        window_size=win, shift_size=(3, 3), num_heads=h,
    )
    card_kw = {k: v.cuda() if torch.is_tensor(v) else v for k, v in kw.items()}
    with torch.no_grad():
        block = W.fused_swin_block_v1(x.cuda(), **card_kw).cpu()
        block_ref = W.fused_swin_block_v1(x, **kw)
        attn_args = ("qkv_weight", "proj_weight", "relative_position_bias")
        attn = W.shifted_window_attention(
            x.cuda(), *(card_kw[a] for a in attn_args), win, h, (3, 3), qkv_bias=card_kw["qkv_bias"],
            proj_bias=card_kw["proj_bias"],
        ).cpu()
        attn_ref = W.shifted_window_attention(
            x, *(kw[a] for a in attn_args), win, h, (3, 3), qkv_bias=kw["qkv_bias"], proj_bias=kw["proj_bias"],
        )
    for what, got, ref in (("fused_swin_block_v1", block, block_ref), ("shifted_window_attention", attn, attn_ref)):
        _check(got.shape == x.shape and bool(torch.isfinite(got).all()), f"ragged {what}: malformed output")
        err = (got - ref).abs().max().item()
        _check(err < F32_BOUND, f"ragged {what}: card vs CPU {err}")
        print(f"ragged input {tuple(x.shape)}, window 7 (3 windows, width covered): {what} card vs CPU "
              f"max|diff| {err:.3e} (bound {F32_BOUND})")


def _reset(counters):
    for fn in counters:
        fn.launches = 0


def calibrate_batchnorm(model, size):
    """Running statistics from one training-mode f32 forward on a seeded
    batch (momentum 1 for that forward): a BatchNorm built fresh has mean 0
    and variance 1 and normalises nothing, and through resnet50's 16 blocks
    the logits would grow until an absolute bound means little."""
    from eqxvision_tpu_torch.nn import BatchNorm

    norms = {m: m.momentum for m in model.modules() if isinstance(m, BatchNorm)}
    x = torch.randn(CALIBRATION_BATCH, size, size, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(4))
    for m in norms:
        m.momentum = 1.0
    with torch.no_grad():
        model.train()(x)
    for m, momentum in norms.items():  # each its own: MobileNetV3's and EfficientNet b5-b7's are 0.01
        m.momentum = momentum
    return model.eval()


def serve(create_model, name, size, requests, counters, expected, prepare=None, **model_kwargs):
    """``name`` as a server. ``counters`` are every kernel wrapper; the path
    must raise their ``launches`` by ``expected`` per forward (0 for the
    kernels it does not run); returns the counts of the request run.
    ``prepare(model, size)`` runs on the f32 card model before anything
    else (``calibrate_batchnorm``)."""
    model = create_model(name, generator=torch.Generator().manual_seed(0), device="cuda", **model_kwargs).eval()
    if prepare is not None:
        model = prepare(model, size)
    x2 = torch.randn(2, size, size, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        card = model(x2.cuda()).cpu()
        cpu_model = create_model(name, generator=torch.Generator().manual_seed(0), device="cpu", **model_kwargs).eval()
        cpu_model.load_state_dict(model.state_dict())
        cpu = cpu_model(x2)
    err = (card - cpu).abs().max().item()
    print(f"{name} f32 b2 logits, card vs CPU plain path: max|diff| {err:.3e} (bound {LOGIT_BOUND}), "
          f"max|logit| {cpu.abs().max().item():.3f}")
    _check(card.shape == (2, 1000) and bool(torch.isfinite(card).all()), f"{name} f32 logits malformed")
    _check(err < LOGIT_BOUND, f"{name}: card vs CPU logits differ by {err}")
    b = requests[-1]
    x32 = torch.randn(b, size, size, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.inference_mode():
        ms = _time_ms(lambda: model(x32), 5)
    print(f"{name} b{b} f32: {ms:.3f} ms per forward, {b / ms * 1000:.1f} images/s")
    del x32

    model = model.to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batches = {b: torch.randn(b, size, size, 3, device="cuda", generator=gen).to(torch.bfloat16) for b in requests}
    _reset(counters)
    for b in requests:
        before = [fn.launches for fn in counters]
        with torch.inference_mode():
            logits = model(batches[b])
        torch.cuda.synchronize()
        launched = [fn.launches - n for fn, n in zip(counters, before)]
        print(f"{name} request b={b} bf16: logits {tuple(logits.shape)} finite={bool(torch.isfinite(logits).all())} "
              f"launches {dict(zip((fn.__name__ for fn in counters), launched))}")
        _check(logits.shape == (b, 1000) and bool(torch.isfinite(logits).all()), f"{name} b={b} logits malformed")
        _check(launched == list(expected), f"{name} b={b}: launches {launched}, expected {list(expected)} per forward")
    counts = {fn.__name__: fn.launches for fn in counters}
    _check(all(counts[fn.__name__] for fn, n in zip(counters, expected) if n),
           f"{name}: a kernel of the path was never launched: {counts}")

    for b in requests:
        with torch.inference_mode():
            ms = _time_ms(lambda: model(batches[b]), 10)
        print(f"{name} b{b} bf16: {ms:.3f} ms per forward, {b / ms * 1000:.1f} images/s")
    return counts


def serve_folded(create_model, counters, batch=RESNET_REQUESTS[-1]):
    """resnet50 with its BatchNorms folded into its convolutions
    (``ops.fold_batchnorm`` on the calibrated f32 model, then cast): f32
    logits against the unfolded model's, then the unfolded and the folded
    bf16 forwards at ``batch`` timed in turns, no kernel of the port
    launched by the folded one."""
    from eqxvision_tpu_torch.ops import fold_batchnorm

    model = calibrate_batchnorm(create_model("resnet50", generator=torch.Generator().manual_seed(0), device="cuda"), 224)
    folded = fold_batchnorm(model)
    x2 = torch.randn(2, 224, 224, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.inference_mode():
        ref, out = model(x2), folded(x2)
    err = (out - ref).abs().max().item()
    print(f"resnet50 folded f32 b2 logits against unfolded: max|diff| {err:.3e} (bound {LOGIT_BOUND}), "
          f"max|logit| {ref.abs().max().item():.3f}")
    _check(out.shape == (2, 1000) and bool(torch.isfinite(out).all()), "resnet50 folded logits malformed")
    _check(err < LOGIT_BOUND, f"resnet50: folded and unfolded logits differ by {err}")
    model, folded = model.to(torch.bfloat16), folded.to(torch.bfloat16)
    x = torch.randn(batch, 224, 224, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(2))
    x = x.to(torch.bfloat16)
    _reset(counters)
    with torch.inference_mode():
        logits = folded(x)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counters}
        _check(logits.shape == (batch, 1000) and bool(torch.isfinite(logits).all()), "resnet50 folded bf16 malformed")
        _check(not any(counts.values()), f"resnet50 folded: launches {counts}")
        t = [_time_ms(lambda: m(x), 10) for m in (model, folded, folded, model)]
    unfolded_ms, folded_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"resnet50 b{batch} bf16, turns unfolded/folded/folded/unfolded {', '.join(f'{v:.3f}' for v in t)} ms: "
          f"unfolded {unfolded_ms:.3f} ms, {batch / unfolded_ms * 1000:.1f} images/s; folded {folded_ms:.3f} ms, "
          f"{batch / folded_ms * 1000:.1f} images/s; launches {counts}")
    return counts


def _maps(out):
    """A segmentation model's maps: ``(aux, out)`` (aux None without an aux
    head), or LR-ASPP's map alone."""
    return [m for m in out if m is not None] if isinstance(out, tuple) else [out]


def serve_segmentation(create_model, name, requests, counters, n_maps, **model_kwargs):
    """``name`` at ``SEG_SIZE`` as a server, every port launch count 0:
    calibrated; f32 maps at b1 and ``SEG_CHECK_SIZE`` against the same
    weights on the CPU; the f32 forward at the largest batch; bf16
    requests, each map finite and (b, SEG_SIZE, SEG_SIZE, SEG_CLASSES)."""
    model = create_model(name, generator=torch.Generator().manual_seed(0), device="cuda", **model_kwargs).eval()
    model = calibrate_batchnorm(model, SEG_CHECK_SIZE)
    x1 = torch.randn(1, SEG_CHECK_SIZE, SEG_CHECK_SIZE, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        card = [m.cpu() for m in _maps(model(x1.cuda()))]
        cpu_model = create_model(name, generator=torch.Generator().manual_seed(0), device="cpu", **model_kwargs).eval()
        cpu_model.load_state_dict(model.state_dict())
        cpu = _maps(cpu_model(x1))
    shape = (1, SEG_CHECK_SIZE, SEG_CHECK_SIZE, SEG_CLASSES)
    _check(len(card) == len(cpu) == n_maps and all(m.shape == shape and bool(torch.isfinite(m).all()) for m in card),
           f"{name} f32 maps malformed: {[tuple(m.shape) for m in card]}")
    err = max((a - b).abs().max().item() for a, b in zip(card, cpu))
    print(f"{name} f32 b1 {SEG_CHECK_SIZE} px maps ({n_maps}), card vs CPU plain path: max|diff| {err:.3e} "
          f"(bound {LOGIT_BOUND}), max|map| {max(m.abs().max().item() for m in cpu):.3f}")
    _check(err < LOGIT_BOUND, f"{name}: card vs CPU maps differ by {err}")
    del cpu_model
    b = requests[-1]
    x32 = torch.randn(b, SEG_SIZE, SEG_SIZE, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.inference_mode():
        ms = _time_ms(lambda: model(x32), 5)
    print(f"{name} b{b} {SEG_SIZE} px f32: {ms:.3f} ms per forward, {b / ms * 1000:.1f} images/s")
    del x32

    model = model.to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batches = {b: torch.randn(b, SEG_SIZE, SEG_SIZE, 3, device="cuda", generator=gen).to(torch.bfloat16)
               for b in requests}
    _reset(counters)
    for b in requests:
        with torch.inference_mode():
            maps = _maps(model(batches[b]))
        torch.cuda.synchronize()
        shape = (b, SEG_SIZE, SEG_SIZE, SEG_CLASSES)
        print(f"{name} request b={b} {SEG_SIZE} px bf16: maps {[tuple(m.shape) for m in maps]} "
              f"finite={all(bool(torch.isfinite(m).all()) for m in maps)}")
        _check(len(maps) == n_maps and all(m.shape == shape and bool(torch.isfinite(m).all()) for m in maps),
               f"{name} b={b} maps malformed")
    counts = {fn.__name__: fn.launches for fn in counters}
    print(f"{name} requests {list(requests)}: launches {counts}")
    _check(not any(counts.values()), f"{name}: launches {counts}, expected none")
    for b in requests:
        with torch.inference_mode():
            ms = _time_ms(lambda: model(batches[b]), 10)
        print(f"{name} b{b} {SEG_SIZE} px bf16: {ms:.3f} ms per forward, {b / ms * 1000:.1f} images/s")
    return counts


SERVE_CANVAS, SERVE_CROP = 256, 224
SERVE_REQUESTS = (1, 8, 128)
# the port's kernels by the names torch.profiler gives them
PORT_KERNELS = ("attention_stage", "gemm_bf16", "gemm_f32", "layer_norm", "row_stats", "swin_block", "window_stage",
                "window_attention_kernel", "stage_halves", "split_weights")
# int8 weights against the unquantized bf16 model: per-channel rounding of every weight moves the logits by a
# share of their spread; bound on max|int8 - bf16| over the std of the bf16 logits
INT8_LOGIT_SHARE = 0.5
PROBS_BOUND = 1e-4  # f32 attention probabilities, card vs CPU


def _canvases(b, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, (b, SERVE_CANVAS, SERVE_CANVAS, 3), dtype=torch.uint8, device="cuda", generator=gen)


def _cli_args(model, *flags, device="cuda"):
    from eqxvision_tpu_torch.cli import eval_imagenet as cli

    return cli.build_argparser().parse_args(["--model", model, "--data-dir", "-", "--device", device, *flags])


def _cli_model(model, weights, *flags, device="cuda"):
    """The eval CLI's model and step for ``flags``, weights from the file."""
    from eqxvision_tpu_torch.cli import eval_imagenet as cli

    args = _cli_args(model, "--torch-weights", weights, *flags, device=device)
    return cli.build_model(args), cli.make_step(args)


def _serve_requests(tag, model, step, counters, expected, smi, requests=SERVE_REQUESTS):
    """bf16 requests of uint8 canvases through the CLI's step, every count 0
    before and each request's launches checked (``expected`` per forward);
    then each request's ms and images/s. Returns the counts."""
    batches = {b: _canvases(b, 5) for b in requests}
    _reset(counters)
    for b in requests:
        before = [fn.launches for fn in counters]
        scores = step.scores(model, batches[b])
        torch.cuda.synchronize()
        launched = [fn.launches - n for fn, n in zip(counters, before)]
        print(f"{tag} request b={b}: scores {tuple(scores.shape)} finite={bool(torch.isfinite(scores).all())} "
              f"launches {dict(zip((fn.__name__ for fn in counters), launched))}")
        _check(scores.shape == (b, 1000) and bool(torch.isfinite(scores).all()), f"{tag} b={b} scores malformed")
        _check(launched == list(expected), f"{tag} b={b}: launches {launched}, expected {list(expected)} a forward")
    counts = {fn.__name__: fn.launches for fn in counters}
    _check(all(counts[fn.__name__] for fn, n in zip(counters, expected) if n),
           f"{tag}: a kernel of the path was never launched: {counts}")
    for b in requests:
        ms = _time_ms(lambda: step.scores(model, batches[b]), 10)
        print(f"{tag} b{b}: {ms:.3f} ms a request (uint8 {SERVE_CANVAS} px canvases, crop {SERVE_CROP}), "
              f"{b / ms * 1000:.1f} images/s on {smi}")
    return counts


def _card_vs_cpu(tag, model, weights, *flags):
    """The CLI's f32 model for ``flags`` on the card and on the CPU, the
    same uint8 b2 canvases through each one's step: scores within
    ``LOGIT_BOUND`` of their largest magnitude (of 1 where that is less;
    image-like canvases give resnet50 logits of ~40, randn input ~2)."""
    card, step = _cli_model(model, weights, *flags)
    cpu, cpu_step = _cli_model(model, weights, *flags, device="cpu")
    u8 = _canvases(2, 6)
    a, b = step.scores(card, u8).cpu(), cpu_step.scores(cpu, u8.cpu())
    err = (a - b).abs().max().item()
    bound = LOGIT_BOUND * max(1.0, b.abs().max().item())
    print(f"{tag} f32 b2, card vs CPU plain path: max|diff| {err:.3e} (bound {bound:.3e}), max|score| "
          f"{b.abs().max().item():.3f}")
    _check(a.shape == b.shape and bool(torch.isfinite(a).all()) and err < bound, f"{tag}: card vs CPU {err}")


def _int8_against_bf16(tag, q, ref, step, b=8):
    """int8 scores against the unquantized bf16 model's on one batch."""
    u8 = _canvases(b, 7)
    a, r = step.scores(q, u8).float(), step.scores(ref, u8).float()
    share = ((a - r).abs().max() / r.std()).item()
    agree = (a.argmax(-1) == r.argmax(-1)).float().mean().item()
    print(f"{tag} b{b} bf16 against the unquantized bf16 model: max|diff| {(a - r).abs().max().item():.4f}, "
          f"{share:.3f} of the logits' std (bound {INT8_LOGIT_SHARE}), top-1 agreement {agree:.3f}")
    _check(bool(torch.isfinite(a).all()) and share < INT8_LOGIT_SHARE, f"{tag}: int8 logits off by {share} std")


def _perturbed_layernorms(model, seed):
    """LayerNorm affines drawn away from 1 and 0 (a fresh model's fold is a no-op)."""
    from eqxvision_tpu_torch.nn import LayerNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerNorm) and m.weight is not None:
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=gen))
    return model


def _int8_gemm_kernels(fn):
    """Names of the int8 GEMM kernels ``fn`` launches (cuBLAS's i8/imma)."""
    names = _device_kernels(fn, iters=2)
    return sorted(k for k in names if re.search(r"gemm|imma|xmma|cutlass", k, re.I)
                  and re.search(r"i8|s8|int8|imma", k, re.I))


def serve_transforms(create_model, counters, smi):
    """The serving path through the eval CLI (``cli.eval_imagenet``'s
    ``build_model`` and ``make_step``) on seeded uint8 canvases, full width
    and depth, bf16: resnet50 ``--int8``; vit_base ``--fold-ln``,
    ``--int8`` and ``--int8 --int8-act``; swin_t ``--int8`` and a ten-crop
    step; ``resize_pos_embed`` to 384 px; ``get_last_self_attention``;
    ``export_inference`` of vit_base and of resnet50 with a baked uint8
    preprocess, saved, loaded and run; ``checked_call`` on a planted NaN.
    Returns the counts of the int8 vit_base requests."""
    import tempfile

    from eqxvision_tpu_torch.cli import eval_imagenet as cli
    from eqxvision_tpu_torch.export import export_inference, load_exported, save_exported
    from eqxvision_tpu_torch.models.classification import resize_pos_embed
    from eqxvision_tpu_torch.nn import BatchNorm
    from eqxvision_tpu_torch.observability import checked_call
    from eqxvision_tpu_torch.ops import imagenet_eval_pipeline
    from eqxvision_tpu_torch.quantize import DynActInt8Linear, QuantConv2d, QuantLinear

    print(f"serving transforms on {smi}")
    none = (0,) * len(counters)
    tmp = tempfile.TemporaryDirectory()
    r50_file, vit_file, swin_file = (f"{tmp.name}/{n}.pt" for n in ("resnet50", "vit_base", "swin_t"))
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    r50 = calibrate_batchnorm(create_model("resnet50", generator=gen(), device="cuda"), SERVE_CROP)
    torch.save(r50.state_dict(), r50_file)
    vit = _perturbed_layernorms(create_model("vit_base", generator=gen(), device="cuda").eval(), 8)
    torch.save(vit.state_dict(), vit_file)
    torch.save(create_model("swin_t", generator=gen(), device="cuda").state_dict(), swin_file)

    # resnet50 --int8: BatchNorm folded, every conv and the fc quantized
    q, step = _cli_model("resnet50", r50_file, "--bf16", "--int8")
    kinds = {type(m).__name__ for m in q.modules()}
    _check("QuantConv2d" in kinds and "QuantLinear" in kinds and "BatchNorm" not in kinds and "Conv2d" not in kinds,
           f"resnet50 --int8 layers: {sorted(kinds)}")
    _card_vs_cpu("resnet50 --int8", "resnet50", r50_file, "--int8")
    ref, _ = _cli_model("resnet50", r50_file, "--bf16")
    _int8_against_bf16("resnet50 --int8", q, ref, step)
    _serve_requests("resnet50 --bf16 --int8", q, step, counters, none, smi, requests=(SERVE_REQUESTS[-1],))
    del q, ref

    # vit_base --fold-ln: f32 folded against unfolded on the card, then bf16 requests on both fused halves
    plain, step32 = _cli_model("vit_base", vit_file)
    folded, _ = _cli_model("vit_base", vit_file, "--fold-ln")
    _check(all(b.norm1.weight is None and b.norm2.weight is None for b in folded.blocks), "vit_base not folded")
    u8 = _canvases(8, 9)
    a, r = step32.scores(folded, u8), step32.scores(plain, u8)
    err = (a - r).abs().max().item()
    print(f"vit_base --fold-ln f32 b8 against unfolded on the card: max|diff| {err:.3e} (bound {LOGIT_BOUND}), "
          f"max|logit| {r.abs().max().item():.3f}")
    _check(err < LOGIT_BOUND, f"vit_base --fold-ln: folded and unfolded logits differ by {err}")
    del plain, folded
    m, step = _cli_model("vit_base", vit_file, "--bf16", "--fold-ln")
    _serve_requests("vit_base --bf16 --fold-ln", m, step, counters, (0, 0, 0, 1, 0, 12, 12, 0), smi)
    ref, _ = _cli_model("vit_base", vit_file, "--bf16")
    _serve_requests("vit_base --bf16", ref, step, counters, (0, 0, 0, 1, 0, 12, 12, 0), smi, requests=(1, 8))

    # vit_base --int8: the blocks call the quantized layers, K6 -> qkv -> K1 -> proj, K6 -> MLP
    _card_vs_cpu("vit_base --int8", "vit_base", vit_file, "--int8")
    q, step = _cli_model("vit_base", vit_file, "--bf16", "--int8")
    _check(all(isinstance(getattr(b.attn, n), QuantLinear) for b in q.blocks for n in ("qkv", "proj"))
           and isinstance(q.patch_embed.proj, QuantConv2d), "vit_base --int8 layers")
    _int8_against_bf16("vit_base --int8", q, ref, step)
    int8_counts = _serve_requests("vit_base --bf16 --int8", q, step, counters, (12, 0, 0, 25, 0, 0, 0, 0), smi)

    # vit_base --int8 --int8-act: w8a8 Linears on cuBLAS's int8 GEMM, weight-only int8 convs
    qa, step = _cli_model("vit_base", vit_file, "--bf16", "--int8", "--int8-act")
    linears = [m for m in qa.modules() if isinstance(m, QuantLinear)]
    _check(len(linears) == 49 and all(isinstance(m, DynActInt8Linear) for m in linears)
           and isinstance(qa.patch_embed.proj, QuantConv2d), "vit_base --int8 --int8-act layers")
    _int8_against_bf16("vit_base --int8 --int8-act", qa, ref, step)
    _serve_requests("vit_base --bf16 --int8 --int8-act", qa, step, counters, (12, 0, 0, 25, 0, 0, 0, 0), smi)
    u8 = _canvases(8, 10)
    int8_gemms = _int8_gemm_kernels(lambda: step.scores(qa, u8))
    print(f"vit_base --int8 --int8-act b8: int8 GEMM kernels {int8_gemms}")
    _check(bool(int8_gemms), "vit_base --int8 --int8-act: the profiler saw no int8 GEMM kernel")
    del q, qa

    # swin_t --int8: the fused kernels read the dequantized weights; then a ten-crop step
    _card_vs_cpu("swin_t --int8", "swin_t", swin_file, "--int8")
    q, step = _cli_model("swin_t", swin_file, "--bf16", "--int8")
    _serve_requests("swin_t --bf16 --int8", q, step, counters, (0, 0, 4, 5, 0, 8, 0, 8), smi, requests=(8,))
    tta = cli.make_step(_cli_args("swin_t", "--torch-weights", swin_file, "--bf16", "--int8", "--tta", "ten_crop"))
    u8, labels = _canvases(8, 11), torch.arange(8, device="cuda")
    _reset(counters)
    probs = tta.scores(q, u8)
    top1, top5 = tta(q, u8, labels)
    counts = {fn.__name__: fn.launches for fn in counters}
    rows = probs.sum(-1)
    print(f"swin_t --int8 --tta ten_crop b8 (80 crops a forward): probs {tuple(probs.shape)}, row sums "
          f"[{rows.min().item():.6f}, {rows.max().item():.6f}], top1 {int(top1)} top5 {int(top5)}, launches {counts}")
    _check(probs.shape == (8, 1000) and bool(torch.isfinite(probs).all()) and (rows - 1).abs().max() < 1e-4,
           "swin_t ten-crop probabilities malformed")
    _check([counts[fn.__name__] for fn in counters] == [0, 0, 8, 10, 0, 16, 0, 16], f"swin_t ten-crop: {counts}")
    ms = _time_ms(lambda: tta(q, u8, labels), 5)
    print(f"swin_t --bf16 --int8 --tta ten_crop b8: {ms:.3f} ms a request, {8 / ms * 1000:.1f} images/s on {smi}")
    del q

    # resize_pos_embed to 384 px (577 tokens): f32 card against CPU, then bf16 b32 on the fused halves
    vit = create_model("vit_base", device="cuda", torch_weights=vit_file).eval()
    big = resize_pos_embed(vit, 384)
    cpu_big = resize_pos_embed(create_model("vit_base", device="cpu", torch_weights=vit_file).eval(), 384)
    x2 = torch.randn(2, 384, 384, 3, generator=torch.Generator().manual_seed(12))
    with torch.inference_mode():
        pe_err = (big.pos_embed.cpu() - cpu_big.pos_embed).abs().max().item()
        err = (big(x2.cuda()).cpu() - cpu_big(x2)).abs().max().item()
    print(f"resize_pos_embed(vit_base, 384): pos_embed {tuple(big.pos_embed.shape)} card vs CPU {pe_err:.3e}; f32 b2 "
          f"logits card vs CPU plain path: max|diff| {err:.3e} (bound {LOGIT_BOUND})")
    _check(tuple(big.pos_embed.shape) == (1, 577, 768) and err < LOGIT_BOUND, f"resize_pos_embed: {err}")
    del cpu_big
    big = big.to(torch.bfloat16)
    x32 = torch.randn(32, 384, 384, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(13))
    x32 = x32.to(torch.bfloat16)
    _reset(counters)
    with torch.inference_mode():
        logits = big(x32)
    counts = {fn.__name__: fn.launches for fn in counters}
    print(f"vit_base 384 px b32 bf16: logits {tuple(logits.shape)}, launches {counts}")
    _check([counts[fn.__name__] for fn in counters] == [0, 0, 0, 1, 0, 12, 12, 0], f"vit_base 384 px: {counts}")
    with torch.inference_mode():
        ms = _time_ms(lambda: big(x32), 10)
    print(f"vit_base 384 px b32 bf16: {ms:.3f} ms a request, {32 / ms * 1000:.1f} images/s on {smi}")
    del big, x32

    # get_last_self_attention at b8: f32 card against CPU
    cpu_vit = create_model("vit_base", device="cpu", torch_weights=vit_file).eval()
    x8 = torch.randn(8, 224, 224, 3, generator=torch.Generator().manual_seed(14))
    with torch.inference_mode():
        card = vit.get_last_self_attention(x8.cuda()).cpu()
        cpu = cpu_vit.get_last_self_attention(x8)
    err = (card - cpu).abs().max().item()
    print(f"get_last_self_attention vit_base b8 f32 {tuple(card.shape)}: card vs CPU max|diff| {err:.3e} "
          f"(bound {PROBS_BOUND})")
    _check(card.shape == (8, 12, 197, 197) and err < PROBS_BOUND, f"get_last_self_attention: {err}")
    del cpu_vit

    # export: vit_base b8 bf16, and resnet50 b8 behind a baked uint8 preprocess; saved, loaded, run
    x = torch.randn(8, 224, 224, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(15))
    x = x.to(torch.bfloat16)
    t0 = time.perf_counter()
    program = export_inference(vit, 8, 224, dtype=torch.bfloat16)
    save_exported(program, f"{tmp.name}/vit_base.pt2")
    loaded = load_exported(f"{tmp.name}/vit_base.pt2").module()
    print(f"vit_base b8 bf16 exported, saved and loaded in {time.perf_counter() - t0:.1f} s")
    eager = vit.to(torch.bfloat16)
    with torch.inference_mode():
        want = eager(x)
        _reset(counters)
        got = loaded(x)
        torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in counters}
    names = sorted({k for k in _device_kernels(lambda: loaded(x), iters=2) if any(n in k for n in PORT_KERNELS)})
    print(f"loaded vit_base program b8: equal to eager {torch.equal(got, want)} (max|diff| "
          f"{(got.float() - want.float()).abs().max().item():.3e}), launches {counts}, the port's kernels in its "
          f"trace {names}")
    _check(torch.equal(got, want), "the loaded vit_base program's logits differ from eager")
    _check([counts[fn.__name__] for fn in counters] == [0, 0, 0, 1, 0, 12, 12, 0], f"loaded vit_base: {counts}")
    _check(all(any(n in k for k in names) for n in ("attention_stage", "gemm_bf16", "layer_norm")),
           f"the loaded vit_base program's trace lacks the port's kernels: {names}")
    for tag, fn in (("eager", lambda: eager(x)), ("loaded program", lambda: loaded(x))):
        with torch.inference_mode():
            ms = _time_ms(fn, 10)
        print(f"vit_base b8 bf16 {tag}: {ms:.3f} ms a request, {8 / ms * 1000:.1f} images/s on {smi}")
    del program, loaded, eager, vit

    preprocess = functools.partial(imagenet_eval_pipeline, resize_size=SERVE_CANVAS, crop_size=SERVE_CROP,
                                   dtype=torch.bfloat16)
    program = export_inference(r50, 8, SERVE_CANVAS, dtype=torch.bfloat16, input_dtype=torch.uint8,
                               preprocess_fn=preprocess)
    save_exported(program, f"{tmp.name}/resnet50.pt2")
    loaded = load_exported(f"{tmp.name}/resnet50.pt2").module()
    eager, step = _cli_model("resnet50", r50_file, "--bf16")
    u8 = _canvases(8, 16)
    with torch.inference_mode():
        got, want = loaded(u8), step.scores(eager, u8)
    print(f"loaded resnet50 program b8 (uint8 {SERVE_CANVAS} px in, preprocess baked): {tuple(got.shape)}, equal to "
          f"the eager step {torch.equal(got, want)} (max|diff| {(got.float() - want.float()).abs().max().item():.3e})")
    _check(torch.equal(got, want), "the loaded resnet50 program's logits differ from the eager step")
    for tag, fn in (("eager step", lambda: step.scores(eager, u8)), ("loaded program", lambda: loaded(u8))):
        with torch.inference_mode():
            ms = _time_ms(fn, 10)
        print(f"resnet50 b8 uint8 bf16 {tag}: {ms:.3f} ms a request, {8 / ms * 1000:.1f} images/s on {smi}")
    del program, loaded, eager

    # checked_call: a NaN planted in one convolution's weight is named
    x = torch.randn(2, 224, 224, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(17))
    with torch.no_grad():
        _check(torch.equal(checked_call(r50, x), r50(x)), "checked_call changed the output")
        r50.layer2[0].conv1.weight[0, 0, 0, 0] = float("nan")
        try:
            checked_call(r50, x)
            _check(False, "checked_call let a planted NaN through")
        except FloatingPointError as e:
            print(f"checked_call on resnet50 with a NaN planted in layer2.0.conv1.weight: {e}")
            _check("layer2.0.conv1 " in str(e), f"checked_call named another module: {e}")
    _check(not any(isinstance(m, BatchNorm) and m.training for m in r50.modules()), "resnet50 left in training")
    del r50
    tmp.cleanup()
    return int8_counts


def _recompute_ms(fn):
    """Device ms of one call of ``fn`` (a train step) in all, and in the
    backward of each kernel's autograd function, which recomputes through
    the plain version (torch.profiler: a backward node's device time holds
    the kernels of the node and of the nodes it runs). An empty trace is
    taken again up to three times, then fails the run."""
    from torch.profiler import ProfilerActivity, profile

    prefix = "autograd::engine::evaluate_function: "
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total = sum(e.self_device_time_total for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
        if total:
            recompute = {e.key[len(prefix):]: e.device_time_total / 1e3 for e in events
                         if e.key.startswith(prefix) and e.key[len(prefix):] in KERNEL_BACKWARDS}
            return total / 1e3, recompute
    _check(False, "the profiler saw no kernel of a train step, three times")


def _linear_widening_ms(rows, d_in, d_out):
    """``Linear.preactivation`` under grad on the card widens a bf16 input
    and weight to f32 (``nn/linear.py``): its forward and backward at
    (rows, d_in) x (d_out, d_in) in f32 against the same product in bf16,
    CUDA events over 5 calls each, in turns."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(rows, d_in, device="cuda", generator=gen).to(torch.bfloat16).requires_grad_(True)
    w = (torch.randn(d_out, d_in, device="cuda", generator=gen) * 0.02).to(torch.bfloat16).requires_grad_(True)
    g = torch.randn(rows, d_out, device="cuda", generator=gen)

    def widened():
        F.linear(x.float(), w.float()).backward(g)

    def bf16():
        F.linear(x, w).backward(g.to(torch.bfloat16))

    t = [_time_ms(fn, 5) for fn in (bf16, widened, widened, bf16)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2


def check_ema_eval(model, run_step):
    """One EMA update across ``run_step()`` (decay 0.999: the closed form
    d p0 + (1 - d) p1 of every floating parameter and buffer in f32), then
    the EMA's weights through ``make_eval_step`` with ten-crop TTA (224 of
    256, f32) on b8, against the ten crops' softmax averaged one forward at
    a time: labels set to each image's top class (top-1 and top-5 all
    correct) and to its fifth (top-1 none, top-5 all), an image whose
    averaged probability lies within ``EVAL_TIE`` of the next class's
    excused."""
    from eqxvision_tpu_torch.ops import normalize, ten_crop
    from eqxvision_tpu_torch.parallel import ema_init, ema_params, ema_update, make_eval_step

    decay = 0.999
    ema = ema_init(model)
    before = {k: v.clone() for k, v in ema.items()}
    run_step()
    ema_update(ema, model, decay)
    now = dict(model.state_dict())
    err = max(((ema[k] - (before[k] * decay + now[k].float() * (1 - decay))).abs().max() /
               before[k].abs().max().clamp_min(1e-30)).item() for k in ema)
    print(f"EMA update of {len(ema)} tensors (decay {decay}) against its closed form: max relative |diff| {err:.2e}")
    _check(err <= 1e-6, f"EMA update off its closed form by {err}")

    eval_model = ema_params(ema, model).eval()
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = normalize(torch.randint(0, 256, (8, TRAIN_CANVAS, TRAIN_CANVAS, 3), dtype=torch.uint8, device="cuda",
                                generator=gen))
    with torch.no_grad():
        probs = torch.stack([torch.softmax(eval_model(c).float(), -1) for c in ten_crop(x, TRAIN_CROP)]).mean(0)
    p, order = probs.sort(-1, descending=True)
    step = make_eval_step(functools.partial(ten_crop, crop_h=TRAIN_CROP))
    top = step(eval_model, x, order[:, 0])
    fifth = step(eval_model, x, order[:, 4])
    tie = EVAL_TIE * p[:, 0]
    slack1 = int(((p[:, 0] - p[:, 1]) < tie).sum())
    slack5 = int(((p[:, 3] - p[:, 4]) < tie).sum() + ((p[:, 4] - p[:, 5]) < tie).sum())
    got = [int(v) for v in (*top[:2], *fifth[:2])]
    print(f"eval step, ten-crop TTA, EMA weights, b8: labels at the top class top-1/top-5 {got[0]}/{got[1]}, at the "
          f"fifth {got[2]}/{got[3]} (expected 8/8 and 0/8; near-ties excused {slack1}, {slack5})")
    _check(got[0] >= 8 - slack1 and got[1] == 8 and got[2] <= slack1 and got[3] >= 8 - slack5,
           f"eval step counts {got}")


def train(create_model, counters, name, opt, lr, weight_decay, remat, expected, ema=False, **model_kwargs):
    """``name`` trained for ``TRAIN_STEPS`` bf16 mixed-precision steps at
    b``TRAIN_BATCH`` (f32 masters, ``make_train_step``), each from uint8
    canvases (the CLI's seeded ``synthetic_batches``, copied to the card by
    ``data.device_prefetch`` and checked against the host's) through the
    CLI's on-device augmentation: crop 224 of 256, flip, label smoothing
    0.1, mixup 0.2 or cutmix 1.0. Every step must
    give a finite loss and launch ``expected`` kernels (with remat, the
    recompute's too). Prints each step's forward (augmentation included)
    and backward + optimiser ms by CUDA events, the mean of steps 2 on with
    images/s, the peak memory, and a fourth step's device time with the
    share of each kernel's plain recompute in its backward. With ``ema``,
    ``check_ema_eval`` around that fourth step. Returns the launches of the
    timed steps."""
    from eqxvision_tpu_torch.cli.train_imagenet import build_optimizer, make_augment_fn, synthetic_batches
    from eqxvision_tpu_torch.data import device_prefetch
    from eqxvision_tpu_torch.parallel import make_train_step

    model = create_model(name, generator=torch.Generator().manual_seed(0), device="cuda", **model_kwargs).train()
    optimizer = build_optimizer(model, opt, lr, weight_decay)
    step = make_train_step(compute_dtype=torch.bfloat16, remat=remat,
                           augment_fn=make_augment_fn(1000, TRAIN_CROP, 0.1, 0.2, 1.0))
    gen = torch.Generator(device="cuda").manual_seed(7)
    host = list(synthetic_batches(TRAIN_STEPS, TRAIN_BATCH, TRAIN_CANVAS, 1000, seed=8))
    batches = list(device_prefetch(host, 2, "cuda"))
    _check(all(torch.equal(t.cpu(), torch.from_numpy(a)) for b, hb in zip(batches, host) for t, a in zip(b, hb)),
           "device_prefetch: the batches on the card differ from the host's")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    times = []
    for i, (x, y) in enumerate(batches):
        before = [fn.launches for fn in counters]
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        loss = step.loss(model, x, y, gen)
        events[1].record()
        step.update(optimizer, loss)
        events[2].record()
        events[2].synchronize()
        launched = [fn.launches - n for fn, n in zip(counters, before)]
        fwd, bwd = events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2])
        times.append((fwd, bwd))
        launches = dict(zip((fn.__name__ for fn in counters), launched))
        print(f"{name} b{TRAIN_BATCH} bf16 train step {i + 1}: loss {loss.item():.4f}, {fwd + bwd:.3f} ms (forward "
              f"{fwd:.3f}, backward + optimiser {bwd:.3f}), launches {launches}")
        _check(math.isfinite(loss.item()), f"{name} train step {i + 1}: loss {loss.item()}")
        _check(launched == list(expected), f"{name} train step {i + 1}: launches {launched}, expected {list(expected)}")
    counts = {fn.__name__: fn.launches for fn in counters}
    _check(all(counts[fn.__name__] for fn, n in zip(counters, expected) if n),
           f"{name}: a kernel of the training path was never launched: {counts}")
    _check(all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in model.parameters()),
           f"{name}: the masters are not all finite f32 after training")
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd = sum(t[0] for t in times[1:]) / (len(times) - 1)
    ms = sum(t[0] + t[1] for t in times[1:]) / (len(times) - 1)
    print(f"{name} b{TRAIN_BATCH} bf16 train step ({opt}{', remat' if remat else ''}): {ms:.3f} ms, "
          f"{TRAIN_BATCH / ms * 1000:.1f} images/s; forward {fwd / ms:.1%}, backward + optimiser {1 - fwd / ms:.1%} "
          f"(steps 2-{TRAIN_STEPS}; step 1 {sum(times[0]):.3f} ms); peak memory {peak:.2f} GiB")

    def fourth_step():
        total, recompute = _recompute_ms(lambda: step(model, optimizer, *batches[0], gen))
        share = sum(recompute.values()) / total
        print(f"{name} b{TRAIN_BATCH} train step, device time (torch.profiler): {total:.3f} ms; the kernels' plain "
              f"recompute in the backward {sum(recompute.values()):.3f} ms ({share:.1%}): "
              + (", ".join(f"{k} {v:.3f}" for k, v in sorted(recompute.items())) or "none"))

    if ema:
        check_ema_eval(model, fourth_step)
    else:
        fourth_step()
    del model, optimizer
    torch.cuda.empty_cache()
    return counts


def check_train_f32(create_model, counters, lr=1.0):
    """One f32 SGD step (lr ``lr``) of vit_base b``TRAIN_F32_BATCH``, no
    dropout or drop path, on the card (the fused halves and K6, TF32 off)
    and on the CPU's plain path, from the same weights and batch: the loss
    within 2 ``LOGIT_BOUND`` (cross-entropy moves at most twice its largest
    logit error), and every updated parameter within ``lr *
    TRAIN_GRAD_BOUND`` of its tensor's largest CPU gradient, plus two f32
    steps of its largest value for the update's rounding."""
    from eqxvision_tpu_torch.parallel import make_train_step

    models = [create_model("vit_base", generator=torch.Generator().manual_seed(0), device=d).train()
              for d in ("cuda", "cpu")]
    models[1].load_state_dict(models[0].state_dict())
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(TRAIN_F32_BATCH, 224, 224, 3, generator=gen)
    y = torch.randint(0, 1000, (TRAIN_F32_BATCH,), generator=gen)
    step = make_train_step()
    _reset(counters)
    losses = [step(m, torch.optim.SGD(m.parameters(), lr=lr), x.to(d), y.to(d)).item()
              for m, d in zip(models, ("cuda", "cpu"))]
    counts = {fn.__name__: fn.launches for fn in counters}
    worst, worst_name = 0.0, None
    for (name, p), q in zip(models[0].named_parameters(), models[1].parameters()):
        bound = lr * TRAIN_GRAD_BOUND * q.grad.abs().max().item() + 2 ** -22 * q.detach().abs().max().item()
        ratio = (p.detach().cpu() - q.detach()).abs().max().item() / bound
        if ratio > worst:
            worst, worst_name = ratio, name
    print(f"vit_base b{TRAIN_F32_BATCH} f32 train step, card vs CPU plain path: loss {losses[0]:.6f} vs "
          f"{losses[1]:.6f} (bound {2 * LOGIT_BOUND}); updated parameters at most {worst:.3f} of their bound "
          f"({worst_name}); launches {counts}")
    _check(abs(losses[0] - losses[1]) <= 2 * LOGIT_BOUND, f"f32 train step: losses {losses}")
    _check(worst <= 1.0, f"f32 train step: {worst_name} off by {worst} of its bound")
    _check(list(counts.values()) == [0, 0, 0, 1, 0, 12, 12, 0], f"f32 train step: launches {counts}")


def serve_attention(A, counters):
    """The public attention as a user calls it, on the swin_t stage 1,
    vit_base b256 (without and with the relative-position bias) and vit_base
    384 px b32 bf16 shapes; one launch each, and no other kernel."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    calls = [_attn_inputs(ATTN_CASES[name][0], *ATTN_CASES[name][1:], torch.bfloat16, gen)
             for name in ("swin_t stage 1", "vit_base b256", "vit_base b256 rel-pos bias", "vit_base 384 px b32")]
    _reset(counters)
    for q, k, v, bias in calls:
        with torch.inference_mode():
            out = A.attention(q, k, v, bias)
        torch.cuda.synchronize()
        _check(out.shape == q.shape and bool(torch.isfinite(out).all()), f"attention {tuple(q.shape)} malformed")
    counts = {fn.__name__: fn.launches for fn in counters}
    print(f"attention requests {[tuple(c[0].shape) for c in calls]} bf16: launches {counts}")
    _check(counts == {fn.__name__: (len(calls) if fn is A.attention else 0) for fn in counters},
           f"attention requests: launches {counts}")
    return counts


# Phase 10, several ranks: the world (4 ranks, launch.placement: one a card
# over NCCL with four cards, else round-robin on the cards over gloo, which
# all-reduces and broadcasts CUDA tensors, where NCCL refuses two ranks on
# one card; the 2 x 2 mesh needs the four ranks), the models, and what a
# step of each launches on every rank (fused-qkv, window attention, whole
# block, LayerNorm, public attention, MLP half, attention half, Swin attention
# half). vit_base 2 x 2 with drop path 0.1 and remat: every block split (12
# heads, 6 a rank), K1 between K6s in all 12 blocks, the forward twice: 24 K1
# and 50 K6, no half. swin_t 2 x 2: stage 1's 3-head blocks stay whole, the
# rest split; every block unfused as in one-card training: 12 K3, 29 K6.
PARALLEL_WORLD = 4
PARALLEL_STEPS = 3
PARALLEL_VIT_EXPECTED = (24, 0, 0, 50, 0, 0, 0, 0)
PARALLEL_SWIN_EXPECTED = (0, 12, 0, 29, 0, 0, 0, 0)
# The f32 vit_base step on the 2 x 2 mesh against the one-card step (both on
# the card, kernels on, TF32 off): check_train_f32's bounds.
PARALLEL_F32_BATCH = 8
# resnet50's running statistics from one f32 training-mode forward of a global
# b32 at momentum 1 on 4 data ranks against one card: f32 sums in another
# order, combined in f64, through 53 BatchNorms, cuDNN's f32 convolutions
# picking their algorithms by batch size; each mean within 1e-4 of its
# channel's standard deviation, each variance within 1e-4 of its tensor's
# largest.
PARALLEL_STATS_BATCH, PARALLEL_STATS_BOUND = 32, 1e-4


def _rank_counters():
    from eqxvision_tpu_torch.ops import attention_half as AH
    from eqxvision_tpu_torch.ops import layernorm as LN
    from eqxvision_tpu_torch.ops import mlp_half as M
    from eqxvision_tpu_torch.ops import window_attention as W
    from eqxvision_tpu_torch.ops import window_attention_half as WH

    attention = importlib.import_module("eqxvision_tpu_torch.ops.attention")
    return attention, [attention.fused_qkv_attention, attention.window_qkv_attention, W.fused_swin_block,
                       LN.layer_norm, attention.attention, M.fused_mlp_half, AH.fused_attention_half,
                       WH.fused_window_attention_half]


def _heads_probe(attention):
    """Record the heads K1 and K3/K4 launch with, at their launch functions."""
    heads = {"K1": [], "K3": []}
    k1, k3 = attention._launch_kernel, attention._launch_window_kernel

    def launch_k1(qkv, num_heads, scale):
        heads["K1"].append(num_heads)
        return k1(qkv, num_heads, scale)

    def launch_k3(qkv, bias, num_heads, scale, cosine_gs):
        heads["K3"].append(num_heads)
        return k3(qkv, bias, num_heads, scale, cosine_gs)

    attention._launch_kernel, attention._launch_window_kernel = launch_k1, launch_k3
    return heads


def _rank_train(name, mesh, dev, counters, expected, opt, steps, **model_kwargs):
    """``steps`` bf16 steps of ``name`` on ``mesh`` at global b TRAIN_BATCH
    through the CLI's augmentation; every step's launches must be
    ``expected``. Returns the losses, ms a step (steps 2 on), peak memory
    and the model."""
    from eqxvision_tpu_torch.cli.train_imagenet import build_optimizer, make_augment_fn, synthetic_batches
    from eqxvision_tpu_torch.models import create_model
    from eqxvision_tpu_torch.parallel import make_train_step, parallelize, seed_rank, shard_batch

    seed = seed_rank(0, mesh)
    model = create_model(name, generator=torch.Generator().manual_seed(0), device=dev, **model_kwargs).train()
    parallelize(model, mesh)
    optimizer = build_optimizer(model, opt, 1e-3 if opt == "adamw" else 0.025, 0.05 if opt == "adamw" else 1e-4)
    step = make_train_step(compute_dtype=torch.bfloat16, remat=name == "vit_base",
                           augment_fn=make_augment_fn(1000, TRAIN_CROP, 0.1, 0.2, 1.0), mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batches = [[torch.from_numpy(t).to(dev) for t in shard_batch(b, mesh)]
               for b in synthetic_batches(steps, TRAIN_BATCH, TRAIN_CANVAS, 1000, seed=8)]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset(counters)
    losses, times, launches = [], [], []
    for x, y in batches:
        before = [fn.launches for fn in counters]
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        loss = step(model, optimizer, x, y, gen)
        events[1].record()
        events[1].synchronize()
        launches.append([fn.launches - n for fn, n in zip(counters, before)])
        losses.append(loss.item())
        times.append(events[0].elapsed_time(events[1]))
    for i, got in enumerate(launches):
        _check(got == list(expected), f"rank {mesh.rank} {name} step {i + 1}: launches {got}, expected {list(expected)}")
    _check(all(math.isfinite(v) for v in losses), f"rank {mesh.rank} {name}: losses {losses}")
    ms = sum(times[1:]) / max(len(times) - 1, 1) if len(times) > 1 else times[0]
    return {"losses": losses, "ms": ms, "step1_ms": times[0],
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}, model


def _rank_parallel(work):
    """One rank of phase 10 (``parallel.launch`` runs it in each process)."""
    import torch.distributed as dist

    from eqxvision_tpu_torch import _native
    from eqxvision_tpu_torch.models import create_model
    from eqxvision_tpu_torch.nn import BatchNorm
    from eqxvision_tpu_torch.parallel import (
        Shard,
        make_mesh,
        make_train_step,
        param_shardings,
        parallelize,
        shard_batch,
        shard_params_tp,
    )
    from eqxvision_tpu_torch.nn.collectives import RowParallelLinear
    from eqxvision_tpu_torch.parallel.launch import rank_device
    from eqxvision_tpu_torch.parallel.mesh import shard_tensor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    dev = rank_device()
    _native.library()  # the parent built it: this loads it
    attention, counters = _rank_counters()
    heads = _heads_probe(attention)
    out = {"device": str(dev), "backend": dist.get_backend()}
    mesh22, mesh41 = make_mesh(data=2, model=2), make_mesh(data=4, model=1)

    # vit_base 2 x 2, bf16 AdamW, drop path 0.1, remat
    res, model = _rank_train("vit_base", mesh22, dev, counters, PARALLEL_VIT_EXPECTED, "adamw", PARALLEL_STEPS,
                             drop_path_rate=0.1)
    _check(set(heads["K1"]) == {6}, f"rank {rank} vit_base: K1 launched with heads {sorted(set(heads['K1']))}")
    res["split"] = [sum(isinstance(b.attn.proj, RowParallelLinear) for b in model.blocks), len(model.blocks)]
    out["vit_base"] = res
    del model
    torch.cuda.empty_cache()

    # f32 vit_base b8 SGD step on 2 x 2 against the one-card step (the parent's)
    ref = torch.load(work + "/f32_reference.pt", weights_only=True)
    model = create_model("vit_base", generator=torch.Generator().manual_seed(0), device=dev).train()
    shard_params_tp(model, mesh22)
    loss = make_train_step(mesh=mesh22)(model, torch.optim.SGD(model.parameters(), lr=1.0),
                                        *shard_batch((ref["x"].to(dev), ref["y"].to(dev)), mesh22))
    shardings = param_shardings(model, mesh22)
    worst, worst_name = 0.0, None
    for name, p in model.named_parameters():
        want = ref["after"][name]
        if shardings[name] is not None:
            want = shard_tensor(want, Shard(*shardings[name]), mesh22.model, mesh22.model_index)
        ratio = (p.detach().cpu() - want).abs().max().item() / ref["bound"][name]
        if ratio > worst:
            worst, worst_name = ratio, name
    out["f32"] = {"loss": loss.item(), "worst": worst, "worst_name": worst_name}
    del model
    torch.cuda.empty_cache()

    # swin_t 2 x 2, one bf16 AdamW step
    heads["K3"].clear()
    res, model = _rank_train("swin_t", mesh22, dev, counters, PARALLEL_SWIN_EXPECTED, "adamw", 1)
    res["heads"] = sorted(set(heads["K3"]))
    res["split"] = [isinstance(b.attn.proj, RowParallelLinear) for b in model.modules()
                    if hasattr(b, "stochastic_depth")]
    out["swin_t"] = res
    del model
    torch.cuda.empty_cache()

    # resnet50 on 4 data ranks with synchronised BatchNorm: three bf16 SGD steps, then the statistics
    res, model = _rank_train("resnet50", mesh41, dev, counters, (0,) * 8, "sgd", PARALLEL_STEPS)
    if rank == 0:
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, work + "/resnet50_after_steps.pt")
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.momentum = 1.0
    x = torch.randn(PARALLEL_STATS_BATCH, TRAIN_CROP, TRAIN_CROP, 3, generator=torch.Generator().manual_seed(14))
    with torch.no_grad():
        model(shard_batch(x, mesh41).to(dev))
    stats = {k: v.cpu() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    res["stats"] = stats if rank == 0 else None
    res["stats_sum"] = sum(v.double().sum().item() for v in stats.values())
    out["resnet50"] = res
    dist.barrier()
    return out


def train_parallel(create_model, smi):
    """Phase 10: the training path on several ranks (``parallel.launch``):
    vit_base and swin_t on a 2 x 2 mesh, resnet50 on 4 data ranks; an f32
    vit_base step against one card, resnet50's statistics against one
    card. Any rank's failure fails the run. The files the ranks share
    live in a temporary directory, removed after."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="eqx_parallel_") as work:
        return _train_parallel(create_model, smi, work)


def _train_parallel(create_model, smi, work):
    from eqxvision_tpu_torch.entry import dryrun_multichip
    from eqxvision_tpu_torch.parallel import launch, make_train_step

    n = PARALLEL_WORLD
    backend, devices = launch.placement(n, "cuda")
    shared = len(set(devices)) < n
    print(f"training on several ranks: a world of {n}, backend {backend}, devices {[str(d) for d in devices]} on "
          f"{smi}" + (" (ranks share a card: no multi-card speed)" if shared else ""))

    # the one-card f32 step that the sharded one is held to
    model = create_model("vit_base", generator=torch.Generator().manual_seed(0), device="cuda").train()
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(PARALLEL_F32_BATCH, 224, 224, 3, generator=gen)
    y = torch.randint(0, 1000, (PARALLEL_F32_BATCH,), generator=gen)
    loss = make_train_step()(model, torch.optim.SGD(model.parameters(), lr=1.0), x.cuda(), y.cuda()).item()
    bound = {name: TRAIN_GRAD_BOUND * p.grad.abs().max().item() + 2 ** -22 * p.detach().abs().max().item()
             for name, p in model.named_parameters()}
    torch.save({"x": x, "y": y, "loss": loss, "bound": bound,
                "after": {k: p.detach().cpu() for k, p in model.named_parameters()}}, work + "/f32_reference.pt")
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    results = launch.run(_rank_parallel, n, (work,), device="cuda", timeout_s=900)
    print(f"phase 10 world: {time.perf_counter() - t0:.1f} s (start-up, builds from the parent's library)")
    for r, res in enumerate(results):
        print(f"rank {r} on {res['device']} ({res['backend']}): " + "; ".join(
            f"{k} losses {[round(v, 4) for v in res[k]['losses']]}" for k in ("vit_base", "swin_t", "resnet50")))
    for name, mesh, steps in (("vit_base", "2 x 2", PARALLEL_STEPS), ("swin_t", "2 x 2", 1),
                              ("resnet50", "4 x 1", PARALLEL_STEPS)):
        ms = max(res[name]["ms"] for res in results)
        peak = max(res[name]["peak_gib"] for res in results)
        print(f"{name} {mesh} global b{TRAIN_BATCH} bf16 train step ({steps} steps; slowest rank, "
              f"{'steps 2 on' if steps > 1 else 'step 1'}): {ms:.3f} ms, {TRAIN_BATCH / ms * 1000:.1f} images/s, "
              f"peak memory a rank {peak:.2f} GiB, launches a step as expected on every rank, on {smi}"
              + (f" ({n} ranks on {len(set(devices))} card(s) over gloo: no multi-card speed)" if shared else ""))
    for name in ("vit_base", "swin_t", "resnet50"):
        losses = {tuple(res[name]["losses"]) for res in results}
        _check(len(losses) == 1, f"{name}: the ranks report different global losses {losses}")
    print(f"vit_base 2 x 2: {'{} of {}'.format(*results[0]['vit_base']['split'])} blocks split, K1 with 6 heads a "
          f"rank; "
          f"swin_t 2 x 2: blocks split {results[0]['swin_t']['split']}, K3 with heads {results[0]['swin_t']['heads']}")
    _check(results[0]["vit_base"]["split"][0] == results[0]["vit_base"]["split"][1], "vit_base: a block not split")
    _check(results[0]["swin_t"]["heads"] == [3, 6, 12], f"swin_t K3 heads {results[0]['swin_t']['heads']}")

    f32 = [res["f32"] for res in results]
    worst = max(f32, key=lambda f: f["worst"])
    print(f"vit_base b{PARALLEL_F32_BATCH} f32 train step, 2 x 2 mesh vs one card: loss {f32[0]['loss']:.6f} vs "
          f"{loss:.6f} (bound {2 * LOGIT_BOUND}); parameters at most {worst['worst']:.3f} of their bound "
          f"({worst['worst_name']})")
    _check(all(abs(f["loss"] - loss) <= 2 * LOGIT_BOUND for f in f32), f"f32 sharded step: losses {f32}")
    _check(worst["worst"] <= 1.0, f"f32 sharded step: {worst['worst_name']} off by {worst['worst']} of its bound")

    _check(len({res["resnet50"]["stats_sum"] for res in results}) == 1,
           "resnet50: the ranks' running statistics differ")
    from eqxvision_tpu_torch.nn import BatchNorm

    model = create_model("resnet50", generator=torch.Generator().manual_seed(0), device="cuda")
    model.load_state_dict(torch.load(work + "/resnet50_after_steps.pt", weights_only=True))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 1.0
    x = torch.randn(PARALLEL_STATS_BATCH, TRAIN_CROP, TRAIN_CROP, 3, generator=torch.Generator().manual_seed(14))
    with torch.no_grad():
        model.train()(x.cuda())
    got = results[0]["resnet50"]["stats"]
    want = {k: v.cpu() for k, v in model.state_dict().items() if k in got}
    worst, worst_name = 0.0, None
    for k, v in got.items():
        if k.endswith("running_mean"):  # in units of the channel's standard deviation
            var = want[k.replace("running_mean", "running_var")]
            err = ((v - want[k]).abs() / (var + 1e-5).sqrt()).max().item()
        else:
            err = ((v - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
        if err > worst:
            worst, worst_name = err, k
    print(f"resnet50 4 x 1 synchronised BatchNorm, f32 b{PARALLEL_STATS_BATCH} statistics against one card: "
          f"{len(got)} tensors, at most {worst:.2e} (a mean's error over its channel's standard deviation, a "
          f"variance's over its tensor's largest; {worst_name}; bound {PARALLEL_STATS_BOUND})")
    _check(worst <= PARALLEL_STATS_BOUND, f"resnet50 synchronised statistics: {worst_name} off by {worst}")
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    losses = dryrun_multichip(n, timeout_s=300)
    print(f"entry.dryrun_multichip({n}) on the cards ({backend}): losses {losses}, "
          f"{time.perf_counter() - t0:.1f} s with start-up")
    _check(set(losses) == {"vit", "resnet18"} and all(math.isfinite(v) for v in losses.values()),
           f"dryrun_multichip: losses {losses}")
    return results


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card", file=sys.stderr)
        return 1
    from eqxvision_tpu_torch import _native
    from eqxvision_tpu_torch.models import create_model
    from eqxvision_tpu_torch.ops import attention_half as AH
    from eqxvision_tpu_torch.ops import layernorm as LN
    from eqxvision_tpu_torch.ops import mlp_half as M
    from eqxvision_tpu_torch.ops import window_attention as W
    from eqxvision_tpu_torch.ops import window_attention_half as WH

    attention = importlib.import_module("eqxvision_tpu_torch.ops.attention")  # ops.attention is the public op

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _native.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({_native.library_path().name})")
    times = re.findall(r" -c -o \S+ \S*/(\S+)\ncompiled in ([\d.]+) s", _native.build_log())
    print("compile time per source (parallel): " + ", ".join(f"{src} {secs} s" for src, secs in times))
    print(_native.build_log().strip())
    if sys.argv[1:] == ["--only-parallel"]:  # phase 10 alone, e.g. on four cards; prints no result line
        print(smi)
        train_parallel(create_model, smi)
        print("phase 10 alone: passed")
        return 0

    check_gemm(M, AH, W, WH, _native.build_log())
    qkv_main = check_fused_qkv(attention, _native.library(), _native.build_log())
    window_main = check_window_attention(attention, _native.library(), _native.build_log())
    block_main = check_block(W, _native.build_log())
    check_ragged(W)
    ln_main = check_layer_norm(LN)
    attn_main = check_attention(attention, _native.library())
    mlp_main = check_mlp_half(M)
    attn_half_main = check_attention_half(AH)
    window_half_main = check_window_attention_half(W, WH)
    check_bias_layers()
    check_batchnorm()

    # per forward: fused-qkv, window attention, whole block, LayerNorm, public attention, MLP half, attention half,
    # Swin attention half
    counters = [attention.fused_qkv_attention, attention.window_qkv_attention, W.fused_swin_block, LN.layer_norm,
                attention.attention, M.fused_mlp_half, AH.fused_attention_half, WH.fused_window_attention_half]
    vit_counts = serve(create_model, "vit_base", 224, VIT_REQUESTS, counters, (0, 0, 0, 1, 0, 12, 12, 0))
    # swin_t: stages 1-2 on the whole block, stages 3-4 on the two fused halves; K6 in the stem, mergings and head
    swin_counts = serve(create_model, "swin_t", 224, SWIN_REQUESTS, counters, (0, 0, 4, 5, 0, 8, 0, 8))
    swin_v2_counts = serve(create_model, "swin_v2_t", 256, SWIN_REQUESTS, counters, (0, 8, 4, 21, 0, 0, 0, 0))
    # layer_scale 0.5: at the default 1e-6 every block is nearly an identity,
    # and the card-vs-CPU comparison would not see the blocks
    convnext_counts = serve(create_model, "convnext_tiny", 224, CONVNEXT_REQUESTS, counters,
                            (0, 0, 0, 5, 0, 18, 0, 0), layer_scale=0.5)
    attn_counts = serve_attention(attention, counters)
    # the conv trunks run no kernel of the port
    zeros = (0,) * len(counters)
    serve(create_model, "resnet50", 224, RESNET_REQUESTS, counters, zeros, prepare=calibrate_batchnorm)
    serve_folded(create_model, counters)
    serve(create_model, "alexnet", 224, ALEXNET_REQUESTS, counters, zeros)
    serve(create_model, "vgg16_bn", 224, VGG_REQUESTS, counters, zeros, prepare=calibrate_batchnorm)
    print(f"mobile families on {smi}")
    for name in ("mobilenet_v3_large", "efficientnet_b0"):
        serve(create_model, name, 224, MOBILE_REQUESTS, counters, zeros, prepare=calibrate_batchnorm)
    for name in ("mobilenet_v2", "regnet_y_400mf"):
        serve(create_model, name, 224, (8,), counters, zeros, prepare=calibrate_batchnorm)
    print(f"model zoo on {smi}")
    serve(create_model, "googlenet", 224, ZOO_REQUESTS, counters, zeros, prepare=calibrate_batchnorm,
          transform_input=True)
    serve(create_model, "shufflenet_v2_x1_0", 224, ZOO_REQUESTS, counters, zeros, prepare=calibrate_batchnorm)
    serve(create_model, "densenet121", 224, (8,), counters, zeros, prepare=calibrate_batchnorm)
    serve(create_model, "squeezenet1_1", 224, (8,), counters, zeros)  # no BatchNorm
    for name, (requests, kwargs) in SEG_MODELS.items():
        serve_segmentation(create_model, name, requests, counters, 2 if kwargs else 1, **kwargs)
    print(f"training on {smi}")
    train_counts = {name: train(create_model, counters, name, **cfg) for name, cfg in TRAIN.items()}
    wide, narrow = _linear_widening_ms(TRAIN_BATCH * 197, 768, 3072)
    print(f"Linear.preactivation under grad (vit_base b{TRAIN_BATCH} fc1, 11 blocks a forward in training): f32 "
          f"forward + backward {wide:.3f} ms against {narrow:.3f} in bf16, {11 * (wide - narrow):.3f} ms a step "
          f"(without remat's second forward)")
    check_train_f32(create_model, counters)
    serve_transforms(create_model, counters, smi)
    train_parallel(create_model, smi)

    src = "eqxvision_tpu_torch/csrc/"
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "fused_qkv_attention", "route": "cuda", "source": src + "attention_stage.cuh",
         "replaces": ["eqxvision_tpu/ops/attention.py:245", "eqxvision_tpu/ops/attention.py:276"],
         "launches": train_counts["vit_base"]["fused_qkv_attention"], **qkv_main},
        {"name": "window_qkv_attention", "route": "cuda",
         "source": [src + "window_attention.cu", src + "attention_stage.cuh"],
         "replaces": ["eqxvision_tpu/ops/attention.py:445", "eqxvision_tpu/ops/attention.py:682",
                      "scripts/ablate_swin2.py:71", "scripts/ablate_swin9.py:53"],
         "launches": swin_v2_counts["window_qkv_attention"], **window_main},
        {"name": "fused_swin_block", "route": "cuda", "source": src + "swin_block.cu",
         "replaces": ["eqxvision_tpu/ops/window_attention.py:79", "scripts/ablate_swin8.py:43"],
         "launches": swin_counts["fused_swin_block"], **block_main},
        {"name": "layer_norm", "route": "cuda", "source": src + "layer_norm.cu",
         "replaces": ["eqxvision_tpu/ops/layernorm.py:44"],
         "launches": convnext_counts["layer_norm"], **ln_main},
        {"name": "attention", "route": "cuda",
         "source": [src + "attention.cu", src + "window_attention.cu", src + "attention_stage.cuh"],
         "replaces": ["eqxvision_tpu/ops/attention.py:121", "eqxvision_tpu/ops/attention.py:193"],
         "launches": attn_counts["attention"], **attn_main},
        {"name": "fused_mlp_half", "route": "cuda", "source": src + "mlp_half.cu",
         "replaces": ["scripts/ablate_convnext2.py:73", "scripts/ablate_vit2.py:114", "scripts/ablate_vit3.py:121",
                      "scripts/ablate_vit4.py:196"],
         "launches": vit_counts["fused_mlp_half"], **mlp_main},
        {"name": "fused_attention_half", "route": "cuda", "source": src + "attention_half.cu",
         "replaces": ["scripts/ablate_vit2.py:172", "scripts/ablate_vit4.py:145"],
         "launches": vit_counts["fused_attention_half"], **attn_half_main},
        {"name": "fused_window_attention_half", "route": "cuda", "source": src + "window_attention_half.cu",
         "replaces": ["scripts/ablate_swin3.py:63", "scripts/ablate_swin4.py:65"],
         "launches": swin_counts["fused_window_attention_half"], **window_half_main},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
