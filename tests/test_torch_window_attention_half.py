"""The fused Swin v1 attention half of the PyTorch port against the JAX
prototypes and the JAX model.

The port's ``ops.fused_window_attention_half`` (on a CPU tensor its plain
version, ``window_attention_half_reference``) takes the same seeded numpy
inputs as the Pallas prototypes it ports, run in interpret mode with
``pl.pallas_call`` patched to pass ``interpret=True``; the scripts are
imported as they are:

- P7 ``fused_attn_half`` (scripts/ablate_swin3.py), shifted (a bias per
  window) and unshifted (one shared bias);
- P8 ``flat_fused_block`` (scripts/ablate_swin4.py), the whole v1 block on
  windows padded from 49 to 64 tokens, against the port's pair, this op
  then ``ops.fused_mlp_half``.

The prototypes take their weights Cp-packed (each of q, k and v padded to
128 lanes) and their bias packed (nW | 1, L, H * L); the tests pack them
with the prototypes' layout. f32 at atol and rtol 2e-5: both sides take the
LayerNorm statistics, the scores and softmax and all products in f32, in
another order. Also: the bf16 rounding choice against P7 and against the
JAX model's unfused block; a map that is not a multiple of the window,
whose windows hold padding tokens, against the JAX model's block; a
swin_t-shaped model of reduced depth against the JAX model; the gradient;
the refusals. The CUDA kernel itself is compared with the plain version in
tests/test_torch_kernels_cuda.py.
"""
import functools
import importlib
import importlib.util
import os

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqxvision_tpu.core import tree_inference
from eqxvision_tpu.core.module import replace
from eqxvision_tpu.models import create_model as jax_create_model
from eqxvision_tpu.models.classification import swin as jax_swin
from eqxvision_tpu.weights.serialize import _flatten_with_paths
from eqxvision_tpu_torch.models import create_model
from eqxvision_tpu_torch.models.classification import swin as port_swin
from eqxvision_tpu_torch.ops import window_attention as TW
from eqxvision_tpu_torch.ops import window_attention_half as T
from eqxvision_tpu_torch.ops.mlp_half import fused_mlp_half
from eqxvision_tpu_torch.weights import load_jax_params

JA = importlib.import_module("eqxvision_tpu.ops.attention")
WA = importlib.import_module("eqxvision_tpu.ops.window_attention")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=2e-5)
WIN = (7, 7)
L = 49


@functools.lru_cache(maxsize=None)
def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret(monkeypatch):
    calls = []
    orig = pl.pallas_call

    def wrapper(*args, **kwargs):
        calls.append(1)
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", wrapper)
    return calls


def _params(c, seed, hidden=None):
    """LayerNorm affine, qkv and proj (and an MLP where ``hidden``), JAX
    layout (in, out), at the models' scales, f32."""
    rng = np.random.RandomState(seed)
    p = dict(
        lnw=1.0 + 0.2 * rng.randn(c), lnb=0.2 * rng.randn(c), wqkv=rng.randn(c, 3 * c) * c**-0.5,
        bqkv=0.2 * rng.randn(3 * c), wproj=rng.randn(c, c) * c**-0.5, bproj=0.2 * rng.randn(c),
    )
    if hidden:
        p.update(ln2w=1.0 + 0.2 * rng.randn(c), ln2b=0.2 * rng.randn(c), w1=rng.randn(c, hidden) * c**-0.5,
                 b1=0.2 * rng.randn(hidden), w2=rng.randn(hidden, c) * hidden**-0.5, b2=0.2 * rng.randn(c))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _packed(p, c):
    """The prototypes' Cp-packed qkv and proj: q, k and v each padded to 128
    lanes, proj's rows to match."""
    cp = -(-c // 128) * 128
    pad = lambda a: np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, cp - c)])  # noqa: E731
    wqkv = np.concatenate([pad(w) for w in np.split(p["wqkv"], 3, axis=1)], axis=1)
    bqkv = np.concatenate([pad(b) for b in np.split(p["bqkv"], 3)])
    return wqkv, bqkv, np.pad(p["wproj"], ((0, cp - c), (0, 0)))


def _pack_bias(bias):
    """(nW | 1, H, L, L) -> the prototypes' (nW | 1, L, H * L)."""
    nb, h, l, _ = bias.shape
    return np.ascontiguousarray(bias.transpose(0, 2, 1, 3).reshape(nb, l, h * l))


def _windows(n, side, c, heads, shifted, seed):
    """Windows of a seeded NHWC map (padded, rolled, partitioned by the
    port's own plumbing), the window bias (a relative-position bias of std 1
    plus the shift mask) and the padding flags."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, side, side, c).astype(np.float32))
    xw, geo = TW._to_windows(x, WIN, (3, 3) if shifted else (0, 0))
    rel = torch.from_numpy(rng.randn(1, heads, L, L).astype(np.float32))
    return xw.contiguous(), TW._window_bias(rel, WIN, heads, geo), T._valid_rows_on(xw.device, geo, *WIN), geo


def _port_half(xw, p, bias, heads, scale, valid=None, dtype=torch.float32):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    return T.fused_window_attention_half(
        xw.to(dtype), t["lnw"], t["lnb"], t["wqkv"].T, t["bqkv"], t["wproj"].T, t["bproj"], bias, heads, scale, 1e-5,
        valid,
    )


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted-shared-bias", "shifted-bias-per-window"])
def test_plain_matches_p7_interpret(shifted, interpret):
    c, heads = 64, 2
    xw, bias, valid, _ = _windows(2, 14, c, heads, shifted, seed=1)
    assert valid is None and bias.shape[0] == (4 if shifted else 1)
    p = _params(c, seed=2)
    scale = (c // heads) ** -0.5
    wqkv_p, bqkv_p, wproj_p = _packed(p, c)
    ref = _script("ablate_swin3").fused_attn_half(
        jnp.asarray(xw.numpy()), jnp.asarray(p["lnw"]), jnp.asarray(p["lnb"]), jnp.asarray(wqkv_p),
        jnp.asarray(bqkv_p), jnp.asarray(wproj_p), jnp.asarray(p["bproj"]), jnp.asarray(_pack_bias(bias.numpy())),
        heads, c, scale, with_proj=True,
    )
    assert len(interpret) == 1
    out = _port_half(xw, p, bias, heads, scale)
    assert out.shape == xw.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_pair_matches_p8_interpret(shifted, interpret):
    """This op then fused_mlp_half computes P8's block on the 49 real
    tokens; P8 pads each window to 64 tokens (zero rows, pad keys at -1e9)
    and its first 49 rows are compared."""
    c, heads, hidden = 64, 4, 256
    xw, bias, _, _ = _windows(2, 14, c, heads, shifted, seed=3)
    p = _params(c, seed=4, hidden=hidden)
    scale = (c // heads) ** -0.5
    wqkv_p, bqkv_p, wproj_p = _packed(p, c)
    x64 = np.pad(xw.numpy(), ((0, 0), (0, 0), (0, 64 - L), (0, 0)))
    bias64 = np.pad(bias.numpy(), ((0, 0), (0, 0), (0, 64 - L), (0, 64 - L)))
    bias64[..., L:] = -1e9
    params = tuple(jnp.asarray(a) for a in (p["lnw"], p["lnb"], wqkv_p, bqkv_p, wproj_p, p["bproj"], p["ln2w"],
                                            p["ln2b"], p["w1"], p["b1"], p["w2"], p["b2"]))
    ref = _script("ablate_swin4").flat_fused_block(jnp.asarray(x64), params, jnp.asarray(_pack_bias(bias64)), heads,
                                                   c, scale, eps=1e-5)
    assert len(interpret) == 1
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    h = _port_half(xw, p, bias, heads, scale)
    out = fused_mlp_half(h, h, t["ln2w"], t["ln2b"], t["w1"].T, t["b1"], t["w2"].T, t["b2"], None, 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, :, :L], **TOL)


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _steps_off(got, ref):
    """|got - ref| in bf16 steps at each output's magnitude, taken at 1 for
    the smaller ones (the residual and the branch are of order 1)."""
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1.0))) - 7)
    return np.abs(got - ref) / step


def _jax_block(c, heads, shift, seed, table_scale=50.0, v2=False):
    """A JAX block (v1, or v2 with 8 x 8 windows) with LayerNorm affines
    drawn away from (1, 0) (so that a padding token's LayerNorm would not be
    0), v1's relative-position table scaled up from its std-0.02 init, and
    every parameter rounded to bf16 values (kept in f32); and the same
    parameters for the port as numpy, JAX layout."""
    key = jax.random.PRNGKey(seed)
    if v2:
        blk = jax_swin._SwinTransformerBlockV2(c, heads, (8, 8), shift, attn_layer=jax_swin._ShiftedWindowAttentionV2,
                                               key=key)
    else:
        blk = jax_swin._SwinTransformerBlock(c, heads, WIN, shift, key=key)
    rng = np.random.RandomState(seed)

    def affine(norm):
        return replace(norm, weight=jnp.asarray(1.0 + 0.2 * rng.randn(c), jnp.float32),
                       bias=jnp.asarray(0.2 * rng.randn(c), jnp.float32))

    blk = replace(blk, norm1=affine(blk.norm1), norm2=affine(blk.norm2))
    if not v2:
        table = blk.attn.relative_position_bias_table * table_scale
        blk = replace(blk, attn=replace(blk.attn, relative_position_bias_table=table))
    blk = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), blk)
    return blk, {k: np.asarray(v) for k, v in _flatten_with_paths(blk)}


def test_bf16_rounding_follows_prototype(interpret):
    """In bf16 the op rounds where P7 does: the qkv product, then its bias,
    each rounded; p; each head's output; and the projection, its bias and x
    summed in f32 and rounded once. Against P7, outputs differ in a few
    places by one step (f32 sums in another order). Against the JAX model's
    unfused bf16 block, which rounds the projection, then adds its bias and
    then x, each in bf16, they differ in many places, each by at most one
    step."""
    c, heads = 64, 2
    blk, w = _jax_block(c, heads, (3, 3), seed=5)
    x = _bf16(np.random.RandomState(6).randn(2, 14, 14, c))
    xb = jnp.asarray(x, jnp.bfloat16)
    unfused = np.asarray((xb + blk.attn(blk.norm1(xb))).astype(jnp.float32))
    xw, geo = TW._to_windows(torch.from_numpy(x), WIN, (3, 3))
    rel = torch.from_numpy(np.array(blk.attn._relative_position_bias()))
    bias = TW._window_bias(rel, WIN, heads, geo)
    p = dict(lnw=w[".norm1.weight"], lnb=w[".norm1.bias"], wqkv=w[".attn.qkv.weight"], bqkv=w[".attn.qkv.bias"],
             wproj=w[".attn.proj.weight"], bproj=w[".attn.proj.bias"])
    scale = (c // heads) ** -0.5
    wqkv_p, bqkv_p, wproj_p = _packed(p, c)
    proto = _script("ablate_swin3").fused_attn_half(
        jnp.asarray(xw.numpy(), jnp.bfloat16), jnp.asarray(p["lnw"]), jnp.asarray(p["lnb"]),
        jnp.asarray(wqkv_p, jnp.bfloat16), jnp.asarray(bqkv_p), jnp.asarray(wproj_p, jnp.bfloat16),
        jnp.asarray(p["bproj"]), jnp.asarray(_pack_bias(bias.numpy())), heads, c, scale, with_proj=True,
    )
    out = _port_half(xw, p, bias, heads, scale, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    off_proto = _steps_off(out.float().numpy(), np.asarray(proto.astype(jnp.float32)))
    off_unfused = _steps_off(TW._from_windows(out, WIN, geo).float().numpy(), unfused)
    assert off_proto.max() <= 1.0 and float((off_proto > 0).mean()) < 0.01
    assert off_unfused.max() <= 1.0 and float((off_unfused > 0).mean()) > 0.05


def _port_block(jax_blk, params, v2=False):
    """The port's block with the JAX block's parameters: a one-entry
    ModuleDict gives the JAX paths the prefix the name map expects."""
    c, heads = jax_blk.norm1.weight.shape[0], jax_blk.attn.num_heads
    kw = dict(generator=torch.Generator().manual_seed(0), device="cpu")
    if v2:
        blk = port_swin._SwinTransformerBlockV2(c, heads, jax_blk.attn.window_size, jax_blk.attn.shift_size,
                                                attn_layer=port_swin._ShiftedWindowAttentionV2, **kw)
    else:
        blk = port_swin._SwinTransformerBlock(c, heads, jax_blk.attn.window_size, jax_blk.attn.shift_size, **kw)
    load_jax_params(torch.nn.ModuleDict({"b": blk}), {".b" + k: v for k, v in params.items()})
    return blk


@pytest.mark.parametrize("side,shift", [(10, (0, 0)), (9, (3, 3))], ids=["10x10-unshifted", "9x9-shifted"])
def test_ragged_block_matches_jax_unfused_block(side, shift):
    """A C > 192 block on a map that is not a multiple of the window: the
    port's fused halves (plain versions on the CPU) against the JAX model's
    block (its unfused path), f32. The padding tokens are zeroed after
    norm1, as the JAX block pads; without the flags the op differs. (On a
    shifted 10 x 10 map the shift mask alone keeps the padding tokens apart
    from the image's; on a 9 x 9 one it does not.)"""
    c, heads = 256, 8
    jblk, w = _jax_block(c, heads, shift, seed=7, table_scale=1.0)
    jblk = tree_inference(jblk, True)
    x = np.random.RandomState(side).randn(2, side, side, c).astype(np.float32)
    ref = np.asarray(jblk(jnp.asarray(x)))
    blk = _port_block(jblk, w).eval()
    calls = []
    orig = T.fused_window_attention_half

    def counted(*args, **kwargs):
        calls.append(args[-1])  # the flags
        return orig(*args, **kwargs)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "fused_window_attention_half", counted)
        out = blk(torch.from_numpy(x)).numpy()
        assert len(calls) == 1 and calls[0] is not None
        mp.setattr(T, "_valid_rows_on", lambda *a: None)
        unflagged = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    assert np.abs(unflagged - ref).max() > 1e-2


def test_swin_t_shaped_model_matches_jax():
    """swin_t's widths (96 to 768, heads 3 to 24, window 7) at depths 1, 1,
    2, 2 and 160 px (stage 3 a shifted 10 x 10 map padded to 14 x 14, stage
    4 a 5 x 5 map in one window): f32 logits against the JAX model at 1e-4,
    the stage-3 and -4 blocks on the fused halves, no kernel launched."""
    kwargs = dict(depths=(1, 1, 2, 2), num_classes=10, stochastic_depth_prob=0.1)
    model, state = jax_create_model("swin_t", **kwargs)
    model = tree_inference(model, True)
    x = np.random.RandomState(8).randn(1, 160, 160, 3).astype(np.float32)
    ref, _ = jax.jit(lambda m, t, s: m(t, s))(model, jnp.asarray(x), state)
    params = {k: np.asarray(v) for k, v in _flatten_with_paths(model)}
    port = load_jax_params(create_model("swin_t", device="cpu", **kwargs), params).eval()
    calls = []
    orig = T.fused_window_attention_half
    before = orig.launches
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "fused_window_attention_half", lambda *a, **k: calls.append(1) or orig(*a, **k))
        out = port(torch.from_numpy(x)).numpy()
    assert len(calls) == 4 and orig.launches == before  # CPU: the plain version, no kernel
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_gradient_matches_autograd_through_reference():
    c, heads = 32, 2
    xw, bias, valid, _ = _windows(1, 10, c, heads, True, seed=9)
    p = _params(c, seed=10)
    inputs = [xw.numpy(), p["lnw"], p["lnb"], p["wqkv"].T, p["bqkv"], p["wproj"].T, p["bproj"]]
    g = np.random.RandomState(11).randn(*xw.shape)
    leaves = [torch.tensor(np.ascontiguousarray(a), requires_grad=True) for a in inputs]
    T.fused_window_attention_half(*leaves, bias, heads, None, 1e-5, valid).backward(torch.from_numpy(g).float())
    refs = [torch.tensor(np.ascontiguousarray(a), dtype=torch.float64, requires_grad=True) for a in inputs]
    T.window_attention_half_reference(*refs, bias.double(), heads, (c // heads) ** -0.5, 1e-5, valid).backward(
        torch.from_numpy(g))
    for t, r in zip(leaves, refs):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), atol=1e-5, rtol=1e-5)


def test_without_qkv_bias_matches_zero_bias():
    xw, bias, _, _ = _windows(1, 7, 64, 2, False, seed=12)
    p = _params(64, seed=13)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    none = T.fused_window_attention_half(xw, t["lnw"], t["lnb"], t["wqkv"].T, None, t["wproj"].T, t["bproj"], bias, 2)
    zero = T.fused_window_attention_half(xw, t["lnw"], t["lnb"], t["wqkv"].T, torch.zeros(192), t["wproj"].T,
                                         t["bproj"], bias, 2)
    torch.testing.assert_close(none, zero, rtol=0, atol=0)


@pytest.mark.parametrize(
    "c,heads,L_,ok",
    [(384, 12, 49, True), (768, 24, 49, True), (256, 8, 64, True), (64, 4, 49, True), (96, 4, 49, False),
     (256, 2, 49, False), (384, 12, 81, False), (384, 0, 49, False)],
)
def test_gate_is_a_shape_rule(c, heads, L_, ok):
    assert T.window_attention_half_supported(c, heads, L_) is ok


def _args(c=64, heads=2, nw=4, L_=49, device="cpu"):
    t = lambda *s: torch.zeros(*s, device=device)  # noqa: E731
    return [t(1, nw, L_, c), t(c), t(c), t(3 * c, c), t(3 * c), t(c, c), t(c), t(nw, heads, L_, L_)], heads


@pytest.mark.parametrize(
    "change",
    ["meta-device", "ndim-3", "L-81", "head_dim-24", "bias-shape", "valid-shape", "valid-dtype", "wqkv-shape"],
)
def test_refuses(change):
    if change == "meta-device":
        args, heads = _args(device="meta")
        kw = {}
    elif change == "L-81":
        args, heads = _args(L_=81)
        kw = {}
    elif change == "head_dim-24":
        args, heads = _args(c=96, heads=4)
        kw = {}
    else:
        args, heads = _args()
        kw = {}
        if change == "ndim-3":
            args[0] = args[0][0]
        elif change == "bias-shape":
            args[7] = torch.zeros(2, heads, 49, 49)
        elif change == "valid-shape":
            kw["valid"] = torch.ones(4, 48, dtype=torch.bool)
        elif change == "valid-dtype":
            kw["valid"] = torch.ones(4, 49)
        elif change == "wqkv-shape":
            args[3] = torch.zeros(64, 64)
    with pytest.raises(ValueError):
        T.fused_window_attention_half(*args, heads, **kw)


# ------------------------------------------------- the unfused path's rounding


@pytest.fixture
def cores_pass_v(monkeypatch):
    """Both packages' attention cores replaced by ``o = v``: Swin v2's core
    rounds its normalised q and k to bf16 in the JAX package and keeps them
    in f32 in the port (a choice of the port's, ops/attention.py), so v2's
    projections and MLP are compared around a core that both compute alike."""
    monkeypatch.setattr(JA, "attention_reference", lambda q, k, v, bias=None, scale=None: v)
    monkeypatch.setattr(TW, "window_qkv_attention", lambda qkv, *a: qkv[..., 2 * qkv.shape[-1] // 3:])


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_windowed_projections_round_as_jax(v2, shifted, request):
    """bf16: the unfused path's qkv and proj round the product to x's type,
    then add the bias in x's type and round again, as the JAX package's
    ``shifted_window_attention`` does (plain versions on both sides; v2
    around cores that pass v through). ``F.linear`` with the bias rounds
    once, and then about 60% of the outputs differ."""
    if v2:
        request.getfixturevalue("cores_pass_v")
    c, heads = 64, 2
    win = (8, 8) if v2 else WIN
    rng = np.random.RandomState(20 + shifted)
    x = _bf16(rng.randn(2, 2 * win[0], 2 * win[0], c))
    qkv_w, proj_w = _bf16(rng.randn(c, 3 * c) * c**-0.5), _bf16(rng.randn(c, c) * c**-0.5)
    qkv_b, proj_b = (0.5 * rng.randn(3 * c)).astype(np.float32), (0.5 * rng.randn(c)).astype(np.float32)
    bias = rng.randn(1, heads, win[0] ** 2, win[0] ** 2).astype(np.float32)
    ls = np.log(np.array([10.0, 40.0], np.float32)).reshape(heads, 1, 1) if v2 else None
    shift = (win[0] // 2,) * 2 if shifted else (0, 0)
    ref = WA.shifted_window_attention(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(qkv_w), jnp.asarray(proj_w), jnp.asarray(bias), win, heads, shift,
        qkv_bias=jnp.asarray(qkv_b), proj_bias=jnp.asarray(proj_b), logit_scale=None if ls is None else jnp.asarray(ls),
    )
    t = torch.from_numpy
    out = TW.shifted_window_attention(
        t(x).bfloat16(), t(qkv_w.T.copy()), t(proj_w.T.copy()), t(bias), win, heads, shift, qkv_bias=t(qkv_b),
        proj_bias=t(proj_b), logit_scale=None if ls is None else t(ls),
    )
    assert out.dtype == torch.bfloat16
    off = _steps_off(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert off.max() <= 1.0 and float((off > 0).mean()) < 0.01


@pytest.mark.parametrize("case", ["v1-training", "v2-C256-inference"])
def test_unfused_block_rounds_as_jax(case, request):
    """bf16 blocks of the port's unfused path against the JAX model's
    blocks, every parameter f32 (of bf16 values): gelu acts on fc1's f32
    accumulator, and each bias is added where the JAX block adds it.
    v1 in training mode (drop path and dropout 0) takes the unfused path at
    any width; v2 with C > 192 takes it at inference (around cores that
    pass v through). Before the repairs, fc1 was rounded before gelu and
    every ``Linear`` bias rounded to bf16 first: most outputs differed."""
    v2 = case.startswith("v2")
    if v2:
        request.getfixturevalue("cores_pass_v")
    c, heads, side = (256, 8, 16) if v2 else (64, 2, 14)
    jblk, w = _jax_block(c, heads, (4, 4) if v2 else (3, 3), seed=21, v2=v2)
    jblk = tree_inference(jblk, v2)
    x = _bf16(np.random.RandomState(22).randn(2, side, side, c))
    ref = np.asarray(jblk(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    blk = _port_block(jblk, w, v2=v2)
    blk.train(not v2)
    with torch.no_grad():
        out = blk(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    off = _steps_off(out.float().numpy(), ref)
    # v2's post-norm LayerNorms scale a one-step difference of their input (an
    # f32 sum in another order) by 1 / std of the branch: two steps at most
    assert off.max() <= (2.0 if v2 else 1.0) and float((off > 0).mean()) < 0.01
