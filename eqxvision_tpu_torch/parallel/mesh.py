"""The (data, model) grid of ranks and the tensor-parallel layout
(eqxvision_tpu/parallel/mesh.py).

The JAX module builds a ``jax.sharding.Mesh`` and lets XLA insert the
collectives. Here each process is one rank of a ``torch.distributed``
world, and the collectives are explicit:

- ``make_mesh(data, model)`` places the world's ranks on a ``data x
  model`` grid, rank ``r`` at data index ``r // model`` and model index
  ``r % model``, and makes a process group for each row (the model group:
  the ranks that hold one data shard) and each column (the data group: the
  ranks that hold one model shard);
- ``shard_batch`` gives this rank's rows of a global batch;
- ``replicate`` broadcasts a model's or a dict's tensors from rank 0;
- ``shard_params_tp`` splits the transformer blocks' Linears over the
  model group (Megatron: qkv, fc1 and ConvNeXt's ``block.3`` by output
  features, proj, fc2 and ``block.5`` by input features), swapping in
  ``nn.collectives``' column- and row-parallel layers, which the blocks
  call on their unfused route; ``tp_spec_for_path`` gives the rule for a
  ``state_dict`` name and ``param_shardings`` what a sharded model holds,
  for the checkpoint;
- ``sync_batchnorm`` gives every BatchNorm the data group, so that its
  training statistics are the global batch's;
- ``all_reduce_grads`` averages the gradients over the data group.

A process that is no rank of a world (``torch.distributed`` not
initialised) is a mesh of one rank (``make_mesh()``), on which all of this
is the identity; the steps and the checkpoint also take ``mesh=None`` for
one process.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from ..nn.collectives import ColumnParallelLinear, Group, RowParallelLinear, all_reduce_
from ..nn.linear import Linear


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the ``data x model`` grid and the two groups it
    belongs to."""

    data: int
    model: int
    rank: int
    data_group: Group  # the ranks with this rank's model index, in data order
    model_group: Group  # the ranks with this rank's data index, in model order

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def __deepcopy__(self, memo):
        return self


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The world's ranks on a ``data x model`` grid (``data`` defaults to
    the world size over ``model``). Every rank of the world must call it,
    in the same order as its other group-making calls: it makes the
    process groups. Raises where ``data * model`` is not the world size."""
    world, rank = _world()
    if data is None:
        data = world // model
    if data * model != world or data < 1 or model < 1:
        raise ValueError(f"data({data}) * model({model}) != world size ({world})")
    rows = [[d * model + m for m in range(model)] for d in range(data)]
    cols = [[d * model + m for d in range(data)] for m in range(model)]
    groups = {}
    for ranks in (rows if model > 1 else []) + (cols if data > 1 else []):
        groups[tuple(ranks)] = dist.new_group(ranks)  # collective: every rank makes every group
    row, col = rows[rank // model], cols[rank % model]
    return Mesh(data, model, rank, Group(col, groups.get(tuple(col))), Group(row, groups.get(tuple(row))))


def shard_batch(x: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global batch (a tensor, or a tuple, list or dict
    of them): data index ``d`` takes rows ``[d B / D, (d + 1) B / D)``.
    Every model rank of a data index takes the same rows."""
    if isinstance(x, (tuple, list)):
        return type(x)(shard_batch(t, mesh) for t in x)
    if isinstance(x, dict):
        return {k: shard_batch(v, mesh) for k, v in x.items()}
    b = x.shape[0]
    if b % mesh.data:
        raise ValueError(f"a batch of {b} does not split over {mesh.data} data ranks")
    per = b // mesh.data
    return x[mesh.data_index * per : (mesh.data_index + 1) * per]


def _buckets(tensors: Iterable[torch.Tensor], limit_bytes: int = 1 << 25) -> Iterator[List[torch.Tensor]]:
    """Consecutive tensors of one type and device, up to ``limit_bytes`` a bucket."""
    bucket: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device or size + t.nbytes > limit_bytes):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.nbytes
    if bucket:
        yield bucket


def _flat(bucket: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in bucket])


def _unflat_into(flat: torch.Tensor, bucket: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in bucket:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def _broadcast(tensors: Sequence[torch.Tensor], src: int, group: Optional[dist.ProcessGroup]) -> None:
    for bucket in _buckets(tensors):
        flat = _flat(bucket)
        dist.broadcast(flat, src=src, group=group)
        _unflat_into(flat, bucket)


def replicate(obj: Union[nn.Module, Dict[str, torch.Tensor]], mesh: Mesh):
    """Every tensor of a module (parameters and buffers) or of a dict as
    rank 0 holds it, in place; returns ``obj``. A tensor that
    ``shard_params_tp`` split is broadcast over the data group from its
    data index 0, so each model rank keeps its own shard."""
    if mesh.world == 1:
        return obj
    if isinstance(obj, nn.Module):
        shardings = param_shardings(obj, mesh)
        entries = obj.state_dict(keep_vars=True)
        whole = [t.data for k, t in entries.items() if shardings.get(k) is None]
        split = [t.data for k, t in entries.items() if shardings.get(k) is not None]
    else:
        whole, split = list(obj.values()), []
    _broadcast(whole, 0, None)
    if split and mesh.data > 1:
        _broadcast(split, mesh.data_group.src, mesh.data_group.group)
    return obj


# ---------------------------------------------------------------------------
# Tensor-parallel layout


class Shard(NamedTuple):
    """How a tensor splits over the model group: along ``dim``, each of its
    ``parts`` equal pieces split into contiguous shards (qkv's three
    pieces q, k and v each by head, so that a rank's rows hold whole heads
    of all three)."""

    dim: int
    parts: int = 1


# (name pattern, the tensor's rank, the split). The JAX rules' paths under
# the port's own names: ViT's attn.qkv / attn.proj / mlp.fc1 / mlp.fc2, Swin's
# attn.qkv / attn.proj / mlp.0 / mlp.3, ConvNeXt's block.3 / block.5 (JAX's
# pwconv1 / pwconv2), in torch's (out, in) layout. Swin's per-head parameters
# split by head too: the bias table's head column, v2's logit scale and the
# last layer of its cpb_mlp.
_TP_RULES: Tuple[Tuple[str, int, Shard], ...] = (
    (r"(^|\.)attn\.qkv\.weight$", 2, Shard(0, 3)),
    (r"(^|\.)attn\.qkv\.bias$", 1, Shard(0, 3)),
    (r"(^|\.)attn\.proj\.weight$", 2, Shard(1)),
    (r"(^|\.)mlp\.(fc1|0)\.weight$", 2, Shard(0)),
    (r"(^|\.)mlp\.(fc1|0)\.bias$", 1, Shard(0)),
    (r"(^|\.)mlp\.(fc2|3)\.weight$", 2, Shard(1)),
    (r"(^|\.)block\.3\.weight$", 2, Shard(0)),
    (r"(^|\.)block\.3\.bias$", 1, Shard(0)),
    (r"(^|\.)block\.5\.weight$", 2, Shard(1)),
    (r"(^|\.)attn\.relative_position_bias_table$", 2, Shard(1)),
    (r"(^|\.)attn\.logit_scale$", 3, Shard(0)),
    (r"(^|\.)attn\.cpb_mlp\.2\.weight$", 2, Shard(0)),
)


def tp_spec_for_path(path: str, tensor: Any) -> Optional[Shard]:
    """The split of the ``state_dict`` entry ``path``, or None (kept whole
    on every model rank). A rule whose rank does not match the tensor's
    keeps it whole, as the JAX rules do."""
    for pattern, ndim, spec in _TP_RULES:
        if re.search(pattern, path) and len(tensor.shape) == ndim:
            return spec
    return None


def shard_tensor(t: torch.Tensor, spec: Shard, size: int, index: int) -> torch.Tensor:
    """Model rank ``index``'s shard of ``t`` (of ``size`` ranks)."""
    n = t.shape[spec.dim]
    if n % (spec.parts * size):
        raise ValueError(f"dimension {spec.dim} of {tuple(t.shape)} does not split into {spec.parts} x {size}")
    pieces = t.chunk(spec.parts, spec.dim)
    return torch.cat([p.chunk(size, spec.dim)[index] for p in pieces], spec.dim).contiguous()


def join_tensors(shards: Sequence[torch.Tensor], spec: Shard) -> torch.Tensor:
    """The whole tensor from every model rank's shard, in model order."""
    pieces = [s.chunk(spec.parts, spec.dim) for s in shards]
    return torch.cat([torch.cat([p[i] for p in pieces], spec.dim) for i in range(spec.parts)], spec.dim)


def shard_state_dict(state: Mapping[str, torch.Tensor], shardings: Mapping[str, Optional[Shard]], size: int,
                     index: int) -> Dict[str, torch.Tensor]:
    """Model rank ``index``'s ``state_dict`` from a whole one."""
    return {k: v if shardings.get(k) is None else shard_tensor(v, shardings[k], size, index) for k, v in state.items()}


def join_state_dicts(states: Sequence[Mapping[str, torch.Tensor]],
                     shardings: Mapping[str, Optional[Shard]]) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` from every model rank's, in model order."""
    return {k: v if shardings.get(k) is None else join_tensors([s[k] for s in states], shardings[k])
            for k, v in states[0].items()}


def _block_kinds():
    from ..models.classification.convnext import CNBlock
    from ..models.classification.swin import _SwinTransformerBlock
    from ..models.classification.vit import _VitBlock

    return _VitBlock, _SwinTransformerBlock, CNBlock


def _block_widths(block: nn.Module) -> Tuple[Optional[int], int]:
    """(heads or None, hidden width) of a tensor-parallel block."""
    vit, swin, cn = _block_kinds()
    if isinstance(block, vit):
        return block.attn.num_heads, block.mlp.fc1.out_features
    if isinstance(block, swin):
        return block.attn.num_heads, block.mlp[0].out_features
    return None, block.block[3].out_features


def _tp_blocks(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    kinds = _block_kinds()
    for name, module in model.named_modules():
        if isinstance(module, kinds):
            yield name, module


def _is_split(block: nn.Module) -> bool:
    return any(isinstance(m, (ColumnParallelLinear, RowParallelLinear)) for m in block.modules())


def _shard_param(p: nn.Parameter, spec: Shard, mesh: Mesh) -> nn.Parameter:
    return nn.Parameter(shard_tensor(p.detach(), spec, mesh.model, mesh.model_index), requires_grad=p.requires_grad)


def _parallel_linear(layer: Linear, path: str, mesh: Mesh) -> nn.Module:
    """This rank's share of the Linear at ``path``: column-parallel where its
    rule splits the weight's rows, row-parallel (bias whole) where it splits
    the columns."""
    spec = tp_spec_for_path(f"{path}.weight", layer.weight)
    bias = layer.bias
    if bias is not None and spec.dim == 0:
        bias = _shard_param(bias, tp_spec_for_path(f"{path}.bias", bias), mesh)
    kind = ColumnParallelLinear if spec.dim == 0 else RowParallelLinear
    return kind(_shard_param(layer.weight, spec, mesh), bias, mesh.model_group)


def shard_params_tp(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split, in place, every ViT, Swin (v1 and v2) and ConvNeXt block whose
    heads and hidden width the model group divides: qkv, fc1 and
    ``block.3`` (and v2's last ``cpb_mlp`` layer) become
    ``ColumnParallelLinear``s of this rank's rows (qkv by head: q, k and v
    of heads ``[m H / T, (m + 1) H / T)``), proj, fc2 and ``block.5``
    ``RowParallelLinear``s of its columns (their biases whole), Swin's bias
    table and logit scale keep this rank's heads, and the attention's
    ``num_heads`` counts them. The block then takes its unfused route, on
    which the attention kernels run the rank's heads. A block the group does
    not divide (swin_t's 3-head first stage at T = 2) stays whole and runs
    its one-card forward on every model rank. Raises where the model has
    such blocks and the group divides none of them, and on a quantized
    block. Other models, and a model group of one rank, are left as they
    are. Call it before the optimiser is built: the split parameters are
    new tensors. Returns ``model``."""
    size = mesh.model
    if size == 1:
        return model
    blocks = list(_tp_blocks(model))
    split = 0
    for prefix, block in blocks:
        heads, hidden = _block_widths(block)
        if (heads is not None and heads % size) or hidden % size:
            continue
        quantized = [n for n, m in block.named_modules() if type(m).__name__.startswith("Quant")]
        if quantized:
            raise ValueError(f"{prefix}: a quantized block ({quantized}) cannot be split")
        for name, module in list(block.named_modules()):
            owner, _, leaf = name.rpartition(".")
            parent = block.get_submodule(owner) if owner else block
            if isinstance(module, Linear) and tp_spec_for_path(f"{prefix}.{name}.weight", module.weight):
                setattr(parent, leaf, _parallel_linear(module, f"{prefix}.{name}", mesh))
        for name, p in list(block.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            module = block.get_submodule(owner) if owner else block
            spec = tp_spec_for_path(f"{prefix}.{name}", p)
            if spec is not None and not isinstance(module, (ColumnParallelLinear, RowParallelLinear)):
                setattr(module, leaf, _shard_param(p, spec, mesh))  # Swin's per-head parameters
        if heads is not None:
            block.attn.num_heads //= size
        split += 1
    if blocks and not split:
        widths = sorted({_block_widths(b) for _, b in blocks}, key=str)
        raise ValueError(f"a model group of {size} ranks divides no block's (heads, hidden width): {widths}")
    return model


def param_shardings(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[Shard]]:
    """How each ``state_dict()`` entry of a model that ``shard_params_tp``
    has split is laid out over the model group: its ``Shard``, or None
    where every model rank holds it whole."""
    split = tuple(f"{prefix}." for prefix, block in _tp_blocks(model) if _is_split(block))
    out: Dict[str, Optional[Shard]] = {}
    for name, t in model.state_dict().items():
        out[name] = tp_spec_for_path(name, t) if mesh.model > 1 and name.startswith(split) else None
    return out


def sync_batchnorm(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Give every BatchNorm of ``model`` the data group, so that its
    training statistics are the global batch's (one data rank: none).
    Returns ``model``."""
    from ..nn.norm import BatchNorm

    group = mesh.data_group if mesh.data > 1 else None
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    return model


def parallelize(model: nn.Module, mesh: Mesh) -> nn.Module:
    """``replicate`` (rank 0's weights everywhere), ``shard_params_tp`` and
    ``sync_batchnorm``: a model built on every rank ready for the mesh's
    train step. Returns ``model``."""
    return sync_batchnorm(shard_params_tp(replicate(model, mesh), mesh), mesh)


def seed_rank(seed: int, mesh: Optional[Mesh] = None) -> int:
    """Seed the default generators (the CPU's and the cards'), from which
    dropout and drop path draw, by ``(seed, data index)``; returns that
    seed, for a generator of the caller's (the augmentation's). Every model
    rank of a data index draws the same masks, as its activations must
    agree; data index 0 (and one process, ``mesh=None``) draws what one
    process seeded with ``seed`` draws (ROADMAP C.22)."""
    s = int(seed) + 0x9E3779B1 * (mesh.data_index if mesh is not None else 0)  # an odd step: distinct low 32 bits, which the CPU generator keeps
    torch.manual_seed(s)
    return s


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Average the gradients over the data group, in buckets of one type (a
    few flat all-reduces). No gradient is summed over the model group: the
    tensor-parallel copies already make the whole parameters' gradients
    agree there."""
    if mesh.data == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for bucket in _buckets(grads):
        flat = _flat(bucket)
        all_reduce_(flat, mesh.data_group)
        _unflat_into(flat.div_(mesh.data), bucket)
