"""Tensor parallelism (Megatron column/row pairs) of the extended UNet.

Counterpart of ``ladi_vton_tpu/parallel/tp.py``, written on the port's
state-dict names (diffusers' keys).  The plan, over the mesh's ``model``
group of ``tp`` ranks (arXiv 1909.08053):

* ``to_q``, ``to_k``, ``to_v``: column-parallel, the rows of ``weight``
  split by heads, so each rank runs K1 (``ops.flash_attention``) on its
  ``H / tp`` heads as contiguous (B, S, H/tp, D) views;
* ``to_out.0``: row-parallel; the partial outputs are summed over
  ``model`` and the bias added once, after the sum;
* ``ff.net.0.proj``: column-parallel, with the value half and the gate
  half of the (2I, C) weight each split into ``tp`` slices and rank r
  holding ``[value_r ‖ gate_r]``: the gating is local to the rank and
  exact (the JAX package's contiguous split pairs a value column with a
  gate column on another chip, which GSPMD reshards), and each rank runs
  K4 (``ops.geglu``) at ``(rows, C, I / tp)``;
* ``ff.net.2``: row-parallel; K4 takes a (C,) bias, which is the real
  bias on model rank 0 and a zero that carries its gradient elsewhere;
* everything else (convolutions, norms, the time embedding, the
  transformer's ``proj_in``/``proj_out``) is replicated.

An attention whose head count does not divide ``tp`` (SD-2's level 0 has
5 heads) stays whole on every rank of its model group with its weights
replicated, the fallback the JAX package takes per call site
(``ops/attention.py``); it costs memory only.

The collectives are two autograd Functions over the model group:
``copy_to_model`` (identity forward, ``all_reduce`` of the gradient) at
a parallel region's input and ``reduce_from_model`` (``all_reduce``
forward, identity backward) at its output, each summing in fp32.  So the
replicated parameters get the same gradient on every model rank, and the
sharded ones (marked ``tp_sharded``) their slice's.

``tp_shard_state_dict`` and its exact inverse ``tp_gather_state_dict``
move between the reference layout, which both zoos load, and one rank's
slices; ``gather_unet_state`` and ``gather_optimizer_state`` are the
collective forms a checkpoint or an export runs on every rank.  The JAX
``tp_train_state`` has no counterpart here: AdamW over the sliced
parameters (``train.steps.make_optimizer(..., mesh=)``) already keeps
moments of the slices' shapes, and the clip's norm spans ``model``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ladi_vton_tpu_torch.core.mesh import Mesh
from ladi_vton_tpu_torch.models.layers import (
    BasicTransformerBlock,
    CrossAttention,
    FeedForwardGEGLU,
    GEGLUProj,
)
from ladi_vton_tpu_torch.ops.attention import dot_product_attention
from ladi_vton_tpu_torch.ops.geglu import geglu

COLUMN = "column"  # rows of the (out, in) weight (and the bias) split
GEGLU_COLUMN = "geglu_column"  # value and gate halves split each
ROW = "row"  # columns of the weight split; the bias replicated


# ------------------------------------------------------------------ plan


def _leaf_spec(key: str) -> Optional[tuple]:
    """(kind, axis) of one UNet state-dict key, or None (replicated)."""
    parts = key.split(".")
    if "transformer_blocks" not in parts:
        return None
    leaf = parts[-1]
    if any(p in ("to_q", "to_k", "to_v") for p in parts):
        return (COLUMN, 0)
    if "to_out" in parts:
        return (ROW, 1) if leaf == "weight" else None
    if "ff" in parts and parts[-3:-1] == ["0", "proj"]:
        return (GEGLU_COLUMN, 0)
    if "ff" in parts and parts[-2] == "2":
        return (ROW, 1) if leaf == "weight" else None
    return None


def unet_tp_specs(state_dict: dict) -> dict:
    """The Megatron plan over a UNet state dict: key -> (kind, axis) for
    the split leaves, None for the replicated ones (the JAX
    ``unet_tp_specs`` on the port's names)."""
    return {k: _leaf_spec(k) for k in state_dict}


def attention_heads(unet: nn.Module) -> dict:
    """Module name -> head count of every transformer attention."""
    return {name: getattr(m, "full_heads", m.heads)
            for name, m in unet.named_modules()
            if isinstance(m, (CrossAttention, TPCrossAttention))
            and "transformer_blocks" in name}


def unet_tp_plan(unet: nn.Module, tp: int) -> dict:
    """``unet_tp_specs`` of ``unet``'s state dict with the attentions
    whose heads do not divide ``tp`` replicated, checked by
    ``tp_shardings``.  The state dict is the full (reference) one."""
    state = full_state_shapes(unet)
    specs = unet_tp_specs(state)
    heads = attention_heads(unet)
    for key in specs:
        owner = (key.split(".to_out.")[0] if ".to_out." in key
                 else key.rsplit(".", 2)[0])
        if heads.get(owner, 0) % tp:
            specs[key] = None
    return tp_shardings(state, tp, specs)


def full_state_shapes(unet: nn.Module) -> dict:
    """Key -> a meta tensor of the full shape, for a UNet that may already
    hold slices (``TPCrossAttention``/``TPFeedForwardGEGLU``)."""
    shapes = {}
    full = {}
    for name, m in unet.named_modules():
        if isinstance(m, (TPCrossAttention, TPFeedForwardGEGLU)):
            full.update({f"{name}.{k}": v for k, v in m.full_shapes.items()})
    for key, value in unet.state_dict().items():
        shape = full.get(key, tuple(value.shape))
        shapes[key] = torch.empty(shape, dtype=value.dtype, device="meta")
    return shapes


def tp_shardings(state_dict: dict, tp: int,
                 specs: Optional[dict] = None) -> dict:
    """The plan of ``state_dict`` at ``tp`` ranks (``specs`` or the
    Megatron plan); raises, naming the key, where a split axis does not
    divide ``tp``."""
    specs = unet_tp_specs(state_dict) if specs is None else specs
    for key, spec in specs.items():
        if spec is None:
            continue
        kind, axis = spec
        size = state_dict[key].shape[axis]
        if kind == GEGLU_COLUMN:
            size //= 2
        if size % tp:
            raise ValueError(
                f"TP axis size {tp} does not divide {key} axis {axis} (shape "
                f"{tuple(state_dict[key].shape)}); pick tp dividing the "
                f"attention inner widths")
    return specs


def _shard(t: torch.Tensor, spec, rank: int, tp: int) -> torch.Tensor:
    kind, axis = spec
    if kind == GEGLU_COLUMN:
        value, gate = t.chunk(2, dim=axis)
        return torch.cat([value.chunk(tp, dim=axis)[rank],
                          gate.chunk(tp, dim=axis)[rank]], dim=axis)
    return t.chunk(tp, dim=axis)[rank]


def _unshard(parts: list, spec) -> torch.Tensor:
    kind, axis = spec
    if kind == GEGLU_COLUMN:
        halves = [p.chunk(2, dim=axis) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         dim=axis)
    return torch.cat(parts, dim=axis)


def tp_shard_state_dict(state_dict: dict, rank: int, tp: int,
                        specs: Optional[dict] = None) -> dict:
    """Model rank ``rank``'s slices of a full UNet state dict (the other
    entries as they are)."""
    specs = tp_shardings(state_dict, tp, specs)
    return {k: (v if specs.get(k) is None
                else _shard(v, specs[k], rank, tp).contiguous())
            for k, v in state_dict.items()}


def tp_gather_state_dict(shards: list, specs: dict) -> dict:
    """The full state dict from every model rank's slices, in rank order:
    the exact inverse of ``tp_shard_state_dict``."""
    return {k: (v if specs.get(k) is None
                else _unshard([s[k] for s in shards], specs[k]))
            for k, v in shards[0].items()}


# ----------------------------------------------------------- collectives


def _all_reduce_fp32(t: torch.Tensor, group) -> torch.Tensor:
    out = t.float().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_fp32(grad, ctx.group).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group, in fp32; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.model_group is None:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The fp32 sum of ``x`` over the model group."""
    if mesh.model_group is None:
        return x.float()
    return _ReduceFromModel.apply(x, mesh.model_group)


def _mark(*params: nn.Parameter) -> None:
    for p in params:
        p.tp_sharded = True


def _param(t: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return nn.Parameter(t.detach().clone().contiguous(),
                        requires_grad=like.requires_grad)


# --------------------------------------------------------------- modules


class TPCrossAttention(nn.Module):
    """``CrossAttention`` over ``H / tp`` heads of one model rank: the
    same parameter names with the rank's slices, K1 on its heads, the
    output projection's partial sums reduced over ``model``."""

    def __init__(self, attn: CrossAttention, mesh: Mesh):
        super().__init__()
        tp, r = mesh.model, mesh.model_index
        self.mesh = mesh
        self.full_heads = attn.heads
        self.heads = attn.heads // tp
        self.dim_head = attn.dim_head
        self.full_shapes = {k: tuple(v.shape)
                            for k, v in attn.state_dict().items()}
        self.to_q = nn.Linear(1, 1, bias=False)
        self.to_k = nn.Linear(1, 1, bias=False)
        self.to_v = nn.Linear(1, 1, bias=False)
        for name in ("to_q", "to_k", "to_v"):
            w = getattr(attn, name).weight
            getattr(self, name).weight = _param(
                _shard(w, (COLUMN, 0), r, tp), w)
        out = attn.to_out[0]
        self.to_out = nn.ModuleList([nn.Linear(1, 1), nn.Dropout(0.0)])
        self.to_out[0].weight = _param(_shard(out.weight, (ROW, 1), r, tp),
                                       out.weight)
        self.to_out[0].bias = _param(out.bias, out.bias)
        _mark(self.to_q.weight, self.to_k.weight, self.to_v.weight,
              self.to_out[0].weight)

    def project_kv(self, context: torch.Tensor) -> tuple:
        context = copy_to_model(context, self.mesh)
        return self.to_k(context), self.to_v(context)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                kv: Optional[tuple] = None) -> torch.Tensor:
        x = copy_to_model(x, self.mesh)
        B, Sq, _ = x.shape
        H, D = self.heads, self.dim_head
        if kv is None:
            kv = (self.to_k(x), self.to_v(x)) if context is None else \
                self.project_kv(context)
        Sk = kv[0].shape[1]
        q = self.to_q(x).view(B, Sq, H, D)
        k = kv[0].view(B, Sk, H, D)
        v = kv[1].view(B, Sk, H, D)
        out = dot_product_attention(q, k, v).reshape(B, Sq, H * D)
        partial = F.linear(out, self.to_out[0].weight)
        y = reduce_from_model(partial, self.mesh)
        return (y + self.to_out[0].bias.float()).to(partial.dtype)


class TPFeedForwardGEGLU(nn.Module):
    """``FeedForwardGEGLU`` over ``I / tp`` of the inner width: the rank's
    ``[value_r ‖ gate_r]`` rows of ``net.0.proj`` and columns of
    ``net.2``, K4 at ``(rows, C, I / tp)``, the partial outputs reduced
    over ``model``."""

    def __init__(self, ff: FeedForwardGEGLU, mesh: Mesh):
        super().__init__()
        tp, r = mesh.model, mesh.model_index
        self.mesh = mesh
        self.full_shapes = {k: tuple(v.shape)
                            for k, v in ff.state_dict().items()}
        proj, out = ff.net[0].proj, ff.net[2]
        self.net = nn.ModuleList([GEGLUProj(1, 1), nn.Dropout(0.0),
                                  nn.Linear(1, 1)])
        p = self.net[0].proj
        p.weight = _param(_shard(proj.weight, (GEGLU_COLUMN, 0), r, tp),
                          proj.weight)
        p.bias = _param(_shard(proj.bias, (GEGLU_COLUMN, 0), r, tp),
                        proj.bias)
        self.net[2].weight = _param(_shard(out.weight, (ROW, 1), r, tp),
                                    out.weight)
        self.net[2].bias = _param(out.bias, out.bias)
        _mark(p.weight, p.bias, self.net[2].weight)
        self.inner_local = proj.weight.shape[0] // 2 // tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x, self.mesh)
        proj, out = self.net[0].proj, self.net[2]
        b2 = out.bias
        if self.mesh.model_index != 0:
            # zero in value, and b2's gradient on this rank too
            b2 = b2 - b2.detach()
        partial = geglu(x, proj.weight, proj.bias, out.weight, b2)
        return reduce_from_model(partial, self.mesh).to(partial.dtype)


def unet_tp(unet: nn.Module, mesh: Mesh) -> nn.Module:
    """Swap every transformer block's attentions (where their heads divide
    ``model``) and feed-forward for this rank's tensor-parallel modules,
    in place; the UNet's other parameters stay replicated.  Returns
    ``unet``."""
    if mesh.model == 1:
        return unet
    unet_tp_plan(unet, mesh.model)  # raises where an axis does not divide
    for block in [m for m in unet.modules()
                  if isinstance(m, BasicTransformerBlock)]:
        for name in ("attn1", "attn2"):
            attn = getattr(block, name)
            if isinstance(attn, CrossAttention) and attn.heads % mesh.model \
                    == 0:
                setattr(block, name, TPCrossAttention(attn, mesh))
        if isinstance(block.ff, FeedForwardGEGLU):
            block.ff = TPFeedForwardGEGLU(block.ff, mesh)
    return unet


def load_full_state(unet: nn.Module, state: dict, mesh: Mesh) -> None:
    """Load a full (reference-layout) state dict into a UNet that may hold
    this rank's slices."""
    if mesh.model > 1:
        state = tp_shard_state_dict(state, mesh.model_index, mesh.model,
                                    unet_tp_plan(unet, mesh.model))
    unet.load_state_dict(state)


# ------------------------------------------------------ gathers (collective)


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    """The same bytes as an integer tensor (broadcast moves bits)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()]) if t.is_floating_point() else t


def gather_shards(t: torch.Tensor, mesh: Mesh) -> list:
    """Every model rank's ``t`` (same shape on each), in model order, on
    every rank: one broadcast a rank, which gloo also takes on CUDA."""
    parts = []
    for i, src in enumerate(mesh.model_ranks):
        part = t.detach().clone() if i == mesh.model_index else \
            torch.empty_like(t)
        dist.broadcast(_as_bits(part), src=src, group=mesh.model_group)
        parts.append(part)
    return parts


def gather_unet_state(unet: nn.Module, mesh: Mesh,
                      state: Optional[dict] = None) -> dict:
    """The full (reference-layout) state dict of a tensor-parallel UNet
    (or of ``state``, a dict on its keys, such as its gradients), on every
    rank.  Collective over ``model``."""
    state = unet.state_dict() if state is None else state
    if mesh.model == 1:
        return state
    specs = unet_tp_plan(unet, mesh.model)
    return {k: (v if specs.get(k) is None
                else _unshard(gather_shards(v, mesh), specs[k]))
            for k, v in state.items()}


def param_specs(unet: nn.Module, names: list, mesh: Mesh,
                prefix: str = "unet.") -> list:
    """The plan's spec of each named trained parameter (None for those
    outside the UNet or replicated)."""
    specs = unet_tp_plan(unet, mesh.model) if mesh.model > 1 else {}
    return [specs.get(n[len(prefix):]) if n.startswith(prefix) else None
            for n in names]


def gather_optimizer_state(state: dict, specs: list, mesh: Mesh) -> dict:
    """An AdamW state dict over sliced parameters (``specs`` in parameter
    order) as the one over the full parameters.  Collective over
    ``model``."""
    if mesh.model == 1:
        return state
    out = {"param_groups": state["param_groups"], "state": {}}
    for idx, entry in state["state"].items():
        spec = specs[idx]
        out["state"][idx] = {
            k: (_unshard(gather_shards(v, mesh), spec)
                if spec is not None and torch.is_tensor(v) and v.dim()
                else v)
            for k, v in entry.items()}
    return out


def shard_optimizer_state(state: dict, specs: list, mesh: Mesh) -> dict:
    """This model rank's AdamW state from the full one (the inverse of
    ``gather_optimizer_state``)."""
    if mesh.model == 1:
        return state
    out = {"param_groups": state["param_groups"], "state": {}}
    for idx, entry in state["state"].items():
        spec = specs[int(idx)]
        out["state"][idx] = {
            k: (_shard(v, spec, mesh.model_index, mesh.model).contiguous()
                if spec is not None and torch.is_tensor(v) and v.dim()
                else v)
            for k, v in entry.items()}
    return out
