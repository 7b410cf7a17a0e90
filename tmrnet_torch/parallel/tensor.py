"""Tensor parallelism over the grid's model axis: the rules, the slices of
the parameters, the model group's collectives and whole tensors for the
checkpoints.

Port of `tmrnet_tpu/parallel/mesh.py`'s `DEFAULT_TP_RULES` (:29-35),
`param_shardings` (:122-153) and `shard_state` (:219-261). JAX places each
parameter by its rule and lets XLA insert the collectives; the port keeps
on each rank of a model group (`parallel/mesh.py`, M ranks) its slice of
each parameter that a rule shards, and the model's forward makes the
collectives itself (`models/blocks.py::column_linear` / `row_linear`,
`models/lstm.py`, `TimeConv`):

- the rules are JAX's, over the JAX parameter paths; the weight bridge
  (`models/convert.py`) maps a path and its dimension to the port's name
  and dimension: a Dense kernel (in, out) is the port's (out, in), so
  JAX's P(None, "model") is the port's dimension 0 and fc_c's
  P("model", None) dimension 1; the LSTM's weight_ih is (4H, In) in both
  (dimension 1); a Conv1d kernel (k, Cin, Cout) is the port's (Cout, Cin,
  k), dimension 0 (the kernel's dimension 2 once TimeConv lays it out);
- a parameter whose dimension does not divide by M stays replicated (JAX
  :139-148); a sliced parameter carries its `Shard` (`tp_shard`);
- the model group's two collectives, each an autograd Function with its
  matching backward, and each used in both directions: a gather of
  feature slices along the last axis (`gather`; its conjugate `split`
  takes the rank's slice and gathers in the backward) and a sum of
  partial products (`sum_partials`; its conjugate `copy_in` is the
  identity and sums in the backward). A gather is an all-reduce into a
  zeroed whole, since gloo takes only all-reduce and broadcast for a
  CUDA tensor (two ranks sharing a card), and adding zeros is exact;
  the collectives run in f32;
- the optimizer's slots follow their parameter's slice (torch's optimizers
  make them in the parameter's shape); a checkpoint holds whole tensors,
  gathered over the model group (`whole_model_state`,
  `whole_optimizer_state`), and a resume slices them again
  (`slice_model_state`, `slice_optimizer_state`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# JAX's DEFAULT_TP_RULES: path regex -> the spec over the flax layout;
# first match wins.
TP_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r".*lstm/weight_ih$", (None, "model")),        # (4H, In): In
    (r".*nl_block/(query|key|value|out)/kernel$", (None, "model")),
    (r".*fc_h_c/kernel$", (None, "model")),
    (r".*fc_c/kernel$", ("model", None)),
    (r".*time_conv/conv_k\d+/kernel$", (None, None, "model")),  # (k, in, out)
)
# The bridge's kernel layouts: the port's dimension i is flax's perm[i]
# (`models/convert.py::_KERNEL_PERM`).
_KERNEL_PERM = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


def flax_path(name: str, ndim: int) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """A port parameter's flax path ('/'-joined) and the bridge's
    permutation of its layout (None: the same layout)."""
    module, _, leaf = name.rpartition(".")
    if leaf == "weight" and ndim > 1:
        return module.replace(".", "/") + "/kernel", _KERNEL_PERM[ndim]
    return name.replace(".", "/"), None


def sharded_dims(shapes: Mapping[str, Sequence[int]], mp: int
                 ) -> Dict[str, int]:
    """The parameters the rules shard over a model axis of mp, {port name:
    port dimension}: a rule's dimension that does not divide by mp, or a
    spec longer than the parameter, leaves it replicated; nothing is
    sharded at mp = 1."""
    out: Dict[str, int] = {}
    if mp <= 1:
        return out
    for name, shape in shapes.items():
        path, perm = flax_path(name, len(shape))
        for pattern, spec in TP_RULES:
            if not re.match(pattern, path):
                continue
            if len(spec) == len(shape):
                flax_dim = spec.index("model")
                dim = flax_dim if perm is None else perm.index(flax_dim)
                if shape[dim] % mp == 0:
                    out[name] = dim
            break
    return out


@dataclasses.dataclass(frozen=True)
class Shard:
    """A sliced parameter's dimension, the rank's model index, M and the
    model group."""

    dim: int
    index: int
    size: int
    group: Any

    def bounds(self, whole: int) -> Tuple[int, int]:
        n = whole // self.size
        return self.index * n, (self.index + 1) * n


def shard_of(t: Optional[torch.Tensor]) -> Optional[Shard]:
    return getattr(t, "tp_shard", None)


def shard_model_(model: torch.nn.Module, mesh) -> Dict[str, int]:
    """Replace each parameter that the rules shard over the mesh's model
    axis by this rank's slice (in place, the same Parameter objects), and
    mark it with its `Shard`. Returns {name: dimension}; {} without a
    model axis. Call it before the optimizer is made."""
    if mesh is None or mesh.model_parallel == 1:
        return {}
    params = dict(model.named_parameters())
    dims = sharded_dims({n: tuple(p.shape) for n, p in params.items()},
                        mesh.model_parallel)
    with torch.no_grad():
        for name, dim in dims.items():
            p = params[name]
            shard = Shard(dim, mesh.model_index, mesh.model_parallel,
                          mesh.model_group)
            lo, hi = shard.bounds(p.shape[dim])
            p.data = p.data.narrow(dim, lo, hi - lo).clone()
            p.tp_shard = shard
    return dims


# -- the model group's collectives -------------------------------------------

def _wide(dtype: torch.dtype) -> torch.dtype:
    """The collectives' dtype: f32, or f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def _gather_along(x: torch.Tensor, shard: Shard, dim: int = -1
                  ) -> torch.Tensor:
    """The whole of x's slices along `dim` over the model group: each
    rank's slice written into a zeroed whole, summed (f32 or wider)."""
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= shard.size
    whole = torch.zeros(shape, dtype=_wide(x.dtype), device=x.device)
    lo, hi = shard.bounds(shape[dim])
    whole.narrow(dim, lo, hi - lo).copy_(x)
    dist.all_reduce(whole, group=shard.group)
    return whole.to(x.dtype)


def _sum(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    y = torch.empty(x.shape, dtype=_wide(x.dtype), device=x.device)
    y.copy_(x)
    dist.all_reduce(y, group=shard.group)
    return y.to(x.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _gather_along(x.contiguous(), shard)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.shard.bounds(g.shape[-1])
        return g[..., lo:hi].contiguous(), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        lo, hi = shard.bounds(x.shape[-1])
        return x[..., lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g.contiguous(), ctx.shard), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return _sum(x, shard)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.shard), None


def gather(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """(..., F / M) slices -> (..., F) on every rank of the model group;
    the backward takes the rank's slice of the gradient."""
    return _Gather.apply(x, shard)


def split(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """(..., F) -> the rank's (..., F / M); the backward gathers the
    slices' gradients into the whole."""
    return _Split.apply(x, shard)


def sum_partials(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The sum over the model group of each rank's partial product (in
    f32, then x's dtype); the backward passes the gradient to each."""
    return _SumPartials.apply(x, shard)


def copy_in(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """x itself, as the input of a layer whose outputs are sliced: the
    backward sums the ranks' partial input gradients."""
    return _CopyIn.apply(x, shard)


# -- whole tensors for the checkpoints ---------------------------------------

def _sharded_params(model: torch.nn.Module) -> Dict[str, Shard]:
    return {n: shard_of(p) for n, p in model.named_parameters()
            if shard_of(p) is not None}


def is_sharded(model: torch.nn.Module) -> bool:
    return bool(_sharded_params(model))


def whole_model_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with each sliced parameter gathered whole
    (a collective over the model group: every rank calls it); the state
    dict itself where nothing is sliced."""
    sd = model.state_dict()
    shards = _sharded_params(model)
    for name, shard in shards.items():
        sd[name] = _gather_along(sd[name], shard, shard.dim)
    return sd


def slice_model_state(model: torch.nn.Module,
                      whole: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to the model's slices."""
    shards = _sharded_params(model)
    out = dict(whole)
    for name, shard in shards.items():
        t = out[name]
        lo, hi = shard.bounds(t.shape[shard.dim])
        out[name] = t.narrow(shard.dim, lo, hi - lo).contiguous()
    return out


def _param_shards(params: Sequence[torch.nn.Parameter]):
    return [shard_of(p) for p in params]


def _map_slots(state: Mapping, params, fn) -> dict:
    """Optimizer state {"state": {i: {slot: tensor}}, ...} with fn(slot,
    shard) on every slot shaped like its (sliced or whole) parameter i."""
    shards = _param_shards(params)
    out = dict(state)
    out["state"] = {}
    for i, slots in state["state"].items():
        shard = shards[int(i)]
        out["state"][i] = {
            k: (fn(v, shard) if shard is not None and isinstance(
                v, torch.Tensor) and v.dim() > shard.dim else v)
            for k, v in slots.items()}
    return out


def whole_optimizer_state(optimizer: torch.optim.Optimizer,
                          params: Sequence[torch.nn.Parameter]) -> dict:
    """The optimizer's state dict with each slot of a sliced parameter
    gathered whole (a collective, as `whole_model_state`); `params` in
    the optimizer's order."""
    return _map_slots(optimizer.state_dict(), params,
                      lambda v, s: _gather_along(v, s, s.dim))


def slice_optimizer_state(state: Mapping,
                          params: Sequence[torch.nn.Parameter]) -> dict:
    """A whole optimizer state dict cut to the parameters' slices."""
    def cut(v, s):
        lo, hi = s.bounds(v.shape[s.dim])
        return v.narrow(s.dim, lo, hi - lo).contiguous()

    return _map_slots(state, params, cut)


def whole_tensors(tensors: Sequence[Optional[torch.Tensor]],
                  params: Sequence[torch.nn.Parameter]) -> list:
    """Tensors shaped like their parameters (gradient accumulators), each
    of a sliced parameter gathered whole."""
    return [t if t is None or s is None else _gather_along(t, s, s.dim)
            for t, s in zip(tensors, _param_shards(params))]


def slice_tensors(tensors: Sequence[Optional[torch.Tensor]],
                  params: Sequence[torch.nn.Parameter]) -> list:
    out = []
    for t, s in zip(tensors, _param_shards(params)):
        if t is not None and s is not None:
            lo, hi = s.bounds(t.shape[s.dim])
            t = t.narrow(s.dim, lo, hi - lo).contiguous()
        out.append(t)
    return out
