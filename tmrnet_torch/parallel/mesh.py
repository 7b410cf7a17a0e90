"""The (data x model) grid across processes: one process a card (or a CPU
in the tests), `torch.distributed` between them.

Port of `tmrnet_tpu/parallel/mesh.py`. JAX compiles one SPMD program over
a ('data', 'model') mesh and lets XLA insert the collectives; the port
runs one process a card and makes each collective itself, so that a
grid's step computes what a one-process step over the same global batch
computes. Rank r sits at data index r // M and model index r % M, JAX's
`reshape(dp, mp)` of the process-ordered devices (:48-62): the ranks of
one data index (consecutive) form a model group, the ranks of one model
index a data group. The model axis is tensor parallelism, whose rules and
collectives are `parallel/tensor.py`'s; this module is the grid and the
data axis:

- the global batch splits into contiguous rows, [d*B/dp, (d+1)*B/dp) at
  data index d (`process_local_bounds`, JAX :168-197 on a
  process-contiguous mesh), and each rank's loader assembles only its own
  rows (the ranks of a model group the same ones);
- a train-mode BatchNorm takes its statistics over the global batch
  (`models/resnet.py::batch_norm` reads `current_shard()`), and dropout
  draws its mask at the global batch's shape and keeps the rank's rows
  (`models/blocks.py::dropout`);
- the gradients are summed over the data group once per optimizer step
  (`all_reduce_sum_`, `train/state.py`; under a model axis a replicated
  parameter's are each model group's first rank's, summed over the
  world), since the loss is a sum;
- every rank starts from rank 0's weights (`broadcast_module`, JAX's
  replicated placement), then keeps its slice of each parameter that the
  TP rules shard (`parallel/tensor.py::shard_model_`, JAX's
  `shard_state` :219-261).

With M = 1 the grid is the data axis alone: the data group is the world
and nothing is sharded.

Collectives on the card are `all_reduce` and `broadcast` only, which
both NCCL and gloo take for CUDA tensors (two ranks may then share
one card over gloo; NCCL refuses that). Host arrays go through a gloo
group on the CPU (`all_gather_host`, `all_reduce_host`), as NCCL takes no
CPU tensors. Nothing falls back: a failed rendezvous, a rank without its
card or a failed collective raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tmrnet_torch.config import MeshConfig
from tmrnet_torch.device import resolve_device

# The gloo group on the CPU beside a default group of another backend,
# one for each default group (made collectively, once).
_CPU_GROUPS: Dict[Any, Any] = {}


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """The rank's device: `device` where it names an index or the CPU, else
    cuda:(LOCAL_RANK % device_count), LOCAL_RANK defaulting to `rank`
    (a manual launch with --set mesh.process_id) or RANK. A card that is
    not there raises."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return resolve_device(dev)
    if not torch.cuda.is_available():
        resolve_device(dev)             # raises: no card
    local = os.environ.get("LOCAL_RANK",
                           rank if rank is not None else
                           os.environ.get("RANK", 0))
    return torch.device("cuda", int(local) % torch.cuda.device_count())


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda",
                         backend: Optional[str] = None,
                         timeout: Optional[float] = None) -> torch.device:
    """Join the process group and return this rank's device, set as the
    current card before any other CUDA call. `coordinator` ("host:port"),
    `num_processes` and `process_id` together give a tcp:// rendezvous;
    none of them, torchrun's environment (env://: RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT). The backend is NCCL for a card and gloo
    for the CPU unless `backend` says (gloo lets two ranks share a card).
    Nothing happens but the device's choice when the group is up already;
    a failed rendezvous raises (after `timeout` seconds, default
    torch's)."""
    given = [coordinator, num_processes, process_id]
    if any(v is not None for v in given) and None in given:
        raise ValueError("mesh.coordinator, mesh.num_processes and "
                         "mesh.process_id go together")
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if coordinator is not None:
        kw.update(init_method=f"tcp://{coordinator}",
                  world_size=int(num_processes), rank=int(process_id))
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"), **kw)
    return dev


def shutdown() -> None:
    """Leave the process group (and drop its CPU and grid groups)."""
    _CPU_GROUPS.clear()
    _GRID_GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


# The grid's groups, made collectively once for each (world group, M):
# (data groups, their gloo groups on the CPU, model groups), each a list
# by index.
_GRID_GROUPS: Dict[Any, Any] = {}


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The (data x model) grid over every process: the default group (NCCL
    on cards, gloo on the CPU), its gloo group on the CPU for host arrays,
    this process's rank, the world size and the rank's device; with
    model_parallel M > 1 also this rank's data group (device and CPU) and
    model group. Collectives over `group` and `cpu_group` span the world
    (every rank a data rank, as the eval commands take it); the trainers
    sum over the data group."""

    group: Any
    cpu_group: Any
    rank: int
    world: int
    device: torch.device
    model_parallel: int = 1
    data_groups: Any = None         # (device group, CPU group); None: world
    model_group: Any = None

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    @property
    def dp(self) -> int:
        return self.world // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    @property
    def data_group(self):
        return self.group if self.data_groups is None else self.data_groups[0]

    @property
    def data_cpu_group(self):
        return (self.cpu_group if self.data_groups is None
                else self.data_groups[1])

    @property
    def shape(self) -> Dict[str, int]:
        """JAX's `mesh.shape`: {'data': dp, 'model': M}."""
        return {"data": self.dp, "model": self.model_parallel}


def _grid_groups(group, world: int, mp: int, backend: str):
    """Every data and model group of a dp x mp grid over `world` ranks,
    made in one order on every rank (new_group is collective)."""
    key = (group, mp)
    if key not in _GRID_GROUPS:
        dp = world // mp
        data = [[d * mp + m for d in range(dp)] for m in range(mp)]
        model = [[d * mp + m for m in range(mp)] for d in range(dp)]
        data_dev = [dist.new_group(r) for r in data]
        data_cpu = (data_dev if backend == "gloo" else
                    [dist.new_group(r, backend="gloo") for r in data])
        _GRID_GROUPS[key] = (data_dev, data_cpu,
                             [dist.new_group(r) for r in model])
    return _GRID_GROUPS[key]


def make_mesh(cfg: MeshConfig = MeshConfig(), device="cuda") -> DataMesh:
    """The grid over the process group (`initialize_multihost` first),
    checked as JAX's `make_mesh` checks its sizes (:48-62): M =
    mesh.model_parallel divides the world, and mesh.data_parallel is -1 or
    the world over M. Every rank calls it (the groups are made
    collectively). device: as `rank_device`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "initialize_multihost first")
    world, rank = dist.get_world_size(), dist.get_rank()
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel
    if world % mp or (dp != -1 and dp * mp != world):
        want = dp * mp if dp != -1 else f"a multiple of {mp}"
        raise ValueError(f"mesh {dp}x{mp} needs {want} processes, "
                         f"have {world}")
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    cpu = group
    if backend != "gloo":
        if group not in _CPU_GROUPS:
            _CPU_GROUPS[group] = dist.new_group(backend="gloo")
        cpu = _CPU_GROUPS[group]
    dev = rank_device(device, rank)
    if mp == 1:
        return DataMesh(group, cpu, rank, world, dev)
    data_dev, data_cpu, model = _grid_groups(group, world, mp, backend)
    m, d = rank % mp, rank // mp
    return DataMesh(group, cpu, rank, world, dev, mp,
                    (data_dev[m], data_cpu[m]), model[d])


def process_local_bounds(global_batch: int, rank: int,
                         world: int) -> Tuple[int, int]:
    """[lo, hi): the contiguous rows of data index `rank` among `world`
    of a global batch, [r*B/P, (r+1)*B/P); a batch that does not divide
    raises."""
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} does not divide "
                         f"over {world} data ranks")
    per = global_batch // world
    return rank * per, (rank + 1) * per


def mesh_spans_processes(mesh: Optional[DataMesh]) -> bool:
    return mesh is not None and mesh.world > 1


def require_single_controller(mesh: Optional[DataMesh], what: str) -> None:
    """The engines run one process over its own card: a mesh over several
    processes is refused by name (`eval/distributed.py` partitions videos
    over processes instead, each with its own engine)."""
    if mesh_spans_processes(mesh):
        raise ValueError(
            f"{what} runs in one process on one card: give it the rank's "
            f"device, not a mesh over {mesh.world} processes (multi-process "
            f"evaluation partitions videos, eval/distributed.py)")


def all_gather_host(array: np.ndarray, mesh: DataMesh,
                    data_only: bool = False) -> np.ndarray:
    """multihost_utils.process_allgather: every rank's `array` (one shape
    on all ranks) stacked as (world, ...), through the CPU group; with
    data_only, the data group's, (dp, ...)."""
    a = np.ascontiguousarray(array)
    as_bool = a.dtype == np.bool_
    t = torch.from_numpy(a.astype(np.uint8) if as_bool else a)
    n = mesh.dp if data_only else mesh.world
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t, group=(mesh.data_cpu_group if data_only
                                   else mesh.cpu_group))
    g = torch.stack(out).numpy()
    return g.astype(np.bool_) if as_bool else g


def all_reduce_host(array: np.ndarray, mesh: DataMesh,
                    op: str = "sum", data_only: bool = False) -> np.ndarray:
    """The elementwise sum (or max) of `array` over the ranks (with
    data_only, over the data group), through the CPU group."""
    t = torch.from_numpy(np.array(array))
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op],
                    group=(mesh.data_cpu_group if data_only
                           else mesh.cpu_group))
    return t.numpy()


def _flat_groups(tensors: Iterable[torch.Tensor]):
    by = {}
    for t in tensors:
        by.setdefault((t.dtype, t.device), []).append(t)
    return by.values()


def all_reduce_sum_(tensors: Iterable[torch.Tensor], mesh: DataMesh,
                    group: Any = None) -> None:
    """Sum each tensor over the ranks (of `group`, default the world) in
    place: one all-reduce a dtype, over the tensors laid end to end."""
    for ts in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=mesh.group if group is None else group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def broadcast_module(module: torch.nn.Module, mesh: DataMesh,
                     src: int = 0) -> None:
    """Give every rank rank `src`'s parameters and buffers (in place): one
    broadcast a dtype."""
    with torch.no_grad():
        for ts in _flat_groups(module.state_dict().values()):
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src, group=mesh.group)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's rows [lo, hi) of a global batch of `size`, its rank and
    the group its BatchNorm statistics are summed over."""

    lo: int
    hi: int
    size: int
    rank: int
    world: int
    group: Any


def shard_of(mesh: DataMesh, local_batch: int) -> BatchShard:
    """The rows of this rank's data index; its BatchNorm statistics are
    summed over the data group."""
    lo = mesh.data_index * local_batch
    return BatchShard(lo, lo + local_batch, local_batch * mesh.dp,
                      mesh.data_index, mesh.dp, mesh.data_group)


# The shard of the train step running in this process. Not thread-local:
# on a card the backward pass, and with it a remat block's recomputation,
# runs on autograd's device thread.
_SHARD: Optional[BatchShard] = None


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    """Within: train-mode BatchNorm and dropout act as on the global batch
    that `shard` is a part of."""
    global _SHARD
    previous, _SHARD = _SHARD, shard
    try:
        yield
    finally:
        _SHARD = previous


def current_shard() -> Optional[BatchShard]:
    return _SHARD
