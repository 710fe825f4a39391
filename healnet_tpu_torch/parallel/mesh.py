"""The (data, seq, model) mesh over ``torch.distributed`` ranks, and the
layout of the parameters on it.

Counterpart of ``healnet_tpu/parallel/mesh.py``. In the port a process is
one device, and a mesh is a grid of the world's ranks with the axes

- ``data``  - the batch (data parallel),
- ``seq``   - the context's tokens (sequence parallel, WSI-scale bags),
- ``model`` - attention heads and feed-forward hidden units (tensor
  parallel),

with one process group for each line of ranks along an axis. Where JAX
annotates shardings and XLA inserts the collectives, every collective of
the port is explicit (:mod:`healnet_tpu_torch.parallel.comm`). An axis of
size 1 has no group and its collectives are the identity, so a mesh of one
device runs the single-device code and works under CUDA-graph capture.

A sharding is a per-dimension tuple of axis names (``PartitionSpec``'s
role): ``("data", None)`` splits dimension 0 over ``data``.

Tensor-parallel rules (Megatron's, over the port's torch-layout ``(out,
in)`` weights): the column-parallel projections ``to_q``, ``to_kv`` and
``net_0`` split their output rows, the row-parallel ``to_out`` and
``net_2`` their input columns (their outputs are summed over ``model``).
The fused outputs split by half: ``to_kv``'s rows are ``[K | V]`` and
``net_0``'s ``[value | gate]``, and each half splits over the ranks, so a
rank owns whole heads (K and V of the same heads) and whole gated units.
A leaf stays replicated where its heads (its hidden units) do not divide
``model``: an attention module splits all of ``to_q``, ``to_kv`` and
``to_out`` or none.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from healnet_tpu_torch.device import DeviceLike, resolve_device

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"
AXES = (AXIS_DATA, AXIS_SEQ, AXIS_MODEL)

Spec = Tuple[Optional[str], ...]


def _factor(n: int, max_model: int, max_seq: int) -> Tuple[int, int, int]:
    """Split n devices into (data, seq, model) with power-of-two model/seq."""
    model = 1
    while model * 2 <= max_model and n % (model * 2) == 0:
        model *= 2
    rest = n // model
    seq = 1
    while seq * 2 <= max_seq and rest % (seq * 2) == 0:
        seq *= 2
    data = rest // seq
    return data, seq, model


class Mesh:
    """A (data, seq, model) grid of process ranks, seen from one rank.

    ``devices``: the ranks, an int array of shape (data, seq, model) (JAX's
    ``mesh.devices``); ``shape``: ``{axis: size}``; ``coords``: this rank's
    coordinate on each axis; :meth:`group`: the process group of this
    rank's line along an axis (None for an axis of size 1); ``device``: the
    device this process computes on.
    """

    axis_names = AXES

    def __init__(self, devices: np.ndarray, rank: int, device: torch.device,
                 groups: Mapping[str, Optional[dist.ProcessGroup]]):
        self.devices = np.asarray(devices)
        self.rank = int(rank)
        self.device = device
        self._groups = dict(groups)
        where = np.argwhere(self.devices == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh {self.devices.tolist()}")
        self.coords: Dict[str, int] = dict(zip(AXES, (int(c) for c in where[0])))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self._groups.get(axis)

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank}, coords={self.coords}, {self.device})"


def _init_world(device: torch.device) -> None:
    """The default process group from the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for
    a card, gloo for the CPU."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            timeout=datetime.timedelta(seconds=600))


def _default_device(device: DeviceLike) -> torch.device:
    """The caller's device; else the card of this process's local rank."""
    if device is not None:
        dev = resolve_device(device)
    else:
        dev = resolve_device(None)
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    max_model: int = 2,
    max_seq: int = 2,
    require: bool = False,
    *,
    device: DeviceLike = None,
) -> Mesh:
    """Build a (data, seq, model) mesh over the world's ranks.

    The world is the default process group where one exists; else one is
    initialised from the ``torchrun`` environment (NCCL for a ``cuda``
    device, gloo for ``cpu``); with no
    such environment the mesh is this process alone, one device, as JAX's
    on one device. ``devices``: the ranks that form the mesh (JAX's device
    list; default every rank). ``n_devices`` keeps the first ``n_devices``
    of them; in a larger world every block of ``n_devices`` consecutive
    ranks forms a mesh of its own, and each rank gets its block's (so
    ``make_mesh(1)`` gives every rank a mesh of its own). With
    ``require=True`` fewer ranks than ``n_devices`` raise instead of a
    smaller mesh. ``device``: this process's device (default: the card of
    its ``LOCAL_RANK``).

    Every rank of the world must call it with the same arguments: the
    groups are created collectively.
    """
    dev = _default_device(device)
    if not dist.is_initialized() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        _init_world(dev)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if n_devices is not None:
        if require and len(ranks) < n_devices:
            raise RuntimeError(
                f"make_mesh(require=True): asked for {n_devices} devices but only "
                f"{len(ranks)} ranks exist; launch more processes (torchrun "
                "--nproc_per_node=N) or drop `require`.")
        n = min(int(n_devices), len(ranks))
    else:
        n = len(ranks)
    blocks = [ranks[i:i + n] for i in range(0, len(ranks) - n + 1, n)]
    mine = next((blk for blk in blocks if rank in blk), None)
    if mine is None:
        raise ValueError(f"rank {rank} is in no mesh of {n} of the ranks {ranks}")
    shape = _factor(n, max_model=max_model, max_seq=max_seq)
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    # every rank creates every group, in one order (new_group is collective)
    for blk in blocks:
        grid = np.asarray(blk).reshape(shape)
        for ax, axis in enumerate(AXES):
            if shape[ax] == 1:
                continue
            lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[axis] = group
    return Mesh(np.asarray(mine).reshape(shape), rank, dev, groups)


def data_parallel_mesh(n_devices: Optional[int] = None, *, device: DeviceLike = None) -> Mesh:
    """Every rank on ``data``: (n, 1, 1)."""
    return make_mesh(n_devices, max_model=1, max_seq=1, device=device)


class Sharding(NamedTuple):
    """A mesh and a per-dimension spec (``NamedSharding``'s role;
    :func:`local_block` cuts a rank's block by a spec)."""

    mesh: Mesh
    spec: Spec


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, extra_axes: int = 0) -> Sharding:
    """Shard the leading (batch) axis over ``data``; rest replicated."""
    return Sharding(mesh, (AXIS_DATA, *([None] * extra_axes)))


def context_sharding(mesh: Mesh, ndim: int, token_axis: int = 1) -> Sharding:
    """Batch over ``data`` and the token axis over ``seq`` (sequence parallel)."""
    spec: list = [None] * ndim
    spec[0] = AXIS_DATA
    spec[token_axis] = AXIS_SEQ
    return Sharding(mesh, tuple(spec))


def _slice(x: torch.Tensor, dim: int, parts: int, index: int, halves: bool = False):
    """Block ``index`` of ``parts`` along ``dim``; with ``halves`` each half
    of the dimension is split and the two blocks are joined."""
    if parts == 1:
        return x
    if halves:
        return torch.cat([_slice(h, dim, parts, index) for h in torch.chunk(x, 2, dim=dim)],
                         dim=dim)
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not divide over {parts}")
    step = n // parts
    return x.narrow(dim, index * step, step)


def local_block(x, spec: Spec, mesh: Mesh, halves: bool = False) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``, on the mesh's device
    (``halves``: split each half of a dimension, the fused outputs' rule)."""
    t = torch.as_tensor(x)
    if t.dtype == torch.float64:
        t = t.float()
    sizes = mesh.shape
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = _slice(t, dim, sizes[axis], mesh.coord(axis), halves)
    return t.to(mesh.device).contiguous()


# ---------------------------------------------------------------- parameters

# the port's names of JAX's suffix rules (Flax ``to_q/kernel`` is the torch
# ``to_q.weight``, stored (out, in)); column-parallel leaves split dim 0
# (their output rows), row-parallel ones dim 1 (their input columns), and
# the column-parallel biases follow their rows
_COL_PARALLEL_SUFFIXES = ("to_q.weight", "to_kv.weight", "net_0.weight", "net_0.bias")
_ROW_PARALLEL_SUFFIXES = ("to_out.weight", "net_2.weight")
# fused outputs split by half: [K | V] and [value | gate]
_HALVES_SUFFIXES = ("to_kv.weight", "net_0.weight", "net_0.bias")


def param_spec(path: str) -> Spec:
    """The suffix rule of a parameter name (torch layout)."""
    if path.endswith(_COL_PARALLEL_SUFFIXES):
        return (AXIS_MODEL,) if path.endswith(".bias") else (AXIS_MODEL, None)
    if path.endswith(_ROW_PARALLEL_SUFFIXES):
        return (None, AXIS_MODEL)
    return ()


def _split_units(module: torch.nn.Module) -> Dict[str, int]:
    """Submodule name -> the units its tensor-parallel leaves split by:
    the heads of an attention module, the hidden units of a feed-forward."""
    from healnet_tpu_torch.models.layers import Attention, FeedForward

    units = {}
    for name, sub in module.named_modules():
        if isinstance(sub, Attention):
            units[name] = sub.heads
        elif isinstance(sub, FeedForward):
            units[name] = sub.hidden
    return units


def param_shardings(params: torch.nn.Module, mesh: Mesh, tensor_parallel: bool = True
                    ) -> Dict[str, Spec]:
    """Parameter name -> spec: the TP rules of :func:`param_spec` where the
    leaf's module splits into whole units (heads, hidden units) over
    ``model``, else replicated; every leaf replicated without
    ``tensor_parallel``."""
    model = mesh.shape[AXIS_MODEL]
    units = _split_units(params) if tensor_parallel and model > 1 else {}
    specs = {}
    for name, _ in params.named_parameters():
        spec = param_spec(name)
        owner = name.rsplit(".", 2)[0] if spec else ""
        ok = owner in units and units[owner] % model == 0
        specs[name] = spec if ok else ()
    return specs


def shard_params(params: torch.nn.Module, mesh: Mesh, tensor_parallel: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """This rank's slice of each parameter of the module ``params``, on the
    mesh's device."""
    state = dict(params.named_parameters())
    out = {}
    for name, spec in param_shardings(params, mesh, tensor_parallel).items():
        value = state[name].detach()
        out[name] = local_block(value, spec, mesh, halves=name.endswith(_HALVES_SUFFIXES))
    return out
