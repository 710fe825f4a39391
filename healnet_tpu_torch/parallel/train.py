"""The sharded training step over a (data, seq, model) mesh.

Counterpart of ``healnet_tpu/parallel/train.py``. JAX annotates the step
and GSPMD inserts the collectives; here every rank runs its shard and the
collectives are explicit:

- the batch's leading axis splits over ``data`` and a context's tokens over
  ``seq`` (:func:`batch_shardings`, :func:`put_batch`); the model is told
  which contexts are split (``seq_sharded``);
- parameters split by the tensor-parallel rules over ``model``
  (:func:`shard_module`, :func:`healnet_tpu_torch.parallel.mesh.
  param_shardings`), or stay replicated;
- the loss is the global batch's: the logits and the labels are gathered
  over ``data`` (the Cox risk set and the NLL mean under ``sample_mask``
  and class weights need every row), each rank computes it alike, and the
  gradients of its own rows flow back (:func:`~healnet_tpu_torch.parallel.
  comm.gather_rows`);
- after the backward each parameter's gradient is summed over ``data``
  (:func:`sync_grads`); the ``seq`` and ``model`` parts are summed inside
  the forward's autograd (``sum_grad`` / ``all_sum``), so every rank then
  holds the gradient of its own (shard of each) parameter, and the same
  optimizer update runs on every rank;
- the L1 term sums each shard's absolute values and adds them across
  ``model`` (JAX's ``flat=False``); only ``data`` coordinate 0 adds it to
  the loss it differentiates, so the sum over ``data`` counts it once.

A mesh of one device runs the single-device step: no collective, the same
numbers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from healnet_tpu_torch.parallel.comm import all_sum, gather_rows, sum_grads_
from healnet_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_SEQ,
    Mesh,
    local_block,
    param_shardings,
    shard_params,
)

_NOT_ROWS = ("seq_sharded",)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: (v if k in _NOT_ROWS else _map(fn, v)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def batch_shardings(
    batch: Mapping[str, Any],
    mesh: Mesh,
    batch_axis_factor: int = 1,
    scan_axis: bool = False,
):
    """The spec of each leaf of a survival batch (the batch's structure,
    a tuple of axis names or None per dimension at each leaf).

    Leading axis over ``data`` everywhere; a leaf of rank >= 3 (a modality
    tensor) splits its token axis over ``seq`` where it divides and holds
    more than one token. ``batch_axis_factor``: the leaves are
    process-local slices of a batch that many times longer, and
    divisibility is judged on it. ``scan_axis``: a leading (steps, ...)
    axis stays whole and every rule moves one dimension right.
    """
    sizes = mesh.shape
    off = 1 if scan_axis else 0

    def spec(leaf):
        shape = np.shape(leaf)
        out = [None] * len(shape)
        b_dim, tok_dim = off, off + 1
        if len(shape) >= b_dim + 1 and (shape[b_dim] * batch_axis_factor) % sizes[AXIS_DATA] == 0:
            out[b_dim] = AXIS_DATA
        if len(shape) >= tok_dim + 2 and _tokens_divide(shape[tok_dim], sizes[AXIS_SEQ]):
            out[tok_dim] = AXIS_SEQ
        return tuple(out)

    return _map(spec, batch)


def _tokens_divide(tokens: int, seq: int) -> bool:
    return tokens > 1 and tokens % seq == 0


def splits_tokens(tokens: int, mesh: Optional[Mesh]) -> bool:
    """Whether a context of ``tokens`` tokens is split over ``seq``: the
    mesh has a ``seq`` axis above 1 and the tokens (more than one) divide
    over it. The batch placement's rule (:func:`batch_shardings`,
    :func:`put_batch`), which a bag gathered on the device follows too."""
    seq = 1 if mesh is None else mesh.shape[AXIS_SEQ]
    return seq > 1 and _tokens_divide(int(tokens), seq)


def put_batch(batch: Mapping[str, Any], mesh: Mesh, batch_axis_factor: int = 1,
              split_tokens: bool = True) -> Dict[str, Any]:
    """This rank's block of every leaf (:func:`batch_shardings`), on the
    mesh's device, and ``seq_sharded``: which modality tensors hold only
    this rank's tokens (none without ``split_tokens``: for a module that
    takes no split context, the batch splits over ``data`` only). The
    batch's rows must divide over ``data``: a sharded step never runs a
    replicated batch."""
    specs = batch_shardings(batch, mesh, batch_axis_factor)
    skip = (AXIS_DATA,) if batch_axis_factor > 1 else ()

    def place(leaf, spec):
        if not split_tokens:
            spec = spec[:1] + (None,) * (len(spec) - 1)
        if mesh.shape[AXIS_DATA] > 1 and np.ndim(leaf) and spec[0] != AXIS_DATA:
            raise ValueError(f"a batch of {np.shape(leaf)[0] * batch_axis_factor} rows does "
                             f"not divide over data {mesh.shape[AXIS_DATA]}")
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float64:
            leaf = leaf.float()
        return local_block(leaf, tuple(None if a in skip else a for a in spec), mesh)

    out = {k: (None if v is None else _zip_map(place, v, specs[k]))
           for k, v in batch.items() if k not in _NOT_ROWS}
    split = split_tokens and mesh.shape[AXIS_SEQ] > 1
    out["seq_sharded"] = tuple(split and len(s) > 1 and s[1] == AXIS_SEQ
                               for s in specs["tensors"])
    return out


def _zip_map(fn, tree, specs):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


# ------------------------------------------------------------- parameters


def shard_module(module: torch.nn.Module, mesh: Mesh, tensor_parallel: bool = True
                 ) -> torch.nn.Module:
    """Replace each parameter of ``module`` by this rank's slice of it, in
    place (:func:`~healnet_tpu_torch.parallel.mesh.shard_params`), and
    remember the full shapes (:func:`full_shapes`). An optimizer is made
    after this, over the slices. Modules that take a mesh are given it."""
    if getattr(module, "_full_shapes", None) is not None:
        raise ValueError("the module is sharded already")
    full = {name: tuple(p.shape) for name, p in module.named_parameters()}
    local = shard_params(module, mesh, tensor_parallel)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.data = local[name]
    module._full_shapes, module._split_mask = full, None
    if hasattr(module, "set_mesh"):
        module.set_mesh(mesh)
    return module


def full_shapes(module: torch.nn.Module) -> Optional[Dict[str, Tuple[int, ...]]]:
    """The parameters' shapes before :func:`shard_module` (None if it was
    not sharded)."""
    return getattr(module, "_full_shapes", None)


def unshard_shapes_(module: torch.nn.Module) -> None:
    """Give a sharded module's parameters their full shapes again (values
    undefined, to be drawn anew) and forget the sharding."""
    full = full_shapes(module)
    if full is None:
        return
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.data = torch.empty(full[name], dtype=p.dtype, device=p.device)
    module._full_shapes = None


def _split_params(module: torch.nn.Module):
    """(names, is each split over ``model``), from the full shapes."""
    full = full_shapes(module) or {}
    names, split = [], []
    for name, p in module.named_parameters():
        names.append(name)
        split.append(name in full and tuple(p.shape) != full[name])
    return names, split


def sync_grads(module: torch.nn.Module, mesh: Mesh) -> None:
    """Sum every parameter's gradient over ``data`` (each rank's gradient
    holds its own rows' part of the global loss)."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    sum_grads_(grads, mesh.group(AXIS_DATA))


def l1_sharded(module: torch.nn.Module, mesh: Mesh) -> torch.Tensor:
    """The L1 norm of the whole parameters: each leaf's absolute sum, the
    split leaves' summed over ``model`` (the gradient stays each shard's)."""
    from healnet_tpu_torch.utils.train_utils import l1_norm

    names, split = _split_params(module)
    params = dict(module.named_parameters())
    rep = [params[n] for n, s in zip(names, split) if not s]
    parts = [params[n] for n, s in zip(names, split) if s]
    total = l1_norm(rep, flat=False) if rep else torch.zeros((), device=mesh.device)
    if parts:
        total = total + all_sum(l1_norm(parts, flat=False), mesh.group(AXIS_MODEL))
    return total


def split_sq_norms(module: torch.nn.Module, mesh: Mesh, sq: torch.Tensor) -> torch.Tensor:
    """Per-parameter squared gradient norms ``sq`` (named_parameters
    order, those with a gradient) of the whole parameters: the split
    ones summed over ``model``."""
    group = mesh.group(AXIS_MODEL)
    if group is None:
        return sq
    # which are split: one copy to the device a sharding (a copy a step
    # would make the host wait for the device)
    mask = getattr(module, "_split_mask", None)
    if mask is None or mask.numel() != sq.numel():
        _, split = _split_params(module)
        mask = torch.tensor([s for s, p in zip(split, module.parameters())
                             if p.grad is not None], device=sq.device)
        module._split_mask = mask
    parts = torch.where(mask, sq, torch.zeros_like(sq))
    return torch.where(mask, all_sum(parts, group), sq)


def global_rows(batch: Mapping[str, Any], mesh: Mesh, keys) -> Dict[str, Any]:
    """The batch with ``keys`` (per-sample labels) gathered over ``data``."""
    group = mesh.group(AXIS_DATA)
    return {**batch, **{k: gather_rows(batch[k], group) for k in keys
                        if batch.get(k) is not None}}


def model_keywords(module: torch.nn.Module, batch: Mapping[str, Any]) -> Dict[str, Any]:
    """``seq_sharded`` for a module that takes it, where a context is split."""
    flags = batch.get("seq_sharded")
    if flags and any(flags):
        if not hasattr(module, "set_mesh"):
            raise ValueError(f"{type(module).__name__} does not take contexts split over seq")
        return {"seq_sharded": flags}
    return {}


_LABELS = ("y_disc", "censorship", "event_time", "sample_mask")


def global_batch(logits: torch.Tensor, batch: Mapping[str, Any], mesh: Optional[Mesh]):
    """``(logits, batch)`` of the global batch, for its loss: on a mesh the
    logits (on the autograd path) and the labels gathered over ``data``, as
    the Cox risk set and the NLL mean under ``sample_mask`` and class
    weights need every row; every rank computes the loss alike and its own
    rows' gradients flow back. Without a mesh, as given."""
    if mesh is None:
        return logits, batch
    return gather_rows(logits, mesh.group(AXIS_DATA)), global_rows(batch, mesh, _LABELS)


def sharded_loss(
    module: torch.nn.Module,
    logits: torch.Tensor,
    batch: Mapping[str, Any],
    mesh: Optional[Mesh],
    loss_fn: Callable,
    *,
    l1: float = 0.0,
    gc_compat: float = 1.0,
    reg: Optional[Callable[[torch.nn.Module], torch.Tensor]] = None,
):
    """``(total, surv_loss, risk)`` of a step: the global batch's loss
    (``loss_fn`` on :func:`global_batch`) over ``gc_compat``, plus the L1
    term. The L1 term is added only at ``data`` coordinate 0, since the
    gradients are then summed over ``data`` (:func:`sync_grads`, after the
    backward). Where a parameter is split over ``model`` it is ``l1`` times
    :func:`l1_sharded` (each shard's absolute sum, added across ``model``);
    otherwise ``reg(module)`` (default the same)."""
    surv, risk = loss_fn(*global_batch(logits, batch, mesh))
    total = surv / float(gc_compat)
    if l1 > 0 and (mesh is None or mesh.coord(AXIS_DATA) == 0):
        if reg is None or any(_split_params(module)[1]):
            total = total + float(l1) * l1_sharded(module, mesh)
        else:
            total = total + reg(module)
    return total, surv, risk


def make_sharded_train_step(
    module: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    *,
    loss_type: str = "nll",
    alpha: float = 0.4,
    l1: float = 0.0,
    gc_compat: float = 16.0,
    class_weights: Optional[torch.Tensor] = None,
    tensor_parallel: bool = True,
    max_lr: Optional[float] = None,
    horizon: float = 1.0,
    cycle_momentum: bool = True,
) -> Callable:
    """The sharded step: ``step(batch, generator=None, seed_generator=None,
    seeds=None) -> (surv_loss, risk)``, the loss and the risks of the global
    batch (the same on every rank); the dropout draws as the module's
    ``forward`` takes them (the same generator states or seeds on every
    rank). ``batch``: placed with :func:`put_batch` (or
    :func:`~healnet_tpu_torch.parallel.data.global_batch_from_host_local`);
    ``module`` and ``optimizer`` as :func:`init_sharded_state` leaves them.
    The step checks that the parameters have the mesh's layout (TP rules,
    or replicated without ``tensor_parallel``) and raises where they do
    not. With ``max_lr`` the optimizer's lr (and beta1 with
    ``cycle_momentum``) is set from its step count over ``horizon``
    (:func:`healnet_tpu_torch.train.schedule.progress_hyperparams`).
    """
    from healnet_tpu_torch.train.losses import survival_loss
    from healnet_tpu_torch.train.schedule import progress_hyperparams

    expect = shard_params_shapes(module, mesh, tensor_parallel)

    def loss_fn(logits, labels):
        return survival_loss(logits, labels, loss_type=loss_type, alpha=alpha,
                             class_weights=class_weights)

    def step(batch, generator=None, seed_generator=None, seeds=None):
        for name, p in module.named_parameters():
            if tuple(p.shape) != expect[name]:
                raise ValueError(f"{name} is {tuple(p.shape)}, the mesh's layout "
                                 f"{expect[name]}: shard the module with shard_module")
        module.train()
        optimizer.zero_grad(set_to_none=True)
        kw = model_keywords(module, batch)
        logits = module(batch["tensors"], presence=batch.get("presence"),
                        kv_masks=batch.get("kv_masks"), generator=generator,
                        seed_generator=seed_generator, seeds=seeds, **kw)
        total, surv, risk = sharded_loss(module, logits, batch, mesh, loss_fn, l1=l1,
                                         gc_compat=gc_compat)
        total.backward()
        sync_grads(module, mesh)
        if max_lr is not None:
            progress_hyperparams(optimizer, horizon, max_lr, cycle_momentum=cycle_momentum)
        optimizer.step()
        return surv.detach(), risk.detach()

    return step


def shard_params_shapes(module: torch.nn.Module, mesh: Mesh, tensor_parallel: bool = True
                        ) -> Dict[str, Tuple[int, ...]]:
    """Each parameter's local shape under the mesh's layout."""
    full = full_shapes(module) or {n: tuple(p.shape) for n, p in module.named_parameters()}
    sizes = mesh.shape
    out = {}
    for name, spec in param_shardings(module, mesh, tensor_parallel).items():
        shape = list(full[name])
        for dim, axis in enumerate(spec):
            if axis is not None:
                shape[dim] //= sizes[axis]
        out[name] = tuple(shape)
    return out


def init_sharded_state(
    module: torch.nn.Module,
    optimizer_fn: Callable,
    example_batch: Optional[Mapping[str, Any]],
    mesh: Mesh,
    seed: int = 0,
    tensor_parallel: bool = True,
):
    """Draw the module's weights from ``seed`` (on the host, as a new
    module's are: the same weights on every rank), shard them over the
    mesh (:func:`shard_module`) and make the optimizer over the shards with
    ``optimizer_fn(parameters)``. Returns ``(module, optimizer)``.
    ``example_batch`` is unused: the port's modules know their shapes."""
    del example_batch
    device = mesh.device
    module.to("cpu")
    if hasattr(module, "reset_parameters"):
        module.reset_parameters(torch.Generator().manual_seed(seed))
    module.to(device)
    shard_module(module, mesh, tensor_parallel)
    return module, optimizer_fn(module.parameters())
