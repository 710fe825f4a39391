"""Flash cross-attention, forward and backward.

Counterpart of ``healnet_tpu/ops/flash_attention.py``. A small latent query
array attends to a long per-modality context; the forward CUDA kernel
(``csrc/flash_attention.cu``) streams KV tiles with an online softmax so the
(lq x lkv) weights never reach device memory, and writes the per-row
log-sum-exp; the backward kernel (``csrc/flash_attention_bwd.cu``) rebuilds
the probabilities from that log-sum-exp and ``delta = rowsum(dO * O)``.
:class:`FlashAttentionFunction` ties the two together for autograd; its
forward is the registered op ``healnet_port::flash_attention_fwd``
(:func:`flash_fwd_op`), which ``torch.export`` keeps in a traced program.

Each kernel has four routes, chosen by :func:`flash_variant` from the
dtype and head dim before the launch: bf16 with d <= 128 (the model's
path) takes the tensor-core kernel (``"tc"``); f32 up to 256, and bf16 of
129-256, the f32 FMA kernel (``"fma"``); heads of 257-512 the one-pass wide
kernels of ``csrc/flash_wide.cu`` (``"wide"``: bf16 on tensor cores, f32 on
FMAs, each tile's scores taken once over the whole head); wider heads the
same kernels with the head's columns split into panels over a cluster's
blocks (``"panels"``, :func:`flash_panels`: each tile's partial scores
summed across the panels through distributed shared memory). All are one
clustered launch per call sized by :func:`flash_plan` (in key tiles of
:func:`key_tile`) from the kernel's own cluster occupancy. Each wrapper
counts the launches of each kernel in its own counter
(:func:`launch_counter`). Every kernel takes any latent count: the forward
walks the queries in groups inside a block, and the backward walks them in
chunks sized by :func:`query_chunks` from what a block holds.

The plain versions are :func:`healnet_tpu_torch.ops.attention.multihead_attention`
(forward, materialised weights; its autograd gradient is the same function
as the kernels' backward) and :func:`flash_backward_plain`, which carries
the backward kernel's formulas with materialised probabilities.

Semantics shared with the TPU kernels: temperature folded into the scale,
masked keys contribute zero, a row with every key masked outputs zero and
gets zero gradients, dropout multiplies the normalised probabilities by
``keep / (1 - rate)`` with ``keep`` from the coordinate hash over absolute
(batch*head row, query, key) coordinates, and the denominator is taken
before dropout.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.attention import multihead_attention
from healnet_tpu_torch.ops.hash_dropout import dense_keep_mask, keep_scale, keep_threshold

_TC_TILE = 64  # keys per tile of the tensor-core kernels (tc::kKeyTile)
_TC_MAX_D = 128  # widest head the tensor-core kernels take
_FMA_CHUNK = 256  # widest head of the one-pass FMA kernels (fmav::kMaxD)
_FMA_TILE = 32  # keys per tile of the FMA kernels (fmav::kKeys)
_WIDE_MAX_D = 512  # widest head (or panel) a wide block takes (flash_wide.cu kMaxD)
_PANEL_MAX = 6  # panels of one pass (flash_wide.cu kMaxPanels)
# the widest panel of the bf16 backward: it then still holds a chunk of 32
# queries beside the exchange (its chunks are whole m16 tiles, and at 512 it
# holds 16, which splits lq 17 and took 2.6x the time at d 1024); every
# other panel is up to 512 wide
_BF16_BWD_PANEL_WIDTH = 480
# per dtype, flash_wide.cu's Wide<T>: keys per tile, the multiple a head (or
# panel) pads to, a staged row's padding, an exchange slot's row pitch
_WIDE_TILE = {torch.bfloat16: 32, torch.float32: 16}
_WIDE_ALIGN = {torch.bfloat16: 16, torch.float32: 32}
_WIDE_PAD = {torch.bfloat16: 8, torch.float32: 4}
_WIDE_XPITCH = {torch.bfloat16: 36, torch.float32: 16}
_MAX_SMEM = 232448  # dynamic shared memory a block may use (tc::kMaxSmem)
_TC_QGROUP = 32  # queries per group of the tensor-core kernels (tc::kQGroup)
_CLUSTER_SIZES = (16, 8, 4, 2, 1)
# the wide kernels run one block an SM, where 16-block clusters of brca's 8
# rows are not all resident: they take any size up to 16
_WIDE_CLUSTER_SIZES = tuple(range(16, 0, -1))
_NEG_BIG = -1e30


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention")
    fn = lib.healnet_flash_forward
    if fn.argtypes is None:
        p, i, ll, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint32)
        fn.argtypes = [p] * 6 + [i] * 7 + [ll] * 10 + [f, i, p, u, f, u, i, i, p]
        fn.restype = ctypes.c_int
        lib.healnet_flash_max_queries.argtypes = [i]
        lib.healnet_flash_max_queries.restype = i
        lib.healnet_flash_fma_max_clusters.argtypes = [i, i, i]
        lib.healnet_flash_fma_max_clusters.restype = i
        lib.healnet_flash_forward_tc.argtypes = (
            [p] * 6 + [i] * 7 + [ll] * 10 + [f, i, p, u, f, u, i, p])
        lib.healnet_flash_forward_tc.restype = ctypes.c_int
        lib.healnet_flash_tc_max_clusters.argtypes = [i, i]
        lib.healnet_flash_tc_max_clusters.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_attention_bwd")
    fn = lib.healnet_flash_backward
    if fn.argtypes is None:
        p, i, ll, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint32)
        fn.argtypes = [p] * 11 + [i] * 9 + [ll] * 13 + [f, i, p, u, f, u, i, i, p]
        fn.restype = ctypes.c_int
        lib.healnet_flash_bwd_max_queries.argtypes = [i]
        lib.healnet_flash_bwd_max_queries.restype = i
        lib.healnet_flash_bwd_fma_max_clusters.argtypes = [i, i, i, i]
        lib.healnet_flash_bwd_fma_max_clusters.restype = i
        lib.healnet_flash_backward_tc.argtypes = (
            [p] * 11 + [i] * 9 + [ll] * 13 + [f, i, p, u, f, u, i, p])
        lib.healnet_flash_backward_tc.restype = ctypes.c_int
        lib.healnet_flash_bwd_tc_max_queries.argtypes = [i]
        lib.healnet_flash_bwd_tc_max_queries.restype = i
        lib.healnet_flash_bwd_tc_max_clusters.argtypes = [i, i, i]
        lib.healnet_flash_bwd_tc_max_clusters.restype = ctypes.c_int
    return lib


def flash_variant(dtype: torch.dtype, d: int) -> str:
    """Which kernel pair a call takes, from its dtype and head dim alone:
    ``"tc"`` (tensor cores) for bf16 with d <= 128; ``"fma"`` (f32 FMA;
    tensor cores would mean TF32 for f32) for other heads up to 256;
    ``"wide"`` (one pass, bf16 on tensor cores) for 257-512; ``"panels"``
    (the wide kernels over :func:`flash_panels`) above."""
    if dtype == torch.bfloat16 and d <= _TC_MAX_D:
        return "tc"
    if d <= _FMA_CHUNK:
        return "fma"
    return "wide" if d <= _WIDE_MAX_D else "panels"


def key_tile(dtype: torch.dtype, d: int) -> int:
    """Keys per tile of the kernel a call takes: 64 for the tensor-core
    kernels, 32 (bf16) or 16 (f32) for the wide and panel ones, 32 for the
    FMA ones."""
    variant = flash_variant(dtype, d)
    if variant == "tc":
        return _TC_TILE
    return _FMA_TILE if variant == "fma" else _WIDE_TILE[dtype]


class Panels(NamedTuple):
    """How the wide kernels split a head: ``count`` panels over a cluster's
    blocks in each of ``passes`` passes, and the columns ``(start, width)``
    of panel ``t * count + i`` (pass t, cluster panel i)."""

    count: int
    passes: int
    columns: Tuple[Tuple[int, int], ...]


def flash_panels(dtype: torch.dtype, d: int, backward: bool = False) -> Panels:
    """The panels of a head of ``d`` columns on the wide kernels, forward
    or backward: one for d <= 512, else ``ceil(d / 512)`` (two of 288 at
    d 576; ``ceil(d / 480)`` for the bf16 backward), in one pass while that
    is at most ``_PANEL_MAX`` (their exchange slots fit beside a 512-wide
    panel only so far: :func:`wide_smem`), else in the fewest passes of at
    most ``_PANEL_MAX``. Widths are balanced in whole ``kAlign`` units (16
    columns for bf16, 32 for f32), the last panel clipped to d, so no panel
    is wider than 512. Fewer, wider panels are faster: every panel count
    runs a tile in about the same time, and more panels leave fewer key
    ranges to a cluster."""
    width = _BF16_BWD_PANEL_WIDTH if backward and dtype == torch.bfloat16 else _WIDE_MAX_D
    n = 1 if d <= _WIDE_MAX_D else -(-d // width)
    passes = -(-n // _PANEL_MAX)
    count = -(-n // passes)
    total, align = count * passes, _WIDE_ALIGN[dtype]
    units = -(-d // align)
    cuts = [min(d, i * units // total * align) for i in range(total + 1)]
    return Panels(count, passes, tuple((a, b - a) for a, b in zip(cuts, cuts[1:])))


def wide_smem(dtype: torch.dtype, dp: int, panels: int = 1, rows: Optional[int] = None
              ) -> Tuple[int, int, int]:
    """``(stages, alias, bytes)`` of a wide or panel kernel's shared memory
    at padded panel width ``dp``, mirroring ``flash_wide.cu``'s FwdLayout
    (``rows`` None) or BwdLayout (a query chunk of ``rows``, bf16's padded
    to 16) and its pick_plan: the most ring stages (4 to 2) beside the
    pushed states, else aliased with them; (0, 0, 0) where none fits.
    ``panels`` > 1 adds the exchange: six mbarriers (the exchange's two and
    the ring's four) and a slot of partial scores for each tile parity and
    panel."""
    kt, tc = _WIDE_TILE[dtype], dtype == torch.bfloat16
    row = (2 if tc else 4) * (dp + _WIDE_PAD[dtype])
    stage = 2 * kt * row + 4 * kt
    a16 = lambda x: -(-x // 16) * 16  # noqa: E731

    def total(stages: int, alias: bool) -> int:
        ring = stages * stage
        if rows is None:
            pushed = a16(4 * (_TC_QGROUP * dp + 16))
            at = (max(ring, pushed) if alias else ring + pushed) + _TC_QGROUP * row
            at += ((4 * _TC_QGROUP * (kt + 4) if panels == 1 else 0) + 2 * _TC_QGROUP * (kt + 8)
                   if tc else 4 * _TC_QGROUP * kt)
            end = at + 4 * _TC_QGROUP + 2 * 4 * 16 * _TC_QGROUP
            slot = _TC_QGROUP * _WIDE_XPITCH[dtype]
        else:
            pushed = a16(4 * (rows * dp + 16))
            at = a16((max(ring, pushed) if alias else ring + pushed) + 2 * rows * row + 8 * rows)
            end = at + (4 * kt * (rows + 8) if tc else 8 * rows * kt)
            slot = 2 * rows * _WIDE_XPITCH[dtype]
        return end if panels == 1 else a16(end) + 48 + 4 * 2 * panels * slot

    for alias in (False, True):
        for stages in (4, 3, 2):
            if total(stages, alias) <= _MAX_SMEM:
                return stages, int(alias), total(stages, alias)
    return 0, 0, 0


def flash_plan(rows: int, lkv: int, sms: int, max_cluster: int,
               tile: int = _TC_TILE, panels: int = 1) -> Tuple[int, int]:
    """Launch plan of every kernel variant: ``(cluster, keys_per_block)``.

    One cluster of ``cluster`` blocks per (batch*head) row: ``panels``
    blocks (the head's panels, :func:`flash_panels`) for each of the row's
    key ranges, block ``r`` owning panel ``r % panels`` of keys
    ``[(r // panels) * keys_per_block, (r // panels + 1) * keys_per_block)``:
    enough blocks for one on every SM, each range a whole number of
    ``tile``-key tiles, the cluster at most ``max_cluster`` (the largest
    cluster of which ``rows`` fit on the card at once, a multiple of
    ``panels``), and no range without keys (so ``lkv <= tile`` gives one).
    """
    tiles = max(1, -(-lkv // tile))
    want = max(1, -(-sms // max(rows, 1)))
    ranges = max(1, min(-(-want // panels), tiles, max_cluster // panels))
    per = -(-tiles // ranges) * tile
    return max(1, -(-lkv // per)) * panels, per


def query_chunks(lq: int, max_rows: int, align: int = 1) -> Tuple[int, int]:
    """``(n_chunks, chunk)``: the fewest chunks of at most ``max_rows``
    queries (the most a block's shared memory holds), each a multiple of
    ``align`` (32 for the tensor-core backward's query groups), balanced so
    that chunk ``i`` holds queries ``[i * chunk, min(lq, (i + 1) * chunk))``
    and none is empty. Raises where ``max_rows`` holds no aligned chunk."""
    cap = max_rows // align * align
    if cap < 1:
        raise ValueError(f"a block holds {max_rows} queries, fewer than one chunk of {align}")
    n = max(1, -(-lq // cap))
    chunk = -(-(-(-lq // n)) // align) * align
    return n, chunk


def _wide_lib() -> ctypes.CDLL:
    lib = cuda_build.load("flash_wide")
    fn = lib.healnet_flash_wide_forward
    if fn.argtypes is None:
        p, i, ll, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint32)
        fn.argtypes = [p] * 7 + [i] * 9 + [ll] * 10 + [f, i, p, u, f, u, i, i, p]
        fn.restype = i
        lib.healnet_flash_wide_backward.argtypes = (
            [p] * 12 + [i] * 11 + [ll] * 13 + [f, i, p, u, f, u, i, i, p])
        lib.healnet_flash_wide_backward.restype = i
        lib.healnet_flash_wide_max_d.restype = i
        lib.healnet_flash_wide_max_panels.restype = i
        lib.healnet_flash_wide_smem.argtypes = [i] * 6
        lib.healnet_flash_wide_smem.restype = ll
        lib.healnet_flash_wide_fwd_max_clusters.argtypes = [i] * 5
        lib.healnet_flash_wide_fwd_max_clusters.restype = i
        lib.healnet_flash_wide_bwd_max_queries.argtypes = [i] * 4
        lib.healnet_flash_wide_bwd_max_queries.restype = i
        lib.healnet_flash_wide_bwd_max_clusters.argtypes = [i] * 6
        lib.healnet_flash_wide_bwd_max_clusters.restype = i
        if (lib.healnet_flash_wide_max_d(), lib.healnet_flash_wide_max_panels()) != (
                _WIDE_MAX_D, _PANEL_MAX):
            raise RuntimeError("flash_wide.cu's kMaxD / kMaxPanels and _WIDE_MAX_D / "
                               "_PANEL_MAX disagree")
    return lib


@functools.lru_cache(maxsize=None)
def _max_queries(lib: ctypes.CDLL, name: str, *args: int) -> int:
    """The most queries a block of a kernel holds, from ``lib``'s query
    ``name`` (``args``: the head dim, and for the wide kernels whether it is
    bf16), cached."""
    return int(getattr(lib, name)(*args))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (kernel, device, shape class) -> {cluster size: clusters resident at once}
_RESIDENT: Dict[tuple, Dict[int, int]] = {}


def _max_cluster(query, key: tuple, rows: int, sizes: Tuple[int, ...] = _CLUSTER_SIZES) -> int:
    """The largest cluster size of ``sizes`` of which ``rows`` clusters of a
    kernel are resident at once (1 if none), from its cluster occupancy
    (``query(size)``, ``cudaOccupancyMaxActiveClusters``) cached per kernel,
    device and shape class (``key``). The fused chain sizes its clusters by
    it too."""
    counts = _RESIDENT.get(key)
    if counts is None:
        counts = {c: int(query(c)) for c in sizes}
        if min(counts.values()) < 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed for {key}")
        _RESIDENT[key] = counts
    return next((c for c in sizes if counts[c] >= rows), sizes[-1])


def _plan(query, key: tuple, rows: int, lkv: int, device: torch.device,
          tile: int = _TC_TILE, sizes: Tuple[int, ...] = _CLUSTER_SIZES,
          panels: int = 1) -> Tuple[int, int]:
    """:func:`flash_plan` on ``device``, with its SM count and
    :func:`_max_cluster` over ``sizes`` (the smallest where none is
    resident ``rows`` times)."""
    return flash_plan(rows, lkv, _sm_count(device.index),
                      _max_cluster(query, key, rows, sizes), tile, panels)


def _sizes(variant: str, panels: int = 1) -> Tuple[int, ...]:
    """The cluster sizes a route's plan may take: for the wide kernels any
    multiple of its panels up to 16."""
    if variant in ("wide", "panels"):
        return tuple(c for c in _WIDE_CLUSTER_SIZES if c % panels == 0)
    return _CLUSTER_SIZES


def _check_qkv(q, k, v, extra=()) -> None:
    for name, x in (("q", q), ("k", k), ("v", v), *extra):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if x.dtype != q.dtype or x.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"q, k, v must share bf16 or f32, got {x.dtype}")
        if x.ndim != 4 or x.stride(-1) != 1:
            raise ValueError(f"{name} must be (b, h, n, d) with unit stride on d")
    b, h, _, d = q.shape
    lkv = k.shape[2]
    if tuple(k.shape) != (b, h, lkv, d) or tuple(v.shape) != (b, h, lkv, d):
        raise ValueError(f"k, v must be {(b, h, lkv, d)}: {k.shape}, {v.shape}")


def _float_mask(kv_mask, b, lkv, device):
    if kv_mask is None:
        return None
    if tuple(kv_mask.shape) != (b, lkv):
        raise ValueError(f"kv_mask must be {(b, lkv)}, got {tuple(kv_mask.shape)}")
    return kv_mask.to(device=device, dtype=torch.float32).contiguous()


SeedLike = Union[int, torch.Tensor]
# the dtypes of a seed word: the low 32 bits of its element are the seed
_SEED_DTYPES = tuple(getattr(torch, n) for n in ("int64", "int32", "uint32") if hasattr(torch, n))


def seed_word(seed: Optional[SeedLike], device: torch.device) -> torch.Tensor:
    """The dropout seed as the device word the kernels read (the TPU
    kernels' ``(1, 1)`` uint32 operand): a one-element int64, int32 or
    uint32 tensor on ``device`` (a view into a step's seed table) is used
    as it is, its low 32 bits being the seed; an int is copied to the
    device, one copy a call (for tests and single calls, not for a step)."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.device != device or seed.dtype not in _SEED_DTYPES:
            raise ValueError(f"a dropout seed tensor must be one int64/int32/uint32 element on "
                             f"{device}, got {seed.dtype} {tuple(seed.shape)} on {seed.device}")
        return seed
    return torch.tensor([0 if seed is None else int(seed) & 0xFFFFFFFF], dtype=torch.int64,
                        device=device)


def _dropout_args(rate: float, seed: Optional[SeedLike], device: torch.device,
                  row_offset: int, head_stride: int):
    """(the kernels' dropout arguments, the seed word they point at, to be
    kept alive over the launch). The hash row of row (b, h) is
    ``row_offset + b * head_stride + h`` (launch arguments: a captured graph
    keeps them, as a shard's offsets stay the same from step to step)."""
    rows = (int(row_offset) & 0xFFFFFFFF, int(head_stride))
    if rate <= 0:
        return (0, None, keep_threshold(rate), keep_scale(rate), *rows), None
    word = seed_word(seed, device)
    return (1, word.data_ptr(), keep_threshold(rate), keep_scale(rate), *rows), word


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    eff_scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[SeedLike] = 0,
    row_offset: int = 0,
    head_stride: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: returns ``(out (b, lq, h*d), lse (b, h, lq))``.

    q: (b, h, lq, d); k, v: (b, h, lkv, d), any strides with a unit stride
    on d (the column slices of the merged KV buffer are taken as they are);
    kv_mask: optional (b, lkv), True/1 = attend; eff_scale = scale / T;
    dropout_seed: the hash seed, which every kernel reads from device
    memory once a block (:func:`seed_word`); ``row_offset`` and
    ``head_stride`` (0: ``h``) place a shard's rows at their hash rows
    ``row_offset + b * head_stride + h`` (:func:`~healnet_tpu_torch.ops.
    hash_dropout.hash_rows`).
    The route is :func:`flash_variant`'s: bf16 with d <= 128 launches the
    tensor-core kernel (counted in ``launches``), other heads up to 256 the
    FMA kernel (``launches_fma``), heads of 257-512 the one-pass wide kernel
    (``launches_wide_fma`` in f32, ``launches_wide_tc`` in bf16), wider ones
    the panel kernels (``launches_panel_fma`` / ``launches_panel_tc``; past
    one pass of panels with a (b*h, lq, lkv) f32 scratch of the scores).
    Each is one launch.
    """
    _check_qkv(q, k, v)
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    variant = flash_variant(q.dtype, d)
    wide = variant in ("wide", "panels")
    lib = _wide_lib() if wide else _lib()
    bf = int(q.dtype == torch.bfloat16)
    mask = _float_mask(kv_mask, b, lkv, q.device)
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    mask_ptr = None if mask is None else mask.data_ptr()
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               0 if mask is None else mask.stride(0))
    drop, _word = _dropout_args(float(dropout_rate), dropout_seed, q.device, row_offset,
                                head_stride or h)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant == "tc":
            cluster, per = _plan(lambda c: lib.healnet_flash_tc_max_clusters(d, c),
                                 ("fwd", q.device.index, -(-d // 16)), b * h, lkv, q.device)
            code = lib.healnet_flash_forward_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
                lse.data_ptr(), b, h, lq, lkv, d, cluster, per, *strides, float(eff_scale),
                *drop, stream,
            )
        elif variant == "fma":
            cluster, per = _plan(lambda c: lib.healnet_flash_fma_max_clusters(d, bf, c),
                                 ("fwd_fma", q.device.index, d, bf), b * h, lkv, q.device,
                                 _FMA_TILE)
            code = lib.healnet_flash_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
                lse.data_ptr(), b, h, lq, lkv, d, cluster, per, *strides, float(eff_scale),
                *drop, bf, stream,
            )
        else:
            pan = flash_panels(q.dtype, d)
            scores = (torch.empty((b * h, lq, lkv), dtype=torch.float32, device=q.device)
                      if pan.passes > 1 else None)
            cluster, per = _plan(
                lambda c: lib.healnet_flash_wide_fwd_max_clusters(d, bf, c, pan.count, pan.passes),
                (f"fwd_{variant}", q.device.index, d, bf), b * h, lkv, q.device,
                key_tile(q.dtype, d), _sizes(variant, pan.count), pan.count)
            code = lib.healnet_flash_wide_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
                lse.data_ptr(), None if scores is None else scores.data_ptr(), b, h, lq, lkv, d,
                cluster, per, pan.count, pan.passes, *strides, float(eff_scale), *drop, bf,
                stream,
            )
        _count(flash_attention_kernel, q.dtype, d)
    cuda_build.check(lib, code, "flash_attention_kernel")
    return out.reshape(b, lq, h * d), lse


# the wrappers' launch counters, one a kernel
LAUNCH_COUNTERS = ("launches", "launches_fma", "launches_wide_fma", "launches_wide_tc",
                   "launches_panel_fma", "launches_panel_tc")


def launch_counter(dtype: torch.dtype, d: int) -> str:
    """The wrappers' counter of the kernel a call takes: ``launches`` (the
    tensor-core kernel), ``launches_fma``, ``launches_wide_fma`` (the wide
    route in f32), ``launches_wide_tc`` (in bf16), ``launches_panel_fma``
    or ``launches_panel_tc`` (the panel route)."""
    variant = flash_variant(dtype, d)
    if variant in ("wide", "panels"):
        kind = "tc" if dtype == torch.bfloat16 else "fma"
        return f"launches_{'wide' if variant == 'wide' else 'panel'}_{kind}"
    return {"tc": "launches", "fma": "launches_fma"}[variant]


def _count(wrapper, dtype: torch.dtype, d: int) -> None:
    name = launch_counter(dtype, d)
    setattr(wrapper, name, getattr(wrapper, name) + 1)


for _name in LAUNCH_COUNTERS:
    setattr(flash_attention_kernel, _name, 0)


def flash_attention_bwd_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    eff_scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[SeedLike] = 0,
    row_offset: int = 0,
    head_stride: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: returns ``(dq, dk, dv)``, contiguous
    ``(b, h, lq, d)`` / ``(b, h, lkv, d)`` in q's dtype.

    q, k, v, kv_mask, eff_scale and the dropout arguments as for the
    forward; do: (b, h, lq, d) in q's dtype, any strides with a unit stride
    on d; lse, delta: (b, h, lq) f32 (the forward's log-sum-exp and
    rowsum(dO * O)). The route and its counter as for the forward (past one
    pass of panels with a (2, b*h, lq, lkv) f32 scratch of s and dp). Every
    route walks the queries in :func:`query_chunks` of what a block holds;
    with more than one chunk, dk and dv are carried over the chunks in an
    f32 scratch buffer (each element by one thread, in chunk order).
    """
    _check_qkv(q, k, v, extra=(("do", do),))
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    if tuple(do.shape) != (b, h, lq, d):
        raise ValueError(f"do must be {(b, h, lq, d)}, got {tuple(do.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (b, h, lq) or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"{name} must be {(b, h, lq)} f32 on {q.device}")
    lse, delta = lse.contiguous(), delta.contiguous()
    variant = flash_variant(q.dtype, d)
    tc, wide = variant == "tc", variant in ("wide", "panels")
    bf = int(q.dtype == torch.bfloat16)
    lib = _wide_lib() if wide else _bwd_lib()
    if wide:  # bf16 pads a chunk to m16 query tiles
        pan = flash_panels(q.dtype, d, backward=True)
        max_rows = _max_queries(lib, "healnet_flash_wide_bwd_max_queries", d, bf, pan.count,
                                pan.passes)
        align = 16 if bf else 1
    else:
        max_rows = _max_queries(
            lib, "healnet_flash_bwd_tc_max_queries" if tc else "healnet_flash_bwd_max_queries", d)
        align = _TC_QGROUP if tc else 1
    n_chunks, chunk = query_chunks(lq, max_rows, align)
    mask = _float_mask(kv_mask, b, lkv, q.device)
    dq = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h, lkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, h, lkv, d), dtype=q.dtype, device=q.device)
    # dk and dv carried over the query chunks in f32 (the tensor-core kernel
    # at the head dim padded to 16)
    pitch = -(-d // 16) * 16 if tc else d
    carry = (torch.empty((2, b * h, lkv, pitch), dtype=torch.float32, device=q.device)
             if n_chunks > 1 else None)
    carry_ptr = None if carry is None else carry.data_ptr()
    mask_ptr = None if mask is None else mask.data_ptr()
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
               0 if mask is None else mask.stride(0))
    drop, _word = _dropout_args(float(dropout_rate), dropout_seed, q.device, row_offset,
                                head_stride or h)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), carry_ptr)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tc:
            cluster, per = _plan(
                lambda c: lib.healnet_flash_bwd_tc_max_clusters(chunk, d, c),
                ("bwd", q.device.index, -(-d // 16), chunk // _TC_QGROUP), b * h, lkv, q.device)
            code = lib.healnet_flash_backward_tc(
                *ptrs, b, h, lq, lkv, d, cluster, per, chunk, n_chunks, *strides,
                float(eff_scale), *drop, stream,
            )
        elif not wide:
            cluster, per = _plan(
                lambda c: lib.healnet_flash_bwd_fma_max_clusters(chunk, d, bf, c),
                ("bwd_fma", q.device.index, d, bf, chunk), b * h, lkv, q.device, _FMA_TILE)
            code = lib.healnet_flash_backward(
                *ptrs, b, h, lq, lkv, d, cluster, per, chunk, n_chunks, *strides,
                float(eff_scale), *drop, bf, stream,
            )
        else:  # past one pass of panels: a (2, b*h, lq, lkv) f32 scratch of s and dp
            scores = (torch.empty((2, b * h, lq, lkv), dtype=torch.float32, device=q.device)
                      if pan.passes > 1 else None)
            cluster, per = _plan(
                lambda c: lib.healnet_flash_wide_bwd_max_clusters(chunk, d, bf, c, pan.count,
                                                                  pan.passes),
                (f"bwd_{variant}", q.device.index, d, bf, chunk), b * h, lkv, q.device,
                key_tile(q.dtype, d), _sizes(variant, pan.count), pan.count)
            code = lib.healnet_flash_wide_backward(
                *ptrs, None if scores is None else scores.data_ptr(), b, h, lq, lkv, d, cluster,
                per, chunk, n_chunks, pan.count, pan.passes, *strides, float(eff_scale), *drop,
                bf, stream,
            )
        _count(flash_attention_bwd_kernel, q.dtype, d)
    cuda_build.check(lib, code, "flash_attention_bwd_kernel")
    return dq, dk, dv


for _name in LAUNCH_COUNTERS:
    setattr(flash_attention_bwd_kernel, _name, 0)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in f64 where it is f64 (a reference in f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _scores(q, k, kv_mask, eff_scale):
    """The kernels' scores in f32 (f64 for f64 inputs): ``q k^T * scale``
    with masked keys at -1e30, and the mask in that dtype ((b, 1, 1, lkv),
    ones without a mask)."""
    b, _, _, _ = q.shape
    lkv = k.shape[2]
    q, k = _wide(q), _wide(k)
    s = torch.einsum("bhid,bhjd->bhij", q, k) * eff_scale
    mask = torch.ones((b, lkv), dtype=q.dtype, device=q.device) if kv_mask is None \
        else kv_mask.to(q.dtype)
    mask = mask[:, None, None, :]
    return s + (mask - 1.0) * -_NEG_BIG, mask


def flash_lse_plain(q, k, kv_mask, eff_scale) -> torch.Tensor:
    """The forward kernel's log-sum-exp ``(b, h, lq)``: ``m + log(max(l,
    1e-30))`` over the masked scores (about -1e30 for a fully masked row)."""
    s, mask = _scores(q, k, kv_mask, eff_scale)
    m = torch.amax(s, dim=-1)
    l = torch.sum(torch.exp(s - m[..., None]) * mask, dim=-1)
    return m + torch.log(torch.clamp(l, min=1e-30))


def flash_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    eff_scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: SeedLike = 0,
    row_offset: int = 0,
    head_stride: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel, with materialised
    probabilities (the formulas of the JAX package's ``_bwd_kernel``):

        p   = exp(s - lse) * mask,   e = keep * f32(1 / (1 - rate))
        dv  = round_do(p * e)^T dO
        ds  = round_q(p * (e * (V dO^T)^T - delta))
        dk  = ds^T q * scale,  dq = ds k * scale

    Shapes as :func:`flash_attention_bwd_kernel`; returns dq, dk, dv in q's
    dtype. Sums run in f32, or in f64 for f64 inputs (a reference for the
    f32 kernels). ``dropout_seed`` may be an int or a one-element tensor on
    q's device: the same mask either way.
    """
    b, h, lq, _ = q.shape
    lkv = k.shape[2]
    s, mask = _scores(q, k, kv_mask, eff_scale)
    p = torch.exp(s - lse[..., None]) * mask
    rate = float(dropout_rate)
    if rate > 0:
        keep = dense_keep_mask(dropout_seed, b * h, lq, lkv, rate, device=q.device,
                               row_offset=row_offset, heads=h, head_stride=head_stride)
        e = keep.reshape(b, h, lq, lkv).to(p.dtype) * keep_scale(rate)
    else:
        e = torch.ones((), dtype=p.dtype, device=q.device)
    dof = _wide(do)
    p_drop = _wide((p * e).to(do.dtype))
    dv = torch.einsum("bhij,bhid->bhjd", p_drop, dof)
    dp = torch.einsum("bhid,bhjd->bhij", dof, _wide(v)) * e
    ds = _wide((p * (dp - delta[..., None])).to(q.dtype))
    dk = torch.einsum("bhij,bhid->bhjd", ds, _wide(q)) * eff_scale
    dq = torch.einsum("bhij,bhjd->bhid", ds, _wide(k)) * eff_scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@torch.library.custom_op("healnet_port::flash_attention_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    eff_scale: float,
    rate: float,
    seed: Optional[torch.Tensor],
    row_offset: int = 0,
    head_stride: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward as a registered op: ``(out (b, lq, h*d), lse (b,
    h, lq))`` as :func:`flash_attention_kernel` returns them, ``seed`` the
    one-element seed word (:func:`seed_word`; None for seed 0),
    ``row_offset`` / ``head_stride`` the hash rows of a shard (0 and 0 for
    a whole batch: the schema's defaults, which programs exported without
    them take). On CUDA
    tensors it launches the kernel; on CPU tensors it is the plain version
    (:func:`multihead_attention` with :func:`flash_lse_plain`). Its fake
    implementation gives the outputs' shapes to ``torch.export``."""
    seed = seed_word(seed, q.device) if rate > 0 else None
    # multihead_attention's scale / temperature is eff_scale
    out, _ = multihead_attention(q, k, v, scale=eff_scale, temperature=1.0, kv_mask=kv_mask,
                                 dropout_rate=rate, dropout_seed=seed, row_offset=row_offset,
                                 head_stride=head_stride)
    return out.contiguous(), flash_lse_plain(q, k, kv_mask, eff_scale).contiguous()


@flash_fwd_op.register_kernel("cuda")
def _flash_fwd_op_cuda(q, k, v, kv_mask, eff_scale, rate, seed, row_offset=0, head_stride=0):
    return flash_attention_kernel(q, k, v, kv_mask, eff_scale, rate, seed, row_offset,
                                  head_stride)


@flash_fwd_op.register_fake
def _flash_fwd_op_fake(q, k, v, kv_mask, eff_scale, rate, seed, row_offset=0, head_stride=0):
    b, h, lq, d = q.shape
    lse = q.new_empty((b, h, lq), dtype=torch.promote_types(q.dtype, torch.float32))
    return q.new_empty((b, lq, h * d)), lse


class FlashAttentionFunction(torch.autograd.Function):
    """Flash cross-attention with its backward, for autograd.

    ``apply(q, k, v, kv_mask, eff_scale, rate, seed[, row_offset,
    head_stride])`` -> (b, lq, h * d); ``seed`` an int or a one-element
    tensor on q's device (the kernels read it there, so a captured step
    replays with the seed its table holds at the time); ``row_offset`` and
    ``head_stride`` the hash rows of a shard (:func:`flash_attention_kernel`).
    The forward is :func:`flash_fwd_op`: CUDA tensors launch the forward
    and backward kernels; CPU tensors take the plain
    versions (:func:`multihead_attention` with
    :func:`flash_lse_plain`, and :func:`flash_backward_plain`), which the
    tests use to check the backward's formulas. The residuals are q, k, v,
    the mask, the output and the log-sum-exp; the backward computes
    ``delta = rowsum(dO * O)`` in f32 before its kernel, as the JAX package
    does outside its backward kernel.
    """

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, eff_scale, rate, seed, row_offset=0, head_stride=0):
        word = seed_word(seed, q.device) if rate > 0 else None
        out, lse = flash_fwd_op(q, k, v, kv_mask, float(eff_scale), float(rate), word,
                                int(row_offset), int(head_stride))
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.eff_scale, ctx.rate, ctx.seed = eff_scale, rate, seed
        ctx.rows = (int(row_offset), int(head_stride))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        b, h, lq, d = q.shape
        # (b, lq, h * d) -> (b, h, lq, d), a view of the contiguous cotangent
        g = g.contiguous().to(q.dtype)
        do = g.reshape(b, lq, h, d).transpose(1, 2)
        delta = torch.sum(
            g.float().reshape(b, lq, h, d) * out.float().reshape(b, lq, h, d), dim=-1
        ).transpose(1, 2)
        bwd = flash_attention_bwd_kernel if q.is_cuda else flash_backward_plain
        dq, dk, dv = bwd(q, k, v, kv_mask, do, lse, delta, ctx.eff_scale, ctx.rate, ctx.seed,
                         *ctx.rows)
        return dq, dk, dv, None, None, None, None, None, None


def flash_cross_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    temperature: float = 0.5,
    kv_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[SeedLike] = None,
    row_offset: int = 0,
    head_stride: int = 0,
) -> torch.Tensor:
    """Fused cross-attention: q (b, h, lq, d), k/v (b, h, lkv, d) ->
    (b, lq, h * d). CUDA tensors go through :class:`FlashAttentionFunction`
    (the kernels, forward and backward); CPU tensors take the plain version,
    whose autograd gradient is the same function. ``dropout_seed`` is the
    raw 32-bit hash seed, required when ``dropout_rate > 0``: an int, or a
    one-element tensor on q's device (a training step's seeds, never read
    on the host); an int is copied to the card once for both kernels.
    ``row_offset`` / ``head_stride`` (0: ``h``) give a shard's rows their
    global hash rows, so a sharded batch drops what the whole one does."""
    dropout_rate = float(dropout_rate)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not q.is_cuda:
        out, _ = multihead_attention(
            q, k, v, scale=scale, temperature=temperature, kv_mask=kv_mask,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed, row_offset=row_offset,
            head_stride=head_stride,
        )
        return out
    seed = seed_word(dropout_seed, q.device) if dropout_rate > 0.0 else None
    return FlashAttentionFunction.apply(
        q, k, v, kv_mask, float(scale) / float(temperature), dropout_rate, seed, row_offset,
        head_stride)
