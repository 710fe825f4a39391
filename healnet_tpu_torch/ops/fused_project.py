"""Fused merged-KV projection with folded LayerNorm, forward and backward.

Counterpart of ``healnet_tpu/ops/fused_project.py``. The model projects every
fusion layer's KV from the raw context in one merged product with each
layer's context-LayerNorm affine folded into the weights:

    x_hat @ W = (1/sigma) (ctx @ W_c + enc @ W_e - mu * colsum(W)) + beta @ W

so the normalization applies on the (tokens x F) output, never on the
context itself. :func:`project_plain` is the two-pass PyTorch version (the
math of the JAX package's ``_xla_project``); :func:`fused_project_kernel`
launches a CUDA kernel that reads the context once for the statistics, the
product and the normalization: the Hopper kernel (``csrc/fused_project_tma.cu``:
TMA ring, wgmma, persistent warp-specialised blocks) for every bf16-compute
call, its rows as they are where TMA can describe them, else (the generic
route) as 16-byte hulls it realigns, or, for a generic call of few rows,
the split kernel (``csrc/fused_project.cu``: the channels over a cluster),
and the f32 kernel (``csrc/fused_project_f32.cu``: f32 FMA from a cp.async
ring) for every f32-compute call, by :func:`project_route` and
:func:`project_generic_plan`.
:class:`FusedProjectFunction` gives it a backward whose cotangent pass is a
second kernel (``csrc/fused_project_bwd.cu``, plain version
:func:`project_bwd_plain`). Its forward is the registered op
``healnet_port::fused_kv_project`` (:func:`project_op`), which
``torch.export`` keeps in a traced program.

Quantized contexts (:class:`healnet_tpu_torch.ops.quantize.QuantizedContext`):
int8 values with one f32 scale per token. The statistics and the product
commute with the per-token rescale, so both run on the int8 values and the
scale applies to the (tokens x F) accumulator; the output is in the compute
dtype (``out_dtype``, float32 unless given).

Rounding contract, identical in both versions: the product accumulates in
f32 and is rounded to the compute dtype (for an int8 context, widened to
f32, multiplied by the scale and rounded again), the encoding projection is
added in the compute dtype, and the sum is widened to f32 before the
normalization. The statistics are f32 sums of the stored context values.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.quantize import QuantizedContext

_IMPLS = ("auto", "xla", "kernel", "pallas")
# int8 rows: the kernel's per-thread integer sums of q^2 (|q| <= 127) stay
# below 2^31 for rows of up to this many channels
_MAX_INT8_CHANNELS = (2**31 - 1) // (127 * 127)

# the Hopper kernel (csrc/fused_project_tma.cu): output columns per pass it
# is built for (one wgmma N-tile of up to 256, or two of 136: at 272 its
# accumulators take 136 of the 168 registers ptxas gives a thread), rows per
# tile and channels per k-step
PROJECT_WIDTHS = (64, 128, 256, 272)
_TILE_ROWS = 128
_TILE_K = 64
_MAX_SMEM = 232448  # dynamic shared memory a block may use on Hopper
# the generic route's rows at any byte offset: bytes of a row's staged
# 16-byte hull per 64-channel k-step (bf16, int8)
HULL_BYTES = {2: _TILE_K * 2 + 16, 1: _TILE_K + 16}

# the split kernel (csrc/fused_project.cu): generic calls of at most this
# many rows take it, more take the Hopper kernel's hull kinds (the omic
# vector of a batch of 8 has 8; the crossover measured on the card, PERF.md
# section 6); rows and columns a block, blocks of a cluster at most, and its
# static shared memory (``Smem``): 8 rows' hulls of 4 bf16 k-slices and 32
# bytes, those rows widened to f32, the 4 parts' and the block's sums of its
# 8 x 64 outputs, and the rows' sums
SPLIT_MAX_ROWS = 128
_SPLIT_ROWS = 8
_SPLIT_COLS = 64
_SPLIT_CLUSTER = 16
SPLIT_SMEM = (_SPLIT_ROWS * (4 * _TILE_K * 2 + 32) + _SPLIT_ROWS * 4 * _TILE_K * 4
              + 5 * _SPLIT_ROWS * _SPLIT_COLS * 4 + _SPLIT_ROWS * 2 * 4)


# the f32 kernel (csrc/fused_project_f32.cu): output columns per pass it is
# built for (an 8 x 16 register microtile a thread, 8 x 17 at 272), rows per
# block, channels per k-step and ring stages (f32 context; int8 context)
F32_WIDTHS = (64, 128, 256, 272)
_F32_ROWS = 128
_F32_K = 32
_F32_STAGES = {4: 3, 1: 4}


def project_route(dtype: torch.dtype, cdt: torch.dtype, c: int, data_ptr: int) -> str:
    """Which projection kernel a CUDA call takes: ``"f32"`` (the f32
    kernel) for f32 compute, over an f32 or int8 context; ``"tma"`` (the
    Hopper kernel) for a bf16 or int8 context computed in bf16 whose rows TMA
    can describe (a 16-byte aligned base and a row pitch ``c * itemsize``
    that is a multiple of 16 bytes: C = 2000, 2048, 1024 in either type);
    else ``"generic"`` (bf16 compute over rows at any byte offset, such as
    C = 4095, 2001, 203, 3 or a misaligned view: the Hopper kernel's hull
    kinds or the split kernel, by :func:`project_generic_plan`)."""
    if cdt == torch.float32:
        return "f32"
    itemsize = {torch.bfloat16: 2, torch.int8: 1}.get(dtype)
    if cdt != torch.bfloat16 or itemsize is None or c < 1:
        return "generic"
    return "tma" if (c * itemsize) % 16 == 0 and data_ptr % 16 == 0 else "generic"


class ProjectPlan(NamedTuple):
    """A launch of the Hopper kernel (see :func:`project_plan`)."""

    nb: int          # output columns per pass, the kernel's N (a PROJECT_WIDTHS entry)
    n_col: int       # column passes; each reads the context once
    row_tiles: int
    pitch: int       # elements per staged output row (even)
    stages: int      # ring stages
    held_staging: bool  # the epilogue stages its rows in a spent ring stage
    smem: int        # dynamic shared memory per block, bytes


def project_smem(nb: int, itemsize: int, stages: int, pitch: int,
                 held_staging: bool = False, hull: bool = False) -> int:
    """Bytes of shared memory a block takes (``Layout`` in
    ``csrc/fused_project_tma.cu``): the ring (context tile of 128 x 64
    channels, or with ``hull`` 128 staged hull rows of :data:`HULL_BYTES`;
    ``nb`` weight rows of 64 bf16 each); for an int8 context and the hull
    kinds two 8 KB bf16 tiles per consumer warpgroup, which they convert or
    realign into; for the hull kinds two tiles' row sums; 8 staged output
    rows a warp at ``pitch`` (none with ``held_staging``: a tile's epilogue
    then stages them in one of its spent ring stages); [colsum; bias]; the
    barriers; and 1024 bytes of alignment slack."""
    ctx = _TILE_ROWS * (HULL_BYTES[itemsize] if hull else _TILE_K * itemsize)
    stage = ctx + nb * _TILE_K * 2
    conv = 2 * 2 * 64 * _TILE_K * 2 if itemsize == 1 or hull else 0
    sums = 2 * _TILE_ROWS * 2 * 4 if hull else 0
    staged = 0 if held_staging else -(-(8 * 8 * pitch * 2) // 16) * 16
    return stages * stage + conv + sums + staged + 8 * nb + 16 * stages + 1024


def project_plan(m: int, f: int, itemsize: int, hull: bool = False) -> ProjectPlan:
    """The Hopper kernel's plan for ``m`` context rows of ``itemsize`` bytes
    per channel and ``f`` output columns, the rows as they are or (``hull``)
    staged as 16-byte hulls.

    Columns: as few passes as keep a pass within 272 columns (the most the
    consumers' registers hold), each ``nb`` wide, the narrowest width the
    kernel is built for. Rows: tiles of 128. Stages: as many (2 to 4) as
    shared memory holds with the staged output rows in a region of their
    own, or where that costs a stage, in a spent ring stage held until the
    tile's rows are out (holding a stage thins the next tile's prefetch:
    only worth a stage).
    """
    n_col = -(-f // PROJECT_WIDTHS[-1])
    nb = next(w for w in PROJECT_WIDTHS if w >= -(-f // n_col))
    pitch = f + f % 2 if n_col == 1 else nb  # even: the epilogue works on pairs
    for stages in (4, 3, 2):
        for held in (False, True):
            smem = project_smem(nb, itemsize, stages, pitch, held, hull)
            if smem <= _MAX_SMEM:
                return ProjectPlan(nb, n_col, -(-m // _TILE_ROWS), pitch, stages, held, smem)
    raise ValueError(f"no ring fits shared memory at nb={nb}")


def row_classes(c: int, itemsize: int) -> int:
    """Classes of rows at one offset mod 16 bytes: rows r and r + P of a
    pitch of ``c * itemsize`` bytes, P = 16 / gcd(pitch, 16) (8 for a bf16
    row of odd C, 1 for a 16-byte pitch)."""
    return 16 // math.gcd(c * itemsize, 16)


class GenericPlan(NamedTuple):
    """A launch of the generic route (see :func:`project_generic_plan`)."""

    path: str        # "rows": the Hopper kernel's hull kinds; "split": the split kernel
    classes: int     # rows: row classes of one offset (one TMA map each)
    rows: Optional[ProjectPlan]  # rows: the Hopper kernel's plan with hull rows
    cluster: int     # split: blocks over the channels (one cluster)
    slices: int      # split: 64-channel k-slices a block takes
    col_groups: int  # split: blocks of 64 columns
    row_groups: int  # split: blocks of 8 rows
    smem: int        # shared memory per block, bytes

    @property
    def counter(self) -> str:
        """The launch counter of the kernel this plan runs."""
        return "launches_generic" if self.path == "rows" else "launches_generic_split"


def project_generic_plan(m: int, c: int, f: int, itemsize: int) -> GenericPlan:
    """The generic route's plan for ``m`` rows of ``c`` channels of
    ``itemsize`` bytes (2: bf16, 1: int8) at any byte offset and ``f``
    output columns.

    More than :data:`SPLIT_MAX_ROWS` rows take the Hopper kernel's pipe with
    hull rows (:func:`project_plan` with ``hull``; one TMA map per row class,
    :func:`row_classes`). Fewer take the split kernel: the ``ceil(c / 64)``
    k-slices over a cluster of at most 16 blocks (``slices`` a block, as few
    as keep the cluster within 16, then as few blocks as that needs), F over
    blocks of 64 columns and the rows over blocks of 8 (the omic vector
    (8, 1, 2001) -> 252: clusters of 16 blocks of 2 slices, 4 column blocks).
    """
    if itemsize not in HULL_BYTES:
        raise ValueError(f"the generic route takes bf16 or int8 rows, got itemsize {itemsize}")
    classes = row_classes(c, itemsize)
    if m > SPLIT_MAX_ROWS:
        rows = project_plan(m, f, itemsize, hull=True)
        return GenericPlan("rows", classes, rows, 0, 0, 0, 0, rows.smem)
    nk = -(-c // _TILE_K)
    slices = -(-nk // _SPLIT_CLUSTER)
    return GenericPlan("split", classes, None, -(-nk // slices), slices,
                       -(-f // _SPLIT_COLS), -(-m // _SPLIT_ROWS), SPLIT_SMEM)


class F32Plan(NamedTuple):
    """A launch of the f32 kernel (see :func:`project_f32_plan`)."""

    nb: int          # output columns per pass (an F32_WIDTHS entry)
    n_col: int       # column passes (the grid's y axis); each reads the context once
    row_tiles: int   # blocks per pass, 128 rows each
    nk: int          # k-steps of 32 channels (the weights are padded to nk * 32 rows)
    stages: int      # ring stages
    smem: int        # dynamic shared memory per block, bytes


def project_f32_smem(nb: int, itemsize: int) -> int:
    """Bytes of dynamic shared memory a block of the f32 kernel takes
    (``Layout`` in ``csrc/fused_project_f32.cu``): per ring stage a context
    tile of 128 rows x 32 channels (f32 rows padded to 36 floats, int8 rows
    to 48 bytes) and 32 x ``nb`` f32 weights, 3 stages for f32 and 4 for
    int8; and two channel-major f32 tiles of 32 x 128 the products read,
    staged one k-step ahead."""
    pitch = _F32_K + 4 if itemsize == 4 else _F32_K + 16
    stage = _F32_ROWS * pitch * itemsize + _F32_K * nb * 4
    return _F32_STAGES[itemsize] * stage + 2 * _F32_K * _F32_ROWS * 4


def project_f32_plan(m: int, c: int, f: int, itemsize: int, sms: int = 132) -> F32Plan:
    """The f32 kernel's plan for ``m`` context rows of ``c`` channels of
    ``itemsize`` bytes (4: f32, 1: int8) and ``f`` output columns on a card
    of ``sms`` SMs.

    Columns: the pass width ``nb`` (an ``F32_WIDTHS`` entry, ceil(F / nb)
    passes) whose blocks finish soonest, one block an SM: a block's time
    grows with ``nb``, so the cost is waves x ``nb``, ties going to the
    wider (fewer passes, fewer reads of the context). brca's and kirp's bag
    (256 row tiles) take one pass of 256 or 272; the omic vector (one row
    tile) four of 64, which spreads it over four SMs (:func:`project_f32_smem`
    gives the shared memory).
    """
    if itemsize not in _F32_STAGES:
        raise ValueError(f"the f32 kernel takes f32 or int8 contexts, got itemsize {itemsize}")
    row_tiles = -(-m // _F32_ROWS)
    nb = min(reversed(F32_WIDTHS), key=lambda w: -(-row_tiles * -(-f // w) // sms) * w)
    return F32Plan(nb, -(-f // nb), row_tiles, -(-c // _F32_K), _F32_STAGES[itemsize],
                   project_f32_smem(nb, itemsize))


# the backward kernel (csrc/fused_project_bwd.cu): threads per block and
# blocks per first-level group of its column sums
_BWD_THREADS = 512
_BWD_GROUP = 16


class BwdPlan(NamedTuple):
    """A launch of the backward kernel (see :func:`project_bwd_plan`)."""

    vec: int      # columns per thread's vector access
    w: int        # threads a token row of a block spans (a multiple of 32)
    tokens: int   # tokens per tile (token rows x tokens a thread)
    grid_x: int   # blocks over the token tiles, per column chunk
    grid_y: int   # column chunks of w vectors
    groups: int   # first-level groups of the column sums


def project_bwd_plan(b: int, t: int, f: int, itemsize: int, data_ptr: int, sms: int) -> BwdPlan:
    """The backward kernel's plan for a (b, t, f) cotangent of ``itemsize``
    bytes at ``data_ptr`` on a card of ``sms`` SMs.

    Vectors: the widest access of up to 4 columns whose column count
    divides F and whose size divides the base's alignment (brca's F 252: 4
    columns, 8 bytes of bf16, 16 of f32; kirp's 270: 2). A block's 512
    threads span a token row with ``w`` threads (F / vec rounded up to a
    warp, at most 512; wider rows take column chunks on the grid's y axis)
    and hold 512 // w token rows, each thread 1, 2 or 4 tokens of a tile
    (16-byte, 8-byte and narrower vectors). One block an SM, at most one
    per tile; groups of 16 blocks.
    """
    vec = next(v for v in (4, 2, 1) if f % v == 0 and data_ptr % (v * itemsize) == 0)
    nvec = f // vec
    w = min(_BWD_THREADS, -(-nvec // 32) * 32)
    grid_y = -(-nvec // w)
    vec_bytes = vec * itemsize
    tokens = (_BWD_THREADS // w) * (1 if vec_bytes >= 16 else 2 if vec_bytes >= 8 else 4)
    grid_x = max(1, min(-(-t // tokens), sms // grid_y))
    return BwdPlan(vec, w, tokens, grid_x, grid_y, -(-grid_x // _BWD_GROUP) * grid_y)


def _row_stats(dat, enc, scale=None):
    """f32 row sums and sums of squares of the stored context values, scaled
    for an int8 context, the encoding's added on: ``(s1, s2)``, each (b, t)."""
    xf = dat.float()
    s1 = torch.sum(xf, dim=-1)
    s2 = torch.sum(xf * xf, dim=-1)
    if scale is not None:
        s1 = scale * s1
        s2 = (scale * scale) * s2
    if enc is not None:
        ef = enc.float()
        s1 = s1 + torch.sum(ef, dim=-1)
        s2 = s2 + torch.sum(ef * ef, dim=-1)
    return s1, s2


def _mu_inv(s1, s2, d_total, eps):
    mu = s1 / d_total
    return mu, torch.rsqrt(s2 / d_total - mu * mu + eps)


def _project_plain(dat, enc, w_all, b_all, eps, scale=None, cdt=None):
    """``(kv, s1, s2)`` of the plain version, as the kernel returns them;
    ``cdt`` is the compute and output dtype (default: dat's)."""
    cdt = dat.dtype if cdt is None else cdt
    c_dim = dat.shape[-1]
    s1, s2 = _row_stats(dat, enc, scale)
    mu, inv = _mu_inv(s1, s2, w_all.shape[0], eps)
    colsum = torch.sum(w_all, dim=0)
    raw = dat.to(cdt) @ w_all[:c_dim].to(cdt)
    if scale is not None:
        raw = (raw.float() * scale[..., None]).to(cdt)
    if enc is not None:
        raw = raw + enc.to(cdt) @ w_all[c_dim:].to(cdt)
    kv = inv[..., None] * (raw.float() - mu[..., None] * colsum) + b_all
    return kv.to(cdt), s1, s2


def project_plain(
    dat: torch.Tensor,
    enc: Optional[torch.Tensor],
    w_all: torch.Tensor,
    b_all: torch.Tensor,
    eps: float = 1e-5,
    scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version: a statistics pass plus a matmul pass.

    dat: (b, t, C), or int8 values with ``scale`` (b, t) f32; enc: optional
    (t, E) shared across the batch; w_all: (C + E, F) f32; b_all: (F,).
    Returns (b, t, F) in ``out_dtype`` (default: the context dtype), which is
    also the compute dtype.
    """
    return _project_plain(dat, enc, w_all, b_all, eps, scale, out_dtype)[0]


def project_bwd_plain(
    g: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    d_total: int,
    eps: float = 1e-5,
    scale: Optional[torch.Tensor] = None,
    with_bsum: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: the cotangent pass.

    g: (b, t, F) cotangent of the projection, in the compute dtype; s1, s2
    (and an int8 context's ``scale``): (b, t) f32. Returns ``d_raw =
    round((scale *) inv * g)`` (b, t, F) in g's dtype, with the scale and
    inv multiplied first, and ``dsum2 = [sum g; sum inv * mu * g]`` (2, F)
    f32, which are ``[d_bias; -d_colsum]``; with ``with_bsum`` also ``bsum =
    sum_b round(inv * g)`` (t, F) f32, unscaled, for the encoding weights'
    gradient. That sum rounds each term to g's dtype first, as the JAX
    package's default backward (its ``_BWD_KERNEL = False`` path) does.
    """
    mu, inv = _mu_inv(s1, s2, d_total, eps)
    gf = g.float()
    factor = inv if scale is None else scale * inv
    d_raw = (factor[..., None] * gf).to(g.dtype)
    dsum2 = torch.stack([
        torch.sum(gf, dim=(0, 1)),
        torch.sum((inv * mu)[..., None] * gf, dim=(0, 1)),
    ])
    if not with_bsum:
        return d_raw, dsum2
    plain = d_raw if scale is None else (inv[..., None] * gf).to(g.dtype)
    return d_raw, dsum2, torch.sum(plain.float(), dim=0)


def _split_lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_project")
    fn = lib.healnet_fused_project_split
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 9 + [i] * 4 + [f, f] + [i] * 3 + [p]
        fn.restype = ctypes.c_int
        lib.healnet_fused_project_split_smem.argtypes = [i]
        lib.healnet_fused_project_split_smem.restype = ctypes.c_longlong
    return lib


def _f32_lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_project_f32")
    fn = lib.healnet_fused_project_f32
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 9 + [i] * 4 + [f, f] + [i] * 4 + [p]
        fn.restype = ctypes.c_int
        lib.healnet_fused_project_f32_smem.argtypes = [i, i]
        lib.healnet_fused_project_f32_smem.restype = i
    return lib


def _tma_lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_project_tma")
    fn = lib.healnet_fused_project_tma
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 9 + [i] * 4 + [f, f] + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        lib.healnet_fused_project_tma_max_blocks.argtypes = [i, i, i, ctypes.c_longlong]
        lib.healnet_fused_project_tma_max_blocks.restype = i
        lib.healnet_fused_project_tma_smem.argtypes = [i] * 6
        lib.healnet_fused_project_tma_smem.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: int, nb: int, quantized: bool, hull: bool, smem: int) -> int:
    """Blocks of the Hopper kernel the card holds at once (one per SM),
    cached per device and shape class; raises if the query fails."""
    with torch.cuda.device(device):
        n = _tma_lib().healnet_fused_project_tma_max_blocks(nb, int(quantized), int(hull), smem)
    if n < 1:
        raise RuntimeError(f"the occupancy query failed for nb={nb}, {smem} B")
    return n


def _check_operands(device, expect) -> None:
    for name, (x, shape, dtype) in expect.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(x.shape)} {x.dtype}"
            )
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def fused_project_kernel(
    dat: torch.Tensor,
    w_c: torch.Tensor,
    enc_proj: torch.Tensor,
    enc_stats: torch.Tensor,
    aux: torch.Tensor,
    d_total: int,
    eps: float,
    scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch a CUDA kernel: returns ``(kv, s1, s2)``.

    dat: (b, t, C) bf16 or f32, or int8 with ``scale`` (b, t) f32; w_c: the
    weights in the compute dtype (dat's, or bf16/f32 for an int8 context),
    laid out for the call's :func:`project_route` as :func:`_prep` lays them
    out: (ceil(C / 64), F, 64) k-slices on the ``"tma"`` and ``"generic"``
    routes, (n_col, ceil(C / 32) * 32, nb) column passes
    (:func:`project_f32_plan`) on the ``"f32"`` one; enc_proj: (t, F) in
    the compute dtype; enc_stats: (2, t) f32 [row sums; row sums of squares]
    of the encoding; aux: (2, F) f32 [colsum(W); folded bias]. All
    contiguous and on one CUDA device. kv: (b, t, F) in the compute dtype;
    s1, s2: (b, t) f32.

    Launches are counted per variant: ``launches`` (the Hopper kernel, bf16
    contexts), ``launches_int8`` (the Hopper kernel, int8 contexts),
    ``launches_f32`` (the f32 kernel, f32 contexts), ``launches_f32_int8``
    (the f32 kernel, int8 contexts); a generic call (bf16 or int8 rows at
    any byte offset, bf16 compute) is one launch of ``launches_generic``
    (the Hopper kernel's hull kinds) or ``launches_generic_split`` (the
    split kernel), as :func:`project_generic_plan` picks.
    """
    return _project_launch(dat, w_c, enc_proj, enc_stats, aux, d_total, eps, scale)


def _project_launch(dat, w_c, enc_proj, enc_stats, aux, d_total, eps, scale, route=None):
    """:func:`fused_project_kernel` on ``route``: :func:`project_route`'s by
    default, or ``"generic"`` for any bf16-compute call (its weights are laid
    out as the ``"tma"`` route's), so that ``chip_smoke.py`` can time the
    generic route on the Hopper kernel's inputs."""
    if not dat.is_cuda:
        raise ValueError("fused_project_kernel takes CUDA tensors")
    if dat.ndim != 3:
        raise ValueError(f"dat must be (b, t, C), got {tuple(dat.shape)}")
    b, t, c = dat.shape
    f = aux.shape[1] if aux.ndim == 2 else -1
    quantized = dat.dtype == torch.int8
    cdt = w_c.dtype
    if quantized:
        if cdt not in (torch.bfloat16, torch.float32):
            raise TypeError(f"an int8 context computes in bf16 or f32, got {cdt}")
        if scale is None:
            raise ValueError("an int8 context needs its per-token scale")
        if c > _MAX_INT8_CHANNELS:
            raise ValueError(f"int8 rows of {c} channels overflow the integer sums")
    else:
        if dat.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"fused_project_kernel takes bf16, f32 or int8, got {dat.dtype}")
        if scale is not None:
            raise ValueError("a scale goes with an int8 context only")
        cdt = dat.dtype
    if route is None:
        route = project_route(dat.dtype, cdt, c, dat.data_ptr())
    elif route != "generic" or cdt != torch.bfloat16:
        raise ValueError(f"a forced route is 'generic', for bf16 compute, got {route!r}")
    if route == "f32":
        plan32 = project_f32_plan(b * t, c, f, dat.element_size(), _sm_count(dat.device.index))
        w_shape = (plan32.n_col, plan32.nk * _F32_K, plan32.nb)
    else:
        w_shape = (-(-c // _TILE_K), f, _TILE_K)
    expect = {
        "w_c": (w_c, w_shape, cdt),
        "enc_proj": (enc_proj, (t, f), cdt),
        "enc_stats": (enc_stats, (2, t), torch.float32),
        "aux": (aux, (2, f), torch.float32),
    }
    if quantized:
        expect["scale"] = (scale, (b, t), torch.float32)
    _check_operands(dat.device, expect)
    if not dat.is_contiguous():
        raise ValueError("dat must be contiguous")
    if route == "generic" and dat.untyped_storage().data_ptr() % 16 != 0:
        # a hull starts up to 15 bytes before its row, never before the storage
        raise ValueError("the generic route takes a context whose storage starts on 16 bytes")
    kv = torch.empty((b, t, f), dtype=cdt, device=dat.device)
    s1 = torch.empty((b, t), dtype=torch.float32, device=dat.device)
    s2 = torch.empty((b, t), dtype=torch.float32, device=dat.device)
    if kv.numel() == 0:
        return kv, s1, s2
    scale_ptr = scale.data_ptr() if quantized else None
    with torch.cuda.device(dat.device):
        stream = torch.cuda.current_stream(dat.device).cuda_stream
        gplan = project_generic_plan(b * t, c, f, dat.element_size()) \
            if route == "generic" else None
        if route == "tma" or (gplan is not None and gplan.path == "rows"):
            hull = gplan is not None
            plan = gplan.rows if hull else project_plan(b * t, f, dat.element_size())
            resident = _resident_blocks(dat.device.index, plan.nb, quantized, hull, plan.smem)
            lib = _tma_lib()
            code = lib.healnet_fused_project_tma(
                dat.data_ptr(), w_c.data_ptr(), enc_proj.data_ptr(), enc_stats.data_ptr(),
                aux.data_ptr(), scale_ptr, kv.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                b * t, c, f, t, float(d_total), float(eps), int(quantized), plan.nb,
                plan.n_col, min(resident, plan.row_tiles * plan.n_col), plan.stages,
                plan.pitch, int(plan.held_staging), int(hull), stream,
            )
            counter = gplan.counter if hull else "launches_int8" if quantized else "launches"
        elif route == "f32":
            # 16-byte cp.async staging needs 16-byte rows and base (f32: C %
            # 4, int8: C % 16); other rows are staged element by element
            vec = int((c * dat.element_size()) % 16 == 0 and dat.data_ptr() % 16 == 0)
            lib = _f32_lib()
            code = lib.healnet_fused_project_f32(
                dat.data_ptr(), w_c.data_ptr(), enc_proj.data_ptr(), enc_stats.data_ptr(),
                aux.data_ptr(), scale_ptr, kv.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                b * t, c, f, t, float(d_total), float(eps), int(quantized), plan32.nb,
                plan32.n_col, vec, stream,
            )
            counter = "launches_f32_int8" if quantized else "launches_f32"
        else:
            lib = _split_lib()
            code = lib.healnet_fused_project_split(
                dat.data_ptr(), w_c.data_ptr(), enc_proj.data_ptr(), enc_stats.data_ptr(),
                aux.data_ptr(), scale_ptr, kv.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                b * t, c, f, t, float(d_total), float(eps), int(quantized), gplan.cluster,
                gplan.slices, stream,
            )
            counter = gplan.counter
    setattr(fused_project_kernel, counter, getattr(fused_project_kernel, counter) + 1)
    cuda_build.check(lib, code, "fused_project_kernel")
    return kv, s1, s2


fused_project_kernel.launches = 0
fused_project_kernel.launches_int8 = 0
fused_project_kernel.launches_f32 = 0
fused_project_kernel.launches_f32_int8 = 0
fused_project_kernel.launches_generic = 0
fused_project_kernel.launches_generic_split = 0


def _prep(dat, enc, w_all, b_all, cdt):
    """The kernel's small operands: weights in the compute dtype, laid out
    for the call's :func:`project_route` (for the Hopper kernel and the
    generic route (nk, F, 64): k-slices of 64 channels, zero past C, each
    K-major and contiguous; for the f32 kernel (n_col, nk * 32, nb): each
    column pass's weights, zero past C and F), the encoding projection and
    statistics, and [colsum; bias]."""
    b, t, c = dat.shape
    f = w_all.shape[1]
    w_c = w_all[:c].to(cdt)
    route = project_route(dat.dtype, cdt, c, dat.data_ptr()) if dat.is_cuda else None
    if route in ("tma", "generic"):
        nk = -(-c // _TILE_K)
        w_c = torch.nn.functional.pad(w_c, (0, 0, 0, nk * _TILE_K - c))
        w_c = w_c.reshape(nk, _TILE_K, f).transpose(1, 2)
    elif route == "f32":
        plan = project_f32_plan(b * t, c, f, dat.element_size(), _sm_count(dat.device.index))
        w_c = torch.nn.functional.pad(
            w_c, (0, plan.n_col * plan.nb - f, 0, plan.nk * _F32_K - c))
        w_c = w_c.reshape(plan.nk * _F32_K, plan.n_col, plan.nb).transpose(0, 1)
    w_c = w_c.contiguous()
    aux = torch.stack([torch.sum(w_all, dim=0), b_all]).float().contiguous()
    if enc is not None:
        enc_proj = (enc.to(cdt) @ w_all[c:].to(cdt)).contiguous()
        ef = enc.float()
        enc_stats = torch.stack([torch.sum(ef, dim=-1), torch.sum(ef * ef, dim=-1)])
    else:
        enc_proj = torch.zeros((t, f), dtype=cdt, device=dat.device)
        enc_stats = torch.zeros((2, t), dtype=torch.float32, device=dat.device)
    return w_c, enc_proj, enc_stats.contiguous(), aux


@torch.library.custom_op("healnet_port::fused_kv_project", mutates_args=(), device_types="cpu")
def project_op(
    dat: torch.Tensor,
    enc: Optional[torch.Tensor],
    w_all: torch.Tensor,
    b_all: torch.Tensor,
    eps: float,
    scale: Optional[torch.Tensor],
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The projection forward as a registered op, ``(kv, s1, s2)`` as
    :func:`fused_project_kernel` returns them: ``out_dtype`` is the compute
    dtype. On CUDA tensors it launches the kernel, its route and weight
    layout chosen from the context's address at the call (so a traced
    program decides them at run time, as an eager call does); on CPU
    tensors it is the plain version. Its fake implementation gives the
    outputs' shapes to ``torch.export``."""
    return _project_plain(dat.contiguous(), enc, w_all, b_all, eps,
                          None if scale is None else scale.contiguous(), out_dtype)


@project_op.register_kernel("cuda")
def _project_op_cuda(dat, enc, w_all, b_all, eps, scale, out_dtype):
    dat = dat.contiguous()
    return fused_project_kernel(
        dat, *_prep(dat, enc, w_all, b_all, out_dtype), w_all.shape[0], eps,
        scale=None if scale is None else scale.contiguous())


@project_op.register_fake
def _project_op_fake(dat, enc, w_all, b_all, eps, scale, out_dtype):
    b, t = dat.shape[0], dat.shape[1]
    s1 = dat.new_empty((b, t), dtype=torch.float32)
    return dat.new_empty((b, t, w_all.shape[1]), dtype=out_dtype), s1, torch.empty_like(s1)


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_project_bwd")
    fn = lib.healnet_fused_project_bwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 9 + [i] * 3 + [f, f] + [i] * 5 + [p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# (device, stream) -> the backward kernel's ticket counters, zeros between
# calls (the kernel's last blocks reset the ones they took), so a call
# launches nothing but the kernel; one buffer per stream, since two calls
# running at once must not share counters
_BWD_COUNTERS: dict = {}


def _bwd_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _BWD_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _BWD_COUNTERS[key] = buf
    return buf


def fused_project_bwd_kernel(
    g: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    d_total: int,
    eps: float = 1e-5,
    scale: Optional[torch.Tensor] = None,
    with_bsum: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Launch the backward (cotangent pass) kernel: returns ``(d_raw,
    dsum2)``, or ``(d_raw, dsum2, bsum)`` with ``with_bsum``, as
    :func:`project_bwd_plain` does, in one launch (sized by
    :func:`project_bwd_plan`) for any batch.

    g: (b, t, F) bf16 or f32, contiguous; s1, s2 and an int8 context's
    ``scale``: (b, t) f32, contiguous; all on one CUDA device. Launches are
    counted per variant: ``launches`` (no scale) and ``launches_int8``.
    """
    if not g.is_cuda:
        raise ValueError("fused_project_bwd_kernel takes CUDA tensors")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_project_bwd_kernel takes bf16 or f32, got {g.dtype}")
    if g.ndim != 3 or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous (b, t, F), got {tuple(g.shape)}")
    b, t, f = g.shape
    stats = {"s1": s1, "s2": s2} if scale is None else {"s1": s1, "s2": s2, "scale": scale}
    _check_operands(g.device, {k: (x, (b, t), torch.float32) for k, x in stats.items()})
    d_raw = torch.empty_like(g)
    dsum2 = torch.empty((2, f), dtype=torch.float32, device=g.device)
    bsum = torch.empty((t, f), dtype=torch.float32, device=g.device) if with_bsum else None
    outs = (d_raw, dsum2) if bsum is None else (d_raw, dsum2, bsum)
    if g.numel() == 0:
        dsum2.zero_()
        if bsum is not None:
            bsum.zero_()
        return outs
    plan = project_bwd_plan(b, t, f, g.element_size(), g.data_ptr(), _sm_count(g.device.index))
    blocks = plan.grid_x * plan.grid_y
    part = torch.empty((blocks + plan.groups, 2, f), dtype=torch.float32, device=g.device)
    lib = _bwd_lib()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        counters = _bwd_counters(g.device, stream, plan.groups + 1)
        code = lib.healnet_fused_project_bwd(
            g.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            None if scale is None else scale.data_ptr(), d_raw.data_ptr(), part.data_ptr(),
            dsum2.data_ptr(), None if bsum is None else bsum.data_ptr(), counters.data_ptr(),
            b, t, f, float(d_total), float(eps), int(g.dtype == torch.bfloat16), plan.vec,
            plan.w, plan.grid_x, plan.grid_y, stream,
        )
    if scale is None:
        fused_project_bwd_kernel.launches += 1
    else:
        fused_project_bwd_kernel.launches_int8 += 1
    cuda_build.check(lib, code, "fused_project_bwd_kernel")
    return outs


fused_project_bwd_kernel.launches = 0
fused_project_bwd_kernel.launches_int8 = 0


def _gemm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in f32 (bf16 products are exact
    in f32), as JAX's ``preferred_element_type=float32``."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class FusedProjectFunction(torch.autograd.Function):
    """The merged folded-KV projection with its backward, for autograd.

    ``apply(dat, enc, w_all, b_all, eps, scale=None, out_dtype=None)`` ->
    (b, t, F) in the compute dtype: dat's, or ``out_dtype`` (default f32)
    for an int8 ``dat`` with its (b, t) ``scale``. The forward is
    :func:`project_op`: CUDA tensors launch the forward kernel and, in the
    backward, the cotangent-pass kernel; CPU tensors take the plain
    versions, which the tests use to check the formulas. The residuals are
    the inputs and the two (b, t) row statistics, never a (b, t, F) tensor.

    Backward (the JAX package's ``_pallas_bwd``): with ``d_raw = (scale *)
    inv * g`` and ``dsum2 = [sum g; sum inv * mu * g]`` from the cotangent
    pass, ``d_W_c = dat^T d_raw`` (a library GEMM, as JAX leaves it to XLA;
    an int8 context is cast to the compute dtype for it), ``d_W_e = enc^T
    sum_b round(inv * g)`` in f32 (the pass's ``bsum`` for an int8 context),
    ``d_bias = dsum2[0]`` and ``-dsum2[1]`` added to every row of ``d_W``.
    The input cotangents ``d_dat`` (none for int8 values), ``d_enc`` and
    ``d_scale`` are plain ops, computed only when asked for: training never
    needs them.
    """

    @staticmethod
    def forward(ctx, dat, enc, w_all, b_all, eps, scale=None, out_dtype=None):
        cdt = out_dtype or (torch.float32 if scale is not None else dat.dtype)
        if dat.is_cuda and scale is None and cdt != dat.dtype:
            raise ValueError("a bf16/f32 context computes in its own dtype")
        kv, s1, s2 = project_op(dat, enc, w_all, b_all, float(eps), scale, cdt)
        ctx.save_for_backward(dat, enc, w_all, s1, s2, scale)
        ctx.eps, ctx.b_dtype = eps, b_all.dtype
        return kv

    @staticmethod
    def backward(ctx, g):
        dat, enc, w_all, s1, s2, scale = ctx.saved_tensors
        eps = ctx.eps
        need_dat, need_enc, need_w, need_b = ctx.needs_input_grad[:4]
        need_scale = any(ctx.needs_input_grad[5:6])  # apply() may leave the scale out
        need_enc = need_enc and enc is not None
        quantized = scale is not None
        cdt = g.dtype if quantized else dat.dtype
        c, d_total, f = dat.shape[-1], w_all.shape[0], w_all.shape[1]
        g = g.contiguous().to(cdt)
        d_dat = d_enc = d_w = d_bias = d_scale = None

        if need_w or need_b:
            bwd = fused_project_bwd_kernel if g.is_cuda else project_bwd_plain
            with_bsum = quantized and enc is not None
            outs = bwd(g, s1, s2, d_total, eps, scale=scale, with_bsum=with_bsum)
            d_raw, dsum2 = outs[0], outs[1]
            d_bias = dsum2[0].to(ctx.b_dtype)
            d_w = torch.zeros_like(w_all)
            d_w[:c] = _gemm_f32(dat.reshape(-1, c).t().to(cdt), d_raw.reshape(-1, f))
            if enc is not None:
                d_raw_t = outs[2] if with_bsum else torch.sum(d_raw.float(), dim=0)
                d_w[c:] = enc.float().t() @ d_raw_t  # (E, F)
            d_w -= dsum2[1]

        if need_dat or need_enc or need_scale:
            mu, inv = _mu_inv(s1, s2, d_total, eps)
            colsum = torch.sum(w_all, dim=0)
            gf = g.float()
            # the pre-normalization product in f32, as JAX's backward forms it
            raw = (dat.to(cdt) @ w_all[:c].to(cdt)).float()
            if quantized:
                raw = raw * scale[..., None]
            if enc is not None:
                raw = raw + (enc.to(cdt) @ w_all[c:].to(cdt)).float()
            d_inv = torch.sum(gf * (raw - mu[..., None] * colsum), dim=-1)
            d_p = inv[..., None] * gf
            d_var = d_inv * -0.5 * inv * inv * inv
            d_s2 = d_var / d_total
            d_s1 = (-torch.sum(d_p * colsum, dim=-1) - 2.0 * mu * d_var) / d_total
            if need_dat or need_scale:
                x_eff = dat.float() if not quantized else dat.float() * scale[..., None]
                d_x = d_p @ w_all[:c].t().float() + d_s1[..., None] + 2.0 * x_eff * d_s2[..., None]
                if quantized:  # int8 values carry no gradient; the scale's is
                    d_scale = torch.sum(d_x * dat.float(), dim=-1).to(scale.dtype)
                else:
                    d_dat = d_x.to(dat.dtype)
            if need_enc:
                d_enc = (torch.sum(d_p, dim=0) @ w_all[c:].t().float()
                         + torch.sum(d_s1, dim=0)[..., None]
                         + 2.0 * enc.float() * torch.sum(d_s2, dim=0)[..., None]
                         ).to(enc.dtype)
        return d_dat, d_enc, d_w, d_bias, None, d_scale, None


def fused_kv_project(
    dat,
    enc: Optional[torch.Tensor],
    w_all: torch.Tensor,
    b_all: torch.Tensor,
    *,
    eps: float = 1e-5,
    impl: str = "auto",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Merged folded-KV projection of a raw context: (b, t, F).

    dat: (b, t, C) tensor or a :class:`QuantizedContext` (int8 values and
    per-token f32 scales: half the context bytes, the scale applied on the
    accumulator). Returns ``out_dtype``, by default the context's dtype, or
    float32 for a quantized context.

    impl: ``"xla"`` is the plain two-pass version anywhere; ``"kernel"``
    (also spelt ``"pallas"``, the JAX package's name) and ``"auto"`` run a
    CUDA tensor through :class:`FusedProjectFunction` (the forward kernel,
    and the cotangent-pass kernel in the backward). A CPU tensor always
    takes the plain version.
    """
    scale = None
    if isinstance(dat, QuantizedContext):
        scale, dat = dat.scale, dat.data
        if out_dtype is None:
            out_dtype = torch.float32
    if impl not in _IMPLS:
        raise ValueError(f"unknown fused projection impl: {impl!r}")
    if impl == "xla" or not dat.is_cuda:
        return project_plain(dat, enc, w_all, b_all, eps, scale, out_dtype)
    return FusedProjectFunction.apply(dat, enc, w_all, b_all, eps, scale, out_dtype)


def split_columns(x: torch.Tensor, widths) -> Tuple[torch.Tensor, ...]:
    """Split the last axis into contiguous column blocks (views)."""
    widths = [int(w) for w in widths]
    if sum(widths) != x.shape[-1]:
        raise ValueError(f"widths {widths} do not cover {x.shape[-1]} columns")
    return tuple(torch.split(x, widths, dim=-1))
