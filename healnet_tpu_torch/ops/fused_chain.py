"""Fused latent chain: every (layer, modality) block of the fusion loop in
one launch (forward only).

Counterpart of ``healnet_tpu/ops/fused_chain.py``. The HealNet fusion loop
runs, per layer and per modality, a cross-attention and a feed-forward block
over a tiny latent array (l_c x l_d, e.g. 17 x 126). The module path
launches a dozen small kernels per block; :func:`fused_latent_chain` runs the
whole chain in ONE CUDA kernel (``csrc/fused_chain.cu``), one thread-block
cluster per batch element (sized by :func:`chain_plan`), over the merged KV
buffers that
:meth:`healnet_tpu_torch.models.healnet.HealNetModule.project_contexts`
returns.

Per layer l and modality m: PreNorm -> Q projection -> scores on the K
columns of the merged KV at ``offsets[l]`` -> masked softmax -> hash dropout
(seed ``seeds[l, m]``, row id the batch index) -> @V -> out projection ->
LeakyReLU(0.01) -> presence residual -> PreNorm -> gated SELU/GELU FF -> FF
keep multipliers -> presence residual.

Numerics (the JAX kernel's): the latent-side math is f32; q is rounded to
the KV dtype before the scores, the dropped probabilities to the KV dtype
before @V, both products accumulating in f32; the output is rounded to the
latent's dtype once, at the end. The module path rounds x after every block
in bf16, so the chain agrees with it tightly at f32 only.

:func:`chain_reference` is the plain version (differentiable by autograd),
the CPU path and the kernel's oracle. As in the JAX package, no model,
serving or trainer path dispatches to the chain; :func:`stack_chain_weights`
and :func:`chain_spec` build its operands from a ``HealNetModule``. Scope:
one cross head (``x_heads == 1``) and no latent self-attention
(``self_per_cross_attn == 0``), which covers every tuned configuration.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.flash_attention import _CLUSTER_SIZES, _max_cluster, _sm_count
from healnet_tpu_torch.ops.hash_dropout import dense_keep_mask, keep_scale, keep_threshold

_NEG_BIG = 1e30
# selu constants (jax.nn.selu)
_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
_MAX_SMEM = 232448  # dynamic shared memory a block may use on Hopper

# weight bundle order (all stacked over (layers, modalities) on axes 0, 1)
WEIGHT_FIELDS = (
    "ln1_s", "ln1_b",        # (L, M, 1, l_d) f32 — attention PreNorm affine
    "wq",                    # (L, M, l_d, inner) f32
    "wout", "bout",          # (L, M, inner, l_d), (L, M, 1, l_d) f32
    "ln2_s", "ln2_b",        # (L, M, 1, l_d) f32 — FF PreNorm affine
    "w0", "b0",              # (L, M, l_d, 2*mult*l_d), (L, M, 1, 2*mult*l_d)
    "w2", "b2",              # (L, M, mult*l_d, l_d), (L, M, 1, l_d)
)


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static configuration of one fused chain call."""

    depth: int
    n_modalities: int
    l_c: int
    l_d: int
    inner: int               # cross_dim_head * x_heads (x_heads == 1)
    mult: int                # FF expansion (reference: 4)
    act: str                 # "selu" | "gelu"
    scale: float             # cross_dim_head ** -0.5 / temperature
    attn_dropout: float
    ff_dropout: float
    tokens: Tuple[int, ...]      # per-modality context length
    offsets: Tuple[int, ...]     # per-LAYER column offset into kv_all
    has_mask: Tuple[bool, ...]   # per-modality kv_mask present
    out_dtype: str               # latent/compute storage dtype name

    @property
    def sites(self) -> int:
        return self.depth * self.n_modalities


def weight_shapes(spec: ChainSpec) -> Tuple[Tuple[int, ...], ...]:
    """The shapes of the 11 stacked arrays, in :data:`WEIGHT_FIELDS` order."""
    lm, ld, inner = (spec.depth, spec.n_modalities), spec.l_d, spec.inner
    f = spec.mult * ld
    row = (*lm, 1, ld)
    return (row, row, (*lm, ld, inner), (*lm, inner, ld), row, row, row,
            (*lm, ld, 2 * f), (*lm, 1, 2 * f), (*lm, f, ld), row)


# --------------------------------------------------------------- reference


def _act(g: torch.Tensor, act: str) -> torch.Tensor:
    if act == "selu":
        return _SELU_SCALE * torch.where(g > 0, g, _SELU_ALPHA * torch.expm1(g))
    return 0.5 * g * (1.0 + torch.erf(g * _INV_SQRT2))


def _act_grad(g: torch.Tensor, act: str) -> torch.Tensor:
    if act == "selu":
        return _SELU_SCALE * torch.where(g > 0, torch.ones_like(g), _SELU_ALPHA * torch.exp(g))
    phi = torch.exp(-0.5 * g * g) * _INV_SQRT_2PI
    cdf = 0.5 * (1.0 + torch.erf(g * _INV_SQRT2))
    return cdf + g * phi


def _ln(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    """f32 LayerNorm over the last axis with var = E[x^2] - mu^2; returns
    (y, x_hat, inv_sigma)."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True) - torch.square(mu)
    inv = torch.rsqrt(var + eps)
    xn = (x - mu) * inv
    return xn * s + b, xn, inv


def chain_reference(
    x0: torch.Tensor,
    kvs: Sequence[torch.Tensor],
    masks: Sequence[Optional[torch.Tensor]],
    ff_keep: Optional[torch.Tensor],
    presence: torch.Tensor,
    seeds,
    weights: Sequence[torch.Tensor],
    spec: ChainSpec,
) -> torch.Tensor:
    """Plain version of the fused kernel (batched over b), differentiable.

    Args:
        x0: (b, l_c, l_d) latent in the compute dtype.
        kvs: per modality, (b, t_m, F) merged-KV buffer (all layer groups'
            K|V columns side by side).
        masks: per modality, optional (b, t_m) bool or float (1 = attend).
        ff_keep: (b, L*M, l_c, l_d) pre-scaled FF keep multipliers, or None
            (applied when given).
        presence: (b, M), 1 where the modality exists.
        seeds: (L, M) 32-bit attention-dropout hash seeds (a tensor or array
            of any integer type; the low 32 bits count).
        weights: the 11 stacked f32 arrays of :data:`WEIGHT_FIELDS`.
        spec: static config.

    Returns:
        (b, l_c, l_d) final latent in the compute dtype.
    """
    w = dict(zip(WEIGHT_FIELDS, weights))
    b = x0.shape[0]
    cdt = x0.dtype
    x = x0.float()
    for l in range(spec.depth):
        off = spec.offsets[l]
        for m in range(spec.n_modalities):
            s_idx = l * spec.n_modalities + m
            pres = presence[:, m].float()[:, None, None]
            # ---- attention block
            y, _, _ = _ln(x, w["ln1_s"][l, m], w["ln1_b"][l, m])
            q = y @ w["wq"][l, m]                        # (b, lc, inner) f32
            k = kvs[m][:, :, off:off + spec.inner]
            v = kvs[m][:, :, off + spec.inner:off + 2 * spec.inner]
            # operands in the KV dtype, products and sums in f32
            s = q.to(k.dtype).float() @ k.float().transpose(1, 2) * spec.scale
            if masks[m] is not None:
                mk = masks[m].float()[:, None, :]
                s = s + (mk - 1.0) * _NEG_BIG
            mx = torch.amax(s, dim=-1, keepdim=True)
            p = torch.exp(s - mx)
            if masks[m] is not None:
                p = p * mk
            probs = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
            if spec.attn_dropout > 0.0:  # row id: the batch index
                keep = dense_keep_mask(seeds[l, m], b, spec.l_c, spec.tokens[m],
                                       spec.attn_dropout, device=x.device)
                probs = torch.where(keep, probs * keep_scale(spec.attn_dropout),
                                    torch.zeros_like(probs))
            av = probs.to(v.dtype).float() @ v.float()   # (b, lc, inner) f32
            o = av @ w["wout"][l, m] + w["bout"][l, m]
            u = torch.where(o >= 0, o, 0.01 * o)
            x = pres * u + x
            # ---- feed-forward block
            y2, _, _ = _ln(x, w["ln2_s"][l, m], w["ln2_b"][l, m])
            h1 = y2 @ w["w0"][l, m] + w["b0"][l, m]      # (b, lc, 2F)
            f = spec.mult * spec.l_d
            gated = h1[..., :f] * _act(h1[..., f:], spec.act)
            h2 = gated @ w["w2"][l, m] + w["b2"][l, m]
            if ff_keep is not None:
                h2 = h2 * ff_keep[:, s_idx].float()
            x = pres * h2 + x
    return x.to(cdt)


# ------------------------------------------------------------ launch plan

CHAIN_TILE = 64         # keys per tile of the kernel (its kTile)
CHAIN_MAX_CHUNK = 512   # keys whose scores a block holds in shared memory at once


def _keys_per_block(tokens: Sequence[int], cluster: int,
                    tile: int = CHAIN_TILE) -> Tuple[int, ...]:
    return tuple(max(1, -(-(-(-int(t) // cluster)) // tile)) * tile for t in tokens)


def chain_plan(batch: int, tokens: Sequence[int], sms: int,
               max_cluster: int) -> Tuple[int, Tuple[int, ...], int]:
    """Launch plan of the chain kernel: ``(cluster, keys_per_block, chunk)``.

    One cluster of ``cluster`` blocks per batch element: the fewest (a
    power of two) that give every one of ``sms`` SMs a block, at most
    ``max_cluster`` (the largest cluster of which ``batch`` fit on the card
    at once) and 16. Block ``r`` owns keys ``[r * kpb, (r + 1) * kpb)`` of a
    modality, ``kpb = keys_per_block[m]`` a whole number of
    :data:`CHAIN_TILE`-key tiles; blocks past the modality's last key own
    none. ``chunk``: the keys whose scores a block holds at once, its longest
    range up to :data:`CHAIN_MAX_CHUNK` (a longer range takes chunks, scored
    twice).
    """
    want = max(1, -(-sms // max(batch, 1)))
    cap = min(max_cluster, 16)
    cluster = 1
    while cluster * 2 <= cap and cluster < want:
        cluster *= 2
    kpb = _keys_per_block(tokens, cluster)
    return cluster, kpb, min(max(kpb), CHAIN_MAX_CHUNK)


def chain_launch_plan(spec: ChainSpec, batch: int, dtype: torch.dtype,
                      device: torch.device) -> Tuple[int, Tuple[int, ...], int]:
    """:func:`chain_plan` on ``device`` (a CUDA device), with its SM count
    and the kernel's cluster occupancy (``healnet_chain_max_clusters``,
    through the flash kernels' ``_max_cluster``); the chunk shrinks by tiles
    until a block's shared memory fits. Raises where even one tile does
    not."""
    lib = _lib()
    dims = (spec.l_c, spec.l_d, spec.inner, spec.mult)
    bf16 = int(dtype == torch.bfloat16)
    smem = lambda cluster, chunk: lib.healnet_chain_smem_bytes(*dims, cluster, chunk)
    chunks = {}
    for c in _CLUSTER_SIZES:
        chunks[c] = min(max(_keys_per_block(spec.tokens, c)), CHAIN_MAX_CHUNK)
        while chunks[c] > CHAIN_TILE and smem(c, chunks[c]) > _MAX_SMEM:
            chunks[c] -= CHAIN_TILE
    resident = lambda c: (lib.healnet_chain_max_clusters(*dims, c, chunks[c], bf16)
                          if smem(c, chunks[c]) <= _MAX_SMEM else 0)
    key = ("chain", device.index, *dims, bf16, *chunks.values())
    cluster, kpb, _ = chain_plan(batch, spec.tokens, _sm_count(device.index),
                                 _max_cluster(resident, key, batch))
    if smem(cluster, chunks[cluster]) > _MAX_SMEM:
        raise ValueError(f"l_c={spec.l_c}, l_d={spec.l_d}, inner={spec.inner} needs "
                         f"{smem(cluster, chunks[cluster])} B of shared memory")
    return cluster, kpb, chunks[cluster]


# ----------------------------------------------------------------- kernel


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_chain")
    fn = lib.healnet_chain_forward
    if fn.argtypes is None:
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        fn.argtypes = [p] * 14 + [i] * 10 + [f, i, u, f, i, p]
        fn.restype = ctypes.c_int
        lib.healnet_chain_smem_bytes.argtypes = [i] * 6
        lib.healnet_chain_smem_bytes.restype = ctypes.c_longlong
        lib.healnet_chain_max_clusters.argtypes = [i] * 7
        lib.healnet_chain_max_clusters.restype = i
        lib.healnet_chain_limits.argtypes = [p]
        lib.healnet_chain_limits.restype = None
    return lib


def _c_array(ctype, values):
    arr = (ctype * len(values))(*values)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _check_kernel_operands(x0, kvs, masks, ff_keep, presence, weights, spec) -> None:
    dev, dt = x0.device, x0.dtype
    b = x0.shape[0]
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_chain_kernel takes bf16 or f32 latents, got {dt}")
    if tuple(x0.shape) != (b, spec.l_c, spec.l_d):
        raise ValueError(f"x0 must be (b, {spec.l_c}, {spec.l_d}), got {tuple(x0.shape)}")
    if spec.act not in ("selu", "gelu"):
        raise ValueError(f"unknown activation {spec.act!r}")
    if not (len(kvs) == len(masks) == len(spec.tokens) == len(spec.has_mask)
            == spec.n_modalities) or len(spec.offsets) != spec.depth:
        raise ValueError("kvs, masks, tokens and has_mask need one entry per modality, "
                         "offsets one per layer")
    for m, kv in enumerate(kvs):
        if kv.device != dev or kv.dtype != dt:
            raise ValueError(f"kvs[{m}] must be {dt} on {dev}")
        if kv.ndim != 3 or kv.shape[:2] != (b, spec.tokens[m]) or kv.stride(-1) != 1:
            raise ValueError(f"kvs[{m}] must be (b, {spec.tokens[m]}, F) with unit column "
                             f"stride, got {tuple(kv.shape)}")
        if max(spec.offsets) + 2 * spec.inner > kv.shape[-1]:
            raise ValueError(f"kvs[{m}] has {kv.shape[-1]} columns, offsets need "
                             f"{max(spec.offsets) + 2 * spec.inner}")
        if (masks[m] is not None) != spec.has_mask[m]:
            raise ValueError(f"masks[{m}] does not match spec.has_mask")
        if masks[m] is not None and tuple(masks[m].shape) != (b, spec.tokens[m]):
            raise ValueError(f"masks[{m}] must be (b, {spec.tokens[m]})")
    if tuple(presence.shape) != (b, spec.n_modalities):
        raise ValueError(f"presence must be (b, {spec.n_modalities})")
    if ff_keep is not None and tuple(ff_keep.shape) != (b, spec.sites, spec.l_c, spec.l_d):
        raise ValueError(f"ff_keep must be (b, {spec.sites}, {spec.l_c}, {spec.l_d})")
    for name, w, shape in zip(WEIGHT_FIELDS, weights, weight_shapes(spec)):
        if tuple(w.shape) != shape or w.dtype != torch.float32 or w.device != dev:
            raise ValueError(f"{name} must be {shape} f32 on {dev}, got {tuple(w.shape)} "
                             f"{w.dtype}")
    tensors = [x0, *kvs, *[mk for mk in masks if mk is not None], presence, *weights]
    if ff_keep is not None:
        tensors.append(ff_keep)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the fused chain kernel is forward-only: call it under "
                           "torch.no_grad(), or use chain_reference for gradients")


def fused_chain_kernel(x0, kvs, masks, ff_keep, presence, seeds, weights,
                       spec: ChainSpec) -> torch.Tensor:
    """Launch the CUDA kernel: the (b, l_c, l_d) final latent in x0's dtype.

    Arguments as :func:`chain_reference`, all on one CUDA device; the KV
    buffers in x0's dtype (bf16 or f32), any strides with a unit stride on
    the columns. Forward only: raises if an input requires grad while
    autograd records (outside ``torch.no_grad()``).
    """
    if not x0.is_cuda:
        raise ValueError("fused_chain_kernel takes CUDA tensors")
    _check_kernel_operands(x0, kvs, masks, ff_keep, presence, weights, spec)
    lib = _lib()
    limits = (ctypes.c_int * 4)()
    lib.healnet_chain_limits(ctypes.cast(limits, ctypes.c_void_p))
    max_mod, max_depth, max_lc, max_inner = limits
    if (spec.n_modalities > max_mod or spec.depth > max_depth or spec.l_c > max_lc
            or spec.inner > max_inner):
        raise ValueError(f"the kernel takes at most {max_mod} modalities, depth {max_depth}, "
                         f"l_c {max_lc} and inner {max_inner}")
    dev = x0.device
    b = x0.shape[0]
    with torch.cuda.device(dev):  # the occupancy query runs on the current device
        cluster, kpb, chunk = chain_launch_plan(spec, b, x0.dtype, dev)
    x0 = x0.contiguous()
    fmasks = [None if mk is None else mk.to(device=dev, dtype=torch.float32).contiguous()
              for mk in masks]
    pres = presence.to(device=dev, dtype=torch.float32).contiguous()
    keep = None if ff_keep is None else ff_keep.to(dtype=torch.float32).contiguous()
    seeds = torch.as_tensor(seeds).to(device=dev, dtype=torch.int64) & 0xFFFFFFFF
    seeds = seeds.reshape(spec.depth, spec.n_modalities).contiguous()
    weights = [w.contiguous() for w in weights]
    out = torch.empty_like(x0)
    ptr = lambda t: None if t is None else t.data_ptr()
    kv_arr = _c_array(ctypes.c_void_p, [kv.data_ptr() for kv in kvs])
    kv_sb = _c_array(ctypes.c_longlong, [kv.stride(0) for kv in kvs])
    kv_st = _c_array(ctypes.c_longlong, [kv.stride(1) for kv in kvs])
    tokens = _c_array(ctypes.c_int, list(spec.tokens))
    mask_arr = _c_array(ctypes.c_void_p, [ptr(mk) for mk in fmasks])
    mask_sb = _c_array(ctypes.c_longlong, [0 if mk is None else mk.stride(0) for mk in fmasks])
    w_arr = _c_array(ctypes.c_void_p, [w.data_ptr() for w in weights])
    offsets = _c_array(ctypes.c_int, list(spec.offsets))
    keys = _c_array(ctypes.c_int, list(kpb))
    rate = float(spec.attn_dropout)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.healnet_chain_forward(
            x0.data_ptr(), out.data_ptr(), kv_arr[1], kv_sb[1], kv_st[1], tokens[1],
            mask_arr[1], mask_sb[1], ptr(keep), pres.data_ptr(), seeds.data_ptr(), w_arr[1],
            offsets[1], keys[1], b, spec.depth, spec.n_modalities, spec.l_c, spec.l_d,
            spec.inner, spec.mult, int(spec.act == "gelu"), cluster, chunk, float(spec.scale),
            int(rate > 0),
            keep_threshold(rate), keep_scale(rate),
            int(x0.dtype == torch.bfloat16), stream,
        )
    fused_chain_kernel.launches += 1
    cuda_build.check(lib, code, "fused_chain_kernel")
    return out


fused_chain_kernel.launches = 0


def fused_latent_chain(
    x0: torch.Tensor,
    kvs: Sequence[torch.Tensor],
    masks: Sequence[Optional[torch.Tensor]],
    ff_keep: Optional[torch.Tensor],
    presence: torch.Tensor,
    seeds,
    weights: Sequence[torch.Tensor],
    spec: ChainSpec,
) -> torch.Tensor:
    """The whole latent chain: (b, l_c, l_d) in x0's dtype.

    A CUDA ``x0`` launches the kernel (:func:`fused_chain_kernel`, forward
    only: it raises if an input requires grad); a CPU ``x0`` takes the
    plain version, :func:`chain_reference`. Arguments as there.
    """
    if x0.is_cuda:
        return fused_chain_kernel(x0, kvs, masks, ff_keep, presence, seeds, weights, spec)
    return chain_reference(x0, kvs, masks, ff_keep, presence, seeds, weights, spec)


# ------------------------------------------------- operands from a module


def _check_scope(module) -> None:
    if module.x_heads != 1 or module.self_per_cross_attn != 0:
        raise ValueError(
            "the fused chain covers x_heads == 1 and self_per_cross_attn == 0, got "
            f"x_heads={module.x_heads}, self_per_cross_attn={module.self_per_cross_attn}")


def _layer_keys(module) -> List[int]:
    """Each fusion layer's module-group key (tied layers share theirs)."""
    from healnet_tpu_torch.models.healnet import _tie_key  # the model imports the ops

    return [_tie_key(l, module.weight_tie_layers) for l in range(module.depth)]


def stack_chain_weights(module) -> Tuple[torch.Tensor, ...]:
    """A ``HealNetModule``'s cross-attention and cross-FF parameters as the
    11 f32 arrays of :data:`WEIGHT_FIELDS`, stacked over (depth, modality).

    Tied layers repeat their group's weights and a shared cross-FF repeats
    across modalities; dense weights turn from the port's (out, in) layout
    into the chain's (in, out). Differentiable (no copy is detached).
    """
    _check_scope(module)
    fields = {k: [] for k in WEIGHT_FIELDS}
    row = lambda t: t[None]
    for key in _layer_keys(module):
        group = module.groups[key]
        for m in range(module.n_modalities):
            att = module._mod(group["cross_attns"][m])
            ff = module._mod(group["cross_ffs"][m])
            vals = (row(att.norm.weight), row(att.norm.bias), att.fn.to_q.weight.t(),
                    att.fn.to_out.weight.t(), row(att.fn.to_out.bias),
                    row(ff.norm.weight), row(ff.norm.bias),
                    ff.fn.net_0.weight.t(), row(ff.fn.net_0.bias),
                    ff.fn.net_2.weight.t(), row(ff.fn.net_2.bias))
            for field, value in zip(WEIGHT_FIELDS, vals):
                fields[field].append(value.float())
    lm = (module.depth, module.n_modalities)
    return tuple(torch.stack(fields[k]).reshape(*lm, *fields[k][0].shape) for k in WEIGHT_FIELDS)


def chain_spec(module, tokens: Sequence[int], has_mask: Sequence[bool],
               training: bool = False) -> ChainSpec:
    """The :class:`ChainSpec` of a ``HealNetModule`` over contexts of
    ``tokens`` keys: ``scale = cross_dim_head**-0.5 / temperature``; layer
    l's offset into the merged KV (``project_contexts``) is its group's
    index times ``2 * inner``; the dropout rates only when ``training``."""
    _check_scope(module)
    order = list(module.groups)
    inner = module.cross_dim_head * module.x_heads
    attn = module._mod(module.groups[0]["cross_attns"][0]).fn
    ff = module._mod(module.groups[0]["cross_ffs"][0]).fn
    dtype = module.dtype if module.dtype is not None else torch.float32
    return ChainSpec(
        depth=module.depth, n_modalities=module.n_modalities, l_c=module.l_c, l_d=module.l_d,
        inner=inner, mult=ff.net_2.in_features // module.l_d,
        act="selu" if module.snn else "gelu",
        scale=module.cross_dim_head**-0.5 / attn.temperature,
        attn_dropout=float(module.attn_dropout) if training else 0.0,
        ff_dropout=float(module.ff_dropout) if training else 0.0,
        tokens=tuple(int(t) for t in tokens),
        offsets=tuple(order.index(k) * 2 * inner for k in _layer_keys(module)),
        has_mask=tuple(bool(h) for h in has_mask),
        out_dtype=str(dtype).replace("torch.", ""),
    )
