"""PyTorch port ops (healnet_tpu_torch.ops) against the JAX package on CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
port. Unless a test says otherwise, float32 results agree to 1e-5 relative /
1e-6 absolute; hash keep masks must be bit-equal.
"""

import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healnet_tpu.ops import activations as jact
from healnet_tpu.ops import attention as jatt
from healnet_tpu.ops import fourier as jfour
from healnet_tpu.ops import hash_dropout as jhash
from healnet_tpu.ops.flash_attention import _bwd_call as jflash_bwd_call
from healnet_tpu.ops.flash_attention import _fwd_call as jflash_fwd_call
from healnet_tpu.ops.flash_attention import flash_cross_attention as jflash
from healnet_tpu.ops.fused_project import _pallas_bwd_call as jproject_bwd_call
from healnet_tpu.ops.fused_project import fused_kv_project as jproject
from healnet_tpu.ops.quantize import QuantizedContext as JaxQC
from healnet_tpu.ops.hash_dropout import seed_from_rng
from healnet_tpu_torch import device as tdevice
from healnet_tpu_torch.ops import activations as tact
from healnet_tpu_torch.ops import attention as tatt
from healnet_tpu_torch.ops import fourier as tfour
from healnet_tpu_torch.ops import hash_dropout as thash
from healnet_tpu_torch.ops.flash_attention import (
    LAUNCH_COUNTERS,
    _BF16_BWD_PANEL_WIDTH,
    _PANEL_MAX,
    _RESIDENT,
    _WIDE_CLUSTER_SIZES,
    FlashAttentionFunction,
    _max_cluster,
    flash_attention_bwd_kernel,
    flash_attention_kernel,
    flash_backward_plain,
    flash_cross_attention as tflash,
    flash_lse_plain,
    flash_panels,
    flash_plan,
    flash_variant,
    key_tile,
    launch_counter,
    query_chunks,
    wide_smem,
)
from healnet_tpu_torch.ops.fused_project import (
    PROJECT_WIDTHS,
    SPLIT_MAX_ROWS,
    SPLIT_SMEM,
    FusedProjectFunction,
    fused_kv_project as tproject,
    fused_project_bwd_kernel,
    fused_project_kernel,
    project_bwd_plain,
    project_bwd_plan,
    project_f32_plan,
    project_generic_plan,
    project_plan,
    project_route,
    project_smem,
    split_columns,
)
from healnet_tpu_torch.ops.quantize import QuantizedContext

RTOL, ATOL = 1e-5, 1e-6
SEEDS = [0, 1, 12345, 2**31 - 1, 2**31, 2**31 + 7, 0xDEADBEEF, 2**32 - 1]


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, np.float32), rtol=rtol, atol=atol
    )


# ------------------------------------------------------------ hash dropout


@pytest.mark.parametrize("rate", [0.083, 0.3, 0.5])
@pytest.mark.parametrize("shape", [(2, 17, 300), (3, 5, 1024)])
def test_dense_keep_mask_bit_equal(rate, shape):
    bh, lq, lkv = shape
    for seed in SEEDS:
        ref = np.asarray(jhash.dense_keep_mask(jnp.asarray(np.uint32(seed)), bh, lq, lkv, rate))
        got = thash.dense_keep_mask(seed, bh, lq, lkv, rate).numpy()
        assert np.array_equal(got, ref), f"seed {seed}"
    assert thash.keep_threshold(rate) == int(jhash.keep_threshold(rate))


def test_hash_keep_bit_equal_full_range_coordinates(rng):
    # coordinates and seeds across all 32 bits exercise every carry of the
    # int64-held multiply
    ids = rng.integers(0, 2**32, size=(3, 4096), dtype=np.uint64).astype(np.uint32)
    for seed in SEEDS:
        ref = np.asarray(jhash.hash_keep(
            jnp.asarray(np.uint32(seed)), jnp.asarray(ids[0]), jnp.asarray(ids[1]),
            jnp.asarray(ids[2]), 0.3,
        ))
        t = [torch.from_numpy(ids[i].astype(np.int64)) for i in range(3)]
        got = thash.hash_keep(seed, t[0], t[1], t[2], 0.3).numpy()
        assert np.array_equal(got, ref), f"seed {seed}"


# ------------------------------------------------------ fourier/activations


@pytest.mark.parametrize(
    "spatial,max_freq,bands", [((7,), 2.0, 2), ((4, 5), 10.0, 4), ((3, 4, 2), 6.0, 3)]
)
def test_positional_encoding(spatial, max_freq, bands):
    ref = jfour.positional_encoding(spatial, max_freq, bands)
    got = tfour.positional_encoding(spatial, max_freq, bands)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("name", ["gelu", "selu", "relu"])
def test_gated_activations(rng, name):
    x = rng.normal(size=(4, 6, 10)).astype(np.float32)
    ref = jact.GATED_ACTIVATIONS[name](jnp.asarray(x))
    got = tact.GATED_ACTIVATIONS[name](torch.from_numpy(x))
    _close(got, ref)
    assert tact.mask_value(torch.float32) == jact.mask_value(jnp.float32)


# ---------------------------------------------------------------- attention


def _qkv(rng, b=2, h=2, lq=17, lkv=300, d=63):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, h, lq, d), (b, h, lkv, d), (b, h, lkv, d))]


@pytest.mark.parametrize("masked", [False, True])
def test_multihead_attention(rng, masked):
    q, k, v = _qkv(rng)
    mask = None
    if masked:
        mask = rng.uniform(size=(2, 300)) > 0.4
        mask[1] = False  # a fully masked row outputs zero
    scale = 63**-0.5
    ref, ref_w = jatt.multihead_attention(
        *map(jnp.asarray, (q, k, v)), scale=scale, temperature=0.5,
        kv_mask=None if mask is None else jnp.asarray(mask), return_weights=True,
    )
    got, got_w = tatt.multihead_attention(
        *map(torch.from_numpy, (q, k, v)), scale=scale, temperature=0.5,
        kv_mask=None if mask is None else torch.from_numpy(mask), return_weights=True,
    )
    _close(got, ref)
    _close(got_w, ref_w)
    if masked:
        assert float(got[1].abs().max()) == 0.0


# --------------------------------------------------------- fused projection


def _proj_inputs(rng, b=2, t=384, c=256, e=10, f=252):
    dat = rng.normal(size=(b, t, c)).astype(np.float32)
    enc = rng.normal(size=(t, e)).astype(np.float32) if e else None
    w = (rng.normal(size=(c + e, f)) * 0.05).astype(np.float32)
    bias = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    return dat, enc, w, bias


def _both_projections(dat, enc, w, bias, dtype):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jenc = None if enc is None else jnp.asarray(enc)
    tenc = None if enc is None else torch.from_numpy(enc)
    jargs = (jnp.asarray(dat, jd), jenc, jnp.asarray(w), jnp.asarray(bias))
    refs = {
        "xla": jproject(*jargs, impl="xla"),
        "pallas": jproject(*jargs, impl="pallas", interpret=True, tile=128),
    }
    got = tproject(
        torch.from_numpy(dat).to(td), tenc, torch.from_numpy(w), torch.from_numpy(bias),
        impl="auto",
    )
    return got, refs


@pytest.mark.parametrize("case", ["enc", "no_enc", "ragged_tokens"])
def test_fused_kv_project_f32(rng, case):
    kw = {"enc": {}, "no_enc": {"e": 0}, "ragged_tokens": {"t": 200}}[case]
    got, refs = _both_projections(*_proj_inputs(rng, **kw), "f32")
    for name, ref in refs.items():
        assert tuple(got.shape) == ref.shape, name
        _close(got, ref)


def test_fused_kv_project_bf16(rng):
    got, refs = _both_projections(*_proj_inputs(rng), "bf16")
    assert got.dtype == torch.bfloat16
    for ref in refs.values():
        # bf16 keeps 8 bits of mantissa: outputs of magnitude ~1-4 round at
        # up to 1.6e-2; the two frameworks round the product at the same
        # places, so they agree to within two bf16 ulps
        _close(got, ref, rtol=2e-2, atol=2e-2)


# the generic route's shapes: rows at any byte offset (odd C, an omic vector
# of 2001 columns, C = 3: the README's image modality, C = 1: the
# omic_attention: false layout) and few rows (batch 8, one token)
GENERIC_SHAPES = {"c203": (2, 200, 203), "c2001": (2, 16, 2001), "omic_2001": (8, 1, 2001),
                  "omic_203": (8, 1, 203), "c3": (2, 200, 3), "c1": (2, 200, 1),
                  "omic_c1": (8, 1, 1)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(GENERIC_SHAPES))
def test_fused_kv_project_generic_shapes(rng, dtype, shape):
    """The plain version against JAX's XLA path and its Pallas kernel
    (interpret mode) at the generic route's shapes. f32: sums of up to 2001
    products in another order, 1e-5 relative and 1e-5 of the largest
    output absolute (as the long-latent flash case); bf16 as the bf16 case
    above."""
    b, t, c = GENERIC_SHAPES[shape]
    got, refs = _both_projections(*_proj_inputs(rng, b=b, t=t, c=c), dtype)
    top = max(1.0, float(got.float().abs().max()))
    tol = dict(rtol=1e-5, atol=1e-5 * top) if dtype == "f32" else dict(rtol=2e-2, atol=2e-2)
    for name, ref in refs.items():
        assert tuple(got.shape) == ref.shape, name
        _close(got, ref, **tol)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("b,t,c", [(2, 200, 203), (8, 1, 2040), (2, 16, 2001)],
                         ids=["c203", "omic_2040", "c2001"])
def test_quantized_projection_generic_shapes(rng, out, b, t, c):
    """int8 rows whose pitch is not a multiple of 16 bytes, the plain
    version against JAX's XLA path and Pallas kernel (interpret mode): f32
    to 1e-5, bf16 to two bf16 ulps of outputs of magnitude ~1-4 (2e-2)."""
    q = rng.integers(-127, 128, size=(b, t, c)).astype(np.int8)
    sc = rng.uniform(0.005, 0.05, size=(b, t)).astype(np.float32)
    _, enc, w, bias = _proj_inputs(rng, b=b, t=t, c=c)
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
    jargs = (JaxQC(jnp.asarray(q), jnp.asarray(sc)), jnp.asarray(enc), jnp.asarray(w),
             jnp.asarray(bias))
    refs = {"xla": jproject(*jargs, impl="xla", out_dtype=jd),
            "pallas": jproject(*jargs, impl="pallas", interpret=True, tile=128, out_dtype=jd)}
    got = tproject(QuantizedContext(torch.from_numpy(q), torch.from_numpy(sc)),
                   torch.from_numpy(enc), torch.from_numpy(w), torch.from_numpy(bias),
                   out_dtype=td)
    tol = 1e-5 if out == "f32" else 2e-2
    for name, ref in refs.items():
        assert tuple(got.shape) == ref.shape, name
        _close(got, ref, rtol=tol, atol=tol)


def test_split_columns():
    x = torch.arange(2 * 3 * 10, dtype=torch.float32).reshape(2, 3, 10)
    a, b, c = split_columns(x, (4, 4, 2))
    assert torch.equal(torch.cat([a, b, c], dim=-1), x)
    with pytest.raises(ValueError):
        split_columns(x, (4, 4))


# ----------------------------------------------------------- flash attention


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_flash_cross_attention_vs_jax_interpret(rng, dropout):
    q, k, v = _qkv(rng, lkv=384)
    mask = rng.uniform(size=(2, 384)) > 0.3
    scale = 63**-0.5
    seed = seed_from_rng(jax.random.PRNGKey(42)) if dropout else None
    ref = jflash(
        *map(jnp.asarray, (q, k, v)), scale=scale, temperature=0.5,
        kv_mask=jnp.asarray(mask), dropout_rate=dropout, dropout_seed=seed, kv_chunk=128,
    )
    port_seed = None if seed is None else int(np.asarray(seed).view(np.uint32)[0, 0])
    got = tflash(
        *map(torch.from_numpy, (q, k, v)), scale=scale, temperature=0.5,
        kv_mask=torch.from_numpy(mask), dropout_rate=dropout, dropout_seed=port_seed,
    )
    # online softmax (JAX kernel) against materialised weights (the port's
    # plain version): the JAX package's own flash tests hold this pair to
    # 2e-5
    _close(got, ref, rtol=2e-5, atol=2e-5)
    if dropout:
        nodrop = tflash(*map(torch.from_numpy, (q, k, v)), scale=scale,
                        kv_mask=torch.from_numpy(mask))
        assert float((got - nodrop).abs().max()) > 1e-3


def _flash_case(rng, case):
    """q, k, v, mask, seed and rate of a backward case, f32, lkv = 256."""
    q, k, v = _qkv(rng, lkv=256)
    mask = rng.uniform(size=(2, 256)) > 0.3
    if case == "unmasked":
        mask = None
    if case == "fully_masked_row":
        mask[1] = False
    rate = 0.3 if case == "dropout" else 0.0
    seed = seed_from_rng(jax.random.PRNGKey(7)) if rate else None
    return q, k, v, mask, seed, rate


@pytest.mark.parametrize("case", ["unmasked", "masked", "fully_masked_row", "dropout"])
def test_flash_gradients_vs_jax_interpret(rng, case):
    """The flash Function (plain forward and backward on the CPU), the plain
    backward alone, and the CPU path's autograd, against ``jax.grad`` of the
    JAX flash kernel in interpret mode; same hash seed. f32, 1e-5."""
    q, k, v, mask, seed, rate = _flash_case(rng, case)
    g = rng.normal(size=(2, 17, 2 * 63)).astype(np.float32)
    scale, eff = 63**-0.5, 63**-0.5 / 0.5
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(q_, k_, v_):
        out = jflash(q_, k_, v_, scale=scale, temperature=0.5, kv_mask=jmask,
                     dropout_rate=rate, dropout_seed=seed, kv_chunk=128)
        return jnp.sum(out * jnp.asarray(g))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    port_seed = 0 if seed is None else int(np.asarray(seed).view(np.uint32)[0, 0])
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    tg = torch.from_numpy(g)

    out = FlashAttentionFunction.apply(tq, tk, tv, tmask, eff, rate, port_seed)
    fn_grads = torch.autograd.grad(out, (tq, tk, tv), tg)
    assert all(x is not None for x in fn_grads)
    path_out = tflash(tq, tk, tv, scale=scale, kv_mask=tmask, dropout_rate=rate,
                      dropout_seed=port_seed if rate else None)
    path_grads = torch.autograd.grad(path_out, (tq, tk, tv), tg)
    with torch.no_grad():
        do = tg.reshape(2, 17, 2, 63).transpose(1, 2)
        delta = (do * out.reshape(2, 17, 2, 63).transpose(1, 2)).sum(-1)
        lse = flash_lse_plain(tq, tk, tmask, eff)
        plain = flash_backward_plain(tq, tk, tv, tmask, do, lse, delta, eff, rate, port_seed)
    for grads in (fn_grads, path_grads, plain):
        for got, want in zip(grads, ref):
            _close(got, want, rtol=1e-5, atol=1e-5)
    if case == "fully_masked_row":
        assert float(fn_grads[0][1].abs().max()) == 0.0
        assert float(fn_grads[1][1].abs().max()) == 0.0


@pytest.mark.parametrize("max_cluster", [8, 16])
@pytest.mark.parametrize("rows,lkv", [(8, 4096), (8, 1), (8, 17), (24, 17), (64, 4096),
                                      (2, 1000)])
def test_flash_plan_covers_every_key_once(rows, lkv, max_cluster):
    """The tensor-core kernels' launch plan on a 132-SM card: block r of a
    row's cluster owns keys [r * per, (r + 1) * per) clipped to lkv. Every
    key is owned exactly once, every block owns at least one, ranges are
    whole 64-key tiles, and the cluster fits the largest resident one."""
    cluster, per = flash_plan(rows, lkv, 132, max_cluster)
    assert 1 <= cluster <= max_cluster and per % 64 == 0
    owned = np.concatenate([np.arange(r * per, min(lkv, (r + 1) * per)) for r in range(cluster)])
    np.testing.assert_array_equal(owned, np.arange(lkv))
    assert (cluster - 1) * per < lkv
    if lkv <= 64:
        assert cluster == 1
    if (rows, lkv) == (8, 4096):  # the brca shape fills the card: 8 x 16 blocks
        assert cluster == max_cluster


@pytest.mark.parametrize("max_cluster", [4, 13, 16])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 63), (torch.float32, 27),
                                     (torch.float32, 256), (torch.bfloat16, 160)])
@pytest.mark.parametrize("rows,lkv", [(8, 4096), (8, 1), (8, 33), (64, 4096), (2, 1000)])
def test_fma_plan_covers_every_key_once(rows, lkv, dtype, d, max_cluster):
    """The FMA kernels' launch plan (``flash_plan`` in their 32-key tiles)
    on a 132-SM card: every key
    owned by exactly one block of the row's cluster, no block without keys,
    ranges of whole tiles, the cluster within its limit; one block at the
    omic vector's single key; brca fills the card."""
    tile = key_tile(dtype, d)
    assert flash_variant(dtype, d) == "fma" and tile == 32
    cluster, per = flash_plan(rows, lkv, 132, max_cluster, tile)
    assert 1 <= cluster <= max_cluster and per % tile == 0
    owned = np.concatenate([np.arange(r * per, min(lkv, (r + 1) * per)) for r in range(cluster)])
    np.testing.assert_array_equal(owned, np.arange(lkv))
    assert all(r * per < lkv for r in range(cluster))
    if lkv <= tile:
        assert cluster == 1
    if (rows, lkv) == (8, 4096):
        assert cluster == max_cluster


@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 63, "tc"), (torch.bfloat16, 27, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 129, "fma"), (torch.bfloat16, 160, "fma"), (torch.float32, 63, "fma"),
    (torch.float32, 16, "fma")])
def test_flash_variant_rule(dtype, d, variant):
    """bf16 with d <= 128 takes the tensor-core kernels; f32 (no TF32) and
    wider bf16 heads the FMA kernels, by dtype and d alone."""
    assert flash_variant(dtype, d) == variant


@pytest.mark.parametrize("align", [1, 32])
@pytest.mark.parametrize("max_rows", [32, 64, 96, 110, 171, 192])
def test_query_chunks_cover_every_query_once(max_rows, align):
    """The flash kernels' query chunks: the fewest that fit a block (at most
    max_rows, a multiple of align), chunk i holding [i * chunk, min(lq,
    (i + 1) * chunk)), none empty; one chunk wherever lq fits (brca's 17)."""
    cap = max_rows // align * align
    for lq in list(range(1, 300, 7)) + [17, 64, 128, 130, 256, 1000]:
        n, chunk = query_chunks(lq, max_rows, align)
        assert chunk % align == 0 and 1 <= chunk <= cap
        assert (n - 1) * chunk < lq <= n * chunk
        assert n == -(-lq // cap)
        if lq <= cap:
            assert n == 1


def test_query_chunks_refuse_a_block_without_room():
    with pytest.raises(ValueError):
        query_chunks(17, 31, 32)
    with pytest.raises(ValueError):
        query_chunks(17, 0, 1)


@pytest.mark.parametrize("lq", [17, 130])
def test_flash_plain_vs_jax_at_kirp_head(rng, lq):
    """kirp's head dim 27, f32: the port's plain forward (with its
    log-sum-exp) and plain backward against the JAX flash kernel in
    interpret mode, forward and ``jax.grad``, at lq 17 and past a chunk
    (130); masked with a fully masked row, dropout 0.318 with one hash
    seed: 2e-5 forward, 1e-5 gradients."""
    b, h, lkv, d, rate = 2, 1, 300, 27, 0.318
    q, k, v = _qkv(rng, b=b, h=h, lq=lq, lkv=lkv, d=d)
    mask = rng.uniform(size=(b, lkv)) > 0.3
    mask[1] = False
    g = rng.normal(size=(b, lq, h * d)).astype(np.float32)
    scale, eff = d**-0.5, d**-0.5 / 0.5
    seed = seed_from_rng(jax.random.PRNGKey(3))
    port_seed = int(np.asarray(seed).view(np.uint32)[0, 0])

    def jfwd(q_, k_, v_):
        return jflash(q_, k_, v_, scale=scale, temperature=0.5, kv_mask=jnp.asarray(mask),
                      dropout_rate=rate, dropout_seed=seed, kv_chunk=128)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = jfwd(jq, jk, jv)
    ref_grads = jax.grad(lambda *a: jnp.sum(jfwd(*a) * jnp.asarray(g)), argnums=(0, 1, 2))(
        jq, jk, jv)
    tq, tk, tv, tmask = map(torch.from_numpy, (q, k, v, mask))
    out = tflash(tq, tk, tv, scale=scale, kv_mask=tmask, dropout_rate=rate,
                 dropout_seed=port_seed)
    _close(out, ref, rtol=2e-5, atol=2e-5)
    do = torch.from_numpy(g).reshape(b, lq, h, d).transpose(1, 2)
    delta = (do * out.reshape(b, lq, h, d).transpose(1, 2)).sum(-1)
    lse = flash_lse_plain(tq, tk, tmask, eff)
    got = flash_backward_plain(tq, tk, tv, tmask, do, lse, delta, eff, rate, port_seed)
    for a, r in zip(got, ref_grads):
        _close(a, r, rtol=1e-5, atol=1e-5)
    assert float(got[0][1].abs().max()) == 0.0 and float(out[1].abs().max()) == 0.0


@pytest.mark.parametrize("lq", [130, 256])
def test_flash_backward_plain_vs_jax_at_long_latents(rng, lq):
    """Latent counts past the card kernels' shared-memory table: the port's
    plain backward (the formulas its chunked kernels keep) against the JAX
    backward kernel in interpret mode, called directly as the JAX wrapper
    calls it (queries padded to 16). d 96, f32, a fully masked row, dropout
    0.3 with one hash seed: 1e-5."""
    b, h, lkv, d, rate = 2, 1, 256, 96, 0.3
    q, k, v = _qkv(rng, b=b, h=h, lq=lq, lkv=lkv, d=d)
    do = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    mask = rng.uniform(size=(b, lkv)) > 0.3
    mask[1] = False
    eff, seed = d**-0.5 / 0.5, 0x2545F491
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tmask = torch.from_numpy(mask)
    lse = flash_lse_plain(tq, tk, tmask, eff)
    out = tatt.multihead_attention(tq, tk, tv, scale=eff, temperature=1.0, kv_mask=tmask,
                                   dropout_rate=rate, dropout_seed=seed)[0]
    delta = (tdo * out.reshape(b, lq, h, d).transpose(1, 2)).sum(-1)
    got = flash_backward_plain(tq, tk, tv, tmask, tdo, lse, delta, eff, rate, seed)

    lq_p = -(-lq // 16) * 16
    pad = lambda x: np.pad(np.asarray(x, np.float32).reshape(b * h, lq, -1),
                           ((0, 0), (0, lq_p - lq), (0, 0)))
    jmask = np.repeat(mask.astype(np.float32)[:, None, :], h, axis=1).reshape(b * h, 1, lkv)
    dq, dk, dv = jflash_bwd_call(
        jnp.asarray(pad(q)), jnp.asarray(k.reshape(b * h, lkv, d)),
        jnp.asarray(v.reshape(b * h, lkv, d)), jnp.asarray(jmask), jnp.asarray(pad(do)),
        jnp.asarray(pad(lse.numpy()[..., None])), jnp.asarray(pad(delta.numpy()[..., None])),
        jnp.asarray(np.array([[seed]], np.uint32)), eff, 128, True, rate)
    want = (np.asarray(dq)[:, :lq], np.asarray(dk), np.asarray(dv))
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        top = max(1.0, float(np.abs(r).max()))
        _close(a.reshape(r.shape), r, rtol=1e-5, atol=1e-5 * top)
    assert float(got[0][1].abs().max()) == 0.0 and float(got[1][1].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,d,variant,tile,counter", [
    (torch.float32, 256, "fma", 32, "launches_fma"),
    (torch.bfloat16, 256, "fma", 32, "launches_fma"),
    (torch.float32, 257, "wide", 16, "launches_wide_fma"),
    (torch.bfloat16, 257, "wide", 32, "launches_wide_tc"),
    (torch.float32, 320, "wide", 16, "launches_wide_fma"),
    (torch.bfloat16, 320, "wide", 32, "launches_wide_tc"),
    (torch.float32, 512, "wide", 16, "launches_wide_fma"),
    (torch.bfloat16, 512, "wide", 32, "launches_wide_tc"),
    (torch.float32, 513, "panels", 16, "launches_panel_fma"),
    (torch.bfloat16, 513, "panels", 32, "launches_panel_tc"),
    (torch.float32, 1024, "panels", 16, "launches_panel_fma"),
    (torch.float32, 576, "panels", 16, "launches_panel_fma"),
    (torch.bfloat16, 576, "panels", 32, "launches_panel_tc"),
    (torch.float32, 3100, "panels", 16, "launches_panel_fma"),
    (torch.bfloat16, 8200, "panels", 32, "launches_panel_tc")])
def test_flash_wide_route_rule(dtype, d, variant, tile, counter):
    """Heads of 257-512 take the one-pass wide kernels (32-key tiles in
    bf16, 16 in f32), wider heads the same kernels over panels (in the same
    tiles; past one pass of panels too), by dtype and d alone; 256 stays on
    the FMA kernels. Each kernel has its own launch counter on both
    wrappers. The launch plan covers every key once in the route's tiles,
    its cluster a multiple of the head's panels."""
    assert flash_variant(dtype, d) == variant and key_tile(dtype, d) == tile
    assert launch_counter(dtype, d) == counter and counter in LAUNCH_COUNTERS
    assert all(getattr(fn, name) >= 0 for fn in (flash_attention_kernel,
                                                 flash_attention_bwd_kernel)
               for name in LAUNCH_COUNTERS)
    panels = flash_panels(dtype, d).count
    for backward in (False, True):
        pan = flash_panels(dtype, d, backward)
        assert (pan.count > 1 or pan.passes > 1) == (variant == "panels")
    cluster, per = flash_plan(8, 4096, 132, 8, key_tile(dtype, d), panels)
    ranges = cluster // panels
    assert cluster % panels == 0 and per % tile == 0
    assert (ranges - 1) * per < 4096 <= ranges * per


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("d", [1, 63, 257, 512, 513, 576, 600, 1000, 1024, 1025, 2000, 3072,
                               3073, 3100, 5000, 8192, 8200, 20000])
def test_flash_panels_cover_every_column_once(dtype, d, backward):
    """The wide kernels' panels: one for d <= 512; ceil(d / 512) past it
    (ceil(d / 480) for the bf16 backward) in one pass up to ``_PANEL_MAX``,
    then the fewest passes of at most that many; every column in exactly
    one panel, in order, each panel at most 512 wide and a whole number of
    ``kAlign`` units (16 bf16, 32 f32) except the last."""
    pan = flash_panels(dtype, d, backward)
    align = 16 if dtype == torch.bfloat16 else 32
    width = _BF16_BWD_PANEL_WIDTH if backward and dtype == torch.bfloat16 else 512
    n = 1 if d <= 512 else -(-d // width)
    assert pan.count * pan.passes == len(pan.columns) >= n
    assert 1 <= pan.count <= _PANEL_MAX and pan.count * pan.passes - n < pan.passes
    assert pan.passes == (1 if n <= _PANEL_MAX else -(-n // _PANEL_MAX))
    if d <= 512:
        assert pan == (1, 1, ((0, d),))
    np.testing.assert_array_equal(
        np.concatenate([np.arange(c, c + w) for c, w in pan.columns]), np.arange(d))
    assert all(0 < w <= 512 for _, w in pan.columns)
    assert all(w % align == 0 for _, w in pan.columns[:-1])
    widths = [-(-w // align) for _, w in pan.columns]
    assert max(widths) - min(widths) <= 1  # balanced in units
    if d == 576:
        assert pan.columns == ((0, 288), (288, 288))


@pytest.mark.parametrize("panels", [1, 2, 3, 6])
@pytest.mark.parametrize("max_cluster", [6, 8, 12, 16])
@pytest.mark.parametrize("rows,lkv", [(8, 4096), (8, 1), (8, 17), (64, 4096), (2, 1000),
                                      (8, 100)])
def test_flash_plan_with_panels_covers_every_key_once(rows, lkv, max_cluster, panels):
    """The panel kernels' plan: a cluster of ``panels`` blocks for each of
    its key ranges, at most 16 and at most the largest resident multiple
    of ``panels``; block r on panel r % panels of range r // panels; the
    ranges cover every key once in whole 16-key tiles, none empty; one
    range at the omic vector's single key."""
    max_cluster = max_cluster // panels * panels
    cluster, per = flash_plan(rows, lkv, 132, max_cluster, 16, panels)
    assert cluster % panels == 0 and panels <= cluster <= max(max_cluster, panels) <= 16
    ranges = cluster // panels
    assert per % 16 == 0 and all(j * per < lkv for j in range(ranges))
    owned = np.concatenate([np.arange(j * per, min(lkv, (j + 1) * per)) for j in range(ranges)])
    np.testing.assert_array_equal(owned, np.arange(lkv))
    if lkv <= 16:
        assert ranges == 1
    if panels == 1:  # the wide kernels' plan as it was
        assert (cluster, per) == flash_plan(rows, lkv, 132, max_cluster, 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_panel_exchange_fits_at_most_panels(dtype):
    """``_PANEL_MAX`` is the most panels whose exchange slots fit a block
    beside a 512-wide panel (forward, and the backward at a chunk of 16
    queries); one more does not fit the forward. Two backward panels of the
    widest width hold brca's 17 queries in one chunk (bf16: 32 rows, which
    512 would not). The wide route's layouts (one panel) are the kernels'
    of before."""
    bf = dtype == torch.bfloat16
    assert wide_smem(dtype, _BF16_BWD_PANEL_WIDTH if bf else 512, 2, 32 if bf else 17)[0] >= 2
    if dtype == torch.bfloat16:
        assert wide_smem(dtype, 512, 2, 32)[0] == 0
    assert wide_smem(dtype, 512, _PANEL_MAX)[0] >= 2
    assert wide_smem(dtype, 512, _PANEL_MAX, 16)[0] >= 2
    assert wide_smem(dtype, 512, _PANEL_MAX + 1)[0] == 0
    assert wide_smem(dtype, 288, 2)[0] >= 2 and wide_smem(dtype, 288, 2, 16)[0] >= 2
    # one panel at d 320 and 512: three stages, and two aliased, as before
    assert wide_smem(dtype, 320)[:2] == (3, 0) and wide_smem(dtype, 512)[:2] == (2, 1)


@pytest.mark.parametrize("rows,want", [(8, 9), (7, 16), (9, 9), (10, 8), (16, 6), (133, 1)])
def test_wide_cluster_is_the_largest_resident(rows, want):
    """The wide kernels' clusters may take any size up to 16: the plan takes
    the largest of which every row's cluster is resident (here the card's
    table at one block an SM: 7 clusters of 10-16, 9 of 9, 15 of 8)."""
    resident = {16: 7, 15: 7, 14: 7, 13: 7, 12: 7, 11: 7, 10: 7, 9: 9, 8: 15, 7: 15, 6: 17,
                5: 22, 4: 30, 3: 39, 2: 66, 1: 132}
    key = ("test_wide", rows)
    try:
        assert _max_cluster(resident.get, key, rows, _WIDE_CLUSTER_SIZES) == want
        cluster, per = flash_plan(rows, 4096, 132, want, 32)
        assert cluster <= want and (cluster - 1) * per < 4096 <= cluster * per
    finally:
        _RESIDENT.pop(key, None)


@pytest.mark.parametrize("d", [257, 320, 512, 576, 600])
def test_flash_plain_vs_jax_at_wide_heads(rng, d):
    """Heads wider than 256 (the card's one-pass wide kernels up to 512,
    panel kernels past it; 600 splits into panels of 288 and 312 in f32):
    the port's plain forward, log-sum-exp and backward against the JAX
    kernels ``_fwd_call`` / ``_bwd_call`` in interpret mode, as the JAX
    wrapper calls them (queries padded to 16). f32, lq 17, a fully masked
    row, dropout 0.083 with one hash seed: 2e-5 forward, 1e-5 of the
    largest gradient."""
    b, h, lq, lkv, rate = 2, 1, 17, 256, 0.083
    q, k, v = _qkv(rng, b=b, h=h, lq=lq, lkv=lkv, d=d)
    do = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    mask = rng.uniform(size=(b, lkv)) > 0.3
    mask[1] = False
    eff, seed = d**-0.5 / 0.5, 0x2545F491
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tmask = torch.from_numpy(mask)
    out = tatt.multihead_attention(tq, tk, tv, scale=eff, temperature=1.0, kv_mask=tmask,
                                   dropout_rate=rate, dropout_seed=seed)[0]
    lse = flash_lse_plain(tq, tk, tmask, eff)
    delta = (tdo * out.reshape(b, lq, h, d).transpose(1, 2)).sum(-1)
    got = flash_backward_plain(tq, tk, tv, tmask, tdo, lse, delta, eff, rate, seed)

    lq_p = -(-lq // 16) * 16
    pad = lambda x: np.pad(np.asarray(x, np.float32).reshape(b * h, lq, -1),
                           ((0, 0), (0, lq_p - lq), (0, 0)))
    jk, jv = jnp.asarray(k.reshape(b * h, lkv, d)), jnp.asarray(v.reshape(b * h, lkv, d))
    jmask = jnp.asarray(mask.astype(np.float32).reshape(b * h, 1, lkv))
    jseed = jnp.asarray(np.array([[seed]], np.uint32))
    ref_out, ref_lse = jflash_fwd_call(jnp.asarray(pad(q)), jk, jv, jmask, jseed, eff, 128, True,
                                       rate)
    _close(out.reshape(b, lq, d), np.asarray(ref_out)[:, :lq], rtol=2e-5, atol=2e-5)
    valid = ~np.repeat(~mask.any(-1), lq).reshape(b, lq)  # the fully masked row's lse differs
    np.testing.assert_allclose(lse.numpy().reshape(b, lq)[valid],
                               np.asarray(ref_lse)[:, :lq, 0][valid], rtol=1e-5, atol=1e-5)
    dq, dk, dv = jflash_bwd_call(
        jnp.asarray(pad(q)), jk, jv, jmask, jnp.asarray(pad(do)),
        jnp.asarray(pad(lse.numpy()[..., None])), jnp.asarray(pad(delta.numpy()[..., None])),
        jseed, eff, 128, True, rate)
    want = (np.asarray(dq)[:, :lq], np.asarray(dk), np.asarray(dv))
    for a, r in zip(got, want):
        top = max(1.0, float(np.abs(r).max()))
        _close(a.reshape(r.shape), r, rtol=1e-5, atol=1e-5 * top)
    assert float(out[1].abs().max()) == 0.0 and float(got[0][1].abs().max()) == 0.0


@pytest.mark.parametrize("lkv", [256, 1])
def test_flash_backward_plain_in_f64(rng, lkv):
    """The plain backward computes in f64 for f64 inputs (the reference the
    card check holds the f32 kernels to) and agrees with itself in f32: 1e-5
    of the call's largest gradient (at one key p = 1, and dq and dk are the
    f32 rounding residue of dp * e - delta), zero for a fully masked row."""
    b, h, lq, d, rate, seed = 2, 1, 17, 320, 0.083, 0x2545F491
    q, k, v = _qkv(rng, b=b, h=h, lq=lq, lkv=lkv, d=d)
    do = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    mask = np.ones((b, lkv), bool)
    mask[1] = False
    eff, tmask = d**-0.5 / 0.5, torch.from_numpy(mask)
    got = {}
    for dt in (torch.float32, torch.float64):
        tq, tk, tv, tdo = (torch.from_numpy(x).to(dt) for x in (q, k, v, do))
        out = tatt.multihead_attention(tq, tk, tv, scale=eff, temperature=1.0, kv_mask=tmask,
                                       dropout_rate=rate, dropout_seed=seed)[0]
        delta = (tdo * out.reshape(b, lq, h, d).transpose(1, 2)).sum(-1)
        got[dt] = flash_backward_plain(tq, tk, tv, tmask, tdo, flash_lse_plain(tq, tk, tmask, eff),
                                       delta, eff, rate, seed)
    assert all(g.dtype == torch.float64 for g in got[torch.float64])
    top = max(float(g.abs().max()) for g in got[torch.float64])
    for a, r in zip(got[torch.float32], got[torch.float64]):
        _close(a, r.numpy(), rtol=1e-5, atol=1e-5 * max(1.0, top))
        assert float(r[1].abs().max()) == 0.0


# ----------------------------------------------------- the projection kernels


@pytest.mark.parametrize("dtype,cdt,c,offset,route", [
    (torch.bfloat16, torch.bfloat16, 2048, 0, "tma"),
    (torch.bfloat16, torch.bfloat16, 2000, 0, "tma"),
    (torch.bfloat16, torch.bfloat16, 1024, 256, "tma"),
    (torch.int8, torch.bfloat16, 2048, 0, "tma"),
    (torch.int8, torch.bfloat16, 2000, 0, "tma"),
    (torch.int8, torch.bfloat16, 1024, 16, "tma"),
    (torch.bfloat16, torch.bfloat16, 203, 0, "generic"),
    (torch.bfloat16, torch.bfloat16, 2048, 2, "generic"),
    (torch.int8, torch.bfloat16, 200, 0, "generic"),
    (torch.int8, torch.bfloat16, 2048, 8, "generic"),
    (torch.bfloat16, torch.bfloat16, 3, 0, "generic"),
    (torch.bfloat16, torch.bfloat16, 2001, 0, "generic"),
    (torch.bfloat16, torch.bfloat16, 4095, 0, "generic"),
    (torch.int8, torch.float32, 2048, 0, "f32"),
    (torch.float32, torch.float32, 2048, 0, "f32"),
])
def test_project_route(dtype, cdt, c, offset, route):
    """The Hopper kernel takes bf16 compute over bf16 or int8 rows that TMA
    can describe (16-byte aligned base and row pitch), the f32 kernel every
    f32 compute; the rest is generic."""
    assert project_route(dtype, cdt, c, 0x7F0000000000 + offset) == route


@pytest.mark.parametrize("m,f,itemsize", [
    (32768, 252, 2), (32768, 270, 2), (32768, 252, 1), (32768, 270, 1),
    (8192, 252, 2), (8, 252, 2), (2100, 300, 2), (600, 70, 2),
    (32768, 600, 2), (32768, 2000, 1), (129, 321, 2), (1, 8, 2)])
def test_project_plan(m, f, itemsize):
    """The Hopper kernel's plan: one column pass up to 272 columns (so each
    context row is read once at brca, kirp and trimodal), tiles of 128 rows,
    a ring that fills but fits shared memory, and the epilogue's rows staged
    in a held ring stage only where their own region would cost a stage."""
    plan = project_plan(m, f, itemsize)
    assert plan.n_col == -(-f // 272) and plan.nb in PROJECT_WIDTHS
    assert plan.nb * plan.n_col >= f and plan.nb >= -(-f // plan.n_col)
    assert (plan.n_col - 1) * plan.nb < f  # no column pass starts past F
    assert plan.row_tiles == -(-m // 128)
    assert plan.pitch == (f + f % 2 if plan.n_col == 1 else plan.nb)
    assert 2 <= plan.stages <= 4 and plan.smem <= 232448
    smem = lambda stages, held: project_smem(plan.nb, itemsize, stages, plan.pitch, held)
    assert plan.smem == smem(plan.stages, plan.held_staging)
    if plan.stages < 4:  # no deeper ring fits, even with the rows staged in a held stage
        assert smem(plan.stages + 1, True) > 232448
    if plan.held_staging:  # a region of their own would have cost this stage
        assert smem(plan.stages, False) > 232448
    # the 8 warps' 8 staged rows fit in a ring stage, as the kernel checks
    assert 8 * 8 * plan.pitch * 2 <= 128 * 64 * itemsize + plan.nb * 64 * 2
    if f in (252, 270):  # brca / trimodal and kirp: one pass over the context
        assert plan.n_col == 1 and plan.nb == (256 if f == 252 else 272)
    if (m, f) == (32768, 270):  # kirp: the held stage buys its fourth stage
        assert plan.stages == 4 and plan.held_staging


@pytest.mark.parametrize("itemsize", [2, 1])
@pytest.mark.parametrize("m", [8, SPLIT_MAX_ROWS, SPLIT_MAX_ROWS + 1, 32768])
def test_project_generic_plan(m, itemsize):
    """The generic route's plan at every C from 1 to 70: few rows on the
    split kernel (every k-slice in one block of a cluster of at most 16, no
    block without one, every column and row in a block), more on the Hopper
    kernel's hull kinds (one row class per offset mod 16 bytes, each with a
    row of every tile), within a block's shared memory; each path names its
    kernel's launch counter."""
    for c in range(1, 71):
        plan = project_generic_plan(m, c, 252, itemsize)
        nk = -(-c // 64)
        assert plan.classes == 16 // math.gcd(c * itemsize, 16)
        assert plan.smem <= 232448
        if m <= SPLIT_MAX_ROWS:
            assert plan.path == "split" and plan.rows is None
            assert plan.counter == "launches_generic_split"
            assert 1 <= plan.cluster <= 16
            assert plan.cluster * plan.slices >= nk > (plan.cluster - 1) * plan.slices
            assert plan.col_groups * 64 >= 252 > (plan.col_groups - 1) * 64
            assert plan.row_groups * 8 >= m > (plan.row_groups - 1) * 8
            assert plan.smem == SPLIT_SMEM
        else:
            assert plan.path == "rows" and plan.counter == "launches_generic"
            assert plan.rows == project_plan(m, 252, itemsize, hull=True)
            assert plan.smem == plan.rows.smem == project_smem(
                plan.rows.nb, itemsize, plan.rows.stages, plan.rows.pitch,
                plan.rows.held_staging, hull=True)
            assert m >= plan.classes and 128 % plan.classes == 0


def test_project_generic_plan_at_the_parity_layout():
    """The parity layout's omic vector (8, 1, 2001) takes clusters of 16
    blocks of two k-slices over 4 column blocks; its slide (8, 2048, 4095)
    the hull kinds: 8 row classes, one column pass of 256, 3 stages."""
    omic = project_generic_plan(8, 2001, 252, 2)
    assert (omic.path, omic.cluster, omic.slices, omic.col_groups, omic.row_groups) == (
        "split", 16, 2, 4, 1)
    wsi = project_generic_plan(8 * 2048, 4095, 252, 2)
    assert (wsi.path, wsi.classes, wsi.rows.nb, wsi.rows.n_col, wsi.rows.stages) == (
        "rows", 8, 256, 1, 3)
    with pytest.raises(ValueError):
        project_generic_plan(8, 2001, 252, 4)


# (m, c, f, itemsize) -> the f32 kernel's plan (nb, n_col, row_tiles, nk,
# stages, smem): brca and kirp (f32 and int8) in one pass of 256 / 272
# columns, the omic vector in four blocks of 64, smaller calls spread over
# more passes, shared memory as the kernel lays it out
F32_PLANS = {
    (32768, 2048, 252, 4): (256, 1, 256, 64, 3, 186368),
    (32768, 2048, 270, 4): (272, 1, 256, 64, 3, 192512),
    (32768, 2048, 252, 1): (256, 1, 256, 64, 4, 188416),
    (32768, 2000, 270, 1): (272, 1, 256, 63, 4, 196608),
    (8, 2000, 252, 4): (64, 4, 1, 63, 3, 112640),
    (8192, 1024, 252, 4): (128, 2, 64, 32, 3, 137216),
    (387, 203, 70, 4): (64, 2, 4, 7, 3, 112640),
    (387, 203, 600, 1): (64, 10, 4, 7, 4, 90112),
    (600, 64, 2100, 4): (128, 17, 5, 2, 3, 137216),
    (32768, 2048, 70, 4): (128, 1, 256, 64, 3, 137216),
    (1, 1, 1, 4): (64, 1, 1, 1, 3, 112640),
}


@pytest.mark.parametrize("m,c,f,itemsize", list(F32_PLANS))
def test_project_f32_plan(m, c, f, itemsize):
    """The f32 kernel's plan at brca, kirp, the omic vector and ragged
    shapes, within a block's shared memory (less the kernel's static 4 KB)."""
    plan = project_f32_plan(m, c, f, itemsize, sms=132)
    assert tuple(plan) == F32_PLANS[(m, c, f, itemsize)]
    assert plan.smem <= 232448 - 4096


def test_project_f32_plan_refuses_bf16():
    with pytest.raises(ValueError):
        project_f32_plan(8, 64, 64, 2)


# (b, t, f, itemsize, base offset) -> the backward kernel's plan (vec, w,
# tokens, grid_x, grid_y, groups): brca bf16 8-byte and f32 16-byte
# vectors, kirp's 540-byte rows 4-byte ones, one block an SM (132) in 9
# groups of 16, one token tile (one block) for a one-token context at any
# batch, two column chunks past 512 threads a row, narrower vectors at a
# less aligned base
BWD_PLANS = {
    (8, 4096, 252, 2, 0): (4, 64, 16, 132, 1, 9),
    (8, 4096, 270, 2, 0): (2, 160, 12, 132, 1, 9),
    (8, 4096, 252, 4, 0): (4, 64, 8, 132, 1, 9),
    (8, 4096, 270, 4, 0): (2, 160, 6, 132, 1, 9),
    (8, 1, 252, 2, 0): (4, 64, 16, 1, 1, 1),
    (5000, 1, 252, 2, 0): (4, 64, 16, 1, 1, 1),
    (3, 129, 2100, 4, 0): (4, 512, 1, 66, 2, 10),
    (2, 300, 71, 2, 0): (1, 96, 20, 15, 1, 1),
    (8, 4096, 252, 2, 4): (2, 128, 16, 132, 1, 9),
    (8, 4096, 252, 4, 8): (2, 128, 8, 132, 1, 9),
}


@pytest.mark.parametrize("b,t,f,itemsize,offset", list(BWD_PLANS))
def test_project_bwd_plan(b, t, f, itemsize, offset):
    """The backward kernel's plan at brca, kirp, the omic context, batch
    5000, two column chunks and misaligned bases."""
    plan = project_bwd_plan(b, t, f, itemsize, 0x7F0000000000 + offset, 132)
    assert tuple(plan) == BWD_PLANS[(b, t, f, itemsize, offset)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_project_bwd_plain_vs_jax_kernel(rng, dtype):
    """The cotangent pass against the JAX backward kernel (interpret mode),
    called directly: d_raw and dsum2 = [sum g; sum inv * mu * g]."""
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    b, t, f, d_total = 2, 256, 252, 261
    g = rng.normal(size=(b, t, f)).astype(np.float32)
    x = rng.normal(size=(b, t, d_total)).astype(np.float32) * 1.5 + 0.3
    s1, s2 = x.sum(-1), (x * x).sum(-1)
    jg = jnp.pad(jnp.asarray(g, jd), ((0, 0), (0, 0), (0, 4)))  # F padded to 256 lanes
    ref_raw, ref_sum = jproject_bwd_call(jg, jnp.asarray(s1), jnp.asarray(s2), None, d_total,
                                         1e-5, 128, True, False, jd)
    d_raw, dsum2 = project_bwd_plain(torch.from_numpy(g).to(td), torch.from_numpy(s1),
                                     torch.from_numpy(s2), d_total, 1e-5)
    assert d_raw.dtype == td
    # d_raw rounds inv * g once in both: equal in f32, at most one bf16 ulp
    # apart (the rsqrt may differ in its last f32 bit)
    tol = (1e-6, 1e-6) if dtype == "f32" else (8e-3, 1e-6)
    _close(d_raw, np.asarray(ref_raw[..., :f], np.float32), rtol=tol[0], atol=tol[1])
    # sums of 512 terms in another order
    _close(dsum2, np.asarray(ref_sum[:, :f]), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["enc", "no_enc", "params_only"])
def test_projection_function_vjp_vs_jax(rng, case):
    """FusedProjectFunction's gradients (plain versions on the CPU) against
    ``jax.vjp`` of the JAX projection; d_dat / d_enc only when asked for."""
    dat, enc, w, bias = _proj_inputs(rng, t=128, c=64, e=0 if case == "no_enc" else 10, f=70)
    g = rng.normal(size=(2, 128, 70)).astype(np.float32)
    jenc = None if enc is None else jnp.asarray(enc)
    _, vjp = jax.vjp(
        lambda d_, e_, w_, b_: jproject(d_, e_, w_, b_, impl="pallas", interpret=True, tile=128),
        jnp.asarray(dat), jenc, jnp.asarray(w), jnp.asarray(bias))
    ref = vjp(jnp.asarray(g))
    inputs = [torch.from_numpy(a) if a is not None else None for a in (dat, enc, w, bias)]
    for i, x in enumerate(inputs):
        if x is not None and (case != "params_only" or i >= 2):
            x.requires_grad_()
    out = FusedProjectFunction.apply(*inputs, 1e-5)
    out.backward(torch.from_numpy(g))
    for name, x, want in zip(("dat", "enc", "w", "bias"), inputs, ref):
        if x is None:
            continue
        if not x.requires_grad:
            assert x.grad is None, name
            continue
        # d_w sums 256 rows of products in another order: entries up to ~50
        # agree to f32 rounding of the largest, so the absolute tolerance
        # scales with it
        top = max(1.0, float(np.abs(np.asarray(want)).max()))
        _close(x.grad, want, rtol=1e-5, atol=1e-6 * top)


# ------------------------------------------------------ devices and imports


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        fused_project_kernel(x, torch.zeros(8, 4), torch.zeros(2, 4), torch.zeros(2, 2),
                             torch.zeros(2, 4), 8, 1e-5)
    with pytest.raises(ValueError):
        fused_project_bwd_kernel(torch.zeros(1, 2, 4), torch.zeros(1, 2), torch.zeros(1, 2), 8)
    q = torch.zeros(1, 1, 2, 4)
    with pytest.raises(ValueError):
        flash_attention_kernel(q, q, q, None, 1.0)
    with pytest.raises(ValueError):
        flash_attention_bwd_kernel(q, q, q, None, q, torch.zeros(1, 1, 2),
                                   torch.zeros(1, 1, 2), 1.0)


def test_resolve_device():
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert tdevice.round_up(17, 16) == 32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdevice.resolve_device()


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import healnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(healnet_tpu_torch.__path__, 'healnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules\n"
        "       if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'healnet_tpu')]\n"
        "print(len([n for n in sys.modules if n.startswith('healnet_tpu_torch')]))\n"
        "assert not bad, bad\n"
        "for name in ('train.loop', 'train.schedule', 'train.losses', 'utils.train_utils'):\n"
        "    assert 'healnet_tpu_torch.' + name in sys.modules, name\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 18
