"""The port's fused latent chain against the JAX package on CPU.

The same numpy inputs (seeded) go through the JAX chain's reference
(``chain_reference``), its Pallas kernel in interpret mode (``_fwd_call``),
the port's plain version (``chain_reference``, which the port's
``fused_latent_chain`` runs for CPU tensors) and, through the port's model
helpers (``project_contexts``, ``stack_chain_weights``, ``chain_spec``), the
JAX ``HealNetModule`` with the same Flax weights.

Tolerances, all at float32: values to 1e-5 (relative and absolute; sums of
the same products in another order); the hash dropout masks are bit-equal,
so dropout moves nothing; gradients to 1e-4 relative / 1e-5 absolute
(reverse-mode sums over many more terms, in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from healnet_tpu.models.healnet import HealNetModule as JaxHealNet
from healnet_tpu.ops import fused_chain as jchain
from healnet_tpu_torch.compat.flax_params import state_dict_from_flax
from healnet_tpu_torch.models.healnet import HealNetModule as TorchHealNet
from healnet_tpu_torch.ops import fused_chain as tchain
from healnet_tpu_torch.ops.hash_dropout import dense_keep_mask, keep_scale
from healnet_tpu_torch.ops.fused_chain import (
    WEIGHT_FIELDS,
    ChainSpec,
    chain_reference,
    chain_spec,
    fused_chain_kernel,
    fused_latent_chain,
    stack_chain_weights,
    weight_shapes,
)

B, L_C, L_D, INNER, MULT = 3, 5, 16, 8, 4
TOKENS = (1, 40)


def _spec(depth=2, act="selu", offsets=None, has_mask=(False, False), attn=0.0, ff=0.0,
          tokens=TOKENS):
    return ChainSpec(
        depth=depth, n_modalities=len(tokens), l_c=L_C, l_d=L_D, inner=INNER, mult=MULT,
        act=act, scale=INNER**-0.5 / 0.5, attn_dropout=attn, ff_dropout=ff,
        tokens=tuple(tokens), offsets=offsets or tuple(2 * INNER * l for l in range(depth)),
        has_mask=tuple(has_mask), out_dtype="float32")


def _operands(rng, spec, masks=None, presence_zeros=False, ff_keep=False):
    """Seeded numpy operands of one chain call: (x0, kvs, masks, ff_keep,
    presence, seeds, weights)."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    width = 2 * INNER * (max(spec.offsets) // (2 * INNER) + 1)
    x0 = f32(B, L_C, L_D)
    kvs = [f32(B, t, width) for t in spec.tokens]
    masks = masks or [None] * spec.n_modalities
    keep = None
    if ff_keep:
        keep = ((rng.uniform(size=(B, spec.sites, L_C, L_D)) > 0.3) / 0.7).astype(np.float32)
    presence = np.ones((B, spec.n_modalities), np.float32)
    if presence_zeros:
        presence[1, 0] = presence[2, 1] = 0.0
    seeds = rng.integers(0, 2**32, size=(spec.depth, spec.n_modalities)).astype(np.uint32)
    weights = []
    for name, shape in zip(WEIGHT_FIELDS, weight_shapes(spec)):
        if name in ("ln1_s", "ln2_s"):
            weights.append((1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32))
        elif name in ("wq", "wout", "w0", "w2"):
            weights.append((rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32))
        else:
            weights.append((0.1 * rng.normal(size=shape)).astype(np.float32))
    return x0, kvs, masks, keep, presence, seeds, weights


def _to_torch(ops, requires_grad=False):
    x0, kvs, masks, keep, presence, seeds, weights = ops
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    leaf = lambda a: t(a).requires_grad_(requires_grad)
    return (leaf(x0), [leaf(kv) for kv in kvs], [t(mk) for mk in masks], t(keep), t(presence),
            torch.from_numpy(seeds.astype(np.int64)), [leaf(w) for w in weights])


def _to_jax(ops):
    x0, kvs, masks, keep, presence, seeds, weights = ops
    j = lambda a: None if a is None else jnp.asarray(a)
    return (j(x0), [j(kv) for kv in kvs], [j(mk) for mk in masks], j(keep), j(presence),
            j(seeds), tuple(j(w) for w in weights))


def _ragged_mask(rng, t, fully_masked_row):
    mask = (np.arange(t)[None, :] < rng.integers(1, t + 1, size=(B, 1))).astype(np.float32)
    if fully_masked_row:
        mask[1] = 0.0
    return mask


CASES = ["no_mask", "ragged_mask", "fully_masked_row", "presence_zeros", "dropout_ff_keep",
         "dropout_no_ff_keep", "tied_offsets"]


def _case(rng, case, act):
    """(spec, numpy operands) of one grid point."""
    masked = case not in ("no_mask", "tied_offsets")
    spec = _spec(
        depth=3 if case == "tied_offsets" else 2, act=act,
        offsets=(0, 2 * INNER, 2 * INNER) if case == "tied_offsets" else None,
        has_mask=(False, masked), attn=0.2 if case.startswith("dropout") else 0.0,
        ff=0.2 if case == "dropout_ff_keep" else 0.0)
    masks = [None, _ragged_mask(rng, TOKENS[1], case != "ragged_mask")] if masked else None
    ops = _operands(rng, spec, masks, presence_zeros=case not in ("no_mask", "ragged_mask"),
                    ff_keep=case == "dropout_ff_keep")
    return spec, ops


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("act", ["selu", "gelu"])
def test_chain_reference_matches_jax_reference_and_kernel(rng, act, case):
    spec, ops = _case(rng, case, act)
    jspec = jchain.ChainSpec(**dataclasses.asdict(spec))
    jops = _to_jax(ops)
    ref = np.asarray(jchain.chain_reference(*jops, jspec))
    pallas = np.asarray(jchain._fwd_call(*jops, jspec, interpret=True))
    got = chain_reference(*_to_torch(ops), spec)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, L_C, L_D)
    for want in (ref, pallas):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if spec.attn_dropout > 0:  # the masks did drop something
        undropped = chain_reference(*_to_torch(ops), dataclasses.replace(spec, attn_dropout=0.0))
        assert float((got - undropped).abs().max()) > 1e-3


@pytest.mark.parametrize("case", ["dropout_ff_keep", "tied_offsets"])
@pytest.mark.parametrize("act", ["selu", "gelu"])
def test_chain_reference_grads_match_jax(rng, act, case):
    spec, ops = _case(rng, case, act)
    cot = rng.normal(size=(B, L_C, L_D)).astype(np.float32)
    if spec.has_mask[1]:
        # at a fully masked row the port's gradients are finite (zero where
        # nothing depends on the input) ...
        tx0, tkvs, tmasks, tkeep, tpres, tseeds, tw = _to_torch(ops, requires_grad=True)
        out = chain_reference(tx0, tkvs, tmasks, tkeep, tpres, tseeds, tw, spec)
        torch.sum(out * torch.from_numpy(cot)).backward()
        assert all(torch.isfinite(t.grad).all() for t in [tx0, *tkvs, *tw])
        # ... where jax.grad of the JAX reference takes 0/0 (the derivative of
        # p / max(sum p, 1e-30) at sum p = 0): that row keeps 5 keys here
        ops[2][1][1, :5] = 1.0
    jspec = jchain.ChainSpec(**dataclasses.asdict(spec))
    x0, kvs, masks, keep, presence, seeds, weights = _to_jax(ops)

    def loss(x0, kvs, weights):
        out = jchain.chain_reference(x0, kvs, masks, keep, presence, seeds, weights, jspec)
        return jnp.sum(out * cot)

    jx0, jkvs, jw = jax.grad(loss, argnums=(0, 1, 2))(x0, kvs, weights)
    tx0, tkvs, tmasks, tkeep, tpres, tseeds, tw = _to_torch(ops, requires_grad=True)
    out = chain_reference(tx0, tkvs, tmasks, tkeep, tpres, tseeds, tw, spec)
    torch.sum(out * torch.from_numpy(cot)).backward()
    pairs = [("x0", tx0, jx0)] + [(f"kv{m}", a, b) for m, (a, b) in enumerate(zip(tkvs, jkvs))]
    pairs += list(zip(WEIGHT_FIELDS, tw, jw))
    for name, t, want in pairs:
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("act", ["selu", "gelu"])
def test_act_grad_is_the_derivative_of_act(act):
    g = torch.linspace(-4, 4, 101, dtype=torch.float64, requires_grad=True)
    tchain._act(g, act).sum().backward()
    torch.testing.assert_close(tchain._act_grad(g.detach(), act), g.grad, rtol=1e-12, atol=1e-12)


# ------------------------------------------------- chain path vs JAX model

# bench.py's rows (one cross head, no latent self-attention), channels and
# tokens cut down, and a tied topology
TOPOLOGIES = {
    "brca": dict(depth=2, l_c=17, l_d=126, cross_dim_head=63, snn=True),
    "kirp": dict(depth=5, l_c=17, l_d=62, cross_dim_head=27, snn=True),
    "trimodal": dict(depth=2, l_c=17, l_d=126, cross_dim_head=63, snn=True, n_modalities=3,
                     channel_dims=(40, 32, 24), num_spatial_axes=(1, 1, 1)),
    "tied": dict(depth=3, l_c=9, l_d=16, cross_dim_head=6, snn=False, weight_tie_layers=True),
}
COMMON = dict(n_modalities=2, channel_dims=(40, 32), num_spatial_axes=(1, 1), out_dims=4,
              num_freq_bands=2, max_freq=2.0, x_heads=1, l_heads=2, latent_dim_head=8,
              self_per_cross_attn=0)
MODEL_TOKENS = (1, 24, 16)


def _model_inputs(rng, n, b=4):
    return [rng.normal(size=(b, t, c)).astype(np.float32)
            for t, c in zip(MODEL_TOKENS[:n], (40, 32, 24))]


def _model_pair(rng, topo, **kw):
    cfg = {**COMMON, **TOPOLOGIES[topo], **kw}
    jmod = JaxHealNet(**cfg, projection_impl="xla")
    x = _model_inputs(rng, cfg["n_modalities"])
    params = jmod.init(jax.random.PRNGKey(0), tuple(map(jnp.asarray, x)))["params"]
    tmod = TorchHealNet(**cfg, device="cpu").eval()
    tmod.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jmod, params, tmod, x


def _chain_path(tmod, x, presence, masks, training=False, seeds=None, ff_keep=None):
    """project_contexts -> fused_latent_chain -> (embeddings, logits)."""
    kvs, cdt = tmod.project_contexts(x)
    spec = chain_spec(tmod, [kv.shape[1] for kv in kvs], [m is not None for m in masks],
                      training=training)
    weights = stack_chain_weights(tmod)
    assert [tuple(w.shape) for w in weights] == list(weight_shapes(spec))
    if seeds is None:
        seeds = torch.zeros((spec.depth, spec.n_modalities), dtype=torch.int64)
    x0 = tmod.latents.to(cdt).expand(x[0].shape[0], tmod.l_c, tmod.l_d)
    emb = fused_latent_chain(x0, kvs, masks, ff_keep, presence, seeds, weights, spec)
    return emb, tmod.final_head(tmod.final_norm(emb.mean(dim=1)))


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_chain_path_matches_jax_model(rng, topo):
    jmod, params, tmod, x = _model_pair(rng, topo)
    n = len(x)
    presence = np.ones((4, n), np.float32)
    presence[1, 0] = presence[2, n - 1] = 0.0
    mask = rng.uniform(size=(4, MODEL_TOKENS[1])) > 0.3
    mask[3] = False  # a sample whose whole bag is masked
    masks = [None, mask] + [None] * (n - 2)
    kw = dict(presence=jnp.asarray(presence),
              kv_masks=tuple(None if m is None else jnp.asarray(m) for m in masks))
    jx = tuple(map(jnp.asarray, x))
    ref_logits = np.asarray(jmod.apply({"params": params}, jx, **kw))
    ref_emb = np.asarray(jmod.apply({"params": params}, jx, return_embeddings=True, **kw))
    with torch.no_grad():
        emb, logits = _chain_path(
            tmod, [torch.from_numpy(a) for a in x], torch.from_numpy(presence),
            [None if m is None else torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(emb.numpy(), ref_emb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("topo", ["kirp", "tied"])
def test_chain_path_dropout_matches_module_in_train_mode(rng, topo):
    """Attention dropout on, FF dropout off: the module in train mode and the
    chain with the seeds the module draws (a clone of its seed generator)."""
    _, _, tmod, x = _model_pair(rng, topo, attn_dropout=0.3)
    tmod.train()
    xt = [torch.from_numpy(a) for a in x]
    mask = torch.from_numpy(rng.uniform(size=(4, MODEL_TOKENS[1])) > 0.3)
    masks = [None, mask] + [None] * (len(x) - 2)
    seed_gen = torch.Generator().manual_seed(11)
    clone = torch.Generator()
    clone.set_state(seed_gen.get_state())
    with torch.no_grad():
        ref = tmod(xt, kv_masks=masks, return_embeddings=True,
                   generator=torch.Generator().manual_seed(0), seed_generator=seed_gen)
        seeds = torch.randint(0, 2**32, (tmod.depth, tmod.n_modalities), generator=clone,
                              dtype=torch.int64)
        emb, _ = _chain_path(tmod, xt, torch.ones((4, len(x))), masks, training=True,
                             seeds=seeds)
        undropped, _ = _chain_path(tmod, xt, torch.ones((4, len(x))), masks)
    torch.testing.assert_close(emb, ref, rtol=1e-5, atol=1e-5)
    assert float((emb - undropped).abs().max()) > 1e-3


@pytest.mark.parametrize("kw", [dict(x_heads=2), dict(self_per_cross_attn=1)],
                         ids=["two_cross_heads", "latent_self_attention"])
def test_chain_helpers_raise_outside_the_scope(kw):
    cfg = {**COMMON, **TOPOLOGIES["tied"], **kw}
    tmod = TorchHealNet(**cfg, device="cpu")
    with pytest.raises(ValueError, match="fused chain covers"):
        stack_chain_weights(tmod)
    with pytest.raises(ValueError, match="fused chain covers"):
        chain_spec(tmod, (1, 24), (False, False))


def test_chain_spec_of_a_tied_module():
    tmod = TorchHealNet(**{**COMMON, **TOPOLOGIES["tied"]}, device="cpu")
    spec = chain_spec(tmod, (1, 24), (False, True), training=False)
    assert spec.offsets == (0, 12, 12) and spec.inner == 6 and spec.mult == 4
    assert spec.act == "gelu" and spec.scale == pytest.approx(6**-0.5 / 0.5)
    assert spec.attn_dropout == spec.ff_dropout == 0.0
    trained = chain_spec(TorchHealNet(**{**COMMON, **TOPOLOGIES["tied"]}, attn_dropout=0.1,
                                      ff_dropout=0.2, device="cpu"), (1, 24), (False, True),
                         training=True)
    assert (trained.attn_dropout, trained.ff_dropout) == (0.1, 0.2)
    w = dict(zip(WEIGHT_FIELDS, stack_chain_weights(tmod)))
    # tied layers repeat their group's weights, the shared cross-FF repeats
    # across modalities, and dense weights are (in, out)
    assert torch.equal(w["wq"][1, 0], w["wq"][2, 0])
    assert torch.equal(w["w0"][1, 0], w["w0"][1, 1]) and torch.equal(w["w0"][2, 1], w["w0"][1, 0])
    assert torch.equal(w["wq"][0, 1], tmod.layer0_cross_attn_m1.fn.to_q.weight.t())


def test_kernel_wrapper_takes_cuda_tensors_only(rng):
    spec = _spec()
    ops = _to_torch(_operands(rng, spec))
    with pytest.raises(ValueError, match="CUDA"):
        fused_chain_kernel(*ops, spec)
    torch.testing.assert_close(fused_latent_chain(*ops, spec), chain_reference(*ops, spec),
                               rtol=0, atol=0)


# ------------------------------------------------------- the launch plan

PLAN_CASES = {  # (batch, tokens, max_cluster) -> (cluster, keys_per_block, chunk), 132 SMs
    "brca_b1": ((1, (1, 4096), 16), (16, (64, 256), 256)),
    "brca_b8": ((8, (1, 4096), 16), (16, (64, 256), 256)),
    "kirp_b8": ((8, (1, 4096), 16), (16, (64, 256), 256)),
    "trimodal_b1": ((1, (1, 4096, 1024), 16), (16, (64, 256, 64), 256)),
    "trimodal_b8": ((8, (1, 4096, 1024), 16), (16, (64, 256, 64), 256)),
    "omic_only": ((8, (1,), 16), (16, (64,), 64)),
    "ragged_1000": ((3, (1, 1000), 16), (16, (64, 64), 64)),
    "ragged_300": ((8, (1, 300), 16), (16, (64, 64), 64)),
    "forced_8": ((8, (1, 4096), 8), (8, (64, 512), 512)),
    "forced_1": ((8, (1, 4096, 1024), 1), (1, (64, 4096, 1024), 512)),
    "batch_40": ((40, (1, 4096), 16), (4, (64, 1024), 512)),
    "batch_132": ((132, (1, 4096), 16), (1, (64, 4096), 512)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_chain_plan(case):
    (batch, tokens, max_cluster), want = PLAN_CASES[case]
    plan = tchain.chain_plan(batch, tokens, 132, max_cluster)
    assert plan == want
    cluster, kpb, chunk = plan
    for t, k in zip(tokens, kpb):
        # the fewest whole tiles that cover the keys; each key owned by one block
        tile = tchain.CHAIN_TILE
        assert k % tile == 0 and t <= cluster * k and (k == tile or cluster * (k - tile) < t)
        owners = [min(t, r * k + k) - min(t, r * k) for r in range(cluster)]
        assert sum(owners) == t and all(n >= 0 for n in owners)
    assert chunk % tchain.CHAIN_TILE == 0 and chunk <= tchain.CHAIN_MAX_CHUNK


# ---------------------- the kernel's key-split merge, emulated in plain torch


def _split_attention(q, k, v, mask, scale, keep, rate, cluster, kpb):
    """The kernel's attention over keys spread on a cluster: each block's
    range gives its rows' (max, sum) ((-inf, 0) when it owns no key), the
    blocks merge them in rank order (skipping -inf), form the dropped
    probabilities from their own scores and sum their partial @V in rank
    order. q (b, lc, d) rounded as the kernel rounds it; k, v (b, t, d)."""
    b, lc, t = q.shape[0], q.shape[1], k.shape[1]
    s = q @ k.transpose(1, 2) * scale
    mk = torch.ones((b, t)) if mask is None else mask.float()
    s = s + (mk[:, None, :] - 1.0) * 1e30
    ranges = [(min(t, r * kpb), min(t, (r + 1) * kpb)) for r in range(cluster)]
    stats = []
    for k0, k1 in ranges:
        if k1 == k0:
            stats.append((torch.full((b, lc), -float("inf")), torch.zeros((b, lc))))
            continue
        mr = s[..., k0:k1].amax(-1)
        stats.append((mr, (torch.exp(s[..., k0:k1] - mr[..., None]) * mk[:, None, k0:k1]).sum(-1)))
    m = stats[0][0]
    for mr, _ in stats[1:]:
        m = torch.maximum(m, mr)
    l = torch.zeros((b, lc))
    for mr, lr in stats:  # rank order
        l = l + torch.where(mr == -float("inf"), torch.zeros_like(lr), lr * torch.exp(mr - m))
    av = torch.zeros((b, lc, v.shape[-1]))
    for k0, k1 in ranges:  # rank order; an empty range adds its zeros
        p = torch.exp(s[..., k0:k1] - m[..., None]) * mk[:, None, k0:k1]
        p = p / torch.clamp(l, min=1e-30)[..., None]
        if keep is not None:
            p = torch.where(keep[..., k0:k1], p * keep_scale(rate), torch.zeros_like(p))
        av = av + p.to(v.dtype).float() @ v[:, k0:k1].float()
    return av


def _split_chain(x0, kvs, masks, ff_keep, presence, seeds, weights, spec, cluster, tile):
    """chain_reference with its attention taken as the kernel takes it."""
    w = dict(zip(WEIGHT_FIELDS, weights))
    b = x0.shape[0]
    kpb = tchain._keys_per_block(spec.tokens, cluster, tile)
    x = x0.float()
    for l in range(spec.depth):
        off = spec.offsets[l]
        for m in range(spec.n_modalities):
            pres = presence[:, m].float()[:, None, None]
            y, _, _ = tchain._ln(x, w["ln1_s"][l, m], w["ln1_b"][l, m])
            q = (y @ w["wq"][l, m]).to(kvs[m].dtype).float()
            k = kvs[m][:, :, off:off + spec.inner].float()
            v = kvs[m][:, :, off + spec.inner:off + 2 * spec.inner]
            keep = None
            if spec.attn_dropout > 0.0:
                keep = dense_keep_mask(seeds[l, m], b, spec.l_c, spec.tokens[m],
                                       spec.attn_dropout, device=x.device)
            av = _split_attention(q, k, v, masks[m], spec.scale, keep, spec.attn_dropout,
                                  cluster, kpb[m])
            o = av @ w["wout"][l, m] + w["bout"][l, m]
            x = pres * torch.where(o >= 0, o, 0.01 * o) + x
            y2, _, _ = tchain._ln(x, w["ln2_s"][l, m], w["ln2_b"][l, m])
            h1 = y2 @ w["w0"][l, m] + w["b0"][l, m]
            f = spec.mult * spec.l_d
            h2 = (h1[..., :f] * tchain._act(h1[..., f:], spec.act)) @ w["w2"][l, m] + w["b2"][l, m]
            if ff_keep is not None:
                h2 = h2 * ff_keep[:, l * spec.n_modalities + m].float()
            x = pres * h2 + x
    return x.to(x0.dtype)


@pytest.mark.parametrize("cluster", [1, 4, 8])
@pytest.mark.parametrize("case", ["fully_masked_row", "dropout_ff_keep"])
def test_key_split_merge_matches_chain_reference(rng, case, cluster):
    """8-key tiles over 40 keys: at clusters of 8, three blocks own none of
    the bag's keys and seven none of the omic token; a ragged mask leaves
    some ranges only masked keys, and one sample has every key masked."""
    spec, ops = _case(rng, case, "selu")
    ops = _to_torch(ops)
    got = _split_chain(*ops, spec, cluster=cluster, tile=8)
    want = chain_reference(*ops, spec)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
