"""Sequence-parallel cross-attention and the dropout hash's shard offsets,
on the CPU, against the JAX package.

``sequence_parallel_attention`` runs in worlds of gloo processes (2 ranks
in a (1, 2, 1) mesh, 4 in (2, 2, 1) and (1, 2, 2)), each rank on its block
of the batch rows, heads and keys, and is held against JAX's function on a
4-device CPU mesh (the conftest's virtual devices): output and gradients
of ``sum(sin(out))`` within 1e-5 (f32 sums over shards in another order),
finite where a whole shard of keys is masked; its dropout keeps, taken at
global coordinates, equal ``dense_keep_mask``'s bit for bit; a HealNet
module whose context is split over ``seq`` gives the unsplit module's
logits. The offsets of ``dense_keep_mask``, the plain attention and the
flash pair's plain versions are checked in this process.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_port_parallel import run_world, worker  # noqa: E402,F401

B, H, LQ, LKV, D = 4, 2, 9, 64, 16
RATE = 0.25
LAYOUTS = {2: [(1, 2, 1)], 4: [(2, 2, 1), (1, 2, 2)]}
# (mask kind, dropout rate)
CASES = {"masked": ("random", 0.0), "unmasked": (None, 0.0), "dropout": ("random", RATE),
         "shard_masked": ("half", 0.0), "shard_masked_dropout": ("half", RATE)}
MODEL = dict(n_modalities=2, channel_dims=(24, 48), num_spatial_axes=(1, 1), out_dims=4,
             depth=2, l_c=6, l_d=16, x_heads=2, l_heads=2, cross_dim_head=8,
             latent_dim_head=8, self_per_cross_attn=0, attn_dropout=0.3)


def _inputs(case):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, H, LQ, D), (B, H, LKV, D), (B, H, LKV, D)))
    kind, rate = CASES[case]
    mask = None
    if kind == "random":
        mask = rng.uniform(size=(B, LKV)) > 0.3
    elif kind == "half":  # the second shard of keys entirely masked
        mask = np.concatenate([np.ones((B, LKV // 2), bool), np.zeros((B, LKV // 2), bool)], 1)
    return q, k, v, mask, rate, 123456789


def _blocks(mesh, b, h, lkv):
    """This rank's (rows, heads, keys) slices."""
    sizes = mesh.shape
    hs = H // sizes["model"] if sizes["model"] > 1 else H
    bs, ks = b // sizes["data"], lkv // sizes["seq"]
    d0, m0, s0 = mesh.coord("data"), mesh.coord("model") if sizes["model"] > 1 else 0, \
        mesh.coord("seq")
    return slice(d0 * bs, (d0 + 1) * bs), slice(m0 * hs, (m0 + 1) * hs), \
        slice(s0 * ks, (s0 + 1) * ks)


def job_seq(tmp, world):
    from test_torch_port_parallel import _mesh
    from healnet_tpu_torch.models import HealNetModule
    from healnet_tpu_torch.ops.hash_dropout import dense_keep_mask
    from healnet_tpu_torch.parallel import put_batch, sequence_parallel_attention

    out = {}
    for layout in LAYOUTS[world]:
        mesh = _mesh(layout)
        rows, heads, keys = _blocks(mesh, B, H, LKV)
        for case in CASES:
            q, k, v, mask, rate, seed = _inputs(case)
            qt = torch.tensor(q[rows, heads], requires_grad=True)
            kt = torch.tensor(k[rows, heads, keys], requires_grad=True)
            vt = torch.tensor(v[rows, heads, keys], requires_grad=True)
            mt = None if mask is None else torch.tensor(mask[rows, keys])
            o = sequence_parallel_attention(qt, kt, vt, mesh, scale=D**-0.5, temperature=0.5,
                                            kv_mask=mt, dropout_rate=rate,
                                            dropout_seed=seed if rate else None, heads=H)
            torch.sum(torch.sin(o)).backward()
            out[(layout, case)] = dict(out=o.detach().numpy(), dq=qt.grad.numpy(),
                                       dk=kt.grad.numpy(), dv=vt.grad.numpy(),
                                       coords=dict(mesh.coords))
        # the keeps: with one-hot values the output is the dropped map
        q, k, _, _, _, seed = _inputs("dropout")
        eye = torch.eye(LKV)[keys].expand(B, H, -1, -1)[rows, heads].contiguous()
        o = sequence_parallel_attention(torch.tensor(q[rows, heads]),
                                        torch.tensor(k[rows, heads, keys]), eye, mesh,
                                        scale=D**-0.5, dropout_rate=RATE, dropout_seed=seed,
                                        heads=H)
        dropped = o.reshape(o.shape[0], LQ, -1, LKV).transpose(1, 2) == 0
        keep = dense_keep_mask(seed, B * H, LQ, LKV, RATE).reshape(B, H, LQ, LKV)
        out[(layout, "keep")] = bool(torch.equal(~dropped, keep[rows, heads]))
    # the model, its WSI context split over seq, dropout on
    mesh = _mesh((1, 2, 1) if world == 2 else (2, 2, 1))
    inp = torch.load(tmp / "model.pt", weights_only=False)
    module = HealNetModule(**MODEL, device="cpu", mesh=mesh)
    module.load_state_dict(inp["state"])
    assert module._mod("layer0_cross_attn_m1").fn._should_use_seq_parallel(True, False)
    batch = put_batch(inp["batch"], mesh)
    logits = module.train()(batch["tensors"], kv_masks=batch["kv_masks"],
                            seq_sharded=batch["seq_sharded"], seeds=inp["seeds"],
                            generator=torch.Generator())
    out["model"] = dict(logits=logits.detach().numpy(), coords=dict(mesh.coords),
                        flags=batch["seq_sharded"])
    return out


JOBS = {"seq": job_seq}


def _jax_case(case, mesh):
    import jax
    import jax.numpy as jnp
    from healnet_tpu.parallel.seq_attention import sequence_parallel_attention as jax_sp

    q, k, v, mask, rate, seed = _inputs(case)
    seed = jnp.asarray(np.array([[seed]], np.uint32).view(np.int32))

    def loss(q, k, v):
        with mesh:
            out = jax_sp(q, k, v, mesh, scale=D**-0.5, temperature=0.5,
                         kv_mask=None if mask is None else jnp.asarray(mask),
                         dropout_rate=rate, dropout_seed=seed if rate else None)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax
    from healnet_tpu.models import HealNetModule as JaxHealNet
    from healnet_tpu_torch.compat.flax_params import state_dict_from_flax

    tmp = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(1)
    batch = {"tensors": (rng.normal(size=(8, 1, 24)).astype(np.float32),
                         rng.normal(size=(8, 64, 48)).astype(np.float32)),
             "kv_masks": (None, rng.uniform(size=(8, 64)) > 0.2)}
    jmod = JaxHealNet(**{k: v for k, v in MODEL.items()})
    params = jmod.init(jax.random.PRNGKey(0), tuple(map(np.asarray, batch["tensors"])))["params"]
    state = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    seeds = torch.tensor(np.random.default_rng(2).integers(0, 2**32, 4), dtype=torch.int64)
    torch.save(dict(state=state, batch=batch, seeds=seeds), tmp / "model.pt")
    return dict(tmp=tmp, state=state, batch=batch, seeds=seeds,
                ranks={n: run_world(tmp, n, "seq", "test_torch_port_seq_attention")
                       for n in (2, 4)})


@pytest.fixture(scope="module")
def jax_refs():
    from healnet_tpu.parallel import make_mesh as jax_make_mesh

    mesh = jax_make_mesh(4)
    assert dict(mesh.shape) == {"data": 1, "seq": 2, "model": 2}
    return {case: _jax_case(case, mesh) for case in CASES}


class _Coords:
    """A rank's coordinates where ``_blocks`` wants a mesh."""

    def __init__(self, coords, shape):
        self.coords, self.shape = coords, shape

    def coord(self, axis):
        return self.coords[axis]


def _assemble(ranks, key):
    """The global output and gradients from the ranks' blocks."""
    got = {"out": np.zeros((B, LQ, H, D), np.float32), "dq": np.zeros((B, H, LQ, D), np.float32),
           "dk": np.zeros((B, H, LKV, D), np.float32), "dv": np.zeros((B, H, LKV, D), np.float32)}
    shape = {a: max(r[key]["coords"][a] for r in ranks) + 1 for a in ("data", "seq", "model")}
    for r in ranks:
        rows, heads, keys = _blocks(_Coords(r[key]["coords"], shape), B, H, LKV)
        out = r[key]["out"]
        got["out"][rows, :, heads] = out.reshape(out.shape[0], LQ, -1, D)
        got["dq"][rows, heads] = r[key]["dq"]
        got["dk"][rows, heads, keys] = r[key]["dk"]
        got["dv"][rows, heads, keys] = r[key]["dv"]
    got["out"] = got["out"].reshape(B, LQ, H * D)
    return got


@pytest.mark.parametrize("n,layout", [(2, l) for l in LAYOUTS[2]] + [(4, l) for l in LAYOUTS[4]])
@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallel_matches_jax(worlds, jax_refs, n, layout, case):
    """Forward and gradients against JAX's sequence_parallel_attention on a
    4-device mesh; every rank of a line along seq holds the same output and
    query gradient; a fully masked shard stays finite."""
    ranks = worlds["ranks"][n]
    key = (layout, case)
    for r in ranks:  # seq ranks agree on what they share
        for o in ranks:
            c, d = r[key]["coords"], o[key]["coords"]
            if (c["data"], c["model"]) == (d["data"], d["model"]):
                np.testing.assert_array_equal(r[key]["out"], o[key]["out"])
                np.testing.assert_array_equal(r[key]["dq"], o[key]["dq"])
    got = _assemble(ranks, key)
    want_out, (dq, dk, dv) = jax_refs[case]
    assert np.all(np.isfinite(got["out"]))
    np.testing.assert_allclose(got["out"], want_out, rtol=1e-5, atol=1e-6)
    for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n,layout", [(2, l) for l in LAYOUTS[2]] + [(4, l) for l in LAYOUTS[4]])
def test_dropout_keeps_bit_equal_dense_mask(worlds, n, layout):
    assert all(r[(layout, "keep")] for r in worlds["ranks"][n])


@pytest.mark.parametrize("n", [2, 4])
def test_model_seq_parallel_matches_single_device(worlds, n):
    """The module with its WSI context split over seq (attention dropout on,
    the same seeds) against the module on one device."""
    from healnet_tpu_torch.models import HealNetModule

    module = HealNetModule(**MODEL, device="cpu")
    module.load_state_dict(worlds["state"])
    batch = worlds["batch"]
    want = module.train()([torch.tensor(t) for t in batch["tensors"]],
                          kv_masks=[None, torch.tensor(batch["kv_masks"][1])],
                          seeds=worlds["seeds"], generator=torch.Generator()).detach().numpy()
    for r in worlds["ranks"][n]:
        got = r["model"]
        assert got["flags"] == (False, True)
        rows = 8 // (2 if n == 4 else 1)
        start = got["coords"]["data"] * rows
        np.testing.assert_allclose(got["logits"], want[start:start + rows], rtol=2e-5,
                                   atol=2e-5)


def test_single_device_mesh_is_plain_attention():
    """On a mesh of one device the function is the plain attention."""
    from healnet_tpu_torch.ops.attention import multihead_attention
    from healnet_tpu_torch.parallel import make_mesh, sequence_parallel_attention

    q, k, v, mask, _, seed = _inputs("masked")
    args = [torch.tensor(x) for x in (q, k, v)]
    got = sequence_parallel_attention(*args, make_mesh(1, device="cpu"), scale=0.25,
                                      kv_mask=torch.tensor(mask), dropout_rate=RATE,
                                      dropout_seed=seed)
    want, _ = multihead_attention(*args, scale=0.25, kv_mask=torch.tensor(mask),
                                  dropout_rate=RATE, dropout_seed=seed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_dispatch_needs_seq_cross_and_divisible_tokens():
    """The attention takes the sequence-parallel route for cross-attention
    without weight capture on a mesh with seq > 1; which contexts are split
    (tokens above 1 that divide over seq) is the batch placement's rule."""
    from healnet_tpu_torch.models.layers import Attention
    from healnet_tpu_torch.parallel.mesh import Mesh
    from healnet_tpu_torch.parallel.train import batch_shardings, splits_tokens

    attn = Attention(16, 24, heads=2, dim_head=8, dropout=0.3)
    attn.mesh = Mesh(np.arange(2).reshape(1, 2, 1), 0, torch.device("cpu"), {})
    assert attn._should_use_seq_parallel(True, False)
    assert not attn._should_use_seq_parallel(False, False)
    assert not attn._should_use_seq_parallel(True, True)
    assert splits_tokens(64, attn.mesh)
    assert not splits_tokens(63, attn.mesh) and not splits_tokens(1, attn.mesh)
    specs = batch_shardings({"tensors": (np.zeros((2, 64, 4)), np.zeros((2, 63, 4)))}, attn.mesh)
    assert [s[1] for s in specs["tensors"]] == ["seq", None]
    attn.mesh = None
    assert not attn._should_use_seq_parallel(True, False)
    assert not splits_tokens(64, None)


@pytest.mark.parametrize("heads", [False, True], ids=["rows", "heads_split"])
def test_keep_mask_offsets_are_the_whole_masks_block(heads):
    """dense_keep_mask at a shard's row and key offsets is the whole
    batch's mask at that block, bit for bit."""
    from healnet_tpu_torch.ops.hash_dropout import dense_keep_mask

    b, h, lq, lkv, seed = 6, 4, 5, 40, 987654321
    whole = dense_keep_mask(seed, b * h, lq, lkv, RATE).reshape(b, h, lq, lkv)
    rows, hs, keys = slice(2, 4), slice(2, 4) if heads else slice(0, h), slice(10, 30)
    hl = hs.stop - hs.start
    part = dense_keep_mask(seed, 2 * hl, lq, 20, RATE, row_offset=2 * h + hs.start,
                           kv_offset=10, heads=hl, head_stride=h)
    assert torch.equal(part.reshape(2, hl, lq, 20), whole[rows, hs, :, keys])


@pytest.mark.parametrize("head_split", [False, True])
def test_flash_plain_path_row_offset_gives_the_whole_calls_rows(head_split):
    """The flash pair's plain versions on a shard of rows (and heads), with
    the shard's row offset, equal the whole call's block: the forward
    through ``FlashAttentionFunction`` and its backward."""
    from healnet_tpu_torch.ops.flash_attention import FlashAttentionFunction

    q, k, v, mask, _, seed = _inputs("masked")
    t = lambda x: torch.tensor(x, requires_grad=True)  # noqa: E731
    eff = D**-0.5 / 0.5
    whole = [t(q), t(k), t(v)]
    out = FlashAttentionFunction.apply(*whole, torch.tensor(mask), eff, RATE, seed)
    g = torch.tensor(np.random.default_rng(3).normal(size=out.shape).astype(np.float32))
    (out * g).sum().backward()
    rows, hs = slice(2, 4), slice(1, 2) if head_split else slice(0, H)
    hl = hs.stop - hs.start
    part = [t(x[rows, hs]) for x in (q, k, v)]
    got = FlashAttentionFunction.apply(*part, torch.tensor(mask[rows]), eff, RATE, seed,
                                       2 * H + hs.start, H)
    gp = g.reshape(B, LQ, H, D)[rows, :, hs].reshape(2, LQ, hl * D)
    (got * gp).sum().backward()
    want = out.detach().reshape(B, LQ, H, D)[rows, :, hs].reshape(2, LQ, hl * D)
    torch.testing.assert_close(got.detach(), want, rtol=1e-5, atol=1e-6)
    for a, w in zip(part, whole):
        torch.testing.assert_close(a.grad, w.grad[rows, hs], rtol=1e-5, atol=1e-6)
