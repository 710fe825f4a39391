"""The port's multi-device layer on the CPU, in worlds of 2 and 4 gloo
processes, against the port in one process and the JAX package.

The model of ``tests/test_parallel.py`` (2 cross heads of 16, depth 2,
tokens 16, batch 8), with attention dropout 0.25 (the seeds JAX's step
draws, recorded and handed to the port) and no feed-forward dropout
(Flax's threefry masks are not reproduced). The JAX references and the
port's single-process runs are made in this process; each world is
spawned once (``python -c``: its ranks import torch and the port, never
JAX) and runs every case of its size; each rank saves its shards, which
the tests put together. The rendezvous is a ``file://`` under the test's
temporary directory, and a world that outlives ``WORLD_TIMEOUT_S`` fails.

Tolerances, as in ``tests/test_parallel.py``: the step's loss to 1e-5
relative, the risks and the updated parameters to 1e-4 relative and 1e-6
absolute (sums over shards in another order); the fit's train loss to
1e-4 and its validation c-index to 1e-6; arena gathers bit for bit.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
WORLD_TIMEOUT_S = 300

MODULE = dict(n_modalities=2, channel_dims=(32, 16), num_spatial_axes=(1, 1), out_dims=4,
              depth=2, l_c=8, l_d=32, x_heads=2, l_heads=2, cross_dim_head=16,
              latent_dim_head=16, self_per_cross_attn=1)
ATTN_DROPOUT = 0.25
B, TOKENS = 8, 16
LAYOUTS = {2: [(2, 1, 1), (1, 2, 1), (1, 1, 2)], 4: [(2, 2, 1), (1, 2, 2)]}
HALVES = ("to_kv.weight", "net_0.weight", "net_0.bias")


def _batch(b=B, tokens=TOKENS, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tensors": (rng.normal(size=(b, 1, 32)).astype(np.float32),
                    rng.normal(size=(b, tokens, 16)).astype(np.float32)),
        "y_disc": rng.integers(0, 4, size=b).astype(np.int32),
        "censorship": rng.integers(0, 2, size=b).astype(np.float32),
        "event_time": rng.uniform(1, 100, size=b).astype(np.float32),
        "sample_mask": np.ones(b, dtype=np.float32),
    }


def _split(n, seed):
    r = np.random.default_rng(seed)
    return {"tensors": (r.normal(size=(n, 1, 32)).astype(np.float32),
                        r.normal(size=(n, 16, 16)).astype(np.float32)),
            "y_disc": r.integers(0, 4, n).astype(np.int32),
            "censorship": r.integers(0, 2, n).astype(np.float32),
            "event_time": r.uniform(1, 100, n).astype(np.float32)}


def _module2mod_kw():
    # omic + an arena-gathered slide (width tokens of dim 16)
    return dict(n_modalities=2, channel_dims=(32, 16), num_spatial_axes=(1, 1), out_dims=4,
                depth=1, l_c=8, l_d=16, x_heads=1, l_heads=2, cross_dim_head=8,
                latent_dim_head=8, self_per_cross_attn=0)


def _arena_data(seed=3, n=16, width=8, dim=16, ragged=False):
    """Bags packed into an arena with ``width`` zero rows after them, and
    index-only data (``tests/test_parallel.py``'s sharded-arena cases)."""
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(n, 1, 32)).astype(np.float32)
    lengths = (rng.integers(2, 7, size=n) if ragged else np.full(n, width)).astype(np.int32)
    offsets = np.zeros(n, np.int32)
    np.cumsum(lengths[:-1], out=offsets[1:])
    rows = rng.normal(size=(int(lengths.sum()), dim)).astype(np.float32)
    arena = np.concatenate([rows, np.zeros((width, dim), np.float32)])
    event_time = np.exp(1.5 + tab[:, 0, 0]).astype(np.float32)
    qs = np.quantile(event_time, [0.25, 0.5, 0.75])
    data = dict(tensors=(tab,), kv_masks=(None, np.arange(width)[None, :] < lengths[:, None]),
                patch_offsets=offsets, patch_lengths=lengths,
                y_disc=np.digitize(event_time, qs).astype(np.int32),
                censorship=(rng.uniform(size=n) < 0.3).astype(np.float32),
                event_time=event_time)
    return arena, data


# ------------------------------------------------------------------ worlds


def run_world(tmp: Path, n: int, job: str, module: str = "test_torch_port_parallel"):
    """Spawn ``n`` gloo ranks running ``job`` of ``module``'s ``JOBS``;
    returns each rank's result."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(HERE),
                                                      os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(n):
        cfg = dict(init=f"file://{tmp}/rendezvous_{job}_{n}", rank=rank, world=n, job=job,
                   dir=str(tmp))
        logs.append(open(tmp / f"{job}_rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", f"import {module} as t; t.worker(t.JOBS)"],
            env=dict(env, HEALNET_TEST_WORLD=json.dumps(cfg)), cwd=str(tmp),
            stdout=logs[-1], stderr=subprocess.STDOUT))
    # a failed rank stops the world at once; so does the time limit
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline \
                and not any(p.poll() for p in procs):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            text = (tmp / f"{job}_rank{rank}.log").read_text()
            pytest.fail(f"rank {rank} of world {job} exited {p.returncode} (killed where "
                        f"negative: a failed rank or {WORLD_TIMEOUT_S} s):\n{text[-4000:]}")
    return [torch.load(tmp / f"{job}_rank{r}.pt", weights_only=False) for r in range(n)]


def worker(jobs):
    """One rank of a world: runs its job of ``jobs`` and saves what it
    returns."""
    import torch.distributed as dist

    cfg = json.loads(os.environ["HEALNET_TEST_WORLD"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=cfg["init"], rank=cfg["rank"],
                            world_size=cfg["world"], timeout=datetime.timedelta(seconds=120))
    out = jobs[cfg["job"]](Path(cfg["dir"]), cfg["world"])
    torch.save(out, Path(cfg["dir"]) / f"{cfg['job']}_rank{cfg['rank']}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _mesh(layout):
    from healnet_tpu_torch.parallel import make_mesh

    mesh = make_mesh(max_model=layout[2], max_seq=layout[1], device="cpu")
    assert tuple(mesh.devices.shape) == tuple(layout), (mesh.devices.shape, layout)
    return mesh


def _port_module(state=None, **kw):
    from healnet_tpu_torch.models import HealNetModule

    module = HealNetModule(**{**MODULE, **kw}, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    if state is not None:
        module.load_state_dict(state)
    return module


def _one_step(inp, mesh, tp, **module_kw):
    """One sharded step of the carried weights: (loss, risk, shards)."""
    from healnet_tpu_torch.parallel import make_sharded_train_step, put_batch, shard_module
    from healnet_tpu_torch.train.schedule import make_optimizer

    module = shard_module(_port_module(inp["state"], attn_dropout=ATTN_DROPOUT, **module_kw),
                          mesh, tp)
    opt = make_optimizer(module.parameters(), cycle_momentum=False)
    step = make_sharded_train_step(module, opt, mesh, loss_type="nll", gc_compat=1.0,
                                   tensor_parallel=tp, max_lr=1e-3, horizon=100,
                                   cycle_momentum=False)
    loss, risk = step(put_batch(inp["batch"], mesh), generator=torch.Generator(),
                      seeds=inp["seeds"])
    return dict(loss=float(loss), risk=risk.numpy(), coords=dict(mesh.coords),
                params={n: p.detach().numpy().copy() for n, p in module.named_parameters()})


def _fit(mesh, data, arena=None, **kw):
    from healnet_tpu_torch.train import SurvivalTrainer

    module_kw = kw.pop("module_kw", {})
    module = _port_module(**module_kw) if "n_modalities" not in module_kw else \
        _plain_module(module_kw)
    trainer = SurvivalTrainer(module, batch_size=8, epochs=kw.pop("epochs", 2),
                              early_stopping=False, gc_compat=1, seed=0, mesh=mesh,
                              device="cpu", prefetch=0, feature_arena=arena, **kw)
    res = trainer.fit(data[0], data[1], verbose=False)
    return dict(train_loss=res["train_loss"], val_c_index=res["val_c_index"],
                history=[h["train_loss"] for h in res["history"]],
                evaluate=trainer.evaluate(data[1]), halo=trainer.arena_halo,
                arena=type(trainer._arena).__name__)


def _plain_module(kw):
    from healnet_tpu_torch.models import HealNetModule

    return HealNetModule(**kw, device="cpu", generator=torch.Generator().manual_seed(0))


def job_steps(tmp, world):
    """The sharded step in each layout of this world's size, with and
    without tensor parallelism; the mesh's factoring and ``require``; five
    steps; ``global_batch_from_host_local``."""
    from healnet_tpu_torch.parallel import (
        global_batch_from_host_local,
        make_mesh,
        put_batch,
        shard_module,
        make_sharded_train_step,
    )
    from healnet_tpu_torch.train.schedule import make_optimizer

    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    out = {"default": tuple(make_mesh(device="cpu").devices.shape),
           "truncated": make_mesh(16, device="cpu").size,
           "single": (make_mesh(1, device="cpu").size, make_mesh(1, device="cpu").devices.tolist())}
    try:
        make_mesh(16, require=True, device="cpu")
    except RuntimeError as exc:
        out["require"] = str(exc)
    for layout in LAYOUTS[world]:
        mesh = _mesh(layout)
        for tp in (False, True):
            out[f"step{layout}{tp}"] = _one_step(inp, mesh, tp)
    # five steps (and one with remat) on the layout with every axis of this
    # world split
    mesh = _mesh(LAYOUTS[world][-1])
    out["remat"] = _one_step(inp, mesh, True, remat=True)
    module = shard_module(_port_module(inp["state"]), mesh)
    opt = make_optimizer(module.parameters(), cycle_momentum=False)
    step = make_sharded_train_step(module, opt, mesh, gc_compat=1.0, max_lr=1e-3, horizon=100,
                                   cycle_momentum=False)
    out["five"] = [float(step(put_batch(_batch(seed=i), mesh))[0]) for i in range(5)]
    if world == 2:  # each rank passes its data rows
        mesh = _mesh((2, 1, 1))
        rows = slice(mesh.coord("data") * B // 2, (mesh.coord("data") + 1) * B // 2)
        local = {k: (tuple(t[rows] for t in v) if k == "tensors" else v[rows])
                 for k, v in _batch().items()}
        placed, ref = global_batch_from_host_local(local, mesh), put_batch(_batch(), mesh)
        out["global_batch"] = all(torch.equal(placed["tensors"][i], ref["tensors"][i])
                                  for i in range(2)) and torch.equal(placed["y_disc"],
                                                                     ref["y_disc"])
        mesh = _mesh((1, 2, 1))
        out["token_split"] = tuple(put_batch(_batch(), mesh)["tensors"][1].shape)
    return out


def job_fit(tmp, world):
    """``SurvivalTrainer(mesh=...).fit``, dense and from arenas (replicated
    and row-sharded, float and int8), the sharded gathers, the widened halo."""
    from healnet_tpu_torch.ops.quantize import QuantizedContext, quantize_context_host
    from healnet_tpu_torch.parallel import (
        build_device_arena,
        build_sharded_arena,
        gather_bag,
        gather_sharded,
    )

    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    out = {}
    layout = (2, 1, 1) if world == 2 else (1, 2, 2)
    mesh = _mesh(layout)
    dense = (_split(32, 0), _split(16, 1))
    out["fit"] = _fit(mesh, dense, module_kw=dict(attn_dropout=0.25, ff_dropout=0.3))
    # the sharded arena's gathers against the replicated one's, bit for bit
    mesh = _mesh((1, 2, 1) if world == 2 else (2, 2, 1))
    rng = np.random.default_rng(0)
    rows, dim, width = 101, 16, 24
    host = rng.normal(size=(rows, dim)).astype(np.float32)
    offsets = torch.from_numpy(rng.integers(0, rows - width, size=8).astype(np.int32))
    local = offsets.reshape(mesh.shape["data"], -1)[mesh.coord("data")]
    mask = torch.ones((local.shape[0], width), dtype=torch.bool)
    sharded = build_sharded_arena(host, mesh, halo=width)
    out["gather_float"] = torch.equal(gather_sharded(sharded, local, width, mesh),
                                      gather_bag(torch.from_numpy(host), local, mask))
    out["gather_jax"] = gather_sharded(sharded, local, width, mesh).numpy()
    q = QuantizedContext(*quantize_context_host(host))
    got = gather_bag(build_device_arena(q, mesh, halo=width), local, mask, mesh=mesh)
    want = gather_bag(QuantizedContext(torch.from_numpy(q.data), torch.from_numpy(q.scale)),
                      local, mask)
    out["gather_int8"] = torch.equal(got.data, want.data) and torch.equal(got.scale, want.scale)
    try:
        gather_sharded(build_sharded_arena(np.zeros((64, 8), np.float32), mesh, halo=16),
                       torch.zeros(2, dtype=torch.int32), 32, mesh)
    except ValueError as exc:
        out["oversized"] = str(exc)
    # trainer: the replicated arena on the mesh (the bag's tokens split over
    # seq here), then the sharded arena, float and int8, then the halo
    arena_host, data = _arena_data()
    arena = (arena_host, data["patch_offsets"], data["patch_lengths"])
    kw = dict(module_kw=_module2mod_kw(), arena_halo=8)
    out["arena_rep"] = _fit(mesh, (data, data), arena, **kw)
    out["arena_sharded"] = _fit(mesh, (data, data), arena, arena_sharded=True, **kw)
    out["arena_int8"] = _fit(mesh, (data, data), arena, arena_sharded=True, arena_quant=True,
                             **kw)
    out["arena_int8_rep"] = _fit(mesh, (data, data), arena, arena_quant=True, **kw)
    arena_host, data = _arena_data(seed=7, ragged=True)
    arena = (arena_host, data["patch_offsets"], data["patch_lengths"])
    for name, halo in (("halo_auto", None), ("halo_explicit", 8)):
        out[name] = _fit(mesh, (data, data), arena, module_kw=_module2mod_kw(), epochs=1,
                         arena_sharded=True, arena_halo=halo)
    out["dense_arena_mesh"] = _fit(_mesh((1, 2, 1) if world == 2 else (2, 2, 1)),
                                   (inp["arena_dense"], inp["arena_dense"]),
                                   (inp["arena_host"], None, None))
    return out


def job_pipeline(tmp, world):
    """A Pipeline fold with ``spmd`` and ``data.shard_arena`` over the world."""
    from healnet_tpu_torch.train.pipeline import Pipeline
    from healnet_tpu_torch.utils import Config

    def config(**kw):
        out = Config(str(tmp / "spmd.yml")).read()
        out["model_params"] = Config(str(tmp / "spmd_hp.yml")).read()["brca"]
        out.update(kw)
        return out

    try:
        Pipeline(config(explainer=True), device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    pipe = Pipeline(config(), device="cpu")
    summary = pipe.main()
    return dict(summary=summary, shape=pipe.mesh.shape,
                arena=type(pipe._trainer._arena.data if hasattr(pipe._trainer._arena, "data")
                           else pipe._trainer._arena).__name__,
                log_dir=str(pipe.tracker.log_dir), explainer_refused=refused)


def job_all(tmp, world):
    """Every case of a world's size, in one world (one torch import a rank)."""
    out = {**job_steps(tmp, world), **job_fit(tmp, world)}
    if world == 2:
        out["pipeline"] = job_pipeline(tmp, world)
    return out


JOBS = {"all": job_all}


# ------------------------------------------------------------ references


def _assemble(ranks, key):
    """The whole parameters from the ranks' shards: a leaf held in parts
    (its shape short of the model's) is joined from the blocks of the ranks
    at ``data`` and ``seq`` 0, in ``model`` order, along the dimension it
    is cut in (each half on its own for the fused outputs)."""
    full = {k: tuple(v.shape) for k, v in _port_module().state_dict().items()}
    owners = sorted((r[key]["coords"]["model"], r[key]["params"]) for r in ranks
                    if r[key]["coords"]["data"] == 0 and r[key]["coords"]["seq"] == 0)
    whole = {}
    for name, value in ranks[0][key]["params"].items():
        if value.shape == full[name]:
            whole[name] = value
            continue
        dim = next(d for d, (a, b) in enumerate(zip(value.shape, full[name])) if a != b)
        parts = [params[name] for _, params in owners]
        if name.endswith(HALVES):
            halves = [np.split(p, 2, axis=dim) for p in parts]
            parts = [h[0] for h in halves] + [h[1] for h in halves]
        whole[name] = np.concatenate(parts, axis=dim)
        assert whole[name].shape == full[name], name
    return whole


def _replicas_agree(ranks, key):
    """Every rank holds the same value of every leaf it shares with the
    ranks of its ``model`` coordinate (the same update everywhere)."""
    for r in ranks[1:]:
        if r[key]["coords"]["model"] != ranks[0][key]["coords"]["model"]:
            continue
        for name, value in r[key]["params"].items():
            np.testing.assert_array_equal(value, ranks[0][key]["params"][name], err_msg=name)


def _jax_reference():
    """JAX's single-device step on its initial weights (seed 0), and the
    attention seeds its dropout draws, recorded from an eager pass."""
    import jax
    from healnet_tpu.models import HealNetModule as JaxHealNet
    from healnet_tpu.ops import hash_dropout as jhash
    from healnet_tpu.parallel import (
        init_sharded_state,
        make_mesh as jax_make_mesh,
        make_sharded_train_step as jax_step,
        put_batch as jax_put,
    )
    from healnet_tpu.train import make_optimizer as jax_optimizer
    from healnet_tpu_torch.compat.flax_params import state_dict_from_flax

    module = JaxHealNet(**MODULE, attn_dropout=ATTN_DROPOUT)
    batch = _batch()
    mesh = jax_make_mesh(1)
    opt = jax_optimizer(1e-3, 100, cycle_momentum=False)
    params, opt_state = init_sharded_state(module, opt, batch, mesh, seed=0)
    state = {k: v.clone() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    seeds, real = [], jhash.seed_from_rng

    def record(rng):
        seed = real(rng)
        seeds.append(int(np.asarray(seed).view(np.uint32)[0, 0]))
        return seed

    jhash.seed_from_rng = record
    try:
        module.apply({"params": params}, tuple(map(np.asarray, batch["tensors"])),
                     deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    finally:
        jhash.seed_from_rng = real
    step = jax_step(module, opt, mesh, loss_type="nll", gc_compat=1.0)
    new, _, loss, risk = step(params, opt_state, jax_put(batch, mesh), jax.random.PRNGKey(0))
    return state, torch.tensor(seeds, dtype=torch.int64), dict(
        loss=float(loss), risk=np.asarray(risk),
        params=state_dict_from_flax(jax.tree_util.tree_map(np.asarray, new)))


def _port_single(inp):
    from healnet_tpu_torch.parallel import make_mesh

    return _one_step(inp, make_mesh(1, device="cpu"), True)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    state, seeds, jax_ref = _jax_reference()
    # the host-fed twin of an arena run: the same bags as dense tensors
    r = np.random.default_rng(0)
    n, width = 32, 16
    lengths = r.integers(4, width + 1, n).astype(np.int32)
    offsets = np.zeros(n, np.int32)
    np.cumsum(lengths[:-1], out=offsets[1:])
    arena_host = np.zeros((int(lengths.sum()) + width, 16), np.float32)
    arena_host[:int(lengths.sum())] = r.normal(size=(int(lengths.sum()), 16))
    kv_mask = np.arange(width)[None, :] < lengths[:, None]
    meta = _split(n, 1)
    omic = r.normal(size=(n, 1, 32)).astype(np.float32)
    slides = np.stack([arena_host[o:o + width] for o in offsets])
    inp = dict(state=state, seeds=seeds, batch=_batch(), arena_host=arena_host,
               arena_dense=dict(meta, tensors=(omic,), kv_masks=(None, kv_mask),
                                patch_offsets=offsets, patch_lengths=lengths),
               host_dense=dict(meta, tensors=(omic, slides), kv_masks=(None, kv_mask)))
    torch.save(inp, tmp / "inputs.pt")
    single = _port_single(inp)
    return dict(tmp=tmp, inp=inp, jax=jax_ref, single=single, pipeline=_pipeline_plain(tmp))


def _pipeline_plain(tmp):
    """A small TCGA tree, the configs of a fold with and without ``spmd``
    and ``data.shard_arena`` (the int8 arena, stepwise), and the mesh-free
    fold's summary."""
    from test_torch_port_etl import write_tree
    from test_torch_port_pipeline import write_config
    from healnet_tpu_torch.train.pipeline import Pipeline
    from healnet_tpu_torch.utils import Config

    write_tree(tmp / "tcga", np.random.default_rng(11), n=40)
    for name, spmd in (("plain", "false"), ("spmd", "true")):
        path = write_config(tmp, name, epochs=2, dropout=0.1)
        text = path.read_text().replace("spmd: false", f"spmd: {spmd}")
        text = text.replace("fused_epochs: true", "fused_epochs: false")
        text = text.replace("  quantize_arena: false",
                            "  quantize_arena: true\n  shard_arena: true")
        path.write_text(text)
    config = Config(str(tmp / "plain.yml")).read()
    config["model_params"] = Config(str(tmp / "plain_hp.yml")).read()["brca"]
    return Pipeline(config, device="cpu").main()


@pytest.fixture(scope="module")
def worlds(refs):
    return {n: run_world(refs["tmp"], n, "all") for n in (2, 4)}


@pytest.fixture(scope="module")
def steps(worlds):
    return worlds


@pytest.fixture(scope="module")
def fits(worlds):
    return worlds


# ------------------------------------------------------------------- tests


def test_mesh_factoring_and_require(steps):
    """make_mesh over the world: (1, 1, 2) for 2 ranks, (1, 2, 2) for 4;
    ``require`` raises for more ranks than the world has, the truncating
    form gives the world, and ``make_mesh(1)`` a mesh of one to each rank."""
    from healnet_tpu_torch.parallel.mesh import _factor

    assert _factor(8, 2, 2) == (2, 2, 2) and _factor(1, 2, 2) == (1, 1, 1)
    for n, ranks in steps.items():
        for rank, r in enumerate(ranks):
            assert r["default"] == _factor(n, 2, 2)
            assert "asked for 16" in r["require"] and r["truncated"] == n
            assert r["single"] == (1, [[[rank]]])


def test_param_tp_rules_on_port_names():
    """JAX's suffix rules on the port's (out, in) names, and the guard:
    only whole heads and whole gated units split."""
    from healnet_tpu_torch.parallel import make_mesh, param_shardings, param_spec
    from healnet_tpu_torch.parallel.mesh import Mesh

    assert param_spec("layer0_cross_attn_m0.fn.to_q.weight") == ("model", None)
    assert param_spec("layer0_cross_attn_m0.fn.to_kv.weight") == ("model", None)
    assert param_spec("layer0_cross_attn_m0.fn.to_out.weight") == (None, "model")
    assert param_spec("layer0_cross_ff_m0.fn.net_0.bias") == ("model",)
    assert param_spec("layer0_cross_ff_m0.fn.net_2.weight") == (None, "model")
    assert param_spec("latents") == () and param_spec("layer0_cross_ff_m0.fn.net_2.bias") == ()
    # a (1, 1, 2) mesh seen from rank 0, without a process group
    mesh = Mesh(np.arange(2).reshape(1, 1, 2), 0, torch.device("cpu"), {})
    specs = param_shardings(_port_module(), mesh)
    assert specs["layer0_cross_attn_m0.fn.to_q.weight"] == ("model", None)
    assert specs["layer0_self_attn_b0.fn.to_out.weight"] == (None, "model")
    assert specs["latents"] == () and specs["final_head.weight"] == ()
    assert all(s == () for s in param_shardings(_port_module(), mesh, False).values())
    # one cross head (BRCA-tuned's): q, kv and out stay whole, the FFs split
    one_head = param_shardings(_port_module(x_heads=1), mesh)
    assert one_head["layer0_cross_attn_m1.fn.to_kv.weight"] == ()
    assert one_head["layer0_cross_ff_m1.fn.net_0.weight"] == ("model", None)
    assert make_mesh(device="cpu").size == 1  # no process group: one device


@pytest.mark.parametrize("n,layout", [(2, l) for l in LAYOUTS[2]] + [(4, l) for l in LAYOUTS[4]])
@pytest.mark.parametrize("tp", [False, True])
def test_sharded_step_matches_single_process_and_jax(steps, refs, n, layout, tp):
    ranks = steps[n]
    key = f"step{layout}{tp}"
    _replicas_agree(ranks, key)
    whole = _assemble(ranks, key)
    for ref, name in ((refs["single"], "port"), (refs["jax"], "jax")):
        np.testing.assert_allclose(ranks[0][key]["loss"], ref["loss"], rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(ranks[0][key]["risk"], ref["risk"], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        want = {k: np.asarray(v) for k, v in ref["params"].items()}
        assert set(whole) == set(want)
        for pname, value in whole.items():
            np.testing.assert_allclose(value, want[pname], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}: {pname}")


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_remat_step_matches_single_process(steps, refs, n):
    """``remat=True`` on the world's last layout (its blocks recomputed in
    the backward, collectives included) against the plain single step."""
    ranks = steps[n]
    _replicas_agree(ranks, "remat")
    np.testing.assert_allclose(ranks[0]["remat"]["loss"], refs["single"]["loss"], rtol=1e-5)
    for name, value in _assemble(ranks, "remat").items():
        np.testing.assert_allclose(value, refs["single"]["params"][name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_five_steps_lower_the_loss(steps):
    for ranks in steps.values():
        losses = ranks[0]["five"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        assert all(r["five"] == losses for r in ranks)


def test_global_batch_from_host_local(steps):
    ranks = steps[2]
    assert all(r["global_batch"] for r in ranks)
    assert all(r["token_split"] == (B, TOKENS // 2, 16) for r in ranks)


def _port_fit(data, arena=None, **kw):
    return _fit(None, data, arena, **kw)


@pytest.mark.parametrize("n", [2, 4])
def test_trainer_with_mesh_matches_single_process(fits, n):
    """SurvivalTrainer(mesh=...).fit, attention and FF dropout on, against
    the mesh-free fit: (2, 1, 1) in a world of 2, (1, 2, 2) in one of 4."""
    want = _port_fit((_split(32, 0), _split(16, 1)),
                     module_kw=dict(attn_dropout=0.25, ff_dropout=0.3))
    for r in fits[n]:
        got = r["fit"]
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(got["val_c_index"], want["val_c_index"], rtol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_arena_gather_on_mesh_matches_host_path(fits, refs, n):
    """A replicated arena on a mesh whose seq axis splits the gathered bag's
    tokens, against the host-fed mesh-free run."""
    want = _port_fit((refs["inp"]["host_dense"],) * 2)
    for r in fits[n]:
        np.testing.assert_allclose(r["dense_arena_mesh"]["train_loss"], want["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["dense_arena_mesh"]["val_c_index"], want["val_c_index"],
                                   rtol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_arena_gather_bitequal(fits, n):
    assert all(r["gather_float"] and r["gather_int8"] for r in fits[n])


def test_sharded_arena_gather_matches_jax(fits):
    """The port's gather_sharded against JAX's on a 4-device CPU mesh
    (seq 2, data 2), bit for bit."""
    import jax.numpy as jnp
    from healnet_tpu.parallel import make_mesh as jax_make_mesh
    from healnet_tpu.parallel.arena import build_sharded_arena, gather_sharded

    rng = np.random.default_rng(0)
    rows, dim, width = 101, 16, 24
    host = rng.normal(size=(rows, dim)).astype(np.float32)
    offsets = rng.integers(0, rows - width, size=8).astype(np.int32)
    mesh = jax_make_mesh(4, max_model=1)
    assert dict(mesh.shape) == {"data": 2, "seq": 2, "model": 1}
    with mesh:
        want = np.asarray(gather_sharded(build_sharded_arena(host, mesh, halo=width),
                                         jnp.asarray(offsets), width, mesh))
    for r in fits[4]:  # ranks 0 and 1 hold data rows 0-3, ranks 2 and 3 rows 4-7
        np.testing.assert_array_equal(r["gather_jax"], want[:4] if r is fits[4][0] or
                                      r is fits[4][1] else want[4:])


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_arena_rejects_oversized_window(fits, n):
    assert all("halo" in r["oversized"] for r in fits[n])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_sharded_arena_trainer_matches_replicated(fits, n, kind):
    for r in fits[n]:
        rep, sh = ((r["arena_rep"], r["arena_sharded"]) if kind == "float"
                   else (r["arena_int8_rep"], r["arena_int8"]))
        assert sh["arena"] in ("ShardedArena", "QuantizedContext") and rep["arena"] != \
            "ShardedArena"
        np.testing.assert_allclose(sh["history"], rep["history"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(sh["evaluate"], rep["evaluate"], rtol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_arena_halo_widens_to_batch_width(fits, n):
    for r in fits[n]:
        assert r["halo_auto"]["halo"] >= 8
        np.testing.assert_allclose(r["halo_auto"]["history"], r["halo_explicit"]["history"],
                                   rtol=1e-6, atol=1e-7)


def test_pipeline_fold_spmd_sharded_arena(refs, worlds):
    """``Pipeline`` with ``spmd`` and ``data.shard_arena`` in a world of 2
    (a (1, 1, 2) mesh: the feed-forwards split over model) against the
    mesh-free fold on the same tree: the same c-indices to 1e-6."""
    ranks, want = worlds[2], refs["pipeline"]
    for r in ranks:
        got = r["pipeline"]
        assert got["shape"] == {"data": 1, "seq": 1, "model": 2}
        assert got["arena"] == "ShardedArena" and got["log_dir"] == ranks[0]["pipeline"]["log_dir"]
        for metric in ("mean_train_c_index", "mean_val_c_index", "mean_test_c_index"):
            np.testing.assert_allclose(got["summary"][metric], want[metric], rtol=1e-6,
                                       err_msg=metric)


def test_pipeline_spmd_refuses_explainer_under_model_split(worlds):
    """``explainer: true`` on the world of 2's (1, 1, 2) mesh, whose
    feed-forwards split over model, is refused when the Pipeline is made:
    the explainer's checkpoint would hold one rank's shards."""
    for r in worlds[2]:
        assert "splits the weights over model" in (r["pipeline"]["explainer_refused"] or "")
