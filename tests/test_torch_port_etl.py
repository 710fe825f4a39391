"""The port's config reader, host utilities, TCGA loader, survival bins,
splits, batches and sweep engine, against the JAX package on the CPU.

The same files and the same seeds go through both packages. Everything here
is host code on numpy, so the results must be equal bit for bit (the omic
tensor compared after its float32 cast: pandas' float parser and Python's
may differ in the last bit of a float64).
"""

import ast
import getpass
import json
import math
import zipfile
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from healnet_tpu.cli.main import build_parser as jax_parser
from healnet_tpu.cli.main import load_config as jax_load_config
from healnet_tpu.etl import TCGADataset as JaxTCGADataset
from healnet_tpu.etl import class_weights as jax_class_weights
from healnet_tpu.etl import discretize_survival as jax_discretize
from healnet_tpu.etl import train_val_test_split as jax_split
from healnet_tpu.models.healnet import HealNetModule as JaxHealNet
from healnet_tpu.train.sweep import Sweep as JaxSweep
from healnet_tpu.utils import Box as JaxBox
from healnet_tpu.utils import Config as JaxConfig
from healnet_tpu.utils import Tracker as JaxTracker
from healnet_tpu.utils import flatten_config as jax_flatten
from healnet_tpu_torch import runtime
from healnet_tpu_torch.cli.main import build_parser, load_config
from healnet_tpu_torch.compat.flax_params import state_dict_from_flax
from healnet_tpu_torch.etl import (
    LRUCache,
    MMDataset,
    Table,
    TCGADataset,
    class_weights,
    discretize_survival,
    train_val_test_split,
)
from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.quantize import quantize_context_host
from healnet_tpu_torch.parallel import place_quantized
from healnet_tpu_torch.train.sweep import Sweep
from healnet_tpu_torch.utils import (
    Box,
    Config,
    StepTimer,
    Tracker,
    enable_compilation_cache,
    flatten_config,
    trace,
    unflatten_config,
)
from healnet_tpu_torch.utils.yaml_reader import YamlSubsetError, loads

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (REPO / "config").iterdir())
PATCH_DIM = 32
N_GENES = 40


# ------------------------------------------------------------------ config


class _IncludeLoader(yaml.FullLoader):
    pass


_IncludeLoader.add_constructor(
    "!include", lambda loader, node: ("include", loader.construct_scalar(node)))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_files_read_as_the_jax_package_reads_them(name):
    path = str(REPO / "config" / name)
    got, want = Config(path).read(), JaxConfig(path).read()
    assert got == want
    assert isinstance(got, Box) and json.dumps(got, default=str) == json.dumps(want, default=str)


@pytest.mark.parametrize("name", ["main.yml", "dress_rehearsal.yml", "explainer_demo.yml"])
@pytest.mark.parametrize("dataset", [None, "kirp", "luad"])
def test_load_config_as_the_jax_cli(name, dataset, monkeypatch):
    monkeypatch.chdir(REPO)  # the configs name config/best_hyperparams.yml
    argv = ["--config_path", f"config/{name}"] + (["--dataset", dataset] if dataset else [])
    got = load_config(build_parser().parse_args(argv))
    want = jax_load_config(jax_parser().parse_args(argv))
    assert got == want
    assert flatten_config(got) == jax_flatten(want)
    assert unflatten_config(flatten_config(got)) == got


# scalars as PyYAML's FullLoader resolves them: floats need a dot ("1e-07"
# is a string), "None" is a string, null / ~ are None, YAML 1.1 bools / ints
SCALARS = [
    "1.0e-07", "1e-07", "1.165e-05", "1.0E+5", "0.008", "2.0", "3.", ".5", "-.inf", "+.inf",
    "null", "Null", "NULL", "~", "None", "none", "true", "True", "FALSE", "yes", "No", "on",
    "off", "0", "-0", "+12", "017", "08", "0x1f", "0b101", "1_000", "1:30", "1:30.5", "07.5",
    "abc", "a b", "/tmp/healnet_dress/tcga", "./gdc-client", "log_uniform_values",
    "http://x.y:80/z", "a#b", "'quoted'", "'it''s'", '"tab\\tand \\u00e9"', '"a # b"',
    "[2048, 4096, 8192]", "[omic, 'slides', \"x\"]", "[]", "{}", "{a: 1, b: [2, 3]}",
    "[1.0e-07, null, None, true]", "[[1, 2], [3]]",
]


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalars_resolve_as_pyyaml_full_loader(scalar):
    doc = f"key: {scalar}  # a comment\n"
    got, want = loads(doc)["key"], yaml.load(doc, Loader=yaml.FullLoader)["key"]
    assert type(got) is type(want) and json.dumps(got) == json.dumps(want)


DOCUMENTS = [
    "a:\n- 1\n- 2\nb: 3\n",
    "a:\n  - x\n  - y\n",
    "- a: 1\n  b: 2\n- c\n- - x\n  - y\n-\n",
    "a: &x\n  b: 1.0e-05\n  c: [1, 2]\nd: *x\ne:\n  f: *x\n",
    "- &s hello\n- *s\n",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n",
    "\n# only a comment\n",
    "x:\n",
    "a: 'b # c'   # d\n'quoted key': 1\n\"k2\": [a, b]\n",
    "k: !include other.yml\n",
]


@pytest.mark.parametrize("doc", DOCUMENTS)
def test_documents_read_as_pyyaml_full_loader(doc):
    got = loads(doc, include=lambda target: ("include", target))
    assert got == yaml.load(doc, Loader=_IncludeLoader)


OUTSIDE = [
    ("a: |\n  text\n", 1), ("a: >\n  text\n", 1), ("a: one\n  two\n", 2), ("<<: *x\n", 1),
    ("? key\n: value\n", 1), ("a: !!str 1\n", 1), ("a: 2001-12-14\n", 1), ("---\na: 1\n", 1),
    ("a: b: c\n", 1), ("a: [1, 2\n", 1), ("a: 'open\n", 1), ("a:\n\t- 1\n", 2),
    ("a: *nowhere\n", 1), ("a: 1\n b: 2\n", 2), ("k: !include x.yml\n", 1),
]


@pytest.mark.parametrize("doc,line", OUTSIDE)
def test_outside_the_subset_raises_naming_the_line(doc, line):
    with pytest.raises(YamlSubsetError, match=f"line {line}:"):
        loads(doc)  # no include callback: !include raises too


def test_include_and_user_overlay_as_the_jax_package(tmp_path):
    user = getpass.getuser().lower().replace(" ", "_")
    (tmp_path / "sub").mkdir()
    (tmp_path / "main.yml").write_text(
        "a: 1\nnested:\n  keep: x\n  over: 1\nsub: !include sub/part.yml\n")
    (tmp_path / f"main.{user}.yml").write_text("nested:\n  over: 2\nadded: [1, 2]\n")
    (tmp_path / "sub" / "part.yml").write_text("p: 1.5\nq: None\n")
    (tmp_path / "sub" / f"part.{user}.yml").write_text("q: null\n")
    path = str(tmp_path / "main.yml")
    got = Config(path).read()
    assert got == JaxConfig(path).read()
    assert got.nested.over == 2 and got.sub.q is None and got.sub.p == 1.5


# ---------------------------------------------------- survival bins, splits


def _surv_frame(rng, n, rounded=False):
    months = rng.uniform(1, 120, size=n)
    return pd.DataFrame({"survival_months": np.round(months) if rounded else months,
                         "censorship": rng.integers(0, 2, size=n)})


@pytest.mark.parametrize("subset", ["all", "uncensored", "censored"])
@pytest.mark.parametrize("n_bins", [2, 3, 4, 7])
@pytest.mark.parametrize("rounded", [False, True])
def test_discretize_survival_bit_equal(subset, n_bins, rounded):
    rng = np.random.default_rng(n_bins + 10 * rounded)
    for n in (24, 57, 200):
        df = _surv_frame(rng, n, rounded)
        want = jax_discretize(df, n_bins=n_bins, subset=subset).values
        got = discretize_survival({k: df[k].values for k in df}, n_bins=n_bins, subset=subset)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64


def test_discretize_survival_jax_cases_and_values_on_edges():
    # the JAX tests' cases: eps-widened outer edges, extreme censored samples
    df = pd.DataFrame({"survival_months": np.r_[np.linspace(1, 100, 40), [0.5, 150.0]],
                       "censorship": np.r_[np.zeros(40), [1, 1]]})
    np.testing.assert_array_equal(discretize_survival(df), jax_discretize(df).values)
    # values exactly on quantile edges (9 evenly spaced: every edge is a value)
    df = pd.DataFrame({"survival_months": np.arange(1.0, 10.0), "censorship": np.zeros(9)})
    for subset in ("all", "uncensored"):
        got = discretize_survival(df, n_bins=4, subset=subset)
        np.testing.assert_array_equal(got, jax_discretize(df, n_bins=4, subset=subset).values)
    np.testing.assert_array_equal(discretize_survival(df, subset="all"), [0, 0, 0, 1, 1, 2, 2, 3, 3])
    # duplicate edges raise in both
    df = pd.DataFrame({"survival_months": np.ones(12), "censorship": np.zeros(12)})
    with pytest.raises(ValueError, match="unique"):
        jax_discretize(df)
    with pytest.raises(ValueError, match="unique"):
        discretize_survival(df)


@pytest.mark.parametrize("scheme", ["inverse", "inverse_root", "None", None])
def test_class_weights_and_splits_bit_equal(scheme, rng):
    for y, n_bins in ((rng.integers(0, 4, 50), 4), (np.array([0, 0, 2, 2, 3]), 4),
                      (np.array([1, 1, 1]), None)):
        got, want = class_weights(y, scheme, n_bins=n_bins), jax_class_weights(y, scheme, n_bins)
        assert (got is None and want is None) or np.array_equal(got, want)
    for n, seed in ((24, 1), (48, 2), (1022, 5)):
        for a, b in zip(train_val_test_split(n, seed=seed), jax_split(n, seed=seed)):
            np.testing.assert_array_equal(a, b)


def test_mmdataset_and_lru_cache(rng):
    tab = rng.normal(size=(5, 1, 3))
    ds = MMDataset([tab, tab[:, 0]], np.arange(5))
    sample, y = ds[2]
    assert len(ds) == 5 and y == 2 and sample[1].shape == (3,)
    with pytest.raises(ValueError):
        MMDataset([np.zeros((5, 2)), np.zeros((6, 2))])
    cache = LRUCache(2)
    cache.set("a", 1)
    cache.set("b", 2)
    cache.get("a")
    cache.set("c", 3)
    assert "b" not in cache and "a" in cache and len(cache) == 2


# ------------------------------------------------------------ TCGA trees


def write_tree(root, rng, n=24, bag=(8, 48), extra_omic=0, pt=False, nan_cell=True):
    """A TCGA-layout tree: ``n`` slides with ragged bags of ``bag`` patches
    (or ``.pt`` files), an omics CSV written by pandas with one missing
    cell, ``extra_omic`` omic rows without a slide."""
    (root / "omic").mkdir(parents=True)
    prep = root / "wsi" / "brca_preprocessed_level2"
    (prep / "patches").mkdir(parents=True)
    (prep / "patch_features").mkdir(parents=True)
    sids = [f"TCGA-R{i:03d}" for i in range(n)]
    for sid in sids:
        (prep / "patches" / f"{sid}.h5").touch()
        feats = rng.normal(size=(int(rng.integers(bag[0], bag[1] + 1)), PATCH_DIM))
        if pt:
            torch.save(torch.from_numpy(feats.astype(np.float32)),
                       prep / "patch_features" / f"{sid}.pt")
        else:
            np.save(prep / "patch_features" / f"{sid}.npy", feats.astype(np.float32))
    rows = n + extra_omic
    df = pd.DataFrame(rng.normal(size=(rows, N_GENES)).astype(np.float32),
                      columns=[f"gene_{i}" for i in range(N_GENES)])
    if nan_cell:
        df.loc[3, "gene_1"] = np.nan  # imputed with the column mean
    names = sids + [f"TCGA-X{i:03d}" for i in range(extra_omic)]
    df["site"] = "breast"
    df["oncotree_code"] = "IDC"
    df["case_id"] = names
    df["slide_id"] = [s + ".svs" for s in names]
    df["train"] = 1
    df["censorship"] = rng.integers(0, 2, size=rows)
    df["survival_months"] = rng.uniform(5, 100, size=rows)
    df.to_csv(root / "omic" / "tcga_brca_all_clean.csv.zip", compression="zip")
    return root


def _cfg(root, **kw):
    return {"tcga_path": str(root), "model": "healnet", "omic_attention": True, **kw}


@pytest.fixture
def tree(tmp_path, rng):
    return write_tree(tmp_path / "tcga", rng)


def _pair(root, log_dirs=(None, None), **kw):
    cfg = _cfg(root, **kw)
    got = TCGADataset("brca", Box(cfg), n_bins=4, log_dir=log_dirs[0])
    want = JaxTCGADataset("brca", JaxBox(cfg), n_bins=4, log_dir=log_dirs[1])
    return got, want


def _assert_same_data(got, want):
    assert got.omic_tensor.dtype == np.float32
    np.testing.assert_array_equal(got.omic_tensor, want.omic_tensor)
    for key in ("y_disc", "censorship", "survival_months"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert got.slide_ids == want.slide_ids and len(got) == len(want)
    assert got.max_patches == want.max_patches
    assert getattr(got, "_bag_sizes", None) == getattr(want, "_bag_sizes", None)
    assert got.feature_columns == list(want.features.columns)


@pytest.mark.parametrize("omic_attention", [True, False])
def test_tcga_dataset_same_data_as_jax(tree, omic_attention):
    got, want = _pair(tree, omic_attention=omic_attention)
    _assert_same_data(got, want)
    assert not np.isnan(got.omic_tensor).any()
    assert got.omic_df.shape == want.omic_df.shape
    assert got.omic_df.columns == list(want.omic_df.columns)


@pytest.mark.parametrize("extra_omic,extra_slides", [(5, 0), (0, 4)])
def test_overlap_filter_row_count_rule(tmp_path, rng, extra_omic, extra_slides):
    root = write_tree(tmp_path / "tcga", rng, extra_omic=extra_omic)
    prep = root / "wsi" / "brca_preprocessed_level2"
    for i in range(extra_slides):  # slides without omic rows
        (prep / "patches" / f"TCGA-Z{i:03d}.h5").touch()
        np.save(prep / "patch_features" / f"TCGA-Z{i:03d}.npy", np.ones((4, PATCH_DIM)))
    got, want = _pair(root)
    _assert_same_data(got, want)
    assert len(got.omic_df) == 24


def test_overlap_table_written_back_as_the_jax_package_writes_it(tree, tmp_path):
    dirs = (tmp_path / "port", tmp_path / "jax")
    for d in dirs:
        d.mkdir()
    got, want = _pair(tree, log_dirs=dirs)
    port_csv, jax_csv = (d / "brca_omic_overlap.csv.zip" for d in dirs)
    a = pd.read_csv(port_csv, compression="zip", index_col=0)
    b = pd.read_csv(jax_csv, compression="zip", index_col=0)
    pd.testing.assert_frame_equal(a, b)
    with zipfile.ZipFile(port_csv) as zf:
        assert zf.namelist() == ["brca_omic_overlap.csv"]
    table = Table.read_csv(port_csv)
    assert table["y_disc"].dtype == np.int64 and table["slide_id"].dtype == object


def test_table_types_columns_as_pandas(tmp_path):
    df = pd.DataFrame({"i": [1, 2, 3], "f": [1.5, np.nan, -2.0], "s": ["a", "b,c", "d"],
                       "b": [True, False, True], "n": [np.nan] * 3, "e": [1, None, 3]})
    path = tmp_path / "t.csv.zip"
    df.to_csv(path, compression="zip")
    table = Table.read_csv(path).fill_missing_with_means()
    want = pd.read_csv(path, compression="zip", index_col=0)
    want = want.fillna(want.mean(numeric_only=True))
    assert table.columns == list(want.columns)
    for col in ("i", "f", "n", "e"):
        np.testing.assert_array_equal(table[col], want[col].to_numpy(np.float64), err_msg=col)
    assert table["i"].dtype == np.int64 and table["e"].dtype == np.float64
    assert table["s"].tolist() == ["a", "b,c", "d"] and table["b"].tolist() == [True, False, True]
    with pytest.raises(ValueError, match="not numeric"):
        table.matrix(["i", "s"])


def test_pt_features_load_through_torch(tmp_path, rng):
    root = write_tree(tmp_path / "tcga", rng, pt=True)
    got, want = _pair(root, data={"max_patches": 48})
    _assert_same_data(got, want)
    for i in (0, 5):
        a, b = got[i], want[i]
        np.testing.assert_array_equal(a[0][1], b[0][1])
    with pytest.raises(ValueError, match="npy"):
        _pair(root, patch_attention=True, data={"device_cache": True, "max_patches": 48})[0] \
            .feature_arena()


@pytest.mark.parametrize("align", [8, 16, 128])
def test_bucket_suggestions_and_arena_as_jax(tmp_path, rng, align):
    root = write_tree(tmp_path / "tcga", rng, bag=(8, 300))
    got, want = _pair(root, patch_attention=True, data={"device_cache": True})
    _assert_same_data(got, want)
    assert got.suggest_bucket_boundaries(align=align) == want.suggest_bucket_boundaries(align=align)
    if align == 128:
        assert got.suggest_bucket_boundaries() == [128, 256, got.max_patches]
    for a, b in zip(got.feature_arena(), want.feature_arena()):
        np.testing.assert_array_equal(a, b)
    for bounds in (None, [64, 128], [64, 1000]):
        for idx in (None, np.arange(0, 24, 3)):
            assert got.count_batches(idx, 4, bounds) == want.count_batches(idx, 4, bounds)


def _batches_equal(got_iter, want_iter):
    got, want = list(got_iter), list(want_iter)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            a, b = g[key], w[key]
            if isinstance(a, tuple):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    assert (x is None) == (y is None)
                    if x is not None:
                        assert x.dtype == y.dtype
                        np.testing.assert_array_equal(x, y, err_msg=key)
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=key)
    return got


@pytest.mark.parametrize("layout", ["tokens", "channels", "arena"])
@pytest.mark.parametrize("bounds", [None, [16, 32]])
@pytest.mark.parametrize("shuffle", [False, True])
def test_iter_batches_same_batches_same_order(tree, layout, bounds, shuffle):
    kw = {"channels": {}, "tokens": {"patch_attention": True},
          "arena": {"patch_attention": True, "data": {"device_cache": True}}}[layout]
    got, want = _pair(tree, **kw)
    assert got.device_cache == want.device_cache == (layout == "arena")
    idx = np.arange(2, 21)
    for ds_got, ds_want in ((got, want), (got.take(idx), want.take(idx))):
        _batches_equal(
            ds_got.iter_batches(4, shuffle=shuffle, rng=np.random.default_rng(7),
                                bucket_boundaries=bounds),
            ds_want.iter_batches(4, shuffle=shuffle, rng=np.random.default_rng(7),
                                 bucket_boundaries=bounds))
    np.testing.assert_array_equal(got.take(idx).indices, idx)  # shuffling copies
    m_got, m_want = got.materialize(idx), want.materialize(idx)
    _batches_equal([m_got], [m_want])


def test_raw_slides_not_ported_yet(tree, monkeypatch):
    """Raw slides go through the OpenSlide binding: without libopenslide
    both calls raise its error (tests/test_torch_port_explainer.py drives
    them through a fake library)."""
    from healnet_tpu_torch.etl import slides

    monkeypatch.setattr(slides, "_LIB", None)
    monkeypatch.setattr(slides, "_LIB_ERROR", "libopenslide not found")
    (tree / "wsi" / "brca" / "x").mkdir(parents=True)
    (tree / "wsi" / "brca" / "x" / "TCGA-R000.svs").touch()
    got, _ = _pair(tree)
    for call in (lambda: got.load_wsi("TCGA-R000"), lambda: got.get_resize_dims(2)):
        with pytest.raises(RuntimeError, match="libopenslide"):
            call()
    assert got.get_info()["molecular_shape"] == tuple(got.omic_df.shape)


# ----------------------------------------------------- runtime, utilities


def test_native_feature_cache_decodes_npy(tmp_path, rng):
    assert runtime.native_available()
    path = tmp_path / "f.npy"
    x = rng.normal(size=(37, 5)).astype(np.float32)
    np.save(path, x)
    cache = runtime.NativeFeatureCache(capacity_mb=4)
    cache.prefetch([path])
    np.testing.assert_array_equal(cache.load(path), x)
    np.testing.assert_array_equal(cache.load(path), x)
    assert cache.stats["entries"] == 1 and cache.stats["hits"] >= 1
    lib = runtime.library_path()
    assert lib.parent.parent.name == "build" and lib.parent.name.startswith("runtime-")


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_arena_quantized_on_the_device_equals_host_quantization(rng, dtype):
    arena = (rng.standard_normal((1000, 48)) * rng.uniform(0.1, 9, (1000, 1))).astype(dtype)
    arena[7] = 0.0  # a zero row: scale 0, values 0
    got = place_quantized(arena, torch.device("cpu"), chunk_rows=96)
    want = quantize_context_host(arena)
    np.testing.assert_array_equal(got.data.numpy(), want[0])
    np.testing.assert_array_equal(got.scale.numpy(), want[1])
    assert got.data.dtype == torch.int8 and got.scale.dtype == torch.float32


def test_compilation_cache_default_leaves_the_build_directory(tmp_path, monkeypatch):
    kernels, host = cuda_build.BUILD_ROOT, runtime.BUILD_ROOT
    enable_compilation_cache()
    assert cuda_build.BUILD_ROOT == kernels and runtime.BUILD_ROOT == host
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", kernels)
    monkeypatch.setattr(runtime, "BUILD_ROOT", host)
    enable_compilation_cache(str(tmp_path))
    assert cuda_build.build_dir().parent == tmp_path
    assert runtime.library_path().parents[1] == tmp_path


def test_step_timer_and_trace(tmp_path):
    timer = StepTimer(samples_per_step=4)
    for _ in range(3):
        timer.start()
        timer.stop(fence=torch.ones(2))
    summary = timer.summary()
    assert summary["steps"] == 2 and summary["samples_per_sec"] > 0
    assert StepTimer().summary()["steps"] == 0
    with pytest.raises(RuntimeError):
        StepTimer().stop()
    with trace(str(tmp_path / "trace")) as where:
        torch.ones(8).sum()
    assert json.loads((Path(where) / "trace.json").read_text())


def test_tracker_logs_and_norms_as_jax(tmp_path, rng):
    cfg = dict(n_modalities=2, channel_dims=(6, 5), num_spatial_axes=(1, 1), out_dims=4,
               depth=1, l_c=4, l_d=8, x_heads=1, cross_dim_head=4, l_heads=1,
               latent_dim_head=4, self_per_cross_attn=0)
    x = (np.ones((1, 1, 6), np.float32), np.ones((1, 3, 5), np.float32))
    params = jax.tree_util.tree_map(
        np.asarray, JaxHealNet(**cfg).init(jax.random.PRNGKey(0), x)["params"])
    state = state_dict_from_flax(params)
    got = Tracker(name="run", log_dir=str(tmp_path / "port"), config={"a": 1})
    want = JaxTracker(name="run", log_dir=str(tmp_path / "jax"), config={"a": 1})
    for tracker, p in ((got, state), (want, params)):
        tracker.log({"loss": np.float32(0.5), "c": 0.25}, step=1)
        tracker.watch(params=p, grad_stats={"global": torch.tensor(2.0)}, step=2, prefix="f_")
        tracker.log({"test": 1.0})
        tracker.finish()
    rows = [[json.loads(line) for line in open(t.log_dir / "metrics.jsonl")] for t in (got, want)]
    assert len(rows[0]) == len(rows[1]) == 3
    for a, b in zip(*rows):
        a.pop("time"), b.pop("time")
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-12, err_msg=key)
    a, b = (json.loads((t.log_dir / "summary.json").read_text()) for t in (got, want))
    assert a.keys() == b.keys() and "f_param_norm/global" in a


# -------------------------------------------------------------------- sweep


SWEEP_SPECS = {
    "grid": yaml.safe_load((REPO / "config" / "sweep_grid.yaml").read_text()),
    "random": {**yaml.safe_load((REPO / "config" / "sweep_bayesian.yaml").read_text()),
               "method": "random"},
    "bayes": yaml.safe_load((REPO / "config" / "sweep_bayesian.yaml").read_text()),
}


def _objective(params):
    """Deterministic, with a NaN trial and a varying key set."""
    score = sum(float(v) for v in params.values() if not isinstance(v, bool))
    out = {"mean_test_c_index": math.sin(score)}
    if int(score) % 5 == 0:
        out["extra"] = None
        out["mean_test_c_index"] = float("nan")
    return out


@pytest.mark.parametrize("method", ["grid", "random", "bayes"])
@pytest.mark.parametrize("seed", [0, 3])
def test_sweep_same_trials_for_the_same_seed(method, seed, tmp_path):
    got, want = Sweep(SWEEP_SPECS[method], seed=seed), JaxSweep(SWEEP_SPECS[method], seed=seed)
    best_got = got.run(_objective, n_trials=12, csv_path=tmp_path / "port.csv")
    best_want = want.run(_objective, n_trials=12, csv_path=tmp_path / "jax.csv")
    assert [t["params"] for t in got.trials] == [t["params"] for t in want.trials]
    assert best_got["params"] == best_want["params"]
    a, b = pd.read_csv(tmp_path / "port.csv"), pd.read_csv(tmp_path / "jax.csv")
    pd.testing.assert_frame_equal(a, b)


# ------------------------------------------------------------------ imports


FORBIDDEN = ("jax", "flax", "optax", "healnet_tpu", "pandas", "yaml", "h5py", "cv2",
             "torchvision")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "healnet_tpu_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_port_imports_no_jax_pandas_yaml_or_h5py(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"
