"""The port's explainer, slide binding, raw-slide loader and HDF5 reader and
writer, against the JAX package on the CPU.

A JAX ``Pipeline`` run with ``explainer: true`` (the synthetic tree of
``tests/test_explainer_tasks.py``), its best weights carried into a port
``Pipeline`` run of the same config (same splits, so the same test indices),
and both explainers on the same samples, dense and streaming: the same
patients in the same order, every ``.npy`` of the same shape with values
within 1e-5, ``_mask.npy`` equal, the rankings' features in the same order
wherever neighbouring scores differ by more than 1e-6. Slides come from a
fake libopenslide swapped into both ``slides`` modules; ``load_wsi`` agrees
with the JAX package's (cv2) within 1/255 a channel. The HDF5 reader reads
what h5py writes, equal to h5py's own reading, and h5py reads the writer's
files.
"""

import ctypes
import pickle
import sys
from pathlib import Path

import h5py
import jax
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

from healnet_tpu.etl import TCGADataset as JaxTCGADataset
from healnet_tpu.etl import slides as jax_slides
from healnet_tpu.models.explainer import Explainer as JaxExplainer
from healnet_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from healnet_tpu.train.pipeline import Pipeline as JaxPipeline
from healnet_tpu.utils import Box as JaxBox
from healnet_tpu_torch.compat.flax_params import state_dict_from_flax
from healnet_tpu_torch.etl import TCGADataset, h5
from healnet_tpu_torch.etl import slides as port_slides
from healnet_tpu_torch.etl.transforms import resize_linear_uint8
from healnet_tpu_torch.models import Explainer
from healnet_tpu_torch.models import explainer as explainer_module
from healnet_tpu_torch.train.checkpoint import Checkpointer
from healnet_tpu_torch.train.pipeline import Pipeline

sys.path.insert(0, str(Path(__file__).parent))
from test_slides_fake_lib import _premultiply  # noqa: E402

N_SAMPLES, N_FEATS, PATCH_DIM = 24, 10, 8
ATOL, GAP = 1e-5, 1e-6
SUFFIXES = ("omic_attention", "attention", "heatmap", "mask")


# ------------------------------------------------------------ the fake slide


class FastFakeOpenSlideLib:
    """A stand-in for libopenslide that fills ``read_region``'s buffer with
    numpy (premultiplied ARGB of a pattern at absolute level coordinates),
    with the C call conventions of ``tests/test_slides_fake_lib.py``."""

    def __init__(self, levels):
        self.levels = list(levels)
        self.closed = []

        class _Fn:
            def __init__(self, impl):
                self._impl, self.restype, self.argtypes = impl, None, None

            def __call__(self, *args):
                return self._impl(*args)

        def openslide_open(path):
            assert isinstance(path, bytes)
            return 7

        def openslide_get_level_dimensions(handle, level, wref, href):
            wref._obj.value, href._obj.value = self.levels[level]

        def openslide_read_region(handle, buf, x, y, level, w, h):
            assert type(buf)._type_ is ctypes.c_uint32 and len(buf) == w * h
            py, px = np.meshgrid(np.arange(h) + y // 4 ** level, np.arange(w) + x // 4 ** level,
                                 indexing="ij")
            a = np.uint32(200)
            r, g, b = (px * 7) % 256, (py * 5) % 256, (px + py) % 256
            arr = np.ctypeslib.as_array(buf)
            arr[:] = ((a << 24) | ((r * 200 // 255) << 16) | ((g * 200 // 255) << 8)
                      | (b * 200 // 255)).reshape(-1).astype(np.uint32)

        impls = dict(
            openslide_open=openslide_open,
            openslide_get_error=lambda handle: None,
            openslide_get_level_count=lambda handle: len(self.levels),
            openslide_get_level_dimensions=openslide_get_level_dimensions,
            openslide_read_region=openslide_read_region,
            openslide_get_property_names=lambda handle: [None],
            openslide_get_property_value=lambda handle, key: b"",
            openslide_close=lambda handle: self.closed.append(handle),
        )
        for name, impl in impls.items():
            setattr(self, name, _Fn(impl))


@pytest.fixture
def fake_slides(monkeypatch):
    lib = FastFakeOpenSlideLib([(2048, 512), (1024, 256), (512, 128)])
    for module in (jax_slides, port_slides):
        module._configure(lib)
        monkeypatch.setattr(module, "_LIB", lib)
        monkeypatch.setattr(module, "_LIB_ERROR", None)
    return lib


def test_fast_fake_matches_the_premultiplied_packing(fake_slides):
    buf = (ctypes.c_uint32 * 6)()
    fake_slides.openslide_read_region(7, buf, 0, 0, 0, 3, 2)
    assert buf[4] == _premultiply(7, 5, 2, 200)


# ------------------------------------------------------------- the two runs


def write_tcga(root: Path, rng, bags, raw: bool):
    """The tree of ``tests/test_explainer_tasks.py``: coords written by h5py
    (a row a patch, 256 apart), features ``(bag, 8)``, an omics CSV of 10
    genes; with ``raw`` an empty ``.svs`` per slide for the fake library."""
    (root / "omic").mkdir(parents=True)
    prep = root / "wsi" / "brca_preprocessed_level2"
    (prep / "patches").mkdir(parents=True)
    (prep / "patch_features").mkdir(parents=True)
    (root / "wsi" / "brca").mkdir(parents=True)
    sids = [f"TCGA-{i:04d}" for i in range(N_SAMPLES)]
    for sid, bag in zip(sids, bags):
        with h5py.File(prep / "patches" / f"{sid}.h5", "w") as f:
            cols = np.arange(bag) % 8
            f.create_dataset("coords", data=np.stack([cols * 256, (np.arange(bag) // 8) * 256],
                                                     axis=1).astype(np.int64))
        np.save(prep / "patch_features" / f"{sid}.npy",
                rng.normal(size=(bag, PATCH_DIM)).astype(np.float32))
        if raw:
            (root / "wsi" / "brca" / f"{sid}.svs").touch()
    df = pd.DataFrame(rng.normal(size=(N_SAMPLES, N_FEATS)).astype(np.float32),
                      columns=[f"g{i}" for i in range(N_FEATS - 2)] + ["age", "is_female"])
    df["site"] = "b"
    df["oncotree_code"] = "x"
    df["case_id"] = sids
    df["slide_id"] = [s + ".svs" for s in sids]
    df["train"] = 1
    df["censorship"] = rng.integers(0, 2, N_SAMPLES)
    df["survival_months"] = np.round(rng.uniform(5, 100, N_SAMPLES), 0)  # ties
    df.to_csv(root / "omic" / "tcga_brca_all_clean.csv.zip", compression="zip")


def run_config(root: Path, log_path: Path, tokens: bool) -> dict:
    return {
        "tcga_path": str(root), "log_path": str(log_path), "dataset": "brca",
        "model": "healnet", "explainer": True, "missing_ablation": False,
        "omic_attention": False, "patch_attention": tokens, "n_folds": 1, "wandb": False,
        "compilation_cache": False, "attention_impl": "xla",
        "data": {"wsi_level": 2}, "sources": ["omic", "slides"],
        "survival": {"loss": "nll", "subset": "uncensored"},
        "train_loop": {"batch_size": 8, "epochs": 1, "early_stopping": False,
                       "patience": 5, "gc_compat": 1},
        "optimizer": {"max_lr": 0.005, "lr": 0.005},
        "model_params": {
            "output_dims": 4, "class_weights": "None", "l1": 0.0, "num_freq_bands": 2,
            "depth": 2, "max_freq": 2.0, "num_latents": 6, "latent_dim": 8,
            "cross_dim_head": 4, "latent_dim_head": 4, "cross_heads": 2, "latent_heads": 2,
            "attn_dropout": 0.1, "ff_dropout": 0.1, "fourier_encode_data": True,
            "self_per_cross_attn": 1, "weight_tie_layers": False, "snn": True,
        },
    }


@pytest.fixture(scope="module", params=["channels", "tokens"])
def runs(request, tmp_path_factory):
    """(JAX run dir, port run dir, tree root, layout): the JAX run's best
    weights in the port run's checkpoint."""
    tokens = request.param == "tokens"
    root = tmp_path_factory.mktemp(f"explainer_{request.param}")
    rng = np.random.default_rng(3)
    bags = rng.integers(16, 600, N_SAMPLES) if tokens else np.full(N_SAMPLES, 6)
    write_tcga(root / "tcga", rng, bags, raw=tokens)
    jax_pipe = JaxPipeline(config=JaxBox(run_config(root / "tcga", root / "jax_logs", tokens)))
    jax_pipe.main()
    port_pipe = Pipeline(run_config(root / "tcga", root / "port_logs", tokens), device="cpu")
    port_pipe.main()
    jax_dir, port_dir = Path(jax_pipe.log_dir), Path(port_pipe.log_dir)
    params = jax.tree_util.tree_map(np.asarray,
                                    JaxCheckpointer(jax_dir / "checkpoints").restore_best())
    Checkpointer(port_dir / "checkpoints").save_best(state_dict_from_flax(params))
    return jax_dir, port_dir, root, request.param


def _pickled(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture
def explainers(runs, tmp_path, monkeypatch):
    jax_dir, port_dir, _, layout = runs
    monkeypatch.chdir(tmp_path)  # explanations/ under a temporary directory
    return JaxExplainer(jax_dir), Explainer(port_dir, device="cpu"), layout


def test_pipelines_write_the_same_artifacts(runs):
    jax_dir, port_dir, _, _ = runs
    np.testing.assert_array_equal(_pickled(port_dir / "test_data_indices.pkl"),
                                  _pickled(jax_dir / "test_data_indices.pkl"))
    jax_cfg, port_cfg = _pickled(jax_dir / "config.pkl"), _pickled(port_dir / "config.pkl")
    for key in ("dataset", "data.wsi_level", "model_params.depth", "omic_attention"):
        assert port_cfg[key] == jax_cfg[key]
    assert (port_dir / "checkpoints" / "best.pt").exists()


def _same_patients(jax_series, port_pairs):
    assert [(str(i), s) for i, s in jax_series.items()] == port_pairs


def test_patients_in_the_same_order(explainers):
    jx, px, _ = explainers
    for risk in ("high", "low"):
        for n in (1, 3, 8):
            _same_patients(jx.get_patients(n=n, risk=risk), px.get_patients(n=n, risk=risk))


def _rankings_agree(jax_df, port_table):
    want_f, want_a = list(jax_df["feature"]), np.asarray(jax_df["attention"])
    got_f, got_a = list(port_table["feature"]), np.asarray(port_table["attention"])
    assert len(got_f) == len(want_f)
    np.testing.assert_allclose(got_a, want_a, rtol=0, atol=ATOL)
    np.testing.assert_allclose(port_table["attention_scaled"],
                               np.asarray(jax_df["attention_scaled"]), rtol=0, atol=ATOL)
    assert not any(f in ("age", "is_female") for f in got_f)
    # features in runs of scores within GAP of each other may swap
    start = 0
    for i in range(1, len(want_a) + 1):
        if i == len(want_a) or want_a[i - 1] - want_a[i] > GAP:
            assert set(got_f[start:i]) == set(want_f[start:i])
            start = i


def _npys_agree(jx, px, names):
    for name in names:
        for suffix in SUFFIXES:
            a = jx.expl_dir / f"{name}_{suffix}.npy"
            if not a.exists():
                assert not (px.expl_dir / f"{name}_{suffix}.npy").exists()
                continue
            want, got = np.load(a), np.load(px.expl_dir / f"{name}_{suffix}.npy")
            assert got.shape == want.shape, (name, suffix)
            if suffix == "mask":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=name + suffix)


@pytest.mark.parametrize("streaming", [None, True], ids=["dense", "streaming"])
def test_explainer_run_matches_jax(explainers, streaming, fake_slides):
    jx, px, layout = explainers
    want = jx.run(n_high=2, n_low=1, streaming=streaming)
    got = px.run(n_high=2, n_low=1, streaming=streaming)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["slide_id"] == w["slide_id"]
        np.testing.assert_allclose(g["logits"], w["logits"], rtol=1e-5, atol=1e-6)
        _rankings_agree(w["omic_ranking"], g["omic_ranking"])
        assert (g["heatmap"] is None) == (w["heatmap"] is None)
    names = ["high_risk_0", "high_risk_1", "low_risk_0"]
    _npys_agree(jx, px, names)
    assert {p.name for p in px.expl_dir.glob("*.png")} == \
        {p.name for p in jx.expl_dir.glob("*.png")}
    if layout == "tokens":  # the slide image rendered through the fake library
        assert list(px.expl_dir.glob("high_risk_0_patch_0_high_res.png"))


def test_dense_and_streaming_agree_within_the_port(explainers):
    _, px, _ = explainers
    idx, slide_id = px.get_patients(n=1)[0]
    dense = px.run_sample_explanation(idx, slide_id, save_name="dense", streaming=False)
    stream = px.run_sample_explanation(int(idx), slide_id, save_name="stream", streaming=True)
    _rankings_agree({k: np.asarray(v) for k, v in
                     (("feature", dense["omic_ranking"]["feature"]),
                      ("attention", dense["omic_ranking"]["attention"]),
                      ("attention_scaled", dense["omic_ranking"]["attention_scaled"]))},
                    stream["omic_ranking"])
    for suffix in SUFFIXES:
        np.testing.assert_allclose(np.load(px.expl_dir / f"stream_{suffix}.npy"),
                                   np.load(px.expl_dir / f"dense_{suffix}.npy"),
                                   rtol=0, atol=ATOL)


def test_large_bags_stream_by_default(explainers, monkeypatch):
    """A bag past ``STREAMING_TOKENS`` streams (the dense capture is never
    called) and agrees with JAX's: 8,192 patches in the tokens layout; in
    the channels layout (8 tokens, the feature dim) the port's threshold is
    lowered to 7 and the JAX explainer asked to stream."""
    jx, px, layout = explainers
    if layout == "tokens":
        big = np.random.default_rng(0).normal(size=(8192, PATCH_DIM)).astype(np.float32)
        for ex in (jx, px):
            def big_sample(pos, orig=ex.data._sample):
                tensors, a, b, c, _ = orig(pos)
                return list(tensors[:-1]) + [big], a, b, c, 8192

            monkeypatch.setattr(ex.data, "_sample", big_sample)
        jax_streaming = None
    else:
        monkeypatch.setattr(explainer_module, "STREAMING_TOKENS", 7)
        jax_streaming = True
    for ex in (jx, px):
        monkeypatch.setattr(ex.model, "get_attention_weights",
                            lambda: (_ for _ in ()).throw(AssertionError("dense capture")))
    idx, slide_id = px.get_patients(n=1)[0]
    px.run_sample_explanation(idx, slide_id, save_name="big")
    jx.run_sample_explanation(int(idx), slide_id, save_name="big", streaming=jax_streaming)
    _npys_agree(jx, px, ["big"])
    tokens = 8192 if layout == "tokens" else PATCH_DIM
    assert np.load(px.expl_dir / "big_attention.npy").shape == (tokens,)


def test_plot_entry_points_match_jax(explainers):
    """``plot_omic_attn`` and ``plot_slide_attn`` on the same dense maps."""
    jx, px, _ = explainers
    r = np.random.default_rng(1)
    omic = [r.uniform(size=(2, 6, N_FEATS)).astype(np.float32) for _ in range(3)]
    _, slide_id = px.get_patients(n=1)[0]
    coords = px.load_patch_coords(slide_id)
    np.testing.assert_array_equal(coords, jx.load_patch_coords(slide_id))
    width = px.data.max_patches if px.data.patch_attention else PATCH_DIM
    slide = [r.uniform(size=(2, 6, width)).astype(np.float32) for _ in range(2)]
    for ex in (jx, px):
        ex.save_name = "plot"
    _rankings_agree(jx.plot_omic_attn(omic, k=5), px.plot_omic_attn(omic, k=5))
    want = jx.plot_slide_attn(slide_id, slide, coords, heatmap=False, save_patches=False)
    got = px.plot_slide_attn(slide_id, slide, coords, heatmap=False, save_patches=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _npys_agree(jx, px, ["plot"])


def test_figures_skipped_without_matplotlib(explainers, monkeypatch, capsys):
    _, px, _ = explainers
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    idx, slide_id = px.get_patients(n=1)[0]
    result = px.run_sample_explanation(idx, slide_id, save_name="nompl")
    said = capsys.readouterr().out
    assert "skipped" in said and "nompl_omic_attn.png" in said
    assert not list(px.expl_dir.glob("nompl_*.png"))
    for suffix in SUFFIXES:
        assert (px.expl_dir / f"nompl_{suffix}.npy").exists()
    assert result["heatmap"] is not None and len(result["omic_ranking"]["feature"]) > 0


def test_unknown_sample_and_risk_raise(explainers):
    _, px, _ = explainers
    with pytest.raises(KeyError):
        px.run_sample_explanation("no-such-label", "x")
    with pytest.raises(ValueError):
        px.get_patients(risk="medium")


# ------------------------------------------------------ slides and load_wsi


def test_read_slide_image_and_high_res_patches(fake_slides, tmp_path, monkeypatch):
    raw = tmp_path / "wsi" / "brca"
    raw.mkdir(parents=True)
    (raw / "S1.svs").touch()
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, cls in (("jax", JaxExplainer), ("port", Explainer)):
        ex = cls.__new__(cls)
        ex.raw_path, ex.level, ex.save_name = raw, 2, name
        ex.expl_dir = tmp_path / name
        ex.expl_dir.mkdir()
        img, scale = ex._read_slide_image("S1")
        assert ex._read_slide_image("MISSING") == (None, 1.0)
        ex._save_high_res_patches("S1", np.array([[0, 0], [512, 256]]), (32, 32), scale)
        out[name] = (img, scale, sorted(p.name for p in ex.expl_dir.iterdir()))
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1] == 4.0
    assert [n.replace("port", "jax") for n in out["port"][2]] == out["jax"][2]
    for a, b in zip(out["jax"][2], out["port"][2]):
        import matplotlib.pyplot as plt

        np.testing.assert_array_equal(plt.imread(tmp_path / "port" / b),
                                      plt.imread(tmp_path / "jax" / a))


def test_openslide_binding_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(port_slides, "_LIB", None)
    monkeypatch.setattr(port_slides, "_LIB_ERROR", "libopenslide not found")
    assert not port_slides.openslide_available()
    with pytest.raises(RuntimeError, match="libopenslide"):
        port_slides.OpenSlide(tmp_path / "s.svs")


@pytest.mark.parametrize("level", [0, 1, 2, 99, None])
def test_load_wsi_matches_jax(fake_slides, tmp_path, rng, level):
    write_tcga(tmp_path / "tcga", rng, np.full(N_SAMPLES, 6), raw=True)
    config = {"tcga_path": str(tmp_path / "tcga"), "model": "healnet",
              "omic_attention": True, "survival.subset": "uncensored"}
    want_ds = JaxTCGADataset("brca", JaxBox(config), level=2, n_bins=2)
    got_ds = TCGADataset("brca", config, level=2, n_bins=2)
    assert got_ds.get_resize_dims(1) == want_ds.get_resize_dims(1)
    slide, got = got_ds.load_wsi("TCGA-0001", level=level)
    _, want = want_ds.load_wsi("TCGA-0001", level=level)
    assert slide.level_count == 3 and got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1 / 255 + 1e-7
    override = dict(config, **{"data.resize": True, "data.resize_width": 300,
                               "data.resize_height": 100})
    got_ds.config = override
    assert got_ds.get_resize_dims(0, override=True) == (300, 100)
    assert got_ds.load_wsi("TCGA-0001", level=level)[1].shape == (100, 300, 3)


@pytest.mark.parametrize("src,dst", [((96, 128), (128, 128)), ((33, 65), (129, 17)),
                                     ((7, 3), (64, 64)), ((500, 300), (128, 384)),
                                     ((50, 50), (25, 25))])
def test_resize_linear_within_one_of_cv2(rng, src, dst, monkeypatch):
    import cv2

    from healnet_tpu_torch.etl import transforms

    monkeypatch.setattr(transforms, "_ROWS_PER_BLOCK", 7)  # several blocks
    img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = resize_linear_uint8(img, dst[1], dst[0])
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    gray = resize_linear_uint8(img[:, :, 0], dst[1], dst[0])
    np.testing.assert_array_equal(gray, got[:, :, 0])


# ---------------------------------------------------------------- HDF5


DTYPES = ["<i8", "<i4", "<u2", "u1", ">i8", "<f4", ">f8", "<f2"]


@st.composite
def h5_case(draw):
    rank = draw(st.integers(1, 3))
    shape = tuple(draw(st.lists(st.integers(0, 9), min_size=rank, max_size=rank)))
    dtype = draw(st.sampled_from(DTYPES))
    layout = draw(st.sampled_from(["contiguous", "compact", "chunked", "resizable"]))
    chunks = tuple(draw(st.integers(1, 6)) for _ in range(rank))
    gzip = layout in ("chunked", "resizable") and draw(st.booleans())
    shuffle = gzip and draw(st.booleans())
    libver = draw(st.sampled_from(["earliest", "latest"]))
    unlimited = draw(st.integers(0, rank - 1))
    seed = draw(st.integers(0, 2**16))
    return shape, dtype, layout, chunks, gzip, shuffle, libver, unlimited, seed


def _write_case(path, data, layout, chunks, gzip, shuffle, libver, unlimited):
    with h5py.File(path, "w", libver=libver) as f:
        if layout == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            dsid = h5py.h5d.create(f.id, b"x", h5py.h5t.py_create(data.dtype),
                                   h5py.h5s.create_simple(data.shape), dcpl=dcpl)
            dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))
            d = f["x"]
        elif layout == "contiguous":
            d = f.create_dataset("x", data=data)
        else:
            maxshape = tuple(None if layout == "resizable" and dim == unlimited else size
                             for dim, size in enumerate(data.shape))
            chunks = tuple(c if m is None else max(1, min(c, m))
                           for c, m in zip(chunks, maxshape))
            d = f.create_dataset("x", data=data, chunks=chunks, maxshape=maxshape,
                                 compression="gzip" if gzip else None, shuffle=shuffle)
        d.attrs["scalar"] = np.array(3, dtype=data.dtype)[()]
        d.attrs["vector"] = data.reshape(-1)[:4]
        f.create_group("g").create_dataset("y", data=np.arange(5, dtype="<i4"))


@settings(max_examples=80, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(case=h5_case())
def test_h5_reads_what_h5py_writes(tmp_path, case):
    shape, dtype, layout, chunks, gzip, shuffle, libver, unlimited, seed = case
    # h5py chunks no fixed dimension of size 0
    assume(layout == "contiguous" or all(
        size > 0 or (layout == "resizable" and dim == unlimited)
        for dim, size in enumerate(shape)))
    data = (np.random.default_rng(seed).normal(size=shape) * 50).astype(dtype)
    path = tmp_path / "case.h5"
    _write_case(path, data, layout, chunks, gzip, shuffle, libver, unlimited)
    with h5py.File(path, "r") as f:
        want = f["x"][()]
        want_attrs = dict(f["x"].attrs)
    got = h5.read_dataset(path, "x")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    attrs = h5.read_attrs(path, "x")
    assert set(attrs) == set(want_attrs)
    for k, v in want_attrs.items():
        np.testing.assert_array_equal(attrs[k], v)
    np.testing.assert_array_equal(h5.read_dataset(path, "g/y"), np.arange(5))
    assert h5.read_dataset(path, "missing") is None


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("rows", [1, 2000, 30000])
def test_h5_reads_clam_resizable_coords(tmp_path, libver, rows):
    """CLAM's save_hdf5: a resizable coords dataset of one-row chunks,
    grown by appends (a multi-level B-tree, or an extensible array)."""
    coords = np.random.default_rng(rows).integers(0, 10**6, (rows, 2))
    path = tmp_path / "clam.h5"
    with h5py.File(path, "w", libver=libver) as f:
        d = f.create_dataset("coords", shape=(min(rows, 100), 2), maxshape=(None, 2),
                             chunks=(1, 2), dtype=np.int64)
        d[:] = coords[:min(rows, 100)]
        for start in range(100, rows, 997):
            stop = min(start + 997, rows)
            d.resize(stop, axis=0)
            d[start:stop] = coords[start:stop]
        d.attrs["patch_size"] = 256
        d.attrs["patch_level"] = 1
    np.testing.assert_array_equal(h5.read_dataset(path, "coords"), coords)
    assert h5.read_attrs(path, "coords") == {"patch_size": 256, "patch_level": 1}


@pytest.mark.parametrize("rows", [0, 1, 5, 5000])
def test_h5_writer_read_back_by_h5py(tmp_path, rows):
    coords = np.random.default_rng(rows).integers(0, 10**6, (rows, 2)).astype(np.int32)
    path = tmp_path / "w.h5"
    h5.write_coords(path, coords, 256, 2)
    with h5py.File(path, "r") as f:
        d = f["coords"]
        assert d.dtype == np.int64 and d.shape == (rows, 2)
        np.testing.assert_array_equal(d[()], coords)
        assert dict(d.attrs) == {"patch_size": 256, "patch_level": 2}
        assert d.attrs["patch_size"].dtype == np.int64
        assert list(f) == ["coords"]
    np.testing.assert_array_equal(h5.read_dataset(path, "coords"), coords)
    assert h5.read_attrs(path, "coords") == {"patch_size": 256, "patch_level": 2}


def test_h5_names_what_it_does_not_read(tmp_path):
    path = tmp_path / "u.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("v2", data=np.zeros((4, 4)), maxshape=(None, None), chunks=(2, 2))
        f.create_dataset("vlen", data=np.array([b"a", b"bc"], dtype=object),
                         dtype=h5py.string_dtype())
    with pytest.raises(NotImplementedError, match="version 2 B-tree"):
        h5.read_dataset(path, "v2")
    with pytest.raises(NotImplementedError, match="variable-length"):
        h5.read_dataset(path, "vlen")
    with h5py.File(path, "w") as f:
        f.create_dataset("fl", data=np.arange(8.0), chunks=(4,), fletcher32=True)
        f.create_dataset("s", data=np.array([b"ab", b"c"]))
    with pytest.raises(NotImplementedError, match="filter 3"):
        h5.read_dataset(path, "fl")
    with pytest.raises(NotImplementedError, match="string"):
        h5.read_dataset(path, "s")
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(12):  # past 8 links: dense link storage
            f.create_dataset(f"d{i}", data=np.arange(i + 1))
    with pytest.raises(NotImplementedError, match="fractal heap"):
        h5.read_dataset(path, "d3")
    with pytest.raises(KeyError):
        h5.read_attrs(_writer_file(tmp_path), "missing")
    (tmp_path / "empty.h5").touch()
    with pytest.raises(ValueError):
        h5.read_dataset(tmp_path / "empty.h5", "coords")


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("chunks", [None, (2, 2)])
def test_h5_unwritten_storage_reads_the_fill_value(tmp_path, libver, chunks):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver=libver) as f:
        d = f.create_dataset("x", shape=(5, 3), dtype="<i4", fillvalue=7, chunks=chunks,
                             maxshape=(None, 3) if chunks else None)
        if chunks:
            d[:2] = 1  # one chunk row written, the rest left unallocated
        f.create_dataset("y", shape=(4,), dtype="<f8")
    with h5py.File(path, "r") as f:
        want_x, want_y = f["x"][()], f["y"][()]
    np.testing.assert_array_equal(h5.read_dataset(path, "x"), want_x)
    np.testing.assert_array_equal(h5.read_dataset(path, "y"), want_y)


def _writer_file(tmp_path):
    path = tmp_path / "small.h5"
    h5.write_coords(path, np.zeros((2, 2)), 256, 0)
    return path
