"""The port's data-ops (``cli/tasks.py``, ``ops/resnet.py``,
``etl/manifests.py``, ``utils/profiling.py::log_compile_time``) against the
JAX package on the CPU.

- ResNet-50 on carried Flax variables (BatchNorm statistics perturbed) and
  on a torchvision-layout checkpoint with ``fc.*`` keys: each stage's last
  block and the pooled features within 2e-4 of the largest value;
  ``PatchFeatureExtractor`` against JAX's on 6 patches at batch 4 (a ragged
  last chunk), both loading the same ``.pt``: 2e-4.
- ``segment_tissue``: the saturation over all 256 x 256 (max, min) pairs,
  and the mask under hypothesis over thumbnails of 7-300 pixels a side,
  equal to the JAX package's (OpenCV's) bit for bit; ``patch_slide``'s
  coords equal on slides whose level sizes do not divide evenly.
- ``preprocess`` patch then features, port against JAX on the same fake
  slides (a numpy stand-in for libopenslide in both ``slides`` modules):
  coords and attributes read back by h5py, features within 2e-4 at patch
  size 224 (both resizes the identity), the resized patches within 1 of
  cv2 at 256, the printed lines of ``max_patches``, resume, a missing h5
  and the attributes' override, ``.pt`` output.
- Manifests read, filtered, written and sampled as pandas does them;
  ``install``, ``download`` (``subprocess.run`` mocked) and ``flatten``
  as JAX's; ``log_compile_time``'s lines.
- The CLI in a fresh process with pandas, PyYAML, h5py, cv2, torchvision
  and the JAX stack blocked.
"""

import ctypes
import inspect
import io
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import cv2
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from healnet_tpu.cli import tasks as jax_tasks
from healnet_tpu.etl import manifests as jax_manifests
from healnet_tpu.etl import slides as jax_slides
from healnet_tpu.ops import resnet as jax_resnet
from healnet_tpu.utils import profiling as jax_profiling
from healnet_tpu_torch.cli import tasks
from healnet_tpu_torch.compat import state_dict_from_flax_resnet
from healnet_tpu_torch.etl import manifests
from healnet_tpu_torch.etl import slides as port_slides
from healnet_tpu_torch.ops import resnet
from healnet_tpu_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).parent))
from test_resnet_import import _randomise_bn_stats, _ResNet50  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MANIFESTS = sorted((REPO / "data" / "tcga" / "gdc_manifests").glob("*/*.txt"))
RESNET_TOL, STAGES = 2e-4, (3, 4, 6, 3)


def rel_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / (np.max(np.abs(b)) + 1e-12))


# ---------------------------------------------------------------- the slides


class BlobSlideLib:
    """libopenslide's C surface over numpy (the call conventions of
    ``tests/test_torch_port_explainer.py::FastFakeOpenSlideLib``): every
    path opens a slide of the given level sizes, stained discs of textured
    tissue on a white background, their layout seeded by the file's stem."""

    def __init__(self, levels, n_blobs=3):
        self.levels = [tuple(map(int, lv)) for lv in levels]
        self.handles = {}

        class _Fn:
            def __init__(self, impl):
                self._impl, self.restype, self.argtypes = impl, None, None

            def __call__(self, *args):
                return self._impl(*args)

        def openslide_open(path):
            stem = path.decode().rsplit("/", 1)[-1].rsplit(".", 1)[0]
            rng = np.random.default_rng(sum(stem.encode()) * 7919 + len(stem))
            self.handles[len(self.handles) + 1] = np.column_stack([
                rng.uniform(0.2, 0.8, n_blobs), rng.uniform(0.2, 0.8, n_blobs),
                rng.uniform(0.12, 0.3, n_blobs)])
            return len(self.handles)

        def openslide_get_level_dimensions(handle, level, wref, href):
            wref._obj.value, href._obj.value = self.levels[level]

        def openslide_read_region(handle, buf, x, y, level, w, h):
            assert type(buf)._type_ is ctypes.c_uint32 and len(buf) == w * h
            (w0, h0), (wl, hl) = self.levels[0], self.levels[level]
            px = np.arange(w, dtype=np.int64) + x * wl // w0
            py = np.arange(h, dtype=np.int64) + y * hl // h0
            fx, fy = (px[None, :] + 0.5) / wl, (py[:, None] + 0.5) / hl
            inside = np.zeros((h, w), bool)
            for cx, cy, r in self.handles[handle]:
                inside |= (fx - cx) ** 2 + (fy - cy) ** 2 < r * r
            noise = ((px[None, :] * 73856093) ^ (py[:, None] * 19349663) ^ (level * 83492791)) % 61
            r = np.where(inside, 190 - noise, 238 + noise % 13)
            g = np.where(inside, 90 + noise // 2, 238 + noise % 13)
            b = np.where(inside, 180 - noise // 3, 238 + noise % 13)
            arr = np.ctypeslib.as_array(buf)
            arr[:] = ((255 << 24) | (r << 16) | (g << 8) | b).reshape(-1).astype(np.uint32)

        impls = dict(
            openslide_open=openslide_open,
            openslide_get_error=lambda handle: None,
            openslide_get_level_count=lambda handle: len(self.levels),
            openslide_get_level_dimensions=openslide_get_level_dimensions,
            openslide_read_region=openslide_read_region,
            openslide_get_property_names=lambda handle: [None],
            openslide_get_property_value=lambda handle, key: b"",
            openslide_close=lambda handle: None,
        )
        for name, impl in impls.items():
            setattr(self, name, _Fn(impl))


# level sizes that do not divide evenly (each level a quarter, floored)
TREE_LEVELS = [(3000, 2200), (750, 550), (187, 137)]
WIDE_LEVELS = [(20011, 15013), (5002, 3753), (1250, 938), (312, 234)]


def install_lib(monkeypatch, levels):
    lib = BlobSlideLib(levels)
    for module in (jax_slides, port_slides):
        module._configure(lib)
        monkeypatch.setattr(module, "_LIB", lib)
        monkeypatch.setattr(module, "_LIB_ERROR", None)
    return lib


@pytest.fixture
def fake_slides(monkeypatch):
    return install_lib(monkeypatch, TREE_LEVELS)


# ---------------------------------------------------------------- ResNet-50


@pytest.fixture(scope="module")
def flax_resnet():
    """JAX's ResNet-50 variables on a (2, 64, 64, 3) input, BatchNorm
    statistics and affine terms perturbed, and that input."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_resnet.ResNet50(features_only=True).init(jax.random.PRNGKey(0),
                                                                  jnp.asarray(x)))
    variables = {k: jax.tree_util.tree_map(np.array, dict(v)) for k, v in variables.items()}

    def perturb(params, stats):
        for name, leaf in stats.items():
            if "mean" in leaf:
                n = leaf["mean"].shape[0]
                leaf["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
                leaf["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                params[name]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                params[name]["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            else:
                perturb(params[name], leaf)

    perturb(variables["params"], variables["batch_stats"])
    return variables, x


def jax_stages(variables, x):
    pooled, state = jax_resnet.ResNet50(features_only=True).apply(
        variables, jnp.asarray(x), train=False,
        capture_intermediates=lambda mdl, name: name == "__call__", mutable=["intermediates"])
    inter = state["intermediates"]
    return np.asarray(pooled), [np.asarray(inter[f"layer{s + 1}_{b - 1}"]["__call__"][0])
                                for s, b in enumerate(STAGES)]


def port_stages(model, x):
    """The pooled features and each stage's last block (NHWC) of the port's
    model on NHWC ``x``."""
    outs = []
    hooks = [getattr(model, f"layer{s + 1}")[-1].register_forward_hook(
        lambda mod, inp, out: outs.append(out.numpy().transpose(0, 2, 3, 1)))
        for s in range(4)]
    with torch.no_grad():
        pooled = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    for h in hooks:
        h.remove()
    return pooled, outs


def assert_stages_close(got, want):
    (pooled, stages), (ref_pooled, ref_stages) = got, want
    for s, (a, b) in enumerate(zip(stages, ref_stages)):
        assert a.shape == b.shape and rel_err(a, b) < RESNET_TOL, f"stage {s + 1}"
    assert pooled.shape == ref_pooled.shape == (2, 2048)
    assert rel_err(pooled, ref_pooled) < RESNET_TOL


def test_resnet_on_carried_flax_variables(flax_resnet):
    variables, x = flax_resnet
    model = resnet.ResNet50().eval()
    state = state_dict_from_flax_resnet(variables)
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    assert_stages_close(port_stages(model, x), jax_stages(variables, x))


def torchvision_checkpoint(seed: int):
    """A torchvision-layout ResNet-50 state_dict (the hand-built model of
    ``tests/test_resnet_import.py``, BatchNorm randomised) with the
    ``fc.*`` keys a torchvision checkpoint carries."""
    torch.manual_seed(seed)
    ref = _ResNet50().eval()
    with torch.no_grad():
        _randomise_bn_stats(ref, np.random.default_rng(seed))
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    state["fc.weight"] = torch.zeros(1000, 2048)
    state["fc.bias"] = torch.zeros(1000)
    return state


def test_resnet_on_torchvision_state_dict(flax_resnet):
    template, x = flax_resnet
    state = torchvision_checkpoint(1)
    variables = jax_resnet.params_from_torchvision_state_dict(state, template)
    model = resnet.load_torchvision_state_dict(resnet.ResNet50().eval(), state)
    assert model.fc is None
    assert_stages_close(port_stages(model, x), jax_stages(variables, x))


def test_load_refuses_a_checkpoint_missing_weights():
    state = torchvision_checkpoint(2)
    del state["layer3.2.bn2.running_var"]
    with pytest.raises(KeyError, match="layer3.2.bn2.running_var"):
        resnet.load_torchvision_state_dict(resnet.ResNet50(), state)


def test_resnet_with_head_and_seeded_random_weights():
    a, b = resnet.ResNet50(generator=torch.Generator().manual_seed(3)), resnet.ResNet50(
        generator=torch.Generator().manual_seed(3))
    c = resnet.ResNet50(generator=torch.Generator().manual_seed(4))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    head = resnet.ResNet50(num_classes=10, features_only=False).eval()
    with torch.no_grad():
        assert head(torch.zeros(2, 3, 32, 32)).shape == (2, 10)


@pytest.fixture(scope="module")
def extractors(tmp_path_factory):
    """JAX's and the port's extractors at batch 4 on the same checkpoint."""
    ckpt = tmp_path_factory.mktemp("resnet") / "resnet50.pt"
    torch.save(torchvision_checkpoint(5), ckpt)
    return (jax_resnet.PatchFeatureExtractor(weights_path=str(ckpt), batch_size=4),
            resnet.PatchFeatureExtractor(weights_path=str(ckpt), batch_size=4, device="cpu"),
            ckpt)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_patch_extractor_against_jax(extractors, dtype):
    jax_ex, port_ex, _ = extractors
    rng = np.random.default_rng(6)
    patches = rng.integers(0, 256, (6, 224, 224, 3)).astype(np.uint8)
    if dtype == "float32":
        patches = patches.astype(np.float32) / 255.0
    want, got = jax_ex(patches), port_ex(patches)
    assert port_ex.pretrained and got.shape == (6, 2048) and got.dtype == np.float32
    assert rel_err(got, want) < RESNET_TOL
    # the ragged last chunk (2 of 4) gives what a full chunk gives
    np.testing.assert_allclose(port_ex(patches[4:]), got[4:], rtol=1e-5, atol=1e-6)


def test_patch_extractor_needs_a_gpu_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.PatchFeatureExtractor()
    ex = resnet.PatchFeatureExtractor(device="cpu")
    assert not ex.pretrained and ex.device.type == "cpu"


def test_patch_extractor_leaves_tf32_alone():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    ex = resnet.PatchFeatureExtractor(device="cpu", batch_size=2)
    ex(np.zeros((3, 32, 32, 3), np.uint8))
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


# ---------------------------------------------------------- tissue and grid


def test_saturation_over_every_max_min_pair():
    hi, lo = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ordered = lo <= hi
    mid = (hi + lo) // 2
    for channels in ((hi, lo, lo), (lo, hi, mid), (mid, lo, hi)):
        img = np.stack(channels, axis=-1).astype(np.uint8)
        want = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)[..., 1]
        np.testing.assert_array_equal(tasks.hsv_saturation(img)[ordered], want[ordered])


def thumbnail(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8), (h, w, 3)).copy()
    if kind == "two":
        colours = rng.integers(0, 256, (2, 3), dtype=np.uint8)
        return colours[(rng.random((h, w)) < rng.uniform(0.05, 0.95)).astype(int)]
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    img = np.full((h, w, 3), 245, np.uint8)  # blobs of stain on white
    yy, xx = np.mgrid[:h, :w]
    for _ in range(rng.integers(1, 4)):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, max(h, w) / 2)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers([120, 30, 120], [220, 120, 220])
    noise = rng.integers(-12, 13, (h, w, 3))
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


@settings(max_examples=60, deadline=None, suppress_health_check=list(HealthCheck))
@given(kind=st.sampled_from(["flat", "two", "noise", "blobs"]), h=st.integers(7, 300),
       w=st.integers(7, 300), seed=st.integers(0, 2**31 - 1))
def test_segment_tissue_equals_opencv(kind, h, w, seed):
    thumb = thumbnail(kind, h, w, seed)
    np.testing.assert_array_equal(tasks.segment_tissue(thumb), jax_tasks.segment_tissue(thumb))


def test_segment_tissue_on_the_blob():
    """The thumbnail of ``tests/test_explainer_tasks.py``."""
    thumb = np.full((128, 128, 3), 250, np.uint8)
    thumb[30:90, 40:100] = [160, 60, 160]
    mask = tasks.segment_tissue(thumb)
    np.testing.assert_array_equal(mask, jax_tasks.segment_tissue(thumb))
    assert mask[50, 60] and not mask[5, 5] and 0.1 < mask.mean() < 0.6


@pytest.mark.parametrize("level,patch_size,step,thumb_max", [
    (1, 256, None, 1024), (0, 512, 384, 1024), (2, 64, None, 100), (1, 200, 150, 90),
    (3, 32, None, 1024)])
def test_patch_slide_coords_equal(monkeypatch, level, patch_size, step, thumb_max):
    install_lib(monkeypatch, WIDE_LEVELS)
    slide = port_slides.OpenSlide("TCGA-WIDE-01.svs")
    kw = dict(level=level, patch_size=patch_size, step=step, thumb_max=thumb_max)
    got, want = tasks.patch_slide(slide, **kw), jax_tasks.patch_slide(slide, **kw)
    assert got.dtype == want.dtype == np.int64 and got.shape[1:] == (2,)
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got)


@pytest.mark.parametrize("dtype", ["uint8", "float32", "float64"])
@pytest.mark.parametrize("src,dst", [((37, 53, 3), (224, 224)), ((300, 200, 1), (17, 41)),
                                     ((256, 256, 3), (224, 224)), ((64, 64), (32, 96))])
def test_resize_transform_equals_opencv(dtype, src, dst):
    """The port's ResizeTransform (numpy, no cv2) against the JAX package's
    (cv2): uint8 within 1, float32 within 4 ulps of the largest value,
    float64 within 1e-12 of it; a one-channel image comes back 2-D."""
    from healnet_tpu.etl.transforms import ResizeTransform as JaxResize
    from healnet_tpu_torch.etl.transforms import ResizeTransform

    img = (np.random.default_rng(7).random(src) * 255).astype(dtype)
    want, got = JaxResize(*dst)(img), ResizeTransform(*dst)(img)
    assert got.shape == want.shape and got.dtype == want.dtype
    top = float(np.abs(want).max())
    tol = {"uint8": 1, "float32": 4 * float(np.spacing(np.float32(top))),
           "float64": 1e-12 * top}[dtype]
    assert np.abs(got.astype(np.float64) - want.astype(np.float64)).max() <= tol


# ---------------------------------------------------------------- preprocess


SLIDES = ("TCGA-AA-0001-01Z-00-DX1", "TCGA-AB-0002-01Z-00-DX1")


def make_tree(root: Path, slides=SLIDES) -> Path:
    """Empty ``.svs`` files for the fake library under ``wsi/brca`` (one in
    a subdirectory) and a config pointing at the tree; returns the config."""
    for i, sid in enumerate(slides):
        folder = root / "wsi" / "brca" / (f"dir{i}" if i % 2 else "")
        folder.mkdir(parents=True, exist_ok=True)
        (folder / f"{sid}.svs").touch()
    return write_config(root)


def write_config(root: Path) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    config = root / "config.yml"
    config.write_text(f'tcga_path: "{root}"\ngdc_client: "{root}/gdc-client"\n')
    return config


def run_both(tmp_path, capsys, start: Path, step):
    """``step(module, config)`` with the JAX package's and the port's tasks
    module, each on its own copy of the tree ``start`` at one path: (JAX
    tree, JAX lines, port tree, port lines)."""
    out = []
    for name, module in (("jax", jax_tasks), ("port", tasks)):
        tree = tmp_path / "tree"
        if tree.exists():
            shutil.rmtree(tree)
        shutil.copytree(start, tree)
        capsys.readouterr()
        step(module, write_config(tree))
        lines = capsys.readouterr().out.splitlines()
        shutil.copytree(tree, tmp_path / name)
        out += [tmp_path / name, lines]
    return out


def prep_dir(tree: Path, level: int) -> Path:
    return tree / "wsi" / f"brca_preprocessed_level{level}"


def patched_tree(tmp_path, patch_size=256, level=1) -> Path:
    start = tmp_path / "start"
    make_tree(start)
    tasks.preprocess("brca", str(start / "config.yml"), level=level, patch_size=patch_size,
                     step="patch")
    return start


@pytest.mark.parametrize("level,patch_size", [(1, 256), (0, 512), (2, 64), (3, 64)])
def test_preprocess_patch_step_equal(fake_slides, tmp_path, capsys, level, patch_size):
    start = tmp_path / "start"
    make_tree(start)
    jax_tree, jax_lines, port_tree, port_lines = run_both(
        tmp_path, capsys, start,
        lambda m, cfg: m.preprocess("brca", str(cfg), level=level, step="patch",
                                    patch_size=patch_size))
    assert port_lines == jax_lines
    names = sorted(p.name for p in (prep_dir(jax_tree, level) / "patches").glob("*.h5"))
    assert names == sorted(p.name for p in (prep_dir(port_tree, level) / "patches").glob("*.h5"))
    assert len(names) == (0 if level == 3 else len(SLIDES))
    for name in names:
        with h5py.File(prep_dir(jax_tree, level) / "patches" / name) as a, \
                h5py.File(prep_dir(port_tree, level) / "patches" / name) as b:
            assert a["coords"].dtype == b["coords"].dtype == np.int64
            np.testing.assert_array_equal(b["coords"][:], a["coords"][:])
            assert dict(b["coords"].attrs) == dict(a["coords"].attrs)
            assert {k: int(v) for k, v in b["coords"].attrs.items()} == {
                "patch_size": patch_size, "patch_level": level}


class ShrunkJaxExtractor(jax_resnet.PatchFeatureExtractor):
    """JAX's extractor at batch 4 (its default of 64 costs minutes on a CPU)."""

    def __init__(self, weights_path=None, batch_size=4, seed=0):
        super().__init__(weights_path=weights_path, batch_size=4, seed=seed)


def test_preprocess_features_equal_at_224(fake_slides, extractors, tmp_path, capsys,
                                          monkeypatch):
    monkeypatch.setattr(jax_resnet, "PatchFeatureExtractor", ShrunkJaxExtractor)
    start = patched_tree(tmp_path, patch_size=224)
    ckpt = extractors[2]
    jax_tree, jax_lines, port_tree, port_lines = run_both(
        tmp_path, capsys, start,
        lambda m, cfg: m.preprocess("brca", str(cfg), level=1, step="features", patch_size=224,
                                    weights=str(ckpt),
                                    **({"device": "cpu"} if m is tasks else {})))
    assert port_lines == jax_lines
    assert port_lines[-1] == f"features: {len(SLIDES)} extracted, 0 already present, 0 without a patches h5"
    total = 0
    for sid in SLIDES:
        want = np.load(prep_dir(jax_tree, 1) / "patch_features" / f"{sid}.npy")
        got = np.load(prep_dir(port_tree, 1) / "patch_features" / f"{sid}.npy")
        assert got.shape == want.shape and got.dtype == np.float32 and len(got) > 0
        assert rel_err(got, want) < RESNET_TOL
        total += len(got)
    assert 4 <= total <= 16  # a handful of patches


class RecordingExtractor:
    """Stands in for both packages' extractors: keeps the patches it is
    given and returns their channel means, padded to 2048."""

    calls = []

    def __init__(self, weights_path=None, batch_size=64, seed=0, device=None):
        self.pretrained = weights_path is not None

    def __call__(self, patches):
        RecordingExtractor.calls.append(np.array(patches))
        feats = np.zeros((len(patches), 2048), np.float32)
        feats[:, :3] = np.asarray(patches, np.float32).mean(axis=(1, 2))
        return feats


@pytest.fixture
def recording(monkeypatch):
    RecordingExtractor.calls = []
    monkeypatch.setattr(jax_resnet, "PatchFeatureExtractor", RecordingExtractor)
    monkeypatch.setattr(tasks, "PatchFeatureExtractor", RecordingExtractor)
    return RecordingExtractor.calls


def test_preprocess_resized_patches_within_one_of_cv2(fake_slides, recording, tmp_path, capsys):
    start = patched_tree(tmp_path, patch_size=256)
    run_both(tmp_path, capsys, start,
             lambda m, cfg: m.preprocess("brca", str(cfg), level=1, step="features"))
    assert len(recording) == 2 * len(SLIDES)
    for want, got in zip(recording[:len(SLIDES)], recording[len(SLIDES):]):
        assert got.shape == want.shape and got.shape[1:] == (224, 224, 3) and len(got)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def rewrite_h5(path: Path, attrs: dict) -> None:
    """Write the coords of ``path`` again with h5py, with ``attrs`` only."""
    with h5py.File(path) as f:
        coords = f["coords"][:]
    path.unlink()
    with h5py.File(path, "w") as f:
        dset = f.create_dataset("coords", data=coords)
        for k, v in attrs.items():
            dset.attrs[k] = v


@pytest.mark.parametrize("case", ["max_patches", "resume", "missing_h5", "attrs", "pt"])
def test_preprocess_features_lines_and_outputs(fake_slides, recording, tmp_path, capsys, case):
    start = patched_tree(tmp_path, patch_size=256)
    patches = prep_dir(start, 1) / "patches"
    kw = dict(level=1, step="features", patch_size=256)
    if case == "max_patches":
        kw["max_patches"] = 3
    elif case == "resume":
        np.save(prep_dir(start, 1) / "patch_features" / f"{SLIDES[0]}.npy", np.zeros((1, 2048)))
    elif case == "missing_h5":
        for h5 in patches.glob("*.h5"):
            h5.unlink()
    elif case == "attrs":
        # the first slide's h5 says 224 at level 2 (the CLI 256 at level 1);
        # the second has no attributes, so the CLI's geometry holds for it
        rewrite_h5(patches / f"{SLIDES[0]}.h5", {"patch_size": 224, "patch_level": 2})
        rewrite_h5(patches / f"{SLIDES[1]}.h5", {})
    else:
        kw["save_format"] = "pt"
    jax_tree, jax_lines, port_tree, port_lines = run_both(
        tmp_path, capsys, start, lambda m, cfg: m.preprocess("brca", str(cfg), **kw))
    assert port_lines == jax_lines
    n = len(SLIDES)
    assert port_lines[-1 if case != "missing_h5" else -2] == (
        f"features: {0 if case == 'missing_h5' else n - (case == 'resume')} extracted, "
        f"{int(case == 'resume')} already present, {n if case == 'missing_h5' else 0} without a "
        "patches h5")
    if case == "attrs":
        assert f"{SLIDES[0]}: using patch_size 224 from the patches h5 (CLI said 256)" in port_lines
        assert f"{SLIDES[0]}: using level 2 from the patches h5 (CLI said 1)" in port_lines
    suffix = "pt" if case == "pt" else "npy"
    outs = sorted((prep_dir(jax_tree, 1) / "patch_features").glob(f"*.{suffix}"))
    assert [p.name for p in outs] == sorted(
        p.name for p in (prep_dir(port_tree, 1) / "patch_features").glob(f"*.{suffix}"))
    for path in outs:
        if case == "pt":
            want = torch.load(path, weights_only=True)
            got = torch.load(prep_dir(port_tree, 1) / "patch_features" / path.name,
                             weights_only=True)
            assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
            got, want = got.numpy(), want.numpy()
        else:
            want, got = np.load(path), np.load(prep_dir(port_tree, 1) / "patch_features" / path.name)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=1.0)  # channel means of patches within 1
        if case == "max_patches":
            assert len(got) == 3


def test_preprocess_rejects_an_unknown_step(fake_slides, tmp_path):
    config = make_tree(tmp_path)
    with pytest.raises(ValueError, match="step must be"):
        tasks.preprocess("brca", str(config), step="segment")


# ----------------------------------------------------------------- manifests


@pytest.mark.parametrize("path", MANIFESTS, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_manifest_read_and_filter_equal_pandas(path):
    df, table = jax_manifests.read_manifest(path), manifests.read_manifest(path)
    assert table.columns == list(df.columns) and len(table) == len(df)
    assert table["size"].dtype == np.int64
    for name in df.columns:
        assert table[name].tolist() == df[name].tolist(), name
    keep = df["filename"].tolist()[::3] + ["not-a-slide.svs"]
    for kw in (dict(keep_filenames=keep), dict(contains="DX1"), dict(contains=".svs"),
               dict(contains="-01Z-00-DX"), dict(contains="[.]"),
               dict(keep_filenames=keep, contains="DX")):
        want, got = jax_manifests.filter_manifest(df, **kw), manifests.filter_manifest(table, **kw)
        assert got["filename"].tolist() == want["filename"].tolist(), kw
        assert got.index.tolist() == want.index.tolist() == list(range(len(want)))
        assert got["size"].tolist() == want["size"].tolist()


@pytest.mark.parametrize("path", MANIFESTS[::3], ids=lambda p: p.name)
def test_write_manifest_bytes_equal(path, tmp_path):
    df, table = jax_manifests.read_manifest(path), manifests.read_manifest(path)
    jax_manifests.write_manifest(df.iloc[::2], tmp_path / "jax.txt")
    manifests.write_manifest(table.rows(np.arange(0, len(table), 2)), tmp_path / "port.txt")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    manifests.write_manifest(table, tmp_path / "whole.txt")
    assert (tmp_path / "whole.txt").read_bytes() == path.read_bytes()


def mock_run(monkeypatch, module, seen):
    """Replace ``subprocess.run`` in ``module``: record each argv (and the
    manifest file a ``gdc-client`` call names, read while it exists)."""
    def run(argv, check=False):
        entry = {"argv": list(argv)}
        if "-m" in argv:
            entry["manifest"] = Path(argv[argv.index("-m") + 1]).read_bytes()
        if argv[0] == "curl":
            Path(argv[argv.index("--output") + 1]).write_bytes(b"zip")
        seen.append(entry)
        return subprocess.CompletedProcess(argv, 0)
    monkeypatch.setattr(module.subprocess, "run", run)


@pytest.mark.parametrize("samples", [None, 10])
def test_download_equal_with_subprocess_mocked(tmp_path, monkeypatch, samples):
    (tmp_path / "data" / "tcga" / "gdc_manifests").mkdir(parents=True)
    shutil.copytree(REPO / "data" / "tcga" / "gdc_manifests" / "filtered",
                    tmp_path / "data" / "tcga" / "gdc_manifests" / "filtered")
    config = make_tree(tmp_path / "tree", slides=())
    monkeypatch.chdir(tmp_path)
    seen = {}
    for name, module in (("jax", jax_tasks), ("port", tasks)):
        seen[name] = []
        mock_run(monkeypatch, module, seen[name])
        module.download("brca", str(config), samples)
    (want,), (got,) = seen["jax"], seen["port"]
    assert got == want
    assert got["argv"][0] == str(tmp_path / "tree" / "gdc-client")
    assert got["argv"][1:4] == ["download", "-m", got["argv"][3]]
    if samples is None:
        assert got["argv"][3].endswith("brca_wsi_manifest_filtered.txt")
    else:
        sampled = pd.read_csv(io.BytesIO(got["manifest"]), sep="\t")
        full = pd.read_csv(REPO / "data" / "tcga" / "gdc_manifests" / "filtered"
                           / "brca_wsi_manifest_filtered.txt", sep="\t")
        rows = np.random.RandomState(42).choice(len(full), samples, replace=False)
        assert sampled["id"].tolist() == full["id"].iloc[rows].tolist()
        assert not (tmp_path / got["argv"][3]).exists()  # the temporary manifest is gone
    assert (tmp_path / "tree" / "wsi" / "brca").is_dir()


def test_install_equal_with_subprocess_mocked(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    seen = {}
    for name, module in (("jax", jax_tasks), ("port", tasks)):
        seen[name] = []
        mock_run(monkeypatch, module, seen[name])
        capsys.readouterr()
        module.install("mac")
        seen[name].append(capsys.readouterr().out)
        assert not (tmp_path / "gdc-client.zip").exists()
    assert seen["port"] == seen["jax"]
    assert [e["argv"][0] for e in seen["port"][:2]] == ["curl", "unzip"]
    assert tasks.GDC_URLS == jax_tasks.GDC_URLS


def test_flatten_equal(tmp_path, capsys):
    start = tmp_path / "start"
    make_tree(start, slides=())
    wsi = start / "wsi" / "brca"
    for i, folder in enumerate(["a", "b", "c", "c", "d"]):
        (wsi / folder).mkdir(parents=True, exist_ok=True)
        (wsi / folder / f"slide{i % 4}.svs").write_text(str(i))
    (wsi / "d" / "annotations.txt").write_text("kept")
    (wsi / "slide9.svs").write_text("top")
    trees = {}
    for name, module in (("jax", jax_tasks), ("port", tasks)):
        tree = tmp_path / "tree"
        shutil.copytree(start, tree)
        capsys.readouterr()
        module.flatten("brca", str(write_config(tree)))
        lines = capsys.readouterr().out.replace(str(tree), "<tree>")
        files = sorted((str(p.relative_to(tree)), p.read_text() if p.is_file() else None)
                       for p in tree.rglob("*"))
        trees[name] = (lines, files)
        shutil.rmtree(tree)
    assert trees["port"] == trees["jax"]
    assert "Flattened 4 slides" in trees["port"][0]


def test_cli_parser_adds_only_device(monkeypatch):
    """The port's parser takes the JAX CLI's arguments and ``--device`` on
    ``preprocess``."""
    seen = []
    monkeypatch.setattr(tasks, "preprocess", lambda *a: seen.append(a))
    tasks.main(["preprocess", "--dataset", "brca", "--step", "features", "--device", "cpu",
                "--max_patches", "5"])
    assert seen == [("brca", "config/main.yml", 2, "features", 256, 5, None, "npy", "cpu")]
    with pytest.raises(SystemExit):
        tasks.main(["preprocess", "--dataset", "brca", "--device", "tpu"])
    with pytest.raises(SystemExit):
        tasks.main(["flatten", "--dataset", "brca", "--device", "cpu"])


# ---------------------------------------------------------------- profiling


def test_log_compile_time_lines(monkeypatch, capsys):
    clock = iter([0.0, 1.23456, 2.0, 2.00789, 3.0, 3.5])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    outs = []
    for module in (jax_profiling, profiling):
        calls = []
        fn = module.log_compile_time(lambda x: calls.append(x) or x * 2, name="embed")
        capsys.readouterr()
        results = [fn(1), fn(2), fn(3)]
        outs.append((results, calls, capsys.readouterr().out))
        clock = iter([0.0, 1.23456, 2.0, 2.00789, 3.0, 3.5])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    assert outs[1] == outs[0]
    assert outs[1][2] == ("[embed] first call (incl. compile): 1.23s\n"
                          "[embed] steady-state dispatch: 7.89ms\n")


# ---------------------------------------------- the CLI in a fresh process


BLOCKED = ("pandas", "yaml", "h5py", "cv2", "torchvision", "jax", "flax", "optax",
           "healnet_tpu")


def test_cli_runs_without_pandas_yaml_h5py_cv2_or_torchvision(tmp_path):
    """``python -m healnet_tpu_torch.cli.tasks preprocess`` (patch, then
    features on the CPU) in fresh processes with pandas, PyYAML, h5py, cv2,
    torchvision and the JAX stack blocked, the slide library replaced by
    :class:`BlobSlideLib` through a ``-c`` wrapper."""
    config = make_tree(tmp_path, slides=SLIDES[:1])
    code = ("import runpy, sys\n"
            f"for name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            "import ctypes\nimport numpy as np\n"
            + inspect.getsource(BlobSlideLib)
            + "from healnet_tpu_torch.etl import slides\n"
            f"lib = BlobSlideLib({TREE_LEVELS!r})\n"
            "slides._configure(lib)\n"
            "slides._LIB = lib\n"
            "runpy.run_module('healnet_tpu_torch.cli.tasks', run_name='__main__', "
            "alter_sys=True)\n")
    env = {**os.environ, "PYTHONPATH": f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
    said = []
    for step in (["--step", "patch"], ["--step", "features", "--device", "cpu"]):
        proc = subprocess.run(
            [sys.executable, "-c", code, "preprocess", "--dataset", "brca", "--config",
             str(config), "--level", "1", "--max_patches", "4", *step],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        said.append(proc.stdout)
    n = int(said[0].split(f"{SLIDES[0]}: ")[1].split()[0])
    assert n > 0
    feats = np.load(prep_dir(tmp_path, 1) / "patch_features" / f"{SLIDES[0]}.npy")
    assert feats.shape == (4, 2048) and np.isfinite(feats).all()
    assert "features: 1 extracted, 0 already present, 0 without a patches h5" in said[1]
    with h5py.File(prep_dir(tmp_path, 1) / "patches" / f"{SLIDES[0]}.h5") as f:
        assert f["coords"].shape == (n, 2)
