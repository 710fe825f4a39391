"""The port's deployment artifact (``healnet_tpu_torch.serving_export``)
against the JAX package's (``healnet_tpu.serving_export``) on the CPU.

Counterparts of ``tests/test_serving_export.py`` on its fixture dims: both
packages export a predictor of the same Flax weights (the port converts
them through ``compat/flax_params.state_dict_from_flax``) and serve the
same numpy requests from their artifacts. Tolerances: the port's exported
program runs the live module's ops, so on the CPU it equals the live
``Predictor`` bit for bit; the port against JAX agrees to 1e-5 relative /
1e-6 absolute in f32, and to 2 bf16 ulps of the largest logit in bf16
(the two packages round the bf16 compute at different points).

Also here: the registered ops behind the kernels
(``healnet_port::fused_kv_project``, ``healnet_port::flash_attention_fwd``)
under ``torch.library.opcheck``, their fake implementations' output
metadata against the CPU implementations', the device rules of
``ExportedPredictor`` and a serving process that imports nothing but
``healnet_tpu_torch.serving_export``.
"""

import json
import os
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from healnet_tpu.models import HealNetModule as JaxHealNet
from healnet_tpu.serving import Predictor as JaxPredictor
from healnet_tpu.serving_export import ExportedPredictor as JaxExported
from healnet_tpu.serving_export import _unflatten_params
from healnet_tpu_torch.compat.flax_params import state_dict_from_flax
from healnet_tpu_torch.models.healnet import HealNetModule
from healnet_tpu_torch.ops import cuda_build
from healnet_tpu_torch.ops.flash_attention import FlashAttentionFunction, flash_fwd_op
from healnet_tpu_torch.ops.fused_project import FusedProjectFunction, project_op
from healnet_tpu_torch.ops.quantize import quantize_context
from healnet_tpu_torch.serving import Predictor
from healnet_tpu_torch.serving_export import ExportedPredictor, version_problems

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
KEYS = ("logits", "hazards", "survival", "risk")
CFG = dict(
    n_modalities=2, channel_dims=(12, 6), num_spatial_axes=(1, 1),
    out_dims=4, depth=1, l_c=4, l_d=8, x_heads=1, l_heads=1,
    cross_dim_head=4, latent_dim_head=4, self_per_cross_attn=0,
)
SHAPES = [(1, 12), (5, 6)]
BOUNDARIES = [8, 16]


def _jax_params(dtype=None):
    module = JaxHealNet(**CFG)
    tensors = (np.zeros((2, 1, 12), np.float32), np.zeros((2, 5, 6), np.float32))
    params = module.init(jax.random.PRNGKey(0), tensors)["params"]
    if dtype is not None:
        params = jax.tree_util.tree_map(lambda p: p.astype(dtype), params)
    return module, params


def _numpy_tree(params):
    """The Flax tree as f32 numpy arrays (bf16 values are exact in f32)."""
    return jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32), params)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """Both packages' predictors of one set of Flax weights (batch 4,
    buckets 8 and 16) and their artifacts with both widths; the port's
    dense-only artifact."""
    root = tmp_path_factory.mktemp("export")
    jmod, params = _jax_params()
    jlive = JaxPredictor(jmod, params, batch_size=4, bucket_boundaries=BOUNDARIES)
    live = Predictor(HealNetModule(**CFG, device="cpu"), _numpy_tree(params), batch_size=4,
                     bucket_boundaries=BOUNDARIES, device="cpu")
    jlive.export(root / "jax", example_shapes=SHAPES, widths=BOUNDARIES)
    live.export(root / "port", example_shapes=SHAPES, widths=BOUNDARIES)
    live.export(root / "dense", example_shapes=SHAPES)
    return dict(root=root, jlive=jlive, live=live, jax=JaxExported(root / "jax"),
                port=ExportedPredictor(root / "port", device="cpu"))


def _same(got, live, ref_jax, keys=KEYS):
    for k in keys:
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(ref_jax[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _port_ops(program) -> list:
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and "healnet_port" in str(n.target)]


# ------------------------------------- counterparts of test_serving_export


def test_export_roundtrip_dense(arts, rng):
    n = 7  # exercises padding + splitting
    omic = rng.normal(size=(n, 1, 12)).astype(np.float32)
    wsi = rng.normal(size=(n, 5, 6)).astype(np.float32)
    got = arts["port"]([omic, wsi])
    _same(got, arts["live"]([omic, wsi]), arts["jax"]([omic, wsi]))

    # the manifest records enough to validate a deployment host
    manifest = json.loads((arts["root"] / "port" / "manifest.json").read_text())
    assert manifest["batch_size"] == 4 and manifest["out_dims"] == 4
    assert manifest["torch_version"] == torch.__version__
    assert manifest["cuda_version"] == torch.version.cuda
    assert manifest["kernel_hash"] == cuda_build.build_dir().name
    assert manifest["platforms"] == ["cpu"] and manifest["program_dirs"] == {"cpu": "."}
    jax_manifest = json.loads((arts["root"] / "jax" / "manifest.json").read_text())
    for key in ("format_version", "batch_size", "n_mod", "compute_dtype", "mod_tails",
                "uses_masks", "widths", "out_dims"):
        assert manifest[key] == jax_manifest[key], key


def test_export_missing_modality_and_masks(arts, rng):
    served, live, jserved = arts["port"], arts["live"], arts["jax"]
    omic = rng.normal(size=(5, 1, 12)).astype(np.float32)
    wsi = rng.normal(size=(5, 5, 6)).astype(np.float32)

    # missing modality (None) -> zero-fill + presence column, as the live path
    _same(served([omic, None]), live([omic, None]), jserved([omic, None]), ("logits",))

    # explicit KV masks change outputs and match the live masked program
    mask = np.ones((5, 5), bool)
    mask[:, 3:] = False
    got = served([omic, wsi], kv_masks=[None, mask])
    _same(got, live([omic, wsi], kv_masks=[None, mask]),
          jserved([omic, wsi], kv_masks=[None, mask]), ("logits",))
    assert not np.allclose(got["logits"], served([omic, wsi])["logits"])

    # empty request: well-shaped zero outputs
    empty = served([np.zeros((0, 1, 12), np.float32), None])
    assert empty["logits"].shape == (0, 4) and empty["risk"].shape == (0,)


def test_export_ragged_widths(arts, rng):
    n = 6
    omic = rng.normal(size=(n, 1, 12)).astype(np.float32)
    bags = [rng.normal(size=(ln, 6)).astype(np.float32) for ln in (3, 8, 11, 16, 2, 13)]
    bags[4] = None  # a missing bag rides the same path
    got = arts["port"].predict_ragged([omic, bags])
    _same(got, arts["live"].predict_ragged([omic, bags]),
          arts["jax"].predict_ragged([omic, bags]), ("logits", "risk"))

    # widths are mandatory for ragged serving
    with pytest.raises(ValueError, match="widths"):
        ExportedPredictor(arts["root"] / "dense", device="cpu").predict_ragged([omic, bags])


def test_export_bf16_params_roundtrip(tmp_path, rng):
    """bf16 weights in params.npz as f32 and back: bit-identical. The
    port's bf16 model computes in bf16 (``dtype``) and holds bf16
    parameters here; JAX's takes bf16 parameters and inputs."""
    jmod, params = _jax_params(jnp.bfloat16)
    jlive = JaxPredictor(jmod, params, batch_size=4, compute_dtype=jnp.bfloat16)
    module = HealNetModule(**CFG, dtype=torch.bfloat16, device="cpu").to(torch.bfloat16)
    live = Predictor(module, _numpy_tree(params), batch_size=4,
                     compute_dtype=torch.bfloat16, device="cpu")
    jlive.export(tmp_path / "jax", example_shapes=SHAPES)
    live.export(tmp_path / "port", example_shapes=SHAPES)
    served = ExportedPredictor(tmp_path / "port", device="cpu")
    state = live.module.state_dict()
    assert set(served.params) == set(state)
    for k, v in served.params.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, state[k]), k
    omic = rng.normal(size=(4, 1, 12)).astype(np.float32)
    wsi = rng.normal(size=(4, 5, 6)).astype(np.float32)
    got = served([omic, wsi])["logits"]
    np.testing.assert_array_equal(got, live([omic, wsi])["logits"])
    ref = np.asarray(JaxExported(tmp_path / "jax")([omic, wsi])["logits"])
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 * ulp)


class JaxBagPool(nn.Module):
    """The bag-baseline convention (MCAT/MultiModN): no kv_masks."""

    out_dims: int = 4

    @nn.compact
    def __call__(self, tensors, presence=None, deterministic=True):
        omic = tensors[0].reshape((tensors[0].shape[0], -1))
        bag = jnp.mean(tensors[1], axis=1)  # pools zero-padded tokens
        return nn.Dense(self.out_dims)(jnp.concatenate([omic, bag], -1))


class BagPool(torch.nn.Module):
    """:class:`JaxBagPool` in torch; its Dense under the Flax scope name,
    so ``state_dict_from_flax`` maps the weights."""

    def __init__(self, in_features=18, out_dims=4):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(in_features, out_dims)
        self.out_dims = out_dims

    def forward(self, tensors, presence=None):
        omic = tensors[0].reshape(tensors[0].shape[0], -1)
        return self.Dense_0(torch.cat([omic, torch.mean(tensors[1], dim=1)], dim=-1))


def test_export_ragged_mask_free_bag_module(tmp_path, rng):
    """A mask-free module's programs are traced without masks, and
    predict_ragged drops the mask list as the live Predictor does (padded
    rows are pooled, as live)."""
    dim = 6
    jmod = JaxBagPool()
    params = jmod.init(
        jax.random.PRNGKey(0),
        (np.zeros((2, 1, 12), np.float32), np.zeros((2, 8, dim), np.float32)),
    )["params"]
    jlive = JaxPredictor(jmod, params, batch_size=4, bucket_boundaries=BOUNDARIES,
                         mod_shapes={0: (1, 12)})
    live = Predictor(BagPool(), _numpy_tree(params), batch_size=4,
                     bucket_boundaries=BOUNDARIES, device="cpu")
    jlive.export(tmp_path / "jax", example_shapes=[(1, 12), (8, dim)], widths=BOUNDARIES)
    live.export(tmp_path / "port", example_shapes=[(1, 12), (8, dim)], widths=BOUNDARIES)
    served = ExportedPredictor(tmp_path / "port", device="cpu")
    jserved = JaxExported(tmp_path / "jax")
    assert served.manifest["uses_masks"] is False

    n = 5
    omic = rng.normal(size=(n, 1, 12)).astype(np.float32)
    bags = [rng.normal(size=(ln, dim)).astype(np.float32) for ln in (3, 8, 5, 12, 2)]
    _same(served.predict_ragged([omic, bags]), live.predict_ragged([omic, bags]),
          jserved.predict_ragged([omic, bags]), ("logits", "risk"))

    # the dense program serves mask-free modules too
    wsi = rng.normal(size=(n, 8, dim)).astype(np.float32)
    _same(served([omic, wsi]), live([omic, wsi]), jserved([omic, wsi]), ("logits",))


def test_export_version_pins_enforced(arts, tmp_path):
    """The manifest's pins are enforced at load: warn by default, raise
    under strict_versions. A device the artifact has no programs for
    raises in any case (JAX warns: its programs name their platforms, and
    the port never falls back to another device)."""
    art = shutil.copytree(arts["root"] / "dense", tmp_path / "art")
    manifest_path = art / "manifest.json"
    manifest = json.loads(manifest_path.read_text())

    with warnings.catch_warnings():  # matching host: a clean load
        warnings.simplefilter("error")
        ExportedPredictor(art, device="cpu")

    manifest["torch_version"] = "0.0.1"
    manifest_path.write_text(json.dumps(manifest))
    with pytest.warns(RuntimeWarning, match="0.0.1"):
        ExportedPredictor(art, device="cpu")
    with pytest.raises(ValueError, match="0.0.1"):
        ExportedPredictor(art, strict_versions=True, device="cpu")

    manifest["torch_version"] = torch.__version__
    manifest["platforms"] = ["nonexistent_backend"]
    manifest["program_dirs"] = {"nonexistent_backend": "."}
    manifest_path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="nonexistent_backend"):
        ExportedPredictor(art, device="cpu")


def test_export_rejects_params_npz_cannot_hold(arts, tmp_path):
    """Counterpart of JAX's refusal of pytrees that do not survive the
    artifact's '::' flatten / unflatten round-trip. A state_dict is already
    flat, so that case cannot arise here; what can is a weight of a dtype
    params.npz cannot hold (numpy's dtypes, and bf16 through f32): it
    fails LOUDLY at export, before anything is traced or written, not at
    serve time."""
    module = HealNetModule(**CFG, device="cpu")
    module.register_buffer("scales8", torch.zeros(4, dtype=torch.float8_e4m3fn))
    live = Predictor(module, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="round-trip"):
        live.export(tmp_path / "bad", example_shapes=SHAPES)
    assert not (tmp_path / "bad").exists()


def test_exported_artifact_needs_no_model_code(arts, rng):
    """The artifact serves through a module-free loader: only files on disk."""
    art = arts["root"] / "dense"
    assert {p.name for p in art.iterdir()} == {"manifest.json", "params.npz", "predict.pt2"}
    # the program keeps no example inputs: they would store the weights and
    # a whole batch again in every program
    assert torch.export.load(art / "predict.pt2").example_inputs is None
    served = ExportedPredictor(art, device="cpu")
    assert not hasattr(served, "module")
    out = served([rng.normal(size=(2, 1, 12)).astype(np.float32),
                  rng.normal(size=(2, 5, 6)).astype(np.float32)])
    assert out["logits"].shape == (2, 4)


def test_exported_warmup_compiles_every_program(arts, rng):
    """warmup loads and runs the dense program and every bucket-width
    program; live traffic afterwards loads nothing."""
    served = ExportedPredictor(arts["root"] / "port", device="cpu")
    stats = served.warmup()
    assert stats["programs"] == 3 and stats["seconds"] >= 0.0  # dense + w8 + w16
    assert set(served._fns) == {"predict", "predict_w8", "predict_w16"}
    loaded = dict(served._fns)
    omic = rng.normal(size=(3, 1, 12)).astype(np.float32)
    bags = [rng.normal(size=(ln, 6)).astype(np.float32) for ln in (3, 9, 16)]
    assert served.predict_ragged([omic, bags])["risk"].shape == (3,)
    assert served._fns == loaded  # nothing new loaded by live traffic


# ------------------------------------------------ the port's own artifact


def test_params_npz_equals_jax_artifacts(arts):
    """The port's params.npz is ``state_dict_from_flax`` of the JAX
    artifact's, array for array and dtype for dtype."""
    with np.load(arts["root"] / "jax" / "params.npz") as z:
        want = state_dict_from_flax(_unflatten_params({k: z[k] for k in z.files}))
    with np.load(arts["root"] / "port" / "params.npz") as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.numpy().dtype, k
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


SERVE_SCRIPT = """
import sys
import numpy as np
from healnet_tpu_torch.serving_export import ExportedPredictor
served = ExportedPredictor(sys.argv[1], device="cpu")
with np.load(sys.argv[2]) as z:
    omic = z["omic"]
    bags = [z[f"bag{i}"] for i in range(len(z.files) - 1)]
np.savez(sys.argv[3], **served.predict_ragged([omic, bags]))
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "healnet_tpu")))
"""


def test_fresh_process_serves_artifact(arts, tmp_path, rng):
    """A process that imports only ``healnet_tpu_torch.serving_export``
    (which registers the ops the programs call) serves the artifact with
    the in-process outputs, bit for bit, and imports nothing of JAX."""
    omic = rng.normal(size=(5, 1, 12)).astype(np.float32)
    bags = [rng.normal(size=(ln, 6)).astype(np.float32) for ln in (3, 8, 11, 16, 2)]
    np.savez(tmp_path / "req.npz", omic=omic, **{f"bag{i}": b for i, b in enumerate(bags)})
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_SCRIPT, str(arts["root"] / "port"),
         str(tmp_path / "req.npz"), str(tmp_path / "out.npz")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    want = arts["port"].predict_ragged([omic, bags])
    with np.load(tmp_path / "out.npz") as got:
        for k in KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_device_rules(arts):
    """No fallback: without a GPU the default device raises, and a CPU
    artifact serves only where ``device="cpu"`` is asked for; a predictor
    on the CPU exports CPU programs only."""
    assert arts["port"].manifest["platforms"] == ["cpu"]
    assert arts["port"].device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExportedPredictor(arts["root"] / "port")


def test_artifact_without_the_devices_programs_raises(arts, tmp_path):
    art = shutil.copytree(arts["root"] / "dense", tmp_path / "art")
    manifest = json.loads((art / "manifest.json").read_text())
    manifest.update(platforms=["cuda"], program_dirs={"cuda": "."})
    (art / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="none for 'cpu'"):
        ExportedPredictor(art, device="cpu")


def test_version_problems_on_the_card(arts):
    """Serving on the card also pins the CUDA version and the kernel
    build's hash; the CPU programs run no kernel and pin the torch version
    only."""
    manifest = dict(arts["port"].manifest)
    cuda = torch.device("cuda")
    manifest.update(cuda_version=torch.version.cuda, kernel_hash=cuda_build.build_dir().name)
    assert version_problems(manifest, cuda) == []
    manifest.update(cuda_version="0.1", kernel_hash="kernels-0")
    problems = version_problems(manifest, cuda)
    assert len(problems) == 2 and "0.1" in problems[0] and "kernels-0" in problems[1]
    assert version_problems(manifest, torch.device("cpu")) == []


@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
def test_cpu_programs_hold_no_port_op(tmp_path, attention_impl):
    """On the CPU the model's wrappers take the plain path (as JAX's
    ``auto`` never lowers Pallas on the CPU): its programs hold no op of
    the ``healnet_port`` namespace."""
    module = HealNetModule(**CFG, attention_impl=attention_impl, device="cpu")
    Predictor(module, batch_size=2, device="cpu").export(tmp_path, example_shapes=SHAPES)
    assert _port_ops(torch.export.load(tmp_path / "predict.pt2")) == []


class OpModule(torch.nn.Module):
    """Calls both autograd Functions, whose forwards are the registered
    ops, on whatever tensors it is given (the CPU ones too)."""

    def forward(self, dat, enc, w_all, b_all, q, mask):
        kv = FusedProjectFunction.apply(dat, enc, w_all, b_all, 1e-5)
        k, v = kv[..., :4][:, None], kv[..., 4:][:, None]  # strided column slices
        return FlashAttentionFunction.apply(q, k, v, mask, 0.5, 0.0, 0)


def test_module_through_the_ops_exports_them(tmp_path, rng):
    """A module whose CPU tensors reach the ops exports with the ops
    themselves in its graph (not the Functions' bodies), and the saved
    program gives the eager outputs bit for bit."""
    args = (torch.from_numpy(rng.normal(size=(2, 9, 5)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(9, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(8,)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(2, 1, 3, 4)).astype(np.float32)),
            torch.from_numpy(rng.uniform(size=(2, 9)) > 0.3))
    exported = torch.export.export(OpModule(), args, strict=False)
    assert _port_ops(exported) == ["healnet_port.fused_kv_project.default",
                                   "healnet_port.flash_attention_fwd.default"]
    torch.export.save(exported, tmp_path / "ops.pt2")
    got = torch.export.load(tmp_path / "ops.pt2").module()(*args)
    assert torch.equal(got, OpModule()(*args))


# ------------------------------------------------------- the registered ops


def _project_args(rng, b, t, c, f, kind, enc_on, contiguous=True):
    """The projection op's inputs: ``kind`` bf16 / f32 (the compute dtype
    too) or int8 (with its scale, computing in f32)."""
    x = torch.from_numpy(rng.normal(size=(b, t, c) if contiguous else (t, b, c)).astype(
        np.float32) * 3)
    if not contiguous:
        x = x.transpose(0, 1)
    enc = torch.from_numpy(rng.normal(size=(t, 5)).astype(np.float32)) if enc_on else None
    d_total = c + (5 if enc_on else 0)
    w_all = torch.from_numpy(rng.normal(size=(d_total, f)).astype(np.float32) * 0.1)
    b_all = torch.from_numpy(rng.normal(size=(f,)).astype(np.float32))
    if kind == "int8":
        qc = quantize_context(x)
        return (qc.data, enc, w_all, b_all, 1e-5, qc.scale, torch.float32)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[kind]
    return (x.to(dtype), None if enc is None else enc.to(dtype), w_all, b_all, 1e-5, None,
            dtype)


def _flash_args(rng, case, dtype=torch.float32, b=2, h=2, lq=5, lkv=11, d=6):
    """The flash op's inputs; K and V are column slices of one merged
    (b, lkv, 2 h d) buffer, as the model passes them."""
    q = torch.from_numpy(rng.normal(size=(b, h, lq, d)).astype(np.float32)).to(dtype)
    kv = torch.from_numpy(rng.normal(size=(b, lkv, 2 * h * d)).astype(np.float32)).to(dtype)
    k, v = (kv[..., i * h * d:(i + 1) * h * d].reshape(b, lkv, h, d).transpose(1, 2)
            for i in (0, 1))
    mask = torch.from_numpy(rng.uniform(size=(b, lkv)) > 0.3) if case != "plain" else None
    if case == "masked_row":
        mask[0] = False
    rate, seed = (0.2, torch.tensor([12345], dtype=torch.int64)) if case == "dropout" \
        else (0.0, None)
    return (q, k, v, mask, d**-0.5 / 0.5, rate, seed)


@pytest.mark.parametrize("enc_on", [True, False], ids=["enc", "no_enc"])
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_project_op_opcheck(rng, kind, enc_on):
    torch.library.opcheck(project_op, _project_args(rng, 2, 7, 13, 9, kind, enc_on))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["plain", "masked_row", "dropout"])
def test_flash_op_opcheck(rng, case, dtype):
    torch.library.opcheck(flash_fwd_op, _flash_args(rng, case, dtype))


def _meta(outs):
    return [(tuple(o.shape), o.dtype, o.stride()) for o in outs]


def _fake_outputs(op, args):
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        return op(*fake)


@pytest.mark.parametrize("b,t,c,f", [(1, 1, 1, 1), (3, 5, 7, 9), (2, 33, 203, 70),
                                     (4, 1, 2001, 252), (2, 17, 64, 130)])
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_project_op_fake_matches_cpu(rng, b, t, c, f, kind):
    """The fake implementation's outputs (what ``torch.export`` traces on
    the card with) have the CPU implementation's shape, dtype and strides,
    for contiguous and permuted contexts, with and without the encoding."""
    for enc_on in (True, False):
        for contiguous in (True, False):
            args = _project_args(rng, b, t, c, f, kind, enc_on, contiguous)
            assert _meta(_fake_outputs(project_op, args)) == _meta(project_op(*args))


@pytest.mark.parametrize("b,h,lq,lkv,d", [(1, 1, 1, 1, 1), (2, 3, 5, 11, 7),
                                          (2, 1, 17, 40, 63), (3, 2, 33, 9, 27)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_op_fake_matches_cpu(rng, b, h, lq, lkv, d, dtype):
    for case in ("plain", "masked_row", "dropout"):
        args = _flash_args(rng, case, dtype, b, h, lq, lkv, d)
        assert _meta(_fake_outputs(flash_fwd_op, args)) == _meta(flash_fwd_op(*args))
