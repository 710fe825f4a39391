"""Deployment artifacts for the serving layer.

Counterpart of ``healnet_tpu/serving_export.py``. :func:`export_predictor`
traces a :class:`healnet_tpu_torch.serving.Predictor`'s predict program
(the module and the survival head) with ``torch.export`` and writes a
self-contained artifact directory: programs, parameters and a manifest.
:class:`ExportedPredictor` then serves that directory WITHOUT the model's
Python class: a deployment host needs torch, numpy and this package's ops,
not the model zoo or the training stack. Artifact layout::

    <path>/manifest.json       shapes, dtypes, bucket widths, out_dims, pins
    <path>/params.npz          the module's state_dict, one array a key
    <path>/predict.pt2         dense program (fixed per-modality shapes)
    <path>/predict_w<W>.pt2    one ragged-bag program per bucket width W
    <path>/<platform>/...      the same programs for each further platform

The programs take the parameters as inputs (``torch.func.functional_call``,
as JAX's take ``params``), so the weights are stored once, in
``params.npz``. A program is traced on one device, which it keeps (the
model builds its presence and positional encodings on the inputs' device):
``platforms`` names the devices an artifact holds programs for, the first
at the top of the directory, each further one in a folder of its name.

On the card the projection and flash forward kernels appear in a program
as the registered ops ``healnet_port::fused_kv_project`` and
``healnet_port::flash_attention_fwd``, which decide their route and launch
plan from the real tensors at each call; importing this module registers
them, as ``torch.export.load`` needs. A CPU program takes the plain path
and holds neither op, as JAX's ``auto`` never lowers Pallas on the CPU. The
manifest pins the torch version, its CUDA version and the kernel build's
hash (``ops/cuda_build.build_dir``): a serving host warns on a mismatch,
or raises under ``strict_versions``.
"""

from __future__ import annotations

import copy
import json
import math
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

# the ops' modules register healnet_port::fused_kv_project and
# healnet_port::flash_attention_fwd, which the saved programs call
from healnet_tpu_torch.ops import cuda_build, flash_attention, fused_project  # noqa: F401
from healnet_tpu_torch.device import DeviceLike, resolve_device
from healnet_tpu_torch.serving import (
    dense_request,
    serve_microbatched,
    serve_ragged,
    zero_outputs,
)
from healnet_tpu_torch.train.losses import hazards_survival_risk

_FORMAT_VERSION = 1
# parameter dtypes params.npz holds: numpy's own, and bf16 stored as f32
# (exact: every bf16 value is an f32 value)
_NPZ_DTYPES = (torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64,
               torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class _PredictProgram(torch.nn.Module):
    """The traced function: ``(params, tensors, presence, kv_masks)`` ->
    logits, hazards, survival and risk, as ``Predictor._predict``."""

    def __init__(self, module: torch.nn.Module, uses_masks: bool):
        super().__init__()
        # not a submodule: the programs take the weights as inputs and so
        # store none of them
        object.__setattr__(self, "served", module)
        self.uses_masks = uses_masks

    def forward(self, params, tensors, presence, kv_masks):
        kwargs = {"presence": presence}
        if self.uses_masks:
            kwargs["kv_masks"] = kv_masks
        logits = torch.func.functional_call(self.served, params, (tensors,), kwargs).float()
        hazards, survival, risk = hazards_survival_risk(logits)
        return {"logits": logits, "hazards": hazards, "survival": survival, "risk": risk}


def export_predictor(
    predictor,
    path,
    example_shapes: Sequence[Sequence[int]],
    widths: Optional[Sequence[int]] = None,
    platforms: Optional[Sequence[str]] = None,
) -> Path:
    """Write ``predictor``'s predict programs and parameters to ``path``.

    Args:
        predictor: a live :class:`healnet_tpu_torch.serving.Predictor`.
        example_shapes: per-sample trailing shape for each modality (no
            batch dim), e.g. ``[(1, 2000), (4096, 2048)]``: fixes the dense
            program's signature.
        widths: optional ragged-bag bucket widths; one extra program is
            exported per width, with the LAST modality reshaped to
            ``(width, d)`` and KV-masked (mirrors ``predict_ragged``).
        platforms: the devices to trace programs for, e.g. ``("cuda",
            "cpu")`` (a further device's programs are traced from a copy of
            the module there); defaults to the predictor's device.

    Must run outside ``torch.inference_mode``. The manifest records each
    program's export seconds (``export_seconds``).
    """
    module = predictor.module
    state = {k: v.detach() for k, v in module.state_dict().items()}
    # fail before tracing, not at serve time, on weights the npz cannot hold
    bad = {k: str(v.dtype) for k, v in state.items() if v.dtype not in _NPZ_DTYPES}
    if bad:
        raise ValueError(f"parameters of dtypes params.npz cannot round-trip: {bad}")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tails = [tuple(int(d) for d in s) for s in example_shapes]
    bs = int(predictor.batch_size)
    dtype = predictor.compute_dtype or torch.float32
    uses_masks = bool(predictor._accepts_kv_masks)
    platforms = [torch.device(p).type for p in (platforms or [predictor.device.type])]
    width_list = sorted(int(w) for w in widths) if widths else []
    names = {"predict": None, **{f"predict_w{w}": w for w in width_list}}

    dirs: Dict[str, str] = {}
    seconds: Dict[str, float] = {}
    out_dims = None
    for platform in platforms:
        device = predictor.device if platform == predictor.device.type else torch.device(platform)
        served = module if device == predictor.device else copy.deepcopy(module).to(device)
        program = _PredictProgram(served, uses_masks)
        params = {k: v.to(device) for k, v in state.items()}
        dirs[platform] = "." if not dirs else platform
        folder = path / dirs[platform]
        folder.mkdir(exist_ok=True)
        for name, width in names.items():
            cur = list(tails)
            if width is not None:
                cur[-1] = (width, cur[-1][-1])
            tensors = tuple(torch.zeros((bs, *t), dtype=dtype, device=device) for t in cur)
            masks = (tuple(torch.ones((bs, math.prod(t[:-1])), dtype=torch.bool, device=device)
                           for t in cur) if uses_masks else None)
            presence = torch.ones((bs, len(tails)), dtype=torch.float32, device=device)
            t0 = time.perf_counter()
            exported = torch.export.export(program, (params, tensors, presence, masks),
                                           strict=False)
            # the saved program would hold its example inputs: the weights
            # and a whole zero batch again
            exported.example_inputs = None
            torch.export.save(exported, folder / f"{name}.pt2")
            seconds[f"{platform}/{name}"] = time.perf_counter() - t0
            if out_dims is None:
                outputs = next(n for n in exported.graph.nodes if n.op == "output").args[0]
                vals = pytree.tree_unflatten([n.meta["val"] for n in outputs],
                                             exported.call_spec.out_spec)
                out_dims = int(vals["logits"].shape[-1])

    np.savez(path / "params.npz", **{
        k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
        for k, v in state.items()})
    manifest = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "kernel_hash": cuda_build.build_dir().name,
        "platforms": platforms,
        "program_dirs": dirs,
        "batch_size": bs,
        "n_mod": len(tails),
        "compute_dtype": _dtype_name(dtype),
        "mod_tails": [list(t) for t in tails],
        "uses_masks": uses_masks,
        "widths": width_list,
        "out_dims": out_dims,
        "param_dtypes": {k: _dtype_name(v.dtype) for k, v in state.items()},
        "export_seconds": seconds,
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return path


def version_problems(manifest: Dict[str, Any], device: torch.device) -> List[str]:
    """The manifest's pins this host does not meet when serving on
    ``device``: the torch version always; on the card also the CUDA
    version and the kernel build's hash (a program calls the kernels this
    checkout builds)."""
    here = {"torch_version": torch.__version__}
    if device.type == "cuda":
        here.update(cuda_version=torch.version.cuda, kernel_hash=cuda_build.build_dir().name)
    return [f"artifact exported under {key} {manifest.get(key)} but this host has {value}"
            for key, value in here.items() if manifest.get(key) != value]


class ExportedPredictor:
    """Serve an :func:`export_predictor` artifact without model code.

    Mirrors the :class:`healnet_tpu_torch.serving.Predictor` call surface:
    ``__call__`` for dense fixed-shape requests (entries may be ``None``
    for missing modalities) and ``predict_ragged`` for ragged patch bags
    when the artifact was exported with ``widths``. ``device``: the GPU
    unless ``"cpu"`` is asked for; an artifact without programs for that
    device raises, and so does a missing GPU (never a quiet CPU run).
    """

    def __init__(self, path, strict_versions: bool = False, device: DeviceLike = None):
        self.path = Path(path)
        self.manifest = json.loads((self.path / "manifest.json").read_text())
        if self.manifest["format_version"] != _FORMAT_VERSION:
            raise ValueError(
                f"artifact format {self.manifest['format_version']} != "
                f"supported {_FORMAT_VERSION}"
            )
        self.device = resolve_device(device)
        dirs = self.manifest["program_dirs"]
        if self.device.type not in dirs:
            raise ValueError(
                f"the artifact holds programs for {self.manifest['platforms']}, none for "
                f"'{self.device.type}': export with platforms=[..., '{self.device.type}']"
            )
        problems = version_problems(self.manifest, self.device)
        if problems and strict_versions:
            raise ValueError("; ".join(problems))
        for p in problems:
            warnings.warn(p, RuntimeWarning, stacklevel=2)
        self._dir = self.path / dirs[self.device.type]
        dtypes = self.manifest["param_dtypes"]
        with np.load(self.path / "params.npz") as z:
            self.params = {
                k: torch.from_numpy(z[k]).to(device=self.device, dtype=getattr(torch, dtypes[k]))
                for k in z.files
            }
        self.batch_size = int(self.manifest["batch_size"])
        self.compute_dtype = getattr(torch, self.manifest["compute_dtype"])
        self._tails = [tuple(t) for t in self.manifest["mod_tails"]]
        self._uses_masks = bool(self.manifest["uses_masks"])
        self._widths = [int(w) for w in self.manifest["widths"]]
        self._fns: Dict[str, Any] = {}  # lazily loaded programs

    def _fn(self, name: str):
        if name not in self._fns:
            program = torch.export.load(self._dir / f"{name}.pt2").module()

            def call(tensors, presence, kv_masks, _p=program):
                if self._uses_masks:
                    # the program takes every mask: None slots become all-True
                    kv_masks = tuple(
                        torch.ones((t.shape[0], math.prod(t.shape[1:-1])), dtype=torch.bool,
                                   device=t.device) if m is None else m
                        for m, t in zip(kv_masks, tensors)
                    )
                with torch.inference_mode():
                    return _p(self.params, tensors, presence, kv_masks)

            self._fns[name] = call
        return self._fns[name]

    def warmup(self) -> Dict[str, float]:
        """Load and run every program once on zeros, so that no live
        request pays a program's load (or, on the card, the kernels'
        build). All shapes come from the manifest.

        Returns ``{"programs": n, "seconds": wall}``.
        """
        t0 = time.perf_counter()
        bs = self.batch_size
        zeros = [np.zeros((bs, *t), np.float32) for t in self._tails]
        self(zeros)  # the dense program
        dim = self._tails[-1][-1]
        for w in self._widths:
            bags = [np.zeros((w, dim), np.float32) for _ in range(bs)]
            self.predict_ragged(list(zeros[:-1]) + [bags])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"programs": 1 + len(self._widths), "seconds": time.perf_counter() - t0}

    def _zeros_out(self, n: int) -> Dict[str, np.ndarray]:
        return zero_outputs(n, int(self.manifest["out_dims"]))

    def _materialize(self, tensors, n, pres) -> List[np.ndarray]:
        full = []
        for i, t in enumerate(tensors):
            if t is None:
                pres[:, i] = 0.0
                full.append(np.zeros((n, *self._tails[i]), np.float32))
            else:
                full.append(np.asarray(t, np.float32))
        return full

    def _serve(self, name, n, full, pres, masks):
        # a mask-free artifact's programs (bag baselines) were traced without
        # masks: the mask list is dropped, as the live Predictor drops it
        return serve_microbatched(
            self._fn(name), n, full, pres, masks, not self._uses_masks, self.batch_size,
            self.compute_dtype, self.device,
        )

    def __call__(
        self,
        tensors: Sequence[Optional[np.ndarray]],
        presence: Optional[np.ndarray] = None,
        kv_masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> Dict[str, np.ndarray]:
        n, full, pres, masks = dense_request(tensors, presence, kv_masks, self._materialize)
        if n == 0:
            return self._zeros_out(0)
        return self._serve("predict", n, full, pres, masks)

    def _bucket_width(self, length: int) -> int:
        for w in self._widths:
            if length <= w:
                return w
        return self._widths[-1]

    def predict_ragged(
        self,
        tensors: Sequence[Any],
        presence: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """Ragged-bag serving from the per-width programs.

        Mirrors ``Predictor.predict_ragged`` (grouping, padding, KV masks,
        request-order reassembly); requires ``widths`` at export time.
        """
        if not self._widths:
            raise ValueError("artifact has no ragged programs: export with widths=[...]")
        bags = list(tensors[-1])
        n = len(bags)
        pres = (
            np.ones((n, len(tensors)), np.float32)
            if presence is None
            else np.asarray(presence, np.float32).copy()
        )
        lead = self._materialize(list(tensors[:-1]), n, pres)
        return serve_ragged(bags, lead, pres, self._tails[-1][-1], self._bucket_width,
                            lambda width, *group: self._serve(f"predict_w{width}", *group))
