"""BENCHMARK.json against the benchmark's contract, and every file a cell
is found by."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == KEYS
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in MANIFEST["command"])
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    for path in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", path) and (ROOT / path).is_dir()


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [entry["name"] for entry in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {c["name"] for c in MANIFEST["workloads"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= cells and m["layer"].strip()
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_find_their_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    for cell in MANIFEST["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
        config = configs[cell["config"]]
        used.add(cell["config"])
        assert (ROOT / config["file"]).is_file() and config["file"].startswith("portbench/")
        mix = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
        assert set(mix["trainer"]) == {"fused_epochs", "arena", "prefetch"}
        cfg = json.loads((ROOT / config["file"]).read_text())
        assert (ROOT / "portbench" / "models" / f"{cfg['model']}.py").is_file()
        assert (ROOT / cfg["reference"]).is_file() and cfg["reference"].startswith("portbench/")
        limits = json.loads((ROOT / "portbench" / "limits" / f"{cell['name']}.json").read_text())
        assert set(limits) >= {"loss", "loss_first", "change"}
    assert used == set(configs)
    for config in configs.values():
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert config["source"].startswith("https://") and len(config["reduced"]) <= 16


def test_configs_keep_the_published_block():
    """The tuned blocks of the release's best_hyperparams.yml, nothing cut."""
    brca = json.loads((ROOT / "portbench" / "configs" / "brca.json").read_text())
    kirp = json.loads((ROOT / "portbench" / "configs" / "kirp.json").read_text())
    assert (brca["depth"], brca["num_latents"], brca["latent_dim"], brca["cross_dim_head"],
            brca["latent_dim_head"]) == (2, 17, 126, 63, 20)
    assert (kirp["depth"], kirp["num_latents"], kirp["latent_dim"], kirp["cross_dim_head"],
            kirp["latent_dim_head"]) == (5, 17, 62, 27, 113)
    assert brca["attn_dropout"] == 0.45526926537716805 and brca["ff_dropout"] == 0.364741344399059
    assert kirp["attn_dropout"] == 0.31789955176609086 and kirp["ff_dropout"] == 0.04735283995174411
    for cfg in (brca, kirp):
        assert cfg["precision"] == "bf16" and set(cfg["assumed"]) >= {"omic_dim", "cohort"}
