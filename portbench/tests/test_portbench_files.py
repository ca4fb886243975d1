"""The benchmark's files: every configuration, cell, driver and metric of
BENCHMARK.json has its own file, found by name; names, units and keys keep
the contract's rules; a cell and a metric added as new files are picked up
with no file that is there edited."""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import uuid

import pytest

from portbench import run
from portbench.harness import REPO, ROOT, load_json

BENCH = load_json(REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"])
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    assert (REPO / config["file"]).is_file()
    assert config["reduced"] == []


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_file_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    data = load_json(ROOT / "workloads" / f"{cell['name']}.json")
    for key in ("config", "traffic", "chips", "why"):
        assert data[key] == cell[key], key
    assert (ROOT / "drivers" / f"{data['driver']}.py").is_file()
    assert len(cell["why"]) <= 200 and "\n" not in cell["why"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(run.load_reader(metric["name"]))
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_moves_is_reported_in_each_of_its_cells(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    for cell in CELLS:
        if _reports(metric, cell):
            assert _reports(moved, cell), (metric["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e = [m["name"] for m in run.metrics_for(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.metrics_for(BENCH, cell, True)


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]
            }["setup_s"] == 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_names_are_unique_and_size_is_small():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name,cls", [
    ("vqgan-f8-k128-256px",
     "vqgan_tpu_torch.configs.vqgan_config.VQGANConfig"),
    ("ldm-cfg-unet-d96", "vqgan_tpu_torch.configs.ldm_config.LDMConfig"),
])
def test_config_holds_the_published_defaults(name, cls):
    """`reduced` is empty: every field the file gives is the configuration
    class's default, which is the reference repository's setting."""
    import importlib

    module, attr = cls.rsplit(".", 1)
    defaults = dataclasses.asdict(getattr(importlib.import_module(module),
                                          attr)())
    data = load_json(ROOT / "configs" / f"{name}.json")
    shared = [k for k in data if k in defaults]
    assert len(shared) >= 25
    for key in shared:
        want = defaults[key]
        want = list(want) if isinstance(want, tuple) else want
        assert data[key] == want, key


def test_new_cell_and_metric_are_picked_up_as_files(tmp_path):
    """A later PR adds a cell and a metric as new files and BENCHMARK.json
    entries; the harness finds both by name, no file that is there
    edited."""
    tag = f"tmp_{uuid.uuid4().hex[:8]}"
    before = {p: p.read_bytes() for p in ROOT.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    metric = ROOT / "metrics" / f"{tag}_ms.py"
    cell = ROOT / "workloads" / f"{tag}.json"
    try:
        metric.write_text("def read(record):\n"
                          "    return record.host.get('extra')\n")
        data = load_json(ROOT / "workloads" / "ldm_train_scan.json")
        cell.write_text(json.dumps({**data, "traffic": f"{tag}_mix"}))
        bench = json.loads(json.dumps(BENCH))
        bench["workloads"].append({"name": tag, "config": data["config"],
                                   "traffic": f"{tag}_mix", "chips": 1,
                                   "why": "test"})
        bench["per_layer"].append({
            "name": f"{tag}_ms", "unit": "ms", "better": "lower",
            "source": "host_clock", "layer": "data",
            "moves": "train_samples_per_s", "workloads": [tag]})
        bench["end_to_end"][0]["workloads"].append(tag)
        names = [m["name"] for m in run.metrics_for(bench, tag, True)]
        assert f"{tag}_ms" in names
        assert "mfu.train" not in names  # the metric lists its cells

        class Args:
            workload, seed, seconds, trace = tag, 1, 1.0, 0

        ctx = run.context(Args, 0.0)
        shutil.rmtree(ctx.scratch)
        assert ctx.cell["traffic"] == f"{tag}_mix"

        class Rec:
            host = {"extra": 2.5}

        got = run.read_metrics([m for m in bench["per_layer"]
                                if m["name"] == f"{tag}_ms"], Rec)
        assert got == {f"{tag}_ms": {"value": 2.5, "unit": "ms"}}
        assert not run.read_metrics([{"name": f"{tag}_ms", "unit": "ms"}],
                                    type("R", (), {"host": {}}))
    finally:
        metric.unlink(missing_ok=True)
        cell.unlink(missing_ok=True)
    after = {p: p.read_bytes() for p in ROOT.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before
