"""A run with its timed path broken underneath reads `correct` false:
the harness's look for a chip skipped, the rest of a run driven on the
CPU at small sizes, once for each fault that the cell can have."""

from __future__ import annotations

import json

import pytest

from portbench import run
from portbench.faults import fault
from portbench.harness import REPO, load_json
from portbench.tests.tiny import tiny_cell

BENCH = load_json(REPO / "BENCHMARK.json")
CASES = [("vqgan256_train_gd", "frozen_state"),
         ("vqgan256_train_gd", "half_batch"),
         ("ldm_train_scan", "frozen_state"),
         ("ldm_train_scan", "half_batch"),
         ("ldm_gen_ddim150", "altered_answer")]


@pytest.mark.parametrize("workload,name", CASES)
def test_fault_reads_incorrect(capsys, workload, name):
    code = run.execute(tiny_cell(workload), BENCH, device="cpu", fault=name)
    assert code == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert failed, line["checks"]


def test_unknown_fault_is_refused():
    with pytest.raises(ValueError):
        with fault("no_such_fault"):
            pass
