"""The comparison that decides ``correct`` fails what it should, at a CPU's
size with each cell's own limits: the control (the reference in fp8 for the
train cells; the program's int8 backbone for the embed cells), and every run
with a fault planted under the timed path. A sound run of the same sizes,
with the program in float32, passes."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.faults import FAULTS
from benchmark.harness import ROOT, load_cell

from _cells import CELLS, DRIVER, SEED, float32, of, run_cpu

RT = type("Rt", (), {"device": torch.device("cpu"), "rank": 0, "world": 1})()
# each cell with each fault its driver can have; no exchange shows only on
# the four-rank cell
PLANTED = [(w, fault) for w in CELLS for kind, fault in FAULTS
           if kind == DRIVER[w] and fault != "no_exchange"]


def _over(readings: dict, limits: dict) -> list:
    return [k for k in limits if not readings[k] <= limits[k]]


@pytest.mark.parametrize("workload", of("train"))
def test_the_fp8_control_fails_a_train_cell(tiny_root, workload):
    from benchmark.drivers.train import Driver

    cell = load_cell(tiny_root, workload)
    d = Driver(cell, SEED, RT, None)
    d.check(3, 0)
    readings = d.planted()
    assert _over(readings["control"], cell.limits)
    assert _over(readings["half_batch"], cell.limits)


@pytest.mark.parametrize("workload", of("embed"))
def test_the_int8_control_fails_the_embed_cell(tiny_root, workload):
    from benchmark.drivers.embed import Driver

    cell = load_cell(tiny_root, workload)
    d = Driver(cell, SEED, RT, None)
    d.check(0, 1)
    assert _over(d.planted()["control"], cell.limits)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_passes(tiny_root, workload, capsys):
    out = run_cpu(float32(tiny_root), workload, capsys)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", PLANTED)
def test_a_planted_fault_fails(tiny_root, workload, fault, capsys):
    out = run_cpu(float32(tiny_root), workload, capsys, fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", [None, "no_exchange", "frozen_state", "half_batch"])
def test_the_four_rank_cell_on_gloo(tiny_root, fault):
    """A cell on a data=2 x model=2 mesh as four CPU processes over gloo:
    sound, and with each fault it can have."""
    root = float32(tiny_root)
    argv = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
            "train-2x2", "--seed", str(SEED), "--seconds", "0.2", "--trace", "0",
            "--device", "cpu", "--root", str(root)] + (["--fault", fault] if fault else [])
    r = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is (fault is None), out["checks"]
