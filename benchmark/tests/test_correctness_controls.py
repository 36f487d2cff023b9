"""The comparison that decides ``correct`` fails what it should, at a CPU's
size with each cell's own limits: the control (the reference in fp8 for the
train cells; the program's int8 backbone for the embed cell), and every run
with a fault planted under the timed path. A sound run of the same sizes,
with the program in float32, passes."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import ROOT, load_cell

RT = type("Rt", (), {"device": torch.device("cpu"), "rank": 0, "world": 1})()
SEED = 2 ** 31 + 11


def _float32(root):
    for f in (root / "benchmark" / "configs").iterdir():
        c = json.loads(f.read_text())
        c["compute_dtype"] = "float32"
        f.write_text(json.dumps(c))
    return root


def _run(root, workload, capsys, fault=None) -> dict:
    from benchmark.harness import run
    from benchmark.run import parse

    argv = ["--workload", workload, "--seed", str(SEED), "--seconds", "0.2", "--trace", "0",
            "--device", "cpu", "--root", str(root)]
    assert run(parse(argv + (["--fault", fault] if fault else [])), 0.0) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _over(readings: dict, limits: dict) -> list:
    return [k for k in limits if not readings[k] <= limits[k]]


@pytest.mark.parametrize("workload", ["train-ir50-casia"])
def test_the_fp8_control_fails_a_train_cell(tiny_root, workload):
    from benchmark.drivers.train import Driver

    cell = load_cell(tiny_root, workload)
    d = Driver(cell, SEED, RT, None)
    d.check(3, 0)
    readings = d.planted()
    assert _over(readings["control"], cell.limits)
    assert _over(readings["half_batch"], cell.limits)


def test_the_int8_control_fails_the_embed_cell(tiny_root):
    from benchmark.drivers.embed import Driver

    cell = load_cell(tiny_root, "embed-ir50-16px")
    d = Driver(cell, SEED, RT, None)
    d.check(0, 1)
    assert _over(d.planted()["control"], cell.limits)


@pytest.mark.parametrize("workload", ["embed-ir50-16px", "train-ir50-casia"])
def test_a_sound_run_passes(tiny_root, workload, capsys):
    out = _run(_float32(tiny_root), workload, capsys)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", [
    ("embed-ir50-16px", "altered_answer"),
    ("embed-ir50-16px", "half_batch"),
    ("train-ir50-casia", "frozen_state"),
    ("train-ir50-casia", "half_batch"),
])
def test_a_planted_fault_fails(tiny_root, workload, fault, capsys):
    out = _run(_float32(tiny_root), workload, capsys, fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", [None, "no_exchange", "frozen_state", "half_batch"])
def test_the_four_rank_cell_on_gloo(tiny_root, fault):
    """A cell on a data=2 x model=2 mesh as four CPU processes over gloo:
    sound, and with each fault it can have."""
    root = _float32(tiny_root)
    argv = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
            "train-2x2", "--seed", str(SEED), "--seconds", "0.2", "--trace", "0",
            "--device", "cpu", "--root", str(root)] + (["--fault", fault] if fault else [])
    r = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is (fault is None), out["checks"]
