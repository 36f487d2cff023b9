"""The cells of ``BENCHMARK.json`` by the driver their traffic names, for the
tests that run over every cell, and a CPU run of one cell of a tiny root."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.harness import ROOT, load_cell

SEED = 2 ** 31 + 11
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
DRIVER = {name: load_cell(ROOT, name).traffic["driver"] for name in CELLS}


def of(driver: str) -> list[str]:
    """The cells whose traffic ``driver`` runs, in ``BENCHMARK.json``'s order."""
    return [name for name in CELLS if DRIVER[name] == driver]


def float32(root: Path) -> Path:
    """Every configuration of ``root`` computing in float32."""
    for f in (root / "benchmark" / "configs").iterdir():
        c = json.loads(f.read_text())
        c["compute_dtype"] = "float32"
        f.write_text(json.dumps(c))
    return root


def run_cpu(root: Path, workload: str, capsys, fault: str | None = None) -> dict:
    """One run of ``workload`` of ``root`` on the CPU → its result line."""
    from benchmark.harness import run
    from benchmark.run import parse

    argv = ["--workload", workload, "--seed", str(SEED), "--seconds", "0.2", "--trace", "0",
            "--device", "cpu", "--root", str(root)]
    assert run(parse(argv + (["--fault", fault] if fault else [])), 0.0) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
