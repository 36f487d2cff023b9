"""The benchmark's CPU tests: the checkout on the import path, and a copy of
the benchmark's data at sizes a CPU can run (``tiny_root``)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each configuration at a CPU's size is ``benchmark/tests/cpu_cuts/<config>.json``:
# keys of the configuration file put over it. A cut may change the depth
# (``backbone``), the input size, the classes, the lows, the embedding width
# and the CE's block and streaming threshold; the batch is TINY_TRAFFIC's. The
# real file keeps ``units`` as ``reference/irse.py::STAGES`` has them, as
# ``test_config_files_state_the_reference_architecture`` reads it, not the cut.
CPU_CUTS = Path("benchmark") / "tests" / "cpu_cuts"
TINY_TRAFFIC = {"batch": 8, "pool": 4}
# a cell on four ranks, data=2 x model=2, under the train cell's limits: the
# harness's path across cards runs here as four gloo processes
FOUR_RANKS = {"name": "train-2x2", "config": "ir50_casia", "traffic": "train_2x2",
              "chips": 4, "why": "four-rank path"}
FOUR_RANKS_TRAFFIC = {"driver": "train", "batch": 8, "pool": 4, "layout": [2, 2]}


def cpu_cut(src: Path, config: str) -> dict:
    path = src / CPU_CUTS / f"{config}.json"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {config!r} has no CPU cut: add {CPU_CUTS}/"
                                f"{config}.json, the keys that bring it to a CPU's size")
    return json.loads(path.read_text())


def write_tiny_root(dst: Path, src: Path = ROOT) -> Path:
    """``src``'s ``BENCHMARK.json`` and the files it names, each
    configuration under its CPU cut and each traffic at TINY_TRAFFIC, with
    the four-rank cell added."""
    spec = json.loads((src / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits"):
        (dst / "benchmark" / sub).mkdir(parents=True, exist_ok=True)
    for c in spec["configs"]:
        cfg = json.loads((src / c["file"]).read_text())
        cfg.update(cpu_cut(src, c["name"]))
        (dst / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        path = src / "benchmark" / "traffic" / f"{w['traffic']}.json"
        t = json.loads(path.read_text())
        t.update(TINY_TRAFFIC)
        (dst / "benchmark" / "traffic" / path.name).write_text(json.dumps(t))
        lim = src / "benchmark" / "limits" / f"{w['name']}.json"
        (dst / "benchmark" / "limits" / lim.name).write_text(lim.read_text())
    spec["workloads"].append(FOUR_RANKS)
    (dst / "benchmark" / "traffic" / "train_2x2.json").write_text(json.dumps(FOUR_RANKS_TRAFFIC))
    (dst / "benchmark" / "limits" / "train-2x2.json").write_text(
        (src / "benchmark" / "limits" / "train-ir50-casia.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return write_tiny_root(tmp_path)


@pytest.fixture
def tiny_root_of(tmp_path):
    """``tiny_root_of(src)``: the tiny copy of another checkout's benchmark."""
    return lambda src: write_tiny_root(tmp_path / "tiny", src)
