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

# each configuration at a CPU's size: every width cut, the classes and batch
# small
TINY_CONFIG = {
    "ir50_casia": {"backbone": "ir_18", "input_size": 32, "num_classes": 40,
                   "degrade_min": 8, "degrade_max": 32},
}
TINY_TRAFFIC = {"batch": 8, "pool": 4}
# a cell on four ranks, data=2 x model=2, under the train cell's limits: the
# harness's path across cards runs here as four gloo processes
FOUR_RANKS = {"name": "train-2x2", "config": "ir50_casia", "traffic": "train_2x2",
              "chips": 4, "why": "four-rank path"}
FOUR_RANKS_TRAFFIC = {"driver": "train", "batch": 8, "pool": 4, "layout": [2, 2]}


def write_tiny_root(dst: Path) -> Path:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits"):
        (dst / "benchmark" / sub).mkdir(parents=True, exist_ok=True)
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY_CONFIG[c["name"]])
        (dst / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        src = ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
        t = json.loads(src.read_text())
        t.update(TINY_TRAFFIC)
        (dst / "benchmark" / "traffic" / src.name).write_text(json.dumps(t))
        lim = ROOT / "benchmark" / "limits" / f"{w['name']}.json"
        (dst / "benchmark" / "limits" / lim.name).write_text(lim.read_text())
    spec["workloads"].append(FOUR_RANKS)
    (dst / "benchmark" / "traffic" / "train_2x2.json").write_text(json.dumps(FOUR_RANKS_TRAFFIC))
    (dst / "benchmark" / "limits" / "train-2x2.json").write_text(
        (ROOT / "benchmark" / "limits" / "train-ir50-casia.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return write_tiny_root(tmp_path)
