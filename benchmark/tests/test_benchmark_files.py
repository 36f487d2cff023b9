"""``BENCHMARK.json`` and the files it names: every cell resolves its
configuration, traffic, driver, limits and metric readers by name; names and
units keep to their characters; nothing the harness runs imports JAX, Flax
or the JAX package, and the reference imports nothing of the program."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from benchmark.harness import ROOT, load_cell, load_module

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_counts():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["workloads"]) <= 24 and 1 <= len(SPEC["configs"]) <= 24
    fours = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert fours <= max(1, len(SPEC["workloads"]) // 4)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_one_line_texts():
    names = [*(c["name"] for c in SPEC["configs"]), *WORKLOADS,
             *(m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"])]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]] + \
            [k for c in SPEC["configs"] for k in c["reduced"]]:
        assert NAME.fullmatch(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [w["why"] for w in SPEC["workloads"]] + [m["layer"] for m in SPEC["per_layer"]] + \
        [c["source"] for c in SPEC["configs"]] + SPEC["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_resolves_by_name(workload):
    cell = load_cell(ROOT, workload)
    driver = load_module("drivers", cell.traffic["driver"])
    assert hasattr(driver, "Driver") and driver.images_per_call(cell) > 0
    assert driver.flops_per_call(cell) > 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert set(cell.limits) >= {"embed_gap"} or set(cell.limits) >= {
        "grad_gap", "change_gap", "grad_diff_median", "change_diff_median"}
    c = cell.config
    assert c["name"] == next(w["config"] for w in SPEC["workloads"] if w["name"] == workload)
    assert sorted(c["reduced"]) == sorted(
        next(x for x in SPEC["configs"] if x["name"] == c["name"])["reduced"])


def test_config_files_state_the_reference_architecture():
    from benchmark.reference.irse import STAGES, WIDTHS

    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert tuple(cfg["units"]) == STAGES[cfg["backbone"].split("_")[-1]]
        assert tuple(cfg["widths"]) == WIDTHS


def test_every_named_metric_has_a_reader():
    named = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "benchmark" / "metrics").glob("*.py")}
    assert named <= files


_SCAN = """
import sys
sys.path.insert(0, {root!r})
from benchmark import harness
for kind, name in {modules!r}:
    harness.load_module(kind, name)
{extra}
bad = [m for m in sys.modules if m.split(".")[0] in {forbidden!r}]
print(repr(sorted(bad)))
"""


def _loaded_after(modules, extra="", forbidden=("jax", "jaxlib", "flax", "crfr")) -> list:
    code = _SCAN.format(root=str(ROOT), modules=modules, extra=extra, forbidden=forbidden)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_nothing_the_harness_runs_imports_jax_or_the_jax_package():
    modules = [("drivers", p.stem) for p in (ROOT / "benchmark" / "drivers").glob("*.py")]
    modules += [("metrics", p.name[:-3]) for p in (ROOT / "benchmark" / "metrics").glob("*.py")]
    extra = ("import benchmark.run, benchmark.faults, benchmark.program, benchmark.trace\n"
             "import crfr_torch.train.loop, crfr_torch.serve, crfr_torch.models.quant\n"
             "import crfr_torch.parallel.multihost")
    assert _loaded_after(modules, extra) == []


def test_the_reference_imports_nothing_of_the_program():
    extra = ("import benchmark.reference.train, benchmark.reference.irse, "
             "benchmark.reference.arcface, benchmark.reference.sgd, "
             "benchmark.reference.bicubic")
    assert _loaded_after([], extra, forbidden=("jax", "jaxlib", "flax", "crfr",
                                               "crfr_torch")) == []


def test_without_cuda_a_run_exits_2_and_prints_no_result():
    r = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                        WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 2, r.stderr[-2000:]
    assert "{" not in r.stdout


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
