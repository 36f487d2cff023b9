"""A configuration and its cell come in as new files and appends to
``BENCHMARK.json``'s lists, with no edit to a file under ``benchmark/``: in
a copy of the checkout, an IR-100-shaped configuration whose CPU cut sends
the CE down the streamed path (more classes than the threshold, a partial
last block), a train traffic mix, the cell's limits and its CPU cut. The
harness resolves the cell, a sound CPU run of it is correct, one with its
state left unchanged is not, and every file the copy's ``benchmark/`` held
before is as it was."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark.harness import ROOT, load_cell

from _cells import float32, run_cpu

CUT = {"backbone": "ir_100", "input_size": 32, "num_classes": 50, "ce_block": 16,
       "ce_streaming_threshold": 32, "degrade_min": 8, "degrade_max": 32}
NEW = ["benchmark/configs/ir100_proof.json", "benchmark/traffic/train_proof.json",
       "benchmark/limits/train-proof.json", "benchmark/tests/cpu_cuts/ir100_proof.json"]


def _checkout(dst: Path) -> dict[str, bytes]:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` → the copy's files
    under ``benchmark/`` by path."""
    dst.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return _files(dst)


def _files(src: Path) -> dict[str, bytes]:
    return {p.relative_to(src).as_posix(): p.read_bytes()
            for p in (src / "benchmark").rglob("*") if p.is_file()}


def _add_proof(src: Path, cut: bool = True) -> None:
    b = src / "benchmark"
    cfg = json.loads((b / "configs" / "ir50_casia.json").read_text())
    cfg.update(name="ir100_proof", preset="ms1m_ijbc", backbone="ir_100",
               units=[3, 13, 30, 3], num_classes=85742, images=5822653, global_batch=1024)
    (b / "configs" / "ir100_proof.json").write_text(json.dumps(cfg))
    (b / "traffic" / "train_proof.json").write_text(json.dumps(
        {"driver": "train", "batch": 256, "pool": 8, "layout": [1, 1]}))
    shutil.copy(b / "limits" / "train-ir50-casia.json", b / "limits" / "train-proof.json")
    if cut:
        (b / "tests" / "cpu_cuts" / "ir100_proof.json").write_text(json.dumps(CUT))
    spec = json.loads((src / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ir100_proof", "source": "https://arxiv.org/abs/1801.07698",
                            "file": "benchmark/configs/ir100_proof.json", "reduced": [],
                            "why": "IR-100 with its head streamed"})
    spec["workloads"].append({"name": "train-proof", "config": "ir100_proof",
                              "traffic": "train_proof", "chips": 1, "why": "proof"})
    next(m for m in spec["end_to_end"] if m["name"] == "train_imgs_per_s")["workloads"].append(
        "train-proof")
    (src / "BENCHMARK.json").write_text(json.dumps(spec))


def test_a_configuration_and_its_cell_come_in_as_new_files(tmp_path, tiny_root_of, capsys,
                                                           monkeypatch):
    import crfr_torch.train.loop as loop

    src = tmp_path / "checkout"
    before = _checkout(src)
    _add_proof(src)
    after = _files(src)
    assert sorted(set(after) - set(before)) == sorted(NEW)
    assert all(after[p] == b for p, b in before.items())

    cell = load_cell(src, "train-proof")
    assert cell.config["backbone"] == "ir_100" and cell.traffic["driver"] == "train"
    assert {m["name"] for m in cell.end_to_end} == {"train_imgs_per_s", "setup_s"}
    assert set(cell.limits) == {"grad_gap", "change_gap", "grad_diff_median",
                                "change_diff_median"}

    streamed, ce = [], loop.streaming_margin_ce

    def counted(*args, **kwargs):
        streamed.append(kwargs["block"])
        return ce(*args, **kwargs)

    monkeypatch.setattr(loop, "streaming_margin_ce", counted)
    tiny = float32(tiny_root_of(src))
    out = run_cpu(tiny, "train-proof", capsys)
    assert out["correct"] is True, out["checks"]
    assert streamed and set(streamed) == {CUT["ce_block"]}
    out = run_cpu(tiny, "train-proof", capsys, "frozen_state")
    assert out["correct"] is False, out["checks"]
    assert _files(src) == after


def test_a_configuration_without_a_cpu_cut_names_the_file_to_add(tmp_path, tiny_root_of):
    src = tmp_path / "checkout"
    _checkout(src)
    _add_proof(src, cut=False)
    with pytest.raises(FileNotFoundError, match="benchmark/tests/cpu_cuts/ir100_proof.json"):
        tiny_root_of(src)
