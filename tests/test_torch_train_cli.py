"""``python -m crfr_torch train`` on the CPU: 4 steps, then ``--resume`` to
6, end with the same parameters, BN statistics and momentum as 6 steps
straight through, on synthetic batches and on a ``.crfrpack`` of records
(whose pipeline state is saved beside the checkpoint); ``--eval-bin``
writes at each ``eval_every_steps`` what ``eval-bin --ckpt`` reads on that
step's checkpoint (a command held against crfr's in
test_torch_eval_cli.py); what is not ported raises."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from crfr_torch.cli import main
from crfr_torch.data.records import write_pack

OVERRIDES = ["data.image_size=32", "model.input_size=32", "data.num_classes=4",
             "data.degrade_min=8", "data.degrade_max=32", "model.backbone=ir_18",
             "model.compute_dtype=float32", "loss.scale=16.0", "loss.margin=0.2",
             "train.batch_size=8", "train.warmup_steps=2", "train.checkpoint_every_steps=2",
             "train.log_every=1"]


def _train(ckpt, steps, *extra, resume=False):
    argv = ["train", "--preset", "casia_arcface", "--device", "cpu", *OVERRIDES,
            f"train.checkpoint_dir={ckpt}", "--max-steps", str(steps), *extra]
    return main(argv + (["--resume"] if resume else []))


def _final(ckpt, step):
    return torch.load(ckpt / f"step_{step:09d}.pt", weights_only=True)


def _same(a, b):
    assert a["step"] == b["step"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["opt"]["state"].items():
        assert torch.equal(st["momentum_buffer"], b["opt"]["state"][i]["momentum_buffer"])


@pytest.mark.parametrize("source", ["synthetic", "records", "records_saved_at_the_end"])
def test_resume_equals_straight_run(tmp_path, capsys, source):
    """``records_saved_at_the_end`` checkpoints only when a run ends, so the
    resume reads the pipeline state saved after the loop stopped."""
    extra = []
    if source == "records_saved_at_the_end":
        extra = ["train.checkpoint_every_steps=100", "train.keep_checkpoints=1"]
    if source.startswith("records"):
        rng = np.random.default_rng(0)
        recs = [(int(i % 4), rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))
                for i in range(20)]
        write_pack(str(tmp_path / "train.crfrpack"), recs)
        extra += ["--train-records", str(tmp_path / "train.crfrpack"), "--workers", "2"]
    assert _train(tmp_path / "a", 4, *extra) == 0
    assert _train(tmp_path / "a", 6, *extra, resume=True) == 0
    assert _train(tmp_path / "b", 6, *extra) == 0
    out = capsys.readouterr()
    finals = [json.loads(line) for line in out.out.splitlines() if "final_step" in line]
    assert finals == [{"final_step": 4}, {"final_step": 6}, {"final_step": 6}]
    assert "resumed from step 4" in out.err
    _same(_final(tmp_path / "a", 6)["state"], _final(tmp_path / "b", 6)["state"])
    if source.startswith("records"):
        saved = json.loads((tmp_path / "a" / "data_state.json").read_text())
        assert saved == {"step": 6, "state": {"epoch": 2, "position": 8}}     # 48 of 20 records
    rows = [json.loads(line) for line in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5, 6]
    cfg = _final(tmp_path / "a", 6)["config"]
    assert json.loads(cfg)["train"]["batch_size"] == 8


def eval_bin_file(tmp_path, n_pairs: int = 60):
    """A ``.bin`` of hard-rendered pairs at 32 px (8 identities): a net
    this young reads them near chance, so equal accuracies and EERs are
    not the trivial 1.0 and 0.0 of separable faces."""
    from crfr_torch.data.bins import save_bin
    from crfr_torch.data.render import RenderedIdentities

    i1, i2, same = RenderedIdentities(8, 32, seed=7).eval_pairs(np.random.default_rng(7),
                                                                n_pairs)
    path = tmp_path / "pairs.bin"
    save_bin(str(path), i1.astype(np.uint8), i2.astype(np.uint8), same)
    return path


def assert_evals_equal_eval_bin(capsys, tmp_path, ckpt, rows, ebin, steps):
    """The in-loop ``eval_accuracy``/``eval_eer`` rows at ``steps`` equal
    ``eval-bin --ckpt`` on a directory holding only that step's checkpoint."""
    evals = [r for r in rows if "eval_accuracy" in r]
    assert [r["step"] for r in evals] == steps
    for r in evals:
        one = tmp_path / f"only_{r['step']}"
        one.mkdir()
        name = f"step_{r['step']:09d}.pt"
        os.link(ckpt / name, one / name)       # a second name, not a copy
        capsys.readouterr()
        assert main(["eval-bin", "--device", "cpu", "--ckpt", str(one), "--bin", str(ebin)]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (got["accuracy"], got["eer"]) == (r["eval_accuracy"], r["eval_eer"]), r


@pytest.mark.parametrize("degrade", [None, 16])
def test_eval_bin_equals_eval_bin_of_the_checkpoint(tmp_path, capsys, degrade):
    """Eval after the checkpoint at steps 3 and 6 with the live weights (BN
    in eval mode, flip-TTA, degraded to ``data.eval_degrade_size`` when set)."""
    ebin = eval_bin_file(tmp_path)
    ck = tmp_path / "ck"
    extra = ["train.eval_every_steps=3", "train.checkpoint_every_steps=3"]
    if degrade:
        extra.append(f"data.eval_degrade_size={degrade}")
    assert _train(ck, 6, "--eval-bin", str(ebin), *extra) == 0
    rows = [json.loads(line) for line in (ck / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3, 4, 5, 6]
    assert all(0.0 < r["eval_eer"] and r["eval_accuracy"] < 1.0 for r in rows
               if "eval_accuracy" in r)
    assert_evals_equal_eval_bin(capsys, tmp_path, ck, rows, ebin, [3, 6])


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    with pytest.raises(KeyError, match="unknown config key"):
        _train(tmp_path, 1, "train.bogus=1")
    with pytest.raises(SystemExit):
        _train(tmp_path, 1, "--bogus")
    # WORLD_SIZE alone describes no launch (no address, no rank): one
    # process trains; a mesh larger than the processes raises. Two processes
    # are held in tests/test_torch_parallel_distill.py.
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert _train(tmp_path / "one", 1) == 0
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        _train(tmp_path / "two", 1, "mesh.data=2")


def test_cli_wants_cuda_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["train", "--preset", "casia_arcface", *OVERRIDES,
            f"train.checkpoint_dir={tmp_path}", "--max-steps", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_python_dash_m_entry_point():
    out = subprocess.run([sys.executable, "-m", "crfr_torch", "train", "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--resume" in out.stdout
