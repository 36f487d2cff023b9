"""``train --recycle-every-steps``: checkpoint, restart the process, resume
exactly (crfr/cli.py's ``_recycle_exec``), held as crfr's
tests/test_recycle.py holds it.

With ``os.execv`` stubbed, at the boundary both packages' ``train`` append
the same generation record and exec ``python -m <package> <argv>
--resume``, with ``--resume`` never doubled and the checkpoint at the
boundary. Then a real chain on the CPU: 9 steps recycled every 3 steps
cross two process generations and end in the state of a straight 9-step
run bit for bit, with one metrics stream, on synthetic batches and on a
``.crfrpack`` (whose pipeline state is saved at each boundary)."""

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
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)
from tests.test_torch_train_cli import OVERRIDES, _same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Recycled(BaseException):
    pass


def _stub_execv(monkeypatch) -> dict:
    captured = {}

    def fake_execv(exe, argv):
        captured["exe"], captured["argv"] = exe, argv
        raise _Recycled

    monkeypatch.setattr(os, "execv", fake_execv)
    monkeypatch.delenv("CRFR_RECYCLE_GEN", raising=False)
    return captured


def _records(ckpt) -> list[dict]:
    return [json.loads(line) for line in open(os.path.join(ckpt, "recycles.jsonl"))]


def test_recycle_exec_argv_and_record_as_crfrs(tmp_path, monkeypatch):
    from crfr.cli import main as crfr_main
    from crfr.train.checkpoints import Checkpointer as CrfrCheckpointer
    from crfr_torch.train.checkpoints import Checkpointer

    captured = _stub_execv(monkeypatch)
    argv = ["train", "--preset", "casia_arcface", "--device", "cpu", "--max-steps", "6",
            "--recycle-every-steps", "2", *OVERRIDES, f"train.checkpoint_dir={tmp_path}/port"]
    with pytest.raises(_Recycled):
        main(argv)
    port = dict(captured)
    assert port["exe"] == sys.executable
    assert port["argv"] == [sys.executable, "-m", "crfr_torch", *argv, "--resume"]
    assert os.environ["CRFR_RECYCLE_GEN"] == "1"
    ck = Checkpointer(str(tmp_path / "port"))
    assert ck.latest_step() == 2 and ck.restore()["step"] == 2

    # crfr's own train at the same boundary, on a one-device mesh
    monkeypatch.delenv("CRFR_RECYCLE_GEN")
    crfr_argv = ["train", "--preset", "casia_arcface", "--max-steps", "6",
                 "--recycle-every-steps", "2", "mesh.data=1", *OVERRIDES,
                 "train.checkpoint_every_steps=100", f"train.checkpoint_dir={tmp_path}/crfr"]
    with pytest.raises(_Recycled):
        crfr_main(crfr_argv)
    assert captured["argv"] == [sys.executable, "-m", "crfr", *crfr_argv, "--resume"]
    ref_ck = CrfrCheckpointer(str(tmp_path / "crfr"), keep=3)
    assert ref_ck.latest_step() == 2
    ref_ck.close()

    got, want = _records(tmp_path / "port"), _records(tmp_path / "crfr")
    assert [(r["step"], r["gen"]) for r in got] == [(r["step"], r["gen"]) for r in want] \
        == [(2, 1)]
    assert set(got[0]) == set(want[0]) == {"step", "gen", "max_rss_mb"}    # no card here
    assert got[0]["max_rss_mb"] > 0

    # --resume already in the argv is not added again
    captured.clear()
    with pytest.raises(_Recycled):
        main(argv + ["--resume"])
    assert captured["argv"].count("--resume") == 1
    assert [(r["step"], r["gen"]) for r in _records(tmp_path / "port")] == [(2, 1), (4, 2)]


def _child(ckpt, *extra) -> subprocess.CompletedProcess:
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    env.pop("CRFR_RECYCLE_GEN", None)
    out = subprocess.run(
        [sys.executable, "-m", "crfr_torch", "train", "--preset", "casia_arcface",
         "--device", "cpu", "--max-steps", "9", *OVERRIDES, "train.checkpoint_every_steps=100",
         "train.keep_checkpoints=1", f"train.checkpoint_dir={ckpt}", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


@pytest.mark.parametrize("source", ["synthetic", "records"])
def test_recycled_chain_equals_a_straight_run(tmp_path, source):
    extra = []
    if source == "records":
        rng = np.random.default_rng(0)
        write_pack(str(tmp_path / "train.crfrpack"),
                   [(int(i % 4), rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))
                    for i in range(20)])
        extra = ["--train-records", str(tmp_path / "train.crfrpack"), "--workers", "2"]
    chain = _child(tmp_path / "chain", "--recycle-every-steps", "3", *extra)
    straight = _child(tmp_path / "straight", *extra)

    for out in (chain, straight):
        assert json.loads(out.stdout.strip().splitlines()[-1]) == {"final_step": 9}
    assert [(r["step"], r["gen"]) for r in _records(tmp_path / "chain")] == [(3, 1), (6, 2)]
    assert chain.stderr.count("recycling process at step") == 2
    assert "resumed from step 3" in chain.stderr and "resumed from step 6" in chain.stderr
    steps = [json.loads(line)["step"] for line in open(tmp_path / "chain" / "metrics.jsonl")
             if '"loss"' in line]
    assert steps == list(range(1, 10))

    def final(d):
        return torch.load(d / f"step_{9:09d}.pt", weights_only=True)["state"]

    _same(final(tmp_path / "chain"), final(tmp_path / "straight"))
    if source == "records":
        for d in ("chain", "straight"):        # 72 records of 20 taken, none drawn ahead
            saved = json.loads((tmp_path / d / "data_state.json").read_text())
            assert saved == {"step": 9, "state": {"epoch": 3, "position": 12}}
