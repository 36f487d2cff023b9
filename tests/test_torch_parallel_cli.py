"""The training commands as more than one process on the CPU: each rank a
``python -m crfr_torch`` process started with the ``CRFR_*`` environment,
the gloo group joined through a file, every process with a time limit.

- ``train`` as two processes on a ``.crfrpack``: 4 steps, then ``--resume``
  to 6, end bit-equal to 6 steps straight; each rank reads its contiguous
  half of the records; ``metrics.jsonl`` is rank 0's alone, and each rank
  keeps its own ``data_state_{rank}.json``.
- ``--recycle-every-steps`` in more than one process raises.
- ``train-distill`` (a one-process teacher checkpoint, laid out on the
  student's mesh) and ``train-sr`` as two processes on synthetic slabs:
  each run ends at its step with finite losses, rank 0 alone writes the
  metrics and the checkpoint, and a restored trainer of one process reads
  that checkpoint.
- ``match --probe-npy`` as two processes (the bank's rows sharded) prints
  what one process prints.
"""

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
from tests._torch_rank_worker import REPO
from tests.test_torch_train_cli import OVERRIDES


def _launch(ckpt, steps, records, pg, *extra, resume=False, world=2, timeout=150,
            cmd="train"):
    """``python -m crfr_torch CMD`` as ``world`` processes; → their exit
    codes and outputs."""
    argv = [sys.executable, "-m", "crfr_torch", cmd, "--preset", "casia_arcface",
            "--device", "cpu", *OVERRIDES, f"train.checkpoint_dir={ckpt}",
            f"mesh.data={world}", "--max-steps", str(steps),
            *(["--train-records", records] if records else []),
            *extra, *(["--resume"] if resume else [])]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CRFR_COORDINATOR=f"file://{pg}", CRFR_NUM_PROCESSES=str(world))
    procs = [subprocess.Popen(argv, env=dict(env, CRFR_PROCESS_ID=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


@pytest.fixture
def records(tmp_path):
    rng = np.random.default_rng(0)
    recs = [(int(i % 4), rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)) for i in range(22)]
    path = str(tmp_path / "train.crfrpack")
    write_pack(path, recs)
    return path


def test_two_process_train_resume_equals_straight_run(tmp_path, records):
    a, b = tmp_path / "a", tmp_path / "b"
    runs = [(a, 4, False), (a, 6, True), (b, 6, False)]
    for i, (ck, steps, resume) in enumerate(runs):
        rcs, outs = _launch(ck, steps, records, tmp_path / f"pg{i}", resume=resume)
        assert rcs == [0, 0], outs
        for out, err in outs:
            assert json.loads(out.strip().splitlines()[-1]) == {"final_step": steps}
        if resume:
            assert all("resumed from step 4" in err for _, err in outs)
        assert "records [0, 11), local batch 4" in outs[0][1]
        assert "records [11, 22), local batch 4" in outs[1][1]
    fa = torch.load(a / "step_000000006.pt", weights_only=True)["state"]
    fb = torch.load(b / "step_000000006.pt", weights_only=True)["state"]
    assert fa["step"] == fb["step"] == 6
    for k, v in fa["model"].items():
        assert torch.equal(v, fb["model"][k]), k
    for i, st in fa["opt"]["state"].items():
        assert torch.equal(st["momentum_buffer"], fb["opt"]["state"][i]["momentum_buffer"])
    rows = [json.loads(ln) for ln in (a / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3, 4, 5, 6]
    assert sorted(os.listdir(a)).count("data_state.json") == 0
    for r in range(2):
        saved = json.loads((a / f"data_state_{r}.json").read_text())
        assert saved["step"] == 6


def test_recycle_refuses_more_than_one_process(tmp_path, records):
    rcs, outs = _launch(tmp_path / "r", 4, records, tmp_path / "pg",
                        "--recycle-every-steps", "2")
    assert rcs[0] != 0 and rcs[1] != 0
    assert "does not run in a run of 2 processes" in outs[0][1]


def test_two_process_distill_and_sr(tmp_path):
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_trainer
    from crfr_torch.train.loop import Trainer
    from crfr_torch.train.sr_loop import SRTrainer

    teacher = tmp_path / "t"
    assert main(["train", "--preset", "casia_arcface", "--device", "cpu", *OVERRIDES,
                 f"train.checkpoint_dir={teacher}", "--max-steps", "1"]) == 0
    kd = ["--teacher-ckpt", str(teacher), "loss.distill_weight=0.1"]
    rcs, outs = _launch(tmp_path / "kd", 2, None, tmp_path / "pg_kd", *kd, cmd="train-distill")
    assert rcs == [0, 0], outs
    for out, _ in outs:
        last = json.loads(out.strip().splitlines()[-1])
        assert last["steps"] == 2 and np.isfinite(last["loss"]) and last["kd"] > 0
    rows = (tmp_path / "kd" / "distill_metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["step"] for r in rows if "loss" in r] == [1, 2]
    cfg = get_config("casia_arcface", [*OVERRIDES, "loss.distill_weight=0.1"])
    st = DistillTrainer(cfg, teacher_from_trainer(Trainer(cfg, device="cpu")), device="cpu")
    st.load_state_dict(Checkpointer(str(tmp_path / "kd" / "student")).restore())
    assert st.step == 2

    rcs, outs = _launch(tmp_path / "sr", 2, None, tmp_path / "pg_sr", "--scale", "4",
                        cmd="train-sr")
    assert rcs == [0, 0], outs
    for out, _ in outs:
        last = json.loads(out.strip().splitlines()[-1])
        assert last["steps"] == 2 and np.isfinite(last["g_loss"]) and np.isfinite(last["d_loss"])
    sr = SRTrainer(get_config("casia_arcface", OVERRIDES), scale=4, device="cpu")
    sr.restore_from(Checkpointer(str(tmp_path / "sr" / "sr")))
    assert sr.step == 2


def test_two_process_match_equals_one(tmp_path, capsys):
    """``match --probe-npy`` as two processes (an int8 bank's 301 rows
    sharded two ways, padded) prints what one process prints."""
    from crfr_torch.eval.bank import quantize_bank, save_bank

    rng = np.random.default_rng(3)
    rows = rng.normal(size=(301, 64)).astype(np.float32)
    probes = rows[[5, 150, 300]] + rng.normal(0, 0.05, (3, 64)).astype(np.float32)
    save_bank(str(tmp_path / "bank.npz"), quantize_bank(rows, np.arange(301) * 7))
    np.save(tmp_path / "p.npy", probes)
    argv = ["match", "--device", "cpu", "--gallery-npy", str(tmp_path / "bank.npz"),
            "--probe-npy", str(tmp_path / "p.npy"), "--k", "4"]
    assert main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [m["labels"][0] for m in want["matches"]] == [35, 1050, 2100]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CRFR_COORDINATOR=f"file://{tmp_path / 'pg'}", CRFR_NUM_PROCESSES="2")
    procs = [subprocess.Popen([sys.executable, "-m", "crfr_torch", *argv], cwd=REPO,
                              env=dict(env, CRFR_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    for out, _ in outs:
        assert json.loads(out.strip().splitlines()[-1]) == want
