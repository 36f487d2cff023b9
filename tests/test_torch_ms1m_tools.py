"""The port's MS1M tools against ``crfr``'s scripts on the CPU:
``bench.ms1m_scale`` prints ``crfr``'s keys (XLA's memory accounting and
retrace count replaced by the card's peak memory) with a falling loss on
its repeated batch; ``bench.ms1m_fit`` writes ``scripts/ms1m_fit.py``'s
pack bytes, starts ``crfr``'s ``train`` command on the port, and reads a
``metrics.jsonl`` as ``crfr``'s does, but for the step reference, which
it measures on the card instead of quoting a TPU number."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from crfr_torch.bench import ms1m_fit, ms1m_scale

REPO = Path(__file__).resolve().parent.parent

# scripts/ms1m_scale.py's keys (:116-128), less jit_cache_entries and the
# hbm_* accounting, which mean nothing on the card
SCALE_KEYS = {"backbone", "batch", "ce_impl", "ms1m", "control", "head_marginal_ms",
              "loss_first", "loss_after_steps", "ln_C"}


@pytest.fixture(scope="module")
def ref_fit():
    """scripts/ms1m_fit.py, imported by path (it imports no JAX at the top)."""
    spec = importlib.util.spec_from_file_location("ref_ms1m_fit", REPO / "scripts/ms1m_fit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scale_prints_crfrs_keys_and_memorises(capsys):
    assert ms1m_scale.main(["--device", "cpu", "--backbone", "ir_18", "--batch", "4",
                            "--classes", "64", "--control-classes", "8", "--steps", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == SCALE_KEYS | {"peak_allocated_gb", "device"}
    assert out["peak_allocated_gb"] is None and out["device"] == "cpu"
    assert (out["backbone"], out["batch"], out["ce_impl"]) == ("ir_18", 4, "streaming(auto)")
    assert out["ms1m"]["classes"] == 64 and out["control"]["classes"] == 8
    for run in (out["ms1m"], out["control"]):
        assert set(run) == {"classes", "steady_step_ms", "imgs_per_sec", "compile_s"}
        assert run["steady_step_ms"] > 0 and run["imgs_per_sec"] > 0
    assert out["head_marginal_ms"] == pytest.approx(
        out["ms1m"]["steady_step_ms"] - out["control"]["steady_step_ms"], abs=0.011)
    assert out["ln_C"] == round(math.log(64), 3)
    assert math.isfinite(out["loss_first"]) and math.isfinite(out["loss_after_steps"])
    assert out["loss_after_steps"] < out["loss_first"]


def test_fit_pack_is_crfrs(tmp_path, ref_fit):
    kw = dict(n_imgs=6, classes=5, image_size=32, hard=1.0, seed=3)
    want = ref_fit.build_pack(str(tmp_path / "ref"), **kw)
    got = ms1m_fit.build_pack(str(tmp_path / "port"), **kw)
    assert os.path.basename(got) == os.path.basename(want)
    assert Path(got).read_bytes() == Path(want).read_bytes()
    assert not Path(got + ".tmp").exists()
    assert ms1m_fit.build_pack(str(tmp_path / "port"), **kw) == got        # cached


def test_fit_child_is_crfrs_train_command(tmp_path, ref_fit, monkeypatch):
    """Both scripts' child commands, caught at ``subprocess.run`` (which
    fails, so each returns before its analysis): ``crfr``'s argv with
    ``crfr`` → ``crfr_torch`` and ``--device``."""
    argvs = {}

    def catch(tag):
        def run(cmd, **kw):
            argvs[tag] = cmd
            return SimpleNamespace(returncode=3)
        return run

    work = str(tmp_path / "w")
    flags = ["--workdir", work, "--classes", "5", "--steps", "2", "--batch", "3",
             "--image-size", "32", "--backbone", "ir_18", "--seed", "1"]
    monkeypatch.setattr(ref_fit.subprocess, "run", catch("ref"))
    monkeypatch.setattr(sys, "argv", ["ms1m_fit.py", *flags])
    assert ref_fit.main() == 3
    monkeypatch.setattr(ms1m_fit.subprocess, "run", catch("port"))
    assert ms1m_fit.main([*flags, "--device", "cpu"]) == 3
    want = argvs["ref"][:2] + ["crfr_torch"] + argvs["ref"][3:] + ["--device", "cpu"]
    assert argvs["ref"][2] == "crfr" and argvs["port"] == want
    assert not os.path.exists(os.path.join(work, ms1m_fit.DEVICE_STEP_FILE))   # no card


def _metrics(path: Path) -> None:
    """40 steps logged every 10 with one row lost (a gap 20 → 40), an eval
    row without a loss, and a row without a rate."""
    rows = [{"step": 10, "loss": 44.5, "imgs_per_sec": 900.0, "lr": 0.02},
            {"step": 20, "loss": 43.25, "imgs_per_sec": 1800.0, "lr": 0.04},
            {"step": 20, "eval_accuracy": 0.5},
            {"step": 40, "loss": 41.125, "imgs_per_sec": 2000.0, "lr": 0.08},
            {"step": 50, "loss": 40.0}]
    path.parent.mkdir(parents=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def test_fit_analysis_is_crfrs(tmp_path, capsys):
    work = tmp_path / "w"
    _metrics(work / "ckpt" / "metrics.jsonl")
    flags = ["--analyze-only", "--workdir", str(work), "--classes", "85742", "--steps", "40",
             "--batch", "64"]
    r = subprocess.run([sys.executable, str(REPO / "scripts/ms1m_fit.py"), *flags],
                       capture_output=True, text=True, timeout=120, check=True)
    want = json.loads(r.stdout.strip().splitlines()[-1])
    assert ms1m_fit.main(flags) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    on_card = {"device_step_ms_ref", "feed_overhead_ms"}
    assert set(got) == set(want) | {"device_step_device"}
    assert {k: v for k, v in got.items() if k in set(want) - on_card} == \
        {k: v for k, v in want.items() if k not in on_card}
    assert got["continuity_gaps"] == [[20, 40]] and got["final_step"] == 50
    assert got["device_step_ms_ref"] is None and got["feed_overhead_ms"] is None

    # the card's step, kept in the workdir by a run, is what --analyze-only reads
    (work / ms1m_fit.DEVICE_STEP_FILE).write_text(json.dumps(
        {"device_step_ms": 17.25, "device": "NVIDIA H100 80GB HBM3"}))
    assert ms1m_fit.main(flags) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["device_step_ms_ref"] == 17.25
    assert got["device_step_device"] == "NVIDIA H100 80GB HBM3"
    # the steady rate is the median of the later half of the rates: 1,900
    assert got["steady_imgs_per_sec"] == 1900.0
    assert got["feed_overhead_ms"] == round(1e3 * 64 / 1900.0 - 17.25, 1)
