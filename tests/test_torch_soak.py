"""crfr_torch.bench.soak against crfr.bench.soak on the CPU: the fixtures
(a ``.crfrpack`` of raw pixels or JPEG bytes, a ``.bin`` of 600 pairs) are
byte for byte crfr's; a tiny soak on the CPU prints crfr's keys, with the
device numbers null (no card, no copy)."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import json

import pytest

from crfr.bench import soak as ref
from crfr_torch.bench import soak
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("fmt", ["raw", "jpeg"])
def test_pack_is_crfrs(tmp_path, fmt):
    ref._build_pack(str(tmp_path / "ref.crfrpack"), 3, 4, 32, seed=2, fmt=fmt)
    soak._build_pack(str(tmp_path / "port.crfrpack"), 3, 4, 32, seed=2, fmt=fmt)
    assert (tmp_path / "port.crfrpack").read_bytes() == (tmp_path / "ref.crfrpack").read_bytes()


def test_eval_bin_is_crfrs(tmp_path):
    ref._build_eval_bin(str(tmp_path / "ref.bin"), 5, 32)
    soak._build_eval_bin(str(tmp_path / "port.bin"), 5, 32)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()


# crfr's soak prints these (crfr/bench/soak.py:222-243)
CRFR_KEYS = {"metric", "steps", "batch", "fmt", "fit_imgs_per_sec", "step_only_imgs_per_sec",
             "fit_over_step", "host_pipeline_imgs_per_sec", "h2d_imgs_per_sec",
             "serial_host_bound_imgs_per_sec", "compile_s", "losses_every_500", "final_loss",
             "eval_accuracy", "jit_cache_entries", "max_rss_growth_mb", "workdir"}


def test_tiny_soak_on_the_cpu_prints_crfrs_keys(tmp_path, capsys):
    assert soak.main(["--device", "cpu", "--steps", "4", "--warm-steps", "1", "--batch", "8",
                      "--backbone", "ir_18", "--image-size", "32", "--classes", "4",
                      "--per-class", "4", "--eval-every", "4", "--ckpt-every", "2",
                      "--workdir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert CRFR_KEYS <= set(out)
    assert out["metric"] == "soak_fit_imgs_per_sec" and out["steps"] == 4
    assert out["device"] == "cpu" and out["card"] == "cpu"
    assert out["h2d_imgs_per_sec"] is None and out["peak_cuda_bytes"] is None
    assert out["jit_cache_entries"] is None
    assert out["fit_imgs_per_sec"] > 0 and out["step_only_imgs_per_sec"] > 0
    assert out["serial_host_bound_imgs_per_sec"] == out["host_pipeline_imgs_per_sec"]
    assert len(out["eval_accuracy"]) == 1 and 0 <= out["eval_accuracy"][0] <= 1
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_000000002.pt", "step_000000004.pt"]
    rows = [json.loads(line) for line in (tmp_path / "soak_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [4]
