"""The port's ``bench`` subcommand and its CPU yardstick against ``crfr``'s:
``python -m crfr_torch bench [--int8]`` prints ``crfr``'s line for the same
result and hands the flags on; a real run on the CPU prints finite
numbers; ``bench/torch_reference.py``'s IR-50 has ``crfr``'s keys and
shapes and, on ``crfr``'s weights, gives its output bit for bit; the
images/s cache keeps ``crfr``'s key; a missing PIL is named."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import json
import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import crfr.bench.throughput as ref_throughput
import crfr_torch.bench.throughput as throughput
from crfr.bench import torch_reference as ref_yardstick
from crfr.cli import main as ref_main
from crfr_torch.bench import torch_reference as yardstick
from crfr_torch.cli import main


def _stub(calls):
    def run_throughput(**kw):
        calls.append(kw)
        return SimpleNamespace(imgs_per_sec=12345.678, per_batch_ms=20.736)
    return run_throughput


@pytest.mark.parametrize("int8", [False, True])
def test_bench_prints_crfrs_line(monkeypatch, capsys, int8):
    ref_calls, calls = [], []
    monkeypatch.setattr(ref_throughput, "run_throughput", _stub(ref_calls))
    monkeypatch.setattr(throughput, "run_throughput", _stub(calls))
    flags = ["--batch", "64", "--steps", "7", *(["--int8"] if int8 else [])]
    assert ref_main(["bench", *flags]) == 0
    want = capsys.readouterr().out
    assert main(["bench", *flags, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert set(json.loads(got)) == {"imgs_per_sec", "per_batch_ms", "int8"}
    assert json.loads(got)["int8"] is int8
    assert ref_calls == [{"batch": 64, "steps": 7, "int8": int8}]
    assert calls == [{"batch": 64, "steps": 7, "int8": int8, "device": "cpu"}]


def test_bench_runs_on_the_cpu(capsys):
    assert main(["bench", "--device", "cpu", "--batch", "2", "--steps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["int8"] is False
    for k in ("imgs_per_sec", "per_batch_ms"):
        assert math.isfinite(out[k]) and out[k] > 0
    assert out["per_batch_ms"] == pytest.approx(1e3 * 2 / out["imgs_per_sec"])


def _randomised(model, seed: int):
    """Every parameter and float buffer of ``model`` drawn from ``seed``
    (BN statistics positive), so equal outputs mean equal weights used."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    return model


def test_yardstick_ir50_is_crfrs():
    ref = _randomised(ref_yardstick._build_torch_ir50(), 3)
    port = yardstick._build_torch_ir50()
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    port.load_state_dict(ref.state_dict())
    assert not port.training
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2, 3, 112, 112))
                         .astype(np.float32))
    with torch.no_grad():
        a, b = ref(x), port(x)
    assert b.shape == (2, 512)
    assert torch.equal(a, b)


def test_yardstick_cache_keeps_crfrs_key(tmp_path, monkeypatch):
    cache = tmp_path / "cache.json"
    monkeypatch.setattr(yardstick, "_CACHE", str(cache))
    ips = yardstick.measure_cpu_reference(batch=2, iters=1)
    assert math.isfinite(ips) and ips > 0
    key = f"torch{torch.__version__}-b2-t{torch.get_num_threads()}"
    assert json.loads(cache.read_text()) == {key: ips}
    # crfr's copy reads the port's entry as its own
    monkeypatch.setattr(ref_yardstick, "_CACHE", str(cache))
    assert ref_yardstick.measure_cpu_reference(batch=2, iters=1) == ips

    def no_model():
        raise AssertionError("built the model though the cache holds the key")
    monkeypatch.setattr(yardstick, "_build_torch_ir50", no_model)
    assert yardstick.measure_cpu_reference(batch=2, iters=1) == ips


def test_yardstick_names_a_missing_pil(tmp_path, monkeypatch):
    monkeypatch.setattr(yardstick, "_CACHE", str(tmp_path / "cache.json"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL.*pillow"):
        yardstick.measure_cpu_reference(batch=2, iters=1, use_cache=False)
    assert not (tmp_path / "cache.json").exists()
