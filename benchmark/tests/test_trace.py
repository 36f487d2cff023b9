"""The trace reader on a small synthetic Chrome trace."""

from __future__ import annotations

import json

import pytest

from benchmark.trace import kernel_s, load_events, summarize, top_kernels


def _x(name, cat, ts, dur, tid=1, pid=1):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur, "tid": tid, "pid": pid}


EVENTS = [
    _x("bench::segment", "user_annotation", 100, 1000),
    _x("bench::segment", "gpu_user_annotation", 90, 1100, tid=7, pid=2),
    _x("aten::conv2d", "cpu_op", 110, 200),
    _x("cudaLaunchKernel", "cuda_runtime", 150, 10),
    _x("aten::batch_norm", "cpu_op", 400, 300),
    _x("cudaStreamSynchronize", "cuda_runtime", 800, 300),
    _x("aten::other_thread", "cpu_op", 100, 1000, tid=2),
    _x("void cudnn_conv_fprop<bf16>", "kernel", 50, 150, tid=7, pid=2),     # starts before
    _x("void cudnn_conv_fprop<bf16>", "kernel", 300, 100, tid=7, pid=2),
    _x("batch_norm_collect_statistics_kernel", "kernel", 350, 100, tid=7, pid=2),
    _x("Memcpy DtoD", "gpu_memcpy", 600, 50, tid=8, pid=2),
    _x("ncclDevKernel_AllReduce_Sum_f32", "kernel", 1000, 50, tid=9, pid=2),
    _x("prelu_kernel", "kernel", 1500, 50, tid=7, pid=2),                  # after the span
]


def test_window_busy_kernels_and_gaps(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    s = summarize(load_events(str(path)), "bench::segment")
    assert s["window_s"] == pytest.approx(1000e-6)
    # [100, 200) + [300, 450) + [600, 650) + [1000, 1050)
    assert s["busy_s"] == pytest.approx(350e-6)
    assert s["compute_busy_s"] == pytest.approx(300e-6)          # NCCL's kernel left out
    assert s["kernels"]["void cudnn_conv_fprop<bf16>"] == [pytest.approx(250e-6), 2]
    assert "prelu_kernel" not in s["kernels"]
    assert "Memcpy DtoD" not in s["kernels"]
    gaps = {(label, round(sec * 1e6)) for label, sec in s["gaps"]}
    assert gaps == {("aten::batch_norm", 350), ("aten::batch_norm", 150),
                    ("aten::conv2d", 100), ("cudaStreamSynchronize", 50)}
    assert [round(g[1] * 1e6) for g in s["gaps"]] == [350, 150, 100, 50]


def test_kernel_s_by_patterns_and_top_kernels():
    s = summarize(EVENTS, "bench::segment")
    assert kernel_s(s, ("BATCH_NORM", "prelu")) == (pytest.approx(100e-6), 1)
    assert kernel_s(s, ("nccl",)) == (pytest.approx(50e-6), 1)
    assert kernel_s(s, ("nothing",)) == (0.0, 0)
    top = top_kernels([s, s])
    assert top[0] == ["void cudnn_conv_fprop<bf16>", pytest.approx(250e-6)]
    assert len(top) == 3


def test_a_trace_without_the_span_raises():
    with pytest.raises(RuntimeError):
        summarize(EVENTS[2:], "bench::segment")
    with pytest.raises(RuntimeError):
        summarize(EVENTS[2:7])


def test_a_trace_of_the_device_alone_spans_its_operations():
    s = summarize([e for e in EVENTS if e["cat"] in ("kernel", "gpu_memcpy")])
    assert s["window_s"] == pytest.approx(1500e-6)                 # [50, 1550)
    assert s["busy_s"] == pytest.approx(450e-6)
    assert s["compute_busy_s"] == pytest.approx(400e-6)
    assert s["kernels"]["prelu_kernel"] == [pytest.approx(50e-6), 1]
    assert s["gaps"] == [["before prelu_kernel", pytest.approx(450e-6)],
                         ["before ncclDevKernel_AllReduce_Sum_f32", pytest.approx(350e-6)],
                         ["before Memcpy DtoD", pytest.approx(150e-6)],
                         ["before void cudnn_conv_fprop<bf16>", pytest.approx(100e-6)]]


def test_a_traced_run_reads_its_segment(tiny_root, capsys):
    from benchmark.harness import run
    from benchmark.run import parse

    argv = ["--workload", "embed-ir50-16px", "--seed", "5", "--seconds", "0.2", "--trace", "1",
            "--device", "cpu", "--root", str(tiny_root)]
    assert run(parse(argv), 0.0) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"]["busy_s"] == 0 < out["device"]["window_s"]       # no device here
    assert set(out["metrics"]) == {"embed_mfu_pct"}                   # no kernel to read
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
