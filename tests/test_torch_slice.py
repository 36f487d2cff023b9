"""The port's embed-and-verify slice on the CPU against crfr, end to end:
extract and serving functions (IR-18, 32 px, probes degraded to 8 px,
flip-TTA sum, B=4, float32) with the same weights, embeddings within
2e-3 abs / 1e-3 rel; the verification protocol on both stacks' embeddings;
the HTTP server; import hygiene; no silent CPU fallback."""

import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crfr.eval.extract import make_extract_fn as ref_extract_fn
from crfr.eval.verification import evaluate_verification as ref_evaluate
from crfr.serve import build_serving_fn as ref_serving_fn
from crfr_torch.eval.extract import make_extract_fn
from crfr_torch.eval.verification import evaluate_verification
from crfr_torch.serve import build_serving_fn
from crfr_torch.serve_http import make_server
from tests.test_torch_irse import jax_backbone, torch_twin

SIZE, LOW, B = 32, 8, 4
TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def twins():
    jm = jax_backbone(input_size=SIZE, seed=21)
    return jm, torch_twin(jm, input_size=SIZE)


def _faces(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


@pytest.mark.parametrize("degrade_to", [None, LOW])
@pytest.mark.parametrize("flip_fusion", ["sum", "concat"])
def test_extract_matches(twins, degrade_to, flip_fusion):
    jm, tm = twins
    x = _faces(1, B)
    want = ref_extract_fn(lambda v: jm(v, train=False), degrade_to=degrade_to,
                          flip=True, flip_fusion=flip_fusion, image_size=SIZE)(
        jnp.asarray(x, jnp.float32))
    got = make_extract_fn(tm, degrade_to=degrade_to, flip=True,
                          flip_fusion=flip_fusion, image_size=SIZE, device="cpu")(x)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_extract_state_fn_uses_live_weights(twins):
    _, tm = twins
    fn = make_extract_fn(lambda m, v: m(v), degrade_to=LOW, flip=False,
                         image_size=SIZE, state_fn=lambda: tm, device="cpu")
    x = _faces(2, B)
    np.testing.assert_allclose(fn(x).numpy(),
                               make_extract_fn(tm, degrade_to=LOW, flip=False,
                                               image_size=SIZE, device="cpu")(x).numpy(),
                               rtol=0, atol=0)


def test_extract_refuses_unported_options(twins):
    _, tm = twins
    with pytest.raises(NotImplementedError, match="sr_apply"):
        make_extract_fn(tm, degrade_to=LOW, sr_apply=lambda v: v, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        make_extract_fn(tm, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match=r"expected \(B, 32, 32, 3\)"):
        make_extract_fn(tm, image_size=SIZE, device="cpu")(np.zeros((1, 16, 16, 3), np.uint8))


@pytest.mark.parametrize("flip_tta", [False, True])
def test_serving_fn_matches(twins, flip_tta):
    jm, tm = twins
    x = _faces(3, B)
    want = ref_serving_fn(lambda v: jm(v, train=False), degrade_to=LOW,
                          flip_tta=flip_tta, image_size=SIZE)(jnp.asarray(x))
    got = build_serving_fn(tm, degrade_to=LOW, flip_tta=flip_tta, image_size=SIZE,
                           device="cpu")(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_verification_equal_on_both_stacks(twins):
    """HR gallery vs 8 px probes through each stack, then each stack's
    protocol on its own embeddings: the same accuracies and thresholds."""
    jm, tm = twins
    rng = np.random.default_rng(5)
    base = _faces(6, 16)
    issame = np.tile([True, False], 8)
    other = base[rng.permutation(16)]
    noisy = np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)
    probes = np.where(issame[:, None, None, None], noisy, other)

    j_apply = lambda v: jm(v, train=False)               # noqa: E731
    j_hr = ref_extract_fn(j_apply, image_size=SIZE)
    j_lr = ref_extract_fn(j_apply, degrade_to=LOW, image_size=SIZE)
    t_hr = make_extract_fn(tm, image_size=SIZE, device="cpu")
    t_lr = make_extract_fn(tm, degrade_to=LOW, image_size=SIZE, device="cpu")
    je1 = np.concatenate([np.asarray(j_hr(jnp.asarray(base[i:i + B], jnp.float32)))
                          for i in range(0, 16, B)])
    je2 = np.concatenate([np.asarray(j_lr(jnp.asarray(probes[i:i + B], jnp.float32)))
                          for i in range(0, 16, B)])
    te1 = torch.cat([t_hr(base[i:i + B]) for i in range(0, 16, B)])
    te2 = torch.cat([t_lr(probes[i:i + B]) for i in range(0, 16, B)])
    np.testing.assert_allclose(te1.numpy(), je1, **TOL)
    np.testing.assert_allclose(te2.numpy(), je2, **TOL)

    want = ref_evaluate(je1, je2, issame, n_folds=4)
    got = evaluate_verification(te1, te2, issame, n_folds=4, device="cpu")
    np.testing.assert_array_equal(got.fold_accuracies, want.fold_accuracies)
    np.testing.assert_array_equal(got.best_thresholds, want.best_thresholds)
    assert got.eer == pytest.approx(want.eer, abs=1e-6)


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def test_http_server_embeds(twins):
    _, tm = twins
    fn = build_serving_fn(tm, degrade_to=LOW, image_size=SIZE, device="cpu")
    meta = {"batch": B, "image_size": SIZE, "input_dtype": "uint8"}
    srv = make_server(fn, meta, host="127.0.0.1", port=0, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            info = json.loads(r.read())
        assert info["ok"] and info["meta"]["batch"] == B and info["gallery"] == 0
        one, many = _faces(7, 1), _faces(8, B + 2)       # more rows than the batch
        with ThreadPoolExecutor(2) as ex:
            f1 = ex.submit(_post, base + "/embed", one)
            f2 = ex.submit(_post, base + "/embed", many)
            got1, got2 = f1.result(timeout=120), f2.result(timeout=120)
        # the server pads and coalesces, so rows share batches other than
        # the direct calls': CPU convolutions then sum in another order
        np.testing.assert_allclose(got1, fn(one).numpy(), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got2, fn(many).numpy(), atol=1e-4, rtol=1e-4)
        for path in ("/match", "/enroll", "/remove"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, one)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/gallery", timeout=30)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/embed", np.zeros((1, 16, 16, 3), np.uint8))
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()
        th.join(timeout=10)
    assert not th.is_alive()


def test_import_hygiene():
    """Every crfr_torch module imports without JAX, flax or crfr."""
    code = (
        "import pkgutil, importlib, sys, crfr_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(crfr_torch.__path__, 'crfr_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'crfr'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_trace_helpers():
    """The profiler breakdown's interval union and kernel grouping; the
    trace itself needs the card."""
    from crfr_torch.bench import xprof_check as xc

    assert xc._busy_us([(5, 7), (0, 2), (1, 3), (6, 9)]) == 7.0
    assert xc._group("void resample_normalize_kernel<unsigned char, __nv_bfloat16>") \
        == "preprocess"
    assert xc._group("sm90_xmma_fprop_implicit_gemm_bf16bf16") == "conv"
    assert xc._group("cutlass_80_tensorop_bf16_s16816gemm_relu_bf16") == "gemm"
    assert xc._group("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    assert xc._group("memset") == "other"
    with pytest.raises(ValueError, match="CUDA device"):
        xc.trace_embed(device="cpu")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["extract", "serve", "server", "bench", "verify",
                                   "device"])
def test_no_quiet_cpu(no_cuda, twins, entry):
    """With CUDA hidden, an entry point called without device='cpu' raises."""
    from crfr_torch.bench.throughput import build_embed_pipeline
    from crfr_torch.device import resolve_device

    _, tm = twins
    calls = {
        "extract": lambda: make_extract_fn(tm),
        "serve": lambda: build_serving_fn(tm),
        "server": lambda: make_server(lambda v: v, {"batch": 1}),
        "bench": lambda: build_embed_pipeline("ir_18", image_size=SIZE),
        "verify": lambda: evaluate_verification(np.ones((2, 4)), np.ones((2, 4)),
                                                [True, False], n_folds=2),
        "device": lambda: resolve_device(),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
