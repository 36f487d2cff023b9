"""crfr_torch.ops.bank_scan against crfr.ops.bank_scan on the CPU: the plain
version of ``bank_tilemax`` equals crfr's Pallas kernel (interpret mode,
tile 8, chunk 64) exactly, and the three-phase ``bank_topk_fused`` equals
crfr's on the cases of tests/test_bank.py: gapped scores, a ragged bank, a
masked victim row, and a probe count that is not a multiple of 32. Labels
exact, scores within 1e-6 (the fused-vs-scan tolerance of crfr's tests;
the two stacks' probe scales may differ in the last bit)."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crfr.eval.bank import quantize_bank
from crfr.ops import bank_scan as ref
from crfr_torch.ops import bank_scan as port

TILE, CHUNK = 8, 64


def _gapped(rng, n_probes, n_gallery, dim=64, coeffs=(1.0, 0.8, 0.6, 0.4, 0.2)):
    """Probes as blends of distinct gallery axes: score gaps of ~0.09, far
    above int8 noise, so the top-k order is unambiguous."""
    g = np.eye(dim, dtype=np.float32)[:n_gallery]
    order = np.stack([rng.permutation(n_gallery)[:len(coeffs)] for _ in range(n_probes)])
    p = np.zeros((n_probes, dim), np.float32)
    for i, row in enumerate(order):
        p[i, row] = coeffs
    return p, g, np.arange(n_gallery), order


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n,m,d,invalid", [(32, 128, 64, 0.0), (64, 192, 128, 0.2),
                                           (32, 100, 64, 0.1), (32, 61, 512, 0.5),
                                           (257, 200, 64, 0.1), (32, 70, 48, 0.2),
                                           (7, 1, 64, 0.0), (257, 1, 48, 0.0)])
def test_tilemax_reference_equals_pallas_kernel(n, m, d, invalid):
    """The port's (N, T) maxima equal crfr's transposed (T, N) exactly. crfr
    needs M padded to its chunk; the port takes the ragged bank as it is."""
    rng = np.random.default_rng(m + d)
    pq = rng.integers(-127, 128, (n, d)).astype(np.int8)
    q = rng.integers(-127, 128, (m, d)).astype(np.int8)
    sc = rng.uniform(1e-3, 1e-2, m).astype(np.float32)
    valid = rng.random(m) >= invalid
    mp = -(-m // CHUNK) * CHUNK
    want = np.asarray(ref.bank_tilemax(
        jnp.asarray(pq), jnp.asarray(np.pad(q, ((0, mp - m), (0, 0)))),
        jnp.asarray(np.pad(sc, (0, mp - m))), jnp.asarray(np.pad(valid, (0, mp - m))),
        tile=TILE, chunk=CHUNK, interpret=True)).T
    before = port.bank_tilemax.launches
    got = port.bank_tilemax(*_t(pq, q, sc, valid), tile=TILE)
    assert port.bank_tilemax.launches == before          # CPU: the plain version
    assert got.shape == (n, -(-m // TILE)) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want[:, :got.shape[1]])


def _fused_case(case):
    rng = np.random.default_rng(0)
    if case == "gapped":                      # tests/test_bank.py:159
        p, g, labels, order = _gapped(rng, 16, 400, dim=512)
        k, victim = 5, None
    elif case == "ragged":                    # M not a multiple of tile or chunk
        p, g, labels, order = _gapped(rng, 16, 150, dim=256)
        k, victim = 5, None
    elif case == "victim":                    # tests/test_bank.py:175
        p, g, labels, order = _gapped(rng, 7, 150, dim=256, coeffs=(1.0, 0.6, 0.3))
        k = 3
        labels = labels.copy()
        victim = int(np.setdiff1d(np.arange(150), order.ravel())[0])
        g = g.copy()
        g[victim] = 10.0 * g[int(order[0, 0])]    # probe 0's best direction, masked
        labels[victim] = -1
    else:                                     # "n_odd": N % 32 != 0
        p, g, labels, order = _gapped(rng, 45, 256, dim=256)
        k, victim = 5, None
    return p, quantize_bank(g, labels), k, order, victim


@pytest.mark.parametrize("case", ["gapped", "ragged", "victim", "n_odd"])
def test_fused_topk_equals_crfr(case):
    p, bank, k, order, victim = _fused_case(case)
    want_s, want_l = ref.bank_topk_fused(p, bank.q, bank.scale, bank.labels, k=k,
                                         tile=TILE, chunk=CHUNK, interpret=True)
    got_s, got_l = port.bank_topk_fused(*_t(p, bank.q, bank.scale, bank.labels), k=k,
                                        tile=TILE)
    assert got_l.dtype == torch.int64 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_l.numpy(), order[:, :k])
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)
    if victim is not None:
        assert victim not in got_l.numpy()


def test_fused_topk_short_rows_and_probe_blocks(monkeypatch):
    """Fewer valid rows than k: label −1 and score −inf fill the row, as in
    crfr. A small phase-3 budget splits the probes into blocks without
    changing the answer."""
    rng = np.random.default_rng(3)
    p, g, labels, _ = _gapped(rng, 9, 64, dim=64, coeffs=(1.0, 0.5))
    labels = np.where(np.arange(64) < 3, labels, -1)          # 3 live rows
    bank = quantize_bank(g, labels)
    want_s, want_l = ref.bank_topk_fused(p, bank.q, bank.scale, bank.labels, k=5,
                                         tile=TILE, chunk=CHUNK, interpret=True)
    got_s, got_l = port.bank_topk_fused(*_t(p, bank.q, bank.scale, bank.labels), k=5,
                                        tile=TILE)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert (got_l.numpy()[:, 3:] == -1).all() and np.isneginf(got_s.numpy()[:, 3:]).all()
    np.testing.assert_allclose(got_s.numpy()[:, :3], np.asarray(want_s)[:, :3], atol=1e-6)
    monkeypatch.setattr(port, "_CAND_BYTES", 1)              # one probe per block
    blk_s, blk_l = port.bank_topk_fused(*_t(p, bank.q, bank.scale, bank.labels), k=5,
                                        tile=TILE)
    assert torch.equal(blk_l, got_l) and torch.equal(blk_s, got_s)


def test_fused_topk_refuses_too_few_tiles():
    p, g, labels, _ = _gapped(np.random.default_rng(4), 2, 20, dim=32, coeffs=(1.0,))
    bank = quantize_bank(g, labels)
    with pytest.raises(ValueError, match="fewer than k"):
        port.bank_topk_fused(*_t(p, bank.q, bank.scale, bank.labels), k=5, tile=8)


def test_tilemax_refuses_other_devices():
    x = torch.zeros((4, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        port.bank_tilemax(x, x, torch.zeros(4, device="meta"),
                          torch.zeros(4, dtype=torch.bool, device="meta"))


def test_gallery_trace_helpers():
    """The profiler breakdown's kernel groups for the gallery scan; the
    trace itself needs the card."""
    from crfr_torch.bench import xprof_check as xc

    assert xc._group("void (anonymous namespace)::bank_tilemax_kernel(signed char const*)") \
        == "bank_tilemax"
    assert xc._group("void at::native::bitonicSortKVInPlace<float, long>") == "sort"
    assert xc._group("void at::native::index_elementwise_kernel<128, 4>") == "gather"
    assert xc._group("void at::native::vectorized_gather_kernel<16, long>") == "gather"
    with pytest.raises(ValueError, match="CUDA device"):
        xc.trace_gallery(device="cpu")
