"""crfr_torch.eval.bank against crfr.eval.bank on the CPU: quantization
(host rows bit-equal; probes equal except at near-ties of the rounding),
the int8 scan and ``topk_matches_bank`` (labels exact, scores within 1e-6),
``.npz`` banks read and written by either package, and the bank lifecycle
cases of tests/test_bank_lifecycle.py on ``ServingBank(device="cpu")``."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import threading

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crfr.eval import bank as ref
from crfr_torch.eval import bank as port
from crfr_torch.eval.bank import QuantBank, ServingBank

CPU = "cpu"


def _gapped(rng, n_probes, n_gallery, dim=64, coeffs=(1.0, 0.8, 0.6, 0.4, 0.2)):
    g = np.eye(dim, dtype=np.float32)[:n_gallery]
    order = np.stack([rng.permutation(n_gallery)[:len(coeffs)] for _ in range(n_probes)])
    p = np.zeros((n_probes, dim), np.float32)
    for i, row in enumerate(order):
        p[i, row] = coeffs
    return p, g, np.arange(n_gallery), order


def _embs(rng, n, dim=32):
    """One dominant axis per row + small noise: unambiguous self-matches."""
    e = np.eye(dim, dtype=np.float32)[np.arange(n) % dim]
    return (e + rng.normal(0, 0.03, e.shape)).astype(np.float32)


def _same_bank(a, b):
    for f in ("q", "scale", "labels"):
        x, y = port._np(getattr(a, f)), port._np(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


# ---------------------------------------------------------------------------
# quantization and the scan
# ---------------------------------------------------------------------------


def test_quantize_rows_bit_equal(rng):
    x = rng.normal(0, 1, (300, 512)).astype(np.float32)
    x[3] = 0.0                                               # the clip floors
    for got, want in zip(port._quantize_rows(x), ref._quantize_rows(x)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    _same_bank(port.quantize_bank(x, np.arange(300) * 3), ref.quantize_bank(x, np.arange(300) * 3))


def test_quantize_probes_matches(rng):
    """int8 codes equal crfr's except where the value before rounding lies
    within 1e-4 of k + 0.5 (the two stacks' norms may differ in the last
    bit); the scales within a few float32 ulps (5e-7 relative) for the
    same reason."""
    x = rng.normal(0, 1, (256, 512)).astype(np.float32)
    pq, ps = port.quantize_probes(torch.from_numpy(x))
    rq, rs = (np.asarray(a) for a in ref.quantize_probes(jnp.asarray(x)))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_allclose(ps.numpy(), rs, rtol=5e-7, atol=0)
    xn = x.astype(np.float64) / np.linalg.norm(x.astype(np.float64), axis=-1, keepdims=True)
    v = np.abs(xn / (np.abs(xn).max(axis=-1, keepdims=True) / 127.0))
    near = np.abs(v - np.floor(v) - 0.5) < 1e-4
    diff = pq.numpy() != rq
    assert not (diff & ~near).any()
    assert diff.sum() <= near.sum() and near.mean() < 1e-3


@pytest.mark.parametrize("block", [16, 64, 400])
def test_streaming_topk_q_matches(rng, block):
    m = 40 if block == 16 else 400
    p, g, glabels, order = _gapped(rng, 32, m, dim=max(m, 64))
    bank = ref.quantize_bank(g, glabels)
    ws, wl = ref.streaming_topk_q(p, bank.q, bank.scale, bank.labels, k=5, block=block)
    gs, gl = port.streaming_topk_q(torch.from_numpy(p), *(torch.from_numpy(a) for a in
                                   (bank.q, bank.scale, bank.labels)), k=5, block=block)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gl.numpy(), order)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fused", [None, False, True])
@pytest.mark.parametrize("holder", ["host", "device", "serving"])
def test_topk_matches_bank_matches(rng, fused, holder):
    """Every way of holding the bank, through the CPU default (scan), the
    scan and the fused path (the kernel's plain version on the CPU, tile
    128, so 640 rows make five tiles), equals crfr's scan."""
    p, g, glabels, order = _gapped(rng, 24, 640, dim=640)
    host = port.quantize_bank(g, glabels)
    bank = {"host": host, "device": host.to_device(CPU),
            "serving": ServingBank.from_bank(host, slab=512, device=CPU)}[holder]
    ws, wl = ref.topk_matches_bank(p, ref.quantize_bank(g, glabels), k=5)
    gs, gl = port.topk_matches_bank(p, bank, k=5, fused=fused, device=CPU)
    assert gs.shape == (24, 5) and gl.dtype == np.int64 and gs.dtype == np.float32
    np.testing.assert_array_equal(gl, np.asarray(wl))
    np.testing.assert_array_equal(gl, order)
    np.testing.assert_allclose(gs, np.asarray(ws), rtol=0, atol=1e-6)


def test_topk_matches_bank_small_bank_and_approx(rng):
    """A bank under 128·k rows scans even with fused=True; approx is
    accepted and the answer stays the exact one."""
    p, g, glabels, _ = _gapped(rng, 8, 50, coeffs=(1.0, 0.7, 0.4))
    bank = port.quantize_bank(g, glabels).to_device(CPU)
    ws, wl = ref.topk_matches_bank(p, ref.quantize_bank(g, glabels), k=3, block=16)
    for kw in ({"fused": True}, {"approx": True}, {"approx": 0.999}):
        gs, gl = port.topk_matches_bank(p, bank, k=3, block=16, **kw)
        np.testing.assert_array_equal(gl, np.asarray(wl))
        np.testing.assert_allclose(gs, np.asarray(ws), atol=1e-6)
    # a one-device mesh scans on the one device; a mesh of more devices than
    # this process group's ranks, or one whose size cannot be read, raises
    one = port.topk_matches_bank(p, bank, k=3, block=16, mesh=SimpleNamespace(size=lambda: 1))
    np.testing.assert_array_equal(one[1], np.asarray(wl))
    with pytest.raises(ValueError, match="process group"):
        port.topk_matches_bank(p, bank, k=3, mesh=SimpleNamespace(size=lambda: 2))
    with pytest.raises(TypeError, match="size of mesh"):
        port.topk_matches_bank(p, bank, k=3, mesh=object())


def test_bank_to_device_and_dequantize(rng):
    host = port.quantize_bank(rng.normal(0, 1, (60, 64)), np.arange(60))
    dev = host.to_device(CPU)
    assert isinstance(dev.q, torch.Tensor) and dev.labels.dtype == torch.int64
    assert len(dev) == len(host) == 60
    np.testing.assert_array_equal(dev.dequantize(), host.dequantize())
    np.testing.assert_array_equal(host.dequantize(), ref.QuantBank(
        host.q, host.scale, host.labels).dequantize())


@pytest.mark.parametrize("writer", ["crfr", "port", "port_device"])
def test_npz_bank_crosses_packages(rng, tmp_path, writer):
    """A bank saved by either package loads bitwise in the other."""
    g = rng.normal(0, 1, (37, 96)).astype(np.float32)
    labels = rng.integers(0, 10, 37)
    path = str(tmp_path / "bank.npz")
    bank = ref.quantize_bank(g, labels)
    if writer == "crfr":
        ref.save_bank(path, bank)
        back = port.load_bank(path)
    else:
        pb = port.quantize_bank(g, labels)
        port.save_bank(path, pb.to_device(CPU) if writer == "port_device" else pb)
        back = ref.load_bank(path)
    _same_bank(back, bank)
    assert back.labels.dtype == np.int64


# ---------------------------------------------------------------------------
# lifecycle (tests/test_bank_lifecycle.py)
# ---------------------------------------------------------------------------


def test_append_bitwise_equals_rebuild(rng):
    a = rng.normal(0, 1, (13, 24)).astype(np.float32)
    b = rng.normal(0, 1, (7, 24)).astype(np.float32)
    la, lb = np.arange(13), np.arange(100, 107)
    grown = port.append_bank(port.quantize_bank(a, la), b, lb)
    rebuilt = port.quantize_bank(np.concatenate([a, b]), np.concatenate([la, lb]))
    _same_bank(grown, rebuilt)
    _same_bank(grown, ref.append_bank(ref.quantize_bank(a, la), b, lb))


def test_append_auto_labels_and_validation(rng):
    bank = port.quantize_bank(rng.normal(0, 1, (5, 16)), [3, 9, 1, 0, 2])
    grown = port.append_bank(bank, rng.normal(0, 1, (3, 16)))
    assert grown.labels[-3:].tolist() == [10, 11, 12]
    with pytest.raises(ValueError, match="labels"):
        port.append_bank(bank, rng.normal(0, 1, (3, 16)), labels=[1, 2])


def test_remove_leaves_rows_untouched(rng):
    x = rng.normal(0, 1, (10, 16)).astype(np.float32)
    bank = port.quantize_bank(x, np.arange(10))
    out = port.remove_bank(bank, [2, 5, 5, 7])
    keep = [0, 1, 3, 4, 6, 8, 9]
    assert out.labels.tolist() == keep
    assert (out.q == bank.q[keep]).all() and (out.scale == bank.scale[keep]).all()
    _same_bank(out, ref.remove_bank(ref.quantize_bank(x, np.arange(10)), [2, 5, 5, 7]))


def _sb(rng, n=6, dim=32, slab=16):
    x = _embs(rng, n, dim)
    return ServingBank.from_bank(port.quantize_bank(x, np.arange(n)), slab=slab,
                                 device=CPU), x


def test_serving_enroll_snapshot_equals_host_rebuild(rng):
    sb, x0 = _sb(rng)
    x1 = rng.normal(0, 1, (3, 32)).astype(np.float32)
    x2 = rng.normal(0, 1, (2, 32)).astype(np.float32)
    assert sb.enroll(x1, labels=[10, 11, 12]).tolist() == [10, 11, 12]
    assert sb.enroll(x2).tolist() == [13, 14]
    assert len(sb) == 11
    snap = sb.snapshot()
    want = port.append_bank(port.append_bank(port.quantize_bank(x0, np.arange(6)),
                                             x1, [10, 11, 12]), x2, [13, 14])
    _same_bank(snap, want)


def test_serving_bank_follows_crfr(rng):
    """The same enrolls, removes and growth on both packages' ServingBanks:
    equal snapshots, capacities, sizes and returned labels."""
    x = _embs(rng, 6, 32)
    banks = [ref.ServingBank.from_bank(ref.quantize_bank(x, np.arange(6)), slab=16),
             ServingBank.from_bank(port.quantize_bank(x, np.arange(6)), slab=16, device=CPU)]
    steps = [("enroll", rng.normal(0, 1, (3, 32)).astype(np.float32), [10, 11, 12]),
             ("enroll", rng.normal(0, 1, (20, 32)).astype(np.float32), None),
             ("remove", [1, 12, 99], None),
             ("enroll", rng.normal(0, 1, (1, 32)).astype(np.float32), None)]
    for op, arg, labels in steps:
        outs = [b.enroll(arg, labels=labels) if op == "enroll" else b.remove(arg)
                for b in banks]
        assert np.array_equal(outs[0], outs[1]), op
        assert banks[0].capacity == banks[1].capacity and len(banks[0]) == len(banks[1])
    _same_bank(banks[1].snapshot(), banks[0].snapshot())


def test_serving_remove_tombstones_and_scan(rng):
    sb, x = _sb(rng, n=8)
    assert sb.remove([2, 5]) == 2
    assert sb.remove([2]) == 0                       # already dead
    assert len(sb) == 6
    assert set(sb.snapshot().labels.tolist()) == {0, 1, 3, 4, 6, 7}
    _, lab = port.topk_matches_bank(x, sb, k=4)
    assert not np.isin(lab, [2, 5]).any()
    for i in [0, 1, 3, 4, 6, 7]:
        assert lab[i, 0] == i


def test_serving_scan_parity_with_compacted_host_bank(rng):
    sb, _ = _sb(rng, n=10)
    sb.enroll(rng.normal(0, 1, (5, 32)).astype(np.float32))
    sb.remove([1, 12])
    probes = rng.normal(0, 1, (4, 32)).astype(np.float32)
    s_dev, l_dev = port.topk_matches_bank(probes, sb, k=5)
    s_host, l_host = port.topk_matches_bank(probes, sb.snapshot(), k=5, device=CPU)
    np.testing.assert_array_equal(l_dev, l_host)
    np.testing.assert_array_equal(s_dev, s_host)


def test_serving_grow_preserves_rows(rng):
    sb, x0 = _sb(rng, n=6, slab=16)
    assert sb.capacity == 16
    big = rng.normal(0, 1, (20, 32)).astype(np.float32)
    sb.enroll(big)                                   # needs a grow
    assert sb.capacity >= 26 and sb.capacity % 16 == 0
    _same_bank(sb.snapshot(), port.append_bank(port.quantize_bank(x0, np.arange(6)), big))


def test_serving_mutations_copy_on_write(rng):
    """A view fetched before enroll, remove and grow still holds the bank as
    it was: mutations build new tensors and never write into published ones."""
    sb, _ = _sb(rng, n=6, slab=8)
    view = sb.view()
    before = [t.clone() for t in (view.q, view.scale, view.labels)]
    sb.enroll(rng.normal(0, 1, (2, 32)).astype(np.float32))
    sb.remove([0, 3])
    sb.enroll(rng.normal(0, 1, (9, 32)).astype(np.float32))     # grows
    for t, b in zip((view.q, view.scale, view.labels), before):
        assert torch.equal(t, b)
    assert sb.view().q is not view.q


def test_serving_snapshot_roundtrips_save(rng, tmp_path):
    sb, _ = _sb(rng)
    sb.enroll(rng.normal(0, 1, (2, 32)).astype(np.float32))
    path = str(tmp_path / "bank.npz")
    port.save_bank(path, sb.snapshot())
    back = ref.load_bank(path)
    assert back.labels.dtype == np.int64 and len(back) == 8


def test_concurrent_auto_label_enrolls_are_unique(rng):
    sb, _ = _sb(rng, n=4, slab=16)
    errs = []

    def worker(seed):
        try:
            r = np.random.default_rng(seed)
            for _ in range(8):
                sb.enroll(r.normal(0, 1, (3, 32)).astype(np.float32))
        except Exception as e:                       # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in threads)
    lbl = sb.snapshot().labels
    assert len(sb) == 4 + 4 * 8 * 3
    assert len(np.unique(lbl)) == lbl.size


def test_scan_view_consistent_under_concurrent_growth(rng):
    """Scans race enrolls that keep growing the capacity; each scan reads
    one consistent view, so no torn mixed-capacity triple reaches it."""
    sb, x = _sb(rng, n=8, slab=8)
    stop = threading.Event()
    errs = []

    def mutate():
        r = np.random.default_rng(7)
        try:
            while not stop.is_set():
                sb.enroll(r.normal(0, 1, (5, 32)).astype(np.float32))
        except Exception as e:                       # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=mutate)
    t.start()
    try:
        for _ in range(25):
            _, lab = port.topk_matches_bank(x, sb, k=4)
            assert lab.shape == (8, 4)
            assert (lab[np.arange(8), 0] == np.arange(8)).all()
    finally:
        stop.set()
        t.join(timeout=60)
    assert not errs and not t.is_alive()


def test_device_label_range_guard(rng):
    bank = port.quantize_bank(rng.normal(0, 1, (2, 8)), [1, 2 ** 31])
    with pytest.raises(ValueError, match="int32"):
        bank.to_device(CPU)
    with pytest.raises(ValueError, match="int32"):
        ServingBank.from_bank(bank, slab=8, device=CPU)
    sb, _ = _sb(rng, n=2, dim=8, slab=8)
    with pytest.raises(ValueError, match="int32"):
        sb.enroll(rng.normal(0, 1, (1, 8)).astype(np.float32), labels=[2 ** 31])
    assert isinstance(sb.view(), QuantBank)
