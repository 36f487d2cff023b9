"""crfr_torch.eval.identification and crfr_torch.eval.ijbc against crfr on
the CPU: the streaming top-k on float galleries (labels exact on gapped
data, scores within 1e-5), the hierarchical block selection, closed-set and
open-set results (rank-1, CMC, TPIR@FPIR), IJB-C pooling (within 1e-6),
exact TAR@FAR and the two-gallery 1:N, on float and int8 galleries.
``approx`` is accepted and gives the exact answer."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crfr.eval import identification as ref
from crfr.eval import ijbc as ref_ijbc
from crfr.eval.bank import quantize_bank as ref_quantize_bank
from crfr_torch.eval import identification as port
from crfr_torch.eval import ijbc as port_ijbc
from crfr_torch.eval.bank import quantize_bank

CPU = "cpu"


def _gapped(rng, n_probes, n_gallery, dim=64, coeffs=(1.0, 0.8, 0.6, 0.4, 0.2)):
    g = np.eye(dim, dtype=np.float32)[:n_gallery]
    order = np.stack([rng.permutation(n_gallery)[:len(coeffs)] for _ in range(n_probes)])
    p = np.zeros((n_probes, dim), np.float32)
    for i, row in enumerate(order):
        p[i, row] = coeffs
    return p, g, np.arange(n_gallery), order


def _clustered(rng, n_ids, per_id, dim, noise):
    centers = rng.normal(0, 1, (n_ids, dim)).astype(np.float32)
    labels = np.repeat(np.arange(n_ids), per_id)
    return (centers[labels] + rng.normal(0, noise, (len(labels), dim))).astype(np.float32), \
        labels, centers


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("block", [16, 64, 500])
def test_streaming_topk_matches(rng, block):
    p, g, glabels, order = _gapped(rng, 24, 300, dim=300)
    ws, wl = ref.streaming_topk(p, g, glabels, k=5, block=block)
    gs, gl = port.streaming_topk(_t(p), _t(g), _t(glabels), k=5, block=block)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gl.numpy(), order)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,k", [(3, 5), (40, 5), (1000, 5), (1100, 4), (1030, 8)])
def test_block_topk_matches(rng, b, k):
    """Every branch of the hierarchical block selection: fewer rows than k,
    a tiny block (plain sort), whole tiles, and leftover rows past the last
    tile; on distinct random scores, with some masked rows."""
    sim = rng.normal(0, 1, (6, b)).astype(np.float32)
    lblk = np.arange(b) + 100
    lblk[::7] = -1
    sim[:, ::7] = -np.inf
    ws, wl = ref._block_topk(jnp.asarray(sim), jnp.asarray(lblk), k)
    gs, gl = port._block_topk(_t(sim), _t(lblk), k)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_top_k_breaks_ties_like_lax():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, -np.inf, 1.0]])
    s, i = port.top_k(x, 5)
    ws, wi = (np.asarray(a) for a in __import__("jax").lax.top_k(jnp.asarray(x.numpy()), 5))
    np.testing.assert_array_equal(i.numpy(), wi)
    np.testing.assert_array_equal(s.numpy(), ws)


@pytest.mark.parametrize("gallery", ["float", "int8"])
def test_topk_matches_matches(rng, gallery):
    p, g, glabels, order = _gapped(rng, 16, 200, dim=200)
    if gallery == "float":
        want = ref.topk_matches(p, g, glabels * 3, k=5, block=64)
        got = port.topk_matches(p, g, glabels * 3, k=5, block=64, device=CPU)
    else:                      # labels=None → the bank's; else they override
        want = ref.topk_matches(p, ref_quantize_bank(g, glabels), glabels * 3, k=5)
        got = port.topk_matches(p, quantize_bank(g, glabels).to_device(CPU), glabels * 3,
                                k=5)
        np.testing.assert_array_equal(
            port.topk_matches(p, quantize_bank(g, glabels), None, k=5, device=CPU)[1], order)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[1], order * 3)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0, atol=1e-5)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int64


def test_approx_flag_is_accepted_and_exact(rng, caplog):
    p, g, glabels, _ = _gapped(rng, 8, 120, dim=128)
    exact = port.topk_matches(p, g, glabels, k=5, block=64, device=CPU)
    assert port._approx_cfg(0.999) == (True, 0.999) and port._approx_cfg(1.0)[0] is False
    port._log_exact_once.cache_clear()
    with caplog.at_level(logging.INFO, logger="crfr_torch.eval.identification"):
        for approx in (True, 0.999):
            got = port.topk_matches(p, g, glabels, k=5, block=64, approx=approx, device=CPU)
            np.testing.assert_array_equal(got[1], exact[1])
            np.testing.assert_array_equal(got[0], exact[0])
    assert sum("exact top-k" in r.getMessage() for r in caplog.records) == 1
    with pytest.raises(TypeError, match="size of mesh"):
        port.topk_matches(p, g, glabels, k=5, mesh=object(), device=CPU)


@pytest.mark.parametrize("gallery", ["float", "int8"])
def test_one_device_mesh_scans_on_one_device(rng, gallery):
    """A mesh of one device takes the single-device scan, as in crfr; a
    mesh of more devices than this process group's ranks (one: there is no
    group), or one whose size cannot be read, raises. The row-sharded scan
    itself is held against crfr's in tests/test_torch_parallel.py."""
    import jax
    from types import SimpleNamespace

    p, g, glabels, order = _gapped(rng, 8, 200, dim=200)
    one = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("x",))
    two = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("x",))
    if gallery == "float":
        gal, ref_gal = g, g
    else:
        gal, ref_gal = quantize_bank(g, glabels).to_device(CPU), ref_quantize_bank(g, glabels)
    want = ref.topk_matches(p, ref_gal, glabels, k=5, block=64, mesh=one)
    for mesh in (one, SimpleNamespace(size=lambda: 1)):
        got = port.topk_matches(p, gal, glabels, k=5, block=64, mesh=mesh, device=CPU)
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        np.testing.assert_array_equal(got[1], order)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0, atol=1e-5)
    for mesh in (two, SimpleNamespace(size=lambda: 2)):
        with pytest.raises(ValueError, match="needs a process group of 2 ranks, this one has 1"):
            port.topk_matches(p, gal, glabels, k=5, mesh=mesh, device=CPU)
    with pytest.raises(TypeError, match="size of mesh"):
        port.topk_matches(p, gal, glabels, k=5, mesh=object(), device=CPU)


def test_closed_set_matches(rng):
    gal, glabels, centers = _clustered(rng, 60, 1, 64, 0.0)
    plabels = rng.integers(0, 60, 80)
    probes = (centers[plabels] + rng.normal(0, 2.5, (80, 64))).astype(np.float32)
    want = ref.closed_set_identification(probes, gal, plabels, glabels, max_rank=10,
                                         block=32)
    got = port.closed_set_identification(probes, gal, plabels, glabels, max_rank=10,
                                         block=32, device=CPU)
    assert got.rank1 == want.rank1 and 0.0 < got.rank1 < 1.0
    np.testing.assert_array_equal(got.cmc, np.asarray(want.cmc))
    assert got.tpir_at_fpir == {}
    wr1, wcmc = ref._dense_closed_set(jnp.asarray(probes), jnp.asarray(gal),
                                      jnp.asarray(plabels), jnp.asarray(glabels), 10)
    gr1, gcmc = port._dense_closed_set(_t(probes), _t(gal), _t(plabels), _t(glabels), 10)
    np.testing.assert_array_equal(gr1.numpy(), np.asarray(wr1))
    np.testing.assert_array_equal(gcmc.numpy(), np.asarray(wcmc))
    np.testing.assert_array_equal(gcmc.numpy().mean(axis=0), got.cmc)


@pytest.mark.parametrize("gallery", ["float", "int8"])
def test_open_set_matches(rng, gallery):
    gal, glabels, centers = _clustered(rng, 150, 1, 128, 0.0)
    mated = np.arange(100) < 70
    plabels = np.where(mated, rng.integers(0, 150, 100), 1000 + np.arange(100))
    base = np.where(mated[:, None], centers[np.minimum(plabels, 149)],
                    rng.normal(0, 1, (100, 128)))
    probes = (base + rng.normal(0, 0.7, (100, 128))).astype(np.float32)
    fpir = (0.01, 0.1, 0.3)
    g_ref = gal if gallery == "float" else ref_quantize_bank(gal, glabels)
    g_port = gal if gallery == "float" else quantize_bank(gal, glabels).to_device(CPU)
    want = ref.open_set_identification(probes, g_ref, plabels, glabels, mated,
                                       fpir_targets=fpir, max_rank=10)
    got = port.open_set_identification(probes, g_port, plabels, glabels, mated,
                                       fpir_targets=fpir, max_rank=10, device=CPU)
    assert got.rank1 == want.rank1
    np.testing.assert_array_equal(got.cmc, np.asarray(want.cmc))
    assert got.tpir_at_fpir == want.tpir_at_fpir
    assert 0.0 < got.tpir_at_fpir[0.3] <= got.rank1 <= 1.0


# ---------------------------------------------------------------------------
# IJB-C
# ---------------------------------------------------------------------------


def _ijbc_meta(rng, n_subjects=12, imgs=90, dim=64):
    subjects = rng.integers(0, n_subjects, imgs)
    template_ids = subjects * 10 + rng.integers(0, 2, imgs)          # 2 templates each
    media_ids = rng.integers(0, 3, imgs)
    centers = rng.normal(0, 1, (n_subjects, dim))
    embs = (centers[subjects] + rng.normal(0, 0.8, (imgs, dim))).astype(np.float32)
    return embs, template_ids, media_ids, subjects


def test_pool_templates_matches(rng):
    embs, tids, mids, _ = _ijbc_meta(rng)
    seg, tom, uids = port_ijbc.make_template_index(tids, mids)
    wseg, wtom, wuids = ref_ijbc.make_template_index(tids, mids)
    for a, b in ((seg, wseg), (tom, wtom), (uids, wuids)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    want = ref_ijbc.pool_templates(jnp.asarray(embs), jnp.asarray(seg), jnp.asarray(tom),
                                   int(seg.max()) + 1, len(uids))
    got = port_ijbc.pool_templates(embs, seg, tom, int(seg.max()) + 1, len(uids), device=CPU)
    assert got.shape == (len(uids), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_tar_at_far_exact_and_11_match(rng):
    scores = np.round(rng.normal(0, 1, 4000), 2).astype(np.float32)      # many ties
    issame = rng.random(4000) < 0.3
    scores[issame] += 1.5
    far = (1e-4, 1e-3, 1e-2, 0.1, 1.0)
    assert port_ijbc.tar_at_far_exact(scores, issame, far) == \
        ref_ijbc.tar_at_far_exact(scores, issame, far)
    assert port_ijbc.tar_at_far_exact(scores, np.ones(4000, bool), far) == \
        ref_ijbc.tar_at_far_exact(scores, np.ones(4000, bool), far)

    embs, tids, mids, subjects = _ijbc_meta(rng)
    uids = np.unique(tids)
    i1, i2 = rng.integers(0, len(uids), 300), rng.integers(0, len(uids), 300)
    label = (uids[i1] // 10 == uids[i2] // 10).astype(np.int32)
    want = ref_ijbc.ijbc_11(embs, tids, mids, uids[i1], uids[i2], label, far_targets=far,
                            block=128)
    got = port_ijbc.ijbc_11(embs, tids, mids, uids[i1], uids[i2], label, far_targets=far,
                            block=128, device=CPU)
    for f in far:
        assert got.tar_at_far[f] == pytest.approx(want.tar_at_far[f], abs=1e-6)
    tpl, subj, tuids = port_ijbc.pool_meta(embs, tids, mids, subjects, device=CPU)
    wtpl, wsubj, wtuids = ref_ijbc.pool_meta(embs, tids, mids, subjects)
    np.testing.assert_allclose(tpl, wtpl, atol=1e-6)
    np.testing.assert_array_equal(subj, wsubj)
    np.testing.assert_array_equal(tuids, wtuids)


@pytest.mark.parametrize("gallery", ["float", "int8"])
def test_ijbc_1n_two_gallery_matches(rng, gallery):
    """G1/G2 disjoint subject splits; a third of the probe subjects are in
    neither (unmated). An int8 gallery goes through topk_matches_bank."""
    dim = 64
    centers = rng.normal(0, 1, (90, dim)).astype(np.float32)
    g1_subj, g2_subj = np.arange(0, 30), np.arange(30, 60)
    psubj = rng.integers(0, 90, 120)
    probes = (centers[psubj] + rng.normal(0, 2.5, (120, dim))).astype(np.float32)
    g1, g2 = centers[g1_subj], centers[g2_subj]
    if gallery == "int8":
        r1, r2 = ref_quantize_bank(g1, g1_subj), ref_quantize_bank(g2, g2_subj)
        p1, p2 = quantize_bank(g1, g1_subj).to_device(CPU), quantize_bank(g2, g2_subj).to_device(CPU)
    else:
        r1, r2, p1, p2 = g1, g2, g1, g2
    want = ref_ijbc.ijbc_1n_two_gallery(probes, psubj, r1, g1_subj, r2, g2_subj,
                                        fpir_targets=(0.05, 0.2), max_rank=10)
    got = port_ijbc.ijbc_1n_two_gallery(probes, psubj, p1, g1_subj, p2, g2_subj,
                                        fpir_targets=(0.05, 0.2), max_rank=10, device=CPU)
    for w, g in zip(want, got):
        assert g.rank1 == w.rank1
        np.testing.assert_array_equal(g.cmc, np.asarray(w.cmc))
        assert g.tpir_at_fpir == w.tpir_at_fpir
    assert 0.0 < got[0].rank1 < 1.0
    tensor_probes = port_ijbc.ijbc_1n(_t(probes), psubj, p1, g1_subj, max_rank=10,
                                      fpir_targets=(0.05, 0.2), device=CPU)
    assert tensor_probes.rank1 == got[1].rank1
