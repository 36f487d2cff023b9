"""crfr_torch.eval.verification against crfr.eval.verification on shared
distances: fold accuracies and best thresholds identical, TAR@FAR within
1e-6, EER equal. Includes distances on a coarse grid, which gives long flat
plateaus in the train FAR curve and ties in train accuracy."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crfr.eval import verification as ref
from crfr_torch.eval import verification as port

FAR_TARGETS = (1e-3, 1e-2, 0.1)


def _pairs(kind, n, seed):
    rng = np.random.default_rng(seed)
    issame = rng.random(n) < 0.5
    if kind == "overlap":
        dist = np.where(issame, rng.normal(0.8, 0.3, n), rng.normal(1.3, 0.3, n))
    elif kind == "plateau":          # coarse grid: many exact ties
        dist = np.where(issame, rng.integers(2, 12, n), rng.integers(8, 20, n)) * 0.1
    else:                            # "separated": a wide gap between classes
        dist = np.where(issame, rng.uniform(0.1, 0.5, n), rng.uniform(1.5, 2.0, n))
    return np.clip(dist, 0.0, 4.0).astype(np.float32), issame


def _ref_protocol(dist, issame, n_folds):
    masks = jnp.asarray(ref._fold_masks(len(dist), n_folds))
    out = ref._protocol(jnp.asarray(dist), jnp.asarray(issame), masks,
                        jnp.asarray(FAR_TARGETS, jnp.float32), n_folds=n_folds)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("kind,n,n_folds", [("overlap", 600, 10), ("plateau", 500, 10),
                                            ("separated", 303, 7)])
def test_protocol_matches_on_shared_distances(kind, n, n_folds):
    dist, issame = _pairs(kind, n, seed=n)
    fa, thr, tar, far_r = _ref_protocol(dist, issame, n_folds)
    masks = torch.from_numpy(port._fold_masks(n, n_folds))
    got = port._protocol(torch.from_numpy(dist), torch.from_numpy(issame), masks,
                         torch.tensor(FAR_TARGETS))
    g_fa, g_thr, g_tar, g_far = (t.numpy() for t in got)
    np.testing.assert_array_equal(g_fa, fa)
    np.testing.assert_array_equal(g_thr, thr)
    np.testing.assert_allclose(g_tar, tar, atol=1e-6, rtol=0)
    np.testing.assert_allclose(g_far, far_r, atol=1e-6, rtol=0)

    res = port.evaluate_distances(dist, issame, n_folds, FAR_TARGETS, device="cpu")
    assert res.eer == ref.compute_eer(dist, issame)
    np.testing.assert_array_equal(res.fold_accuracies, fa)


def test_plateau_case_has_ties():
    """The plateau case really has flat FAR stretches and accuracy ties."""
    dist, issame = _pairs("plateau", 500, seed=500)
    thresholds = port._thresholds(400)
    far = np.array([np.mean(dist[~issame] < t) for t in thresholds])
    acc = np.array([np.mean((dist < t) == issame) for t in thresholds])
    assert np.sum(np.diff(far) == 0) > 300
    assert np.sum(acc == acc.max()) > 1


def test_thresholds_equal_jnp_linspace():
    assert np.array_equal(port._thresholds(400),
                          np.asarray(jnp.linspace(0.0, 4.0, 400)))


@pytest.mark.parametrize("case", ["random", "plateaus"])
def test_interp_matches_jnp_interp(case):
    rng = np.random.default_rng(3)
    if case == "random":
        xp = np.sort(rng.uniform(0, 1, 50)).astype(np.float32)
    else:                            # repeated knots: zero-width intervals
        xp = np.repeat(np.linspace(0, 1, 10, dtype=np.float32), 5)
    fp = rng.uniform(-2, 2, xp.shape).astype(np.float32)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 40), xp[::3]]).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = port.interp(torch.from_numpy(x)[None], torch.from_numpy(xp)[None],
                      torch.from_numpy(fp)[None])[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_evaluate_verification_matches_on_embeddings():
    rng = np.random.default_rng(9)
    e1 = rng.normal(0, 1, (240, 32)).astype(np.float32)
    issame = rng.random(240) < 0.5
    e2 = np.where(issame[:, None], e1 + rng.normal(0, 1.0, e1.shape),
                  rng.normal(0, 1, e1.shape)).astype(np.float32)
    want = ref.evaluate_verification(e1, e2, issame, n_folds=10)
    got = port.evaluate_verification(e1, e2, issame, n_folds=10, device="cpu")
    np.testing.assert_array_equal(got.fold_accuracies, want.fold_accuracies)
    np.testing.assert_array_equal(got.best_thresholds, want.best_thresholds)
    assert got.accuracy_mean == want.accuracy_mean
    assert got.eer == pytest.approx(want.eer, abs=1e-6)
    for k, v in want.tar_at_far.items():
        assert got.tar_at_far[k] == pytest.approx(v, abs=1e-6)


def test_pair_distances_and_flip_fusion():
    rng = np.random.default_rng(4)
    a, b = (rng.normal(0, 1, (16, 8)).astype(np.float32) for _ in range(2))
    a[0] = 0.0                                   # zero row: norm clip at 1e-12
    want = np.asarray(ref.pair_distances(jnp.asarray(a), jnp.asarray(b)))
    got = port.pair_distances(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for mode in ("sum", "concat"):
        np.testing.assert_array_equal(
            port.fuse_flip_features(torch.from_numpy(a), torch.from_numpy(b), mode).numpy(),
            np.asarray(ref.fuse_flip_features(jnp.asarray(a), jnp.asarray(b), mode)))
    with pytest.raises(ValueError, match="unknown flip fusion"):
        port.fuse_flip_features(torch.from_numpy(a), torch.from_numpy(b), "max")
