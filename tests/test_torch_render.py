"""The port's copy of the procedural renderer against crfr/data/render.py:
the same seed gives the same identities, images, landmarks, labels and
verification pairs, array for array (exactly), at hard=0 and at hard=0.5
(occluders, blur and the JPEG round trip); without PIL the JPEG nuisance
raises an error that names it."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import sys

import numpy as np
import pytest

from crfr.data.render import RenderedIdentities as RefRendered
from crfr_torch.data.render import RenderedIdentities


@pytest.mark.parametrize("hard", [0.0, 0.5])
def test_renderer_equals_crfr(hard):
    ref, port = (R(12, 48, seed=3, hard=hard) for R in (RefRendered, RenderedIdentities))
    for k, v in ref.geom.items():
        np.testing.assert_array_equal(port.geom[k], v, err_msg=k)
    np.testing.assert_array_equal(port.texture, ref.texture)

    a, b = np.random.default_rng(5), np.random.default_rng(5)
    ids = np.array([0, 3, 3, 11, 7, 1, 0, 5])
    (ri, rl), (pi, pl) = (r.sample_for_ids(g, ids, return_landmarks=True)
                          for r, g in ((ref, a), (port, b)))
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pl, rl)
    assert pi.shape == (8, 48, 48, 3) and pi.dtype == np.float32 and pl.shape == (8, 5, 2)

    for (ri, rl), (pi, pl) in zip(ref.batches(6, 2, seed=9), port.batches(6, 2, seed=9)):
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pl, rl)

    want = ref.eval_pairs(np.random.default_rng(2), 10, id_range=(4, 12))
    got = port.eval_pairs(np.random.default_rng(2), 10, id_range=(4, 12))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2][0::2].all() and not got[2][1::2].any()          # interleaved


def test_many_identities_render_lazily_and_equally():
    """Above 4,096 identities the textures are upsampled per render, with
    the same values."""
    ref, port = (R(4100, 32, seed=1) for R in (RefRendered, RenderedIdentities))
    assert port.texture is None and port._tex_fine.shape == (4100, 24, 24)
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    np.testing.assert_array_equal(port.sample_for_ids(b, [4099, 7]),
                                  ref.sample_for_ids(a, [4099, 7]))


def test_jpeg_nuisance_without_pil_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    r = RenderedIdentities(2, 32, seed=0, hard=1.0)
    with pytest.raises(ImportError, match="PIL"):
        for seed in range(50):
            r.render(0, np.random.default_rng(seed))
