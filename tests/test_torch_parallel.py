"""crfr_torch.parallel and the sharded eval paths against crfr on the CPU.

crfr runs in this process on a (2, 2) or (4, 1) mesh over four of the eight
fake CPU devices that tests/conftest.py gives; the port runs as four gloo
ranks (tests/_torch_rank_worker.py, which imports no JAX), one process per
device, while crfr computes. Inputs are made with numpy from a seed. Each
multi-process case has its own time limit (``run_ranks``' ``timeout``),
past which its ranks are killed and the test fails.

- ``make_mesh``'s shapes, coordinates and errors; the mesh dispatch
  (``device.mesh_world``); ``process_shard`` over an (n, world) grid
  against crfr's with ``jax.process_index``/``process_count`` patched;
  ``pad_to_multiple``; ``maybe_initialize_distributed`` inert with no
  environment.
- ``topk_matches`` and ``topk_matches_bank`` (a host bank and a
  ``ServingBank``) over 203 gallery rows, which do not divide four: labels
  equal outside equal-score groups, scores within 1e-6, the same result on
  every rank.
- ``sharded_margin_ce``: the loss and its gradients with respect to emb
  and W against crfr's ``jax.grad`` within 1e-5, on (2, 2) with and
  without ``num_valid`` padding.
- ``make_extract_fn`` on the mesh: a batch that divides four is split (one
  preprocessing call of a quarter of it per rank), one that does not is
  embedded whole on every rank; both equal the one-process extract.
- ``SRTrainer`` on two ranks against one process on the same global
  batches.
"""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crfr.configs import MeshCfg as RefMeshCfg
from crfr.parallel import mesh as ref_mesh
from crfr.parallel import multihost as ref_mh
from crfr_torch.parallel import mesh as pm
from crfr_torch.parallel import multihost as mh
from tests._torch_rank_worker import run_ranks


def test_make_mesh_shapes_and_errors(tmp_path):
    """One process: no group, so (1, 1) is the single-device path (None)
    and a larger mesh raises as crfr's does on one device. Four ranks:
    (4, 1) by default, (2, 2) with rank r at divmod(r, 2), and a mesh
    larger or smaller than the world raises."""
    assert pm.make_mesh() is None and pm.make_mesh(pm.MeshCfg(1, 1)) is None
    with pytest.raises(ValueError) as port_err:
        pm.make_mesh(pm.MeshCfg(2, 1))
    with pytest.raises(ValueError) as ref_err:
        ref_mesh.make_mesh(RefMeshCfg(2, 1), devices=jax.devices()[:1])
    assert str(port_err.value) == str(ref_err.value)
    shapes = [(2, 2), (4, 1), (1, 4), (4, 2), (1, 2)]
    outs = run_ranks("mesh", 4, {"shapes": shapes}, tmp_path / "mesh", timeout=90)
    for r, out in enumerate(outs):
        assert out[None] == ((4, 1), (r, 0), ("data", "model"), 4)
        assert out[(2, 2)] == ((2, 2), divmod(r, 2), ("data", "model"), 4)
        assert out[(1, 4)][:2] == ((1, 4), (0, r))
        assert "needs 8 devices, have 4" in out[(4, 2)]
        assert "covers 2 of the 4 ranks" in out[(1, 2)]
        assert "process group of 3 ranks, this one has 4" in out["three"]
        assert out["one"] == 1
        # which slice of a global value each rank holds: rows over the whole
        # mesh in rank order, W's columns over model, the rest whole
        put = out["put"]
        x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
        w = torch.arange(12, dtype=torch.float32).reshape(2, 6)
        assert torch.equal(put["batch"], x[2 * r:2 * r + 2])
        assert torch.equal(put["class"], w[:, 3 * (r % 2):3 * (r % 2) + 3])
        assert torch.equal(put["replicated"], w) and torch.equal(put["local"], x[:2])
        assert torch.equal(put["shard_batch"]["x"], x[2 * r:2 * r + 2])
        assert torch.equal(put["shard_batch"]["y"][0], x[2 * r:2 * r + 2, 0])
        assert list(put["local_rows"]) == [2 * r, 2 * r + 1]
        assert put["maybe"] == [True, False]
    # crfr's device grid gives the same coordinates
    ref = ref_mesh.make_mesh(RefMeshCfg(2, 2), devices=jax.devices()[:4])
    flat = [d.id for d in ref.devices.reshape(-1)]
    for r in range(4):
        d, m = np.argwhere(np.vectorize(lambda x: x.id)(ref.devices) == flat[r])[0]
        assert (d, m) == divmod(r, 2)


def test_process_shard_matches_crfr(monkeypatch):
    for n in (0, 1, 7, 8, 13, 100, 1001):
        for world in (1, 2, 3, 4, 8):
            monkeypatch.setattr(jax, "process_count", lambda w=world: w)
            monkeypatch.setattr(mh, "process_count", lambda w=world: w)
            got = []
            for p in range(world):
                monkeypatch.setattr(jax, "process_index", lambda p=p: p)
                monkeypatch.setattr(mh, "process_index", lambda p=p: p)
                assert mh.process_shard(n) == ref_mh.process_shard(n), (n, world, p)
                got.append(mh.process_shard(n))
            assert got[0][0] == 0 and got[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_pad_to_multiple_and_inert_init(monkeypatch):
    for n in range(0, 40):
        for m in (1, 2, 3, 4, 8):
            assert pm.pad_to_multiple(n, m) == ref_mesh.pad_to_multiple(n, m)
    for var in ("CRFR_COORDINATOR", "CRFR_NUM_PROCESSES", "CRFR_PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mh.maybe_initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert mh.process_shard(10) == (0, 10) and mh.process_count() == 1
    # a partial launch description is no launch
    monkeypatch.setenv("CRFR_COORDINATOR", "localhost:1")
    monkeypatch.setenv("CRFR_NUM_PROCESSES", "2")
    assert mh.maybe_initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()


def _ties_equal(got_s, got_l, want_s, want_l, atol=1e-6):
    """Scores within atol; labels equal outside groups of equal scores."""
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=atol)
    for i in range(got_l.shape[0]):
        for j in range(got_l.shape[1]):
            tied = np.isclose(want_s[i], want_s[i, j], rtol=0, atol=1e-6).sum() > 1
            if not tied:
                assert got_l[i, j] == want_l[i, j], (i, j)


def test_sharded_topk_matches_crfr(tmp_path):
    """203 gallery rows over four ranks (51 + padding), k = 5, two
    identities planted twice so that some scores tie."""
    from crfr.eval.bank import quantize_bank, topk_matches_bank as ref_bank_topk
    from crfr.eval.identification import topk_matches as ref_topk

    rng = np.random.default_rng(0)
    g = rng.normal(size=(203, 64)).astype(np.float32)
    g[150] = g[10]                      # equal rows: tied scores
    labels = rng.permutation(1000)[:203].astype(np.int64)
    p = (g[rng.integers(0, 203, 12)] + rng.normal(0, 0.3, (12, 64))).astype(np.float32)
    inp = {"p": p, "g": g, "labels": labels, "k": 5, "block": 16}

    def ref():
        mesh = ref_mesh.make_mesh(RefMeshCfg(4, 1), devices=jax.devices()[:4])
        f = ref_topk(p, g, labels, k=5, block=16, mesh=mesh)
        q = ref_bank_topk(p, quantize_bank(g, labels), k=5, block=16, mesh=mesh)
        return f, q

    outs, ((fs, fl), (qs, ql)) = run_ranks("topk", 4, inp, tmp_path / "topk", wait=ref)
    for out in outs:
        _ties_equal(out["s"], out["l"], np.asarray(fs), np.asarray(fl))
        _ties_equal(out["qs"], out["ql"], np.asarray(qs), np.asarray(ql))
        _ties_equal(out["ss"], out["sl"], np.asarray(qs), np.asarray(ql))
        for key in ("s", "l", "qs", "ql"):
            np.testing.assert_array_equal(out[key], outs[0][key])


CE_KW = dict(margin_type="arcface", s=16.0, m=0.3, easy_margin=False)


def _ce_case(rng, shape, c, c_pad, b=8, d=16):
    emb = rng.normal(size=(b, d)).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int64)
    w = rng.normal(size=(d, c_pad)).astype(np.float32)
    return {"shape": shape, "emb": emb, "labels": labels, "w": w,
            "num_valid": c if c_pad != c else None, "kw": CE_KW}


def test_sharded_margin_ce_matches_jax_grad(tmp_path):
    from crfr.losses.arcface import sharded_margin_ce as ref_ce

    rng = np.random.default_rng(1)
    cases = [_ce_case(rng, (2, 2), 8, 8), _ce_case(rng, (2, 2), 7, 8)]

    def ref():
        res = []
        for c in cases:
            mesh = ref_mesh.make_mesh(RefMeshCfg(*c["shape"]), devices=jax.devices()[:4])
            fn = ref_ce(mesh, num_valid=c["num_valid"], **CE_KW)
            loss, grads = jax.value_and_grad(
                lambda e, w: fn(e, jnp.asarray(c["labels"], jnp.int32), w), argnums=(0, 1))(
                jnp.asarray(c["emb"]), jnp.asarray(c["w"]))
            res.append((float(loss), np.asarray(grads[0]), np.asarray(grads[1])))
        return res

    outs, want = run_ranks("ce", 4, {"cases": cases}, tmp_path / "ce", wait=ref)
    for out in outs:
        for got, (loss, g_emb, g_w) in zip(out["cases"], want):
            assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
            scale_e, scale_w = np.abs(g_emb).max(), np.abs(g_w).max()
            np.testing.assert_allclose(got["g_emb"].numpy(), g_emb, rtol=0, atol=1e-5 * scale_e)
            np.testing.assert_allclose(got["g_w"].numpy(), g_w, rtol=0, atol=1e-5 * scale_w)
    # the padding class takes no gradient
    assert float(outs[0]["cases"][1]["g_w"][:, 7].abs().max()) == 0.0


def test_split_extract_matches_one_process(tmp_path):
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.models.irse import build_backbone

    bb = build_backbone("ir_18", dropout=0.0, input_size=32, generator=torch.Generator()
                        .manual_seed(3)).eval()
    rng = np.random.default_rng(2)
    even = rng.integers(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    odd = rng.integers(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    outs = run_ranks("extract", 4, {"backbone": bb.state_dict(), "even": even, "odd": odd},
                     tmp_path / "extract")
    fn = make_extract_fn(lambda x: bb(x), degrade_to=16, image_size=32, device="cpu")
    want_even, want_odd = fn(even).numpy(), fn(odd).numpy()
    for out in outs:
        assert out["calls"] == [2, 6]          # a quarter of the even batch, all of the odd
        np.testing.assert_allclose(out["split"].numpy(), want_even, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["whole"].numpy(), want_odd, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(out["split"].numpy(), outs[0]["split"].numpy())


def test_sr_two_ranks_equal_one_rank(tmp_path):
    """SRTrainer on two ranks (G's and D's BN over the global batch, the
    gradients summed before Adam, R1, two D steps, landmarks' priors)
    against one process on the same global batches: losses within 1e-4
    relative; G, D and the EMA within tests/test_torch_sr_train.py's bound
    (rtol 2e-4 / atol 2e-5, but for Adam's ±lr sign flips, counted)."""
    from crfr_torch.train.sr_loop import SRTrainer
    from tests.test_torch_sr_losses import landmarks
    from tests.test_torch_sr_train import KW, assert_state_matches, batches, port_cfg

    one = SRTrainer(port_cfg(), device="cpu", **KW)
    init = {n: {k: v.clone() for k, v in getattr(one, n).state_dict().items()}
            for n in ("g", "d")}
    lm = landmarks(np.random.default_rng(7), 4, 32)
    data = [(x, lm) for x in batches(2)]
    outs = run_ranks("sr", 2, {"cfg": port_cfg(**{"mesh.data": 2}).to_dict(), "kw": KW,
                               "batches": data, **init}, tmp_path / "sr", timeout=120)
    want = [{k: float(v) for k, v in one.train_step(x, landmarks=m).items()} for x, m in data]
    want_ps = one.psnr_ssim(data[0][0])
    for out in outs:
        for mw, mg in zip(want, out["metrics"]):
            for k in ("g_loss", "d_loss"):
                assert abs(mg[k] - mw[k]) <= 1e-4 * abs(mw[k]), (k, want, out["metrics"])
        for k, v in want_ps.items():
            assert abs(out["psnr_ssim"][k] - v) <= 1e-4 * abs(v), (k, want_ps, out["psnr_ssim"])
        for n in ("g", "d", "g_ema"):
            assert_state_matches(getattr(one, n).state_dict(), out[n], 2)
    assert outs[0]["metrics"] == outs[1]["metrics"]


def test_parallel_imports_none_of_the_jax_stack():
    """The parallel package and the rank worker import neither JAX nor crfr."""
    import subprocess
    import sys

    code = ("import sys, crfr_torch.parallel, crfr_torch.parallel.multihost, "
            "tests._torch_rank_worker\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'crfr'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
