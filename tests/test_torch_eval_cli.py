"""The evaluation commands of the port on the CPU against crfr's own.

``--probe-npy`` modes: ``eval-openset`` and ``eval-ijbc --probe-tpl-npy``
print crfr's JSON on the same ``.npy`` files. Image modes: one face.evoLVe
state dict (crfr's ``export_face_evolve_state_dict`` of a seeded IR-18 at
32 px with drawn BN statistics) goes into both stacks through each
package's ``import-torch``; then ``eval-verification`` (bicubic probes),
``eval-scface``, ``eval-openset``, ``eval-bin`` and ``eval-ijbc`` run on the
same rendered faces (``data.render``) written as PNG/JPEG files, and give
crfr's accuracy, rank-1 and CMC exactly and its other numbers within 1e-4.
``eval-verification --sr-ckpt`` (G at init) runs through the hallucinated
probe path. Missing inputs raise."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from flax import nnx

from crfr.cli import main as ref_main
from crfr.data.bins import save_bin
from crfr.models.irse import IRBackbone as RefIRBackbone
from crfr.train.torch_import import export_face_evolve_state_dict
from crfr_torch.cli import main
from crfr_torch.data.render import RenderedIdentities
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)

S, IDS = 32, 8
OV = ["mesh.data=1", "model.backbone=ir_18", "model.compute_dtype=float32", "model.dropout=0.0",
      f"data.image_size={S}", f"model.input_size={S}", f"data.num_classes={IDS}",
      "eval.batch_size=16", "eval.n_folds=4"]
EXACT = ("accuracy", "rank1", "rank1_g1", "rank1_g2", "cmc")


def _json(cli, capsys, *argv) -> dict:
    assert cli(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _same(got, want, key=""):
    """Equal keys; the EXACT fields equal, other numbers within 1e-4."""
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _same(got[k], want[k], k if key not in EXACT else key)
    elif isinstance(want, list):
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            _same(g, w, key)
    elif key in EXACT:
        assert got == want, key
    else:
        assert got == pytest.approx(want, abs=1e-4), key


@pytest.fixture(scope="module")
def protocols(tmp_path_factory):
    """Rendered faces as each protocol's files, and one face.evoLVe dict
    imported into a crfr and a port checkpoint."""
    d = tmp_path_factory.mktemp("protocols")
    rng = np.random.default_rng(0)
    ren = RenderedIdentities(IDS, image_size=S, seed=1)

    def face(i):
        return np.clip(np.rint(ren.render(i, rng)), 0, 255).astype(np.uint8)

    def save(rel, img):
        p = d / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(p)
        return str(p)

    for i in range(IDS):
        for j in (1, 2, 3):
            save(f"lfw/p{i}/p{i}_{j:04d}.jpg", face(i))
    same = [f"p{i} 1 {j}" for i in range(IDS) for j in (2, 3)]
    diff = [f"p{i} 1 p{(i + k) % IDS} {k + 1}" for i in range(IDS) for k in (1, 2)]
    (d / "pairs.txt").write_text("\n".join(["4 8", *[v for p in zip(same, diff) for v in p]]))
    for i in range(IDS):
        save(f"sc_g/{i:03d}_frontal.png", face(i))
        for cam in (1, 2):
            save(f"sc_p/{i:03d}_cam{cam}_1.png", face(i))
    lists = {"g": [], "m": [], "u": []}
    for i in range(IDS):
        lists["g" if i < 6 else "u"].append(f"{save(f'os/g{i}.png', face(i))} {i}")
        lists["m" if i < 6 else "u"].append(f"{save(f'os/p{i}.png', face(i))} {i}")
    for k, v in lists.items():
        (d / f"os_{k}.txt").write_text("\n".join(v) + "\n")
    i1, i2, issame = ren.eval_pairs(rng, 8)
    u8 = lambda a: np.clip(np.rint(a), 0, 255).astype(np.uint8)  # noqa: E731
    save_bin(str(d / "pairs.bin"), u8(i1), u8(i2), issame)
    meta, tid = [], 0
    for s in range(4):
        for _ in range(2):
            for m in range(2):
                meta.append(f"{save(f'ijbc/t{tid}_{m}.png', face(s))} {tid} {10 * tid + m} {s}")
            tid += 1
    (d / "meta.txt").write_text("\n".join(meta) + "\n")
    (d / "ijbc_pairs.txt").write_text("\n".join(f"{2 * s} {2 * s + 1} 1\n{2 * s} "
                                                f"{(2 * s + 3) % 8} 0" for s in range(4)))
    (d / "probe.txt").write_text("\n".join(meta[0::4]) + "\n")
    (d / "g1.txt").write_text("\n".join(meta[1::4][:2] + meta[2::4][2:]) + "\n")
    (d / "g2.txt").write_text("\n".join(meta[2::4][:2] + meta[1::4][2:]) + "\n")

    jm = RefIRBackbone(depth="18", input_size=S, dtype=jnp.float32, rngs=nnx.Rngs(3))
    g = np.random.default_rng(3)
    for _, mod in nnx.iter_graph(jm):
        if isinstance(mod, nnx.BatchNorm):
            n = mod.mean.value.shape[0]
            mod.mean.value = jnp.asarray(g.normal(0, 0.2, n), jnp.float32)
            mod.var.value = jnp.asarray(g.uniform(0.5, 2.0, n), jnp.float32)
    sd = {k: torch.from_numpy(v.copy()) for k, v in export_face_evolve_state_dict(jm).items()}
    torch.save(sd, d / "evolve.pth")
    assert ref_main(["import-torch", "--torch-ckpt", str(d / "evolve.pth"), "--out",
                     str(d / "ref_ck"), "--preset", "casia_arcface", *OV]) == 0
    assert main(["import-torch", "--torch-ckpt", str(d / "evolve.pth"), "--out",
                 str(d / "ck"), "--device", "cpu", *OV]) == 0
    return d


def _both(capsys, d, *argv):
    """(port's JSON, crfr's JSON) of one eval command on the two imports."""
    got = _json(main, capsys, *argv, "--ckpt", str(d / "ck"), "--device", "cpu")
    want = _json(ref_main, capsys, *argv, "--ckpt", str(d / "ref_ck"))
    return got, want


@pytest.mark.parametrize("side", ["second", "both"])
def test_eval_verification_equals_crfr(protocols, capsys, side):
    d = protocols
    got, want = _both(capsys, d, "eval-verification", "--pairs", str(d / "pairs.txt"),
                      "--lfw-root", str(d / "lfw"), "--degrade", "8", "--degrade-side", side)
    _same(got, want)
    assert set(got) == {"accuracy", "std", "eer", "tar_at_far"}


def test_eval_scface_equals_crfr(protocols, capsys):
    d = protocols
    got, want = _both(capsys, d, "eval-scface", "--gallery", str(d / "sc_g"),
                      "--probes", str(d / "sc_p"), "--distance", "1")
    _same(got, want)
    assert len(got["cmc"]) == 20


def test_eval_openset_images_equal_crfr(protocols, capsys):
    d = protocols
    got, want = _both(capsys, d, "eval-openset", "--gallery-list", str(d / "os_g.txt"),
                      "--mated-list", str(d / "os_m.txt"), "--unmated-list", str(d / "os_u.txt"),
                      "--degrade", "8", "--max-rank", "5")
    _same(got, want)
    assert len(got["cmc"]) == 5 and set(got["tpir_at_fpir"]) == {"0.01", "0.1"}


def test_eval_bin_equals_crfr(protocols, capsys):
    d = protocols
    got, want = _both(capsys, d, "eval-bin", "--bin", str(d / "pairs.bin"), "--degrade", "8")
    _same(got, want)


def test_eval_ijbc_images_equal_crfr(protocols, capsys):
    d = protocols
    got, want = _both(capsys, d, "eval-ijbc", "--meta", str(d / "meta.txt"),
                      "--pairs", str(d / "ijbc_pairs.txt"), "--probe-meta", str(d / "probe.txt"),
                      "--gallery-g1", str(d / "g1.txt"), "--gallery-g2", str(d / "g2.txt"))
    _same(got, want)
    assert len(got["tar_at_far"]) == 6 and len(got["cmc"]) == 20


def test_eval_verification_through_the_hallucinator(protocols, capsys, tmp_path):
    """``--sr-ckpt`` of G at init (scale 4, so 8 px probes): the probe side
    goes down to 8 px through kernel 2's plain version and back up
    through G; at init that is bicubic, so the result is the bicubic run's
    within the float error of the two paths."""
    from crfr_torch.configs import get_config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.sr_loop import SRTrainer

    d = protocols
    sr = SRTrainer(get_config("casia_arcface", OV), scale=4, n_priors=16, device="cpu")
    Checkpointer(str(tmp_path / "sr")).save(0, sr.state_dict(), force=True)
    args = ["eval-verification", "--pairs", str(d / "pairs.txt"), "--lfw-root", str(d / "lfw"),
            "--ckpt", str(d / "ck"), "--device", "cpu"]
    got = _json(main, capsys, *args, "--sr-ckpt", str(tmp_path / "sr"), "--sr-scale", "4")
    want = _json(main, capsys, *args, "--degrade", "8")
    assert got["accuracy"] == want["accuracy"]
    assert got["eer"] == pytest.approx(want["eer"], abs=1e-3)


def test_probe_npy_modes_equal_crfr(tmp_path, capsys):
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(60, 64)).astype(np.float32)
    files = {"g": emb[:40], "gl": np.arange(40),
             "p": emb[:20] + 0.4 * rng.normal(size=(20, 64)).astype(np.float32),
             "pl": np.r_[np.arange(10), np.arange(100, 110)],
             "mated": np.r_[np.ones(10, bool), np.zeros(10, bool)],
             "ptpl": emb[:12], "psub": np.arange(12), "g1tpl": emb[:8], "g1sub": np.arange(8),
             "g2tpl": emb[4:12], "g2sub": np.arange(4, 12)}
    for k, v in files.items():
        np.save(tmp_path / f"{k}.npy", v)
    f = {k: str(tmp_path / f"{k}.npy") for k in files}
    openset = ["eval-openset", "--probe-npy", f["p"], "--probe-labels-npy", f["pl"],
               "--gallery-npy", f["g"], "--gallery-labels-npy", f["gl"], "--mated-npy",
               f["mated"], "--max-rank", "10"]
    ijbc = ["eval-ijbc", "--probe-tpl-npy", f["ptpl"], "--probe-subjects-npy", f["psub"],
            "--g1-tpl-npy", f["g1tpl"], "--g1-subjects-npy", f["g1sub"],
            "--g2-tpl-npy", f["g2tpl"], "--g2-subjects-npy", f["g2sub"]]
    for argv in (openset, ijbc):
        got = _json(main, capsys, *argv, "--device", "cpu")
        want = _json(ref_main, capsys, *argv)
        assert got == want, argv[0]
    # a bank as the gallery: its own labels
    from crfr_torch.eval.bank import quantize_bank, save_bank

    save_bank(str(tmp_path / "bank.npz"), quantize_bank(emb[:40], np.arange(40)))
    got = _json(main, capsys, *openset[:5], "--gallery-npy", str(tmp_path / "bank.npz"),
                "--mated-npy", f["mated"], "--device", "cpu")
    assert 0.0 <= got["rank1"] <= 1.0


def test_missing_inputs_raise(tmp_path, capsys):
    with pytest.raises(ValueError, match="--gallery-npy"):
        main(["eval-openset", "--probe-npy", "p.npy", "--device", "cpu"])
    with pytest.raises(ValueError, match="--ckpt"):
        main(["eval-openset", "--gallery-list", "g.txt", "--device", "cpu"])
    with pytest.raises(ValueError, match="--ckpt"):
        main(["eval-ijbc", "--device", "cpu"])
