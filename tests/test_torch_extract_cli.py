"""The serving commands' port on the CPU: ``data.datasets`` (``load_image``,
``parse_list_file``), ``data.pipeline.embed_batches`` and
``eval.extract.extract_embeddings`` equal crfr's on PNG files written here
with PIL; ``python -m crfr_torch extract`` (float, ``--int8``,
``--quantize-bank``) and ``match`` (``--probe-npy`` and ``--ckpt --list``,
against ``.npy`` and ``.npz`` galleries, ``--int8``) print crfr's JSON
lines, ``match --probe-npy`` the same matches as crfr's own command, and
``match``'s top-k equals a direct ``topk_matches`` call. The int8 extract
stays within cosine 0.98 of the float one (crfr's bound,
tests/test_quant.py). The checkpoint: ``crfr_torch train`` for 2 steps of
IR-18 at 32 px in float32."""

import _torch_threads  # noqa: F401 (first: caps torch's threads per worker)
import json
import re

import numpy as np
import pytest
import torch
from PIL import Image

from crfr.cli import main as crfr_main
from crfr.data import datasets as ref_datasets
from crfr.data.pipeline import embed_batches as ref_embed_batches
from crfr.eval.extract import extract_embeddings as ref_extract_embeddings
from crfr_torch.cli import main
from crfr_torch.data.datasets import load_image, parse_list_file
from crfr_torch.data.pipeline import embed_batches
from crfr_torch.eval.extract import extract_embeddings
from crfr_torch.eval.identification import topk_matches
from tests.test_torch_sr_losses import one_thread  # noqa: F401 (autouse)
from tests.test_torch_train_cli import OVERRIDES

N_IMGS = 12
CLI = ["--preset", "casia_arcface", "--device", "cpu", "eval.batch_size=8"]


def _write_images(root, n, size=32, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        s = size if i % 3 else size + 8                  # some need the resize
        Image.fromarray(rng.integers(0, 256, (s, s, 3)).astype(np.uint8)).save(root / f"{i}.png")
        lines.append(f"{i}.png {i % 4}")
    (root / "list.txt").write_text("\n".join(lines) + "\n\n")
    return root / "list.txt"


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    return root, _write_images(root, N_IMGS)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    assert main(["train", "--preset", "casia_arcface", "--device", "cpu", *OVERRIDES,
                 f"train.checkpoint_dir={d}", "--max-steps", "2"]) == 0
    return d


def test_load_image_and_list_equal_crfr(images):
    root, lst = images
    paths, labels = parse_list_file(str(lst), str(root))
    want_paths, want_labels = ref_datasets.parse_list_file(str(lst), str(root))
    assert paths == want_paths and len(paths) == N_IMGS
    np.testing.assert_array_equal(labels, want_labels)
    for p in paths[:4]:
        for size in (None, 32):
            got, want = load_image(p, size), ref_datasets.load_image(p, size)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_load_image_names_pil_when_missing(images, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        load_image(str(images[0] / "0.png"))


@pytest.mark.parametrize("pad_to_full", [True, False])
def test_embed_batches_equal_crfr(images, pad_to_full):
    root, lst = images
    paths, _ = parse_list_file(str(lst), str(root))
    got = list(embed_batches(paths, 5, 32, pad_to_full=pad_to_full, num_threads=3))
    want = list(ref_embed_batches(paths, 5, 32, pad_to_full=pad_to_full, num_threads=3))
    assert [n for _, n in got] == [n for _, n in want] == [5, 5, 2]
    for (a, _), (b, _) in zip(got, want):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert list(embed_batches([], 5, 32)) == []


def test_extract_embeddings_equals_crfr(images):
    """The same deterministic numpy embedder through both: the batch size
    rule (12 paths → batches of 16, the last rows dropped) and the rows."""
    root, lst = images
    paths, _ = parse_list_file(str(lst), str(root))
    proj = np.random.default_rng(1).normal(size=(32 * 32 * 3, 16)).astype(np.float32)
    seen = []

    def fn(x):
        x = np.asarray(x, np.float32)
        seen.append(x.shape[0])
        return x.reshape(len(x), -1) / 255.0 @ proj

    got = extract_embeddings(paths, lambda x: torch.from_numpy(fn(x)), batch_size=256,
                             image_size=32)
    want = ref_extract_embeddings(paths, fn, batch_size=256, image_size=32)
    assert seen == [16, 16] and got.shape == (N_IMGS, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    seen.clear()
    got = extract_embeddings(paths, lambda x: torch.from_numpy(fn(x)), batch_size=8,
                             image_size=32)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert seen == [8, 8]


def _run(cli, capsys, *argv):
    assert cli(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_extract_float_int8_and_bank(ckpt, images, tmp_path, capsys):
    root, lst = images
    base = ["extract", "--ckpt", str(ckpt), "--list", str(lst), "--root", str(root), *CLI]
    out = _run(main, capsys, *base, "--out", str(tmp_path / "f.npy"))
    assert out == {"out": str(tmp_path / "f.npy"), "count": N_IMGS, "dim": 512}
    ef = np.load(tmp_path / "f.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "f_labels.npy"), np.arange(N_IMGS) % 4)
    assert ef.shape == (N_IMGS, 512) and np.isfinite(ef).all()

    out = _run(main, capsys, *base, "--out", str(tmp_path / "q.npy"), "--int8")
    assert set(out) == {"out", "count", "dim"}
    eq = np.load(tmp_path / "q.npy")
    cos = _cos(ef, eq)
    assert cos.min() > 0.98, cos
    assert not np.array_equal(ef, eq)

    out = _run(main, capsys, *base, "--out", str(tmp_path / "bank"), "--quantize-bank")
    assert out == {"out": str(tmp_path / "bank.npz"), "count": N_IMGS, "dim": 512,
                   "quantized_bank": True}
    from crfr_torch.eval.bank import load_bank, quantize_bank

    bank, want = load_bank(str(tmp_path / "bank.npz")), quantize_bank(ef, np.arange(N_IMGS) % 4)
    np.testing.assert_array_equal(bank.q, want.q)
    np.testing.assert_array_equal(bank.labels, want.labels)


def test_match_probe_npy_equals_crfr(tmp_path, capsys):
    """``match --probe-npy`` against a float .npy and an int8 .npz gallery:
    the port's JSON line equals crfr's command's, and ``--approx`` is
    accepted."""
    from crfr_torch.eval.bank import quantize_bank, save_bank

    rng = np.random.default_rng(2)
    g = rng.normal(size=(40, 64)).astype(np.float32)
    p = g[[3, 17, 29]] + 0.1 * rng.normal(size=(3, 64)).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    np.save(tmp_path / "p.npy", p)
    np.save(tmp_path / "gl.npy", np.arange(40) + 100)
    save_bank(str(tmp_path / "g.npz"), quantize_bank(g, np.arange(40) * 2))
    for gallery, extra in (("g.npy", []), ("g.npy", ["--gallery-labels-npy", "gl.npy"]),
                           ("g.npz", []), ("g.npz", ["--approx"])):
        argv = ["match", "--gallery-npy", str(tmp_path / gallery), "--probe-npy",
                str(tmp_path / "p.npy"), "--k", "3",
                *[str(tmp_path / a) if a.endswith(".npy") else a for a in extra]]
        got = _run(main, capsys, *argv, "--device", "cpu")
        want = _run(crfr_main, capsys, *argv)
        assert got == want, (gallery, extra)
        assert set(got) == {"matches", "k", "gallery"} and got["gallery"] == 40
        assert set(got["matches"][0]) == {"labels", "scores"}
        lab = np.arange(40) * 2 if gallery.endswith(".npz") else \
            (np.arange(40) + 100 if extra else np.arange(40))
        assert [m["labels"][0] for m in got["matches"]] == lab[[3, 17, 29]].tolist()


def test_match_images_int8_against_bank(ckpt, images, tmp_path, capsys):
    """``match --ckpt --list --int8`` against the ``--quantize-bank`` bank:
    the top-k equals ``topk_matches`` of ``extract --int8``'s embeddings on
    the same images (the same calibration, the same front end), and the
    float path against the float .npy as well."""
    from crfr_torch.eval.bank import load_bank

    root, lst = images
    ex = ["extract", "--ckpt", str(ckpt), "--list", str(lst), "--root", str(root), *CLI]
    _run(main, capsys, *ex, "--out", str(tmp_path / "bank"), "--quantize-bank")
    _run(main, capsys, *ex, "--out", str(tmp_path / "f.npy"))
    _run(main, capsys, *ex, "--out", str(tmp_path / "q.npy"), "--int8")
    bank = load_bank(str(tmp_path / "bank.npz"))
    m = ["match", "--ckpt", str(ckpt), "--list", str(lst), "--root", str(root), "--k", "4",
         *CLI]
    for gallery, flag, probes, g in (("bank.npz", ["--int8"], "q.npy", bank),
                                     ("f.npy", [], "f.npy", np.load(tmp_path / "f.npy"))):
        got = _run(main, capsys, *m, "--gallery-npy", str(tmp_path / gallery), *flag)
        labels = None if gallery.endswith(".npz") else np.arange(N_IMGS)
        s, lab = topk_matches(np.load(tmp_path / probes), g, labels, k=4, device="cpu")
        assert got["k"] == 4 and got["gallery"] == N_IMGS and len(got["matches"]) == N_IMGS
        assert [r["labels"] for r in got["matches"]] == lab.tolist()
        np.testing.assert_allclose([r["scores"] for r in got["matches"]], s, atol=1e-4)
    assert _cos(np.load(tmp_path / "q.npy"), np.load(tmp_path / "f.npy")).min() > 0.98


def test_int8_calibrates_on_crfrs_padded_batches(ckpt, images, monkeypatch):
    """``--int8`` calibrates on the batches crfr's ``_backbone_apply`` takes:
    up to two of ``embed_batches``' batches of the run's images, the zero
    rows that pad the last one included, through the same down-up operator
    and normalization; without images, one batch of 32 seeded noise images.
    Both stacks' ``calibrate`` give the same absmax per conv on them."""
    import argparse
    import types

    import jax.numpy as jnp
    from flax import nnx

    from crfr import cli as ref_cli
    from crfr.configs import get_config as ref_get_config
    from crfr.models import quant as ref_quant
    from crfr_torch import cli
    from crfr_torch.models import quant
    from tests.test_torch_irse import jax_backbone, torch_twin

    got, want = [], []
    real = quant.quantize_backbone

    def spy(backbone, calib, compute_dtype=None):
        got.append([c.numpy() for c in calib])
        return real(backbone, calib, compute_dtype)

    monkeypatch.setattr(quant, "quantize_backbone", spy)
    monkeypatch.setattr(ref_quant, "quantize_backbone",
                        lambda backbone, calib: want.append(list(calib)) or backbone)
    args = argparse.Namespace(ckpt=str(ckpt), preset="casia_arcface", device="cpu", int8=True)
    tr, cfg = cli._embed_fn_from_ckpt(args, ["eval.batch_size=8"])
    ref_cfg = ref_get_config("casia_arcface", ["model.input_size=32", "eval.batch_size=8",
                                               f"data.resize_mode={cfg.data.resize_mode}"])
    ref_tr = types.SimpleNamespace(model=types.SimpleNamespace(backbone=None))
    root, _ = images
    paths = [str(root / f"{i}.png") for i in range(N_IMGS)]
    for sample, low in ((paths, 8), (paths[:5], None), ((), None)):
        cli._backbone_apply(tr, cfg, args, sample, degrade_to=low)
        ref_cli._backbone_apply(ref_tr, ref_cfg, args, sample, degrade_to=low)
    assert [[c.shape for c in b] for b in got] == \
        [[(8, 32, 32, 3), (8, 32, 32, 3)], [(8, 32, 32, 3)], [(32, 32, 32, 3)]]
    assert [[c.shape for c in b] for b in want] == [[c.shape for c in b] for b in got]
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            np.testing.assert_allclose(gc, np.asarray(wc), rtol=0, atol=1e-5)
    pad = got[0][1][N_IMGS - 8:]                          # the last batch's 4 zero images
    np.testing.assert_allclose(pad, np.full_like(pad, pad.flat[0]), atol=1e-6)

    jm = jax_backbone()
    tm = torch_twin(jm)
    for g, w in zip(got, want):
        ref_amax = ref_quant.calibrate(nnx.clone(jm), [jnp.asarray(c) for c in w])
        amax = quant.calibrate(tm, g)
        assert len(amax) == len(ref_amax) == 21
        for path, v in ref_amax.items():
            name = re.sub(r"\[(\d+)\]", r".\1", path)
            assert amax[name] == pytest.approx(v, rel=1e-5), name


def test_match_needs_probes(tmp_path):
    np.save(tmp_path / "g.npy", np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="--probe-npy, or --ckpt"):
        main(["match", "--gallery-npy", str(tmp_path / "g.npy"), "--device", "cpu"])
