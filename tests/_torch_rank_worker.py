"""One rank of a crfr_torch multi-process case on the CPU (gloo), run as a
subprocess by tests/test_torch_parallel*.py (as tests/_mh_worker.py is for
crfr). Imports no JAX.

    python tests/_torch_rank_worker.py CASE RANK WORLD DIR

reads ``DIR/in.pt``, joins a gloo group through ``file://DIR/pg`` and writes
``DIR/out_RANK.pt``. ``run_ranks`` starts every rank and collects the
outputs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(case: str, world: int, inputs: dict, tmp, timeout: float = 120,
              wait=None) -> list[dict]:
    """Run ``case`` on ``world`` ranks; → each rank's output dict. ``wait``
    (a callable) runs while the ranks do, so the caller's own work (crfr's
    side of a comparison) overlaps theirs."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    torch.save(inputs, os.path.join(tmp, "in.pt"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                               str(world), tmp], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    extra = wait() if wait is not None else None
    deadline = time.time() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks {bad} failed:\n" + "\n".join(logs)[-6000:])
    outs = [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]
    return outs if wait is None else (outs, extra)


# ---------------------------------------------------------------------------
# Cases: each takes the inputs and returns this rank's output dict
# ---------------------------------------------------------------------------


def case_mesh(inp: dict) -> dict:
    """make_mesh's shapes, coordinates and errors; the mesh dispatch."""
    from crfr_torch.device import mesh_world
    from crfr_torch.parallel import mesh as pm

    out = {}
    for shape in [None, *inp["shapes"]]:
        try:
            mesh = pm.make_mesh(None if shape is None else pm.MeshCfg(*shape))
            out[shape] = (tuple(mesh.shape), pm.coords(mesh), mesh.mesh_dim_names,
                          mesh_world(mesh))
        except ValueError as e:
            out[shape] = str(e)
    mesh = pm.make_mesh(pm.MeshCfg(2, 2))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    w = np.arange(2 * 6, dtype=np.float32).reshape(2, 6)
    out["put"] = {
        "batch": pm.host_put(x, pm.batch_sharding(mesh), "cpu"),
        "class": pm.host_put(w, pm.class_sharding(mesh), "cpu"),
        "replicated": pm.host_put(w, pm.replicated(mesh), "cpu"),
        "local": pm.host_put_local(x[:2], pm.batch_sharding(mesh), "cpu"),
        "shard_batch": pm.shard_batch({"x": x, "y": [x[:, 0]]}, mesh, "cpu"),
        "local_rows": pm.local_rows(mesh, list(range(8))),
        "maybe": [pm.maybe_shard_batch(mesh, x)[1], pm.maybe_shard_batch(mesh, x[:6])[1]]}
    for name, mesh in (("three", type("M", (), {"size": lambda self: 3})()),
                       ("one", type("M", (), {"size": lambda self: 1})())):
        try:
            out[name] = mesh_world(mesh)
        except ValueError as e:
            out[name] = str(e)
    return out


def case_topk(inp: dict) -> dict:
    from crfr_torch.eval.bank import ServingBank, quantize_bank, topk_matches_bank
    from crfr_torch.eval.identification import topk_matches
    from crfr_torch.parallel import make_mesh

    mesh = make_mesh()
    p, g, lbl, k = inp["p"], inp["g"], inp["labels"], inp["k"]
    s, lab = topk_matches(p, g, lbl, k=k, block=inp["block"], mesh=mesh, device="cpu")
    bank = quantize_bank(g, lbl)
    qs, ql = topk_matches_bank(p, bank, k=k, block=inp["block"], mesh=mesh, device="cpu")
    serving = ServingBank.from_bank(bank, device="cpu")
    ss, sl = topk_matches_bank(p, serving, k=k, mesh=mesh, device="cpu")
    return {"s": s, "l": lab, "qs": qs, "ql": ql, "ss": ss, "sl": sl}


def case_ce(inp: dict) -> dict:
    """For each case: this rank's rows and W shard through the
    class-sharded CE; the gradients of emb (every rank's rows) and W
    (summed over the data group, gathered over the model group) rebuilt
    whole."""
    import torch.distributed as dist

    from crfr_torch.losses.arcface import sharded_margin_ce
    from crfr_torch.parallel import mesh as pm

    out = []
    for c in inp["cases"]:
        mesh = pm.make_mesh(pm.MeshCfg(*c["shape"]))
        T = torch.from_numpy
        emb = pm.batch_sharding(mesh).local(T(c["emb"])).clone().requires_grad_(True)
        labels = pm.batch_sharding(mesh).local(T(c["labels"]))
        w = pm.class_sharding(mesh).local(T(c["w"])).clone().requires_grad_(True)
        fn = sharded_margin_ce(mesh, num_valid=c["num_valid"], **c["kw"])
        share = fn(emb, labels, w)
        share.backward()
        loss = share.detach().clone()
        dist.all_reduce(loss)
        gw = w.grad.clone()
        if c["shape"][0] > 1:
            dist.all_reduce(gw, group=mesh.get_group("data"))
        gw = torch.cat(_gather(gw, mesh.get_group("model")), dim=1)
        out.append({"loss": loss, "g_emb": torch.cat(_gather(emb.grad, None)), "g_w": gw})
    return {"cases": out}


def _gather(x, group):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _load_start(tr, start: dict) -> None:
    """Start ``tr`` from a whole state_dict (W whole)."""
    st = tr.state
    st["model"] = start
    tr.state = st


def case_train(inp: dict) -> dict:
    """``steps`` Trainer steps on the given global batches and lows; the
    per-step metrics and the state after them (W whole)."""
    from crfr_torch.configs import Config
    from crfr_torch.models.convert import train_state_from_jax
    from crfr_torch.parallel.mesh import class_sharding
    from crfr_torch.train.loop import Trainer

    tr = Trainer(Config.from_dict(inp["cfg"]), steps_per_epoch=100, device="cpu")
    # crfr's state on its mesh: this rank's class shard of W
    tr.model.load_state_dict(train_state_from_jax(inp["flat"], shard=class_sharding(tr.mesh)))
    metrics = []
    for imgs, labels, lows in inp["batches"]:
        m = tr.train_step(imgs, labels, lows=lows)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": tr.state["model"], "ce_impl": tr._ce_impl,
            "w_local": tuple(tr.model.head.weight.shape)}


def case_distill(inp: dict) -> dict:
    """One DistillTrainer step per bicubic path from the given student and
    teacher weights; the metrics and the student after it. Then
    ``student_embed_fn`` with and without ``local_snapshot`` on a batch."""
    from crfr_torch.configs import Config
    from crfr_torch.models.irse import build_backbone
    from crfr_torch.train.distill_loop import DistillTrainer, teacher_from_state

    out = {}
    for name, cfg_d, start, lows, kw in inp["paths"]:
        cfg = Config.from_dict(cfg_d)
        mc = cfg.model
        bb = build_backbone(mc.backbone, embedding_dim=mc.embedding_dim, dropout=0.0,
                            input_size=mc.input_size)
        bb.load_state_dict(inp["teacher"])
        st = DistillTrainer(cfg, teacher_from_state(bb), steps_per_epoch=100, device="cpu",
                            **kw)
        _load_start(st, start)
        imgs, labels = inp["batch"]
        m = st.train_step(imgs, labels, lows=lows)
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "state": st.state["model"]}
        if name == inp["embed_path"]:
            x = inp["embed_images"]
            out["embed"] = {f"{res}_{snap}": st.student_embed_fn(
                with_residual=res, local_snapshot=snap)(x)
                for res in (False, True) for snap in (False, True)}
    return out


def case_extract(inp: dict) -> dict:
    """make_extract_fn with the mesh on a batch that divides the world and
    one that does not, counting preprocessing calls on this rank."""
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.models.irse import build_backbone
    from crfr_torch.ops import fused_preprocess as fp
    from crfr_torch.parallel import make_mesh

    bb = build_backbone("ir_18", dropout=0.0, input_size=32).eval()
    bb.load_state_dict(inp["backbone"])
    calls = []
    real = fp.fused_degrade_normalize
    import crfr_torch.eval.extract as ex

    def counted(x, *a, **kw):
        calls.append(int(x.shape[0]))
        return real(x, *a, **kw)

    ex.fused_degrade_normalize = counted
    fn = make_extract_fn(lambda x: bb(x), degrade_to=16, image_size=32, mesh=make_mesh(),
                         device="cpu")
    return {"split": fn(inp["even"]), "whole": fn(inp["odd"]), "calls": calls}


def case_preset(inp: dict) -> dict:
    """One step of a preset (with overrides) on its own mesh."""
    from crfr_torch.configs import get_config
    from crfr_torch.data.synthetic import SyntheticFaces
    from crfr_torch.train.loop import Trainer

    cfg = get_config(inp["preset"], inp["ov"])
    tr = Trainer(cfg, device="cpu")
    imgs, labels = SyntheticFaces(num_classes=8, image_size=cfg.data.image_size).sample(
        np.random.default_rng(0), cfg.train.batch_size)
    m = tr.train_step(imgs, labels.astype(np.int64) * 10_000)
    return {"loss": float(m["loss"]), "mesh": tuple(tr.mesh.shape), "ce": tr._ce_impl,
            "w_local": tuple(tr.model.head.weight.shape)}


def case_train_ckpt(inp: dict) -> dict:
    """Two steps on a mesh, then a checkpoint written by rank 0."""
    from crfr_torch.configs import Config
    from crfr_torch.train.checkpoints import Checkpointer
    from crfr_torch.train.loop import Trainer

    cfg = Config.from_dict(inp["cfg"])
    tr = Trainer(cfg, steps_per_epoch=100, device="cpu")
    for imgs, labels in inp["batches"]:
        tr.train_step(imgs, labels)
    ck = Checkpointer(inp["dir"], keep=2)
    st = tr.state
    written = ck.save(tr.host_step, st, cfg.to_json())
    emb = tr.embed_fn()(inp["probe"])
    return {"written": written, "state": st["model"], "emb": emb,
            "w_local": tuple(tr.model.head.weight.shape)}


def case_sr(inp: dict) -> dict:
    """SRTrainer steps on the global batches from the given G and D."""
    from crfr_torch.configs import Config
    from crfr_torch.train.sr_loop import SRTrainer

    tr = SRTrainer(Config.from_dict(inp["cfg"]), device="cpu", **inp["kw"])
    tr.g.load_state_dict(inp["g"])
    tr.d.load_state_dict(inp["d"])
    tr.g_ema.load_state_dict(inp["g"])
    metrics = [{k: float(v) for k, v in tr.train_step(x, landmarks=lm).items()}
               for x, lm in inp["batches"]]
    return {"metrics": metrics, "psnr_ssim": tr.psnr_ssim(inp["batches"][0][0]),
            **{n: getattr(tr, n).state_dict() for n in ("g", "d", "g_ema")}}


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main() -> int:
    case, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch.distributed as dist

    torch.set_num_threads(1)
    inp = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'pg')}",
                            rank=rank, world_size=world)
    try:
        out = CASES[case](inp)
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
