#!/usr/bin/env python3
"""Smoke run of crfr_torch on one CUDA card: kernels, embed, verify, serve.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card, its power limit (nvidia-smi), and the kernel build time;
2. kernels: every CUDA kernel of the embed path, built from the sources in
   this checkout, held against its plain PyTorch version (TF32 off) and a
   float64 product at the main path's shapes, and timed beside its bound,
   the plain version and one library call (``torch.einsum``) as yardstick.
   The bound counts the flops the function needs through its banded
   factors (``needed_flops``), not the dense products the kernel does;
3. embed: the main path, ``build_embed_pipeline("ir_50")`` at B=256 on
   random uint8 images (IR-50 in bf16, weights from seed 0), with the
   launch counters reset just before one call and read just after; its
   output is checked against a float32 plain-path run, then timed;
4. verify: ``make_extract_fn`` on HR images and their 16 px probes, then the
   10-fold protocol on the card, which must equal the same protocol run on
   CPU tensors for the same distances;
5. serve: ``make_server`` with ``build_serving_fn(degrade_to=16)`` at static
   batch 64, three concurrent ``/embed`` requests and ``/healthz``.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises and the exit code is
not 0. Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
B, S, LOW = 256, 112, 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(in_bytes: int, out_bytes: int, flops: int) -> tuple[float, str]:
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def needed_flops(which: str, b: int, c: int, h: int, w: int, arg, mode: str) -> int:
    """Flops the function needs on these shapes: each operator applied
    through its banded bicubic factors, counting only their nonzero taps
    (a sparse (m, k) by dense (k, n) product is 2 * nnz * n flops). The
    degrade operator is up(S x low) . down(low x S), so it goes down then
    up along each axis; a resize takes the cheaper of its two pass orders."""
    from crfr_torch.ops.bicubic import resize_matrix

    def nnz(m) -> int:
        return int(np.count_nonzero(m))

    if which == "fused_degrade_normalize":
        down, up = nnz(resize_matrix(h, arg, mode)), nnz(resize_matrix(arg, h, mode))
        per_plane = 2 * (down * w + arg * down + up * arg + h * up)
    else:
        (oh, ow), wr, wc = arg, nnz(resize_matrix(h, arg[0], mode)), nnz(resize_matrix(w, arg[1], mode))
        per_plane = 2 * min(wr * w + oh * wc, h * wc + wr * ow)
    return b * c * per_plane


def kernel_case(fp, which: str, x: torch.Tensor, arg, mode: str, out_dtype: torch.dtype,
                timed: bool) -> dict:
    """Kernel vs plain version vs float64 on ``x``; times when ``timed``."""
    from crfr_torch.ops.fused_preprocess import _operators

    kern = getattr(fp, which)
    plain = getattr(fp, which + "_reference")
    b, h, w, c = x.shape
    oh, ow = (h, w) if which == "fused_degrade_normalize" else arg
    key = (("degrade", h, w, arg, mode) if which == "fused_degrade_normalize"
           else ("resize", h, w, oh, ow, mode))
    got = kern(x, arg, mode, out_dtype)
    want = plain(x, arg, mode, out_dtype)
    wr, wc = (m.double() for m in _operators(key, x.device))
    exact = (wr @ x.double().permute(0, 3, 1, 2) @ wc.t() - 127.5) / 128.0
    exact = exact.permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    err64 = (got.double() - exact).abs().max().item()
    tol = 1e-4 if out_dtype == torch.float32 else 2e-2
    tol64 = 2e-3 if out_dtype == torch.float32 else 2e-2
    if got.shape != want.shape or got.dtype != out_dtype or not got.is_contiguous():
        raise AssertionError(f"{which}: bad output {got.shape} {got.dtype}")
    if not (err <= tol and err64 <= tol64):
        raise AssertionError(f"{which} {mode} {x.dtype}->{out_dtype}: max_abs_err "
                             f"{err} (tol {tol}), vs float64 {err64} (tol {tol64})")
    case = {"in": str(x.dtype).split(".")[-1], "out": str(out_dtype).split(".")[-1],
            "shape": [b, h, w, c], "out_hw": [oh, ow], "mode": mode,
            "max_abs_err": err, "tolerance": tol, "max_abs_err_vs_f64": err64}
    if timed:
        xf = x.float()
        flops = needed_flops(which, b, c, h, w, arg, mode)
        in_bytes = x.numel() * x.element_size() + (oh * h + ow * w) * 4
        out_bytes = got.numel() * got.element_size()
        bms, by = bound(in_bytes, out_bytes, flops)
        wr32, wc32 = _operators(key, x.device)
        case.update(
            ms=cuda_ms(lambda: kern(x, arg, mode, out_dtype)),
            plain_ms=cuda_ms(lambda: plain(x, arg, mode, out_dtype)),
            library_ms=cuda_ms(lambda: torch.einsum("oi,bijc,pj->bopc", wr32, xf, wc32)),
            bound_ms=bms, bound_by=by, flops=flops, bytes=in_bytes + out_bytes,
            kernel_flops=2 * b * c * (oh * h * w + oh * w * ow))
    return case


def phase_kernels(fp) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(1)
    u8 = torch.randint(0, 256, (B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    f32 = u8.float()
    degrade = []
    for x in (u8, f32):
        for out_dtype in (torch.bfloat16, torch.float32):
            for mode in ("pil", "cv2"):
                main = x is u8 and out_dtype == torch.bfloat16 and mode == "pil"
                degrade.append(kernel_case(fp, "fused_degrade_normalize", x, LOW, mode,
                                           out_dtype, timed=main or (x is f32 and mode == "pil")))
    big = torch.randint(0, 256, (B, 160, 140, 3), generator=g, device="cuda", dtype=torch.uint8)
    resize = [kernel_case(fp, "fused_resize_normalize", big, (S, S), "pil", torch.bfloat16, True),
              kernel_case(fp, "fused_resize_normalize", big.float(), (S, S), "pil",
                          torch.float32, True)]
    return [
        {"name": "fused_degrade_normalize", "route": "cuda",
         "source": "crfr_torch/ops/csrc/fused_preprocess.cu",
         "replaces": "crfr/ops/fused_pallas.py:34", "on_main_path": True,
         "cases": degrade, **_headline(degrade[0])},
        {"name": "fused_resize_normalize", "route": "cuda",
         "source": "crfr_torch/ops/csrc/fused_preprocess.cu",
         "replaces": "crfr/ops/fused_pallas.py:93", "on_main_path": False,
         "cases": resize, **_headline(resize[0])},
    ]


def _headline(case: dict) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    out = {k: case[k] for k in keys}
    out["kernel_ms"] = case["ms"]
    return out


def phase_embed(fp) -> tuple[dict, dict]:
    from crfr_torch.bench.throughput import build_embed_pipeline
    from crfr_torch.device import strict_fp32
    from crfr_torch.models.irse import build_backbone

    embed = build_embed_pipeline("ir_50", degrade_to=LOW, image_size=S, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randint(0, 256, (B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)

    fp.fused_degrade_normalize.launches = 0
    fp.fused_resize_normalize.launches = 0
    emb = embed(x)
    torch.cuda.synchronize()
    launches = {"fused_degrade_normalize": fp.fused_degrade_normalize.launches,
                "fused_resize_normalize": fp.fused_resize_normalize.launches}
    if tuple(emb.shape) != (B, 512) or emb.dtype != torch.float32:
        raise AssertionError(f"embed: bad output {tuple(emb.shape)} {emb.dtype}")
    if not torch.isfinite(emb).all():
        raise AssertionError("embed: non-finite embeddings")
    if launches["fused_degrade_normalize"] < 1:
        raise AssertionError("embed: the main path did not launch the preprocessing kernel")

    # the bf16 pipeline against the float32 plain path on 16 images
    model32 = build_backbone("ir_50", generator=torch.Generator().manual_seed(0)).cuda().eval()
    with strict_fp32(), torch.inference_mode():
        xs = x[:16]
        ref = model32(fp.fused_degrade_normalize_reference(xs, LOW, "pil", torch.float32))
        k32 = model32(fp.fused_degrade_normalize(xs, LOW, "pil", torch.float32))
    rel32 = ((k32 - ref).abs().max() / ref.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(emb[:16], ref, dim=-1).min().item()
    if not (rel32 < 1e-4 and cos > 0.99):
        raise AssertionError(f"embed: float32 kernel path vs plain rel err {rel32}, "
                             f"bf16 pipeline cosine {cos}")

    per_batch = []
    for _ in range(3):
        embed(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            embed(x)
        torch.cuda.synchronize()
        per_batch.append(1e3 * (time.perf_counter() - t0) / 20)
    best = min(per_batch)
    return ({"phase": "embed", "backbone": "ir_50", "batch": B, "degrade_to": LOW,
             "dtype": "bfloat16", "launches": launches, "shape": list(emb.shape),
             "f32_kernel_vs_plain_max_rel": rel32, "bf16_vs_f32_cos_min": cos,
             "ms_per_batch": best, "ms_per_batch_repeats": per_batch,
             "imgs_per_s": 1e3 * B / best}, {"model32": model32})


def phase_verify(fp, model32) -> dict:
    from crfr_torch.device import strict_fp32
    from crfr_torch.eval.extract import make_extract_fn
    from crfr_torch.eval.verification import evaluate_distances, pair_distances

    n = 300
    g = torch.Generator(device="cuda").manual_seed(3)
    base = torch.randint(0, 256, (n, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    issame = torch.arange(n, device="cuda") % 2 == 0
    noise = torch.randn(base.shape, generator=g, device="cuda") * 8
    genuine = (base.float() + noise).clamp(0, 255).round().to(torch.uint8)
    impostor = base[torch.randperm(n, generator=g, device="cuda")]
    probes = torch.where(issame[:, None, None, None], genuine, impostor)
    hr = make_extract_fn(model32, degrade_to=None, image_size=S, device="cuda")
    lr = make_extract_fn(model32, degrade_to=LOW, image_size=S, device="cuda")
    fp.fused_degrade_normalize.launches = 0
    with strict_fp32():
        e1 = torch.cat([hr(base[i:i + 100]) for i in range(0, n, 100)])
        e2 = torch.cat([lr(probes[i:i + 100]) for i in range(0, n, 100)])
    launches = fp.fused_degrade_normalize.launches
    if launches < 1 or not (torch.isfinite(e1).all() and torch.isfinite(e2).all()):
        raise AssertionError(f"verify: launches {launches}, finite embeddings required")
    dist = pair_distances(e1, e2)
    same = issame.cpu().numpy()
    on_card = evaluate_distances(dist, same, device="cuda")
    on_cpu = evaluate_distances(dist.cpu(), same, device="cpu")
    if not (np.array_equal(on_card.fold_accuracies, on_cpu.fold_accuracies)
            and np.array_equal(on_card.best_thresholds, on_cpu.best_thresholds)
            and on_card.eer == on_cpu.eer
            and all(abs(on_card.tar_at_far[k] - v) <= 1e-6
                    for k, v in on_cpu.tar_at_far.items())):
        raise AssertionError(f"verify: protocol on the card {on_card} != on CPU {on_cpu}")
    return {"phase": "verify", "pairs": n, "launches": {"fused_degrade_normalize": launches},
            "accuracy_mean": on_card.accuracy_mean, "eer": on_card.eer,
            "tar_at_far": {str(k): v for k, v in on_card.tar_at_far.items()},
            "card_equals_cpu": True}


def phase_serve(fp, model32) -> dict:
    from crfr_torch.device import strict_fp32
    from crfr_torch.serve import build_serving_fn
    from crfr_torch.serve_http import make_server

    fn = build_serving_fn(model32, degrade_to=LOW, image_size=S, device="cuda")
    meta = {"batch": 64, "image_size": S, "input_dtype": "uint8", "backbone": "ir_50"}
    rng = np.random.default_rng(4)
    reqs = [rng.integers(0, 256, (k, S, S, 3)).astype(np.uint8) for k in (1, 5, 100)]

    def post(url, arr):
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return np.load(io.BytesIO(r.read()), allow_pickle=False)

    fp.fused_degrade_normalize.launches = 0
    with strict_fp32():
        srv = make_server(fn, meta, host="127.0.0.1", port=0, device="cuda")
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(3) as ex:
                futs = [ex.submit(post, url + "/embed", r) for r in reqs]
                outs = [f.result(timeout=300) for f in futs]
            wall = time.perf_counter() - t0
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            direct = [fn(r).cpu().numpy() for r in reqs]
        finally:
            srv.shutdown()
            srv.server_close()
            srv.service.close()
            th.join(timeout=30)
    errs = []
    for r, got, want in zip(reqs, outs, direct):
        if got.shape != (len(r), 512):
            raise AssertionError(f"serve: bad response shape {got.shape}")
        errs.append(float(np.abs(got - want).max() / np.abs(want).max()))
    if max(errs) > 1e-3 or not health["ok"] or th.is_alive():
        raise AssertionError(f"serve: rel errors {errs}, health {health}")
    return {"phase": "serve", "rows": [len(r) for r in reqs], "static_batch": 64,
            "dispatches": health["dispatches"], "max_rel_err_vs_direct": errs,
            "launches": {"fused_degrade_normalize": fp.fused_degrade_normalize.launches},
            "wall_s_three_requests": wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from crfr_torch.ops import _build
    from crfr_torch.ops import fused_preprocess as fp

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0})

    kernels = phase_kernels(fp)
    emit({"phase": "kernels", "cases": sum(len(k["cases"]) for k in kernels)})
    embed, state = phase_embed(fp)
    emit({**embed, "card": smi})
    for k in kernels:
        k["launches"] = embed["launches"][k["name"]]
    emit(phase_verify(fp, state["model32"]))
    emit(phase_serve(fp, state["model32"]))
    emit({"kernels": kernels, "card": smi, "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
