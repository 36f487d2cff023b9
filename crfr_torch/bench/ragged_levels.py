"""Where the time of kernel 2's ragged forms goes, on one CUDA card.

    python -m crfr_torch.bench.ragged_levels [--sweep]

For a 640×480 and a 1280×720 uint8 photo at MTCNN's min_face 20, float32
out, one JSON line each: the pyramid form over every level (``ms``), over
each level alone (``level_ms``, the same form and plan with one level), and
each level's own launch of the resize form (``resize_ms``); then 223 boxes
of the 640×480 photo (``photo_boxes``: sides 12 to 400 px, some outside
it) cut to 24 px by the crop form. With ``--phases``, each photo's pyramid once more from
a build with ``-DCRFR_PHASE_CLOCK`` (``preprocess_phases``' library): per
level, its tiles' medians and maxima of the chunks' staging, their
horizontal passes, the vertical pass, and the whole tile, in µs. With
``--sweep``, the pyramid and the crops again at
other tile limits (``fused_preprocess.TILE_FMAS``, ``TILE_SUMS_BYTES``,
``STAGE_BYTES``, ``CROP_ROWS``), each result checked bit for bit against
the defaults'. Times are CUDA-event means behind a spin kernel
(``chip_smoke.cuda_ms``'s method); the card's name and power limit come
first. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from crfr_torch.models.mtcnn import MTCNN
from crfr_torch.ops import fused_preprocess as fp

PHOTOS = ((480, 640), (720, 1280))
SPIN_CYCLES_PER_CALL = 400_000
CROP_SPIN = 4_000_000           # the crop form's host work a call is longer than the default's


def cuda_ms(fn, iters: int = 20, warmup: int = 3, spin: int = SPIN_CYCLES_PER_CALL) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def photo_boxes(n: int, h: int, w: int, seed: int = 11, min_side: float = 12,
                unequal: float = 0.2) -> np.ndarray:
    """``n`` int32 boxes [x1, y1, x2, y2] on an (h, w) photo as a cascade's
    stages see them: sides ``min_side`` to 400 px, a share ``unequal`` of
    them with cw != ch, some partly outside the photo, the first wholly
    outside it, the second with no area."""
    rng = np.random.default_rng(seed)
    side = np.exp(rng.uniform(np.log(min_side), np.log(400), n))
    cx, cy = rng.uniform(-30, w + 30, n), rng.uniform(-30, h + 30, n)
    sw = side * np.where(rng.random(n) < unequal, rng.uniform(0.6, 1.4, n), 1.0)
    b = np.stack([cx - sw / 2, cy - side / 2, cx + sw / 2, cy + side / 2], 1).astype(np.int32)
    b[0] = [-90, -60, -10, -5]
    b[1] = [30, 40, 30, 90]
    return b


def _set(**limits) -> None:
    for k, v in limits.items():
        setattr(fp, k, v)
    fp.pyramid_plan.cache_clear()
    fp._pyramid_tables.cache_clear()


def pyramid_line(x: torch.Tensor, sizes: list, per_level: bool) -> dict:
    _, h, w, c = x.shape
    out = {"photo": f"{w}x{h}", "levels": [list(s) for s in sizes],
           "tiles": len(fp.pyramid_plan(h, w, c, 1, tuple(sizes), "pil")["tiles"]),
           "ms": cuda_ms(lambda: fp.fused_pyramid_normalize(x, sizes))}
    if per_level:
        out["level_ms"] = [cuda_ms(lambda s=s: fp.fused_pyramid_normalize(x, [s]))
                           for s in sizes]
        out["resize_ms"] = [cuda_ms(lambda s=s: fp.fused_resize_normalize(x, s, "pil",
                                                                          torch.float32))
                            for s in sizes]
    return out


def phase_line(lib, x: torch.Tensor, sizes: list) -> dict:
    """One pyramid launch of the phase-clock build: µs by pass and level."""
    from crfr_torch.ops import _build

    _, h, w, c = x.shape
    sizes = tuple(map(tuple, sizes))
    plan = fp.pyramid_plan(h, w, c, 1, sizes, "pil")
    wins, tiles, _ = fp._pyramid_tables(h, w, c, 1, sizes, "pil", x.device)
    out = torch.empty(plan["total"], dtype=torch.float32, device=x.device)
    clock = torch.zeros((len(plan["tiles"]), 8), dtype=torch.int64, device=x.device)
    _build.check(lib, lib.crfr_resample_phase_clock(clock.data_ptr()), "phase clock")
    for _ in range(3):                                   # the last run is read
        err = lib.crfr_pyramid_normalize(
            x.data_ptr(), 0, out.data_ptr(), 0, h, w, c, wins.data_ptr(), tiles.data_ptr(),
            len(plan["tiles"]), plan["taps_off"], plan["stage_off"], plan["smem"],
            torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "fused_pyramid_normalize")
    torch.cuda.synchronize()
    _build.check(lib, lib.crfr_resample_phase_clock(None), "phase clock")
    d = clock.cpu().numpy()
    start = d[:, 0].min()
    level = np.asarray([t[0] for t in plan["tiles"]])
    us = {"stage": d[:, 2] / 1e3, "horizontal": d[:, 3] / 1e3,
          "vertical": (d[:, 4] - d[:, 1]) / 1e3, "tile": (d[:, 4] - d[:, 0]) / 1e3}
    levels = []
    for i, hw in enumerate(sizes):
        sel = level == i
        levels.append({"level": list(hw), "tiles": int(sel.sum()),
                       "end_us": float((d[sel, 4].max() - start) / 1e3),
                       **{f"{k}_us_median": float(np.median(v[sel])) for k, v in us.items()},
                       **{f"{k}_us_max": float(v[sel].max()) for k, v in us.items()}})
    return {"photo": f"{w}x{h}", "span_us": float((d[:, 4].max() - start) / 1e3),
            "levels": levels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="also other tile limits")
    ap.add_argument("--phases", action="store_true", help="also the phase-clock build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ragged_levels: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    mt = MTCNN(min_face=20, device="cpu")
    photos = [torch.randint(0, 256, (1, h, w, 3), generator=g, device="cuda", dtype=torch.uint8)
              for h, w in PHOTOS]
    sizes = [[hw for _, hw in mt.pyramid_sizes(h, w)] for h, w in PHOTOS]
    img = photos[0][0]
    boxes = photo_boxes(223, *PHOTOS[0])
    crops = lambda: fp.fused_crop_resize_normalize(img, boxes, 24)  # noqa: E731
    want = ([fp.fused_pyramid_normalize(x, s) for x, s in zip(photos, sizes)], crops())
    defaults = {k: getattr(fp, k) for k in ("TILE_FMAS", "TILE_SUMS_BYTES", "STAGE_BYTES",
                                            "CROP_ROWS")}
    runs = [defaults]
    if args.sweep:
        runs += [{**defaults, "TILE_FMAS": f} for f in (1 << 16, 1 << 17, 1 << 19, 1 << 20)]
        runs += [{**defaults, "TILE_SUMS_BYTES": b} for b in (16 << 10, 64 << 10)]
        runs += [{**defaults, "STAGE_BYTES": b} for b in (12 << 10, 48 << 10)]
        runs += [{**defaults, "CROP_ROWS": r} for r in (4, 16)]
    for limits in runs:
        _set(**limits)
        t0 = time.perf_counter()
        got = ([fp.fused_pyramid_normalize(x, s) for x, s in zip(photos, sizes)], crops())
        torch.cuda.synchronize()
        same = (all(torch.equal(a, b) for p, q in zip(got[0], want[0]) for a, b in zip(p, q))
                and torch.equal(got[1], want[1]))
        line = {"limits": limits, "equal_to_defaults": same,
                "first_call_s": time.perf_counter() - t0,
                "pyramids": [pyramid_line(x, s, limits is defaults)
                             for x, s in zip(photos, sizes)],
                "crops": {"boxes": len(boxes), "size": 24, "ms": cuda_ms(crops, spin=CROP_SPIN),
                          **fp.crop_plan(*(d[d > 0] for d in (boxes[:, 3] - boxes[:, 1],
                                                               boxes[:, 2] - boxes[:, 0])),
                                         24, 3, 1, "pil")}}
        print(json.dumps(line), flush=True)
    _set(**defaults)
    if args.phases:
        from crfr_torch.bench.preprocess_phases import _library

        lib = _library()
        for x, s in zip(photos, sizes):
            print(json.dumps(phase_line(lib, x, s)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
