"""Exact three-phase top-k over an int8 gallery bank (crfr/ops/bank_scan.py).

1. ``bank_tilemax``: for every probe and every tile of ``tile`` consecutive
   bank rows, the max of the int8 dot times the row's scale (invalid rows
   −3e38), in one launch that reads the bank once per group of up to 256
   probes;
2. the top k tiles per probe over those maxima;
3. the k·tile rows of those tiles per probe, rescored exactly as the scan
   ``eval.bank.streaming_topk_q`` scores them (int8 dot · (probe scale · row
   scale), invalid rows −inf), then a final top-k.

Exact by the tournament argument of ``eval.identification._block_topk``: a
tile whose max is below the k-th best score cannot hold a top-k row, and
fewer than k tiles can beat a tile that holds one. Phase 1 leaves out the
probe's scale, a positive constant per probe, as ``crfr`` does.

A tensor on the CPU goes through ``bank_tilemax_reference``; a CUDA tensor
goes through the hand-written kernel in ``csrc/bank_scan.cu`` or the call
raises: there is no fallback. ``bank_tilemax.launches`` counts launches.
Phases 2 and 3 are torch ops on the bank's device, as ``crfr`` runs them
outside its ``pallas_call``.
"""

from __future__ import annotations

import ctypes

import torch

from crfr_torch.ops import _build

NEG = -3.0e38                   # effectively −inf, stays finite in f32
MAX_D = 1024                    # D · 127² < 2²⁴: float sums of int8 products stay exact
_CAND_BYTES = 256 << 20         # phase 3's f32 candidate rows per probe block


def bank_tilemax_reference(pq: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                           valid: torch.Tensor, tile: int = 128) -> torch.Tensor:
    """Plain PyTorch version of ``bank_tilemax``: an f32 product of the int8
    values (exact while D ≤ 1024), the select, padding to a whole tile with
    invalid rows, and the max over each tile."""
    n, m = pq.shape[0], q.shape[0]
    t = -(-m // tile)
    acc = torch.matmul(pq.to(torch.float32), q.to(torch.float32).t())     # (N, M)
    sim = torch.where(valid[None, :], acc * scale.to(torch.float32)[None, :],
                      torch.tensor(NEG, dtype=torch.float32, device=acc.device))
    if t * tile != m:
        sim = torch.nn.functional.pad(sim, (0, t * tile - m), value=NEG)
    return sim.reshape(n, t, tile).amax(dim=2)


def _check_launch(pq, q, scale, valid, tile) -> None:
    what = "bank_tilemax"
    for name, x, dtype in (("pq", pq, torch.int8), ("q", q, torch.int8),
                           ("scale", scale, torch.float32), ("valid", valid, torch.bool)):
        if x.device != pq.device:
            raise ValueError(f"{what}: {name} is on {x.device}, pq on {pq.device}")
        if x.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if pq.ndim != 2 or q.ndim != 2 or pq.shape[1] != q.shape[1]:
        raise ValueError(f"{what}: pq (N, D) and q (M, D), got {tuple(pq.shape)} "
                         f"and {tuple(q.shape)}")
    m, d = q.shape
    if scale.shape != (m,) or valid.shape != (m,):
        raise ValueError(f"{what}: scale and valid must be ({m},), got "
                         f"{tuple(scale.shape)} and {tuple(valid.shape)}")
    if d % 16 or d > MAX_D:
        raise ValueError(f"{what}: D must be a multiple of 16 and at most {MAX_D}, got {d}")
    if pq.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{what}: pq and q must start on a 16-byte boundary")
    if m >= 2 ** 31:
        raise ValueError(f"{what}: at most 2**31 - 1 bank rows, got {m}")


def bank_tilemax(pq: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 valid: torch.Tensor, tile: int = 128) -> torch.Tensor:
    """(N, ceil(M / tile)) f32 per-probe maxima over bank tiles, in one
    launch (one pass over the bank per group of up to 256 probes, 128 at
    D > 512). ``pq`` (N, D) int8 probes, ``q`` (M, D) int8 bank,
    ``scale`` (M,) f32 row scales, ``valid`` (M,) bool. Invalid rows, and
    rows past M in the last tile, score −3e38. On the card ``tile`` is 128,
    D a multiple of 16 and at most 1024, every input contiguous."""
    if pq.device.type == "cpu":
        return bank_tilemax_reference(pq, q, scale, valid, tile)
    if pq.device.type != "cuda":
        raise ValueError(f"bank_tilemax: the kernel takes CUDA tensors, got {pq.device}")
    _check_launch(pq, q, scale, valid, tile)
    lib = _build.load_library()
    if tile != lib.crfr_bank_tilemax_tile():
        raise ValueError(f"bank_tilemax: the kernel computes tiles of "
                         f"{lib.crfr_bank_tilemax_tile()} rows, got tile={tile}")
    n, m, d = pq.shape[0], q.shape[0], q.shape[1]
    out = torch.empty((n, -(-m // tile)), dtype=torch.float32, device=pq.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(pq.device):
        stream = torch.cuda.current_stream(pq.device).cuda_stream
        err = lib.crfr_bank_tilemax(pq.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                    valid.data_ptr(), out.data_ptr(), n, m, d, tile, stream)
    _build.check(lib, err, "bank_tilemax")
    bank_tilemax.launches += 1
    return out


bank_tilemax.launches = 0

_INFO_KEYS = ("registers", "spill_bytes", "smem_bytes", "ctas", "probe_groups", "stages",
              "threads", "probes_per_group")


def bank_tilemax_info(n: int, m: int, d: int) -> dict:
    """What one ``bank_tilemax`` call at (N, M, D) launches on the current
    CUDA device: registers and local-memory (spill) bytes per thread as
    compiled, dynamic shared memory, CTAs, probe groups (each streams the
    bank once), ring stages, threads per CTA and probes per group."""
    lib = _build.load_library()
    info = (ctypes.c_int * len(_INFO_KEYS))()
    _build.check(lib, lib.crfr_bank_tilemax_info(n, m, d, ctypes.addressof(info)),
                 "bank_tilemax_info")
    return dict(zip(_INFO_KEYS, info))


def bank_topk_fused(probe_emb: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    labels: torch.Tensor, k: int = 10,
                    tile: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-probe top-k against an int8 bank through ``bank_tilemax``.

    Same contract as ``eval.bank.streaming_topk_q``: (scores (N, k) f32,
    labels (N, k) int64) on the bank's device, sorted descending, label −1
    and score −inf on rows short of k. Needs at least k tiles, i.e. M >
    tile·(k − 1) (``topk_matches_bank`` sends smaller banks to the scan)."""
    from crfr_torch.eval.bank import quantize_probes
    from crfr_torch.eval.identification import top_k

    dev = q.device
    pq, ps = quantize_probes(torch.as_tensor(probe_emb).to(dev))
    n = pq.shape[0]
    m, d = q.shape
    n_tiles = -(-m // tile)
    if n_tiles < k:
        raise ValueError(f"bank_topk_fused: {m} rows make {n_tiles} tiles of {tile}, "
                         f"fewer than k={k}")
    sc = scale.to(dev, torch.float32)
    lbl = labels.to(dev, torch.int64)
    valid = lbl >= 0

    tm = bank_tilemax(pq, q.contiguous(), sc.contiguous(), valid, tile)    # (N, T)
    _, tsel = top_k(tm, k)                                                # (N, k)
    cand = (tsel[:, :, None] * tile
            + torch.arange(tile, device=dev)[None, None, :]).reshape(n, k * tile)
    inside = cand < m                                   # the ragged last tile
    cand = cand.clamp(max=m - 1)
    step = max(1, _CAND_BYTES // (k * tile * d * 4))
    scores, out_labels = [], []
    for i in range(0, n, step):
        c = cand[i:i + step]
        rows = q[c].to(torch.float32)                                    # (b, k·t, D)
        acc = torch.bmm(rows, pq[i:i + step, :, None].to(torch.float32))[..., 0]
        sim = acc * (ps[i:i + step, None] * sc[c])
        sim = torch.where(valid[c] & inside[i:i + step], sim, -torch.inf)
        s, idx = top_k(sim, k)
        lab = torch.gather(lbl[c], 1, idx)
        scores.append(s)
        out_labels.append(torch.where(torch.isfinite(s), lab, -1))
    if not scores:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int64, device=dev))
    return torch.cat(scores), torch.cat(out_labels)
