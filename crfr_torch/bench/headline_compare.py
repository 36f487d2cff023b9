"""The headline's ordering gaps from two runs side by side: the per-seed
tables that ``headline --seeds N`` writes (``headline_seeds.json``) by two
implementations at the same ``HeadlineCfg``, e.g. the reference's on the
CPU and the port's on the card.

    python -m crfr_torch headline --out A --seeds 3 int8_eval=0 <key=value ...>
    python -m crfr_torch.bench.headline_compare A/headline_seeds.json B/headline_seeds.json

For each seed, probe size and metric (verification accuracy, rank-1) it
prints student_sr − student_bic and student_bic − teacher_lr of both runs
and whether their signs agree (a zero gap is its own sign), then one JSON
line with the counts. Reads JSON only.
"""

from __future__ import annotations

import argparse
import json

SYSTEMS = ("teacher_lr", "student_bic", "student_sr")
GAPS = (("sr_minus_bic", "student_sr", "student_bic"),
        ("bic_minus_teacher", "student_bic", "teacher_lr"))
METRICS = ("verification_acc", "rank1")


def _sign(v: float) -> int:
    return (v > 0) - (v < 0)


def gaps(per_seed: list[dict]) -> dict:
    """{(seed index, probe, metric, gap name): value} of one run."""
    out = {}
    for k, results in enumerate(per_seed):
        for probe, res in results.items():
            for metric in METRICS:
                for name, a, b in GAPS:
                    out[(k, probe, metric, name)] = res[a][metric] - res[b][metric]
    return out


def compare(a: dict, b: dict) -> dict:
    ga, gb = gaps(a["per_seed"]), gaps(b["per_seed"])
    rows = []
    for key in sorted(ga.keys() & gb.keys()):
        k, p, m, g = key
        rows.append({"seed": k, "probe": p, "metric": m, "gap": g, "a": ga[key], "b": gb[key],
                     "signs_agree": _sign(ga[key]) == _sign(gb[key])})
    counts = {g: {"agree": sum(r["signs_agree"] for r in rows if r["gap"] == g),
                  "of": sum(r["gap"] == g for r in rows)} for g, _, _ in GAPS}
    return {"rows": rows, "counts": counts}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="crfr_torch.bench.headline_compare")
    ap.add_argument("a", help="headline_seeds.json of the first run")
    ap.add_argument("b", help="headline_seeds.json of the second run")
    args = ap.parse_args(argv)
    with open(args.a) as f:
        a = json.load(f)
    with open(args.b) as f:
        b = json.load(f)
    if {k: v for k, v in a["cfg"].items() if k != "out_dir"} != \
            {k: v for k, v in b["cfg"].items() if k != "out_dir"}:
        raise ValueError("the two runs were made at different HeadlineCfg fields")
    out = compare(a, b)
    for r in out["rows"]:
        print(f"seed {r['seed']} probe {r['probe']:>2} {r['metric']:16s} {r['gap']:17s} "
              f"a {r['a']:+.4f} b {r['b']:+.4f} {'agree' if r['signs_agree'] else 'DIFFER'}")
    print(json.dumps({"counts": out["counts"],
                      "n_seeds": [a["n_seeds"], b["n_seeds"]]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
