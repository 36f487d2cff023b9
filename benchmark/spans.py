"""The program's span log (``crfr_torch.utils.profiling.spans``: flat records
with parent ids, host edges on ``time.time_ns()`` and device edges from CUDA
events), read for the per-layer metrics. The harness's traced segment is
the only window in which a profiler runs, so after a ``--trace 1`` run the
log holds that segment's spans. Where the program keeps no such log, the
readers find nothing and give no reading."""


def calls(root: str, last: int | None = None) -> list[dict]:
    """The last ``last`` (None: all) finished spans named ``root`` that have
    no parent, each with ``children``: {name: its child span}; [] without
    the log."""
    try:
        from crfr_torch.utils.profiling import spans
    except ImportError:
        return []
    recs = spans()
    roots = [r for r in recs if r["name"] == root and r["parent"] is None]
    if last is not None:
        roots = roots[max(len(roots) - last, 0):]
    by_id = {r["id"]: dict(r, children={}) for r in roots}
    for r in recs:
        if r["parent"] in by_id:
            by_id[r["parent"]]["children"][r["name"]] = r
    return list(by_id.values())
