"""Seconds to build the port's kernel library, by two routes:

- ``one``: a single ``nvcc -shared`` call given every source, which
  compiles them one after another and links;
- ``parallel``: ``ops._build``'s route, one ``nvcc -c`` per source, all
  started together, then one link.

    python -m crfr_torch.bench.build_time [--rounds 2]

Each round builds one, parallel, parallel, one into a scratch directory
under ``build/`` (removed afterwards), with ``ops._build``'s flags. Prints
one JSON line: the seconds of every build by route, and the median of each.
Needs ``nvcc``; no card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

from crfr_torch.ops import _build


def build_one_call(so: Path) -> None:
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                    *map(str, _build.SOURCES)], check=True, capture_output=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    routes = {"one": build_one_call, "parallel": _build._compile_and_link}
    secs: dict[str, list[float]] = {"one": [], "parallel": []}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as d:
        for i in range(args.rounds):
            for j, route in enumerate(("one", "parallel", "parallel", "one")):
                so = Path(d) / f"lib_{i}_{j}.so"
                t0 = time.perf_counter()
                routes[route](so)
                secs[route].append(time.perf_counter() - t0)
                if not so.exists():
                    raise RuntimeError(f"{route}: no library built")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(json.dumps({"sources": [s.name for s in _build.SOURCES], "nvcc": nvcc,
                      "seconds": secs,
                      "median_s": {r: float(np.median(v)) for r, v in secs.items()}}))


if __name__ == "__main__":
    main()
