"""Run one cell of the benchmark of ``crfr_torch`` and print its result line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up (loading the program, making its weights and traffic on the card
from the seed, warming up) counts from this process's start to the first
timed call. A cell on more than one card starts one process a card with
``torch.distributed.run`` (NCCL), and its rank 0 prints the line. Without
CUDA, or with fewer cards than the cell asks for, it exits with 2 and
prints no result.

``--calibrate N [--control-seeds K]`` prints, in place of a result, the
readings that set the cell's limits: the program's on N seeds from
``--seed`` on, and the control's and the planted faults' on the first K.
``--device cpu``, ``--root`` and ``--fault`` serve the tests: a run on the
CPU at the sizes of another ``BENCHMARK.json``, with a fault planted.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)          # the checkout, not this folder, is the import root


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", type=int, default=0)
    ap.add_argument("--control-seeds", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--fault", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    from benchmark.harness import load_cell, run

    if args.worker:
        return run(args, args.t0)
    cell = load_cell(Path(args.root), args.workload)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
                  f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
            return 2
    if cell.chips == 1:
        return run(args, T0)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={cell.chips}", str(Path(__file__).resolve()), *argv,
           "--worker", "--t0", repr(T0)]
    return subprocess.run(cmd, cwd=ROOT).returncode


if __name__ == "__main__":
    sys.exit(main())
