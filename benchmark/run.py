"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with as many CUDA cards as the
cell asks for.  The cell is read from ``BENCHMARK.json``; its configuration,
traffic, limits and per-layer metrics from the files under ``benchmark/``
that the manifest names.  The last line of stdout is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; then ``checks``, each compared number beside its limit, which
are also the last lines of stderr.  Without the cards it asks for the run
exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.prepare_env()
    cell = common.resolve_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    from benchmark.harness.cell import run_cell

    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    found = common.forbidden_loaded()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
