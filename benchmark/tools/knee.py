"""The sweep that finds a serving cell's knee: the highest offered rate the
program sustains without a growing backlog.  One server (the cell's
Translator and handler, warm), then one open-loop window at each rate, on
the cell's mix; per rate one JSON line with the latencies' p50 and p95, the
median latency of the window's first and last fifth, and the rate of
answers.  A rate is sustained where no request fails and the last fifth's
median latency is under twice the first fifth's plus 20 ms.

    python3 benchmark/tools/knee.py --workload NAME --seconds 20 \\
        --rates 10 20 40 80
"""

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import threading
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import common  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    common.prepare_env()
    import torch

    from benchmark.harness import serve

    cell = common.resolve_cell(args.workload)
    dev = torch.device(args.device)
    server, _ = serve.build_server(cell["config"], cell["traffic"], args.seed,
                                   dev, None)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        for rate in args.rates:
            traffic = dict(cell["traffic"], rate_per_s=rate)
            work = Path(tempfile.mkdtemp(prefix="srgan_bench_knee_"))
            try:
                res, _ = serve.drive(server.server_address[1], traffic,
                                     cell["config"]["model"], args.seed,
                                     args.seconds, work, dev)
            finally:
                shutil.rmtree(work, ignore_errors=True)
            rows = res["rows"]
            lat = serve.latencies(traffic, rows)
            fifth = max(1, len(rows) // 5)
            first = statistics.median(lat[:fifth])
            last = statistics.median(lat[-fifth:])
            done = [r[3] for r in rows if r[4] == 200]
            failed = sum(r[4] != 200 for r in rows)
            print(json.dumps({
                "rate": rate, "requests": len(rows), "failed": failed,
                "p50_ms": 1e3 * serve.nearest_rank(lat, 0.5),
                "p95_ms": 1e3 * serve.nearest_rank(lat, 0.95),
                "first_fifth_ms": 1e3 * first, "last_fifth_ms": 1e3 * last,
                "answers_per_s": len(done) / max(done) if done else 0.0,
                "sustained": failed == 0 and last < 2 * first + 0.020}),
                flush=True)
    finally:
        server.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
