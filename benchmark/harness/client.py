"""The serving cell's open-loop client, a process of its own:

    python -m benchmark.harness.client SPEC.json

It encodes the pool's bodies, prints "ready", waits for a line on stdin,
then sends each request of the schedule at its due time on a connection of
its own, whether or not earlier ones have answered (a pool of sender
threads; a request that finds them all busy waits, and its latency counts
the wait).  A request is timed from its due time until its whole response
has been read.  Once every request has answered, or ``late_wait_s`` after
the last was due, it writes ``results.json`` (per request: kind, due,
sent, done, HTTP status; -1 for none) and the sampled answers'
bodies to the spec's directory, and exits."""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from benchmark.harness import mix


def main(spec_path: str):
    spec = json.loads(Path(spec_path).read_text())
    traffic, out = spec["traffic"], Path(spec["out"])
    bodies = {kind: [mix.encode_npz({k: v for k, v in r.items()
                                     if k != "path"}) for r in reqs]
              for kind, reqs in mix.pool(traffic, spec["model"],
                                         spec["seed"]).items()}
    paths = {k["name"]: k["path"] for k in traffic["mix"]}
    sched = mix.schedule(traffic, spec["seed"], spec["seconds"])
    keep = set(mix.sample(traffic, sched, spec["seed"]))
    rows = [[kind, due, None, None, -1] for due, kind, _ in sched]
    answers = {}
    left = threading.Semaphore(0)
    print("ready", flush=True)
    sys.stdin.readline()

    def send(i, t0):
        _, kind, j = sched[i]
        rows[i][2] = time.perf_counter() - t0
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", spec["port"],
                timeout=spec["seconds"] + traffic["late_wait_s"])
            conn.request("POST", paths[kind], bodies[kind][j],
                         {"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            rows[i][3] = time.perf_counter() - t0
            rows[i][4] = resp.status
            if i in keep:
                answers[i] = data
        except (OSError, http.client.HTTPException) as e:
            rows[i][3] = time.perf_counter() - t0
            print(f"request {i} ({kind}) failed: {e!r}", file=sys.stderr)
        finally:
            left.release()

    t0 = time.perf_counter() + spec["lead_s"]
    ex = ThreadPoolExecutor(traffic["client_threads"])
    for i, (due, _, _) in enumerate(sched):
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        ex.submit(send, i, t0)
    deadline = t0 + sched[-1][0] + traffic["late_wait_s"]
    for _ in sched:
        if not left.acquire(timeout=max(0.0, deadline - time.perf_counter())):
            break
    snapshot = [list(r) for r in rows]
    for i, data in list(answers.items()):
        (out / f"answer_{i}.npz").write_bytes(data)
    (out / "results.json").write_text(json.dumps(
        {"rows": snapshot, "sampled": sorted(answers)}))


if __name__ == "__main__":
    main(sys.argv[1])
    sys.stdout.flush()
    sys.stderr.flush()
    # a sender still waiting past the deadline is abandoned, not joined
    os._exit(0)
