"""The serving cells: the program's HTTP handler (``serving.make_handler``
over a ``Translator``) under ``http.server.ThreadingHTTPServer`` on a
loopback port inside the run, fed by the open-loop client
(``harness/client.py``) in a process of its own.

After the window the answers the client kept (a sample drawn from the seed,
with the first request of each kind in it) are compared with the plain
reference's G and E in fp32 on the same inputs."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness import common, mix


class Spans:
    """Host seconds inside the handler and inside the Translator, summed
    over requests (thread-safe)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.handler_s = self.translator_s = 0.0
        self.requests = 0

    def add(self, field: str, dt: float, request: bool = False):
        with self.lock:
            setattr(self, field, getattr(self, field) + dt)
            self.requests += request

    def wrap(self, fn):
        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.add("translator_s", time.perf_counter() - t)
        return timed


def build_server(config: dict, traffic: dict, seed: int, device,
                 spans: Spans | None):
    """The program's Translator over the benchmark's weights, warmed at the
    traffic's batch sizes, behind its handler on a free loopback port."""
    from http.server import ThreadingHTTPServer

    from srgan_tpu_torch.serving import Translator, make_handler

    cfg = common.port_config(config, 0)
    g, _, e = common.make_weights(config, seed, device)
    tr = Translator.from_state_dicts(
        cfg, g, e, device=device,
        warm_batch_sizes=tuple(traffic["warm_batch_sizes"]))
    handler = make_handler(tr)
    if spans is not None:
        tr.translate = spans.wrap(tr.translate)
        tr.encode = spans.wrap(tr.encode)
        base = handler

        class handler(base):  # noqa: N801
            def do_POST(self):
                t = time.perf_counter()
                try:
                    super().do_POST()
                finally:
                    spans.add("handler_s", time.perf_counter() - t, True)

    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    return server, tr


def nearest_rank(values, q: float) -> float:
    v = sorted(values)
    return v[max(0, min(len(v) - 1, int(np.ceil(q * len(v))) - 1))]


def reference_outputs(config: dict, seed: int, reqs, device,
                      precision: str = "fp32") -> list:
    """The plain reference's answer to each request: (fakes NHWC, latent)
    for a translation, (mu, logvar) for an encoding; the latent of a body
    without one is drawn as the server draws it, from a CPU generator
    seeded with the body's seed."""
    from benchmark.reference.nets import build, set_precision

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    G, _, E = build(config, "meta")
    g, _, e = common.make_weights(config, seed, device)
    G.load_state_dict(g, assign=True)
    E.load_state_dict(e, assign=True)
    set_precision(G, precision)
    set_precision(E, precision)
    m = config["model"]
    out = []
    with torch.inference_mode():
        for r in reqs:
            x = torch.from_numpy(r["images"]).to(device).permute(0, 3, 1, 2)
            if r["path"] == "/encode":
                mu, logvar = E(x)
                out.append((mu.cpu().numpy(), logvar.cpu().numpy()))
                continue
            n = len(x)
            latent = r.get("latent")
            if latent is None:
                gen = torch.Generator().manual_seed(int(r["seed"]))
                latent = torch.randn((n, m["ndim"]), generator=gen).numpy()
            lat = torch.from_numpy(np.asarray(latent, np.float32)).to(device)
            oh = F.one_hot(torch.from_numpy(r["target_labels"]).long(),
                           m["n_classes"]).float().to(device)
            fake = G(x, torch.cat([oh, lat], 1)).permute(0, 2, 3, 1)
            out.append((fake.cpu().numpy(), np.asarray(latent, np.float32)))
    return out


def gaps(answers: list, refs: list, kinds: list) -> dict:
    """fake_gap: the largest |pixel - reference pixel| of a translation;
    code_gap: the largest |mu or logvar - reference| of an encoding over
    the reference's largest |value| in that answer; latent_gap: the
    largest |latent returned - latent asked for or drawn|."""
    out = {"fake_gap": 0.0, "code_gap": 0.0, "latent_gap": 0.0}
    for a, r, path in zip(answers, refs, kinds):
        if path == "/encode":
            for got, want in ((a["mu"], r[0]), (a["logvar"], r[1])):
                if got.shape != want.shape:
                    return {k: float("inf") for k in out}
                scale = max(float(np.abs(want).max()), 1e-30)
                out["code_gap"] = max(out["code_gap"], float(
                    np.abs(got - want).max()) / scale)
        else:
            if a["fakes"].shape != r[0].shape or \
                    a["latent"].shape != r[1].shape:
                return {k: float("inf") for k in out}
            out["fake_gap"] = max(out["fake_gap"], float(
                np.abs(a["fakes"] - r[0]).max()))
            out["latent_gap"] = max(out["latent_gap"], float(
                np.abs(a["latent"] - r[1]).max()))
    return out


def sampled_requests(config, traffic, seed, seconds):
    """(indices, request dicts) of the answers a run compares."""
    sched = mix.schedule(traffic, seed, seconds)
    bodies = mix.pool(traffic, config["model"], seed)
    idx = mix.sample(traffic, sched, seed)
    return idx, [bodies[sched[i][1]][sched[i][2]] for i in idx]


def drive(port: int, traffic: dict, model: dict, seed: int,
          seconds: float, work: Path, device, during=None):
    """Start the client on ``port``, let it run the schedule, and return
    (its results, the host time of the window's start).  ``during`` is
    called once the window has started, in this thread."""
    spec = {"traffic": traffic, "model": model, "seed": seed,
            "seconds": seconds, "port": port, "out": str(work),
            "lead_s": 0.1}
    (work / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    client = subprocess.Popen(
        [sys.executable, "-m", "benchmark.harness.client",
         str(work / "spec.json")], cwd=str(common.ROOT), env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        if client.stdout.readline().strip() != "ready":
            raise RuntimeError("the client did not start")
        common.sync(device)
        client.stdin.write("go\n")
        client.stdin.flush()
        t_window = time.perf_counter() + spec["lead_s"]
        if during is not None:
            during(t_window)
        client.wait(timeout=seconds + traffic["late_wait_s"] + 120)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
    return json.loads((work / "results.json").read_text()), t_window


def latencies(traffic: dict, rows) -> list:
    """Seconds from due to answered; a request that failed or never
    answered counts as slower than any answer can be."""
    give_up = max(r[1] for r in rows) + traffic["late_wait_s"] + 1.0
    return [(r[3] - r[1]) if r[4] == 200 else give_up for r in rows]


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, readers) -> tuple[dict, dict]:
    from benchmark.harness import trace as tr

    config, traffic = cell["config"], cell["traffic"]
    work = Path(tempfile.mkdtemp(prefix="srgan_bench_serve_"))
    held = None
    try:
        spans = Spans() if trace else None
        server, translator = build_server(config, traffic, seed, device,
                                          spans)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()

        def profile(t_window):
            nonlocal held
            time.sleep(max(0.0, t_window - time.perf_counter() + (
                seconds - traffic["trace_seconds"]) / 2))
            with tr.profiled(device) as held:
                time.sleep(traffic["trace_seconds"])

        try:
            res, t_window = drive(server.server_address[1], traffic,
                                  config["model"], seed, seconds, work,
                                  device, profile if trace else None)
        finally:
            server.shutdown()
            server.server_close()
        setup_s = t_window - t_start
        dev = common.device_record(device, cell["chips"])
        del translator, server
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rows = res["rows"]
        lat = latencies(traffic, rows)
        failed = sum(r[4] != 200 for r in rows)
        idx, reqs = sampled_requests(config, traffic, seed, seconds)
        have = [i for i in idx if (work / f"answer_{i}.npz").exists()]
        answers = [mix.decode_npz((work / f"answer_{i}.npz").read_bytes())
                   for i in have]
        reqs = [r for i, r in zip(idx, reqs) if i in set(have)]
        refs = reference_outputs(config, seed, reqs, device)
        numbers = gaps(answers, refs, [r["path"] for r in reqs])
        numbers["failed_requests"] = failed
        numbers["unanswered_samples"] = len(idx) - len(have)
        correct, checks = common.judge(numbers, cell["limits"])
        if trace:
            ctx = {"config": config, "chips": cell["chips"],
                   "device": device, "trace": held.trace if held else None,
                   "handler_s": spans.handler_s,
                   "translator_s": spans.translator_s,
                   "requests": spans.requests}
            metrics = readers(ctx)
            if ctx["trace"] is not None:
                t = ctx["trace"]
                dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        else:
            metrics = {
                "serve_p95_ms": {"value": 1e3 * nearest_rank(lat, 0.95),
                                 "unit": "ms"},
                "serve_p50_ms": {"value": 1e3 * nearest_rank(lat, 0.50),
                                 "unit": "ms"},
                "setup_s": {"value": setup_s, "unit": "s"}}
        late = [r[2] - r[1] for r in rows if r[2] is not None]
        print(f"serve: {len(rows)} requests, {failed} failed, the sender "
              f"at most {1e3 * max(late, default=0.0):.1f} ms late",
              file=sys.stderr)
        result = {"correct": correct, "attempted": len(rows),
                  "failed": failed, "metrics": metrics, "device": dev}
        if trace and held is not None and held.trace is not None:
            result["breakdown"] = held.trace.breakdown()
        return result, checks
    finally:
        shutil.rmtree(work, ignore_errors=True)
