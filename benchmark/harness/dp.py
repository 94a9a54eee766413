"""Training cells across cards: the training cell's step under the
program's data-parallel mesh (``parallel.make_mesh`` over NCCL), one rank a
card, each rank a process the run starts itself:

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=... MASTER_PORT=... \
        python -m benchmark.harness.dp SPEC.json

Every rank builds the same weights and global batches from the seed and
steps on its rows (``parallel.shard_batch``); rank 0 decides when the
window closes and broadcasts it, so every rank takes the same steps.  Rank
0's record of the check steps (the global losses, its optimizer moments and
parameters) is compared, after the ranks have exited, with the plain
reference's single-card step on the whole global batch, which the
program's data parallel reproduces."""

from __future__ import annotations

import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchmark.harness import common, train


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plant(fault):
    """The tests' and the calibration's planted fault: "no_exchange" leaves
    the ranks' gradients and metrics unaveraged."""
    import srgan_tpu_torch.training.gan as gan

    if not hasattr(gan, "_bench_mean_over_ranks"):
        gan._bench_mean_over_ranks = gan._mean_over_ranks
    gan._mean_over_ranks = (lambda tensors, mesh: tensors) \
        if fault == "no_exchange" else gan._bench_mean_over_ranks


def _check(config, traffic, seed, mesh):
    """This rank's program and pool, driven through the check steps."""
    from srgan_tpu_torch.parallel import shard_batch

    dev = mesh.device
    prog = train.Program(config, seed, dev, mesh)
    pool = [shard_batch(b, mesh)
            for b in train.make_pool(config, traffic, seed, dev)]
    rec = train.record_check(prog.step, prog.nets, prog.opts, pool,
                             traffic["check_steps"], dev)
    return prog, pool, rec


def rank_main(spec_path: str):
    import torch.distributed as dist

    from srgan_tpu_torch.parallel import make_mesh

    spec = json.loads(Path(spec_path).read_text())
    config, traffic = spec["config"], spec["traffic"]
    seed, seconds = spec["seed"], spec["seconds"]
    mesh = make_mesh(device=spec["device"])
    dev = mesh.device
    if "calibrate" in spec:
        # rank 0's records of the check steps, seed by seed, with the
        # planted fault where the spec names one
        out = []
        for s, fault in spec["calibrate"]:
            _plant(fault)
            out.append(_check(config, traffic, s, mesh)[2])
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if mesh.rank == 0:
            with open(Path(spec["out"]) / "calibrate.pkl", "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
        return
    _plant(spec.get("fault"))
    prog, pool, rec = _check(config, traffic, seed, mesh)
    n_check = traffic["check_steps"]
    for i in range(traffic["warmup_steps"]):
        prog.step(pool[(n_check + i) % len(pool)])
    start = n_check + traffic["warmup_steps"]
    flag = torch.zeros(1, device=dev)

    def stop(elapsed):
        # rank 0's clock closes the window for every rank
        flag.fill_(float(elapsed >= seconds))
        dist.broadcast(flag, 0)
        return bool(flag.item())

    dist.barrier()
    steps, secs, enq, t0 = train.window(prog, pool, start, seconds, dev,
                                        stop)
    out = {"steps": steps, "seconds": secs, "enqueue_s": enq,
           "t_window": t0, "trace": None}
    if spec["trace"]:
        from benchmark.harness import trace as tr

        with tr.profiled(dev) as held:
            for i in range(traffic["trace_steps"]):
                prog.step(pool[(start + steps + i) % len(pool)])
        out["trace"] = held.trace
    out["peak"] = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    if mesh.rank == 0:
        out["record"] = rec
    dist.barrier()
    with open(Path(spec["out"]) / f"rank{mesh.rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def launch(cell: dict, spec: dict, device, work: Path):
    """Start one rank a card with ``spec`` and wait for all of them; a rank
    that fails, or outlives the traffic's ``rank_timeout_s``, fails the
    run."""
    ranks = cell["chips"]
    (work / "spec.json").write_text(json.dumps(spec))
    port = free_port()
    procs = []
    for r in range(ranks):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        if device.type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "benchmark.harness.dp",
             str(work / "spec.json")], cwd=str(common.ROOT), env=env))
    deadline = time.monotonic() + cell["traffic"]["rank_timeout_s"]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"rank exit codes {[p.returncode for p in procs]}")


def calibrate(cell: dict, seeds, device):
    """Rank 0's records of the check steps for each (seed, fault)."""
    work = Path(tempfile.mkdtemp(prefix="srgan_bench_dp_"))
    try:
        launch(cell, {"config": cell["config"], "traffic": cell["traffic"],
                      "seed": 0, "seconds": 0, "trace": False,
                      "out": str(work), "device": device.type,
                      "calibrate": list(seeds)}, device, work)
        with open(work / "calibrate.pkl", "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, readers, fault=None) -> tuple[dict, dict]:
    config, traffic = cell["config"], cell["traffic"]
    ranks = cell["chips"]
    B = config["train"]["batch_size"]
    work = Path(tempfile.mkdtemp(prefix="srgan_bench_dp_"))
    try:
        spec = {"config": config, "traffic": traffic, "seed": seed,
                "seconds": seconds, "trace": trace, "out": str(work),
                "device": device.type, "fault": fault}
        launch(cell, spec, device, work)
        outs = []
        for r in range(ranks):
            with open(work / f"rank{r}.pkl", "rb") as f:
                outs.append(pickle.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    o = outs[0]
    dev = common.device_record(device, ranks)
    dev["memory_peak_bytes"] = max(x["peak"] for x in outs)
    if trace:
        ctx = {"config": config, "chips": ranks,
               "device": device, "steps": o["steps"], "seconds": o["seconds"],
               "enqueue_s": o["enqueue_s"], "trace": o["trace"],
               "trace_steps": traffic["trace_steps"]}
        metrics = readers(ctx)
        attempted = o["steps"] + traffic["trace_steps"]
    else:
        metrics = {"train_img_per_s": {"value": o["steps"] * B
                                       / o["seconds"], "unit": "img/s"},
                   "setup_s": {"value": o["t_window"] - t_start, "unit": "s"}}
        attempted = o["steps"]
    ref = train.reference_check(config, traffic, seed, device)
    numbers = train.compare(o["record"], ref)
    correct, checks = common.judge(numbers, cell["limits"])
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and o["trace"] is not None:
        t = o["trace"]
        dev["busy_s"] = sum(x["trace"].busy_s for x in outs) / ranks
        dev["window_s"] = t.window_s
        result["breakdown"] = t.breakdown()
    return result, checks


if __name__ == "__main__":
    rank_main(sys.argv[1])
