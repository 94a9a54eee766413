"""The ranks of ``tests/test_torch_parallel.py``: spawned processes that join
a gloo group through a ``file://`` rendezvous, run the port's collectives
and data-parallel train steps on their rows of a global batch, and save
what they computed for the test to hold against the JAX package.  This
module imports neither JAX nor ``srgan_tpu``, so a rank starts in about
the time torch takes to import."""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from srgan_tpu_torch.configs import config_from_dict
from srgan_tpu_torch.parallel import collectives as C
from srgan_tpu_torch.parallel import make_mesh, shard_batch
from srgan_tpu_torch.parallel.mesh import local_rows
from srgan_tpu_torch.training.gan import GANTrainer


class InjectedPort(GANTrainer):
    """Hands out the given draws, in order, at the step's seam."""

    def _draw_latent(self, shape):
        arr = self.draws[self.draw_i]
        self.draw_i += 1
        assert arr.shape == tuple(shape), (arr.shape, tuple(shape))
        return torch.from_numpy(arr)


def start(work: str, inputs, nprocs: int = 2):
    """Start ``_rank`` on ``nprocs`` spawned ranks over ``inputs`` (saved
    under ``work``); ``finish`` waits for them."""
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    ctx = torch.multiprocessing.start_processes(
        _rank, args=(work, nprocs), nprocs=nprocs, join=False,
        start_method="spawn")
    return ctx, work, nprocs, time.monotonic()


def finish(started, timeout: float = 120.0):
    """Each rank's output.  A rank that raises makes this raise; a rank
    still running ``timeout`` seconds after its start is killed and this
    raises ``TimeoutError``."""
    ctx, work, nprocs, t0 = started
    deadline = t0 + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a rank ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def _rank(rank: int, work: str, nprocs: int):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank))
    mesh = make_mesh("cpu", init_method="file://" + os.path.join(work,
                                                                 "rdzv"))
    try:
        inputs = torch.load(os.path.join(work, "inputs.pt"),
                            weights_only=False)
        out = dict(collectives=collectives(mesh, inputs["collectives"]),
                   steps={name: dp_step(mesh, case)
                          for name, case in inputs["steps"].items()})
        torch.save(out, os.path.join(work, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _value_and_grad(fn, *arrays):
    """fn's value on this rank's rows of the global arrays, and its
    gradient with respect to those rows (through the all-reduces'
    backward)."""
    xs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    v = fn(*xs)
    v.backward()
    return float(v.detach()), [x.grad.numpy().copy() for x in xs]


def collectives(mesh, d):
    """Every function of ``parallel/collectives.py`` on this rank's rows."""
    def rows(a):
        return np.ascontiguousarray(local_rows(a, mesh))

    mu, logvar, mask = rows(d["mu"]), rows(d["logvar"]), rows(d["mask"])
    target = torch.from_numpy(d["target"])
    weights = d["weights"]
    out = {
        "global_batch_kl": _value_and_grad(
            lambda m: C.global_batch_kl(m, d["n_batch"], mesh), mu),
        "global_corrcoef_loss": _value_and_grad(
            lambda m: C.global_corrcoef_loss(m, mesh), mu),
        "global_kl_loss": _value_and_grad(
            lambda m, lv: C.global_kl_loss(m, lv, mesh), mu, logvar),
        "global_histogram_imitation": _value_and_grad(
            lambda m: C.global_histogram_imitation(m, target, mesh), mu),
        "global_masked_lsgan_loss": _value_and_grad(
            lambda a, b: C.global_masked_lsgan_loss(
                [a, b], 1.0, torch.from_numpy(mask), mesh),
            *[rows(o) for o in d["outputs"]]),
        "global_diversification_loss": _value_and_grad(
            lambda m, lv: C.global_diversification_loss(
                m, lv, weights=weights, n_batch=d["n_batch"],
                hist_target=target, mesh=mesh)[0], mu, logvar),
    }
    return out


def dp_step(mesh, case):
    """One data-parallel step from the given weights, draws and global
    batch: the metrics and G, D and E's state dicts after it."""
    cfg = config_from_dict(case["config"])
    t = InjectedPort(cfg, device="cpu", mesh=mesh,
                     grad_sync=case["grad_sync"])
    t.draws, t.draw_i = case["draws"], 0
    state = t.init_state(g_state=case["g"], d_state=case["d"],
                         e_state=case["e"], hist_target=case["hist_target"],
                         freeze_pretrained=case["frozen"])
    metrics = t.step(state, shard_batch(case["batch"], mesh))
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                draws_used=t.draw_i,
                **{name: {k: v.detach().clone() for k, v in
                          getattr(state, name).state_dict().items()}
                   for name in ("G", "D", "E")})
