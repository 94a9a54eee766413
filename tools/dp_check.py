"""Data parallel across the cards of one host (one rank a card, NCCL) against
one process, at the full width of 05_srgan_full.

    torchrun --standalone --nproc_per_node N tools/dp_check.py

Every rank draws the same seeded weights, draws and global batch (128
images, 128 / N a rank).  Rank 0 first takes one single-process step on
the whole batch on its card; then every rank takes the data-parallel step
on its rows, from the same weights and draws, and ``STEPS`` more, timed
with CUDA events.  Rank 0 holds the first data-parallel step's metrics
(``DP_TOL`` relative) and parameters (the Adam-sign-tolerant criterion of
``tests/test_torch_train.py``) to the single-process step's, and the
ranks' parameters to each other (bit-equal).  Three cases: instance norm
under ``grad_sync`` "auto" and "manual", batch norm under "auto" (its
moments summed over the ranks).  Each rank's launches of the training
kernels are counted around its first step.  Rank 0 prints one
JSON line per case and, last, one line with them all, the card's name and
power limit.  ``--device cpu`` (gloo) with ``--small`` rehearses it on
the CPU at 64 px, nch 8, batch 8, k 2.  Run from the repository root.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from srgan_tpu_torch.configs import PRESETS  # noqa: E402
from srgan_tpu_torch.parallel import make_mesh, shard_batch  # noqa: E402

CASES = (("instance", "auto"), ("instance", "manual"), ("batch", "auto"))
STEPS = 2
DP_TOL = cs.DP_TOL


def preset(norm_type: str, small: bool):
    cfg = PRESETS[cs.PRESET]()
    model = dict(norm_type=norm_type)
    if small:
        model.update(image_size=64, g_nch=8, d_nch=8, e_nch=8, g_res_num=1,
                     d_num_cls=2, e_num_cls=2)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=8, unrolled_k=2))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **model))


class Clock:
    """CUDA events on a card, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def time(self, fn):
        if not self.cuda:
            t0 = time.perf_counter()
            out = fn()
            return out, 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)


def gather(values, mesh):
    """Every rank's list of floats, on every rank (an all-reduce of a
    zero-filled table: gloo has no all_gather for CUDA tensors)."""
    table = torch.zeros((mesh.size, len(values)), dtype=torch.float64,
                        device=mesh.device)
    table[mesh.rank] = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(table)
    return table.cpu().tolist()


def run_case(norm_type, grad_sync, mesh, clock, small):
    cfg = preset(norm_type, small)
    B, k, ndim = cfg.train.batch_size, cfg.train.unrolled_k, cfg.model.ndim
    dev = mesh.device
    rng = np.random.default_rng(17)
    draws = [torch.from_numpy(rng.standard_normal((B, ndim))
                              .astype(np.float32)) for _ in range(k)]
    m = cfg.model
    src = rng.integers(0, m.n_classes, B)
    batch = dict(
        image=torch.from_numpy(rng.uniform(
            -1, 1, (B, m.image_size, m.image_size, m.nch_in))
            .astype(np.float32)),
        source_label=torch.from_numpy(src),
        target_label=torch.from_numpy(
            (src + rng.integers(1, m.n_classes, B)) % m.n_classes))
    ref = cs.InjectedTrainer(cfg, dev)
    state = ref.init_state(torch.Generator().manual_seed(0),
                           freeze_pretrained=True)
    start = {net: {key: v.detach().clone() for key, v in
                   getattr(state, net).state_dict().items()}
             for net in ("G", "D", "E")}
    hist_target = state.hist_target
    single = post = None
    with cs.deterministic_cudnn():
        if mesh.rank == 0:
            ref.draws, ref.draw_i = draws, 0
            metrics, single_ms = clock.time(lambda: ref.step(state, batch))
            single = {key: float(v) for key, v in metrics.items()}
            post = {net: {key: v.detach().cpu().clone() for key, v in
                          getattr(state, net).state_dict().items()}
                    for net in ("G", "D", "E")}
        del ref, state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        trainer = cs.InjectedTrainer(cfg, mesh=mesh, grad_sync=grad_sync)
        dstate = trainer.init_state(g_state=start["G"], d_state=start["D"],
                                    e_state=start["E"],
                                    hist_target=hist_target,
                                    freeze_pretrained=True)
        local = shard_batch(batch, mesh)
        local["image"] = local["image"].to(dev)
        times, counts = [], None
        for i in range(1 + STEPS):
            trainer.draws, trainer.draw_i = draws, 0
            before = cs.counts_now()
            metrics, ms = clock.time(lambda: trainer.step(dstate, local))
            times.append(ms)
            if i == 0:
                counts = cs.counts_since(before)
                dp = {key: float(v) for key, v in metrics.items()}
                first = {net: {key: v.detach().cpu().clone() for key, v in
                               getattr(dstate, net).state_dict().items()}
                         for net in ("G", "D", "E")}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else None
    flat = torch.cat([v.reshape(-1).float() for net in ("G", "D", "E")
                      for v in first[net].values()]).to(dev)
    ref0 = flat.clone()
    dist.broadcast(ref0, src=0)
    rank_diff = float((flat - ref0).abs().max())
    table = gather(times + [rank_diff, peak or 0.0]
                   + [float(c) for c in counts.values()], mesh)
    if mesh.rank != 0:
        return None
    cs.check(all(row[len(times)] == 0.0 for row in table),
             "a rank's parameters differ from rank 0's")
    want = cs.expected_counts(cfg, *cs_norms(cfg, dev))
    if dev.type != "cuda":
        want = {key: 0 for key in want}      # no kernel runs on the CPU
    for row in table:
        got = dict(zip(counts, (int(c) for c in row[len(times) + 2:])))
        cs.check(got == want, f"launches {got}, derived {want}")
    worst = max(abs(dp[key] - v) / max(abs(v), 1e-12)
                for key, v in single.items())
    cs.check(set(dp) == set(single), (sorted(dp), sorted(single)))
    cs.check(worst <= DP_TOL, f"{norm_type}/{grad_sync}: metrics "
             f"{worst:.2e} from one process")
    params = {net: cs.param_parity(first[net], post[net], n, net,
                                   bound_only=net == "G")
              for net, n in (("G", 2), ("D", k), ("E", 1))}
    return dict(norm_type=norm_type, grad_sync=grad_sync,
                ranks=mesh.size, backend=mesh.backend, global_batch=B,
                batch_per_rank=B // mesh.size, unrolled_k=k,
                single_step_ms=single_ms,
                rank_step_ms=[row[:len(times)] for row in table],
                rank_peak_mem_gib=[row[len(times) + 1] for row in table]
                if peak is not None else None,
                launches_per_rank_step=want, worst_rel_diff=worst,
                params=params, metrics_single=single, metrics_dp=dp)


def cs_norms(cfg, dev):
    """Norm kernels a G and an E forward in ``cfg``'s instance mode (0 in
    batch mode, whose norms are plain torch ops) on a CUDA device; the
    CPU runs no kernel."""
    if cfg.model.norm_type == "batch" or dev.type != "cuda":
        return 0, 0
    from srgan_tpu_torch.training import gan

    G = gan.build_generator(cfg, dev)
    E = gan.build_encoder(cfg, dev)
    shapes = cs.path_norm_shapes(G, E, cfg)
    return sum(shapes["G"].values()), sum(shapes["E"].values())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    mesh = make_mesh(args.device)
    cs.DEV = str(mesh.device)
    clock = Clock(mesh.device)
    card = cs.card_line() if mesh.device.type == "cuda" else "CPU, n/a"
    try:
        results = []
        for norm_type, grad_sync in CASES:
            rec = run_case(norm_type, grad_sync, mesh, clock, args.small)
            if rec is not None:
                rec.update(card=card)
                results.append(rec)
                print(json.dumps({"case": rec}), flush=True)
        if mesh.rank == 0:
            print(card, flush=True)
            print(json.dumps({"dp_check": dict(card=card, cases=[
                {key: r[key] for key in ("norm_type", "grad_sync", "ranks",
                                         "rank_step_ms", "worst_rel_diff",
                                         "rank_peak_mem_gib")}
                for r in results])}), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
