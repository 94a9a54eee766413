"""The training cells: ``GANTrainer.step`` back to back on a pool of seeded
batches resident on the device.

Set-up builds one trainer and its state from the benchmark's weights,
drives it through the pool's first ``check_steps`` batches with the
window's own call (recording what the comparison needs) and warms up; the
window then steps through the pool from where the check left off.  After
the window the program is freed and the plain reference repeats the check
steps from the same weights, batches and draws."""

from __future__ import annotations

import statistics
import sys
import time

import torch

from benchmark.harness import common
from benchmark.reference.losses import histogram_target

NETS = ("G", "D", "E")


def make_pool(config: dict, traffic: dict, seed: int, device):
    """``pool_batches`` batches drawn on the device from the seed: images
    U(-1, 1) (B, H, W, 3), source labels uniform over the domains, targets
    uniform over the other domains."""
    m, B = config["model"], config["train"]["batch_size"]
    hw, nc = m["image_size"], m["n_classes"]
    gen = torch.Generator(device).manual_seed(common.subseed(seed, 2))
    pool = []
    for _ in range(traffic["pool_batches"]):
        image = torch.rand((B, hw, hw, m["nch_in"]), generator=gen,
                           device=device) * 2 - 1
        src = torch.randint(0, nc, (B,), generator=gen, device=device)
        tgt = (src + torch.randint(1, nc, (B,), generator=gen,
                                   device=device)) % nc
        pool.append({"image": image, "source_label": src,
                     "target_label": tgt})
    return pool


def make_hist_target(config: dict, seed: int, device):
    gen = torch.Generator(device).manual_seed(common.subseed(seed, 3))
    return histogram_target(gen, device)


def draw_seed(seed: int) -> int:
    """The seed of the program's step generator, which the trainer seeds
    with its config's seed plus one."""
    return common.subseed(seed, 4) + 1


def _moments(nets: dict, opts: dict) -> dict:
    """Adam's first moment of every trained leaf, by net and name, on the
    host."""
    out = {}
    for k in NETS:
        state = opts[k].state
        out[k] = {n: state[p]["exp_avg"].detach().float().cpu().clone()
                  for n, p in nets[k].named_parameters() if p in state}
    return out


def _params(nets: dict) -> dict:
    return {k: {n: p.detach().float().cpu().clone()
                for n, p in nets[k].named_parameters()} for k in NETS}


def record_check(step, nets, opts, pool, n_steps: int, device) -> dict:
    """Drive ``step`` through the pool's first ``n_steps`` batches: the
    losses of each step, the first moments after the first, the parameters
    after the last."""
    rec = {"losses": []}
    for s in range(n_steps):
        metrics = step(pool[s])
        rec["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            rec["moments"] = _moments(nets, opts)
    common.sync(device)
    rec["params"] = _params(nets)
    return rec


class Program:
    """The program's trainer and state for a cell, built from the
    benchmark's weights, histogram target and seed; with a ``mesh``, one
    rank's."""

    def __init__(self, config: dict, seed: int, device, mesh=None):
        from srgan_tpu_torch.training.gan import GANTrainer

        cfg = common.port_config(config, draw_seed(seed) - 1)
        self.trainer = GANTrainer(cfg, device, mesh=mesh)
        g, d, e = common.make_weights(config, seed, device)
        self.state = self.trainer.init_state(
            g_state=g, d_state=d, e_state=e,
            hist_target=make_hist_target(config, seed, device),
            freeze_pretrained=config["pretrained_encoder"])
        st = self.state
        self.nets = {"G": st.G, "D": st.D, "E": st.E}
        self.opts = {"G": st.opt_g, "D": st.opt_d, "E": st.opt_e}

    def step(self, batch):
        return self.trainer.step(self.state, batch)


def reference_check(config: dict, traffic: dict, seed: int, device,
                    precision: str = "fp32") -> dict:
    """The plain reference's record of the check steps, from the same
    weights, target, batches and draws as the program's."""
    from benchmark.reference.step import Reference

    ref = Reference(config, common.make_weights(config, seed, device),
                    make_hist_target(config, seed, device), device,
                    draw_seed(seed), precision)
    pool = make_pool(config, traffic, seed, device)[:traffic["check_steps"]]
    nets = {"G": ref.G, "D": ref.D, "E": ref.E}
    rec = record_check(lambda b: ref.step(b["image"], b["source_label"],
                                          b["target_label"]),
                       nets, ref.optimizers(), pool, len(pool), device)
    # the reference nets hold no buffers: their state dicts are their
    # parameters, by name
    rec["initial"] = {k: {n: v.float().cpu() for n, v in sd.items()}
                      for k, sd in zip(NETS, common.make_weights(
                          config, seed, device))}
    return rec


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    """Over the nets' leaves: |‖prog leaf‖ - ‖ref leaf‖| over the larger of
    the reference leaf's norm and the median leaf norm of its net (inf for
    a leaf the program lacks)."""
    gaps = []
    for k in ref:
        names = [n for n in ref[k] if keep is None or keep(k, n)]
        if not names:
            continue
        rn = {n: float(ref[k][n].norm()) for n in names}
        med = statistics.median(rn.values())
        for n in names:
            if n not in prog[k]:
                gaps.append(float("inf"))
                continue
            gap = abs(float(prog[k][n].norm()) - rn[n])
            gaps.append(gap / max(rn[n], med, 1e-30))
    return gaps


def compare(prog: dict, ref: dict) -> dict:
    """loss_gap: the largest |program - reference| of a step's loss over
    the larger of the reference's |loss| and the step's median |loss|
    (``loss_gap_first``: the first step's alone, before any update has
    moved the weights; ``loss_gap_first_mean``: the mean over its
    losses);
    grad_gap: Adam's first moment after the first step, by the worst leaf;
    change_gap: the parameters' change over the check steps, by the worst
    leaf among those whose reference moment is at least a thousandth of
    its net's median (the others move by round-off alone); the ``_median``
    twins take the median leaf instead of the worst."""
    by_step = []
    for p, r in zip(prog["losses"], ref["losses"]):
        med = statistics.median(abs(v) for v in r.values())
        gaps = [abs(p.get(k, float("inf")) - rv) / max(abs(rv), med, 1e-30)
                for k, rv in r.items()]
        by_step.append([float("inf") if g != g else g for g in gaps])
    norms = {k: {n: float(v.norm()) for n, v in ref["moments"][k].items()}
             for k in NETS}
    meds = {k: statistics.median(v.values()) if v else 0.0
            for k, v in norms.items()}

    def moved(k, n):
        return n in norms[k] and norms[k][n] >= 1e-3 * meds[k]

    init = ref["initial"]
    delta = {side: {k: {n: rec["params"][k][n] - init[k][n]
                        for n in rec["params"][k]} for k in NETS}
             for side, rec in (("prog", prog), ("ref", ref))}
    grad = leaf_gaps(prog["moments"], ref["moments"])
    change = leaf_gaps(delta["prog"], delta["ref"], moved)
    return {"loss_gap": max(max(g) for g in by_step),
            "loss_gap_first": max(by_step[0]),
            "loss_gap_first_mean": statistics.fmean(by_step[0]),
            "grad_gap": max(grad),
            "grad_gap_median": statistics.median(grad),
            "change_gap": max(change),
            "change_gap_median": statistics.median(change)}


def window(prog: Program, pool, start: int, seconds: float, device,
           stop=None):
    """Step through the pool for ``seconds``: each step is launched before
    the one before it is waited for, and the window closes when the last
    launched step has finished.  ``stop(elapsed)`` decides the close where
    ranks must agree on it.  Returns (steps, seconds, host seconds inside
    ``step``, the window's start on the host clock)."""
    cuda = device.type == "cuda"
    steps, enqueue, prev = 0, 0.0, None
    stop = stop or (lambda elapsed: elapsed >= seconds)
    common.sync(device)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        prog.step(pool[(start + steps) % len(pool)])
        enqueue += time.perf_counter() - t
        steps += 1
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        if prev is not None:
            prev.synchronize()
        prev = ev
        if stop(time.perf_counter() - t0):
            break
    common.sync(device)
    return steps, time.perf_counter() - t0, enqueue, t0


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, readers) -> tuple[dict, dict]:
    """One run of a training cell.  Returns (result, checks)."""
    from benchmark.harness import trace as tr

    config, traffic = cell["config"], cell["traffic"]
    B = config["train"]["batch_size"]
    n_check = traffic["check_steps"]
    marks = [("start", time.perf_counter())]
    prog = Program(config, seed, device)
    pool = make_pool(config, traffic, seed, device)
    common.sync(device)
    marks.append(("program and pool", time.perf_counter()))
    rec = record_check(prog.step, prog.nets, prog.opts, pool, n_check, device)
    marks.append(("check steps", time.perf_counter()))
    for i in range(traffic["warmup_steps"]):
        prog.step(pool[(n_check + i) % len(pool)])
    common.sync(device)
    marks.append(("warm-up steps", time.perf_counter()))
    start = n_check + traffic["warmup_steps"]
    setup_s = time.perf_counter() - t_start
    print("set-up: imports and CUDA %.2f s, " % (marks[0][1] - t_start)
          + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                      in zip(marks, marks[1:])), file=sys.stderr)

    ctx = {"config": config, "chips": cell["chips"],
           "device": device}
    if not trace:
        steps, secs, _, _ = window(prog, pool, start, seconds, device)
        metrics = {"train_img_per_s": {"value": steps * B / secs,
                                       "unit": "img/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        attempted = steps
    else:
        k = traffic["trace_steps"]
        steps, secs, enq, _ = window(prog, pool, start, seconds, device)
        with tr.profiled(device) as held:
            for i in range(k):
                prog.step(pool[(start + steps + i) % len(pool)])
        ctx.update(steps=steps, seconds=secs, enqueue_s=enq,
                   trace=held.trace, trace_steps=k)
        attempted = steps + k
        metrics = None
    dev = common.device_record(device, cell["chips"])
    del prog, pool
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        metrics = readers(ctx)
    ref = reference_check(config, traffic, seed, device)
    numbers = compare(rec, ref)
    correct, checks = common.judge(numbers, cell["limits"])
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and ctx["trace"] is not None:
        t = ctx["trace"]
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = t.breakdown()
    return result, checks
