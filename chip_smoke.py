#!/usr/bin/env python3
"""Smoke run of srgan_tpu_torch on one NVIDIA Hopper GPU (sm_90a).

    python3 chip_smoke.py

from the root of a checkout; no install step, no argument.  Phases:

  1. the card, torch and CUDA versions; TF32 off for every phase;
  2. build the CUDA kernels (plain nvcc, one process per source, all
     started together; loaded with ctypes);
  3. the conditional-instance-norm forward kernel against its plain
     PyTorch twin on the card, at every (C, H, W) the model path gives it,
     batch 8, fp32 and bf16, ReLU on and off;
  4. the serving path at the full width of preset 05_srgan_full (128 px,
     g_nch 64, g_res_num 6, e_nch 64, e_num_cls 4, fp32), random weights
     from a seeded torch.Generator saved and loaded back through the
     Translator's weights dir: translate N = 1, 8, 40 and encode N = 8
     through the npz request dispatch, with the kernel's launch count read
     around those requests, and one batch-8 forward checked against the
     same model with the plain norm forced;
  5. CUDA-event timings of the forward kernel, its plain twin and
     F.instance_norm (timed as a yardstick, never called by the port) at
     those shapes, and translate throughput at batch 32;
  6. the training slice's kernels against their plain twins on the card:
     the norm backward at every path shape (batch 8, fp32 and bf16, ReLU on
     and off), at every tier and edge of its plan (batch 1, planes that do
     not fill a block, plane lengths that are not a multiple of 4, clusters
     of 2, 4 and 8 blocks, a plane above the register tiers, an unaligned
     view), without affine, twice for the same bits, and its dg and db
     against the plain backward in float64; the soft histogram forward and
     backward at the main path's mu (128, 8) with 50 bins and at four more
     (B, D, bins), batch 4,096 among them, each called twice for the same
     bits; the fused diversification loss at six (B, D, bins), from the
     main path's (128, 8, 50) to batch 4,096 and 20 dimensions, each
     called twice for the same bits and held, like its plain fp32 twin,
     against the same composition in float64;
  7. the gradient repair: a G + E + D forward and backward at batch 8
     through the kernels against the same models with the plain norm
     forced, every parameter's gradient compared;
  8. the train step of 05_srgan_full at full width (batch 128, k = 5, the
     proposed loss stack, frozen encoder trunk, fp32): 1 warm and 3 timed
     steps with every metric printed and finite and every kernel's launches
     per step checked against the count derived from the code; one step
     under torch.profiler; one step with SRGAN_TPU_FUSED_DIV=1 against the
     unfused one; a bf16 step, and one more under torch.profiler;
  9. CUDA-event timings of every kernel at the shapes of one train step,
     the norms in fp32 and bf16, beside its bound, its plain twin and,
     where one exists, the PyTorch call that computes the same function;
     the small kernels also beside an empty launch timed the same way
     (floor_ms) and at batch 4,096, the fused diversification kernel also
     at batch 2, and its backward (autograd of the plain composition) with
     its device operations counted.

Without CUDA it raises before printing a result.  It starts no server and
no thread; its only subprocesses are nvidia-smi and nvcc, both with a
timeout.  Before the last line it prints the `kernels`, `training` and
`serving` JSON lines; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from srgan_tpu_torch.configs import PRESETS  # noqa: E402
from srgan_tpu_torch.ops import (  # noqa: E402
    build,
    diversification,
    histogram,
    norm,
)
from srgan_tpu_torch.ops import losses as L  # noqa: E402
from srgan_tpu_torch.serving import (  # noqa: E402
    Translator,
    decode_npz,
    encode_npz,
    handle_request,
)
from srgan_tpu_torch.training import gan  # noqa: E402

PRESET = "05_srgan_full"
DEV = "cuda"
WARM = (1, 8, 32)
TRANSLATE_N = (1, 8, 40)
ENCODE_N = 8
TIMING_BATCH = 32
CHECK_BATCH = 8
TIMED_STEPS = 3
# fp32: both sides compute in fp32, sums in another order; bf16: about two
# bf16 ulps at |y| <= 4, both outputs compared in fp32
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
MODEL_TOL = 1e-4
# the training kernels against their plain twins, relative to the largest
# entry of the plain result: fp32 sums in another order
REL_TOL = 1e-4
# a model's parameter gradients through the kernels against the plain norm
# (and against the plain norm computed in float64), per tensor, as
# ||a - b|| / ||b||, with cuDNN deterministic: each norm call agrees with
# its plain twin to about 1e-7 on the model's own data (checked call by
# call), but at this random init the gradients of the CBINorm biases and
# conditional biases are sums over a plane of nearly cancelling terms, so
# either fp32 path lands up to about 6e-3 from the float64 reference
# (measured on the card)
GRAD_TOL = 1e-2
# the metrics of one step with the fused diversification kernel against one
# without it, from the same weights, draws and batch, cuDNN deterministic,
# relative: the fused kernel's 1e-7-level difference, carried through
# Adam's first steps (about lr * sign(grad)) into the later losses
STEP_TOL = 1e-3
# H100 SXM, NVIDIA's data sheet: HBM rate and fp32 rate outside the tensor
# cores, at the full 700 W power limit
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
# per element: sum (1 add), sum of squares (1 fma), apply (1 fma)
FLOPS_PER_ELEM = 5
# backward, per element: two passes of the mask and xhat (4), the two sums
# (3), dx (4)
BWD_FLOPS_PER_ELEM = 11
# soft histogram, per (sample, dim, bin): difference, divide, square, exp,
# accumulate (forward); and the backward's extra multiplies (-w z / sigma g)
HIST_OPS = 5
HIST_BWD_OPS = 9
# (B, D, bins) of phase 6's histogram checks: the main path's shape first,
# then batch 1, a ragged shape (neither 32 nor a block of 8 divides B, D or
# bins), more bins, and a batch larger than one 2,048-sample shared-memory
# chunk of the forward
HIST_SHAPES = ((128, 8, 50), (1, 8, 50), (37, 3, 7), (128, 8, 128),
               (4096, 8, 50))
HIST_LARGE_B = HIST_SHAPES[-1][0]
# (B, D, bins) of phase 6's fused-diversification checks: the main path's
# shape first, then batch 2 (the least the kernel takes), a ragged shape,
# more bins, more dimensions (20) than a cluster has blocks (8), and a
# batch above the 1,476 that the old one-block kernel's 48 KB of shared
# memory took
DIV_SHAPES = ((128, 8, 50), (2, 8, 50), (37, 3, 7), (128, 8, 128),
              (128, 20, 50), (4096, 8, 50))
# timed calls take turns over copies of their inputs until the copies hold
# this many bytes of x and dy: three times the H100's 50 MB L2
L2_FLUSH_BYTES = 150e6
# device-side sleep (in clock cycles) ahead of a timed loop, long enough
# for the host to queue the whole loop behind it
SLEEP_CYCLES = 100_000_000
KERNELS = {
    "cbinorm_fwd": dict(
        source="srgan_tpu_torch/csrc/cbinorm.cu",
        replaces="srgan_tpu/ops/pallas/norm.py:86 (_fused_fwd; kernel "
                 "_fwd_kernel :37)"),
    "cbinorm_bwd": dict(
        source="srgan_tpu_torch/csrc/cbinorm.cu",
        replaces="srgan_tpu/ops/pallas/norm.py:139 (_cbinorm_bwd, jnp on "
                 "the TPU)"),
    "soft_histogram_fwd": dict(
        source="srgan_tpu_torch/csrc/histogram.cu",
        replaces="srgan_tpu/ops/pallas/histogram.py:72 (_fwd; kernel "
                 "_fwd_kernel :35)"),
    "soft_histogram_bwd": dict(
        source="srgan_tpu_torch/csrc/histogram.cu",
        replaces="srgan_tpu/ops/pallas/histogram.py:89 (_bwd_rule; kernel "
                 "_bwd_kernel :49)"),
    "diversification_fwd": dict(
        source="srgan_tpu_torch/csrc/diversification.cu",
        replaces="srgan_tpu/ops/pallas/diversification.py:106 (_fwd; "
                 "kernel _fused_kernel :38)"),
}


def check(ok: bool, what):
    """A check that also holds under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warm: int = 3):
    """(device ms, host ms) per call of ``fn``.  The timed calls are queued
    behind a device-side sleep, so the device runs them back to back and the
    CUDA events see device time only; the host clock around the same loop
    gives what each call costs the host to issue."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, 1e3 * host_s / iters


def wall_ms(fn, iters: int = 10) -> float:
    """Host-clock ms per call of ``fn``, synchronised at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the fp32 rate."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = ops / PEAK_FP32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def bound_ms(B, C, H, W, itemsize: int = 4):
    """Least time for one forward launch: each input read once (x, t, g,
    b), each output written once (y, mu, rstd)."""
    n = B * C * H * W
    return bound(2 * n * itemsize + 4 * (3 * B * C + 2 * C),
                 FLOPS_PER_ELEM * n)


def bwd_bound_ms(B, C, H, W, itemsize: int = 4):
    """Least time for one backward launch: x and dy read once, dx written
    once; t, g, b, mu, rstd read and dt, dg, db written once."""
    n = B * C * H * W
    return bound(3 * n * itemsize + 4 * (4 * B * C + 4 * C),
                 BWD_FLOPS_PER_ELEM * n)


def norm_inputs(gen, B, C, H, W, dtype):
    # |y| stays below 4: |x_hat| <= sqrt(3) for uniform x
    x = ((torch.rand((B, C, H, W), generator=gen, device=DEV) * 2 - 1) * 3
         + 0.5).to(dtype)
    t = torch.tanh(torch.randn((B, C), generator=gen, device=DEV))
    g = 0.8 + 0.4 * torch.rand((C,), generator=gen, device=DEV)
    b = 0.4 * torch.rand((C,), generator=gen, device=DEV) - 0.2
    return x, t, g, b


def path_norm_shapes(G, E, cfg):
    """(C, H, W) -> launches per forward, for one generator and one encoder
    forward, recorded from the models themselves at batch 1."""
    seen = {"G": {}, "E": {}}
    which = [None]
    real = norm.fused_cbinorm

    def recording(x, *a, **k):
        key = tuple(x.shape[1:])
        seen[which[0]][key] = seen[which[0]].get(key, 0) + 1
        return real(x, *a, **k)

    hw = cfg.model.image_size
    x = torch.zeros((1, cfg.model.nch_in, hw, hw), device=DEV)
    c = torch.zeros((1, cfg.model.num_con), device=DEV)
    norm.fused_cbinorm = recording
    try:
        with torch.inference_mode():
            which[0] = "G"
            G(x, c)
            which[0] = "E"
            E(x)
    finally:
        norm.fused_cbinorm = real
    return seen


class plain_norm:
    """Within the block every norm is ``cbinorm_plain`` under plain
    autograd: the models as they would run without the kernels."""

    def __enter__(self):
        self.real = norm.fused_cbinorm
        norm.fused_cbinorm = lambda *a, **k: norm.cbinorm_plain(*a, **k)

    def __exit__(self, *exc):
        norm.fused_cbinorm = self.real


def forward_with_plain_norm(fn):
    with plain_norm(), torch.inference_mode():
        return fn()


def reset_counts():
    norm.LAUNCHES = norm.BWD_LAUNCHES = 0
    histogram.LAUNCHES = histogram.BWD_LAUNCHES = 0
    diversification.LAUNCHES = 0


def read_counts():
    return {"cbinorm_fwd": norm.LAUNCHES, "cbinorm_bwd": norm.BWD_LAUNCHES,
            "soft_histogram_fwd": histogram.LAUNCHES,
            "soft_histogram_bwd": histogram.BWD_LAUNCHES,
            "diversification_fwd": diversification.LAUNCHES}


def rel_err(got, want) -> float:
    scale = float(want.float().abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


def bf16_ulps_ok(got, want) -> bool:
    """Every element within two bf16 ulps of the fp32-computed reference,
    plus 1e-5 of the largest entry for results that cancel to near 0."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(1e-30))) - 7)
    floor = 1e-5 * float(want.abs().max())
    return bool(((got - want).abs() <= 2 * ulp + floor).all())


# ---------------------------------------------------------------------------
# phases 3-5: the serving slice
# ---------------------------------------------------------------------------

def serving_phases(cfg, name, power_limit):
    m = cfg.model
    gen = torch.Generator().manual_seed(0)
    G = gan.build_generator(cfg, DEV, gen)
    E = gan.build_encoder(cfg, DEV, gen)
    say(f"== phase 3: kernel vs plain on the card, batch {CHECK_BATCH}, at "
        f"the norm shapes of {PRESET}")
    shapes = path_norm_shapes(G, E, cfg)
    g_per_fwd = sum(shapes["G"].values())
    e_per_fwd = sum(shapes["E"].values())
    # the down CBINorms, 2 per residual block, the up path's plain norms
    check(g_per_fwd == (m.g_num_cls + 1) + 2 * m.g_res_num + m.g_num_cls,
          shapes)
    check(e_per_fwd == 2 * m.e_num_cls, shapes)
    say(f"norm launches per forward: G {g_per_fwd} {shapes['G']}, "
        f"E {e_per_fwd} {shapes['E']}")
    cgen = torch.Generator(device=DEV).manual_seed(1)
    all_shapes = sorted(set(shapes["G"]) | set(shapes["E"]))
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for (C, H, W) in all_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for relu in (False, True):
                x, t, g, b = norm_inputs(cgen, CHECK_BATCH, C, H, W, dtype)
                out, mu, r = norm.fused_cbinorm(x, t, g, b, 1e-5, relu)
                torch.cuda.synchronize()
                p_out, p_mu, p_r = norm.cbinorm_plain(x, t, g, b, 1e-5, relu)
                err = (out.float() - p_out.float()).abs().max().item()
                err_mu = (mu - p_mu).abs().max().item()
                err_r = ((r - p_r) / p_r).abs().max().item()
                say(f"cbinorm C={C} H={H} W={W} {str(dtype)[6:]} "
                    f"relu={relu}: max|out-plain| {err:.3e} "
                    f"(tol {TOL[dtype]:g}), max|mu-plain| {err_mu:.3e}, "
                    f"max rel rstd {err_r:.3e}")
                check(err <= TOL[dtype] and err_mu <= TOL[torch.float32]
                      and err_r <= TOL[torch.float32],
                      f"kernel disagrees with plain at {(C, H, W)} {dtype} "
                      f"relu={relu}")
                max_err[dtype] = max(max_err[dtype], err)

    say(f"== phase 4: the serving path of {PRESET} through handle_request")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wdir:
        torch.save(G.state_dict(), os.path.join(wdir, "generator.pth"))
        torch.save(E.state_dict(), os.path.join(wdir, "encoder.pth"))
        del G, E
        tr = Translator(cfg, wdir, device=DEV, warm_batch_sizes=WARM)
    say(f"Translator up (random weights saved, loaded back, warmed at "
        f"{WARM}) in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    hw = m.image_size
    n_max = max(TRANSLATE_N)
    images = rng.uniform(-1, 1, (n_max, hw, hw, m.nch_in)).astype(np.float32)
    labels = rng.integers(0, m.n_classes, n_max)
    chunk = max(WARM)
    reset_counts()
    for n in TRANSLATE_N:
        before = norm.LAUNCHES
        code, body = handle_request(tr, "/translate", encode_npz(
            images=images[:n], target_labels=labels[:n], seed=n))
        check(code == 200, body[:2000])
        out = decode_npz(body)
        fakes = out["fakes"]
        check(fakes.shape == (n, hw, hw, m.nch_in), fakes.shape)
        check(out["latent"].shape == (n, m.ndim), out["latent"].shape)
        check(np.isfinite(fakes).all() and np.abs(fakes).max() <= 1.0,
              "fakes not finite or outside [-1, 1]")
        chunks = math.ceil(n / chunk)
        got = norm.LAUNCHES - before
        check(got == g_per_fwd * chunks, (n, got))
        say(f"translate N={n}: {chunks} chunk(s), {got} launches "
            f"({g_per_fwd} per G chunk), fakes in "
            f"[{fakes.min():.3f}, {fakes.max():.3f}]")
    before = norm.LAUNCHES
    code, body = handle_request(tr, "/encode",
                                encode_npz(images=images[:ENCODE_N]))
    check(code == 200, body[:2000])
    enc = decode_npz(body)
    check(enc["mu"].shape == enc["logvar"].shape == (ENCODE_N, m.ndim),
          enc["mu"].shape)
    check(np.isfinite(enc["mu"]).all() and np.isfinite(enc["logvar"]).all(),
          "encoder output not finite")
    got = norm.LAUNCHES - before
    check(got == e_per_fwd * math.ceil(ENCODE_N / chunk), got)
    serving_launches = read_counts()
    check(serving_launches["cbinorm_bwd"] == 0, serving_launches)
    launches = norm.LAUNCHES
    say(f"encode N={ENCODE_N}: {got} launches ({e_per_fwd} per E chunk); "
        f"serving path total {launches} launches")

    x8 = torch.from_numpy(images[:8]).to(DEV).permute(0, 3, 1, 2) \
        .contiguous()
    c8 = torch.cat([gan.onehot(labels[:8], m.n_classes),
                    torch.randn((8, m.ndim), generator=gen)], 1).to(DEV)
    with torch.inference_mode():
        g_k = tr.G(x8, c8)
        e_k = tr.E(x8)
    g_p = forward_with_plain_norm(lambda: tr.G(x8, c8))
    e_p = forward_with_plain_norm(lambda: tr.E(x8))
    g_err = (g_k - g_p).abs().max().item()
    e_err = max((a - b).abs().max().item() for a, b in zip(e_k, e_p))
    say(f"batch-8 G forward, kernel vs plain norm: max abs {g_err:.3e}; "
        f"E heads: {e_err:.3e} (tol {MODEL_TOL:g})")
    check(g_err <= MODEL_TOL and e_err <= MODEL_TOL,
          "model output with the kernel disagrees with the plain norm")

    say(f"== phase 5: timing at batch {TIMING_BATCH} (CUDA events around "
        "calls queued behind a device sleep: device time; the kernel is "
        "timed with t=0, g=1, b=0, no ReLU, so that F.instance_norm computes "
        "the same function; the kernel's work does not depend on those "
        "values)")
    B = TIMING_BATCH
    rows = []
    for (C, H, W) in all_shapes:
        uses = shapes["G"].get((C, H, W), 0) + shapes["E"].get((C, H, W), 0)
        x = torch.randn((B, C, H, W), generator=cgen, device=DEV)
        t = torch.zeros((B, C), device=DEV)
        g = torch.ones((C,), device=DEV)
        b = torch.zeros((C,), device=DEV)
        k_ms, k_host_ms = cuda_ms(lambda: norm.fused_cbinorm(x, t, g, b))
        p_ms, _ = cuda_ms(lambda: norm.cbinorm_plain(x, t, g, b))
        l_ms, _ = cuda_ms(lambda: F.instance_norm(x, eps=1e-5))
        bd_ms, bd_by = bound_ms(B, C, H, W)
        rows.append(dict(C=C, H=H, W=W, B=B, uses_per_request=uses,
                         kernel_ms=k_ms, kernel_host_ms=k_host_ms,
                         plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=bd_ms, bound_by=bd_by,
                         card=name, power_limit=power_limit))
        say(json.dumps({"kernel_shape": rows[-1]}))

    def per_request(key):
        return sum(r[key] * r["uses_per_request"] for r in rows)

    serving = dict(preset=PRESET, tf32=False, card=name,
                   power_limit=power_limit, launches=launches,
                   norm_ms_per_g_plus_e=per_request("kernel_ms"),
                   norm_plain_ms_per_g_plus_e=per_request("plain_ms"),
                   norm_library_ms_per_g_plus_e=per_request("library_ms"),
                   norm_bound_ms_per_g_plus_e=per_request("bound_ms"),
                   norm_max_abs_err_fp32=max_err[torch.float32],
                   norm_max_abs_err_bf16=max_err[torch.bfloat16])
    for n in (1, B):
        xg = torch.from_numpy(images[:n]).to(DEV).permute(0, 3, 1, 2) \
            .contiguous()
        cg = torch.cat([gan.onehot(labels[:n], m.n_classes),
                        torch.randn((n, m.ndim), generator=gen)], 1).to(DEV)
        with torch.inference_mode():
            g_ms, g_host_ms = cuda_ms(lambda: tr.G(xg, cg), iters=10)
            e_ms, _ = cuda_ms(lambda: tr.E(xg), iters=10)
            g_wall = wall_ms(lambda: tr.G(xg, cg))
            e_wall = wall_ms(lambda: tr.E(xg))
        t_ms = wall_ms(lambda: tr.translate(images[:n], labels[:n], seed=0),
                       iters=5)
        serving[f"batch_{n}"] = dict(
            translate_ms=t_ms, translate_img_s=1e3 * n / t_ms,
            g_forward_device_ms=g_ms, g_forward_wall_ms=g_wall,
            g_forward_host_issue_ms=g_host_ms,
            e_forward_device_ms=e_ms, e_forward_wall_ms=e_wall)
    b_row = serving[f"batch_{B}"]
    b_row["norm_share_of_g_plus_e_device"] = serving[
        "norm_ms_per_g_plus_e"] / (b_row["g_forward_device_ms"]
                                   + b_row["e_forward_device_ms"])
    serving["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del tr
    return shapes, all_shapes, max_err, serving


# ---------------------------------------------------------------------------
# phases 6-9: the training slice
# ---------------------------------------------------------------------------

def check_bwd_call(x, t, g, b, dy, relu, what):
    """One backward launch on (x, t, g, b, dy) against its plain twin, the
    mask taken from the forward kernel's output: fp32 every output within
    REL_TOL of the largest entry; bf16 dx within two bf16 ulps.  Returns
    (max |dx - plain|, the kernel's outputs, the forward's mu and rstd)."""
    y, mu, r = norm.cbinorm_fwd(x, t, g, b, 1e-5, relu)
    got = norm.cbinorm_bwd(x, t, g, b, mu, r, dy, relu)
    torch.cuda.synchronize()
    # the mask is the forward kernel's y > 0, which the backward kernel
    # recomputes bit for bit; the plain twin's own (xhat + t) g + b can
    # round the other way where y is ~1e-7
    dy_m = dy * (y > 0) if relu else dy
    want = norm.cbinorm_bwd_plain(x, t, g, b, mu, r, dy_m, False)
    rels = [rel_err(a, w) for a, w in zip(got, want)]
    dx_abs = float((got[0].float() - want[0].float()).abs().max())
    if x.dtype == torch.float32:
        ok = all(e <= REL_TOL for e in rels)
    else:
        ok = bf16_ulps_ok(got[0], want[0]) and all(
            e <= REL_TOL for e in rels[1:])
    B, C, H, W = x.shape
    aligned = all(v.data_ptr() % 16 == 0 for v in (x, dy))
    plan = norm.bwd_plan(H * W, x.element_size(), aligned)
    say(f"cbinorm_bwd {what} B={B} C={C} H={H} W={W} {str(x.dtype)[6:]} "
        f"relu={relu} plan {plan}: max|dx-plain| {dx_abs:.3e}, rel "
        + ", ".join(f"{n} {e:.2e}" for n, e in zip(("dx", "dt", "dg", "db"),
                                                    rels)))
    check(ok, f"backward kernel disagrees with plain at {what} "
              f"{(B, C, H, W)} {x.dtype} relu={relu}")
    return dx_abs, got, mu, r


# the tiers and edges of the backward kernel beyond the path shapes at
# batch 8: (what, B, C, H, W)
BWD_EDGES = (
    ("batch 1, cluster of 4", 1, 64, 128, 128),
    ("batch 1, warp tier", 1, 256, 32, 32),
    ("batch 1, 2 a lane", 1, 512, 7, 7),
    ("15 planes, 8 a block", 3, 5, 15, 15),
    ("15 planes, 2 a lane", 3, 5, 8, 8),
    ("cluster of 2, scalar", 2, 3, 65, 65),
    ("cluster of 4, scalar", 2, 3, 127, 127),
    ("cluster of 8, scalar", 2, 4, 181, 181),
    ("above the register tiers: two passes", 2, 64, 256, 256),
)
# dg and db against the plain backward computed in float64, relative to the
# largest entry: fp32 sums of up to 8 x 16384 terms of either sign, in a
# fixed order; the plain fp32 twin is measured beside it
DGDB_TOL = 1e-5


def check_norm_bwd(all_shapes, cgen):
    """Phase 6, the norm backward: every path shape at batch 8 (fp32 and
    bf16, ReLU on and off), every tier and edge, an unaligned input, the
    no-affine call, run-to-run bits, and dg/db against float64.  Returns
    (max |dx - plain| fp32, bf16, dg/db distance to float64)."""
    errs = [0.0, 0.0]
    cases = [("path", CHECK_BATCH) + s for s in all_shapes] + list(BWD_EDGES)
    for what, B, C, H, W in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for relu in (False, True):
                x, t, g, b = norm_inputs(cgen, B, C, H, W, dtype)
                dy = torch.randn(x.shape, generator=cgen, device=DEV) \
                    .to(dtype)
                e = check_bwd_call(x, t, g, b, dy, relu, what)[0]
                k = 0 if dtype == torch.float32 else 1
                errs[k] = max(errs[k], e)

    # a view one element into its buffer: no 16-byte access is possible
    B, C, H, W = CHECK_BATCH, 256, 32, 32
    buf = torch.randn(B * C * H * W + 1, generator=cgen, device=DEV)
    x = buf[1:].view(B, C, H, W)
    _, t, g, b = norm_inputs(cgen, B, C, H, W, torch.float32)
    dy = torch.randn(x.shape, generator=cgen, device=DEV)
    check(norm.bwd_plan(H * W, 4, aligned=False)[2] == 1, "unaligned plan")
    check_bwd_call(x, t, g, b, dy, True, "unaligned view")

    # without affine the call writes dx alone, the same bits as with it;
    # and the same call twice gives the same bits
    for (C, H, W) in ((64, 128, 128), (256, 32, 32), (512, 7, 7)):
        x, t, g, b = norm_inputs(cgen, CHECK_BATCH, C, H, W, torch.float32)
        dy = torch.randn(x.shape, generator=cgen, device=DEV)
        _, mu, r = norm.cbinorm_fwd(x, t, g, b, 1e-5, True)
        full = norm.cbinorm_bwd(x, t, g, b, mu, r, dy, True)
        again = norm.cbinorm_bwd(x, t, g, b, mu, r, dy, True)
        alone = norm.cbinorm_bwd(x, t, g, b, mu, r, dy, True, affine=False)
        torch.cuda.synchronize()
        check(all(v is None for v in alone[1:]),
              "the no-affine call returned more than dx")
        check(torch.equal(alone[0], full[0]),
              f"no-affine dx differs from affine dx at {(C, H, W)}")
        check(all(torch.equal(a, b_) for a, b_ in zip(full, again)),
              f"two calls gave different bits at {(C, H, W)}")
    say("cbinorm_bwd without affine: dx alone, equal bit for bit to the "
        "affine call's; two calls equal bit for bit")

    # dg and db alone against float64 (the mask from the forward kernel)
    worst = {"kernel": 0.0, "plain_fp32": 0.0}
    for (C, H, W) in all_shapes:
        for relu in (False, True):
            x, t, g, b = norm_inputs(cgen, CHECK_BATCH, C, H, W,
                                     torch.float32)
            dy = torch.randn(x.shape, generator=cgen, device=DEV)
            y, mu, r = norm.cbinorm_fwd(x, t, g, b, 1e-5, relu)
            got = norm.cbinorm_bwd(x, t, g, b, mu, r, dy, relu)
            dy_m = dy * (y > 0) if relu else dy
            plain = norm.cbinorm_bwd_plain(x, t, g, b, mu, r, dy_m, False)
            want = norm.cbinorm_bwd_plain(*(v.double() for v in (
                x, t, g, b, mu, r, dy_m)), False)
            for i in (2, 3):
                worst["kernel"] = max(worst["kernel"],
                                      rel_err(got[i], want[i]))
                worst["plain_fp32"] = max(worst["plain_fp32"],
                                          rel_err(plain[i], want[i]))
    say(f"cbinorm_bwd dg, db vs the plain backward in float64 at every path "
        f"shape, batch {CHECK_BATCH}, ReLU on and off, relative to the "
        f"largest entry: kernel {worst['kernel']:.2e}, plain fp32 twin "
        f"{worst['plain_fp32']:.2e} (tol {DGDB_TOL:g})")
    check(worst["kernel"] <= DGDB_TOL, "dg/db far from float64")
    return errs, worst


def check_histogram(cgen):
    """Both soft-histogram kernels against their plain twins at every
    ``HIST_SHAPES`` entry, each called twice for the same bits.  Returns
    {kernel: [max abs error at the main path's shape, None]} and, per
    kernel, the relative error at every shape."""
    errs = {"soft_histogram_fwd": [None, None],
            "soft_histogram_bwd": [None, None]}
    by_shape = {kn: {} for kn in errs}
    for B, D, bins in HIST_SHAPES:
        mu = (torch.randn((B, D), generator=cgen, device=DEV) * 1.5 + 0.1)
        gh = torch.randn((D, bins), generator=cgen, device=DEV)
        h = histogram.soft_histogram_fwd(mu, bins)
        h2 = histogram.soft_histogram_fwd(mu, bins)
        dmu = histogram.soft_histogram_bwd(mu, gh, bins)
        dmu2 = histogram.soft_histogram_bwd(mu, gh, bins)
        torch.cuda.synchronize()
        h_p = histogram.soft_histogram_cols_plain(mu, bins)
        dmu_p = histogram.soft_histogram_cols_bwd_plain(mu, gh, bins)
        e_h, e_d = rel_err(h, h_p), rel_err(dmu, dmu_p)
        same = torch.equal(h, h2) and torch.equal(dmu, dmu2)
        say(f"soft histogram mu ({B}, {D}), {bins} bins: forward rel "
            f"{e_h:.2e}, backward rel {e_d:.2e} (tol {REL_TOL:g}); "
            f"repeat bit-equal: {same}")
        check(e_h <= REL_TOL and e_d <= REL_TOL,
              f"histogram kernels disagree at ({B}, {D}, {bins})")
        check(same, f"histogram kernels do not repeat at ({B}, {D}, {bins})")
        key = f"{B}x{D}x{bins}"
        by_shape["soft_histogram_fwd"][key] = e_h
        by_shape["soft_histogram_bwd"][key] = e_d
        if (B, D, bins) == HIST_SHAPES[0]:
            errs["soft_histogram_fwd"][0] = float((h - h_p).abs().max())
            errs["soft_histogram_bwd"][0] = float((dmu - dmu_p).abs().max())
    return errs, by_shape


def diversification64(mu, target, n_cfg, bins, vmin=-10.0, vmax=10.0,
                      sigma=0.2):
    """[batch_kl, corr, hist] of ``diversification_plain``'s composition
    computed in float64 (the plain losses cast to fp32, so the formulas are
    written out here once more)."""
    x, t = mu.double(), target.double()
    B, D = x.shape
    m = x.mean(dim=0)
    xc = x - m
    cov = xc.T @ xc / (B - 1)
    var = torch.diagonal(cov)
    v = var * n_cfg / (n_cfg - 1)
    bkl = -0.5 * torch.sum(1.0 + torch.log(v) - m ** 2 - v)
    std = torch.sqrt(var)
    r = torch.clamp(cov / std[None, :] / std[:, None], -1.0, 1.0)
    eye = torch.eye(D, dtype=torch.float64, device=x.device)
    corr = torch.sum(torch.abs(r - eye)) / (D * (D - 1))
    delta = (vmax - vmin) / bins
    c = vmin + delta * (torch.arange(bins, dtype=torch.float64,
                                     device=x.device) + 0.5)
    z = (x.T[:, None, :] - c[None, :, None]) / sigma      # (D, bins, B)
    h = torch.exp(-0.5 * z * z).sum(dim=2) * delta / (
        sigma * math.sqrt(2 * math.pi))
    p = h / h.sum(dim=1, keepdim=True) + 1e-8
    hist = torch.sum(t[None, :] * (torch.log(t)[None, :] - torch.log(p)))
    return torch.stack([bkl, corr, hist])


def per_output_rel(got, want) -> float:
    return float(((got.double() - want.double()).abs()
                  / want.double().abs()).max())


def check_diversification(cgen):
    """The fused diversification kernel against its plain twin at every
    ``DIV_SHAPES`` entry, each called twice for the same bits, and both
    against the composition in float64.  Returns the max abs error at the
    main path's shape and, by shape, the kernel's relative error, the plain
    fp32 twin's and the kernel's distance to float64, and the plan's K."""
    by_shape = {}
    main_err = None
    for B, D, bins in DIV_SHAPES:
        mu = (torch.randn((B, D), generator=cgen, device=DEV) * 1.5 + 0.1)
        target = L.histogram_target(
            torch.Generator(device=DEV).manual_seed(2), bins)
        K = diversification.plan(D)
        out = diversification.diversification_fwd(mu, target, B, bins)
        out2 = diversification.diversification_fwd(mu, target, B, bins)
        torch.cuda.synchronize()
        plain = diversification.diversification_plain(mu, target, B, bins)
        want64 = diversification64(mu, target, B, bins)
        e = per_output_rel(out, plain)
        e64, p64 = per_output_rel(out, want64), per_output_rel(plain, want64)
        same = torch.equal(out, out2)
        say(f"fused diversification mu ({B}, {D}), {bins} bins, K = {K} "
            f"blocks: {out.tolist()} vs plain "
            f"{plain.tolist()}, max rel per output {e:.2e} (tol "
            f"{REL_TOL:g}); to float64: kernel {e64:.2e}, plain fp32 twin "
            f"{p64:.2e}; repeat bit-equal: {same}")
        check(e <= REL_TOL,
              f"diversification kernel disagrees at ({B}, {D}, {bins})")
        check(same, f"diversification kernel does not repeat at "
                    f"({B}, {D}, {bins})")
        by_shape[f"{B}x{D}x{bins}"] = dict(rel_err=e, kernel_vs_float64=e64,
                                           plain_vs_float64=p64, cluster=K)
        if (B, D, bins) == DIV_SHAPES[0]:
            main_err = float((out - plain).abs().max())
    return main_err, by_shape


def check_training_kernels(all_shapes, cgen):
    """Phase 6.  Returns ({kernel: (max abs error fp32, bf16 or None)},
    the dg/db distances to float64, the histogram kernels' relative errors
    by shape, the fused diversification kernel's checks by shape)."""
    bwd_errs, dgdb = check_norm_bwd(all_shapes, cgen)
    errs = {"cbinorm_bwd": bwd_errs}

    hist_errs, hist_rel = check_histogram(cgen)
    errs.update(hist_errs)

    div_err, div_by_shape = check_diversification(cgen)
    errs["diversification_fwd"] = [div_err, None]
    return errs, dgdb, hist_rel, div_by_shape


class deterministic_cudnn:
    """cuDNN's deterministic algorithms within the block, so that two runs
    of the same model differ only where the code under test differs."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.saved


def plain64(x, t, g, b, eps=1e-5, relu=False):
    """The plain norm computed in float64, its output back in x's dtype."""
    out, mu, r = norm.cbinorm_plain(x.double(), t.double(), g.double(),
                                    b.double(), eps, relu)
    return out.to(x.dtype), mu.float(), r.float()


def check_gradient_repair(cfg, g_per, e_per):
    """Phase 7: G + E + D forward and backward through the kernels against
    the same models with the plain norm forced.  ``g_per`` and ``e_per``
    are the norms of one G and one E forward; each runs forward and
    backward once here (E's input, the fake, needs a gradient)."""
    m = cfg.model
    gen = torch.Generator().manual_seed(3)
    G = gan.build_generator(cfg, DEV, gen)
    E = gan.build_encoder(cfg, DEV, gen)
    D = gan.build_discriminator(cfg, DEV, gen)
    rng = np.random.default_rng(3)
    hw, B = m.image_size, CHECK_BATCH
    x = torch.from_numpy(rng.uniform(-1, 1, (B, m.nch_in, hw, hw))
                         .astype(np.float32)).to(DEV)
    labels = rng.integers(0, m.n_classes, B)
    onehot = gan.onehot(labels, m.n_classes).to(DEV)
    c = torch.cat([onehot, torch.from_numpy(rng.standard_normal(
        (B, m.ndim)).astype(np.float32)).to(DEV)], 1)
    w = torch.from_numpy(rng.standard_normal((B, m.nch_in, hw, hw))
                         .astype(np.float32)).to(DEV)
    names = [f"G.{n}" for n, _ in G.named_parameters()] \
        + [f"E.{n}" for n, _ in E.named_parameters()] \
        + [f"D.{n}" for n, _ in D.named_parameters()]
    params = list(G.parameters()) + list(E.parameters()) \
        + list(D.parameters())

    def grads():
        fake = G(x, c)
        adv, cls = D(fake)
        mu, logvar, cls_e = E(fake)
        loss = (L.lsgan_loss(adv, 1.0)
                + L.domain_classification_loss(cls, onehot)
                + (fake * w).mean() + mu.square().mean() + logvar.mean()
                + cls_e.square().mean())
        return torch.autograd.grad(loss, params)

    with deterministic_cudnn():
        reset_counts()
        got = grads()
        torch.cuda.synchronize()
        counts = read_counts()
        with plain_norm():
            want = grads()
        real = norm.fused_cbinorm
        norm.fused_cbinorm = plain64
        try:
            want64 = grads()
        finally:
            norm.fused_cbinorm = real

        # every backward launch of the model, against the plain twin on the
        # same inputs (the mask taken from the forward kernel's output)
        calls, no_affine = [], []
        real_bwd = norm.cbinorm_bwd

        def checking(x, t, g, b, mu, rstd, dy, relu=False, affine=True):
            out = real_bwd(x, t, g, b, mu, rstd, dy, relu, affine)
            dy = dy.to(x.dtype).contiguous()
            if relu:
                dy = dy * (norm.cbinorm_fwd(x, t, g, b, 1e-5, True)[0] > 0)
            ref = norm.cbinorm_bwd_plain(x, t, g, b, mu, rstd, dy, False)
            calls.append(max(rel_err(o, r) for o, r in zip(out, ref)
                             if o is not None))
            no_affine.append(not affine)
            return out

        norm.cbinorm_bwd = checking
        try:
            grads()
        finally:
            norm.cbinorm_bwd = real_bwd

    def l2(a, b):
        return float((a - b).norm() / b.norm())

    worst = {"plain": (0.0, ""), "float64": (0.0, ""),
             "plain_vs_float64": (0.0, "")}
    for n, a, b, r in zip(names, got, want, want64):
        check(bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0,
              f"{n}: gradient through the kernels is zero or not finite")
        for key, e in (("plain", l2(a, b)), ("float64", l2(a, r)),
                       ("plain_vs_float64", l2(b, r))):
            worst[key] = max(worst[key], (e, n))
    say(f"G + E + D gradients at batch {B}: every one of {len(params)} "
        f"parameters got a non-zero gradient through the kernels; "
        f"launches {counts}")
    say(f"each of the {len(calls)} backward launches vs its plain twin on "
        f"the model's own data: worst {max(calls):.2e} relative (tol "
        f"{REL_TOL:g})")
    say("per-tensor ||a - b|| / ||b||, worst: kernels vs plain "
        f"{worst['plain'][0]:.2e} ({worst['plain'][1]}), kernels vs float64 "
        f"norm {worst['float64'][0]:.2e} ({worst['float64'][1]}), plain vs "
        f"float64 norm {worst['plain_vs_float64'][0]:.2e} "
        f"({worst['plain_vs_float64'][1]}); tol {GRAD_TOL:g}")
    check(counts["cbinorm_fwd"] == g_per + e_per
          and counts["cbinorm_bwd"] == g_per + e_per, counts)
    check(len(calls) == g_per + e_per and max(calls) <= REL_TOL,
          "a backward launch disagrees with its plain twin")
    # the plain instance norms (G's up path, E's trunk) ask for dx alone
    n_in = cfg.model.g_num_cls + e_per
    say(f"{sum(no_affine)} of the {len(calls)} backward launches took the "
        f"no-affine call (the instance norms: {n_in})")
    check(sum(no_affine) == n_in, "the instance norms did not skip dt/dg/db")
    check(worst["plain"][0] <= GRAD_TOL and worst["float64"][0] <= GRAD_TOL,
          "gradients through the kernels disagree")
    return worst


def expected_counts(cfg, g_per, e_per, fused):
    """Launches of each kernel in one train step, from the step's code
    (srgan_tpu_torch/training/gan.py::GANTrainer.step), with idt > 0 and
    idt_reg * idt > 0 as in the preset:

    forward norms, G: k - 1 D-loop fakes (no grad), the k-th fake, the
    phase-1 pair (one 2B call), the phase-2 pair (one 2B call) = k + 2
    calls; E: phase 1 on the images, phase 2 on the images (no grad) and
    on the 2B pair = 3 calls.
    backward norms: G's k-th fake (its graph feeds D(fake) and the phase-1
    pair: one backward), the phase-1 pair and the phase-2 pair = 3 G
    backwards; E: the phase-2 pair's forward, back to its input = 1; E's
    phase-1 forward on the images reaches no norm backward, since the
    trunk is frozen (neither its input nor its parameters need a
    gradient).
    soft histogram: once forward, once backward (phase 1's errE), unless
    the fused kernel takes the stack; fused kernel: 0, or 1 when fused.
    """
    k = cfg.train.unrolled_k
    return {"cbinorm_fwd": (k + 2) * g_per + 3 * e_per,
            "cbinorm_bwd": 3 * g_per + e_per,
            "soft_histogram_fwd": 0 if fused else 1,
            "soft_histogram_bwd": 0 if fused else 1,
            "diversification_fwd": 1 if fused else 0}


def make_batches(cfg, n, seed):
    m, B = cfg.model, cfg.train.batch_size
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        src = rng.integers(0, m.n_classes, B)
        tgt = (src + rng.integers(1, m.n_classes, B)) % m.n_classes
        img = rng.uniform(-1, 1, (B, m.image_size, m.image_size, m.nch_in)) \
            .astype(np.float32)
        out.append(dict(image=torch.from_numpy(img).to(DEV),
                        source_label=torch.from_numpy(src),
                        target_label=torch.from_numpy(tgt)))
    return out


def timed_step(trainer, state, batch):
    """(metrics as floats, device ms, host ms, launches) of one step."""
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = trainer.step(state, batch)
    end.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts()
    metrics = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(v) for v in metrics.values()),
          f"a metric is not finite: {metrics}")
    return metrics, start.elapsed_time(end), host_ms, counts


def fresh(cfg):
    trainer = gan.GANTrainer(cfg, DEV)
    state = trainer.init_state(torch.Generator().manual_seed(0),
                               freeze_pretrained=True)
    return trainer, state


# kernel names of the layout transposes cuDNN runs around a convolution,
# and of cuDNN's convolutions and cuBLAS's matrix products
TRANSPOSE_RE = re.compile(r"nchwToNhwc|nhwcToNchw", re.I)
CONV_RE = re.compile(r"conv|cudnn|xmma|gemm|implicit|dgrad|wgrad|fprop|"
                     r"cutlass", re.I)


def profile_step(trainer, state, batch):
    """One step under torch.profiler: device ms by kernel group (the norm
    kernels, the histogram and diversification kernels, cuDNN's layout
    transposes, convolutions and matrix products, the rest) and the 12
    kernels that take longest.  ``recorded`` is False where the trace holds
    no device time.  The kernels' sum can exceed the step's wall time where
    cuDNN runs kernels side by side."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups = dict.fromkeys(("norm", "histogram_diversification",
                            "layout_transpose", "conv_matmul", "rest"), 0.0)
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.device_time_total / 1e3
        kernels.append((ms, e.count, e.key))
        if "cbinorm" in e.key:
            groups["norm"] += ms
        elif "histogram" in e.key or "diversification" in e.key:
            groups["histogram_diversification"] += ms
        elif TRANSPOSE_RE.search(e.key):
            groups["layout_transpose"] += ms
        elif CONV_RE.search(e.key):
            groups["conv_matmul"] += ms
        else:
            groups["rest"] += ms
    busy = sum(groups.values())
    kernels.sort(reverse=True)
    return dict(recorded=busy > 0, wall_ms_profiled=wall_ms,
                kernel_ms=busy, kernel_share_of_wall=busy / wall_ms,
                groups_ms=groups,
                top=[dict(ms=ms, count=n, name=k[:160])
                     for ms, n, k in kernels[:12]])


def say_profile(what, p):
    if not p["recorded"]:
        say(f"profile of {what}: the trace holds no device time "
            "(torch.profiler's key_averages() show none on this machine)")
        return
    say(f"profile of {what}: kernels {p['kernel_ms']:.1f} ms in a "
        f"{p['wall_ms_profiled']:.1f} ms profiled step "
        f"({100 * p['kernel_share_of_wall']:.1f} % of its wall; above 100 % "
        "where kernels ran side by side); by group: "
        + ", ".join(f"{k} {v:.2f} ms ({100 * v / p['kernel_ms']:.1f} %)"
                    for k, v in p["groups_ms"].items()))
    for k in p["top"]:
        say(f"  {k['ms']:10.3f} ms {k['count']:6d}x  {k['name']}")


def training_phase(cfg, g_per, e_per, name, power_limit):
    """Phase 8.  Returns the `training` record and the launches per step."""
    B, k = cfg.train.batch_size, cfg.train.unrolled_k
    say(f"== phase 8: train step of {PRESET} at full width: batch {B}, "
        f"k = {k}, fp32 (TF32 off), frozen encoder trunk, random weights "
        "from a seeded torch.Generator, synthetic batches from numpy")
    check(os.environ.get("SRGAN_TPU_FUSED_DIV") != "1",
          "SRGAN_TPU_FUSED_DIV=1 is set in the environment; the smoke run "
          "sets it itself for its one fused step")
    batches = make_batches(cfg, 1 + TIMED_STEPS, seed=5)
    want = expected_counts(cfg, g_per, e_per, fused=False)
    t0 = time.perf_counter()
    trainer, state = fresh(cfg)
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i, batch in enumerate(batches):
        metrics, dev_ms, host_ms, counts = timed_step(trainer, state, batch)
        say(f"step {i} ({'warm' if i == 0 else 'timed'}): device "
            f"{dev_ms:.1f} ms, host {host_ms:.1f} ms, launches {counts}, "
            + json.dumps(metrics))
        check(counts == want, f"launches {counts}, derived {want}")
        steps.append(dict(metrics=metrics, device_ms=dev_ms,
                          host_ms=host_ms))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("== phase 8a: one more fp32 step under torch.profiler")
    prof_fp32 = profile_step(trainer, state, batches[-1])
    say_profile("one fp32 step", prof_fp32)
    del trainer, state
    torch.cuda.empty_cache()

    say("== phase 8b: one step with SRGAN_TPU_FUSED_DIV=1 against one "
        "without, from the same weights, draws and batch, cuDNN "
        "deterministic")
    with deterministic_cudnn():
        trainer, state = fresh(cfg)
        unfused0 = timed_step(trainer, state, batches[0])[0]
        del trainer, state
        trainer, state = fresh(cfg)
        os.environ["SRGAN_TPU_FUSED_DIV"] = "1"
        try:
            fused, f_ms, f_host_ms, f_counts = timed_step(trainer, state,
                                                          batches[0])
        finally:
            del os.environ["SRGAN_TPU_FUSED_DIV"]
    f_want = expected_counts(cfg, g_per, e_per, fused=True)
    worst = max(abs(fused[key] - v) / abs(v) for key, v in unfused0.items())
    say(f"unfused: {json.dumps(unfused0)}")
    say(f"fused step: device {f_ms:.1f} ms, launches {f_counts}, "
        + json.dumps(fused) + f"; worst relative difference "
        f"{worst:.2e} (tol {STEP_TOL:g})")
    check(set(fused) == set(unfused0), (sorted(fused), sorted(unfused0)))
    check(f_counts == f_want, f"launches {f_counts}, derived {f_want}")
    check(worst <= STEP_TOL, "the fused step disagrees with the unfused one")
    del trainer, state
    torch.cuda.empty_cache()

    say("== phase 8c: bf16 compute (torch.autocast), 1 warm and 1 timed "
        "step")
    bcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="bfloat16"))
    trainer, state = fresh(bcfg)
    torch.cuda.reset_peak_memory_stats()
    bf16 = []
    for batch in batches[:2]:
        metrics, dev_ms, host_ms, counts = timed_step(trainer, state, batch)
        say(f"bf16 step: device {dev_ms:.1f} ms, host {host_ms:.1f} ms, "
            f"launches {counts}, " + json.dumps(metrics))
        check(counts == want, f"launches {counts}, derived {want}")
        bf16.append(dict(metrics=metrics, device_ms=dev_ms,
                         host_ms=host_ms))
    bf16_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof_bf16 = profile_step(trainer, state, batches[2])
    say_profile("one bf16 step", prof_bf16)
    del trainer, state
    torch.cuda.empty_cache()

    timed = steps[1:]
    record = dict(
        preset=PRESET, batch=B, unrolled_k=k, tf32=False,
        freeze_pretrained=True, card=name, power_limit=power_limit,
        init_s=init_s, warm_step_device_ms=steps[0]["device_ms"],
        step_device_ms=[s["device_ms"] for s in timed],
        step_host_ms=[s["host_ms"] for s in timed],
        step_device_ms_mean=sum(s["device_ms"] for s in timed) / len(timed),
        img_s=1e3 * B * len(timed) / sum(s["device_ms"] for s in timed),
        peak_mem_gib=peak, metrics_last_step=timed[-1]["metrics"],
        launches_per_step=want,
        profile=prof_fp32,
        fused_step=dict(device_ms=f_ms, launches=f_counts,
                        worst_rel_diff_to_unfused=worst),
        bf16=dict(warm_step_device_ms=bf16[0]["device_ms"],
                  step_device_ms=bf16[1]["device_ms"],
                  step_host_ms=bf16[1]["host_ms"],
                  img_s=1e3 * B / bf16[1]["device_ms"], peak_mem_gib=bf16_peak,
                  metrics=bf16[1]["metrics"], profile=prof_bf16))
    return record, want, f_counts


def norm_uses_per_step(cfg, shapes):
    """(C, H, W, batch) -> (forward launches, backward launches) in one
    step, split as ``expected_counts`` derives them."""
    B, k = cfg.train.batch_size, cfg.train.unrolled_k
    uses = {}

    def add(net, batch, n_fwd, n_bwd):
        for shape, per in shapes[net].items():
            f, b = uses.get(shape + (batch,), (0, 0))
            uses[shape + (batch,)] = (f + per * n_fwd, b + per * n_bwd)

    add("G", B, k, 1)
    add("G", 2 * B, 2, 2)
    add("E", B, 2, 0)
    add("E", 2 * B, 1, 1)
    return uses


def rotating(fn, sets):
    """A call with no argument that runs ``fn`` on the next of ``sets``, in
    turn."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def time_training_kernels(cfg, shapes, cgen, name, power_limit):
    """Phase 9: device time of every kernel at the shapes of one step."""
    say("== phase 9: kernel timing at the shapes of one train step, fp32 and "
        "bf16 (CUDA events around calls queued behind a device sleep; the "
        "norms with t=0, g=1, b=0, no ReLU, so that F.instance_norm and its "
        "autograd backward compute the same functions; the timed calls "
        "take turns over copies of x and dy that hold at least "
        f"{L2_FLUSH_BYTES / 1e6:g} MB, so that none finds its inputs in "
        "L2)")
    uses = norm_uses_per_step(cfg, shapes)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "ms_bf16",
            "bound_ms_bf16", "library_ms_bf16")
    tot = {kn: dict(dict.fromkeys(keys, 0.0), by=set())
           for kn in ("cbinorm_fwd", "cbinorm_bwd")}
    for (C, H, W, B), (n_fwd, n_bwd) in sorted(uses.items()):
        row = dict(C=C, H=H, W=W, B=B, fwd_per_step=n_fwd,
                   bwd_per_step=n_bwd, card=name, power_limit=power_limit)
        t = torch.zeros((B, C), device=DEV)
        g = torch.ones((C,), device=DEV)
        b = torch.zeros((C,), device=DEV)
        for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            isz = torch.finfo(dtype).bits // 8
            copies = max(1, math.ceil(L2_FLUSH_BYTES / (2 * B * C * H * W
                                                        * isz)))
            sets = []
            for _ in range(copies):
                x = torch.randn((B, C, H, W), generator=cgen,
                                device=DEV).to(dtype)
                dy = torch.randn((B, C, H, W), generator=cgen,
                                 device=DEV).to(dtype)
                _, mu, r = norm.cbinorm_fwd(x, t, g, b)
                sets.append((x, dy, mu, r))
            row["copies" + sfx] = copies
            row["fwd_ms" + sfx] = cuda_ms(rotating(
                lambda x, dy, mu, r: norm.cbinorm_fwd(x, t, g, b), sets))[0]
            if dtype == torch.float32:
                row["fwd_plain_ms"] = cuda_ms(rotating(
                    lambda x, *_: norm.cbinorm_plain(x, t, g, b), sets))[0]
            row["fwd_library_ms" + sfx] = cuda_ms(rotating(
                lambda x, *_: F.instance_norm(x, eps=1e-5), sets))[0]
            row["fwd_bound_ms" + sfx], fby = bound_ms(B, C, H, W, isz)
            if n_bwd:
                row["bwd_ms" + sfx] = cuda_ms(rotating(
                    lambda x, dy, mu, r: norm.cbinorm_bwd(x, t, g, b, mu, r,
                                                          dy), sets))[0]
                if dtype == torch.float32:
                    row["bwd_plain_ms"] = cuda_ms(rotating(
                        lambda x, dy, mu, r: norm.cbinorm_bwd_plain(
                            x, t, g, b, mu, r, dy), sets))[0]
                graphs = []
                for x, dy, _, _ in sets:
                    xr = x.detach().requires_grad_(True)
                    graphs.append((F.instance_norm(xr, eps=1e-5), xr, dy))
                row["bwd_library_ms" + sfx] = cuda_ms(rotating(
                    lambda y, xr, dy: torch.autograd.grad(
                        y, xr, dy, retain_graph=True), graphs))[0]
                row["bwd_bound_ms" + sfx], bby = bwd_bound_ms(B, C, H, W,
                                                              isz)
                del graphs
            del sets
        say(json.dumps({"train_kernel_shape": row}))
        for kn, n, pre in (("cbinorm_fwd", n_fwd, "fwd"),
                           ("cbinorm_bwd", n_bwd, "bwd")):
            if n:
                for key in keys:
                    tot[kn][key] += n * row[f"{pre}_{key}"]
                tot[kn]["by"].add(fby if pre == "fwd" else bby)
        del t, g, b
        torch.cuda.empty_cache()
    for kn in ("cbinorm_fwd", "cbinorm_bwd"):
        v = tot[kn]
        say(f"{kn} per step: fp32 {v['ms']:.3f} ms, bound "
            f"{v['bound_ms']:.3f} ms ({v['ms'] / v['bound_ms']:.3f}x), "
            f"library {v['library_ms']:.3f} ms; bf16 {v['ms_bf16']:.3f} ms, "
            f"bound {v['bound_ms_bf16']:.3f} ms "
            f"({v['ms_bf16'] / v['bound_ms_bf16']:.3f}x), library "
            f"{v['library_ms_bf16']:.3f} ms")

    tot.update(time_small_kernels(cfg, cgen))
    return tot


def small_kernel_calls(mu, gh, target):
    """{kernel: (kernel call, plain call, (bound ms, bound by))} of the
    small kernels on mu (B, D), gh (D, 50) and the target (50,)."""
    Bm, Dm = mu.shape
    n_hist = Bm * Dm * 50
    return {
        "soft_histogram_fwd": (
            lambda: histogram.soft_histogram_fwd(mu),
            lambda: histogram.soft_histogram_cols_plain(mu),
            bound(4 * (Bm * Dm + Dm * 50), HIST_OPS * n_hist)),
        "soft_histogram_bwd": (
            lambda: histogram.soft_histogram_bwd(mu, gh),
            lambda: histogram.soft_histogram_cols_bwd_plain(mu, gh),
            bound(4 * (2 * Bm * Dm + Dm * 50), HIST_BWD_OPS * n_hist)),
        "diversification_fwd": (
            lambda: diversification.diversification_fwd(mu, target, Bm),
            lambda: diversification.diversification_plain(mu, target, Bm),
            # moments and covariance (2 B D^2), the histograms, the KL
            bound(4 * (Bm * Dm + 50 + 3),
                  2 * Bm * Dm * Dm + HIST_OPS * n_hist + 4 * Dm * 50)),
    }


def time_fused_backward(mu, target):
    """(device ms, host ms, device operations) of one backward through
    ``fused_diversification`` at mu (B, D): autograd of the plain
    composition, as on the TPU; no kernel of this repository.  The
    operations are counted under torch.profiler (None where its trace holds
    no device event)."""
    from torch.profiler import ProfilerActivity, profile

    m = mu.detach().requires_grad_(True)
    out = diversification.fused_diversification(m, target, mu.shape[0])
    g = torch.tensor([10.0, 100.0, 100.0], device=DEV)

    def fn():
        return torch.autograd.grad(out, m, g, retain_graph=True)

    dev_ms, host_ms = cuda_ms(fn, iters=20)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return dev_ms, host_ms, n or None


def time_small_kernels(cfg, cgen):
    """Phase 9's small kernels at the train step's mu (B, ndim) and at
    batch ``HIST_LARGE_B``, beside an empty launch timed the same way
    (``floor_ms``): what launch latency alone costs back to back.  The
    fused diversification kernel also at batch 2 (its latency with next to
    no work), and its backward (autograd of the plain composition) at the
    train step's mu."""
    floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), iters=50)[0]
    say(f"empty launch (torch.cuda._sleep(0)), back to back: "
        f"{floor_ms:.4f} ms")
    target = L.histogram_target(torch.Generator(device=DEV).manual_seed(2))
    tot = {}
    for B in (cfg.train.batch_size, HIST_LARGE_B):
        mu = (torch.randn((B, cfg.model.ndim), generator=cgen, device=DEV)
              * 1.5 + 0.1)
        gh = torch.randn((cfg.model.ndim, 50), generator=cgen, device=DEV)
        main = B == cfg.train.batch_size
        for kn, (fn, plain_fn, (bd, by)) in small_kernel_calls(
                mu, gh, target).items():
            k_ms, host_ms = cuda_ms(fn, iters=50)
            plain_ms = cuda_ms(plain_fn, iters=50)[0]
            say(f"{kn} mu ({B}, {cfg.model.ndim}): {k_ms:.4f} ms, floor "
                f"{floor_ms:.4f} ms ({k_ms / floor_ms:.2f}x), bound "
                f"{bd:.2e} ms ({by}), plain {plain_ms:.4f} ms")
            if main:
                tot[kn] = dict(ms=k_ms, plain_ms=plain_ms, bound_ms=bd,
                               library_ms=None, by={by}, host_ms=host_ms,
                               floor_ms=floor_ms, extra={})
            else:
                tot[kn]["extra"].update({f"ms_B{B}": k_ms,
                                         f"plain_ms_B{B}": plain_ms,
                                         f"bound_ms_B{B}": bd})
        if main:
            div = tot["diversification_fwd"]
            mu2 = mu[:2].contiguous()
            b2_ms = cuda_ms(lambda: diversification.diversification_fwd(
                mu2, target, 2), iters=50)[0]
            say(f"diversification_fwd mu (2, {cfg.model.ndim}), the least "
                f"batch it takes: {b2_ms:.4f} ms")
            div["extra"]["ms_B2"] = b2_ms
            b_ms, b_host_ms, b_n = time_fused_backward(mu, target)
            say(f"fused diversification backward (torch.autograd.grad "
                f"through fused_diversification, autograd of the plain "
                f"composition) mu ({B}, {cfg.model.ndim}): device "
                f"{b_ms:.4f} ms, host {b_host_ms:.4f} ms per call, "
                f"{b_n if b_n is not None else 'not measured'} device "
                "operations per call (torch.profiler)")
            div["extra"].update(backward_ms=b_ms,
                                backward_host_ms=b_host_ms,
                                backward_device_ops=b_n)
    return tot


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")

    say("== phase 1: device")
    card = card_line()
    say(card)
    name, power_limit = [s.strip() for s in card.split(",", 1)]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "TF32 off for convolutions and matmuls in every phase")

    say("== phase 2: build the CUDA kernels")
    build_s = build.build()
    for n in build.SIGNATURES:
        build.load(n)
    say(f"build of {sorted(build.SIGNATURES)}: {build_s:.2f} s")

    cfg = PRESETS[PRESET]()
    shapes, all_shapes, fwd_err, serving = serving_phases(cfg, name,
                                                          power_limit)
    g_per = sum(shapes["G"].values())
    e_per = sum(shapes["E"].values())

    say("== phase 6: the training kernels vs plain on the card")
    cgen = torch.Generator(device=DEV).manual_seed(4)
    errs, dgdb, hist_rel, div_by_shape = check_training_kernels(all_shapes,
                                                                cgen)
    errs["cbinorm_fwd"] = [fwd_err[torch.float32], fwd_err[torch.bfloat16]]

    say(f"== phase 7: gradients of G + E + D at batch {CHECK_BATCH}, "
        "kernels vs plain norm")
    grad_worst = check_gradient_repair(cfg, g_per, e_per)

    training, launches, fused_launches = training_phase(
        cfg, g_per, e_per, name, power_limit)
    tot = time_training_kernels(cfg, shapes, cgen, name, power_limit)

    entries = []
    for kn, meta in KERNELS.items():
        t = tot[kn]
        n = fused_launches[kn] if kn == "diversification_fwd" \
            else launches[kn]
        check(n > 0, f"{kn} was not launched on its path")
        entry = dict(
            name=kn, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=n,
            max_abs_err=errs[kn][0], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"],
            bound_by="bytes" if t["by"] == {"bytes"} else "operations",
            library_ms=t["library_ms"], card=name, power_limit=power_limit,
            work="the launches of one train step of "
                 f"{PRESET} at batch {cfg.train.batch_size}")
        if errs[kn][1] is not None:
            entry["max_abs_err_bf16"] = errs[kn][1]
        if kn in ("cbinorm_fwd", "cbinorm_bwd"):
            entry.update({k: t[k] for k in ("ms_bf16", "bound_ms_bf16",
                                            "library_ms_bf16")})
        if kn == "cbinorm_bwd":
            entry["dg_db_rel_err_vs_float64"] = dgdb["kernel"]
        if kn == "cbinorm_fwd":
            entry["launches_serving"] = serving["launches"]
        if kn == "cbinorm_bwd":
            entry["library"] = ("torch.autograd.grad through "
                                "F.instance_norm")
        if kn == "diversification_fwd":
            entry["path"] = "the SRGAN_TPU_FUSED_DIV=1 step"
        if "floor_ms" in t:
            entry["floor_ms"] = t["floor_ms"]
        if kn in hist_rel:
            entry["rel_err_by_shape"] = hist_rel[kn]
        if kn == "diversification_fwd":
            entry["checks_by_shape"] = div_by_shape
        entry.update(t.get("extra", {}))
        if t["library_ms"] is None:
            entry["library"] = "none: no one PyTorch call computes it"
        entries.append(entry)
    norm_ms = tot["cbinorm_fwd"]["ms"] + tot["cbinorm_bwd"]["ms"]
    training["norm_ms_per_step"] = norm_ms
    training["norm_share_of_step"] = norm_ms / training["step_device_ms_mean"]
    norm_bf16 = tot["cbinorm_fwd"]["ms_bf16"] + tot["cbinorm_bwd"]["ms_bf16"]
    training["bf16"]["norm_ms_per_step"] = norm_bf16
    training["bf16"]["norm_share_of_step"] = \
        norm_bf16 / training["bf16"]["step_device_ms"]
    training["grad_rel_l2_worst"] = {k: v[0] for k, v in grad_worst.items()}
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"training": training}))
    say(json.dumps({"serving": serving}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
