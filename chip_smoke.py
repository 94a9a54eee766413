#!/usr/bin/env python3
"""Smoke run of srgan_tpu_torch on one NVIDIA Hopper GPU (sm_90a).

    python3 chip_smoke.py

from the root of a checkout; no install step, no argument.  Phases:

  1. the card, torch and CUDA versions; TF32 off for every phase;
  2. build the CUDA kernels (plain nvcc, loaded with ctypes);
  3. the conditional-instance-norm kernel against its plain PyTorch twin on
     the card, at every (C, H, W) the serving path gives it, batch 8, fp32
     and bf16, ReLU on and off;
  4. the serving path at the full width of preset 05_srgan_full (128 px,
     g_nch 64, g_res_num 6, e_nch 64, e_num_cls 4, fp32), random weights
     from a seeded torch.Generator saved and loaded back through the
     Translator's weights dir: translate N = 1, 8, 40 and encode N = 8
     through the npz request dispatch, with the kernel's launch count read
     around those requests, and one batch-8 forward checked against the
     same model with the plain norm forced;
  5. CUDA-event timings of the kernel, its plain twin and F.instance_norm
     (timed as a yardstick, never called by the port) at those shapes, and
     translate throughput at batch 32.

Without CUDA it raises before printing a result.  It starts no server and
no thread; its only subprocesses are nvidia-smi and nvcc, both with a
timeout.  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
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
from srgan_tpu_torch.ops import build, norm  # noqa: E402
from srgan_tpu_torch.serving import (  # noqa: E402
    Translator,
    decode_npz,
    encode_npz,
    handle_request,
)
from srgan_tpu_torch.training import gan  # noqa: E402

PRESET = "05_srgan_full"
WARM = (1, 8, 32)
TRANSLATE_N = (1, 8, 40)
ENCODE_N = 8
TIMING_BATCH = 32
# fp32: both sides compute in fp32, sums in another order; bf16: about two
# bf16 ulps at |y| <= 4, both outputs compared in fp32
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
MODEL_TOL = 1e-4
# H100 SXM, NVIDIA's data sheet: HBM rate and fp32 rate outside the tensor
# cores, at the full 700 W power limit
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
# per element: sum (1 add), sum of squares (1 fma), apply (1 fma)
FLOPS_PER_ELEM = 5
# device-side sleep (in clock cycles) ahead of a timed loop, long enough
# for the host to queue the whole loop behind it
SLEEP_CYCLES = 100_000_000
KERNEL = dict(
    name="cbinorm_fwd", route="cuda", source="srgan_tpu_torch/csrc/cbinorm.cu",
    replaces="srgan_tpu/ops/pallas/norm.py:86 (_fused_fwd; kernel "
             "_fwd_kernel :37)")


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


def bound_ms(B, C, H, W, itemsize: int = 4):
    """Least time for one launch: each input read once (x, t, g, b), each
    output written once (y, mu, rstd), over the HBM rate; or its flops over
    the fp32 rate, whichever is larger."""
    n = B * C * H * W
    nbytes = 2 * n * itemsize + 4 * (3 * B * C + 2 * C)
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = FLOPS_PER_ELEM * n / PEAK_FP32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def norm_inputs(gen, B, C, H, W, dtype):
    dev = "cuda"
    # |y| stays below 4: |x_hat| <= sqrt(3) for uniform x
    x = ((torch.rand((B, C, H, W), generator=gen, device=dev) * 2 - 1) * 3
         + 0.5).to(dtype)
    t = torch.tanh(torch.randn((B, C), generator=gen, device=dev))
    g = 0.8 + 0.4 * torch.rand((C,), generator=gen, device=dev)
    b = 0.4 * torch.rand((C,), generator=gen, device=dev) - 0.2
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
    x = torch.zeros((1, cfg.model.nch_in, hw, hw), device="cuda")
    c = torch.zeros((1, cfg.model.num_con), device="cuda")
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


def forward_with_plain_norm(fn):
    real = norm.fused_cbinorm
    norm.fused_cbinorm = lambda *a, **k: norm.cbinorm_plain(*a, **k)
    try:
        with torch.inference_mode():
            return fn()
    finally:
        norm.fused_cbinorm = real


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
    say(f"build: {build_s:.2f} s")

    say(f"== phase 3: kernel vs plain on the card, batch 8, at the norm "
        f"shapes of {PRESET}")
    cfg = PRESETS[PRESET]()
    m = cfg.model
    gen = torch.Generator().manual_seed(0)
    G = gan.build_generator(cfg, "cuda", gen)
    E = gan.build_encoder(cfg, "cuda", gen)
    shapes = path_norm_shapes(G, E, cfg)
    g_per_fwd = sum(shapes["G"].values())
    e_per_fwd = sum(shapes["E"].values())
    # the down CBINorms, 2 per residual block, the up path's plain norms
    check(g_per_fwd == (m.g_num_cls + 1) + 2 * m.g_res_num + m.g_num_cls,
          shapes)
    check(e_per_fwd == 2 * m.e_num_cls, shapes)
    say(f"norm launches per forward: G {g_per_fwd} {shapes['G']}, "
        f"E {e_per_fwd} {shapes['E']}")
    cgen = torch.Generator(device="cuda").manual_seed(1)
    all_shapes = sorted(set(shapes["G"]) | set(shapes["E"]))
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for (C, H, W) in all_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for relu in (False, True):
                x, t, g, b = norm_inputs(cgen, 8, C, H, W, dtype)
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
        tr = Translator(cfg, wdir, device="cuda", warm_batch_sizes=WARM)
    say(f"Translator up (random weights saved, loaded back, warmed at "
        f"{WARM}) in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    hw = m.image_size
    n_max = max(TRANSLATE_N)
    images = rng.uniform(-1, 1, (n_max, hw, hw, m.nch_in)).astype(np.float32)
    labels = rng.integers(0, m.n_classes, n_max)
    chunk = max(WARM)
    norm.LAUNCHES = 0
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
    launches = norm.LAUNCHES
    say(f"encode N={ENCODE_N}: {got} launches ({e_per_fwd} per E chunk); "
        f"main path total {launches} launches")

    x8 = torch.from_numpy(images[:8]).cuda().permute(0, 3, 1, 2).contiguous()
    c8 = torch.cat([gan.onehot(labels[:8], m.n_classes),
                    torch.randn((8, m.ndim), generator=gen)], 1).cuda()
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
        x = torch.randn((B, C, H, W), generator=cgen, device="cuda")
        t = torch.zeros((B, C), device="cuda")
        g = torch.ones((C,), device="cuda")
        b = torch.zeros((C,), device="cuda")
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

    k_ms = per_request("kernel_ms")
    entry = dict(KERNEL, launches=launches,
                 max_abs_err=max_err[torch.float32],
                 max_abs_err_bf16=max_err[torch.bfloat16],
                 ms=k_ms, kernel_ms=k_ms, plain_ms=per_request("plain_ms"),
                 bound_ms=per_request("bound_ms"),
                 bound_by="bytes" if all(r["bound_by"] == "bytes"
                                         for r in rows) else "operations",
                 library_ms=per_request("library_ms"),
                 work=f"the launches of one G and one E forward at batch {B}",
                 card=name, power_limit=power_limit)

    serving = dict(preset=PRESET, tf32=False, card=name,
                   power_limit=power_limit)
    for n in (1, B):
        xg = torch.from_numpy(images[:n]).cuda().permute(0, 3, 1, 2) \
            .contiguous()
        cg = torch.cat([gan.onehot(labels[:n], m.n_classes),
                        torch.randn((n, m.ndim), generator=gen)], 1).cuda()
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
    b_row["norm_share_of_g_plus_e_device"] = k_ms / (
        b_row["g_forward_device_ms"] + b_row["e_forward_device_ms"])
    serving["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    say(json.dumps({"kernels": [entry]}))
    say(json.dumps({"serving": serving}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
