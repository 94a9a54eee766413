#!/usr/bin/env python3
"""Smoke run of srgan_tpu_torch on one NVIDIA Hopper GPU (sm_90a).

    python3 chip_smoke.py

from the root of a checkout; no install step, no argument.  Phases:

  1. the card, torch and CUDA versions; TF32 off for every phase;
  2. build the CUDA kernels (plain nvcc, one process per source, all
     started together; loaded with ctypes);
  3. the conditional-instance-norm forward kernel against its plain
     PyTorch twin on the card, at every (C, H, W) the model path gives it
     (G, the SRGAN encoder and the SingleGAN presets' conditional encoder),
     batch 8, per-sample conditional bias, fp32 and bf16, ReLU on and off;
  4. the serving path at the full width of preset 05_srgan_full (128 px,
     g_nch 64, g_res_num 6, e_nch 64, e_num_cls 4, fp32), random weights
     from a seeded torch.Generator saved and loaded back through the
     Translator's weights dir: translate N = 1, 8, 40 and encode N = 8
     through the npz request dispatch, with the kernel's launch count read
     around those requests, and one batch-8 forward checked against the
     same model with the plain norm forced; then a 02_singlegan_solod
     training checkpoint (random weights) served through ``serve``'s
     --ckpt path: translate, and encode with the labels the conditional
     encoder needs (without them the request fails), its launches counted
     and its mu held against the plain norm;
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
  7. the gradient repair: a G + E + D + conditional-E forward and
     backward at batch 8 through the kernels against the same models with
     the plain norm forced, every parameter's gradient compared;
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
     its device operations counted;
 10. the training loop, ``train_gan``, at the full width of 05_srgan_full in
     bf16 (batch 128, k = 5, frozen encoder trunk loaded from a classifier
     .pth of a seeded random encoder) on a synthetic fixture of 272 images
     (256 train: two steps an epoch), 2 epochs and a resume to a third,
     with the decoder the host's probes allow (the native one where libpng
     and libjpeg build, else PIL, chosen by name): config.json, every
     logged value finite, the step column rising across the resume,
     checkpoints step_1-3, a resume with a changed config refused, the
     kernels' launches per step as derived; the host's wait on each batch
     and the step's device time, and the DataLoader alone in img/s;
 11. encoder-classifier pretraining at the full width of 05_srgan_full's
     encoder (128 px, e_nch 64, e_num_cls 4), batch 512 (ClassifierConfig),
     fp32: 1 warm and 3 timed ClassifierTrainer steps, the norm launches of
     a step (8 forward, 8 backward) and of an evaluation batch as derived,
     one step's gradients through the kernels against the plain norm; then
     ``python -m srgan_tpu_torch.pretrain_classifier --synthetic`` (in
     process) on 160 images, 4 epochs of 2 steps of 64, its launches as
     derived, its confusion_matrix.png where matplotlib imports (else
     --no-confusion-plot), and its classifier_best.pth loaded into the
     05_srgan_full encoder through load_pretrained_encoder, the trunk
     bit-equal;
 12. VGG19-BN at 224 px, batch 32: features on the card against the same
     weights on the CPU, their time; 1 warm and 3 timed fine-tune steps;
     ``finetune_vgg --synthetic`` (2 steps of 32) from torchvision's init
     and from a seeded random torchvision-layout .pth (--imagenet-pth);
 13. ``evaluate_prdc`` on phase 10's checkpoint with vgg-initialization
     and phase 12's vgg-CelebA, all 16 (source, target) pairs, 32 samples
     a pair, nearest_k 5: every metric finite and in range, the norm
     launches of each translate as derived (one G forward), a set against
     itself at precision = coverage = 1 exactly, a set of duplicated
     features at k = 1 at all four metrics exactly 0 (the exact distances);
     the harness's preprocess, feature and PRDC times;
 14. the trainer variants at full width (128 px, batch 128, fp32, TF32
     off): 01_proposed_singlegan_k5 (per-domain Ds, conditional encoder),
     01_conventional_singlegan (k 1, the reparametrised style),
     02_singlegan_solod and 05_srgan_full with unrolled_restore=True, each
     1 warm and 2 timed steps with every metric finite, the peak memory and
     every kernel's launches per step as derived; for unrolled_restore, D's
     parameters after each step bit-equal to their values after its first
     update and Adam's step count at all k updates; one bf16 step of
     01_proposed_singlegan_k5;
 15. the visualisation module: the progress grid's panels and a
     ``get_samples`` sweep with injected latents on the card against the
     same weights on the CPU; ``sample_sweep`` on phase 10's checkpoint
     (GIFs where PIL imports, the grid PNG where matplotlib does); and
     ``train_gan`` with grids on: where matplotlib is missing it must
     refuse before any step, else write the JAX loop's PNG names;
 16. batch-norm mode: 05_srgan_full with norm_type="batch" at full width
     (batch 128, k = 5, fp32, TF32 off), 1 warm and 2 timed steps with
     CUDA events and the peak memory, every metric finite, every running
     statistic of G and E moved, no norm kernel and 1 + 1 histogram
     launches a step as derived, one more step under torch.profiler, and
     the eval-mode transform of one image against its row of the
     batch-of-128 call (1e-4);
 17. data parallel on the one card: two ranks spawned under gloo, both on
     cuda:0, run the 05_srgan_full step at full width on a global batch of
     128 (64 a rank), fp32, from the weights and injected draws of one
     single-process step run first: the metrics within 2e-3 relative of
     it, the G, D and E parameters by the Adam-sign-tolerant criterion of
     tests/test_torch_train.py, both ranks bit-equal, each rank's norm and
     histogram launches as phase 8 derives them, then one more step each;
     step ms and peak memory per rank.  The only phase where the
     collectives meet CUDA tensors; it checks correctness across ranks,
     not scaling.  A rank that fails fails the phase.

Each entry point of phases 11-13 runs with TF32 turned on before it and
must turn it off itself (``resolve_device``), as it does for its users.

Without CUDA it raises before printing a result.  It starts no server; its
subprocesses are nvidia-smi, nvcc and g++ (the host probes and the native
decoder's build), each with a timeout, its threads are the loader's
workers, joined at the end of each epoch, and phase 17's two ranks, joined
(or killed at a timeout) before it goes on.  Before the last line it prints
the `kernels`, `training`, `serving`, `loop`, `classifier`, `vgg`,
`evaluation`, `variants`, `visualisation`, `batch_norm` and
`data_parallel` JSON lines; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import dataclasses
import importlib.util
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

from srgan_tpu_torch.configs import PRESETS, config_from_dict  # noqa: E402
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
from srgan_tpu_torch.data import (  # noqa: E402
    DataLoader,
    FaceDataset,
    make_synthetic_celeba,
    native,
)
from srgan_tpu_torch.training import gan, loop  # noqa: E402

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


def path_norm_shapes(G, E, cfg, Ec=None):
    """(C, H, W) -> launches per forward, for one generator and one encoder
    forward (and one of the conditional encoder ``Ec``), recorded from the
    models themselves at batch 1."""
    seen = {"G": {}, "E": {}, "Ec": {}}
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
            if Ec is not None:
                which[0] = "Ec"
                Ec(x, c[:, :cfg.model.n_classes])
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


# the trainer variants of phases 4 and 14: the SingleGAN baselines (nb01,
# nb02) and 05_srgan_full's UnrolledGAN restore
SOLO_PRESET = "02_singlegan_solod"
VARIANTS = (("01_proposed_singlegan_k5", {}),
            ("01_conventional_singlegan", {}),
            (SOLO_PRESET, {}),
            ("05_srgan_full", {"unrolled_restore": True}))
VARIANT_TIMED_STEPS = 2


def serve_singlegan(scfg, g_per, e_per, images, labels, chunk):
    """Phase 4's SingleGAN part: a training checkpoint of ``scfg`` (random
    weights, as ``train_gan`` writes them: ``run/config.json``,
    ``run/ckpt/step_N``) served through ``serve``'s --ckpt path with no
    --preset.  Returns the launches of its requests."""
    from srgan_tpu_torch import serve
    from srgan_tpu_torch.configs import save_config
    from srgan_tpu_torch.utils.checkpoint import save_checkpoint

    m = scfg.model
    n = 8
    with tempfile.TemporaryDirectory() as run:
        trainer = gan.GANTrainer(scfg, DEV)
        state = trainer.init_state(torch.Generator().manual_seed(21))
        save_config(scfg, run)
        save_checkpoint(os.path.join(run, "ckpt"), state, step=2)
        del trainer, state
        tr = serve.build_translator(serve.parse_args(
            ["--ckpt", os.path.join(run, "ckpt"), "--device", DEV,
             "--warm-batch-sizes", str(chunk)]))
    check(tr.cfg == scfg, "serve --ckpt did not find the run's config")
    reset_counts()
    code, body = handle_request(tr, "/translate", encode_npz(
        images=images[:n], target_labels=labels[:n], seed=3))
    check(code == 200, body[:2000])
    fakes = decode_npz(body)["fakes"]
    check(np.isfinite(fakes).all() and np.abs(fakes).max() <= 1.0,
          "SingleGAN fakes not finite or outside [-1, 1]")
    code, body = handle_request(tr, "/encode", encode_npz(
        images=images[:n], labels=labels[:n]))
    check(code == 200, body[:2000])
    enc = decode_npz(body)
    counts = read_counts()
    check(counts["cbinorm_fwd"] == g_per + e_per
          and counts["cbinorm_bwd"] == 0, counts)
    code, body = handle_request(tr, "/encode",
                                encode_npz(images=images[:n]))
    check(code == 400 and b"labels" in body,
          f"/encode without labels: {code} {body[:200]}")
    x = torch.from_numpy(images[:n]).to(DEV).permute(0, 3, 1, 2) \
        .contiguous()
    oh = gan.onehot(labels[:n], m.n_classes).to(DEV)
    want = forward_with_plain_norm(lambda: tr.E(x, oh))[1].cpu().numpy()
    err = float(np.abs(enc["mu"] - want).max())
    say(f"{SOLO_PRESET} served from its ckpt dir (config found, no "
        f"--preset): translate N={n} and encode N={n} with labels, "
        f"launches {counts}; mu against the plain norm {err:.3e} (tol "
        f"{MODEL_TOL:g}); encode without labels refused (400)")
    check(err <= MODEL_TOL, "the conditional encoder disagrees with the "
          "plain norm")
    del tr
    return counts


# ---------------------------------------------------------------------------
# phases 3-5: the serving slice
# ---------------------------------------------------------------------------

def serving_phases(cfg, name, power_limit):
    m = cfg.model
    gen = torch.Generator().manual_seed(0)
    G = gan.build_generator(cfg, DEV, gen)
    E = gan.build_encoder(cfg, DEV, gen)
    scfg = PRESETS[SOLO_PRESET]()
    check(scfg.model == cfg.model, "the SingleGAN preset's widths differ")
    Ec = gan.build_encoder(scfg, DEV, gen)
    say(f"== phase 3: kernel vs plain on the card, batch {CHECK_BATCH}, at "
        f"the norm shapes of {PRESET} and of {SOLO_PRESET}'s conditional "
        "encoder")
    shapes = path_norm_shapes(G, E, cfg, Ec)
    g_per_fwd = sum(shapes["G"].values())
    e_per_fwd = sum(shapes["E"].values())
    # the down CBINorms, 2 per residual block, the up path's plain norms
    check(g_per_fwd == (m.g_num_cls + 1) + 2 * m.g_res_num + m.g_num_cls,
          shapes)
    check(e_per_fwd == 2 * m.e_num_cls, shapes)
    # the conditional encoder: a CBINorm where the SRGAN one normalises
    check(shapes["Ec"] == shapes["E"], shapes)
    say(f"norm launches per forward: G {g_per_fwd} {shapes['G']}, "
        f"E {e_per_fwd} {shapes['E']}, conditional E {shapes['Ec']}")
    del Ec
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
    solo_launches = serve_singlegan(scfg, g_per_fwd, e_per_fwd, images,
                                    labels, chunk)

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
                   launches_singlegan=solo_launches,
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
    """Phase 7: G + E + D + the SingleGAN presets' conditional encoder Ec,
    forward and backward through the kernels against the same models with
    the plain norm forced.  ``g_per`` and ``e_per`` are the norms of one G
    and one E forward (Ec has E's); each runs forward and backward once
    here (E's and Ec's input, the fake, needs a gradient)."""
    m = cfg.model
    gen = torch.Generator().manual_seed(3)
    G = gan.build_generator(cfg, DEV, gen)
    E = gan.build_encoder(cfg, DEV, gen)
    D = gan.build_discriminator(cfg, DEV, gen)
    Ec = gan.build_encoder(PRESETS[SOLO_PRESET](), DEV, gen)
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
    nets = (("G", G), ("E", E), ("D", D), ("Ec", Ec))
    names = [f"{k}.{n}" for k, net in nets for n, _ in net.named_parameters()]
    params = [p for _, net in nets for p in net.parameters()]

    def grads():
        fake = G(x, c)
        adv, cls = D(fake)
        mu, logvar, cls_e = E(fake)
        _, mu_c, logvar_c = Ec(fake, onehot)
        loss = (L.lsgan_loss(adv, 1.0)
                + L.domain_classification_loss(cls, onehot)
                + (fake * w).mean() + mu.square().mean() + logvar.mean()
                + cls_e.square().mean() + mu_c.square().mean()
                + logvar_c.mean())
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
    per = g_per + 2 * e_per
    check(counts["cbinorm_fwd"] == per and counts["cbinorm_bwd"] == per,
          counts)
    check(len(calls) == per and max(calls) <= REL_TOL,
          "a backward launch disagrees with its plain twin")
    # the plain instance norms (G's up path, E's trunk) ask for dx alone;
    # Ec's are conditional
    n_in = cfg.model.g_num_cls + e_per
    say(f"{sum(no_affine)} of the {len(calls)} backward launches took the "
        f"no-affine call (the instance norms: {n_in})")
    check(sum(no_affine) == n_in, "the instance norms did not skip dt/dg/db")
    check(worst["plain"][0] <= GRAD_TOL and worst["float64"][0] <= GRAD_TOL,
          "gradients through the kernels disagree")
    return worst


def expected_counts(cfg, g_per, e_per, fused=False):
    """Launches of each kernel in one train step of ``cfg``, from the
    step's code (srgan_tpu_torch/training/gan.py::GANTrainer.step), with
    idt > 0 as in every preset; ``e_per`` is the norms of one forward of
    either encoder.

    forward norms, G: k - 1 D-loop fakes (no grad), the k-th fake, the
    phase-1 pair (one 2B call) and phase 2's call (the 2B pair, or one B
    call without the identity regression) = k + 2 calls; E: phase 1 on the
    images, phase 2 on its G output, and, in the SRGAN flavour of the
    identity regression (idt_reg * idt > 0, unconditional encoder), on the
    images (no grad) = 2 or 3 calls.
    backward norms: G's k-th fake (its graph feeds D(fake) and the phase-1
    pair: one backward), the phase-1 pair and phase 2's call = 3 G
    backwards; E: phase 2's call, back to its input, and phase 1's
    forward unless the trunk is frozen (05_srgan_full: neither its input
    nor its parameters need a gradient).
    soft histogram (the proposed stack): once forward, once backward
    (phase 1's errE), unless the fused kernel takes the stack; fused
    kernel: 0, or 1 when fused.  The discriminators run no norm.
    """
    k, lw = cfg.train.unrolled_k, cfg.loss
    srgan_idt = lw.idt_reg * lw.idt > 0 and not gan.conditional_encoder(cfg)
    e_fwd = 3 if srgan_idt else 2
    e_bwd = 1 if cfg.pretrained_encoder else 2
    hist = 1 if lw.batch_KL > 0 and lw.hist > 0 and not fused else 0
    return {"cbinorm_fwd": (k + 2) * g_per + e_fwd * e_per,
            "cbinorm_bwd": 3 * g_per + e_bwd * e_per,
            "soft_histogram_fwd": hist,
            "soft_histogram_bwd": hist,
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
    """A trainer and seeded state of ``cfg``; its encoder trunk frozen
    where the preset says so (05_srgan_full)."""
    trainer = gan.GANTrainer(cfg, DEV)
    state = trainer.init_state(torch.Generator().manual_seed(0),
                               freeze_pretrained=cfg.pretrained_encoder)
    return trainer, state


# kernel names of the layout transposes cuDNN runs around a convolution,
# and of cuDNN's convolutions and cuBLAS's matrix products
TRANSPOSE_RE = re.compile(r"nchwToNhwc|nhwcToNchw", re.I)
CONV_RE = re.compile(r"conv|cudnn|xmma|gemm|implicit|dgrad|wgrad|fprop|"
                     r"cutlass", re.I)
# batch norm (VGG19-BN), ATen's kernels and cuDNN's
BATCH_NORM_RE = re.compile(r"batch_norm|bn_fw|bn_bw", re.I)


def profile_step(step):
    """One call of ``step`` under torch.profiler: device ms by kernel group
    (the norm kernels, the histogram and diversification kernels, batch
    norm, cuDNN's layout transposes, convolutions and matrix products, the
    rest) and the 12 kernels that take longest.  ``recorded`` is False
    where the trace holds no device time.  The kernels' sum can exceed the
    step's wall time where cuDNN runs kernels side by side."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups = dict.fromkeys(("norm", "histogram_diversification",
                            "batch_norm", "layout_transpose", "conv_matmul",
                            "rest"), 0.0)
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
        elif BATCH_NORM_RE.search(e.key):
            groups["batch_norm"] += ms
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
    gflop = step_gflop_per_image(cfg, trainer, state)
    say("== phase 8a: one more fp32 step under torch.profiler")
    prof_fp32 = profile_step(lambda: trainer.step(state, batches[-1]))
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
    prof_bf16 = profile_step(lambda: trainer.step(state, batches[2]))
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
        launches_per_step=want, step_gflop_per_image=gflop,
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


# ---------------------------------------------------------------------------
# phase 10: the data feed and the training loop
# ---------------------------------------------------------------------------

# images a class of the synthetic fixture: with test_num 4, 64 a class train,
# 256 in all, two steps of 128 an epoch
LOOP_PER_CLASS = 68
LOOP_TEST_NUM = 4
LOOP_EPOCHS = 2            # then a resume to LOOP_EPOCHS + 1
FEED_EPOCHS = 3            # epochs of the loader timed alone
FEED_WORKERS = 8


def probe_host():
    """What this host offers the data feed: PIL, the libpng and libjpeg
    headers, a link against both, and whether the native decoder builds."""
    def runs(cmd, stdin=None) -> bool:
        try:
            return subprocess.run(cmd, input=stdin, capture_output=True,
                                  text=True, timeout=120).returncode == 0
        except (OSError, subprocess.TimeoutExpired):
            return False

    found = {"cpu_count": os.cpu_count(),
             "PIL": importlib.util.find_spec("PIL") is not None}
    for header in ("png.h", "jpeglib.h"):
        found[header] = runs([native.CXX, "-E", "-x", "c++", "-"],
                             f"#include <{header}>\n")
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "probe.cc")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        found["link_png_jpeg"] = runs([native.CXX, src, "-o",
                                       os.path.join(d, "probe"), "-lpng",
                                       "-ljpeg"])
    found["native_decoder"] = native.available()
    if not found["native_decoder"]:
        err = native.build_error()
        found["native_build_error"] = next(
            (line.strip() for line in err.splitlines() if "error" in line),
            err.strip())[:300]
    return found


class LoopProbe:
    """Wraps the loop's device feed and the trainer's step while it is
    entered: the host seconds each ``next`` of the feed takes (the step
    waiting on its batch) and CUDA events around each step."""

    def __init__(self):
        self.waits, self.events = [], []

    def __enter__(self):
        self.feed, self.step = loop.prefetch_to_device, gan.GANTrainer.step
        feed, step = self.feed, self.step

        def timed_feed(iterator, device, size=2):
            it = feed(iterator, device, size)
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    return
                self.waits.append(time.perf_counter() - t0)
                yield batch

        def timed_step(trainer, state, batch, epoch=0):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(trainer, state, batch, epoch)
            end.record()
            self.events.append((start, end))
            return metrics

        loop.prefetch_to_device, gan.GANTrainer.step = timed_feed, timed_step
        return self

    def __exit__(self, *exc):
        loop.prefetch_to_device, gan.GANTrainer.step = self.feed, self.step

    def device_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def loader_img_s(ds, batch, decode, workers):
    """Images a second of the DataLoader alone over FEED_EPOCHS epochs."""
    dl = DataLoader(ds, batch_size=batch, num_workers=workers, seed=0,
                    decode=decode)
    t0 = time.perf_counter()
    n = sum(len(b["source_label"]) for _ in range(FEED_EPOCHS) for b in dl)
    return n / (time.perf_counter() - t0)


def loop_phase(cfg, g_per, e_per, bf16_img_s, name, power_limit, tmp):
    """Phase 10, in the directory ``tmp``.  Returns the `loop` record, the
    launches of the run, and the run directory and the fixture (image root,
    attribute file) for phase 13."""
    lcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="bfloat16", test_num=LOOP_TEST_NUM))
    B = lcfg.train.batch_size
    say(f"== phase 10: train_gan of {PRESET} at full width, bf16, batch "
        f"{B}, k = {lcfg.train.unrolled_k}, on a synthetic fixture of "
        f"{4 * LOOP_PER_CLASS} images, {LOOP_EPOCHS} epochs, then a resume "
        "to one more")
    probes = probe_host()
    say(f"host probes: {json.dumps(probes)}")
    if probes["native_decoder"]:
        decode = "native"
    else:
        check(probes["PIL"], "neither the native decoder nor PIL: the data "
              "feed cannot decode on this host")
        decode = "pil"
    say(f"decode: {decode!r}, chosen by name from the probes")
    t0 = time.perf_counter()
    img_root, attr_file = make_synthetic_celeba(
        os.path.join(tmp, "data"), n_per_class=LOOP_PER_CLASS)
    fixture_s = time.perf_counter() - t0
    # a classifier: the trunk and fcclass of a seeded random encoder
    clf = os.path.join(tmp, "classifier.pth")
    E = gan.build_encoder(lcfg, "cpu", torch.Generator().manual_seed(7))
    torch.save({k: v for k, v in E.state_dict().items()
                if not k.startswith(("fcmean.", "fcvar."))}, clf)
    out = os.path.join(tmp, "run")
    run = dict(data_root=img_root, attr_file=attr_file,
               classifier_ckpt=clf, sample_grids=False,
               checkpoint_every=1, echo=False, device=DEV,
               decode=decode)
    t0 = time.perf_counter()
    with LoopProbe() as probe:
        reset_counts()
        loop.train_gan(lcfg, out, epochs=LOOP_EPOCHS, **run)
        _, state = loop.train_gan(lcfg, out, epochs=LOOP_EPOCHS + 1,
                                  resume=True, **run)
        torch.cuda.synchronize()
        counts = read_counts()
    loop_s = time.perf_counter() - t0
    device_ms = probe.device_ms()
    check(os.path.exists(os.path.join(out, "config.json")),
          "no config.json")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    n_steps = len(device_ms)
    check(n_steps == 2 * (LOOP_EPOCHS + 1) == state.step,
          f"{n_steps} steps, state step {state.step}")
    check([r["step"] for r in records] == list(range(1, n_steps + 1)),
          f"step column {[r['step'] for r in records]}")
    check(all(math.isfinite(v) for r in records for v in r.values()
              if isinstance(v, float)), "a logged value is not finite")
    ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
    check(ckpts == [f"step_{i}" for i in range(1, LOOP_EPOCHS + 2)],
          f"checkpoints {ckpts}")
    changed = dataclasses.replace(lcfg, name="changed")
    try:
        loop.train_gan(changed, out, epochs=LOOP_EPOCHS + 2, resume=True,
                       **run)
        refused = False
    except ValueError as e:
        refused = "different config" in str(e)
    check(refused, "a resume with a changed config did not refuse")
    per_step = expected_counts(lcfg, g_per, e_per, fused=False)
    want = {k: v * n_steps for k, v in per_step.items()}
    check(counts == want, f"launches {counts}, derived {want}")

    train_ds, _ = loop.build_datasets(lcfg, img_root, attr_file)
    feed = {}
    for workers in sorted({FEED_WORKERS, os.cpu_count() or 1}):
        feed[str(workers)] = loader_img_s(train_ds, B, decode, workers)
    per_epoch = [r["images_per_sec"] for r in records[1::2]]
    steady = device_ms[1:LOOP_EPOCHS * 2] + device_ms[LOOP_EPOCHS * 2 + 1:]
    record = dict(
        preset=PRESET, compute_dtype="bfloat16", batch=B,
        unrolled_k=lcfg.train.unrolled_k, images=len(train_ds),
        steps=n_steps, decode=decode, probes=probes,
        card=name, power_limit=power_limit, cpu_count=os.cpu_count(),
        fixture_s=fixture_s, loop_s=loop_s,
        loader_img_s_by_workers=feed,
        wait_s_per_step=probe.waits,
        wait_s_mean=sum(probe.waits) / len(probe.waits),
        step_device_ms=device_ms,
        step_device_ms_steady_mean=sum(steady) / len(steady),
        loop_img_s_by_epoch=per_epoch,
        bf16_step_img_s_phase8=bf16_img_s,
        launches=counts, launches_per_step=per_step,
        metrics_last=records[-1])
    say(f"loop: {n_steps} steps in {loop_s:.1f} s; host wait per step "
        + ", ".join(f"{1e3 * w:.1f}" for w in probe.waits)
        + " ms; device ms per step "
        + ", ".join(f"{m:.1f}" for m in device_ms)
        + f"; img/s by epoch {', '.join(f'{v:.1f}' for v in per_epoch)} "
        f"against phase 8c's {bf16_img_s:.1f}; the loader alone "
        + ", ".join(f"{v:.1f} img/s on {w} workers" for w, v in feed.items())
        + f"; launches {counts}")
    return record, counts, dict(run=out, data=(img_root, attr_file),
                                decode=decode)


# ---------------------------------------------------------------------------
# phases 11-13: classifier pretraining, VGG19-BN and PRDC evaluation
# ---------------------------------------------------------------------------

# phase 11's pretrain_classifier run: 40 images a class, with val 4 and
# test 4 a class 32 train: two steps of 64 an epoch, validation at epochs 0
# and 3 (ClassifierConfig's test_interval), one test batch
CLF_CLI = dict(per_class=40, train_num=32, val_num=4, test_num=4, batch=64,
               epochs=4)
# phase 12's finetune_vgg runs: of the fixture's 24 images a class, with
# val 4 and test 4 a class 16 train: two steps of 32, one validation batch
VGG_CLI = dict(train_num=16, val_num=4, batch=32, epochs=1)
VGG_BATCH = 32
# phase 13's evaluate_prdc run: 32 test images a class of phase 10's
# fixture (68 a class), the reference's nearest_k
EVAL_SAMPLES = 32
EVAL_K = 5
# VGG19-BN features on the card against the CPU, relative to the largest
# entry: fp32 on both (TF32 off), but cuDNN's and the CPU's convolution
# algorithms sum in other orders through 16 layers (3.2e-6 measured on an
# H100; TF32 convolutions would be near 1e-3)
VGG_TOL = 3e-5
# the fine-tune's Adam moves a weight by at most about lr a step
VGG_LR = 5e-5


def forward_flops(model, x):
    """FLOPs a sample of one forward of ``model`` on ``x``: 2 a
    multiply-accumulate of every convolution and linear layer (the rest is
    a few percent), from the layers' output shapes."""
    total = 0

    def count(mod, _, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels // mod.groups * math.prod(mod.kernel_size)
        else:
            k = mod.in_features
        total += 2 * out.numel() * k

    hooks = [mod.register_forward_hook(count) for mod in model.modules()
             if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total / x.shape[0]


def tf32_on():
    return (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32)


def run_cli(main, argv):
    """An entry point's ``main(argv)`` in this process, with TF32 turned on
    first: it must turn TF32 off itself, so that what is checked and timed
    here is what its users get."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    main(argv)
    check(not tf32_on(), f"{main.__module__} left TF32 on")


def cli_arg_list(**kw):
    return [x for k, v in kw.items()
            for x in (f"--{k.replace('_', '-')}", str(v))]


def classifier_counts(ccfg, steps, eval_batches):
    """Norm launches of ``steps`` classifier train steps and
    ``eval_batches`` evaluation batches: 2 instance norms a block, forward
    in both, backward in a step (every norm's input needs a gradient: the
    first block's is ``first_layer``'s output)."""
    per = 2 * ccfg.model.e_num_cls
    return {"cbinorm_fwd": per * (steps + eval_batches),
            "cbinorm_bwd": per * steps, "soft_histogram_fwd": 0,
            "soft_histogram_bwd": 0, "diversification_fwd": 0}


def classifier_phase(cfg, work, decode, name, power_limit):
    """Phase 11.  Returns the `classifier` record."""
    from srgan_tpu_torch import pretrain_classifier
    from srgan_tpu_torch.configs import ClassifierConfig
    from srgan_tpu_torch.training.classifier import ClassifierTrainer

    ccfg = ClassifierConfig(model=cfg.model)
    m, B = ccfg.model, ccfg.batch_size
    say(f"== phase 11: encoder-classifier pretraining at full width "
        f"({m.image_size} px, e_nch {m.e_nch}, e_num_cls {m.e_num_cls}), "
        f"batch {B}, fp32, random init from a seeded torch.Generator")
    trainer = ClassifierTrainer(ccfg, DEV)
    state = trainer.init_state(torch.Generator().manual_seed(11))
    rng = np.random.default_rng(11)
    batches = [(torch.from_numpy(rng.uniform(-1, 1, (
        B, m.image_size, m.image_size, m.nch_in)).astype(np.float32)).to(DEV),
        torch.from_numpy(rng.integers(0, m.n_classes, B)).to(DEV))
        for _ in range(1 + TIMED_STEPS)]
    per_step = classifier_counts(ccfg, 1, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i, (x, y) in enumerate(batches):
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = trainer.step(state, x, y, epoch=i)
        end.record()
        torch.cuda.synchronize()
        counts = read_counts()
        metrics = {k: float(v) for k, v in metrics.items()}
        ms = start.elapsed_time(end)
        say(f"classifier step {i} ({'warm' if i == 0 else 'timed'}): device "
            f"{ms:.2f} ms, launches {counts}, {json.dumps(metrics)}")
        check(all(math.isfinite(v) for v in metrics.values()), metrics)
        check(counts == per_step, f"launches {counts}, derived {per_step}")
        steps.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reset_counts()
    trainer.predict(state, batches[0][0])
    per_eval = read_counts()
    check(per_eval == classifier_counts(ccfg, 0, 1),
          f"launches per evaluation batch {per_eval}")

    # one step's gradients through the kernels against the plain norm (and
    # the plain norm in float64), per tensor
    x = batches[0][0].permute(0, 3, 1, 2).contiguous()
    y = batches[0][1]
    fwd_flops = forward_flops(state.model, x[:1])
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())

    def grads():
        loss = F.cross_entropy(model(x), y)
        return torch.autograd.grad(loss, params)

    with deterministic_cudnn():
        got = grads()
        with plain_norm():
            want = grads()
        real = norm.fused_cbinorm
        norm.fused_cbinorm = plain64
        try:
            want64 = grads()
        finally:
            norm.fused_cbinorm = real
    worst = {"plain": (0.0, ""), "float64": (0.0, ""),
             "plain_vs_float64": (0.0, "")}
    for n, a, b, r in zip(names, got, want, want64):
        check(bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0,
              f"{n}: gradient through the kernels is zero or not finite")
        for key, u, v in (("plain", a, b), ("float64", a, r),
                          ("plain_vs_float64", b, r)):
            worst[key] = max(worst[key], (float((u - v).norm() / v.norm()),
                                          n))
    say(f"classifier gradients at batch {B}, per-tensor ||a - b|| / ||b||, "
        f"worst: kernels vs plain {worst['plain'][0]:.2e} "
        f"({worst['plain'][1]}), kernels vs float64 norm "
        f"{worst['float64'][0]:.2e} ({worst['float64'][1]}), plain vs "
        f"float64 norm {worst['plain_vs_float64'][0]:.2e} "
        f"({worst['plain_vs_float64'][1]}); tol {GRAD_TOL:g}")
    check(worst["plain"][0] <= GRAD_TOL and worst["float64"][0] <= GRAD_TOL,
          "classifier gradients through the kernels disagree")
    prof = profile_step(lambda: trainer.step(state, *batches[-1]))
    say_profile(f"one classifier step at batch {B}", prof)
    del trainer, state, model, batches, x, got, want, want64
    torch.cuda.empty_cache()

    c = CLF_CLI
    out = os.path.join(work, "clf")
    argv = ["--synthetic", "--synthetic-per-class", str(c["per_class"]),
            "--train-num", str(c["train_num"]), "--val-num",
            str(c["val_num"]), "--test-num", str(c["test_num"]),
            "--batch-size", str(c["batch"]), "--epochs", str(c["epochs"]),
            "--image-size", str(m.image_size), "--e-nch", str(m.e_nch),
            "--e-num-cls", str(m.e_num_cls), "--decode", decode,
            "--device", DEV, "--out", out]
    # the confusion-matrix figure needs matplotlib
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    if not has_mpl:
        argv.append("--no-confusion-plot")
    say("python -m srgan_tpu_torch.pretrain_classifier " + " ".join(argv))
    reset_counts()
    t0 = time.perf_counter()
    run_cli(pretrain_classifier.main, argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_counts = read_counts()
    train_n = 4 * min(c["train_num"],
                      c["per_class"] - c["val_num"] - c["test_num"])
    n_steps = c["epochs"] * (train_n // c["batch"])
    n_val = len(range(0, c["epochs"], ccfg.test_interval))
    n_eval = n_val * -(-4 * c["val_num"] // c["batch"]) \
        + -(-4 * c["test_num"] // c["batch"])
    want_cli = classifier_counts(ccfg, n_steps, n_eval)
    check(cli_counts == want_cli, f"launches {cli_counts}, derived "
          f"{want_cli} ({n_steps} steps, {n_eval} evaluation batches)")
    with open(os.path.join(out, "test_metrics.json")) as f:
        test_metrics = json.load(f)
    check(test_metrics["test_n"] == 4 * c["test_num"]
          and np.asarray(test_metrics["confusion_matrix"]).shape == (4, 4),
          test_metrics)
    check(os.path.exists(os.path.join(out, "confusion_matrix.png"))
          == has_mpl, "confusion_matrix.png written where matplotlib is "
          "missing, or missing where it is present")
    pth = os.path.join(out, "classifier_best.pth")
    sd = torch.load(pth, map_location="cpu", weights_only=True)
    E = gan.build_encoder(cfg, "cpu", torch.Generator().manual_seed(12))
    loop.load_pretrained_encoder(pth, E)
    esd = E.state_dict()
    check(all(torch.equal(esd[k], v) for k, v in sd.items()),
          "the encoder's trunk is not the classifier's bit for bit")
    say(f"pretrain_classifier: {cli_s:.1f} s, {n_steps} steps of "
        f"{c['batch']}, launches {cli_counts} (derived); test metrics "
        f"{json.dumps(test_metrics)}; classifier_best.pth ({len(sd)} "
        f"tensors) loaded into the {PRESET} encoder, trunk bit-equal")
    timed = steps[1:]
    mean_ms = sum(timed) / len(timed)
    # a train step: the forward and about twice its FLOPs backward
    step_tflop_s = 3 * fwd_flops * B / mean_ms / 1e9
    say(f"classifier: {fwd_flops / 1e9:.3f} GFLOP a forward an image, "
        f"{step_tflop_s:.1f} TFLOP/s a step "
        f"({100 * step_tflop_s * 1e12 / PEAK_FP32_FLOP_S:.0f} % of the fp32 "
        "peak)")
    return dict(
        batch=B, image_size=m.image_size, e_nch=m.e_nch,
        e_num_cls=m.e_num_cls, dtype="float32", tf32=False, card=name,
        power_limit=power_limit, warm_step_device_ms=steps[0],
        step_device_ms=timed, step_device_ms_mean=mean_ms,
        img_s=1e3 * B / mean_ms, peak_mem_gib=peak,
        forward_gflop_per_image=fwd_flops / 1e9, step_tflop_s=step_tflop_s,
        launches_per_step=per_step, launches_per_eval_batch=per_eval,
        grad_rel_l2_worst={k: v[0] for k, v in worst.items()},
        profile=prof, cli=dict(argv=argv, seconds=cli_s, steps=n_steps,
                 eval_batches=n_eval, launches=cli_counts,
                 test_metrics=test_metrics))


def vgg_phase(work, decode, name, power_limit):
    """Phase 12.  Returns the `vgg` record and the fine-tuned .pth."""
    from srgan_tpu_torch import finetune_vgg
    from srgan_tpu_torch.evaluation.features import (
        init_vgg,
        load_vgg,
        vgg_feature_extractor,
    )
    from srgan_tpu_torch.training.vgg_finetune import VGGFinetuneTrainer

    B = VGG_BATCH
    say(f"== phase 12: VGG19-BN at 224 px, batch {B}, fp32, torchvision's "
        "init from a seeded torch.Generator")
    cpu = init_vgg(torch.Generator().manual_seed(12))
    card = load_vgg(cpu.state_dict()).to(DEV)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (B, 3, 224, 224)).astype(np.float32))
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu(x)
    cpu_s = time.perf_counter() - t0
    extract = vgg_feature_extractor(card)
    xg = x.to(DEV)
    got = extract(xg).cpu()
    err = rel_err(got, want)
    feat_ms = cuda_ms(lambda: extract(xg), iters=10)[0]
    feat_prof = profile_step(lambda: extract(xg))
    fwd_flops = forward_flops(card, xg[:1])
    say(f"features at batch {B}: card vs CPU (the CPU took {cpu_s:.1f} s) "
        f"{err:.2e} of the largest entry (tol {VGG_TOL:g}); card "
        f"{feat_ms:.2f} ms a batch, {1e3 * B / feat_ms:.1f} img/s; "
        f"{fwd_flops / 1e9:.3f} GFLOP an image, "
        f"{fwd_flops * B / feat_ms / 1e9:.1f} TFLOP/s")
    check(err <= VGG_TOL and bool(torch.isfinite(got).all()),
          "VGG features on the card disagree with the CPU")
    say_profile(f"one VGG feature batch of {B}", feat_prof)
    del cpu, card, extract, xg

    trainer = VGGFinetuneTrainer(device=DEV)
    state = trainer.init_state(torch.Generator().manual_seed(13))
    rng = np.random.default_rng(13)
    xs = [torch.from_numpy(rng.standard_normal((B, 224, 224, 3)).astype(
        np.float32)).to(DEV) for _ in range(1 + TIMED_STEPS)]
    ys = torch.from_numpy(rng.integers(0, 4, B)).to(DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i, xb in enumerate(xs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = trainer.step(state, xb, ys, preprocessed=True)
        end.record()
        torch.cuda.synchronize()
        metrics = {k: float(v) for k, v in metrics.items()}
        steps.append(start.elapsed_time(end))
        check(all(math.isfinite(v) for v in metrics.values()), metrics)
        say(f"fine-tune step {i} ({'warm' if i == 0 else 'timed'}): device "
            f"{steps[-1]:.2f} ms, {json.dumps(metrics)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_prof = profile_step(lambda: trainer.step(state, xs[-1], ys,
                                                  preprocessed=True))
    say_profile(f"one fine-tune step at batch {B}", step_prof)
    del trainer, state, xs
    torch.cuda.empty_cache()

    c = VGG_CLI
    common = ["--synthetic", "--train-num", str(c["train_num"]), "--val-num",
              str(c["val_num"]), "--batch-size", str(c["batch"]),
              "--epochs", str(c["epochs"]), "--val-every", "1",
              "--decode", decode, "--device", DEV]
    # --synthetic holds out 4 test images a class
    train_n = 4 * min(c["train_num"], finetune_vgg.SYNTHETIC_PER_CLASS
                      - c["val_num"] - 4)
    n_steps = c["epochs"] * (train_n // c["batch"])
    runs = {}
    imagenet = os.path.join(work, "vgg19_bn_random.pth")
    src = init_vgg(torch.Generator().manual_seed(14)).state_dict()
    torch.save(src, imagenet)
    for arm, extra in (("init", []), ("imagenet", ["--imagenet-pth",
                                                   imagenet])):
        out = os.path.join(work, f"vgg_{arm}")
        argv = common + extra + ["--out", out]
        say("python -m srgan_tpu_torch.finetune_vgg " + " ".join(argv))
        t0 = time.perf_counter()
        run_cli(finetune_vgg.main, argv)
        torch.cuda.synchronize()
        runs[arm] = dict(argv=argv, seconds=time.perf_counter() - t0)
        sd = torch.load(os.path.join(out, "vgg_celeba_best.pth"),
                        map_location="cpu", weights_only=True)
        check(load_vgg(sd).num_classes == 4
              and int(sd["features.1.num_batches_tracked"]) == n_steps,
              f"{arm}: the written .pth is not a {n_steps}-step 4-way net")
        if arm == "imagenet":
            moved = max(float((sd[k] - v).abs().max()) for k, v in
                        src.items() if v.is_floating_point()
                        and not k.startswith("classifier.6.")
                        and "running" not in k)
            say(f"the --imagenet-pth run moved the file's weights by at "
                f"most {moved:.2e} (bound {2.2 * n_steps * VGG_LR:.1e}: "
                f"{n_steps} Adam steps at lr {VGG_LR:g})")
            check(0 < moved <= 2.2 * n_steps * VGG_LR,
                  "the fine-tune did not start from the --imagenet-pth")
            runs[arm]["max_weight_move"] = moved
        say(f"finetune_vgg ({arm}): {runs[arm]['seconds']:.1f} s, "
            f"{n_steps} steps, vgg_celeba_best.pth written")
    os.remove(imagenet)
    timed = steps[1:]
    mean_ms = sum(timed) / len(timed)
    return dict(
        batch=B, image_size=224, dtype="float32", tf32=False, card=name,
        power_limit=power_limit, features_rel_err_vs_cpu=err,
        feature_ms_batch=feat_ms, feature_img_s=1e3 * B / feat_ms,
        forward_gflop_per_image=fwd_flops / 1e9,
        feature_tflop_s=fwd_flops * B / feat_ms / 1e9,
        feature_profile=feat_prof, finetune_profile=step_prof,
        finetune_warm_step_device_ms=steps[0],
        finetune_step_device_ms=timed, finetune_step_device_ms_mean=mean_ms,
        finetune_img_s=1e3 * B / mean_ms, finetune_peak_mem_gib=peak,
        cli=runs), os.path.join(work, "vgg_init", "vgg_celeba_best.pth")


def evaluation_phase(g_per, loop_out, vgg_pth, work, name, power_limit):
    """Phase 13.  Returns the `evaluation` record."""
    import pickle

    from srgan_tpu_torch import evaluate_prdc
    from srgan_tpu_torch.evaluation import GANEvaluation, compute_prdc
    from srgan_tpu_torch.evaluation.prdc import pairwise_distances
    from srgan_tpu_torch.evaluation.harness import METRICS

    say(f"== phase 13: evaluate_prdc on phase 10's checkpoint, "
        f"vgg-initialization and phase 12's vgg-CelebA, all 16 pairs, "
        f"{EVAL_SAMPLES} samples a pair, nearest_k {EVAL_K}")
    img_root, attr_file = loop_out["data"]
    pkl = os.path.join(work, "prdc.pkl")
    fes = ["vgg-initialization", "vgg-CelebA"]
    argv = ["--ckpt", os.path.join(loop_out["run"], "ckpt"), "--data-root",
            img_root, "--attr-file", attr_file, "--feature-extractors", *fes,
            "--vgg-celeba-ckpt", vgg_pth, "--num-samples", str(EVAL_SAMPLES),
            "--test-num", str(EVAL_SAMPLES), "--nearest-k", str(EVAL_K),
            "--device", DEV, "--out", pkl]
    say("python -m srgan_tpu_torch.evaluate_prdc " + " ".join(argv))
    real_transform = gan.transform
    per_call = []

    def counting(*a, **k):
        before = read_counts()
        result = real_transform(*a, **k)
        per_call.append({key: v - before[key]
                         for key, v in read_counts().items()})
        return result

    gan.transform = counting
    reset_counts()
    t0 = time.perf_counter()
    try:
        run_cli(evaluate_prdc.main, argv)
    finally:
        gan.transform = real_transform
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = read_counts()
    per_translate = {"cbinorm_fwd": g_per, "cbinorm_bwd": 0,
                     "soft_histogram_fwd": 0, "soft_histogram_bwd": 0,
                     "diversification_fwd": 0}
    check(len(per_call) == 16 and all(c == per_translate for c in per_call),
          f"launches per translate {per_call}, derived {per_translate}")
    check(counts == {k: 16 * v for k, v in per_translate.items()},
          f"launches {counts}")
    with open(pkl, "rb") as f:
        results = pickle.load(f)
    for fe in fes:
        for s in range(4):
            for t in range(4):
                r = {k: v[0] for k, v in results[fe][s][t].items()}
                check(all(len(v) == 1 for v in results[fe][s][t].values())
                      and all(math.isfinite(v) for v in r.values())
                      and all(0 <= r[k] <= 1 for k in
                              ("precision", "recall", "coverage"))
                      and r["density"] >= 0, (fe, s, t, r))
    tables = {fe: {m: [[results[fe][s][t][m][0] for t in range(4)]
                       for s in range(4)] for m in METRICS} for fe in fes}

    # a set against itself, the timings of the harness's three stages
    ds = FaceDataset(img_root, attr_file=attr_file, data_type="test",
                          train_num=10000, val_num=0, test_num=EVAL_SAMPLES)
    images = np.stack([ds[i][0] for i in range(2 * EVAL_SAMPLES)])
    ev = GANEvaluation("vgg-initialization", device=DEV)
    same = ev.get_prdc(images[:EVAL_SAMPLES], images[:EVAL_SAMPLES],
                       nearest_k=EVAL_K)
    say(f"a set of {EVAL_SAMPLES} against itself: {json.dumps(same)}")
    check(same["precision"] == same["coverage"] == 1.0,
          "a set against itself is not precision = coverage = 1 exactly")
    t0 = time.perf_counter()
    pre = ev.preprocess(images)
    pre_img_s = len(images) / (time.perf_counter() - t0)
    feat_ms = wall_ms(lambda: ev.get_feature(pre), iters=3)
    f = ev.get_feature(pre)
    f1, f2 = f[:EVAL_SAMPLES], f[EVAL_SAMPLES:]
    prdc_ms = wall_ms(lambda: compute_prdc(f1, f2, EVAL_K, device=DEV))
    # every point twice: at k = 1 each radius is exactly 0 on the exact
    # path, so no strict "<" holds and all four metrics are exactly 0; a
    # matrix-product distance leaves rounding noise in radii and distances
    real2, fake2 = torch.cat([f1, f1]), torch.cat([f2, f2])
    d = pairwise_distances(real2, real2)
    dup = compute_prdc(real2, fake2, 1, device=DEV)
    say(f"{2 * EVAL_SAMPLES} x 4096 features, each twice, at k = 1: "
        f"{json.dumps(dup)}; the largest self- and duplicate distance "
        f"{float(d.diag().max()):g}, "
        f"{float(d.diag(EVAL_SAMPLES).max()):g}")
    check(float(d.diag().max()) == float(d.diag(EVAL_SAMPLES).max()) == 0
          and all(v == 0.0 for v in dup.values()),
          "duplicate features are not exactly 0 apart on the card")
    say(f"evaluate_prdc: {cli_s:.1f} s; norm launches per translate "
        f"{per_translate['cbinorm_fwd']} (derived: one G forward), "
        f"{counts['cbinorm_fwd']} in the run; preprocess (host) "
        f"{pre_img_s:.1f} img/s; get_feature (batch 32, host clock, the "
        f"copies in) {1e3 * len(images) / feat_ms:.1f} img/s; PRDC of "
        f"{EVAL_SAMPLES} vs {EVAL_SAMPLES} x 4096 {prdc_ms:.3f} ms (host "
        "clock, synchronised)")
    for fe in fes:
        say(f"{fe} coverage (source x target): "
            + json.dumps(tables[fe]["coverage"]))
    return dict(card=name, power_limit=power_limit, argv=argv,
                seconds=cli_s, samples_per_pair=EVAL_SAMPLES,
                nearest_k=EVAL_K, launches=counts,
                launches_per_translate=per_translate, self_prdc=same,
                duplicates_prdc_k1=dup,
                preprocess_img_s_host=pre_img_s,
                get_feature_img_s_host=1e3 * len(images) / feat_ms,
                prdc_ms=prdc_ms, tables=tables)


# ---------------------------------------------------------------------------
# phase 14: the trainer variants
# ---------------------------------------------------------------------------

class DSnapshots:
    """Wraps ``state.opt_d.step``: after the first D update of each train
    step it keeps a copy of D's parameters, the values that
    ``unrolled_restore`` must leave them at."""

    def __init__(self, state, k):
        self.state, self.k, self.calls, self.snap = state, k, 0, None
        self.real = state.opt_d.step

        def step(*a, **kw):
            out = self.real(*a, **kw)
            if self.calls % self.k == 0:
                self.snap = [p.detach().clone()
                             for p in state.D.parameters()]
            self.calls += 1
            return out

        state.opt_d.step = step

    def check(self, steps_done):
        state = self.state
        same = all(torch.equal(p, v) for p, v in
                   zip(state.D.parameters(), self.snap))
        adam = {int(state.opt_d.state[p]["step"])
                for p in state.D.parameters()}
        check(same, "unrolled_restore: D's parameters are not their values "
              "after the step's first update")
        check(adam == {self.k * steps_done}, f"Adam's step counts {adam}, "
              f"want {self.k * steps_done} (all k updates)")
        return dict(params_equal_snapshot=same, adam_step=adam.pop())


def step_gflop_per_image(cfg, trainer, state):
    """Forward GFLOP an image of one train step of ``cfg`` on ``state``'s
    nets (2 a multiply-accumulate, ``forward_flops``), a backward through
    the weights and the input counted as two forwards and one through the
    input alone as one: G (k + 14) g, or (k + 11) g without phase 2's pair;
    D (6k + 2) d, d over every domain's D; E (5, or 3 without the pair, + 2
    if the encoder trains + 1 for the SRGAN identity regression) e.  The
    calls are those of ``expected_counts``."""
    m, k, lw = cfg.model, cfg.train.unrolled_k, cfg.loss
    x = torch.zeros((1, m.nch_in, m.image_size, m.image_size), device=DEV)
    c = torch.zeros((1, m.num_con), device=DEV)

    class Call(torch.nn.Module):
        def __init__(self, net, fn):
            super().__init__()
            self.net, self.fn = net, fn

        def forward(self, x):
            return self.fn(self.net, x)

    g = forward_flops(Call(state.G, lambda net, x: net(x, c)), x)
    e = forward_flops(Call(state.E, lambda net, x: trainer._E(
        net, x, c[:, :m.n_classes])), x)
    d = forward_flops(Call(state.D, lambda net, x: [Di(x) for Di in net]
                           if isinstance(net, torch.nn.ModuleList)
                           else net(x)), x)
    pair = lw.idt_reg * lw.idt > 0
    srgan_idt = pair and not gan.conditional_encoder(cfg)
    g_units = k + (14 if pair else 11)
    e_units = (5 if pair else 3) + (0 if cfg.pretrained_encoder else 2) \
        + int(srgan_idt)
    return (g_units * g + (6 * k + 2) * d + e_units * e) / 1e9


def variants_phase(g_per, e_per, name, power_limit):
    """Phase 14.  Returns the `variants` record and the launches per step
    of each variant."""
    say(f"== phase 14: the trainer variants at full width, batch 128, fp32 "
        f"(TF32 off): 1 warm and {VARIANT_TIMED_STEPS} timed steps each, "
        "random weights from a seeded torch.Generator, synthetic batches")
    record, launches = {}, {}
    for preset, over in VARIANTS:
        cfg = PRESETS[preset]()
        if over:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, **over))
        key = preset + "".join(f"+{k}" for k in over)
        k = cfg.train.unrolled_k
        want = expected_counts(cfg, g_per, e_per)
        batches = make_batches(cfg, 1 + VARIANT_TIMED_STEPS, seed=14)
        t0 = time.perf_counter()
        trainer, state = fresh(cfg)
        init_s = time.perf_counter() - t0
        snaps = DSnapshots(state, k) if cfg.train.unrolled_restore else None
        torch.cuda.reset_peak_memory_stats()
        steps, restore = [], None
        for i, batch in enumerate(batches):
            metrics, dev_ms, host_ms, counts = timed_step(trainer, state,
                                                          batch)
            check(counts == want, f"{key}: launches {counts}, derived "
                  f"{want}")
            if snaps is not None:
                restore = snaps.check(i + 1)
            steps.append(dict(metrics=metrics, device_ms=dev_ms,
                              host_ms=host_ms))
            say(f"{key} step {i} ({'warm' if i == 0 else 'timed'}): device "
                f"{dev_ms:.1f} ms, host {host_ms:.1f} ms, launches "
                f"{counts}, " + json.dumps(metrics))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        timed = [st["device_ms"] for st in steps[1:]]
        gflop = step_gflop_per_image(cfg, trainer, state)
        mean_ms = sum(timed) / len(timed)
        rec = dict(trainer=cfg.trainer, unrolled_k=k,
                   encoded_feature=cfg.train.encoded_feature,
                   loss=dataclasses.asdict(cfg.loss),
                   freeze_pretrained=cfg.pretrained_encoder, init_s=init_s,
                   warm_step_device_ms=steps[0]["device_ms"],
                   step_device_ms=timed,
                   step_host_ms=[st["host_ms"] for st in steps[1:]],
                   step_device_ms_mean=mean_ms,
                   img_s=1e3 * cfg.train.batch_size * len(timed) / sum(timed),
                   step_gflop_per_image=gflop,
                   step_tflop_s=gflop * cfg.train.batch_size / mean_ms,
                   peak_mem_gib=peak, launches_per_step=want,
                   metrics_last_step=steps[-1]["metrics"])
        if restore is not None:
            rec["unrolled_restore"] = restore
        record[key] = rec
        launches[key] = want
        del trainer, state, snaps
        torch.cuda.empty_cache()

    preset = VARIANTS[0][0]
    cfg = PRESETS[preset]()
    bcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="bfloat16"))
    trainer, state = fresh(bcfg)
    want = expected_counts(bcfg, g_per, e_per)
    torch.cuda.reset_peak_memory_stats()
    bf16 = []
    for batch in make_batches(bcfg, 2, seed=15):
        metrics, dev_ms, host_ms, counts = timed_step(trainer, state, batch)
        check(counts == want, f"bf16 {preset}: launches {counts}, derived "
              f"{want}")
        bf16.append(dict(device_ms=dev_ms, host_ms=host_ms, metrics=metrics))
        say(f"{preset} bf16 step: device {dev_ms:.1f} ms, host "
            f"{host_ms:.1f} ms, launches {counts}, " + json.dumps(metrics))
    record[preset]["bf16"] = dict(
        warm_step_device_ms=bf16[0]["device_ms"],
        step_device_ms=bf16[1]["device_ms"],
        img_s=1e3 * bcfg.train.batch_size / bf16[1]["device_ms"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        metrics=bf16[1]["metrics"])
    del trainer, state
    torch.cuda.empty_cache()
    for key, rec in record.items():
        say(f"{key}: {rec['step_device_ms_mean']:.1f} ms a step, "
            f"{rec['img_s']:.1f} img/s, peak {rec['peak_mem_gib']:.2f} GiB, "
            f"{rec['step_gflop_per_image']:.1f} GFLOP an image a step "
            f"(step_gflop_per_image), {rec['step_tflop_s']:.1f} TFLOP/s")
    return dict(batch=cfg.train.batch_size, dtype="float32", tf32=False,
                card=name, power_limit=power_limit, presets=record), launches


# ---------------------------------------------------------------------------
# phase 15: visualisation
# ---------------------------------------------------------------------------

VIZ_SAMPLES = 2            # random latents of the grid and of the sweep


def viz_phase(cfg, loop_out, probes, work, name, power_limit):
    """Phase 15, in the directory ``work``.  Returns the `visualisation`
    record."""
    from srgan_tpu_torch import sample_sweep
    from srgan_tpu_torch.utils import viz
    from srgan_tpu_torch.utils.checkpoint import restore_checkpoint

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    say(f"== phase 15: visualisation at the full width of {SOLO_PRESET} "
        f"(card against CPU, {VIZ_SAMPLES} latents), sample_sweep and the "
        f"loop's grids on phase 10's run; matplotlib "
        f"{'present' if has_mpl else 'missing'}, PIL "
        f"{'present' if probes['PIL'] else 'missing'} on this host")
    img_root, attr_file = loop_out["data"]
    run = loop_out["run"]
    with open(os.path.join(run, "config.json")) as f:
        lcfg = config_from_dict(json.load(f))
    test_ds = FaceDataset(img_root, attr_file=attr_file, data_type="test",
                          train_num=lcfg.train.train_num, val_num=0,
                          test_num=lcfg.train.test_num,
                          image_size=lcfg.model.image_size)
    rec = dict(card=name, power_limit=power_limit, matplotlib=has_mpl,
               PIL=probes["PIL"])

    # the device parts on the card and on the CPU, the same weights
    scfg = PRESETS[SOLO_PRESET]()
    sd = {}
    gen = torch.Generator().manual_seed(31)
    for net, build in (("G", gan.build_generator), ("E", gan.build_encoder)):
        sd[net] = build(scfg, "cpu", gen).state_dict()
    img, label = test_ds[0]
    classes = tuple(range(scfg.model.n_classes))
    lat = viz.progress_latents(VIZ_SAMPLES, len(classes) - 1,
                               scfg.model.ndim,
                               torch.Generator().manual_seed(32))
    sweep = np.random.default_rng(0).standard_normal(
        (VIZ_SAMPLES, scfg.model.ndim)).astype(np.float32)
    out = {}
    for dev in (DEV, "cpu"):
        trainer = gan.GANTrainer(scfg, dev)
        state = trainer.init_state(g_state=sd["G"], e_state=sd["E"])
        t0 = time.perf_counter()
        panels = viz.progress_panels(trainer, state, img, label, classes,
                                     VIZ_SAMPLES, latents=lat)
        data, labels = viz.get_samples(trainer, state, test_ds, 0, sweep,
                                       classes=classes)
        out[dev] = (panels, data, labels, time.perf_counter() - t0)
        del trainer, state
    err = max(
        [float(np.abs(out[DEV][0][k] - v).max())
         for k, v in out["cpu"][0].items()]
        + [float(np.abs(out[DEV][1]["target"][c] - v).max())
           for c, v in out["cpu"][1]["target"].items()]
        + [float(np.abs(out[DEV][2]["latent"][c] - v).max())
           for c, v in out["cpu"][2]["latent"].items()])
    rec.update(card_vs_cpu_max_abs_err=err, card_s=out[DEV][3],
               cpu_s=out["cpu"][3])
    say(f"progress panels and sweep, card against CPU: max abs {err:.3e} "
        f"(tol {MODEL_TOL:g}); card {out[DEV][3]:.2f} s, CPU "
        f"{out['cpu'][3]:.2f} s")
    check(err <= MODEL_TOL, "the visualisation's arrays on the card "
          "disagree with the CPU's")

    if probes["PIL"]:
        sweep_dir = os.path.join(work, "sweep")
        argv = ["--ckpt", os.path.join(run, "ckpt"), "--data-root", img_root,
                "--attr-file", attr_file, "--out", sweep_dir, "--device",
                DEV] + ([] if has_mpl else ["--no-grid"])
        say("python -m srgan_tpu_torch.sample_sweep " + " ".join(argv))
        reset_counts()
        t0 = time.perf_counter()
        run_cli(sample_sweep.main, argv)
        sweep_s = time.perf_counter() - t0
        written = sorted(os.listdir(sweep_dir))
        want = sorted([f"index0_class{c}.gif" for c in classes]
                      + [f"latent_mu_class{c}.npy" for c in classes]
                      + (["result_index0_grid.png"] if has_mpl else []))
        check(written == want, f"sample_sweep wrote {written}")
        # the same sweep from the checkpoint, in this process
        trainer = gan.GANTrainer(lcfg, DEV)
        state = trainer.init_state(freeze_pretrained=lcfg.pretrained_encoder)
        restore_checkpoint(os.path.join(run, "ckpt"), state)
        latent = np.random.default_rng(0).standard_normal(
            (24, lcfg.model.ndim)).astype(np.float32)
        _, lab = viz.get_samples(trainer, state, test_ds, 0, latent,
                                 classes=classes)
        mu_err = max(float(np.abs(np.load(os.path.join(
            sweep_dir, f"latent_mu_class{c}.npy")) - lab["latent"][c]).max())
            for c in classes)
        check(mu_err <= MODEL_TOL, f"sample_sweep's mu differ by {mu_err}")
        del trainer, state
        rec["sample_sweep"] = dict(seconds=sweep_s, files=written,
                                   launches=read_counts())
        rec["sample_sweep"]["mu_max_abs_err_vs_in_process"] = mu_err
        say(f"sample_sweep: {sweep_s:.1f} s, {written}, launches "
            f"{rec['sample_sweep']['launches']}; its mu {mu_err:.3e} from "
            f"the same sweep in this process (tol {MODEL_TOL:g})")

    # the loop with its grids (the CLI's default)
    grid_run = os.path.join(work, "grid_run")
    run_args = dict(data_root=img_root, attr_file=attr_file,
                    classifier_ckpt=os.path.join(work, "classifier.pth"),
                    sample_grids=True, echo=False, device=DEV,
                    decode=loop_out["decode"])
    steps = []
    real_step = gan.GANTrainer.step

    def counting(trainer, state, batch, epoch=0):
        steps.append(1)
        return real_step(trainer, state, batch, epoch)

    gan.GANTrainer.step = counting
    try:
        if has_mpl:
            t0 = time.perf_counter()
            loop.train_gan(lcfg, grid_run, epochs=1, **run_args)
            grid_s = time.perf_counter() - t0
            pngs = sorted(p for p in os.listdir(grid_run)
                          if p.endswith(".png"))
            n_steps = len(steps)
            interval = max(n_steps // 3, 1)
            want = [f"progress_e000_i{i:05d}.png"
                    for i in range(0, n_steps, interval)]
            check(pngs == want, f"grids {pngs}, the JAX cadence {want}")
            rec["loop_grids"] = dict(seconds=grid_s, steps=n_steps,
                                     files=pngs)
            say(f"train_gan with grids: {n_steps} steps, {pngs} in "
                f"{grid_s:.1f} s")
        else:
            try:
                loop.train_gan(lcfg, grid_run, epochs=1, **run_args)
                refused = False
            except RuntimeError as e:
                refused = "matplotlib" in str(e)
            check(refused and not steps and not os.path.exists(grid_run),
                  "train_gan with grids and no matplotlib did not refuse "
                  "before its first step")
            rec["loop_grids"] = dict(refused_before_any_step=True)
            say("train_gan with grids and no matplotlib: refused before "
                "any step, nothing written")
    finally:
        gan.GANTrainer.step = real_step
    return rec


# ---------------------------------------------------------------------------
# phase 16: batch-norm mode
# ---------------------------------------------------------------------------

BN_TIMED_STEPS = 2
# eval-mode transform of one image against its row of the whole batch's
# call: the running statistics make each row its own (fp32, cuDNN's
# algorithm may differ with the batch size)
BN_ROW_TOL = 1e-4


def running_stats(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()
            if "running" in k}


def batch_norm_phase(g_per, e_per, name, power_limit):
    """Phase 16.  Returns the `batch_norm` record and the launches of one
    step."""
    cfg = PRESETS[PRESET]()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, norm_type="batch"))
    B, k = cfg.train.batch_size, cfg.train.unrolled_k
    say(f"== phase 16: batch-norm mode of {PRESET} at full width: batch "
        f"{B}, k = {k}, fp32 (TF32 off), frozen encoder trunk, 1 warm and "
        f"{BN_TIMED_STEPS} timed steps")
    # CBBNorm and BatchNorm are plain torch ops: no norm kernel a forward
    want = expected_counts(cfg, 0, 0)
    batches = make_batches(cfg, 1 + BN_TIMED_STEPS, seed=16)
    trainer, state = fresh(cfg)
    before = {"G": running_stats(state.G), "E": running_stats(state.E)}
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i, batch in enumerate(batches):
        metrics, dev_ms, host_ms, counts = timed_step(trainer, state, batch)
        say(f"batch-norm step {i} ({'warm' if i == 0 else 'timed'}): device "
            f"{dev_ms:.1f} ms, host {host_ms:.1f} ms, launches {counts}, "
            + json.dumps(metrics))
        check(counts == want, f"batch mode: launches {counts}, derived "
              f"{want}")
        steps.append(dict(metrics=metrics, device_ms=dev_ms,
                          host_ms=host_ms))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_step(lambda: trainer.step(state, batches[-1]))
    say_profile("one batch-mode step", prof)
    moved = {}
    for net in ("G", "E"):
        after = running_stats(getattr(state, net))
        check(set(after) == set(before[net]) and after,
              f"{net} has no running statistics")
        moved[net] = sum(not torch.equal(after[key], before[net][key])
                         for key in after)
        check(moved[net] == len(after), f"{net}: {len(after) - moved[net]} "
              "running statistics did not move")
    images = batches[0]["image"]
    tgt = batches[0]["target_label"]
    latent = torch.randn((B, cfg.model.ndim), device=DEV,
                         generator=torch.Generator(DEV).manual_seed(16))
    full, _ = gan.transform(state.G, images, tgt, latent)
    one, _ = gan.transform(state.G, images[:1], tgt[:1], latent[:1])
    row_err = float((one[0] - full[0]).abs().max())
    say(f"eval-mode transform of image 0 alone against its row of the "
        f"batch of {B}: max abs {row_err:.3e} (tol {BN_ROW_TOL:g})")
    check(bool(torch.isfinite(full).all()), "batch-mode transform is not "
          "finite")
    check(row_err <= BN_ROW_TOL, "eval-mode transform depends on the batch")
    timed = [s["device_ms"] for s in steps[1:]]
    del trainer, state
    torch.cuda.empty_cache()
    return dict(preset=PRESET, norm_type="batch", batch=B, unrolled_k=k,
                tf32=False, freeze_pretrained=True, card=name,
                power_limit=power_limit,
                warm_step_device_ms=steps[0]["device_ms"],
                step_device_ms=timed,
                step_host_ms=[s["host_ms"] for s in steps[1:]],
                step_device_ms_mean=sum(timed) / len(timed),
                img_s=1e3 * B * len(timed) / sum(timed),
                peak_mem_gib=peak, launches_per_step=want,
                running_stats_moved=moved, transform_row_max_abs=row_err,
                metrics_last_step=steps[-1]["metrics"], profile=prof), want


# ---------------------------------------------------------------------------
# phase 17: data parallel, two ranks on the one card
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_TIMED_STEPS = 1
# the metrics of the two-rank step against the single-process step:
# tests/test_sharding.py:108-114's tolerance
DP_TOL = 2e-3
DP_TIMEOUT_S = 600
DP_LR = 1e-4


class InjectedTrainer(gan.GANTrainer):
    """Hands out the given draws, in order, at the step's seam."""

    def _draw_latent(self, shape):
        arr = self.draws[self.draw_i]
        self.draw_i += 1
        check(tuple(arr.shape) == tuple(shape),
              f"draw {tuple(arr.shape)} for {tuple(shape)}")
        return arr.to(self.device)


def param_parity(ours, theirs, n_steps, what, bound_only=False):
    """``tests/test_torch_train.py``'s Adam-sign-tolerant criterion: the
    largest difference within n_steps opposite Adam steps, the mean a small
    fraction of one, under 1 % of the elements off by more than 1e-6.
    Returns the largest and mean difference."""
    d = torch.cat([(ours[k].float() - theirs[k].float()).abs().reshape(-1)
                   for k in sorted(theirs)]).double()
    worst, mean = float(d.max()), float(d.mean())
    frac = float((d > 1e-6).double().mean())
    check(worst <= 2.2 * n_steps * DP_LR, f"{what}: max {worst:.3e}")
    if not bound_only:
        check(mean < 0.02 * DP_LR, f"{what}: mean {mean:.3e}")
        check(frac < 0.01, f"{what}: {frac:.3%} of the elements off")
    return dict(max_abs=worst, mean_abs=mean, frac_above_1e6=frac)


def _dp_rank(rank, work, nprocs):
    """One rank of phase 17: joins the gloo group on the parent's device
    (cuda:0 for every rank), steps once on
    its rows of the global batch from the saved weights and draws (its
    launches counted), then DP_TIMED_STEPS more; saves what it measured."""
    from srgan_tpu_torch.parallel import make_mesh, shard_batch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    inp = torch.load(os.path.join(work, "dp_inputs.pt"), weights_only=False)
    mesh = make_mesh(inp["device"], backend="gloo",
                     init_method="file://" + os.path.join(work, "rdzv"))
    try:
        cfg = config_from_dict(inp["config"])
        trainer = InjectedTrainer(cfg, mesh=mesh)
        state = trainer.init_state(g_state=inp["G"], d_state=inp["D"],
                                   e_state=inp["E"],
                                   hist_target=inp["hist_target"],
                                   freeze_pretrained=True)
        batch = shard_batch(inp["batch"], mesh)
        batch["image"] = batch["image"].to(mesh.device)
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(1 + DP_TIMED_STEPS):
            trainer.draws, trainer.draw_i = inp["draws"], 0
            metrics, dev_ms, host_ms, counts = timed_step(trainer, state,
                                                          batch)
            steps.append(dict(device_ms=dev_ms, host_ms=host_ms,
                              launches=counts, metrics=metrics))
            if i == 0:
                first = {net: {k: v.detach().cpu().clone() for k, v in
                               getattr(state, net).state_dict().items()}
                         for net in ("G", "D", "E")}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # every rank's parameters against rank 0's, after the first step
        flat = torch.cat([v.reshape(-1).float() for net in ("G", "D", "E")
                          for v in first[net].values()]).to(mesh.device)
        ref = flat.clone()
        torch.distributed.broadcast(ref, src=0)
        rank_diff = float((flat - ref).abs().max())
        out = dict(steps=steps, peak_mem_gib=peak, rank_diff=rank_diff,
                   backend=mesh.backend, device=str(mesh.device))
        if rank == 0:
            out["state"] = first
        torch.save(out, os.path.join(work, f"dp_out{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(fn, work, nprocs, timeout):
    """``fn(rank, work, nprocs)`` on ``nprocs`` spawned processes; a rank
    that raises makes this raise, and one still running after ``timeout``
    seconds is killed and this raises."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=(work, nprocs), nprocs=nprocs, join=False,
        start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            check(time.monotonic() <= deadline,
                  f"a rank ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def data_parallel_phase(g_per, e_per, work, name, power_limit):
    """Phase 17, in the directory ``work``.  Returns the `data_parallel`
    record and one rank's launches of its step."""
    cfg = PRESETS[PRESET]()
    B, k, ndim = cfg.train.batch_size, cfg.train.unrolled_k, cfg.model.ndim
    say(f"== phase 17: data parallel, {DP_RANKS} ranks under gloo on the "
        f"one card (cuda:0), the {PRESET} step at full width on a global "
        f"batch of {B} ({B // DP_RANKS} a rank), fp32, from the same "
        "weights and draws as one single-process step; the only place "
        "where the collectives meet CUDA tensors (gloo stages them through "
        "the host); it checks correctness across ranks, not scaling")
    want = expected_counts(cfg, g_per, e_per)
    rng = np.random.default_rng(17)
    draws = [torch.from_numpy(rng.standard_normal((B, ndim))
                              .astype(np.float32)) for _ in range(k)]
    batch = make_batches(cfg, 1, seed=17)[0]
    with deterministic_cudnn():
        trainer = InjectedTrainer(cfg, DEV)
        state = trainer.init_state(torch.Generator().manual_seed(0),
                                   freeze_pretrained=True)
        start = {net: {k2: v.detach().cpu().clone() for k2, v in
                       getattr(state, net).state_dict().items()}
                 for net in ("G", "D", "E")}
        hist_target = state.hist_target.cpu()
        trainer.draws, trainer.draw_i = draws, 0
        single, s_ms, _, s_counts = timed_step(trainer, state, batch)
        check(s_counts == want, f"single-process step: launches "
              f"{s_counts}, derived {want}")
        post = {net: {k2: v.detach().cpu().clone() for k2, v in
                      getattr(state, net).state_dict().items()}
                for net in ("G", "D", "E")}
    del trainer, state
    torch.cuda.empty_cache()
    host_batch = {key: v.cpu() for key, v in batch.items()}
    torch.save(dict(device="cuda:0" if DEV == "cuda" else DEV,
                    config=dataclasses.asdict(cfg), draws=draws,
                    hist_target=hist_target, batch=host_batch, **start),
               os.path.join(work, "dp_inputs.pt"))
    t0 = time.perf_counter()
    run_ranks(_dp_rank, work, DP_RANKS, DP_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    outs = [torch.load(os.path.join(work, f"dp_out{r}.pt"),
                       weights_only=False) for r in range(DP_RANKS)]
    for r, out in enumerate(outs):
        for i, st in enumerate(out["steps"]):
            say(f"rank {r} step {i} ({'compared' if i == 0 else 'timed'}): "
                f"device {st['device_ms']:.1f} ms, host "
                f"{st['host_ms']:.1f} ms, launches {st['launches']}, peak "
                f"{out['peak_mem_gib']:.2f} GiB")
            check(st["launches"] == want, f"rank {r}: launches "
                  f"{st['launches']}, derived {want}")
        check(out["rank_diff"] == 0.0, f"rank {r}'s parameters differ from "
              f"rank 0's by {out['rank_diff']:.3e}")
        check(out["steps"][0]["metrics"] == outs[0]["steps"][0]["metrics"],
              f"rank {r}'s metrics differ from rank 0's")
    dp = outs[0]["steps"][0]["metrics"]
    check(set(dp) == set(single), (sorted(dp), sorted(single)))
    worst = max(abs(dp[key] - v) / max(abs(v), 1e-12)
                for key, v in single.items())
    say(f"single-process step: device {s_ms:.1f} ms, "
        + json.dumps(single))
    say(f"two-rank step: " + json.dumps(dp) + f"; worst relative "
        f"difference {worst:.2e} (tol {DP_TOL:g})")
    check(worst <= DP_TOL, "the two-rank step disagrees with the "
          "single-process step")
    params = {net: param_parity(outs[0]["state"][net], post[net], n, net,
                                bound_only=net == "G")
              for net, n in (("G", 2), ("D", k), ("E", 1))}
    say(f"parameters after the step against the single-process step: "
        + json.dumps(params))
    return dict(
        preset=PRESET, ranks=DP_RANKS, backend=outs[0]["backend"],
        device=outs[0]["device"], global_batch=B,
        batch_per_rank=B // DP_RANKS, unrolled_k=k, tf32=False,
        freeze_pretrained=True, card=name, power_limit=power_limit,
        single_step_device_ms=s_ms,
        rank_step_device_ms=[[st["device_ms"] for st in o["steps"]]
                             for o in outs],
        rank_step_host_ms=[[st["host_ms"] for st in o["steps"]]
                           for o in outs],
        rank_peak_mem_gib=[o["peak_mem_gib"] for o in outs],
        launches_per_rank_step=want, metrics_single=single,
        metrics_two_rank=dp, worst_rel_diff=worst, params=params,
        ranks_wall_s=ranks_s,
        note="two ranks share one card: correctness across ranks, not "
             "scaling"), want


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")

    t_script = time.perf_counter()
    say("== phase 1: device")
    card = card_line()
    say(card)
    name, power_limit = [s.strip() for s in card.split(",", 1)]
    gan.resolve_device(DEV)
    check(not tf32_on(), "resolve_device left TF32 on")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "TF32 off for convolutions and matmuls, as the port's "
        "resolve_device sets it")

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

    say(f"== phase 7: gradients of G + E + D + {SOLO_PRESET}'s conditional "
        f"E at batch {CHECK_BATCH}, kernels vs plain norm")
    grad_worst = check_gradient_repair(cfg, g_per, e_per)

    training, launches, fused_launches = training_phase(
        cfg, g_per, e_per, name, power_limit)
    tot = time_training_kernels(cfg, shapes, cgen, name, power_limit)
    with tempfile.TemporaryDirectory() as work:
        loop_record, loop_launches, loop_out = loop_phase(
            cfg, g_per, e_per, training["bf16"]["img_s"], name, power_limit,
            work)
        # the CLIs write their synthetic fixtures into the temporary
        # directory: this one, removed at the end
        saved_tempdir, tempfile.tempdir = tempfile.tempdir, work
        try:
            t0 = time.perf_counter()
            classifier = classifier_phase(cfg, work, loop_out["decode"], name,
                                          power_limit)
            t1 = time.perf_counter()
            vgg, vgg_pth = vgg_phase(work, loop_out["decode"], name,
                                     power_limit)
            t2 = time.perf_counter()
            evaluation = evaluation_phase(g_per, loop_out, vgg_pth, work,
                                          name, power_limit)
            t3 = time.perf_counter()
            variants, variant_launches = variants_phase(g_per, e_per, name,
                                                        power_limit)
            t4 = time.perf_counter()
            visualisation = viz_phase(cfg, loop_out, loop_record["probes"],
                                      work, name, power_limit)
            t5 = time.perf_counter()
            batch_norm, bn_launches = batch_norm_phase(g_per, e_per, name,
                                                       power_limit)
            t6 = time.perf_counter()
            data_parallel, dp_launches = data_parallel_phase(
                g_per, e_per, work, name, power_limit)
            t7 = time.perf_counter()
            classifier["phase_s"], vgg["phase_s"] = t1 - t0, t2 - t1
            evaluation["phase_s"] = t3 - t2
            variants["phase_s"], visualisation["phase_s"] = t4 - t3, t5 - t4
            batch_norm["phase_s"], data_parallel["phase_s"] = t6 - t5, t7 - t6
            say(f"phases 11-17: {t1 - t0:.1f}, {t2 - t1:.1f}, "
                f"{t3 - t2:.1f}, {t4 - t3:.1f}, {t5 - t4:.1f}, "
                f"{t6 - t5:.1f}, {t7 - t6:.1f} s")
        finally:
            tempfile.tempdir = saved_tempdir

    entries = []
    for kn, meta in KERNELS.items():
        t = tot[kn]
        n = fused_launches[kn] if kn == "diversification_fwd" \
            else launches[kn]
        check(n > 0, f"{kn} was not launched on its path")
        check(kn == "diversification_fwd" or loop_launches[kn] > 0,
              f"{kn} was not launched by the training loop")
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
        entry["launches_loop"] = loop_launches[kn]
        entry["launches_batch_mode"] = bn_launches[kn]
        entry["launches_data_parallel_rank"] = dp_launches[kn]
        check(kn == "diversification_fwd" or dp_launches[kn] > 0,
              f"{kn} was not launched by a data-parallel rank")
        check(kn not in ("soft_histogram_fwd", "soft_histogram_bwd")
              or bn_launches[kn] > 0,
              f"{kn} was not launched by the batch-mode step")
        entry["launches_variants"] = {key: c[kn] for key, c in
                                      variant_launches.items()}
        check(kn == "diversification_fwd"
              or all(c[kn] > 0 for key, c in variant_launches.items()
                     if "conventional" not in key),
              f"{kn} was not launched by a trainer variant")
        if kn in ("cbinorm_fwd", "cbinorm_bwd"):
            entry["launches_classifier_step"] = \
                classifier["launches_per_step"][kn]
            entry["launches_classifier_cli"] = \
                classifier["cli"]["launches"][kn]
            entry["launches_evaluation_translate"] = \
                evaluation["launches_per_translate"][kn]
            entry["launches_evaluation"] = evaluation["launches"][kn]
            check(classifier["cli"]["launches"][kn] > 0,
                  f"{kn} was not launched by the classifier pretraining")
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
    say(json.dumps({"loop": loop_record}))
    say(f"phases 1-17: {time.perf_counter() - t_script:.1f} s")
    say(json.dumps({"classifier": classifier}))
    say(json.dumps({"vgg": vgg}))
    say(json.dumps({"evaluation": evaluation}))
    say(json.dumps({"variants": variants}))
    say(json.dumps({"visualisation": visualisation}))
    say(json.dumps({"batch_norm": batch_norm}))
    say(json.dumps({"data_parallel": data_parallel}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
