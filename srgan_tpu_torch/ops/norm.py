"""Conditional instance norm: the CUDA kernels' wrappers and their plain
twins.

Counterpart of ``srgan_tpu/ops/pallas/norm.py``.  ``fused_cbinorm`` is a
``torch.autograd.Function``: on a CUDA tensor its forward launches
``srgan_cbinorm_fwd`` and its backward ``srgan_cbinorm_bwd`` (both in
``csrc/cbinorm.cu``), or raises; on a CPU tensor they compute
``cbinorm_plain`` and ``cbinorm_bwd_plain``, the same functions in plain
PyTorch, which are also the kernels' oracles on the card.

x may be stored NCHW or channels-last (NHWC in memory, NCHW in shape, as
the nets keep their activations on CUDA); the wrapper reads which from x's
strides.  A channels-last CUDA x launches the NHWC pair
(``srgan_cbinorm_fwd_nhwc``, ``srgan_cbinorm_bwd_nhwc``) and counts one
``norm.nhwc`` a call; an NCHW one the NCHW pair; a CPU x either way the
plain twins.  out and dx keep x's layout.  Each launch counts one
``launch.`` and its kernel's name (``launch.cbinorm_fwd_nhwc``, ...) in
``utils/spans``; the plain twins count none.
"""

from __future__ import annotations

import ctypes

import torch

from srgan_tpu_torch.utils import spans

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the counter of the calls that take the NHWC pair, forward or backward
NHWC_COUNTER = "norm.nhwc"


def channels_last(x) -> bool:
    """Whether x is stored channels-last and not also NCHW-contiguous (a
    tensor with C = 1 or H = W = 1 is both; it takes the NCHW pair)."""
    return (not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def layout(x) -> torch.memory_format:
    """x's memory format: ``torch.channels_last`` or
    ``torch.contiguous_format``."""
    return torch.channels_last if channels_last(x) else \
        torch.contiguous_format


def dense(x):
    """x itself where it is contiguous NCHW or channels-last, which the
    norm takes as it is; else an NCHW copy."""
    if x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last):
        return x
    return x.contiguous()


def _compute_dtype(dtype):
    """fp32 for fp32 and bf16; float64 stays float64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def cbinorm_plain(x, t, g, b, eps: float = 1e-5, relu: bool = False):
    """out = relu?((IN(x) + t[b, c]) * g[c] + b[c]) in plain PyTorch.

    x: (B, C, H, W) float32 or bfloat16; t: (B, C), g and b: (C,) float32.
    Statistics in fp32 with the one-pass formula and variance clamp of
    ``srgan_tpu/nn/layers.py:110-118``; the affine and ReLU as at
    ``:356-361``.  Like the kernel, the normalised value is not rounded to
    x's dtype before the conditional bias is added.  Returns
    (out in x's dtype, mu (B, C) fp32, rstd (B, C) fp32).
    """
    x32 = x.to(_compute_dtype(x.dtype))
    mean = x32.mean(dim=(2, 3), keepdim=True)
    m2 = (x32 * x32).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp_min(m2 - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    out = (x32 - mean) * rstd
    out = (out + t[:, :, None, None]) * g[None, :, None, None] \
        + b[None, :, None, None]
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(x.dtype), mean[:, :, 0, 0], rstd[:, :, 0, 0]


def cbinorm_bwd_plain(x, t, g, b, mu, rstd, dy, relu: bool = False):
    """Gradient of ``cbinorm_plain``'s output in plain PyTorch, the math of
    ``srgan_tpu/ops/pallas/norm.py:139-156``: the ReLU mask recomputed from
    the output, then

        db = sum dy',  dg = sum dy' (xhat + t),  dt = g sum_hw dy',
        dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),

    with dxhat = dy' g.  Returns (dx in x's dtype, dt (B, C), dg (C,),
    db (C,)), the last three fp32."""
    ct = _compute_dtype(x.dtype)
    dy = dy.to(ct)
    r = rstd[:, :, None, None]
    xhat = (x.to(ct) - mu[:, :, None, None]) * r
    if relu:
        out = (xhat + t[:, :, None, None]) * g[None, :, None, None] \
            + b[None, :, None, None]
        dy = dy * (out > 0)
    s1 = dy.sum(dim=(2, 3))
    db = s1.sum(0)
    dg = (dy * (xhat + t[:, :, None, None])).sum(dim=(0, 2, 3))
    dt = s1 * g[None, :]
    dxhat = dy * g[None, :, None, None]
    m1 = dxhat.mean(dim=(2, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(2, 3), keepdim=True)
    dx = r * (dxhat - m1 - xhat * m2)
    return dx.to(x.dtype), dt, dg, db


def _check(x, t, g, b):
    if x.dim() != 4:
        raise ValueError(f"fused_cbinorm takes NCHW x, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_cbinorm takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    B, C = x.shape[:2]
    for name, v, shape in (("t", t, (B, C)), ("g", g, (C,)), ("b", b, (C,))):
        if tuple(v.shape) != shape:
            raise ValueError(f"fused_cbinorm: {name} must have shape {shape}, "
                             f"got {tuple(v.shape)}")
        if v.dtype != torch.float32:
            raise TypeError(f"fused_cbinorm: {name} must be float32, got "
                            f"{v.dtype}")
    for name, v in (("x", x), ("t", t), ("g", g), ("b", b)):
        if v.device != x.device:
            raise ValueError(f"fused_cbinorm: {name} is on {v.device}, x on "
                             f"{x.device}")
        if not (v.is_contiguous() or name == "x" and channels_last(v)):
            raise ValueError(f"fused_cbinorm: {name} must be contiguous"
                             + (" (NCHW or channels-last)" if name == "x"
                                else ""))
    if x.numel() == 0:
        raise ValueError("fused_cbinorm: x is empty")
    if B * C >= 2 ** 31 or x.shape[2] * x.shape[3] >= 2 ** 31:
        raise ValueError("fused_cbinorm: B*C and H*W must fit in int32")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_cbinorm runs on cuda (kernel) or cpu "
                         f"(plain), not on {x.device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x, t, g, b, eps: float, relu: bool, nhwc=None):
    """One call of ``srgan_cbinorm_fwd`` or, given an NHWC plan ``nhwc``
    for a channels-last x, of ``srgan_cbinorm_fwd_nhwc``; out takes x's
    layout."""
    from srgan_tpu_torch.ops.build import load

    B, C, H, W = x.shape
    out = torch.empty_like(x)
    mu = torch.empty((B, C), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    lib = load("cbinorm")
    if nhwc is None:
        fn, planes, plan = lib.srgan_cbinorm_fwd, B * C, ()
    else:
        fn, planes, plan = lib.srgan_cbinorm_fwd_nhwc, B, nhwc
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), t.data_ptr(), g.data_ptr(), b.data_ptr(),
                 out.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                 planes, C, H * W, ctypes.c_float(eps), int(relu),
                 _DTYPE_CODE[x.dtype], *plan, _stream(x))
    if err != 0:
        raise RuntimeError(f"cbinorm kernel launch failed: cudaError_t {err}")
    spans.count("launch.cbinorm_fwd" if nhwc is None
                 else "launch.cbinorm_fwd_nhwc")
    return out, mu, rstd


# The backward kernel's tiers (csrc/cbinorm.cu, which checks every plan it
# is given against the same constants): a warp per plane up to
# 32 * WARP_ITEMS[-1] elements, then 1 to MAX_CLUSTER blocks of CTA_THREADS
# threads holding CTA_ITEMS elements each, then two passes.
BWD_WARP, BWD_CTA, BWD_TWO_PASS = 0, 1, 2
WARP_ITEMS = (2, 8, 32)
CTA_THREADS, CTA_ITEMS, MAX_CLUSTER = 256, 16, 8


def bwd_plan(hw: int, itemsize: int, aligned: bool = True):
    """(tier, items, vec, cluster) of the backward kernel for planes of
    ``hw`` elements of ``itemsize`` bytes: the elements each thread holds
    in registers (0 for two passes), the elements per 16-byte access (1:
    scalar) and the blocks per plane.  16-byte accesses need 16-byte
    aligned tensors and a plane length that keeps every plane so."""
    vec = 16 // itemsize
    if not aligned or hw % vec:
        vec = 1
    if hw <= 32 * WARP_ITEMS[-1]:
        items = next(e for e in WARP_ITEMS if 32 * e >= hw)
        return BWD_WARP, items, vec if items % vec == 0 else 1, 1
    cluster = -(-hw // (CTA_THREADS * CTA_ITEMS))
    if cluster <= MAX_CLUSTER:
        return BWD_CTA, CTA_ITEMS, vec, cluster
    return BWD_TWO_PASS, 0, 1, 1


def _launch_bwd(x, t, g, b, mu, rstd, dy, relu: bool, affine: bool,
                nhwc=None):
    """One call of ``srgan_cbinorm_bwd`` or, given an NHWC plan ``nhwc``
    for a channels-last x and dy, of ``srgan_cbinorm_bwd_nhwc``: one grid
    writes dx (and, under ``affine``, dt and the per-plane sums), and under
    ``affine`` a second grid of the same call reduces the sums over the
    batch into dg and db in a fixed order (no atomics).  Without ``affine``
    dt, dg and db are None."""
    from srgan_tpu_torch.ops.build import load

    B, C, H, W = x.shape
    dx = torch.empty_like(x)
    dt = parts = dg = db = None
    if affine:
        dt = torch.empty((B, C), dtype=torch.float32, device=x.device)
        parts = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
        dg = torch.empty((C,), dtype=torch.float32, device=x.device)
        db = torch.empty_like(dg)
    if nhwc is None:
        aligned = all(v.data_ptr() % 16 == 0 for v in (x, dy, dx))
        fn = load("cbinorm").srgan_cbinorm_bwd
        plan = bwd_plan(H * W, x.element_size(), aligned)
    else:
        fn, plan = load("cbinorm").srgan_cbinorm_bwd_nhwc, nhwc
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dy.data_ptr(), t.data_ptr(), g.data_ptr(),
                 b.data_ptr(), mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                 *(0 if v is None else v.data_ptr()
                   for v in (dt, parts, dg, db)),
                 B, C, H * W, int(relu), int(affine), _DTYPE_CODE[x.dtype],
                 *plan, _stream(x))
    if err != 0:
        raise RuntimeError(f"cbinorm backward kernel launch failed: "
                           f"cudaError_t {err}")
    spans.count("launch.cbinorm_bwd" if nhwc is None
                 else "launch.cbinorm_bwd_nhwc")
    return dx, dt, dg, db


# The channels-last kernels' plans (csrc/cbinorm.cu checks every plan
# against the same limits).  A tile is a group of TC 16-byte vectors along C
# of one sample (TC one of NHWC_TC); the 1 to NHWC_MAX_CLUSTER blocks of a
# cluster hold its pixels, each ``rows * boxes`` of them as TMA boxes of
# ``rows`` pixels (a multiple of 8, at most NHWC_BOX_ROWS), in a ring of
# more than ``boxes`` and at most NHWC_MAX_SLOTS slots of a box each, which
# fits NHWC_SMEM bytes with the block's bookkeeping (``nhwc_smem``).  The
# grid is persistent, as many clusters as the card holds.
NHWC_TC = (8, 4, 2, 1)
NHWC_MAX_CLUSTER = 16
NHWC_BOX_ROWS = 256
NHWC_MAX_SLOTS = 64
NHWC_SMEM = 232448
# the plan's aims, not limits of the kernels: a block's share of a tile of
# at most NHWC_TILE_BYTES (x, and dy in the backward) where one fits, two
# boxes loading beside the tile in hand where they fit, and enough blocks
# for the card's NHWC_SMS SMs
NHWC_TILE_BYTES = 128 * 1024
NHWC_LOOKAHEAD = 2
NHWC_SMS = 132
# a call that moves at most NHWC_SMALL_CALL bytes is bound by latency, not
# by the memory's rate: its plan weighs a cluster's exchange (about
# NHWC_EXCHANGE_US) against the time a block takes over its share
# (NHWC_BLOCK_BYTES_PER_US, at half the rate for 16-byte rows)
NHWC_SMALL_CALL = 8 << 20
NHWC_EXCHANGE_US = 2.0
NHWC_BLOCK_BYTES_PER_US = 50e3


def nhwc_smem(plan, itemsize: int, tensors: int) -> int:
    """Shared memory bytes a block of ``plan`` takes: its alignment, the
    ring, and the bookkeeping (per channel of the group: coefficients, the
    warps' sums and the cluster's; two barriers a slot and two more)."""
    tc, rows, _, cluster, slots = plan
    cb = tc * 16 // itemsize
    return (128 + slots * rows * tc * 16 * tensors + (88 + 16 * cluster) * cb
            + 16 * slots + 16)


def nhwc_slab(hw: int, cluster: int):
    """(rows, boxes) of each of ``cluster`` blocks that share a sample's
    ``hw`` pixels: the fewest boxes of at most NHWC_BOX_ROWS pixels, each a
    multiple of 8 pixels.  None where the last block would hold none."""
    pixels = -(-hw // cluster)
    boxes = -(-pixels // NHWC_BOX_ROWS)
    rows = -(-pixels // (8 * boxes)) * 8
    if (cluster - 1) * rows * boxes >= hw:
        return None
    return rows, boxes


def nhwc_plan(b: int, hw: int, c: int, itemsize: int, tensors: int = 1):
    """(tc, rows, boxes, cluster, slots) of the NHWC kernels for ``b``
    samples of ``hw`` pixels and ``c`` channels of ``itemsize`` bytes, with
    ``tensors`` tensors staged (1: the forward's x; 2: the backward's x and
    dy).  First a block's share of a tile of at most NHWC_TILE_BYTES; then
    the most blocks up to the card's SMs (a small batch spreads each sample
    over more blocks and narrower groups), or, for a call of at most
    NHWC_SMALL_CALL bytes, the least time estimated from a block's share
    and a cluster's exchange; then the widest group (the longest runs of
    bytes a pixel, for the copy engine and the memory); then the fewest
    blocks a tile.  The ring holds the tile's boxes and NHWC_LOOKAHEAD
    more, or one more where that is all that fits.  None where C is not a
    whole number of vectors or no ring fits a tile and one more box."""
    vec = 16 // itemsize
    small = b * hw * c * itemsize * tensors <= NHWC_SMALL_CALL
    best = key = None
    for tc in NHWC_TC:
        if c % (tc * vec):
            continue
        tiles = b * c // (tc * vec)
        for cluster in range(1, NHWC_MAX_CLUSTER + 1):
            slab = nhwc_slab(hw, cluster)
            if slab is None:
                continue
            rows, boxes = slab
            slots = next((boxes + n for n in range(NHWC_LOOKAHEAD, 0, -1)
                          if nhwc_smem((tc, rows, boxes, cluster, boxes + n),
                                       itemsize, tensors) <= NHWC_SMEM),
                         None)
            if slots is None:
                continue
            share = rows * boxes * tc * 16 * tensors
            if small:
                rounds = -(-tiles * cluster // (2 * NHWC_SMS))
                us = (rounds * share * (2 if tc == 1 else 1)
                      / NHWC_BLOCK_BYTES_PER_US
                      + (NHWC_EXCHANGE_US if cluster > 1 else 0.0))
                k = (share <= NHWC_TILE_BYTES, -us, tc, -cluster)
            else:
                k = (share <= NHWC_TILE_BYTES,
                     min(tiles * cluster, NHWC_SMS), tc, -cluster)
            if key is None or k > key:
                best, key = (tc, rows, boxes, cluster, slots), k
    return best


def _nhwc_plan_for(x, *others):
    """The NHWC plan of a call that stages x and ``others`` (the backward's
    dy), or None where there is none or a tensor is not 16-byte aligned."""
    if any(v.data_ptr() % 16 for v in (x, *others)):
        return None
    B, C, H, W = x.shape
    return nhwc_plan(B, H * W, C, x.element_size(), 1 + len(others))


def cbinorm_fwd(x, t, g, b, eps: float = 1e-5, relu: bool = False):
    """The forward alone, no graph: the kernels on a CUDA x (the NHWC pair
    for a channels-last x, counting one ``norm.nhwc``), ``cbinorm_plain``
    on a CPU x.  Returns (out in x's layout, mu, rstd).  Counts one
    ``norm.fwd``."""
    _check(x, t, g, b)
    spans.count("norm.fwd")
    if x.device.type != "cuda":
        return cbinorm_plain(x, t, g, b, eps, relu)
    if not channels_last(x):
        return _launch(x, t, g, b, eps, relu)
    plan = _nhwc_plan_for(x)
    if plan is None:
        # no NHWC plan for the shape: the NCHW kernel on a copy
        out, mu, rstd = _launch(x.contiguous(), t, g, b, eps, relu)
        return out.contiguous(memory_format=torch.channels_last), mu, rstd
    spans.count(NHWC_COUNTER)
    return _launch(x, t, g, b, eps, relu, plan)


def cbinorm_bwd(x, t, g, b, mu, rstd, dy, relu: bool = False,
                affine: bool = True):
    """The backward alone: the kernels on a CUDA x (as ``cbinorm_fwd``
    chooses them), ``cbinorm_bwd_plain`` on a CPU x.  dy must have x's
    shape; it is cast to x's dtype and brought to x's layout.  Returns (dx
    in x's layout, dt, dg, db); without ``affine`` (no gradient wanted for
    t, g or b) the kernel writes dx alone, and dt, dg and db are None on
    both devices.  Counts one ``norm.bwd``."""
    _check(x, t, g, b)
    spans.count("norm.bwd")
    dy = dy.to(x.dtype).contiguous(memory_format=layout(x))
    if tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise ValueError(f"cbinorm_bwd: dy {tuple(dy.shape)} on {dy.device} "
                         f"does not match x {tuple(x.shape)} on {x.device}")
    for name, v in (("mu", mu), ("rstd", rstd)):
        if (tuple(v.shape) != tuple(x.shape[:2]) or v.dtype != torch.float32
                or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"cbinorm_bwd: {name} must be contiguous "
                             f"float32 {tuple(x.shape[:2])} on {x.device}")
    if x.device.type == "cuda":
        if not channels_last(x):
            return _launch_bwd(x, t, g, b, mu, rstd, dy, relu, affine)
        plan = _nhwc_plan_for(x, dy)
        if plan is None:
            dx, dt, dg, db = _launch_bwd(x.contiguous(), t, g, b, mu, rstd,
                                         dy.contiguous(), relu, affine)
            return (dx.contiguous(memory_format=torch.channels_last), dt, dg,
                    db)
        spans.count(NHWC_COUNTER)
        return _launch_bwd(x, t, g, b, mu, rstd, dy, relu, affine, plan)
    dx, dt, dg, db = cbinorm_bwd_plain(x, t, g, b, mu, rstd, dy, relu)
    return (dx, dt, dg, db) if affine else (dx, None, None, None)


class CBINormFunction(torch.autograd.Function):
    """``cbinorm_fwd`` with ``cbinorm_bwd`` as its gradient.  Saves x, t, g,
    b, mu and rstd; the ReLU mask is recomputed from them.  mu and rstd are
    outputs without a gradient.  Where none of t, g, b needs a gradient (the
    plain instance norm) the backward asks for dx alone."""

    @staticmethod
    def forward(ctx, x, t, g, b, eps, relu):
        out, mu, rstd = cbinorm_fwd(x, t, g, b, eps, relu)
        ctx.save_for_backward(x, t, g, b, mu, rstd)
        ctx.relu = relu
        ctx.mark_non_differentiable(mu, rstd)
        return out, mu, rstd

    @staticmethod
    def backward(ctx, dy, _dmu, _drstd):
        x, t, g, b, mu, rstd = ctx.saved_tensors
        want = ctx.needs_input_grad[:4]
        grads = cbinorm_bwd(x, t, g, b, mu, rstd, dy, ctx.relu,
                            affine=any(want[1:]))
        return (*(v if w else None for v, w in zip(grads, want)), None,
                None)


def fused_cbinorm(x, t, g, b, eps: float = 1e-5, relu: bool = False):
    """out = relu?((IN(x) + t[b, c]) * g[c] + b[c]), with (mu, rstd).

    x: (B, C, H, W) float32 or bfloat16, contiguous NCHW or channels-last;
    t: (B, C) conditional bias (already tanh'ed), g, b: (C,) affine, all
    float32 on x's device.  A CUDA x launches the kernels of its layout
    (forward, and backward when a gradient flows back); a CPU x takes the
    plain twins; any other device raises.  Returns (out in x's dtype and
    layout, mu, rstd).
    """
    return CBINormFunction.apply(x, t, g, b, eps, relu)


def fused_instance_norm(x, eps: float = 1e-5, relu: bool = False):
    """Plain instance norm (optionally + ReLU): the same kernel with t = 0,
    g = 1, b = 0, as ``srgan_tpu/ops/pallas/norm.py:162-168``."""
    B, C = x.shape[:2]
    zeros_t = torch.zeros((B, C), dtype=torch.float32, device=x.device)
    ones = torch.ones((C,), dtype=torch.float32, device=x.device)
    zeros = torch.zeros((C,), dtype=torch.float32, device=x.device)
    return fused_cbinorm(x, zeros_t, ones, zeros, eps, relu)[0]
