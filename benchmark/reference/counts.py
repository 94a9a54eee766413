"""The work of one training step or one served forward, worked out from a
configuration's shapes on the meta device: the FLOPs of the plain
reference (``torch.utils.flop_counter`` over its convolutions and matrix
products, forward and backward) and the list of norm applications, with
the least time each needs at the card's HBM rate.

It counts the architecture's work, whatever the program under test runs it
with: a kernel that takes over a convolution does not lower the count."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import nets
from benchmark.reference.peaks import PEAK_BYTES_S, PEAK_FP32_FLOP_S
from benchmark.reference.step import Reference

# per element: sum (1 add), sum of squares (1 fma), apply (1 fma)
FLOPS_PER_ELEM = 5
# backward, per element: two passes of the mask and xhat (4), the two sums
# (3), dx (4)
BWD_FLOPS_PER_ELEM = 11


def bound(nbytes: float, ops: float) -> float:
    """Least ms: the larger of the bytes over the HBM rate and the
    operations over the fp32 rate."""
    return 1e3 * max(nbytes / PEAK_BYTES_S, ops / PEAK_FP32_FLOP_S)


def bound_ms(B, C, H, W, itemsize: int = 4) -> float:
    """Least time for one forward application: each input read once (x, t,
    g, b), each output written once (y, mu, rstd)."""
    n = B * C * H * W
    return bound(2 * n * itemsize + 4 * (3 * B * C + 2 * C),
                 FLOPS_PER_ELEM * n)


def bwd_bound_ms(B, C, H, W, itemsize: int = 4) -> float:
    """Least time for one backward application: x and dy read once, dx
    written once; t, g, b, mu, rstd read and dt, dg, db written once."""
    n = B * C * H * W
    return bound(3 * n * itemsize + 4 * (4 * B * C + 4 * C),
                 BWD_FLOPS_PER_ELEM * n)


class _NormLog:
    """Records every norm application and whether a gradient flowed back
    through it."""

    def __init__(self):
        self.fwd, self.bwd = [], []

    def __call__(self, x, affine):
        shape = tuple(x.shape)
        self.fwd.append(shape)
        if x.requires_grad:
            # the application's output gets a gradient iff its input does
            x.register_hook(lambda g: self.bwd.append(shape))


def _itemsize(config) -> int:
    # every norm's input is a convolution's output, or a sum of them, which
    # autocast computes in the configuration's compute dtype
    return 2 if config["train"]["compute_dtype"] == "bfloat16" else 4


def train_step_work(config: dict, device="meta") -> dict:
    """{"flops": FLOPs of one step, "norm_bound_ms": the norms' least ms in
    one step, "norm_fwd": applications, "norm_bwd": backward
    applications}, at the configuration's batch.  On the meta device (the
    default) it computes shapes only; on another it runs the step on
    seeded weights, for the tests to hold the two counts together."""
    B = config["train"]["batch_size"]
    m = config["model"]
    hist = torch.full((50,), 0.02, device=device)
    sds = None
    if torch.device(device).type != "meta":
        sds = nets.init_weights(nets.build(config, "meta"),
                                torch.Generator(device).manual_seed(0),
                                device)
    ref = Reference(config, sds, hist, device, 0)
    hw = m["image_size"]
    images = torch.rand((B, hw, hw, m["nch_in"]), device=device) * 2 - 1
    labels = torch.arange(B, device=device) % m["n_classes"]
    log = _NormLog()
    nets.NORM_HOOK = log
    try:
        counter = FlopCounterMode(display=False)
        with counter:
            ref.step(images, labels, (labels + 1) % m["n_classes"])
    finally:
        nets.NORM_HOOK = None
    isz = _itemsize(config)
    ms = sum(bound_ms(*s, isz) for s in log.fwd) \
        + sum(bwd_bound_ms(*s, isz) for s in log.bwd)
    return {"flops": float(counter.get_total_flops()), "norm_bound_ms": ms,
            "norm_fwd": len(log.fwd), "norm_bwd": len(log.bwd)}
