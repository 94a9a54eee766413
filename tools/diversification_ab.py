"""Time the fused diversification kernel beside other builds of the same C
entry point on one CUDA card, with the plan's cluster and with one block.

    python3 tools/diversification_ab.py [OTHER.cu ...]

Builds ``srgan_tpu_torch/csrc/diversification.cu`` and every OTHER.cu (each
must export ``srgan_diversification_fwd`` with the same arguments and take
a (D, bins) fp32 workspace) with ``nvcc``, the package's flags and
``-Xptxas -v``, all started together, into ``build/diversification_ab/``,
and prints each build's registers, shared memory and spills as the
compiler reports them.  It holds every build, at every shape and cluster
size, against ``diversification_plain`` (``REL_TOL`` per output) and
against its own repeat (same bits), then times them in turns, ``ROUNDS``
rounds of ``ITERS`` back-to-back launches each, and prints every round's
time and, last, one JSON line.  Needs CUDA; run from the repository root.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from srgan_tpu_torch.ops import build, diversification, histogram  # noqa: E402
from srgan_tpu_torch.ops import losses as L  # noqa: E402

OUT = ROOT / "build" / "diversification_ab"
# the main path's shape, the least batch, more columns than a cluster has
# blocks, and a batch the old one-block kernel refused
SHAPES = ((128, 8, 50), (2, 8, 50), (128, 20, 50), (4096, 8, 50))
ROUNDS = 7
ITERS = 100


def compile_all(sources):
    """{name: (ctypes library, the compiler's resource lines)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for name, src in sources.items():
        so = OUT / f"lib{name}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
               str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    argtypes, restype = build.SIGNATURES["diversification"][
        "srgan_diversification_fwd"]
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n"
                               f"{err}{out}")
        lib = ctypes.CDLL(str(so))
        fn = lib.srgan_diversification_fwd
        fn.argtypes = list(argtypes)
        fn.restype = restype
        report = [ln.strip() for ln in err.splitlines()
                  if "registers" in ln or "spill" in ln]
        libs[name] = (fn, report)
    return libs


def launcher(fn, mu, target, K, bins=50):
    """A call of ``fn`` on mu with a cluster of K blocks, into a fresh
    (3,) output, as ``diversification.diversification_fwd`` makes it."""
    B, D = mu.shape
    delta, norm = histogram._consts(bins, -10.0, 10.0, 0.2)
    rows = torch.empty((D, bins), dtype=torch.float32, device=mu.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        out = torch.empty((3,), dtype=torch.float32, device=mu.device)
        err = fn(mu.data_ptr(), target.data_ptr(), out.data_ptr(),
                 rows.data_ptr(), B, D, bins, K, ctypes.c_float(B),
                 ctypes.c_float(-10.0), ctypes.c_float(delta),
                 ctypes.c_float(0.2), ctypes.c_float(norm), stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out
    return call


def main():
    if not torch.cuda.is_available():
        raise SystemExit("diversification_ab needs a CUDA card")
    sources = {"committed": build.CSRC / "diversification.cu"}
    for p in sys.argv[1:]:
        sources[Path(p).stem] = Path(p).resolve()
    card = cs.card_line()
    cs.say(card)
    libs = compile_all(sources)
    for name, (_, report) in libs.items():
        cs.say(f"{name}: nvcc -Xptxas -v: {report}")

    gen = torch.Generator(device="cuda").manual_seed(4)
    calls = {}
    for B, D, bins in SHAPES:
        mu = torch.randn((B, D), generator=gen, device="cuda") * 1.5 + 0.1
        target = L.histogram_target(
            torch.Generator(device="cuda").manual_seed(2), bins)
        plain = diversification.diversification_plain(mu, target, B, bins)
        for name, (fn, _) in libs.items():
            for K in sorted({diversification.plan(D), 1}):
                call = launcher(fn, mu, target, K, bins)
                a, b = call(), call()
                e = cs.per_output_rel(a, plain)
                cs.check(e <= cs.REL_TOL and torch.equal(a, b),
                         f"{name} K={K} at ({B}, {D}, {bins}): rel {e:.2e}, "
                         f"repeat bit-equal {torch.equal(a, b)}")
                calls[(B, D, bins, name, K)] = call

    times = {key: [] for key in calls}
    floor = []
    for r in range(ROUNDS):
        floor.append(cs.cuda_ms(lambda: torch.cuda._sleep(0),
                                iters=ITERS)[0])
        keys = list(calls)
        for key in keys[r % len(keys):] + keys[:r % len(keys)]:
            times[key].append(cs.cuda_ms(calls[key], iters=ITERS)[0])
    cs.say(f"empty launch: median {statistics.median(floor) * 1e3:.3f} us, "
           f"rounds {[round(t * 1e3, 3) for t in floor]}")
    rows = []
    for (B, D, bins, name, K), ts in times.items():
        us = [t * 1e3 for t in ts]
        cs.say(f"({B}, {D}, {bins}) {name} K={K}: median "
               f"{statistics.median(us):.3f} us, min {min(us):.3f}, max "
               f"{max(us):.3f}")
        rows.append(dict(shape=[B, D, bins], build=name, K=K,
                         median_us=statistics.median(us), rounds_us=us))
    print(json.dumps({"diversification_ab": dict(
        card=card, floor_rounds_us=[t * 1e3 for t in floor],
        compiler={n: rep for n, (_, rep) in libs.items()}, times=rows)}))


if __name__ == "__main__":
    main()
