"""What the program's span recording costs when it is on: a training cell's
window (``harness/train.py::window``) with ``spans.recording()`` on for the
whole window against off, in turns on one program (off, on, on, off, off,
on, ...), from one seed a pair.  One JSON line a window, on stdout; the
medians last.

    python3 benchmark/tools/span_cost.py --workload srgan_full.train_b128 \\
        --seeds 1 2 3 --seconds 30
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import common  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    common.prepare_env()
    import torch

    from benchmark.harness import train
    from srgan_tpu_torch.utils import spans

    cell = common.resolve_cell(args.workload)
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device("cuda", 0)
    B = config["train"]["batch_size"]
    rates = {False: [], True: []}
    for n, seed in enumerate(args.seeds):
        prog = train.Program(config, seed, dev)
        pool = train.make_pool(config, traffic, seed, dev)
        for i in range(traffic["check_steps"] + traffic["warmup_steps"]):
            prog.step(pool[i % len(pool)])
        order = (False, True) if n % 2 == 0 else (True, False)
        for on in order:
            rec = None
            if on:
                with spans.recording() as rec:
                    steps, secs, _, _ = train.window(prog, pool, 0,
                                                     args.seconds, dev)
            else:
                steps, secs, _, _ = train.window(prog, pool, 0,
                                                 args.seconds, dev)
            rates[on].append(steps * B / secs)
            print(json.dumps({"seed": seed, "recording": on,
                              "train_img_per_s": rates[on][-1],
                              "spans": len(rec.spans) if rec else 0}),
                  flush=True)
        del prog, pool
        torch.cuda.empty_cache()
    off, on = (statistics.median(rates[k]) for k in (False, True))
    print(json.dumps({"card": torch.cuda.get_device_name(dev),
                      "median_off": off, "median_on": on,
                      "cost": 1 - on / off}), flush=True)


if __name__ == "__main__":
    main()
