"""The readings a cell's limits are set from, on the card at the cell's own
size.  Training: for each seed the program's numbers (a sound run of the
check steps against the reference), and for the control seeds the control's
(the reference computed in fp8, put in the program's place) and the planted
half-batch fault's (the program stepping on the first half of each batch).
Serving: for each seed the program's answers to the run's sampled requests
and, for the control seeds, the fp8 reference's.  Across cards: rank 0's
check steps, and on the control seeds the same with the exchange between
the ranks left out.  One JSON line a seed, on
stdout.

    python3 benchmark/tools/calibrate.py --workload NAME --seeds 1 2 3 \\
        [--control-seeds 1 2 3]
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import common  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    common.prepare_env()
    import torch

    from benchmark.harness import train

    cell = common.resolve_cell(args.workload)
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(args.device)
    if traffic["kind"] == "serve":
        return serve_readings(cell, args, dev)
    if cell["chips"] > 1:
        return dp_readings(cell, args, dev)
    n = traffic["check_steps"]

    def program_record(seed, half=False):
        prog = train.Program(config, seed, dev)
        pool = train.make_pool(config, traffic, seed, dev)
        if half:
            pool = [{k: v[:len(v) // 2] for k, v in b.items()} for b in pool]
        return train.record_check(prog.step, prog.nets, prog.opts, pool, n,
                                  dev)

    def readings(rec, ref):
        """compare()'s numbers, with the first step's gap by loss and the
        moments' median leaf by net beside them."""
        out = train.compare(rec, ref)
        r0, p0 = ref["losses"][0], rec["losses"][0]
        med = statistics.median(abs(v) for v in r0.values())
        out["first_by_loss"] = {k: abs(p0[k] - v) / max(abs(v), med)
                                for k, v in r0.items()}
        out["moment_median_by_net"] = {
            k: statistics.median(train.leaf_gaps(
                {k: rec["moments"][k]}, {k: ref["moments"][k]}) or [0.0])
            for k in train.NETS}
        return out

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        ref = train.reference_check(config, traffic, seed, dev)
        out = {"seed": seed, "ref_s": time.perf_counter() - t}
        if seed in args.seeds:
            out["program"] = readings(program_record(seed), ref)
        if seed in args.control_seeds:
            ctl = train.reference_check(config, traffic, seed, dev, "fp8")
            out["control"] = readings(ctl, ref)
            out["half_batch"] = readings(program_record(seed, True), ref)
        print(json.dumps(out), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def dp_readings(cell, args, dev):
    """A cell across cards: rank 0's check steps against the reference on
    each seed, and with the exchange between the ranks left out on the
    control seeds.  The control itself is the one-card cell's: the same
    reference at the same global batch."""
    from benchmark.harness import dp, train

    config, traffic = cell["config"], cell["traffic"]
    todo = [(s, None) for s in args.seeds] + \
        [(s, "no_exchange") for s in args.control_seeds]
    recs = dp.calibrate(cell, todo, dev)
    refs = {}
    for (seed, fault), rec in zip(todo, recs):
        if seed not in refs:
            refs[seed] = train.reference_check(config, traffic, seed, dev)
        key = "no_exchange" if fault else "program"
        print(json.dumps({"seed": seed, key: train.compare(rec, refs[seed])}),
              flush=True)


def serve_readings(cell, args, dev):
    """A serving cell's readings: the program's answers to each seed's
    sampled requests, through its request handler (the wire format, the
    Translator, G and E) without the socket; the control's, the reference
    in fp8 in the program's place."""
    import torch

    from benchmark.harness import mix, serve
    from srgan_tpu_torch.serving import handle_request

    config, traffic = cell["config"], cell["traffic"]
    seconds = common.manifest()["run_seconds"]
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        _, reqs = serve.sampled_requests(config, traffic, seed, seconds)
        ref = serve.reference_outputs(config, seed, reqs, dev)
        paths = [r["path"] for r in reqs]
        out = {"seed": seed, "requests": len(reqs)}
        if seed in args.seeds:
            server, tr = serve.build_server(config, traffic, seed, dev, None)
            server.server_close()
            answers = []
            for r in reqs:
                body = mix.encode_npz({k: v for k, v in r.items()
                                       if k != "path"})
                status, data = handle_request(tr, r["path"], body)
                answers.append(mix.decode_npz(data) if status == 200
                               else {})
            out["program"] = serve.gaps(answers, ref, paths)
            del tr
        if seed in args.control_seeds:
            ctl = serve.reference_outputs(config, seed, reqs, dev, "fp8")
            answers = [{"mu": a, "logvar": b} if p == "/encode"
                       else {"fakes": a, "latent": b}
                       for (a, b), p in zip(ctl, paths)]
            out["control"] = serve.gaps(answers, ref, paths)
        print(json.dumps(out), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
