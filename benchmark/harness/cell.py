"""One run of a cell, on the runner its traffic's ``kind`` and its chips
name: ``train`` on one card or across cards, or ``serve``."""

from __future__ import annotations

from benchmark.harness.readers import Context, read_all


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float):
    """(result, checks) of one run; ``t_start`` is the process's start on
    the host clock, from which ``setup_s`` runs."""
    kind = cell["traffic"]["kind"]
    if kind == "train" and cell["chips"] > 1:
        from benchmark.harness import dp as runner
    elif kind == "train":
        from benchmark.harness import train as runner
    elif kind == "serve":
        from benchmark.harness import serve as runner
    else:
        raise SystemExit(f"traffic kind {kind!r}: train or serve")
    return runner.run(cell, seed, seconds, trace, device, t_start,
                      lambda ctx: read_all(cell, Context(**ctx)))
