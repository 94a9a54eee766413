"""Metric logging and step timing (counterpart of
``srgan_tpu/utils/metrics.py``).

The reference keeps its losses in notebook lists and prints the wall clock
(nb01 cell 22).  Here: a JSONL metric writer (the JAX package's record,
optionally echoed to stdout) and an images-per-second meter.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, metrics: Dict, **extra):
        """Append one record: every value that converts to float does (a
        0-dim CUDA tensor's conversion waits for the device), plus the host
        time."""
        rec = {k: (float(v) if hasattr(v, "__float__") else v)
               for k, v in {**metrics, **extra}.items()}
        rec.setdefault("time", time.time())
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo:
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                           f"{k}={v}" for k, v in rec.items()
                           if k != "time"))
        return rec

    def close(self):
        if self._f:
            self._f.close()


class StepTimer:
    """Images per second on the host clock since ``reset``.  The device runs
    behind the host: read it after a synchronising call (the loop reads it
    after converting the step's metrics to floats)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._images = 0

    def update(self, batch_size: int):
        self._images += batch_size

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else 0.0


def pickle_save(data, path):
    """util.py:61-82."""
    with open(path, "wb") as f:
        pickle.dump(data, f)


def pickle_load(path):
    """util.py:84-106.  Unpickling runs code: load only files this program
    wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)
