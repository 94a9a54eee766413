"""Cooperative single-card occupancy markers (counterpart of
``srgan_tpu/utils/chiplock.py``).

A benchmark that runs while a training or evaluation job holds the card
records a silently contended number.  Nothing arbitrates the card, so
occupancy is advertised cooperatively: every long-running card job wraps
itself in :func:`hold_chip`, which drops a ``<pid>.pid`` marker under
``$SRGAN_TPU_LOCK_DIR`` (default :func:`default_lock_dir`); ``python -m
srgan_tpu_torch.bench`` calls :func:`wait_chip_free` before timing and
annotates its output when live holders remain.

The lock directory is the JAX package's: the same variable, and a default
under the temporary directory that is the JAX package's
``/tmp/srgan_tpu_chip_locks`` where ``TMPDIR`` is unset, so one directory
guards the card whichever package holds it.  A process with a ``TMPDIR`` of
its own gets a directory of its own.  Markers are advisory (nothing
blocks on them except the bench) and self-cleaning: a marker whose pid is
dead is removed on the next scan, so a SIGKILLed job cannot wedge future
benches.
"""

from __future__ import annotations

import argparse
import contextlib
import errno
import os
import tempfile
import time

import torch


def default_lock_dir() -> str:
    """``$SRGAN_TPU_LOCK_DIR``, else ``srgan_tpu_chip_locks`` under the
    temporary directory.  Both are read at each call (the JAX package reads
    them at import), so a process may set them after importing this."""
    return os.environ.get("SRGAN_TPU_LOCK_DIR") or os.path.join(
        tempfile.gettempdir(), "srgan_tpu_chip_locks")


def _lock_dir(lock_dir: str | None) -> str:
    return lock_dir or default_lock_dir()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError as e:
        return e.errno == errno.EPERM   # exists, owned by someone else
    return True


def busy_pids(lock_dir: str | None = None) -> list[int]:
    """Live holder pids; stale (dead-pid / malformed) markers are removed."""
    d = _lock_dir(lock_dir)
    if not os.path.isdir(d):
        return []
    alive = []
    for name in os.listdir(d):
        if not name.endswith(".pid"):
            continue
        path = os.path.join(d, name)
        try:
            pid = int(name[:-4])
        except ValueError:
            pid = -1
        if pid > 0 and _pid_alive(pid):
            alive.append(pid)
        else:
            with contextlib.suppress(OSError):
                os.unlink(path)
    return sorted(alive)


@contextlib.contextmanager
def hold_chip(label: str = "", lock_dir: str | None = None, device=None):
    """Advertise this process as a card holder for the with-block's duration.

    Only a CUDA ``device`` is advertised; None means the default device,
    CUDA where torch sees a card (the JAX package's ``only_on_tpu`` checks
    its default backend the same way).  CPU runs, the tests', stay
    marker-free.
    """
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        yield
        return
    d = _lock_dir(lock_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{os.getpid()}.pid")
    with open(path, "w") as f:
        f.write(label or "chip job")
    try:
        yield
    finally:
        with contextlib.suppress(OSError):
            os.unlink(path)


def cli_device(argv: list[str], default: str = "cuda") -> str:
    """The ``--device`` a CLI's ``main`` will parse from ``argv``, so its
    ``__main__`` block can hold the card only where the run uses one."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=default)
    return ap.parse_known_args(argv)[0].device


def wait_chip_free(timeout_s: float, poll_s: float = 15.0,
                   lock_dir: str | None = None) -> list[int]:
    """Poll until no live holders remain or ``timeout_s`` elapses.

    Returns the (possibly empty) list of pids still holding at return time —
    empty means the card is advertised free.
    """
    deadline = time.monotonic() + timeout_s
    while True:
        holders = busy_pids(lock_dir)
        if not holders or time.monotonic() >= deadline:
            return holders
        time.sleep(min(poll_s, max(deadline - time.monotonic(), 0.1)))
