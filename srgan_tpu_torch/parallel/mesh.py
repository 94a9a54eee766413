"""The data-parallel group of the port (counterpart of
``srgan_tpu/parallel/mesh.py:22-37``).

The JAX package lays a 1-D ``data`` mesh over its devices: batches sharded
along it, parameters replicated.  Here each rank is one process, started by
``torchrun`` (or any launcher that sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``), holding one device; ``make_mesh`` joins the process group
and says where this rank sits in it.  Nothing falls back to one process: an
environment that names no group raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the data-parallel group (the default process
    group): ``rank`` of ``size``, its ``device`` and the ``backend``."""

    rank: int
    size: int
    device: torch.device
    backend: str


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise RuntimeError(
            f"data parallel needs a process group, but {name} is not set: "
            "start every rank with torchrun (torchrun --nproc_per_node N -m "
            "srgan_tpu_torch.train ... --mesh), which sets RANK, WORLD_SIZE "
            "and LOCAL_RANK")
    return int(value)


def make_mesh(device: Optional[str] = None, backend: Optional[str] = None,
              init_method: str = "env://") -> Mesh:
    """Join the process group the launcher set up and return this rank's
    ``Mesh``.  Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, and
    raises if one is missing.

    ``device``: "cuda" (default) places the rank on ``cuda:LOCAL_RANK``; an
    explicit index ("cuda:0") places it there (ranks may then share a
    card); "cpu" keeps it on the CPU.  ``backend``: NCCL on CUDA and gloo
    on the CPU unless named; "gloo" on CUDA is allowed (NCCL refuses two
    ranks on one card).  ``init_method``: ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``, as torchrun sets them) or any URL
    ``init_process_group`` takes (``file://`` for tests).  A group that is
    already initialised is joined as it is, if its rank and size agree."""
    rank, size = _env_int("RANK"), _env_int("WORLD_SIZE")
    local = _env_int("LOCAL_RANK")
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but CUDA is not "
                               "available here; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"device {dev}: cuda or cpu")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices; use gloo on "
                         "the CPU")
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, size):
            raise RuntimeError(
                f"the process group has rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, the environment {rank} of {size}")
        backend = dist.get_backend()
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=size)
    return Mesh(rank=rank, size=size, device=dev, backend=backend)


def local_rows(x, mesh: Mesh):
    """Rows ``[rank * b, (rank + 1) * b)`` of ``x`` (numpy or torch), with
    ``b = len(x) / size``; raises unless the size divides the rows."""
    n = len(x)
    if n % mesh.size:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{mesh.size} ranks")
    b = n // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every entry of a host batch dict, row-major, as
    ``NamedSharding(mesh, P("data"))`` places them: rank r takes rows
    ``[r * b, (r + 1) * b)``.  The entries stay where they were (numpy or
    tensors); ``prefetch_to_device`` moves them."""
    return {k: local_rows(v, mesh) for k, v in batch.items()}


def replicate(tree, mesh: Mesh):
    """Broadcast from rank 0, in place: a tensor, a module's parameters and
    buffers, or a list / tuple of those (None entries skipped), one
    broadcast per dtype and device.  Returns ``tree``."""
    tensors = []

    def collect(node):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            tensors.append(node)
        elif isinstance(node, torch.nn.Module):
            tensors.extend(node.parameters())
            tensors.extend(node.buffers())
        elif isinstance(node, (list, tuple)):
            for v in node:
                collect(v)
        else:
            raise TypeError(f"replicate: cannot broadcast a "
                            f"{type(node).__name__}")

    collect(tree)
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for ts in groups.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=0)
            offsets = np.cumsum([0] + [t.numel() for t in ts])
            for t, a, b in zip(ts, offsets[:-1], offsets[1:]):
                t.copy_(flat[a:b].view_as(t))
    return tree
