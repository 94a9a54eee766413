"""The epoch loop (counterpart of ``srgan_tpu/training/loop.py``): the
notebook training cells (nb01/03/05 cell 22) as a function.

``train_gan`` iterates a shuffled loader once per epoch with the target
labels sampled per batch, logs the metrics about three times an epoch to a
JSONL file and draws a progress grid at each log (thinned by
``grid_every_epochs``), checkpoints every ``checkpoint_every`` epochs and
at the end, resumes from its latest checkpoint, and on SIGTERM or SIGINT
finishes the step, checkpoints and stops.  Batches reach the device through
``prefetch_to_device``.

Data parallel (``mesh``, a ``parallel.Mesh`` of every rank, each running
this function): every rank decodes and steps on its rows of each global
batch and resumes from the same checkpoint; rank 0 alone writes
``config.json``, the synthetic fixture, ``metrics.jsonl``, the grids, the
profile and the checkpoints; a stop signal on any rank stops every rank at
the same epoch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import tempfile
from typing import Dict, Optional

import torch
import torch.distributed as dist

from srgan_tpu_torch.configs import (
    ExperimentConfig,
    config_from_dict,
    save_config,
)
from srgan_tpu_torch.data import DataLoader, FaceDataset, make_synthetic_celeba
from srgan_tpu_torch.data.dataset import LABEL_DESCRIPTION
from srgan_tpu_torch.data.loader import prefetch_to_device
from srgan_tpu_torch.training.gan import GANTrainer, resolve_device
from srgan_tpu_torch.training.state import TRAINABLE_WHEN_FROZEN
from srgan_tpu_torch.utils import viz
from srgan_tpu_torch.utils.checkpoint import (
    latest_step,
    load_state_dict_file,
    restore_checkpoint,
    save_checkpoint,
)
from srgan_tpu_torch.utils.chiplock import hold_chip
from srgan_tpu_torch.utils.metrics import MetricLogger, StepTimer


def build_datasets(cfg: ExperimentConfig, data_root: Optional[str] = None,
                   attr_file: Optional[str] = None,
                   label_root: Optional[str] = None,
                   synthetic_dir: Optional[str] = None,
                   synthetic_per_class: int = 16,
                   write_fixture: bool = True):
    """(train, sample) ``FaceDataset``s of ``data_root``; without one, of a
    synthetic fixture written to ``synthetic_dir`` (default: a folder in the
    temporary directory; ``write_fixture=False`` reads the one another
    process wrote there), with the preset's ``test_num`` cut to a quarter
    of a class where it would swallow the fixture."""
    if data_root is None:
        synthetic_dir = synthetic_dir or os.path.join(
            tempfile.gettempdir(), "srgan_tpu_torch_synthetic")
        if write_fixture:
            data_root, attr_file = make_synthetic_celeba(
                synthetic_dir, n_per_class=synthetic_per_class)
        else:
            data_root = os.path.join(synthetic_dir, "img")
            attr_file = os.path.join(synthetic_dir, "list_attr_celeba.txt")
        if cfg.train.test_num >= synthetic_per_class:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, test_num=max(synthetic_per_class // 4, 1)))
    t = cfg.train
    common = dict(attr_file=attr_file, label_root=label_root,
                  train_num=t.train_num, val_num=t.val_num,
                  test_num=t.test_num, image_size=cfg.model.image_size)
    train = FaceDataset(data_root, data_type="train", **common)
    sample = FaceDataset(data_root, data_type="test", **common)
    return train, sample


def load_pretrained_encoder(path: str, E: torch.nn.Module):
    """The nb05 transfer (``strict=False``): load the nb04 classifier at
    ``path``, a ``.pth`` state dict in the reference's
    ``Encoder_classifier`` layout (the encoder's trunk and ``fcclass``),
    into the encoder ``E``, whose ``fcmean`` / ``fcvar`` stay as drawn.
    Every other key of ``E`` must be in the file, and nothing else."""
    if not path.endswith(".pth"):
        raise ValueError(f"{path}: the port reads a classifier .pth; an "
                         "orbax directory is the JAX package's format")
    missing, unexpected = E.load_state_dict(load_state_dict_file(path),
                                            strict=False)
    heads = {k for k in E.state_dict()
             if k.split(".", 1)[0] in TRAINABLE_WHEN_FROZEN}
    if set(missing) != heads or unexpected:
        raise ValueError(f"{path} does not fit the encoder as a classifier: "
                         f"missing {sorted(set(missing) - heads)}, "
                         f"unexpected {unexpected}, heads present "
                         f"{sorted(heads - set(missing))}")


def _check_resume_config(cfg: ExperimentConfig, cfg_json: str):
    """The stored run record is what later commands rebuild the model from:
    never replace it on resume.  ``epochs`` is a run length, not part of the
    model or trainer, so extending a finished run is allowed."""
    with open(cfg_json) as f:
        stored = config_from_dict(json.load(f))
    stored_cmp = dataclasses.replace(stored, train=dataclasses.replace(
        stored.train, epochs=cfg.train.epochs))
    if stored_cmp != cfg:
        raise ValueError(
            f"--resume with a different config than {cfg_json} "
            f"(stored '{stored.name}' != requested '{cfg.name}' or "
            "overrides differ); re-run with the original preset/"
            "overrides, or use a fresh --out dir")


def _barrier(mesh):
    if mesh is not None:
        dist.barrier()


def _any_rank(flag: bool, mesh) -> bool:
    """``flag`` on this rank, or on any rank of ``mesh``."""
    if mesh is None:
        return flag
    t = torch.tensor([float(flag)], device=mesh.device)
    dist.all_reduce(t)
    return bool(t.item() > 0)


def _check_finite(metrics: Dict[str, torch.Tensor], epoch: int, step: int):
    for k, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            raise FloatingPointError(f"{k} = {float(v)} at epoch {epoch}, "
                                     f"step {step}")


def train_gan(cfg: ExperimentConfig, out_dir: str,
              data_root: Optional[str] = None,
              attr_file: Optional[str] = None,
              label_root: Optional[str] = None,
              epochs: Optional[int] = None,
              classifier_ckpt: Optional[str] = None,
              sample_grids: bool = True,
              grid_every_epochs: int = 1,
              checkpoint_every: int = 3,
              synthetic_per_class: int = 16,
              echo: bool = True,
              resume: bool = False,
              profile_dir: Optional[str] = None,
              debug_nans: bool = False,
              synthetic_dir_override: Optional[str] = None,
              device="cuda",
              decode: str = "native",
              mesh=None,
              grad_sync: str = "auto"):
    """Train ``cfg`` for ``epochs`` (default ``cfg.train.epochs``) into
    ``out_dir``: ``config.json``, ``metrics.jsonl`` and ``ckpt/step_N``
    (N = epochs completed).  Returns (trainer, state).

    ``resume`` continues from the latest checkpoint, with the loader's
    generator and the step's draws started again from their seeds, as the
    JAX loop does.  ``debug_nans`` raises at the first non-finite metric.
    ``profile_dir`` receives a ``torch.profiler`` trace of the whole run.
    ``sample_grids`` writes ``progress_e{epoch:03d}_i{it:05d}.png`` of a
    test-split image at every log of every ``grid_every_epochs``-th epoch
    (``srgan_tpu/training/loop.py:191-210``); it needs matplotlib, and
    raises before anything else where it is missing.

    ``mesh`` and ``grad_sync`` train data parallel, as ``GANTrainer`` does
    (``srgan_tpu/training/loop.py:68-69, 122``); the device is the mesh's.
    """
    if sample_grids:
        viz.require_matplotlib("sample_grids=True (the CLI's default; "
                               "--no-sample-grids turns the grids off)")
    device = resolve_device(device if mesh is None else mesh.device)
    writer = mesh is None or mesh.rank == 0
    os.makedirs(out_dir, exist_ok=True)
    cfg_json = os.path.join(out_dir, "config.json")
    if resume and os.path.exists(cfg_json):
        _check_resume_config(cfg, cfg_json)
    elif writer:
        save_config(cfg, out_dir)
    if not writer:
        # the fixture: written by rank 0, then read
        _barrier(mesh)
    train_ds, sample_ds = build_datasets(
        cfg, data_root, attr_file, label_root,
        synthetic_dir=synthetic_dir_override,
        synthetic_per_class=synthetic_per_class, write_fixture=writer)
    if writer:
        _barrier(mesh)
    loader = DataLoader(train_ds, batch_size=cfg.train.batch_size,
                        drop_last=cfg.train.drop_last,
                        classes=tuple(range(cfg.model.n_classes)),
                        seed=cfg.train.seed, decode=decode, mesh=mesh)
    if len(loader) == 0:
        raise ValueError(
            f"dataset ({len(train_ds)}) smaller than batch "
            f"({cfg.train.batch_size}); lower batch_size or add data")

    trainer = GANTrainer(cfg, device, mesh=mesh, grad_sync=grad_sync)
    if cfg.pretrained_encoder and classifier_ckpt is None:
        raise ValueError("pretrained_encoder config needs classifier_ckpt "
                         "(run pretrain_classifier first, nb04 equivalent)")
    state = trainer.init_state(torch.Generator().manual_seed(cfg.train.seed),
                               freeze_pretrained=cfg.pretrained_encoder)
    if cfg.pretrained_encoder:
        load_pretrained_encoder(classifier_ckpt, state.E)
    ckpt_dir = os.path.join(out_dir, "ckpt")
    start_epoch = 0
    if resume and latest_step(ckpt_dir) is not None:
        start_epoch = latest_step(ckpt_dir)
        restore_checkpoint(ckpt_dir, state, step=start_epoch)
        print(f"resumed from epoch {start_epoch} (checkpoint step = epochs "
              "completed)")

    logger = MetricLogger(os.path.join(out_dir, "metrics.jsonl")
                          if writer else None, echo=echo and writer)
    timer = StepTimer()
    epochs = epochs if epochs is not None else cfg.train.epochs
    interval = max(len(loader) // 3, 1)

    # preemption: on SIGTERM/SIGINT finish the step, checkpoint, stop
    stop_requested = []

    def _request_stop(signum, frame):
        stop_requested.append(signum)

    old_handlers = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _request_stop)
    except ValueError:
        pass    # not in the main thread

    # the state's step survives checkpoint and restore, so the logged step
    # column rises across a resume
    step = state.step
    # the grids' random latents, apart from the step's draws
    grid_gen = torch.Generator().manual_seed(cfg.train.seed + 2)
    profiler = None
    if profile_dir and writer:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
    # advertise the card's occupancy for the epochs, so that the bench
    # waits or annotates its line instead of recording a contended number;
    # under a mesh each rank holds its own marker (entered by hand to join
    # the try/finally below, as the JAX loop does)
    chip = hold_chip(f"train_gan {out_dir}", device=trainer.device)
    chip.__enter__()
    try:
        for epoch in range(start_epoch, epochs):
            timer.reset()
            for it, batch in enumerate(prefetch_to_device(loader,
                                                          trainer.device)):
                metrics = trainer.step(state, batch, epoch)
                timer.update(cfg.train.batch_size)
                step += 1
                if debug_nans:
                    _check_finite(metrics, epoch, step)
                if it % interval == 0 and writer:
                    # converting the metrics waits for the device, so the
                    # throughput meter, read after it, counts whole steps
                    values = {k: float(v) for k, v in metrics.items()}
                    logger.log(values, epoch=epoch, step=step,
                               images_per_sec=timer.images_per_sec)
                    if (sample_grids and len(sample_ds)
                            and epoch % max(grid_every_epochs, 1) == 0):
                        fig = viz.training_progress_grid(
                            trainer, state, sample_ds,
                            min(53, len(sample_ds) - 1), LABEL_DESCRIPTION,
                            generator=grid_gen)
                        fig.savefig(os.path.join(
                            out_dir, f"progress_e{epoch:03d}_i{it:05d}.png"))
                        viz.close(fig)
            # step = epochs completed, as the stop and final saves and the
            # resume (which re-enters at epoch == step) count
            if checkpoint_every and epoch % checkpoint_every == 0 and writer:
                save_checkpoint(ckpt_dir, state, step=epoch + 1)
            if _any_rank(bool(stop_requested), mesh):
                stop_requested = stop_requested or ["another rank's"]
                print(f"signal {stop_requested[0]} received: checkpointing "
                      f"at epoch {epoch + 1} and stopping")
                if writer:
                    save_checkpoint(ckpt_dir, state, step=epoch + 1)
                break
    finally:
        chip.__exit__(None, None, None)
        # the caller (a notebook, a test) keeps a working Ctrl-C
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        if profiler is not None:
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir,
                                                      "trace.json"))
        logger.close()
    if not stop_requested and writer:
        save_checkpoint(ckpt_dir, state, step=epochs)
    _barrier(mesh)
    return trainer, state
