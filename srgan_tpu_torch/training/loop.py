"""The epoch loop (counterpart of ``srgan_tpu/training/loop.py``): the
notebook training cells (nb01/03/05 cell 22) as a function.

``train_gan`` iterates a shuffled loader once per epoch with the target
labels sampled per batch, logs the metrics about three times an epoch to a
JSONL file, checkpoints every ``checkpoint_every`` epochs and at the end,
resumes from its latest checkpoint, and on SIGTERM or SIGINT finishes the
step, checkpoints and stops.  Batches reach the device through
``prefetch_to_device``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import tempfile
from typing import Dict, Optional

import torch

from srgan_tpu_torch.configs import (
    ExperimentConfig,
    config_from_dict,
    save_config,
)
from srgan_tpu_torch.data import DataLoader, FaceDataset, make_synthetic_celeba
from srgan_tpu_torch.data.loader import prefetch_to_device
from srgan_tpu_torch.training.gan import GANTrainer, resolve_device
from srgan_tpu_torch.training.state import TRAINABLE_WHEN_FROZEN
from srgan_tpu_torch.utils.checkpoint import (
    latest_step,
    load_state_dict_file,
    restore_checkpoint,
    save_checkpoint,
)
from srgan_tpu_torch.utils.metrics import MetricLogger, StepTimer


def build_datasets(cfg: ExperimentConfig, data_root: Optional[str] = None,
                   attr_file: Optional[str] = None,
                   label_root: Optional[str] = None,
                   synthetic_dir: Optional[str] = None,
                   synthetic_per_class: int = 16):
    """(train, sample) ``FaceDataset``s of ``data_root``; without one, of a
    synthetic fixture written to ``synthetic_dir`` (default: a folder in the
    temporary directory), with the preset's ``test_num`` cut to a quarter
    of a class where it would swallow the fixture."""
    if data_root is None:
        synthetic_dir = synthetic_dir or os.path.join(
            tempfile.gettempdir(), "srgan_tpu_torch_synthetic")
        data_root, attr_file = make_synthetic_celeba(
            synthetic_dir, n_per_class=synthetic_per_class)
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
              checkpoint_every: int = 3,
              synthetic_per_class: int = 16,
              echo: bool = True,
              resume: bool = False,
              profile_dir: Optional[str] = None,
              debug_nans: bool = False,
              synthetic_dir_override: Optional[str] = None,
              device="cuda",
              decode: str = "native"):
    """Train ``cfg`` for ``epochs`` (default ``cfg.train.epochs``) into
    ``out_dir``: ``config.json``, ``metrics.jsonl`` and ``ckpt/step_N``
    (N = epochs completed).  Returns (trainer, state).

    ``resume`` continues from the latest checkpoint, with the loader's
    generator and the step's draws started again from their seeds, as the
    JAX loop does.  ``debug_nans`` raises at the first non-finite metric.
    ``profile_dir`` receives a ``torch.profiler`` trace of the whole run.
    The progress grids (``sample_grids``) need the visualisation module,
    which is not ported yet."""
    if sample_grids:
        raise NotImplementedError(
            "sample_grids=True needs utils/viz.py::training_progress_grid, "
            "which is not ported yet (ROADMAP A7); pass sample_grids=False "
            "(the CLI's --no-sample-grids)")
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    cfg_json = os.path.join(out_dir, "config.json")
    if resume and os.path.exists(cfg_json):
        _check_resume_config(cfg, cfg_json)
    else:
        save_config(cfg, out_dir)
    train_ds, _ = build_datasets(
        cfg, data_root, attr_file, label_root,
        synthetic_dir=synthetic_dir_override,
        synthetic_per_class=synthetic_per_class)
    loader = DataLoader(train_ds, batch_size=cfg.train.batch_size,
                        drop_last=cfg.train.drop_last,
                        classes=tuple(range(cfg.model.n_classes)),
                        seed=cfg.train.seed, decode=decode)
    if len(loader) == 0:
        raise ValueError(
            f"dataset ({len(train_ds)}) smaller than batch "
            f"({cfg.train.batch_size}); lower batch_size or add data")

    trainer = GANTrainer(cfg, device)
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

    logger = MetricLogger(os.path.join(out_dir, "metrics.jsonl"), echo=echo)
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
    profiler = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
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
                if it % interval == 0:
                    # converting the metrics waits for the device, so the
                    # throughput meter, read after it, counts whole steps
                    values = {k: float(v) for k, v in metrics.items()}
                    logger.log(values, epoch=epoch, step=step,
                               images_per_sec=timer.images_per_sec)
            # step = epochs completed, as the stop and final saves and the
            # resume (which re-enters at epoch == step) count
            if checkpoint_every and epoch % checkpoint_every == 0:
                save_checkpoint(ckpt_dir, state, step=epoch + 1)
            if stop_requested:
                print(f"signal {stop_requested[0]} received: checkpointing "
                      f"at epoch {epoch + 1} and stopping")
                save_checkpoint(ckpt_dir, state, step=epoch + 1)
                break
    finally:
        # the caller (a notebook, a test) keeps a working Ctrl-C
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        if profiler is not None:
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir,
                                                      "trace.json"))
        logger.close()
    if not stop_requested:
        save_checkpoint(ckpt_dir, state, step=epochs)
    return trainer, state
