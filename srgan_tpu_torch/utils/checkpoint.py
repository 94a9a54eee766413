"""Checkpoints of the port, and the weight carry-over from the JAX
package's parameter trees.

Counterpart of the torch export in ``srgan_tpu/utils/checkpoint.py:339-529``:
the same key layout (the reference's ``SingleGenerator``, ``Encoder``,
``EncoderOriginal``, ``Encoder_classifier``,
``SingleDiscriminator_solo_multi`` and ``SingleDiscriminator_original_multi``,
and torchvision's ``vgg19_bn``), computed from parameter trees given as
nested dicts of numpy arrays, so the port needs no JAX to read them.
``load_state_dict_file`` reads the ``generator.pth`` / ``encoder.pth`` that
``scripts/export_torch_checkpoint.py`` writes.  In batch-norm mode the
generator and encoder bridges also take the JAX ``batch_stats`` collection
(``{"mean", "var"}`` of each norm) into the ``running_mean`` /
``running_var`` buffers, and the flax ``BatchNorm`` layers' ``scale`` /
``bias`` into ``up_norms.{j}`` and ``layers.{i}.norm{1,2}``.

``save_checkpoint`` / ``restore_checkpoint`` keep a training state under
``<path>/step_N/`` (the JAX package's layout of its orbax directories,
``srgan_tpu/utils/checkpoint.py:68-108``): G, D and E as ``generator.pth``,
``discriminator.pth`` and ``encoder.pth`` in the reference key layout (the
per-domain Ds of the ``singlegan`` trainer as one ``nn.ModuleList``, each
domain's keys under ``{i}.``), and
the three Adam state dicts, the step and the histogram target in
``train_state.pth``; in batch-norm mode G's and E's state dicts carry their
running statistics, so a run resumes, and is served, with them.  The orbax format is the JAX package's and is not read
here.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch


def _inv_conv_w(a):   # HWIO -> OIHW
    return np.transpose(np.asarray(a), (3, 2, 0, 1))


def _inv_convT_w(a):  # (kh, kw, in, out) pre-flipped -> (in, out, kh, kw)
    return np.transpose(np.asarray(a)[::-1, ::-1], (2, 3, 0, 1))


def _inv_lin_w(a):    # (in, out) -> (out, in)
    return np.transpose(np.asarray(a))


def _vec(a):
    return np.asarray(a)


class _Exporter:
    """Collects torch-key -> tensor assignments from a parameter tree and,
    in batch-norm mode, its ``batch_stats`` tree."""

    def __init__(self, params: Mapping, batch_stats: Optional[Mapping] = None):
        self.params = params
        self.stats = batch_stats
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, path, fn, tree=None):
        node = self.params if tree is None else tree
        for p in path:
            node = node[p]
        self.sd[key] = torch.from_numpy(np.array(fn(node), np.float32))

    def running(self, prefix: str, path):
        for key, stat in (("running_mean", "mean"), ("running_var", "var")):
            self.put(f"{prefix}.{key}", path + (stat,), _vec, self.stats)

    def cbinorm(self, prefix: str, path):
        """CBINorm, or CBBNorm with its running statistics in batch mode."""
        self.put(f"{prefix}.ConBias.0.weight", path + ("con_bias", "kernel"),
                 _inv_lin_w)
        self.put(f"{prefix}.ConBias.0.bias", path + ("con_bias", "bias"),
                 _vec)
        self.put(f"{prefix}.weight", path + ("scale",), _vec)
        self.put(f"{prefix}.bias", path + ("bias",), _vec)
        if self.stats is not None:
            self.running(prefix, path)

    def batchnorm(self, prefix: str, path):
        """A flax ``BatchNorm``: ``scale`` / ``bias`` and running stats."""
        self.put(f"{prefix}.weight", path + ("scale",), _vec)
        self.put(f"{prefix}.bias", path + ("bias",), _vec)
        self.running(prefix, path)


def generator_state_dict_from_jax(params: Mapping, num_cls: int = 2,
                                  res_num: int = 6,
                                  batch_stats: Optional[Mapping] = None
                                  ) -> Dict[str, torch.Tensor]:
    """JAX ``SingleGenerator`` params -> the port's generator state dict;
    with ``batch_stats`` (batch-norm mode) its running statistics and the
    up path's ``BatchNorm`` layers too."""
    ex = _Exporter(params, batch_stats)
    for i in range(num_cls + 1):
        ex.put(f"down_convs.{i}.weight", (f"down_conv_{i}", "kernel"),
               _inv_conv_w)
        ex.cbinorm(f"down_cnorms.{i}", (f"down_cnorm_{i}",))
    for i in range(res_num):
        for conv in ("c1", "c2"):
            ex.put(f"resBlocks.{i}.{conv}.weight",
                   (f"res_{i}", conv, "kernel"), _inv_conv_w)
        for cn in ("cn1", "cn2"):
            ex.cbinorm(f"resBlocks.{i}.{cn}", (f"res_{i}", cn))
    for j in range(num_cls):
        ex.put(f"up_convs.{j}.weight", (f"up_conv_{j}", "kernel"),
               _inv_convT_w)
        if batch_stats is not None:
            ex.batchnorm(f"up_norms.{j}", (f"up_norm_{j}",))
    ex.put(f"up_convs.{num_cls}.weight", ("up_conv_out", "kernel"),
           _inv_conv_w)
    return ex.sd


def _encoder_trunk(ex: _Exporter, num_cls: int, conditional: bool = False):
    ex.put("first_layer.weight", ("first_layer", "kernel"), _inv_conv_w)
    ex.put("first_layer.bias", ("first_layer", "bias"), _vec)
    for i in range(num_cls):
        blk = f"layers_{i}"
        ex.put(f"layers.{i}.conv1.weight", (blk, "conv1", "kernel"),
               _inv_conv_w)
        ex.put(f"layers.{i}.cmp.0.weight", (blk, "cmp_conv", "kernel"),
               _inv_conv_w)
        ex.put(f"layers.{i}.shortcut.1.weight", (blk, "shortcut_conv",
                                                 "kernel"), _inv_conv_w)
        ex.put(f"layers.{i}.shortcut.1.bias", (blk, "shortcut_conv", "bias"),
               _vec)
        if conditional:
            ex.cbinorm(f"layers.{i}.cnorm1", (blk, "cnorm1"))
            ex.cbinorm(f"layers.{i}.cnorm2", (blk, "cnorm2"))
        elif ex.stats is not None:
            ex.batchnorm(f"layers.{i}.norm1", (blk, "norm1"))
            ex.batchnorm(f"layers.{i}.norm2", (blk, "norm2"))


def _heads(ex: _Exporter, heads):
    for head in heads:
        ex.put(f"{head}.weight", (head, "kernel"), _inv_lin_w)
        ex.put(f"{head}.bias", (head, "bias"), _vec)


def encoder_state_dict_from_jax(params: Mapping, num_cls: int = 4,
                                batch_stats: Optional[Mapping] = None
                                ) -> Dict[str, torch.Tensor]:
    """JAX (unconditional) ``Encoder`` params -> the port's encoder state
    dict; with ``batch_stats``, batch-norm mode's ``BatchNorm`` layers."""
    ex = _Exporter(params, batch_stats)
    _encoder_trunk(ex, num_cls)
    _heads(ex, ("fcmean", "fcvar", "fcclass"))
    return ex.sd


def encoder_original_state_dict_from_jax(params: Mapping, num_cls: int = 4,
                                         batch_stats: Optional[Mapping] = None
                                         ) -> Dict[str, torch.Tensor]:
    """JAX ``EncoderOriginal`` (conditional) params -> the port's
    ``EncoderOriginal`` state dict: the trunk with each block's
    ``cnorm1`` / ``cnorm2``, ``fcmean`` and ``fcvar``
    (``srgan_tpu/utils/checkpoint.py:439-467``, ``conditional=True``); with
    ``batch_stats``, the CBBNorms' running statistics."""
    ex = _Exporter(params, batch_stats)
    _encoder_trunk(ex, num_cls, conditional=True)
    _heads(ex, ("fcmean", "fcvar"))
    return ex.sd


def classifier_state_dict_from_jax(params: Mapping, num_cls: int = 4,
                                   batch_stats: Optional[Mapping] = None
                                   ) -> Dict[str, torch.Tensor]:
    """JAX ``EncoderClassifier`` params (or a full ``Encoder``'s, whose
    ``fcmean`` / ``fcvar`` are left out) -> the port's classifier state dict,
    the reference's ``Encoder_classifier`` layout
    (``srgan_tpu/utils/checkpoint.py:470-479``); with ``batch_stats``,
    batch-norm mode's ``BatchNorm`` layers."""
    ex = _Exporter(params, batch_stats)
    _encoder_trunk(ex, num_cls)
    _heads(ex, ("fcclass",))
    return ex.sd


def solo_discriminator_state_dict_from_jax(params: Mapping, num_cls: int = 4
                                           ) -> Dict[str, torch.Tensor]:
    """JAX ``SingleDiscriminatorSoloMulti`` params -> the port's solo
    discriminator state dict (the trunks' convs sit at the even indices of
    ``down_convs``, LeakyReLUs between them)."""
    ex = _Exporter(params)
    for trunk in ("discriminator1", "discriminator2"):
        for i in range(num_cls):
            ex.put(f"{trunk}.down_convs.{2 * i}.weight",
                   (trunk, f"conv_{i}", "kernel"), _inv_conv_w)
    for name in ("last_layer1", "last_layer2"):
        ex.put(f"{name}.weight", (name, "kernel"), _inv_conv_w)
        ex.put(f"{name}.bias", (name, "bias"), _vec)
    for name in ("classification_layer1", "classification_layer2"):
        ex.put(f"{name}.0.weight", (name, "kernel"), _inv_conv_w)
        ex.put(f"{name}.0.bias", (name, "bias"), _vec)
    return ex.sd


def original_discriminator_state_dict_from_jax(params: Mapping,
                                              num_cls: int = 4
                                              ) -> Dict[str, torch.Tensor]:
    """One domain's JAX ``SingleDiscriminatorOriginalMulti`` params -> the
    port's state dict of that D (``conv_out`` at ``down_convs.{2 *
    num_cls}``, ``srgan_tpu/utils/checkpoint.py:405-422``)."""
    ex = _Exporter(params)
    for trunk in ("discriminator1", "discriminator2"):
        for i in range(num_cls):
            ex.put(f"{trunk}.down_convs.{2 * i}.weight",
                   (trunk, f"conv_{i}", "kernel"), _inv_conv_w)
        ex.put(f"{trunk}.down_convs.{2 * num_cls}.weight",
               (trunk, "conv_out", "kernel"), _inv_conv_w)
        ex.put(f"{trunk}.down_convs.{2 * num_cls}.bias",
               (trunk, "conv_out", "bias"), _vec)
    return ex.sd


def per_domain_discriminator_state_dicts_from_jax(
        params: Mapping, num_cls: int = 4) -> List[Dict[str, torch.Tensor]]:
    """The ``singlegan`` trainer's D params, the domains' trees stacked on a
    leading axis (``srgan_tpu/training/gan.py:556-560``) -> one state dict
    per domain, as the reference's ``netD`` list holds them."""
    def take(node, i):
        if isinstance(node, Mapping):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    n = len(np.asarray(params["discriminator1"]["conv_0"]["kernel"]))
    return [original_discriminator_state_dict_from_jax(take(params, i),
                                                       num_cls)
            for i in range(n)]


def vgg_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                            ) -> Dict[str, torch.Tensor]:
    """JAX ``VGG19BN`` ``params`` and ``batch_stats`` -> torchvision's
    ``vgg19_bn`` key layout (``features.N.*`` with ``num_batches_tracked``
    0, ``classifier.{0,3,6}.*``), which the port's ``VGG19BN`` loads with
    ``strict=True`` (``srgan_tpu/utils/checkpoint.py:491-529``)."""
    from srgan_tpu_torch.evaluation.features import VGG19_CFG

    ex = _Exporter(params)
    seq = conv_i = 0
    for v in VGG19_CFG:
        if v == "M":
            seq += 1
            continue
        conv, bn = f"features.{seq}", f"features.{seq + 1}"
        ex.put(f"{conv}.weight", (f"conv_{conv_i}", "kernel"), _inv_conv_w)
        ex.put(f"{conv}.bias", (f"conv_{conv_i}", "bias"), _vec)
        ex.put(f"{bn}.weight", (f"bn_{conv_i}", "scale"), _vec)
        ex.put(f"{bn}.bias", (f"bn_{conv_i}", "bias"), _vec)
        stats = batch_stats[f"bn_{conv_i}"]
        for key, stat in (("running_mean", "mean"), ("running_var", "var")):
            ex.sd[f"{bn}.{key}"] = torch.from_numpy(
                np.array(stats[stat], np.float32))
        ex.sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
        seq += 3
        conv_i += 1
    for idx, name in ((0, "fc0"), (3, "fc1"), (6, "fc2")):
        ex.put(f"classifier.{idx}.weight", (name, "kernel"), _inv_lin_w)
        ex.put(f"classifier.{idx}.bias", (name, "bias"), _vec)
    return ex.sd


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` state dict onto the CPU; tensors only, no pickled
    code."""
    return torch.load(path, map_location="cpu", weights_only=True)


NET_FILES = (("G", "generator.pth"), ("D", "discriminator.pth"),
             ("E", "encoder.pth"))
TRAIN_STATE_FILE = "train_state.pth"
_STEP_DIR = re.compile(r"step_(\d+)")


def latest_step(path: str) -> Optional[int]:
    """The largest N of the ``step_N`` directories under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_DIR.fullmatch,
                                          os.listdir(path)) if m]
    return max(steps) if steps else None


def save_checkpoint(path: str, state, step: int) -> str:
    """Write ``state`` (a ``GANTrainState``) to ``<path>/step_<step>/``,
    replacing one that is there; returns the directory.  The files are
    written into a temporary directory that is then renamed, so a reader
    never sees half a checkpoint."""
    final = os.path.join(path, f"step_{int(step)}")
    tmp = f"{final}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for attr, name in NET_FILES:
        torch.save(getattr(state, attr).state_dict(), os.path.join(tmp, name))
    hist = state.hist_target
    torch.save(dict(opt_g=state.opt_g.state_dict(),
                    opt_d=state.opt_d.state_dict(),
                    opt_e=state.opt_e.state_dict(),
                    step=int(state.step),
                    hist_target=None if hist is None else hist.cpu()),
               os.path.join(tmp, TRAIN_STATE_FILE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def restore_checkpoint(path: str, state, step: Optional[int] = None):
    """Load ``<path>/step_<step>/`` (default: the latest) into ``state`` in
    place and return it.  The nets load with ``strict=True``; the encoder's
    optimizer must hold the same parameters as when it was saved (the frozen
    trunk stays frozen: loading sets no ``requires_grad``)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no step_N checkpoint under {path}")
    ckpt = os.path.join(path, f"step_{int(step)}")
    for attr, name in NET_FILES:
        getattr(state, attr).load_state_dict(
            load_state_dict_file(os.path.join(ckpt, name)))
    saved = torch.load(os.path.join(ckpt, TRAIN_STATE_FILE),
                       map_location="cpu", weights_only=True)
    state.opt_g.load_state_dict(saved["opt_g"])
    state.opt_d.load_state_dict(saved["opt_d"])
    state.opt_e.load_state_dict(saved["opt_e"])
    state.step = int(saved["step"])
    hist = saved["hist_target"]
    if (hist is None) != (state.hist_target is None):
        raise ValueError(f"{ckpt}: the histogram target is "
                         f"{'absent' if hist is None else 'present'}, the "
                         "state's is not: another loss configuration")
    if hist is not None:
        state.hist_target = hist.to(state.hist_target.device)
    return state
