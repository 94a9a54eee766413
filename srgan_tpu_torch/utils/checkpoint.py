"""The weight carry-over from the JAX package's parameter trees to the port.

Counterpart of the torch export in ``srgan_tpu/utils/checkpoint.py:339-489``:
the same key layout (the reference's ``SingleGenerator``, ``Encoder`` and
``SingleDiscriminator_solo_multi``), computed from parameter trees given as
nested dicts of numpy arrays, so the port needs no JAX to read them.
``load_state_dict_file`` reads the ``generator.pth`` / ``encoder.pth`` that
``scripts/export_torch_checkpoint.py`` writes.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
    """Collects torch-key -> tensor assignments from a parameter tree."""

    def __init__(self, params: Mapping):
        self.params = params
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, path, fn):
        node = self.params
        for p in path:
            node = node[p]
        self.sd[key] = torch.from_numpy(np.array(fn(node), np.float32))

    def cbinorm(self, prefix: str, path):
        self.put(f"{prefix}.ConBias.0.weight", path + ("con_bias", "kernel"),
                 _inv_lin_w)
        self.put(f"{prefix}.ConBias.0.bias", path + ("con_bias", "bias"),
                 _vec)
        self.put(f"{prefix}.weight", path + ("scale",), _vec)
        self.put(f"{prefix}.bias", path + ("bias",), _vec)


def generator_state_dict_from_jax(params: Mapping, num_cls: int = 2,
                                  res_num: int = 6) -> Dict[str, torch.Tensor]:
    """JAX ``SingleGenerator`` params -> the port's generator state dict."""
    ex = _Exporter(params)
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
    ex.put(f"up_convs.{num_cls}.weight", ("up_conv_out", "kernel"),
           _inv_conv_w)
    return ex.sd


def encoder_state_dict_from_jax(params: Mapping, num_cls: int = 4
                                ) -> Dict[str, torch.Tensor]:
    """JAX (unconditional) ``Encoder`` params -> the port's encoder state
    dict."""
    ex = _Exporter(params)
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
    for head in ("fcmean", "fcvar", "fcclass"):
        ex.put(f"{head}.weight", (head, "kernel"), _inv_lin_w)
        ex.put(f"{head}.bias", (head, "bias"), _vec)
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


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` state dict onto the CPU; tensors only, no pickled
    code."""
    return torch.load(path, map_location="cpu", weights_only=True)
