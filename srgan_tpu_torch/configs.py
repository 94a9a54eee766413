"""Experiment configuration: the port's own copy of ``srgan_tpu/configs.py``
for the presets it trains and serves and for the classifier-pretraining and
PRDC jobs (same field names and defaults), so that a run's ``config.json``
is the same file for both packages and the presets resolve without JAX."""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """The reference's ``lbd`` dict (``srgan_tpu/configs.py:18-45``)."""

    cycle: float = 5.0
    idt: float = 5.0
    reg: float = 0.5
    idt_reg: float = 0.5
    KL: float = 0.0
    batch_KL: float = 10.0
    corr_enc: float = 100.0
    hist: float = 100.0
    cls: float = 1.0

    @classmethod
    def proposed_kl(klass, **kw) -> "LossWeights":
        return klass(KL=0.0, batch_KL=10.0, corr_enc=100.0, hist=100.0, **kw)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (``srgan_tpu/configs.py:48-76``)."""

    image_size: int = 128
    nch_in: int = 3
    ndim: int = 8
    n_classes: int = 4

    g_nch: int = 64
    g_reduce: int = 2
    g_num_cls: int = 2
    g_res_num: int = 6
    norm_type: str = "instance"

    d_nch: int = 64
    d_reduce: int = 2
    d_num_cls: int = 4

    e_nch: int = 64
    e_num_cls: int = 4

    @property
    def num_con(self) -> int:
        """Conditioning dim fed to the generator: one-hot class + latent."""
        return self.n_classes + self.ndim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters (``srgan_tpu/configs.py:79-115``).
    Serving reads ``compute_dtype``; the rest is kept so that every stored
    run config parses."""

    batch_size: int = 128
    epochs: int = 31
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    lr_e: float = 1e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    lr_gamma: float = 0.95
    unrolled_k: int = 5
    unrolled_restore: bool = False
    encoded_feature: str = "mu"
    train_num: int = 10000
    val_num: int = 0
    test_num: int = 100
    seed: int = 0
    compute_dtype: str = "float32"   # "float32" | "bfloat16"
    drop_last: bool = True


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: ModelConfig
    train: TrainConfig
    loss: LossWeights
    trainer: str = "srgan"     # "singlegan" | "singlegan_solo" | "srgan"
    pretrained_encoder: bool = False


def srgan_nopretraining() -> ExperimentConfig:
    """Notebook 03: SRGAN (unconditional encoder), no pretraining."""
    return ExperimentConfig(
        name="03_srgan_nopretraining",
        model=ModelConfig(),
        train=TrainConfig(encoded_feature="mu"),
        loss=LossWeights.proposed_kl(cls=1.0),
        trainer="srgan",
    )


def srgan_full() -> ExperimentConfig:
    """Notebook 05: full SRGAN with the classification-pretrained encoder."""
    return ExperimentConfig(
        name="05_srgan_pretrained",
        model=ModelConfig(),
        train=TrainConfig(encoded_feature="mu"),
        loss=LossWeights.proposed_kl(cls=1.0),
        trainer="srgan",
        pretrained_encoder=True,
    )


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """The nb04 encoder-classifier pretraining job
    (``srgan_tpu/configs.py:196-210``)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    epochs: int = 301
    lr: float = 1e-4
    lr_gamma: float = 0.99
    batch_size: int = 512
    test_interval: int = 3
    train_num: int = 10000
    val_num: int = 1000
    test_num: int = 100
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class PRDCConfig:
    """The nb06 PRDC evaluation (``srgan_tpu/configs.py:212-219``)."""

    nearest_k: int = 5
    batch: int = 32
    feature_extractors: Tuple[str, ...] = (
        "vgg-initialization", "vgg-ImageNet", "vgg-CelebA")
    metrics: Tuple[str, ...] = ("precision", "recall", "density", "coverage")


def config_to_dict(cfg: ExperimentConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> ExperimentConfig:
    return ExperimentConfig(
        name=d["name"],
        model=ModelConfig(**d["model"]),
        train=TrainConfig(**d["train"]),
        loss=LossWeights(**d["loss"]),
        trainer=d.get("trainer", "srgan"),
        pretrained_encoder=d.get("pretrained_encoder", False),
    )


def save_config(cfg: ExperimentConfig, out_dir: str) -> str:
    """Write ``out_dir/config.json``, the record a run's later commands
    rebuild the model from (``srgan_tpu/configs.py:237-252``: the same
    file)."""
    path = os.path.join(out_dir, "config.json")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=1)
    return path


def load_config_for_ckpt(ckpt_path: str, preset: str | None = None
                         ) -> ExperimentConfig:
    """A ``config.json`` in the weights dir or its parent wins (it reflects
    the run's actual overrides); otherwise the named preset."""
    p = os.path.abspath(ckpt_path)
    for cand_dir in (p, os.path.dirname(p)):
        cand = os.path.join(cand_dir, "config.json")
        if os.path.exists(cand):
            with open(cand) as f:
                cfg = config_from_dict(json.load(f))
            if preset is not None and cfg != PRESETS[preset]():
                warnings.warn(
                    f"both {cand} and --preset {preset} given and they "
                    f"differ: using the stored run config '{cfg.name}' "
                    "(it reflects the run's actual overrides)")
            return cfg
    if preset is None:
        raise ValueError(
            f"no config.json found near {ckpt_path} and no --preset given")
    return PRESETS[preset]()


# the presets whose trainer (srgan, unconditional Encoder) the port has
PRESETS = {
    "03_srgan_nopretraining": srgan_nopretraining,
    "05_srgan_full": srgan_full,
    # the config srgan_full builds is named "05_srgan_pretrained"
    "05_srgan_pretrained": srgan_full,
}


def get_adjustable_parameters(notebook_no: int = 1):
    """The reference's experiment registry (util_notebook.py:10-26) as a
    pandas table; None for notebooks whose registry was None."""
    import numpy as np
    import pandas as pd

    if notebook_no == 1:
        models = [["conventionalKL", 1, 0],
                  ["preposedKL", 1, 0],
                  ["preposedKL", 5, 0.5]]
        return pd.DataFrame(np.array(models),
                            columns=["restriction_type", "unrolled_k",
                                     "idt_reg"])
    return None
