"""Experiment configuration: the port's own copy of what serving reads from
``srgan_tpu/configs.py`` (same field names and defaults), so that a run's
``config.json`` parses and the serving presets resolve without JAX."""

from __future__ import annotations

import dataclasses
import json
import os
import warnings


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


def config_from_dict(d: dict) -> ExperimentConfig:
    return ExperimentConfig(
        name=d["name"],
        model=ModelConfig(**d["model"]),
        train=TrainConfig(**d["train"]),
        loss=LossWeights(**d["loss"]),
        trainer=d.get("trainer", "srgan"),
        pretrained_encoder=d.get("pretrained_encoder", False),
    )


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


# the presets whose trainer (srgan, unconditional Encoder) the port serves
PRESETS = {
    "03_srgan_nopretraining": srgan_nopretraining,
    "05_srgan_full": srgan_full,
    # the config srgan_full builds is named "05_srgan_pretrained"
    "05_srgan_pretrained": srgan_full,
}
