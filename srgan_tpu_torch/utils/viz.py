"""Visualisation and reporting (counterpart of ``srgan_tpu/utils/viz.py``).

Each figure of the JAX module is split in two: a device part in torch that
returns numpy arrays (``progress_panels``, ``get_samples``), and a drawing
part that imports matplotlib (``Agg``) only when it is called and keeps the
JAX figures' layout, axes, titles and order:

  - training-progress grid   ``training_progress_grid`` (util_notebook.py:
                             738-846)
  - latent sample sweep      ``get_samples`` (util_notebook.py:858-950)
  - GIF writer               ``save_gif`` (util.py:356-373; PIL imported
                             when it is called)
  - loss curves              ``plot_loss_curves`` over a metrics.jsonl
  - correlation matrix       ``plot_correlation_matrix`` (util.py:336-354)
  - confusion matrix         ``plot_confusion_matrix`` (util.py:376-452)

The grid's four random latents come from a ``torch.Generator`` (the JAX
function splits a PRNG key) or are passed in.
"""

from __future__ import annotations

import importlib.util
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from srgan_tpu_torch.data.sampling import get_target
from srgan_tpu_torch.ops.image import to_uint8_images
from srgan_tpu_torch.training import gan


def require_matplotlib(what: str):
    """Raise unless matplotlib can be imported: callers that will draw check
    this before any work, not at their first figure."""
    if importlib.util.find_spec("matplotlib") is None:
        raise RuntimeError(f"{what} needs matplotlib, which is not "
                           "installed here")


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def close(fig):
    """Release a figure of this module."""
    _pyplot().close(fig)


# ---------------------------------------------------------------------------
# device parts
# ---------------------------------------------------------------------------

def progress_latents(random_sample_num: int, n_targets: int, ndim: int,
                     generator: torch.Generator) -> List[torch.Tensor]:
    """The grid's four standard-normal latents, in the JAX function's order
    of ``k1..k4`` (``srgan_tpu/utils/viz.py:43-53``): the random-latent
    targets, the per-class translations, the random-latent recons and the
    random-latent identities."""
    shapes = ((random_sample_num, ndim), (n_targets, ndim),
              (random_sample_num, ndim), (random_sample_num, ndim))
    return [torch.randn(s, generator=generator, device=generator.device)
            for s in shapes]


def progress_panels(trainer, state, image: np.ndarray, label: int,
                    classes: Sequence[int], random_sample_num: int = 5,
                    latents: Optional[Sequence] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, np.ndarray]:
    """The images of the progress grid for one source ``image`` (H, W, C)
    of class ``label``, as (N, H, W, C) fp32 arrays, computed as
    ``srgan_tpu/utils/viz.py:29-62`` does: source, target / recon /
    identity by the source's encoded style, one translation per other class
    (``targets``), and ``random_sample_num`` targets, recons and identities
    by random latents.  ``latents`` are those four draws (see
    ``progress_latents``); without them they are drawn from ``generator``
    (default: one seeded with 0)."""
    G, E = state.G, state.E
    dev = next(G.parameters()).device
    ndim = trainer.cfg.model.ndim
    src = torch.from_numpy(np.asarray(image, np.float32))[None].to(dev)
    src_label = np.array([label])
    tgt_all = get_target(src_label, classes, shuffle=False)[0]
    tgt_label = np.array([tgt_all[0]])
    n = random_sample_num
    if latents is None:
        latents = progress_latents(n, len(tgt_all), ndim,
                                   generator or torch.Generator()
                                   .manual_seed(0))
    k1, k2, k3, k4 = (torch.as_tensor(lat, dtype=torch.float32).to(dev)
                      for lat in latents)

    def tr(x, labels, latent):
        return gan.transform(G, x, torch.as_tensor(labels), latent)[0]

    with trainer._autocast():
        style = gan.encode(E, src, src_label)[0]
        tgt_by_src = tr(src, tgt_label, style)
        rep = src.repeat(n, 1, 1, 1)
        tgt_rand = tr(rep, np.repeat(tgt_label, n), k1)
        recon = tr(tgt_rand[:1], src_label, style)
        idt = tr(src, src_label, style)
        trans = tr(src.repeat(len(tgt_all), 1, 1, 1), tgt_all, k2)
        recon_rand = tr(tgt_rand[:1].repeat(n, 1, 1, 1),
                        np.repeat(src_label, n), k3)
        idt_rand = tr(rep, np.repeat(src_label, n), k4)
    out = dict(source=src, tgt_by_src=tgt_by_src, recon=recon, idt=idt,
               trans=trans, tgt_rand=tgt_rand, recon_rand=recon_rand,
               idt_rand=idt_rand)
    panels = {k: v.float().cpu().numpy() for k, v in out.items()}
    panels["targets"] = np.asarray(tgt_all)
    return panels


def get_samples(trainer, state, dataset, index: int, latent,
                classes: Sequence[int] = (0, 1, 2, 3), batch: int = 32):
    """Latent sweep per target class for one source image
    (``srgan_tpu/utils/viz.py:84-117``).

    latent: (num, ndim), or a list of per-class arrays.  Returns (data,
    label) dicts of numpy arrays: data["target"][cls] = (num, H, W, 3)
    images, label["latent"][cls] = the encoder's mu of each output (the
    conditional encoder given ``cls``)."""
    G, E = state.G, state.E
    dev = next(G.parameters()).device
    img, src_label = dataset[index]
    src = torch.from_numpy(np.asarray(img, np.float32))[None].to(dev)
    latent_list = latent if isinstance(latent, list) else \
        [np.asarray(latent)] * len(classes)

    data = {"source": np.asarray(img), "target": {}}
    label = {"source": np.array([src_label]), "latent": {}}
    for cls, lat in zip(classes, latent_list):
        imgs, mus = [], []
        for start in range(0, len(lat), batch):
            chunk = torch.from_numpy(np.asarray(lat[start:start + batch],
                                                np.float32)).to(dev)
            m = chunk.shape[0]
            with trainer._autocast():
                out, _ = gan.transform(G, src.repeat(m, 1, 1, 1),
                                       torch.full((m,), cls), chunk)
                mu = gan.encode(E, out, torch.full((m,), cls))[0]
            imgs.append(out.float().cpu().numpy())
            mus.append(mu.float().cpu().numpy())
        data["target"][cls] = np.concatenate(imgs)
        label["latent"][cls] = np.concatenate(mus)
    return data, label


# ---------------------------------------------------------------------------
# drawing parts
# ---------------------------------------------------------------------------

def draw_progress_grid(panels: Dict[str, np.ndarray],
                       label_description: Dict[int, str]):
    """The ``get_output_and_plot`` layout of ``progress_panels``' images:
    4 columns x (1 + max(samples, classes)) rows."""
    plt = _pyplot()
    targets = panels["targets"]
    n = len(panels["tgt_rand"])
    length, width = max(n, len(targets)) + 1, 4
    fig = plt.figure(figsize=(4 * width, 4 * length))

    def show(pos, image, title):
        ax = fig.add_subplot(length, width, pos)
        ax.imshow(to_uint8_images(np.asarray(image))[0])
        ax.set_title(title)
        ax.axis("off")

    show(1, panels["source"], "source")
    show(2, panels["tgt_by_src"], "target by source condition")
    show(3, panels["recon"], "recon by source condition")
    show(4, panels["idt"], "identity by source condition")
    for i, t in enumerate(targets):
        show(4 * (i + 1) + 1, panels["trans"][i:i + 1],
             label_description[int(t)])
    for i in range(n):
        show(4 * (i + 1) + 2, panels["tgt_rand"][i:i + 1],
             "target by random latent")
        show(4 * (i + 1) + 3, panels["recon_rand"][i:i + 1],
             "recon by random latent")
        show(4 * (i + 1) + 4, panels["idt_rand"][i:i + 1],
             "idt by random latent")
    fig.tight_layout()
    return fig


def training_progress_grid(trainer, state, dataset, index: int,
                           label_description: Dict[int, str],
                           random_sample_num: int = 5,
                           latents: Optional[Sequence] = None,
                           generator: Optional[torch.Generator] = None):
    """The progress grid of ``dataset[index]``: ``progress_panels`` drawn
    by ``draw_progress_grid``.  Returns the matplotlib Figure."""
    img, label = dataset[index]
    panels = progress_panels(trainer, state, img, label,
                             tuple(sorted(label_description)),
                             random_sample_num, latents, generator)
    return draw_progress_grid(panels, label_description)


def save_gif(images: Sequence[np.ndarray], gif_path: str,
             duration: int = 100):
    """uint8/float image sequence -> animated GIF."""
    from PIL import Image

    frames = [Image.fromarray(f) for f in to_uint8_images(np.asarray(images))]
    frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                   duration=duration, loop=0)


def plot_loss_curves(metrics, model_keys: Sequence[str] = ("errD", "errG",
                                                           "errE"),
                     x_key: str = "step",
                     save_path: Optional[str] = None):
    """Training loss curves: the reference's loss panel (nb01 cell 22, the
    Discriminator / Generator / Encoder lines) and a second axes for the
    loss_* components, when the log has them.  ``metrics`` is a path to a
    metrics.jsonl or a sequence of metric dicts; keys missing from the log
    are skipped; an axis with a non-positive value is symlog, else log."""
    plt = _pyplot()
    if isinstance(metrics, (str, bytes)):
        with open(metrics) as f:
            metrics = [json.loads(line) for line in f]
    metrics = list(metrics)
    if not metrics:
        raise ValueError("empty metrics log")

    xs = [m.get(x_key, i) for i, m in enumerate(metrics)]
    comp_keys = sorted({k for m in metrics for k in m
                        if k.startswith("loss_")})
    present = [k for k in model_keys if any(k in m for m in metrics)]

    def _scale(keys):
        vals = [m[k] for m in metrics for k in keys if k in m]
        return "log" if all(v > 0 for v in vals) else "symlog"

    fig, axes = plt.subplots(1, 2 if comp_keys else 1,
                             figsize=(12 if comp_keys else 6, 4.5))
    axes = np.atleast_1d(axes)
    names = {"errD": "Discriminator", "errG": "Generator",
             "errE": "Encoder", "errG_ex": "Generator (phase 2)"}
    for k in present:
        pts = [(x, m[k]) for x, m in zip(xs, metrics) if k in m]
        axes[0].plot(*zip(*pts), label=names.get(k, k))
    axes[0].set_xlabel(x_key)
    axes[0].set_yscale(_scale(present))
    axes[0].legend()
    axes[0].set_title("model losses")
    if comp_keys:
        for k in comp_keys:
            pts = [(x, m[k]) for x, m in zip(xs, metrics) if k in m]
            axes[1].plot(*zip(*pts), label=k[len("loss_"):])
        axes[1].set_xlabel(x_key)
        axes[1].set_yscale(_scale(comp_keys))
        axes[1].legend(fontsize=8)
        axes[1].set_title("loss components")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, format="png", bbox_inches="tight")
    return fig


def plot_correlation_matrix(cm: np.ndarray, save_path: Optional[str] = None):
    plt = _pyplot()
    fig = plt.figure(figsize=(10, 8))
    plt.imshow(cm, interpolation="nearest", cmap=plt.get_cmap("Blues"))
    plt.colorbar()
    thresh = cm.max() / 2
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            plt.text(j, i, str(round(float(cm[i, j]), 4)),
                     horizontalalignment="center",
                     color="white" if cm[i, j] > thresh else "black",
                     fontsize=12)
    plt.tight_layout()
    if save_path:
        fig.savefig(save_path, format="png", bbox_inches="tight")
    return fig


def plot_confusion_matrix(cm: np.ndarray, target_names: Sequence[str],
                          title: str = "Confusion matrix",
                          normalize: bool = True,
                          save_path: Optional[str] = None):
    plt = _pyplot()
    accuracy = np.trace(cm) / float(np.sum(cm))
    fig = plt.figure(figsize=(10, 8))
    disp = cm.astype(float)
    if normalize:
        disp = disp / disp.sum(axis=1, keepdims=True)
    plt.imshow(disp, interpolation="nearest", cmap=plt.get_cmap("Blues"))
    plt.title(title)
    plt.colorbar()
    ticks = np.arange(len(target_names))
    plt.xticks(ticks, target_names, rotation=45)
    plt.yticks(ticks, target_names)
    thresh = disp.max() / (1.5 if normalize else 2)
    for i in range(disp.shape[0]):
        for j in range(disp.shape[1]):
            txt = f"{disp[i, j]:0.4f}" if normalize else f"{int(cm[i, j]):,}"
            plt.text(j, i, txt, horizontalalignment="center",
                     color="white" if disp[i, j] > thresh else "black")
    plt.ylabel("True label")
    plt.xlabel(f"Predicted label\naccuracy={accuracy:0.4f}; "
               f"misclass={1 - accuracy:0.4f}")
    plt.tight_layout()
    if save_path:
        fig.savefig(save_path, format="png", bbox_inches="tight")
    return fig
