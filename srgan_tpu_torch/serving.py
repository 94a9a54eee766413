"""Batch-inference / serving surface of the port (counterpart of
``srgan_tpu/serving.py``).

``Translator`` holds a generator and an encoder (of any of the three
trainers: the SingleGAN ones' encoder is conditional and needs the images'
labels) on one device and answers translate / encode requests given as
NHWC numpy arrays in [-1, 1], chunked at the largest warm batch size.
``handle_request`` dispatches one request body of the npz wire format
without any socket; ``make_handler`` wraps it for ``http.server`` (see
``srgan_tpu_torch/serve.py``).
"""

from __future__ import annotations

import contextlib
import io
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from srgan_tpu_torch.configs import ExperimentConfig
from srgan_tpu_torch.training import gan
from srgan_tpu_torch.utils.checkpoint import load_state_dict_file


class Translator:
    """Style-translation service over trained weights.

    ``weights_dir`` holds ``generator.pth`` and ``encoder.pth`` in the
    reference's key layout (as ``scripts/export_torch_checkpoint.py``
    writes them, and as a training checkpoint's ``step_N`` holds them).
    ``warmup`` runs each warm batch size once at construction, so
    first-request costs (kernel build and load, cuDNN set-up) are paid at
    start-up.
    """

    def __init__(self, cfg: ExperimentConfig, weights_dir: str,
                 device="cuda", warm_batch_sizes: Sequence[int] = (1, 8, 32),
                 warmup: bool = True):
        g_sd = load_state_dict_file(os.path.join(weights_dir,
                                                 "generator.pth"))
        e_sd = load_state_dict_file(os.path.join(weights_dir, "encoder.pth"))
        self._setup(cfg, g_sd, e_sd, device, warm_batch_sizes, warmup)

    @classmethod
    def from_state_dicts(cls, cfg: ExperimentConfig, g_sd, e_sd,
                         device="cuda",
                         warm_batch_sizes: Sequence[int] = (1, 8, 32),
                         warmup: bool = True) -> "Translator":
        self = cls.__new__(cls)
        self._setup(cfg, g_sd, e_sd, device, warm_batch_sizes, warmup)
        return self

    def _setup(self, cfg, g_sd, e_sd, device, warm_batch_sizes, warmup):
        self.cfg = cfg
        self.device = gan.resolve_device(device)
        dtype = cfg.train.compute_dtype
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {dtype!r}: float32 or bfloat16")
        self.bf16 = dtype == "bfloat16"
        self.G = gan.build_generator(cfg, self.device, state_dict=g_sd)
        self.E = gan.build_encoder(cfg, self.device, state_dict=e_sd)
        self.warm_sizes = tuple(sorted(warm_batch_sizes))
        self.ndim = cfg.model.ndim
        if warmup:
            hw = cfg.model.image_size
            for b in self.warm_sizes:
                dummy = np.zeros((b, hw, hw, cfg.model.nch_in), np.float32)
                self.translate(dummy, np.zeros(b, np.int64),
                               latent=np.zeros((b, self.ndim), np.float32))
                self.encode(dummy, np.zeros(b, np.int64))

    def _autocast(self):
        if not self.bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=torch.bfloat16)

    def _chunks(self, n: int):
        biggest = self.warm_sizes[-1]
        for i in range(0, n, biggest):
            yield i, min(n - i, biggest)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def translate(self, images: np.ndarray, target_labels: np.ndarray,
                  latent: Optional[np.ndarray] = None,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """images: (N, H, W, 3) in [-1, 1]; target_labels: (N,); latent:
        (N, ndim), (ndim,) for one style over the batch, or None for a
        standard-normal draw from a ``torch.Generator`` seeded with
        ``seed``.  Returns (fakes (N, H, W, 3), latents (N, ndim))."""
        images = np.asarray(images, np.float32)
        target_labels = np.asarray(target_labels)
        n = len(images)
        if latent is None:
            latent = torch.randn((n, self.ndim), generator=torch.Generator()
                                 .manual_seed(seed)).numpy()
        latent = np.asarray(latent, np.float32)
        if latent.ndim == 1:
            latent = np.broadcast_to(latent, (n, latent.shape[0]))
        outs = []
        for i, size in self._chunks(n):
            with self._autocast():
                fake, _ = gan.transform(
                    self.G, self._to_device(images[i:i + size]),
                    torch.from_numpy(target_labels[i:i + size]),
                    self._to_device(latent[i:i + size]))
            outs.append(fake.float().cpu().numpy())
        return np.concatenate(outs), np.ascontiguousarray(latent)

    def encode(self, images: np.ndarray, labels: Optional[np.ndarray] = None
               ) -> Dict[str, np.ndarray]:
        """images: (N, H, W, 3), labels: (N,), which the conditional encoder
        needs and the unconditional one ignores -> {"mu": (N, ndim),
        "logvar": (N, ndim)}."""
        images = np.asarray(images, np.float32)
        mus, logvars = [], []
        for i, size in self._chunks(len(images)):
            lbl = None if labels is None else \
                torch.from_numpy(np.asarray(labels)[i:i + size])
            with self._autocast():
                mu, logvar, _ = gan.encode(
                    self.E, self._to_device(images[i:i + size]), lbl)
            mus.append(mu.float().cpu().numpy())
            logvars.append(logvar.float().cpu().numpy())
        return {"mu": np.concatenate(mus), "logvar": np.concatenate(logvars)}


# ---------------------------------------------------------------------------
# npz wire format
# ---------------------------------------------------------------------------

def encode_npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def decode_npz(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def handle_request(translator: Translator, path: str,
                   body: bytes) -> Tuple[int, bytes]:
    """Answer one POST: ``/translate`` (images, target_labels [, latent,
    seed]) -> (fakes, latent); ``/encode`` (images [, labels]) -> (mu,
    logvar).
    Returns (HTTP status, body): 200 with an npz body, 404 for an unknown
    path, 400 with the error's text for a request that fails."""
    if path not in ("/translate", "/encode"):
        return 404, b"not found"
    try:
        req = decode_npz(body)
        if path == "/translate":
            fakes, latent = translator.translate(
                req["images"], req["target_labels"],
                latent=req.get("latent"), seed=int(req.get("seed", 0)))
            return 200, encode_npz(fakes=fakes, latent=latent)
        return 200, encode_npz(**translator.encode(req["images"],
                                                   labels=req.get("labels")))
    except Exception as e:  # the server keeps running; the client sees why
        return 400, f"{type(e).__name__}: {e}".encode()


def make_handler(translator: Translator):
    """``BaseHTTPRequestHandler`` subclass serving ``translator``: GET
    /healthz, and POST bodies dispatched by ``handle_request``."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes):
            ctype = "application/octet-stream" if code == 200 \
                else "text/plain"
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", "0"))
            self._send(*handle_request(translator, self.path,
                                       self.rfile.read(n)))

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler
