"""HTTP inference server of the port, the same endpoints as
``scripts/serve.py``:

  GET  /healthz     -> 200 "ok"
  POST /translate   body: images (N,H,W,3) in [-1,1], target_labels (N,)
                          [, latent (N,ndim) or (ndim,), seed]
                    resp: fakes (N,H,W,3), latent (N,ndim)
  POST /encode      body: images [, labels (N,), which the SingleGAN
                          presets' conditional encoder needs]
                    resp: mu, logvar

Bodies are npz archives (``srgan_tpu_torch.serving.encode_npz``).  Run:

    python -m srgan_tpu_torch.serve --ckpt RUN/ckpt [--ckpt-step N]
    python -m srgan_tpu_torch.serve --weights DIR [--preset 05_srgan_full]

--ckpt is a training run's checkpoint directory (``python -m
srgan_tpu_torch.train`` writes RUN/ckpt/step_N); the latest step is served
unless --ckpt-step names one, and the run's RUN/config.json names the model.
--weights is a bare directory holding ``generator.pth`` and
``encoder.pth``; a ``config.json`` there or up to two levels above names
the model, else --preset does.
"""

from __future__ import annotations

import argparse
from http.server import ThreadingHTTPServer

from srgan_tpu_torch.configs import PRESETS, load_config_for_ckpt
from srgan_tpu_torch.serving import Translator, make_handler
from srgan_tpu_torch.utils.checkpoint import step_dir


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="a run's ckpt dir of step_N checkpoints")
    src.add_argument("--weights",
                     help="dir with generator.pth and encoder.pth")
    ap.add_argument("--ckpt-step", type=int,
                    help="the step_N of --ckpt to serve (default: latest)")
    ap.add_argument("--preset", choices=sorted(PRESETS),
                    help="fallback when no config.json is found")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8718)
    ap.add_argument("--warm-batch-sizes", type=int, nargs="+",
                    default=[1, 8, 32])
    args = ap.parse_args(argv)
    if args.ckpt_step is not None and args.ckpt is None:
        ap.error("--ckpt-step goes with --ckpt")
    return args


def build_translator(args) -> Translator:
    """The Translator the parsed arguments name: the weights directory (for
    --ckpt, its step_N) and the config found near it."""
    weights = args.weights
    if args.ckpt is not None:
        weights = step_dir(args.ckpt, args.ckpt_step)
    cfg = load_config_for_ckpt(weights, args.preset)
    return Translator(cfg, weights, device=args.device,
                      warm_batch_sizes=args.warm_batch_sizes)


def main(argv=None):
    args = parse_args(argv)
    print("loading and warming up ...", flush=True)
    translator = build_translator(args)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(translator))
    print(f"serving {translator.cfg.name} on http://{args.host}:{args.port}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
