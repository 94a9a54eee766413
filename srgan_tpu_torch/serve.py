"""HTTP inference server of the port, the same endpoints as
``scripts/serve.py``:

  GET  /healthz     -> 200 "ok"
  POST /translate   body: images (N,H,W,3) in [-1,1], target_labels (N,)
                          [, latent (N,ndim) or (ndim,), seed]
                    resp: fakes (N,H,W,3), latent (N,ndim)
  POST /encode      body: images     resp: mu, logvar

Bodies are npz archives (``srgan_tpu_torch.serving.encode_npz``).  Run:

    python -m srgan_tpu_torch.serve --weights DIR [--preset 05_srgan_full]

DIR holds ``generator.pth`` and ``encoder.pth``; a ``config.json`` there (or
in its parent) names the model, else ``--preset`` does.
"""

from __future__ import annotations

import argparse
from http.server import ThreadingHTTPServer

from srgan_tpu_torch.configs import PRESETS, load_config_for_ckpt
from srgan_tpu_torch.serving import Translator, make_handler


def main():
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--weights", required=True,
                    help="dir with generator.pth and encoder.pth")
    ap.add_argument("--preset", choices=sorted(PRESETS),
                    help="fallback when the weights dir has no config.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8718)
    ap.add_argument("--warm-batch-sizes", type=int, nargs="+",
                    default=[1, 8, 32])
    args = ap.parse_args()

    cfg = load_config_for_ckpt(args.weights, args.preset)
    print("loading and warming up ...", flush=True)
    translator = Translator(cfg, args.weights, device=args.device,
                            warm_batch_sizes=args.warm_batch_sizes)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(translator))
    print(f"serving {cfg.name} on http://{args.host}:{args.port}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
