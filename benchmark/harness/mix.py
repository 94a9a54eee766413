"""The serving traffic, from a traffic file and the seed alone (numpy only:
the client process imports it too).

Images follow the synthetic-face recipe of the port's fixture (the
"structured" mode of ``data/synthetic.py``, frozen here): a class colour
plus a smooth low-frequency field, a soft radial blob and a linear shading,
quantised to 8 bits, so that zlib sees image-like data and not white
noise.  Each kind of request has a pool of distinct bodies; every seed gets
the same number of requests of each kind and the same set of gaps between
arrivals (the quantiles of an exponential at the traffic's rate), in an
order drawn from the seed."""

from __future__ import annotations

import io

import numpy as np

CLASS_COLOURS = np.array([[120, 140, 120], [120, 80, 120], [60, 140, 120],
                          [60, 80, 120]], np.float32)


def _smooth_field(rng, h, w, coarse=(5, 4), sigma=18.0):
    ch, cw = coarse
    grid = rng.normal(0, sigma, (ch, cw, 3)).astype(np.float32)
    ys, xs = np.linspace(0, ch - 1, h), np.linspace(0, cw - 1, w)
    y0 = np.clip(ys.astype(np.int64), 0, ch - 2)
    x0 = np.clip(xs.astype(np.int64), 0, cw - 2)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    return ((1 - wy) * ((1 - wx) * grid[y0][:, x0] + wx * grid[y0][:, x0 + 1])
            + wy * ((1 - wx) * grid[y0 + 1][:, x0]
                    + wx * grid[y0 + 1][:, x0 + 1]))


def face(rng, size: int) -> np.ndarray:
    """One (size, size, 3) float32 image in [-1, 1]."""
    h = w = size
    base = CLASS_COLOURS[rng.integers(0, 4)]
    field = _smooth_field(rng, h, w)
    cy, cx = rng.uniform(0.25, 0.75) * h, rng.uniform(0.25, 0.75) * w
    sig = rng.uniform(25.0, 55.0) * size / 178
    amp = rng.uniform(20.0, 45.0) * rng.choice([-1.0, 1.0])
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    blob = amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
    gdir, gamp = rng.uniform(0, 2 * np.pi), rng.uniform(0.0, 15.0)
    grad = gamp * ((yy / h - 0.5) * np.sin(gdir) + (xx / w - 0.5)
                   * np.cos(gdir))
    u8 = np.clip(base + field + (blob + grad)[:, :, None], 0, 255).astype(
        np.uint8)
    return (u8.astype(np.float32) / 127.5 - 1.0).astype(np.float32)


def pool(traffic: dict, model: dict, seed: int) -> dict:
    """{kind: [request dict]}: each request has ``path`` and its arrays
    (``images``, and for a translation ``target_labels`` with ``latent`` or
    ``seed``).  Every other translation body of a kind carries a latent;
    the rest let the server draw one from ``seed``.  A ``styles`` kind is
    one image under that many latents, toward one target."""
    rng = np.random.default_rng([seed % 2 ** 64, 7])
    size, ndim, nc = model["image_size"], model["ndim"], model["n_classes"]
    out = {}
    for kind in traffic["mix"]:
        bodies = []
        for j in range(traffic["pool_per_kind"][kind["name"]]):
            if kind.get("styles"):
                n = kind["styles"]
                images = np.repeat(face(rng, size)[None], n, axis=0)
                req = {"images": images,
                       "target_labels": np.full(n, rng.integers(0, nc)),
                       "latent": rng.standard_normal((n, ndim)).astype(
                           np.float32)}
            else:
                n = kind["images"]
                req = {"images": np.stack([face(rng, size)
                                           for _ in range(n)])}
                if kind["path"] == "/translate":
                    req["target_labels"] = rng.integers(0, nc, n)
                    if j % 2 == 0:
                        req["latent"] = rng.standard_normal(
                            (n, ndim)).astype(np.float32)
                    else:
                        req["seed"] = np.asarray(int(rng.integers(0, 2 ** 31)))
            req["path"] = kind["path"]
            bodies.append(req)
        out[kind["name"]] = bodies
    return out


def schedule(traffic: dict, seed: int, seconds: float):
    """[(due_s, kind, body index)]: ``rate_per_s * seconds`` requests, each
    kind's count its share of them (largest remainders), the gaps the
    quantiles of an exponential at the rate, kinds, gaps and bodies in an
    order drawn from the seed."""
    rate = traffic["rate_per_s"]
    n = max(1, round(rate * seconds))
    shares = [(k["name"], k["share"] * n) for k in traffic["mix"]]
    counts = {name: int(x) for name, x in shares}
    for name, x in sorted(shares, key=lambda s: int(s[1]) - s[1])[
            :n - sum(counts.values())]:
        counts[name] += 1
    rng = np.random.default_rng([seed % 2 ** 64, 8])
    kinds = rng.permutation([name for name, c in counts.items()
                             for _ in range(c)])
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    index = {name: list(rng.permutation(
        np.arange(c) % traffic["pool_per_kind"][name]))
        for name, c in counts.items()}
    return [(float(d), str(k), int(index[k].pop()))
            for d, k in zip(due, kinds)]


def sample(traffic: dict, sched, seed: int) -> list:
    """Indices of the requests whose answers are compared: the first of
    each kind (the longest among them) and ``sample`` more drawn from the
    seed."""
    rng = np.random.default_rng([seed % 2 ** 64, 9])
    first = {}
    for i, (_, kind, _) in enumerate(sched):
        first.setdefault(kind, i)
    extra = rng.choice(len(sched), min(traffic["sample"], len(sched)),
                       replace=False)
    return sorted(set(first.values()) | {int(i) for i in extra})


def encode_npz(arrays: dict) -> bytes:
    """The wire format: an npz archive, zlib-compressed."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def decode_npz(data: bytes) -> dict:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
