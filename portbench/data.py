"""What a run serves, made from ``--seed``: weights, camera frames, gallery.

Everything is drawn on the run's device by one ``torch.Generator`` seeded
from ``--seed``, in a few large calls, then copied to the host once: the
port's engine takes float32 flax trees of numpy arrays (it casts them to
the served dtype itself), the clients submit numpy BGR frames, and the
gallery is installed from a host matrix.  The same arrays go to the port
and to the reference.

Weights follow the synthetic-leaf convention the port's own packs use
(fan-in normal kernels, unit BatchNorm scales and variances, zero biases
and means, unit SCRFD bbox scales, the classification prior -4.595), drawn
from the seed instead of a fixed hash.  With them most draws fill every
one of a frame's ``max_faces`` slots; the detector is redrawn from the
seed (``draw``) until the reference finds every frame of the pool full
(``serve.full_detector``), so every seed serves the same work.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.pipeline import detector_factory, embedder_factory
from .reference.weights import flax_layout

CLS_PRIOR = -4.595


def generator(seed: int, device, stream: int, draw: int = 0) -> torch.Generator:
    """One generator a stream of draws (weights, frames, gallery), so adding
    a draw to one stream moves no other; ``draw`` k > 0 is the stream's
    k-th redraw, seeded by a hash of all three (the CPU's generator reads
    only a seed's low 32 bits)."""
    g = torch.Generator(device=device)
    if draw:
        g.manual_seed(int(np.random.SeedSequence([int(seed) % (1 << 64), stream, int(draw)])
                          .generate_state(1, np.uint64)[0]) >> 1)
    else:
        g.manual_seed((int(seed) * 4 + stream) % (1 << 63))
    return g


def layout(make) -> list:
    """[(flax path, flax shape)] of the module ``make()`` builds, with no
    parameter allocated."""
    with torch.device("meta"):
        model = make()
    return [(path, tuple(shape)) for _, path, shape, _ in flax_layout(model)]


def _constant(path: str, shape) -> np.ndarray | None:
    leaf = path.rsplit("/", 1)[-1]
    if path.endswith("head/cls/bias"):
        return np.full(shape, CLS_PRIOR, np.float32)
    if leaf.startswith("bbox_scale") or leaf in ("scale", "var"):
        return np.ones(shape, np.float32)
    if leaf in ("bias", "mean"):
        return np.zeros(shape, np.float32)
    return None


def make_weights(leaves: list, seed: int, device, stream: int, draw: int = 0) -> dict:
    """{flax path: float32 numpy leaf}: every drawn leaf in one normal draw
    of the total size on ``device``, scaled by sqrt(2 / fan_in)."""
    drawn = [(p, s) for p, s in leaves if _constant(p, s) is None]
    sizes = [int(np.prod(s)) for _, s in drawn]
    stds = [float(np.sqrt(2.0 / max(1, int(np.prod(s[:-1])) if len(s) > 1 else int(s[0]))))
            for _, s in drawn]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, stream, draw),
                       device=device)
    flat *= torch.repeat_interleave(torch.tensor(stds, device=device),
                                    torch.tensor(sizes, device=device))
    host = flat.cpu().numpy()
    out, at = {}, 0
    for (path, shape), n in zip(drawn, sizes):
        out[path] = host[at:at + n].reshape(shape)
        at += n
    for path, shape in leaves:
        if path not in out:
            out[path] = _constant(path, shape)
    return out


def model_weights(config: dict, seed: int, device) -> tuple:
    """(detector leaves, embedder leaves) of a configuration."""
    return detector_weights(config, seed, device), embedder_weights(config, seed, device)


def detector_weights(config: dict, seed: int, device, draw: int = 0) -> dict:
    return make_weights(layout(detector_factory(config["detector"])), seed, device, 0, draw)


def embedder_weights(config: dict, seed: int, device) -> dict:
    return make_weights(layout(embedder_factory(config["recognizer"])), seed, device, 1)


def camera_frames(n: int, height: int, width: int, seed: int, device) -> np.ndarray:
    """[n, height, width, 3] BGR u8: per-frame shading (a base level and a
    gradient) plus sensor noise of 25 levels, clipped."""
    g = generator(seed, device, 2)
    base = torch.rand(n, generator=g, device=device) * 130.0 + 60.0
    grad = torch.rand(n, 2, generator=g, device=device) * 0.4 - 0.2
    yy = torch.arange(height, device=device, dtype=torch.float32) - height / 2
    xx = torch.arange(width, device=device, dtype=torch.float32) - width / 2
    img = (base[:, None, None] + grad[:, 0, None, None] * xx[None, None, :]
           + grad[:, 1, None, None] * yy[None, :, None])
    img = img[..., None] + torch.randn(n, height, width, 3, generator=g, device=device) * 25.0
    return img.clamp(0, 255).to(torch.uint8).cpu().numpy()


def distractors(n: int, dim: int, seed: int, device) -> np.ndarray:
    """[n, dim] float32 unit rows: the enrolled persons the cameras never
    see."""
    x = torch.randn(n, dim, generator=generator(seed, device, 3), device=device)
    return torch.nn.functional.normalize(x, dim=1).cpu().numpy()


def client_orders(seed: int, clients: int, pool: int) -> np.ndarray:
    """[clients, pool] pool indices: client c serves the pool in its own
    seeded order, cycling."""
    rng = np.random.default_rng(int(seed))
    return np.stack([rng.permutation(pool) for _ in range(clients)])


def nested(flat: dict) -> dict:
    """{``/``-joined path: leaf} -> the nested flax tree the port takes."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree
