# Frozen excerpt of facerecognition_infrenceengine_tpu_torch/models/weights.py at
# commit 5fe48e2: the flax leaf layout of a module, the flax -> torch leaf
# conversion and the deterministic synthetic leaves; do not edit, except for
# the ``nn.LayerNorm`` branch of ``flax_layout``, which the port's
# models/weights.py does not have yet (no model of the port builds a
# LayerNorm): the change that first builds one there adds it there too.
"""Flax-tree weights for the reference's modules (frozen excerpt)."""

from __future__ import annotations

import zlib

import numpy as np
import torch
from torch import nn

SEP = "/"

def _synthetic_leaf(path: str, shape, dtype, seed: int) -> np.ndarray:
    """Deterministic numpy init for one flax leaf, keyed by its tree path.

    A bit-for-bit copy of the reference's ``_synthetic_leaf``: fan-in
    normal kernels drawn in the flax shape, the SCRFD classification prior,
    unit bbox scales, zero biases/means and unit scales/vars.
    """
    leaf = path.rsplit(SEP, 1)[-1]
    npdtype = np.dtype(dtype)
    if path.endswith("head/cls/bias"):
        return np.full(shape, -4.595, npdtype)
    if leaf.startswith("bbox_scale"):
        return np.ones(shape, npdtype)
    if leaf in ("bias", "mean"):
        return np.zeros(shape, npdtype)
    if leaf in ("scale", "var"):
        return np.ones(shape, npdtype)
    digest = zlib.crc32(f"{path}:{seed}".encode())
    rng = np.random.default_rng(digest)
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else max(1, int(shape[0] if shape else 1))
    std = float(np.sqrt(2.0 / max(1, fan_in)))
    return rng.normal(0.0, std, size=shape).astype(npdtype)


def _conv_to_torch(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))  # HWIO -> OIHW


def _dense_to_torch(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(k.T)


_conv_to_torch.inverse = lambda w: np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
_dense_to_torch.inverse = _dense_to_torch


def _flat_dense_to_torch(chw):
    """Dense after a flatten: flax flattens NHWC (spatial-major), torch
    NCHW (channel-major), so the kernel rows H*W*C are permuted to C*H*W
    (the inverse of tools/convert_onnx.py's mapping)."""
    c, h, w = chw

    def convert(k: np.ndarray) -> np.ndarray:
        n_out = k.shape[1]
        k = k.reshape(h, w, c, n_out).transpose(3, 2, 0, 1)
        return np.ascontiguousarray(k.reshape(n_out, c * h * w))

    def inverse(t: np.ndarray) -> np.ndarray:
        n_out = t.shape[0]
        t = t.reshape(n_out, c, h, w).transpose(2, 3, 1, 0)
        return np.ascontiguousarray(t.reshape(h * w * c, n_out))

    convert.inverse = inverse
    return convert


def _identity(a: np.ndarray) -> np.ndarray:
    return a


_identity.inverse = _identity


def flax_layout(model: nn.Module) -> list:
    """[(state-dict key, flax path, flax shape, flax->torch convert)] for
    every tensor the flax tree holds (``num_batches_tracked`` has no flax
    counterpart and is skipped)."""
    out = []
    for key, tensor in model.state_dict().items():
        mod_path, _, name = key.rpartition(".")
        mod = model.get_submodule(mod_path) if mod_path else model
        base = mod_path.replace(".", SEP)
        prefix = f"params{SEP}{base}{SEP}" if base else f"params{SEP}"
        shape = tuple(tensor.shape)
        if isinstance(mod, nn.Conv2d):
            if name == "weight":
                out.append((key, prefix + "kernel",
                            (shape[2], shape[3], shape[1], shape[0]),
                            _conv_to_torch))
            else:
                out.append((key, prefix + name, shape, _identity))
        elif isinstance(mod, (nn.BatchNorm1d, nn.BatchNorm2d)):
            if name == "num_batches_tracked":
                continue
            flax = {"weight": prefix + "scale", "bias": prefix + "bias",
                    "running_mean": f"batch_stats{SEP}{base}{SEP}mean",
                    "running_var": f"batch_stats{SEP}{base}{SEP}var"}[name]
            out.append((key, flax, shape, _identity))
        elif isinstance(mod, nn.LayerNorm):  # flax's nn.LayerNorm: scale, bias
            out.append((key, prefix + {"weight": "scale", "bias": "bias"}[name], shape,
                        _identity))
        elif isinstance(mod, nn.PReLU):
            out.append((key, prefix + "alpha", shape, _identity))
        elif isinstance(mod, nn.Linear):
            if name == "weight":
                chw = getattr(mod, "flatten_chw", None)
                out.append((key, prefix + "kernel", (shape[1], shape[0]),
                            _flat_dense_to_torch(chw) if chw else _dense_to_torch))
            else:
                out.append((key, prefix + name, shape, _identity))
        else:  # a bare parameter (SCRFD's per-level bbox scales)
            out.append((key, prefix + name, shape, _identity))
    return out


def synthetic_tree(model: nn.Module, seed: int = 0) -> dict:
    """{flax path: leaf} equal to the reference's ``load_or_init`` with no
    pack present, derived from the torch module's structure."""
    return {path: _synthetic_leaf(path, shape, np.float32, seed)
            for _, path, shape, _ in flax_layout(model)}


def from_flax(flat: dict, model: nn.Module) -> dict:
    """{flax path: array} -> torch state dict for ``model``.

    Convs go HWIO -> OIHW; BN scale/bias/mean/var go to weight/bias/
    running_mean/running_var; PReLU slopes keep their shape; the flattened
    Dense rows are permuted NHWC -> NCHW.  A missing leaf or a shape that
    disagrees raises."""
    state = {}
    for key, path, shape, convert in flax_layout(model):
        if path not in flat:
            raise KeyError(f"flax tree has no leaf {path!r} (for {key})")
        leaf = np.asarray(flat[path], np.float32)
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {leaf.shape}, expected {shape}")
        state[key] = torch.from_numpy(np.array(convert(leaf)))
    return state


def unflatten_tree(flat: dict) -> dict:
    """{``/``-joined path: array} -> nested dicts (``flatten_tree``'s inverse)."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split(SEP)
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def load_tree(model: nn.Module, flat: dict) -> nn.Module:
    """Load a flat flax tree into ``model``; returns it in eval mode."""
    result = model.load_state_dict(from_flax(flat, model), strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"weights do not fit the module: {missing}")
    return model.eval()


