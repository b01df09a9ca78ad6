"""Model weight I/O: the reference's flax trees, carried into torch modules.

Weights live as flat ``<FRE_WEIGHTS_DIR>/<name>.npz`` files of the flax
param/batch-stats tree (``/``-joined keys), the format the reference
package saves and loads (``facerecognition_infrenceengine_tpu/models/
weights.py``).  With no pack present, ``load_or_init`` fills every leaf
with the reference's deterministic synthetic values, so both packages hold
identical weights without either one running the other.

The flax leaf paths come from the torch modules themselves: every
submodule is named after its flax counterpart (``Conv_0``, ``BatchNorm_0``,
``layer1_b0``, ...), so a state-dict key maps to a flax path by swapping
``.`` for ``/`` and renaming the parameter by layer type.  ``to_flax`` is
the inverse of ``from_flax``; ``train_state_from_flax`` /
``train_state_to_flax`` carry a training state (params, BatchNorm
statistics, SGD momentum) between the reference's trees and
``engine/training.py``'s layout.  ``save_variables`` / ``load_variables``
write and read the nested trees as the reference's do, which is how
``models/convert_onnx.py`` writes a converted pack.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch
from torch import nn

SEP = "/"


def weights_dir() -> str:
    return os.environ.get("FRE_WEIGHTS_DIR",
                          os.path.join(os.path.dirname(__file__), "_weights"))


def flatten_shapes(tree, prefix: str = "") -> dict:
    """Nested dicts -> {``/``-joined path: leaf}, the leaves as they are
    (shapes, arrays or tensors)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten_shapes(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    return out


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested flax variables (dicts of arrays) -> {``/``-joined path: numpy
    array}, the ``.npz`` key form."""
    return {k: np.asarray(v) for k, v in flatten_shapes(tree, prefix).items()}


def save_variables(path: str, variables: dict) -> None:
    """Write a nested tree of arrays as one ``.npz`` of ``/``-joined keys."""
    np.savez(path, **flatten_tree(variables))


def load_variables(path: str) -> dict:
    """``.npz`` -> the nested tree of numpy arrays (``save_variables``'s
    inverse)."""
    return unflatten_tree(load_flat(path))


def load_flat(path: str) -> dict:
    """``.npz`` flax tree -> {flax path: numpy array}."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


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


def to_flax(state: dict, model: nn.Module) -> dict:
    """Torch tensors {state-dict key: tensor} of ``model`` -> {flax path:
    numpy float32 array}, the inverse of ``from_flax``: OIHW -> HWIO, the
    flattened Dense's rows NCHW -> NHWC (``flatten_chw``).  Converts the
    keys given (a parameter-only dict, such as a momentum tree, gives the
    ``params`` leaves only); a key the layout lacks raises."""
    layout = {key: (path, convert) for key, path, _, convert in flax_layout(model)}
    unknown = set(state) - set(layout)
    if unknown:
        raise KeyError(f"not in the flax layout of the module: {sorted(unknown)}")
    return {layout[key][0]: layout[key][1].inverse(
                t.detach().cpu().numpy().astype(np.float32, copy=False))
            for key, t in state.items()}


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


def _torch_leaves(flat: dict, model: nn.Module, keys) -> dict:
    out = {}
    for key, path, shape, convert in flax_layout(model):
        if key in keys:
            leaf = np.asarray(flat[path], np.float32)
            if tuple(leaf.shape) != tuple(shape):
                raise ValueError(f"{path}: shape {leaf.shape}, expected {shape}")
            out[key] = torch.from_numpy(np.array(convert(leaf)))
    return out


def train_state_from_flax(params: dict, batch_stats: dict, momentum: dict,
                          model: nn.Module) -> dict:
    """The reference's training state -> ``engine/training.py``'s.

    params: {"model": flax params tree, "w": [C, 512]}; batch_stats: the
    flax batch-stats tree; momentum: the SGD trace (``optax.sgd``'s
    ``TraceState.trace``), shaped as params.  The momentum of a converted
    leaf is converted as the leaf is (the flattened Dense's rows permuted,
    conv kernels transposed)."""
    pkeys = {k for k, _ in model.named_parameters()}
    skeys = {k for k, _ in model.named_buffers() if k.endswith(("running_mean", "running_var"))}
    flat = flatten_tree({"params": params["model"], "batch_stats": batch_stats})
    mflat = flatten_tree({"params": momentum["model"]})
    return {
        "params": {"model": _torch_leaves(flat, model, pkeys),
                   "w": torch.from_numpy(np.array(params["w"], np.float32))},
        "batch_stats": _torch_leaves(flat, model, skeys),
        "opt_state": {"model": _torch_leaves(mflat, model, pkeys),
                      "w": torch.from_numpy(np.array(momentum["w"], np.float32))},
    }


def train_state_to_flax(state: dict, model: nn.Module) -> tuple:
    """``engine/training.py``'s state -> the reference's (params,
    batch_stats, momentum) nested trees of numpy arrays (row-sharded W and
    momentum gathered whole)."""
    def whole(t):
        from ..parallel.sharding import RowShards

        t = t.gather("cpu") if isinstance(t, RowShards) else t
        return t.detach().cpu().numpy()

    p = unflatten_tree(to_flax(state["params"]["model"], model))["params"]
    stats = unflatten_tree(to_flax(state["batch_stats"], model))["batch_stats"]
    m = unflatten_tree(to_flax(state["opt_state"]["model"], model))["params"]
    return ({"model": p, "w": whole(state["params"]["w"])}, stats,
            {"model": m, "w": whole(state["opt_state"]["w"])})


def load_tree(model: nn.Module, flat: dict) -> nn.Module:
    """Load a flat flax tree into ``model``; returns it in eval mode."""
    result = model.load_state_dict(from_flax(flat, model), strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"weights do not fit the module: {missing}")
    return model.eval()


def load_or_init(name: str, model: nn.Module, seed: int = 0) -> nn.Module:
    """Load ``<weights_dir>/<name>.npz`` into ``model`` if present, else the
    deterministic synthetic weights; returns ``model`` in eval mode."""
    path = os.path.join(weights_dir(), f"{name}.npz")
    return load_tree(model, load_flat(path) if os.path.exists(path)
                     else synthetic_tree(model, seed))
