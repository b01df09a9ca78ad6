"""Convert an insightface buffalo_l ONNX pack into the port's ``.npz`` packs.

    python -m facerecognition_infrenceengine_tpu_torch.models.convert_onnx \
        --pack ~/.insightface/models/buffalo_l [--out DIR]

The port's copy of ``tools/convert_onnx.py``, with no JAX: the graphs are
read by ``models/onnxlite.py`` (no ``onnx`` package), the template trees
are ``weights.synthetic_tree`` of the port's own modules (equal, leaf for
leaf, to the reference's ``load_or_init`` template), and the attribute
graphs are sanity-run by ``models/onnx_exec.OnnxRunner`` on the CPU.  It
writes the files the reference's tool writes: ``scrfd_det_10g.npz``,
``arcface_r50.npz`` and ``arcface_mobilefacenet.npz`` (flax trees, ``/``-
joined keys, float32) and the attribute graphs copied as they are, into
``--out`` (default: ``weights.weights_dir()``, i.e. ``FRE_WEIGHTS_DIR``),
where ``weights.load_or_init`` picks them up.

Layers map by execution order, not by name: each model's
``layer_execution_order()`` lists its layers in torch trace order, and the
converter walks the graph's nodes (topologically sorted by the export)
popping per-kind queues.  Every assignment is shape-checked; a mismatch or
a layer left over raises, and nothing is written unless every model of the
pack converted.  Layouts: ONNX conv kernels OIHW -> flax HWIO; Gemm/MatMul
[out, in] -> [in, out], with the rows after an NCHW flatten permuted to
NHWC (``dense_flatten``); BatchNormalization's (scale, B, mean, var) ->
params scale/bias + batch_stats mean/var; PRelu slopes -> [C]; SCRFD's
shared head re-traced a level is skipped by initializer name, and its
per-level bbox Scale exports as 1-element Mul constants.
"""

from __future__ import annotations

import argparse
import os
import shutil
from collections import deque

import numpy as np

from . import arcface, mobilefacenet, onnx_exec, onnxlite, scrfd
from .weights import save_variables, synthetic_tree, unflatten_tree, weights_dir

# (onnx file, npz name, module factory, layer order, NCHW shape at the flatten)
JOBS = [
    ("det_10g.onnx", "scrfd_det_10g", lambda: scrfd.SCRFD(scrfd.CONFIGS["det_10g"]),
     lambda: scrfd.layer_execution_order(scrfd.CONFIGS["det_10g"]), None),
    ("w600k_r50.onnx", "arcface_r50", arcface.iresnet50,
     lambda: arcface.layer_execution_order((3, 4, 14, 3)), (512, 7, 7)),
    ("w600k_mbf.onnx", "arcface_mobilefacenet", mobilefacenet.mobilefacenet,
     mobilefacenet.layer_execution_order, None),
]

# The attribute heads have no published architecture: the graph itself is
# the converted artifact, run exactly by models/onnx_exec.py.
ATTRIBUTE_GRAPHS = [
    ("genderage.onnx", "attr_genderage.onnx"),
    ("2d106det.onnx", "attr_2d106det.onnx"),
    ("1k3d68.onnx", "attr_1k3d68.onnx"),  # buffalo_l's 3D-68 head
]


def load_onnx_graph(path: str):
    """(initializers {name: array}, [(op_type, inputs, outputs, attrs)]).

    Trivial shape ops whose inputs are all initializers (Unsqueeze, Squeeze,
    Reshape, Identity, Transpose) and Constant nodes are folded into the
    initializers: an exporter that skips ONNX-level constant folding wraps
    e.g. PReLU slopes in an Unsqueeze, which would otherwise hide the
    parameter from the execution-order walk."""
    g = onnxlite.load(path)
    inits = {name: t.to_numpy() for name, t in g.initializers.items()}
    nodes = []
    for n in g.nodes:
        ins = list(n.inputs)
        if n.op_type == "Constant" and len(n.outputs) == 1 and "value" in n.attrs:
            inits[n.outputs[0]] = np.asarray(n.attrs["value"])
            continue
        if (n.op_type in ("Unsqueeze", "Squeeze", "Reshape", "Identity", "Transpose")
                and ins and len(n.outputs) == 1 and all(i in inits for i in ins)):
            arr = inits[ins[0]]
            if n.op_type == "Transpose":  # bias-free Linear: Transpose(weight) + MatMul
                perm = n.attrs.get("perm")
                arr = np.transpose(arr, perm and [int(p) for p in perm])
            axes = n.attrs.get("axes")
            if axes is None and len(ins) > 1:  # opset >= 13: axes as an input
                axes = [int(a) for a in np.asarray(inits[ins[1]]).reshape(-1)]
            if n.op_type == "Unsqueeze":
                for ax in sorted(int(a) for a in axes or ()):
                    arr = np.expand_dims(arr, ax)
            elif n.op_type == "Squeeze":
                arr = np.squeeze(arr, tuple(int(a) for a in axes)) if axes else np.squeeze(arr)
            elif n.op_type == "Reshape":
                arr = arr.reshape([int(d) for d in np.asarray(inits[ins[1]]).reshape(-1)])
            inits[n.outputs[0]] = arr
            continue
        nodes.append((n.op_type, ins, list(n.outputs), dict(n.attrs)))
    return inits, nodes


def _conv_to_flax(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO (depthwise too)


def _expand_order(order: list) -> list:
    """layer_execution_order entries -> [(kind, path, ...)] queue items, the
    path holding the leaves directly (``convbn`` splits into its Conv_0
    and BatchNorm_0)."""
    out = []
    for entry in order:
        kind, path = entry[0], entry[1]
        if kind == "convbn":
            out.append(("conv", f"{path}/Conv_0"))
            out.append(("bn", f"{path}/BatchNorm_0"))
        elif kind in ("conv", "bn", "prelu", "dense", "dense_flatten", "scale"):
            out.append((kind, path) + tuple(entry[2:]))
        else:
            raise ValueError(f"unknown execution-order kind {kind!r}")
    return out


def _check_assign(out: dict, key: str, val: np.ndarray) -> None:
    if key not in out:
        raise ValueError(f"flax tree has no leaf {key}")
    if tuple(out[key].shape) != tuple(val.shape):
        raise ValueError(f"{key}: flax {out[key].shape} vs onnx {val.shape}")
    out[key] = np.asarray(val, out[key].dtype)


def assign_by_execution_order(flat_flax: dict, order: list, nodes: list, inits: dict,
                              flatten_chw=None) -> dict:
    """Map the graph's initializers onto the flat flax tree in trace order."""
    queues: dict = {}
    for item in _expand_order(order):
        queues.setdefault(item[0], deque()).append(item[1:])
    out = dict(flat_flax)
    consumed: set = set()

    def stats_path(bn_path: str) -> str:
        if not bn_path.startswith("params/"):
            raise ValueError(f"BatchNorm path outside params: {bn_path}")
        return "batch_stats/" + bn_path[len("params/"):]

    for op_type, ins, _outs, attrs in nodes:
        params = [name for name in ins if name in inits]
        if not params:
            continue
        if op_type == "Conv":
            if params[0] in consumed:
                continue  # the shared head re-traced
            if not queues.get("conv"):
                raise ValueError("more ONNX Convs than expected by the model's execution order")
            (path,) = queues["conv"].popleft()
            _check_assign(out, f"{path}/kernel", _conv_to_flax(inits[params[0]]))
            if len(params) > 1:
                bias_key = f"{path}/bias"
                if bias_key not in out:
                    raise ValueError(
                        f"ONNX Conv for {path} carries a bias but the flax conv is bias-free "
                        "- the export looks BN-folded; convert from the unfolded insightface "
                        "release instead")
                _check_assign(out, bias_key, inits[params[1]])
            consumed.update(params)
        elif op_type == "BatchNormalization":
            if params[0] in consumed:
                continue
            if not queues.get("bn"):
                raise ValueError("more ONNX BatchNorms than expected")
            (path,) = queues["bn"].popleft()
            scale, bias, mean, var = (inits[p] for p in params[:4])
            _check_assign(out, f"{path}/scale", scale)
            _check_assign(out, f"{path}/bias", bias)
            _check_assign(out, f"{stats_path(path)}/mean", mean)
            _check_assign(out, f"{stats_path(path)}/var", var)
            consumed.update(params)
        elif op_type == "PRelu":
            if params[0] in consumed:
                continue
            if not queues.get("prelu"):
                raise ValueError("more ONNX PRelus than expected")
            (path,) = queues["prelu"].popleft()
            key = f"{path}/alpha"
            if key not in out:
                raise ValueError(f"flax tree has no leaf {key}")
            _check_assign(out, key, inits[params[0]].reshape(out[key].shape))
            consumed.update(params)
        elif op_type in ("Gemm", "MatMul"):
            if params[0] in consumed:
                continue
            kind = "dense_flatten" if queues.get("dense_flatten") else "dense"
            if not queues.get(kind):
                raise ValueError("more ONNX Gemm/MatMuls than expected")
            path = queues[kind].popleft()[0]
            w = inits[params[0]]
            key = f"{path}/kernel"
            if key not in out:
                raise ValueError(f"flax tree has no leaf {key}")
            if kind == "dense_flatten":
                # torch flattens NCHW channel-major, flax NHWC spatial-major:
                # permute the input rows C*H*W -> H*W*C
                if flatten_chw is None:
                    raise ValueError("dense_flatten entry needs flatten_chw")
                c, h, wd = flatten_chw
                n_out = w.shape[0] if w.shape[1] == c * h * wd else w.shape[1]
                w = (w.reshape(n_out, c, h, wd) if w.shape[0] == n_out
                     else w.T.reshape(n_out, c, h, wd))
                w = np.transpose(w, (2, 3, 1, 0)).reshape(h * wd * c, n_out)
            elif op_type == "Gemm":
                # transB=1 (torch's Linear export) carries [out, in]; transB=0
                # [in, out].  A square weight's shape cannot tell them apart.
                if int(attrs.get("transB") or 0):
                    w = w.T
                elif tuple(w.shape) != tuple(out[key].shape):
                    w = w.T
            elif tuple(w.shape) != tuple(out[key].shape):
                w = w.T  # MatMul carries [in, out] already
            _check_assign(out, key, w)
            if len(params) > 1:
                bias_key = f"{path}/bias"
                if bias_key in out:
                    _check_assign(out, bias_key, inits[params[1]])
            consumed.update(params)
        elif op_type == "Mul":
            # the per-level bbox Scale modules: 1-element constants
            if (len(params) == 1 and inits[params[0]].size == 1 and queues.get("scale")
                    and params[0] not in consumed):
                (path,) = queues["scale"].popleft()
                if path not in out:
                    raise ValueError(f"flax tree has no leaf {path}")
                _check_assign(out, path, inits[params[0]].reshape(out[path].shape))
                consumed.add(params[0])

    leftovers = {k: len(q) for k, q in queues.items() if q}
    if leftovers:
        raise ValueError(f"unmapped flax layers remain: {leftovers} - the ONNX graph has "
                         "fewer layers than the flax model")
    return out


def _write_npz(dst: str, variables: dict) -> None:
    tmp = dst + ".tmp.npz"  # np.savez appends .npz to a name without it
    save_variables(tmp, variables)
    os.replace(tmp, dst)


def convert(pack_dir: str, out_dir: str) -> dict:
    """Convert every model of the pack found in ``pack_dir`` into
    ``out_dir``; returns {npz or graph name: tensors written}.  Every model
    is mapped (and every attribute graph run) before anything is written."""
    mapped = []
    for onnx_name, npz_name, factory, order, flatten_chw in JOBS:
        src = os.path.join(pack_dir, onnx_name)
        if not os.path.exists(src):
            print(f"skip {onnx_name}: not found in {pack_dir}")
            continue
        inits, nodes = load_onnx_graph(src)
        flat = assign_by_execution_order(synthetic_tree(factory(), seed=0), order(), nodes,
                                         inits, flatten_chw=flatten_chw)
        mapped.append((npz_name, flat))
    graphs = check_attribute_graphs(pack_dir)
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for npz_name, flat in mapped:
        dst = os.path.join(out_dir, f"{npz_name}.npz")
        _write_npz(dst, unflatten_tree(flat))
        written[npz_name] = len(flat)
        print(f"wrote {dst} ({len(flat)} tensors)")
    written.update(install_attribute_graphs(pack_dir, out_dir, graphs))
    return written


def check_attribute_graphs(pack_dir: str) -> list:
    """Parse and run each attribute graph of the pack on a zero blob (CPU);
    returns [(source name, destination name, initializer count)]."""
    found = []
    for src_name, dst_name in ATTRIBUTE_GRAPHS:
        src = os.path.join(pack_dir, src_name)
        if not os.path.exists(src):
            print(f"skip {src_name}: not found in {pack_dir}")
            continue
        g = onnxlite.load(src)
        runner = onnx_exec.OnnxRunner(g, device="cpu")
        in_name, in_shape = g.graph_inputs()[0]
        shape = (1,) + tuple(96 if d <= 0 else d for d in in_shape)[1:]  # free batch -> 1
        outs = runner(np.zeros(shape, np.float32))
        print(f"{src_name}: {len(g.nodes)} nodes, census {runner.param_census()} params, "
              f"input {in_name}{shape}, outputs {[tuple(o.shape) for o in outs]}")
        found.append((src_name, dst_name, len(g.initializers)))
    return found


def install_attribute_graphs(pack_dir: str, out_dir: str, graphs: list) -> dict:
    written = {}
    for src_name, dst_name, n_init in graphs:
        dst = os.path.join(out_dir, dst_name)
        shutil.copyfile(os.path.join(pack_dir, src_name), dst)
        written[dst_name] = n_init
        print(f"wrote {dst} (exact graph, executed by models/onnx_exec.py)")
    return written


def convert_attribute_graphs(pack_dir: str, out_dir: str) -> dict:
    """Sanity-run and install the pack's attribute graphs alone."""
    graphs = check_attribute_graphs(pack_dir)
    os.makedirs(out_dir, exist_ok=True)
    return install_attribute_graphs(pack_dir, out_dir, graphs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pack", required=True, help="buffalo_l directory holding the .onnx files")
    ap.add_argument("--out", default=None,
                    help="weights dir (default: FRE_WEIGHTS_DIR, else models/_weights)")
    args = ap.parse_args(argv)
    convert(args.pack, args.out or weights_dir())


if __name__ == "__main__":
    main()
