"""Execute an ONNX graph as an eager PyTorch program, graph-exact by
construction.

The torch form of ``facerecognition_infrenceengine_tpu/models/onnx_exec.py``:
the buffalo_l attribute heads (genderage.onnx, 2d106det.onnx) have no
published architecture, so the engine runs the graph in the file itself,
parsed by ``models/onnxlite.py`` (no ``onnx`` package), node by node.

Design notes:
- Shape plumbing (Shape -> Gather -> Concat -> Reshape chains) stays
  numpy, as in the reference: an op whose inputs are all constants (numpy
  arrays, Python scalars, integer initializers) computes in numpy, so
  reshape targets are concrete.  ``Shape`` itself returns numpy.
- Float initializers become float32 tensors on the runner's device once;
  graph inputs are moved there at each call.  Every other operand is a
  tensor on that device, and the graph runs in float32.
- Conv, Gemm and MatMul go to ``F.conv*d`` / ``torch.matmul`` (cuDNN and
  cuBLAS on the card, TF32 off: ``core.device.resolve_device``); the
  reference leaves them to XLA.  Each other op follows the reference's
  function, not ONNX's text where the two differ: ``Resize`` is
  ``jax.image.resize`` (half-pixel centres, antialiased when linear or
  cubic shrinks), pools pad explicitly (``MaxPool`` with -inf), and
  ``BatchNormalization`` is ``(x - mean) * (scale * rsqrt(var + eps)) +
  bias``.
- ``batch_agnostic`` rewrites export-time batch-1 reshape targets so the
  graph serves any leading batch (the engine batches the attribute heads
  over all detected faces).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from . import onnxlite


def _is_const(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _np(x) -> np.ndarray:
    """A constant operand (shape plumbing, attributes) as numpy, wherever it
    lives."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _t(x, device) -> torch.Tensor:
    """An operand as a tensor on ``device``; numpy float64 becomes float32 (the
    reference runs with 64-bit types off), Python scalars 0-d tensors (which
    do not promote a tensor's dtype within its kind)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _tensors(*args):
    dev = _device(args)
    return [None if a is None else _t(a, dev) for a in args]


def _torch_dtype(npdtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, npdtype)).dtype


def _on_tensors(fn):
    def op(*args):
        return fn(*_tensors(*args))

    return staticmethod(op)


class _Torch:
    """The numpy functions the ops call, on tensors (the reference's ``jnp``)."""

    add = _on_tensors(torch.add)
    subtract = _on_tensors(torch.sub)
    multiply = _on_tensors(torch.mul)
    divide = _on_tensors(torch.div)
    power = _on_tensors(torch.pow)
    matmul = _on_tensors(torch.matmul)
    maximum = _on_tensors(torch.maximum)
    minimum = _on_tensors(torch.minimum)
    equal = _on_tensors(torch.eq)
    greater = _on_tensors(torch.gt)
    less = _on_tensors(torch.lt)
    exp = _on_tensors(torch.exp)
    sqrt = _on_tensors(torch.sqrt)
    tanh = _on_tensors(torch.tanh)
    abs = _on_tensors(torch.abs)

    @staticmethod
    def where(c, a, b):
        c, a, b = _tensors(c, a, b)
        return torch.where(c.bool(), a, b)

    @staticmethod
    def reshape(x, shape):
        return _t(x, _device([x])).reshape(shape)

    @staticmethod
    def transpose(x, perm=None):
        x = _t(x, _device([x]))
        return x.permute(*(perm if perm is not None else range(x.ndim - 1, -1, -1)))

    @staticmethod
    def concatenate(xs, axis=0):
        return torch.cat(_tensors(*xs), dim=axis)

    @staticmethod
    def take(x, idx, axis=0):
        x, idx = _tensors(x, idx)
        axis %= x.ndim
        n = x.shape[axis]
        flat = idx.reshape(-1).long()
        flat = torch.where(flat < 0, flat + n, flat)
        out = torch.index_select(x, axis, flat)
        return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])

    @staticmethod
    def broadcast_to(x, shape):
        return torch.broadcast_to(_t(x, _device([x])), shape)

    @staticmethod
    def tile(x, reps):
        return torch.tile(_t(x, _device([x])), reps)

    @staticmethod
    def expand_dims(x, axis):
        return torch.unsqueeze(_t(x, _device([x])), axis)

    @staticmethod
    def squeeze(x, axis=None):
        x = _t(x, _device([x]))
        return torch.squeeze(x) if axis is None else torch.squeeze(x, tuple(axis))

    @staticmethod
    def split(x, sections, axis=0):
        return torch.tensor_split(_t(x, _device([x])), sections, dim=axis)

    @staticmethod
    def _reduce(fn, x, axis=None, keepdims=False):
        x = _t(x, _device([x]))
        dims = tuple(range(x.ndim)) if axis is None else axis
        return fn(x, dim=dims, keepdim=keepdims)

    @staticmethod
    def mean(x, axis=None, keepdims=False):
        return _Torch._reduce(torch.mean, x, axis, keepdims)

    @staticmethod
    def sum(x, axis=None, keepdims=False):
        return _Torch._reduce(torch.sum, x, axis, keepdims)

    @staticmethod
    def max(x, axis=None, keepdims=False):
        return _Torch._reduce(torch.amax, x, axis, keepdims)


def _xp(*args):
    """numpy when every operand is concrete (shape plumbing stays numpy),
    torch otherwise."""
    return np if all(_is_const(a) for a in args if a is not None) else _Torch


def _conv_pads(attrs, spatial: int) -> list:
    pads = attrs.get("pads")
    if pads is None:
        auto = attrs.get("auto_pad", "NOTSET")
        if auto in ("NOTSET", "VALID", ""):
            return [(0, 0)] * spatial
        raise ValueError(f"auto_pad={auto} not supported (buffalo_l exports "
                         "use explicit pads)")
    return [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]


def _pad_spatial(x: torch.Tensor, pads: list, value: float = 0.0) -> torch.Tensor:
    """Explicit (begin, end) padding of the trailing spatial dims."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


# --------------------------------------------------------------- operators
# Each op: fn(node, inputs) -> list of outputs.  `inputs` may mix numpy
# (constants) and tensors.

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _op_conv(node, ins):
    x, w = _tensors(ins[0], ins[1])
    b = ins[2] if len(ins) > 2 else None
    spatial = w.ndim - 2
    strides = [int(s) for s in node.attrs.get("strides", [1] * spatial)]
    dilations = [int(d) for d in node.attrs.get("dilations", [1] * spatial)]
    groups = int(node.attrs.get("group", 1))
    pads = _conv_pads(node.attrs, spatial)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        x, padding = _pad_spatial(x, pads), 0
    out = _CONV[spatial](x, w, None, strides, padding, dilations, groups)
    if b is not None:
        out = out + _t(b, out.device).reshape((1, -1) + (1,) * spatial)
    return [out]


def _op_batchnorm(node, ins):
    x, scale, bias, mean, var = _tensors(*ins[:5])
    eps = node.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(var + eps)
    return [(x - mean.reshape(shape)) * (scale * inv).reshape(shape)
            + bias.reshape(shape)]


def _op_gemm(node, ins):
    a, b = _tensors(ins[0], ins[1])
    if node.attrs.get("transA", 0):
        a = a.T
    if node.attrs.get("transB", 0):
        b = b.T
    out = node.attrs.get("alpha", 1.0) * (a @ b)
    if len(ins) > 2 and ins[2] is not None:
        out = out + node.attrs.get("beta", 1.0) * _t(ins[2], out.device)
    return [out]


def _op_prelu(node, ins):
    x, slope = _tensors(*ins)
    if slope.ndim and slope.ndim < x.ndim:
        # onnx unidirectional broadcast: align slope's leading dim to C
        slope = slope.reshape((1,) + tuple(slope.shape)
                              + (1,) * (x.ndim - slope.ndim - 1))
    return [torch.where(x > 0, x, slope * x)]


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(x, ks, strides):
    """Sum over each pooling window (no padding; the caller padded)."""
    if x.ndim == 3:  # avg_pool1d has no divisor_override
        return F.avg_pool1d(x, ks, strides) * float(ks[0])
    return _AVG_POOL[x.ndim - 2](x, ks, strides, divisor_override=1)


def _pool(node, ins, is_avg):
    """reduce_window with explicit padding, as the reference: MaxPool pads
    with -inf; AveragePool sums the zero-padded window and divides by the
    kernel size (``count_include_pad``) or by the in-bounds count."""
    x = _t(ins[0], _device(ins))
    spatial = x.ndim - 2
    ks = [int(k) for k in node.attrs["kernel_shape"]]
    strides = [int(s) for s in node.attrs.get("strides", [1] * spatial)]
    pads = _conv_pads(node.attrs, spatial)
    if node.attrs.get("ceil_mode", 0):
        # extend end-padding so the last (partial) window is included
        pads = list(pads)
        for i in range(spatial):
            size = x.shape[2 + i] + pads[i][0] + pads[i][1]
            rem = (size - ks[i]) % strides[i]
            if rem:
                pads[i] = (pads[i][0], pads[i][1] + strides[i] - rem)
    if not is_avg:
        return [_MAX_POOL[spatial](_pad_spatial(x, pads, float("-inf")), ks, strides)]
    out = _window_sum(_pad_spatial(x, pads), ks, strides)
    if node.attrs.get("count_include_pad", 0):
        return [out / float(np.prod(ks))]
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    return [out / _window_sum(_pad_spatial(ones, pads), ks, strides)]


def _op_slice(node, ins):
    x = ins[0]
    if len(ins) > 1:  # opset >= 10: starts/ends/axes/steps are inputs
        starts = _np(ins[1]).tolist()
        ends = _np(ins[2]).tolist()
        axes = (_np(ins[3]).tolist() if len(ins) > 3
                and ins[3] is not None else list(range(len(starts))))
        steps = (_np(ins[4]).tolist() if len(ins) > 4
                 and ins[4] is not None else [1] * len(starts))
    else:
        starts = list(node.attrs["starts"])
        ends = list(node.attrs["ends"])
        axes = list(node.attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    ndim = len(_shape(x))
    sl = [slice(None)] * ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        # onnx clamps out-of-range ends (INT64_MAX is idiomatic)
        en = None if en >= (1 << 62) else int(en)
        sl[int(ax)] = slice(int(st), en, int(sp))
    if _is_const(x):
        return [x[tuple(sl)]]
    for ax, s in enumerate(sl):  # torch slicing takes no negative step
        if s.step is not None and s.step < 0:
            idx = np.arange(x.shape[ax])[s].copy()
            x = torch.index_select(x, ax, torch.from_numpy(idx).to(x.device))
            sl[ax] = slice(None)
    return [x[tuple(sl)]]


def _op_reshape(node, ins, batch_agnostic):
    x, target = ins[0], _np(ins[1]).astype(np.int64).copy()
    shape = _shape(x)
    # onnx: 0 copies the input dim
    for i, v in enumerate(target):
        if v == 0:
            target[i] = shape[i]
    if (batch_agnostic and len(target) >= 2
            and target[0] not in (-1, shape[0])):
        # export-time batch literal that doesn't match the live batch:
        # rebind it
        target[0] = shape[0] if -1 in target[1:] else -1
    return [_xp(x).reshape(x, tuple(int(v) for v in target))]


# jax.image.resize's kernels (jax/_src/image/scale.py), over float32 numpy
def _triangle_kernel(x):
    return np.maximum(np.float32(0), 1 - np.abs(x))


def _keys_cubic_kernel(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., 0., out).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """[in, out] float32 weights of ``jax.image.resize`` along one dim (scale
    out/in, no translation, antialiased: the kernel widens by in/out when
    shrinking)."""
    kernel = _triangle_kernel if method == "bilinear" else _keys_cubic_kernel
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(inv_scale)
                - np.float32(0.0) - 0.5).astype(np.float32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = kernel(x.astype(np.float32)).astype(np.float32)
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def _op_resize(node, ins):
    x = _t(ins[0], _device(ins))
    # inputs: X, roi, scales, sizes
    sizes = ins[3] if len(ins) > 3 and ins[3] is not None else None
    scales = ins[2] if len(ins) > 2 and ins[2] is not None else None
    if sizes is not None and np.size(_np(sizes)):
        out_shape = tuple(int(v) for v in _np(sizes))
    else:
        sc = _np(scales).astype(np.float64)
        out_shape = tuple(int(round(d * s)) for d, s in zip(x.shape, sc))
    mode = node.attrs.get("mode", "nearest")
    method = {"nearest": "nearest", "linear": "bilinear",
              "cubic": "bicubic"}[mode]
    for d, (m, n) in enumerate(zip(x.shape, out_shape)):
        if m == n:
            continue
        if method == "nearest":
            offsets = np.floor((np.arange(n, dtype=np.float32) + 0.5) * m / n).astype(np.int64)
            x = torch.index_select(x, d, torch.from_numpy(offsets).to(x.device))
        else:
            w = torch.from_numpy(_resize_weights(m, n, method)).to(x.device, x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return [x]


def _elementwise(fn):
    def op(node, ins):
        xp = _xp(*ins)
        return [fn(xp, *ins)]

    return op


def _reduce(fname):
    def op(node, ins):
        x = ins[0]
        xp = _xp(x)
        axes = node.attrs.get("axes")
        if axes is None and len(ins) > 1 and ins[1] is not None:
            axes = _np(ins[1]).tolist()
        axes = tuple(int(a) for a in axes) if axes is not None else None
        keep = bool(node.attrs.get("keepdims", 1))
        return [getattr(xp, fname)(x, axis=axes, keepdims=keep)]

    return op


def _op_clip(node, ins):
    x = ins[0]
    lo = node.attrs.get("min")
    hi = node.attrs.get("max")
    if len(ins) > 1 and ins[1] is not None:
        lo = ins[1]
    if len(ins) > 2 and ins[2] is not None:
        hi = ins[2]
    xp = _xp(x)
    if lo is not None:
        x = xp.maximum(x, lo)
    if hi is not None:
        x = xp.minimum(x, hi)
    return [x]


def _axes_arg(node, ins, idx=1):
    axes = node.attrs.get("axes")
    if axes is None and len(ins) > idx and ins[idx] is not None:
        axes = _np(ins[idx]).tolist()
    return axes


def _op_softmax(node, ins):
    x = _t(ins[0], _device(ins))
    return [torch.softmax(x, dim=int(node.attrs.get("axis", -1)))]


def _np_erf(x):
    from math import erf

    return np.vectorize(erf)(np.asarray(x, np.float64)).astype(np.float32)


def _op_leaky(node, ins):
    x = ins[0]
    alpha = node.attrs.get("alpha", 0.01)
    xp = _xp(x)
    return [xp.where(x > 0, x, alpha * x)]


def _op_cast(node, ins):
    dtype = onnxlite.DTYPES[int(node.attrs["to"])]
    if _is_const(ins[0]):
        return [np.asarray(ins[0]).astype(dtype)]
    return [_t(ins[0], _device(ins)).to(_torch_dtype(dtype))]


_OPS = {
    "Conv": _op_conv,
    "BatchNormalization": _op_batchnorm,
    "Gemm": _op_gemm,
    "MatMul": _elementwise(lambda xp, a, b: xp.matmul(a, b)),
    "PRelu": _op_prelu,
    "Relu": _elementwise(lambda xp, x: xp.maximum(x, 0)),
    "LeakyRelu": _op_leaky,
    "Sigmoid": _elementwise(lambda xp, x: 1.0 / (1.0 + xp.exp(-x))),
    "Tanh": _elementwise(lambda xp, x: xp.tanh(x)),
    "Softmax": _op_softmax,
    "Exp": _elementwise(lambda xp, x: xp.exp(x)),
    "Sqrt": _elementwise(lambda xp, x: xp.sqrt(x)),
    "Reciprocal": _elementwise(lambda xp, x: 1.0 / x),
    "Neg": _elementwise(lambda xp, x: -x),
    "Abs": _elementwise(lambda xp, x: xp.abs(x)),
    "Erf": _elementwise(lambda xp, x: _np_erf(x) if xp is np else torch.erf(x)),
    "Add": _elementwise(lambda xp, a, b: xp.add(a, b)),
    "Sub": _elementwise(lambda xp, a, b: xp.subtract(a, b)),
    "Mul": _elementwise(lambda xp, a, b: xp.multiply(a, b)),
    "Div": _elementwise(lambda xp, a, b: xp.divide(a, b)),
    "Pow": _elementwise(lambda xp, a, b: xp.power(a, b)),
    "Min": _elementwise(lambda xp, *a: functools.reduce(xp.minimum, a)),
    "Max": _elementwise(lambda xp, *a: functools.reduce(xp.maximum, a)),
    "Where": _elementwise(lambda xp, c, a, b: xp.where(c, a, b)),
    "Equal": _elementwise(lambda xp, a, b: xp.equal(a, b)),
    "Greater": _elementwise(lambda xp, a, b: xp.greater(a, b)),
    "Less": _elementwise(lambda xp, a, b: xp.less(a, b)),
    "Clip": _op_clip,
    "ReduceMean": _reduce("mean"),
    "ReduceSum": _reduce("sum"),
    "ReduceMax": _reduce("max"),
    "Slice": _op_slice,
    "Resize": _op_resize,
    "Identity": lambda n, ins: [ins[0]],
    "Dropout": lambda n, ins: [ins[0]],
    "GlobalAveragePool": lambda n, ins: [
        _Torch.mean(ins[0], axis=tuple(range(2, len(_shape(ins[0])))), keepdims=True)],
    "MaxPool": lambda n, ins: _pool(n, ins, False),
    "AveragePool": lambda n, ins: _pool(n, ins, True),
    "Flatten": lambda n, ins: [
        _xp(ins[0]).reshape(ins[0], (int(np.prod(_shape(ins[0])[:n.attrs.get("axis", 1)]))
                                     or 1, -1))],
    "Transpose": lambda n, ins: [_xp(ins[0]).transpose(ins[0], n.attrs.get("perm"))],
    "Concat": lambda n, ins: [_xp(*ins).concatenate(ins, axis=int(n.attrs["axis"]))],
    "Gather": lambda n, ins: [
        _xp(ins[0]).take(ins[0], np.asarray(ins[1]).astype(np.int64)
                         if _is_const(ins[1]) else ins[1],
                         axis=int(n.attrs.get("axis", 0)))],
    "Shape": lambda n, ins: [np.asarray(_shape(ins[0]), np.int64)],
    "Size": lambda n, ins: [np.asarray(int(np.prod(_shape(ins[0]))), np.int64)],
    "Cast": _op_cast,
    "Constant": lambda n, ins: [
        n.attrs.get("value") if n.attrs.get("value") is not None
        else np.asarray(n.attrs.get("value_float", n.attrs.get("value_int")))],
    "ConstantOfShape": lambda n, ins: [
        np.full(tuple(int(v) for v in _np(ins[0])),
                n.attrs["value"].reshape(()) if "value" in n.attrs else 0.0)],
    "Expand": lambda n, ins: [
        _xp(ins[0]).broadcast_to(
            ins[0], np.broadcast_shapes(_shape(ins[0]), tuple(int(v) for v in _np(ins[1]))))],
    "Range": lambda n, ins: [
        np.arange(_np(ins[0]).item(), _np(ins[1]).item(), _np(ins[2]).item())],
    "Tile": lambda n, ins: [_xp(ins[0]).tile(ins[0], tuple(int(v) for v in _np(ins[1])))],
}


def _op_unsqueeze(node, ins):
    x = ins[0]
    axes = _axes_arg(node, ins)
    xp = _xp(x)
    for ax in sorted(int(a) for a in axes):
        x = xp.expand_dims(x, ax)
    return [x]


def _op_squeeze(node, ins):
    x = ins[0]
    axes = _axes_arg(node, ins)
    xp = _xp(x)
    if axes is None:
        return [xp.squeeze(x)]
    return [xp.squeeze(x, axis=tuple(int(a) for a in axes))]


def _op_split(node, ins):
    x = ins[0]
    axis = int(node.attrs.get("axis", 0))
    sizes = node.attrs.get("split")
    if sizes is None and len(ins) > 1 and ins[1] is not None:
        sizes = _np(ins[1]).tolist()
    xp = _xp(x)
    if sizes is None:
        k = len(node.outputs)
        return list(xp.split(x, k, axis=axis))
    offsets = np.cumsum(sizes)[:-1].tolist()
    return list(xp.split(x, offsets, axis=axis))


_OPS["Unsqueeze"] = _op_unsqueeze
_OPS["Squeeze"] = _op_squeeze
_OPS["Split"] = _op_split


class OnnxRunner:
    """Eager executor for one parsed ONNX graph on one device (default
    ``cuda``).

    >>> runner = OnnxRunner(onnxlite.load("genderage.onnx"), device="cpu")
    >>> out = runner(blob)[0]   # the exact graph
    """

    def __init__(self, graph: onnxlite.Graph, batch_agnostic: bool = True, device=None):
        self.graph = graph
        self.batch_agnostic = batch_agnostic
        self.device = resolve_device(device)
        self.input_names = [n for n, _ in graph.graph_inputs()]
        self.input_shapes = {n: s for n, s in graph.graph_inputs()}
        self.output_names = [n for n, _ in graph.outputs]
        # float initializers as float32 tensors on the device, uploaded
        # once; integer ones (reshape targets, axes) stay numpy constants
        self.params = {}
        for name, t in graph.initializers.items():
            arr = t.to_numpy()
            self.params[name] = (torch.from_numpy(np.array(arr, np.float32))
                                 .to(self.device) if arr.dtype.kind == "f" else arr)

    def _dispatch(self, node, ins):
        if node.op_type == "Reshape":
            return _op_reshape(node, ins, self.batch_agnostic)
        fn = _OPS.get(node.op_type)
        if fn is None:
            raise ValueError(
                f"onnx op '{node.op_type}' (node '{node.name}') is not in "
                "models/onnx_exec.py's op set; add it there (one torch "
                "mapping) to run this graph")
        return fn(node, ins)

    def _input(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return _t(x, self.device)

    @torch.inference_mode()
    def apply(self, params: dict, *inputs) -> tuple:
        """Graph outputs of (initializers, graph inputs).  Pass ``self.params``
        (or converted values of the same names); inputs (numpy or tensors)
        are moved to the runner's device."""
        env: dict = dict(params)
        env.update(zip(self.input_names, (self._input(x) for x in inputs)))
        for node in self.graph.nodes:
            ins = [env[i] if i else None for i in node.inputs]
            outs = self._dispatch(node, ins)
            env.update((name, val) for name, val in zip(node.outputs, outs)
                       if name)
        return tuple(env[o] for o in self.output_names)

    def __call__(self, *inputs):
        return self.apply(self.params, *inputs)

    def param_census(self) -> int:
        """Total weight scalar count: the initializer census to pin against
        the published model files."""
        return int(sum(int(np.prod(v.shape)) for v in self.params.values()))
