"""The synthetic attribute heads written as ONNX graphs.

``head_graph`` turns a float32 ``genderage.GenderAge`` or
``landmark106.Landmark106`` into a ModelProto (``onnxlite.build_model``)
with the shape of buffalo_l's exported heads: an NCHW float32 input of
0..255 pixels (mean 0 / std 1 blobs), the head's own ``preprocess`` as
``Sub``/``Div``, then per stage ``Conv`` (3x3, stride 2, pad 1) +
``BatchNormalization`` + ``PRelu``, ``GlobalAveragePool``, a flatten and
``Gemm``.  The graph computes the module's function, so the exact-graph
executor (``models/onnx_exec.py``) can be held against the module on the
same crops where no published graph is at hand.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from . import onnxlite
from .layers import BN_EPS


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def head_graph(model: nn.Module, input_size: int, batch1_reshape: bool = False) -> bytes:
    """ModelProto bytes of ``model`` exported at batch 1.  With
    ``batch1_reshape`` the flatten is a ``Reshape`` to the export-time target
    [1, -1] (a ``Constant``), which a runner built with ``batch_agnostic``
    rebinds to the live batch; else ``Flatten``."""
    nodes = [("Sub", ["data", "mean"], ["x0"], {}), ("Div", ["x0", "std"], ["h0"], {})]
    inits = {"mean": np.asarray([127.5], np.float32), "std": np.asarray([128.0], np.float32)}
    stages = sorted((name for name, _ in model.named_children() if name.startswith("ConvBNPReLU_")),
                    key=lambda n: int(n.rsplit("_", 1)[1]))
    h = "h0"
    for k, name in enumerate(stages):
        stage = getattr(model, name)
        conv, bn, prelu = stage.ConvBN_0.Conv_0, stage.ConvBN_0.BatchNorm_0, stage.PReLU_0
        p = f"s{k}"
        inits.update({f"{p}_w": _np(conv.weight), f"{p}_scale": _np(bn.weight),
                      f"{p}_bias": _np(bn.bias), f"{p}_mean": _np(bn.running_mean),
                      f"{p}_var": _np(bn.running_var), f"{p}_slope": _np(prelu.weight)})
        nodes += [("Conv", [h, f"{p}_w"], [f"{p}_c"],
                   {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]}),
                  ("BatchNormalization", [f"{p}_c", f"{p}_scale", f"{p}_bias", f"{p}_mean",
                                          f"{p}_var"], [f"{p}_bn"], {"epsilon": BN_EPS}),
                  ("PRelu", [f"{p}_bn", f"{p}_slope"], [f"{p}_out"], {})]
        h = f"{p}_out"
    nodes.append(("GlobalAveragePool", [h], ["pool"], {}))
    if batch1_reshape:
        # a Constant node, as torch's exporter writes one (the reference's
        # jitted attribute program traces initializers, so an initializer
        # target would not stay concrete there)
        nodes += [("Constant", [], ["flat_shape"], {"value": np.asarray([1, -1], np.int64)}),
                  ("Reshape", ["pool", "flat_shape"], ["flat"], {})]
    else:
        nodes.append(("Flatten", ["pool"], ["flat"], {"axis": 1}))
    dense = model.Dense_0
    inits.update({"fc_w": _np(dense.weight), "fc_b": _np(dense.bias)})
    nodes.append(("Gemm", ["flat", "fc_w", "fc_b"], ["fc1"], {"transB": 1}))
    return onnxlite.build_model(nodes, inits, {"data": (1, 3, input_size, input_size)},
                                {"fc1": (1, dense.out_features)})
