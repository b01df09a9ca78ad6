"""ArcFace fine-tuning step, sharded over the device mesh.

The torch form of ``facerecognition_infrenceengine_tpu/engine/training.py``:

- ``arcface_logits``: additive-angular-margin logits (ArcFace, Deng et al.
  2019), the reference's formula (no "easy margin" branch);
- ``make_train_state``: the model's parameters, BatchNorm statistics, a
  ``[C, 512]`` classifier W and SGD momentum (``torch.optim.SGD``,
  momentum 0.9: ``t <- g + 0.9 t``, ``p <- p - lr t``, as ``optax.sgd``);
- ``make_train_step``: one step that returns a new state and leaves the one
  it is given as it was.  BatchNorm runs with flax's train-mode semantics:
  the batch mean and *biased* variance (``E[x^2] - E[x]^2``), running
  statistics ``(1 - m) * running + m * batch`` with torch's momentum ``m``
  (flax's ``1 - momentum``);
- with a mesh: the batch split over ``data``, W row-sharded over
  ``gallery`` with its momentum beside each shard, the softmax
  cross-entropy class-parallel (a per-shard max and sum-exp, combined on
  the data row's first device; the target logit from the shard that owns
  it), and BatchNorm normalising with the statistics of the whole batch:
  each shard's sums go to the first data device and the statistics come
  back, as autograd ops.  The result equals the unsharded step within f32
  rounding, as XLA's SPMD gives the reference global-batch semantics;
- ``save_checkpoint`` / ``restore_checkpoint`` (``torch.save``, written
  under a temporary name then ``os.replace``) and ``fit``.

The mesh step runs the model layer by layer over the list of data shards
from its ``torch.fx`` graph, with each BatchNorm module taking every
shard's statistics; a model that does not trace, or that calls a
functional batch norm, is refused with an error rather than trained with
per-shard statistics.
"""

from __future__ import annotations

import contextlib
import functools
import os
import re
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import metrics
from ..ops.matching import l2_normalize
from ..parallel.sharding import Mesh, RowShards, batch_sharding, gallery_sharding

EMBED_DIM = 512
_STATS = ("running_mean", "running_var")


def _margin_logits(emb_n, w_n, labels, offset: int, margin: float, scale: float):
    """The ArcFace logits of the classes ``offset .. offset + len(w_n)``."""
    cos = emb_n.float() @ w_n.float().T
    cos = torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    classes = torch.arange(offset, offset + w_n.shape[0], device=cos.device)
    onehot = (labels[:, None] == classes[None, :]).to(cos.dtype)
    cos_margin = torch.cos(theta + margin)
    return scale * (onehot * cos_margin + (1.0 - onehot) * cos)


def arcface_logits(embeddings, weight, labels, margin: float = 0.5, scale: float = 64.0):
    """Additive angular margin logits.

    embeddings: [B, D] (unnormalized), weight: [C, D], labels: [B] int.
    Returns [B, C] scaled logits with the margin on the target class."""
    return _margin_logits(l2_normalize(embeddings), l2_normalize(weight), labels.long(), 0,
                          margin, scale)


def _is_bn(mod) -> bool:
    return isinstance(mod, nn.modules.batchnorm._BatchNorm)


def _batch_norm(mod, name: str, xs, ws, bs, stats: dict, new_stats: dict, root):
    """Train-mode BatchNorm over data shards ``xs`` (one tensor a device,
    channels at dim 1) with the statistics of all of them: each shard's sum
    and sum of squares go to ``root``, the mean and biased variance come
    back.  The new running statistics land in ``new_stats``."""
    dims = [0] + list(range(2, xs[0].dim()))
    count = sum(x.numel() // x.shape[1] for x in xs)
    s1 = sum(x.float().sum(dims).to(root) for x in xs)
    s2 = sum((x.float() * x.float()).sum(dims).to(root) for x in xs)
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    m = mod.momentum
    for key, batch in zip(_STATS, (mean, var)):
        old = stats[f"{name}.{key}"]
        new_stats[f"{name}.{key}"] = old * (1.0 - m) + batch.detach().to(old.device) * m
    out = []
    for x, w, b in zip(xs, ws, bs):
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var.to(x.device) + mod.eps) * w
        out.append((x.float() - mean.to(x.device).view(shape)) * mul.view(shape)
                   + b.view(shape))
    return out


def _check_model(model: nn.Module) -> None:
    for name, mod in model.named_modules():
        if _is_bn(mod) and not (mod.affine and mod.track_running_stats and mod.momentum):
            raise ValueError(f"BatchNorm {name}: the step needs affine, running statistics "
                             "and a fixed momentum")


def _stats_of(model: nn.Module) -> dict:
    return {f"{name}.{key}": getattr(mod, key).detach().clone()
            for name, mod in model.named_modules() if _is_bn(mod) for key in _STATS}


def make_train_state(model: nn.Module, num_classes: int, example_input, seed: int = 0,
                     learning_rate: float = 1e-3):
    """The state for fine-tuning ``model``, and its optimizer.

    The model's parameters and BatchNorm statistics are copied as the
    module holds them (a torch module is initialized when it is built:
    load weights into it first to fine-tune them); the classifier W is
    ``randn(num_classes, 512) * 0.01`` from a generator seeded with
    ``seed + 1`` (the reference's key), on the model's device.  The
    example input runs one forward to check that the model embeds in 512
    dimensions.  The optimizer is ``torch.optim.SGD(lr, momentum=0.9)``
    (returned as a factory over parameter lists); its momentum starts at
    zero.

    Returns (state, opt): state = {"params": {"model": {name: tensor},
    "w": W}, "batch_stats": {name: tensor}, "opt_state": {"model": ...,
    "w": ...}} with the momentum shaped as the params."""
    _check_model(model)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    dev = next(iter(params.values())).device
    gen = torch.Generator().manual_seed(seed + 1)
    w = (torch.randn((num_classes, EMBED_DIM), generator=gen) * 0.01).to(dev)
    state = {"params": {"model": params, "w": w}, "batch_stats": _stats_of(model)}
    with torch.no_grad():
        emb, _ = _embed(model, state, _as_tensor(example_input, dev, torch.float32))
    if emb.shape[-1] != EMBED_DIM:
        raise ValueError(f"the model embeds in {emb.shape[-1]} dimensions, W takes "
                         f"{EMBED_DIM}")
    state["opt_state"] = {"model": {k: torch.zeros_like(p) for k, p in params.items()},
                          "w": torch.zeros_like(w)}
    return state, functools.partial(torch.optim.SGD, lr=learning_rate, momentum=0.9)


def _embed(model: nn.Module, state: dict, images, params=None):
    """Train-mode forward of the whole model on one device: every BatchNorm
    module normalises with its batch's statistics (its ``forward`` is
    replaced while the call runs, so a step must not share its module
    object with a thread serving it).  Returns (embeddings, new batch
    statistics)."""
    params = state["params"]["model"] if params is None else params
    stats, new_stats = state["batch_stats"], {}
    bns = [(name, mod) for name, mod in model.named_modules() if _is_bn(mod)]

    def bn_forward(name, mod, x):
        return _batch_norm(mod, name, [x], [mod.weight], [mod.bias], stats, new_stats,
                           x.device)[0]

    for name, mod in bns:
        mod.forward = functools.partial(bn_forward, name, mod)
    try:
        emb = torch.func.functional_call(model, params, (images.float(),))
    finally:
        for _, mod in bns:
            del mod.forward
    return emb, new_stats


def _traced(model: nn.Module):
    """The model's ``torch.fx`` graph, for the layer-by-layer forward over
    data shards; refuses what that forward cannot hold to global batch
    statistics."""
    try:
        gm = torch.fx.symbolic_trace(model)
    except Exception as e:  # fx raises many kinds for untraceable code
        raise ValueError(f"the mesh step runs {type(model).__name__} layer by layer over "
                         f"the data shards (torch.fx) and it does not trace: {e}") from e
    if sum(node.op == "placeholder" for node in gm.graph.nodes) != 1:
        raise ValueError(f"the mesh step runs a model of one input; {type(model).__name__}'s "
                         "forward takes more")
    for node in gm.graph.nodes:
        if node.op == "call_function" and node.target in (F.batch_norm, torch.batch_norm):
            raise ValueError(f"{type(model).__name__} calls a functional batch norm "
                             f"({node.name}): the mesh step cannot give it the whole "
                             "batch's statistics")
    leaf_params = {}
    for node in gm.graph.nodes:
        if node.op == "call_module":
            mod = gm.get_submodule(node.target)
            leaf_params[node.target] = [(local, f"{node.target}.{local}")
                                        for local, _ in mod.named_parameters()]
    return gm, leaf_params


def _apply_leaf(mod: nn.Module, p: dict, x):
    """A leaf module on one shard with the parameters ``p``."""
    if isinstance(mod, nn.Conv2d):
        return mod._conv_forward(x, p["weight"], p.get("bias"))
    if isinstance(mod, nn.Linear):
        return F.linear(x, p["weight"], p.get("bias"))
    if isinstance(mod, nn.PReLU):
        return F.prelu(x, p["weight"])
    return torch.func.functional_call(mod, p, (x,))


def _forward_shards(traced, params_on: dict, xs: list, stats: dict, new_stats: dict, root):
    """Run the traced graph over the data shards ``xs`` (one tensor a
    device): every op a shard on its device, every BatchNorm across all of
    them.  ``params_on[device]`` holds the model's parameters there."""
    gm, leaf_params = traced
    devs = [x.device for x in xs]
    env = {}

    def args_of(node, i):
        return (torch.fx.node.map_arg(node.args, lambda n: env[n][i]),
                torch.fx.node.map_arg(node.kwargs, lambda n: env[n][i]))

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = xs
        elif node.op == "get_attr":
            env[node] = [params_on[d].get(node.target) for d in devs]
            if env[node][0] is None:  # a buffer or constant of the module
                env[node] = [getattr(gm, node.target).to(d) for d in devs]
        elif node.op == "call_module":
            mod = gm.get_submodule(node.target)
            names = leaf_params[node.target]
            if _is_bn(mod):
                ins = [args_of(node, i)[0][0] for i in range(len(xs))]
                env[node] = _batch_norm(mod, node.target, ins,
                                        [params_on[d][f"{node.target}.weight"] for d in devs],
                                        [params_on[d][f"{node.target}.bias"] for d in devs],
                                        stats, new_stats, root)
            else:
                env[node] = [_apply_leaf(mod, {local: params_on[d][full] for local, full in names},
                                         args_of(node, i)[0][0])
                             for i, d in enumerate(devs)]
        elif node.op == "call_function":
            env[node] = [node.target(*a, **k) for a, k in (args_of(node, i)
                                                          for i in range(len(xs)))]
        elif node.op == "call_method":
            env[node] = [getattr(a[0], node.target)(*a[1:], **k)
                         for a, k in (args_of(node, i) for i in range(len(xs)))]
        elif node.op == "output":
            return [torch.fx.node.map_arg(node.args[0], lambda n: env[n][i])
                    for i in range(len(xs))]
    raise ValueError("the traced graph has no output")


def _sharded_loss(traced, mesh: Mesh, params_on: dict, xs: list, ys: list, w_leaves: list,
                  offsets: list, stats: dict, new_stats: dict, margin: float, scale: float):
    """The mean ArcFace cross-entropy over data shards ``xs`` / ``ys`` and
    W shards ``w_leaves``: logits block (i, j) on device (i, j), the
    softmax class-parallel -- the blocks' row maxima, their shifted
    sum-exps and the target logit (from the block that holds the label),
    combined on data row i's first device; the rows' sums on the mesh's
    first device."""
    root = mesh.devices[0, 0]
    embs = _forward_shards(traced, params_on, xs, stats, new_stats, root)
    w_n = [l2_normalize(w) for w in w_leaves]
    total = 0.0
    for i, (emb, y) in enumerate(zip(embs, ys)):
        head = mesh.devices[i, 0]
        e_n = l2_normalize(emb)
        blocks = []
        for j, (w, off) in enumerate(zip(w_n, offsets)):
            d = mesh.devices[i, j]
            blocks.append((d, off, _margin_logits(e_n.to(d), w.to(d), y.to(d), off, margin,
                                                  scale)))
        top = torch.stack([b.max(dim=1).values.detach().to(head) for _, _, b in blocks])
        top = top.max(dim=0).values
        sums = sum(torch.exp(b - top.to(d)[:, None]).sum(dim=1).to(head) for d, _, b in blocks)
        target = sum(torch.where(y.to(d)[:, None] - off == torch.arange(b.shape[1], device=d),
                                 b, 0.0).sum(dim=1).to(head)
                     for d, off, b in blocks)
        total = total + (torch.log(sums) + top - target).sum().to(root)
    return total / sum(int(y.shape[0]) for y in ys)


def _sgd(opt, leaves: list, grads: list, momenta: list):
    """One ``opt`` (SGD) update of fresh ``leaves`` from their momenta;
    returns the new momenta.  The leaves are updated in place: they are
    the step's own copies."""
    sgd = opt(leaves)
    for p, g, m in zip(leaves, grads, momenta):
        p.grad = g
        sgd.state[p]["momentum_buffer"] = m.clone()
    sgd.step()
    new_m = [sgd.state[p]["momentum_buffer"] for p in leaves]
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return new_m


def _conv_backend(devices):
    """No oneDNN for a step with a CPU shard: its CPU weight gradient of a
    strided 1x1 convolution on a channels-last input (IResNet's shortcut;
    the NHWC input's permute makes every activation channels-last)
    segfaults in torch 2.13 at batches of 3 to 6."""
    if any(torch.device(d).type == "cpu" for d in devices):
        return torch.backends.mkldnn.flags(enabled=False)
    return contextlib.nullcontext()


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(True)


def _as_tensor(x, device, dtype):
    """A tensor of ``dtype`` on ``device`` (None: where it already is)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(dtype=dtype) if device is None else t.to(device, dtype)


def make_train_step(model: nn.Module, opt, mesh: Mesh | None = None, margin: float = 0.5,
                    scale: float = 64.0) -> Callable:
    """``step(state, images, labels) -> (new state, loss)``: one SGD step on
    the mean ArcFace cross-entropy, leaving ``state`` as it was.

    With a mesh: images and labels split over ``data``; W row-sharded over
    ``gallery`` (``step.shard_state(state)`` places a state: the model's
    parameters, statistics and momentum on the mesh's first device, W and
    its momentum as ``RowShards``; the step places an unplaced state
    itself).  Logits block (i, j) -- data shard i against W shard j -- is
    computed on device (i, j)."""
    _check_model(model)

    @metrics.on_device
    def step(state, images, labels):
        params = state["params"]
        dev = params["w"].device
        names = list(params["model"])
        leaves = [_leaf(params["model"][k]) for k in names] + [_leaf(params["w"])]
        x = _as_tensor(images, dev, torch.float32)
        y = _as_tensor(labels, dev, torch.long)
        with _conv_backend([dev]):
            emb, new_stats = _embed(model, state, x, dict(zip(names, leaves[:-1])))
            logits = arcface_logits(emb, leaves[-1], y, margin, scale)
            loss = F.cross_entropy(logits, y)
            grads = torch.autograd.grad(loss, leaves)
        opt_state = state["opt_state"]
        momenta = _sgd(opt, leaves, list(grads),
                       [opt_state["model"][k] for k in names] + [opt_state["w"]])
        new_state = {
            "params": {"model": dict(zip(names, leaves[:-1])), "w": leaves[-1]},
            "batch_stats": new_stats,
            "opt_state": {"model": dict(zip(names, momenta[:-1])), "w": momenta[-1]},
        }
        return new_state, loss.detach()

    if mesh is None:
        return step

    traced = _traced(model)
    root = mesh.devices[0, 0]
    rows = batch_sharding(mesh)
    w_place = gallery_sharding(mesh)

    def shard_state(state):
        """Place a state: W and its momentum as row shards over the gallery
        axis, everything else on the mesh's first device."""
        def on_root(tree):
            return {k: on_root(v) if isinstance(v, dict) else v.to(root)
                    for k, v in tree.items()}

        def rows_of(t):
            return w_place.put(t.gather() if isinstance(t, RowShards) else t)

        return {"params": {"model": on_root(state["params"]["model"]),
                           "w": rows_of(state["params"]["w"])},
                "batch_stats": on_root(state["batch_stats"]),
                "opt_state": {"model": on_root(state["opt_state"]["model"]),
                              "w": rows_of(state["opt_state"]["w"])}}

    @metrics.on_device
    def sharded_step(state, images, labels):
        if not isinstance(state["params"]["w"], RowShards):
            state = shard_state(state)
        params = state["params"]
        names = list(params["model"])
        model_leaves = [_leaf(params["model"][k]) for k in names]
        w_shards = params["w"]
        w_leaves = [_leaf(p) for p in w_shards.parts]
        xs = rows.put(_as_tensor(images, None, torch.float32)).parts
        ys = rows.put(_as_tensor(labels, None, torch.long)).parts
        params_on = {}
        for d in dict.fromkeys(x.device for x in xs):
            params_on[d] = {k: leaf if d == root else leaf.to(d)
                            for k, leaf in zip(names, model_leaves)}
        new_stats = {}
        with _conv_backend(params_on):
            loss = _sharded_loss(traced, mesh, params_on, xs, ys, w_leaves, w_shards.offsets,
                                 state["batch_stats"], new_stats, margin, scale)
            grads = torch.autograd.grad(loss, model_leaves + w_leaves)
        opt_state = state["opt_state"]
        momenta = _sgd(opt, model_leaves + w_leaves, list(grads),
                       [opt_state["model"][k] for k in names] + opt_state["w"].parts)
        n = len(names)
        new_state = {
            "params": {"model": dict(zip(names, model_leaves)), "w": RowShards(w_leaves)},
            "batch_stats": new_stats,
            "opt_state": {"model": dict(zip(names, momenta[:n])), "w": RowShards(momenta[n:])},
        }
        return new_state, loss.detach()

    sharded_step.shard_state = shard_state
    return sharded_step


# --------------------------------------------------------------- fine-tune loop
_CKPT = re.compile(r"step_(\d{8})")


def _to_host(tree):
    """Every tensor on the CPU; row shards gathered whole."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, RowShards):
        return tree.gather("cpu")
    return tree.detach().cpu()


def _like(loaded, target):
    """``loaded`` placed as ``target`` is: each tensor on its target's
    device, row shards split as the target's."""
    if isinstance(target, dict):
        if set(loaded) != set(target):
            raise KeyError(f"checkpoint keys {sorted(loaded)} != state keys {sorted(target)}")
        return {k: _like(loaded[k], target[k]) for k in target}
    if isinstance(target, RowShards):
        sizes = [int(p.shape[0]) for p in target.parts]
        return RowShards(p.to(d) for p, d in zip(torch.split(loaded, sizes), target.devices))
    return loaded.to(target.device)


def save_checkpoint(ckpt_dir: str, state: dict, step: int) -> str:
    """Write ``state`` (every tensor on the CPU, row shards whole) as
    ``<ckpt_dir>/step_%08d`` with ``torch.save``: a temporary name, then
    ``os.replace``, so a reader never sees a partial file."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_host(state), tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: str, target: dict | None = None) -> tuple[dict, int] | None:
    """Load the latest checkpoint under ``ckpt_dir`` (None when absent).

    With ``target`` (a live state of the same structure, fresh from
    ``make_train_state`` or a step) each tensor goes where the target's is,
    row shards included; without one everything stays on the CPU (pass
    the result through ``step.shard_state`` when resuming a mesh run).
    Returns (state, step)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted((int(m.group(1)), name) for name in os.listdir(ckpt_dir)
                   if (m := _CKPT.fullmatch(name)))
    if not steps:
        return None
    step, name = steps[-1]
    state = torch.load(os.path.join(ckpt_dir, name), map_location="cpu", weights_only=True)
    if target is not None:
        state = _like(state, target)
    return state, step


def fit(step_fn: Callable, state: dict, batches, *, ckpt_dir: str | None = None,
        ckpt_every: int = 100, log_every: int = 10, logger: Callable[[str], None] = print,
        start_step: int = 0):
    """Drive ``step_fn`` over an iterable of (images, labels) batches.

    Resumable: with ``ckpt_dir`` set, checkpoints land every ``ckpt_every``
    steps and once more at the end; ``restore_checkpoint`` + ``start_step``
    continue a run.  Returns (state, losses)."""
    losses = []
    step_no = start_step
    for images, labels in batches:
        state, loss = step_fn(state, images, labels)
        step_no += 1
        losses.append(float(loss))
        if log_every and step_no % log_every == 0:
            logger(f"step {step_no}: loss {losses[-1]:.4f}")
        if ckpt_dir and step_no % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state, step_no)
    if ckpt_dir and step_no > start_step and step_no % ckpt_every != 0:
        save_checkpoint(ckpt_dir, state, step_no)
    return state, losses
