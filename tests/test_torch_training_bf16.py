"""bf16 mixed-precision fine-tuning in the port (``engine/training.py`` over
``models/arcface.IResNet(dtype=...)`` and ``models/mobilefacenet``) against
the reference's flax models built with ``dtype=jnp.bfloat16``, on the CPU.

Both packages keep float32 parameters, BatchNorm statistics and momentum
and compute in bf16.  The port rounds where flax's program rounds: the
input, every conv and Dense operand, every BatchNorm output, PReLU and the
residual add in bf16; BatchNorm statistics and normalisation in float32.
Compiled with its defaults on the CPU, XLA keeps a conv's and the Dense's
output in float32 into the BatchNorm that follows (the compiled HLO has no
bf16 convert there: excess precision), so the oracle for the rounding
points is the reference's bf16 step compiled with
``xla_allow_excess_precision`` off, where every rounding flax writes
happens.

Past the first layers a bf16 step is chaotic at the level of its own
rounding error: XLA's float32 BatchNorm sums differ from torch's in the
last bits (a relative 6e-6 in ``E[x^2]`` here), which flips a few bf16
roundings of the first BatchNorm, and the flips spread.  So the port's
step is held to lie no farther from the reference's bf16 step than that
step lies from the reference's float32 step, on the batch's per-example
losses, the gradient (the momentum after one step from zero), the
params' update and the batch statistics (relative L2 over all leaves).
The step's mean loss alone is one draw of that noise and is printed, not
compared.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from facerecognition_infrenceengine_tpu.engine import training as ref_training
from facerecognition_infrenceengine_tpu.models import arcface as ref_arcface
from facerecognition_infrenceengine_tpu.models import mobilefacenet as ref_mobilefacenet
from facerecognition_infrenceengine_tpu.models.weights import unflatten_tree
from facerecognition_infrenceengine_tpu_torch.engine import training
from facerecognition_infrenceengine_tpu_torch.models import arcface, layers, mobilefacenet, weights
from facerecognition_infrenceengine_tpu_torch.models.layers import cast_keep_bn_f32
from facerecognition_infrenceengine_tpu_torch.parallel import build_mesh
from test_torch_bf16 import _trained_tree

BF16 = torch.bfloat16
SIDE, CLASSES, BATCH, LR = 32, 64, 32, 0.1
MFN_STAGES = ((2, 8, 2, 2), (2, 16, 1, 2), (2, 16, 1, 2))
COS_BUDGET = 1e-3  # BASELINE.md: embeddings within 1e-3 cosine of the reference
REF_TX = optax.sgd(LR, momentum=0.9)  # the optimizer the reference's make_train_state builds


def _models(kind, jdtype, tdtype):
    """(flax model, torch model) of ``kind`` at the test's size."""
    if kind == "iresnet":
        return (ref_arcface.IResNet(depths=(1, 1, 1, 1), widths=(8, 8, 16, 16), dtype=jdtype),
                arcface.IResNet(depths=(1, 1, 1, 1), widths=(8, 8, 16, 16), input_size=SIDE,
                                dtype=tdtype))
    return (ref_mobilefacenet.MobileFaceNet(stages=MFN_STAGES, dtype=jdtype),
            mobilefacenet.MobileFaceNet(stages=MFN_STAGES, input_size=SIDE, dtype=tdtype))


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, SIDE, SIDE, 3)).astype(np.float32),
            rng.integers(0, CLASSES, n).astype(np.int32))


def _port(kind, tdtype=BF16):
    """A port model of ``tdtype`` (torch's seeded init) with its state, and
    the reference's state carried from it by ``train_state_to_flax``
    (momentum ``REF_TX.init``, zero as the port's; flax's eager init would
    take ~15 s); returns (ref state, ref tx,
    torch model, port state, port opt)."""
    torch.manual_seed(0)
    _, tm = _models(kind, jnp.float32, tdtype)
    state, opt = training.make_train_state(tm, CLASSES, np.zeros((2, SIDE, SIDE, 3), np.float32),
                                           learning_rate=LR)
    params, stats, _ = weights.train_state_to_flax(state, tm)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    ref_state = {"params": params, "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats),
                 "opt_state": REF_TX.init(params)}
    return ref_state, REF_TX, tm, state, opt


def _rel(got: dict, want: dict) -> float:
    """||got - want|| / ||want||, L2 over all leaves."""
    assert set(got) == set(want), set(got) ^ set(want)
    num = sum(float(((np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)) ** 2)
                    .sum()) for k in want)
    den = sum(float((np.asarray(want[k], np.float64) ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def _flat32(tree) -> dict:
    flat = weights.flatten_tree(jax.device_get(tree))
    assert all(np.asarray(v).dtype == np.float32 for v in flat.values())
    return flat


def _parts(params, stats, mom, start):
    """{"update", "batch_stats", "gradient"} flat dicts of a state after one
    step from ``start`` (zero momentum: the momentum is the gradient)."""
    p = _flat32(params)
    return {"update": {k: np.asarray(v) - start[k] for k, v in p.items()},
            "batch_stats": _flat32(stats), "gradient": _flat32(mom)}


def _ref_losses(fm, state, x, y):
    """The reference's per-example ArcFace losses (train-mode forward)."""
    emb, _ = fm.apply({"params": state["params"]["model"], "batch_stats": state["batch_stats"]},
                      x, train=True, mutable=["batch_stats"])
    logits = ref_training.arcface_logits(emb, state["params"]["w"], y)
    return optax.softmax_cross_entropy_with_integer_labels(logits, y)


def _every_rounding(jitted, *args):
    """``jitted(*args)`` compiled with XLA's excess precision off: every
    bf16 rounding the program writes happens."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _port_losses(tm, state, x, y):
    """The port's per-example losses, from the forward its step runs."""
    with torch.no_grad(), training._conv_backend(["cpu"]):
        emb, _ = training._embed(tm, state, torch.from_numpy(x))
        logits = training.arcface_logits(emb, state["params"]["w"], torch.from_numpy(y).long())
        return F.cross_entropy(logits, torch.from_numpy(y).long(), reduction="none").numpy()


def _vec(a, b):
    return float(np.linalg.norm(np.float64(a) - b) / np.linalg.norm(np.float64(b)))


# ------------------------------------------------------------- one bf16 step
def _distances(kind, seed: int, batch: int = BATCH) -> dict:
    """One bf16 step of the port and of the reference (every rounding) and
    the port's f32 step from one state on batch ``seed``: {name: (port to
    reference bf16, reference bf16 to f32)} for the per-example losses,
    the gradient, the update and the batch statistics (relative L2), plus
    the mean losses under "mean"."""
    ref_state, tx, tm, state, opt = _port(kind)
    _, _, tm32, state32, opt32 = _port(kind, torch.float32)
    assert all(torch.equal(state["params"]["model"][k], v)
               for k, v in state32["params"]["model"].items())
    fmbf, _ = _models(kind, jnp.bfloat16, BF16)
    x, y = _batch(seed, batch)
    start = _flat32(ref_state["params"])

    new, loss = training.make_train_step(tm, opt)(state, x, y)
    for part in ("params", "opt_state"):
        assert {t.dtype for t in new[part]["model"].values()} == {torch.float32}
        assert new[part]["w"].dtype == torch.float32
    assert {t.dtype for t in new["batch_stats"].values()} == {torch.float32}
    port = _parts(*weights.train_state_to_flax(new, tm), start)
    new32, loss32 = training.make_train_step(tm32, opt32)(state32, x, y)
    f32 = _parts(*weights.train_state_to_flax(new32, tm32), start)

    args = (ref_state, jnp.asarray(x), jnp.asarray(y))
    sbf, lbf = _every_rounding(ref_training.make_train_step(fmbf, tx), *args)
    ref_bf = _parts(sbf["params"], sbf["batch_stats"], sbf["opt_state"][0].trace, start)
    losses_bf = np.asarray(_every_rounding(jax.jit(functools.partial(_ref_losses, fmbf)), *args))
    losses = _port_losses(tm, state, x, y)
    np.testing.assert_allclose(float(loss), losses.mean(), rtol=1e-6)
    got = {"losses": (_vec(losses, losses_bf), _vec(losses_bf, _port_losses(tm32, state32, x, y)))}
    for name in ref_bf:
        got[name] = (_rel(port[name], ref_bf[name]), _rel(ref_bf[name], f32[name]))
    got["mean"] = (float(loss), float(lbf), float(loss32))
    # the step is bf16, not float32 in disguise
    assert _rel(port["gradient"], f32["gradient"]) > 1e-3
    return got


@pytest.mark.parametrize("kind", ["iresnet", "mobilefacenet"])
def test_bf16_step_lies_within_the_references_bf16_error(kind):
    """One bf16 step from one state (the port's seeded init, carried
    across), B = 32 at 32x32, 64 classes, lr 0.1.  The port's params,
    batch statistics and momentum stay float32; its per-example losses,
    gradient, update and batch statistics lie no farther from the
    reference's bf16 step (every rounding) than that step lies from the
    f32 step (the port's, which tests/test_torch_training.py holds to the
    reference's within f32 rounding).

    Over 8 batches at B = 32 and 4 at B = 64 for each model (``PYTHONPATH=.
    python tests/test_torch_training_bf16.py``; an x86 CPU, torch 2.13,
    jax 0.9) the ratio of the two distances was 0.48-0.83 for the gradient,
    the update and the batch statistics, but 0.56-1.08 for the per-example
    losses: on the losses the port lies about as far from the reference's
    bf16 step as that step lies from f32, and one draw of the 24 (iresnet,
    B = 64) put it farther.  This batch gives 0.96 for iresnet's losses."""
    got = _distances(kind, 1)
    print(f"{kind}: (port to reference bf16, reference bf16 to f32) {got}")
    mean = got.pop("mean")
    assert np.isfinite(mean).all()
    for name, (port_to_ref, ref_to_f32) in got.items():
        assert port_to_ref <= ref_to_f32, (name, port_to_ref, ref_to_f32)


def test_bf16_eval_forward_holds_the_cosine_budget():
    """``IResNet(dtype=torch.bfloat16)`` (float32 parameters) against flax
    ``IResNet(dtype=bfloat16)`` on one tree: max 1 - cos <= 1e-3; and bit
    for bit the serving engine's module (the float32 module cast by
    ``cast_keep_bn_f32``; tests/test_torch_bf16.py holds that one at r18
    and r50)."""
    fm, f32 = _models("iresnet", jnp.bfloat16, torch.float32)
    stats_crops = np.random.default_rng(3).integers(0, 256, (16, SIDE, SIDE, 3), dtype=np.uint8)
    flat = _trained_tree(f32, 3, arcface.preprocess(torch.from_numpy(stats_crops)))
    weights.load_tree(f32, flat)
    tm = _models("iresnet", jnp.bfloat16, BF16)[1]
    weights.load_tree(tm, flat)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    crops = np.random.default_rng(4).integers(0, 256, (8, SIDE, SIDE, 3), dtype=np.uint8)
    x = arcface.preprocess(torch.from_numpy(crops))
    want = np.asarray(jax.jit(fm.apply)(unflatten_tree(flat),
                                        ref_arcface.preprocess(jnp.asarray(crops))))
    with torch.no_grad():
        got = tm(x)
        served = cast_keep_bn_f32(f32, "cpu", BF16)(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, served)
    got = got.numpy()
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
    print(f"IResNet bf16 eval forward: max 1-cos {float((1 - cos).max()):.3e}")
    assert float((1.0 - cos).max()) <= COS_BUDGET


# ------------------------------------------------------------ the mesh step
def test_bf16_mesh_step_matches_unsharded():
    """The bf16 mesh step on 2 x 4 CPU shards (every BatchNorm on the whole
    batch's float32 statistics) against the unsharded bf16 step from one
    state: the loss within 1e-3 relative, the gradient (the momentum after
    the step) no farther than the unsharded bf16 step lies from the f32
    step (relative L2): on this batch 2.3% against 3.1%.  A fixed 1e-2
    would hold the rounding, not the sharding: the unsharded bf16 step on
    a batch permuted moves by 0.2-1.3% over batches, and BatchNorm on one
    shard's statistics (tried in a throwaway copy) by ~45%.  The mesh
    state stays float32."""
    _, _, tm, state, opt = _port("iresnet")
    _, _, tm32, state32, opt32 = _port("iresnet", torch.float32)
    x, y = _batch(5, 16)
    new, loss = training.make_train_step(tm, opt)(state, x, y)
    new32, _ = training.make_train_step(tm32, opt32)(state32, x, y)
    mstep = training.make_train_step(tm, opt, mesh=build_mesh(["cpu"] * 8, data=2, gallery=4))
    mnew, mloss = mstep(state, x, y)

    def grad(s, m):
        return weights.flatten_tree(weights.train_state_to_flax(s, m)[2])

    mesh_err, bf16_err = _rel(grad(mnew, tm), grad(new, tm)), _rel(grad(new, tm), grad(new32, tm32))
    print(f"bf16 mesh step: loss {abs(float(mloss) - float(loss)) / abs(float(loss)):.2e} apart, "
          f"gradient {mesh_err:.4f} (the bf16 step from f32: {bf16_err:.4f})")
    assert abs(float(mloss) - float(loss)) <= 1e-3 * abs(float(loss))
    assert mesh_err <= bf16_err
    assert {t.dtype for t in mnew["params"]["model"].values()} == {torch.float32}
    assert {p.dtype for p in mnew["params"]["w"].parts} == {torch.float32}


# -------------------------------------------- the cast model and the default
def test_a_model_cast_to_bf16_is_refused():
    """A model whose parameters were cast (the serving engine's
    ``cast_keep_bn_f32``) gets a ValueError naming the ``dtype=``
    constructor argument, from the state and from the step."""
    tm = cast_keep_bn_f32(arcface.IResNet(depths=(1, 1, 1, 1), widths=(8, 8, 16, 16),
                                          input_size=SIDE), "cpu", BF16)
    with pytest.raises(ValueError, match=r"dtype= constructor argument"):
        training.make_train_state(tm, CLASSES, np.zeros((2, SIDE, SIDE, 3), np.float32))
    opt = _port("iresnet")[4]
    with pytest.raises(ValueError, match=r"Conv_0.weight is torch.bfloat16"):
        training.make_train_step(tm, opt)


@contextlib.contextmanager
def _torch_layers():
    """``models/layers``' Conv2d, Linear and PReLU running torch's own
    forwards."""
    saved = {cls: cls.forward for cls in (layers.Conv2d, layers.Linear, layers.PReLU)}
    for cls in saved:
        cls.forward = cls.__mro__[1].forward
    try:
        yield
    finally:
        for cls, fwd in saved.items():
            cls.forward = fwd


@pytest.mark.parametrize("build", [arcface.iresnet50, mobilefacenet.mobilefacenet],
                         ids=["iresnet50", "mobilefacenet"])
def test_the_float32_default_is_unchanged(build):
    """``build()`` and ``build(dtype=torch.float32)`` give bit-equal
    forwards, equal to the same modules on torch's own conv, Dense and
    PReLU; so does the serving engine's bf16 cast of them."""
    torch.manual_seed(0)
    a = build().eval()
    b = build(dtype=torch.float32).eval()
    b.load_state_dict(a.state_dict())
    x = torch.randn(2, 112, 112, 3)
    with torch.no_grad():
        ya, yb = a(x), b(x)
        served = cast_keep_bn_f32(b, "cpu", BF16)(x)
        with _torch_layers():
            plain, plain_served = a(x), b(x)
    assert torch.equal(ya, yb) and torch.equal(ya, plain)
    assert torch.equal(served, plain_served)


# ------------------------------------------------------------- checkpoints
def test_bf16_checkpoint_round_trip_and_resume_are_bit_exact(tmp_path):
    """A bf16 model's state: its checkpoint restores bit for bit, a run
    resumed from it equals the uninterrupted run bit for bit, and the flax
    carry-over keeps float32 leaves under the f32 model's keys."""
    _, _, tm, state, opt = _port("iresnet")
    step = training.make_train_step(tm, opt)
    batches = [_batch(20 + i, 16) for i in range(4)]
    whole, l_whole = training.fit(step, state, batches, log_every=0)
    ckpt = str(tmp_path / "ckpt")
    mid, _ = training.fit(step, state, batches[:2], ckpt_dir=ckpt, log_every=0)
    back, at = training.restore_checkpoint(ckpt, target=state)
    assert at == 2
    flat = weights.flatten_tree(training._to_host(back))
    assert all(v.dtype == np.float32 for v in flat.values())
    want = weights.flatten_tree(training._to_host(mid))
    assert set(flat) == set(want) and all(np.array_equal(flat[k], want[k]) for k in want)
    resumed, l_res = training.fit(step, back, batches[2:], log_every=0, start_step=at)
    assert l_res == l_whole[2:]
    got, want = (weights.flatten_tree(training._to_host(s)) for s in (resumed, whole))
    assert all(np.array_equal(got[k], want[k]) for k in want)
    trees = weights.train_state_to_flax(whole, tm)
    f32_keys = weights.train_state_to_flax(_port("iresnet", torch.float32)[3],
                                           _models("iresnet", jnp.float32, torch.float32)[1])
    for tree, ref in zip(trees, f32_keys):
        flat_t = weights.flatten_tree(tree)
        assert set(flat_t) == set(weights.flatten_tree(ref))
        assert all(np.asarray(v).dtype == np.float32 for v in flat_t.values())
    again, want = (weights.flatten_tree(training._to_host(s))
                   for s in (weights.train_state_from_flax(*trees, tm), whole))
    assert set(again) == set(want) and all(np.array_equal(again[k], want[k]) for k in want)


def _r50_reference_spread() -> None:
    """The reference's own IResNet-50 bf16 step against its f32 step and
    against itself on the batch permuted (B = 16 at 112x112, 93,431
    classes, lr 1e-3, crops of 8 seeded prototypes): how far bf16
    rounding alone moves the gradient through 24 blocks."""
    f32, bf = ref_arcface.iresnet50(), ref_arcface.iresnet50(dtype=jnp.bfloat16)
    state, tx = ref_training.make_train_state(f32, 93_431, jnp.zeros((2, 112, 112, 3)),
                                              learning_rate=1e-3)
    rng = np.random.default_rng(0)
    protos = rng.normal(size=(8, 112, 112, 3)).astype(np.float32)
    labels = rng.integers(0, 8, 16)
    x = protos[labels] + 0.1 * rng.normal(size=(16, 112, 112, 3)).astype(np.float32)
    y = labels.astype(np.int32)
    perm = rng.permutation(16)
    out = {}
    for name, model, order in (("f32", f32, None), ("bf16", bf, None), ("bf16 permuted", bf, perm),
                               ("f32 permuted", f32, perm)):
        xs, ys = (x, y) if order is None else (x[order], y[order])
        new, loss = ref_training.make_train_step(model, tx)(state, xs, ys)
        out[name] = (float(loss), _flat32(new["opt_state"][0].trace))
    w = [k for k in out["f32"][1] if k.startswith("w")]

    def rel(a, b, keys=None):
        keys = keys or sorted(out[b][1])
        return _rel({k: out[a][1][k] for k in keys}, {k: out[b][1][k] for k in keys})

    model = [k for k in out["f32"][1] if k not in w]
    print(f"reference IResNet-50, B = 16, 93,431 classes: loss bf16 to f32 "
          f"{abs(out['bf16'][0] - out['f32'][0]) / out['f32'][0]:.2e}; gradient bf16 to f32 "
          f"{rel('bf16', 'f32'):.4f} (W {rel('bf16', 'f32', w):.4f}, model "
          f"{rel('bf16', 'f32', model):.4f}); bf16 permuted to bf16 "
          f"{rel('bf16 permuted', 'bf16'):.4f} (W {rel('bf16 permuted', 'bf16', w):.4f}, model "
          f"{rel('bf16 permuted', 'bf16', model):.4f}); f32 permuted to f32 "
          f"{rel('f32 permuted', 'f32'):.2e}")


if __name__ == "__main__":  # the spread quoted above; --r50: the reference's at IResNet-50
    import sys

    jax.config.update("jax_platforms", "cpu")
    if "--r50" in sys.argv:
        _r50_reference_spread()
        sys.exit(0)
    for size, seeds in ((BATCH, 8), (2 * BATCH, 4)):
        for kind in ("iresnet", "mobilefacenet"):
            for seed in range(seeds):
                d = _distances(kind, seed, size)
                d.pop("mean")
                print(kind, f"B={size}", f"batch {seed}:", " ".join(
                    f"{k} {a:.3e}/{b:.3e} ({a / b:.2f})" for k, (a, b) in d.items()))
