"""The port's ArcFace fine-tuning (``engine/training.py``) and the
training-state carry-over (``models/weights.py``) against the JAX package,
on the CPU.

Both packages start from one state (the reference's, carried across by
``train_state_from_flax``) and take the same steps on the same seeded
batches.  Models: the twin of tests/test_training.py's ``TinyEmbedder``
(flax ``'SAME'`` at stride 2 on 8x8 pads (0, 1); flax BatchNorm's default
momentum 0.99 is torch's 0.01) and the tiny ``IResNet`` of
``__graft_entry__.dryrun_multichip`` (depths 1, widths 8, 32x32).

Tolerances (f32): the loss within 1e-6 relative; the gradients (the
momentum after one step from zero is the gradient: ``t = g + 0.9 * 0``)
within 1e-4 of the largest gradient of their leaf, and no tighter than
1e-6 of the largest gradient of all (a BatchNorm bias that another
BatchNorm follows has a zero gradient in exact arithmetic: both sides hold
f32 noise of ~1e-6 there); params within 1e-5 and
batch statistics within 1e-5 (absolute, values of order 1).  The mesh step
against the unsharded one: the same bounds.  Checkpoints: bit for bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F
from flax import linen as fnn
from torch import nn

from facerecognition_infrenceengine_tpu.engine import training as ref_training
from facerecognition_infrenceengine_tpu.models import arcface as ref_arcface
from facerecognition_infrenceengine_tpu_torch.engine import training
from facerecognition_infrenceengine_tpu_torch.models import arcface, weights
from facerecognition_infrenceengine_tpu_torch.parallel import build_mesh
from facerecognition_infrenceengine_tpu_torch.parallel.sharding import RowShards

CPU8 = ["cpu"] * 8


class TinyEmbedderFlax(fnn.Module):
    """tests/test_training.py's TinyEmbedder."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.Conv(8, (3, 3), strides=2, use_bias=False)(x)
        x = fnn.BatchNorm(use_running_average=not train)(x)
        x = fnn.relu(x)
        x = x.mean(axis=(1, 2))
        return fnn.Dense(512)(x)


class TinyEmbedder(nn.Module):
    """Its torch twin: flax names, NHWC input, flax's 'SAME' (0, 1) pad."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 8, 3, 2, 0, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(8, eps=1e-5, momentum=0.01)
        self.Dense_0 = nn.Linear(8, 512)

    def forward(self, x):
        x = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
        x = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))


def _iresnet_pair():
    return (ref_arcface.IResNet(depths=(1, 1, 1, 1), widths=(8, 8, 8, 8), embed_dim=512),
            arcface.IResNet(depths=(1, 1, 1, 1), widths=(8, 8, 8, 8), input_size=32))


MODELS = {"tiny": (lambda: (TinyEmbedderFlax(), TinyEmbedder()), 8, 4),
          "iresnet": (_iresnet_pair, 32, 64)}


def _batch(rng, n, side, classes):
    return (rng.normal(size=(n, side, side, 3)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int32))


def _reference_and_port(kind, lr=0.1):
    """Both packages' states from the reference's init; returns
    (flax model, ref state, ref tx, torch model, port state, port opt)."""
    make, side, classes = MODELS[kind]
    fm, tm = make()
    ref_state, tx = ref_training.make_train_state(fm, classes, jnp.zeros((2, side, side, 3)),
                                                  learning_rate=lr)
    _, opt = training.make_train_state(tm, classes, np.zeros((2, side, side, 3), np.float32),
                                       learning_rate=lr)
    state = _carried(ref_state, tm)
    return fm, ref_state, tx, tm, state, opt


def _carried(ref_state, tm):
    return weights.train_state_from_flax(
        jax.device_get(ref_state["params"]), jax.device_get(ref_state["batch_stats"]),
        jax.device_get(ref_state["opt_state"][0].trace), tm)


def _flat_trees(trees):
    return [weights.flatten_tree(t) for t in trees]


def _close(got: dict, want: dict, atol=None, rel=None):
    """Within ``atol``, or within ``rel`` of the leaf's largest value with a
    floor of 1e-6 of the largest value of all leaves."""
    assert set(got) == set(want), set(got) ^ set(want)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k in want:
        w, g = np.asarray(want[k], np.float32), np.asarray(got[k], np.float32)
        tol = atol if rel is None else max(rel * float(np.abs(w).max()), 1e-6 * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)


def _close_states(got_trees, want_trees):
    params, stats, mom = _flat_trees(got_trees)
    w_params, w_stats, w_mom = _flat_trees(want_trees)
    _close(params, w_params, atol=1e-5)
    _close(stats, w_stats, atol=1e-5)
    _close(mom, w_mom, rel=1e-4)


# ------------------------------------------------------------------ logits
def test_arcface_logits_matches_reference():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(6, 512)).astype(np.float32)
    w = rng.normal(size=(10, 512)).astype(np.float32)
    w[3] = emb[0] * 2.0  # cos = 1: the clip
    labels = np.array([3, 1, 9, 0, 0, 5], np.int32)
    got = training.arcface_logits(torch.from_numpy(emb), torch.from_numpy(w),
                                  torch.from_numpy(labels))
    want = ref_training.arcface_logits(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    got2 = training.arcface_logits(torch.from_numpy(emb), torch.from_numpy(w),
                                   torch.from_numpy(labels), margin=0.3, scale=30.0)
    want2 = ref_training.arcface_logits(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels),
                                        margin=0.3, scale=30.0)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=0, atol=1e-4)


# ---------------------------------------------------------------- one step
@pytest.mark.parametrize("kind", ["tiny", "iresnet"])
def test_one_step_matches_reference(kind):
    """Loss, every gradient (against jax.value_and_grad of the reference's
    loss), params, batch_stats and momentum after the optax update: one
    step from the initial state, and one from the reference's state after
    it (non-zero momentum), each carried across first.  (Two steps in a
    row part by ~1e-3 of the tiny IResNet's gradients: its lr-0.1,
    scale-64 step amplifies the first step's f32 rounding ~1000x.)"""
    fm, ref_state, tx, tm, state, opt = _reference_and_port(kind)
    _, side, classes = MODELS[kind]
    rng = np.random.default_rng(1)
    ref_step = ref_training.make_train_step(fm, tx, mesh=None)
    step = training.make_train_step(tm, opt)

    def ref_loss(params, batch_stats, images, labels):
        emb, _ = fm.apply({"params": params["model"], "batch_stats": batch_stats}, images,
                          train=True, mutable=["batch_stats"])
        logits = ref_training.arcface_logits(emb, params["w"], labels)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    for it in range(2):
        images, labels = _batch(rng, 16, side, classes)
        loss_r, grads_r = jax.value_and_grad(ref_loss)(
            ref_state["params"], ref_state["batch_stats"], jnp.asarray(images),
            jnp.asarray(labels))
        ref_state, ref_l = ref_step(ref_state, jnp.asarray(images), jnp.asarray(labels))
        new, loss = step(state, images, labels)
        np.testing.assert_allclose(float(loss), float(ref_l), rtol=1e-6)
        np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-6)
        if it == 1:  # the gradient from the carried non-zero-momentum state
            grads = {k: (np.asarray(m) - 0.9 * np.asarray(m0)) for (k, m), m0 in zip(
                weights.flatten_tree(weights.train_state_to_flax(new, tm)[2]).items(),
                weights.flatten_tree(weights.train_state_to_flax(state, tm)[2]).values())}
            _close(grads, weights.flatten_tree(jax.device_get(grads_r)), rel=1e-4)
        if it == 0:  # from zero momentum, the momentum is the gradient
            _, _, mom = weights.train_state_to_flax(new, tm)
            want = weights.flatten_tree(jax.device_get(grads_r))
            _close(weights.flatten_tree(mom), want, rel=1e-4)
        _close_states(weights.train_state_to_flax(new, tm), (
            jax.device_get(ref_state["params"]), jax.device_get(ref_state["batch_stats"]),
            jax.device_get(ref_state["opt_state"][0].trace)))
        state = _carried(ref_state, tm)


def test_the_step_leaves_its_state_as_it_was():
    _, _, _, tm, state, opt = _reference_and_port("iresnet")
    before = weights.flatten_tree(weights.train_state_to_flax(state, tm)[0])
    images, labels = _batch(np.random.default_rng(2), 16, 32, 64)
    for step in (training.make_train_step(tm, opt),
                 training.make_train_step(tm, opt, mesh=build_mesh(CPU8, data=2, gallery=4))):
        a, la = step(state, images, labels)
        b, lb = step(state, images, labels)
        assert float(la) == float(lb)
        after = weights.flatten_tree(weights.train_state_to_flax(state, tm)[0])
        assert all(np.array_equal(before[k], after[k]) for k in before)
        assert not torch.equal(a["params"]["model"]["Conv_0.weight"],
                               state["params"]["model"]["Conv_0.weight"])


# -------------------------------------------------------------- the mesh step
@pytest.mark.parametrize("data,gallery", [(2, 4), (8, 1), (1, 8)])
def test_mesh_step_matches_unsharded(data, gallery):
    """The mesh step (batch over data, W row-sharded over gallery, BatchNorm
    on the whole batch's statistics, the class-parallel softmax) equals the
    unsharded step: from the initial state, then from the unsharded step's
    result (non-zero momentum) placed by ``shard_state``; 64 classes, 16
    images."""
    _, _, _, tm, state, opt = _reference_and_port("iresnet")
    mesh = build_mesh(CPU8, data=data, gallery=gallery)
    step = training.make_train_step(tm, opt)
    mstep = training.make_train_step(tm, opt, mesh=mesh)
    mstate = mstep.shard_state(state)
    assert isinstance(mstate["params"]["w"], RowShards) and len(mstate["params"]["w"]) == gallery
    rng = np.random.default_rng(3)
    for _ in range(2):
        images, labels = _batch(rng, 16, 32, 64)
        new, loss = step(state, images, labels)
        mnew, mloss = mstep(mstate, images, labels)
        np.testing.assert_allclose(float(mloss), float(loss), rtol=1e-6)
        assert isinstance(mnew["opt_state"]["w"], RowShards)
        _close_states(weights.train_state_to_flax(mnew, tm),
                      weights.train_state_to_flax(new, tm))
        state, mstate = new, mstep.shard_state(new)


def test_mesh_step_matches_the_reference_mesh_step():
    """The reference's own mesh step (2x4 virtual devices, XLA's SPMD) and
    the port's, from one state."""
    fm, ref_state, tx, tm, state, opt = _reference_and_port("iresnet")
    jmesh = __import__("facerecognition_infrenceengine_tpu.parallel",
                       fromlist=["build_mesh"]).build_mesh(jax.devices()[:8], data=2, gallery=4)
    ref_step = ref_training.make_train_step(fm, tx, mesh=jmesh)
    ref_state = ref_step.shard_state(ref_state)
    mstep = training.make_train_step(tm, opt, mesh=build_mesh(CPU8, data=2, gallery=4))
    images, labels = _batch(np.random.default_rng(4), 16, 32, 64)
    ref_state, ref_l = ref_step(ref_state, jnp.asarray(images), jnp.asarray(labels))
    new, loss = mstep(state, images, labels)
    np.testing.assert_allclose(float(loss), float(ref_l), rtol=1e-6)
    _close_states(weights.train_state_to_flax(new, tm), (
        jax.device_get(ref_state["params"]), jax.device_get(ref_state["batch_stats"]),
        jax.device_get(ref_state["opt_state"][0].trace)))


class _FunctionalBN(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(3, 512)
        self.scale = nn.Parameter(torch.ones(512))

    def forward(self, x):
        x = self.Dense_0(x.mean(dim=(1, 2)))
        return F.batch_norm(x, None, None, self.scale, None, training=True)


class _Untraceable(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(3, 512)

    def forward(self, x):
        if x.sum() > 0:  # data-dependent control flow: torch.fx cannot trace it
            x = x * 2
        return self.Dense_0(x.mean(dim=(1, 2)))


def test_mesh_step_refuses_what_it_cannot_shard():
    mesh = build_mesh(CPU8, data=2, gallery=4)
    opt = training.make_train_state(_Untraceable(), 8, np.zeros((2, 4, 4, 3), np.float32))[1]
    with pytest.raises(ValueError, match="does not trace"):
        training.make_train_step(_Untraceable(), opt, mesh=mesh)
    with pytest.raises(ValueError, match="functional batch norm"):
        training.make_train_step(_FunctionalBN(), opt, mesh=mesh)


# ------------------------------------------------- tests/test_training.py
N_CLASSES = 4
IMG = 8


def _toy_batches(n_steps, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(N_CLASSES, IMG, IMG, 3)).astype(np.float32)
    for _ in range(n_steps):
        labels = rng.integers(0, N_CLASSES, size=batch)
        images = protos[labels] + 0.05 * rng.normal(size=(batch, IMG, IMG, 3)).astype(np.float32)
        yield images, labels


@pytest.fixture(scope="module")
def toy():
    torch.manual_seed(0)
    model = TinyEmbedder()
    state, opt = training.make_train_state(model, N_CLASSES, np.zeros((1, IMG, IMG, 3),
                                                                      np.float32),
                                           learning_rate=0.1)
    return training.make_train_step(model, opt), state


def test_loss_converges_on_separable_toy(toy):
    step, state0 = toy
    _, losses = training.fit(step, state0, _toy_batches(40), log_every=0)
    assert losses[0] > 0
    assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5]), losses


def _leaves(state):
    return weights.flatten_tree(training._to_host(state))


def test_checkpoint_resume_is_bit_exact(toy, tmp_path):
    step, state0 = toy
    ckpt = str(tmp_path / "ckpt")
    ref_state, _ = training.fit(step, state0, _toy_batches(12, seed=7), log_every=0)
    batches = list(_toy_batches(12, seed=7))
    mid_state, _ = training.fit(step, state0, batches[:6], ckpt_dir=ckpt, log_every=0)
    restored, at_step = training.restore_checkpoint(ckpt, target=state0)
    assert at_step == 6
    mid, back = _leaves(mid_state), _leaves(restored)
    assert set(mid) == set(back)
    for k in mid:
        np.testing.assert_array_equal(back[k], mid[k], err_msg=k)
    res_state, _ = training.fit(step, restored, batches[6:], ckpt_dir=ckpt, log_every=0,
                                start_step=at_step)
    want, got = _leaves(ref_state), _leaves(res_state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert training.restore_checkpoint(ckpt)[1] == 12
    assert training.restore_checkpoint(str(tmp_path / "none")) is None


def test_a_sharded_checkpoint_restores_into_its_shards(tmp_path):
    _, _, _, tm, state, opt = _reference_and_port("iresnet")
    mstep = training.make_train_step(tm, opt, mesh=build_mesh(CPU8, data=2, gallery=4))
    mstate, _ = mstep(state, *_batch(np.random.default_rng(5), 16, 32, 64))
    training.save_checkpoint(str(tmp_path), mstate, 3)
    back, at = training.restore_checkpoint(str(tmp_path), target=mstate)
    assert at == 3 and isinstance(back["params"]["w"], RowShards)
    assert [p.shape for p in back["params"]["w"].parts] == [p.shape for p in
                                                            mstate["params"]["w"].parts]
    assert all(torch.equal(a, b) for a, b in zip(back["opt_state"]["w"].parts,
                                                 mstate["opt_state"]["w"].parts))
    plain, _ = training.restore_checkpoint(str(tmp_path))
    assert torch.equal(plain["params"]["w"], mstate["params"]["w"].gather())


# ------------------------------------------------------ the state carry-over
@pytest.mark.parametrize("kind", ["tiny", "iresnet"])
def test_to_flax_round_trips(kind):
    """``from_flax(to_flax(x)) == x`` bit for bit (the flattened Dense's
    NCHW <-> NHWC permutation included), and the reverse on the flax tree;
    the training state's carry-over round-trips too."""
    _, ref_state, _, tm, state, _ = _reference_and_port(kind)
    sd = {k: torch.randn(t.shape) for k, t in tm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    back = weights.from_flax(weights.to_flax(sd, tm), tm)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    flat = weights.flatten_tree({"params": jax.device_get(ref_state["params"]["model"]),
                                 "batch_stats": jax.device_get(ref_state["batch_stats"])})
    again = weights.to_flax(weights.from_flax(flat, tm), tm)
    assert set(again) == set(flat)
    assert all(np.array_equal(again[k], np.asarray(flat[k])) for k in flat)
    trees = weights.train_state_to_flax(state, tm)
    state2 = weights.train_state_from_flax(*trees, tm)
    assert _leaves(state2).keys() == _leaves(state).keys()
    assert all(np.array_equal(_leaves(state2)[k], v) for k, v in _leaves(state).items())
    with pytest.raises(KeyError, match="not in the flax layout"):
        weights.to_flax({"nope.weight": torch.zeros(1)}, tm)
