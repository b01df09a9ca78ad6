"""Port gallery match vs the reference: the plain K1 against the Pallas
top-1 in the interpreter, cosine_topk for k > 1, and snapshot matches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.engine.gallery import _CompanySnapshot as JaxSnapshot
from facerecognition_infrenceengine_tpu.ops.match_pallas import gallery_top1 as jax_top1
from facerecognition_infrenceengine_tpu.ops.matching import cosine_topk as jax_topk
from facerecognition_infrenceengine_tpu_torch.engine import gallery
from facerecognition_infrenceengine_tpu_torch.ops import match_kernel, matching


def _unit(rng, n, d=512):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,nv,b", [
    (1024, 1000, 64),   # padding tail
    (4096, 4096, 3),    # tiny batch, several of the reference's tiles
    (2048, 1, 8),       # single valid row
    (8, 5, 1),          # gallery smaller than one tile
])
def test_plain_top1_matches_pallas(n, nv, b):
    rng = np.random.default_rng(0)
    g, q = _unit(rng, n), _unit(rng, b)
    v_ref, i_ref = jax_top1(jnp.asarray(q), jnp.asarray(g), nv, interpret=True)
    v, i = match_kernel.gallery_top1(torch.from_numpy(q), torch.from_numpy(g), nv)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=0, atol=1e-6)


def test_plain_top1_bf16_same_ids():
    rng = np.random.default_rng(1)
    n, b = 2048, 16
    g32 = _unit(rng, n)
    q = g32[:b] + rng.normal(size=(b, 512)).astype(np.float32) * 1e-3
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v_ref, i_ref = jax_top1(jnp.asarray(q, jnp.bfloat16), jnp.asarray(g32, jnp.bfloat16),
                            n, interpret=True)
    v, i = match_kernel.gallery_top1(torch.from_numpy(q).bfloat16(),
                                     torch.from_numpy(g32).bfloat16(), n)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(i.numpy(), np.arange(b))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref, np.float32), rtol=0, atol=1e-5)


def test_plain_top1_ties_go_to_lowest_index():
    g = np.zeros((64, 512), np.float32)
    g[10, 0] = g[37, 0] = 1.0
    q = np.eye(1, 512, dtype=np.float32)
    _, i_ref = jax_top1(jnp.asarray(q), jnp.asarray(g), 64, interpret=True)
    _, i = match_kernel.gallery_top1(torch.from_numpy(q), torch.from_numpy(g), 64)
    assert int(i[0]) == int(i_ref[0]) == 10


def test_plain_top1_all_padding_is_neg_inf():
    rng = np.random.default_rng(2)
    g, q = _unit(rng, 128), _unit(rng, 4)
    v_ref, i_ref = jax_top1(jnp.asarray(q), jnp.asarray(g), 0, interpret=True)
    v, i = match_kernel.gallery_top1(torch.from_numpy(q), torch.from_numpy(g), 0)
    assert np.all(v.numpy() == -np.inf) and np.all(np.asarray(v_ref) == -np.inf)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def test_cosine_topk_matches_reference():
    rng = np.random.default_rng(3)
    g, q = _unit(rng, 256), _unit(rng, 5)
    g[100] = g[7]  # a duplicate: lax.top_k puts the lower index first
    q[0] = g[7]
    valid = np.arange(256) < 200
    v_ref, i_ref = jax_topk(jnp.asarray(q), jnp.asarray(g), jnp.asarray(valid), k=5)
    v, i = matching.cosine_topk(torch.from_numpy(q), torch.from_numpy(g),
                                torch.from_numpy(valid), k=5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 5])
def test_snapshot_match_matches_reference(k):
    """Capacity, prefix mask, query bucketing and the id mapping."""
    rng = np.random.default_rng(4)
    n = 1500
    mat = _unit(rng, n)
    ids = [f"p{i}" for i in range(n)]
    meta = {pid: {"type": "employee", "name": pid} for pid in ids}
    q = _unit(rng, 3)
    q[1] = mat[42]
    want_v, want_ids = JaxSnapshot(ids, meta, mat, 512, 1024).match(q, k=k)
    snap = gallery._CompanySnapshot(ids, meta, mat, 512, 1024, device="cpu")
    assert snap.device_matrix.shape == (2048, 512) and snap.size == n
    got_v, got_ids = snap.match(q, k=k)
    assert got_ids == want_ids and got_ids[1][0] == "p42"
    np.testing.assert_allclose(got_v, np.asarray(want_v), rtol=0, atol=1e-6)


def test_empty_snapshot_and_int8_refusal():
    """Empty snapshots answer None; the int8 dtype is ported now (K2), so
    only a dtype the reference does not have is refused."""
    for dtype in ("float32", "int8"):
        snap = gallery._CompanySnapshot([], {}, None, 512, 1024, dtype=dtype, device="cpu")
        scores, ids = snap.match(np.ones((2, 512), np.float32))
        assert ids == [[None], [None]] and np.all(scores == -1.0)
    with pytest.raises(ValueError):
        gallery._CompanySnapshot([], {}, None, 512, 1024, dtype="float16", device="cpu")
