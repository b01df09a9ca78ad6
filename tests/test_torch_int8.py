"""K2 and the int8 gallery vs the reference on the CPU: ``quantize_gallery``
bytes and scale, the plain int8 top-1 against the Pallas kernel in the
interpreter (``gallery_top1_int8(interpret=True)``), the int8 snapshot at
k = 1 and 5, and ``apply_delta`` for f32 and int8 snapshots.

K2's arithmetic is integer (|raw dot| <= 512 * 127**2 < 2**24, exact in
f32 in any order) and its value is raw * (query scale * gallery scale) in
that order, so ids and values are held to exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.engine.gallery import _CompanySnapshot as JaxSnapshot
from facerecognition_infrenceengine_tpu.ops import match_pallas
from facerecognition_infrenceengine_tpu_torch.engine import gallery
from facerecognition_infrenceengine_tpu_torch.ops import match_kernel


def _unit(rng, n, d=512):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("headroom", [1.0, 1.25])
def test_quantize_gallery_matches_reference(headroom):
    rng = np.random.default_rng(0)
    for x in (_unit(rng, 300), np.zeros((8, 512), np.float32),
              rng.normal(size=(17, 512)).astype(np.float32) * 3):
        q, s = match_kernel.quantize_gallery(x, headroom)
        q_ref, s_ref = match_pallas.quantize_gallery(x, headroom)
        assert q.dtype == np.int8 and s == s_ref
        np.testing.assert_array_equal(q, q_ref)


def _both(q, g, nv):
    gq, gs = match_pallas.quantize_gallery(g)
    v_ref, i_ref = match_pallas.gallery_top1_int8(jnp.asarray(q), jnp.asarray(gq), gs, nv,
                                                  interpret=True)
    v, i = match_kernel.gallery_top1_int8(torch.from_numpy(q), torch.from_numpy(gq), gs, nv)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("n,nv,b", [
    (4096, 4000, 48),   # the reference's score-budget case: padding tail, 2 tiles
    (1024, 1024, 8),    # separated identities
    (2048, 1, 3),       # a single valid row
    (64, 0, 2),         # no valid row: -inf
    (8, 5, 1),          # gallery smaller than one tile
])
def test_plain_int8_top1_matches_pallas(n, nv, b):
    rng = np.random.default_rng(n + nv + b)
    g = _unit(rng, n)
    q = _unit(rng, b)
    if nv >= b:  # near-copies of gallery rows, as the reference's separated case
        q = g[:b] + rng.normal(size=(b, 512)).astype(np.float32) * 1e-2
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    v, i = _both(q, g, nv)
    if nv == 0:
        assert np.all(v == -np.inf) and np.all(i == 0)
    elif nv >= b:
        np.testing.assert_array_equal(i, np.arange(b))


def test_plain_int8_ties_rows_past_n_valid_and_a_padded_batch():
    """Exact ties go to the lowest row, across the reference's 2048-row
    tiles too; rows past n_valid never win though they would score higher;
    zero rows padding the query batch change nothing for the real ones."""
    rng = np.random.default_rng(9)
    n, nv = 8192, 6000
    g = _unit(rng, n) * 0.5
    a, b = _unit(rng, 2)
    g[100] = g[2500] = a        # tie across tiles: 100 wins
    g[5990] = g[5995] = b       # tie inside the last valid tile: 5990 wins
    g[6003] = g[8000] = 1.9 * a  # past n_valid, would win if read
    q = np.zeros((32, 512), np.float32)
    q[0], q[1] = a, b
    q[2:5] = _unit(rng, 3)
    v, i = _both(q, g, nv)
    assert i[0] == 100 and i[1] == 5990
    v_small, i_small = _both(q[:5], g, nv)
    np.testing.assert_array_equal(i_small, i[:5])


def _edge_case(case):
    """(queries, float gallery, n_valid) of the edge cases below."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "all_zero_batch":  # bucket padding only: qs = 1e-12 / 127, every dot 0
        return np.zeros((32, 512), np.float32), _unit(rng, 1024), 1000
    if case == "all_negative_dots":  # positive rows queried by their negation
        g = np.abs(_unit(rng, 1024))
        return -g[[0, 31, 32, 500, 999]], g, 1000
    if case == "saturated_rows":  # rows at +-127 against +-1 queries: |dot| = 512 * 127**2
        sign = rng.choice([-1.0, 1.0], size=512).astype(np.float32)
        g = rng.uniform(-0.5, 0.5, (2048, 512)).astype(np.float32)
        g[100], g[1500] = sign, -sign
        return np.stack([sign, -sign, sign]), g, 2048
    if case.startswith("n_valid_"):  # the edges of 32- and 128-row chunks
        nv = int(case.split("_")[-1])
        g = _unit(rng, 2048)
        q = g[[0, nv - 1, nv // 2, nv, nv + 1]] + rng.normal(size=(5, 512)).astype(np.float32) * 1e-2
        return q, g, nv
    assert case == "b257_bucketed"  # padded to bucket(257) = 512 rows, as the snapshot does
    g = _unit(rng, 1024)
    q = np.zeros((512, 512), np.float32)
    q[:257] = _unit(rng, 257)
    q[:5] = g[[3, 64, 999, 500, 7]]
    return q, g, 1000


@pytest.mark.parametrize("case", ["all_zero_batch", "all_negative_dots", "saturated_rows",
                                  "n_valid_1", "n_valid_127", "n_valid_128", "n_valid_129",
                                  "b257_bucketed"])
def test_plain_int8_edge_cases_match_pallas(case):
    """The cases K2's card tests hold the kernel to, here held between the
    plain version and the reference's kernel in the interpreter: ids and
    values equal."""
    q, g, nv = _edge_case(case)
    v, i = _both(q, g, nv)
    if case == "all_zero_batch":
        assert np.all(i == 0) and np.all(v == 0)
    elif case == "all_negative_dots":
        assert np.all(v < 0)
    elif case == "saturated_rows":
        assert i.tolist() == [100, 1500, 100]
        gq, gs = match_pallas.quantize_gallery(g)
        assert np.all(np.abs(gq[[100, 1500]]) == 127)
        qs = np.float32(1.0) / np.float32(127.0)
        np.testing.assert_array_equal(v, np.float32(8258048.0) * (qs * np.float32(gs)))
    elif case.startswith("n_valid_"):
        assert np.all(i < nv)
        assert i[0] == 0 and i[1] == nv - 1
    else:
        from facerecognition_infrenceengine_tpu_torch.engine.pipeline import bucket
        assert bucket(257) == q.shape[0]
        assert i[:5].tolist() == [3, 64, 999, 500, 7]


def test_int8_wrapper_counts_no_launch_on_the_cpu():
    rng = np.random.default_rng(1)
    gq, gs = match_kernel.quantize_gallery(_unit(rng, 64))
    before = match_kernel.gallery_top1_int8.launches
    match_kernel.gallery_top1_int8(torch.from_numpy(_unit(rng, 2)), torch.from_numpy(gq), gs, 64)
    assert match_kernel.gallery_top1_int8.launches == before
    with pytest.raises(TypeError):
        match_kernel.gallery_top1_int8(torch.zeros(2, 512), torch.zeros(64, 512), gs, 64)


@pytest.mark.parametrize("k", [1, 5])
def test_int8_snapshot_matches_reference(k):
    """Same int8 bytes and scale (headroom 1.25) as the reference's snapshot.
    k = 1 runs K2 in the port and is held to the reference's int8 kernel on
    the reference snapshot's matrix; k = 5 runs cosine_topk on the
    dequantized matrix in both packages (the reference's path off a TPU)."""
    rng = np.random.default_rng(4 + k)
    n = 1500
    mat = _unit(rng, n)
    ids = [f"p{i}" for i in range(n)]
    meta = {pid: {"type": "employee", "name": pid} for pid in ids}
    q = _unit(rng, 3)
    q[1] = mat[42]
    ref = JaxSnapshot(ids, meta, mat, 512, 1024, dtype="int8")
    snap = gallery._CompanySnapshot(ids, meta, mat, 512, 1024, dtype="int8", device="cpu")
    assert snap.int8_scale == ref.int8_scale and snap.device_matrix.dtype == torch.int8
    np.testing.assert_array_equal(snap.device_matrix.numpy(), np.asarray(ref.device_matrix))
    got_v, got_ids = snap.match(q, k=k)
    assert got_ids[1][0] == "p42"
    if k == 1:
        qp = np.zeros((4, 512), np.float32)  # the snapshot's bucketed batch
        qp[:3] = q
        v_ref, i_ref = match_pallas.gallery_top1_int8(
            jnp.asarray(qp), ref.device_matrix, ref.int8_scale, n, interpret=True)
        np.testing.assert_array_equal(got_v[:, 0], np.asarray(v_ref)[:3])
        assert [r[0] for r in got_ids] == [ids[j] for j in np.asarray(i_ref)[:3]]
    else:
        want_v, want_ids = ref.match(q, k=k)
        assert got_ids == want_ids
        np.testing.assert_allclose(got_v, np.asarray(want_v), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(snap._dense_matrix().numpy(), np.asarray(ref._dense_matrix()))


# ------------------------------------------------------------- apply_delta
def _pair(dtype, n=6, block=8, seed=0):
    rng = np.random.default_rng(seed)
    mat = _unit(rng, n) * 0.7
    ids = [f"E{i}" for i in range(n)]
    meta = {pid: {"name": pid} for pid in ids}
    ref = JaxSnapshot(ids, meta, mat, 512, block, dtype=dtype)
    snap = gallery._CompanySnapshot(ids, meta, mat, 512, block, dtype=dtype, device="cpu")
    return ref, snap, dict(zip(ids, mat)), rng


def _same(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.ids == want.ids and got.row_of == want.row_of and got.size == want.size
    assert got.metadata == want.metadata
    assert got.int8_scale == want.int8_scale
    m = np.asarray(want.device_matrix)
    np.testing.assert_array_equal(got.device_matrix.numpy()[:want.size], m[:want.size])
    assert got.device_matrix.dtype == (torch.int8 if want.dtype == "int8" else torch.float32)
    np.testing.assert_array_equal(got.device_valid.numpy(), np.asarray(want.device_valid))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_apply_delta_matches_reference(dtype):
    """Append, in-place update, removals (several in one delta, the last
    live row among them, one with a pending update), capacity growth ->
    None; ids, row_of, size, metadata, valid mask and matrix rows (int8
    bytes) exact; the old snapshot is left as it was."""
    ref, snap, vecs, rng = _pair(dtype)
    before = snap.device_matrix.clone()
    get_vec = vecs.__getitem__
    steps = [
        ({"N1": _unit(rng, 1)[0] * 0.6}, [], None),                    # append
        ({"E2": _unit(rng, 1)[0] * 0.5}, [], None),                    # update in place
        ({}, ["E0", "N1", "E3"], None),                                # multi-removal, last row
        ({"E5": _unit(rng, 1)[0] * 0.5, "N2": _unit(rng, 1)[0] * 0.6}, ["E1", "nobody"], None),
        ({}, [], "noop"),
        ({f"G{i}": _unit(rng, 1)[0] * 0.6 for i in range(7)}, [], "grow"),  # 11 > 8 rows
    ]
    for updates, removals, note in steps:
        meta = {p: {"name": p} for p in updates}
        want = ref.apply_delta(updates, meta, removals, get_vec)
        got = snap.apply_delta(updates, meta, removals, get_vec)
        _same(got, want)
        if note == "noop":
            assert got is snap and want is ref
        if note == "grow":
            assert got is None
            break
        vecs.update(updates)
        ref, snap = want, got
    # the first snapshot still holds its rows (value-immutable)
    _, first, _, _ = _pair(dtype)
    np.testing.assert_array_equal(before.numpy(), first.device_matrix.numpy())
    # every surviving row matches its own identity
    for pid, row in snap.row_of.items():
        vec = snap._dense_matrix()[row].numpy()
        assert snap.match(vec[None])[1][0][0] == pid


def test_apply_delta_int8_headroom_overflow_returns_none():
    ref, snap, vecs, rng = _pair("int8")
    big = _unit(rng, 1)[0] * 0.7 * 2.0  # beyond the 1.25 headroom of the global scale
    small = _unit(rng, 1)[0] * 0.7
    for upd, none in (({"N": big}, True), ({"N": small}, False)):
        meta = {p: {"name": p} for p in upd}
        want = ref.apply_delta(upd, meta, [], vecs.__getitem__)
        got = snap.apply_delta(upd, meta, [], vecs.__getitem__)
        assert (got is None) == (want is None) == none
        _same(got, want)
