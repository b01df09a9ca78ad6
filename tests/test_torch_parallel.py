"""The port's device mesh (``parallel/``), the sharded gallery and
``FaceEngine.make_sharded_fused`` against the JAX package, on the CPU.

The reference's cases get their devices from XLA's eight virtual host
devices (tests/conftest.py); the port's counterpart is a mesh that names
the CPU eight times, so each shard is a tensor of its own and every
kernel runs its plain version.  Tolerances: ids and indices exactly;
f32 scores within 1e-5 (the reference's), int8 within 2e-2 of the
unsharded path (the reference's) and within 1e-6 of the reference's own
int8 functions (both scale exact s32 sums by f32 scales); the sharded
fused outputs bit-equal to the unsharded port on each shard's frames, and
the reference's detection sets within its own 1e-3 / 1e-2 px plus 5e-6 of
the largest coordinate (f32 summation order on saturated heads, see
tests/test_torch_slice.py).
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.core.config import EngineConfig as JaxEngineConfig
from facerecognition_infrenceengine_tpu.engine.pipeline import FaceEngine as JaxFaceEngine
from facerecognition_infrenceengine_tpu.ops.match_pallas import (
    quantize_gallery as jax_quantize_gallery)
from facerecognition_infrenceengine_tpu.parallel import build_mesh as jax_build_mesh
from facerecognition_infrenceengine_tpu.parallel import distributed_topk as jax_distributed_topk
from facerecognition_infrenceengine_tpu.parallel.topk import (
    distributed_top1_fused as jax_top1_fused, distributed_topk_int8 as jax_topk_int8)
from facerecognition_infrenceengine_tpu_torch import native
from facerecognition_infrenceengine_tpu_torch.api import create_app
from facerecognition_infrenceengine_tpu_torch.core import metrics
from facerecognition_infrenceengine_tpu_torch.core.config import Config, EngineConfig
from facerecognition_infrenceengine_tpu_torch.domain.enrollment import FaceEmbeddingWorker
from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
from facerecognition_infrenceengine_tpu_torch.models.zoo import (
    FakeFaceAnalysis, encode_fake_face, fake_embedding)
from facerecognition_infrenceengine_tpu_torch.parallel import (
    AXIS_DATA, AXIS_GALLERY, batch_sharding, build_mesh, distributed_top1, distributed_topk,
    gallery_sharding, replicated)
from facerecognition_infrenceengine_tpu_torch.parallel import topk
from facerecognition_infrenceengine_tpu_torch.parallel.sharding import RowShards
from facerecognition_infrenceengine_tpu_torch.store import Datastore

from test_torch_port_cases import cpu_by_default

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_by_default(monkeypatch)


def _unit(rng, n, d=512):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ----------------------------------------------------------------- the mesh
@pytest.mark.parametrize("data,gallery", [(None, None), (2, None), (None, 2), (2, 4), (8, 1)])
def test_build_mesh_shapes_match_the_reference(data, gallery):
    mesh = build_mesh(CPU8, data=data, gallery=gallery)
    ref = jax_build_mesh(jax.devices()[:8], data=data, gallery=gallery)
    assert mesh.shape == dict(ref.shape)
    assert mesh.axis_names == tuple(ref.axis_names) == (AXIS_DATA, AXIS_GALLERY)
    assert mesh.devices.shape == ref.devices.shape
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_build_mesh_errors_and_placements():
    for kw in ({"data": 3}, {"data": 3, "gallery": 3}, {"gallery": 16}):
        with pytest.raises(ValueError, match=r"mesh \d+x\d+ != 8 devices"):
            build_mesh(CPU8, **kw)
        with pytest.raises(ValueError, match=r"mesh \d+x\d+ != 8 devices"):
            jax_build_mesh(jax.devices()[:8], **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh()
    mesh = build_mesh(CPU8, data=2, gallery=4)
    x = torch.arange(24.0).reshape(12, 2)
    rows = gallery_sharding(mesh).put(x)
    assert isinstance(rows, RowShards) and len(rows) == 4 and rows.offsets == [0, 3, 6, 9, 12]
    assert torch.equal(rows.gather(), x) and rows.shape == x.shape and rows.dtype == x.dtype
    assert len(batch_sharding(mesh).put(x)) == 2
    copies = replicated(mesh).put(x)
    assert len(copies) == 1 and torch.equal(copies[0], x)  # one distinct device
    uneven = gallery_sharding(build_mesh(["cpu"] * 2)).put(torch.zeros(93431, 1))
    assert [p.shape[0] for p in uneven.parts] == [46716, 46715]


# ------------------------------------------------------------- distributed top-k
def test_distributed_topk_matches_reference():
    """tests/test_ops_align_matching.py::test_distributed_topk_matches_single_device
    on the port: 8 shards, k = 3, padding rows past 500."""
    rng = np.random.default_rng(6)
    n, d = 512, 128
    g, q = _unit(rng, n, d), _unit(rng, 4, d)
    valid = np.ones(n, bool)
    valid[500:] = False
    mesh = build_mesh(CPU8, data=1, gallery=8)
    vals, idx = distributed_topk(torch.from_numpy(q), torch.from_numpy(g),
                                 torch.from_numpy(valid), mesh, k=3)
    rv, ri = jax_distributed_topk(jnp.asarray(q), jnp.asarray(g), jnp.asarray(valid),
                                  jax_build_mesh(jax.devices()[:8], data=1, gallery=8), k=3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), atol=1e-5)
    v1, i1 = distributed_top1(torch.from_numpy(q), torch.from_numpy(g),
                              torch.from_numpy(valid), mesh)
    assert torch.equal(i1, idx[:, 0]) and torch.equal(v1, vals[:, 0])


def test_distributed_topk_ties_resolve_to_the_lowest_global_index():
    """One row planted in four shards (and twice in one shard): every
    top-k and top-1 names the lowest global copy first, as the reference's
    shard-major lax.top_k does."""
    rng = np.random.default_rng(7)
    n, d = 1024, 512
    g = _unit(rng, n, d)
    copies = [900, 130, 129, 515, 260]  # shards 7, 1, 1, 4, 2 of 128 rows
    for r in copies:
        g[r] = g[copies[0]]
    q = np.stack([g[copies[0]], _unit(rng, 1, d)[0]])
    mesh = build_mesh(CPU8, data=1, gallery=8)
    jmesh = jax_build_mesh(jax.devices()[:8], data=1, gallery=8)
    valid = np.ones(n, bool)
    vals, idx = distributed_topk(torch.from_numpy(q), torch.from_numpy(g),
                                 torch.from_numpy(valid), mesh, k=5)
    assert idx[0].tolist() == sorted(copies)
    rv, ri = jax_distributed_topk(jnp.asarray(q), jnp.asarray(g), jnp.asarray(valid), jmesh,
                                  k=5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    for int8 in (False, True):
        gt = torch.from_numpy(g)
        scale = None
        if int8:
            gq, scale = jax_quantize_gallery(g, headroom=1.25)
            gt = torch.from_numpy(gq)
        v1, i1 = topk.distributed_top1_fused(torch.from_numpy(q), gt, n, mesh, int8_scale=scale)
        assert int(i1[0]) == min(copies)
        if int8:
            vk, ik = topk.distributed_topk_int8(torch.from_numpy(q), gt, scale, n, mesh, k=5)
            assert ik[0].tolist() == sorted(copies)


@pytest.fixture(scope="module")
def seeded_gallery():
    rng = np.random.default_rng(11)
    n, size = 1024, 1000
    g = _unit(rng, n)
    g[size:] = _unit(rng, n - size)  # padding rows that would win if read
    q = np.concatenate([g[[3, 500, 999]] + 0.02 * _unit(rng, 3), _unit(rng, 5)])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[5] = g[1000]  # its best row is padding: never returned
    return g, q, size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_distributed_top1_fused_matches_reference(seeded_gallery, dtype):
    g, q, size = seeded_gallery
    mesh = build_mesh(CPU8, data=1, gallery=8)
    jmesh = jax_build_mesh(jax.devices()[:8], data=1, gallery=8)
    scale = None
    if dtype == "int8":
        gq, scale = jax_quantize_gallery(g, headroom=1.25)
        gt, gj = torch.from_numpy(gq), jnp.asarray(gq)
        rv, ri = jax_top1_fused(jnp.asarray(q), gj, size, jmesh, int8_scale=scale,
                                interpret=True)
    else:
        gt = torch.from_numpy(g).to(getattr(torch, dtype))
        gj = jnp.asarray(g).astype(getattr(jnp, dtype))
        rv, ri = jax_top1_fused(jnp.asarray(q).astype(gj.dtype), gj, size, jmesh,
                                interpret=True)
    vals, idx = topk.distributed_top1_fused(torch.from_numpy(q), gt, size, mesh,
                                            int8_scale=scale)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), atol=1e-5 if scale is None else 1e-6)
    assert (idx.numpy() < size).all()
    pv, pi = topk.distributed_top1_fused_plain(torch.from_numpy(q),
                                               gallery_sharding(mesh).put(gt), size, scale)
    assert torch.equal(pv, vals) and torch.equal(pi, idx)


def test_distributed_topk_int8_matches_reference(seeded_gallery):
    g, q, size = seeded_gallery
    gq, scale = jax_quantize_gallery(g, headroom=1.25)
    mesh = build_mesh(CPU8, data=1, gallery=8)
    jmesh = jax_build_mesh(jax.devices()[:8], data=1, gallery=8)
    vals, idx = topk.distributed_topk_int8(torch.from_numpy(q), torch.from_numpy(gq), scale,
                                           size, mesh, k=3)
    rv, ri = jax_topk_int8(jnp.asarray(q), jnp.asarray(gq), scale, size, jmesh, k=3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), atol=1e-6)
    shards = gallery_sharding(mesh).put(torch.from_numpy(gq))
    pv, pi = topk.distributed_topk_int8_plain(torch.from_numpy(q), shards, scale, size, k=3)
    assert torch.equal(pv, vals) and torch.equal(pi, idx)
    valid = gallery_sharding(mesh).put(torch.arange(len(g)) < size)
    fv, fi = topk.distributed_topk_plain(torch.from_numpy(q), gallery_sharding(mesh).put(
        torch.from_numpy(g)), valid, k=3)
    assert torch.equal(fi[:5, 0], idx[:5, 0])  # the planted queries: same rows as f32


# ---------------------------------------------------- the sharded gallery
def _png(person_seed, jitter=0.0):
    ok, buf = cv2.imencode(".png", encode_fake_face(person_seed, jitter))
    assert ok
    return buf.tobytes()


@pytest.fixture
def world():
    """tests/test_enrollment_gallery.py's ``world`` on the port's modules."""
    cfg = Config()
    ds = Datastore(cfg)
    client = create_app(ds, cfg).test_client()
    cid = client.post("/bharatlytics/v1/companies/seed").get_json()["company"]["_id"]
    worker = FaceEmbeddingWorker(ds, cfg, detector=FakeFaceAnalysis())
    return cfg, ds, client, cid, worker


def _register(client, cid, emp_id, person_seed, jitters=(0.0, 0.1, 0.2)):
    files = {pose: (f"{pose}.png", _png(person_seed, j), "image/png")
             for pose, j in zip(("center", "left", "right"), jitters)}
    return client.post("/bharatlytics/v1/employees/register",
                       data={"employeeId": emp_id, "employeeName": f"P{person_seed}",
                             "companyId": cid}, files=files)


def test_gallery_match_sharded_equals_local(world):
    """GalleryManager.match over an 8-device gallery mesh == single device."""
    cfg, ds, client, cid, worker = world
    for emp, seed in (("E1", 42), ("E2", 43), ("E3", 44)):
        _register(client, cid, emp, person_seed=seed)
    worker.process_available_jobs()
    local = GalleryManager(ds, cfg, mesh=None)
    sharded = GalleryManager(ds, cfg, mesh=build_mesh(CPU8, data=1, gallery=8))
    assert isinstance(sharded.snapshot(cid).device_matrix, RowShards)
    probe = np.stack([fake_embedding(42, 0.05), fake_embedding(44, 0.02)])
    s_loc, ids_loc, _ = local.match(probe, company_id=cid)
    s_sh, ids_sh, _ = sharded.match(probe, company_id=cid)
    assert ids_sh == ids_loc
    np.testing.assert_allclose(s_sh, s_loc, atol=1e-5)
    s_loc3, ids_loc3, _ = local.match(probe, company_id=cid, k=3)
    s_sh3, ids_sh3, _ = sharded.match(probe, company_id=cid, k=3)
    assert ids_sh3 == ids_loc3
    np.testing.assert_allclose(s_sh3, s_loc3, atol=1e-5)


def test_gallery_match_sharded_int8_no_dequant(world):
    """The mesh path keeps an int8 gallery int8 on every shard (K2 a shard,
    plain version here) and returns the local int8 path's ids; k > 1 rides
    the int8 shard matmul; a delta keeps the row shards resident."""
    cfg, ds, client, cid, worker = world
    for emp, seed in (("E1", 42), ("E2", 43), ("E3", 44)):
        _register(client, cid, emp, person_seed=seed)
    worker.process_available_jobs()
    cfg_i8 = dataclasses.replace(cfg, engine=dataclasses.replace(cfg.engine,
                                                                 gallery_dtype="int8"))
    local = GalleryManager(ds, cfg_i8)
    sharded = GalleryManager(ds, cfg_i8, mesh=build_mesh(CPU8, data=1, gallery=8))
    snap = sharded.snapshot(cid)
    assert snap.device_matrix.dtype == torch.int8
    assert all(p.dtype == torch.int8 for p in snap.device_matrix.parts)
    probe = np.stack([fake_embedding(42, 0.03), fake_embedding(44, 0.01)])
    s_l, ids_l, _ = local.match(probe, company_id=cid)
    s_s, ids_s, _ = sharded.match(probe, company_id=cid)
    assert ids_s == ids_l
    np.testing.assert_allclose(s_s, s_l, atol=2e-2)
    s_s3, ids_s3, _ = sharded.match(probe, company_id=cid, k=3)
    s_l3, ids_l3, _ = local.match(probe, company_id=cid, k=3)
    assert ids_s3 == ids_l3
    _register(client, cid, "E9", person_seed=99)
    worker.process_available_jobs()
    sharded.force_sync()
    snap9 = sharded.snapshot(cid)
    assert isinstance(snap9.device_matrix, RowShards) and snap9.device_matrix.dtype == torch.int8
    _, ids, meta = sharded.match(fake_embedding(99)[None], company_id=cid)
    assert meta[ids[0][0]]["employeeId"] == "E9"


def test_gallery_mesh_indivisible_capacity_falls_back(world):
    """A gallery axis that does not divide the padded capacity (6 against
    1024 * 2**k) serves through the single-device kernels."""
    cfg, ds, client, cid, worker = world
    for emp, seed in (("E1", 42), ("E2", 43)):
        _register(client, cid, emp, person_seed=seed)
    worker.process_available_jobs()
    local = GalleryManager(ds, cfg, mesh=None)
    sharded = GalleryManager(ds, cfg, mesh=build_mesh(["cpu"] * 6, data=1, gallery=6))
    assert isinstance(sharded.snapshot(cid).device_matrix, torch.Tensor)
    probe = np.stack([fake_embedding(42, 0.05)])
    s_loc, ids_loc, _ = local.match(probe, company_id=cid)
    s_sh, ids_sh, _ = sharded.match(probe, company_id=cid)
    assert ids_sh == ids_loc
    np.testing.assert_allclose(s_sh, s_loc, atol=1e-5)


# ----------------------------------------------------- make_sharded_fused
KW = dict(det_size=(160, 160), max_faces=4, pre_nms_topk=64, dtype="float32")


@pytest.fixture(scope="module")
def engine():
    return FaceEngine(EngineConfig(**KW, packed_stem_impl="pallas"), det_arch="det_500m",
                      rec_arch="r18", seed=0, device="cpu")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 255, (8, 160, 160, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def reference_raw(frames):
    ref = JaxFaceEngine(JaxEngineConfig(**KW), det_arch="det_500m", rec_arch="r18", seed=0)
    return tuple(np.asarray(o) for o in ref.detect_align_embed(frames, 0.1))


@pytest.mark.parametrize("data,gallery", [(8, 1), (2, 4)])
@pytest.mark.parametrize("variant", ["raw", "flat", "yuv_flat"])
def test_sharded_fused_matches_single_device(engine, frames, reference_raw, variant, data,
                                             gallery):
    """Each data shard equals the single-device program on its own frames
    bit for bit and stays on its shard's device; the raw variant's
    detections match the reference's single-device program as sets (its
    own test's comparison, tests/test_sharded_fused.py)."""
    mesh = build_mesh(CPU8, data=data, gallery=gallery)
    run = engine.make_sharded_fused(mesh, variant)
    x = frames if variant != "yuv_flat" else np.stack(
        [native.pack_yuv420_s2d4(f) for f in frames])
    got = run(x, 0.1)
    step = len(frames) // data
    single = {"raw": engine.detect_align_embed, "flat": engine.detect_align_embed_flat,
              "yuv_flat": engine.detect_align_embed_yuv420_flat}[variant]
    for i in range(data):
        want = single(x[i * step:(i + 1) * step], 0.1)
        if variant == "raw":
            assert all(torch.equal(o.parts[i], w) for o, w in zip(got, want))
            assert all(o.parts[i].device == mesh.devices[i, 0] for o in got)
        else:
            assert torch.equal(got.parts[i], want)
            assert got.parts[i].device == mesh.devices[i, 0]
    if variant == "flat":
        assert got.shape == (8, 4, 528)
    if variant != "raw":
        return
    assert got[4].shape == (8, 4, 512) and len(got[4]) == data
    g_boxes, g_valid = got[0].gather().numpy(), got[3].gather().numpy()
    w_boxes, w_valid = reference_raw[0], reference_raw[3]
    assert (g_valid.sum(1) == w_valid.sum(1)).all() and g_valid.any()
    scale = np.abs(w_boxes[w_valid]).max()
    for b in range(len(frames)):
        gb = np.sort(g_boxes[b][g_valid[b]], axis=0)
        wb = np.sort(w_boxes[b][w_valid[b]], axis=0)
        np.testing.assert_allclose(gb, wb, rtol=1e-3, atol=1e-2 + 5e-6 * scale)


def test_sharded_fused_batch_must_split_and_engine_copies(engine, frames):
    run = engine.make_sharded_fused(build_mesh(CPU8, data=8, gallery=1), "flat")
    with pytest.raises(ValueError, match="does not split over 8 data shards"):
        run(frames[:6], 0.1)
    twin = engine._on(torch.device("cpu"))
    assert twin.detector is not engine.detector and twin.embedder is not engine.embedder
    assert twin.det_variables["stem_pallas"] is twin.stem_weights  # shared once
    assert torch.equal(twin.detect_align_embed_flat(frames[:2], 0.1),
                       engine.detect_align_embed_flat(frames[:2], 0.1))


def test_the_mesh_entry_points_run_inside_the_gate():
    gated = metrics.on_device(lambda: None).__code__
    run = FaceEngine.make_sharded_fused
    assert run.__code__ is gated and FaceEngine._on.__code__ is gated
