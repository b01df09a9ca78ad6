#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one card and check it.

    python3 chip_smoke.py

Phases, one flushed line each:

1. device: the card's name and power limit, torch/CUDA versions; TF32 off.
2. build: the one nvcc call over csrc/*.cu, its seconds and ptxas report.
3. main path: FaceAnalysis("buffalo_l") with seeded synthetic det_10g +
   IResNet-50 weights in bf16 on a 640x640 canvas serves 3 requests of 8
   BGR 640x480 frames (get_batch), then match_faces(draw=False) on every
   frame against a 65,536-capacity gallery holding request 1's faces plus
   seeded distractors (n_valid = 50,000).  Every face of request 1 must
   find its own id at score >= 0.99, and the launch counters of both
   kernels, zeroed just before, must be > 0.  A small det_2.5g + r18 f32
   engine on the card is then held against the same engine on the CPU.
4. kernels vs their plain PyTorch versions, on the card, at the path's
   shapes:
   - K3 at M = 256 on request 1's ROIs (with the path's pyramid-level
     histogram and the share of output pixels whose taps clamp to the ROI
     border), and on 256 in-canvas faces: ARCFACE_DST landmarks at scales
     0.5-4 and rotations up to 0.5 rad inside request 1's 640x480 frames;
   - K1 in f32 and bf16 at B = 1, 32, 256 on the path's gallery with the
     embeddings of requests 2-3 as queries, then on a copy of that gallery
     with exact self-matches and ties planted in the last valid row chunk
     and across chunks, and rows past n_valid that would win if read; plus
     n_valid = 0.
5. times: CUDA events after warm-up; bounds from this run's inputs (K3's
   bytes are the ROI pixels its taps read, not the whole ROI).
6. the card line, then {"ok": true, "device": ...} as the last line.

Any failed check or exception exits non-zero before the last line.  With no
CUDA device, or without the port's package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import faulthandler
import json
import subprocess
import sys
import time

import numpy as np

DET_THRESH = 0.5   # synthetic weights saturate scores: every slot is valid
REQUESTS = 3
FRAMES = 8
CAPACITY_ROWS = 50_000
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # FP32 CUDA cores; bf16 tensor cores
WARP_SRC = "facerecognition_infrenceengine_tpu_torch/csrc/warp.cu"
MATCH_SRC = "facerecognition_infrenceengine_tpu_torch/csrc/match.cu"


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    raise SystemExit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def warp_footprint(torch, rois, mats, out_size: int = 112):
    """(ROI pixels that K3's taps read with a non-zero weight, share of output
    pixels with a row or column coordinate clamped to the ROI border), from
    the tap arithmetic of csrc/warp.cu."""
    m, r, _, _ = rois.shape
    dev = rois.device
    m00, m01, m02 = (mats[:, 0, k, None, None] for k in range(3))
    m10, m11, m12 = (mats[:, 1, k, None, None] for k in range(3))
    m11 = torch.where(m11.abs() < 1e-6, torch.full_like(m11, 1e-6), m11)
    jj = torch.arange(out_size, dtype=torch.float32, device=dev)[None, None, :]
    ii = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    sy = m10 * jj + m11 * ii + m12                      # [M, out(i), out(j)]
    syc = sy.clamp(0.0, r - 1.0)
    clamped = sy != syc
    read = torch.zeros(m * r * r, dtype=torch.bool, device=dev)
    face = torch.arange(m, device=dev)[:, None, None]
    for t in (0, 1):
        yf = syc.floor() + t
        wy = (1.0 - (syc - yf).abs()).clamp(min=0.0)
        u = (m00 - m01 * m10 / m11) * jj + (m01 / m11) * yf + (m02 - m01 * m12 / m11)
        uc = u.clamp(0.0, r - 1.0)
        clamped |= (u != uc) & (wy > 0)
        for dx in (0, 1):
            xf = uc.floor() + dx
            w = wy * (1.0 - (uc - xf).abs()).clamp(min=0.0)
            flat = (face * r + yf.long().clamp(max=r - 1)) * r + xf.long().clamp(max=r - 1)
            read[flat[w > 0]] = True
    return int(read.sum()), float(clamped.float().mean())


def in_canvas_kps(rng, n: int, width: int = 640, height: int = 480, dst=None):
    """n faces' landmarks: ARCFACE_DST at scales 0.5-4 and rotations within
    +-0.5 rad, centred so every landmark lies inside a width x height frame."""
    base = dst - dst.mean(0)
    kps = []
    for _ in range(n):
        scale, theta = rng.uniform(0.5, 4.0), rng.uniform(-0.5, 0.5)
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]]) * scale
        pts = base @ rot.T
        lo, hi = -pts.min(0), np.array([width, height]) - 1 - pts.max(0)
        kps.append(pts + rng.uniform(lo, hi))
    return np.stack(kps).astype(np.float32)


def camera_frames(rng, n: int) -> list:
    """Seeded BGR 640x480 frames: smooth shading plus sensor noise."""
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    frames = []
    for _ in range(n):
        gx, gy, base = rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), rng.uniform(60, 190)
        img = base + gx * (xx - 320) + gy * (yy - 240)
        img = img[..., None] + rng.normal(0, 25, (480, 640, 3))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(600, exit=True)
    from facerecognition_infrenceengine_tpu_torch.core.config import (
        Config, EngineConfig, ThresholdConfig)
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
    from facerecognition_infrenceengine_tpu_torch.engine.recognizer import (
        FaceRecognitionProcessor)
    from facerecognition_infrenceengine_tpu_torch.kernels import build
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis, letterbox
    from facerecognition_infrenceengine_tpu_torch.ops import match_kernel, warp2pass, warp_kernel
    from facerecognition_infrenceengine_tpu_torch.ops.align import (
        ARCFACE_DST, _invert_affine, umeyama_similarity)

    # ---------------------------------------------------------------- device
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | tf32 off")
    dev = torch.device("cuda")

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.lib()
    say(f"[build] {build.build_info.get('command', 'cached ' + lib_path)}")
    say(f"[build] {time.perf_counter() - t0:.2f} s")
    for line in build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            say(f"[build] {line.strip()}")

    # ------------------------------------------------------------- main path
    cfg = Config(thresholds=ThresholdConfig(detection=DET_THRESH), engine=EngineConfig())
    t0 = time.perf_counter()
    app = FaceAnalysis("buffalo_l", cfg=cfg.engine, device="cuda")
    app.prepare(ctx_id=0, det_thresh=DET_THRESH)
    engine = app._ensure_engine()
    say(f"[path] FaceAnalysis(buffalo_l) det_10g + r50 {cfg.engine.dtype} "
        f"{cfg.engine.det_size} built in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    requests = [camera_frames(rng, FRAMES) for _ in range(REQUESTS)]
    galleries = GalleryManager(cfg, device="cuda")
    proc = FaceRecognitionProcessor(galleries, face_app=app, cfg=cfg)

    warp_kernel.warp_rois.launches = 0
    match_kernel.gallery_top1.launches = 0
    torch.cuda.reset_peak_memory_stats()
    request_ms, faces_per_request, results = [], [], []
    setup_ms = 0.0
    for r, frames in enumerate(requests):
        t0 = time.perf_counter()
        faces = app.get_batch(frames)
        if r == 0:  # enrol request 1's faces plus seeded unit distractors
            t1 = time.perf_counter()
            own = [f"r0-f{i}-s{j}" for i, fl in enumerate(faces) for j in range(len(fl))]
            emb = [f.normed_embedding for fl in faces for f in fl]
            n_dis = CAPACITY_ROWS - len(own)
            dis = np.random.default_rng(1).normal(size=(n_dis, 512)).astype(np.float32)
            matrix = np.concatenate([np.stack(emb), dis])
            ids = own + [f"distractor-{k}" for k in range(n_dis)]
            meta = {pid: {"type": "employee", "name": pid} for pid in ids}
            snap = galleries.set_snapshot(ids, meta, matrix, company_id="site-1")
            torch.cuda.synchronize()
            setup_ms = (time.perf_counter() - t1) * 1e3
        out = [proc.match_faces(frame, fl, "site-1", draw=False)[1]
               for frame, fl in zip(frames, faces)]
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3 - (setup_ms if r == 0 else 0.0))
        faces_per_request.append(sum(len(fl) for fl in faces))
        results.append((faces, out))
    launches = {"warp_rois": warp_kernel.warp_rois.launches,
                "gallery_top1": match_kernel.gallery_top1.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    say(f"[path] valid slots per request {faces_per_request} of {FRAMES * cfg.engine.max_faces}")
    say(f"[path] gallery capacity {snap.device_matrix.shape[0]} n_valid {snap.size} "
        f"({snap.dtype}), built in {setup_ms:.1f} ms")
    say(f"[path] launches on the path {launches}")
    check(snap.device_matrix.shape[0] == 65536 and snap.size == CAPACITY_ROWS, "gallery shape")
    check(all(n > 0 for n in faces_per_request), "a request found no valid slot")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    for fl in sum((f for f, _ in results), []):
        for face in fl:
            check(np.isfinite(face.bbox).all() and np.isfinite(face.kps).all(), "non-finite box")
            check(abs(float(np.linalg.norm(face.normed_embedding)) - 1.0) < 1e-3, "embedding norm")
    faces0, out0 = results[0]
    k = 0
    for fl, rows in zip(faces0, out0):
        for row in rows:
            check(row["recognized"] and row["person_id"] == own[k] and row["similarity"] >= 0.99,
                  f"request 1 face {own[k]} matched {row['person_id']} at {row['similarity']}")
            k += 1
    others = [row["similarity"] for _, out in results[1:] for rows in out for row in rows]
    say(f"[path] request 1: {k}/{k} faces matched their own id (min score "
        f"{min(row['similarity'] for rows in out0 for row in rows):.6f}); requests 2-3 best "
        f"scores {min(others):.4f}..{max(others):.4f}")

    # small engine on the card vs the same engine on the CPU (plain versions)
    small = EngineConfig(det_size=(128, 128), max_faces=8, pre_nms_topk=64, dtype="float32")
    canvas = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    on_card = FaceEngine(small, det_arch="det_2.5g", rec_arch="r18", device="cuda")
    on_cpu = FaceEngine(small, det_arch="det_2.5g", rec_arch="r18", device="cpu")
    got = on_card.detect_align_embed_flat(canvas, DET_THRESH).cpu().numpy()
    want = on_cpu.detect_align_embed_flat(canvas, DET_THRESH).numpy()
    valid = want[..., 15] > 0.5
    check(np.array_equal(got[..., 15] > 0.5, valid) and valid.any(), "small engine: valid slots")
    cos = (got[..., 16:][valid] * want[..., 16:][valid]).sum(-1)
    box_err = float(np.abs(got[..., :15] - want[..., :15]).max() / max(1.0, np.abs(want[..., :15]).max()))
    check(cos.min() >= 1 - 1e-4 and box_err <= 1e-4, f"small engine: cos {cos.min()} box {box_err}")
    say(f"[path] det_2.5g+r18 f32 card vs CPU: {int(valid.sum())} valid slots identical, "
        f"embedding cos >= {cos.min():.7f}, box/kps err {box_err:.2e} of max")

    # ------------------------------------------------- kernels vs plain, card
    # K3 on the path's own ROIs: request 1's 256 slots, as get_batch warped them
    canvases = np.stack([letterbox(f[..., ::-1], cfg.engine.det_size)[0] for f in requests[0]])
    frames_dev = torch.from_numpy(canvases).to(dev)
    n_frames, slots = FRAMES, cfg.engine.max_faces
    fidx = torch.arange(n_frames, device=dev).repeat_interleave(slots)
    with torch.inference_mode():
        det = engine._detect_impl(frames_dev, DET_THRESH)
        path_kps = det[2].reshape(n_frames * slots, 5, 2).float()
        path_lvl = warp2pass.pyramid_level(
            _invert_affine(umeyama_similarity(path_kps, engine._dst)), cfg.engine.embed_size)
        path_rois, path_mats = warp2pass.extract_rois(frames_dev, fidx, path_kps,
                                                      cfg.engine.embed_size, dst=engine._dst)
    inside = ((path_kps[..., 0] >= 0) & (path_kps[..., 0] < 640)
              & (path_kps[..., 1] >= 0) & (path_kps[..., 1] < 480)).float().mean()
    path_err = float((warp_kernel.warp_rois(path_rois, path_mats)
                      - warp_kernel.warp_rois_plain(path_rois, path_mats)).abs().max())
    check(path_err <= 1e-3, f"K3 on the path's ROIs: max abs err {path_err}")
    path_px, path_clamped = warp_footprint(torch, path_rois, path_mats)
    say(f"[kernels] K3 path ROIs M={path_rois.shape[0]}: max abs err {path_err:.3e} (<= 1e-3); "
        f"pyramid levels {torch.bincount(path_lvl, minlength=4).tolist()}; landmarks inside "
        f"the 640x480 frame {float(inside):.4f}; output pixels with a clamped tap "
        f"{path_clamped:.4f}; ROI pixels read {path_px} of {path_rois.numel() // path_rois.shape[3]}")

    # K3 on in-canvas faces of the same frames, where the taps land inside the ROI
    face_kps = torch.from_numpy(in_canvas_kps(np.random.default_rng(4), n_frames * slots,
                                              dst=ARCFACE_DST)).to(dev)
    with torch.inference_mode():
        face_lvl = warp2pass.pyramid_level(
            _invert_affine(umeyama_similarity(face_kps, engine._dst)), cfg.engine.embed_size)
        rois, mats = warp2pass.extract_rois(frames_dev, fidx, face_kps,
                                            cfg.engine.embed_size, dst=engine._dst)
    crops = warp_kernel.warp_rois(rois, mats)
    crops_plain = warp_kernel.warp_rois_plain(rois, mats)
    warp_err = float((crops - crops_plain).abs().max())
    face_px, face_clamped = warp_footprint(torch, rois, mats)
    check(warp_err <= 1e-3, f"K3 on in-canvas faces: max abs err {warp_err}")
    check(face_clamped < 0.5, f"K3 in-canvas faces: {face_clamped} of output pixels clamp")
    say(f"[kernels] K3 in-canvas faces M={rois.shape[0]} scales 0.5-4: max abs err "
        f"{warp_err:.3e} (<= 1e-3); pyramid levels "
        f"{torch.bincount(face_lvl, minlength=4).tolist()}; output pixels with a clamped "
        f"tap {face_clamped:.4f}; ROI pixels read {face_px} of {rois.numel() // rois.shape[3]}")

    # K1 on the path's gallery, queried with requests 2-3's embeddings
    gal32 = snap.device_matrix
    gal16 = gal32.bfloat16()
    cols = torch.arange(gal32.shape[0], device=dev)
    far = torch.from_numpy(np.stack([fc.normed_embedding for faces, _ in results[1:]
                                     for fl in faces for fc in fl])[:256]).to(dev)
    chunk_rows = build.lib().fre_gallery_top1_rows_per_block()

    def compare_top1(q, gal, n_valid, dtype_name, what):
        v, i = match_kernel.gallery_top1(q, gal, n_valid)
        pv, pi = match_kernel.gallery_top1_plain(q, gal, n_valid)
        scores = torch.where(cols < n_valid, q.to(gal.dtype).float() @ gal.float().T,
                             torch.tensor(float("-inf"), device=dev))
        top2 = scores.topk(2, dim=1).values
        # bf16: the kernel's f32 summation order may swap near-ties
        clear = (top2[:, 0] - top2[:, 1]) >= (1e-2 if dtype_name == "bfloat16" else 0.0)
        check(torch.equal(i[clear], pi[clear]), f"K1 {dtype_name} {what}: ids differ")
        err = float((v - pv).abs().max())
        check(err <= 1e-5, f"K1 {dtype_name} {what}: value err {err}")
        return err, i

    top1_err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype_name, gal in (("float32", gal32), ("bfloat16", gal16)):
        for bq in (1, 32, 256):
            err, i = compare_top1(far[:bq].contiguous(), gal, CAPACITY_ROWS, dtype_name,
                                  f"B={bq}")
            top1_err[dtype_name] = max(top1_err[dtype_name], err)
        v, i = match_kernel.gallery_top1(far[:32].contiguous(), gal, 0)
        check(bool(torch.all(v == float("-inf"))) and bool(torch.all(i == 0)),
              f"K1 {dtype_name}: n_valid=0")
    far_best = match_kernel.gallery_top1_plain(far, gal32, CAPACITY_ROWS)[1]
    say(f"[kernels] K1 path gallery N={gal32.shape[0]} n_valid={CAPACITY_ROWS}, requests 2-3 "
        f"as queries B=1,32,256: top-1 rows {int(far_best.min())}..{int(far_best.max())} in "
        f"{far_best.div(chunk_rows, rounding_mode='floor').unique().numel()} of "
        f"{-(-CAPACITY_ROWS // chunk_rows)} {chunk_rows}-row chunks; max abs err f32 "
        f"{top1_err['float32']:.2e} bf16 {top1_err['bfloat16']:.2e}; n_valid=0 -> -inf")

    # planted rows: exact self-matches in the last valid chunk and in an early
    # one, ties inside a chunk and across chunks, and rows past n_valid that
    # would win if they were read
    unit = np.random.default_rng(3).normal(size=(2, 512)).astype(np.float32)
    qa, qb = torch.from_numpy(unit / np.linalg.norm(unit, axis=1, keepdims=True)).to(dev)
    last = CAPACITY_ROWS - 1
    planted = gal32.clone()
    planted[last - 9] = qa
    planted[last - 4] = qa        # tie inside the last chunk: last - 9 wins
    planted[30_000] = qb
    planted[last] = qb            # tie across chunks: 30,000 wins
    planted[CAPACITY_ROWS + 10] = 4 * qa   # past n_valid, in the last valid chunk
    planted[65_000] = 4 * qb               # past n_valid, far
    want = torch.tensor([last - 9, 30_000], dtype=torch.int32, device=dev)
    for dtype_name, gal in (("float32", planted), ("bfloat16", planted.bfloat16())):
        for bq in (1, 32, 256):
            q = torch.cat([torch.stack([qa, qb]), far])[:bq].contiguous()
            err, i = compare_top1(q, gal, CAPACITY_ROWS, dtype_name, f"planted B={bq}")
            top1_err[dtype_name] = max(top1_err[dtype_name], err)
            check(torch.equal(i[:2], want[:bq]),
                  f"K1 {dtype_name} planted B={bq}: got {i[:2].tolist()}, want {want[:bq].tolist()}")
    say(f"[kernels] K1 planted gallery: self-matches at rows {last - 9} (last chunk, tie with "
        f"{last - 4}) and 30000 (tie with {last}) found in f32 and bf16 at B=1,32,256; rows "
        f"{CAPACITY_ROWS + 10} and 65000 past n_valid never won; max abs err f32 "
        f"{top1_err['float32']:.2e} bf16 {top1_err['bfloat16']:.2e}")

    # ----------------------------------------------------------------- times
    # K3: the in-canvas faces are the kernel line's inputs; the path's own
    # ROIs (taps mostly clamped) are timed beside them.  Bytes: the ROI
    # pixels the taps read, the affines, the crops written.
    m, _, _, c = rois.shape
    warp_ms = time_ms(torch, lambda: warp_kernel.warp_rois(rois, mats), 50)
    warp_plain_ms = time_ms(torch, lambda: warp_kernel.warp_rois_plain(rois, mats), 3, 1)
    warp_ops = m * 112 * 112 * (30 + 10 * c)
    warp_bound, warp_by = bound(4 * (face_px * c + m * 6 + m * 112 * 112 * c), warp_ops,
                                "float32")
    path_warp_ms = time_ms(torch, lambda: warp_kernel.warp_rois(path_rois, path_mats), 50)
    path_warp_bound, _ = bound(4 * (path_px * c + m * 6 + m * 112 * 112 * c), warp_ops,
                               "float32")
    path_b = 32  # match_faces matches one frame's 32 slots, bucketed to 32
    q = far[:path_b].contiguous()
    valid_cols = torch.arange(gal32.shape[0], device=dev) < CAPACITY_ROWS

    def library_top1(gal):
        s = torch.where(valid_cols, q.to(gal.dtype) @ gal.T, float("-inf"))
        return torch.topk(s, 1)

    times = {}
    for dtype_name, gal in (("float32", gal32), ("bfloat16", gal16)):
        for bq in (1, 32, 256):
            qq = far[:bq].contiguous()
            times[(dtype_name, bq)] = time_ms(
                torch, lambda: match_kernel.gallery_top1(qq, gal, CAPACITY_ROWS), 50)
    top1_plain_ms = time_ms(torch, lambda: match_kernel.gallery_top1_plain(q, gal32, CAPACITY_ROWS), 20)
    top1_lib_ms = time_ms(torch, lambda: library_top1(gal32), 20)
    top1_bound, top1_by = bound(CAPACITY_ROWS * 512 * 4 + path_b * 512 * 4 + path_b * 8,
                                2 * path_b * CAPACITY_ROWS * 512, "float32")
    kernels = [
        {"name": "warp_rois", "route": "cuda", "source": WARP_SRC,
         "replaces": "facerecognition_infrenceengine_tpu/ops/warp_pallas.py:115",
         "launches": launches["warp_rois"], "max_abs_err": max(warp_err, path_err),
         "ms": warp_ms,
         "plain_ms": warp_plain_ms, "bound_ms": warp_bound, "bound_by": warp_by,
         "library_ms": None},
        {"name": "gallery_top1", "route": "cuda", "source": MATCH_SRC,
         "replaces": "facerecognition_infrenceengine_tpu/ops/match_pallas.py:79",
         "launches": launches["gallery_top1"], "max_abs_err": top1_err["float32"],
         "ms": times[("float32", path_b)], "plain_ms": top1_plain_ms, "bound_ms": top1_bound,
         "bound_by": top1_by, "library_ms": top1_lib_ms},
    ]
    variants = []
    for (dtype_name, bq), ms in times.items():
        esize = 4 if dtype_name == "float32" else 2
        bnd, by = bound(CAPACITY_ROWS * 512 * esize + bq * 512 * esize + bq * 8,
                        2 * bq * CAPACITY_ROWS * 512, dtype_name)
        variants.append({"name": "gallery_top1", "dtype": dtype_name, "B": bq, "ms": ms,
                         "bound_ms": bnd, "bound_by": by})
    say(f"[times] {card} | K3 M={m} in-canvas faces: {warp_ms:.4f} ms (plain "
        f"{warp_plain_ms:.3f} ms, bound {warp_bound * 1e3:.2f} us by {warp_by}); path ROIs "
        f"{path_warp_ms:.4f} ms (bound {path_warp_bound * 1e3:.2f} us) | K1 f32 B={path_b}: "
        f"{times[('float32', path_b)]:.4f} ms (plain {top1_plain_ms:.4f}, library "
        f"{top1_lib_ms:.4f}, bound {top1_bound * 1e3:.2f} us by {top1_by})")
    say(json.dumps({"variants": variants}))
    say(json.dumps({"path": {"card": card, "requests": REQUESTS, "frames_per_request": FRAMES,
                             "request_ms": request_ms, "faces_per_request": faces_per_request,
                             "gallery_setup_ms": setup_ms, "peak_memory_mb": peak_mb}}))
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
