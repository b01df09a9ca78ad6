#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one card and check them.

    python3 chip_smoke.py

Phases, one flushed line each:

1. device: the card's name and power limit, torch/CUDA versions; TF32 off.
2. build: the one nvcc call over csrc/*.cu, its seconds and ptxas report;
   the host codec (csrc/imagecodec.cc) built by g++, with or without JPEG.
3. rgb path: FaceAnalysis("buffalo_l", allowed_modules=("detection",
   "recognition")) with seeded synthetic det_10g +
   IResNet-50 weights in bf16 on a 640x640 canvas serves 3 requests of 8
   BGR 640x480 frames (get_batch), then match_faces(draw=False) on every
   frame against a 65,536-capacity gallery holding request 1's faces plus
   seeded distractors (n_valid = 50,000).  Every face of request 1 must
   find its own id at score >= 0.99, and the launch counters of both
   kernels, zeroed just before, must be > 0.  A small det_2.5g + r18 f32
   engine on the card is then held against the same engine on the CPU.
4. yuv path: FaceAnalysis("buffalo_l", EngineConfig(stream_transport=
   "yuv420", packed_stem_impl="pallas", gallery_dtype="int8"),
   allowed_modules=("detection", "recognition")), det_10g +
   r50 in bf16, serves 3 requests of 8 BGR 640x480 frames (host yuv420
   encode included) through K4 (fused stem), K3 and K2 (int8 top-1), then
   match_faces against an int8 gallery (capacity 65,536, n_valid 50,000:
   request 1's faces plus seeded distractors).  The launch counters of K4,
   K3 and K2, zeroed just before, must be > 0, with K4 once and K2 8 times
   a request (the attribute heads, on by default, would send the batch to
   the rgb path: the reference's rule); K2's ids and scores on the
   path must equal the plain int8 version's; request 1's faces must be
   recognized, with the f32 plain match's ids wherever its top-1 leads the
   runner-up by more than 5e-3.  A small det_2.5g + r18 f32 engine on the
   same configuration runs yuv packs on the card and on the CPU.
5. hd path: FaceAnalysis("buffalo_l") with its default modules
   (detection, recognition, genderage, landmark_2d_106), det_10g + r50 and
   the two attribute heads in bf16, serves 3 requests of 8 BGR frames from
   mixed cameras, 4 at 1920x1080 (letterbox scale 1/3) and 4 at 1280x720
   (1/2): the C++ letterbox x8, detect, boxes and landmarks over the
   float32 scale, embed from the native frames padded to 1088x1920 (K3 at
   112), the attribute heads (K3 at 96 and 192), then match_faces(draw=True)
   against an f32 gallery (K1; capacity 65,536, n_valid 50,000) and the HUD
   on every frame.  On the card's host the C++ letterbox and
   letterbox_yuv420_s2d4 must equal the numpy plain versions byte for byte
   on request 1's frames; K3 launches once a request at each crop size and
   K1 once a frame; every face of request 1 finds its own id at >= 0.99;
   gender is 0 or 1; request 1's 106 landmarks equal the landmark head's
   output on its crops mapped back through the crop affine, and the
   farthest landmark (in box sides from the box centre) on 256 boxes inside
   the frames equals the float32 head's on the CPU within a bf16 step; the
   share within 1.5 box sides is reported (the seeded head is untrained, so
   it is not bounded).  Host times: 8 letterboxes, C++ against plain, and the yuv420
   encode of the rgb path's 8 640x480 frames, C++ (encode_frame) against the
   numpy encoder the port used before the host codec was built.
6. kernels vs their plain PyTorch versions, on the card, at the paths'
   shapes:
   - K3 at M = 256 read straight from request 1's uint8 atlas (the path's
     call) on request 1's faces (with the path's pyramid-level histogram
     and the share of output pixels whose taps clamp to the ROI border),
     and on 256 in-canvas faces: ARCFACE_DST landmarks at scales 0.5-4 and
     rotations up to 0.5 rad inside request 1's 640x480 frames; in both
     uint8 reads (direct and staged) it must equal K3 on the ROIs cut out of
     the atlas bit for bit, and its plain version within 1e-3; the same on
     the packed atlas of request 1's yuv frames (the yuv path's faces and
     the in-canvas faces) and at 96 and 192 on the hd boxes (below); and
     warp_faces_two_pass, warp_boxes_two_pass (96, 192) and
     warp_faces_two_pass_packed at the paths' shapes must launch K3 once and
     form no [M, 192, 192, C] or [M, 48, 48, 16C] ROI tensor (no aten op
     under them returns one);
   - K1 in f32 and bf16 at B = 1, 32, 256 on the path's gallery with the
     embeddings of requests 2-3 as queries, then on a copy of that gallery
     with exact self-matches and ties planted in the last valid row chunk
     and across chunks, and rows past n_valid that would win if read; plus
     n_valid = 0; and request 1 of the yuv path against its f32 gallery:
     every face finds its own id at >= 0.99;
   - K4 at B = 8, 640x640, sw = 28 on request 1's packed frames of the yuv
     path, in bf16 (tensor cores) and f32, at 128x64 with sw = 12 and at
     36x44 with sw = 8 (edge tiles; the three stem widths of det_10g,
     det_2.5g and det_500m);
   - K2 at B = 1, 32, 64, 128, 256 on the yuv path's int8 gallery with
     requests 2-3's embeddings as queries, on a planted copy as for K1 (the
     ties placed in and across K2's 32-row chunks), and with n_valid = 0:
     ids and values exactly equal; and one device kernel a K2 call
     (torch.profiler) at B = 1, 32, 256;
   - the yuv mix on the card against the CPU on every (Y, U, V) triple;
   - K3 at 96 and 192 on the hd path's request-1 boxes and on 256 boxes of
     40-400 px inside its frames, from one atlas of the native batch.
7. times: `ms` is the wrapper call as the path makes it, CUDA events over
   back-to-back calls after warm-up (host dispatch included where the host
   is slower than the card); `kernel_device_ms` is the kernels' own device
   time a call, from torch.profiler's device events over the same calls.
   K2 also gives `kernel_device_ms_cold`, its kernel's device time with
   the L2 cache evicted (a 256 MB read) before every call.  Bounds from
   this run's inputs (K3's bytes are the distinct atlas bytes its taps
   read, not the whole window; bound_ms_f32_rois counts the float32 ROI
   pixels they read, the bound of K3 on extracted ROIs).  K3's entries also
   give kernel_device_ms_staged (kernel_device_ms is the direct uint8
   read, the default), K3 on the extracted float32 ROIs (ms_f32_rois), and
   step_ms (window arithmetic + K3 on the atlas) against step_ms_unfused
   (the same arithmetic, the ROIs cut out of the atlas, float32, and K3 on
   them), timed in turns, beside atlas_ms.  K1's wrapper is also timed at
   B = 1 with its scratch cache emptied before every call (`ms_uncached`):
   the per-call allocations and library lookups the cache removes.
8. the card line, then {"ok": true, "device": ...} as the last line.

    python3 chip_smoke.py --profile

also traces one more request of each path (rgb, yuv, hd) with
torch.profiler after the checks: wall time, the device's busy share, the kernels that take the
most device time, the hand-written kernels' count and device time, and
the BatchNorm kernels' count and device time.

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
CAPACITY_ROWS = 50_000          # n_valid of the galleries
CAPACITY = 65_536               # their padded capacity
TIE_ROW, FAR_ROW = 30_000, 65_000  # planted rows: a tie across chunks, one past n_valid
CANVAS = 640                    # det canvas side
FRAME_H, FRAME_W = 480, 640     # camera frames (letterbox scale 1.0 on the canvas)
HD_SHAPES = ((1080, 1920),) * 4 + ((720, 1280),) * 4  # the hd path's mixed cameras
ATTR_SIZES = (96, 192)          # the attribute heads' crops (genderage, landmark_2d_106)
ALL_MODULES = ("detection", "recognition", "genderage", "landmark_2d_106")
HBM_BYTES_PER_S = 3.35e12
# FP32 CUDA cores; bf16 and int8 tensor cores (dense)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
WARP_SRC = "facerecognition_infrenceengine_tpu_torch/csrc/warp.cu"
MATCH_SRC = "facerecognition_infrenceengine_tpu_torch/csrc/match.cu"
MATCH_INT8_SRC = "facerecognition_infrenceengine_tpu_torch/csrc/match_int8.cu"
STEM_SRC = "facerecognition_infrenceengine_tpu_torch/csrc/stem.cu"
# the kernels of csrc/ as torch.profiler names them
HAND_KERNELS = ("warp_windows_kernel", "top1_f32_kernel", "top1_bf16_kernel", "top1_int8_kernel",
                "fused_stem")
INT8_MARGIN = 5e-3  # f32 top-1 lead over the runner-up above which int8 must agree


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


def traced(activities):
    """A torch.profiler session whose first step is a warm-up: its events are
    dropped, and those of the second step are kept (the tracer on the card's
    machine can lose the first device events of a session).  Run one call,
    ``prof.step()``, the traced calls, ``prof.step()``."""
    from torch.profiler import profile, schedule

    return profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1,
                                                            repeat=1))


def device_events(torch, fn, iters: int, before=None) -> list:
    """torch.profiler's device events (key, count, self device us) over iters
    calls of fn after a warm-up; before(), if given, runs ahead of every call.
    A trace that recorded no device time, or fewer device events than calls
    (every call launches a kernel), is taken again, four times at most: the
    profiler on the card's machine now and then returns empty traces, up to
    three in a row, or loses most of a trace's events."""
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        if attempt:
            time.sleep(0.5)
        with traced([ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
            prof.step()
        rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0 and not e.key.startswith("ProfilerStep")]
        if sum(count for _, count, _ in rows) >= iters:
            if attempt:
                say(f"[profile] a trace with no or lost device events was taken again "
                    f"({attempt}x)")
            return rows
    fail(f"torch.profiler recorded fewer device events than {iters} calls")


def device_ms(torch, fn, iters: int = 20) -> float:
    """The device time a call of fn: the sum of torch.profiler's device
    events (kernels, copies, memsets) over iters calls, after a warm-up."""
    return sum(us for _, _, us in device_events(torch, fn, iters)) / 1e3 / iters


def kernel_ms(torch, fn, part: str, iters: int = 20, before=None) -> float:
    """The device time a call of fn of the kernels whose name holds part;
    before(), if given, runs ahead of every call and is not counted."""
    us = sum(u for key, _, u in device_events(torch, fn, iters, before) if part in key)
    if us <= 0:
        fail(f"torch.profiler recorded no device time for {part}")
    return us / 1e3 / iters


def device_kernels(torch, fn, iters: int = 5) -> list:
    """(name, count a call) of every device event of iters traced calls of fn
    (a trace of a single short call can come back empty on the card's
    machine)."""
    return [(key, count / iters) for key, count, _ in device_events(torch, fn, iters)]


def profile_request(torch, fn, label: str, top: int = 12) -> None:
    """Trace one call of fn (one request): wall ms, device-busy ms (the sum of
    the kernels' device time; one stream, so kernels do not overlap) and the
    kernels with the most device time."""
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    # device-side events only (kernels, copies, memsets): operator rows would
    # count their kernels' time a second time, and the step's annotation spans
    # the whole traced call
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    say(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), idle {100 - 100 * busy_ms / wall_ms:.1f}%")
    for us, count, key in rows[:top]:
        say(f"[profile] {label}:   {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    for us, count, key in rows:  # the hand-written kernels, wherever they rank
        if any(k in key for k in HAND_KERNELS):
            say(f"[profile] {label}:   hand {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    bn = [r for r in rows if "batch_norm" in r[2]]
    say(f"[profile] {label}: BatchNorm kernels {sum(r[1] for r in bn)} launches, "
        f"{sum(r[0] for r in bn) / 1e3:.3f} ms device")
    for us, count, key in bn:
        say(f"[profile] {label}:   bn {us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


def warp_footprint(torch, mats, r: int, out_size: int = 112, windows=None, atlas_shape=None,
                   packed: bool = False):
    """(window pixels that K3's taps read with a non-zero weight, summed over
    the faces; share of output pixels with a row or column coordinate clamped
    to the window border; given the windows and the atlas's [B, Ha, Wa, Cs]
    shape, the distinct atlas pixels those taps read -- what the kernel on
    the uint8 atlas must move, over C -- else None), from the tap arithmetic
    of csrc/warp.cu."""
    m = mats.shape[0]
    dev = mats.device
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
    atlas_px = None
    if windows is not None:
        b, ha, wa, _ = atlas_shape
        idx = read.nonzero()[:, 0]
        f, rem = idx // (r * r), idx % (r * r)
        w = windows.long()[f]
        unit = 4 if packed else 1
        ay = w[:, 1] * unit + rem // r
        ax = w[:, 2] * unit + rem % r
        seen = torch.zeros(b * ha * unit * wa * unit, dtype=torch.bool, device=dev)
        seen[(w[:, 0] * ha * unit + ay) * wa * unit + ax] = True
        atlas_px = int(seen.sum())
    return int(read.sum()), float(clamped.float().mean()), atlas_px


def in_turns(torch, fa, fb, iters: int = 50):
    """ms a call of fa and of fb, timed in the order a, b, b, a (CUDA events,
    back-to-back calls after warm-up): two versions compared on one card in
    one run."""
    a1 = time_ms(torch, fa, iters)
    b1 = time_ms(torch, fb, iters)
    b2 = time_ms(torch, fb, iters)
    a2 = time_ms(torch, fa, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def in_canvas_kps(rng, n: int, width: int = FRAME_W, height: int = FRAME_H, dst=None):
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


def camera_frames(rng, n: int, height: int = FRAME_H, width: int = FRAME_W) -> list:
    """Seeded BGR frames (640x480 by default): smooth shading plus sensor
    noise."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    frames = []
    for _ in range(n):
        gx, gy, base = rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), rng.uniform(60, 190)
        img = base + gx * (xx - width / 2) + gy * (yy - height / 2)
        img = img[..., None] + rng.normal(0, 25, (height, width, 3))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def host_ms(fn, reps: int = 3) -> list:
    """Host wall ms of each of reps calls of fn."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def in_frame_boxes(rng, n: int, shapes) -> tuple:
    """n boxes of side 40-400 px (aspect up to 1.3) inside frames of the given
    (h, w) shapes, round robin -> (boxes [n, 4] xyxy, frame index [n])."""
    boxes, idx = [], []
    for k in range(n):
        h, w = shapes[k % len(shapes)]
        bw = rng.uniform(40, 400)
        bh = bw * rng.uniform(1.0, 1.3)
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        boxes.append([x1, y1, x1 + bw, y1 + bh])
        idx.append(k % len(shapes))
    return np.asarray(boxes, np.float32), np.asarray(idx)


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
    from facerecognition_infrenceengine_tpu_torch import native
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import _YUV_BLACK, bucket
    from facerecognition_infrenceengine_tpu_torch.kernels import build
    from facerecognition_infrenceengine_tpu_torch.models import genderage, landmark106, scrfd
    from facerecognition_infrenceengine_tpu_torch.models.weights import load_or_init
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis, letterbox
    from facerecognition_infrenceengine_tpu_torch.native import plain
    from facerecognition_infrenceengine_tpu_torch.ops import (
        match_kernel, stem_kernel, warp2pass, warp_kernel, yuv)
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
    t0 = time.perf_counter()
    host_path = build.build_host()
    native_jpeg = native.have_jpeg()
    say(f"[build] {build.build_info.get('host_command', 'cached ' + host_path)}")
    say(f"[build] host codec {time.perf_counter() - t0:.2f} s, JPEG "
        f"{'compiled in (libjpeg found)' if native_jpeg else 'not compiled (no libjpeg)'}")

    # ------------------------------------------------------------- main path
    cfg = Config(thresholds=ThresholdConfig(detection=DET_THRESH),
                 engine=EngineConfig(det_size=(CANVAS, CANVAS)))
    t0 = time.perf_counter()
    app = FaceAnalysis("buffalo_l", cfg=cfg.engine, device="cuda",
                       allowed_modules=("detection", "recognition"))
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
    check(snap.device_matrix.shape[0] == CAPACITY and snap.size == CAPACITY_ROWS, "gallery shape")
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

    # ------------------------------------------------------------- yuv path
    ycfg = Config(thresholds=ThresholdConfig(detection=DET_THRESH),
                  engine=EngineConfig(det_size=(CANVAS, CANVAS), stream_transport="yuv420",
                                      packed_stem_impl="pallas", gallery_dtype="int8"))
    t0 = time.perf_counter()
    yapp = FaceAnalysis("buffalo_l", cfg=ycfg.engine, device="cuda",
                        allowed_modules=("detection", "recognition"))
    yapp.prepare(ctx_id=0, det_thresh=DET_THRESH)
    yengine = yapp._ensure_engine()
    say(f"[yuv] FaceAnalysis(buffalo_l) det_10g + r50 {ycfg.engine.dtype} "
        f"{ycfg.engine.det_size}, stream_transport=yuv420 packed_stem_impl=pallas "
        f"gallery_dtype=int8, built in {time.perf_counter() - t0:.2f} s")
    check(all(yapp._yuv_eligible(yengine, frames) for frames in requests), "yuv path not taken")
    ygal = GalleryManager(ycfg, device="cuda")
    yproc = FaceRecognitionProcessor(ygal, face_app=yapp, cfg=ycfg)

    stem_kernel.fused_stem.launches = 0
    warp_kernel.warp_rois.launches = 0
    match_kernel.gallery_top1_int8.launches = 0
    match_kernel.gallery_top1.launches = 0
    torch.cuda.reset_peak_memory_stats()
    y_ms, y_faces, y_results = [], [], []
    y_setup_ms = 0.0
    for r, frames in enumerate(requests):
        t0 = time.perf_counter()
        faces = yapp.get_batch(frames)
        if r == 0:  # enrol request 1's faces plus the same seeded distractors
            t1 = time.perf_counter()
            yown = [f"r0-f{i}-s{j}" for i, fl in enumerate(faces) for j in range(len(fl))]
            emb = [f.normed_embedding for fl in faces for f in fl]
            n_dis = CAPACITY_ROWS - len(yown)
            dis = np.random.default_rng(1).normal(size=(n_dis, 512)).astype(np.float32)
            ymatrix = np.concatenate([np.stack(emb), dis])
            yids = yown + [f"distractor-{k}" for k in range(n_dis)]
            ymeta = {pid: {"type": "employee", "name": pid} for pid in yids}
            ysnap = ygal.set_snapshot(yids, ymeta, ymatrix, company_id="site-1")
            torch.cuda.synchronize()
            y_setup_ms = (time.perf_counter() - t1) * 1e3
        out = [yproc.match_faces(frame, fl, "site-1", draw=False)[1]
               for frame, fl in zip(frames, faces)]
        torch.cuda.synchronize()
        y_ms.append((time.perf_counter() - t0) * 1e3 - (y_setup_ms if r == 0 else 0.0))
        y_faces.append(sum(len(fl) for fl in faces))
        y_results.append((faces, out))
    y_launches = {"fused_stem": stem_kernel.fused_stem.launches,
                  "warp_rois": warp_kernel.warp_rois.launches,
                  "gallery_top1_int8": match_kernel.gallery_top1_int8.launches,
                  "gallery_top1": match_kernel.gallery_top1.launches}
    y_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    say(f"[yuv] request wall ms {[round(t, 1) for t in y_ms]}, peak memory {y_peak_mb:.1f} MiB")
    if "--profile" in sys.argv[1:]:
        t0 = time.perf_counter()
        for f in requests[1]:
            yapp.encode_frame(f)
        say(f"[profile] yuv host encode of request 2's {FRAMES} frames: "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
        for label, fa, pr in (("rgb", app, proc), ("yuv", yapp, yproc)):
            profile_request(torch, lambda: [pr.match_faces(f, fl, "site-1", draw=False)
                                            for f, fl in zip(requests[1],
                                                             fa.get_batch(requests[1]))],
                            f"{label} request 2")
    say(f"[yuv] valid slots per request {y_faces} of {FRAMES * ycfg.engine.max_faces}")
    say(f"[yuv] int8 gallery capacity {ysnap.device_matrix.shape[0]} n_valid {ysnap.size} "
        f"scale {ysnap.int8_scale:.6g}, built in {y_setup_ms:.1f} ms")
    say(f"[yuv] launches on the path {y_launches}")
    check(ysnap.device_matrix.shape[0] == CAPACITY and ysnap.size == CAPACITY_ROWS
          and ysnap.device_matrix.dtype == torch.int8, "int8 gallery shape")
    check(all(n > 0 for n in y_faces), "a yuv request found no valid slot")
    check(all(y_launches[k] > 0 for k in ("fused_stem", "warp_rois", "gallery_top1_int8")),
          f"a kernel of the yuv path was not launched: {y_launches}")
    check(y_launches["fused_stem"] == REQUESTS and y_launches["gallery_top1_int8"] == sum(
        1 for faces, _ in y_results for fl in faces if fl) == REQUESTS * FRAMES
        and y_launches["gallery_top1"] == 0,
        f"the yuv path must launch K4 once and K2 {FRAMES} times a request: {y_launches}")
    for fl in sum((f for f, _ in y_results), []):
        for face in fl:
            check(np.isfinite(face.bbox).all() and np.isfinite(face.kps).all(), "non-finite box")
            check(abs(float(np.linalg.norm(face.normed_embedding)) - 1.0) < 1e-3, "embedding norm")

    # K2 on the path against the plain int8 version; request 1 against f32
    ymat32 = torch.from_numpy(ymatrix / np.linalg.norm(ymatrix, axis=1, keepdims=True)).to(dev)
    ycols = torch.arange(ymat32.shape[0], device=dev)
    compared, under_margin, own_ok = 0, 0, 0
    for r, (faces, out) in enumerate(y_results):
        for fl, rows in zip(faces, out):
            if not fl:
                continue
            embs = np.stack([f.normed_embedding for f in fl])
            embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
            q = np.zeros((bucket(len(fl)), 512), np.float32)
            q[:len(fl)] = embs
            qd = torch.from_numpy(q).to(dev)
            pv, pi = match_kernel.gallery_top1_int8_plain(qd, ysnap.device_matrix,
                                                          ysnap.int8_scale, ysnap.size)
            pv, pi = pv.cpu().numpy()[:len(fl)], pi.cpu().numpy()[:len(fl)]
            for row, v, i in zip(rows, pv, pi):
                check(row["similarity"] == float(v), f"K2 on the path: score {row['similarity']} "
                      f"vs plain {float(v)}")
                want_id = yids[i] if v >= ycfg.thresholds.recognition else None
                check(row["person_id"] == want_id, f"K2 on the path: id {row['person_id']} "
                      f"vs plain {want_id}")
                compared += 1
            if r == 0:
                s32 = qd[:len(fl)] @ ymat32.T
                s32 = torch.where(ycols < CAPACITY_ROWS, s32, float("-inf"))
                top2 = s32.topk(2, dim=1)
                for row, vals, idx in zip(rows, top2.values.tolist(), top2.indices.tolist()):
                    check(row["recognized"], f"request 1 face not recognized: {row}")
                    if vals[0] - vals[1] > INT8_MARGIN:
                        check(row["person_id"] == yids[idx[0]],
                              f"request 1: int8 id {row['person_id']} vs f32 {yids[idx[0]]}")
                        own_ok += 1
                    else:
                        under_margin += 1
    say(f"[yuv] K2 on the path: {compared} faces' ids and scores equal to the plain int8 "
        f"version; request 1: {len(yown)}/{len(yown)} recognized, {own_ok} with the f32 id "
        f"(f32 lead > {INT8_MARGIN}), {under_margin} under that margin")
    # request 1 of the yuv path against its own f32 gallery, through K1
    emb1 = torch.from_numpy(np.stack([f.normed_embedding for fl in y_results[0][0]
                                      for f in fl])).to(dev)
    v1, i1 = match_kernel.gallery_top1(emb1, ymat32.float().contiguous(), CAPACITY_ROWS)
    own_rows = torch.arange(len(yown), device=dev, dtype=torch.int32)
    check(torch.equal(i1, own_rows) and float(v1.min()) >= 0.99,
          f"yuv request 1 vs its f32 gallery: {int((i1 != own_rows).sum())} faces miss "
          f"their own id, min score {float(v1.min())}")
    say(f"[yuv] request 1 vs its f32 gallery through K1: {len(yown)}/{len(yown)} faces found "
        f"their own id (min score {float(v1.min()):.6f})")

    # small engine on the yuv / pallas / int8 configuration: card vs CPU
    small_y = EngineConfig(det_size=(128, 128), max_faces=8, pre_nms_topk=64, dtype="float32",
                           stream_transport="yuv420", packed_stem_impl="pallas",
                           gallery_dtype="int8")
    packs = np.stack([native.pack_yuv420_s2d4(c) for c in canvas])
    y_card = FaceEngine(small_y, det_arch="det_2.5g", rec_arch="r18", device="cuda")
    y_cpu = FaceEngine(small_y, det_arch="det_2.5g", rec_arch="r18", device="cpu")
    got = y_card.detect_align_embed_yuv420_flat(packs, DET_THRESH).cpu().numpy()
    want = y_cpu.detect_align_embed_yuv420_flat(packs, DET_THRESH).numpy()
    valid = want[..., 15] > 0.5
    check(np.array_equal(got[..., 15] > 0.5, valid) and valid.any(), "small yuv engine: valid slots")
    cos = (got[..., 16:][valid] * want[..., 16:][valid]).sum(-1)
    box_err = float(np.abs(got[..., :15] - want[..., :15]).max() / max(1.0, np.abs(want[..., :15]).max()))
    check(cos.min() >= 1 - 1e-4 and box_err <= 1e-4, f"small yuv engine: cos {cos.min()} box {box_err}")
    say(f"[yuv] det_2.5g+r18 f32 yuv/pallas card vs CPU: {int(valid.sum())} valid slots "
        f"identical, embedding cos >= {cos.min():.7f}, box/kps err {box_err:.2e} of max")

    # --------------------------------------------------------------- hd path
    hcfg = Config(thresholds=ThresholdConfig(detection=DET_THRESH),
                  engine=EngineConfig(det_size=(CANVAS, CANVAS)))
    t0 = time.perf_counter()
    happ = FaceAnalysis("buffalo_l", cfg=hcfg.engine, device="cuda")
    happ.prepare(ctx_id=0, det_thresh=DET_THRESH)
    hengine = happ._ensure_engine()
    hengine._ensure_attr_models()
    say(f"[hd] FaceAnalysis(buffalo_l) modules {list(happ.allowed_modules)}, det_10g + r50 + "
        f"genderage + landmark_2d_106 {hcfg.engine.dtype} {hcfg.engine.det_size}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    check(happ.allowed_modules == ALL_MODULES, f"default modules {happ.allowed_modules}")
    hrng = np.random.default_rng(5)
    hd_requests = [[camera_frames(hrng, 1, h, w)[0] for h, w in HD_SHAPES]
                   for _ in range(REQUESTS)]
    # the host codec on the card's host, on request 1's frames (before the HUD
    # draws on them): C++ against the numpy plain versions, byte for byte
    rgb1 = [np.ascontiguousarray(f[..., ::-1]) for f in hd_requests[0]]
    hd_scales = []
    for f in rgb1:
        got, scale = native.letterbox(f, CANVAS, CANVAS)
        want, want_scale = plain.letterbox_plain(f, CANVAS, CANVAS)
        check(scale == want_scale and np.array_equal(got, want),
              f"C++ letterbox of a {f.shape[:2]} frame differs from plain")
        got, scale = native.letterbox_yuv420_s2d4(f, CANVAS, CANVAS)
        want, want_scale = plain.letterbox_yuv420_s2d4_plain(f, CANVAS, CANVAS)
        check(scale == want_scale and np.array_equal(got, want),
              f"C++ letterbox_yuv420_s2d4 of a {f.shape[:2]} frame differs from plain")
        hd_scales.append(scale)
    check(sorted(set(hd_scales)) == [float(np.float32(1 / 3)), 0.5], f"scales {hd_scales}")
    lb_ms = host_ms(lambda: [native.letterbox(f, CANVAS, CANVAS) for f in rgb1])
    lb_plain_ms = host_ms(lambda: [plain.letterbox_plain(f, CANVAS, CANVAS) for f in rgb1])

    def numpy_encode(frame):  # encode_frame as it was before the host codec
        canvas = np.zeros((FRAME_H, CANVAS, 3), np.uint8)
        canvas[:, :FRAME_W] = frame[..., ::-1]
        return plain.pack_yuv420_s2d4_plain(canvas)

    check(all(np.array_equal(yapp.encode_frame(f), numpy_encode(f)) for f in requests[0]),
          "C++ yuv420 encode differs from the numpy encoder")
    enc_ms = host_ms(lambda: [yapp.encode_frame(f) for f in requests[0]])
    enc_plain_ms = host_ms(lambda: [numpy_encode(f) for f in requests[0]])
    say(f"[hd] host codec on the card's host: request 1's 8 frames letterboxed by C++ "
        f"byte-equal to plain (scales {sorted(set(hd_scales))}), yuv420 equal too; "
        f"{card} | 8 letterboxes C++ {[round(t, 2) for t in lb_ms]} ms, plain "
        f"{[round(t, 2) for t in lb_plain_ms]} ms | yuv420 encode of 8 640x480 frames C++ "
        f"{[round(t, 2) for t in enc_ms]} ms, numpy {[round(t, 2) for t in enc_plain_ms]} ms")
    hd_h = max(h for h, _ in HD_SHAPES)
    hd_w = max(w for _, w in HD_SHAPES)
    hd_batch = np.zeros((FRAMES, hd_h + (-hd_h) % 8, hd_w + (-hd_w) % 8, 3), np.uint8)
    for i, f in enumerate(rgb1):
        hd_batch[i, :f.shape[0], :f.shape[1]] = f

    hgal = GalleryManager(hcfg, device="cuda")
    hproc = FaceRecognitionProcessor(hgal, face_app=happ, cfg=hcfg)
    warp_kernel.warp_rois.launches = 0
    warp_kernel.warp_rois.launches_by_size.clear()
    match_kernel.gallery_top1.launches = 0
    match_kernel.gallery_top1_int8.launches = 0
    stem_kernel.fused_stem.launches = 0
    torch.cuda.reset_peak_memory_stats()
    h_ms, h_get_ms, h_match_ms, h_faces, h_results = [], [], [], [], []
    h_setup_ms = 0.0
    for r, frames in enumerate(hd_requests):
        t0 = time.perf_counter()
        faces = happ.get_batch(frames)
        t_get = time.perf_counter()
        setup = 0.0
        if r == 0:  # enrol request 1's faces plus the seeded distractors
            hown = [f"r0-f{i}-s{j}" for i, fl in enumerate(faces) for j in range(len(fl))]
            emb = [f.normed_embedding for fl in faces for f in fl]
            n_dis = CAPACITY_ROWS - len(hown)
            dis = np.random.default_rng(1).normal(size=(n_dis, 512)).astype(np.float32)
            hids = hown + [f"distractor-{k}" for k in range(n_dis)]
            hmeta = {pid: {"type": "employee", "name": pid, "employeeId": f"E{k:05d}"}
                     for k, pid in enumerate(hids)}
            hsnap = hgal.set_snapshot(hids, hmeta, np.concatenate([np.stack(emb), dis]),
                                      company_id="site-1")
            torch.cuda.synchronize()
            setup = time.perf_counter() - t_get
            h_setup_ms = setup * 1e3
        t_match = time.perf_counter()
        out = [hproc.match_faces(frame, fl, "site-1", draw=True)[1]
               for frame, fl in zip(frames, faces)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h_ms.append((t1 - t0 - setup) * 1e3)
        h_get_ms.append((t_get - t0) * 1e3)
        h_match_ms.append((t1 - t_match) * 1e3)
        h_faces.append(sum(len(fl) for fl in faces))
        h_results.append((faces, out))
    h_launches = {"warp_rois": dict(warp_kernel.warp_rois.launches_by_size),
                  "gallery_top1": match_kernel.gallery_top1.launches,
                  "gallery_top1_int8": match_kernel.gallery_top1_int8.launches,
                  "fused_stem": stem_kernel.fused_stem.launches}
    h_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    say(f"[hd] request wall ms {[round(t, 1) for t in h_ms]} (get_batch "
        f"{[round(t, 1) for t in h_get_ms]}, match_faces + HUD {[round(t, 1) for t in h_match_ms]})"
        f", peak memory {h_peak_mb:.1f} MiB")
    say(f"[hd] valid slots per request {h_faces} of {FRAMES * hcfg.engine.max_faces}; "
        f"f32 gallery capacity {hsnap.device_matrix.shape[0]} n_valid {hsnap.size}, built in "
        f"{h_setup_ms:.1f} ms")
    say(f"[hd] launches on the path {h_launches}")
    check(all(n > 0 for n in h_faces), "an hd request found no valid slot")
    check(h_launches["warp_rois"] == {112: REQUESTS, 96: REQUESTS, 192: REQUESTS},
          f"the hd path must launch K3 once a request at 112, 96 and 192: {h_launches}")
    check(h_launches["gallery_top1"] == sum(1 for faces, _ in h_results for fl in faces if fl)
          and h_launches["gallery_top1_int8"] == h_launches["fused_stem"] == 0,
          f"the hd path must launch K1 once a frame and neither K2 nor K4: {h_launches}")
    for faces, _ in h_results:
        for fl in faces:
            for face in fl:
                check(np.isfinite(face.bbox).all() and np.isfinite(face.kps).all(),
                      "non-finite box")
                check(abs(float(np.linalg.norm(face.normed_embedding)) - 1.0) < 1e-3,
                      "embedding norm")
                check(face.gender in (0, 1) and face.age is not None, f"gender {face.gender}")
                check(face.landmark_2d_106.shape == (106, 2)
                      and np.isfinite(face.landmark_2d_106).all(), "landmarks")
    # request 1's 106 landmarks are the landmark head's output on its 192 crops
    # mapped back through the crop affine: recomputed here from the crops, they
    # must agree.  A trained head regresses crop coordinates in [-1, 1], which
    # the 1.5x crop puts within 0.75 box sides of the box centre; the seeded
    # synthetic head's output is not bounded (its farthest landmark on an
    # all-black crop is printed, in box sides), so the share within 1.5 box
    # sides is reported, on the path's boxes and on boxes of 40-400 px inside
    # the frames, and the farthest in-frame face is recomputed by the float32
    # head on the CPU: the card's bf16 heads must put it as far.
    hd_dev = torch.from_numpy(hd_batch).to(dev)
    faces0 = [f for fl in h_results[0][0] for f in fl]
    h_boxes = torch.from_numpy(np.stack([f.bbox for f in faces0]).astype(np.float32)).to(dev)
    h_idx = torch.tensor([b for b, fl in enumerate(h_results[0][0]) for _ in fl], device=dev)
    lm_size = ATTR_SIZES[1]
    with torch.inference_mode():
        crops = warp2pass.warp_boxes_two_pass(hd_dev, h_idx, h_boxes, lm_size)
        lm_norm = hengine._ensure_attr_models()[1](genderage.preprocess(crops)).float()
        m_inv = warp2pass.boxes_to_affines(h_boxes, lm_size)
        lm_want = (torch.einsum("mij,mkj->mki", m_inv[:, :, :2], (lm_norm + 1.0) * lm_size / 2)
                   + m_inv[:, None, :, 2]).cpu().numpy()
    lm_path = np.stack([f.landmark_2d_106 for f in faces0])
    lm_err = float(np.abs(lm_path - lm_want).max() / max(1.0, np.abs(lm_want).max()))
    check(lm_err <= 1e-5, f"hd landmarks differ from the head's output mapped back: {lm_err}")

    def box_sides(boxes, lms):
        side = np.maximum(np.abs(boxes[:, 2] - boxes[:, 0]), np.abs(boxes[:, 3] - boxes[:, 1]))
        centre = np.stack([boxes[:, 0] + boxes[:, 2], boxes[:, 1] + boxes[:, 3]], 1) / 2
        return np.abs(lms - centre[:, None]).max(axis=(1, 2)) / np.maximum(side, 1e-6)

    path_sides = box_sides(np.stack([f.bbox for f in faces0]), lm_path)
    # how much of each box lies on its frame: what the HUD's fills cover
    in_frame = []
    for b, fl in enumerate(h_results[0][0]):
        fh, fw = HD_SHAPES[b]
        for f in fl:
            xs, ys = sorted(f.bbox[0::2]), sorted(f.bbox[1::2])
            cover = (max(0.0, min(xs[1], fw) - max(xs[0], 0.0))
                     * max(0.0, min(ys[1], fh) - max(ys[0], 0.0)))
            in_frame.append(cover / max((xs[1] - xs[0]) * (ys[1] - ys[0]), 1e-6))
    in_frame = np.asarray(in_frame)
    box_np, box_idx = in_frame_boxes(np.random.default_rng(6), len(faces0), HD_SHAPES)
    g_in, _, lm_in = hengine.attributes(hd_dev, box_idx, box_np)
    in_sides = box_sides(box_np, lm_in)
    check(set(np.unique(g_in)) <= {0, 1}, f"in-frame genders {np.unique(g_in)}")
    worst = int(np.argmax(in_sides))
    with torch.inference_mode():
        worst_crop = warp2pass.warp_boxes_two_pass(
            hd_dev, torch.tensor([int(box_idx[worst])], device=dev),
            torch.from_numpy(box_np[worst:worst + 1]).to(dev), lm_size).cpu()
        f32_head = load_or_init("landmark_2d_106", landmark106.Landmark106(), 8)
        worst_f32 = 0.75 * float(f32_head(genderage.preprocess(worst_crop)).abs().max())
        black_f32 = 0.75 * float(f32_head(genderage.preprocess(
            torch.zeros_like(worst_crop))).abs().max())
    check(abs(in_sides[worst] - worst_f32) <= 2.0 ** -5 * worst_f32,
          f"the farthest in-frame landmark: {in_sides[worst]:.4f} box sides on the card, "
          f"{worst_f32:.4f} from the float32 head on the CPU")
    lm_note = (f"landmarks = head output mapped back (rel err {lm_err:.1e}); within 1.5 box "
               f"sides of the centre: {float((in_sides <= 1.5).mean()):.3f} of {len(box_np)} "
               f"in-frame boxes (farthest {in_sides[worst]:.4f}, the f32 head on the CPU "
               f"{worst_f32:.4f}), {float((path_sides <= 1.5).mean()):.3f} of the path's "
               f"(max {path_sides.max():.3f}; an all-black crop {black_f32:.4f} from the f32 "
               f"head); the path's boxes lie {float(in_frame.mean()):.3f} "
               f"on their frames on average, {int((in_frame == 0).sum())} wholly off")
    k = 0
    for fl, rows in zip(h_results[0][0], h_results[0][1]):
        for row in rows:
            check(row["recognized"] and row["person_id"] == hown[k] and row["similarity"] >= 0.99,
                  f"hd request 1 face {hown[k]} matched {row['person_id']} at {row['similarity']}")
            k += 1
    drawn = sum(not np.array_equal(f, np.ascontiguousarray(g[..., ::-1]))
                for f, g in zip(hd_requests[0], rgb1))
    check(drawn == FRAMES, f"the HUD changed {drawn} of {FRAMES} frames")
    genders = np.bincount([f.gender for fl in h_results[0][0] for f in fl], minlength=2)
    say(f"[hd] request 1: {k}/{k} faces matched their own id through K1 (min score "
        f"{min(row['similarity'] for rows in h_results[0][1] for row in rows):.6f}); gender "
        f"counts {genders.tolist()}; {lm_note}; HUD drawn on {drawn}/{FRAMES} frames")
    if "--profile" in sys.argv[1:]:
        profile_request(torch, lambda: [hproc.match_faces(f, fl, "site-1", draw=True)
                                        for f, fl in zip(hd_requests[1],
                                                         happ.get_batch(hd_requests[1]))],
                        "hd request 2")

    # ------------------------------------------------- kernels vs plain, card
    roi = warp2pass.ROI

    def fused_vs_rois(atlas, windows, mats, rois, size, packed, what):
        """K3 read from the atlas, in both uint8 reads, against K3 on the ROIs
        cut out of it (bit for bit: the same taps on the same values) and
        against its plain version (<= 1e-3) -> max abs err."""
        want = warp_kernel.warp_rois(rois, mats, size)
        for variant in ("direct", "staged"):
            got = warp_kernel.warp_windows(atlas, windows, mats, size, packed=packed,
                                           variant=variant)
            check(torch.equal(got, want), f"K3 {what} out {size}: warp_windows ({variant}) "
                  f"differs from warp_rois on the extracted ROIs")
        err = float((got - warp_kernel.warp_windows_plain(atlas, windows, mats, size, packed))
                    .abs().max())
        check(err <= 1e-3, f"K3 {what} out {size} on the atlas: max abs err {err}")
        return err

    # K3 on the path's own faces: request 1's 256 slots, as get_batch warped
    # them, read from the uint8 atlas (the path's call) and, as before, on the
    # ROIs cut out of it
    canvases = np.stack([letterbox(f[..., ::-1], cfg.engine.det_size)[0] for f in requests[0]])
    frames_dev = torch.from_numpy(canvases).to(dev)
    n_frames, slots = FRAMES, cfg.engine.max_faces
    fidx = torch.arange(n_frames, device=dev).repeat_interleave(slots)
    with torch.inference_mode():
        det = engine._detect_impl(frames_dev, DET_THRESH)
        path_kps = det[2].reshape(n_frames * slots, 5, 2).float()
        path_minv = _invert_affine(umeyama_similarity(path_kps, engine._dst))
        path_lvl = warp2pass.pyramid_level(path_minv, cfg.engine.embed_size)
        path_rois, path_mats = warp2pass.extract_rois(frames_dev, fidx, path_kps,
                                                      cfg.engine.embed_size, dst=engine._dst)
    atlas_rgb, offs_rgb = warp2pass.build_atlas(frames_dev)
    path_win, path_wmats = warp2pass.roi_windows(offs_rgb, fidx, path_minv, cfg.engine.embed_size)
    check(torch.equal(path_wmats, path_mats), "K3 path: roi_windows' affines differ from "
          "extract_rois'")
    inside = ((path_kps[..., 0] >= 0) & (path_kps[..., 0] < FRAME_W)
              & (path_kps[..., 1] >= 0) & (path_kps[..., 1] < FRAME_H)).float().mean()
    path_err = float((warp_kernel.warp_rois(path_rois, path_mats)
                      - warp_kernel.warp_rois_plain(path_rois, path_mats)).abs().max())
    check(path_err <= 1e-3, f"K3 on the path's ROIs: max abs err {path_err}")
    path_err = max(path_err, fused_vs_rois(atlas_rgb, path_win, path_mats, path_rois, 112, False,
                                           "path faces"))
    path_px, path_clamped, path_apx = warp_footprint(torch, path_mats, roi, 112, path_win,
                                                     atlas_rgb.shape)
    say(f"[kernels] K3 path faces M={path_rois.shape[0]}: on the atlas bit-equal to K3 on the "
        f"extracted ROIs (direct and staged), max abs err {path_err:.3e} (<= 1e-3); pyramid "
        f"levels {torch.bincount(path_lvl, minlength=4).tolist()}; landmarks inside the "
        f"640x480 frame {float(inside):.4f}; output pixels with a clamped tap "
        f"{path_clamped:.4f}; ROI pixels read {path_px} of {path_rois.numel() // path_rois.shape[3]}"
        f", distinct atlas pixels {path_apx}")

    # K3 on in-canvas faces of the same frames, where the taps land inside the ROI
    face_kps = torch.from_numpy(in_canvas_kps(np.random.default_rng(4), n_frames * slots,
                                              dst=ARCFACE_DST)).to(dev)
    with torch.inference_mode():
        face_minv = _invert_affine(umeyama_similarity(face_kps, engine._dst))
        face_lvl = warp2pass.pyramid_level(face_minv, cfg.engine.embed_size)
        rois, mats = warp2pass.extract_rois(frames_dev, fidx, face_kps,
                                            cfg.engine.embed_size, dst=engine._dst)
    face_win, face_wmats = warp2pass.roi_windows(offs_rgb, fidx, face_minv, cfg.engine.embed_size)
    check(torch.equal(face_wmats, mats), "K3 in-canvas: roi_windows' affines differ")
    crops = warp_kernel.warp_rois(rois, mats)
    crops_plain = warp_kernel.warp_rois_plain(rois, mats)
    warp_err = float((crops - crops_plain).abs().max())
    check(warp_err <= 1e-3, f"K3 on in-canvas faces: max abs err {warp_err}")
    warp_err = max(warp_err, fused_vs_rois(atlas_rgb, face_win, mats, rois, 112, False,
                                           "in-canvas faces"))
    face_px, face_clamped, face_apx = warp_footprint(torch, mats, roi, 112, face_win,
                                                     atlas_rgb.shape)
    check(face_clamped < 0.5, f"K3 in-canvas faces: {face_clamped} of output pixels clamp")
    say(f"[kernels] K3 in-canvas faces M={rois.shape[0]} scales 0.5-4: on the atlas bit-equal "
        f"to K3 on the extracted ROIs, max abs err {warp_err:.3e} (<= 1e-3); pyramid levels "
        f"{torch.bincount(face_lvl, minlength=4).tolist()}; output pixels with a clamped "
        f"tap {face_clamped:.4f}; ROI pixels read {face_px} of {rois.numel() // rois.shape[3]}, "
        f"distinct atlas pixels {face_apx}")

    # K3 at the attribute heads' sizes: on the hd path's request-1 boxes, and on
    # boxes of 40-400 px inside its frames (the kernel line's inputs), from one
    # atlas of the native batch
    atlas_hd, offs_hd = warp2pass.build_atlas(hd_dev)
    attr_sets, attr_err = {}, {}
    for size in ATTR_SIZES:
        errs, lines = [], []
        for what, bx, bi in (("path boxes", h_boxes, h_idx),
                             ("in-frame boxes", torch.from_numpy(box_np).to(dev),
                              torch.from_numpy(box_idx).to(dev))):
            with torch.inference_mode():
                m_inv = warp2pass.boxes_to_affines(bx, size)
                lvl = warp2pass.pyramid_level(m_inv, size)
                r_, m_ = warp2pass.extract_rois_from_affines(hd_dev, bi, m_inv, size)
            w_, wm_ = warp2pass.roi_windows(offs_hd, bi, m_inv, size)
            check(torch.equal(wm_, m_), f"K3 out {size} {what}: roi_windows' affines differ")
            err = float((warp_kernel.warp_rois(r_, m_, size)
                         - warp_kernel.warp_rois_plain(r_, m_, size)).abs().max())
            check(err <= 1e-3, f"K3 out {size} on the {what}: max abs err {err}")
            err = max(err, fused_vs_rois(atlas_hd, w_, m_, r_, size, False, what))
            px, clamped, apx = warp_footprint(torch, m_, roi, size, w_, atlas_hd.shape)
            errs.append(err)
            lines.append(f"{what} M={r_.shape[0]} err {err:.3e}, levels "
                         f"{torch.bincount(lvl, minlength=4).tolist()}, clamped {clamped:.4f}, "
                         f"ROI px read {px}, atlas px {apx}")
            attr_sets[(size, what)] = (w_, m_, r_, px, apx, bi, m_inv)
        attr_err[size] = max(errs)
        say(f"[kernels] K3 out {size} on the atlas, bit-equal to K3 on the extracted ROIs "
            f"(<= 1e-3 of plain): " + "; ".join(lines))

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
    planted[TIE_ROW] = qb
    planted[last] = qb            # tie across chunks: 30,000 wins
    planted[CAPACITY_ROWS + 10] = 4 * qa   # past n_valid, in the last valid chunk
    planted[FAR_ROW] = 4 * qb               # past n_valid, far
    want_rows = torch.tensor([last - 9, TIE_ROW], dtype=torch.int32, device=dev)
    for dtype_name, gal in (("float32", planted), ("bfloat16", planted.bfloat16())):
        for bq in (1, 32, 256):
            q = torch.cat([torch.stack([qa, qb]), far])[:bq].contiguous()
            err, i = compare_top1(q, gal, CAPACITY_ROWS, dtype_name, f"planted B={bq}")
            top1_err[dtype_name] = max(top1_err[dtype_name], err)
            check(torch.equal(i[:2], want_rows[:bq]),
                  f"K1 {dtype_name} planted B={bq}: got {i[:2].tolist()}, "
                  f"want {want_rows[:bq].tolist()}")
    say(f"[kernels] K1 planted gallery: self-matches at rows {last - 9} (last chunk, tie with "
        f"{last - 4}) and {TIE_ROW} (tie with {last}) found in f32 and bf16 at B=1,32,256; rows "
        f"{CAPACITY_ROWS + 10} and {FAR_ROW} past n_valid never won; max abs err f32 "
        f"{top1_err['float32']:.2e} bf16 {top1_err['bfloat16']:.2e}")

    # K4 on request 1's packed frames of the yuv path, bf16 (the path's) and f32
    ypacks = yapp._stack_yuv([yapp.encode_frame(f) for f in requests[0]], CANVAS)
    ypacks = torch.from_numpy(ypacks).to(dev)
    black = torch.tensor(_YUV_BLACK, dtype=torch.uint8, device=dev)
    ypacks = torch.cat([ypacks, black.expand(FRAMES, CANVAS // 4 - ypacks.shape[1], CANVAS // 4, 24)], dim=1)
    x48 = yuv.yuv420p4_to_rgbp4(ypacks).contiguous()
    sw = yengine.stem_width
    stem_w = {"bfloat16": yengine.stem_weights,
              "float32": {k: v.to(dev) for k, v in stem_kernel.precompute_fused_stem(
                  load_or_init("scrfd_det_10g", scrfd.SCRFD(scrfd.CONFIGS["det_10g"]), 0),
                  torch.float32).items()}}
    small_sw = y_card.stem_width
    small_w = {"float32": y_card.stem_weights,
               "bfloat16": {k: v.to(dev) for k, v in stem_kernel.precompute_fused_stem(
                   load_or_init("scrfd_det_2.5g", scrfd.SCRFD(scrfd.CONFIGS["det_2.5g"]), 0),
                   torch.bfloat16).items()}}
    tiny_sw = scrfd.CONFIGS["det_500m"].stem_width
    tiny_w = {name: {k: v.to(dev) for k, v in stem_kernel.precompute_fused_stem(
        load_or_init("scrfd_det_500m", scrfd.SCRFD(scrfd.CONFIGS["det_500m"]), 0),
        getattr(torch, name)).items()} for name in ("bfloat16", "float32")}
    stem_err = {}

    def compare_stem(x, wts, width, dtype_name, what):
        got = stem_kernel.fused_stem_s2d4(x, wts, width).float()
        want = stem_kernel.fused_stem_plain(x, wts, width).float()
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        if dtype_name == "float32":
            # f32 summation order
            check(err <= 1e-4 * max(1.0, top), f"K4 f32 {what}: err {err} (max {top})")
        else:
            # each conv output is cast to bf16 after f32 sums in another order:
            # one bf16 step (2**-8 relative) can carry into the next conv
            same = float((got == want).float().mean())
            check(err <= 2.0 ** -6 * top and same >= 0.9,
                  f"K4 bf16 {what}: err {err} (max {top}), equal share {same}")
        return err, top

    for dtype_name in ("bfloat16", "float32"):
        err, top = compare_stem(x48, stem_w[dtype_name], sw, dtype_name, "B=8 640x640")
        stem_err[dtype_name] = err
        err2, _ = compare_stem(x48[:, :32, :16].contiguous(), small_w[dtype_name], small_sw,
                               dtype_name, "B=8 128x64 sw=12")
        err3, _ = compare_stem(x48[:, :9, :11].contiguous(), tiny_w[dtype_name], tiny_sw,
                               dtype_name, "B=8 36x44 sw=8")
        say(f"[kernels] K4 {dtype_name}: B=8 640x640 sw={sw} on request 1's packed frames max "
            f"abs err {err:.3e} (outputs up to {top:.3f}); 128x64 sw={small_sw} {err2:.3e}; "
            f"36x44 sw={tiny_sw} {err3:.3e}")

    # K3 on the packed atlas of request 1's yuv frames: the yuv path's own faces
    # and the in-canvas faces, read from the packed uint8 atlas against K3 on
    # the unpacked ROIs
    with torch.inference_mode():
        ydet = yengine._detect_packed_impl(x48, DET_THRESH)
        y_kps = ydet[2].reshape(n_frames * slots, 5, 2).float()
        y_minv = _invert_affine(umeyama_similarity(y_kps, yengine._dst))
    atlas_p, offs_p = warp2pass.build_atlas_packed(x48)
    packed_sets, lines, packed_err = {}, [], 0.0
    for what, minv in (("path faces", y_minv), ("in-canvas faces", face_minv)):
        w_, m_ = warp2pass.roi_windows_packed(offs_p, fidx, minv, 112)
        r_ = warp2pass.unpack_roi4(warp_kernel.gather_windows(atlas_p, w_, roi // 4))
        r_ = r_.float().contiguous()
        err = fused_vs_rois(atlas_p, w_, m_, r_, 112, True, f"packed {what}")
        px, clamped, apx = warp_footprint(torch, m_, roi, 112, w_, atlas_p.shape, packed=True)
        packed_sets[what] = (w_, m_, r_, px, apx, minv)
        packed_err = max(packed_err, err)
        lines.append(f"{what} M={r_.shape[0]} err {err:.3e}, clamped {clamped:.4f}, ROI px read "
                     f"{px}, atlas px {apx}")
    say(f"[kernels] K3 packed out 112 on the atlas, bit-equal to K3 on the unpacked ROIs "
        f"(<= 1e-3 of plain): " + "; ".join(lines))

    # the warp entry points on the card allocate no ROI stack: no aten op under
    # them returns a [M, 192, 192, *] or [M, 48, 48, *] tensor (the crops are
    # the one empty [M, out, out, 3] the wrapper allocates), and each launches
    # K3 once
    from torch.utils._python_dispatch import TorchDispatchMode

    class Outputs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.seen.append((str(func), tuple(t.shape)))
            return out

    roi_checks = []
    for name, size, call in (
            ("warp_faces_two_pass", 112, lambda: warp2pass.warp_faces_two_pass(
                frames_dev, fidx, path_kps, 112, dst=engine._dst)),
            ("warp_boxes_two_pass", 96, lambda: warp2pass.warp_boxes_two_pass(
                hd_dev, h_idx, h_boxes, 96)),
            ("warp_boxes_two_pass", 192, lambda: warp2pass.warp_boxes_two_pass(
                hd_dev, h_idx, h_boxes, 192)),
            ("warp_faces_two_pass_packed", 112, lambda: warp2pass.warp_faces_two_pass_packed(
                x48, fidx, y_kps, 112, dst=yengine._dst))):
        before = warp_kernel.warp_rois.launches
        with torch.inference_mode(), Outputs() as seen:
            out_crops = call()
        torch.cuda.synchronize()
        m_ = out_crops.shape[0]
        stacks = [(op, shape) for op, shape in seen.seen if len(shape) == 4 and shape[0] == m_
                  and shape[1:3] in ((roi, roi), (roi // 4, roi // 4))
                  and not op.startswith("aten.empty")]
        check(not stacks, f"{name} out {size} formed a ROI tensor on the card: {stacks}")
        check(warp_kernel.warp_rois.launches == before + 1, f"{name}: K3 launches "
              f"{warp_kernel.warp_rois.launches - before} a call")
        roi_checks.append(f"{name} {size} ({len(seen.seen)} ops)")
    say(f"[kernels] K3 on the card path forms no ROI tensor and launches once a call: "
        f"{', '.join(roi_checks)}")

    # K2 on the yuv path's int8 gallery, queried with requests 2-3's embeddings
    g8 = ysnap.device_matrix
    gs = ysnap.int8_scale
    yfar = torch.from_numpy(np.stack([fc.normed_embedding for faces, _ in y_results[1:]
                                      for fl in faces for fc in fl])[:256]).to(dev)

    def compare_int8(q, gal, n_valid, what):
        v, i = match_kernel.gallery_top1_int8(q, gal, gs, n_valid)
        pv, pi = match_kernel.gallery_top1_int8_plain(q, gal, gs, n_valid)
        check(torch.equal(i, pi) and torch.equal(v, pv), f"K2 {what}: differs from plain")
        return i

    int8_bs = (1, 32, 64, 128, 256)
    for bq in int8_bs:
        i = compare_int8(yfar[:bq].contiguous(), g8, CAPACITY_ROWS, f"B={bq}")
    for bq in int8_bs:
        v, i0 = match_kernel.gallery_top1_int8(yfar[:bq].contiguous(), g8, gs, 0)
        check(bool(torch.all(v == float("-inf"))) and bool(torch.all(i0 == 0)),
              f"K2 n_valid=0 B={bq}")
    # K2's chunking: the 32-row unit a warp holds in registers
    i8_chunk = build.lib().fre_gallery_top1_int8_rows_per_block()
    say(f"[kernels] K2 path int8 gallery N={g8.shape[0]} n_valid={CAPACITY_ROWS}, requests 2-3 "
        f"as queries B={','.join(map(str, int8_bs))}: ids and values equal to plain; top-1 rows "
        f"{int(i.min())}..{int(i.max())} in {i.div(i8_chunk, rounding_mode='floor').unique().numel()}"
        f" of {-(-CAPACITY_ROWS // i8_chunk)} {i8_chunk}-row chunks; n_valid=0 -> -inf")
    # one device kernel a call, with no copy or memset, at every form of the launch
    for bq in (1, 32, 256):
        qq = yfar[:bq].contiguous()
        ev = device_kernels(torch, lambda: match_kernel.gallery_top1_int8(qq, g8, gs, CAPACITY_ROWS))
        check(len(ev) == 1 and ev[0][1] == 1 and "top1_int8" in ev[0][0],
              f"K2 B={bq}: device events of one call {ev}")
    say(f"[kernels] K2 one device kernel a call at B=1,32,256: {ev[0][0][:60]}")
    qa8 = torch.clamp(torch.round(qa / gs), -127, 127).to(torch.int8)
    qb8 = torch.clamp(torch.round(qb / gs), -127, 127).to(torch.int8)
    planted8 = g8.clone()
    planted8[last - 9] = qa8
    planted8[last - 4] = qa8           # tie inside the last chunk: last - 9 wins
    planted8[TIE_ROW] = qb8
    planted8[last] = qb8               # tie across chunks: 30,000 wins
    planted8[CAPACITY_ROWS + 10] = (127 * torch.sign(qa)).to(torch.int8)  # past n_valid
    planted8[FAR_ROW] = (127 * torch.sign(qb)).to(torch.int8)
    for bq in int8_bs:
        q = torch.cat([torch.stack([qa, qb]), yfar])[:bq].contiguous()
        i = compare_int8(q, planted8, CAPACITY_ROWS, f"planted B={bq}")
        check(torch.equal(i[:2], want_rows[:bq]),
              f"K2 planted B={bq}: got {i[:2].tolist()}, want {want_rows[:bq].tolist()}")
    unit_of = {row: row // i8_chunk for row in (last - 9, last - 4, TIE_ROW, last,
                                                CAPACITY_ROWS + 10)}
    check(unit_of[last - 9] == unit_of[last - 4] == unit_of[CAPACITY_ROWS + 10]
          == (CAPACITY_ROWS - 1) // i8_chunk and unit_of[TIE_ROW] != unit_of[last],
          f"K2 planted rows do not fall in the chunks their ties need: {unit_of}")
    say(f"[kernels] K2 planted int8 gallery: self-matches at rows {last - 9} and {TIE_ROW} "
        f"(ties with {last - 4} in the same, last valid {i8_chunk}-row chunk "
        f"{unit_of[last - 9]}, and with {last} in chunk {unit_of[last]} against "
        f"{unit_of[TIE_ROW]}) found at B={','.join(map(str, int8_bs))}; rows "
        f"{CAPACITY_ROWS + 10} (chunk {unit_of[CAPACITY_ROWS + 10]}) and {FAR_ROW} past n_valid "
        f"never won; ids and values equal to plain")

    # the yuv mix on the card against the CPU on every (Y, U, V) triple
    u_, v_, g_ = np.meshgrid(np.arange(256), np.arange(256), np.arange(16), indexing="ij")
    triples = np.empty(u_.shape + (24,), np.uint8)
    triples[..., :16] = g_[..., None] * 16 + np.arange(16)
    triples[..., 16:20] = u_[..., None]
    triples[..., 20:24] = v_[..., None]
    triples = torch.from_numpy(triples.reshape(-1, 24))
    mix_diff = (yuv.yuv420p4_to_rgbp4(triples.to(dev)).cpu().int()
                - yuv.yuv420p4_to_rgbp4(triples).int()).abs()
    check(int(mix_diff.max()) <= 1, f"yuv mix card vs CPU: max diff {int(mix_diff.max())}")
    say(f"[kernels] yuv mix card vs CPU on all 2**24 (Y,U,V) triples: {int((mix_diff > 0).sum())}"
        f" of {mix_diff.numel()} u8 values differ (by at most 1)")

    # ----------------------------------------------------------------- times
    # K3 as the paths call it: read from the uint8 atlas (raw or packed).  The
    # in-canvas faces (112) and the in-frame boxes (96, 192) are the kernel
    # lines' inputs; the paths' own faces and boxes (taps mostly clamped) are
    # timed beside them (path_ms).  bound_ms counts the distinct atlas bytes
    # the taps read, the windows and affines, and the crops written;
    # bound_ms_f32_rois counts the float32 ROI pixels the taps read instead
    # (the kernel on extracted ROIs: ms_f32_rois).  step_ms is the window
    # arithmetic and K3 on the atlas; step_ms_unfused the same arithmetic, the
    # ROIs cut out of the atlas (float32, unpacked) and K3 on them, i.e.
    # extract_rois* without the atlas build (atlas_ms); the two in turns.
    c = 3

    def k3_times(atlas, offsets, fidx_, minv, win, mats_, rois_, px, apx, size, packed, frames_):
        m_ = win.shape[0]
        wfn = warp2pass.roi_windows_packed if packed else warp2pass.roi_windows
        build_fn = warp2pass.build_atlas_packed if packed else warp2pass.build_atlas

        def fused():
            w, mm = wfn(offsets, fidx_, minv, size)
            return warp_kernel.warp_windows(atlas, w, mm, size, packed=packed)

        def unfused():
            w, mm = wfn(offsets, fidx_, minv, size)
            r = warp_kernel.gather_windows(atlas, w, roi // 4 if packed else roi)
            r = warp2pass.unpack_roi4(r) if packed else r
            return warp_kernel.warp_rois(r.float().contiguous(), mm, size)

        def call(variant="direct"):
            return lambda: warp_kernel.warp_windows(atlas, win, mats_, size, packed=packed,
                                                    variant=variant)

        def on_rois():
            return warp_kernel.warp_rois(rois_, mats_, size)

        step, step_unfused = in_turns(torch, fused, unfused)
        ops = m_ * size * size * (30 + 10 * c)
        crops = m_ * size * size * c * 4
        bnd, by = bound(apx * c + m_ * (12 + 24) + crops, ops, "float32")
        return {"ms": time_ms(torch, call(), 50), "kernel_device_ms": device_ms(torch, call()),
                "kernel_device_ms_staged": device_ms(torch, call("staged")),
                "ms_f32_rois": time_ms(torch, on_rois, 50),
                "kernel_device_ms_f32_rois": device_ms(torch, on_rois),
                "plain_ms": time_ms(torch, lambda: warp_kernel.warp_windows_plain(
                    atlas, win, mats_, size, packed), 3, 1),
                "bound_ms": bnd, "bound_by": by,
                "bound_ms_f32_rois": bound(4 * (px * c + m_ * 6) + crops, ops, "float32")[0],
                "step_ms": step, "step_ms_unfused": step_unfused,
                "atlas_ms": time_ms(torch, lambda: build_fn(frames_), 20)}

    def k3_path(atlas, win, mats_, apx, size, packed):
        m_ = win.shape[0]
        return {"path_ms": time_ms(torch, lambda: warp_kernel.warp_windows(
                    atlas, win, mats_, size, packed=packed), 50),
                "path_bound_ms": bound(apx * c + m_ * (12 + 24) + m_ * size * size * c * 4,
                                       m_ * size * size * (30 + 10 * c), "float32")[0]}

    k3 = {112: {**k3_times(atlas_rgb, offs_rgb, fidx, face_minv, face_win, mats, rois, face_px,
                           face_apx, 112, False, frames_dev),
                **k3_path(atlas_rgb, path_win, path_mats, path_apx, 112, False)}}
    for size in ATTR_SIZES:
        w_, m_, r_, px, apx, bi, minv = attr_sets[(size, "in-frame boxes")]
        pw, pm, _, _, papx, _, _ = attr_sets[(size, "path boxes")]
        k3[size] = {**k3_times(atlas_hd, offs_hd, bi, minv, w_, m_, r_, px, apx, size, False,
                               hd_dev),
                    **k3_path(atlas_hd, pw, pm, papx, size, False)}
    w_, m_, r_, px, apx, minv = packed_sets["in-canvas faces"]
    pw, pm, _, _, papx, _ = packed_sets["path faces"]
    k3["packed"] = {**k3_times(atlas_p, offs_p, fidx, minv, w_, m_, r_, px, apx, 112, True, x48),
                    **k3_path(atlas_p, pw, pm, papx, 112, True)}
    path_b = 32  # match_faces matches one frame's 32 slots, bucketed to 32
    q = far[:path_b].contiguous()
    valid_cols = torch.arange(gal32.shape[0], device=dev) < CAPACITY_ROWS

    def library_top1(gal, qq):
        s = torch.where(valid_cols, qq.to(gal.dtype) @ gal.T, float("-inf"))
        return torch.topk(s, 1)

    times, dev_times, lib_times = {}, {}, {}
    for dtype_name, gal in (("float32", gal32), ("bfloat16", gal16)):
        for bq in (1, 32, 256):
            qq = far[:bq].contiguous()
            times[(dtype_name, bq)] = time_ms(
                torch, lambda: match_kernel.gallery_top1(qq, gal, CAPACITY_ROWS), 50)
            dev_times[(dtype_name, bq)] = device_ms(
                torch, lambda: match_kernel.gallery_top1(qq, gal, CAPACITY_ROWS))
            lib_times[(dtype_name, bq)] = time_ms(torch, lambda: library_top1(gal, qq), 20)

    def top1_uncached():  # the wrapper as it was before its scratch cache
        match_kernel._scratch.clear()
        match_kernel._entries.clear()
        return match_kernel.gallery_top1(far[:1], gal32, CAPACITY_ROWS)

    top1_uncached_ms = time_ms(torch, top1_uncached, 50)
    top1_plain_ms = time_ms(torch, lambda: match_kernel.gallery_top1_plain(q, gal32, CAPACITY_ROWS), 20)
    top1_lib_ms = lib_times[("float32", path_b)]
    top1_bound, top1_by = bound(CAPACITY_ROWS * 512 * 4 + path_b * 512 * 4 + path_b * 8,
                                2 * path_b * CAPACITY_ROWS * 512, "float32")

    # K2 at the yuv path's B = 32 (and 1, 64, 128, 256); library: torch._int_mm + mask +
    # max; cuBLASLt int8 needs more than 16 rows, so below 17 the library is timed on
    # the queries zero-padded to 32 rows.  kernel_device_ms is taken over back-to-back
    # calls, as the path makes its 8 a request (the 25.6 MB gallery can stay in the
    # 50 MB L2); kernel_device_ms_cold reads a 256 MB buffer before every call, which
    # evicts it.
    def library_top1_int8(qq):
        q_int, _ = match_kernel.quantize_queries(qq)
        raw = torch._int_mm(q_int, g8.t())
        return torch.where(valid_cols, raw, torch.iinfo(torch.int32).min).max(dim=1)

    evict = torch.zeros(256 * 2**20 // 4, device=dev)
    int8_times, int8_dev, int8_cold, int8_lib, int8_lib_rows = {}, {}, {}, {}, {}
    for bq in int8_bs:
        qq = yfar[:bq].contiguous()
        int8_times[bq] = time_ms(
            torch, lambda: match_kernel.gallery_top1_int8(qq, g8, gs, CAPACITY_ROWS), 50)
        int8_dev[bq] = device_ms(
            torch, lambda: match_kernel.gallery_top1_int8(qq, g8, gs, CAPACITY_ROWS))
        int8_cold[bq] = kernel_ms(
            torch, lambda: match_kernel.gallery_top1_int8(qq, g8, gs, CAPACITY_ROWS),
            "top1_int8", before=evict.sum)
        int8_lib_rows[bq] = 32 if bq <= 16 else bq
        ql = torch.cat([qq, qq.new_zeros(int8_lib_rows[bq] - bq, 512)])
        int8_lib[bq] = time_ms(torch, lambda: library_top1_int8(ql), 20)
    del evict
    q8 = yfar[:path_b].contiguous()
    int8_plain_ms = time_ms(
        torch, lambda: match_kernel.gallery_top1_int8_plain(q8, g8, gs, CAPACITY_ROWS), 20)

    def int8_bound(bq):
        return bound(CAPACITY_ROWS * 512 + bq * 512 + bq * 8, 2 * bq * CAPACITY_ROWS * 512, "int8")

    # K4 at the yuv path's shape (B = 8, 640x640, det_10g), bf16 and f32; library:
    # the port's cuDNN stem (stem1 -> stem2 -> stem3 ConvBN + max_pool2d, channels_last,
    # same dtype) -- four calls, not one
    def stem_bound(x, width, dtype_name):
        b_, h4, w4, _ = x.shape
        macs = b_ * (2 * h4) * (2 * w4) * (27 * width + 9 * width * width + 18 * width * width)
        esize = 4 if dtype_name == "float32" else 2
        wbytes = (27 * width + 9 * width * width + 18 * width * width) * esize + 4 * 4 * width
        return bound(x.numel() + b_ * h4 * w4 * 2 * width * esize + wbytes, 2 * macs, dtype_name)

    bb = yengine.detector.backbone
    x_nchw = ((stem_kernel.depth_to_space4(x48).float() - 127.5) / 128.0).to(yengine.dtype)
    x_nchw = x_nchw.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    def library_stem():
        with torch.inference_mode():
            return torch.nn.functional.max_pool2d(bb.stem3(bb.stem2(bb.stem1(x_nchw))), 3, 2, 1)

    stem_times = {name: time_ms(torch, lambda: stem_kernel.fused_stem_s2d4(x48, stem_w[name], sw),
                                20) for name in ("bfloat16", "float32")}
    stem_dev = {name: device_ms(torch, lambda: stem_kernel.fused_stem_s2d4(x48, stem_w[name], sw),
                                10) for name in ("bfloat16", "float32")}
    stem_plain_ms = time_ms(torch, lambda: stem_kernel.fused_stem_plain(x48, stem_w["bfloat16"], sw),
                            5, 1)
    stem_lib_ms = time_ms(torch, library_stem, 20)
    stem_bnd, stem_by = stem_bound(x48, sw, "bfloat16")

    def k3_entry(name, size, n_launches, err, t, **extra):
        return {"name": name, "route": "cuda", "source": WARP_SRC,
                "replaces": "facerecognition_infrenceengine_tpu/ops/warp_pallas.py:115",
                "launches": n_launches, "max_abs_err": err, "library_ms": None,
                "out_size": size, **t, **extra}

    kernels = [
        k3_entry("warp_rois", 112, launches["warp_rois"] + h_launches["warp_rois"].get(112, 0),
                 max(warp_err, path_err), k3[112]),
    ] + [
        k3_entry(f"warp_rois_out{size}", size, h_launches["warp_rois"].get(size, 0),
                 attr_err[size], k3[size])
        for size in ATTR_SIZES
    ] + [
        k3_entry("warp_windows_packed", 112, y_launches["warp_rois"], packed_err, k3["packed"],
                 packed=True),
        {"name": "gallery_top1", "route": "cuda", "source": MATCH_SRC,
         "replaces": "facerecognition_infrenceengine_tpu/ops/match_pallas.py:79",
         "launches": launches["gallery_top1"] + y_launches["gallery_top1"]
         + h_launches["gallery_top1"],
         "max_abs_err": top1_err["float32"],
         "ms": times[("float32", path_b)], "kernel_device_ms": dev_times[("float32", path_b)],
         "plain_ms": top1_plain_ms, "bound_ms": top1_bound,
         "bound_by": top1_by, "library_ms": top1_lib_ms,
         "library_ms_bf16": lib_times[("bfloat16", path_b)]},
        {"name": "gallery_top1_int8", "route": "cuda", "source": MATCH_INT8_SRC,
         "replaces": "facerecognition_infrenceengine_tpu/ops/match_pallas.py:235",
         "launches": y_launches["gallery_top1_int8"], "max_abs_err": 0.0,
         "ms": int8_times[path_b], "kernel_device_ms": int8_dev[path_b],
         "kernel_device_ms_cold": int8_cold[path_b], "plain_ms": int8_plain_ms,
         "bound_ms": int8_bound(path_b)[0], "bound_by": int8_bound(path_b)[1],
         "library_ms": int8_lib[path_b]},
        {"name": "fused_stem", "route": "cuda", "source": STEM_SRC,
         "replaces": "facerecognition_infrenceengine_tpu/ops/stem_pallas.py:258",
         "launches": y_launches["fused_stem"], "max_abs_err": stem_err["bfloat16"],
         "ms": stem_times["bfloat16"], "kernel_device_ms": stem_dev["bfloat16"],
         "plain_ms": stem_plain_ms, "bound_ms": stem_bnd,
         "bound_by": stem_by, "library_ms": stem_lib_ms},
    ]
    variants = []
    for (dtype_name, bq), ms in times.items():
        esize = 4 if dtype_name == "float32" else 2
        bnd, by = bound(CAPACITY_ROWS * 512 * esize + bq * 512 * esize + bq * 8,
                        2 * bq * CAPACITY_ROWS * 512, dtype_name)
        variants.append({"name": "gallery_top1", "dtype": dtype_name, "B": bq, "ms": ms,
                         "kernel_device_ms": dev_times[(dtype_name, bq)], "bound_ms": bnd,
                         "bound_by": by, "library_ms": lib_times[(dtype_name, bq)]})
        if (dtype_name, bq) == ("float32", 1):
            variants[-1]["ms_uncached"] = top1_uncached_ms
    for bq, ms in int8_times.items():
        bnd, by = int8_bound(bq)
        variants.append({"name": "gallery_top1_int8", "dtype": "int8", "B": bq, "ms": ms,
                         "kernel_device_ms": int8_dev[bq],
                         "kernel_device_ms_cold": int8_cold[bq], "bound_ms": bnd,
                         "bound_by": by, "library_ms": int8_lib[bq],
                         "library_rows": int8_lib_rows[bq]})
    for dtype_name, ms in stem_times.items():
        bnd, by = stem_bound(x48, sw, dtype_name)
        variants.append({"name": "fused_stem", "dtype": dtype_name, "B": FRAMES,
                         "hw": [CANVAS, CANVAS], "stem_width": sw, "ms": ms,
                         "kernel_device_ms": stem_dev[dtype_name], "bound_ms": bnd,
                         "bound_by": by, "max_abs_err": stem_err[dtype_name]})
    say(f"[times] {card} | K1 f32 B={path_b}: "
        f"{times[('float32', path_b)]:.4f} ms, device {dev_times[('float32', path_b)]:.4f} ms "
        f"(plain {top1_plain_ms:.4f}, library {top1_lib_ms:.4f}, bound "
        f"{top1_bound * 1e3:.2f} us by {top1_by}); bf16 {times[('bfloat16', path_b)]:.4f} ms, "
        f"device {dev_times[('bfloat16', path_b)]:.4f} ms (library "
        f"{lib_times[('bfloat16', path_b)]:.4f}); B=1 f32 {times[('float32', 1)]:.4f} ms, "
        f"uncached {top1_uncached_ms:.4f} ms")
    say(f"[times] {card} | K2 B={path_b}: {int8_times[path_b]:.4f} ms, device "
        f"{int8_dev[path_b]:.4f} ms, L2 evicted {int8_cold[path_b]:.4f} ms (plain "
        f"{int8_plain_ms:.4f}, library {int8_lib[path_b]:.4f}, bound "
        f"{int8_bound(path_b)[0] * 1e3:.2f} us by {int8_bound(path_b)[1]}) | K4 bf16 B=8 "
        f"640x640: {stem_times['bfloat16']:.4f} ms (device {stem_dev['bfloat16']:.4f}), f32 "
        f"{stem_times['float32']:.4f} ms (plain "
        f"{stem_plain_ms:.3f}, cuDNN stem {stem_lib_ms:.4f}, bound {stem_bnd * 1e3:.2f} us by "
        f"{stem_by})")
    say(json.dumps({"variants": variants}))
    say(json.dumps({"path": {"card": card, "requests": REQUESTS, "frames_per_request": FRAMES,
                             "request_ms": request_ms, "faces_per_request": faces_per_request,
                             "gallery_setup_ms": setup_ms, "peak_memory_mb": peak_mb,
                             "launches": launches}}))
    say(json.dumps({"yuv_path": {"card": card, "requests": REQUESTS, "frames_per_request": FRAMES,
                                 "request_ms": y_ms, "faces_per_request": y_faces,
                                 "gallery_setup_ms": y_setup_ms, "peak_memory_mb": y_peak_mb,
                                 "launches": y_launches, "int8_faces_compared": compared,
                                 "request1_under_margin": under_margin}}))
    say(json.dumps({"hd_path": {"card": card, "requests": REQUESTS, "frames": HD_SHAPES,
                                "request_ms": h_ms, "get_batch_ms": h_get_ms,
                                "match_and_hud_ms": h_match_ms, "faces_per_request": h_faces,
                                "gallery_setup_ms": h_setup_ms, "peak_memory_mb": h_peak_mb,
                                "launches": h_launches, "letterbox8_ms": lb_ms,
                                "letterbox8_plain_ms": lb_plain_ms, "yuv_encode8_ms": enc_ms,
                                "yuv_encode8_numpy_ms": enc_plain_ms,
                                "host_codec_jpeg": native_jpeg}}))
    for key, t in k3.items():
        say(f"[times] {card} | K3 {'packed 112' if key == 'packed' else key} on the atlas: "
            f"{t['ms']:.4f} ms, device {t['kernel_device_ms']:.4f} (the direct read; staged "
            f"{t['kernel_device_ms_staged']:.4f}), "
            f"bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} "
            f"({100 * t['bound_ms'] / t['kernel_device_ms']:.0f}%); on f32 ROIs "
            f"{t['ms_f32_rois']:.4f} ms, device {t['kernel_device_ms_f32_rois']:.4f} (bound "
            f"{t['bound_ms_f32_rois'] * 1e3:.2f} us); step {t['step_ms']:.4f} ms against "
            f"{t['step_ms_unfused']:.4f} unfused, atlas build {t['atlas_ms']:.4f}; path "
            f"{t['path_ms']:.4f} ms (bound {t['path_bound_ms'] * 1e3:.2f} us); plain "
            f"{t['plain_ms']:.3f} ms")
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
