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
6. mfn path: FaceAnalysis("mobile_facenet_v1", allowed_modules=
   ("detection", "recognition")), det_10g + MobileFaceNet (full width) in
   bf16, serves the rgb path's 3 requests, then match_faces against an f32
   gallery (capacity 65,536, n_valid 50,000: request 1's faces plus seeded
   distractors).  Every face of request 1 finds its own id at >= 0.99; K3
   launches once a request and K1 once a frame; a det_2.5g + MobileFaceNet
   f32 engine embeds request 1's faces on the card and on the CPU within
   1 - cos 1e-4.  Wall and device ms a request, beside the r50 rgb path's.
7. onnx path: the synthetic genderage / landmark heads (seeds 7 and 8)
   written as buffalo_l-shaped ONNX graphs (models/onnx_export.head_graph:
   Sub/Div, Conv + BatchNormalization + PRelu stages, a batch-1 Reshape)
   into a temporary FRE_WEIGHTS_DIR; FaceAnalysis("buffalo_l") with its
   default modules picks the exact-graph runners (sizes 96 and 192) and
   serves 2 requests of the rgb frames: K3 once a request at 112, 96 and
   192; request 1's gender, age and landmarks equal the float32 nn.Module
   heads' on the same K3 crops (gender wherever the logits differ by more
   than 1e-4, age within 1, landmarks within 1e-3 px).  The attribute
   call's device ms, exact graphs (f32) against the synthetic heads (bf16).
7b. [convert]: tools/synthetic_pack.make_pack (det_10g, w600k_r50 and
   w600k_mbf as torch mirrors at their published widths, random weights,
   plus three attribute graphs; exported by the TorchScript exporter)
   converted on this host by models/convert_onnx.convert (no JAX) into a
   temporary FRE_WEIGHTS_DIR; the port's f32 det_10g (640x640), r50 and
   MobileFaceNet with the converted leaves against the mirrors on the card
   (1 - cos 1e-5; atol 1e-4 normalized, det atol / rtol 1e-3);
   FaceAnalysis("buffalo_l", detection + recognition) in bf16 serves the
   pack on the rgb path's 3 requests and matches request 1's faces against
   an f32 gallery (K3, K1), runs the pack's exact-graph heads once (K3 at
   96 and 192) against the mirror heads, and its embeddings lie within
   1 - cos 1e-3 of an f32 engine on the same crops; then the ops surface:
   warp_faces on the card within 1e-4 of the CPU, K3 against
   warp_faces at 0, 10, -20 and 30 degrees within tests/test_ops_warp2pass.py's
   budgets, cosine_scores within 1e-5 of a float64 product.  The
   convert_path line: the host seconds of the pack and the conversion,
   the tensors written, request wall and device ms.
8. gallery: 50,000 employees (request 1's rgb-path embeddings plus seeded
   distractors) written into a memory:// Datastore in bulk, as the
   enrollment worker writes them (one GridFS put a person, one
   insert_many); GalleryManager(ds, cfg) f32 (K1) and int8 (K2) load it;
   every face of request 1 finds its own id at >= 0.99 through
   match(company_id=...), and K2's ids and scores equal the plain int8
   version's.  A second store of 2,000 gets 10 appended, 10 archived
   (update_many) and 5 hard-deleted, then force_sync: no snapshot rebuilt,
   exact stats, no removed id returned, every appended person matches
   itself; start_sync / stop_sync pick one more up on the sync thread.
   Host times: the write, the initial loads, the snapshot builds, the first
   matches and force_sync.
9. kernels vs their plain PyTorch versions, on the card, at the paths'
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
10. times: `ms` is the wrapper call as the path makes it, CUDA events over
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
   The epilogue kernel (csrc/epilogue.cu), bf16: every variant that
   IResNet's serving forward launches (BN in place and into a second
   tensor, BN + PReLU, BN + r, BN + BN(r)) bit-equal to its plain version
   at each of IResNet-50's eight (channels, side) shapes, at the main
   path's crop count (FRAMES x max_faces); then BN + PReLU and BN + BN(r)
   at the 112x112 stage (B = 1,024, 64 channels) timed against the plain
   version and against ATen's separate passes (`library_ms`), its bound
   the bytes read and written (`epilogue_phase`, also run alone:
   ``python3 -c "import chip_smoke; chip_smoke.epilogue_main()"``).  The
   kernels row's `launches` are the [path] requests' own.
   The ViT's residual add + LayerNorm kernel (csrc/layernorm.cu) at ViT-L's
   served residual stream (1,024 crops x 144 tokens x 768): in bf16 and f32
   both forms' stream bit-equal to ATen's add and their LayerNorm within a
   rounding of F.layer_norm (one bf16 ulp; f32 2e-6 at unit scale); then the
   fused form (x += a, the LayerNorm into a's buffer) and the plain
   LayerNorm form timed in bf16 against their bytes, the plain version and
   ATen's add + layer_norm (`layernorm_phase`, also run alone:
   ``python3 -c "import chip_smoke; chip_smoke.layernorm_main()"``).
   [vit]: FaceEngine(rec_arch="vit_l") in bf16 at published widths embeds
   a vit_l.crowd batch (1,024 aligned crops) through the engine's embedder
   path (vit.serve_forward) VIT_FORWARDS times; the kernel's launch count,
   zeroed just before, must read 49 a forward (48 fused, block 0's norm1
   plain), and the embeddings are held to the module forward on the same
   crops under 1 - cos VIT_GAP (`vit_phase`, also run alone:
   ``python3 -c "import chip_smoke; chip_smoke.vit_main()"``).  The
   kernels row's `launches` are the [vit] forwards' own.
10b. [mesh] (after the gallery phase): the sharded gallery and
   make_sharded_fused over a mesh of the distinct cards, or of cuda:0 named
   8 times (data 2 x gallery 4) on one card.  The gallery phase's 50,000
   persons in f32, bf16 and int8 through GalleryManager(mesh=...) against
   the same manager without a mesh at B = 1, 32, 256: k = 1 ids identical,
   scores within 1e-5 (f32, bf16) / 2e-2 (int8), K1 or K2 once a shard;
   k = 3 ids identical at every rank clear of its neighbours; each shard's
   kernel against the plain per-shard merge on the CPU.  Then
   make_sharded_fused("raw", "flat" on the rgb engine, "yuv_flat" on the
   yuv engine with K4) on request 1's 8 frames: every data shard bit-equal
   to the unsharded engine on its own frames, its outputs on its device.
10c. [train]: engine/training.py on IResNet-50 at full width (112x112,
   f32, TF32 off), B = 128, 93,431 classes (MS1MV3's identity count): one
   step against the same step on a data 2 x gallery 2 mesh, fit over 20
   steps (the loss falls; step ms, images/s, peak memory, the step's FLOPs
   and f32 bound; the step with TF32 on, timed only), the checkpoint round
   trip bit for bit, and a resumed
   run against the uninterrupted one with cudnn.deterministic on.
11. [int8] (after the kernels' own traces): the opt-in scale modes at
   buffalo_l's full width (det_10g + r50, bf16, 640x640, max_faces 32,
   pre_nms_topk 512), each variant FaceAnalysis.get_batch + match_faces
   (K3 at 112, K1 f32 on the phase's gallery: variant a's request 1 plus
   seeded distractors) on the rgb path's 3 requests: a embed_int8, b
   det_int8, c both, d packed_stem, e stream_transport="yuv420" with
   packed_stem_impl="xla" (K3 on the packed atlas).  Gates: int8_conv2d_nhwc
   equals the float64 conv bit for bit on the path's own int8 inputs (one
   point of each IResNet stage; det_10g's stem1, stem2 and a downsample,
   captured from a request of c); a and c keep min cosine >= 0.98 against
   the float engine's bf16 embeddings of its own crops; b and c keep its
   valid slots, scores within 5e-2; the f32 packed stems equal the
   unpacked stem within rtol 1e-3 / atol 2e-3 (TF32 off); recalibrate_int8
   on 8 of the path's crops changes the scales and the next request's
   embeddings.  Printed a variant: build s, request wall ms, device ms a
   request (torch.profiler), peak memory, _int_mm calls a request and the
   int8 passes' device ms (ops/int8_conv.py's profiler ranges), the
   detections against the float engine's (box movement not gated), the
   calibrations' ms; torch._int_mm's shape rules on the card.
12. server (after the kernels' own traces, which an earlier trace has been
   seen to leave empty): the live recognition server, twice, over one
   memory:// store of about 2,000 employees behind a GalleryManager with its
   sync thread running.  First the batch witness: request 1's 8 frames
   through run a's path, run b's path and run b's path with K4's plain
   version, in every run of n = 1..8 consecutive frames from each offset:
   each frame's faces must be bit-identical in every batch of one bucket
   (1, 2, 4, 8) whatever its neighbours and position; how far they move
   between buckets is printed, beside K4 on each frame alone against in the
   batch of 8 (bit for bit), K4 against its plain version at B = 1, 2, 4, 8,
   the detector's logits alone against in the batch from bit-identical
   stems, and the anchors at the saturated score 1.0.  Each run's company
   enrolls every distinct face of its path's table (all buckets) plus
   seeded distractors.  build_app is served on 127.0.0.1 by
   web.serving.serve and every control call is an HTTP request; four
   stand-in cameras (a cv2.VideoCapture replaying request 1's BGR 640x480
   frames at 30 fps: the camera, never the card) feed CameraManager ->
   MicroBatcher.  Run a is the server as the reference ships it: Config()
   set as the process config, CameraManager builds FaceAnalysis("buffalo_l")
   with its four default modules on the card itself (K3 at 112, 96 and 192,
   K1 on the f32 gallery, the HUD).  Run b is the streaming profile:
   EngineConfig(stream_transport="yuv420", upload_on_submit=True,
   packed_stem_impl="pallas", gallery_dtype="int8", stream_profile="auto"),
   detection + recognition: each pack encoded and uploaded on its capture
   thread, stacked on the card, K4, K3 on the packed windows, K2.  In each
   run: /api/camera/start without a company is 400 and with one succeeds,
   /api/embeddings/stats counts every employee, /api/embeddings/sync
   succeeds; after a warm-up, an 8 s window with the launch counters zeroed
   at its start: every face of every resolved frame lies within 1 px (box)
   and 1e-5 (1 - cos) of its bucket's face, is the host's float64 top-1
   over its company (within 1e-5) as its own enrolled id, and no id goes to
   two distinct faces; run a decides each face as its own id (or one
   within 1e-5) at >= 0.99; run b's K2 ids and scores equal the plain int8
   version's, and its id is the face's own wherever the float64 top-1
   leads the runner-up by more than 5e-3; each dispatch launches K3 once at
   each crop size (and K4 once, run b) and each matched frame K1 (K2) once;
   a dispatch holds more than one frame, the cameras capture more frames
   than are dispatched, no future ends in an exception; in run b a batch
   is dispatched while the one before is unresolved (and the dispatches
   that returned with their batch still on the card are counted), and every
   stacked batch reaches the engine on the card.  Before the runs,
   get_batch_async on run b's uploaded packs makes no synchronizing CUDA
   call (sync debug mode "error") and no host->device copy (its trace);
   its kernel count is printed beside the launches the stream takes
   behind a held stream (torch.cuda._sleep) before a launch waits.  Then /api/profiler/start and /stop (1 s
   apart, two request threads) write a trace holding the path's kernels'
   device events, /api/metrics shows the batcher's frames and dispatch
   timer, and /api/camera/stop ends every capture, dispatch, resolver and
   results thread within 10 s.  Printed: frames offered, captured and
   dispatched, the average batch and drop share, resolved frames/s, p50 and
   p90 submit -> resolve latency, the results stage's drops, run b's
   controller log, and the host over the window: each thread role's CPU
   (from /proc) beside the share of the window it spent inside its call,
   and run b's encode_frame on the capture threads (with the upload)
   against encode_frame alone, with and without the upload.  Last,
   ``python -m facerecognition_infrenceengine_tpu_torch.servers.
   inference_server`` in a subprocess (MONGODB_URI=memory://) answers
   /api/embeddings/stats and exits 0 on SIGTERM.
13. the card line, then {"ok": true, "device": ...} as the last line.

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

import dataclasses
import faulthandler
import hashlib
import io
import json
import logging
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import weakref
import zlib
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DET_THRESH = 0.5   # synthetic weights saturate scores: every slot is valid
REQUESTS = 3
FRAMES = 8
CAPACITY_ROWS = 50_000          # n_valid of the galleries
CAPACITY = 65_536               # their padded capacity
DELTA_ROWS = 2_000              # the delta-sync store: a site's gallery
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
EPILOGUE_SRC = "facerecognition_infrenceengine_tpu_torch/csrc/epilogue.cu"
LAYERNORM_SRC = "facerecognition_infrenceengine_tpu_torch/csrc/layernorm.cu"
# ViT-L's residual stream at a vit_l.crowd batch: 1,024 crops of 144 tokens, 768 wide
LAYERNORM_CROPS, VIT_TOKENS, VIT_WIDTH = 1024, 144, 768
VIT_FORWARDS = 2     # the [vit] phase's served embeds of a vit_l.crowd batch
VIT_GAP = 1e-4       # 1 - cos of the served ViT-L against the module forward, bf16
EPILOGUE_B = 1024               # IResNet-50's crops a buffalo_l.crowd batch (32 x 32)
# IResNet-50's epilogue shapes (channels, side): the stem and stage 1's
# entry at 112, then each stage's entry width at the side it reads and the
# side it writes
EPILOGUE_SHAPES = ((64, 112), (64, 56), (128, 56), (128, 28), (256, 28), (256, 14), (512, 14),
                   (512, 7))
# the kernels of csrc/ as torch.profiler names them
HAND_KERNELS = ("warp_windows_kernel", "top1_f32_kernel", "top1_bf16_kernel", "top1_int8_kernel",
                "fused_stem", "epilogue_kernel", "residual_layernorm_kernel")
INT8_MARGIN = 5e-3  # f32 top-1 lead over the runner-up above which int8 must agree
# the [int8] phase: the opt-in scale modes (models/quant.py, models/packed_stem.py)
INT8_VARIANTS = (("a", dict(embed_int8=True)), ("b", dict(det_int8=True)),
                 ("c", dict(embed_int8=True, det_int8=True)), ("d", dict(packed_stem=True)),
                 ("e", dict(stream_transport="yuv420", packed_stem_impl="xla")))
INT8_EXACT_POINTS = ("IBasicBlock_0/Conv_2", "IBasicBlock_3/Conv_1", "IBasicBlock_7/Conv_2",
                     "IBasicBlock_23/Conv_0", "stem1", "stem2", "layer2_b0/downsample")
INT8_COS_MIN = 0.98        # int8 against float embeddings (tests/test_quant.py:51, :73)
INT8_SCORE_TOL = 5e-2      # det_int8 scores against float (tests/test_quant.py:153-154)
PACKED_RTOL, PACKED_ATOL = 1e-3, 2e-3  # packed stems, f32 (tests/test_packed_stem.py:158-160)
SERVER_PERSONS = 2_000          # the server phase's store (its sync thread audits every id)
SERVER_CAMERAS = 4
SERVER_FPS = 30.0               # each stand-in camera's frame rate
SERVER_WARMUP_S = 3.0           # after the first result, before the measured window
SERVER_WINDOW_S = 8.0
SERVER_BUCKETS = (1, 2, 4, 8)   # the batch shapes a batcher of microbatch_max 8 dispatches
KIOSK_H, KIOSK_W = 720, 1280     # the enrollment photos: a kiosk webcam
ENROLL_EMPLOYEES = 64           # registered through the API, 3 poses each
ENROLL_DUPLICATES = 4           # of them registered again under new ids
COUNT_CAMERAS = 4               # the counter's stand-in cameras: entry, exit, entry, exit
COUNT_WARMUP_S = 2.0            # after every camera's first result
COUNT_WINDOW_S = 10.0
REPLAY_EPS = 1e-5               # a float64 replay this close to a threshold decides nothing
# the seeded, untrained embedder puts two persons' photos at cosine 0.90 (p50) up
# to 0.98, one person's poses at 0.78-0.99: at the shipped duplicate_face 0.4
# every registration after the first ends duplicate (67 of 68 on the H100).
# Above 0.999 only a re-registration of the same photos is a duplicate
ENROLL_DUPLICATE_FACE = 0.999
# the cv2 constants CameraManager sets on its capture (OpenCV's values)
CAP_PROPS = {"CAP_PROP_FRAME_WIDTH": 3, "CAP_PROP_FRAME_HEIGHT": 4, "CAP_PROP_FPS": 5,
             "CAP_PROP_BUFFERSIZE": 38}


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


def epilogue_phase(torch, card: str) -> dict:
    """The epilogue kernel in bf16, channels-last.  First, each variant that
    arcface.serve_forward launches (BN, BN + PReLU, BN + r, BN + BN(r)),
    in place and into a second tensor, bit-equal to the plain version at
    every (channels, side) of EPILOGUE_SHAPES, at the main path's crops
    (FRAMES x max_faces).  Then, at IResNet-50's 112x112 stage (B =
    EPILOGUE_B, 64 channels), BN + PReLU (the stem, BatchNorm_1) and BN +
    BN(r) (a stage entry's end, on a same-sized r), timed (CUDA events; the
    kernel's device time from torch.profiler) against the plain version and
    against ATen's separate passes as the module forward runs them; the
    bound is the bytes read and written once."""
    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.ops import epilogue_kernel

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(20)

    def act(shape):
        return (3 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    def bn(c):
        m = torch.nn.BatchNorm2d(c).eval().to(dev)
        with torch.no_grad():
            for t in (m.weight, m.bias, m.running_mean):
                t.copy_(torch.randn(c, generator=gen, device=dev))
            m.running_var.copy_(torch.randn(c, generator=gen, device=dev).exp())
        return m

    def bits(t):
        return t.view(torch.int16)

    b_path = FRAMES * EngineConfig().max_faces
    checked = 0
    with torch.inference_mode():
        for c, side in EPILOGUE_SHAPES:
            shape = (b_path, c, side, side)
            x, r, bn_a, bn_b = act(shape), act(shape), bn(c), bn(c)
            slope = (0.25 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
            for name, kw in (("bn", {}), ("bn_prelu", dict(prelu=slope)), ("bn_res", dict(res=r)),
                             ("bn_bn_res", dict(res=r, res_bn=bn_b))):
                want = epilogue_kernel.epilogue_plain(x, bn_a, out=torch.empty_like(x), **kw)
                into = epilogue_kernel.epilogue(x, bn_a, out=torch.empty_like(x), **kw)
                inplace = x.clone()
                same = epilogue_kernel.epilogue(inplace, bn_a, **kw)
                torch.cuda.synchronize()
                check(same.data_ptr() == inplace.data_ptr(),
                      f"[epilogue] {name} {shape}: not written in place")
                for how, got in (("into out", into), ("in place", same)):
                    check(torch.equal(bits(got), bits(want)),
                          f"[epilogue] {name} {shape} {how}: {int((got != want).sum())} values "
                          f"differ from the plain version")
                    checked += 1
                del want, into, inplace, same
            del x, r
    say(f"[epilogue] {card} | bit-equal to the plain version: {checked} cases (BN, BN + PReLU, "
        f"BN + r, BN + BN(r); in place and into out) at {len(EPILOGUE_SHAPES)} shapes, "
        f"B={b_path} bf16")

    shape = (EPILOGUE_B, 64, 112, 112)
    x, r, out = act(shape), act(shape), torch.empty(shape, dtype=torch.bfloat16, device=dev,
                                                    memory_format=torch.channels_last)
    bn_a, bn_b = bn(64), bn(64)
    slope = (0.25 * torch.randn(64, generator=gen, device=dev)).to(torch.bfloat16)
    prelu = torch.nn.PReLU(64).to(dev, torch.bfloat16)
    with torch.no_grad():
        prelu.weight.copy_(slope)
    cases = {"bn_prelu": (dict(prelu=slope), lambda: prelu(bn_a(x))),
             "bn_bn_res": (dict(res=r, res_bn=bn_b), lambda: bn_a(x) + bn_b(r))}
    rows = {}
    with torch.inference_mode():
        for name, (kw, aten) in cases.items():
            want = epilogue_kernel.epilogue_plain(x, bn_a, out=torch.empty_like(x), **kw)
            got = epilogue_kernel.epilogue(x, bn_a, out=out, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  f"[epilogue] {name}: {int((got != want).sum())} values differ from the plain "
                  f"version")
            check(torch.equal(aten().view(torch.int16), want.view(torch.int16)),
                  f"[epilogue] {name}: the plain version differs from the module's passes")
            del want, got
            moved = x.numel() * 2 * (3 if "res" in kw else 2)
            bnd, by = bound(moved, 0, "bfloat16")
            rows[name] = {
                "ms": time_ms(torch, lambda: epilogue_kernel.epilogue(x, bn_a, out=out, **kw),
                              20),
                "kernel_device_ms": kernel_ms(
                    torch, lambda: epilogue_kernel.epilogue(x, bn_a, out=out, **kw),
                    "epilogue_kernel", 10),
                "plain_ms": time_ms(torch, lambda: epilogue_kernel.epilogue_plain(
                    x, bn_a, out=out, **kw), 5, 1),
                "library_ms": time_ms(torch, aten, 5, 1),
                "library_device_ms": device_ms(torch, aten, 5),
                "bound_ms": bnd, "bound_by": by, "bytes": moved}
    for name, t in rows.items():
        say(f"[epilogue] {card} | {name} B={EPILOGUE_B} 64x112x112 bf16: {t['ms']:.4f} ms, "
            f"device {t['kernel_device_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']} ({100 * t['bound_ms'] / t['kernel_device_ms']:.1f}%); plain "
            f"{t['plain_ms']:.3f} ms; ATen's passes {t['library_ms']:.3f} ms (device "
            f"{t['library_device_ms']:.3f}); bit-equal to the plain version")
    return rows


def epilogue_main() -> int:
    """The epilogue phase alone, on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    say(json.dumps({"epilogue": epilogue_phase(torch, card)}))
    return 0


def layernorm_phase(torch, card: str) -> dict:
    """The ViT's residual add + LayerNorm kernel at the served shape
    (LAYERNORM_CROPS x VIT_TOKENS rows of VIT_WIDTH).  First, in bf16 and
    f32, both forms against the plain version (ATen's add, then
    F.layer_norm): the updated stream bit-equal, the LayerNorm within one
    bf16 ulp (at least 2**-16) or, in f32, 2e-6 of unit-scale values (the
    kernel's two-pass statistics are not ATen's Welford order).  Then, in
    bf16, the
    fused form (x += a, the LayerNorm into a's buffer; x and a read, x and n
    written) and the plain LayerNorm form (block 0's norm1; x read, n
    written) timed (CUDA events; the kernel's device time from
    torch.profiler) against their bytes bound, the plain version and ATen's
    out-of-place add + layer_norm as the module forward runs them."""
    from facerecognition_infrenceengine_tpu_torch.ops import layernorm_kernel as lk

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(23)
    shape = (LAYERNORM_CROPS, VIT_TOKENS, VIT_WIDTH)

    def norm(dtype):
        m = torch.nn.LayerNorm(VIT_WIDTH, eps=1e-6).to(dev)
        with torch.no_grad():
            m.weight.copy_(1 + 0.1 * torch.randn(VIT_WIDTH, generator=gen, device=dev))
            m.bias.copy_(0.1 * torch.randn(VIT_WIDTH, generator=gen, device=dev))
        return m.to(dtype)

    def rows(dtype):
        return (0.7 * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    def rounding(value, want) -> tuple:
        """(the largest |value - want|, its largest share of the tolerance)"""
        g, w = value.float(), want.float()
        err = (g - w).abs()
        if value.dtype == torch.bfloat16:
            _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
            tol = torch.ldexp(torch.ones_like(g), e - 8).clamp_min(2.0 ** -16)
        else:
            tol = 2e-6 * w.abs().clamp_min(1.0)
        return float(err.max()), float((err / tol).max())

    errs = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            nrm, x, a = norm(dtype), rows(dtype), rows(dtype)
            h = x + a
            want = lk.residual_layernorm_plain(x.clone(), a.clone(), nrm)
            xs, n = x.clone(), a.clone()
            got = lk.residual_layernorm(xs, n, nrm)
            alone = lk.residual_layernorm(h, None, nrm)
            torch.cuda.synchronize()
            check(got.data_ptr() == n.data_ptr(), "[layernorm] not written into a's buffer")
            check(torch.equal(xs, h), f"[layernorm] {dtype}: the stream differs from ATen's add "
                  f"in {int((xs != h).sum())} values")
            for what, value in (("fused", got), ("plain_form", alone)):
                err, share = rounding(value, want)
                check(share <= 1.0, f"[layernorm] {dtype}: the {what} LayerNorm {err:.3e} from "
                      f"F.layer_norm, {share:.2f} of its tolerance")
                errs[f"{what}.{str(dtype).split('.')[-1]}"] = err
            del nrm, x, a, h, want, xs, n, got, alone
    say(f"[layernorm] {card} | {shape}: the stream bit-equal to ATen's add; the LayerNorm's "
        f"largest difference from F.layer_norm {errs}")

    nrm, x, a, out = (norm(torch.bfloat16), rows(torch.bfloat16), rows(torch.bfloat16),
                      torch.empty(shape, dtype=torch.bfloat16, device=dev))
    cases = {
        "residual": (lambda: lk.residual_layernorm(x, a, nrm, out=out),
                     lambda: lk.residual_layernorm_plain(x, a, nrm, out=out),
                     lambda: F.layer_norm(x + a, (VIT_WIDTH,), nrm.weight, nrm.bias, nrm.eps), 4),
        "no_residual": (lambda: lk.residual_layernorm(x, None, nrm, out=out),
                        lambda: lk.residual_layernorm_plain(x, None, nrm, out=out),
                        lambda: F.layer_norm(x, (VIT_WIDTH,), nrm.weight, nrm.bias, nrm.eps), 2),
    }
    timed = {}
    with torch.inference_mode():
        for name, (kernel, plain, aten, passes) in cases.items():
            moved = x.numel() * 2 * passes
            bnd, by = bound(moved, 0, "bfloat16")
            timed[name] = {
                "ms": time_ms(torch, kernel, 20),
                "kernel_device_ms": kernel_ms(torch, kernel, "residual_layernorm_kernel", 10),
                "plain_ms": time_ms(torch, plain, 5, 1),
                "library_ms": time_ms(torch, aten, 5, 1),
                "library_device_ms": device_ms(torch, aten, 5),
                "bound_ms": bnd, "bound_by": by, "bytes": moved}
        timed["no_residual"]["aten_layer_norm_device_ms"] = kernel_ms(
            torch, cases["no_residual"][2], "layer_norm_kernel", 10)
    for name, t in timed.items():
        say(f"[layernorm] {card} | {name} {shape} bf16: {t['ms']:.4f} ms, device "
            f"{t['kernel_device_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"({100 * t['bound_ms'] / t['kernel_device_ms']:.1f}%); plain {t['plain_ms']:.3f} ms; "
            f"ATen's passes {t['library_ms']:.3f} ms (device {t['library_device_ms']:.3f})")
    say(f"[layernorm] {card} | ATen's layer_norm kernel alone: "
        f"{timed['no_residual']['aten_layer_norm_device_ms']:.4f} ms device")
    return {**timed, "max_abs_err": errs}


def layernorm_main() -> int:
    """The residual add + LayerNorm phase alone, on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    say(json.dumps({"layernorm": layernorm_phase(torch, card)}))
    return 0


def vit_phase(torch, card: str) -> dict:
    """The [vit] path: FaceEngine(rec_arch="vit_l") in bf16 at published
    widths (synthetic weights) embeds a vit_l.crowd batch, LAYERNORM_CROPS
    aligned crops, through embed_crops, whose embedder call
    (_apply_embedder, one engine.embedder span) is the one every served
    program makes.  residual_layernorm's launch count is zeroed just before
    VIT_FORWARDS such embeds and must then read 49 a forward (48 fused,
    block 0's norm1 plain); the embeddings are held to the module forward
    on the same crops, under the engine's attention backend, within
    1 - cos VIT_GAP.  The last embed's peak over its base and its time are
    reported."""
    from facerecognition_infrenceengine_tpu_torch.core import metrics
    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine import pipeline
    from facerecognition_infrenceengine_tpu_torch.models import arcface, vit
    from facerecognition_infrenceengine_tpu_torch.ops import layernorm_kernel as lk
    from facerecognition_infrenceengine_tpu_torch.ops.matching import l2_normalize
    from torch.nn.attention import sdpa_kernel

    t0 = time.perf_counter()
    engine = pipeline.FaceEngine(EngineConfig(dtype="bfloat16"), rec_arch="vit_l",
                                 device="cuda")
    build_s = time.perf_counter() - t0
    crops = pipeline._calibration_crops(LAYERNORM_CROPS, 112, 23)
    engine.embed_crops(crops[:8])  # the library and cuBLAS's workspaces
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lk.residual_layernorm.launches = 0
    metrics.record_spans(True)
    try:
        for _ in range(VIT_FORWARDS):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = engine.embed_crops(crops)
            embed_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() - base
    finally:
        metrics.record_spans(False)
    launches = lk.residual_layernorm.launches
    forwards = sum(1 for sp in metrics.spans() if sp.name == "engine.embedder")
    check(forwards == VIT_FORWARDS, f"[vit] {forwards} embedder calls for {VIT_FORWARDS} embeds")
    check(launches == 49 * forwards, f"[vit] {launches} residual_layernorm launches for "
          f"{forwards} forwards of ViT-L: 49 each")
    x = arcface.preprocess(torch.from_numpy(crops).cuda())
    with torch.inference_mode(), sdpa_kernel(vit._ATTENTION[engine.dtype]):
        want = l2_normalize(engine.embedder(x)).double().cpu().numpy()
    gap = float(np.max(1.0 - np.sum(got.astype(np.float64) * want, axis=1)))
    check(got.shape == (LAYERNORM_CROPS, 512) and gap <= VIT_GAP,
          f"[vit] the served ViT-L {gap:.3e} (1 - cos) from the module forward, limit {VIT_GAP}")
    del engine, x
    torch.cuda.empty_cache()
    say(f"[vit] {card} | FaceEngine(vit_l) bf16 built in {build_s:.1f} s; {forwards} embeds of "
        f"{LAYERNORM_CROPS} crops: {launches} residual_layernorm launches, 1 - cos {gap:.3e} "
        f"against the module forward; the last embed {embed_ms:.1f} ms, peak {peak:,} B over "
        f"its base")
    return {"launches": launches, "forwards": forwards, "cos_gap": gap, "embed_ms": embed_ms,
            "peak_over_base_bytes": peak}


def vit_main() -> int:
    """The [vit] path phase alone, on the card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(json.dumps({"vit": vit_phase(torch, card)}))
    return 0


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


def in_canvas_kps(rng, n: int, width: int = FRAME_W, height: int = FRAME_H, dst=None,
                  theta: float | None = None, scales: tuple = (0.5, 4.0)):
    """n faces' landmarks: ARCFACE_DST at scales 0.5-4 (``scales``) and
    rotations within +-0.5 rad (all at ``theta`` when given), centred so
    every landmark lies inside a width x height frame."""
    base = dst - dst.mean(0)
    kps = []
    fixed = theta
    for _ in range(n):
        scale = rng.uniform(*scales)
        theta = rng.uniform(-0.5, 0.5) if fixed is None else fixed
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


def write_people(ds, company, vecs, prefix):
    """Employees as registration + the enrollment worker leave them, in bulk
    (one GridFS put a person, one insert_many) -> their ids (hex)."""
    from facerecognition_infrenceengine_tpu_torch.core.clock import get_current_utc
    from facerecognition_infrenceengine_tpu_torch.core.serialization import serialize_embedding
    from facerecognition_infrenceengine_tpu_torch.store import ObjectId

    docs = []
    for n, v in enumerate(vecs):
        pid = ObjectId()
        fid = ds.employee_embeddings.put(serialize_embedding(v),
                                         filename=f"{company}_{pid}_buffalo_l.pkl")
        now = get_current_utc()
        docs.append({"_id": pid, "companyId": company, "employeeId": f"{prefix}{n:05d}",
                     "employeeName": f"{prefix}{n:05d}", "status": "active",
                     "blacklisted": False, "lastUpdated": now,
                     "employeeEmbeddings": {"buffalo_l": {
                         "embeddingId": fid, "status": "done", "createdAt": now,
                         "finishedAt": now, "corrupt": False}}})
    ds.employee_info.insert_many(docs)
    return [str(d["_id"]) for d in docs]


class ReplayCapture:
    """The server phase's stand-in for cv2.VideoCapture (it replaces the
    camera, never the card or a kernel): each capture replays ``frames`` in
    a loop at SERVER_FPS, a fresh copy a read (the results stage draws its
    HUD into the frame it gets), and tags the copy with its index in
    ``frames`` (``frame_index``) and the time of its read (``read_time``)."""

    frames: list = []
    offered = 0
    _tags: dict = {}
    _lock = threading.Lock()

    def __init__(self, source):
        self.k = 0
        self.next_t = time.perf_counter()

    def isOpened(self):
        return True

    def set(self, *_):
        return True

    def read(self):
        delay = self.next_t - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        # a read that comes late does not earn a burst of catch-up reads
        self.next_t = max(self.next_t, time.perf_counter() - 1.0 / SERVER_FPS) + 1.0 / SERVER_FPS
        k = self.k % len(self.frames)
        self.k += 1
        frame = self.frames[k].copy()
        with ReplayCapture._lock:
            ReplayCapture._tags[id(frame)] = (weakref.ref(frame), k, time.perf_counter())
            ReplayCapture.offered += 1
        return True, frame

    def release(self):
        pass

    @classmethod
    def _tag(cls, frame) -> tuple:
        with cls._lock:
            ref, k, t = cls._tags[id(frame)]
        check(ref() is frame, "a frame's tag belongs to another frame")
        return k, t

    @classmethod
    def frame_index(cls, frame) -> int:
        return cls._tag(frame)[0]

    @classmethod
    def read_time(cls, frame) -> float:
        """The host clock (perf_counter) at the read that returned ``frame``."""
        return cls._tag(frame)[1]


def install_camera(frames):
    """Make ``cv2.VideoCapture`` ReplayCapture over ``frames``: patched into
    OpenCV where it is importable, else a module holding only VideoCapture
    and the CAP_PROP_* constants -> a function that undoes it."""
    import importlib.util
    import types

    ReplayCapture.frames = list(frames)
    if importlib.util.find_spec("cv2") is None:
        mod = types.ModuleType("cv2")
        mod.VideoCapture = ReplayCapture
        for name, value in CAP_PROPS.items():
            setattr(mod, name, value)
        sys.modules["cv2"] = mod
        return lambda: sys.modules.pop("cv2", None)
    import cv2

    old = cv2.VideoCapture
    cv2.VideoCapture = ReplayCapture
    return lambda: setattr(cv2, "VideoCapture", old)


_NO_PROXY = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def http_json(method: str, url: str, body=None, timeout: float = 300.0, files=None):
    """One HTTP request to a local API -> (status, JSON body).  ``body`` goes
    as JSON, or with ``files`` (name -> (filename, bytes, content type)) as
    multipart form fields, encoded as the port's WSGI test client does."""
    from facerecognition_infrenceengine_tpu_torch.web.framework import _encode_multipart

    if files is not None:
        data, ctype = _encode_multipart(body or {}, files)
    else:
        data, ctype = None if body is None else json.dumps(body).encode(), "application/json"
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": ctype})
    try:
        with _NO_PROXY.open(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def trace_kernels(logdir: str) -> tuple:
    """The Chrome trace(s) of ``logdir`` -> (device kernels, name -> count;
    the device's busy share: kernels, copies and memsets over the trace's
    span; one stream, so they do not overlap)."""
    names, busy, t_lo, t_hi = Counter(), 0.0, float("inf"), 0.0
    for name in os.listdir(logdir):
        with open(os.path.join(logdir, name)) as f:
            for ev in json.load(f).get("traceEvents", []):
                if "ts" not in ev or ev.get("ph") != "X":
                    continue
                t_lo = min(t_lo, float(ev["ts"]))
                t_hi = max(t_hi, float(ev["ts"]) + float(ev.get("dur", 0)))
                cat = str(ev.get("cat", "")).lower()
                if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                    busy += float(ev.get("dur", 0))
                if cat == "kernel":
                    names[ev.get("name", "")] += 1
    return names, busy / max(t_hi - t_lo, 1.0)


def _faces_key(faces) -> tuple:
    """A frame's faces -> (boxes [m, 4], embeddings [m, 512]) float32."""
    return (np.asarray([f.bbox for f in faces], np.float32).reshape(-1, 4),
            np.asarray([f.normed_embedding for f in faces], np.float32).reshape(-1, 512))


def batch_witness(torch, card: str, frames: list, paths: dict) -> dict:
    """Whether a frame's faces depend on the batch it rides in.  Each path
    (name -> a get_batch over BGR frames) serves every run of n = 1..8
    consecutive ``frames`` (round robin, from each of the 8 offsets), so each
    frame rides at every position beside different neighbours in every
    bucket the batcher dispatches.  Per path and bucket: whether every batch
    of that bucket gave each frame bit-identical faces (boxes and
    embeddings), and how far they lie from the frame's faces at bucket 8.
    Returns {path: {bucket: [frame k's (boxes, embeddings)]}} for the paths
    whose faces depend on the bucket alone; a path whose faces also depend
    on the neighbours or the position fails the check."""
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import bucket

    n_fr = len(frames)
    tables = {}
    for name, get_batch in paths.items():
        seen = {}  # (bucket, k) -> distinct (boxes, embeddings) byte strings -> one of them
        for n in range(1, n_fr + 1):
            for off in range(n_fr):
                ks = [(off + i) % n_fr for i in range(n)]
                for k, faces in zip(ks, get_batch([frames[k] for k in ks])):
                    boxes, embs = _faces_key(faces)
                    seen.setdefault((bucket(n), k), {})[boxes.tobytes() + embs.tobytes()] = (
                        boxes, embs)
        buckets = sorted({b for b, _ in seen})
        variants = {b: max(len(seen[(b, k)]) for k in range(n_fr)) for b in buckets}
        parts = []
        for b in buckets:
            other_count, shift, cos = 0, 0.0, 0.0
            for k in range(n_fr):
                (bx, em), = list(seen[(b, k)].values())[:1]
                (bx8, em8), = list(seen[(buckets[-1], k)].values())[:1]
                if len(bx) != len(bx8):
                    other_count += 1
                    continue
                if len(bx):
                    shift = max(shift, float(np.abs(bx - bx8).max()))
                    cos = max(cos, float(1.0 - (em * em8).sum(1).min()))
            parts.append(f"bucket {b}: {variants[b]} variant(s) a frame; against bucket "
                         f"{buckets[-1]} {other_count}/{n_fr} frames with another face count, "
                         f"boxes within {shift:.3f} px, 1 - cos <= {cos:.2e}")
        say(f"[server] batch witness, {name}: " + "; ".join(parts))
        check(all(v == 1 for v in variants.values()),
              f"[server] {name}: a frame's faces depend on its neighbours or its position in "
              f"the batch, not only on the bucket: {variants}")
        tables[name] = {b: [next(iter(seen[(b, k)].values())) for k in range(n_fr)]
                        for b in buckets}
    return tables


def stem_witness(torch, card: str, app, frames: list) -> dict:
    """Where a frame's detections come to depend on the bucket, on the yuv
    path's app: K4 on each frame alone against the same frame in the batch
    of 8 (bit for bit), K4 against its plain version at B = 1, 2, 4 and 8,
    and the detector's logits of each frame alone against in the batch from
    bit-identical stem outputs; then how many anchors sit at the saturated
    score 1.0, where the masked top-k breaks ties by anchor index."""
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import yuv_black
    from facerecognition_infrenceengine_tpu_torch.ops import stem_kernel
    from facerecognition_infrenceengine_tpu_torch.ops.yuv import yuv420p4_to_rgbp4

    engine = app._ensure_engine()
    wts, sw = engine.stem_weights, engine.stem_width
    out = {}
    with torch.inference_mode():
        # the packed RGB frames K4 reads on the path (_fused_yuv_impl)
        y24 = torch.as_tensor(app._stack_yuv([app.encode_frame(f) for f in frames],
                                             engine.cfg.det_size[1]), device=engine.device)
        b, rows, w4, _ = y24.shape
        dh = engine.cfg.det_size[0] // 4
        if rows < dh:
            y24 = torch.cat([y24, yuv_black((b, dh - rows, w4), y24.device)], dim=1)
        x48 = yuv420p4_to_rgbp4(y24)
        s8 = stem_kernel.fused_stem_s2d4(x48, wts, sw)
        alone = [stem_kernel.fused_stem_s2d4(x48[k:k + 1].contiguous(), wts, sw)
                 for k in range(x48.shape[0])]
        out["k4_alone_equal"] = all(torch.equal(a[0], s8[k]) for k, a in enumerate(alone))
        p8 = stem_kernel.fused_stem_plain(x48, wts, sw)
        out["plain_alone_equal"] = all(
            torch.equal(stem_kernel.fused_stem_plain(x48[k:k + 1].contiguous(), wts, sw)[0],
                        p8[k]) for k in range(x48.shape[0]))
        vs_plain = {}
        for b in (1, 2, 4, 8):
            got = stem_kernel.fused_stem_s2d4(x48[:b].contiguous(), wts, sw).float()
            want = stem_kernel.fused_stem_plain(x48[:b].contiguous(), wts, sw).float()
            err, top = float((got - want).abs().max()), float(want.abs().max())
            same = float((got == want).float().mean())
            check(err <= 2.0 ** -6 * top and same >= 0.9,
                  f"K4 bf16 B={b}: err {err} (max {top}), equal share {same}")
            vs_plain[b] = (err, same)
        out["k4_vs_plain"] = vs_plain
        l8 = engine.detector(None, stem_out=s8)[0][..., 0].float()
        diff, sat, at_cut = 0.0, [], []
        for k, a in enumerate(alone):
            l1 = engine.detector(None, stem_out=a)[0][0, ..., 0].float()
            diff = max(diff, float((l1 - l8[k]).abs().max()))
        scores = torch.sigmoid(engine.detector(None, stem_out=s8)[0][..., 0])
        for k in range(x48.shape[0]):
            sk = scores[k].float()
            sat.append(int((sk == 1.0).sum()))
        out.update(logits_alone_max_diff=diff, logits_max=float(l8.abs().max()),
                   saturated_anchors=sat, anchors=int(scores.shape[1]),
                   score_dtype=str(scores.dtype))
    say(f"[server] stem witness {card}: K4 on each frame alone == in the batch of 8 bit for "
        f"bit: {out['k4_alone_equal']} (the plain version: {out['plain_alone_equal']}); K4 vs "
        f"plain (max abs err, equal share) "
        f"{ {b: (f'{e:.2e}', round(s, 4)) for b, (e, s) in vs_plain.items()} }; detector "
        f"logits of a frame alone vs in the batch of 8 from bit-identical stems: max diff "
        f"{diff:.3e} (|logits| up to {out['logits_max']:.1f}); anchors at score 1.0 "
        f"({out['score_dtype']}) per frame {sat} of {out['anchors']}")
    return out


def trace_host(logdir: str, roles: dict) -> dict:
    """The CUDA runtime calls in the Chrome trace(s) of ``logdir``, by the
    thread that made them: role (``roles``: name -> threads; a thread no
    role holds is "tid <n>") -> kind (launch, copy, sync, other) -> [calls,
    ms]."""
    role_of = {t.native_id: role for role, ts in roles.items() for t in ts}
    out = {}
    for name in os.listdir(logdir):
        with open(os.path.join(logdir, name)) as f:
            events = json.load(f).get("traceEvents", [])
        for ev in events:
            if ev.get("ph") != "X" or str(ev.get("cat", "")).lower() not in (
                    "cuda_runtime", "cuda_driver"):
                continue
            call = ev.get("name", "")
            kind = ("launch" if "Launch" in call else "copy" if "Memcpy" in call
                    else "sync" if "Synchronize" in call else "other")
            role = role_of.get(ev.get("tid"), f"tid {ev.get('tid')}")
            acc = out.setdefault(role, {}).setdefault(kind, [0, 0.0])
            acc[0] += 1
            acc[1] += float(ev.get("dur", 0)) / 1e3
    return out


def host_line(calls: dict) -> str:
    """trace_host's record of one thread (or role) as text."""
    return ", ".join(f"{kind} {n} calls {ms:.1f} ms ({1e3 * ms / max(n, 1):.1f} us each)"
                     for kind, (n, ms) in sorted(calls.items())) or "no CUDA calls"


def server_phase(torch, card: str, frames: list, cfg_a, cfg_b, persons: int = SERVER_PERSONS,
                 dev_type: str = "cuda") -> list:
    """The live server twice over one memory:// store of ``persons``
    employees: run a as the reference ships it (``cfg_a``, the process
    config: CameraManager builds FaceAnalysis("buffalo_l") with its four
    modules itself, f32 gallery, K3 at 112/96/192 and K1), run b on the
    streaming profile (``cfg_b``: yuv420 packs uploaded on the capture
    threads, stacked on the card, K4, K3 on packed windows and K2 on an int8
    gallery).  Each serves SERVER_CAMERAS stand-in cameras replaying
    ``frames`` at SERVER_FPS through CameraManager -> MicroBatcher, behind
    build_app on 127.0.0.1; every control call is an HTTP request.  Before
    the runs, batch_witness and stem_witness give each frame's faces in each
    bucket, and each run's company enrolls every distinct one of them, plus
    seeded distractors up to ``persons`` // 2.  Returns the two runs'
    records."""
    from facerecognition_infrenceengine_tpu_torch.core import config as core_config
    from facerecognition_infrenceengine_tpu_torch.engine import pipeline
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis
    from facerecognition_infrenceengine_tpu_torch.ops import stem_kernel
    from facerecognition_infrenceengine_tpu_torch.store import Datastore, ObjectId

    dev = torch.device(dev_type)
    previous = core_config.get_config()
    # run a's twin (CameraManager builds its own, with the same seeded
    # weights) and run b's app; each warmed on every batch shape
    t0 = time.perf_counter()
    twin_a = FaceAnalysis("buffalo_l", cfg=cfg_a.engine)
    twin_a.prepare(ctx_id=0, det_thresh=cfg_a.thresholds.detection)
    app_b = FaceAnalysis("buffalo_l", cfg=cfg_b.engine,
                         allowed_modules=("detection", "recognition"))
    app_b.prepare(ctx_id=0, det_thresh=cfg_b.thresholds.detection)
    for n in SERVER_BUCKETS:
        twin_a.get_batch(frames[:n])
        app_b.get_batch(frames[:n])

    def plain_stem(batch):  # run b's path with K4's plain version in its place
        pipeline.fused_stem_s2d4 = stem_kernel.fused_stem_plain
        try:
            return app_b.get_batch(batch)
        finally:
            pipeline.fused_stem_s2d4 = stem_kernel.fused_stem_s2d4

    # what each frame must give in each bucket, and why it differs between
    # buckets; each run's company enrolls every distinct face of its table
    tables = batch_witness(torch, card, frames, {"rgb + heads (run a)": twin_a.get_batch,
                                                 "yuv420 K4 (run b)": app_b.get_batch,
                                                 "yuv420 plain stem": plain_stem})
    witness = stem_witness(torch, card, app_b, frames) if dev.type == "cuda" else {}
    del twin_a
    if dev.type == "cuda":
        # get_batch_async on uploaded packs may not wait for the card: no
        # synchronizing call (.item(), nonzero, a device->host copy: torch's
        # sync debug mode raises on one), and no host->device copy (from
        # pageable memory the copy first waits for the stream; the debug mode
        # does not see it, the trace does)
        packs = [app_b.encode_frame(f) for f in frames]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            resolve = app_b.get_batch_async(packs)
        except RuntimeError as e:
            fail(f"[server] get_batch_async on uploaded yuv packs synchronized: {e}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(len(resolve()) == len(frames), "[server] get_batch_async resolved no frames")
        rows = device_events(torch, lambda: app_b.get_batch_async(packs)(), 1)
        htod = [(key, n) for key, n, _ in rows if "HtoD" in key]
        check(not htod, f"[server] get_batch_async copied host memory to the card: {htod}")
        kernels_per_batch = sum(n for key, n, _ in rows if not key.startswith("Mem"))
        # how far a dispatch can run ahead of the card: the launches the
        # stream takes behind a held stream (torch.cuda._sleep) before a
        # launch waits, against the kernels of one dispatch
        x = torch.zeros(1, device=dev)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)
        queue_depth = None
        for n in range(16384):
            t1 = time.perf_counter()
            x.add_(1)
            if time.perf_counter() - t1 > 0.05:
                queue_depth = n
                break
        torch.cuda.synchronize()
        witness.update(kernels_per_batch8=kernels_per_batch, launch_queue_depth=queue_depth)
        say(f"[server] get_batch_async on 8 uploaded yuv packs made no synchronizing CUDA call "
            f"(torch.cuda.set_sync_debug_mode('error')) and no host->device copy (its copies: "
            f"{sorted(key for key, _, _ in rows if key.startswith('Mem'))}); a dispatch runs "
            f"{kernels_per_batch} kernels, and behind a held stream a launch waited after "
            f"{queue_depth} queued launches")
    ds = Datastore(cfg_a)
    companies = {"a": ObjectId(), "b": ObjectId()}
    rng = np.random.default_rng(12)
    runs = {}
    for label, name in (("a", "rgb + heads (run a)"), ("b", "yuv420 K4 (run b)")):
        faces = {}  # a face's embedding bytes -> embedding: one person each
        for rows in tables[name].values():
            for _, embs in rows:
                for e in embs:
                    faces.setdefault(e.tobytes(), e)
        vecs = np.stack(list(faces.values()))
        dis = rng.normal(size=(max(persons // 2 - len(vecs), 0), 512)).astype(np.float32)
        matrix = np.concatenate([vecs, dis / np.linalg.norm(dis, axis=1, keepdims=True)])
        ids = write_people(ds, companies[label], matrix.astype(np.float32), f"S{label.upper()}")
        runs[label] = {"table": tables[name], "own": dict(zip(faces, ids)), "ids": ids,
                       "matrix": matrix.astype(np.float64)}
    total = sum(len(r["ids"]) for r in runs.values())
    say(f"[server] {card} | {total} employees in two companies, holding run a's "
        f"{len(runs['a']['own'])} and run b's {len(runs['b']['own'])} distinct faces of "
        f"request 1 over the buckets {SERVER_BUCKETS}; enrolled and warmed in "
        f"{time.perf_counter() - t0:.1f} s")
    restore_camera = install_camera(frames)
    records = []
    try:
        for label, cfg, face_app in (("a", cfg_a, None), ("b", cfg_b, app_b)):
            records.append(_server_run(torch, card, dev, label, cfg, face_app, ds,
                                       str(companies[label]), runs[label], total))
    finally:
        restore_camera()
        core_config.set_config(previous)
    records[0]["batch_witness"] = witness
    return records


def thread_cpu_s(threads) -> float:
    """The CPU seconds (user + system) ``threads`` have used, from
    /proc/self/task/<tid>/stat; a thread that has ended counts 0."""
    total = 0.0
    for t in threads:
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            total += (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
        except (OSError, TypeError, IndexError, ValueError):
            pass
    return total


def _server_run(torch, card, dev, label, cfg, face_app, ds, company, run, persons) -> dict:
    """One run of the server phase (see server_phase) -> its record."""
    from facerecognition_infrenceengine_tpu_torch.core import config as core_config
    from facerecognition_infrenceengine_tpu_torch.core import metrics
    from facerecognition_infrenceengine_tpu_torch.domain.cameras import CameraManager
    from facerecognition_infrenceengine_tpu_torch.engine import microbatch, recognizer
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine, bucket
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis
    from facerecognition_infrenceengine_tpu_torch.ops import match_kernel, stem_kernel, warp_kernel
    from facerecognition_infrenceengine_tpu_torch.servers.inference_server import build_app
    from facerecognition_infrenceengine_tpu_torch.web import serve

    core_config.set_config(cfg)
    metrics.reset()
    gallery = GalleryManager(ds, cfg, sync_interval_s=cfg.sync.inference_sync_s)
    gallery.start_sync()
    window = threading.Event()
    rec = {"dispatch": [], "match": [], "latency": [], "errors": [], "yuv_on_card": [],
           "encode": [], "stall": []}
    stall = threading.Event()  # after the window: the card held up once (run b)
    decisions = []

    def on_result(source, frame, results):
        if window.is_set():
            decisions.append((ReplayCapture.frame_index(frame), results))

    cm = CameraManager(gallery, face_app=face_app, on_result=on_result)

    # measurement hooks around the path's own calls, removed after the run:
    # the kernel launches of each dispatch (only the dispatch thread launches
    # K3 and K4) and of each match (only the results thread launches K1 and
    # K2), the batches in flight around each dispatch, each frame's
    # submit -> resolve latency, the device of each stacked yuv batch, the
    # bucket each frame's batch was padded to (on its faces) and each
    # encode_frame on the capture threads
    orig = (FaceAnalysis.get_batch_async, recognizer.FaceRecognitionProcessor.match_faces,
            microbatch.MicroBatcher.submit, FaceEngine.detect_align_embed_yuv420_flat,
            FaceAnalysis.encode_frame)

    def get_batch_async(self, frames_, max_num=0):
        inside, mb = window.is_set(), cm.batcher
        k3, k4 = Counter(warp_kernel.warp_rois.launches_by_size), stem_kernel.fused_stem.launches
        before = mb._inflight_n if mb is not None else 0
        # the hook's own CUDA calls, like the path's, run inside the device
        # gate (a trace starts and stops with no thread calling into CUDA)
        with metrics.device_work():
            t0 = time.perf_counter()
            resolve = orig[0](self, frames_, max_num)
            took = time.perf_counter() - t0
            stalled = stall.is_set() and not rec["stall"]
            if stalled:
                # the card, held up ~0.2 s behind this batch, is the slower side
                torch.cuda._sleep(400_000_000)
            running = False  # the batch still on the card as its dispatch returns
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()
                running = not done.query()
        if inside and window.is_set():
            rec["dispatch"].append((len(frames_), before, running,
                                    dict(Counter(warp_kernel.warp_rois.launches_by_size) - k3),
                                    stem_kernel.fused_stem.launches - k4, took))
        if stall.is_set():
            rec["stall"].append((len(frames_), before, running, stalled))

        def resolve_tagged():
            per_frame = resolve()
            for faces in per_frame:
                for f in faces:
                    f.batch_bucket = bucket(len(frames_))
            return per_frame

        return resolve_tagged

    def match_faces(self, frame, faces, company_id, draw=True):
        inside = window.is_set()
        k1, k2 = match_kernel.gallery_top1.launches, match_kernel.gallery_top1_int8.launches
        t0 = time.perf_counter()
        out = orig[1](self, frame, faces, company_id, draw=draw)
        took = time.perf_counter() - t0
        if inside and window.is_set():
            rec["match"].append((ReplayCapture.frame_index(frame),
                                 np.stack([f.normed_embedding for f in faces]) if faces else None,
                                 out[1], match_kernel.gallery_top1.launches - k1,
                                 match_kernel.gallery_top1_int8.launches - k2, took,
                                 getattr(faces[0], "batch_bucket", None) if faces else None,
                                 np.stack([f.bbox for f in faces]) if faces else None))
        return out

    def submit(self, source, frame, prepare=None):
        fut = orig[2](self, source, frame, prepare=prepare)

        def done(f):
            if getattr(f, "dropped", False):
                return
            if f.exception() is not None:
                rec["errors"].append(repr(f.exception()))
            elif window.is_set():
                rec["latency"].append(time.perf_counter() - f._t_submit)

        fut.add_done_callback(done)
        return fut

    def yuv420_flat(self, frames_y24_u8, det_threshold=0.3):
        rec["yuv_on_card"].append(isinstance(frames_y24_u8, torch.Tensor)
                                  and frames_y24_u8.device.type == dev.type)
        return orig[3](self, frames_y24_u8, det_threshold)

    def encode_frame(self, frame_bgr):
        t0 = time.perf_counter()
        out = orig[4](self, frame_bgr)
        if window.is_set():
            rec["encode"].append(time.perf_counter() - t0)
        return out

    (FaceAnalysis.get_batch_async, recognizer.FaceRecognitionProcessor.match_faces,
     microbatch.MicroBatcher.submit, FaceEngine.detect_align_embed_yuv420_flat,
     FaceAnalysis.encode_frame) = (get_batch_async, match_faces, submit, yuv420_flat,
                                   encode_frame)
    port = free_port()
    server = serve(build_app(gallery, cm), "127.0.0.1", port, background=True)
    base = f"http://127.0.0.1:{port}"
    trace_dir = tempfile.mkdtemp(prefix="fre_trace_")
    tag = f"[server {label}]"
    try:
        st, body = http_json("POST", base + "/api/camera/start", {"sources": [0]})
        check(st == 400 and body["status"] == "error", f"{tag} start without company: {st}")
        st, stats = http_json("GET", base + "/api/embeddings/stats")
        check(st == 200 and stats["total_embeddings"] == persons
              and stats["initial_load_complete"] is True, f"{tag} stats {st} {stats}")
        st, body = http_json("POST", base + "/api/embeddings/sync", {})
        check(st == 200 and body["status"] == "success", f"{tag} sync {st} {body}")
        t0 = time.perf_counter()
        st, body = http_json("POST", base + "/api/camera/start",
                             {"sources": [f"cam{i}" for i in range(SERVER_CAMERAS)],
                              "company_id": company})
        start_s = time.perf_counter() - t0
        check(st == 200 and body["status"] == "success", f"{tag} camera start {st} {body}")
        deadline = time.time() + 120
        while cm.stats["results"] == 0 and time.time() < deadline:
            time.sleep(0.05)
        check(cm.stats["results"] > 0, f"{tag} no result within 120 s: {cm.stats}")
        first_result_s = time.perf_counter() - t0
        time.sleep(SERVER_WARMUP_S)
        mb = cm.batcher

        def counts():
            return (ReplayCapture.offered, cm.stats["frames_captured"], mb.stats["frames"],
                    mb.stats["dispatches"], mb.stats["dropped"], cm.stats["results"],
                    cm.stats["results_dropped"])

        # the host: each role's threads' CPU seconds over the window
        roles = {"capture": list(cm.threads), "dispatch": [mb._thread],
                 "resolver": [t for t in threading.enumerate() if "_resolver_loop" in t.name],
                 "results": [cm._results_thread]}
        cpu0 = {r: thread_cpu_s(ts) for r, ts in roles.items()}
        proc0 = time.process_time()
        warp_kernel.warp_rois.launches = 0
        warp_kernel.warp_rois.launches_by_size.clear()
        stem_kernel.fused_stem.launches = 0
        match_kernel.gallery_top1.launches = 0
        match_kernel.gallery_top1_int8.launches = 0
        c0 = counts()
        window.set()
        tw = time.perf_counter()
        time.sleep(SERVER_WINDOW_S)
        window.clear()
        # the launches and counts first: a call that begins after the window
        # closed must not reach them
        launches = {"warp_rois": dict(warp_kernel.warp_rois.launches_by_size),
                    "fused_stem": stem_kernel.fused_stem.launches,
                    "gallery_top1": match_kernel.gallery_top1.launches,
                    "gallery_top1_int8": match_kernel.gallery_top1_int8.launches}
        offered, captured, dispatched, dispatches, dropped, results, results_dropped = (
            b - a for a, b in zip(c0, counts()))
        dt = time.perf_counter() - tw
        cores = {r: (thread_cpu_s(ts) - cpu0[r]) / dt for r, ts in roles.items()}
        cores["process"] = (time.process_time() - proc0) / dt
        if dev.type == "cuda" and label == "b":
            # the pipeline with the card as the slower side: one dispatch
            # holds the card up, and the next must begin before the batch
            # it dispatched is resolved
            stall.set()
            time.sleep(1.5)
            stall.clear()
        st1, b1 = http_json("POST", base + "/api/profiler/start", {"logdir": trace_dir})
        time.sleep(1.0)
        st2, b2 = http_json("POST", base + "/api/profiler/stop", {})
        check(st1 == 200 and st2 == 200 and b2.get("logdir") == trace_dir,
              f"{tag} profiler over HTTP: {st1} {b1} {st2} {b2}")
        traced, busy_share = trace_kernels(trace_dir)
        host_calls = trace_host(trace_dir, roles)
        st, snap = http_json("GET", base + "/api/metrics")
        check(st == 200 and snap["counters"].get("microbatch.frames", 0) >= cm.stats["results"]
              and snap["timers"].get("microbatch.dispatch", {}).get("count", 0) > 0,
              f"{tag} /api/metrics: {st} {snap.get('counters')}")
        threads = list(cm.threads) + [cm._results_thread, mb._thread] + [
            t for t in threading.enumerate() if "_resolver_loop" in t.name]
        t0 = time.perf_counter()
        st, body = http_json("POST", base + "/api/camera/stop", {})
        while any(t.is_alive() for t in threads) and time.perf_counter() - t0 < 10:
            time.sleep(0.02)
        stop_s = time.perf_counter() - t0
        alive = [t.name for t in threads if t.is_alive()]
        check(st == 200 and body["status"] == "success" and not alive,
              f"{tag} camera stop {st} {body}, threads alive after 10 s: {alive}")
        captured_all, dispatched_all = cm.stats["frames_captured"], mb.stats["frames"]
        adapt_log = [list(x) for x in mb.adapt_log]
        # the same calls with the server's threads stopped: one batch of the
        # 8 frames (dispatch, then resolve) and match_faces with the HUD
        frames = ReplayCapture.frames
        alone_batch, alone_match = [], []

        def batch8():
            return cm.face_app.get_batch_async([
                cm.face_app.encode_frame(f) if cfg.engine.stream_transport != "rgb" else f
                for f in frames])()

        for _ in range(3):
            t0 = time.perf_counter()
            faces = batch8()
            alone_batch.append((time.perf_counter() - t0) * 1e3)
        # the same batch's CUDA calls, traced on this thread alone
        alone_dir = tempfile.mkdtemp(prefix="fre_alone_")
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                        + ([torch.profiler.ProfilerActivity.CUDA]
                                           if dev.type == "cuda" else [])) as prof:
                batch8()
            prof.export_chrome_trace(os.path.join(alone_dir, "alone.json"))
            alone_calls = trace_host(alone_dir, {"alone": [threading.current_thread()]}).get(
                "alone", {})
        finally:
            shutil.rmtree(alone_dir, ignore_errors=True)
        for f, fl in zip(frames, faces):
            t0 = time.perf_counter()
            cm.processor.match_faces(f.copy(), fl, company, draw=True)
            alone_match.append((time.perf_counter() - t0) * 1e3)
        # encode_frame alone (run b): with the upload, and without it
        alone_encode = {}
        if cfg.engine.stream_transport != "rgb":
            app, cfg0 = cm.face_app, cm.face_app.cfg
            for upload in (True, False):
                app.cfg = dataclasses.replace(cfg0, upload_on_submit=upload)
                t_ = []
                for f in frames * 3:
                    t0 = time.perf_counter()
                    app.encode_frame(f)
                    t_.append((time.perf_counter() - t0) * 1e3)
                alone_encode["upload" if upload else "host"] = float(np.median(t_))
            app.cfg = cfg0
    finally:
        (FaceAnalysis.get_batch_async, recognizer.FaceRecognitionProcessor.match_faces,
         microbatch.MicroBatcher.submit, FaceEngine.detect_align_embed_yuv420_flat,
         FaceAnalysis.encode_frame) = orig
        server.shutdown()
        server.server_close()
        gallery.stop_sync()
        shutil.rmtree(trace_dir, ignore_errors=True)

    lat = sorted(rec["latency"])
    disp = rec["dispatch"]
    check(lat and disp, f"{tag} {len(lat)} frames resolved, {len(disp)} dispatches recorded "
          f"in the window")
    busy_call = {"dispatch": sum(d[5] for d in disp) / dt,
                 "results": sum(m[5] for m in rec["match"]) / dt,
                 "capture_encode": sum(rec["encode"]) / dt}
    out = {"run": label, "card": card, "cameras": SERVER_CAMERAS, "fps_per_camera": SERVER_FPS,
           "window_s": dt, "offered": offered, "captured": captured, "dispatched": dispatched,
           "dispatches": dispatches, "avg_batch": dispatched / max(1, dispatches),
           "max_batch": max(d[0] for d in disp), "drop_share": 1 - dispatched / max(1, captured),
           "batcher_dropped": dropped, "resolved": len(lat), "resolved_fps": len(lat) / dt,
           "p50_ms": lat[len(lat) // 2] * 1e3, "p90_ms": lat[int(len(lat) * 0.9)] * 1e3,
           "results": results, "results_dropped": results_dropped,
           "launches": launches, "traced_kernels": dict(traced), "camera_start_s": start_s,
           "first_result_s": first_result_s, "stop_s": stop_s,
           "captured_total": captured_all, "dispatched_total": dispatched_all,
           "dispatch_call_ms_p50": float(np.median([d[5] for d in disp])) * 1e3,
           "match_call_ms_p50": float(np.median([m[5] for m in rec["match"]] or [0])) * 1e3,
           "resolve_ms_p50": snap["timers"].get("microbatch.resolve", {}).get("p50_ms"),
           "dispatch_loop_ms_p50": snap["timers"].get("microbatch.dispatch", {}).get("p50_ms"),
           "device_busy_share_traced": busy_share,
           "alone_batch8_ms": alone_batch, "alone_match_ms_p50": float(np.median(alone_match)),
           "thread_cores": cores, "in_call_share": busy_call, "traced_cuda_calls": host_calls,
           "alone_batch8_cuda_calls": alone_calls,
           "encode_ms_p50": float(np.median(rec["encode"])) * 1e3 if rec["encode"] else None,
           "encode_ms_p90": (float(np.percentile(rec["encode"], 90)) * 1e3
                             if rec["encode"] else None),
           "alone_encode_ms_p50": alone_encode}
    if label == "b":
        out["adapt_log"] = adapt_log
    say(f"{tag} {card} | {SERVER_CAMERAS} cameras x {SERVER_FPS:.0f} fps over {dt:.2f} s: "
        f"offered {offered}, captured {captured}, dispatched {dispatched} in {dispatches} "
        f"batches (avg {out['avg_batch']:.2f}, max {out['max_batch']}), drop share "
        f"{out['drop_share']:.3f}; resolved {out['resolved_fps']:.1f} frames/s, submit->resolve "
        f"p50 {out['p50_ms']:.1f} ms p90 {out['p90_ms']:.1f} ms; results stage dropped "
        f"{results_dropped}; host p50 ms: get_batch_async {out['dispatch_call_ms_p50']:.1f}, "
        f"resolve {out['resolve_ms_p50'] or 0:.1f}, match_faces a frame "
        f"{out['match_call_ms_p50']:.1f} (alone: a batch of 8 "
        f"{[round(t, 1) for t in alone_batch]}, match_faces {out['alone_match_ms_p50']:.1f}); "
        f"device busy {100 * busy_share:.1f}% of the traced second; launches {launches}; "
        f"camera start {start_s:.1f} s "
        f"(first result {first_result_s:.1f} s), stop {stop_s:.2f} s")
    # the host over the window: each role's CPU (cores) beside the share of
    # the window its thread spent inside its call; off a core inside a call
    # while the card idles is waiting: for the interpreter lock, or for the
    # card's queue where a call synchronizes
    say(f"{tag} {card} | host over the window: process {cores['process']:.2f} cores; dispatch "
        f"thread inside get_batch_async {100 * busy_call['dispatch']:.0f}% of the window, on a "
        f"core {100 * cores['dispatch']:.0f}%; results thread inside match_faces "
        f"{100 * busy_call['results']:.0f}%, on a core {100 * cores['results']:.0f}%; resolver "
        f"on a core {100 * cores['resolver']:.0f}%; {len(roles['capture'])} capture threads on a "
        f"core {100 * cores['capture']:.0f}% together"
        + (f", inside encode_frame {100 * busy_call['capture_encode']:.0f}% together: "
           f"encode_frame p50 {out['encode_ms_p50']:.3f} ms p90 {out['encode_ms_p90']:.3f} ms "
           f"(alone: {alone_encode['upload']:.3f} ms with the upload, "
           f"{alone_encode['host']:.3f} ms without)" if rec["encode"] else ""))
    say(f"{tag} {card} | CUDA calls in the traced second, by thread: "
        + "; ".join(f"{role}: {host_line(c)}" for role, c in sorted(
            host_calls.items(), key=lambda rc: -sum(ms for _, ms in rc[1].values()))[:6])
        + f"; alone, a batch of 8: {host_line(alone_calls)}")

    # decisions: a frame's faces depend on the bucket its batch was padded
    # to (batch_witness), so each resolved frame is held against its own
    # bucket's faces: each box within 1 px of its own face's, and each face
    # decided as its own enrolled id, which a float64 match on the host must
    # also find (its top-1 within 1e-5); no id for two distinct faces
    thresh = cfg.thresholds.recognition
    check(not rec["errors"], f"{tag} futures ended in exceptions: {rec['errors'][:3]}")
    # a frame matched as the window opens or closes reaches one list only
    check(decisions and abs(len(decisions) - len(rec["match"])) <= 2,
          f"{tag} {len(decisions)} results, {len(rec['match'])} matches in the window")
    table, own_id, ids = run["table"], run["own"], run["ids"]
    row_of = {pid: i for i, pid in enumerate(ids)}
    gal64 = run["matrix"] / np.linalg.norm(run["matrix"], axis=1, keepdims=True)
    n_faces, under_margin, near_dup, not_own, box_px, emb_gap, int8_gap = 0, 0, 0, 0, 0.0, 0.0, 0.0
    by_bucket = Counter()
    if label == "b":
        snap = gallery.snapshot(company)
    for k, embs, rows, _, _, _, b, boxes in rec["match"]:
        check(embs is not None and b in table, f"{tag} frame {k}: no face, or no bucket ({b})")
        want_boxes, want_embs = table[b][k]
        check(len(rows) == len(embs) == len(want_embs),
              f"{tag} frame {k} in bucket {b}: {len(embs)} faces, {len(want_embs)} expected")
        by_bucket[b] += 1
        box_px = max(box_px, float(np.abs(boxes - want_boxes).max()))
        q = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
        emb_gap = max(emb_gap, float(1.0 - (q * want_embs).sum(1).min()))
        check(box_px <= 1.0 and emb_gap <= 1e-5, f"{tag} frame {k} in bucket {b}: boxes "
              f"{box_px:.3f} px and 1 - cos {emb_gap:.2e} from the bucket's faces")
        s64 = q.astype(np.float64) @ gal64.T
        pairs = []
        for j, row in enumerate(rows):
            own = own_id[want_embs[j].tobytes()]
            top = s64[j].max()
            near = {ids[i] for i in np.flatnonzero(s64[j] >= top - 1e-5)}
            near_dup += len(near) > 1
            check(own in near and row["recognized"],
                  f"{tag} frame {k}: face {j}'s own id {own} scores {s64[j, row_of[own]]:.6f} "
                  f"on the host, the top-1 {top:.6f}; recognized {row['recognized']}")
            if label == "a":
                # K1 (f32) may order ids within 1e-5 of the top either way
                check(row["person_id"] in near and row["similarity"] >= 0.99,
                      f"{tag} frame {k}: face {j} took {row['person_id']} at "
                      f"{row['similarity']:.4f}, want its own {own} (or one within 1e-5)")
                if len(near) == 1:
                    pairs.append((own, row["person_id"]))
            else:
                # int8 may flip ids whose float64 scores lie within the
                # margin of the top-1 (the yuv phase's rule), no further: where
                # the top-1 leads by more, K2 gives the face's own id
                gap = top - s64[j, row_of[row["person_id"]]] if row["recognized"] else 1.0
                int8_gap = max(int8_gap, float(gap))
                check(gap <= INT8_MARGIN, f"{tag} frame {k}: face {j} took "
                      f"{row['person_id']} through K2, {gap:.2e} under its own {own} on the host")
                if top - np.partition(s64[j], -2)[-2] > INT8_MARGIN:
                    check(row["person_id"] == own, f"{tag} frame {k}: face {j} took "
                          f"{row['person_id']} through K2, want its own {own} (lead > margin)")
                    pairs.append((own, row["person_id"]))
                else:
                    under_margin += 1
                    not_own += row["person_id"] != own
        check(len({d for _, d in pairs}) == len({o for o, _ in pairs}),
              f"{tag} frame {k}: one id for two distinct faces: {pairs}")
        if label == "b":
            qd = torch.from_numpy(np.concatenate(
                [q, np.zeros((bucket(len(q)) - len(q), 512), np.float32)])).to(dev)
            pv, pi = match_kernel.gallery_top1_int8_plain(qd, snap.device_matrix,
                                                          snap.int8_scale, snap.size)
            for row, v, i in zip(rows, pv.cpu().numpy(), pi.cpu().numpy()):
                want = snap.ids[i] if v >= thresh else None
                check(row["similarity"] == float(v) and row["person_id"] == want,
                      f"{tag} K2 on the path {row['person_id']} {row['similarity']} vs plain "
                      f"{want} {float(v)}")
        n_faces += len(rows)

    # launches: each call's own, and the window's counts
    k3_want = {112: 1, 96: 1, 192: 1} if label == "a" else {112: 1}
    k4_want = 0 if label == "a" else 1
    match_want = (1, 0) if label == "a" else (0, 1)
    matched = [m for m in rec["match"] if m[1] is not None]
    check(disp and all(d[3] == k3_want and d[4] == k4_want for d in disp),
          f"{tag} a dispatch must launch K3 {k3_want} and K4 {k4_want}: "
          f"{[d[3:5] for d in disp if d[3] != k3_want or d[4] != k4_want][:3]}")
    check(matched and all(m[3:5] == match_want for m in matched),
          f"{tag} a matched frame must launch (K1, K2) {match_want}")
    by_size = launches["warp_rois"]
    k1_window = launches["gallery_top1" if label == "a" else "gallery_top1_int8"]
    # calls that straddle the window's ends launch inside it but are not
    # recorded: at most one a thread at each end
    check(all(len(disp) <= by_size.get(size, 0) <= len(disp) + 2 for size in k3_want)
          and set(by_size) == set(k3_want)
          and len(disp) * k4_want <= launches["fused_stem"] <= (len(disp) + 2) * k4_want
          and len(matched) <= k1_window <= len(matched) + 2
          and launches["gallery_top1" if label == "b" else "gallery_top1_int8"] == 0,
          f"{tag} the window's launches {launches} against {len(disp)} dispatches and "
          f"{len(matched)} matched frames")
    want_traced = (("warp_windows_kernel", "top1_f32_kernel") if label == "a"
                   else ("fused_stem", "warp_windows_kernel", "top1_int8_kernel"))
    hits = {w: sum(n for name, n in traced.items() if w in name) for w in want_traced}
    check(all(hits.values()), f"{tag} the HTTP-controlled trace lacks device events: {hits} "
          f"(traced: {dict(traced.most_common(8))})")

    # batching
    check(max(d[0] for d in disp) > 1, f"{tag} no dispatch held more than one frame")
    check(captured_all > dispatched_all, f"{tag} captured {captured_all} <= dispatched "
          f"{dispatched_all}: the capture did not run free")
    # in the window: dispatches that began while the batch before was
    # unresolved, and of those the ones whose batch before still ran on the
    # card as its dispatch returned (timing: the host is the slower side
    # here); with the card held up once after the window, the next dispatch
    # must begin while the held batch is still unresolved
    unresolved = sum(1 for nxt in disp[1:] if nxt[1] >= 1)
    overlapped = sum(1 for d, nxt in zip(disp, disp[1:]) if d[2] and nxt[1] >= 1)
    if label == "b" and dev.type == "cuda":
        held = rec["stall"]
        check(len(held) >= 2 and held[0][3] and held[0][2] and held[1][1] >= 1,
              f"{tag} with the card held up, the next batch was not dispatched while the held "
              f"one was unresolved: (frames, unresolved before, on the card, held) {held[:3]}")
        check(rec["yuv_on_card"] and all(rec["yuv_on_card"]),
              f"{tag} a stacked yuv batch reached the engine off the card: {rec['yuv_on_card']}")
    out.update(faces_decided=n_faces, max_box_shift_px=box_px, max_embedding_gap=emb_gap,
               frames_by_bucket=dict(by_bucket), near_duplicate_faces=near_dup,
               under_int8_margin=under_margin, int8_not_own=not_own,
               int8_max_gap=int8_gap, dispatches_unresolved_before=unresolved,
               dispatches_overlapping=overlapped,
               traced_kernels=hits)
    margin = (f"; K2 equal to the plain int8 match on every face, its id within "
              f"{int8_gap:.2e} of the host's top-1 score; {under_margin} faces whose top-1 "
              f"leads by less than {INT8_MARGIN} ({not_own} of them took another id there)"
              if label == "b" else "")
    say(f"{tag} {card} | {n_faces} faces of {len(rec['match'])} frames (by bucket "
        f"{dict(sorted(by_bucket.items()))}): each face's own enrolled id is the host's "
        f"float64 top-1 (within 1e-5; {near_dup} faces with another id that close)"
        + (", and K1 decided it at >= 0.99" if label == "a" else "")
        + f"; no id for two distinct faces; boxes within {box_px:.3f} px and 1 - cos {emb_gap:.2e} of their "
        f"bucket's faces{margin}; trace {hits}; {unresolved}/{len(disp) - 1} dispatches while "
        f"the batch before was unresolved, {overlapped} of them while it still ran on the card"
        + (f"; card held up: {rec['stall'][:3]}" if rec["stall"] else "")
        + (f"; adapt_log (t, p50 ms, fps, depth, inflight) {adapt_log}" if label == "b" else ""))
    return out


def png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``rgb`` (HxWx3 uint8), written with the standard
    library: rows Sub-filtered, zlib level 1."""
    h, w, _ = rgb.shape
    rows = rgb.reshape(h, w * 3)
    sub = rows.copy()
    sub[:, 3:] -= rows[:, :-3]  # uint8 arithmetic wraps mod 256, as the filter does
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def kiosk_person(seed: int, poses: int = 3) -> list:
    """One person's seeded KIOSK_W x KIOSK_H RGB kiosk-webcam photos: a
    shaded backdrop with filled ellipses of its own colours, each pose the
    scene moved by up to 8 px, with sensor noise of +-3."""
    rng = np.random.default_rng(seed)
    yy = np.arange(KIOSK_H, dtype=np.float32)[:, None]
    xx = np.arange(KIOSK_W, dtype=np.float32)[None, :]
    c0, c1 = rng.uniform(30, 220, 3), rng.uniform(30, 220, 3)
    t = xx * rng.uniform(-1, 1) + yy * rng.uniform(-1, 1)
    t = (t - t.min()) / max(float(t.max() - t.min()), 1.0)
    scene = (c0 + (c1 - c0) * t[..., None]).astype(np.uint8)
    for _ in range(6):
        cx, cy = rng.uniform(0, KIOSK_W), rng.uniform(0, KIOSK_H)
        ax, ay = rng.uniform(40, 300, 2)
        y0, y1 = int(max(cy - ay, 0)), int(min(cy + ay + 1, KIOSK_H))
        x0, x1 = int(max(cx - ax, 0)), int(min(cx + ax + 1, KIOSK_W))
        inside = ((xx[:, x0:x1] - cx) / ax) ** 2 + ((yy[y0:y1] - cy) / ay) ** 2 <= 1
        scene[y0:y1, x0:x1][inside] = rng.integers(0, 256, 3)
    shots = []
    for _ in range(poses):
        dy, dx = rng.integers(-8, 9, 2)
        moved = np.roll(scene, (int(dy), int(dx)), (0, 1)).astype(np.int16)
        shots.append(np.clip(moved + rng.integers(-3, 4, scene.shape, dtype=np.int16),
                             0, 255).astype(np.uint8))
    return shots


def largest_face(faces):
    """The enrollment worker's pick among a photo's faces (the largest box,
    areas in the boxes' float32) -> its index."""
    areas = [(f.bbox[2] - f.bbox[0]) * (f.bbox[3] - f.bbox[1]) for f in faces]
    return int(np.argmax(areas))


class ErrorLog(logging.Handler):
    """The records of WARNING and above a logger gets (the reference's broad
    ``except`` blocks log there and carry on), but for ``ignore``'s
    messages."""

    def __init__(self, ignore: tuple = ()):
        super().__init__(logging.WARNING)
        self.ignore, self.records = ignore, []

    def emit(self, record):
        msg = record.getMessage()
        if not any(part in msg for part in self.ignore):
            self.records.append(f"{record.name}: {msg}")


class RecordingDetector:
    """The enrollment worker's detector: the real FaceAnalysis, each ``get``
    recorded (the photo's hash, the faces, host ms, the calling thread's
    current card).  A measurement hook: the worker's code is unchanged."""

    def __init__(self, app):
        self.app, self.device = app, app.device
        self.calls, self._lock = [], threading.Lock()

    def get(self, img, max_num: int = 0):
        import torch

        t0 = time.perf_counter()
        faces = self.app.get(img, max_num)
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.calls.append((hashlib.sha1(img.tobytes()).hexdigest(), faces, ms,
                               torch.cuda.current_device()))
        return faces


def _unit64(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _pct(values, q) -> float:
    return float(np.percentile(values, q)) if len(values) else float("nan")


def done_embeddings(ds, company=None) -> dict:
    """Every employee whose buffalo_l entry is done (of ``company``, or all)
    -> (id hex, employeeId) -> its stored embedding, read from the store."""
    from facerecognition_infrenceengine_tpu_torch.core.serialization import (
        deserialize_embedding)

    query = {"employeeEmbeddings.buffalo_l.status": "done"}
    if company is not None:
        query["companyId"] = company
    out = {}
    for doc in ds.employee_info.find(query):
        blob = ds.employee_embeddings.get(doc["employeeEmbeddings"]["buffalo_l"]["embeddingId"])
        out[(str(doc["_id"]), doc["employeeId"])] = deserialize_embedding(blob.read())
    return out


def enroll_phase(torch, card: str, ds, cfg, gallery, app) -> tuple:
    """[enroll]: the REST API (create_app over HTTP on web.serving) registers
    ENROLL_EMPLOYEES employees of one company with the 3 POSES photos each
    at 1280x720 (PNG, or JPEG where the host codec has libjpeg), then
    ENROLL_DUPLICATES of them again under new employee ids with the same
    photos; a FaceEmbeddingWorker with ``cfg`` and ``app`` (FaceAnalysis(
    "buffalo_l") with its four modules on the card, as the worker builds it)
    drains each wave in its run loop on its executor threads.  Launch counts
    are zeroed before the first register call and read once the queue is
    drained (K3), and around the gallery match (K1).  Checked: every job
    ends done, failed or duplicate with no retry and nothing logged by the
    worker at warning or above; each photo's faces in the worker equal a
    direct get of the same photo bit for bit, on the detector's card; each
    status and stored embedding equals the reference's rules replayed on the
    host in float64 over those faces (largest face, poses pairwise >=
    same_person, their mean, a company duplicate > duplicate_face among the
    done entries the company held when the job ran); the re-registrations
    end duplicate; after one force_sync ``gallery`` holds every done
    employee of the store and matches each one's center photo through K1 to
    the host's float64 top-1 of its company.  -> (the phase's record, the
    photos' encoded bytes)."""
    from facerecognition_infrenceengine_tpu_torch import native
    from facerecognition_infrenceengine_tpu_torch.api import create_app
    from facerecognition_infrenceengine_tpu_torch.api.constants import POSES
    from facerecognition_infrenceengine_tpu_torch.core.clock import get_current_utc
    from facerecognition_infrenceengine_tpu_torch.domain.enrollment import FaceEmbeddingWorker
    from facerecognition_infrenceengine_tpu_torch.ops import match_kernel, warp_kernel
    from facerecognition_infrenceengine_tpu_torch.store import ObjectId
    from facerecognition_infrenceengine_tpu_torch.web import serve

    t_phase = time.perf_counter()
    jpeg = native.have_jpeg()
    fmt = "jpeg" if jpeg else "png"

    def person(n):  # numpy and zlib release the interpreter lock: 8 at a time
        return [native.encode_jpeg(p, quality=95) if jpeg else png_bytes(p)
                for p in kiosk_person(2100 + n)]

    with ThreadPoolExecutor(8) as pool:
        encoded = list(pool.map(person, range(ENROLL_EMPLOYEES)))
    gen_s = time.perf_counter() - t_phase
    if not jpeg:
        # without libjpeg a JPEG upload decodes through Pillow, where it imports
        try:
            from PIL import Image
        except ImportError:
            say("[enroll] no Pillow on this host: JPEG uploads do not decode here")
        else:
            photo = kiosk_person(2100, poses=1)[0]
            buf = io.BytesIO()
            Image.fromarray(photo).save(buf, "JPEG", quality=95)
            got = native.decode_image(buf.getvalue())
            check(got is not None and np.array_equal(
                got, np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))),
                "[enroll] a JPEG photo did not decode through Pillow")
            say("[enroll] a JPEG photo decodes through Pillow on this host (no libjpeg)")
    say(f"[enroll] {card} | {ENROLL_EMPLOYEES} x {len(POSES)} photos {KIOSK_W}x{KIOSK_H} as {fmt} "
        f"({sum(len(b) for s in encoded for b in s) / 2**20:.1f} MiB; host codec JPEG "
        f"{'compiled in' if jpeg else 'not compiled: no libjpeg, so PNG, decoded through PIL'}) "
        f"made in {gen_s:.1f} s")

    alone = []  # one photo's get with the card to itself
    img = np.ascontiguousarray(native.decode_image(encoded[0][0])[..., ::-1])
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        app.get(img)
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)
    detector = RecordingDetector(app)
    worker = FaceEmbeddingWorker(ds, cfg, detector=detector, worker_id="smoke-worker")
    errors = ErrorLog(ignore=("usage too high",))
    logging.getLogger("fre.enrollment").addHandler(errors)
    api = create_app(ds, cfg)
    port = free_port()
    server = serve(api, "127.0.0.1", port, background=True)
    base = f"http://127.0.0.1:{port}{cfg.api.url_prefix}"
    st, body = http_json("POST", base + "/companies/seed")
    check(st == 201, f"[enroll] seeding a company: {st} {body}")
    company = body["company"]["_id"]
    company_oid = ObjectId(company)
    employees = [(f"K{n:03d}", n) for n in range(ENROLL_EMPLOYEES)]
    dups = [(f"K{n:03d}-again", n) for n in range(0, ENROLL_EMPLOYEES,
                                                   ENROLL_EMPLOYEES // ENROLL_DUPLICATES)]
    registered = {}
    warp_kernel.warp_rois.launches_by_size.clear()
    warp_kernel.warp_rois.launches = 0
    match_kernel.gallery_top1.launches = 0
    thread = threading.Thread(target=worker.run, name="enroll-worker", daemon=True)
    t_drain = time.perf_counter()
    thread.start()
    reg_ms = []
    try:
        for wave in (employees, dups):
            for emp, n in wave:
                files = {pose: (f"{pose}.{fmt}", encoded[n][k], f"image/{fmt}")
                         for k, pose in enumerate(POSES)}
                t0 = time.perf_counter()
                st, body = http_json("POST", base + "/employees/register",
                                     {"employeeId": emp, "employeeName": f"Kiosk {emp}",
                                      "companyId": company}, files=files)
                reg_ms.append((time.perf_counter() - t0) * 1e3)
                check(st == 200, f"[enroll] register {emp}: {st} {body}")
                registered[emp] = (n, get_current_utc())
            deadline = time.time() + 300
            while ds.embedding_jobs.count_documents(
                    {"model": cfg.worker.model_name,
                     "status": {"$in": ["queued", "started"]}}) > 0:
                check(time.time() < deadline and thread.is_alive(),
                      "[enroll] the worker did not drain the queue in 300 s")
                time.sleep(0.05)
        drain_s = time.perf_counter() - t_drain  # both waves, registration included
    finally:
        worker.stop()
        thread.join(timeout=60)
        server.shutdown()
        server.server_close()
        logging.getLogger("fre.enrollment").removeHandler(errors)
    k3 = dict(warp_kernel.warp_rois.launches_by_size)
    check(not thread.is_alive(), "[enroll] the worker's run loop did not stop")
    check(not errors.records, f"[enroll] the worker logged {len(errors.records)} warnings or "
          f"errors (its broad except blocks): {errors.records[:5]}")

    # every job terminal, first time round
    docs = {d["employeeId"]: d for d in ds.employee_info.find({"companyId": company_oid})}
    jobs = {}
    for emp in registered:
        job = ds.embedding_jobs.find_one({"employeeId": docs[emp]["_id"],
                                          "model": cfg.worker.model_name})
        check(job["status"] in ("done", "failed", "duplicate") and "retryCount" not in job,
              f"[enroll] job of {emp}: {job['status']}, retries {job.get('retryCount')}, "
              f"{job.get('error')}")
        jobs[emp] = job

    # the gallery, right after the drain: every done employee after one
    # force_sync, and K1 on the center photos' faces as the worker got them
    seen = {}
    for key, faces, ms, dev_index in detector.calls:
        check(dev_index == torch.device(app.device).index,
              f"[enroll] an executor thread ran get on card {dev_index}, not {app.device}")
        seen.setdefault(key, []).append(faces)
    photo_key = {(n, k): hashlib.sha1(np.ascontiguousarray(
        native.decode_image(encoded[n][k])[..., ::-1]).tobytes()).hexdigest()
        for n in range(ENROLL_EMPLOYEES) for k in range(len(POSES))}
    check(set(photo_key.values()) <= set(seen), "[enroll] the worker never ran a photo")
    stored = done_embeddings(ds, company_oid)
    t0 = time.perf_counter()
    gallery.force_sync()
    sync_ms = (time.perf_counter() - t0) * 1e3
    total = gallery.get_stats()["total_embeddings"]
    every = done_embeddings(ds)
    check(total == len(every), f"[enroll] the gallery holds {total} after force_sync, the "
          f"store {len(every)} done employees")
    done = list(stored)
    center_faces = [seen[photo_key[(registered[emp][0], 0)]][0] for _, emp in done]
    centers = np.stack([fl[largest_face(fl)].normed_embedding for fl in center_faces])
    match_kernel.gallery_top1.launches = 0
    t0 = time.perf_counter()
    scores, ids, _ = gallery.match(centers, company_id=company)
    match_ms = (time.perf_counter() - t0) * 1e3
    k1 = match_kernel.gallery_top1.launches
    served = get_current_utc()
    index = {pid: i for i, (pid, _) in enumerate(done)}
    host = _unit64(centers) @ _unit64(np.stack([stored[key] for key in done])).T
    own = 0
    for i, (pid, emp) in enumerate(done):
        top, k = int(np.argmax(host[i])), index.get(ids[i][0])
        check(k is not None and host[i][k] >= host[i][top] - 1e-5,
              f"[enroll] {emp}'s center photo matched {ids[i][0]}, the float64 top-1 is "
              f"{done[top][0]}")
        own += ids[i][0] == pid
    check(all(k3.get(size, 0) > 0 for size in (112,) + ATTR_SIZES) and k1 > 0,
          f"[enroll] a kernel was not launched: K3 by size {k3}, K1 {k1}")

    # each photo's faces in the worker == a direct get of the same photo
    direct = {}
    for (n, k), key in photo_key.items():
        img = np.ascontiguousarray(native.decode_image(encoded[n][k])[..., ::-1])
        faces = app.get(img)
        for got in seen[key]:
            check(len(got) == len(faces) and all(
                np.array_equal(g.bbox, f.bbox) and np.array_equal(
                    g.normed_embedding, f.normed_embedding) for g, f in zip(got, faces)),
                f"[enroll] photo {n}/{POSES[k]}: the worker's faces differ from a direct get")
        direct[(n, k)] = faces
    photo_calls = len(detector.calls)

    # the reference's rules, replayed on the host in float64
    thr_same, thr_dup = cfg.thresholds.same_person, cfg.thresholds.duplicate_face
    by_emp = {emp: vec for (_, emp), vec in stored.items()}
    entries = {emp: docs[emp]["employeeEmbeddings"][cfg.worker.model_name] for emp in registered}
    ambiguous, statuses = 0, Counter()
    for emp, (n, _) in registered.items():
        job, entry = jobs[emp], entries[emp]
        check(entry["status"] == job["status"], f"[enroll] {emp}: the entry says "
              f"{entry['status']}, the job {job['status']}")
        statuses[job["status"]] += 1
        embs = [direct[(n, k)][largest_face(direct[(n, k)])].normed_embedding
                for k in range(len(POSES)) if direct[(n, k)]]
        check(len(embs) == len(POSES), f"[enroll] {emp}: a photo has no face")
        u = _unit64(embs)
        sims = [float(u[i] @ u[j]) for i in range(len(u)) for j in range(i + 1, len(u))]
        if min(abs(x - thr_same) for x in sims) < REPLAY_EPS:
            ambiguous += 1
            continue
        if min(sims) < thr_same:
            check(job["status"] == "failed" and "Different persons" in job.get("error", ""),
                  f"[enroll] {emp}: poses at cosine {min(sims):.4f} < {thr_same}, yet "
                  f"{job['status']}")
            continue
        avg = np.mean(np.stack([np.asarray(e, np.float32) for e in embs]), axis=0)
        # the company's done entries before this job started, and before it ended
        outcomes = set()
        for until in (job["startedAt"], job["finishedAt"]):
            cands = [e for e in by_emp if e != emp and entries[e]["finishedAt"] < until]
            if not cands:
                outcomes.add(("done", None))
                continue
            scores = _unit64(np.stack([by_emp[e] for e in cands])) @ _unit64(avg)
            best = int(np.argmax(scores))
            if scores[best] > thr_dup - REPLAY_EPS:
                outcomes.add(("duplicate", cands[best]))
            if scores[best] <= thr_dup + REPLAY_EPS:
                outcomes.add(("done", None))
        got = (job["status"], entry.get("duplicateOf"))
        ambiguous += int(len(outcomes) > 1)
        check(got in outcomes, f"[enroll] {emp}: {got}, the float64 replay gives {outcomes}")
        if job["status"] == "done":
            check(np.array_equal(by_emp[emp], avg),
                  f"[enroll] {emp}: the stored embedding is not the mean of its poses' faces")
    for emp, n in dups:
        check(jobs[emp]["status"] == "duplicate", f"[enroll] re-registration {emp} ended "
              f"{jobs[emp]['status']}")
    # how far apart the untrained embedder puts poses of one person, and persons
    largest = {key: _unit64(fl[largest_face(fl)].normed_embedding) for key, fl in direct.items()}
    pose_cos = [float(largest[(n, i)] @ largest[(n, j)]) for n in range(ENROLL_EMPLOYEES)
                for i in range(len(POSES)) for j in range(i + 1, len(POSES))]
    cross = np.stack([largest[(n, 0)] for n in range(ENROLL_EMPLOYEES)])
    cross = (cross @ cross.T)[np.triu_indices(ENROLL_EMPLOYEES, 1)]

    get_ms = [c[2] for c in detector.calls]
    job_ms = [(j["finishedAt"] - j["startedAt"]).total_seconds() * 1e3 for j in jobs.values()]
    reg_done = [(jobs[e]["finishedAt"] - registered[e][1]).total_seconds()
                for e in registered if jobs[e]["status"] == "done"]
    rec = {"card": card, "employees": ENROLL_EMPLOYEES, "reregistered": len(dups),
           "photo_format": fmt, "photo_shape": [KIOSK_H, KIOSK_W],
           "statuses": dict(statuses), "ambiguous_in_replay": ambiguous,
           "worker_threads": cfg.worker.max_workers, "photo_gets": photo_calls,
           "jobs_per_s": len(jobs) / drain_s, "drain_s": drain_s,
           "register_ms_p50": _pct(reg_ms, 50), "get_ms_p50": _pct(get_ms, 50),
           "get_ms_p90": _pct(get_ms, 90), "get_ms_alone": alone, "job_ms_p50": _pct(job_ms, 50),
           "job_ms_p90": _pct(job_ms, 90), "register_to_done_s_p50": _pct(reg_done, 50),
           "register_to_done_s_max": max(reg_done) if reg_done else None,
           "force_sync_ms": sync_ms, "first_match_ms": match_ms,
           "register_to_first_match_s_max": max(
               (served - registered[e][1]).total_seconds() for _, e in done) if done else None,
           "gallery_total": total, "center_matches_own_id": own, "center_matches": len(done),
           "pose_cosine_min": min(pose_cos), "pose_cosine_p50": _pct(pose_cos, 50),
           "person_cosine_p50": _pct(cross, 50), "person_cosine_p99": _pct(cross, 99),
           "person_cosine_max": float(cross.max()),
           "launches": {"warp_rois": k3, "gallery_top1": k1}}
    say(f"[enroll] {card} | {len(jobs)} jobs {dict(statuses)} in {drain_s:.1f} s "
        f"({rec['jobs_per_s']:.2f} jobs/s, {cfg.worker.max_workers} executor threads, no retry, "
        f"nothing logged); get a photo p50 {rec['get_ms_p50']:.1f} / p90 "
        f"{rec['get_ms_p90']:.1f} ms over {photo_calls} (alone "
        f"{', '.join(f'{t:.1f}' for t in alone)}), a job p50 {rec['job_ms_p50']:.0f} / p90 "
        f"{rec['job_ms_p90']:.0f} ms, register p50 {rec['register_ms_p50']:.0f} ms")
    say(f"[enroll] {card} | every photo's faces equal a direct get bit for bit; every status "
        f"and stored embedding equals the float64 replay ({ambiguous} within {REPLAY_EPS} of a "
        f"threshold or in a concurrent window); the {len(dups)} re-registrations are duplicates; "
        f"float64 cosine of one person's poses min {min(pose_cos):.4f} p50 "
        f"{rec['pose_cosine_p50']:.4f}, of two persons' center photos p50 "
        f"{rec['person_cosine_p50']:.4f} p99 {rec['person_cosine_p99']:.4f} max "
        f"{rec['person_cosine_max']:.4f}")
    say(f"[enroll] {card} | gallery {total} after one force_sync ({sync_ms:.0f} ms); "
        f"{len(done)} center photos matched through K1 in {match_ms:.1f} ms, each the "
        f"float64 top-1 ({own} their own id); register->done p50 "
        f"{rec['register_to_done_s_p50']:.2f} s max {rec['register_to_done_s_max']:.2f} s, "
        f"register->first match max {rec['register_to_first_match_s_max']:.2f} s; K3 "
        f"launches by crop size {k3}, K1 {k1}")
    return rec, encoded


def sample_stacks(threads, seconds: float, interval: float = 0.01) -> Counter:
    """Where ``threads`` spend their time: every ``interval`` s for ``seconds``,
    the innermost frame of each one's stack that lies in the port's package
    (file:function), counted."""
    ids = {t.ident for t in threads}
    seen = Counter()
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for tid, frame in sys._current_frames().items():
            if tid not in ids:
                continue
            where = "outside the package"
            while frame is not None:
                path = frame.f_code.co_filename
                if "facerecognition_infrenceengine_tpu_torch" in path:
                    where = f"{os.path.basename(path)}:{frame.f_code.co_name}"
                    break
                frame = frame.f_back
            seen[where] += 1
        time.sleep(interval)
    return seen


def count_phase(torch, card: str, frames: list, ds, cfg, gallery, company, app) -> dict:
    """[count]: servers/people_count as its main runs it, on the card:
    CameraStreamManager(gallery, CampusPeopleManager(ds, cfg,
    start_background=True), face_app=None, cfg) with COUNT_CAMERAS stand-in
    cameras (ReplayCapture over ``frames`` at SERVER_FPS; campus.frame_skip
    2), so each camera thread builds its own FaceAnalysis("buffalo_l") with
    its four modules and runs get on each kept frame, then the whole-gallery
    top-1 (K1).  ``company`` first enrolls every distinct face of
    frames[:-2] as ``app`` (the same model) gives them on one frame at a
    time, as the threads run it; the last two frames' faces are left out.
    build_app(manager) answers over HTTP during a COUNT_WINDOW_S window
    after a warm-up; launch counts are zeroed as the cameras start and read
    as they stop.  Checked: each detection carries
    the host's float64 top-1 over the whole gallery at >= the counting
    threshold, each unknown scored under the unknown threshold, and faces in
    the dead zone neither; the campus counters, every person's state and the
    unknown clusters equal a replay of the calls on a fresh
    CampusPeopleManager on the CPU; nothing is logged by the counting,
    campus or camera loops' except blocks.  Returns the phase's record."""
    from facerecognition_infrenceengine_tpu_torch.core import metrics
    from facerecognition_infrenceengine_tpu_torch.domain import campus, counting
    from facerecognition_infrenceengine_tpu_torch.domain.campus import (
        CameraType, CampusPeopleManager)
    from facerecognition_infrenceengine_tpu_torch.ops import match_kernel, warp_kernel
    from facerecognition_infrenceengine_tpu_torch.servers.people_count import build_app
    from facerecognition_infrenceengine_tpu_torch.store import Datastore
    from facerecognition_infrenceengine_tpu_torch.web import serve

    tag = "[count]"
    t0 = time.perf_counter()
    faces = {}  # embedding bytes -> embedding: one person each
    for frame in frames[:-2]:
        for f in app.get(frame):
            faces.setdefault(f.normed_embedding.tobytes(), f.normed_embedding)
    ids = write_people(ds, company, np.stack(list(faces.values())), "C")
    gallery.force_sync()
    everyone = done_embeddings(ds)
    gallery_ids = [pid for pid, _ in everyone]
    id_index = {pid: i for i, pid in enumerate(gallery_ids)}
    matrix = _unit64(np.stack(list(everyone.values())))
    check(gallery.get_stats()["total_embeddings"] == len(everyone),
          f"{tag} the gallery does not hold the store's {len(everyone)} done employees")
    say(f"{tag} {card} | {len(ids)} distinct faces of frames 1-{len(frames) - 2} enrolled "
        f"(whole gallery {len(everyone)}) in {time.perf_counter() - t0:.1f} s")

    alone = []  # one get of a frame with the card to itself, as each thread runs it
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        app.get(frames[0])
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t1) * 1e3)
    manager = CampusPeopleManager(ds, cfg, start_background=True)
    streams = counting.CameraStreamManager(gallery, manager, face_app=None, cfg=cfg)
    errors = ErrorLog()
    loggers = [logging.getLogger(n) for n in ("fre.counting", "fre.campus")]
    for lg in loggers:
        lg.addHandler(errors)
    # measurement hooks, removed after the run: the manager's state-changing
    # calls in their order (with the time a cleanup read), each processed
    # frame's read -> state latency, card and gallery matches
    order_lock, calls, frames_done = threading.Lock(), [], []
    local = threading.local()
    real_utc = campus.get_current_utc

    def logged(name):
        orig = getattr(manager, name)

        def call(*args):
            with order_lock:
                calls.append((name, args))
                rec = getattr(local, "rec", None)
                if rec is not None:
                    rec["calls"].append((name, args))
                return orig(*args)
        return call

    def cleanup():
        with order_lock:
            now = real_utc()
            calls.append(("cleanup_stale_detections", (now,)))
            campus.get_current_utc = lambda: now
            try:
                return orig_cleanup()
            finally:
                campus.get_current_utc = real_utc

    orig_cleanup = manager.cleanup_stale_detections
    for name in ("process_detection", "process_unknown_detection"):
        setattr(manager, name, logged(name))
    manager.cleanup_stale_detections = cleanup
    orig_match = gallery.match

    def match(embs, company_id=None, k=1):
        out = orig_match(embs, company_id=company_id, k=k)
        rec = getattr(local, "rec", None)
        if rec is not None:
            rec["matches"].append((np.array(embs), out[0], out[1], company_id))
        return out

    gallery.match = match
    orig_frame = counting.CountingProcessor.process_frame

    def process_frame(self, frame, camera_id):
        t_in = time.perf_counter()
        local.rec = {"camera": camera_id, "matches": [], "calls": [],
                     "read": ReplayCapture.read_time(frame)}
        try:
            stats = orig_frame(self, frame, camera_id)
        finally:
            rec, local.rec = local.rec, None
        with metrics.device_work():
            card_index = torch.cuda.current_device()
        rec.update(done=time.perf_counter(), stats=stats, card=card_index, start=t_in)
        with order_lock:
            frames_done.append(rec)
        return stats

    orig_faces = counting.CountingProcessor.process_faces

    def process_faces(self, faces, camera_id):
        t1 = time.perf_counter()
        try:
            return orig_faces(self, faces, camera_id)
        finally:
            if getattr(local, "rec", None) is not None:
                local.rec["faces_s"] = time.perf_counter() - t1

    counting.CountingProcessor.process_frame = process_frame
    counting.CountingProcessor.process_faces = process_faces
    restore_camera = install_camera(frames)
    server = serve(build_app(manager), "127.0.0.1", free_port(), background=True)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    cams = [(f"cam{i}", "entry" if i % 2 == 0 else "exit") for i in range(COUNT_CAMERAS)]
    mem0 = torch.cuda.memory_allocated()
    t_start = time.perf_counter()
    http_ok = Counter()
    warp_kernel.warp_rois.launches_by_size.clear()
    warp_kernel.warp_rois.launches = 0
    match_kernel.gallery_top1.launches = 0
    try:
        for cam, kind in cams:
            streams.start_camera(cam, 0, "campus-1", CameraType(kind), name=cam)
        deadline = time.time() + 300
        while {r["camera"] for r in list(frames_done)} != {c for c, _ in cams}:
            check(time.time() < deadline and all(
                t.is_alive() for t in streams.camera_threads.values()),
                f"{tag} a camera thread produced no result in 300 s: {errors.records[:3]}")
            time.sleep(0.05)
        first_s = time.perf_counter() - t_start
        mem_engines = torch.cuda.memory_allocated() - mem0
        time.sleep(COUNT_WARMUP_S)
        w0 = time.perf_counter()
        for path in ("/api/status", "/api/campus/campus-1/status", "/api/campus/campus-1/events",
                     "/api/campus/campus-1/people", "/api/campus/campus-1/unknown"):
            st, body = http_json("GET", base + path)
            check(st == 200, f"{tag} GET {path}: {st} {body}")
            http_ok[path] += 1
        # one traced second, on core.metrics' trace thread (the one the
        # server phase's /api/profiler calls used: a profiler session starts
        # and stops on one thread)
        trace_dir = tempfile.mkdtemp(prefix="fre_count_trace_")
        check(metrics.start_device_trace(trace_dir), f"{tag} a trace was already running")
        time.sleep(1.0)
        metrics.stop_device_trace()
        kernel_names, busy = trace_kernels(trace_dir)
        shutil.rmtree(trace_dir, ignore_errors=True)
        time.sleep(max(COUNT_WINDOW_S - (time.perf_counter() - w0), 0.0))
        w1 = time.perf_counter()
        for path in ("/api/status", "/api/campus/campus-1/status"):
            st, body = http_json("GET", base + path)
            check(st == 200, f"{tag} GET {path} at the window's end: {st}")
        # after the window: where the camera threads spend their time
        stacks = sample_stacks(list(streams.camera_threads.values()), 3.0)
    finally:
        streams.stop_all()
        k3 = dict(warp_kernel.warp_rois.launches_by_size)
        k1 = match_kernel.gallery_top1.launches
        restore_camera()
        server.shutdown()
        server.server_close()
        counting.CountingProcessor.process_frame = orig_frame
        counting.CountingProcessor.process_faces = orig_faces
        gallery.match = orig_match
        for lg in loggers:
            lg.removeHandler(errors)
    alive = [t for t in streams.camera_threads.values() if t.is_alive()]
    check(not alive, f"{tag} {len(alive)} camera threads still run after stop_all")
    live = (manager.get_campus_status(),
            {pid: manager.get_person_status(pid) for pid in manager.people_states},
            {uid: (u.detection_count, sorted(u.cameras_seen), u.avg_embedding.tobytes())
             for uid, u in manager.unknown_people.get("campus-1", {}).items()})
    manager.stop()
    check(not errors.records, f"{tag} {len(errors.records)} warnings or errors logged: "
          f"{errors.records[:5]}")
    check(all(r["card"] == torch.device(gallery.device).index for r in frames_done),
          f"{tag} a camera thread ran off the gallery's card")

    # each face's decision against the host's float64 top-1 over the gallery
    thr_rec, thr_unk = cfg.thresholds.counting_recognition, cfg.thresholds.definitely_unknown
    n_faces, decided, ambiguous = 0, Counter(), 0
    for rec in frames_done:
        pending = list(rec["calls"])
        for embs, scores, found, company_id in rec["matches"]:
            check(company_id is None, f"{tag} a match was scoped to company {company_id}")
            host = _unit64(embs) @ matrix.T
            for i in range(len(embs)):
                n_faces += 1
                top = int(np.argmax(host[i]))
                k = id_index.get(found[i][0])
                check(k is not None and host[i][k] >= host[i][top] - 1e-5
                      and abs(float(scores[i][0]) - host[i][top]) < 1e-4,
                      f"{tag} K1 gave {found[i][0]} at {scores[i][0]}, the float64 top-1 is "
                      f"{gallery_ids[top]} at {host[i][top]}")
                s = host[i][top]
                ambiguous += int(min(abs(s - thr_rec), abs(s - thr_unk)) < REPLAY_EPS)
                head = pending[0] if pending else (None, ())
                if head[0] == "process_detection" and head[1][0] == found[i][0]:
                    check(s >= thr_rec - REPLAY_EPS and float(head[1][4]) == float(scores[i][0]),
                          f"{tag} a detection of {found[i][0]} at {s}")
                    decided["recognized"] += 1
                    pending.pop(0)
                elif head[0] == "process_unknown_detection" and np.array_equal(
                        head[1][2], embs[i]):
                    check(s < thr_unk + REPLAY_EPS, f"{tag} an unknown at {s}")
                    decided["unknown"] += 1
                    pending.pop(0)
                else:
                    check(thr_unk - REPLAY_EPS <= s < thr_rec + REPLAY_EPS,
                          f"{tag} a face at {s} was neither counted nor clustered")
                    decided["dead zone"] += 1
        check(not pending, f"{tag} manager calls left unmatched to faces: {pending[:2]}")

    # the same calls on a fresh manager on the CPU
    replay = CampusPeopleManager(Datastore(cfg), cfg, start_background=False)
    for cam, kind in cams:
        replay.register_camera(cam, "campus-1", CameraType(kind), cam)
    for name, args in calls:
        if name == "cleanup_stale_detections":
            campus.get_current_utc = lambda: args[0]
            try:
                replay.cleanup_stale_detections()
            finally:
                campus.get_current_utc = real_utc
        else:
            getattr(replay, name)(*args)
    replayed = (replay.get_campus_status(),
                {pid: replay.get_person_status(pid) for pid in replay.people_states},
                {uid: (u.detection_count, sorted(u.cameras_seen), u.avg_embedding.tobytes())
                 for uid, u in replay.unknown_people.get("campus-1", {}).items()})
    check(live == replayed, f"{tag} the live campus state differs from the CPU replay: "
          f"{live[0]} against {replayed[0]}")

    window = [r for r in frames_done if w0 <= r["done"] <= w1]
    dt = w1 - w0
    per_cam = {cam: sum(r["camera"] == cam for r in window) / dt for cam, _ in cams}
    lat = [(r["done"] - r["read"]) * 1e3 for r in window]
    get_ms = [(r["done"] - r["start"] - r.get("faces_s", 0.0)) * 1e3 for r in window]
    faces_ms = [r.get("faces_s", 0.0) * 1e3 for r in window]
    check(all(k3.get(size, 0) > 0 for size in (112,) + ATTR_SIZES) and k1 > 0,
          f"{tag} a kernel was not launched: K3 by size {k3}, K1 {k1}")
    status = live[0].get("campus-1", {})
    rec = {"card": card, "cameras": COUNT_CAMERAS, "fps_per_camera": SERVER_FPS,
           "frame_skip": cfg.campus.frame_skip,
           "offered_frames_per_s": COUNT_CAMERAS * SERVER_FPS / cfg.campus.frame_skip,
           "window_s": dt, "frames_per_s": sum(per_cam.values()),
           "frames_per_s_per_camera": per_cam, "latency_ms_p50": _pct(lat, 50),
           "latency_ms_p90": _pct(lat, 90), "device_busy_share": busy,
           "get_ms_p50": _pct(get_ms, 50), "get_ms_p90": _pct(get_ms, 90),
           "get_ms_alone": alone, "process_faces_ms_p50": _pct(faces_ms, 50),
           "traced_kernels": {k: v for k, v in kernel_names.items()
                              if any(h in k for h in HAND_KERNELS)},
           "first_result_s": first_s, "engines_memory_mib": mem_engines / 2**20,
           "camera_thread_samples": dict(stacks.most_common(8)),
           "faces": n_faces, "decisions": dict(decided), "ambiguous_in_replay": ambiguous,
           "manager_calls": len(calls), "campus": status, "http_200": dict(http_ok),
           "launches": {"warp_rois": k3, "gallery_top1": k1}}
    say(f"{tag} {card} | {COUNT_CAMERAS} cameras at {SERVER_FPS:.0f} fps, frame_skip "
        f"{cfg.campus.frame_skip} ({rec['offered_frames_per_s']:.0f} frames/s offered): each "
        f"thread built its own FaceAnalysis (together {mem_engines / 2**20:.0f} MiB, the last "
        f"first result {first_s:.1f} s after the start)")
    say(f"{tag} {card} | window {dt:.1f} s: {rec['frames_per_s']:.1f} frames/s processed "
        f"({', '.join(f'{c} {v:.1f}' for c, v in per_cam.items())}), read -> state p50 "
        f"{rec['latency_ms_p50']:.1f} / p90 {rec['latency_ms_p90']:.1f} ms; a frame's get p50 "
        f"{rec['get_ms_p50']:.1f} / p90 {rec['get_ms_p90']:.1f} ms (alone "
        f"{', '.join(f'{t:.1f}' for t in alone)}), process_faces p50 "
        f"{rec['process_faces_ms_p50']:.1f} ms; device busy {100 * busy:.1f}% of a traced second "
        f"(its hand kernels {rec['traced_kernels']}); every HTTP route answered 200")
    n_samples = max(sum(stacks.values()), 1)
    say(f"{tag} {card} | after the window, the camera threads' innermost frame in the package "
        f"(3 s of 10 ms samples): " + ", ".join(
            f"{where} {100 * n / n_samples:.1f}%" for where, n in stacks.most_common(8)))
    say(f"{tag} {card} | {n_faces} faces {dict(decided)}: each the float64 top-1 of the whole "
        f"gallery through K1 ({ambiguous} within {REPLAY_EPS} of a threshold); the campus "
        f"{status} and {len(live[1])} person states and {len(live[2])} unknown clusters equal "
        f"the CPU replay of {len(calls)} calls; K3 by crop size {k3}, K1 {k1}")
    return rec


def entry_points_check(card: str, photos: list) -> dict:
    """The four entry points as subprocesses, started together, each with
    MONGODB_URI set: ``servers.inference_server`` (memory://) answers
    /api/embeddings/stats with an empty gallery; ``servers.api_server``
    (memory://) answers {prefix}/health; ``servers.people_count`` (memory://,
    no camera) answers /api/status; ``servers.training_server``, on a fre://
    store that store/server.py serves from this process, takes the job this
    process queued (one employee registered with ``photos``, the 3 poses'
    encoded bytes), writes its embedding, and this process's gallery then
    matches the center photo to that employee.  Each exits 0 on SIGTERM."""
    from facerecognition_infrenceengine_tpu_torch import native
    from facerecognition_infrenceengine_tpu_torch.api import create_app
    from facerecognition_infrenceengine_tpu_torch.api.constants import POSES
    from facerecognition_infrenceengine_tpu_torch.core.config import Config, DBConfig
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis
    from facerecognition_infrenceengine_tpu_torch.store import Datastore
    from facerecognition_infrenceengine_tpu_torch.store.server import StoreServer

    root = os.path.dirname(os.path.abspath(__file__))
    store = StoreServer(port=0)
    store.start()
    uri = f"fre://127.0.0.1:{store._port}"
    cfg = Config(db=DBConfig(mongodb_uri=uri))
    ds = Datastore(cfg)
    prefix = cfg.api.url_prefix
    client = create_app(ds, cfg).test_client()
    company = client.post(f"{prefix}/companies/seed").get_json()["company"]["_id"]
    fmt = "jpeg" if photos[0][:2] == b"\xff\xd8" else "png"
    r = client.post(f"{prefix}/employees/register",
                    data={"employeeId": "W1", "employeeName": "Wire Worker", "companyId": company},
                    files={pose: (f"{pose}.{fmt}", photos[k], f"image/{fmt}")
                           for k, pose in enumerate(POSES)})
    check(r.status_code == 200, f"[entry] register over the wire store: {r.status_code}")
    ports = {name: free_port() for name in ("inference_server", "api_server", "people_count")}
    runs = {
        "inference_server": ("memory://", ["--host", "127.0.0.1", "--port",
                                           str(ports["inference_server"])]),
        "api_server": ("memory://", ["--host", "127.0.0.1", "--port", str(ports["api_server"])]),
        "people_count": ("memory://", ["--host", "127.0.0.1", "--port",
                                       str(ports["people_count"])]),
        "training_server": (uri, ["--worker-id", "smoke-child"]),
    }
    probes = {
        "inference_server": f"http://127.0.0.1:{ports['inference_server']}/api/embeddings/stats",
        "api_server": f"http://127.0.0.1:{ports['api_server']}{prefix}/health",
        "people_count": f"http://127.0.0.1:{ports['people_count']}/api/status",
    }
    workdir = tempfile.mkdtemp(prefix="fre_entry_")  # the servers' log files land here
    procs, logs, out = {}, {}, {}
    t0 = time.perf_counter()
    try:
        for name, (store_uri, argv) in runs.items():
            env = dict(os.environ, MONGODB_URI=store_uri,
                       PYTHONPATH=os.pathsep.join(
                           [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            logs[name] = open(os.path.join(workdir, f"{name}.txt"), "w")
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"facerecognition_infrenceengine_tpu_torch.servers.{name}",
                 *argv], cwd=workdir, env=env, stdout=logs[name], stderr=subprocess.STDOUT)
        deadline = time.time() + 240
        pending = dict(probes)
        job = None
        while pending or job is None or job["status"] in ("queued", "started"):
            for name, url in list(pending.items()):
                try:
                    st, body = http_json("GET", url, timeout=5)
                except (urllib.error.URLError, ConnectionError, OSError):
                    continue
                out[name] = {"status": st, "body": body,
                             "answered_after_s": time.perf_counter() - t0}
                del pending[name]
            job = ds.embedding_jobs.find_one({"model": "buffalo_l"})
            if job["status"] not in ("queued", "started") and "training_server" not in out:
                out["training_server"] = {"job": job["status"], "worker": job.get("workerId"),
                                          "done_after_s": time.perf_counter() - t0}
            dead = [n for n, p in procs.items() if p.poll() is not None]
            check(not dead and time.time() < deadline,
                  f"[entry] {dead or 'a server'} ended or did not answer in 240 s: "
                  f"{sorted(pending)} pending, job {job['status']}")
            time.sleep(0.2)
        for name, proc in procs.items():
            proc.send_signal(signal.SIGTERM)
        for name, proc in procs.items():
            out.setdefault(name, {})["exit_code"] = proc.wait(timeout=90)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()
    tails = {}
    for name in procs:
        with open(os.path.join(workdir, f"{name}.txt")) as f:
            tails[name] = f.read()[-2000:]
    shutil.rmtree(workdir, ignore_errors=True)
    stats = out["inference_server"]
    check(stats["status"] == 200 and stats["body"]["total_embeddings"] == 0,
          f"[entry] inference_server stats: {stats}: {tails['inference_server']}")
    check(out["api_server"]["status"] == 200 and out["api_server"]["body"] == {"status": "ok"},
          f"[entry] api_server health: {out['api_server']}: {tails['api_server']}")
    check(out["people_count"]["status"] == 200 and out["people_count"]["body"].get("success"),
          f"[entry] people_count status: {out['people_count']}: {tails['people_count']}")
    check(out["training_server"]["job"] == "done"
          and out["training_server"]["worker"] == "smoke-child",
          f"[entry] training_server: {out['training_server']}: {tails['training_server']}")
    for name in procs:
        check(out[name]["exit_code"] == 0, f"[entry] {name} exited {out[name]['exit_code']} on "
              f"SIGTERM: {tails[name]}")
    # the worker process's enrollment, matched by this process's gallery
    gallery = GalleryManager(ds, cfg, device="cuda")
    app = FaceAnalysis()
    app.prepare(ctx_id=0)
    img = np.ascontiguousarray(native.decode_image(photos[0])[..., ::-1])
    faces = app.get(img)
    scores, ids, meta = gallery.match(faces[largest_face(faces)].normed_embedding[None],
                                      company_id=company)
    check(ids[0][0] is not None and meta[ids[0][0]]["employeeId"] == "W1",
          f"[entry] the gallery matched the wire worker's enrollment to {ids[0][0]}")
    ds.db.close()
    store.stop()
    say(f"[entry] {card} | inference_server, api_server and people_count answered after "
        + ", ".join(f"{out[n]['answered_after_s']:.1f}" for n in probes)
        + f" s; training_server finished the queued job after "
        f"{out['training_server']['done_after_s']:.1f} s over {uri} and this process's gallery "
        f"matched it (score {float(scores[0][0]):.4f}); each exited 0 on SIGTERM")
    return {n: {k: v for k, v in o.items() if k != "body"} for n, o in out.items()}


def range_trace(torch, fn, iters: int = 2) -> tuple:
    """torch.profiler over iters calls of fn after a dropped warm-up ->
    (device busy ms a call, {range: device ms a call}) for the int8 passes'
    ranges (ops/int8_conv.py's ``int8.*``).  A trace with no device time
    is taken again, four times at most."""
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        if attempt:
            time.sleep(0.5)
        with traced([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        rows = prof.key_averages()
        cuda = torch.autograd.DeviceType.CUDA
        busy = sum(e.self_device_time_total for e in rows if e.device_type == cuda
                   and not e.key.startswith("ProfilerStep")) / 1e3 / iters
        if busy > 0:
            ranges = {}
            for e in rows:
                if e.key.startswith("int8."):
                    us = (e.device_time_total if e.device_type != cuda
                          else e.self_device_time_total)
                    ranges[e.key] = max(ranges.get(e.key, 0.0), us / 1e3 / iters)
            return busy, ranges
    fail("torch.profiler recorded no device time for an [int8] request")


def int_mm_probe(torch, dev) -> dict:
    """torch._int_mm's shape rules on this card (which M (rows), K and N it
    takes), its rate at one IResNet-50 GEMM shape, the right operand row-
    or column-major, beside a bf16 mm of the same shape, and
    int8_conv2d_nhwc at block 0's widest conv with its im2col copying words
    or bytes."""
    out = {}
    for m, k, n, col in ((16, 32, 32, False), (17, 32, 32, False), (24, 32, 32, False),
                         (40, 32, 32, False), (56, 32, 32, False), (32, 27, 32, False),
                         (32, 32, 28, False), (32, 32, 32, False), (32, 32, 32, True)):
        a = torch.ones((m, k), dtype=torch.int8, device=dev)
        b = torch.ones((k, n), dtype=torch.int8, device=dev)
        if col:
            b = b.t().contiguous().t()
        try:
            ok = bool((torch._int_mm(a, b) == k).all())
            out[f"M{m} K{k} N{n}{' colB' if col else ''}"] = "ok" if ok else "WRONG"
        except RuntimeError as e:
            out[f"M{m} K{k} N{n}{' colB' if col else ''}"] = str(e).splitlines()[0][:70]
    torch.cuda.synchronize()
    # the rate at an IResNet-50 stage-3 conv's GEMM (256 crops, 14x14, 3x3 x
    # 256 -> 256): the right operand row- and column-major, and a bf16 mm
    m, k, n = 256 * 14 * 14, 9 * 256, 256
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
    b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev)
    bc = b.t().contiguous().t()
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    for name, fn in (("int_mm_rowB", lambda: torch._int_mm(a, b)),
                     ("int_mm_colB", lambda: torch._int_mm(a, bc)),
                     ("mm_bf16", lambda: ab @ bb)):
        ms = time_ms(torch, fn, 10)
        out[f"{name}_ms"], out[f"{name}_tops"] = ms, 2 * m * k * n / ms / 1e9
    # int8_conv2d_nhwc at IResNet-50 block 0's Conv_0 (256 x 112x112 x 64 ->
    # 64, 3x3): its im2col copying 8 channels a word, and one a byte
    from facerecognition_infrenceengine_tpu_torch.ops import int8_conv

    x8 = torch.randint(-127, 128, (256, 112, 112, 64), dtype=torch.int8, device=dev)
    w8 = torch.randint(-127, 128, (3, 3, 64, 64), dtype=torch.int8, device=dev)
    wide = int8_conv._WIDE
    for name, words in (("conv_words", wide), ("conv_bytes", ())):
        int8_conv._WIDE = words
        try:
            out[f"{name}_ms"] = time_ms(torch, lambda: int8_conv.int8_conv2d_nhwc(x8, w8, 1, 1), 3)
        finally:
            int8_conv._WIDE = wide
    return out


def int8_phase(torch, card: str, requests: list, cfg, app, yapp) -> dict:
    """The opt-in scale modes at buffalo_l's full width (det_10g + r50, bf16,
    the rgb path's canvas and slots): variants a-e of INT8_VARIANTS, each 3
    requests of the rgb path's frames through FaceAnalysis.get_batch and
    match_faces (K1, f32) on the phase's gallery, held against ``app``'s
    engine (the float rgb engine as shipped) on the same frames and timed
    beside ``app`` and ``yapp`` (the yuv420 path with K4), and the layers
    alone (CUDA events): the embedder at 256 crops, the backbone and the
    stem at 8 x 640x640, float against int8 / packed.  Fails the run
    unless the int8 convs are exact on the card, the int8 embedder keeps min
    cosine 0.98 against bf16, det_int8 keeps the valid slots with scores
    within 5e-2, the packed stems match the unpacked stem in f32, and a
    recalibration serves."""
    import torch.nn.functional as F

    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import (
        FaceEngine, _calibration_crops)
    from facerecognition_infrenceengine_tpu_torch.engine.recognizer import (
        FaceRecognitionProcessor)
    from facerecognition_infrenceengine_tpu_torch.models import arcface, packed_stem, quant, scrfd
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis, letterbox
    from facerecognition_infrenceengine_tpu_torch.ops import (
        int8_conv, match_kernel, stem_kernel, warp2pass, warp_kernel)
    from facerecognition_infrenceengine_tpu_torch.store import Datastore

    t_phase = time.perf_counter()
    engine = app._ensure_engine()
    dev = torch.device(engine.device)
    tag = "[int8]"
    probe = int_mm_probe(torch, dev)
    say(f"{tag} {card} | torch {torch.__version__}: torch._int_mm "
        f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in probe.items()} }")
    canv_np = np.stack([letterbox(np.ascontiguousarray(f[..., ::-1]), cfg.engine.det_size)[0]
                        for f in requests[0]])
    canv = torch.from_numpy(canv_np).to(dev)
    with torch.inference_mode():
        ref_det = engine.detect(canv_np, DET_THRESH)
        _, _, kps, valid = engine._detect_impl(canv, DET_THRESH)
        b, f = valid.shape
        fidx = torch.arange(b, device=dev).repeat_interleave(f)
        crops = warp2pass.warp_faces_two_pass(canv, fidx, kps.reshape(b * f, 5, 2),
                                              cfg.engine.embed_size, dst=engine._dst)
        keep = valid.reshape(-1)
        ref_emb = engine._embed_crops_impl(crops)[keep]
        x_crops = arcface.preprocess(crops[keep])
        # 8 of the path's own crops for the recalibration: one a frame (its
        # first slot), uint8 as a camera would give them
        calib8 = crops.reshape(b, f, *crops.shape[1:])[:, 0].round().clamp(0, 255).to(
            torch.uint8).cpu().numpy()

    def cosines(e) -> tuple:
        """(min, p50) cosine of an engine's embeddings of the float engine's
        crops against the float engine's."""
        with torch.inference_mode():
            q = e._embed_crops_impl(crops)[keep]
        cos = (q * ref_emb).sum(1).float().cpu().numpy()
        return float(cos.min()), float(np.median(cos))
    gallery = GalleryManager(Datastore(cfg), cfg, initial_load=False, device=dev)
    out = {"card": card, "int_mm_probe": probe, "variants": {},
           "launches": {"warp_rois": 0, "warp_windows_packed": 0, "gallery_top1": 0}}
    apps = {}
    for key, kw in INT8_VARIANTS:
        vcfg = dataclasses.replace(cfg.engine, **kw)
        t0 = time.perf_counter()
        vapp = FaceAnalysis("buffalo_l", cfg=vcfg, device=dev,
                            allowed_modules=("detection", "recognition"))
        vapp.prepare(ctx_id=0, det_thresh=DET_THRESH)
        ve = vapp._ensure_engine()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        apps[key] = (vapp, ve)
        check(("int8" in ve.rec_variables) == bool(kw.get("embed_int8"))
              and ("int8" in ve.det_variables) == bool(kw.get("det_int8"))
              and ("packed_stem" in ve.det_variables) == bool(kw.get("packed_stem"))
              and ("packed_stem_s2d4" in ve.det_variables) == (key == "e"),
              f"{tag} {key}: the engine's collections {sorted(ve.det_variables)} "
              f"{sorted(ve.rec_variables)} do not match {kw}")
        if key == "e":
            check(all(vapp._yuv_eligible(ve, fr) for fr in requests),
                  f"{tag} e: the yuv420 path was not taken")
        vproc = FaceRecognitionProcessor(gallery, face_app=vapp, cfg=cfg)
        warp_kernel.warp_rois.launches = 0
        warp_kernel.warp_rois.launches_by_size.clear()
        match_kernel.gallery_top1.launches = 0
        stem_kernel.fused_stem.launches = 0
        mm0 = int8_conv.int8_conv2d_nhwc.calls
        torch.cuda.reset_peak_memory_stats()
        start_mb = torch.cuda.memory_allocated() / 2**20
        wall, embs = [], []
        for r, frames in enumerate(requests):
            t0 = time.perf_counter()
            faces = vapp.get_batch(frames)
            setup = 0.0
            if key == "a" and r == 0:  # the phase's gallery: a's request 1 + distractors
                t1 = time.perf_counter()
                own = [f"r0-f{i}-s{j}" for i, fl in enumerate(faces) for j in range(len(fl))]
                emb = np.stack([x.normed_embedding for fl in faces for x in fl])
                dis = np.random.default_rng(1).normal(
                    size=(CAPACITY_ROWS - len(own), 512)).astype(np.float32)
                ids = own + [f"distractor-{k}" for k in range(len(dis))]
                gallery.set_snapshot(ids, {i: {"type": "employee", "name": i} for i in ids},
                                     np.concatenate([emb, dis]), company_id="site-1")
                torch.cuda.synchronize()
                setup = time.perf_counter() - t1
            rows = [vproc.match_faces(fr, fl, "site-1", draw=False)[1]
                    for fr, fl in zip(frames, faces)]
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0 - setup) * 1e3)
            embs.append(np.stack([x.normed_embedding for fl in faces for x in fl]))
            check(all(np.isfinite(x.bbox).all() and abs(
                float(np.linalg.norm(x.normed_embedding)) - 1.0) < 1e-3
                for fl in faces for x in fl) and embs[-1].shape[0] > 0,
                f"{tag} {key}: request {r + 1} has no face or a non-finite one")
            if key == "a" and r == 0:
                flat = [row for rs in rows for row in rs]
                check(all(row["recognized"] and row["person_id"] == own[i]
                          and row["similarity"] >= 0.99 for i, row in enumerate(flat)),
                      f"{tag} a: a face of request 1 missed its own id")
        launches = {"warp_rois": dict(warp_kernel.warp_rois.launches_by_size),
                    "gallery_top1": match_kernel.gallery_top1.launches,
                    "fused_stem": stem_kernel.fused_stem.launches,
                    "int_mm": int8_conv.int8_conv2d_nhwc.calls - mm0}
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        n_frames = sum(1 for fr in requests for _ in fr)
        check(launches["warp_rois"] == {112: REQUESTS} and launches["fused_stem"] == 0
              and launches["gallery_top1"] == n_frames,
              f"{tag} {key}: K3 must launch once a request at 112, K1 once a frame and K4 "
              f"never: {launches}")
        check((launches["int_mm"] > 0) == any(k.endswith("int8") for k in kw),
              f"{tag} {key}: _int_mm calls {launches['int_mm']}")
        out["launches"]["warp_windows_packed" if key == "e" else "warp_rois"] += \
            launches["warp_rois"].get(112, 0)
        out["launches"]["gallery_top1"] += launches["gallery_top1"]

        def request(vapp=vapp, vproc=vproc):
            return [vproc.match_faces(fr, fl, "site-1", draw=False)
                    for fr, fl in zip(requests[1], vapp.get_batch(requests[1]))]

        busy, ranges = range_trace(torch, request)
        v = {"config": kw, "build_s": build_s, "request_ms": wall, "device_ms": busy,
             "peak_memory_mb": peak_mb, "peak_above_start_mb": peak_mb - start_mb,
             "launches": launches,
             "int_mm_calls_a_request": launches["int_mm"] / REQUESTS,
             "ranges_device_ms": ranges}
        with torch.inference_mode():
            det = ve.detect(canv_np, DET_THRESH)
        both = det.valid & ref_det.valid
        v["valid_equal"] = bool(np.array_equal(det.valid, ref_det.valid))
        v["score_max_diff"] = float(np.abs(det.scores - ref_det.scores)[both].max())
        v["box_max_diff_px"] = float(np.abs(det.boxes - ref_det.boxes)[both].max())
        if "det_int8" in kw:
            check(v["valid_equal"] and v["score_max_diff"] <= INT8_SCORE_TOL,
                  f"{tag} {key}: det_int8 valid slots equal {v['valid_equal']}, scores "
                  f"{v['score_max_diff']} (limit {INT8_SCORE_TOL})")
        if "embed_int8" in kw:
            # at the build's calibration (structured synthetic crops): reported,
            # with the share of the path's activations its scales clip
            v["cos_min_default"], v["cos_p50_default"] = cosines(ve)
            with torch.inference_mode():
                frac = quant.clip_fractions(ve.embedder, ve._embed_scales, x_crops,
                                            dtype=ve.dtype)
            v["clip_fraction_max_default"] = max(frac.values())
            t0 = time.perf_counter()
            ve.recalibrate_int8()
            torch.cuda.synchronize()
            v["recalibrate_default_ms"] = (time.perf_counter() - t0) * 1e3
        if "det_int8" in kw:
            h, w = cfg.engine.det_size
            calib = scrfd.preprocess(ve._to_device(
                _calibration_crops(4, max(h, w), seed=4321)[:, :h, :w]))
            t0 = time.perf_counter()
            with torch.inference_mode():
                scales = quant.calibrate_scrfd(ve.detector, calib, ve.detector.cfg,
                                               dtype=ve.dtype)
            torch.cuda.synchronize()
            v["det_calibrate_ms"] = (time.perf_counter() - t0) * 1e3
            check(scales == ve._det_scales, f"{tag} {key}: the detector's scales moved")
        out["variants"][key] = v
        say(f"{tag} {card} | {key} {kw}: built in {build_s:.2f} s; request wall ms "
            f"{[round(t, 1) for t in wall]}, device {busy:.3f} ms a request, peak "
            f"{peak_mb:.1f} MiB ({peak_mb - start_mb:.1f} above the variant's start); "
            f"_int_mm calls a request {v['int_mm_calls_a_request']:.0f}, "
            f"ranges {({k: round(t, 3) for k, t in ranges.items()})}; valid equal "
            f"{v['valid_equal']}, scores max diff {v['score_max_diff']:.2e}, boxes "
            f"{v['box_max_diff_px']:.2f} px"
            + (f"; at the build's calibration cos vs bf16 min {v['cos_min_default']:.5f} p50 "
               f"{v['cos_p50_default']:.5f}, clip fraction up to "
               f"{v['clip_fraction_max_default']:.4f}, recalibrate (8 structured crops) "
               f"{v['recalibrate_default_ms']:.1f} ms" if "cos_min_default" in v else "")
            + (f"; det calibration {v['det_calibrate_ms']:.1f} ms"
               if "det_calibrate_ms" in v else ""))

    # the float paths' requests beside the variants', through the same trace
    for key, base in (("rgb", app), ("yuv_k4", yapp)):
        bproc = FaceRecognitionProcessor(gallery, face_app=base, cfg=cfg)
        busy, _ = range_trace(torch, lambda base=base, bproc=bproc: [
            bproc.match_faces(fr, fl, "site-1", draw=False)
            for fr, fl in zip(requests[1], base.get_batch(requests[1]))])
        out[f"{key}_device_ms"] = busy
    # the layers alone at the path's shapes, CUDA events: embedder (256 crops),
    # backbone and stem (8 x 640x640), float against int8 / packed
    ae, be, de, ee = (apps[k][1] for k in "abde")
    with torch.inference_mode():
        xd = scrfd.preprocess(canv)
        x4 = stem_kernel.space_to_depth4(canv).contiguous()
        bb = engine.detector.backbone
        sw = engine.stem_width
        layers = {
            "embedder_bf16": lambda: engine._apply_embedder(x_crops),
            "embedder_int8": lambda: ae._apply_embedder(x_crops),
            "backbone_bf16": lambda: bb(xd.permute(0, 3, 1, 2).to(engine.dtype)),
            "backbone_int8": lambda: quant.scrfd_backbone_forward(
                be.detector, xd, be.detector.cfg, qw=be.det_variables["int8"],
                act_scales=be._det_scales, dtype=be.dtype),
            "stem_cudnn": lambda: F.max_pool2d(bb.stem3(bb.stem2(bb.stem1(
                xd.permute(0, 3, 1, 2).to(engine.dtype)))), 3, 2, 1),
            "stem_packed": lambda: packed_stem.packed_stem_forward(
                xd, de.det_variables["packed_stem"], sw, de.dtype),
            "stem_packed_s2d4": lambda: packed_stem.packed_stem_forward_s2d4(
                x4, ee.det_variables["packed_stem_s2d4"], sw, ee.dtype),
            "stem_k4": lambda: stem_kernel.fused_stem_s2d4(x4, engine.stem_weights, sw),
        }
        out["layers_ms"] = {k: time_ms(torch, fn, 3) for k, fn in layers.items()}
    say(f"{tag} {card} | request device ms: rgb {out['rgb_device_ms']:.3f}, yuv420 with K4 "
        f"{out['yuv_k4_device_ms']:.3f}; layers alone (CUDA events, ms): "
        f"{ {k: round(t, 3) for k, t in out['layers_ms'].items()} }")

    # the int32 convs on the card, exact: the path's own int8 inputs at one
    # point of each IResNet stage and det_10g's stem1, stem2 and a
    # downsample, captured from a request of variant c
    vapp, ve = apps["c"]
    det_names = [n for n, _, _ in quant._scrfd_names(ve.detector.cfg)]
    order = det_names + quant.calibration_order(ve.embedder.depths)
    calls, taken = [0], {}
    real = quant.int8_conv2d_nhwc

    def capture(x8, w8, stride, pad, scale=None):
        name = order[calls[0]] if calls[0] < len(order) else None
        calls[0] += 1
        if name in INT8_EXACT_POINTS:
            taken[name] = (x8.clone(), w8, stride, pad)
        return real(x8, w8, stride, pad, scale=scale)

    quant.int8_conv2d_nhwc = capture
    try:
        vapp.get_batch(requests[0])
    finally:
        quant.int8_conv2d_nhwc = real
    check(calls[0] == len(order) and set(taken) == set(INT8_EXACT_POINTS),
          f"{tag} captured {calls[0]} int8 convs of {len(order)}, points {sorted(taken)}")
    t0 = time.perf_counter()
    exact = {}
    for name in INT8_EXACT_POINTS:
        x8, w8, stride, pad = taken[name]
        got = int8_conv.int8_conv2d_nhwc(x8, w8, stride, pad)
        want = int8_conv.int8_conv2d_exact(x8, w8, stride, pad)
        check(torch.equal(got, want), f"{tag} {name}: int8_conv2d_nhwc differs from the exact "
              f"conv at {tuple(x8.shape)}: {int((got != want).sum())} values")
        exact[name] = [list(x8.shape), list(w8.shape), stride]
    torch.cuda.synchronize()
    out["exact_points"] = exact
    say(f"{tag} {card} | int8_conv2d_nhwc equals the float64 conv bit for bit on the path's "
        f"int8 inputs: {exact} ({time.perf_counter() - t0:.2f} s)")

    # recalibration on 8 of the path's own crops (one a frame) serves the next
    # request, and holds a and c to the float engine: min cosine >= 0.98 over
    # all its crops (the build's structured calibration is reported above)
    vapp, ve = apps["a"]
    old = ve._embed_scales
    emb_before = np.stack([x.normed_embedding for fl in vapp.get_batch(requests[1]) for x in fl])
    t0 = time.perf_counter()
    ve.recalibrate_int8(calib8)
    torch.cuda.synchronize()
    recal_ms = (time.perf_counter() - t0) * 1e3
    emb_after = np.stack([x.normed_embedding for fl in vapp.get_batch(requests[1]) for x in fl])
    moved = float(np.abs(emb_after - emb_before).max())
    check(ve._int8_calibration == f"user({len(calib8)} crops)" and ve._embed_scales != old
          and moved > 0,
          f"{tag} recalibration: {ve._int8_calibration}, scales changed "
          f"{ve._embed_scales != old}, embeddings moved {moved}")
    apps["c"][1].recalibrate_int8(calib8)
    for key in ("a", "c"):
        v = out["variants"][key]
        v["cos_min"], v["cos_p50"] = cosines(apps[key][1])
        with torch.inference_mode():
            frac = quant.clip_fractions(apps[key][1].embedder, apps[key][1]._embed_scales,
                                        x_crops, dtype=apps[key][1].dtype)
        v["clip_fraction_max"] = max(frac.values())
        check(v["cos_min"] >= INT8_COS_MIN, f"{tag} {key}: int8 against bf16 embeddings of the "
              f"float engine's {int(keep.sum())} crops, recalibrated on 8 of them: min cosine "
              f"{v['cos_min']} < {INT8_COS_MIN}")
    out["recalibrate_user8_ms"] = recal_ms
    out["recalibrated_embedding_max_move"] = moved
    say(f"{tag} {card} | recalibrated on 8 of the path's crops (one a frame) in {recal_ms:.1f} "
        f"ms: cos vs bf16 on the float engine's {int(keep.sum())} crops a min "
        f"{out['variants']['a']['cos_min']:.5f} p50 {out['variants']['a']['cos_p50']:.5f}, c "
        f"min {out['variants']['c']['cos_min']:.5f}; clip fraction up to "
        f"{out['variants']['a']['clip_fraction_max']:.4f}; the next request's embeddings "
        f"moved up to {moved:.3e}")

    # the packed stems against the unpacked stem on the same frames: an f32
    # engine (TF32 off) within rtol 1e-3 / atol 2e-3, and the bf16 variants'
    # largest difference
    f32 = FaceEngine(EngineConfig(det_size=cfg.engine.det_size, dtype="float32",
                                  packed_stem=True, packed_stem_impl="xla"),
                     rec_arch="r18", device=dev)
    stems = {}
    for label, e in (("float32", f32), ("bfloat16 d", apps["d"][1]),
                     ("bfloat16 e", apps["e"][1])):
        with torch.inference_mode():
            x = scrfd.preprocess(canv)
            bb = e.detector.backbone
            ref = F.max_pool2d(bb.stem3(bb.stem2(bb.stem1(x.permute(0, 3, 1, 2).to(e.dtype)))),
                               3, 2, 1).permute(0, 2, 3, 1).float()
            got = {}
            if "packed_stem" in e.det_variables:
                got["packed_stem"] = packed_stem.packed_stem_forward(
                    x, e.det_variables["packed_stem"], e.stem_width, e.dtype).float()
            if "packed_stem_s2d4" in e.det_variables:
                got["packed_stem_s2d4"] = packed_stem.packed_stem_forward_s2d4(
                    stem_kernel.space_to_depth4(canv).contiguous(),
                    e.det_variables["packed_stem_s2d4"], e.stem_width, e.dtype).float()
        for name, g in got.items():
            err = (g - ref).abs()
            worst = float((err - PACKED_RTOL * ref.abs()).max())
            stems[f"{name} {label}"] = {"max_abs": float(err.max()),
                                        "max_ref": float(ref.abs().max()),
                                        "over_tolerance": worst - PACKED_ATOL}
            if label == "float32":
                check(worst <= PACKED_ATOL, f"{tag} {name} f32 against the unpacked stem: "
                      f"max |diff| {float(err.max())} beyond rtol {PACKED_RTOL} / atol "
                      f"{PACKED_ATOL}")
    out["stems"] = stems
    say(f"{tag} {card} | packed stems against the unpacked stem on request 1's canvases: "
        f"{ {k: round(v['max_abs'], 6) for k, v in stems.items()} } (max |ref| "
        f"{max(v['max_ref'] for v in stems.values()):.3f})")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"{tag} phase {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------- the mesh and the trainer
MESH_BATCHES = (1, 32, 256)     # the [mesh] phase's query batches
MESH_DATA, MESH_GALLERY = 2, 4  # the mesh on one card: cuda:0 named 8 times
TRAIN_CLASSES = 93_431          # MS1MV3's identities (arcface_torch configs/ms1mv3_r50.py)
TRAIN_BATCH = 128
TRAIN_STEPS = 20
TRAIN_PROTOTYPES = 48           # the synthetic crops' identities
TRAIN_LR = 1e-3                 # SGD lr (momentum 0.9): an IResNet-18 rehearsal on the CPU
                                # (B = 16, 1,000 classes) fell at 1e-3 and 1e-2, rose at 0.1
RESUME_STEPS = 4                # the resume check: 2 steps, a checkpoint, 2 more
TRAIN_BF16_GRADIENT = 0.25      # the bf16 step's gradient against the f32 step's, and the bf16
                                # mesh step's against the unsharded bf16 step's (relative L2):
                                # the bf16 step on the batch permuted moves it by ~10% on the
                                # H100 (PERF.md §6); per-shard BatchNorm statistics, far more
TRAIN_BF16_COS = 1e-3           # BASELINE.md's embedding budget: bf16 against f32 train forward


def mesh_of(torch):
    """The distinct cards when there are two or more (data 2 where their
    count is even), else cuda:0 named MESH_DATA x MESH_GALLERY times ->
    (mesh, a line saying which)."""
    from facerecognition_infrenceengine_tpu_torch.parallel import build_mesh

    n = torch.cuda.device_count()
    if n >= 2:
        data = 2 if n % 2 == 0 else 1
        return (build_mesh([torch.device("cuda", i) for i in range(n)], data=data,
                           gallery=n // data), f"{n} distinct cards, data {data} x gallery "
                                               f"{n // data}")
    return (build_mesh([torch.device("cuda", 0)] * (MESH_DATA * MESH_GALLERY), data=MESH_DATA,
                       gallery=MESH_GALLERY),
            f"1 card: cuda:0 named {MESH_DATA * MESH_GALLERY} times, data {MESH_DATA} x "
            f"gallery {MESH_GALLERY} (no copy crosses cards)")


def _clear_ranks(scores: np.ndarray, tol: float) -> np.ndarray:
    """[B, k] mask of the ranks whose score lies more than tol from the
    scores beside it (scores [B, k + 1], descending): there a change of
    summation order or of quantization cannot reorder the ids."""
    gaps = scores[:, :-1] - scores[:, 1:]
    before = np.concatenate([np.full((len(scores), 1), np.inf), gaps[:, :-1]], axis=1)
    return (before > tol) & (gaps > tol)


def mesh_phase(torch, card: str, ids: list, matrix: np.ndarray, engine, yapp,
               frames_bgr: list) -> dict:
    """[mesh]: the sharded gallery and make_sharded_fused on the card.

    a. The [gallery] phase's 50,000 persons (capacity 65,536) in f32, bf16
       and int8, through GalleryManager(mesh=...) against the same manager
       without a mesh, at B = 1, 32, 256: k = 1 ids identical and scores
       within 1e-5 (f32, bf16) / 2e-2 (int8), K1 / K2 once a shard a match;
       k = 3 ids identical at every rank clear of its neighbours by that
       tolerance; each shard's kernel held against the plain per-shard merge
       on the CPU (K2 bit for bit, K1 within 1e-5).
    b. FaceEngine.make_sharded_fused on buffalo_l (det_10g + r50, bf16,
       640x640, max_faces 32), 8 frames over the data axis: "raw", "flat"
       and "yuv_flat" (K4): every data shard bit-equal to the unsharded
       engine on that shard's frames alone, its outputs on its shard's
       device."""
    from facerecognition_infrenceengine_tpu_torch.core.config import Config, EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
    from facerecognition_infrenceengine_tpu_torch.models.zoo import letterbox
    from facerecognition_infrenceengine_tpu_torch.ops import match_kernel, stem_kernel, warp_kernel
    from facerecognition_infrenceengine_tpu_torch.parallel import topk
    from facerecognition_infrenceengine_tpu_torch.parallel.sharding import RowShards
    from facerecognition_infrenceengine_tpu_torch.store import Datastore

    t_phase = time.perf_counter()
    mesh, which = mesh_of(torch)
    shards = mesh.shape["gallery"]
    say(f"[mesh] {card} | mesh {which}")
    out = {"card": card, "mesh": which, "gallery": {}, "fused": {}}
    # the phase's path launches: one k = 1 match a dtype and batch, one run
    # of each make_sharded_fused variant (not the timing loops, the warm-ups
    # or the comparisons with the plain versions)
    launches = {"gallery_top1": 0, "gallery_top1_int8": 0, "warp_rois": 0,
                "warp_windows_packed": 0, "fused_stem": 0}
    rng = np.random.default_rng(12)
    q_all = matrix[:max(MESH_BATCHES)] + 0.02 * rng.normal(size=(max(MESH_BATCHES), 512))
    q_all = (q_all / np.linalg.norm(q_all, axis=1, keepdims=True)).astype(np.float32)
    meta = {pid: {"type": "employee", "name": pid} for pid in ids}
    for dtype in ("float32", "bfloat16", "int8"):
        cfg = Config(engine=EngineConfig(gallery_dtype=dtype))
        local = GalleryManager(Datastore(cfg), cfg, initial_load=False, device="cuda")
        sharded = GalleryManager(Datastore(cfg), cfg, initial_load=False, mesh=mesh)
        local.set_snapshot(ids, meta, matrix, company_id="m")
        snap = sharded.set_snapshot(ids, meta, matrix, company_id="m")
        parts = snap.device_matrix
        check(isinstance(parts, RowShards) and len(parts) == shards
              and snap.device_matrix.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                                               "int8": torch.int8}[dtype]
              and snap.device_matrix.shape[0] == CAPACITY,
              f"[mesh] {dtype} snapshot: {type(parts).__name__} {snap.device_matrix.shape}")
        tol = 2e-2 if dtype == "int8" else 1e-5
        kernel = match_kernel.gallery_top1_int8 if dtype == "int8" else match_kernel.gallery_top1
        row = {}
        for b in MESH_BATCHES:
            q = q_all[:b]
            kernel.launches = 0
            s_sh, id_sh, _ = sharded.match(q, company_id="m")
            per_match = kernel.launches
            launches[kernel.__name__] += per_match
            s_lo, id_lo, _ = local.match(q, company_id="m")
            check(per_match == shards, f"[mesh] {dtype} B={b}: {per_match} launches, want "
                                       f"one a shard ({shards})")
            err = float(np.abs(s_sh - s_lo).max())
            check(id_sh == id_lo and err <= tol, f"[mesh] {dtype} B={b} k=1: ids "
                  f"{sum(a != c for a, c in zip(id_sh, id_lo))} apart, scores {err}")
            s3, id3, _ = sharded.match(q, company_id="m", k=3)
            s4, id4, _ = local.match(q, company_id="m", k=4)
            clear = _clear_ranks(s4, tol)
            same = np.array([[a == c for a, c in zip(r3, r4[:3])] for r3, r4 in zip(id3, id4)])
            check(same[clear].all(), f"[mesh] {dtype} B={b} k=3: {int((~same & clear).sum())} "
                                     f"clear ranks differ")
            ms = time_ms(torch, lambda: sharded.match(q, company_id="m"), 10)
            ms_local = time_ms(torch, lambda: local.match(q, company_id="m"), 10)
            row[b] = {"k1_scores_max_diff": err, "k3_ranks_compared": int(clear.sum()),
                      "k3_ranks_unclear": int((~clear).sum()), "launches_per_match": per_match,
                      "ms": ms, "ms_unsharded": ms_local}
        # each shard's kernel against the plain per-shard merge on the CPU
        qb = torch.from_numpy(q_all)
        scale = snap.int8_scale if dtype == "int8" else None
        kv, ki = topk.distributed_top1_fused(qb.cuda(), parts, snap.size, int8_scale=scale)
        pv, pi = topk.distributed_top1_fused_plain(qb, parts, snap.size, scale)
        kv, ki = kv.cpu(), ki.cpu()
        perr = float((kv - pv).abs().max())
        if dtype == "int8":
            check(torch.equal(kv, pv) and torch.equal(ki, pi),
                  f"[mesh] K2 a shard differs from its plain version ({perr})")
        else:
            plain_scores = np.sort((qb.to(parts.dtype).float() @ parts.gather("cpu").float().T)
                                   [:, :snap.size].numpy(), axis=1)[:, ::-1][:, :2]
            clear1 = (plain_scores[:, 0] - plain_scores[:, 1]) > 1e-5
            check(perr <= 1e-5 and torch.equal(ki[clear1], pi[clear1]),
                  f"[mesh] K1 {dtype} a shard against its plain version: {perr}")
        row["plain_max_abs_err"] = perr
        out["gallery"][dtype] = row
        say(f"[mesh] {card} | {dtype} gallery of {snap.size} in {shards} shards of "
            f"{parts.parts[0].shape[0]} rows: " + "; ".join(
                f"B={b} {r['ms']:.3f} ms ({r['ms_unsharded']:.3f} unsharded), "
                f"{r['launches_per_match']} {kernel.__name__} launches (one a shard), k=1 "
                f"scores {r['k1_scores_max_diff']:.2e} apart, k=3 {r['k3_ranks_compared']} "
                f"clear ranks identical" for b, r in row.items() if isinstance(b, int))
            + f"; kernels against the plain shards {perr:.2e}")
        del local, sharded, snap, parts

    # b. make_sharded_fused on the rgb engine (raw, flat) and the yuv one (K4)
    yengine = yapp._ensure_engine()
    canvases = np.stack([letterbox(np.ascontiguousarray(f[..., ::-1]), engine.cfg.det_size)[0]
                         for f in frames_bgr])
    packs = np.stack([yapp.encode_frame(f) for f in frames_bgr])
    data = mesh.shape["data"]
    step = len(frames_bgr) // data
    for variant, eng, x in (("raw", engine, canvases), ("flat", engine, canvases),
                            ("yuv_flat", yengine, packs)):
        run = eng.make_sharded_fused(mesh, variant)
        run(x, DET_THRESH)  # warm-up
        torch.cuda.synchronize()
        warp_kernel.warp_rois.launches = 0
        stem_kernel.fused_stem.launches = 0
        t0 = time.perf_counter()
        got = run(x, DET_THRESH)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        k3, k4 = warp_kernel.warp_rois.launches, stem_kernel.fused_stem.launches
        single = {"raw": eng.detect_align_embed, "flat": eng.detect_align_embed_flat,
                  "yuv_flat": eng.detect_align_embed_yuv420_flat}[variant]
        t0 = time.perf_counter()  # the unsharded program on all the frames
        single(x, DET_THRESH)
        torch.cuda.synchronize()
        wall_single = (time.perf_counter() - t0) * 1e3
        launches["warp_windows_packed" if variant == "yuv_flat" else "warp_rois"] += k3
        launches["fused_stem"] += k4
        check(k3 == data and k4 == (data if variant == "yuv_flat" else 0),
              f"[mesh] {variant}: K3 {k3}, K4 {k4} launches for {data} data shards")
        outs = got if variant == "raw" else (got,)
        for i in range(data):
            want = single(x[i * step:(i + 1) * step], DET_THRESH)
            want = want if variant == "raw" else (want,)
            check(all(torch.equal(o.parts[i], w) for o, w in zip(outs, want)),
                  f"[mesh] {variant}: data shard {i} differs from the unsharded engine on its "
                  f"{step} frames")
            check(all(o.parts[i].device == mesh.devices[i, 0] for o in outs),
                  f"[mesh] {variant}: shard {i}'s outputs left its device")
        valid = (got[3].gather() if variant == "raw" else got.gather()[..., 15] > 0.5)
        out["fused"][variant] = {"ms": wall, "ms_unsharded": wall_single, "k3_launches": k3,
                                 "k4_launches": k4, "valid_slots": int(valid.sum())}
        say(f"[mesh] {card} | make_sharded_fused({variant!r}) on {len(x)} frames over {data} "
            f"data shards: {wall:.2f} ms ({wall_single:.2f} ms unsharded, all {len(x)} frames "
            f"in one program), K3 {k3} launches, K4 {k4}; each shard bit-equal to "
            f"the unsharded engine on its {step} frames and left on its device "
            f"({int(valid.sum())} valid slots)")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[mesh] launches in the phase {launches}; phase {out['phase_s']:.1f} s")
    return out


def iresnet_flops(model, side: int) -> float:
    """A forward's multiply-adds x 2 for one image (convs and the dense
    layer), from the module's shapes."""
    import torch

    flops = 0.0

    def hook(mod, inp, out):
        nonlocal flops
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels // mod.groups
            flops += 2.0 * k * out.numel() / out.shape[0]
        elif isinstance(mod, torch.nn.Linear):
            flops += 2.0 * mod.in_features * mod.out_features

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            p = next(model.parameters())
            model.eval()(torch.zeros((1, side, side, 3), device=p.device))
    finally:
        for h in hooks:
            h.remove()
    return flops


def _state_errors(torch, got: dict, want: dict, start: dict | None = None) -> dict:
    """How far two training states are apart, each part as one vector:
    ||got - want|| / ||want|| (L2 over all its leaves; for the params, of
    the step's update from ``start`` when given).  A leaf's own largest
    error says little: a BatchNorm bias's gradient sums ~10^8 terms that
    cancel to a small value, whose f32 error is set by the terms."""
    from facerecognition_infrenceengine_tpu_torch.parallel.sharding import RowShards

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", (v.gather() if isinstance(v, RowShards) else v).double()

    errs = {}
    for part in ("params", "batch_stats", "opt_state"):
        g, w = dict(leaves(got[part])), dict(leaves(want[part]))
        if part == "params" and start is not None:
            s0 = dict(leaves(start[part]))
            g = {k: g[k] - s0[k].to(g[k].device) for k in g}
            w = {k: w[k] - s0[k].to(w[k].device) for k in w}
        num = sum(float(((g[k].to(w[k].device) - w[k]) ** 2).sum()) for k in w)
        den = sum(float((w[k] ** 2).sum()) for k in w)
        errs[part] = (num / den) ** 0.5 if den else num ** 0.5
    return errs


def _state_equal(torch, a: dict, b: dict) -> bool:
    """Every leaf of two training states bit-equal (row shards shard by
    shard)."""
    from facerecognition_infrenceengine_tpu_torch.parallel.sharding import RowShards

    if isinstance(b, dict):
        return set(a) == set(b) and all(_state_equal(torch, a[k], b[k]) for k in b)
    if isinstance(b, RowShards):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a.parts, b.parts))
    return torch.equal(a, b)


def _gradient_rel(torch, got: dict, want: dict) -> dict:
    """The gradients (the momenta after one step from zero) of two training
    states apart, relative L2: W's and the model's separately."""
    from facerecognition_infrenceengine_tpu_torch.parallel.sharding import RowShards

    def whole(t):
        return (t.gather() if isinstance(t, RowShards) else t).double()

    def rel(pairs):
        num = sum(float(((g.to(w.device) - w) ** 2).sum()) for g, w in pairs)
        return (num / sum(float((w ** 2).sum()) for _, w in pairs)) ** 0.5

    g, w = got["opt_state"], want["opt_state"]
    return {"w": rel([(whole(g["w"]), whole(w["w"]))]),
            "model": rel([(whole(g["model"][k]), whole(w["model"][k])) for k in w["model"]])}


def train_bf16(torch, card: str, model32, state: dict, new: dict, loss, images, labels,
               batches: list, net_flops: float, cls_flops: float) -> dict:
    """[train] bf16: ``iresnet50(dtype=torch.bfloat16)`` with the same
    seeded weights as float32 master weights, the same classes, state,
    batches and lr.  From one state and one batch: the bf16 step against
    the f32 step ``new`` (``loss``): the loss relative, the train-mode
    embeddings' max 1 - cos, the gradient (the momentum after the step;
    W's and the model's) relative L2; beside it the bf16 step's own spread,
    the same bf16 step on the batch permuted; the data 2 x gallery 2 mesh
    bf16 step against the unsharded bf16 step.  Then fit over the 20
    batches (step ms, images/s, peak memory, share of the bound: the convs
    and the Dense at the dense bf16 peak, the f32 ArcFace logits at the
    f32 peak).  Holds: the loss within 1e-3 of f32 and falling over the
    fit, the embeddings within the 1e-3 cosine budget, params and momentum
    float32, and the gradient of the bf16 step (against f32) and of the
    mesh step (against the unsharded bf16 step) within
    ``TRAIN_BF16_GRADIENT``: through IResNet-50's 24 blocks a bf16 step's
    gradient moves by ~10% when only the batch's order changes (the
    reference's bf16 step alike, on the CPU: ``PYTHONPATH=. python
    tests/test_torch_training_bf16.py --r50``), so that spread is printed
    beside them."""
    from facerecognition_infrenceengine_tpu_torch.engine import training
    from facerecognition_infrenceengine_tpu_torch.models import arcface
    from facerecognition_infrenceengine_tpu_torch.models.weights import load_or_init
    from facerecognition_infrenceengine_tpu_torch.parallel import build_mesh

    t_phase = time.perf_counter()
    dev = images.device
    out = {}
    model = load_or_init("arcface_r50", arcface.iresnet50(dtype=torch.bfloat16), 1).to(dev)
    bstate, opt = training.make_train_state(model, TRAIN_CLASSES, images[:2], seed=0,
                                            learning_rate=TRAIN_LR)
    check(_state_equal(torch, bstate, state), "[train] bf16: the state differs from the f32 "
          "model's (the same seeded weights, W and zero momentum)")
    step = training.make_train_step(model, opt)
    bnew, bloss = step(bstate, images, labels)
    perm = torch.randperm(TRAIN_BATCH, generator=torch.Generator(device=dev).manual_seed(17),
                          device=dev)
    pnew, _ = step(bstate, images[perm], labels[perm])
    mstep = training.make_train_step(model, opt, mesh=build_mesh([dev] * 4, data=2, gallery=2))
    mnew, mloss = mstep(bstate, images, labels)
    with torch.no_grad():
        e_bf = training._embed(model, bstate, images)[0]
        e_32 = training._embed(model32, state, images)[0]
        emb_cos = float((1.0 - torch.nn.functional.cosine_similarity(e_bf, e_32)).max())
    errs = _state_errors(torch, bnew, new, start=state)
    lerr = abs(float(bloss) - float(loss)) / abs(float(loss))
    grads = {"vs_f32": _gradient_rel(torch, bnew, new),
             "batch_permuted": _gradient_rel(torch, pnew, bnew),
             "mesh": _gradient_rel(torch, mnew, bnew)}
    merrs = _state_errors(torch, mnew, bnew, start=bstate)
    spread = _state_errors(torch, pnew, bnew, start=bstate)
    mlerr = abs(float(mloss) - float(bloss)) / abs(float(bloss))
    torch.cuda.synchronize()
    out["vs_f32"] = {"loss_rel": lerr, "embedding_max_1_minus_cos": emb_cos,
                     "gradient_rel": errs["opt_state"], "update_rel": errs["params"],
                     "batch_stats_rel": errs["batch_stats"]}
    out["batch_permuted_vs_bf16"] = {"gradient_rel": spread["opt_state"],
                                     "batch_stats_rel": spread["batch_stats"]}
    out["mesh_vs_unsharded"] = {"loss_rel": mlerr, "gradient_rel": merrs["opt_state"],
                                "update_rel": merrs["params"],
                                "batch_stats_rel": merrs["batch_stats"]}
    out["gradient_parts"] = grads
    say(f"[train] {card} | bf16 (f32 master weights): one step, loss {float(bloss):.4f}; "
        f"against the f32 step from the same state and batch: loss {lerr:.2e} apart, the "
        f"train-mode embeddings max 1-cos {emb_cos:.2e}, gradient {errs['opt_state']:.2e} "
        f"(W {grads['vs_f32']['w']:.2e}, model {grads['vs_f32']['model']:.2e}), batch_stats "
        f"{errs['batch_stats']:.2e} (relative L2); the same bf16 step on the batch permuted "
        f"against it: gradient {spread['opt_state']:.2e} (W {grads['batch_permuted']['w']:.2e}, "
        f"model {grads['batch_permuted']['model']:.2e}); the data 2 x gallery 2 mesh bf16 step "
        f"against the unsharded bf16 step: loss {mlerr:.2e}, gradient {merrs['opt_state']:.2e} "
        f"(W {grads['mesh']['w']:.2e}, model {grads['mesh']['model']:.2e}), batch_stats "
        f"{merrs['batch_stats']:.2e}")
    del bnew, mnew, pnew

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []

    def timed(s, x, y):
        t = time.perf_counter()
        s2, l2 = step(s, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        return s2, l2

    fitted, losses = training.fit(timed, bstate, batches, log_every=0)
    peak = torch.cuda.max_memory_allocated() / 2**20
    steady = sorted(times[2:])
    step_ms = steady[len(steady) // 2]
    net_ms = net_flops / PEAK_FLOPS["bfloat16"] * 1e3
    cls_ms = cls_flops / PEAK_FLOPS["float32"] * 1e3
    bound_ms = net_ms + cls_ms
    leaves = [t for part in ("params", "opt_state")
              for t in list(fitted[part]["model"].values()) + [fitted[part]["w"]]]
    dtypes = sorted({str(t.dtype) for t in leaves})
    out.update(step_ms=step_ms, step_ms_all=list(times), images_per_s=TRAIN_BATCH / step_ms * 1e3,
               peak_memory_mb=peak, losses=losses, flops_per_step=net_flops + cls_flops,
               bound_ms=bound_ms, bound_by="operations", peak_flops_bf16=PEAK_FLOPS["bfloat16"],
               peak_flops_f32=PEAK_FLOPS["float32"], state_dtypes=dtypes)
    say(f"[train] {card} | bf16 fit {TRAIN_STEPS} steps: loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f} (first five {np.mean(losses[:5]):.3f}, last five "
        f"{np.mean(losses[-5:]):.3f}); step {step_ms:.2f} ms (p50 of steps 3-{TRAIN_STEPS}; "
        f"first {times[0]:.1f} ms), {TRAIN_BATCH / step_ms * 1e3:.1f} images/s, peak memory "
        f"{peak:.0f} MiB; {(net_flops + cls_flops) / 1e12:.3f} TFLOP a step: "
        f"{net_flops / 1e12:.3f} in the convs and the Dense at the dense bf16 peak "
        f"({PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s, {net_ms:.2f} ms) and "
        f"{cls_flops / 1e12:.4f} in the f32 logits at the f32 peak "
        f"({PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s, {cls_ms:.2f} ms): bound {bound_ms:.2f} ms "
        f"({100 * bound_ms / step_ms:.0f}%); params and momentum {dtypes}")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[train] bf16 part {out['phase_s']:.1f} s")
    bound = TRAIN_BF16_GRADIENT
    check(np.isfinite(float(bloss)) and lerr <= 1e-3 and emb_cos <= TRAIN_BF16_COS,
          f"[train] bf16: the loss or the embeddings against the f32 step: {out['vs_f32']}")
    check(errs["opt_state"] <= bound,
          f"[train] bf16: the gradient against the f32 step beyond {bound:.3e}: {out['vs_f32']}")
    check(merrs["opt_state"] <= bound and mlerr <= 1e-3,
          f"[train] bf16: the mesh step beyond {bound:.3e}: {out['mesh_vs_unsharded']}")
    check(all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"[train] bf16: the loss did not fall: {losses}")
    check(dtypes == ["torch.float32"], f"[train] bf16: the state is not float32: {dtypes}")
    return out


def train_phase(torch, card: str) -> dict:
    """[train]: engine/training.py at full width on the card.

    IResNet-50 (112x112, embedding 512, the seeded synthetic weights), f32
    with TF32 off, B = 128, 93,431 classes; synthetic crops of a few dozen
    prototypes made on the card.  One step with no mesh against the same
    step on a data 2 x gallery 2 mesh from one state (relative, see
    ``_state_errors``: the loss and the batch statistics within 1e-5, the
    params within 1e-5, the gradient -- the momentum after one step --
    within 5e-3: a batch permutation alone moves an IResNet-18 step's f32
    gradient by 1.4e-4 on the CPU, and the same unsharded step on the
    batch permuted is printed beside it); fit
    over 20 steps at lr 1e-3 (the
    loss falls; step ms, images/s, peak memory; the step with TF32 on,
    timed only); the checkpoint round trip
    bit for bit; a resumed run against the uninterrupted one with
    cudnn.deterministic on for that check (bit for bit, else within 1e-4
    relative, printed).  Then the same in bf16 mixed precision
    (``train_bf16``)."""
    from facerecognition_infrenceengine_tpu_torch.engine import training
    from facerecognition_infrenceengine_tpu_torch.models import arcface
    from facerecognition_infrenceengine_tpu_torch.models.weights import load_or_init
    from facerecognition_infrenceengine_tpu_torch.parallel import build_mesh

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {"card": card, "classes": TRAIN_CLASSES, "batch": TRAIN_BATCH}
    model = load_or_init("arcface_r50", arcface.iresnet50(), 1).to(dev)
    net_flops = iresnet_flops(model, 112) * 3 * TRAIN_BATCH
    cls_flops = 3 * 2.0 * TRAIN_BATCH * TRAIN_CLASSES * 512
    flops = net_flops + cls_flops
    gen = torch.Generator(device=dev).manual_seed(13)
    protos = torch.randn((TRAIN_PROTOTYPES, 112, 112, 3), generator=gen, device=dev)

    def batch():
        labels = torch.randint(0, TRAIN_PROTOTYPES, (TRAIN_BATCH,), generator=gen, device=dev)
        noise = torch.randn((TRAIN_BATCH, 112, 112, 3), generator=gen, device=dev)
        return protos[labels] + 0.1 * noise, labels

    t0 = time.perf_counter()
    state, opt = training.make_train_state(model, TRAIN_CLASSES, protos[:2], seed=0,
                                           learning_rate=TRAIN_LR)
    torch.cuda.synchronize()
    out["state_s"] = time.perf_counter() - t0
    step = training.make_train_step(model, opt)
    mesh = build_mesh([dev] * 4, data=2, gallery=2)
    mstep = training.make_train_step(model, opt, mesh=mesh)
    images, labels = batch()
    new, loss = step(state, images, labels)
    mnew, mloss = mstep(state, images, labels)
    # the f32 spread of one step under a change of summation order alone:
    # the same unsharded step on the batch in another order
    perm = torch.randperm(TRAIN_BATCH, generator=gen, device=dev)
    permuted, _ = step(state, images[perm], labels[perm])
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the mesh step again, warm: its wall time
    mstep(state, images, labels)
    torch.cuda.synchronize()
    out["mesh_step_ms"] = (time.perf_counter() - t0) * 1e3
    errs = _state_errors(torch, mnew, new, start=state)
    spread = _state_errors(torch, permuted, new, start=state)
    p_err = _state_errors(torch, mnew, new)["params"]
    lerr = abs(float(mloss) - float(loss)) / abs(float(loss))
    out["mesh_vs_unsharded"] = {"loss_rel": lerr, "params_rel": p_err, "update_rel": errs["params"],
                                "batch_stats_rel": errs["batch_stats"],
                                "gradient_rel": errs["opt_state"]}
    out["batch_order_spread"] = {"update_rel": spread["params"],
                                     "batch_stats_rel": spread["batch_stats"],
                                     "gradient_rel": spread["opt_state"]}
    say(f"[train] {card} | IResNet-50 112x112 f32 (TF32 off), B={TRAIN_BATCH}, "
        f"{TRAIN_CLASSES} classes (W {TRAIN_CLASSES * 512 * 4 / 1e6:.0f} MB): one step, loss "
        f"{float(loss):.4f}; the data 2 x gallery 2 mesh step from the same state: loss "
        f"{lerr:.2e} apart, params {p_err:.2e}, batch_stats {errs['batch_stats']:.2e}, the "
        f"gradient (the momentum after the step) {errs['opt_state']:.2e}, the params' update "
        f"{errs['params']:.2e} (relative L2); the unsharded step on the batch in another "
        f"order against it: gradient {spread['opt_state']:.2e}, batch_stats "
        f"{spread['batch_stats']:.2e}; the mesh step {out['mesh_step_ms']:.1f} ms on one card")
    check(lerr <= 1e-5 and p_err <= 1e-5 and errs["batch_stats"] <= 1e-5
          and errs["opt_state"] <= 5e-3, f"[train] the mesh step differs: {out['mesh_vs_unsharded']}")
    check(np.isfinite(float(loss)), "[train] non-finite loss")
    del mnew, permuted

    # fit: the step's time, rate and memory
    batches = [batch() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []

    def timed(s, x, y):
        t = time.perf_counter()
        s2, l2 = step(s, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        return s2, l2

    fitted, losses = training.fit(timed, state, batches, log_every=0)
    peak = torch.cuda.max_memory_allocated() / 2**20
    steady = sorted(times[2:])
    step_ms = steady[len(steady) // 2]
    bound_ms = flops / PEAK_FLOPS["float32"] * 1e3
    out.update(step_ms=step_ms, step_ms_all=list(times),
               images_per_s=TRAIN_BATCH / step_ms * 1e3,
               peak_memory_mb=peak, losses=losses, flops_per_step=flops, bound_ms=bound_ms,
               bound_by="operations")
    say(f"[train] {card} | fit {TRAIN_STEPS} steps: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
        f"(first five {np.mean(losses[:5]):.3f}, last five {np.mean(losses[-5:]):.3f}); step "
        f"{step_ms:.2f} ms (p50 of steps 3-{TRAIN_STEPS}; first {times[0]:.1f} ms), "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f} images/s, peak memory {peak:.0f} MiB; "
        f"{flops / 1e12:.3f} TFLOP a step, bound {bound_ms:.2f} ms at the f32 peak "
        f"({100 * bound_ms / step_ms:.0f}%)")
    check(all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"[train] the loss did not fall: {losses}")
    # what TF32 off costs: the same steps with TF32 on, for this measure only
    # (the port's f32 programs are held to true f32)
    times.clear()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        training.fit(timed, state, batches[:6], log_every=0)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out["step_ms_tf32"] = sorted(times[2:])[len(times[2:]) // 2]
    say(f"[train] {card} | the same step with TF32 on (this measure only): "
        f"{out['step_ms_tf32']:.2f} ms (p50 of steps 3-6) against {step_ms:.2f} ms with it off")

    out["bf16"] = train_bf16(torch, card, model, state, new, loss, images, labels, batches,
                             net_flops, cls_flops)
    del new

    # the checkpoint round trip and the resume
    ckpt = tempfile.mkdtemp(prefix="fre_ckpt_")
    try:
        t0 = time.perf_counter()
        training.save_checkpoint(ckpt, fitted, TRAIN_STEPS)
        back, at = training.restore_checkpoint(ckpt, target=fitted)
        torch.cuda.synchronize()
        out["checkpoint_s"] = time.perf_counter() - t0
        check(at == TRAIN_STEPS and _state_equal(torch, back, fitted),
              "[train] the restored checkpoint differs from the saved state")
        del back
        shutil.rmtree(ckpt)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            run = batches[:RESUME_STEPS]
            whole, l_whole = training.fit(step, state, run, log_every=0)
            half = RESUME_STEPS // 2
            training.fit(step, state, run[:half], ckpt_dir=ckpt, log_every=0)
            restored, at = training.restore_checkpoint(ckpt, target=state)
            resumed, l_res = training.fit(step, restored, run[half:], ckpt_dir=ckpt,
                                          log_every=0, start_step=at)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        rerr = _state_errors(torch, resumed, whole)
        exact = _state_equal(torch, resumed, whole) and l_res == l_whole[half:]
        out["resume"] = {"bit_exact": exact, **rerr}
        check(at == half and training.restore_checkpoint(ckpt)[1] == RESUME_STEPS
              and max(rerr.values()) <= 1e-4, f"[train] resume: {out['resume']}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    say(f"[train] {card} | checkpoint of {TRAIN_STEPS} steps saved and restored bit for bit in "
        f"{out['checkpoint_s']:.2f} s; resumed {half} + {half} steps against {RESUME_STEPS} "
        f"uninterrupted (cudnn.deterministic on for this check): " + (
            "bit for bit" if exact else f"not bit for bit, within {max(rerr.values()):.2e} "
                                        f"(relative L2)"))
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[train] phase {out['phase_s']:.1f} s")
    return out



CONVERT_ROTATIONS = (0, 10, -20, 30)  # degrees: tests/test_ops_warp2pass.py's angles
CONVERT_FACES = 256                   # in-canvas faces at each angle
CONVERT_MAX_SCALE = 1.2               # that test's face scale: K3 reads pyramid level 0


def smooth_frame(h: int = FRAME_H, w: int = FRAME_W, seed: int = 0) -> np.ndarray:
    """tests/test_ops_warp2pass.py's smooth float32 RGB frame: the two-pass
    warp's budgets against the exact bilinear warp are set on it."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (h // 16, w // 16, 3)).astype(np.float32)
    yy = np.linspace(0, small.shape[0] - 1, h)
    xx = np.linspace(0, small.shape[1] - 1, w)
    y0, x0 = yy.astype(int), xx.astype(int)
    y1, x1 = np.minimum(y0 + 1, small.shape[0] - 1), np.minimum(x0 + 1, small.shape[1] - 1)
    fy, fx = (yy - y0)[:, None, None], (xx - x0)[None, :, None]
    img = ((small[y0][:, x0] * (1 - fy) + small[y1][:, x0] * fy) * (1 - fx)
           + (small[y0][:, x1] * (1 - fy) + small[y1][:, x1] * fy) * fx)
    return img.astype(np.float32)


def inside_kps(rng, theta: float, n: int = CONVERT_FACES) -> np.ndarray:
    """n in-canvas faces at rotation theta (scales 0.5-CONVERT_MAX_SCALE)
    whose whole 112x112 crop samples inside the FRAME_W x FRAME_H frame:
    past the edge the bilinear warp interpolates toward the clamped row's
    neighbour while K3 replicates the border, by design."""
    import torch

    from facerecognition_infrenceengine_tpu_torch.ops.align import (
        ARCFACE_DST, _invert_affine, umeyama_similarity)

    corners = torch.tensor([[0.0, 0.0, 1.0], [111.0, 0.0, 1.0], [0.0, 111.0, 1.0],
                            [111.0, 111.0, 1.0]])
    kept = []
    while sum(len(k) for k in kept) < n:
        cand = in_canvas_kps(rng, n, dst=ARCFACE_DST, theta=theta,
                             scales=(0.5, CONVERT_MAX_SCALE))
        m_inv = _invert_affine(umeyama_similarity(torch.from_numpy(cand),
                                                  torch.from_numpy(ARCFACE_DST)))
        src = torch.einsum("mij,kj->mki", m_inv, corners)  # [n, 4 corners, (x, y)]
        ok = ((src >= 0) & (src < torch.tensor([FRAME_W - 1.0, FRAME_H - 1.0]))).all(-1).all(-1)
        kept.append(cand[ok.numpy()])
    return np.concatenate(kept)[:n]


def convert_phase(torch, card: str, requests: list) -> tuple:
    """[convert]: a buffalo_l-shaped pack converted on the card's host by the
    port's converter (no JAX), then served.

    a. tools/synthetic_pack.make_pack (torch mirrors of det_10g, w600k_r50
       and w600k_mbf at their published widths, random weights and BN
       statistics, plus three attribute graphs; the TorchScript export)
       converted by models/convert_onnx.convert into a temporary
       FRE_WEIGHTS_DIR.
    b. The port's f32 det_10g, r50 and MobileFaceNet on the card with the
       converted leaves (every leaf equal to its .npz leaf) against the torch
       mirrors on the card on the same inputs: embedders 1 - cos 1e-5 and
       atol 1e-4 normalized, det_10g's scores, bbox and kps 1 - cos 1e-5 and
       atol / rtol 1e-3 on a 640x640 canvas (tests/test_weight_dropin.py).
    c. FaceAnalysis("buffalo_l", detection + recognition), bf16 at 640x640,
       picks the pack up (its modules hold the converted leaves), serves the
       rgb path's 3 requests and match_faces against an f32 gallery of
       request 1's faces plus seeded distractors (K3, K1; counters zeroed
       just before): every face of request 1 finds its own id at >= 0.99 (or
       a twin's: faces found in the canvas' black padding share one crop);
       then the pack's exact-graph attribute heads run once on request 1's
       boxes (K3 at 96 and 192) and agree with the mirror heads on the same
       crops.  The bf16 embeddings lie within 1 - cos 1e-3 of an f32 engine
       on the same K3 crops.
    d. The ops surface on the card: warp_faces on the card equals warp_faces
       on the CPU within 1e-4 on request 1's landmarks; K3's 112 crop
       (warp_faces_two_pass) of 256 faces of the smooth frame whose crops lie
       inside it, at each of 0, 10, -20 and 30 degrees (scales 0.5-1.2), keeps
       tests/test_ops_warp2pass.py's budgets against the bilinear warp_faces
       (max < 0.35 at 0 degrees; at every angle each face's mean < 1 and
       median < 0.5); cosine_scores equals q.float() @ g.float().T and a
       float64 product within 1e-5.

    Returns (the convert_path dict, a served request for the device-time
    trace taken after the kernels' own)."""
    import contextlib
    import warnings

    from facerecognition_infrenceengine_tpu_torch.core.config import (
        Config, EngineConfig, ThresholdConfig)
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
    from facerecognition_infrenceengine_tpu_torch.engine.recognizer import (
        FaceRecognitionProcessor)
    from facerecognition_infrenceengine_tpu_torch.models import (
        arcface, convert_onnx, mobilefacenet, scrfd)
    from facerecognition_infrenceengine_tpu_torch.models.weights import (
        flax_layout, load_flat, load_or_init)
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis, letterbox
    from facerecognition_infrenceengine_tpu_torch.ops import (
        cosine_scores, match_kernel, warp2pass, warp_kernel)
    from facerecognition_infrenceengine_tpu_torch.ops.align import warp_faces
    from facerecognition_infrenceengine_tpu_torch.store import Datastore
    from tools import synthetic_pack

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    pack_dir = tempfile.mkdtemp(prefix="fre-pack-")
    wdir = tempfile.mkdtemp(prefix="fre-converted-")
    weights_env = os.environ.get("FRE_WEIGHTS_DIR")
    try:
        # ------------------------------------------- a. the pack, converted
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the TorchScript exporter's notices
            mirrors = synthetic_pack.make_pack(pack_dir, seed=0, det_canvas=CANVAS)
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            written = convert_onnx.convert(pack_dir, wdir)
        convert_s = time.perf_counter() - t0
        check(sorted(os.listdir(wdir)) == sorted(
            ["scrfd_det_10g.npz", "arcface_r50.npz", "arcface_mobilefacenet.npz",
             "attr_genderage.onnx", "attr_2d106det.onnx", "attr_1k3d68.onnx"]),
            f"[convert] files written: {sorted(os.listdir(wdir))}")
        say(f"[convert] make_pack(seed=0, det_canvas={CANVAS}) {pack_s:.2f} s (TorchScript "
            f"export); models/convert_onnx.convert {convert_s:.2f} s on the host: {written}")
        os.environ["FRE_WEIGHTS_DIR"] = wdir

        # ------------------------------- b. f32 on the card against the mirrors
        def leaves_equal(module, name) -> int:
            flat = load_flat(os.path.join(wdir, f"{name}.npz"))
            state = module.state_dict()
            layout = flax_layout(module)
            check({path for _, path, _, _ in layout} == set(flat),
                  f"[convert] {name}: the module's leaves are not the pack's")
            for key, path, _, conv in layout:
                want = torch.from_numpy(np.ascontiguousarray(conv(flat[path])))
                check(torch.equal(state[key].detach().cpu(), want.to(state[key].dtype)),
                      f"[convert] {name}: {key} is not its .npz leaf {path}")
            return len(layout)

        rng = np.random.default_rng(11)
        f32_err = {}
        with torch.inference_mode():
            for name, factory, onnx in (("arcface_r50", arcface.iresnet50, "w600k_r50.onnx"),
                                        ("arcface_mobilefacenet", mobilefacenet.mobilefacenet,
                                         "w600k_mbf.onnx")):
                model = load_or_init(name, factory())
                leaves_equal(model, name)
                model, mirror = model.to(dev), mirrors[onnx].to(dev).eval()
                x = torch.from_numpy(rng.uniform(-1, 1, (FRAMES, 112, 112, 3)).astype(
                    np.float32)).to(dev)
                got = torch.nn.functional.normalize(model(x), dim=1)
                want = torch.nn.functional.normalize(mirror(x.permute(0, 3, 1, 2)), dim=1)
                cos = float((got * want).sum(1).min())
                err = float((got - want).abs().max())
                check(1.0 - cos <= 1e-5 and err <= 1e-4,
                      f"[convert] {name} f32 against its mirror: 1-cos {1 - cos}, err {err}")
                f32_err[name] = {"one_minus_cos": 1.0 - cos, "max_abs_err": err}
                mirrors[onnx].cpu()
                del model
            det = load_or_init("scrfd_det_10g", scrfd.SCRFD(scrfd.CONFIGS["det_10g"]))
            leaves_equal(det, "scrfd_det_10g")
            det, mirror = det.to(dev), mirrors["det_10g.onnx"].to(dev).eval()
            x = torch.from_numpy(rng.uniform(-1, 1, (1, CANVAS, CANVAS, 3)).astype(
                np.float32)).to(dev)
            for part, g, w in zip(("scores", "bbox", "kps"), det(x), mirror(x.permute(0, 3, 1, 2))):
                check(g.shape == w.shape, f"[convert] det_10g {part}: {g.shape} vs {w.shape}")
                g64, w64 = g.double().flatten(), w.double().flatten()
                cos = float(g64 @ w64 / (g64.norm() * w64.norm() + 1e-30))
                bad = float(((g - w).abs() - (1e-3 + 1e-3 * w.abs())).max())
                check(1.0 - cos <= 1e-5 and bad <= 0.0,
                      f"[convert] det_10g {part} against the mirror: 1-cos {1 - cos}, "
                      f"excess over atol/rtol 1e-3 {bad}")
                f32_err[f"det_10g_{part}"] = {"one_minus_cos": 1.0 - cos,
                                              "max_abs_err": float((g - w).abs().max())}
            mirrors["det_10g.onnx"].cpu()
            del det
        say(f"[convert] f32 on the card against the torch mirrors (TF32 off): " + "; ".join(
            f"{k} 1-cos {v['one_minus_cos']:.2e} err {v['max_abs_err']:.2e}"
            for k, v in f32_err.items()))

        # ----------------------------------------------- c. the served path
        cfg = Config(thresholds=ThresholdConfig(detection=DET_THRESH),
                     engine=EngineConfig(det_size=(CANVAS, CANVAS)))
        t0 = time.perf_counter()
        capp = FaceAnalysis("buffalo_l", cfg=cfg.engine, device="cuda",
                            allowed_modules=("detection", "recognition"))
        capp.prepare(ctx_id=0, det_thresh=DET_THRESH)
        cengine = capp._ensure_engine()
        build_s = time.perf_counter() - t0
        n_leaves = leaves_equal(cengine.detector, "scrfd_det_10g") + leaves_equal(
            cengine.embedder, "arcface_r50")
        gal = GalleryManager(Datastore(cfg), cfg, initial_load=False, device="cuda")
        proc = FaceRecognitionProcessor(gal, face_app=capp, cfg=cfg)
        warp_kernel.warp_rois.launches = 0
        warp_kernel.warp_rois.launches_by_size.clear()
        match_kernel.gallery_top1.launches = 0
        c_ms, c_faces, c_results = [], [], []
        for r, frames in enumerate(requests):
            t0 = time.perf_counter()
            faces = capp.get_batch(frames)
            if r == 0:  # enrol request 1's faces plus seeded unit distractors
                t1 = time.perf_counter()
                own = [f"c0-f{i}-s{j}" for i, fl in enumerate(faces) for j in range(len(fl))]
                emb = np.stack([f.normed_embedding for fl in faces for f in fl])
                dis = np.random.default_rng(12).normal(size=(CAPACITY_ROWS - len(own), 512))
                matrix = np.concatenate([emb, dis / np.linalg.norm(dis, axis=1, keepdims=True)])
                ids = own + [f"distractor-{k}" for k in range(len(dis))]
                gal.set_snapshot(ids, {p: {"type": "employee", "name": p} for p in ids},
                                 matrix.astype(np.float32), company_id="site-c")
                torch.cuda.synchronize()
                setup_ms = (time.perf_counter() - t1) * 1e3
            out = [proc.match_faces(frame, fl, "site-c", draw=False)[1]
                   for frame, fl in zip(frames, faces)]
            torch.cuda.synchronize()
            c_ms.append((time.perf_counter() - t0) * 1e3 - (setup_ms if r == 0 else 0.0))
            c_faces.append(sum(len(fl) for fl in faces))
            c_results.append((faces, out))
        check(all(n > 0 for n in c_faces), f"[convert] a request found no face: {c_faces}")
        faces0, out0 = c_results[0]
        # the pack's random detector finds faces in the canvas' black padding too:
        # their crops, and so their embeddings, are identical, and a tie goes to
        # the lowest index.  A face must find its own id, or one enrolled with
        # its embedding (1 - cos <= 1e-5)
        row_of = {p: i for i, p in enumerate(own)}
        k, twins = 0, 0
        for fl, rows in zip(faces0, out0):
            for row in rows:
                pid = row["person_id"]
                same = pid == own[k] or (pid in row_of and float(
                    emb[row_of[pid]] @ emb[k]) >= 1 - 1e-5)
                twins += pid != own[k]
                check(row["recognized"] and same and row["similarity"] >= 0.99,
                      f"[convert] request 1 face {own[k]} matched {pid} at "
                      f"{row['similarity']}")
                k += 1
        distinct = len({tuple(np.round(e, 5)) for e in emb})
        # the pack's exact-graph attribute heads, once, on request 1's boxes
        canvases = torch.from_numpy(np.stack([letterbox(np.ascontiguousarray(f[..., ::-1]),
                                                        (CANVAS, CANVAS))[0]
                                              for f in requests[0]])).to(dev)
        c_list = [f for fl in faces0 for f in fl]
        c_idx = np.asarray([b for b, fl in enumerate(faces0) for _ in fl], np.int64)
        c_boxes = np.stack([f.bbox for f in c_list]).astype(np.float32)
        gender, age, lm = cengine.attributes(canvases, c_idx, c_boxes)
        check(cengine._attr_runners is not None and cengine._attr_sizes == ATTR_SIZES,
              f"[convert] the pack's attribute graphs were not picked up: {cengine._attr_sizes}")
        c_launches = {"warp_rois": dict(warp_kernel.warp_rois.launches_by_size),
                      "gallery_top1": match_kernel.gallery_top1.launches}
        say(f"[convert] launches on the path {c_launches}")
        check(c_launches["warp_rois"].get(112, 0) == REQUESTS
              and c_launches["warp_rois"].get(ATTR_SIZES[0]) == 1
              and c_launches["warp_rois"].get(ATTR_SIZES[1]) == 1
              and c_launches["gallery_top1"] == sum(1 for fs, _ in c_results for fl in fs if fl),
              f"[convert] K3 once a request at 112 and once at 96 and 192, K1 once a frame "
              f"with faces: {c_launches}")
        with torch.inference_mode():
            idx_d, boxes_d = torch.from_numpy(c_idx).to(dev), torch.from_numpy(c_boxes).to(dev)
            ga = mirrors["genderage.onnx"].to(dev).eval()(warp2pass.warp_boxes_two_pass(
                canvases, idx_d, boxes_d, ATTR_SIZES[0], scale_factor=1.5).permute(
                0, 3, 1, 2).float()).cpu().numpy()
            lm_norm = mirrors["2d106det.onnx"].to(dev).eval()(warp2pass.warp_boxes_two_pass(
                canvases, idx_d, boxes_d, ATTR_SIZES[1], scale_factor=1.5).permute(
                0, 3, 1, 2).float()).reshape(len(c_list), -1, 2)
            m_inv = warp2pass.boxes_to_affines(boxes_d, ATTR_SIZES[1], 1.5)
            lm_want = (torch.einsum("mij,mkj->mki", m_inv[:, :, :2],
                                    (lm_norm + 1.0) * ATTR_SIZES[1] / 2)
                       + m_inv[:, None, :, 2]).cpu().numpy()
        decided = np.abs(ga[:, 0] - ga[:, 1]) > 1e-4
        attr_age_err = float(np.abs(age - np.round(ga[:, 2] * 100.0)).max())
        attr_lm_err = float(np.abs(lm - lm_want).max())
        check(np.array_equal(gender[decided], np.argmax(ga[:, :2], 1)[decided])
              and attr_age_err <= 1.0 and attr_lm_err <= 1e-3,
              f"[convert] the exact graphs against the mirror heads: gender, age err "
              f"{attr_age_err}, landmarks err {attr_lm_err} px")
        # bf16 against an f32 engine on the same K3 crops (the fused rgb path
        # embeds from the letterboxed canvases)
        f32_engine = FaceEngine(EngineConfig(det_size=(CANVAS, CANVAS), dtype="float32"),
                                device="cuda")
        e32 = f32_engine.embed_faces(canvases, c_idx, np.stack([f.kps for f in c_list]).astype(
            np.float32))
        e16 = np.stack([f.normed_embedding for f in c_list])
        bf16_cos = float((e16 * e32).sum(1).min())
        check(1.0 - bf16_cos <= 1e-3, f"[convert] bf16 against f32 on the same crops: "
                                      f"1-cos {1.0 - bf16_cos}")
        del f32_engine
        say(f"[convert] {card} | FaceAnalysis(buffalo_l) from the converted pack (bf16, "
            f"{n_leaves} leaves equal to the pack's) built in {build_s:.2f} s; request wall ms "
            f"{[round(t, 1) for t in c_ms]}, faces {c_faces}; request 1: {k}/{k} faces matched "
            f"their own id ({twins} of them a twin's: {distinct} distinct embeddings; min score "
            f"{min(r['similarity'] for rows in out0 for r in rows):.6f}); "
            f"bf16 vs f32 on the same crops 1-cos {1.0 - bf16_cos:.2e}; exact-graph heads vs "
            f"the mirrors: gender equal on {int(decided.sum())} decided, age err "
            f"{attr_age_err:.0f}, landmarks err {attr_lm_err:.2e} px")
    finally:
        if weights_env is None:
            os.environ.pop("FRE_WEIGHTS_DIR", None)
        else:
            os.environ["FRE_WEIGHTS_DIR"] = weights_env
        shutil.rmtree(pack_dir, ignore_errors=True)
        shutil.rmtree(wdir, ignore_errors=True)

    # --------------------------------------------------- d. the ops surface
    wf_err = 0.0
    for b, fl in enumerate(faces0):
        if not fl:
            continue
        img = np.ascontiguousarray(requests[0][b][..., ::-1])
        kps = torch.from_numpy(np.stack([f.kps for f in fl]).astype(np.float32))
        on_card = warp_faces(torch.from_numpy(img).to(dev), kps.to(dev)).cpu()
        on_cpu = warp_faces(torch.from_numpy(img), kps)
        wf_err = max(wf_err, float((on_card - on_cpu).abs().max()))
    check(wf_err <= 1e-4, f"[convert] warp_faces on the card against the CPU: {wf_err}")
    frame = torch.from_numpy(smooth_frame()).to(dev)
    two_pass = {}
    for i, deg in enumerate(CONVERT_ROTATIONS):
        kps = torch.from_numpy(inside_kps(np.random.default_rng(13 + i), np.deg2rad(deg))).to(dev)
        got = warp2pass.warp_faces_two_pass(frame[None], torch.zeros(
            CONVERT_FACES, dtype=torch.int32, device=dev), kps)
        diff = (got - warp_faces(frame, kps)).abs().flatten(1)
        worst = {"max": float(diff.max()), "mean": float(diff.mean(1).max()),
                 "median": float(diff.median(1).values.max())}
        two_pass[deg] = worst
        check((worst["max"] < 0.35 if deg == 0 else True) and worst["mean"] < 1.0
              and worst["median"] < 0.5,
              f"[convert] K3 against the bilinear warp at {deg} degrees: {worst}")
    q = torch.from_numpy(e16).to(dev)
    g = torch.from_numpy(matrix.astype(np.float32)).to(dev)
    cs_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        qd, gd = q.to(dtype), g.to(dtype)
        got = cosine_scores(qd, gd)
        want64 = qd.double() @ gd.double().T
        cs_err[str(dtype).split(".")[1]] = {
            "vs_expression": float((got - qd.float() @ gd.float().T).abs().max()),
            "vs_float64": float((got.double() - want64).abs().max())}
    check(all(v <= 1e-5 for e in cs_err.values() for v in e.values()),
          f"[convert] cosine_scores on the card: {cs_err}")
    say(f"[convert] {card} | ops: warp_faces card vs CPU on request 1's {len(c_list)} faces "
        f"max err {wf_err:.2e}; K3 against warp_faces on {CONVERT_FACES} faces a angle (worst "
        f"face) " + ", ".join(f"{d} deg max {v['max']:.3f} mean {v['mean']:.3f} median "
                              f"{v['median']:.3f}" for d, v in two_pass.items())
        + f"; cosine_scores {cs_err}")

    def request():
        return [proc.match_faces(f, fl, "site-c", draw=False)
                for f, fl in zip(requests[1], capp.get_batch(requests[1]))]

    return ({"card": card, "pack": "tools/synthetic_pack.make_pack (TorchScript export)",
             "pack_s": pack_s, "convert_host_s": convert_s, "tensors_written": written,
             "f32_vs_mirrors": f32_err, "build_s": build_s, "requests": REQUESTS,
             "frames_per_request": FRAMES, "request_ms": c_ms, "faces_per_request": c_faces,
             "gallery_setup_ms": setup_ms, "launches": c_launches,
             "bf16_vs_f32_one_minus_cos": 1.0 - bf16_cos, "attr_age_err": attr_age_err,
             "attr_landmark_err_px": attr_lm_err, "warp_faces_card_vs_cpu": wf_err,
             "two_pass_vs_bilinear": two_pass, "cosine_scores_err": cs_err,
             "phase_s": time.perf_counter() - t_phase}, request)


def main() -> int:
    import torch

    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    faulthandler.enable(all_threads=True)  # a crash prints every thread's stack
    faulthandler.dump_traceback_later(1000, exit=True)
    from facerecognition_infrenceengine_tpu_torch.core.config import (
        Config, EngineConfig, ThresholdConfig)
    from facerecognition_infrenceengine_tpu_torch.core.clock import get_current_utc
    from facerecognition_infrenceengine_tpu_torch.core.serialization import serialize_embedding
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import (
        GalleryManager, _CompanySnapshot)
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
    from facerecognition_infrenceengine_tpu_torch.engine.recognizer import (
        FaceRecognitionProcessor)
    from facerecognition_infrenceengine_tpu_torch import native
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import _YUV_BLACK, bucket
    from facerecognition_infrenceengine_tpu_torch.kernels import build
    from facerecognition_infrenceengine_tpu_torch.models import genderage, landmark106, scrfd
    from facerecognition_infrenceengine_tpu_torch.models.onnx_export import head_graph
    from facerecognition_infrenceengine_tpu_torch.models.weights import load_or_init
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis, letterbox
    from facerecognition_infrenceengine_tpu_torch.native import plain
    from facerecognition_infrenceengine_tpu_torch.ops import (
        epilogue_kernel, match_kernel, stem_kernel, warp2pass, warp_kernel, yuv)
    from facerecognition_infrenceengine_tpu_torch.ops.align import (
        ARCFACE_DST, _invert_affine, umeyama_similarity)
    from facerecognition_infrenceengine_tpu_torch.store import Datastore, ObjectId

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
    galleries = GalleryManager(Datastore(cfg), cfg, initial_load=False, device="cuda")
    proc = FaceRecognitionProcessor(galleries, face_app=app, cfg=cfg)

    warp_kernel.warp_rois.launches = 0
    match_kernel.gallery_top1.launches = 0
    epilogue_kernel.epilogue.launches = 0
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
                "gallery_top1": match_kernel.gallery_top1.launches,
                "epilogue": epilogue_kernel.epilogue.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    say(f"[path] valid slots per request {faces_per_request} of {FRAMES * cfg.engine.max_faces}")
    say(f"[path] gallery capacity {snap.device_matrix.shape[0]} n_valid {snap.size} "
        f"({snap.dtype}), built in {setup_ms:.1f} ms")
    say(f"[path] launches on the path {launches}")
    check(snap.device_matrix.shape[0] == CAPACITY and snap.size == CAPACITY_ROWS, "gallery shape")
    check(all(n > 0 for n in faces_per_request), "a request found no valid slot")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    # serve_forward's epilogues: the stem's and three a block, in every r50 forward
    check(launches["epilogue"] % (1 + 3 * engine.embedder.num_blocks) == 0,
          f"epilogue launches {launches['epilogue']} are not whole r50 forwards")
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
    ygal = GalleryManager(Datastore(ycfg), ycfg, initial_load=False, device="cuda")
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

    hgal = GalleryManager(Datastore(hcfg), hcfg, initial_load=False, device="cuda")
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

    # -------------------------------------------------------------- mfn path
    mcfg = Config(thresholds=ThresholdConfig(detection=DET_THRESH),
                  engine=EngineConfig(det_size=(CANVAS, CANVAS)))
    t0 = time.perf_counter()
    mapp = FaceAnalysis("mobile_facenet_v1", cfg=mcfg.engine, device="cuda",
                        allowed_modules=("detection", "recognition"))
    mapp.prepare(ctx_id=0, det_thresh=DET_THRESH)
    mengine = mapp._ensure_engine()
    check(mengine.rec_arch == "mobilefacenet", f"mobile_facenet_v1 built {mengine.rec_arch}")
    say(f"[mfn] FaceAnalysis(mobile_facenet_v1) det_10g + MobileFaceNet {mcfg.engine.dtype} "
        f"{mcfg.engine.det_size}, built in {time.perf_counter() - t0:.2f} s")
    mgal = GalleryManager(Datastore(mcfg), mcfg, initial_load=False, device="cuda")
    mproc = FaceRecognitionProcessor(mgal, face_app=mapp, cfg=mcfg)
    warp_kernel.warp_rois.launches = 0
    warp_kernel.warp_rois.launches_by_size.clear()
    match_kernel.gallery_top1.launches = 0
    match_kernel.gallery_top1_int8.launches = 0
    stem_kernel.fused_stem.launches = 0
    m_ms, m_faces, m_results = [], [], []
    m_setup_ms = 0.0
    for r, frames in enumerate(requests):
        t0 = time.perf_counter()
        faces = mapp.get_batch(frames)
        setup = 0.0
        if r == 0:  # enrol request 1's faces plus the seeded distractors
            t1 = time.perf_counter()
            mown = [f"r0-f{i}-s{j}" for i, fl in enumerate(faces) for j in range(len(fl))]
            emb = [f.normed_embedding for fl in faces for f in fl]
            n_dis = CAPACITY_ROWS - len(mown)
            dis = np.random.default_rng(1).normal(size=(n_dis, 512)).astype(np.float32)
            mids = mown + [f"distractor-{k}" for k in range(n_dis)]
            mmeta = {pid: {"type": "employee", "name": pid} for pid in mids}
            msnap = mgal.set_snapshot(mids, mmeta, np.concatenate([np.stack(emb), dis]),
                                      company_id="site-1")
            torch.cuda.synchronize()
            setup = time.perf_counter() - t1
            m_setup_ms = setup * 1e3
        out = [mproc.match_faces(frame, fl, "site-1", draw=False)[1]
               for frame, fl in zip(frames, faces)]
        torch.cuda.synchronize()
        m_ms.append((time.perf_counter() - t0 - setup) * 1e3)
        m_faces.append(sum(len(fl) for fl in faces))
        m_results.append((faces, out))
    m_launches = {"warp_rois": dict(warp_kernel.warp_rois.launches_by_size),
                  "gallery_top1": match_kernel.gallery_top1.launches,
                  "gallery_top1_int8": match_kernel.gallery_top1_int8.launches,
                  "fused_stem": stem_kernel.fused_stem.launches}
    say(f"[mfn] launches on the path {m_launches}")
    check(all(n > 0 for n in m_faces), "an mfn request found no valid slot")
    check(msnap.device_matrix.shape[0] == CAPACITY and msnap.size == CAPACITY_ROWS,
          "mfn gallery shape")
    check(m_launches["warp_rois"] == {112: REQUESTS}
          and m_launches["gallery_top1"] == sum(1 for fs, _ in m_results for fl in fs if fl)
          == REQUESTS * FRAMES and m_launches["gallery_top1_int8"] == 0
          and m_launches["fused_stem"] == 0,
          f"the mfn path must launch K3 once a request and K1 once a frame: {m_launches}")
    k = 0
    for fl, rows in zip(*m_results[0]):
        for face, row in zip(fl, rows):
            check(abs(float(np.linalg.norm(face.normed_embedding)) - 1.0) < 1e-3, "mfn norm")
            check(row["recognized"] and row["person_id"] == mown[k] and row["similarity"] >= 0.99,
                  f"mfn request 1 face {mown[k]} matched {row['person_id']} at "
                  f"{row['similarity']}")
            k += 1

    def mfn_request():
        return [mproc.match_faces(f, fl, "site-1", draw=False)
                for f, fl in zip(requests[1], mapp.get_batch(requests[1]))]

    def rgb_request():
        return [proc.match_faces(f, fl, "site-1", draw=False)
                for f, fl in zip(requests[1], app.get_batch(requests[1]))]

    # a small det_2.5g + MobileFaceNet f32 engine on the card against the CPU, on
    # request 1's faces (K3 and plain crops of the native frames)
    small_m = EngineConfig(det_size=(128, 128), max_faces=8, pre_nms_topk=64, dtype="float32")
    m_idx = np.asarray([b for b, fl in enumerate(m_results[0][0]) for _ in fl], np.int32)
    m_kps = np.stack([f.kps for fl in m_results[0][0] for f in fl]).astype(np.float32)
    m_rgb = np.stack([np.ascontiguousarray(f[..., ::-1]) for f in requests[0]])
    e_card = FaceEngine(small_m, det_arch="det_2.5g", rec_arch="mobilefacenet",
                        device="cuda").embed_faces(m_rgb, m_idx, m_kps)
    e_cpu = FaceEngine(small_m, det_arch="det_2.5g", rec_arch="mobilefacenet",
                       device="cpu").embed_faces(m_rgb, m_idx, m_kps)
    m_cos = float((e_card * e_cpu).sum(1).min())
    check(1.0 - m_cos <= 1e-4, f"MobileFaceNet f32 card vs CPU: 1-cos {1.0 - m_cos}")
    say(f"[mfn] {card} | request wall ms {[round(t, 1) for t in m_ms]} (r50 rgb path: "
        f"{[round(t, 1) for t in request_ms]}); request 1: {k}/{k} faces matched their own "
        f"id (min score {min(r['similarity'] for rows in m_results[0][1] for r in rows):.6f});"
        f" det_2.5g+MobileFaceNet f32 card vs CPU on {len(m_idx)} faces: 1-cos "
        f"{1.0 - m_cos:.2e}")

    # ------------------------------------------------------------- onnx path
    # the synthetic heads (seeds 7 and 8) written as buffalo_l-shaped graphs in
    # a temporary weights dir: FaceAnalysis("buffalo_l") then runs the exact
    # graphs through models/onnx_exec.py, on K3 crops at the graphs' sizes
    ga_f32 = load_or_init("genderage", genderage.GenderAge(), 7)
    lm_f32 = load_or_init("landmark_2d_106", landmark106.Landmark106(), 8)
    onnx_dir = tempfile.mkdtemp(prefix="fre-onnx-")
    weights_env = os.environ.get("FRE_WEIGHTS_DIR")
    try:
        with open(os.path.join(onnx_dir, "attr_genderage.onnx"), "wb") as f:
            f.write(head_graph(ga_f32, ATTR_SIZES[0]))
        with open(os.path.join(onnx_dir, "attr_2d106det.onnx"), "wb") as f:
            f.write(head_graph(lm_f32, ATTR_SIZES[1], batch1_reshape=True))
        os.environ["FRE_WEIGHTS_DIR"] = onnx_dir
        t0 = time.perf_counter()
        oapp = FaceAnalysis("buffalo_l", cfg=EngineConfig(det_size=(CANVAS, CANVAS)),
                            device="cuda")
        oapp.prepare(ctx_id=0, det_thresh=DET_THRESH)
        oengine = oapp._ensure_engine()
        oengine._ensure_attr_models()
    finally:
        if weights_env is None:
            os.environ.pop("FRE_WEIGHTS_DIR", None)
        else:
            os.environ["FRE_WEIGHTS_DIR"] = weights_env
        shutil.rmtree(onnx_dir, ignore_errors=True)
    check(oengine._attr_runners is not None and oengine._attr_sizes == ATTR_SIZES,
          f"the exact graphs were not picked up: sizes {oengine._attr_sizes}")
    check(oapp.allowed_modules == ALL_MODULES, f"default modules {oapp.allowed_modules}")
    say(f"[onnx] FaceAnalysis(buffalo_l) with attr_genderage.onnx + attr_2d106det.onnx "
        f"({sum(r.param_census() for r in oengine._attr_runners)} weights), runners at sizes "
        f"{oengine._attr_sizes}, built in {time.perf_counter() - t0:.2f} s")
    warp_kernel.warp_rois.launches = 0
    warp_kernel.warp_rois.launches_by_size.clear()
    match_kernel.gallery_top1.launches = 0
    o_ms, o_results = [], []
    for frames in requests[:2]:
        t0 = time.perf_counter()
        o_results.append(oapp.get_batch(frames))
        torch.cuda.synchronize()
        o_ms.append((time.perf_counter() - t0) * 1e3)
    o_launches = {"warp_rois": dict(warp_kernel.warp_rois.launches_by_size),
                  "gallery_top1": match_kernel.gallery_top1.launches}
    say(f"[onnx] launches on the path {o_launches}")
    check(o_launches["warp_rois"] == {112: 2, ATTR_SIZES[0]: 2, ATTR_SIZES[1]: 2},
          f"the onnx path must launch K3 once a request at 112, 96 and 192: {o_launches}")
    # request 1 against the float32 nn.Module heads on the same K3 crops of the
    # same canvases
    o_faces = [f for fl in o_results[0] for f in fl]
    canvases = torch.from_numpy(np.stack([letterbox(np.ascontiguousarray(f[..., ::-1]),
                                                    (CANVAS, CANVAS))[0]
                                          for f in requests[0]])).to(dev)
    o_idx = torch.tensor([b for b, fl in enumerate(o_results[0]) for _ in fl], device=dev)
    o_boxes = torch.from_numpy(np.stack([f.bbox for f in o_faces]).astype(np.float32)).to(dev)
    ga_dev, lm_dev = ga_f32.to(dev), lm_f32.to(dev)
    with torch.inference_mode():
        ga_out = ga_dev(genderage.preprocess(warp2pass.warp_boxes_two_pass(
            canvases, o_idx, o_boxes, ATTR_SIZES[0]))).cpu().numpy()
        lm_norm = lm_dev(genderage.preprocess(warp2pass.warp_boxes_two_pass(
            canvases, o_idx, o_boxes, ATTR_SIZES[1]))).float()
        m_inv = warp2pass.boxes_to_affines(o_boxes, ATTR_SIZES[1])
        lm_want = (torch.einsum("mij,mkj->mki", m_inv[:, :, :2],
                                (lm_norm + 1.0) * ATTR_SIZES[1] / 2)
                   + m_inv[:, None, :, 2]).cpu().numpy()
    g_got = np.asarray([f.gender for f in o_faces])
    a_got = np.asarray([f.age for f in o_faces], np.float64)
    l_got = np.stack([f.landmark_2d_106 for f in o_faces])
    decided = np.abs(ga_out[:, 0] - ga_out[:, 1]) > 1e-4
    check(np.array_equal(g_got[decided], np.argmax(ga_out[:, :2], 1)[decided]),
          "exact-graph gender differs from the float32 head's")
    age_err = float(np.abs(a_got - np.round(ga_out[:, 2] * 100.0)).max())
    lm_px_err = float(np.abs(l_got - lm_want).max())
    check(age_err <= 1.0 and lm_px_err <= 1e-3,
          f"exact-graph age err {age_err}, landmarks err {lm_px_err} px")
    o_idx_np, o_boxes_np = o_idx.cpu().numpy(), o_boxes.cpu().numpy()
    say(f"[onnx] {card} | request wall ms {[round(t, 1) for t in o_ms]}; request 1's "
        f"{len(o_faces)} faces against the float32 heads on the same crops: gender equal on "
        f"{int(decided.sum())} decided, age err {age_err:.0f}, landmarks err "
        f"{lm_px_err:.2e} px")

    # ---------------------------------------------------------- convert path
    # a buffalo_l-shaped pack converted on this host by the port's converter
    # (no JAX), held against its torch mirrors and served; its launches join
    # the kernels line
    convert_out, convert_request = convert_phase(torch, card, requests)

    # ---------------------------------------------------------- gallery path
    # the store-backed gallery: 50,000 employees written into a memory://
    # Datastore in bulk (one GridFS put a person, one insert_many), loaded by
    # an f32 (K1) and an int8 (K2) GalleryManager; then the delta sync on a
    # second store of 2,000 (the audit is quadratic in the gallery: a 50,000
    # store would take minutes a sync)
    gcfg = Config(thresholds=ThresholdConfig(detection=DET_THRESH),
                  engine=EngineConfig(det_size=(CANVAS, CANVAS)))
    g8cfg = Config(thresholds=gcfg.thresholds,
                   engine=EngineConfig(det_size=(CANVAS, CANVAS), gallery_dtype="int8"))
    own_vecs = np.stack([f.normed_embedding for fl in results[0][0] for f in fl])
    g_dis = np.random.default_rng(9).normal(size=(CAPACITY_ROWS - len(own_vecs), 512))
    gds, gco = Datastore(gcfg), ObjectId()
    t0 = time.perf_counter()
    g_ids = write_people(gds, gco, np.concatenate([own_vecs, g_dis]).astype(np.float32), "E")
    g_write_s = time.perf_counter() - t0
    match_kernel.gallery_top1.launches = 0
    match_kernel.gallery_top1_int8.launches = 0
    g_times = {}
    g_out = {}
    for dtype_name, c_ in (("float32", gcfg), ("int8", g8cfg)):
        t0 = time.perf_counter()
        gm = GalleryManager(gds, c_, device="cuda")
        t1 = time.perf_counter()
        gsnap = gm.snapshot(str(gco))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scores, ids, _ = gm.match(own_vecs, company_id=str(gco))
        t3 = time.perf_counter()
        g_times[dtype_name] = {"initial_load_s": t1 - t0, "snapshot_build_s": t2 - t1,
                               "first_match_ms": (t3 - t2) * 1e3}
        g_out[dtype_name] = (gm, gsnap, scores, ids)
        check(gm.get_stats()["total_embeddings"] == CAPACITY_ROWS
              and gsnap.size == CAPACITY_ROWS and gsnap.device_matrix.shape[0] == CAPACITY,
              f"{dtype_name} gallery: {gm.get_stats()}, snapshot {gsnap.size}")
    g_launches = {"gallery_top1": match_kernel.gallery_top1.launches,
                  "gallery_top1_int8": match_kernel.gallery_top1_int8.launches}
    check(g_launches == {"gallery_top1": 1, "gallery_top1_int8": 1},
          f"the gallery phase must launch K1 and K2 once each: {g_launches}")
    _, _, s32, ids32 = g_out["float32"]
    n_own = len(own_vecs)
    check([r[0] for r in ids32] == g_ids[:n_own] and float(s32[:, 0].min()) >= 0.99,
          f"f32 gallery: {sum(r[0] != p for r, p in zip(ids32, g_ids))} faces miss their own "
          f"id, min score {float(s32[:, 0].min())}")
    _, snap8, s8, ids8 = g_out["int8"]
    q8 = np.zeros((bucket(n_own), 512), np.float32)
    q8[:n_own] = own_vecs
    pv, pi = match_kernel.gallery_top1_int8_plain(torch.from_numpy(q8).to(dev),
                                                  snap8.device_matrix, snap8.int8_scale,
                                                  snap8.size)
    pv, pi = pv.cpu().numpy()[:n_own], pi.cpu().numpy()[:n_own]
    check(np.array_equal(s8[:, 0], pv) and [r[0] for r in ids8] == [snap8.ids[i] for i in pi],
          "K2 behind the store-backed gallery differs from the plain int8 version")
    say(f"[gallery] {card} | {CAPACITY_ROWS} employees written in {g_write_s:.2f} s "
        f"(GridFS puts + insert_many); " + "; ".join(
            f"{k}: initial load {v['initial_load_s']:.2f} s, snapshot build "
            f"{v['snapshot_build_s']:.2f} s, first match ({n_own} faces) "
            f"{v['first_match_ms']:.2f} ms" for k, v in g_times.items())
        + f"; request 1's {n_own} faces found their own ids (min f32 score "
        f"{float(s32[:, 0].min()):.6f}), K2's ids and scores equal to the plain int8 version")
    del g_out, gds

    # the delta sync on a site-sized store
    dds, dco = Datastore(gcfg), ObjectId()
    d_vecs = np.random.default_rng(10).normal(size=(DELTA_ROWS + 11, 512)).astype(np.float32)
    d_vecs /= np.linalg.norm(d_vecs, axis=1, keepdims=True)
    d_ids = write_people(dds, dco, d_vecs[:DELTA_ROWS], "D")
    dm = GalleryManager(dds, gcfg, device="cuda")
    dm.snapshot(str(dco)), dm.snapshot(None)
    builds = _CompanySnapshot.full_builds
    added = write_people(dds, dco, d_vecs[DELTA_ROWS:DELTA_ROWS + 10], "A")
    archived, deleted = d_ids[:10], d_ids[10:15]
    dds.employee_info.update_many({"_id": {"$in": [ObjectId(p) for p in archived]}},
                                  {"$set": {"status": "archived",
                                            "deletedAt": get_current_utc()}})
    dds.employee_info.delete_many({"_id": {"$in": [ObjectId(p) for p in deleted]}})
    t0 = time.perf_counter()
    dm.force_sync()
    sync_ms = (time.perf_counter() - t0) * 1e3
    stats = dm.get_stats()
    want_n = DELTA_ROWS + 10 - 10 - 5
    check(_CompanySnapshot.full_builds == builds, "the delta sync rebuilt a snapshot")
    check(stats["total_embeddings"] == stats["employees"] == want_n and stats["visitors"] == 0,
          f"stats after the delta: {stats}, want {want_n}")
    removed = set(archived) | set(deleted)
    probe = np.concatenate([d_vecs[:15], d_vecs[DELTA_ROWS:DELTA_ROWS + 10]])
    for key in (str(dco), None):
        scores, ids, _ = dm.match(probe, company_id=key)
        check(not removed & {r[0] for r in ids}, "a removed id was returned")
        check([r[0] for r in ids[15:]] == added and float(scores[15:, 0].min()) >= 0.99,
              "an appended person does not match itself")
        check(dm.snapshot(key).size == want_n, f"snapshot {key}: {dm.snapshot(key).size}")
    late = write_people(dds, dco, d_vecs[DELTA_ROWS + 10:], "L")
    dm.sync_interval = 0.05
    dm.start_sync()
    deadline = time.time() + 30
    while dm.get_stats()["total_embeddings"] < want_n + 1 and time.time() < deadline:
        time.sleep(0.02)
    dm.stop_sync()
    _, ids, _ = dm.match(d_vecs[DELTA_ROWS + 10:], company_id=str(dco))
    check(dm.get_stats()["total_embeddings"] == want_n + 1 and ids[0][0] == late[0]
          and not dm._thread.is_alive(), "start_sync/stop_sync: the sync thread's tick")
    say(f"[gallery] {card} | delta sync on {DELTA_ROWS}: append 10, archive 10 "
        f"(update_many), hard-delete 5 -> force_sync {sync_ms:.1f} ms, no rebuild, "
        f"{want_n} left; no removed id returned, the 10 appended match themselves; the sync "
        f"thread picked up one more and stopped")
    g_launches = {"gallery_top1": match_kernel.gallery_top1.launches,
                  "gallery_top1_int8": match_kernel.gallery_top1_int8.launches}
    say(f"[gallery] launches in the phase {g_launches}")

    # ------------------------------------------------- the mesh and the trainer
    # the sharded gallery (the [gallery] phase's 50,000 persons) and
    # make_sharded_fused on a mesh, then engine/training.py at full width;
    # their launches join the kernels line
    mesh_out = mesh_phase(torch, card, g_ids, np.concatenate([own_vecs, g_dis]).astype(
        np.float32), engine, yapp, requests[0])
    train_out = train_phase(torch, card)
    torch.cuda.empty_cache()

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

    ep = epilogue_phase(torch, card)
    ln = layernorm_phase(torch, card)
    vp = vit_phase(torch, card)

    def k3_entry(name, size, n_launches, err, t, **extra):
        return {"name": name, "route": "cuda", "source": WARP_SRC,
                "replaces": "facerecognition_infrenceengine_tpu/ops/warp_pallas.py:115",
                "launches": n_launches, "max_abs_err": err, "library_ms": None,
                "out_size": size, **t, **extra}

    kernels = [
        k3_entry("warp_rois", 112, launches["warp_rois"] + h_launches["warp_rois"].get(112, 0)
                 + m_launches["warp_rois"].get(112, 0) + o_launches["warp_rois"].get(112, 0),
                 max(warp_err, path_err), k3[112]),
    ] + [
        k3_entry(f"warp_rois_out{size}", size, h_launches["warp_rois"].get(size, 0)
                 + o_launches["warp_rois"].get(size, 0), attr_err[size], k3[size])
        for size in ATTR_SIZES
    ] + [
        k3_entry("warp_windows_packed", 112, y_launches["warp_rois"], packed_err, k3["packed"],
                 packed=True),
        {"name": "gallery_top1", "route": "cuda", "source": MATCH_SRC,
         "replaces": "facerecognition_infrenceengine_tpu/ops/match_pallas.py:79",
         "launches": launches["gallery_top1"] + y_launches["gallery_top1"]
         + h_launches["gallery_top1"] + m_launches["gallery_top1"] + g_launches["gallery_top1"],
         "max_abs_err": top1_err["float32"],
         "ms": times[("float32", path_b)], "kernel_device_ms": dev_times[("float32", path_b)],
         "plain_ms": top1_plain_ms, "bound_ms": top1_bound,
         "bound_by": top1_by, "library_ms": top1_lib_ms,
         "library_ms_bf16": lib_times[("bfloat16", path_b)]},
        {"name": "gallery_top1_int8", "route": "cuda", "source": MATCH_INT8_SRC,
         "replaces": "facerecognition_infrenceengine_tpu/ops/match_pallas.py:235",
         "launches": y_launches["gallery_top1_int8"] + g_launches["gallery_top1_int8"],
         "max_abs_err": 0.0,
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
        {"name": "epilogue", "route": "cuda", "source": EPILOGUE_SRC, "replaces": None,
         "launches": launches["epilogue"], "max_abs_err": 0.0, "B": EPILOGUE_B, **ep["bn_prelu"],
         "bn_bn_res": ep["bn_bn_res"]},
        {"name": "residual_layernorm", "route": "cuda", "source": LAYERNORM_SRC,
         "replaces": None, "launches": vp["launches"], "forwards": vp["forwards"],
         "max_abs_err": ln["max_abs_err"]["fused.bfloat16"], "vit_cos_gap": vp["cos_gap"],
         "shape": [LAYERNORM_CROPS, VIT_TOKENS, VIT_WIDTH], **ln["residual"],
         "no_residual": ln["no_residual"]},
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
    # the new paths' device time, traced last, after every kernel's own times:
    # a request of the mfn path beside one of the r50 rgb path, and the
    # attributes call with the exact graphs beside the synthetic heads
    m_dev_ms, rgb_dev_ms = device_ms(torch, mfn_request, 3), device_ms(torch, rgb_request, 3)
    o_dev_ms = device_ms(torch, lambda: oengine.attributes(canvases, o_idx_np, o_boxes_np), 3)
    s_dev_ms = device_ms(torch, lambda: hengine.attributes(canvases, o_idx_np, o_boxes_np), 3)
    say(f"[mfn] {card} | device {m_dev_ms:.3f} ms a request (the r50 rgb path: "
        f"{rgb_dev_ms:.3f} ms)")
    say(f"[onnx] {card} | attributes on {len(o_faces)} faces, device {o_dev_ms:.3f} ms a call "
        f"(exact graphs, float32) against {s_dev_ms:.3f} ms (the synthetic heads, bf16)")
    convert_out["device_ms_a_request"] = device_ms(torch, convert_request, 3)
    say(f"[convert] {card} | device {convert_out['device_ms_a_request']:.3f} ms a request "
        f"(the converted pack, bf16)")

    # ----------------------------------------------------------- int8 path
    # the opt-in scale modes (int8 embedder and detector backbone, the packed
    # plain-conv stems), after every kernel's own traces; its K3 and K1
    # launches join the kernels line
    int8 = int8_phase(torch, card, requests, cfg, app, yapp)

    # ---------------------------------------------------------- server path
    # the live server, run a as the reference ships it (Config() defaults),
    # run b on the streaming profile; then the entry point in a subprocess.
    # Last of the phases: its traces are started and stopped by the control
    # API's trace thread, and a trace taken before the kernels' own traces
    # has been seen to leave them empty (the K2 one-kernel check)
    server_runs = server_phase(
        torch, card, requests[0], Config(),
        Config(engine=EngineConfig(stream_transport="yuv420", upload_on_submit=True,
                                   packed_stem_impl="pallas", gallery_dtype="int8",
                                   stream_profile="auto")))

    # ------------------------------------------- enrollment and counting
    # the enrollment worker and the people counter as their servers run
    # them, over one memory:// store holding a 2,000-person site (another
    # company), with Config() as shipped but for duplicate_face (see
    # ENROLL_DUPLICATE_FACE); then the four entry points
    cfg_site = Config(thresholds=ThresholdConfig(duplicate_face=ENROLL_DUPLICATE_FACE))
    site_ds = Datastore(cfg_site)
    site = np.random.default_rng(31).normal(size=(SERVER_PERSONS, 512)).astype(np.float32)
    write_people(site_ds, ObjectId(), site / np.linalg.norm(site, axis=1, keepdims=True), "P")
    site_gallery = GalleryManager(site_ds, cfg_site, sync_interval_s=cfg_site.sync.counting_sync_s)
    t0 = time.perf_counter()
    kiosk_app = FaceAnalysis(name=cfg_site.worker.model_name, cfg=cfg_site.engine)
    kiosk_app.prepare(ctx_id=0)
    say(f"[enroll] FaceAnalysis({cfg_site.worker.model_name}) with {kiosk_app.allowed_modules} "
        f"{cfg_site.engine.dtype} built in {time.perf_counter() - t0:.2f} s; site of "
        f"{SERVER_PERSONS} persons loaded")
    enroll, kiosk_bytes = enroll_phase(torch, card, site_ds, cfg_site, site_gallery, kiosk_app)
    site_gallery.start_sync()
    try:
        count = count_phase(torch, card, requests[0], site_ds, cfg_site, site_gallery,
                            ObjectId(), kiosk_app)
    finally:
        site_gallery.stop_sync()
    del kiosk_app
    entry = entry_points_check(card, kiosk_bytes[0])
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
    say(json.dumps({"mfn_path": {"card": card, "requests": REQUESTS, "frames_per_request": FRAMES,
                                 "request_ms": m_ms, "device_ms_a_request": m_dev_ms,
                                 "rgb_r50_device_ms_a_request": rgb_dev_ms,
                                 "faces_per_request": m_faces, "gallery_setup_ms": m_setup_ms,
                                 "launches": m_launches, "card_vs_cpu_1_minus_cos": 1.0 - m_cos}}))
    say(json.dumps({"onnx_path": {"card": card, "requests": 2, "frames_per_request": FRAMES,
                                  "request_ms": o_ms, "launches": o_launches,
                                  "attributes_device_ms_exact_f32": o_dev_ms,
                                  "attributes_device_ms_synthetic_bf16": s_dev_ms,
                                  "faces": len(o_faces), "age_err": age_err,
                                  "landmark_err_px": lm_px_err}}))
    say(json.dumps({"convert_path": convert_out}))
    say(json.dumps({"gallery_path": {"card": card, "persons": CAPACITY_ROWS,
                                     "write_s": g_write_s, **{f"{k}_{n}": v for k, t in
                                                              g_times.items()
                                                              for n, v in t.items()},
                                     "delta_store_persons": DELTA_ROWS,
                                     "force_sync_ms": sync_ms, "launches": g_launches}}))
    for run in server_runs:
        say(json.dumps({"server_path": dict(run, entry_point=entry["inference_server"])}))
    say(json.dumps({"int8_path": int8}))
    say(json.dumps({"mesh_path": mesh_out}))
    say(json.dumps({"train_path": train_out}))
    say(json.dumps({"enroll_path": enroll}))
    say(json.dumps({"count_path": count}))
    say(json.dumps({"entry_points": entry}))
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
    # the enrollment and counting phases' launches join the paths' counts
    for phase in (enroll, count):
        by_size, k1 = phase["launches"]["warp_rois"], phase["launches"]["gallery_top1"]
        for k in kernels:
            if k["name"].startswith("warp_rois") and not k.get("packed"):
                k["launches"] += by_size.get(k["out_size"], 0)
            elif k["name"] == "gallery_top1":
                k["launches"] += k1
    # and the [convert] phase's (K3 at 112, 96 and 192, K1)
    for k in kernels:
        if k["name"].startswith("warp_rois") and not k.get("packed"):
            k["launches"] += convert_out["launches"]["warp_rois"].get(k["out_size"], 0)
        elif k["name"] == "gallery_top1":
            k["launches"] += convert_out["launches"]["gallery_top1"]
    # and the [int8] phase's (K3 at 112, raw and packed, and K1) and the
    # [mesh] phase's (K1 and K2 once a shard, K3 and K4 once a data shard)
    for k in kernels:
        k["launches"] += int8["launches"].get(k["name"], 0)
        k["launches"] += mesh_out["launches"].get(k["name"], 0)
    say(json.dumps({"kernels": kernels}))
    say(f"[done] {card} | the script took {time.perf_counter() - t_script:.1f} s")
    say(card_line())
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
