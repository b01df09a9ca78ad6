"""One run of a cell: set-up, the measured window, the traced span.

The entry under test is the live server's data plane without HTTP or
capture threads: ``clients`` cameras, each submitting a frame to
``engine/microbatch.MicroBatcher`` over a ``models/zoo.FaceAnalysis`` and
waiting for its decisions before it submits the next (a closed loop, one
frame outstanding a camera, a thread a camera).  One results thread turns
each resolved frame into decisions with ``engine/recognizer.
FaceRecognitionProcessor.match_faces(draw=False)`` against the site's
gallery, as the camera manager's results loop does.  A frame's latency runs
from the client's ``submit`` to the return of its ``match_faces``.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, data
from .reference.pipeline import Reference, canvas_of

COMPANY = "site"


@dataclass
class Frame:
    """One submitted frame and what came back."""

    client: int
    pool_index: int
    t_submit: float
    keep: bool = False   # its faces and decisions are kept for the check
    t_done: float = 0.0
    match_s: float = 0.0
    n_faces: int = 0
    faces: list = field(default_factory=list)
    results: list = field(default_factory=list)
    failed: bool = False


def thread_keys() -> tuple:
    """The ids a trace may give the calling thread: its native id, and its
    pthread id whole and in its low 32 bits (signed or not)."""
    ident = threading.get_ident()
    low = ident & 0xFFFFFFFF
    return (threading.get_native_id(), ident, low, low - (1 << 32) if low >= 1 << 31 else low)


def note_role(roles: dict, role: str) -> None:
    for key in thread_keys():
        roles[key] = role


class Logged:
    """The facade as the batcher sees it: each dispatch is logged as [host
    clock on entry, frames, faces] from inside the port's device gate, so
    that a dispatch's log entry and its device work fall on the same side
    of a trace's start or stop (its faces are counted when it resolves);
    the threads are logged by role."""

    def __init__(self, app, roles: dict):
        self.app = app
        self.roles = roles
        self.dispatches: list = []

    @property
    def device(self):
        return self.app.device

    def get_batch_async(self, frames: list):
        from facerecognition_infrenceengine_tpu_torch.core import metrics

        note_role(self.roles, "dispatch")
        with metrics.device_work():
            entry = [time.perf_counter(), len(frames), 0]
            self.dispatches.append(entry)
            resolve = self.app.get_batch_async(frames)

        def logged():
            note_role(self.roles, "resolve")
            per_frame = resolve()
            entry[2] = sum(len(faces) for faces in per_frame)
            return per_frame

        return logged


def engine_config(config: dict, traffic: dict, overrides: dict | None = None):
    from facerecognition_infrenceengine_tpu_torch.core.config import (
        Config, DBConfig, EngineConfig, ThresholdConfig)

    b = traffic["batcher"]
    eng = dict(det_size=tuple(config["canvas"]), max_faces=config["max_faces"],
               pre_nms_topk=config["pre_nms_topk"], nms_iou=config["nms_iou"],
               embed_size=config["embed_size"], dtype=config["dtype"],
               microbatch_max=b["microbatch_max"], microbatch_window_ms=b["microbatch_window_ms"],
               inflight_batches=b["inflight_batches"], frame_queue_depth=b["frame_queue_depth"],
               stream_profile=b["stream_profile"], **traffic["engine"])
    eng.update(overrides or {})
    return Config(db=DBConfig(mongodb_uri="memory://", persist_dir=""),
                  thresholds=ThresholdConfig(detection=config["det_thresh"],
                                             recognition=traffic["recognition_threshold"]),
                  engine=EngineConfig(**eng))


def full_detector(config: dict, traffic: dict, seed: int, pool: np.ndarray, device) -> tuple:
    """The detector's leaves drawn from the seed, redrawn until the
    reference finds ``max_faces`` faces on every frame of the pool and the
    draw is no more sensitive to rounding than most: most random draws fill
    every slot, some leave a few frames short and a few most of every frame;
    and on some draws rounding the activations to bfloat16 moves the boxes
    ten times what rounding the weights alone moves, so that a sound bf16
    port reads past the limits.  Either would change the work from seed to
    seed.  The rounding is read by the bf16 witness (``check.
    conditioning``), against the traffic's ``detector_draw`` limits.
    -> (leaves, draws taken, seconds of the reference's counting, the
    accepted draw's two conditioning readings)."""
    canvases = np.stack([canvas_of(f, config["canvas"], traffic["transport"]) for f in pool])
    rule = traffic["detector_draw"]
    plain = dict(config, attribute_heads=None)
    counting = 0.0
    for draw in range(rule["tries"]):
        det = data.detector_weights(config, seed, device, draw)
        t = time.perf_counter()
        ref = Reference(plain, det, None, device)
        blocks = [canvases[i:i + 16] for i in range(0, len(canvases), 16)]
        found = [ref.detect(b) for b in blocks]
        cond = (float("inf"), float("inf"))
        if all(f["valid"].all() for f in found):
            witness = Reference(plain, det, None, device, bf16=True)
            cond = check.conditioning(found, [ref.detect_probe(b) for b in blocks],
                                      [witness.detect(b) for b in blocks],
                                      config["det_thresh"], config["max_faces"])
            del witness
        del ref, found
        counting += time.perf_counter() - t
        if cond[0] <= rule["witness_gap_rel"] and cond[1] <= rule["witness_gap_max_rel"]:
            return det, draw + 1, counting, cond
    raise RuntimeError(f"no detector draw in {rule['tries']} fills every frame's "
                       f"{config['max_faces']} slots within the rounding limits")


def enrol(config: dict, traffic: dict, det: dict, rec: dict, pool: np.ndarray,
          device) -> np.ndarray:
    """The reference's unit embeddings of the faces it finds in the first
    ``enrolled_frames`` frames of the pool, one row a distinct face: faces
    whose embeddings lie within ``enrol_min_distance`` (1 - cos) of one
    already taken are left out, so no two persons are near ties."""
    g = traffic["gallery"]
    ref = Reference(config, det, rec, device)
    canvases = np.stack([canvas_of(f, config["canvas"], traffic["transport"])
                         for f in pool[:g["enrolled_frames"]]])
    found = ref.detect(canvases)
    idx, kps = np.nonzero(found["valid"])[0], found["kps"][found["valid"]]
    vecs = ref.embed(canvases, idx.astype(np.int64), kps)
    del ref
    taken: list = []
    for v in vecs:
        if not taken or (1.0 - np.max(np.stack(taken) @ v)) > g["enrol_min_distance"]:
            taken.append(v)
    return np.stack(taken).astype(np.float32)


class Site:
    """The port's serving objects for one run."""

    def __init__(self, config: dict, traffic: dict, det: dict, rec: dict, ids: list,
                 matrix: np.ndarray, device, overrides: dict | None = None):
        from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
        from facerecognition_infrenceengine_tpu_torch.engine.microbatch import MicroBatcher
        from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
        from facerecognition_infrenceengine_tpu_torch.engine.recognizer import (
            FaceRecognitionProcessor)
        from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis
        from facerecognition_infrenceengine_tpu_torch.store import Datastore

        self.cfg = engine_config(config, traffic, overrides)
        engine = FaceEngine(self.cfg.engine, det_variables=data.nested(det),
                            rec_variables=data.nested(rec), det_arch=config["detector"]["arch"],
                            rec_arch=config["recognizer"]["arch"], device=device)
        self.app = FaceAnalysis(config["pack"], cfg=self.cfg.engine, engine=engine,
                                allowed_modules=tuple(config["modules"]), device=device)
        self.app.prepare(ctx_id=0, det_thresh=self.cfg.thresholds.detection)
        self.gallery = GalleryManager(Datastore(self.cfg), self.cfg, initial_load=False,
                                      device=device)
        meta = {pid: {"type": "employee", "name": pid, "employeeId": pid} for pid in ids}
        self.snapshot = self.gallery.set_snapshot(ids, meta, matrix, company_id=COMPANY)
        self.proc = FaceRecognitionProcessor(self.gallery, face_app=self.app, cfg=self.cfg)
        self.roles: dict = {}
        self.logged = Logged(self.app, self.roles)
        self.batcher = MicroBatcher(self.logged, self.cfg.engine)
        self.prepare = self.app.encode_frame if traffic["prepare_on_client"] else None

    def warm(self, pool: np.ndarray, microbatch_max: int, max_faces: int) -> None:
        """Every batch shape the batcher can dispatch, twice, each frame's
        decisions included: the cuDNN plans, the kernels' first launches
        and the gallery's first match happen here, not in the window.  A
        batch of n frames runs the detector at ``bucket(n)`` canvases and
        the embedder at ``bucket(faces)`` crops, so the largest n of each
        distinct pair is served (for 32 of 32 faces: 1, 2, 4, 8, 16, 24
        and 32 frames; 24 is the 768-crop embedder)."""
        for n in warm_sizes(microbatch_max, max_faces):
            for _ in range(2):
                frames = [self.prepare(f) if self.prepare else f for f in pool[:n]]
                for f, faces in zip(pool[:n], self.app.get_batch_async(frames)()):
                    self.proc.match_faces(f, faces, COMPANY, draw=False)
        if torch.device(self.app.device).type == "cuda":
            torch.cuda.synchronize()


def warm_sizes(microbatch_max: int, max_faces: int) -> list:
    """The largest batch of each distinct (canvases, crops) shape pair the
    port's batch buckets give n <= ``microbatch_max`` frames of
    ``max_faces`` faces."""
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import bucket

    largest = {}
    for n in range(1, microbatch_max + 1):
        largest[(bucket(n), bucket(n * max_faces))] = n
    return sorted(largest.values())


class Loop:
    """The closed loop: the cameras, the batcher, one results thread.

    Each camera keeps one frame outstanding: its thread submits the next
    frame when the decisions for the previous one are out.  A camera has a
    thread of its own, as the server's capture threads do: with
    ``upload_on_submit`` the encode and upload run there."""

    def __init__(self, site: Site, pool: np.ndarray, orders: np.ndarray, seed: int,
                 keep_one_in: int):
        self.site, self.pool, self.orders = site, pool, orders
        self.seed, self.keep_one_in = int(seed), int(keep_one_in)
        self.submitted: list = []
        self.frames: list = []
        self.matches: list = []  # (host clock on entry, faces), as Logged's
        self.stop = threading.Event()
        self.results: queue.Queue = queue.Queue()
        self.inbox = [queue.Queue() for _ in range(len(orders))]
        self.sent = [0] * len(orders)
        self.resolved = 0
        self.clients = [threading.Thread(target=self._client, args=(c,), daemon=True,
                                         name=f"portbench-client-{c}")
                        for c in range(len(orders))]
        self.decider = threading.Thread(target=self._decide, daemon=True,
                                        name="portbench-results")

    def _kept(self, c: int, i: int) -> bool:
        """One submission in ``keep_one_in``, drawn from the seed, keeps its
        outputs for the check; the others keep their times and face counts
        only (holding every frame's faces would grow the heap the
        collector walks all through the window)."""
        h = (c * 1_000_003 + i) * 2_654_435_761 + self.seed * 97
        return (h >> 7) % self.keep_one_in == 0

    def _submit(self, c: int) -> None:
        i = self.sent[c]
        self.sent[c] += 1
        idx = int(self.orders[c][i % len(self.orders[c])])
        rec = Frame(c, idx, time.perf_counter(), keep=self._kept(c, i))
        self.submitted.append(rec)
        fut = self.site.batcher.submit(c, self.pool[idx], self.site.prepare)
        fut.add_done_callback(lambda f, rec=rec: self.results.put((rec, f)))

    def _client(self, c: int) -> None:
        note_role(self.site.roles, "client")
        self._submit(c)
        while self.inbox[c].get() is not None:
            if not self.stop.is_set():
                self._submit(c)

    def _decide(self) -> None:
        from facerecognition_infrenceengine_tpu_torch.core import metrics
        from facerecognition_infrenceengine_tpu_torch.core.device import bind_thread

        bind_thread(self.site.app.device)
        note_role(self.site.roles, "results")
        while True:
            item = self.results.get()
            if item is None:
                return
            rec, fut = item
            try:
                if getattr(fut, "dropped", False):
                    raise RuntimeError("frame dropped")
                faces = fut.result()
                with metrics.device_work():
                    t0 = time.perf_counter()
                    self.matches.append((t0, len(faces)))
                    _, results = self.site.proc.match_faces(self.pool[rec.pool_index], faces,
                                                            COMPANY, draw=False)
                rec.t_done = time.perf_counter()
                rec.match_s, rec.n_faces = rec.t_done - t0, len(faces)
                if rec.keep:
                    rec.faces, rec.results = faces, results
            except Exception:  # counted as failed; the loop keeps serving
                rec.failed = True
                rec.t_done = time.perf_counter()
            self.frames.append(rec)
            self.resolved += 1
            self.inbox[rec.client].put(rec.client)

    def start(self) -> None:
        self.site.batcher.start()
        self.decider.start()
        for t in self.clients:
            t.start()

    def close(self, timeout_s: float = 60.0) -> None:
        """Stop submitting, wait for every outstanding frame's decisions,
        then stop the batcher, the clients and the results thread."""
        self.stop.set()
        deadline = time.perf_counter() + timeout_s
        while self.resolved < len(self.submitted) and time.perf_counter() < deadline:
            time.sleep(0.005)
        self.site.batcher.stop()
        for box in self.inbox:
            box.put(None)
        for t in self.clients:
            t.join(timeout=5.0)
        self.results.put(None)
        self.decider.join(timeout=30.0)


def timer_totals() -> dict:
    """(count, total seconds) of the batcher's two timers, and (frames, 0)
    of its frames counter."""
    from facerecognition_infrenceengine_tpu_torch.core import metrics

    snap = metrics.snapshot()
    out = {"microbatch.frames": (snap["counters"].get("microbatch.frames", 0), 0.0)}
    for name in ("microbatch.dispatch", "microbatch.resolve"):
        t = snap["timers"].get(name, {"count": 0})
        out[name] = (t["count"], t.get("mean_ms", 0.0) * t["count"] / 1e3)
    return out


def traced_span(seconds: float, logdir: str) -> tuple:
    """Trace ``seconds`` of serving through the port's device gate into
    ``logdir`` -> host clock (before the start was asked, after it
    returned, before the stop was asked, after it returned): a logged
    dispatch or match that entered the gate between the second and the
    third ran wholly inside the trace; the first and the last bound the
    time the trace held the serving threads up."""
    from facerecognition_infrenceengine_tpu_torch.core import metrics

    a = time.perf_counter()
    metrics.start_device_trace(logdir)
    h0 = time.perf_counter()
    time.sleep(seconds)
    h1 = time.perf_counter()
    metrics.stop_device_trace()
    return a, h0, h1, time.perf_counter()

