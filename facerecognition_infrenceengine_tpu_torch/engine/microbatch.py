"""Dynamic micro-batcher: many camera streams, one device pipeline.

The port's copy of ``facerecognition_infrenceengine_tpu/engine/microbatch.py``.
The upstream service gives each camera its own OS process and ONNX session
(reference infrenceServer.py:565-679).  Here every camera thread submits
frames to a single batcher; a dispatch thread drains the queue, runs ONE
``get_batch_async`` (or ``get_batch``) on the card for the whole batch, and
a resolver thread waits for its results and resolves the per-frame futures.

Backpressure matches the reference's drop-on-full semantics
(infrenceServer.py:594-598): each source key has a bounded slot (depth from
EngineConfig.frame_queue_depth); a newer frame replaces a stale undispatched
one rather than queueing behind it.

The dispatch and resolver threads bind themselves to the face app's CUDA
device when it names one (a thread PyTorch has not seen starts on device 0);
every card-side call of the batch runs on that device's current stream.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict

from ..core import metrics
from ..core.config import EngineConfig, get_config
from ..core.device import bind_thread


def _bind_device(face_app) -> None:
    """Bind the calling thread to the face app's device (its engine's, once
    the engine is built)."""
    bind_thread(getattr(face_app, "device", None))


class MicroBatcher:
    def __init__(self, face_app, cfg: EngineConfig | None = None):
        """face_app: anything with get_batch(frames) -> list[list[Face]]."""
        self.face_app = face_app
        self.cfg = cfg or get_config().engine
        self._lock = threading.Lock()
        self._slots: Dict[Any, list] = {}  # source -> [(frame, future), ...]
        self._wakeup = threading.Event()
        self.running = False
        self._thread = None
        self.stats = {"dispatches": 0, "frames": 0, "dropped": 0}
        # Live knobs (start at the configured values; the "auto" profile's
        # controller retunes them while running — see _adapt_step)
        self.depth = max(1, int(self.cfg.frame_queue_depth))
        self.inflight_limit = max(1, int(getattr(self.cfg,
                                                 "inflight_batches", 1)))
        self._inflight_n = 0
        self._inflight_cv = threading.Condition()
        self._adaptive = getattr(self.cfg, "stream_profile",
                                 "static") == "auto"
        self._lat_window: list = []       # submit->resolve seconds
        self._lat_lock = threading.Lock()
        self._adapt_t0 = time.perf_counter()
        self._adapt_prev = None           # last interval's (fps, p50_ms)
        self._adapt_trial = None          # ("depth"|"inflight", old_value)
        self._drops_at_mark = 0
        self.adapt_log: list = []         # (t, p50_ms, fps, depth, inflight)

    def start(self):
        if self.running:
            return
        self.running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self.running = False
        self._wakeup.set()
        if self._thread:
            self._thread.join(timeout=5)
        # Fail open: resolve anything still queued so no waiter blocks
        # forever on a future whose dispatch loop is gone.
        with self._lock:
            pending = [fut for slot in self._slots.values() for _, fut in slot]
            self._slots.clear()
        for fut in pending:
            fut.dropped = True
            fut.set_result([])

    def submit(self, source: Any, frame, prepare=None) -> Future:
        """Queue one frame; returns a Future resolving to list[Face].

        If the per-source slot is full, the OLDEST queued frame is dropped
        (its future gets an empty result) — a live stream must never back up.

        ``prepare`` (optional) is an expensive per-frame transform (wire-
        format encode and/or device upload, models/zoo.encode_frame) run on
        the CALLING thread, outside the batcher lock — N capture threads
        prepare in parallel.  It runs only when the frame is admitted: when
        the slot is full the NEW frame is dropped instead (admission
        control), so a saturated link never pays upload bytes for a frame
        that would immediately be displaced.
        """
        future: Future = Future()
        if not self.running:
            future.dropped = True  # type: ignore[attr-defined]
            future.set_result([])
            return future
        future._t_submit = time.perf_counter()  # type: ignore[attr-defined]
        if prepare is not None:
            with self._lock:
                admitted = (len(self._slots.get(source, ())) < self.depth)
            if not admitted:
                future.dropped = True  # type: ignore[attr-defined]
                future.set_result([])
                self.stats["dropped"] += 1
                metrics.counter("microbatch.dropped").inc()
                return future
            frame = prepare(frame)
        with self._lock:
            slot = self._slots.setdefault(source, [])
            while len(slot) >= self.depth:
                _, stale = slot.pop(0)
                stale.dropped = True  # lets callers tell drops from no-face
                stale.set_result([])
                self.stats["dropped"] += 1
                metrics.counter("microbatch.dropped").inc()
            slot.append((frame, future))
        self._wakeup.set()
        return future

    def process(self, frame) -> list:
        """Synchronous convenience: submit + wait."""
        return self.submit(object(), frame).result()

    def _drain(self) -> list:
        with self._lock:
            batch = []
            # round-robin across sources for fairness
            progressed = True
            while progressed and len(batch) < self.cfg.microbatch_max:
                progressed = False
                for slot in self._slots.values():
                    if slot and len(batch) < self.cfg.microbatch_max:
                        batch.append(slot.pop(0))
                        progressed = True
            # prune drained sources: one-shot keys (process() uses a fresh
            # object() per call) must not accumulate forever
            for key in [k for k, slot in self._slots.items() if not slot]:
                del self._slots[key]
            return batch

    def _dispatch(self, batch):
        """Start one device batch; returns (futures, resolve_fn) or None.
        Uses face_app.get_batch_async when available so the NEXT batch's
        host prep + upload overlaps this batch's device time."""
        frames = [f for f, _ in batch]
        futures = [fut for _, fut in batch]
        try:
            if hasattr(self.face_app, "get_batch_async"):
                resolve = self.face_app.get_batch_async(frames)
            else:
                results = self.face_app.get_batch(frames)
                resolve = lambda: results  # noqa: E731
        except Exception as e:  # propagate to every waiter
            for fut in futures:
                fut.set_exception(e)
            return None
        self.stats["dispatches"] += 1
        self.stats["frames"] += len(frames)
        metrics.counter("microbatch.frames").inc(len(frames))
        metrics.gauge("microbatch.last_batch").set(len(frames))
        return futures, resolve

    def _resolve(self, inflight):
        futures, resolve = inflight
        try:
            results = resolve()
        except Exception as e:
            for fut in futures:
                fut.set_exception(e)
            return
        now = time.perf_counter()
        lats = []
        for fut, faces in zip(futures, results):
            fut.set_result(faces)
            t0 = getattr(fut, "_t_submit", None)
            if t0 is not None:
                lats.append(now - t0)
        if self._adaptive and lats:
            with self._lat_lock:
                self._lat_window.extend(lats)

    def _resolver_loop(self, q):
        """Drain the in-flight queue in FIFO order, blocking on device
        results OFF the dispatch thread: resolving inline would leave the
        dispatch thread idle for each result download, when it could be
        preparing and uploading the next batch."""
        _bind_device(self.face_app)
        while True:
            inflight = q.get()
            if inflight is None:
                return
            with metrics.timer("microbatch.resolve"):
                self._resolve(inflight)
            with self._inflight_cv:
                self._inflight_n -= 1
                self._inflight_cv.notify_all()
            if self._adaptive:
                self._maybe_adapt()

    # ------------------------------------------------- adaptive controller
    def _maybe_adapt(self):
        if (time.perf_counter() - self._adapt_t0
                < getattr(self.cfg, "adapt_interval_s", 2.0)):
            return
        self._adapt_step()

    def _adapt_step(self):
        """One controller step (runs on the resolver thread, so knob writes
        never race the dispatch gate mid-wait).

        Policy: p50 latency in the window ~= (queued frames + batches in
        flight) x batch cycle, so depth/inflight are THE latency knobs.
        Overshoot of target_p50_ms tightens one knob per step (inflight
        first: it costs a whole batch cycle of queueing).  When p50 sits
        comfortably under target while frames are still being dropped,
        throughput might be on the table: loosen one knob as a TRIAL and
        keep it only if the next window shows >=5% more resolved fps at
        acceptable p50 — deeper queues often just add latency, so loosening
        must prove itself."""
        now = time.perf_counter()
        interval = now - self._adapt_t0
        with self._lat_lock:
            lats, self._lat_window = self._lat_window, []
        self._adapt_t0 = now
        drops = self.stats["dropped"] - self._drops_at_mark
        self._drops_at_mark = self.stats["dropped"]
        if len(lats) < 5:
            self._adapt_trial = None
            return
        lats.sort()
        p50 = lats[len(lats) // 2] * 1000.0
        fps = len(lats) / max(interval, 1e-6)
        target = getattr(self.cfg, "target_p50_ms", 300.0)
        drop_rate = drops / max(1, drops + len(lats))

        reverted_trial = False
        if self._adapt_trial is not None:
            knob, old = self._adapt_trial
            self._adapt_trial = None
            prev_fps = self._adapt_prev[0] if self._adapt_prev else 0.0
            if p50 > target or fps < prev_fps * 1.05:
                self._set_knob(knob, old)  # trial didn't pay — revert
                reverted_trial = True
        if reverted_trial:
            # The window's latency was produced BY the trial knob we just
            # undid; tightening a second knob off that evidence would be a
            # double movement (one knob per step) and makes the controller
            # oscillate between over-tight and trial states instead of
            # settling at the pre-trial point.
            pass
        elif p50 > target:
            if self.inflight_limit > 1:
                self._set_knob("inflight", self.inflight_limit - 1)
            elif self.depth > 1:
                self._set_knob("depth", self.depth - 1)
        elif p50 < 0.7 * target and drop_rate > 0.05:
            if self.depth < 4:
                self._adapt_trial = ("depth", self.depth)
                self._set_knob("depth", self.depth + 1)
            elif self.inflight_limit < 2:
                self._adapt_trial = ("inflight", self.inflight_limit)
                self._set_knob("inflight", self.inflight_limit + 1)
        self._adapt_prev = (fps, p50)
        self.adapt_log.append((round(now, 2), round(p50, 1), round(fps, 1),
                               self.depth, self.inflight_limit))
        metrics.gauge("microbatch.depth").set(self.depth)
        metrics.gauge("microbatch.inflight_limit").set(self.inflight_limit)

    def _set_knob(self, knob: str, value: int):
        if knob == "depth":
            self.depth = max(1, int(value))
        else:
            self.inflight_limit = max(1, int(value))
            with self._inflight_cv:
                self._inflight_cv.notify_all()

    def _loop(self):
        # Pipelined dispatch: this thread only drains + preps + uploads;
        # a resolver thread blocks on device results.  Backpressure is the
        # _inflight_cv gate below (at most inflight_limit batches
        # dispatched-but-unresolved — runtime-tunable by the adaptive
        # controller, unlike a queue bound), so uploads never wait on a
        # result download.
        import queue

        _bind_device(self.face_app)

        window_s = self.cfg.microbatch_window_ms / 1000.0
        inflight_q: "queue.Queue" = queue.Queue()
        resolver = threading.Thread(target=self._resolver_loop,
                                    args=(inflight_q,), daemon=True)
        resolver.start()
        try:
            while self.running:
                self._wakeup.wait(timeout=0.05)
                self._wakeup.clear()
                if not self.running:
                    break
                # In-flight gate: at most inflight_limit batches dispatched-
                # but-unresolved beyond the one about to upload.  Waiting
                # BEFORE draining keeps frames in their per-source slots
                # while blocked, where drop-on-full admission still applies
                # (a pre-drained batch would be exempt from backpressure).
                with self._inflight_cv:
                    while (self._inflight_n > self.inflight_limit
                           and self.running):
                        self._inflight_cv.wait(timeout=0.1)
                if not self.running:
                    break
                # small batching window: let concurrent cameras pile in
                deadline = time.perf_counter() + window_s
                while time.perf_counter() < deadline:
                    with self._lock:
                        pending = sum(len(s) for s in self._slots.values())
                    if pending >= self.cfg.microbatch_max:
                        break
                    time.sleep(window_s / 4)
                batch = self._drain()
                if not batch:
                    continue
                with metrics.timer("microbatch.dispatch"):
                    nxt = self._dispatch(batch)
                if nxt is not None:
                    with self._inflight_cv:
                        self._inflight_n += 1
                    inflight_q.put(nxt)
        finally:
            inflight_q.put(None)
            resolver.join(timeout=10)
