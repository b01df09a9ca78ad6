"""A run of one cell, from the seed to the result line.

Set-up (``setup_s``: from the process's start to the window's, less the
reference's work): the frame pool, the weights and the gallery from the
seed, the detector redrawn until the reference finds a full frame of faces
on every frame of the pool, and the enrolled persons' vectors, which the
reference makes (the reference's counting and enrolment are timed apart
and left out of ``setup_s``: no change to the port can move them);
the port's engine, facade, gallery snapshot, recognizer and batcher; every
batch shape the cell can dispatch, warmed; the clients started and the
loop ramped up.  Then the window of
``--seconds``, traced in its middle with ``--trace 1``; then the loop is
drained, the peak memory read, the port's objects freed, and the sample of
the window's frames judged by the reference.
"""

from __future__ import annotations

import gc
import math
import subprocess
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check, count, data, serve, spec, trace
from .reference.pipeline import Reference


def _p(values: list, q: float) -> float:
    """Nearest-rank percentile (an unanswered frame counts as infinite)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)] if v else float("nan")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def prepare_data(config: dict, traffic: dict, seed: int, device) -> SimpleNamespace:
    """What the run serves: weights, frames, enrolled vectors, gallery."""
    at = [time.perf_counter()]

    def lap():
        at.append(time.perf_counter())
        return at[-1] - at[-2]

    h, w = traffic["frame"]
    pool = data.camera_frames(traffic["pool_frames"], h, w, seed, device)
    phases = {"frames": lap()}
    det, draws, counting, cond = serve.full_detector(config, traffic, seed, pool, device)
    rec = data.embedder_weights(config, seed, device)
    phases["weights"] = lap() - counting
    phases["faces"] = counting
    enrolled = serve.enrol(config, traffic, det, rec, pool, device)
    phases["enrol"] = lap()
    g = traffic["gallery"]
    matrix = np.concatenate([enrolled, data.distractors(g["persons"] - len(enrolled),
                                                        config["embed_dim"], seed, device)])
    ids = [f"person-{k:06d}" for k in range(len(matrix))]
    orders = data.client_orders(seed, traffic["clients"], len(pool))
    phases["gallery"] = lap()
    return SimpleNamespace(det=det, rec=rec, pool=pool, enrolled=len(enrolled), matrix=matrix,
                           ids=ids, orders=orders, phases=phases, seed=seed, draws=draws,
                           conditioning=cond)


def serve_window(cell: dict, d: SimpleNamespace, seconds: float, traced: bool, device,
                 t_start: float, overrides: dict | None = None) -> SimpleNamespace:
    """Set up the port, run the window, drain; returns what was measured."""
    config, traffic = cell["config"], cell["traffic"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    site = serve.Site(config, traffic, d.det, d.rec, d.ids, d.matrix, device, overrides)
    phases = {"port": time.perf_counter() - t}
    t = time.perf_counter()
    site.warm(d.pool, traffic["batcher"]["microbatch_max"], config["max_faces"])
    phases["warm"] = time.perf_counter() - t
    loop = serve.Loop(site, d.pool, d.orders, d.seed, traffic["keep_one_in"])
    loop.start()
    ramp_deadline = time.perf_counter() + traffic["ramp_timeout_s"]
    while loop.resolved < traffic["ramp_frames"] and time.perf_counter() < ramp_deadline:
        time.sleep(0.01)
    gc.collect()
    gc.freeze()  # set-up's objects (the gallery's metadata, weights) leave the collector's walks
    t0 = time.perf_counter()
    phases["ramp"] = t0 - t - phases["warm"]
    setup_s = t0 - t_start - d.phases["faces"] - d.phases["enrol"]
    timers0 = serve.timer_totals()
    tr, held = None, None
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as logdir:
        if traced:
            span = min(traffic["trace_seconds"], seconds)
            time.sleep(max(0.0, (seconds - span) / 2))
            held = serve.traced_span(span, logdir)
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        t1 = time.perf_counter()
        timers1 = serve.timer_totals()
        loop.close(traffic["drain_timeout_s"])
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if traced:
            tr = trace.read_dir(logdir)
    h0, h1 = (held[1], held[2]) if held else (None, None)
    out = SimpleNamespace(t0=t0, t1=t1, setup_s=setup_s, phases=phases, trace=tr, h0=h0,
                          h1=h1, held=held, peak=peak, submitted=list(loop.submitted),
                          timers={k: (timers1[k][0] - timers0[k][0], timers1[k][1] - timers0[k][1])
                                  for k in timers1},
                          rows=d.matrix.shape[0], roles=dict(site.roles),
                          dispatches=list(site.logged.dispatches), matches=list(loop.matches))
    del loop, site
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def end_to_end(w: SimpleNamespace) -> SimpleNamespace:
    window_s = w.t1 - w.t0
    done = [f for f in w.submitted if f.t_done and not f.failed]
    in_window = [f for f in done if w.t0 <= f.t_done <= w.t1]
    sent = [f for f in w.submitted if w.t0 <= f.t_submit < w.t1]
    lat = [(f.t_done - f.t_submit) * 1e3 if f.t_done and not f.failed else math.inf
           for f in sent]
    return SimpleNamespace(window_s=window_s, in_window=in_window, sent=sent, latencies=lat,
                           faces=sum(f.n_faces for f in in_window),
                           failed=sum(1 for x in lat if not math.isfinite(x)))


def judged_sample(sent: list, seed: int, n: int) -> list:
    """The frames to judge: ``n`` of the window's answered frames that kept
    their outputs (one in ``keep_one_in``, drawn from the seed), drawn from
    the seed."""
    answered = [f for f in sent if f.t_done and not f.failed and f.keep]
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(len(answered), size=min(n, len(answered)), replace=False)
    return [answered[i] for i in sorted(pick)]


def site_gallery(cell: dict, d: SimpleNamespace, dtype: str | None = None) -> check.Gallery:
    """The site's gallery as the reference scores it (``dtype``: as the
    port stores it, unless another is asked for)."""
    traffic = cell["traffic"]
    dtype = dtype or traffic["engine"].get("gallery_dtype", "float32")
    return check.Gallery(d.ids, d.matrix, dtype, traffic["gallery"]["int8_headroom"])


def served(sample: list) -> list:
    """The sample as judged: (pool index, faces, decisions) a frame."""
    return [(f.pool_index, check.faces_of(f.faces), check.decisions_of(f.results))
            for f in sample]


def judge_port(cell: dict, d: SimpleNamespace, sample: list, device, extra=None) -> dict:
    """{set: {number: widest value}}: the port's sample ("port") and any
    ``extra`` sets over the same frames."""
    ref = Reference(cell["config"], d.det, d.rec, device)
    sets = {"port": served(sample), **(extra or {})}
    return check.judge(ref, site_gallery(cell, d), cell["config"], cell["traffic"], d.pool, sets)


def layer_run(cell: dict, w: SimpleNamespace, e: SimpleNamespace) -> SimpleNamespace:
    """What the per-layer readers read: the window's frames, timers and
    decision times; with a trace, the trace and the dispatches (frames and
    faces each) and decisions (faces each) whose device work lies inside
    it."""
    def inside(log, at=1):
        return [e[at] for e in log if w.h0 <= e[0] <= w.h1] if w.trace is not None else []

    held = w.held or (0.0, 0.0, 0.0, 0.0)
    clear = [(f.t_done - f.t_submit) * 1e3 if f.t_done and not f.failed else math.inf
             for f in e.sent if f.t_done < held[0] or f.t_submit > held[3]]
    return SimpleNamespace(config=cell["config"], traffic=cell["traffic"], window_s=e.window_s,
                           frames=e.in_window, timers=w.timers, latencies=clear,
                           clear_frames=[f for f in e.in_window
                                         if not held[0] <= f.t_done <= held[3]],
                           clear_s=e.window_s - (held[3] - held[0]),
                           match_s=[f.match_s for f in e.in_window], trace=w.trace,
                           traced_dispatches=inside(w.dispatches),
                           traced_faces=inside(w.dispatches, 2),
                           traced_matches=inside(w.matches), gallery_rows=w.rows,
                           flops=count.frame_flops(cell["config"]))


def breakdown(tr, roles: dict) -> dict:
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_gaps(tr.roles(roles)).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:160], us / 1e6] for name, us in ops],
            "idle_gaps": [[label, s] for label, s in gaps]}


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
             log=print) -> dict:
    """The result object of one run; ``log`` takes the lines for standard
    error, the compared numbers last."""
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    d = prepare_data(config, traffic, seed, dev)
    w = serve_window(cell, d, seconds, traced, dev, t_start)
    e = end_to_end(w)
    finite = [x for x in e.latencies if math.isfinite(x)]
    log("set-up s: " + ", ".join(f"{k} {v:.2f}" for k, v in {**d.phases, **w.phases}.items())
        + f"; setup_s {w.setup_s:.2f} (the total less faces and enrol); detector draws "
        f"{d.draws}, its bf16 witness's gaps {d.conditioning[0]:.3f} (median), "
        f"{d.conditioning[1]:.3f} (widest)")
    (n, dispatch_s), (n_r, resolve_s) = (w.timers["microbatch.dispatch"],
                                         w.timers["microbatch.resolve"])
    log(f"frames submitted in the window {len(e.sent)}, answered {len(finite)}; latency "
        f"median {_p(finite, 50):.3f} ms, p95 {_p(e.latencies, 95):.3f} ms; faces resolved "
        f"{e.faces} in {e.window_s:.3f} s; enrolled {d.enrolled} of {len(d.ids)} persons; "
        f"{n} dispatches of {w.timers['microbatch.frames'][0] / max(1, n):.2f} frames, "
        f"dispatch {1e3 * dispatch_s / max(1, n):.1f} ms, "
        f"resolve {1e3 * resolve_s / max(1, n_r):.1f} ms")
    if dev.type == "cuda":
        log(f"card {power_limit()}")
    log(f"faces_per_s {e.faces / e.window_s:.4f} (per layer as faces_per_s.host)")
    values = {"setup_s": w.setup_s}
    if w.peak:  # the card's allocator high-water mark; a CPU run has none
        values["memory_peak_gib"] = w.peak / 2**30
    metrics = {}
    if traced:
        by_thread: dict = {}
        roles = w.trace.roles(w.roles)
        for *_, tid in w.trace.ops:
            key = roles.get(tid, "other") + ("" if tid in w.roles else " (inferred)")
            by_thread[key] = by_thread.get(key, 0) + 1
        log(f"traced {w.trace.window_s:.3f} s: device busy {w.trace.busy_s:.3f} s, "
            f"device ops by launching thread {by_thread}")
        run = layer_run(cell, w, e)
        for m in cell["per_layer"]:
            v = spec.reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    sample = judged_sample(e.sent, seed, traffic["check_frames"])
    t = time.perf_counter()
    nums = judge_port(cell, d, sample, dev)["port"]
    log(f"reference check {time.perf_counter() - t:.2f} s")
    ok, compared = check.verdict(nums, cell["limits"])
    ok = ok and e.failed == 0 and len(sample) > 0
    result = {"correct": bool(ok), "attempted": len(e.sent), "failed": e.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(w.peak)}}
    if traced:
        result["device"].update(busy_s=w.trace.busy_s, window_s=w.trace.window_s)
        result["breakdown"] = breakdown(w.trace, w.roles)
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in compared.items()}
    log(f"judged {len(sample)} frames, {sum(len(f.faces) for f in sample)} faces")
    for name, (v, lim) in compared.items():
        log(f"check {name} {v!r} <= {lim!r} {'ok' if np.isfinite(v) and v <= lim else 'FAIL'}")
    return result
