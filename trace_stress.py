"""Start and stop device traces while threads serve FaceAnalysis.get on the card.

torch.profiler's CUDA tracing can corrupt the heap when a trace starts or
stops while another thread calls into CUDA; the port's device gate
(``core/metrics.py``) shuts every device entry point while it does.  This
script counts how many trace cycles a process survives with the gate and
with it disabled, each mode in a process of its own (a crash there ends only
that process):

    python3 trace_stress.py [--seconds 240] [--threads 2] [--hold 0.25]
                            [--modes nogate,gate]

Each mode: ``--threads`` threads, each with its own four-module
FaceAnalysis("buffalo_l") (random weights from a seed), run ``get`` on a
seeded 640x480 frame without pause, as the people counter's camera threads
do; the main thread starts a trace through ``metrics.start_device_trace``,
waits ``--hold`` seconds and stops it (the trace is written), until
``--seconds`` have passed.  Prints one line a mode (its exit code or signal,
the cycles it completed, the first fatal line of its errors) and, last, a
JSON object with the same.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np


def child(mode: str, seconds: float, threads: int, hold: float) -> None:
    import contextlib

    import torch
    from facerecognition_infrenceengine_tpu_torch.core import metrics
    from facerecognition_infrenceengine_tpu_torch.core.device import bind_thread
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis

    if mode == "nogate":
        metrics._device_alone = contextlib.nullcontext
    rng = np.random.default_rng(0)
    frame = np.clip(rng.normal(128, 40, (480, 640, 3)), 0, 255).astype(np.uint8)
    apps = [FaceAnalysis("buffalo_l") for _ in range(threads)]
    for app in apps:
        app.prepare(ctx_id=0)
    stop, gets = threading.Event(), [0] * threads

    def serve(i):
        bind_thread(apps[i].device)
        while not stop.is_set():
            apps[i].get(frame)
            gets[i] += 1

    workers = [threading.Thread(target=serve, args=(i,), daemon=True) for i in range(threads)]
    for w in workers:
        w.start()
    time.sleep(2.0)
    t_end = time.perf_counter() + seconds
    cycles = 0
    while time.perf_counter() < t_end:
        logdir = tempfile.mkdtemp(prefix="fre_stress_")
        metrics.start_device_trace(logdir)
        time.sleep(hold)
        metrics.stop_device_trace()
        shutil.rmtree(logdir, ignore_errors=True)
        cycles += 1
        print(f"cycle {cycles}", flush=True)
    stop.set()
    for w in workers:
        w.join(30)
    torch.cuda.synchronize()
    print(f"done {cycles} cycles, {sum(gets)} gets", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--hold", type=float, default=0.25)
    ap.add_argument("--modes", default="nogate,gate")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.seconds, args.threads, args.hold)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("trace_stress: no CUDA device", file=sys.stderr)
        return 2
    from facerecognition_infrenceengine_tpu_torch.kernels import build

    build.lib()
    build.host_lib()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    results = []
    for mode in args.modes.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", mode,
             "--seconds", str(args.seconds), "--threads", str(args.threads),
             "--hold", str(args.hold)],
            capture_output=True, text=True, timeout=args.seconds + 300)
        lines = proc.stdout.splitlines()
        cycles = sum(1 for line in lines if line.startswith("cycle "))
        rc = proc.returncode
        ended = (f"signal {signal.Signals(-rc).name}" if rc < 0 else f"exit {rc}")
        fatal = next((line for line in proc.stderr.splitlines()
                      if "Fatal" in line or "corruption" in line or "Error" in line), "")
        results.append({"mode": mode, "ended": ended, "cycles": cycles,
                        "completed": any(line.startswith("done ") for line in lines),
                        "seconds": round(time.perf_counter() - t0, 1), "fatal": fatal,
                        "threads": args.threads, "hold_s": args.hold, "card": card})
        print(f"[{mode}] {card} | {ended} after {cycles} trace cycles "
              f"({args.threads} threads serving get, {args.hold} s traced a cycle) "
              f"{fatal}", flush=True)
    print(json.dumps({"trace_stress": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
