"""The batcher's dispatch thread, a traced batch: the time its
``microbatch.dispatch`` span was not running on a core (wall less the
thread's CPU time: waits for the interpreter lock, preemption), less that
of its ``engine.wait`` spans, which wait for the card."""

from portbench import spans

LAYER = "batcher"
UNIT = "ms"
MOVES = "memory_peak_gib"


def _off(s) -> int:
    return (s.end_ns - s.start_ns) - s.cpu_ns


def read(run):
    p = spans.traced(run)
    bs = spans.batches(p) if p else []
    if not bs:
        return None
    tid = {b.id: b.dispatch.tid for b in bs}
    off = sum(_off(b.dispatch) - sum(_off(s) for s in b.spans
                                     if s.name == "engine.wait" and s.tid == tid[b.id])
              for b in bs)
    return off / len(bs) / 1e6
