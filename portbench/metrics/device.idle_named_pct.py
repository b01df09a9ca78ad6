"""The device: the share of the traced span's idle time put down to a
named span of the port.  Each gap between device ops is spread over the
innermost spans open, during it, on the thread that launched the op ending
it; what no span covers, and the gap after the last op, is not named.  The
attribution by span is logged to standard error."""

from portbench import spans

LAYER = "device"
UNIT = "%"
MOVES = "memory_peak_gib"


def read(run):
    p = spans.traced(run)
    if p is None or run.trace is None:
        return None
    by_span = spans.idle_by_span(run.trace, p)
    total = sum(by_span.values())
    if total <= 0:
        return None
    spans.log_idle(by_span)
    return 100.0 * (total - by_span.get("no span", 0.0) - by_span.get("end", 0.0)) / total
