"""latency_ms.p95: the 95th percentile of the latencies of all requests
of the window, by nearest rank, in ms. Each is timed on the host from
when the request was due (in a closed loop, when it was sent) to its maps
in hand."""
import math


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the ceil(q/100 * n)-th smallest value."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def read(win):
    if not win.latencies_s:
        return None
    return percentile(win.latencies_s, 95.0) * 1e3
