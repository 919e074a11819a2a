"""device.idle_pct.stream: the share of a one-pair request's time in
which no operation runs on the device, in %: one less the device's busy
time a pair in the profiled stretch over a pair's time, sending to map
in hand, in the unprofiled one.

A one-pair match issues its ops one by one, so the profiler leaves the
device's time a pair as it is and slows only the host (by 1.4 to 1.6
times at Cone size, even recording the device's activity alone): the
profiled stretch's own idle share would read the profiler. Graph
replays (``device.idle_pct.batch``) run more slowly under the profiler,
so they read the profiled stretch alone."""


def read(trace):
    if trace.pairs == 0 or trace.plain_s_a_pair <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.pairs / trace.plain_s_a_pair)
