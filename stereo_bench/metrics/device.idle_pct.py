"""device.idle_pct: the share of the profiled stretch, on the host's
clock from its first request to its last map in hand, in which no
operation ran on the device (the union of kernel, copy and set
intervals), in %: one less ``busy_s`` over ``window_s``."""


def read(trace):
    window = trace.window_s()
    if window <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / window)
