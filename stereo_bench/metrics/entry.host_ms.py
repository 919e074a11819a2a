"""entry.host_ms: the host's exposed ms a pair: the time a pair takes in
the unprofiled stretch less the device's busy time a pair in the
profiled one. It is what the request spends with no operation on the
device: issuing ops, copying on the host, waiting in Python; the host's
work that overlaps the device's is not in it."""


def read(trace):
    if trace.pairs == 0 or trace.plain_s_a_pair <= 0 or not trace.device_ops:
        return None
    return (trace.plain_s_a_pair - trace.busy_s() / trace.pairs) * 1e3
