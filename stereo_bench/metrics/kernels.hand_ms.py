"""kernels.hand_ms: device ms a pair in the hand-written kernels, named in
hand_kernels.json, their durations summed."""


def read(trace):
    ks = [(s, e) for s, e, n in trace.kernels() if trace.kernel_id(n)]
    if not ks or trace.pairs == 0:
        return None
    return sum(e - s for s, e in ks) / 1e3 / trace.pairs
