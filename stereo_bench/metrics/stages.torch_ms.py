"""stages.torch_ms: device ms a pair in kernels that are not hand-written
(PyTorch's own), their durations summed."""


def read(trace):
    ks = [(s, e) for s, e, n in trace.kernels() if trace.kernel_id(n) is None]
    if not ks or trace.pairs == 0:
        return None
    return sum(e - s for s, e in ks) / 1e3 / trace.pairs
