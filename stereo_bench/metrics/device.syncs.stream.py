"""device.syncs.stream: host calls a pair that wait on the device
(cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize and
the blocking cudaMemcpy) made inside the program's spans
(stereo_bench/spans.py)."""
from stereo_bench import spans


def read(trace):
    return spans.syncs(trace)
