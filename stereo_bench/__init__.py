"""The benchmark of ``adcensus_torch``, the PyTorch and CUDA AD-Census
engine: ``python3 stereo_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""
