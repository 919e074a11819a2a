"""Run-time support of the entry points: the CUDA graphs of the multi-pair
pipelines, and per-stage timing."""
