"""Host (B, H, W, 3) stacks a request through
``adcensus_torch.stages.pipeline.match_batched_device`` (CUDA graphs of
a group each, the group by the default rule unless ``entry_args`` gives
one), the (B, H, W) disparities copied to the host. ``entry_args`` are
the entry's keyword arguments (``group``, ``cross_backend``,
``agg_impl``)."""
INPUTS = "stacks"


def make(device, opts, **entry_args):
    from adcensus_torch.stages import pipeline

    def call(lefts, rights):
        return pipeline.match_batched_device(
            lefts, rights, opts, device=device, **entry_args).cpu().numpy()

    return call
