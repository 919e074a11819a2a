"""One pair a request through ``adcensus_torch.stages.pipeline.match``:
numpy images in, the numpy disparity map out. ``entry_args`` are the
entry's keyword arguments (``gray_mode``, ``cross_backend``,
``agg_impl``)."""
INPUTS = "stacks"


def make(device, opts, **entry_args):
    from adcensus_torch.stages import pipeline

    def call(lefts, rights):
        if len(lefts) != 1:
            raise ValueError("match takes one pair a request")
        return pipeline.match(lefts[0], rights[0], opts, device=device,
                              **entry_args)["disparity"][None]

    return call
