"""One pair a request through
``adcensus_torch.parallel.serve.ShardedMatcher``: numpy images in on rank
0 (this process, on the harness's card), the numpy disparity map out, the
volume sharded over the ranks of the cell's cards. ``entry_args`` are
the matcher's keyword arguments (``world``, ``volume_axis``,
``cross_backend``). The matcher starts its worker ranks in ``make`` and
stops them in ``close``; ``peak_bytes`` reads each card's peak."""
INPUTS = "stacks"


def make(device, opts, **entry_args):
    from adcensus_torch.parallel.serve import ShardedMatcher

    matcher = ShardedMatcher(opts, device=device, **entry_args)

    def call(lefts, rights):
        if len(lefts) != 1:
            raise ValueError("match_sharded takes one pair a request")
        return matcher.match(lefts[0], rights[0])[None]

    call.matcher = matcher
    return call


def peak_bytes(call):
    return call.matcher.peak_bytes()


def close(call):
    call.matcher.close()
