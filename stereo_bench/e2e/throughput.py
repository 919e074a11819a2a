"""throughput: H * W * D summed over the pairs the window completed, over
the seconds in which a request was out (from its sending to its maps in
hand, summed), in millions (Mpixd/s). The harness's own time making each
request's inputs, and in an open loop its waits for a due time, are not
in it."""


def read(win):
    busy = sum(win.service_s)
    if win.pairs == 0 or busy <= 0:
        return None
    return win.work / busy / 1e6
