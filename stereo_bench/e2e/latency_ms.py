"""latency_ms: the mean of the latencies of all requests of the window,
in ms: each from when the request was due (in a closed loop, when it was
sent) to its maps in hand. In a closed loop of one pair a request this
is the time a user waits for each pair; the harness's own time making a
request's inputs is not in it."""


def read(win):
    if not win.latencies_s:
        return None
    return sum(win.latencies_s) / len(win.latencies_s) * 1e3
