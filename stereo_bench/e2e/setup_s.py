"""setup_s: seconds from the start of the process to the first timed
request: imports, the card's context, the kernels' build or load, the
pool of pairs and the warm-up requests (with a graph's capture)."""


def read(win):
    return win.setup_s
