"""``setup_s`` (host clock): from the process's start to the window's
start: imports, the card, weights, the input, the entry's build (and,
in a checkout's first run, the kernels' compilation) and the warm-up
pass."""


def read(rec: dict):
    return rec["setup_s"]
