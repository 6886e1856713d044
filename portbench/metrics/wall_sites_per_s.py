"""``wall_sites_per_s`` (host clock): the traced window's sites over its
seconds, every pass whole: ``sites_per_s`` as a per-layer reading, for
cells whose pace the host sets and whose rate repeats too loosely to
bound."""


def read(rec: dict):
    return rec["sites"] / rec["window_s"] if rec["window_s"] > 0 else None
