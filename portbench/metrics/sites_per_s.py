"""``sites_per_s`` (host clock): the window's sites over its seconds,
every pass whole."""


def read(rec: dict):
    return rec["sites"] / rec["window_s"] if rec["window_s"] > 0 else None
