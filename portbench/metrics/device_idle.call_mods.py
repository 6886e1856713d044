"""``device_idle.call_mods`` (device trace): the share of the traced
window in which no kernel, copy or set ran on the card."""


def read(rec: dict):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
