"""``card_s_per_msite`` (device trace): the seconds in which a kernel,
copy or set ran on the card during the window, per million of the
window's sites: the card time that a million calls cost, whatever the
host's pace. Nothing without a device timeline (a traced run reports
per-layer metrics; a run on the CPU has no card)."""


def read(rec: dict):
    busy = rec.get("device_busy_s")
    if not busy or not rec["sites"]:
        return None
    return busy / (rec["sites"] / 1e6)
