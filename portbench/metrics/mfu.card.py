"""``mfu.card`` (device trace): the whole forward's products over the
traced window's sites, at the compute dtype's peak, as a share of the
seconds in which the card was busy (lib/flops.py, lib/peaks.py): the
step's share of the chip's peak while it works, which bounds what any
one kernel's roofline can claim of ``card_s_per_msite``."""
from portbench.lib.flops import forward_flops_per_site


def read(rec: dict):
    tr = rec["trace"]
    if tr is None or not rec["sites"] or tr["busy_s"] <= 0:
        return None
    flops = forward_flops_per_site(rec["config"]) * rec["sites"]
    return 100.0 * flops / rec["peak_flops"] / tr["busy_s"]
