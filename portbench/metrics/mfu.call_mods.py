"""``mfu.call_mods`` (device trace): the whole forward's products over
the traced window's sites, at the compute dtype's peak, as a share of
the traced window (lib/flops.py, lib/peaks.py)."""
from portbench.lib.flops import forward_flops_per_site


def read(rec: dict):
    tr = rec["trace"]
    if tr is None or not rec["sites"] or tr["window_s"] <= 0:
        return None
    flops = forward_flops_per_site(rec["config"]) * rec["sites"]
    return 100.0 * flops / rec["peak_flops"] / tr["window_s"]
