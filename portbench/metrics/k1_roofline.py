"""``k1_roofline`` (device trace): the least time of the forward's five
LSTM layers over the traced window's sites and forward tiles (products
at the compute dtype's peak or bytes at the memory rate, the longer,
a layer; lib/flops.py), over the device time of the kernels of group
``k1`` (``kernels/*.json``) in the trace. Nothing when no K1 kernel
ran."""
from portbench.lib.flops import lstm_bound_seconds


def read(rec: dict):
    tr = rec["trace"]
    if tr is None:
        return None
    k1 = tr["groups_s"].get("k1", 0.0)
    if k1 <= 0 or not rec["sites"]:
        return None
    bound = lstm_bound_seconds(rec["config"], rec["sites"],
                               int(rec["stats"].get("forward_tiles", 0)),
                               rec["itemsize"], rec["peak_flops"],
                               rec["peak_bytes"])
    return 100.0 * bound / k1
