"""``parse_wait_share.call_mods`` (program counter): the share of the
passes' seconds that the engine's main thread waited for parsed or
loaded input blocks (CallStats ``parse_wait_seconds`` over ``seconds``,
summed over the window's passes)."""


def read(rec: dict):
    st = rec["stats"]
    if not st.get("seconds"):
        return None
    return 100.0 * st.get("parse_wait_seconds", 0.0) / st["seconds"]
