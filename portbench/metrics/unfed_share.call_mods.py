"""``unfed_share.call_mods`` (program counter): the share of the passes'
seconds in which the engine had no unit submitted to the card and not
yet waited for (CallStats ``unfed_seconds`` over ``seconds``, summed over
the window's passes): the time the engine gave the card no work. None
where the program has no such counter."""


def read(rec: dict):
    st = rec["stats"]
    if not st.get("seconds") or "unfed_seconds" not in st:
        return None
    return 100.0 * st["unfed_seconds"] / st["seconds"]
