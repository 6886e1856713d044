"""``emit_share.call_mods`` (program counter): the share of the passes'
seconds that the engine's main thread spent emitting and queueing rows
(CallStats ``format_seconds`` over ``seconds``)."""


def read(rec: dict):
    st = rec["stats"]
    if not st.get("seconds"):
        return None
    return 100.0 * st.get("format_seconds", 0.0) / st["seconds"]
