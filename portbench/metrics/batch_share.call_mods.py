"""``batch_share.call_mods`` (program counter): the share of the passes'
seconds that the engine's main thread spent assembling batches and
units, its waits for input blocks excluded (CallStats ``batch_seconds``
over ``seconds``, summed over the window's passes). None where the
program's ``batch_seconds`` still holds those waits (no ``unfed_seconds``
beside it)."""


def read(rec: dict):
    st = rec["stats"]
    if not st.get("seconds") or "unfed_seconds" not in st:
        return None
    return 100.0 * st["batch_seconds"] / st["seconds"]
