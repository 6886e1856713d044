"""``wire_bytes_per_site`` (program counter): bytes of every array the
engine uploaded, over the sites (CallStats ``wire_bytes`` over
``sites``)."""


def read(rec: dict):
    st = rec["stats"]
    if not st.get("sites") or not st.get("wire_bytes"):
        return None
    return st["wire_bytes"] / st["sites"]
