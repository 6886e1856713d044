"""``extract_cpu_s_per_msite`` (host clock): the CPU seconds, user and
system, of the child processes reaped during the window (``os.times``:
a fast5 pass's extraction workers, pipeline/extract.py, reading,
decompressing and extracting the fast5s), per million of the window's
sites. Nothing where no child was reaped."""


def read(rec: dict):
    if not rec["sites"] or rec["children_cpu_s"] <= 0:
        return None
    return rec["children_cpu_s"] / (rec["sites"] / 1e6)
