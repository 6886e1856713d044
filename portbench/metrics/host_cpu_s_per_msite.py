"""``host_cpu_s_per_msite`` (host clock): the CPU seconds, user and
system, of the benchmark's process and of every child process it
reaped during the window (``os.times``; a fast5 pass's extraction
workers, whose pool shuts down inside the pass), per million of the
window's sites: the host's cores a million calls cost, whatever the
card's pace."""


def read(rec: dict):
    if not rec["sites"]:
        return None
    return (rec["cpu_s"] + rec["children_cpu_s"]) / (rec["sites"] / 1e6)
