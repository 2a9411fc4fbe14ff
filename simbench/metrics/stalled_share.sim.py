"""Share (%) of the window's env-steps in which a substep's contact QP
stopped at its iteration cap short of its tolerance (the env's
info["stalled"], summed on the device over the window)."""


def read(s):
    if s.get("tag") != "sim":
        return None
    return 100.0 * s["counters"]["stalled_share"]
