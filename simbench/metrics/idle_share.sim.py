"""Share (%) of a step_autoreset's wall time in which the device ran
nothing: 1 - device-busy seconds per traced unit over the wall seconds per
unit of the same run's unprofiled window."""


def read(s):
    if s.get("tag") != "sim":
        return None
    return 100.0 * (1.0 - (s["busy_s"] / s["units"]) / s["wall_s_per_unit"])
