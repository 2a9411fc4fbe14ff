"""Share (%) of a PPO iteration's wall time in which the device ran
nothing: 1 - the traced iteration's device-busy seconds over the wall
seconds per iteration of the same run's unprofiled window."""


def read(s):
    if s.get("tag") != "train":
        return None
    return 100.0 * (1.0 - (s["busy_s"] / s["units"]) / s["wall_s_per_unit"])
