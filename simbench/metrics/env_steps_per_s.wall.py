"""env-steps per second of wall time, as RL code stepping the batch sees
it: all the env-steps of the run's unprofiled window over all its time,
after a final synchronise. Wall time is at least the device's busy time,
so this is at most env_steps_per_device_s; the gap is the host's (launches
issued one by one), and it moves with how fast the host's core runs."""


def read(s):
    if s.get("tag") != "sim":
        return None
    return s["shapes"]["B"] / s["wall_s_per_unit"]
