"""The whole PPO iteration's share (%) of the card's float32 peak: the
rollout's policy forwards, its control steps' dense physics (a lower
bound: roofline.control_step_flops) and the update's operations
(simbench/roofline_train.py::iteration_flops) over the iteration's
device-busy seconds (its rollout steps and its update) and the peak."""
from simbench import roofline, roofline_train


def read(s):
    if s.get("tag") != "train":
        return None
    sh = s["shapes"]
    busy = s["busy_s"] / s["units"]
    return 100.0 * roofline_train.iteration_flops(sh) / (busy * roofline.PEAK_FLOPS[sh["dtype"]])
