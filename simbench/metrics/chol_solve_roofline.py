"""Kernel A's share (%) of its roofline: the least time the SPD factor +
solves of a step_autoreset need on the card (simbench/roofline.py, counted
from the cell's shapes: per control step and substep one solve at m = 1
with the diagonal shift and one at m = 1 + rows, n = nv, the batch), over
the device time of the kernels that implement them (kernels/chol_solve/).
Nothing when no such kernel ran."""
from simbench import roofline, trace


def read(s):
    if s.get("tag") != "sim":
        return None
    ops = trace.select(s["device_ops"], "chol_solve")
    dev_s = sum(v[0] for v in ops.values()) / s["units"]
    if dev_s <= 0:
        return None
    sh = s["shapes"]
    bound = sh["control_steps_per_unit"] * roofline.control_step_solve_bound_s(
        sh["B"], sh["nv"], sh["rows"], sh["substeps"], sh["dtype"], sh["itemsize"])
    return 100.0 * bound / dev_s
