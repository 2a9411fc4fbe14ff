"""The whole step_autoreset's share (%) of the card's float32 peak: the
dense work its control steps need (simbench/roofline.py::
control_step_flops, counted from the cell's shapes whatever implements it:
per substep the inertia, the SPD factor + solves and the Delassus product)
over the device-busy seconds per traced unit and the peak. The work counted
is a lower bound of the step's, so the share is too; it bounds the kernels'
roofline shares from the whole step, as env_steps_per_device_s does."""
from simbench import roofline


def read(s):
    if s.get("tag") != "sim":
        return None
    sh = s["shapes"]
    flops = sh["control_steps_per_unit"] * roofline.control_step_flops(
        sh["B"], sh["nv"], sh["rows"], sh["substeps"])
    return 100.0 * flops / ((s["busy_s"] / s["units"]) * roofline.PEAK_FLOPS[sh["dtype"]])
