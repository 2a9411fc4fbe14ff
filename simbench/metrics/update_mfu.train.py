"""The PPO update's share (%) of the card's float32 peak, the learner's
roofline share: the nets' operations of one update (simbench/
roofline_train.py::update_flops, 6 P per sample per minibatch step for
each net and 2 P per sample for the value pass, counted from the widths
and the batch) over the update's device-busy seconds and the peak."""
from simbench import roofline, roofline_train


def read(s):
    if s.get("tag") != "train":
        return None
    sh = s["shapes"]
    busy = s["update_busy_s"] / s["units"]
    return 100.0 * roofline_train.update_flops(sh) / (busy * roofline.PEAK_FLOPS[sh["dtype"]])
