"""The PPO update's device-busy ms per iteration: the union of the device
operations' intervals of the traced iteration's update (PPO.update: the
values, GAE, the norm merge and every minibatch step of both nets)."""


def read(s):
    if s.get("tag") != "train":
        return None
    return 1e3 * s["update_busy_s"] / s["units"]
