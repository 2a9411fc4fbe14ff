"""On the card: the lower-precision control comes out not correct and the
program correct, on three seeds, at sizes a test run holds (a smaller batch
of each cell's traffic, the cell's own limits). The benchmark's own runs
never run the control; simbench/calibrate.py reads it at the cells' sizes."""
import pytest

from simbench import calibrate
from simbench.tests.tiny import tiny_cell

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def _over(readings: dict, limits: dict) -> list:
    return [k for k, v in readings.items() if k in limits and not v <= limits[k]]


@pytest.mark.card
@pytest.mark.parametrize("cell,traffic,config,overrides", [
    ("speed_b4096", "speed_b4096", "smpl", {"batch": 1024, "warmup_units": 1}),
    ("smplx_speed_b4096", "speed_b4096", "smplx", {"batch": 512, "warmup_units": 1}),
])
def test_env_control_fails_program_passes(card, tmp_path, cell, traffic, config, overrides):
    m, base = tiny_cell(tmp_path, traffic, config, overrides, limits=cell)
    limits = calibrate.harness.load_json(base, "limits", "tiny.json")
    for seed in SEEDS:
        r = calibrate.one_seed(m, "tiny", seed, 2, "cuda", base)["calls"]
        assert not _over(r["program"], limits), (seed, r["program"])
        assert _over(r["control"], limits), (seed, r["control"])
