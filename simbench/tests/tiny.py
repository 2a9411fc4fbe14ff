"""Tiny cells for the CPU tests: a copy of the benchmark's data directories
in a temporary directory, with one more cell added there as data files
only (a traffic file derived from a committed one, and its limits)."""
import copy
import json
import os
import shutil

from simbench import harness

DATA_DIRS = ("configs", "traffic", "limits", "metrics")


def tiny_cell(tmp_path, traffic: str, config: str, overrides: dict, limits: str | None = None,
              name: str = "tiny", limit_overrides: dict | None = None):
    """(manifest, base): the committed manifest with a cell `name` of
    `config` under a copy of traffic `traffic` with `overrides`, and the
    directory holding the data; the new cell takes the limits of the cell
    `limits` (default: the traffic's name) with `limit_overrides`, and is
    added to every metric that lists that cell."""
    base = str(tmp_path / "simbench")
    for d in DATA_DIRS:
        shutil.copytree(os.path.join(harness.HERE, d), os.path.join(base, d))
    t = harness.load_json(base, "traffic", traffic + ".json")
    t.update(overrides)
    with open(os.path.join(base, "traffic", name + ".json"), "w") as f:
        json.dump(t, f)
    like = limits or traffic
    lim = harness.load_json(base, "limits", like + ".json")
    lim.update(limit_overrides or {})
    with open(os.path.join(base, "limits", name + ".json"), "w") as f:
        json.dump(lim, f)
    m = copy.deepcopy(harness.load_json(harness.ROOT, "BENCHMARK.json"))
    m["workloads"].append({"name": name, "config": config, "traffic": name, "chips": 1,
                           "why": "a tiny cell for the CPU tests"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e and like in e["workloads"]:
            e["workloads"].append(name)
    return m, base
