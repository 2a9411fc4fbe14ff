"""Does the JAX package's self-contact set flip under a one-ulp change of its
forward kinematics? A check run as a script, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_fk_ulp_check.py

The state is that of tests/test_torch_modules.py::
test_self_contacts_match_wide_keeps[2] (6 tangled envs, seed 2, float64,
the KEEPs wide). The JAX package's per-env self_contacts (the routine that
test holds the port against) runs on its own FK, then on frames changed in
the last bits, the package itself left as it is:

  (a) the port's FK of a stacked model of identical copies, whose batched
      frame products round differently from the shared model's BLAS ones
      (kinematics.fk's two forms);
  (b) `--trials` random perturbations: every entry of xpos and xmat moved
      by at most one ulp (np.nextafter, up, down or not at all).

For each run it prints the contacts that differ from the unperturbed set:
a flipped active flag, or a depth moved by more than 1e-6 (the capsule-box
knife edges move by centimetres when they flip).
"""
from __future__ import annotations

import argparse

import jax
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)

from smplsim_tpu.physics import collision_pairs as jax_cp  # noqa: E402
from smplsim_tpu.physics import kinematics as jax_kin  # noqa: E402
from smplsim_tpu_torch.models import stack_models  # noqa: E402
from smplsim_tpu_torch.physics import kinematics  # noqa: E402
from tests._torch_port import T, models, states  # noqa: E402

B = 6


def contact_set(sc):
    """{(body1, body2, k): depth} of one env's active self-contacts (k counts
    repeated body pairs in slot order)."""
    act = np.asarray(sc.active)
    out, seen = {}, {}
    for b1, b2, d in zip(*(np.asarray(x)[act] for x in (sc.body1, sc.body2, sc.dist))):
        k = seen.get((int(b1), int(b2)), 0)
        seen[(int(b1), int(b2))] = k + 1
        out[(int(b1), int(b2), k)] = float(d)
    return out


def diff(ref, val):
    """Contacts present in one set only, or whose depth moved by > 1e-6."""
    keys = sorted(set(ref) | set(val))
    return [(k, ref.get(k), val.get(k)) for k in keys
            if k not in ref or k not in val or abs(ref[k] - val[k]) > 1e-6]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=200)
    args = ap.parse_args()
    jm, tm = models()
    qpos, _, _ = states(jm, B, "tangled", seed=2)
    one = jax.jit(lambda kin: jax_cp.self_contacts(jm, kin))
    kins = [jax_kin.fk(jm, q) for q in qpos]
    base = [contact_set(one(k)) for k in kins]

    # (a) the port's stacked-model frames, fed to JAX's narrowphase
    sk = kinematics.fk(stack_models([tm] * B), T(qpos))
    shared = kinematics.fk(tm, T(qpos))
    ulps = (sk.xmat - shared.xmat).abs().max() / np.spacing(1.0)
    print(f"(a) port stacked vs shared FK: xpos differs by at most "
          f"{float((sk.xpos - shared.xpos).abs().max()):.3e}, xmat by {float(ulps):.1f} ulp of 1")
    flips_a = 0
    for b in range(B):
        kin = kins[b]._replace(xpos=sk.xpos[b].numpy(), xmat=sk.xmat[b].numpy())
        d = diff(base[b], contact_set(one(kin)))
        flips_a += len(d)
        for k, r, v in d:
            print(f"    env {b}: bodies {k[:2]} depth {r} -> {v}")
    print(f"(a) {flips_a} contacts differ from JAX's own over the {B} envs")

    # (b) random one-ulp perturbations of xpos and xmat
    rng = np.random.RandomState(0)
    hit = {}
    for t in range(args.trials):
        for b in range(B):
            k = kins[b]
            xp, xm = np.asarray(k.xpos), np.asarray(k.xmat)
            nudge = lambda x: np.where(rng.rand(*x.shape) < 0.5,
                                       np.nextafter(x, np.where(rng.rand(*x.shape) < 0.5,
                                                                np.inf, -np.inf)), x)
            d = diff(base[b], contact_set(one(k._replace(xpos=nudge(xp), xmat=nudge(xm)))))
            for key, r, v in d:
                hit.setdefault((b,) + key[:2], []).append((r, v))
    print(f"(b) {args.trials} random one-ulp perturbations of every env's frames: "
          f"{sum(len(v) for v in hit.values())} contact changes")
    for (b, b1, b2), seen in sorted(hit.items()):
        r, v = seen[0]
        print(f"    env {b}: bodies ({b1}, {b2}) changed in {len(seen)} of {args.trials} "
              f"trials, e.g. depth {r} -> {v}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
