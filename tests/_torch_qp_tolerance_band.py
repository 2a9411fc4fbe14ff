"""How far apart can two float64 contact-QP answers lie when both meet the
KKT tolerance? A check run as a script, on the CPU:

    PYTHONPATH=. python tests/_torch_qp_tolerance_band.py [--batch 1536]

The systems are chip_smoke.py phase 24's kind at a smaller batch:
DomainRandEnv over HumanoidSpeed (float32, the bench QP, every physical
field randomized), 3 step_autoresets of uniform random actions from a
reset, then the compact QP of one real substep, cast to float64 (the envs
with |qvel| > 1e3 left out). The plain newton_qp (16 iterations, tol 1e-12)
is compared on the systems where both answers meet tol 1e-12 with

  (a) itself at tol 1e-14 (the same system, a later stop in the band);
  (b) itself on (A, b) moved by at most one ulp per entry.

For (a) the pairs that part by more than 1e-12 are held against the
distance the tolerance allows two solutions (chip_smoke.tolerance_spread).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from smplsim_tpu_torch.envs import (DomainRandConfig, DomainRandEnv, HumanoidSpeed,  # noqa: E402
                                    NoiseSpec)
from smplsim_tpu_torch.models import registry  # noqa: E402
from smplsim_tpu_torch.ops import qp  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1536)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()
    model = registry.default_humanoid(torch.float32, device="cpu")
    scl = lambda lo, hi: NoiseSpec("uniform", "scaling", (lo, hi))
    noise = NoiseSpec("gaussian", "additive", (0.0, 0.01))
    cfg = DomainRandConfig(frequency=1, observations=noise, actions=noise,
                           body_mass=scl(0.8, 1.2), friction=scl(0.5, 1.5),
                           dof_damping=scl(0.5, 1.5), armature=scl(0.5, 2.0),
                           pd_gains=scl(0.8, 1.2), gravity=scl(0.95, 1.05))
    gen = torch.Generator().manual_seed(args.seed)
    act = lambda: torch.rand(args.batch, model.nu, generator=gen) * 2 - 1
    denv = DomainRandEnv(HumanoidSpeed(model, **cs.QP), cfg)
    ds = denv.reset(args.batch, gen)
    for _ in range(3):
        ds = denv.step_autoreset(ds, act())
    inputs = cs.substep_inputs(ds.model, ds.inner, act())
    tame = ds.inner.phys.qvel.abs().amax(1) <= cs.WILD_QVEL
    A, b, a, f0 = (t[tame].double().contiguous() for t in inputs["qp"])
    tau = 1e-12 * (1 + b.abs().amax(-1))
    met = lambda A_, b_, f: qp.kkt_residual(A_, b_, f, a) <= tau
    rel = lambda x, y: ((x - y).abs() / (1 + x.abs())).amax(1)

    fp, _ = qp.newton_qp_plain_counted(A, b, a, f0, 16, 1e-12)
    fr, _ = qp.newton_qp_plain_counted(A, b, a, f0, 16, 1e-14)
    both = met(A, b, fp) & met(A, b, fr)
    d = rel(fp, fr)
    print(f"(a) {int(both.sum())} of {b.shape[0]} systems meet tol 1e-12 at both stops: "
          f"|p - p'|/(1 + |p|) max {d[both].max().item():.3e}, > 1e-9 in "
          f"{int((both & (d > 1e-9)).sum())}", flush=True)
    parted = both & (d > 1e-12)
    print(f"(a) the {int(parted.sum())} that part by more than 1e-12 within the tolerance's "
          f"bound: {cs.tolerance_spread(A, b, a, fr, fp, 1e-12, parted)}")

    g = torch.Generator().manual_seed(args.seed + 1)
    sign = lambda x: torch.where(torch.rand(x.shape, generator=g, dtype=x.dtype) < 0.5, 1.0, -1.0)
    eps = torch.finfo(torch.float64).eps
    A2 = A * (1 + sign(A) * eps)
    A2 = 0.5 * (A2 + A2.transpose(1, 2))
    b2 = b * (1 + sign(b) * eps)
    fq, _ = qp.newton_qp_plain_counted(A2, b2, a, f0, 16, 1e-12)
    both = met(A, b, fp) & met(A2, b2, fq)
    d = rel(fp, fq)
    print(f"(b) {int(both.sum())} systems meet tol 1e-12 on both inputs: max "
          f"{d[both].max().item():.3e}, > 1e-9 in {int((both & (d > 1e-9)).sum())}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
