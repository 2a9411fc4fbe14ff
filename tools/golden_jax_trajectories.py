"""Write the JAX package's own closed-loop speed trajectories beside the
MuJoCo golden, for the PyTorch port's tools and tests to compare against.

    JAX_PLATFORMS=cpu python tools/golden_jax_trajectories.py

The loop is tools/calibrate_solver.py's and tools/gate_f32_tpu.py's: the
speed env reset from PRNGKey(0), its task pinned to the golden's tar_speed
with no speed change, then `jax.jit(env.step)` over the golden's 150
actions (tests/golden/speed_ref_150.npz), on the CPU. It writes the qpos
of every control step, (150, nq) float64:

  tests/golden/speed_ref_150_jax_f32_product.npy
      float32 at the product QP (SMPLSIM_QP_ITERS=16, SMPLSIM_QP_TOL=1e-4,
      SMPLSIM_QP_ROWS=32), the float32 spine as the package defaults;
  tests/golden/speed_ref_150_jax_f64.npy
      float64 at the package's default QP (40 iterations, tol 1e-12, 64 rows).

The package reads its QP knobs when it is imported, so each loop runs in a
process of its own (about 45 s each). The port reads these files as numpy.
"""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "speed_ref_150.npz")
RUNS = {
    "f32_product": ("float32", {"SMPLSIM_QP_ITERS": "16", "SMPLSIM_QP_TOL": "1e-4",
                                "SMPLSIM_QP_ROWS": "32"}),
    "f64": ("float64", {}),
}
KNOBS = ("SMPLSIM_QP_ITERS", "SMPLSIM_QP_TOL", "SMPLSIM_QP_ROWS", "SMPLSIM_ABA",
         "SMPLSIM_CC_KEEP", "SMPLSIM_CB_KEEP", "SMPLSIM_BB_KEEP")


def out_path(name: str) -> str:
    return GOLDEN.replace(".npz", f"_jax_{name}.npy")


def loop(dtype_name: str) -> np.ndarray:
    """The (150, nq) float64 qpos of the JAX speed loop in `dtype_name`."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from smplsim_tpu.envs import HumanoidSpeed
    from smplsim_tpu.models import registry

    dtype = jnp.dtype(dtype_name)
    gold = np.load(GOLDEN)
    model = registry.default_humanoid(dtype=dtype)
    env = HumanoidSpeed(model)
    st = env.reset(jax.random.PRNGKey(0))
    st = st.replace(task=st.task.replace(
        tar_speed=jnp.asarray(float(gold["tar_speed"]), dtype),
        change_step=jnp.asarray(10**9, jnp.int32)))
    step = jax.jit(env.step)
    qpos = []
    for a in gold["actions"]:
        st = step(st, jnp.asarray(a, dtype))
        qpos.append(np.asarray(st.phys.qpos, np.float64))
    return np.asarray(qpos)


def main() -> None:
    if len(sys.argv) > 1:                      # one loop, in a process of its own
        name = sys.argv[1]
        qpos = loop(RUNS[name][0])
        np.save(out_path(name), qpos)
        err = np.abs(qpos - np.load(GOLDEN)["qpos"]).max(1)
        print(f"wrote {out_path(name)}: {qpos.shape}, max |qpos - golden| at steps "
              f"9/49/149: {err[9]:.3e} {err[49]:.3e} {err[149]:.3e}", flush=True)
        return
    for name, (_, knobs) in RUNS.items():
        env = {k: v for k, v in os.environ.items() if k not in KNOBS}
        env.update(knobs, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, os.path.abspath(__file__), name], env=env, check=True,
                       timeout=1800)


if __name__ == "__main__":
    main()
