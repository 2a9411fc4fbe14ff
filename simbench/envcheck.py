"""What decides `correct` for env-steps: a sample, drawn from the seed, of
the window's `step_autoreset` calls, each held against the plain reference
(simbench/reference) stepping the same input state under the same action.

The sample is a reservoir over the window's calls: every call is equally
likely to be kept, and which are kept follows from the seed alone. A kept
call keeps a copy of its input state, its action, its env generator's state
and a copy of its output state.

The reference takes from the program's input state what a step reads:
qpos, qvel, the stable-PD cache (M, C of the last substep before, and the
contact warm start), the task, the episode clock and the generator's state;
it works out the kinematics again. It then resets every row from the
generator as it stands after the step's draws, as the port does, and keeps
a row's reset where the row finished. The input cache is the program's own
state, which only the program's previous step makes: each compared step's
output cache is compared (cache_gap_p50, and reset_gap for the fresh cache
of a reset row), so the cache a step hands on is checked where it is made.

Numbers, per sampled call, then the worst over the sample; limits/<cell>.json
names those compared and their limits, and the others are printed as
observed:

  * state_gap_p50   the physics: each row's largest |program - reference| /
                    (1 + |reference|) over qpos and qvel after the call, and
                    of those row gaps the median. Uniform random actions make
                    the humanoids' contacts chaotic and the bench QP stops at
                    a tolerance, so some rows of every sound call diverge by
                    their nature (the reference in float32 diverges from the
                    float64 one as far as the program does); the median is
                    steady from seed to seed, while a lower precision, a step
                    left out or half the batch left out moves it.
  * rows_off_share  the share of rows whose row gap exceeds the cell's
                    `rows_off_threshold`: a fault in a tenth of the rows, or
                    rows that a wrong termination left running or reset,
                    moves it where the median does not move.
  * cache_gap_p50   the stable-PD cache the call hands on (M, C and the
                    contact forces of its last substep): of each row the
                    largest |program - reference| of each over 1 + the row's
                    largest |reference| of it, the largest of the three; the
                    median row.
  * reset_gap       the rows the program finished in the call, on their own:
                    their qpos, qvel, observation, cache, task and episode
                    clock against the reference's reset of the same row from
                    the same generator state, the worst row. A reset is drawn,
                    not simulated, so nothing chaotic lies between the two.
  * done_flips      the rows whose done flag differs from the reference's,
                    the most in a call. A flag follows the chaotic physics of
                    its row, so a few rows flip in every sound call; a lower
                    precision flips many more, and a termination left out
                    flips every row that should have finished.
  * answer_gap      the answers handed back, against the reference's answers
                    for the program's own output state: of each row, the
                    largest |program - reference| of the observation over
                    1 + the row's largest |reference|, and the reward's
                    |program - reference| / (1 + |reference|) (rows that did
                    not finish; a finished row's reward belongs to the state
                    before its reset, which the call does not hand back); the
                    worst row. Nothing chaotic lies between the two, so one
                    altered answer shows.

Observed and printed, not compared: the first rows whose done flag
differs, reset_rows (the finished rows reset_gap compared) and the share
of rows off at each of THRESHOLDS, for the next calibration.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch


def sub_seeds(seed: int, n: int) -> list:
    """n independent 63-bit seeds from one run seed."""
    return [int(x) for x in np.random.SeedSequence(seed).generate_state(n, np.uint64) >> 1]


def clone_tree(x):
    """A deep copy of the tensors of a state tree (dataclasses, tuples,
    lists, dicts); a generator is kept as it is (its state is taken apart)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: clone_tree(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x


class Reservoir:
    """Keeps `size` of the calls offered, each equally likely, chosen by a
    generator seeded from the run seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.seen = 0
        self.kept = {}

    def slot(self):
        """The slot the next call goes to, or None."""
        k = self.seen
        self.seen += 1
        if k < self.size:
            return k
        j = self.rng.randrange(k + 1)
        return j if j < self.size else None


def record_call(env_step, reservoir: Reservoir):
    """env_step (state, action) -> state, wrapped so that the calls the
    reservoir keeps are copied into it."""
    def step(state, action, *args, **kwargs):
        slot = reservoir.slot()
        if slot is None:
            return env_step(state, action, *args, **kwargs)
        s_in, a_in, g_in = clone_tree(state), action.clone(), state.rng.get_state()
        out = env_step(state, action, *args, **kwargs)
        reservoir.kept[slot] = (s_in, a_in, g_in, clone_tree(out))
        return out
    return step


# ------------------------------------------------------------ the reference
def reference_env(ctx, dtype=torch.float64):
    """The reference env of the cell's configuration and traffic."""
    from simbench.reference.envs import tasks
    from simbench.reference.models.load import load_model

    model = load_model(ctx.model_path(), dtype=dtype, device=ctx.device)
    t = ctx.traffic
    cfg_cls = {"HumanoidSpeed": tasks.SpeedConfig, "HumanoidGetup": tasks.GetupConfig}[t["task"]]
    cfg = cfg_cls(**ctx.config["env"], **t.get("task_config", {}))
    return tasks.TASKS[t["task"]](model, cfg, keeps=tuple(t["keeps"]), **t["qp"])


def to_reference(env, state, gen_state, dtype):
    """A reference EnvState from a program EnvState (cast to dtype), with
    a generator at gen_state; the kinematics worked out again."""
    from simbench.reference.envs import base, tasks
    from simbench.reference.physics import kinematics
    from simbench.reference.physics.engine import PhysicsState

    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t.clone()

    phys = PhysicsState(cast(state.phys.qpos), cast(state.phys.qvel))
    task = state.task
    if task is not None:
        task = getattr(tasks, type(task).__name__)(**{
            f.name: cast(getattr(task, f.name)) for f in dataclasses.fields(task)})
    gen = torch.Generator(device=state.phys.qpos.device)
    gen.set_state(gen_state)
    return base.EnvState(
        phys=phys, obs=cast(state.obs), reward=cast(state.reward),
        terminated=state.terminated.clone(), truncated=state.truncated.clone(),
        cur_t=state.cur_t.clone(), task=task,
        info={k: cast(v) for k, v in state.info.items()},
        pd_cache=None if state.pd_cache is None else tuple(cast(t) for t in state.pd_cache),
        kin=kinematics.fk(env.model, phys.qpos), rng=gen)


def _rel(p, r) -> torch.Tensor:
    """(B,) each row's largest |p - r| / (1 + |r|) in float64 over the
    trailing axes; inf where p's row is not finite."""
    p, r = p.double().reshape(len(p), -1), r.double().reshape(len(r), -1)
    if p.shape[1] == 0:
        return torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    g = ((p - r).abs() / (1.0 + r.abs())).amax(1)
    return torch.where(torch.isfinite(p).all(1), g, torch.full_like(g, float("inf")))


def _rel_row(p, r) -> torch.Tensor:
    """(B,) each row's largest |p - r| over 1 + the row's largest |r|, in
    float64; inf where p's row is not finite. For rows whose entries are
    sums of large terms (forces, observations), where an entry near 0 says
    nothing of the rounding."""
    p, r = p.double().reshape(len(p), -1), r.double().reshape(len(r), -1)
    g = (p - r).abs().amax(1) / (1.0 + r.abs().amax(1))
    return torch.where(torch.isfinite(p).all(1), g, torch.full_like(g, float("inf")))


def _rows(gaps) -> torch.Tensor:
    """(B,) the largest of several (B,) row gaps."""
    out = gaps[0]
    for g in gaps[1:]:
        out = torch.maximum(out, g)
    return out


def _cache_rows(p, r) -> torch.Tensor:
    """(B,) row gaps over the caches (M, C, contact forces), each at its
    row's scale; None where the control mode keeps none."""
    if p is None or r is None:
        return None
    return _rows([_rel_row(a, b) for a, b in zip(p, r)])


def _task_rows(p, r) -> torch.Tensor:
    """(B,) row gaps over the task's fields; None without a task."""
    if p is None:
        return None
    return _rows([_rel(getattr(p, f.name), getattr(r, f.name)) for f in dataclasses.fields(p)])


def answers(env, prog_in, prog_out, gen_state, dtype):
    """The reference's observation and reward for the program's output
    state: the observation of the output state and task, and the reward of
    the step from the input's root position to the output state under the
    output task."""
    ref_out = to_reference(env, prog_out, gen_state, dtype)
    ref_in = to_reference(env, prog_in, gen_state, dtype)
    task = env.pre_physics(ref_out.task, ref_in.phys, ref_in.kin)
    obs = env.compute_obs(ref_out.task, ref_out.phys, ref_out.kin)
    reward = env.reward(task, ref_out.phys, ref_out.kin, None)
    return obs, reward


@dataclasses.dataclass
class RefStep:
    """The reference's call: `out` as step_autoreset returns it, `fresh` the
    reset of every row from the generator after the step's draws, and
    `stepped` the step before any reset."""

    out: object
    fresh: object
    stepped: object


def reference_out(env, s_in, a_in, g_in, dtype) -> RefStep:
    """The reference's step_autoreset from the kept input, keeping the
    reset of every row beside the output (as its step_autoreset does)."""
    from simbench.reference.envs import base

    nxt = env.step(to_reference(env, s_in, g_in, dtype), a_in.to(dtype))
    fresh = env.reset(nxt.cur_t.shape[0], nxt.rng)
    fresh = dataclasses.replace(fresh, reward=nxt.reward, terminated=nxt.terminated,
                                truncated=nxt.truncated, info=nxt.info)
    return RefStep(out=base.select(nxt.done, fresh, nxt), fresh=fresh, stepped=nxt)


def compare(env, prog_in, prog_out, ref: RefStep, gen_state, dtype,
            threshold: float = 1.0) -> dict:
    """The numbers of one call; `ref` is the reference's call from the
    program's input; `threshold` the row gap above which a row counts as
    off."""
    r_out = ref.out
    state = _rows([_rel(prog_out.phys.qpos, r_out.phys.qpos),
                   _rel(prog_out.phys.qvel, r_out.phys.qvel)])
    cache = _cache_rows(prog_out.pd_cache, r_out.pd_cache)
    # the rows the program finished, against the reference's reset of them
    fin = prog_out.done
    fresh = ref.fresh
    reset = [_rel(prog_out.phys.qpos, fresh.phys.qpos), _rel(prog_out.phys.qvel, fresh.phys.qvel),
             _rel_row(prog_out.obs, fresh.obs),
             _rel(prog_out.cur_t, fresh.cur_t)]
    for g in (_cache_rows(prog_out.pd_cache, fresh.pd_cache),
              _task_rows(prog_out.task, fresh.task)):
        if g is not None:
            reset.append(g)
    reset = _rows(reset)[fin]
    obs, reward = answers(env, prog_in, prog_out, gen_state, dtype)
    ans = _rel_row(prog_out.obs, obs)
    ans = torch.where(~fin, torch.maximum(ans, _rel(prog_out.reward, reward)), ans)
    qs = torch.tensor(QUANTILES, dtype=state.dtype, device=state.device)
    q = torch.quantile(state.clamp_max(1e300), qs).tolist()
    flips = (prog_out.done != r_out.done).nonzero().flatten()
    return dict(
        state_gap_p50=q[QUANTILES.index(0.5)],
        rows_off_share=float((~(state <= threshold)).double().mean()),
        cache_gap_p50=0.0 if cache is None else float(torch.quantile(cache.clamp_max(1e300), 0.5)),
        reset_gap=float(reset.max()) if reset.numel() else 0.0,
        answer_gap=float(ans.max()),
        done_flips=int(flips.numel()), flipped_rows=flips[:8].tolist(), reset_rows=int(fin.sum()),
        state_quantiles=dict(zip(QUANTILES, q)), state=state, answer=ans)


NAMES = ("state_gap_p50", "rows_off_share", "cache_gap_p50", "reset_gap", "answer_gap",
         "done_flips")
QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)
# the row gaps at which calibrate.py reads the share of rows off
THRESHOLDS = (0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0)


def reference_outs(env, kept: dict, dtype=torch.float64) -> dict:
    """{slot: the reference's call from the kept call's input}."""
    with torch.no_grad():
        return {slot: reference_out(env, s_in, a_in, g_in, dtype)
                for slot, (s_in, a_in, g_in, _) in kept.items()}


def readings(env, kept: dict, dtype=torch.float64, limits: dict | None = None,
             more: bool = False, refs: dict | None = None):
    """(worst, observed, failed): the worst of each number over the kept
    calls; what is observed but not compared (the first rows flipped in the
    call with the most done flips, the finished rows compared, the share of
    rows off at each of THRESHOLDS); and how many rows' answers exceed the
    answer limit (where `limits` gives one). The row-off threshold is the
    limits' `rows_off_threshold` (1 without). more: also the row-gap
    quantiles. refs: the reference's calls, where already worked out."""
    limits = limits or {}
    threshold = limits.get("rows_off_threshold", 1.0)
    worst = dict.fromkeys(NAMES, 0.0)
    observed = {"flipped_rows": [], "reset_rows": 0,
                "off_shares": {str(t): 0.0 for t in THRESHOLDS}}
    extra = {f"state_q{q}": 0.0 for q in QUANTILES}
    failed = 0
    for slot in sorted(kept):
        s_in, a_in, g_in, s_out = kept[slot]
        with torch.no_grad():
            ref = (refs or {}).get(slot)
            if ref is None:
                ref = reference_out(env, s_in, a_in, g_in, dtype)
            c = compare(env, s_in, s_out, ref, g_in, dtype, threshold)
        if c["done_flips"] >= worst["done_flips"]:
            observed["flipped_rows"] = c["flipped_rows"]
        for k in NAMES:
            worst[k] = max(worst[k], c[k])
        observed["reset_rows"] += c["reset_rows"]
        for q, v in c["state_quantiles"].items():
            extra[f"state_q{q}"] = max(extra[f"state_q{q}"], v)
        offs = observed["off_shares"]
        for t in THRESHOLDS:
            offs[str(t)] = max(offs[str(t)], float((~(c["state"] <= t)).double().mean()))
        if "answer_gap" in limits:
            failed += int((~(c["answer"] <= limits["answer_gap"])).sum())
    return ({**worst, **extra} if more else worst), observed, failed


def check_calls(ctx, kept: dict, dtype=torch.float64):
    """([(name, worst value, limit)] of the numbers the cell's limits name,
    the rows whose answer exceeded its limit, and what was observed: with
    it each number the cell's limits leave out, one whose lower-precision
    control does not read three times what the program reads there)."""
    if not kept:
        return [("calls_compared", 0.0, -1.0)], 0, {}
    lim = ctx.limits
    worst, observed, failed = readings(reference_env(ctx, dtype), kept, dtype, lim)
    observed.update({k: worst[k] for k in NAMES if k not in lim})
    return [(k, float(worst[k]), float(lim[k])) for k in NAMES if k in lim], failed, observed
