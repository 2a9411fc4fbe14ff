"""Process-group plumbing: distributed init, the 1-D data mesh, placement,
the collectives and the rank's generator (port of
smplsim_tpu/parallel/mesh.py).

The JAX package runs one program over a device mesh (shard_map); the port
runs one process per rank under torch.distributed, and what shard_map gives
for free is spelled out here:

  * `init_distributed()`       the process group, from arguments or the
                               SMPLSIM_* variables; a no-op at one process.
  * `data_mesh(n)`             the group of the first n ranks, this rank's
                               index and size, and its device.
  * `replicate(tree, mesh)`    rank 0's values on every rank (broadcast).
  * `shard_batch(tree, mesh)`  this rank's contiguous rows of every leaf.
  * `shard_env_states`         shard_batch of an EnvState, whose generator
                               is folded with the rank.
  * `pmean`, `psum`, `pmax`, `pmin`, `all_gather`   the collectives used
                               inside shard_map, over a process group.
  * `fold_in(generator, r)`    the counterpart of jax.random.fold_in.
  * `run_ranks(fn, world)`     a world of spawned processes on this host.

The gather, and max and min through it, is an all-reduce SUM of a
zero-padded buffer and a local reduction: exact (x + 0 = x; a -0.0 comes
back as 0.0), one code path on NCCL and on gloo, whose CUDA tensors take
only broadcast and all_reduce.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from smplsim_tpu_torch.envs.base import map_state

# how long a rank waits at the rendezvous and in a collective for the others
TIMEOUT = datetime.timedelta(seconds=600)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the default process group of num_processes ranks as rank
    process_id (else SMPLSIM_NUM_PROCESSES, SMPLSIM_PROCESS_ID; the
    rendezvous at SMPLSIM_COORDINATOR, host:port, default localhost:12355;
    an address with a scheme, such as file:///path, is taken as it is). A
    no-op at one process. The backend is "nccl" unless the caller names
    "gloo"; "nccl" without a CUDA card raises."""
    num = num_processes if num_processes is not None else int(
        os.environ.get("SMPLSIM_NUM_PROCESSES", "1"))
    if num <= 1:
        return
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs a CUDA card; name backend='gloo' for the CPU")
    addr = coordinator_address or os.environ.get("SMPLSIM_COORDINATOR", "localhost:12355")
    rank = process_id if process_id is not None else int(
        os.environ.get("SMPLSIM_PROCESS_ID", "0"))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=addr if "://" in addr else f"tcp://{addr}",
                            world_size=num, rank=rank, timeout=TIMEOUT)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The port's 1-D "data" mesh: a process group (None for a single
    process without one: every collective of the package is then skipped),
    this rank's index in it (-1 on a rank outside it), its size, and the
    device this rank computes on."""

    group: Any
    rank: int
    size: int
    device: torch.device


def data_mesh(n_devices: int | None = None, device: str | torch.device | None = None) -> DataMesh:
    """The mesh of the first n_devices ranks of the default group (all of
    them by default; a single process without a group is a mesh of one).
    Every rank must call it, as torch.distributed.new_group asks. The
    device is cuda:<rank % device_count> (the ranks of one host numbered
    from 0), or `device` where the caller names one, as the CPU tests do."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs init_distributed first")
        group, rank, size, global_rank = None, 0, 1, 0
    else:
        world = dist.get_world_size()
        size = world if n_devices is None else n_devices
        if not 1 <= size <= world:
            raise ValueError(f"a mesh of {size} ranks in a world of {world}")
        group = dist.group.WORLD if size == world else dist.new_group(list(range(size)))
        global_rank = dist.get_rank()
        rank = global_rank if global_rank < size else -1
    if device is None:
        device = torch.device("cuda", global_rank % max(torch.cuda.device_count(), 1))
    return DataMesh(group=group, rank=rank, size=size, device=torch.device(device))


# ------------------------------------------------------------------ placement
def _broadcast_(t: torch.Tensor, mesh: DataMesh) -> None:
    """Overwrite t with rank 0's t, through a buffer on the mesh's device
    where t lies elsewhere (NCCL takes only CUDA tensors)."""
    src = dist.get_global_rank(mesh.group, 0)
    if t.device == mesh.device and t.is_contiguous():
        dist.broadcast(t, src, group=mesh.group)
        return
    buf = t.to(mesh.device, copy=True).contiguous()
    dist.broadcast(buf, src, group=mesh.group)
    t.copy_(buf)


@torch.no_grad()
def replicate(tree: Any, mesh: DataMesh) -> Any:
    """Rank 0's values on every rank of the mesh. Tensors come back as
    copies on the mesh's device; modules (parameters and buffers),
    optimisers (their state) and generators are overwritten in place and
    returned; dataclasses, tuples, lists and dicts are walked; other leaves
    are kept."""
    if isinstance(tree, torch.Tensor):
        out = tree.to(mesh.device, copy=True)
        if mesh.group is not None:
            _broadcast_(out, mesh)
        return out
    if mesh.group is not None:
        if isinstance(tree, torch.nn.Module):
            for t in list(tree.parameters()) + list(tree.buffers()):
                _broadcast_(t.data, mesh)
        elif isinstance(tree, torch.optim.Optimizer):
            for state in tree.state.values():
                for v in state.values():
                    if isinstance(v, torch.Tensor):
                        _broadcast_(v, mesh)
        elif isinstance(tree, torch.Generator):
            state = tree.get_state()
            _broadcast_(state, mesh)
            tree.set_state(state)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: replicate(getattr(tree, f.name), mesh) for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(x, mesh) for x in tree)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return tree


def _rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    if x.dim() == 0 or x.shape[0] % mesh.size:
        raise ValueError(f"a leading axis of shape {tuple(x.shape)} does not divide over "
                         f"{mesh.size} ranks")
    b = x.shape[0] // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device, copy=True)


def shard_batch(tree: Any, mesh: DataMesh) -> Any:
    """This rank's contiguous rows (rank r of W: rows r*B/W to (r+1)*B/W)
    of every tensor's leading axis, copied to the mesh's device; the rows
    of all ranks, in rank order, are the batch. B must divide by W, as in
    the JAX package. Generators are kept (shard_env_states folds them)."""
    return map_state(lambda x: x if isinstance(x, torch.Generator) else _rows(x, mesh), tree)


def shard_env_states(states: Any, mesh: DataMesh) -> Any:
    """An EnvState batch sharded over the mesh: its rows, and its
    generator folded with the rank (fold_in), so that each rank draws its
    own task samples and resets. The port's EnvState carries one generator
    for the batch, where the JAX one carries a key per env: a run at W > 1
    is therefore not the unsharded run reshuffled."""
    return map_state(lambda x: fold_in(x, mesh.rank) if isinstance(x, torch.Generator)
                     else _rows(x, mesh), states)


# ---------------------------------------------------------------- collectives
def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group (jax.lax.psum), as a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of x over the group (jax.lax.pmean: the sum over the size)."""
    return psum(x, group) / dist.get_world_size(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(W, *x.shape): every rank's x in rank order (jax.lax.all_gather),
    as the sum of buffers that are zero but in the rank's own row."""
    buf = x.new_zeros((dist.get_world_size(group),) + tuple(x.shape))
    buf[dist.get_rank(group)] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group (jax.lax.pmax)."""
    return all_gather(x, group).amax(0)


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise min over the group (jax.lax.pmin)."""
    return all_gather(x, group).amin(0)


# ------------------------------------------------------------------ generators
def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A new generator on `generator`'s device, derived from its state and
    the integer `data` (the counterpart of jax.random.fold_in): seeded with
    the first 8 bytes, little-endian, of the BLAKE2b hash of the state's
    bytes followed by `data` as 8 little-endian bytes, the top bit cleared.
    `generator` is left as it was; the same state and data give the same
    generator on every rank."""
    h = hashlib.blake2b(generator.get_state().numpy().tobytes(), digest_size=8)
    h.update(int(data).to_bytes(8, "little"))
    seed = int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)
    return torch.Generator(device=generator.device).manual_seed(seed)


# ------------------------------------------------------------------- launching
def _rank_main(fn, rank, world, store, args, results) -> None:
    torch.set_num_threads(1)
    try:
        # plain pickle bytes: the queue's own pickler would pass tensors as
        # shared memory, which dies with the rank
        results.put((rank, True, pickle.dumps(fn(rank, world, store, *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, args: tuple = (), timeout: float = 900.0) -> list:
    """fn(rank, world, store, *args) in `world` processes started with the
    spawn method (safe beside a CUDA context); store is a file:// address
    in a fresh directory for init_distributed to meet at. Returns the
    ranks' results (picklable) in rank order. A rank that raises or dies,
    or a world that outlives `timeout` seconds, kills every rank and
    raises. fn must be importable (a module-level function)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            out, deadline = {}, time.monotonic() + timeout
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world - len(out)} of {world} ranks did not finish "
                                       f"within {timeout:.0f} s")
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                try:
                    # a rank that has exited flushed its result first: wait a
                    # little for it before calling the rank lost
                    rank, ok, value = results.get(timeout=5.0 if dead else min(left, 1.0))
                except queue.Empty:
                    if dead:
                        raise RuntimeError(f"ranks {dead} of {world} exited without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
                out[rank] = pickle.loads(value)
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
            return [out[r] for r in range(world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
