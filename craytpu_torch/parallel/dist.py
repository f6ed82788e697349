"""Several processes, one a card: the port of the JAX package's
parallel/dist.py (init_distributed), on torch.distributed.

The JAX package is single-controller: one process drives every local
device through shard_map, and jax.distributed joins hosts. The port runs
one process (rank) per card, as torchrun does, and the process group
plays the part of the mesh: every collective of the JAX design is a
torch.distributed call, and every rank runs the same host control flow
over its own share of the work.

Import-light like the JAX package's module: nothing here builds a kernel
or loads the rest of the package, so an entry point can join the group
before it touches a card.

Groups:
  - the default group carries device data (frame sums, gradients): NCCL
    when every rank has a card of its own, gloo on the CPU and when
    ranks share a card (NCCL refuses two ranks on one card; gloo takes
    CUDA tensors for all_reduce and broadcast, and gathers go through
    host copies);
  - a gloo "control" group carries host values (the pool's live counts,
    the interrupt flag, checkpoint gathers), so the host never waits on
    a device collective to read one;
  - a gloo "job" group, with a long timeout, carries the jobs a cluster
    worker's rank 0 hands its other ranks (they may wait for a master
    for as long as the worker lives).
"""

from __future__ import annotations

import os
import socket
import traceback
from datetime import timedelta

# seconds a collective may wait for the slowest rank before the run fails
DEFAULT_TIMEOUT_S = 300.0
_JOB_TIMEOUT = timedelta(days=7)

_GROUPS: dict = {}


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group when one is configured.

    Sources, in precedence order: the arguments; CRAYTPU_COORDINATOR
    (host:port of rank 0), CRAYTPU_NUM_PROCESSES and CRAYTPU_PROCESS_ID
    (the JAX package's variables); then torchrun's MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK (in place of jax.distributed's cluster
    auto-detection). LOCAL_RANK and LOCAL_WORLD_SIZE, where set, say
    which card of its host a rank takes; else every rank is taken to be
    on one host.

    device: "cpu" (or CRAYTPU_PLATFORM=cpu) renders on the CPU over
    gloo. Otherwise the rank takes card LOCAL_RANK % device_count before
    any NCCL call, and the backend is NCCL when the host's ranks have a
    card each, gloo when they share cards. timeout_s: how long a
    collective waits for the slowest rank before the run fails.

    Returns True when the process is in a group (also when it already
    was), False when nothing is configured (one process). A failed
    init raises: nothing falls back to one rank.
    """
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("CRAYTPU_COORDINATOR")
    if coordinator:
        world = (num_processes if num_processes is not None
                 else _env_int("CRAYTPU_NUM_PROCESSES"))
        rank = (process_id if process_id is not None
                else _env_int("CRAYTPU_PROCESS_ID"))
        if world is None or rank is None:
            raise ValueError("CRAYTPU_COORDINATOR needs "
                             "CRAYTPU_NUM_PROCESSES and CRAYTPU_PROCESS_ID")
        init_method = f"tcp://{coordinator}"
    elif os.environ.get("MASTER_ADDR") and _env_int("WORLD_SIZE"):
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK") or 0
        init_method = "env://"
    else:
        return False
    local_rank = _env_int("LOCAL_RANK")
    local_world = _env_int("LOCAL_WORLD_SIZE")
    if local_rank is None:
        local_rank, local_world = rank, world
    local_world = local_world or world

    if device is None and os.environ.get("CRAYTPU_PLATFORM") == "cpu":
        device = "cpu"
    backend = "gloo"
    if device is None or torch.device(device).type != "cpu":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("no CUDA device for this rank; pass "
                               "device='cpu' (or CRAYTPU_PLATFORM=cpu)")
        torch.cuda.set_device(local_rank % n_cards)
        if local_world <= n_cards:
            backend = "nccl"
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    _GROUPS.clear()
    _GROUPS["control"] = (dist.new_group(backend="gloo", timeout=timeout)
                          if backend != "gloo" else dist.group.WORLD)
    _GROUPS["job"] = dist.new_group(backend="gloo", timeout=_JOB_TIMEOUT)
    return True


def initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if initialized() else 1


def multi_rank() -> bool:
    """True in a group of more than one rank."""
    return world_size() > 1


def control_group():
    return _GROUPS["control"]


def job_group():
    return _GROUPS["job"]


def host_max(values) -> list[int]:
    """The element-wise maximum over the group of a list of host ints
    (one gloo all_reduce on the control group)."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=control_group())
    return [int(v) for v in t]


def all_gather_object(obj) -> list:
    """Every rank's `obj`, in rank order (control group)."""
    import torch.distributed as dist
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=control_group())
    return out


def broadcast_object(obj=None, src: int = 0, group=None):
    """Rank src's `obj` on every rank (control group unless given)."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=src,
                               group=group or control_group())
    return box[0]


def all_reduce_sum_(t, group=None):
    """Sum a tensor over the group in place and return it: every rank
    holds the same sum, bit for bit."""
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_cat(t, group=None):
    """The ranks' tensors of one shape concatenated on dim 0, in rank
    order of the group. A gloo group gathers host copies (gloo has no
    CUDA all_gather)."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size(group)
    gloo = dist.get_backend(group) == "gloo"
    src = t.detach().cpu() if gloo else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawned(rank_: int, world: int, port: int, device, timeout_s: float,
             threads, fn, args, results) -> None:
    """A rank of spawn_local: join the group, run fn(*args), put
    (rank, ok, result or traceback) on `results`, leave the group."""
    import torch
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    try:
        init_distributed(f"127.0.0.1:{port}", world, rank_, device=device,
                         timeout_s=timeout_s)
        out = fn(*args)
        results.put((rank_, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank_, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        _GROUPS.clear()


def spawn_local(world: int, fn, *args, device="cuda",
                timeout_s: float = 600.0, collective_timeout_s: float = 60.0,
                threads: int | None = None) -> list:
    """Run fn(*args) on `world` ranks of a new process group on this host
    (processes started with torch.multiprocessing's spawn); returns the
    ranks' results in rank order. fn must be a module-level function.

    device: "cuda" (the default; ranks take cards LOCAL_RANK % count and
    share them when there are fewer cards than ranks) or "cpu" (gloo).
    threads: torch.set_num_threads in each rank. A rank's exception, a
    rank that dies, or the whole run outlasting timeout_s fails the call
    (the other ranks are killed); collective_timeout_s bounds each
    collective's wait. Every rank leaves the group in a finally."""
    import queue as queue_mod
    import time

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_spawned, daemon=True,
                         args=(r, world, port, device, collective_timeout_s,
                               threads, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            try:
                r, ok, out = results.get(timeout=0.2)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    left = sorted(set(range(world)) - set(got))
                    raise TimeoutError(
                        f"spawn_local({world}): ranks {left} not done "
                        f"after {timeout_s:.0f} s") from None
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    # a rank died without reporting: give its queue item
                    # a moment to arrive, then fail
                    try:
                        r, ok, out = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"spawn_local({world}): rank {dead[0]} exited "
                            f"with code {procs[dead[0]].exitcode}") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"spawn_local({world}): rank {r} "
                                   f"failed:\n{out}")
            got[r] = out
    finally:
        for p in procs:
            if p.is_alive() and len(got) < world:
                p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
