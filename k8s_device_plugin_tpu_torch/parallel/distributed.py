"""The process group over every card a pod was given, on one host or many:
the counterpart of the JAX package's ``parallel/distributed.py``.

The device plugin's Allocate response exports the slice layout
(``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``, ``TPU_COORDINATOR_PORT``);
this module parses it (``slice_env``), and starts one rank per local card
against one store (``RankPool``, ``spawn_local``): the world is hosts x
local cards, rank ``worker_id x local + local_rank``, and the store is at
``hostnames[0]:coordinator_port``, hosted by worker 0's launcher, as the
JAX module elects its coordinator. On one host the launcher hosts the
store on a free localhost port. Each rank then joins the group
(``initialize``: NCCL on the card, gloo on the CPU) and builds the global
mesh (``global_mesh``); each host feeds only its own rows of the batch
(``shard_host_batch``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import multiprocessing
import multiprocessing.connection
import os
import signal
import sys
import time
import traceback
from collections.abc import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import batch_index, make_mesh

DEFAULT_COORDINATOR_PORT = 8476
# Seconds a launcher waits for its ranks to come up or to finish one job
# before it kills them all.
DEFAULT_TIMEOUT_S = 600.0
# The environment a launched rank reads (torchrun's names).
RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class SliceEnv:
    """The multi-host slice layout as the plugin exported it."""

    worker_id: int
    hostnames: tuple[str, ...]
    coordinator_port: int = DEFAULT_COORDINATOR_PORT

    @property
    def num_hosts(self) -> int:
        return len(self.hostnames)

    @property
    def coordinator_address(self) -> str:
        # The first worker hosts the store: it lives as long as the slice,
        # and every worker has its name.
        return f"{self.hostnames[0]}:{self.coordinator_port}"


def slice_env(environ: Mapping[str, str] | None = None) -> SliceEnv | None:
    """Parse the plugin-exported slice env; None when not on a multi-host
    slice (no or empty TPU_WORKER_HOSTNAMES). A missing or malformed value
    raises rather than defaulting: two hosts both taking worker 0 would
    hang every rank at the store."""
    environ = os.environ if environ is None else environ
    raw = environ.get("TPU_WORKER_HOSTNAMES", "")
    hosts = tuple(h.strip() for h in raw.split(",") if h.strip())
    if not hosts:
        return None
    raw_id = environ.get("TPU_WORKER_ID", "")
    if raw_id == "" and len(hosts) > 1:
        raise ValueError(
            f"TPU_WORKER_ID is unset but TPU_WORKER_HOSTNAMES lists "
            f"{len(hosts)} workers; every host would claim process 0"
        )
    try:
        worker_id = int(raw_id or 0)
    except ValueError as e:
        raise ValueError(f"unparseable TPU_WORKER_ID={raw_id!r}") from e
    raw_port = environ.get("TPU_COORDINATOR_PORT", "")
    try:
        port = int(raw_port or DEFAULT_COORDINATOR_PORT)
    except ValueError as e:
        raise ValueError(f"unparseable TPU_COORDINATOR_PORT={raw_port!r}") from e
    if not 0 <= worker_id < len(hosts):
        raise ValueError(
            f"TPU_WORKER_ID={worker_id} out of range for {len(hosts)} worker hostnames"
        )
    return SliceEnv(worker_id=worker_id, hostnames=hosts, coordinator_port=port)


def rank_layout(env: SliceEnv | None, local: int) -> tuple[int, int, str | None]:
    """(world, this host's first rank, the coordinator's ``host:port``) for
    ``local`` ranks on this host. The coordinator is None on one host (no
    env, or one hostname): the launcher then hosts the store on a free
    localhost port, and no fixed port is taken."""
    if env is None or env.num_hosts < 2:
        return local, 0, None
    return env.num_hosts * local, env.worker_id * local, env.coordinator_address


def local_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on in this rank: the card of its
    ``LOCAL_RANK`` (``cuda:0`` outside a launcher) unless the caller asks
    for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize(device: str | torch.device | None = None) -> bool:
    """Bring up this process's default process group; idempotent. A rank a
    launcher started (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` in its environment, as ``RankPool`` and torchrun set
    them) joins the launcher's store. Any other process is a world of one
    over an in-memory ``HashStore``: no port and no coordinator
    round-trip. NCCL on the card (which this also makes the current one),
    gloo on the CPU. Returns True when the group spans more than this
    process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    dev = local_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    if world > 1:
        rank = int(os.environ["RANK"])
        store = dist.TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]),
                              is_master=False, timeout=timeout)
    else:
        rank, store = 0, dist.HashStore()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store,
                            rank=rank, world_size=world, timeout=timeout)
    return world > 1


def global_mesh(shape: Sequence[int] | None = None, device: str | torch.device | None = None):
    """The mesh over the whole slice (every host's ranks). Ranks of one
    host are contiguous, so the outer axes (data, fsdp) cross hosts and
    the inner one (model) stays within a host."""
    return make_mesh(shape=tuple(shape) if shape else None, device=device)


def shard_host_batch(local_batch, mesh) -> torch.Tensor:
    """The rows of this host's batch that this rank feeds. Each host holds
    only its own examples, ``local_batch``: the rows of the (data, fsdp)
    shards its ranks feed, in shard order. No input row crosses hosts."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    rank = dist.get_rank()
    first = rank - rank % local_world
    shards = sorted({batch_index(mesh, r)[0] for r in range(first, first + local_world)})
    rows = len(local_batch)
    if rows % len(shards):
        raise ValueError(f"a host batch of {rows} rows does not split over its "
                         f"{len(shards)} batch shards")
    per = rows // len(shards)
    j = shards.index(batch_index(mesh)[0])
    return torch.as_tensor(np.asarray(local_batch[j * per:(j + 1) * per])).long()


class RankPool:
    """``local`` rank processes on this host, one per card (or gloo ranks
    on the CPU), joined in one process group, that run the functions they
    are handed. ``env`` (a multi-host ``SliceEnv``) places them in the
    slice's world; without it they are the whole world.

    The launcher process hosts the store (on a free localhost port, or on
    the coordinator port for worker 0 of a slice, which raises at once
    when the port is taken). Every wait has a deadline, ``timeout_s`` by
    default: a rank that fails, dies or misses it gets every rank killed,
    and the call raises with the failing rank's traceback. Each rank dies
    with its launcher (Linux), and ``close`` stops them all.

    A job is a function importable by name (it is pickled) and its
    arguments; ``run`` returns each local rank's result. Rank processes
    import only what the job's module imports."""

    def __init__(self, local: int, device: str | torch.device | None = None,
                 env: SliceEnv | None = None, timeout_s: float = DEFAULT_TIMEOUT_S):
        dev_type = resolve_device(device).type
        if dev_type == "cuda" and local > torch.cuda.device_count():
            raise ValueError(f"{local} ranks, but only {torch.cuda.device_count()} cards")
        world, first, coordinator = rank_layout(env, local)
        self.first = first
        self.timeout_s = timeout_s
        self._store = None
        if coordinator is None:
            self._store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
            host, port = "127.0.0.1", self._store.port
        else:
            host, port = env.hostnames[0], env.coordinator_port
            if env.worker_id == 0:
                self._store = dist.TCPStore(host, port, is_master=True, wait_for_workers=False)
        ctx = multiprocessing.get_context("spawn")
        self._conns, self._procs = [], []
        for i in range(local):
            ours, theirs = ctx.Pipe()
            rank_env = dict(RANK=first + i, WORLD_SIZE=world, LOCAL_RANK=i,
                            LOCAL_WORLD_SIZE=local, MASTER_ADDR=host, MASTER_PORT=port)
            proc = ctx.Process(target=_rank_main, daemon=True,
                               args=(theirs, {k: str(v) for k, v in rank_env.items()}, dev_type))
            proc.start()
            theirs.close()
            self._conns.append(ours)
            self._procs.append(proc)
        self._collect(timeout_s)  # every rank has joined the group

    def run(self, fn: Callable, *args) -> list:
        """``fn(*args)`` on every rank; their results, by local rank."""
        for conn in self._conns:
            conn.send((fn, args))
        return self._collect(self.timeout_s)

    def _collect(self, timeout_s: float) -> list:
        deadline = time.monotonic() + timeout_s
        results = [None] * len(self._conns)
        pending = set(range(len(self._conns)))
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self._kill()
                raise RuntimeError(f"ranks {sorted(self.first + i for i in pending)} did not "
                                   f"answer within {timeout_s} s; every rank was stopped")
            waits = {self._conns[i]: i for i in pending}
            waits.update({self._procs[i].sentinel: i for i in pending})
            for ready in multiprocessing.connection.wait(list(waits), left):
                i = waits[ready]
                if i not in pending:
                    continue
                status, value = ("died", None)
                if ready is self._conns[i] or self._conns[i].poll():
                    try:
                        status, value = self._conns[i].recv()
                    except EOFError:
                        pass
                if status != "ok":
                    code = self._procs[i].exitcode
                    self._kill()
                    how = "failed" if code is None else f"exited with code {code}"
                    raise RuntimeError(f"rank {self.first + i} {how}; every rank was "
                                       f"stopped:\n{value or ''}")
                results[i] = value
                pending.discard(i)
        return results

    def close(self) -> None:
        """Stop every rank: ask, then kill what has not exited in 10 s."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        deadline = time.monotonic() + 10.0
        for proc in self._procs:
            proc.join(max(deadline - time.monotonic(), 0.0))
        self._kill()

    def _kill(self) -> None:
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        self._store = None

    def __enter__(self) -> RankPool:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn_local(fn: Callable, local: int, device: str | torch.device | None = None,
                args: tuple = (), env: SliceEnv | None = None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """``fn(*args)`` once on each of ``local`` new ranks of this host (see
    ``RankPool``); their results, by local rank."""
    with RankPool(local, device, env, timeout_s) as pool:
        return pool.run(fn, *args)


def _die_with_parent() -> None:
    """Have the kernel kill this process when its launcher dies (Linux)."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def _rank_main(conn, rank_env: dict[str, str], dev_type: str) -> None:
    _die_with_parent()
    os.environ.update(rank_env)
    if dev_type == "cpu":
        torch.set_num_threads(1)
    try:
        initialize(dev_type)
        conn.send(("ok", None))
    except Exception:  # noqa: BLE001 -- reported to the launcher, which stops every rank
        conn.send(("error", traceback.format_exc()))
        return
    while True:
        try:
            job = conn.recv()
        except EOFError:
            break
        if job is None:
            break
        fn, args = job
        try:
            conn.send(("ok", fn(*args)))
        except Exception:  # noqa: BLE001 -- as above
            conn.send(("error", traceback.format_exc()))
    dist.destroy_process_group()
    # The rank holds nothing more to flush or close: skip the interpreter's
    # teardown of torch, which takes seconds a process.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
