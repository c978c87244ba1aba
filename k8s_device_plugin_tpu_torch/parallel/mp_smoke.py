"""Multi-process smoke: a process group over several localhost "hosts",
each a process with its own ranks, on the CPU over gloo. The counterpart
of the JAX package's ``parallel/mp_smoke.py``.

It drives the multi-host wiring a one-host run never does: the store
hosted by worker 0 at the coordinator port the plugin-style env names, the
ranks of every host placed in one world, and each host feeding only its
own rows (``distributed.shard_host_batch``). The sharded train step's
gradient reduction crosses the process boundary.

* ``main()``: one host (``python -m
  k8s_device_plugin_tpu_torch.parallel.mp_smoke``). It reads the slice from
  TPU_WORKER_HOSTNAMES / TPU_WORKER_ID / TPU_COORDINATOR_PORT, starts
  MP_SMOKE_LOCAL_DEVICES ranks (default 2), builds the global mesh (fsdp
  spanning every rank unless MP_SMOKE_MESH_SHAPE gives another six-axis
  shape) and takes one sharded step of ``ModelConfig.tiny()``, then prints
  ``mp_smoke worker=<id> loss=<loss>``.
* ``launch_local(n)``: starts n such hosts against one coordinator port,
  checks that every host exits 0 and all agree on the loss, and returns
  it. A failed host gets the others killed at once.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _host_step(shape: tuple[int, ...], worker_id: int, local: int) -> float:
    """One rank's part: the sharded step on this host's rows."""
    from ..workload import train
    from ..workload.model import ModelConfig
    from . import distributed

    mesh = distributed.global_mesh(shape, device="cpu")
    cfg = ModelConfig.tiny()
    model, optimizer = train.make_train_state(cfg, "cpu", seed=0, mesh=mesh)
    local_batch = np.random.default_rng(worker_id).integers(
        0, cfg.vocab_size, (2 * local, cfg.max_seq_len), dtype=np.int64
    )
    tokens = distributed.shard_host_batch(local_batch, mesh)
    return float(train.train_step(model, optimizer, tokens))


def main() -> None:
    from . import distributed

    env = distributed.slice_env()
    if env is None or env.num_hosts < 2:
        raise SystemExit(f"mp_smoke needs a multi-host slice env, got {env}")
    local = int(os.environ.get("MP_SMOKE_LOCAL_DEVICES", "2"))
    total = env.num_hosts * local
    raw_shape = os.environ.get("MP_SMOKE_MESH_SHAPE", "")
    # Default: fsdp spans every rank, so parameter shards and the gradient
    # reduction both cross the process boundary.
    shape = tuple(int(x) for x in raw_shape.split(",")) if raw_shape else (1, total, 1, 1, 1, 1)
    losses = distributed.spawn_local(_host_step, local, "cpu",
                                     (shape, env.worker_id, local), env=env)
    if len(set(losses)) != 1:
        raise SystemExit(f"the ranks of worker {env.worker_id} disagree on the loss: {losses}")
    print(f"mp_smoke worker={env.worker_id} loss={losses[0]:.6f}", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(
    num_processes: int = 2,
    local_devices: int = 2,
    timeout_s: float = 300.0,
    port: int | None = None,
    mesh_shape: tuple[int, ...] | None = None,
) -> float:
    """Run the multi-process smoke on localhost; returns the agreed loss.

    Raises RuntimeError (with every failed host's output) when hosts fail
    or disagree on the loss: a disagreement would mean the reduction did
    not span the processes. The coordinator port is probed and released
    before worker 0 binds it, so another process can take it in between;
    a failed round is retried once on a fresh port, unless the caller
    pinned ``port``."""
    last_err: RuntimeError | None = None
    for _ in range(2 if port is None else 1):
        try:
            return _launch_once(num_processes, local_devices, timeout_s,
                                _free_port() if port is None else port, mesh_shape)
        except RuntimeError as e:
            last_err = e
    raise last_err


def _launch_once(num_processes: int, local_devices: int, timeout_s: float, port: int,
                 mesh_shape: tuple[int, ...] | None) -> float:
    from .distributed import RANK_ENV

    hosts = ",".join(["127.0.0.1"] * num_processes)
    procs = []
    for wid in range(num_processes):
        env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
        env.update(
            TPU_WORKER_HOSTNAMES=hosts,
            TPU_WORKER_ID=str(wid),
            TPU_COORDINATOR_PORT=str(port),
            MP_SMOKE_LOCAL_DEVICES=str(local_devices),
            PYTHONPATH=_REPO + os.pathsep + env.get("PYTHONPATH", ""),
        )
        if mesh_shape is not None:
            env["MP_SMOKE_MESH_SHAPE"] = ",".join(str(x) for x in mesh_shape)
        # Each host in a session of its own, so that killing it kills its
        # ranks too.
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "k8s_device_plugin_tpu_torch.parallel.mp_smoke"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True,
        ))
    # Fail fast: one host dying (worker 0 at a taken port, say) leaves the
    # others waiting at the store until their timeout, so the survivors are
    # killed as soon as the first failure shows.
    deadline = time.monotonic() + timeout_s
    failed = False
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if any(c is not None and c != 0 for c in codes):
            failed = True
            break
        if all(c == 0 for c in codes):
            break
        time.sleep(0.2)
    else:
        failed = True  # the deadline passed with hosts still running
    outs, fails = [], []
    for wid, p in enumerate(procs):
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        if p.returncode != 0:
            fails.append(f"worker {wid} rc={p.returncode}\n{out}\n{err}")
        else:
            outs.append(out.strip().splitlines()[-1])
    if failed and not fails:
        fails.append("hosts killed at the deadline with no failure output")
    if fails:
        raise RuntimeError("mp_smoke failed:\n" + "\n---\n".join(fails))
    losses = {o.split("loss=")[1] for o in outs}
    if len(losses) != 1:
        raise RuntimeError(f"workers disagree on loss: {outs}")
    return float(losses.pop())


if __name__ == "__main__":
    main()
