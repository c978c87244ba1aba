"""The PyTorch port's multi-host runtime (``parallel/distributed.py`` and
``parallel/mp_smoke.py``) against the JAX package's
``tests/test_distributed.py``: two localhost "hosts", each a process with
two gloo ranks, one store at worker 0's coordinator port, a global mesh
with data across the hosts and fsdp within each, and one sharded step whose
gradient reduction crosses the process boundary. Each host feeds only its
own rows (``shard_host_batch``).
"""

import math
import socket
import time

import numpy as np
import pytest
import torch

from k8s_device_plugin_tpu_torch.parallel import distributed, mp_smoke
from k8s_device_plugin_tpu_torch.workload import smoke, train
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig
from tests import torch_rank_jobs as jobs


def test_two_process_train_step_matches_one_process():
    """Both hosts agree on the loss (``launch_local`` checks it), and it is
    the loss of one process's step on the same global rows, within 1e-4
    relative (the JAX sharded test's bound): host w's rows are
    ``default_rng(w)``'s, and host 0's ranks feed the first half."""
    loss = mp_smoke.launch_local(num_processes=2, local_devices=2,
                                 mesh_shape=(2, 2, 1, 1, 1, 1), timeout_s=120.0)
    cfg = ModelConfig.tiny()
    rows = np.concatenate([
        np.random.default_rng(w).integers(0, cfg.vocab_size, (4, cfg.max_seq_len))
        for w in (0, 1)
    ])
    model, optimizer = train.make_train_state(cfg, "cpu", seed=0)
    single = float(train.train_step(model, optimizer, torch.from_numpy(rows).long()))
    assert math.isfinite(loss)
    assert loss == pytest.approx(single, rel=1e-4)


def test_mp_smoke_fails_fast_when_coordinator_port_taken():
    """A coordinator that cannot start must not stall the smoke for the
    whole deadline: with the port bound first, worker 0 dies at startup,
    and the launcher kills the other host and raises well before it."""
    with socket.socket() as blocker:
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        port = blocker.getsockname()[1]
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="mp_smoke failed"):
            mp_smoke.launch_local(num_processes=2, local_devices=1, timeout_s=240.0, port=port)
        assert time.monotonic() - t0 < 120


def test_a_failing_rank_stops_every_rank_well_before_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*fails on purpose"):
        distributed.spawn_local(jobs.fail_on_rank, 2, "cpu", (1, 300.0), timeout_s=240.0)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize(
    "cards,hosts,spawned",
    [(4, "", 4), (1, "host-a,host-b", 1), (1, "", None)],
    ids=["four-cards", "one-card-a-host-of-two", "one-card"],
)
def test_pod_entry_starts_one_rank_per_visible_card(monkeypatch, capsys, cards, hosts, spawned):
    """``main`` on the card: one rank per visible card (or per card of
    each host of a slice) through ``spawn_local``; one card on one host
    runs in the pod's own process. The launcher prints the first rank's
    report and exits by its verdict."""
    calls = []

    def fake_spawn(fn, local, device, args, env=None, timeout_s=None):
        calls.append((fn, local, env.num_hosts if env else None))
        return [{"ok": True, "rank": i} for i in range(local)]

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(smoke, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(smoke.distributed, "spawn_local", fake_spawn)
    monkeypatch.setattr(smoke, "build_all", lambda: {})
    monkeypatch.setattr(smoke, "_rank_smoke", lambda kwargs, stream: {"ok": True, "rank": 0})
    for var in distributed.RANK_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", hosts)
    monkeypatch.setenv("TPU_WORKER_ID", "0")
    assert smoke.main(["--steps", "1", "--no-stream"]) == 0
    if spawned is None:
        assert calls == []
    else:
        assert [(local, n_hosts) for _, local, n_hosts in calls] == [
            (spawned, 2 if hosts else None)]
    assert capsys.readouterr().out.strip() == '{"ok": true, "rank": 0}'
