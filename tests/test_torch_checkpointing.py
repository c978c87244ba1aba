"""The PyTorch port's checkpoint/resume (``workload/checkpointing.py``,
``workload/loop.py``) case by case against ``tests/test_checkpointing.py``,
and what DCP's layout must hold that orbax's gives the JAX package: no
tensor- or expert-parallel slice lost, a pipelined save, a killed save
never restored, and the beacon the JAX control plane reads.

A world of one runs in this process; the multi-rank cases run on the gloo
rank processes of two module ``RankPool``s (2 and 8 ranks, which import no
JAX), each job with its own deadline. Every restored value is held to the
saved one bit for bit: a checkpoint copies, it computes nothing.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch
from torch.distributed.checkpoint.api import CheckpointException
from torch.distributed.checkpoint.format_utils import dcp_to_torch_save

from k8s_device_plugin_tpu.workload.checkpointing import CheckpointBeacon as JaxBeacon
from k8s_device_plugin_tpu_torch.parallel.distributed import RankPool
from k8s_device_plugin_tpu_torch.parallel.mesh import make_mesh
from k8s_device_plugin_tpu_torch.workload import checkpointing, train
from k8s_device_plugin_tpu_torch.workload.checkpointing import CheckpointBeacon, TrainCheckpointer
from k8s_device_plugin_tpu_torch.workload.loop import run_training
from k8s_device_plugin_tpu_torch.workload.model import ModelConfig
from tests import torch_rank_jobs as jobs
from tests.fake_apiserver import FakeApiServer

JOB_TIMEOUT_S = 120.0
TINY = dataclasses.asdict(ModelConfig.tiny())


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, "cpu", timeout_s=JOB_TIMEOUT_S) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool8():
    with RankPool(8, "cpu", timeout_s=JOB_TIMEOUT_S) as pool:
        yield pool


def _state(cfg: ModelConfig, seed: int = 0):
    """A model on this process's world-of-one mesh and its optimizer."""
    return train.make_train_state(cfg, "cpu", seed, mesh=make_mesh(1, device="cpu"))


def _tokens(cfg_kw: dict, batch: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg_kw["vocab_size"],
                                                (batch, cfg_kw["max_seq_len"]))


def _read_whole(directory: str, tmp_path) -> dict:
    """The newest committed step read back whole, without a process group
    (DCP's own converter): ``params``, ``opt_state.{count,mu,nu}``."""
    step = max(int(n) for n in os.listdir(directory) if n.isdigit())
    out = str(tmp_path / f"whole-{step}.pt")
    dcp_to_torch_save(os.path.join(directory, str(step)), out)
    return torch.load(out, weights_only=False)


def _assert_whole_equal(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{what}: {name}")


def _assert_restored(saved: list, restored: list) -> None:
    """Every parameter (gathered whole on every rank) and every moment (of
    the parameters each rank holds) equal to the saved ones, bit for bit;
    every step count the saved one."""
    for r in restored:
        _assert_whole_equal(r["whole"]["params"], saved[0]["whole"]["params"], "params")
    want_mu = {k: v for s in saved for k, v in s["whole"]["moments"]["mu"].items()}
    want_nu = {k: v for s in saved for k, v in s["whole"]["moments"]["nu"].items()}
    names = set()
    for r in restored:
        moments = r["whole"]["moments"]
        names |= set(moments["mu"])
        for name in moments["mu"]:
            np.testing.assert_array_equal(moments["mu"][name], want_mu[name], err_msg=name)
            np.testing.assert_array_equal(moments["nu"][name], want_nu[name], err_msg=name)
        assert moments["steps"] == {1.0}
    assert names == set(want_mu)


def test_save_restore_roundtrip(tmp_path):
    """``tests/test_checkpointing.py::test_save_restore_roundtrip``: a fresh
    state saved at step 7 comes back as it was. The optimizer never
    stepped: it comes back with optax's initial state (zeros, count 0),
    and no parameter moved on the way."""
    cfg = ModelConfig.tiny()
    model, optimizer = _state(cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ckpt:
        assert ckpt.latest_step() is None
        assert ckpt.restore_latest(model, optimizer) is None
        assert ckpt.save(7, model, optimizer)
        ckpt.wait()
        model2, optimizer2 = _state(cfg, seed=1)
        step, m2, o2 = ckpt.restore_latest(model2, optimizer2)
    assert step == 7 and m2 is model2 and o2 is optimizer2
    for name, tensor in model2.state_dict().items():
        assert torch.equal(tensor, start[name]), name
        assert torch.equal(model.state_dict()[name], start[name]), name
    assert len(optimizer2.state) == len(list(model2.parameters()))
    for p in model2.parameters():
        state = optimizer2.state[p]
        assert float(state["step"]) == 0.0
        assert not state["exp_avg"].any() and not state["exp_avg_sq"].any()
    assert not optimizer.state  # saving created no state either


def test_retention_keeps_newest(tmp_path):
    """``test_retention_keeps_newest``: with ``max_to_keep`` 2, three saves
    leave the newest two, one directory a step."""
    model, optimizer = _state(ModelConfig.tiny())
    with TrainCheckpointer(str(tmp_path / "ckpt"), max_to_keep=2) as ckpt:
        for s in (1, 2, 3):
            ckpt.save(s, model, optimizer)
        ckpt.wait()
        assert ckpt.latest_step() == 3
        assert ckpt.committed_steps() == [2, 3]
        with pytest.raises(ValueError, match="already saved"):
            ckpt.save(3, model, optimizer)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "3"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_resume_continues_from_saved_step(tmp_path, dtype):
    """``test_resume_continues_from_saved_step``: an interrupted run and its
    resume give the loss stream of one long run. The JAX test allows 2e-2;
    the port's restore copies every value of the state (AdamW's step count
    included) and the token stream is seeded per step, so the stitched
    losses equal the uninterrupted ones bit for bit."""
    cfg = dataclasses.replace(ModelConfig.tiny(), dtype=dtype)
    ckpt_dir = str(tmp_path / "ckpt")
    kw = dict(batch_per_device=4, seed=0, device="cpu")
    full = run_training(cfg, steps=6, **kw)
    first = run_training(cfg, steps=3, checkpoint_dir=ckpt_dir, save_every=100, **kw)
    assert not first["resumed"] and first["start_step"] == 0
    second = run_training(cfg, steps=6, checkpoint_dir=ckpt_dir, save_every=100, **kw)
    assert second["resumed"] and second["start_step"] == 3
    assert second["restore_s"] is not None and len(second["save_s"]) == 1
    assert first["losses"] + second["losses"] == full["losses"]
    assert second["mesh"] == {a: 1 for a in second["mesh"]}


@pytest.mark.parametrize("shape", [(1, 2, 1, 1, 1, 1), (1, 1, 1, 1, 1, 2)],
                         ids=["fsdp2", "model2"])
def test_resume_on_two_ranks_continues_bit_for_bit(pool2, tmp_path, shape):
    """The same on two gloo ranks, FSDP2 shards or tensor-parallel slices
    of the f32 model and its moments: 3 + 3 steps equal 6."""
    kw = dict(TINY, dtype=torch.float32)
    ckpt_dir = str(tmp_path / "ckpt")
    full = pool2.run(jobs.resumed_training, kw, shape, "", 6)[0]
    first = pool2.run(jobs.resumed_training, kw, shape, ckpt_dir, 3)[0]
    second = pool2.run(jobs.resumed_training, kw, shape, ckpt_dir, 6)
    assert all(r["start_step"] == 3 for r in second)
    assert first["losses"] + second[0]["losses"] == full["losses"]


# The JAX test's config of test_restore_onto_bigger_mesh, and a width the
# fsdp axis of 8 does not divide (d_model 36): FSDP2 then shards the
# `embed` dims on dim 0, unevenly, where the JAX layout replicates them.
BIGGER = {
    "fsdp4-model2": (dict(TINY, d_model=64, n_heads=2), (1, 4, 1, 1, 1, 2)),
    "fsdp8-uneven": (dict(TINY, d_model=36, n_heads=2), (1, 8, 1, 1, 1, 1)),
}


@pytest.mark.parametrize("case", sorted(BIGGER))
def test_restore_onto_bigger_mesh(pool2, pool8, tmp_path, case):
    """``test_restore_onto_bigger_mesh``: saved on 2 ranks (fsdp 2, after
    one step), restored on 8 onto a model of other weights: every
    parameter and Adam moment is the saved one bit for bit, laid out as
    the new mesh lays it out (each local shape as before the restore), the
    checkpoint read whole holds the saver's state, and the next loss is
    finite."""
    kw, shape = BIGGER[case]
    directory = str(tmp_path / "ckpt")
    tokens = _tokens(kw, 16)
    saved = pool2.run(jobs.checkpoint_save, kw, (1, 2, 1, 1, 1, 1), tokens, directory)
    restored = pool8.run(jobs.checkpoint_restore, kw, shape, tokens, directory)
    assert all(r["step"] == 1 for r in restored)
    _assert_restored(saved, restored)
    for r in restored:
        before, after = r["local_shapes"]
        assert before == after
    wq = restored[0]["local_shapes"][1]["blocks.0.attn.wq"]
    d, h, k = kw["d_model"], kw["n_heads"], kw["d_model"] // kw["n_heads"]
    assert wq == ((d // 4, h // 2, k) if case == "fsdp4-model2" else (math.ceil(d / 8), h, k))
    whole = _read_whole(directory, tmp_path)
    _assert_whole_equal({k: v.numpy() for k, v in whole["params"].items()},
                        saved[0]["whole"]["params"], "checkpoint params")
    _assert_whole_equal({k: v.numpy() for k, v in whole["opt_state"]["mu"].items()},
                        saved[0]["whole"]["moments"]["mu"], "checkpoint mu")
    assert float(whole["opt_state"]["count"]) == 1.0
    assert all(np.isfinite(r["losses"][0]) for r in restored)


def test_model_split_save_restores_whole_on_one(pool2, tmp_path):
    """Saved with the tensor-parallel slices of ``model`` 2 (plain local
    tensors, a different one on each rank), restored on a world of one:
    both halves of every split parameter and moment come back. The next
    step's loss is the two-rank run's next loss (f32; the TP sums add in
    another order)."""
    kw = dict(TINY, dtype=torch.float32)
    directory = str(tmp_path / "ckpt")
    tokens = _tokens(kw, 4)
    saved = pool2.run(jobs.checkpoint_save, kw, (1, 1, 1, 1, 1, 2), tokens, directory, 1, 1)
    restored = jobs.checkpoint_restore(kw, (1,) * 6, tokens, directory)
    assert restored["step"] == 1
    _assert_restored(saved, [restored])
    assert restored["losses"][0] == pytest.approx(saved[0]["later_losses"][0], rel=1e-5)


@pytest.mark.parametrize("target", [(1,) * 6, (2, 1, 1, 2, 1, 2)], ids=["one", "dp2-pp2-tp2"])
def test_pipelined_save_restores(pool2, pool8, tmp_path, target):
    """Saved on ``pipe`` 2 (each rank holds and writes its stage's block),
    restored on a world of one and on dryrun plan C's mesh (data 2 x pipe
    2 x model 2): every block and its moments come back, bit for bit."""
    kw = dict(TINY, n_layers=2, pipeline_microbatches=2)
    directory = str(tmp_path / "ckpt")
    tokens = _tokens(kw, 8)
    saved = pool2.run(jobs.checkpoint_save, kw, (1, 1, 1, 2, 1, 1), tokens, directory)
    assert set(saved[0]["whole"]["moments"]["mu"]) != set(saved[1]["whole"]["moments"]["mu"])
    if target == (1,) * 6:
        restored = [jobs.checkpoint_restore(kw, target, tokens, directory)]
    else:
        restored = pool8.run(jobs.checkpoint_restore, kw, target, tokens, directory)
    assert all(r["step"] == 1 for r in restored)
    _assert_restored(saved, restored)


def test_killed_save_is_never_restored(tmp_path):
    """A save killed before its commit leaves ``<step>.tmp``: the latest
    step and the restore skip it, and the next save of that step clears it
    and commits."""
    directory = tmp_path / "ckpt"
    model, optimizer = _state(ModelConfig.tiny())
    with TrainCheckpointer(str(directory)) as ckpt:
        ckpt.save(1, model, optimizer)
        # The files of step 2, written but never committed.
        state = checkpointing._state_dict(model, optimizer, checkpointing._Layout(model))
        torch.distributed.checkpoint.save(state, checkpoint_id=str(directory / "2.tmp"))
        assert sorted(os.listdir(directory)) == ["1", "2.tmp"]
        assert ckpt.latest_step() == 1
        model2, optimizer2 = _state(ModelConfig.tiny(), seed=1)
        assert ckpt.restore_latest(model2, optimizer2)[0] == 1
        ckpt.save(2, model, optimizer)
        assert ckpt.latest_step() == 2
    assert sorted(os.listdir(directory)) == ["1", "2"]


def test_restore_refuses_a_checkpoint_of_another_model(tmp_path):
    """A restore that cannot fill the live state raises; nothing falls back
    to a fresh start."""
    model, optimizer = _state(ModelConfig.tiny())
    with TrainCheckpointer(str(tmp_path / "ckpt")) as ckpt:
        ckpt.save(1, model, optimizer)
        other, other_opt = _state(dataclasses.replace(ModelConfig.tiny(), n_layers=2))
        with pytest.raises(CheckpointException):
            ckpt.restore_latest(other, other_opt)


def test_async_save_commits_before_the_beacon_stamps(tmp_path):
    """``async_save``: the save runs behind the next steps, counts as the
    latest step while in flight, and is committed before the beacon
    stamps; its restore is the state it saved."""
    directory = tmp_path / "ckpt"
    stamps = []

    def stamp(ann: dict) -> None:
        stamps.append((dict(ann), sorted(os.listdir(directory))))

    cfg = ModelConfig.tiny()
    model, optimizer = _state(cfg)
    tokens = torch.from_numpy(_tokens(TINY, 4)).long()
    train.train_step(model, optimizer, tokens)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with TrainCheckpointer(str(directory), async_save=True) as ckpt:
        ckpt.save(1, model, optimizer)
        assert ckpt.latest_step() == 1
        train.train_step(model, optimizer, tokens)  # the live state moves on
        ckpt.wait()
        ckpt.beacon = CheckpointBeacon(stamp)
        ckpt.save(2, model, optimizer)
        model2, optimizer2 = _state(cfg, seed=1)
        ckpt_dir_steps = ckpt.committed_steps()
    assert ckpt_dir_steps == [1, 2]
    assert len(stamps) == 1 and stamps[0][1] == ["1", "2"]
    assert CheckpointBeacon.ANNOTATION in stamps[0][0]
    with TrainCheckpointer(str(directory)) as ckpt:
        os.rename(directory / "2", directory / "2.tmp")  # as if step 2 never committed
        assert ckpt.restore_latest(model2, optimizer2)[0] == 1
    for name, tensor in model2.state_dict().items():
        assert torch.equal(tensor, saved[name]), name


def test_beacon_stamps_a_pod_the_jax_control_plane_reads(tmp_path):
    """The port's beacon, bound to a pod of the fake API server through the
    JAX package's ``KubeClient``, stamps the annotation after a committed
    save; the JAX ``CheckpointBeacon.age_from`` (the extender's one parser)
    reads it as seconds old. A dead API server costs the stamp only."""
    from k8s_device_plugin_tpu.api import constants
    from k8s_device_plugin_tpu.kube.client import KubeClient, KubeError

    assert checkpointing.CHECKPOINT_TS_ANNOTATION == constants.CHECKPOINT_TS_ANNOTATION
    server = FakeApiServer()
    url = server.start()
    try:
        server.add_pod({"metadata": {"name": "w0", "namespace": "default", "annotations": {}},
                        "spec": {"nodeName": "n1"}, "status": {"phase": "Running"}})
        beacon = CheckpointBeacon.for_pod(KubeClient(url), namespace="default", name="w0")
        model, optimizer = _state(ModelConfig.tiny())
        with TrainCheckpointer(str(tmp_path / "ckpt"), beacon=beacon) as ckpt:
            ckpt.save(5, model, optimizer)
        ann = server.pods[("default", "w0")]["metadata"]["annotations"]
        age = JaxBeacon.age_from(ann)
        assert age is not None and 0.0 <= age < 5.0
        assert float(ann[constants.CHECKPOINT_TS_ANNOTATION]) == beacon.last_stamped
    finally:
        server.stop()
    bad = CheckpointBeacon(lambda ann: (_ for _ in ()).throw(KubeError(500, "down")))
    assert bad.note_saved(6) is False and bad.last_stamped is None


def test_beacon_for_pod_reads_the_downward_api(monkeypatch):
    """``for_pod`` takes POD_NAMESPACE / POD_NAME, and binds nothing when
    the pod's name is unknown."""
    calls = []

    class Client:
        def patch_pod_annotations(self, ns, name, ann):
            calls.append((ns, name, ann))

    monkeypatch.delenv("POD_NAME", raising=False)
    monkeypatch.delenv("POD_NAMESPACE", raising=False)
    assert CheckpointBeacon.for_pod(Client()) is None
    monkeypatch.setenv("POD_NAME", "w1")
    assert CheckpointBeacon.for_pod(Client()).note_saved(3)
    monkeypatch.setenv("POD_NAMESPACE", "team")
    assert CheckpointBeacon.for_pod(Client()).note_saved(4)
    assert [(ns, name) for ns, name, _ in calls] == [("default", "w1"), ("team", "w1")]
    assert all(set(ann) == {ANN} for _, _, ann in calls)


NOW = 1_700_000_000.0
ANN = "tpu.google.com/last-checkpoint"


@pytest.mark.parametrize("annotations", [
    None, {}, {"other": "1"}, {ANN: ""}, {ANN: None}, {ANN: "junk"}, {ANN: "1e400"},
    {ANN: str(NOW - 30.5)}, {ANN: str(NOW + 100)}, {ANN: f"{NOW - 7:.3f}"},
], ids=["none", "empty", "missing", "blank", "null", "junk", "inf", "past", "skew", "ms"])
def test_age_from_reads_as_the_jax_parser(annotations):
    """``age_from`` against the JAX one on junk, negative-skew (clamped to
    0) and missing inputs."""
    assert CheckpointBeacon.age_from(annotations, now=NOW) == JaxBeacon.age_from(annotations,
                                                                                 now=NOW)


def test_run_training_zero_step_resume_closes(tmp_path):
    """A resume with nothing left to run trains nothing, saves nothing and
    still closes its checkpointer (the JAX loop's ``finally``)."""
    cfg = ModelConfig.tiny()
    ckpt_dir = str(tmp_path / "ckpt")
    run_training(cfg, steps=2, batch_per_device=2, checkpoint_dir=ckpt_dir, device="cpu")
    again = run_training(cfg, steps=2, batch_per_device=2, checkpoint_dir=ckpt_dir, device="cpu")
    assert again["resumed"] and again["losses"] == [] and again["save_s"] == []
    assert again["first_loss"] is None and again["start_step"] == 2
    assert sorted(os.listdir(ckpt_dir)) == ["0", "1"]

