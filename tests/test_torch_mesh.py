"""The PyTorch port's mesh helpers and slice env against the JAX package's:
``factorize``, ``host_bounds_from_env``, ``make_mesh`` (at 4 gloo ranks,
default and short shapes) and ``slice_env``'s parsing, defaults and raising
cases, with ``initialize`` in a single host.

The mesh over ranks runs on 4 rank processes of one ``RankPool``, which
import no JAX (``tests/torch_rank_jobs.py``).
"""

import pytest
import torch.distributed as dist

from k8s_device_plugin_tpu.parallel import distributed as jdist
from k8s_device_plugin_tpu.parallel import mesh as jmesh
from k8s_device_plugin_tpu_torch.parallel import distributed as tdist
from k8s_device_plugin_tpu_torch.parallel import mesh as tmesh
from tests import torch_rank_jobs as jobs

# The JAX factorize's results, at every count up to a 64-card slice.
COUNTS = list(range(1, 65))


@pytest.fixture(scope="module")
def pool4():
    with tdist.RankPool(4, "cpu", timeout_s=120.0) as pool:
        yield pool


def test_factorize_shapes():
    assert tmesh.factorize(1) == (1, 1, 1)
    assert tmesh.factorize(8) == (1, 2, 4)
    d, f, m = tmesh.factorize(12)
    assert d * f * m == 12 and m <= 4
    with pytest.raises(ValueError):
        tmesh.factorize(0)
    assert [tmesh.factorize(n) for n in COUNTS] == [jmesh.factorize(n) for n in COUNTS]


def test_axes_and_rules_are_the_jax_ones():
    assert tmesh.AXES == jmesh.AXES
    assert tmesh.LOGICAL_AXIS_RULES == jmesh.LOGICAL_AXIS_RULES


def test_host_bounds_from_env(monkeypatch):
    monkeypatch.setenv("TPU_CHIPS_PER_HOST_BOUNDS", "2,2,1")
    assert tmesh.host_bounds_from_env() == (2, 2, 1)
    monkeypatch.setenv("TPU_CHIPS_PER_HOST_BOUNDS", "garbage")
    assert tmesh.host_bounds_from_env() is None
    monkeypatch.delenv("TPU_CHIPS_PER_HOST_BOUNDS")
    assert tmesh.host_bounds_from_env() is None


@pytest.mark.parametrize(
    "shape,want",
    [
        (None, (1, 2, 1, 1, 1, 4)),
        ((2, 2, 2), (2, 2, 1, 1, 1, 2)),
        ((1, 2, 2, 2), (1, 2, 1, 1, 2, 2)),
        ((1, 1, 2, 2, 1, 2), (1, 1, 2, 2, 1, 2)),
    ],
)
def test_mesh_shape_fills_short_shapes_as_jax(shape, want):
    import jax

    assert tmesh.mesh_shape(8, shape) == want
    assert tuple(jmesh.make_mesh(jax.devices(), shape).shape.values()) == want


@pytest.mark.parametrize("shape", [(3, 1, 1), (1, 2, 1, 1, 1), (2, 2, 2, 1, 1, 1)])
def test_mesh_shape_refuses_what_does_not_fit(shape):
    with pytest.raises(ValueError):
        tmesh.mesh_shape(4, shape)


def test_make_mesh_over_four_ranks(pool4):
    """Default: factorize(4) = (1, 1, 4); ranks that differ only along
    model feed the same rows of the global batch."""
    reports = pool4.run(jobs.mesh_report, None)
    assert all(r["sizes"] == {"data": 1, "fsdp": 1, "expert": 1, "pipe": 1, "seq": 1,
                              "model": 4} for r in reports)
    assert [r["rows"] for r in reports] == [list(range(8))] * 4


@pytest.mark.parametrize(
    "shape,rows",
    [
        ((1, 2, 2), [[0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]]),
        ((2, 2, 1), [[0, 1], [2, 3], [4, 5], [6, 7]]),
        ((1, 1, 2, 2), [[0, 1, 2, 3, 4, 5, 6, 7]] * 4),
    ],
    ids=["fsdp-model", "data-fsdp", "seq-model"],
)
def test_make_mesh_short_shapes_and_batch_rows(pool4, shape, rows):
    reports = pool4.run(jobs.mesh_report, shape)
    full = tmesh.mesh_shape(4, shape)
    assert all(tuple(r["sizes"].values()) == full for r in reports)
    assert [r["rows"] for r in reports] == rows


def test_make_mesh_refuses_a_shape_off_the_world(pool4):
    refusal = "mesh shape (1, 2, 1, 1, 1, 1) != 4 devices"
    assert pool4.run(jobs.mesh_refusal, (1, 2, 1)) == [refusal] * 4


def test_slice_env_absent():
    assert tdist.slice_env({}) is None
    assert tdist.slice_env({"TPU_WORKER_HOSTNAMES": ""}) is None


def test_slice_env_parsing():
    raw = {"TPU_WORKER_HOSTNAMES": "host-a, host-b ,host-c", "TPU_WORKER_ID": "2",
           "TPU_COORDINATOR_PORT": "9000"}
    env = tdist.slice_env(raw)
    assert env == tdist.SliceEnv(2, ("host-a", "host-b", "host-c"), 9000)
    assert env.num_hosts == 3
    assert env.coordinator_address == "host-a:9000"
    assert dict(vars(env)) == dict(vars(jdist.slice_env(raw)))


def test_slice_env_defaults_single_host():
    env = tdist.slice_env({"TPU_WORKER_HOSTNAMES": "a"})
    assert env.worker_id == 0
    assert env.coordinator_port == tdist.DEFAULT_COORDINATOR_PORT == jdist.DEFAULT_COORDINATOR_PORT


@pytest.mark.parametrize(
    "raw,match",
    [
        ({"TPU_WORKER_HOSTNAMES": "a,b"}, "unset"),
        ({"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "5"}, "out of range"),
        ({"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "w1"}, "TPU_WORKER_ID"),
        ({"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "0", "TPU_COORDINATOR_PORT": "x"},
         "TPU_COORDINATOR_PORT"),
    ],
    ids=["missing-id", "id-out-of-range", "unparseable-id", "unparseable-port"],
)
def test_slice_env_raises_as_jax(raw, match):
    with pytest.raises(ValueError, match=match):
        tdist.slice_env(raw)
    with pytest.raises(ValueError, match=match):
        jdist.slice_env(raw)


def test_rank_layout_places_each_host():
    """One host needs no coordinator (the launcher's store takes a free
    port); on a slice, rank = worker_id x local + local_rank and the store
    is at the first host's coordinator port."""
    assert tdist.rank_layout(None, 2) == (2, 0, None)
    assert tdist.rank_layout(tdist.SliceEnv(0, ("only-host",)), 1) == (1, 0, None)
    env = tdist.SliceEnv(1, ("a", "b"), 9000)
    assert tdist.rank_layout(env, 4) == (8, 4, "a:9000")


def test_initialize_single_host_is_a_world_of_one(monkeypatch):
    """No launcher's environment: a world of one over an in-memory store
    (no port, no coordinator), and a second call is a no-op."""
    for var in tdist.RANK_ENV:
        monkeypatch.delenv(var, raising=False)
    was_up = dist.is_initialized()
    try:
        assert tdist.initialize("cpu") is False
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert tdist.initialize("cpu") is False
    finally:
        if not was_up:
            dist.destroy_process_group()
