"""The port's card placement (topology/placement.py) against the JAX
package's: the same bookkeeping on every generated operation sequence, and
a pick that equals a brute-force search of the best average pair score on
generated link tables (NVLink and PCIe classes mixed)."""

import itertools

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from k8s_device_plugin_tpu.discovery.scanner import PyTpuInfo
from k8s_device_plugin_tpu.topology.mesh import IciMesh
from k8s_device_plugin_tpu.topology.placement import PlacementState
from k8s_device_plugin_tpu_torch.discovery import nvml
from k8s_device_plugin_tpu_torch.discovery.chips import GpuChip
from k8s_device_plugin_tpu_torch.topology import placement
from k8s_device_plugin_tpu_torch.topology.links import LinkTopology
from k8s_device_plugin_tpu_torch.topology.placement import GpuPlacementState
from tests import fakes

# (NVLinks, PCIe level) of each class the tables mix: NV18, NV2, PIX, PHB, SYS.
CLASSES = {
    "NV18": (18, nvml.TOPOLOGY_NODE),
    "NV2": (2, nvml.TOPOLOGY_SYSTEM),
    "PIX": (0, nvml.TOPOLOGY_SINGLE),
    "PHB": (0, nvml.TOPOLOGY_HOSTBRIDGE),
    "SYS": (0, nvml.TOPOLOGY_SYSTEM),
}


class Table:
    """A link table standing in for NVML: ``pair_link`` by card index."""

    def __init__(self, links):
        self.links = links  # {(a, b) with a < b: class name}

    def pair_link(self, a, b):
        return CLASSES[self.links[(min(a, b), max(a, b))]]


def cards(n):
    return [GpuChip(index=i, uuid=f"GPU-{i:02d}", name="NVIDIA H100 80GB HBM3",
                    dev_path=f"/dev/nvidia{i}", pci_addr="", numa_node=-1, chip_type="H100",
                    hbm_bytes=80 * 2 ** 30)
            for i in range(n)]


def topology(n, links):
    return LinkTopology(cards(n), Table(links))


def jax_mesh(root, chip_type, count):
    accel, dev = fakes.make_fake_tpu_node(str(root), chip_type, count)
    return IciMesh(PyTpuInfo().scan(accel, dev))


def mesh_table(mesh):
    """The NVLink graph of a TPU host's ICI links: NV2 where two chips are
    ICI neighbours, SYS elsewhere, card i for the mesh's i-th chip."""
    ids = mesh.ids
    return {(a, b): "NV2" if ids[b] in mesh.neighbors(ids[a]) else "SYS"
            for a, b in itertools.combinations(range(len(ids)), 2)}


def oracle(topo, n, pool, must=()):
    """Brute force: the best average score over every n-subset of the pool
    holding ``must``, ties by NVLink pairs inside, then by sorted ids."""
    best = None
    for combo in itertools.combinations(sorted(set(pool) | set(must)), n):
        if not set(must) <= set(combo):
            continue
        key = (-topo.set_score(combo), -topo.internal_links(combo), sorted(combo))
        best = key if best is None or key < best else best
    return [] if best is None else best[2]


# -- bookkeeping: the same as the JAX PlacementState ------------------------

OPS = st.lists(
    st.one_of(
        st.tuples(st.just("allocate"), st.lists(st.integers(-1, 7), max_size=4)),
        st.tuples(st.just("free"), st.lists(st.integers(-1, 7), max_size=4)),
        st.tuples(st.just("set_health"), st.integers(-1, 7), st.booleans()),
        st.tuples(st.just("reset"), st.lists(st.integers(0, 7), max_size=3),
                  st.lists(st.integers(0, 7), max_size=3)),
    ),
    max_size=25,
)

@pytest.fixture(scope="module")
def mesh8(tmp_path_factory):
    return jax_mesh(tmp_path_factory.mktemp("v5e"), "v5e", 8)


@settings(max_examples=60, deadline=None)
@given(ops=OPS)
def test_bookkeeping_equals_jax_placement_state(mesh8, ops):
    jax_state = PlacementState(mesh8)
    topo = topology(8, mesh_table(mesh8))
    port = GpuPlacementState(topo)
    # Card i is the mesh's i-th chip; -1 is an id neither side knows.
    jid = {i: mesh8.ids[i] for i in range(8)} | {-1: "unknown"}
    pid = {i: topo.ids[i] for i in range(8)} | {-1: "unknown"}
    to_port = {jid[i]: pid[i] for i in jid}
    for op in ops:
        if op[0] == "set_health":
            assert jax_state.set_health(jid[op[1]], op[2]) == port.set_health(pid[op[1]], op[2])
        elif op[0] == "reset":
            jax_state.reset([jid[i] for i in op[1]], [jid[i] for i in op[2]])
            port.reset([pid[i] for i in op[1]], [pid[i] for i in op[2]])
        else:
            getattr(jax_state, op[0])([jid[i] for i in op[1]])
            getattr(port, op[0])([pid[i] for i in op[1]])
        assert {to_port[i] for i in jax_state.allocated} == port.allocated
        assert {to_port[i] for i in jax_state.unhealthy} == port.unhealthy
        assert [to_port[i] for i in jax_state.available()] == port.available()


# -- select: the best average score -----------------------------------------

TABLES = st.integers(2, 8).flatmap(lambda n: st.tuples(
    st.just(n),
    st.fixed_dictionaries({p: st.sampled_from(sorted(CLASSES))
                           for p in itertools.combinations(range(n), 2)}),
))


@settings(max_examples=60, deadline=None)
@given(TABLES, st.data())
def test_select_equals_the_brute_force_best_score(table, data):
    n, links = table
    topo = topology(n, links)
    state = GpuPlacementState(topo)
    pool = data.draw(st.lists(st.sampled_from(topo.ids), unique=True, min_size=1))
    for k in range(2, len(pool) + 1):
        got = state.select(k, available=pool)
        assert got == oracle(topo, k, pool)
        assert topo.set_score(got) == max(topo.set_score(c)
                                          for c in itertools.combinations(pool, k))


@settings(max_examples=40, deadline=None)
@given(TABLES, st.data())
def test_select_honours_must_include(table, data):
    n, links = table
    topo = topology(n, links)
    state = GpuPlacementState(topo)
    pool = data.draw(st.lists(st.sampled_from(topo.ids), unique=True, min_size=1))
    must = data.draw(st.lists(st.sampled_from(topo.ids), unique=True, max_size=2))
    for k in range(1, n + 1):
        got = state.select(k, available=pool, must_include=must)
        if len(set(pool) | set(must)) < k or len(must) > k:
            assert got == []
            continue
        assert set(must) <= set(got) and len(got) == k
        if k > 1:
            assert got == oracle(topo, k, pool, must)


def test_select_returns_nothing_when_over_asked():
    topo = topology(4, {p: "NV18" for p in itertools.combinations(range(4), 2)})
    state = GpuPlacementState(topo)
    assert state.select(5) == []
    assert state.select(0) == []
    assert state.select(3, available=topo.ids[:2]) == []
    state.allocate(topo.ids[:2])
    state.set_health(topo.ids[2], False)
    assert state.select(2) == []  # only one card left to the state
    assert state.select(2, available=topo.ids) == []  # the kubelet's stale view
    assert state.select(1, available=topo.ids) == [topo.ids[3]]


def test_one_card_is_picked_corner_first():
    # 0-1-2 joined by NVLink in a line, 3 alone on PCIe: 3 has no NVLink
    # neighbour, then 0 and 2 have one each.
    links = {p: "SYS" for p in itertools.combinations(range(4), 2)}
    links[(0, 1)] = links[(1, 2)] = "NV18"
    topo = topology(4, links)
    state = GpuPlacementState(topo)
    assert state.select(1) == [topo.ids[3]]
    assert state.select(1, available=topo.ids[:3]) == [topo.ids[0]]
    assert state.select(1, available=topo.ids[1:3]) == [topo.ids[1]]


def test_greedy_growth_beyond_the_exhaustive_limit(monkeypatch):
    """Past EXHAUSTIVE_MAX sets the pick grows by score, from the card
    scoring highest to the pool: two NVLink islands of 3 and 5 cards."""
    links = {p: "SYS" for p in itertools.combinations(range(8), 2)}
    for island in ((0, 1, 2), (3, 4, 5, 6, 7)):
        for a, b in itertools.combinations(island, 2):
            links[(a, b)] = "NV18"
    topo = topology(8, links)
    state = GpuPlacementState(topo)
    exhaustive = state.select(4)
    monkeypatch.setattr(placement, "EXHAUSTIVE_MAX", 1)
    grown = state.select(4)
    assert grown == exhaustive == topo.ids[3:7]
    assert state.select(3, must_include=[topo.ids[0]]) == topo.ids[0:3]


@pytest.mark.parametrize("chip_type", ["v5p", "v4"])
def test_pick_on_a_tpu_host_graph_has_no_fewer_links_than_jax(tmp_path, chip_type):
    """Where the NVLink graph is a 2x2 TPU host's ICI graph, every pick over
    every pool has at least as many links inside as the JAX box pick."""
    mesh = jax_mesh(tmp_path, chip_type, 4)
    topo = topology(4, mesh_table(mesh))
    jax_state, port = PlacementState(mesh), GpuPlacementState(topo)
    to_port = dict(zip(mesh.ids, topo.ids))
    for size in range(1, 5):
        for pool in itertools.combinations(range(4), size):
            for k in range(1, size + 1):
                jax_pick = jax_state.select(k, available=[mesh.ids[i] for i in pool])
                port_pick = port.select(k, available=[topo.ids[i] for i in pool])
                assert len(port_pick) == len(jax_pick) == k
                assert topo.internal_links(port_pick) >= topo.internal_links(
                    [to_port[i] for i in jax_pick])


def test_sixteen_cards_search_every_set_quickly():
    """C(16, 8) sets, scored at once: an HGX node of two 8-card NVSwitch
    planes, the best 8 lie inside one plane."""
    links = {(a, b): "NV18" if a // 8 == b // 8 else "SYS"
             for a, b in itertools.combinations(range(16), 2)}
    topo = topology(16, links)
    assert GpuPlacementState(topo).select(8) == topo.ids[:8]
