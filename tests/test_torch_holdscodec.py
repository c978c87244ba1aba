"""The port's shard-holds wire (extender/holdscodec.py) against the JAX one.

The scenarios of the JAX ``tests/test_holdscodec.py``, parametrised over the
two planes: the round trip, the JSON form still read, the lenient JSON
validation, every structural fault decoding to the empty overlay, the
digest memo and the density. 9 of its 10 tests have a case here.
``test_env_escape_hatch_pins_json_wire`` has none: the port's writer has no
``TPU_SHARD_HOLDS_WIRE`` hatch, since no reader of the port's leases knows
only JSON; ``test_port_writer_emits_binary_whatever_the_environment`` holds
that in its place. Across the planes: each plane's payload decodes in the
other to the same records, and the two encoders agree byte for byte.
"""

import base64
import json
import random

import pytest

from k8s_device_plugin_tpu.extender import holdscodec as jax_codec
from k8s_device_plugin_tpu_torch.extender import holdscodec as torch_codec
from k8s_device_plugin_tpu_torch.utils import metrics

CODECS = {"jax": jax_codec, "torch": torch_codec}


@pytest.fixture(params=sorted(CODECS))
def codec(request):
    c = CODECS[request.param]
    c.clear_memo()
    yield c
    c.clear_memo()


def _random_recs(rng, n_recs, n_hosts):
    hosts = [f"gpu-host-{i}.cell" for i in range(n_hosts)]
    recs = []
    for i in range(n_recs):
        held = {h: rng.randint(1, 16)
                for h in rng.sample(hosts, rng.randint(1, min(8, n_hosts)))}
        recs.append({"namespace": rng.choice(["default", "ml-team", "prod"]),
                     "gang": f"gang-{i}", "hosts": held})
    return recs


def test_round_trip_random_overlays(codec):
    rng = random.Random(0x7B5)
    for _ in range(50):
        recs = _random_recs(rng, rng.randint(0, 12), rng.randint(1, 40))
        raw = codec.encode_holds(recs)
        assert raw.startswith("tpb1:")
        codec.clear_memo()
        assert codec.decode_holds(raw) == recs


EDGE_SHAPES = (
    [],
    [{"namespace": "", "gang": "", "hosts": {}}],
    [{"namespace": "", "gang": "", "hosts": {"n1": 3, "n2": 1}}],
    [{"namespace": "ns", "gang": "g", "hosts": {"h": 2**40}}],
    [{"namespace": "üñï-ns", "gang": "gang/φ", "hosts": {"hôst": 1}}],
)


def test_round_trip_edge_shapes(codec):
    for recs in EDGE_SHAPES:
        raw = codec.encode_holds(recs)
        codec.clear_memo()
        assert codec.decode_holds(raw) == recs


def test_json_wire_still_decodes(codec):
    recs = [{"namespace": "default", "gang": "g", "hosts": {"n1": 4}}]
    assert codec.decode_holds(json.dumps(recs)) == recs
    assert codec.decode_holds("[]") == []


def test_json_wire_lenient_validation_preserved(codec):
    raw = json.dumps([
        {"namespace": 7, "gang": None, "hosts": {"n1": 2, "n2": 0, "n3": "x"}},
        {"namespace": "ok", "gang": "g", "hosts": "nope"},
    ])
    assert codec.decode_holds(raw) == [{"namespace": "7", "gang": "None", "hosts": {"n1": 2}}]


def test_version_skew_decodes_empty(codec):
    packed = bytearray(codec.pack_holds([{"namespace": "d", "gang": "g", "hosts": {"n1": 4}}]))
    packed[0] = 2  # a later version this reader does not know
    assert codec.decode_holds("tpb1:" + base64.b64encode(bytes(packed)).decode("ascii")) == []


def test_truncation_at_every_byte_decodes_empty(codec):
    recs = [{"namespace": "default", "gang": "a", "hosts": {"n1": 2, "n2": 1}},
            {"namespace": "default", "gang": "b", "hosts": {"n1": 1}}]
    packed = codec.pack_holds(recs)
    for cut in range(len(packed)):
        raw = "tpb1:" + base64.b64encode(packed[:cut]).decode("ascii")
        codec.clear_memo()
        assert codec.decode_holds(raw) == [], f"cut at {cut}"
    raw = "tpb1:" + base64.b64encode(packed + b"\x00").decode("ascii")
    codec.clear_memo()
    assert codec.decode_holds(raw) == []


def test_corrupt_base64_and_garbage_decode_empty(codec):
    for raw in ("tpb1:!!!not-base64!!!", "tpb1:", "not json at all", "{", ""):
        assert codec.decode_holds(raw) == []


def test_decode_memo_returns_cached_object(codec):
    recs = [{"namespace": "d", "gang": "g", "hosts": {"n1": 4}}]
    raw = codec.encode_holds(recs)
    first = codec.decode_holds(raw)
    assert codec.decode_holds(raw) is first
    codec.clear_memo()
    assert codec.decode_holds(raw) is not first


def test_binary_wire_denser_than_json_at_fleet_scale(codec):
    recs = _random_recs(random.Random(0xF1EE7), 200, 64)
    assert len(codec.encode_holds(recs)) * 2 < len(json.dumps(recs))


def test_port_writer_emits_binary_whatever_the_environment(monkeypatch):
    """In place of the JAX hatch's test: ``TPU_SHARD_HOLDS_WIRE=json`` moves
    the JAX writer to JSON and leaves the port's binary."""
    recs = [{"namespace": "d", "gang": "g", "hosts": {"n1": 4}}]
    monkeypatch.setenv("TPU_SHARD_HOLDS_WIRE", "json")
    raw = torch_codec.encode_holds(recs)
    assert raw.startswith("tpb1:")
    assert raw == "tpb1:" + base64.b64encode(torch_codec.pack_holds(recs)).decode("ascii")
    assert json.loads(jax_codec.encode_holds(recs)) == recs
    torch_codec.clear_memo()
    assert torch_codec.decode_holds(raw) == recs


def test_port_memo_hit_counts_an_avoided_parse():
    raw = torch_codec.encode_holds([{"namespace": "d", "gang": "g", "hosts": {"n1": 4}}])
    torch_codec.clear_memo()
    before = metrics.PARSE_AVOIDED.get(reason="holds_memo")
    torch_codec.decode_holds(raw)
    assert metrics.PARSE_AVOIDED.get(reason="holds_memo") == before
    torch_codec.decode_holds(raw)
    assert metrics.PARSE_AVOIDED.get(reason="holds_memo") == before + 1


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_each_planes_payload_decodes_in_the_other(writer, reader, seed):
    """Byte for byte: the two encoders give the same payload, and each
    plane's payload decodes in the other to the same records."""
    rng = random.Random(seed)
    recs = _random_recs(rng, rng.randint(0, 20), rng.randint(1, 64))
    if seed == 0:
        recs = list(EDGE_SHAPES[-1]) + recs
    raw = CODECS[writer].encode_holds(recs)
    CODECS[reader].clear_memo()
    assert CODECS[reader].decode_holds(raw) == recs
    assert raw == CODECS[reader].encode_holds(recs)
    assert jax_codec.pack_holds(recs) == torch_codec.pack_holds(recs)
    lenient = json.dumps(recs + [{"namespace": "x", "gang": "y", "hosts": {"h": 0}}])
    CODECS[reader].clear_memo()
    CODECS[writer].clear_memo()
    assert CODECS[reader].decode_holds(lenient) == CODECS[writer].decode_holds(lenient)
