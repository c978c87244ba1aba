"""The port's operator tools (k8s_device_plugin_tpu_torch/tools/: trace,
explain, flame, tputop) against the JAX package's.

The JAX tests' scenarios of these tools (tests/test_tracing.py,
tests/test_decisions.py, tests/test_profiling.py, tests/test_telemetry.py,
tests/test_defrag.py), each run on both planes: the plane's tool over what
the plane's own ledger, collector, profiler or sampler produced. Where both
tools take the same input (an OTLP export, a flight dump, a records list, a
folded stack, a scrape text) the rendered text is held equal, byte for
byte, but in two places, both in tputop: the port's node header shows
``best_set_score=`` (the port exports ``tpu_node_best_set_score{size}``, not
the JAX ``tpu_node_largest_free_box_chips`` and
``tpu_node_topology_fragmentation``) and the port's link column is headed
``NVLINK`` (``tpu_chip_ici_link_up`` carries a card's NVLinks).

Then the rules of the tools as a whole: a fresh process that imports all
six tools of the port holds no torch, no jax and nothing of the JAX package,
and ``tpu-doctor drain`` is refused until the rescue plane comes. The
doctor, gang, fleet and postmortem cases are tests/test_torch_tools_doctor.py.
"""

import json
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

from k8s_device_plugin_tpu import telemetry as jax_telemetry
from k8s_device_plugin_tpu.tools import explain as jax_explain
from k8s_device_plugin_tpu.tools import flame as jax_flame
from k8s_device_plugin_tpu.tools import trace as jax_trace
from k8s_device_plugin_tpu.tools import tputop as jax_tputop
from k8s_device_plugin_tpu.utils import decisions as jax_decisions
from k8s_device_plugin_tpu.utils import flightrecorder as jax_flight
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu.utils import stackprof as jax_stackprof
from k8s_device_plugin_tpu.utils import tracing as jax_tracing
from k8s_device_plugin_tpu_torch import telemetry
from k8s_device_plugin_tpu_torch.discovery.scanner import NvmlInfo
from k8s_device_plugin_tpu_torch.tools import explain, flame, trace, tputop
from k8s_device_plugin_tpu_torch.topology.links import LinkTopology
from k8s_device_plugin_tpu_torch.topology.placement import GpuPlacementState
from k8s_device_plugin_tpu_torch.utils import decisions, flightrecorder, metrics, stackprof
from k8s_device_plugin_tpu_torch.utils import tracing
from tests import fakes
from tests import torch_fake_nvml as fk

ROOT = Path(__file__).resolve().parents[1]
PLANES = {
    "jax": types.SimpleNamespace(
        trace=jax_trace, explain=jax_explain, flame=jax_flame, tputop=jax_tputop,
        tracing=jax_tracing, decisions=jax_decisions, flight=jax_flight,
        stackprof=jax_stackprof, metrics=jax_metrics, telemetry=jax_telemetry),
    "torch": types.SimpleNamespace(
        trace=trace, explain=explain, flame=flame, tputop=tputop,
        tracing=tracing, decisions=decisions, flight=flightrecorder,
        stackprof=stackprof, metrics=metrics, telemetry=telemetry),
}
BOTH = pytest.mark.parametrize("plane", ["jax", "torch"])
TOOLS = ("trace", "explain", "flame", "tputop", "gang", "doctor")


@pytest.fixture(autouse=True)
def _planes_clean():
    """The collectors, ledgers and telemetry families are process-global:
    every test leaves them off and empty on both planes."""
    telemetry._CHANGED = None
    yield
    for p in PLANES.values():
        p.tracing.disable()
        p.tracing.COLLECTOR.clear()
        p.decisions.LEDGER.disable()
        p.decisions.LEDGER.clear()
        for fam in (*p.telemetry.CHIP_FAMILIES, p.metrics.NODE_BOX_PLACEABLE,
                    p.metrics.NODE_FREE_CHIPS, p.metrics.TELEMETRY_TICKS):
            fam.remove_matching()
    metrics.NODE_BEST_SET_SCORE.remove_matching()
    for fam in (jax_metrics.NODE_LARGEST_BOX, jax_metrics.NODE_FRAGMENTATION):
        fam.remove_matching()
    telemetry.install_sampler(None)
    telemetry.NODE_STATS = None
    telemetry._CHANGED = None


@pytest.fixture
def traced():
    """Tracing on for each plane, into a private collector."""
    saved = {name: p.tracing.COLLECTOR for name, p in PLANES.items()}
    collectors = {}
    for name, p in PLANES.items():
        collectors[name] = p.tracing.COLLECTOR = p.tracing.SpanCollector()
    yield collectors
    for name, p in PLANES.items():
        p.tracing.COLLECTOR = saved[name]


@pytest.fixture
def ledger():
    """Each plane's ledger on (service extender)."""
    for p in PLANES.values():
        p.decisions.LEDGER.clear()
        p.decisions.LEDGER.enable(service="extender")
    yield {name: p.decisions.LEDGER for name, p in PLANES.items()}


# -- trace ------------------------------------------------------------------------


@BOTH
def test_trace_cli_renders_tree_and_events(plane, capsys, traced, tmp_path):
    p = PLANES[plane]
    p.tracing.enable(service="extender")
    with p.tracing.span("gang.admit", service="extender") as root:
        with p.tracing.span("kube.PATCH"):
            pass
    path = tmp_path / "t.json"
    path.write_text(json.dumps(traced[plane].otlp_json()))
    assert p.trace.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "gang.admit" in out and "kube.PATCH" in out
    assert root.trace_id in out
    # A flight dump renders as the event table.
    rec = p.flight.FlightRecorder()
    rec.enabled = True
    rec.service = "plugin"
    rec.record("allocate", "chips out", chips="c0,c1")
    dump = tmp_path / "events.json"
    dump.write_text(json.dumps(rec.snapshot()))
    assert p.trace.main([str(dump)]) == 0
    out = capsys.readouterr().out
    assert "allocate" in out and "chips out" in out


@BOTH
def test_trace_cli_self_test(plane, capsys):
    assert PLANES[plane].trace.main(["--self-test"]) == 0
    out = capsys.readouterr().out
    assert "extender.filter" in out and "plugin.Allocate" in out


@BOTH
def test_trace_cli_rejects_garbage(plane, tmp_path):
    p = tmp_path / "x.json"
    p.write_text('{"neither": true}')
    assert PLANES[plane].trace.main([str(p)]) == 1


def test_trace_renders_the_same_text_on_both_planes(traced):
    """The port's collector's export, with an error span and a dropped count,
    and a flight dump of the port's recorder: the same lines from both
    tools, for the whole export and for one trace."""
    tracing.enable(service="plugin")
    with tracing.span("plugin.Allocate", chips=2) as root:
        with tracing.span("kube.PATCH", service="controller"):
            pass
    try:
        with tracing.span("controller.reconcile", parent=root.context):
            raise RuntimeError("apiserver gone")
    except RuntimeError:
        pass
    with tracing.span("plugin.GetPreferredAllocation"):
        pass
    doc = traced["torch"].otlp_json()
    doc["dropped_spans"] = 3
    assert trace.render(doc) == jax_trace.render(doc)
    assert trace.render(doc, trace_id=root.trace_id) == jax_trace.render(
        doc, trace_id=root.trace_id)
    assert "ERROR: RuntimeError: apiserver gone" in "\n".join(trace.render(doc))
    rec = flightrecorder.FlightRecorder()
    rec.enable(service="plugin")
    with tracing.span("plugin.Allocate"):
        rec.record("allocate", "cards out", chips="GPU-a")
    rec.record("chip_health", "GPU-a unhealthy", xid=79)
    dump = rec.export(reason="sigterm")
    assert trace.render(dump) == jax_trace.render(dump)
    assert trace._flatten_otlp(doc) == jax_trace._flatten_otlp(doc)


# -- explain ----------------------------------------------------------------------


@BOTH
def test_explain_cli_self_test(plane, capsys):
    assert PLANES[plane].explain.main(["--self-test"]) == 0
    out = capsys.readouterr().out
    assert "gang_waiting" in out and "allocate_substitution" in out


@BOTH
def test_explain_cli_node_and_gang_views(plane, capsys, tmp_path, ledger):
    led = ledger[plane]
    led.record("filter_reject", "insufficient_chips", "0 chips available, 2 needed",
               pod="d/p", node="n1")
    led.record("filter_reject", "no_topology", "m", pod="d/q", node="n1")
    led.record("gang_waiting", "capacity", "blocked", gang="d/g")
    led.record("gang_admitted", "admitted", "fits", gang="d/g", waited_s=7.5)
    path = tmp_path / "dec.json"
    path.write_text(json.dumps(led.snapshot()))
    cli = PLANES[plane].explain
    assert cli.main(["--node", "n1", "--decisions", str(path)]) == 0
    out = capsys.readouterr().out
    assert "insufficient_chips×1" in out and "no_topology×1" in out
    assert cli.main(["--gang", "g", "--decisions", str(path)]) == 0
    assert "admitted after 7.5s" in capsys.readouterr().out
    assert cli.main(["--pod", "absent", "--decisions", str(path)]) == 1


@BOTH
def test_explain_renders_full_chain(plane, capsys, ledger, traced, tmp_path):
    """The rendered chain carries the rejection reason, the gang shortfall
    and the chosen cards, on a chain through the plane's real ledger."""
    p = PLANES[plane]
    led = ledger[plane]
    p.tracing.enable(service="extender")
    with p.tracing.span("gang.admit", service="extender") as root:
        ctx = root.context
        led.tag_gang("d/g", ctx.trace_id, ctx.span_id)
    led.record("gang_waiting", "capacity",
               "insufficient GPU capacity for [2, 2]: blocking demand 2: best host has 1 "
               "free card(s), short 1", gang="d/g", shortfall_chips=1)
    led.tag_gang("d/g", ctx.trace_id, ctx.span_id)
    with p.tracing.span("extender.filter", parent=ctx, service="extender"):
        led.record("filter_reject", "no_topology", "no GPU topology published", pod="d/w0",
                   gang="d/g", node="bad-node")
    with p.tracing.span("plugin.Allocate", parent=ctx, service="plugin"):
        led.record("allocate_substitution", "substituted",
                   "kubelet requested ['c3'], topology chose ['c0']", requested="c3",
                   assigned="c0")
    dec = tmp_path / "d.json"
    dec.write_text(json.dumps(led.snapshot()))
    tr = tmp_path / "t.json"
    tr.write_text(json.dumps(traced[plane].otlp_json()))
    assert p.explain.main(["--pod", "w0", "--decisions", str(dec), "--traces", str(tr)]) == 0
    out = capsys.readouterr().out
    assert "no GPU topology published" in out  # the rejection reason
    assert "short 1" in out  # the gang's shortfall
    assert "topology chose ['c0']" in out  # the chosen cards
    assert "gang.admit" in out  # the joined trace tree
    assert out.count(ctx.trace_id[:16]) >= 3  # one trace id throughout


def test_explain_renders_the_same_text_on_both_planes():
    """The port's self-test journey (its ledger and collector; preemption,
    defragmentation and rescue records among them) through every selector
    of both tools: the same lines. The JAX journey too, the other way."""
    for records, spans in (explain._self_test(), jax_explain._self_test()):
        for name in ("demo-w0", "default/demo-w0", "absent"):
            assert explain.render_pod(records, spans, name) == jax_explain.render_pod(
                records, spans, name)
        for render in ("render_gang", "render_evicted", "render_migrated", "render_rescued"):
            for gang in ("demo", "batch", "default/demo", "absent"):
                assert getattr(explain, render)(records, spans, gang) == getattr(
                    jax_explain, render)(records, spans, gang), (render, gang)
        for node in ("node-b", "absent"):
            assert explain.render_node(records, node) == jax_explain.render_node(records, node)
        assert explain.chain_for_pod(records, "demo-w0") == jax_explain.chain_for_pod(
            records, "demo-w0")


def test_explain_gathers_from_files_and_a_live_server(tmp_path):
    """``--url`` reads /debug/decisions and /debug/traces off the port's
    MetricsServer, merged with a second ledger's file, as the JAX tool
    does: the same chain from both tools."""
    tracing.enable(service="extender")
    decisions.LEDGER.enable(service="plugin")
    with tracing.span("plugin.Allocate"):
        decisions.LEDGER.record("allocate_substitution", "substituted", "kept",
                                pod="d/w0", assigned="GPU-a")
    other = tmp_path / "ext.json"
    other.write_text(json.dumps({"records": [
        {"ts": 1.0, "kind": "filter", "reason": "ok", "message": "1/1 candidates passed",
         "pod": "d/w0", "gang": "", "node": "", "attrs": {}}]}))
    srv = metrics.MetricsServer(host="127.0.0.1")
    url = srv.start()
    try:
        got = explain.gather(url, [str(other)], "")
        assert got == jax_explain.gather(url, [str(other)], "")
    finally:
        srv.stop()
    records, spans = got
    assert [r["kind"] for r in records] == ["allocate_substitution", "filter"]
    assert [s["name"] for s in spans] == ["plugin.Allocate"]
    assert "plugin.Allocate" in "\n".join(explain.render_pod(records, spans, "w0"))


# -- flame ------------------------------------------------------------------------


def _recorded(sp):
    prof = sp.SamplingProfiler(hz=10)
    for _ in range(3):
        prof._record(["thread:x;a (f.py:1);b (f.py:2)", "thread:y;c (g.py:3)"], ts=time.time())
    return prof


@BOTH
def test_speedscope_and_collapsed_exports_agree(plane):
    p = PLANES[plane]
    prof = _recorded(p.stackprof)
    col = p.flame.parse_collapsed(prof.export_collapsed())
    assert col == p.flame.from_speedscope(prof.export_speedscope())
    assert col[("thread:x", "a (f.py:1)", "b (f.py:2)")] == 3


@BOTH
def test_capture_bundle_reads_in_every_shape(plane, tmp_path):
    """A capture bundle's profile section, a /debug/profile payload, a bare
    speedscope document and collapsed text from a file all read to the same
    folded counts; a bundle taken with the profiler off is refused."""
    p = PLANES[plane]
    prof = _recorded(p.stackprof)
    collapsed, speedscope = prof.export_collapsed(), prof.export_speedscope()
    bundle = {"service": "plugin", "reason": "slo_allocate",
              "profile": {"enabled": True, "folded": collapsed, "speedscope": speedscope}}
    path = tmp_path / "capture-plugin-1-slo_allocate.json"
    path.write_text(json.dumps(bundle))
    want = p.flame.parse_collapsed(collapsed)
    assert p.flame.load_path(str(path)) == want
    assert p.flame.load_any({"enabled": True, "format": "collapsed", "folded": collapsed}) == want
    assert p.flame.load_any(json.dumps(speedscope)) == want
    assert p.flame.load_any(collapsed) == want
    with pytest.raises(ValueError, match="--profile-hz was 0"):
        p.flame.load_any({"profile": {"enabled": False}})
    with pytest.raises(ValueError, match="enabled: false"):
        p.flame.load_any({"enabled": False})


@BOTH
def test_flame_cli_renders_a_file_and_self_tests(plane, capsys, tmp_path):
    p = PLANES[plane]
    path = tmp_path / "folded.txt"
    path.write_text(_recorded(p.stackprof).export_collapsed())
    assert p.flame.main([str(path), "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("   SELF  SELF%   TOTAL   TOT%  FRAME")
    assert "b (f.py:2)" in out and "total samples: 6" in out
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    assert p.flame.main([str(empty)]) == 2
    assert "no samples" in capsys.readouterr().err
    # The self-test in its own process, as tier-1 runs the JAX one: the
    # sampler sees every thread, and a pytest worker's own threads would
    # crowd the hot frame out of its top table.
    package = "k8s_device_plugin_tpu" if plane == "jax" else "k8s_device_plugin_tpu_torch"
    out = subprocess.run([sys.executable, "-m", f"{package}.tools.flame", "--self-test"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["flame_self_test"] == "ok"


def test_flame_renders_the_same_text_on_both_planes():
    """A live sample of this process by the port's profiler, read both ways:
    the same folded counts, the same top table and flamegraph."""
    stop = threading.Event()

    def _tools_test_spin():
        while not stop.is_set():
            sum(i * i for i in range(200))

    t = threading.Thread(target=_tools_test_spin, name="tools-test-spin", daemon=True)
    t.start()
    prof = stackprof.SamplingProfiler(hz=199, service="plugin")
    prof.start()
    try:
        deadline = time.monotonic() + 5
        while prof.snapshot()["samples"] < 10 and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        prof.stop()
        stop.set()
        t.join(timeout=2)
    collapsed, speedscope = prof.export_collapsed(), prof.export_speedscope()
    folded = flame.load_any(collapsed)
    assert folded == jax_flame.load_any(collapsed) == jax_flame.from_speedscope(speedscope)
    assert flame.top_frames(folded, 50) == jax_flame.top_frames(folded, 50)
    assert flame.render_top(folded, 7) == jax_flame.render_top(folded, 7)
    for kw in ({}, {"width": 60, "max_depth": 3, "min_pct": 5.0}):
        assert flame.render_flame(folded, **kw) == jax_flame.render_flame(folded, **kw)
    assert "_tools_test_spin" in flame.render_flame(folded)


# -- tputop -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    f = fk.FakeNvml(fk.build(tmp_path_factory.mktemp("fake_nvml")))
    yield f
    f.reset()


def _port_scrape(fake, tmp_path, duty=88, link_down=False):
    """The port's sampler over four fake-NVML H100s: card 0 held by ml/w0
    (gang g) and busy, the node's gauges with cards 2 and 3 free. Returns
    the registry's text and the cards' UUIDs."""
    fake.reset()
    uuids = fk.hgx_node(fake, tmp_path / "sys", 4)
    fake.set_telemetry(0, util_gpu=duty, mem_used=8 * 2**30, temp_c=71, power_mw=200_000)
    if link_down:
        fake.set_link(0, 0, active=False)
    info = NvmlInfo(fake.path)
    chips = info.scan(str(tmp_path / "sys"), str(tmp_path / "dev"))
    sampler = telemetry.TelemetrySampler(
        info, str(tmp_path / "sys"), chips,
        attribution=lambda: {uuids[0]: {"pod": "w0", "namespace": "ml", "gang": "g"}})
    sampler.poll_once()
    state = GpuPlacementState(LinkTopology(chips, info))
    telemetry.update_node_gauges(state, uuids[2:])
    return metrics.REGISTRY.render(), uuids


@BOTH
def test_tputop_renders_and_self_tests(plane, fake, tmp_path, capsys):
    """The plane's sampler over its own fake node (the JAX one over a fake
    sysfs tree, the port's over the fake NVML), the registry's text, the
    plane's tputop: the holder, the counters, a downed link, the node line;
    the CLI reads a scrape file; a scrape of no card family is refused."""
    p = PLANES[plane]
    if plane == "jax":
        from k8s_device_plugin_tpu.discovery.scanner import PyTpuInfo
        from tests.test_telemetry import _chips_and_mesh

        accel, dev, chips, mesh = _chips_and_mesh(tmp_path)
        fakes.set_chip_telemetry(accel, 0, duty_pct=88, hbm_used_bytes=8 * 2**30, temp_c=71.0,
                                 power_w=200.0)
        fakes.set_chip_ici_link(accel, 0, 0, up=False, errors=9)
        sampler = jax_telemetry.TelemetrySampler(
            PyTpuInfo(), accel, mesh,
            attribution=lambda: {mesh.ids[0]: {"pod": "w0", "namespace": "ml", "gang": "g"}})
        sampler.poll_once()
        jax_telemetry.update_node_gauges(mesh, mesh.ids[2:])
        text, down, node = jax_metrics.REGISTRY.render(), "0up/1dn", "fragmentation="
    else:
        text, _ = _port_scrape(fake, tmp_path, link_down=True)
        down, node = "17up/1dn", "best_set_score=2:9.00"
    table = p.tputop.render(text)
    assert "ml/w0" in table and "88" in table and "71.0C" in table and "200W" in table
    assert down in table
    assert node in table and "free=2" in table
    scrape = tmp_path / "scrape.txt"
    scrape.write_text(text)
    assert p.tputop.main([str(scrape)]) == 0
    assert "ml/w0" in capsys.readouterr().out
    with pytest.raises(ValueError):
        p.tputop.render("nothing_here 1\n")
    assert p.tputop.main([str(tmp_path / "absent.txt")]) == 1


@BOTH
def test_tputop_self_test(plane, capsys):
    """The self-test on a clean registry: the JAX one over its fake sysfs
    tree, the port's over the backend the tool defines."""
    assert PLANES[plane].tputop.main(["--self-test"]) == 0
    out = capsys.readouterr().out
    assert "tputop self-test: OK" in out
    if plane == "torch":
        assert "ml/train-w0" in out and "NVLINK" in out
        # The self-test put back the node gauges it wrote.
        assert metrics.NODE_FREE_CHIPS.series() == []
        assert metrics.NODE_BEST_SET_SCORE.series() == []


def test_tputop_renders_the_same_rows_on_both_planes(fake, tmp_path):
    """One scrape of the port's daemon, read by both tools: every line the
    same but the two named differences. The port's node line shows
    best_set_score= between free= and placeable= (the JAX tool reads no
    box or fragmentation family here, so it shows free= and placeable=
    alone), and its link column is headed NVLINK where the JAX one says
    ICI."""
    text, uuids = _port_scrape(fake, tmp_path)
    port, ref = tputop.render(text).splitlines(), jax_tputop.render(text).splitlines()
    assert ref[0] == "node: free=2 placeable=1,2"
    assert port[0] == "node: free=2 best_set_score=2:9.00 placeable=1,2"
    assert port[1] == ref[1].replace(f"{'ICI':>12}", f"{'NVLINK':>12}")
    assert port[2:] == ref[2:]
    row = next(line for line in port if line.startswith(uuids[0]))
    assert row.split()[1:5] == ["ml/w0", "-", "g", "88"]
    assert len(port) == 2 + 1 + len(uuids)


@BOTH
def test_tputop_footer_aggregates_shards_and_skips_placeholders(plane):
    """The defrag footer: an empty family's unlabelled placeholder must not
    render (an extender without defrag is not "budget 0, gate closed"), and
    the series of several shards add up."""
    t = PLANES[plane].tputop
    placeholders = {f: [({}, 0.0)] for f in t.DEFRAG_FAMILIES}
    assert t._defrag_footer(placeholders) is None
    real = dict(placeholders)
    real["tpu_extender_defrag_budget_remaining"] = [({"shard": ""}, 10.0), ({"shard": "1"}, 2.0)]
    real["tpu_extender_stranded_demand"] = [({"shard": "", "size": "4"}, 1.0),
                                            ({"shard": "1", "size": "4"}, 2.0)]
    footer = t._defrag_footer(real)
    assert "budget 12 eviction(s) left/h" in footer
    assert "stranded size=4×3" in footer
    assert footer == (jax_tputop._defrag_footer(real))


def test_tputop_footer_renders_the_same_from_a_merged_scrape():
    """A node scrape followed by the JAX extender's defrag families (what an
    operator cats together): the same footer from both tools."""
    jax_metrics.STRANDED_DEMAND.set(1, size="4", shard="")
    jax_metrics.DEFRAG_BUDGET.set(10, shard="")
    try:
        text = ('tpu_chip_duty_cycle{chip="GPU-a"} 5\n'
                + jax_metrics.EXTENDER_REGISTRY.render())
        port, ref = tputop.render(text), jax_tputop.render(text)
    finally:
        jax_metrics.STRANDED_DEMAND.remove_matching(size="4")
        jax_metrics.DEFRAG_BUDGET.remove_matching(shard="")
    assert port.splitlines()[-1] == ref.splitlines()[-1]
    assert port.splitlines()[-1].startswith("defrag: stranded size=4×1 | budget 10")


# -- the tools as a whole ------------------------------------------------------------


def test_tools_import_no_torch_jax_or_the_jax_package_in_a_fresh_process():
    """An operator runs the tools from a laptop: importing the tools package,
    all six tools and ``tpu-simreport`` (with the simulator behind it) loads
    no torch, no jax and nothing of the JAX package (its name is a prefix of
    the port's)."""
    pinned = TOOLS + ("simreport",)
    code = (
        "import re, sys\n"
        "import k8s_device_plugin_tpu_torch.tools\n"
        + "".join(f"import k8s_device_plugin_tpu_torch.tools.{t}\n" for t in pinned)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'jaxlib')"
        " or re.match(r'k8s_device_plugin_tpu(?!_torch)', m))\n"
        "print(len([m for m in sys.modules if m.startswith('k8s_device_plugin_tpu_torch.tools.')]),"
        " bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(None, 1) == [str(len(pinned)), "[]\n"]


def test_doctor_drain_is_refused_naming_the_missing_plane(tmp_path):
    """``tpu-doctor drain`` against an extender run with ``--no-rescue``
    (its /drain answers 404): exit 2 and a message naming the inactive
    rescue plane, for a drain and an uncordon alike; without a node or a
    URL the parser refuses with exit 2."""
    import signal
    import socket

    from tests.fake_apiserver import FakeApiServer

    api = FakeApiServer()
    url = api.start()
    kc = tmp_path / "kc.json"
    kc.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config",
        "clusters": [{"name": "c", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {}}],
        "contexts": [{"name": "x", "context": {"cluster": "c", "user": "u"}}],
        "current-context": "x"}))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_device_plugin_tpu_torch.extender", "--host", "127.0.0.1",
         "--port", str(port), "--kubeconfig", str(kc), "--node-cache", "--gang-admission",
         "--no-rescue"], cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    try:
        import urllib.request

        deadline = time.time() + 30
        while True:
            try:
                if urllib.request.urlopen(f"{base}/readyz", timeout=2).status == 200:
                    break
            except OSError:
                pass
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.05)
        for args in (["drain", "n3", "--url", base], ["drain", "n3", "--uncordon", "--url", base],
                     ["drain"], ["drain", "n3"]):
            out = subprocess.run(
                [sys.executable, "-m", "k8s_device_plugin_tpu_torch.tools.doctor", *args],
                capture_output=True, text=True, timeout=60, cwd=ROOT)
            assert out.returncode == 2, out
            assert out.stdout == ""
            if "--url" in args:
                assert "drain not enabled" in out.stderr, out.stderr
                assert "rescue plane is not active" in out.stderr, out.stderr
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        api.stop()
    assert rc == 0
