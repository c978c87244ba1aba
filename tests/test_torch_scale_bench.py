"""The port's control-plane scale bench (extender/scale_bench.py), held to
the JAX ``tests/test_scale_bench.py``.

Each JAX case has a twin here under its JAX name, against the JAX bounds
(the constants and ``_check`` are the JAX module's own) and with the
suite's one full re-run for host contention: the 1,000-node run, the
sharded probe, defragmentation planning, the cold start, the tracing,
telemetry, audit, profiler, resilience and black-box probes, the schema
cases and the scheduling-quality probe, which runs the port's simulator
against the port's golden. The two ``slow`` cases stay ``slow``.
``test_placement_kernel_probe_bound_and_schema`` has no twin: it times the
TPU box bitset's vector kernel, and a GPU node has no box search.

Beside them: every probe's result has the JAX probe's key tree, both run
at a toy size; the three self-tests and the ``--placement-kernel`` refusal
run in fresh processes; and importing the bench loads neither torch, jax
nor the JAX package.
"""

import json
import os
import subprocess
import sys

import pytest

from k8s_device_plugin_tpu.extender import scale_bench as jax_scale_bench
from k8s_device_plugin_tpu_torch.extender import scale_bench
from tests.test_scale_bench import R5_1000_P99_MS, WARM_P50_BOUNDS_MS, _check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "k8s_device_plugin_tpu_torch.extender.scale_bench"


def test_scale_bench_bounds_at_1000():
    last = None
    for _attempt in range(2):
        r = scale_bench.run(n_nodes=1000, n_gangs=100, filter_calls=20, tick_rounds=2)
        assert r["nodes"] == 1000 and r["gangs"] == 100
        last = _check(r), r
        if not last[0]:
            return
    assert not last[0], last


@pytest.mark.slow
def test_scale_bench_sublinear_at_5000():
    """At 5,000 nodes and 500 gangs the warm indexed /filter and /prioritize
    p99 stay within 2x the JAX round-5 1,000-node p99, the full admission
    sweep stays under a second, and the idle dirty tick keeps the 1,000-node
    bound: independent of the gang count."""
    last = None
    for _attempt in range(2):
        r = scale_bench.run(n_nodes=5000, n_gangs=500, filter_calls=20, tick_rounds=2)
        assert r["nodes"] == 5000 and r["gangs"] == 500
        problems = []
        for k, r5 in R5_1000_P99_MS.items():
            if r[k]["p99_ms"] >= 2 * r5:
                problems.append(f"{k} p99 {r[k]['p99_ms']}ms >= {2 * r5}ms (2x the r5 "
                                f"1,000-node p99 — hot path went linear again)")
        if r["gang_tick_full"]["p99_ms"] >= 1000:
            problems.append(f"gang_tick_full p99 {r['gang_tick_full']['p99_ms']}ms >= 1000ms")
        if r["gang_tick_idle"]["p50_ms"] >= WARM_P50_BOUNDS_MS["gang_tick_idle"]:
            problems.append(f"gang_tick_idle p50 {r['gang_tick_idle']['p50_ms']}ms >= "
                            f"{WARM_P50_BOUNDS_MS['gang_tick_idle']}ms")
        last = problems, r
        if not problems:
            return
    assert not last[0], last


def test_shard_scaling_probe_bound_and_schema():
    """Every gang admits under the partition, disjointly and completely;
    gangs admitted per second are recorded for the three shapes; and the
    steady /filter shape (own shard local, peers through the holds overlay)
    stays within 1.1x of the single table's p99, with the JAX slack floor."""
    last = None
    for _attempt in range(2):
        r = scale_bench.shard_scaling(n_nodes=300, n_gangs=30, shards=3, filter_calls=20)
        assert r["nodes"] == 300 and r["shards"] == 3
        assert r["single"]["gangs_per_s"] > 0
        assert r["sharded"]["gangs_per_s_parallel"] > 0
        assert sum(v["gangs"] for v in r["sharded"]["per_shard"].values()) == 30
        problems = []
        peer_p99 = r["sharded"]["filter_peer_overlay"]["p99_ms"]
        single_p99 = r["single"]["filter"]["p99_ms"]
        limit = max(1.1 * single_p99, single_p99 + 2.0)
        if peer_p99 >= limit:
            problems.append(f"sharded /filter p99 {peer_p99}ms >= {limit:.2f}ms "
                            f"(single-shard p99 {single_p99}ms)")
        last = problems, r
        if not problems:
            return
    assert not last[0], last


def test_defrag_planning_probe_bound_and_schema():
    """Over the fragmented 1,000-node fixture (two free cards on every
    4-card node, so a 4-card member is stranded by scatter alone) the plan
    finds the one-victim repack, the node it frees places 4, the detection
    scan stays cheap and the plan's p99 stays under the JAX tripwire."""
    last = None
    for _attempt in range(2):
        r = scale_bench.defrag_planning(n_nodes=1000, samples=20)
        assert r["nodes"] == 1000
        assert r["plan_victims"] == 1, r
        assert 4 in r["placeable_after"], r
        problems = []
        if r["plan"]["p99_ms"] >= 50.0:
            problems.append(f"plan p99 {r['plan']['p99_ms']}ms >= 50ms over the "
                            f"fragmented 1,000-node fixture")
        if r["detect"]["p99_ms"] >= 25.0:
            problems.append(f"detect p99 {r['detect']['p99_ms']}ms >= 25ms — the "
                            f"per-tick stranded scan must stay cheap")
        last = problems, r
        if not problems:
            return
    assert not last[0], last


@pytest.mark.slow
def test_shard_scaling_at_50000():
    """50,000 nodes and 5,000 gangs over 4 shards: the per-shard /filter p99
    stays within 1.1x of the single shard's (plus the JAX floor), and the
    parallel shards admit faster than the single admitter."""
    last = None
    for _attempt in range(2):
        r = scale_bench.shard_scaling(n_nodes=50000, n_gangs=5000, shards=4, filter_calls=10)
        assert r["nodes"] == 50000 and r["gangs"] == 5000
        assert sum(v["gangs"] for v in r["sharded"]["per_shard"].values()) == 5000
        problems = []
        peer_p99 = r["sharded"]["filter_peer_overlay"]["p99_ms"]
        single_p99 = r["single"]["filter"]["p99_ms"]
        if peer_p99 >= 1.1 * single_p99 + 5.0:
            problems.append(f"per-shard /filter p99 {peer_p99}ms >= 1.1x single "
                            f"{single_p99}ms at 50k nodes")
        if r["sharded"]["gangs_per_s_parallel"] <= r["single"]["gangs_per_s"]:
            problems.append("parallel sharded throughput did not beat the single admitter: "
                            f"{r['sharded']['gangs_per_s_parallel']} vs "
                            f"{r['single']['gangs_per_s']} gangs/s")
        last = problems, r
        if not problems:
            return
    assert not last[0], last


def test_scale_bench_cold_is_separated_from_warm():
    r = scale_bench.run(n_nodes=20, n_gangs=5, filter_calls=3, tick_rounds=1)
    cold = r["cold_first_call"]
    assert cold["filter_ms"] > 0 and cold["prioritize_ms"] > 0
    assert cold["index_build_ms"] > 0
    assert r["filter"]["samples"] == 3


def test_tracing_overhead_probe_schema_and_restore():
    from k8s_device_plugin_tpu_torch.utils import tracing

    saved_collector = tracing.COLLECTOR
    r = scale_bench.tracing_overhead(n_nodes=30, filter_calls=4)
    assert r["nodes"] == 30
    assert r["disabled"]["filter"]["samples"] == 4
    assert r["enabled"]["filter"]["samples"] == 4
    # One filter and one prioritize span per enabled call.
    assert r["spans_collected"] == 8
    assert "filter_p99_overhead_pct" in r
    assert not tracing.enabled()
    assert tracing.COLLECTOR is saved_collector


def _ratio_violations(r, control: str, arm: str, paths, key: str = "p99_ms"):
    """The suite's ratio bound: the plane's arm within 1.05x its control
    plus the 0.3 ms timer-noise floor."""
    out = []
    for path in paths:
        base = r[control][path][key]
        got = r[arm][path][key]
        if got > 1.05 * base + 0.3:
            out.append(f"{path}: {arm} p99 {got}ms vs {control} {base}ms "
                       f"(bound 1.05x + 0.3ms noise floor)")
    return out


def _twice(probe, violations):
    """One run, and one full re-run if a bound failed (host contention)."""
    r = probe()
    failures = violations(r)
    if failures:
        r = probe()
        failures = violations(r)
    assert not failures, failures
    return r


def test_telemetry_overhead_probe_bound_and_schema():
    """With the sampler off, filter, prioritize and the index-fed dirty tick
    of the tracking index stay within 1.05x (+0.3 ms) of the control arm's,
    whose index keeps no placeable aggregate. The node-side costs over an
    8-card board are schema-checked, and every synthetic series is pruned."""
    from k8s_device_plugin_tpu_torch import telemetry
    from k8s_device_plugin_tpu_torch.utils import metrics

    saved_provider = telemetry.CLUSTER_PROVIDER
    r = _twice(lambda: scale_bench.telemetry_overhead(n_nodes=60, filter_calls=101,
                                                      tick_rounds=101, sampler_rounds=5),
               lambda r: _ratio_violations(r, "control", "tracked",
                                           ("filter", "prioritize", "tick_dirty")))
    assert telemetry.CLUSTER_PROVIDER is saved_provider
    assert metrics.EXT_PLACEABLE_NODES.series() == []
    assert r["nodes"] == 60
    for arm in ("control", "tracked"):
        assert r[arm]["filter"]["samples"] == 101
        assert r[arm]["tick_dirty"]["samples"] == 101
        assert r[arm]["index_build_ms"] > 0
    assert r["sampler_tick"]["samples"] == 5
    assert r["node_gauges"]["p99_ms"] >= 0
    assert not [s for fam in telemetry.CHIP_FAMILIES for s in fam.series()]
    assert "filter_p99_overhead_pct" in r
    # A full 8-card pass stays under 100 ms even on a loaded host.
    assert r["sampler_tick"]["p99_ms"] < 100


def test_audit_overhead_probe_bound_and_schema():
    """With the auditor's engine sweeping between RPCs over a real on-disk
    journal, standing holds and the index, the indexed /filter p99 stays
    within 1.05x (+0.3 ms) of the audit-free arm; the sweeps find nothing on
    the undrifted fixtures."""
    from k8s_device_plugin_tpu_torch import telemetry
    from k8s_device_plugin_tpu_torch.utils import metrics

    saved_provider = telemetry.CLUSTER_PROVIDER
    r = _twice(lambda: scale_bench.audit_overhead(n_nodes=60, n_holds=10, filter_calls=101,
                                                  sweep_every=10, sweep_rounds=5),
               lambda r: _ratio_violations(r, "control", "audited", ("filter",)))
    assert telemetry.CLUSTER_PROVIDER is saved_provider
    assert metrics.EXT_PLACEABLE_NODES.series() == []
    assert metrics.EXT_AUDIT_FINDINGS.series() == []
    assert r["nodes"] == 60 and r["holds"] == 10
    for arm in ("control", "audited"):
        assert r[arm]["filter"]["samples"] == 101
    assert r["sweep"]["samples"] == 5
    assert r["sweep"]["p99_ms"] < 1000
    assert "filter_p99_overhead_pct" in r


def test_profiler_overhead_probe_bound_and_schema():
    """The 19 Hz sampler costs the indexed /filter p99 at most 1.05x
    (+0.3 ms) of the paused-sampler arm, and is uninstalled afterwards."""
    from k8s_device_plugin_tpu_torch.utils import stackprof

    saved = stackprof.PROFILER
    r = _twice(lambda: scale_bench.profiler_overhead(n_nodes=60, filter_calls=101),
               lambda r: _ratio_violations(r, "control", "profiled", ("filter",)))
    assert r["nodes"] == 60 and r["hz"] == 19.0
    for arm in ("control", "profiled"):
        assert r[arm]["filter"]["samples"] == 101
    assert "filter_p99_overhead_pct" in r
    assert r["profiler"]["dropped_stacks"] == 0
    assert stackprof.PROFILER is saved


def test_resilience_overhead_probe_bound_and_schema():
    """A healthy wrapped kube call costs at most 1.05x (+0.3 ms) of a bare
    one, and the probe's private tracker leaves the process-wide one as it
    was."""
    from k8s_device_plugin_tpu_torch.utils import resilience

    before = resilience.TRACKER.snapshot()["call_outcomes"]
    r = _twice(lambda: scale_bench.resilience_overhead(calls=101, batch=50),
               lambda r: _ratio_violations(r, "control", "wrapped", ("call",)))
    assert r["calls"] == 101 and r["batch"] == 50
    for arm in ("control", "wrapped"):
        assert r[arm]["call"]["samples"] == 101
    assert "call_p99_overhead_pct" in r
    assert resilience.TRACKER.snapshot()["call_outcomes"] == before


def test_blackbox_overhead_probe_bound_and_schema():
    """With the black-box recorder's taps attached and its writer persisting,
    the indexed /filter p99 stays within 1.05x (+0.3 ms) of the detached arm;
    the recorder wrote what it was fed, and every plane is torn down."""
    from k8s_device_plugin_tpu_torch.utils import profiling, tracing
    from k8s_device_plugin_tpu_torch.utils.decisions import LEDGER
    from k8s_device_plugin_tpu_torch.utils.flightrecorder import RECORDER

    r = _twice(lambda: scale_bench.blackbox_overhead(n_nodes=60, filter_calls=101),
               lambda r: _ratio_violations(r, "control", "blackbox", ("filter",)))
    assert r["nodes"] == 60
    for arm in ("control", "blackbox"):
        assert r[arm]["filter"]["samples"] == 101
    assert "filter_p99_overhead_pct" in r
    assert r["recorder"]["records_written"] >= 101
    assert r["recorder"]["bytes_written"] > 0
    assert r["recorder"]["segments"] >= 1
    assert r["recorder"]["drops"] == {}
    assert not RECORDER.enabled and not LEDGER.enabled
    assert not tracing.enabled()
    assert "blackbox_writer" not in {hb["name"] for hb in profiling.HEARTBEATS.snapshot()}


def test_cold_start_snapshot_bounds_at_1000():
    """The warm snapshot's time to ready is at least 5x faster than the full
    parse (p50), and the wholly stale fallback within 1.05x of it (+2 ms):
    the JAX bounds, over the port's 4-card annotations, which parse more than
    the v5e ones."""
    from k8s_device_plugin_tpu_torch import telemetry
    from k8s_device_plugin_tpu_torch.utils import metrics

    saved_provider = telemetry.CLUSTER_PROVIDER

    def violations(r):
        out = []
        full = r["full_parse"]["time_to_ready"]["p50_ms"]
        snap = r["snapshot_warm"]["time_to_ready"]["p50_ms"]
        stale = r["snapshot_stale"]["time_to_ready"]["p50_ms"]
        if snap * 5 > full:
            out.append(f"snapshot-warm time-to-ready p50 {snap}ms not 5x faster than full "
                       f"parse {full}ms")
        if stale > 1.05 * full + 2.0:
            out.append(f"stale-snapshot fallback p50 {stale}ms exceeds 1.05x full parse "
                       f"{full}ms (+2ms noise floor)")
        return out

    r = _twice(lambda: scale_bench.cold_start(n_nodes=1000, ready_samples=101, slow_samples=7),
               violations)
    assert r["nodes"] == 1000
    assert r["snapshot_warm"]["restored_per_start"] == 1000
    assert r["snapshot_warm"]["time_to_ready"]["samples"] == 101
    assert r["full_parse"]["time_to_ready"]["samples"] == 7
    assert r["snapshot_warm"]["warm_drain"]["p50_ms"] > 0
    assert r["snapshot_warm"]["cold_first_call"]["p50_ms"] > 0
    assert telemetry.CLUSTER_PROVIDER is saved_provider
    assert metrics.EXT_PLACEABLE_NODES.series() == []


def test_scale_bench_correctness_assertions_fire():
    """run() asserts that every node passes the all-free filter on both
    paths, every gang releases in the full sweep, a dirty-marked new gang
    releases on a dirty tick, and idle ticks release nothing."""
    r = scale_bench.run(n_nodes=20, n_gangs=5, filter_calls=3, tick_rounds=1)
    assert r["filter"]["samples"] == 3
    assert r["gang_tick_full"]["samples"] == 1
    assert r["gang_tick_dirty"]["samples"] == 1
    assert r["gang_tick_idle"]["samples"] >= 5


def test_scheduling_quality_probe_bound_and_schema():
    """The port's simulator replays the canned traces through the port's
    admission and eviction planes, bounded on the decisions as JAX bounds
    them: tier-ordered time to admit with preemption paid, the utilisation
    and defrag-efficiency floors, the rescue within 30 virtual seconds and
    the targetless failure parked, no drift from the port's golden, and the
    replay byte-identical. The sim series are pruned after."""
    from k8s_device_plugin_tpu_torch.extender import simulator
    from k8s_device_plugin_tpu_torch.utils import metrics as m

    try:
        r = simulator.scheduling_quality()
    finally:
        simulator.prune_metrics()
    assert set(r["traces"]) == set(simulator.CANNED_TRACES)
    assert r["golden_found"] is True
    assert r["deterministic"] is True, r.get("determinism_sha256")
    for name, card in r["traces"].items():
        assert card["schema"] == simulator.SCORECARD_SCHEMA, name
        assert card["trace"] == name
    problems = []
    tiers = r["traces"]["priority_burst"]["time_to_admit_s"]
    order = ["critical", "high", "standard", "batch"]
    missing = [t for t in order if t not in tiers]
    if missing:
        problems.append(f"priority_burst missing tiers: {missing}")
    else:
        p50s = [tiers[t]["p50_s"] for t in order]
        if sorted(p50s) != p50s:
            problems.append(f"time-to-admit not tier-ordered: {dict(zip(order, p50s))}")
        if r["traces"]["priority_burst"]["score"]["preemption_churn_cost"] <= 0:
            problems.append("priority_burst paid no restart cost")
    util = r["traces"]["steady_mixed"]["score"]["utilization"]
    if util < 0.6:
        problems.append(f"steady_mixed utilization {util} < 0.6 floor")
    eff = r["traces"]["churn_strand"]["score"]["defrag_efficiency_chips_per_eviction"]
    if eff < 0.5:
        problems.append(f"churn_strand defrag efficiency {eff} chips/eviction < 0.5 floor")
    resc = r["traces"]["chip_failure_rescue"]["rescue"]
    if resc["gangs_rescued"] < 1:
        problems.append("chip_failure_rescue: no gang was rescued")
    ttr = resc["time_to_rescue_s"]["p50_s"]
    if not 0 < ttr <= 30.0:
        problems.append(f"chip_failure_rescue time-to-rescue p50 {ttr}s outside (0, 30]")
    if resc["pending_gang_ticks"] <= 0:
        problems.append("chip_failure_rescue: the targetless failure never parked "
                        "RESCUE_PENDING")
    if r["traces"]["chip_failure_rescue"]["score"]["work_lost_to_hardware_cost"] <= 0:
        problems.append("chip_failure_rescue paid no hardware restart cost")
    for name, deltas in r["deltas"].items():
        drift = {k: v for k, v in deltas.items() if v != 0}
        if drift:
            problems.append(f"{name} drifted from golden: {drift}")
    assert not problems, (problems, {n: c["score"] for n, c in r["traces"].items()})
    for fam in (m.SIM_RUNS, m.SIM_TIME_TO_ADMIT, m.SIM_UTILIZATION, m.SIM_FRAGMENTATION,
                m.SIM_PREEMPTION_CHURN, m.SIM_DEFRAG_EFFICIENCY, m.SIM_BASELINE_DELTA):
        assert fam.series() == []


# -- the JAX key tree ---------------------------------------------------------


def _key_tree(x):
    """The nested dict keys of a result, leaves as None."""
    if isinstance(x, dict):
        return {k: _key_tree(v) for k, v in x.items()}
    return None


# probe -> the call, at a toy size, the same for both benches.
TOY_PROBES = {
    "run": lambda b: b.run(n_nodes=20, n_gangs=5, filter_calls=3, tick_rounds=1),
    "shard_scaling": lambda b: b.shard_scaling(n_nodes=30, n_gangs=6, shards=3, filter_calls=3),
    "tracing_overhead": lambda b: b.tracing_overhead(n_nodes=20, filter_calls=3),
    "ledger_overhead": lambda b: b.ledger_overhead(n_nodes=20, filter_calls=3),
    "journal_overhead": lambda b: b.journal_overhead(n_nodes=20, n_gangs=3, tick_rounds=3),
    "audit_overhead": lambda b: b.audit_overhead(n_nodes=20, n_holds=3, filter_calls=6,
                                                 sweep_every=3, sweep_rounds=2),
    "profiler_overhead": lambda b: b.profiler_overhead(n_nodes=20, filter_calls=6),
    "blackbox_overhead": lambda b: b.blackbox_overhead(n_nodes=20, filter_calls=6),
    "resilience_overhead": lambda b: b.resilience_overhead(calls=6, batch=5),
    "telemetry_overhead": lambda b: b.telemetry_overhead(n_nodes=20, filter_calls=3,
                                                         tick_rounds=3, sampler_rounds=2),
    "defrag_planning": lambda b: b.defrag_planning(n_nodes=20, n_victims=5, samples=3),
    "cold_start": lambda b: b.cold_start(n_nodes=20, ready_samples=3, slow_samples=2),
}


@pytest.mark.parametrize("probe", sorted(TOY_PROBES))
def test_probe_result_has_the_jax_key_tree(probe):
    """Both benches' probe at one toy size: the port's result has the JAX
    result's keys at every level, no more and no fewer."""
    jax_result = TOY_PROBES[probe](jax_scale_bench)
    torch_result = TOY_PROBES[probe](scale_bench)
    assert _key_tree(torch_result) == _key_tree(jax_result)


# -- the CLI, in fresh processes ------------------------------------------------

LOADED_PROBE = (
    "import json, re, sys\n"
    "from k8s_device_plugin_tpu_torch.extender import scale_bench\n"
    "rc = scale_bench.main(sys.argv[1:]) if sys.argv[1:] else 0\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')\n"
    "             or re.match(r'k8s_device_plugin_tpu(?!_torch)', m))\n"
    "print('LOADED ' + json.dumps(bad))\n"
    "sys.exit(rc)\n")


def _fresh(*args):
    """Run the bench's main with ``args`` in a fresh process; the last line
    printed names every torch, jax or JAX-package module it loaded."""
    out = subprocess.run([sys.executable, "-c", LOADED_PROBE, *args], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "LOADED []", lines[-1]
    return lines


def test_importing_the_bench_loads_no_torch_jax_or_jax_package():
    assert _fresh() == ["LOADED []"]


def test_cold_start_self_test_in_a_fresh_process():
    result = json.loads(_fresh("--cold-start-self-test")[-2])
    assert set(result) == {"cold_start_self_test", "ready_speedup_p50"}
    assert result["cold_start_self_test"] == "ok" and result["ready_speedup_p50"] > 0


def test_profile_self_test_in_a_fresh_process():
    result = json.loads(_fresh("--profile-self-test")[-2])
    assert set(result) == {"profile_self_test", "samples"}
    assert result["profile_self_test"] == "ok" and result["samples"] >= 1


def test_placement_self_test_in_a_fresh_process():
    """The JAX keys that keep a meaning (no ``kernel_mode``): every size up to
    the free count of every free mask of the 4-card node cross-checked
    (4 cards x 2^3 masks holding each = 32), and the overlay's sizes those of
    the JAX codec on the same records."""
    from k8s_device_plugin_tpu.extender import holdscodec as jax_holdscodec

    result = json.loads(_fresh("--placement-self-test")[-2])
    assert set(result) == {"placement_self_test", "verdicts_cross_checked", "overlay_bytes"}
    assert result["placement_self_test"] == "ok"
    assert result["verdicts_cross_checked"] == 32
    recs = [{"namespace": "default", "gang": f"g{i}", "hosts": {f"n{i}": 2, f"n{i + 1}": 2}}
            for i in range(8)]
    assert result["overlay_bytes"] == {"binary": len(jax_holdscodec.encode_holds(recs)),
                                       "json": len(json.dumps(recs))}


def test_placement_kernel_is_refused_with_its_reason():
    out = subprocess.run([sys.executable, "-m", MODULE, "--placement-kernel"],
                         capture_output=True, text=True, timeout=60, cwd=REPO)
    assert out.returncode == 2
    assert out.stdout == ""
    lines = out.stderr.splitlines()
    assert len(lines) == 1, out.stderr
    assert "--placement-kernel" in lines[0] and "no twin" in lines[0]
