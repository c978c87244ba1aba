"""The port's tpu-lint (``analysis/``, ``tools/lint.py``), the audit's
``loop_inventory`` and the span counters, against the JAX package's.

* The engines: on every seeded fixture of ``tests/lint_fixtures/`` the JAX
  ``rules.run_rules`` and the port's give the same ``(rule, line, key)``
  findings, rule by rule and with every rule on; over the port's tree and
  over the JAX tree, judged against the same shared docs, both engines give
  the same findings.
* The scanners: every inventory (flight, ledger, span, metric,
  local-registry, uptime, heartbeat, debug index and debug dispatch) is the
  same from both scanners over both trees.
* The JAX ``tests/test_analysis.py`` cases of the engine, the CLI and the
  audit, each on both planes; the lockdep and ``lock_order`` cases run on
  both planes in ``tests/test_torch_profiling.py`` and
  ``tests/test_torch_audit.py`` and are not repeated here.
* The port's own: its tree clean modulo its baseline (no stale and no
  unjustified entry, none covering the span counters), its static families
  equal to its runtime registries, the embedded self-test corpus, the docs'
  addendum, and each plane's trace-span counter counting on its own
  registry.

Temporary trees sit under short ``/tmp/lnt*`` dirs.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import types

import pytest

from k8s_device_plugin_tpu import audit as jax_audit
from k8s_device_plugin_tpu.analysis import registry_scan as jax_scan
from k8s_device_plugin_tpu.analysis import rules as jax_rules
from k8s_device_plugin_tpu.tools import lint as jax_lint
from k8s_device_plugin_tpu.utils import metrics as jax_metrics
from k8s_device_plugin_tpu.utils import profiling as jax_profiling
from k8s_device_plugin_tpu.utils import tracing as jax_tracing
from k8s_device_plugin_tpu_torch import audit
from k8s_device_plugin_tpu_torch.analysis import registry_scan as scan
from k8s_device_plugin_tpu_torch.analysis import rules
from k8s_device_plugin_tpu_torch.tools import lint
from k8s_device_plugin_tpu_torch.utils import metrics, profiling, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")

PLANES = {
    "jax": types.SimpleNamespace(
        rules=jax_rules, scan=jax_scan, lint=jax_lint, audit=jax_audit,
        profiling=jax_profiling, tracing=jax_tracing, module="k8s_device_plugin_tpu",
        registry_for=lambda service: (jax_metrics.EXTENDER_REGISTRY if service == "extender"
                                      else jax_metrics.REGISTRY)),
    "torch": types.SimpleNamespace(
        rules=rules, scan=scan, lint=lint, audit=audit, profiling=profiling,
        tracing=tracing, module="k8s_device_plugin_tpu_torch",
        registry_for=metrics.registry_for),
}
TREES = {"port": scan.package_files, "jax": jax_scan.package_files}


@pytest.fixture(params=sorted(PLANES))
def plane(request):
    return PLANES[request.param]


def fixture(name: str) -> str:
    return os.path.join(FIXTURES, name)


def expected_lines(path: str, rule_id: str):
    with open(path) as f:
        return [i for i, line in enumerate(f, start=1) if f"LINT-EXPECT: {rule_id}" in line]


def triples(findings):
    return sorted((f.rule, f.path, f.line, f.key) for f in findings)


# -- the engines on the seeded fixtures --------------------------------------------


@pytest.mark.parametrize("rule_id", sorted(rules.RULES_BY_ID))
def test_seeded_violation_fires_exactly(rule_id):
    """Each rule's bad fixture fires at exactly its ``LINT-EXPECT`` lines on
    the port, its clean twin fires nothing, and the JAX engine gives the
    same findings on both. TPL008's fixtures hold no ``DEBUG_ENDPOINTS``, so
    each engine judges them against its own package's index (both list
    ``/debug/events``, neither the fixture's unlisted path); TPL011's carry
    their own production ``*REGISTRY`` site, so no engine falls back to its
    package's families."""
    bad = fixture(f"{rule_id.lower()}_bad.py")
    ok = fixture(f"{rule_id.lower()}_ok.py")
    if rule_id == "TPL008":
        assert scan.debug_endpoint_keys([bad]) == [] == jax_scan.debug_endpoint_keys([bad])
        for s in (scan, jax_scan):
            keys = {k for k, _p, _l in s.debug_endpoint_keys()}
            assert "/debug/events" in keys and "/debug/fixture-unlisted" not in keys
    if rule_id == "TPL011":
        assert scan.metric_family_sites([bad]) == jax_scan.metric_family_sites([bad]) != []
    exp = expected_lines(bad, rule_id)
    assert exp, f"fixture {bad} has no LINT-EXPECT marker"
    got = rules.run_rules(files=[bad], rules={rule_id})
    assert sorted((f.rule, f.line) for f in got) == [(rule_id, ln) for ln in exp]
    assert all(f.path == os.path.relpath(bad, REPO) for f in got)
    assert triples(got) == triples(jax_rules.run_rules(files=[bad], rules={rule_id}))
    assert rules.run_rules(files=[ok], rules={rule_id}) == []
    assert jax_rules.run_rules(files=[ok], rules={rule_id}) == []


def test_fixture_corpus_all_rules_equal_jax():
    """Every rule at once over the whole fixture corpus in one scan (the
    TPL008 fallback to each package's index taken once, TPL011 judged
    against the corpus's own production sites): the same findings, one
    rule's marked lines each."""
    files = [fixture(f) for f in sorted(os.listdir(FIXTURES)) if f.endswith(".py")]
    assert len(files) == 2 * len(rules.RULES)
    port = rules.run_rules(files=files)
    assert triples(port) == triples(jax_rules.run_rules(files=files))
    for rule_id in rules.RULES_BY_ID:
        bad = fixture(f"{rule_id.lower()}_bad.py")
        rel = os.path.relpath(bad, REPO)
        lines = sorted(f.line for f in port if f.rule == rule_id and f.path == rel)
        assert lines == expected_lines(bad, rule_id), rule_id


@pytest.fixture(scope="module")
def shared_docs():
    """The shared operator docs alone (no port addendum), for judging both
    engines against the same text."""
    d = tempfile.mkdtemp(prefix="lnt", dir="/tmp")
    for name in ("metrics.md", "observability.md"):
        os.symlink(os.path.join(REPO, "docs", name), os.path.join(d, name))
    yield d
    shutil.rmtree(d)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_engines_agree_over_both_trees(tree, shared_docs):
    """Every rule over a whole tree, with the full-repo checks (ghost
    families, undocumented ``/debug`` keys) on."""
    files = TREES[tree]()
    port = rules.run_rules(files=files, docs_dir=shared_docs, full_repo=True)
    jax = jax_rules.run_rules(files=files, docs_dir=shared_docs, full_repo=True)
    assert triples(port) == triples(jax)
    if tree == "port":
        # Judged against the shared doc alone, the port's one family of its
        # own is undocumented; the addendum documents it (the clean scan).
        assert ("TPL003", "k8s_device_plugin_tpu_torch/utils/metrics.py",
                "tpu_node_best_set_score") in {(f.rule, f.path, f.key) for f in port}


# -- the scanners ---------------------------------------------------------------------

INVENTORIES = ("flight_kind_sites", "ledger_kind_sites", "span_name_sites",
               "metric_family_sites", "local_registry_family_sites", "uptime_families",
               "heartbeat_names", "debug_endpoint_keys", "debug_path_compare_sites")


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("inventory", INVENTORIES)
def test_scanner_inventories_equal_jax(inventory, tree):
    files = TREES[tree]()
    port = getattr(scan, inventory)(files)
    assert port == getattr(jax_scan, inventory)(files)
    assert port or inventory == "local_registry_family_sites"


def test_doc_side_reads_the_shared_doc_and_the_addendum():
    """The port reads ``docs/<name>`` followed by ``docs/torch/<name>``:
    JAX's documented set plus the addendum's table, and its lines still
    point into the shared doc."""
    addendum = open(os.path.join(REPO, "docs", "torch", "metrics.md")).read()
    rows = set(re.findall(r"^\| `(tpu_[a-z0-9_]+)` \|", addendum, re.M))
    assert rows == {"tpu_node_best_set_score"}
    assert scan.documented_metric_families() == jax_scan.documented_metric_families() | rows
    addendum = open(os.path.join(REPO, "docs", "torch", "observability.md")).read()
    spans = set(re.findall(r"^\| `([a-z][a-z0-9_.]*)` \|", addendum, re.M))
    assert spans == {"train.step", "train.forward", "train.backward", "train.optimizer",
                     "moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.backward"}
    assert (scan.documented_backticked("observability.md")
            == jax_scan.documented_backticked("observability.md") | spans)
    assert scan.doc_line_of("observability.md", "`train.step`") == 0
    path, line = scan.doc_site("observability.md", "`train.step`")
    assert path == "docs/torch/observability.md" and line > 0
    for family in ("tpu_build_info", "tpu_plugin_trace_spans_total"):
        line = jax_scan.doc_line_of("metrics.md", f"`{family}`")
        assert line and scan.doc_line_of("metrics.md", f"`{family}`") == line
        assert scan.doc_site("metrics.md", f"`{family}`") == ("docs/metrics.md", line)
    assert scan.doc_line_of("metrics.md", "`tpu_node_best_set_score`") == 0
    path, line = scan.doc_site("metrics.md", "`tpu_node_best_set_score`")
    assert path == "docs/torch/metrics.md" and line > 0


# -- the JAX engine and CLI cases, on both planes -----------------------------------


def test_rule_narrowing_does_not_leak_sibling_thread_rules(plane):
    assert plane.rules.run_rules(files=[fixture("tpl001_bad.py")], rules={"TPL002"}) == []
    assert plane.rules.run_rules(files=[fixture("tpl002_bad.py")], rules={"TPL001"}) == []


@pytest.fixture
def short_tmp():
    d = tempfile.mkdtemp(prefix="lnt", dir="/tmp")
    yield d
    shutil.rmtree(d)


def test_positional_thread_target_is_checked(plane, short_tmp):
    p = os.path.join(short_tmp, "positional.py")
    with open(p, "w") as f:
        f.write("import threading\ndef loop():\n    pass\nt = threading.Thread(None, loop)\n")
    assert [f.rule for f in plane.rules.run_rules(files=[p], rules={"TPL001"})] == ["TPL001"]


def test_unknown_rule_id_is_an_error_not_a_green_scan(plane):
    assert plane.lint.main(["--rules", "TPL999"]) == 2


def test_lowercase_transient_registry_is_not_inventoried(plane, short_tmp):
    p = os.path.join(short_tmp, "bench_helper.py")
    with open(p, "w") as f:
        f.write("registry = None\n"
                "X = registry.counter('tpu_bench_scratch_total', 'nope')\n"
                "GOOD_REGISTRY = None\n"
                "Y = GOOD_REGISTRY.counter('tpu_real_total', 'yes')\n")
    assert {v for v, _p, _l in plane.scan.metric_family_sites([p])} == {"tpu_real_total"}
    assert {v for v, _p, _l in plane.scan.local_registry_family_sites([p])} == {
        "tpu_bench_scratch_total"}


def test_inline_suppression_silences_a_finding(plane, short_tmp):
    src = ("import threading\n"
           "def loop():\n"
           "    pass\n"
           "# short-lived by design  # tpu-lint: disable=TPL001\n"
           "t = threading.Thread(target=loop)\n")
    p = os.path.join(short_tmp, "suppressed.py")
    with open(p, "w") as f:
        f.write(src)
    assert plane.rules.run_rules(files=[p], rules={"TPL001"}) == []
    p2 = os.path.join(short_tmp, "unsuppressed.py")
    with open(p2, "w") as f:
        f.write(src.replace("# short-lived by design  # tpu-lint: disable=TPL001\n", ""))
    assert len(plane.rules.run_rules(files=[p2], rules={"TPL001"})) == 1


def test_baseline_matching_and_staleness(plane):
    R = plane.rules
    f = R.LintFinding("TPL006", "pkg/x.py", 10, "msg", key="lock:self._lock->open")
    entry = {"rule": "TPL006", "path": "pkg/x.py", "key": "lock:self._lock->open",
             "justification": "why"}
    assert R.apply_baseline([f], [entry]) == ([], [f], [])
    # Line churn does not break the match (key-based, not line-based).
    f2 = R.LintFinding("TPL006", "pkg/x.py", 99, "msg", key="lock:self._lock->open")
    new, old, _stale = R.apply_baseline([f2], [entry])
    assert not new and old == [f2]
    # A fixed finding leaves its entry stale.
    assert R.apply_baseline([], [entry])[2] == [entry]


def test_lint_cli_self_test_and_scan():
    """``--self-test`` on the checked-in fixture corpus proves every rule,
    and ``--json`` over the port's tree reports nothing new, no stale and no
    unjustified entry (the JAX CLI's run is ``tests/test_analysis.py``'s)."""
    module = "k8s_device_plugin_tpu_torch.tools.lint"
    r = subprocess.run([sys.executable, "-m", module, "--self-test"],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(r.stdout)
    assert doc["lint_self_test"] == "ok" and doc["corpus"] == "fixtures"
    assert sorted(doc["rules_proven"]) == sorted(rules.RULES_BY_ID)
    r = subprocess.run([sys.executable, "-m", module, "--json"],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    report = json.loads(r.stdout)
    assert report["new"] == [] and report["stale_baseline"] == []
    assert report["unjustified_baseline"] == []


def test_lint_self_test_uses_the_checked_in_fixture_corpus(capsys):
    """In the repo, the port's ``--self-test`` proves the rules on the same
    fixture files as the tests: one corpus, no drift."""
    assert lint.main(["--self-test"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["corpus"] == "fixtures" and doc["failures"] == []


def test_write_baseline_with_narrowed_rules_preserves_other_entries(plane, short_tmp):
    """``--write-baseline --rules TPL001`` keeps every other rule's entries
    and their justifications."""
    bl = os.path.join(short_tmp, "baseline.json")
    kept = {"rule": "TPL006", "path": f"{plane.module}/utils/statestore.py",
            "key": "lock:self._lock->os.fsync", "justification": "the WAL ordering contract"}
    with open(bl, "w") as f:
        json.dump({"findings": [kept]}, f)
    assert plane.lint.main(["--rules", "TPL001", "--write-baseline", "--baseline", bl]) == 0
    with open(bl) as f:
        entries = json.load(f)["findings"]
    assert kept in entries
    assert {e["rule"] for e in entries} <= {"TPL001", "TPL006"}


def test_write_baseline_marks_new_entries_fixme_and_the_scan_refuses_them(short_tmp, capsys):
    """A regenerated baseline's new entries carry the FIXME placeholder,
    which the default scan then refuses (exit 1) until justified."""
    bl = os.path.join(short_tmp, "baseline.json")
    with open(bl, "w") as f:
        json.dump({"findings": []}, f)
    assert lint.main(["--write-baseline", "--baseline", bl]) == 0
    with open(bl) as f:
        entries = json.load(f)["findings"]
    assert entries and all(e["justification"].startswith("FIXME") for e in entries)
    capsys.readouterr()
    assert lint.main(["--json", "--baseline", bl]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["new"] == [] and len(report["unjustified_baseline"]) == len(entries)


def test_scanner_inventories_are_plausible(plane):
    s = plane.scan
    assert {"allocate", "loop_stall", "lockdep_cycle"} <= {v for v, _p, _l in s.flight_kind_sites()}
    assert {"filter_reject", "gang_admitted"} <= {v for v, _p, _l in s.ledger_kind_sites()}
    assert {"extender.filter", "gang.admit"} <= {v for v, _p, _l in s.span_name_sites()}
    assert {"/debug/events", "/debug/lockdep"} <= {v for v, _p, _l in s.debug_endpoint_keys()}
    for _v, p, ln in s.flight_kind_sites():
        assert p.startswith(plane.module + "/") and p.endswith(".py") and ln > 0


def test_scanner_heartbeat_inventory(plane):
    exact, prefixes = plane.scan.heartbeat_names()
    for name in ("gang_tick", "audit_sweep", "telemetry_sampler", "stall_watchdog",
                 "node_event_applier", "topology_publisher", "fs_watcher", "stack_sampler",
                 "dra_slice_publisher"):
        assert name in exact, (name, sorted(exact))
    assert any(p.startswith("index_warm") for p in prefixes), prefixes
    assert any(p.startswith("lease_renew") for p in prefixes), prefixes
    assert plane.scan.loop_name_known("index_warm_7", exact, prefixes)
    assert not plane.scan.loop_name_known("totally_unknown", exact, prefixes)


def test_heartbeat_inventories_of_the_two_planes_are_equal():
    """The port runs the same loops under the same names: 18 exact names
    and the prefixes ``lease_renew_``, ``http_`` and ``index_warm_``."""
    exact, prefixes = scan.heartbeat_names()
    assert (exact, prefixes) == jax_scan.heartbeat_names()
    assert len(exact) == 18 and prefixes == {"lease_renew_", "http_", "index_warm_"}


# -- the port's own checks ------------------------------------------------------------

NO_TWIN = {"tpu_plugin_coord_assumption_mismatches_total", "tpu_placement_kernel_mode",
           "tpu_placement_candidate_spaces", "tpu_node_largest_free_box_chips",
           "tpu_node_topology_fragmentation"}
SIMULATOR = {"tpu_sim_runs_total", "tpu_sim_time_to_admit_seconds", "tpu_sim_utilization_ratio",
             "tpu_sim_fragmentation_avg", "tpu_sim_preemption_churn_cost",
             "tpu_sim_defrag_efficiency_chips_per_eviction", "tpu_sim_baseline_delta"}


def test_repo_scan_is_clean_modulo_baseline():
    findings = rules.run_rules()
    baseline = rules.load_baseline()
    new, grandfathered, stale = rules.apply_baseline(findings, baseline)
    assert not new, [f.to_dict() for f in new]
    assert not stale, stale
    assert len(grandfathered) == len(baseline)
    for e in baseline:
        just = str(e.get("justification", "")).strip()
        assert just and not just.startswith("FIXME"), e


def test_baseline_holds_exactly_the_decided_entries():
    """The port's baseline: the statestore's two deliberate holds and a
    ghost for each family with no twin by decision. The simulator's seven
    families are registered (extender/simulator.py), so none of them has an
    entry; none covers a span counter either: both are registered."""
    baseline = rules.load_baseline()
    keys = {(e["rule"], e["path"], e["key"]) for e in baseline}
    assert len(keys) == len(baseline) == 7
    store = "k8s_device_plugin_tpu_torch/utils/statestore.py"
    assert keys == ({("TPL006", store, "lock:self._lock->os.fsync"),
                     ("TPL006", store, "lock:self._lock->open")}
                    | {("TPL003", "docs/metrics.md", f"ghost:{fam}") for fam in NO_TWIN})
    for e in baseline:
        fam = e["key"].removeprefix("ghost:")
        if fam in NO_TWIN:
            assert "no twin, by decision" in e["justification"]
        assert "trace_spans" not in e["key"] and "tpu_sim_" not in e["key"]
    static = {v for v, _p, _l in scan.metric_family_sites()}
    assert {"tpu_plugin_trace_spans_total", "tpu_extender_trace_spans_total"} <= static
    assert SIMULATOR <= static


def test_scanner_static_metrics_equal_runtime_registries():
    static = {v for v, _p, _l in scan.metric_family_sites()}
    runtime = set(metrics.REGISTRY._metrics) | set(metrics.EXTENDER_REGISTRY._metrics)
    assert static == runtime
    assert scan.uptime_families() == {"tpu_plugin_uptime_seconds", "tpu_extender_uptime_seconds"}


def test_self_test_embedded_corpus_proves_every_rule(monkeypatch, capsys):
    """Where ``tests/lint_fixtures/`` is not beside the package, the
    self-test proves every rule on its embedded corpus."""
    root = tempfile.mkdtemp(prefix="lnt", dir="/tmp")
    try:
        os.symlink(os.path.join(REPO, "docs"), os.path.join(root, "docs"))
        monkeypatch.setattr(scan, "repo_root", lambda: root)
        assert lint.self_test() == 0
    finally:
        shutil.rmtree(root)
    doc = json.loads(capsys.readouterr().out)
    assert doc["corpus"] == "embedded" and doc["failures"] == []
    assert sorted(doc["rules_proven"]) == sorted(rules.RULES_BY_ID)


def test_analysis_docs_in_lockstep():
    """The shared rule reference names every port rule by id and slug; the
    README's port section says how to run the port's lint, where its
    baseline is and what the docs' addendum holds. (The JAX case's
    ``scripts/tier1.sh`` and ``check-tsan`` needles have no port twin: the
    port has no tier-1 script of its own and no native code.)"""
    doc = open(os.path.join(REPO, "docs", "analysis.md")).read()
    for rule in rules.RULES:
        assert f"`{rule.id}`" in doc and f"`{rule.slug}`" in doc, rule.id
        assert (rule.id, rule.slug) == (jax_rules.RULES_BY_ID[rule.id].id,
                                        jax_rules.RULES_BY_ID[rule.id].slug)
    assert len(rules.RULES) == len(jax_rules.RULES) == 11
    readme = open(os.path.join(REPO, "README.md")).read()
    port = readme[readme.index("## PyTorch/CUDA port"):readme.index("## Component map")]
    for needle in ("python -m k8s_device_plugin_tpu_torch.tools.lint", "--self-test",
                   "analysis/baseline.json", "docs/torch/metrics.md", "loop_inventory"):
        assert needle in port, needle


# -- the audit's loop_inventory ------------------------------------------------------


def test_loop_inventory_warns_on_statically_invisible_loop(plane):
    hb = plane.profiling.HEARTBEATS
    hb.register("definitely_unknown_loop_xyz")
    try:
        mine = [f for f in plane.audit.check_loop_inventory()
                if f.chip == "definitely_unknown_loop_xyz"]
        assert len(mine) == 1
        assert (mine[0].severity, mine[0].invariant) == (plane.audit.WARNING, "loop_inventory")
    finally:
        hb.unregister("definitely_unknown_loop_xyz")
    # Known names, exact and prefixed, stay silent.
    hb.register("gang_tick")
    hb.register("index_warm_3")
    try:
        names = {f.chip for f in plane.audit.check_loop_inventory()}
        assert "gang_tick" not in names and "index_warm_3" not in names
    finally:
        hb.unregister("gang_tick")
        hb.unregister("index_warm_3")


def test_shared_invariants_registered_on_both_audit_sets(plane):
    node_names = {i.name for i in plane.audit.NodeAudit(plugin=None).invariants()}
    sentinel = object()
    ext_names = {i.name for i in plane.audit.ExtenderAudit(
        reservations=sentinel, journal=sentinel, gang=sentinel, index=sentinel).invariants()}
    for name in ("thread_liveness", "lock_order", "loop_inventory", "degraded_consistency"):
        assert name in node_names and name in ext_names
    # Zero wired planes means zero invariants, shared ones included.
    assert plane.audit.ExtenderAudit().invariants() == []


def test_warmed_loop_inventory_keeps_no_parsed_trees(monkeypatch):
    """The extender builds the inventory before ``/readyz``; the process
    keeps the names and drops the scanner's trees."""
    expected = scan.heartbeat_names()
    assert scan._AST_CACHE
    monkeypatch.setattr(audit, "_STATIC_LOOPS", None)
    assert audit.static_loop_inventory() == expected
    assert scan._AST_CACHE == {} and scan._WALK_CACHE == {}


# -- the span counters ----------------------------------------------------------------


def span_count(registry, service: str) -> float:
    name = f"tpu_{'extender' if service == 'extender' else 'plugin'}_trace_spans_total"
    for line in registry.render().splitlines():
        if line.split(" ")[0] == name:
            return float(line.split(" ")[1])
    raise AssertionError(f"{name} not rendered")


@pytest.mark.parametrize("service", ["plugin", "extender"])
def test_finished_span_counts_on_its_services_registry(plane, service):
    """Tracing on as ``service``: one finished span reads 1 more on that
    service's registry and 0 more on the other's; with tracing off a span
    counts nowhere."""
    other = "plugin" if service == "extender" else "extender"
    mine, theirs = plane.registry_for(service), plane.registry_for(other)
    was_on, was_service = plane.tracing.enabled(), plane.tracing._service
    try:
        plane.tracing.disable()
        before = span_count(mine, service), span_count(theirs, other)
        with plane.tracing.span("lint.span_counter_off"):
            pass
        assert (span_count(mine, service), span_count(theirs, other)) == before
        plane.tracing.enable(service)
        with plane.tracing.span("lint.span_counter"):
            pass
        assert span_count(mine, service) == before[0] + 1
        assert span_count(theirs, other) == before[1]
    finally:
        plane.tracing.disable()
        if was_on:
            plane.tracing.enable(was_service)
