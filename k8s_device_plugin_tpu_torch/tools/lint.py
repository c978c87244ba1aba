"""tpu-lint over the port: the project's static analysis CLI.

Runs the :mod:`k8s_device_plugin_tpu_torch.analysis.rules` engine over the
port's package, applies the port's checked-in baseline
(``analysis/baseline.json``: every grandfathered finding carries a one-line
justification), and exits non-zero on any new finding::

    python -m k8s_device_plugin_tpu_torch.tools.lint --self-test   # engine
    python -m k8s_device_plugin_tpu_torch.tools.lint               # repo scan

``--self-test`` proves every rule on a seeded violation and its clean twin
(the checked-in ``tests/lint_fixtures/`` modules when they are beside the
package, the embedded corpus below otherwise), so a rule that silently
stops matching fails here.

Other modes: ``--json`` (machine output), ``--no-baseline`` (show
everything), ``--write-baseline`` (regenerate; every new entry gets a
``FIXME: justify`` placeholder that the default scan then refuses),
``--rules TPL001,TPL006`` (narrow the set). Exit codes: 0 clean, 1 a new
finding or an unjustified baseline entry (or a failed self-test), 2 an
unknown rule id.

It imports neither ``torch`` nor ``jax``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

from ..analysis import registry_scan as scan
from ..analysis import rules as R


def _human(findings: List[R.LintFinding]) -> str:
    out = []
    for f in findings:
        slug = R.RULES_BY_ID[f.rule].slug
        out.append(f"{f.path}:{f.line}: {f.rule} [{slug}] {f.message}")
    return "\n".join(out)


def run_scan(
    baseline_path: Optional[str] = None,
    use_baseline: bool = True,
    rules: Optional[set] = None,
) -> dict:
    findings = R.run_rules(rules=rules)
    baseline = R.load_baseline(baseline_path) if use_baseline else []
    new, grandfathered, stale = R.apply_baseline(findings, baseline)
    unjustified = [
        e for e in baseline
        if not str(e.get("justification", "")).strip()
        or str(e.get("justification", "")).startswith("FIXME")
    ]
    return {
        "new": [f.to_dict() for f in new],
        "grandfathered": [f.to_dict() for f in grandfathered],
        "stale_baseline": stale,
        "unjustified_baseline": unjustified,
        "rules": [
            {"id": r.id, "slug": r.slug, "summary": r.summary,
             "motivated_by": r.motivated_by}
            for r in R.RULES
        ],
    }


# ---------------------------------------------------------------------------
# --self-test: one seeded violation + one clean twin per rule
# ---------------------------------------------------------------------------

# Fallback corpus for --self-test when the checked-in fixture modules
# (tests/lint_fixtures/: the authoritative per-rule corpus, shared with
# both planes' lint tests so the gates cannot drift) are not shipped
# beside the package. Each snippet is (rule_id, bad_source, ok_source),
# written to a temp dir and scanned as files (the engine's only input
# shape); the doc-side rules are judged against the real repo docs, so
# the bad names below must never appear there.
_SEEDS = [
    (
        "TPL001",
        "import threading\n"
        "def loop():\n"
        "    pass\n"
        "t = threading.Thread(target=loop, daemon=True)\n",
        "import threading\n"
        "from k8s_device_plugin_tpu_torch.utils import profiling\n"
        "def loop():\n"
        "    pass\n"
        "t = threading.Thread(\n"
        "    target=profiling.supervised('selftest_loop', loop),\n"
        "    daemon=True,\n"
        ")\n",
    ),
    (
        "TPL002",
        "import threading\n"
        "from k8s_device_plugin_tpu_torch.utils import profiling\n"
        "def loop():\n"
        "    while True:\n"
        "        pass\n"
        "t = threading.Thread(\n"
        "    target=profiling.supervised('selftest_loop', loop),\n"
        ")\n",
        "import threading\n"
        "from k8s_device_plugin_tpu_torch.utils import profiling\n"
        "def loop():\n"
        "    hb = profiling.HEARTBEATS.register('selftest_loop')\n"
        "    while True:\n"
        "        hb.beat()\n"
        "t = threading.Thread(\n"
        "    target=profiling.supervised('selftest_loop', loop),\n"
        ")\n",
    ),
    (
        "TPL003",
        "FIXTURE_REGISTRY = None\n"
        "BOGUS = FIXTURE_REGISTRY.counter(\n"
        "    'tpu_selftest_never_documented_total', 'nope')\n",
        "FIXTURE_REGISTRY = None\n"
        "OK = FIXTURE_REGISTRY.counter(\n"
        "    'tpu_build_info', 'documented family')\n",
    ),
    (
        "TPL004",
        "RECORDER = None\n"
        "RECORDER.record('selftest_never_documented_kind', 'msg')\n",
        "RECORDER = None\n"
        "RECORDER.record('allocate', 'msg')\n",
    ),
    (
        "TPL005",
        "LEDGER = None\n"
        "LEDGER.record('selftest_never_documented_kind', 'r', 'm')\n",
        "LEDGER = None\n"
        "LEDGER.record('filter_reject', 'r', 'm')\n",
    ),
    (
        "TPL006",
        "import time, threading\n"
        "_lock = threading.Lock()\n"
        "def f():\n"
        "    with _lock:\n"
        "        time.sleep(1)\n",
        "import time, threading\n"
        "_lock = threading.Lock()\n"
        "def f():\n"
        "    with _lock:\n"
        "        x = 1\n"
        "    time.sleep(1)\n",
    ),
    (
        "TPL007",
        "def f():\n"
        "    try:\n"
        "        pass\n"
        "    except:\n"
        "        pass\n",
        "def f():\n"
        "    try:\n"
        "        pass\n"
        "    except BaseException:\n"
        "        raise\n",
    ),
    (
        "TPL008",
        "def debug_payload(path):\n"
        "    if path == '/debug/selftest-unlisted':\n"
        "        return {}\n",
        "def debug_payload(path):\n"
        "    if path == '/debug/events':\n"
        "        return {}\n",
    ),
    (
        "TPL009",
        "tracing = None\n"
        "def f():\n"
        "    with tracing.span('selftest.never_documented'):\n"
        "        pass\n",
        "tracing = None\n"
        "def f():\n"
        "    with tracing.span('extender.filter'):\n"
        "        pass\n",
    ),
    (
        "TPL010",
        "def f(client):\n"
        "    return client._attempt('GET', '/api/v1/pods')\n",
        "class C:\n"
        "    def _attempt(self, method, path):\n"
        "        return self._session.request(method, path)\n"
        "    def get(self, path):\n"
        "        return self.resilience.call(\n"
        "            lambda: self._attempt('GET', path))\n",
    ),
    (
        "TPL011",
        "FIXTURE_REGISTRY = None\n"
        "PROD = FIXTURE_REGISTRY.counter(\n"
        "    'tpu_selftest_sim_score_total', 'prod')\n"
        "def run_sim(factory):\n"
        "    reg = factory()\n"
        "    return reg.counter(\n"
        "        'tpu_selftest_sim_score_total', 'collides')\n",
        "FIXTURE_REGISTRY = None\n"
        "PROD = FIXTURE_REGISTRY.counter(\n"
        "    'tpu_selftest_sim_score_total', 'prod')\n"
        "def run_sim(factory):\n"
        "    reg = factory()\n"
        "    return reg.counter(\n"
        "        'tpu_selftest_sim_run_events_total', 'run-local')\n",
    ),
]


def _seed_corpus() -> tuple:
    """(corpus, [(rule_id, bad_src, ok_src), ...]): the checked-in
    fixture modules when running in the repo (one corpus shared with the
    lint tests), the embedded _SEEDS otherwise."""
    fixdir = os.path.join(scan.repo_root(), "tests", "lint_fixtures")
    seeds = []
    for rule_id, bad_src, ok_src in _SEEDS:
        bad = os.path.join(fixdir, f"{rule_id.lower()}_bad.py")
        ok = os.path.join(fixdir, f"{rule_id.lower()}_ok.py")
        if not (os.path.exists(bad) and os.path.exists(ok)):
            return "embedded", list(_SEEDS)
        with open(bad) as f:
            bad_src = f.read()
        with open(ok) as f:
            ok_src = f.read()
        seeds.append((rule_id, bad_src, ok_src))
    return "fixtures", seeds


def self_test() -> int:
    failures: List[str] = []
    corpus, seeds = _seed_corpus()
    with tempfile.TemporaryDirectory() as td:
        for rule_id, bad_src, ok_src in seeds:
            bad = os.path.join(td, f"{rule_id.lower()}_bad.py")
            ok = os.path.join(td, f"{rule_id.lower()}_ok.py")
            with open(bad, "w") as f:
                f.write(bad_src)
            with open(ok, "w") as f:
                f.write(ok_src)
            got = R.run_rules(files=[bad], rules={rule_id})
            if not any(f.rule == rule_id for f in got):
                failures.append(
                    f"{rule_id}: seeded violation not detected"
                )
            clean = R.run_rules(files=[ok], rules={rule_id})
            if any(f.rule == rule_id for f in clean):
                failures.append(
                    f"{rule_id}: clean twin produced a finding: "
                    f"{[f.message for f in clean]}"
                )
    # The scanner inventories must be non-empty on the real tree —
    # an AST-pattern drift that empties one would otherwise make
    # every doc-lockstep check vacuously green.
    for name, got in (
        ("flight kinds", scan.flight_kind_sites()),
        ("ledger kinds", scan.ledger_kind_sites()),
        ("span names", scan.span_name_sites()),
        ("metric families", scan.metric_family_sites()),
        ("debug endpoints", scan.debug_endpoint_keys()),
    ):
        if not got:
            failures.append(f"scanner inventory empty: {name}")
    exact, prefixes = scan.heartbeat_names()
    if "gang_tick" not in exact or not prefixes:
        failures.append(
            f"heartbeat inventory implausible: {sorted(exact)[:5]}... "
            f"prefixes={sorted(prefixes)}"
        )
    # The static metric inventory must agree with the runtime
    # registries — the scanner IS the lockstep tests' source of truth.
    from ..utils import metrics as M

    runtime = set(M.REGISTRY._metrics) | set(
        M.EXTENDER_REGISTRY._metrics
    )
    static = {v for v, _p, _l in scan.metric_family_sites()}
    if runtime != static:
        failures.append(
            f"static vs runtime metric inventory drift: "
            f"only-static={sorted(static - runtime)} "
            f"only-runtime={sorted(runtime - static)}"
        )
    result = {
        "lint_self_test": "ok" if not failures else "FAILED",
        "corpus": corpus,
        "rules_proven": [s[0] for s in seeds],
        "failures": failures,
    }
    print(json.dumps(result, indent=1))
    return 0 if not failures else 1


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu-lint",
        description="project-native static analysis "
        "(docs/analysis.md has the rule table)",
    )
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--baseline", default=None,
                   help="baseline file "
                   "(default: analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report grandfathered findings as new")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline from the current "
                   "findings (new entries get a FIXME justification "
                   "the default scan refuses)")
    p.add_argument("--rules", default="",
                   help="comma-separated rule ids to run "
                   "(default: all)")
    p.add_argument("--self-test", action="store_true",
                   help="prove every rule on embedded seeded "
                   "violations + scanner sanity; exit 0/1")
    a = p.parse_args(argv)

    if a.self_test:
        return self_test()

    rules = (
        {r.strip().upper() for r in a.rules.split(",") if r.strip()}
        or None
    )
    if rules:
        unknown = rules - set(R.RULES_BY_ID)
        if unknown:
            # A typo'd --rules must not silently run ZERO rules and
            # report a vacuously green scan.
            print(
                f"error: unknown rule id(s): {sorted(unknown)} "
                f"(known: {sorted(R.RULES_BY_ID)})",
                file=sys.stderr,
            )
            return 2
    report = run_scan(
        baseline_path=a.baseline,
        use_baseline=not a.no_baseline,
        rules=rules,
    )

    if a.write_baseline:
        path = a.baseline or R.BASELINE_PATH
        existing = R.load_baseline(a.baseline)
        old = {
            (e.get("rule"), e.get("path"), e.get("key")):
            e.get("justification", "")
            for e in existing
        }
        entries = []
        for f in report["new"] + report["grandfathered"]:
            just = old.get(
                (f["rule"], f["path"], f["key"]),
                "FIXME: justify this grandfathered finding",
            )
            entries.append({
                "rule": f["rule"], "path": f["path"],
                "key": f["key"], "justification": just,
            })
        if rules:
            # A --rules-narrowed run only re-derives THOSE rules'
            # entries; every other rule's grandfathered findings (and
            # their hand-written justifications) carry over verbatim
            # — a baseline refresh of one rule must not delete the
            # rest of the file.
            entries.extend(
                e for e in existing if e.get("rule") not in rules
            )
        with open(path, "w") as fh:
            json.dump({"findings": entries}, fh, indent=1)
            fh.write("\n")
        print(f"baseline written: {path} ({len(entries)} entries)")
        return 0

    if a.json:
        print(json.dumps(report, indent=1))
    else:
        new = [R.LintFinding(**f) for f in report["new"]]
        if new:
            print(_human(new))
        for e in report["stale_baseline"]:
            print(
                f"note: stale baseline entry (finding no longer "
                f"fires): {e.get('rule')} {e.get('path')} "
                f"{e.get('key')}", file=sys.stderr,
            )
        for e in report["unjustified_baseline"]:
            print(
                f"error: baseline entry without a justification: "
                f"{e.get('rule')} {e.get('path')} {e.get('key')}",
                file=sys.stderr,
            )
        n_new = len(report["new"])
        n_old = len(report["grandfathered"])
        print(
            f"tpu-lint: {n_new} new finding(s), {n_old} "
            f"grandfathered (baseline), "
            f"{len(report['stale_baseline'])} stale baseline "
            f"entr(ies)"
        )
    bad = report["new"] or report["unjustified_baseline"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
