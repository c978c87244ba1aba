"""tpu-lint rules over the port: the JAX package's eleven checks, with its
ids and slugs, so that ``docs/analysis.md`` describes both planes.

Each rule exists because its class of violation already cost an incident
or a review round in this repo (the "motivated by" column of
``docs/analysis.md``):

========  ===========================  ====================================
id        slug                         the bug it would have caught
========  ===========================  ====================================
TPL001    unsupervised-thread          silent background-thread death
TPL002    loop-without-heartbeat       a wedged-but-alive loop the stall
                                       watchdog cannot see
TPL003    undocumented-metric          a family missing from
                                       docs/metrics.md (or documented and
                                       never registered)
TPL004    undocumented-flight-kind     a flight kind missing from the
                                       observability kind table
TPL005    undocumented-ledger-kind     a decision kind missing from the
                                       ledger kind table
TPL006    blocking-under-lock          blocking work (kube RPC, file I/O,
                                       sleep, observe) under a hot lock:
                                       the GC-callback-inside-
                                       ``Histogram.observe`` self-deadlock
TPL007    bare-except                  a bare ``except:`` or a swallowed
                                       ``BaseException``
TPL008    undocumented-debug-endpoint  a ``/debug/*`` surface served but
                                       absent from ``DEBUG_ENDPOINTS`` or
                                       the docs
TPL009    undocumented-span            a span name missing from the
                                       observability span table
TPL010    raw-kube-call                an API-server hop that bypasses the
                                       resilience wrapper
TPL011    sim-metric-collision         a local (bench, simulator) registry
                                       minting a production family name
========  ===========================  ====================================

Suppression: ``# tpu-lint: disable=TPL006`` on the offending line (or the
line before it) with a short reason in the same comment. Grandfathered
findings live in the port's ``baseline.json`` next to this module: every
entry carries a one-line justification, and the CLI refuses an entry
without one.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import registry_scan as scan


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    slug: str
    summary: str
    motivated_by: str


RULES: Tuple[Rule, ...] = (
    Rule(
        "TPL001", "unsupervised-thread",
        "a threading.Thread target is not wrapped in profiling.supervised: an "
        "unhandled exception would kill the loop silently (no log level "
        "guarantee, no metric, no thread_liveness finding)",
        "silent background-thread death (fixed across 9 loops of the JAX "
        "package)",
    ),
    Rule(
        "TPL002", "loop-without-heartbeat",
        "a supervised long-lived loop (contains `while`) never registers or "
        "beats a Heartbeat: the stall watchdog cannot see it wedge",
        "the stall watchdog: a wedged loop without a heartbeat is invisible",
    ),
    Rule(
        "TPL003", "undocumented-metric",
        "a registered tpu_* metric family is absent from docs/metrics.md (or "
        "its port addendum), or documented but not registered",
        "the docs/metrics.md lockstep test class",
    ),
    Rule(
        "TPL004", "undocumented-flight-kind",
        "a RECORDER.record kind is absent from the docs/observability.md "
        "flight-event kind table",
        "the flight recorder's lockstep greps",
    ),
    Rule(
        "TPL005", "undocumented-ledger-kind",
        "a LEDGER.record kind is absent from the docs/observability.md "
        "decision kind table",
        "the decision ledger's lockstep greps",
    ),
    Rule(
        "TPL006", "blocking-under-lock",
        "a blocking call (sleep, file open, kube RPC, Histogram.observe) runs "
        "inside a `with <lock>:` block: the GC-callback-inside-observe "
        "self-deadlock shape, and a convoy on the RPC hot path",
        "the Histogram.observe GC-callback self-deadlock and the TimedLock "
        "convoy work",
    ),
    Rule(
        "TPL007", "bare-except",
        "a bare `except:` or a swallowed `except BaseException:` eats "
        "KeyboardInterrupt, SystemExit and the chaos suite's "
        "SIGKILL-simulation exceptions",
        "the chaos harness (BaseException must pass through best-effort "
        "handlers)",
    ),
    Rule(
        "TPL008", "undocumented-debug-endpoint",
        "a /debug/* path is dispatched on but missing from "
        "metrics.DEBUG_ENDPOINTS, or a DEBUG_ENDPOINTS key is missing from "
        "docs/observability.md: tpu-doctor bundles collect from "
        "DEBUG_ENDPOINTS, so an unlisted surface is absent from every "
        "support bundle",
        "the tpu-doctor bundle, which collects through DEBUG_ENDPOINTS",
    ),
    Rule(
        "TPL009", "undocumented-span",
        "a tracing span name is absent from the docs/observability.md span "
        "table",
        "the tracing plane's lockstep greps",
    ),
    Rule(
        "TPL010", "raw-kube-call",
        "a raw API-server transport hop (`._attempt(...)` or a "
        "`._session.<verb>(...)` call) outside the resilience wrapper gets no "
        "per-call deadline, no retry budget, no Retry-After handling, no "
        "circuit breaker and no outcome metric, so one hostile API-server "
        "window hangs or crashes the caller instead of degrading it",
        "hostile-API-server resilience: every kube hop rides "
        "utils/resilience",
    ),
    Rule(
        "TPL011", "sim-metric-collision",
        "a tpu_* family registered on a LOCAL registry (a receiver not ending "
        "in `REGISTRY`: the bench and simulator transient-registry "
        "convention, invisible to TPL003) reuses a production family name: "
        "the scrape cannot tell a simulated series from the real one",
        "the scheduling-quality simulator, which mints tpu_sim_* series on "
        "run-local registries beside the production families",
    ),
)

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in RULES}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str  # repo-relative
    line: int
    message: str
    # Stable identity for baseline matching: the rule's subject (a family, a
    # kind, a function's qualname, a lock->call pair), never a line number,
    # so an edit above a finding does not churn the baseline.
    key: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# -- suppression ------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*tpu-lint:\s*disable=([A-Za-z0-9_,]+)")
_LINES_CACHE: Dict[str, List[str]] = {}


def _source_lines(path: str) -> List[str]:
    if path not in _LINES_CACHE:
        with open(path, "r") as f:
            _LINES_CACHE[path] = f.read().splitlines()
    return _LINES_CACHE[path]


def _suppressed(abs_path: str, lines: Sequence[int], rule_id: str) -> bool:
    src = _source_lines(abs_path)
    for ln in lines:
        if 1 <= ln <= len(src):
            m = _SUPPRESS_RE.search(src[ln - 1])
            if m and rule_id in m.group(1).split(","):
                return True
    return False


# -- shared AST helpers -------------------------------------------------------------


class _ModuleIndex:
    """Per-module resolution: methods by enclosing class, module-level
    functions, the enclosing-class map."""

    def __init__(self, path: str):
        self.path = path
        self.tree = scan.parse_file(path)
        self.functions: Dict[str, ast.FunctionDef] = {}
        self.class_methods: Dict[str, Dict[str, ast.FunctionDef]] = {}
        self.enclosing_class: Dict[int, str] = {}
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.class_methods[node.name] = {
                    sub.name: sub for sub in node.body
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                }
                for sub in ast.walk(node):
                    self.enclosing_class.setdefault(id(sub), node.name)

    def resolve_callable(self, node: ast.AST, at: ast.AST) -> Optional[ast.FunctionDef]:
        """``self._loop`` → the method on the enclosing class; ``module_fn``
        → the module-level def; a lambda → the method it calls (the
        ``lambda n=x: self._warm_loop(n)`` idiom). None: unresolvable (a
        variable, a foreign attribute)."""
        if isinstance(node, ast.Lambda):
            for sub in ast.walk(node.body):
                if isinstance(sub, ast.Call):
                    resolved = self.resolve_callable(sub.func, at)
                    if resolved is not None:
                        return resolved
            return None
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            cls = self.enclosing_class.get(id(at))
            if cls is not None:
                return self.class_methods.get(cls, {}).get(node.attr)
            return None
        if isinstance(node, ast.Name):
            return self.functions.get(node.id)
        return None

    def one_level_callees(self, fn: ast.FunctionDef) -> List[ast.FunctionDef]:
        out: List[ast.FunctionDef] = []
        seen: Set[int] = {id(fn)}
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call):
                resolved = self.resolve_callable(sub.func, fn)
                if resolved is not None and id(resolved) not in seen:
                    seen.add(id(resolved))
                    out.append(resolved)
        return out


def _is_thread_ctor(call: ast.Call) -> bool:
    name = scan._dotted(call.func)
    return name == "Thread" or name.endswith(".Thread")


def _is_supervised_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Name):
        return f.id in ("supervised", "run_supervised")
    if isinstance(f, ast.Attribute):
        return f.attr in ("supervised", "run_supervised")
    return False


def _qualname(idx: _ModuleIndex, node: ast.AST) -> str:
    """``<file>:<Class>.<innermost def>`` of ``node`` (the key of its
    finding)."""
    cls = idx.enclosing_class.get(id(node))
    fn = None
    for candidate in scan.walk(idx.tree):
        if (isinstance(candidate, (ast.FunctionDef, ast.AsyncFunctionDef))
                and any(id(sub) == id(node) for sub in ast.walk(candidate))):
            fn = candidate.name
    parts = [p for p in (cls, fn) if p]
    return f"{os.path.basename(idx.path)}:{'.'.join(parts) or '<module>'}"


# -- TPL001 / TPL002 -------------------------------------------------------------------


def _check_threads(idx: _ModuleIndex, rel: str, out: List[LintFinding], want: Set[str]) -> None:
    for call in scan.walk(idx.tree):
        if not isinstance(call, ast.Call) or not _is_thread_ctor(call):
            continue
        target = None
        for kw in call.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is None and len(call.args) > 1:
            # threading.Thread(group, target, ...): a positional target must
            # not dodge the rule.
            target = call.args[1]
        if target is None:
            continue
        if not _is_supervised_call(target):
            if "TPL001" in want:
                out.append(LintFinding(
                    "TPL001", rel, call.lineno,
                    "threading.Thread target is not wrapped in profiling.supervised(...): "
                    "an unhandled exception kills this loop silently (no died counter, no "
                    "thread_liveness finding). Wrap the target, or suppress with a reason "
                    "if the thread is short-lived by design.",
                    key=f"thread:{ast.unparse(target)}",
                ))
            continue
        if "TPL002" not in want:
            continue
        # Supervised: the loop must now be watchable. Resolve the real loop
        # function (supervised's second argument) and require a heartbeat
        # when it runs a long-lived `while` loop.
        sup_args = target.args  # type: ignore[union-attr]
        loop_fn = idx.resolve_callable(sup_args[1], call) if len(sup_args) > 1 else None
        if loop_fn is None:
            continue  # unresolvable across modules: not provable
        fns = [loop_fn] + idx.one_level_callees(loop_fn)
        if not any(isinstance(sub, ast.While) for fn in fns for sub in ast.walk(fn)):
            continue
        seg = "\n".join(ast.unparse(fn) for fn in fns)
        if "HEARTBEATS.register" in seg or ".beat(" in seg:
            continue
        out.append(LintFinding(
            "TPL002", rel, loop_fn.lineno,
            f"supervised loop {loop_fn.name!r} runs a while-loop but never registers or "
            f"beats a Heartbeat (profiling.HEARTBEATS.register): the stall watchdog "
            f"cannot tell wedged from idle",
            key=f"loop:{_qualname(idx, loop_fn)}",
        ))


# -- TPL006 -----------------------------------------------------------------------------

_LOCK_EXPR_RE = re.compile(r"(^|[._])lock\b", re.IGNORECASE)
# The blocking kube-client verbs. The port's kube/client.py has exactly the
# JAX client's verbs, so the list is JAX's.
_KUBE_VERBS = {
    "get", "list_pods", "list_nodes", "patch_node", "patch_pod",
    "create_event", "replace", "watch_nodes", "watch_pods",
    "delete_pod", "post", "put", "list_leases",
}


def _blocking_reason(call: ast.Call) -> Optional[str]:
    f = call.func
    dotted = scan._dotted(f)
    if dotted in ("time.sleep", "sleep") or dotted.endswith(".sleep"):
        return "sleep"
    if isinstance(f, ast.Name) and f.id == "open":
        return "file I/O (open)"
    if dotted in ("os.fsync", "os.replace"):
        return f"file I/O ({dotted})"
    if isinstance(f, ast.Attribute) and f.attr == "observe":
        return ("Histogram.observe (a GC pass triggered inside observe runs "
                "gc.callbacks under the histogram lock: the self-deadlock shape)")
    if dotted.startswith("requests."):
        return f"HTTP call ({dotted})"
    if isinstance(f, ast.Attribute) and f.attr in _KUBE_VERBS:
        owner = scan._dotted(f.value)
        if "client" in owner or "resilience" in owner:
            return f"kube RPC ({f.attr})"
    return None


def _check_blocking_under_lock(idx: _ModuleIndex, rel: str, out: List[LintFinding]) -> None:
    for node in scan.walk(idx.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        lock_names = []
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                continue  # `with open(...)`, `with timed(...)` and the like
            src = ast.unparse(expr)
            if _LOCK_EXPR_RE.search(src):
                lock_names.append(src)
        if not lock_names:
            continue
        # Walk the body, skipping nested function and lambda bodies (they
        # run later, outside the hold).
        stack: List[ast.AST] = list(node.body)
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(sub, ast.Call):
                reason = _blocking_reason(sub)
                if reason is not None:
                    out.append(LintFinding(
                        "TPL006", rel, sub.lineno,
                        f"blocking call under {lock_names[0]!r}: {reason}; every other "
                        f"thread queuing on this lock stalls for the duration: move the "
                        f"blocking work outside the hold or buffer it (the "
                        f"flush_gc_pauses idiom)",
                        key=f"lock:{lock_names[0]}->{ast.unparse(sub.func)}",
                    ))
            stack.extend(ast.iter_child_nodes(sub))


# -- TPL007 -------------------------------------------------------------------------------


def _check_bare_except(idx: _ModuleIndex, rel: str, out: List[LintFinding]) -> None:
    for node in scan.walk(idx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            out.append(LintFinding(
                "TPL007", rel, node.lineno,
                "bare `except:` catches BaseException: KeyboardInterrupt, SystemExit "
                "and the chaos suite's SIGKILL-simulation exceptions are silently eaten; "
                "catch Exception (and re-raise what you cannot handle)",
                key=f"bare:{_qualname(idx, node)}",
            ))
            continue
        if "BaseException" not in ast.unparse(node.type):
            continue
        reraises = any(isinstance(sub, ast.Raise) and sub.exc is None for sub in ast.walk(node))
        if not reraises:
            out.append(LintFinding(
                "TPL007", rel, node.lineno,
                "`except BaseException:` without a bare `raise` swallows "
                "SystemExit/KeyboardInterrupt: re-raise after the cleanup, or catch "
                "Exception",
                key=f"baseexc:{_qualname(idx, node)}",
            ))


# -- TPL010 -------------------------------------------------------------------------------


def _check_raw_kube_call(idx: _ModuleIndex, rel: str, out: List[LintFinding]) -> None:
    """Every API-server hop must ride ``resilience.call``. Two raw shapes
    are flagged: a direct ``<client>._attempt(...)`` and a direct
    ``<client>._session.<verb>(...)``. Two contexts are sanctioned: anything
    lexically inside a ``*resilience*.call(...)`` argument (the wrapper's
    own thunk, ``lambda: self._attempt(...)`` in kube/client.py), and the
    body of a function named ``_attempt`` (the wrapper's one transport hop
    onto the session)."""
    sanctioned: Set[int] = set()
    for node in scan.walk(idx.tree):
        if isinstance(node, ast.Call):
            dotted = scan._dotted(node.func)
            if dotted.endswith(".call") and "resilience" in dotted:
                sanctioned.update(id(sub) for sub in ast.walk(node))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name == "_attempt":
            sanctioned.update(id(sub) for sub in ast.walk(node))
    for node in scan.walk(idx.tree):
        if not isinstance(node, ast.Call) or id(node) in sanctioned:
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        raw = f.attr == "_attempt" or (isinstance(f.value, ast.Attribute)
                                       and f.value.attr == "_session")
        if not raw:
            continue
        out.append(LintFinding(
            "TPL010", rel, node.lineno,
            f"raw kube transport call `{scan._dotted(f)}(...)` bypasses the resilience "
            f"layer: no per-call deadline, no retry budget, no Retry-After handling, no "
            f"circuit breaker, no outcome metric; go through the KubeClient verbs (or "
            f"wrap the hop in `self.resilience.call(...)`)",
            key=f"rawkube:{_qualname(idx, node)}->{f.attr}",
        ))


# -- doc-lockstep rules (TPL003/4/5/8/9) ---------------------------------------------


def _doc_rule_sites(sites: List[scan.Site], documented: Set[str], rule_id: str, doc_name: str,
                    what: str, out: List[LintFinding], abs_by_rel: Dict[str, str]) -> None:
    seen: Set[str] = set()
    for value, rel, line in sites:
        if value in documented or value in seen:
            continue
        seen.add(value)
        ap = abs_by_rel.get(rel)
        if ap and _suppressed(ap, (line, line - 1), rule_id):
            continue
        out.append(LintFinding(
            rule_id, rel, line,
            f"{what} `{value}` is not documented in docs/{doc_name} (or its port "
            f"addendum docs/{scan.ADDENDUM_DIR}/{doc_name})",
            key=value,
        ))


# -- engine --------------------------------------------------------------------------------

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def load_baseline(path: Optional[str] = None) -> List[dict]:
    p = path or BASELINE_PATH
    if not os.path.exists(p):
        return []
    with open(p, "r") as f:
        doc = json.load(f)
    return list(doc.get("findings", []))


def baseline_matches(entry: dict, finding: LintFinding) -> bool:
    return (entry.get("rule") == finding.rule and entry.get("path") == finding.path
            and entry.get("key") == finding.key)


def apply_baseline(findings: List[LintFinding], baseline: List[dict]
                   ) -> Tuple[List[LintFinding], List[LintFinding], List[dict]]:
    """(new, grandfathered, stale baseline entries)."""
    new: List[LintFinding] = []
    old: List[LintFinding] = []
    used: Set[int] = set()
    for f in findings:
        hit = next((i for i, entry in enumerate(baseline) if baseline_matches(entry, f)), None)
        if hit is None:
            new.append(f)
        else:
            used.add(hit)
            old.append(f)
    stale = [e for i, e in enumerate(baseline) if i not in used]
    return new, old, stale


def run_rules(files: Optional[Iterable[str]] = None, docs_dir: Optional[str] = None,
              rules: Optional[Set[str]] = None,
              full_repo: Optional[bool] = None) -> List[LintFinding]:
    """Run the rule set over ``files`` (default: the whole port package).

    ``full_repo`` gates the checks that only make sense over the complete
    package (a ghost family, documented and never registered, can only be
    judged when every registration site was scanned); it defaults to True
    exactly when ``files`` was not narrowed.
    """
    file_list = list(files) if files is not None else scan.package_files()
    if full_repo is None:
        full_repo = files is None
    want = rules or {r.id for r in RULES}
    out: List[LintFinding] = []
    abs_by_rel = {scan.relpath(p): p for p in file_list}

    for path in file_list:
        rel = scan.relpath(path)
        idx = _ModuleIndex(path)
        if "TPL001" in want or "TPL002" in want:
            _check_threads(idx, rel, out, want)
        if "TPL006" in want:
            _check_blocking_under_lock(idx, rel, out)
        if "TPL007" in want:
            _check_bare_except(idx, rel, out)
        if "TPL010" in want:
            _check_raw_kube_call(idx, rel, out)

    if "TPL003" in want:
        fam_sites = scan.metric_family_sites(file_list)
        documented = scan.documented_metric_families(docs_dir)
        _doc_rule_sites(fam_sites, documented, "TPL003", "metrics.md",
                        "registered metric family", out, abs_by_rel)
        if full_repo:
            registered = {v for v, _p, _l in fam_sites}
            rendered = scan.uptime_families(file_list)
            for ghost in sorted(documented - registered - rendered):
                doc_path, doc_line = scan.doc_site("metrics.md", f"`{ghost}`", docs_dir)
                out.append(LintFinding(
                    "TPL003", doc_path, doc_line,
                    f"{doc_path} documents `{ghost}` but no registry registers it (a "
                    f"renamed or removed family left its row behind)",
                    key=f"ghost:{ghost}",
                ))

    if "TPL011" in want:
        # The production inventory from the same scan scope; a narrowed run
        # (a fixture) that carries no *REGISTRY site judges against the real
        # package's inventory, like TPL008's index fallback.
        prod_sites = scan.metric_family_sites(file_list)
        if not prod_sites and not full_repo:
            prod_sites = scan.metric_family_sites()
        production = {v for v, _p, _l in prod_sites}
        seen_collide: Set[str] = set()
        for fam, rel, line in scan.local_registry_family_sites(file_list):
            if fam not in production or fam in seen_collide:
                continue
            seen_collide.add(fam)
            out.append(LintFinding(
                "TPL011", rel, line,
                f"local-registry family `{fam}` collides with a production family of the "
                f"same name: a series minted on a bench or simulator registry is "
                f"indistinguishable from the real one at scrape time and would poison its "
                f"dashboards; rename the local family (run-local series are "
                f"tpu_sim_run_*) or register it on the production registry and document it",
                key=f"collide:{fam}",
            ))

    if "TPL004" in want or "TPL005" in want:
        documented = scan.documented_backticked("observability.md", docs_dir=docs_dir)
        if "TPL004" in want:
            _doc_rule_sites(scan.flight_kind_sites(file_list), documented, "TPL004",
                            "observability.md", "flight-recorder kind", out, abs_by_rel)
        if "TPL005" in want:
            _doc_rule_sites(scan.ledger_kind_sites(file_list), documented, "TPL005",
                            "observability.md", "decision-ledger kind", out, abs_by_rel)

    if "TPL009" in want:
        documented = scan.documented_backticked("observability.md", docs_dir=docs_dir)
        _doc_rule_sites(scan.span_name_sites(file_list), documented, "TPL009",
                        "observability.md", "tracing span", out, abs_by_rel)

    if "TPL008" in want:
        # The DEBUG_ENDPOINTS index comes from the whole package when the
        # scan scope holds none (it lives in utils/metrics.py), so a narrowed
        # fixture scan still judges against the real index.
        key_sites = scan.debug_endpoint_keys(file_list) or scan.debug_endpoint_keys()
        keys = {k for k, _p, _l in key_sites}
        seen: Set[str] = set()
        for path_lit, rel, line in scan.debug_path_compare_sites(file_list):
            if path_lit in keys or path_lit in seen:
                continue
            seen.add(path_lit)
            ap = abs_by_rel.get(rel)
            if ap and _suppressed(ap, (line, line - 1), "TPL008"):
                continue
            out.append(LintFinding(
                "TPL008", rel, line,
                f"debug surface `{path_lit}` is dispatched on but absent from "
                f"metrics.DEBUG_ENDPOINTS: the /debug index won't list it and tpu-doctor "
                f"bundles won't collect it",
                key=path_lit,
            ))
        if full_repo:
            obs = scan.doc_text("observability.md", docs_dir)
            for k, rel, line in key_sites:
                if k not in obs:
                    out.append(LintFinding(
                        "TPL008", rel, line,
                        f"DEBUG_ENDPOINTS key `{k}` is not documented in "
                        f"docs/observability.md",
                        key=f"doc:{k}",
                    ))

    # Inline suppressions for the AST rules (the doc rules' are read above).
    filtered = [f for f in out
                if not ((ap := abs_by_rel.get(f.path))
                        and _suppressed(ap, (f.line, f.line - 1), f.rule))]
    filtered.sort(key=lambda f: (f.path, f.line, f.rule))
    return filtered
