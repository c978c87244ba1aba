"""Cross-plane consistency auditor: the node side of the JAX package's
``audit.py``, over the port's planes.

The node daemon keeps one fact, which card a pod holds, in several
independent places:

1. the kubelet's own record (the PodResources API and its checkpoint
   file),
2. the ``nvidia.com/gpu-devices`` pod annotations the controller writes,
3. the controller's card→pod attribution map (the telemetry join), and
4. the exported gauges (``tpu_plugin_chips``) dashboards and alerts trust.

Nothing else checks that they agree. This module does, on a cadence:

* a declarative invariant registry: each :class:`Invariant` names the
  planes it joins and returns structured :class:`Finding`s;
* an :class:`AuditEngine` running them on its own thread
  (``--audit-interval-s``; 0 means off and no thread), off the gRPC hot
  path;
* findings exported as ``tpu_audit_findings{invariant,severity}`` with
  ``tpu_audit_sweeps_total``, ``tpu_audit_sweep_seconds`` and
  ``tpu_audit_last_clean_sweep_timestamp``, and recorded in the flight
  recorder and decision ledger as ``audit_divergence`` on every detection
  and clear (never per sweep while a finding persists);
* the whole snapshot served at ``GET /debug/audit``.

Findings are observations, never repairs: every plane has an owner with a
reconcile loop, and an auditor that "fixed" state would be a second writer
racing them.

A new critical finding dumps the flight ring to the flight dir
(``audit_critical``), while the divergence's lead-up is still in it.

The invariants are the four shared ones (``thread_liveness``,
``lock_order``, ``loop_inventory``, ``degraded_consistency``), the five of
:class:`NodeAudit` and seven of :class:`ExtenderAudit`
(``reservation_vs_journal``, ``reservation_vs_cluster``, ``gate_vs_hold``,
``reservation_shard_ownership`` with sharding, ``defrag_vs_reservations``
and ``rescue_vs_health`` with those planes wired, and ``placeable_recount``
with the topology index): every JAX invariant. ``loop_inventory`` matches
the live heartbeats against the static loop inventory of the port's lint
(``analysis/registry_scan.heartbeat_names``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from .api import constants
from .kube import checkpoint as ckpt
from .topology.placement import placeable_sizes
from .utils import metrics, profiling
from .utils.decisions import LEDGER
from .utils.flightrecorder import RECORDER
from .utils.logging import get_logger
from .utils.podresources import gpu_request

log = get_logger(__name__)

# "warning": a plane is stale or diverged but the system is self-healing or
# degraded-safe; "critical": capacity is leaked or a plane is frozen.
WARNING = "warning"
CRITICAL = "critical"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One observed divergence between two (or more) state planes."""

    invariant: str
    severity: str
    message: str
    pod: str = ""
    gang: str = ""
    node: str = ""
    chip: str = ""
    # Flat, JSON-ready detail payload (chip lists, expected-vs-got).
    details: Tuple[Tuple[str, str], ...] = ()

    @staticmethod
    def make(invariant, severity, message, pod="", gang="", node="",
             chip="", **details) -> "Finding":
        return Finding(
            invariant=invariant, severity=severity, message=message,
            pod=pod, gang=gang, node=node, chip=chip,
            details=tuple(sorted((k, str(v)) for k, v in details.items())),
        )

    def key(self) -> tuple:
        """Identity for detected/cleared transitions: the subject and the
        severity, not the message (a drifting detail must not re-fire every
        sweep, but a warning→critical escalation is a new detection)."""
        return (self.invariant, self.severity, self.pod, self.gang, self.node, self.chip)

    def to_dict(self) -> dict:
        return {
            "invariant": self.invariant,
            "severity": self.severity,
            "message": self.message,
            "pod": self.pod,
            "gang": self.gang,
            "node": self.node,
            "chip": self.chip,
            "details": dict(self.details),
        }


@dataclasses.dataclass(frozen=True)
class Invariant:
    """One declarative cross-plane check: ``check()`` returns the current
    findings (empty: the planes agree). ``planes`` names the state surfaces
    it joins, for the /debug/audit registry table."""

    name: str
    planes: Tuple[str, ...]
    description: str
    check: Callable[[], List[Finding]]


class AuditEngine:
    """Runs an invariant set on a cadence and owns the reporting.

    One engine per process (installed with :func:`install_engine`). The node
    daemon runs it on its own thread (``start``/``stop``); the extender calls
    :meth:`maybe_sweep` from the gang-admission loop, so a sweep never races
    the journal's writer. ``sweep_once`` is the direct entry the tests
    drive. The families are the service's (``metrics.family``)."""

    def __init__(
        self,
        service: str,
        invariants: List[Invariant],
        interval_s: float = 60.0,
        prepare: Optional[Callable[[], None]] = None,
        config: Optional[dict] = None,
    ):
        self.service = service
        self.invariants = list(invariants)
        self.interval_s = interval_s
        # Optional per-sweep fact gatherer (one pod list shared by every
        # invariant of the sweep); a raising prepare fails the sweep as
        # outcome="error".
        self._prepare = prepare
        # Knob values surfaced at /debug/audit; never credentials.
        self.config = dict(config or {})
        self._findings_fam = metrics.family("AUDIT_FINDINGS", service)
        self._sweeps_fam = metrics.family("AUDIT_SWEEPS", service)
        self._seconds_fam = metrics.family("AUDIT_SWEEP_SECONDS", service)
        self._last_clean_fam = metrics.family("AUDIT_LAST_CLEAN", service)
        self._last_sweep_mono = float("-inf")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sweeps = 0
        self._last_ts = 0.0
        self._last_duration_ms = 0.0
        self._findings: List[Finding] = []
        self._errors: Dict[str, str] = {}
        # finding key → Finding from the previous sweep (transitions), and
        # the (invariant, severity) pairs the gauge carries (the prune list).
        self._prev: Dict[tuple, Finding] = {}
        self._gauge_pairs: Set[Tuple[str, str]] = set()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """An immediate first sweep, then one per interval. Supervised: the
        auditor watching every other plane must not die silently."""
        self._stop.clear()
        self._thread = threading.Thread(
            target=profiling.supervised("audit_sweep", self._run),
            name="tpu-audit",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 2)
            self._thread = None

    def _run(self) -> None:
        log.info("consistency auditor started: %d invariants, %.1fs interval",
                 len(self.invariants), self.interval_s)
        hb = profiling.HEARTBEATS.register("audit_sweep", interval_s=self.interval_s)
        while not self._stop.is_set():
            hb.beat()
            try:
                self.sweep_once()
            except Exception:  # noqa: BLE001 - the auditor must survive
                log.exception("audit sweep failed")
                self._sweeps_fam.inc(outcome="error")
            if self._stop.wait(self.interval_s):
                return

    def maybe_sweep(self) -> bool:
        """The cadence check for a caller that embeds the engine in its own
        loop (the gang-admission tick). True when a sweep ran. Never
        raises."""
        if self.interval_s <= 0:
            return False
        if time.monotonic() - self._last_sweep_mono < self.interval_s:
            return False
        try:
            self.sweep_once()
        except Exception:  # noqa: BLE001 - never break the host loop
            log.exception("audit sweep failed")
            self._sweeps_fam.inc(outcome="error")
        return True

    # -- one sweep ---------------------------------------------------------

    def sweep_once(self) -> List[Finding]:
        """Run every invariant once; returns the findings (also kept for
        /debug/audit). A raising invariant costs its own planes' coverage
        this pass (recorded in ``errors`` and the error outcome), never the
        sweep."""
        self._last_sweep_mono = time.monotonic()
        t0 = time.perf_counter()
        findings: List[Finding] = []
        errors: Dict[str, str] = {}
        if self._prepare is not None:
            try:
                self._prepare()
            except Exception as e:  # noqa: BLE001 - a degraded sweep
                log.warning("audit sweep prepare failed: %s", e)
                errors["_prepare"] = f"{type(e).__name__}: {e}"
        if "_prepare" not in errors:
            for inv in self.invariants:
                try:
                    findings.extend(inv.check())
                except Exception as e:  # noqa: BLE001 - isolate
                    log.exception("audit invariant %s raised", inv.name)
                    errors[inv.name] = f"{type(e).__name__}: {e}"
        self._publish(findings, errors, time.perf_counter() - t0)
        return findings

    def _publish(self, findings: List[Finding], errors: Dict[str, str],
                 duration_s: float) -> None:
        # Gauge: a count per (invariant, severity); emptied pairs drop
        # their series (absent means clean).
        counts: Dict[Tuple[str, str], int] = {}
        for f in findings:
            pair = (f.invariant, f.severity)
            counts[pair] = counts.get(pair, 0) + 1
        with self._lock:
            for inv, sev in self._gauge_pairs - set(counts):
                self._findings_fam.remove(invariant=inv, severity=sev)
            for (inv, sev), n in counts.items():
                self._findings_fam.set(n, invariant=inv, severity=sev)
            self._gauge_pairs = set(counts)
            prev = self._prev
            current = {f.key(): f for f in findings}
            self._prev = current
            self._sweeps += 1
            self._last_ts = time.time()
            self._last_duration_ms = round(duration_s * 1000.0, 3)
            self._findings = list(findings)
            self._errors = dict(errors)
        outcome = "error" if errors else ("findings" if findings else "clean")
        self._sweeps_fam.inc(outcome=outcome)
        self._seconds_fam.observe(duration_s)
        if outcome == "clean":
            self._last_clean_fam.set(round(time.time(), 3))
        # Detection/clear transitions → flight recorder and ledger, once per
        # transition (a persisting finding is silent until it clears).
        new_critical = False
        for key, f in current.items():
            if key in prev:
                continue
            if f.severity == CRITICAL:
                new_critical = True
            RECORDER.record(
                "audit_divergence", f.message, state="detected",
                invariant=f.invariant, severity=f.severity,
                pod=f.pod, gang=f.gang, node=f.node, chip=f.chip,
            )
            LEDGER.record(
                "audit_divergence", f.invariant, f.message,
                pod=f.pod, gang=f.gang, node=f.node,
                severity=f.severity, chip=f.chip, **dict(f.details),
            )
            log.warning("audit divergence (%s, %s): %s", f.invariant, f.severity, f.message)
        for key, f in prev.items():
            if key not in current:
                RECORDER.record(
                    "audit_divergence", f"cleared: {f.message}", state="cleared",
                    invariant=f.invariant, severity=f.severity,
                    pod=f.pod, gang=f.gang, node=f.node, chip=f.chip,
                )
        if new_critical:
            # A new critical finding is a post-mortem moment: capture the
            # event tail now, while the divergence's lead-up is in the ring.
            RECORDER.dump_on("audit_critical")

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "service": self.service,
                "interval_s": self.interval_s,
                "sweeps": self._sweeps,
                "last_sweep_ts": self._last_ts,
                "last_duration_ms": self._last_duration_ms,
                "findings": [f.to_dict() for f in self._findings],
                "errors": dict(self._errors),
                "invariants": [
                    {"name": inv.name, "planes": list(inv.planes),
                     "description": inv.description}
                    for inv in self.invariants
                ],
                "config": dict(self.config),
            }


# Process-global engine for /debug/audit (one daemon per process).
ENGINE: Optional[AuditEngine] = None


def install_engine(engine: Optional[AuditEngine]) -> None:
    global ENGINE
    ENGINE = engine


def debug_snapshot() -> dict:
    """The /debug/audit payload: engine state and build identity."""
    out: dict = {"enabled": ENGINE is not None, "build": metrics.build_info()}
    engine = ENGINE
    if engine is not None:
        out.update(engine.snapshot())
        out["build"]["component"] = engine.service
    return out


# ---------------------------------------------------------------------------
# Shared invariants
# ---------------------------------------------------------------------------


def check_thread_liveness() -> List[Finding]:
    """Every registered long-lived loop (``profiling.HEARTBEATS``) must beat
    within its own stall threshold or have been stopped cleanly (which
    unregisters it). A dead loop, one that exited on an unhandled exception,
    is CRITICAL: whatever it maintained is frozen until a restart. A silent
    loop is a WARNING. The loop's name rides the Finding's ``chip`` slot, so
    two dead loops are two findings."""
    out: List[Finding] = []
    for hb in profiling.HEARTBEATS.snapshot():
        if hb["dead"]:
            out.append(Finding.make(
                "thread_liveness", CRITICAL,
                f"background loop '{hb['name']}' died ({hb['dead_reason']}): "
                f"its plane is frozen until the loop restarts",
                chip=hb["name"], loop=hb["name"], reason=hb["dead_reason"],
                beats=hb["beats"],
            ))
        elif hb["age_s"] > hb["max_silence_s"]:
            out.append(Finding.make(
                "thread_liveness", WARNING,
                f"background loop '{hb['name']}' heartbeat silent for "
                f"{hb['age_s']:.1f}s (threshold {hb['max_silence_s']:.1f}s)",
                chip=hb["name"], loop=hb["name"], age_s=hb["age_s"],
                max_silence_s=hb["max_silence_s"],
            ))
    return out


def thread_liveness_invariant() -> Invariant:
    return Invariant(
        "thread_liveness",
        ("threads", "heartbeats"),
        "every registered long-lived loop must beat its heartbeat within "
        "its stall threshold; a dead loop (unhandled exception) is "
        "critical: its plane is silently frozen",
        check_thread_liveness,
    )


def check_lock_order() -> List[Finding]:
    """The runtime lockdep graph (``profiling.LockdepGraph``, fed by every
    ``TimedLock`` acquire when ``--lockdep`` is on) must hold no inversion
    cycle: two threads that ever take the same locks in opposite orders are
    one interleaving from a deadlock. CRITICAL, since the fix is a code
    change: the finding stands (witness stacks at /debug/lockdep) until a
    restart. The cycle's id rides the ``chip`` slot."""
    out: List[Finding] = []
    for cyc in profiling.LOCKDEP.cycles():
        out.append(Finding.make(
            "lock_order", CRITICAL,
            f"lock-order inversion {' -> '.join(cyc['nodes'])}: these locks have been "
            f"acquired in opposite orders by different threads; witness stacks at "
            f"/debug/lockdep",
            chip=cyc["id"], nodes=" -> ".join(cyc["nodes"]),
            witnesses=len(cyc["witnesses"]), first_seen_ts=cyc["ts"],
        ))
    return out


def lock_order_invariant() -> Invariant:
    return Invariant(
        "lock_order",
        ("threads", "locks"),
        "the runtime lock-order graph must be acyclic: an inversion cycle (same "
        "locks, opposite orders, different threads) is a deadlock one "
        "interleaving away; critical, with witness stacks at /debug/lockdep",
        check_lock_order,
    )


# The static loop inventory: one AST pass over the package, cached for the
# process (the scanner tpu-lint uses is the source of truth).
_STATIC_LOOPS: Optional[Tuple[Set[str], Set[str]]] = None


def static_loop_inventory() -> Tuple[Set[str], Set[str]]:
    """(exact names, prefixes), built on the first call (about a second of
    parsing) and kept. The extender calls it at start-up, before
    ``/readyz``, because its sweeps ride the gang-admission tick, which the
    parse would otherwise stall; the daemon's first sweep builds it on the
    auditor's own thread."""
    global _STATIC_LOOPS
    if _STATIC_LOOPS is None:
        from .analysis import registry_scan

        t0 = time.perf_counter()
        _STATIC_LOOPS = registry_scan.heartbeat_names()
        # Nothing in a daemon reads the trees again.
        registry_scan.clear_cache()
        log.info("static loop inventory: %d names, %d prefixes in %.0f ms",
                 len(_STATIC_LOOPS[0]), len(_STATIC_LOOPS[1]),
                 (time.perf_counter() - t0) * 1e3)
    return _STATIC_LOOPS


def check_loop_inventory() -> List[Finding]:
    """Every heartbeat registered at runtime must be statically discoverable
    (a literal or literal-prefixed loop name at a ``HEARTBEATS.register`` or
    ``supervised`` call site). tpu-lint's loop-without-heartbeat rule can
    only protect loops it can see, so a dynamically named loop the scanner
    cannot attribute is a WARNING: name it with a literal (or a literal
    prefix) so the linter, the watchdog gauge and the runbooks agree on what
    the loop is called. The loop's name rides the ``chip`` slot."""
    from .analysis import registry_scan

    exact, prefixes = static_loop_inventory()
    out: List[Finding] = []
    for hb in profiling.HEARTBEATS.snapshot():
        name = hb["name"]
        if not registry_scan.loop_name_known(name, exact, prefixes):
            out.append(Finding.make(
                "loop_inventory", WARNING,
                f"runtime heartbeat '{name}' is not in the static loop inventory (no "
                f"literal name at any HEARTBEATS.register/supervised call site): "
                f"tpu-lint cannot check a loop it cannot see",
                chip=name, loop=name,
            ))
    return out


def loop_inventory_invariant() -> Invariant:
    return Invariant(
        "loop_inventory",
        ("threads", "heartbeats", "static-analysis"),
        "every runtime-registered heartbeat must be statically discoverable by "
        "the tpu-lint loop scanner (a literal or literal-prefixed name): a loop "
        "the linter cannot see is a loop its supervision rules cannot protect",
        check_loop_inventory,
    )


def check_degraded_consistency() -> List[Finding]:
    """No kube mutation may land while the circuit breaker is open. The
    resilience layer fails every call fast while it is, and the TRACKER
    keeps the evidence either way: every successful mutation and every
    breaker window. A mutation inside an open window means some call path
    bypassed the wrapper: CRITICAL, standing until restart (the evidence
    never shrinks). The verb rides the ``chip`` slot."""
    from .utils.resilience import TRACKER

    out: List[Finding] = []
    by_verb: Dict[str, List[float]] = {}
    for ts, verb in TRACKER.mutations_while_open():
        by_verb.setdefault(verb, []).append(ts)
    for verb, stamps in sorted(by_verb.items()):
        out.append(Finding.make(
            "degraded_consistency", CRITICAL,
            f"{len(stamps)} successful '{verb}' mutation(s) landed while the "
            f"kube circuit breaker was OPEN: a write path bypassed the "
            f"resilience wrapper; evidence at /debug/resilience",
            chip=verb, verb=verb, count=len(stamps),
            first_ts=min(stamps), last_ts=max(stamps),
        ))
    return out


def degraded_consistency_invariant() -> Invariant:
    return Invariant(
        "degraded_consistency",
        ("kube", "resilience", "breaker"),
        "no kube mutation may succeed while the circuit breaker is open: "
        "breaker-open means the daemon's view of the cluster is stale, and "
        "a write against stale state is critical",
        check_degraded_consistency,
    )


def shared_invariants() -> List[Invariant]:
    """The process-health invariant set both daemons carry."""
    return [thread_liveness_invariant(), lock_order_invariant(),
            loop_inventory_invariant(), degraded_consistency_invariant()]


# ---------------------------------------------------------------------------
# Node invariants (plugin daemon)
# ---------------------------------------------------------------------------


class NodeAudit:
    """The plugin daemon's invariant set over one node's planes: the
    kubelet record (PodResources/checkpoint), pod annotations, the
    attribution map, the placement state and the exported gauges. Facts
    several invariants share (the kubelet's assignments, the API server's
    pod list) are gathered once per sweep in :meth:`prepare`."""

    def __init__(
        self,
        plugin,  # GpuDevicePlugin
        controller=None,  # Controller (None: no kube integration)
        client=None,  # KubeClient (None: no API server)
        node_name: str = "",
        checkpoint_path: str = constants.KUBELET_CHECKPOINT,
        podres=None,  # PodResourcesClient (None: checkpoint only)
        resource_name: str = constants.RESOURCE_NAME,
    ):
        self.plugin = plugin
        self.controller = controller
        self.client = client
        self.node_name = node_name
        self.checkpoint_path = checkpoint_path
        self.podres = podres
        self.resource_name = resource_name
        # Per-sweep facts (prepare()).
        self._podres_by_pod: Optional[Dict[Tuple[str, str], Set[str]]] = None
        self._ckpt_by_uid: Optional[Dict[str, Set[str]]] = None
        self._pods: Optional[List[dict]] = None
        self._pods_error: Optional[Exception] = None

    def engine(self, interval_s: float = 60.0) -> AuditEngine:
        return AuditEngine(
            service="plugin",
            invariants=self.invariants(),
            interval_s=interval_s,
            prepare=self.prepare,
            config={
                "audit_interval_s": interval_s,
                "node_name": self.node_name,
                "has_apiserver": self.client is not None,
                "has_controller": self.controller is not None,
                "resource_name": self.resource_name,
            },
        )

    def invariants(self) -> List[Invariant]:
        return [
            Invariant(
                "checkpoint_vs_podresources",
                ("checkpoint", "podresources"),
                "the kubelet's two records of the same assignments, the "
                "checkpoint file and the PodResources API, must name the "
                "same card set",
                self.check_checkpoint_vs_podresources,
            ),
            Invariant(
                "annotation_vs_kubelet",
                ("annotations", "podresources", "checkpoint"),
                f"a Running pod's {constants.POD_DEVICES_ANNOTATION} "
                "annotation must match the cards the kubelet assigned it",
                self.check_annotation_vs_kubelet,
            ),
            Invariant(
                "attribution_vs_kubelet",
                ("attribution", "podresources", "checkpoint"),
                "every card in the controller's telemetry-attribution map "
                "must be kubelet-assigned to the pod it names",
                self.check_attribution_vs_kubelet,
            ),
            Invariant(
                "gauge_vs_state",
                ("metrics", "placement"),
                "the tpu_plugin_chips gauges must equal the placement "
                "state (total/available always render; allocated/"
                "unhealthy drop when empty)",
                self.check_gauge_vs_state,
            ),
            Invariant(
                "orphaned_chip",
                ("podresources", "checkpoint", "apiserver"),
                "a card the kubelet holds for a pod the API server no "
                "longer knows is leaked capacity",
                self.check_orphaned_chips,
            ),
            *shared_invariants(),
        ]

    # -- shared facts ------------------------------------------------------

    def _real(self, kubelet_ids) -> Set[str]:
        """Kubelet device ids → real card ids, through the plugin's
        substitution record, as the controller's delete-time reconcile
        translates them."""
        out: Set[str] = set()
        for kid in kubelet_ids:
            rid = self.plugin.substitutions.get(kid, kid)
            if rid in self.plugin.topology.by_id:
                out.add(rid)
        return out

    def prepare(self) -> None:
        self._podres_by_pod = None
        self._ckpt_by_uid = None
        self._pods = None
        self._pods_error = None
        if self.podres is not None and self.podres.available():
            try:
                raw = self.podres.device_ids_by_pod(self.resource_name)
                self._podres_by_pod = {key: self._real(ids) for key, ids in raw.items()}
            except Exception as e:  # noqa: BLE001 - a wedged kubelet costs
                # this sweep's kubelet-joined invariants, audited again next
                log.warning("audit: podresources list failed: %s", e)
        entries = ckpt.read_checkpoint(self.checkpoint_path)
        if entries:
            self._ckpt_by_uid = {
                uid: self._real(ids)
                for uid, ids in ckpt.device_ids_by_pod(entries, self.resource_name).items()
            }
        if self.client is not None:
            try:
                self._pods = self.client.list_pods(node_name=self.node_name).get("items", [])
            except Exception as e:  # noqa: BLE001 - the API-server-joined
                # invariants raise below (an audit error, not silence)
                self._pods_error = e

    def _kubelet_truth(self) -> Optional[Dict[tuple, Set[str]]]:
        """Pod key → real card set, from the best kubelet source. Keys are
        ("name", ns, name) for PodResources entries, ("uid", uid) for a
        checkpoint-only kubelet. None: no source answered (those invariants
        skip rather than fire)."""
        if self._podres_by_pod is not None:
            return {("name",) + key: ids for key, ids in self._podres_by_pod.items()}
        if self._ckpt_by_uid is not None:
            return {("uid", uid): ids for uid, ids in self._ckpt_by_uid.items()}
        return None

    def _require_pods(self) -> List[dict]:
        """This sweep's pod list; a failed list raises (an audit error,
        not silence)."""
        if self._pods_error is not None:
            raise RuntimeError(f"apiserver pod list failed: {self._pods_error}")
        return self._pods or []

    # -- invariants --------------------------------------------------------

    def check_checkpoint_vs_podresources(self) -> List[Finding]:
        """Both kubelet sources present: their assigned card sets must agree
        (the checkpoint is the fallback source; if it drifts from the API,
        a daemon restart would rebuild allocation state from the wrong
        record)."""
        if self._podres_by_pod is None or self._ckpt_by_uid is None:
            return []
        pr = set().union(*self._podres_by_pod.values(), set())
        ck = set().union(*self._ckpt_by_uid.values(), set())
        out = []
        only_pr = sorted(pr - ck)
        only_ck = sorted(ck - pr)
        if only_pr:
            out.append(Finding.make(
                "checkpoint_vs_podresources", WARNING,
                f"chips {only_pr} assigned per PodResources but absent from "
                f"the kubelet checkpoint",
                node=self.node_name, only_in_podresources=",".join(only_pr),
            ))
        if only_ck:
            out.append(Finding.make(
                "checkpoint_vs_podresources", WARNING,
                f"chips {only_ck} in the kubelet checkpoint but absent from "
                f"PodResources",
                node=self.node_name, only_in_checkpoint=",".join(only_ck),
            ))
        return out

    def check_annotation_vs_kubelet(self) -> List[Finding]:
        truth = self._kubelet_truth()
        if truth is None or self.client is None:
            return []
        pods = self._require_pods()
        by_name = {k[1:]: ids for k, ids in truth.items() if k[0] == "name"}
        by_uid = {k[1]: ids for k, ids in truth.items() if k[0] == "uid"}
        out = []
        for pod in pods:
            meta = pod.get("metadata") or {}
            ann = (meta.get("annotations") or {}).get(constants.POD_DEVICES_ANNOTATION)
            if not ann:
                continue
            phase = (pod.get("status") or {}).get("phase")
            if phase not in ("Running", "Pending"):
                # A finished pod's annotation outlives its freed assignment.
                continue
            ns = meta.get("namespace", "default")
            name = meta.get("name", "")
            # The raw annotation set, unfiltered: an id the current node does
            # not know (a prior generation's leftover) is the drift this
            # invariant exists to catch.
            ann_ids = {i for i in ann.split(",") if i}
            kub = by_name.get((ns, name))
            if kub is None:
                kub = by_uid.get(meta.get("uid", ""))
            if kub is None:
                # No kubelet entry at all: for a Running pod with an
                # annotation, a stale annotation from a prior incarnation.
                if phase == "Running":
                    out.append(Finding.make(
                        "annotation_vs_kubelet", WARNING,
                        f"pod {ns}/{name} annotation names chips "
                        f"{sorted(ann_ids)} but the kubelet reports no "
                        f"assignment",
                        pod=f"{ns}/{name}", node=self.node_name,
                        annotation=",".join(sorted(ann_ids)),
                    ))
                continue
            if ann_ids != kub:
                out.append(Finding.make(
                    "annotation_vs_kubelet", WARNING,
                    f"pod {ns}/{name} annotation says {sorted(ann_ids)}, "
                    f"kubelet says {sorted(kub)}",
                    pod=f"{ns}/{name}", node=self.node_name,
                    annotation=",".join(sorted(ann_ids)), kubelet=",".join(sorted(kub)),
                ))
        return out

    def check_attribution_vs_kubelet(self) -> List[Finding]:
        if self.controller is None:
            return []
        truth = self._kubelet_truth()
        if truth is None:
            return []
        attribution = self.controller.chip_attribution()
        if not attribution:
            return []
        chip_holder: Dict[str, tuple] = {}
        assigned: Set[str] = set()
        for key, ids in truth.items():
            assigned |= ids
            for cid in ids:
                chip_holder[cid] = key
        out = []
        for cid, attr in sorted(attribution.items()):
            podkey = f"{attr.get('namespace', '')}/{attr.get('pod', '')}"
            if cid not in assigned:
                out.append(Finding.make(
                    "attribution_vs_kubelet", WARNING,
                    f"chip {cid} attributed to pod {podkey} but the kubelet "
                    f"reports it unassigned (telemetry would label a free "
                    f"card with a dead pod)",
                    pod=podkey, chip=cid, node=self.node_name,
                ))
                continue
            holder = chip_holder.get(cid)
            if holder and holder[0] == "name":
                want = (attr.get("namespace", ""), attr.get("pod", ""))
                if holder[1:] != want:
                    out.append(Finding.make(
                        "attribution_vs_kubelet", WARNING,
                        f"chip {cid} attributed to {podkey} but "
                        f"kubelet-assigned to {holder[1]}/{holder[2]}",
                        pod=podkey, chip=cid, node=self.node_name,
                        kubelet_pod=f"{holder[1]}/{holder[2]}",
                    ))
        return out

    def check_gauge_vs_state(self) -> List[Finding]:
        """The state and the exported gauge are read non-atomically (the
        gRPC Allocate path changes both between the two reads), so a diff is
        recomputed once before it becomes a finding: real drift is steady,
        a mid-sweep allocation is not."""
        out = self._gauge_diff()
        return self._gauge_diff() if out else out

    def _gauge_diff(self) -> List[Finding]:
        state = self.plugin.state
        truth = {
            "total": len(self.plugin.topology.chips),
            "available": len(state.available()),
            "allocated": len(state.allocated),
            "unhealthy": len(state.unhealthy),
        }
        exported = {labels.get("state", ""): value for labels, value in metrics.CHIPS.series()}
        out = []
        for st, want in truth.items():
            got = exported.get(st)
            if st in ("allocated", "unhealthy") and want == 0:
                # Emptied states must be absent, not 0: a frozen series is
                # exactly the drift this audits.
                if got is not None:
                    out.append(Finding.make(
                        "gauge_vs_state", WARNING,
                        f"tpu_plugin_chips{{state={st!r}}} still exports "
                        f"{got:g} but the placement state has none (stale "
                        f"series)",
                        node=self.node_name, state=st, exported=got,
                    ))
                continue
            if got is None or int(got) != want:
                out.append(Finding.make(
                    "gauge_vs_state", WARNING,
                    f"tpu_plugin_chips{{state={st!r}}} exports "
                    f"{'nothing' if got is None else '%g' % got} but the "
                    f"placement state says {want}",
                    node=self.node_name, state=st,
                    exported="absent" if got is None else got, expected=want,
                ))
        return out

    def check_orphaned_chips(self) -> List[Finding]:
        truth = self._kubelet_truth()
        if truth is None or self.client is None:
            return []
        pods = self._require_pods()
        live_names = set()
        live_uids = set()
        for pod in pods:
            meta = pod.get("metadata") or {}
            live_names.add((meta.get("namespace", "default"), meta.get("name", "")))
            live_uids.add(meta.get("uid", ""))
        out = []
        for key, ids in sorted(truth.items()):
            if not ids:
                continue
            if key[0] == "name":
                gone = key[1:] not in live_names
                podkey = f"{key[1]}/{key[2]}"
            else:
                gone = key[1] not in live_uids
                podkey = key[1]
            if gone:
                out.append(Finding.make(
                    "orphaned_chip", CRITICAL,
                    f"chips {sorted(ids)} held in the kubelet record by pod "
                    f"{podkey}, which the apiserver no longer knows: leaked "
                    f"capacity until pruned",
                    pod=podkey, node=self.node_name, chips=",".join(sorted(ids)),
                ))
        return out


# ---------------------------------------------------------------------------
# Extender invariants (the gang admitter and the scheduler extender)
# ---------------------------------------------------------------------------


class _SkipInvariant(Exception):
    """An invariant's preconditions are absent (no gang plane wired): it
    contributes nothing, silently."""


def _skippable(fn: Callable[[], List[Finding]]) -> Callable[[], List[Finding]]:
    def wrapped() -> List[Finding]:
        try:
            return fn()
        except _SkipInvariant:
            return []
    return wrapped


class ExtenderAudit:
    """The extender's invariant set: the reservation table against the
    admission journal and the cluster's truth, the gates against the holds,
    and the shared invariants (``lock_order`` over the index's and the
    table's ``TimedLock``s). Built with whatever halves the entry point
    wired: no journal, no replay check; no gang admission, no check against
    the cluster; nothing wired, no invariant at all (the JAX rule: an
    auditor of nothing would read clean). The engine is driven from the
    gang-admission loop, so the journal's read never races its one writer.
    With sharded admission (``shard_manager``) it also proves that every
    hold lies on its own shard's nodes; with the defrag and rescue engines
    on the admitter (and the journal), their two-phase contracts. The JAX
    plane registers ``defrag_vs_reservations`` with any journal; the port
    registers each plane's invariant only where its engine is wired. With
    the topology index it recounts the index's placeable aggregate, and
    finds nothing where the index keeps none (``track_placeable=False``,
    the scale bench's control arm), as JAX does."""

    # The from-scratch placeable recount is the one check that is not O(1):
    # each sweep re-derives a rotating sample of entries, so every entry is
    # re-proved within n / RECOUNT_SAMPLE sweeps.
    RECOUNT_SAMPLE = 32

    def __init__(
        self,
        reservations=None,  # extender.reservations.ReservationTable
        journal=None,  # extender.journal.AdmissionJournal
        gang=None,  # extender.gang.GangAdmission
        index=None,  # extender.index.TopologyIndex
        resource_name: str = constants.RESOURCE_NAME,
        shard_manager=None,  # extender.sharding.ShardManager
    ):
        self.reservations = reservations
        self.journal = journal
        self.gang = gang
        self.index = index
        self.resource_name = resource_name
        self.shard_manager = shard_manager
        self._recount_pos = 0
        # Per-sweep facts.
        self._gangs: Optional[dict] = None
        self._gangs_error: Optional[Exception] = None

    def engine(self, interval_s: float = 60.0) -> AuditEngine:
        return AuditEngine(
            service="extender",
            invariants=self.invariants(),
            interval_s=interval_s,
            prepare=self.prepare,
            config={
                "audit_interval_s": interval_s,
                "has_journal": self.journal is not None,
                "has_gang_admission": self.gang is not None,
                "has_topology_index": self.index is not None,
                "resource_name": self.resource_name,
            },
        )

    def invariants(self) -> List[Invariant]:
        out = []
        if self.journal is not None and self.reservations is not None:
            out.append(Invariant(
                "reservation_vs_journal",
                ("reservations", "journal"),
                "a from-scratch journal replay must rebuild exactly the live "
                "reservation table: a hold the journal would not rehydrate dies "
                "with the process",
                self.check_reservation_vs_journal,
            ))
        if self.gang is not None and self.reservations is not None:
            out.append(Invariant(
                "reservation_vs_cluster",
                ("reservations", "apiserver", "topology-index"),
                "every standing hold must belong to a live gang on known nodes: a "
                "hold for a vanished gang or node fences cards nothing will use",
                _skippable(self.check_reservation_vs_cluster),
            ))
            out.append(Invariant(
                "gate_vs_hold",
                ("gates", "reservations"),
                "gate state and hold state must agree: released-but-unscheduled "
                "GPU pods need a fence (or a lapse bar); a fully gated gang with a "
                "standing hold is a release that failed wholesale",
                _skippable(self.check_gate_vs_hold),
            ))
        if (self.journal is not None and self.reservations is not None
                and getattr(self.gang, "defrag", None) is not None):
            out.append(Invariant(
                "defrag_vs_reservations",
                ("journal", "reservations"),
                "an open defrag_evicted journal phase must have either a standing fence "
                "for the stranded gang or a journaled abort: the victims are already "
                "evicted, so a fenceless round hands the freed cards to a scavenger and "
                "leaves the stranded gang ungated and unfenced",
                self.check_defrag_vs_reservations,
            ))
        if getattr(self.gang, "rescue", None) is not None:
            out.append(Invariant(
                "rescue_vs_health",
                ("rescue", "journal", "reservations"),
                "a RUNNING gang known to sit on failed or withdrawn capacity past the "
                "rescue grace window must be accounted for (an open rescue round, a "
                "RESCUE_PENDING parking, or a just-completed rescue), and an open "
                "rescue_evicted journal phase must have a standing fence: its pods are "
                "already evicted, so a fenceless round is a gang gone and unprotected",
                self.check_rescue_vs_health,
            ))
        if self.shard_manager is not None:
            out.append(Invariant(
                "reservation_shard_ownership",
                ("reservations", "shard-ring", "topology-index"),
                "every hold must fence cards of nodes its own shard owns (the "
                "consistent hash of the node's hostname), and no node may carry "
                "holds of two shards: the structural guarantee against cross-shard "
                "double-booking",
                self.check_shard_ownership,
            ))
        if self.index is not None:
            out.append(Invariant(
                "placeable_recount",
                ("metrics", "topology-index"),
                "the incrementally kept placeable-nodes aggregate (and its gauge) must "
                "equal a from-scratch recount over the index's entries (each entry's "
                "sizes re-derived on a rotating sample, the aggregate every sweep)",
                self.check_placeable_recount,
            ))
        if out:
            out.extend(shared_invariants())
        return out

    # -- shared facts ------------------------------------------------------

    def prepare(self) -> None:
        self._gangs = None
        self._gangs_error = None
        if self.gang is None:
            return
        try:
            # The admitter's own discovery (one filtered pod list), so the
            # auditor cannot disagree with it about membership.
            self._gangs = self.gang._collect_gangs()
        except Exception as e:  # noqa: BLE001 - surfaces per invariant
            self._gangs_error = e

    def _require_gangs(self) -> dict:
        if self._gangs_error is not None:
            raise RuntimeError(f"gang pod list failed: {self._gangs_error}")
        if self._gangs is None:
            raise _SkipInvariant()
        return self._gangs

    # -- invariants --------------------------------------------------------

    def check_reservation_vs_journal(self) -> List[Finding]:
        """The live table against a read-only replay. A mutation can race
        the comparison (a /filter-thread prune journals under the table's
        lock, its write lands after the read), so a difference is checked
        once more after a fresh flush before it becomes a finding."""
        def diff() -> List[Finding]:
            self.journal.flush()
            replayed = self.journal.replay_readonly().holds
            live = self.reservations.export_state()
            out = []
            for key in sorted(set(live) - set(replayed)):
                out.append(Finding.make(
                    "reservation_vs_journal", CRITICAL,
                    f"gang {key[0]}/{key[1]} holds a live reservation the journal would "
                    f"NOT rehydrate: a restart unfences its cards",
                    gang=f"{key[0]}/{key[1]}", hosts=dict(live[key]["hosts"]),
                ))
            for key in sorted(set(replayed) - set(live)):
                out.append(Finding.make(
                    "reservation_vs_journal", WARNING,
                    f"journal replay resurrects a hold for gang {key[0]}/{key[1]} the live "
                    f"table no longer has (conservative over-fencing after a restart)",
                    gang=f"{key[0]}/{key[1]}", hosts=dict(replayed[key].hosts),
                ))
            for key in sorted(set(live) & set(replayed)):
                lh = {h: int(n) for h, n in live[key]["hosts"].items() if n > 0}
                rh = {h: int(n) for h, n in replayed[key].hosts.items() if n > 0}
                if lh != rh:
                    out.append(Finding.make(
                        "reservation_vs_journal", WARNING,
                        f"gang {key[0]}/{key[1]} hold differs between table ({lh}) and "
                        f"journal replay ({rh})",
                        gang=f"{key[0]}/{key[1]}", table=lh, journal=rh,
                    ))
            return out

        out = diff()
        return diff() if out else out

    def check_defrag_vs_reservations(self) -> List[Finding]:
        """The defrag plane's two-phase contract (extender/defrag.py), proven
        again from the journal each sweep: once a round reaches
        ``defrag_evicted`` its victims are gone, so the only safe states are
        "the freed cards fenced under the stranded gang's key" and "round
        closed" (``defrag_done``/``defrag_abort`` take it out of the
        replay). An open evicted phase with no standing fence is CRITICAL; a
        fence that no longer covers the journaled plan is a WARNING (drifted,
        not unprotected). An open intent is safe (nothing irreversible
        happened; recovery aborts it). A difference must survive a second
        read after a fresh flush, as for reservation_vs_journal."""
        def diff() -> List[Finding]:
            self.journal.flush()
            defragging = self.journal.replay_readonly().defragging
            if not defragging:
                return []
            live = self.reservations.export_state()
            out = []
            for key, rec in sorted(defragging.items()):
                if rec.get("phase") != "evicted":
                    continue
                planned = {str(h): int(n) for h, n in (rec.get("consumed") or {}).items()
                           if int(n) > 0}
                hold = live.get(key)
                if hold is None:
                    out.append(Finding.make(
                        "defrag_vs_reservations", CRITICAL,
                        f"gang {key[0]}/{key[1]} has an open defrag_evicted phase (victims "
                        f"already migrated off {sorted(planned)}) but NO standing fence and "
                        f"no journaled abort: the freed cards are up for grabs and the "
                        f"stranded gang is unprotected",
                        gang=f"{key[0]}/{key[1]}", planned=planned,
                    ))
                    continue
                held = {h: int(n) for h, n in hold["hosts"].items() if n > 0}
                if any(held.get(h, 0) < n for h, n in planned.items()):
                    out.append(Finding.make(
                        "defrag_vs_reservations", WARNING,
                        f"gang {key[0]}/{key[1]}'s standing fence ({held}) no longer covers "
                        f"its open defrag_evicted plan ({planned}): the fence drifted while "
                        f"the round stayed open",
                        gang=f"{key[0]}/{key[1]}", planned=planned, held=held,
                    ))
            return out

        out = diff()
        return diff() if out else out

    def check_rescue_vs_health(self) -> List[Finding]:
        """The rescue plane's two contracts (extender/rescue.py), proven
        again each sweep. Liveness: a gang the engine itself sees degraded
        strictly past the grace window must be in an open round, parked
        RESCUE_PENDING or just rescued; one the plane lost track of is a job
        burning on dead hardware, CRITICAL. Crash consistency, the defrag
        twin: an open ``rescue_evicted`` phase means the gang's pods are
        gone, so a round with no standing fence is CRITICAL. A finding must
        survive a second read, as for the siblings."""
        engine = self.gang.rescue

        def diff() -> List[Finding]:
            out = []
            grace = int(getattr(engine, "grace_ticks", 1))
            for key, st in sorted(engine.degraded_state().items()):
                if int(st.get("ticks", 0)) <= grace or engine.tracked(key):
                    continue
                out.append(Finding.make(
                    "rescue_vs_health", CRITICAL,
                    f"gang {key[0]}/{key[1]} has been degraded on "
                    f"{sorted(st.get('hosts') or {})} for {st.get('ticks')} tick(s) (grace "
                    f"{grace}) with no open rescue round, no RESCUE_PENDING parking, and no "
                    f"completed rescue: the job is burning on failed hardware and nothing is "
                    f"moving it",
                    gang=f"{key[0]}/{key[1]}", hosts=dict(st.get("hosts") or {}),
                    ticks=int(st.get("ticks", 0)),
                ))
            if self.journal is not None and self.reservations is not None:
                self.journal.flush()
                rescuing = self.journal.replay_readonly().rescuing
                live = self.reservations.export_state() if rescuing else {}
                for key, rec in sorted(rescuing.items()):
                    if rec.get("phase") != "evicted" or key in live:
                        continue
                    planned = {str(h): int(n) for h, n in (rec.get("consumed") or {}).items()
                               if int(n) > 0}
                    out.append(Finding.make(
                        "rescue_vs_health", CRITICAL,
                        f"gang {key[0]}/{key[1]} has an open rescue_evicted phase (its pods "
                        f"were already evacuated) but NO standing fence on the planned "
                        f"target {sorted(planned)} and no journaled abort: the target is up "
                        f"for grabs and the rescued gang is unprotected",
                        gang=f"{key[0]}/{key[1]}", planned=planned,
                    ))
            return out

        out = diff()
        return diff() if out else out

    def check_shard_ownership(self) -> List[Finding]:
        """Sharded admission's guarantee, proven again from scratch each
        sweep: each held host of every owned shard's table, hashed through
        the ring, must belong to that shard, and no host may carry holds of
        two shards. A GPU node forms no multi-host slice, so its capacity
        key is its hostname (the index's ``slice_key`` is always None). A
        host the index does not know (no index wired, or its entry gone
        while the hold stands) skips the ownership half, as in JAX; the
        two-shards check needs no hash and always runs."""
        ring = self.shard_manager.ring
        known: Optional[Set[str]] = None
        if self.index is not None:
            known = {e.hostname for e in self.index.entries() if e.hostname}
        out: List[Finding] = []
        holder_of: Dict[str, int] = {}
        conflicted: Set[str] = set()
        for shard_id, table in self.shard_manager.shard_tables():
            for key, res in sorted(table.active().items()):
                for host, n in sorted(res.hosts.items()):
                    owner = ring.shard_of(host) if known is not None and host in known else shard_id
                    if owner != shard_id:
                        out.append(Finding.make(
                            "reservation_shard_ownership", CRITICAL,
                            f"shard {shard_id} holds {n} card(s) on {host} for gang "
                            f"{key[0]}/{key[1]}, but shard {owner} owns that node: its true "
                            f"owner can book those cards again",
                            gang=f"{key[0]}/{key[1]}", node=host, shard=shard_id,
                            owner_shard=owner, chips=n,
                        ))
                    prev = holder_of.get(host)
                    if prev is not None and prev != shard_id:
                        # One finding per host a sweep: ten holds behind one
                        # conflicted host are one hazard.
                        if host not in conflicted:
                            conflicted.add(host)
                            out.append(Finding.make(
                                "reservation_shard_ownership", CRITICAL,
                                f"host {host} carries holds from two shards ({prev} and "
                                f"{shard_id}): cross-shard double-booking in progress",
                                node=host, shards=f"{prev},{shard_id}",
                            ))
                    else:
                        holder_of[host] = shard_id
        return out

    def check_reservation_vs_cluster(self) -> List[Finding]:
        active = self.reservations.active()
        if not active:
            return []
        gangs = self._require_gangs()
        known_hosts: Optional[Set[str]] = None
        if self.index is not None and len(self.index):
            known_hosts = {e.hostname for e in self.index.entries() if e.hostname}
        rescue = getattr(self.gang, "rescue", None)
        out = []
        for key, res in sorted(active.items()):
            if key not in gangs:
                if rescue is not None and rescue.shield(key):
                    # A rescued gang's pods were evicted and its replacements
                    # are coming: the upkeep keeps this hold for them too.
                    continue
                out.append(Finding.make(
                    "reservation_vs_cluster", WARNING,
                    f"reservation held for gang {key[0]}/{key[1]} whose pods no longer "
                    f"exist (leaked hold; upkeep should have dropped it)",
                    gang=f"{key[0]}/{key[1]}", hosts=dict(res.hosts),
                ))
                continue
            if known_hosts is None:
                continue
            for host in sorted(res.hosts):
                if host not in known_hosts:
                    out.append(Finding.make(
                        "reservation_vs_cluster", WARNING,
                        f"gang {key[0]}/{key[1]} reserves {res.hosts[host]} card(s) on "
                        f"{host}, which no indexed node publishes (vanished node)",
                        gang=f"{key[0]}/{key[1]}", node=host, chips=res.hosts[host],
                    ))
        return out

    def check_gate_vs_hold(self) -> List[Finding]:
        gangs = self._require_gangs()
        active = self.reservations.active()
        # The admitter's lapse bars plus the table's undrained lapses: a
        # hold can age out inside this very active() call and reach the
        # bars only at the next tick's drain; peek_lapsed() does not steal
        # the admitter's signal.
        lapsed = set(getattr(self.gang, "_lapsed_gangs", set())) | self.reservations.peek_lapsed()
        rescue = getattr(self.gang, "rescue", None)
        out = []
        for key, gv in sorted(gangs.items()):
            gated = gv.gated
            released_unscheduled = [
                p for p in gv.ungated_live
                if not (p.get("spec") or {}).get("nodeName")
                and gpu_request(p, self.resource_name) > 0
            ]
            if released_unscheduled and not gated and key not in active and key not in lapsed:
                names = sorted((p.get("metadata") or {}).get("name", "")
                               for p in released_unscheduled)
                out.append(Finding.make(
                    "gate_vs_hold", CRITICAL,
                    f"gang {key[0]}/{key[1]}: {len(names)} released-but-unscheduled GPU "
                    f"pod(s) with no reservation and no lapse bar: the release->steal "
                    f"window is open",
                    gang=f"{key[0]}/{key[1]}", pods=",".join(names),
                ))
            if gated and not gv.ungated_live and key in active and not (
                    rescue is not None and rescue.shield(key)):
                # A rescued gang's gated replacements release against the
                # standing fence at the next tick: that is the plan, not a
                # failed release.
                out.append(Finding.make(
                    "gate_vs_hold", WARNING,
                    f"gang {key[0]}/{key[1]} holds a reservation but every member is still "
                    f"gated: a release pass failed wholesale (release_retry finishes it "
                    f"next tick; persisting = gate patches failing)",
                    gang=f"{key[0]}/{key[1]}", gated=len(gated),
                ))
        return out

    def check_placeable_recount(self) -> List[Finding]:
        if not self.index.track_placeable:
            return []  # an index that keeps no aggregate has none to recount
        # The aggregate comparison reads the entries, the counts and the
        # gauge at three instants while the watch or relist thread can
        # rebuild entries in between: a diff is recomputed once before it
        # becomes a finding. A real index bug is steady; a mid-sweep rebuild
        # is not.
        out = self._placeable_aggregate_diff()
        if out:
            out = self._placeable_aggregate_diff()
        entries = self.index.entries()
        sample = entries[self._recount_pos:self._recount_pos + self.RECOUNT_SAMPLE]
        if len(sample) < self.RECOUNT_SAMPLE:
            sample += entries[:self.RECOUNT_SAMPLE - len(sample)]
        self._recount_pos = (self._recount_pos + self.RECOUNT_SAMPLE) % max(1, len(entries))
        seen = set()
        for e in sample:
            if e.name in seen or e.topo is None:
                continue
            seen.add(e.name)
            # The one derivation the index itself uses (its _placeable_for):
            # the recount proves the cached tuple, not a re-spelled formula.
            fresh = placeable_sizes(e.topo.to_topology(), e.topo.available)
            if fresh != e.placeable:
                out.append(Finding.make(
                    "placeable_recount", WARNING,
                    f"node {e.name}: index entry says placeable sizes {list(e.placeable)}, "
                    f"from-scratch recompute says {list(fresh)}",
                    node=e.name, entry=list(e.placeable), recompute=list(fresh),
                ))
        return out

    def _placeable_aggregate_diff(self) -> List[Finding]:
        """One pass of the aggregate comparison: the cached per-entry tuples
        against the incremental counts against the exported gauge."""
        out: List[Finding] = []
        want: Dict[int, int] = {}
        for e in self.index.entries():
            for n in e.placeable:
                want[n] = want.get(n, 0) + 1
        counts = {int(k): v
                  for k, v in self.index.placeable_snapshot()["placeable_nodes"].items()}
        if counts != want:
            out.append(Finding.make(
                "placeable_recount", WARNING,
                f"incremental placeable-nodes counts {counts} disagree with the per-entry "
                f"recount {want}",
                incremental=counts, recount=want,
            ))
        gauge = {int(labels["size"]): int(value)
                 for labels, value in metrics.EXT_PLACEABLE_NODES.series()
                 if labels.get("size", "").isdigit()}
        if gauge != want:
            out.append(Finding.make(
                "placeable_recount", WARNING,
                f"tpu_extender_placeable_nodes exports {gauge} but the per-entry recount "
                f"says {want}",
                gauge=gauge, recount=want,
            ))
        return out
