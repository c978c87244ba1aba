"""The write-ahead journal of gang admission: the JAX package's
``extender/journal.py``, what the extender must not forget when it dies.

Gang admission keeps its in-flight placement in process memory: the
reservation table's holds (``reservations.py``), the lapse bars (a hold that
hit its age cap is never re-fenced) and each gang's wait clocks. A SIGKILL
between a reserve and the last gate patch would lose all three: the restarted
extender could double-book the cards a half-released gang counts on, or
bring a lapsed hold back with a fresh age and void the cap. This module
journals every transition to a crash-safe store (``utils/statestore.py``:
checksummed append-only records, atomic snapshot compaction, torn-tail
tolerance) and rebuilds the state on start:

* the records: ``reserve``, ``shrink``, ``renew``, ``drop`` and ``lapse``
  mirror the table's mutations one for one (its ``observer`` hook emits
  them, so a lapse inside a /filter-thread prune is captured too);
  ``admit`` marks the all-or-nothing release, written before the first
  gate patch; ``wait`` and ``wait_clear`` carry a gang's capacity-wait
  episode, so the SLO origin and the pending-Event clock survive a restart.
  The ``preempt_*``, ``defrag_*`` and ``rescue_*`` ops of the later planes
  are kept as vocabulary: a journal written by either plane replays in the
  other to the same :class:`RehydratedState`;
* the replay (:meth:`AdmissionJournal.replay`) folds snapshot and journal
  into a :class:`RehydratedState`; ``renew`` replays as a no-op (expiry is
  process-local: a rehydrated hold gets a fresh TTL but keeps its original
  age, so the cap still counts from the reserve before the crash);
* recovery is ``GangAdmission.recover`` (``gang.py``), behind the /readyz
  ``replaying`` phase.

Durability: ``reserve``, ``admit`` and ``lapse`` (and the later planes'
round records) reach the OS before :meth:`record` returns, so they survive
the process's death; the rest wait for the end-of-tick flush, and losing
them is conservative. fsync on every record (machine-crash durability) is
the opt-in ``--journal-fsync``.

``python -m k8s_device_plugin_tpu_torch.extender.journal --self-test``
drives a journal through a reserve, a crash, a torn tail and compactions in
a temporary dir and prints a one-line verdict.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..utils import metrics, statestore
from ..utils.logging import get_logger

log = get_logger(__name__)

GangKey = Tuple[str, str]

# Ops whose loss could double-book cards or void the age cap: pushed to the
# OS before record() returns. The two-phase rounds of the preemption,
# defrag and rescue planes are all critical: losing one could re-evict
# evicted victims or leave freed cards unfenced through recovery.
CRITICAL_OPS = frozenset({
    "reserve", "admit", "lapse",
    "preempt_intent", "preempt_evicted", "preempt_done", "preempt_abort",
    "defrag_intent", "defrag_evicted", "defrag_done", "defrag_abort",
    "rescue_intent", "rescue_evicted", "rescue_done", "rescue_abort",
})

# One snapshot compaction per this many journal records keeps the replay
# bounded and the file small through renew-heavy steady states.
DEFAULT_COMPACT_EVERY = 4096

# The two-phase round ops: intent and evicted open (or advance) a round,
# done and abort close it. Each plane's rounds fold into their own map.
_ROUND_OPS = {"preempt": "preempting", "defrag": "defragging", "rescue": "rescuing"}


@dataclasses.dataclass
class Hold:
    hosts: Dict[str, int]
    demands: Tuple[int, ...]
    counted_pods: Set[str]
    created_ts: float  # wall clock of the original reserve
    priority: int = 0  # the gang's priority at reserve time

    def age_s(self, now: Optional[float] = None) -> float:
        return max(0.0, (now or time.time()) - self.created_ts)


@dataclasses.dataclass
class RehydratedState:
    holds: Dict[GangKey, Hold]
    lapsed: Set[GangKey]
    waiting_since: Dict[GangKey, float]  # wall-clock starts of wait episodes
    status: str  # the statestore's load status
    records: int  # journal records applied past the snapshot
    dropped: int  # torn or corrupt journal lines discarded
    # Open two-phase rounds of the preemption, defrag and rescue planes,
    # keyed by the gang they are for: {"phase": intent|evicted, "victims",
    # "consumed": {host: cards}, "demands", "priority", "ts"}, written by
    # preemption.py, defrag.py and rescue.py.
    preempting: Dict[GangKey, dict] = dataclasses.field(default_factory=dict)
    defragging: Dict[GangKey, dict] = dataclasses.field(default_factory=dict)
    rescuing: Dict[GangKey, dict] = dataclasses.field(default_factory=dict)
    # Wall clocks of executed defrag victim evictions (the rolling-hour
    # budget window).
    defrag_spend: List[float] = dataclasses.field(default_factory=list)


class AdmissionJournal:
    """Gang admission's write-ahead journal and its replay."""

    def __init__(
        self,
        dir_path: str,
        fsync_always: bool = False,
        compact_every: int = DEFAULT_COMPACT_EVERY,
        clock: Callable[[], float] = time.time,
    ):
        self.store = statestore.StateStore(dir_path, name="admission",
                                           fsync_always=fsync_always)
        self.compact_every = compact_every
        self._clock = clock

    # -- write -------------------------------------------------------------

    def record(self, op: str, gang: GangKey, **data) -> None:
        """Append one transition. Never raises: a full or broken disk
        degrades journaling (logged and counted), never admission, whose
        in-memory state is still right; the next restart then rebuilds
        from the cluster's truth, as an unjournaled extender does."""
        rec = {"op": op, "ts": round(self._clock(), 3), "g": [gang[0], gang[1]], **data}
        try:
            self.store.append(rec, flush=op in CRITICAL_OPS)
        except OSError as e:
            metrics.STATE_JOURNAL_RECORDS.inc(op="error")
            log.warning("journal append (%s) failed: %s", op, e)
            return
        # The bytes gauge is refreshed at flush and compaction: a stat()
        # per record would cost more than the append.
        metrics.STATE_JOURNAL_RECORDS.inc(op=op)

    def observe(self, op: str, gang: GangKey, payload: dict) -> None:
        """The reservation table's ``observer``: every mutation, lapses in
        routine prunes included."""
        self.record(op, gang, **payload)

    def flush(self) -> None:
        """Push the buffered records to the OS (the end of each admission
        tick): at most one tick's renewals and shrinks are ever at risk."""
        self.store.flush()
        metrics.STATE_JOURNAL_BYTES.set(self.store.size_bytes())

    def maybe_compact(self, state_data_fn: Callable[[], dict]) -> bool:
        """Fold the journal into a snapshot once enough records piled up.
        ``state_data_fn`` builds the owner's whole current state, called only
        when a compaction runs. Never raises."""
        if self.store.records_since_compact < self.compact_every:
            return False
        return self.compact(state_data_fn)

    def compact(self, state_data) -> bool:
        """``state_data``: the state document, or a zero-argument callable
        building it (when other threads can mutate the table, the /filter
        prune). With the callable the covered seq is captured before the
        build, so a record racing the capture survives in the fresh journal.
        Never raises."""
        try:
            if callable(state_data):
                seq = self.store.current_seq()
                self.store.compact(state_data(), seq=seq)
            else:
                self.store.compact(state_data)
        except OSError as e:
            metrics.STATE_COMPACTIONS.inc(outcome="error")
            log.warning("journal compaction failed: %s", e)
            return False
        metrics.STATE_COMPACTIONS.inc(outcome="ok")
        metrics.STATE_JOURNAL_BYTES.set(self.store.size_bytes())
        return True

    def close(self) -> None:
        self.store.close()

    # -- replay ------------------------------------------------------------

    def replay(self) -> RehydratedState:
        """Rebuild the admission state from the snapshot and the journal, as
        the owner. Tolerates any damage: a torn tail keeps the durable
        prefix, a corrupt record stops the replay there."""
        t0 = time.perf_counter()
        loaded = self.store.load()
        state = self._fold(loaded)
        metrics.STATE_REPLAY_SECONDS.set(round(time.perf_counter() - t0, 6))
        metrics.STATE_REHYDRATIONS.inc(outcome=loaded.status)
        return state

    def replay_readonly(self) -> RehydratedState:
        """Replay the files without the owner's side effects (no tail
        healing, no seq, no rehydration metrics): the consistency auditor's
        proof that the live table and a replay agree. flush() first, or the
        file lags the table by the tick's buffered records."""
        return self._fold(statestore.read_state(self.store.journal_path,
                                                self.store.snapshot_path))

    @staticmethod
    def _round_from(p: dict) -> dict:
        """One open two-phase round, from its snapshot or journal form."""
        return {
            "phase": p.get("phase", "intent"),
            "victims": p.get("victims") or [],
            "consumed": p.get("consumed") or {},
            "demands": p.get("demands") or [],
            "priority": int(p.get("priority", 0)),
            "ts": float(p.get("ts", 0.0)),
        }

    @staticmethod
    def _hold_from(h: dict, created_ts: float) -> Hold:
        return Hold(
            hosts={str(k): int(v) for k, v in (h.get("hosts") or {}).items()},
            demands=tuple(h.get("demands") or ()),
            counted_pods=set(h.get("counted") or ()),
            created_ts=created_ts,
            priority=int(h.get("priority", 0)),
        )

    def _fold(self, loaded) -> RehydratedState:
        holds: Dict[GangKey, Hold] = {}
        lapsed: Set[GangKey] = set()
        waiting: Dict[GangKey, float] = {}
        rounds: Dict[str, Dict[GangKey, dict]] = {m: {} for m in _ROUND_OPS.values()}
        defrag_spend: List[float] = []
        snap = loaded.snapshot
        if snap:
            for h in snap.get("holds", []):
                holds[(h.get("ns", ""), h.get("gang", ""))] = self._hold_from(
                    h, float(h.get("created", 0.0)))
            lapsed = {tuple(k) for k in snap.get("lapsed", [])}
            waiting = {(w[0], w[1]): float(w[2]) for w in snap.get("waiting", [])}
            for field, out in rounds.items():
                for p in snap.get(field, []):
                    out[(p.get("ns", ""), p.get("gang", ""))] = self._round_from(p)
            defrag_spend.extend(float(t) for t in snap.get("defrag_spend", []))
        for rec in loaded.records:
            self._apply(rec, holds, lapsed, waiting, rounds, defrag_spend)
        return RehydratedState(
            holds=holds, lapsed=lapsed, waiting_since=waiting, status=loaded.status,
            records=len(loaded.records), dropped=loaded.dropped,
            preempting=rounds["preempting"], defragging=rounds["defragging"],
            rescuing=rounds["rescuing"], defrag_spend=defrag_spend,
        )

    @classmethod
    def _apply(cls, rec: dict, holds: Dict[GangKey, Hold], lapsed: Set[GangKey],
               waiting: Dict[GangKey, float], rounds: Dict[str, Dict[GangKey, dict]],
               defrag_spend: List[float]) -> None:
        g = rec.get("g") or ["", ""]
        key: GangKey = (str(g[0]), str(g[1]))
        op = rec.get("op", "")
        if op == "reserve":
            # A fresh reserve is a fresh all-or-nothing decision: it clears a
            # predecessor's lapse bar (as tick() does). A restart's re-fence
            # journals its kept age in ``age_s``.
            holds[key] = cls._hold_from(
                rec, float(rec.get("ts", 0.0)) - float(rec.get("age_s", 0.0)))
            lapsed.discard(key)
        elif op == "shrink":
            h = holds.get(key)
            pod = rec.get("pod", "")
            if h is None or pod in h.counted_pods:
                return
            h.counted_pods.add(pod)
            host = rec.get("host", "")
            if host in h.hosts:
                h.hosts[host] = max(0, h.hosts[host] - int(rec.get("chips", 0)))
                if h.hosts[host] == 0:
                    del h.hosts[host]
            if not h.hosts:
                # Fully consumed: the live table prunes such a hold as a
                # plain drop, and the replay must not bring it back.
                holds.pop(key, None)
        elif op == "drop":
            holds.pop(key, None)
        elif op == "lapse":
            holds.pop(key, None)
            lapsed.add(key)
        elif op == "wait":
            waiting[key] = float(rec.get("since", rec.get("ts", 0.0)))
        elif op == "wait_clear":
            waiting.pop(key, None)
        elif op == "defrag_spend":
            defrag_spend.extend(float(t) for t in rec.get("stamps") or [])
        else:
            plane, _, phase = op.partition("_")
            out = rounds.get(_ROUND_OPS.get(plane, ""))
            if out is None:
                # "renew" (expiry is process-local) and "admit" (the reserve
                # before it carries the state) replay as no-ops.
                return
            if phase in ("intent", "evicted"):
                # Both phases carry the whole plan, so a compaction between
                # the two records leaves the evicted phase self-sufficient.
                out[key] = cls._round_from(dict(rec, phase=phase))
            elif phase in ("done", "abort"):
                out.pop(key, None)

    # -- the snapshot document ---------------------------------------------

    @staticmethod
    def _rounds_to_snap(rounds: Optional[Dict[GangKey, dict]]) -> list:
        return [
            {
                "ns": k[0],
                "gang": k[1],
                "phase": p.get("phase", "intent"),
                "victims": list(p.get("victims") or []),
                "consumed": dict(p.get("consumed") or {}),
                "demands": list(p.get("demands") or []),
                "priority": int(p.get("priority", 0)),
                "ts": round(float(p.get("ts", 0.0)), 3),
            }
            for k, p in sorted((rounds or {}).items())
        ]

    @staticmethod
    def state_data(
        holds: Dict[GangKey, Hold],
        lapsed: Set[GangKey],
        waiting_since: Dict[GangKey, float],
        preempting: Optional[Dict[GangKey, dict]] = None,
        defragging: Optional[Dict[GangKey, dict]] = None,
        defrag_spend: Optional[List[float]] = None,
        rescuing: Optional[Dict[GangKey, dict]] = None,
    ) -> dict:
        """The compaction document replay() reads, built by the owner
        (``gang.py``) from the live table, its lapse bars and wait clocks."""
        return {
            "holds": [
                {
                    "ns": k[0],
                    "gang": k[1],
                    "hosts": dict(h.hosts),
                    "demands": list(h.demands),
                    "counted": sorted(h.counted_pods),
                    "created": round(h.created_ts, 3),
                    "priority": int(h.priority),
                }
                for k, h in sorted(holds.items())
            ],
            "lapsed": sorted(list(k) for k in lapsed),
            "waiting": [[k[0], k[1], round(ts, 3)] for k, ts in sorted(waiting_since.items())],
            "preempting": AdmissionJournal._rounds_to_snap(preempting),
            "defragging": AdmissionJournal._rounds_to_snap(defragging),
            "rescuing": AdmissionJournal._rounds_to_snap(rescuing),
            # Full precision: same-millisecond stamps stay distinct.
            "defrag_spend": sorted(float(t) for t in defrag_spend or []),
        }


def self_test() -> int:
    """Drive a journal through a reserve, a crash and its replay, a torn
    tail, a compaction, and an open round of each two-phase plane surviving
    a replay and a compaction, in a temporary dir; print a one-line JSON
    verdict."""
    import json
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="gpu-journal-selftest-")
    try:
        j = AdmissionJournal(d)
        key = ("default", "train")
        j.record("reserve", key, hosts={"n1": 4}, demands=[2, 2], age_s=0.0)
        j.record("admit", key, hosts={"n1": 4}, demands=[2, 2])
        j.record("shrink", key, pod="w0", host="n1", chips=2)
        j.record("wait", ("default", "starved"), since=123.0)
        j.close()  # the process "dies"; the file survives

        st = AdmissionJournal(d).replay()
        assert st.status == statestore.CLEAN, st.status
        assert st.holds[key].hosts == {"n1": 2}, st.holds
        assert st.holds[key].counted_pods == {"w0"}
        assert st.waiting_since[("default", "starved")] == 123.0

        # A torn tail: the durable prefix survives.
        j2 = AdmissionJournal(d)
        j2.replay()
        j2.record("lapse", key)
        j2.close()
        with open(j2.store.journal_path, "rb+") as f:
            f.truncate(max(0, f.seek(0, 2) - 7))
        j3 = AdmissionJournal(d)
        st = j3.replay()
        assert st.status == statestore.TORN_TAIL, st.status
        assert key in st.holds  # the torn lapse never committed

        # A compaction, then a replay over the snapshot.
        j3.compact(AdmissionJournal.state_data(st.holds, st.lapsed, st.waiting_since))
        j3.record("drop", key)
        j3.close()
        st = AdmissionJournal(d).replay()
        assert key not in st.holds
        assert st.waiting_since[("default", "starved")] == 123.0

        # An open evicted round of each two-phase plane survives a replay
        # and a compaction, then closes on its done record.
        for plane, field in _ROUND_OPS.items():
            rk = ("default", f"{plane}-gang")
            jr = AdmissionJournal(d)
            jr.replay()  # the owner's load: the seq continues
            for phase in ("intent", "evicted"):
                jr.record(f"{plane}_{phase}", rk, victims=[["default", "v"]],
                          consumed={"n2": 4}, demands=[4])
            jr.close()
            st = AdmissionJournal(d).replay()
            assert getattr(st, field)[rk]["phase"] == "evicted", getattr(st, field)
            assert getattr(st, field)[rk]["consumed"] == {"n2": 4}
            jc = AdmissionJournal(d)
            st = jc.replay()
            jc.compact(AdmissionJournal.state_data(
                st.holds, st.lapsed, st.waiting_since, st.preempting, st.defragging,
                rescuing=st.rescuing))
            assert getattr(jc.replay(), field)[rk]["phase"] == "evicted"
            jc.record(f"{plane}_done", rk)
            jc.close()
            assert rk not in getattr(AdmissionJournal(d).replay(), field)
        print(json.dumps({"journal_self_test": "ok"}))
        return 0
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--self-test", action="store_true",
                   help="run the crash-recovery smoke in a temporary dir")
    a = p.parse_args(argv)
    if a.self_test:
        return self_test()
    p.print_help()
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
