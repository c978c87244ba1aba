"""The kernel leg of the bench: the counterpart of ``bench.py``'s
``run_kernels`` and its helpers.

The port's microbench (``ops/microbench.py``) runs in a subprocess, in
two tiers:

1. the micro tier (``--stream --tier micro``: the matmul anchor, one
   flash-vs-dense case at seq 2048 and the agreement check) under a window
   timeout, retried up to an attempt cap until one window yields numbers;
   a stall costs one window, not the budget;
2. the full tier with whatever budget remains, merged over the micro
   tier's cases: a full-tier case overrides its micro twin, except where
   the micro case was captured and the full one was not.

Every attempt is recorded in ``attempts``, and ``emit(state)`` is called
after every change of state (a failed window, the micro capture, the
merge), so a caller killed mid-leg keeps what was captured.

    python -m k8s_device_plugin_tpu_torch.tools.bench_kernels --budget-s 120
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

MICROBENCH = "k8s_device_plugin_tpu_torch.ops.microbench"
ROOT = Path(__file__).resolve().parents[2]
# Pause after an attempt that failed within FAST_FAILURE_S (a bad import,
# an instant exit): such a failure is no stall, and retrying at once would
# spend the attempts in a few seconds.
FAST_FAILURE_S = 5.0
FAST_FAILURE_PAUSE_S = 3.0


def parse_report(stdout: str):
    """The last JSON line of ``stdout`` that is a microbench report (a dict
    carrying ``kernels``); None when there is none."""
    for line in reversed(stdout.strip().splitlines()):
        try:
            report = json.loads(line)
        except ValueError:
            continue
        if isinstance(report, dict) and "kernels" in report:
            return report
    return None


def run_module(args: list, timeout_s: float):
    """``python -m <args>`` from the repository's root with a hard timeout:
    (report or None, error or None). A streaming run killed at its timeout
    gives its last complete partial report."""
    try:
        proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                              text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        partial = parse_report(out)
        if partial is not None:
            partial["timed_out_after_s"] = timeout_s
            return partial, None
        return None, f"timed out after {timeout_s:.0f}s"
    report = parse_report(proc.stdout)
    if report is None:
        return None, (f"rc={proc.returncode}, no JSON on stdout; "
                      f"stderr tail: {proc.stderr.strip()[-400:]}")
    return report, None


def _case_has_numbers(case) -> bool:
    """True when one kernel case carries a real timing (an ``ms`` side);
    a skipped or failed case does not."""
    return isinstance(case, dict) and any(
        isinstance(side, dict) and side.get("ms") for side in case.values())


def _has_kernel_numbers(report) -> bool:
    """True when at least one case carries a real timing; a report whose
    cases are all skipped or failed, or a partial line with no case yet,
    is no capture."""
    if not isinstance(report, dict):
        return False
    return any(_case_has_numbers(c) for c in (report.get("kernels") or {}).values())


def _case_captured(case) -> bool:
    """A case worth keeping in a merge: it measured something (a side with
    ``ms``) or gave a verdict (the agreement check's ``ok``), as against a
    skip or an error."""
    if _case_has_numbers(case):
        return True
    return (isinstance(case, dict) and "ok" in case and "skipped" not in case
            and "error" not in case)


def _merge_kernels(micro: dict, full: dict) -> dict:
    """Full-tier cases override their micro twins (more calls, longer
    windows), but never with a skipped or failed entry where the micro
    tier captured that case."""
    merged = dict(micro)
    for name, case in full.items():
        if name in merged and _case_captured(merged[name]) and not _case_captured(case):
            continue
        merged[name] = case
    return merged


def run_kernels(budget_s: float, emit=None, window_s: float = 30.0, max_attempts: int = 8,
                runner=run_module) -> dict:
    """The micro tier in windows of ``window_s`` (at most ``max_attempts``),
    then the full tier with the rest of ``budget_s``; returns the merged
    report with ``attempts``, or an ``error`` or ``skipped`` record with
    them. ``runner(args, timeout_s)`` runs one microbench subprocess and
    returns (report or None, error or None)."""
    t_start = time.monotonic()

    def left() -> float:
        return budget_s - (time.monotonic() - t_start)

    def note(state: dict) -> None:
        if emit is not None:
            emit(state)

    attempts: list = []
    micro = None
    while len(attempts) < max_attempts:
        room = left() - 5
        if room < 20:
            break
        window = min(window_s, room)
        t0 = time.monotonic()
        report, err = runner([MICROBENCH, "--stream", "--tier", "micro",
                              "--budget-s", str(int(window - 5))], window)
        took = round(time.monotonic() - t0, 1)
        if _has_kernel_numbers(report):
            attempts.append({"ok": True, "tier": "micro", "took_s": took})
            micro = report
            micro["attempts"] = attempts
            note(micro)
            break
        attempts.append({"ok": False, "tier": "micro", "took_s": took,
                         "error": (err or "report without kernel numbers")[:200]})
        note({"in_progress": True, "attempts": list(attempts)})
        if took < FAST_FAILURE_S:
            time.sleep(FAST_FAILURE_PAUSE_S)
    if micro is None:
        if not attempts:
            return {"skipped": f"budget exhausted ({left():.0f}s left)"}
        return {"error": "no kernel numbers: every micro-tier window failed",
                "attempts": attempts}

    room = left() - 5
    if room >= 45:
        t0 = time.monotonic()
        full, err = runner([MICROBENCH, "--stream", "--budget-s", str(int(room - 10))], room)
        took = round(time.monotonic() - t0, 1)
        if _has_kernel_numbers(full):
            attempts.append({"ok": True, "tier": "full", "took_s": took})
            full["kernels"] = _merge_kernels(micro["kernels"], full["kernels"])
            full["attempts"] = attempts
            note(full)
            return full
        attempts.append({"ok": False, "tier": "full", "took_s": took,
                         "error": (err or "report without kernel numbers")[:200]})
        note(micro)
    return micro


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--budget-s", type=float, default=120.0)
    p.add_argument("--window-s", type=float, default=30.0)
    p.add_argument("--max-attempts", type=int, default=8)
    args = p.parse_args(argv)
    report = run_kernels(args.budget_s, emit=lambda r: print(json.dumps(r), flush=True),
                         window_s=args.window_s, max_attempts=args.max_attempts)
    print(json.dumps(report), flush=True)
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
