"""tpu-flame: render a profiler capture as a terminal flamegraph.

The last mile of the port's profiling plane (``utils/stackprof.py``): the
``/debug/profile`` exports and the ``--capture-dir`` bundles are machine
formats (collapsed stacks, speedscope JSON); this CLI turns any of them
into something an operator reads over ssh:

* a **top-N table**: per frame, the SELF samples (the program counter in
  that function) and the TOTAL samples (that function anywhere on the
  stack);
* a **terminal flamegraph**: the merged call tree, indented, each frame
  with a share bar sized by its subtree's samples.

Inputs (sniffed, not flagged):

* collapsed-stack text (``stack;frames count`` lines: the
  ``?format=collapsed`` export's ``folded`` string, or flamegraph.pl
  files),
* a speedscope JSON document (``$schema`` + ``profiles``),
* a ``/debug/profile`` payload (a ``profile`` or ``folded`` key),
* an SLO capture bundle (``--capture-dir``; the ``profile`` section's
  ``folded``/``speedscope``),

from a file path, ``-`` for stdin, or ``--url`` to GET a live
``/debug/profile``. ``--self-test`` drives the port's chain: a busy thread,
the port's ``SamplingProfiler``, both exports, this parser and both
renderers.

The verbs, flags, exit codes and output are the JAX package's
``tools/flame.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

FoldedCounts = Dict[Tuple[str, ...], int]


# ---------------------------------------------------------------------------
# Parsing (any supported shape → {stack tuple: count})
# ---------------------------------------------------------------------------


def parse_collapsed(text: str) -> FoldedCounts:
    """Collapsed-stack lines: ``frame;frame;frame count``. A line that
    does not parse is skipped (a truncated tail must not lose the rest of
    the file)."""
    out: FoldedCounts = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack_s, _, count_s = line.rpartition(" ")
        if not stack_s:
            continue
        try:
            count = int(count_s)
        except ValueError:
            continue
        key = tuple(p for p in stack_s.split(";") if p)
        if key:
            out[key] = out.get(key, 0) + count
    return out


def from_speedscope(doc: dict) -> FoldedCounts:
    """A speedscope 'sampled' profile document → folded counts. Our
    exporter stamps the sampling ``hz`` on the profile (non-standard,
    ignored by the app), so counts recover exactly as weight × hz;
    foreign files fall back to proportional integers scaled by the
    smallest weight."""
    frames = [
        f.get("name", "?")
        for f in (doc.get("shared") or {}).get("frames", [])
    ]
    out: FoldedCounts = {}
    for prof in doc.get("profiles", []):
        if prof.get("type") != "sampled":
            continue
        samples = prof.get("samples", [])
        weights = prof.get("weights", [])
        hz = prof.get("hz")
        unit = min((w for w in weights if w > 0), default=1.0)
        for i, idxs in enumerate(samples):
            key = tuple(
                frames[j] if 0 <= j < len(frames) else "?" for j in idxs
            )
            if not key:
                continue
            w = weights[i] if i < len(weights) else unit
            count = w * hz if hz else w / unit
            out[key] = out.get(key, 0) + max(1, round(count))
    return out


def load_any(obj) -> FoldedCounts:
    """Sniff one payload: collapsed text, speedscope doc,
    /debug/profile payload, or a capture bundle."""
    if isinstance(obj, str):
        stripped = obj.lstrip()
        if stripped.startswith("{"):
            return load_any(json.loads(obj))
        return parse_collapsed(obj)
    if not isinstance(obj, dict):
        raise ValueError(f"unsupported profile payload: {type(obj)}")
    if "profiles" in obj:  # a bare speedscope document
        return from_speedscope(obj)
    profile = obj.get("profile")
    if isinstance(profile, dict):
        # /debug/profile speedscope payload, or a capture bundle's
        # profile section ({enabled, folded, speedscope}).
        if "profiles" in profile:
            return from_speedscope(profile)
        if profile.get("enabled") is False:
            raise ValueError(
                "capture bundle has no profile samples "
                "(--profile-hz was 0 when it was taken)"
            )
        if isinstance(profile.get("speedscope"), dict):
            return from_speedscope(profile["speedscope"])
        if isinstance(profile.get("folded"), str):
            return parse_collapsed(profile["folded"])
    if isinstance(obj.get("folded"), str):  # ?format=collapsed payload
        return parse_collapsed(obj["folded"])
    if obj.get("enabled") is False:
        raise ValueError(
            "payload reports enabled: false — no profiler was running "
            "(pass ?seconds=N for a burst, or start --profile-hz)"
        )
    raise ValueError(
        "unrecognized profile payload (expected collapsed text, "
        "speedscope JSON, a /debug/profile payload, or a capture "
        "bundle)"
    )


def load_path(path: str) -> FoldedCounts:
    if path == "-":
        return load_any(sys.stdin.read())
    with open(path) as f:
        return load_any(f.read())


# ---------------------------------------------------------------------------
# Aggregation + rendering
# ---------------------------------------------------------------------------


def top_frames(folded: FoldedCounts, n: int = 20) -> List[dict]:
    """Per-frame self/total sample counts, self-heaviest first (ties
    by total). ``total`` counts a frame once per stack regardless of
    recursion depth."""
    self_c: Dict[str, int] = {}
    total_c: Dict[str, int] = {}
    for stack, count in folded.items():
        self_c[stack[-1]] = self_c.get(stack[-1], 0) + count
        for frame in set(stack):
            total_c[frame] = total_c.get(frame, 0) + count
    rows = [
        {
            "frame": frame,
            "self": self_c.get(frame, 0),
            "total": total,
        }
        for frame, total in total_c.items()
    ]
    rows.sort(key=lambda r: (-r["self"], -r["total"], r["frame"]))
    return rows[:n]


def render_top(folded: FoldedCounts, n: int = 20) -> str:
    total = sum(folded.values()) or 1
    lines = [
        f"{'SELF':>7} {'SELF%':>6} {'TOTAL':>7} {'TOT%':>6}  FRAME",
    ]
    for row in top_frames(folded, n):
        lines.append(
            f"{row['self']:>7} {100.0 * row['self'] / total:>5.1f}% "
            f"{row['total']:>7} {100.0 * row['total'] / total:>5.1f}%  "
            f"{row['frame']}"
        )
    return "\n".join(lines)


class _Node:
    __slots__ = ("count", "children")

    def __init__(self):
        self.count = 0
        self.children: Dict[str, _Node] = {}


def _tree(folded: FoldedCounts) -> _Node:
    root = _Node()
    for stack, count in folded.items():
        root.count += count
        node = root
        for frame in stack:
            node = node.children.setdefault(frame, _Node())
            node.count += count
    return root


def render_flame(
    folded: FoldedCounts,
    width: int = 100,
    max_depth: int = 40,
    min_pct: float = 0.5,
) -> str:
    """The merged call tree, hottest-first, with per-frame share bars
    — a flamegraph rotated 90° for a terminal. Subtrees under
    ``min_pct`` of total samples collapse into a ``…`` marker so a
    wide profile stays readable."""
    root = _tree(folded)
    total = root.count or 1
    barw = 24
    lines: List[str] = [f"total samples: {total}"]

    def walk(node: _Node, depth: int) -> None:
        if depth >= max_depth:
            return
        hidden = 0
        for name, child in sorted(
            node.children.items(), key=lambda kv: -kv[1].count
        ):
            pct = 100.0 * child.count / total
            if pct < min_pct:
                hidden += child.count
                continue
            bar = "█" * max(1, round(barw * child.count / total))
            label = f"{'  ' * depth}{name}"
            lines.append(
                f"{bar:<{barw}} {pct:>5.1f}% {child.count:>7}  "
                f"{label[: max(20, width - barw - 16)]}"
            )
            walk(child, depth + 1)
        if hidden:
            lines.append(
                f"{'':<{barw}} {100.0 * hidden / total:>5.1f}% "
                f"{hidden:>7}  {'  ' * depth}…"
            )

    walk(root, 0)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _fetch_url(url: str) -> FoldedCounts:
    import urllib.request

    with urllib.request.urlopen(url, timeout=70) as resp:
        return load_any(resp.read().decode())


def self_test() -> int:
    """A busy thread with a known hot frame, sampled by the port's
    profiler, exported in both formats, parsed by this module and rendered
    both ways: a drift anywhere in the chain (export shape, folded syntax,
    speedscope frames) fails here."""
    import threading
    import time

    from ..utils import stackprof

    stop = threading.Event()

    def _flame_selftest_spin():
        while not stop.is_set():
            sum(i * i for i in range(500))

    # A self-test-local busy loop, joined below: supervision would only
    # add teardown noise.  # tpu-lint: disable=TPL001
    t = threading.Thread(
        target=_flame_selftest_spin, name="flame-selftest", daemon=True
    )
    t.start()
    prof = stackprof.SamplingProfiler(hz=199, service="plugin")
    prof.start()
    deadline = time.monotonic() + 5.0
    try:
        # Until the hot frame is visibly dominant (fast box: ~0.2 s).
        while time.monotonic() < deadline:
            time.sleep(0.1)
            if prof.snapshot()["samples"] >= 20:
                break
    finally:
        prof.stop()
        stop.set()
        t.join(timeout=2)
    collapsed = prof.export_collapsed()
    speedscope = prof.export_speedscope()
    assert collapsed, "profiler captured nothing"
    for name, folded in (
        ("collapsed", parse_collapsed(collapsed)),
        ("speedscope", from_speedscope(speedscope)),
        ("debug-payload", load_any(
            {"enabled": True, "format": "collapsed", "folded": collapsed}
        )),
        ("capture-bundle", load_any({
            "profile": {
                "enabled": True,
                "folded": collapsed,
                "speedscope": speedscope,
            }
        })),
    ):
        assert folded, f"{name} parse produced nothing"
        # The hot function's SELF time sits in its genexpr leaf; the
        # function itself must still rank by TOTAL in the top table.
        rows = top_frames(folded, n=10)
        assert any(
            "_flame_selftest_spin" in r["frame"] for r in rows
        ), f"{name}: hot frame missing from the top table: {rows}"
        assert "_flame_selftest_spin" in render_top(folded)
        assert "_flame_selftest_spin" in render_flame(folded)
    # Collapsed and speedscope must agree on total samples exactly
    # (the speedscope weights are count/hz by construction).
    assert (
        sum(parse_collapsed(collapsed).values())
        == sum(from_speedscope(speedscope).values())
    )
    print(json.dumps({
        "flame_self_test": "ok",
        "samples": prof.snapshot()["samples"],
        "stacks": prof.snapshot()["stacks"],
    }))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu-flame",
        description="render a profiler capture (collapsed stacks, "
        "speedscope JSON, /debug/profile payload, or a capture "
        "bundle) as a terminal flamegraph + top-N self-time table",
    )
    p.add_argument(
        "path", nargs="?",
        help="capture file, or - for stdin",
    )
    p.add_argument(
        "--url",
        help="GET a live /debug/profile (e.g. "
        "http://extender:12346/debug/profile?seconds=5)",
    )
    p.add_argument("--top", type=int, default=20,
                   help="rows in the self-time table")
    p.add_argument("--depth", type=int, default=40,
                   help="max tree depth rendered")
    p.add_argument("--min-pct", type=float, default=0.5,
                   help="collapse subtrees below this %% of samples")
    p.add_argument("--width", type=int, default=100)
    p.add_argument("--self-test", action="store_true",
                   help="CI smoke: profile a busy loop through the "
                   "real sampler, parse and render every format")
    a = p.parse_args(argv)
    if a.self_test:
        return self_test()
    if not a.path and not a.url:
        p.error("need a capture file, -, or --url")
    try:
        folded = _fetch_url(a.url) if a.url else load_path(a.path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not folded:
        print("error: no samples in the capture", file=sys.stderr)
        return 2
    print(render_top(folded, n=a.top))
    print()
    print(render_flame(
        folded, width=a.width, max_depth=a.depth, min_pct=a.min_pct
    ))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
