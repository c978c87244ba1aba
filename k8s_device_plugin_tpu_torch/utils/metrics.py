"""The metric classes of the JAX package's ``utils/metrics.py`` and the
families the port's health watcher, decision ledger, flight recorder and
supervised loops write, under the JAX names and labels. The histograms,
the HTTP endpoint and the other families come with the plugin server."""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple


class Metric:
    def __init__(self, name: str, help_text: str, kind: str):
        self.name = name
        self.help = help_text
        self.kind = kind  # "counter" | "gauge"
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted(labels.items()))

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = value

    def get(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def render(self, openmetrics: bool = False) -> str:
        # OpenMetrics declares a counter family without the _total suffix
        # (samples keep it).
        family = self.name
        if openmetrics and self.kind == "counter" and family.endswith("_total"):
            family = family[: -len("_total")]
        lines = [
            f"# HELP {family} {self.help}",
            f"# TYPE {family} {self.kind}",
        ]
        with self._lock:
            if not self._values:
                lines.append(f"{self.name} 0")
            for key, value in sorted(self._values.items()):
                if key:
                    label_s = ",".join(f'{k}="{v}"' for k, v in key)
                    lines.append(f"{self.name}{{{label_s}}} {_fmt(value)}")
                else:
                    lines.append(f"{self.name} {_fmt(value)}")
        return "\n".join(lines)


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(v)


class Registry:
    def __init__(self, uptime_name: str = "tpu_plugin_uptime_seconds"):
        self._metrics: Dict[str, Metric] = {}
        self._start = time.time()
        self._uptime_name = uptime_name

    def counter(self, name: str, help_text: str) -> Metric:
        return self._register(name, help_text, "counter")

    def gauge(self, name: str, help_text: str) -> Metric:
        return self._register(name, help_text, "gauge")

    def _register(self, name: str, help_text: str, kind: str) -> Metric:
        if name not in self._metrics:
            self._metrics[name] = Metric(name, help_text, kind)
        return self._metrics[name]

    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text format (``openmetrics=True`` adds the closing
        ``# EOF``)."""
        parts = [m.render(openmetrics=openmetrics) for m in self._metrics.values()]
        parts.append(
            f"# HELP {self._uptime_name} Seconds since process start\n"
            f"# TYPE {self._uptime_name} gauge\n"
            f"{self._uptime_name} "
            f"{_fmt(round(time.time() - self._start, 1))}"
        )
        out = "\n".join(parts) + "\n"
        if openmetrics:
            out += "# EOF\n"
        return out


# The plugin's metrics (module-level: one daemon per process).
REGISTRY = Registry()
APP_FAULTS = REGISTRY.counter(
    "tpu_plugin_app_faults_total",
    "Application-level chip faults observed (not marked unhealthy), "
    "by reason",
)
FLIGHT_EVENTS = REGISTRY.counter(
    "tpu_plugin_flight_events_total",
    "Flight-recorder events captured, by kind (utils/flightrecorder.py)",
)
DECISIONS = REGISTRY.counter(
    "tpu_plugin_decisions_total",
    "Scheduling/health decisions recorded by this daemon's decision "
    "ledger (utils/decisions.py), by kind and machine-readable reason token",
)
LOOP_STALLS = REGISTRY.counter(
    "tpu_loop_stall_total",
    "Loop stall transitions by loop and reason: died (the thread exited "
    "on an unhandled exception; run_supervised counts it)",
)
