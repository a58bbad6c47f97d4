"""Prometheus text-exposition metrics (``iresearch_tpu/utils/metrics.py``):
the counters the host layers bump for every bounded behaviour, rendered in
the text exposition format or written to a file (the CLI's
``--metrics-out``)."""

from __future__ import annotations

from typing import Dict, Optional, TextIO, Tuple


class MetricsRegistry:
    def __init__(self) -> None:
        self._gauges: Dict[Tuple[str, tuple], float] = {}
        self._counters: Dict[Tuple[str, tuple], float] = {}
        self._help: Dict[str, str] = {}

    def gauge(
        self, name: str, value: float, labels: Optional[Dict[str, str]] = None,
        help_: str = "",
    ) -> None:
        key = (name, tuple(sorted((labels or {}).items())))
        self._gauges[key] = float(value)
        if help_:
            self._help[name] = help_

    def counter(
        self, name: str, inc: float = 1.0,
        labels: Optional[Dict[str, str]] = None, help_: str = "",
    ) -> float:
        """Monotonic counter (the no-silent-caps channel: every bounded
        behavior — dropped dense-grid terms, scored_terms_limit
        truncations, batch chunking — increments one of these)."""
        key = (name, tuple(sorted((labels or {}).items())))
        cur = self._counters.get(key, 0.0) + float(inc)
        self._counters[key] = cur
        if help_:
            self._help[name] = help_
        return cur

    def counter_value(
        self, name: str, labels: Optional[Dict[str, str]] = None
    ) -> float:
        key = (name, tuple(sorted((labels or {}).items())))
        return self._counters.get(key, 0.0)

    def render(self) -> str:
        """Prometheus text exposition format."""
        out = []
        seen = set()
        for kind, series in (
            ("gauge", self._gauges),
            ("counter", self._counters),
        ):
            for (name, labels), value in sorted(series.items()):
                if name not in seen:
                    seen.add(name)
                    if name in self._help:
                        out.append(f"# HELP {name} {self._help[name]}")
                    out.append(f"# TYPE {name} {kind}")
                if labels:
                    lbl = ",".join(f'{k}="{v}"' for k, v in labels)
                    out.append(f"{name}{{{lbl}}} {value}")
                else:
                    out.append(f"{name} {value}")
        return "\n".join(out) + "\n"

    def write(self, fh_or_path) -> None:
        text = self.render()
        if hasattr(fh_or_path, "write"):
            fh_or_path.write(text)
        else:
            with open(fh_or_path, "w") as fh:
                fh.write(text)


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry
