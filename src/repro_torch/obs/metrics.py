"""Hierarchical metrics registry — one ``/``-path schema for ``stats()``.

Subsystems implement ``metrics(registry=None, prefix=...)``, which fills
(and returns) a registry of gauges (``serve/engine/clock_s``,
``serve/engine/transport/link/<name>/busy_s``, ...); their ``stats()``
dicts are thin adapters over the registry snapshot.  Values are stored
exactly as given (no float coercion), so the dicts match the
reference's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v

    def get(self):
        return self.value


class MetricsRegistry:
    """Get-or-create store of named metrics.  Names are ``/``-separated
    paths; ``snapshot()`` flattens to ``{path: value}`` and ``tree()``
    nests by path segment (the shape ``--json`` files serialize)."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, kind):
        m = self._metrics.get(name)
        if m is None:
            m = kind()
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {kind.__name__}")
        return m

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def set(self, name: str, value) -> None:
        """Shorthand: ``gauge(name).set(value)`` — the bulk of the
        ``metrics()`` implementations are point-in-time snapshots."""
        self.gauge(name).set(value)

    # ---- reading ---------------------------------------------------------
    def snapshot(self, prefix: str = "") -> Dict[str, Any]:
        """Flat ``{name: value}`` of every metric under ``prefix``."""
        return {n: m.get() for n, m in sorted(self._metrics.items())
                if n.startswith(prefix)}
