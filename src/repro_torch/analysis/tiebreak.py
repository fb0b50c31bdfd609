"""Seeded tie-break perturbation seam for the determinism race detector.

The estate's headline claims are *bit-exactness* claims on one modeled
clock, yet several decision paths enumerate collections whose order is
**incidental** — dict views, candidate lists, same-timestamp event
batches.  Python's insertion-ordered dicts make those enumerations
deterministic *today*, which is exactly the trap: a refactor that
changes insertion order silently changes results, and no test notices
because every run of the changed code agrees with itself.

This module is the seam ``repro_torch.analysis.racecheck`` drives to prove
the enumerations don't matter.  Decision paths route incidental
enumerations through :func:`order` (or :func:`shuffled`):

* **inactive** (the default, and the only mode production code ever
  sees): ``order(items)`` returns ``list(items)`` unchanged — the
  exact enumeration the subsystem used before the seam existed, so
  instrumented code is bit-identical to pre-seam code;
* **active** (inside :func:`perturb`): the enumeration is permuted by
  a seeded ``random.Random``, so K differently-seeded runs exercise K
  different enumeration orders.  If outcomes and traces stay
  bit-identical across all of them, every decision downstream of the
  seam is a total-order reduction or a commutative accumulation — the
  dynamic proof of order-insensitivity.

The discipline the seam enforces (and the ``no-unordered-iteration``
lint checks statically): *perturb enumeration orders; canonicalize
before any order-sensitive effect*.  Spec'd tie-breaks (FIFO by
submission sequence, serve-before-train on equal clocks, victim = max
over-share then min name) are encoded as **total-order sort/selection
keys**, which permutation cannot disturb; they are never themselves
perturbed.

Stdlib-only; importing this module must stay cheap (it sits on the
import path of every modeled-time subsystem).
"""

from __future__ import annotations

import contextlib
import random
from typing import Iterable, Iterator, List, Optional, TypeVar

__all__ = ["TieBreaker", "active", "order", "perturb"]

T = TypeVar("T")


class TieBreaker:
    """A seeded permutation source.  One instance = one perturbation
    schedule: calls consume the generator in program order, so a fixed
    seed replays the identical perturbation sequence (the harness can
    re-run a diverging seed to bisect)."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)

    def order(self, items: Iterable[T]) -> List[T]:
        out = list(items)
        if len(out) > 1:
            self._rng.shuffle(out)
        return out


# the active tiebreaker, installed by ``perturb`` — module-level so the
# subsystems need no new constructor arguments (the seam must not
# change any public API or any default behavior)
_ACTIVE: Optional[TieBreaker] = None


def active() -> bool:
    """True inside a ``perturb`` context."""
    return _ACTIVE is not None


def order(items: Iterable[T]) -> List[T]:
    """The seam: claims the enumeration order of ``items`` is
    incidental.  Identity (a plain ``list``) unless a perturbation is
    active, in which case the list is re-ordered by the seeded RNG.

    Call it ONLY where every downstream effect is order-insensitive —
    a total-order ``min``/``max``/``sorted`` key, an integer sum, a
    per-key independent write.  Float accumulations and trace
    emissions are NOT order-insensitive; sort first.
    """
    if _ACTIVE is None:
        return list(items)
    return _ACTIVE.order(items)


@contextlib.contextmanager
def perturb(seed: int) -> Iterator[TieBreaker]:
    """Install a seeded :class:`TieBreaker` for the duration of the
    context.  Re-entrant (the previous tiebreaker is restored), but the
    modeled-time subsystems are single-threaded by design so there is
    no cross-thread isolation — don't run perturbed scenarios
    concurrently."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = TieBreaker(seed)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev
