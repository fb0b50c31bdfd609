"""Pluggable AST lint rules for the port's modeled-time estate (a copy of
``repro.analysis.lints``, rescoped to ``src/repro_torch``).

The port's modeled clock must stay identical to the reference's: library
code must never read the host wall clock, draw unseeded randomness, or
bypass the observability layer.  These rules are the static half of that
discipline; the dynamic half is the port's trace sanitizer
(``repro_torch.analysis.sanitizer``).

Each rule is an AST visitor keyed by a stable name; violations carry
``path:line`` plus a message.  A justified exception is annotated
inline on the offending line, with the reference's syntax, so one
annotation reads alike in both packages::

    t0 = time.time()    # repro: allow(no-wallclock) host-side profiling

The rules are the reference's, copied (the port imports nothing of
``repro``), with the path scopes keyed on a path part named
``repro_torch``.  The reference's sixth rule, ``compat-imports``, guards
jax version drift through ``repro.core.compat``; the port imports no
jax and has no such shim, so it is left out.

Shipped rules:

``no-bare-print``
    No ``print(`` calls anywhere under ``src/repro_torch`` — human-facing
    output goes through ``repro_torch.obs.console``, reports through the
    metrics registry.
``no-wallclock``
    Inside the modeled-time subsystems (``serve/``, ``fabric/``,
    ``pool/``, ``colo/``, ``obs/``, ``disagg/``): no ``time.time()`` /
    ``perf_counter()`` / ``datetime.now()`` and no *unseeded* module-
    level ``random`` / ``np.random`` calls.  Wall clocks and ambient
    RNG state make event streams host-dependent; modeled clocks and
    explicitly-seeded generators do not.
``no-mutable-default``
    No mutable literals (list/dict/set displays or comprehensions) as
    function-parameter or dataclass-field defaults — the shared-
    instance aliasing bug class.
``no-unordered-iteration``
    In the scheduling decision paths (``pool/scheduler.py``,
    ``serve/arbiter.py``, ``fabric/transport.py``): no ``for`` loop or
    comprehension directly over a dict view (``.items()`` /
    ``.values()`` / ``.keys()``) or a set.  Insertion order is
    deterministic *today*, which is the trap — a refactor that changes
    insertion order silently changes scheduling outcomes and every run
    of the changed code agrees with itself.  Route the enumeration
    through ``sorted(...)`` (canonical) or
    ``repro_torch.analysis.tiebreak.order(...)`` (the racecheck
    perturbation seam), or annotate a proof of order-insensitivity
    (integer sums, ``any``/``all``, total-order ``min``/``max`` keys,
    per-key independent writes).
``no-float-equality``
    Inside the modeled-time subsystems (``serve/``, ``fabric/``,
    ``pool/``, ``colo/``): no ``==`` / ``!=`` against a modeled-time
    value (``clock``, ``*_s``, ``t``, ``dt``, ``completion``, ...).
    Accumulated floats are association-sensitive; two clocks that are
    "the same time" may differ in the last ulp, so float equality on
    them is a latent heisenbug.  The sanctioned patterns — identity
    tests of an uncopied stored float (heap keys, progress checks) —
    are annotated where they occur.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.lints [PATH...]
    # default src/repro_torch
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "LintViolation", "Rule", "RULES", "iter_py_files", "lint_file",
    "lint_paths", "main", "suppressed_lines",
]

# one inline annotation silences one rule on one line:
#   ``# repro: allow(<rule>)`` with an optional trailing reason
_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\(\s*([\w\-,\s]+?)\s*\)")

# the package part the path-scoped rules key on
_PKG = "repro_torch"

# subsystems that run on the modeled clock: the no-wallclock scope
MODELED_TIME_DIRS = ("serve", "fabric", "pool", "colo", "obs",
                     "disagg")


@dataclasses.dataclass(frozen=True)
class LintViolation:
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def suppressed_lines(source: str) -> dict:
    """Map line number -> set of rule names allowed on that line."""
    out: dict = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


class Rule:
    """One lint rule.  Subclasses set ``name``/``description`` and
    implement ``check``; ``applies_to`` scopes the rule by path."""

    name: str = ""
    description: str = ""

    def applies_to(self, path: Path) -> bool:
        return True

    def check(self, tree: ast.AST, path: Path,
              source: str) -> Iterator[Tuple[int, str]]:
        raise NotImplementedError


def _call_name(node: ast.AST) -> Optional[str]:
    """Dotted name of a call target: ``a.b.c`` -> "a.b.c", else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class NoBarePrint(Rule):
    name = "no-bare-print"
    description = ("bare print() in library code — use "
                   "repro_torch.obs.console or the metrics registry")

    def check(self, tree, path, source):
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                yield node.lineno, ("bare print() in library code (route "
                                    "through repro_torch.obs.console)")


class NoWallclock(Rule):
    name = "no-wallclock"
    description = ("wall-clock reads / unseeded RNG inside modeled-time "
                   "subsystems break trace determinism")

    # module-level calls that read host state
    _WALLCLOCK_CALLS = {
        "time.time", "time.time_ns", "time.perf_counter",
        "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
        "time.process_time",
        "datetime.now", "datetime.utcnow", "datetime.today", "date.today",
        "datetime.datetime.now", "datetime.datetime.utcnow",
        "datetime.datetime.today", "datetime.date.today",
    }
    # module-state RNG namespaces: any call into them is ambient/unseeded
    _RNG_MODULES = ("random.", "np.random.", "numpy.random.",
                    "jax.random.")            # jax.random.* is keyed, so
    # jax.random is NOT ambient — exclude it below; listed here only to
    # document the decision
    _RNG_CLASS_OK = {"Random", "RandomState", "Generator", "SeedSequence",
                     "default_rng", "PRNGKey", "key"}
    _WALLCLOCK_IMPORTS = {
        ("time", "time"), ("time", "time_ns"), ("time", "perf_counter"),
        ("time", "perf_counter_ns"), ("time", "monotonic"),
        ("time", "monotonic_ns"), ("time", "process_time"),
        ("datetime", "datetime"), ("datetime", "date"),
    }

    def applies_to(self, path: Path) -> bool:
        parts = set(path.parts)
        return _PKG in parts and bool(parts & set(MODELED_TIME_DIRS))

    def _rng_violation(self, dotted: str, node: ast.Call) -> Optional[str]:
        for mod in ("random.", "np.random.", "numpy.random."):
            if dotted.startswith(mod):
                fn = dotted[len(mod):]
                if fn in ("seed",):
                    return (f"{dotted}() mutates global RNG state — "
                            f"construct a seeded generator instead")
                if fn not in self._RNG_CLASS_OK:
                    return (f"{dotted}() draws from ambient RNG state — "
                            f"use a seeded RandomState/Generator")
                # constructing a generator is fine only when seeded
                if not node.args and not any(
                        kw.arg in ("seed", "x") for kw in node.keywords):
                    return (f"{dotted}() without a seed is "
                            f"host-nondeterministic")
        return None

    def check(self, tree, path, source):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                dotted = _call_name(node.func)
                if dotted is None:
                    continue
                if dotted in self._WALLCLOCK_CALLS:
                    yield node.lineno, (
                        f"{dotted}() reads the host wall clock inside a "
                        f"modeled-time subsystem")
                    continue
                msg = self._rng_violation(dotted, node)
                if msg is not None:
                    yield node.lineno, msg
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    if (node.module, alias.name) in self._WALLCLOCK_IMPORTS:
                        yield node.lineno, (
                            f"'from {node.module} import {alias.name}' "
                            f"pulls a wall-clock surface into a "
                            f"modeled-time subsystem")


class NoMutableDefault(Rule):
    name = "no-mutable-default"
    description = ("mutable literal as a function/dataclass default "
                   "aliases one instance across calls")

    _MUTABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                ast.SetComp)

    def _defaults(self, fn) -> Iterator[ast.AST]:
        args = fn.args
        yield from (d for d in args.defaults if d is not None)
        yield from (d for d in args.kw_defaults if d is not None)

    def _is_dataclass(self, cls: ast.ClassDef) -> bool:
        for dec in cls.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = _call_name(target) or ""
            if name.split(".")[-1] == "dataclass":
                return True
        return False

    def check(self, tree, path, source):
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for d in self._defaults(node):
                    if isinstance(d, self._MUTABLE):
                        yield d.lineno, (
                            f"mutable default in {node.name}() is shared "
                            f"across calls — default to None (or a "
                            f"dataclasses.field factory)")
            elif isinstance(node, ast.ClassDef) and self._is_dataclass(node):
                for stmt in node.body:
                    value = None
                    if isinstance(stmt, ast.AnnAssign):
                        value = stmt.value
                    elif isinstance(stmt, ast.Assign):
                        value = stmt.value
                    if isinstance(value, self._MUTABLE):
                        yield value.lineno, (
                            f"mutable default on dataclass {node.name} "
                            f"field — use dataclasses.field("
                            f"default_factory=...)")


class NoUnorderedIteration(Rule):
    name = "no-unordered-iteration"
    description = ("dict/set enumeration order must not feed scheduling "
                   "decisions — sort it, seam it, or prove it "
                   "order-insensitive")

    # the decision paths whose enumeration order picks winners: event
    # draining / DRF admission, water-filling / victim selection, and
    # in-flight flow re-rating
    _FILES = ("pool/scheduler.py", "serve/arbiter.py",
              "fabric/transport.py", "disagg/router.py")
    _VIEWS = {"items", "values", "keys"}
    # wrappers that make enumeration order canonical (sorted) or
    # deliberately perturbed (the repro_torch.analysis.tiebreak seam)
    _SAFE_CALLS = {"sorted"}
    _SEAM_ATTR = "order"

    def applies_to(self, path: Path) -> bool:
        p = str(path)
        return any(p.endswith(f) for f in self._FILES)

    def _iter_violation(self, it: ast.AST) -> Optional[str]:
        if isinstance(it, ast.Call):
            fn = it.func
            if isinstance(fn, ast.Name) and fn.id in self._SAFE_CALLS:
                return None
            if isinstance(fn, ast.Attribute) \
                    and fn.attr == self._SEAM_ATTR:
                return None         # tiebreak.order(...) racecheck seam
            if isinstance(fn, ast.Attribute) and fn.attr in self._VIEWS:
                return (f"iteration over .{fn.attr}() exposes dict "
                        f"insertion order to a scheduling decision — "
                        f"wrap in sorted(...) or tiebreak.order(...), "
                        f"or annotate a proof of order-insensitivity")
            if isinstance(fn, ast.Name) and fn.id in ("set", "frozenset"):
                return ("iteration over a set exposes hash order — "
                        "wrap in sorted(...)")
        if isinstance(it, (ast.Set, ast.SetComp)):
            return ("iteration over a set display exposes hash order — "
                    "wrap in sorted(...)")
        return None

    def check(self, tree, path, source):
        # a comprehension fed DIRECTLY to sorted(...) is canonicalized
        # by construction — its internal enumeration order cannot leak
        sanctioned = {
            id(arg)
            for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in self._SAFE_CALLS
            for arg in node.args
            if isinstance(arg, (ast.ListComp, ast.SetComp,
                                ast.GeneratorExp))
        }
        for node in ast.walk(tree):
            iters: List[ast.AST] = []
            if isinstance(node, ast.For):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                if id(node) in sanctioned:
                    continue
                iters.extend(g.iter for g in node.generators)
            for it in iters:
                msg = self._iter_violation(it)
                if msg is not None:
                    yield it.lineno, msg


class NoFloatEquality(Rule):
    name = "no-float-equality"
    description = ("== / != on modeled-time values — accumulated floats "
                   "are association-sensitive; compare with a tolerance "
                   "or annotate the identity-test exceptions")

    # modeled-time subsystems (obs excluded: it never *computes* times,
    # only records them)
    _DIRS = ("serve", "fabric", "pool", "colo", "disagg")
    # identifier heuristics for "this is a modeled-time value"
    _EXACT = {"t", "ts", "dt", "now", "t0", "t1", "t_req", "t_eff",
              "before", "clock", "horizon", "deadline"}
    _SUBSTR = ("time", "clock", "deadline", "arrival", "completion",
               "latency", "horizon")
    _SUFFIXES = ("_s", "_t", "_ts")

    def applies_to(self, path: Path) -> bool:
        parts = set(path.parts)
        return _PKG in parts and bool(parts & set(self._DIRS))

    def _timeish(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Attribute):
            ident = node.attr
        elif isinstance(node, ast.Name):
            ident = node.id
        else:
            return None
        low = ident.lower()
        if low in self._EXACT or low.endswith(self._SUFFIXES) \
                or any(s in low for s in self._SUBSTR):
            return ident
        return None

    def check(self, tree, path, source):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Compare):
                continue
            if not any(isinstance(op, (ast.Eq, ast.NotEq))
                       for op in node.ops):
                continue
            for operand in [node.left, *node.comparators]:
                ident = self._timeish(operand)
                if ident is not None:
                    yield node.lineno, (
                        f"float equality against modeled-time value "
                        f"{ident!r} — accumulated clocks differ in the "
                        f"last ulp across association orders; compare "
                        f"with a tolerance (or annotate an identity "
                        f"test of one stored float)")
                    break


RULES: Tuple[Rule, ...] = (NoBarePrint(), NoWallclock(), NoMutableDefault(),
                           NoUnorderedIteration(), NoFloatEquality())


def iter_py_files(roots: Sequence[Path]) -> Iterator[Path]:
    for root in roots:
        if root.is_file():
            yield root
        else:
            yield from sorted(root.rglob("*.py"))


def lint_file(path: Path, rules: Iterable[Rule] = RULES
              ) -> List[LintViolation]:
    """All un-suppressed violations in one file."""
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as err:
        return [LintViolation("syntax", str(path), err.lineno or 0,
                              f"does not parse: {err.msg}")]
    allowed = suppressed_lines(source)
    out: List[LintViolation] = []
    for rule in rules:
        if not rule.applies_to(path):
            continue
        for line, message in rule.check(tree, path, source):
            if rule.name in allowed.get(line, ()):
                continue
            out.append(LintViolation(rule.name, str(path), line, message))
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def lint_paths(paths: Sequence[Path], rules: Iterable[Rule] = RULES
               ) -> List[LintViolation]:
    out: List[LintViolation] = []
    for f in iter_py_files([Path(p) for p in paths]):
        out.extend(lint_file(f, rules))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: lint the given trees (default ``src/repro_torch``); exit 1 on
    any un-annotated violation."""
    import argparse

    from repro_torch.obs.console import emit, warn

    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.lints",
        description="AST lint rules guarding modeled-time determinism")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    metavar="PATH", help="files or trees to lint")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="NAME", dest="rules",
                    help="run only the named rule (repeatable)")
    ap.add_argument("--list-rules", action="store_true",
                    help="list available rules and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule in RULES:
            emit(f"{rule.name:20s} {rule.description}")
        return 0
    rules: Iterable[Rule] = RULES
    if args.rules:
        by_name = {r.name: r for r in RULES}
        unknown = [n for n in args.rules if n not in by_name]
        if unknown:
            warn(f"unknown rule(s): {', '.join(unknown)} "
                 f"(have: {', '.join(by_name)})")
            return 2
        rules = tuple(by_name[n] for n in args.rules)
    violations = lint_paths([Path(p) for p in args.paths], rules)
    for v in violations:
        emit(v.format())
    names = ", ".join(r.name for r in rules)
    where = ", ".join(str(p) for p in args.paths)
    if violations:
        warn(f"{len(violations)} lint violation(s) over {where} "
             f"[{names}] — annotate justified lines with "
             f"'# repro: allow(<rule>) <reason>'")
        return 1
    import sys
    emit(f"repro_torch.analysis.lints: clean ({where}) [{names}]",
         stream=sys.stderr)
    return 0
