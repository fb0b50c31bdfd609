"""The port's lint entry point (``repro_torch.analysis.lints``) against the
reference's rules, and the pool-signature fix those rules found.

``repro_torch.analysis.lints`` is a copy of ``repro.analysis.lints``
whose path scopes key on a part named ``repro_torch``; the reference's
``compat-imports`` rule (jax version drift) has no counterpart in the
port.  On the same snippet, placed under a ``repro_torch/`` path and
under a ``repro/`` path, the copy must flag exactly the lines the
reference flags, rule by rule, and both must leave the snippet alone
outside their scopes.  The port's own tree must be clean."""

import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lints as ref_lints                  # noqa: E402
from repro_torch.analysis import lints                          # noqa: E402
from repro_torch.serve import PoolArbiter                       # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_RULES = {r.name for r in lints.RULES}

# rule -> (path inside the package, source); every snippet has flagged
# lines, a line annotated with ``# repro: allow(...)`` and lines that pass
SNIPPETS = {
    "no-bare-print": ("models/shapes.py", '''\
def f(emit):
    print("x")
    print("y")  # repro: allow(no-bare-print) a test fixture
    emit("z")
    return print
'''),
    "no-wallclock": ("serve/clocks.py", '''\
import random
import time
from time import perf_counter

import numpy as np


def f():
    t = time.time()
    u = time.perf_counter()  # repro: allow(no-wallclock) host profiling
    r = random.random()
    g = np.random.default_rng()
    h = np.random.RandomState(0)
    np.random.seed(1)
    return t, u, r, g, h, perf_counter
'''),
    "no-mutable-default": ("pool/defaults.py", '''\
import dataclasses


def f(x=[], *, y={}, z=None, w=()):
    return x, y, z, w


def g(a={k: 1 for k in "ab"}):  # repro: allow(no-mutable-default) test
    return a


@dataclasses.dataclass
class C:
    a: list = []
    b: int = 0
    c: set = dataclasses.field(default_factory=set)
'''),
    "no-unordered-iteration": ("serve/arbiter.py", '''\
from repro_torch.analysis import tiebreak


def f(d, s):
    for k, v in d.items():
        pass
    xs = [v for v in d.values()]
    ys = sorted(v for v in d.values())
    for x in set(s):
        pass
    for x in {1, 2}:
        pass
    for k in tiebreak.order(d.keys()):
        pass
    n = sum(v for v in d.values())  # repro: allow(no-unordered-iteration) integer sum
    return xs, ys, n
'''),
    "no-float-equality": ("disagg/gates.py", '''\
def f(clock, dt, t0, n, req):
    if dt == 0.0:
        pass
    if clock != t0:
        pass
    if n == 3:
        pass
    if req.arrival_time == 1.0:  # repro: allow(no-float-equality) test
        pass
    return req.latency_s != clock
'''),
}


def _flagged(module, root: Path, pkg: str, rel: str, source: str):
    path = root / pkg / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return sorted((v.rule, v.line) for v in module.lint_file(path)
                  if v.rule in PORT_RULES)


@pytest.mark.parametrize("rule", sorted(SNIPPETS))
def test_copy_flags_what_the_reference_flags(tmp_path, rule):
    rel, source = SNIPPETS[rule]
    ref = _flagged(ref_lints, tmp_path / "a", "repro", rel, source)
    got = _flagged(lints, tmp_path / "b", "repro_torch", rel, source)
    assert got == ref
    assert any(r == rule for r, _ in got), got
    annotated = [i for i, line in enumerate(source.splitlines(), 1)
                 if "repro: allow" in line]
    assert annotated and not any(n in annotated for _, n in got)
    # outside the packages (or a scoped file's directory) both agree
    other = rel.replace(rel.split("/")[0], "models", 1)
    assert _flagged(lints, tmp_path / "c", "repro_torch", other, source) \
        == _flagged(ref_lints, tmp_path / "d", "repro", other, source)
    assert _flagged(lints, tmp_path / "e", "elsewhere", rel, source) == \
        _flagged(ref_lints, tmp_path / "f", "elsewhere", rel, source)


def test_scopes_key_on_the_port_package(tmp_path):
    """The path-scoped rules apply under ``repro_torch/`` and not under
    ``repro/``: each package's lints guard its own tree."""
    rel, source = SNIPPETS["no-wallclock"]
    assert not _flagged(lints, tmp_path / "a", "repro", rel, source)
    assert _flagged(lints, tmp_path / "b", "repro_torch", rel, source)
    assert "compat-imports" not in PORT_RULES
    assert PORT_RULES == {r.name for r in ref_lints.RULES} - {
        "compat-imports"}


def test_port_tree_is_clean(capsys):
    assert lints.lint_paths([ROOT / "src" / "repro_torch"]) == []
    assert lints.main([str(ROOT / "src" / "repro_torch")]) == 0
    assert "clean" in capsys.readouterr().err
    # every modeled-time package of the port is in scope
    scoped = {p.relative_to(ROOT / "src" / "repro_torch").parts[0]
              for p in (ROOT / "src" / "repro_torch").rglob("*.py")
              if lints.NoFloatEquality().applies_to(p)}
    assert {"serve", "fabric", "pool", "disagg"} <= scoped


def test_cli_lists_rules_and_fails_on_a_violation(tmp_path, capsys):
    assert lints.main(["--list-rules"]) == 0
    assert capsys.readouterr().out.count("\n") == len(lints.RULES)
    rel, source = SNIPPETS["no-float-equality"]
    path = tmp_path / "repro_torch" / rel
    path.parent.mkdir(parents=True)
    path.write_text(source)
    assert lints.main([str(path)]) == 1
    assert lints.main([str(path), "--rule", "no-bare-print"]) == 0
    assert lints.main([str(path), "--rule", "compat-imports"]) == 2


# ---------------------------------------------------------------------------
# the pool's leaf signature (the no-unordered-iteration finding)
# ---------------------------------------------------------------------------

def _slot_shapes(order, dtype=torch.float32, heads=2):
    shape = (2, 1, 64, heads, 16)
    return {name: torch.empty(shape, dtype=dtype, device="meta")
            for name in order}


def _fake_engine():
    return types.SimpleNamespace(cfg=types.SimpleNamespace(page_size=8),
                                 device=torch.device("cpu"))


def test_pool_signature_ignores_leaf_order():
    """A tenant whose cache lists the same leaves in another order serves
    the same layout and is admitted, as the reference's pytree walk
    (sorted dict keys) admits it; a real layout mismatch is refused."""
    jax = pytest.importorskip("jax")
    from repro.serve import PoolArbiter as RefArbiter

    arb = PoolArbiter(4, page_size=8)
    arb.register("a", _fake_engine(), slot_shapes=_slot_shapes("kv"),
                 page_bytes=1.0)
    arb.register("b", _fake_engine(), slot_shapes=_slot_shapes("vk"),
                 page_bytes=1.0)
    assert list(arb.pool) == ["k", "v"]
    assert arb.pool["k"].shape == (2, 5, 8, 2, 16)
    assert arb.tenants == ("a", "b")
    with pytest.raises(ValueError, match="cache geometry"):
        arb.register("c", _fake_engine(),
                     slot_shapes=_slot_shapes("vk", heads=4), page_bytes=1.0)
    with pytest.raises(ValueError, match="cache geometry"):
        arb.register("d", _fake_engine(),
                     slot_shapes=_slot_shapes("kv", torch.bfloat16),
                     page_bytes=1.0)

    def ref_shapes(order, heads=2):
        return {n: jax.ShapeDtypeStruct((2, 1, 64, heads, 16), "float32")
                for n in order}

    ref = RefArbiter(4, page_size=8)
    ref.register("a", _fake_engine(), slot_shapes=ref_shapes("kv"),
                 page_bytes=1.0)
    ref.register("b", _fake_engine(), slot_shapes=ref_shapes("vk"),
                 page_bytes=1.0)
    with pytest.raises(ValueError, match="cache geometry"):
        ref.register("c", _fake_engine(), slot_shapes=ref_shapes("vk", 4),
                     page_bytes=1.0)
