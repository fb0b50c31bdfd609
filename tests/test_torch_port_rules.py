"""Rules of the port: ``repro_torch`` and ``chip_smoke.py`` import neither
JAX nor the reference package, and no entry point runs on the CPU
unless the caller asks for it by name."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_and_repro_blocked():
    code = "\n".join([
        "import sys, importlib, importlib.util",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        f"sys.path.insert(0, {str(ROOT / 'src')!r})",
        *[f"importlib.import_module({m!r})" for m in _module_names()],
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})",
        "mod = importlib.util.module_from_spec(spec)",
        "spec.loader.exec_module(mod)",
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]",
        "print('ok')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (
                f"{path}:{node.lineno} imports {name}")


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import main
    from repro_torch.models import transformer
    from repro_torch.models.api import build_model
    from repro_torch.serve import Engine

    cfg = get_config("qwen1.5-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_params(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine.local(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--smoke", "--requests", "1"])
    assert resolve_device("cpu").type == "cpu"


def test_the_pool_slice_modules_are_checked():
    """The multi-tenant and pool modules are among those imported with
    JAX and the reference blocked, and whose sources are scanned."""
    names = set(_module_names())
    slice_modules = {
        "repro_torch.serve.arbiter", "repro_torch.serve.trace",
        "repro_torch.pool", "repro_torch.pool.inventory",
        "repro_torch.pool.allocator", "repro_torch.pool.lease",
        "repro_torch.ckpt", "repro_torch.ckpt.elastic",
        "repro_torch.core.fabric", "repro_torch.fabric.topology",
        "repro_torch.runtime.serve", "repro_torch.launch.serve"}
    assert slice_modules <= names, sorted(slice_modules - names)
    files = {p.relative_to(PKG).as_posix() for p in FILES if PKG in p.parents}
    assert {"serve/arbiter.py", "pool/lease.py", "pool/allocator.py",
            "pool/inventory.py", "ckpt/elastic.py"} <= files


def test_lease_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.pool import smoke_pool
    from repro_torch.runtime.serve import make_lease_session
    from repro_torch.serve import Engine, PoolArbiter

    model = build_model(get_config("qwen1.5-0.5b", smoke=True),
                        device="cpu")
    lease = smoke_pool().lease("svc", 4, tier2_gb=8, kv_gb=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        lease.materialize()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine.from_lease(model, lease)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine.local(model, arbiter=PoolArbiter(4), tenant="a")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_lease_session(model, ShapeConfig("s", "decode", 32, 2), lease)
    for extra in (["--tenants", "2"], ["--pool", "scalepool",
                                        "--tier2-kv-gb", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--smoke", "--requests", "2"] + extra)


def test_non_dense_families_are_not_served_yet():
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    with pytest.raises(NotImplementedError):
        build_model(get_config("mixtral-8x7b", smoke=True), device="cpu")


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_cli_serves_on_the_cpu_when_asked(capsys):
    import json
    from repro_torch.launch.serve import main
    rc = main(["--smoke", "--requests", "3", "--max-new", "4", "--slots",
               "2", "--max-seq", "96", "--tier1-pages", "4",
               "--tier2-kv-gb", "1", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["requests"] == 3 and out["device"] == "cpu"
    assert out["stats"]["completed"] == 3


def test_cli_fixed_batch_mode_on_the_cpu(capsys):
    """With no --requests the CLI runs the fixed-batch mode, as the
    reference's does, for a family without paged KV too."""
    import json
    from repro_torch.launch.serve import main
    rc = main(["--arch", "mamba2-780m", "--smoke", "--batch", "2",
               "--prompt", "16", "--generate", "4", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["mode"] == "batch" and out["device"] == "cpu"
    assert out["generated"] == 4 and out["batch"] == 2
    assert all(0 <= t < 256 for t in out["sample_tokens"])


def test_cli_engine_refuses_families_without_paged_kv(capsys):
    from repro_torch.launch.serve import main
    rc = main(["--arch", "mamba2-780m", "--smoke", "--requests", "1",
               "--device", "cpu"])
    assert rc == 2 and "paged-KV" in capsys.readouterr().err


def test_cli_fixed_batch_mode_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "mamba2-780m", "--smoke", "--batch", "2",
              "--prompt", "16", "--generate", "4"])


def test_every_cuda_source_is_built_and_every_kernel_names_its_source():
    """Each ``csrc/*.cu`` is compiled (listed in ``_build.SOURCES``, so
    nvcc builds it in parallel with the others), and each kernel
    module's ``SOURCE`` (and, for the flash and SSD wrappers, which
    choose between two kernels, ``SOURCE_F32``) names a file of the repo
    that is one of them; every source is some wrapper's, and each C
    entry point is found in the sources."""
    from repro_torch.kernels import WRAPPERS, _build
    on_disk = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert sorted(_build.SOURCES) == on_disk
    named = [getattr(mod, attr) for mod in WRAPPERS.values()
             for attr in ("SOURCE", "SOURCE_F32") if hasattr(mod, attr)]
    assert len(named) == len(WRAPPERS) + 2
    assert sorted(Path(src).name for src in named) == on_disk
    assert "ssd_scan_tc.cu" in on_disk
    for src in named:
        assert (ROOT / src).is_file(), src
        assert Path(src).name in _build.SOURCES, src
    text = "".join((PKG / "csrc" / n).read_text() for n in on_disk)
    for entry in _build.SIGNATURES:
        assert f'extern "C" int {entry}(' in text, entry
