"""Build and load the port's CUDA kernels.

Every ``repro_torch/csrc/*.cu`` source is compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with ``ctypes``.  No PyTorch headers are included, so a build
takes seconds, not minutes.  The library lands in
``<checkout>/build/repro_torch/<hash>/`` keyed by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one is reused.
The sources compile in parallel, one ``nvcc`` each (a source in
``PARTS`` one a part), and are linked in one more step; ``build.log``
there holds nvcc's ``-Xptxas -v`` report for each and the seconds by
which it had finished (waited on in ``SOURCES`` order).

Nothing here runs at import time: the first kernel launch builds.  A
failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("paged_attention.cu", "flash_attention.cu",
           "flash_attention_tc.cu", "flash_attention_bwd.cu",
           "flash_attention_bwd_tc.cu", "rmsnorm.cu", "rmsnorm_bwd.cu",
           "ssd_scan.cu", "ssd_scan_tc.cu", "ssd_scan_bwd.cu",
           "ssd_scan_bwd_tc.cu")
HEADERS = ("common.cuh", "wgmma.cuh", "mma_sync.cuh")
# sources compiled in parts, one nvcc a part with its defines, all
# started together: the fp32 flash kernel's six unrolled instantiations
# took 64 s in one nvcc on an H100 machine's 8 cores, the rest of the
# build under 26 s
PARTS = {"flash_attention.cu": tuple(f"-DREPRO_FLASH_PART={i}"
                                     for i in range(7))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FLASH = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
          _I, _P)
_FLASH_BWD = (_P,) * 10 + (_I,) * 6 + (_F,) + (_I,) * 5 + (_P,)
# C signature of every entry point: (argtypes) -> int (a cudaError_t)
SIGNATURES = {
    # q, k_pages, v_pages, page_table, lengths, out, ws_acc, ws_ml,
    # B, H, KV, D, ps, PMAX, sm_scale, window, q_dtype, kv_dtype, stream
    "paged_attention_fwd": (_P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    # q, k, v, out, lse (nullable), B, Sq, Skv, H, HKV, D, sm_scale,
    # causal, window, q_offset, kv_len, kv_dtype, stream (fp32 q: CUDA
    # cores; bf16 q: tensor cores)
    "flash_attention_fwd": _FLASH,
    "flash_attention_tc_fwd": _FLASH,
    # q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, HKV, D,
    # sm_scale, causal, window, q_offset, kv_len, dtype, stream (fp32: CUDA
    # cores; bf16: tensor cores)
    "flash_attention_bwd": _FLASH_BWD,
    "flash_attention_tc_bwd": _FLASH_BWD,
    # x, scale, out, rows, d, eps, x_dtype, scale_dtype, vec, stream
    "rmsnorm_fwd": (_P, _P, _P, _I, _I, _F, _I, _I, _I, _P),
    # x, scale, dy, dx, dscale, partial, rows, d, eps, x_dtype,
    # scale_dtype, blocks, stream
    "rmsnorm_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P),
    # x, dt, A, B, C, D, h0 (nullable), y, h_out,
    # B, S, H, G, P, N, Q, stream (fp32 x, B, C: CUDA cores)
    "ssd_scan_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _P),
    # ... the same (bf16 x, B, C: tensor cores)
    "ssd_scan_tc_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _P),
    # x, dt, A, B, C, D, h0 (nullable), dy, dh_T (nullable), dx, ddt, dA,
    # dD, dB, dC, states, dstates, pB, pC, pAD, B, S, H, G, P, N, Qb,
    # dtype, stream (fp32: CUDA cores)
    "ssd_scan_bwd": (_P,) * 20 + (_I,) * 8 + (_P,),
    # x, dt, A, B, C, D, h0 (nullable), dy, dh_T (nullable), dx, ddt, dA,
    # dD, dB, dC, dh0 (nullable), hs, gs, pB, pC, pAD, B, S, H, G, P, N,
    # Qb, run, stream (bf16: tensor cores)
    "ssd_scan_tc_bwd": (_P,) * 21 + (_I,) * 8 + (_P,),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """``nvcc`` failed or is missing."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise KernelBuildError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that matches this PyTorch build")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(PARTS.items())).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile the sources (one parallel ``nvcc`` each) and link them
    into ``librepro_torch.so``; returns its path.  Reuses an existing
    library built from the same sources unless ``force``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "librepro_torch.so"
    if lib.exists() and not force:
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    t0 = time.perf_counter()
    for name in SOURCES:
        for i, define in enumerate(PARTS.get(name, (None,))):
            obj = tmp / f"{Path(name).stem}.{i}.o"
            cmd = [nvcc, *NVCC_FLAGS, *([define] if define else []), "-I",
                   str(CSRC), "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((f"{name} {define}" if define else name, obj,
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs = []
    for name, obj, proc in procs:
        log, _ = proc.communicate()
        logs.append(f"== {name} (done by {time.perf_counter() - t0:.1f} s)"
                    f"\n{log}")
        if proc.returncode != 0:
            for _, _, other in procs:
                other.kill()
            raise KernelBuildError(f"nvcc failed on {name}:\n{log}")
    link = subprocess.run(
        [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp / lib.name),
         *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    (out_dir / "build.log").write_text("\n".join(logs))
    os.replace(tmp / lib.name, lib)
    shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on PyTorch's current stream and raise on a
    nonzero ``cudaGetLastError()`` (a refused launch never runs, and a
    later synchronise would not report it)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise KernelLaunchError(f"{name}: CUDA error {err}")


def needs_grad(*tensors) -> bool:
    """Whether autograd will want a gradient through a call on these
    tensors: grad mode is on and one of them requires a gradient."""
    import torch

    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# dtype codes shared with csrc/common.cuh
DTYPE_CODES: Dict[str, int] = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code
