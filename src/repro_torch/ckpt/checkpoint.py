"""Checkpoint/restart without external dependencies (port of
``repro.ckpt.checkpoint``), in the reference's on-disk format:

  * one ``.npy`` file per leaf, named by its leaf path
    (``<path with / as __>.p<process>.s0.npy``), and a manifest
    ``manifest.p<process>.json`` recording the step, the extra state
    (the data pipeline's), and per leaf its global shape, dtype and the
    file's shape and checksum (sha256 of the array's bytes, 16 hex);
  * leaf names and shapes are the reference's: the port's per-layer
    lists are stacked back into the reference's ``(L, ...)`` leaves
    (``repro_torch.tree.leaf_groups``), and split again on restore;
  * commit is atomic: write to ``<dir>.tmp<process>``, fsync the
    manifest, rename;
  * async save: the snapshot (device -> host copy) is taken
    synchronously, serialization runs on a background thread.

fp32 (and integer) leaves are interchangeable with the reference's both
ways, with equal checksums.  bf16 leaves are written as their uint16
bits under the dtype name ``bfloat16`` and restore port to port bit for
bit, without ``ml_dtypes``; a bf16 leaf across the two packages is not
supported (the reference writes numpy's ``ml_dtypes`` bfloat16).  The
port runs on one process: every leaf is one whole shard, whose index the
manifest records as null; restore also reads the reference's sliced
shards.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaf_groups, rebuild

_BF16 = "bfloat16"


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _snapshot(leaves: List[Any], lead: Tuple[int, ...]
              ) -> Tuple[np.ndarray, str]:
    """The port's tensors of one reference leaf -> (host array, dtype
    name), stacked into the ``lead`` axes when they are a layer list."""
    ts = [torch.as_tensor(t).detach() for t in leaves]
    t = ts[0] if not lead else torch.stack(ts).reshape(
        lead + tuple(ts[0].shape))
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), _BF16
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str | os.PathLike, tree, *, step: int,
         extra: Optional[Dict[str, Any]] = None, process_index: int = 0,
         asynchronous: bool = False) -> "SaveHandle":
    """Save a tree of tensors.  Returns a handle; ``handle.wait()`` blocks
    until the checkpoint is committed."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir.with_name(ckpt_dir.name + f".tmp{process_index}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    # snapshot: device -> host, synchronously (training may then continue)
    snapshot = [(name, *_snapshot(leaves, lead))
                for name, leaves, lead in leaf_groups(tree)]

    def commit():
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for name, arr, dtype in snapshot:
            fn = f"{name.replace('/', '__')}.p{process_index}.s0.npy"
            np.save(tmp / fn, arr)
            manifest["leaves"][name] = {
                "global_shape": list(arr.shape),
                "dtype": dtype,
                "shards": [{"file": fn, "index": None,
                            "checksum": _checksum(arr),
                            "shape": list(arr.shape)}],
            }
        with open(tmp / f"manifest.p{process_index}.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # atomic publish
        if ckpt_dir.exists():
            shutil.rmtree(ckpt_dir)
        os.replace(tmp, ckpt_dir)

    handle = SaveHandle()
    if asynchronous:
        t = threading.Thread(target=lambda: handle._run(commit), daemon=True)
        t.start()
        handle._thread = t
    else:
        handle._run(commit)
    return handle


class SaveHandle:
    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.done = False

    def _run(self, fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001
            self.error = e
        finally:
            self.done = True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        if self.error is not None:
            raise self.error
        return self


def load_manifest(ckpt_dir: str | os.PathLike,
                  process_index: int = 0) -> Dict:
    with open(Path(ckpt_dir) / f"manifest.p{process_index}.json") as f:
        return json.load(f)


def _read_leaf(ckpt_dir: Path, meta: Dict, validate: bool) -> np.ndarray:
    bf16 = meta["dtype"] == _BF16
    full = np.zeros(meta["global_shape"],
                    dtype=np.uint16 if bf16 else np.dtype(meta["dtype"]))
    for e in meta["shards"]:
        arr = np.load(ckpt_dir / e["file"])
        if validate and _checksum(arr) != e["checksum"]:
            raise IOError(f"checksum mismatch in {e['file']}")
        if e["index"] is None:
            full = arr
        else:
            full[tuple(slice(a, b, c) for a, b, c in e["index"])] = arr
    return full


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == _BF16:
        arr = arr.view(np.int16)
    t = torch.from_numpy(np.array(arr))      # a copy; 0-d stays 0-d
    return t.view(torch.bfloat16) if dtype_name == _BF16 else t


def restore(ckpt_dir: str | os.PathLike, target_tree, *,
            process_index: int = 0, validate: bool = True
            ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree`` (its values give
    only each leaf's dtype and device).  Returns ``(tree, {"step": ...,
    **extra})``.  Raises on a checksum mismatch or a missing leaf."""
    ckpt_dir = Path(ckpt_dir)
    manifest = load_manifest(ckpt_dir, process_index)
    supply = {}
    for name, leaves, lead in leaf_groups(target_tree):
        if name not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {name}")
        meta = manifest["leaves"][name]
        full = _to_tensor(_read_leaf(ckpt_dir, meta, validate), meta["dtype"])
        parts = [full] if not lead else \
            list(full.reshape((len(leaves),) + tuple(leaves[0].shape)))
        supply[name] = iter([p.to(dtype=t.dtype, device=t.device)
                             for p, t in zip(parts, leaves)])
    tree = rebuild(target_tree, supply)
    return tree, {"step": manifest["step"], **manifest.get("extra", {})}
