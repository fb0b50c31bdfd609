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
supported (the reference writes numpy's ``ml_dtypes`` bfloat16).

One process writes every leaf as one whole shard, whose index the
manifest records as null.  On a rank grid whose rules shard the tree
(``save(..., mesh=, rules=, axes=)``: tensor parallelism, FSDP) every
rank takes part: each rank sends rank 0 the blocks of which it holds the
first replica (the reference's ``replica_id == 0``), and rank 0 writes
each distinct block once with its ``index``, ``[[start, stop, step],
...]`` per dimension, in one ``manifest.p0.json``: the reference's
sharded format.  ``restore``
reads any such checkpoint (the reference's from a sharded mesh, the
port's from any layout, or whole leaves) and, given a grid, rules and
axes, keeps the restoring rank's block of each leaf, reading only the
shards that meet it.
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

from repro_torch.sharding import partition
from repro_torch.tree import leaf_groups, rebuild

_BF16 = "bfloat16"


def _checksum(arr: np.ndarray) -> str:
    # hashed through the array's buffer: no copy of its bytes
    return hashlib.sha256(np.ascontiguousarray(arr)).hexdigest()[:16]


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


def _leaf_blocks(tree, mesh, rules, axes) -> Optional[Dict[str, Any]]:
    """{leaf name: this rank's ``Block``} where the rules shard ``tree``
    on the grid ``mesh``, else None."""
    if mesh is None or rules is None or axes is None:
        return None
    named = dict(partition.named_axes(axes))
    blocks = {name: partition.logical_to_sharding(mesh, rules, named[name])
              for name, _, _ in leaf_groups(tree)}
    return None if all(b.whole for b in blocks.values()) else blocks


def _replica_zero_leaves(mesh, rules, named, names, rank: int) -> List[str]:
    """The leaves of ``names`` (in order) whose block the rank ``rank``
    writes: those of which it holds the first replica."""
    coords = mesh.layout.coords(rank)
    return [n for n in names if partition.replica_zero(
        partition.block_of(mesh.layout, coords, rules, named[n]), coords)]


def _gather_blocks(snapshot, mesh, rules, named
                   ) -> Optional[Dict[int, Dict[str, np.ndarray]]]:
    """``{rank: {leaf name: array}}`` on rank 0, None on the others: each
    other rank sends its ``snapshot`` (the blocks of which it holds the
    first replica, laid end to end as bytes) to rank 0, so each distinct
    block crosses once.  Rank 0's snapshot holds every leaf (its
    coordinates are all 0), which gives the others' shapes."""
    import torch.distributed as dist
    if mesh.rank != 0:
        if snapshot:
            buf = torch.from_numpy(np.concatenate(
                [np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
                 for _, arr, _ in snapshot]))
            if mesh.backend == "nccl":
                buf = buf.to(mesh.device)
            dist.send(buf, dst=0)
        return None
    arrays = {name: arr for name, arr, _ in snapshot}
    out = {0: arrays}
    for r in range(1, mesh.world):
        leaves = _replica_zero_leaves(mesh, rules, named, list(arrays), r)
        if not leaves:
            continue
        buf = torch.empty(sum(arrays[n].nbytes for n in leaves),
                          dtype=torch.uint8)
        if mesh.backend == "nccl":
            buf = buf.to(mesh.device)
        dist.recv(buf, src=r)
        host, at, got = buf.cpu().numpy(), 0, {}
        for n in leaves:
            a = arrays[n]
            got[n] = host[at:at + a.nbytes].view(a.dtype).reshape(a.shape)
            at += a.nbytes
        out[r] = got
    return out


def save(ckpt_dir: str | os.PathLike, tree, *, step: int,
         extra: Optional[Dict[str, Any]] = None, process_index: int = 0,
         asynchronous: bool = False, mesh=None, rules=None,
         axes=None) -> "SaveHandle":
    """Save a tree of tensors.  Returns a handle; ``handle.wait()`` blocks
    until the checkpoint is committed.

    ``mesh``, ``rules``, ``axes`` (the tree's logical axes): on a grid
    whose rules shard the tree the leaves are this rank's blocks, every
    rank calls ``save`` after the same step, and rank 0 writes them all;
    elsewhere on a grid rank 0 alone writes its whole leaves and the
    other ranks' handles are done at once."""
    ckpt_dir = Path(ckpt_dir)
    handle = SaveHandle()
    blocks = _leaf_blocks(tree, mesh, rules, axes)
    if blocks is None and mesh is not None and mesh.rank != 0:
        handle.done = True      # rank 0 writes its whole leaves
        return handle
    groups = list(leaf_groups(tree))
    leads = {name: lead for name, _, lead in groups}
    named = None if blocks is None else _named_axes(axes)
    mine = None if blocks is None else set(_replica_zero_leaves(
        mesh, rules, named, list(blocks), mesh.rank))
    # snapshot: device -> host, synchronously (training may then
    # continue), of the blocks this rank writes
    snapshot = [(name, *_snapshot(leaves, lead))
                for name, leaves, lead in groups
                if mine is None or name in mine]
    ranks = None
    if blocks is not None:
        ranks = _gather_blocks(snapshot, mesh, rules, named)
    if mesh is not None and mesh.rank != 0:
        handle.done = True
        return handle
    tmp = ckpt_dir.with_name(ckpt_dir.name + f".tmp{process_index}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    def entries(name: str, arr: np.ndarray):
        """(global shape, [(index, array)]) of leaf ``name``."""
        if ranks is None:
            return list(arr.shape), [(None, arr)]
        lead = leads[name]
        b = blocks[name]
        shape = [n * c for n, (_, c) in zip(arr.shape[len(lead):], b.parts)]
        out = []
        for r in sorted(ranks):
            if name in ranks[r]:
                rb = partition.block_of(mesh.layout, mesh.layout.coords(r),
                                        rules, named[name])
                out.append(([[None, None, None]] * len(lead)
                            + rb.index(shape), ranks[r][name]))
        return list(lead) + shape, out

    def commit():
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for name, arr, dtype in snapshot:
            shape, shards = entries(name, arr)
            safe_ = name.replace("/", "__")
            listed = []
            for i, (index, a) in enumerate(shards):
                fn = f"{safe_}.p{process_index}.s{i}.npy"
                np.save(tmp / fn, a)
                listed.append({"file": fn, "index": index,
                               "checksum": _checksum(a),
                               "shape": list(a.shape)})
            manifest["leaves"][name] = {"global_shape": shape,
                                        "dtype": dtype, "shards": listed}
        with open(tmp / f"manifest.p{process_index}.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # atomic publish
        if ckpt_dir.exists():
            shutil.rmtree(ckpt_dir)
        os.replace(tmp, ckpt_dir)

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


def _meets(index, want) -> bool:
    """Whether a shard's manifest ``index`` meets the slices ``want`` of
    the leaf's last dimensions."""
    for (a, b, _), s in zip(index[len(index) - len(want):], want):
        if (a is not None and a >= s.stop) or (b is not None and b <= s.start):
            return False
    return True


def _read_leaf(ckpt_dir: Path, meta: Dict, validate: bool,
               want=None) -> np.ndarray:
    """The leaf's full array; with ``want`` (slices of its last
    dimensions) only the shards that meet them are read, the rest left
    zero."""
    bf16 = meta["dtype"] == _BF16
    full = np.zeros(meta["global_shape"],
                    dtype=np.uint16 if bf16 else np.dtype(meta["dtype"]))
    for e in meta["shards"]:
        if want is not None and e["index"] is not None and not _meets(
                e["index"], want):
            continue
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


def _named_axes(axes) -> Dict[str, Any]:
    return dict(partition.named_axes(axes))


def restore(ckpt_dir: str | os.PathLike, target_tree, *,
            process_index: int = 0, validate: bool = True, mesh=None,
            rules=None, axes=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree`` (its values give
    only each leaf's dtype and device).  Returns ``(tree, {"step": ...,
    **extra})``.  Raises on a checksum mismatch or a missing leaf.
    ``mesh``, ``rules``, ``axes``: each leaf is cut to the restoring
    rank's block (``partition.shard_leaf``), whatever layout wrote it."""
    ckpt_dir = Path(ckpt_dir)
    manifest = load_manifest(ckpt_dir, process_index)
    named = _named_axes(axes) if axes is not None else None
    supply = {}
    for name, leaves, lead in leaf_groups(target_tree):
        if name not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {name}")
        meta = manifest["leaves"][name]
        block = want = None
        if named is not None and mesh is not None and rules is not None:
            block = partition.logical_to_sharding(mesh, rules, named[name])
            if not block.whole:
                want = block.slices(meta["global_shape"][len(lead):])
        full = _to_tensor(_read_leaf(ckpt_dir, meta, validate, want),
                          meta["dtype"])
        parts = [full] if not lead else \
            list(full.reshape((len(leaves),) + tuple(full.shape[len(lead):])))
        if block is not None:
            parts = [partition.shard_leaf(p, block) for p in parts]
        supply[name] = iter([p.to(dtype=t.dtype, device=t.device)
                             for p, t in zip(parts, leaves)])
    tree = rebuild(target_tree, supply)
    return tree, {"step": manifest["step"], **manifest.get("extra", {})}
