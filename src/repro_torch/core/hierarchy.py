"""Hierarchical (fabric-aware) collectives: ScalePool's communication
schedule on ``torch.distributed`` process groups (port of
``repro.core.hierarchy``).

The paper's section 4: bulk intra-cluster data movement stays on the
fast XLink fabric; only the reduced shard crosses the inter-cluster CXL
fabric.  On the port's rank grid (``repro_torch.launch.mesh``):

    phase 1: reduce-scatter over the intra-pod axis  ("data")
    phase 2: all-reduce across pods                  ("pod")
    phase 3: all-gather over the intra-pod axis      ("data")

Compared to one flat all-reduce over (pod x data), the cross-pod groups
carry 1/|data| of the bytes.  Optionally, phase 2 moves int8 codes with
a per-tensor scale shared across pods, and carries the quantization
error to the next step (error feedback).

The reference runs these inside ``shard_map`` on mesh axes; here each
process is one rank and passes its own tensor.  In the reference's
training step the mean over ``data`` inside a pod is GSPMD's; the port
does it explicitly (``reduce_gradients_hierarchically``), on one flat
buffer of the gradient tree: phase 1 leaves each rank a contiguous
shard, phase 2 runs on the shard, so the per-tensor scale is a max over
the whole world of the shards' maxima, the same number as the
reference's max over pods of each pod's whole tensor.

Every collective goes through ``_collective``, which stages it and
counts it.  With ``gloo`` and a tensor on a card it runs on a pinned
host copy (copied in, reduced, copied back); with ``nccl``, and for
CPU tensors, on the tensor itself.  gloo's CUDA support differs by op
and version: ``chip_smoke.py`` phase 11 probes it on the card, and
torch 2.11 (CUDA 12.8, an H100) took CUDA tensors for all seven ops it
tries (``all_reduce``, ``broadcast``, ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter``,
``reduce_scatter_tensor``, ``all_to_all_single``).  The port stages
every op all the same, so one rule holds whatever the version takes.
Under gloo an all-reduce of at most ``EXCHANGE_BYTES`` is an exchange
instead: each rank sends its tensor to every other rank of the group at
once and sums (or maxes) the group's tensors in rank order, the same
bits on every rank.  gloo's ring takes 2 (n - 1) dependent steps, each a
thread handoff; the exchange takes one but receives n - 1 whole tensors.
On an H100 host whose sockets run under gVisor
(``chip_tools/collective_latency.py``, staged from the card), 4 ranks:
the exchange 2.1 ms against the ring's 7.8 at 16 KB, 3.4 against 7.3 at
512 KB, 16.1 against 8.0 at 1 MiB; 2 ranks: the exchange ahead up to 1
MiB, behind from 2 MiB.  Larger tensors, and every op under nccl, take
the backend's own collective.
Each call adds its ring-accounted bytes (the reference's
``repro.launch.hlo_analysis.moved_bytes``, whatever the algorithm) and
its host seconds to the grid's ``stats``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import RankGrid
from repro_torch.tree import leaf_groups, rebuild

# torch renamed the tensor forms of reduce-scatter and all-gather; both
# names take (output, input, ...)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def moved_bytes(kind: str, result_bytes: int, n: int) -> float:
    """Per-rank wire bytes under ring algorithms (``result_bytes``: the
    op's result on one rank)."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * frac * result_bytes
    if kind == "all-gather":
        return frac * result_bytes            # result is the gathered buffer
    if kind == "reduce-scatter":
        return frac * result_bytes * n        # result is the scattered shard
    raise ValueError(f"unknown collective {kind!r}")


# at or under this many bytes a gloo all-reduce is an exchange: the
# largest size at which it beat gloo's ring over both 2 and 4 ranks
EXCHANGE_BYTES = 512 << 10


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _exchange_reduce(out: torch.Tensor, inp: torch.Tensor, group,
                     op: str) -> None:
    """``out`` = the sum (or max) of the group's ``inp`` in rank order:
    every rank sends its tensor to every other and receives theirs, all
    at once."""
    me = dist.get_rank()
    ranks = dist.get_process_group_ranks(group)
    parts, ops = [], []
    for r in ranks:
        if r == me:
            parts.append(inp)
            continue
        buf = torch.empty_like(inp)
        parts.append(buf)
        ops.append(dist.P2POp(dist.isend, inp, r, group))
        ops.append(dist.P2POp(dist.irecv, buf, r, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    acc = parts[0].clone()
    for part in parts[1:]:
        if op == "sum":
            acc += part
        else:
            torch.maximum(acc, part, out=acc)
    out.copy_(acc)


def _collective(grid: RankGrid, axes: Tuple[str, ...], kind: str, out,
                inp, run, what: str = "") -> None:
    """``run(out, inp, group)`` over the group of ``axes``, staged on
    pinned host copies when ``grid.stages_on_host`` (gloo, tensors on a
    card), else on the tensors themselves; counted in ``grid.stats``
    under ``kind``, or ``kind:what`` where the caller names what it
    moves (the moe layer's, ``sharding.tp``)."""
    group = grid.group(axes)
    n = grid.size(axes)
    if grid.stages_on_host:
        # the copy in waits for the work queued before it: wait first, so
        # the seconds counted are the collective's own
        torch.cuda.current_stream(grid.device).synchronize()
    t0 = time.perf_counter()
    if grid.stages_on_host:
        h_in = _host(inp)
        h_out = h_in if out is inp else torch.empty(
            out.shape, dtype=out.dtype, pin_memory=True)
        run(h_out, h_in, group)
        out.copy_(h_out)
    else:
        run(out, inp, group)
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
    grid.stats.add(tuple(a for a in grid.axis_names
                         if a in axes and grid.layout.axis_size(a) > 1),
                   f"{kind}:{what}" if what else kind,
                   moved_bytes(kind, _nbytes(out), n),
                   time.perf_counter() - t0)


def all_reduce(t: torch.Tensor, grid: RankGrid, axes: Tuple[str, ...],
               op: str = "sum", what: str = "") -> torch.Tensor:
    """In place: ``t`` becomes its sum (or ``"max"``) over the group."""
    if grid.group(axes) is None:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if grid.backend == "gloo" and _nbytes(t) <= EXCHANGE_BYTES:
        _collective(grid, axes, "all-reduce", t, t,
                    lambda o, i, g: _exchange_reduce(o, i, g, op), what)
    else:
        _collective(grid, axes, "all-reduce", t, t,
                    lambda o, i, g: dist.all_reduce(o, op=red, group=g),
                    what)
    return t


def reduce_scatter(x: torch.Tensor, grid: RankGrid,
                   axes: Tuple[str, ...], what: str = "") -> torch.Tensor:
    """The sum over the group of ``x`` (1-D, its length a multiple of the
    group's size), scattered: this rank's chunk, by its index."""
    n = grid.size(axes)
    if grid.group(axes) is None:
        return x.clone()
    out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
    _collective(grid, axes, "reduce-scatter", out, x.contiguous(),
                lambda o, i, g: _REDUCE_SCATTER(o, i, group=g), what)
    return out


def all_gather(x: torch.Tensor, grid: RankGrid,
               axes: Tuple[str, ...], what: str = "") -> torch.Tensor:
    """The group's 1-D tensors concatenated in rank order."""
    n = grid.size(axes)
    if grid.group(axes) is None:
        return x.clone()
    out = torch.empty(x.numel() * n, dtype=x.dtype, device=x.device)
    _collective(grid, axes, "all-gather", out, x.contiguous(),
                lambda o, i, g: _ALL_GATHER(o, i, group=g), what)
    return out


def all_gather_dim(x: torch.Tensor, grid: RankGrid, axes: Tuple[str, ...],
                   dim: int, what: str = "") -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    n = grid.size(axes)
    if grid.group(axes) is None:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = all_gather(front.reshape(-1), grid, axes, what)
    return out.reshape((n * front.shape[0],) + front.shape[1:]).movedim(
        0, dim)


def reduce_scatter_dim(x: torch.Tensor, grid: RankGrid,
                       axes: Tuple[str, ...], dim: int) -> torch.Tensor:
    """The sum over the group of ``x``, split along ``dim`` in rank
    order: this rank's part."""
    n = grid.size(axes)
    if grid.group(axes) is None:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = reduce_scatter(front.reshape(-1), grid, axes)
    return out.reshape((front.shape[0] // n,) + front.shape[1:]).movedim(
        0, dim)


# ---------------------------------------------------------------------------
# explicit collectives on flat buffers (benchmark + unit-test surface)
# ---------------------------------------------------------------------------

def flat_allreduce(x: torch.Tensor, grid: RankGrid,
                   axes: Tuple[str, ...]) -> torch.Tensor:
    """Baseline: one sum spanning all given grid axes (the 'RDMA-era'
    topology-oblivious collective).  Returns a new tensor."""
    return all_reduce(x.clone(), grid, axes)


def hierarchical_allreduce(x: torch.Tensor, grid: RankGrid, *,
                           intra_axis: str = "data",
                           inter_axis: str = "pod") -> torch.Tensor:
    """Two-level all-reduce: RS(intra) -> AR(inter) -> AG(intra).

    ``x``'s leading dim is a multiple of the intra group's size.  Equal
    to ``flat_allreduce`` over both axes (tested), but the inter-axis
    groups carry only 1/|intra| of the buffer."""
    shard = reduce_scatter(x.reshape(-1), grid, (intra_axis,))
    all_reduce(shard, grid, (inter_axis,))
    return all_gather(shard, grid, (intra_axis,)).reshape(x.shape)


# ---------------------------------------------------------------------------
# error-feedback int8 compression for the inter-pod phase
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_mean(xf: torch.Tensor, segments: Sequence[Tuple[int, int]],
                     grid: RankGrid, axis: str,
                     scale_axes: Tuple[str, ...]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 error-feedback mean over ``axis`` of the fp32 1-D ``xf``
    (the residual already added), a shared scale per segment ``(lo,
    hi)``: the max over ``scale_axes`` of each rank's max |x| over its
    part of the segment, / 127, + 1e-12.  Elements in no segment (a
    shard's padding) are zeros and stay so.  Returns (mean in fp32, new
    residual)."""
    maxes = torch.zeros(len(segments), dtype=torch.float32, device=xf.device)
    for k, (lo, hi) in enumerate(segments):
        if hi > lo:
            maxes[k] = torch.max(torch.abs(xf[lo:hi]))
    all_reduce(maxes, grid, scale_axes, op="max")
    scales = maxes / 127.0 + 1e-12
    q = torch.zeros(xf.shape, dtype=torch.int8, device=xf.device)
    residual = torch.zeros_like(xf)
    for k, (lo, hi) in enumerate(segments):
        if hi > lo:
            qk = torch.clamp(torch.round(xf[lo:hi] / scales[k]), -127, 127)
            q[lo:hi] = qk.to(torch.int8)
            residual[lo:hi] = xf[lo:hi] - qk * scales[k]
    # int8 codes cross the slow fabric; their sum over pods is taken in
    # int32 on each rank
    n = grid.size((axis,))
    codes = all_gather(q, grid, (axis,)).reshape(n, -1)
    summed = codes.sum(dim=0, dtype=torch.int32)
    out = torch.zeros_like(xf)
    for k, (lo, hi) in enumerate(segments):
        if hi > lo:
            out[lo:hi] = summed[lo:hi].float() * scales[k] / n
    return out, residual


def compressed_cross_pod_mean(x: torch.Tensor, grid: RankGrid,
                              residual: Optional[torch.Tensor] = None, *,
                              axis_name: str = "pod",
                              scale_axes: Optional[Tuple[str, ...]] = None,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce ``x`` across pods with int8 error-feedback compression.

    Returns (reduced, new_residual).  The scale is shared across pods
    (a max over ``scale_axes``, default the pod axis: negligible
    traffic), so the int32 sum of codes is an exact sum of quantized
    values.  Error feedback: the quantization error is carried to the
    next step so the compression is unbiased over time."""
    xf = x.float().reshape(-1)
    if residual is not None:
        xf = xf + residual.reshape(-1)
    out, new = compressed_mean(xf, [(0, xf.numel())], grid, axis_name,
                                scale_axes or (axis_name,))
    return out.to(x.dtype).reshape(x.shape), new.reshape(x.shape)


def cross_pod_mean(x: torch.Tensor, grid: RankGrid,
                   axis_name="pod") -> torch.Tensor:
    """The mean of ``x`` over the group of ``axis_name`` (an axis, or a
    tuple of axes, as ``pmean`` takes)."""
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    return all_reduce(x.clone(), grid, axes) / grid.size(axes)


# ---------------------------------------------------------------------------
# gradient-tree reduction for the training step
# ---------------------------------------------------------------------------

class FlatTree:
    """A tree's leaves laid end to end in one fp32 buffer, in the
    reference's leaf order (``leaf_groups``: a stacked reference leaf's
    layers together), padded to a multiple of ``multiple``.  ``bounds``
    holds each reference leaf's ``(lo, hi)``: the tensors the
    compressed phase gives one scale, as the reference scales each of
    its (stacked) leaves."""

    def __init__(self, tree, multiple: int = 1):
        self.groups = [(name, [(t.shape, t.dtype) for t in leaves])
                       for name, leaves, _ in leaf_groups(tree)]
        self.bounds: List[Tuple[int, int]] = []
        n = 0
        for _, metas in self.groups:
            lo = n
            for shape, _ in metas:
                n += _numel(shape)
            self.bounds.append((lo, n))
        self.numel = n
        self.padded = -(-n // multiple) * multiple
        self.template = tree

    def flatten(self, tree) -> torch.Tensor:
        leaves = [t for _, ts, _ in leaf_groups(tree) for t in ts]
        flat = torch.zeros(self.padded, dtype=torch.float32,
                           device=leaves[0].device)
        torch.cat([t.reshape(-1).float() for t in leaves],
                  out=flat[:self.numel])
        return flat

    def unflatten(self, flat: torch.Tensor):
        supply: Dict[str, Any] = {}
        at = 0
        for name, metas in self.groups:
            parts = []
            for shape, dtype in metas:
                k = _numel(shape)
                parts.append(flat[at:at + k].reshape(shape).to(dtype))
                at += k
            supply[name] = iter(parts)
        return rebuild(self.template, supply)

    def segments(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """Each reference leaf's part of ``[lo, hi)``, relative to lo."""
        return [(max(a, lo) - lo, max(min(b, hi), lo) - lo)
                for a, b in self.bounds]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# the axes a compressed leaf's scale is shared over: its largest
# |gradient| over every rank, as the reference's max over pods of each
# pod's whole (model-sharded) leaf
SCALE_AXES = ("pod", "data", "model")


def reduce_gradients_flat(grads: Any, grid: RankGrid) -> Any:
    """The mean of ``grads`` over every data-parallel rank: one
    all-reduce of the flat buffer over the flat group (what GSPMD does
    in the reference's ``dp_mode="auto"``)."""
    axes = grid.data_axes
    n = grid.size(axes)
    if n == 1:
        return grads
    flat_tree = FlatTree(grads)
    flat = flat_tree.flatten(grads)
    all_reduce(flat, grid, axes)
    return flat_tree.unflatten(flat.div_(n))


def reduce_gradients_hierarchically(grads: Any, grid: RankGrid, *,
                                    inter_axis: str = "pod",
                                    intra_axis: str = "data",
                                    compress: bool = False,
                                    residuals: Optional[torch.Tensor] = None,
                                    ) -> Tuple[Any, Optional[torch.Tensor]]:
    """The mean of ``grads`` over every data-parallel rank, in ScalePool's
    schedule: the flat buffer reduce-scattered over ``intra_axis`` (the
    pod's mean, a shard on each rank), its mean across pods (int8 with
    error feedback when ``compress``), all-gathered over ``intra_axis``.

    With ``compress`` the residual is this rank's shard of its pod's
    error feedback: a 1-D fp32 tensor of ``residual_shape`` (zeros, or
    None, at the start).  Returns (grads, new residual or None)."""
    n_intra = grid.size((intra_axis,))
    flat_tree = FlatTree(grads, n_intra)
    flat = flat_tree.flatten(grads)
    shard = reduce_scatter(flat, grid, (intra_axis,)).div_(n_intra)
    del flat
    new_res = None
    if compress:
        if residuals is not None:
            shard = shard + residuals
        lo = grid.index((intra_axis,)) * shard.numel()
        shard, new_res = compressed_mean(
            shard, flat_tree.segments(lo, lo + shard.numel()), grid,
            inter_axis, SCALE_AXES)
    else:
        all_reduce(shard, grid, (inter_axis,)).div_(
            grid.size((inter_axis,)))
    full = all_gather(shard, grid, (intra_axis,))
    return flat_tree.unflatten(full), new_res


def residual_shape(params: Any, grid: RankGrid,
                   intra_axis: str = "data") -> Tuple[int]:
    """The shape of one rank's error-feedback residual: its shard of the
    flat, padded gradient buffer."""
    n = grid.size((intra_axis,))
    return (FlatTree(params, n).padded // n,)
