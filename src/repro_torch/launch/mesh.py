"""The rank grid: the port's counterpart of a JAX ``Mesh`` (port of
``repro.launch.mesh``).

ScalePool mapping: the inner axes (``data``, ``model``) are one
accelerator cluster's XLink domain; the outer ``pod`` axis is the
inter-cluster CXL fabric.  In the port one process is one rank, and a
rank's coordinates on the grid are its global rank unravelled row-major
over the layout's shape, the order ``jax.make_mesh`` lays out a device
list: on ``(pod 2, data 2, model 1)`` ranks 0, 1 are pod 0 and ranks 2,
3 pod 1.

A ``Layout`` is the grid's shape and axis names only (what
``make_rules`` reads); ``init_grid`` makes the ``RankGrid`` of one rank:
its coordinates, its device, and one process group per axis (the ranks
that differ only in that axis: the ``data`` group is the ranks of one
pod, the ``pod`` group the ranks with the same ``data`` index) and one
over the data-parallel axes together (``pod`` and ``data``, the flat
group).  Every rank makes every group, once, in the same order, as
``torch.distributed.new_group`` requires.  A world of one makes no
process group: each collective over it is the identity.

The backend follows one rule (``choose_backend``): ``nccl`` when every
rank of the host has a card of its own, ``gloo`` when ranks share a
card or run on the CPU.  NCCL refuses two ranks on one card, so a
one-card machine runs its ranks over ``gloo``, each collective on a
pinned host copy of the tensor (``repro_torch.core.hierarchy``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# the data-parallel axes, outer first: a batch block's index is its
# rank's row-major index over those of them the grid has
DATA_AXES = ("pod", "data")
# a dead rank makes the others raise after this long in a collective
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Layout:
    """A grid's shape and axis names (a ``Mesh`` without devices)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} does not match axes "
                             f"{self.axis_names}")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def coords(self, rank: int) -> Dict[str, int]:
        """``{axis: index}`` of ``rank`` (row-major, the last axis
        fastest)."""
        out = {}
        for name, size in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = rank % size
            rank //= size
        return {a: out[a] for a in self.axis_names}

    def groups(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """Every group of ranks that differ only in ``axes``, each in
        increasing rank order (row-major over ``axes``), the groups in
        increasing order of their first rank."""
        out: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            out.setdefault(key, []).append(r)
        return [out[k] for k in sorted(out, key=lambda k: out[k][0])]

    def as_dict(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Layout(shape, axes)


def make_smoke_mesh(n_devices: int) -> Layout:
    """The reference's small mesh over ``n_devices`` ranks."""
    if n_devices >= 8:
        return Layout((2, 2, 2), ("pod", "data", "model"))
    if n_devices >= 4:
        return Layout((2, 2), ("data", "model"))
    return Layout((1, 1), ("data", "model"))


def choose_backend(device: torch.device, local_world: int,
                   requested: Optional[str] = None) -> Tuple[str, str]:
    """(backend, why) by the port's one rule: ``nccl`` when each of the
    ``local_world`` ranks on this host has a card of its own, ``gloo``
    when they share a card or run on the CPU.  ``requested`` names the
    backend instead; ``nccl`` is refused where the rule gives ``gloo``
    (NCCL refuses two ranks on one card and has no CPU path)."""
    if device.type == "cpu":
        rule, why = "gloo", "ranks run on the CPU"
    else:
        cards = torch.cuda.device_count()
        if local_world <= cards:
            rule, why = "nccl", (f"{local_world} ranks on {cards} cards: "
                                 f"a card each")
        else:
            rule, why = "gloo", (f"{local_world} ranks share {cards} "
                                 f"card(s)")
    if requested is None or requested == rule:
        return rule, why
    if requested == "nccl":
        raise ValueError(f"backend nccl cannot run here: {why}")
    if requested != "gloo":
        raise ValueError(f"unknown backend {requested!r}: nccl or gloo")
    return "gloo", f"asked for by the caller ({why})"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of the rank ``local_rank`` of its host: a card in
    turn (``cuda:local_rank mod cards``), or the CPU when asked."""
    if device_type == "cpu":
        return torch.device("cpu")
    resolve_device(device_type)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


@dataclasses.dataclass
class CollectiveStats:
    """What this rank's collectives cost: ring-accounted payload bytes
    it sends per ``(axes, op)`` (the reference's HLO accounting,
    ``repro.launch.hlo_analysis.moved_bytes``) and host seconds spent in
    them, staging copies included."""
    moved_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds_by: Dict[str, float] = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    def add(self, axes: Tuple[str, ...], op: str, nbytes: float,
            seconds: float) -> None:
        key = f"{'+'.join(axes)}:{op}"
        self.moved_bytes[key] = self.moved_bytes.get(key, 0.0) + nbytes
        self.calls[key] = self.calls.get(key, 0) + 1
        self.seconds_by[key] = self.seconds_by.get(key, 0.0) + seconds
        self.seconds += seconds

    def reset(self) -> None:
        self.moved_bytes.clear()
        self.calls.clear()
        self.seconds_by.clear()
        self.seconds = 0.0

    def axis_bytes(self, axis: str) -> float:
        """Bytes sent over groups that span ``axis``."""
        return sum(b for k, b in self.moved_bytes.items()
                   if axis in k.split(":")[0].split("+"))


@dataclasses.dataclass
class RankGrid:
    """One rank's place on the grid, its device and its groups.
    ``owns_world``: whether ``init_grid`` started the process group (a
    grid formed in a world already running leaves it to its owner)."""
    layout: Layout
    rank: int
    device: torch.device
    backend: Optional[str] = None
    backend_why: str = "a world of one makes no process group"
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict)
    stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)
    owns_world: bool = False

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.layout.axis_names

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.layout.shape

    @property
    def world(self) -> int:
        return self.layout.size

    @property
    def coords(self) -> Dict[str, int]:
        return self.layout.coords(self.rank)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.axis_names)

    @property
    def stages_on_host(self) -> bool:
        """Whether collectives run on a pinned host copy: gloo with the
        rank's tensors on a card."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def size(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.layout.axis_size(a)
        return n

    def index(self, axes: Tuple[str, ...]) -> int:
        """This rank's row-major index over ``axes``."""
        c, i = self.coords, 0
        for a in axes:
            i = i * self.layout.axis_size(a) + c.get(a, 0)
        return i

    def group(self, axes: Tuple[str, ...]):
        """The process group over ``axes`` (in any order) that holds this
        rank; None when the group is this rank alone, the world's when
        it spans every axis over 1."""
        axes = tuple(a for a in self.axis_names
                     if a in axes and self.layout.axis_size(a) > 1)
        if not axes:
            return None
        if len(axes) == len([s for s in self.shape if s > 1]):
            return dist.group.WORLD
        if axes not in self.groups:
            raise KeyError(f"no process group over {axes}: the grid made "
                           f"{sorted(self.groups)}")
        return self.groups[axes]

    def describe(self) -> Dict[str, object]:
        return {"world": self.world, "mesh": self.layout.as_dict(),
                "rank": self.rank, "coords": self.coords,
                "device": str(self.device), "backend": self.backend,
                "backend_why": self.backend_why}

    def close(self) -> None:
        """Leave the process group (every rank, at the end) if this grid
        started it; a grid formed in a running world only drops its
        groups."""
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self.groups.clear()


def grid_axes(layout: Layout) -> List[Tuple[str, ...]]:
    """The axes of the groups a grid makes: each axis over 1, the
    data-parallel axes together where more than one of them is over 1,
    and ``data`` with ``model`` (a leaf both split, under FSDP and
    tensor parallelism) where both are and the grid has more.  The group
    over every axis over 1 is the world's."""
    big = [a for a, s in zip(layout.axis_names, layout.shape) if s > 1]
    out = [(a,) for a in big]
    data = tuple(a for a in DATA_AXES if a in big)
    dm = tuple(a for a in layout.axis_names if a in ("data", "model")
               and a in big)
    if len(data) > 1:
        out.append(data)
    if 1 < len(dm) < len(big):
        out.append(dm)
    return out


def elastic_store(world: int, timeout: datetime.timedelta):
    """Under ``torch.distributed.run``'s agent store, the store of this
    attempt: the agent keeps one store across a world's restarts, so the
    keys the ranks of an earlier attempt left there (the addresses gloo
    connects to) would pair a restarted rank with dead ones; a prefix
    per ``TORCHELASTIC_RESTART_COUNT`` keeps each attempt's apart.  None
    outside an agent."""
    if os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True":
        return None
    attempt = os.environ.get("TORCHELASTIC_RESTART_COUNT", "0")
    return dist.PrefixStore(
        f"/repro_torch/attempt_{attempt}",
        dist.TCPStore(os.environ["MASTER_ADDR"],
                      int(os.environ["MASTER_PORT"]), world,
                      is_master=False, timeout=timeout))


def world_from_env() -> Optional[Dict[str, int]]:
    """The rank, world and host-local rank ``torch.distributed.run``
    sets, or None when run as one process."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    return {"world": world, "rank": rank,
            "local_rank": int(os.environ.get("LOCAL_RANK", str(rank))),
            "local_world": int(os.environ.get("LOCAL_WORLD_SIZE",
                                              str(world)))}


def running_world() -> Dict[str, int]:
    """This process's place in its world: the running process group's
    (its host-local rank from ``LOCAL_RANK``, else its rank), else what
    ``torch.distributed.run`` set (``world_from_env``), else a world of
    one."""
    env = world_from_env()
    if not dist.is_initialized():
        return env or {"world": 1, "rank": 0, "local_rank": 0,
                       "local_world": 1}
    world, rank = dist.get_world_size(), dist.get_rank()
    env = env or {}
    return {"world": world, "rank": rank,
            "local_rank": env.get("local_rank", rank),
            "local_world": env.get("local_world", world)}


def init_grid(layout: Layout, *, rank: int, device: torch.device,
              backend: Optional[str] = None, local_world: Optional[int] = None,
              init_method: str = "env://",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> RankGrid:
    """Join the world of ``layout.size`` ranks as ``rank`` and make the
    grid's groups.  ``backend`` None applies ``choose_backend``'s rule
    over ``local_world`` ranks on this host (default: the whole world).
    ``timeout_s`` bounds each collective, so a dead rank makes the
    others raise instead of waiting forever.  In a world already joined
    (a second layout over the same ranks) only the groups are made, by
    every rank in the same order; the backend is the world's."""
    if not 0 <= rank < layout.size:
        raise ValueError(f"rank {rank} outside a world of {layout.size}")
    grid = RankGrid(layout, rank, device)
    if layout.size == 1:
        return grid
    timeout = datetime.timedelta(seconds=timeout_s)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (layout.size, rank):
            raise ValueError(
                f"rank {rank} of a layout of {layout.size} in a running "
                f"world where this process is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}")
        grid.backend = dist.get_backend()
        grid.backend_why = "the running world's"
    else:
        grid.backend, grid.backend_why = choose_backend(
            device, local_world or layout.size, backend)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        store = elastic_store(layout.size, timeout) \
            if init_method == "env://" else None
        dist.init_process_group(
            grid.backend, init_method=None if store else init_method,
            store=store, rank=rank, world_size=layout.size, timeout=timeout)
        grid.owns_world = True
    for axes in grid_axes(layout):
        for ranks in layout.groups(axes):
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                grid.groups[axes] = g
    return grid

