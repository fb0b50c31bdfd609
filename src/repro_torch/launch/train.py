"""Training entry point of the port (``repro.launch.train``'s flags).

    # on the card (the default device)
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 100 --batch 8 --seq 512

    # small config on the CPU (also --arch olmoe-1b-7b, mamba2-780m,
    # zamba2-7b); --layers N trains any config's first N layers
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --smoke --steps 4 --batch 8 --seq 32 --device cpu

    # data parallel over 4 processes, ScalePool's hierarchical gradient
    # phase on the lease's (pod 2, data 2, model 1) layout
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --smoke \
        --device cpu --pool scalepool --pool-accels 12 \
        --dp-mode hierarchical --compress-pod --steps 3 --batch 8 --seq 32

    # tensor parallelism: 4 processes on the reference's smoke mesh
    # (data 2, model 2), restarted once if a rank fails
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 --max-restarts 1 -m repro_torch.launch.train \
        --smoke --device cpu --steps 3 --batch 8 --seq 32

Runs the full stack: data pipeline → train step (remat, microbatches,
data-parallel reduction) → AdamW → async checkpointing → fault-tolerant
loop with straggler monitoring.  ``--offload-optimizer`` keeps the AdamW
moments in pinned host memory (tier 2); ``--pool`` takes the tiering
policy (and, across processes, the layout) from a lease on a smoke
estate.

Under ``torch.distributed.run`` (``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` set) each process is one rank of a grid
(``launch.mesh``): the layout is the lease's ``mesh_shape(world)`` with
``--pool`` (``--pool-model-parallel`` sets its ``model`` axis), else the
reference's ``make_smoke_mesh(world)``: on 4 ranks ``(data 2, model
2)``, tensor parallelism with ``make_rules(..., fsdp=False)``, as the
reference's CLI trains there.  The backend follows
``launch.mesh.choose_backend`` (``--backend`` names it) and is printed.
Every rank draws the same global batch from the seeded pipeline and
trains on its rows with its blocks of the parameters; where the rules
shard the state every rank takes part in a checkpoint
(``ckpt.checkpoint.save`` sends rank 0 each distinct block once, and
rank 0 writes them), else rank 0 alone writes it, and one checkpoint
is in flight at a time; rank 0 prints each ``--log-every``-th step's
loss on stderr and the summary, which adds ``world``,
``compress_pod``, ``backend``, the rules (``profiles.describe``) and
``resumed_from``.  ``--dp-mode hierarchical`` falls back to ``auto``,
with a warning, only where the layout has no ``pod`` axis (one process
never has one).  Prints the reference's JSON summary plus ``"device"``;
exits 0 iff the loss decreased.

One process: the fault-tolerant loop retries a failing step, then
restores and rewinds, for as long as it takes (the reference's
semantics).  Across processes a failing step ends its rank's process;
under ``torch.distributed.run --max-restarts N`` the world restarts,
and each rank restores the last checkpoint this run committed (its
``TORCHELASTIC_RUN_ID``) and resumes from its step
(``TORCHELASTIC_RESTART_COUNT`` tells a rank it was restarted).  What
no step can do is refused before the loop, with exit code 2 and the
reason on stderr (``refusal``, ``layout_refusal``): encdec (the
pipeline yields no ``frame_embeds``; it trains through
``runtime.train.make_train_step``), on the card a config whose
attention or SSD scan the backward kernels do not take (the smoke
configs' head_dim 16, or SSD head_dim P 16), and across processes a
layout the world does not fill or that ``profiles.grid_refusal``
leaves to a later slice (the moe, ssm, hybrid and encdec families under
a ``model`` axis, heads that do not divide it).  Collectives time out
(``launch.mesh.DEFAULT_TIMEOUT_S``), so a dead rank makes the others
raise instead of waiting forever.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import elastic
from repro_torch.configs import get_config
from repro_torch.core.tiering import TieringPolicy
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention, ssd_scan
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.api import build_model
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.transformer import dtype_of
from repro_torch.obs.console import emit, emit_json, warn
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.runtime import train as train_rt
from repro_torch.runtime.ft import FaultTolerantLoop, StragglerMonitor
from repro_torch.sharding.profiles import (describe, grid_refusal,
                                           hierarchical_unsafe, make_rules)
from repro_torch.tree import tree_map

# the families whose training step runs attention (hybrid: its shared
# block) and the SSD scan
ATTENTION_FAMILIES = ("dense", "moe", "hybrid")
SSD_FAMILIES = ("ssm", "hybrid")
# the checkpoint directory, under the checkout's gitignored build/
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "ckpt"


def refusal(cfg: ModelConfig, device: torch.device) -> Optional[str]:
    """Why no training step of ``cfg`` can run from this CLI on
    ``device``, or None."""
    if cfg.family == "encdec":
        return (f"{cfg.name}: the data pipeline yields tokens and labels but "
                f"no frame_embeds, which the encoder reads (the reference "
                f"CLI has the same gap); train encdec through "
                f"runtime.train.make_train_step with batches that carry "
                f"frame_embeds")
    if device.type == "cuda":
        # q, k, v and the scan's x, B, C are projected from one activation
        # in the compute dtype
        dtype = dtype_of(cfg.compute_dtype)
        try:
            if cfg.family in ATTENTION_FAMILIES:
                flash_attention.check_backward(cfg.head_dim, dtype, dtype)
            if cfg.family in SSD_FAMILIES:
                ssd_scan.check_backward(cfg.ssm_head_dim, cfg.ssm_state,
                                        cfg.ssm_chunk, dtype)
        except (ValueError, TypeError) as e:
            return f"{cfg.name} cannot train on {device}: {e}"
    return None


def layout_refusal(layout: mesh_lib.Layout, world: int,
                   cfg: Optional[ModelConfig] = None,
                   rules=None) -> Optional[str]:
    """Why the port cannot train ``cfg`` on ``layout`` with ``world``
    ranks and ``rules``, or None."""
    if layout.size != world:
        return (f"a world of {world} ranks does not fill the layout "
                f"{layout.as_dict()} ({layout.size} ranks)")
    return grid_refusal(layout, rules, cfg)


def latest_checkpoint(ckpt_dir: Path, run_id: Optional[str]
                      ) -> Optional[Path]:
    """The committed ``step<N>`` checkpoint of the largest N in
    ``ckpt_dir`` that this run (``run_id``) wrote, or None."""
    best, best_step = None, -1
    for d in ckpt_dir.glob("step*"):
        if not d.name[4:].isdigit() or not (d / "manifest.p0.json").exists():
            continue
        manifest = ckpt.load_manifest(d)
        if manifest.get("extra", {}).get("run_id") != run_id:
            continue
        if manifest["step"] > best_step:
            best, best_step = d, manifest["step"]
    return best


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


def main(argv=None, failure_hook=None):
    """The CLI.  ``failure_hook(step)``, called before each step, may
    raise (an injected failure, as ``runtime.ft``'s tests inject one)."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="olmo-1b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--layers", type=int, default=None,
                   help="train only the config's first N layers (each "
                        "stack of an encoder-decoder): a depth cut at "
                        "full width, for quick runs")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' must be asked "
                        "for by name)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--dp-mode", default="auto",
                   choices=["auto", "hierarchical"])
    p.add_argument("--compress-pod", action="store_true")
    p.add_argument("--offload-optimizer", action="store_true")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend across processes "
                        "(default: nccl when each rank has a card of its "
                        "own, else gloo)")
    # ---- pool-orchestrated resources (repro_torch.pool) ----
    p.add_argument("--pool", default="none",
                   choices=["none", "scalepool", "baseline", "contention"],
                   help="obtain the device and tiering from a resource-pool "
                        "lease (contention = scalepool estate with overlap-"
                        "aware placement for co-resident jobs)")
    p.add_argument("--pool-accels", type=int, default=8)
    p.add_argument("--pool-tier2-gb", type=float, default=0.0)
    p.add_argument("--pool-model-parallel", type=int, default=1)
    p.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    args = p.parse_args(argv)
    env = world_from_env()
    if env is None:
        device = resolve_device(args.device)
    else:
        device = mesh_lib.rank_device(
            resolve_device(args.device).type, env["local_rank"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.n_layers:
            p.error(f"--layers {args.layers}: {cfg.name} has "
                    f"{cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers, **(
            {"n_enc_layers": args.layers} if cfg.family == "encdec"
            else {}))
    why = refusal(cfg, device)
    if why is not None:
        emit(f"error: {why}", stream=sys.stderr)
        return 2
    optimizer = AdamW(lr=args.lr)
    shape = ShapeConfig("cli", "train", args.seq, args.batch,
                        microbatches=args.microbatches)

    lease = None
    tier_policy = TieringPolicy() if args.offload_optimizer else None
    mesh = {"data": 1, "model": 1}
    layout = None
    if env is not None and args.pool == "none":
        layout = mesh_lib.make_smoke_mesh(env["world"])
    if args.pool != "none":
        # the orchestrator decides the devices AND tiering: a lease with a
        # tier-2 reservation trains with optimizer state in the capacity
        # tier; one without keeps everything in HBM.
        from repro_torch.pool import smoke_pool
        pool = smoke_pool(args.pool)
        lease = pool.lease("cli-train", args.pool_accels,
                           tier2_gb=args.pool_tier2_gb,
                           model_parallel=args.pool_model_parallel)
        if env is None:
            binding = lease.materialize([device])
            device, tier_policy = binding.device, binding.policy
            mesh = dict(zip(binding.axes, binding.shape))
        else:
            # every rank lays the lease's topology over the world
            layout = mesh_lib.Layout(*lease.mesh_shape(env["world"]))
            tier_policy = lease.tiering_policy()
        if args.offload_optimizer and not tier_policy.offload_optimizer:
            # explicit flag without a tier-2 reservation: honor it (host
            # memory stands in for the capacity tier) but say so.
            warn("--offload-optimizer with a 0-byte tier-2 lease; "
                 "offloading to host memory (pass --pool-tier2-gb to "
                 "reserve pool capacity)")
            tier_policy = dataclasses.replace(tier_policy,
                                              offload_optimizer=True)
    dp_mode = args.dp_mode
    if layout is not None:
        why = layout_refusal(layout, env["world"], cfg, make_rules(
            cfg, shape, layout, fsdp=False, dp_mode="auto"))
        if why is not None:
            emit(f"error: {why}", stream=sys.stderr)
            return 2
        mesh = layout.as_dict()
    if dp_mode == "hierarchical" and (layout is None
                                      or "pod" not in layout.axis_names):
        warn(f"hierarchical dp_mode needs a 'pod' axis, which the layout "
             f"{mesh} does not have; falling back to dp_mode=auto")
        dp_mode = "auto"
    if dp_mode == "hierarchical":
        reason = hierarchical_unsafe(cfg)
        if reason:
            warn(f"{reason}; falling back to dp_mode=auto")
            dp_mode = "auto"
    tcfg = train_rt.TrainStepConfig(dp_mode=dp_mode,
                                    compress_pod=args.compress_pod,
                                    microbatches=args.microbatches)
    grid, rules = None, None
    if layout is not None:
        rules = make_rules(cfg, shape, layout, fsdp=False, dp_mode=dp_mode)
        grid = mesh_lib.init_grid(layout, rank=env["rank"], device=device,
                                  backend=args.backend,
                                  local_world=env["local_world"])
        if grid.rank == 0:
            emit(f"backend: {grid.backend} ({grid.backend_why})",
                 stream=sys.stderr)
    try:
        return _train(args, cfg, device, optimizer, shape, tcfg, tier_policy,
                      lease, mesh, dp_mode, grid, rules, failure_hook)
    finally:
        if grid is not None:
            grid.close()


def _train(args, cfg, device, optimizer, shape, tcfg, tier_policy, lease,
           mesh, dp_mode, grid, rules, failure_hook=None) -> int:
    writer = grid is None or grid.rank == 0
    model = build_model(cfg, device=device)
    # the initial weights are drawn from seed 0, as the reference's
    # PRNGKey(0), the same on every rank, which keeps its blocks
    generator = torch.Generator(device=device).manual_seed(0)
    state = train_rt.init_state(model, optimizer, generator, tcfg,
                                tiering=tier_policy, mesh=grid, rules=rules)
    train_step = train_rt.make_train_step(model, optimizer, shape, mesh=grid,
                                          rules=rules, tcfg=tcfg,
                                          tiering=tier_policy)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                   global_batch=args.batch))

    ckpt_dir = Path(args.ckpt_dir)
    ranks = 1 if grid is None else grid.world
    run_id = os.environ.get("TORCHELASTIC_RUN_ID")
    pa = model.param_axes() if model.param_axes is not None else None
    axes = None if pa is None else {"params": pa, "mu": pa, "nu": pa}
    resumed_from = first_loss = None
    # the world's restarts (torch.distributed.run's), beside the loop's
    world_restarts = 0 if ranks == 1 else int(
        os.environ.get("TORCHELASTIC_RESTART_COUNT", "0"))
    if world_restarts > 0:
        # a restarted world: every rank restores the last checkpoint this
        # run committed (or starts over), and the loop rewinds to its step
        found = latest_checkpoint(ckpt_dir, run_id)
        resumed_from = 0
        if found is not None:
            tree, extra = elastic.replan(
                found, {"params": state.params, "mu": state.opt.mu,
                        "nu": state.opt.nu}, grid, rules, axes)
            step_t = torch.tensor(extra["step"], dtype=torch.int32,
                                  device=state.opt.step.device)
            state = train_rt.TrainState(tree["params"], AdamWState(
                step_t, tree["mu"], tree["nu"]), state.residuals)
            resumed_from, first_loss = extra["step"], extra.get("loss_first")
            del tree
            if writer:
                emit(f"restored the checkpoint of step {resumed_from} "
                     f"({found})", stream=sys.stderr)
    # the state a failure restores.  One process keeps it (a world of
    # one rank in host memory, since ranks may share a card); across
    # processes the loop restores nothing, a restarted world reads the
    # checkpoint, and the loop starts from the state
    keep = (lambda s: s) if grid is None else (
        lambda s: tree_map(lambda t: t.to("cpu", copy=True), s))
    last = {"state": state if ranks > 1 else keep(state),
            "step": resumed_from or 0}
    del state
    saves = []
    # the run's first loss: a resumed run's is its first attempt's (the
    # checkpoint's); kept apart from the loop, so no closure here refers
    # to the loop and the state is freed when the CLI returns
    first = {"loss": first_loss}

    def save_fn(s, step):
        if ranks == 1:
            last["state"], last["step"] = keep(s), step
        # one checkpoint in flight: the previous one is committed before
        # this one's host copy is taken (the other ranks' blocks wait for
        # it too), so a rank that fails after this save leaves at least
        # the previous checkpoint committed
        for handle in saves:
            handle.wait()
        saves.clear()
        # rank 0 writes; the others send it their blocks, if any
        saves.append(ckpt.save(
            ckpt_dir / f"step{step}",
            {"params": s.params, "mu": s.opt.mu, "nu": s.opt.nu},
            step=step, extra={"pipeline": pipe.state.to_dict(),
                              "run_id": run_id,
                              "loss_first": first["loss"]},
            asynchronous=True, mesh=grid, rules=rules, axes=axes))

    def restore_fn():
        if ranks > 1:
            return last.pop("state"), last["step"]
        if grid is None:
            return last["state"], last["step"]
        return tree_map(lambda t: t.to(device), last["state"]), last["step"]

    def logged_step(s, batch):
        s, metrics = train_step(s, batch)
        done, loss = int(metrics["step"]), float(metrics["loss"])
        if first["loss"] is None:
            first["loss"] = loss
        if writer and args.log_every > 0 and done % args.log_every == 0:
            emit(json.dumps({"step": done, "loss": loss}), stream=sys.stderr)
        return s, metrics

    loop = FaultTolerantLoop(logged_step, save_fn, restore_fn, pipe,
                             ckpt_every=args.ckpt_every,
                             monitor=StragglerMonitor(),
                             failure_hook=failure_hook, ranks=ranks)

    t0 = time.time()
    loop.run(None, args.steps)
    dt = time.time() - t0
    for handle in saves:    # no checkpoint is left half written at exit
        handle.wait()

    losses = [h["loss"] for h in loop.history]
    summary = {
        "arch": cfg.name, "steps": args.steps,
        "devices": 1 if grid is None else grid.world, "mesh": mesh,
        "dp_mode": dp_mode,
        "lease": (None if lease is None else {
            "pods": list(lease.allocation.pod_ids),
            "accels": lease.n_accels,
            "tier2_gb": lease.tier2_bytes / 1e9,
            "offload_optimizer": tier_policy.offload_optimizer}),
        "loss_first": first["loss"], "loss_last": losses[-1],
        "loss_drop": first["loss"] - losses[-1],
        "wall_s": round(dt, 1),
        "s_per_step": round(dt / max(1, args.steps - loop.start_step), 3),
        "straggler_events": len(loop.monitor.events),
        "restarts": loop.restarts + world_restarts,
        "device": str(device),
    }
    if grid is not None:
        summary.update(world=grid.world, compress_pod=tcfg.compress_pod,
                       backend=grid.backend, rules=describe(rules),
                       resumed_from=resumed_from)
    if writer:
        emit_json(summary)
    return 0 if losses[-1] < first["loss"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
