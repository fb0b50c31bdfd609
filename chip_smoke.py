"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root, one GPU

Phases, each printing one JSON line; any failure raises (nonzero exit,
no result line):

1. device   - the card's name and power limit, TF32 off;
2. build    - the CUDA kernels of ``src/repro_torch/csrc`` compiled by
              nvcc, with the build time;
3. kernels  - each kernel against its plain PyTorch version on the card
              at the serving paths' shapes, max errors beside their
              tolerances; split-KV paged attention bitwise invariant
              under the page layout and under the batch (a row alone
              equals its row of B = 8), and on a bf16 pool of 16-token
              pages with a window starting mid-split, and at the pooled
              path's shape (bf16 q, fp32 pool of 16-token pages, H=KV=16,
              D=64, 8-page tables; rows alone and in pairs bitwise equal
              to their rows of B = 4), the decode tier's (15-page
              tables, 224..240 tokens) and the colocation engines' (10-page
              tables, 33..160 tokens; rows in ones, pairs and fours
              bitwise equal to their rows of B = 6); flash on its
              tensor-core kernel (bf16 q) over Sq 1..1024, D 64 / 112 /
              128, fp32 and bf16 K/V, G 1 and 4, the masks, rows with no
              visible key exactly zero, and on its CUDA-core kernel (fp32
              q) at the fp32 tolerance; the SSD scan on its tensor-core
              kernel (bf16 x, B, C) at the served shapes and over S
              1..1000, chunk 64 / 128, N 64 / 128, P 32 / 64, G 1 / 2,
              with and without an initial state (y 2e-2, state 2e-4), and
              on its CUDA-core kernel (fp32) at 2e-4, each launch checked
              by variant; the moe and encdec paths' shapes: paged decode
              over bf16 pools of 64-token pages at olmoe's heads
              (H=KV=16, D=128) and mixtral's (H=32, KV=8, D=128, window
              4096), flash at olmoe's 512-token prefill on bf16 K/V,
              whisper's non-causal encoder (B=4, 1500 frames, H=12,
              D=64), its cross-attention (64 and 1 queries over 1500
              frames; these non-causal cases at 6e-3, and one more with
              V lifted on the ragged last tile's 28 keys) and its
              decoder's causal self-attention over the fp32 cache,
              RMSNorm at 512 x 2048 and 8 x 2048; the training path's
              backward kernels through their autograd Functions against
              autograd of the plain versions, each case run twice and
              required to give the same bits: flash backward at olmo's
              shape (B=2, S=512, H=KV=16, D=128; olmoe's too), qwen's
              (D=64), GQA (H=32, KV=8, D=128, window 128), non-causal (64
              queries over 300 keys), whisper's encoder (1500 frames,
              non-causal, H=12, D=64), cross-attention (448 queries over
              1500 frames) and decoder (448, causal), all bf16 on the
              tensor-core kernel (2e-2 of the
              largest |grad|; and against the emulation of its contract,
              ``tests/_flash_bwd_emulation.py``, at ``BWD_EMU_TOL``), and
              the fp32 CUDA-core kernel at D=64 (1e-5), and zamba2's
              shared block (B=8, S=512, H=KV=32, D=112) in bf16 and fp32;
              RMSNorm backward at 4096 x 1024 (qwen's, a warp a row) and
              4096 x 2048 (olmoe's, a block a row) in bf16 and fp32, and
              at mamba2's 1536 and 3072 and zamba2's 3584 and 7168 (a
              block a row); the SSD backward (B8) through ``SSDScanFn``
              at mamba2's and zamba2's training calls (B=8, S=512, H=48
              / 112, N=128 / 64) and a ragged S=300 with G=2, an initial
              state and a final state's gradient, in bf16 on the
              tensor-core kernel (2e-2; against the emulation of its
              contract, ``tests/_ssd_bwd_tc_emulation.py``) and fp32 on
              the CUDA-core one (2e-4; against the emulation of its
              algorithm, ``tests/_ssd_bwd_emulation.py``), both at
              ``SSD_BWD_EMU_TOL``;
4. serve    - qwen1.5-0.5b at full width (24 layers, d=1024, vocab
              151,936, seeded random weights) served by
              ``repro_torch.serve.Engine`` through ``run_trace``: 16
              requests under a 32-page tier-1 quota with a 4 GB tier-2
              budget, so sequences pause, spill and fetch.  Every kernel
              launch of the run is counted (flash by variant: every
              served launch on the tensor-core kernel), and one
              prefill's and one decode step's logits are held against
              the plain path (gated with the weights upcast to fp32
              compute, on flash's CUDA-core kernel; the served bf16
              comparison is reported beside it); 4b profiles an engine
              window;
6.  pooled  - (run right after phase 4, on its model and weights)
              benchmarks/fig9_multitenant.py's smoke scenario at full
              width: three skewed tenants (hog, mid, burst) served by
              three engines from ONE 24-page ``PoolArbiter`` pool through
              ``run_multi_trace`` (then again without the page check and
              the tracer, timed), against three static 1/3 private
              engines; a lone tenant under an arbiter against a private
              engine; two tenants built with ``Engine.from_lease`` from
              one multi-tenant lease against ``Engine.local`` with
              ``kv_share``'s budget; the pooled scenario in fp32 against
              private engines with ample pools.  Checked: every request
              done, revocation fired, pooled aggregate p95 below static
              and no tenant above 1.05x its static p95, the lone tenant
              and the lease engines identical (tokens, clocks) to their
              counterparts, the fp32 pooled tokens equal to the private
              engines' (revocation fired there too), the timed rerun
              identical to the watched run, no live page in two tenants'
              tables after any step, the modeled numbers equal to the
              same scenario at smoke width on the CPU, and the paged,
              flash and RMSNorm launches exact;
7.  disagg  - (run right after phase 6, on phase 4's model and weights)
              benchmarks/fig12_disagg.py's smoke scenario at full width:
              12 requests of 224 prompt tokens and 16 new on 4-slot
              engines of 16-token pages, modeled costs priced at the
              full-size model, link capacities in pages per modeled
              second.  At full depth in bf16: two colocated engines
              (``run_multi_trace``) against a prefill engine handing each
              request's pages over the modeled fabric to a decode engine
              (``DisaggCluster``: direct, and staged through a tier-2
              memory node), and the degenerate cluster against
              ``run_trace(Engine)``; the three runs again in fp32 (TF32
              off); the four staging runs (saturated and idle trunk) on
              the first 2 layers.  Checked: every request done, fig12's
              four claims (decode p95 at least 2x better disaggregated,
              fp32 tokens identical across the three runs, the
              degenerate cluster identical in tokens and trace events,
              staging wins on a saturated trunk and loses on an idle
              one), every ``handoff_use`` at or after its last page
              landed, the modeled numbers equal to the same scenario's at
              smoke width on the CPU, and the paged, flash and RMSNorm
              launches exact; the bf16 tokens are reported beside the
              fp32 ones, with the top-2 logit margin where they differ;
8.  colo    - (run right after phase 7, on phase 4's model and weights)
              benchmarks/fig11_colocation.py's smoke scenario at full
              width: two tenants' bursts (6 requests each, 32 prompt
              tokens, 128 new) on 6-slot engines of 16-token pages under
              a 20-page quota, spilling KV over one tier-2 trunk, while
              an 8-way data-parallel training job (colo-13b, 16 GB of
              tier-2 offload, 8 steps) prices its gradient and offload
              phases on the same ``Transport`` (``repro_torch.colo``,
              ``run_colo``), on 6 pods of 5 accels over 3 CXL leaves and
              2 tier-2 memory nodes.  At full depth in bf16: the training
              job placed hop-only, contention-aware, and no training.
              Checked: every request done, fig11's five claims (the
              placements differ, contention-aware placement wins on step
              time and aggregate p95, tokens identical across the three
              runs, the trunk carries serving and training bytes, the
              transport re-rated contended transfers), the modeled
              numbers within 1e-9 of the same scenario's at smoke width
              on the CPU, the paged, flash and RMSNorm launches exact per
              run, and the hop-only trace clean under the port's
              sanitizer; on the first 2 layers in fp32 the three runs
              again, every modeled number equal to the CPU's to the last
              digit; on the first 2 layers in bf16 the port's racecheck
              (fig11's racecheck shape, seeds 1 and 2) bit-identical;
6-8.         the traces of phases 6 (a), 7 and 8 pass the port's
              sanitizer (``repro_torch.analysis``) with zero violations,
              and their Chrome exports ``validate_trace_events``;
4c/4d. batch - mamba2-780m (48 layers, d=1536, 8 x 500-token prompts,
              32 tokens) and zamba2-7b (81 mamba layers, d=3584, the
              shared attention block 13 times, 4 x 500-token prompts, 16
              tokens) at full width and depth through the fixed-batch
              steps ``make_prefill_step`` / ``make_decode_step``, launch
              counts checked exactly (every served SSD launch on the
              tensor-core kernel, the fp32-gated checks' on the CUDA-core
              one), logits held against the plain path as in phase 4; 4e
              profiles a mamba2 decode window; 4f: whisper-small (12
              encoder and 12 decoder layers, d=768, 1500 seeded frames, 4
              x 64-token prompts, 32 tokens) the same way: flash 36 times
              a prefill (12 encoder, 12 causal self, 12 cross) and 24
              times a decode step, no RMSNorm (LayerNorm is no kernel);
9.  moe     - (run after phase 8, once qwen's weights are freed)
              olmoe-1b-7b at full width and depth (16 layers, d=2048, 64
              experts top-8 of d_ff 1024, vocab 50,304, capacity factor
              1.25, seeded fp32 draws served in bf16, 64-token bf16
              pages) through ``Engine.local`` and ``run_trace`` under
              phase 4's trace, quota and tier-2 budget: every request
              done, spills and fetches, launches exact; one prefill's and
              one decode step's logits against the plain path, reported
              in bf16 and gated in fp32 under the routing-tie rule (each
              layer's routing recorded on both paths: gated where equal;
              a flip fails the run unless its router gap is under 1e-5);
              a profiled decode window: a step's device time (its
              expert and attention layers alone too) beside its byte
              bound, and its busy share.  Then mixtral-8x7b at full
              width on its first 8 layers (the fp32 gate's 8.7 GB a
              layer: 9 or more do not fit one card with headroom):
              8 requests of 120/250 prompt tokens, 32 new, an ample pool,
              launches exact, logits held the same way;
10. train   - (run after the serving paths) the training path at B=8 x
              S=512 through ``repro_torch.launch.train``'s parts (the
              step of ``runtime.train``, AdamW at the CLI's defaults,
              remat on, the synthetic pipeline): (a) olmo-1b at full width
              and depth (16 layers, d=2048, 1.18e9 fp32 masters, bf16
              compute), 10 steps: the loss falls, every parameter leaf has
              a finite non-zero gradient on step 1, flash launches exactly
              2 x 16 forward (forward and remat recompute) and 16 backward
              per step, every backward on the tensor-core kernel; (b) the
              fp32 gate: olmo-1b at full width on its first 2 layers in
              fp32, 3 steps through the kernels (the backward on the
              CUDA-core kernel) against 3 under ``plain_versions()``, loss
              and grad norm to 1e-5 relative; (b2) the same cut in bf16,
              10 steps against 10 plain, each step's loss to 1e-2
              relative; (c) qwen1.5-0.5b at full width, 10 steps, flash and
              RMSNorm forward and backward launches exact; (d) fault
              tolerance on (b)'s cut in bf16: the CLI's fault-tolerant loop
              with the port's own ``ckpt.save``, a failure that outlasts the
              retries restores from disk, final state equal in bits to a
              clean run's; (e) ``--offload-optimizer`` on the same cut: 2
              steps with the moments in pinned host memory equal the
              in-HBM steps in bits at a lower peak of device memory,
              host<->device bytes per step reported; (f) seconds per
              step, tokens per second, peak memory, the device's busy
              share over 2 profiled steps and (a)'s model FLOPs share of
              989 TFLOP/s, beside ``nvidia-smi``'s line; (g) the training
              CLI itself on its default device: olmo-1b at full width and
              depth, 10 steps in HBM, 4 with ``--offload-optimizer`` (the
              offloaded peak lower) and 2 through ``--pool scalepool``
              with a tier-2 reservation; the CLI's refusals before its
              loop (``--smoke`` in a process of its own: head_dim 16 has
              no backward kernel, exit 2 with the reason within 30 s;
              whisper-small: no ``frame_embeds`` in the pipeline); (h)
              olmoe-1b-7b at full width on its first 4 of 16 layers and
              (i) whisper-small at full width and depth (B=8, 1500
              seeded frames, decoder S=448), each as (a) (every leaf a
              finite gradient, non-zero but for an expert no token
              reached and whisper's key biases, whose gradient is zero in
              exact arithmetic; launches exact, every backward on the
              tensor-core kernel; the report (f), model FLOPs of the
              active parameters) plus one step run twice from one state,
              equal in bits, and an fp32 gate on its first 2 layers (the
              moe routing recorded on both paths: a flip beyond 1e-5 on
              step 1 fails, a step is gated while the routing so far is
              equal); whisper's bf16 trajectory on its first 2 layers;
              (j) mamba2-780m at full width and depth (48 layers,
              d=1536, 7.79e8 parameters) and (k) zamba2-7b at full width
              on its first 15 of 81 layers (2 groups of the shared block
              and 6 Mamba2 layers, 3 tail layers), each as (h) (the SSD
              scan forward and recompute and B8 on every Mamba2 layer,
              zamba2's shared block on B3 and B5 at head_dim 112) with
              its fp32 gate and bf16 trajectory (mamba2 on 2 layers,
              zamba2 on 7: a group and a tail layer, its trajectory at
              ``TRAJ_LR``, where that cut's loss falls); the CLI trains
              mamba2-780m 3 steps and refuses its ``--smoke`` (SSD head_dim
              P 16) within 30 s; serving paths launch no backward kernel;
11. dp      - (run after phase 10) data-parallel training across
              processes: one spawned world of 4 ranks sharing the card
              as (pod 2, data 2, model 1) over gloo (``launch.mesh``;
              NCCL refuses two ranks on one card), each collective on a
              pinned host copy (``core.hierarchy``), the kernels built
              by this process first; any rank's failure or the world's
              overrunning ``DP_WORLD_LIMIT_S`` fails the run.  The
              probe: which collectives this torch's gloo takes on CUDA
              tensors.  (a) qwen1.5-0.5b at full width on its first 2
              layers in fp32 (TF32 off), global B=8 x S=512: one
              ``auto`` step against the one-process step, and
              ``hierarchical`` against ``auto``: loss and grad norm to
              1e-5 relative, parameters to 1e-5 of the largest
              |parameter| but at most ``DP_PARAM_SHARE`` of them (AdamW's
              near-zero gradients); the ``compress_pod`` reduction
              against the plain in-process evaluation of the reference's
              compressed mean over the two pods' gradients, within one
              code step (scale / 2) plus 1e-6 of the largest |mean|, the
              share of code sums that differ reported; (b) qwen1.5-0.5b
              at full width on its first 6 of 24 layers (``DP_DEPTH``)
              in bf16, 4 ranks x B=2 x S=512 (the weights of seed 0,
              phase 10 (c)'s batches), 4 steps each of
              ``auto``, ``hierarchical`` and ``compress_pod``: s/step,
              each rank's peak, host seconds in collectives by op, the
              byte counter by axis and op, each rank's launches exact
              (B2, B3, B5, B6; every flash call forward and backward on
              the tensor-core kernel), ranks' losses equal, ``auto``'s
              losses within 1e-2 of the one-process step's on the same
              cut; (c) one
              ``compress_pod`` step on (a)'s cut in bf16 run twice from
              one state: the same bits in every rank; (d) the training
              CLI under ``torch.distributed.run`` on 4 ranks
              (qwen1.5-0.5b at full width on its first 2 layers,
              ``--layers``, the lease's (2, 2, 1) layout,
              ``hierarchical`` with ``compress_pod``, 3 steps) exits 0
              with mesh, dp_mode and backend ``gloo`` in its summary.
              Every time here is 4 ranks sharing one card: it measures
              nothing of a fabric;
12. tp      - (run after phase 11) tensor parallelism over ``model`` and
              FSDP over ``data`` (``repro_torch.sharding.tp``): two
              spawned worlds of 4 ranks sharing the card over gloo as
              phase 11's, (data 2, model 2) with FSDP off (the reference
              CLI's rules) and on, and (pod 2, data 1, model 2)
              ``hierarchical`` with ``compress_pod``.  (a) qwen1.5-0.5b at
              full width on its first 2 layers in fp32, global B=8 x
              S=512, 3 steps of each case against the one-process step on
              the same weights and batches (the compressed case against
              the plain in-process evaluation of the reference's
              compressed mean over the two pods, residuals carried): loss
              and grad norm to 1e-5 relative, the parameters gathered
              from the ranks to 1e-5 of the largest |parameter| but at
              most ``DP_PARAM_SHARE`` of them (C-port15); (b) full width
              and depth in bf16, phase 10 (c)'s weights and batches, 4
              steps of each case: s/step, host seconds in collectives
              and bytes by (axes, op), each rank's peak, launches exact
              in every rank (B2, B3, B5, B6 on a rank's local heads),
              ranks' losses equal and each within 1e-2 of phase 10
              (c)'s (the compressed case's of the plain in-process
              evaluation of the same schedule: int8 codes move a
              trajectory further); (c) a step with FSDP on the 2-layer cut in bf16 run
              twice from one state: the same bits in every rank; (d) the
              training CLI under ``torch.distributed.run`` on 4 ranks
              with no ``--pool`` (qwen1.5-0.5b at full width on its
              first 2 layers, the reference's smoke mesh (data 2, model
              2), tensor parallel, 3 steps of 8 x 512), then under
              ``--max-restarts 1`` through a wrapper whose failure hook
              raises on rank 1 at step 2 of the first attempt, with
              ``--ckpt-every 1``: exit 0, the resume reported, every
              step's loss equal in bits to the first run's.  Every time
              here is 4 ranks sharing one card: nothing of a fabric;
5. times    - each kernel's time (CUDA graphs of back-to-back calls,
              timed with CUDA events, median of trials) beside its plain
              version, a PyTorch library call where one computes the
              same function (for flash, SDPA on the same inputs: in
              bf16 where q and K/V are bf16, in fp32 over the fp32
              cache; and, as ``library_bf16_ms``, on bf16 K/V), and
              the bound from the H100's published peaks, at each path's
              shapes (paged at
              the engine's 8-row and 1-row decode buckets, the pooled
              path's 4 rows of 8-page tables, the decode tier's 4 rows
              of 15-page tables and the colocation engines' 6 rows of
              10-page tables, 16-token pages; flash at qwen's 32 / 128 /
              256 / 512 buckets and zamba2's prefill and decode;
              RMSNorm at 512 and 8 rows of 1024, 8 of 1536 and 3072,
              2000 of 3584 and 7168; the SSD scan at mamba2's and
              zamba2's prefill; paged at olmoe's and mixtral's 8-row
              decode, flash at olmoe's 512 prefill and whisper's encoder
              and cross-attention, RMSNorm at 512 and 8 rows of 2048; the
              backward kernels at phase 10's shapes: flash at olmo's and
              qwen's B=8 x S=512 in bf16 (tensor cores), at olmo's in
              fp32 (CUDA cores) and at whisper's encoder (1500 frames)
              and cross-attention (448 x 1500) in bf16, RMSNorm at
              qwen's 4096 x 1024, olmoe's 4096 x 2048, mamba2's 1536 and
              3072 and zamba2's 3584 and 7168 wide, flash at
              zamba2's B=8 x S=512, H=32, D=112 and the SSD backward at
              mamba2's and zamba2's training calls (no library call
              computes it), beside autograd's backward of the plain
              version and of bf16 SDPA / ``F.rms_norm``: graphs of forward
              and backward less the forward's).  Every call reads cold
              inputs: the copies cycled through read more than twice the
              L2 a cycle.
              A time under its bound / 1.05 fails the run;
then the ``launches`` and ``kernels`` lines (phases 6, 7, 8, 9, 4f, 10,
11 and 12's launches among the paths, phases 11 and 12 per rank, the
backward kernels B5, B6 and B8 counted apart), and
the contract line ``{"ok": true, "device":
{...}}``, last.

It imports torch, numpy and ``repro_torch`` only (no JAX).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
FP32_FLOPS = 67e12              # fp32 outside the tensor cores
L2_BYTES = 50e6                 # H100 SXM L2 cache
BOUND_SLACK = 1.05              # a timed kernel under bound / 1.05 fails
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SSD_TOL = 2e-4                  # fp32 SSD outputs: sums run in another order
PROMPT_LENS = (120, 250, 500)   # the full-width trace's prompt lengths
LONG_KV_TOL = 6e-3              # non-causal bf16 flash over 1500 keys: the
                                # outputs' RMS is ~0.04, so 2e-2 would pass a
                                # dropped 28-key tail; errors seen on an H100
                                # are 2.0e-3 and 9.8e-4
BWD_EMU_TOL = {"atol_of_max": 2e-3,     # the bf16 flash backward against
               "rtol": 2 ** -7}         # the emulation of its contract:
                                        # one bf16 ulp of a gradient, plus
                                        # 2e-3 of the largest |grad| for
                                        # fp32 sums in another order
GAP_NOISE = 1e-5                # a routing flip at a smaller router gap
                                # (k-th less (k+1)-th probability) is fp32
                                # noise between two summation orders


T_START = time.perf_counter()   # the script's start, for ``emit``'s t_s


def emit(obj) -> None:
    """One JSON line on stdout.  A phase's line gets ``t_s``, the seconds
    since the script started, and a line on stderr with its phase and
    check, so a run stopped at its time limit shows how far it got."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
        print(f"smoke: {obj['phase']} {obj.get('check', '')} at "
              f"{obj['t_s']:.1f} s", file=sys.stderr, flush=True)
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cold_copies(nbytes: float) -> int:
    """Input copies whose one cycle reads more than twice the L2, for a
    call that reads ``nbytes``: cycled through, every call reads cold."""
    return int(2 * L2_BYTES // nbytes) + 1


def time_ms(fn, n_inputs: int = 1, reps: int = 20, trials: int = 7):
    """Median device time of one ``fn(i)`` call: ``max(reps, n_inputs)``
    calls (cycling ``i`` over ``n_inputs`` input copies, each read once
    a cycle: see ``cold_copies``) captured in a CUDA graph, replayed
    ``trials`` times between CUDA events."""
    import torch
    reps = max(reps, n_inputs)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i % n_inputs)
    graph.replay()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def backward_ms(forward, sets):
    """Device time of autograd's backward of ``forward`` on input copy
    ``i`` (``sets[i]``: the inputs, which require a gradient, and the
    output's gradient): a CUDA graph of forward and backward, less one of
    the forward alone (run with grad enabled, as in training)."""
    import torch
    both = time_ms(lambda i: torch.autograd.grad(
        forward(*sets[i][0]), sets[i][0], sets[i][1]), len(sets))
    return both - time_ms(lambda i: forward(*sets[i][0]), len(sets))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def within(got, want, tol) -> bool:
    import torch
    return bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))


def paged_inputs(gen, B, H, KV, D, ps, PMAX, lengths, q_dtype, kv_dtype,
                 device):
    """One decode batch over a pool of B*PMAX + 1 pages, each row on its
    own shuffled pages."""
    import torch
    P = B * PMAX + 1
    q = torch.randn(B, H, D, generator=gen, device=device).to(q_dtype)
    kp = torch.randn(P, ps, KV, D, generator=gen, device=device).to(kv_dtype)
    vp = torch.randn(P, ps, KV, D, generator=gen, device=device).to(kv_dtype)
    perm = torch.randperm(P - 1, generator=gen, device=device)
    table = perm.reshape(B, PMAX).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, kp, vp, table, lens


def ssd_inputs(gen, B, S, H, G, N, dtype, device, P=64):
    """SSD scan inputs: x and B/C in ``dtype``, fp32 dt > 0, A < 0, D = 1
    (the reference suite's scales)."""
    import torch
    x = torch.randn(B, S, H, P, generator=gen, device=device).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device=device))
    A = -torch.exp(0.5 * torch.randn(H, generator=gen, device=device))
    Bm, Cm = ((torch.randn(B, S, G, N, generator=gen, device=device)
               / N ** 0.5).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm, torch.ones(H, device=device)


def kernel_checks(device):
    import itertools

    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan

    gen = torch.Generator(device=device).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}

    def record(name, case, got, want, tol):
        torch.cuda.synchronize()
        e = max_err(got, want)
        ok = within(got, want, tol) and bool(torch.isfinite(got).all())
        emit({"phase": "kernels", "kernel": name, "case": case,
              "max_abs_err": e, "tol": tol, "ok": ok})
        check(ok, f"{name} {case}: max err {e} > tol {tol}")
        return e

    # paged: the serving path's shape, bf16 queries on an fp32 pool
    for B, lens in ((1, [300]), (8, [0, 1, 64, 65, 200, 333, 512, 576])):
        args = paged_inputs(gen, B, 16, 16, 64, 64, 16, lens, bf16, f32,
                            device)
        got = paged_decode_attention(*args)
        want = ref.paged_attention_ref(*args)
        errs["paged_attention"] = record(
            "paged_attention", f"B={B} H=KV=16 D=64 ps=64 q=bf16 pages=fp32",
            got, want, TOL["bfloat16"])
        if 0 in lens:
            check(bool((got[lens.index(0)] == 0).all()),
                  "paged: a zero-length row is not exactly zero")
    args = paged_inputs(gen, 4, 32, 8, 128, 16, 12, [0, 5, 100, 191],
                        f32, f32, device)
    record("paged_attention", "B=4 H=32 KV=8 D=128 ps=16 window=40 fp32",
           paged_decode_attention(*args, sliding_window=40),
           ref.paged_attention_ref(*args, sliding_window=40),
           TOL["float32"])

    # bitwise layout invariance: the same logical KV on other pages
    q, kp, vp, table, lens = paged_inputs(
        gen, 8, 16, 16, 64, 64, 16, [576, 3, 64, 129, 0, 400, 511, 250],
        bf16, f32, device)
    perm = torch.randperm(kp.shape[0], generator=gen, device=device)
    kp2 = torch.empty_like(kp)
    vp2 = torch.empty_like(vp)
    kp2[perm] = kp
    vp2[perm] = vp
    table2 = perm[table.long()].to(torch.int32)
    out1 = paged_decode_attention(q, kp, vp, table, lens)
    out2 = paged_decode_attention(q, kp2, vp2, table2, lens)
    torch.cuda.synchronize()
    same = bool(torch.equal(out1, out2))
    emit({"phase": "kernels", "kernel": "paged_attention",
          "case": "bitwise layout invariance", "ok": same})
    check(same, "paged: output changed with the physical page layout")
    # bitwise row independence: each row decoded alone (B = 1, with the
    # full table row and with one cut to its live pages) equals its row
    # of the B = 8 batch, as the engine moves rows between buckets
    alone_ok = True
    for b, n in enumerate(lens.tolist()):
        for width in (table.shape[1], max(1, -(-n // 64))):
            one = paged_decode_attention(
                q[b:b + 1].contiguous(), kp, vp,
                table[b:b + 1, :width].contiguous(), lens[b:b + 1])
            alone_ok &= bool(torch.equal(one[0], out1[b]))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel": "paged_attention",
          "case": "bitwise row independence, B=1 vs B=8", "ok": alone_ok})
    check(alone_ok, "paged: a row's output changed with its batch")
    # a bf16 pool of 16-token pages, GQA G=4, a 40-token window whose
    # start falls inside a 64-position split for most rows
    args = paged_inputs(gen, 8, 32, 8, 64, 16, 16,
                        [0, 1, 16, 17, 100, 130, 250, 256], bf16, bf16,
                        device)
    got = paged_decode_attention(*args, sliding_window=40)
    record("paged_attention", "B=8 H=32 KV=8 D=64 ps=16 window=40 q=bf16 "
           "pages=bf16", got,
           ref.paged_attention_ref(*args, sliding_window=40),
           TOL["bfloat16"])
    check(bool((got[0] == 0).all()),
          "paged: a zero-length row is not exactly zero")
    # the pooled path's shape (phase 6): bf16 q over an fp32 pool of
    # 16-token pages, H=KV=16, D=64, a table of 8 pages, so each
    # 64-position split crosses 4 pages; then each row decoded alone and
    # in pairs (the engine's 1- and 2-row buckets) equals its row of B=4
    for lens in ([0, 17, 65, 128], [1, 33, 64, 100]):
        q, kp, vp, table, lt = paged_inputs(gen, 4, 16, 16, 64, 16, 8, lens,
                                            bf16, f32, device)
        out4 = paged_decode_attention(q, kp, vp, table, lt)
        record("paged_attention", f"B=4 H=KV=16 D=64 ps=16 pages=8 "
               f"lens={lens} q=bf16 pages=fp32", out4,
               ref.paged_attention_ref(q, kp, vp, table, lt),
               TOL["bfloat16"])
        if 0 in lens:
            check(bool((out4[lens.index(0)] == 0).all()),
                  "paged: a zero-length row is not exactly zero")
        alone_ok = True
        for b, n in enumerate(lens):
            for width in (table.shape[1], max(1, -(-n // 16))):
                one = paged_decode_attention(
                    q[b:b + 1].contiguous(), kp, vp,
                    table[b:b + 1, :width].contiguous(), lt[b:b + 1])
                alone_ok &= bool(torch.equal(one[0], out4[b]))
        for b in (0, 2):
            two = paged_decode_attention(q[b:b + 2].contiguous(), kp, vp,
                                         table[b:b + 2].contiguous(),
                                         lt[b:b + 2])
            alone_ok &= bool(torch.equal(two, out4[b:b + 2]))
        torch.cuda.synchronize()
        emit({"phase": "kernels", "kernel": "paged_attention",
              "case": f"bitwise row independence ps=16, B=1 and B=2 vs "
                      f"B=4, lens={lens}", "ok": alone_ok})
        check(alone_ok, "paged ps=16: a row's output changed with its batch")
    # the disaggregated decode tier's shape (phase 7): 4 rows of 224..240
    # tokens over 15-page tables of 16-token pages
    args = paged_inputs(gen, 4, 16, 16, 64, 16, 15, [224, 229, 235, 240],
                        bf16, f32, device)
    record("paged_attention", "B=4 H=KV=16 D=64 ps=16 pages=15 "
           "lens=[224, 229, 235, 240] q=bf16 pages=fp32",
           paged_decode_attention(*args), ref.paged_attention_ref(*args),
           TOL["bfloat16"])
    # the colocation engines' shape (phase 8): 6 slots (row buckets 1, 2,
    # 4 and 6) over 10-page tables of 16-token pages, 33..160 tokens; each
    # row alone, in pairs and in fours equals its row of B = 6
    lens = [33, 48, 97, 128, 150, 160]
    q, kp, vp, table, lt = paged_inputs(gen, 6, 16, 16, 64, 16, 10, lens,
                                        bf16, f32, device)
    out6 = paged_decode_attention(q, kp, vp, table, lt)
    record("paged_attention", f"B=6 H=KV=16 D=64 ps=16 pages=10 lens={lens} "
           f"q=bf16 pages=fp32", out6,
           ref.paged_attention_ref(q, kp, vp, table, lt), TOL["bfloat16"])
    alone_ok = True
    for n in (1, 2, 4):
        for b in range(0, 6 - n + 1, n):
            part = paged_decode_attention(q[b:b + n].contiguous(), kp, vp,
                                          table[b:b + n].contiguous(),
                                          lt[b:b + n])
            alone_ok &= bool(torch.equal(part, out6[b:b + n]))
    torch.cuda.synchronize()
    emit({"phase": "kernels", "kernel": "paged_attention",
          "case": f"bitwise row independence ps=16 pages=10, B=1, 2 and 4 "
                  f"vs B=6, lens={lens}", "ok": alone_ok})
    check(alone_ok, "paged B=6: a row's output changed with its batch")

    # flash, bf16 q (the tensor-core kernel): every Sq bucket (32: the
    # colocation engines' prefill) and a decode query, each head_dim, K/V
    # as the fp32 cache holds them and in bf16, MHA and GQA G=4; then the
    # masks the served paths use
    flash_grid = [(Sq, D, kv, G)
                  for Sq in (1, 15, 32, 64, 65, 130, 500, 512, 1024)
                  for D in (64, 112, 128) for kv in (f32, bf16) for G in (1, 4)]
    for Sq, D, kv, G in flash_grid:
        H = 8 if Sq <= 512 else 4
        q = torch.randn(1, Sq, H, D, generator=gen, device=device).to(bf16)
        k, v = (torch.randn(1, Sq, H // G, D, generator=gen,
                            device=device).to(kv) for _ in range(2))
        got = flash_attention(q, k, v, causal=True)
        with ops.plain_versions():
            want = ops.flash_attention(q, k, v, causal=True)
        e = record("flash_attention",
                   f"B=1 Sq=Skv={Sq} H={H} G={G} D={D} q=bf16 "
                   f"kv={str(kv)[6:]}", got, want, TOL["bfloat16"])
        if (Sq, D, kv, G) == (512, 64, f32, 1):
            errs["flash_attention"] = e
    # window, q_offset and kv_len < Skv together; with window 8 and
    # kv_len 13, rows 20.. see no key and must be exact zeros
    for D, kv in ((64, f32), (112, f32), (128, bf16)):
        q = torch.randn(2, 70, 8, D, generator=gen, device=device).to(bf16)
        k, v = (torch.randn(2, 96, 2, D, generator=gen, device=device).to(kv)
                for _ in range(2))
        for kw in (dict(sliding_window=24, q_offset=10, kv_len=80),
                   dict(sliding_window=8, q_offset=0, kv_len=13)):
            got = flash_attention(q, k, v, causal=True, **kw)
            with ops.plain_versions():
                want = ops.flash_attention(q, k, v, causal=True, **kw)
            record("flash_attention", f"GQA G=4 D={D} kv={str(kv)[6:]} "
                   + " ".join(f"{a}={b}" for a, b in kw.items()),
                   got, want, TOL["bfloat16"])
            if kw["kv_len"] == 13:
                zero = bool((got[:, 20:] == 0).all()
                            and (got[:, :20] != 0).any())
                emit({"phase": "kernels", "kernel": "flash_attention",
                      "case": f"D={D} rows with no visible key are exact "
                              f"zeros", "ok": zero})
                check(zero, "flash: a row with no visible key is not zero")
    # fp32 q: the CUDA-core kernel, held at the fp32 tolerance
    q = torch.randn(2, 70, 8, 128, generator=gen, device=device)
    k = torch.randn(2, 96, 2, 128, generator=gen, device=device)
    v = torch.randn(2, 96, 2, 128, generator=gen, device=device)
    for D in (64, 112, 128):
        record("flash_attention",
               f"fp32 q GQA G=4 D={D} window=24 q_offset=10 kv_len=80",
               flash_attention(q[..., :D].contiguous(), k[..., :D].contiguous(),
                               v[..., :D].contiguous(), causal=True,
                               sliding_window=24, q_offset=10, kv_len=80),
               ref.attention_ref(q[..., :D].transpose(1, 2),
                                 k[..., :D].transpose(1, 2),
                                 v[..., :D].transpose(1, 2),
                                 sliding_window=24, q_offset=10,
                                 kv_len=80).transpose(1, 2),
               TOL["float32"])

    # flash at head_dim 112: zamba2's shared block, prefill over the fp32
    # contiguous cache (kv_len masks its unwritten tail) and one decode
    # query at an offset
    q = torch.randn(2, 500, 32, 112, generator=gen, device=device).to(bf16)
    k = torch.randn(2, 516, 32, 112, generator=gen, device=device)
    v = torch.randn(2, 516, 32, 112, generator=gen, device=device)
    for Sq, off in ((500, 0), (1, 507)):
        args = (q[:, :Sq].contiguous(), k, v)
        kw = dict(causal=True, q_offset=off, kv_len=off + Sq)
        got = flash_attention(*args, **kw)
        with ops.plain_versions():
            want = ops.flash_attention(*args, **kw)
        e = record("flash_attention",
                   f"B=2 Sq={Sq} Skv=516 kv_len={off + Sq} H=KV=32 D=112 "
                   f"q=bf16 kv=fp32", got, want, TOL["bfloat16"])
        if Sq == 500:
            errs["flash_attention_d112"] = e

    # the moe and encdec paths (phases 9 and 4f): paged decode over bf16
    # pools of 64-token pages at olmoe's heads (H=KV=16, D=128) and
    # mixtral's (H=32, KV=8, D=128, with its 4096-token window); flash at
    # olmoe's 512-token prefill over the bf16 slot cache, whisper's
    # non-causal encoder (1500 frames, H=12, D=64) and cross-attention
    # (64 and 1 queries over 1500 frames) on bf16 K/V, and its decoder's
    # causal self-attention over the fp32 cache (prefill and one decode
    # query)
    for name, H, KV, lens, window in (
            ("olmoe", 16, 16, [120, 184, 250, 314, 500, 563, 377, 440], None),
            ("mixtral", 32, 8, [120, 151, 250, 281, 1, 64, 200, 130], 4096)):
        args = paged_inputs(gen, 8, H, KV, 128, 64, 16, lens, bf16, bf16,
                            device)
        errs[f"paged_attention_{name}"] = record(
            "paged_attention", f"{name} decode B=8 H={H} KV={KV} D=128 "
            f"ps=64 q=bf16 pages=bf16 window={window}",
            paged_decode_attention(*args, sliding_window=window),
            ref.paged_attention_ref(*args, sliding_window=window),
            TOL["bfloat16"])
    flash_paths = [
        ("olmoe prefill", 1, 512, 512, 16, 128, True, bf16, {}),
        ("whisper encoder", 4, 1500, 1500, 12, 64, False, bf16, {}),
        ("whisper cross prefill", 4, 64, 1500, 12, 64, False, bf16, {}),
        ("whisper cross decode", 4, 1, 1500, 12, 64, False, bf16, {}),
        ("whisper self prefill", 4, 64, 96, 12, 64, True, f32,
         dict(kv_len=64)),
        ("whisper self decode", 4, 1, 96, 12, 64, True, f32,
         dict(q_offset=80, kv_len=81))]
    # the last case lifts V on the ragged last tile's 28 keys (1500 =
    # 23*64 + 28) by 4: a dropped or doubled tail moves every output by
    # about 4 * 28/1500 = 0.07, far past LONG_KV_TOL
    flash_paths.append(("whisper encoder, lifted tail", 1, 1500, 1500, 12,
                        64, False, bf16, {}))
    for tag, B, Sq, Skv, H, D, causal, kv, kw in flash_paths:
        q = torch.randn(B, Sq, H, D, generator=gen, device=device).to(bf16)
        k, v = (torch.randn(B, Skv, H, D, generator=gen, device=device).to(kv)
                for _ in range(2))
        if tag.endswith("lifted tail"):
            v[:, Skv - Skv % 64:] += 4
        got = flash_attention(q, k, v, causal=causal, **kw)
        with ops.plain_versions():
            want = ops.flash_attention(q, k, v, causal=causal, **kw)
        tol = TOL["bfloat16"] if causal or Skv != 1500 else LONG_KV_TOL
        errs[f"flash_attention {tag}"] = record(
            "flash_attention", f"{tag} B={B} Sq={Sq} Skv={Skv} H={H} D={D} "
            f"causal={causal} q=bf16 kv={str(kv)[6:]} "
            + " ".join(f"{a}={b}" for a, b in kw.items()), got, want, tol)

    # ssd: the serving shapes (bf16 x and B/C, fp32 dt, the zero fp32
    # state the prefill passes from the cache) on the tensor-core kernel,
    # y at the bf16 tolerance and the fp32 state at 2e-4; then the
    # tensor-core grid (S 1..1000, chunk 64 / 128, N 64 / 128, P 32 / 64,
    # G 1 / 2, with and without an initial state); then fp32 cases with a
    # random initial state, G = 2 and a prompt shorter than one chunk on
    # the CUDA-core kernel
    def ssd_case(variant, tag, args, chunk, h0, y_tol, emit_each=True):
        kernels.reset_launch_counts()
        y, h = ssd_scan(*args, chunk=chunk, init_state=h0)
        got = kernels.variant_counts()
        check(got[f"ssd_scan.{variant}"] == 1
              and kernels.launch_counts()["ssd_scan"] == 1,
              f"ssd {tag}: ran on {got}, expected the {variant} kernel")
        wy, wh = ref.ssd_chunked_ref(*args, chunk, init_state=h0)
        if emit_each:
            e = record("ssd_scan", f"{tag} y", y, wy, y_tol)
            record("ssd_scan", f"{tag} state", h, wh, SSD_TOL)
            return e, 0.0
        torch.cuda.synchronize()
        ok = (within(y, wy, y_tol) and within(h, wh, SSD_TOL)
              and bool(torch.isfinite(y).all()))
        check(ok, f"ssd {tag}: y err {max_err(y, wy)}, state err "
              f"{max_err(h, wh)}")
        return max_err(y, wy), max_err(h, wh)

    for arch, B, H, N in (("mamba2", 8, 48, 128), ("zamba2", 4, 112, 64)):
        args = ssd_inputs(gen, B, 500, H, 1, N, bf16, device)
        h0 = torch.zeros(B, H, 64, N, device=device)
        e, _ = ssd_case("tc", f"{arch} B={B} S=500 H={H} P=64 N={N} G=1 "
                        f"Q=128 bf16", args, 128, h0, TOL["bfloat16"])
        if arch == "mamba2":
            errs["ssd_scan"] = e
    worst = [0.0, 0.0]
    n_cases = 0
    for S in (1, 100, 128, 129, 500, 1000):
        for chunk, N, P, G, init in itertools.product(
                (64, 128), (64, 128), (32, 64), (1, 2), (False, True)):
            args = ssd_inputs(gen, 2, S, 4, G, N, bf16, device, P=P)
            h0 = (torch.randn(2, 4, P, N, generator=gen, device=device)
                  if init else None)
            ey, eh = ssd_case("tc", f"S={S} chunk={chunk} N={N} P={P} "
                              f"G={G} init={init}", args, chunk, h0,
                              TOL["bfloat16"], emit_each=False)
            worst = [max(worst[0], ey), max(worst[1], eh)]
            n_cases += 1
    emit({"phase": "kernels", "kernel": "ssd_scan",
          "case": f"tensor-core grid, {n_cases} cases (B=2 H=4 bf16)",
          "max_abs_err_y": worst[0], "tol_y": TOL["bfloat16"],
          "max_abs_err_state": worst[1], "tol_state": SSD_TOL, "ok": True})
    for case, (B, S, H, G, N, chunk) in {
            "fp32 init_state": (2, 300, 8, 1, 128, 128),
            "fp32 G=2 init_state": (2, 260, 8, 2, 64, 64),
            "fp32 S=100<Q init_state": (3, 100, 4, 1, 128, 128)}.items():
        args = ssd_inputs(gen, B, S, H, G, N, f32, device)
        h0 = torch.randn(B, H, 64, N, generator=gen, device=device)
        ssd_case("f32", f"B={B} S={S} H={H} G={G} N={N} chunk={chunk} "
                 f"{case}", args, chunk, h0, SSD_TOL)

    # rmsnorm: the model's rows and widths, activations and scale in the
    # compute dtype.  qwen1.5-0.5b: d = 64 (qk rows) and 1024, at the
    # colocation engines' decode rows (1, 2, 4, 6) and a 32-token prefill;
    # the recurrent paths: d_model 1536 / 3584 and the gated norm's d_inner
    # 3072 / 7168 (d > 2048: a 256-thread block per row), at decode's 4 /
    # 8 rows, the logits check's 500 and a prefill's 4000 (mamba2: 8 x
    # 500); then 512 rows (qwen's largest bucket), 3 / 33 (not a multiple
    # of the rows a block takes), d = 1000 (vectors, 125 a row) and 1001
    # (the scalar branch: a tail, and rows not 16-byte aligned)
    grid = [(rows, d, bf16) for rows in (1, 2, 4, 6, 7, 32, 300)
            for d in (64, 1024)]
    grid += [(rows, d, dt) for d in (1536, 3072, 3584, 7168)
             for rows in (4, 8, 500, 4000) for dt in (bf16, f32)]
    grid += [(rows, d, dt) for rows in (3, 33, 512, 4000)
             for d in (64, 1000, 1001, 1024) for dt in (bf16, f32)]
    # the moe path's d_model 2048 (olmoe): a 512-token prefill, 8 rows
    grid += [(rows, 2048, dt) for rows in (8, 512) for dt in (bf16, f32)]
    for rows, d, dt in grid:
        x = torch.randn(rows, d, generator=gen, device=device).to(dt)
        s = (1 + 0.1 * torch.randn(d, generator=gen, device=device)).to(dt)
        name = str(dt).split(".")[-1]
        e = record("rmsnorm", f"rows={rows} d={d} {name}", rmsnorm(x, s),
                   ref.rmsnorm_ref(x, s), TOL[name])
        if dt == bf16:
            errs["rmsnorm"] = max(errs.get("rmsnorm", 0.0), e)
    # a row view that starts 2 bytes past a 16-byte boundary
    x = torch.randn(33 * 1024 + 1, generator=gen, device=device).to(bf16)
    x = x[1:].view(33, 1024)
    s = torch.ones(1024, device=device, dtype=bf16)
    record("rmsnorm", "rows=33 d=1024 bf16 misaligned", rmsnorm(x, s),
           ref.rmsnorm_ref(x, s), TOL["bfloat16"])
    return errs


def backward_checks(device):
    """Phase 3's training cases: each backward kernel, through its
    autograd Function, against autograd of its plain version on the same
    inputs (the plain forward in fp32), run twice and required to give
    the same bits.  Flash: olmo's shape (B=2, S=512, H=KV=16, D=128;
    olmoe's too), qwen's (D=64), GQA (H=32, KV=8, D=128, window 128),
    non-causal 64 queries over 300 keys, whisper's encoder (1500 frames,
    non-causal, H=12, D=64: a ragged 28-key tail), cross-attention (448
    queries over 1500 frames) and decoder (448, causal), all bf16 on the
    tensor-core kernel, and the
    fp32 CUDA-core kernel at D=64; RMSNorm at 4096 x 1024 (qwen's, the
    warp-per-row branch) and 4096 x 2048 (olmoe's, block-per-row) in
    bf16 and fp32, and at mamba2's 1536 (bf16, fp32) and 3072 and
    zamba2's 3584 and 7168 (bf16), block-per-row.  Each gradient is held
    to its dtype's tolerance of its largest
    |value| (bf16 2e-2, fp32 1e-5), as the forward's cases at these
    shapes; each bf16 flash case also to the emulation of the tensor-core
    kernel's contract (``tests/_flash_bwd_emulation.py``, on the
    kernel's own forward output and log-sum-exp) at ``BWD_EMU_TOL``.
    Flash at zamba2's training shape too (B=8, S=512, H=KV=32, D=112),
    in bf16 (tensor cores) and fp32.  Returns the max errors of olmo's and
    zamba2's bf16 flash cases and the bf16 RMSNorm case."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _flash_bwd_emulation import flash_bwd_tc_emulation

    gen = torch.Generator(device=device).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}

    def hold(kernel, case, runs, want, tol):
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        errs_case, scales = [], []
        for got, w in zip(runs[0], want):
            errs_case.append(max_err(got, w))
            scales.append(float(w.float().abs().max()))
        ok = same and all(e <= tol * s for e, s in zip(errs_case, scales)) \
            and all(bool(torch.isfinite(g).all()) for g in runs[0])
        emit({"phase": "kernels", "kernel": kernel, "case": case,
              "max_abs_err": errs_case, "max_abs_grad": scales,
              "tol_of_max_grad": tol, "same_bits_twice": same, "ok": ok})
        check(ok, f"{kernel} {case}: errors {errs_case} against {tol} of "
              f"{scales}, same bits twice: {same}")
        return max(errs_case)

    for tag, B, Sq, Skv, H, KV, D, dt, kw in (
            ("olmo", 2, 512, 512, 16, 16, 128, bf16, {}),
            ("qwen", 2, 512, 512, 16, 16, 64, bf16, {}),
            ("GQA window 128", 2, 512, 512, 32, 8, 128, bf16,
             dict(sliding_window=128)),
            ("non-causal", 2, 64, 300, 8, 8, 64, bf16, dict(causal=False)),
            ("whisper encoder", 2, 1500, 1500, 12, 12, 64, bf16,
             dict(causal=False)),
            ("whisper cross", 2, 448, 1500, 12, 12, 64, bf16,
             dict(causal=False)),
            ("whisper decoder", 2, 448, 448, 12, 12, 64, bf16, {}),
            ("fp32", 2, 512, 512, 16, 16, 64, f32, {}),
            ("zamba2", 8, 512, 512, 32, 32, 112, bf16, {}),
            ("zamba2 fp32", 8, 512, 512, 32, 32, 112, f32, {})):
        q = torch.randn(B, Sq, H, D, generator=gen, device=device).to(dt)
        k, v = (torch.randn(B, Skv, KV, D, generator=gen,
                            device=device).to(dt) for _ in range(2))
        dout = torch.randn(B, Sq, H, D, generator=gen, device=device).to(dt)
        variant = "tc" if dt == bf16 else "f32"
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            kernels.reset_launch_counts()
            flash_attention(*leaves, **kw).backward(dout)
            got = kernels.backward_variant_counts()
            check(kernels.backward_counts()["flash_attention_bwd"] == 1
                  and got[f"flash_attention_bwd.{variant}"] == 1,
                  f"flash backward {tag}: not one backward launch on the "
                  f"{variant} kernel: {got}")
            runs.append([t.grad for t in leaves])
        plain = [t.float().requires_grad_(True) for t in (q, k, v)]
        with ops.plain_versions():
            ops.flash_attention(*plain, **kw).backward(dout.float())
        case = (f"{tag} B={B} Sq={Sq} Skv={Skv} H={H} KV={KV} D={D} "
                f"{str(dt)[6:]} " + " ".join(f"{a}={b}" for a, b in
                                             kw.items()))
        e = hold("flash_attention_bwd", case, runs,
                 [t.grad for t in plain], TOL[str(dt)[6:]])
        if tag == "olmo":
            errs["flash_attention_bwd"] = e
        if tag == "zamba2":
            errs["flash_attention_bwd d112"] = e
        if dt == bf16:
            lse = torch.empty((B, H, Sq), dtype=f32, device=device)
            out = fa._launch_forward(q, k, v, kw.get("causal", True),
                                     kw.get("sliding_window"),
                                     1.0 / D ** 0.5, 0, Skv, lse)
            want = flash_bwd_tc_emulation(q, k, v, dout, **kw, out=out,
                                          lse=lse)
            emu = []
            for got, w in zip(runs[0], want):
                d_ = (got.float() - w.float()).abs()
                scale = float(w.float().abs().max())
                limit = (BWD_EMU_TOL["atol_of_max"] * scale
                         + BWD_EMU_TOL["rtol"] * w.float().abs())
                emu.append((float(d_.max()), scale,
                            bool((d_ <= limit).all())))
            ok = all(x[2] for x in emu)
            emit({"phase": "kernels", "kernel": "flash_attention_bwd",
                  "case": case + " vs emulation",
                  "max_abs_err": [x[0] for x in emu],
                  "max_abs_grad": [x[1] for x in emu],
                  "tol": BWD_EMU_TOL, "ok": ok})
            check(ok, f"flash backward {case}: against the emulation "
                  f"{emu} over {BWD_EMU_TOL}")
    # d=1024 (qwen) takes the warp-per-row branch; olmoe's 2048,
    # mamba2's 1536 and 3072 and zamba2's 3584 and 7168 the block-per-row
    # one (rows in the team's registers)
    for d, dt in ((1024, bf16), (1024, f32), (2048, bf16), (2048, f32),
                  (1536, bf16), (1536, f32), (3072, bf16), (3584, bf16),
                  (7168, bf16)):
        x = torch.randn(4096, d, generator=gen, device=device).to(dt)
        s = (1 + 0.1 * torch.randn(d, generator=gen, device=device)).to(dt)
        dy = torch.randn(4096, d, generator=gen, device=device).to(dt)
        runs = []
        for _ in range(2):
            xx, ss = (t.clone().requires_grad_(True) for t in (x, s))
            kernels.reset_launch_counts()
            rmsnorm(xx, ss).backward(dy)
            check(kernels.backward_counts()["rmsnorm_bwd"] == 1,
                  f"rmsnorm backward d={d}: not one backward launch: "
                  f"{kernels.backward_counts()}")
            runs.append([xx.grad, ss.grad])
        xx, ss = (t.clone().requires_grad_(True) for t in (x, s))
        ref.rmsnorm_ref(xx, ss).backward(dy)
        e = hold("rmsnorm_bwd", f"rows=4096 d={d} {str(dt)[6:]}", runs,
                 [xx.grad, ss.grad], TOL[str(dt)[6:]])
        if d == 1024 and dt == bf16:
            errs["rmsnorm_bwd"] = e
    return errs


SSD_BWD_EMU_TOL = {"atol_of_max": SSD_TOL,    # the SSD backward against
                   "rtol": 2 ** -7}            # the emulation of its
                                               # contract: fp32 sums in
                                               # other orders, and one
                                               # bf16 ulp of dx, dB, dC


def ssd_backward_checks(device):
    """Phase 3's SSD backward (B8) cases: through ``SSDScanFn`` (the
    forward kernel, then the backward kernel) against autograd of the
    plain version on fp32 copies of the same inputs, each gradient (dx,
    ddt, dA, dB, dC, dD, and dh0 where there is an initial state) to its
    dtype's tolerance of its largest |value| (bf16 2e-2, fp32
    ``SSD_TOL``), and at ``SSD_BWD_EMU_TOL`` against the emulation of
    the kernel it ran: bf16 the tensor-core kernel's contract
    (``tests/_ssd_bwd_tc_emulation.py``), fp32 the CUDA-core kernel's
    algorithm (``tests/_ssd_bwd_emulation.py``); each case run twice,
    required to give the same bits, one forward and one backward launch,
    the backward on its dtype's kernel.  Shapes: mamba2's training call
    (B=8, S=512, H=48, P=64, G=1, N=128, Q=128) and zamba2's (H=112,
    N=64), a ragged S=300 with G=2 and an initial state whose final state
    has a gradient, in bf16 and fp32.  Returns the max error of mamba2's
    bf16 case."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan import ssd_scan
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _ssd_bwd_emulation import ssd_bwd_emulation
    from _ssd_bwd_tc_emulation import ssd_bwd_tc_emulation

    gen = torch.Generator(device=device).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
    out = None
    for tag, B, S, H, G, N, dt, init in (
            ("mamba2", 8, 512, 48, 1, 128, bf16, False),
            ("mamba2", 8, 512, 48, 1, 128, f32, False),
            ("zamba2", 8, 512, 112, 1, 64, bf16, False),
            ("zamba2", 8, 512, 112, 1, 64, f32, False),
            ("ragged G=2 h0", 2, 300, 8, 2, 128, bf16, True),
            ("ragged G=2 h0", 2, 300, 8, 2, 128, f32, True)):
        args = ssd_inputs(gen, B, S, H, G, N, dt, device)
        h0 = (torch.randn(B, H, 64, N, generator=gen, device=device)
              if init else None)
        dy = torch.randn(B, S, H, 64, generator=gen, device=device).to(dt)
        dst = (torch.randn(B, H, 64, N, generator=gen, device=device)
               if init else None)
        outs = [dy] + ([dst] if init else [])
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_(True) for t in args] + (
                [h0.clone().requires_grad_(True)] if init else [])
            kernels.reset_launch_counts()
            y, st = ssd_scan(*leaves[:6], chunk=128,
                             init_state=leaves[6] if init else None)
            torch.autograd.backward([y] + ([st] if init else []), outs)
            got = (kernels.launch_counts()["ssd_scan"],
                   kernels.backward_counts()["ssd_scan_bwd"],
                   kernels.backward_variant_counts()[
                       f"ssd_scan_bwd.{'tc' if dt == bf16 else 'f32'}"])
            check(got == (1, 1, 1), f"ssd backward {tag}: launches "
                  f"(forward, backward, backward on the {dt} kernel) "
                  f"{got}, expected (1, 1, 1)")
            runs.append([t.grad for t in leaves])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        plain = [t.detach().float().clone().requires_grad_(True)
                 for t in list(args) + ([h0] if init else [])]
        y, st = ref.ssd_chunked_ref(*plain[:6], 128,
                                    init_state=plain[6] if init else None)
        torch.autograd.backward([y] + ([st] if init else []),
                                [o.float() for o in outs])
        with torch.no_grad():
            if dt == bf16:
                emu = ssd_bwd_tc_emulation(
                    *args, dy, chunk=128, init_state=h0, dstate=dst,
                    run=ssd.bwd_run(B, S, H, G, 128))
            else:
                emu = ssd_bwd_emulation(*args, dy, chunk=128, init_state=h0,
                                        dstate=dst)
        tol = TOL["bfloat16"] if dt == bf16 else SSD_TOL
        errs, scales, emu_ok = [], [], []
        for got, want, e in zip(runs[0], plain, emu):
            got, w, e = got.float(), want.grad.float(), e.float()
            errs.append(max_err(got, w))
            scales.append(float(w.abs().max()))
            limit = (SSD_BWD_EMU_TOL["atol_of_max"] * float(e.abs().max())
                     + SSD_BWD_EMU_TOL["rtol"] * e.abs())
            emu_ok.append(float(((got - e).abs() - limit).max()))
        finite = all(bool(torch.isfinite(g).all()) for g in runs[0])
        ok = (same and finite and all(x <= 0 for x in emu_ok)
              and all(e <= tol * sc for e, sc in zip(errs, scales)))
        case = (f"{tag} B={B} S={S} H={H} P=64 G={G} N={N} Q=128 "
                f"{str(dt)[6:]}")
        emit({"phase": "kernels", "kernel": "ssd_scan_bwd", "case": case,
              "gradients": names[:len(errs)], "max_abs_err": errs,
              "max_abs_grad": scales, "tol_of_max_grad": tol,
              "emulation_excess_over_tol": emu_ok,
              "emulation_tol": SSD_BWD_EMU_TOL, "same_bits_twice": same,
              "ok": ok})
        check(ok, f"ssd backward {case}: errors {errs} against {tol} of "
              f"{scales}, emulation excess {emu_ok}, same bits twice: "
              f"{same}, finite: {finite}")
        if out is None:
            out = max(errs)
        del runs, plain, emu
    return {"ssd_scan_bwd": out}


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------

def serve_full_width(device):
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tiering import KVBudget
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.serve import (Engine, EngineConfig, latency_summary,
                                   run_trace, synthetic_trace)

    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    tracer = Tracer(1 << 20)
    engine = Engine.local(
        model, EngineConfig(max_slots=8, max_seq=1024, page_size=64),
        generator=gen, budget=KVBudget(tier1_pages=32, tier2_bytes=4e9,
                                       page_size=64),
        tracer=tracer, device=device)
    # prompts end a few tokens short of a page boundary, so decode grows
    # each sequence by a page: page-aligned prompts with 64 new tokens
    # never outgrow their admission pages, and no quota could then force
    # a spill without failing a request OOM
    trace = synthetic_trace(16, prompt_lens=PROMPT_LENS,
                            max_new_tokens=64, mean_interarrival_s=0.002,
                            vocab=cfg.vocab, seed=0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    handles = run_trace(engine, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    variants = kernels.variant_counts()

    stats = engine.stats()
    names = [e.name for e in tracer.events()]
    decodes, prefills = names.count("decode"), names.count("prefill")
    L = cfg.n_layers
    emit({"phase": "serve", "arch": cfg.name, "layers": L,
          "d_model": cfg.d_model, "vocab": cfg.vocab,
          "requests": len(handles), "wall_s": wall,
          "tokens_decoded": stats["tokens_decoded"],
          "tokens_per_s": stats["tokens_decoded"] / wall,
          "prefills": prefills, "decode_steps": decodes,
          "launches": counts, "kernel_variants": variants,
          "latency_modeled": latency_summary(handles),
          "kv": stats["kv"], "preempts": stats["preempts"],
          "swaps": stats["preempt_swaps"],
          "recomputes": stats["preempt_recomputes"],
          "trace_dropped": tracer.dropped})
    check(tracer.dropped == 0, "trace ring dropped events")
    check(stats["completed"] == 16 and stats["failed_oom"] == 0,
          f"not every request finished: {stats['completed']} done, "
          f"{stats['failed_oom']} failed OOM")
    check(all(len(h.tokens) == 64 and all(0 <= t < cfg.vocab
                                           for t in h.tokens)
              for h in handles), "a request's tokens are out of range")
    check(stats["kv"]["spills"] > 0 and stats["kv"]["fetches"] > 0,
          f"no spill/fetch under the 32-page quota: {stats['kv']}")
    check(counts["paged_attention"] == decodes * L,
          f"paged launches {counts['paged_attention']} != "
          f"{decodes} decode steps x {L}")
    check(counts["flash_attention"] == prefills * L,
          f"flash launches {counts['flash_attention']} != "
          f"{prefills} prefills x {L}")
    check_flash_variant(cfg.name, cfg.compute_dtype, variants,
                        counts["flash_attention"])
    check(counts["rmsnorm"] == (decodes + prefills) * (2 * L + 1),
          f"rmsnorm launches {counts['rmsnorm']} != "
          f"{decodes + prefills} calls x {2 * L + 1}")
    # the served bf16 path, kernels vs plain: reported, not gated — bf16
    # rounding flips compound over 24 random-weight layers (phase 3
    # gates each kernel at these shapes in bf16)
    logits_check(model, engine.params, trace[0].prompt_tokens, device,
                 gate=False, n_flash=(L, 0))
    # the same weights, upcast exactly, computed in fp32: gated
    model32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                          device=device)
    logits_check(model32, model32.load(engine.params),
                 trace[0].prompt_tokens, device, gate=True, n_flash=(L, 0))
    del model32
    profile_window(model, engine.params, device)
    return counts, variants, model, engine.params


def profile_window(model, params, device):
    """Where the serving time goes: 8 requests of 250 prompt tokens and
    32 new tokens arriving at once, on the same model and engine shape
    without a quota, run twice plain (the second timed) and once under
    ``torch.profiler``.  The device's busy share is the profiled
    kernel and copy time over the plain run's wall time.  Reported, not
    gated."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import (Engine, EngineConfig, burst_trace,
                                   run_trace)

    def run():
        eng = Engine.local(model, EngineConfig(max_slots=8, max_seq=1024,
                                               page_size=64),
                           params=params, device=device)
        trace = burst_trace(8, prompt_len=250, max_new_tokens=32,
                            vocab=model.cfg.vocab, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_trace(eng, trace)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, eng.steps

    run()
    wall, steps = run()
    # the device's activities alone: only device time is read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled_wall, _ = run()
    emit({"phase": "profile", "requests": 8, "engine_steps": steps,
          "wall_s": wall, "profiled_wall_s": profiled_wall,
          **device_time(prof, wall)})


def device_time(prof, wall: float):
    """The profiled run's device time by kernel name: the busy share is
    the kernel and copy time over ``wall``, the plain run's time."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy_s = sum(t for t, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_busy_s": busy_s if by_name else None,
            "device_busy_share": busy_s / wall if by_name else None,
            "top_device_time": [{"name": k[:90], "ms": t / 1e3, "calls": n}
                                for k, (t, n) in top]}


def check_flash_variant(what, compute, variants, n):
    """``n`` flash launches, all on the variant of the compute dtype: the
    tensor-core kernel for bf16 q, the CUDA-core kernel for fp32 q."""
    on = "tc" if compute == "bfloat16" else "f32"
    got = {v: variants[f"flash_attention.{v}"] for v in ("tc", "f32")}
    want = {v: n if v == on else 0 for v in got}
    check(got == want, f"{what} ({compute}): flash launches by variant "
          f"{got} != {want}")
    return {"launches": got, "expected": want}


def check_ssd_variant(what, compute, variants, n):
    """``n`` SSD launches, all on the variant of the compute dtype: the
    tensor-core kernel for bf16 x, B and C, the CUDA-core kernel for
    fp32."""
    on = "tc" if compute == "bfloat16" else "f32"
    got = {v: variants[f"ssd_scan.{v}"] for v in ("tc", "f32")}
    want = {v: n if v == on else 0 for v in got}
    check(got == want, f"{what} ({compute}): ssd launches by variant "
          f"{got} != {want}")
    return {"launches": got, "expected": want}


def check_step_variant(model, step, n, n_ssd=0):
    """The kernel path of a logits check's ``step`` launched flash ``n``
    times and the SSD scan ``n_ssd`` times, each on its compute dtype's
    variant."""
    from repro_torch import kernels
    cfg = model.cfg
    variants = kernels.variant_counts()
    emit({"phase": "launches", "arch": cfg.name,
          "compute": cfg.compute_dtype,
          "check": f"{step} logits: flash and ssd launches by variant",
          **check_flash_variant(f"{cfg.name} {step}", cfg.compute_dtype,
                                variants, n),
          "ssd": check_ssd_variant(f"{cfg.name} {step}", cfg.compute_dtype,
                                   variants, n_ssd)})


def routing_flips(got, want):
    """Each expert layer's routing on two paths, as ``moe.record_routing``
    recorded it: (the tokens whose experts differ, each with its router
    gap on both paths; the number of differing keep bits; the smallest
    gap on ``got``'s path)."""
    flips, keep_diff, min_gap = [], 0, math.inf
    for layer, (a, b) in enumerate(zip(got, want)):
        min_gap = min(min_gap, float(a["gap"].min()))
        differ = (a["expert_idx"] != b["expert_idx"]).any(-1)    # (G, Tg)
        for g, t in differ.nonzero().tolist():
            flips.append({"layer": layer, "group": g, "token": t,
                          "gap": float(a["gap"][g, t]),
                          "gap_plain": float(b["gap"][g, t])})
        keep_diff += int((a["keep"] != b["keep"]).sum())
    return flips, keep_diff, min_gap


def routing_gate(step, got, want, gate: bool, phase, arch) -> bool:
    """The routing-tie rule: each expert layer's routing (each token's
    experts, each dispatch entry's keep bit) on the kernel path (``got``)
    against the plain path (``want``), as ``moe.record_routing`` recorded
    them.  Reported with the smallest gap between a token's k-th and
    (k+1)-th router probability and every flipped decision with its gap;
    with ``gate``, a flip at a gap of ``GAP_NOISE`` or more (not fp32
    noise) fails the run.  Returns whether to gate the logits: only where
    the routing is equal everywhere.  A path without expert layers
    records nothing and is gated as asked."""
    if not got:
        return gate
    flips, keep_diff, min_gap = routing_flips(got, want)
    equal = not flips and keep_diff == 0
    noise = bool(flips) and all(max(f["gap"], f["gap_plain"]) < GAP_NOISE
                                for f in flips)
    emit({"phase": phase, "arch": arch,
          "check": f"{step} routing, kernels vs plain",
          "layers": len(got), "equal": equal, "min_gap": min_gap,
          "n_flips": len(flips), "flips": flips[:16],
          "keep_differences": keep_diff, "gap_noise": GAP_NOISE,
          "gated": gate, "ok": equal or noise})
    if gate:
        check(equal or noise, f"{arch} {step}: routing differs between the "
              f"kernel and plain paths beyond fp32 noise: {flips[:4]}, "
              f"{keep_diff} keep bits")
    return gate and equal


def logits_check(model, params, prompt, device, gate: bool, n_flash,
                 phase="serve"):
    """One prefill and one decode step of the served model through the
    kernels and through the plain versions, on the same inputs; with
    ``gate`` a mismatch beyond the bf16 tolerance fails the run.
    ``n_flash``: the flash launches of the kernel path's prefill and
    decode, checked by variant.  For an moe model the routing of both
    paths is held to ``routing_gate``, and the logits are gated only
    where it is equal."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.models.moe import record_routing

    cfg = model.cfg
    plen, ps = len(prompt), 64
    bucket = -(-plen // ps) * ps
    tokens = torch.zeros((1, bucket), dtype=torch.long, device=device)
    tokens[0, :plen] = torch.as_tensor(prompt, device=device)

    def prefill():
        cache = model.init_cache(1, bucket, dtype=torch.float32)
        return model.prefill_at(params, {"tokens": tokens}, cache, plen - 1)

    arch = cfg.name if phase != "serve" else None
    kernels.reset_launch_counts()
    with record_routing() as r_got:
        got, cache = prefill()
    check_step_variant(model, "prefill", n_flash[0])
    with ops.plain_versions(), record_routing() as r_want:
        want, _ = prefill()
    report("prefill", got, want, model.cfg.compute_dtype,
           routing_gate("prefill", r_got, r_want, gate, phase, cfg.name),
           phase=phase, arch=arch)

    # the prompt's pages, plus the page the decoded token lands in
    n_filled, n_pages = bucket // ps, plen // ps + 1
    pools = {n: torch.zeros((cfg.n_layers, n_pages + 1, ps, cfg.n_kv_heads,
                             cfg.head_dim), device=device)
             for n in ("k", "v")}
    for n in pools:
        pools[n][:, :n_filled] = cache[n][:, 0].reshape(
            cfg.n_layers, n_filled, ps, cfg.n_kv_heads, cfg.head_dim)
    table = torch.arange(n_pages, dtype=torch.int32,
                         device=device)[None, :].contiguous()
    lengths = torch.tensor([plen], dtype=torch.int32, device=device)
    tok = torch.argmax(got[:, -1], dim=-1)[:, None]
    kernels.reset_launch_counts()
    with record_routing() as r_got:
        got, _ = model.decode_paged(params, tok, {n: p.clone()
                                                  for n, p in pools.items()},
                                    table, lengths)
    check_step_variant(model, "decode", n_flash[1])
    with ops.plain_versions(), record_routing() as r_want:
        want, _ = model.decode_paged(params, tok, pools, table, lengths)
    report("decode", got, want, model.cfg.compute_dtype,
           routing_gate("decode", r_got, r_want, gate, phase, cfg.name),
           phase=phase, arch=arch)


def report(step, got, want, compute, gate, phase="serve", arch=None):
    import torch
    torch.cuda.synchronize()
    e = max_err(got, want)
    ok = within(got, want, TOL["bfloat16"]) and bool(
        torch.isfinite(got).all())
    same_top = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    emit({"phase": phase, **({"arch": arch} if arch else {}),
          "check": f"{step} logits, kernels vs plain",
          "compute": compute, "shape": list(got.shape), "max_abs_err": e,
          "logit_absmax": float(want.float().abs().max()),
          "same_argmax": same_top, "tol": TOL["bfloat16"], "gated": gate,
          "ok": ok})
    if gate:
        check(ok, f"{step} logits ({compute}): kernels vs plain max err {e}")


# ---------------------------------------------------------------------------
# phases 4c-4e: the recurrent families through the fixed-batch steps
# ---------------------------------------------------------------------------

# (mamba layers, shared-block invocations) of each full-width config:
# 48 Mamba2 layers; 81 Mamba2 layers with the shared block every 6
LAYOUT = {"mamba2-780m": (48, 0), "zamba2-7b": (81, 81 // 6)}


def step_launches(cfg):
    """(flash per prefill, flash per decode step, SSD scans per prefill,
    RMSNorm per forward) of a fixed-batch model.  Recurrent families: the
    SSD scan once per mamba layer at prefill (decode runs the plain
    one-token recurrence), flash once per shared-block invocation per
    forward, RMSNorm twice per block plus the final norm.  encdec
    (whisper): flash once per encoder layer (non-causal) at prefill, and
    per decoder layer once for the causal self-attention and once for
    the cross-attention per forward; its LayerNorms are no kernel."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers, 0, 0
    n_mamba, n_attn = LAYOUT[cfg.name]
    check(cfg.n_layers == n_mamba, f"{cfg.name}: {cfg.n_layers} layers, "
          f"expected {n_mamba}")
    return n_attn, n_attn, n_mamba, 2 * n_mamba + 2 * n_attn + 1


def expected_launches(cfg, generate: int):
    """Kernel launches of one prefill and ``generate - 1`` decode steps
    (see ``step_launches``)."""
    f_pre, f_dec, n_ssd, n_rms = step_launches(cfg)
    return {"paged_attention": 0,
            "flash_attention": f_pre + f_dec * (generate - 1),
            "rmsnorm": n_rms * generate, "ssd_scan": n_ssd}


def fixed_batch_full_width(arch, device, batch, prompt, generate, *,
                           profile_steps=0):
    """``batch`` seeded random prompts of ``prompt`` tokens prefilled,
    then greedy-decoded to ``generate`` tokens per row, at full width and
    depth through ``repro_torch.launch.serve``'s fixed-batch loop
    (``make_prefill_step`` / ``make_decode_step`` over an fp32 cache).
    Launch counts are checked exactly; tokens/s is over the timed
    decode, ending in ``torch.cuda.synchronize()``."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (fixed_batch_generate,
                                          fixed_batch_inputs)
    from repro_torch.models.api import build_model
    from repro_torch.runtime.serve import make_decode_step

    cfg = get_config(arch)
    model = build_model(cfg, device=device)
    raw, inputs = fixed_batch_inputs(model, batch, prompt, 0, device)
    params = model.load(raw)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    run = fixed_batch_generate(model, params, inputs, generate, device)
    counts = kernels.launch_counts()
    variants = kernels.variant_counts()

    toks = run["tokens"]
    want = expected_launches(cfg, generate)
    emit({"phase": "batch", "arch": cfg.name, "family": cfg.family,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "param_dtype": cfg.param_dtype,
          "compute_dtype": cfg.compute_dtype, "batch": batch,
          "prompt": prompt, "generated": toks.shape[1],
          "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
          "decode_tokens_per_s": run["decode_tokens_per_s"],
          "launches": counts, "kernel_variants": variants,
          "expected_launches": want,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "sample_tokens": toks[0, :8].tolist()})
    check(counts == want, f"{cfg.name}: launches {counts} != {want}")
    check_flash_variant(cfg.name, cfg.compute_dtype, variants,
                        counts["flash_attention"])
    check_ssd_variant(cfg.name, cfg.compute_dtype, variants,
                      counts["ssd_scan"])
    check(toks.shape == (batch, generate)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{cfg.name}: tokens out of range or missing")
    check(run["logits_finite"], f"{cfg.name}: non-finite logits")

    carry = run.pop("carry")
    if profile_steps:
        profile_decode_window(params, make_decode_step(model), carry,
                              profile_steps)
    del carry, run
    one = {k: v[:1] for k, v in inputs.items()}
    # the served bf16 path, kernels vs plain: reported, not gated (bf16
    # rounding flips compound over the layers, ROADMAP C-port2)
    fixed_batch_logits_check(model, params, one, gate=False)
    del params
    torch.cuda.empty_cache()
    # the same weights computed in fp32 (the fp32 draw itself: no copy):
    # gated
    model32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                          device=device)
    fixed_batch_logits_check(model32, model32.load(raw), one, gate=True)
    return counts, variants


def fixed_batch_logits_check(model, params, inputs, gate: bool):
    """One prefill of ``inputs`` (one row: tokens (1, S), and frame
    embeddings for encdec) and one decode step from its cache, through
    the kernels and through the plain versions; both decode steps start
    from the kernel path's cache, token (and encoder states).  The
    kernel path's flash and SSD launches are checked by variant, at the
    counts of ``step_launches``."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops

    S = inputs["tokens"].shape[1]
    f_pre, f_dec, n_ssd, _ = step_launches(model.cfg)

    def prefill():
        cache = model.init_cache(1, S + 1, dtype=torch.float32)
        return model.prefill(params, inputs, cache)

    kernels.reset_launch_counts()
    got, cache, *enc = prefill()
    check_step_variant(model, "prefill", f_pre, n_ssd=n_ssd)
    with ops.plain_versions():
        want, *_ = prefill()
    report("prefill", got, want, model.cfg.compute_dtype, gate,
           phase="batch", arch=model.cfg.name)
    tok = torch.argmax(got[:, -1], dim=-1)[:, None]
    twin = {k: v.clone() for k, v in cache.items()}
    kernels.reset_launch_counts()
    got, _ = model.decode(params, tok, cache, S, *enc)
    check_step_variant(model, "decode", f_dec)
    with ops.plain_versions():
        want, _ = model.decode(params, tok, twin, S, *enc)
    report("decode", got, want, model.cfg.compute_dtype, gate,
           phase="batch", arch=model.cfg.name)


def profile_decode_window(params, decode, carry, steps: int):
    """Where the fixed-batch decode time goes: ``steps`` greedy steps
    from ``carry``, run twice plain (the second timed) and once under
    ``torch.profiler``.  Reported, not gated."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        c = carry
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            _, c = decode(params, c)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    wall = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled_wall = run()
    emit({"phase": "profile", "path": "fixed-batch decode",
          "batch": carry["tokens"].shape[0], "decode_steps": steps,
          "wall_s": wall, "profiled_wall_s": profiled_wall,
          **device_time(prof, wall)})


def sanitize(what: str, tracers) -> dict:
    """Each tracer through the port's sanitizer, and its Chrome export
    through ``validate_trace_events``: zero violations and zero
    problems, or the run fails."""
    from repro_torch.analysis import sanitize_tracer
    from repro_torch.obs import to_chrome_trace, validate_trace_events
    out = {"traces": len(tracers), "events": 0, "violations": 0,
           "problems": 0, "checks": {}}
    for tr in tracers:
        rep = sanitize_tracer(tr)
        problems = validate_trace_events(to_chrome_trace(tr))
        check(rep.ok, f"{what}: the sanitizer found violations:\n"
              f"{rep.format()}")
        check(not problems, f"{what}: trace export invalid: {problems[:5]}")
        out["events"] += rep.events
        out["violations"] += len(rep.violations)
        out["problems"] += len(problems)
        for rule, n in rep.checks.items():
            out["checks"][rule] = out["checks"].get(rule, 0) + n
    emit({"phase": "sanitize", "path": what, **out})
    return out


# ---------------------------------------------------------------------------
# phase 6: multi-tenant pooled serving (fig9's smoke scenario) at full width
# ---------------------------------------------------------------------------

# benchmarks/fig9_multitenant.py's smoke constants, restated (the smoke
# imports nothing of benchmarks/): three skewed tenants on one 24-page
# pool, 4 slots each, a 3 GB tier-2 grant split three ways
MT_PAGE, MT_PROMPT, MT_MAX_NEW, MT_SLOTS = 16, 32, 96, 4
MT_POOL_PAGES, MT_T2_BYTES = 24, 3e9
MT_TENANTS = ("hog", "mid", "burst")
MT_SHALLOW = 2      # depth of the comparison runs (b)-(e)


def mt_traffic():
    """fig9's ``_traffic(smoke=True)``: a hog of 8 requests 4 ms apart,
    a steady tenant of 4 requests 12 ms apart with half the new tokens,
    and a burst of 2 at t = 20 ms with a third of them.  Drawn with the
    smoke config's vocab, as fig9 draws them, at every width: numpy's
    ``randint`` takes more or fewer draws from the seed's stream by
    range, so another vocab would move the arrival times."""
    from repro_torch.configs import get_config
    from repro_torch.serve import synthetic_trace
    vocab = get_config("qwen1.5-0.5b", smoke=True).vocab
    hog = synthetic_trace(8, mean_interarrival_s=0.004,
                          prompt_lens=(MT_PROMPT,),
                          max_new_tokens=MT_MAX_NEW, vocab=vocab, seed=0)
    mid = synthetic_trace(4, mean_interarrival_s=0.012,
                          prompt_lens=(MT_PROMPT,),
                          max_new_tokens=MT_MAX_NEW // 2, vocab=vocab,
                          seed=1)
    burst = [dataclasses.replace(r, arrival_time=0.02)
             for r in synthetic_trace(2, mean_interarrival_s=0.0,
                                      prompt_lens=(MT_PROMPT,),
                                      max_new_tokens=MT_MAX_NEW // 3,
                                      vocab=vocab, seed=2)]
    return {"hog": hog, "mid": mid, "burst": burst}


def mt_engine(model, params, device, **kw):
    """One engine of the scenario with fig9's ``_cost_model``: modeled
    costs priced at the full-size qwen1.5-0.5b, tier-2 bandwidth scaled
    by this engine's page bytes over the full model's bf16 page, so the
    schedule does not depend on the width served."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, EngineConfig, ServeCostModel

    full = get_config("qwen1.5-0.5b")
    lease = kw.pop("lease", None)
    cfg = EngineConfig(max_slots=MT_SLOTS, max_seq=MT_PROMPT + MT_MAX_NEW,
                       page_size=MT_PAGE)
    if lease is not None:
        eng = Engine.from_lease(model, lease, cfg, params=params,
                                device=device, **kw)
    else:
        eng = Engine.local(model, cfg, params=params, device=device, **kw)
    cm = ServeCostModel.from_fabric(2.0 * full.param_count())
    full_page = (2 * full.n_layers * MT_PAGE * full.n_kv_heads
                 * full.head_dim * 2)
    eng.cost = dataclasses.replace(
        cm, tier2_bw=cm.tier2_bw * eng.kv.page_bytes / full_page)
    return eng


def mt_pooled(model, params, device, tracer=None, watch=False):
    """(a) the tenants on one ``PoolArbiter`` through ``run_multi_trace``;
    with ``watch`` the pool's page conservation (no live page in two
    tenants' tables) is checked at the end of every engine step."""
    from repro_torch.serve import KVBudget, PoolArbiter, run_multi_trace

    arb = PoolArbiter(MT_POOL_PAGES, page_size=MT_PAGE, tracer=tracer)
    n = len(MT_TENANTS)
    engines = {t: mt_engine(model, params, device, arbiter=arb, tenant=t,
                            tracer=tracer,
                            budget=KVBudget(tier2_bytes=MT_T2_BYTES / n,
                                            page_size=MT_PAGE))
               for t in MT_TENANTS}
    checked = [0]
    if watch:
        for eng in engines.values():
            def step(orig=eng.step):
                dt = orig()
                arb.check_conservation()
                checked[0] += 1
                return dt
            eng.step = step
    traffic = mt_traffic()
    lists = run_multi_trace([(engines[t], traffic[t]) for t in MT_TENANTS])
    return arb, engines, dict(zip(MT_TENANTS, lists)), checked[0]


def mt_static(model, params, device):
    """(b) static 1/3 partitions: each tenant a private engine with a
    third of the pool and of the tier-2 grant."""
    from repro_torch.serve import KVBudget, run_trace
    n = len(MT_TENANTS)
    traffic = mt_traffic()
    return {t: run_trace(mt_engine(model, params, device,
                                   budget=KVBudget(
                                       tier1_pages=MT_POOL_PAGES // n,
                                       tier2_bytes=MT_T2_BYTES / n,
                                       page_size=MT_PAGE)), traffic[t])
            for t in MT_TENANTS}


def mt_modeled(arb, engines, handles):
    """The numbers the modeled clock gives: per tenant p95, swaps,
    recomputes and every handle's clocks, and the arbiter's revoked
    pages — width-free by construction."""
    from repro_torch.serve import latency_summary
    out = {"revoked_pages": arb.revoked_pages,
           "revocations": arb.revocations,
           "recompute_drops": arb.recompute_drops}
    for t in MT_TENANTS:
        st = engines[t].stats()
        out[t] = {"p95_s": latency_summary(handles[t])["p95_s"],
                  "swaps": st["preempt_swaps"],
                  "recomputes": st["preempt_recomputes"],
                  "clocks": [(h.submit_clock, h.first_token_clock,
                              h.done_clock) for h in handles[t]]}
    return out


def same_runs(a, b) -> bool:
    """Identical tokens and handle clocks, request by request."""
    return len(a) == len(b) and all(
        x.tokens == y.tokens
        and (x.submit_clock, x.first_token_clock, x.done_clock)
        == (y.submit_clock, y.first_token_clock, y.done_clock)
        for x, y in zip(a, b))


def multitenant_full_width(model, params, device):
    """fig9's smoke scenario served on the card from one physical KV
    pool: (a) the three tenants on one ``PoolArbiter`` at full width and
    depth, every kernel launch counted and the pages checked after every
    step, then run again unwatched and untraced for the wall time; (b)
    three static 1/3 private engines; (c) a lone tenant under an 8-page
    arbiter against a private engine with that budget, on the hog's
    trace; (d) two tenants built with ``Engine.from_lease`` from one
    multi-tenant lease against ``Engine.local`` with ``kv_share``'s
    budget; (e) the pooled scenario in fp32, each tenant's tokens against
    a private engine with an ample pool, so revocation's gather, copy
    and page reuse on the card are held to a run that never revokes.
    (b)-(e) run the first ``MT_SHALLOW`` layers at full width: their
    modeled numbers do not depend on depth (checked against the CPU run
    below), and the smoke's time stays in bounds.  (a)'s and (b)'s
    modeled numbers must equal the same scenario's at smoke width on
    the CPU."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.pool import smoke_pool
    from repro_torch.serve import (KVBudget, PoolArbiter, RequestStatus,
                                   latency_summary, run_multi_trace,
                                   run_trace)

    # the same scenario at smoke width on the CPU, inside this run
    small = build_model(get_config("qwen1.5-0.5b", smoke=True),
                        device="cpu")
    small_params = small.init(torch.Generator().manual_seed(0))
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # its ops are tiny: threads only wait
    t0 = time.perf_counter()
    cpu_modeled = mt_modeled(*mt_pooled(small, small_params, cpu,
                                        watch=True)[:3])
    cpu_static = mt_static(small, small_params, cpu)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)

    # (a) on the card, every kernel launch counted
    tracer = Tracer(1 << 20)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    arb, engines, fair, checked = mt_pooled(model, params, device,
                                            tracer=tracer, watch=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    variants = kernels.variant_counts()
    names = [e.name for e in tracer.events()]
    decodes, prefills = names.count("decode"), names.count("prefill")
    modeled = mt_modeled(arb, engines, fair)
    L = model.cfg.n_layers
    tokens = sum(engines[t].stats()["tokens_decoded"] for t in MT_TENANTS)
    all_fair = [h for t in MT_TENANTS for h in fair[t]]

    # (a) again without the page check and the tracer, timed: the wall
    # and tokens per wall second a deployment would see; it must repeat
    # the watched run's tokens and modeled numbers
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arb_t, engines_t, timed, _ = mt_pooled(model, params, device)
    torch.cuda.synchronize()
    timed_wall = time.perf_counter() - t0
    repeat_same = (mt_modeled(arb_t, engines_t, timed) == modeled
                   and all(same_runs(timed[t], fair[t]) for t in MT_TENANTS))
    del arb_t, engines_t, timed

    # (b)-(e) at depth MT_SHALLOW: the full model's first layers
    shallow = build_model(dataclasses.replace(model.cfg,
                                              n_layers=MT_SHALLOW),
                          device=device)
    shallow_params = {**params, "layers": params["layers"][:MT_SHALLOW]}
    t0 = time.perf_counter()
    static = mt_static(shallow, shallow_params, device)
    torch.cuda.synchronize()
    static_wall = time.perf_counter() - t0
    all_static = [h for t in MT_TENANTS for h in static[t]]
    static_clocks = {t: [(h.submit_clock, h.first_token_clock,
                          h.done_clock) for h in static[t]]
                     for t in MT_TENANTS}

    n = len(MT_TENANTS)
    hog = mt_traffic()["hog"]
    priv = run_trace(mt_engine(shallow, shallow_params, device,
                               budget=KVBudget(MT_POOL_PAGES // n,
                                               MT_T2_BYTES / n, MT_PAGE)),
                     hog)
    solo_arb = PoolArbiter(MT_POOL_PAGES // n, page_size=MT_PAGE)
    solo = run_trace(mt_engine(shallow, shallow_params, device,
                               arbiter=solo_arb, tenant="solo",
                               budget=KVBudget(tier2_bytes=MT_T2_BYTES / n,
                                               page_size=MT_PAGE)), hog)

    # (d) two tenants from one lease == Engine.local with kv_share
    traffic = mt_traffic()
    lease = smoke_pool("scalepool").lease("chip-serve", 4, tier2_gb=8,
                                          kv_gb=1, tenants=("t0", "t1"))
    pair = {"t0": traffic["mid"], "t1": traffic["burst"]}
    runs = []
    for leased in (True, False):
        a2 = PoolArbiter(MT_POOL_PAGES // 2, page_size=MT_PAGE)
        engs = {t: (mt_engine(shallow, shallow_params, device, lease=lease,
                              arbiter=a2, tenant=t) if leased else
                    mt_engine(shallow, shallow_params, device, arbiter=a2,
                              tenant=t,
                              budget=lease.kv_share(t, page_size=MT_PAGE)))
                for t in pair}
        runs.append((run_multi_trace([(engs[t], pair[t]) for t in pair]),
                     [engs[t].budget.tier2_bytes for t in pair]))

    # (e) revocation on the card against an independent run: the pooled
    # scenario in fp32 (the same weights, upcast exactly) must give each
    # tenant the tokens that a private engine with room for every slot's
    # pages gives it, though the hog's pages were revoked, spilled and
    # fetched while other tenants reused them
    shallow32 = build_model(dataclasses.replace(shallow.cfg,
                                                compute_dtype="float32"),
                            device=device)
    arb32, engines32, pooled32, _ = mt_pooled(shallow32, shallow_params,
                                              device)
    ample = MT_SLOTS * (MT_PROMPT + MT_MAX_NEW) // MT_PAGE
    private32 = {}
    for t in MT_TENANTS:
        eng = mt_engine(shallow32, shallow_params, device,
                        budget=KVBudget(ample, MT_T2_BYTES / n, MT_PAGE))
        private32[t] = (run_trace(eng, traffic[t]), eng.stats()["preempts"])
    torch.cuda.synchronize()
    revoked32 = {"revoked_pages": arb32.revoked_pages,
                 "hog_swaps": engines32["hog"].stats()["preempt_swaps"]}
    tokens_equal32 = {t: [h.tokens for h in pooled32[t]]
                      == [h.tokens for h in private32[t][0]]
                      for t in MT_TENANTS}
    del shallow32, arb32, engines32, pooled32

    per_tenant = {}
    for t in MT_TENANTS:
        st = engines[t].stats()
        per_tenant[t] = {
            "p95_fair_s": modeled[t]["p95_s"],
            "p95_static_s": latency_summary(static[t])["p95_s"],
            "swaps": modeled[t]["swaps"],
            "recomputes": modeled[t]["recomputes"],
            "requests": len(fair[t]), "tokens_decoded": st["tokens_decoded"],
            "revocation_charged_s":
                arb.stats()["tenants"][t]["revocation_charged_s"]}
    agg_fair = latency_summary(all_fair)["p95_s"]
    agg_static = latency_summary(all_static)["p95_s"]
    static_equal = static_clocks == {
        t: [(h.submit_clock, h.first_token_clock, h.done_clock)
            for h in cpu_static[t]] for t in MT_TENANTS}
    emit({"phase": "multitenant", "arch": model.cfg.name,
          "layers": L, "d_model": model.cfg.d_model,
          "comparison_layers": MT_SHALLOW,
          "tenants": per_tenant, "revoked_pages": arb.revoked_pages,
          "revocations": arb.revocations,
          "agg_p95_fair_s": agg_fair, "agg_p95_static_s": agg_static,
          "wall_s": timed_wall, "tokens_decoded": tokens,
          "tokens_per_s": tokens / timed_wall, "watched_wall_s": wall,
          "repeat_identical": repeat_same, "static_wall_s": static_wall,
          "fp32_revocation": revoked32,
          "fp32_private_preempts": {t: private32[t][1] for t in MT_TENANTS},
          "fp32_tokens_equal_private": tokens_equal32,
          "prefills": prefills, "decode_steps": decodes,
          "page_checks": checked, "launches": counts,
          "kernel_variants": variants,
          "cpu_smoke_width_s": cpu_s,
          "modeled_equal_smoke_width": modeled == cpu_modeled,
          "static_equal_smoke_width": static_equal,
          "trace_dropped": tracer.dropped})
    check(tracer.dropped == 0, "multitenant: trace ring dropped events")
    sanitize("multitenant (a) pooled (full depth, bf16)", [tracer])
    done = all(h.status is RequestStatus.DONE for h in all_fair + all_static)
    check(done and all(engines[t].stats()["failed_oom"] == 0
                       for t in MT_TENANTS),
          "multitenant: a request did not finish or failed OOM")
    check(all(len(h.tokens) == h.request.max_new_tokens
              and all(0 <= x < model.cfg.vocab for x in h.tokens)
              for h in all_fair), "multitenant: tokens missing or out of "
          "range")
    check(arb.revoked_pages > 0, "multitenant: revocation never fired")
    check(agg_fair < agg_static, f"multitenant: pooled aggregate p95 "
          f"{agg_fair} not below static {agg_static}")
    for t, v in per_tenant.items():
        check(v["p95_fair_s"] <= 1.05 * v["p95_static_s"],
              f"multitenant: {t} p95 {v['p95_fair_s']} > 1.05 x static "
              f"{v['p95_static_s']}")
    check(same_runs(priv, solo), "multitenant: a lone tenant under an "
          "arbiter differs from its private engine")
    (leased_h, leased_t2), (local_h, local_t2) = runs
    check(leased_t2 == local_t2 == [0.5e9, 0.5e9]
          and all(same_runs(a, b) for a, b in zip(leased_h, local_h)),
          "multitenant: lease-built engines differ from local ones")
    check(repeat_same, "multitenant: the unwatched rerun of (a) differs "
          "from the watched run")
    check(revoked32["revoked_pages"] > 0 and revoked32["hog_swaps"] > 0,
          f"multitenant fp32: revocation did not fire: {revoked32}")
    check(all(private32[t][1] == 0 for t in MT_TENANTS),
          "multitenant fp32: a private engine with an ample pool preempted")
    check(all(tokens_equal32.values()), f"multitenant fp32: pooled tokens "
          f"differ from private engines': {tokens_equal32}")
    check(checked > 0, "multitenant: no page check ran")
    check(modeled == cpu_modeled, f"multitenant: modeled numbers at full "
          f"width {modeled} != smoke width on the CPU {cpu_modeled}")
    check(static_equal, "multitenant: the static runs' clocks differ from "
          "the same runs at smoke width on the CPU")
    check(counts["paged_attention"] == decodes * L,
          f"multitenant: paged launches {counts['paged_attention']} != "
          f"{decodes} decode steps x {L}")
    check(counts["flash_attention"] == prefills * L,
          f"multitenant: flash launches {counts['flash_attention']} != "
          f"{prefills} prefills x {L}")
    check_flash_variant(f"{model.cfg.name} pooled", model.cfg.compute_dtype,
                        variants, counts["flash_attention"])
    check(counts["rmsnorm"] == (decodes + prefills) * (2 * L + 1),
          f"multitenant: rmsnorm launches {counts['rmsnorm']} != "
          f"{decodes + prefills} calls x {2 * L + 1}")
    return counts, variants


# ---------------------------------------------------------------------------
# phase 7: disaggregated prefill/decode (fig12's smoke scenario) at full width
# ---------------------------------------------------------------------------

# benchmarks/fig12_disagg.py's smoke constants, restated: a prefill-heavy
# burst of 12 requests (224 prompt tokens, 16 new) on 4-slot engines of
# 16-token pages; fabric capacities in pages per modeled second
DG_PAGE, DG_PROMPT, DG_MAX_NEW, DG_SLOTS = 16, 224, 16, 4
DG_FAST_PAGES_S = 20000.0   # uncontended: the fabric outruns prefill
DG_SLOW_PAGES_S = 50.0      # the staging runs: handoffs genuinely priced
DG_N_BG = 3                 # background flows saturating the XLink trunk
DG_REQUESTS = 12
DG_SHALLOW = 2              # depth of the four staging runs
DG_MAIN = ("colocated", "direct", "tier2")   # fig12's full-depth runs


def dg_trace():
    """fig12's burst, drawn with the smoke config's vocab at every width
    (numpy's ``randint`` takes more or fewer draws by range)."""
    from repro_torch.configs import get_config
    from repro_torch.serve import burst_trace
    vocab = get_config("qwen1.5-0.5b", smoke=True).vocab
    return burst_trace(DG_REQUESTS, prompt_len=DG_PROMPT,
                       max_new_tokens=DG_MAX_NEW, vocab=vocab, seed=0)


def dg_engine(model, params, device, **kw):
    """One engine of the scenario: modeled costs priced at the full-size
    qwen1.5-0.5b (fig12's ``_cost_model``), whatever width is served."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, EngineConfig, ServeCostModel
    full = get_config("qwen1.5-0.5b")
    return Engine.local(
        model, EngineConfig(max_slots=DG_SLOTS,
                            max_seq=DG_PROMPT + DG_MAX_NEW,
                            page_size=DG_PAGE),
        params=params, device=device,
        cost_model=ServeCostModel.from_fabric(2.0 * full.param_count()),
        **kw)


def dg_topology(bw: float):
    """fig12's two pods with two disjoint inter-pod paths: the XLink
    trunk (via ``xsw``, inserted first, so pod-to-pod routes take it) and
    the tier-2 staging path (via ``t2sw`` and ``mem:0``)."""
    from repro_torch.core import fabric as fb
    from repro_torch.fabric import Topology
    lat = fb.tier2_memory_fabric(8).latency()
    topo = Topology("fig12")
    topo.add_node("xsw", "switch")
    topo.add_node("t2sw", "switch")
    topo.add_node("mem:0", "memory")
    for pid in (0, 1):
        topo.add_node(f"pod:{pid}", "pod")
        topo.connect(f"pod:{pid}", "xsw", fb.UALINK200, capacity=bw,
                     latency=lat / 8)
        topo.connect(f"pod:{pid}", "t2sw", fb.CXL3, capacity=bw,
                     latency=lat / 4)
    topo.connect("t2sw", "mem:0", fb.CXL_CAPACITY, capacity=2.0 * bw,
                 latency=lat / 4)
    return topo


def dg_colocated(model, params, device, trace, tracer=None):
    """The equal-hardware baseline: two colocated engines, the burst
    split round-robin, on one modeled clock."""
    from repro_torch.serve import run_multi_trace
    engines = [dg_engine(model, params, device, tenant=f"colo{k}",
                         tracer=tracer) for k in (0, 1)]
    res = run_multi_trace(list(zip(engines, [trace[0::2], trace[1::2]])))
    out = [None] * len(trace)
    for k in (0, 1):
        for j, h in enumerate(res[k]):
            out[k + 2 * j] = h
    return out, None


def dg_disagg(model, params, device, trace, *, staging, pages_s,
              saturate=False, tracer=None):
    """One prefill pod and one decode pod over fig12's fabric, link
    capacity ``pages_s`` pages of the decode engine's page bytes per
    modeled second, so the schedule does not depend on the width."""
    from repro_torch.disagg import DisaggCluster, DisaggConfig, PrefillWorker
    from repro_torch.fabric import Transport
    pe = dg_engine(model, params, device, tenant="prefill0", tracer=tracer)
    de = dg_engine(model, params, device, tenant="decode0", tracer=tracer)
    bw = pages_s * de.kv.page_bytes
    topo = dg_topology(bw)
    tx = Transport(topo, tracer=tracer)
    direct = topo.route("pod:0", "pod:1")
    check(any("xsw" in l.name for l in direct.links),
          "disagg: the direct route does not ride the XLink trunk")
    if saturate:
        for _ in range(DG_N_BG):
            tx.begin_transfer(direct, 1e4 * bw, 0.0, label="bg:xlink")
    kw = {}
    if staging == "tier2":
        kw["stage_in"] = topo.route("pod:0", "mem:0")
        kw["stage_out"] = topo.route("mem:0", "pod:1")
    cluster = DisaggCluster(
        [PrefillWorker(pe, name="p0")], [de], transport=tx, route=direct,
        tenant="kvcache",
        config=DisaggConfig(staging=staging, min_ready_pages=1), **kw)
    handles = cluster.run(trace)
    tx.quiesce()
    return handles, cluster


def dg_degenerate(model, params, device, trace, tracers):
    """route=None, one pod: the cluster against ``run_trace(Engine)``,
    tokens and trace events."""
    from repro_torch.disagg import DisaggCluster, PrefillWorker
    from repro_torch.obs import Tracer
    from repro_torch.serve import run_trace
    tr_a, tr_b = Tracer(1 << 16), Tracer(1 << 16)
    tracers += [tr_a, tr_b]
    plain = run_trace(dg_engine(model, params, device, tracer=tr_a), trace)
    idle = PrefillWorker(dg_engine(model, params, device, tracer=tr_b))
    got = DisaggCluster([idle], [dg_engine(model, params, device,
                                           tracer=tr_b)]).run(trace)
    key = lambda t: [(e.ph, e.track, e.name, e.ts, e.dur, e.args)
                     for e in t.events()]
    ev_a, ev_b = key(tr_a), key(tr_b)
    return {"tokens_identical": [h.tokens for h in plain]
            == [h.tokens for h in got],
            "events_identical": ev_a == ev_b, "events": len(ev_a),
            "done": all(h.done for h in plain + got)}


def dg_decode_p95(handles) -> float:
    """p95 of the decode phase (done - first token), fig12's
    interference axis."""
    ds = sorted(h.done_clock - h.first_token_clock for h in handles)
    return ds[max(0, math.ceil(0.95 * len(ds)) - 1)]


def dg_mean_transit(handles) -> float:
    return sum(h.kv_transit_s for h in handles) / max(1, len(handles))


def dg_main_runs(model, params, device, trace, tracers=None):
    """The three runs fig12 compares at full depth: colocated, direct and
    tier-2 staged, each with its wall time."""
    import torch
    from repro_torch.obs import Tracer
    runs, walls = {}, {}
    for name, fn, kw in (
            ("colocated", dg_colocated, {}),
            ("direct", dg_disagg, dict(staging="direct",
                                       pages_s=DG_FAST_PAGES_S)),
            ("tier2", dg_disagg, dict(staging="tier2",
                                      pages_s=DG_FAST_PAGES_S))):
        tracer = None
        if tracers is not None:
            tracer = Tracer(1 << 18)
            tracers.append(tracer)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = fn(model, params, device, trace, tracer=tracer, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    return runs, walls


def dg_staging_runs(model, params, device, trace):
    """fig12's staging scenario on the first six requests: a scarce
    fabric, with and without background flows pinning the trunk."""
    sat = trace[:max(6, len(trace) // 2)]
    return {f"{load}_{staging}": dg_disagg(
                model, params, device, sat, staging=staging,
                pages_s=DG_SLOW_PAGES_S, saturate=load == "sat")
            for load in ("sat", "idle") for staging in ("direct", "tier2")}


def dg_modeled(runs):
    """The numbers the modeled clock gives, width-free by construction:
    decode and end-to-end p95, mean KV transit, handoffs and colocated
    requests of every run."""
    from repro_torch.serve import latency_summary
    out = {"decode_p95_s": {}, "e2e_p95_s": {}, "transit_mean_s": {},
           "handoffs": {}, "colocated": {}}
    for name, (handles, cluster) in runs.items():
        out["decode_p95_s"][name] = dg_decode_p95(handles)
        out["e2e_p95_s"][name] = latency_summary(handles)["p95_s"]
        out["transit_mean_s"][name] = dg_mean_transit(handles)
        if cluster is not None:
            out["handoffs"][name] = cluster.handoffs
            out["colocated"][name] = cluster.colocated
    return out


def dg_claims(modeled, tokens_identical, degenerate):
    m = modeled
    sat_ok = (m["transit_mean_s"]["sat_tier2"]
              < m["transit_mean_s"]["sat_direct"]
              and m["transit_mean_s"]["idle_direct"]
              <= m["transit_mean_s"]["idle_tier2"])
    return {"p95_2x": m["decode_p95_s"]["colocated"]
            >= 2.0 * m["decode_p95_s"]["direct"],
            "tokens_identical": tokens_identical,
            "degenerate_identical": degenerate["tokens_identical"]
            and degenerate["events_identical"],
            "staging_wins": sat_ok}


def dg_uses_after_pages(tracer):
    """Every ``handoff_use`` at or after its request's last page landed
    (the ``ready_ts`` of that request's ``handoff_page`` events)."""
    last, uses = {}, []
    for e in tracer.events():
        if e.name == "handoff_page":
            last[e.track] = max(last.get(e.track, 0.0), e.args["ready_ts"])
        elif e.name == "handoff_use":
            uses.append(e)
    ok = all(e.track in last and e.ts >= last[e.track]
             and e.args["ready_ts"] == last[e.track] for e in uses)
    return len(uses), ok


def top2_margin(model, params, device, tokens) -> float:
    """Top-1 minus top-2 logit after ``tokens``, from one prefill."""
    import torch
    n = len(tokens)
    bucket = -(-n // DG_PAGE) * DG_PAGE
    toks = torch.zeros((1, bucket), dtype=torch.long, device=device)
    toks[0, :n] = torch.as_tensor(tokens, device=device)
    cache = model.init_cache(1, bucket, dtype=torch.float32)
    logits, _ = model.prefill_at(params, {"tokens": toks}, cache, n - 1)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def dg_tokens(model, params, device, runs):
    """(identical, difference): whether the colocated, direct and tier-2
    runs gave the same tokens, and where not, the first differing step
    with the colocated run's top-2 logit margin there (C-ref3)."""
    toks = {k: [h.tokens for h in runs[k][0]] for k in DG_MAIN}
    if toks["colocated"] == toks["direct"] == toks["tier2"]:
        return True, None
    other = "direct" if toks["direct"] != toks["colocated"] else "tier2"
    i, step = next((i, s) for i, (a, b) in enumerate(
        zip(toks["colocated"], toks[other]))
        for s, (x, y) in enumerate(zip(a, b)) if x != y)
    h = runs["colocated"][0][i]
    return False, {"run": other, "request": i, "step": step,
                   "top2_margin": top2_margin(
                       model, params, device,
                       list(h.request.prompt_tokens) + h.tokens[:step])}


def disagg_full_width(model, params, device):
    """fig12's smoke scenario served on the card: a prefill engine
    exports each prompt's KV page by page (``prefill_export``), the
    router streams the pages over the modeled fabric and plants each
    request on the decode engine (``submit_prefilled``).  At full width
    and depth in bf16, every kernel launch counted: two colocated engines
    against disaggregation direct and tier-2 staged, and the degenerate
    cluster against ``run_trace(Engine)`` on 6 requests; at full depth in
    fp32 (TF32 off) the three token streams held equal; on the first
    ``DG_SHALLOW`` layers the four staging runs (saturated and idle
    trunk).  The modeled numbers must equal the same scenario's at smoke
    width on the CPU."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    trace = dg_trace()
    # the same scenario at smoke width on the CPU, inside this run
    small = build_model(get_config("qwen1.5-0.5b", smoke=True),
                        device="cpu")
    small_params = small.init(torch.Generator().manual_seed(0))
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # its ops are tiny: threads only wait
    t0 = time.perf_counter()
    cpu_runs, _ = dg_main_runs(small, small_params, cpu, trace)
    cpu_runs.update(dg_staging_runs(small, small_params, cpu, trace))
    cpu_modeled = dg_modeled(cpu_runs)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    del cpu_runs, small, small_params

    # full width and depth, bf16, every kernel launch counted
    tracers = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    runs, walls = dg_main_runs(model, params, device, trace, tracers)
    degenerate = dg_degenerate(model, params, device, trace[:6], tracers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    variants = kernels.variant_counts()
    names = [e.name for t in tracers for e in t.events()]
    decodes, prefills = names.count("decode"), names.count("prefill")
    uses = {k: dg_uses_after_pages(tracers[DG_MAIN.index(k)])
            for k in ("direct", "tier2")}

    # the staging runs at depth DG_SHALLOW, the full model's first
    # layers: their pages (2^18 B) are a power of two apart from the
    # smoke width's (2^14 B), so the fabric's byte arithmetic rounds the
    # saturated runs' clocks alike; full-depth pages (3 x 2^20 B) do not
    shallow = build_model(dataclasses.replace(model.cfg,
                                              n_layers=DG_SHALLOW),
                          device=device)
    shallow_params = {**params, "layers": params["layers"][:DG_SHALLOW]}
    t1 = time.perf_counter()
    runs.update(dg_staging_runs(shallow, shallow_params, device, trace))
    torch.cuda.synchronize()
    staging_wall = time.perf_counter() - t1
    del shallow, shallow_params
    modeled = dg_modeled(runs)

    # tokens: bf16 reported, fp32 (the same weights, upcast exactly, TF32
    # off) gated; the colocated and the decode tier's rows sit in other
    # row buckets, where a GEMM at another row count may round otherwise
    bf16_equal, bf16_diff = dg_tokens(model, params, device, runs)
    model32 = build_model(dataclasses.replace(model.cfg,
                                              compute_dtype="float32"),
                          device=device)
    params32 = model32.load(params)
    runs32, walls32 = dg_main_runs(model32, params32, device, trace)
    fp32_equal, fp32_diff = dg_tokens(model32, params32, device, runs32)
    fp32_modeled_equal = dg_modeled(runs32) == dg_modeled(
        {k: runs[k] for k in DG_MAIN})
    del model32, params32, runs32

    claims = dg_claims(modeled, fp32_equal, degenerate)
    L = model.cfg.n_layers
    generated = {k: sum(len(h.tokens) for h in runs[k][0]) for k in DG_MAIN}
    run_steps = {k: sum(e.name == "decode" for e in tracers[i].events())
                 for i, k in enumerate(DG_MAIN)}
    emit({"phase": "disagg", "arch": model.cfg.name, "layers": L,
          "d_model": model.cfg.d_model, "staging_layers": DG_SHALLOW,
          "requests": len(trace), "claims": claims, "modeled": modeled,
          "wall_s": wall, "run_wall_s": walls,
          "tokens_per_wall_s": {k: generated[k] / walls[k]
                                for k in DG_MAIN},
          "decode_steps_per_run": run_steps,
          "staging_wall_s": staging_wall, "fp32_wall_s": walls32,
          "tokens_identical_fp32": fp32_equal, "fp32_difference": fp32_diff,
          "fp32_modeled_equal_bf16": fp32_modeled_equal,
          "tokens_identical_bf16": bf16_equal, "bf16_difference": bf16_diff,
          "degenerate": degenerate, "handoff_uses": uses,
          "prefills": prefills, "decode_steps": decodes,
          "launches": counts, "kernel_variants": variants,
          "cpu_smoke_width_s": cpu_s,
          "modeled_equal_smoke_width": modeled == cpu_modeled,
          "trace_dropped": sum(t.dropped for t in tracers)})
    check(all(t.dropped == 0 for t in tracers),
          "disagg: trace ring dropped events")
    sanitize("disagg colocated, direct, tier2 and degenerate (full depth, "
             "bf16)", tracers)
    check(all(h.done and len(h.tokens) == h.request.max_new_tokens
              and all(0 <= x < model.cfg.vocab for x in h.tokens)
              for hs, _ in runs.values() for h in hs)
          and degenerate["done"], "disagg: a request did not finish, or "
          "its tokens are missing or out of range")
    for k, v in claims.items():
        check(v, f"disagg: fig12 claim {k} failed: {modeled}")
    check(fp32_modeled_equal, "disagg: the fp32 runs' modeled numbers "
          "differ from the bf16 runs'")
    for k, (n, ok) in uses.items():
        check(n == modeled["handoffs"][k] and ok,
              f"disagg {k}: {n} handoff_use events, a use before its "
              f"last page landed: {not ok}")
    check(modeled == cpu_modeled, f"disagg: modeled numbers at full width "
          f"{modeled} != smoke width on the CPU {cpu_modeled}")
    check(counts["paged_attention"] == decodes * L,
          f"disagg: paged launches {counts['paged_attention']} != "
          f"{decodes} decode steps x {L}")
    check(counts["flash_attention"] == prefills * L,
          f"disagg: flash launches {counts['flash_attention']} != "
          f"{prefills} prefills x {L}")
    check_flash_variant(f"{model.cfg.name} disagg", model.cfg.compute_dtype,
                        variants, counts["flash_attention"])
    check(counts["rmsnorm"] == (decodes + prefills) * (2 * L + 1),
          f"disagg: rmsnorm launches {counts['rmsnorm']} != "
          f"{decodes + prefills} calls x {2 * L + 1}")
    return counts, variants


# ---------------------------------------------------------------------------
# phase 8: train+serve co-residency (fig11's smoke scenario) at full width
# ---------------------------------------------------------------------------

# benchmarks/fig11_colocation.py's smoke constants, restated: two bursty
# tenants on 6-slot engines of 16-token pages under a 20-page quota each,
# spilling over one tier-2 trunk, co-resident with an 8-way data-parallel
# training job on 6 pods of 5 accels over 3 CXL leaves (switch radix
# narrowed to 4) and 2 tier-2 memory nodes of 64 GB
CO_PAGE, CO_PROMPT, CO_MAX_NEW, CO_SLOTS, CO_QUOTA = 16, 32, 128, 6, 20
CO_TENANTS = ("a", "b")
CO_BW_SCALE = 0.002         # fig10's capacity-fabric slowdown
CO_PODS, CO_POD_SIZE, CO_MEM = 6, 5, 2
CO_TRAIN_TIER2_GB = 16.0
CO_REQUESTS, CO_STEPS = 6, 8            # the smoke's burst, training steps
CO_RACE_REQUESTS, CO_RACE_STEPS = 4, 4  # fig11's racecheck scenario
CO_RACE_SEEDS = (1, 2)
CO_SHALLOW = 2              # depth of the fp32 pass and the racecheck
CO_REL = 1e-9               # full-depth pages round otherwise (see phase 7)
# (name, allocator policy, train?): fig11's three runs
CO_RUNS = (("hop_only", "scalepool", True),
           ("contention", "contention", True),
           ("serve_solo", "scalepool", False))


def co_train():
    """fig11's training job: colo-13b, dp=8 over two 5-accel pods, its
    step priced by the simulator on 5-accel clusters (a real inter-pod
    gradient phase plus the optimizer-offload shuttle)."""
    from repro_torch.core import simulator as sim
    model = sim.LLMConfig("colo-13b", 40, 5120, 40, 4 * 5120, 50257, 2048,
                          13e9)
    par = sim.ParallelismConfig(tp=1, pp=1, dp=8, global_batch_seqs=8)
    calib = dataclasses.replace(sim.Calibration(), cluster_size=CO_POD_SIZE)
    system = sim.make_system("scalepool", 2 * CO_POD_SIZE, calib)
    return par, sim.simulate_step(model, par, system)


def co_inventory():
    """The placement estate: the stock switch radix would put all six
    pods on one leaf; radix 4 spreads them over three."""
    from repro_torch.pool import build_inventory
    inv = build_inventory(n_pods=CO_PODS, pod_size=CO_POD_SIZE,
                          hbm_per_accel_gb=64.0, n_memory_nodes=CO_MEM,
                          memory_node_gb=64.0, interconnect="scalepool")
    inter = inv.inter_fabric
    inter = dataclasses.replace(
        inter, topology=dataclasses.replace(
            inter.topology, switch=dataclasses.replace(
                inter.topology.switch, radix=4)))
    return dataclasses.replace(inv, inter_fabric=inter)


def co_topology(inv, bw: float):
    """fig11's pricing estate: the inventory's node and link names, with
    capacities in the served model's page bytes: pod uplinks 8x,
    leaf->spine 1.2x, the spine->t2sw trunk 1.6x, node links 1x."""
    from repro_torch.core import fabric as fb
    from repro_torch.fabric import Topology
    lat = fb.tier2_memory_fabric(8).latency()
    topo = Topology("fig11")
    topo.add_node("spine", "switch")
    topo.add_node("t2sw", "switch")
    topo.connect("spine", "t2sw", fb.CXL_CAPACITY, capacity=1.6 * bw,
                 latency=lat / 4)
    for leaf in range(CO_PODS // inv.pods_per_leaf):
        topo.add_node(f"leaf:{leaf}", "switch")
        topo.connect(f"leaf:{leaf}", "spine", fb.CXL3, capacity=1.2 * bw,
                     latency=lat / 4)
    for pid in range(CO_PODS):
        topo.add_node(f"pod:{pid}", "pod")
        topo.connect(f"pod:{pid}", f"leaf:{inv.leaf_of(pid)}", fb.CXL3,
                     capacity=8 * bw, latency=lat / 4)
    for node in range(CO_MEM):
        topo.add_node(f"mem:{node}", "memory")
        topo.connect("t2sw", f"mem:{node}", fb.CXL_CAPACITY, capacity=bw,
                     latency=lat / 4)
    return topo


def co_place(policy: str, n_gpus: int):
    """Admit serving, then training, on a fresh estate under ``policy``:
    (serving pods, serving tier-2 nodes, training pods, training
    nodes)."""
    from repro_torch.pool import Allocator, JobRequest
    alloc = Allocator(co_inventory(), policy)
    svc = alloc.allocate(JobRequest("svc", 1, tier2_bytes=8e9, kv_bytes=1e9,
                                    tenants=CO_TENANTS))
    trn = alloc.allocate(JobRequest("train", n_gpus,
                                    tier2_bytes=CO_TRAIN_TIER2_GB * 1e9))
    check(svc is not None and trn is not None, "colo: the estate misadmits")
    return (list(svc.pod_ids), sorted(svc.tier2), list(trn.pod_ids),
            sorted(trn.tier2))


def co_traces(n: int):
    """Each tenant's burst, drawn with the smoke config's vocab at every
    width (numpy's ``randint`` takes more or fewer draws by range)."""
    from repro_torch.configs import get_config
    from repro_torch.serve import burst_trace
    vocab = get_config("qwen1.5-0.5b", smoke=True).vocab
    return {t: burst_trace(n, prompt_len=CO_PROMPT, max_new_tokens=CO_MAX_NEW,
                           vocab=vocab, seed=i)
            for i, t in enumerate(CO_TENANTS)}


def co_cost():
    """Modeled serving costs priced at the full-size qwen1.5-0.5b, and
    the bytes of its bf16 KV page."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeCostModel
    full = get_config("qwen1.5-0.5b")
    full_page = (2 * full.n_layers * CO_PAGE * full.n_kv_heads
                 * full.head_dim * 2)
    return ServeCostModel.from_fabric(2.0 * full.param_count()), full_page


def co_bw(model, params, device):
    """fig11's ``_page_bw``: the capacity link's bytes per second scaled
    by the served model's page bytes over the full model's bf16 page,
    so the schedule does not depend on the width served; also returns
    the page bytes."""
    from repro_torch.serve import Engine, EngineConfig, KVBudget
    probe = Engine.local(model, EngineConfig(max_slots=CO_SLOTS,
                                             max_seq=CO_PROMPT + CO_MAX_NEW,
                                             page_size=CO_PAGE),
                         params=params, device=device,
                         budget=KVBudget(CO_QUOTA, 1e9, CO_PAGE))
    cm, full_page = co_cost()
    page_bytes = probe.kv.page_bytes
    return cm.tier2_bw * page_bytes / full_page * CO_BW_SCALE, page_bytes


def co_run(model, params, device, policy: str, n_steps: int, traces,
           bw: float, tracer=None):
    """One fig11 run (``_run_policy``): place serving and training under
    ``policy``, serve both tenants over the placement's spill route and
    step the training job on its collective routes, on one shared
    ``Transport`` through ``run_colo``.  The tracer, when given, records
    the engines as well as the transport."""
    from repro_torch.colo import TrainActor, job_routes, run_colo
    from repro_torch.fabric import Transport
    from repro_torch.obs import link_report
    from repro_torch.serve import (Engine, EngineConfig, KVBudget,
                                   latency_summary)
    par, bd = co_train()
    svc_pods, svc_mems, trn_pods, trn_mems = co_place(policy, par.n_gpus)
    topo = co_topology(co_inventory(), bw)
    tx = Transport(topo, tracer=tracer)
    cm, _ = co_cost()
    cfg = EngineConfig(max_slots=CO_SLOTS, max_seq=CO_PROMPT + CO_MAX_NEW,
                       page_size=CO_PAGE)
    spill = topo.route(f"pod:{svc_pods[0]}", f"mem:{svc_mems[0]}")
    engines = {t: Engine.local(model, cfg, params=params, device=device,
                               budget=KVBudget(CO_QUOTA, 1e9, CO_PAGE),
                               cost_model=cm, transport=tx, route=spill,
                               tenant=t, tracer=tracer)
               for t in CO_TENANTS}
    actors = []
    if n_steps > 0:
        actors = [TrainActor("job0", bd, tx,
                             job_routes(topo, trn_pods, trn_mems),
                             n_steps=n_steps)]
    res = run_colo([(engines[t], traces[t]) for t in CO_TENANTS], actors)
    tx.quiesce()
    handles = dict(zip(CO_TENANTS, res.serve_handles))
    return {"handles": handles, "engines": engines,
            "agg_p95": latency_summary(
                [h for hs in res.serve_handles for h in hs])["p95_s"],
            "p95": {t: latency_summary(handles[t])["p95_s"]
                    for t in CO_TENANTS},
            "train": res.train[0].stats() if actors else None,
            "placement": {"svc_pods": svc_pods, "train_pods": trn_pods,
                          "train_mem": trn_mems},
            "links": link_report(tx), "transport": tx.stats()}


def co_outcome(r):
    """What a run gives a user, as racecheck compares it: tokens,
    latencies, p95s, training stats, placement, link report and
    transport stats (fig11's ``racecheck_scenario``)."""
    return {"tokens": {t: [list(h.tokens) for h in r["handles"][t]]
                       for t in CO_TENANTS},
            "latency": {t: [h.latency for h in r["handles"][t]]
                        for t in CO_TENANTS},
            "p95": r["p95"], "agg_p95": r["agg_p95"], "train": r["train"],
            "placement": r["placement"], "links": r["links"],
            "transport": r["transport"]}


def co_modeled(r, page_bytes: float):
    """The numbers the modeled clock gives, width-free by construction:
    each request's clocks, per-tenant and aggregate p95, the training
    job's step times and stretch, contended transfers, placement, and
    the trunk's bytes by flow label per byte of the served page."""
    train = r["train"] or {}
    trunk = r["links"]["spine->t2sw"]["by_label"]
    return {"clocks": {t: [(h.submit_clock, h.first_token_clock,
                            h.done_clock) for h in r["handles"][t]]
                       for t in CO_TENANTS},
            "p95_s": dict(r["p95"]), "agg_p95_s": r["agg_p95"],
            "step_s_avg": train.get("step_s_avg"),
            "step_s_max": train.get("step_s_max"),
            "stretch_s": train.get("stretch_s"),
            "train_clock_s": train.get("clock_s"),
            "contended_transfers": r["transport"]["contended_transfers"],
            "train_pods": r["placement"]["train_pods"],
            "trunk_pages_by_label": {k: v / page_bytes
                                     for k, v in sorted(trunk.items())}}


def co_close(a, b, rel: float) -> bool:
    """Equal structure, and every float within ``rel`` of the other."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(co_close(a[k], b[k], rel)
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(co_close(x, y, rel)
                                        for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= rel * max(abs(a), abs(b))
    return a == b


def co_claims(runs):
    """fig11's five claims over the three runs."""
    hop, con, solo = (runs[k] for k, _, _ in CO_RUNS)
    toks = lambda r: [h.tokens for t in CO_TENANTS for h in r["handles"][t]]

    def trunk_classes(r):
        by = r["links"].get("spine->t2sw", {}).get("by_label", {})
        return {lbl.split(":", 1)[0] for lbl, b in by.items() if b > 0}

    return {"placements_differ": hop["placement"]["train_pods"]
            != con["placement"]["train_pods"],
            "contention_dominates": con["train"]["step_s_avg"]
            < hop["train"]["step_s_avg"] and con["agg_p95"] < hop["agg_p95"],
            "tokens_bit_identical": toks(hop) == toks(con) == toks(solo),
            "trunk_shared": all(trunk_classes(r) >= {"serve", "train"}
                                for r in (hop, con)),
            "contention_real": hop["transport"]["contended_transfers"] > 0}


def co_token_difference(model, params, device, runs):
    """Where the runs' tokens first differ from hop_only's: the run, the
    tenant, the request and the step, with hop_only's top-2 logit margin
    there (C-ref3)."""
    base = runs["hop_only"]["handles"]
    for name in ("contention", "serve_solo"):
        for t in CO_TENANTS:
            for i, (h, g) in enumerate(zip(base[t], runs[name]["handles"][t])):
                step = next((s for s, (x, y) in enumerate(zip(h.tokens,
                                                               g.tokens))
                             if x != y), None)
                if step is not None:
                    return {"run": name, "tenant": t, "request": i,
                            "step": step, "top2_margin": top2_margin(
                                model, params, device,
                                list(h.request.prompt_tokens)
                                + h.tokens[:step])}
    return None


def co_three(model, params, device, n_requests, n_steps):
    """fig11's three runs, each with its wall time, and the page bytes."""
    import torch
    bw, page_bytes = co_bw(model, params, device)
    runs, walls = {}, {}
    for name, policy, train in CO_RUNS:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = co_run(model, params, device, policy,
                            n_steps if train else 0, co_traces(n_requests),
                            bw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    return runs, walls, page_bytes


def co_racecheck(model, params, device):
    """fig11's racecheck scenario (hop-only, 4 requests a tenant, 4
    training steps) under the port's racecheck: the run again under each
    of ``CO_RACE_SEEDS``' perturbations of every candidate enumeration,
    bit-identical in tokens, clocks, training stats, link report and
    trace events."""
    from repro_torch.analysis import racecheck
    bw, _ = co_bw(model, params, device)

    def scenario(tracer):
        r = co_run(model, params, device, "scalepool", CO_RACE_STEPS,
                   co_traces(CO_RACE_REQUESTS), bw, tracer=tracer)
        return co_outcome(r)

    return racecheck(scenario, seeds=CO_RACE_SEEDS, label="fig11 hop_only")


def colo_full_width(model, params, device):
    """fig11's smoke scenario on the card: two tenants' bursts served
    while a data-parallel training job's gradient and offload phases
    share the estate's links, placed hop-only, contention-aware, and
    with no training.  At full width and depth in bf16, every kernel
    launch counted, the hop-only trace sanitized; on the first
    ``CO_SHALLOW`` layers in fp32 the three runs again, and the racecheck
    in bf16.  The modeled numbers must equal the same scenario's at
    smoke width on the CPU: to ``CO_REL`` at full depth, exactly at
    depth ``CO_SHALLOW``."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.serve import RequestStatus

    phase_t0 = time.perf_counter()
    # the same scenario at smoke width on the CPU, inside this run
    small = build_model(get_config("qwen1.5-0.5b", smoke=True),
                        device="cpu")
    small_params = small.init(torch.Generator().manual_seed(0))
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # its ops are tiny: threads only wait
    t0 = time.perf_counter()
    cpu_runs, _, cpu_page = co_three(small, small_params, cpu, CO_REQUESTS,
                                     CO_STEPS)
    cpu_modeled = {k: co_modeled(r, cpu_page) for k, r in cpu_runs.items()}
    cpu_claims = co_claims(cpu_runs)
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    del cpu_runs, small, small_params

    # full width and depth, bf16, every kernel launch counted per run
    L = model.cfg.n_layers
    runs, walls, launches, steps = {}, {}, {}, {}
    tracers = []
    bw, page_bytes = co_bw(model, params, device)
    for name, policy, train in CO_RUNS:
        tracer = Tracer(1 << 18)
        tracers.append(tracer)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runs[name] = co_run(model, params, device, policy,
                            CO_STEPS if train else 0,
                            co_traces(CO_REQUESTS), bw, tracer=tracer)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts = kernels.launch_counts()
        variants = kernels.variant_counts()
        names = [e.name for e in tracer.events()]
        decodes, prefills = names.count("decode"), names.count("prefill")
        steps[name] = {"engine_steps": sum(
            e.stats()["steps"] for e in runs[name]["engines"].values()),
            "decode_steps": decodes, "prefills": prefills}
        launches[name] = {"launches": counts, "kernel_variants": variants}
        check(counts["paged_attention"] == decodes * L,
              f"colo {name}: paged launches {counts['paged_attention']} != "
              f"{decodes} decode steps x {L}")
        check(counts["flash_attention"] == prefills * L,
              f"colo {name}: flash launches {counts['flash_attention']} != "
              f"{prefills} prefills x {L}")
        check_flash_variant(f"{model.cfg.name} colo {name}",
                            model.cfg.compute_dtype, variants,
                            counts["flash_attention"])
        check(counts["rmsnorm"] == (decodes + prefills) * (2 * L + 1),
              f"colo {name}: rmsnorm launches {counts['rmsnorm']} != "
              f"{decodes + prefills} calls x {2 * L + 1}")
        check(tracer.dropped == 0, f"colo {name}: trace ring dropped events")
    total = {k: sum(v["launches"][k] for v in launches.values())
             for k in launches["hop_only"]["launches"]}
    total_variants = {k: sum(v["kernel_variants"][k]
                             for v in launches.values())
                      for k in launches["hop_only"]["kernel_variants"]}
    modeled = {k: co_modeled(r, page_bytes) for k, r in runs.items()}
    claims = co_claims(runs)
    bf16_diff = None if claims["tokens_bit_identical"] else \
        co_token_difference(model, params, device, runs)
    generated = {k: sum(len(h.tokens) for hs in r["handles"].values()
                        for h in hs) for k, r in runs.items()}
    san = sanitize("colo hop_only (full depth, bf16)", tracers[:1])

    # the three runs on the first CO_SHALLOW layers in fp32 (the same
    # weights, upcast exactly, TF32 off): pages of 2^18 B, a power of two
    # from the smoke width's, so every modeled number must equal the CPU's
    shallow32 = build_model(dataclasses.replace(
        model.cfg, n_layers=CO_SHALLOW, compute_dtype="float32"),
        device=device)
    shallow_params = {**params, "layers": params["layers"][:CO_SHALLOW]}
    params32 = shallow32.load(shallow_params)
    runs32, walls32, page32 = co_three(shallow32, params32, device,
                                       CO_REQUESTS, CO_STEPS)
    modeled32 = {k: co_modeled(r, page32) for k, r in runs32.items()}
    claims32 = co_claims(runs32)
    del shallow32, params32, runs32

    # the racecheck on the card, first CO_SHALLOW layers in bf16
    shallow = build_model(dataclasses.replace(model.cfg,
                                              n_layers=CO_SHALLOW),
                          device=device)
    t0 = time.perf_counter()
    race = co_racecheck(shallow, shallow_params, device)
    torch.cuda.synchronize()
    race_wall = time.perf_counter() - t0
    del shallow, shallow_params

    per_run = {k: {"wall_s": walls[k], "tokens": generated[k],
                   "tokens_per_wall_s": generated[k] / walls[k],
                   **steps[k], **launches[k],
                   "modeled": modeled[k], "cpu_modeled": cpu_modeled[k]}
               for k in walls}
    emit({"phase": "colo", "arch": model.cfg.name, "layers": L,
          "d_model": model.cfg.d_model, "shallow_layers": CO_SHALLOW,
          "requests_per_tenant": CO_REQUESTS, "train_steps": CO_STEPS,
          "page_bytes": page_bytes, "cpu_page_bytes": cpu_page,
          "fp32_page_bytes": page32, "claims": claims,
          "cpu_claims": cpu_claims, "fp32_claims": claims32,
          "runs": per_run, "fp32_wall_s": walls32,
          "bf16_token_difference": bf16_diff,
          "modeled_within_rel_smoke_width": {
              k: co_close(modeled[k], cpu_modeled[k], CO_REL)
              for k in modeled},
          "modeled_equal_bits_smoke_width": {
              k: modeled[k] == cpu_modeled[k] for k in modeled},
          "fp32_modeled_equal_smoke_width": {
              k: modeled32[k] == cpu_modeled[k] for k in modeled32},
          "racecheck": race.format(), "racecheck_ok": race.ok,
          "racecheck_events": race.baseline_events,
          "racecheck_wall_s": race_wall, "sanitizer": san,
          "cpu_smoke_width_s": cpu_s, "launches_total": total,
          "phase_wall_s": time.perf_counter() - phase_t0})
    for name, r in runs.items():
        check(all(h.status is RequestStatus.DONE
                  and len(h.tokens) == CO_MAX_NEW
                  and all(0 <= x < model.cfg.vocab for x in h.tokens)
                  for hs in r["handles"].values() for h in hs)
              and len(r["handles"]["a"]) == CO_REQUESTS,
              f"colo {name}: a request did not finish, or its tokens are "
              f"missing or out of range")
    for k, v in claims.items():
        check(v, f"colo: fig11 claim {k} failed at full depth in bf16")
    for k, v in claims32.items():
        check(v, f"colo: fig11 claim {k} failed on {CO_SHALLOW} layers in "
              f"fp32")
    check(all(cpu_claims.values()), f"colo: fig11 claims on the CPU "
          f"{cpu_claims}")
    for k in modeled:
        check(co_close(modeled[k], cpu_modeled[k], CO_REL),
              f"colo {k}: modeled numbers at full width {modeled[k]} not "
              f"within {CO_REL} of smoke width on the CPU {cpu_modeled[k]}")
        check(modeled32[k] == cpu_modeled[k],
              f"colo {k}: modeled numbers on {CO_SHALLOW} layers in fp32 "
              f"{modeled32[k]} != smoke width on the CPU {cpu_modeled[k]}")
    check(race.ok, f"colo: the racecheck diverged on the card:\n"
          f"{race.format()}")
    return total, total_variants

# ---------------------------------------------------------------------------
# phase 9: the moe family (olmoe-1b-7b at full width and depth, mixtral-8x7b
# at full width on its first layers)
# ---------------------------------------------------------------------------

# mixtral's depth on one card: a layer is 1.45e9 parameters, and both the
# draw (fp32 draws beside their bf16 copy) and the fp32 gate (bf16 weights
# beside their fp32 upcast) hold 12 bytes of each, 8.7 GB a layer, plus
# 1.6 GB for the embedding and head; 8 layers peak near 71 GB of the
# card's 85 GB, 9 near 80 GB
MIXTRAL_DEPTH = 8


def moe_engine_run(arch, device, *, n_layers, n_requests, prompt_lens,
                   max_new, max_seq, quota=None, tier2=0.0):
    """``n_requests`` seeded requests served by ``Engine.local`` through
    ``run_trace``: ``arch`` (cut to its first ``n_layers`` layers when
    given), weights drawn in fp32 from a seeded generator and loaded in
    bf16 (the draw is freed once the engine holds the loaded copy), 8
    slots of 64-token pages in bf16 (the family's cache dtype), under
    ``quota`` tier-1 pages and ``tier2`` bytes when a quota is given.
    Every request must finish with its tokens in range and the launches
    must be exact (paged once per layer per decode step, flash once per
    layer per prefill, all on the tensor-core kernel, RMSNorm 2L+1 times
    per forward); under a quota, sequences must spill and fetch."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tiering import KVBudget
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.serve import (Engine, EngineConfig, latency_summary,
                                   run_trace, synthetic_trace)

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, device=device)
    tracer = Tracer(1 << 20)
    budget = (KVBudget(tier1_pages=quota, tier2_bytes=tier2, page_size=64)
              if quota else None)
    engine = Engine.local(
        model, EngineConfig(max_slots=8, max_seq=max_seq, page_size=64,
                            cache_dtype="bfloat16"),
        generator=torch.Generator(device=device).manual_seed(0),
        budget=budget, tracer=tracer, device=device)
    gc.collect()
    torch.cuda.empty_cache()
    trace = synthetic_trace(n_requests, prompt_lens=prompt_lens,
                            max_new_tokens=max_new, mean_interarrival_s=0.002,
                            vocab=cfg.vocab, seed=0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    handles = run_trace(engine, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    variants = kernels.variant_counts()

    stats = engine.stats()
    names = [e.name for e in tracer.events()]
    decodes, prefills = names.count("decode"), names.count("prefill")
    L = cfg.n_layers
    want = {"paged_attention": decodes * L, "flash_attention": prefills * L,
            "rmsnorm": (decodes + prefills) * (2 * L + 1), "ssd_scan": 0}
    run = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model,
           "experts": cfg.n_experts, "top_k": cfg.top_k,
           "expert_d_ff": cfg.expert_d_ff, "vocab": cfg.vocab,
           "capacity_factor": cfg.capacity_factor,
           "requests": len(handles), "wall_s": wall,
           "tokens_decoded": stats["tokens_decoded"],
           "tokens_per_s": stats["tokens_decoded"] / wall,
           "prefills": prefills, "decode_steps": decodes,
           "page_mb": engine.kv.page_bytes / 1e6,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit({"phase": "moe", **run, "launches": counts,
          "expected_launches": want, "kernel_variants": variants,
          "latency_modeled": latency_summary(handles), "kv": stats["kv"],
          "preempts": stats["preempts"], "swaps": stats["preempt_swaps"],
          "recomputes": stats["preempt_recomputes"],
          "row_buckets": sorted(engine._row_buckets_used),
          "trace_dropped": tracer.dropped})
    check(tracer.dropped == 0, f"{cfg.name}: trace ring dropped events")
    check(stats["completed"] == n_requests and stats["failed_oom"] == 0,
          f"{cfg.name}: not every request finished: {stats['completed']} "
          f"done, {stats['failed_oom']} failed OOM")
    check(all(len(h.tokens) == max_new and all(0 <= t < cfg.vocab
                                                for t in h.tokens)
              for h in handles), f"{cfg.name}: tokens out of range")
    if quota:
        check(stats["kv"]["spills"] > 0 and stats["kv"]["fetches"] > 0,
              f"{cfg.name}: no spill/fetch under the {quota}-page quota: "
              f"{stats['kv']}")
    check(counts == want, f"{cfg.name}: launches {counts} != {want}")
    check_flash_variant(cfg.name, cfg.compute_dtype, variants,
                        counts["flash_attention"])
    return model, engine, trace, counts, variants, run


def moe_decode_breakdown(model, params, device, lens):
    """A decode window of olmoe: steps at the engine's full 8-row bucket
    (``lens`` tokens a row, random bf16 K/V pages) run back to back.  A
    step's device time is its kernels and copies summed under
    ``torch.profiler``, its wall time the host clock over steps ending
    in a synchronise, the busy share their ratio; its two parts run
    alone, layer after layer: the expert layers (router, dispatch, the
    expert matmuls, combine) on a decode batch's activations, and the
    attention layers (projections, page write, paged kernel).  The byte
    bound reads every weight once (each decode step runs every expert:
    the capacity gives each at least one slot) and each row's K/V."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers as Lyr
    from repro_torch.models import moe, transformer

    cfg = model.cfg
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(3)
    B, ps, pmax = len(lens), 64, 1024 // 64
    pools = {n: torch.randn((cfg.n_layers, B * pmax + 1, ps, cfg.n_kv_heads,
                             cfg.head_dim), generator=gen,
                            device=device).to(bf16) for n in "kv"}
    table = torch.arange(B * pmax, dtype=torch.int32,
                         device=device).reshape(B, pmax)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    tokens = torch.randint(1, cfg.vocab, (B, 1), generator=gen,
                           device=device)
    h = torch.randn((B, 1, cfg.d_model), generator=gen,
                    device=device).to(bf16)
    acfg = transformer.attn_config(cfg)
    positions = lengths.long()[:, None]
    layers = params["layers"]

    def step():
        model.decode_paged(params, tokens, pools, table, lengths)

    def experts():
        for layer in layers:
            moe.moe_mlp_fwd(layer["moe"], h, cfg)

    def attention():
        for i, layer in enumerate(layers):
            Lyr.attention_fwd_paged(
                layer["attn"], h, acfg, positions=positions,
                k_pages=pools["k"][i], v_pages=pools["v"][i],
                page_table=table, lengths=lengths)

    def device_ms(fn, n=3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3 / n

    def host_ms(fn, n=10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]

    weight_bytes = sum(w.numel() * w.element_size() for w in leaves(params))
    kv_bytes = (2 * cfg.n_layers * sum(n + 1 for n in lens) * cfg.n_kv_heads
                * cfg.head_dim * 2)
    out = {"rows": B, "lens": lens, "step_device_ms": device_ms(step),
           "step_wall_ms": host_ms(step),
           "experts_device_ms": device_ms(experts),
           "attention_device_ms": device_ms(attention),
           "weight_gb": weight_bytes / 1e9, "kv_gb": kv_bytes / 1e9,
           "bound_ms": (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes"}
    out["step_over_bound"] = out["step_device_ms"] / out["bound_ms"]
    out["step_busy_share"] = out["step_device_ms"] / out["step_wall_ms"]
    del pools
    return out


def moe_full_width(device):
    """Phase 9: olmoe-1b-7b at full width and depth through the engine
    under phase 4's trace, quota and tier-2 budget; its served bf16
    logits reported and its fp32 logits gated against the plain path
    under the routing-tie rule; the decode step's device breakdown
    from a profiled decode window.  Then mixtral-8x7b at full width on its
    first ``MIXTRAL_DEPTH`` layers, 8 requests of 120/250 prompt tokens,
    32 new, an ample pool: launches exact, logits held the same way."""
    import torch
    from repro_torch.models.api import build_model

    counts, variants = {}, {}
    for arch, kw in (
            ("olmoe-1b-7b", dict(n_layers=None, n_requests=16,
                                 prompt_lens=PROMPT_LENS, max_new=64,
                                 max_seq=1024, quota=32, tier2=4e9)),
            ("mixtral-8x7b", dict(n_layers=MIXTRAL_DEPTH, n_requests=8,
                                  prompt_lens=(120, 250), max_new=32,
                                  max_seq=512))):
        torch.cuda.reset_peak_memory_stats()
        stamps = [time.perf_counter()]
        model, engine, trace, c, v, run = moe_engine_run(arch, device, **kw)
        stamps.append(time.perf_counter())
        cfg = model.cfg
        path = cfg.name if kw["n_layers"] is None \
            else f"{cfg.name} ({cfg.n_layers} layers)"
        counts[path], variants[path] = c, v
        L = cfg.n_layers
        params = engine.params
        del engine
        prompt = trace[0].prompt_tokens
        if cfg.sliding_window:
            longest = max(kw["prompt_lens"]) + kw["max_new"]
            emit({"phase": "moe", "arch": cfg.name,
                  "sliding_window": cfg.sliding_window,
                  "longest_sequence": longest,
                  "window_masks": longest > cfg.sliding_window,
                  "note": "the window never masks at these lengths; "
                          "phase 3 gates the kernels' window"})
        # the served bf16 path, kernels vs plain: reported
        logits_check(model, params, prompt, device, gate=False,
                     n_flash=(L, 0), phase="moe")
        stamps.append(time.perf_counter())
        if kw["n_layers"] is None:
            emit({"phase": "moe", "arch": cfg.name,
                  "check": "decode step device time",
                  **moe_decode_breakdown(model, params, device,
                                         [250 + 9 * i for i in range(8)]),
                  "engine_wall_s": run["wall_s"],
                  "engine_tokens_per_s": run["tokens_per_s"]})
        stamps.append(time.perf_counter())
        # the same weights upcast exactly, computed in fp32: gated under
        # the routing-tie rule (the bf16 copy above is all that is held)
        gc.collect()
        torch.cuda.empty_cache()
        model32 = build_model(dataclasses.replace(
            cfg, compute_dtype="float32"), device=device)
        logits_check(model32, model32.load(params), prompt, device,
                     gate=True, n_flash=(L, 0), phase="moe")
        del model32, params, model
        gc.collect()
        torch.cuda.empty_cache()
        stamps.append(time.perf_counter())
        emit({"phase": "moe", "arch": cfg.name, "seconds": dict(zip(
            ("draw_and_serve", "bf16_logits", "profile", "fp32_gate"),
            (b - a for a, b in zip(stamps, stamps[1:])))),
              "total_s": stamps[-1] - stamps[0],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return counts, variants


# ---------------------------------------------------------------------------
# phase 10: training (olmo-1b at full width and depth, qwen1.5-0.5b at full
# width; the fp32 gate, fault tolerance and the optimizer offload on
# olmo-1b's first 2 layers)
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 10
TRAIN_CUT = 2                   # layers of the gates and of (d), (e): olmo's,
                                # olmoe's, and each of whisper's two stacks
BF16_TRAJ_TOL = 1e-2            # bf16 loss, kernels against plain, per step
CKPT_DIR = Path(__file__).resolve().parent / "build" / "smoke_ckpt"
# olmoe-1b-7b's depth for (h): a layer is 419.6e6 parameters, and training
# holds ~29 bytes of each (fp32 masters, two AdamW moments, the next
# state's, fp32 gradients, the bf16 copy: olmo-1b's (a) peaks near 34.4 GB
# for 1.177e9 on an H100); 4 of 16 layers and the 103e6-parameter table
# come to ~1.78e9, near 52 GB, and (h)'s twice-in-bits check holds a third
# state of 21.4 GB beside them; all 16 need 82 GB for masters and moments
OLMOE_TRAIN_DEPTH = 4
# zamba2-7b's depth for (k): its first 15 of 81 layers are 2 groups of
# [the shared block, 6 Mamba2 layers] and 3 tail layers, the full
# model's layout in small.  A Mamba2 layer at d=3584 is 78.0e6
# parameters, the shared block 205.5e6 and the table 114.7e6, so 15
# layers come to 1.49e9, ~43 GB at ~29 bytes a parameter (olmoe's 1.78e9
# peaked at 52.63 GB), and ~61 GB with the twice check's third state
# (12 bytes a parameter); all 81 (6.64e9) need 80 GB for the fp32
# masters and moments alone
ZAMBA2_TRAIN_DEPTH = 15
ZAMBA2_GATE_DEPTH = 7   # one group and one tail layer: the shared block
# the learning rate of a bf16 trajectory whose cut, with no warmup, does
# not train at the CLI's 3e-4: there zamba2's 7 layers jump from loss
# 10.97 to 17.6 after one step and wander (on an H100), and the two
# paths' bf16 roundings grow apart with them; at 1e-5 the loss falls
# from the first step
TRAJ_LR = {"zamba2-7b": 1e-5}
WHISPER_DEC_SEQ = 448           # whisper's published n_text_ctx
FRAME_SEED = 11                 # numpy seed of whisper's frame embeddings


def train_counts():
    from repro_torch import kernels
    return {**kernels.launch_counts(), **kernels.backward_counts()}


def train_seq(cfg) -> int:
    """The token sequence a training batch of ``cfg`` carries: 512, or
    whisper's decoder context of 448."""
    return WHISPER_DEC_SEQ if cfg.family == "encdec" else TRAIN_SEQ


def train_batches(cfg, pipe, n, device):
    """The pipeline's next ``n`` batches; an encdec batch also carries
    ``frame_embeds`` (B, enc_seq, d_model), as the reference's
    ``input_specs`` define it: drawn with numpy from ``FRAME_SEED``, in
    bf16 on the card."""
    import numpy as np
    import torch
    batches = [pipe.next_batch() for _ in range(n)]
    if cfg.family == "encdec":
        rng = np.random.default_rng(FRAME_SEED)
        for b in batches:
            b["frame_embeds"] = torch.from_numpy(rng.standard_normal(
                (TRAIN_BATCH, cfg.enc_seq, cfg.d_model), dtype=np.float32)
            ).to(device=device, dtype=torch.bfloat16)
    return batches


def attention_layers(cfg) -> int:
    """Flash calls in one forward: one per layer, two (self and cross)
    per decoder layer of an encoder-decoder, none in mamba2, one per
    group (the shared block) in a hybrid."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def train_launches(cfg, steps: int) -> dict:
    """Kernel launches of ``steps`` training steps (remat on), forward and
    backward: each rematted layer runs its forward kernels twice (forward
    and recompute) and its backward kernels once.  Every layer is
    rematted but a hybrid's tail Mamba2 layers (the reference's remat is
    its group body).  RMSNorm: two per block (a Mamba2 layer's input and
    gated norms, a transformer block's two) and the final norm, where the
    model has RMSNorm; the SSD scan once per Mamba2 layer."""
    L = cfg.n_layers
    A = attention_layers(cfg)
    mamba = L if cfg.family in ("ssm", "hybrid") else 0
    remat_mamba = mamba
    if cfg.family == "hybrid":
        remat_mamba = A * cfg.attn_every        # the groups' layers
    blocks = L + (A if cfg.family == "hybrid" else 0)
    remat_blocks = blocks - (mamba - remat_mamba)
    norms = 2 * blocks + 1 if cfg.norm_type == "rmsnorm" else 0
    remat_norms = 2 * remat_blocks if norms else 0
    return {"paged_attention": 0,
            "ssd_scan": (mamba + remat_mamba) * steps,
            "ssd_scan_bwd": mamba * steps,
            "flash_attention": 2 * A * steps,
            "flash_attention_bwd": A * steps,
            "rmsnorm": (norms + remat_norms) * steps,
            "rmsnorm_bwd": norms * steps}


def cut(arch, n_layers, **kw):
    """``arch``'s full-width config on its first ``n_layers`` layers (each
    stack of an encoder-decoder)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.family == "encdec":
        kw["n_enc_layers"] = n_layers
    return dataclasses.replace(cfg, n_layers=n_layers, **kw)


def train_parts(cfg, device, lr=None, **step_kw):
    """The training CLI's parts (``repro_torch.launch.train``): the model
    on the card, AdamW at the CLI's defaults (``lr``: another learning
    rate), remat on, the synthetic data pipeline at B=8 x S=512 (S=448
    for whisper), and the step."""
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import train as train_rt

    model = build_model(cfg, device=device)
    opt = AdamW() if lr is None else AdamW(lr=lr)
    step = train_rt.make_train_step(
        model, opt, ShapeConfig("smoke", "train", train_seq(cfg),
                                TRAIN_BATCH),
        tcfg=train_rt.TrainStepConfig(), **step_kw)
    pipe = DataPipeline(DataConfig(vocab=cfg.vocab, seq_len=train_seq(cfg),
                                   global_batch=TRAIN_BATCH))
    return model, opt, step, pipe


def grad_leaves_check(cfg, grads, routing):
    """Step 1's gradient leaves: (leaves, names of the bad ones, exempt).
    Every leaf is finite and non-zero (a kernel whose output left the
    graph would leave its inputs' leaves without one), with two
    exemptions, named in ``exempt``: an expert that no token reached
    (its slice of ``w_gate``, ``w_up``, ``w_down`` is zero; ``routing``
    records each expert layer's routing) and an attention key bias of
    whisper's (no RoPE: softmax is invariant to the shift q.bk, so its
    gradient is exactly zero in exact arithmetic)."""
    import torch
    from repro_torch.tree import leaf_groups
    reached = [torch.bincount(r["expert_idx"].flatten(),
                              minlength=cfg.n_experts) > 0 for r in routing]
    names, ok, exempt = [], [], []
    for name, leaves, _ in leaf_groups(grads):
        for layer, g in enumerate(leaves):
            names.append(name)
            if name.endswith("/bk") and cfg.family == "encdec":
                exempt.append(f"{name}[{layer}]")
                ok.append(torch.isfinite(g).all())
                continue
            nonzero = g.abs().max() > 0
            if name in ("layers/moe/w_gate", "layers/moe/w_up",
                        "layers/moe/w_down"):
                alive = g.flatten(1).abs().amax(1) > 0
                exempt.extend(f"{name}[{layer}] expert {e}" for e in
                              (~reached[layer]).nonzero().flatten().tolist())
                nonzero = (alive | ~reached[layer]).all()
            ok.append(torch.isfinite(g).all() & nonzero)
    bad = sorted({n for n, f in zip(names, torch.stack(ok).tolist())
                  if not f})
    return len(names), bad, exempt


def train_flops(cfg, params) -> float:
    """Model FLOPs of one training step: 8 N T for the matrix products
    (forward, remat recompute, and the backward's two), N the parameters
    a token's products read (an moe token the router's top k of its
    experts; a hybrid's shared block once per use) and T the tokens they
    run on (whisper: its encoder's over the frames, its decoder's over
    the text, its cross-attention K and V over the frames, outside
    remat: 6 N T; a hybrid's tail Mamba2 layers, outside remat too:
    6 N T), plus 4.5 forwards (forward, recompute, 2.5 in the backward)
    of attention's q K^T and P V over the (query, key) pairs each mask
    keeps, and 4 of each Mamba2 layer's SSD products (forward,
    recompute, 2 in the backward; ``ssd_work``'s count; 3 in a tail
    layer)."""
    from repro_torch.tree import leaf_groups

    def n(tree):
        return sum(t.numel() for _, ts, _ in leaf_groups(tree) for t in ts)

    B, S = TRAIN_BATCH, train_seq(cfg)
    causal = S * (S + 1) // 2

    def attn(pairs, layers):
        return 4.5 * 4 * cfg.head_dim * cfg.n_heads * B * pairs * layers

    if cfg.family == "encdec":
        F = cfg.enc_seq
        cross_kv = sum(n(layer["cross_attn"][w]) for layer in
                       params["dec_layers"] for w in ("wk", "bk", "wv", "bv"))
        dec = n(params["dec_layers"]) - cross_kv + n(params["embedding"])
        return (8 * n(params["enc_layers"]) * B * F + 8 * dec * B * S
                + 6 * cross_kv * B * F
                + attn(F * F, cfg.n_enc_layers)
                + attn(causal + S * F, cfg.n_layers))
    active = n(params)
    if cfg.family in ("ssm", "hybrid"):
        tail = params.get("mamba_tail", [])
        ssd = (4 * cfg.n_layers - len(tail)) * ssd_work(
            B, S, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_n_groups,
            cfg.ssm_state, cfg.ssm_chunk, 2)[1]
        uses = attention_layers(cfg)
        if uses:
            active += (uses - 1) * n(params["shared_attn"])
        return ((8 * active - 2 * n(tail)) * B * S + attn(causal, uses)
                + ssd)
    if cfg.family == "moe":
        experts = sum(n(layer["moe"][w]) for layer in params["layers"]
                      for w in ("w_gate", "w_up", "w_down"))
        active -= experts * (1 - cfg.top_k / cfg.n_experts)
    return 8 * active * B * S + attn(causal, cfg.n_layers)


def twice_in_bits(step, state, batch):
    """The step run twice from ``state`` on ``batch``: (whether the two
    new states and metrics are equal in bits, the peak device memory of
    the check).  Both new states share the card with ``state``: three
    states of olmoe's 4 layers (21.4 GB each) fit beside a step's
    activations, and a host copy of one would cost more than the
    steps."""
    import torch
    from repro_torch.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    first, m1 = step(state, batch)
    second, m2 = step(state, batch)
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(first), tree_leaves(second)))
    same = same and all(torch.equal(m1[k], m2[k]) for k in m1)
    return same, torch.cuda.max_memory_allocated()


def train_full_width(arch, device, smi, n_layers=None, record=None):
    """10 steps at full width (bf16 compute, fp32 masters, remat on), at
    full depth or on the first ``n_layers``: the loss falls; on step 1
    every parameter leaf has a finite, non-zero gradient
    (``grad_leaves_check``); the launches are exact per step
    (``train_launches``), every forward and backward on the compute
    dtype's variant.  A model other than the dense ones then runs one
    step twice from the same state, required equal in bits (the moe
    dispatch's fixed-order backward, the SSD backward's fixed-order
    sums).  Then 2 more steps plain and 2 profiled give the device's
    busy share.  Returns the run's counts and variants; ``record`` (a
    dict) gets the 10 losses under the config's name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.moe import record_routing
    from repro_torch.runtime import train as train_rt
    from repro_torch.tree import leaf_groups

    cfg = get_config(arch) if n_layers is None else cut(arch, n_layers)
    model, opt, step, pipe = train_parts(cfg, device)
    state = train_rt.init_state(
        model, opt, torch.Generator(device=device).manual_seed(0))
    n_params = sum(t.numel() for _, ts, _ in leaf_groups(state.params)
                   for t in ts)
    flops = train_flops(cfg, state.params)
    batches = train_batches(cfg, pipe, TRAIN_STEPS + 4, device)
    # step 1's gradients, as the step computes them
    with record_routing() as routing:
        _, grads = train_rt._accumulated_grads(
            model, state.params, {k: torch.as_tensor(v, device=device)
                                  for k, v in batches[0].items()},
            train_rt.TrainStepConfig())
    n_leaves, bad, exempt = grad_leaves_check(cfg, grads, routing)
    del grads, routing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, norms, secs = [], [], []
    for k in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[k])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    counts = train_counts()
    variants = {**kernels.variant_counts(),
                **kernels.backward_variant_counts()}
    peak = torch.cuda.max_memory_allocated()
    if record is not None:
        record[cfg.name] = losses

    L, n = cfg.n_layers, TRAIN_STEPS
    want = train_launches(cfg, n)
    s_step = statistics.mean(secs[1:])
    tokens = TRAIN_BATCH * train_seq(cfg)
    twice = None
    if cfg.family != "dense":
        t0 = time.perf_counter()
        twice, twice_peak = twice_in_bits(step, state, batches[n])
        twice_s = time.perf_counter() - t0

    # the busy share: 2 steps timed plain, the same 2 profiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[n:n + 2]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches[n + 2:n + 4]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
    busy = device_time(prof, wall2)
    emit({"phase": "train", "arch": cfg.name, "nvidia_smi": smi,
          "layers": L, "d_model": cfg.d_model, "params": n_params,
          "batch": TRAIN_BATCH, "seq": train_seq(cfg), "steps": n,
          **({"enc_layers": cfg.n_enc_layers, "frames": cfg.enc_seq}
             if cfg.family == "encdec" else {}),
          "compute_dtype": cfg.compute_dtype, "remat": True,
          "losses": losses, "grad_norms": norms, "step_s": secs,
          "s_per_step": s_step, "tokens_per_s": tokens / s_step,
          "peak_mem_gb": peak / 1e9, "model_flops_per_step": flops,
          "model_flops_share_of_989T": flops / s_step / BF16_FLOPS,
          "step1_grad_leaves": n_leaves, "step1_bad_leaves": bad,
          "step1_exempt_from_nonzero": exempt,
          **({} if twice is None else {
              "step_twice_same_bits": twice, "step_twice_s": twice_s,
              "step_twice_peak_mem_gb": twice_peak / 1e9}),
          "launches": counts,
          "expected_launches": want, "kernel_variants": variants,
          "profiled_wall_s_2_steps": wall2, **busy})
    check(not bad, f"{cfg.name}: leaves without a finite non-zero gradient "
          f"on step 1: {bad}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"{cfg.name}: a non-finite loss or gradient norm")
    check(losses[-1] < losses[0], f"{cfg.name}: the loss did not fall: "
          f"{losses}")
    check(counts == want, f"{cfg.name} train: launches {counts} != {want}")
    check_flash_variant(f"{cfg.name} train", cfg.compute_dtype, variants,
                        counts["flash_attention"])
    check_backward_variant(f"{cfg.name} train", cfg.compute_dtype, variants,
                           counts["flash_attention_bwd"])
    check_backward_variant(f"{cfg.name} train", cfg.compute_dtype, variants,
                           counts["ssd_scan_bwd"], "ssd_scan_bwd")
    check_ssd_variant(f"{cfg.name} train", cfg.compute_dtype, variants,
                      counts["ssd_scan"])
    check(twice is not False, f"{cfg.name}: one step run twice from one "
          f"state gave other bits")
    return counts, variants


def check_backward_variant(what, compute, variants, n,
                           kernel="flash_attention_bwd"):
    """``n`` calls of the backward ``kernel`` (flash's, or B8
    ``ssd_scan_bwd``), all on the kernel of the compute dtype: the
    tensor-core one in bf16, the CUDA-core one in fp32."""
    got = {v: variants[f"{kernel}.{v}"] for v in ("tc", "f32")}
    want = {"tc": n if compute == "bfloat16" else 0,
            "f32": n if compute == "float32" else 0}
    check(got == want, f"{what} ({compute}): {kernel} calls by variant "
          f"{got}, expected {want}")


def kernels_against_plain(cfg, device, seed, steps, lr=None):
    """``steps`` training steps of ``cfg`` from one seeded init on the
    same batches, through the kernels and under ``plain_versions()``, at
    the CLI's learning rate or ``lr``: {plain: ([(loss, grad norm)] a step,
    launches, backward variants, [each step's routing,
    ``moe.record_routing``'s records])}."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.models.moe import record_routing
    from repro_torch.runtime import train as train_rt
    from repro_torch.tree import tree_map

    model, opt, step, pipe = train_parts(cfg, device, lr)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    batches = train_batches(cfg, pipe, steps, device)
    runs = {}
    for plain in (False, True):
        state = train_rt.state_from_params(tree_map(torch.clone, params), opt)
        kernels.reset_launch_counts()
        metrics, routing = [], []
        with (ops.plain_versions() if plain else contextlib.nullcontext()):
            for b in batches:
                with record_routing() as r:
                    state, m = step(state, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                routing.append(r)
        runs[plain] = (metrics, train_counts(),
                       kernels.backward_variant_counts(), routing)
        del state
    return runs


def fp32_gate(device, arch="olmo-1b", layers=TRAIN_CUT):
    """``arch`` at full width on its first ``layers`` layers in fp32: 3
    steps through the kernels (the fp32 kernels forward and backward)
    against 3 steps of the same under ``plain_versions()``, from the same
    weights on the same batches: loss and grad norm to 1e-5 relative,
    the launches exact (``train_launches``).
    For an moe model each step's routing is held to ``routing_gate`` (on
    step 1, whose weights are equal, a flip beyond fp32 noise fails the
    run; later steps report theirs) and a step is gated only while the
    routing of every step so far is equal."""
    cfg = cut(arch, layers, compute_dtype="float32")
    runs = kernels_against_plain(cfg, device, 1, 3)
    gaps = [max(abs(a - b) / abs(b) for a, b in zip(got, want))
            for got, want in zip(runs[False][0], runs[True][0])]
    gated, equal = [], True
    for k, (got, want) in enumerate(zip(runs[False][3], runs[True][3])):
        routing_gate(f"train step {k + 1}", got, want, k == 0, "train",
                     cfg.name)
        flips, keep_diff, _ = routing_flips(got, want)
        equal = equal and not flips and not keep_diff
        gated.append(equal)
    A = attention_layers(cfg)
    want = train_launches(cfg, 3)
    emit({"phase": "train", "check": "fp32 gate", "arch": cfg.name,
          "layers": layers, "steps": 3,
          "kernel_loss_grad_norm": runs[False][0],
          "plain_loss_grad_norm": runs[True][0], "max_rel_gap": gaps,
          "gated_steps": gated, "tol": TOL["float32"],
          "kernel_launches": runs[False][1],
          "kernel_backward_variants": runs[False][2],
          "plain_launches": runs[True][1]})
    check(all(g <= TOL["float32"] for g, on in zip(gaps, gated) if on),
          f"{cfg.name} fp32 gate: loss / grad norm gaps {gaps} over "
          f"{TOL['float32']} (gated steps {gated})")
    check(runs[False][1] == want and not any(runs[True][1].values()),
          f"{cfg.name} fp32 gate: launches {runs[False][1]} (want {want}), "
          f"plain path {runs[True][1]}")
    check_backward_variant(f"{cfg.name} fp32 gate", cfg.compute_dtype,
                           runs[False][2], A * 3)
    check_backward_variant(f"{cfg.name} fp32 gate", cfg.compute_dtype,
                           runs[False][2], want["ssd_scan_bwd"],
                           "ssd_scan_bwd")


def bf16_trajectory(device, arch="olmo-1b", layers=TRAIN_CUT, lr=None):
    """``arch`` at full width on its first ``layers`` layers in bf16 (the
    training path's compute): 10 steps through the kernels (every flash
    backward on the tensor-core kernel, the launches exact) against 10
    steps under ``plain_versions()``, from the same weights on the same
    batches: each step's loss within ``BF16_TRAJ_TOL`` relative of the
    plain path's, the gaps printed.  bf16 rounds at other places on the
    two paths, so the trajectories are not equal in bits; a gap over the
    limit fails the run.  ``lr`` replaces the CLI's learning rate (see
    ``TRAJ_LR``)."""
    from repro_torch.optim.adamw import AdamW
    cfg = cut(arch, layers)
    t0 = time.perf_counter()
    runs = kernels_against_plain(cfg, device, 4, TRAIN_STEPS, lr)
    losses = {plain: [m[0] for m in runs[plain][0]] for plain in runs}
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses[False],
                                                losses[True])]
    n = attention_layers(cfg) * TRAIN_STEPS
    emit({"phase": "train", "check": "bf16 trajectory", "arch": cfg.name,
          "layers": layers, "steps": TRAIN_STEPS,
          "compute_dtype": cfg.compute_dtype,
          "kernel_losses": losses[False], "plain_losses": losses[True],
          "rel_gaps": gaps, "tol": BF16_TRAJ_TOL, "lr": lr or AdamW.lr,
          "kernel_launches": runs[False][1],
          "kernel_backward_variants": runs[False][2],
          "plain_launches": runs[True][1],
          "seconds": time.perf_counter() - t0})
    check(all(g <= BF16_TRAJ_TOL for g in gaps),
          f"{cfg.name} bf16 trajectory: loss gaps {gaps} over "
          f"{BF16_TRAJ_TOL}")
    check_backward_variant(f"{cfg.name} bf16 trajectory", cfg.compute_dtype,
                           runs[False][2], n)
    check_backward_variant(f"{cfg.name} bf16 trajectory", cfg.compute_dtype,
                           runs[False][2],
                           train_launches(cfg, TRAIN_STEPS)["ssd_scan_bwd"],
                           "ssd_scan_bwd")
    check(runs[False][1] == train_launches(cfg, TRAIN_STEPS)
          and not any(runs[True][1].values()),
          f"{cfg.name} bf16 trajectory: launches {runs[False][1]}, plain "
          f"path {runs[True][1]}")


def fault_tolerance(device):
    """olmo-1b at full width on its first 2 layers, bf16: the training
    CLI's fault-tolerant loop (checkpoint every 2 steps with the port's
    own ``ckpt.save``, asynchronous) run 3 steps, once clean and once
    with a failure injected at the third that outlasts the retries, so
    the loop restores the step-2 checkpoint from disk and replays: the
    two final states equal in bits."""
    import shutil

    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.runtime import ft
    from repro_torch.runtime import train as train_rt
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=TRAIN_CUT)
    params = None
    finals, loops = [], []
    t_start = time.perf_counter()
    for fail in (False, True):
        model, opt, step, pipe = train_parts(cfg, device)
        if params is None:
            params = model.init(torch.Generator(device=device).manual_seed(2))
        state = train_rt.state_from_params(tree_map(torch.clone, params), opt)
        path = CKPT_DIR / f"run{int(fail)}"
        saved = {}

        def save_fn(s, k, path=path, pipe=pipe):
            # one directory per step, as the training CLI's: an async
            # save may still be writing the last one
            saved["path"] = path / f"step{k}"
            saved.setdefault("handles", []).append(ckpt.save(
                saved["path"],
                {"params": s.params, "mu": s.opt.mu, "nu": s.opt.nu},
                step=k, extra={"pipeline": pipe.state.to_dict()},
                asynchronous=True))

        errors = []

        def guarded_step(s, batch, step=step, errors=errors):
            try:
                return step(s, batch)
            except Exception as e:
                errors.append(e)
                raise

        def restore_fn(template=state, errors=errors):
            # the loop retries whatever fails, forever (C-ref6): a real
            # step failure, not the injected one, ends the smoke here
            if errors:
                raise RuntimeError("fault tolerance: a step failed") \
                    from errors[0]
            saved["handles"][-1].wait()
            tree, meta = ckpt.restore(saved["path"], {
                "params": template.params,
                "mu": template.opt.mu, "nu": template.opt.nu})
            k = meta["step"]
            return train_rt.TrainState(tree["params"], AdamWState(
                torch.tensor(k, dtype=torch.int32, device=device),
                tree["mu"], tree["nu"]), {}), k

        left = {"n": 3 if fail else 0}

        def failure_hook(k, left=left):
            if k == 2 and left["n"]:
                left["n"] -= 1
                raise RuntimeError("injected failure")

        loop = ft.FaultTolerantLoop(
            guarded_step, save_fn, restore_fn, pipe, ckpt_every=2,
            retry=ft.RetryPolicy(max_retries=1, backoff_s=0.0),
            failure_hook=failure_hook)
        finals.append(loop.run(state, 3))
        for handle in saved["handles"]:
            handle.wait()
        loops.append(loop)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(finals[0]),
                                                 tree_leaves(finals[1])))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit({"phase": "train", "check": "fault tolerance", "arch": cfg.name,
          "layers": TRAIN_CUT, "steps": 3, "ckpt_every": 2,
          "restarts": [lp.restarts for lp in loops],
          "history_steps": [[h["step"] for h in lp.history] for lp in loops],
          "losses": [[h["loss"] for h in lp.history] for lp in loops],
          "same_bits": same, "seconds": time.perf_counter() - t_start})
    check([lp.restarts for lp in loops] == [0, 1],
          f"fault tolerance: restarts {[lp.restarts for lp in loops]}")
    check(same, "fault tolerance: the recovered run's state differs from "
          "the clean run's")


def offload_check(device):
    """olmo-1b at full width on its first 2 layers, bf16: 2 steps with
    the AdamW moments offloaded to pinned host memory
    (``TieringPolicy(offload_optimizer=True)``, as ``--offload-optimizer``)
    against 2 steps with them in HBM, from the same weights: the same
    bits, and a lower peak of device memory (each run's peak over its
    steps, the other run's state moved off the card).  Reports the
    host<->device bytes a step moves, measured from the moments' sizes,
    beside ``tier_traffic_report``'s count at full depth."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tiering import TieringPolicy, tier_traffic_report
    from repro_torch.runtime import train as train_rt
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=TRAIN_CUT)
    policy = TieringPolicy(offload_optimizer=True)
    finals, secs, peaks = [], [], []
    params = None
    for tiering in (None, policy):
        model, opt, step, pipe = train_parts(cfg, device, tiering=tiering)
        if params is None:
            params = model.init(torch.Generator(device=device).manual_seed(3))
        state = train_rt.state_from_params(tree_map(torch.clone, params), opt,
                                           tiering=tiering)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for b in [pipe.next_batch() for _ in range(2)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        mu = state.opt.mu
        on_host = all(t.device.type == "cpu" and t.is_pinned()
                      for t in tree_leaves(mu))
        finals.append(tree_map(lambda t: t.cpu(), state))
        del state
    moment_bytes = 2 * sum(t.numel() * t.element_size()
                           for t in tree_leaves(mu))
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(finals[0]), tree_leaves(finals[1])))
    # olmo-1b's parameters: the tied table, and per layer q, k, v, o and
    # the gated MLP (its LayerNorm has none)
    full = get_config("olmo-1b")
    n_full = full.padded_vocab * full.d_model + full.n_layers * (
        4 * full.d_model ** 2 + 3 * full.d_model * full.d_ff)
    emit({"phase": "train", "check": "offload optimizer", "arch": cfg.name,
          "layers": TRAIN_CUT, "steps": 2, "same_bits": same,
          "moments_pinned_on_host": on_host,
          "host_device_bytes_per_step": 2 * moment_bytes,
          "full_depth_tier2_bytes_per_step": tier_traffic_report(
              policy, n_full)["tier2_bytes_per_step"],
          "peak_mem_gb_in_hbm": peaks[0] / 1e9,
          "peak_mem_gb_offloaded": peaks[1] / 1e9,
          "peak_reduction_gb": (peaks[0] - peaks[1]) / 1e9,
          "step_s_in_hbm": secs[:2], "step_s_offloaded": secs[2:]})
    check(on_host, "offload: the moments are not in pinned host memory")
    check(same, "offload: the offloaded step's state differs from the "
          "in-HBM step's")
    check(peaks[1] < peaks[0], f"offload: peak device memory {peaks[1]} "
          f"bytes offloaded, not under {peaks[0]} in HBM")


def train_cli(device, smi):
    """The training entry point itself (``repro_torch.launch.train.main``,
    as ``python -m repro_torch.launch.train`` runs it, on its default
    device): olmo-1b at full width and depth, B=8 x S=512, 10 steps with
    the moments in HBM, 4 with ``--offload-optimizer`` and 2 through
    ``--pool scalepool`` with a tier-2 reservation (the lease's policy
    offloads the moments), and mamba2-780m at full width and depth, 3
    steps, each run's peak device memory beside its JSON.  Every run
    exits 0 (its loss fell) on the card, and the offloaded peak is the
    lower.  No run reaches the CLI's checkpoint
    interval (14 GB a save at this depth); (d) runs the same
    asynchronous ``ckpt.save`` on the card."""
    import io

    import torch
    from repro_torch.launch import train as train_cli_mod

    t_start = time.perf_counter()
    full = ["--arch", "olmo-1b", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ)]
    runs = {"in HBM": full + ["--steps", "10"],
            "offload": full + ["--steps", "4", "--offload-optimizer"],
            "pool": full + ["--steps", "2", "--pool", "scalepool",
                            "--pool-tier2-gb", "8"],
            "mamba2": ["--arch", "mamba2-780m", "--batch", str(TRAIN_BATCH),
                       "--seq", str(TRAIN_SEQ), "--steps", "3"]}
    for name, argv in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_cli_mod.main(argv)
        out = json.loads(buf.getvalue())
        peak = torch.cuda.max_memory_allocated()
        emit({"phase": "train", "check": f"CLI {name}", "nvidia_smi": smi,
              "argv": argv, "rc": rc, "cli": out,
              "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9})
        check(rc == 0 and out["device"].startswith("cuda"),
              f"training CLI ({name}): rc {rc} on {out['device']}, "
              f"losses {out['loss_first']} -> {out['loss_last']}")
        runs[name] = (out, peak)
    check(runs["pool"][0]["lease"]["offload_optimizer"],
          "training CLI (pool): the lease's policy did not offload")
    check(runs["offload"][1] < runs["in HBM"][1],
          f"training CLI: peak {runs['offload'][1]} bytes with "
          f"--offload-optimizer, not under {runs['in HBM'][1]}")
    emit({"phase": "train", "check": "CLI", "seconds":
          time.perf_counter() - t_start})


def train_cli_refusals():
    """The training CLI refuses before its loop what no step could do
    (its fault-tolerant loop would retry the step forever): ``--smoke``
    on the card, each in a process of its own (exit code 2 and the reason
    within 30 s): olmo-1b's head_dim 16, which the flash backward does
    not take, and mamba2-780m's SSD head_dim P=16, which the SSD kernels
    do not take; and whisper-small, for whose encoder the data pipeline
    yields no ``frame_embeds``."""
    import io
    import os

    from repro_torch.launch import train as train_cli_mod

    root = Path(__file__).resolve().parent
    # both at once; each one's seconds run to its exit or later
    t0 = time.perf_counter()
    started = {arch: (subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--arch", arch, "--steps", "2", "--ckpt-dir", str(CKPT_DIR)],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), reason)
        for arch, reason in (("olmo-1b", "head_dim"),
                             ("mamba2-780m", "P in (32, 64)"))}
    smoke = {}
    for arch, (proc, reason) in started.items():
        _, stderr = proc.communicate(timeout=120)
        smoke[arch] = (subprocess.CompletedProcess(
            proc.args, proc.returncode, stderr=stderr),
            time.perf_counter() - t0, reason)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc_encdec = train_cli_mod.main(["--arch", "whisper-small",
                                        "--steps", "1"])
    emit({"phase": "train", "check": "CLI refusals",
          "smoke": {arch: {"rc": proc.returncode, "seconds": secs,
                           "stderr": proc.stderr.strip().splitlines()[-1:]}
                    for arch, (proc, secs, _) in smoke.items()},
          "whisper_rc": rc_encdec, "whisper_stderr": err.getvalue().strip()})
    for arch, (proc, secs, reason) in smoke.items():
        check(proc.returncode == 2 and reason in proc.stderr and secs < 30,
              f"training CLI --smoke --arch {arch} on the card: rc "
              f"{proc.returncode} after {secs:.1f} s: {proc.stderr[-400:]}")
    check(rc_encdec == 2 and "frame_embeds" in err.getvalue(),
          f"training CLI whisper-small: rc {rc_encdec}: {err.getvalue()}")


def train_families(device, smi):
    """Phase 10 (h) olmoe-1b-7b at full width on its first
    ``OLMOE_TRAIN_DEPTH`` layers and (i) whisper-small at full width and
    depth (1500 frames, decoder S=448), each as (a) with its fp32 gate on
    its first 2 layers; whisper's bf16 trajectory on them too.  Returns
    the two paths' counts and variants."""
    import torch
    counts, variants = {}, {}
    for arch, depth in (("olmoe-1b-7b", OLMOE_TRAIN_DEPTH),
                        ("whisper-small", None)):
        counts[f"{arch} train"], variants[f"{arch} train"] = \
            train_full_width(arch, device, smi, depth)
        gc.collect()
        torch.cuda.empty_cache()
        fp32_gate(device, arch)
        gc.collect()
        torch.cuda.empty_cache()
    bf16_trajectory(device, "whisper-small")
    gc.collect()
    torch.cuda.empty_cache()
    return counts, variants


def train_ssm_families(device, smi):
    """Phase 10 (j) mamba2-780m at full width and depth and (k) zamba2-7b
    at full width on its first ``ZAMBA2_TRAIN_DEPTH`` layers, each as (a)
    (every leaf a finite non-zero gradient, launches exact: the SSD scan
    forward and recompute and its backward B8, RMSNorm and B6 on every
    norm, zamba2's shared block on flash B3 and B5 at head_dim 112; the
    report (f)) plus one step run twice from one state, equal in bits,
    its fp32 gate and its bf16 trajectory (mamba2 on its first 2 layers,
    zamba2 on its first ``ZAMBA2_GATE_DEPTH``, so the shared block
    runs).  Returns the two paths' counts and variants."""
    import torch
    counts, variants = {}, {}
    for arch, depth, gate in (("mamba2-780m", None, TRAIN_CUT),
                              ("zamba2-7b", ZAMBA2_TRAIN_DEPTH,
                               ZAMBA2_GATE_DEPTH)):
        counts[f"{arch} train"], variants[f"{arch} train"] = \
            train_full_width(arch, device, smi, depth)
        gc.collect()
        torch.cuda.empty_cache()
        fp32_gate(device, arch, gate)
        gc.collect()
        torch.cuda.empty_cache()
        bf16_trajectory(device, arch, gate, TRAJ_LR.get(arch))
        gc.collect()
        torch.cuda.empty_cache()
    return counts, variants


def train_phase(device, smi, record=None):
    """Phase 10: (a) olmo-1b and (c) qwen1.5-0.5b trained at full width,
    (b) the fp32 gate, (b2) the bf16 trajectory, (d) fault tolerance,
    (e) the optimizer offload, (g) the training CLI itself and its
    refusals, (h) olmoe-1b-7b, (i) whisper-small, (j) mamba2-780m and
    (k) zamba2-7b; the report (f) is in each line.  Returns the six
    paths' counts and variants; ``record`` gets (a)'s and (c)'s losses
    (phase 12 holds its trajectories to (c)'s)."""
    import torch
    t0 = time.perf_counter()
    counts, variants = {}, {}
    for arch in ("olmo-1b", "qwen1.5-0.5b"):
        counts[f"{arch} train"], variants[f"{arch} train"] = \
            train_full_width(arch, device, smi, record=record)
        gc.collect()
        torch.cuda.empty_cache()
    for part in (fp32_gate, bf16_trajectory, fault_tolerance, offload_check):
        part(device)
        gc.collect()
        torch.cuda.empty_cache()
    train_cli(device, smi)
    train_cli_refusals()
    # the CLI runs in this process: what its last run left in reference
    # cycles goes before the largest training check, (h)'s twice-in-bits
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    more = train_families(device, smi)
    counts.update(more[0])
    variants.update(more[1])
    t2 = time.perf_counter()
    more = train_ssm_families(device, smi)
    counts.update(more[0])
    variants.update(more[1])
    emit({"phase": "train", "seconds": time.perf_counter() - t0,
          "families_seconds": t2 - t1,
          "ssm_families_seconds": time.perf_counter() - t2})
    return counts, variants


# ---------------------------------------------------------------------------
# phase 11: data-parallel training across processes: qwen1.5-0.5b on a
# (pod 2, data 2, model 1) grid of 4 ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

DP_LAYOUT = ((2, 2, 1), ("pod", "data", "model"))
DP_STEPS = 4                    # (b)'s steps a mode; s/step over 2-4
# (b)'s depth: qwen1.5-0.5b's first 6 of 24 layers, cut when phase 12
# took the smoke past 1050 s (1064 s on an H100 80GB HBM3 at 700 W);
# the collectives move the 0.93 GB flat buffer of 6 layers and the table
# (1.86 GB at full depth); auto's losses are held to the one-process
# step's on the same cut, run by rank 0
DP_DEPTH = 6
DP_MODES = {"auto": ("auto", False), "hierarchical": ("hierarchical", False),
            "compress_pod": ("hierarchical", True)}
DP_DIR = Path(__file__).resolve().parent / "build" / "phase11"
DP_WORLD_LIMIT_S = 300.0        # the (a)-(c) world's wall-clock limit
DP_CLI_LIMIT_S = 240.0          # (d)'s torch.distributed.run
DP_COLLECTIVE_LIMIT_S = 180.0   # a rank's collective, then it raises
DP_PARAM_SHARE = 1e-3           # parameters allowed past 1e-5 of the
                                # largest |parameter|, each within 2 x lr:
                                # AdamW's lr x m / (sqrt(v) + 1e-8) turns
                                # the rounding of a gradient within a few
                                # 1e-8 of zero into up to a sign flip


def dp_state_gap(got, want, lr):
    """(loss, grad norm) relative gaps and the parameters' gap of two
    (state, metrics) pairs: the largest |difference| over the largest
    |parameter|, and the share of parameters past ``TOL["float32"]`` of
    it (each within 2 x ``lr``)."""
    from repro_torch.tree import tree_leaves
    (gs, gm), (ws, wm) = got, want
    rel = {k: abs(float(gm[k]) - float(wm[k])) / abs(float(wm[k]))
           for k in ("loss", "grad_norm")}
    top = max(float(t.abs().max()) for t in tree_leaves(ws.params))
    worst, off, n = 0.0, 0, 0
    for a, b in zip(tree_leaves(gs.params), tree_leaves(ws.params)):
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        off += int((err > TOL["float32"] * top).sum())
        n += err.numel()
    return {**rel, "param_max_err": worst, "param_top": top,
            "param_share_past_tol": off / n,
            "ok": (max(rel.values()) <= TOL["float32"]
                   and off <= DP_PARAM_SHARE * n and worst <= 2 * lr)}


def dp_flat_leaves(tree):
    """{reference leaf name: its values flat in fp32} of a port tree
    (``leaf_groups``: a stacked leaf's layers together)."""
    import torch
    from repro_torch.tree import leaf_groups
    return {name: torch.cat([t.reshape(-1).float() for t in ts])
            for name, ts, _ in leaf_groups(tree)}


def dp_plain_compressed_mean(pods, residuals=None):
    """The reference's ``compressed_cross_pod_mean`` over pods, evaluated
    in process on the pods' gradients (``dp_flat_leaves`` of each): per
    reference leaf each pod's residual is added (``residuals``, one
    {leaf name: flat fp32} per pod, empty at the first step; None: no
    error feedback), the scale is the max over pods of max |x| / 127 +
    1e-12, the codes clip(round(x / scale), -127, 127), their sum taken
    in int32, the mean sum x scale / n, and each pod's new residual x -
    code x scale replaces its old one.  Returns {leaf name: (mean,
    scale)}, the mean flat in fp32."""
    import torch
    out = {}
    for name in pods[0]:
        xs = [g[name] for g in pods]
        if residuals is not None:
            xs = [x + r.get(name, 0.0) for x, r in zip(xs, residuals)]
        scale = torch.max(torch.stack([x.abs().max() for x in xs])) \
            / 127.0 + 1e-12
        codes = [torch.clamp(torch.round(x / scale), -127, 127).to(
            torch.int8) for x in xs]
        if residuals is not None:
            for r, x, c in zip(residuals, xs, codes):
                r[name] = x - c.float() * scale
        summed = torch.stack(codes).sum(dim=0, dtype=torch.int32)
        out[name] = (summed.float() * scale / len(xs), scale)
    return out


def dp_fp32_gate(grid):
    """(a) qwen1.5-0.5b at full width on its first 2 layers in fp32 (TF32
    off), the global batch B=8 x S=512: one ``auto`` step against the
    one-process step (rank 0), ``hierarchical`` against ``auto`` (every
    rank), and the ``compress_pod`` reduction of this rank's gradients
    against ``dp_plain_compressed_mean`` of the two pods' gradients
    (rank 0: each pod's 4 rows in process), element by element within
    one code step (scale / 2 pods) plus 1e-6 of the largest |mean|."""
    import torch
    from repro_torch.core import hierarchy
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import train as train_rt
    from repro_torch.sharding.profiles import make_rules
    from repro_torch.tree import leaf_groups, tree_map

    cfg = cut("qwen1.5-0.5b", TRAIN_CUT, compute_dtype="float32")
    model, opt, one_step, pipe = train_parts(cfg, grid.device)
    shape = ShapeConfig("smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    params = model.init(torch.Generator(device=grid.device).manual_seed(1))
    batch = pipe.next_batch()
    runs, out = {}, {}
    for name in ("auto", "hierarchical"):
        tcfg = train_rt.TrainStepConfig(dp_mode=DP_MODES[name][0])
        rules = make_rules(cfg, shape, grid, fsdp=False, dp_mode=tcfg.dp_mode)
        step = train_rt.make_train_step(model, opt, shape, mesh=grid,
                                        rules=rules, tcfg=tcfg)
        runs[name] = step(train_rt.state_from_params(
            tree_map(torch.clone, params), opt, tcfg, mesh=grid), batch)
    out["hierarchical_vs_auto"] = dp_state_gap(runs["hierarchical"],
                                               runs["auto"], opt.lr)
    if grid.rank == 0:
        one = one_step(train_rt.state_from_params(
            tree_map(torch.clone, params), opt), batch)
        out["auto_vs_one_process"] = dp_state_gap(runs["auto"], one, opt.lr)
        del one
    del runs

    # compress_pod: this rank's rows, reduced as the step reduces them
    rules = make_rules(cfg, shape, grid, fsdp=False, dp_mode="hierarchical")
    first, n = train_rt.batch_rows(grid, rules, shape)
    dev = {k: torch.as_tensor(v[first:first + n], device=grid.device)
           for k, v in batch.items()}
    _, grads = train_rt._accumulated_grads(model, params, dev,
                                           train_rt.TrainStepConfig())
    reduced, _ = hierarchy.reduce_gradients_hierarchically(
        grads, grid, compress=True)
    del grads
    if grid.rank == 0:
        pods = []
        for p in range(2):
            rows = {k: torch.as_tensor(v[4 * p:4 * p + 4], device=grid.device)
                    for k, v in batch.items()}
            pods.append(dp_flat_leaves(train_rt._accumulated_grads(
                model, params, rows, train_rt.TrainStepConfig())[1]))
        plain = dp_plain_compressed_mean(pods)
        worst, differ, total = 0.0, 0, 0
        for name, ts, _ in leaf_groups(reduced):
            got = torch.cat([t.reshape(-1).float() for t in ts])
            want, scale = plain[name]
            step = scale / 2
            err = (got - want).abs()
            tol = step + 1e-6 * want.abs().max()
            worst = max(worst, float((err / tol).max()))
            differ += int((torch.round(err / step) != 0).sum())
            total += got.numel()
        out["compress_vs_plain"] = {
            "max_err_over_tol": worst, "code_sums_differ": differ,
            "elements": total, "share_differ": differ / total,
            "ok": worst <= 1.0}
    return out


def dp_schedules(grid):
    """(b) qwen1.5-0.5b at full width on its first ``DP_DEPTH`` layers,
    bf16 compute: each rank B=2 of the global 8 x 512 (the weights of
    seed 0, phase 10 (c)'s batches), ``DP_STEPS`` steps of each mode:
    losses, seconds a step, host seconds in collectives (by op) and the
    byte counter a step, the peak of device memory, the kernels'
    launches and variants; rank 0 then the one-process step's losses on
    the same cut.  Then (c), ``dp_twice``."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import train as train_rt
    from repro_torch.sharding.profiles import make_rules

    cfg = cut("qwen1.5-0.5b", DP_DEPTH)
    model, opt, one_step, pipe = train_parts(cfg, grid.device)
    shape = ShapeConfig("smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    batches = [pipe.next_batch() for _ in range(DP_STEPS)]
    out = {}
    state = step = None
    t_start = time.perf_counter()
    for name, (mode, compress) in DP_MODES.items():
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        tcfg = train_rt.TrainStepConfig(dp_mode=mode, compress_pod=compress)
        rules = make_rules(cfg, shape, grid, fsdp=False, dp_mode=mode)
        step = train_rt.make_train_step(model, opt, shape, mesh=grid,
                                        rules=rules, tcfg=tcfg)
        # each mode draws the masters anew (a copy kept beside the state
        # would hold 1.86 GB more on each rank)
        state = train_rt.init_state(
            model, opt, torch.Generator(device=grid.device).manual_seed(0),
            tcfg, mesh=grid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, norms, secs, coll, by_op = [], [], [], [], []
        for b in batches:
            grid.stats.reset()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            coll.append(grid.stats.seconds)
            by_op.append(dict(grid.stats.seconds_by))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = {
            "losses": losses, "grad_norms": norms, "step_s": secs,
            "s_per_step": statistics.mean(secs[1:]),
            "collective_host_s": coll,
            "collective_host_s_per_step": statistics.mean(coll[1:]),
            "moved_bytes_per_step": dict(grid.stats.moved_bytes),
            "calls_per_step": dict(grid.stats.calls),
            "collective_host_s_by_op": {
                k: statistics.mean(d[k] for d in by_op[1:])
                for k in by_op[0]},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": train_counts(),
            "variants": {**kernels.variant_counts(),
                         **kernels.backward_variant_counts()}}
        dp_progress(grid.rank, f"(b) {name}", t_start, {
            k: out[name][k] for k in ("losses", "step_s", "peak_mem_gb",
                                      "collective_host_s_by_op")})
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    if grid.rank == 0:
        state = train_rt.init_state(
            model, opt, torch.Generator(device=grid.device).manual_seed(0))
        losses = []
        for b in batches:
            state, m = one_step(state, b)
            losses.append(float(m["loss"]))
        out["one_process_losses"] = losses
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return out, dp_twice(grid)


def dp_twice(grid):
    """(c) one ``compress_pod`` step of qwen1.5-0.5b at full width on its
    first 2 layers in bf16 (the kernels' tensor-core variants) run twice
    from one state, after a step that fills the residuals: the two new
    states, residuals and metrics equal in bits."""
    import torch
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import train as train_rt
    from repro_torch.sharding.profiles import make_rules
    from repro_torch.tree import tree_leaves

    cfg = cut("qwen1.5-0.5b", TRAIN_CUT)
    model, opt, _, pipe = train_parts(cfg, grid.device)
    shape = ShapeConfig("smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    tcfg = train_rt.TrainStepConfig(dp_mode="hierarchical",
                                    compress_pod=True)
    step = train_rt.make_train_step(
        model, opt, shape, mesh=grid, tcfg=tcfg,
        rules=make_rules(cfg, shape, grid, fsdp=False,
                         dp_mode="hierarchical"))
    t0 = time.perf_counter()
    state = train_rt.init_state(
        model, opt, torch.Generator(device=grid.device).manual_seed(2),
        tcfg, mesh=grid)
    state, _ = step(state, pipe.next_batch())
    batch = pipe.next_batch()
    first = tree_leaves(step(state, batch))
    second = tree_leaves(step(state, batch))
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    return {"same_bits": same, "layers": TRAIN_CUT,
            "compute_dtype": cfg.compute_dtype,
            "seconds": time.perf_counter() - t0}


def gloo_cuda_probe(grid):
    """Which collectives this torch's gloo takes on CUDA tensors (the
    port stages every one on a pinned host copy: ``core.hierarchy``),
    each on the world group: "takes" or the error it raises."""
    import torch
    import torch.distributed as dist
    n, dev = grid.world, grid.device
    x = torch.full((8,), float(grid.rank + 1), device=dev)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * n, device=dev), x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(8 // n, device=dev), list(x.clone().chunk(n))),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // n, device=dev), x.clone()),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
    }
    found = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            found[name] = "takes"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            found[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return found


def dp_progress(rank: int, part: str, t0: float, what,
                phase: int = 11) -> None:
    """Rank 0's progress on stderr (a failed world shows how far it
    got)."""
    if rank == 0:
        print(f"phase {phase} rank 0: {part} done at "
              f"{time.perf_counter() - t0:.1f} s: {json.dumps(what)[:600]}",
              file=sys.stderr, flush=True)


def dp_rank(rank: int, init: str, out_dir: str) -> None:
    """One rank of phase 11 (a spawned process; any failure exits it
    non-zero): the probe, (a), (b) and (c), its report to
    ``<out_dir>/rank<r>.json``."""
    import torch
    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    grid = mesh_lib.init_grid(mesh_lib.Layout(*DP_LAYOUT), rank=rank,
                              device=torch.device("cuda", 0),
                              init_method=init,
                              timeout_s=DP_COLLECTIVE_LIMIT_S)
    report = {"rank": rank, "grid": grid.describe(),
              "gloo_cuda": gloo_cuda_probe(grid)}
    dp_progress(rank, "probe", t0, report["gloo_cuda"])
    t1 = time.perf_counter()
    report["fp32_gate"] = dp_fp32_gate(grid)
    dp_progress(rank, "(a)", t0, report["fp32_gate"])
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    report["schedules"], report["twice"] = dp_schedules(grid)
    dp_progress(rank, "(b), (c)", t0, report["twice"])
    report["seconds"] = {"setup": t1 - t0, "fp32_gate": t2 - t1,
                         "schedules": time.perf_counter() - t2}
    grid.close()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))


def wait_world(procs, limit_s: float, what: str) -> float:
    """Wait for every process; a non-zero exit or the limit kills the
    rest and fails the run.  Returns the seconds taken."""
    t0 = time.perf_counter()
    while any(p.is_alive() for p in procs):
        failed = [p.exitcode for p in procs
                  if p.exitcode is not None and p.exitcode != 0]
        over = time.perf_counter() - t0 > limit_s
        if failed or over:
            for p in procs:
                p.kill()
            for p in procs:
                p.join(timeout=30)
            check(False, f"{what}: " + (f"a rank exited {failed}" if failed
                                        else f"overran {limit_s} s"))
        time.sleep(0.2)
    codes = [p.exitcode for p in procs]
    check(all(c == 0 for c in codes), f"{what}: rank exit codes {codes}")
    return time.perf_counter() - t0


def kill_tree(pid: int) -> None:
    """SIGKILL ``pid`` and every process under it (``torch.distributed.run``
    starts its workers in sessions of their own), read from /proc."""
    import os
    import signal
    children = {}
    for entry in Path("/proc").iterdir():
        if entry.name.isdigit():
            try:
                ppid = int((entry / "stat").read_text().rsplit(")", 1)[1]
                           .split()[1])
            except (OSError, IndexError, ValueError):
                continue
            children.setdefault(ppid, []).append(int(entry.name))
    todo, tree = [pid], []
    while todo:
        p = todo.pop()
        tree.append(p)
        todo.extend(children.get(p, []))
    for p in tree:
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass


@contextlib.contextmanager
def dp_allocator_env():
    """The environment the ranks start with: four processes share the
    card, so each rank's allocator grows its segments in place
    (``expandable_segments``) rather than holding freed blocks of other
    sizes (1.83 GB of one rank's 16.3 GB in a first run)."""
    import os
    key = "PYTORCH_CUDA_ALLOC_CONF"
    old = os.environ.get(key)
    os.environ[key] = "expandable_segments:True"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(key)
        else:
            os.environ[key] = old


def dp_cli(smi):
    """(d) the training CLI under ``torch.distributed.run`` on 4 ranks:
    qwen1.5-0.5b at full width on its first ``TRAIN_CUT`` layers
    (``--layers``), the lease's (2, 2, 1) layout,
    ``hierarchical`` with ``compress_pod``, 3 steps of 8 x 512; its
    output in files, and past ``DP_CLI_LIMIT_S`` its whole process tree
    killed."""
    import os
    root = Path(__file__).resolve().parent
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
            "--arch", "qwen1.5-0.5b", "--layers", str(TRAIN_CUT),
            "--dp-mode", "hierarchical",
            "--compress-pod", "--pool", "scalepool", "--pool-accels", "12",
            "--steps", "3", "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--ckpt-dir", str(DP_DIR / "ckpt")]
    t0 = time.perf_counter()
    out_path, err_path = DP_DIR / "cli.out", DP_DIR / "cli.err"
    with open(out_path, "w") as fo, open(err_path, "w") as fe, \
            dp_allocator_env():
        proc = subprocess.Popen(argv, cwd=root, env={
            **os.environ, "PYTHONPATH": str(root / "src")},
            stdout=fo, stderr=fe, text=True)
    try:
        proc.wait(timeout=DP_CLI_LIMIT_S)
    except subprocess.TimeoutExpired:
        kill_tree(proc.pid)
        proc.wait(timeout=60)
        check(False, f"phase 11 (d): the CLI overran {DP_CLI_LIMIT_S} s: "
              f"{err_path.read_text()[-2000:]}")
    secs = time.perf_counter() - t0
    out, err = out_path.read_text(), err_path.read_text()
    summary = json.loads(out) if proc.returncode == 0 else None
    emit({"phase": "dp", "check": "(d) CLI", "nvidia_smi": smi,
          "argv": argv[3:], "rc": proc.returncode, "seconds": secs,
          "cli": summary,
          "stderr_tail": err.strip().splitlines()[-6:]})
    check(proc.returncode == 0, f"phase 11 (d): rc {proc.returncode}: "
          f"{err[-2000:]}")
    check(summary["mesh"] == {"pod": 2, "data": 2, "model": 1}
          and summary["dp_mode"] == "hierarchical"
          and summary["backend"] == "gloo" and summary["compress_pod"]
          and summary["world"] == 4
          and summary["device"].startswith("cuda"),
          f"phase 11 (d): summary {summary}")


def dp_phase(smi):
    """Phase 11: (a)-(c) in one spawned world of 4 ranks sharing the card
    (the kernels built by this process before), then (d) the CLI.
    Returns each rank's (b) launches, all three modes together."""
    import multiprocessing
    import shutil

    import torch

    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(
        r, f"file://{DP_DIR / 'store'}", str(DP_DIR))) for r in range(4)]
    with dp_allocator_env():
        for p in procs:
            p.start()
    world_s = wait_world(procs, DP_WORLD_LIMIT_S, "phase 11 (a)-(c)")
    reports = [json.loads((DP_DIR / f"rank{r}.json").read_text())
               for r in range(4)]
    cfg = cut("qwen1.5-0.5b", DP_DEPTH)
    want = train_launches(cfg, DP_STEPS)
    emit({"phase": "dp", "check": "gloo on CUDA tensors",
          "torch": torch.__version__, "ops": reports[0]["gloo_cuda"],
          "backend": reports[0]["grid"]["backend"],
          "backend_why": reports[0]["grid"]["backend_why"]})
    gate = {r["rank"]: r["fp32_gate"] for r in reports}
    emit({"phase": "dp", "check": "(a) fp32 gate", "arch": cfg.name,
          "layers": TRAIN_CUT, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "tol": TOL["float32"], "param_share_allowed": DP_PARAM_SHARE,
          "per_rank": gate})
    check(all(g["hierarchical_vs_auto"]["ok"] for g in gate.values())
          and gate[0]["auto_vs_one_process"]["ok"]
          and gate[0]["compress_vs_plain"]["ok"],
          f"phase 11 (a): {gate}")
    counts = {}
    for mode in DP_MODES:
        per = [r["schedules"][mode] for r in reports]
        emit({"phase": "dp", "check": f"(b) {mode}", "nvidia_smi": smi,
              "arch": cfg.name, "layers": cfg.n_layers,
              "ranks": "4 ranks sharing one card (gloo, host-staged)",
              "rank_batch": TRAIN_BATCH // 4, "seq": TRAIN_SEQ,
              "steps": DP_STEPS, "per_rank": per})
        losses = per[0]["losses"]
        check(all(p["losses"] == losses for p in per)
              and all(math.isfinite(x) for x in losses),
              f"phase 11 (b) {mode}: ranks' losses {[p['losses'] for p in per]}")
        for r, p in enumerate(per):
            check(p["launches"] == want,
                  f"phase 11 (b) {mode} rank {r}: launches "
                  f"{p['launches']} != {want}")
            check_flash_variant(f"phase 11 {mode} rank {r}",
                                cfg.compute_dtype, p["variants"],
                                want["flash_attention"])
            check_backward_variant(f"phase 11 {mode} rank {r}",
                                   cfg.compute_dtype, p["variants"],
                                   want["flash_attention_bwd"])
            counts.setdefault(f"qwen1.5-0.5b dp rank {r}", {})
            for k, v in p["launches"].items():
                c = counts[f"qwen1.5-0.5b dp rank {r}"]
                c[k] = c.get(k, 0) + v
    auto = reports[0]["schedules"]["auto"]["losses"]
    ref = reports[0]["schedules"]["one_process_losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(auto, ref)]
    emit({"phase": "dp", "check": "(b) auto against the one-process step",
          "layers": cfg.n_layers, "dp_losses": auto, "one_card_losses": ref,
          "rel_gaps": gaps, "tol": BF16_TRAJ_TOL})
    check(all(g <= BF16_TRAJ_TOL for g in gaps),
          f"phase 11 (b): auto's losses {auto} against one card's {ref}")
    twice = [r["twice"] for r in reports]
    emit({"phase": "dp", "check": "(c) compress_pod step twice",
          "per_rank": twice})
    check(all(t["same_bits"] for t in twice),
          f"phase 11 (c): a rank's step twice gave other bits: {twice}")
    dp_cli(smi)
    emit({"phase": "dp", "seconds": time.perf_counter() - t_start,
          "world_seconds": world_s,
          "rank_seconds": [r["seconds"] for r in reports]})
    return counts


# ---------------------------------------------------------------------------
# phase 12: tensor parallelism and FSDP: qwen1.5-0.5b on (data 2, model 2)
# with FSDP off and on and on (pod 2, data 1, model 2) with the compressed
# cross-pod phase, 4 ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# world -> (layout, [(case, dp_mode, compress_pod, fsdp)])
TP_WORLDS = {
    "2x2": (((2, 2), ("data", "model")),
            [("tp", "auto", False, False), ("tp_fsdp", "auto", False, True)]),
    "2x1x2": (((2, 1, 2), ("pod", "data", "model")),
              [("pod_compress", "hierarchical", True, False)]),
}
TP_GATE_STEPS = 3               # (a)'s steps
TP_STEPS = 4                    # (b)'s steps a case; s/step over 2-4
TP_DIR = Path(__file__).resolve().parent / "build" / "phase12"
TP_WORLD_LIMIT_S = 300.0        # each world's wall-clock limit
TP_CLI_LIMIT_S = 240.0          # each of (d)'s torch.distributed.run
TP_FAIL_AT = 2                  # (d)'s injected failure: rank 1, step 2
TP_CLI_WRAPPER = """
import os, sys
from repro_torch.launch.train import main

def hook(step):
    if (os.environ["TORCHELASTIC_RESTART_COUNT"] == "0"
            and os.environ["RANK"] == "1" and step == {fail_at}):
        raise RuntimeError("injected failure on rank 1 at step {fail_at}")

raise SystemExit(main(sys.argv[1:], failure_hook=hook))
"""


def tp_plain_compressed_steps(model, opt, params, batches):
    """The one-process evaluation of ``compress_pod`` on (pod 2, data 1,
    model 2): per step each pod's gradient on its half of the rows, the
    reference's compressed mean over the two pods per reference leaf
    (``dp_plain_compressed_mean`` with each pod's residual), then
    AdamW.  Returns [(loss, grad norm)] and the final masters."""
    import torch
    from repro_torch.runtime import train as train_rt
    from repro_torch.tree import leaf_groups, rebuild, tree_map

    dev = model.device
    state = train_rt.state_from_params(tree_map(torch.clone, params), opt)
    residual = [{}, {}]
    metrics = []
    half = TRAIN_BATCH // 2
    for b in batches:
        losses, flats = [], []
        for p in range(2):
            rows = {k: torch.as_tensor(v[half * p:half * p + half],
                                       device=dev) for k, v in b.items()}
            loss, g = train_rt._accumulated_grads(
                model, state.params, rows, train_rt.TrainStepConfig())
            losses.append(loss)
            flats.append(dp_flat_leaves(g))
            del g
        mean = dp_plain_compressed_mean(flats, residual)
        del flats
        supply = {}
        for name, ts, _ in leaf_groups(state.params):
            parts, at = [], 0
            for t in ts:
                parts.append(mean[name][0][at:at + t.numel()].reshape(
                    t.shape))
                at += t.numel()
            supply[name] = iter(parts)
        del mean
        grads = rebuild(state.params, supply)
        new_params, new_opt, gnorm = opt.update(grads, state.opt,
                                                state.params)
        state = train_rt.TrainState(new_params, new_opt, {})
        metrics.append((float((losses[0] + losses[1]) / 2), float(gnorm)))
    return metrics, state.params


def tp_gap(got_metrics, got_params, want_metrics, want_params, lr, steps):
    """Loss and grad norm relative gaps per step, and the parameters':
    the largest |difference| over the largest |parameter| and the share
    past ``TOL["float32"]`` of it (each within 2 x lr a step)."""
    from repro_torch.tree import tree_leaves
    rel = [max(abs(g[k] - w[k]) / abs(w[k]) for k in range(2))
           for g, w in zip(got_metrics, want_metrics)]
    top = max(float(t.abs().max()) for t in tree_leaves(want_params))
    worst, off, n = 0.0, 0, 0
    for a, b in zip(tree_leaves(got_params), tree_leaves(want_params)):
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        off += int((err > TOL["float32"] * top).sum())
        n += err.numel()
    return {"metric_rel_gaps": rel, "param_max_err": worst,
            "param_top": top, "param_share_past_tol": off / n,
            "ok": (max(rel) <= TOL["float32"] and off <= DP_PARAM_SHARE * n
                   and worst <= 2 * lr * steps)}


def tp_fp32_gate(grid, cases):
    """(a) qwen1.5-0.5b at full width on its first 2 layers in fp32 (TF32
    off), global B=8 x S=512, ``TP_GATE_STEPS`` steps of each case from
    the same draw, the parameters gathered from the ranks; rank 0 holds
    them, the losses and grad norms against the one-process step (for
    ``compress_pod``, ``tp_plain_compressed_steps``)."""
    import torch
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import train as train_rt
    from repro_torch.sharding import partition
    from repro_torch.sharding.profiles import make_rules
    from repro_torch.tree import tree_map

    cfg = cut("qwen1.5-0.5b", TRAIN_CUT, compute_dtype="float32")
    model, opt, one_step, pipe = train_parts(cfg, grid.device)
    shape = ShapeConfig("smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    params = model.init(torch.Generator(device=grid.device).manual_seed(1))
    batches = [pipe.next_batch() for _ in range(TP_GATE_STEPS)]
    out, plain = {}, None
    for name, mode, compress, fsdp in cases:
        tcfg = train_rt.TrainStepConfig(dp_mode=mode, compress_pod=compress)
        rules = make_rules(cfg, shape, grid, fsdp=fsdp, dp_mode=mode)
        step = train_rt.make_train_step(model, opt, shape, mesh=grid,
                                        rules=rules, tcfg=tcfg)
        state = train_rt.state_from_params(
            tree_map(torch.clone, params), opt, tcfg, mesh=grid,
            rules=rules, axes=model.param_axes())
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        blocks = partition.tree_shardings(grid, rules, model.param_axes())
        full = tree_map(lambda t, b: partition.gather_leaf(t, b, grid),
                        state.params, blocks)
        del state, step
        if grid.rank == 0:
            if compress:
                want = tp_plain_compressed_steps(model, opt, params, batches)
            elif plain is None:
                one = train_rt.state_from_params(
                    tree_map(torch.clone, params), opt)
                wm = []
                for b in batches:
                    one, m = one_step(one, b)
                    wm.append((float(m["loss"]), float(m["grad_norm"])))
                want = plain = (wm, one.params)
                del one
            else:
                want = plain
            out[name] = {"metrics": metrics, "one_process": want[0],
                         **tp_gap(metrics, full, want[0], want[1], opt.lr,
                                  TP_GATE_STEPS)}
            del want
        else:
            out[name] = {"metrics": metrics}
        del full
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_full_depth(grid, cases):
    """(b) qwen1.5-0.5b at full width and depth, bf16 compute, the global
    8 x 512 (phase 10 (c)'s weights, seed 0, and batches), ``TP_STEPS``
    steps of each case: losses, seconds a step, host seconds in
    collectives and the byte counter by (axes, op) a step, the peak of
    device memory, the kernels' launches and variants."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import train as train_rt
    from repro_torch.sharding.profiles import describe, make_rules

    cfg = get_config("qwen1.5-0.5b")
    model, opt, _, pipe = train_parts(cfg, grid.device)
    shape = ShapeConfig("smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    batches = [pipe.next_batch() for _ in range(TP_STEPS)]
    out = {}
    state = step = None
    t_start = time.perf_counter()
    for name, mode, compress, fsdp in cases:
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        tcfg = train_rt.TrainStepConfig(dp_mode=mode, compress_pod=compress)
        rules = make_rules(cfg, shape, grid, fsdp=fsdp, dp_mode=mode)
        step = train_rt.make_train_step(model, opt, shape, mesh=grid,
                                        rules=rules, tcfg=tcfg)
        state = train_rt.init_state(
            model, opt, torch.Generator(device=grid.device).manual_seed(0),
            tcfg, mesh=grid, rules=rules)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, norms, secs, coll, by_op = [], [], [], [], []
        for b in batches:
            grid.stats.reset()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            coll.append(grid.stats.seconds)
            by_op.append(dict(grid.stats.seconds_by))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[name] = {
            "rules": describe(rules),
            "losses": losses, "grad_norms": norms, "step_s": secs,
            "s_per_step": statistics.mean(secs[1:]),
            "collective_host_s": coll,
            "collective_host_s_per_step": statistics.mean(coll[1:]),
            "moved_bytes_per_step": dict(grid.stats.moved_bytes),
            "calls_per_step": dict(grid.stats.calls),
            "collective_host_s_by_op": {
                k: statistics.mean(d[k] for d in by_op[1:])
                for k in by_op[0]},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": train_counts(),
            "variants": {**kernels.variant_counts(),
                         **kernels.backward_variant_counts()}}
        dp_progress(grid.rank, f"(b) {name}", t_start, {
            k: out[name][k] for k in ("losses", "step_s", "peak_mem_gb",
                                      "collective_host_s_by_op")}, phase=12)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    if grid.rank == 0 and any(compress for _, _, compress, _ in cases):
        params = model.init(torch.Generator(device=grid.device).manual_seed(0))
        metrics, _ = tp_plain_compressed_steps(model, opt, params, batches)
        out["plain_compressed_losses"] = [m[0] for m in metrics]
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_twice(grid):
    """(c) one step with FSDP on (data 2, model 2), qwen1.5-0.5b at full
    width on its first 2 layers in bf16, run twice from one state after
    a first step: the two new states and metrics equal in bits."""
    import torch
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import train as train_rt
    from repro_torch.sharding.profiles import make_rules
    from repro_torch.tree import tree_leaves

    cfg = cut("qwen1.5-0.5b", TRAIN_CUT)
    model, opt, _, pipe = train_parts(cfg, grid.device)
    shape = ShapeConfig("smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    rules = make_rules(cfg, shape, grid, fsdp=True)
    step = train_rt.make_train_step(model, opt, shape, mesh=grid,
                                    rules=rules)
    t0 = time.perf_counter()
    state = train_rt.init_state(
        model, opt, torch.Generator(device=grid.device).manual_seed(2),
        mesh=grid, rules=rules)
    state, _ = step(state, pipe.next_batch())
    batch = pipe.next_batch()
    first = tree_leaves(step(state, batch))
    second = tree_leaves(step(state, batch))
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    return {"same_bits": same, "layers": TRAIN_CUT, "fsdp": True,
            "compute_dtype": cfg.compute_dtype,
            "seconds": time.perf_counter() - t0}


def tp_rank(rank: int, init: str, out_dir: str, world: str) -> None:
    """One rank of one of phase 12's worlds (a spawned process; any
    failure exits it non-zero): (a), (b) and, on (data 2, model 2), (c);
    its report to ``<out_dir>/<world>.rank<r>.json``."""
    import torch
    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layout, cases = TP_WORLDS[world]
    t0 = time.perf_counter()
    grid = mesh_lib.init_grid(mesh_lib.Layout(*layout), rank=rank,
                              device=torch.device("cuda", 0),
                              init_method=init,
                              timeout_s=DP_COLLECTIVE_LIMIT_S)
    report = {"rank": rank, "grid": grid.describe()}
    t1 = time.perf_counter()
    report["fp32_gate"] = tp_fp32_gate(grid, cases)
    dp_progress(rank, f"{world} (a)", t0, report["fp32_gate"], phase=12)
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    report["full_depth"] = tp_full_depth(grid, cases)
    t3 = time.perf_counter()
    if any(fsdp for *_, fsdp in cases):
        report["twice"] = tp_twice(grid)
        dp_progress(rank, f"{world} (c)", t0, report["twice"], phase=12)
    report["seconds"] = {"setup": t1 - t0, "fp32_gate": t2 - t1,
                         "full_depth": t3 - t2,
                         "twice": time.perf_counter() - t3}
    grid.close()
    Path(out_dir, f"{world}.rank{rank}.json").write_text(json.dumps(report))


def tp_torchrun(argv, name):
    """The training CLI's argv under ``torch.distributed.run`` on 4 ranks,
    its output in files, its whole process tree killed past
    ``TP_CLI_LIMIT_S``: (rc, summary or None, stderr, seconds)."""
    import os
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4"] + argv
    t0 = time.perf_counter()
    out_path, err_path = TP_DIR / f"{name}.out", TP_DIR / f"{name}.err"
    with open(out_path, "w") as fo, open(err_path, "w") as fe, \
            dp_allocator_env():
        proc = subprocess.Popen(cmd, cwd=root, env={
            **os.environ, "PYTHONPATH": str(root / "src")},
            stdout=fo, stderr=fe, text=True)
    try:
        proc.wait(timeout=TP_CLI_LIMIT_S)
    except subprocess.TimeoutExpired:
        kill_tree(proc.pid)
        proc.wait(timeout=60)
        check(False, f"phase 12 (d) {name}: the CLI overran "
              f"{TP_CLI_LIMIT_S} s: {err_path.read_text()[-2000:]}")
    secs = time.perf_counter() - t0
    out, err = out_path.read_text(), err_path.read_text()
    summary = json.loads(out) if proc.returncode == 0 else None
    return proc.returncode, summary, err, secs


def tp_step_losses(err):
    """[(step, loss)] of rank 0's per-step lines on the CLI's stderr."""
    out = []
    for line in err.splitlines():
        if line.startswith('{"step"'):
            d = json.loads(line)
            out.append((d["step"], d["loss"]))
    return out


def tp_cli(smi):
    """(d) the training CLI under ``torch.distributed.run`` on 4 ranks
    with no ``--pool``: qwen1.5-0.5b at full width on its first
    ``TRAIN_CUT`` layers (``--layers``; (b) runs the full depth) on the
    reference's smoke mesh (data 2, model 2), tensor parallel, 3 steps of
    8 x 512; then the same under ``--max-restarts 1`` through a wrapper
    (under the ignored ``build/``) whose failure hook raises on rank 1 at
    step ``TP_FAIL_AT`` of the first attempt, with ``--ckpt-every 1``:
    exit 0, the resume reported, every step's loss (the first attempt's
    and the replayed ones) equal in bits to the first run's."""
    base = ["--arch", "qwen1.5-0.5b", "--layers", str(TRAIN_CUT),
            "--steps", "3", "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1"]
    rc, plain, err, secs = tp_torchrun(
        ["-m", "repro_torch.launch.train"] + base
        + ["--ckpt-dir", str(TP_DIR / "ckpt_plain")], "cli")
    emit({"phase": "tp", "check": "(d) CLI", "nvidia_smi": smi, "rc": rc,
          "layers": TRAIN_CUT, "seconds": secs, "cli": plain,
          "stderr_tail": err.strip().splitlines()[-6:]})
    check(rc == 0, f"phase 12 (d): rc {rc}: {err[-2000:]}")
    check(plain["mesh"] == {"data": 2, "model": 2}
          and plain["dp_mode"] == "auto" and plain["backend"] == "gloo"
          and plain["world"] == 4 and "heads=model" in plain["rules"]
          and plain["device"].startswith("cuda")
          and plain["resumed_from"] is None,
          f"phase 12 (d): summary {plain}")
    want = dict(tp_step_losses(err))
    wrapper = TP_DIR / "restart_wrapper.py"
    wrapper.write_text(TP_CLI_WRAPPER.format(fail_at=TP_FAIL_AT))
    rc, summary, err, secs = tp_torchrun(
        ["--max-restarts", "1", str(wrapper)] + base
        + ["--ckpt-every", "1", "--ckpt-dir", str(TP_DIR / "ckpt_restart")],
        "cli_restart")
    got = tp_step_losses(err)
    same = [(s, x, want.get(s)) for s, x in got]
    emit({"phase": "tp", "check": "(d) CLI world restart", "nvidia_smi": smi,
          "rc": rc, "layers": TRAIN_CUT, "seconds": secs, "cli": summary,
          "steps_and_losses_against_the_first_run": same,
          "stderr_tail": err.strip().splitlines()[-6:]})
    check(rc == 0, f"phase 12 (d) restart: rc {rc}: {err[-2000:]}")
    check(f"injected failure on rank 1 at step {TP_FAIL_AT}" in err
          and summary["restarts"] == 1
          and summary["resumed_from"] in (TP_FAIL_AT - 1, TP_FAIL_AT)
          and [s for s, _ in got[:TP_FAIL_AT]] == list(
              range(1, TP_FAIL_AT + 1))
          and [s for s, _ in got[TP_FAIL_AT:]] == list(
              range(summary["resumed_from"] + 1, 4))
          and all(x == w for _, x, w in same),
          f"phase 12 (d) restart: {summary}, losses {same}")


def tp_phase(smi, qwen_losses):
    """Phase 12: each of ``TP_WORLDS`` spawned as 4 ranks sharing the
    card (the kernels built by this process before), then (d) the CLI.
    (b)'s trajectories are held to the one-card trajectory of phase 10
    (c) (``qwen_losses``), the compressed one to the plain in-process
    evaluation of the same schedule (``tp_plain_compressed_steps``, rank
    0): int8 codes change the gradient, so a compressed trajectory
    leaves the uncompressed one by more than the bf16 bound (phase 11's
    own by 4.6% at step 4 of its full-depth run on an H100).  Returns
    each rank's (b) launches, its cases together."""
    import multiprocessing
    import shutil

    import torch
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    cfg = get_config("qwen1.5-0.5b")
    want = train_launches(cfg, TP_STEPS)
    counts, world_s = {}, {}
    ctx = multiprocessing.get_context("spawn")
    for world, (layout, cases) in TP_WORLDS.items():
        gc.collect()
        torch.cuda.empty_cache()
        store = TP_DIR / f"store_{world}"
        procs = [ctx.Process(target=tp_rank, args=(
            r, f"file://{store}", str(TP_DIR), world)) for r in range(4)]
        with dp_allocator_env():
            for p in procs:
                p.start()
        world_s[world] = wait_world(procs, TP_WORLD_LIMIT_S,
                                    f"phase 12 {world}")
        reports = [json.loads((TP_DIR / f"{world}.rank{r}.json").read_text())
                   for r in range(4)]
        gate = reports[0]["fp32_gate"]
        emit({"phase": "tp", "check": "(a) fp32 gate", "world": world,
              "layout": reports[0]["grid"]["mesh"], "layers": TRAIN_CUT,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "steps": TP_GATE_STEPS, "tol": TOL["float32"],
              "param_share_allowed": DP_PARAM_SHARE, "rank0": gate})
        check(all(g["ok"] for g in gate.values())
              and all(r["fp32_gate"][c]["metrics"] == gate[c]["metrics"]
                      for r in reports for c in gate),
              f"phase 12 (a) {world}: {gate}")
        for name, _, compress, _ in cases:
            per = [r["full_depth"][name] for r in reports]
            losses = per[0]["losses"]
            ref = (reports[0]["full_depth"]["plain_compressed_losses"]
                   if compress else qwen_losses)
            gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
            emit({"phase": "tp", "check": f"(b) {name}", "nvidia_smi": smi,
                  "arch": cfg.name, "layers": cfg.n_layers,
                  "layout": reports[0]["grid"]["mesh"],
                  "ranks": "4 ranks sharing one card (gloo, host-staged)",
                  "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
                  "steps": TP_STEPS,
                  "held_to": ("the plain compressed evaluation"
                              if compress else "phase 10 (c)"),
                  "reference_losses": ref[:TP_STEPS], "rel_gaps": gaps,
                  "rel_gaps_to_phase_10c": [
                      abs(a - b) / abs(b)
                      for a, b in zip(losses, qwen_losses)],
                  "tol": BF16_TRAJ_TOL, "per_rank": per})
            check(all(p["losses"] == losses for p in per)
                  and all(math.isfinite(x) for x in losses)
                  and all(g <= BF16_TRAJ_TOL for g in gaps),
                  f"phase 12 (b) {name}: losses "
                  f"{[p['losses'] for p in per]} against {ref}")
            for r, p in enumerate(per):
                check(p["launches"] == want,
                      f"phase 12 (b) {name} rank {r}: launches "
                      f"{p['launches']} != {want}")
                check_flash_variant(f"phase 12 {name} rank {r}",
                                    cfg.compute_dtype, p["variants"],
                                    want["flash_attention"])
                check_backward_variant(f"phase 12 {name} rank {r}",
                                       cfg.compute_dtype, p["variants"],
                                       want["flash_attention_bwd"])
                c = counts.setdefault(f"qwen1.5-0.5b tp rank {r}", {})
                for k, v in p["launches"].items():
                    c[k] = c.get(k, 0) + v
        if any(fsdp for *_, fsdp in cases):
            twice = [r["twice"] for r in reports]
            emit({"phase": "tp", "check": "(c) FSDP step twice",
                  "world": world, "per_rank": twice})
            check(all(t["same_bits"] for t in twice),
                  f"phase 12 (c): a rank's step twice gave other bits: "
                  f"{twice}")
        emit({"phase": "tp", "world": world, "seconds": world_s[world],
              "rank_seconds": [r["seconds"] for r in reports]})
    tp_cli(smi)
    emit({"phase": "tp", "seconds": time.perf_counter() - t_start,
          "world_seconds": world_s})
    return counts


def ssd_work(B, S, H, P, G, N, chunk, itemsize):
    """(bytes, flops) of one SSD scan: x, dt, B, C, A, D and the initial
    state read once, y and the final state written once; the causal half
    of each chunk's score and intra-chunk products, the carried-state
    output and the state update."""
    Q = min(chunk, S)
    tri = sum(q * (q + 1) // 2 for q in (min(Q, S - t)
                                         for t in range(0, S, Q)))
    flops = 2 * B * H * (tri * (N + P) + 2 * S * N * P)
    nbytes = (2 * B * S * H * P * itemsize + B * S * H * 4
              + 2 * B * S * G * N * itemsize + 2 * H * 4
              + 2 * B * H * P * N * 4)
    return nbytes, flops


def ssd_bwd_work(B, S, H, P, G, N, itemsize):
    """(bytes, flops) of one SSD backward (no initial state): x, dy, B, C,
    dt, A and D read once, dx, dB, dC, ddt, dA and dD written once; the
    least products of the gradient, those of the recurrence walked one
    position at a time: per position and (P, N) element of a head, the
    state rebuilt (a product and a multiply-add) and its gradient walked
    back (the same), and one multiply-add each for dx, dB, dC and the
    decay's gradient: 14 flops.  The kernel's chunked algorithm does
    more (its masked intra-chunk products)."""
    flops = 14 * B * H * S * P * N
    nbytes = (3 * B * S * H * P * itemsize + 4 * B * S * G * N * itemsize
              + 2 * B * S * H * 4 + 4 * H * 4)
    return nbytes, flops


def kernel_times(device, counts, errs):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device=device).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def row(mod, name, ms, plain_ms, bound_ms, bound_by, library_ms,
            **extra):
        bwd = name.endswith("_bwd")
        rows.append({"name": name, "route": "cuda",
                     "source": mod.SOURCE_BWD if bwd else mod.SOURCE,
                     "replaces": mod.REPLACES_BWD if bwd else mod.REPLACES,
                     "launches": counts[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     **extra})

    cases = []

    def times(kernel, case, ms, plain, b_ms, b_by, lib, **extra):
        """One phase-5 line; every case is held to its bound below."""
        emit({"phase": "times", "kernel": kernel, "case": case, "ms": ms,
              "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": lib, **extra})
        cases.append((f"{kernel} {case}", ms, b_ms))

    # paged: a full decode batch of the engine (8 rows, 120..563 live
    # tokens, the trace's prompt lengths plus generated tokens), a one-row
    # bucket, the pooled path's 4 rows over 8-page tables of 16-token
    # pages, the decode tier's 4 rows over 15-page tables and the
    # colocation engines' 6 rows over 10-page tables; copies of
    # the pool cycled so the timed calls read cold K/V, as a decode step
    # does layer by layer
    def paged_work(q, kp, lens, ps):
        live = sum(lens)
        nbytes = (2 * live * kp.shape[2] * kp.shape[3] * kp.element_size()
                  + 2 * q.numel() * q.element_size()              # q, out
                  + 4 * sum(-(-n // ps) for n in lens)            # table
                  + 4 * len(lens))                                # lens
        return nbytes, 4 * live * q.shape[1] * q.shape[2]

    def paged_time(case, B, ps, pmax, lens, first=False, H=16, KV=16,
                   D=64, kv=f32, window=None):
        one = paged_inputs(gen, B, H, KV, D, ps, pmax, lens, bf16, kv,
                           device)
        nbytes, flops = paged_work(one[0], one[1], lens, ps)
        reads = nbytes - one[0].numel() * one[0].element_size()   # - out
        sets = [one] + [paged_inputs(gen, B, H, KV, D, ps, pmax, lens,
                                     bf16, kv, device)
                        for _ in range(max(4, cold_copies(reads)) - 1)]
        ms = time_ms(lambda i: pa.paged_decode_attention(
            *sets[i], sliding_window=window), len(sets))
        plain = time_ms(lambda i: ref.paged_attention_ref(
            *sets[i], sliding_window=window), len(sets))
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        if first:
            row(pa, "paged_attention", ms, plain, b_ms, b_by, None)
        times("paged_attention", case, ms, plain, b_ms, b_by, None,
              input_copies=len(sets))
        del sets

    paged_time("engine decode B=8 len 130..563 H=KV=16 D=64 ps=64 q=bf16 "
               "pages=fp32", 8, 64, 16, [130, 260, 520, 150, 300, 563, 200,
                                          400], first=True)
    # a one-row decode bucket: 300 tokens, 5 live splits x 16 heads
    paged_time("engine decode B=1 len 300 H=KV=16 D=64 ps=64 q=bf16 "
               "pages=fp32", 1, 64, 16, [300])
    paged_time("pooled decode B=4 len 40..128 H=KV=16 D=64 ps=16 pages=8 "
               "q=bf16 pages=fp32", 4, 16, 8, [40, 72, 100, 128])
    paged_time("disagg decode tier B=4 len 224..240 H=KV=16 D=64 ps=16 "
               "pages=15 q=bf16 pages=fp32", 4, 16, 15, [224, 229, 235, 240])
    paged_time("colo decode B=6 len 33..160 H=KV=16 D=64 ps=16 pages=10 "
               "q=bf16 pages=fp32", 6, 16, 10, [33, 48, 97, 128, 150, 160])
    # the moe engines' decode (phase 9): 8 rows over bf16 pools of
    # 64-token pages, olmoe's heads and mixtral's (GQA, its window)
    paged_time("olmoe decode B=8 len 250..313 H=KV=16 D=128 ps=64 q=bf16 "
               "pages=bf16", 8, 64, 16, [250 + 9 * i for i in range(8)],
               D=128, kv=bf16)
    paged_time("mixtral decode B=8 len 120..282 H=32 KV=8 D=128 ps=64 "
               "window=4096 q=bf16 pages=bf16", 8, 64, 8,
               [120, 151, 182, 213, 250, 260, 270, 282], H=32, KV=8, D=128,
               kv=bf16, window=4096)

    def flash_time(B, Sq, Skv, H, D, q_offset=0, kv_len=None,
                   q_dtype=bf16, kv_dtype=f32, causal=True):
        """(ms, plain, bound, bound_by, library, bf16 SDPA, copies) of
        one call over ``kv_dtype`` keys (an fp32 cache by default), every
        call on its own copy of the inputs: SDPA gets the keys the
        queries see, [0, kv_len), causal for a causal prefill from
        position 0, all visible for one decode query at the end of them
        and for a non-causal call.  The library call takes the inputs as
        they are where q and K/V share a dtype (bf16), else (bf16 q over
        the fp32 cache, which SDPA cannot mix) upcast to fp32."""
        n_kv = Skv if kv_len is None else kv_len
        tri = causal and Sq > 1
        pairs = Sq * (Sq + 1) // 2 if tri else Sq * n_kv
        qbytes = B * Sq * H * D * torch.finfo(q_dtype).bits // 8
        nbytes = (2 * qbytes + 2 * B * n_kv * H * D
                  * torch.finfo(kv_dtype).bits // 8)
        sets = []
        for _ in range(cold_copies(nbytes - qbytes)):
            q = torch.randn(B, Sq, H, D, generator=gen,
                            device=device).to(q_dtype)
            k, v = (torch.randn(B, Skv, H, D, generator=gen,
                                device=device).to(kv_dtype)
                    for _ in range(2))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            ks, vs = kt[:, :, :n_kv], vt[:, :, :n_kv]
            sets.append(((q, k, v), (qt, kt, vt),
                         (qt.float(), ks.float(), vs.float()),
                         (qt.to(bf16), ks.to(bf16), vs.to(bf16))))
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
        n = len(sets)
        ms = time_ms(lambda i: fa.flash_attention(*sets[i][0], **kw), n)
        plain = time_ms(lambda i: ref.attention_ref(*sets[i][1], **kw), n)
        lib16 = time_ms(lambda i: F.scaled_dot_product_attention(
            *sets[i][3], is_causal=tri), n)
        lib = lib16 if q_dtype == kv_dtype == bf16 else time_ms(
            lambda i: F.scaled_dot_product_attention(*sets[i][2],
                                                     is_causal=tri), n)
        del sets
        rate = BF16_FLOPS if q_dtype == bf16 else FP32_FLOPS
        return (ms, plain, *bound(nbytes, 4 * D * H * B * pairs, rate),
                lib, lib16, n)

    def flash_line(case, t, variant="tc", **extra):
        ms, plain, b_ms, b_by, lib, lib16, n = t
        times("flash_attention", case, ms, plain, b_ms, b_by, lib,
              variant=variant, library_bf16_ms=lib16, input_copies=n,
              **extra)

    # flash: the largest prefill bucket of the trace (512), bf16 q, fp32
    # cache; then the other buckets (32: the colocation engines'
    # prompts), zamba2's prefill and decode at
    # head_dim 112, and the fp32-q kernel at the 512 bucket
    t = flash_time(1, 512, 512, 16, 64)
    row(fa, "flash_attention", *t[:5], library_bf16_ms=t[5])
    flash_line("qwen prefill B=1 Sq=Skv=512 H=16 D=64 q=bf16 kv=fp32", t)
    for S in (32, 128, 256):
        flash_line(f"qwen prefill B=1 Sq=Skv={S} H=16 D=64 q=bf16 kv=fp32",
                   flash_time(1, S, S, 16, 64))
    flash_line("zamba2 prefill B=4 Sq=500 Skv=516 kv_len=500 H=KV=32 "
               "D=112 q=bf16 kv=fp32",
               flash_time(4, 500, 516, 32, 112, kv_len=500),
               max_abs_err=errs["flash_attention_d112"])
    flash_line("zamba2 decode B=4 Sq=1 Skv=516 q_offset=499 kv_len=500 "
               "H=KV=32 D=112 q=bf16 kv=fp32",
               flash_time(4, 1, 516, 32, 112, q_offset=499, kv_len=500))
    flash_line("fp32 q B=1 Sq=Skv=512 H=16 D=64 kv=fp32",
               flash_time(1, 512, 512, 16, 64, q_dtype=f32), variant="f32")
    # the moe and encdec paths: olmoe's 512-token prefill over its bf16
    # slot cache; whisper's non-causal encoder over 1500 frames and its
    # cross-attention (a 64-token prompt, one decode query) over them
    flash_line("olmoe prefill B=1 Sq=Skv=512 H=16 D=128 q=bf16 kv=bf16",
               flash_time(1, 512, 512, 16, 128, kv_dtype=bf16),
               max_abs_err=errs["flash_attention olmoe prefill"])
    for tag, Sq in (("encoder", 1500), ("cross prefill", 64),
                    ("cross decode", 1)):
        flash_line(f"whisper {tag} B=4 Sq={Sq} Skv=1500 H=12 D=64 "
                   f"non-causal q=bf16 kv=bf16",
                   flash_time(4, Sq, 1500, 12, 64, kv_dtype=bf16,
                              causal=False),
                   max_abs_err=errs[f"flash_attention whisper {tag}"])

    # rmsnorm: bf16 rows at d_model: qwen's 512-row bucket, decode's 8
    # rows at each path's width, zamba2's prefill (4 x 500 rows) at
    # d_model and d_inner, olmoe's 512-row prefill and 8-row decode at
    # 2048; the rows of every call are a slice of their
    # own of one buffer, cycled so each call reads cold
    def rms_time(n, d):
        copies = cold_copies(n * d * 2 + d * 2)
        xs = torch.randn(copies * n, d, generator=gen,
                         device=device).to(bf16)
        s = (1 + 0.1 * torch.randn(d, generator=gen, device=device)).to(bf16)
        x = [xs[i * n:(i + 1) * n] for i in range(copies)]
        ms = time_ms(lambda i: rn.rmsnorm(x[i], s), copies)
        plain = time_ms(lambda i: ref.rmsnorm_ref(x[i], s), copies)
        lib = (time_ms(lambda i: F.rms_norm(x[i], (d,), weight=s, eps=1e-6),
                       copies) if hasattr(F, "rms_norm") else None)
        del x, xs
        return (ms, plain, *bound(2 * n * d * 2 + d * 2, 4 * n * d,
                                  BF16_FLOPS), lib, copies)

    for n, d in ((512, 1024), (8, 1024), (8, 1536), (8, 3072), (2000, 3584),
                 (2000, 7168), (512, 2048), (8, 2048)):
        ms, plain, b_ms, b_by, lib, copies = rms_time(n, d)
        if (n, d) == (512, 1024):
            row(rn, "rmsnorm", ms, plain, b_ms, b_by, lib)
        times("rmsnorm", f"rows={n} d={d} bf16", ms, plain, b_ms, b_by, lib,
              input_copies=copies)

    # the backward kernels at phase 10's training shapes: flash at olmo's
    # (B=8, S=512, H=16, D=128; olmoe's too) and qwen's (D=64) causal bf16
    # shapes, at olmo's in fp32 (the fp32 gate's) and at whisper's
    # non-causal encoder (1500 frames) and cross-attention (448 queries
    # over 1500 frames; H=12, D=64, bf16), on the forward kernel's output
    # and log-sum-exp; RMSNorm at qwen's 4096 rows of 1024 and olmoe's
    # 4096 of 2048 in bf16.  The
    # kernel is timed as the others; the plain version's and the
    # library's times are autograd's backward of their forward on the same
    # inputs (``backward_ms``).  Flash backward's operations are 2.5x the
    # forward's over the (query, key) pairs the mask keeps; RMSNorm
    # backward's bytes are x, dy and scale in, dx and dscale out
    def flash_bwd_time(B, Sq, Skv, H, D, dt=bf16, causal=True):
        scale = 1.0 / D ** 0.5
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        q_elems, kv_elems = B * Sq * H * D, B * Skv * H * D
        size = torch.finfo(dt).bits // 8
        # q, out, dO in and dQ out; k, v in and dK, dV out; lse
        nbytes = (4 * q_elems + 4 * kv_elems) * size + B * H * Sq * 4
        sets, ad = [], []
        for _ in range(cold_copies(nbytes - (q_elems + 2 * kv_elems) * size)):
            q, do = (torch.randn(B, Sq, H, D, generator=gen,
                                 device=device).to(dt) for _ in range(2))
            k, v = (torch.randn(B, Skv, H, D, generator=gen,
                                device=device).to(dt) for _ in range(2))
            lse = torch.empty((B, H, Sq), dtype=f32, device=device)
            out = fa._launch_forward(q, k, v, causal, None, scale, 0, Skv,
                                     lse)
            sets.append((q, k, v, out, do, lse))
            ad.append(([t.transpose(1, 2).detach().requires_grad_(True)
                        for t in (q, k, v)], do.transpose(1, 2)))
        n = len(sets)
        ms = time_ms(lambda i: fa._launch_backward(
            *sets[i], causal, None, scale, 0, Skv), n)
        plain_ms = backward_ms(lambda *a: ref.attention_ref(
            *a, causal=causal), ad)
        lib_ms = backward_ms(lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=causal), ad)
        del sets, ad
        rate = BF16_FLOPS if dt == bf16 else FP32_FLOPS
        return (ms, plain_ms, *bound(nbytes, 2.5 * 4 * D * H * B * pairs,
                                     rate), lib_ms, n)

    # bf16 on the tensor-core kernel; fp32 (the fp32 gate's olmo-1b
    # layers) on the CUDA-core one
    for case, B, Sq, Skv, H, D, dt, causal in (
            ("olmo train B=8 S=512 H=KV=16 D=128 causal", 8, 512, 512, 16,
             128, bf16, True),
            ("qwen train B=8 S=512 H=KV=16 D=64 causal", 8, 512, 512, 16, 64,
             bf16, True),
            ("olmo fp32 gate train B=8 S=512 H=KV=16 D=128 causal", 8, 512,
             512, 16, 128, f32, True),
            ("whisper encoder train B=8 S=1500 H=KV=12 D=64 non-causal", 8,
             1500, 1500, 12, 64, bf16, False),
            ("whisper cross train B=8 Sq=448 Skv=1500 H=KV=12 D=64 "
             "non-causal", 8, 448, 1500, 12, 64, bf16, False),
            ("zamba2 train B=8 S=512 H=KV=32 D=112 causal", 8, 512, 512,
             32, 112, bf16, True)):
        ms, plain, b_ms, b_by, lib, n = flash_bwd_time(B, Sq, Skv, H, D, dt,
                                                       causal)
        if case.startswith("olmo train"):
            row(fa, "flash_attention_bwd", ms, plain, b_ms, b_by, lib)
        extra = ({"max_abs_err": errs["flash_attention_bwd d112"]}
                 if D == 112 else {})
        times("flash_attention_bwd", f"{case} {str(dt)[6:]}", ms, plain,
              b_ms, b_by, lib, variant="tc" if dt == bf16 else "f32",
              input_copies=n, **extra)

    # qwen's rows take the warp-per-row branch; olmoe's, mamba2's (d and
    # its gated 2d) and zamba2's the block-per-row one; qwen's is the
    # kernels line's row
    for arch, rows_n, d in (("qwen", 4096, 1024), ("olmoe", 4096, 2048),
                            ("mamba2", 4096, 1536), ("mamba2", 4096, 3072),
                            ("zamba2", 4096, 3584), ("zamba2", 4096, 7168)):
        copies = cold_copies(2 * rows_n * d * 2)
        xs = [torch.randn(rows_n, d, generator=gen, device=device).to(bf16)
              for _ in range(copies)]
        dys = [torch.randn(rows_n, d, generator=gen, device=device).to(bf16)
               for _ in range(copies)]
        s = (1 + 0.1 * torch.randn(d, generator=gen, device=device)).to(bf16)
        ms = time_ms(lambda i: rn._launch_backward(xs[i], s, dys[i], 1e-6),
                     copies)
        ad = [([x.detach().requires_grad_(True),
                s.detach().requires_grad_(True)], dy)
              for x, dy in zip(xs, dys)]
        plain = backward_ms(ref.rmsnorm_ref, ad)
        lib = backward_ms(lambda x, w: F.rms_norm(x, (w.shape[0],), weight=w,
                                                  eps=1e-6), ad)
        b_ms, b_by = bound(3 * rows_n * d * 2 + 2 * d * 2, 8 * rows_n * d,
                           BF16_FLOPS)
        if arch == "qwen":
            row(rn, "rmsnorm_bwd", ms, plain, b_ms, b_by, lib)
        times("rmsnorm_bwd", f"{arch} train rows={rows_n} d={d} bf16", ms,
              plain, b_ms, b_by, lib, input_copies=copies,
              branch="warp" if d <= rn.BWD_WARP_MAX_D else "block")
        del xs, dys, ad

    # ssd: the prefill's shapes (bf16 x and B/C, fp32 dt, the cache's
    # zero fp32 state) on the tensor-core kernel, input copies cycled so
    # each call reads cold
    for arch, B, H, N in (("mamba2", 8, 48, 128), ("zamba2", 4, 112, 64)):
        nbytes, flops = ssd_work(B, 500, H, 64, 1, N, 128, 2)
        reads = nbytes - B * 500 * H * 64 * 2 - B * H * 64 * N * 4  # - y, h
        sets = [ssd_inputs(gen, B, 500, H, 1, N, bf16, device)
                + (torch.zeros(B, H, 64, N, device=device),)
                for _ in range(cold_copies(reads))]
        ms = time_ms(lambda i: ssd.ssd_scan(
            *sets[i][:6], chunk=128, init_state=sets[i][6]), len(sets))
        plain = time_ms(lambda i: ref.ssd_chunked_ref(
            *sets[i][:6], 128, init_state=sets[i][6]), len(sets))
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        if arch == "mamba2":
            row(ssd, "ssd_scan", ms, plain, b_ms, b_by, None, variant="tc")
        times("ssd_scan", f"{arch} prefill B={B} S=500 H={H} P=64 N={N} "
              f"G=1 Q=128 bf16", ms, plain, b_ms, b_by, None, variant="tc",
              input_copies=len(sets))
        del sets

    # the SSD backward at the training shapes (mamba2: B=8, S=512, H=48,
    # N=128; zamba2: H=112, N=64; bf16 x, B, C and dy, no initial state):
    # the kernel (its three launches) beside autograd's backward of the
    # plain version on the same inputs; no single PyTorch call computes
    # it, so no library time
    for arch, H, N in (("mamba2", 48, 128), ("zamba2", 112, 64)):
        B, S = TRAIN_BATCH, TRAIN_SEQ
        nbytes, flops = ssd_bwd_work(B, S, H, 64, 1, N, 2)
        # - dx, dB, dC, ddt, dA, dD
        reads = nbytes - (B * S * H * 64 * 2 + 2 * B * S * N * 2
                          + B * S * H * 4 + 2 * H * 4)
        copies = cold_copies(reads)
        sets = [ssd_inputs(gen, B, S, H, 1, N, bf16, device)
                + (torch.randn(B, S, H, 64, generator=gen,
                               device=device).to(bf16),)
                for _ in range(copies)]
        ms = time_ms(lambda i: ssd._launch_backward(
            *sets[i][:6], None, sets[i][6], None, 128), copies)
        ad = [([t.detach().requires_grad_(True) for t in st[:6]], st[6])
              for st in sets]
        plain = backward_ms(lambda *a: ref.ssd_chunked_ref(*a, 128)[0], ad)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        if arch == "mamba2":
            row(ssd, "ssd_scan_bwd", ms, plain, b_ms, b_by, None,
                variant="tc")
        times("ssd_scan_bwd", f"{arch} train B={B} S={S} H={H} P=64 N={N} "
              f"G=1 Q=128 bf16", ms, plain, b_ms, b_by, None, variant="tc",
              run=ssd.bwd_run(B, S, H, 1, 128), input_copies=copies)
        del sets, ad

    # no time may beat the card's bound: a case under it read warm data
    # (or the bound is miscounted)
    for case, ms, b_ms in cases:
        check(ms >= b_ms / BOUND_SLACK, f"times: {case} took {ms} ms, under "
              f"its bound {b_ms} ms / {BOUND_SLACK}")
    return rows


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip smoke needs a CUDA device; none is visible")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import kernels
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False})

    t0 = time.perf_counter()
    lib = _build.build(force=True)
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib), "sources": list(_build.SOURCES)})
    for line in (lib.parent / "build.log").read_text().splitlines():
        if ("registers" in line or "spill" in line or "entry" in line
                or line.startswith("==")):
            print(line, file=sys.stderr)

    errs = kernel_checks(device)
    errs.update(backward_checks(device))
    errs.update(ssd_backward_checks(device))
    # each path runs with the counts set to 0 just before it, read after;
    # a serving path's backward launches are read as it returns (0:
    # serving never differentiates)
    counts, variants = {}, {}
    (counts["qwen1.5-0.5b"], variants["qwen1.5-0.5b"], qwen,
     qwen_params) = serve_full_width(device)
    counts["qwen1.5-0.5b"].update(kernels.backward_counts())
    gc.collect()
    torch.cuda.empty_cache()
    counts["qwen1.5-0.5b pooled"], variants["qwen1.5-0.5b pooled"] = \
        multitenant_full_width(qwen, qwen_params, device)
    counts["qwen1.5-0.5b pooled"].update(kernels.backward_counts())
    gc.collect()
    torch.cuda.empty_cache()
    counts["qwen1.5-0.5b disagg"], variants["qwen1.5-0.5b disagg"] = \
        disagg_full_width(qwen, qwen_params, device)
    counts["qwen1.5-0.5b disagg"].update(kernels.backward_counts())
    gc.collect()
    torch.cuda.empty_cache()
    counts["qwen1.5-0.5b colo"], variants["qwen1.5-0.5b colo"] = \
        colo_full_width(qwen, qwen_params, device)
    counts["qwen1.5-0.5b colo"].update(kernels.backward_counts())
    del qwen, qwen_params
    gc.collect()
    torch.cuda.empty_cache()
    moe_counts, moe_variants = moe_full_width(device)
    for c in moe_counts.values():
        c.update(kernels.backward_counts())
    counts.update(moe_counts)
    variants.update(moe_variants)
    for arch, batch, prompt, generate, steps in (
            ("mamba2-780m", 8, 500, 32, 8), ("zamba2-7b", 4, 500, 16, 0),
            ("whisper-small", 4, 64, 32, 0)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counts[arch], variants[arch] = fixed_batch_full_width(
            arch, device, batch, prompt, generate, profile_steps=steps)
        counts[arch].update(kernels.backward_counts())
    check(not any(c[k] for c in counts.values() for k in kernels.BACKWARD),
          "a serving path launched a backward kernel")
    gc.collect()
    torch.cuda.empty_cache()
    losses = {}
    train_counts_, train_variants = train_phase(device, smi, losses)
    counts.update(train_counts_)
    variants.update(train_variants)
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(dp_phase(smi))
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(tp_phase(smi, losses["qwen1.5-0.5b"]))
    names = sorted({name for c in counts.values() for name in c})
    total = {name: sum(c.get(name, 0) for c in counts.values())
             for name in names}
    emit({"phase": "smoke", "seconds_before_times":
          time.perf_counter() - t_start})
    emit({"phase": "launches", "per_path": counts,
          "kernel_variants_per_path": variants, "total": total})
    check(all(n > 0 for n in total.values()),
          f"a kernel never ran on the main paths: {total}")
    rows = kernel_times(device, total, errs)
    emit({"phase": "smoke", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
