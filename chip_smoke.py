"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repo root, one GPU

Phases, each printing one JSON line; any failure raises (nonzero exit,
no result line):

1. device   - the card's name and power limit, TF32 off;
2. build    - the CUDA kernels of ``src/repro_torch/csrc`` compiled by
              nvcc, with the build time; then, beside the card's phases,
              phases 6-8's CPU references in a process of their own and
              phases 11-13's world's 4 ranks spawned to import and wait
              for its go (every process this script starts is stopped
              before it exits);
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
6.  pooled  - (run right after phase 4, on its model and weights cut to
              their first ``SERVE_DEPTH`` = 2 layers, as phases 7 and 8)
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
              same scenario at smoke width on the CPU (computed, with
              phases 7's and 8's, by a process of this run's own while
              the card runs phases 3-5, ``cpu_smoke_refs``), and the
              paged, flash and RMSNorm launches exact;
7.  disagg  - (run right after phase 6, on phase 6's cut)
              benchmarks/fig12_disagg.py's smoke scenario at full width:
              12 requests of 224 prompt tokens and 16 new on 4-slot
              engines of 16-token pages, modeled costs priced at the
              full-size model, link capacities in pages per modeled
              second.  On the cut in bf16: two colocated engines
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
8.  colo    - (run right after phase 7, on phase 6's cut)
              benchmarks/fig11_colocation.py's smoke scenario at full
              width: two tenants' bursts (6 requests each, 32 prompt
              tokens, 128 new) on 6-slot engines of 16-token pages under
              a 20-page quota, spilling KV over one tier-2 trunk, while
              an 8-way data-parallel training job (colo-13b, 16 GB of
              tier-2 offload, 8 steps) prices its gradient and offload
              phases on the same ``Transport`` (``repro_torch.colo``,
              ``run_colo``), on 6 pods of 5 accels over 3 CXL leaves and
              2 tier-2 memory nodes.  On the cut in bf16: the training
              job placed hop-only, contention-aware, and no training.
              Checked: every request done, fig11's five claims (the
              placements differ, contention-aware placement wins on step
              time and aggregate p95, tokens identical across the three
              runs, the trunk carries serving and training bytes, the
              transport re-rated contended transfers), the modeled
              numbers within 1e-9 of the same scenario's at smoke width
              on the CPU, the paged, flash and RMSNorm launches exact per
              run, and the hop-only trace clean under the port's
              sanitizer; on the first layer (``CO_SHALLOW``) in fp32 the
              three runs again, every modeled number equal to the CPU's
              to the last digit; on it in bf16 the port's racecheck
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
              processes: the first grid of phase 12's spawned world of
              4 ranks sharing the card, (pod 2, data 2, model 1) over
              gloo (``launch.mesh``; NCCL refuses two ranks on one
              card), each collective on a pinned host copy
              (``core.hierarchy``), the kernels built by this process
              first; any rank's failure or the world's overrunning
              ``TP_WORLD_LIMIT_S`` fails the run.  The
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
              at full width on its first 2 of 24 layers (``DP_DEPTH``)
              in bf16, 4 ranks x B=2 x S=512 (the weights of seed 0,
              phase 10 (c)'s batches), 3 steps each of
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
              ``hierarchical`` with ``compress_pod``, 3 steps; started
              after phase 12 (d)'s two CLI worlds) exits 0
              with mesh, dp_mode and backend ``gloo`` in its summary.
              Every time here is 4 ranks sharing one card: it measures
              nothing of a fabric;
12. tp      - (run after phase 11, in its world) tensor parallelism
              over ``model`` and FSDP over ``data``
              (``repro_torch.sharding.tp``): the world's ranks hold two
              more grids in turn, their groups formed in the same
              processes: (data 2, model 2) with FSDP off (the reference
              CLI's rules) and on, and (pod 2, data 1, model 2)
              ``hierarchical`` with ``compress_pod``.  (a) qwen1.5-0.5b at
              full width on its first 2 layers in fp32, global B=8 x
              S=512, 2 steps of each case against the one-process step on
              the same weights and batches (the compressed case against
              the plain in-process evaluation of the reference's
              compressed mean over the two pods, residuals carried): loss
              and grad norm to 1e-5 relative, the parameters gathered
              from the ranks to 1e-5 of the largest |parameter| but at
              most ``DP_PARAM_SHARE`` of them (C-port15); (b) full width
              on the first ``TP_DEPTH`` = 2 layers in bf16, phase 10
              (c)'s weights and batches, 3 steps of each case: s/step,
              host seconds in collectives and bytes by (axes, op), each
              rank's peak, launches exact in every rank (B2, B3, B5, B6
              on a rank's local heads), ranks' losses equal and each
              within 1e-2 of one card's on the same cut, run by this
              process while the world runs phase 11 (``tp_one_card``,
              as (e)'s and (f)'s) (the compressed case's of the plain
              in-process
              evaluation of the same schedule: int8 codes move a
              trajectory further); (c) a step with FSDP on the 2-layer cut in bf16 run
              twice from one state: the same bits in every rank; (d) the
              training CLI under ``torch.distributed.run`` on 4 ranks
              with no ``--pool`` (qwen1.5-0.5b at full width on its
              first 2 layers, the reference's smoke mesh (data 2, model
              2), tensor parallel, 3 steps of 8 x ``CLI_SEQ`` = 128),
              then under
              ``--max-restarts 1`` through a wrapper whose failure hook
              raises on rank 1 at step 2 of the first attempt, with
              ``--ckpt-every 1``: exit 0, the resume reported, every
              step's loss equal in bits to the first run's (both worlds
              and phase 11 (d)'s at once); (e) expert parallelism on
              the world's (data 2, model 2) grid: olmoe-1b-7b at full
              width on its first ``EP_DEPTH`` = 1 layer (64 experts, 32
              a rank over ``model``, the dispatch group the whole
              batch: each layer's entries' experts gathered over
              ``data``),
              the fp32 gate of ``tp`` and ``tp_fsdp`` (2 steps each
              against one card, as (a)), then 3 timed bf16 steps of
              ``tp``: s/step, each rank's peak, host seconds and bytes
              in collectives by (axes, op), the expert gather
              (``moe-experts``) and the expert layer's sum over ``model``
              (``moe``) apart, launches exact (B2, B3, B5, B6 on local
              heads), the ranks' losses equal and within 1e-2 of one
              card's; (f) the ssm and hybrid families under the ``ssm_*``
              rules on that grid (``models/mamba2.py``: the SSD heads,
              ``in_proj``'s contiguous column blocks and the conv
              channels over ``model``, one gather of the projection and
              conv weights a layer, the gated norm's sum of squares
              summed over ``model`` in plain ops, the row-parallel
              ``out_proj``): mamba2-780m at full width on its first 2 of
              48 layers (24 of 48 SSD heads a rank) with FSDP off and on,
              zamba2-7b on its first ``ZAMBA2_GATE_DEPTH`` = 7 of 81 (the
              shared block's 16 of 32 heads and 56 of 112 SSD heads a
              rank, a tail layer) with FSDP off, each the fp32 gate (2
              steps against one card, as (a); zamba2 at ``TRAJ_LR``)
              then 3 timed bf16 steps of ``tp`` as (e), the launches
              exact (one RMSNorm a Mamba2 layer: its gated norm is not
              B2's under ``model``; every B4 and B8 call on the tensor
              cores), the ``ssm`` and ``ssm-norm`` collectives made;
              (g) the encdec family on that grid (``models/encdec.py``:
              each attention of the encoder and decoder on a rank's
              heads, the cross K/V from encoder states behind one
              ``copy_to_model`` whose backward sums their gradient over
              ``model`` once a step, ``cross``): whisper-small at full
              width on the first 2 layers of each stack (6 of 12 heads a
              rank), phase 10 (i)'s frames, B=8 x 448 decoder tokens x
              1500 frames, FSDP off and on, the fp32 gate (2 steps
              against one card, as (a)) then 3 timed bf16 steps of
              ``tp`` as (e): launches exact (B3 and B5 on the tensor
              cores), one ``cross`` all-reduce a step, its host seconds
              and the step's share in collectives reported.
              Every time here is 4 ranks sharing one card: nothing of a
              fabric;
13. tp serve - (in phase 12's world, after its grids, their state
              freed) the request-level engine under a (data 1, model 4)
              lease (``Engine.from_lease``: each rank joins the lease's
              grid, serves 4 of qwen1.5-0.5b's 16 heads over a page pool
              of its 4 kv heads, the MLP column -> row, greedy tokens by
              ``tp.vocab_parallel_argmax``), on phase 4's trace, quota
              and tier-2 budget.  (a) the first 2 layers in fp32: every
              rank's tokens, the modeled latency summary, every handle's
              clocks and the KV stats (spills, fetches) equal the
              one-card fp32 engine's on the same weights (rank 0 runs
              it), a divergence passing only as a documented tie: the
              one-card top-2 logit margin at that step within
              ``TS_TIE_MARGIN`` (C-ref3); the first prompt's prefill
              logits, gathered over ``model``, against the one-card
              ones; (b) full width on the first ``SERVE_DEPTH`` layers
              in bf16: every rank
              completes the 16 requests with spills and fetches, its
              tokens equal rank 0's, its launches exact (B1 a decode
              step and B3 a prefill per layer, B2 49 a call, all flash
              on the tensor cores), wall seconds, decode tokens per wall
              second and host seconds in collectives a step by (axes,
              op); one card's tokens on the same cut beside, reported
              (bf16 rounding parts them, C-port2); (c) each rank's B1 and B3
              at its local shapes (4 of 16 heads; B1 also at (h)'s, 4 rows
              on 8 heads), and B3 and B2 at (d)'s session shapes on each
              grid, against their plain versions within ``TOL``; (d) the fixed-batch session
              (``runtime.serve.make_lease_session``) on the (data 1,
              model 4) lease and on a (data 2, model 2) lease, a second
              grid formed in the running world: rows over ``data``,
              heads over ``model``, the greedy token gathered over the
              batch axes; in fp32 on the first 2 layers every step's
              gathered logits within 1e-5 of the largest |logit| of the
              one-card session's (rank 0 runs it) on rows whose tokens
              agree, the tokens equal or parted at a documented tie
              (C-ref3); in bf16 on the first ``SERVE_DEPTH`` layers B=8
              rows of 512-token
              prompts and 32 new tokens: every rank's tokens rank 0's,
              B2 and B3 launches exact (B3 on the tensor cores),
              prefill and decode seconds, decode tokens per wall second
              and host seconds in collectives by (axes, op); (e) two
              tenants of one (data 1, model 4) lease over one
              ``PoolArbiter`` a rank, phase 4's trace with
              ``TS_MT_NEW`` = 32 new tokens a request split
              round-robin over a ``TS_MT_PAGES``-page pool that revokes
              pages, fp32 on the first 2 layers: every rank's tokens,
              clocks and arbiter stats equal, the pages checked after
              every step, the trace sanitized, both tenants on one grid
              over a pool of the rank's kv heads, every rank's B1-B3
              launches exact (fp32 flash on the CUDA cores); held to the
              one-card
              two-tenant run (rank 0) in tokens (or a documented tie),
              every handle's clocks and the arbiter's stats; (f) phase
              7's scenario on a gang of two (data 1, model 4) members,
              every engine on one grid: colocated, direct and the
              degenerate cluster in fp32 on the first 2 layers, tokens
              (or a documented tie) and every modeled number equal to
              one card's (phase 7 runs them); colocated and direct in
              bf16 on phase 7's cut: tokens equal across ranks and
              reported beside phase 7's, modeled numbers within 1e-9 of
              phase 7's, fig12's decode p95 claim, every
              ``handoff_use`` after its last page; (g) phase 8's three
              runs on a (data 1, model 4) lease in fp32 on the first
              layer (``CO_SHALLOW``): tokens and modeled numbers equal
              to one card's
              (phase 8 runs them), fig11's five claims; in (f) and (g)
              the traces sanitized, the launches exact in every rank for
              every run, wall, collectives and peak reported; (h) the
              engine on a (data 2, model 2) lease (one grid, joined by
              its first engine): each rank decodes its block of every
              decode bucket's rows on 8 of the 16 heads, its page pool
              replicated over ``data`` and kept equal by one all-gather
              a decode step: phase 4's trace in fp32 on the first 2
              layers, every rank's tokens (or a documented tie), clocks,
              latency summary and KV stats equal to (a)'s one-card run,
              the pools of the two data replicas of each ``model`` index
              equal in bits (a digest of each); in bf16 on the first
              ``SERVE_DEPTH`` layers tokens equal across ranks, B1-B3
              launches exact, one ``data`` gather a decode step, wall,
              decode tokens per wall second and collectives beside (b)'s
              and one card's on the same cut; (f)'s direct cluster on a
              gang of two (data 2, model 2) members in fp32 on 2 layers,
              tokens (or a tie) and modeled numbers equal to one card's
              (``dg_cut_runs``), its decode replicas equal in bits; the
              traces sanitized; (i) the engine serving olmoe-1b-7b at
              full width on the first ``SERVE_DEPTH`` layers on a (data
              2, model 2) lease (32 of its 64 experts and 8 of its 16
              heads a rank, each decode bucket's dispatch group the
              whole bucket), on phase 9's trace, quota and budget: in
              fp32 every rank's tokens (or a documented tie), clocks,
              latency summary and KV stats equal to one card's on the
              same weights (rank 0 runs it); in bf16 on phase 9's bf16
              pages tokens equal across ranks, wall seconds and decode
              tokens per wall second beside one card's; in both the
              data replicas' pool digests equal, B1-B3 launches exact,
              one K/V gather and an expert gather a layer over ``data``
              each decode step, one expert sum over ``model`` a layer
              each model call, the traces sanitized; (c) holds B1 and
              B3 at its rank's shapes (4 rows on 8 heads at D=128 over
              bf16 pages; a 512-token prefill on 8 heads); (j) the
              fixed-batch session on a (data 2, model 2) lease for
              mamba2-780m on its first 2 layers and zamba2-7b on its
              first 7: in fp32 ``TS_SESSION``'s rows and prompts, 8 new
              tokens, every step's gathered logits within 1e-5 of the
              largest |logit| of the one-card session's (rank 0 runs it),
              tokens equal or parted at a documented tie; in bf16 32 new
              tokens: tokens equal across ranks, B2-B4 launches exact (an
              SSD scan a Mamba2 layer in the prefill, one B2 a Mamba2
              layer a call), the three collectives a Mamba2 layer a call,
              decode tokens per wall second beside one card's; (c) holds
              B4 and B8 at (f)'s and (j)'s rank shapes (4 rows of 512,
              24 or 56 SSD heads) and B3 and B5 at zamba2's rank shapes
              (16 heads at D=112); (k) the fixed-batch session on that
              lease for whisper-small on the first 2 layers of each
              stack: 8 rows of 1500 seeded frames and 64-token prompts,
              in fp32 8 new tokens held to one card's session as (j), in
              bf16 32 new tokens through ``launch.serve``'s fixed-batch
              loop: tokens equal across ranks, B3 launches exact (on the
              tensor cores), the lookup's and three sums a decoder layer
              a call (two an encoder layer in the prefill), decode
              tokens per wall second beside one card's; (c) holds B3 and
              B5 at (g)'s rank shapes (4 rows, 6 heads: the encoder's
              1500 x 1500 and the cross-attention's 448 x 1500,
              non-causal).  4 ranks share one card over gloo: nothing of
              a fabric;
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
              zamba2's prefill and at phase 13 (j)'s rank prefill (4
              rows of 512 on 24 and 56 heads), flash at its zamba2 rank
              prefill (16 heads, D=112); paged at olmoe's and mixtral's 8-row
              decode and at a rank's decode in phase 13 ((b), (f), (g)
              and (h)'s 4 rows on 8 heads, (i)'s 4 rows on 8 of olmoe's
              heads at D=128), flash at a session rank's decode (phase
              13 (d)) and at (i)'s rank prefill (8 heads, D=128),
              at olmoe's 512 prefill and whisper's encoder
              and cross-attention, RMSNorm at 512 and 8 rows of 2048; the
              backward kernels at phase 10's shapes: flash at olmo's and
              qwen's B=8 x S=512 in bf16 (tensor cores), at olmo's in
              fp32 (CUDA cores) and at whisper's encoder (1500 frames)
              and cross-attention (448 x 1500) in bf16, RMSNorm at
              qwen's 4096 x 1024, olmoe's 4096 x 2048, mamba2's 1536 and
              3072 and zamba2's 3584 and 7168 wide, flash at
              zamba2's B=8 x S=512, H=32, D=112 and at phase 12 (f)'s
              rank (B=4, H=16), flash forward and backward at phase 12
              (g)'s rank (whisper's encoder and cross-attention, B=4,
              H=6), and the SSD backward at mamba2's and
              zamba2's training calls and at (f)'s rank shapes (B=4, 24
              and 56 heads; no library call
              computes it), beside autograd's backward of the plain
              version and of bf16 SDPA / ``F.rms_norm``: graphs of forward
              and backward less the forward's).  Every call reads cold
              inputs: the copies cycled through read more than twice the
              L2 a cycle.
              A time under its bound / 1.05 fails the run;
then the ``launches`` and ``kernels`` lines (phases 6, 7, 8, 9, 4f, 10,
11, 12 and 13's launches among the paths, phases 11-13 per rank, the
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
SERVE_DEPTH = 2                 # the serving scenarios' bf16 depth (phases
                                # 6-8, 13 (b), (d), (f) and (h)):
                                # qwen1.5-0.5b's first 2 of 24 layers (24
                                # until the script overran its 1200 s limit
                                # on a slower H100 host, then 4 until phase
                                # 13 (h) took it past 1000 s on one; phase
                                # 4 serves all 24); fp32 KV pages of 2^18
                                # B, a power of two from the smoke width's
TP_DEPTH = 2                    # phase 12 (b)'s depth, cut from 24 with it
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

def serve_parts(cfg):
    """Phase 4's engine shape, KV budget and trace (phase 13 serves them
    too): 8 slots of 1024 tokens in 64-token pages, a 32-page quota, 4
    GB of tier 2, 16 requests of 120/250/500 prompt tokens and 64 new.
    The prompts end a few tokens short of a page boundary, so decode
    grows each sequence by a page: page-aligned prompts with 64 new
    tokens never outgrow their admission pages, and no quota could then
    force a spill without failing a request OOM."""
    from repro_torch.core.tiering import KVBudget
    from repro_torch.serve import EngineConfig, synthetic_trace
    return (EngineConfig(max_slots=8, max_seq=1024, page_size=64),
            KVBudget(tier1_pages=32, tier2_bytes=4e9, page_size=64),
            synthetic_trace(16, prompt_lens=PROMPT_LENS, max_new_tokens=64,
                            mean_interarrival_s=0.002, vocab=cfg.vocab,
                            seed=0))


def serve_cut(model, params, n_layers=None):
    """``model`` at full width on its first ``n_layers`` layers
    (``SERVE_DEPTH`` by default), with those layers of its loaded
    ``params``."""
    from repro_torch.models.api import build_model
    n = SERVE_DEPTH if n_layers is None else n_layers
    return (build_model(dataclasses.replace(model.cfg, n_layers=n),
                        device=model.device),
            {**params, "layers": params["layers"][:n]})


def serve_full_width(device):
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.serve import Engine, latency_summary, run_trace

    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    tracer = Tracer(1 << 20)
    ecfg, budget, trace = serve_parts(cfg)
    engine = Engine.local(model, ecfg, generator=gen, budget=budget,
                          tracer=tracer, device=device)
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


def sanitize_report(tracers) -> dict:
    """Each tracer through the port's sanitizer, and its Chrome export
    through ``validate_trace_events``: the events, violations, export
    problems and rule checks summed, and the first violation's report."""
    from repro_torch.analysis import sanitize_tracer
    from repro_torch.obs import to_chrome_trace, validate_trace_events
    out = {"traces": len(tracers), "events": 0, "violations": 0,
           "problems": 0, "checks": {}, "first": None, "dropped": 0}
    for tr in tracers:
        rep = sanitize_tracer(tr)
        problems = validate_trace_events(to_chrome_trace(tr))
        if out["first"] is None and not (rep.ok and not problems):
            out["first"] = rep.format() if not rep.ok else str(problems[:5])
        out["events"] += rep.events
        out["violations"] += len(rep.violations)
        out["problems"] += len(problems)
        out["dropped"] += tr.dropped
        for rule, n in rep.checks.items():
            out["checks"][rule] = out["checks"].get(rule, 0) + n
    return out


def sanitize(what: str, tracers) -> dict:
    """``sanitize_report`` of the tracers: zero violations and zero
    problems, or the run fails."""
    out = sanitize_report(tracers)
    check(out["violations"] == 0 and out["problems"] == 0,
          f"{what}: the sanitizer or the trace export found faults:\n"
          f"{out['first']}")
    out.pop("first")
    out.pop("dropped")
    emit({"phase": "sanitize", "path": what, **out})
    return out


def cpu_smoke_refs() -> dict:
    """Phases 6, 7 and 8's scenarios at smoke width on the CPU, the
    numbers their full-width runs on the card must equal: {"mt": fig9's
    modeled numbers and the static partitions' clocks, "dg": fig12's
    modeled numbers, "co": fig11's modeled numbers, claims and page
    bytes}, each with its seconds.  ``main`` computes them in a process
    of its own while the card runs phases 3-5 (``cpu_refs_start``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    small = build_model(get_config("qwen1.5-0.5b", smoke=True),
                        device="cpu")
    params = small.init(torch.Generator().manual_seed(0))
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # its ops are tiny: threads only wait
    out = {}
    try:
        t0 = time.perf_counter()
        modeled = mt_modeled(*mt_pooled(small, params, cpu, watch=True)[:3])
        static = mt_static(small, params, cpu)
        out["mt"] = {"modeled": modeled, "static_clocks": {
            t: [(h.submit_clock, h.first_token_clock, h.done_clock)
                for h in static[t]] for t in MT_TENANTS},
            "seconds": time.perf_counter() - t0}
        t0 = time.perf_counter()
        trace = dg_trace()
        runs, _ = dg_main_runs(small, params, cpu, trace)
        runs.update(dg_staging_runs(small, params, cpu, trace))
        out["dg"] = {"modeled": dg_modeled(runs),
                     "seconds": time.perf_counter() - t0}
        t0 = time.perf_counter()
        runs, _, page = co_three(small, params, cpu, CO_REQUESTS, CO_STEPS)
        out["co"] = {"modeled": {k: co_modeled(r, page)
                                 for k, r in runs.items()},
                     "claims": co_claims(runs), "page": page,
                     "seconds": time.perf_counter() - t0}
    finally:
        torch.set_num_threads(threads)
    return out


def cpu_refs_child(path: str) -> None:
    """``cpu_smoke_refs`` in a spawned process, pickled to ``path``."""
    import pickle
    Path(path).write_bytes(pickle.dumps(cpu_smoke_refs()))


def cpu_refs_start():
    """Start ``cpu_refs_child``; returns (process, path)."""
    import multiprocessing
    path = Path(__file__).resolve().parent / "build" / "cpu_refs.pkl"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    proc = multiprocessing.get_context("spawn").Process(
        target=cpu_refs_child, args=(str(path),))
    proc.start()
    return proc, path


def cpu_refs_join(proc, path) -> dict:
    """The side process's references, once it exits 0."""
    import pickle
    proc.join(timeout=600)
    check(proc.exitcode == 0, f"the CPU smoke-width references' process "
          f"exited {proc.exitcode}")
    return pickle.loads(path.read_bytes())


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


def multitenant_full_width(model, params, device, cpu_refs):
    """fig9's smoke scenario served on the card from one physical KV
    pool: (a) the three tenants on one ``PoolArbiter`` on ``model`` (full
    width, ``SERVE_DEPTH`` layers), every kernel launch counted and the pages checked after every
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
    the CPU (``cpu_refs``, ``cpu_smoke_refs``' report)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.pool import smoke_pool
    from repro_torch.serve import (KVBudget, PoolArbiter, RequestStatus,
                                   latency_summary, run_multi_trace,
                                   run_trace)

    # the same scenario at smoke width on the CPU (``cpu_refs``)
    ref = cpu_refs["mt"]
    cpu_modeled, cpu_static, cpu_s = (ref["modeled"], ref["static_clocks"],
                                      ref["seconds"])

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
    static_equal = static_clocks == cpu_static
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
    sanitize("multitenant (a) pooled (bf16)", [tracer])
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


class DgTiers:
    """Phase 13 (f)'s and (h)'s engines: ``Engine.from_lease`` of the
    members of one ``lease_gang`` of the smoke pool (``prefill`` and
    ``decode``, as many accelerators as the world's ranks each, and
    ``model_parallel``, ``TS_MODEL`` by default) on one grid, ``grid`` or the one the first
    engine joined, each with the budget ``Engine.local`` takes when
    given none."""

    def __init__(self, model_parallel=None, grid=None):
        from repro_torch.pool import smoke_pool
        self.gang = smoke_pool("scalepool").lease_gang(
            "disagg-tp", {"prefill": dict(n_accels=TS_MODEL),
                          "decode": dict(n_accels=TS_MODEL, tier2_gb=8,
                                         kv_gb=4)},
            model_parallel=model_parallel or TS_MODEL)
        self.grid = grid

    def engine(self, model, cfg, role: str, **kw):
        from repro_torch.serve import Engine, KVBudget
        eng = Engine.from_lease(model, self.gang[role], cfg, grid=self.grid,
                                budget=KVBudget(page_size=cfg.page_size),
                                **kw)
        self.grid = eng.grid
        return eng


def dg_engine(model, params, device, tiers=None, role="decode", **kw):
    """One engine of the scenario: modeled costs priced at the full-size
    qwen1.5-0.5b (fig12's ``_cost_model``), whatever width is served;
    with ``tiers`` (a ``DgTiers``), from its member ``role``."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, EngineConfig, ServeCostModel
    full = get_config("qwen1.5-0.5b")
    cfg = EngineConfig(max_slots=DG_SLOTS, max_seq=DG_PROMPT + DG_MAX_NEW,
                       page_size=DG_PAGE)
    kw.update(params=params, device=device,
              cost_model=ServeCostModel.from_fabric(2.0 * full.param_count()))
    if tiers is not None:
        return tiers.engine(model, cfg, role, **kw)
    return Engine.local(model, cfg, **kw)


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


def dg_colocated(model, params, device, trace, tracer=None, tiers=None):
    """The equal-hardware baseline: two colocated engines, the burst
    split round-robin, on one modeled clock (with ``tiers``, one from
    each member)."""
    from repro_torch.serve import run_multi_trace
    engines = [dg_engine(model, params, device, tiers, role,
                         tenant=f"colo{k}", tracer=tracer)
               for k, role in enumerate(("prefill", "decode"))]
    res = run_multi_trace(list(zip(engines, [trace[0::2], trace[1::2]])))
    out = [None] * len(trace)
    for k in (0, 1):
        for j, h in enumerate(res[k]):
            out[k + 2 * j] = h
    return out, None


def dg_disagg(model, params, device, trace, *, staging, pages_s,
              saturate=False, tracer=None, tiers=None):
    """One prefill pod and one decode pod over fig12's fabric, link
    capacity ``pages_s`` pages of the decode engine's page bytes per
    modeled second, so the schedule does not depend on the width."""
    from repro_torch.disagg import DisaggCluster, DisaggConfig, PrefillWorker
    from repro_torch.fabric import Transport
    pe = dg_engine(model, params, device, tiers, "prefill",
                   tenant="prefill0", tracer=tracer)
    de = dg_engine(model, params, device, tiers, "decode", tenant="decode0",
                   tracer=tracer)
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


def dg_degenerate(model, params, device, trace, tracers, tiers=None):
    """route=None, one pod: the cluster against ``run_trace(Engine)``,
    tokens and trace events."""
    from repro_torch.disagg import DisaggCluster, PrefillWorker
    from repro_torch.obs import Tracer
    from repro_torch.serve import run_trace
    tr_a, tr_b = Tracer(1 << 16), Tracer(1 << 16)
    tracers += [tr_a, tr_b]
    plain = run_trace(dg_engine(model, params, device, tiers, tracer=tr_a),
                      trace)
    idle = PrefillWorker(dg_engine(model, params, device, tiers, "prefill",
                                   tracer=tr_b))
    got = DisaggCluster([idle], [dg_engine(model, params, device, tiers,
                                           tracer=tr_b)]).run(trace)
    key = lambda t: [(e.ph, e.track, e.name, e.ts, e.dur, e.args)
                     for e in t.events()]
    ev_a, ev_b = key(tr_a), key(tr_b)
    return {"tokens_identical": [h.tokens for h in plain]
            == [h.tokens for h in got],
            "events_identical": ev_a == ev_b, "events": len(ev_a),
            "done": all(h.done for h in plain + got),
            "tokens": [h.tokens for h in got],
            "clocks": [(h.submit_clock, h.first_token_clock, h.done_clock)
                       for h in got]}


def dg_decode_p95(handles) -> float:
    """p95 of the decode phase (done - first token), fig12's
    interference axis."""
    ds = sorted(h.done_clock - h.first_token_clock for h in handles)
    return ds[max(0, math.ceil(0.95 * len(ds)) - 1)]


def dg_mean_transit(handles) -> float:
    return sum(h.kv_transit_s for h in handles) / max(1, len(handles))


def dg_main_runs(model, params, device, trace, tracers=None,
                 names=DG_MAIN, tiers=None, launches=None):
    """The runs fig12 compares on ``model`` (of ``names``): colocated,
    direct and tier-2 staged, each with its wall time; with ``launches``
    (a dict) each run's kernel launches and variants, counted from 0."""
    import torch
    from repro_torch import kernels
    from repro_torch.obs import Tracer
    runs, walls = {}, {}
    for name, fn, kw in (
            ("colocated", dg_colocated, {}),
            ("direct", dg_disagg, dict(staging="direct",
                                       pages_s=DG_FAST_PAGES_S)),
            ("tier2", dg_disagg, dict(staging="tier2",
                                      pages_s=DG_FAST_PAGES_S))):
        if name not in names:
            continue
        tracer = None
        if tracers is not None:
            tracer = Tracer(1 << 18)
            tracers.append(tracer)
        if device.type == "cuda":
            torch.cuda.synchronize()
        if launches is not None:
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runs[name] = fn(model, params, device, trace, tracer=tracer,
                        tiers=tiers, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if launches is not None:
            launches[name] = {"launches": kernels.launch_counts(),
                              "variants": kernels.variant_counts()}
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


def dg_fp32_cut(model, params, device):
    """``model``'s first ``TRAIN_CUT`` layers at full width in fp32 and
    those layers of ``params``, upcast exactly."""
    from repro_torch.models.api import build_model
    m32 = build_model(dataclasses.replace(model.cfg, n_layers=TRAIN_CUT,
                                          compute_dtype="float32"),
                      device=device)
    return m32, m32.load({**params, "layers": params["layers"][:TRAIN_CUT]})


def dg_cut_runs(model, params, device, tiers=None, tracers=None,
                launches=None):
    """Phase 13 (f)'s fp32 runs, on one card (phase 7) or from ``tiers``:
    colocated and direct (``TS_DG_MAIN``) and the degenerate cluster on
    6 requests, on the first ``TRAIN_CUT`` layers of ``model`` at full
    width in fp32, the weights of ``params`` upcast exactly.  Returns
    (their tokens, modeled numbers, the degenerate cluster's report and
    wall seconds; the fp32 model and its full parameters)."""
    import torch
    from repro_torch import kernels

    trace = dg_trace()
    m32, p32 = dg_fp32_cut(model, params, device)
    runs, walls = dg_main_runs(m32, p32, device, trace, tracers, TS_DG_MAIN,
                               tiers, launches)
    if launches is not None:
        kernels.reset_launch_counts()
    t0 = time.perf_counter()
    degenerate = dg_degenerate(m32, p32, device, trace[:6],
                               tracers if tracers is not None else [], tiers)
    if device.type == "cuda":
        torch.cuda.synchronize()
    walls["degenerate"] = time.perf_counter() - t0
    if launches is not None:
        launches["degenerate"] = {"launches": kernels.launch_counts(),
                                  "variants": kernels.variant_counts()}
    return ({"tokens": {k: [h.tokens for h in runs[k][0]] for k in runs},
             "clocks": {k: [(h.submit_clock, h.first_token_clock,
                             h.done_clock) for h in runs[k][0]]
                        for k in runs},
             "modeled": dg_modeled(runs), "degenerate": degenerate,
             "wall_s": walls}, m32, p32)


def disagg_full_width(model, params, device, cpu_refs):
    """fig12's smoke scenario served on the card: a prefill engine
    exports each prompt's KV page by page (``prefill_export``), the
    router streams the pages over the modeled fabric and plants each
    request on the decode engine (``submit_prefilled``).  At full width
    and depth in bf16, every kernel launch counted: two colocated engines
    against disaggregation direct and tier-2 staged, and the degenerate
    cluster against ``run_trace(Engine)`` on 6 requests; at ``model``'s
    depth in fp32 (TF32 off) the three token streams held equal; on the first
    ``DG_SHALLOW`` layers the four staging runs (saturated and idle
    trunk).  The modeled numbers must equal the same scenario's at smoke
    width on the CPU (``cpu_refs``, as phase 6's)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models.api import build_model

    trace = dg_trace()
    ref = cpu_refs["dg"]
    cpu_modeled, cpu_s = ref["modeled"], ref["seconds"]

    # full width at model's depth, bf16, every kernel launch counted
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
    # phase 13 (f)'s one-card references: the fp32 runs on the first
    # TRAIN_CUT layers, and these bf16 runs' tokens and modeled numbers
    t1 = time.perf_counter()
    cut_ref, m32, _ = dg_cut_runs(model, params, device)
    cut_s = time.perf_counter() - t1
    del m32
    refs = ts_dg_refs(runs, modeled, cut_ref)
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
          "trace_dropped": sum(t.dropped for t in tracers),
          "fp32_cut_for_phase_13": {"layers": TRAIN_CUT, "seconds": cut_s,
                                    "modeled": cut_ref["modeled"]}})
    check(all(t.dropped == 0 for t in tracers),
          "disagg: trace ring dropped events")
    sanitize("disagg colocated, direct, tier2 and degenerate (bf16)",
             tracers)
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
    check(cut_ref["degenerate"]["tokens_identical"]
          and cut_ref["degenerate"]["events_identical"],
          f"disagg: the degenerate cluster on {TRAIN_CUT} layers in fp32 "
          f"is not the engine's run")
    return counts, variants, refs


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
CO_SHALLOW = 1              # depth of the fp32 pass, the racecheck and
                            # phase 13 (g) (2 until phase 13 (h) took the
                            # script past 1000 s on a slower H100 host)
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
           bw: float, tracer=None, lease=None, grid=None):
    """One fig11 run (``_run_policy``): place serving and training under
    ``policy``, serve both tenants over the placement's spill route and
    step the training job on its collective routes, on one shared
    ``Transport`` through ``run_colo``.  The tracer, when given, records
    the engines as well as the transport.  ``lease``: the engines come
    from it (``Engine.from_lease``; a (data 1, model m) lease in a world
    of m ranks serves both tenants on one grid, ``grid`` when given)."""
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
    engines = {}
    for t in CO_TENANTS:
        kw = dict(params=params, device=device,
                  budget=KVBudget(CO_QUOTA, 1e9, CO_PAGE), cost_model=cm,
                  transport=tx, route=spill, tenant=t, tracer=tracer)
        if lease is None:
            engines[t] = Engine.local(model, cfg, **kw)
        else:
            engines[t] = Engine.from_lease(model, lease, cfg, grid=grid,
                                           **kw)
            grid = engines[t].grid
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
            "links": link_report(tx), "transport": tx.stats(),
            "grid": grid}


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


def co_three(model, params, device, n_requests, n_steps, lease=None,
             tracers=None, launches=None):
    """fig11's three runs, each with its wall time, and the page bytes;
    with ``lease``, every run's engines from it on one grid, with
    ``tracers`` (a list) each run traced into a new one, and with
    ``launches`` (a dict) each run's kernel launches and variants,
    counted from 0."""
    import torch
    from repro_torch import kernels
    from repro_torch.obs import Tracer
    bw, page_bytes = co_bw(model, params, device)
    runs, walls, grid = {}, {}, None
    for name, policy, train in CO_RUNS:
        tracer = None
        if tracers is not None:
            tracer = Tracer(1 << 18)
            tracers.append(tracer)
        if device.type == "cuda":
            torch.cuda.synchronize()
        if launches is not None:
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        runs[name] = co_run(model, params, device, policy,
                            n_steps if train else 0, co_traces(n_requests),
                            bw, tracer=tracer, lease=lease, grid=grid)
        grid = runs[name]["grid"]
        if device.type == "cuda":
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if launches is not None:
            launches[name] = {"launches": kernels.launch_counts(),
                              "variants": kernels.variant_counts()}
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


def colo_full_width(model, params, device, cpu_refs):
    """fig11's smoke scenario on the card: two tenants' bursts served
    while a data-parallel training job's gradient and offload phases
    share the estate's links, placed hop-only, contention-aware, and
    with no training.  At full width on ``model`` (``SERVE_DEPTH`` layers)
    in bf16, every kernel
    launch counted, the hop-only trace sanitized; on the first
    ``CO_SHALLOW`` layers in fp32 the three runs again, and the racecheck
    in bf16.  The modeled numbers must equal the same scenario's at
    smoke width on the CPU (``cpu_refs``, as phase 6's): to ``CO_REL`` at
    ``model``'s depth, exactly at depth ``CO_SHALLOW``."""
    import torch
    from repro_torch import kernels
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.serve import RequestStatus

    phase_t0 = time.perf_counter()
    # the same scenario at smoke width on the CPU (``cpu_refs``)
    ref = cpu_refs["co"]
    cpu_modeled, cpu_claims, cpu_page, cpu_s = (
        ref["modeled"], ref["claims"], ref["page"], ref["seconds"])

    # full width at model's depth, bf16, every kernel launch counted per run
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
    san = sanitize("colo hop_only (bf16)", tracers[:1])

    # the three runs on the first CO_SHALLOW layers in fp32 (the same
    # weights, upcast exactly, TF32 off): pages of 2^17 B, a power of two
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
    refs = ts_co_refs(runs32, page32)   # phase 13 (g)'s one-card runs
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
        check(v, f"colo: fig11 claim {k} failed on {L} layers in bf16")
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
    return total, total_variants, refs

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


def train_launches(cfg, steps: int, sharded: bool = False) -> dict:
    """Kernel launches of ``steps`` training steps (remat on), forward and
    backward: each rematted layer runs its forward kernels twice (forward
    and recompute) and its backward kernels once.  Every layer is
    rematted but a hybrid's tail Mamba2 layers (the reference's remat is
    its group body).  RMSNorm: two per block (a Mamba2 layer's input and
    gated norms, a transformer block's two) and the final norm, where the
    model has RMSNorm; the SSD scan once per Mamba2 layer.  ``sharded``:
    under a ``model`` axis over 1, where a Mamba2 layer's gated norm runs
    in plain ops with its sum of squares summed over ``model``
    (``models/mamba2.py``): one RMSNorm a Mamba2 layer."""
    L = cfg.n_layers
    A = attention_layers(cfg)
    mamba = L if cfg.family in ("ssm", "hybrid") else 0
    remat_mamba = mamba
    if cfg.family == "hybrid":
        remat_mamba = A * cfg.attn_every        # the groups' layers
    blocks = L + (A if cfg.family == "hybrid" else 0)
    remat_blocks = blocks - (mamba - remat_mamba)
    k = 1 if sharded else 2                     # norms a Mamba2 layer
    norms = (2 * (blocks - mamba) + k * mamba + 1
             if cfg.norm_type == "rmsnorm" else 0)
    remat_norms = (2 * (remat_blocks - remat_mamba) + k * remat_mamba
                   if norms else 0)
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


def train_full_width(arch, device, smi, n_layers=None):
    """10 steps at full width (bf16 compute, fp32 masters, remat on), at
    full depth or on the first ``n_layers``: the loss falls; on step 1
    every parameter leaf has a finite, non-zero gradient
    (``grad_leaves_check``); the launches are exact per step
    (``train_launches``), every forward and backward on the compute
    dtype's variant.  A model other than the dense ones then runs one
    step twice from the same state, required equal in bits (the moe
    dispatch's fixed-order backward, the SSD backward's fixed-order
    sums).  Then 2 more steps plain and 2 profiled give the device's
    busy share.  Returns the run's counts and variants."""
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


def train_cli_refusals_start():
    """Start ``train_cli_refusals``' two ``--smoke`` CLI processes (at
    the start of phase 10, beside its training: they only read the
    config and exit); each one's exit time is kept as it exits."""
    import os
    import threading

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    started = {}
    for arch, reason in (("olmo-1b", "head_dim"),
                         ("mamba2-780m", "P in (32, 64)")):
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
             "--arch", arch, "--steps", "2", "--ckpt-dir", str(CKPT_DIR)],
            cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        done = {}

        def wait(proc=proc, done=done):
            done["stderr"] = proc.communicate(timeout=120)[1]
            done["seconds"] = time.perf_counter() - t0
        thread = threading.Thread(target=wait, daemon=True)
        thread.start()
        started[arch] = (proc, reason, thread, done)
    return started


def train_cli_refusals(started):
    """The training CLI refuses before its loop what no step could do
    (its fault-tolerant loop would retry the step forever): ``--smoke``
    on the card, each in a process of its own (``started``,
    ``train_cli_refusals_start``: exit code 2 and the reason within 30 s
    of its start): olmo-1b's head_dim 16, which the flash backward does
    not take, and mamba2-780m's SSD head_dim P=16, which the SSD kernels
    do not take; and whisper-small, for whose encoder the data pipeline
    yields no ``frame_embeds``."""
    import io

    from repro_torch.launch import train as train_cli_mod

    smoke = {}
    for arch, (proc, reason, thread, done) in started.items():
        thread.join(timeout=150)
        smoke[arch] = (subprocess.CompletedProcess(
            proc.args, proc.returncode, stderr=done.get("stderr", "")),
            done.get("seconds", float("inf")), reason)
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


def train_phase(device, smi):
    """Phase 10: (a) olmo-1b and (c) qwen1.5-0.5b trained at full width,
    (b) the fp32 gate, (b2) the bf16 trajectory, (d) fault tolerance,
    (e) the optimizer offload, (g) the training CLI itself and its
    refusals, (h) olmoe-1b-7b, (i) whisper-small, (j) mamba2-780m and
    (k) zamba2-7b; the report (f) is in each line.  Returns the six
    paths' counts and variants."""
    import torch
    t0 = time.perf_counter()
    counts, variants = {}, {}
    refusals = train_cli_refusals_start()
    for arch in ("olmo-1b", "qwen1.5-0.5b"):
        counts[f"{arch} train"], variants[f"{arch} train"] = \
            train_full_width(arch, device, smi)
        gc.collect()
        torch.cuda.empty_cache()
    for part in (fp32_gate, bf16_trajectory, fault_tolerance, offload_check):
        part(device)
        gc.collect()
        torch.cuda.empty_cache()
    train_cli(device, smi)
    train_cli_refusals(refusals)
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
DP_STEPS = 3                    # (b)'s steps a mode; s/step over 2-3
# (b)'s depth: qwen1.5-0.5b's first 2 of 24 layers (6 until phase 13
# needed the time; 24 until phase 12 took the smoke past 1050 s on an
# H100 80GB HBM3 at 700 W); the collectives move the flat buffer of 2
# layers and the table (1.86 GB at full depth); auto's losses are held
# to the one-process step's on the same cut, run by rank 0
DP_DEPTH = 2
DP_MODES = {"auto": ("auto", False), "hierarchical": ("hierarchical", False),
            "compress_pod": ("hierarchical", True)}
DP_DIR = Path(__file__).resolve().parent / "build" / "phase11"
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


def dp_part(grid, t0: float) -> dict:
    """Phase 11 in a rank of phase 12's world, on ``grid`` (``DP_LAYOUT``,
    the grid that started the world at ``t0``): the probe, (a), (b) and
    (c); its report."""
    import torch
    rank = grid.rank
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
    return report


def wait_world(procs, limit_s: float, what: str, tick=None) -> float:
    """Wait for every process, calling ``tick()`` (if given) as it polls;
    a non-zero exit or the limit kills the rest and fails the run.
    Returns the seconds taken."""
    t0 = time.perf_counter()
    while any(p.is_alive() for p in procs):
        if tick is not None:
            tick()
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


def dp_cli_start():
    """(d) the training CLI under ``torch.distributed.run`` on 4 ranks:
    qwen1.5-0.5b at full width on its first ``TRAIN_CUT`` layers
    (``--layers``), the lease's (2, 2, 1) layout, ``hierarchical`` with
    ``compress_pod``, 3 steps of 8 x ``CLI_SEQ``; its output in files.
    Started once phase 12 (d)'s two CLI worlds have exited
    (``tp_cli_start``); returns ``torchrun_start``'s (process, wait)."""
    argv = ["-m", "repro_torch.launch.train",
            "--arch", "qwen1.5-0.5b", "--layers", str(TRAIN_CUT),
            "--dp-mode", "hierarchical",
            "--compress-pod", "--pool", "scalepool", "--pool-accels", "12",
            "--steps", "3", "--batch", str(TRAIN_BATCH), "--seq",
            str(CLI_SEQ), "--ckpt-dir", str(DP_DIR / "ckpt")]
    return torchrun_start(argv, DP_DIR, "cli", DP_CLI_LIMIT_S,
                          "phase 11 (d)")


def cli_error(err: str) -> str:
    """A failed CLI world's stderr from its first traceback (a rank's,
    ahead of ``torch.distributed.run``'s report), its head and the
    exception that ends it, else the stderr's end."""
    at = err.find("Traceback")
    if at < 0:
        return err[-2000:]
    import re
    lines = err[at:].splitlines()
    end = next((i for i, line in enumerate(lines[1:], 1)
                if not re.sub(r"^\[rank\d+\]: ?", "", line).startswith(
                    (" ", "\t"))), len(lines) - 1)
    if end < 16:
        return "\n".join(lines[:end + 1])
    return "\n".join(lines[:12] + ["..."] + lines[end - 3:end + 1])


def dp_cli_checks(smi, wait):
    """(d)'s line and checks once its world ends."""
    rc, summary, err, secs = wait()
    emit({"phase": "dp", "check": "(d) CLI", "nvidia_smi": smi, "rc": rc,
          "seconds": secs, "cli": summary,
          "started_after": "phase 12 (d)'s two CLI worlds",
          "stderr_tail": err.strip().splitlines()[-6:]})
    check(rc == 0, f"phase 11 (d): rc {rc}: {cli_error(err)}")
    check(summary["mesh"] == {"pod": 2, "data": 2, "model": 1}
          and summary["dp_mode"] == "hierarchical"
          and summary["backend"] == "gloo" and summary["compress_pod"]
          and summary["world"] == 4
          and summary["device"].startswith("cuda"),
          f"phase 11 (d): summary {summary}")


def dp_checks(smi, reports):
    """Phase 11 (a)-(c)'s lines and checks from each rank's ``dp_part``
    report (phase 12's world ran them on its first grid); (d), the CLI,
    runs with phase 12 (d)'s (``tp_cli``).  Returns each rank's (b)
    launches, all three modes together."""
    import torch

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
    emit({"phase": "dp", "rank_seconds": [r["seconds"] for r in reports]})
    return counts


# ---------------------------------------------------------------------------
# phase 12: tensor parallelism and FSDP: qwen1.5-0.5b on (data 2, model 2)
# with FSDP off and on and on (pod 2, data 1, model 2) with the compressed
# cross-pod phase, 4 ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# the world's grids, in turn -> (layout, [(case, dp_mode, compress_pod,
# fsdp)]); phase 13 then serves on (data 1, model 4) in the same world
TP_GRIDS = {
    "2x2": (((2, 2), ("data", "model")),
            [("tp", "auto", False, False), ("tp_fsdp", "auto", False, True)]),
    "2x1x2": (((2, 1, 2), ("pod", "data", "model")),
              [("pod_compress", "hierarchical", True, False)]),
}
TP_GATE_STEPS = 2               # (a)'s steps
TP_STEPS = 3                    # (b)'s steps a case; s/step over 2-3
TP_DIR = Path(__file__).resolve().parent / "build" / "phase12"
TP_WORLD_LIMIT_S = 780.0        # the world's wall-clock limit (phase 11
                                # (a)-(c), phase 12 (a)-(c) on both grids,
                                # (e), (f), then phase 13)
TP_CLI_LIMIT_S = 240.0          # each of (d)'s torch.distributed.run
TP_FAIL_AT = 2                  # (d)'s injected failure: rank 1, step 2
TP_CLI_GO = "cli_go"            # rank 0's file: (e), (i) done, (d) may start
TP_WORLD_GO = "world_go"        # tp_phase's file: the spawned ranks begin
TP_WAIT_LIMIT_S = 1200.0        # a spawned rank waits this long for it
CLI_NICE = 19                   # the CLI worlds' niceness (torchrun_start)
CLI_SEQ = 128                   # the CLI worlds' sequence (8 x 128 a step):
                                # their 12 ranks held ~74 GB of an H100
                                # 80GB at 8 x 512, and beside phase 13's
                                # world one ran out of memory
TP_CLI_WRAPPER = """
import os, sys
from repro_torch.launch.train import main

def hook(step):
    if (os.environ["TORCHELASTIC_RESTART_COUNT"] == "0"
            and os.environ["RANK"] == "1" and step == {fail_at}):
        raise RuntimeError("injected failure on rank 1 at step {fail_at}")

raise SystemExit(main(sys.argv[1:], failure_hook=hook))
"""


# (e): expert parallelism in training on the world's (data 2, model 2)
# grid, olmoe-1b-7b at full width on its first ``EP_DEPTH`` layers (64
# experts, 32 a rank over model): the fp32 gate of both cases, then a
# timed bf16 run of ``tp``
EP_ARCH = "olmoe-1b-7b"
EP_GRID = "2x2"
EP_DEPTH = 1
EP_GATE_STEPS = 2
EP_STEPS = 3                    # s/step over 2-3


# (f): the ssm and hybrid families in training on the world's (data 2,
# model 2) grid, the mamba2 block's SSD heads over model: mamba2-780m on
# its first 2 of 48 layers (24 of 48 heads a rank) FSDP off and on,
# zamba2-7b on its first ZAMBA2_GATE_DEPTH of 81 (one group, the shared
# block's 16 of 32 heads and 56 of 112 SSD heads a rank, and a tail
# layer) FSDP off; the fp32 gate against one card, then timed bf16 steps
# of tp beside one card's losses on the same cut (zamba2 at TRAJ_LR)
SSM_TRAIN = (("mamba2-780m", TRAIN_CUT, ("tp", "tp_fsdp")),
             ("zamba2-7b", ZAMBA2_GATE_DEPTH, ("tp",)))
SSM_GATE_STEPS = 2              # (f)'s and (g)'s
SSM_STEPS = 3                   # s/step over 2-3

# (g): the encdec family in training on the world's (data 2, model 2)
# grid: whisper-small at full width on the first 2 layers of each stack
# (6 of its 12 heads a rank; phase 10 (i)'s frames, B=8 x 448 decoder
# tokens x 1500 frames) FSDP off and on: the fp32 gate against one card,
# then timed bf16 steps of tp beside one card's losses on the same cut
ENCDEC_TRAIN = (("whisper-small", TRAIN_CUT, ("tp", "tp_fsdp")),)


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


def tp_fp32_gate(grid, cases, arch="qwen1.5-0.5b", layers=TRAIN_CUT,
                 steps=TP_GATE_STEPS, lr=None):
    """(a) ``arch`` (qwen1.5-0.5b; (e): olmoe-1b-7b; (f): mamba2-780m,
    zamba2-7b; (g): whisper-small) at full width on its first ``layers``
    layers in fp32 (TF32 off), global B=8 x S=512 (whisper: 448 decoder
    tokens and phase 10 (i)'s frames), ``steps`` steps of each case from the same
    draw (AdamW at ``lr``, default the CLI's), the parameters gathered
    from the ranks; rank 0 holds them, the losses and grad norms against
    the one-process step (for ``compress_pod``,
    ``tp_plain_compressed_steps``)."""
    import torch
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import train as train_rt
    from repro_torch.sharding import partition
    from repro_torch.sharding.profiles import make_rules
    from repro_torch.tree import tree_map

    cfg = cut(arch, layers, compute_dtype="float32")
    model, opt, one_step, pipe = train_parts(cfg, grid.device, lr)
    shape = ShapeConfig("smoke", "train", train_seq(cfg), TRAIN_BATCH)
    params = model.init(torch.Generator(device=grid.device).manual_seed(1))
    batches = train_batches(cfg, pipe, steps, grid.device)
    out, plain = {}, None
    for name, mode, compress, fsdp in cases:
        t0 = time.perf_counter()
        tcfg = train_rt.TrainStepConfig(dp_mode=mode, compress_pod=compress)
        rules = make_rules(cfg, shape, grid, fsdp=fsdp, dp_mode=mode)
        step = train_rt.make_train_step(model, opt, shape, mesh=grid,
                                        rules=rules, tcfg=tcfg)
        state = train_rt.state_from_params(
            tree_map(torch.clone, params), opt, tcfg, mesh=grid,
            rules=rules, axes=model.param_axes())
        metrics = []
        t1 = time.perf_counter()
        for b in batches:
            state, m = step(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        t2 = time.perf_counter()
        blocks = partition.tree_shardings(grid, rules, model.param_axes())
        full = tree_map(lambda t, b: partition.gather_leaf(t, b, grid),
                        state.params, blocks)
        del state, step
        seconds = {"setup": t1 - t0, "steps": t2 - t1,
                   "gather": time.perf_counter() - t2}
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
                                  steps)}
            del want
        else:
            out[name] = {"metrics": metrics}
        out[name]["seconds"] = {**seconds, "one_card_and_compare":
                                time.perf_counter() - t0 - sum(
                                    seconds.values())}
        del full
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_full_depth(grid, cases, arch="qwen1.5-0.5b", layers=TP_DEPTH,
                  steps=TP_STEPS, lr=None):
    """(b) ``arch`` (qwen1.5-0.5b; (e): olmoe-1b-7b; (f): mamba2-780m,
    zamba2-7b; (g): whisper-small) at full width on its first ``layers``
    layers, bf16 compute, AdamW at ``lr`` (default the CLI's), the global 8 x 512
    (phase 10 (c)'s weights, seed 0, and batches), ``steps`` steps of
    each case:
    losses, seconds a step, host seconds in collectives and the byte
    counter by (axes, op) a step, the peak of device memory, the
    kernels' launches and variants (one card's losses on the same cut,
    weights and batches: ``tp_reference_losses``, run by the parent)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime import train as train_rt
    from repro_torch.sharding.profiles import describe, make_rules

    cfg = cut(arch, layers)
    model, opt, one_step, pipe = train_parts(cfg, grid.device, lr)
    shape = ShapeConfig("smoke", "train", train_seq(cfg), TRAIN_BATCH)
    batches = train_batches(cfg, pipe, steps, grid.device)
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


# the one-card bf16 trajectories that (b), (e), (f) and (g) are held
# to: (arch, layers, steps), each at TRAJ_LR where it has one
TP_ONE_CARD = (("qwen1.5-0.5b", TP_DEPTH, TP_STEPS),
               (EP_ARCH, EP_DEPTH, EP_STEPS),
               ("mamba2-780m", TRAIN_CUT, SSM_STEPS),
               ("zamba2-7b", ZAMBA2_GATE_DEPTH, SSM_STEPS),
               ("whisper-small", TRAIN_CUT, SSM_STEPS))


def tp_reference_losses(device, arch="qwen1.5-0.5b", layers=TP_DEPTH,
                        steps=TP_STEPS):
    """A one-card bf16 reference of (b), (e), (f) or (g): phase 10 (c)'s run
    (the weights of seed 0, its batches) of ``arch`` on its first
    ``layers`` layers at ``TRAJ_LR`` where it has one, ``steps`` steps'
    losses: ``tp_full_depth``'s cut, weights and batches."""
    import torch
    from repro_torch.runtime import train as train_rt

    cfg = cut(arch, layers)
    model, opt, step, pipe = train_parts(cfg, device, TRAJ_LR.get(arch))
    state = train_rt.init_state(
        model, opt, torch.Generator(device=device).manual_seed(0))
    losses = []
    for b in train_batches(cfg, pipe, steps, device):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses


def tp_one_card(device) -> dict:
    """{arch: ``tp_reference_losses``} of every ``TP_ONE_CARD`` entry."""
    import torch
    out = {}
    for arch, layers, steps in TP_ONE_CARD:
        out[arch] = tp_reference_losses(device, arch, layers, steps)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_rank(rank: int, init: str, out_dir: str) -> None:
    """One rank of phase 12's world (a spawned process; any failure exits
    it non-zero): phase 11 (a)-(c) on ``DP_LAYOUT``'s grid, which starts
    the world; on each of ``TP_GRIDS`` in turn (their groups formed in
    that world) (a), (b) and, with FSDP, (c); (e) and (f) on (data 2,
    model 2), and (g) there; then phase 13; its report to
    ``<out_dir>/rank<r>.json``."""
    import torch
    import repro_torch.runtime.serve  # noqa: F401  (imported while waiting)
    import repro_torch.runtime.train  # noqa: F401
    import repro_torch.serve  # noqa: F401
    from repro_torch.launch import mesh as mesh_lib

    # spawned while the card runs phases 4-10 (``tp_world_start``): the
    # imports above are done by then, and the card untouched until
    # ``tp_phase``'s go
    go, t_wait = Path(out_dir, TP_WORLD_GO), time.perf_counter()
    while not go.exists():
        if time.perf_counter() - t_wait > TP_WAIT_LIMIT_S:
            raise SystemExit(3)
        time.sleep(0.2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one intra-op thread a rank, as torch.distributed.run sets each
    # worker: four ranks' thread pools would contend for the host's cores
    torch.set_num_threads(1)
    t_world = time.perf_counter()
    report = {"rank": rank, "grids": {}}
    world = mesh_lib.init_grid(mesh_lib.Layout(*DP_LAYOUT), rank=rank,
                               device=torch.device("cuda", 0),
                               init_method=init,
                               timeout_s=DP_COLLECTIVE_LIMIT_S)
    report["dp"] = dp_part(world, t_world)
    gc.collect()
    torch.cuda.empty_cache()
    ep_grid = None
    for name, (layout, cases) in TP_GRIDS.items():
        t0 = time.perf_counter()
        grid = mesh_lib.init_grid(mesh_lib.Layout(*layout), rank=rank,
                                  device=torch.device("cuda", 0),
                                  init_method=init,
                                  timeout_s=DP_COLLECTIVE_LIMIT_S)
        r = {"grid": grid.describe()}
        t1 = time.perf_counter()
        r["fp32_gate"] = tp_fp32_gate(grid, cases)
        dp_progress(rank, f"{name} (a)", t_world, r["fp32_gate"], phase=12)
        gc.collect()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        r["full_depth"] = tp_full_depth(grid, cases)
        t3 = time.perf_counter()
        if any(fsdp for *_, fsdp in cases):
            r["twice"] = tp_twice(grid)
            dp_progress(rank, f"{name} (c)", t_world, r["twice"], phase=12)
        r["seconds"] = {"setup": t1 - t0, "fp32_gate": t2 - t1,
                        "full_depth": t3 - t2,
                        "twice": time.perf_counter() - t3}
        report["grids"][name] = r
        if name == EP_GRID:
            ep_grid = grid
        else:
            grid.close()
        gc.collect()
        torch.cuda.empty_cache()
    report["ep"] = ep_rank(ep_grid)
    gc.collect()
    torch.cuda.empty_cache()
    report["ssm"] = family_rank(ep_grid, SSM_TRAIN, "(f)")
    gc.collect()
    torch.cuda.empty_cache()
    report["encdec"] = family_rank(ep_grid, ENCDEC_TRAIN, "(g)")
    ep_grid.close()
    gc.collect()
    torch.cuda.empty_cache()
    # phase 13 (i) and (j) first: their fp32 draws of olmoe's and
    # zamba2's layers are the world's largest, and (d)'s CLI worlds, which
    # hold tens of GB of the card, start once they are freed
    moe = ts_moe(rank, torch.device("cuda", 0))
    gc.collect()
    torch.cuda.empty_cache()
    ssm = ts_fixed_batch(rank, torch.device("cuda", 0), TS_SSM, "(j)")
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:               # (d)'s CLI worlds may start beside ours
        Path(out_dir, TP_CLI_GO).write_text("")
    # (k)'s whisper cut is small beside the CLI worlds
    encdec = ts_fixed_batch(rank, torch.device("cuda", 0), TS_ENCDEC, "(k)",
                            TS_ENCDEC_PROMPT)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs = Path(out_dir, TS_REFS)
    report["serve"] = ts_rank(rank, json.loads(refs.read_text())
                              if refs.exists() else None)
    report["serve"].update(moe=moe, ssm=ssm, encdec=encdec)
    report["serve"]["seconds"] = time.perf_counter() - t0
    world.close()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))


def ep_rank(grid) -> dict:
    """(e) on ``grid`` (the world's (data 2, model 2)): olmoe-1b-7b at
    full width on its first ``EP_DEPTH`` layers, the fp32 gate of ``tp``
    and ``tp_fsdp`` (``EP_GATE_STEPS`` steps each against one card),
    then ``EP_STEPS`` timed bf16 steps of ``tp`` beside one card's
    losses on the same cut."""
    t0 = time.perf_counter()
    cases = TP_GRIDS[EP_GRID][1]
    out = {"fp32_gate": tp_fp32_gate(grid, cases, EP_ARCH, EP_DEPTH,
                                     EP_GATE_STEPS)}
    dp_progress(grid.rank, "(e) fp32 gate", t0, out["fp32_gate"], phase=12)
    t1 = time.perf_counter()
    out["full_depth"] = tp_full_depth(grid, cases[:1], EP_ARCH, EP_DEPTH,
                                      EP_STEPS)
    out["seconds"] = {"fp32_gate": t1 - t0,
                      "bf16": time.perf_counter() - t1}
    return out


def ep_checks(smi, reports, one_card) -> dict:
    """(e)'s lines and checks (``one_card``: ``tp_one_card``'s); returns
    each rank's launches."""
    cfg = cut(EP_ARCH, EP_DEPTH)
    per = [r["ep"] for r in reports]
    gate = per[0]["fp32_gate"]
    emit({"phase": "tp", "check": "(e) expert parallel fp32 gate",
          "arch": cfg.name, "layers": EP_DEPTH, "experts": cfg.n_experts,
          "experts_a_rank": cfg.n_experts // 2,
          "layout": reports[0]["grids"][EP_GRID]["grid"]["mesh"],
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": EP_GATE_STEPS,
          "tol": TOL["float32"], "param_share_allowed": DP_PARAM_SHARE,
          "rank0": gate})
    check(all(g["ok"] for g in gate.values())
          and all(p["fp32_gate"][c]["metrics"] == gate[c]["metrics"]
                  for p in per for c in gate),
          f"phase 12 (e) fp32 gate: {gate}")
    want = train_launches(cfg, EP_STEPS)
    counts = {}
    for name, *_ in TP_GRIDS[EP_GRID][1][:1]:
        full = [p["full_depth"][name] for p in per]
        losses = full[0]["losses"]
        ref = one_card[EP_ARCH]
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        emit({"phase": "tp", "check": f"(e) expert parallel bf16 {name}",
              "nvidia_smi": smi, "arch": cfg.name, "layers": EP_DEPTH,
              "layout": reports[0]["grids"][EP_GRID]["grid"]["mesh"],
              "ranks": "4 ranks sharing one card (gloo, host-staged)",
              "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
              "steps": EP_STEPS, "one_card_losses": ref, "rel_gaps": gaps,
              "tol": BF16_TRAJ_TOL, "per_rank": full})
        check(all(f["losses"] == losses for f in full)
              and all(math.isfinite(x) for x in losses)
              and all(g <= BF16_TRAJ_TOL for g in gaps),
              f"phase 12 (e) {name}: losses {[f['losses'] for f in full]} "
              f"against one card's {ref}")
        for r, f in enumerate(full):
            calls = f["calls_per_step"]
            check(f["launches"] == want
                  and calls.get("data:all-gather:moe-experts", 0) > 0
                  and calls.get("model:all-reduce:moe", 0) > 0,
                  f"phase 12 (e) {name} rank {r}: launches {f['launches']} "
                  f"!= {want}, or no moe collective in {calls}")
            check_flash_variant(f"phase 12 (e) rank {r}", cfg.compute_dtype,
                                f["variants"], want["flash_attention"])
            check_backward_variant(f"phase 12 (e) rank {r}",
                                   cfg.compute_dtype, f["variants"],
                                   want["flash_attention_bwd"])
            counts[f"olmoe-1b-7b ep rank {r}"] = dict(f["launches"])
    emit({"phase": "tp", "check": "(e) seconds",
          "per_rank": [p["seconds"] for p in per]})
    return counts


def family_rank(grid, entries, tag) -> dict:
    """(f) or (g) (``tag``) on ``grid`` (the world's (data 2, model 2)):
    each of ``entries`` (``SSM_TRAIN``, ``ENCDEC_TRAIN``) at full width on
    its cut, the fp32 gate of its cases (``SSM_GATE_STEPS`` steps each
    against one card), then ``SSM_STEPS`` timed bf16 steps of ``tp``
    beside one card's losses on the same cut."""
    import torch
    out = {}
    for arch, layers, names in entries:
        t0 = time.perf_counter()
        cases = [c for c in TP_GRIDS[EP_GRID][1] if c[0] in names]
        lr = TRAJ_LR.get(arch)
        r = {"fp32_gate": tp_fp32_gate(grid, cases, arch, layers,
                                       SSM_GATE_STEPS, lr)}
        dp_progress(grid.rank, f"{tag} {arch} fp32 gate", t0,
                    r["fp32_gate"], phase=12)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        r["full_depth"] = tp_full_depth(grid, cases[:1], arch, layers,
                                        SSM_STEPS, lr=lr)
        r["seconds"] = {"fp32_gate": t1 - t0,
                        "bf16": time.perf_counter() - t1}
        out[arch] = r
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ssm_checks(smi, reports, one_card) -> dict:
    """(f)'s lines and checks (``one_card``: ``tp_one_card``'s); returns
    each rank's launches."""
    counts = {}
    mesh = reports[0]["grids"][EP_GRID]["grid"]["mesh"]
    for arch, layers, names in SSM_TRAIN:
        cfg = cut(arch, layers)
        per = [r["ssm"][arch] for r in reports]
        gate = per[0]["fp32_gate"]
        emit({"phase": "tp", "check": "(f) ssm_* rules fp32 gate",
              "arch": cfg.name, "layers": layers, "layout": mesh,
              "ssd_heads_a_rank": cfg.ssm_heads // 2,
              "lr": TRAJ_LR.get(arch, "the CLI's"),
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "steps": SSM_GATE_STEPS, "tol": TOL["float32"],
              "param_share_allowed": DP_PARAM_SHARE, "rank0": gate})
        check(all(g["ok"] for g in gate.values())
              and all(p["fp32_gate"][c]["metrics"] == gate[c]["metrics"]
                      for p in per for c in gate),
              f"phase 12 (f) {arch} fp32 gate: {gate}")
        want = train_launches(cfg, SSM_STEPS, sharded=True)
        full = [p["full_depth"]["tp"] for p in per]
        losses = full[0]["losses"]
        ref = one_card[arch]
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        emit({"phase": "tp", "check": "(f) ssm_* rules bf16 tp",
              "nvidia_smi": smi, "arch": cfg.name, "layers": layers,
              "layout": mesh,
              "ranks": "4 ranks sharing one card (gloo, host-staged)",
              "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
              "steps": SSM_STEPS, "lr": TRAJ_LR.get(arch, "the CLI's"),
              "one_card_losses": ref, "rel_gaps": gaps,
              "tol": BF16_TRAJ_TOL, "per_rank": full})
        check(all(f["losses"] == losses for f in full)
              and all(math.isfinite(x) for x in losses)
              and all(g <= BF16_TRAJ_TOL for g in gaps),
              f"phase 12 (f) {arch}: losses {[f['losses'] for f in full]} "
              f"against one card's {ref}")
        for r, f in enumerate(full):
            calls = f["calls_per_step"]
            check(f["launches"] == want
                  and all(calls.get(k, 0) > 0 for k in (
                      "model:all-gather:ssm", "model:reduce-scatter:ssm",
                      "model:all-reduce:ssm", "model:all-reduce:ssm-norm")),
                  f"phase 12 (f) {arch} rank {r}: launches {f['launches']} "
                  f"!= {want}, or no ssm collective in {calls}")
            check_ssd_variant(f"phase 12 (f) {arch} rank {r}",
                              cfg.compute_dtype, f["variants"],
                              want["ssd_scan"])
            check_backward_variant(f"phase 12 (f) {arch} rank {r}",
                                   cfg.compute_dtype, f["variants"],
                                   want["ssd_scan_bwd"], "ssd_scan_bwd")
            check_flash_variant(f"phase 12 (f) {arch} rank {r}",
                                cfg.compute_dtype, f["variants"],
                                want["flash_attention"])
            check_backward_variant(f"phase 12 (f) {arch} rank {r}",
                                   cfg.compute_dtype, f["variants"],
                                   want["flash_attention_bwd"])
            counts[f"{arch} ssm tp rank {r}"] = dict(f["launches"])
        emit({"phase": "tp", "check": f"(f) {arch} seconds",
              "per_rank": [p["seconds"] for p in per]})
    return counts


def encdec_checks(smi, reports, one_card) -> dict:
    """(g)'s lines and checks (``one_card``: ``tp_one_card``'s): the fp32
    gates, the bf16 ``tp`` steps against one card's losses, each rank's
    launches (B3 forward and recompute, B5 on the tensor cores, no
    RMSNorm: LayerNorm is no kernel), one ``cross`` all-reduce a step
    (the encoder states' gradient, summed over ``model`` once for every
    decoder layer's cross K/V), and the share of a step in collectives;
    returns each rank's launches."""
    counts = {}
    mesh = reports[0]["grids"][EP_GRID]["grid"]["mesh"]
    for arch, layers, names in ENCDEC_TRAIN:
        cfg = cut(arch, layers)
        per = [r["encdec"][arch] for r in reports]
        gate = per[0]["fp32_gate"]
        emit({"phase": "tp", "check": "(g) encdec fp32 gate",
              "arch": cfg.name, "layers": layers, "layout": mesh,
              "heads_a_rank": cfg.n_heads // 2, "batch": TRAIN_BATCH,
              "seq": train_seq(cfg), "frames": cfg.enc_seq,
              "steps": SSM_GATE_STEPS, "tol": TOL["float32"],
              "param_share_allowed": DP_PARAM_SHARE, "rank0": gate})
        check(all(g["ok"] for g in gate.values())
              and all(p["fp32_gate"][c]["metrics"] == gate[c]["metrics"]
                      for p in per for c in gate),
              f"phase 12 (g) {arch} fp32 gate: {gate}")
        want = train_launches(cfg, SSM_STEPS, sharded=True)
        full = [p["full_depth"]["tp"] for p in per]
        losses = full[0]["losses"]
        ref = one_card[arch]
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        emit({"phase": "tp", "check": "(g) encdec bf16 tp",
              "nvidia_smi": smi, "arch": cfg.name, "layers": layers,
              "layout": mesh,
              "ranks": "4 ranks sharing one card (gloo, host-staged)",
              "seq": train_seq(cfg), "frames": cfg.enc_seq,
              "global_batch": TRAIN_BATCH, "steps": SSM_STEPS,
              "one_card_losses": ref, "rel_gaps": gaps,
              "tol": BF16_TRAJ_TOL, "per_rank": full})
        check(all(f["losses"] == losses for f in full)
              and all(math.isfinite(x) for x in losses)
              and all(g <= BF16_TRAJ_TOL for g in gaps),
              f"phase 12 (g) {arch}: losses {[f['losses'] for f in full]} "
              f"against one card's {ref}")
        cross = "model:all-reduce:cross"
        for r, f in enumerate(full):
            calls = f["calls_per_step"]
            check(f["launches"] == want and calls.get(cross) == 1,
                  f"phase 12 (g) {arch} rank {r}: launches {f['launches']} "
                  f"!= {want}, or not one {cross} a step in {calls}")
            check_flash_variant(f"phase 12 (g) {arch} rank {r}",
                                cfg.compute_dtype, f["variants"],
                                want["flash_attention"])
            check_backward_variant(f"phase 12 (g) {arch} rank {r}",
                                   cfg.compute_dtype, f["variants"],
                                   want["flash_attention_bwd"])
            counts[f"{arch} encdec tp rank {r}"] = dict(f["launches"])
        emit({"phase": "tp", "check": "(g) cross", "arch": cfg.name,
              "what": "the encoder states' gradient summed over model, "
                      "once a step for every decoder layer's cross K/V",
              "per_rank": [{
                  "s_per_step": f["s_per_step"],
                  "collective_share": f["collective_host_s_per_step"]
                  / f["s_per_step"],
                  "cross_host_s": f["collective_host_s_by_op"].get(cross),
                  "cross_share": f["collective_host_s_by_op"].get(cross, 0)
                  / f["s_per_step"],
                  "cross_bytes": f["moved_bytes_per_step"].get(cross),
                  "cross_calls": f["calls_per_step"].get(cross)}
                  for f in full]})
        emit({"phase": "tp", "check": f"(g) {arch} seconds",
              "per_rank": [p["seconds"] for p in per]})
    return counts


def torchrun_start(argv, out_dir, name, limit_s, what):
    """Start ``argv`` under ``torch.distributed.run`` on 4 ranks, its
    output in ``<out_dir>/<name>.out`` and ``.err``, at ``CLI_NICE``: the
    CLI worlds run beside phase 13's world on the host's cores, whose
    ranks wait on each other's collectives, so the world's ranks go
    first and the CLIs take the cores they leave.  Returns the process
    and a function that waits for it (its whole process tree killed past
    ``limit_s`` from its start) and gives (rc, summary or None, stderr,
    seconds)."""
    import os
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4"] + argv
    t0 = time.perf_counter()
    out_path, err_path = out_dir / f"{name}.out", out_dir / f"{name}.err"
    with open(out_path, "w") as fo, open(err_path, "w") as fe, \
            dp_allocator_env():
        proc = subprocess.Popen(cmd, cwd=root, env={
            **os.environ, "PYTHONPATH": str(root / "src")},
            stdout=fo, stderr=fe, text=True,
            preexec_fn=lambda: os.nice(CLI_NICE))

    def wait():
        try:
            proc.wait(timeout=max(1.0, limit_s
                                  - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            kill_tree(proc.pid)
            proc.wait(timeout=60)
            check(False, f"{what} {name}: the CLI overran {limit_s} s: "
                  f"{err_path.read_text()[-2000:]}")
        secs = time.perf_counter() - t0
        out, err = out_path.read_text(), err_path.read_text()
        summary = json.loads(out) if proc.returncode == 0 else None
        return proc.returncode, summary, err, secs
    return proc, wait


def tp_torchrun(argv, name):
    """``torchrun_start`` of a phase 12 (d) world."""
    return torchrun_start(argv, TP_DIR, name, TP_CLI_LIMIT_S, "phase 12 (d)")


def tp_step_losses(err):
    """[(step, loss)] of rank 0's per-step lines on the CLI's stderr."""
    out = []
    for line in err.splitlines():
        if line.startswith('{"step"'):
            d = json.loads(line)
            out.append((d["step"], d["loss"]))
    return out


def tp_cli_start():
    """(d) the training CLI under ``torch.distributed.run`` on 4 ranks
    with no ``--pool``: qwen1.5-0.5b at full width on its first
    ``TRAIN_CUT`` layers (``--layers``) on the reference's smoke mesh
    (data 2, model 2), tensor parallel, 3 steps of 8 x ``CLI_SEQ``; beside
    it the
    same under ``--max-restarts 1`` through a wrapper (under the ignored
    ``build/``) whose failure hook raises on rank 1 at step
    ``TP_FAIL_AT`` of the first attempt, with ``--ckpt-every 1``: exit 0,
    the resume reported, every step's loss (the first attempt's and the
    replayed ones) equal in bits to the first run's.  The two worlds
    start at once, while phase 12's world serves phase 13 (the ranks'
    (e), (i) and (j) done, ``TP_CLI_GO``), and phase 11 (d)'s
    (``dp_cli_start``) once both have exited: the three at once held
    ~67 GB of an H100 80GB's 79 at 8 x 128 tokens a step, and beside the
    serving world one ran out of memory.  Their
    seconds are start-up under each other's load and the world's.
    Returns the two (process, wait)."""
    base = ["--arch", "qwen1.5-0.5b", "--layers", str(TRAIN_CUT),
            "--steps", "3", "--batch",
            str(TRAIN_BATCH), "--seq", str(CLI_SEQ), "--log-every", "1"]
    wrapper = TP_DIR / "restart_wrapper.py"
    wrapper.write_text(TP_CLI_WRAPPER.format(fail_at=TP_FAIL_AT))
    return [tp_torchrun(
        ["-m", "repro_torch.launch.train"] + base
        + ["--ckpt-dir", str(TP_DIR / "ckpt_plain")], "cli"),
        tp_torchrun(
        ["--max-restarts", "1", str(wrapper)] + base
        + ["--ckpt-every", "1", "--ckpt-dir", str(TP_DIR / "ckpt_restart")],
        "cli_restart")]


def tp_cli_checks(smi, plain_wait, restart_wait):
    """(d)'s lines and checks, each world's as it ends."""
    rc, plain, err, secs = plain_wait()
    emit({"phase": "tp", "check": "(d) CLI", "nvidia_smi": smi, "rc": rc,
          "layers": TRAIN_CUT, "seconds": secs, "cli": plain,
          "stderr_tail": err.strip().splitlines()[-6:]})
    check(rc == 0, f"phase 12 (d): rc {rc}: {cli_error(err)}")
    check(plain["mesh"] == {"data": 2, "model": 2}
          and plain["dp_mode"] == "auto" and plain["backend"] == "gloo"
          and plain["world"] == 4 and "heads=model" in plain["rules"]
          and plain["device"].startswith("cuda")
          and plain["resumed_from"] is None,
          f"phase 12 (d): summary {plain}")
    want = dict(tp_step_losses(err))
    rc, summary, err, secs = restart_wait()
    got = tp_step_losses(err)
    same = [(s, x, want.get(s)) for s, x in got]
    emit({"phase": "tp", "check": "(d) CLI world restart", "nvidia_smi": smi,
          "rc": rc, "layers": TRAIN_CUT, "seconds": secs, "cli": summary,
          "steps_and_losses_against_the_first_run": same,
          "stderr_tail": err.strip().splitlines()[-6:]})
    check(rc == 0, f"phase 12 (d) restart: rc {rc}: {cli_error(err)}")
    check(f"injected failure on rank 1 at step {TP_FAIL_AT}" in err
          and summary["restarts"] == 1
          and summary["resumed_from"] in (TP_FAIL_AT - 1, TP_FAIL_AT)
          and [s for s, _ in got[:TP_FAIL_AT]] == list(
              range(1, TP_FAIL_AT + 1))
          and [s for s, _ in got[TP_FAIL_AT:]] == list(
              range(summary["resumed_from"] + 1, 4))
          and all(x == w for _, x, w in same),
          f"phase 12 (d) restart: {summary}, losses {same}")


def tp_world_start():
    """Spawn the 4 ranks of phases 11-13's world (``tp_rank``): each
    imports, then waits for ``tp_phase``'s go file before it touches
    the card.  Returns the processes."""
    import multiprocessing
    import shutil
    for d in (DP_DIR, TP_DIR):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    store = TP_DIR / "store"
    procs = [ctx.Process(target=tp_rank, args=(
        r, f"file://{store}", str(TP_DIR))) for r in range(4)]
    with dp_allocator_env():
        for p in procs:
            p.start()
    return procs


def tp_phase(smi, qwen_run, serve_refs, procs):
    """Phases 11, 12 and 13: one world of 4 ranks sharing the card (the
    kernels built by this process before): phase 11 (a)-(c) on its grid
    (``dp_part``), then each of ``TP_GRIDS`` in turn, then (e)
    (``ep_rank``), (f) and (g) (``family_rank``), 13 (i) (``ts_moe``),
    (j) and (k) (``ts_fixed_batch``), then the rest of serving
    (``ts_rank``), beside which phase 12 (d)'s two CLI worlds run,
    started once the ranks' (j) is done (``tp_cli_start``), and phase 11
    (d)'s once they have exited.  (b)'s, (e)'s, (f)'s and (g)'s
    trajectories are held to one card's of the same cut
    (``tp_one_card``, run by this process while the world runs phase 11:
    the ranks do not read it), the compressed one to the
    plain in-process evaluation of the same schedule
    (``tp_plain_compressed_steps``, rank 0): int8 codes change the gradient, so a compressed trajectory
    leaves the uncompressed one by more than the bf16 bound (phase 11's
    own by 4.6% at step 4 of its full-depth run on an H100).  Phase 13
    (b)'s bf16 tokens are reported beside one card's on the same cut
    (``qwen_run``, ``ts_one_card_run``, beside (h)'s bf16 run), and (f)
    and (g) held to one card's runs of phases 7 and 8 (``serve_refs``,
    written for the ranks before the world starts).
    ``procs``: the world's ranks (``tp_world_start``), started by this
    function's go file.  Returns each rank's (b) launches, its cases
    together, and phase 13 (b)'s."""
    import torch

    t_start = time.perf_counter()
    (TP_DIR / TS_REFS).write_text(json.dumps(serve_refs))
    counts = {}
    gc.collect()
    torch.cuda.empty_cache()
    (TP_DIR / TP_WORLD_GO).write_text("")
    clis = []
    try:
        one_card = tp_one_card(torch.device("cuda"))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    gc.collect()
    torch.cuda.empty_cache()

    # the card's least free memory while the world runs, and while the
    # CLI worlds run beside it
    least = {"world": float("inf"), "with_clis": float("inf")}

    def start_clis(now=False):
        free = torch.cuda.mem_get_info()[0] / 1e9
        key = "with_clis" if clis else "world"
        least[key] = min(least[key], free)
        if not clis and (now or (TP_DIR / TP_CLI_GO).exists()):
            clis.extend(tp_cli_start())
        if len(clis) == 2 and (now or all(proc.poll() is not None
                                          for proc, _ in clis)):
            clis.append(dp_cli_start())
    try:
        world_s = wait_world(procs, TP_WORLD_LIMIT_S, "phase 12 world",
                             start_clis)
        start_clis(now=True)
        counts.update(tp_world_checks(smi, one_card, qwen_run,
                                      serve_refs, world_s))
        tp_cli_checks(smi, *(wait for _, wait in clis[:2]))
        dp_cli_checks(smi, clis[2][1])
    finally:
        for proc, _ in clis:
            if proc.poll() is None:
                kill_tree(proc.pid)
                proc.wait(timeout=60)
    emit({"phase": "tp", "seconds": time.perf_counter() - t_start,
          "least_free_gb": least})
    return counts


def tp_world_checks(smi, one_card, qwen_run, serve_refs, world_s):
    """Phases 11, 12 and 13's lines and checks from the world's reports
    (``one_card``: ``tp_one_card``'s); returns each rank's launches."""
    cfg = cut("qwen1.5-0.5b", TP_DEPTH)
    want = train_launches(cfg, TP_STEPS)
    qwen_losses = one_card["qwen1.5-0.5b"]
    counts = {}
    reports = [json.loads((TP_DIR / f"rank{r}.json").read_text())
               for r in range(4)]
    counts.update(dp_checks(smi, [r["dp"] for r in reports]))
    for world in TP_GRIDS:
        _, cases = TP_GRIDS[world]
        grids = [r["grids"][world] for r in reports]
        gate = grids[0]["fp32_gate"]
        emit({"phase": "tp", "check": "(a) fp32 gate", "world": world,
              "layout": grids[0]["grid"]["mesh"], "layers": TRAIN_CUT,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "steps": TP_GATE_STEPS, "tol": TOL["float32"],
              "param_share_allowed": DP_PARAM_SHARE, "rank0": gate})
        check(all(g["ok"] for g in gate.values())
              and all(r["fp32_gate"][c]["metrics"] == gate[c]["metrics"]
                      for r in grids for c in gate),
              f"phase 12 (a) {world}: {gate}")
        for name, _, compress, _ in cases:
            per = [r["full_depth"][name] for r in grids]
            losses = per[0]["losses"]
            ref = (grids[0]["full_depth"]["plain_compressed_losses"]
                   if compress else qwen_losses)
            gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
            emit({"phase": "tp", "check": f"(b) {name}", "nvidia_smi": smi,
                  "arch": cfg.name, "layers": cfg.n_layers,
                  "layout": grids[0]["grid"]["mesh"],
                  "ranks": "4 ranks sharing one card (gloo, host-staged)",
                  "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
                  "steps": TP_STEPS,
                  "held_to": ("the plain compressed evaluation"
                              if compress else "one card, the same cut"),
                  "reference_losses": ref[:TP_STEPS], "rel_gaps": gaps,
                  "rel_gaps_to_one_card": [
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
            twice = [r["twice"] for r in grids]
            emit({"phase": "tp", "check": "(c) FSDP step twice",
                  "world": world, "per_rank": twice})
            check(all(t["same_bits"] for t in twice),
                  f"phase 12 (c): a rank's step twice gave other bits: "
                  f"{twice}")
        emit({"phase": "tp", "world": world,
              "rank_seconds": [r["seconds"] for r in grids]})
    counts.update(ep_checks(smi, reports, one_card))
    counts.update(ssm_checks(smi, reports, one_card))
    counts.update(encdec_checks(smi, reports, one_card))
    counts.update(ts_checks(smi, [r["serve"] for r in reports],
                            qwen_run, serve_refs))
    emit({"phase": "tp", "world_seconds": world_s,
          "serve_rank_seconds": [r["serve"]["seconds"] for r in reports]})
    return counts


# ---------------------------------------------------------------------------
# phase 13: the request-level engine under a (data 1, model 4) lease, in
# phase 12's world: 4 ranks sharing the card over gloo
# ---------------------------------------------------------------------------

TS_MODEL = 4                    # the lease's model axis: the world's ranks
TS_TIE_MARGIN = 1e-4            # an fp32 top-2 logit margin this small is
                                # a documented tie (C-ref3): the ranks sum
                                # attention and MLP outputs over ``model``
                                # in another order than one card (logits
                                # part by ~1e-6), so such a step may take
                                # the other token
TS_RANKS = "4 ranks sharing one card (gloo, host-staged): no fabric measured"


def ts_engine(model, device, tracer=None, model_parallel=TS_MODEL,
              grid=None, cache=None):
    """``Engine.from_lease`` on a lease of the smoke pool of the world's
    4 ranks with ``model_parallel`` ((data 1, model 4) by default; 2
    gives (h)'s and (i)'s (data 2, model 2)), on ``grid`` when given,
    phase 4's engine shape (its pages in ``cache``'s dtype when given:
    phase 9 serves bf16) and budget, the weights of seed 0 drawn whole
    on every rank and cut to its shards; and phase 4's trace."""
    import torch
    from repro_torch.pool import smoke_pool
    from repro_torch.serve import Engine

    ecfg, budget, trace = serve_parts(model.cfg)
    if cache is not None:
        ecfg = dataclasses.replace(ecfg, cache_dtype=cache)
    lease = smoke_pool("scalepool").lease("serve-tp", TS_MODEL, tier2_gb=8,
                                          kv_gb=4,
                                          model_parallel=model_parallel)
    eng = Engine.from_lease(
        model, lease, ecfg,
        generator=torch.Generator(device=device).manual_seed(0),
        budget=budget, tracer=tracer, grid=grid, device=device)
    return eng, trace


def ts_run(eng, trace):
    from repro_torch.serve import latency_summary, run_trace
    handles = run_trace(eng, trace)
    st = eng.stats()
    return {"tokens": [h.tokens for h in handles],
            "clocks": [(h.submit_clock, h.first_token_clock, h.done_clock)
                       for h in handles],
            "latency": latency_summary(handles), "kv": st["kv"],
            "completed": st["completed"], "failed_oom": st["failed_oom"],
            "tokens_decoded": st["tokens_decoded"]}


def ts_one_card_run(device):
    """(b)'s and (h)'s one-card reference: phase 4's trace served by
    ``Engine.local`` on the first ``SERVE_DEPTH`` layers in bf16, the
    weights of seed 0 drawn as ``ts_engine`` draws them: its tokens, wall
    seconds and decode tokens per wall second."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.serve import Engine

    cfg = cut("qwen1.5-0.5b", SERVE_DEPTH)
    model = build_model(cfg, device=device)
    ecfg, budget, trace = serve_parts(cfg)
    eng = Engine.local(
        model, ecfg, budget=budget, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ts_run(eng, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"tokens": out["tokens"], "wall_s": wall,
            "decode_tokens_per_wall_s": out["tokens_decoded"] / wall}


def ts_serve_model(device):
    """(f)'s and (g)'s model: qwen1.5-0.5b's weights of seed 0 drawn whole
    (phase 4's), loaded and cut to the first ``SERVE_DEPTH`` layers, as
    phases 7 and 8 serve them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    full = build_model(get_config("qwen1.5-0.5b"), device=device)
    return serve_cut(full, full.load(full.init(
        torch.Generator(device=device).manual_seed(0))))


def ts_prefill_logits(eng, prompt):
    """The engine's prefill logits of ``prompt`` (fp32), gathered over
    ``model`` when it has a plan, sliced to the vocab."""
    import torch
    from repro_torch.core import hierarchy

    n = len(prompt)
    bucket = -(-n // eng.cfg.page_size) * eng.cfg.page_size
    toks = torch.zeros((1, bucket), dtype=torch.long, device=eng.device)
    toks[0, :n] = torch.as_tensor(prompt, device=eng.device)
    with eng._scope():
        cache = eng.model.init_cache(1, bucket, dtype=torch.float32)
        logits, _ = eng.model.prefill_at(eng.params, {"tokens": toks},
                                         cache, n - 1)
    if eng.plan is not None:
        logits = hierarchy.all_gather_dim(logits.contiguous(), eng.grid,
                                          ("model",), 2)
    return logits[0, -1, :eng.model.cfg.vocab].float()


def ts_fp32_gate(rank, device):
    """(a) the first ``TRAIN_CUT`` layers in fp32 under the lease; rank 0
    also runs the one-card fp32 engine on the same weights and holds
    every rank's run (by the report) to it, and keeps that run
    (``one_card_run``) for (h)."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.serve import Engine

    cfg = cut("qwen1.5-0.5b", TRAIN_CUT, compute_dtype="float32")
    model = build_model(cfg, device=device)
    eng, trace = ts_engine(model, device)
    out = ts_run(eng, trace)
    got_logits = ts_prefill_logits(eng, trace[0].prompt_tokens)
    del eng
    if rank == 0:
        ecfg, budget, _ = serve_parts(cfg)
        one = Engine.local(
            model, ecfg, budget=budget, device=device,
            generator=torch.Generator(device=device).manual_seed(0))
        want = ts_run(one, trace)
        ties = []
        for i, (a, b) in enumerate(zip(out["tokens"], want["tokens"])):
            step = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                        None)
            if step is not None:
                h = trace[i]
                m = top2_margin(model, one.params, device,
                                list(h.prompt_tokens) + b[:step])
                ties.append({"request": i, "step": step, "top2_margin": m,
                             "tie": m <= TS_TIE_MARGIN})
        want_logits = ts_prefill_logits(one, trace[0].prompt_tokens)
        out["one_card"] = {
            "requests_parting": len(ties), "divergences": ties,
            "clocks_equal": out["clocks"] == want["clocks"],
            "latency_equal": out["latency"] == want["latency"],
            "kv_equal": out["kv"] == want["kv"],
            "kv": want["kv"],
            "prefill_logits_max_abs_err": max_err(got_logits, want_logits),
            "prefill_logits_max_abs": float(want_logits.abs().max())}
        # (h) holds its (data 2, model 2) run to the same one-card run
        out["one_card_run"] = want
        del one
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ts_full_depth(device, model_parallel=TS_MODEL, grid=None):
    """(b) full width on the first ``SERVE_DEPTH`` layers in bf16 under
    the lease (``ts_engine``'s; (h) passes its (data 2, model 2)): the
    run as ``ts_timed_run`` reports it."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer

    model = build_model(cut("qwen1.5-0.5b", SERVE_DEPTH), device=device)
    tracer = Tracer(1 << 20)
    eng, trace = ts_engine(model, device, tracer, model_parallel, grid)
    out = ts_timed_run(eng, trace, tracer)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ts_timed_run(eng, trace, tracer):
    """``ts_run`` of ``eng`` timed: its wall seconds, decode tokens per
    wall second, decode steps and prefills, the kernels' launches and
    variants, the host seconds and calls in collectives, the peak of
    device memory, the rules, the page pool's digest and kv heads, and
    the trace's sanitizer report."""
    import torch
    from repro_torch import kernels
    from repro_torch.sharding.profiles import describe

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.grid.stats.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = ts_run(eng, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    names = [e.name for e in tracer.events()]
    stats = eng.grid.stats
    out.update({
        "wall_s": wall,
        "decode_tokens_per_wall_s": out["tokens_decoded"] / wall,
        "decodes": names.count("decode"), "prefills": names.count("prefill"),
        "engine_steps": eng.steps, "trace_dropped": tracer.dropped,
        "launches": kernels.launch_counts(),
        "variants": kernels.variant_counts(),
        "collective_host_s": stats.seconds,
        "collective_host_s_per_engine_step_by_op": {
            k: v / eng.steps for k, v in stats.seconds_by.items()},
        "collective_calls": dict(stats.calls),
        "moved_bytes": dict(stats.moved_bytes),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "rules": describe(eng.plan.rules),
        "pool_sha256": ts_pool_digest(eng), "kv_heads": eng.kv_heads,
        "mesh": eng.grid.layout.as_dict(),
        "batch_axes": eng.plan.batch_axes,
        "sanitizer": sanitize_report([tracer])})
    return out


def ts_kernels(device):
    """(c) B1 and B3 at a rank's local shapes, 4 of qwen's 16 heads: the
    engine's 8-row decode over an fp32 pool of 64-token pages and its
    512-token prefill (bf16 q, fp32 K/V); and (d)'s session on each
    grid: B3 at a rank's last decode step (its rows and heads) and B2
    over its prefill's and a decode step's rows; phase 12 (f)'s and (j)'s
    ranks on (data 2, model 2): B4 on a rank's SSD heads (its 4 rows of
    512, mamba2's 24 of 48 heads, zamba2's 56 of 112) with its backward
    B8 (each gradient within the bf16 tolerance of its largest |value|,
    against autograd of the plain version on fp32 copies), and B3 and B5
    on zamba2's shared block, 16 of 32 heads at head_dim 112; phase 12
    (g)'s: B3 and B5 at whisper's encoder and cross-attention on a
    rank's 6 of 12 heads; each against its plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.rmsnorm import rmsnorm

    gen = torch.Generator(device=device).manual_seed(13)
    bf16, f32 = torch.bfloat16, torch.float32
    H = 16 // TS_MODEL
    out = {}
    args = paged_inputs(gen, 8, H, H, 64, 64, 16,
                        [130, 260, 520, 150, 300, 563, 0, 400], bf16, f32,
                        device)
    got = paged_decode_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    out["paged_attention"] = {
        "case": f"B=8 H=KV={H} D=64 ps=64 q=bf16 pages=fp32",
        "max_abs_err": max_err(got, want),
        "ok": within(got, want, TOL["bfloat16"])
        and bool(torch.isfinite(got).all())}
    # (h)'s rank on (data 2, model 2): its block of the engine's 8-row
    # bucket, 4 rows on 8 of the 16 heads
    Hd = 16 // TS_DP_MODEL
    args = paged_inputs(gen, 4, Hd, Hd, 64, 64, 16, [130, 260, 520, 150],
                        bf16, f32, device)
    got = paged_decode_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    out["paged_attention (data 2, model 2) rank"] = {
        "case": f"B=4 len 130..520 H=KV={Hd} D=64 ps=64 q=bf16 pages=fp32",
        "max_abs_err": max_err(got, want),
        "ok": within(got, want, TOL["bfloat16"])
        and bool(torch.isfinite(got).all())}
    # (i)'s rank: olmoe's 8 of 16 heads at D=128 over its bf16 pages, 4
    # rows (its block of the 8-row bucket), and its 512-token prefill
    args = paged_inputs(gen, 4, Hd, Hd, 128, 64, 16, [130, 260, 520, 150],
                        bf16, bf16, device)
    got = paged_decode_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    out["paged_attention olmoe (data 2, model 2) rank"] = {
        "case": f"B=4 len 130..520 H=KV={Hd} D=128 ps=64 q=bf16 pages=bf16",
        "max_abs_err": max_err(got, want),
        "ok": within(got, want, TOL["bfloat16"])
        and bool(torch.isfinite(got).all())}
    q, k, v = (torch.randn(1, 512, Hd, 128, generator=gen,
                           device=device).to(bf16) for _ in range(3))
    got = flash_attention(q, k, v, causal=True)
    with ops.plain_versions():
        want = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    out["flash_attention olmoe (model 2) rank prefill"] = {
        "case": f"B=1 Sq=Skv=512 H={Hd} D=128 q=bf16 kv=bf16",
        "max_abs_err": max_err(got, want),
        "ok": within(got, want, TOL["bfloat16"])
        and bool(torch.isfinite(got).all())}
    # (f)'s decode tier (bf16 at full depth: 4 rows of 224..240 tokens)
    # and (g)'s tenants (fp32: 6 rows of 33..160), 16-token pages
    for name, B, pmax, lens, q_dtype in (
            ("disagg decode tier", 4, 15, [224, 229, 235, 240], bf16),
            ("colo tenants", 6, 10, [33, 48, 97, 128, 150, 160], f32)):
        args = paged_inputs(gen, B, H, H, 64, 16, pmax, lens, q_dtype, f32,
                            device)
        got = paged_decode_attention(*args)
        want = ref.paged_attention_ref(*args)
        torch.cuda.synchronize()
        tol = TOL[str(q_dtype).split(".")[1]]
        out[f"paged_attention {name}"] = {
            "case": f"B={B} len {lens[0]}..{lens[-1]} H=KV={H} D=64 ps=16 "
                    f"pages={pmax} q={str(q_dtype).split('.')[1]} "
                    f"pages=fp32", "tol": tol,
            "max_abs_err": max_err(got, want),
            "ok": within(got, want, tol) and bool(torch.isfinite(got).all())}
    q = torch.randn(1, 512, H, 64, generator=gen, device=device).to(bf16)
    k, v = (torch.randn(1, 512, H, 64, generator=gen, device=device)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=True)
    with ops.plain_versions():
        want = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    out["flash_attention"] = {
        "case": f"B=1 Sq=Skv=512 H={H} D=64 q=bf16 kv=fp32",
        "max_abs_err": max_err(got, want),
        "ok": within(got, want, TOL["bfloat16"])
        and bool(torch.isfinite(got).all())}
    # (f)'s and (j)'s ranks on (data 2, model 2): the SSD scan on a
    # rank's heads, its 4 rows of 512, forward and backward (bf16), and
    # zamba2's shared block on 16 of its 32 heads at head_dim 112
    from repro_torch.kernels.ssd_scan import ssd_scan
    for arch, H, N in (("mamba2", 24, 128), ("zamba2", 56, 64)):
        args = ssd_inputs(gen, 4, 512, H, 1, N, bf16, device)
        leaves = [t.clone().requires_grad_(True) for t in args]
        dy = torch.randn(4, 512, H, 64, generator=gen, device=device).to(bf16)
        y, st = ssd_scan(*leaves, chunk=128)
        torch.autograd.backward(y, dy)
        plain = [t.detach().float().clone().requires_grad_(True)
                 for t in args]
        y32, st32 = ref.ssd_chunked_ref(*plain, 128)
        torch.autograd.backward(y32, dy.float())
        torch.cuda.synchronize()
        errs = [max_err(a.grad, b.grad) for a, b in zip(leaves, plain)]
        scales = [float(b.grad.abs().max()) for b in plain]
        case = f"B=4 S=512 H={H} P=64 G=1 N={N} Q=128 bf16"
        out[f"ssd_scan {arch} (data 2, model 2) rank"] = {
            "case": case, "max_abs_err": max_err(y, y32),
            "state_max_abs_err": max_err(st, st32),
            "ok": within(y, y32, TOL["bfloat16"])
            and within(st, st32, TOL["bfloat16"])
            and bool(torch.isfinite(y).all())}
        out[f"ssd_scan_bwd {arch} (data 2, model 2) rank"] = {
            "case": case, "gradients": ["dx", "ddt", "dA", "dB", "dC", "dD"],
            "max_abs_err": errs, "max_abs_grad": scales,
            "tol_of_max_grad": TOL["bfloat16"],
            "ok": all(e <= TOL["bfloat16"] * sc for e, sc in zip(errs, scales))
            and all(bool(torch.isfinite(a.grad).all()) for a in leaves)}
        del args, leaves, plain, y, y32
    q, k, v = (torch.randn(4, 512, 16, 112, generator=gen,
                           device=device).to(bf16).requires_grad_(True)
               for _ in range(3))
    do = torch.randn(4, 512, 16, 112, generator=gen, device=device).to(bf16)
    got = flash_attention(q, k, v, causal=True)
    got.backward(do)
    q32, k32, v32 = (t.detach().float().requires_grad_(True)
                     for t in (q, k, v))
    with ops.plain_versions():
        want = ops.flash_attention(q32, k32, v32, causal=True)
    want.backward(do.float())
    torch.cuda.synchronize()
    errs = [max_err(a.grad, b.grad) for a, b in ((q, q32), (k, k32),
                                                 (v, v32))]
    scales = [float(b.grad.abs().max()) for b in (q32, k32, v32)]
    out["flash_attention zamba2 (model 2) rank"] = {
        "case": "B=4 Sq=Skv=512 H=KV=16 D=112 q=bf16 kv=bf16 causal",
        "max_abs_err": max_err(got, want),
        "ok": within(got, want, TOL["bfloat16"])
        and bool(torch.isfinite(got).all())}
    out["flash_attention_bwd zamba2 (model 2) rank"] = {
        "case": "B=4 Sq=Skv=512 H=KV=16 D=112 bf16 causal",
        "gradients": ["dq", "dk", "dv"], "max_abs_err": errs,
        "max_abs_grad": scales, "tol_of_max_grad": TOL["bfloat16"],
        "ok": all(e <= TOL["bfloat16"] * sc for e, sc in zip(errs, scales))}
    del q, k, v, q32, k32, v32, got, want
    # phase 12 (g)'s rank on (data 2, model 2): whisper's encoder and
    # cross-attention on 6 of its 12 heads, 4 rows (its block of 8),
    # non-causal over 1500 frames, forward (``LONG_KV_TOL``: a dropped
    # ragged tail moves the outputs past it) and backward (each gradient
    # within the bf16 tolerance of its largest |value|), bf16 q and K/V,
    # against the plain versions on fp32 copies
    for tag, Sq in (("encoder", 1500), ("cross", WHISPER_DEC_SEQ)):
        shape = [(4, Sq, 6, 64), (4, 1500, 6, 64), (4, 1500, 6, 64)]
        q, k, v = (torch.randn(*sh, generator=gen, device=device).to(bf16)
                   .requires_grad_(True) for sh in shape)
        do = torch.randn(4, Sq, 6, 64, generator=gen, device=device).to(bf16)
        got = flash_attention(q, k, v, causal=False)
        got.backward(do)
        q32, k32, v32 = (t.detach().float().requires_grad_(True)
                         for t in (q, k, v))
        with ops.plain_versions():
            want = ops.flash_attention(q32, k32, v32, causal=False)
        want.backward(do.float())
        torch.cuda.synchronize()
        errs = [max_err(a.grad, b.grad) for a, b in ((q, q32), (k, k32),
                                                     (v, v32))]
        scales = [float(b.grad.abs().max()) for b in (q32, k32, v32)]
        case = f"B=4 Sq={Sq} Skv=1500 H=KV=6 D=64 q=bf16 kv=bf16 non-causal"
        out[f"flash_attention whisper {tag} (model 2) rank"] = {
            "case": case, "tol": LONG_KV_TOL,
            "max_abs_err": max_err(got, want),
            "ok": within(got, want, LONG_KV_TOL)
            and bool(torch.isfinite(got).all())}
        out[f"flash_attention_bwd whisper {tag} (model 2) rank"] = {
            "case": case, "gradients": ["dq", "dk", "dv"],
            "max_abs_err": errs, "max_abs_grad": scales,
            "tol_of_max_grad": TOL["bfloat16"],
            "ok": all(e <= TOL["bfloat16"] * sc
                      for e, sc in zip(errs, scales))}
        del q, k, v, q32, k32, v32, got, want
    # (d)'s session on each grid: a rank's last decode step (one query
    # over the 544-token fp32 cache) and its norms over the prefill's
    # rows and a decode step's
    S = TS_SESSION["prompt"] + TS_SESSION["generate"]
    for name, (accels, mp) in TS_SESSION_GRIDS.items():
        rows, heads = TS_SESSION["batch"] * mp // accels, 16 // mp
        q = torch.randn(rows, 1, heads, 64, generator=gen,
                        device=device).to(bf16)
        k, v = (torch.randn(rows, S, heads, 64, generator=gen,
                            device=device) for _ in range(2))
        kw = dict(causal=True, q_offset=S - 1, kv_len=S)
        got = flash_attention(q, k, v, **kw)
        with ops.plain_versions():
            want = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        out[f"flash_attention session {name}"] = {
            "case": f"B={rows} Sq=1 Skv={S} q_offset={S - 1} H=KV={heads} "
                    f"D=64 q=bf16 kv=fp32",
            "max_abs_err": max_err(got, want),
            "ok": within(got, want, TOL["bfloat16"])
            and bool(torch.isfinite(got).all())}
        for n in (rows * TS_SESSION["prompt"], rows):
            x = torch.randn(n, 1024, generator=gen, device=device).to(bf16)
            w = (1 + 0.1 * torch.randn(1024, generator=gen,
                                       device=device)).to(bf16)
            got = rmsnorm(x, w)
            want = ref.rmsnorm_ref(x, w)
            torch.cuda.synchronize()
            out[f"rmsnorm session {name} rows={n}"] = {
                "case": f"rows={n} d=1024 bf16",
                "max_abs_err": max_err(got, want),
                "ok": within(got, want, TOL["bfloat16"])
                and bool(torch.isfinite(got).all())}
    return out


# (d): the fixed-batch session on two grids of the running world, the
# lease's (accels, model_parallel) and mesh each; (e): two tenants of one
# (data 1, model 4) lease over one arbiter a rank
TS_SESSION_GRIDS = {"1x4": (4, 4), "2x2": (4, 2)}
TS_SESSION = dict(batch=8, prompt=512, generate=32)
TS_SESSION_GATE_GEN = 8         # (d)'s fp32 gate: generated tokens a row
TS_MT_TENANTS = ("a", "b")
TS_MT_PAGES = 32                # (e)'s shared tier-1 pool: revokes pages
                                # on phase 4's trace split two ways
TS_MT_NEW = 32                  # (e)'s new tokens a request (phase 4's are
                                # 64): each sequence still grows by a page,
                                # and the pool still revokes 2


def ts_session_steps(sess, params, inputs, generate, keep_logits=False):
    """A prefill and ``generate - 1`` greedy decode steps of the session
    over an fp32 cache (encdec: its encoder states in the carry): the
    global tokens (B, generate) on the host and, with ``keep_logits``,
    every step's global logits (fp32, on the card)."""
    import torch
    batch, prompt = inputs["tokens"].shape
    cache = sess.init_cache(batch, prompt + generate, dtype=torch.float32)
    logits, cache, *enc = sess.prefill_step(params, inputs, cache)
    carry = {"tokens": sess.greedy(logits), "cache": cache, "index": prompt}
    if enc:
        carry["enc_states"] = enc[0]
    steps = [sess.gather_logits(logits)[:, -1].float()] if keep_logits \
        else []
    tokens = [carry["tokens"]]
    for _ in range(generate - 1):
        logits, carry = sess.decode_step(params, carry)
        tokens.append(carry["tokens"])
        if keep_logits:
            steps.append(sess.gather_logits(logits)[:, -1].float())
    return torch.cat(tokens, 1).cpu(), steps


def ts_session_lease(name, model, device):
    """``make_lease_session`` on the grid ``name`` of
    ``TS_SESSION_GRIDS`` (its groups formed in the running world) for
    ``TS_SESSION``'s decode shape."""
    from repro_torch.models.config import ShapeConfig
    from repro_torch.pool import smoke_pool
    from repro_torch.runtime.serve import make_lease_session

    accels, mp = TS_SESSION_GRIDS[name]
    lease = smoke_pool("scalepool").lease(f"session-{name}", accels,
                                          tier2_gb=8, kv_gb=4,
                                          model_parallel=mp)
    B, S, G = (TS_SESSION[k] for k in ("batch", "prompt", "generate"))
    return make_lease_session(model, ShapeConfig("session", "decode", S + G,
                                                 B), lease, device=device)


def ts_session_gate(rank, device):
    """(d) fp32 on the first ``TRAIN_CUT`` layers at full width: on each
    grid every step's logits (gathered from the ranks) against the
    one-card session's on the same weights and prompts (rank 0 runs
    it), on rows whose tokens so far agree; tokens equal, or parted
    only at a documented tie (the one-card top-2 margin within
    ``TS_TIE_MARGIN``, C-ref3)."""
    import torch
    from repro_torch.launch.serve import fixed_batch_inputs
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime.serve import make_session

    cfg = cut("qwen1.5-0.5b", TRAIN_CUT, compute_dtype="float32")
    model = build_model(cfg, device=device)
    B, S, G = TS_SESSION["batch"], TS_SESSION["prompt"], TS_SESSION_GATE_GEN
    raw, inputs = fixed_batch_inputs(model, B, S, 0, device)
    want = None
    if rank == 0:
        one = make_session(model, ShapeConfig("one", "decode", S + G, B))
        want = ts_session_steps(one, one.load(raw), inputs, G, True)
    out = {}
    for name in TS_SESSION_GRIDS:
        sess = ts_session_lease(name, model, device)
        got = ts_session_steps(sess, sess.load(raw), inputs, G, True)
        r = {"tokens": got[0].tolist(), "mesh": sess.grid.layout.as_dict()}
        if want is not None:
            r["one_card"] = ts_session_compare(got, want)
        sess.grid.close()
        out[name] = r
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ts_session_compare(got, want) -> dict:
    """Two sessions' ``ts_session_steps`` with logits, each step's logits
    on the rows whose tokens so far agree: the error over the largest
    |logit| a step, and where tokens part, the second's top-2 margin
    (within ``TS_TIE_MARGIN``: a tie, C-ref3)."""
    import torch
    B, G = want[0].shape
    same = torch.ones(B, dtype=torch.bool)
    errs, parted = [], []
    for k in range(G):
        a, b = got[1][k][same], want[1][k][same]
        if len(a):
            errs.append(max_err(a, b) / float(b.abs().max()))
        for i in torch.nonzero(same & (got[0][:, k]
                                       != want[0][:, k])).flatten():
            top = torch.topk(want[1][k][i], 2).values
            m = float(top[0] - top[1])
            parted.append({"row": int(i), "step": k, "top2_margin": m,
                           "tie": m <= TS_TIE_MARGIN})
            same[i] = False
    return {"rel_err_by_step": errs, "max_rel_err": max(errs),
            "parted": parted}


def ts_session_full(device):
    """(d) bf16 at full width on the first ``SERVE_DEPTH`` layers on each
    grid: ``TS_SESSION``'s
    rows, prompts and new tokens through ``launch.serve.
    fixed_batch_generate``; the tokens, the launches and kernel variants
    of the run, prefill and decode seconds, decode tokens per wall
    second, host seconds in collectives by (axes, op)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.serve import (fixed_batch_generate,
                                          fixed_batch_inputs)
    from repro_torch.models.api import build_model
    from repro_torch.sharding.profiles import describe

    model = build_model(cut("qwen1.5-0.5b", SERVE_DEPTH), device=device)
    B, S, G = (TS_SESSION[k] for k in ("batch", "prompt", "generate"))
    raw, inputs = fixed_batch_inputs(model, B, S, 0, device)
    out = {}
    for name in TS_SESSION_GRIDS:
        sess = ts_session_lease(name, model, device)
        params = sess.load(raw)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        sess.grid.stats.reset()
        kernels.reset_launch_counts()
        run = fixed_batch_generate(model, params, inputs, G, device, sess)
        stats = sess.grid.stats
        out[name] = {
            "mesh": sess.grid.layout.as_dict(), "rows": sess.rows(B),
            "rules": describe(sess.plan.rules),
            "tokens": run["tokens"].tolist(),
            "finite": run["logits_finite"],
            "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
            "decode_tokens_per_wall_s": run["decode_tokens_per_s"],
            "launches": kernels.launch_counts(),
            "variants": kernels.variant_counts(),
            "collective_host_s": stats.seconds,
            "collective_host_s_by_op": dict(stats.seconds_by),
            "collective_calls": dict(stats.calls),
            "moved_bytes": dict(stats.moved_bytes)}
        sess.grid.close()
        del params, run
        gc.collect()
        torch.cuda.empty_cache()
    del raw
    return out


# (j): the ssm and hybrid families' fixed-batch session on the world's
# (data 2, model 2) grid: mamba2-780m on its first 2 layers, zamba2-7b on
# its first ZAMBA2_GATE_DEPTH (the SSD heads, conv channels and shared
# attention heads over model)
TS_SSM = (("mamba2-780m", TRAIN_CUT), ("zamba2-7b", ZAMBA2_GATE_DEPTH))
TS_SSM_GRID = "2x2"
# (k): the encdec family's there: whisper-small on the first 2 layers of
# each stack (6 of 12 heads a rank), TS_SESSION's 8 rows of 1500 frames
# and 64-token prompts
TS_ENCDEC = (("whisper-small", TRAIN_CUT),)
TS_ENCDEC_PROMPT = 64


def ts_fixed_batch(rank, device, entries, tag, prompt=TS_SESSION["prompt"]):
    """(j) or (k) (``tag``) each of ``entries`` (``TS_SSM``,
    ``TS_ENCDEC``) at full width on its cut: fp32 on ``TS_SESSION``'s
    rows and ``prompt``-token prompts, ``TS_SESSION_GATE_GEN`` new
    tokens, every step's logits (gathered) against one card's session
    on the same weights (rank 0 runs it, and again through the plain
    versions: how far two fp32 programs of one semantics part on one
    card, ``ts_family_gate``'s bound); then bf16 with
    ``TS_SESSION``'s new tokens through ``launch.serve.
    fixed_batch_generate``: the tokens, launches, kernel variants,
    collectives, seconds and decode tokens per wall second, beside one
    card's run of the same (rank 0)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (fixed_batch_generate,
                                          fixed_batch_inputs)
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.runtime.serve import make_session
    from repro_torch.sharding.profiles import describe

    B, S = TS_SESSION["batch"], prompt
    out = {}
    for arch, layers in entries:
        t0 = time.perf_counter()
        cfg = cut(arch, layers, compute_dtype="float32")
        model = build_model(cfg, device=device)
        G = TS_SESSION_GATE_GEN
        raw, inputs = fixed_batch_inputs(model, B, S, 0, device)
        sess = ts_session_lease(TS_SSM_GRID, model, device)
        got = ts_session_steps(sess, sess.load(raw), inputs, G, True)
        r = {"gate": {"tokens": got[0].tolist(),
                      "mesh": sess.grid.layout.as_dict()}}
        sess.grid.close()
        if rank == 0:
            one = make_session(model, ShapeConfig("one", "decode", S + G, B))
            want = ts_session_steps(one, one.load(raw), inputs, G, True)
            r["gate"]["one_card"] = ts_session_compare(got, want)
            with ops.plain_versions():
                plain = ts_session_steps(one, one.load(raw), inputs, G, True)
            r["gate"]["one_card_plain"] = ts_session_compare(plain, want)
            del want, plain
        del raw, got, model
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        model = build_model(cut(arch, layers), device=device)
        G = TS_SESSION["generate"]
        raw, inputs = fixed_batch_inputs(model, B, S, 0, device)
        sess = ts_session_lease(TS_SSM_GRID, model, device)
        params = sess.load(raw)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        sess.grid.stats.reset()
        kernels.reset_launch_counts()
        run = fixed_batch_generate(model, params, inputs, G, device, sess)
        stats = sess.grid.stats
        r["full"] = {
            "mesh": sess.grid.layout.as_dict(), "rows": sess.rows(B),
            "rules": describe(sess.plan.rules),
            "tokens": run["tokens"].tolist(),
            "finite": run["logits_finite"],
            "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
            "decode_tokens_per_wall_s": run["decode_tokens_per_s"],
            "launches": kernels.launch_counts(),
            "variants": kernels.variant_counts(),
            "collective_host_s": stats.seconds,
            "collective_host_s_by_op": dict(stats.seconds_by),
            "collective_calls": dict(stats.calls)}
        sess.grid.close()
        del params, run
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0:
            one = fixed_batch_generate(model, model.load(raw), inputs, G,
                                       device)
            r["full"]["one_card"] = {
                "prefill_s": one["prefill_s"], "decode_s": one["decode_s"],
                "decode_tokens_per_wall_s": one["decode_tokens_per_s"],
                "rows_parting": sum(a != b for a, b in zip(
                    r["full"]["tokens"], one["tokens"].tolist()))}
            del one
        del raw, model
        gc.collect()
        torch.cuda.empty_cache()
        r["seconds"] = {"fp32": t1 - t0, "bf16": time.perf_counter() - t1}
        out[arch] = r
        dp_progress(rank, f"{tag} {arch}", t0, r["seconds"], phase=13)
    return out


def ts_ssm_checks(smi, per):
    """Phase 13 (j)'s lines and checks; returns each rank's launches of
    the bf16 runs."""
    counts = {}
    for arch, layers in TS_SSM:
        cfg = cut(arch, layers)
        runs = [p["ssm"][arch] for p in per]
        ts_family_gate(smi, cfg, layers, runs, "(j) ssm_* session",
                       TS_SESSION["prompt"])
        full = [r["full"] for r in runs]
        f0 = full[0]
        G = TS_SESSION["generate"]
        A = attention_layers(cfg)
        L = cfg.n_layers                        # Mamba2 layers
        emit({"phase": "tp serve", "check": "(j) ssm_* session full width, "
              "cut depth", "grid": TS_SSM_GRID, "mesh": f0["mesh"],
              "nvidia_smi": smi, "arch": cfg.name, "layers": layers,
              "compute": cfg.compute_dtype, **TS_SESSION,
              "ranks": TS_RANKS, "rules": f0["rules"],
              "one_card": f0["one_card"],
              "per_rank": [{k: f[k] for k in f if k not in (
                  "tokens", "one_card")} for f in full]})
        # a call's norms: the shared block's two, each Mamba2 layer's
        # input norm (its gated norm runs in plain ops under model), the
        # final norm; the SSD scan in the prefill (decode steps the
        # state); flash in each shared block call
        want = {"paged_attention": 0, "flash_attention": A * G,
                "ssd_scan": L, "rmsnorm": (2 * A + L + 1) * G}
        for r, f in enumerate(full):
            n, calls = f["launches"], f["collective_calls"]
            check(f["tokens"] == f0["tokens"] and f["finite"]
                  and len(f["tokens"]) == TS_SESSION["batch"]
                  and all(len(t) == G and all(0 <= x < cfg.vocab for x in t)
                          for t in f["tokens"]),
                  f"phase 13 (j) {arch} rank {r}: tokens differ from rank "
                  f"0's or are not {G} in the vocab a row")
            check(all(n.get(k, 0) == v for k, v in want.items())
                  and calls.get("model:all-gather:ssm") == L * G
                  and calls.get("model:all-reduce:ssm-norm") == L * G,
                  f"phase 13 (j) {arch} rank {r}: launches {n} != {want}, "
                  f"or collectives {calls}")
            check_flash_variant(f"phase 13 (j) {arch} rank {r}",
                                cfg.compute_dtype, f["variants"],
                                want["flash_attention"])
            check_ssd_variant(f"phase 13 (j) {arch} rank {r}",
                              cfg.compute_dtype, f["variants"],
                              want["ssd_scan"])
            counts[f"{arch} session ssm tp rank {r}"] = dict(n)
    emit({"phase": "tp serve", "check": "(j) seconds",
          "per_rank": [{a: p["ssm"][a]["seconds"] for a, _ in TS_SSM}
                       for p in per]})
    return counts


def ts_family_gate(smi, cfg, layers, runs, what, prompt):
    """(j)'s or (k)'s fp32 gate line and checks: the ranks' tokens equal,
    every step's logits within the bound of one card's session, no row
    parting."""
    tag = what.split()[0]
    gate = [r["gate"] for r in runs]
    one = gate[0]["one_card"]
    # the fp32 sums of 4 ranks part from one card's by as much as the
    # kernels' from the plain versions' on one card: zamba2's 7 layers at
    # d=3584 part by ~1.1e-5 of the largest |logit| on an H100; held to
    # twice the latter where it is the larger
    plain = gate[0]["one_card_plain"]
    tol = max(TOL["float32"], 2 * plain["max_rel_err"])
    emit({"phase": "tp serve", "check": f"{what} fp32 gate",
          "grid": TS_SSM_GRID, "mesh": gate[0]["mesh"], "nvidia_smi": smi,
          "arch": cfg.name, "layers": layers, "batch": TS_SESSION["batch"],
          "prompt": prompt, "generate": TS_SESSION_GATE_GEN, "tol": tol,
          "tie_margin": TS_TIE_MARGIN, "ranks": TS_RANKS, "one_card": one,
          "one_card_kernels_vs_plain": plain})
    check(all(g["tokens"] == gate[0]["tokens"] for g in gate),
          f"phase 13 {tag} {cfg.name}: the ranks' fp32 tokens differ")
    check(one["max_rel_err"] <= tol and not one["parted"]
          and not plain["parted"],
          f"phase 13 {tag} {cfg.name}: against the one-card fp32 session "
          f"(bound {tol}): {one}")


def ts_encdec_checks(smi, per):
    """Phase 13 (k)'s lines and checks; returns each rank's launches of
    the bf16 run."""
    counts = {}
    for arch, layers in TS_ENCDEC:
        cfg = cut(arch, layers)
        runs = [p["encdec"][arch] for p in per]
        ts_family_gate(smi, cfg, layers, runs, "(k) encdec session",
                       TS_ENCDEC_PROMPT)
        full = [r["full"] for r in runs]
        f0 = full[0]
        G = TS_SESSION["generate"]
        L, E = cfg.n_layers, cfg.n_enc_layers
        emit({"phase": "tp serve", "check": "(k) encdec session full "
              "width, cut depth", "grid": TS_SSM_GRID, "mesh": f0["mesh"],
              "nvidia_smi": smi, "arch": cfg.name, "layers": layers,
              "compute": cfg.compute_dtype, "batch": TS_SESSION["batch"],
              "frames": cfg.enc_seq, "prompt": TS_ENCDEC_PROMPT,
              "generate": G, "ranks": TS_RANKS, "rules": f0["rules"],
              "one_card": f0["one_card"],
              "per_rank": [{k: f[k] for k in f if k not in (
                  "tokens", "one_card")} for f in full]})
        # flash: the prefill's encoder layers and each decoder layer's
        # self- and cross-attention, then those two a decode step; no
        # RMSNorm (LayerNorm is no kernel).  Collectives over model: the
        # lookup's sum and three a decoder layer each call, two an
        # encoder layer in the prefill; the greedy token's gathers over
        # model and data each call
        want = {"paged_attention": 0, "ssd_scan": 0, "rmsnorm": 0,
                "flash_attention": E + 2 * L * G}
        want_calls = {"model:all-reduce": G * (1 + 3 * L) + 2 * E,
                      "model:all-gather": G, "data:all-gather": G}
        for r, f in enumerate(full):
            n, calls = f["launches"], f["collective_calls"]
            check(f["tokens"] == f0["tokens"] and f["finite"]
                  and len(f["tokens"]) == TS_SESSION["batch"]
                  and all(len(t) == G and all(0 <= x < cfg.vocab for x in t)
                          for t in f["tokens"]),
                  f"phase 13 (k) {arch} rank {r}: tokens differ from rank "
                  f"0's or are not {G} in the vocab a row")
            check(all(n.get(k, 0) == v for k, v in want.items())
                  and calls == want_calls,
                  f"phase 13 (k) {arch} rank {r}: launches {n} != {want}, "
                  f"or collectives {calls} != {want_calls}")
            check_flash_variant(f"phase 13 (k) {arch} rank {r}",
                                cfg.compute_dtype, f["variants"],
                                want["flash_attention"])
            counts[f"{arch} session encdec tp rank {r}"] = dict(n)
    emit({"phase": "tp serve", "check": "(k) seconds",
          "per_rank": [{a: p["encdec"][a]["seconds"] for a, _ in TS_ENCDEC}
                       for p in per]})
    return counts


def ts_tenant_parts(cfg):
    """(e)'s engine shape and trace: phase 4's, each request's new tokens
    ``TS_MT_NEW``."""
    ecfg, _, trace = serve_parts(cfg)
    return ecfg, [dataclasses.replace(r, max_new_tokens=TS_MT_NEW)
                  for r in trace]


def ts_tenant_engines(model, device, lease, tracer=None):
    """Two tenants of ``lease`` (its grid when it binds one) over one
    ``PoolArbiter`` of ``TS_MT_PAGES`` pages, phase 4's engine shape,
    each tenant's ``kv_share`` of the lease's grant, the weights of seed
    0; the pages checked after every engine step."""
    import torch
    from repro_torch.serve import Engine, PoolArbiter

    ecfg, trace = ts_tenant_parts(model.cfg)
    arb = PoolArbiter(TS_MT_PAGES, page_size=ecfg.page_size, tracer=tracer)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    engines = []
    for t in TS_MT_TENANTS:
        kw = dict(params=params, arbiter=arb, tenant=t, tracer=tracer,
                  device=device)
        if lease.tenants and lease.model_parallel > 1:
            eng = Engine.from_lease(model, lease, ecfg, **kw)
        else:
            eng = Engine.local(model, ecfg, budget=lease.kv_share(
                t, page_size=ecfg.page_size), **kw)
        engines.append(eng)
    checked = [0]
    for eng in engines:
        def step(orig=eng.step):
            dt = orig()
            arb.check_conservation()
            checked[0] += 1
            return dt
        eng.step = step
    n = len(TS_MT_TENANTS)
    split = [trace[i::n] for i in range(n)]
    return arb, engines, split, checked


def ts_tenant_outcome(arb, engines, lists, checked):
    return {"tokens": [[h.tokens for h in hs] for hs in lists],
            "clocks": [[(h.submit_clock, h.first_token_clock, h.done_clock)
                        for h in hs] for hs in lists],
            "arbiter": arb.stats(), "checked": checked[0],
            "completed": [e.stats()["completed"] for e in engines],
            "failed_oom": [e.stats()["failed_oom"] for e in engines]}


def ts_tenants(rank, device):
    """(e) two tenants of one (data 1, model 4) lease over one arbiter a
    rank, fp32 on the first ``TRAIN_CUT`` layers at full width, phase
    4's trace split round-robin under ``TS_MT_PAGES``; rank 0 also runs
    the one-card two-tenant run (``Engine.local`` with each tenant's
    ``kv_share``) on the same weights.  Every rank's trace through the
    port's sanitizer."""
    import torch
    from repro_torch import kernels
    from repro_torch.analysis import sanitize_tracer
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.pool import smoke_pool
    from repro_torch.serve import run_multi_trace

    cfg = cut("qwen1.5-0.5b", TRAIN_CUT, compute_dtype="float32")
    model = build_model(cfg, device=device)
    lease = smoke_pool("scalepool").lease(
        "serve-tenants", TS_MODEL, tier2_gb=8, kv_gb=4,
        model_parallel=TS_MODEL, tenants=TS_MT_TENANTS)
    tracer = Tracer(1 << 20)
    arb, engines, split, checked = ts_tenant_engines(model, device, lease,
                                                     tracer)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lists = run_multi_trace(list(zip(engines, split)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = ts_tenant_outcome(arb, engines, lists, checked)
    names = [e.name for e in tracer.events()]
    out.update({"launches": kernels.launch_counts(),
                "variants": kernels.variant_counts(),
                "decodes": names.count("decode"),
                "prefills": names.count("prefill")})
    rep = sanitize_tracer(tracer)
    out.update({"wall_s": wall, "mesh": arb.grid.layout.as_dict(),
                "one_grid": all(e.grid is arb.grid for e in engines),
                "pool_kv_heads": int(arb.pool["k"].shape[3]),
                "page_bytes": arb.page_bytes,
                "sanitizer": {"ok": rep.ok, "events": rep.events,
                              "violations": len(rep.violations)},
                "trace_dropped": tracer.dropped})
    grid = arb.grid
    del arb, engines, lists
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        one = smoke_pool("scalepool").lease(
            "serve-tenants", TS_MODEL, tier2_gb=8, kv_gb=4,
            tenants=TS_MT_TENANTS)
        arb1, engines1, split1, checked1 = ts_tenant_engines(model, device,
                                                             one)
        want = ts_tenant_outcome(arb1, engines1, run_multi_trace(
            list(zip(engines1, split1))), checked1)
        ties = []
        for t, (a, b, reqs) in enumerate(zip(out["tokens"], want["tokens"],
                                             split1)):
            for i, (x, y) in enumerate(zip(a, b)):
                step = next((k for k, (p, q) in enumerate(zip(x, y))
                             if p != q), None)
                if step is not None:
                    m = top2_margin(model, engines1[0].params, device,
                                    list(reqs[i].prompt_tokens) + y[:step])
                    ties.append({"tenant": TS_MT_TENANTS[t], "request": i,
                                 "step": step, "top2_margin": m,
                                 "tie": m <= TS_TIE_MARGIN})
        out["one_card"] = {
            "tokens_equal": out["tokens"] == want["tokens"],
            "divergences": ties,
            "clocks_equal": out["clocks"] == want["clocks"],
            "arbiter_equal": out["arbiter"] == want["arbiter"],
            "arbiter": want["arbiter"],
            "page_bytes": arb1.page_bytes,
            "pool_kv_heads": int(arb1.pool["k"].shape[3])}
        del arb1, engines1
    grid.close()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# (f): phase 7's disaggregated serving on a gang of two (data 1, model 4)
# members; (g): phase 8's co-residency on one (data 1, model 4) lease;
# every engine from its lease on one grid, held to one card's runs
TS_DG_MAIN = ("colocated", "direct")    # (f)'s runs at each depth
TS_REFS = "serve_refs.json"             # one card's, written before the
                                        # world (phases 7 and 8)


def ts_dg_refs(runs, modeled, cut_ref):
    """(f)'s one-card references: the bf16 colocated and direct runs'
    tokens and modeled numbers (of phase 7's ``runs`` and ``modeled``)
    and ``dg_cut_runs``' report, as JSON gives them back."""
    return json.loads(json.dumps({"fp32_cut": cut_ref, "bf16": {
        "tokens": {k: [h.tokens for h in runs[k][0]] for k in TS_DG_MAIN},
        "modeled": {m: {k: v for k, v in d.items() if k in TS_DG_MAIN}
                    for m, d in modeled.items()}}}))


def ts_co_refs(runs32, page_bytes):
    """(g)'s one-card reference: fig11's three runs in fp32 on the first
    ``TRAIN_CUT`` layers (phase 8's), tokens and modeled numbers."""
    return json.loads(json.dumps({
        "tokens": {k: co_outcome(r)["tokens"] for k, r in runs32.items()},
        "modeled": {k: co_modeled(r, page_bytes) for k, r in runs32.items()},
        "page_bytes": page_bytes}))


def ts_serve_refs(device):
    """(f)'s and (g)'s one-card references outside the smoke's phases 7
    and 8 (``chip_tools/``): on ``ts_serve_model``'s cut, phase 7's bf16
    colocated and direct runs, ``dg_cut_runs``, and phase 8's three fp32
    runs on the first ``CO_SHALLOW`` layers."""
    from repro_torch.models.api import build_model
    model, params = ts_serve_model(device)
    runs, _ = dg_main_runs(model, params, device, dg_trace(),
                           names=TS_DG_MAIN)
    cut_ref, _, _ = dg_cut_runs(model, params, device)
    m32 = build_model(cut("qwen1.5-0.5b", CO_SHALLOW,
                          compute_dtype="float32"), device=device)
    p32 = m32.load({**params, "layers": params["layers"][:CO_SHALLOW]})
    runs32, _, page32 = co_three(m32, p32, device, CO_REQUESTS, CO_STEPS)
    return {"disagg": ts_dg_refs(runs, dg_modeled(runs), cut_ref),
            "colo": ts_co_refs(runs32, page32)}


def ts_divergences(model, params, device, got, want, prompts):
    """Where ``got`` (a list of token lists) parts from ``want``: each
    request's first differing step with one card's top-2 logit margin
    there (``model`` and the full ``params``, outside any plan)."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        step = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if step is not None:
            m = top2_margin(model, params, device,
                            list(prompts[i]) + list(b[:step]))
            out.append({"request": i, "step": step, "top2_margin": m,
                        "tie": m <= TS_TIE_MARGIN})
    return out


def ts_run_counts(tracers, launches):
    """Each run's launches beside the decode steps and prefills its
    trace (or traces) recorded."""
    out = {}
    for name, trs in tracers.items():
        names = [e.name for t in trs for e in t.events()]
        out[name] = {**launches[name], "decodes": names.count("decode"),
                     "prefills": names.count("prefill")}
    return out


def ts_disagg(rank, device, full_model, full_params, refs):
    """(f) fig12's scenario (phase 7) on a gang of two (data 1, model 4)
    members, every engine on one grid (``DgTiers``): colocated, direct
    and the degenerate cluster in fp32 on the first ``TRAIN_CUT`` layers
    at full width; colocated and direct in bf16 on ``full_model``
    (``ts_serve_model``'s ``SERVE_DEPTH`` layers, as phase 7's), with the
    wall, the host seconds in collectives and the peak memory.
    Rank 0 takes one card's top-2 margin wherever its tokens part from
    one card's (``refs``: phase 7's)."""
    import torch

    tiers = DgTiers()
    trace = dg_trace()
    prompts = [r.prompt_tokens for r in trace]
    tracers32, launches32 = [], {}
    t0 = time.perf_counter()
    cut_out, m32, p32 = dg_cut_runs(full_model, full_params, device, tiers,
                                    tracers32, launches32)
    cut_s = time.perf_counter() - t0
    out = {"fp32": {**cut_out, "seconds": cut_s,
                    "counts": ts_run_counts(
                        {"colocated": tracers32[:1],
                         "direct": tracers32[1:2],
                         "degenerate": tracers32[2:]}, launches32),
                    "sanitizer": sanitize_report(tracers32),
                    "handoff_uses": dg_uses_after_pages(tracers32[1])}}
    if rank == 0:
        ref = refs["fp32_cut"]
        out["fp32"]["divergences"] = {
            k: ts_divergences(m32, p32, device, cut_out["tokens"][k],
                              ref["tokens"][k], prompts)
            for k in TS_DG_MAIN}
        out["fp32"]["divergences"]["degenerate"] = ts_divergences(
            m32, p32, device, cut_out["degenerate"]["tokens"],
            ref["degenerate"]["tokens"], prompts)
    del m32, p32
    gc.collect()
    torch.cuda.empty_cache()

    tracers, launches = [], {}
    grid = tiers.grid
    grid.stats.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runs, walls = dg_main_runs(full_model, full_params, device, trace,
                               tracers, TS_DG_MAIN, tiers, launches)
    wall = time.perf_counter() - t0
    stats = grid.stats
    counts = ts_run_counts({k: [t] for k, t in zip(TS_DG_MAIN, tracers)},
                           launches)
    decoded = {k: sum(len(h.tokens) - 1 for h in runs[k][0])
               for k in TS_DG_MAIN}
    tokens = {k: [h.tokens for h in runs[k][0]] for k in TS_DG_MAIN}
    out["bf16"] = {
        "tokens": tokens, "modeled": dg_modeled(runs), "wall_s": walls,
        "seconds": wall, "counts": counts,
        "decode_tokens_per_wall_s": {k: decoded[k] / walls[k]
                                     for k in TS_DG_MAIN},
        "collective_host_s": stats.seconds,
        "collective_host_s_by_op": dict(stats.seconds_by),
        "collective_calls": dict(stats.calls),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "handoff_uses": dg_uses_after_pages(tracers[1]),
        "sanitizer": sanitize_report(tracers),
        "mesh": grid.layout.as_dict(),
        "one_grid": all(e.grid is grid for e in
                        [w.engine for w in runs["direct"][1].prefill_workers]
                        + runs["direct"][1].decode_engines),
        "kv_heads": runs["direct"][1].decode_engines[0].kv_heads}
    if rank == 0:
        out["bf16"]["divergences"] = {
            k: ts_divergences(full_model, full_params, device, tokens[k],
                              refs["bf16"]["tokens"][k], prompts)
            for k in TS_DG_MAIN}
    del runs
    grid.close()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ts_colo(rank, device, full_params, refs):
    """(g) fig11's three runs (phase 8) in fp32 on the first
    ``CO_SHALLOW`` layers at full width, both tenants' engines from one
    (data 1, model 4) lease on one grid; rank 0 takes one card's top-2
    margin wherever its tokens part from one card's (``refs``: phase
    8's fp32 runs on the same cut)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.pool import smoke_pool

    m32 = build_model(cut("qwen1.5-0.5b", CO_SHALLOW,
                          compute_dtype="float32"), device=device)
    p32 = m32.load({**full_params,
                    "layers": full_params["layers"][:CO_SHALLOW]})
    lease = smoke_pool("scalepool").lease("colo-tp", TS_MODEL, tier2_gb=8,
                                          kv_gb=4, model_parallel=TS_MODEL)
    tracers, launches = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runs, walls, page = co_three(m32, p32, device, CO_REQUESTS, CO_STEPS,
                                 lease=lease, tracers=tracers,
                                 launches=launches)
    wall = time.perf_counter() - t0
    grid = runs["hop_only"]["grid"]
    stats = grid.stats
    names = [k for k, _, _ in CO_RUNS]
    tokens = {k: co_outcome(r)["tokens"] for k, r in runs.items()}
    decoded = {k: sum(len(h.tokens) - 1 for hs in r["handles"].values()
                      for h in hs) for k, r in runs.items()}
    out = {"tokens": tokens,
           "modeled": {k: co_modeled(r, page) for k, r in runs.items()},
           "claims": co_claims(runs), "page_bytes": page,
           "wall_s": walls, "seconds": wall,
           "counts": ts_run_counts(dict(zip(names, ([t] for t in tracers))),
                                   launches),
           "decode_tokens_per_wall_s": {k: decoded[k] / walls[k]
                                        for k in walls},
           "collective_host_s": stats.seconds,
           "collective_host_s_by_op": dict(stats.seconds_by),
           "collective_calls": dict(stats.calls),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "sanitizer": sanitize_report(tracers),
           "mesh": grid.layout.as_dict(),
           "one_grid": all(e.grid is grid for r in runs.values()
                           for e in r["engines"].values()),
           "kv_heads": runs["hop_only"]["engines"]["a"].kv_heads,
           "full_kv_heads": get_config("qwen1.5-0.5b").n_kv_heads}
    if rank == 0:
        out["divergences"] = {
            k: {t: ts_divergences(
                m32, p32, device, tokens[k][t], refs["tokens"][k][t],
                [h.request.prompt_tokens for h in runs[k]["handles"][t]])
                for t in CO_TENANTS} for k in names}
    del runs
    grid.close()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# (h): the engine on a (data 2, model 2) lease of the world's 4 ranks:
# each rank decodes its block of every decode bucket's rows (at most 4
# of phase 4's 8 slots) on 8 of qwen's 16 heads, the page pool
# replicated over data and kept equal by one all-gather a decode step
TS_DP_MODEL = 2
TS_DP_MESH = {"data": TS_MODEL // TS_DP_MODEL, "model": TS_DP_MODEL}


def ts_pool_digest(eng) -> str:
    """sha256 of ``eng``'s page pool, its trash page left out (the idle
    rows of a data rank's block write it)."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for name, leaf in eng._pool.items():
        h.update(name.encode())
        h.update(leaf[:, :eng._trash].contiguous().cpu().view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def ts_dp_fp32(rank, device, one_card):
    """(h) 1: phase 4's trace in fp32 on the first ``TRAIN_CUT`` layers
    on a (data 2, model 2) lease (the engine joins the grid (h) serves
    on), its launches, its trace's sanitizer report and its pool's
    digest; rank 0 takes one card's top-2 margin wherever its tokens
    part from ``one_card`` ((a)'s one-card fp32 run).  Returns (report,
    grid)."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer

    cfg = cut("qwen1.5-0.5b", TRAIN_CUT, compute_dtype="float32")
    model = build_model(cfg, device=device)
    tracer = Tracer(1 << 20)
    eng, trace = ts_engine(model, device, tracer, TS_DP_MODEL)
    grid = eng.grid
    out = ts_timed_run(eng, trace, tracer)
    del eng
    if rank == 0:
        params = model.load(model.init(
            torch.Generator(device=device).manual_seed(0)))
        out["divergences"] = ts_divergences(
            model, params, device, out["tokens"], one_card["tokens"],
            [r.prompt_tokens for r in trace])
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return out, grid


def ts_dp_disagg(rank, device, full_model, full_params, refs, grid):
    """(h) 3: (f)'s direct cluster in fp32 on the first ``TRAIN_CUT``
    layers, both tiers from a gang of two (data 2, model 2) members on
    ``grid``; rank 0 takes one card's top-2 margin wherever its tokens
    part from one card's (``refs``: ``dg_cut_runs``')."""
    import torch

    tiers = DgTiers(TS_DP_MODEL, grid)
    trace = dg_trace()
    m32, p32 = dg_fp32_cut(full_model, full_params, device)
    tracers, launches = [], {}
    runs, walls = dg_main_runs(m32, p32, device, trace, tracers,
                               ("direct",), tiers, launches)
    handles, cluster = runs["direct"]
    engines = [w.engine for w in cluster.prefill_workers] \
        + cluster.decode_engines
    out = {"tokens": [h.tokens for h in handles],
           "clocks": [(h.submit_clock, h.first_token_clock, h.done_clock)
                      for h in handles],
           "modeled": dg_modeled(runs), "wall_s": walls["direct"],
           "counts": ts_run_counts({"direct": tracers}, launches),
           "sanitizer": sanitize_report(tracers),
           "handoff_uses": dg_uses_after_pages(tracers[0]),
           "mesh": grid.layout.as_dict(),
           "one_grid": all(e.grid is grid for e in engines),
           "decode_pool_sha256": ts_pool_digest(cluster.decode_engines[0])}
    if rank == 0:
        out["divergences"] = ts_divergences(
            m32, p32, device, out["tokens"], refs["tokens"]["direct"],
            [r.prompt_tokens for r in trace])
    del runs, cluster, engines, m32, p32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ts_dp(rank, device, one_card, full_model, full_params, refs):
    """(h) on one (data 2, model 2) grid, joined once by its first
    engine: the fp32 run against (a)'s one-card run (``one_card``), the
    bf16 run on ``SERVE_DEPTH`` layers (``ts_full_depth``), and (f)'s
    direct cluster in fp32 against one card's (``refs``)."""
    t0 = time.perf_counter()
    out = {}
    out["fp32"], grid = ts_dp_fp32(rank, device, one_card)
    dp_progress(rank, "(h) fp32", t0, {k: out["fp32"][k] for k in (
        "wall_s", "kv", "launches")}, phase=13)
    out["bf16"] = ts_full_depth(device, TS_DP_MODEL, grid)
    dp_progress(rank, "(h) bf16", t0, {k: out["bf16"][k] for k in (
        "wall_s", "kv", "launches")}, phase=13)
    out["disagg"] = ts_dp_disagg(rank, device, full_model, full_params,
                                 refs["fp32_cut"], grid)
    dp_progress(rank, "(h) disagg", t0, out["disagg"]["modeled"], phase=13)
    grid.close()
    out["seconds"] = time.perf_counter() - t0
    return out


# (i): the engine serving olmoe-1b-7b at full width (64 experts, 32 a rank)
# on the first ``SERVE_DEPTH`` layers on a (data 2, model 2) lease, on
# phase 9's trace
TS_MOE_ARCH = "olmoe-1b-7b"


def ts_moe_routing(eng):
    """Record the routing of every expert layer of ``eng``'s model calls,
    in call order: the list of calls, each ``{"kind": "prefill" or
    "decode", "layers": [{"expert_idx", "kept", "gap"}]}`` of the
    tokens the call routed (a decode call on a data grid: the rank's
    block's real rows)."""
    from repro_torch.models import moe

    calls = []

    def wrap(fn, kind):
        def call(*args):
            with moe.record_routing() as rec:
                out = fn(*args)
            calls.append({"kind": kind, "layers": [
                {"expert_idx": r["expert_idx"][0].tolist(),
                 "kept": r["kept"][0].int().tolist(),
                 "gap": r["gap"][0].tolist()} for r in rec]})
            return out
        return call
    eng.model = dataclasses.replace(
        eng.model, prefill_at=wrap(eng.model.prefill_at, "prefill"),
        decode_paged=wrap(eng.model.decode_paged, "decode"))
    return calls


def ts_moe_first_flip(runs, one_card):
    """Where the ranks' routing first parts from one card's: every call's
    routing put together (a prefill's from rank 0, a decode step's from
    the data ranks' blocks in order), compared call by call and layer by
    layer with ``one_card``'s.  Returns None where they never part, else
    the first differing layer's tokens whose experts differ, each with
    its router gap on both paths, the keep bits that differ, and whether
    it is a routing tie: experts that differ, each at a gap under
    ``GAP_NOISE`` (a later keep bit follows from them)."""
    blocks = sorted({r["data_index"]: r["routing"] for r in runs}.items())
    for i, want in enumerate(one_card):
        got = (blocks[0][1][i] if want["kind"] == "prefill" else {
            "layers": [{k: sum((b[1][i]["layers"][l][k] for b in blocks),
                               []) for k in ("expert_idx", "kept", "gap")}
                       for l in range(len(want["layers"]))]})
        for layer, (a, b) in enumerate(zip(got["layers"], want["layers"])):
            if a["expert_idx"] == b["expert_idx"] and a["kept"] == b["kept"]:
                continue
            flips = [{"token": t, "gap": a["gap"][t], "gap_one_card":
                      b["gap"][t]}
                     for t, (x, y) in enumerate(zip(a["expert_idx"],
                                                    b["expert_idx"]))
                     if x != y]
            keep = sum(x != y for p, q in zip(a["kept"], b["kept"])
                       for x, y in zip(p, q))
            return {"call": i, "kind": want["kind"], "layer": layer,
                    "flips": flips[:8], "n_flips": len(flips),
                    "keep_differences": keep,
                    "tie": bool(flips) and all(
                        max(f["gap"], f["gap_one_card"]) < GAP_NOISE
                        for f in flips)}
    return None


def ts_moe(rank, device):
    """(i): phase 9's trace in fp32 on the first ``SERVE_DEPTH`` layers of
    olmoe-1b-7b on a (data 2, model 2) lease, rank 0 also serving it on
    one card (``Engine.local``, the same weights) and taking one card's
    top-2 margin wherever the ranks' tokens part from its; then in bf16
    on phase 9's bf16 pages, one card's bf16 run beside (rank 0)."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.obs import Tracer
    from repro_torch.serve import Engine

    t0 = time.perf_counter()
    out = {}
    grid = None
    for compute, cache in (("float32", "float32"),
                           ("bfloat16", "bfloat16")):
        cfg = cut(TS_MOE_ARCH, SERVE_DEPTH, compute_dtype=compute)
        model = build_model(cfg, device=device)
        tracer = Tracer(1 << 20)
        eng, trace = ts_engine(model, device, tracer, TS_DP_MODEL, grid,
                               cache)
        grid = eng.grid
        gate = compute == "float32"
        routing = ts_moe_routing(eng) if gate else None
        run = ts_timed_run(eng, trace, tracer)
        if gate:
            run.update(routing=routing, data_index=grid.index(("data",)))
        del eng
        if rank == 0:
            ecfg, budget, _ = serve_parts(cfg)
            one = Engine.local(
                model, dataclasses.replace(ecfg, cache_dtype=cache),
                budget=budget, device=device,
                generator=torch.Generator(device=device).manual_seed(0))
            if gate:
                run["one_card_routing"] = ts_moe_routing(one)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = ts_run(one, trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            run["one_card"] = {
                "wall_s": wall,
                "decode_tokens_per_wall_s": want["tokens_decoded"] / wall,
                "clocks_equal": run["clocks"] == want["clocks"],
                "latency_equal": run["latency"] == want["latency"],
                "kv_equal": run["kv"] == want["kv"],
                "requests_parting": sum(a != b for a, b in zip(
                    run["tokens"], want["tokens"]))}
            if gate:
                run["one_card"]["divergences"] = ts_divergences(
                    model, one.params, device, run["tokens"],
                    want["tokens"], [r.prompt_tokens for r in trace])
            del one
        out[compute] = run
        del model
        gc.collect()
        torch.cuda.empty_cache()
        dp_progress(rank, f"(i) {compute}", t0, {k: run[k] for k in (
            "wall_s", "kv", "launches")}, phase=13)
    grid.close()
    out["seconds"] = time.perf_counter() - t0
    return out


def ts_rank(rank: int, refs=None) -> dict:
    """Phase 13 in one rank of phase 12's world: (a)-(e), and with
    ``refs`` (f), (g) and (h)."""
    import torch
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out = {"fp32_gate": ts_fp32_gate(rank, device)}
    dp_progress(rank, "(a)", t0, out["fp32_gate"].get("one_card"),
                phase=13)
    out["full_depth"] = ts_full_depth(device)
    dp_progress(rank, "(b)", t0, {k: out["full_depth"][k] for k in (
        "wall_s", "kv", "launches")}, phase=13)
    out["kernels"] = ts_kernels(device)
    t1 = time.perf_counter()
    out["session_gate"] = ts_session_gate(rank, device)
    dp_progress(rank, "(d) fp32 gate", t0, {k: v.get("one_card") for k, v
                                             in out["session_gate"].items()},
                phase=13)
    out["session_full"] = ts_session_full(device)
    dp_progress(rank, "(d) full depth", t0, {
        k: {f: v[f] for f in ("prefill_s", "decode_s", "collective_host_s")}
        for k, v in out["session_full"].items()}, phase=13)
    t2 = time.perf_counter()
    out["tenants"] = ts_tenants(rank, device)
    dp_progress(rank, "(e)", t0, {k: out["tenants"][k] for k in (
        "wall_s", "arbiter", "one_card") if k in out["tenants"]}, phase=13)
    t3 = time.perf_counter()
    if refs is not None:
        full, params = ts_serve_model(device)
        out["disagg"] = ts_disagg(rank, device, full, params,
                                  refs["disagg"])
        dp_progress(rank, "(f)", t0, {k: out["disagg"][k]["seconds"]
                                      for k in ("fp32", "bf16")}, phase=13)
        t4 = time.perf_counter()
        out["colo"] = ts_colo(rank, device, params, refs["colo"])
        dp_progress(rank, "(g)", t0, out["colo"]["seconds"], phase=13)
        t5 = time.perf_counter()
        out["dp"] = ts_dp(rank, device, out["fp32_gate"].get("one_card_run"),
                          full, params, refs["disagg"])
        del full, params
        gc.collect()
        torch.cuda.empty_cache()
        out["seconds_f_g"] = {"f": t4 - t3, "g": t5 - t4,
                              "h": time.perf_counter() - t5}
    out["seconds_d_e"] = {"d": t2 - t1, "e": t3 - t2}
    return out


def ts_checks(smi, per, qwen_run, refs=None):
    """Phase 13's lines and checks from every rank's report (with
    ``refs``, (f)'s, (g)'s and (h)'s too; ``qwen_run``: one card's bf16
    run on (b)'s cut, ``ts_one_card_run``); returns each rank's
    launches."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen1.5-0.5b")
    gate = [p["fp32_gate"] for p in per]
    one = gate[0]["one_card"]
    emit({"phase": "tp serve", "check": "(a) fp32 gate", "nvidia_smi": smi,
          "arch": cfg.name, "layers": TRAIN_CUT, "lease": {"data": 1,
                                                           "model": TS_MODEL},
          "ranks": TS_RANKS, "tie_margin": TS_TIE_MARGIN,
          "kv": gate[0]["kv"], "latency_modeled": gate[0]["latency"],
          "one_card": one})
    check(all(g["tokens"] == gate[0]["tokens"] and g["kv"] == gate[0]["kv"]
              and g["clocks"] == gate[0]["clocks"] for g in gate),
          "phase 13 (a): the ranks' runs differ")
    check(one["clocks_equal"] and one["latency_equal"] and one["kv_equal"]
          and all(d["tie"] for d in one["divergences"])
          and gate[0]["kv"]["spills"] > 0 and gate[0]["kv"]["fetches"] > 0,
          f"phase 13 (a): against the one-card fp32 engine: {one}")
    full = [p["full_depth"] for p in per]
    b0 = full[0]
    L = SERVE_DEPTH
    parting = sum(a != b for a, b in zip(b0["tokens"], qwen_run["tokens"]))
    emit({"phase": "tp serve", "check": "(b) full width, cut depth",
          "nvidia_smi": smi, "arch": cfg.name, "layers": L,
          "lease": {"data": 1, "model": TS_MODEL}, "ranks": TS_RANKS,
          "rules": b0["rules"],
          "requests_parting_one_card_bf16": parting,
          "per_rank": [{k: f[k] for k in f if k not in ("tokens", "clocks")}
                       for f in full]})
    counts = {}
    for r, f in enumerate(full):
        check(f["completed"] == 16 and f["failed_oom"] == 0
              and f["kv"]["spills"] > 0 and f["kv"]["fetches"] > 0
              and f["tokens"] == b0["tokens"] and f["clocks"] == b0["clocks"]
              and f["trace_dropped"] == 0
              and all(0 <= t < cfg.vocab for h in f["tokens"] for t in h),
              f"phase 13 (b) rank {r}: {f['kv']}, {f['completed']} done")
        n = f["launches"]
        check(n["paged_attention"] == f["decodes"] * L
              and n["flash_attention"] == f["prefills"] * L
              and n["rmsnorm"] == (f["decodes"] + f["prefills"]) * (2 * L + 1),
              f"phase 13 (b) rank {r}: launches {n} for {f['decodes']} "
              f"decode steps and {f['prefills']} prefills")
        check_flash_variant(f"phase 13 rank {r}", cfg.compute_dtype,
                            f["variants"], n["flash_attention"])
        counts[f"qwen1.5-0.5b serve tp rank {r}"] = dict(n)
    kern = [p["kernels"] for p in per]
    emit({"phase": "tp serve", "check": "(c) B1-B3 at a rank's shapes",
          "tol": TOL["bfloat16"], "per_rank": kern})
    check(all(k["ok"] for ks in kern for k in ks.values()),
          f"phase 13 (c): {kern}")
    counts.update(ts_session_checks(smi, per))
    counts.update(ts_tenant_checks(smi, per))
    if refs is not None:
        counts.update(ts_disagg_checks(smi, per, refs["disagg"]))
        counts.update(ts_colo_checks(smi, per, refs["colo"]))
        counts.update(ts_dp_checks(smi, per, refs["disagg"], qwen_run))
    counts.update(ts_moe_checks(smi, per))
    counts.update(ts_ssm_checks(smi, per))
    counts.update(ts_encdec_checks(smi, per))
    emit({"phase": "tp serve", "seconds_d_e": [p["seconds_d_e"]
                                               for p in per],
          "seconds_f_g": [p.get("seconds_f_g") for p in per]})
    return counts


def ts_dp_checks(smi, per, refs, qwen_run):
    """Phase 13 (h)'s lines and checks; returns each rank's launches."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen1.5-0.5b")
    h = [p["dp"] for p in per]
    h0 = h[0]
    want = per[0]["fp32_gate"]["one_card_run"]
    counts = {}
    # 1: fp32 on 2 layers against (a)'s one-card run
    a0 = h0["fp32"]
    emit({"phase": "tp serve", "check": "(h) fp32 against one card",
          "nvidia_smi": smi, "arch": cfg.name, "layers": TRAIN_CUT,
          "lease": TS_DP_MESH, "ranks": TS_RANKS,
          "tie_margin": TS_TIE_MARGIN, "kv": a0["kv"],
          "latency_modeled": a0["latency"],
          "divergences": a0["divergences"],
          "per_rank": [{k: x["fp32"][k] for k in (
              "wall_s", "kv_heads", "batch_axes", "pool_sha256",
              "launches", "sanitizer")} for x in h]})
    digests = {}
    for r, x in enumerate(h):
        a = x["fp32"]
        check(a["tokens"] == a0["tokens"] and a["mesh"] == TS_DP_MESH
              and a["batch_axes"] == ["data"],
              f"phase 13 (h) fp32 rank {r}: tokens differ from rank 0's, "
              f"or a grid {a['mesh']} splitting rows over "
              f"{a['batch_axes']}")
        check(a["clocks"] == want["clocks"]
              and a["latency"] == want["latency"] and a["kv"] == want["kv"]
              and a["completed"] == 16 and a["failed_oom"] == 0
              and a["kv"]["spills"] > 0 and a["kv"]["fetches"] > 0,
              f"phase 13 (h) fp32 rank {r}: clocks, latency or KV stats "
              f"{a['kv']} differ from one card's {want['kv']}")
        ts_trace_check(f"phase 13 (h) fp32 rank {r}", a["sanitizer"])
        ts_launch_checks(f"phase 13 (h) fp32 rank {r}", {"run": a},
                         TRAIN_CUT, "float32")
        heads = tuple(a["kv_heads"])
        check(digests.setdefault(heads, a["pool_sha256"])
              == a["pool_sha256"],
              f"phase 13 (h) fp32 rank {r}: its pool of kv heads {heads} "
              f"differs in bits from its data replica's")
    check(len(digests) == TS_DP_MODEL
          and all(d["tie"] for d in a0["divergences"]),
          f"phase 13 (h) fp32: tokens part from one card's off a tie: "
          f"{a0['divergences']}")
    # 2: bf16 on SERVE_DEPTH layers, beside (b)'s (data 1, model 4) and
    # one card's on the same cut
    b0 = h0["bf16"]
    L = SERVE_DEPTH
    keep = ("wall_s", "decode_tokens_per_wall_s", "collective_host_s",
            "collective_host_s_per_engine_step_by_op", "collective_calls",
            "moved_bytes", "peak_mem_gb", "launches", "decodes", "prefills",
            "engine_steps", "sanitizer")
    emit({"phase": "tp serve", "check": "(h) bf16, cut depth",
          "nvidia_smi": smi, "arch": cfg.name, "layers": L,
          "lease": TS_DP_MESH, "ranks": TS_RANKS, "rules": b0["rules"],
          "requests_parting_one_card_bf16": sum(
              a != b for a, b in zip(b0["tokens"], qwen_run["tokens"])),
          "one_card": {k: qwen_run[k] for k in (
              "wall_s", "decode_tokens_per_wall_s")},
          "data1_model4": [{k: p["full_depth"][k] for k in (
              "wall_s", "decode_tokens_per_wall_s", "collective_host_s")}
              for p in per],
          "per_rank": [{k: x["bf16"][k] for k in keep} for x in h]})
    for r, x in enumerate(h):
        b = x["bf16"]
        check(b["tokens"] == b0["tokens"] and b["clocks"] == b0["clocks"]
              and b["kv"] == b0["kv"] and b["mesh"] == TS_DP_MESH
              and b["completed"] == 16 and b["failed_oom"] == 0
              and b["kv"]["spills"] > 0 and b["kv"]["fetches"] > 0
              and b["trace_dropped"] == 0
              and all(0 <= t < cfg.vocab for q in b["tokens"] for t in q),
              f"phase 13 (h) bf16 rank {r}: {b['kv']}, {b['completed']} "
              f"done, tokens equal rank 0's: {b['tokens'] == b0['tokens']}")
        ts_trace_check(f"phase 13 (h) bf16 rank {r}", b["sanitizer"])
        ts_launch_checks(f"phase 13 (h) bf16 rank {r}", {"run": b}, L,
                         cfg.compute_dtype)
        check(b["collective_calls"].get("data:all-gather") == b["decodes"],
              f"phase 13 (h) bf16 rank {r}: {b['collective_calls']} for "
              f"{b['decodes']} decode steps (one gather over data each)")
    # 3: (f)'s direct cluster in fp32 against one card's
    d0 = h0["disagg"]
    emit({"phase": "tp serve", "check": "(h) disagg direct fp32",
          "nvidia_smi": smi, "arch": cfg.name, "layers": TRAIN_CUT,
          "lease": f"a gang of prefill and decode, {TS_DP_MESH} each",
          "ranks": TS_RANKS, "modeled": d0["modeled"],
          "divergences": d0["divergences"],
          "per_rank": [{k: x["disagg"][k] for k in (
              "wall_s", "counts", "sanitizer", "handoff_uses",
              "decode_pool_sha256")} for x in h]})
    digests = {}
    for r, (x, p) in enumerate(zip(h, per)):
        d = x["disagg"]
        one = {m: {"direct": v["direct"]} for m, v
               in refs["fp32_cut"]["modeled"].items() if "direct" in v}
        check(d["tokens"] == d0["tokens"] and d["modeled"] == one
              and d["clocks"] == refs["fp32_cut"]["clocks"]["direct"],
              f"phase 13 (h) disagg rank {r}: tokens differ from rank "
              f"0's, or modeled numbers {d['modeled']} != one card's "
              f"{one}")
        uses, ok = d["handoff_uses"]
        check(uses == d["modeled"]["handoffs"]["direct"] > 0 and ok
              and d["sanitizer"]["checks"].get("disagg-handoff", 0) > 0
              and d["one_grid"] and d["mesh"] == TS_DP_MESH,
              f"phase 13 (h) disagg rank {r}: {uses} handoff uses, a use "
              f"before its last page: {not ok}, one grid {d['one_grid']}")
        ts_trace_check(f"phase 13 (h) disagg rank {r}", d["sanitizer"])
        ts_launch_checks(f"phase 13 (h) disagg rank {r}", d["counts"],
                         TRAIN_CUT, "float32")
        heads = tuple(x["fp32"]["kv_heads"])
        check(digests.setdefault(heads, d["decode_pool_sha256"])
              == d["decode_pool_sha256"],
              f"phase 13 (h) disagg rank {r}: its decode pool differs in "
              f"bits from its data replica's")
        counts[f"qwen1.5-0.5b serve dp rank {r}"] = {
            k: x["fp32"]["launches"].get(k, 0) + x["bf16"]["launches"].get(
                k, 0) + ts_sum_launches(d["counts"]).get(k, 0)
            for k in x["bf16"]["launches"]}
    check(all(v["tie"] for v in d0["divergences"]),
          f"phase 13 (h) disagg: tokens part from one card's off a tie: "
          f"{d0['divergences']}")
    emit({"phase": "tp serve", "check": "(h) seconds",
          "per_rank": [x["seconds"] for x in h]})
    return counts


def ts_moe_checks(smi, per):
    """Phase 13 (i)'s lines and checks; returns each rank's launches."""
    cfg = cut(TS_MOE_ARCH, SERVE_DEPTH)
    L = SERVE_DEPTH
    runs = [p["moe"] for p in per]
    counts = {}
    keep = ("wall_s", "decode_tokens_per_wall_s", "collective_host_s",
            "collective_host_s_per_engine_step_by_op", "collective_calls",
            "moved_bytes", "peak_mem_gb", "launches", "decodes", "prefills",
            "engine_steps", "kv_heads", "pool_sha256", "sanitizer")
    for compute in ("float32", "bfloat16"):
        r0 = runs[0][compute]
        one = r0["one_card"]
        emit({"phase": "tp serve", "check": f"(i) moe engine {compute}",
              "nvidia_smi": smi, "arch": cfg.name, "layers": L,
              "experts": cfg.n_experts,
              "experts_a_rank": cfg.n_experts // TS_DP_MODEL,
              "capacity_factor": cfg.capacity_factor, "lease": TS_DP_MESH,
              "ranks": TS_RANKS, "tie_margin": TS_TIE_MARGIN,
              "kv": r0["kv"], "latency_modeled": r0["latency"],
              "one_card": one,
              "per_rank": [{k: x[compute][k] for k in keep} for x in runs]})
        digests = {}
        for r, x in enumerate(runs):
            a = x[compute]
            check(a["tokens"] == r0["tokens"] and a["clocks"] == r0["clocks"]
                  and a["kv"] == r0["kv"] and a["mesh"] == TS_DP_MESH
                  and a["batch_axes"] == ["data"]
                  and a["completed"] == 16 and a["failed_oom"] == 0
                  and a["kv"]["spills"] > 0 and a["kv"]["fetches"] > 0
                  and a["trace_dropped"] == 0
                  and all(0 <= t < cfg.vocab for q in a["tokens"] for t in q),
                  f"phase 13 (i) {compute} rank {r}: {a['kv']}, "
                  f"{a['completed']} done, tokens equal rank 0's: "
                  f"{a['tokens'] == r0['tokens']}, on {a['mesh']} over "
                  f"{a['batch_axes']}")
            ts_trace_check(f"phase 13 (i) {compute} rank {r}",
                           a["sanitizer"])
            ts_launch_checks(f"phase 13 (i) {compute} rank {r}", {"run": a},
                             L, compute)
            calls = a["collective_calls"]
            check(calls.get("data:all-gather") == a["decodes"]
                  and calls.get("data:all-gather:moe-experts")
                  == a["decodes"] * L
                  and calls.get("model:all-reduce:moe")
                  == (a["decodes"] + a["prefills"]) * L,
                  f"phase 13 (i) {compute} rank {r}: {calls} for "
                  f"{a['decodes']} decode steps and {a['prefills']} "
                  f"prefills of {L} layers")
            heads = tuple(a["kv_heads"])
            check(digests.setdefault(heads, a["pool_sha256"])
                  == a["pool_sha256"],
                  f"phase 13 (i) {compute} rank {r}: its pool of kv heads "
                  f"{heads} differs in bits from its data replica's")
            c = counts.setdefault(f"olmoe-1b-7b serve dp rank {r}", {})
            for k, v in a["launches"].items():
                c[k] = c.get(k, 0) + v
        check(len(digests) == TS_DP_MODEL,
              f"phase 13 (i) {compute}: pools of {sorted(digests)}")
        if compute == "float32":
            # a divergence passes as a documented tie (C-ref3): a top-2
            # logit margin within fp32 noise, or where the routing first
            # parts from one card's, a router top-k decision at a gap
            # under GAP_NOISE (the ranks sum the expert and attention
            # outputs over model in another order than one card)
            flip = ts_moe_first_flip([x[compute] for x in runs],
                                     r0["one_card_routing"])
            emit({"phase": "tp serve", "check": "(i) moe routing fp32",
                  "gap_noise": GAP_NOISE, "first_difference": flip})
            check(one["clocks_equal"] and one["latency_equal"]
                  and one["kv_equal"]
                  and (all(d["tie"] for d in one["divergences"])
                       or (flip is not None and flip["tie"])),
                  f"phase 13 (i) fp32: against the one-card engine: {one}, "
                  f"the routing first parting at {flip}")
    emit({"phase": "tp serve", "check": "(i) seconds",
          "per_rank": [x["seconds"] for x in runs]})
    return counts


def ts_session_checks(smi, per):
    """Phase 13 (d)'s lines and checks; returns each rank's launches of
    the bf16 run on each grid."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen1.5-0.5b")
    L, G = SERVE_DEPTH, TS_SESSION["generate"]
    counts = {}
    for name in TS_SESSION_GRIDS:
        gate = [p["session_gate"][name] for p in per]
        one = gate[0]["one_card"]
        emit({"phase": "tp serve", "check": "(d) session fp32 gate",
              "grid": name, "mesh": gate[0]["mesh"], "nvidia_smi": smi,
              "arch": cfg.name, "layers": TRAIN_CUT,
              "batch": TS_SESSION["batch"], "prompt": TS_SESSION["prompt"],
              "generate": TS_SESSION_GATE_GEN, "tol": TOL["float32"],
              "tie_margin": TS_TIE_MARGIN, "ranks": TS_RANKS,
              "one_card": one})
        check(all(g["tokens"] == gate[0]["tokens"] for g in gate),
              f"phase 13 (d) {name}: the ranks' fp32 tokens differ")
        check(one["max_rel_err"] <= TOL["float32"]
              and all(d["tie"] for d in one["parted"]),
              f"phase 13 (d) {name}: against the one-card fp32 session: "
              f"{one}")
        full = [p["session_full"][name] for p in per]
        f0 = full[0]
        emit({"phase": "tp serve", "check": "(d) session full width, cut "
              "depth", "grid": name, "mesh": f0["mesh"], "nvidia_smi": smi,
              "arch": cfg.name, "layers": L, "compute": cfg.compute_dtype,
              **TS_SESSION, "ranks": TS_RANKS, "rules": f0["rules"],
              "per_rank": [{k: f[k] for k in f if k != "tokens"}
                           for f in full]})
        want = {"paged_attention": 0, "flash_attention": L * G,
                "rmsnorm": (2 * L + 1) * G}
        for r, f in enumerate(full):
            n = f["launches"]
            check(f["tokens"] == f0["tokens"] and f["finite"]
                  and len(f["tokens"]) == TS_SESSION["batch"]
                  and all(len(t) == G and all(0 <= x < cfg.vocab for x in t)
                          for t in f["tokens"]),
                  f"phase 13 (d) {name} rank {r}: tokens differ from rank "
                  f"0's or are not {G} in the vocab a row")
            check(all(n.get(k, 0) == v for k, v in want.items()),
                  f"phase 13 (d) {name} rank {r}: launches {n} != {want}")
            check_flash_variant(f"phase 13 (d) {name} rank {r}",
                                cfg.compute_dtype, f["variants"],
                                n["flash_attention"])
            counts[f"qwen1.5-0.5b session {name} rank {r}"] = dict(n)
    return counts


def ts_tenant_checks(smi, per):
    """Phase 13 (e)'s line and checks; returns each rank's launches."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen1.5-0.5b")
    L = TRAIN_CUT
    ten = [p["tenants"] for p in per]
    t0 = ten[0]
    one = t0["one_card"]
    counts = {}
    emit({"phase": "tp serve", "check": "(e) two tenants over one arbiter",
          "nvidia_smi": smi, "arch": cfg.name, "layers": TRAIN_CUT,
          "compute": "float32", "mesh": t0["mesh"], "pages": TS_MT_PAGES,
          "ranks": TS_RANKS, "tie_margin": TS_TIE_MARGIN,
          "arbiter": t0["arbiter"], "one_card": one,
          "per_rank": [{k: t[k] for k in t if k not in (
              "tokens", "clocks", "arbiter", "one_card")} for t in ten]})
    for r, t in enumerate(ten):
        check(t["tokens"] == t0["tokens"] and t["clocks"] == t0["clocks"]
              and t["arbiter"] == t0["arbiter"] and t["one_grid"]
              and t["sanitizer"]["ok"] and t["trace_dropped"] == 0
              and t["checked"] > 0 and t["failed_oom"] == [0, 0]
              and sum(t["completed"]) == 16
              and t["pool_kv_heads"] == cfg.n_kv_heads // TS_MODEL,
              f"phase 13 (e) rank {r}: {t}")
        n = t["launches"]
        check(n["paged_attention"] == t["decodes"] * L
              and n["flash_attention"] == t["prefills"] * L
              and n["rmsnorm"] == (t["decodes"] + t["prefills"]) * (2 * L + 1),
              f"phase 13 (e) rank {r}: launches {n} for {t['decodes']} "
              f"decode steps and {t['prefills']} prefills")
        check_flash_variant(f"phase 13 (e) rank {r}", "float32",
                            t["variants"], n["flash_attention"])
        counts[f"qwen1.5-0.5b tenants tp rank {r}"] = dict(n)
    check(one["clocks_equal"] and one["arbiter_equal"]
          and all(d["tie"] for d in one["divergences"])
          and one["pool_kv_heads"] == cfg.n_kv_heads
          and one["page_bytes"] == t0["page_bytes"]
          and t0["arbiter"]["revoked_pages"] > 0,
          f"phase 13 (e): against the one-card two-tenant run: {one}")
    return counts


def ts_launch_checks(what, per_run, L, compute):
    """Every run's B1, B3 and B2 launches exact for its decode steps and
    prefills (``L`` layers); flash on ``compute``'s kernel."""
    for name, c in per_run.items():
        n, d, p = c["launches"], c["decodes"], c["prefills"]
        check(n["paged_attention"] == d * L
              and n["flash_attention"] == p * L
              and n["rmsnorm"] == (d + p) * (2 * L + 1),
              f"{what} {name}: launches {n} for {d} decode steps and {p} "
              f"prefills of {L} layers")
        check_flash_variant(f"{what} {name}", compute, c["variants"],
                            n["flash_attention"])


def ts_sum_launches(per_run) -> dict:
    out = {}
    for c in per_run.values():
        for k, v in c["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def ts_trace_check(what, rep):
    check(rep["violations"] == 0 and rep["problems"] == 0
          and rep["dropped"] == 0,
          f"{what}: the sanitizer or the trace export found faults, or "
          f"the ring dropped events:\n{rep['first']}")


def ts_disagg_checks(smi, per, refs):
    """Phase 13 (f)'s lines and checks; returns each rank's launches."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen1.5-0.5b")
    L = SERVE_DEPTH
    f = [p["disagg"] for p in per]
    f0 = f[0]
    ref32, ref16 = refs["fp32_cut"], refs["bf16"]
    emit({"phase": "tp serve", "check": "(f) disagg fp32", "nvidia_smi": smi,
          "arch": cfg.name, "layers": TRAIN_CUT, "ranks": TS_RANKS,
          "lease": "a gang of prefill and decode, (data 1, model 4) each",
          "tie_margin": TS_TIE_MARGIN, "modeled": f0["fp32"]["modeled"],
          "modeled_equal_one_card": f0["fp32"]["modeled"]
          == ref32["modeled"],
          "divergences": f0["fp32"]["divergences"],
          "per_rank": [{k: x["fp32"][k] for k in (
              "seconds", "wall_s", "sanitizer", "handoff_uses")}
              for x in f]})
    counts = {}
    for r, x in enumerate(f):
        a = x["fp32"]
        check(a["tokens"] == f0["fp32"]["tokens"]
              and a["degenerate"]["tokens"]
              == f0["fp32"]["degenerate"]["tokens"],
              f"phase 13 (f) fp32 rank {r}: tokens differ from rank 0's")
        check(a["modeled"] == ref32["modeled"]
              and a["clocks"] == ref32["clocks"]
              and a["degenerate"]["clocks"] == ref32["degenerate"]["clocks"],
              f"phase 13 (f) fp32 rank {r}: modeled numbers "
              f"{a['modeled']} != one card's {ref32['modeled']}")
        check(a["degenerate"]["tokens_identical"]
              and a["degenerate"]["events_identical"]
              and a["degenerate"]["done"],
              f"phase 13 (f) fp32 rank {r}: the degenerate cluster is not "
              f"the engine's run: {a['degenerate']}")
        uses, ok = a["handoff_uses"]
        check(uses == a["modeled"]["handoffs"]["direct"] and ok,
              f"phase 13 (f) fp32 rank {r}: {uses} handoff uses, a use "
              f"before its last page: {not ok}")
        ts_trace_check(f"phase 13 (f) fp32 rank {r}", a["sanitizer"])
        ts_launch_checks(f"phase 13 (f) fp32 rank {r}", a["counts"],
                         TRAIN_CUT, "float32")
        b = x["bf16"]
        check(b["tokens"] == f0["bf16"]["tokens"]
              and b["modeled"] == f0["bf16"]["modeled"],
              f"phase 13 (f) bf16 rank {r}: tokens or modeled numbers "
              f"differ from rank 0's")
        check(co_close(b["modeled"], ref16["modeled"], CO_REL),
              f"phase 13 (f) bf16 rank {r}: modeled numbers {b['modeled']} "
              f"not within {CO_REL} of phase 7's {ref16['modeled']}")
        m = b["modeled"]["decode_p95_s"]
        check(m["colocated"] >= 2.0 * m["direct"],
              f"phase 13 (f) bf16 rank {r}: fig12's decode p95 claim: "
              f"colocated {m['colocated']} < 2 x direct {m['direct']}")
        uses, ok = b["handoff_uses"]
        check(uses == b["modeled"]["handoffs"]["direct"] and ok,
              f"phase 13 (f) bf16 rank {r}: {uses} handoff uses, a use "
              f"before its last page: {not ok}")
        ts_trace_check(f"phase 13 (f) bf16 rank {r}", b["sanitizer"])
        ts_launch_checks(f"phase 13 (f) bf16 rank {r}", b["counts"], L,
                         cfg.compute_dtype)
        check(b["one_grid"] and b["mesh"] == {"data": 1, "model": TS_MODEL}
              and b["kv_heads"][1] - b["kv_heads"][0]
              == cfg.n_kv_heads // TS_MODEL,
              f"phase 13 (f) rank {r}: the tiers' grid {b['mesh']}, one "
              f"grid {b['one_grid']}, kv heads {b['kv_heads']}")
        counts[f"qwen1.5-0.5b disagg tp rank {r}"] = {
            k: ts_sum_launches(a["counts"]).get(k, 0)
            + ts_sum_launches(b["counts"]).get(k, 0)
            for k in ts_sum_launches(b["counts"])}
    div = f0["fp32"]["divergences"]
    check(all(d["tie"] for ds in div.values() for d in ds),
          f"phase 13 (f) fp32: tokens part from one card's off a tie: "
          f"{div}")
    b0 = f0["bf16"]
    emit({"phase": "tp serve", "check": "(f) disagg bf16",
          "nvidia_smi": smi, "arch": cfg.name, "layers": L,
          "ranks": TS_RANKS, "requests": DG_REQUESTS,
          "modeled": b0["modeled"], "phase_7_modeled": ref16["modeled"],
          "modeled_equal_phase_7": b0["modeled"] == ref16["modeled"],
          "tokens_equal_phase_7": b0["tokens"] == ref16["tokens"],
          "divergences_from_phase_7": b0["divergences"],
          "per_rank": [{k: x["bf16"][k] for k in (
              "seconds", "wall_s", "decode_tokens_per_wall_s",
              "collective_host_s", "collective_host_s_by_op",
              "collective_calls", "peak_mem_gb", "counts", "sanitizer",
              "handoff_uses")} for x in f]})
    return counts


def ts_colo_checks(smi, per, refs):
    """Phase 13 (g)'s line and checks; returns each rank's launches."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen1.5-0.5b")
    g = [p["colo"] for p in per]
    g0 = g[0]
    emit({"phase": "tp serve", "check": "(g) colo fp32", "nvidia_smi": smi,
          "arch": cfg.name, "layers": CO_SHALLOW, "ranks": TS_RANKS,
          "lease": {"data": 1, "model": TS_MODEL},
          "requests_per_tenant": CO_REQUESTS, "train_steps": CO_STEPS,
          "claims": g0["claims"], "modeled_equal_one_card":
              g0["modeled"] == refs["modeled"],
          "tokens_equal_one_card": g0["tokens"] == refs["tokens"],
          "divergences": g0["divergences"], "tie_margin": TS_TIE_MARGIN,
          "per_rank": [{k: x[k] for k in (
              "seconds", "wall_s", "decode_tokens_per_wall_s",
              "collective_host_s", "collective_host_s_by_op",
              "collective_calls", "peak_mem_gb", "counts", "sanitizer")}
              for x in g]})
    counts = {}
    for r, x in enumerate(g):
        check(x["tokens"] == g0["tokens"],
              f"phase 13 (g) rank {r}: tokens differ from rank 0's")
        check(x["modeled"] == refs["modeled"]
              and x["page_bytes"] == refs["page_bytes"],
              f"phase 13 (g) rank {r}: modeled numbers {x['modeled']} != "
              f"one card's {refs['modeled']}")
        for k, v in x["claims"].items():
            check(v, f"phase 13 (g) rank {r}: fig11 claim {k} failed")
        ts_trace_check(f"phase 13 (g) rank {r}", x["sanitizer"])
        ts_launch_checks(f"phase 13 (g) rank {r}", x["counts"], CO_SHALLOW,
                         "float32")
        check(x["one_grid"] and x["mesh"] == {"data": 1, "model": TS_MODEL}
              and x["kv_heads"][1] - x["kv_heads"][0]
              == x["full_kv_heads"] // TS_MODEL,
              f"phase 13 (g) rank {r}: grid {x['mesh']}, one grid "
              f"{x['one_grid']}, kv heads {x['kv_heads']}")
        counts[f"qwen1.5-0.5b colo tp rank {r}"] = ts_sum_launches(
            x["counts"])
    div = g0["divergences"]
    check(all(d["tie"] for run in div.values() for ds in run.values()
              for d in ds),
          f"phase 13 (g): tokens part from one card's off a tie: {div}")
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
                   D=64, kv=f32, window=None, q=bf16):
        one = paged_inputs(gen, B, H, KV, D, ps, pmax, lens, q, kv, device)
        nbytes, flops = paged_work(one[0], one[1], lens, ps)
        reads = nbytes - one[0].numel() * one[0].element_size()   # - out
        sets = [one] + [paged_inputs(gen, B, H, KV, D, ps, pmax, lens,
                                     q, kv, device)
                        for _ in range(max(4, cold_copies(reads)) - 1)]
        ms = time_ms(lambda i: pa.paged_decode_attention(
            *sets[i], sliding_window=window), len(sets))
        plain = time_ms(lambda i: ref.paged_attention_ref(
            *sets[i], sliding_window=window), len(sets))
        b_ms, b_by = bound(nbytes, flops,
                           BF16_FLOPS if q == bf16 else FP32_FLOPS)
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
    # a rank's decode under phase 13's (data 1, model 4) lease: the
    # engine's 8 rows on 4 of qwen's 16 heads
    paged_time("tp rank (model 4) decode B=8 len 130..563 H=KV=4 D=64 "
               "ps=64 q=bf16 pages=fp32", 8, 64, 16,
               [130, 260, 520, 150, 300, 563, 200, 400], H=4, KV=4)
    # phase 13 (f)'s decode tier and (g)'s tenants on a rank's 4 heads
    paged_time("tp rank (model 4) disagg decode tier B=4 len 224..240 "
               "H=KV=4 D=64 ps=16 pages=15 q=bf16 pages=fp32", 4, 16, 15,
               [224, 229, 235, 240], H=4, KV=4)
    paged_time("tp rank (model 4) colo decode B=6 len 33..160 H=KV=4 D=64 "
               "ps=16 pages=10 q=fp32 pages=fp32", 6, 16, 10,
               [33, 48, 97, 128, 150, 160], H=4, KV=4, q=f32)
    # a rank's decode in phase 13 (h) on (data 2, model 2): its block of
    # the engine's 8-row bucket, 4 rows on 8 of the 16 heads
    paged_time("dp rank (data 2, model 2) decode B=4 len 130..520 H=KV=8 "
               "D=64 ps=64 q=bf16 pages=fp32", 4, 64, 16,
               [130, 260, 520, 150], H=8, KV=8)
    # phase 13 (i)'s rank: olmoe's 8 of 16 heads at D=128 over its bf16
    # pages, its block of the 8-row bucket
    paged_time("olmoe ep rank (data 2, model 2) decode B=4 len 130..520 "
               "H=KV=8 D=128 ps=64 q=bf16 pages=bf16", 4, 64, 16,
               [130, 260, 520, 150], H=8, KV=8, D=128, kv=bf16)

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
    flash_line("tp rank (model 4) prefill B=1 Sq=Skv=512 H=4 D=64 q=bf16 "
               "kv=fp32", flash_time(1, 512, 512, 4, 64))
    # phase 13 (j)'s rank: zamba2's shared block on 16 of its 32 heads,
    # its 4 rows of 512 over the session's fp32 cache
    flash_line("zamba2 session rank (data 2, model 2) prefill B=4 "
               "Sq=Skv=512 H=KV=16 D=112 q=bf16 kv=fp32",
               flash_time(4, 512, 512, 16, 112))
    # a rank's decode step of phase 13 (d)'s session at its last token
    # (512 prompt + 32 new over an fp32 cache of 544): its rows and
    # local heads on each grid
    for n_rows, heads, grid in ((4, 8, "data 2, model 2"),
                              (8, 4, "data 1, model 4")):
        flash_line(f"session rank ({grid}) decode B={n_rows} Sq=1 "
                   f"Skv=544 q_offset=543 kv_len=544 H=KV={heads} D=64 "
                   f"q=bf16 kv=fp32", flash_time(n_rows, 1, 544, heads, 64,
                                                 q_offset=543, kv_len=544))
    flash_line("fp32 q B=1 Sq=Skv=512 H=16 D=64 kv=fp32",
               flash_time(1, 512, 512, 16, 64, q_dtype=f32), variant="f32")
    # the moe and encdec paths: olmoe's 512-token prefill over its bf16
    # slot cache; whisper's non-causal encoder over 1500 frames and its
    # cross-attention (a 64-token prompt, one decode query) over them
    flash_line("olmoe prefill B=1 Sq=Skv=512 H=16 D=128 q=bf16 kv=bf16",
               flash_time(1, 512, 512, 16, 128, kv_dtype=bf16),
               max_abs_err=errs["flash_attention olmoe prefill"])
    # phase 13 (i)'s rank prefill on 8 of olmoe's 16 heads
    flash_line("olmoe ep rank (model 2) prefill B=1 Sq=Skv=512 H=8 D=128 "
               "q=bf16 kv=bf16", flash_time(1, 512, 512, 8, 128,
                                            kv_dtype=bf16))
    for tag, Sq in (("encoder", 1500), ("cross prefill", 64),
                    ("cross decode", 1)):
        flash_line(f"whisper {tag} B=4 Sq={Sq} Skv=1500 H=12 D=64 "
                   f"non-causal q=bf16 kv=bf16",
                   flash_time(4, Sq, 1500, 12, 64, kv_dtype=bf16,
                              causal=False),
                   max_abs_err=errs[f"flash_attention whisper {tag}"])
    # phase 12 (g)'s rank: whisper's encoder and cross-attention on 6 of
    # its 12 heads, its 4 rows of the 8
    for tag, Sq in (("encoder", 1500), ("cross", WHISPER_DEC_SEQ)):
        flash_line(f"whisper {tag} (model 2) rank B=4 Sq={Sq} Skv=1500 "
                   f"H=6 D=64 non-causal q=bf16 kv=bf16",
                   flash_time(4, Sq, 1500, 6, 64, kv_dtype=bf16,
                              causal=False))

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
             32, 112, bf16, True),
            # phase 12 (f)'s rank: 4 rows, 16 of zamba2's 32 heads
            ("zamba2 (model 2) rank train B=4 S=512 H=KV=16 D=112 causal",
             4, 512, 512, 16, 112, bf16, True),
            # phase 12 (g)'s rank: 4 rows, 6 of whisper's 12 heads
            ("whisper encoder (model 2) rank train B=4 S=1500 H=KV=6 D=64 "
             "non-causal", 4, 1500, 1500, 6, 64, bf16, False),
            ("whisper cross (model 2) rank train B=4 Sq=448 Skv=1500 "
             "H=KV=6 D=64 non-causal", 4, 448, 1500, 6, 64, bf16, False)):
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
    # phase 9's prefills (500 tokens), then a rank's 4 rows of 512 on
    # (data 2, model 2) (phase 13 (j)'s prefill, 24 of mamba2's 48 heads
    # and 56 of zamba2's 112)
    for arch, B, S, H, N in (("mamba2", 8, 500, 48, 128),
                             ("zamba2", 4, 500, 112, 64),
                             ("mamba2 (data 2, model 2) rank", 4, 512, 24,
                              128),
                             ("zamba2 (data 2, model 2) rank", 4, 512, 56,
                              64)):
        nbytes, flops = ssd_work(B, S, H, 64, 1, N, 128, 2)
        reads = nbytes - B * S * H * 64 * 2 - B * H * 64 * N * 4  # - y, h
        sets = [ssd_inputs(gen, B, S, H, 1, N, bf16, device)
                + (torch.zeros(B, H, 64, N, device=device),)
                for _ in range(cold_copies(reads))]
        ms = time_ms(lambda i: ssd.ssd_scan(
            *sets[i][:6], chunk=128, init_state=sets[i][6]), len(sets))
        plain = time_ms(lambda i: ref.ssd_chunked_ref(
            *sets[i][:6], 128, init_state=sets[i][6]), len(sets))
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        if arch == "mamba2":
            row(ssd, "ssd_scan", ms, plain, b_ms, b_by, None, variant="tc")
        times("ssd_scan", f"{arch} prefill B={B} S={S} H={H} P=64 N={N} "
              f"G=1 Q=128 bf16", ms, plain, b_ms, b_by, None, variant="tc",
              input_copies=len(sets))
        del sets

    # the SSD backward at the training shapes (mamba2: B=8, S=512, H=48,
    # N=128; zamba2: H=112, N=64; bf16 x, B, C and dy, no initial state):
    # the kernel (its three launches) beside autograd's backward of the
    # plain version on the same inputs; no single PyTorch call computes
    # it, so no library time
    # and a rank's on phase 12 (f)'s (data 2, model 2): its 4 rows, 24
    # of mamba2's heads, 56 of zamba2's
    for arch, B, H, N in (("mamba2", TRAIN_BATCH, 48, 128),
                          ("zamba2", TRAIN_BATCH, 112, 64),
                          ("mamba2 (data 2, model 2) rank", 4, 24, 128),
                          ("zamba2 (data 2, model 2) rank", 4, 56, 64)):
        S = TRAIN_SEQ
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

    # beside the card's phases: the CPU smoke-width references of phases
    # 6-8 in a process of their own, and phases 11-13's world's ranks
    # spawned to import and wait (``tp_world_start``)
    refs = cpu_refs_start()
    world = tp_world_start()
    try:
        return smoke_phases(device, smi, t_start, refs, world)
    finally:
        for proc in [refs[0]] + world:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=30)


def smoke_phases(device, smi, t_start, refs, world) -> int:
    """Phases 3-13 and 5 of ``main`` (its docstring), ``refs`` and
    ``world`` the side processes ``main`` started."""
    import torch
    from repro_torch import kernels

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
    # phases 6-8 serve the first SERVE_DEPTH layers; phase 13 (b)'s
    # one-card reference is phase 4's trace on that cut
    qwen, qwen_params = serve_cut(qwen, qwen_params)
    qwen_run = ts_one_card_run(device)
    gc.collect()
    torch.cuda.empty_cache()
    cpu_refs = cpu_refs_join(*refs)
    counts["qwen1.5-0.5b pooled"], variants["qwen1.5-0.5b pooled"] = \
        multitenant_full_width(qwen, qwen_params, device, cpu_refs)
    counts["qwen1.5-0.5b pooled"].update(kernels.backward_counts())
    gc.collect()
    torch.cuda.empty_cache()
    serve_refs = {}
    (counts["qwen1.5-0.5b disagg"], variants["qwen1.5-0.5b disagg"],
     serve_refs["disagg"]) = disagg_full_width(qwen, qwen_params, device,
                                               cpu_refs)
    counts["qwen1.5-0.5b disagg"].update(kernels.backward_counts())
    gc.collect()
    torch.cuda.empty_cache()
    (counts["qwen1.5-0.5b colo"], variants["qwen1.5-0.5b colo"],
     serve_refs["colo"]) = colo_full_width(qwen, qwen_params, device,
                                           cpu_refs)
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
    train_counts_, train_variants = train_phase(device, smi)
    counts.update(train_counts_)
    variants.update(train_variants)
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(tp_phase(smi, qwen_run, serve_refs, world))
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
