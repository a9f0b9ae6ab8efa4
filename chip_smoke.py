#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card (an H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. build   the hand-written kernels K1-K10 from robot3dlotus_tpu_torch/csrc
             (one nvcc per source, all started together) and load them;
             ptxas's registers and spills of K1, K2, K3, K5, K6, K7 and
             K10 logged;
             the native voxelizer (robot3dlotus_tpu_torch/native, g++);
  2. capture one `Actioner.predict` at the release width (4096 points) and
             one `predict_batch` of 4 with recorders on the kernel call
             sites, keeping every kernel input the main path produces;
  3. kernels hold each captured call against the kernel's plain PyTorch
             version on the card (|kernel - plain| <= 1e-4 * max(1,
             max|plain|): fp32 on both sides, other summation orders; K4
             bit-equal, its unpool calls with sentinel rows), and time the
             B=1 calls: kernel, plain version and, where one PyTorch call
             computes the same function, that call (CUDA events: median of
             21 rounds of 10 back-to-back calls, after 3 warm-up calls);
             K4's calls also read their device time from the profiler;
             K1, K2 and K3 (3xTF32 on the tensor cores) are also held
             bit-equal across two launches, timed on the profiler, beside
             their bounds at the TF32 and the fp32 SIMT rates, K2 and K3
             beside an im2col gather + matmul (two PyTorch calls, for
             reference); K2 with each map's shares of live (row, tap)
             pairs, of (64-row tile, tap) pairs a whole-tap skip keeps and
             of pairs K2 multiplies, K3 of live pairs and of (tap, 16-row
             group) pairs it multiplies;
  4. serving launch counters to 0, then 4 `predict` requests and one
             `predict_batch` of the same 4 observations (4 cameras of
             256 x 256 xyz/rgb, seeded tabletop scenes), counters read: each
             kernel must have launched its per-forward count 5 times; batch
             and sequential actions must agree; p50 request latency and
             the requests' peak memory printed;
             then (serving nmap) the B = 1 forward's neighbour-map builds
             (nmap_phase: device ms of the stem's and each stage's
             build_neighbor_map over 3 forwards, and the host syncs they
             cause);
  5. breakdown host preprocessing (its parts: the native crop +
             voxelize, robot box, subsample, presort) vs device forward per
             request, and a torch.profiler window over 3 forwards: device
             time by kernel, device launches per forward and the device's
             idle share (profile_forward.txt in the output directory);
 5a. fused     Actioner(device_preprocess=True) on the same weights
             (vox_capacity FUSED_VOX_CAPACITY): launch counters to 0, phase
             4's 4 observations through predict, counters read (each
             kernel's count per forward as phase 4's); predict p50 and its
             host part (the raw cloud's staging); on each observation
             vox_overflow 0 and count equal to the host path's; on a sparse
             observation (no subsample) the action against the host path's
             at the same point capacity (position 2e-4, quaternion 1e-4,
             open logit 1e-3); the packed vector against a CPU run of the
             same program with the same draws (1e-3 * max(1, |ref|),
             count and overflow exact); a profiler window over 3 predicts:
             device busy, host launch calls and synchronizes per predict
             (profile_fused.txt);
  6. reference the card's logits for one observation against the same
             weights on the CPU (the plain path);
 6a. bf16      serving at ptv3_config compute_dtype bfloat16 (BF16_OPTS;
             the seed-0 weights): one captured predict (every K1-K4 call
             against its bf16 plain version and timed: K4 bit-equal; K1,
             K2, K3 bit-equal across two launches and within one bf16 ulp
             of the plain value plus 1e-4 of its scale, K1 plus one bf16
             ulp of each probability's share, ops/bf16.py; bounds at
             989 TFLOP/s bf16; library SDPA in bf16 for K1, the im2col
             gather + matmul for K2 / K3) and a predict_batch of 4
             (checked); phase 4 with launches held at BF16_PER_FORWARD (the
             bf16 counters; the fp32 ones 0); phase 5 (profile_forward_
             bf16.txt); the heads against the fp32 forward on the card
             (0.08 x max(1, |fp32|), the JAX package's bar) and the CPU
             port at bf16 (0.02, the CPU tests'), a hook holding the
             backbone's activations bf16; predict p50, device busy,
             launches and host synchronizes per forward beside phases 4-5's;
             then the AdaNorm and Concat policies at bf16: one predict, its
             calls checked (the Concat stem's K2 at 125 taps timed), its
             launches held, its heads against its fp32 forward;
  7. train-capture  the trainer of the release YAML on synthetic_reach
             (train_simple_policy's build_trainer, B = 32 clouds x 4096
             points, release dropout rates, order shuffling under
             TRAIN.host_structure: one order permutation a batch, the
             batch presorted by the loader's 4 worker processes and the
             consuming process), one step with recorders that keep every
             kernel input and the cotangent of every kernel output;
  8. training launch counters to 0, 5 training steps, counters read: each
             kernel of the training path must have launched its per-step
             count 5 times (PER_STEP: host structure; PER_STEP_REDRAW, the
             key False, is phase 11's); each step's losses finite; step
             time p50 (host
             clock after synchronize), clouds/s, peak memory; then a
             torch.profiler window over 2 steps: device time by kernel
             group (DEVICE_GROUPS) and the device's idle share
             (chiprun_out/profile_train.txt); then (training nmap) the
             step's neighbour-map builds as phase 4's, over 2 steps (at
             bf16 in phase 11a too);
  9. train-kernels hold the captured training calls against the plain
             versions: K5's out, row logsumexp and packed keep bits (the
             bits bit-equal to the PyTorch Philox generator, their keep
             fraction within 5 binomial sigmas of 1 - rate), K6 on K5's
             outputs and the captured cotangent, K5 at rate 0 against K1,
             K7 at the CPE and the stem shapes, K8 (sentinel rows
             dropped; bit-equal across two launches), and the conv's dx
             (K8 onto voxel owners, an invalid row at the sentinel, then K2
             with the mirrored weight) against the exact adjoint (autograd
             of subm_conv_plain) on every row; |kernel - plain|
             <= 1e-4 * max|plain| (gradients are far below 1); K4 on the
             step's 4 calls at B = 32, bit-equal; time K4-K8 per training
             step (CUDA events, median of 5 rounds of 2 calls after a
             warm-up call; K5/K6 also their profiler device time) beside
             the SDPA calls (the profiler names of the SDPA kernels
             logged); K2's 9 forward and 9 mirrored dx launches and K7,
             each bit-equal across two launches, timed (events and
             profiler) against their plain versions and their TF32 and
             fp32 SIMT bounds (K2's 18 launches also by events queued
             behind a spin kernel; K7 beside an im2col gather + matmul);
             K3's forward on the step's B = 32 stem call as in phase 3;
             K8's device time on the profiler;
 10. stem-vjp  the stem conv's input gradient on the step's captured stem
             call (B = 32): launch counters to 0, stem_conv forward and
             backward with x and W requiring gradients, counters read (one
             K3, one K7, one K10: G = g W^T by one matmul, then K10 onto x
             with dead links at the sentinel), peak memory; dx and dW
             against the CPU run (autograd of stem_conv_plain) within
             1e-4 * max|ref|; K10 on the call's operands (C = 7) against
             its plain version, timed (events, profiler) beside its bound,
             index_add_ and scatter_add_; then the same call at bf16 (x, W
             and the cotangent rounded to bf16): one K3, one K7 and one
             K10 bf16 launch, dx and dW against the CPU port at bf16 (the
             bar of ops/bf16.py at the gradients' scale, dx plus one bf16
             ulp of the largest G row it adds: the two devices' fp32 sums
             may round a G element to neighbouring bf16 values), K10 bf16
             on the call's bf16 operands against its plain version
             (fp32 sums rounded once), timed beside its bound and
             index_add_ in bf16;
 11. step-check one step at dropout 0 on each of CHECK_SLICES B = 2
             slices of the same batch with its order_perm (host
             structure), then on slice 0 without it and with injected
             order permutations (the key False; K4 / K9 / K8 launches of
             each card step against PER_STEP or PER_STEP_REDRAW), the same
             weights, on the card and on the CPU (plain versions): losses,
             every updated parameter and running statistic, every
             gradient; a gradient that a max reduction picking different
             rows on the two devices (a near tie) can reach is not held on
             that slice, and every gradient must be held on some slice; at
             a leaky-ReLU pre-activation within 1e-4 max|z| of the kink
             (a tie) the CPU follows the card's branch;
 11c. zero1  data parallelism (parallel/dist.py, mesh.py, zero.py): a
             one-process NCCL group on the card (tcp://localhost at a free
             port), DDP_STEPS policy steps at B = 32 x 4096 on phase 7's
             host batches through build_trainer's ZeRO-1 step (the
             optimizer's state sharded over the dp group, the gradient
             reduce-scattered, the update all-gathered), then through its
             TRAIN.zero1_manual step, then through the replicated
             DistributedDataParallel module (dist.wrap_model); in each the
             masked batch norms' sums and the losses' counts reduced over
             the group (the manual step: its own), launches held at
             PER_STEP; every gradient and batch-norm statistic after each
             step, the losses and the parameters bit-equal to the plain
             trainer's (built before the group is joined) on the same
             batches; the group is left; the optimizer state's bytes a
             process holds at dp = 1, 2, 4, 8 (the shard's length) beside
             the replicated state's;
 11d. tp     tensor parallelism (parallel/mesh.py, the MLP and CPE pairs
             of models/layers.py): scripts/torch_collectives_probe.py
             first (which collectives two processes on the one card run,
             by backend: NCCL refuses two ranks on one device), then two
             processes on the card in a gloo group (this script with
             --tp-worker), a dp = 1 x tp = 2 mesh: TP_STEPS policy steps at
             B = 32 x 4096 on the zero1 phase's batches (release dropout,
             the draws the plain step's) against the plain trainer's
             losses (rtol 2e-4) and parameters (5e-5 where the gradient
             is not within rounding of 0, there at most 3 x the steps'
             summed lr apart: an Adam step flips with the gradient's
             sign), JAX's bars; the last step's gradients against the
             plain step's, each leaf's gap relative to its largest: the
             median leaf and the median tp-sharded leaf within GRAD_TOL
             (at the warmup's lr the parameters cannot tell a wrong
             backward; a near tie of a max reduction moves the rows of a
             few leaves, as in the step checks, so the worst leaf is
             measured, not held); every gate fails on a NaN; launches
             held at PER_STEP; then
             TP_PREDICTS `predict` calls of Actioner(mesh="tp=2") and one
             MotionPlannerEngine(mesh="tp=2") request against the plain
             objects' (2e-4); step and predict times (CUDA events), each
             process's peak memory and optimizer-state bytes;
 11e. tp-widths  K2 and K7 at the tp path's widths on the captured CPE
             calls of phase 7's step: for tp = 2 and 4, at fp32 and at bf16
             (the captured operands rounded), the forward at Cout = C/tp,
             the input gradient's mirrored conv at Cin = C/tp and the
             weight gradient at Cout = C/tp, each against its plain
             version (the dx against the exact adjoint), and against the
             full-width kernel's columns (the gap stated; the dx's tp
             partials summed); K2 and K7 at C/2 and C/4 timed beside
             their bounds and the full width on the first CPE call (C =
             64) and the widest (C = 768);
 11a. bf16-train  training at compute_dtype bfloat16 (BF16_OPTS) on phase 7's
             host batches, B = 32 x 4096, release dropout, host structure:
             one step captured, every bf16 K5 / K6 / K7 / K8 and conv
             input-gradient call against its plain version (K5's bits
             bit-equal to philox_keep_mask; K5, K6, K7 and the mirrored K2
             bit-equal across two launches; out, dq, dk, dv, the mirrored
             K2 and K8's rounded sums within ops/bf16.py's bar, the
             gradients' slack of their own scale; K7's fp32 sums and K8's
             owner sums within 1e-4 of max|plain|; K8 bit-equal across two
             launches, each call's index collisions logged (k8_collisions:
             rows owned by another row, destinations with several sources,
             the most sources, runs); the conv dx within the
             bar of the exact fp32 adjoint rounded once) and timed beside
             its bound (bytes at 3.35 TB/s against flops at 989 TFLOP/s
             bf16, live links for K2 / K7) and the library call (SDPA
             forward / backward in bf16, index_add_ in bf16, the im2col
             gather + matmul in bf16; K5's bound the larger of its bytes
             and its Philox integer work, _philox_s); K5 / K6 also on a
             ragged patch (a captured call's first 77 rows and keys at the
             step's smallest head dim); K2's bf16 forward calls of the step
             checked and timed as a row of their own (beside phase 9's fp32
             forward device time), K3's bf16 forward on the step's B = 32
             stem call as a row of its own (events, profiler, bound, plain,
             im2col in bf16), K5's and its device time from queued
             events where the profiler recorded none; TRAIN_STEPS steps
             with launches at BF16_PER_STEP (the fp32 counters 0) and a
             profiler window
             (profile_train_bf16.txt) beside phase 8's numbers; the step
             check on BF16_CHECK_SLICES slices and the redrawn one, card vs
             the CPU port at bf16, the CPU following the card's max
             decisions (MaxDecisions) and leaky-ReLU ties, at
             BF16_STEP_TOLS, slice 0 also against the CPU port at fp32 (the
             card nearer on the gradients); train_simple_policy.main at
             bf16 for BF16_ENTRY_STEPS steps (4 loader processes, launches
             held, losses finite), its fp32 model file served by Actioner
             at fp32 and at bf16 (launches per forward held);
 11b. optim    the optimizer menu on the release-width policy, B = 32 x
             4096, phase 7's host batches, release dropout, TRAIN.warmup_
             steps 2: adam, adamax, radam, ralamb for OPTIM_STEPS steps
             each, rangerlars for 2 x lookahead_k (Lookahead's second
             sync, the first that moves the slow weights, last), adamw at
             gradient_accumulation_steps 2 for OPTIM_ACCUM_STEPS micro-steps
             and radam at accumulation 2 at compute_dtype bfloat16; launches
             held at PER_STEP (BF16_PER_STEP) per step, losses finite, step
             p50 and the optimizer step's device ms (CUDA events around
             it); the last step's update against a CPU copy of the
             optimizer (its state carried through opt_state_to_jax /
             opt_state_from_jax) fed the card's gradients: each tensor's
             update within 1e-4 of the largest update plus UPDATE_ULPS
             fp32 ulps of the tensor's largest |p| (the roundings at
             |p|'s scale);
 12. entry     train_simple_policy.main on the card for ENTRY_STEPS steps,
             with the release YAML's 4 loader worker processes and the
             prefetch onto the card, then again as the loop in series (no
             workers, no prefetch), then the loader alone with 4 workers
             and with none: wall ms and this process's CPU ms per batch
             (launch counters to 0 before, read after against the
             per-step counts; logged losses finite; a fresh run directory
             under build/smoke_runs, removed after); the end-to-end
             training rate, host batches included, over the second half,
             beside phase 8's device-step rate; host ms per batch (the
             prefetch thread's wait on the loader) and the training
             thread's wait for a batch;
 12a. lmdb     the synthetic_reach store written by LmdbWriterStore as
             GemBench LMDB environments under build/smoke_data; the first 4
             host batches of a 4-worker loader over LmdbStore bit-equal to
             those over the synthetic store (same data_ids and seeds); then
             train_simple_policy.main on the LMDB directory for LMDB_STEPS
             steps, checked as phase 12; the directory kept for 13a / 13b;
 13. ckpt      checkpoints, validation and serving from a checkpoint:
             train_simple_policy.main for CKPT_STEPS steps under
             chiprun_out/ckpt with a save and a validation (VAL_DATASET
             synthetic_reach4, 2 batches of 32) every 2 steps, then a
             second main to CKPT_RESUME_STEPS that must log the resume and
             restore parameters, buffers, mu, nu, count and step bit-equal
             to the state the first ended with; every save (ms, bytes per
             file), the resume's load, each validation forward (ms, kernel
             launches: counters to 0 before, read after, against
             VAL_PER_FORWARD: the `validation` path) timed; K1 on the first
             validation forward's calls (B = 32) against its plain version
             as in phase 3; an Actioner from model_step_4.msgpack, its
             state bit-equal to the saved one, serves phase 4's requests
             (kernel launch counts per forward unchanged), its host launch
             calls per forward (kernels, memcpy, memset: 2226) equal to
             phase 5's, its logits within 1e-3 * max(1, |ref|) of a CPU
             Actioner loaded from the same file;
 13a. eval-server the port's eval_simple_policy_server in a process of
             its own (python -m, --env replay) on model_step_4.msgpack and
             the run's training config: the consumer on the card, 4
             producers on ReplayEnv over phase 12a's store, EVAL_TASKVARS
             taskvars x EVAL_DEMOS demos x up to 25 steps; requests/s,
             p50 / p99 per request at the producers, the consumer's
             batches and kernel launches (PER_FORWARD a forward), no
             producer with torch imported, the results.jsonl rows;
 13b. http     PolicyHTTPServer on port 0 with ThreeDLotusActioner on the
             same file, run_client over ReplayEnv: round trip p50, bytes
             per request and reply, the msgpack codec's share, launches;
             the checkpoint files are deleted, the logs kept.
Then the 3D-LOTUS++ motion planner (release motion_planner_ptv3.yaml,
seeded weights) behind the ground-truth pipeline (robot_pipeline_gt.yaml):
 14. mp-capture   one GroundtruthRobotPipeline.predict on a synthetic
             observation with gt_mask images (4096 points), recorders on the
             K9 call sites (the stage-0 entry sort, the categorical stem)
             and the convs (K2, held against its plain version in 16);
 15. mp-serving   launch counters to 0, 4 pipeline requests of one episode,
             each running the motion planner, counters read against
             MP_PER_FORWARD; MotionPlannerEngine.predict p50 with the host
             prep (GT vision, labels, text) apart from the device forward;
             a profiler window over 3 forwards, device launches per forward
             among its numbers (profile_mp_forward.txt
             beside the other outputs); the card's trajectory logits against
             the same weights on the CPU (1e-3 * max(1, |ref|)), decoded
             actions finite;
 15b. rp-vlm   the released 3D-LOTUS++ (robot_pipeline.yaml: VLM
             grounding) around phase 15's card engine, with the scripted
             OWLv2 / SAM backends of eval/synthetic_obs.py
             (ScriptedVLMBackend) on phase 15's observations: RP_EPISODES
             episodes of RP_SCHEDULE (a grasp, a move of the grasped
             object, a release, the restart; the plan pointer scripted,
             since the seeded weights' stop bit fires at random), 21
             requests with launch counters to 0 before and read after,
             held at MP_PER_FORWARD per motion-planner forward (K1, K2, K4
             and K9 launched); request p50, the VLM's host ms p50 (clean +
             merge), engine predict p50, launches per request; the first
             request on the CPU: its objects and motion-planner input
             equal, logits within phase 15's bar, the action within 1e-3 *
             max(1, |ref|); one episode through LLMTaskPlanner with a
             scripted chat backend (the plan parsed as written, one chat
             call);
 15a. bf16-mp  the motion planner at compute_dtype bfloat16 behind the GT
             pipeline (seed 0): one request captured (its bf16 K9 call, the
             categorical stem's, timed, which must run
             gather_smallc16_kernel; every K1, K2, K4 and K9 call
             against its bf16 plain version), phase 15 with launches held
             at BF16_MP_PER_FORWARD, the trajectory heads against the fp32
             engine's and the CPU port's at bf16 as in 6a, request p50 and
             device busy beside phase 15's;
 16. mp-kernels   K9 on every captured call bit-equal to its plain version
             (device time from the profiler beside the event time);
             K10 on the captured stem index with seeded cotangents at C = 5
             and C = 20 (<= 1e-4 * max|plain|); times (K10 also on the
             profiler), bounds, library calls (K10: the faster of
             index_add_ and scatter_add_)
             (at the forward's B = 1 and, from one captured training step,
             at B = 32); K2 on the request's 9 captured calls (within
             1e-4 * max(1, max|plain|), bit-equal across two launches);
 17. mp-train     train_motion_planner's trainer on synthetic_motion, B = 32
             clouds x 4096 points, release dropout: 5 steps with launch
             counts checked per step (MP_PER_STEP), step p50, clouds/s, peak
             memory, a profiler window (profile_mp_train.txt); then one
             more step captured, whose 9 convs hold and time K2 (forward
             and mirrored dx) and K7 per motion-planner step as phase 9;
 18. mp-stem-vjp  the categorical stem's call of the first captured step
             (B = 32) with its features, weight and label table requiring
             gradients: launch counters to 0, forward and backward,
             counters read (one K9, one K10 at C = 5), peak memory; the
             three gradients against the CPU run within 1e-4 * max|ref|;
             then at bf16 (bf16-mp-stem-vjp): one K9 and one K10 bf16
             launch, dfeat and dW against the CPU port at bf16 within the
             bar of ops/bf16.py (dfeat plus one bf16 ulp of the largest
             row cotangent it adds), the table's gradient (a bf16 product
             over 16.4M rows) within 2^-6 of its scale, K10 bf16 on a
             seeded cotangent at the stem's index against its plain
             version, timed (up to C = 8 it must run
             scatter_smallc16_kernel, in bf16-stem-vjp too);
 19. mp-step-check  phase 11 for the motion planner, on MP_CHECK_SLICES
             slices;
 19a. bf16-mp-train  phase 11a for the motion planner on phase 17's host
             batches (BF16_MP_PER_STEP; its categorical stem's dW is its
             product's autograd, so no stem K7), served behind the GT
             pipeline;
 20. mp-entry     train_motion_planner.main on the card for MP_ENTRY_STEPS
             steps (4 loader worker processes, prefetch), launch counts
             checked,
             logged losses finite, the rates as phase 12's beside phase 17's,
             the loop in series and the loader alone as phase 12;
 20a. mp-lmdb  phase 12a for the motion planner (synthetic_motion);
 21. mp-ckpt      phase 13 for the motion planner (MP_CKPT_STEPS, then a
             resume to MP_CKPT_RESUME_STEPS; validation on the synthetic
             motion store, 3 batches of 32: the `mp_validation` path),
             served by MotionPlannerEngine(checkpoint=...) behind the GT
             pipeline as in phase 15, against a CPU engine from the same
             file;
 21a. mp-eval-server  the port's eval_robot_pipeline_server (GT pipeline,
             stateful, 2 producers) on the mp-ckpt model file over a motion
             store of MP_EVAL_TASKVARS, as phase 13a.
Then the conditioning variants and the other model options (seeded
weights, release widths):
 22. adanorm   SimplePolicyPTV3AdaNorm with pdnorm_adaptive (ADANORM_OPTS):
             one predict captured, every kernel call against its plain
             version; phase 4's requests with launches held at
             ADANORM_PER_FORWARD; card vs CPU logits (1e-3 * max(1,
             |ref|)); VARIANT_STEPS training steps at B = 32 (launches at
             PER_STEP; step p50, peak memory); a step check on
             VARIANT_CHECK_SLICES slices and the redrawn one;
 23. concat    SimplePolicyPTV3Concat (CONCAT_OPTS), as 22 with
             CONCAT_PER_FORWARD / CONCAT_PER_STEP (K3 0: the 263-channel
             stem is K2 at 125 taps); the stem's K2 at B = 1 timed; then,
             concat-stem, the stem call of a training step (B = 32): the
             conv dx against the exact adjoint, K2 forward, mirrored K2 and
             K7 against their plain versions at 1e-4 of the plain scale,
             bit-equal across launches, timed by events and the profiler
             beside their bounds (no im2col: its gather is 17 GB);
 24. mp-adanorm  MotionPlannerPTV3AdaNorm with pdnorm_adaptive (its YAML's
             txt_reduce 'attn'): phase 15's 4 GT-pipeline requests with
             launches held at MP_PER_FORWARD, card vs CPU logits,
             VARIANT_STEPS training steps (MP_PER_STEP), a step check on
             VARIANT_CHECK_SLICES slices and the redrawn one;
 25. variants  an Actioner with ENSEMBLES shuffled members and 'ens1'
             (launches ENSEMBLE_PER_FORWARD a member; each member's logits
             card vs CPU with the same permutations; the vote bit-equal
             across decodes and to the CPU's), a CA policy with the pose and
             step tokens (TOKEN_OPTS) and one with heatmap_mlp, reduce attn
             and quat rotations (HEAD_OPTS), each a predict with launches
             held at PER_FORWARD and logits card vs CPU;
 26. attn-opts  the release policy with the backbone's attention options
             (ATTN_OPTS: enable_rpe, scaled_cosine_attn, add_coords_in_attn
             'qkv'), which run K1, K5 and K6's _opts kernels (the per-head
             scale and the relative-position bias looked up in the kernel):
             a captured predict's 9 K1 calls each against its plain version
             (1e-4 * max(1, |plain|)), bit-equal across two launches, timed
             beside the plain version, SDPA with the bias materialised as
             its mask (the bias build timed apart) and the bound; 4
             requests and a predict_batch with launches held at
             ATTN_OPTS_PER_FORWARD, their p50 and peak memory; card vs CPU
             heads (1e-3 * max(1, |ref|)); a B = 32 training step captured:
             its 9 K5 / K6 calls against their plain versions, the table's
             and the head scales' gradients included, each kernel bit-equal
             across two launches, timed; VARIANT_STEPS steps with launches
             held at ATTN_OPTS_PER_STEP (step p50, peak memory); a step
             check on VARIANT_CHECK_SLICES slices and the redrawn one, the
             CPU following the card's max decisions (scaled cosine
             attention's near-uniform stage 0 ties the first pooling's
             maxima within rounding); K6's blocks an SM with the options
             (attention.bwd_opts_blocks_per_sm, each head dim: must be 2);
 27. bf16-attn-opts  the same at compute_dtype bfloat16 with
             add_coords_in_attn 'qk' (BF16_ATTN_OPTS; the bf16 bars, heads
             card vs the CPU port at bf16 within BF16_CPU_TOL, the
             predict_batch's actions equal to the sequential ones, the
             bf16 step check's bars, the biases in front of a batch norm,
             whose gradients are zero up to rounding, held in its L2 bar
             only) on phase 26's host batches, then one predict with
             upcast_attention (the JAX XLA path: the fp32 _opts K1 with the
             probabilities rounded to bf16, launches held at
             UPCAST_PER_FORWARD) and one with upcast_attention and no
             option (the JAX Pallas path: the bf16 release K1, launches
             held at BF16_PER_FORWARD), each card vs CPU.
The K2 / K3 order check (batch-order, after phase 1's kernels and after
the motion planner's capture): each captured B = 1 K3 and K2 call of the
policy and K2 call of the motion planner, at fp32 and cast to bf16,
bit-equal to the same cloud's rows in a B = 4 batch (and K3 to the
whole-row plan), so that a row's order of sums does not follow B.
It fails if a kernel's main path (K10's: phase 10) launched it no time.
Before it prints its result it stops the loader's forkserver and
multiprocessing's resource tracker, waits for every process the run
started (each carries RUN_MARK in its environment) to end, and fails if
one is still running after 30 s (it is killed). It prints the kernels
line, the card's name and power limit, and as its last line
{"ok": true, "device": {...}}. It needs one CUDA card and exits
non-zero without one.

"""
from __future__ import annotations

import collections
import contextlib
import copy
import datetime
import gc
import json
import logging
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from robot3dlotus_tpu_torch.configs import get_config
from robot3dlotus_tpu_torch.convert import (opt_state_from_jax,
                                            opt_state_to_jax)
from robot3dlotus_tpu_torch.eval.actioner import Actioner
from robot3dlotus_tpu_torch.eval.common import parse_code
from robot3dlotus_tpu_torch.eval import serving
from robot3dlotus_tpu_torch.eval.robot_pipeline import (
    GroundtruthRobotPipeline, MotionPlannerEngine, _plan_action_name)
from robot3dlotus_tpu_torch.eval.server import ReplayEnv
from robot3dlotus_tpu_torch.eval.serving import (PolicyHTTPClient,
                                                 PolicyHTTPServer,
                                                 ThreeDLotusActioner,
                                                 run_client)
from robot3dlotus_tpu_torch.eval.synthetic_obs import (
    OBJECT_ID, TARGET_ID, TASKVAR, ScriptedVLMBackend, synthetic_observation)
from robot3dlotus_tpu_torch.models import heads as heads_mod
from robot3dlotus_tpu_torch.models import layers
from robot3dlotus_tpu_torch.models import ptv3 as ptv3_mod
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.models.motion_planner import (compute_mp_loss,
                                                          decode_mp_actions)
from robot3dlotus_tpu_torch.models.simple_policy import (compute_loss,
                                                         decode_actions)
from robot3dlotus_tpu_torch import native
from robot3dlotus_tpu_torch.ops import (attention, conv, cuda_lib, gather,
                                        patching, pooling, sparse_conv, stem)
from robot3dlotus_tpu_torch.ops.bf16 import bf16_excess, bf16_ulp
from robot3dlotus_tpu_torch.parallel import dist, zero
from robot3dlotus_tpu_torch.train import checkpoint as ckpt_mod, driver
from robot3dlotus_tpu_torch.train.checkpoint import load_any_model_ckpt
from robot3dlotus_tpu_torch.train.datasets.loader import (KeystepBatchLoader,
                                                          PrefetchToDevice)
from robot3dlotus_tpu_torch.train.datasets.store import (LmdbWriterStore,
                                                         open_store)
from robot3dlotus_tpu_torch.train.driver import build_trainer
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train import serialization as msgpack_io
from robot3dlotus_tpu_torch.train import (train_motion_planner,
                                          train_simple_policy)
from robot3dlotus_tpu_torch.train.train_simple_policy import SPEC
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device
from robot3dlotus_tpu_torch.vlm.owlv2_detector import Owlv2ObjectDetector
from robot3dlotus_tpu_torch.vlm.sam_segmentor import SAMSegmentor

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "robot3dlotus_tpu_torch", "configs", "rlbench",
                      "simple_policy_ptv3.yaml")
MP_CONFIG = os.path.join(os.path.dirname(CONFIG), "motion_planner_ptv3.yaml")
GT_CONFIG = os.path.join(os.path.dirname(CONFIG), "robot_pipeline_gt.yaml")
CLI_OPTS = ["TRAIN_DATASET.instr_embed_file", "None"]
# set in the environment by main, inherited by every process the run starts
RUN_MARK = "ROBOT3DLOTUS_SMOKE_RUN"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, fp32 outside tensor cores
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM data sheet, dense TF32 tensor cores
TOL = 1e-4
# launches per forward of the release model (5 enc + 4 dec Blocks; one
# stem; four decoder unpools; inputs presorted, so no entry-sort gather)
PER_FORWARD = {"patch_attention": 9, "subm_conv": 9, "stem_conv": 1,
               "gather_rows": 4}
KERNELS = {
    "patch_attention": ("robot3dlotus_tpu_torch/csrc/attention.cu",
                        "robot3dlotus_tpu/ops/pallas_attention.py:66"),
    "subm_conv": ("robot3dlotus_tpu_torch/csrc/conv.cu",
                  "robot3dlotus_tpu/ops/pallas_conv.py:397"),
    "stem_conv": ("robot3dlotus_tpu_torch/csrc/stem.cu",
                  "robot3dlotus_tpu/ops/pallas_stem.py:138"),
    "gather_rows": ("robot3dlotus_tpu_torch/csrc/gather.cu",
                    "robot3dlotus_tpu/ops/pallas_gather.py:133"),
    "patch_attention_dropout": (
        "robot3dlotus_tpu_torch/csrc/attention_dropout.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:232"),
    "patch_attention_dropout_bwd": (
        "robot3dlotus_tpu_torch/csrc/attention_dropout.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:247"),
    "conv_weight_grad": ("robot3dlotus_tpu_torch/csrc/conv_grad.cu",
                         "robot3dlotus_tpu/ops/pallas_conv.py:569"),
    "scatter_rows_add": ("robot3dlotus_tpu_torch/csrc/gather.cu",
                         "robot3dlotus_tpu/ops/pallas_gather.py:160"),
    "gather_rows_smallc": ("robot3dlotus_tpu_torch/csrc/gather_smallc.cu",
                           "robot3dlotus_tpu/ops/pallas_gather.py:353"),
    "scatter_rows_smallc_add": (
        "robot3dlotus_tpu_torch/csrc/gather_smallc.cu",
        "robot3dlotus_tpu/ops/pallas_gather.py:272"),
    # the bf16 paths (compute_dtype bfloat16) of K1-K4 and K9
    "patch_attention_bf16": ("robot3dlotus_tpu_torch/csrc/attention.cu",
                             "robot3dlotus_tpu/ops/pallas_attention.py:66"),
    "subm_conv_bf16": ("robot3dlotus_tpu_torch/csrc/conv.cu",
                       "robot3dlotus_tpu/ops/pallas_conv.py:397"),
    "stem_conv_bf16": ("robot3dlotus_tpu_torch/csrc/stem.cu",
                       "robot3dlotus_tpu/ops/pallas_stem.py:138"),
    "gather_rows_bf16": ("robot3dlotus_tpu_torch/csrc/gather.cu",
                         "robot3dlotus_tpu/ops/pallas_gather.py:133"),
    "gather_rows_smallc_bf16": (
        "robot3dlotus_tpu_torch/csrc/gather_smallc.cu",
        "robot3dlotus_tpu/ops/pallas_gather.py:353"),
    # the bf16 paths (compute_dtype bfloat16, training) of K2's input
    # gradient (the mirrored conv), K5-K8
    "subm_conv_dx_bf16": ("robot3dlotus_tpu_torch/csrc/conv.cu",
                          "robot3dlotus_tpu/ops/pallas_conv.py:397"),
    "patch_attention_dropout_bf16": (
        "robot3dlotus_tpu_torch/csrc/attention_dropout.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:232"),
    "patch_attention_dropout_bwd_bf16": (
        "robot3dlotus_tpu_torch/csrc/attention_dropout.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:247"),
    "conv_weight_grad_bf16": ("robot3dlotus_tpu_torch/csrc/conv_grad.cu",
                              "robot3dlotus_tpu/ops/pallas_conv.py:569"),
    "scatter_rows_add_bf16": ("robot3dlotus_tpu_torch/csrc/gather.cu",
                              "robot3dlotus_tpu/ops/pallas_gather.py:160"),
    # K10's bf16 path: the stems' input gradients at bf16
    "scatter_rows_smallc_add_bf16": (
        "robot3dlotus_tpu_torch/csrc/gather_smallc.cu",
        "robot3dlotus_tpu/ops/pallas_gather.py:272"),
    # K1, K5 and K6 with the attention options (enable_rpe,
    # scaled_cosine_attn), both dtypes: K1's kernels of attention_opts.cuh,
    # K5 / K6's of attention_dropout.cuh instantiated with LogitOpts
    "patch_attention_opts": ("robot3dlotus_tpu_torch/csrc/attention_opts.cu",
                             "robot3dlotus_tpu/ops/pallas_attention.py:66"),
    "patch_attention_dropout_opts": (
        "robot3dlotus_tpu_torch/csrc/attention_dropout_opts.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:232"),
    "patch_attention_dropout_bwd_opts": (
        "robot3dlotus_tpu_torch/csrc/attention_dropout_opts.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:247"),
    "patch_attention_opts_bf16": (
        "robot3dlotus_tpu_torch/csrc/attention_opts16.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:66"),
    "patch_attention_dropout_opts_bf16": (
        "robot3dlotus_tpu_torch/csrc/attention_dropout_opts16.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:232"),
    "patch_attention_dropout_bwd_opts_bf16": (
        "robot3dlotus_tpu_torch/csrc/attention_dropout_opts16.cu",
        "robot3dlotus_tpu/ops/pallas_attention.py:247"),
}
# the trainer of the release YAML on the learnable synthetic store
# (scripts/e2e_learning_proof.py makes the same overrides)
TRAIN_OPTS = ["TRAIN_DATASET.data_dir", "synthetic_reach",
              "TRAIN_DATASET.instr_embed_file", "None",
              "TRAIN_DATASET.taskvar_instr_file", "None",
              "TRAIN_DATASET.taskvar_file", "None",
              "TRAIN_DATASET.augment_pc", "True"]
TRAIN_STEPS = 5
PROFILE_STEPS = 2
ENTRY_STEPS = 16  # train_simple_policy.main; the rate is read over the last 8
LOADER_BATCHES = 6  # the loader alone: batches timed after the first
LMDB_STEPS = 2    # main on each family's LMDB copy of its synthetic store
LMDB_BATCHES = 4  # host batches held bit-equal across the two stores
# the fused serving path: the smoke's observations crop to up to 8,951
# occupied 1 cm voxels (counted on the CPU), past the default 8192
FUSED_VOX_CAPACITY = 16384
# launches per training step of the release model under
# TRAIN.host_structure (the default: the batch presorted on the host with
# its order_perm, the orders redrawn at no stage): K2 9 forward + 9 dx; K4
# the 4 unpools; no K9 (no stage-0 entry sort); K7 9 CPE + the stem; K8 the
# backward of every K4 call and the owner sum of each of the 9 conv dx; no
# K10: the stem's input is data (the stem-vjp phase gives K10 its path: the
# stem conv's input gradient)
PER_STEP = {"subm_conv": 18, "stem_conv": 1, "gather_rows": 4,
            "gather_rows_smallc": 0, "scatter_rows_smallc_add": 0,
            "patch_attention_dropout": 9, "patch_attention_dropout_bwd": 9,
            "conv_weight_grad": 10, "scatter_rows_add": 13,
            "patch_attention": 0}
# with TRAIN.host_structure False (orders redrawn at stage 0 and after
# every pooling): K4 also the 4 shuffled child entry sorts, K9 the stage-0
# entry sort of the 7-channel input, K8 their backwards
PER_STEP_REDRAW = dict(PER_STEP, gather_rows=8, gather_rows_smallc=1,
                       scatter_rows_add=17)
# the kernels whose counts tell the two apart
ORDER_KERNELS = ("gather_rows", "gather_rows_smallc", "scatter_rows_add")
# the motion planner: its trainer on the synthetic motion store (no action
# embedding cache: the crc32 embeddings), with the policy's release loader
# workers (the motion planner's YAML sets none)
MP_TRAIN_OPTS = ["TRAIN_DATASET.data_dir", "synthetic_motion",
                 "TRAIN_DATASET.action_embed_file", "None",
                 "TRAIN_DATASET.taskvar_file", "None",
                 "TRAIN.n_workers", "4"]
MP_REQUESTS = 4
MP_ENTRY_STEPS = 12  # the rate is read over the last 6
# launches per motion-planner forward: 9 Blocks; 4 unpools; K9 for the
# stage-0 entry sort (C = 4) and the categorical stem (C = 5, M = N * 125),
# whose product is a plain matmul (no K3)
MP_PER_FORWARD = {"patch_attention": 9, "subm_conv": 9, "stem_conv": 0,
                  "gather_rows": 4, "gather_rows_smallc": 2,
                  "scatter_rows_smallc_add": 0, "conv_weight_grad": 0,
                  "scatter_rows_add": 0, "patch_attention_dropout": 0,
                  "patch_attention_dropout_bwd": 0}
# per motion-planner training step: as the policy's, with K9 for the stem
# (and the entry sort without host structure), no K3, K7 for the 9 CPE
# only (the stem's dW is autograd of its product) and no K10 (the stem
# gathers data; the mp-stem-vjp phase runs K10 with the stem's features
# requiring a gradient)
MP_PER_STEP = dict(PER_STEP, stem_conv=0, gather_rows_smallc=1,
                   conv_weight_grad=9)
MP_PER_STEP_REDRAW = dict(PER_STEP_REDRAW, stem_conv=0, gather_rows_smallc=2,
                          conv_weight_grad=9)
# the conditioning variants at the release widths, seeded weights: the
# AdaNorm policy (the YAML's pdnorm_adaptive False leaves it unconditioned,
# so it is set), the Concat policy (the stem reads 7 + 256 = 263 channels:
# K2 at 125 taps instead of K3), the AdaNorm motion planner (its YAML's
# txt_reduce 'attn'); VARIANT_STEPS counted training steps each and a step
# check on VARIANT_CHECK_SLICES slices (and the redrawn one)
ADANORM_OPTS = ["MODEL.model_class", "SimplePolicyPTV3AdaNorm",
                "MODEL.ptv3_config.pdnorm_adaptive", "True"]
CONCAT_OPTS = ["MODEL.model_class", "SimplePolicyPTV3Concat"]
MP_ADANORM_OPTS = ["MODEL.model_class", "MotionPlannerPTV3AdaNorm",
                   "MODEL.ptv3_config.pdnorm_adaptive", "True"]
VARIANT_STEPS = 3
VARIANT_CHECK_SLICES = 2
# the backbone's attention options (ptv3_config; off in the release YAMLs):
# the relative-position bias, scaled cosine attention and the coordinates
# in attention ('qkv' at fp32, 'qk' at bf16), then upcast_attention at
# bf16; every Block's attention goes to the _opts kernels (K1, K5, K6 with
# the per-head scale and the in-kernel bias), which take the counts of
# the release kernels they stand in for
ATTN_OPTS = ["MODEL.ptv3_config.enable_rpe", "True",
             "MODEL.ptv3_config.scaled_cosine_attn", "True",
             "MODEL.ptv3_config.add_coords_in_attn", "qkv"]
BF16_ATTN_OPTS = ["MODEL.ptv3_config.enable_rpe", "True",
                  "MODEL.ptv3_config.scaled_cosine_attn", "True",
                  "MODEL.ptv3_config.add_coords_in_attn", "qk",
                  "MODEL.ptv3_config.compute_dtype", "bfloat16"]
UPCAST_OPTS = ["MODEL.ptv3_config.upcast_attention", "True"]
ATTN_OPTS_PER_FORWARD = dict(PER_FORWARD, patch_attention=0,
                             patch_attention_opts=9)
ATTN_OPTS_PER_STEP = dict(PER_STEP, patch_attention_dropout=0,
                          patch_attention_dropout_bwd=0,
                          patch_attention_dropout_opts=9,
                          patch_attention_dropout_bwd_opts=9)
ATTN_OPTS_PER_STEP_REDRAW = dict(PER_STEP_REDRAW, patch_attention_dropout=0,
                                 patch_attention_dropout_bwd=0,
                                 patch_attention_dropout_opts=9,
                                 patch_attention_dropout_bwd_opts=9)
# launches per forward and per training step: the AdaNorm policy's are the
# CA policy's (its modulations are PyTorch linears); the Concat policy's
# stem is one more K2 launch (and, in training, one more mirrored K2 and
# one more K8 owner sum for its input gradient, which reaches txt_fc),
# never K3; without host structure its 263-channel stage-0 entry sort is
# K4 (not K9), whose backward is one more K8
ADANORM_PER_FORWARD = dict(PER_FORWARD)
CONCAT_PER_FORWARD = dict(PER_FORWARD, subm_conv=10, stem_conv=0)
CONCAT_PER_STEP = dict(PER_STEP, subm_conv=20, stem_conv=0,
                       scatter_rows_add=14)
CONCAT_PER_STEP_REDRAW = dict(PER_STEP_REDRAW, subm_conv=20, stem_conv=0,
                              gather_rows=9, gather_rows_smallc=0,
                              scatter_rows_add=19)
# the variants phase: an ensemble member is an eval forward with its orders
# shuffled: the stage-0 entry sort (K9) and the 4 child entry sorts (K4)
ENSEMBLES = 3
ENSEMBLE_PER_FORWARD = dict(PER_FORWARD, gather_rows=8, gather_rows_smallc=1)
TOKEN_OPTS = ["MODEL.action_config.use_ee_pose", "True",
              "MODEL.action_config.use_step_id", "True"]
HEAD_OPTS = ["MODEL.action_config.pos_pred_type", "heatmap_mlp",
             "MODEL.action_config.reduce", "attn",
             "MODEL.action_config.rot_pred_type", "quat",
             "MODEL.action_config.dim_actions", "8"]
# checkpoints: the policy trains CKPT_STEPS steps (saves and validations
# every 2), then a second main resumes to CKPT_RESUME_STEPS; validation on
# synthetic_reach4 (48 clouds: 2 batches of 32, the last half valid). The
# motion planner: MP_CKPT_STEPS, then MP_CKPT_RESUME_STEPS, validation on
# the synthetic motion store (96 clouds, 3 batches).
CKPT_STEPS, CKPT_RESUME_STEPS = 4, 6
MP_CKPT_STEPS, MP_CKPT_RESUME_STEPS = 2, 3
# closed-loop evaluation on the checkpoint phases' model files: the policy
# on EVAL_TASKVARS taskvars of the lmdb phase's store (one for each of the
# 4 producers), the GT pipeline on MP_EVAL_TASKVARS (GemBench taskvars of
# its plan and label files, 2 producers), EVAL_DEMOS demos each (ReplayEnv
# cycles a taskvar's episodes); the HTTP client HTTP_EPISODES episodes of
# one taskvar. About 3 requests an episode: some hundreds of requests over
# 10-20 s a phase, so that p50 and p99 are read over enough samples (50
# demos and 80 episodes until the attention options' phases pushed the
# run past 900 s of its 1200 s limit)
EVAL_TASKVARS = 4
EVAL_DEMOS = 30
MP_EVAL_TASKVARS = ["push_button+0", "close_fridge+0"]
HTTP_EPISODES = 48
VAL_OPTS = ["VAL_DATASET.use_val", "True",
            "VAL_DATASET.data_dir", "synthetic_reach4",
            "VAL_DATASET.instr_embed_file", "None",
            "VAL_DATASET.taskvar_instr_file", "None",
            "VAL_DATASET.taskvar_file", "None"]
# launches per validation forward (eval mode, B = 32, clouds not presorted:
# K9 sorts the stage-0 input; no order shuffling, so no child entry sorts)
VAL_PER_FORWARD = dict(PER_FORWARD, gather_rows_smallc=1)
TRAIN_KERNELS = ("patch_attention_dropout", "patch_attention_dropout_bwd",
                 "conv_weight_grad", "scatter_rows_add")
# the step check's order permutations: stage 0 and the four poolings
CHECK_PERMS = [[2, 0, 3, 1], [1, 3, 0, 2], [3, 2, 1, 0], [0, 2, 1, 3],
               [2, 3, 0, 1]]
GRAD_TOL = 1e-3   # card vs CPU gradients of the whole step, per tensor
# B = 2 slices per step check, ~3-6 s of CPU each, with
# TRAIN.host_structure (the batch's order_perm); then slice 0 once more
# without it (CHECK_PERMS drawn at stage 0 and every pooling); 6 each
# until the attention options' phases pushed the run past 900 s
CHECK_SLICES = 4
MP_CHECK_SLICES = 4
# leaky-ReLU decisions the CPU run may take from the card: each at |z| <=
# KINK_TOL max|z| (the devices' rows differ by ~1e-6 relative), at most
# MAX_KINKS per slice
KINK_TOL = 1e-5
MAX_KINKS = 4
# the same density of ties for the AdaNorm motion planner's step check:
# its heatmap head's leaky ReLU runs over max_traj_len = 5 times the
# policy head's elements (B x N x 5 x 128 against B x N x 128); on the
# H100 a B = 2 slice of its batch follows 6 ties within 1e-5 max|z|
MP_ADANORM_MAX_KINKS = 5 * MAX_KINKS
# device kernels of a training step by name, first match wins
DEVICE_GROUPS = [
    ("K9/K10 small-C gather", ("gather_smallc_kernel",
                               "gather_smallc16_kernel",
                               "scatter_smallc_kernel",
                               "scatter_smallc16_kernel",
                               "scatter_smallc_sum_kernel")),
    ("K7 conv_weight_grad", ("wgrad_", "sum_splits")),
    ("K2 subm_conv", ("subm_conv",)),
    ("K6 attention dropout bwd", ("attn_drop_bwd",)),
    ("K5 attention dropout fwd", ("attn_drop_fwd",)),
    ("K3 stem_conv", ("stem_conv", "stem_pad8")),
    ("K4/K8 gather, scatter-add", ("gather_rows_kernel",
                                   "scatter_rows_sum_kernel")),
    ("bf16 GEMM (cuBLAS nvjet)", ("nvjet",)),
    ("fp32 GEMM (cuBLAS/CUTLASS)", ("gemm", "sgemm")),
    ("LayerNorm fwd/bwd", ("layer_norm",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "Memset", "Memcpy")),
    ("PyTorch scatter/gather/sort", ("scatter", "gather", "sort", "Sort",
                                     "index")),
]


# K2 / K7: the kernel each wrapper call launches once, and the other
# kernels of the same call (device_ms)
K2_PROFILE = (("subm_conv_kernel", "subm_conv16_kernel"),
              ("subm_conv_reduce",))
K7_PROFILE = (("wgrad_tc_kernel", "wgrad_taps_kernel", "wgrad_taps16_kernel"),
              ("wgrad_compact", "sum_splits"))
# torch.gather's kernel (the K4 / K9 yardstick's device time)
TORCH_GATHER_PROFILE = ("scatter_gather", "vectorized_gather")
# K10: its main kernel (scatter_smallc16_kernel at bf16 up to C = 8) and
# the ranges' in-order sum
K10_PROFILE = (("scatter_smallc_kernel", "scatter_smallc16_kernel"),
               ("scatter_smallc_sum_kernel",))


def log(msg):
    print(msg, flush=True)


def ptxas_usage():
    """{kernel (mangled name): 'registers, spill stores, spill loads'} from
    the `nvcc -Xptxas -v` output the kernel build keeps beside the
    library."""
    usage, entry, spills = {}, None, ""
    with open(cuda_lib.build()[:-3] + ".ptxas.txt") as f:
        for line in f:
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and "spill stores" in line:
                spills = line.strip()
            elif entry and "Used" in line and "registers" in line:
                usage[entry] = (line.split("Used")[1].split(",")[0].strip() +
                                ", " + spills)
                entry, spills = None, ""
    return usage


def cuda_ms(fn, rounds=21, reps=10, warmup=3):
    """Median over `rounds` of the mean time of `reps` back-to-back calls
    between two CUDA events. A call shorter than its host-side launch cost
    measures that cost: it is what the caller pays. The training shapes
    take rounds=5, reps=2, warmup=1 (TRAIN_TIMING)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


# ------------------------------------------------------------- capture -----

class Recorder:
    """Wraps a kernel wrapper where the model calls it and keeps clones of
    the inputs of each call and, when the output takes part in a backward,
    of its cotangent (None otherwise)."""

    def __init__(self, fn):
        self.fn, self.calls, self.grads = fn, [], []

    def __call__(self, *args):
        def keep(a):      # tensors cloned, also in a plain tuple (rpe)
            if type(a) is tuple:
                return tuple(keep(t) for t in a)
            return a.detach().clone() if torch.is_tensor(a) else a
        self.calls.append(tuple(keep(a) for a in args))
        self.grads.append(None)
        out = self.fn(*args)
        if out.requires_grad:
            i = len(self.grads) - 1
            out.register_hook(lambda g: self.grads.__setitem__(
                i, g.detach().clone(memory_format=torch.contiguous_format)))
        return out


SERVING_SITES = [(layers, "patch_attention", "patch_attention"),
                 (sparse_conv, "subm_conv", "subm_conv"),
                 (sparse_conv, "stem_conv", "stem_conv"),
                 (pooling, "gather_rows", "gather_rows"),
                 (gather, "gather_rows", "gather_rows")]
TRAIN_SITES = [(layers, "patch_attention_dropout", "attention"),
               (sparse_conv, "subm_conv", "subm_conv"),
               (sparse_conv, "stem_conv", "stem_conv"),
               (pooling, "gather_rows", "gather_rows"),
               (gather, "gather_rows", "gather_rows"),
               (patching, "gather_rows", "gather_rows")]
# K9: the entry sort (gather.permute_rows_any) and the categorical stem
SMALLC_SITES = [(gather, "gather_rows_smallc", "gather_rows_smallc"),
                (sparse_conv, "gather_rows_smallc", "gather_rows_smallc")]
# the motion planner's CPE convs (K2, K7) and its categorical stem
MP_CONV_SITES = [(sparse_conv, "subm_conv", "subm_conv")]
MP_STEM_SITES = [(sparse_conv, "categorical_conv", "categorical_conv")]


def capture(run, sites):
    """Calls `run` with recorders on the kernel call sites; returns, by
    kernel, the (inputs, output cotangent) of every call."""
    recs = {}
    saved = []
    for mod, attr, kernel in sites:
        rec = Recorder(getattr(mod, attr))
        saved.append((mod, attr, rec.fn))
        setattr(mod, attr, rec)
        recs.setdefault(kernel, []).append(rec)
    try:
        run()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return {k: [c for r in v for c in zip(r.calls, r.grads)]
            for k, v in recs.items()}


def capture_main_path(run):
    """The serving forward's recorded kernel inputs by kernel."""
    return {k: [args for args, _ in v]
            for k, v in capture(run, SERVING_SITES).items()}


# ------------------------------------------------------------- kernels -----

def _bound(nbytes, flops, flops_per_s=FP32_FLOPS_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, t_b, t_f


def _sdpa(q, k, v, kv, scale):
    mask = kv[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale)


def _named(events, names):
    names = (names,) if isinstance(names, str) else names
    return [e for e in events if any(n in e.key for n in names)]


def device_ms(fn, name, reps=10, windows=5, also=()):
    """Device time per call of fn, over `reps` calls in one torch.profiler
    window (CUPTI), after a warm-up call: the device's share of a call
    whose CUDA-event time (cuda_ms) includes its host path. `name` (a
    string or a tuple) matches the profiler name of the kernel that each
    call launches once; `also` other kernels of the same call (a
    compaction, a split reduction), whose time is added. Divides by the
    launches of `name` the profiler recorded: in a process that opens many
    windows it sometimes records only some of them, or none, and then a new
    window is opened, up to `windows`; None (not measured) if none recorded
    one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof.key_averages())
        launches = sum(e.count for e in _named(events, name))
        if launches:
            timed = _named(events, (name,) + tuple(also)
                           if isinstance(name, str) else name + tuple(also))
            return sum(_dev_us(e) for e in timed) / 1e3 / launches
    return None


def device_ms_queued(fns, reps=2, spin_cycles=50_000_000):
    """Device time of one pass over fns by CUDA events, every launch
    queued behind a spin kernel (torch.cuda._sleep, ~25 ms) so that the
    card runs them back to back whatever the host's pace: the time of a
    group of calls where a profiler window (device_ms) recorded nothing
    for one of them. None if the card had finished the spin before the
    host queued the last call (the events would then hold host gaps)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        for fn in fns:
            fn()
    end.record()
    queued = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / reps if queued else None


def _total(values):
    """The sum, or None (not measured) if any value is None."""
    values = list(values)
    return None if None in values else sum(values)


# the row gathers: wrapper, plain version, the kernel's profiler name
GATHERS = {"gather_rows": (gather.gather_rows, gather.gather_rows_plain,
                           "gather_rows_kernel"),
           "gather_rows_smallc": (gather.gather_rows_smallc,
                                  gather.gather_rows_smallc_plain,
                                  ("gather_smallc_kernel",
                                   "gather_smallc16_kernel"))}


def _padded_gather(x, idx):
    """The library yardstick of a row gather with sentinel rows: one
    torch.gather on x with a zero row appended, every index outside [0, N)
    sent to it; pad and int64 expanded index built here, outside the timed
    call."""
    B, N, D = x.shape
    x_pad = torch.cat([x, x.new_zeros(B, 1, D)], 1)
    sel = torch.where((idx >= 0) & (idx < N), idx, N).long()
    sel = sel[..., None].expand(-1, -1, D)
    return lambda: torch.gather(x_pad, 1, sel)


def check_gather(kernel, args, timing=None):
    """K4 or K9 on one captured call: bit-equal to its plain version (both
    only copy) and its sentinel rows (index outside [0, N)) counted; with
    `timing` (cuda_ms keywords), the kernel's event and profiler device
    times, the plain version's and the library yardstick's times, and the
    bound (x and the indices read once, the output written once); a timed
    bf16 K9 call must run gather_smallc16_kernel."""
    x, idx = args
    fn, plain_fn, name = GATHERS[kernel]
    B, N, D = x.shape
    run = lambda: fn(x, idx)  # noqa: E731
    plain = lambda: plain_fn(x, idx)  # noqa: E731
    got, want = run(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{kernel} {[B, N, D]} M={idx.shape[1]}: not "
                             "bit-equal to its plain version")
    out = {"shape": [B, N, D, idx.shape[1]], "index": str(idx.dtype),
           "max_abs_err": 0.0, "max_rel_err": 0.0,
           "sentinel_rows": int(((idx < 0) | (idx >= N)).sum())}
    if timing is None:
        return out
    bound_ms, t_b, t_f = _bound(x.element_size() * (x.numel() + got.numel())
                                + idx.numel() * idx.element_size(), 0)
    library = _padded_gather(x, idx)
    out = {**out, "ms": cuda_ms(run, **timing),
           "device_ms": device_ms(run, name),
           "plain_ms": cuda_ms(plain, **timing),
           "library_ms": cuda_ms(library, **timing),
           "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f}
    if x.dtype == torch.bfloat16:
        # the bf16 rows: torch.gather's device time beside the kernel's
        out["library_device_ms"] = device_ms(library, TORCH_GATHER_PROFILE)
        if kernel == "gather_rows_smallc":
            _required_kernels(run, "gather_smallc16_kernel",
                              f"K9 bf16 {[B, N, D]}")
    return out


def _required_kernels(run, name, what):
    """Raises if the profiler recorded the kernels of one call of run and
    `name` is not among them (the call took another kernel than the
    path's); a window that recorded none checks nothing."""
    names = _kernel_names(run)
    if names and not any(name in k for k in names):
        raise AssertionError(f"{what}: ran {names}, not {name}")


def _twice(run, what):
    """Two launches on the same inputs, bit-equal (no atomics, a fixed
    summation order); returns the first result."""
    a, b = run(), run()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: two launches on the same inputs "
                             "differ")
    return a


def _im2col(x, idx, ok, w):
    """For reference only, K2's product as two PyTorch calls: a dense
    gather of all K taps (a zero row appended, dead links sent to it) and
    one matmul, no bias; the padded x and the index are built here, outside
    the timed call."""
    B, N, Cin = x.shape
    K, _, Cout = w.shape
    x_pad = torch.cat([x, x.new_zeros(B, 1, Cin)], 1)
    sel = torch.where(ok, idx.long(), N).reshape(B, N * K, 1).expand(
        -1, -1, Cin)
    w2 = w.reshape(K * Cin, Cout)
    return lambda: torch.matmul(
        torch.gather(x_pad, 1, sel).reshape(B, N, K * Cin), w2)


def _im2col_wgrad(x, idx, ok, g):
    """For reference only, K7's weight gradient as two PyTorch calls: the
    dense gather of all K taps (dead links sent to an appended zero row)
    and one (K Cin, B N) x (B N, Cout) matmul; the padded x and the index
    are built here, outside the timed call."""
    B, N, Cin = x.shape
    K = idx.shape[-1]
    x_pad = torch.cat([x, x.new_zeros(B, 1, Cin)], 1)
    sel = torch.where(ok, idx.long(), N).reshape(B, N * K, 1).expand(
        -1, -1, Cin)
    g2 = g.reshape(B * N, -1)
    return lambda: torch.matmul(
        torch.gather(x_pad, 1, sel).reshape(B * N, K * Cin).t(), g2)


def _conv_bytes(x, idx, w, cout):
    """K2's bytes: x, the map (idx and ok), W and bias read once, the
    output written once."""
    B, N, _ = x.shape
    return 4 * (x.numel() + w.numel() + B * N * cout + cout) + \
        5 * idx.numel()


def link_shares(ok, tile_rows=conv.CONV_ROWS, group=16, skip_rows=64):
    """Work shares of one conv's (B, N, K) map. 'live': the (row, tap)
    pairs with a link, of all B N K; 'tile_kept': the (skip_rows-row tile,
    tap) pairs in which some row has a link, of all such pairs (what a
    whole-tap skip per tile keeps, as the earlier SIMT K2 did);
    'compacted': the (row, tap) pairs K2 multiplies, of all B N K: per
    (tile_rows-row tile, tap) its live rows rounded up to `group` (the
    mma's m)."""
    B, N, K = ok.shape
    okc = ok.to(torch.int32)

    def per_tile(rows):
        t = F.pad(okc, (0, 0, 0, -N % rows))
        return t.reshape(B, -1, rows, K).sum(2)

    kept = per_tile(skip_rows) > 0
    comp = -(-per_tile(tile_rows) // group) * group
    total = max(B * N * K, 1)
    return {"live": int(okc.sum()) / total,
            "tile_kept": int(kept.sum()) / max(kept.numel(), 1),
            "compacted": int(comp.sum()) / total}


def stem_shares(ok, group=16):
    """Work shares of one stem call's (B, N, K) map. 'live': the (row, tap)
    pairs with a link, of all B N K; 'group_kept': the (tap, 16-row group)
    pairs in which some row has a link, of all such pairs: the ones K3
    multiplies (its ballot skips the others)."""
    B, N, K = ok.shape
    okc = ok.to(torch.int32)
    groups = F.pad(okc, (0, 0, 0, -N % group)).reshape(B, -1, group, K)
    kept = groups.sum(2) > 0
    return {"live": int(okc.sum()) / max(B * N * K, 1),
            "group_kept": int(kept.sum()) / max(kept.numel(), 1)}


def _shares(results):
    """The work shares (link_shares) of several calls, weighted by
    their (row, tap) pairs."""
    pairs = sum(r["pairs"] for r in results)
    return {k: sum(r["shares"][k] * r["pairs"] for r in results) / pairs
            for k in results[0]["shares"]}


def check_conv(args, timed=True):
    """K2 on one captured forward call: within TOL * max(1, max|plain|)
    of its plain version, bit-equal across two launches, its map's work
    shares (link_shares); if `timed`, its event and profiler device
    times, the plain version's, the im2col gather + matmul reference (two
    PyTorch calls, no single one computes K2), and its bounds: bytes
    against 3 x the live-link flops at the TF32 rate (its products run on
    the tensor cores as 3xTF32), the fp32 SIMT bound beside it."""
    x, idx, ok, w, bias = args
    run = lambda: conv.subm_conv(x, idx, ok, w, bias)  # noqa: E731
    plain = lambda: conv.subm_conv_plain(x, idx, ok, w, bias)  # noqa
    B, N, Cin = x.shape
    K, _, Cout = w.shape
    shape = [B, N, K, Cin, Cout]
    got = _twice(run, f"K2 {shape}")
    want = plain()
    err = float((got - want).abs().max())
    scale_ref = max(1.0, float(want.abs().max()))
    if not bool(torch.isfinite(got).all()) or err > TOL * scale_ref:
        raise AssertionError(f"K2 {shape}: max |kernel - plain| = {err} > "
                             f"{TOL} * {scale_ref}")
    out = {"shape": shape, "max_abs_err": err, "max_rel_err": err / scale_ref,
           "shares": link_shares(ok), "pairs": B * N * K,
           "tap_splits": conv.conv_tap_splits(B, N, K, Cout)}
    if not timed:
        return out
    nbytes = _conv_bytes(x, idx, w, Cout)
    flops = 2 * Cin * Cout * int(ok.sum())      # this cloud's live links
    bound_ms, t_b, t_f = _bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    return {**out, "ms": cuda_ms(run),
            "device_ms": device_ms(run, K2_PROFILE[0], also=K2_PROFILE[1]),
            "plain_ms": cuda_ms(plain), "library_ms": None,
            "im2col_matmul_ms": cuda_ms(_im2col(x, idx, ok, w)),
            "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f,
            "fp32_bound_ms": _bound(nbytes, flops)[0]}


def log_conv(tag, label, r):
    """One line per K2 or K7 call: shape, shares and, if timed, times."""
    sh = r["shares"]
    times = "" if "ms" not in r else (
        f"; {r['ms']:.4f} ms (device {r['device_ms']}; plain "
        f"{r['plain_ms']:.4f}"
        + (f", im2col gather + matmul {r['im2col_matmul_ms']:.4f}"
           if r.get("im2col_matmul_ms") is not None else "")
        + f"; bound {r['bound_ms']:.4f} TF32, {r['fp32_bound_ms']:.4f} "
        f"fp32 SIMT)")
    log(f"[{tag}] {label} {r['shape']}: live (row, tap) pairs "
        f"{sh['live']:.4f}, (64-row tile, tap) pairs a whole-tap skip keeps "
        f"{sh['tile_kept']:.4f}, pairs multiplied {sh['compacted']:.4f}; "
        f"max_abs_err {r['max_abs_err']:.3g}{times}")


# K1 / K3: the kernel each wrapper call launches once, and the other
# kernels of the same call (device_ms)
# K1: the release kernel (and the options' inline plan), and the options'
# bias-warp kernel (csrc/attention_opts.cuh)
K1_PROFILE = (("patch_attention_kernel", "patch_attention_bias_kernel"), ())
K3_PROFILE = ("stem_conv_kernel", ("stem_conv_sum",))
# K3 at bf16: its product kernel, the padding of x's rows and the ranges'
# sum
K3_BF16_PROFILE = ("stem_conv16_kernel", ("stem_conv_sum", "stem_pad8"))
# K8 (both dtypes): one kernel a call
K8_PROFILE = "scatter_rows_sum_kernel"


def check_call(kernel, args, timed=True, timing=None):
    """One captured call: error vs plain and, if `timed`, times (cuda_ms
    keywords `timing`) and bounds. K1 and K3 (3xTF32 on the tensor cores)
    are also held bit-equal across two launches, timed on the profiler,
    bound by bytes against 3 x their flops at the TF32 rate with the fp32
    SIMT bound beside it; K3 also logs its map's work shares (stem_shares)
    and times the im2col gather + matmul (two PyTorch calls) beside it."""
    if kernel == "gather_rows":
        return check_gather(kernel, args, {} if timed else None)
    if kernel == "subm_conv":
        return check_conv(args, timed)
    im2col, shares = None, {}
    if kernel == "patch_attention":
        q, k, v, kv, scale = args
        run = lambda: attention.patch_attention(q, k, v, kv, scale)  # noqa
        plain = lambda: attention.patch_attention_plain(q, k, v, kv, scale)  # noqa
        library = lambda: _sdpa(q, k, v, kv, scale)  # noqa: E731
        G, H, P, Dh = q.shape
        shape = [G, H, P, Dh]
        nbytes = 4 * 4 * q.numel() + kv.numel()
        flops = 4 * G * H * P * P * Dh
        profile = K1_PROFILE
    elif kernel == "stem_conv":
        x, idx, ok, w = args
        run = lambda: stem.stem_conv(x, idx, ok, w)  # noqa: E731
        plain = lambda: stem.stem_conv_plain(x, idx, ok, w)  # noqa
        library = None
        B, N, Cin = x.shape
        K, _, Cout = w.shape
        shape = [B, N, K, Cin, Cout]
        nbytes = 4 * (x.numel() + w.numel() + B * N * Cout) + \
            5 * idx.numel()
        flops = 2 * Cin * Cout * int(ok.sum())      # this cloud's live links
        profile = K3_PROFILE
        im2col = _im2col(x, idx, ok, w)
        shares = {"shares": stem_shares(ok), "pairs": ok.numel(),
                  "plan": list(stem.stem_conv_plan(B, N, K, Cin, Cout))}
    got = _twice(run, f"{kernel} {shape}")
    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale_ref = max(1.0, float(want.abs().max()))
    if not bool(torch.isfinite(got).all()) or err > TOL * scale_ref:
        raise AssertionError(f"{kernel} {shape}: max |kernel - plain| = "
                             f"{err} > {TOL} * {scale_ref}")
    out = {"shape": shape, "max_abs_err": err, "max_rel_err": err / scale_ref,
           **shares}
    if not timed:
        return out
    timing = timing or {}
    bound_ms, t_b, t_f = _bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    out.update(ms=cuda_ms(run, **timing),
               device_ms=device_ms(run, profile[0], also=profile[1]),
               plain_ms=cuda_ms(plain, **timing),
               library_ms=cuda_ms(library, **timing) if library else None,
               bound_ms=bound_ms, bytes_s=t_b, flops_s=t_f,
               fp32_bound_ms=_bound(nbytes, flops)[0])
    if im2col:
        out["im2col_matmul_ms"] = cuda_ms(im2col, **timing)
    return out


def log_call(tag, label, r):
    """One line per K1 or K3 call (or row): shape, the event and profiler
    device times beside the plain version's, the library call or the
    im2col yardstick, the TF32 and fp32 SIMT bounds, K3's shares."""
    extra = ""
    if r.get("library_ms") is not None:
        extra += f", library {r['library_ms']:.4f}"
    if "im2col_matmul_ms" in r:
        extra += f", im2col gather + matmul {r['im2col_matmul_ms']:.4f}"
    shares = f"; shares {r['shares']}" if "shares" in r else ""
    log(f"[{tag}] {label} {r.get('shape', '')}: max_abs_err "
        f"{r['max_abs_err']:.3g}; {r['ms']:.4f} ms (device "
        f"{r['device_ms']}; plain {r['plain_ms']:.4f}{extra}; bound "
        f"{r['bound_ms']:.4f} TF32, {r['fp32_bound_ms']:.4f} fp32 SIMT)"
        f"{shares}")


def kernel_phase(captured, captured_batch):
    """Every captured call of the B=1 forward is checked and timed; every
    call of the batch-of-4 forward is checked."""
    rows, detail = {}, []
    for kernel in PER_FORWARD:
        for cap in (captured, captured_batch):
            if len(cap[kernel]) != PER_FORWARD[kernel]:
                raise AssertionError(
                    f"{kernel}: captured {len(cap[kernel])} calls, "
                    f"expected {PER_FORWARD[kernel]}")
        res = [check_call(kernel, c) for c in captured[kernel]]
        res_b = [check_call(kernel, c, timed=False)
                 for c in captured_batch[kernel]]
        detail += [dict(r, name=kernel) for r in res + res_b]
        lib = [r["library_ms"] for r in res]
        rows[kernel] = {
            "max_abs_err": max(r["max_abs_err"] for r in res + res_b),
            "max_rel_err": max(r["max_rel_err"] for r in res + res_b),
            "ms": sum(r["ms"] for r in res),
            "plain_ms": sum(r["plain_ms"] for r in res),
            "bound_ms": sum(r["bound_ms"] for r in res),
            "bound_by": "bytes" if sum(r["bytes_s"] for r in res) >=
            sum(r["flops_s"] for r in res) else "operations",
            "library_ms": None if None in lib else sum(lib),
        }
        log(f"[kernels] {kernel}: {len(res)} calls per forward, "
            f"max_abs_err {rows[kernel]['max_abs_err']:.3g}, "
            f"{rows[kernel]['ms']:.4f} ms (plain "
            f"{rows[kernel]['plain_ms']:.4f}, bound "
            f"{rows[kernel]['bound_ms']:.4f})")
    for kernel, label in (("patch_attention", "K1"), ("stem_conv", "K3")):
        calls = [r for r in detail if r["name"] == kernel]
        b1 = [r for r in calls if "ms" in r]
        for r in b1:
            log_call("kernels", f"{label} per forward, call", r)
        rows[kernel].update(
            fp32_bound_ms=sum(r["fp32_bound_ms"] for r in b1),
            device_ms=_total(r["device_ms"] for r in b1))
        if kernel == "stem_conv":
            rows[kernel].update(
                im2col_matmul_ms=sum(r["im2col_matmul_ms"] for r in b1),
                shares=_shares(b1), plan=b1[0]["plan"],
                batch4_shares=_shares([r for r in calls if "ms" not in r]),
                batch4_plan=[r for r in calls if "ms" not in r][0]["plan"])
        log_call("kernels", f"{label} per forward", rows[kernel])
    k2 = [r for r in detail if r["name"] == "subm_conv"]
    k2_b1 = [r for r in k2 if "ms" in r]
    for r in k2_b1:
        log_conv("kernels", "K2 per forward, call", r)
    rows["subm_conv"].update(
        fp32_bound_ms=sum(r["fp32_bound_ms"] for r in k2_b1),
        device_ms=_total(r["device_ms"] for r in k2_b1),
        im2col_matmul_ms=sum(r["im2col_matmul_ms"] for r in k2_b1),
        shares=_shares(k2_b1),
        batch4_shares=_shares([r for r in k2 if "ms" not in r]))
    log(f"[kernels] K2 per forward: {rows['subm_conv']['ms']:.4f} ms "
        f"(device {rows['subm_conv']['device_ms']}; plain "
        f"{rows['subm_conv']['plain_ms']:.4f}; im2col gather + matmul "
        f"{rows['subm_conv']['im2col_matmul_ms']:.4f}; bound "
        f"{rows['subm_conv']['bound_ms']:.4f} TF32, "
        f"{rows['subm_conv']['fp32_bound_ms']:.4f} fp32 SIMT); shares "
        f"{rows['subm_conv']['shares']}")
    rows["gather_rows"]["device_ms"] = _total(
        r["device_ms"] for r in detail if r["name"] == "gather_rows"
        and "device_ms" in r)
    log_gathers("kernels", "K4 per forward", [r for r in detail
                                              if r["name"] == "gather_rows"])
    rows["gather_rows"]["host_us"] = host_split(*captured["gather_rows"][0])
    if not any(r["sentinel_rows"] for r in detail
               if r["name"] == "gather_rows"):
        # no captured call had one: hold a seeded call that does
        gen = torch.Generator(device="cuda").manual_seed(21)
        x = torch.randn(1, 512, 64, generator=gen, device="cuda")
        idx = torch.randint(0, 600, (1, 1024), generator=gen, device="cuda")
        r = dict(check_gather("gather_rows", (x, idx)), name="gather_rows",
                 seeded=True)
        detail.append(r)
        log_gathers("kernels", "K4 seeded call", [r])
    return rows, detail


def batch_order_phase(stem_calls, conv_calls, tag):
    """K3 and K2 sum a row in one order at every B (ops/stem.py
    stem_sum_ranges, ops/conv.py conv_tap_splits): each captured B = 1
    call, at fp32 and cast to bf16, against the same cloud at slot 2 of a
    B = 4 batch (the other slots its features rolled by 1, 2 and 3 rows,
    the same map), bit for bit; K3 also against the batch with the whole
    row in one block (the B = 32 plan's form). The launches made here
    count in no main path."""
    checked = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, fn, calls in (("K3", stem.stem_conv, stem_calls),
                                ("K2", conv.subm_conv, conv_calls)):
            for args in calls:
                x, idx, ok, w = args[:4]
                x, w = x.to(dtype), w.to(dtype)
                alone = fn(x, idx, ok, w, *args[4:])
                x4 = torch.cat([x.roll(r, 1) for r in (1, 2, 0, 3)])
                idx4, ok4 = (t.expand(4, -1, -1).contiguous()
                             for t in (idx, ok))
                batch = fn(x4, idx4, ok4, w, *args[4:])
                if not torch.equal(alone[0], batch[2]):
                    raise AssertionError(
                        f"[{tag}] {name} {dtype} {list(x.shape)}: rows at "
                        "B = 1 differ from the same rows inside B = 4")
                if name == "K3":
                    B, N, cin = x4.shape
                    K, _, cout = w.shape
                    cols, warps, splits, blocks = stem.stem_conv_plan(
                        B, N, K, cin, cout, dtype == torch.bfloat16)
                    whole = stem.stem_conv_split(x4, idx4, ok4, w, cols,
                                                 warps, 1, blocks)
                    if splits > 1 and not torch.equal(whole, batch):
                        raise AssertionError(
                            f"[{tag}] K3 {dtype}: the whole-row plan "
                            f"differs from the {splits} ranges' plan")
                key = f"{name} {str(dtype)[6:]}"
                checked[key] = checked.get(key, 0) + 1
    torch.cuda.synchronize()
    log(f"[{tag}] rows at B = 1 bit-equal to the same rows in B = 4 "
        f"(calls checked: {checked})")
    return checked


def host_split(x, idx, rounds=5, calls=2000):
    """Host microseconds per call (host clock, median of `rounds` rounds of
    `calls` back-to-back calls) of K4's wrapper and of torch.gather on the
    padded x, and of the two parts of the wrapper that no Python wrapper
    avoids: the output allocation alone, and the ctypes call of the C entry
    point (with its launch) alone on a preallocated output."""
    B, N, D = x.shape
    M = idx.shape[1]
    out = x.new_empty(B, M, D)
    entry = cuda_lib.library().r3dl_gather_rows
    args = (x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, M, D,
            int(idx.dtype == torch.int64))
    parts = {"wrapper": lambda: gather.gather_rows(x, idx),
             "torch.gather": _padded_gather(x, idx),
             "allocation": lambda: x.new_empty(B, M, D),
             "ctypes call and launch": lambda: entry(
                 *args, cuda_lib.current_stream())}
    times = {k: [] for k in parts}
    for _ in range(rounds):
        for k, fn in parts.items():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[k].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[kernels] K4 host path per call, {[B, N, D, M]} (us, host clock, "
        f"median of {rounds} rounds of {calls} calls): wrapper "
        f"{med['wrapper']:.2f}, torch.gather {med['torch.gather']:.2f}; "
        f"of the wrapper: allocation {med['allocation']:.2f}, ctypes call "
        f"and launch {med['ctypes call and launch']:.2f}")
    return med


def log_gathers(tag, label, results):
    """One line per K4 / K9 call: shape, index type, sentinel rows and, if
    timed, event time beside the profiler's device time."""
    for r in results:
        dev = "not measured" if r.get("device_ms") is None else \
            f"{r['device_ms']:.4f} ms"
        times = "" if "ms" not in r else (
            f", {r['ms']:.4f} ms by events, {dev} on the device (plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f})")
        log(f"[{tag}] {label}: [B, N, D, M] {r['shape']} {r['index']}, "
            f"{r['sentinel_rows']} sentinel rows{times}")


# ------------------------------------------------------------- serving -----

def requests(observations):
    return [{"task_str": "close_jar", "variation": i, "step_id": 0,
             "obs_state_dict": o} for i, o in enumerate(observations)]


def serving_phase(actioner, observations, per_forward=PER_FORWARD,
                  tag="serving"):
    """Launch counters to 0, the requests one by one and as one
    predict_batch, counters read and held at per_forward; the batch's
    actions must equal the sequential ones (1e-5; K2 and K3 sum a row in
    one order at every B, also at bf16). Records the p50, the batch's time
    and the peak memory of the requests (and that peak above the memory
    in use before them)."""
    payloads = requests(observations)
    actioner.rng = np.random.default_rng(7)
    actioner.predict(**payloads[0])                      # warm-up
    torch.cuda.synchronize()

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    actioner.rng = np.random.default_rng(1)
    seq, lat = [], []
    for p in payloads:
        t0 = time.perf_counter()
        seq.append(actioner.predict(**p)["action"])
        lat.append(time.perf_counter() - t0)
    actioner.rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    bat = [o["action"] for o in actioner.predict_batch(payloads)]
    batch_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    forwards = len(payloads) + 1
    for k, per in per_forward.items():
        if launches[k] != per * forwards:
            raise AssertionError(f"{k}: {launches[k]} launches in the main "
                                 f"path, expected {per} x {forwards}")
    for i, (s, b) in enumerate(zip(seq, bat)):
        if s.shape != (8,) or not np.isfinite(s).all():
            raise AssertionError(f"request {i}: bad action {s}")
        if not np.allclose(s, b, atol=1e-5, rtol=0):
            raise AssertionError(f"request {i}: predict_batch {b} != "
                                 f"predict {s}")
    batch_diff = max(float(np.abs(s - b).max()) for s, b in zip(seq, bat))
    actioner.rng = np.random.default_rng(1)
    points = [len(actioner._host_prep("close_jar", i, o, None)[1])
              for i, o in enumerate(observations)]
    log(f"[{tag}] points per request {points}; predict p50 "
        f"{np.median(lat) * 1e3:.2f} ms (all {[round(t * 1e3, 2) for t in lat]}"
        f"); predict_batch of {len(payloads)} {batch_s * 1e3:.2f} ms "
        f"(max |batch - sequential| action {batch_diff:.3g}); peak memory "
        f"{peak / 2 ** 30:.3f} GiB ({(peak - base) / 2 ** 30:.3f} above the "
        f"model); launches {launches}")
    return {"predict_p50_ms": float(np.median(lat)) * 1e3,
            "batch_action_diff": batch_diff,
            "peak_mem_gib": peak / 2 ** 30,
            "peak_above_gib": (peak - base) / 2 ** 30,
            "predict_ms": [t * 1e3 for t in lat],
            "predict_batch4_ms": batch_s * 1e3, "points": points,
            "launches": launches, "actions": [a.tolist() for a in seq]}


def breakdown_phase(actioner, observations, out_dir,
                    profile_name="profile_forward.txt", tag="breakdown"):
    """Where a request's time goes: host preprocessing vs the device
    forward (batch upload, model, decode, readback), host clock; then a
    torch.profiler window over 3 forwards for device time by kernel and the
    device's busy share of the window."""
    prep_ms, fwd_ms, parts = [], [], []
    rows = []
    for i, o in enumerate(observations):
        t0 = time.perf_counter()
        emb, pc_ft, _, _, ee = actioner._host_prep("close_jar", i, o, None)
        t1 = time.perf_counter()
        parts.append(dict(actioner.prep_ms))
        actioner._forward([(pc_ft, emb, ee, 0)], 1)
        t2 = time.perf_counter()
        prep_ms.append((t1 - t0) * 1e3)
        fwd_ms.append((t2 - t1) * 1e3)
        rows.append((pc_ft, emb, ee, 0))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in rows[:3]:
            actioner._forward([r], 1)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = _device_ops(events, 3)
    busy_ms = sum(k[1] for k in kernels)
    with open(os.path.join(out_dir, profile_name), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    fwd_p50 = float(np.median(fwd_ms))
    out = {"host_prep_ms_p50": float(np.median(prep_ms)),
           "host_prep_parts_ms_p50": {k: float(np.median([p[k] for p in
                                                          parts]))
                                      for k in parts[0]},
           "forward_ms_p50": fwd_p50,
           "profiled_forward_wall_ms": wall_ms / 3,
           "device_busy_ms_per_forward": busy_ms,
           "device_launches_per_forward": _device_launches(events, 3),
           "host_launches_per_forward": _host_launches(events, 3),
           "host_syncs_per_forward": _host_syncs(events, 3),
           "copy_launches_per_forward": _copy_launches(events, 3),
           "device_ms_by_group": _group_device_ops(kernels),
           "device_idle_share": 1.0 - busy_ms / fwd_p50,
           "top_device_ops": [{"name": k[0][:80], "ms": k[1], "count": k[2]}
                              for k in kernels[:15]]}
    log(f"[{tag}] host prep p50 {out['host_prep_ms_p50']:.2f} ms, "
        f"device forward p50 {fwd_p50:.2f} ms (profiled: "
        f"{out['profiled_forward_wall_ms']:.2f} ms wall); device busy "
        f"{busy_ms:.2f} ms per forward in "
        f"{out['device_launches_per_forward']:.2f} device launches (kernels, "
        f"memcpy, memset; {out['copy_launches_per_forward']:.1f} of them "
        f"copy / cast kernels), {out['host_syncs_per_forward']:.1f} host "
        f"synchronizes, idle share of the unprofiled forward "
        f"{out['device_idle_share']:.3f}")
    log(f"[{tag}] host prep parts p50 (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["host_prep_parts_ms_p50"].items()))
    for k in out["top_device_ops"][:8]:
        log(f"[{tag}]   {k['ms']:.4f} ms x{k['count']}  {k['name']}")
    return out


def fused_phase(actioner, observations, out_dir):
    """The fused serving path (device_preprocess=True) on `actioner`'s
    weights: launch counts per forward, predict p50 and its host part,
    count / overflow per observation, the action on a sparse observation
    against the host path's, the packed vector against the CPU's."""
    t0 = time.perf_counter()
    fused = Actioner(CONFIG, cli_opts=CLI_OPTS, device="cuda", seed=0,
                     device_preprocess=True, vox_capacity=FUSED_VOX_CAPACITY)
    fused.model.load_state_dict(actioner.model.state_dict())
    build_s = time.perf_counter() - t0
    payloads = requests(observations)
    fused.predict(**payloads[0])                          # warm-up
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    lat = []
    for p in payloads:
        t0 = time.perf_counter()
        action = fused.predict(**p)["action"]
        lat.append((time.perf_counter() - t0) * 1e3)
        if action.shape != (8,) or not np.isfinite(action).all():
            raise AssertionError(f"fused: bad action {action}")
    launches = dict(cuda_lib.LAUNCHES)
    for k, per in PER_FORWARD.items():
        if launches[k] != per * len(payloads):
            raise AssertionError(f"fused: {k} launched {launches[k]} times "
                                 f"in {len(payloads)} predicts, expected "
                                 f"{per} per forward (phase 4's)")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for p in payloads[:3]:
            fused.predict(**p)
    events = prof.key_averages()
    with open(os.path.join(out_dir, "profile_fused.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    busy = sum(k[1] for k in _device_ops(events, 3))
    syncs = _host_syncs(events, 3)
    fn = fused._fused_fn()
    host_ms, counts = [], []
    for i, o in enumerate(observations):
        emb = fused._instruction("close_jar", i, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        args = fused._fused_inputs(o, emb, 0)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        packed = fn(*args).cpu().numpy()
        host_n = len(actioner._host_prep("close_jar", i, o, None)[1])
        counts.append((int(packed[8]), host_n, int(packed[9])))
        if int(packed[9]) != 0 or int(packed[8]) != host_n:
            raise AssertionError(f"fused, observation {i}: count "
                                 f"{int(packed[8])} (host path {host_n}), "
                                 f"vox_overflow {int(packed[9])}")

    # a sparse observation: neither path subsamples; the host path at the
    # fused program's point capacity
    sparse = synthetic_observation(300, cameras=1, height=64, width=64)
    emb = actioner._instruction("close_jar", 0, None)
    pc_ft, centroid, radius, ee = actioner.process_point_clouds(
        np.stack(sparse["pc"], 0), np.stack(sparse["rgb"], 0),
        ee_pose=np.asarray(sparse["gripper"]),
        arm_links_info=sparse["arm_links_info"])
    if not 10 < len(pc_ft) < actioner.num_points:
        raise AssertionError(f"sparse observation: {len(pc_ft)} points")
    buckets = actioner._point_buckets
    actioner._point_buckets = (actioner.num_points,)
    try:
        host = actioner._forward([(pc_ft, emb, ee, 0)], 1)[0]
    finally:
        actioner._point_buckets = buckets
    host[:3] = host[:3] * radius + centroid
    host[2] = max(host[2], actioner.TABLE_HEIGHT + 0.005)
    packed = fn(*fused._fused_inputs(sparse, emb, 0)).cpu().numpy()
    if int(packed[8]) != len(pc_ft) or int(packed[9]) != 0:
        raise AssertionError(f"sparse: count {packed[8]} vs {len(pc_ft)}, "
                             f"overflow {packed[9]}")
    sparse_err = {"pos": float(np.abs(packed[:3] - host[:3]).max()),
                  "quat": float(np.abs(packed[3:7] - host[3:7]).max()),
                  "open_logit": float(abs(packed[7] - host[7]))}
    for k, bar in (("pos", 2e-4), ("quat", 1e-4), ("open_logit", 1e-3)):
        if sparse_err[k] > bar:
            raise AssertionError(f"fused vs host path on the sparse "
                                 f"observation: {k} {sparse_err[k]} > {bar}")

    # the same program on the CPU with the card's draws
    cpu = Actioner(CONFIG, cli_opts=CLI_OPTS, device="cpu", seed=0,
                   device_preprocess=True, vox_capacity=FUSED_VOX_CAPACITY)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               actioner.model.state_dict().items()})
    args = fused._fused_inputs(observations[0],
                               fused._instruction("close_jar", 0, None), 0)
    card = fn(*args).cpu().numpy()
    ref = cpu._fused_fn()(*[a.cpu() if torch.is_tensor(a) else a
                            for a in args]).numpy()
    cpu_err = float(np.abs(card - ref).max())
    if (np.abs(card - ref) > 1e-3 * np.maximum(1.0, np.abs(ref))).any() \
            or (card[8:] != ref[8:]).any():
        raise AssertionError(f"fused card vs CPU: {card} vs {ref}")
    out = {"build_s": build_s, "predict_p50_ms": float(np.median(lat)),
           "predict_ms": lat, "host_part_ms_p50": float(np.median(host_ms)),
           "host_part_ms": host_ms, "launches": launches,
           "device_busy_ms_per_predict": busy,
           "device_idle_share": 1.0 - busy / float(np.median(lat)),
           "host_launches_per_predict": _host_launches(events, 3),
           "host_syncs_per_predict": syncs,
           "count_host_overflow": counts, "sparse_points": len(pc_ft),
           "sparse_vs_host_max_diff": sparse_err,
           "card_vs_cpu_max_diff": cpu_err}
    log(f"[fused] predict p50 {out['predict_p50_ms']:.2f} ms (all "
        f"{[round(t, 2) for t in lat]}), host part (stack, pad, boxes, "
        f"upload, draws) p50 {out['host_part_ms_p50']:.2f} ms; launches "
        f"{launches}")
    log(f"[fused] device busy {busy:.2f} ms per predict (idle share "
        f"{out['device_idle_share']:.3f}), "
        f"{out['host_launches_per_predict']:.1f} host launch calls and "
        f"{syncs:.1f} stream / device synchronizes per predict "
        f"(profile_fused.txt)")
    log(f"[fused] (count, host count, vox_overflow) per observation "
        f"{counts}; sparse ({len(pc_ft)} points) vs host path {sparse_err}; "
        f"card vs CPU packed max |diff| {cpu_err:.3g}")
    return out


def reference_phase(actioner, obs, cpu_model=None, tag="reference",
                    cli_opts=CLI_OPTS, step_id=0):
    """The card's logits against the same weights run on the CPU (those
    of `cpu_model`, else the card's copied into a CPU model of
    `cli_opts`)."""
    actioner.rng = np.random.default_rng(3)
    emb, pc_ft, _, _, ee = actioner._host_prep("close_jar", 0, obs, None)
    batch = actioner._batch([(pc_ft, emb, ee, step_id)], 1)
    if cpu_model is None:
        cpu_model = cpu_copy(actioner, cli_opts).model
    with torch.inference_mode():
        gpu = actioner.model(batch)
        cpu = cpu_model({k: v.cpu() for k, v in batch.items()})
    errs = logits_close(gpu, cpu, ("pos", "rot", "open"), "")
    errs["pool_overflow"] = int(gpu["pool_overflow"])
    log(f"[{tag}] card vs CPU logits, max |diff|: {errs}")
    return errs


def cpu_copy(actioner, cli_opts=CLI_OPTS, **kw):
    """An Actioner on the CPU with the card's weights."""
    cpu = Actioner(CONFIG, cli_opts=cli_opts, device="cpu", **kw)
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               actioner.model.state_dict().items()})
    return cpu


def logits_close(gpu, cpu, keys, what):
    """max |card - CPU| of each output within 1e-3 * max(1, |ref|), over
    the entries the model does not mask (masked position candidates hold
    -1e9 on both sides)."""
    errs = {}
    for k in keys:
        ref = cpu[k]
        errs[k] = float((gpu[k].cpu() - ref).abs().max())
        lim = 1e-3 * max(1.0, float(ref[ref > -1e8].abs().max()))
        if errs[k] > lim:
            raise AssertionError(f"{what}{k}: card vs CPU max |diff| "
                                 f"{errs[k]} > {lim}")
    return errs


# ---------------------------------------------------------------- bf16 -----

# serving at ptv3_config compute_dtype bfloat16: the release YAMLs with this
# override; the model files and seeded weights are the fp32 ones
BF16_OPTS = ["MODEL.ptv3_config.compute_dtype", "bfloat16"]
BF16_FLOPS_PER_S = 989e12   # H100 SXM data sheet, dense bf16 tensor cores
# bar of a bf16 forward's heads against the same weights' fp32 forward (the
# JAX package's own, tests/test_policy.py) and against the port's bf16
# forward on the CPU (tests/test_torch_port_bf16.py HEAD_TOL): each of
# max(1, max|ref|)
BF16_VS_FP32_TOL = 0.08
BF16_CPU_TOL = 0.02
# launches per bf16 forward: the bf16 paths of K1-K4 take phase 4's counts
# and their fp32 paths none; the motion planner's stage-0 entry sort stays
# fp32 K9 (its input features are fp32), its categorical stem is bf16 K9
BF16_PER_FORWARD = {"patch_attention_bf16": 9, "subm_conv_bf16": 9,
                    "stem_conv_bf16": 1, "gather_rows_bf16": 4,
                    "gather_rows_smallc_bf16": 0, "patch_attention": 0,
                    "subm_conv": 0, "stem_conv": 0, "gather_rows": 0,
                    "gather_rows_smallc": 0}
BF16_CONCAT_PER_FORWARD = dict(BF16_PER_FORWARD, subm_conv_bf16=10,
                               stem_conv_bf16=0)
BF16_MP_PER_FORWARD = dict(BF16_PER_FORWARD, stem_conv_bf16=0,
                           gather_rows_smallc=1, gather_rows_smallc_bf16=1,
                           scatter_rows_smallc_add=0, conv_weight_grad=0,
                           scatter_rows_add=0, patch_attention_dropout=0,
                           patch_attention_dropout_bwd=0)
# the bf16 kernels of the kernels line, by their counter: the kernel each
# captured call goes to
BF16_SITES = {"patch_attention": "patch_attention_bf16",
              "subm_conv": "subm_conv_bf16", "stem_conv": "stem_conv_bf16",
              "gather_rows": "gather_rows_bf16",
              "gather_rows_smallc": "gather_rows_smallc_bf16"}


def check_bf16_call(kernel, args, timed=True, timing=None):
    """One captured bf16 call (compute_dtype bfloat16). K4 and K9 (copies)
    bit-equal to their plain versions; K1, K2 and K3 bit-equal across two
    launches and within the bar of ops/bf16.py of theirs: |kernel - plain|
    <= one bf16 ulp of max(|kernel|, |plain|) + 1e-4 * max(1, max|plain|)
    (fp32 sums taken in another order before the one rounding), K1 plus
    2^-7 sum_j p_j |v_j| (one bf16 ulp of each probability it rounds). If
    `timed`: event and profiler device times, the plain version's, the
    library call's (SDPA in bf16 for K1, the im2col gather + matmul in bf16
    for K2 / K3; torch.gather for K4 / K9, check_gather), and the bound:
    bytes at 3.35 TB/s against the flops (K2, K3: this call's live links)
    at 989 TFLOP/s bf16."""
    if kernel in GATHERS:
        return check_gather(kernel, args, {} if timed else None)
    extra, out_extra = None, {}
    if kernel == "patch_attention":
        q, k, v, kv, scale = args
        run = lambda: attention.patch_attention(q, k, v, kv, scale)  # noqa
        plain = lambda: attention.patch_attention_plain(q, k, v, kv, scale)  # noqa
        library = lambda: _sdpa(q, k, v, kv, scale)  # noqa: E731
        G, H, P, Dh = q.shape
        shape = [G, H, P, Dh]
        nbytes = 2 * 4 * q.numel() + kv.numel()
        flops = 4 * G * H * P * P * Dh
        profile = K1_PROFILE
        extra = attention.bf16_probability_allowance(q, k, v, kv, scale)
    elif kernel == "subm_conv":
        x, idx, ok, w, bias = args
        run = lambda: conv.subm_conv(x, idx, ok, w, bias)  # noqa: E731
        plain = lambda: conv.subm_conv_plain(x, idx, ok, w, bias)  # noqa
        library = _im2col(x, idx, ok, w)
        B, N, Cin = x.shape
        K, _, Cout = w.shape
        shape = [B, N, K, Cin, Cout]
        nbytes = 2 * (x.numel() + w.numel() + B * N * Cout) + 4 * Cout + \
            5 * idx.numel()
        flops = 2 * Cin * Cout * int(ok.sum())
        profile = K2_PROFILE
    else:
        x, idx, ok, w = args
        run = lambda: stem.stem_conv(x, idx, ok, w)  # noqa: E731
        plain = lambda: stem.stem_conv_plain(x, idx, ok, w)  # noqa
        library = _im2col(x, idx, ok, w)
        B, N, Cin = x.shape
        K, _, Cout = w.shape
        shape = [B, N, K, Cin, Cout]
        nbytes = 2 * (x.numel() + w.numel() + B * N * Cout) + \
            5 * idx.numel()
        flops = 2 * Cin * Cout * int(ok.sum())
        profile = K3_BF16_PROFILE
        out_extra = {"shares": stem_shares(ok), "live_links": int(ok.sum())}
    got = _twice(run, f"bf16 {kernel} {shape}")
    want = plain()
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 {kernel} {shape}: {got.dtype} output")
    err = float((got.float() - want.float()).abs().max())
    excess = bf16_excess(got, want, extra=extra)
    if not bool(torch.isfinite(got).all()) or excess > 0:
        raise AssertionError(f"bf16 {kernel} {shape}: max |kernel - plain| "
                             f"= {err}, {excess} past the bf16 bar")
    scale_ref = max(1.0, float(want.float().abs().max()))
    out = {"shape": shape, "max_abs_err": err, "max_rel_err": err / scale_ref,
           "bar_excess": excess, **out_extra}
    if not timed:
        return out
    bound_ms, t_b, t_f = _bound(nbytes, flops, BF16_FLOPS_PER_S)
    return {**out, "ms": cuda_ms(run, **(timing or {})),
            "device_ms": device_ms(run, profile[0], also=profile[1]),
            "plain_ms": cuda_ms(plain, **(PLAIN_TIMING if timing else {})),
            "library_ms": cuda_ms(library, **(timing or {})),
            "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f}


def bf16_kernel_rows(calls, timed_calls, tag):
    """Every captured bf16 call checked (check_bf16_call); the row of each
    bf16 kernel summed over `timed_calls` (one forward's), as the kernels
    line wants it."""
    rows, detail = {}, []
    for site, kernel in BF16_SITES.items():
        timed = timed_calls.get(site, [])
        res = [check_bf16_call(site, c) for c in timed]
        res += [check_bf16_call(site, c, timed=False)
                for c in calls.get(site, [])]
        detail += [dict(r, name=kernel) for r in res]
        t = [r for r in res if "ms" in r]
        if not t:
            continue
        rows[kernel] = {
            "max_abs_err": max(r["max_abs_err"] for r in res),
            "max_rel_err": max(r["max_rel_err"] for r in res),
            "ms": sum(r["ms"] for r in t),
            "device_ms": _total(r["device_ms"] for r in t),
            "plain_ms": sum(r["plain_ms"] for r in t),
            "bound_ms": sum(r["bound_ms"] for r in t),
            "bound_by": "bytes" if sum(r["bytes_s"] for r in t) >=
            sum(r["flops_s"] for r in t) else "operations",
            "library_ms": sum(r["library_ms"] for r in t),
            "calls": len(t), "checked_calls": len(res)}
        if site in GATHERS:
            rows[kernel]["library_device_ms"] = _total(
                r["library_device_ms"] for r in t)
        r = rows[kernel]
        log(f"[{tag}] {kernel}: {len(res)} calls within the bf16 bar (max "
            f"|kernel - plain| {r['max_abs_err']:.3g}); per forward "
            f"({len(t)} calls) {r['ms']:.4f} ms, device {r['device_ms']} "
            f"(plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']}"
            + (f"; torch.gather device {r['library_device_ms']}"
               if "library_device_ms" in r else "") + ")")
    return rows, detail


def _heads_vs(got, ref, keys, tol, what):
    """max |got - ref| of each head over the entries the model does not
    mask, within tol * max(1, max|ref|); raises otherwise."""
    errs = {}
    for k in keys:
        g, r = got[k].float().cpu(), ref[k].float().cpu()
        if g.dtype != torch.float32 or got[k].dtype != torch.float32:
            raise AssertionError(f"{what}{k}: head in {got[k].dtype}")
        live = r > -1e8
        errs[k] = float((g - r)[live].abs().max())
        lim = tol * max(1.0, float(r[live].abs().max()))
        if not bool(torch.isfinite(g[live]).all()) or errs[k] > lim:
            raise AssertionError(f"{what}{k}: max |diff| {errs[k]} > {lim}")
    return errs


def bf16_vs_references(model16, model32, batch, keys, cli_model, tag):
    """One bf16 forward on the card against the same weights' fp32 forward
    on the card (BF16_VS_FP32_TOL) and the bf16 port on the CPU
    (BF16_CPU_TOL); the backbone's activations bf16 (a forward hook on
    every block)."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, a, out: seen.append(
            (out[0] if isinstance(out, tuple) else out).dtype))
        for m in model16.ptv3_model.modules()
        if type(m).__name__ in ("Block", "CABlock")]
    try:
        with torch.inference_mode():
            got = model16(batch)
    finally:
        for h in hooks:
            h.remove()
    if not seen or any(d != torch.bfloat16 for d in seen):
        raise AssertionError(f"{tag}: backbone activations {set(seen)}")
    state32 = model32.state_dict()
    for k, v in model16.state_dict().items():
        if not torch.equal(v, state32[k]):
            raise AssertionError(f"{tag}: the fp32 model's {k} differs")
    cpu = build_model(cli_model, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         model16.state_dict().items()})
    with torch.inference_mode():
        fp32 = model32(batch)
        ref = cpu({k: v.cpu() for k, v in batch.items()})
    out = {"vs_fp32": _heads_vs(got, fp32, keys, BF16_VS_FP32_TOL,
                                f"{tag} bf16 vs fp32 "),
           "vs_cpu_bf16": _heads_vs(got, ref, keys, BF16_CPU_TOL,
                                    f"{tag} card vs CPU at bf16 ")}
    log(f"[{tag}] heads, max |bf16 - fp32| on the card (bar "
        f"{BF16_VS_FP32_TOL} x max(1, |fp32|)): {out['vs_fp32']}; card vs "
        f"the CPU port at bf16 (bar {BF16_CPU_TOL}): {out['vs_cpu_bf16']}")
    return out


def _launches_of(run):
    cuda_lib.reset_launches()
    run()
    torch.cuda.synchronize()
    return dict(cuda_lib.LAUNCHES)


def _held(launches, per_forward, forwards, what):
    for k, per in per_forward.items():
        if launches[k] != per * forwards:
            raise AssertionError(f"{what}: {k} launched {launches[k]} times "
                                 f"in {forwards} forwards, expected {per} "
                                 f"each")


def bf16_phase(actioner, observations, serving32, breakdown32, out_dir):
    """compute_dtype bfloat16 serving of the policy at the release width,
    the seed-0 weights of phase 4 (an fp32 file serves at bf16 as it is):
    a captured predict (every K1-K4 call against its bf16 plain version,
    timed) and a predict_batch of 4 (checked); phase 4's requests with
    launches held at BF16_PER_FORWARD; phase 5's breakdown; the heads
    against the fp32 forward and the CPU port at bf16; predict p50, device
    busy, launches and host synchronizes per forward beside phase 4/5's
    fp32 ones. Then the AdaNorm and Concat policies at bf16: one predict
    each, its calls checked (the Concat stem's K2 at 125 taps timed), its
    launches held, its heads against its fp32 forward."""
    tag = "bf16"
    t0 = time.perf_counter()
    cli = CLI_OPTS + BF16_OPTS
    a16 = Actioner(CONFIG, cli_opts=cli, device="cuda", seed=0)
    log(f"[{tag}] release-width Actioner at compute_dtype bfloat16 built in "
        f"{time.perf_counter() - t0:.2f} s")
    a16.rng = np.random.default_rng(0)
    one = capture_main_path(
        lambda: a16.predict(**requests(observations)[0]))
    four = capture_main_path(
        lambda: a16.predict_batch(requests(observations)))
    _held({k: len(one.get(s, [])) for s, k in BF16_SITES.items()},
          {k: BF16_PER_FORWARD[k] for k in BF16_SITES.values()}, 1,
          f"{tag} captured forward")
    rows, detail = bf16_kernel_rows(four, one, tag)
    del one, four
    serving16 = serving_phase(a16, observations, BF16_PER_FORWARD,
                              "bf16-serving")
    breakdown16 = breakdown_phase(a16, observations, out_dir,
                                  "profile_forward_bf16.txt",
                                  "bf16-breakdown")
    a16.rng = np.random.default_rng(3)
    emb, pc_ft, _, _, ee = a16._host_prep("close_jar", 0, observations[0],
                                          None)
    batch = a16._batch([(pc_ft, emb, ee, 0)], 1)
    heads = bf16_vs_references(a16.model, actioner.model, batch,
                               ("pos", "rot", "open"), a16.config.MODEL, tag)
    side = {}
    for name, r32, r16 in (
            ("predict_p50_ms", serving32, serving16),
            ("device_busy_ms_per_forward", breakdown32, breakdown16),
            ("host_launches_per_forward", breakdown32, breakdown16),
            ("device_launches_per_forward", breakdown32, breakdown16),
            ("host_syncs_per_forward", breakdown32, breakdown16),
            ("copy_launches_per_forward", breakdown32, breakdown16),
            ("device_idle_share", breakdown32, breakdown16)):
        side[name] = {"fp32": r32[name], "bf16": r16[name]}
    log(f"[{tag}] bf16 beside fp32 (this run, B = 1): " + "; ".join(
        f"{k} {v['bf16']:.2f} vs {v['fp32']:.2f}" for k, v in side.items()))
    g32 = breakdown32["device_ms_by_group"]
    for g, v in breakdown16["device_ms_by_group"].items():
        f = g32.get(g, {"ms": 0.0, "count": 0})
        log(f"[{tag}]   {g}: bf16 {v['ms']:.4f} ms x{v['count']}, fp32 "
            f"{f['ms']:.4f} ms x{f['count']} per forward")
    del a16
    torch.cuda.empty_cache()

    variants = {}
    for vtag, opts, per in (("adanorm", ADANORM_OPTS, BF16_PER_FORWARD),
                            ("concat", CONCAT_OPTS,
                             BF16_CONCAT_PER_FORWARD)):
        vt = f"bf16-{vtag}"
        v16 = Actioner(CONFIG, cli_opts=cli + opts, device="cuda", seed=0)
        v32 = Actioner(CONFIG, cli_opts=CLI_OPTS + opts, device="cuda",
                       seed=0)
        v16.rng = np.random.default_rng(0)
        captured = capture_main_path(
            lambda: v16.predict(**requests(observations)[0]))
        stem = [c for c in captured["subm_conv"] if c[3].shape[0] == 125]
        vrows, vdetail = bf16_kernel_rows(
            captured, {"subm_conv": stem[:1]} if stem else {}, vt)
        launches = _launches_of(
            lambda: v16.predict(**requests(observations)[1]))
        _held(launches, per, 1, vt)
        v16.rng = np.random.default_rng(3)
        emb, pc_ft, _, _, ee = v16._host_prep("close_jar", 0,
                                              observations[0], None)
        batch = v16._batch([(pc_ft, emb, ee, 0)], 1)
        variants[vtag] = {
            "launches": launches, "calls": vdetail,
            "heads": bf16_vs_references(v16.model, v32.model, batch,
                                        ("pos", "rot", "open"),
                                        v16.config.MODEL, vt)}
        if stem:
            variants[vtag]["stem_forward_b1"] = vrows["subm_conv_bf16"]
        del v16, v32, captured, stem
        torch.cuda.empty_cache()
    return {"kernels": rows, "calls": detail, "serving": serving16,
            "breakdown": breakdown16, "heads": heads,
            "bf16_beside_fp32": side, "variants": variants}


def bf16_mp_phase(engine32, mp_obs, mp_serving32, out_dir):
    """The motion planner at compute_dtype bfloat16 behind the GT pipeline
    (seed-0 weights, those of phase 15's fp32 engine): one request
    captured (its bf16 K9 call, the categorical stem's, timed; every
    K1, K2, K4 and K9 call against its bf16 plain version), phase 15's
    requests with launches held at BF16_MP_PER_FORWARD, the trajectory
    heads against the fp32 engine's and the CPU port's at bf16, request
    p50 and device busy beside phase 15's."""
    tag = "bf16-mp"
    e16 = MotionPlannerEngine(MP_CONFIG, cli_opts=BF16_OPTS, device="cuda",
                              seed=0)
    p16 = mp_pipeline(e16)
    captured = capture(lambda: mp_episode(p16, mp_obs[:1], 0),
                       SERVING_SITES + SMALLC_SITES)
    calls = {k: [a for a, _ in v] for k, v in captured.items()}
    # K9's bf16 call is the categorical stem's (the entry sort's is fp32)
    cat = [c for c in calls.pop("gather_rows_smallc")
           if c[0].dtype == torch.bfloat16]
    rows, detail = bf16_kernel_rows(calls, {"gather_rows_smallc": cat}, tag)
    del captured, calls, cat
    serving16, row = mp_serving_phase(p16, mp_obs, out_dir,
                                      "profile_mp_forward_bf16.txt", tag,
                                      BF16_MP_PER_FORWARD)
    inp, txt = row
    batch = e16._batch(inp["pc_fts"], inp["pc_labels"], txt)
    heads = bf16_vs_references(e16.model, engine32.model, batch,
                               ("pos", "rot", "open", "stop"),
                               e16.config.MODEL, tag)
    side = {k: {"fp32": mp_serving32[k], "bf16": serving16[k]}
            for k in ("request_p50_ms", "predict_ms_p50",
                      "device_busy_ms_per_forward",
                      "host_launches_per_forward",
                      "device_launches_per_forward",
                      "copy_launches_per_forward", "device_idle_share")}
    log(f"[{tag}] bf16 beside fp32 (this run): " + "; ".join(
        f"{k} {v['bf16']:.2f} vs {v['fp32']:.2f}" for k, v in side.items()))
    del e16, p16
    torch.cuda.empty_cache()
    return {"kernels": rows, "calls": detail, "serving": serving16,
            "heads": heads, "bf16_beside_fp32": side}


# ------------------------------------------------------------ training -----

TRAIN_TIMING = dict(rounds=5, reps=2, warmup=1)


def train_config(*opts):
    return get_config(CONFIG, TRAIN_OPTS + list(opts))


def train_config_val(*opts):
    return train_config(*VAL_OPTS, *opts)


def host_batches(batches, n):
    """n host batches from the trainer's loader, and the host ms each took
    (keystep preprocessing + collate)."""
    out, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out.append(next(batches))
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def _losses(losses):
    out = {k: float(v) for k, v in losses.items()}
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"non-finite losses {out}")
    return out


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0)


def _device_events(events):
    """The device-side events (kernels, memcpy/memset) of a profile; the
    CPU-side aten ops that launched them report the same time again."""
    return [e for e in events
            if str(e.device_type).endswith("CUDA") and _dev_us(e)]


def _device_ops(events, n):
    """(name, device ms per unit, count per unit) of the device-side
    events of a profile over n units, largest first."""
    return sorted(((e.key, _dev_us(e) / 1e3 / n, e.count // n)
                   for e in _device_events(events)), key=lambda t: -t[1])


def _device_launches(events, n):
    """Device launches (kernels, memcpy, memset) per unit of a profile over
    n units."""
    return sum(e.count for e in _device_events(events)) / n


# the host's runtime calls that put work on the device
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                     "cudaMemsetAsync")


def _host_launches(events, n):
    """The host's launch calls (kernels, memcpy, memset) per unit of a
    profile over n units: the same work as _device_launches, counted where
    it is issued, which the profiler records in full (its device-side
    count of one repeated forward moves between windows)."""
    return sum(e.count for e in events if e.key in HOST_LAUNCH_CALLS) / n


def _copy_launches(events, n):
    """Device copy kernels per unit of a profile over n units: dtype casts
    (a bf16 forward's per-call weight casts among them) and contiguous
    copies."""
    return sum(e.count for e in _device_events(events)
               if "copy_kernel" in e.key) / n


def _host_syncs(events, n):
    """The host's stream and device synchronizes per unit of a profile
    over n units (each blocks the host until the device drains)."""
    return sum(e.count for e in events if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize")) / n


def _group_device_ops(ops):
    """{DEVICE_GROUPS label or 'other': {'ms', 'count'}} of _device_ops'
    output, largest first."""
    groups = {}
    for name, ms, count in ops:
        g = next((label for label, keys in DEVICE_GROUPS
                  if any(k in name for k in keys)), "other")
        acc = groups.setdefault(g, [0.0, 0])
        acc[0] += ms
        acc[1] += count
    return {g: {"ms": v[0], "count": v[1]}
            for g, v in sorted(groups.items(), key=lambda t: -t[1][0])}


def training_phase(trainer, batches, out_dir, per_step=PER_STEP,
                   profile_file="profile_train.txt", tag="training",
                   nmap=False):
    """Counted steps (launches against per_step; the conditioning variants
    count all their batches), then, with a profile_file, a profiler window
    over PROFILE_STEPS more (TRAIN_STEPS counted) and, with `nmap`, the
    step's neighbour-map builds (nmap_phase)."""
    steps = TRAIN_STEPS if profile_file else len(batches)
    dev = [batch_to_device(b, "cuda") for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    step_ms, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        out = trainer.step(dev[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(_losses(out))
        log(f"[{tag}] step {i + 1}: {losses[-1]}")
    launches = dict(cuda_lib.LAUNCHES)
    for k, per in per_step.items():
        if launches[k] != per * steps:
            raise AssertionError(f"[{tag}] {k}: {launches[k]} launches in "
                                 f"{steps} training steps, expected {per} "
                                 "per step")
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_ms))
    out = {"step_ms": step_ms, "step_ms_p50": p50,
           "clouds_per_s": trainer_batch(batches) * 1e3 / p50,
           "peak_mem_gib": peak / 2 ** 30, "losses": losses,
           "launches_per_step": {k: launches[k] / steps for k in launches}}
    log(f"[{tag}] B={trainer_batch(batches)} x "
        f"{batches[0]['pc_fts'].shape[1]} points: step p50 {p50:.1f} ms "
        f"(all {[round(t, 1) for t in step_ms]}), "
        f"{out['clouds_per_s']:.1f} clouds/s, peak memory "
        f"{out['peak_mem_gib']:.2f} GiB")
    log(f"[{tag}] launches per step {out['launches_per_step']}")
    if not profile_file:
        return out, launches

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            trainer.step(dev[TRAIN_STEPS + i])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    ops = _device_ops(events, PROFILE_STEPS)
    with open(os.path.join(out_dir, profile_file), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=80))
    busy = sum(o[1] for o in ops)
    out.update({"profiled_step_wall_ms": wall_ms / PROFILE_STEPS,
                "device_busy_ms_per_step": busy,
                "device_idle_share": 1.0 - busy / p50,
                "device_ms_by_group": _group_device_ops(ops),
                "top_device_ops": [{"name": o[0][:80], "ms": o[1],
                                    "count": o[2]} for o in ops[:20]]})
    log(f"[{tag}] device busy {busy:.1f} ms per step (profiled wall "
        f"{out['profiled_step_wall_ms']:.1f} ms), idle share of the "
        f"unprofiled step {out['device_idle_share']:.3f}")
    for g, v in out["device_ms_by_group"].items():
        log(f"[{tag}]   {v['ms']:.3f} ms x{v['count']}  {g}")
    if nmap:
        out["nmap"] = nmap_phase(lambda: trainer.step(dev[TRAIN_STEPS]),
                                 PROFILE_STEPS, f"{tag} nmap")
    return out, launches


def trainer_batch(batches):
    return int(batches[0]["pc_fts"].shape[0])


def _err(got, want, what, tol=TOL):
    """max |got - want| after a sync; raises past tol * max|want|. The
    training kernels carry gradients, whose scale is far below 1 (~1e-7 at
    the release loss), so the bar is relative to the reference's own
    largest value, not to max(1, |want|)."""
    torch.cuda.synchronize()
    got, want = got.detach(), want.detach()
    if not got.numel():
        return 0.0
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or err > tol * scale or \
            (scale == 0.0 and err > 0.0):
        raise AssertionError(f"{what}: max |kernel - plain| = {err} > "
                             f"{tol} * {scale}")
    return err


def _timed(run, plain, library, nbytes, flops):
    bound_ms, t_b, t_f = _bound(nbytes, flops)
    return {"ms": cuda_ms(run, **TRAIN_TIMING),
            "plain_ms": cuda_ms(plain, **TRAIN_TIMING),
            "library_ms": cuda_ms(library, **TRAIN_TIMING)
            if library else None,
            "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f}


def _timed_tc(run, plain, library, nbytes, flops, name, also=()):
    """_timed for a kernel whose products run on the tensor cores as
    3xTF32: bound_ms is the bytes against 3 * flops at the TF32 rate;
    fp32_bound_ms the bytes against flops at the fp32 SIMT rate (the
    bound of the SIMT kernels' rows); device_ms from the profiler (`name`
    and `also` as device_ms takes them)."""
    bound_ms, t_b, t_f = _bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    return dict(_timed(run, plain, library, nbytes, flops),
                bound_ms=bound_ms, bytes_s=t_b, flops_s=t_f,
                fp32_bound_ms=_bound(nbytes, flops)[0],
                device_ms=device_ms(run, name, reps=4, also=also))


def _kernel_names(fn):
    """The device kernels one call of fn launches (profiler names)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in _device_events(prof.key_averages())})


def check_attention_train(call, log_sdpa=False):
    """K5 and K6 on one captured call: K5's bits against the PyTorch
    Philox mask and their keep fraction, K5 at rate 0 against K1, K5's
    (out, lse, bits) against its plain version, K6 on K5's outputs and the
    captured cotangent against its plain version; times beside the SDPA
    forward (dropout_p) and backward on the same inputs."""
    (q, k, v, kv, scale, rate, seed), g = call
    G, H, P, Dh = q.shape
    run5 = lambda: attention.patch_attention_dropout_fwd(  # noqa: E731
        q, k, v, kv, scale, rate, seed)
    plain5 = lambda: attention.patch_attention_dropout_fwd_plain(  # noqa
        q, k, v, kv, scale, rate, seed)
    out, lse, bits = run5()
    keep = attention.philox_keep_mask(seed, G, H, P, rate, q.device)
    if not torch.equal(bits, attention.pack_keep_bits(keep)):
        raise AssertionError(f"K5's bits {[G, H, P, Dh]} differ from "
                             "philox_keep_mask")
    n = keep.numel()
    frac = float(keep.float().mean())
    del keep
    if abs(frac - (1 - rate)) > 5 * math.sqrt(rate * (1 - rate) / n):
        raise AssertionError(f"keep fraction {frac} at rate {rate}")
    e0 = _err(attention.patch_attention_dropout(q, k, v, kv, scale, 0.0, 0),
              attention.patch_attention(q, k, v, kv, scale), "K5 rate 0")
    p_out, p_lse, _ = plain5()
    e5 = _err(out, p_out, f"K5 out {[G, H, P, Dh]}")
    # a patch with no valid key has lse = -1e9 (+ log P, below fp32's
    # resolution there): equal; the others within the bar
    live = kv.any(-1)
    e_lse = _err(lse[live], p_lse[live], f"K5 lse {[G, H, P, Dh]}")
    if not torch.equal(lse[~live], p_lse[~live]):
        raise AssertionError("K5 lse of a patch with no valid key")
    del p_out, p_lse
    run6 = lambda: attention.patch_attention_dropout_bwd(  # noqa: E731
        q, k, v, kv, out, lse, bits, g, scale, rate)
    plain6 = lambda: attention.patch_attention_dropout_bwd_plain(  # noqa
        q, k, v, kv, out, lse, bits, g, scale, rate)
    e6 = max(_err(a, b, f"K6 d{nm} {[G, H, P, Dh]}")
             for a, b, nm in zip(run6(), plain6(), "qkv"))
    mask = kv[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, dropout_p=rate, scale=scale)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                              dropout_p=rate, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, (qg, kg, vg), g, retain_graph=True)
    if log_sdpa:
        log(f"[train-kernels] SDPA forward kernels {_kernel_names(sdpa)}; "
            f"backward {_kernel_names(sdpa_bwd)}")
    qb = 4 * q.numel()
    side = 4 * (lse.numel() + bits.numel()) + kv.numel()   # lse, bits, kv
    flops = 2 * G * H * P * P * Dh                           # one product
    r5 = dict(_timed_tc(run5, plain5, sdpa, 4 * qb + side, 2 * flops,
                        "attn_drop_fwd"),
              max_abs_err=e5, lse_err=e_lse, rate0_vs_k1_err=e0,
              keep_fraction=frac, shape=[G, H, P, Dh])
    r6 = dict(_timed_tc(run6, plain6, sdpa_bwd, 8 * qb + side, 5 * flops,
                        "attn_drop_bwd"),
              max_abs_err=e6, shape=[G, H, P, Dh])
    return r5, r6


def check_weight_grad(call, im2col=True):
    """K7 on one captured conv or stem call (its x, map and the cotangent
    of its output), timed beside the im2col gather + matmul (two PyTorch
    calls, for reference; None with im2col False: at the Concat stem's
    B = 32 x 4096 x 125 taps x 263 channels its gather alone is 17 GB)."""
    (x, idx, ok, w, *_), g = call
    K, cin, cout = w.shape
    run = lambda: conv.conv_weight_grad(x, idx, ok, g)  # noqa: E731
    plain = lambda: conv.conv_weight_grad_plain(x, idx, ok, g)  # noqa
    shape = list(x.shape[:2]) + [K, cin, cout]
    err = _err(_twice(run, f"K7 {shape}"), plain(), f"K7 {shape}")
    nbytes = 4 * (x.numel() + g.numel() + w.numel()) + 5 * idx.numel()
    return dict(_timed_tc(run, plain, None, nbytes,
                          2 * cin * cout * int(ok.sum()), *K7_PROFILE),
                im2col_matmul_ms=cuda_ms(_im2col_wgrad(x, idx, ok, g),
                                         **TRAIN_TIMING) if im2col else None,
                max_abs_err=err, shape=shape, shares=link_shares(ok),
                pairs=ok.numel(),
                splits=conv.weight_grad_plan(*shape)[0])


def check_conv_dx(call):
    """The conv backward's dx (K8 onto voxel owners, then K2 with the
    mirrored weight) against the exact adjoint (autograd of
    subm_conv_plain) on every row; then the conv's two K2 launches of a
    training step, the forward and the mirrored weight on the owner sums,
    each against its plain version, bit-equal across two launches, and
    timed. Returns the dx row, the K8 result of the owner scatter, the
    two K2 results and the two K2 calls (for device_ms_queued)."""
    (x, idx, ok, w, bias), g = call
    B, N, cin = x.shape
    cout = w.shape[-1]
    shape = [B, N, idx.shape[-1], cin, cout]
    xr = x.clone().requires_grad_()
    exact = torch.autograd.grad(conv.subm_conv_plain(xr, idx, ok, w), xr,
                                g)[0]
    e_dx = _err(conv.conv_input_grad(g, idx, ok, w), exact,
                "conv dx vs the exact adjoint")
    del xr, exact
    # K8 as conv_input_grad calls it: the owner index with the sentinel
    # where the centre link is invalid
    owner = conv.owner_index(idx, ok)
    k8 = check_scatter_add(((g, owner), g))
    # K2's two launches of this conv in the step, timed on their inputs:
    # the forward, and the mirrored weight on the owner sums (the dx)
    gsum = gather.scatter_rows_add(g, owner, N)
    wm = conv.mirror_weight(w)
    flops = 2 * cin * cout * int(ok.sum())
    k2, runs = [], []
    for what, args, c_out in (("K2", (x, idx, ok, w, bias), cout),
                              ("mirrored K2", (gsum, idx, ok, wm), cin)):
        run = lambda a=args: conv.subm_conv(*a)  # noqa: E731
        runs.append(run)
        plain = lambda a=args: conv.subm_conv_plain(*a)  # noqa: E731
        err = _err(_twice(run, f"{what} {shape}"), plain(),
                   f"{what} {shape}")
        k2.append(dict(_timed_tc(run, plain, None,
                                 _conv_bytes(args[0], idx, args[3], c_out),
                                 flops, *K2_PROFILE),
                       max_abs_err=err, shape=shape,
                       shares=link_shares(ok), pairs=ok.numel()))
    return {"shape": list(x.shape) + [cout], "max_abs_err": e_dx,
            "mirrored_k2_err": k2[1]["max_abs_err"]}, k8, k2, runs


def _index_add(g, idx, n):
    """The library yardstick of a scatter-add that drops sentinel rows:
    one index_add_ into B * (n + 1) rows of g's dtype, each cloud's rows
    outside [0, n) sent to its spare row (the flat index built outside the
    timed call)."""
    B, _, D = g.shape
    spare = torch.where((idx >= 0) & (idx < n), idx, n).long()
    flat = (spare + torch.arange(B, device=idx.device)[:, None] * (n + 1)
            ).reshape(-1)
    return lambda: torch.zeros(B * (n + 1), D, device=g.device,
                               dtype=g.dtype).index_add_(0, flat,
                                                         g.reshape(-1, D))


def _scatter_add(g, idx, n):
    """The other library yardstick of K8 / K10: one scatter_add_ into
    (B, n + 1, D) of g's dtype, each cloud's rows outside [0, n) sent to
    its spare row (the int64 index, expanded over D, built outside the
    timed call)."""
    B, _, D = g.shape
    spare = torch.where((idx >= 0) & (idx < n), idx, n).long()
    sel = spare[..., None].expand(-1, -1, D)
    return lambda: torch.zeros(B, n + 1, D, device=g.device,
                               dtype=g.dtype).scatter_add_(1, sel, g)


def check_scatter_add(call):
    """K8 on one captured K4 call (its input and the cotangent of its
    output; the unpools' sentinel rows dropped), or on a conv's owner
    scatter (x stands in for the output shape): bit-equal across two
    launches, within the bar, event and profiler device times, the plain
    version's and index_add_'s."""
    (x, idx), g = call
    B, n, D = x.shape
    run = lambda: gather.scatter_rows_add(g, idx, n)  # noqa: E731
    plain = lambda: gather.scatter_rows_add_plain(g, idx, n)  # noqa: E731
    err = _err(_twice(run, f"K8 {list(g.shape)} -> {n}"), plain(),
               f"K8 {list(g.shape)} -> {n}")
    nbytes = 4 * (g.numel() + B * n * D) + idx.numel() * idx.element_size()
    return dict(_timed(run, plain, _index_add(g, idx, n), nbytes, g.numel()),
                device_ms=device_ms(run, K8_PROFILE, reps=4),
                max_abs_err=err, shape=list(g.shape) + [n],
                sentinel_rows=int(((idx < 0) | (idx >= n)).sum()))


def train_kernel_phase(captured):
    """Every K5-K8 input of one captured training step, K4's, K2's and
    K3's forward: checked and timed; returns the kernels-line rows (sums
    over the step), the K4, K2 and K3 rows per step and the detail."""
    att = [c for c in captured["attention"]]
    convs = [c for c in captured["subm_conv"] if c[1] is not None]
    stems = [c for c in captured["stem_conv"] if c[1] is not None]
    scat = [c for c in captured["gather_rows"] if c[1] is not None]
    expect = {"attention": 9, "conv": 9, "stem": 1,
              "scatter": PER_STEP["gather_rows"]}
    # K8 per step: these K4 backwards and the 9 conv dx owner sums
    for name, got in (("attention", att), ("conv", convs), ("stem", stems),
                      ("scatter", scat)):
        if len(got) != expect[name]:
            raise AssertionError(f"captured {len(got)} {name} calls with a "
                                 f"cotangent, expected {expect[name]}")
    res = {name: [] for name in TRAIN_KERNELS}
    for i, c in enumerate(att):
        r5, r6 = check_attention_train(c, log_sdpa=i == 0)
        res["patch_attention_dropout"].append(r5)
        res["patch_attention_dropout_bwd"].append(r6)
    res["conv_weight_grad"] = [check_weight_grad(c) for c in convs + stems]
    res["scatter_rows_add"] = [check_scatter_add(c) for c in scat]
    log(f"[train-kernels] K8 sentinel rows dropped per K4 backward: "
        f"{[r['sentinel_rows'] for r in res['scatter_rows_add']]}")
    k4 = [dict(check_gather("gather_rows", args, TRAIN_TIMING),
               name="gather_rows") for args, _ in captured["gather_rows"]]
    if len(k4) != PER_STEP["gather_rows"]:
        raise AssertionError(f"captured {len(k4)} K4 calls in a step, "
                             f"expected {PER_STEP['gather_rows']}")
    log_gathers("train-kernels", "K4 per training step", k4)
    # K3's forward on the step's B = 32 stem call (its dW is K7's, above)
    k3_row = dict(check_call("stem_conv", stems[0][0], timing=TRAIN_TIMING),
                  launches_per_step=len(stems))
    log_call("train-kernels", "K3 per training step", k3_row)
    k4_row = dict(_row(k4), device_ms=_total(r["device_ms"] for r in k4))
    log(f"[train-kernels] gather_rows: {len(k4)} calls per step, bit-equal, "
        f"{k4_row['ms']:.4f} ms ({k4_row['device_ms']} ms on the device; "
        f"plain {k4_row['plain_ms']:.4f}, bound {k4_row['bound_ms']:.4f}, "
        f"library {k4_row['library_ms']:.4f})")
    conv_dx, k2, k2_runs = [], [], []
    for c in convs:
        row, k8, k2_calls, runs = check_conv_dx(c)
        conv_dx.append(row)
        k2 += k2_calls
        k2_runs += runs
        res["scatter_rows_add"].append(k8)
    for r in res["conv_weight_grad"]:
        log_conv("train-kernels", "K7 per training step, call", r)
    k2_row = conv_step_row("train-kernels", "K2 per training step", k2,
                           k2_runs)
    del k2_runs
    rows = {}
    for name, rs in res.items():
        rows[name] = _row(rs)
        for key in ("fp32_bound_ms", "device_ms", "im2col_matmul_ms"):
            if key in rs[0]:
                rows[name][key] = _total(r[key] for r in rs)
        log(f"[train-kernels] {name}: {len(rs)} calls per step, max_abs_err "
            f"{rows[name]['max_abs_err']:.3g}, {rows[name]['ms']:.4f} ms "
            f"(device {rows[name].get('device_ms')}; plain "
            f"{rows[name]['plain_ms']:.4f}, bound "
            f"{rows[name]['bound_ms']:.4f} by {rows[name]['bound_by']}, "
            f"fp32 SIMT bound {rows[name].get('fp32_bound_ms')}, library "
            f"{rows[name]['library_ms']})")
    k5 = res["patch_attention_dropout"]
    log(f"[train-kernels] K5 keep fractions "
        f"{[round(r['keep_fraction'], 5) for r in k5]}; K5 at rate 0 vs K1 "
        f"max err {max(r['rate0_vs_k1_err'] for r in k5):.3g}; lse max err "
        f"{max(r['lse_err'] for r in k5):.3g}; bits bit-equal to "
        f"philox_keep_mask on all {len(k5)} calls")
    log(f"[train-kernels] conv dx (K8 + mirrored K2) vs the exact adjoint: "
        f"max err {max(m['max_abs_err'] for m in conv_dx):.3g}; mirrored K2 "
        f"vs plain {max(m['mirrored_k2_err'] for m in conv_dx):.3g}")
    rows["conv_weight_grad"]["shares"] = _shares(res["conv_weight_grad"])
    return rows, k4_row, k2_row, k3_row, {
        "calls": dict(res, gather_rows=k4, subm_conv=k2),
        "conv_dx": conv_dx}


def _phase_launches(run, expect, what):
    """Launch counters to 0, run, counters read: exactly the kernels of
    `expect`, each its count; returns the counts, the run's peak device
    memory (max_memory_allocated, GiB) and that peak above the memory in
    use before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    run()
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if {k: v for k, v in launches.items() if v} != expect:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{expect}")
    return launches, peak / 2 ** 30, (peak - base) / 2 ** 30


def stem_vjp_phase(call):
    """The stem conv's input gradient on the policy's captured training
    stem call (B = 32 x 4096, its x, map, weight and output cotangent):
    one forward and backward of stem_conv with x and W requiring
    gradients, launch counts (one K3, one K7, one K10) and peak memory;
    dx and dW against the CPU run of the same call (autograd of
    stem_conv_plain) within 1e-4 * max|ref|; K10 on the call's own
    operands (G = g W^T and the map with dead links at the sentinel, C = 7)
    against its plain version, timed beside its bound and the library
    calls. Returns the phase and its launches."""
    (x, idx, ok, w), g = call
    N = x.shape[1]
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    launches, peak, own = _phase_launches(
        lambda: stem.stem_conv(xg, idx, ok, wg).backward(g),
        {"stem_conv": 1, "conv_weight_grad": 1,
         "scatter_rows_smallc_add": 1}, "stem input gradient")
    t0 = time.perf_counter()
    xc, wc = x.cpu().requires_grad_(), w.cpu().requires_grad_()
    stem.stem_conv_plain(xc, idx.cpu(), ok.cpu(), wc).backward(g.cpu())
    cpu_s = time.perf_counter() - t0
    e_dx = _err(xg.grad.cpu(), xc.grad, "stem dx, card vs CPU")
    e_dw = _err(wg.grad.cpu(), wc.grad, "stem dW, card vs CPU")
    scale = {"dx": float(xc.grad.abs().max()),
             "dW": float(wc.grad.abs().max())}
    del xc, wc, xg, wg
    k10 = check_smallc_bwd(*stem.stem_grad_rows(g, idx, ok, w, N), N,
                           TRAIN_TIMING)
    out = {"shape": list(x.shape) + list(w.shape), "launches": launches,
           "peak_memory_gib": peak, "peak_above_start_gib": own,
           "dx_err": e_dx, "dW_err": e_dw, "ref_max": scale,
           "cpu_reference_s": cpu_s, "k10": k10}
    log(f"[stem-vjp] stem_conv forward + backward with the input requiring "
        f"a gradient, B = {x.shape[0]} x {N}: launches {launches}; peak "
        f"memory {peak:.3f} GiB ({own:.3f} above the phase's start); card "
        f"vs CPU max err dx {e_dx:.3g}, dW {e_dw:.3g} (max |ref| {scale}; "
        f"CPU reference {cpu_s:.1f} s)")
    log_k10("stem-vjp", "on the call's operands", k10)
    return out, launches


def _g_ulp(G, idx, n):
    """One bf16 ulp of the largest |G| row element that K10 adds into each
    dx element (B, n, C): what a G element rounded to the neighbouring
    bf16 value (the card's and the CPU's fp32 sums of G = g W^T breaking a
    rounding tie apart) can move dx by."""
    B, M, C = G.shape
    keep = (idx >= 0) & (idx < n)
    dest = torch.where(keep, idx, n).long()[..., None].expand(-1, -1, C)
    top = torch.zeros(B, n + 1, C, device=G.device).scatter_reduce_(
        1, dest, G.float().abs(), "amax")[:, :n]
    return bf16_ulp(top)


def bf16_stem_vjp_phase(call):
    """stem_vjp_phase at bf16: the captured B = 32 stem call with x, W and
    the output cotangent rounded to bf16, x and W requiring gradients:
    launches (one K3, one K7 and one K10 bf16) and peak memory; dx and dW
    against the CPU port at bf16 within the bar of ops/bf16.py at the
    gradients' scale (dx plus _g_ulp); K10 bf16 on the call's bf16
    operands (G = g W^T rounded per (row, tap), the map with dead links at
    the sentinel, C = 7) against its plain version, timed. Returns the
    phase and its launches."""
    (x, idx, ok, w), g = call
    x, w, g = (t.to(torch.bfloat16) for t in (x, w, g))
    N = x.shape[1]
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    launches, peak, own = _phase_launches(
        lambda: stem.stem_conv(xg, idx, ok, wg).backward(g),
        {"stem_conv_bf16": 1, "conv_weight_grad_bf16": 1,
         "scatter_rows_smallc_add_bf16": 1}, "bf16 stem input gradient")
    G, flat = stem.stem_grad_rows(g, idx, ok, w, N)
    extra = _g_ulp(G, flat, N)
    t0 = time.perf_counter()
    xc, wc = x.cpu().requires_grad_(), w.cpu().requires_grad_()
    stem.stem_conv(xc, idx.cpu(), ok.cpu(), wc).backward(g.cpu())
    cpu_s = time.perf_counter() - t0
    e_dx = _bf16_err(xg.grad, xc.grad.cuda(), "bf16 stem dx, card vs CPU",
                     extra=extra)
    e_dw = _bf16_err(wg.grad, wc.grad.cuda(), "bf16 stem dW, card vs CPU")
    scale = {"dx": float(xc.grad.float().abs().max()),
             "dW": float(wc.grad.float().abs().max())}
    del xc, wc, xg, wg, extra
    k10 = check_smallc_bwd(G, flat, N, TRAIN_TIMING)
    del G, flat
    out = {"shape": list(x.shape) + list(w.shape), "launches": launches,
           "peak_memory_gib": peak, "peak_above_start_gib": own,
           "dx_err": e_dx, "dW_err": e_dw, "ref_max": scale,
           "cpu_reference_s": cpu_s, "k10": k10}
    log(f"[bf16-stem-vjp] stem_conv at bf16, forward + backward with the "
        f"input requiring a gradient, B = {x.shape[0]} x {N}: launches "
        f"{launches}; peak memory {peak:.3f} GiB ({own:.3f} above the "
        f"phase's start); card vs the CPU port at bf16 max err dx "
        f"{e_dx:.3g}, dW {e_dw:.3g} (max |ref| {scale}; CPU reference "
        f"{cpu_s:.1f} s)")
    log_k10("bf16-stem-vjp", "on the call's bf16 operands", k10)
    return out, launches


def conv_step_row(tag, label, calls, runs):
    """The row of K2's 9 forward + 9 mirrored dx launches of one training
    step (sums over the calls), logged per call and in total; the device
    time of the 18 launches also by events with the launches queued
    (device_ms_queued over `runs`), which stands in for the per-call
    profiler sum where a call's window recorded nothing."""
    for i, r in enumerate(calls):
        log_conv(tag, f"{label}, {'forward' if i % 2 == 0 else 'dx'}", r)
    row = dict(_row(calls), launches_per_step=len(calls),
               shares=_shares(calls))
    for key in ("fp32_bound_ms", "device_ms"):
        row[key] = _total(r[key] for r in calls)
    row["device_ms_queued"] = device_ms_queued(runs)
    row["device_ms_from"] = "profiler" if row["device_ms"] is not None \
        else "queued events"
    if row["device_ms"] is None:
        row["device_ms"] = row["device_ms_queued"]
    log(f"[{tag}] {label}: {len(calls)} launches, {row['ms']:.4f} ms "
        f"(device {row['device_ms']} from the {row['device_ms_from']}, "
        f"queued events {row['device_ms_queued']}; plain "
        f"{row['plain_ms']:.4f}; bound "
        f"{row['bound_ms']:.4f} TF32, {row['fp32_bound_ms']:.4f} fp32 SIMT)"
        f"; shares {row['shares']}")
    return row


class LeakyReluDecisions:
    """Leaky-ReLU decisions recorded on one device and followed on another,
    around one step (patches F.leaky_relu).

    A leaky ReLU is max(z, s z): its gradient is 1 or s (0.02 in the action
    heads) by the sign of z. Where a pre-activation lies within rounding of
    0, the card and the CPU, which round the layers before it differently
    (~1e-6 relative), can take different branches, and that element's
    gradient then differs by 1 / s: a near tie, like two rows of a max
    reduction within rounding of each other. One such element moves the
    weight gradient of the layer before the kink past GRAD_TOL.

    follow=None: record each call's decisions (z > 0), in call order.
    follow=decisions of another run of the same step: keep this run's
    forward values but take the gradient of the recorded branch where the
    two differ, provided the element is a tie (|z| <= tol of the call's
    max|z|) and at most `limit` elements are followed in all; anything
    else raises. `forced` counts the followed elements, `worst` is their
    largest |z| over their call's max|z|."""

    def __init__(self, follow=None, tol=KINK_TOL, limit=MAX_KINKS):
        self.follow, self.tol, self.limit = follow, tol, limit
        self.decisions, self.forced, self.worst = [], 0, 0.0
        self._leaky = None

    def __enter__(self):
        self._leaky = F.leaky_relu
        F.leaky_relu = self._call
        return self

    def __exit__(self, *exc):
        F.leaky_relu = self._leaky

    def _call(self, z, negative_slope=0.01, inplace=False):
        if inplace:
            raise ValueError("LeakyReluDecisions: in-place leaky ReLU")
        out = self._leaky(z, negative_slope)
        pos = (z > 0).detach()
        i = len(self.decisions)
        self.decisions.append(pos.cpu())
        if self.follow is None:
            return out
        if i >= len(self.follow) or self.follow[i].shape != pos.shape:
            raise ValueError(f"leaky ReLU call {i}: no recorded decisions "
                             f"of shape {tuple(pos.shape)} to follow")
        want = self.follow[i].to(pos.device)
        differ = want != pos
        if not bool(differ.any()):
            return out
        za = z.detach().abs()
        rel = float(za[differ].max()) / max(float(za.max()), 1e-30)
        if rel > self.tol:
            raise ValueError(f"leaky ReLU call {i}: decisions differ at |z| "
                             f"= {rel:.3g} of max|z|, not a tie")
        self.forced += int(differ.sum())
        if self.forced > self.limit:
            raise ValueError(f"leaky ReLU call {i}: {self.forced} decisions "
                             f"followed, more than {self.limit}")
        self.worst = max(self.worst, rel)
        branch = torch.where(want, z, negative_slope * z)
        # the forward value of this run, the gradient of the followed branch
        return out.detach() + (branch - branch.detach())


class MaxDecisions:
    """Max reductions' decisions recorded on one device and followed on
    another, around one step: the grid poolings' segment maxima
    (ptv3.segment_reduce 'max') and the heads' pooled max
    (heads.masked_max), patched for the step.

    follow=None: record, per call, where each output's maxima sit (a bool
    of the reduced values, ties included). follow=the records of another
    run of the same step: keep this run's forward values, and route each
    output's cotangent to the recorded maxima, split evenly among tied
    ones as the max's own backward splits it. At bf16 the card and the CPU
    round values apart by an ulp and rank hundreds of near ties apart at
    every pooling; following the card's decisions leaves their gradients
    comparable. `differ` counts, per call, the values whose max membership
    differs between the two runs."""

    def __init__(self, follow=None):
        self.follow, self.masks, self.differ = follow, [], []
        self._saved = []

    def __enter__(self):
        for mod, attr, make in ((ptv3_mod, "segment_reduce", self._segment),
                                (heads_mod, "masked_max", self._masked)):
            self._saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, make(getattr(mod, attr)))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)

    def _route(self, own, values, group):
        """Records `own` (this run's maxima); following, returns the
        surrogate whose cotangent goes to the recorded maxima:
        group(values * weights), weights = mask / its group's count."""
        i = len(self.masks)
        self.masks.append(own.cpu())
        if self.follow is None:
            return None
        want = self.follow[i].to(own.device)
        if want.shape != own.shape:
            raise ValueError(f"max call {i}: no recorded decisions of shape "
                             f"{tuple(own.shape)} to follow")
        self.differ.append(int((want != own).sum()))
        w = want.to(torch.float32)
        w = w / group(w, True).clamp(min=1.0)
        return group(values * w.to(values.dtype), False)

    def _segment(self, fn):
        def run(values, maps, child_cap, reduce="max"):
            out = fn(values, maps, child_cap, reduce)
            if reduce != "max":
                return out
            B, N, C = values.shape
            seg = maps.seg_sorted[..., None].expand(B, N, C)

            def group(v, gather_back):
                tot = v.new_zeros((B, child_cap + 1, C)).scatter_add_(1, seg,
                                                                      v)
                if gather_back:
                    return tot.gather(1, seg)
                return torch.where(maps.child_mask[..., None],
                                   tot[:, :child_cap], 0.0)
            with torch.no_grad():
                raw = values.new_full((B, child_cap + 1, C), -math.inf)
                raw.scatter_reduce_(1, seg, values, reduce="amax",
                                    include_self=True)
                own = values == raw.gather(1, seg)
            sur = self._route(own, values, group)
            return out if sur is None else out.detach() + (sur - sur.detach())
        return run

    def _masked(self, fn):
        def run(x, mask):
            out = fn(x, mask)

            def group(v, gather_back):
                tot = v.sum(1, keepdim=gather_back)
                return tot.expand_as(v) if gather_back else tot
            with torch.no_grad():
                own = (x == out[:, None]) & mask[..., None]
            sur = self._route(own, x, group)
            return out if sur is None else out.detach() + (sur - sur.detach())
        return run


def _record_max_decisions(model):
    """Forward pre-hooks that record each max reduction's decision: the
    winning row of every (segment, channel) of each grid pooling (lowest row
    on an exact tie) and the winning point of every (cloud, channel) of the
    head's pooled max; and hooks that record when each module first starts
    and first ends. Returns ([(module name, decisions)], {module name:
    [start, end]}, hook handles)."""
    rec, spans, clock = [], {}, iter(range(1 << 62))

    def start_hook(name):
        def hook(mod, args):
            spans.setdefault(name, [next(clock), None])
        return hook

    def end_hook(name):
        def hook(mod, args, out):
            if spans[name][1] is None:
                spans[name][1] = next(clock)
        return hook

    def pool_hook(name):
        def hook(mod, args):
            feat, maps, child_cap = args[:3]
            with torch.no_grad():
                v = mod.proj(feat)
                B, N, C = v.shape
                seg = maps.seg_sorted[..., None].expand(B, N, C)
                best = v.new_full((B, child_cap + 1, C), -math.inf)
                best.scatter_reduce_(1, seg, v, reduce="amax")
                rows = torch.arange(N, device=v.device)[None, :, None]
                rows = torch.where(v == best.gather(1, seg), rows, N)
                win = torch.full((B, child_cap + 1, C), N, device=v.device)
                rec.append((name, win.scatter_reduce_(
                    1, seg, rows, reduce="amin").cpu()))
        return hook

    def head_hook(mod, args):
        emb, mask = args[0], args[1]
        with torch.no_grad():
            rec.append(("act_proj_head", torch.where(
                mask[..., None], emb, -math.inf).argmax(1).cpu()))
    handles = []
    for n, m in model.named_modules():
        handles += [m.register_forward_pre_hook(start_hook(n)),
                    m.register_forward_hook(end_hook(n))]
    handles += [m.register_forward_pre_hook(pool_hook("ptv3_model." + n))
                for n, m in model.ptv3_model.named_children()
                if n.endswith("_down")]
    handles.append(model.act_proj_head.register_forward_pre_hook(head_hook))
    return rec, spans, handles


def _one_step(cfg, loss_fn, batch, dev, follow=None, kink_limit=MAX_KINKS,
              kink_tol=KINK_TOL, maxes=None):
    """One dropout-0 step with the injected permutations; the losses, the
    gradients, the updated state, the max decisions, the module spans, the
    seconds and the leaky-ReLU decisions (LeakyReluDecisions: recorded, or
    with `follow` the recorded ones followed at ties), on the host.
    `maxes`: a MaxDecisions to run the step in (recording or following),
    or None."""
    act_cfg = dict(cfg.MODEL.action_config, pos_heatmap_type=cfg.TRAIN_DATASET
                   .get("pos_heatmap_type", "dist"))
    loss_cfg = dict(cfg.MODEL.loss_config)
    model = build_model(cfg.MODEL, device=dev, seed=1)
    opt, _ = build_optimizer(model, dict(cfg.TRAIN))
    trainer = Trainer(model, lambda p, b: loss_fn(p, b, act_cfg, loss_cfg),
                      opt, Randomness(0, dev, perms=CHECK_PERMS))
    decisions, spans, handles = _record_max_decisions(model)
    t0 = time.perf_counter()
    with LeakyReluDecisions(follow, kink_tol, kink_limit) as kinks, \
            (maxes or contextlib.nullcontext()):
        losses = _losses(trainer.step(batch_to_device(batch, dev)))
    seconds = time.perf_counter() - t0
    for h in handles:
        h.remove()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    state = {n: t.detach().cpu() for n, t in model.state_dict().items()}
    return losses, grads, state, decisions, spans, seconds, kinks


def _module_start(spans, leaf):
    """When the module of parameter `leaf` first started; for a parameter
    read outside its own module's forward (an embedding table read as
    .weight), the start of its nearest ancestor that ran, which is no
    later than the read."""
    name = leaf.rpartition(".")[0]
    while name not in spans:
        name = name.rpartition(".")[0]
    return spans[name][0]


def _check_slice(host_batch, i, host_structure):
    """The B = 2 slice i of a host-structured batch: with its order_perm
    (one for the whole batch), or without it (TRAIN.host_structure False:
    the model draws the orders; the rows stay presorted, which is one
    input order among others)."""
    out = {k: v[2 * i:2 * i + 2] for k, v in host_batch.items()
           if k != "order_perm"}
    if host_structure:
        out["order_perm"] = host_batch["order_perm"]
    return out


DDP_STEPS = 2
TP_STEPS = DDP_STEPS
TP_PREDICTS = 4
TP_TIMEOUT = 360.0   # both tp processes, from their start
NEAR_ZERO = 1e-6   # |gradient| within rounding of 0 at the release loss


def _grads_and_stats(trainer):
    """Clones of the trainer's gradients and batch-norm statistics."""
    return ({k: p.grad.detach().clone()
             for k, p in trainer.model.named_parameters()},
            {k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()
             if "running_" in k})


def _params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def _bit_equal_steps(got, plain, tag):
    for i, ((lg, gg, sg, pg), (lp, gp, sp, pp)) in enumerate(zip(got,
                                                                 plain)):
        if lg != lp:
            raise AssertionError(f"[{tag}] step {i + 1} losses {lg} != {lp}")
        for what, a, b in (("gradient", gg, gp), ("statistic", sg, sp),
                           ("parameter", pg, pp)):
            if set(a) != set(b) or not b:
                raise AssertionError(f"[{tag}] step {i + 1}: {what} names")
            diff = [k for k in b if not torch.equal(a[k], b[k])]
            if diff:
                raise AssertionError(f"[{tag}] step {i + 1}: {len(diff)} "
                                     f"{what}s not bit-equal, e.g. {diff[:3]}")


def zero1_phase(host, tag="zero1"):
    """DDP_STEPS policy steps on host batches, first by the plain trainer,
    then in a one-process NCCL group through build_trainer's ZeRO-1 step,
    its TRAIN.zero1_manual step and the replicated DistributedDataParallel
    module: each bit-equal to the plain steps after each step, launches
    held at PER_STEP; the group left afterwards. Returns the phase's
    record and the plain steps' (losses, gradients, parameters) on the
    host for the tp phase."""
    t0 = time.perf_counter()
    dev = [batch_to_device(b, "cuda") for b in host[1:1 + DDP_STEPS]]

    def steps(trainer):
        out = []
        for b in dev:
            losses = trainer.step(b)
            out.append((_losses(losses), *_grads_and_stats(trainer),
                        _params(trainer.model)))
        torch.cuda.synchronize()
        return out

    trainer, batches, _ = build_trainer(train_config(), SPEC, device="cuda")
    if hasattr(batches, "close"):
        batches.close()
    replicated = zero.state_bytes(trainer.optimizer)
    total = sum(p.numel() for p in trainer.model.parameters())
    plain = steps(trainer)
    ref = {"losses": [p[0] for p in plain],
           "grads": [{k: v.cpu() for k, v in p[1].items()} for p in plain],
           "params": {k: v.cpu() for k, v in plain[-1][3].items()},
           # the steps' learning rates, summed: how far apart an Adam step
           # can take an element whose gradient is within rounding of 0
           "lr": sum(float(trainer.optimizer.lr_fn(k))
                     for k in range(DDP_STEPS))}
    del trainer
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    if not dist.init_distributed("nccl", f"tcp://localhost:{port}", 1, 0):
        raise AssertionError(f"[{tag}] no process group joined")
    runs = {}
    try:
        for name, opts in (("zero1", ()), ("zero1_manual", (
                "TRAIN.zero1_manual", "True")), ("ddp", ())):
            trainer, batches, _ = build_trainer(train_config(*opts), SPEC,
                                                device="cuda")
            if hasattr(batches, "close"):
                batches.close()
            shard = trainer.optimizer.shard
            if shard is None or trainer.manual != (name == "zero1_manual"):
                raise AssertionError(f"[{tag}] {name}: the step runs no "
                                     "ZeRO-1 optimizer")
            if name == "ddp":      # the replicated formulation
                opt, _ = build_optimizer(trainer.model,
                                         dict(train_config().TRAIN))
                trainer = Trainer(trainer.model, trainer.loss_fn, opt,
                                  trainer.rng,
                                  net=dist.wrap_model(trainer.model,
                                                      torch.device("cuda")))
                if type(trainer.net).__name__ != "DistributedDataParallel":
                    raise AssertionError(f"[{tag}] ddp: {type(trainer.net)}")
            cuda_lib.reset_launches()
            got = steps(trainer)
            launches = dict(cuda_lib.LAUNCHES)
            sharded = zero.state_bytes(trainer.optimizer)
            del trainer
            for k, per in PER_STEP.items():
                if launches[k] != per * DDP_STEPS:
                    raise AssertionError(
                        f"[{tag}] {name} {k}: {launches[k]} launches in "
                        f"{DDP_STEPS} steps, expected {per} a step")
            _bit_equal_steps(got, plain, f"{tag} {name}")
            runs[name] = {"launches_per_step": {
                k: v / DDP_STEPS for k, v in launches.items() if v},
                "state_bytes": sharded}
            del got
            torch.cuda.empty_cache()
    finally:
        dist.leave()
    torch.cuda.empty_cache()
    if dist.joined():
        raise AssertionError(f"[{tag}] the process group is still joined")
    out = {"steps": DDP_STEPS, "clouds": trainer_batch(host),
           "gradients": len(plain[0][1]), "statistics": len(plain[0][2]),
           "parameters": total, "losses": ref["losses"], "runs": runs,
           # each process's moments under ZeRO-1 at dp processes: the
           # shard's length (parallel/zero.py FlatShard), the same buffers
           "state_bytes_replicated": replicated,
           "state_bytes_zero1": {dp: replicated // total * -(-total // dp)
                                 for dp in (1, 2, 4, 8)},
           "seconds": time.perf_counter() - t0}
    del plain
    log(f"[{tag}] {DDP_STEPS} steps at B = {out['clouds']} in a one-process "
        f"NCCL group through the ZeRO-1 step, the zero1_manual step and "
        f"DistributedDataParallel: {out['gradients']} gradients, "
        f"{out['statistics']} batch-norm statistics, the parameters and the "
        f"losses bit-equal to the plain steps after each step; optimizer "
        f"state a process {replicated} B replicated, ZeRO-1 "
        f"{out['state_bytes_zero1']} B by dp; {out['seconds']:.1f} s")
    return out, ref


def _finite(x):
    """x, or inf where it is NaN or infinite: a gate `not (x <= tol)` then
    fails on it."""
    x = float(x)
    return x if math.isfinite(x) else math.inf


def _tp_compare(whole, ref, device="cuda"):
    """(max |tp - plain| over the parameter elements whose gradient is not
    within rounding of 0 at every plain step, the largest over the
    others) after the tp steps; inf where a parameter is not finite."""
    live_max = near_max = 0.0
    for k, want in ref["params"].items():
        diff = (whole[k].to(device) - want.to(device)).abs()
        live = torch.ones_like(diff, dtype=torch.bool)
        for g in ref["grads"]:
            live &= g[k].to(device).abs() > NEAR_ZERO
        if bool(live.any()):
            live_max = max(live_max, _finite(diff[live].max()))
        if bool((~live).any()):
            near_max = max(near_max, _finite(diff[~live].max()))
    return live_max, near_max


def _tp_grads(got, want, sharded):
    """The last step's gradients against the plain step's: each leaf's
    largest |tp - plain| relative to the leaf's largest |plain| floored at
    1e-3 of the largest of all leaves (inf where not finite). Returns the
    worst leaf and its gap, the median gap over every leaf and over the
    tp-sharded leaves, and the leaves past GRAD_TOL. The medians are held
    to GRAD_TOL (tp_phase): a wrong backward of Megatron's f or g moves
    the gradient of every leaf upstream of an MLP or CPE pair, or of the
    sharded leaves themselves, while a max reduction (grid pooling, the
    heads' pooled max) whose candidates lie within rounding of each other
    can pick another row under the tp sums' order and move the gradient
    rows of a few leaves, as the step checks find between card and CPU."""
    scales = {k: float(g.abs().max()) for k, g in want.items()}
    floor = 1e-3 * max(scales.values())
    rel = {k: _finite((got[k].float() - want[k].to(got[k].device)).abs()
                      .max()) / max(scales[k], floor) for k in want}
    worst = max(rel, key=rel.get)
    return {"grad_rel_max": rel[worst], "grad_worst": worst,
            "grad_rel_median": float(np.median(list(rel.values()))),
            "grad_rel_median_sharded": float(np.median(
                [rel[k] for k in sharded])),
            "grad_leaves": len(rel),
            "grad_past_tol": sorted(k for k, v in rel.items()
                                    if not v <= GRAD_TOL)}


def tp_worker(rank, port, tmp):
    """One of the tp phase's two processes (python3 chip_smoke.py
    --tp-worker RANK PORT DIR): a gloo group on the card, a dp = 1 x tp =
    2 mesh; TP_STEPS steps of the release policy's trainer with its MLP
    and CPE pairs on their tp shards, then the sharded Actioner's and
    motion planner's requests. Process 0 holds them against the plain
    results in DIR/inputs.pt and writes DIR/out.json."""
    from robot3dlotus_tpu_torch.parallel.mesh import (make_mesh, shard_model,
                                                      whole_state_dict)
    import faulthandler
    # where a process waits, in its log, while the phase's deadline runs
    faulthandler.dump_traceback_later(TP_TIMEOUT / 4, repeat=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    cuda_lib.library()
    log(f"[tp {rank}] kernels loaded")
    # a peer that stops answering fails the phase within the timeout
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=2,
        rank=rank, timeout=datetime.timedelta(seconds=TP_TIMEOUT / 2))
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    log(f"[tp {rank}] joined, inputs loaded")
    mesh = make_mesh(tp=2)
    cfg = train_config()
    seed = int(cfg.get("SEED", 2024))
    model = build_model(cfg.MODEL, device="cuda", seed=seed)
    shard_model(model, mesh)
    act_cfg, loss_cfg = driver.task_configs(cfg)
    opt, _ = build_optimizer(model, dict(cfg.TRAIN), mesh=mesh)
    trainer = Trainer(model, lambda p, b, group=None: SPEC.loss_fn(
        p, b, act_cfg, loss_cfg, group=group),
        opt, Randomness(seed + mesh.dp_index, "cuda"), mesh=mesh)
    dev = [batch_to_device(b, "cuda") for b in inp["batches"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    losses, step_ms = [], []
    for b in dev:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(_losses(trainer.step(b)))
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        log(f"[tp {rank}] step {len(step_ms)}: {step_ms[-1]:.1f} ms")
    launches = dict(cuda_lib.LAUNCHES)
    sharded = sorted(model.tp_plan)
    out = {"rank": rank, "mesh": mesh.shape, "losses": losses,
           "step_ms": step_ms, "launches": launches,
           "sharded_leaves": len(sharded),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": zero.state_bytes(opt)}
    whole = whole_state_dict(model)
    grads = whole_state_dict(model, {k: p.grad for k, p in
                                     model.named_parameters()})
    del trainer, opt, dev
    if rank == 0:
        out["live_max"], out["near_max"] = _tp_compare(whole, inp)
        out.update(_tp_grads(grads, inp["grads"][-1], sharded))
    del whole, grads, model
    torch.cuda.empty_cache()
    obs = [synthetic_observation(100 + i) for i in range(TP_PREDICTS)]
    acts = {}
    for tag, mesh_spec in (("tp", "tp=2"), ("plain", None)):
        if tag == "plain" and rank != 0:
            break
        actioner = Actioner(CONFIG, cli_opts=CLI_OPTS, device="cuda", seed=0,
                            mesh=mesh_spec)
        acts[tag], ms = [], []
        for i, req in enumerate(requests(obs)):
            actioner.rng = np.random.default_rng(i)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            acts[tag].append(actioner.predict(**req)["action"])
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        out[f"{tag}_predict_ms"] = ms
        del actioner
        engine = MotionPlannerEngine(MP_CONFIG, device="cuda", seed=0,
                                     mesh=mesh_spec)
        rng = np.random.RandomState(3)
        n = engine.num_points - 5
        feat = int(engine.config.MODEL.ptv3_config.in_channels)
        txt = int(engine.act_cfg.get("txt_ft_size", 512))
        acts[f"mp_{tag}"] = engine.predict(
            rng.uniform(-0.4, 0.4, (n, feat)).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int32),
            rng.randn(3, txt).astype(np.float32),
            np.asarray([0.1, -0.2, 0.9, 0, 0, 0, 1, 1], np.float32),
            pc_centroid=np.zeros(3), pc_radius=1.0, table_height=-10.0)
        del engine
        torch.cuda.empty_cache()
    if rank == 0:
        out["predict_max_diff"] = max(
            _finite(np.abs(a - b).max()) for a, b in zip(acts["tp"],
                                                         acts["plain"]))
        out["predict_equal"] = all(np.array_equal(a, b) for a, b in
                                   zip(acts["tp"], acts["plain"]))
        out["mp_max_diff"] = _finite(np.abs(acts["mp_tp"] -
                                            acts["mp_plain"]).max())
    with open(os.path.join(tmp, f"out{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.leave()


def tp_phase(host, ref, tag="tp"):
    """The collectives probe, then the tp phase's two processes (tp_worker)
    on the zero1 phase's batches and plain results; raises unless both
    end, the losses are within rtol 2e-4 and the parameters within 5e-5
    of the plain steps' (where the gradient is not within rounding of 0;
    there within 3 x the steps' summed lr), the last step's gradients'
    median leaf and median tp-sharded leaf within GRAD_TOL of the plain
    step's (_tp_grads), every kernel launched its PER_STEP count a step
    on both processes, and the sharded requests give the plain answers
    within 2e-4. At the release schedule's warmup the steps' lr sums to
    ~3e-8, so the parameters cannot tell a wrong gradient and the losses
    see the forward only: the gradients hold the backward. Every gate is
    written `not (gap <= bar)`, so that a NaN fails it."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_collectives_probe import probe
    t0 = time.perf_counter()
    collectives = probe()
    log(f"[{tag}] collectives of two processes on the card: "
        f"{json.dumps(collectives)}")
    if any(v != "ok" for v in collectives["gloo"].values()):
        raise AssertionError(f"[{tag}] gloo cannot run the tp path's "
                             f"collectives: {collectives['gloo']}")
    tmp = os.path.join(ROOT, "build", "smoke_tp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(dict(ref, batches=host[1:1 + TP_STEPS]),
               os.path.join(tmp, "inputs.pt"))
    log(f"[{tag}] inputs written, {torch.cuda.memory_reserved()} B of the "
        f"card reserved here; starting the two processes")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # each process's output to a file: a pipe that fills while the other
    # process is waited on would stop its writer in the middle of a
    # collective
    logs = [os.path.join(tmp, f"log{r}.txt") for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--tp-worker",
                 str(r), str(port), tmp], stdout=f,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TP_TIMEOUT
    try:
        while any(p.poll() is None for p in procs) and \
                time.monotonic() < deadline:
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, path in zip(procs, logs):
        with open(path) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f"[{tag}] a tp process exited with "
                                 f"{p.returncode}: {text[-3000:]}")
    outs = []
    for r in range(2):
        with open(os.path.join(tmp, f"out{r}.json")) as f:
            outs.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    first = outs[0]
    for o in outs:
        for k, per in PER_STEP.items():
            if o["launches"].get(k, 0) != per * TP_STEPS:
                raise AssertionError(
                    f"[{tag}] process {o['rank']} {k}: "
                    f"{o['launches'].get(k, 0)} launches in {TP_STEPS} "
                    f"steps, expected {per} a step")
        for i, (got, want) in enumerate(zip(o["losses"], ref["losses"])):
            for k, v in want.items():
                if not abs(got[k] - v) <= 2e-4 * abs(v):
                    raise AssertionError(f"[{tag}] step {i + 1} loss {k}: "
                                         f"{got[k]} vs the plain {v}")
    if not (first["live_max"] <= 5e-5 and
            first["near_max"] <= 3.0 * ref["lr"]):
        raise AssertionError(f"[{tag}] parameters {first['live_max']} "
                             f"(near-zero gradients {first['near_max']}) "
                             f"from the plain steps'")
    if not (first["grad_rel_median"] <= GRAD_TOL and
            first["grad_rel_median_sharded"] <= GRAD_TOL and
            math.isfinite(first["grad_rel_max"])):
        raise AssertionError(
            f"[{tag}] last step's gradients: median leaf "
            f"{first['grad_rel_median']}, median tp-sharded leaf "
            f"{first['grad_rel_median_sharded']}, worst "
            f"{first['grad_rel_max']} ({first['grad_worst']}) from the "
            f"plain step's; past {GRAD_TOL}: {first['grad_past_tol']}")
    if not (first["predict_max_diff"] <= 2e-4 and
            first["mp_max_diff"] <= 2e-4):
        raise AssertionError(f"[{tag}] sharded requests "
                             f"{first['predict_max_diff']} / "
                             f"{first['mp_max_diff']} from the plain ones")
    out = {"collectives": collectives, "processes": outs,
           "loss_max_rel": max(abs(o["losses"][i][k] - v) / abs(v)
                               for o in outs
                               for i, w in enumerate(ref["losses"])
                               for k, v in w.items() if v),
           "seconds": time.perf_counter() - t0}
    log(f"[{tag}] dp = 1 x tp = 2 in two processes on the card (gloo): "
        f"{TP_STEPS} steps at B = {trainer_batch(host)}, losses within "
        f"{out['loss_max_rel']:.3g} (relative), the last gradients' "
        f"median leaf {first['grad_rel_median']:.3g} and median tp-sharded "
        f"leaf {first['grad_rel_median_sharded']:.3g} (relative; worst "
        f"{first['grad_rel_max']:.3g} at {first['grad_worst']}; "
        f"{len(first['grad_past_tol'])} of {first['grad_leaves']} leaves "
        f"past {GRAD_TOL}: {first['grad_past_tol']}), parameters within "
        f"{first['live_max']:.3g} ({first['near_max']:.3g} where the "
        f"gradient is within rounding of 0); step ms {first['step_ms']}; "
        f"{TP_PREDICTS} sharded predicts within "
        f"{first['predict_max_diff']:.3g} (bit-equal: "
        f"{first['predict_equal']}), predict ms {first['tp_predict_ms']} "
        f"(plain {first['plain_predict_ms']}); motion planner within "
        f"{first['mp_max_diff']:.3g}; peak {first['peak_bytes']} B, "
        f"optimizer state {first['state_bytes']} B a process; "
        f"{out['seconds']:.1f} s")
    return out


def _cols_row(what, got, full_cols, want, err):
    """A tp-width check's record: its error against the plain version and
    its gap to the full-width kernel's columns."""
    gap = float((got.float() - full_cols.float()).abs().max())
    return {"what": what, "max_abs_err": err, "full_width_gap": gap,
            "full_width_bit_equal": bool(torch.equal(got, full_cols)),
            "shape": list(want.shape)}


def tp_widths_phase(calls, tag="tp-widths"):
    """K2 (forward and the dx's mirrored conv) and K7 at the tp path's
    widths on each captured CPE call, at fp32 and bf16, against their
    plain versions and the full-width kernel's columns; K2 and K7 at C/2
    and C/4 timed on the first call (C = 64) and the widest (C = 768).
    Raises past the bars of the phases that check them at full width."""
    t0 = time.perf_counter()
    rows, timed = [], {}
    widest = max(range(len(calls)), key=lambda i: calls[i][0][3].shape[-1])
    for n, ((x32, idx, ok, w32, bias), g32) in enumerate(calls):
        C = w32.shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            x, w, g = (t.to(dtype) for t in (x32, w32, g32))
            full = conv.subm_conv(x, idx, ok, w, bias)
            full_dw = conv.conv_weight_grad(x, idx, ok, g)
            full_dx = conv.conv_input_grad(g, idx, ok, w)
            for tp in (2, 4):
                cols = slice(0, C // tp)
                shape = [*x.shape[:2], idx.shape[-1], x.shape[-1], C // tp]
                name = f"{'bf16 ' if dtype != torch.float32 else ''}" \
                    f"tp={tp} {shape}"
                wc, bc, gc = w[..., cols].contiguous(), bias[cols], \
                    g[..., cols].contiguous()
                y = conv.subm_conv(x, idx, ok, wc, bc)
                want = conv.subm_conv_plain(x, idx, ok, wc, bc)
                err = _err(y, want.to(y.dtype), f"K2 {name}") \
                    if dtype == torch.float32 else _bf16_err(
                        y, want, f"K2 {name}", relative=False)
                rows.append(_cols_row(f"K2 {name}", y, full[..., cols],
                                      want, err))
                dw = conv.conv_weight_grad(x, idx, ok, gc)
                want = conv.conv_weight_grad_plain(x, idx, ok, gc)
                rows.append(_cols_row(f"K7 {name}", dw, full_dw[..., cols],
                                      want, _err(dw, want, f"K7 {name}")))
                # the dx at Cin = C / tp: the mirrored conv of one tp
                # process, and the tp processes' partials summed
                parts = [conv.conv_input_grad(
                    g[..., r * (C // tp):(r + 1) * (C // tp)].contiguous(),
                    idx, ok, w[..., r * (C // tp):(r + 1) * (C // tp)]
                    .contiguous()) for r in range(tp)]
                xr = x32.clone().requires_grad_()
                exact = torch.autograd.grad(conv.subm_conv_plain(
                    xr, idx, ok, w[..., cols].float()), xr,
                    gc.float())[0]
                del xr
                err = _err(parts[0], exact, f"dx {name}") \
                    if dtype == torch.float32 else _bf16_err(
                        parts[0], exact.to(dtype), f"dx {name}")
                summed = sum(p.float() for p in parts).to(dtype)
                rows.append(_cols_row(f"dx {name}", summed, full_dx, exact,
                                      err))
                del parts, exact, summed
                if n in (0, widest):
                    for what, run, plain, nbytes, flops in (
                            ("K2", lambda a=(x, idx, ok, wc, bc):
                             conv.subm_conv(*a),
                             lambda a=(x, idx, ok, wc, bc):
                             conv.subm_conv_plain(*a),
                             _conv_bytes(x, idx, wc, C // tp),
                             2 * x.shape[-1] * (C // tp) * int(ok.sum())),
                            ("K7", lambda a=(x, idx, ok, gc):
                             conv.conv_weight_grad(*a),
                             lambda a=(x, idx, ok, gc):
                             conv.conv_weight_grad_plain(*a),
                             x.element_size() * (x.numel() + gc.numel())
                             + 4 * wc.numel() + 5 * idx.numel(),
                             2 * x.shape[-1] * (C // tp) * int(ok.sum()))):
                        peak = TF32_FLOPS_PER_S if dtype == torch.float32 \
                            else BF16_FLOPS_PER_S
                        mult = 3 if dtype == torch.float32 else 1
                        bound_ms = _bound(nbytes, mult * flops, peak)[0]
                        timed[f"{what} {name}"] = {
                            "ms": cuda_ms(run, **TRAIN_TIMING),
                            "plain_ms": cuda_ms(plain, **TRAIN_TIMING),
                            "bound_ms": bound_ms,
                            "full_width_ms": cuda_ms(
                                (lambda: conv.subm_conv(x, idx, ok, w, bias))
                                if what == "K2" else
                                (lambda: conv.conv_weight_grad(x, idx, ok,
                                                               g)),
                                **TRAIN_TIMING)}
            del x, w, g, full, full_dw, full_dx
        torch.cuda.empty_cache()
    out = {"checks": rows, "timed": timed,
           "bit_equal_columns": sum(r["full_width_bit_equal"] for r in rows),
           "seconds": time.perf_counter() - t0}
    for k, r in timed.items():
        log(f"[{tag}] {k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f}, full width {r['full_width_ms']:.4f})")
    gaps = {}
    for r in rows:
        key = r["what"].split(" [")[0]
        gaps[key] = max(gaps.get(key, 0.0), r["full_width_gap"])
    log(f"[{tag}] {len(rows)} checks on {len(calls)} CPE calls, every one "
        f"within its plain version's bar; {out['bit_equal_columns']} "
        f"bit-equal to the full-width kernel's columns; largest gaps "
        f"{json.dumps(gaps)}; {out['seconds']:.1f} s")
    return out


def step_check_phase(host_batch, config=train_config, loss_fn=compute_loss,
                     tag="step-check", slices=CHECK_SLICES,
                     per_step=PER_STEP, per_step_redraw=PER_STEP_REDRAW,
                     kink_limit=MAX_KINKS, tols=None, kink_tol=KINK_TOL,
                     order_kernels=ORDER_KERNELS, fp32_config=None,
                     follow_maxes=False, zero_grads=()):
    """One step at dropout 0 on each of the first `slices` B = 2 slices of
    a host-structured batch, with the batch's order_perm
    (TRAIN.host_structure), then on slice 0 without it and with injected
    order permutations (the key False), the same seeded weights on the
    card and on the CPU: the losses, every updated parameter and running
    statistic at TOL, and every gradient at GRAD_TOL. The card step's K4,
    K9 and K8 launches must be per_step's (with order_perm) or
    per_step_redraw's (without).

    A gradient below a max reduction (grid pooling, the head's pooled max)
    moves as a whole to another row when two candidates lie within rounding
    of each other and the card and the CPU rank them apart, which is no
    kernel error. So the check counts, per slice and per reduction, the max
    decisions on which the two differ. On a slice where some differ it
    still holds the gradient of every module that first starts after the
    last such reduction has ended (no backward through a differing
    decision reaches it), and reports the worst of the rest. Every gradient
    must be held on at least one slice.

    A leaky ReLU (the action heads) is max(z, 0.02 z): a pre-activation
    within rounding of 0 takes the other branch on the other device and
    moves that element's gradient 50-fold, which moved
    `act_proj_head.heatmap_mlp_fc1.weight` by up to 1.7e-3. The CPU run
    follows the card's leaky-ReLU decisions where they differ and the
    element is a tie (|z| <= KINK_TOL max|z|, at most kink_limit elements,
    MAX_KINKS unless the phase passes its own;
    LeakyReluDecisions raises otherwise), keeping its own forward
    values.

    `tols` ({"loss", "state", "grad"}: TOL, TOL, GRAD_TOL by default) and
    `kink_tol` set the bars (the bf16 phases' are wider); with a
    "grad_l2" bar every slice also holds all gradients together to it
    (their relative L2 distance), in place of each gradient on some slice
    (at bf16 the max decisions differ on every slice: bf16 values tie and
    round apart far more often). With `follow_maxes` the CPU run follows
    the card's max decisions (MaxDecisions) as it follows its leaky-ReLU
    ties, and every gradient is held on every slice. `order_kernels` the
    counters
    held against per_step / per_step_redraw. With `fp32_config` (a bf16
    step check), slice 0 also runs the step on the CPU at fp32 from the
    same weights, and the card's bf16 step must be nearer the CPU's bf16
    step than that fp32 step is, on the losses and on the held gradients
    as a whole (their relative L2 distance). `zero_grads`: patterns of
    gradients that are zero up to rounding (a bias in front of a batch
    norm, which takes any shift out), held only with all the others to the
    "grad_l2" bar: their per-gradient error is the two devices' rounding
    noise over itself."""
    tols = tols or {"loss": TOL, "state": TOL, "grad": GRAD_TOL}
    cfg = config("MODEL.ptv3_config.attn_drop", "0.0",
                 "MODEL.ptv3_config.proj_drop", "0.0",
                 "MODEL.action_config.dropout", "0.0")
    if "order_perm" not in host_batch:
        raise AssertionError(f"[{tag}] the host batch has no order_perm: "
                             "TRAIN.host_structure did not run")
    rows, held_somewhere = [], set()
    cases = [(i, True) for i in range(slices)] + [(0, False)]
    for i, structured in cases:
        batch = _check_slice(host_batch, i, structured)
        cuda_lib.reset_launches()
        mc = MaxDecisions() if follow_maxes else None
        lc, gc, sc, dc, spans, tc, kc = _one_step(cfg, loss_fn, batch,
                                                  "cuda", maxes=mc)
        want = per_step if structured else per_step_redraw
        got = {k: cuda_lib.LAUNCHES[k] for k in order_kernels}
        if got != {k: want[k] for k in order_kernels}:
            raise AssertionError(f"[{tag}] slice {i}, host structure "
                                 f"{structured}: launches {got}")
        mr = MaxDecisions(mc.masks) if follow_maxes else None
        lr, gr, sr, dr, _, tr, kr = _one_step(cfg, loss_fn, batch, "cpu",
                                              kc.decisions, kink_limit,
                                              kink_tol, mr)
        differ = {}
        for (name, a), (_, b) in zip(dc, dr):
            if (a != b).any():
                differ[name] = differ.get(name, 0) + int((a != b).sum())
        row = {"slice": i, "host_structure": structured,
               "order_launches": got,
               "max_decisions": sum(d.numel() for _, d in dr),
               "differing": differ, "kinks_followed": kr.forced,
               "kink_worst": kr.worst, "losses_card": lc, "losses_cpu": lr,
               "loss": max(abs(lc[k] - lr[k]) / max(1.0, abs(lr[k]))
                           for k in lr)}
        row["state"], worst_state = 0.0, None
        for n, t in sr.items():
            if t.is_floating_point():
                e = float((sc[n] - t).abs().max()) / max(
                    1.0, float(t.abs().max()))
                if e > row["state"]:
                    row["state"], worst_state = e, n
        gmax = max(float(g.abs().max()) for g in gr.values())
        rel = {n: float((gc[n] - g).abs().max()) /
               max(float(g.abs().max()), 1e-3 * gmax) for n, g in gr.items()}
        last_end = max((spans[name][1] for name in differ), default=-1)
        held = [n for n in gr if (follow_maxes or not differ or
                                  _module_start(spans, n) > last_end) and
                not any(re.search(z, n) for z in zero_grads)]
        if follow_maxes:
            row["max_values_followed"] = sum(mr.differ)
        held_somewhere.update(held)
        row["grad_l2"] = _grad_l2(gc, gr, list(gr))
        free = set(gr).difference(held)
        row.update(grads=len(gr), grads_held=len(held),
                   grad_rel=max((rel[n] for n in held), default=0.0),
                   grad_rel_not_held=max(((rel[n], n) for n in free),
                                         default=None))
        rows.append(row)
        rest = ("none" if not free else "{:.3g} ({})".format(
            *row["grad_rel_not_held"]))
        log(f"[{tag}] B=2 (slice {i}), dropout 0, "
            + (f"order_perm {host_batch['order_perm'].tolist()} "
               if structured else "injected permutations ")
            + f"(K4/K9/K8 launches {got}): "
            f"{row['max_decisions']} max decisions, differing between card "
            f"and CPU {differ or 'on none'}"
            + (f" (the CPU follows the card's: {row['max_values_followed']} "
               "values' max membership followed)" if follow_maxes else "")
            + "; leaky-ReLU ties followed "
            f"{kr.forced} (|z| <= {kr.worst:.3g} max|z|); losses card {lc} "
            f"vs CPU {lr}; "
            f"worst relative errors: loss {row['loss']:.3g}, state "
            f"{row['state']:.3g} ({worst_state}), {len(held)} of {len(gr)} "
            f"gradients held {row['grad_rel']:.3g}, the rest {rest}; all "
            f"gradients' relative L2 {row['grad_l2']:.3g} (card {tc:.2f} s, "
            f"CPU {tr:.2f} s per step)")
        if row["loss"] > tols["loss"]:
            raise AssertionError(f"slice {i}: card vs CPU losses {lc} vs {lr}")
        if row["state"] > tols["state"]:
            raise AssertionError(f"slice {i}: card vs CPU updated "
                                 f"{worst_state}: {row['state']}")
        for n in held:
            if rel[n] > tols["grad"]:
                raise AssertionError(f"slice {i}: card vs CPU gradient {n}: "
                                     f"{rel[n]} of max(|grad|, 1e-3 "
                                     f"max|grads|)")
        if row["grad_l2"] > tols.get("grad_l2", math.inf):
            raise AssertionError(f"slice {i}: card vs CPU gradients, "
                                 f"relative L2 {row['grad_l2']}")
        if fp32_config is not None and i == 0 and structured:
            row["nearer_than_fp32"] = _nearer_than_fp32(
                fp32_config, loss_fn, batch, lc, gc, lr, gr, tag)
    missing = sorted(n for n in set(gr) - held_somewhere
                     if not any(re.search(z, n) for z in zero_grads))
    if missing and "grad_l2" not in tols:
        raise AssertionError(f"{len(missing)} gradients held on no slice of "
                             f"{len(cases)}, e.g. {missing[:5]}")
    return {"slices": rows, "loss": max(r["loss"] for r in rows),
            "state": max(r["state"] for r in rows),
            "grad_rel": max(r["grad_rel"] for r in rows),
            "grad_l2": max(r["grad_l2"] for r in rows)}


def _grad_l2(g, ref, names):
    """||g - ref|| / ||ref|| over the gradients `names` together."""
    return float(torch.cat([(g[n] - ref[n]).reshape(-1) for n in names])
                 .norm() / torch.cat([ref[n].reshape(-1) for n in names])
                 .norm())


def _nearer_than_fp32(fp32_config, loss_fn, batch, lc, gc, lr, gr, tag):
    """The CPU port's fp32 step on the same slice and weights against the
    CPU port's bf16 step (lr, gr), beside the card's bf16 step (lc, gc):
    the card must be nearer on the relative L2 distance of all gradients
    together and on most gradients one by one (their max |difference|);
    the losses' distances are logged beside."""
    cfg = fp32_config("MODEL.ptv3_config.attn_drop", "0.0",
                      "MODEL.ptv3_config.proj_drop", "0.0",
                      "MODEL.action_config.dropout", "0.0")
    l32, g32, *_ = _one_step(cfg, loss_fn, batch, "cpu")

    def loss_d(a):
        return max(abs(a[k] - lr[k]) / max(1.0, abs(lr[k])) for k in lr)

    def leaf_d(g):
        return {n: float((g[n] - gr[n]).abs().max()) for n in gr}
    d16, d32 = leaf_d(gc), leaf_d(g32)
    ratios = sorted(d16[n] / max(d32[n], 1e-30) for n in gr)
    out = {"loss_card_bf16": loss_d(lc), "loss_cpu_fp32": loss_d(l32),
           "grads_card_bf16": _grad_l2(gc, gr, list(gr)),
           "grads_cpu_fp32": _grad_l2(g32, gr, list(gr)),
           "leaves": len(gr),
           "leaves_card_nearer": sum(d16[n] < d32[n] for n in gr),
           "leaf_ratio_median": ratios[len(ratios) // 2],
           "leaf_ratio_q90": ratios[int(0.9 * (len(ratios) - 1))]}
    log(f"[{tag}] distance to the CPU port's bf16 step, the card's bf16 "
        f"step beside the CPU port's fp32 step: {out}")
    if not (out["grads_card_bf16"] < out["grads_cpu_fp32"] and
            2 * out["leaves_card_nearer"] > out["leaves"]):
        raise AssertionError(f"[{tag}] the card's bf16 step is not nearer "
                             f"the CPU's bf16 step than its fp32 step: "
                             f"{out}")
    return out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


class _TimedPrefetch(PrefetchToDevice):
    """run_training's PrefetchToDevice, recording per batch the prefetch
    thread's wait on the host loader (host_ms) and the training thread's
    wait in next() (wait_ms)."""
    runs = []

    def __init__(self, it, *args, **kwargs):
        self.host_ms, self.wait_ms = [], []
        super().__init__(self._timed(iter(it)), *args, **kwargs)
        _TimedPrefetch.runs.append(self)

    def _timed(self, it):
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.host_ms.append((time.perf_counter() - t0) * 1e3)
                yield batch
        finally:
            if hasattr(it, "close"):
                it.close()

    def __next__(self):
        t0 = time.perf_counter()
        batch = super().__next__()
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        return batch


class _Serial:
    """The loop in series (the one before the prefetch): each host batch
    made on the training thread when the step asks for it, then copied to
    the card; timed as _TimedPrefetch times the prefetch (host_ms: making
    the batch; wait_ms: making and copying it)."""
    runs = []

    def __init__(self, it, device="cuda", depth=2):
        self.it, self.device = iter(it), device
        self.host_ms, self.wait_ms = [], []
        _Serial.runs.append(self)

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.it)
        self.host_ms.append((time.perf_counter() - t0) * 1e3)
        out = batch_to_device(batch, self.device)
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def close(self):
        if hasattr(self.it, "close"):
            self.it.close()


def entry_phase(module=train_simple_policy, config=train_config,
                steps=ENTRY_STEPS, per_step=PER_STEP, tag="entry",
                device_clouds_per_s=None, serial=False):
    """module.main (train_simple_policy or train_motion_planner) on the
    card as a user starts it: `steps` steps of run_training, host batches
    made by the loader's TRAIN.n_workers worker processes and prefetched
    onto the card (serial: TRAIN.n_workers 0 and no prefetch, each batch
    made on the training thread when the step asks for it), a log line
    after step steps / 2 and after the last (each reads the losses, a
    sync). Launch counters read against per_step; the end-to-end rate is
    the clouds of the second half over the time between the two lines,
    printed beside device_clouds_per_s (the training phase's device-step
    rate)."""
    half = steps // 2
    run = os.path.join(ROOT, "build", "smoke_runs", tag)
    shutil.rmtree(run, ignore_errors=True)     # a fresh run: no resume
    cfg = config("output_dir", run, "TRAIN.num_train_steps", str(steps),
                 "TRAIN.log_steps", str(half),
                 *(("TRAIN.n_workers", "0") if serial else ()))
    logger = logging.getLogger("robot3dlotus_tpu_torch.train")
    handler, level = _Records(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    cuda_lib.reset_launches()
    prefetch = _Serial if serial else _TimedPrefetch
    prefetch.runs = []
    t0 = time.perf_counter()
    try:
        with _Patch(driver, "PrefetchToDevice", lambda _: prefetch):
            trainer = module.main(cfg)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
        shutil.rmtree(run, ignore_errors=True)
    total_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    if trainer.optimizer.count != steps:
        raise AssertionError(f"entry point ran {trainer.optimizer.count} "
                             f"steps, expected {steps}")
    del trainer
    for k, per in per_step.items():
        if launches[k] != per * steps:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{steps} entry-point steps, expected "
                                 f"{per} per step")
    lines = [r for r in handler.records if r.getMessage().startswith("step ")]
    if len(lines) != 2:
        raise AssertionError(f"entry point logged {len(lines)} step lines")
    for r in lines:
        values = [float(kv.split("=")[1]) for kv in
                  r.getMessage().split(": ", 1)[1].split(", ")]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"entry point: {r.getMessage()}")
    clouds = half * int(cfg.TRAIN.train_batch_size)
    span_s = lines[1].created - lines[0].created
    (pre,) = prefetch.runs
    out = {"steps": steps, "serial": serial, "wall_s": total_s,
           "second_half_s": span_s,
           "clouds_per_s": clouds / span_s,
           "step_ms": span_s * 1e3 / half,
           "n_workers": int(cfg.TRAIN.n_workers),
           "host_ms_per_batch": pre.host_ms,
           "batch_wait_ms": pre.wait_ms,
           "launches": launches,
           "log": [r.getMessage() for r in lines]}
    if device_clouds_per_s:
        out["device_step_clouds_per_s"] = device_clouds_per_s
        out["end_to_end_over_device"] = \
            out["clouds_per_s"] / device_clouds_per_s
    log(f"[{tag}] {module.__name__.rsplit('.', 1)[-1]}.main"
        f"{' in series' if serial else ''}, {steps} steps "
        f"in {total_s:.2f} s (build included); steps {half + 1}-{steps} "
        f"{out['step_ms']:.1f} ms each with their host batches, "
        f"{out['clouds_per_s']:.2f} clouds/s end to end"
        + (f" against {device_clouds_per_s:.2f} device-step clouds/s "
           f"({out['end_to_end_over_device']:.3f}x)"
           if device_clouds_per_s else ""))
    log(f"[{tag}] " + (
        "the loop in series (no workers, no prefetch); host ms per batch "
        "(made on the training thread) " if serial else
        f"{out['n_workers']} loader worker processes; host ms per batch "
        "(the prefetch thread's wait on the loader) ")
        + f"{[round(t, 1) for t in pre.host_ms]}; the training thread's "
        f"wait per batch (ms) {[round(t, 1) for t in pre.wait_ms]}")
    for m in out["log"]:
        log(f"[{tag}]   {m}")
    return out


def loader_phase(module, config, tag, n=LOADER_BATCHES):
    """The training loader alone (driver.build_loader, host structure as
    configured), with the config's worker processes and in series: per
    batch after the first (the pool's start), the wall ms and the CPU ms
    of this process, all its threads: what stays with the consumer of
    the batches (re-chunking, collate, the host-structure presort,
    receiving and unpickling the workers' samples)."""
    out = {}
    for workers in (int(config().TRAIN.n_workers), 0):
        it = iter(driver.build_loader(
            config("TRAIN.n_workers", str(workers)), module.SPEC))
        next(it)
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(n):
            next(it)
        wall = (time.perf_counter() - t0) * 1e3 / n
        cpu = (time.process_time() - c0) * 1e3 / n
        it.close()
        out[f"workers_{workers}"] = {"wall_ms_per_batch": wall,
                                     "parent_cpu_ms_per_batch": cpu}
        log(f"[{tag}] the loader alone, {workers} worker processes: "
            f"{wall:.1f} ms per batch, of which this process's CPU "
            f"{cpu:.1f} ms ({n} batches after the first)")
    return out


def entry_phases(module, config, steps, per_step, tag, device_clouds_per_s):
    """entry_phase with the worker processes and with the loop in series,
    one after the other, then loader_phase; the two end-to-end rates side
    by side."""
    runs = {"workers": entry_phase(module, config, steps, per_step, tag,
                                   device_clouds_per_s),
            "serial": entry_phase(module, config, steps, per_step,
                                  f"{tag}-serial", device_clouds_per_s,
                                  serial=True),
            "loader": loader_phase(module, config, f"{tag}-loader")}
    w, s = runs["workers"]["clouds_per_s"], runs["serial"]["clouds_per_s"]
    log(f"[{tag}] end to end: worker processes {w:.2f} clouds/s, the loop "
        f"in series {s:.2f} ({w / s:.3f}x), device step "
        f"{device_clouds_per_s:.2f}")
    return runs



def lmdb_phase(module, config, synthetic, per_step, tag, keep=False):
    """GemBench LMDB data: the store `synthetic` written by LmdbWriterStore
    under build/smoke_data/<tag>, LMDB_BATCHES host batches of the release
    loader (TRAIN.n_workers worker processes) over LmdbStore held bit-equal
    to those over the synthetic store, then module.main on the LMDB
    directory for LMDB_STEPS steps (entry_phase's checks). The directory
    is removed after, unless `keep` (main removes build/smoke_data at its
    end)."""
    root = os.path.join(ROOT, "build", "smoke_data", tag)
    shutil.rmtree(root, ignore_errors=True)
    ok = False
    try:
        t0 = time.perf_counter()
        src, writer = open_store(synthetic), LmdbWriterStore(root)
        for tv in src.taskvars():
            for ep in src.episodes(tv):
                writer.put(tv, ep, src.get(tv, ep))
        writer.close()
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(root, tv, "data.mdb"))
                     for tv in os.listdir(root))
        cfg = config()
        tds, seed = dict(cfg.TRAIN_DATASET), int(cfg.SEED)
        B = int(cfg.TRAIN.train_batch_size)

        def first_batches(data_dir):
            ds = module.SPEC.build_dataset(dict(tds, data_dir=data_dir),
                                           np.random.RandomState(seed))
            it = iter(KeystepBatchLoader(
                ds, B, int(tds["num_points"]),
                collate_fn=module.SPEC.make_collate(tds, B), seed=seed,
                shuffle_seed=seed, num_workers=int(cfg.TRAIN.n_workers)))
            t0 = time.perf_counter()
            out = [next(it) for _ in range(LMDB_BATCHES)]
            ms = (time.perf_counter() - t0) * 1e3 / LMDB_BATCHES
            it.close()
            return type(ds.store).__name__, ds.data_ids, out, ms

        kind, ids, got, lmdb_ms = first_batches(root)
        _, want_ids, want, synth_ms = first_batches(synthetic)
        if kind != "LmdbStore" or ids != want_ids:
            raise AssertionError(f"{tag}: {kind}, data_ids differ")
        for i, (g, w) in enumerate(zip(got, want)):
            bad = [k for k in w if g[k].dtype != w[k].dtype
                   or not np.array_equal(g[k], w[k])]
            if sorted(g) != sorted(w) or bad:
                raise AssertionError(f"{tag}: batch {i} differs in {bad}")
        log(f"[{tag}] {len(ids)} episodes of {synthetic} written as "
            f"{len(os.listdir(root))} LMDB environments ({nbytes} bytes) in "
            f"{write_s:.2f} s; {LMDB_BATCHES} host batches bit-equal to the "
            f"synthetic store's; host ms per batch, LmdbStore {lmdb_ms:.1f}, "
            f"synthetic {synth_ms:.1f} ({cfg.TRAIN.n_workers} worker "
            "processes)")
        entry = entry_phase(module, lambda *o: config(
            "TRAIN_DATASET.data_dir", root, *o), LMDB_STEPS, per_step, tag)
        ok = True
    finally:
        if not (ok and keep):
            shutil.rmtree(root, ignore_errors=True)
    return {"episodes": len(ids), "bytes": nbytes, "write_s": write_s,
            "host_ms_per_batch_lmdb": lmdb_ms,
            "host_ms_per_batch_synthetic": synth_ms, "main": entry,
            "root": root}


# ----------------------------------------------- closed-loop evaluation ---

def _eval_cli(module, args, tag):
    """`python -m module args` (the eval server as a user starts it, in a
    process of its own, so that its spawned producers import no torch);
    its `eval server: {...}` summary and wall seconds. Raises on a
    non-zero exit."""
    cmd = [sys.executable, "-m", module] + [str(a) for a in args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] {module} exited with "
                             f"{proc.returncode}: {proc.stderr[-4000:]}")
    lines = [x for x in proc.stdout.splitlines()
             if x.startswith("eval server: ")]
    if not lines:
        raise AssertionError(f"[{tag}] no summary line: {proc.stdout[-2000:]}")
    return json.loads(lines[-1][len("eval server: "):]), wall


def _result_rows(path, taskvars, checkpoint, num_demos, tag):
    """The results.jsonl rows, one per taskvar in the JAX layout."""
    with open(path) as f:
        rows = [json.loads(x) for x in f]
    got = sorted(f"{r['task']}+{r['variation']}" for r in rows)
    if got != sorted(taskvars) or any(
            set(r) != {"checkpoint", "task", "variation", "num_demos", "sr"}
            or r["checkpoint"] != checkpoint or r["num_demos"] != num_demos
            or not 0.0 <= r["sr"] <= 1.0 for r in rows):
        raise AssertionError(f"[{tag}] results rows {rows}")
    return rows


def _off_count(launches, per_forward, forwards):
    """The kernels whose launches are not per_forward's times `forwards`
    (a kernel per_forward does not name: 0), with their counts."""
    return {k: launches.get(k, 0) for k in set(per_forward) | set(launches)
            if launches.get(k, 0) != per_forward.get(k, 0) * forwards}


def _log_eval(tag, stats, wall, rows):
    log(f"[{tag}] {stats['requests']} requests in {wall:.1f} s (the "
        f"process, its consumer's build and the producers' start "
        f"included): {stats['requests_per_s']:.2f} requests/s over the "
        f"{stats['serving_s']:.2f} s from the consumer's being ready to the "
        f"last answer; per request at the producers (the "
        f"{stats['requests'] - stats['requests_before_ready']} sent after "
        f"it was ready) p50 {stats['request_ms_p50']:.2f} ms, p99 "
        f"{stats['request_ms_p99']:.2f} ms; the consumer's batches by size "
        f"{dict(sorted(collections.Counter(stats['batch_sizes']).items()))} "
        f"(mean {stats['mean_batch']:.2f}), "
        f"{stats['errors']} failed; kernel launches "
        f"{ {k: v for k, v in stats['kernel_launches'].items() if v} }; "
        f"producers with torch imported: "
        f"{stats['producers_importing_torch']}")
    for r in rows:
        log(f"[{tag}]   {json.dumps(r)}")


def eval_server_phase(run, store_root, ckpt_step, tag="eval-server"):
    """The policy's closed-loop evaluation on the card: the port's
    eval_simple_policy_server on the run's model_step_<ckpt_step>.msgpack
    and logs/training_config.yaml, --env replay over the LMDB store of the
    lmdb phase, EVAL_TASKVARS taskvars (one for each of the 4 producers)
    x EVAL_DEMOS demos x up to 25 steps, the consumer's Actioner on the
    card. Checks the results rows (the JAX layout, one a taskvar), no
    producer with torch imported, and the consumer's kernel launches:
    PER_FORWARD's for every forward it ran (one a batch it formed)."""
    taskvars = sorted(os.listdir(store_root))[:EVAL_TASKVARS]
    tv_file = os.path.join(run, "eval_taskvars.json")
    with open(tv_file, "w") as f:
        json.dump(taskvars, f)
    result_file = os.path.join(run, "preds", "seed100", "results.jsonl")
    if os.path.exists(result_file):
        os.remove(result_file)
    stats, wall = _eval_cli(
        "robot3dlotus_tpu_torch.eval.eval_simple_policy_server",
        ["--expr_dir", run, "--ckpt_step", ckpt_step, "--taskvar_file",
         tv_file, "--env", "replay", "--replay_data_dir", store_root,
         "--num_workers", 4, "--num_demos", EVAL_DEMOS, "--seed", 100], tag)
    rows = _result_rows(result_file, taskvars, f"model_step_{ckpt_step}",
                        EVAL_DEMOS, tag)
    forwards = len(stats["batch_sizes"])
    bad = _off_count(stats["kernel_launches"], PER_FORWARD, forwards)
    if bad or stats["producers_importing_torch"] or stats["errors"] or \
            stats["requests"] != sum(stats["batch_sizes"]):
        raise AssertionError(f"[{tag}] {forwards} forwards, launches "
                             f"{bad}; {stats}")
    _log_eval(tag, stats, wall, rows)
    return dict(stats, wall_s=wall, rows=rows)


def mp_eval_server_phase(run, ckpt_step, tag="mp-eval-server"):
    """The GT pipeline's closed-loop evaluation on the card: the port's
    eval_robot_pipeline_server (stateful: the episode cache rides the
    queues, no batching) with robot_pipeline_gt.yaml and the run's
    model_step_<ckpt_step>.msgpack, --env replay over a motion store
    written here under two GemBench taskvars of the GT plan and label
    files (the synthetic motion episodes, whose `sem` ids the GT vision
    reads), 2 producers x EVAL_DEMOS demos. Checks the rows in
    preds-llm_gt-og_gt_coarse/seed100/results.jsonl, no producer with
    torch imported, and the consumer's kernel launches: MP_PER_FORWARD's
    for every motion-planner forward it ran (9 K1 a forward), none
    else."""
    root = os.path.join(ROOT, "build", "smoke_data", tag)
    shutil.rmtree(root, ignore_errors=True)
    src, writer = open_store("synthetic_motion"), LmdbWriterStore(root)
    for tv, sv in zip(MP_EVAL_TASKVARS, src.taskvars()):
        for ep in src.episodes(sv)[:EVAL_DEMOS]:
            writer.put(tv, ep, src.get(sv, ep))
    writer.close()
    tv_file = os.path.join(run, "eval_taskvars.json")
    with open(tv_file, "w") as f:
        json.dump(MP_EVAL_TASKVARS, f)
    result_file = os.path.join(run, "preds-llm_gt-og_gt_coarse", "seed100",
                               "results.jsonl")
    if os.path.exists(result_file):
        os.remove(result_file)
    stats, wall = _eval_cli(
        "robot3dlotus_tpu_torch.eval.eval_robot_pipeline_server",
        ["--pipeline_config_file", GT_CONFIG, "--mp_expr_dir", run,
         "--mp_ckpt_step", ckpt_step, "--taskvar_file", tv_file, "--env",
         "replay", "--replay_data_dir", root, "--num_workers", 2,
         "--num_demos", EVAL_DEMOS, "--seed", 100], tag)
    rows = _result_rows(result_file, MP_EVAL_TASKVARS, ckpt_step,
                        EVAL_DEMOS, tag)
    launches = stats["kernel_launches"]
    forwards = launches.get("patch_attention", 0) // 9
    bad = _off_count(launches, MP_PER_FORWARD, forwards)
    if not forwards or bad or stats["errors"] or \
            set(stats["batch_sizes"]) != {1} or \
            stats["producers_importing_torch"]:
        raise AssertionError(f"[{tag}] {forwards} forwards, launches "
                             f"{bad}; {stats}")
    _log_eval(tag, stats, wall, rows)
    log(f"[{tag}] motion-planner forwards: "
        f"{forwards} of {stats['requests']} "
        f"requests (the others replay cached steps or release)")
    return dict(stats, wall_s=wall, rows=rows)


def http_phase(run, store_root, ckpt_step, tag="http"):
    """The challenge HTTP server on the card, in this process:
    PolicyHTTPServer on port 0 with ThreeDLotusActioner(run, ckpt_step),
    and run_client over ReplayEnv (the lmdb phase's store, one taskvar,
    HTTP_EPISODES episodes) through PolicyHTTPClient. Times each round
    trip at the client, the msgpack packing and unpacking on both sides
    (serving._pack_np / _unpack_np, their share of the round trips) and
    counts the bytes; the actions finite, the kernel launches
    PER_FORWARD's for each request."""
    lotus = ThreeDLotusActioner(run, ckpt_step=ckpt_step, device="cuda")
    codec, trips, actions = [], [], []

    def timed(fn):
        def wrapped(x):
            t0 = time.perf_counter()
            out = fn(x)
            codec.append((fn.__name__, (time.perf_counter() - t0) * 1e3,
                          len(out) if isinstance(out, bytes) else len(x)))
            return out
        return wrapped

    class Client(PolicyHTTPClient):
        def predict(self, **payload):
            t0 = time.perf_counter()
            out = super().predict(**payload)
            trips.append((time.perf_counter() - t0) * 1e3)
            actions.append(np.asarray(out["action"]))
            return out

    taskvar = sorted(os.listdir(store_root))[0]
    srv = PolicyHTTPServer(lotus, port=0)
    srv.start_background()
    try:
        with _Patch(serving, "_pack_np", timed), \
                _Patch(serving, "_unpack_np", timed):
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            rec = run_client(taskvar, Client(f"http://{srv.host}:{srv.port}"),
                             ReplayEnv(open_store(store_root)),
                             num_episodes=HTTP_EPISODES)
            launches = dict(cuda_lib.LAUNCHES)
    finally:
        srv.shutdown()
    n = len(trips)
    bad = _off_count(launches, PER_FORWARD, n)
    if not n or bad or not all(a.shape == (8,) and np.isfinite(a).all()
                               for a in actions):
        raise AssertionError(f"[{tag}] {n} requests, launches {bad}")
    by = {}
    for name, ms, nbytes in codec:
        by.setdefault(name, []).append((ms, nbytes))
    # per request: the client packs the request and unpacks the reply, the
    # server unpacks the request and packs the reply
    req_bytes = [b for _, b in by["_pack_np"][0::2]]
    codec_ms = sum(ms for _, ms, _ in codec)
    out = {"requests": n, "record": rec, "round_trip_ms": trips,
           "round_trip_p50_ms": float(np.median(trips)),
           "round_trip_p99_ms": float(np.percentile(trips, 99)),
           "round_trip_s": sum(trips) / 1e3,
           "request_bytes": float(np.mean(req_bytes)),
           "reply_bytes": float(np.mean([b for _, b in
                                         by["_pack_np"][1::2]])),
           "codec_ms_per_request": codec_ms / n,
           "codec_share": codec_ms / sum(trips), "launches": launches}
    log(f"[{tag}] {n} requests over HTTP ({rec}): round trip p50 "
        f"{out['round_trip_p50_ms']:.2f} ms, p99 "
        f"{out['round_trip_p99_ms']:.2f} ms, min {min(trips):.2f}, max "
        f"{max(trips):.2f} (the first {trips[0]:.2f}), over "
        f"{out['round_trip_s']:.2f} s of round trips; "
        f"{out['request_bytes']:.0f} bytes "
        f"a request, {out['reply_bytes']:.0f} a reply; msgpack packing and "
        f"unpacking {out['codec_ms_per_request']:.2f} ms a request, "
        f"{out['codec_share']:.3f} of the round trips")
    return out


# --------------------------------------------------------- checkpoints ---

class _Patch:
    """Replaces `attr` of `obj` with make(original) inside a with block."""

    def __init__(self, obj, attr, make):
        self.obj, self.attr, self.make = obj, attr, make

    def __enter__(self):
        self.orig = getattr(self.obj, self.attr)
        setattr(self.obj, self.attr, self.make(self.orig))

    def __exit__(self, *exc):
        setattr(self.obj, self.attr, self.orig)


def _snapshot(trainer):
    """Clones of what a resume restores: state_dict, mu, nu, count, step."""
    opt = trainer.optimizer
    return {"state": {k: v.detach().clone() for k, v in
                      trainer.model.state_dict().items()},
            "mu": opt.mu.clone(), "nu": opt.nu.clone(), "count": opt.count,
            "step": trainer.global_step}


def _bit_equal_state(got, want, what):
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys differ")
    bad = [k for k in want if got[k].dtype != want[k].dtype
           or not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} tensors differ, e.g. "
                             f"{bad[:3]}")


def ckpt_run(module, config, steps, resume_steps, run, tag, per_forward):
    """module.main twice under `run` (chiprun_out/<phase>): `steps` steps
    with saves and validations every 2, then a second main to
    `resume_steps` that must resume at `steps` with the state the first
    ended with, bit for bit. Times every save and the resume's load,
    counts the kernel launches of every validation forward (counters to 0
    before each, read after: the validation path) against per_forward,
    and captures the first validation forward's K1 calls."""
    shutil.rmtree(run, ignore_errors=True)
    saves, resumes, vals, k1 = [], [], [], []

    def timed_save(save):
        def wrapped(saver, model, step, optimizer=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save(saver, model, step, optimizer)
            ms = (time.perf_counter() - t0) * 1e3
            files = {os.path.basename(path): os.path.getsize(path)}
            if optimizer is not None:
                latest = os.path.join(saver.ckpt_dir, ckpt_mod.LATEST)
                files[ckpt_mod.LATEST] = os.path.getsize(latest)
            saves.append({"step": step, "ms": ms, "bytes": files})
            return path
        return wrapped

    def timed_resume(resume):
        def wrapped(trainer, output_dir):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step = resume(trainer, output_dir)
            torch.cuda.synchronize()
            resumes.append({"step": step, "ms": (time.perf_counter() - t0)
                            * 1e3, "state": _snapshot(trainer)})
            return step
        return wrapped

    def counted_val(make):
        def wrapped(model, loss_fn, decode_fn):
            fn = make(model, loss_fn, decode_fn)

            def val(batch):
                torch.cuda.synchronize()
                cuda_lib.reset_launches()
                t0 = time.perf_counter()
                out = fn(batch)
                torch.cuda.synchronize()
                vals.append({"ms": (time.perf_counter() - t0) * 1e3,
                             "launches": dict(cuda_lib.LAUNCHES),
                             "clouds": int(batch["batch_valid"].sum())})
                if not k1:
                    k1.extend(capture_main_path(lambda: fn(batch))
                              ["patch_attention"])
                return out
            return val
        return wrapped

    logger = logging.getLogger("robot3dlotus_tpu_torch.train")
    handler, level = _Records(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    opts = ("output_dir", run, "TRAIN.log_steps", "1", "TRAIN.save_steps",
            "2", "TRAIN.val_steps", "2")
    try:
        with _Patch(ckpt_mod.ModelSaver, "save", timed_save), \
                _Patch(driver, "resume_or_init", timed_resume), \
                _Patch(driver, "make_val_step", counted_val):
            t0 = time.perf_counter()
            first = module.main(config(*opts, "TRAIN.num_train_steps",
                                       str(steps)))
            first_s = time.perf_counter() - t0
            ended = _snapshot(first)
            del first
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            second = module.main(config(*opts, "TRAIN.num_train_steps",
                                        str(resume_steps)))
            second_s = time.perf_counter() - t0
            if second.global_step != resume_steps:
                raise AssertionError(f"resumed run ended at "
                                     f"{second.global_step}")
            del second
            torch.cuda.empty_cache()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    messages = [r.getMessage() for r in handler.records]
    if f"resumed at step {steps}" not in messages:
        raise AssertionError(f"[{tag}] no resume at step {steps}")
    restored = [r for r in resumes if r["step"]]
    if len(restored) != 1 or restored[0]["step"] != steps:
        raise AssertionError(f"[{tag}] resumes {[r['step'] for r in resumes]}")
    got = restored[0]["state"]
    _bit_equal_state(got["state"], ended["state"], f"[{tag}] resumed model")
    for k in ("mu", "nu"):
        if not torch.equal(got[k], ended[k]):
            raise AssertionError(f"[{tag}] resumed {k} differs")
    if (got["count"], got["step"]) != (ended["count"], ended["step"]) or \
            ended["step"] != steps:
        raise AssertionError(f"[{tag}] count / step {got['count']}, "
                             f"{got['step']} vs {ended['count']}, "
                             f"{ended['step']}")
    for i, v in enumerate(vals):
        for k in KERNELS:
            if v["launches"][k] != per_forward.get(k, 0):
                raise AssertionError(f"[{tag}] validation forward {i}: {k} "
                                     f"launched {v['launches'][k]} times, "
                                     f"expected {per_forward.get(k, 0)}")
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        val_metrics = [json.loads(line) for line in f if '"val_' in line]
    for m in val_metrics:
        if not all(math.isfinite(x) for x in m.values()):
            raise AssertionError(f"[{tag}] validation metrics {m}")
    return {"first_main_s": first_s, "second_main_s": second_s,
            "saves": saves, "resume_load_ms": restored[0]["ms"],
            "val_ms": [v["ms"] for v in vals],
            "val_clouds": [v["clouds"] for v in vals],
            "val_launches_per_forward": vals[0]["launches"],
            "validation_launches": {k: sum(v["launches"][k] for v in vals)
                                    for k in KERNELS},
            "val_metrics": val_metrics, "ended": ended}, k1


def log_ckpt(tag, out):
    for s in out["saves"]:
        log(f"[{tag}] save at step {s['step']}: {s['ms']:.1f} ms, bytes "
            f"{s['bytes']}")
    log(f"[{tag}] main to step {out['steps'][0]}: {out['first_main_s']:.1f} "
        f"s; resumed main to step {out['steps'][1]}: "
        f"{out['second_main_s']:.1f} s; resume load (model and train state "
        f"onto the card) {out['resume_load_ms']:.1f} ms; the resumed "
        f"parameters, buffers, mu, nu, count and step bit-equal to the "
        f"saved run's")
    log(f"[{tag}] validation: {len(out['val_ms'])} forwards of clouds "
        f"{out['val_clouds']}, ms per batch p50 "
        f"{np.median(out['val_ms']):.2f} (all "
        f"{[round(t, 2) for t in out['val_ms']]}); kernel launches per "
        f"validation forward {out['val_launches_per_forward']}")
    for m in out["val_metrics"]:
        log(f"[{tag}]   step {m['step']}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in m.items()
            if k.startswith("val_")))


def _same_launches(got, seeded, what):
    """The host's launch calls per forward of a model served from a file
    equal to the seeded model's (both profiled in this run); the
    profiler's device-side counts logged beside them."""
    h, d = "host_launches_per_forward", "device_launches_per_forward"
    log(f"{what} from the file: launch calls per forward {got[h]} (seeded "
        f"{seeded[h]}); device launches recorded per forward {got[d]} "
        f"(seeded {seeded[d]})")
    if got[h] != seeded[h]:
        raise AssertionError(f"{what}: {got[h]} launch calls per forward, "
                             f"the seeded model's {seeded[h]}")


def ckpt_phase(tag, module, config, steps, per_forward, load, serve,
               seeded, out_dir, after=None):
    """A family's checkpoint path under out_dir/<tag>: ckpt_run with
    `steps` (first main, resumed main), K1 of the first validation forward
    (B = 32) against its plain version, then a server from the first
    main's last model file (`load(path, device)`): its state bit-equal to
    the saved run's; `serve(server, cpu_model)` -> (results, profiled
    forward) serves with the serving launch counts and holds the logits
    against a server loaded on the CPU from the same file; the profiled
    forward's launch calls must equal the seeded server's (`seeded`).
    after(run directory) -> dict: more phases on the run's files, before
    they are deleted."""
    run = os.path.join(out_dir, tag.replace("-", "_"))
    try:
        out, k1 = ckpt_run(module, config, *steps, run, tag, per_forward)
        out["steps"] = list(steps)
        log_ckpt(tag, out)
        if len(k1) != per_forward["patch_attention"]:
            raise AssertionError(f"[{tag}] captured {len(k1)} K1 calls")
        calls = [check_call("patch_attention", args, timing=TRAIN_TIMING)
                 for args in k1]
        for i, r in enumerate(calls):
            log_call(tag, f"K1 validation call {i}", r)
        out["k1_b32"] = dict(_row(calls), device_ms=_total(
            r["device_ms"] for r in calls), fp32_bound_ms=sum(
            r["fp32_bound_ms"] for r in calls), calls=calls)
        log_call(tag, "K1 per validation forward (B = 32)", out["k1_b32"])
        del k1
        name = f"model_step_{steps[0]}.msgpack"
        path = os.path.join(run, "ckpts", name)
        t0 = time.perf_counter()
        server = load(path, "cuda")
        out["server_build_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_any_model_ckpt(path, server.model, server.config.MODEL)
        torch.cuda.synchronize()
        out["serve_load_ms"] = (time.perf_counter() - t0) * 1e3
        what = f"[{tag}] {type(server).__name__}"
        _bit_equal_state(server.model.state_dict(), out["ended"]["state"],
                         f"{what}(checkpoint=...)")
        log(f"{what}(checkpoint={name}) built in "
            f"{out['server_build_s']:.2f} s, its state bit-equal to the "
            f"saved run's; load_any_model_ckpt onto the card "
            f"{out['serve_load_ms']:.1f} ms")
        del out["ended"]
        served, profiled = serve(server, load(path, "cpu").model)
        out.update(served)
        _same_launches(profiled, seeded, what)
        del server
        torch.cuda.empty_cache()
        if after is not None:
            out.update(after(run))
        return out
    finally:
        shutil.rmtree(os.path.join(run, "ckpts"), ignore_errors=True)


# ------------------------------------------------------- motion planner ---

def mp_config(*opts):
    return get_config(MP_CONFIG, MP_TRAIN_OPTS + list(opts))


def mp_config_val(*opts):
    """mp_config with a VAL_DATASET (the release YAML has none): the
    training store's keys, no augmentation."""
    val = [x for k, v in mp_config().TRAIN_DATASET.items()
           for x in (f"VAL_DATASET.{k}", str(v))]
    return mp_config(*val, "VAL_DATASET.use_val", "True",
                     "VAL_DATASET.augment_pc", "False", *opts)


def mp_pipeline(engine):
    """The GT pipeline of robot_pipeline_gt.yaml around `engine`."""
    with open(GT_CONFIG) as f:
        return GroundtruthRobotPipeline(yaml.safe_load(f),
                                        motion_planner=engine)


def mp_episode(pipe, observations, seed):
    """One episode of the GT taskvar over `observations` (the vision's
    sampling seeded); returns the actions and each request's seconds."""
    pipe.vision.rng = np.random.RandomState(seed)
    task, var = TASKVAR.split("+")
    cache, actions, lat = None, [], []
    for i, o in enumerate(observations):
        t0 = time.perf_counter()
        out = pipe.predict(task_str=task, variation=int(var), step_id=i,
                           obs_state_dict=o, episode_id=0, cache=cache)
        lat.append(time.perf_counter() - t0)
        cache = out["cache"]
        actions.append(out["action"])
    return actions, lat


def mp_inputs(pipe, obs):
    """The motion planner's host inputs for one observation: GT vision
    (labels, normalised cloud) and the plan's action-name embedding."""
    plan = parse_code(pipe.llm_planner(TASKVAR)[0])
    inp = pipe.vision(TASKVAR, 0, obs["pc"], obs["gt_mask"], obs["gripper"],
                      obs["arm_links_info"])
    return inp, pipe.text_embedder(_plan_action_name(plan))


def mp_serving_phase(pipe, observations, out_dir,
                     profile_name="profile_mp_forward.txt", tag="mp-serving",
                     per_forward=MP_PER_FORWARD):
    """4 counted pipeline requests (launches held at per_forward), then
    host prep vs device forward per request and a profiler window over 3
    forwards."""
    mp_episode(pipe, observations[:1], 7)                 # warm-up
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    actions, lat = mp_episode(pipe, observations, 1)
    launches = dict(cuda_lib.LAUNCHES)
    for k, per in per_forward.items():
        if launches[k] != per * len(observations):
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{len(observations)} pipeline requests, "
                                 f"expected {per} per forward")
    for i, a in enumerate(actions):
        if a.shape != (8,) or not np.isfinite(a).all():
            raise AssertionError(f"pipeline request {i}: bad action {a}")
    engine = pipe.motion_planner
    pipe.vision.rng = np.random.RandomState(1)
    prep_ms, fwd_ms, rows = [], [], []
    for o in observations:
        t0 = time.perf_counter()
        inp, txt = mp_inputs(pipe, o)
        t1 = time.perf_counter()
        traj = engine.predict(inp["pc_fts"], inp["pc_labels"], txt,
                              inp["ee_poses"], inp["pc_centroids"],
                              inp["pc_radius"], pipe.vision.TABLE_HEIGHT)
        t2 = time.perf_counter()
        if traj.shape != (5, 9) or not np.isfinite(traj).all():
            raise AssertionError(f"bad trajectory {traj}")
        prep_ms.append((t1 - t0) * 1e3)
        fwd_ms.append((t2 - t1) * 1e3)
        rows.append((inp, txt))
    from torch.profiler import ProfilerActivity, profile
    batches = [engine._batch(i["pc_fts"], i["pc_labels"], t)
               for i, t in rows[:3]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            engine.forward(b)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    with open(os.path.join(out_dir, profile_name), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    ops = _device_ops(events, len(batches))
    busy = sum(o[1] for o in ops)
    fwd_p50 = float(np.median(fwd_ms))
    out = {"request_ms": [t * 1e3 for t in lat],
           "request_p50_ms": float(np.median(lat)) * 1e3,
           "host_prep_ms": prep_ms, "host_prep_ms_p50":
           float(np.median(prep_ms)), "predict_ms": fwd_ms,
           "predict_ms_p50": fwd_p50,
           "points": [len(i["pc_fts"]) for i, _ in rows],
           "labels": [np.bincount(i["pc_labels"], minlength=4).tolist()
                      for i, _ in rows],
           "profiled_forward_wall_ms": wall_ms / len(batches),
           "device_busy_ms_per_forward": busy,
           "device_launches_per_forward": _device_launches(events,
                                                           len(batches)),
           "host_launches_per_forward": _host_launches(events, len(batches)),
           "copy_launches_per_forward": _copy_launches(events,
                                                       len(batches)),
           "device_idle_share": 1.0 - busy / fwd_p50,
           "device_ms_by_group": _group_device_ops(ops),
           "launches": launches, "actions": [a.tolist() for a in actions]}
    log(f"[{tag}] {len(observations)} GT pipeline requests: p50 "
        f"{out['request_p50_ms']:.2f} ms (all "
        f"{[round(t, 2) for t in out['request_ms']]}); points "
        f"{out['points']}, labels per class {out['labels']}; launches "
        f"{launches}")
    log(f"[{tag}] MotionPlannerEngine.predict p50 {fwd_p50:.2f} ms "
        f"(all {[round(t, 2) for t in fwd_ms]}); host prep (GT vision, "
        f"labels, text) p50 {out['host_prep_ms_p50']:.2f} ms; device busy "
        f"{busy:.2f} ms per forward in "
        f"{out['device_launches_per_forward']:.2f} device launches (profiled "
        f"wall {out['profiled_forward_wall_ms']:.2f} ms), idle share "
        f"{out['device_idle_share']:.3f}")
    for g, v in out["device_ms_by_group"].items():
        log(f"[{tag}]   {v['ms']:.4f} ms x{v['count']}  {g}")
    return out, rows[0]


def mp_reference_phase(engine, row, cpu_model=None, tag="mp-serving"):
    """The card's trajectory logits for one observation against the same
    weights on the CPU (those of `cpu_model`, else the card's copied
    there); the decoded trajectory finite."""
    inp, txt = row
    batch = engine._batch(inp["pc_fts"], inp["pc_labels"], txt)
    if cpu_model is None:
        cpu_model = build_model(engine.config.MODEL, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   engine.model.state_dict().items()})
    with torch.inference_mode():
        gpu = engine.model(batch)
        cpu = cpu_model({k: v.cpu() for k, v in batch.items()})
        traj = decode_mp_actions(gpu, engine.act_cfg).cpu()
    errs = logits_close(gpu, cpu, ("pos", "rot", "open", "stop"),
                        "motion planner ")
    if traj.shape != (1, 5, 9) or not bool(torch.isfinite(traj).all()):
        raise AssertionError(f"decoded trajectory {traj}")
    errs["pool_overflow"] = int(gpu["pool_overflow"])
    log(f"[{tag}] card vs CPU trajectory logits, max |diff|: {errs}")
    return errs


def check_smallc_bwd(g, idx, n, timing):
    """K10 on one call, g (B, M, C) onto (B, n, C) through idx: fp32 within
    1e-4 * max|plain|, a bf16 g (fp32 sums, one rounding) within the bar
    of ops/bf16.py at the gradient's scale (shared-memory atomics: another
    summation order; a bf16 g up to C = 8 must run
    scatter_smallc16_kernel); event and profiler device times (both
    of its kernels) against the plain version, its bound (g, the index
    and dx moved once) and the faster of index_add_ and scatter_add_
    (sentinel rows sent to a spare row per cloud; in g's dtype)."""
    B, M, C = g.shape
    run = lambda: gather.scatter_rows_smallc_add(g, idx, n)  # noqa: E731
    plain = lambda: gather.scatter_rows_smallc_add_plain(  # noqa: E731
        g, idx, n).to(g.dtype)
    what = f"K10 {g.dtype} {[B, M, C]} -> {n}"
    err = _bf16_err(run(), plain(), what) if g.dtype == torch.bfloat16 \
        else _err(run(), plain(), what)
    bound_ms, t_b, t_f = _bound(g.element_size() * (g.numel() + B * n * C) +
                                idx.numel() * idx.element_size(), g.numel())
    library = {"index_add_": cuda_ms(_index_add(g, idx, n), **timing),
               "scatter_add_": cuda_ms(_scatter_add(g, idx, n), **timing)}
    bf16 = g.dtype == torch.bfloat16
    if bf16 and C <= gather.SMALLC16_MAX:
        _required_kernels(run, "scatter_smallc16_kernel", what)
    return {"shape": [B, M, C, n], "dtype": str(g.dtype),
            "max_abs_err": err,
            "plan": list(gather.scatter_smallc_plan(B, M, n, C, bf16)),
            "sentinel_rows": int(((idx < 0) | (idx >= n)).sum()),
            "ms": cuda_ms(run, **timing),
            "device_ms": device_ms(run, K10_PROFILE[0], also=K10_PROFILE[1]),
            "plain_ms": cuda_ms(plain, **timing),
            "library_ms": min(library.values()), "library": library,
            "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f}


def log_k10(tag, label, r):
    """One line per K10 call: shape, plan, times, bound share, library."""
    dev = r["device_ms"]
    share = "not measured" if dev is None else f"{r['bound_ms'] / dev:.3f}"
    log(f"[{tag}] K10 {label}: {r['dtype']} [B, M, C, n] {r['shape']}, "
        f"plan (ranges, "
        f"window) {r['plan']}, {r['sentinel_rows']} sentinel rows, "
        f"max_abs_err {r['max_abs_err']:.3g}; {r['ms']:.4f} ms by events, "
        f"device {dev} (bound {r['bound_ms']:.4f}, bound / device {share}; "
        f"plain {r['plain_ms']:.4f}; library {r['library']})")


def _seeded(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=gen, device="cuda")


def _row(results):
    lib = [r["library_ms"] for r in results]
    return {"max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": sum(r["ms"] for r in results),
            "plain_ms": sum(r["plain_ms"] for r in results),
            "bound_ms": sum(r["bound_ms"] for r in results),
            "bound_by": "bytes" if sum(r["bytes_s"] for r in results) >=
            sum(r["flops_s"] for r in results) else "operations",
            "library_ms": None if None in lib else sum(lib)}


def mp_kernel_phase(captured_fwd, captured_step):
    """K9 on every captured call of one forward (B = 1) and of one training
    step (B = 32), K10 on both stem indices with seeded cotangents at
    C = 5 and C = 20. Rows: K9 per forward (its per-step sums under
    "train_step"), K10 at the training step's stem shape, C = 5 (it
    launches 0 times per step: the stem gathers data)."""
    rows, detail = {}, {}
    # K9's calls: the stage-0 entry sort (C = 4; none in a host-structured
    # training step) and the categorical stem (C = 5)
    for name, cap, timing, widths in (
            ("forward", captured_fwd, {}, [4, 5]),
            ("step", captured_step, TRAIN_TIMING, [5])):
        calls = [args for args, _ in cap["gather_rows_smallc"]]
        if sorted(a[0].shape[-1] for a in calls) != widths:
            raise AssertionError(f"K9 calls per {name}: "
                                 f"{[list(a[0].shape) for a in calls]}")
        k9 = [check_gather("gather_rows_smallc", a, timing) for a in calls]
        stem_x, stem_idx = next(a for a in calls if a[0].shape[-1] == 5)
        k10 = [check_smallc_bwd(_seeded(stem_idx.shape + (C,), 11 + C),
                                stem_idx, stem_x.shape[1], timing)
               for C in (5, 20)]
        detail[name] = {"gather_rows_smallc": k9,
                        "scatter_rows_smallc_add": k10}
        log_gathers("mp-kernels", f"K9 per {name}", k9)
        for r in k10:
            log_k10("mp-kernels", f"per {name}", r)
        k9_row = dict(_row(k9), device_ms=_total(r["device_ms"] for r in k9))
        if name == "forward":
            rows["gather_rows_smallc"] = k9_row
        else:
            rows["gather_rows_smallc"]["train_step"] = k9_row
            rows["scatter_rows_smallc_add"] = dict(
                _row(k10[:1]), device_ms=k10[0]["device_ms"])
    return rows, detail


def mp_stem_vjp_phase(call):
    """The motion planner's categorical stem on its captured training call
    (B = 32 x 4096: features, map, weight, label table, output cotangent)
    with the features, weight and table requiring gradients: launch
    counts (one K9, one K10 at C = 5) and peak memory; the three gradients
    against the CPU run of the same call within 1e-4 * max|ref|. Returns
    the phase and its launches."""
    (feat, nmap, w, (cat_idx, table)), gout = call
    fg, wg, tg = (t.detach().clone().requires_grad_()
                  for t in (feat, w, table))
    launches, peak, own = _phase_launches(
        lambda: sparse_conv.categorical_conv(fg, nmap, wg, (cat_idx, tg))
        .backward(gout),
        {"gather_rows_smallc": 1, "scatter_rows_smallc_add": 1},
        "categorical stem gradient")
    t0 = time.perf_counter()
    fc, wc, tc = (t.detach().cpu().requires_grad_()
                  for t in (feat, w, table))
    sparse_conv.categorical_conv(
        fc, sparse_conv.NeighborMap(nmap.idx.cpu(), nmap.ok.cpu()), wc,
        (cat_idx.cpu(), tc)).backward(gout.cpu())
    cpu_s = time.perf_counter() - t0
    errs = {name: _err(a.grad.cpu(), b.grad, f"categorical stem {name}, "
                       "card vs CPU")
            for name, a, b in (("dfeat", fg, fc), ("dW", wg, wc),
                               ("dtable", tg, tc))}
    out = {"shape": list(feat.shape) + list(w.shape), "launches": launches,
           "peak_memory_gib": peak, "peak_above_start_gib": own,
           "errs": errs, "dfeat_ref_max": float(fc.grad.abs().max()),
           "cpu_reference_s": cpu_s}
    log(f"[mp-stem-vjp] categorical stem forward + backward with the "
        f"features requiring a gradient, {out['shape']}: launches "
        f"{launches}; peak memory {peak:.3f} GiB ({own:.3f} above the "
        f"phase's start); card vs CPU max err {errs} (CPU reference "
        f"{cpu_s:.1f} s)")
    return out, launches


# the categorical stem's label-table gradient at bf16, card vs the CPU
# port: a bf16 product over 16.4M gathered rows whose sum both libraries
# take in their own order and blocking (measured 2.4e-4, about 2^-9 of its
# scale, on an H100): 2^-6 of max|ref|
BF16_TABLE_GRAD_TOL = 2.0 ** -6


def bf16_mp_stem_vjp_phase(call):
    """mp_stem_vjp_phase at bf16: the captured categorical stem call with
    the features, weight, label table and cotangent rounded to bf16, all
    three requiring gradients: launches (one K9 and one K10 bf16) and
    peak memory; dfeat and dW against the CPU port at bf16 within the bar
    of ops/bf16.py at each gradient's scale (dfeat plus one bf16 ulp of
    the largest gathered-row cotangent it adds, _g_ulp), the label table's
    gradient within BF16_TABLE_GRAD_TOL of its scale; K10 bf16
    on a seeded bf16 cotangent at the stem's index (C = 5) against its
    plain version, timed. Returns the phase and its launches."""
    (feat, nmap, w, (cat_idx, table)), gout = call
    feat, w, table, gout = (t.detach().to(torch.bfloat16)
                            for t in (feat, w, table, gout))
    B, N, C = feat.shape
    fg, wg, tg = (t.clone().requires_grad_() for t in (feat, w, table))
    launches, peak, own = _phase_launches(
        lambda: sparse_conv.subm_conv_apply(
            fg, nmap, wg, categorical=(cat_idx, tg)).backward(gout),
        {"gather_rows_smallc_bf16": 1, "scatter_rows_smallc_add_bf16": 1},
        "bf16 categorical stem gradient")
    # the gathered rows' cotangent K10 added (the product's VJP, rounded
    # to bf16): its largest element per destination bounds a tie's move
    K, cout = nmap.idx.shape[-1], w.shape[-1]
    rows_ct = (gout.reshape(B * N, cout).float() @
               w.reshape(-1, cout).float().t()).to(torch.bfloat16)
    rows_ct = rows_ct.reshape(B, N * K, -1)
    flat = torch.where(nmap.ok, nmap.idx, N).reshape(B, N * K)
    extra = _g_ulp(rows_ct[..., :C], flat, N)
    del rows_ct
    t0 = time.perf_counter()
    fc, wc, tc = (t.cpu().requires_grad_() for t in (feat, w, table))
    sparse_conv.subm_conv_apply(
        fc, sparse_conv.NeighborMap(nmap.idx.cpu(), nmap.ok.cpu()), wc,
        categorical=(cat_idx.cpu(), tc)).backward(gout.cpu())
    cpu_s = time.perf_counter() - t0
    errs = {name: _bf16_err(a.grad, b.grad.cuda(), f"bf16 categorical stem "
                            f"{name}, card vs CPU", extra=e)
            for name, a, b, e in (("dfeat", fg, fc, extra),
                                  ("dW", wg, wc, None))}
    # the table's gradient is a bf16 product over all B N K gathered rows
    # (cuBLAS on the card, another accumulation on the CPU), not a kernel
    # of the port's: held within BF16_TABLE_GRAD_TOL of its own scale
    errs["dtable"] = _err(tg.grad.float(), tc.grad.cuda().float(),
                          "bf16 categorical stem dtable, card vs CPU",
                          BF16_TABLE_GRAD_TOL)
    k10 = check_smallc_bwd(
        _seeded((B, N * K, C + 1), 16).to(torch.bfloat16), flat, N,
        TRAIN_TIMING)
    out = {"shape": [B, N, C] + list(w.shape), "launches": launches,
           "peak_memory_gib": peak, "peak_above_start_gib": own,
           "errs": errs, "dfeat_ref_max": float(fc.grad.float().abs().max()),
           "cpu_reference_s": cpu_s, "k10": k10}
    log(f"[bf16-mp-stem-vjp] categorical stem at bf16, forward + backward "
        f"with the features requiring a gradient, {out['shape']}: "
        f"launches {launches}; peak memory {peak:.3f} GiB ({own:.3f} above "
        f"the phase's start); card vs the CPU port at bf16 max err {errs} "
        f"(CPU reference {cpu_s:.1f} s)")
    log_k10("bf16-mp-stem-vjp", "seeded, at the stem's index", k10)
    return out, launches


def mp_forward_k2(calls):
    """K2 on the captured calls of one pipeline request (B = 1), each
    checked as check_conv does; run right after the capture, so that the
    copies are freed before the training phases measure peak memory."""
    if len(calls) != MP_PER_FORWARD["subm_conv"]:
        raise AssertionError(f"captured {len(calls)} K2 calls in a pipeline "
                             "request")
    res = [check_conv(args, timed=False) for args, _ in calls]
    for r in res:
        log_conv("mp-kernels", "K2 per pipeline request, call", r)
    return res


def mp_conv_phase(captured):
    """K2 (9 forward + 9 mirrored dx launches) and K7 (the 9 CPE convs) on
    the calls of one captured motion-planner training step at B = 32,
    checked and timed as the policy's (check_conv_dx, check_weight_grad);
    returns the K2 and K7 rows per step and the detail."""
    convs = [c for c in captured["subm_conv"] if c[1] is not None]
    if len(convs) != 9:
        raise AssertionError(f"captured {len(convs)} motion-planner conv "
                             "calls with a cotangent, expected 9")
    k2, k7, dx, k2_runs = [], [], [], []
    for c in convs:
        row, _, calls, runs = check_conv_dx(c)
        dx.append(row)
        k2 += calls
        k2_runs += runs
        k7.append(check_weight_grad(c))
    k2_row = conv_step_row("mp-kernels", "K2 per MP training step", k2,
                           k2_runs)
    del k2_runs
    for r in k7:
        log_conv("mp-kernels", "K7 per MP training step, call", r)
    k7_row = dict(_row(k7), shares=_shares(k7), launches_per_step=len(k7))
    for key in ("fp32_bound_ms", "device_ms", "im2col_matmul_ms"):
        k7_row[key] = _total(r[key] for r in k7)
    log(f"[mp-kernels] K7 per MP training step: {k7_row['ms']:.4f} ms "
        f"(device {k7_row['device_ms']}; plain {k7_row['plain_ms']:.4f}; "
        f"bound {k7_row['bound_ms']:.4f} TF32, {k7_row['fp32_bound_ms']:.4f} "
        f"fp32 SIMT; im2col gather + matmul "
        f"{k7_row['im2col_matmul_ms']:.4f}); conv dx vs the exact adjoint: "
        f"max err "
        f"{max(m['max_abs_err'] for m in dx):.3g}")
    return k2_row, k7_row, {"subm_conv": k2, "conv_weight_grad": k7,
                            "conv_dx": dx}


def mp_training(out_dir):
    """The motion planner's trainer on synthetic_motion (B = 32 x 4096,
    release dropout): one captured step (K9 inputs and the categorical
    stem's call at B = 32), 5 counted
    steps and a profiler window, then one more captured step (the convs'
    inputs and cotangents: captured after the counted steps, so that
    their copies stay out of the peak memory); returns the phase, its
    launches, the captures and the host batches (the step check takes the
    first; the bf16 training phase all of them)."""
    t0 = time.perf_counter()
    trainer, batches, _ = build_trainer(mp_config(), train_motion_planner.SPEC,
                                        device="cuda")
    host, data_ms = host_batches(batches, 1 + TRAIN_STEPS + PROFILE_STEPS)
    log(f"[mp-train] trainer built and {len(host)} host batches of "
        f"{trainer_batch(host)} clouds made in "
        f"{time.perf_counter() - t0:.1f} s (host ms per batch: "
        f"{[round(t) for t in data_ms]})")
    captured = capture(lambda: trainer.step(batch_to_device(host[0], "cuda")),
                       SMALLC_SITES + MP_STEM_SITES)
    training, launches = training_phase(trainer, host[1:], out_dir,
                                        MP_PER_STEP, "profile_mp_train.txt",
                                        "mp-train")
    training["host_batch_ms"] = data_ms
    captured.update(capture(
        lambda: trainer.step(batch_to_device(host[0], "cuda")),
        MP_CONV_SITES))
    del trainer
    return training, launches, captured, host


# ---------------------------------------------------- bf16 training -----

# launches per training step at compute_dtype bfloat16 (TRAIN.host_structure):
# the bf16 paths take PER_STEP's counts (K2's input gradient counted apart
# as subm_conv_dx_bf16; K8's 13 are the 4 unpools' backwards and the 9
# owner sums) and no fp32 path launches
BF16_PER_STEP = {**dict.fromkeys(PER_STEP, 0), "subm_conv_bf16": 9,
                 "subm_conv_dx_bf16": 9, "stem_conv_bf16": 1,
                 "gather_rows_bf16": 4, "gather_rows_smallc_bf16": 0,
                 "patch_attention_dropout_bf16": 9,
                 "patch_attention_dropout_bwd_bf16": 9,
                 "conv_weight_grad_bf16": 10, "scatter_rows_add_bf16": 13,
                 "patch_attention_bf16": 0}
# without host structure: the stage-0 entry sort of the fp32 input is K9
# (fp32: no gradient), the 4 pooled stages' entry sorts bf16 K4 and K8
BF16_PER_STEP_REDRAW = dict(BF16_PER_STEP, gather_rows_bf16=8,
                            gather_rows_smallc=1, scatter_rows_add_bf16=17)
BF16_ORDER_KERNELS = ("gather_rows_bf16", "gather_rows_smallc",
                      "gather_rows_smallc_bf16", "scatter_rows_add_bf16")
# the motion planner: no K3, the categorical stem's bf16 K9 (its dW and the
# label table's gradient are autograd of its product), K7 for the 9 CPE
BF16_MP_PER_STEP = dict(BF16_PER_STEP, stem_conv_bf16=0,
                        gather_rows_smallc_bf16=1, conv_weight_grad_bf16=9)
BF16_MP_PER_STEP_REDRAW = dict(BF16_PER_STEP_REDRAW, stem_conv_bf16=0,
                               gather_rows_smallc_bf16=1,
                               conv_weight_grad_bf16=9)
# the bf16 paths of the backward kernels and of K5, by their counter
BF16_TRAIN_KERNELS = ("subm_conv_dx_bf16", "patch_attention_dropout_bf16",
                      "patch_attention_dropout_bwd_bf16",
                      "conv_weight_grad_bf16", "scatter_rows_add_bf16")
# train_simple_policy.main / train_motion_planner.main at bf16: steps, a
# save at the last
BF16_ENTRY_STEPS = 4
# the bf16 step check, card vs the CPU port at bf16, the CPU following the
# card's max decisions and leaky-ReLU ties (losses and state relative to
# max(1, |ref|), each gradient as GRAD_TOL's, all gradients together by
# their relative L2 distance): a bf16 activation that the card's fp32 sums
# and the CPU's round to neighbouring values differs by one bf16 ulp (2^-8
# relative), and such flips reach the losses and the gradients through
# the rest of the step; a bias's gradient, a sum of many cancelling bf16
# terms, moves by a large share of its own scale (up to 0.39 measured on
# an H100), the gradients as a whole by ~0.01-0.02
BF16_STEP_TOLS = {"loss": 2.0 ** -8, "state": 2.0 ** -8, "grad": 2.0 ** -1,
                  "grad_l2": 2.0 ** -5}
# with the max decisions followed every gradient is held on every slice,
# so two slices (and the redrawn one) a family cover what CHECK_SLICES
# covers at fp32 (3 until the attention options' phases pushed the run
# past 900 s)
BF16_CHECK_SLICES = 2
# leaky-ReLU ties at bf16: the heads' pre-activations (fp32, from bf16
# backbone features) differ between the card and the CPU by bf16 ulps of
# the features, up to ~2^-7 of max|z| (0.0063 measured on an H100); the
# CPU follows the card's branch within 2^-5 of max|z|, at most
# BF16_MAX_KINKS elements a step (measured 2,300 of the policy head's
# ~1.0M pre-activations a slice, 11,900 of the planner's 5x as many)
BF16_KINK_TOL = 2.0 ** -5
BF16_MAX_KINKS = 1 << 15


def _bf16_err(got, want, what, extra=None, relative=True):
    """max |got - want| of a bf16 result; raises past the bar of
    ops/bf16.py (relative: the slack taken of max |want|, for gradients)."""
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"{what}: {got.dtype} output")
    err = float((got.float() - want.float()).abs().max())
    excess = bf16_excess(got, want, extra=extra, relative=relative)
    if not bool(torch.isfinite(got).all()) or excess > 0:
        raise AssertionError(f"{what}: max |kernel - plain| = {err}, "
                             f"{excess} past the bf16 bar")
    return err


# the bf16 training phases time each plain version once, after the check
# has run it (K5's takes ~0.56 s a call at B = 32: TRAIN_TIMING's 11 calls
# of its 9 would take a minute a family)
PLAIN_TIMING = dict(rounds=1, reps=1, warmup=0)


def _timed_bf16(run, plain, library, nbytes, flops, name, also=()):
    """Event and profiler device times of a bf16 call, its plain version's
    (PLAIN_TIMING) and the library call's (None: none); the bound: the
    bytes at 3.35 TB/s against the flops at 989 TFLOP/s bf16."""
    bound_ms, t_b, t_f = _bound(nbytes, flops, BF16_FLOPS_PER_S)
    return {"ms": cuda_ms(run, **TRAIN_TIMING),
            "device_ms": device_ms(run, name, reps=4, also=also),
            "plain_ms": cuda_ms(plain, **PLAIN_TIMING),
            "library_ms": cuda_ms(library, **TRAIN_TIMING)
            if library else None,
            "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f}


# K5's Philox work: P^2 / 4 Philox4x32-10 calls per (g, h) at rate > 0, 10
# rounds of two 32 x 32 -> 64-bit multiplies (four 32-bit results) and two
# three-input XORs each, at the H100's 64 integer operations a clock on
# each of 132 SMs at 1.98 GHz (the clock and SM count behind the data
# sheet's 67 TFLOP/s fp32)
PHILOX_OPS_PER_CALL = 60
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def _philox_s(G, H, P, rate):
    """Seconds of K5's Philox work at the card's integer rate (0 at rate
    0: the kernel draws no bits then)."""
    calls = G * H * -(-P * P // 4) if rate > 0 else 0
    return calls * PHILOX_OPS_PER_CALL / INT32_OPS_PER_S


def check_attention_train_bf16(call, timed=True):
    """K5 and K6 at bf16 on one captured call: K5 (out, lse, bits)
    bit-equal across two launches, its bits bit-equal to philox_keep_mask,
    out within the bf16 bar plus one bf16 ulp of each dropped
    probability's share, lse within 1e-4; K6 on K5's outputs and the
    captured cotangent bit-equal across two launches and within the bf16
    bar (the gradients' own scale) of its plain version; if `timed`,
    timed beside SDPA forward (dropout_p) and backward in bf16, the bound
    of K5 the larger of its bytes and its Philox work (_philox_s)."""
    (q, k, v, kv, scale, rate, seed), g = call
    G, H, P, Dh = q.shape
    shape = [G, H, P, Dh]
    if q.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 attention {shape}: {q.dtype}, g "
                             f"{g.dtype}")
    run5 = lambda: attention.patch_attention_dropout_fwd(  # noqa: E731
        q, k, v, kv, scale, rate, seed)
    plain5 = lambda: attention.patch_attention_dropout_fwd_plain(  # noqa
        q, k, v, kv, scale, rate, seed)
    (out, lse, bits), again = run5(), run5()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((out, lse, bits), again)):
        raise AssertionError(f"bf16 K5 {shape}: two launches differ")
    del again
    keep = attention.philox_keep_mask(seed, G, H, P, rate, q.device)
    if not torch.equal(bits, attention.pack_keep_bits(keep)):
        raise AssertionError(f"bf16 K5's bits {shape} differ from "
                             "philox_keep_mask")
    p_out, p_lse, _ = plain5()
    e5 = _bf16_err(out, p_out, f"bf16 K5 out {shape}",
                   attention.bf16_probability_allowance(
                       q, k, v, kv, scale, rate, keep), relative=False)
    del keep
    live = kv.any(-1)
    e_lse = _err(lse[live], p_lse[live], f"bf16 K5 lse {shape}")
    del p_out, p_lse
    run6 = lambda: torch.stack(  # noqa: E731
        attention.patch_attention_dropout_bwd(q, k, v, kv, out, lse, bits,
                                              g, scale, rate))
    plain6 = lambda: attention.patch_attention_dropout_bwd_plain(  # noqa
        q, k, v, kv, out, lse, bits, g, scale, rate)
    got6 = _twice(run6, f"bf16 K6 {shape}")
    e6 = max(_bf16_err(a, b.to(torch.bfloat16), f"bf16 K6 d{n} {shape}")
             for a, b, n in zip(got6, plain6(), "qkv"))
    del got6
    if not timed:
        return ({"max_abs_err": e5, "lse_err": e_lse, "shape": shape},
                {"max_abs_err": e6, "shape": shape})
    mask = kv[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, dropout_p=rate, scale=scale)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                              dropout_p=rate, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, (qg, kg, vg), g, retain_graph=True)
    qb = 2 * q.numel()
    side = 4 * (lse.numel() + bits.numel()) + kv.numel()
    flops = 2 * G * H * P * P * Dh                            # one product
    r5 = dict(_timed_bf16(lambda: run5()[0], plain5, sdpa, 4 * qb + side,
                          2 * flops, "attn_drop_fwd"),
              max_abs_err=e5, lse_err=e_lse, shape=shape)
    # the operations' time: the products' or the Philox work's, the larger
    r5["philox_s"] = _philox_s(G, H, P, rate)
    r5["flops_s"] = max(r5["flops_s"], r5["philox_s"])
    r5["bound_ms"] = 1e3 * max(r5["bytes_s"], r5["flops_s"])
    r6 = dict(_timed_bf16(run6, plain6, sdpa_bwd, 8 * qb + side, 5 * flops,
                          "attn_drop_bwd"), max_abs_err=e6, shape=shape)
    return r5, r6


def check_weight_grad_bf16(call):
    """K7 at bf16 on one captured conv or stem call: fp32 sums bit-equal
    across two launches and within 1e-4 of the plain version's largest
    value; timed beside the im2col gather + matmul in bf16; the profiler's
    device time of the product kernel alone and, on the CPE path, of the
    live-list compaction alone."""
    (x, idx, ok, w, *_), g = call
    K, cin, cout = w.shape
    shape = list(x.shape[:2]) + [K, cin, cout]
    run = lambda: conv.conv_weight_grad(x, idx, ok, g)  # noqa: E731
    plain = lambda: conv.conv_weight_grad_plain(x, idx, ok, g)  # noqa
    err = _err(_twice(run, f"bf16 K7 {shape}"), plain(), f"bf16 K7 {shape}")
    nbytes = 2 * (x.numel() + g.numel()) + 4 * w.numel() + 5 * idx.numel()
    # the stem's 7 channels take the (tap, channel) path, every width of
    # 8 (or padded to it) the CPE path's compacted lists
    path = "stem" if cin % 8 and cin < conv.WGRAD_PAD_MIN_CIN else "cpe"
    return dict(_timed_bf16(run, plain, _im2col_wgrad(x, idx, ok, g), nbytes,
                            2 * cin * cout * int(ok.sum()), *K7_PROFILE),
                max_abs_err=err, shape=shape, path=path,
                product_device_ms=device_ms(run, K7_PROFILE[0], reps=4),
                compact_device_ms=device_ms(run, "wgrad_compact", reps=4)
                if path == "cpe" else 0.0)


def k8_collisions(idx, n, valid=None):
    """How one K8 call's indices collide (the structure its design relies
    on for speed, csrc/gather.cu): live rows (index in [0, n), and valid),
    the share of them whose index is not their own row, the share of hit
    destinations with more than one source and of live rows in them, the
    most sources of one destination, whether every cloud's live indices
    are nondecreasing (runs) and whether every live index is at most its
    row."""
    idx = idx.long()
    B, M = idx.shape
    live = (idx >= 0) & (idx < n)
    if valid is not None:
        live &= valid
    rows = torch.arange(M, device=idx.device)[None]
    flat = torch.where(live, idx + torch.arange(B, device=idx.device)[:, None]
                       * n, B * n)
    cnt = torch.bincount(flat.reshape(-1), minlength=B * n + 1)[:B * n]
    nl, hit = int(live.sum()), int((cnt > 0).sum())
    runs = all(bool((v[1:] >= v[:-1]).all())
               for v in (idx[b][live[b]] for b in range(B)))
    return {"live_rows": nl, "not_own_share":
            int((live & (idx != rows)).sum()) / max(nl, 1),
            "multi_dest_share": int((cnt > 1).sum()) / max(hit, 1),
            "rows_in_multi_share": int(cnt[cnt > 1].sum()) / max(nl, 1),
            "max_sources": int(cnt.max()) if cnt.numel() else 0,
            "runs": runs, "index_le_row": bool((~live | (idx <= rows)).all())}


def check_scatter_add_bf16(g, idx, n, dtype=torch.bfloat16):
    """K8 at bf16: the rounded sums (dtype bf16, K4's backward) within the
    bf16 bar of the plain sums rounded once, or the fp32 sums (the conv's
    owner sum) within 1e-4 of the plain version's largest value, both
    bit-equal across two launches (the kernel adds in a fixed order);
    timed beside index_add_ in bf16; the indices' collisions
    (k8_collisions)."""
    B, _, D = g.shape
    shape = list(g.shape) + [n]
    run = lambda: gather.scatter_rows_add(g, idx, n, dtype)  # noqa: E731
    plain = lambda: gather.scatter_rows_add_plain(  # noqa: E731
        g, idx, n).to(dtype)
    got = _twice(run, f"bf16 K8 {shape}")
    if dtype == torch.bfloat16:
        err = _bf16_err(got, plain(), f"bf16 K8 {shape}")
    else:
        err = _err(got, plain(), f"bf16 K8 fp32 sums {shape}")
    del got
    out_bytes = (2 if dtype == torch.bfloat16 else 4) * B * n * D
    return dict(_timed_bf16(run, plain, _index_add(g, idx, n),
                            2 * g.numel() + out_bytes +
                            idx.numel() * idx.element_size(), g.numel(),
                            K8_PROFILE),
                max_abs_err=err, shape=shape, out=str(dtype),
                sentinel_rows=int(((idx < 0) | (idx >= n)).sum()),
                collisions=k8_collisions(idx, n))


def check_conv_dx_bf16(call):
    """The conv's input gradient at bf16 on one captured call: K8's fp32
    owner sums of the bf16 cotangent (checked and timed), the mirrored K2
    on them with the bf16 weight (r3dl_subm_conv_dx_bf16) bit-equal across
    two launches and within the bf16 bar of its plain version, timed
    beside the im2col gather + matmul in bf16; the whole dx
    (conv_input_grad) within the bf16 bar of the exact adjoint computed in
    fp32 (autograd of subm_conv_plain on the widened operands) rounded
    once."""
    (x, idx, ok, w, bias), g = call
    B, N, cin = x.shape
    cout = w.shape[-1]
    shape = [B, N, idx.shape[-1], cin, cout]
    # K8 as conv_input_grad calls it: the owner index with the sentinel
    # where the centre link is invalid, the cotangent as it is
    owner = conv.owner_index(idx, ok)
    k8 = check_scatter_add_bf16(g, owner, N, torch.float32)
    gsum = gather.scatter_rows_add(g, owner, N, torch.float32)
    wm = conv.mirror_weight(w)
    run = lambda: conv._conv_forward(gsum, idx, ok, wm, None)  # noqa: E731
    plain = lambda: conv.subm_conv_plain(  # noqa: E731
        gsum, idx, ok, wm).to(torch.bfloat16)
    err = _bf16_err(_twice(run, f"bf16 mirrored K2 {shape}"), plain(),
                    f"bf16 mirrored K2 {shape}")
    xr = x.float().requires_grad_()
    exact = torch.autograd.grad(
        conv.subm_conv_plain(xr, idx, ok, w.float()), xr, g.float())[0]
    e_dx = _bf16_err(conv.conv_input_grad(g, idx, ok, w),
                     exact.to(torch.bfloat16),
                     f"bf16 conv dx vs the exact adjoint {shape}")
    del xr, exact
    nbytes = 4 * gsum.numel() + 2 * (wm.numel() + B * N * cin) + \
        5 * idx.numel()
    row = dict(_timed_bf16(run, plain,
                           _im2col(gsum.to(torch.bfloat16), idx, ok, wm),
                           nbytes, 2 * cin * cout * int(ok.sum()),
                           *K2_PROFILE),
               max_abs_err=err, dx_vs_exact_err=e_dx, shape=shape,
               shares=link_shares(ok))
    return row, k8


def check_conv_fwd_bf16(call):
    """K2's bf16 forward on one captured training call (B = 32): bit-equal
    across two launches, within the bf16 bar of its plain version, timed
    (events, profiler) beside its bound and the im2col gather + matmul in
    bf16. Returns the row and the call (for device_ms_queued)."""
    (x, idx, ok, w, bias), _ = call
    B, N, cin = x.shape
    K, _, cout = w.shape
    shape = [B, N, K, cin, cout]
    run = lambda: conv.subm_conv(x, idx, ok, w, bias)  # noqa: E731
    plain = lambda: conv.subm_conv_plain(x, idx, ok, w, bias)  # noqa
    err = _bf16_err(_twice(run, f"bf16 K2 {shape}"), plain(),
                    f"bf16 K2 {shape}", relative=False)
    nbytes = 2 * (x.numel() + w.numel() + B * N * cout) + 4 * cout + \
        5 * idx.numel()
    return dict(_timed_bf16(run, plain, _im2col(x, idx, ok, w), nbytes,
                            2 * cin * cout * int(ok.sum()), *K2_PROFILE),
                max_abs_err=err, shape=shape, shares=link_shares(ok),
                pairs=ok.numel()), run


def _queued_fallback(row, runs, tag, name):
    """A row whose profiler windows recorded nothing for some call takes
    its device time from events with the launches queued."""
    if row["device_ms"] is None:
        row["device_ms"] = device_ms_queued(runs)
        row["device_ms_from"] = "queued events"
        log(f"[{tag}] {name}: device time from queued events "
            f"{row['device_ms']}")
    else:
        row["device_ms_from"] = "profiler"


def _bf16_rows(res, tag):
    rows = {}
    for name, rs in res.items():
        rows[name] = dict(_row(rs), calls=len(rs),
                          device_ms=_total(r["device_ms"] for r in rs))
        r = rows[name]
        log(f"[{tag}] {name}: {len(rs)} calls per step within their bars "
            f"(max |kernel - plain| {r['max_abs_err']:.3g}); "
            f"{r['ms']:.4f} ms (device {r['device_ms']}; plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return rows


def bf16_train_kernel_phase(captured, tag, expect):
    """Every bf16 K5, K6, K7, K8 and conv input-gradient call of one
    captured training step, checked and timed; returns the kernels-line
    rows (sums over the step) and the calls. `expect`: the captured calls
    with a cotangent, by site."""
    att = captured.get("attention", [])
    convs = [c for c in captured.get("subm_conv", []) if c[1] is not None]
    stems = [c for c in captured.get("stem_conv", []) if c[1] is not None]
    scat = [c for c in captured.get("gather_rows", []) if c[1] is not None]
    for name, got in (("attention", att), ("conv", convs), ("stem", stems),
                      ("scatter", scat)):
        if len(got) != expect[name]:
            raise AssertionError(f"[{tag}] captured {len(got)} {name} calls "
                                 f"with a cotangent, expected "
                                 f"{expect[name]}")
    res = {k: [] for k in BF16_TRAIN_KERNELS}
    runs5 = []
    for c in att:
        r5, r6 = check_attention_train_bf16(c)
        res["patch_attention_dropout_bf16"].append(r5)
        res["patch_attention_dropout_bwd_bf16"].append(r6)
        (q, k, v, kv, scale, rate, seed), _ = c
        runs5.append(lambda a=(q, k, v, kv, scale, rate, seed):
                     attention.patch_attention_dropout_fwd(*a))
    # K5 / K6 at a ragged patch (P = 77, a last 16-key block of 13) on the
    # step's smallest head dim: a captured call's first 77 rows and keys
    (q, k, v, kv, scale, rate, seed), g = min(att, key=lambda c: c[0][0]
                                              .shape[-1])
    ragged = ((*(t[:, :, :77].contiguous() for t in (q, k, v)),
               kv[:, :77].contiguous(), scale, rate, seed),
              g[:, :, :77].contiguous())
    e5, e6 = check_attention_train_bf16(ragged, timed=False)
    log(f"[{tag}] K5 / K6 at bf16 on a ragged patch {e5['shape']}: within "
        f"their bars (max |kernel - plain| {e5['max_abs_err']:.3g} / "
        f"{e6['max_abs_err']:.3g}), bits equal to philox_keep_mask")
    del ragged
    k2f, runs2 = [], []
    for c in convs:
        row, run = check_conv_fwd_bf16(c)
        k2f.append(row)
        runs2.append(run)
    res["conv_weight_grad_bf16"] = [check_weight_grad_bf16(c)
                                    for c in convs + stems]
    res["scatter_rows_add_bf16"] = [
        check_scatter_add_bf16(g, idx, x.shape[1])
        for (x, idx), g in scat]
    for c in convs:
        row, k8 = check_conv_dx_bf16(c)
        res["subm_conv_dx_bf16"].append(row)
        res["scatter_rows_add_bf16"].append(k8)
    k8s = res["scatter_rows_add_bf16"]
    for what, rs in (("unpool backwards", k8s[:len(scat)]),
                     ("conv owner sums", k8s[len(scat):])):
        log(f"[{tag}] K8 bf16, the {len(rs)} {what}: device "
            f"{_total(r['device_ms'] for r in rs)} ms, events "
            f"{sum(r['ms'] for r in rs):.4f}, bound "
            f"{sum(r['bound_ms'] for r in rs):.4f}; collisions per call "
            + "; ".join(f"{r['shape']} {r['collisions']}" for r in rs))
    # the forward kernels' bf16 rows per training step: K3 on the step's
    # B = 32 stem call (its dW is K7's, above), K4 on the unpools' calls,
    # K9 on the planner's categorical stem
    steps = {}
    if stems:
        k3 = steps["k3"] = dict(check_bf16_call(
            "stem_conv", stems[0][0], timing=TRAIN_TIMING),
            launches_per_step=len(stems))
        log(f"[{tag}] K3 bf16 per training step {k3['shape']}: shares "
            f"{k3['shares']}; max_abs_err {k3['max_abs_err']:.3g}; "
            f"{k3['ms']:.4f} ms (device {k3['device_ms']}; plain "
            f"{k3['plain_ms']:.4f}, im2col in bf16 {k3['library_ms']:.4f}; "
            f"bound {k3['bound_ms']:.4f})")
    for key, site in (("k4", "gather_rows"), ("k9", "gather_rows_smallc")):
        calls16 = [a for a, _ in captured.get(site, [])
                   if a[0].dtype == torch.bfloat16]
        if not calls16:
            continue
        gs = [check_gather(site, a, TRAIN_TIMING) for a in calls16]
        log_gathers(tag, f"{site} bf16 per training step", gs)
        steps[key] = dict(
            _row(gs), calls=len(gs), launches_per_step=len(gs),
            device_ms=_total(r["device_ms"] for r in gs),
            library_device_ms=_total(r["library_device_ms"] for r in gs))
        r = steps[key]
        log(f"[{tag}] {site} bf16: {len(gs)} calls per step, bit-equal, "
            f"{r['ms']:.4f} ms (device {r['device_ms']}; plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, torch.gather "
            f"{r['library_ms']:.4f}, device {r['library_device_ms']})")
    log(f"[{tag}] K5 bits bit-equal to philox_keep_mask and K5, K6, K7 and "
        f"the mirrored K2 bit-equal across two launches on all "
        f"{len(att)} / {len(att)} / {len(convs) + len(stems)} / "
        f"{len(convs)} calls; conv dx vs the exact fp32 adjoint rounded "
        f"once: max err "
        f"{max(r['dx_vs_exact_err'] for r in res['subm_conv_dx_bf16']):.3g}")
    rows = _bf16_rows(res, tag)
    _queued_fallback(rows["patch_attention_dropout_bf16"], runs5, tag,
                     "patch_attention_dropout_bf16")
    k7 = rows["conv_weight_grad_bf16"]
    for path in ("cpe", "stem"):
        rs = [r for r in res["conv_weight_grad_bf16"] if r["path"] == path]
        if not rs:
            continue
        k7[path] = dict(
            _row(rs), calls=len(rs),
            device_ms=_total(r["device_ms"] for r in rs),
            product_device_ms=_total(r["product_device_ms"] for r in rs),
            compact_device_ms=_total(r["compact_device_ms"] for r in rs))
        r = k7[path]
        log(f"[{tag}] K7 bf16, the {path} path: {len(rs)} calls a step, "
            f"{r['ms']:.4f} ms (device {r['device_ms']}: product kernel "
            f"{r['product_device_ms']}, live-list compaction "
            f"{r['compact_device_ms']}; bound {r['bound_ms']:.4f}, im2col "
            f"{r['library_ms']})")
    for r in k2f:
        log(f"[{tag}] K2 bf16 forward per training step, call {r['shape']}: "
            f"shares {r['shares']}; max_abs_err {r['max_abs_err']:.3g}; "
            f"{r['ms']:.4f} ms (device {r['device_ms']}; plain "
            f"{r['plain_ms']:.4f}, im2col {r['library_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f})")
    fwd = dict(_row(k2f), calls=len(k2f), shares=_shares(k2f),
               device_ms=_total(r["device_ms"] for r in k2f))
    _queued_fallback(fwd, runs2, tag, "K2 bf16 forward")
    log(f"[{tag}] K2 bf16 forward per training step: {len(k2f)} calls "
        f"within the bf16 bar, {fwd['ms']:.4f} ms (device "
        f"{fwd['device_ms']}; plain {fwd['plain_ms']:.4f}, im2col "
        f"{fwd['library_ms']:.4f}, bound {fwd['bound_ms']:.4f} by "
        f"{fwd['bound_by']})")
    del runs5, runs2
    res["subm_conv_bf16_forward"] = k2f
    return rows, res, fwd, steps


def _side_by_side(tag, r32, r16, keys):
    side = {k: {"fp32": r32.get(k), "bf16": r16.get(k)} for k in keys}
    log(f"[{tag}] bf16 beside fp32 (this run, B = 32 x 4096): " + "; ".join(
        f"{k} {v['bf16']:.3f} vs {v['fp32']:.3f}" for k, v in side.items()
        if v["bf16"] is not None and v["fp32"] is not None))
    g32 = r32.get("device_ms_by_group", {})
    for g, v in r16.get("device_ms_by_group", {}).items():
        f = g32.get(g, {"ms": 0.0, "count": 0})
        log(f"[{tag}]   {g}: bf16 {v['ms']:.3f} ms x{v['count']}, fp32 "
            f"{f['ms']:.3f} ms x{f['count']} per step")
    return side


TRAIN_SIDE_KEYS = ("step_ms_p50", "clouds_per_s", "peak_mem_gib",
                   "device_busy_ms_per_step", "device_idle_share")


def bf16_entry_phase(module, config, per_step, serve, tag,
                     steps=BF16_ENTRY_STEPS):
    """module.main at bf16 (the BF16_OPTS override) on the card for `steps`
    steps with its loader worker processes and the prefetch, a save at the
    last step: launches held at per_step, every logged loss finite, the
    model file fp32 and its state bit-equal to the trainer's; then
    serve(path) serves it at fp32 and at bf16. The run directory (under
    build/smoke_runs) is removed after."""
    run = os.path.join(ROOT, "build", "smoke_runs", tag)
    shutil.rmtree(run, ignore_errors=True)
    cfg = config(*BF16_OPTS, "output_dir", run, "TRAIN.num_train_steps",
                 str(steps), "TRAIN.log_steps", "1", "TRAIN.save_steps",
                 str(steps))
    logger = logging.getLogger("robot3dlotus_tpu_torch.train")
    handler, level = _Records(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        trainer = module.main(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_lib.LAUNCHES)
        _held(launches, per_step, steps, f"[{tag}] {steps} steps")
        lines = [r.getMessage() for r in handler.records
                 if r.getMessage().startswith("step ")]
        if len(lines) != steps:
            raise AssertionError(f"[{tag}] {len(lines)} step lines")
        for m in lines:
            if not all(math.isfinite(float(kv.split("=")[1]))
                       for kv in m.split(": ", 1)[1].split(", ")):
                raise AssertionError(f"[{tag}] {m}")
        if trainer.model.ptv3_model.compute_dtype != torch.bfloat16:
            raise AssertionError(f"[{tag}] the model is not at bf16")
        path = os.path.join(run, "ckpts", f"model_step_{steps}.msgpack")
        kinds = set()
        _leaf_dtypes(msgpack_io.load(path), kinds)
        if "float32" not in kinds or kinds - {"float32", "int32", "int64"}:
            raise AssertionError(f"[{tag}] model file dtypes {kinds}")
        saved = load_any_model_ckpt(path, trainer.model)
        state = trainer.model.state_dict()
        for k, v in saved.items():
            if not torch.equal(v, state[k]):
                raise AssertionError(f"[{tag}] saved {k} differs")
        del trainer, saved, state
        torch.cuda.empty_cache()
        served = serve(path)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
        shutil.rmtree(run, ignore_errors=True)
    out = {"steps": steps, "wall_s": wall, "launches": launches,
           "log": lines, "served": served}
    log(f"[{tag}] {module.__name__.rsplit('.', 1)[-1]}.main at bf16, "
        f"{steps} steps in {wall:.2f} s (build and loader start included), "
        f"launches held at {steps} x the per-step counts; the model file "
        f"(fp32) served at fp32 and bf16: {served}")
    for m in lines:
        log(f"[{tag}]   {m}")
    return out


def _leaf_dtypes(tree, kinds):
    """The dtype names of a decoded msgpack tree's arrays, into `kinds`."""
    for v in tree.values():
        if isinstance(v, dict):
            _leaf_dtypes(v, kinds)
        else:
            kinds.add(str(np.asarray(v).dtype))


def _served_actions(make, run, per_forward, what):
    """Build a server from the saved file, serve one request with launches
    held at per_forward; returns the action (finite)."""
    server = make()
    launches = _launches_of(lambda: run(server))
    _held(launches, per_forward, 1, what)
    action = np.asarray(run(server))
    if not np.isfinite(action).all():
        raise AssertionError(f"{what}: action {action}")
    del server
    torch.cuda.empty_cache()
    return action


def bf16_train_phase(host, training32, observations, out_dir):
    """Training the policy at compute_dtype bfloat16 (the release YAML with
    BF16_OPTS, B = 32 x 4096, release dropout, TRAIN.host_structure) on
    phase 7's host batches: one step captured and every bf16 K5, K6, K7,
    K8 and conv input-gradient call checked and timed
    (bf16_train_kernel_phase); TRAIN_STEPS counted steps at BF16_PER_STEP
    (the fp32 counters 0) and a profiler window, beside phase 8's fp32
    numbers; the step check at dropout 0 card vs the CPU port at bf16
    (BF16_STEP_TOLS), slice 0 also against the CPU port at fp32 (the card
    must be nearer the CPU's bf16 step); then train_simple_policy.main at
    bf16 and its model file served at fp32 and bf16."""
    tag = "bf16-train"
    t0 = time.perf_counter()
    trainer, batches, _ = build_trainer(train_config(*BF16_OPTS), SPEC,
                                        device="cuda")
    if hasattr(batches, "close"):
        batches.close()
    log(f"[{tag}] release-width trainer at compute_dtype bfloat16 built in "
        f"{time.perf_counter() - t0:.2f} s; phase 7's host batches")
    captured = capture(lambda: trainer.step(batch_to_device(host[0], "cuda")),
                       TRAIN_SITES)
    rows, calls, k2_forward, steps = bf16_train_kernel_phase(
        captured, tag, {"attention": 9, "conv": 9, "stem": 1,
                        "scatter": BF16_PER_STEP["gather_rows_bf16"]})
    del captured
    torch.cuda.empty_cache()
    training16, launches = training_phase(
        trainer, host[1:], out_dir, BF16_PER_STEP, "profile_train_bf16.txt",
        "bf16-training", nmap=True)
    del trainer
    torch.cuda.empty_cache()
    side = _side_by_side(tag, training32, training16, TRAIN_SIDE_KEYS)
    step_check = step_check_phase(
        host[0], lambda *o: train_config(*BF16_OPTS, *o), compute_loss,
        "bf16-step-check", BF16_CHECK_SLICES, BF16_PER_STEP,
        BF16_PER_STEP_REDRAW,
        tols=BF16_STEP_TOLS, order_kernels=BF16_ORDER_KERNELS,
        fp32_config=train_config, kink_tol=BF16_KINK_TOL,
        kink_limit=BF16_MAX_KINKS, follow_maxes=True)

    def serve(path):
        acts = {}
        for name, opts, per in (("fp32", [], PER_FORWARD),
                                ("bf16", BF16_OPTS, BF16_PER_FORWARD)):
            def run(a):
                a.rng = np.random.default_rng(0)
                return a.predict(**requests(observations)[0])["action"]
            acts[name] = _served_actions(
                lambda: Actioner(CONFIG, checkpoint=path,
                                 cli_opts=CLI_OPTS + opts, device="cuda"),
                run, per, f"[{tag}] served at {name}")
        return {k: v.tolist() for k, v in acts.items()}

    entry = bf16_entry_phase(train_simple_policy, train_config,
                             BF16_PER_STEP, serve, "bf16-entry")
    return {"kernels": rows, "calls": calls, "k2_forward_step": k2_forward,
            "forward_steps": steps,
            "training": training16, "launches": launches,
            "bf16_beside_fp32": side, "step_check": step_check,
            "entry": entry}


def bf16_mp_train_phase(host, training32, mp_obs, out_dir):
    """bf16_train_phase for the motion planner (MP_TRAIN_OPTS + BF16_OPTS,
    phase 17's host batches, BF16_MP_PER_STEP): the captured step's calls
    (no stem K7: the categorical stem's dW is its product's autograd),
    counted steps beside phase 17's, the step check, train_motion_planner.
    main at bf16 and its file behind the GT pipeline at fp32 and bf16."""
    tag = "bf16-mp-train"
    trainer, batches, _ = build_trainer(mp_config(*BF16_OPTS),
                                        train_motion_planner.SPEC,
                                        device="cuda")
    if hasattr(batches, "close"):
        batches.close()
    captured = capture(lambda: trainer.step(batch_to_device(host[0], "cuda")),
                       TRAIN_SITES + SMALLC_SITES)
    rows, calls, k2_forward, steps = bf16_train_kernel_phase(
        captured, tag, {"attention": 9, "conv": 9, "stem": 0,
                        "scatter": BF16_MP_PER_STEP["gather_rows_bf16"]})
    del captured
    torch.cuda.empty_cache()
    training16, launches = training_phase(
        trainer, host[1:], out_dir, BF16_MP_PER_STEP,
        "profile_mp_train_bf16.txt", "bf16-mp-training")
    del trainer
    torch.cuda.empty_cache()
    side = _side_by_side(tag, training32, training16, TRAIN_SIDE_KEYS)
    step_check = step_check_phase(
        host[0], lambda *o: mp_config(*BF16_OPTS, *o), compute_mp_loss,
        "bf16-mp-step-check", BF16_CHECK_SLICES, BF16_MP_PER_STEP,
        BF16_MP_PER_STEP_REDRAW, tols=BF16_STEP_TOLS,
        order_kernels=BF16_ORDER_KERNELS, fp32_config=mp_config,
        kink_tol=BF16_KINK_TOL, kink_limit=BF16_MAX_KINKS,
        follow_maxes=True)

    def serve(path):
        acts = {}
        for name, opts, per in (("fp32", [], MP_PER_FORWARD),
                                ("bf16", BF16_OPTS, BF16_MP_PER_FORWARD)):
            def run(engine):
                return np.stack(mp_episode(mp_pipeline(engine), mp_obs[:1],
                                           0)[0])
            acts[name] = _served_actions(
                lambda: MotionPlannerEngine(MP_CONFIG, checkpoint=path,
                                            cli_opts=opts, device="cuda"),
                run, per, f"[{tag}] served at {name}")
        return {k: v.tolist() for k, v in acts.items()}

    entry = bf16_entry_phase(train_motion_planner, mp_config,
                             BF16_MP_PER_STEP, serve, "bf16-mp-entry")
    return {"kernels": rows, "calls": calls, "k2_forward_step": k2_forward,
            "forward_steps": steps,
            "training": training16, "launches": launches,
            "bf16_beside_fp32": side, "step_check": step_check,
            "entry": entry}


# -------------------------------------------------- conditioning variants --

def captured_checks(captured, per_forward, tag):
    """Every kernel call one captured forward made, against its plain
    version (the per-forward counts of calls included)."""
    out = {}
    for kernel, per in per_forward.items():
        calls = captured.get(kernel, [])
        if len(calls) != per:
            raise AssertionError(f"[{tag}] {kernel}: captured {len(calls)} "
                                 f"calls, expected {per}")
        res = [check_call(kernel, c, timed=False) for c in calls]
        out[kernel] = max((r["max_rel_err"] for r in res), default=0.0)
    log(f"[{tag}] every kernel call of one captured forward against its "
        f"plain version, worst relative error by kernel: {out}")
    return out


def policy_variant_phase(tag, opts, per_forward, per_step, per_step_redraw,
                         observations, stem_calls=False):
    """One conditioning variant of the policy at the release width:
    Actioner serving (a captured forward's kernel calls against their
    plain versions; 4 requests and a predict_batch, launches held at
    per_forward; card vs CPU logits), VARIANT_STEPS training steps at
    B = 32 (launches held at per_step), a step check on
    VARIANT_CHECK_SLICES slices. With stem_calls, the training step's stem
    conv call (the Concat stem, 125 taps) is captured and its K2 forward,
    mirrored dx and K7 held and timed (concat_stem_phase)."""
    t0 = time.perf_counter()
    cli = CLI_OPTS + opts
    actioner = Actioner(CONFIG, cli_opts=cli, device="cuda", seed=0)
    log(f"[{tag}] release-width Actioner ({opts}) built in "
        f"{time.perf_counter() - t0:.2f} s")
    actioner.rng = np.random.default_rng(0)
    captured = capture_main_path(
        lambda: actioner.predict(**requests(observations)[0]))
    out = {"kernel_rel_err": captured_checks(captured, per_forward, tag)}
    stem = [c for c in captured["subm_conv"] if c[3].shape[0] == 125]
    if stem:
        out["stem_forward_b1"] = check_conv(stem[0])
        log_conv(tag, "the stem's K2 at B = 1", out["stem_forward_b1"])
    del captured
    out["serving"] = serving_phase(actioner, observations, per_forward, tag)
    out["reference_max_diff"] = reference_phase(actioner, observations[0],
                                                tag=tag, cli_opts=cli)
    del actioner
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    config = lambda *o: train_config(*opts, *o)  # noqa: E731
    trainer, batches, _ = build_trainer(config(), SPEC, device="cuda")
    host, _ = host_batches(batches, 1 + VARIANT_STEPS)
    log(f"[{tag}] trainer built and {len(host)} host batches made in "
        f"{time.perf_counter() - t0:.1f} s")
    step_calls = None
    if stem_calls:
        step_calls = [c for c in capture(
            lambda: trainer.step(batch_to_device(host[0], "cuda")),
            [(sparse_conv, "subm_conv", "subm_conv")])["subm_conv"]
            if c[0][3].shape[0] == 125]
    out["training"], out["training_launches"] = training_phase(
        trainer, host[1:], None, per_step, None, tag)
    del trainer, batches
    torch.cuda.empty_cache()
    out["step_check"] = step_check_phase(
        host[0], config, compute_loss, f"{tag}-step-check",
        VARIANT_CHECK_SLICES, per_step, per_step_redraw)
    return out, step_calls


def concat_stem_phase(call):
    """The Concat stem's call of a training step (B = 32 x 4096, 125 taps,
    263 input channels, its output cotangent): the conv's dx (K8 onto the
    voxel owners, then K2 with the mirrored weight, 263 outputs) against
    the exact adjoint, K2's forward and mirrored launches and K7 against
    their plain versions within 1e-4 of the plain scale, bit-equal across
    two launches, timed by CUDA events and on the profiler beside their
    bounds (the live links only)."""
    dx, k8, (fwd, mirrored), _ = check_conv_dx(call)
    k7 = check_weight_grad(call, im2col=False)
    for label, r in (("K2 forward", fwd), ("K2 mirrored (dx)", mirrored),
                     ("K7", k7)):
        log_conv("concat-stem", label, r)
    log(f"[concat-stem] conv dx vs the exact adjoint: max err "
        f"{dx['max_abs_err']:.3g}; K8 owner sums {k8['ms']:.4f} ms")
    return {"dx": dx, "k8_owner_sum": k8, "k2_forward": fwd,
            "k2_mirrored_dx": mirrored, "k7": k7}


def mp_adanorm_phase(mp_obs, out_dir):
    """The AdaNorm motion planner (txt_reduce 'attn') behind the GT
    pipeline: phase 15 (4 counted requests, launches held at
    MP_PER_FORWARD; profile_mp_adanorm_forward.txt), card vs CPU
    trajectory logits, VARIANT_STEPS training steps at B = 32
    (MP_PER_STEP) and a step check on VARIANT_CHECK_SLICES slices
    (following at most MP_ADANORM_MAX_KINKS leaky-ReLU ties a slice)."""
    tag = "mp-adanorm"
    t0 = time.perf_counter()
    engine = MotionPlannerEngine(MP_CONFIG, cli_opts=MP_ADANORM_OPTS,
                                 device="cuda", seed=0)
    log(f"[{tag}] release-width AdaNorm motion planner built in "
        f"{time.perf_counter() - t0:.2f} s")
    out, row = mp_serving_phase(mp_pipeline(engine), mp_obs, out_dir,
                                "profile_mp_adanorm_forward.txt", tag)
    out["reference_max_diff"] = mp_reference_phase(engine, row, tag=tag)
    del engine
    torch.cuda.empty_cache()
    config = lambda *o: mp_config(*MP_ADANORM_OPTS, *o)  # noqa: E731
    trainer, batches, _ = build_trainer(config(), train_motion_planner.SPEC,
                                        device="cuda")
    host, _ = host_batches(batches, 1 + VARIANT_STEPS)
    out["training"], out["training_launches"] = training_phase(
        trainer, host[1:], None, MP_PER_STEP, None, tag)
    del trainer, batches
    torch.cuda.empty_cache()
    out["step_check"] = step_check_phase(
        host[0], config, compute_mp_loss, f"{tag}-step-check",
        VARIANT_CHECK_SLICES, MP_PER_STEP, MP_PER_STEP_REDRAW,
        MP_ADANORM_MAX_KINKS)
    return out


def variants_phase(observations):
    """One card forward of each other option against the CPU: an Actioner
    with ENSEMBLES shuffled members and the 'ens1' decode (the members'
    launches held at ENSEMBLE_PER_FORWARD; each member's logits card vs
    CPU with the same order permutations; the ens1 vote of the CPU's
    logits on the card bit-equal across two decodes and to the CPU's
    position), a CA policy
    with the pose and step tokens (TOKEN_OPTS) and one with heatmap_mlp,
    reduce attn and quat rotations (HEAD_OPTS): launches per forward held
    at PER_FORWARD, logits card vs CPU."""
    out = {}
    kw = dict(num_ensembles=ENSEMBLES, best_disc_pos="ens1")
    a = Actioner(CONFIG, cli_opts=CLI_OPTS, device="cuda", seed=0, **kw)
    cpu = cpu_copy(a, **kw)
    req = requests(observations)[0]
    a.rng = np.random.default_rng(3)
    a.predict(**req)                                        # warm-up
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    a.rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    action = a.predict(**req)["action"]
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(cuda_lib.LAUNCHES)
    for k, per in ENSEMBLE_PER_FORWARD.items():
        if launches[k] != per * ENSEMBLES:
            raise AssertionError(f"[variants] ensemble {k}: {launches[k]} "
                                 f"launches, expected {per} x {ENSEMBLES}")
    if action.shape != (8,) or not np.isfinite(action).all():
        raise AssertionError(f"[variants] ensemble action {action}")
    a.rng = np.random.default_rng(3)
    emb, pc_ft, _, _, ee = a._host_prep("close_jar", 0, observations[0],
                                        None)
    batch = a._batch([(pc_ft, emb, ee, 0)], 1, N=a.num_points)
    errs = []
    # the same members' seeds on both devices (order permutations come
    # from the members' host generators)
    a.ensemble_rng = np.random.default_rng(5)
    cpu.ensemble_rng = np.random.default_rng(5)
    with torch.inference_mode():
        for i, (rg, rc) in enumerate(zip(a._ensemble_rngs(),
                                         cpu._ensemble_rngs())):
            gpu = a.model(batch, rg)
            ref = cpu.model({k: v.cpu() for k, v in batch.items()}, rc)
            errs.append(logits_close(gpu, ref, ("pos", "rot", "open"),
                                     f"ensemble member {i} "))
            on_card = {k: v.cuda() for k, v in ref.items()
                       if torch.is_tensor(v)}
            vote = decode_actions(on_card, a.act_cfg)
            if not torch.equal(vote, decode_actions(on_card, a.act_cfg)):
                raise AssertionError(f"[variants] ensemble member {i}: two "
                                     "decodes of the same logits differ")
            # the vote's position (the quaternion's sines and cosines
            # round differently on the two devices)
            want = decode_actions(ref, cpu.act_cfg)[:, :3]
            if not torch.equal(vote[:, :3].cpu(), want):
                raise AssertionError(f"[variants] ensemble member {i}: the "
                                     f"ens1 vote {vote[:, :3].tolist()} on "
                                     f"the card, {want.tolist()} on the CPU")
    out["ensemble"] = {"predict_ms": ms, "launches": launches,
                       "member_logit_diffs": errs,
                       "action": action.tolist()}
    log(f"[variants] {ENSEMBLES} shuffled members, ens1: predict "
        f"{ms:.2f} ms, launches {launches}; card vs CPU logits per member "
        f"{errs}; the vote bit-equal across launches and devices")
    del a, cpu
    for name, opts in (("tokens", TOKEN_OPTS), ("head", HEAD_OPTS)):
        cli = CLI_OPTS + opts
        a = Actioner(CONFIG, cli_opts=cli, device="cuda", seed=0)
        a.rng = np.random.default_rng(3)
        cuda_lib.reset_launches()
        action = a.predict(**dict(req, step_id=3))["action"]
        launches = dict(cuda_lib.LAUNCHES)
        if {k: launches[k] for k in PER_FORWARD} != PER_FORWARD or \
                not np.isfinite(action).all():
            raise AssertionError(f"[variants] {name}: launches {launches}, "
                                 f"action {action}")
        out[name] = {"launches": launches, "reference_max_diff":
                     reference_phase(a, observations[0], tag=f"variants "
                                     f"{name}", cli_opts=cli, step_id=3)}
        del a
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ neighbour-map builds ----

# ----------------------------------------------- attention options -----

# the options' launch counts at bf16 (BF16_ATTN_OPTS): the bf16 _opts
# kernels stand in for the bf16 K1, K5, K6; with upcast_attention q and k
# are fp32 after the norms (the JAX XLA path), so K1 is the fp32 _opts one
# on its mixed route (the probabilities rounded to bf16), counted with it
BF16_ATTN_OPTS_PER_FORWARD = dict(BF16_PER_FORWARD, patch_attention_bf16=0,
                                  patch_attention_opts_bf16=9)
UPCAST_PER_FORWARD = dict(BF16_PER_FORWARD, patch_attention_bf16=0,
                          patch_attention_opts=9)
_BF16_OPT_STEP = dict(patch_attention_dropout_bf16=0,
                      patch_attention_dropout_bwd_bf16=0,
                      patch_attention_dropout_opts_bf16=9,
                      patch_attention_dropout_bwd_opts_bf16=9)
BF16_ATTN_OPTS_PER_STEP = dict(BF16_PER_STEP, **_BF16_OPT_STEP)
# the biases of the Dense layers in front of a batch norm (a pooling's proj,
# before its segment max and norm; an unpooling's two projections): their
# gradient is zero up to rounding, at bf16 0.25-0.66 of itself apart
# between the card and the CPU on the options' step check
BIAS_BEFORE_NORM = (r"_down\.proj\.bias$", r"_up\.proj(_skip)?_fc\.bias$")
BF16_ATTN_OPTS_PER_STEP_REDRAW = dict(BF16_PER_STEP_REDRAW, **_BF16_OPT_STEP)
# the options' kernels by counter: the run that is their main path
OPT_MAIN_PATHS = {
    "patch_attention_opts": "attn_opts_serving",
    "patch_attention_dropout_opts": "attn_opts_training",
    "patch_attention_dropout_bwd_opts": "attn_opts_training",
    "patch_attention_opts_bf16": "bf16_attn_opts_serving",
    "patch_attention_dropout_opts_bf16": "bf16_attn_opts_training",
    "patch_attention_dropout_bwd_opts_bf16": "bf16_attn_opts_training"}


def _opt_nbytes(q, kv, head_scale, rpe):
    """The options' own input bytes: key mask, head scales, the grid
    coordinates and the table."""
    n = kv.numel()
    if head_scale is not None:
        n += 4 * head_scale.numel()
    if rpe is not None:
        n += 4 * (rpe[0].numel() + rpe[1].numel())
    return n


def _library_attention(q, k, v, kv, scale, head_scale, rpe):
    """The library yardstick of an options call: (bias build, SDPA) with
    the bias materialised as a float attn_mask (-1e9 at masked keys) and
    q times the head scale at scale 1 (scale under the bias alone)."""
    G, H, P, _ = q.shape

    def build():
        bias = attention._rpe_logit_bias(rpe) if rpe is not None else \
            torch.zeros(G, H, P, P, device=q.device)
        return torch.where(kv[:, None, None, :], bias,
                           torch.full_like(bias, attention.NEG_INF)).to(
                               q.dtype)
    mask = build()
    qs = q if head_scale is None else \
        (q.float() * head_scale[None, :, None, None]).to(q.dtype)
    sc = 1.0 if head_scale is not None else scale
    return build, mask, qs, sc


def check_opts_k1(args, timed=True):
    """One captured K1 call with the options (head_scale, rpe): bit-equal
    across two launches, within 1e-4 * max(1, |plain|) of the plain
    version at fp32, within the bf16 bar plus the probabilities' allowance
    at bf16; if `timed`, event and profiler times beside the plain
    version's, the library SDPA's (the bias materialised as its mask; its
    build timed apart) and the bound (bytes at 3.35 TB/s against 3x the
    flops at the TF32 rate at fp32, the flops at the bf16 rate at bf16)."""
    q, k, v, kv, scale, hs, rpe = args
    G, H, P, Dh = q.shape
    shape = [G, H, P, Dh]
    bf = q.dtype == torch.bfloat16
    run = lambda: attention.patch_attention(  # noqa: E731
        q, k, v, kv, scale, hs, rpe)
    plain = lambda: attention.patch_attention_plain(  # noqa: E731
        q, k, v, kv, scale, hs, rpe)
    got = _twice(run, f"K1 options {shape}")
    want = plain()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale_ref = max(1.0, float(want.float().abs().max()))
    if bf:
        excess = bf16_excess(got, want, extra=(
            attention.bf16_probability_allowance(
                q, k, v, kv, scale, head_scale=hs, rpe=rpe)))
        if not bool(torch.isfinite(got).all()) or excess > 0:
            raise AssertionError(f"bf16 K1 options {shape}: {err}, {excess} "
                                 "past the bf16 bar")
    elif not bool(torch.isfinite(got).all()) or err > TOL * scale_ref:
        raise AssertionError(f"K1 options {shape}: max |kernel - plain| = "
                             f"{err} > {TOL} * {scale_ref}")
    out = {"shape": shape, "max_abs_err": err, "max_rel_err": err / scale_ref}
    if not timed:
        return out
    build, mask, qs, sc = _library_attention(q, k, v, kv, scale, hs, rpe)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, k, v, attn_mask=mask, scale=sc)
    nbytes = 4 * q.element_size() * q.numel() + _opt_nbytes(q, kv, hs, rpe)
    flops = 4 * G * H * P * P * Dh
    bound_ms, t_b, t_f = (_bound(nbytes, flops, BF16_FLOPS_PER_S) if bf else
                          _bound(nbytes, 3 * flops, TF32_FLOPS_PER_S))
    out.update(ms=cuda_ms(run), device_ms=device_ms(run, K1_PROFILE[0]),
               plain_ms=cuda_ms(plain, **TRAIN_TIMING),
               library_ms=cuda_ms(library, **TRAIN_TIMING),
               bias_build_ms=cuda_ms(build, **TRAIN_TIMING),
               bound_ms=bound_ms, bytes_s=t_b, flops_s=t_f)
    return out


def check_opts_train(call, timed=True):
    """K5 and K6 with the options on one captured training call (its
    inputs and the cotangent of its output): K5's (out, lse, bits) and
    K6's (dq, dk, dv, dtable, dhead_scale) each bit-equal across two
    launches (K6 sums its per-patch partials in a fixed order), K5's bits
    equal to philox_keep_mask, the rest against the plain versions: at
    fp32 within 1e-4 * max(1, |plain|) (out), 1e-4 of the lse and of each
    gradient's own scale; at bf16 out within the bf16 bar plus the dropped
    probabilities' allowance, dq, dk, dv within the bf16 bar of their own
    scale, lse and the options' gradients (fp32) within 1e-4. If `timed`:
    K5 and K6 beside the plain versions and SDPA forward (dropout_p, the
    bias as its mask) and backward. Returns the two rows and the calls
    (K5's, K6's) for queued-event timing."""
    (q, k, v, kv, scale, rate, seed, hs, rpe), g = call
    G, H, P, Dh = q.shape
    shape = [G, H, P, Dh]
    bf = q.dtype == torch.bfloat16
    opts = dict(head_scale=hs, rpe=rpe)
    run5 = lambda: attention.patch_attention_dropout_fwd(  # noqa: E731
        q, k, v, kv, scale, rate, seed, **opts)
    plain5 = lambda: attention.patch_attention_dropout_fwd_plain(  # noqa
        q, k, v, kv, scale, rate, seed, **opts)
    (out, lse, bits), again = run5(), run5()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((out, lse, bits), again)):
        raise AssertionError(f"K5 options {shape}: two launches differ")
    del again
    keep = attention.philox_keep_mask(seed, G, H, P, rate, q.device)
    if not torch.equal(bits, attention.pack_keep_bits(keep)):
        raise AssertionError(f"K5 options {shape}: bits differ from "
                             "philox_keep_mask")
    p_out, p_lse, _ = plain5()
    live = kv.any(-1)
    e_lse = _err(lse[live], p_lse[live], f"K5 options lse {shape}")
    if bf:
        e5 = _bf16_err(out, p_out, f"bf16 K5 options out {shape}",
                       attention.bf16_probability_allowance(
                           q, k, v, kv, scale, rate, keep, **opts),
                       relative=False)
    else:
        e5 = _err(out, p_out, f"K5 options out {shape}")
    del keep, p_out, p_lse
    run6 = lambda: attention.patch_attention_dropout_bwd(  # noqa: E731
        q, k, v, kv, out, lse, bits, g, scale, rate, **opts)
    plain6 = lambda: attention.patch_attention_dropout_bwd_plain(  # noqa
        q, k, v, kv, out, lse, bits, g, scale, rate, **opts)
    got, again = run6(), run6()
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "dtable", "dhead_scale")
    e6, e_opt = 0.0, 0.0
    for a, b, c, n in zip(got, again, plain6(), names):
        if a is None:
            continue
        if not torch.equal(a, b):
            raise AssertionError(f"K6 options {n} {shape}: two launches "
                                 "differ")
        if a.dtype == torch.bfloat16:
            e6 = max(e6, _bf16_err(a, c.to(a.dtype),
                                   f"bf16 K6 options {n} {shape}"))
        else:
            e = _err(a, c, f"K6 options {n} {shape}")
            if n in ("dtable", "dhead_scale"):
                e_opt = max(e_opt, e)
            else:
                e6 = max(e6, e)
    del again
    r5 = {"max_abs_err": e5, "lse_err": e_lse, "shape": shape}
    r6 = {"max_abs_err": e6, "opt_grads_err": e_opt, "shape": shape}
    runs = (lambda: run5()[0], run6)
    if not timed:
        return r5, r6, runs
    build, mask, qs, sc = _library_attention(q, k, v, kv, scale, hs, rpe)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, k, v, attn_mask=mask, dropout_p=rate, scale=sc)
    qg, kg, vg = (t.clone().requires_grad_() for t in (qs, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                              dropout_p=rate, scale=sc)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, (qg, kg, vg), g, retain_graph=True)
    qb = q.element_size() * q.numel()
    side = 4 * (lse.numel() + bits.numel()) + _opt_nbytes(q, kv, hs, rpe)
    parts = sum(4 * t.numel() for t in got[3:] if t is not None) * G
    flops = 2 * G * H * P * P * Dh                            # one product

    def timed(run, plain, library, nbytes, products, name):
        """Events (TRAIN_TIMING) and profiler times; the plain version
        once (PLAIN_TIMING: it takes 0.1-0.7 s a step); the bound: the
        bytes at 3.35 TB/s against the products' flops at the bf16 rate,
        or 3x them at the TF32 rate (3xTF32)."""
        bound_ms, t_b, t_f = (
            _bound(nbytes, products * flops, BF16_FLOPS_PER_S) if bf else
            _bound(nbytes, 3 * products * flops, TF32_FLOPS_PER_S))
        return {"ms": cuda_ms(run, **TRAIN_TIMING),
                "device_ms": device_ms(run, name, reps=4),
                "plain_ms": cuda_ms(plain, **PLAIN_TIMING),
                "library_ms": cuda_ms(library, **TRAIN_TIMING),
                "bound_ms": bound_ms, "bytes_s": t_b, "flops_s": t_f}
    r5.update(timed(lambda: run5()[0], plain5, sdpa, 4 * qb + side, 2,
                    "attn_drop_fwd"))
    r6.update(timed(run6, plain6, sdpa_bwd, 8 * qb + side + parts, 5,
                    "attn_drop_bwd"))
    r5["philox_s"] = _philox_s(G, H, P, rate)
    r5["flops_s"] = max(r5["flops_s"], r5["philox_s"])
    r5["bound_ms"] = 1e3 * max(r5["bytes_s"], r5["flops_s"])
    r5["bias_build_ms"] = cuda_ms(build, **PLAIN_TIMING)
    return r5, r6, runs


def _opts_rows(results, tag, name):
    """A kernels-line row summed over one forward's or one step's calls."""
    row = dict(_row(results), calls=len(results),
               device_ms=_total(r["device_ms"] for r in results))
    if "bias_build_ms" in results[0]:
        row["bias_build_ms"] = sum(r["bias_build_ms"] for r in results)
    if "opt_grads_err" in results[0]:
        row["opt_grads_err"] = max(r["opt_grads_err"] for r in results)
    log(f"[{tag}] {name}: {len(results)} calls, max_abs_err "
        f"{row['max_abs_err']:.3g}, {row['ms']:.4f} ms (device "
        f"{row['device_ms']}; plain {row['plain_ms']:.4f}, library "
        f"{row['library_ms']}, bias build {row.get('bias_build_ms')}; bound "
        f"{row['bound_ms']:.4f} by {row['bound_by']})")
    return row


def _heads_vs_cpu(actioner, obs, cli, tol, tag):
    """The card's heads for one observation against the same weights on
    the CPU port, within tol * max(1, |ref|) (1e-3 at fp32, BF16_CPU_TOL
    at bf16)."""
    actioner.rng = np.random.default_rng(3)
    emb, pc_ft, _, _, ee = actioner._host_prep("close_jar", 0, obs, None)
    batch = actioner._batch([(pc_ft, emb, ee, 0)], 1)
    cpu = cpu_copy(actioner, cli).model
    with torch.inference_mode():
        got = actioner.model(batch)
        ref = cpu({k: v.cpu() for k, v in batch.items()})
    errs = _heads_vs({k: got[k].cpu() for k in ("pos", "rot", "open")}, ref,
                     ("pos", "rot", "open"), tol, f"{tag} card vs CPU ")
    log(f"[{tag}] card vs CPU heads, max |diff| (bar {tol} x max(1, "
        f"|ref|)): {errs}")
    return errs


def attn_opts_phase(tag, opts, per_forward, per_step, per_step_redraw,
                    observations, host=None, upcast=None):
    """The release policy with the attention options `opts` at the release
    width, seeded weights: a captured predict's K1 calls (the _opts
    kernel) each against its plain version and timed; 4 requests and a
    predict_batch with launches held at per_forward (its actions equal
    the sequential ones), their p50 and peak memory; card vs CPU heads;
    VARIANT_STEPS training steps at B = 32 with launches held at per_step
    (step p50, peak memory), one step captured and its K5 / K6 calls
    checked and timed (check_opts_train), their options' gradients
    included; K6's blocks an SM (2 at every head dim); the step check on
    VARIANT_CHECK_SLICES slices (and the redrawn one), the CPU following
    the card's max decisions (every gradient held on every slice). With
    `upcast` (bf16): one more predict with upcast_attention (its launches
    held at UPCAST_PER_FORWARD) and one with upcast_attention alone (the
    bf16 release K1, BF16_PER_FORWARD), each card vs CPU. `host`: host
    batches to reuse (made here otherwise)."""
    bf = "bfloat16" in opts
    t0 = time.perf_counter()
    cli = CLI_OPTS + opts
    actioner = Actioner(CONFIG, cli_opts=cli, device="cuda", seed=0)
    log(f"[{tag}] release-width Actioner ({opts}) built in "
        f"{time.perf_counter() - t0:.2f} s")
    actioner.rng = np.random.default_rng(0)
    k1 = capture_main_path(
        lambda: actioner.predict(**requests(observations)[0]))[
            "patch_attention"]
    if len(k1) != 9 or any(len(c) != 7 or c[5] is None or c[6] is None
                           for c in k1):
        raise AssertionError(f"[{tag}] captured K1 calls without the "
                             "options")
    k1_res = [check_opts_k1(c) for c in k1]
    name = "patch_attention_opts" + ("_bf16" if bf else "")
    for r in k1_res:
        log(f"[{tag}] K1 options call {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3g}; {r['ms']:.4f} ms (device "
            f"{r['device_ms']}; plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bias build {r['bias_build_ms']:.4f}; "
            f"bound {r['bound_ms']:.4f})")
    rows = {name: _opts_rows(k1_res, tag, f"{name} per B = 1 forward")}
    _queued_fallback(rows[name], [lambda c=c: attention.patch_attention(*c)
                                  for c in k1], tag, name)
    del k1
    out = {"serving": serving_phase(actioner, observations, per_forward,
                                    tag)}
    out["reference_max_diff"] = _heads_vs_cpu(
        actioner, observations[0], cli, BF16_CPU_TOL if bf else 1e-3, tag)
    del actioner
    torch.cuda.empty_cache()
    if upcast:
        up = Actioner(CONFIG, cli_opts=cli + upcast, device="cuda", seed=0)
        launches = _launches_of(lambda: up.predict(
            **requests(observations)[0]))
        _held(launches, UPCAST_PER_FORWARD, 1, f"[{tag}] upcast")
        out["upcast"] = {"launches": launches,
                         "reference_max_diff": _heads_vs_cpu(
                             up, observations[0], cli + upcast,
                             BF16_CPU_TOL, f"{tag} upcast")}
        del up
        # upcast_attention alone: q and k back to bf16 after the norms,
        # the bf16 release K1
        cli_up = CLI_OPTS + BF16_OPTS + upcast
        up = Actioner(CONFIG, cli_opts=cli_up, device="cuda", seed=0)
        launches = _launches_of(lambda: up.predict(
            **requests(observations)[0]))
        _held(launches, BF16_PER_FORWARD, 1, f"[{tag}] upcast alone")
        out["upcast_alone"] = {"launches": launches,
                               "reference_max_diff": _heads_vs_cpu(
                                   up, observations[0], cli_up,
                                   BF16_CPU_TOL, f"{tag} upcast alone")}
        del up
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    config = lambda *o: train_config(*opts, *o)  # noqa: E731
    trainer, batches, _ = build_trainer(config(), SPEC, device="cuda")
    if host is None:
        host, _ = host_batches(batches, 1 + VARIANT_STEPS)
    elif hasattr(batches, "close"):
        batches.close()
    log(f"[{tag}] trainer built in {time.perf_counter() - t0:.1f} s")
    captured = capture(lambda: trainer.step(batch_to_device(host[0], "cuda")),
                       [(layers, "patch_attention_dropout", "attention")])
    att = captured["attention"]
    if len(att) != 9 or any(g is None for _, g in att):
        raise AssertionError(f"[{tag}] captured {len(att)} attention calls")
    res = [check_opts_train(c) for c in att]
    del captured, att
    sfx = "_bf16" if bf else ""
    for i, kname in enumerate(("patch_attention_dropout_opts" + sfx,
                               "patch_attention_dropout_bwd_opts" + sfx)):
        rows[kname] = _opts_rows([r[i] for r in res], tag,
                                 f"{kname} per B = 32 step")
        _queued_fallback(rows[kname], [r[2][i] for r in res], tag, kname)
    del res
    torch.cuda.empty_cache()
    dtype = torch.bfloat16 if bf else torch.float32
    blocks = {Dh: attention.bwd_opts_blocks_per_sm(dtype, Dh)
              for Dh in attention.KERNEL_HEAD_DIMS}
    log(f"[{tag}] K6 with the options: blocks an SM by head dim {blocks} "
        "(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    if set(blocks.values()) != {2}:
        raise AssertionError(f"[{tag}] K6 with the options holds {blocks} "
                             "blocks an SM, not 2")
    out["k6_blocks_per_sm"] = blocks
    out["training"], out["training_launches"] = training_phase(
        trainer, host[1:], None, per_step, None, tag)
    del trainer, batches
    torch.cuda.empty_cache()
    # the CPU follows the card's max decisions: scaled cosine attention at
    # its initial temperature (logits q.k / |q||k| x 10) leaves stage 0's
    # outputs near-equal within a patch, and the first grid pooling's
    # maxima tie within rounding at ~4,200 of 2.0M decisions a slice (the
    # release model: 0-2), so no slice would hold stage 0's gradients
    # at bf16 the biases in front of a batch norm (the poolings' and
    # unpoolings' projections) have gradients that are zero up to
    # rounding, held with the rest to the L2 bar (BIAS_BEFORE_NORM)
    check = dict(tols=BF16_STEP_TOLS, order_kernels=BF16_ORDER_KERNELS,
                 kink_tol=BF16_KINK_TOL, kink_limit=BF16_MAX_KINKS,
                 follow_maxes=True, zero_grads=BIAS_BEFORE_NORM) if bf \
        else dict(follow_maxes=True)
    out["step_check"] = step_check_phase(
        host[0], config, compute_loss, f"{tag}-step-check",
        VARIANT_CHECK_SLICES, per_step, per_step_redraw, **check)
    out["kernels"] = rows
    return out, host


def nmap_phase(run, units, tag):
    """The device time and the host syncs of build_neighbor_map (the stem's
    and each stage's CPE map, built on the card in every forward) over
    `units` calls of `run` (a training step or a forward): each build in
    a profiler range (the device time of the kernels its ops launch)
    between two CUDA events
    (its start to end on the stream, host gaps included) and, in one
    unprofiled call, under torch.cuda's sync debug mode (the syncs it
    causes: the out-of-extent test reads a scalar back)."""
    import warnings
    from torch.profiler import ProfilerActivity, profile, record_function
    real = ptv3_mod.build_neighbor_map
    seq = [0]
    syncs = collections.Counter()
    spans = []

    def label(kernel_size):
        name = (f"stem k={kernel_size}" if seq[0] == 0
                else f"stage {seq[0] - 1} k={kernel_size}")
        seq[0] += 1
        return name

    def profiled(grid_coord, mask, kernel_size, depth, extent=None):
        name = label(kernel_size)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with record_function(f"nmap/{name}"):
            s.record()
            out = real(grid_coord, mask, kernel_size, depth, extent)
            e.record()
        spans.append((name, s, e))
        return out

    def counted(grid_coord, mask, kernel_size, depth, extent=None):
        name = label(kernel_size)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                out = real(grid_coord, mask, kernel_size, depth, extent)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs[name] += sum("synchroniz" in str(x.message) for x in w)
        return out

    try:
        ptv3_mod.build_neighbor_map = counted
        seq[0] = 0
        run()
        torch.cuda.synchronize()
        ptv3_mod.build_neighbor_map = profiled
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(units):
                seq[0] = 0
                run()
            torch.cuda.synchronize()
    finally:
        ptv3_mod.build_neighbor_map = real
    # the range's own device-side annotation spans its first kernel to its
    # last, gaps included: sum the kernels of the ops inside it instead
    ms, ranged = collections.defaultdict(float), collections.defaultdict(float)
    for e in prof.events():
        if e.name.startswith("nmap/") and \
                str(e.device_type).endswith("CPU"):
            ms[e.name[5:]] += sum(c.device_time_total
                                  for c in e.cpu_children) / 1e3 / units
            ranged[e.name[5:]] += e.device_time_total / 1e3 / units
    stream = collections.defaultdict(float)
    for name, s, e in spans:
        stream[name] += s.elapsed_time(e) / units
    out = {"device_ms": dict(ms), "device_ms_total": sum(ms.values()),
           "stream_ms": dict(stream), "stream_ms_total": sum(stream.values()),
           "range_device_ms_total": sum(ranged.values()),
           "host_syncs": dict(syncs),
           "host_syncs_total": sum(syncs.values())}
    log(f"[{tag}] build_neighbor_map per unit: device ms "
        f"{ {k: round(v, 4) for k, v in ms.items()} } (total "
        f"{out['device_ms_total']:.4f} ms; the ranges' own "
        f"{out['range_device_ms_total']:.4f}; start to end on the stream "
        f"{out['stream_ms_total']:.4f} ms); host syncs "
        f"{dict(syncs)} (total {out['host_syncs_total']})")
    return out


# -------------------------------------------- the released 3D-LOTUS++ -----

RP_CONFIG = os.path.join(os.path.dirname(CONFIG), "robot_pipeline.yaml")
# the scripted scene's names: the taskvar's object and target
RP_NAMES = {OBJECT_ID: "red cube", TARGET_ID: "green square"}
# a grasp, a move of the grasped object, a release, then past the end:
# the restart (the pipeline config's restart: True) runs plan 0 again
RP_PLAN = (f"# taskvar: {TASKVAR}\n"
           "# query: push the block until it is sitting on top of the "
           "green target.\n"
           'cube = grasp(object="red cube")\n'
           'move_grasped_object(target="green square")\n'
           "release()\n")
RP_SCHEDULE = [0, 0, 1, 1, 2, 3, 0]   # plan pointer before each request
RP_EPISODES = 3
RP_LLM_REQUESTS = 3


class _ScriptedChat:
    """A chat backend that answers every plan request with the
    ground-truth plan's code."""

    def __init__(self, plan_text):
        self.calls = 0
        self.code = "\n".join(x for x in plan_text.splitlines()
                              if not x.startswith("# taskvar"))

    def __call__(self, messages, temperature=0.0):
        self.calls += 1
        return self.code


def _rp_backends(backend):
    return {"det": Owlv2ObjectDetector(backend=backend),
            "sam": SAMSegmentor(backend=backend)}


def rp_vlm_phase(engine, mp_obs, out_dir, tag="rp-vlm"):
    """The released 3D-LOTUS++ (robot_pipeline.yaml: VLM grounding) on the
    card around the release-width motion planner `engine`, with the
    scripted OWLv2 / SAM backends of eval/synthetic_obs.py on the
    mp-serving observations: RP_EPISODES episodes of RP_SCHEDULE
    (the plan pointer scripted, since the seeded weights' stop bit fires
    at random), launches counted and held at MP_PER_FORWARD per
    motion-planner forward; the first request's objects and motion-planner
    input equal a CPU pipeline's on the same observation, its logits
    within mp-serving's bar and its action too; then one episode through
    LLMTaskPlanner with a scripted chat backend."""
    with open(RP_CONFIG) as f:
        cfg = yaml.safe_load(f)
    plan_file = os.path.join(out_dir, "rp_vlm_plan.txt")
    with open(plan_file, "w") as f:
        f.write(RP_PLAN)
    cfg["llm_planner"]["gt_plan_file"] = plan_file
    backend = ScriptedVLMBackend(RP_NAMES)
    for o in mp_obs:
        backend.register(o)
    pipe = serving.build_pipeline(cfg, device="cuda", motion_planner=engine,
                                  **_rp_backends(backend))
    vlm = pipe.vlm_pipeline
    host_ms = collections.defaultdict(list)

    def timed(obj, name, key):
        fn = getattr(obj, name)

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host_ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(obj, name, wrapper)
    for name in ("clean_det_bboxes", "merge_multiview_objects", "run"):
        timed(vlm, name, name)
    timed(engine, "predict", "predict")
    inputs = []
    real_prep = pipe.prepare_motion_planner_input

    def prep(*a, **kw):
        out = real_prep(*a, **kw)
        inputs.append(out[0])
        return out
    pipe.prepare_motion_planner_input = prep
    task, var = TASKVAR.split("+")
    lat, actions, first = [], [], None
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    for ep in range(RP_EPISODES):
        cache = None
        for i, plan_id in enumerate(RP_SCHEDULE):
            if cache is not None:
                cache["highlevel_step_id"] = plan_id
            o = mp_obs[(ep + i) % len(mp_obs)]
            t0 = time.perf_counter()
            out = pipe.predict(task_str=task, variation=int(var), step_id=i,
                               obs_state_dict=o, episode_id=ep, cache=cache)
            lat.append((time.perf_counter() - t0) * 1e3)
            cache = out["cache"]
            a = np.asarray(out["action"])
            if a.shape != (8,) or not np.isfinite(a).all():
                raise AssertionError(f"[{tag}] request {len(lat)}: bad "
                                     f"action {a}")
            if plan_id == 2 and a[7] != 1:
                raise AssertionError(f"[{tag}] release did not open: {a}")
            if first is None:
                first = (a, vlm.cache["objects"], inputs[0])
            actions.append(a.tolist())
    launches = dict(cuda_lib.LAUNCHES)
    forwards = len(host_ms["predict"])
    if forwards != RP_EPISODES * sum(p != 2 for p in RP_SCHEDULE):
        raise AssertionError(f"[{tag}] {forwards} motion-planner forwards")
    for k, per in MP_PER_FORWARD.items():
        if launches[k] != per * forwards:
            raise AssertionError(f"[{tag}] {k}: {launches[k]} launches in "
                                 f"{forwards} forwards, expected {per} each")
    for k in ("patch_attention", "subm_conv", "gather_rows",
              "gather_rows_smallc"):
        if not launches[k]:
            raise AssertionError(f"[{tag}] {k} never launched")
    clean_merge = [c + m for c, m in zip(host_ms["clean_det_bboxes"],
                                         host_ms["merge_multiview_objects"])]
    out = {"requests": len(lat), "request_ms": lat,
           "request_p50_ms": float(np.median(lat)),
           "vlm_clean_merge_ms_p50": float(np.median(clean_merge)),
           "vlm_run_ms_p50": float(np.median(host_ms["run"])),
           "predict_ms_p50": float(np.median(host_ms["predict"])),
           "forwards": forwards, "launches": launches,
           "launches_per_request": {k: v / len(lat)
                                    for k, v in launches.items() if v},
           "objects_first": len(first[1]), "actions": actions}
    del engine.predict               # the class's again
    log(f"[{tag}] {len(lat)} requests over {RP_EPISODES} episodes "
        f"(releases and restarts among them): request p50 "
        f"{out['request_p50_ms']:.1f} ms; VLM host (clean + merge) p50 "
        f"{out['vlm_clean_merge_ms_p50']:.1f} ms (whole VLM run "
        f"{out['vlm_run_ms_p50']:.1f} ms); engine predict p50 "
        f"{out['predict_ms_p50']:.2f} ms; launches per request "
        f"{ {k: round(v, 3) for k, v in out['launches_per_request'].items()} }")

    # the first request again on the CPU: objects, input, logits, action
    cpu_engine = MotionPlannerEngine(MP_CONFIG, device="cpu", seed=0)
    cpu_engine.model.load_state_dict(
        {k: v.cpu() for k, v in engine.model.state_dict().items()})
    cpu_pipe = serving.build_pipeline(cfg, device="cpu",
                                      motion_planner=cpu_engine,
                                      **_rp_backends(backend))
    cpu_inputs = []
    real_cpu_prep = cpu_pipe.prepare_motion_planner_input

    def cpu_prep(*a, **kw):
        res = real_cpu_prep(*a, **kw)
        cpu_inputs.append(res[0])
        return res
    cpu_pipe.prepare_motion_planner_input = cpu_prep
    cpu_out = cpu_pipe.predict(task_str=task, variation=int(var), step_id=0,
                               obs_state_dict=mp_obs[0], episode_id=0)
    action, objects, inp = first
    cpu_objects = cpu_pipe.vlm_pipeline.cache["objects"]
    if len(objects) != len(cpu_objects) or any(
            a.captions != b.captions or a.view_ids != b.view_ids or
            not np.array_equal(a.pcd_xyz, b.pcd_xyz)
            for a, b in zip(objects, cpu_objects)):
        raise AssertionError(f"[{tag}] the card run's objects differ from "
                             "the CPU run's")
    for k, v in cpu_inputs[0].items():
        if not np.array_equal(np.asarray(inp[k]), np.asarray(v)):
            raise AssertionError(f"[{tag}] motion-planner input {k} differs "
                                 "from the CPU run's")
    plan = cpu_out["cache"]["highlevel_plans"][0]
    txt = pipe.text_embedder(_plan_action_name(plan))
    out["reference_max_diff"] = mp_reference_phase(
        engine, (inp, txt), cpu_engine.model, tag)
    diff = float(np.abs(action - cpu_out["action"]).max())
    bar = 1e-3 * max(1.0, float(np.abs(cpu_out["action"]).max()))
    out["action_max_diff"] = diff
    if diff > bar:
        raise AssertionError(f"[{tag}] card vs CPU action {action} vs "
                             f"{cpu_out['action']}: {diff} > {bar}")
    log(f"[{tag}] first request on the CPU: {len(cpu_objects)} objects and "
        f"the motion-planner input ({len(inp['pc_fts'])} points, labels "
        f"{np.bincount(inp['pc_labels'], minlength=4).tolist()}) equal; "
        f"action max |card - CPU| {diff:.3g} (bar {bar:.3g})")
    del cpu_pipe, cpu_engine

    # one episode with the LLM planner (a scripted chat backend)
    llm_cfg = copy.deepcopy(cfg)
    llm_cfg["llm_planner"]["use_groundtruth"] = False
    chat = _ScriptedChat(RP_PLAN)
    llm_pipe = serving.build_pipeline(
        llm_cfg, device="cuda", motion_planner=engine, llm_backend=chat,
        **_rp_backends(backend))
    instruction = RP_PLAN.splitlines()[1].split("# query: ")[1]
    cache, llm_actions = None, []
    for i in range(RP_LLM_REQUESTS):
        res = llm_pipe.predict(task_str=task, variation=int(var), step_id=i,
                               obs_state_dict=mp_obs[i % len(mp_obs)],
                               episode_id=0, instructions=[instruction],
                               cache=cache)
        cache = res["cache"]
        if not np.isfinite(res["action"]).all():
            raise AssertionError(f"[{tag}] LLM planner episode: bad action "
                                 f"{res['action']}")
        llm_actions.append(np.asarray(res["action"]).tolist())
    want = [parse_code(x) for x in RP_PLAN.splitlines()
            if x and not x.startswith("#")]
    if cache["highlevel_plans"] != want or chat.calls != 1:
        raise AssertionError(f"[{tag}] LLM planner: plans "
                             f"{cache['highlevel_plans']}, {chat.calls} "
                             "chat calls")
    out["llm_episode"] = {"requests": RP_LLM_REQUESTS,
                          "chat_calls": chat.calls, "actions": llm_actions}
    log(f"[{tag}] LLMTaskPlanner episode: {RP_LLM_REQUESTS} requests, "
        f"{chat.calls} chat call, plan {[p['action'] for p in want]}")
    return out


# --------------------------------------------------- the optimizer menu ---

OPTIM_STEPS = 7
OPTIM_ACCUM_STEPS = 4    # micro-steps at gradient_accumulation_steps 2
# rangerlars runs two Lookahead periods (2 x lookahead_k, 12 steps): its
# first sync only takes the slow weights (the JAX quirk), so the second,
# the last step, is the first that moves them and snaps the fast ones;
# the CPU check holds that step
# the policy's optimizers at full width: (name, accumulation, extra opts);
# warmup 2 so the updates run at the configured lr within a few steps
OPTIM_CASES = [(name, 1, []) for name in ("adam", "adamax", "radam",
                                          "ralamb", "rangerlars")] + \
    [("adamw", 2, []), ("radam", 2, BF16_OPTS)]
OPTIM_OPTS = ["TRAIN.warmup_steps", "2"]
UPDATE_ULPS = 4


def _optim_trainer(cfg, model, seed):
    act_cfg, loss_cfg = driver.task_configs(cfg)
    opt, _ = build_optimizer(model, dict(cfg.TRAIN))
    return Trainer(model,
                   lambda preds, b: SPEC.loss_fn(preds, b, act_cfg, loss_cfg),
                   opt, Randomness(seed, "cuda"))


def _update_vs_cpu(trainer, cfg, batch, cpu, tag):
    """One card step; the same gradients through a CPU copy of the
    optimizer (its state carried by opt_state_to_jax / opt_state_from_jax)
    from the same parameters, on the CPU model `cpu`. Each tensor's update
    |card - CPU| within TOL of the largest update plus UPDATE_ULPS fp32
    ulps of the tensor's largest |p|: each side rounds at |p|'s scale
    (Ralamb forms p_dec, the new p, new p - p and p + update; the others
    p + update), far inside the step check's TOL * max(1, |p|)."""
    model = trainer.model
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_opt, _ = build_optimizer(cpu, dict(cfg.TRAIN))
    opt_state_from_jax(opt_state_to_jax(trainer.optimizer, model), cpu_opt,
                       cpu)
    before = {n: p.detach().cpu().clone() for n, p in cpu.named_parameters()}
    losses = _losses(trainer.step(batch))
    named = dict(model.named_parameters())
    for n, p in cpu.named_parameters():
        g = named[n].grad
        p.grad = None if g is None else g.cpu()
    cpu_opt.step()
    card = {n: named[n].detach().cpu() - before[n] for n in before}
    ref = {n: p.detach() - before[n] for n, p in cpu.named_parameters()}
    scale = max(float(r.abs().max()) for r in ref.values())
    if not scale:
        raise AssertionError(f"[{tag}] the CPU update moved nothing")
    worst, over, name = 0.0, 0.0, None
    for n in ref:
        err = float((card[n] - ref[n]).abs().max())
        ulp = UPDATE_ULPS * float(np.spacing(np.float32(
            before[n].abs().max())))
        worst = max(worst, err)
        if err / (TOL * scale + ulp) > over:
            over, name = err / (TOL * scale + ulp), n
    if over > 1.0:
        raise AssertionError(f"[{tag}] card vs CPU update of {name}: "
                             f"{over} of its bar (largest update {scale})")
    return {"update_max_diff": worst, "update_scale": scale,
            "worst": name, "of_bar": over, "losses": losses}


def optim_phase(host, tag="optim"):
    """Each of OPTIM_CASES on the release-width policy at B = 32 x 4096
    (phase 7's host batches, release dropout): OPTIM_STEPS steps
    (OPTIM_ACCUM_STEPS micro-steps under accumulation, 2 x lookahead_k for
    rangerlars, the batches cycled), launches held at PER_STEP
    (BF16_PER_STEP at bf16) per step, finite losses, step p50 and the
    optimizer step's device ms (CUDA events around it); the last step
    held against the CPU's update of the same gradients (rangerlars': the
    sync that moves the slow weights)."""
    dev = [batch_to_device(b, "cuda") for b in host[1:1 + OPTIM_STEPS]]
    cpu = build_model(train_config().MODEL, device="cpu", seed=0)
    models, init = {}, None
    results = {}
    for name, accum, opts in OPTIM_CASES:
        bf16 = bool(opts)
        key = f"{name}-k{accum}" + ("-bf16" if bf16 else "")
        cfg = train_config(*OPTIM_OPTS, "TRAIN.optim", name,
                           "TRAIN.gradient_accumulation_steps", str(accum),
                           *opts)
        if bf16 not in models:     # one model a dtype, reset to its seed
            models[bf16] = build_model(cfg.MODEL, device="cuda", seed=2024)
            init = init or {k: v.clone() for k, v in
                            models[bf16].state_dict().items()}
        models[bf16].load_state_dict(init)
        trainer = _optim_trainer(cfg, models[bf16], 2024)
        opt = trainer.optimizer
        steps = (OPTIM_ACCUM_STEPS if accum > 1 else 2 * opt.k
                 if name == "rangerlars" else OPTIM_STEPS)
        events = []
        real_step = opt.step

        def timed_step(real_step=real_step, events=events):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            real_step()
            e.record()
            events.append((s, e))
        opt.step = timed_step
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        step_ms, losses = [], []
        for i in range(steps - 1):
            t0 = time.perf_counter()
            out = trainer.step(dev[i % len(dev)])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(_losses(out))
        launches = dict(cuda_lib.LAUNCHES)
        per_step = BF16_PER_STEP if bf16 else PER_STEP
        for k, per in per_step.items():
            if launches[k] != per * (steps - 1):
                raise AssertionError(f"[{tag}] {key} {k}: {launches[k]} "
                                     f"launches in {steps - 1} steps, "
                                     f"expected {per} per step")
        if name == "rangerlars" and not (opt.initialized and
                                         opt.count == steps - 1):
            raise AssertionError(f"[{tag}] {key}: {opt.count} updates, "
                                 f"synced {opt.initialized}: the check "
                                 f"would miss the second sync")
        check = _update_vs_cpu(trainer, cfg, dev[(steps - 1) % len(dev)],
                               cpu, f"{tag} {key}")
        losses.append(check.pop("losses"))
        update_ms = [s.elapsed_time(e) for s, e in events]
        emit = [update_ms[i] for i in range(len(update_ms))
                if (i + 1) % accum == 0]
        acc_only = [update_ms[i] for i in range(len(update_ms))
                    if (i + 1) % accum]
        res = {"steps": steps, "step_ms": step_ms,
               "step_ms_p50": float(np.median(step_ms)),
               "update_device_ms": update_ms,
               "update_device_ms_p50": float(np.median(emit)),
               "accumulate_device_ms_p50": (float(np.median(acc_only))
                                            if acc_only else None),
               "updates": opt.count, "losses": losses,
               "launches": launches,
               "launches_per_step": {k: launches[k] / (steps - 1)
                                     for k in launches if launches[k]},
               **check}
        results[key] = res
        log(f"[{tag}] {key}: {steps} steps, {opt.count} updates: step p50 "
            f"{res['step_ms_p50']:.1f} ms, optimizer step device ms p50 "
            f"{res['update_device_ms_p50']:.3f}"
            + (f" (accumulating micro-steps "
               f"{res['accumulate_device_ms_p50']:.3f})" if acc_only else "")
            + f"; card vs CPU update max |diff| {check['update_max_diff']:.3g}"
            f" of the largest update {check['update_scale']:.3g} ("
            f"{check['of_bar']:.3g} of the bar); losses "
            f"{[round(x['total'], 4) for x in losses]}")
        del trainer, opt, events
    del models, init
    torch.cuda.empty_cache()
    return results


def _marked_processes():
    """(pid, command line) of every live process but this one whose
    environment holds this run's RUN_MARK: every process the run started,
    orphans of a dead parent included."""
    mark = f"{RUN_MARK}={os.environ[RUN_MARK]}".encode()
    found = []
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/environ", "rb") as f:
                if mark not in f.read().split(b"\0"):
                    continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:  # gone, or not ours
            continue
        found.append((int(d), cmd.strip()[:200]))
    return found


def stop_processes(wait_s=30.0):
    """Stops what the run left: collects abandoned loader iterators (their
    worker pools shut down), stops multiprocessing's forkserver and
    resource tracker and waits for them to exit, then waits up to wait_s
    for every other marked process to end. Those still alive are killed
    and returned as (pid, command line)."""
    from multiprocessing import forkserver, resource_tracker
    gc.collect()
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    deadline = time.monotonic() + wait_s
    while (left := _marked_processes()) and time.monotonic() < deadline:
        time.sleep(0.1)
    for pid, _ in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return left


def main():
    if sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    os.environ[RUN_MARK] = f"{os.getpid()}.{time.time_ns()}"
    try:
        lines = run()
    except BaseException:     # shown before the processes are stopped
        traceback.print_exc()
        sys.stderr.flush()
        # the failed phases' frames hold loader iterators, whose worker
        # pools would outlive stop_processes' wait
        traceback.clear_frames(sys.exc_info()[2])
        gc.collect()
        raise
    finally:
        left = stop_processes()
    if left:
        raise AssertionError(f"processes left running (killed): {left}")
    for line in lines:
        print(line, flush=True)
    return 0


def run():
    """Every phase; the kernels line, the card's line and the last line,
    to be printed once the run's processes have ended."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()

    def mark(done):
        """The run's seconds so far, after the phases `done`."""
        log(f"[time] {time.perf_counter() - start:.1f} s after {done}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.library()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    native.get_lib()
    log(f"[build] native voxelizer {os.path.basename(native.build())} "
        f"built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, use in sorted(ptxas_usage().items()):
        m = re.search(r"\d((?:patch_attention|stem_conv|attn_drop|"
                      r"scatter_smallc|gather_smallc16|subm_conv|wgrad)"
                      r"\w*?_kernel)"
                      r"(?:ILi(\d+)E(x)?)?", name)
        # K9's bf16 kernel: one instance a C up to 32; C = 5 is the path's
        if m and not (m.group(1) == "gather_smallc16_kernel" and
                      m.group(2) != "5"):
            kind = ' bf16' if 'bfloat16' in name else ''
            if m.group(1) == "subm_conv16_kernel":   # bf16 W; x bf16 or fp32
                kind = (" bf16" if re.search(r"ILi\d+E13__nv_bfloat16E",
                                             name) else " fp32 x (dx)")
            opt = re.search(r"(?:Logit|Inline)OptsILb(\d)ELb(\d)E", name)
            tile = re.search(r"BiasTileOptsILb(\d)ELb(\d)E", name)
            if opt and opt.groups() != ("0", "0"):   # the options' kernels
                kind += " options " + "+".join(
                    w for w, b in zip(("scale", "rpe"), opt.groups())
                    if b == "1")
            elif tile:                               # K1 with the bias
                kind += (" options " + ("scale+" if tile.group(1) == "1"
                                        else "") + "rpe (bias tile)" +
                         (" mixed" if tile.group(2) == "1" else ""))
            log(f"[build] ptxas {m.group(1)}"
                f"{'<' + m.group(2) + '>' if m.group(2) else ''}"
                f"{' int64' if m.group(3) == 'x' else ''}{kind}: {use}")

    mark("build")
    t0 = time.perf_counter()
    actioner = Actioner(CONFIG, cli_opts=CLI_OPTS, device="cuda", seed=0)
    log(f"[serving] release-width Actioner built in "
        f"{time.perf_counter() - t0:.2f} s")
    observations = [synthetic_observation(100 + i) for i in range(4)]

    actioner.rng = np.random.default_rng(0)
    captured = capture_main_path(
        lambda: actioner.predict(**requests(observations)[0]))
    captured_batch = capture_main_path(
        lambda: actioner.predict_batch(requests(observations)))
    rows, detail = kernel_phase(captured, captured_batch)
    batch_order = {"policy": batch_order_phase(
        captured["stem_conv"], captured["subm_conv"], "batch-order")}
    serving = serving_phase(actioner, observations)
    actioner.rng = np.random.default_rng(0)
    serving["nmap"] = nmap_phase(
        lambda: actioner.predict(**requests(observations)[0]), 3,
        "serving nmap")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    breakdown = breakdown_phase(actioner, observations, out_dir)
    fused = fused_phase(actioner, observations, out_dir)
    ref = reference_phase(actioner, observations[0])
    bf16 = bf16_phase(actioner, observations, serving, breakdown, out_dir)
    del actioner
    mark("serving, breakdown, fused, reference, bf16")

    t0 = time.perf_counter()
    trainer, batches, _ = build_trainer(train_config(), SPEC, device="cuda")
    host, data_ms = host_batches(batches, 1 + TRAIN_STEPS + PROFILE_STEPS)
    log(f"[train-capture] trainer built and {len(host)} host batches of "
        f"{trainer_batch(host)} clouds made in "
        f"{time.perf_counter() - t0:.1f} s (host ms per batch: "
        f"{[round(t) for t in data_ms]})")
    captured = capture(lambda: trainer.step(batch_to_device(host[0], "cuda")),
                       TRAIN_SITES)
    training, train_launches = training_phase(trainer, host[1:], out_dir,
                                              nmap=True)
    training["host_batch_ms"] = data_ms
    del trainer
    train_rows, k4_step, k2_step, k3_step, train_detail = \
        train_kernel_phase(captured)
    rows["gather_rows"]["train_step"] = k4_step
    rows["subm_conv"]["train_step"] = k2_step
    rows["stem_conv"]["train_step"] = k3_step
    stems = [c for c in captured["stem_conv"] if c[1] is not None]
    stem_vjp, stem_launches = stem_vjp_phase(stems[0])
    bf16_stem_vjp, bf16_stem_launches = bf16_stem_vjp_phase(stems[0])
    tp_widths = tp_widths_phase(captured["subm_conv"])
    del captured, stems
    mark("training, train-kernels, stem-vjp, tp-widths")
    step_check = step_check_phase(host[0])
    mark("step-check")
    zero1_out, plain_ref = zero1_phase(host)
    mark("zero1")
    tp = tp_phase(host, plain_ref)
    del plain_ref
    torch.cuda.empty_cache()
    mark("tp")
    bf16_train = bf16_train_phase(host, training, observations, out_dir)
    mark("bf16-train")
    torch.cuda.empty_cache()
    optim = optim_phase(host)
    mark("optim")
    del host, batches
    torch.cuda.empty_cache()
    entry = entry_phases(train_simple_policy, train_config, ENTRY_STEPS,
                         PER_STEP, "entry", training["clouds_per_s"])
    mark("entry")
    lmdb = lmdb_phase(train_simple_policy, train_config, "synthetic_reach",
                      PER_STEP, "lmdb", keep=True)
    mark("lmdb")
    torch.cuda.empty_cache()

    def serve(actioner, cpu):
        res = {"serving": serving_phase(actioner, observations),
               "breakdown": breakdown_phase(actioner, observations, out_dir,
                                            "profile_forward_ckpt.txt",
                                            "ckpt")}
        res["reference_max_diff"] = reference_phase(
            actioner, observations[0], cpu, "ckpt")
        return res, res["breakdown"]

    ckpt = ckpt_phase(
        "ckpt", train_simple_policy, train_config_val,
        (CKPT_STEPS, CKPT_RESUME_STEPS), VAL_PER_FORWARD,
        lambda path, device: Actioner(CONFIG, checkpoint=path,
                                      cli_opts=CLI_OPTS, device=device,
                                      seed=0),
        serve, breakdown, out_dir,
        after=lambda run: {
            "eval_server": eval_server_phase(run, lmdb["root"], CKPT_STEPS),
            "http": http_phase(run, lmdb["root"], CKPT_STEPS)})
    mark("ckpt, eval-server, http")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = MotionPlannerEngine(MP_CONFIG, device="cuda", seed=0)
    pipe = mp_pipeline(engine)
    log(f"[mp-capture] release-width motion planner and GT pipeline built "
        f"in {time.perf_counter() - t0:.2f} s")
    mp_obs = [synthetic_observation(200 + i) for i in range(MP_REQUESTS)]
    mp_fwd_captured = capture(lambda: mp_episode(pipe, mp_obs[:1], 0),
                              SMALLC_SITES + MP_CONV_SITES)
    batch_order["motion_planner"] = batch_order_phase(
        [], [a for a, _ in mp_fwd_captured["subm_conv"]], "mp-batch-order")
    mp_fwd_k2 = mp_forward_k2(mp_fwd_captured.pop("subm_conv"))
    mp_serving, mp_row = mp_serving_phase(pipe, mp_obs, out_dir)
    mp_serving["reference_max_diff"] = mp_reference_phase(engine, mp_row)
    bf16_mp = bf16_mp_phase(engine, mp_obs, mp_serving, out_dir)
    mark("mp-serving, bf16-mp")
    rp_vlm = rp_vlm_phase(engine, mp_obs, out_dir)
    mark("rp-vlm")
    del engine, pipe
    torch.cuda.empty_cache()
    mp_train, mp_train_launches, mp_step_captured, mp_host = \
        mp_training(out_dir)
    mp_rows, mp_detail = mp_kernel_phase(mp_fwd_captured, mp_step_captured)
    mp_stem_call = mp_step_captured.pop("categorical_conv")[0]
    mp_stem_vjp, mp_stem_launches = mp_stem_vjp_phase(mp_stem_call)
    bf16_mp_stem_vjp, bf16_mp_stem_launches = bf16_mp_stem_vjp_phase(
        mp_stem_call)
    del mp_stem_call
    mp_k2, mp_k7, mp_detail["conv_step"] = mp_conv_phase(mp_step_captured)
    mp_detail["conv_forward"] = mp_fwd_k2
    del mp_fwd_captured, mp_step_captured
    torch.cuda.empty_cache()
    mark("mp-train, mp-kernels, mp-stem-vjp")
    mp_step_check = step_check_phase(mp_host[0], mp_config, compute_mp_loss,
                                     "mp-step-check", MP_CHECK_SLICES,
                                     MP_PER_STEP, MP_PER_STEP_REDRAW)
    mark("mp-step-check")
    bf16_mp_train = bf16_mp_train_phase(mp_host, mp_train, mp_obs, out_dir)
    mark("bf16-mp-train")
    del mp_host
    torch.cuda.empty_cache()
    mp_entry = entry_phases(train_motion_planner, mp_config, MP_ENTRY_STEPS,
                            MP_PER_STEP, "mp-entry", mp_train["clouds_per_s"])
    mark("mp-entry")
    mp_lmdb = lmdb_phase(train_motion_planner, mp_config, "synthetic_motion",
                         MP_PER_STEP, "mp-lmdb")
    mark("mp-lmdb")
    torch.cuda.empty_cache()

    def mp_serve(engine, cpu):
        res, row = mp_serving_phase(mp_pipeline(engine), mp_obs, out_dir,
                                    "profile_mp_forward_ckpt.txt", "mp-ckpt")
        return {"serving": res, "reference_max_diff": mp_reference_phase(
            engine, row, cpu, "mp-ckpt")}, res

    mp_ckpt = ckpt_phase(
        "mp-ckpt", train_motion_planner, mp_config_val,
        (MP_CKPT_STEPS, MP_CKPT_RESUME_STEPS), MP_PER_FORWARD,
        lambda path, device: MotionPlannerEngine(
            MP_CONFIG, checkpoint=path, device=device, seed=0),
        mp_serve, mp_serving, out_dir,
        after=lambda run: {"eval_server": mp_eval_server_phase(
            run, MP_CKPT_STEPS)})
    shutil.rmtree(os.path.join(ROOT, "build", "smoke_data"),
                  ignore_errors=True)
    mark("mp-ckpt, mp-eval-server")
    torch.cuda.empty_cache()

    adanorm, _ = policy_variant_phase(
        "adanorm", ADANORM_OPTS, ADANORM_PER_FORWARD, PER_STEP,
        PER_STEP_REDRAW, observations)
    concat, stem_calls = policy_variant_phase(
        "concat", CONCAT_OPTS, CONCAT_PER_FORWARD, CONCAT_PER_STEP,
        CONCAT_PER_STEP_REDRAW, observations, stem_calls=True)
    concat["stem"] = concat_stem_phase(stem_calls[0])
    del stem_calls
    torch.cuda.empty_cache()
    mp_adanorm = mp_adanorm_phase(mp_obs, out_dir)
    variants = variants_phase(observations)
    mark("adanorm, concat, mp-adanorm, variants")
    attn_opts, opt_host = attn_opts_phase(
        "attn-opts", ATTN_OPTS, ATTN_OPTS_PER_FORWARD, ATTN_OPTS_PER_STEP,
        ATTN_OPTS_PER_STEP_REDRAW, observations)
    bf16_attn_opts, _ = attn_opts_phase(
        "bf16-attn-opts", BF16_ATTN_OPTS, BF16_ATTN_OPTS_PER_FORWARD,
        BF16_ATTN_OPTS_PER_STEP, BF16_ATTN_OPTS_PER_STEP_REDRAW,
        observations, host=opt_host, upcast=UPCAST_OPTS)
    del opt_host
    torch.cuda.empty_cache()
    mark("attn-opts, bf16-attn-opts")

    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "kernels": rows, "calls": detail,
                   "serving": serving, "breakdown": breakdown,
                   "fused": fused, "lmdb": lmdb, "mp_lmdb": mp_lmdb,
                   "reference_max_diff": ref, "training": training,
                   "train_kernels": train_rows,
                   "train_calls": train_detail, "step_check": step_check,
                   "entry": entry, "mp_serving": mp_serving,
                   "mp_training": mp_train, "mp_kernels": mp_rows,
                   "mp_calls": mp_detail, "mp_step_check": mp_step_check,
                   "mp_entry": mp_entry, "stem_vjp": stem_vjp,
                   "mp_stem_vjp": mp_stem_vjp,
                   "bf16_stem_vjp": bf16_stem_vjp,
                   "bf16_mp_stem_vjp": bf16_mp_stem_vjp, "ckpt": ckpt,
                   "mp_ckpt": mp_ckpt, "adanorm": adanorm,
                   "concat": concat, "mp_adanorm": mp_adanorm,
                   "variants": variants, "bf16": bf16, "bf16_mp": bf16_mp,
                   "attn_opts": attn_opts, "bf16_attn_opts": bf16_attn_opts,
                   "bf16_train": bf16_train, "bf16_mp_train": bf16_mp_train,
                   "rp_vlm": rp_vlm, "optim": optim,
                   "batch_order": batch_order, "zero1": zero1_out,
                   "tp": tp, "tp_widths": tp_widths},
                  f, indent=1)
    # each kernel's launches in the run of its own slice's main path: K1-K4
    # policy serving, K5-K8 policy training, K9 motion-planner serving, K10
    # the stem conv's input gradient (stem-vjp; at bf16 bf16-stem-vjp);
    # launches_by_path has every run's count for every kernel
    rows.update(train_rows)
    rows.update(mp_rows)
    rows.update(bf16["kernels"])
    rows.update(bf16_mp["kernels"])
    rows.update(bf16_train["kernels"])
    rows.update(attn_opts.pop("kernels"))
    rows.update(bf16_attn_opts.pop("kernels"))
    for k, r in bf16_mp_train["kernels"].items():
        rows[k]["mp_train_step"] = r
    rows["subm_conv_bf16"]["concat_stem_b1"] = \
        bf16["variants"]["concat"]["stem_forward_b1"]
    for k, key, phase in (
            ("k3", "train_step", bf16_train), ("k4", "train_step",
                                               bf16_train),
            ("k4", "mp_train_step", bf16_mp_train),
            ("k9", "mp_train_step", bf16_mp_train)):
        name = {"k3": "stem_conv_bf16", "k4": "gather_rows_bf16",
                "k9": "gather_rows_smallc_bf16"}[k]
        if k in phase["forward_steps"]:
            rows[name][key] = phase["forward_steps"][k]
    for key, phase, fp32_calls in (
            ("train_step", bf16_train, train_detail["calls"]["subm_conv"]),
            ("mp_train_step", bf16_mp_train,
             mp_detail["conv_step"]["subm_conv"])):
        fwd = phase["k2_forward_step"]
        fwd32 = _total(r["device_ms"] for r in fp32_calls[0::2])
        fwd["fp32_forward_device_ms"] = fwd32
        fwd["vs_fp32_forward_device"] = (
            fwd["device_ms"] / fwd32 if fwd32 and fwd["device_ms"] else None)
        log(f"[bf16] K2 bf16 forward per {key}: device {fwd['device_ms']} "
            f"ms against the fp32 forward's {fwd32} in this run: "
            f"{fwd['vs_fp32_forward_device']}")
        rows["subm_conv_bf16"][key] = fwd
    rows["patch_attention"]["validation_b32"] = {
        k: v for k, v in ckpt["k1_b32"].items() if k != "calls"}
    rows["patch_attention"]["mp_validation_b32"] = {
        k: v for k, v in mp_ckpt["k1_b32"].items() if k != "calls"}
    rows["subm_conv"]["mp_train_step"] = mp_k2
    rows["conv_weight_grad"]["mp_train_step"] = mp_k7
    stem = concat["stem"]
    rows["subm_conv"]["concat_stem"] = {
        "forward_b1": concat["stem_forward_b1"],
        "forward_b32": stem["k2_forward"],
        "mirrored_dx_b32": stem["k2_mirrored_dx"]}
    rows["conv_weight_grad"]["concat_stem_b32"] = stem["k7"]
    k10 = stem_vjp["k10"]
    rows["scatter_rows_smallc_add"] = dict(
        _row([k10]), device_ms=k10["device_ms"], shape=k10["shape"],
        mp_train_step_stem=rows["scatter_rows_smallc_add"])
    k10, k10_mp = bf16_stem_vjp["k10"], bf16_mp_stem_vjp["k10"]
    rows["scatter_rows_smallc_add_bf16"] = dict(
        _row([k10]), device_ms=k10["device_ms"], shape=k10["shape"],
        library=k10["library"], mp_stem=dict(
            _row([k10_mp]), device_ms=k10_mp["device_ms"],
            shape=k10_mp["shape"]))
    paths = {"serving": serving["launches"], "training": train_launches,
             "mp_serving": mp_serving["launches"],
             "mp_training": mp_train_launches, "stem_vjp": stem_launches,
             "mp_stem_vjp": mp_stem_launches,
             "bf16_stem_vjp": bf16_stem_launches,
             "bf16_mp_stem_vjp": bf16_mp_stem_launches,
             "validation": ckpt["validation_launches"],
             "mp_validation": mp_ckpt["validation_launches"],
             "adanorm_serving": adanorm["serving"]["launches"],
             "adanorm_training": adanorm["training_launches"],
             "concat_serving": concat["serving"]["launches"],
             "concat_training": concat["training_launches"],
             "mp_adanorm_serving": mp_adanorm["launches"],
             "mp_adanorm_training": mp_adanorm["training_launches"],
             "ensemble_serving": variants["ensemble"]["launches"],
             "bf16_serving": bf16["serving"]["launches"],
             "bf16_mp_serving": bf16_mp["serving"]["launches"],
             "bf16_adanorm_serving": bf16["variants"]["adanorm"]["launches"],
             "bf16_concat_serving": bf16["variants"]["concat"]["launches"],
             "bf16_training": bf16_train["launches"],
             "bf16_mp_training": bf16_mp_train["launches"],
             "bf16_entry": bf16_train["entry"]["launches"],
             "bf16_mp_entry": bf16_mp_train["entry"]["launches"],
             "rp_vlm": rp_vlm["launches"],
             **{f"optim_{k}": r["launches"] for k, r in optim.items()},
             "attn_opts_serving": attn_opts["serving"]["launches"],
             "attn_opts_training": attn_opts["training_launches"],
             "bf16_attn_opts_serving": bf16_attn_opts["serving"]["launches"],
             "bf16_attn_opts_training": bf16_attn_opts["training_launches"],
             "bf16_upcast_serving": bf16_attn_opts["upcast"]["launches"],
             "tp_training": tp["processes"][0]["launches"],
             **{f"zero1_{k}": r["launches_per_step"]
                for k, r in zero1_out["runs"].items()}}
    main_path = dict.fromkeys(PER_FORWARD, "serving")
    main_path.update(dict.fromkeys(TRAIN_KERNELS, "training"))
    main_path.update(gather_rows_smallc="mp_serving",
                     scatter_rows_smallc_add="stem_vjp")
    main_path.update({k: "bf16_serving" for k in BF16_SITES.values()},
                     gather_rows_smallc_bf16="bf16_mp_serving")
    main_path.update(dict.fromkeys(BF16_TRAIN_KERNELS, "bf16_training"),
                     scatter_rows_smallc_add_bf16="bf16_stem_vjp")
    main_path.update(OPT_MAIN_PATHS)
    idle = [k for k in KERNELS if not paths[main_path[k]][k]]
    if idle:
        raise AssertionError(f"kernels that their main path never launched: "
                             f"{idle}")
    kernels = [dict(name=k, route="cuda", source=KERNELS[k][0],
                    replaces=KERNELS[k][1],
                    launches=paths[main_path[k]][k],
                    launches_by_path={p: c.get(k, 0)
                                      for p, c in paths.items()},
                    **rows[k])
               for k in KERNELS]
    return [json.dumps({"kernels": kernels}), smi,
            json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}})]


if __name__ == "__main__":
    sys.exit(main())
