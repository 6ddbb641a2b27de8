#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``iaf_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --multi           # phases 17(e) and 19(e)
                                            # alone (2+ cards)
    python3 chip_smoke.py --memory          # phase 19 alone
    python3 chip_smoke.py --loops           # phase 20 alone
    python3 chip_smoke.py --plans           # K1's forward on every
                                            # launch plan at six shapes
                                            # (``plans_only``)
    python3 chip_smoke.py --k2-plans        # K2's forward on both
                                            # launch plans, the three 5x5
                                            # convs at N = 1 to 1024, and
                                            # dgrad on both tiles
                                            # (``k2_plans_only``)
    python3 chip_smoke.py --glue            # phases 3(b) and 3(c) alone,
                                            # the paper and 5x5 configs
                                            # (``glue_only``)
    python3 chip_smoke.py --ab DIR [CASE] [PAIRS]
                                            # one kernel of DIR's tree
                                            # against this one's, A B B A
                                            # repeated to PAIRS pairs
                                            # (default 2)
                                            # (``ab``; CASE, or several
                                            # joined by commas, in AB_CASES:
                                            # k1_fwd, k1_fwd_f32,
                                            # k1_fwd_small,
                                            # k1_bwd_f32, f32_step,
                                            # f32_chunk, k2_fwd_f32,
                                            # k2_bwd_f32, f32_chunk_5x5,
                                            # k2_fwd, k2_fwd_b32,
                                            # k4_fwd, k4_bwd,
                                            # wrappers; or step: 10
                                            # steps of ``train``
                                            # (step_5x5, step_5x5_f32:
                                            # of the 5x5 config); or
                                            # graph_check: phase 15(a)'s
                                            # f32 check alone, 5 runs a
                                            # tree)
    python3 chip_smoke.py --invert-ab [PAIRS] [plans|loops]
                                            # invert_check on K1's plan
                                            # against the whole-image one
                                            # (plans, the default), or on
                                            # the graphed loops against
                                            # the host loops (loops)
                                            # (``invert_plan_ab``)

Phases, any failure exits non-zero:

1. Device and build: the card's name and power limit, then the CUDA
   kernels (K1 forward ``ar_stack.cu`` and backward ``ar_stack_bwd.cu``,
   K2 forward ``masked_conv.cu`` and backward ``masked_conv_bwd.cu``, K4
   forward and backward ``disc_logistic.cu``, one nvcc each for sm_90a,
   all started together) and the Triton kernels (K3 forward and backward,
   K5) are built from the sources beside this script, with their build
   seconds and ptxas register and spill lines; K4 is launched once on a
   tiny input.
2. The main path's config: the CIFAR paper config (``--hpconfig
   depth=1,num_blocks=20,kl_min=0.25,learning_rate=0.002,batch_size=32``:
   z=32, h=160, 20 IAF layers, depth_ar=2, bf16 convs) with random weights
   from a data-dependent init on 32 synthetic images, run twice from one
   seed: every parameter bitwise equal (the init runs on cuDNN's
   deterministic algorithms); a third init on cuDNN's default algorithms
   gives the seconds before that repair.
3. Kernel vs plain twin on the card: K1's, K3's and K4's inputs are
   captured from the first launches of one real eval chunk (16 images x 64
   samples); each kernel is held to its twin on them (K1 in bf16 and in f32
   with TF32 off) and timed beside its twin, K1 also beside three cuDNN
   convs (its yardstick), and each bound is computed from the shapes. K1
   in bf16 must take the tensor-core kernel (``fwd_route``) and give the
   same bits on two calls, and its weight pack kernel must equal the
   pack's twin bitwise (offsets too) on the model's weights and on
   contiguous copies; its device time per call is listed by kernel
   (weight pack, main kernel), at N = 1024 and at the training shape
   (the chunk's first 32 images with the pre-activations written, heads
   and pre-activations held to the twin's at 2e-2 of max). K4 (CUDA, each
   row split over ``dl_plan``'s S blocks of a cluster) is held to its twin
   at 1e-5 per row, gives the same bits on two calls, and lists its
   device kernels per call and its device time at every S.
   K1's launch plan (``fwd_plan``, ``k1_plans``): at N = 1024 and at the
   training shape the plan it picks and the whole-image plan run on the
   same inputs, each held to the twin (heads and pre-activations), the
   picked one bitwise the whole-image one's, each timed by device time
   and events with its blocks, the bound and cuDNN's three
   convs beside them, and where they differ the two A B B A (phase 6
   does the same in f32, phase 14 at N = 16 bf16 and N = 2 f32).
   (b) The fused inference passes (``iaf_torch.ops.glue``, ``glue_phase``)
   on card tensors at the paper's widths (z 32, h 160, 16x16), N = 1024
   (the eval chunk) and 16 (recon), with no border (the deconv's input),
   the 3x3 convs' border and the 5x5 convs': each held to its twin run
   on the card on the same inputs (``glue_check``: the residual h' and
   K1's context bitwise, bf16 outputs within 1 bf16 step with their
   border zero, z and log q within 4 ulp of f32 of their largest term,
   the KL sums within their terms' tolerances), the same bits on two
   calls, one launch a call; at the 3x3 border each timed by events and
   device time beside its twin, with its bytes bound: one kernels row a
   pass. (c) One chunk of the paper model eagerly through the fused
   route and with ``cvae.fused_route`` forced off (``glue_route_phase``;
   phase 11 the same for the 5x5 model): the bound within 4 ulp of f32,
   the decoder's output bitwise. One chunk is then profiled (device time
   by kernel name).
4. Port vs plain on a small input: one f32 eval forward on the card
   (kernels) against the same forward on the CPU (twins), same noise.
5. Eval main path: ``iaf_torch.train_lib.evaluate`` over 2 test batches
   of 16 at k=256 (4 chunks of 64); the launch counters are zeroed just
   before and read just after, and must be K1 = K3 = 160, K4 = 8 (on the
   card each batch's first chunk runs a CUDA graph's warm-up or a replay,
   the rest replays). Three more batches through the graphed eval step
   alone give the steady seconds per batch (their median).
6. The f32 recipe (the same model, ``compute_dtype=float32``): K1's
   inputs captured from one real f32 eval chunk (posterior samples and
   folded weights with full f32 mantissas, not bf16 upcast); K1 must take
   the 3xTF32 tensor-core kernel (``fwd_route`` ``"3xtf32"``), give the
   same bits on two calls and hold the twin in f64 at 1e-5 of the
   output's max, at N = 1024 and at batch 32 with the pre-activations
   written (each within 1e-5 of its max); its f32 weight pack kernel must
   equal its twin bitwise. Each shape is timed by events and by device
   time (by kernel too) beside the twin and cuDNN's three f32 convs (TF32
   off), with the bound (each f32 product one TF32 product at 495
   TFLOP/s), the 3xTF32 design's floor (three of them) and the FP32
   CUDA-core floor (67 TFLOP/s). One f32 chunk
   is profiled; ``evaluate`` at k=256 over 2 batches must launch exactly
   K1 = K3 = 160, K4 = 8 with every K1 forward on ``"3xtf32"`` (steady
   seconds per batch as in phase 5); ``train`` at batch 32 for 6 steps
   exactly the per-step counts of phase 9, every K1 forward on
   ``"3xtf32"``, every K1 backward on ("3xtf32", "3xtf32") for every conv
   and every loss finite (steady step: median of steps 3-6). Then K1's
   backward on the inputs of one more real f32 step (batch 32; z, the
   weights, the pre-activations and the output gradient with full f32
   mantissas): every conv's dgrad and wgrad on ``"3xtf32"`` (K2's 3xTF32
   kernels), dz, dcontext, dW (live taps; the dead ones zero) and db
   within 1e-5 of each one's max of the twin in f64 (values printed),
   where one TF32 product per f32 product on the same inputs (the
   control, printed) must miss that limit; two calls bitwise equal; the
   f32 glue kernel against its twin and the f32 weight pack kernel
   bitwise; device time by kernel; timed by events and by device time,
   whole and as the dgrad chain and wgrad apart, beside the FMA kernels
   it replaces (same inputs, same run), the twin and autograd of cuDNN's
   three f32 convs (TF32 off), with the bounds. One f32 step is
   profiled.
7. Backward kernels against their twins on the card: the inputs and
   upstream gradients of K1's, K3's and K4's backward are captured from the
   first launches of one real training step (paper config, bf16, batch
   32; K1's forward there must take the tensor-core kernel); each
   backward is held to autograd of its twin (K1 bf16 at 2e-2 of each
   output's max, K3 at 1e-6 (1 + |ref|), K4 at 1e-5) and K5 to its twin
   bitwise on that step's parameters and gradients; each is timed beside
   its twin and its bound, K1's backward also beside autograd through
   three full cuDNN convs (K1's f32 backward is phase 6's). K1's bf16
   backward must take the tensor cores for dgrad and wgrad on every conv
   (``bwd_route``), give the same bits on two calls and list its device
   time per call by kernel; its dgrad chain (with the weight pack and the
   glue passes) and its wgrad (with the reduce) are timed apart, and the
   glue and pack kernels are held to their twins. K4's backward must be
   one device kernel a call and give the same bits on two calls; it is
   timed at every S beside an empty kernel on its grid (the launch
   floor). K3's and K4's forward kernels are held to their twins and
   timed on the same step's inputs (batch 32) too.
8. One f32 training step of the paper config at batch 4, card (kernels)
   against CPU (twins), same params, batch and noise: the loss, every
   gradient leaf and every updated parameter and EMA leaf are compared.
9. Training main path: ``iaf_torch.train_lib.train`` at the paper config
   (bf16, batch 32, synthetic data) for 10 steps with a checkpoint at step
   10, then a resume for 2 more steps that must restore at step 10. On
   the card ``train`` runs the first step of each run eagerly, captures
   the step as a CUDA graph and replays it (phases 6, 11 and 12 too).
   The counters are zeroed before each run and read after it, and must
   be, per step, K1 = K1-backward = K3 = K3-backward = 20, K4 =
   K4-backward = K5 = 1 (a replay adds the launches its capture saw).
   Every step's loss must be finite; the steady seconds per step
   (median of steps 3-10) and examples/s are printed, the reserved
   memory after each run, and one more eager step is profiled (device
   time by kernel name, device-busy share).
10. K1 at the deepest chain it holds at the paper widths (on the tensor
   cores: 16 convs in bf16, 8 in f32 by 3xTF32; 64 images) against its
   twin, bf16 at 2e-2 of the output's max and f32 at 1e-5 of the twin's
   in f64.
11. The 5x5 config (the paper config with ``kernel_size=5``: every AR net
   runs conv by conv through K2, three masked 5x5 convs per IAF step) at
   full width and depth: init; K2's inputs captured from one real eval
   chunk for all three conv shapes, each of which must take the
   tensor-core forward kernel, held to the twin in bf16 at 2e-2 (and the
   same inputs upcast to f32 at 1e-5) of the output's max, timed beside
   the twin, one cuDNN conv (with the ratio) and the bound; one chunk
   through the fused and the plain route (phase 3(c), the passes with
   the 5x5 convs' border of 2), and one chunk profiled; one f32 eval
   forward, card against CPU twins; ``evaluate``
   at k=256 with launches exactly K2 = 60, K3 = 20, K4 = 1 per chunk and
   K1 = 0; K2's backward on inputs captured from a real bf16 step at
   batch 32, each shape's dgrad and wgrad on the tensor cores, held to
   autograd of its twin (2e-2 of each output's max; upcast to f32 at
   1e-4 of the twin in f64), two calls bitwise equal, its device time per
   call by kernel, timed whole and as dgrad and wgrad apart beside the
   twin's and cuDNN's backward; K2's forward on the same step's inputs
   (batch 32) against its twin, timed beside cuDNN with the bound, on
   both launch plans (``k2_plans``: the weight pack kernel bitwise
   ``fwd_pack``, the 64-pixel plan bitwise the 128-pixel one, per plan
   the blocks, the conv kernel's and the pack's device ms, the two A B B
   A), then dgrad's kernel on both tiles for the three convs and K1's
   chain at batch 32 (``dgrad_plans``: measured, not routed) (phase 12
   the same in f32); one f32 training step at batch 4, card
   against CPU; and ``train_lib.train`` for 10 steps plus a 2-step resume
   with launches exactly K2 = K2-backward = 60, K3 = K3-backward = 20, K4
   = K4-backward = K5 = 1, K1 = K1-backward = 0 per step, and one step
   profiled.
12. The 5x5 config's f32 recipe (``compute_dtype=float32``, the same
   model): K2's inputs captured from one real f32 eval chunk (full f32
   mantissas) for the three conv shapes, each of which must take the
   3xTF32 tensor-core kernel (``fwd_route`` ``"3xtf32"``), give the same
   bits on two calls and hold the twin in f64 at 1e-5 of the output's
   max; K2's backward on inputs captured from a real f32 step at batch
   32, dgrad and wgrad on ``"3xtf32"``, dx and dW within 1e-5 of the twin
   in f64 (values printed), two calls bitwise equal; one TF32 product per
   f32 product on the same inputs must miss each 1e-5 limit (the
   control, printed); each timed by events and by device time (by kernel
   too; the backward whole and as dgrad and wgrad) beside the FMA kernels
   it replaces (same inputs, same run), the twin and cuDNN f32 (TF32
   off), with the bound (each f32 product one TF32 product at 495
   TFLOP/s), the 3xTF32 design's floor and the FP32 CUDA-core floor; one
   f32 chunk profiled; ``evaluate`` at k=256 with
   launches exactly K2 = 60, K3 = 20, K4 = 1 per chunk, and ``train`` at
   batch 32 for 6 steps with exactly the 5x5 per-step counts, every K2
   forward on ``"3xtf32"`` and every backward on ("3xtf32", "3xtf32"),
   every loss finite; one f32 step profiled.
13. A 3x3 AR net one conv deeper than K1 holds at the paper widths in
   bf16 (depth_ar=16, 17 convs; f32 holds fewer), through
   ``ARMultiConv2d`` on 64 images: launches exactly K1 = 0 and K2 = 17
   per forward, and the heads match K1's twin at 2e-2 (bf16) and 1e-5
   (f32, TF32 off) of the output's max.
14. The serving modes on phase 9's logdir (its step-12 checkpoint, the
   paper config in bf16), each entry point under PyTorch's default TF32
   flags (as the CLI runs it) and counted (launches zeroed just before,
   read just after): (a) ``train_lib.eval_loop`` with ``max_evals=1``,
   k=256 and one batch of 16 writes one row of
   ``eval_test_metrics.jsonl`` at step 12 and launches exactly K1 = K3
   = 80, K4 = 4; (b) ``evaluate`` over one batch with a progress file,
   then resumed from it to two batches, equals a straight 2-batch run
   within 1e-6 relative (the difference printed), the file still there
   after both (neither is a full pass); (c) ``reconstruct(num=16)``:
   uint8 [16, 32, 32, 3], K1 = K3 = 20, K4 = 1, and the inputs of each
   kernel's first call captured (N = 16) and held to its twin as in
   phase 3 (K1 bf16 at 2e-2 of max, K3 at 1e-6 * (1 + |ref|), K4 at
   1e-5 a row; each timed, a row of the kernels line); (d)
   ``sample(num=16, temperature=[1.0, 0.5])``: no kernel launch, finite
   images equal to ``cvae_sample``'s on the same key with TF32 off in
   the whole process, the two tiles different, the seconds of a call
   printed; (e) ``invert_check(batch=2)``: on the inputs it builds
   (``train_lib.inversion_inputs``), the flow's largest move of z (the
   error of an inverse that returns z' unchanged) above 1e-4, so that
   the round-trip limit can fail; K1's f32 inputs captured from one
   ``ar_fn`` call of the top layer (N = 2) on the 3xTF32 route held to
   the f64 twin at 1e-5 of max and timed as in phase 6 (a row of the
   kernels line), the exact inverse run only where it and Jacobi (D =
   8192 sweeps each) are predicted under 120 s, the launches exactly K1
   = 1 + D per Jacobi or exact inverse + the fixed point's sweeps, K3 =
   1, K3's inputs (N = 2) captured and held to its twin as in (c);
   ``err_jacobi`` and ``err_fixed_point`` (and ``err_exact``) under
   1e-4; then the fixed-point inverse of the same z', card against the
   CPU twins, within 1e-5 of max, the sweeps equal at a tolerance
   halfway (in log) between the CPU's changes either side of 1e-6 and
   at most one apart at 1e-6 itself (printed). K1's launch plans run on
   the captured inputs of (c) and (e) as in phase 3 (``k1_plans``), and
   ``invert_check``'s seconds and one sweep's ms are printed beside the
   host loops' (``INVERT_BEFORE``). The launches count every sweep the
   blocks run (``inverse_sweeps``: D and the fixed point's sweeps rounded
   up to whole blocks).

15. The captured training step (``train_step.make_train_step``): (a)
   three eager ``train_step``s against the graphed step (warm-up, then
   two replays) on copies of one state, same batches and keys, paper
   config at batch 32, bf16 and f32, and the 5x5 config in bf16 (its K2
   forwards on 64-pixel tiles): loss, every gradient, param, m, u
   and EMA leaf and the step bitwise equal where two more eager copies
   (the controls, printed) are bitwise equal to the first and to each
   other; where they are not (f32: cuDNN's algorithms), within
   ``NONDET_MARGIN`` times the largest of the three pairs' differences,
   part by part; in f32, and wherever the controls are not bitwise, the
   same steps again on cuDNN's deterministic algorithms must be
   bitwise (``graph_check``); (b) in the four training cells (paper,
   paper f32, 5x5, 5x5 f32) the median eager step and the median graphed
   step over the same 8 steps, each ending in a wait for its loss (the
   graphed one must be faster), and one graphed step's device busy by
   torch.profiler (by CUDA events if it sees no kernel); (d) from
   phase 9's step-10 checkpoint, ``train`` for 10 more steps at
   steps_per_dispatch=1 and at 4 (4 + 4 + 2): one loss row per step, the
   launch counts of 10 steps each, and the two final states (params, m,
   u, EMA, step) bitwise equal; and ``train`` for 10 steps from init at
   steps_per_dispatch=4, its state bitwise equal to phase 9's S = 1 run
   at step 10; (e) in the two f32 cells the median graphed step over the
   same 8 steps with cuDNN's default and its deterministic algorithms,
   in turns (default, deterministic, deterministic, default).

16. The MNIST family (``mnist_vae.mnist_config`` at full width: z = h =
   64, a 640-wide two-layer MADE, two IAF steps, Bernoulli, batch 100;
   6,716,290 params in 45 leaves) on synthetic 28x28x1 images binarized
   by ``feed.dynamic_binarize``: (a) the init twice from one seed,
   bitwise equal, with its seconds; (b) one f32 forward and one f32
   gradient, card against CPU twins, log_w at 1e-5 and each gradient
   leaf at 1e-4 of its max; (c) ``train`` at batch 100 for 10 steps
   through the graphed step, launches exactly K5 = 10 and nothing else,
   every loss finite, one ``nll_nats`` row a step, a 2-step resume that
   restores and binarizes from step 10 on; then 15(a)'s check on MNIST
   (which case held is printed); (d) K5 on one real MNIST step's 45
   leaves bitwise against its twin and timed (a row of the kernels
   line, ``adamax_polyak_mnist``); (e) ``evaluate`` at k=256 over 2
   batches of 16 with no kernel launch and a finite NLL in nats, the
   steady seconds per batch, one chunk profiled; (f) ``sample`` (two
   temperatures, their tiles different) and ``reconstruct`` on (c)'s
   logdir, uint8 [16, 28, 28, 1], no launch, and ``invert_check``
   raising (the CIFAR family's only); (g) the median eager and graphed
   steps side by side as in 15(b).

17. Data parallelism (``parallel/mesh.py``), paper config: (a) an NCCL
   group of world size 1 made in this process with torchrun's
   environment; ``train`` for 10 bf16 steps from init at S = 1, its
   state bitwise equal to phase 9's at step 10, launches exactly
   ``PER_STEP`` a step; (b) the median graphed step over the same 8
   steps with no group, with the group (its all-reduces captured in the
   graph, the design the port keeps) and with the graph split around
   the gradient all-reduce (``_split_chunk``), in turns (no group,
   captured, split, no group), and one graphed step's device time by
   name with no group and captured (the NCCL kernels' share printed);
   (c) ``evaluate`` at k=256 over 2 batches on phase 9's checkpoint and
   the batch-sharded k = 1 ELBO through the group, bitwise equal to the
   calls with no group; (d) ``sample`` at T = 1.0 and 0.5 through the
   gather, bitwise equal to the calls with no group; (e) where two cards
   are visible, two ranks (``two_rank_phase``, NCCL, paper f32, global
   batch 32): the first step's gradient against one process on the
   whole batch at 1e-4 of each leaf's max, both ranks' params bitwise
   equal after 10 steps, examples/s at world size 2 and 1; with one
   card a line says it did not run (neither a pass nor a failure).

18. ``--mode export`` (``core/export.py``), the forward kernels K1-K4 as
   torch ops (``iaf::*``) that the exported program records, each call
   under PyTorch's default TF32 flags (the loader sets the contract's):
   (a) ``train_lib.export_saved`` on phase 9's logdir (paper bf16, EMA
   weights, k = 1, 16 images, 16 samples): the elbo graph holds exactly
   20 ``iaf.ar_stack``, 20 ``iaf.iaf_update`` and 1
   ``iaf.disc_logistic_logp``; the loaded elbo artifact, counters zeroed
   just before, launches exactly K1 = K3 = 20, K4 = 1 and equals the
   eager ``apply_fn(mode="eval", k=1)`` bitwise with ``draw_noise``'s
   tensors; the sample artifact launches nothing and equals
   ``cvae_sample`` bitwise at T = 1.0 and 0.5; the seconds of the
   export, the load and a call; (b) the same elbo artifact in a fresh
   process that imports only torch, ``iaf_torch.ops`` and
   ``iaf_torch.core.export``: the same launches and bits, no model code
   in ``sys.modules``; (c) the 5x5 config from a data-dependent init at
   k = 4: 60 ``iaf.masked_conv2d`` nodes, launches exactly K2 = 60, K3 =
   20, K4 = 1, bitwise equal to eager, the sample artifact as in (a);
   (d) the f32 recipe exported for the card and the CPU (TF32 off in the
   contract): the card's elbo within 1e-5 relative of the CPU's on the
   same noise; (e) phase 16's MNIST logdir: both artifacts launch
   nothing and equal eager bitwise; (f) phase 5's steady seconds per
   eval batch and phase 3's K1, K3 and K4 events ms, now through the
   torch ops, beside the direct launches' (``BEFORE_OPS``), and the host
   cost of the dispatch measured directly (``dispatch_cost``: K1 f32,
   K3 and K4 at N = 2, each op against the launch it wraps).

19. The training step's memory levers (``memory_phase``), paper config
   in bf16 through the graphed step (``make_train_chunk``, one step a
   chunk), each lever from one init on a copy of its state: (a) batch
   32 at grad_accum 1 and 2 and at scan_blocks=true,remat=true, and the
   5x5 config plain and under remat; (b) batch 256 at grad_accum 1 and 8
   and under remat; for each the peak memory (``max_memory_allocated``
   over the warm-up, the capture and 8 replays) beside what was
   allocated before the run and the state's own bytes (params, m, u,
   EMA), the median replay and the launches a step, exactly
   ``PER_STEP`` (grad_accum A: each micro-batch's kernels A times, K5
   once; remat ``PER_STEP_REMAT``: K1 = K3 = 40, 5x5 K2 = 120); (c)
   grad_accum=2 through an NCCL group of one (the micro-batch row
   gather captured in the graph) bitwise the run with no group; (d) the
   remat step's losses and gradients against the plain step's on
   cuDNN's deterministic algorithms, bitwise or within 1e-6 of each
   leaf's max (which held is printed); (e) in ``--multi``, two ranks at
   grad_accum=2 (``two_rank_phase``).

20. The serving loops on the device (``loops_phase``, also ``--loops``):
   (a) in the five eval cells (paper, paper f32, 5x5, 5x5 f32 and MNIST,
   16 images at k=256 in chunks of 64, each model from a data-dependent
   init) the graphed eval step (``make_graphed_eval_step``) against the
   eager one: launches exactly a chunk's (paper K1 = K3 = 20, K4 = 1;
   5x5 K2 = 60, K3 = 20, K4 = 1; MNIST none) on every call of either;
   bitwise where three eager runs are, else within ``NONDET_MARGIN``
   times their largest difference; again after the weights are copied in
   place (the same graph replayed, a result apart from the old one's);
   the median seconds a batch and importance samples/s of each over 5
   batches in turns (A B B A), and one graphed batch's device-busy share;
   (b) ``invert_check``'s three inverses at batch 2 on the paper model,
   host loops against the blocked ones (replayed graphs): bitwise, equal
   fixed-point counts, K1 one launch a sweep, the seconds and one sweep's
   ms of each; (c) ``train`` (paper bf16, batch 32, 4 steps) with the
   heartbeat eval every 2 steps and without: launches exact, finite
   heartbeat rows and the peak memory with the train and eval graphs
   alive together.

Times: ``ms`` is by CUDA events around 20 back-to-back calls (what a
caller waits, host included); ``device_ms`` (every kernel, and K1's and
K2's library calls) is the device time the profiler records for the same
calls, host gaps left out, which ranks a kernel against its library
call.

The second-last line of standard output is the ``kernels`` JSON (the
fused passes' rows ``elu_bf16``, ``residual_elu``, ``up_stats``,
``posterior``, ``kl_join``, N = 16 under ``*_n16``, their launches those
of phase 5's eval; the f32 recipe's kernels rows of their own: K1's forward ``ar_stack_f32`` and
backward ``ar_stack_bwd_f32``, their launches those of phase 6's runs,
and K2's ``masked_conv2d_f32`` and ``masked_conv2d_bwd_f32``, those of
phase 12's; each with the 3xTF32 bound and the FP32 floor; and
phase 14's rows at the serving shapes: ``ar_stack_recon``,
``iaf_update_recon`` and ``disc_logistic_logp_recon`` at N = 16, their
launches those of one ``reconstruct``, and ``ar_stack_f32_inversion``
(K1 in f32) and ``iaf_update_inversion`` at N = 2, their launches those
of one ``invert_check``; and ``adamax_polyak_mnist``, K5 over the MNIST
model's 45 leaves, its launches those of phase 16's training run; and
K2's forward at the 5x5 training step's shapes, batch 32,
``masked_conv2d_b32`` and ``masked_conv2d_f32_b32``, their launches
those of phases 11's and 12's training runs), the last ``{"ok": true,
"device": {...}}``. The line before it, ``{"main": ...}``, sums up each
path, phase 14's under ``"serve"``, phase 15's medians under each
``train*`` entry's ``"side_by_side"``, with ``"graph_vs_eager"``,
``"train_chunked"`` and ``"train_f32_determinism"``, the inits' seconds
under ``"main"``'s ``"init"``, phase 16's under ``"mnist"``, phase
17's under ``"multi"``, phase 18's under ``"export"``, phase 19's
under ``"memory"`` and phase 20's under ``"loops"``.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PAPER = "depth=1,num_blocks=20,kl_min=0.25,learning_rate=0.002,batch_size=32"
PAPER5 = PAPER + ",kernel_size=5"
# the MNIST family's configuration (``mnist_vae.mnist_config``) on the
# synthetic set, as an hpconfig, so the CIFAR cells' helpers take it
MNIST = ("dataset=synthetic,image_size=28,channels=1,z_size=64,h_size=64,"
         "ar_hidden_size=640,depth_ar=2,flow_depth=2,flow=iaf,"
         "flow_update=division,ar_kind=dense,likelihood=bernoulli,"
         "binarize=true,kl_min=0.25,learning_rate=0.002,batch_size=100,"
         "eval_k=4096")
MNIST_PARAMS, MNIST_LEAVES = 6_716_290, 45
K2_NAMES = ("masked_conv2d", "masked_conv2d_bwd")
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
# dense peaks (data sheet): bf16 and TF32 on the tensor cores, f32 on the
# CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
EVAL_BATCH, EVAL_K, EVAL_CHUNK, EVAL_BATCHES = 16, 256, 64, 2
STEADY_BATCHES = 3         # the steady eval's median is over these batches
TRAIN_STEPS, RESUME_STEPS = 10, 2
SIDE_BY_SIDE_STEPS = 8     # phase 15(b): the steps each median is taken over
# phase 15(a): where eager runs differ (cuDNN's f32 algorithms are not all
# deterministic), the graph may differ from the eager run by this many
# times the controls' difference, part by part: the largest over the three
# pairs of three eager runs, so that one pair that happens to agree (a
# loss difference of 0.0 while the gradients differ by 2-4e-3, seen on an
# H100) does not set a limit of 0. Each part's difference is a maximum
# over up to 41.6 M elements (an H100 read 0.0036 for a control's
# gradients and 0.0025 for the graph's, param 4.0e-4 and 3.9e-4)
NONDET_MARGIN = 2.0
F32_TRAIN_STEPS = 6
# f32 step, card vs CPU: small-gradient elements whose Adamax sign may
# flip. 129-133 of 41.6 M flipped on an H100; a wrong gradient in one
# leaf flips thousands.
MAX_FLIPS = 1000


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(prof) -> list[tuple[str, float, int]]:
    """(name, self device time in us, count) of each kernel, copy and
    memset that a profile recorded on the card."""
    import torch
    events = [(e.key, getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)), e.count)
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return [d for d in events if d[1] > 0]


def device_kernels(fn, iters: int = 20, warmup: int = 3, attempts: int = 3,
                   expect: tuple[str, ...] = ()
                   ) -> list[tuple[str, float, int]]:
    """Per call of ``fn``: (name, device ms, launches) of each kernel, copy
    and memset it puts on the card, from torch.profiler over ``warmup`` +
    ``iters`` calls after one untraced call. The profiler on the card can
    start recording late: it has missed the first launches of a window
    (half of 6 calls of 2.6 ms each, in every window of a phase, late in
    a long run), and now and then a whole short one. So the window opens
    with a pause, and a window that missed launches (a name seen fewer
    times than once a call, or a name in ``expect`` not seen: each a
    substring of a kernel's name that ``fn`` launches) is profiled again
    after a pause four times as long over twice as many calls, so that a
    missed start is a smaller share of it (``attempts`` in all, saying so
    on standard error); each name's time is its mean per launch times its
    launches per call (its count over the calls, rounded, and at least 1:
    a name still seen fewer times than once a call after the last window
    counts once a call, as the profiler drops launches far more often than
    a call of these functions skips one); an ``expect`` name still missing
    fails the run. Host gaps between launches do not count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        calls = (warmup + iters) * 2 ** attempt
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05 * 4 ** attempt)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        missing = [e for e in expect if not any(e in k for k, _, _ in events)]
        short = [k for k, _, count in events if not round(count / calls)]
        if events and not missing and not short:
            break
        print(f"[profile] {getattr(fn, '__qualname__', fn)}: a window of "
              f"{calls} calls recorded {events} on the card ("
              f"{len(prof.key_averages())} names in all; missing "
              f"{missing}, under once a call {short}); again",
              file=sys.stderr)
    check(not missing, f"{attempts} profiler windows of "
          f"{getattr(fn, '__qualname__', fn)} missed {missing}: {events}")
    out = []
    for key, us, count in events:
        per_call = max(1, round(count / calls))
        out.append((key, us / count * per_call / 1e3, per_call))
    return out


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn`` (``device_kernels`` summed), so a
    call that the host holds back reads what the card did."""
    found = device_kernels(fn, iters, warmup)
    total = sum(ms for _, ms, _ in found)
    check(total > 0, f"the profiler recorded no device time for "
          f"{getattr(fn, '__qualname__', fn)} ({found})")
    return total


def bound_ms(flops: float, dtype: str, nbytes: float):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _f32_bounds(flops: float, moved: float) -> dict:
    """For ``flops`` f32 FLOP and ``moved`` bytes: the bound (each f32
    product once at the tensor cores' 495 TFLOP/s, the card's peak for
    f32 operands), the 3xTF32 design's own floor (three TF32 products per
    f32 product, ``design_bound_ms``) and the FP32 CUDA-core floor (each
    product once at 67 TFLOP/s)."""
    b_ms, b_by = bound_ms(flops, "tf32", moved)
    return dict(bound_ms=b_ms, bound_by=b_by,
                design_bound_ms=bound_ms(3 * flops, "tf32", moved)[0],
                fp32_floor_ms=bound_ms(flops, "float32", moved)[0],
                gflop=flops / 1e9, mbytes=moved / 1e6)


def _tf32(t):
    """``t`` (f32) rounded to tf32 as ``cvt.rna.tf32.f32`` rounds (10
    mantissa bits, ties away from zero), in f64: the operands of a kernel
    that forms each f32 product as one TF32 product, the control that
    the f32 checks' limits must reject."""
    import torch
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).double()


def _f32_bound_text(b: dict, dev: float) -> str:
    """``_f32_bounds``' numbers for a print, ``dev`` (device ms) beside
    the bound."""
    return (f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: one TF32 "
            f"product per f32 product, {b['gflop']:.2f} GFLOP at 495 "
            f"TFLOP/s; {100 * b['bound_ms'] / dev:.0f} % of it), 3xTF32 "
            f"design floor {b['design_bound_ms']:.4f} ms, FP32 CUDA-core "
            f"floor {b['fp32_floor_ms']:.4f} ms")


def capture_inputs(ops, fn,
                   names=("ar_stack", "iaf_update", "disc_logistic_logp")):
    """Run ``fn`` with spies on the wrappers ``names``; return each
    wrapper's first call's arguments (cloned)."""
    import torch
    originals = {n: getattr(ops, n) for n in names}
    seen: dict[str, tuple] = {}

    def clone(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, (list, tuple)):
            return type(a)(clone(x) for x in a)
        return a

    def spy(name):
        def wrapped(*args):
            if name not in seen:
                seen[name] = clone(args)
            return originals[name](*args)
        return wrapped

    for n in names:
        setattr(ops, n, spy(n))
    try:
        fn()
    finally:
        for n in names:
            setattr(ops, n, originals[n])
    check(set(seen) == set(names), f"captured only {sorted(seen)}")
    return seen


def k1_yardstick(z, ctx, ws, bs):
    """Three full 3x3 masked cuDNN convs + bias + context + ELU on the same
    folded weights, channels-last (never called by the port)."""
    import torch.nn.functional as F
    h = z.permute(0, 3, 1, 2)
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = F.conv2d(h.to(w.dtype), w.permute(3, 2, 0, 1), padding=1).float()
        h = h + b[:, None, None]
        if i == 0:
            h = h + ctx.permute(0, 3, 1, 2)
        if i < len(ws) - 1:
            h = F.elu(h)
    return h


def _by_kernel(label: str, call) -> int:
    """Print the device time per call of each kernel ``call`` launches;
    return its device launches per call."""
    found = sorted(device_kernels(call, 10, 2), key=lambda d: -d[1])
    for key, k_ms, k in found:
        print(f"[{label}] by kernel, per call: {k_ms:.4f} ms x{k} {key[:80]}")
    return sum(k for _, _, k in found)


def _k1_training_shape(ops, ar_mod, z, ctx, ws, bs, batch=32) -> dict:
    """K1's forward at the training shape: the first ``batch`` images of
    the captured chunk with the pre-activations written (what autograd
    asks for). Heads and pre-activations against the twin's at 2e-2 of
    each one's max, two calls bitwise equal; device time by kernel, by
    events, the bound (bytes: pre-activations included) and cuDNN's three
    convs. Returns the numbers for the kernels line."""
    import torch
    zb, cb = z[:batch].contiguous(), ctx[:batch].contiguous()
    with torch.inference_mode():
        out, pre = ar_mod._fwd(zb, cb, ws, bs, save_pre=True)
        again = ar_mod._fwd(zb, cb, ws, bs, save_pre=True)
        check(all(torch.equal(a, b) for a, b in zip([out, *pre],
                                                     [again[0], *again[1]])),
              f"K1 at batch {batch}: two calls differ")
        rout, rpre = ops.ar_stack_ref_pre(zb, cb, ws, bs)
        worst = max(_rel_err(a, b)[1] for a, b in zip([out, *pre],
                                                      [rout, *rpre]))
        check(worst <= 2e-2, f"K1 at batch {batch}: heads or pre-activations "
              f"{worst:.3e} of max > 2e-2")
        call = lambda: ar_mod._fwd(zb, cb, ws, bs, True)  # noqa: E731
        per_call = _by_kernel(f"K1 b{batch}", call)
        ms = cuda_ms(call)
        dev = device_ms(call)
        lib_dev = device_ms(lambda: k1_yardstick(zb, cb, ws, bs))
    n, hh, ww, _ = zb.shape
    flops = 2 * n * hh * ww * 5 * sum(w.shape[2] * w.shape[3] for w in ws)
    moved = (nbytes(zb, cb, out, *pre, *bs)
             + sum(5 * w[0, 0].numel() * w.element_size() for w in ws))
    b_ms, b_by = bound_ms(flops, "bfloat16", moved)
    print(f"[K1 b{batch}] z{tuple(zb.shape)} with pre-activations: heads and "
          f"pre-activations {worst:.3e} of max from the twin's, two calls "
          f"bitwise equal; by events {ms:.4f} ms, by device time {dev:.4f} "
          f"ms ({per_call} device launches a call), cuDNN {lib_dev:.4f}, "
          f"ratio {dev / lib_dev:.3f}; bound {b_ms:.4f} ms ({b_by}, "
          f"{moved / 1e6:.1f} MB)")
    return {"ms_b32": ms, "device_ms_b32": dev, "library_device_ms_b32":
            lib_dev, "bound_ms_b32": b_ms, "bound_by_b32": b_by,
            "max_rel_err_b32": worst}


def _f64(z, ctx, ws, bs):
    """The K1 twin's arguments in f64 (the f32 kernel's reference)."""
    return (z.double(), ctx.double(), [w.double() for w in ws],
            [b.double() for b in bs])


def _k1_f32_shape(ops, ar_mod, label, z, ctx, ws, bs, masks,
                  save_pre: bool) -> dict:
    """K1's f32 forward on (z, ctx, ws, bs): the 3xTF32 tensor-core route,
    two calls bitwise equal, the heads (and with ``save_pre`` the
    pre-activations) within 1e-5 of each one's max of the twin's in f64;
    device time by kernel, by events and by device time beside the twin
    (f32, TF32 off) and cuDNN's three f32 convs (TF32 off); the bounds of
    ``_f32_bounds``. Returns the numbers."""
    import torch
    n, hh, ww, cz = z.shape
    route = ar_mod.fwd_route(z.dtype, ww, cz, ws[0].shape[-1],
                             ws[-1].shape[-1])
    check(route == "3xtf32", f"K1 f32 z{tuple(z.shape)} takes the {route} "
          "kernel, not the 3xTF32 tensor-core one")
    with torch.inference_mode():
        out, pre = ar_mod._fwd(z, ctx, ws, bs, save_pre)
        again = ar_mod._fwd(z, ctx, ws, bs, save_pre)
        check(all(torch.equal(a, b) for a, b in zip([out, *pre],
                                                     [again[0], *again[1]])),
              f"K1 f32 {label}: two calls differ")
        rout, rpre = ops.ar_stack_ref_pre(*_f64(z, ctx, ws, bs))
        errs = [_rel_err(a, b) for a, b in zip([out, *pre],
                                               [rout, *rpre])]
        err, worst = max(e[0] for e in errs), max(e[1] for e in errs)
        check(worst <= 1e-5, f"K1 f32 {label}: {worst:.3e} of max from the "
              "f64 twin > 1e-5")
        if save_pre:
            call = lambda: ar_mod._fwd(z, ctx, ws, bs, True)  # noqa: E731
        else:
            call = lambda: ops.ar_stack(z, ctx, ws, bs, masks)  # noqa: E731
        per_call = _by_kernel(f"K1 f32 {label}", call)
        ms = cuda_ms(call)
        dev = device_ms(call)
        plain = cuda_ms(lambda: ops.ar_stack_ref(z, ctx, ws, bs))
        lib = cuda_ms(lambda: k1_yardstick(z, ctx, ws, bs))
        lib_dev = device_ms(lambda: k1_yardstick(z, ctx, ws, bs))
    flops = 2 * n * hh * ww * 5 * sum(w.shape[2] * w.shape[3] for w in ws)
    moved = (nbytes(z, ctx, out, *pre, *bs)
             + sum(5 * w[0, 0].numel() * w.element_size() for w in ws))
    b = _f32_bounds(flops, moved)
    print(f"[K1 f32 {label}] z{tuple(z.shape)} ({route}"
          f"{', with pre-activations' if save_pre else ''}): "
          f"{worst:.3e} of max from the f64 twin (max abs {err:.3e}), two "
          f"calls bitwise equal; by events {ms:.4f} ms, by device time "
          f"{dev:.4f} ms ({per_call} device launches a call), twin "
          f"{plain:.4f} ms; cuDNN f32 (TF32 off) {lib:.4f} ms, by device "
          f"time {lib_dev:.4f} ms, ratio {dev / lib_dev:.3f}; "
          f"{_f32_bound_text(b, dev)}")
    return {"max_abs_err": err, "max_rel_err": worst, "ms": ms,
            "device_ms": dev, "plain_ms": plain, "library_ms": lib,
            "library_device_ms": lib_dev,
            "device_launches_per_call": per_call, **b}


# ``invert_check``'s seconds and one sweep's ms with its loops on the host
# (PR 19's final chip run, PERF.md's serving figures), before the sweeps
# became replayed blocks
INVERT_BEFORE = (6.402, 0.2793)
# K1's forward device ms a call before ``fwd_plan``, all on the whole-image
# plan (PERF.md §6's earlier figures), by shape label
K1_BEFORE = {"N=1024 bf16": 0.3766, "N=1024 f32": 1.7428,
             "b32 bf16": 0.0517, "b32 f32": 0.2262, "N=16 bf16": 0.0508,
             "N=2 f32": 0.2249}


def _k1_plan_label(plan, h) -> str:
    """A plan as words: whole-image or bands, with its blocks."""
    if plan.band >= h:
        return f"whole-image ({plan.blocks} blocks)"
    return f"bands of {plan.band} rows, {plan.blocks} blocks"


def _k1_call_ms(call) -> tuple[float, float]:
    """(device ms, main kernel ms) a call of K1's forward ``call`` (the
    weight pack and the main kernel, one launch each a call)."""
    found = device_kernels(call, expect=("ar_pack_w", "ar_stack"))
    return (sum(ms for _, ms, _ in found),
            sum(ms for k, ms, _ in found if "ar_stack" in k))


def k1_plans(ops, ar_mod, label, z, ctx, ws, bs, save_pre: bool,
             candidates: bool = False) -> dict:
    """K1's forward on (z, ctx, ws, bs), the pre-activations written with
    ``save_pre``, on the plan ``fwd_plan`` picks and on the whole-image
    plan (with ``candidates`` at N >= SMs also a banded walk of several
    items a block), on the same
    inputs: each plan's heads (and pre-activations) held to the twin
    (bf16 at 2e-2 of each one's max; f32 at 1e-5 of each one's max of the
    twin in f64) and compared bitwise with the whole-image plan's; device
    ms a call (weight pack included; the main kernel apart) and events
    ms; blocks; cuDNN's three convs (TF32 off) by device time and the
    bound. The picked plan must be bitwise the whole-image one;
    then the two A B B A by device time. Returns the numbers."""
    import torch
    n, h, w_, cz = z.shape
    ch, cout = ws[0].shape[-1], ws[-1].shape[-1]
    f32 = z.dtype == torch.float32
    sms = ar_mod._sms(z.device.index)
    picked = ar_mod.fwd_plan(z.dtype, n, h, w_, cz, ch, cout, len(ws), sms)
    whole = ar_mod.whole_plan(n, h, sms)
    plans = [picked] + ([whole] if whole != picked else [])
    if candidates and n >= sms and 8 + 1 - len(ws) >= 1:
        plans.append(ar_mod.FwdPlan(band=8 + 1 - len(ws), blocks=sms))
    tol = 1e-5 if f32 else 2e-2
    with torch.inference_mode():
        ref = ops.ar_stack_ref_pre(*(_f64(z, ctx, ws, bs) if f32 else
                                     (z, ctx, ws, bs)))
        ref = [ref[0], *ref[1]]
        outs = {p: ar_mod._fwd(z, ctx, ws, bs, save_pre, plan=p)
                for p in plans}
        lib_dev = device_ms(lambda: k1_yardstick(z, ctx, ws, bs))
    flops = 2 * n * h * w_ * 5 * sum(w.shape[2] * w.shape[3] for w in ws)
    base = outs[whole]
    moved = (nbytes(z, ctx, base[0], *base[1], *bs)
             + sum(5 * w[0, 0].numel() * w.element_size() for w in ws))
    b_ms, b_by = bound_ms(flops, "tf32" if f32 else "bfloat16", moved)
    before = K1_BEFORE.get(label)
    print(f"[K1 plans {label}] z{tuple(z.shape)} {str(z.dtype)[6:]}"
          f"{' with pre-activations' if save_pre else ''}: cuDNN (TF32 off) "
          f"{lib_dev:.4f} device ms, bound {b_ms:.4f} ms ({b_by})"
          + (f"; the whole-image plan's {before} device ms a call before "
             "fwd_plan (PERF.md)" if before else ""))
    rows = {}
    for p in plans:
        out, pre = outs[p]
        got = [out, *pre]
        worst = max(_rel_err(a, b)[1] for a, b in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, [base[0],
                                                           *base[1]]))
        call = (lambda p=p: ar_mod._fwd(z, ctx, ws, bs, save_pre, plan=p))
        with torch.inference_mode():
            dev, kern = _k1_call_ms(call)
            ev = cuda_ms(call)
        rows[p] = dict(device_ms=dev, kernel_ms=kern, ms=ev, rel_err=worst,
                       bitwise=same)
        print(f"[K1 plans {label}] {_k1_plan_label(p, h)}"
              f"{' (picked)' if p == picked else ''}: {worst:.3e} of max "
              f"from the twin{' in f64' if f32 else ''} (limit {tol}), "
              f"bitwise the whole-image plan's: {same}; device "
              f"{dev:.4f} ms a call (kernel {kern:.4f}), events {ev:.4f} "
              f"ms; cuDNN/plan {lib_dev / dev:.2f}x")
        check(worst <= tol, f"K1 {label} plan {p}: {worst} of max > {tol}")
    check(rows[picked]["bitwise"], f"K1 {label}: the picked plan {picked} "
          "is not bitwise the whole-image plan")
    result = dict(plan=picked._asdict(), blocks=picked.blocks,
                  plan_rel_err=rows[picked][
                      "rel_err"], bitwise_whole=rows[picked]["bitwise"],
                  library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
                  candidates={_k1_plan_label(p, h): r
                              for p, r in rows.items()})
    if picked != whole:
        with torch.inference_mode():
            turns = [_k1_call_ms(lambda p=p: ar_mod._fwd(
                z, ctx, ws, bs, save_pre, plan=p))[0]
                for p in (picked, whole, whole, picked)]
        result.update(abba=turns, plan_device_ms=(turns[0] + turns[3]) / 2,
                      whole_device_ms=(turns[1] + turns[2]) / 2)
        print(f"[K1 plans {label}] picked against whole-image, A B B A "
              f"device ms {', '.join(f'{t:.4f}' for t in turns)}: "
              f"{result['plan_device_ms']:.4f} against "
              f"{result['whole_device_ms']:.4f}")
    else:
        result.update(plan_device_ms=rows[picked]["device_ms"],
                      whole_device_ms=rows[picked]["device_ms"])
    return result


def plans_only() -> int:
    """``--plans``: K1's build and ``k1_plans`` with every candidate plan
    at the paper widths on random inputs from a seed: N = 2 f32 (the
    inversion), N = 16 bf16 (recon), batch 32 bf16 and f32 with the
    pre-activations written (the training forward), N = 1024 bf16 and
    f32 (the eval chunk)."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from iaf_torch import ops
    from iaf_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load("ar_stack")
    secs = _build.build_seconds.get("ar_stack", 0)
    print(f"[build] nvcc ar_stack.cu {secs:.1f} s")
    for line in _build.build_log.get("ar_stack", "").splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"[build] {line.strip()}")
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    gen = torch.Generator().manual_seed(19)
    ws, bs, _ = _paper_chain(2, gen)
    out = {}
    for label, n, dtype, save_pre in (
            ("N=2 f32", 2, torch.float32, False),
            ("N=16 bf16", 16, torch.bfloat16, False),
            ("b32 bf16", 32, torch.bfloat16, True),
            ("b32 f32", 32, torch.float32, True),
            ("N=1024 bf16", 1024, torch.bfloat16, False),
            ("N=1024 f32", 1024, torch.float32, False)):
        z = torch.randn(n, 16, 16, 32, generator=gen)
        ctx = torch.randn(n, 16, 16, 160, generator=gen)
        args = (z.cuda().to(dtype), ctx.cuda(),
                [w.cuda().to(dtype) for w in ws], [b.cuda() for b in bs])
        out[label] = k1_plans(ops, ar_mod, label, *args, save_pre,
                              candidates=True)
    print(json.dumps({"plans": out}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def glue_only() -> int:
    """``--glue``: phase 3(b), the fused passes against their twins with
    their kernels rows, and 3(c), an eval chunk through the fused and the
    plain route, at the paper and the 5x5 configs (random weights from a
    data-dependent init); about two minutes."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from iaf_torch import ops
    from iaf_torch.core.config import Config
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import cvae
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    out = {"kernels": glue_phase(ops, device)}
    for label, hp in (("paper", PAPER), ("5x5", PAPER5)):
        cfg = Config().parse(hp + ",dataset=synthetic")
        ds = synthetic_dataset(cfg.image_size, cfg.channels)
        model = cvae.init_params(cfg, ds.train_x[:32], rng=cfg.seed,
                                 device=device)
        out[label] = glue_route_phase(cfg, model, ds.test_x[:EVAL_BATCH],
                                      EVAL_CHUNK, label)
        del model
    print(json.dumps({"glue": out}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k2_plans_only() -> int:
    """``--k2-plans``: K2's builds (forward, backward; K1's backward for
    its dgrad pack) with their ptxas lines, then on the three 5x5 AR convs
    at the paper widths from a seed ``k2_plans`` in bf16 and f32 at N = 1,
    2, 16, 32 (with the A B B A) and 1024, and ``dgrad_plans`` at batch 32
    for K2's convs and K1's chain."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from iaf_torch import ops
    from iaf_torch.ops import _build
    from iaf_torch.ops import masked_conv as mc
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("masked_conv", "masked_conv_bwd", "ar_stack_bwd")
    threads = [threading.Thread(target=_build.load, args=(n,))
               for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in names:
        print(f"[build] nvcc {name}.cu "
              f"{_build.build_seconds.get(name, 0):.1f} s")
        for line in _build.build_log.get(name, "").splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"[build] {line.strip()}")
    out = {}
    for n in (1, 2, 16, 32, 1024):
        for f32 in (False, True):
            for label, (x, w, taps) in _k2_f32_convs(n, 21).items():
                if not f32:
                    x, w = x.bfloat16(), w.bfloat16()
                tag = f"K2 {'f32' if f32 else 'bf16'} N={n}"
                out[f"{tag} {label}"] = k2_plans(ops, tag, x, w, taps,
                                                 abba=n == 32)
    for f32 in (False, True):
        convs = []
        for label, (x, w, taps) in _k2_f32_convs(32, 22).items():
            if not f32:
                w = w.bfloat16()
            taps = mc._taps(w, taps)
            kh, kw, cin, cout = w.shape
            g = torch.randn(*x.shape[:3], cout, generator=torch.Generator()
                            .manual_seed(24)).to(x.device, w.dtype)
            convs.append((f"K2 {label}", g, mc.dgrad_pack(w, taps, f32),
                          cin, mc._mirrored(taps, kh, kw), kh, kw))
        out[f"dgrad {'f32' if f32 else 'bf16'}"] = dgrad_plans(
            ops, f"b32 {'f32' if f32 else 'bf16'}",
            convs + k1_dgrad_convs(f32))
    print(json.dumps({"k2_plans": out}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k1_f32_phase(ops, cap) -> dict:
    """K1 in f32 (the f32 recipe) on the inputs of one real f32 eval chunk
    (16 images x 64 samples: the posterior samples and the folded weights
    carry full f32 mantissas, where an upcast from bf16 would leave the
    low 16 bits zero and so hide a kernel that drops the lo parts): at
    N = 1024 and at the training shape (the first 32 images with the
    pre-activations written), each as ``_k1_f32_shape``; the f32 weight
    pack kernel bitwise equal to its twin (offsets too) on the model's
    weights and on contiguous copies. Returns the kernels-line row."""
    import torch
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    z, ctx, ws, bs, masks = cap["ar_stack"]
    _full_f32("K1 f32", z, *ws)
    with torch.inference_mode():
        want, offsets = ar_mod.pack_fwd_ref(ws)
        for group in (ws, [w.contiguous() for w in ws]):
            packed, got_offsets = ar_mod.pack_fwd(group)
            check(got_offsets == offsets and torch.equal(packed, want),
                  "K1: the f32 weight pack kernel differs from its twin")
    print(f"[K1 f32] forward weight pack kernel, all convs (the model's "
          f"weights, contiguous: {ws[0].is_contiguous()}, and contiguous "
          f"copies): bitwise equal to its twin, offsets {offsets}")
    row = _k1_f32_shape(ops, ar_mod, f"N={z.shape[0]}", z, ctx, ws, bs,
                        masks, False)
    b32 = _k1_f32_shape(ops, ar_mod, "b32", z[:32].contiguous(),
                        ctx[:32].contiguous(), ws, bs, masks, True)
    row.update({k + "_b32": v for k, v in b32.items()})
    row["plans"] = k1_plans(ops, ar_mod, f"N={z.shape[0]} f32", z, ctx, ws,
                            bs, False)
    row["plans_b32"] = k1_plans(ops, ar_mod, "b32 f32", z[:32].contiguous(),
                                ctx[:32].contiguous(), ws, bs, True)
    return dict(name="ar_stack_f32", route="cuda",
                source="iaf_torch/ops/csrc/ar_stack.cu",
                replaces="iaf_tpu/ops/ar_stack.py:115", path="paper f32",
                counter="ar_stack", kernel_route="3xtf32", **row)


@contextlib.contextmanager
def k1_routes():
    """Record the route of every K1 forward (``fwd_route``) and backward
    (``bwd_route``) launched inside the block, in order."""
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    fwd, bwd = ar_mod._fwd, ar_mod.ar_stack_bwd
    seen = {"fwd": [], "bwd": []}

    def spy_fwd(z, context, weights, biases, save_pre):
        seen["fwd"].append(ar_mod.fwd_route(
            z.dtype, z.shape[2], z.shape[3], weights[0].shape[-1],
            weights[-1].shape[-1]))
        return fwd(z, context, weights, biases, save_pre)

    def spy_bwd(z, weights, pre, g):
        seen["bwd"].append(ar_mod.bwd_route(z, weights))
        return bwd(z, weights, pre, g)
    ar_mod._fwd, ar_mod.ar_stack_bwd = spy_fwd, spy_bwd
    try:
        yield seen
    finally:
        ar_mod._fwd, ar_mod.ar_stack_bwd = fwd, bwd


@contextlib.contextmanager
def k1_bwd_fma():
    """Inside the block K1's backward takes its FMA kernels (what the f32
    recipe ran before the 3xTF32 route: its yardstick in the same run)."""
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    original = ar_mod._bwd_route
    ar_mod._bwd_route = lambda dtype, h, w_, shapes: (("fma", "fma"),) * len(
        shapes)
    try:
        yield
    finally:
        ar_mod._bwd_route = original


def k1_forward(ops, ar_mod, z, ctx, ws, bs, masks, label: str) -> dict:
    """K1's bf16 forward on these inputs: the tensor-core route, two calls
    bitwise equal, within 2e-2 of the twin's max; its device kernels per
    call, timed by events and by device time beside the twin and cuDNN's
    three convs; the bound (bf16 operations, the live weight taps)."""
    import torch
    n, hh, ww, cz = z.shape
    route = ar_mod.fwd_route(z.dtype, ww, cz, ws[0].shape[-1],
                             ws[-1].shape[-1])
    check(route == "wgmma", f"{label} bf16 z{tuple(z.shape)} takes the "
          f"{route} kernel, not the tensor-core one")
    call = lambda: ops.ar_stack(z, ctx, ws, bs, masks)  # noqa: E731
    with torch.inference_mode():
        got = call()
        check(torch.equal(got, call()), f"{label}: two bf16 calls differ")
        ref = ops.ar_stack_ref(z, ctx, ws, bs)
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        print(f"[{label}] ar_stack z{tuple(z.shape)} ctx{tuple(ctx.shape)} "
              f"-> {tuple(got.shape)} ({route}): bf16 max abs err "
              f"{err:.3e} (rel {rel:.3e}), two calls bitwise equal")
        check(rel <= 2e-2, f"{label} bf16 rel err {rel} > 2e-2")
        per_call = _by_kernel(label, call)
        ms = cuda_ms(call)
        dev_ms = device_ms(call)
        plain = cuda_ms(lambda: ops.ar_stack_ref(z, ctx, ws, bs))
        lib = cuda_ms(lambda: k1_yardstick(z, ctx, ws, bs))
        lib_dev = device_ms(lambda: k1_yardstick(z, ctx, ws, bs))
    flops = 2 * n * hh * ww * 5 * sum(w.shape[2] * w.shape[3] for w in ws)
    live_w = sum(5 * w[0, 0].numel() * w.element_size() for w in ws)
    moved = nbytes(z, ctx, got, *bs) + live_w
    b_ms, b_by = bound_ms(flops, "bfloat16", moved)
    print(f"[{label}] N={n}: by events {ms:.4f} ms, by device time "
          f"{dev_ms:.4f} ms ({per_call} device launches a call), cuDNN "
          f"{lib_dev:.4f}, ratio {dev_ms / lib_dev:.3f}; bound {b_ms:.4f} ms "
          f"({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, device_ms=dev_ms,
                library_device_ms=lib_dev, gflop=flops / 1e9,
                mbytes=moved / 1e6, kernel_route=route,
                device_launches_per_call=per_call)


def k3_forward(ops, a, label: str) -> dict:
    """K3's division update on these inputs: within 1e-6 * (1 + |ref|) of
    its twin, timed by events and by device time beside the twin; the
    bound from the bytes (each input once, both outputs)."""
    import torch
    with torch.inference_mode():
        got = ops.iaf_update(*a)
        ref = ops.iaf_update_ref(*a)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        ok = all(bool(((g - r).abs() <= 1e-6 * (1 + r.abs())).all())
                 for g, r in zip(got, ref))
        print(f"[{label}] iaf_update {tuple(a[0].shape)}: max abs err "
              f"{err:.3e}")
        check(ok, f"{label} err {err} beyond 1e-6 * (1 + |ref|)")
        ms = cuda_ms(lambda: ops.iaf_update(*a))
        dev_ms = device_ms(lambda: ops.iaf_update(*a))
        plain = cuda_ms(lambda: ops.iaf_update_ref(*a))
    b_ms, b_by = bound_ms(4 * a[0].numel(), "float32", nbytes(*a, *got))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, device_ms=dev_ms,
                mbytes=nbytes(*a, *got) / 1e6)


def kernel_phase(ops, cap, device) -> list[dict]:
    import torch
    rows = []

    # K1: the AR chain of the first IAF step of the chunk (bf16 inputs)
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    z, ctx, ws, bs, masks = cap["ar_stack"]
    k1 = k1_forward(ops, ar_mod, z, ctx, ws, bs, masks, "K1")
    with torch.inference_mode():
        z32, ws32 = z.float(), [w.float() for w in ws]
        got32 = ops.ar_stack(z32, ctx, ws32, bs, masks)
        ref32 = ops.ar_stack_ref(z32, ctx, ws32, bs)
        err_f32 = float((got32 - ref32).abs().max())
        scale32 = max(1.0, float(ref32.abs().max()))
        print(f"[K1] the same inputs in f32: max abs err {err_f32:.3e}")
        check(err_f32 <= 1e-4 * scale32, f"K1 f32 err {err_f32} > 1e-4")
        want, offsets = ar_mod.pack_fwd_ref(ws)
        for group in (ws, [w.contiguous() for w in ws]):
            packed, got_offsets = ar_mod.pack_fwd(group)
            check(got_offsets == offsets and torch.equal(packed, want),
                  "K1: the forward weight pack kernel differs from its twin")
        print(f"[K1] forward weight pack kernel, all convs (the model's "
              f"weights, contiguous: {ws[0].is_contiguous()}, and contiguous "
              f"copies): bitwise equal to its twin, offsets {offsets}")
        ms32 = cuda_ms(lambda: ops.ar_stack(z32, ctx, ws32, bs, masks))
    train = _k1_training_shape(ops, ar_mod, z, ctx, ws, bs)
    plans = {"plans": k1_plans(ops, ar_mod, "N=1024 bf16", z, ctx, ws, bs,
                               False),
             "plans_b32": k1_plans(ops, ar_mod, "b32 bf16",
                                   z[:32].contiguous(), ctx[:32].contiguous(),
                                   ws, bs, True)}
    rows.append(dict(
        name="ar_stack", route="cuda", source="iaf_torch/ops/csrc/ar_stack.cu",
        replaces="iaf_tpu/ops/ar_stack.py:115", max_abs_err_f32=err_f32,
        ms_f32=ms32, **k1, **train, **plans))

    # K3: the division update of the same IAF step
    rows.append(dict(
        name="iaf_update", route="triton", source="iaf_torch/ops/fused.py",
        replaces="iaf_tpu/ops/fused.py:43",
        **k3_forward(ops, cap["iaf_update"], "K3")))

    # K4: the chunk's likelihood
    mean, logscale, sample = cap["disc_logistic_logp"]
    rows.append(dict(
        name="disc_logistic_logp", route="cuda",
        source="iaf_torch/ops/csrc/disc_logistic.cu",
        replaces="iaf_tpu/ops/fused.py:103",
        **k4_forward(ops, mean, logscale, sample, "K4")))
    return rows


def k4_forward(ops, mean, logscale, sample, label: str) -> dict:
    """K4's forward on these inputs: held to its twin at 1e-5 per row, the
    same bits on two calls, its device kernels per call, timed by events
    and by device time (also at every split S) beside the twin; the
    bound from the bytes (each input once, the sums out) and 15 FP32
    operations an element."""
    import torch
    fused = importlib.import_module("iaf_torch.ops.fused")
    n, row_len = mean.shape[0], mean[0].numel()
    plan = ops.dl_plan(n, row_len)
    call = lambda: ops.disc_logistic_logp(mean, logscale, sample)  # noqa: E731
    with torch.inference_mode():
        got = call()
        check(torch.equal(got, call()), f"{label}: two calls differ")
        ref = ops.disc_logistic_ref(mean, logscale, sample)
        err = float((got - ref).abs().max())
        rel = float(((got - ref).abs() / ref.abs()).max())
        print(f"[{label}] disc_logistic_logp {tuple(mean.shape)}, S = {plan}"
              f": max abs err {err:.3e} (rel {rel:.3e}), two calls bitwise "
              "equal")
        check(rel <= 1e-5, f"{label} rel err {rel} > 1e-5")
        per_call = _by_kernel(label, call)
        ms = cuda_ms(call)
        dev_ms = device_ms(call)
        by_split = {s_: device_ms(lambda s_=s_: fused._dl_fwd(
            mean, logscale, sample, 1.0 / 256.0, splits=s_))
            for s_ in (1, 2, 4, 8)}
        plain = cuda_ms(lambda: ops.disc_logistic_ref(mean, logscale, sample))
    moved = nbytes(mean, sample, got, logscale)
    b_ms, b_by = bound_ms(15 * mean.numel(), "float32", moved)
    print(f"[{label}] N={n}: by events {ms:.4f} ms, by device time "
          f"{dev_ms:.4f} ms ({per_call} device launches a call; by S "
          + ", ".join(f"{k} {v:.4f}" for k, v in by_split.items())
          + f"), plain {plain:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
          f"{100 * b_ms / dev_ms:.0f} % of it)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, device_ms=dev_ms,
                mbytes=moved / 1e6, splits=plan,
                device_launches_per_call=per_call,
                splits_device_ms=by_split)


# the fused inference passes (``iaf_torch.ops.glue``), phase 3(b)
GLUE_ZS, GLUE_HS, GLUE_HW = 32, 160, 16     # the paper's latents, 16x16
GLUE_PADS = (0, 1, 2)   # the deconv's input, the 3x3 and the 5x5 convs'


def _bf16_steps(a, b):
    """Distance in representable bf16 values, elementwise."""
    import torch

    def key(t):
        i = t.contiguous().view(torch.int16).long()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def _gauss_tol(x, mean, logvar, eps=None):
    """4 ulp of f32 on the largest term of DiagonalGaussian.logps (and of
    sample, given eps): exp's 2 ulp can cancel in the sums."""
    import torch
    glue = importlib.import_module("iaf_torch.ops.glue")
    u = torch.finfo(torch.float32).eps
    t = torch.square(x - mean) * torch.exp(-logvar)
    lp = 4 * u * ((logvar + glue._LOG2PI).abs() + t.abs())
    if eps is None:
        return lp
    return lp, 4 * u * (mean.abs() + (torch.exp(0.5 * logvar) * eps).abs())


def glue_check(op: str, args, got, want) -> list[int]:
    """One call of the fused pass ``op`` (a counter of
    ``ops.glue.launches``) against its twin's outputs on the same inputs:
    the residual h' and K1's context bitwise; every bf16 output within 1
    bf16 step (ELU's 2 ulp of f32 before rounding) and its border zero; z
    and log q within 4 ulp of f32 of their largest term; the KL sums
    within their terms' tolerances and f32 summation in another order;
    the h_det half of the join against ELU(h_det + b) from the raw output.
    Returns, per output, how many elements differ from the twin's bits."""
    import torch
    import torch.nn.functional as F
    glue = importlib.import_module("iaf_torch.ops.glue")
    label = f"glue {op} {tuple(args[0].shape)}"
    check(len(got) == len(want), f"{label}: {len(got)} outputs")
    pad = args[-1] if op != "posterior" else 0
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{label} output {i}: {a.shape} {a.dtype}, twin {b.shape} "
              f"{b.dtype}")
        if a.dtype == torch.bfloat16:
            check(int(_bf16_steps(a, b).max()) <= 1,
                  f"{label} output {i}: beyond 1 bf16 step of the twin")
        if a.dtype == torch.bfloat16 and pad:
            inner = a.float().clone()
            inner[:, pad:-pad, pad:-pad] = 0
            check(not inner.any(), f"{label} output {i}: border not zero")
    if op == "residual_elu":
        check(torch.equal(got[0], want[0]), f"{label}: h' not bitwise")
    if op == "posterior":
        down, db, up, ub, eps = args
        zs = eps.shape[-1]
        u, d = up.float() + ub, down.float() + db
        mean = u[..., :zs] + d[..., 2 * zs:3 * zs]
        logvar = 2.0 * (u[..., zs:2 * zs] + d[..., 3 * zs:4 * zs])
        lp_tol, z_tol = _gauss_tol(want[0], mean, logvar, eps)
        check(bool(((got[0] - want[0]).abs() <= z_tol).all()),
              f"{label}: z beyond 4 ulp of its largest term")
        check(torch.equal(got[1], got[0].to(torch.bfloat16)),
              f"{label}: bf16 z is not z rounded")
        check(bool(((got[2] - want[2]).abs() <= lp_tol).all()),
              f"{label}: log q beyond 4 ulp of its largest term")
        check(torch.equal(got[3], want[3]), f"{label}: context not bitwise")
    if op == "kl_join":
        z, lq, down, db, pad = args
        zs = z.shape[-1]
        d = down.float() + db
        lp_tol = _gauss_tol(z, d[..., :zs], 2.0 * d[..., zs:2 * zs])
        kl = lq - glue.DiagonalGaussian(d[..., :zs],
                                        2.0 * d[..., zs:2 * zs]).logps(z)
        # each term within its tolerance, then f32 sums in another order
        row_tol = lp_tol.sum((1, 2)) + 1e-5 * kl.abs().sum((1, 2))
        check(bool(((got[0] - want[0]).abs() <= row_tol).all()),
              f"{label}: KL sums beyond their tolerance")
        check(bool(((got[1] - want[1]).abs() <= row_tol.sum(1)
                    + 1e-5 * kl.abs().sum((1, 2, 3))).all()),
              f"{label}: KL totals beyond their tolerance")
        hs = (down.shape[-1] - 4 * zs) // 2
        hdet = glue.padded(F.elu(d[..., 4 * zs + hs:]).to(torch.bfloat16),
                           pad)
        check(int(_bf16_steps(got[2][..., zs:], hdet).max()) <= 1,
              f"{label}: the join's h_det half")
    return [int((a != b).sum()) for a, b in zip(got, want)]


def glue_cases(n: int, device, pad: int, seed: int):
    """Per fused pass at n rows, the paper's widths and this conv border:
    (op, args, twin, the bytes it must move). Raw conv outputs bf16 (2
    bytes a channel), states f32; each channel a pass reads or writes
    counted once, the biases once."""
    import torch
    glue = importlib.import_module("iaf_torch.ops.glue")
    zs, hs, hw = GLUE_ZS, GLUE_HS, GLUE_HW
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g, device=device)
                * scale).to(dtype)
    bf = torch.bfloat16
    pix = (n, hw, hw)
    p, pp = n * hw * hw, n * (hw + 2 * pad) ** 2
    h, conv, b = r(*pix, hs), r(*pix, hs, dtype=bf), r(hs, scale=0.3)
    up, ub = r(*pix, 2 * zs + 2 * hs, dtype=bf), r(2 * zs + 2 * hs,
                                                   scale=0.3)
    down = r(*pix, 4 * zs + 2 * hs, dtype=bf, scale=0.5)
    db = r(4 * zs + 2 * hs, scale=0.3)
    eps, z, lq = r(*pix, zs), r(*pix, zs), r(*pix, zs)
    h_top = r(hs).expand(*pix, hs)
    return {
        "elu_bf16": (glue.elu_bf16_op, (h, pad), glue.elu_bf16_ref,
                     p * 4 * hs + pp * 2 * hs),
        "elu_bf16_h_top": (glue.elu_bf16_op, (h_top, pad),
                           glue.elu_bf16_ref, 4 * hs + pp * 2 * hs),
        "residual_elu": (glue.residual_elu_op, (h, conv, b, pad),
                         glue.residual_elu_ref,
                         p * (4 + 2 + 4) * hs + pp * 2 * hs + 4 * hs),
        "residual_elu_h_top": (glue.residual_elu_op, (h_top, conv, b, pad),
                               glue.residual_elu_ref,
                               p * (2 + 4) * hs + pp * 2 * hs + 8 * hs),
        "up_stats": (glue.up_stats_op, (up, ub, hs, pad), glue.up_stats_ref,
                     p * 2 * hs + pp * 2 * hs + 4 * hs),
        "posterior": (glue.posterior_op, (down, db, up, ub, eps),
                      glue.posterior_ref,
                      p * (2 * 2 * (2 * zs + hs) + 4 * zs
                           + (4 + 2 + 4) * zs + 4 * hs)
                      + 4 * (2 * zs + hs) * 2),
        "kl_join": (glue.kl_join_op, (z, lq, down, db, pad),
                    glue.kl_join_ref,
                    p * (2 * 4 * zs + 2 * (2 * zs + hs))
                    + pp * 2 * (zs + hs) + 4 * (2 * zs + hs)
                    + n * (zs + 1) * 4)}


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


# the kernels rows of the fused passes: name (the counter), case at the
# paper's border (pad 1), the Triton kernel
GLUE_ROWS = (("elu_bf16", "elu_bf16_h_top", "glue_residual_elu_kernel"),
             ("residual_elu", "residual_elu", "glue_residual_elu_kernel"),
             ("up_stats", "up_stats", "glue_up_stats_kernel"),
             ("posterior", "posterior", "glue_posterior_kernel"),
             ("kl_join", "kl_join", "glue_kl_join_kernel"))


def glue_phase(ops, device) -> list[dict]:
    """Phase 3(b): each fused pass on card tensors at the eval chunk's N =
    1024 rows and the serving N = 16, the paper's widths, with no border
    (the deconv's input), the 3x3 convs' and the 5x5 convs': held to its
    twin run on the card on the same inputs (``glue_check``), the same
    bits on two calls, one launch a call. At the paper's border each is
    timed by events and by device time beside its twin, with its bytes
    bound at 3.35 TB/s; one kernels row a pass (N = 16 under ``*_n16``).
    """
    import torch
    glue = importlib.import_module("iaf_torch.ops.glue")
    timed: dict = {}
    with torch.inference_mode():
        for n in (1024, 16):
            for pad in GLUE_PADS:
                for case, (op, args, twin, moved) in glue_cases(
                        n, device, pad, 7000 + 10 * n + pad).items():
                    name = case.removesuffix("_h_top")
                    ops.reset_launch_counts()
                    got = _flat(op(*args))
                    check(ops.launch_counts()[name] == 1,
                          f"glue {case}: {ops.launch_counts()}")
                    differ = glue_check(name, args, got, _flat(twin(*args)))
                    check(all(torch.equal(a, b) for a, b in
                              zip(_flat(op(*args)), got)),
                          f"glue {case} n={n} pad={pad}: two calls differ")
                    print(f"[glue] {case} n={n} pad={pad}: elements apart "
                          f"from the twin's bits, per output {differ} of "
                          f"{[a.numel() for a in got]}")
                    if pad == 1:
                        timed[case, n] = dict(
                            ms=cuda_ms(lambda: op(*args)),
                            device_ms=device_ms(lambda: op(*args)),
                            plain_ms=cuda_ms(lambda: twin(*args)),
                            bound_ms=bound_ms(0, "float32", moved)[0],
                            mbytes=moved / 1e6, differ=differ)
    rows = []
    for name, case, kernel in GLUE_ROWS:
        big, small = timed[case, 1024], timed[case, 16]
        rows.append(dict(
            name=name, route="triton", source="iaf_torch/ops/glue.py",
            kernel=kernel, replaces=None, library_ms=None, bound_by="bytes",
            **big, **{f"{k}_n16": v for k, v in small.items()}))
        share = 100 * big["bound_ms"] / big["device_ms"]
        print(f"[glue] {name} ({case}): device {big['device_ms']:.4f} ms, "
              f"N = 16 {small['device_ms']:.4f} ms; bound "
              f"{big['bound_ms']:.4f} ({share:.0f} % of it), "
              f"{small['bound_ms']:.4f}; twin {big['plain_ms']:.4f}, "
              f"{small['plain_ms']:.4f} ms")
    return rows


def glue_route_phase(cfg, model, x, k: int, label: str) -> dict:
    """Phase 3(c) (11 for the 5x5 config): one bf16 eval chunk (the images
    ``x``, k samples each) eagerly through the fused passes, and again
    with ``cvae.fused_route`` forced off (the plain passes), same weights
    and noise: per output of the forward, the elements apart and the
    largest difference. The bound (``elbo_nats``) within 4 ulp of f32 of
    the plain route's: the passes are their twins' arithmetic but for the
    KL sums' order (an H100 read 1 ulp for 1 of 16 images, 6.1e-5 nats in
    3 of 20 layers' mean KL); the decoder's output bitwise."""
    import torch
    from unittest import mock
    from iaf_torch.models import cvae
    with torch.inference_mode():
        check(cvae.fused_route(model, torch.bfloat16),
              f"{label}: the eval chunk does not take the fused route")
        fused = cvae.apply_fn(cfg, model, 5, x, mode="eval", k=k)
        with mock.patch.object(cvae, "fused_route",
                               lambda model, dtype: False):
            plain = cvae.apply_fn(cfg, model, 5, x, mode="eval", k=k)
    out = {}
    for field, a, b in zip(fused._fields, fused, plain):
        out[field] = dict(apart=int((a != b).sum()), of=a.numel(),
                          max_abs=float((a - b).abs().max()))
    print(f"[glue] {label}: {x.shape[0]} images x {k}, fused route against "
          f"the plain one: {out}")
    ulp = torch.finfo(torch.float32).eps * plain.elbo_nats.abs()
    check(bool(((fused.elbo_nats - plain.elbo_nats).abs() <= 4 * ulp).all()),
          f"{label}: the fused route's bound is {out['elbo_nats']} apart")
    check(out["x_out"]["apart"] == 0, f"{label}: the decoder's output")
    return out


def profile_phase(label: str, fn) -> dict:
    """Where one call of ``fn`` spends its device time: torch.profiler's
    self device time per kernel name, top 14, and the device-busy share
    of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)   # see device_kernels: the recording starts late
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = _device_events(prof)
    busy = sum(t for _, t, _ in dev) / 1e6
    print(f"[profile] {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy * 1e3:.3f} ms ({100 * busy / wall:.1f} %)")
    for key, t, count in sorted(dev, key=lambda d: -d[1])[:14]:
        print(f"[profile] {t / 1e3:10.4f} ms {100 * t / 1e6 / busy:5.1f} % "
              f"x{count:<5d} {key[:90]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy * 1e3}


def reference_phase(device, hp: str = PAPER) -> None:
    """One f32 eval forward of the config ``hp`` on the card (kernels)
    against the same forward on the CPU (plain twins), same noise."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import cvae
    cfg = Config().parse(hp + ",compute_dtype=float32")
    x = synthetic_dataset(32, 3, n_train=8, n_test=2, seed=5).test_x
    gpu = cvae.init_params(cfg, x, rng=17, device=device)
    cpu = cvae.CVAE(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    k = 4
    g = torch.Generator().manual_seed(3)
    noise = {f"{n}/z_post": torch.randn((2 * k, 16, 16, 32), generator=g)
             for n in cvae.layer_names(cfg)}
    with torch.inference_mode():
        a = cvae.apply_fn(cfg, gpu, 0, x, mode="eval", k=k,
                          noise={n: t.to(device) for n, t in noise.items()})
        b = cvae.apply_fn(cfg, cpu, 0, x, mode="eval", k=k, noise=noise)
    lw_a, lw_b = a.log_w.cpu(), b.log_w
    rel = float(((lw_a - lw_b).abs() / lw_b.abs()).max())
    print(f"[reference] {_label(cfg)} f32 eval forward, card vs CPU twins: "
          f"log_w "
          f"{lw_b.tolist()}, max rel err {rel:.3e}")
    check(bool(torch.isfinite(lw_a).all()), "non-finite log_w on the card")
    check(rel <= 1e-5, f"card vs CPU log_w rel err {rel} > 1e-5")


def _detach(a):
    import torch
    if torch.is_tensor(a):
        return a.detach().clone()
    if isinstance(a, (list, tuple)):
        return type(a)(_detach(x) for x in a)
    return a


def build_phase(ops, device) -> None:
    """Build every CUDA source at once (one nvcc each, in one thread each)
    and launch every Triton kernel once on tiny inputs (its compile)."""
    import torch
    from iaf_torch.ops import _build
    t0 = time.perf_counter()
    names = ("ar_stack", "ar_stack_bwd", "masked_conv", "masked_conv_bwd",
             "disc_logistic")
    errors: dict[str, str] = {}

    def build(name):
        try:
            _build.load(name)
        except (RuntimeError, OSError) as e:   # reported below
            errors[name] = str(e)

    threads = [threading.Thread(target=build, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"build failed: {errors}")
    for name in names:
        print(f"[build] nvcc {name}.cu {_build.build_seconds.get(name, 0):.1f}"
              " s")
        for line in _build.build_log.get(name, "").splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"[build] {line.strip()}")
    t1 = time.perf_counter()
    a = torch.randn(4, 8, device=device)
    one = torch.zeros((1,), device=device)
    with torch.inference_mode():
        ops.iaf_update(a, a, a, a)
        ops.disc_logistic_logp(a, one, a)
        ops.iaf_update_bwd(a, a, a, a)
        ops.disc_logistic_bwd(a, one, a, a[:, 0].contiguous())
        ops.adamax_polyak([a.clone()], [a], [a.clone()], [a.abs()],
                          [a.clone()], one[0] + 1e-3, beta1=0.9, beta2=0.999,
                          eps=1e-8, polyak_decay=0.999)
    torch.cuda.synchronize()
    print(f"[build] triton K3 (forward and backward) and K5 first launches, "
          f"with K4's CUDA kernels, {time.perf_counter() - t1:.1f} s; all "
          f"builds {time.perf_counter() - t0:.1f} s")
    _triton_registers()


def _triton_registers() -> None:
    """Registers and spills of each compiled Triton kernel, where the
    installed Triton exposes them."""
    from iaf_torch.ops import fused, fused_adamax
    fns = list(fused._kernels()) + [fused_adamax._kernel()]
    for fn in fns:
        caches = getattr(fn, "device_caches", None)
        kernels = []
        if isinstance(caches, dict):
            for entry in caches.values():
                cache = entry[0] if isinstance(entry, tuple) else entry
                if isinstance(cache, dict):
                    kernels += list(cache.values())
        name = getattr(fn, "__name__", getattr(getattr(fn, "fn", None),
                                               "__name__", "?"))
        for k in kernels:
            print(f"[build] triton {name}: {getattr(k, 'n_regs', '?')} "
                  f"registers, {getattr(k, 'n_spills', '?')} spills")
        if not kernels:
            print(f"[build] triton {name}: registers not reported")


def capture_train_step(ops, fn):
    """Run ``fn`` (one training step) with spies on the K1 and K3 forward
    wrappers (every call, keyed by the tensor their backward saves) and on
    the three backward wrappers (the first call); return, per backward,
    (its forward's arguments, its own arguments), all detached copies."""
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    fused_mod = importlib.import_module("iaf_torch.ops.fused")
    fwd_key = {"ar_stack": 0, "iaf_update": 2}     # z, s
    bwd_key = {"ar_stack_bwd": (ar_mod, 0), "iaf_update_bwd": (fused_mod, 1),
               "disc_logistic_bwd": (fused_mod, None)}
    fwd = {n: {} for n in fwd_key}
    bwd: dict[str, tuple] = {}
    originals = {n: getattr(ops, n) for n in fwd_key}
    originals.update({n: getattr(mod, n) for n, (mod, _) in bwd_key.items()})

    def spy_fwd(name):
        def wrapped(*args):
            fwd[name][args[fwd_key[name]].data_ptr()] = _detach(args)
            return originals[name](*args)
        return wrapped

    def spy_bwd(name):
        def wrapped(*args):
            if name not in bwd:
                ki = bwd_key[name][1]
                bwd[name] = (_detach(args),
                             None if ki is None else args[ki].data_ptr())
            return originals[name](*args)
        return wrapped

    for n in fwd_key:
        setattr(ops, n, spy_fwd(n))
    for n, (mod, _) in bwd_key.items():
        setattr(mod, n, spy_bwd(n))
    try:
        fn()
    finally:
        for n in fwd_key:
            setattr(ops, n, originals[n])
        for n, (mod, _) in bwd_key.items():
            setattr(mod, n, originals[n])
    check(set(bwd) == set(bwd_key), f"captured only {sorted(bwd)}")
    k1_args, k1_ptr = bwd["ar_stack_bwd"]
    k3_args, k3_ptr = bwd["iaf_update_bwd"]
    check(k1_ptr in fwd["ar_stack"] and k3_ptr in fwd["iaf_update"],
          "a backward's saved tensor matches no captured forward")
    return {"ar_stack": (fwd["ar_stack"][k1_ptr], k1_args),
            "iaf_update": (fwd["iaf_update"][k3_ptr], k3_args),
            "disc_logistic_logp": bwd["disc_logistic_bwd"][0]}


def _rel_err(got, want) -> tuple[float, float]:
    """(max abs error, that over the reference's max magnitude)."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def _backward_ms(fn, leaves, g, timer=cuda_ms) -> float:
    """Time (``timer``: by events or ``device_ms``) of the backward alone
    of ``fn(*leaves)`` for cotangent ``g``: the graph is built once and
    differentiated repeatedly."""
    import torch
    with torch.enable_grad():
        out = fn(*leaves)
        return timer(lambda: torch.autograd.grad(out, leaves, g,
                                                 retain_graph=True))


def _k1_live(device):
    """1 at the 5 live taps of a 3x3 AR conv, 0 at the 4 dead ones."""
    import torch
    live = torch.zeros(3, 3, 1, 1, device=device)
    live[0], live[1, :2] = 1.0, 1.0
    return live


def _k1_bwd_errs(got, want) -> list[tuple[str, float, float]]:
    """(name, max abs error, that over the reference's max) of dz,
    dcontext, each dW at the live taps and each db of K1's backward."""
    dz, dctx, dws, dbs = got
    rz, rctx, rws, rbs = want
    live = _k1_live(dz.device)
    pairs = [("dz", dz, rz), ("dcontext", dctx, rctx)]
    pairs += [(f"dW{i}", a.float() * live, b.float() * live)
              for i, (a, b) in enumerate(zip(dws, rws))]
    pairs += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, rbs))]
    return [(name, *_rel_err(a, b)) for name, a, b in pairs]


def _k1_grads_close(ops, got, want, tol, label) -> float:
    """Each of dz, dcontext, dW (at the live taps; the kernel's dead taps
    must be zero) and db within ``tol`` of its reference's max. Returns
    the largest absolute error."""
    live = _k1_live(got[0].device)
    for i, a in enumerate(got[2]):
        check(not bool((a.float() * (1 - live)).any()),
              f"K1 bwd {label}: dW{i} nonzero at a dead tap")
    worst_abs, worst_rel = 0.0, 0.0
    for name, err, rel in _k1_bwd_errs(got, want):
        check(rel <= tol, f"K1 bwd {label} {name}: {rel:.3e} of max > {tol}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    print(f"[K1 bwd] {label}: max abs err {worst_abs:.3e}, worst "
          f"{worst_rel:.3e} of an output's max (limit {tol})")
    return worst_abs


def _glue_check(ar_mod, g, pre, f32: bool = False) -> None:
    """The glue kernel against its twin at the main path's shapes: the
    head pass on the step's f32 G and a hidden pass on a dX from a seed
    (bf16, or with ``f32`` f32) with the step's pre-activation. G in f32
    within 1e-6 of its max (expf against torch.exp); in bf16 G (NHWC and
    packed) within one bf16 rounding of each element, bf16(ELU(pre)) too,
    give or take 4e-7 (the forward's fast exponential against expm1 near
    0); in f32 G NHWC and packed within 1e-6 of max and ELU(pre) within
    4e-7; the db sums within 1e-5 of max."""
    import torch
    gen = torch.Generator(device=g.device).manual_seed(21)
    dx = torch.randn(pre.shape, generator=gen, device=g.device)
    if not f32:
        dx = dx.bfloat16()
    tag = "f32 " if f32 else ""
    for label, src, p in (("head", g, None), ("hidden", dx, pre)):
        gt, gp, g32, x, dbp = ar_mod.glue(src, p, True, f32)
        rt, rp, r32, rx, rdb = ar_mod.glue_ref(src, p, f32)
        scale = max(1.0, float(r32.abs().max()))
        errs = {"g32": _rel_err(g32, r32)[0] / scale,
                "db": _rel_err(dbp.sum(0), rdb)[1]}
        for nm, a, b, slack in (("gt", gt, rt, 0.0), ("gp", gp, rp, 0.0)) + (
                (("x", x, rx, 4e-7),) if p is not None else ()):
            d = (a.float() - b.float()).abs()
            errs[nm] = float(d.max())
            if f32:
                ok = errs[nm] <= (4e-7 if nm == "x" else 1e-6 * scale)
            else:
                ok = bool((d <= 2 ** -7 * b.float().abs() + slack).all())
            check(ok, f"glue {tag}{label} {nm}: {errs[nm]:.3e} beyond its "
                  "limit")
        check(errs["g32"] <= 1e-6, f"glue {tag}{label} g32 {errs['g32']}")
        check(errs["db"] <= 1e-5, f"glue {tag}{label} db {errs['db']}")
        print(f"[K1 bwd] {tag}glue kernel, {label} {tuple(src.shape)}: "
              f"against its twin " + ", ".join(f"{k} {v:.3e}" for k, v in
                                               errs.items()))


def _k1_bwd_yardsticks(ops, z, ctx, ws, bs, g):
    """The backward alone of K1's twin and of its yardstick (three full
    cuDNN convs, ``k1_yardstick``) on the same leaves, in their dtype:
    (the twin's ms, cuDNN's ms, cuDNN's device ms)."""
    leaves = [t_.detach().clone().requires_grad_()
              for t_ in (z, ctx, *ws, *bs)]
    nw = len(ws)

    def twin(z_, c_, *wb):
        return ops.ar_stack_ref(z_, c_, list(wb[:nw]), list(wb[nw:]))

    def yard(z_, c_, *wb):
        return k1_yardstick(z_, c_, list(wb[:nw]), list(wb[nw:]))

    gl = g.permute(0, 3, 1, 2)
    return (_backward_ms(twin, leaves, g), _backward_ms(yard, leaves, gl),
            _backward_ms(yard, leaves, gl, device_ms))


def k1_f32_backward_phase(ops, cap) -> dict:
    """K1's backward in f32 (the f32 recipe) on the inputs of one real
    paper f32 training step (batch 32: z, the folded weights, the
    pre-activations and the output gradient carry full f32 mantissas,
    where an upcast from bf16 would hide a dropped lo part): every conv's
    dgrad and wgrad on ``"3xtf32"`` (K2's 3xTF32 kernels); dz, dcontext,
    dW at the live taps (the dead ones zero) and db within 1e-5 of each
    one's max of autograd of the twin in f64, where one TF32 product per
    f32 product on the same inputs (``_tf32``, the control) must miss that
    limit; two calls bitwise equal; the glue kernel against its twin and
    the f32 weight pack kernel bitwise. Device time by kernel; timed by
    events and by device time, whole and as the dgrad chain and wgrad
    apart, beside the FMA kernels it replaces (same run), the twin's
    backward and autograd of three cuDNN f32 convs (TF32 off), with the
    bounds of ``_f32_bounds``. Returns the kernels-line row."""
    import torch
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    (z, ctx, ws, bs, _), (bz, bws, pre, g) = cap
    _full_f32("K1 bwd f32", bz, *bws, *pre, g)
    routes = ar_mod.bwd_route(bz, bws)
    print(f"[K1 bwd f32] z{tuple(bz.shape)}, convs "
          f"{[tuple(w.shape[2:]) for w in bws]}: (dgrad, wgrad) per conv "
          f"{routes}")
    check(routes == (("3xtf32", "3xtf32"),) * len(bws),
          f"K1 bwd f32 takes {routes}, not 3xTF32 on every conv")
    call = lambda: ops.ar_stack_bwd(bz, bws, pre, g)  # noqa: E731
    got, again = call(), call()
    check(all(torch.equal(a, b) for a, b in zip(
        [got[0], got[1], *got[2], *got[3]],
        [again[0], again[1], *again[2], *again[3]])),
        "K1 bwd f32: two calls differ")
    want = ops.ar_stack_bwd_ref(*_f64(z, ctx, ws, bs), g.double())
    err = _k1_grads_close(ops, got, want, 1e-5,
                          "f32 3xtf32 against the f64 twin (two calls "
                          "bitwise equal)")
    errs = _k1_bwd_errs(got, want)
    control = _k1_bwd_errs(ops.ar_stack_bwd_ref(
        _tf32(z), ctx.double(), [_tf32(w) for w in ws],
        [b.double() for b in bs], _tf32(g)), want)
    products = [rel for name, _, rel in control if not name.startswith("db")]
    print("[K1 bwd f32] of each one's max from the f64 twin: " + ", ".join(
        f"{name} {rel:.3e}" for name, _, rel in errs) + "; one TF32 "
        "product per f32 product, the control: " + ", ".join(
            f"{name} {rel:.3e}" for name, _, rel in control))
    check(min(products) > 1e-5, f"K1 bwd f32: one TF32 product per f32 "
          f"product is {min(products):.3e} of max from the f64 twin, within "
          "the 1e-5 limit")
    _glue_check(ar_mod, g, pre[-1], f32=True)
    with torch.inference_mode():
        for group in (bws, [w.contiguous() for w in bws]):
            check(all(torch.equal(a, b) for a, b in zip(
                ar_mod.pack_dgrad(group), ar_mod.pack_dgrad_ref(bws, True))),
                "K1 bwd f32: the weight pack kernel differs from its twin")
    print(f"[K1 bwd f32] weight pack kernel, all convs (the step's weights, "
          f"contiguous: {bws[0].is_contiguous()}, and contiguous copies): "
          "bitwise equal to its twin")
    per_call = _by_kernel("K1 bwd f32", call)
    feeds = ar_mod._dgrad_wgmma(bz, bws, pre, g)[2]
    t = {}
    for part, fn in (("", call),
                     ("dgrad_", lambda: ar_mod._dgrad_wgmma(bz, bws, pre, g)),
                     ("wgrad_", lambda: ar_mod._wgrad_wgmma(bws, feeds))):
        t[part + "ms"] = cuda_ms(fn)
        t[part + "device_ms"] = device_ms(fn)
    with k1_bwd_fma():
        check(ar_mod.bwd_route(bz, bws)[0] == ("fma", "fma"),
              "K1 bwd f32: the FMA yardstick did not take the FMA kernels")
        fma_dev = device_ms(call, 5, 1)
    plain, lib, lib_dev = _k1_bwd_yardsticks(ops, z, ctx, ws, bs, g)
    n, hh, ww, _ = z.shape
    flops = 2 * 2 * n * hh * ww * 5 * sum(w.shape[2] * w.shape[3] for w in ws)
    live_w = sum(5 * w.shape[2] * w.shape[3] * w.element_size() for w in ws)
    b = _f32_bounds(flops, nbytes(bz, g, *pre, got[0], got[1], *got[3])
                    + 2 * live_w)
    dev = t["device_ms"]
    print(f"[K1 bwd f32] 3xtf32: by events {t['ms']:.4f} ms (dgrad chain "
          f"{t['dgrad_ms']:.4f}, wgrad + reduce {t['wgrad_ms']:.4f}), by "
          f"device time {dev:.4f} ms (dgrad chain {t['dgrad_device_ms']:.4f},"
          f" wgrad + reduce {t['wgrad_device_ms']:.4f}), {per_call} device "
          f"launches a call; the FMA kernels {fma_dev:.4f} ms; twin "
          f"{plain:.4f} ms; cuDNN f32 (TF32 off) {lib:.4f} ms, by device "
          f"time {lib_dev:.4f} ms, ratio {dev / lib_dev:.3f}; "
          f"{_f32_bound_text(b, dev)}")
    return dict(
        name="ar_stack_bwd_f32", route="cuda",
        source="iaf_torch/ops/csrc/ar_stack_bwd.cu",
        sources=["iaf_torch/ops/csrc/ar_stack_bwd.cu",
                 "iaf_torch/ops/csrc/masked_conv_bwd.cu"],
        replaces="iaf_tpu/ops/ar_stack.py:251", path="paper f32",
        counter="ar_stack_bwd", kernel_route="3xtf32", max_abs_err=err,
        max_rel_err=max(rel for _, _, rel in errs),
        one_tf32_rel_err=min(products), plain_ms=plain, library_ms=lib,
        library_device_ms=lib_dev, fma_device_ms=fma_dev,
        device_launches_per_call=per_call,
        routes=[list(r) for r in routes], **b, **t)


def backward_kernel_phase(ops, cap) -> list[dict]:
    """K1's, K3's and K4's backward kernels against autograd of their
    twins on the captured inputs, timed beside the twin's backward."""
    import torch
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    rows = []

    # K1 backward, the first AR net the step differentiates (bf16)
    (z, ctx, ws, bs, masks), (bz, bws, pre, g) = cap["ar_stack"]
    routes = ar_mod.bwd_route(bz, bws)
    print(f"[K1 bwd] bf16 z{tuple(bz.shape)}, convs "
          f"{[tuple(w.shape[2:]) for w in bws]}: (dgrad, wgrad) per conv "
          f"{routes}")
    check(routes == (("wgmma", "wgmma"),) * len(bws),
          f"K1 bwd bf16 takes {routes}, not the tensor cores on every conv")
    fwd = ar_mod.fwd_route(z.dtype, z.shape[2], z.shape[3], ws[0].shape[-1],
                           ws[-1].shape[-1])
    print(f"[K1] the step's forward, z{tuple(z.shape)}: the {fwd} kernel")
    check(fwd == "wgmma", f"K1 bf16 at the training shape takes the {fwd} "
          "kernel, not the tensor-core one")
    got = ops.ar_stack_bwd(bz, bws, pre, g)
    again = ops.ar_stack_bwd(bz, bws, pre, g)
    flat = [got[0], got[1], *got[2], *got[3]]
    check(all(torch.equal(a, b) for a, b in zip(
        flat, [again[0], again[1], *again[2], *again[3]])),
        "K1 bwd: two bf16 calls differ")
    err = _k1_grads_close(ops, got, ops.ar_stack_bwd_ref(z, ctx, ws, bs, g),
                          2e-2, "bf16 (two calls bitwise equal)")
    _glue_check(ar_mod, g, pre[-1])
    check(all(torch.equal(a, b) for a, b in zip(
        ar_mod.pack_dgrad(bws), ar_mod.pack_dgrad_ref(bws))),
        "K1 bwd: the weight pack kernel differs from its twin")
    print("[K1 bwd] weight pack kernel, all convs: bitwise equal to its twin")
    call = lambda: ops.ar_stack_bwd(bz, bws, pre, g)  # noqa: E731
    per_call = _by_kernel("K1 bwd", call)
    ms = cuda_ms(call)
    dev_ms = device_ms(call)
    feeds = ar_mod._dgrad_wgmma(bz, bws, pre, g)[2]
    t = {}
    for part, fn in (("dgrad_", lambda: ar_mod._dgrad_wgmma(bz, bws, pre, g)),
                     ("wgrad_", lambda: ar_mod._wgrad_wgmma(bws, feeds))):
        t[part + "ms"] = cuda_ms(fn)
        t[part + "device_ms"] = device_ms(fn)
    plain, lib, lib_dev = _k1_bwd_yardsticks(ops, z, ctx, ws, bs, g)
    n, hh, ww, _ = z.shape
    flops = 2 * 2 * n * hh * ww * 5 * sum(w.shape[2] * w.shape[3] for w in ws)
    live_w = sum(5 * w.shape[2] * w.shape[3] * w.element_size() for w in ws)
    moved = (nbytes(bz, g, *pre, got[0], got[1], *got[3]) + 2 * live_w)
    b_ms, b_by = bound_ms(flops, "bfloat16", moved)
    print(f"[K1 bwd] bf16 (tensor cores): by events {ms:.4f} ms (dgrad chain "
          f"{t['dgrad_ms']:.4f}, wgrad + reduce {t['wgrad_ms']:.4f}), cuDNN "
          f"{lib:.4f}; by device time {dev_ms:.4f} ms (dgrad chain "
          f"{t['dgrad_device_ms']:.4f}, wgrad + reduce "
          f"{t['wgrad_device_ms']:.4f}), cuDNN {lib_dev:.4f}, ratio "
          f"{dev_ms / lib_dev:.3f}; {per_call} device launches a call; bound "
          f"{b_ms:.4f} ms ({b_by})")
    rows.append(dict(
        name="ar_stack_bwd", route="cuda",
        source="iaf_torch/ops/csrc/ar_stack_bwd.cu",
        sources=["iaf_torch/ops/csrc/ar_stack_bwd.cu",
                 "iaf_torch/ops/csrc/masked_conv_bwd.cu"],
        replaces="iaf_tpu/ops/ar_stack.py:251", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        device_ms=dev_ms, library_device_ms=lib_dev,
        device_launches_per_call=per_call,
        routes=[list(r) for r in routes], gflop=flops / 1e9,
        mbytes=moved / 1e6, **t))

    # K3 backward, the same IAF step's update
    (zz, m, s, lq), (z_new, s_b, gz, glq) = cap["iaf_update"]
    got = ops.iaf_update_bwd(z_new, s_b, gz, glq)
    ref = ops.iaf_update_bwd_ref(zz, m, s, lq, gz, glq)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    ok = all(bool(((a - b).abs() <= 1e-6 * (1 + b.abs())).all())
             for a, b in zip(got, ref))
    print(f"[K3 bwd] iaf_update_bwd {tuple(gz.shape)}: max abs err {err:.3e}")
    check(ok, f"K3 bwd err {err} beyond 1e-6 * (1 + |ref|)")
    ms = cuda_ms(lambda: ops.iaf_update_bwd(z_new, s_b, gz, glq))
    dev_ms = device_ms(lambda: ops.iaf_update_bwd(z_new, s_b, gz, glq))
    leaves = [t.detach().clone().requires_grad_() for t in (zz, m, s, lq)]
    plain = _backward_ms(ops.iaf_update_ref, leaves, (gz, glq))
    moved = nbytes(gz, glq, z_new, s_b, *got[:3])
    b_ms, b_by = bound_ms(4 * gz.numel(), "float32", moved)
    rows.append(dict(
        name="iaf_update_bwd", route="triton", source="iaf_torch/ops/fused.py",
        replaces="iaf_tpu/ops/fused.py:79", max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        device_ms=dev_ms, mbytes=moved / 1e6))

    # K4 backward, the step's likelihood
    mean, ls, sample, g = cap["disc_logistic_logp"][:4]
    rows.append(dict(
        name="disc_logistic_logp_bwd", route="cuda",
        source="iaf_torch/ops/csrc/disc_logistic.cu",
        replaces="iaf_tpu/ops/fused.py:148",
        **k4_backward(ops, mean, ls, sample, g)))
    return rows


def k4_backward(ops, mean, ls, sample, g) -> dict:
    """K4's backward on these inputs against autograd of its twin (dmean
    within 1e-5 of its max, dlogscale at rel 1e-5), the same bits on two
    calls, one device kernel a call, timed by events and by device time
    (also at every split S) beside the twin's backward, an empty kernel
    on the same grid and clusters (the launch floor) and the bound."""
    import torch
    fused = importlib.import_module("iaf_torch.ops.fused")
    n, row_len = mean.shape[0], mean[0].numel()
    plan = ops.dl_plan(n, row_len)
    call = lambda: ops.disc_logistic_bwd(mean, ls, sample, g)  # noqa: E731
    dmean, dls = call()
    again = call()
    check(torch.equal(dmean, again[0]) and torch.equal(dls, again[1]),
          "K4 bwd: two calls differ")
    rmean, rls = ops.disc_logistic_bwd_ref(mean, ls, sample, g)
    err, rel = _rel_err(dmean, rmean)
    rel_ls = float((dls - rls).abs().max() / rls.abs().max())
    print(f"[K4 bwd] disc_logistic_bwd {tuple(mean.shape)}, S = {plan}: "
          f"dmean max abs err {err:.3e} ({rel:.3e} of max), dlogscale "
          f"{float(dls):.6e} vs {float(rls):.6e} (rel {rel_ls:.3e}); two "
          "calls bitwise equal")
    check(rel <= 1e-5, f"K4 bwd dmean {rel} of max > 1e-5")
    check(rel_ls <= 1e-5, f"K4 bwd dlogscale rel err {rel_ls} > 1e-5")
    per_call = _by_kernel("K4 bwd", call)
    check(per_call == 1, f"K4 bwd puts {per_call} kernels on the card a "
          "call, not 1")
    ms = cuda_ms(call)
    dev_ms = device_ms(call)
    by_split = {s_: device_ms(lambda s_=s_: ops.disc_logistic_bwd(
        mean, ls, sample, g, splits=s_)) for s_ in (1, 2, 4, 8)}
    stream = torch.cuda.current_stream().cuda_stream
    lib = fused._dl_lib()
    check(lib.dl_launch_floor(n, plan, stream) == 0, "empty kernel failed")
    floor = device_ms(lambda: lib.dl_launch_floor(n, plan, stream))
    leaves = [t.detach().clone().requires_grad_() for t in (mean, ls)]
    plain = _backward_ms(lambda m_, l_: ops.disc_logistic_ref(m_, l_, sample),
                         leaves, g)
    moved = nbytes(mean, sample, g, ls, dmean, dls)
    b_ms, b_by = bound_ms(40 * mean.numel(), "float32", moved)
    print(f"[K4 bwd] batch {n}: by events {ms:.4f} ms, by device time "
          f"{dev_ms:.4f} ms ({per_call} device launch a call; by S "
          + ", ".join(f"{k} {v:.4f}" for k, v in by_split.items())
          + f"), an empty kernel on the same grid {floor:.4f} ms, the twin's "
          f"backward {plain:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, device_ms=dev_ms,
                mbytes=moved / 1e6, splits=plan,
                device_launches_per_call=per_call, splits_device_ms=by_split,
                launch_floor_device_ms=floor)


def forward_b32_phase(ops, cap, rows) -> None:
    """K3's and K4's forward kernels on one training step's inputs (batch
    32; the inputs of the forwards whose backward ``cap`` holds): K3 held
    to its twin at 1e-6 (1 + |ref|) and timed beside its bound, K4 as
    ``k4_forward``; the numbers go into the K3 and K4 rows under
    ``b32_``."""
    import torch
    by_name = {r["name"]: r for r in rows}
    a = cap["iaf_update"][0]
    with torch.inference_mode():
        got = ops.iaf_update(*a)
        ref = ops.iaf_update_ref(*a)
        err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        check(all(bool(((x - y).abs() <= 1e-6 * (1 + y.abs())).all())
                  for x, y in zip(got, ref)),
              f"K3 b32 err {err} beyond 1e-6 * (1 + |ref|)")
        call = lambda: ops.iaf_update(*a)  # noqa: E731
        k3 = dict(max_abs_err=err, ms=cuda_ms(call), device_ms=device_ms(call),
                  plain_ms=cuda_ms(lambda: ops.iaf_update_ref(*a)))
    k3["bound_ms"], k3["bound_by"] = bound_ms(4 * a[0].numel(), "float32",
                                              nbytes(*a, *got))
    print(f"[K3 b32] iaf_update {tuple(a[0].shape)}: max abs err {err:.3e}; "
          f"by events {k3['ms']:.4f} ms, by device time "
          f"{k3['device_ms']:.4f} ms, plain {k3['plain_ms']:.4f} ms; bound "
          f"{k3['bound_ms']:.4f} ms ({k3['bound_by']}, "
          f"{100 * k3['bound_ms'] / k3['device_ms']:.0f} % of it)")
    k4 = k4_forward(ops, *cap["disc_logistic_logp"][:3], "K4 b32")
    for name, got in (("iaf_update", k3), ("disc_logistic_logp", k4)):
        by_name[name].update({f"b32_{k}": v for k, v in got.items()
                              if k not in ("library_ms",)})


def adamax_phase(ops, cfg, state) -> dict:
    """K5 against its twin, bitwise, on the parameters, gradients and
    optimizer state of the step just taken; both timed over all leaves."""
    import torch
    names = [k for k, _ in state.params.named_parameters()]
    params = dict(state.params.named_parameters())
    grads = [torch.zeros_like(params[k]) if params[k].grad is None
             else params[k].grad for k in names]
    base = [[params[k].detach() for k in names],
            [state.opt.m[k] for k in names], [state.opt.u[k] for k in names],
            [state.opt.ema[k] for k in names]]
    dev = grads[0].device
    lr_t = torch.full((), cfg.learning_rate, dtype=torch.float32, device=dev)
    hyper = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.adamax_eps,
                 polyak_decay=cfg.polyak_decay)
    p, m, u, e = ([t.clone() for t in group] for group in base)
    ops.adamax_polyak(p, grads, m, u, e, lr_t, **hyper)
    same = True
    for i, leaf in enumerate(zip(*[[t.clone() for t in grp] for grp in base])):
        ref = ops.adamax_polyak_ref(leaf[0], grads[i], *leaf[1:], lr_t,
                                    **hyper)
        same &= all(torch.equal(a[i], b)
                    for a, b in zip((p, m, u, e), ref))
    n = sum(t.numel() for t in grads)
    print(f"[K5] adamax_polyak over {len(names)} leaves, {n} elements: "
          f"bitwise equal to the twin: {same}")
    check(same, "K5 differs from its twin")
    ms = cuda_ms(lambda: ops.adamax_polyak(p, grads, m, u, e, lr_t, **hyper))
    dev_ms = device_ms(lambda: ops.adamax_polyak(p, grads, m, u, e, lr_t,
                                                 **hyper))

    def twin_all():
        for i in range(len(grads)):
            ops.adamax_polyak_ref(p[i], grads[i], m[i], u[i], e[i], lr_t,
                                  **hyper)

    plain = cuda_ms(twin_all)
    moved = 9 * 4 * n
    b_ms, b_by = bound_ms(10 * n, "float32", moved)
    return dict(name="adamax_polyak", route="triton",
                source="iaf_torch/ops/fused_adamax.py",
                replaces="iaf_tpu/ops/fused_adamax.py:33", max_abs_err=0.0,
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms, mbytes=moved / 1e6,
                leaves=len(names))


def train_reference_phase(device, hp: str = PAPER) -> None:
    """One f32 training step of the config ``hp`` at batch 4 on the card
    (kernels) against the same step on the CPU (twins): same params,
    batch and noise, TF32 off. The loss at 1e-5 relative; every gradient
    leaf at 1e-4 of its max; every EMA leaf at 1e-5 of its max; every
    parameter leaf at 1e-5 of its max where the CPU gradient is at least
    1e-3 of the leaf's largest (elsewhere Adamax's first step is
    +-lr (1 - b1) by the gradient's sign alone, so a sign that float
    rounding flips moves the element by 2 lr (1 - b1); those are
    counted, and at most ``MAX_FLIPS`` may move apart)."""
    import torch
    from iaf_torch import optim
    from iaf_torch.core.config import Config
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import cvae
    from iaf_torch.parallel import train_step as ts
    cfg = Config().parse(hp + ",compute_dtype=float32,batch_size=4")
    x = synthetic_dataset(cfg.image_size, 3, n_train=8, n_test=2,
                          seed=5).train_x[:4]
    gpu = ts.init_train_state(cfg, 17, x, device)
    cpu_model = cvae.CVAE(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               gpu.params.state_dict().items()})
    cpu = ts.TrainState(cpu_model, optim.init_state(
        dict(cpu_model.named_parameters())))
    g = torch.Generator().manual_seed(4)
    hw = cfg.image_size // 2
    noise = {f"{n}/z_post": torch.randn((4, hw, hw, cfg.z_size), generator=g)
             for n in cvae.layer_names(cfg)}
    gpu, gm = ts.train_step(cfg, gpu, 0, x,
                            noise={k: v.to(device) for k, v in noise.items()})
    t0 = time.perf_counter()
    cpu, cm = ts.train_step(cfg, cpu, 0, x, noise=noise)
    cpu_s = time.perf_counter() - t0
    rel = abs(float(gm["loss"]) - float(cm["loss"])) / abs(float(cm["loss"]))
    check(math.isfinite(float(gm["loss"])), "non-finite loss on the card")
    check(rel <= 1e-5, f"f32 step loss rel err {rel} > 1e-5")
    worst = {"grad": 0.0, "param": 0.0, "ema": 0.0}
    flips = 0
    gparams = dict(gpu.params.named_parameters())
    for k, cp in cpu.params.named_parameters():
        gp = gparams[k]
        cg = torch.zeros_like(cp) if cp.grad is None else cp.grad
        gg = torch.zeros_like(cp) if gp.grad is None else gp.grad.cpu()
        gmax = float(cg.abs().max())
        if gmax > 0:
            worst["grad"] = max(worst["grad"], _rel_err(gg, cg)[1])
        big = cg.abs() >= 1e-3 * gmax
        pmax = max(float(cp.detach().abs().max()), 1e-30)
        diff = (gp.detach().cpu() - cp.detach()).abs()
        worst["param"] = max(worst["param"],
                             float((diff * big).max()) / pmax)
        flips += int(((diff > 1e-5 * pmax) & ~big).sum())
        worst["ema"] = max(worst["ema"], _rel_err(gpu.opt.ema[k].cpu(),
                                                  cpu.opt.ema[k])[1])
    print(f"[reference] {_label(cfg)} f32 train step, batch 4, card vs CPU "
          f"twins: loss "
          f"{float(cm['loss']):.4f} (rel err {rel:.3e}); worst leaf error "
          f"over its max: grads {worst['grad']:.3e}, params {worst['param']:.3e}"
          f" (where |g| >= 1e-3 max), ema {worst['ema']:.3e}; {flips} small-"
          f"gradient elements moved apart by a flipped sign (limit "
          f"{MAX_FLIPS}); CPU step "
          f"{cpu_s:.1f} s")
    check(worst["grad"] <= 1e-4, f"grad leaf err {worst['grad']} > 1e-4")
    check(worst["param"] <= 1e-5, f"param leaf err {worst['param']} > 1e-5")
    check(worst["ema"] <= 1e-5, f"ema leaf err {worst['ema']} > 1e-5")
    check(flips <= MAX_FLIPS, f"{flips} small-gradient elements moved "
          f"apart > {MAX_FLIPS}")


# launches per training step: the paper config's AR nets through K1, the
# 5x5 config's through K2 (3 convs x 20 layers)
PER_STEP = {"ar_stack": 20, "ar_stack_bwd": 20, "iaf_update": 20,
            "iaf_update_bwd": 20, "disc_logistic_logp": 1,
            "disc_logistic_logp_bwd": 1, "adamax_polyak": 1}
PER_STEP_5X5 = {"masked_conv2d": 60, "masked_conv2d_bwd": 60,
                "iaf_update": 20, "iaf_update_bwd": 20,
                "disc_logistic_logp": 1, "disc_logistic_logp_bwd": 1,
                "adamax_polyak": 1}
# steps of a ``train_lib.train`` run on the card whose launches Python
# makes: the eager warm-up step and the capture (the replays run none)
GRAPH_PY_STEPS = 2


def _label(cfg) -> str:
    if cfg.likelihood == "bernoulli":
        base = "mnist"
    else:
        base = "5x5" if cfg.kernel_size == 5 else "paper"
    return base + (" f32" if cfg.compute_dtype == "float32" else "")


def _train_images(cfg, n: int):
    """``n`` synthetic training images of ``cfg``'s shape; binarized (step
    0's draws, ``feed.dynamic_binarize``) where ``cfg.binarize``."""
    from iaf_torch.data import feed
    from iaf_torch.data.datasets import synthetic_dataset
    x = synthetic_dataset(cfg.image_size, cfg.channels, n_train=n).train_x
    if cfg.binarize:
        x = feed.dynamic_binarize(x, feed.binarize_rng(cfg.seed, 0))
    return x


def with_glue(per: dict, cfg, model=None) -> dict:
    """``per`` (the launches of a forward of ``model`` without autograd;
    by default a CIFAR model of ``cfg``) with those of the fused inference
    passes (``iaf_torch.ops.glue``) where ``cvae.fused_route`` takes them
    there: per IAF layer one ``up_stats``, ``posterior`` and ``kl_join``
    and two ``residual_elu``, and two ``elu_bf16`` a forward."""
    import torch
    from iaf_torch.models import cvae
    model = cvae.CVAE(cfg, device="meta") if model is None else model
    with torch.no_grad():
        if not (isinstance(model, cvae.CVAE) and cvae.fused_route(
                model, cvae.compute_dtype(cfg.compute_dtype))):
            return per
    layers = len(model.blocks)
    return {**per, "elu_bf16": 2, "residual_elu": 2 * layers,
            "up_stats": layers, "posterior": layers, "kl_join": layers}


def _expect(counts: dict, per: dict, times: int) -> dict:
    """Every counter zero but those of ``per``, which are ``times`` x."""
    want = dict.fromkeys(counts, 0)
    want.update({k: v * times for k, v in per.items()})
    return want


def train_phase(ops, device, hp: str = PAPER, per_step: dict = PER_STEP,
                steps: int = TRAIN_STEPS, resume_steps: int = RESUME_STEPS):
    """The training main path through ``train_lib.train``: ``steps``
    steps with a checkpoint at the last, then ``resume_steps`` more from
    it (none: no resume). Returns (the config, the final state, the first
    run's launch counts, its summary)."""
    import torch
    from iaf_torch import train_lib
    from iaf_torch.core.config import Config
    cfg = Config().parse(hp + f",dataset=synthetic,log_every=1,"
                         f"ckpt_every={steps},eval_every=0")
    tag = _label(cfg)
    logdir = os.path.join(HERE, "build",
                          f"chip_smoke_train_{tag.replace(' ', '_')}")
    shutil.rmtree(logdir, ignore_errors=True)
    cfg = cfg.replace(logdir=logdir)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = train_lib.train(cfg, max_steps=steps, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = _expect(counts, per_step, steps)
    print(f"[train] {tag}: {steps} steps with init and set-up "
          f"{secs:.3f} s, launches {counts}")
    check(counts == want, f"launch counts {counts} != {want}")
    _reserved(f"{tag} training run")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows]
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"losses {losses}")
    step_s = [1.0 / r["steps_per_sec"] for r in rows[2:]]
    steady = statistics.median(step_s)
    print(f"[train] {tag}: losses {[round(v, 2) for v in losses]}")
    print(f"[train] {tag}: steady step (median of steps 3-{steps}): "
          f"{steady:.4f} s, {1 / steady:.3f} steps/s, "
          f"{cfg.batch_size / steady:.1f} examples/s at batch "
          f"{cfg.batch_size}")
    check(os.path.isfile(os.path.join(logdir, f"ckpt-{steps:09d}.npz")),
          "no checkpoint at the last step")
    summary = {"steps": steps, "batch_size": cfg.batch_size,
               "seconds_with_setup": secs, "steady_seconds_per_step": steady,
               "steps_per_s": 1 / steady,
               "examples_per_s": cfg.batch_size / steady,
               "first_loss": losses[0], "last_loss": losses[-1]}
    if not resume_steps:
        return cfg, state, counts, summary

    ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = train_lib.train(cfg, max_steps=steps + resume_steps,
                                device=device)
    torch.cuda.synchronize()
    log = out.getvalue()
    print("\n".join(f"[resume] {tag}: {line}" for line in log.splitlines()))
    resumed = ops.launch_counts()
    check(f"at step {steps}" in log, "the resume did not restore")
    check(resumed == _expect(resumed, per_step, resume_steps),
          f"resume launch counts {resumed}")
    _reserved(f"{tag} resumed run")
    return cfg, state, counts, summary


def _reserved(what: str) -> None:
    import torch
    gib = 2.0 ** 30
    print(f"[memory] after the {what}: "
          f"{torch.cuda.memory_reserved() / gib:.3f} GiB reserved, "
          f"{torch.cuda.memory_allocated() / gib:.3f} GiB allocated")


def eval_phase(ops, device, cfg, model, ds, per_chunk: dict):
    """The eval main path, counted: ``train_lib.evaluate`` over 2 test
    batches at k=256 with the counters zeroed just before and read just
    after (exactly ``per_chunk`` per chunk; on the card the chunks after
    the first are replays of a CUDA graph); then the graphed eval step
    alone (``make_graphed_eval_step``, warmed up and captured on one
    batch) for the steady seconds per batch, the median of
    ``STEADY_BATCHES``. Returns (the counts, a summary)."""
    import torch
    from iaf_torch import train_lib
    from iaf_torch.parallel.eval_step import make_graphed_eval_step
    tag = _label(cfg)
    per_chunk = with_glue(per_chunk, cfg, model)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    metric = train_lib.evaluate(cfg, "eval_test", params=model, k=EVAL_K,
                                max_batches=EVAL_BATCHES, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = _expect(counts, per_chunk, EVAL_K // EVAL_CHUNK * EVAL_BATCHES)
    name = "nll_nats" if cfg.likelihood == "bernoulli" else "bits_per_dim"
    print(f"[main] {tag}: evaluate k={EVAL_K}: {name} {metric!r}, "
          f"{secs:.4f} s with the data set-up, launches {counts}")
    check(math.isfinite(metric), f"{name} {metric} is not finite")
    check(counts == want, f"launch counts {counts} != {want}")
    # steady state: the graphed eval step alone, timed after the counted
    # run (set-up, warm-up and capture excluded)
    step = make_graphed_eval_step(cfg, device, k=EVAL_K)
    batch = ds.test_x[:EVAL_BATCH]
    step(model, 7, batch)
    times = []
    for _ in range(STEADY_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, 7, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step.close()
    per_batch = statistics.median(times)
    print(f"[main] {tag}: steady eval step (graphed, median of "
          f"{STEADY_BATCHES}): {per_batch:.4f} s/batch, "
          f"{EVAL_BATCH * EVAL_K / per_batch:.1f} importance samples/s "
          f"({[round(t, 4) for t in times]})")
    return counts, {
        name: metric, "evaluate_seconds": secs,
        "seconds_per_batch": per_batch,
        "importance_samples_per_s": EVAL_BATCH * EVAL_K / per_batch,
        "k": EVAL_K, "eval_batch_size": EVAL_BATCH, "batches": EVAL_BATCHES}


def f32_phases(ops, device, model, ds):
    """The paper config's f32 recipe (``compute_dtype=float32``, phase 6
    of the module docstring) on the bf16 phases' model. Returns (K1's f32
    forward and backward rows, the eval and training launch counts, a
    summary)."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.models import cvae
    from iaf_torch.parallel import train_step as ts
    hp = PAPER + ",compute_dtype=float32"
    cfg = Config().parse(hp + f",dataset=synthetic,eval_batch_size="
                         f"{EVAL_BATCH},eval_k_chunk={EVAL_CHUNK}")

    def one_chunk():
        with torch.inference_mode():
            cvae.apply_fn(cfg, model, 1, ds.test_x[:EVAL_BATCH], mode="eval",
                          k=EVAL_CHUNK)
    row = k1_f32_phase(ops, capture_inputs(ops, one_chunk))
    chunk = profile_phase(f"paper f32: one eval chunk (16 images x "
                          f"{EVAL_CHUNK} samples)", one_chunk)
    blocks = len(model.blocks)
    with k1_routes() as routes:
        eval_counts, main = eval_phase(
            ops, device, cfg, model, ds,
            {"ar_stack": blocks, "iaf_update": blocks,
             "disc_logistic_logp": 1})
    # the routes are chosen in Python by each graphed step's warm-up chunk
    # and its capture; the replays repeat the capture's launches
    check(routes["fwd"] and set(routes["fwd"]) == {"3xtf32"},
          f"f32 eval: K1 routes {sorted(set(routes['fwd']))}, not all "
          "3xtf32")
    main["profile"] = chunk
    with k1_routes() as routes:
        tcfg, tstate, counts, summary = train_phase(
            ops, device, hp, PER_STEP, F32_TRAIN_STEPS, 0)
    tc = (("3xtf32", "3xtf32"),) * 3
    # the routes are chosen in Python by the warm-up step and the capture;
    # the replays repeat the capture's launches
    check(len(routes["fwd"]) == GRAPH_PY_STEPS * PER_STEP["ar_stack"]
          and set(routes["fwd"]) == {"3xtf32"},
          f"f32 training: K1 routes {sorted(set(routes['fwd']))} "
          f"({len(routes['fwd'])}), not all 3xtf32")
    check(len(routes["bwd"]) == GRAPH_PY_STEPS * PER_STEP["ar_stack_bwd"]
          and set(routes["bwd"]) == {tc},
          f"f32 training: K1 backward routes {sorted(set(routes['bwd']))} "
          f"({len(routes['bwd'])}), not all 3xtf32")
    print(f"[main] paper f32: every K1 forward of the eval and the training "
          f"runs took the 3xtf32 route ({counts['ar_stack']} launches in "
          f"training, {len(routes['fwd'])} of them chosen by the warm-up "
          f"step and the capture, the rest replays), and every K1 backward "
          f"({counts['ar_stack_bwd']}) took 3xtf32 for dgrad and wgrad on "
          "every conv")
    tbatch = ds.train_x[:tcfg.batch_size]
    cap = capture_train_step(
        ops, lambda: ts.train_step(tcfg, tstate, 98, tbatch))
    bwd_row = k1_f32_backward_phase(ops, cap["ar_stack"])
    del cap
    summary["profile"] = profile_phase(
        f"paper f32: one training step (batch {tcfg.batch_size})",
        lambda: ts.train_step(tcfg, tstate, 99, tbatch))
    return [row, bwd_row], eval_counts, counts, {"main": main,
                                                 "train": summary}


def _paper_chain(depth_ar: int, gen):
    """Random folded weights, biases and masks of a 3x3 AR chain of
    depth_ar + 1 convs at the paper widths (z=32, h=160, merged heads)."""
    import numpy as np
    import torch
    from iaf_torch.nn.masks import get_conv_ar_mask
    zs, hs = 32, 160
    ws, bs, masks, prev = [], [], [], zs
    for i in range(depth_ar + 1):
        if i < depth_ar:
            m, cout = get_conv_ar_mask(3, 3, prev, hs, i == 0), hs
        else:
            m = np.concatenate([get_conv_ar_mask(3, 3, hs, zs, False)] * 2,
                               -1)
            cout = 2 * zs
        ws.append(torch.randn(3, 3, prev, cout, generator=gen)
                  / math.sqrt(5 * prev) * torch.from_numpy(m))
        bs.append(0.1 * torch.randn(cout, generator=gen))
        masks.append(m)
        prev = hs
    return ws, bs, masks


def _most_convs(ops, dtype) -> int:
    """The deepest chain K1 holds at the paper widths in ``dtype``."""
    return max(k for k in range(2, 33)
               if ops.ar_stack_fits(k, 16, 32, 160, 64, dtype))


def k1_depth_phase(ops, device, n: int = 64) -> None:
    """K1 with the deepest chain it holds at the paper widths (bf16 and
    f32 both on the tensor cores, f32 by 3xTF32) on random inputs from a
    seed, against its twin: bf16 at 2e-2 of the output's max, f32 at 1e-5
    of it against the twin in f64."""
    import torch
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    gen = torch.Generator().manual_seed(9)
    z = torch.randn(n, 16, 16, 32, generator=gen)
    ctx = torch.randn(n, 16, 16, 160, generator=gen)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        ws, bs, masks = _paper_chain(_most_convs(ops, dtype) - 1, gen)
        args = (z.to(device, dtype), ctx.to(device),
                [w.to(device, dtype) for w in ws], [b.to(device) for b in bs])
        route = ar_mod.fwd_route(dtype, 16, 32, 160, 64)
        check(route == ("wgmma" if dtype == torch.bfloat16 else "3xtf32"),
              f"K1 {dtype} at the paper widths takes the {route} kernel")
        with torch.inference_mode():
            got = ops.ar_stack(*args, masks)
            ref = ops.ar_stack_ref(*(args if dtype == torch.bfloat16
                                     else _f64(*args)))
        err, rel = _rel_err(got, ref)
        print(f"[K1 depth] ar_stack with {len(ws)} convs (depth_ar="
              f"{len(ws) - 1}, the most it holds), {str(dtype)[6:]} "
              f"({route}), z{tuple(z.shape)}: max abs err {err:.3e} "
              f"({rel:.3e} of max{' of the f64 twin' if tol < 1e-4 else ''},"
              f" limit {tol})")
        check(rel <= tol, f"K1 at {len(ws)} convs {dtype}: {rel} > {tol}")


def deep_chain_phase(ops, device, n: int = 64) -> dict:
    """A kernel_size=3 AR net at the paper widths one conv deeper than K1
    holds in bf16 (and so in f32), through ``ARMultiConv2d`` on random
    weights from a seed: it must run conv by conv through K2 (exactly
    K1 = 0, K2 = one launch per conv per forward) and match K1's twin on
    the same folded weights, bf16 at 2e-2 and f32 (TF32 off) at 1e-5 of
    the output's max. Returns the launches of one forward."""
    import torch
    from iaf_torch.nn.layers import ARMultiConv2d
    n_convs = min(_most_convs(ops, torch.bfloat16) + 1, 32)
    depth_ar = n_convs - 1
    gen = torch.Generator().manual_seed(12)
    zs, hs = 32, 160
    mod = ARMultiConv2d(zs, [hs] * depth_ar, [zs, zs], (3, 3), device=device)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            v = torch.randn(p.shape, generator=gen)
            p.copy_(1.0 + 0.1 * v if name.endswith(".g") else
                    0.1 * v if name.endswith(".b") else v)
    z = torch.randn(n, 16, 16, zs, generator=gen).to(device)
    ctx = torch.randn(n, 16, 16, hs, generator=gen).to(device)
    counts = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        with torch.inference_mode():
            ws, bs = mod.folded(dtype)
            fits = ops.ar_stack_fits(len(ws), 16, zs, hs, 2 * zs, dtype)
            check(not fits, f"{len(ws)} convs in {dtype} fit K1; the phase "
                  "needs a chain that does not")
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            got = torch.cat(mod(z, ctx, dtype), dim=-1)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            ref = ops.ar_stack_ref(z.to(dtype), ctx, ws, bs)
            ms = cuda_ms(lambda: mod(z, ctx, dtype), 5, 1)
        want = _expect(counts, {"masked_conv2d": n_convs}, 1)
        err, rel = _rel_err(got, ref)
        print(f"[deep] 3x3 AR net, depth_ar={depth_ar} ({len(ws)} convs), "
              f"{str(dtype)[6:]}, z{tuple(z.shape)}: through K2, launches "
              f"{ {k: v for k, v in counts.items() if v} }; against K1's "
              f"twin max abs err {err:.3e} ({rel:.3e} of max, limit {tol}); "
              f"{ms:.3f} ms a forward")
        check(counts == want, f"deep chain launches {counts} != {want}")
        check(bool(torch.isfinite(got).all()), "non-finite deep-chain output")
        check(rel <= tol, f"deep chain {dtype}: {rel} of max > {tol}")
    return counts


def capture_k2(target, name: str, fn) -> dict:
    """Run ``fn`` with a spy on K2's wrapper ``target.name``; return, per
    conv shape (cin, cout), its first call's arguments (detached copies)."""
    original = getattr(target, name)
    seen: dict[tuple, tuple] = {}

    def spy(*args):
        key = tuple(args[1].shape[2:])
        if key not in seen:
            seen[key] = _detach(args)
        return original(*args)

    setattr(target, name, spy)
    try:
        fn()
    finally:
        setattr(target, name, original)
    check(len(seen) == 3, f"{name}: captured shapes {sorted(seen)}, want 3")
    return seen


_K2_MEANS = ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms",
             "library_device_ms", "gflop", "mbytes")


def _k2_row(name, source, replaces, shapes, extra=(), **keys) -> dict:
    """One kernels-line row for K2 over the AR net's three conv shapes:
    each time (and each of ``extra``) is the mean per launch on the path
    (the three convs run equally often), the bound the mean of the three
    bounds, set by what bounds the larger share of them; each error the
    largest of the three; ``keys`` as given."""
    by_ops = sum(sh["bound_ms"] for sh in shapes
                 if sh["bound_by"] == "operations")
    by_bytes = sum(sh["bound_ms"] for sh in shapes) - by_ops
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               bound_by="operations" if by_ops >= by_bytes else "bytes",
               **keys)
    row.update({k: max(sh[k] for sh in shapes) for k in shapes[0]
                if k.startswith("max_")})
    row.update({k: statistics.fmean(sh[k] for sh in shapes)
                for k in _K2_MEANS + tuple(extra)})
    row["per_shape"] = shapes
    return row


def _k2_conv_lib(x, w):
    """cuDNN's conv on the same masked weights, channels-last, all taps:
    (the call, its inputs) for timing (never called by the port)."""
    import torch
    import torch.nn.functional as F
    kh, kw = w.shape[:2]
    xl = x.permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = ((kh - 1) // 2, (kw - 1) // 2)
    return (lambda a, b: F.conv2d(a, b, padding=pad)), xl, wl


def k2_forward_phase(ops, cap: dict) -> dict:
    """K2 on each captured conv: the bf16 input must take the tensor-core
    kernel (``fwd_route``); bf16 against its twin at 2e-2 and the same
    inputs upcast to f32 (TF32 off) at 1e-5 of the output's max; timed
    beside the twin, one cuDNN conv (with the ratio) and the bound. The
    f32 record is ``k2_f32_forward_phase``'s, on real f32 inputs."""
    import torch
    from iaf_torch.ops.masked_conv import fwd_route
    shapes = []
    for (cin, cout), (x, w, taps) in sorted(cap.items()):
        route = fwd_route(x, w, taps)
        check(route == "wgmma", f"K2 {cin}->{cout} bf16 takes the {route} "
              "kernel, not the tensor-core one")
        with torch.inference_mode():
            got = ops.masked_conv2d(x, w, taps)
            err, rel = _rel_err(got, ops.masked_conv2d_ref(x, w, taps))
            x32, w32 = x.float(), w.float()
            err32, rel32 = _rel_err(ops.masked_conv2d(x32, w32, taps),
                                    ops.masked_conv2d_ref(x32, w32, taps))
            print(f"[K2] masked_conv2d x{tuple(x.shape)} {cin}->{cout}, "
                  f"{len(taps)} live taps: bf16 max abs err {err:.3e} "
                  f"({rel:.3e} of max), f32 {err32:.3e} ({rel32:.3e})")
            check(rel <= 2e-2, f"K2 {cin}->{cout} bf16 {rel} > 2e-2")
            check(rel32 <= 1e-5, f"K2 {cin}->{cout} f32 {rel32} > 1e-5")
            ms = cuda_ms(lambda: ops.masked_conv2d(x, w, taps))
            dev = device_ms(lambda: ops.masked_conv2d(x, w, taps))
            plain = cuda_ms(lambda: ops.masked_conv2d_ref(x, w, taps))
            conv, xl, wl = _k2_conv_lib(x, w)
            lib = cuda_ms(lambda: conv(xl, wl))
            lib_dev = device_ms(lambda: conv(xl, wl))
        print(f"[K2] {cin}->{cout} ({route}): kernel {ms:.4f} ms, cuDNN "
              f"{lib:.4f} ms, ratio {ms / lib:.3f}; by device time "
              f"{dev:.4f} ms against {lib_dev:.4f} ms, ratio "
              f"{dev / lib_dev:.3f}")
        n, hh, ww, _ = x.shape
        flops = 2 * n * hh * ww * len(taps) * cin * cout
        moved = nbytes(x, got) + len(taps) * cin * cout * w.element_size()
        b_ms, b_by = bound_ms(flops, "bfloat16", moved)
        shapes.append(dict(cin=cin, cout=cout, max_abs_err=err,
                           max_abs_err_f32=err32, ms=ms, plain_ms=plain,
                           library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                           device_ms=dev, library_device_ms=lib_dev,
                           gflop=flops / 1e9, mbytes=moved / 1e6))
    return _k2_row("masked_conv2d", "iaf_torch/ops/csrc/masked_conv.cu",
                   "iaf_tpu/ops/masked_conv.py:40", shapes)


def k2_backward_phase(ops, cap: dict) -> dict:
    """K2's backward on each captured conv of a real bf16 step: both dgrad
    and wgrad must take the tensor cores (``bwd_route``); against autograd
    of the twin, dx and dW (live taps; the dead ones must be zero) at 2e-2
    of each output's max, and upcast to f32 at 1e-4 against the twin in
    f64 (on these inputs cuDNN's own f32 weight gradient, TF32 off, is
    ~1e-3 of max away from f64: printed beside); two bf16 calls bitwise
    equal. Device time per call by kernel; timed by events and by device
    time, whole and as dgrad and wgrad (with its reduce) apart, dgrad's
    kernel also alone, beside the twin's backward and autograd of one
    cuDNN conv. The f32 record is ``k2_f32_backward_phase``'s."""
    import torch
    from iaf_torch.ops import masked_conv as mc
    shapes = []
    for (cin, cout), (x, w, g, taps) in sorted(cap.items()):
        kh, kw = w.shape[:2]
        routes = mc.bwd_route(x, w, taps)
        check(routes == ("wgmma", "wgmma"), f"K2 bwd {cin}->{cout} bf16 "
              f"takes dgrad, wgrad on {routes}, not the tensor cores")
        live = torch.zeros(kh, kw, 1, 1, device=x.device)
        for dy, dx in taps:
            live[dy, dx] = 1.0
        errs, outs = {}, {}
        for label, xx, ww, tol in (("bf16", x, w, 2e-2),
                                   ("f32", x.float(), w.float(), 1e-4)):
            dx_, dw_ = outs[label] = ops.masked_conv2d_bwd(xx, ww, g, taps)
            if label == "bf16":
                rdx, rdw = ops.masked_conv2d_bwd_ref(xx, ww, g, taps)
                again = ops.masked_conv2d_bwd(xx, ww, g, taps)
                check(torch.equal(dx_, again[0]) and torch.equal(dw_,
                                                                 again[1]),
                      f"K2 bwd {cin}->{cout}: two calls differ")
            else:
                rdx, rdw = ops.masked_conv2d_bwd_ref(
                    x.double(), w.double(), g.double(), taps)
                twin_dw = ops.masked_conv2d_bwd_ref(xx, ww, g, taps)[1]
                print(f"[K2 bwd] {cin}->{cout}: the f32 twin's own dW is "
                      f"{_rel_err(twin_dw * live, rdw * live)[1]:.3e} of "
                      f"max from f64")
            check(not bool((dw_.float() * (1 - live)).any()),
                  f"K2 bwd {cin}->{cout} {label}: dW nonzero at a dead tap")
            worst = 0.0
            for nm, a, b in (("dx", dx_, rdx), ("dW", dw_.float() * live,
                                                 rdw.float() * live)):
                err, rel = _rel_err(a, b)
                check(rel <= tol, f"K2 bwd {cin}->{cout} {label} {nm}: "
                      f"{rel:.3e} of max > {tol}")
                worst = max(worst, rel)
                errs[label] = max(errs.get(label, 0.0), err)
            print(f"[K2 bwd] {cin}->{cout} {label}: max abs err "
                  f"{errs[label]:.3e}, worst {worst:.3e} of an output's max "
                  f"(limit {tol}); two bf16 calls bitwise equal")
        for key, ms, k in sorted(device_kernels(
                lambda: ops.masked_conv2d_bwd(x, w, g, taps), 10, 2),
                key=lambda d: -d[1]):
            print(f"[K2 bwd] {cin}->{cout} by kernel, per call: {ms:.4f} ms "
                  f"x{k} {key[:80]}")
        t = {}
        for part, fn in (("", lambda: ops.masked_conv2d_bwd(x, w, g, taps)),
                         ("dgrad_", lambda: mc._dgrad(x, w, g, taps)),
                         ("wgrad_", lambda: mc._wgrad(x, w, g, taps))):
            t[part + "ms"] = cuda_ms(fn)
            t[part + "device_ms"] = device_ms(fn)
        # dgrad's kernel alone, its inputs cast and packed
        gb, pk = g.to(torch.bfloat16), mc.dgrad_pack(w, taps)
        dx_t = torch.empty_like(x)
        mirrored = mc._mirrored(taps, kh, kw)
        t["dgrad_kernel_device_ms"] = device_ms(lambda: mc._launch_wgmma(
            mc._bwd_lib().masked_conv_dgrad_wgmma, "dgrad", gb, pk, dx_t,
            mirrored, kh, kw, mc.TILE))
        leaves = [t_.detach().clone().requires_grad_() for t_ in (x, w)]
        plain = _backward_ms(
            lambda a, b: ops.masked_conv2d_ref(a, b, taps), leaves, g)
        conv, _, _ = _k2_conv_lib(x, w)
        lib_args = (lambda a, b: conv(a.permute(0, 3, 1, 2),
                                      b.permute(3, 2, 0, 1)),
                    leaves, g.permute(0, 3, 1, 2).to(x.dtype))
        lib = _backward_ms(*lib_args)
        lib_dev = _backward_ms(*lib_args, timer=device_ms)
        n, hh, ww, _ = x.shape
        flops = 2 * 2 * n * hh * ww * len(taps) * cin * cout
        moved = (nbytes(x, g, *outs["bf16"]) + len(taps) * cin * cout
                 * w.element_size())
        b_ms, b_by = bound_ms(flops, "bfloat16", moved)
        _, chunks = mc.wgrad_chunks(n * hh * ww // mc._GW_PIXELS,
                                    mc.wgrad_m_blocks(len(taps), cin),
                                    mc._sm_count(x.device))
        partial_mb = 2 * chunks * len(taps) * cin * cout * 4 / 1e6
        print(f"[K2 bwd] {cin}->{cout} (dgrad, wgrad: {routes}): by events "
              f"{t['ms']:.4f} ms (dgrad {t['dgrad_ms']:.4f}, wgrad "
              f"{t['wgrad_ms']:.4f}), cuDNN {lib:.4f}; by device time "
              f"{t['device_ms']:.4f} ms (dgrad {t['dgrad_device_ms']:.4f}, "
              f"wgrad + reduce {t['wgrad_device_ms']:.4f}), cuDNN "
              f"{lib_dev:.4f}, ratio {t['device_ms'] / lib_dev:.3f}; dgrad "
              f"kernel alone {t['dgrad_kernel_device_ms']:.4f} ms; wgrad "
              f"{chunks} chunks, partials {partial_mb:.1f} MB written and "
              f"read; bound {b_ms:.4f} ms ({b_by})")
        shapes.append(dict(cin=cin, cout=cout, max_abs_err=errs["bf16"],
                           max_abs_err_f32=errs["f32"], plain_ms=plain,
                           library_ms=lib, library_device_ms=lib_dev,
                           bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9,
                           mbytes=moved / 1e6, wgrad_chunks=chunks,
                           partial_mbytes=partial_mb, **t))
    return _k2_row("masked_conv2d_bwd",
                   "iaf_torch/ops/csrc/masked_conv_bwd.cu",
                   "iaf_tpu/ops/masked_conv.py:98", shapes,
                   ("dgrad_ms", "dgrad_device_ms", "wgrad_ms",
                    "wgrad_device_ms", "dgrad_kernel_device_ms",
                    "partial_mbytes"))


def k2_forward_b32(ops, cap: dict, f32: bool) -> dict:
    """K2's forward at the 5x5 training step's shapes: the inputs of the
    three convs whose backward ``cap`` holds (one real step, batch 32 of
    16x16), on the tensor cores (``fwd_route``: bf16 ``"wgmma"``, f32
    ``"3xtf32"``), held to the twin (bf16 at 2e-2 of the output's max,
    f32 at 1e-5 of the twin in f64), on both launch plans (``k2_plans``:
    per plan the blocks, the conv kernel's and the pack's device ms, the
    bitwise flag against the 128-pixel plan; the two A B B A), the picked
    plan timed by events and by device time beside the twin and one cuDNN
    conv (device time and the ratio), with the bound from the shapes. Then
    once ``dgrad_plans`` for K2's three convs and K1's dgrad at batch 32.
    Returns the kernels-line row ``masked_conv2d_b32``
    (``masked_conv2d_f32_b32``)."""
    import torch
    from iaf_torch.ops import masked_conv as mc
    tag = "K2 f32 b32" if f32 else "K2 b32"
    shapes = []
    for (cin, cout), (x, w, _, taps) in sorted(cap.items()):
        route = mc.fwd_route(x, w, taps)
        check(route == ("3xtf32" if f32 else "wgmma"),
              f"{tag} {cin}->{cout} takes the {route} kernel")
        call = lambda: ops.masked_conv2d(x, w, taps)  # noqa: E731
        with torch.inference_mode():
            got = call()
            ref = (ops.masked_conv2d_ref(x.double(), w.double(), taps) if f32
                   else ops.masked_conv2d_ref(x, w, taps))
            err, rel = _rel_err(got, ref)
            tol = 1e-5 if f32 else 2e-2
            check(rel <= tol, f"{tag} {cin}->{cout}: {rel:.3e} of max > "
                  f"{tol}")
        plans = k2_plans(ops, tag, x, w, taps)
        picked = plans["rows"][plans["plan"]["tile_pixels"]]
        with torch.inference_mode():
            ms, dev = cuda_ms(call), picked["device_ms"]
            plain = cuda_ms(lambda: ops.masked_conv2d_ref(x, w, taps), 5, 1)
            conv, xl, wl = _k2_conv_lib(x, w)
            lib = cuda_ms(lambda: conv(xl, wl))
            lib_dev = device_ms(lambda: conv(xl, wl))
        n, hh, ww, _ = x.shape
        flops = 2 * n * hh * ww * len(taps) * cin * cout
        moved = nbytes(x, got) + len(taps) * cin * cout * w.element_size()
        if f32:
            b = _f32_bounds(flops, moved)
        else:
            b_ms, b_by = bound_ms(flops, "bfloat16", moved)
            b = dict(bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9,
                     mbytes=moved / 1e6)
        print(f"[{tag}] masked_conv2d x{tuple(x.shape)} {cin}->{cout}, "
              f"{len(taps)} live taps ({route}): {rel:.3e} of max from the "
              f"twin (limit {tol}); by events {ms:.4f} ms, by device time "
              f"{dev:.4f} ms on {_k2_plan_label(mc.FwdPlan(**plans['plan']))}"
              f" (kernel {picked['kernel_device_ms']:.4f}, pack "
              f"{picked['pack_device_ms']:.4f}), twin {plain:.4f} ms; cuDNN "
              f"{lib:.4f} ms, by device time {lib_dev:.4f} ms, ratio "
              f"{dev / lib_dev:.3f}; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}, {100 * b['bound_ms'] / dev:.0f} % of the "
              "device time)")
        shapes.append(dict(cin=cin, cout=cout, max_abs_err=err,
                           max_rel_err=rel, ms=ms, device_ms=dev,
                           kernel_device_ms=picked["kernel_device_ms"],
                           pack_device_ms=picked["pack_device_ms"],
                           plain_ms=plain, library_ms=lib,
                           library_device_ms=lib_dev, plans=plans, **b))
    dgrad = dgrad_plans(ops, tag, k2_dgrad_convs(cap, f32)
                        + k1_dgrad_convs(f32))
    extra = ("kernel_device_ms", "pack_device_ms")
    if f32:
        return _k2_row("masked_conv2d_f32_b32",
                       "iaf_torch/ops/csrc/masked_conv.cu",
                       "iaf_tpu/ops/masked_conv.py:40", shapes,
                       extra + ("design_bound_ms", "fp32_floor_ms"),
                       path="5x5 f32", counter="masked_conv2d",
                       kernel_route="3xtf32", dgrad_plans=dgrad)
    return _k2_row("masked_conv2d_b32", "iaf_torch/ops/csrc/masked_conv.cu",
                   "iaf_tpu/ops/masked_conv.py:40", shapes, extra, path="5x5",
                   counter="masked_conv2d", kernel_route="wgmma",
                   dgrad_plans=dgrad)


def _k2_split_ms(call) -> tuple[float, float, float]:
    """(device ms, the conv kernel's ms, the weight pack's ms) a call of
    K2's tensor-core forward ``call``: the conv kernel
    (``conv_wgmma_kernel`` or ``conv_tf32_kernel``) apart from the rest,
    the weight pack (``conv_pack_w_kernel``)."""
    found = device_kernels(call, expect=("conv_pack_w_kernel",))
    kern = sum(ms for k, ms, _ in found
               if "conv_wgmma_kernel" in k or "conv_tf32_kernel" in k)
    check(kern > 0, f"no conv kernel in the profile of a K2 call: {found}")
    total = sum(ms for _, ms, _ in found)
    return total, kern, total - kern


def _k2_plan_label(plan) -> str:
    return f"{plan.tile_pixels}-pixel tiles, {plan.blocks} blocks"


def k2_plans(ops, label: str, x, w, taps, abba: bool = True) -> dict:
    """K2's forward on (x, w, taps) on both launch plans (``fwd_plan``'s
    pick among them): 128-pixel tiles and 64-pixel tiles (one warpgroup
    a block), on the same inputs. The weight pack kernel
    (``fwd_pack_kernel``) must give ``fwd_pack``'s bytes, on ``w`` and on
    a copy of other strides. Each plan's output is held to the twin
    (bf16 at 2e-2 of max; f32 at 1e-5 of the twin in f64) and compared
    bitwise with the 128-pixel plan's (the phase fails where it differs);
    per plan its blocks (checked against the occupancy calculator's grid,
    with the blocks resident on one SM), the ring stages, device ms a call
    with the conv kernel and the weight pack apart, and events ms. With
    ``abba`` the 64-pixel plan against the 128-pixel one, A B B A by
    device time. Returns the numbers, ``rows`` by tile pixels."""
    import torch
    from iaf_torch.ops import masked_conv as mc
    from iaf_torch.ops.ar_stack import _SMEM_LIMIT
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    taps = mc._taps(w, taps)
    f32 = x.dtype == torch.float32
    sms = mc._sm_count(x.device)
    picked = mc.fwd_plan(x.dtype, n, h, w_, cin, cout, sms)
    wide = mc.tile_plan(n, h, w_, mc.TILE, sms)
    small = mc.tile_plan(n, h, w_, mc.SMALL_TILE, sms)
    tol = 1e-5 if f32 else 2e-2
    with torch.inference_mode():
        twin = mc.fwd_pack(w, taps, f32)
        strided = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
        pack_same = all(torch.equal(mc.fwd_pack_kernel(v, taps), twin)
                        for v in (w, strided))
        ref = ops.masked_conv2d_ref(*((x.double(), w.double()) if f32
                                      else (x, w)), taps)
        outs = {p: mc._fwd(x, w, taps, plan=p) for p in (wide, small)}
    check(pack_same, f"{label} {cin}->{cout}: the pack kernel's bytes are "
          "not fwd_pack's")
    rows = {}
    for p in (wide, small):
        err, rel = _rel_err(outs[p], ref)
        same = torch.equal(outs[p], outs[wide])
        blocks, per_sm = mc.fwd_grid(x, w, taps, p)
        stages = mc._lib().masked_conv_wgmma_stages_tile(
            w_, cin, kw, mc._span(taps), mc.wgmma_width(cout), len(taps),
            _SMEM_LIMIT, int(f32), p.tile_pixels)
        call = (lambda p=p: mc._fwd(x, w, taps, plan=p))  # noqa: E731
        with torch.inference_mode():
            dev, kern, pack = _k2_split_ms(call)
            ev = cuda_ms(call)
        rows[p.tile_pixels] = dict(
            plan=p._asdict(), picked=p == picked, grid_blocks=blocks,
            resident_per_sm=per_sm, stages=stages, max_abs_err=err,
            rel_err=rel, bitwise_128=same, device_ms=dev,
            kernel_device_ms=kern, pack_device_ms=pack, ms=ev)
        print(f"[{label} plans] {cin}->{cout} x{tuple(x.shape)} "
              f"{_k2_plan_label(p)}{' (picked)' if p == picked else ''}: "
              f"grid {blocks} blocks, {per_sm} resident an SM, {stages} "
              f"stages; {rel:.3e} of max from the twin"
              f"{' in f64' if f32 else ''} (limit {tol}), bitwise the "
              f"128-pixel plan's: {same}; device {dev:.4f} ms a call "
              f"(kernel {kern:.4f}, pack {pack:.4f}), events {ev:.4f} ms")
        check(rel <= tol, f"{label} {cin}->{cout} plan {p}: {rel} of max > "
              f"{tol}")
        check(same, f"{label} {cin}->{cout}: the {p.tile_pixels}-pixel "
              "plan is not bitwise the 128-pixel plan")
        check(blocks == p.blocks, f"{label} {cin}->{cout}: the launch's "
              f"grid {blocks} is not the plan's {p.blocks} blocks")
    result = dict(plan=picked._asdict(), rows=rows, pack_bitwise=pack_same)
    print(f"[{label} plans] {cin}->{cout}: the pack kernel gives fwd_pack's "
          f"bytes (also from a copy of other strides): {pack_same}")
    if abba:
        with torch.inference_mode():
            turns = [_k2_split_ms(lambda p=p: mc._fwd(x, w, taps, plan=p))
                     for p in (small, wide, wide, small)]
        dev = [t[0] for t in turns]
        result.update(abba=turns, small_device_ms=(dev[0] + dev[3]) / 2,
                      wide_device_ms=(dev[1] + dev[2]) / 2)
        print(f"[{label} plans] {cin}->{cout}: 64-pixel against 128-pixel "
              f"tiles, A B B A device ms {', '.join(f'{t:.4f}' for t in dev)}"
              f" (kernel {', '.join(f'{t[1]:.4f}' for t in turns)}): "
              f"{result['small_device_ms']:.4f} against "
              f"{result['wide_device_ms']:.4f}")
    return result


def dgrad_plans(ops, label: str, convs) -> dict:
    """dgrad's tensor-core kernel (the forward's kernel on the output
    gradient, the taps mirrored: ``masked_conv_dgrad_wgmma`` in bf16,
    ``masked_conv_dgrad_tf32`` in f32) on 128-pixel and on 64-pixel tiles,
    for each (name, g in the dgrad input's dtype, the packed transposed
    weights, dx's channels, the mirrored taps, kh, kw) of ``convs``: the
    kernel's device ms on each and whether the two dx agree bitwise.
    Measured for the next PR; the port's dgrad stays on 128-pixel tiles."""
    import torch
    from iaf_torch.ops import masked_conv as mc
    out = {}
    for name, gin, packed, c_dx, mirrored, kh, kw in convs:
        fn = (mc._bwd_lib().masked_conv_dgrad_tf32
              if gin.dtype == torch.float32
              else mc._bwd_lib().masked_conv_dgrad_wgmma)
        dx = {t: torch.empty(gin.shape[:3] + (c_dx,), device=gin.device,
                             dtype=gin.dtype) for t in (mc.TILE,
                                                        mc.SMALL_TILE)}
        ms = {}
        for t, d in dx.items():
            call = (lambda t=t, d=d: mc._launch_wgmma(  # noqa: E731
                fn, "dgrad", gin, packed, d, mirrored, kh, kw, t))
            call()
            ms[t] = device_ms(call, 10, 2)
        same = torch.equal(dx[mc.TILE], dx[mc.SMALL_TILE])
        out[name] = dict(tile128_device_ms=ms[mc.TILE],
                         tile64_device_ms=ms[mc.SMALL_TILE], bitwise=same)
        print(f"[{label} dgrad plans] {name} g{tuple(gin.shape)}: 128-pixel "
              f"tiles {ms[mc.TILE]:.4f} device ms, 64-pixel "
              f"{ms[mc.SMALL_TILE]:.4f} ({ms[mc.SMALL_TILE] / ms[mc.TILE]:.2f}"
              f"x), bitwise {same} (not routed)")
    return out


def k2_dgrad_convs(cap: dict, f32: bool) -> list:
    """``dgrad_plans``' inputs for K2's three convs of ``cap`` (one real
    step's backward inputs, batch 32)."""
    import torch
    from iaf_torch.ops import masked_conv as mc
    convs = []
    for (cin, cout), (x, w, g, taps) in sorted(cap.items()):
        kh, kw = w.shape[:2]
        gin = g if f32 else g.to(torch.bfloat16)
        convs.append((f"K2 {cin}->{cout}", gin, mc.dgrad_pack(w, taps, f32),
                      cin,
                      mc._mirrored(taps, kh, kw), kh, kw))
    return convs


def k1_dgrad_convs(f32: bool, n: int = 32) -> list:
    """``dgrad_plans``' inputs for K1's dgrad chain at batch ``n`` (the
    paper widths, weights and output gradients from a seed; each conv's
    dgrad on K2's kernels as ``ar_stack._dgrad_wgmma`` launches it)."""
    import torch
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    dtype = torch.float32 if f32 else torch.bfloat16
    gen = torch.Generator().manual_seed(23)
    ws, _, _ = _paper_chain(2, gen)
    ws = [w.cuda().to(dtype) for w in ws]
    packed = ar_mod.pack_dgrad(ws)
    convs = []
    for w, pk in zip(ws, packed):
        cin, cout = w.shape[2], w.shape[3]
        g = torch.randn(n, 16, 16, cout, generator=gen).cuda().to(dtype)
        convs.append((f"K1 {cin}->{cout}", g, pk, cin,
                      ar_mod.MIRRORED_TAPS, 3, 3))
    return convs


@contextlib.contextmanager
def k2_routes():
    """Record the route of every K2 forward (``fwd_route``) and backward
    (``bwd_route``) launched inside the block, in order."""
    mc = importlib.import_module("iaf_torch.ops.masked_conv")
    fwd, bwd = mc._fwd, mc.masked_conv2d_bwd
    seen = {"fwd": [], "bwd": []}

    def spy_fwd(x, w, taps, plan=None):
        seen["fwd"].append(mc.fwd_route(x, w, taps))
        return fwd(x, w, taps, plan)

    def spy_bwd(x, w, g, taps=None):
        seen["bwd"].append(mc.bwd_route(x, w, taps))
        return bwd(x, w, g, taps)
    mc._fwd, mc.masked_conv2d_bwd = spy_fwd, spy_bwd
    try:
        yield seen
    finally:
        mc._fwd, mc.masked_conv2d_bwd = fwd, bwd


@contextlib.contextmanager
def k2_fma():
    """Inside the block every K2 launch takes its FMA kernel (what the
    f32 recipe ran before the 3xTF32 route: its yardstick in the same
    run)."""
    mc = importlib.import_module("iaf_torch.ops.masked_conv")
    route, wroute = mc._route, mc._wgrad_route
    mc._route = mc._wgrad_route = lambda *a: "fma"
    try:
        yield
    finally:
        mc._route, mc._wgrad_route = route, wroute


def _full_f32(label: str, *ts) -> None:
    """Each tensor is f32 with low mantissa bits set somewhere: an upcast
    from bf16 leaves them zero and would hide a kernel that drops the lo
    parts of its split operands."""
    import torch
    check(all(t.dtype == torch.float32 for t in ts),
          f"{label}: the captured inputs are not f32")
    full = [bool((t.view(torch.int32) & 0xFFFF).any()) for t in ts]
    check(all(full), f"{label}: f32 inputs without low mantissa bits: "
          f"{full}")


def k2_f32_forward_phase(ops, cap: dict) -> dict:
    """K2 in f32 (the 5x5 config's f32 recipe) on the inputs of one real
    f32 eval chunk (16 images x 64 samples; full f32 mantissas): each conv
    must take the 3xTF32 route (``fwd_route`` ``"3xtf32"``), give the same
    bits on two calls and hold the twin in f64 at 1e-5 of the output's
    max; device time by kernel; timed by events and by device time beside
    the FMA kernel it replaces (same inputs, same run), the twin and one
    cuDNN f32 conv (TF32 off), with the bound, the 3xTF32 design's floor
    and the FP32 CUDA-core floor (``_f32_bounds``). The control, one TF32
    product per f32 product on the same inputs (``_tf32``), must miss the
    1e-5 limit. Returns the kernels-line row."""
    import torch
    from iaf_torch.ops import masked_conv as mc
    shapes = []
    for (cin, cout), (x, w, taps) in sorted(cap.items()):
        _full_f32(f"K2 f32 {cin}->{cout}", x, w)
        route = mc.fwd_route(x, w, taps)
        check(route == "3xtf32", f"K2 f32 {cin}->{cout} takes the {route} "
              "kernel, not the 3xTF32 tensor-core one")
        call = lambda: ops.masked_conv2d(x, w, taps)  # noqa: E731
        with torch.inference_mode():
            got = call()
            check(torch.equal(got, call()),
                  f"K2 f32 {cin}->{cout}: two calls differ")
            ref = ops.masked_conv2d_ref(x.double(), w.double(), taps)
            err, rel = _rel_err(got, ref)
            check(rel <= 1e-5, f"K2 f32 {cin}->{cout}: {rel:.3e} of max "
                  "from the f64 twin > 1e-5")
            one = _rel_err(ops.masked_conv2d_ref(_tf32(x), _tf32(w), taps),
                           ref)[1]
            check(one > 1e-5, f"K2 f32 {cin}->{cout}: one TF32 product "
                  f"per f32 product is {one:.3e} of max from the f64 twin, "
                  "within the 1e-5 limit")
            per_call = _by_kernel(f"K2 f32 {cin}->{cout}", call)
            ms = cuda_ms(call)
            dev = device_ms(call)
            with k2_fma():
                fma_dev = device_ms(call, 5, 1)
            plain = cuda_ms(lambda: ops.masked_conv2d_ref(x, w, taps), 5, 1)
            conv, xl, wl = _k2_conv_lib(x, w)
            lib = cuda_ms(lambda: conv(xl, wl), 5, 1)
            lib_dev = device_ms(lambda: conv(xl, wl), 5, 1)
        n, hh, ww, _ = x.shape
        b = _f32_bounds(2 * n * hh * ww * len(taps) * cin * cout,
                        nbytes(x, got) + len(taps) * cin * cout * 4)
        print(f"[K2 f32] {cin}->{cout} x{tuple(x.shape)} ({route}): "
              f"{rel:.3e} of max from the f64 twin (max abs {err:.3e}; "
              f"limit 1e-5; one TF32 product per f32 product, the control: "
              f"{one:.3e}), two calls bitwise equal; by events {ms:.4f} ms, "
              f"by device time "
              f"{dev:.4f} ms ({per_call} device launches a call), the FMA "
              f"kernel {fma_dev:.4f} ms; cuDNN f32 (TF32 off) {lib:.4f} ms, "
              f"by device time {lib_dev:.4f} ms, ratio {dev / lib_dev:.3f}; "
              f"{_f32_bound_text(b, dev)}")
        shapes.append(dict(cin=cin, cout=cout, max_abs_err=err,
                           max_rel_err=rel, one_tf32_rel_err=one, ms=ms,
                           device_ms=dev,
                           fma_device_ms=fma_dev, plain_ms=plain,
                           library_ms=lib, library_device_ms=lib_dev,
                           device_launches_per_call=per_call, **b))
    return _k2_row("masked_conv2d_f32", "iaf_torch/ops/csrc/masked_conv.cu",
                   "iaf_tpu/ops/masked_conv.py:40", shapes,
                   ("fma_device_ms", "design_bound_ms", "fp32_floor_ms"),
                   path="5x5 f32",
                   counter="masked_conv2d", kernel_route="3xtf32")


def k2_f32_backward_phase(ops, cap: dict) -> dict:
    """K2's backward in f32 on each captured conv of a real 5x5 f32
    training step (batch 32; full f32 mantissas): dgrad and wgrad must
    take the 3xTF32 route (``bwd_route``); dx and dW (live taps; the dead
    ones zero) within 1e-5 of each one's max of the twin in f64 (the
    values printed), where one TF32 product per f32 product on the same
    inputs (``_tf32``) must miss that limit in both; two calls bitwise
    equal. Device time by kernel;
    timed by events and by device time, whole and as dgrad and wgrad
    apart, beside the FMA kernels they replace (same run), the twin's
    backward and autograd of one cuDNN f32 conv (TF32 off), with the
    bounds of ``_f32_bounds``. Returns the kernels-line row."""
    import torch
    from iaf_torch.ops import masked_conv as mc
    shapes = []
    for (cin, cout), (x, w, g, taps) in sorted(cap.items()):
        _full_f32(f"K2 bwd f32 {cin}->{cout}", x, w, g)
        kh, kw = w.shape[:2]
        routes = mc.bwd_route(x, w, taps)
        check(routes == ("3xtf32", "3xtf32"), f"K2 bwd f32 {cin}->{cout} "
              f"takes dgrad, wgrad on {routes}, not 3xTF32")
        call = lambda: ops.masked_conv2d_bwd(x, w, g, taps)  # noqa: E731
        dx_, dw_ = call()
        again = call()
        check(torch.equal(dx_, again[0]) and torch.equal(dw_, again[1]),
              f"K2 bwd f32 {cin}->{cout}: two calls differ")
        live = torch.zeros(kh, kw, 1, 1, device=x.device)
        for dy, dx in taps:
            live[dy, dx] = 1.0
        check(not bool((dw_ * (1 - live)).any()),
              f"K2 bwd f32 {cin}->{cout}: dW nonzero at a dead tap")
        rdx, rdw = ops.masked_conv2d_bwd_ref(x.double(), w.double(),
                                             g.double(), taps)
        (ex, rx), (ew, rw) = (_rel_err(dx_, rdx),
                              _rel_err(dw_ * live, rdw * live))
        check(max(rx, rw) <= 1e-5, f"K2 bwd f32 {cin}->{cout}: dx {rx:.3e}, "
              f"dW {rw:.3e} of max from the f64 twin > 1e-5")
        odx, odw = ops.masked_conv2d_bwd_ref(_tf32(x), _tf32(w), _tf32(g),
                                             taps)
        ox, ow = _rel_err(odx, rdx)[1], _rel_err(odw * live, rdw * live)[1]
        check(min(ox, ow) > 1e-5, f"K2 bwd f32 {cin}->{cout}: one TF32 "
              f"product per f32 product is dx {ox:.3e}, dW {ow:.3e} of max "
              "from the f64 twin, within the 1e-5 limit")
        for key, k_ms, k in sorted(device_kernels(call, 10, 2),
                                   key=lambda d: -d[1]):
            print(f"[K2 bwd f32] {cin}->{cout} by kernel, per call: "
                  f"{k_ms:.4f} ms x{k} {key[:80]}")
        t = {}
        for part, fn in (("", call),
                         ("dgrad_", lambda: mc._dgrad(x, w, g, taps)),
                         ("wgrad_", lambda: mc._wgrad(x, w, g, taps))):
            t[part + "ms"] = cuda_ms(fn)
            t[part + "device_ms"] = device_ms(fn)
        with k2_fma():
            fma_dev = device_ms(call, 5, 1)
        leaves = [t_.detach().clone().requires_grad_() for t_ in (x, w)]
        plain = _backward_ms(
            lambda a, b: ops.masked_conv2d_ref(a, b, taps), leaves, g)
        conv, _, _ = _k2_conv_lib(x, w)
        lib_args = (lambda a, b: conv(a.permute(0, 3, 1, 2),
                                      b.permute(3, 2, 0, 1)),
                    leaves, g.permute(0, 3, 1, 2))
        lib = _backward_ms(*lib_args)
        lib_dev = _backward_ms(*lib_args, timer=device_ms)
        n, hh, ww, _ = x.shape
        b = _f32_bounds(2 * 2 * n * hh * ww * len(taps) * cin * cout,
                        nbytes(x, g, dx_, dw_) + len(taps) * cin * cout * 4)
        _, chunks = mc.wgrad_chunks(n * hh * ww // mc._GT_PIXELS,
                                    mc.wgrad_m_blocks(len(taps), cin),
                                    mc._sm_count(x.device))
        print(f"[K2 bwd f32] {cin}->{cout} (dgrad, wgrad: {routes}): dx "
              f"{rx:.3e}, dW {rw:.3e} of max from the f64 twin (max abs "
              f"{max(ex, ew):.3e}; limit 1e-5; one TF32 product per f32 "
              f"product, the control: dx {ox:.3e}, dW {ow:.3e}), two calls "
              f"bitwise equal; "
              f"by events {t['ms']:.4f} ms (dgrad {t['dgrad_ms']:.4f}, "
              f"wgrad {t['wgrad_ms']:.4f}), by device time "
              f"{t['device_ms']:.4f} ms (dgrad {t['dgrad_device_ms']:.4f}, "
              f"wgrad + reduce {t['wgrad_device_ms']:.4f}), the FMA kernels "
              f"{fma_dev:.4f} ms; cuDNN f32 (TF32 off) {lib:.4f} ms, by "
              f"device time {lib_dev:.4f} ms, ratio "
              f"{t['device_ms'] / lib_dev:.3f}; wgrad {chunks} chunks; "
              f"{_f32_bound_text(b, t['device_ms'])}")
        shapes.append(dict(cin=cin, cout=cout, max_abs_err=max(ex, ew),
                           max_rel_err=max(rx, rw),
                           one_tf32_rel_err=min(ox, ow),
                           fma_device_ms=fma_dev,
                           plain_ms=plain, library_ms=lib,
                           library_device_ms=lib_dev, wgrad_chunks=chunks,
                           **b, **t))
    return _k2_row("masked_conv2d_bwd_f32",
                   "iaf_torch/ops/csrc/masked_conv_bwd.cu",
                   "iaf_tpu/ops/masked_conv.py:98", shapes,
                   ("dgrad_ms", "dgrad_device_ms", "wgrad_ms",
                    "wgrad_device_ms", "fma_device_ms", "design_bound_ms",
                    "fp32_floor_ms"),
                   path="5x5 f32", counter="masked_conv2d_bwd",
                   kernel_route="3xtf32")


def five_by_five_f32_phases(ops, device, model, ds):
    """The 5x5 config's f32 recipe (``compute_dtype=float32``, phase 12 of
    the module docstring) on the bf16 phases' model. Returns (K2's three
    f32 rows, the eval and training launch counts, a summary)."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.models import cvae
    from iaf_torch.ops import masked_conv
    from iaf_torch.parallel import train_step as ts
    hp = PAPER5 + ",compute_dtype=float32"
    cfg = Config().parse(hp + f",dataset=synthetic,eval_batch_size="
                         f"{EVAL_BATCH},eval_k_chunk={EVAL_CHUNK}")

    def one_chunk():
        with torch.inference_mode():
            cvae.apply_fn(cfg, model, 1, ds.test_x[:EVAL_BATCH], mode="eval",
                          k=EVAL_CHUNK)
    rows = [k2_f32_forward_phase(ops, capture_k2(ops, "masked_conv2d",
                                                 one_chunk))]
    chunk = profile_phase(f"5x5 f32: one eval chunk (16 images x "
                          f"{EVAL_CHUNK} samples)", one_chunk)
    blocks = len(model.blocks)
    with k2_routes() as routes:
        eval_counts, main = eval_phase(
            ops, device, cfg, model, ds,
            {"masked_conv2d": blocks * (cfg.depth_ar + 1),
             "iaf_update": blocks, "disc_logistic_logp": 1})
    check(routes["fwd"] and set(routes["fwd"]) == {"3xtf32"},
          f"5x5 f32 eval: K2 routes {sorted(set(routes['fwd']))}, not all "
          "3xtf32")
    main["profile"] = chunk

    tcfg = Config().parse(hp + ",dataset=synthetic")
    tbatch = ds.train_x[:tcfg.batch_size]
    tstate = ts.init_train_state(tcfg, 11, tbatch, device)
    cap = capture_k2(masked_conv, "masked_conv2d_bwd",
                     lambda: ts.train_step(tcfg, tstate, 3, tbatch))
    rows.append(k2_f32_backward_phase(ops, cap))
    rows.append(k2_forward_b32(ops, cap, True))
    del cap, tstate
    torch.cuda.empty_cache()
    with k2_routes() as routes:
        tcfg, tstate, counts, summary = train_phase(
            ops, device, hp, PER_STEP_5X5, F32_TRAIN_STEPS, 0)
    py = GRAPH_PY_STEPS   # the warm-up step and the capture; see f32_phases
    check(len(routes["fwd"]) == py * PER_STEP_5X5["masked_conv2d"]
          and set(routes["fwd"]) == {"3xtf32"}
          and len(routes["bwd"]) == py * PER_STEP_5X5["masked_conv2d_bwd"]
          and set(routes["bwd"]) == {("3xtf32", "3xtf32")},
          f"5x5 f32 training: K2 routes {sorted(set(routes['fwd']))}, "
          f"{sorted(set(routes['bwd']))} ({len(routes['fwd'])}, "
          f"{len(routes['bwd'])}), not all 3xtf32")
    print(f"[main] 5x5 f32: every K2 forward and backward of the eval and "
          f"the training runs took the 3xtf32 route ({counts['masked_conv2d']}"
          f" forwards and {counts['masked_conv2d_bwd']} backwards in "
          f"training, {len(routes['fwd'])} and {len(routes['bwd'])} of them "
          f"chosen by the warm-up step and the capture, the rest replays)")
    summary["profile"] = profile_phase(
        f"5x5 f32: one training step (batch {tcfg.batch_size})",
        lambda: ts.train_step(tcfg, tstate, 99, tbatch))
    return rows, eval_counts, counts, {"main": main, "train": summary}


def five_by_five_phases(ops, device, ds):
    """The 5x5 config's phases (phases 11 and 12 of the module docstring).
    Returns (K2's three bf16 rows, the eval and training launch counts, a
    summary, and ``five_by_five_f32_phases``'s four results)."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.models import cvae
    from iaf_torch.ops import masked_conv
    from iaf_torch.parallel import train_step as ts
    cfg = Config().parse(PAPER5 + f",dataset=synthetic,eval_batch_size="
                         f"{EVAL_BATCH},eval_k_chunk={EVAL_CHUNK}")
    t0 = time.perf_counter()
    model = cvae.init_params(cfg, ds.train_x[:32], rng=cfg.seed,
                             device=device)
    torch.cuda.synchronize()
    print(f"[init] 5x5 config: {len(model.blocks)} IAF layers, h="
          f"{cfg.h_size}, z={cfg.z_size}, kernel_size={cfg.kernel_size}, "
          f"{sum(p.numel() for p in model.parameters())} params, "
          f"{time.perf_counter() - t0:.1f} s")

    def one_chunk():
        with torch.inference_mode():
            cvae.apply_fn(cfg, model, 1, ds.test_x[:EVAL_BATCH], mode="eval",
                          k=EVAL_CHUNK)
    rows = [k2_forward_phase(ops, capture_k2(ops, "masked_conv2d",
                                             one_chunk))]
    glue = glue_route_phase(cfg, model, ds.test_x[:EVAL_BATCH], EVAL_CHUNK,
                            "5x5")
    profile_phase(f"5x5: one eval chunk (16 images x {EVAL_CHUNK} samples)",
                  one_chunk)
    reference_phase(device, PAPER5)
    convs = len(model.blocks) * (cfg.depth_ar + 1)
    eval_counts, main = eval_phase(
        ops, device, cfg, model, ds,
        {"masked_conv2d": convs, "iaf_update": len(model.blocks),
         "disc_logistic_logp": 1})
    f32 = five_by_five_f32_phases(ops, device, model, ds)
    del model
    torch.cuda.empty_cache()

    tcfg = Config().parse(PAPER5 + ",dataset=synthetic")
    tbatch = ds.train_x[:tcfg.batch_size]
    tstate = ts.init_train_state(tcfg, 11, tbatch, device)
    cap = capture_k2(masked_conv, "masked_conv2d_bwd",
                     lambda: ts.train_step(tcfg, tstate, 3, tbatch))
    rows.append(k2_backward_phase(ops, cap))
    rows.append(k2_forward_b32(ops, cap, False))
    del cap, tstate
    torch.cuda.empty_cache()
    train_reference_phase(device, PAPER5)
    tcfg, tstate, counts, summary = train_phase(ops, device, PAPER5,
                                                PER_STEP_5X5)
    summary["profile"] = profile_phase(
        f"5x5: one training step (batch {tcfg.batch_size})",
        lambda: ts.train_step(tcfg, tstate, 99, tbatch))
    main["glue_route"] = glue
    return rows, eval_counts, counts, {"main": main, "train": summary}, f32


@contextlib.contextmanager
def _default_tf32():
    """Inside the block PyTorch's default TF32 flags (on for cuDNN's convs,
    off for matmuls), what a process of the CLI starts with; this script
    turns both off for its twins."""
    import torch
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def serve_phase(ops, device, cfg) -> tuple[list[dict], dict, dict]:
    """Phase 14: the serving modes on phase 9's logdir (its step-12
    checkpoint, the paper config in bf16), each entry point under
    PyTorch's default TF32 flags. Returns (the kernels rows at the
    serving shapes, each serving path's launch counts, the summary)."""
    import numpy as np
    import torch
    from iaf_torch import train_lib
    from iaf_torch.models import cvae
    from iaf_torch.models.inversion import (invert_ar_fixed_point,
                                            sweep_changes)
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    logdir = cfg.logdir
    out = os.path.join(HERE, "build", "chip_smoke_serve")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    summary: dict = {}
    layers = cfg.num_blocks * cfg.depth
    per_chunk = with_glue({"ar_stack": layers, "iaf_update": layers,
                           "disc_logistic_logp": 1}, cfg)

    def counted(label, fn, per: dict | None, times: int = 1):
        """``fn``'s result, seconds and launch counts; with ``per`` the
        counts must be exactly ``per`` x ``times``."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with _default_tf32():
            result = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        print(f"[serve] {label}: {secs:.3f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        if per is not None:
            want = _expect(counts, per, times)
            check(counts == want, f"{label}: launch counts {counts} != "
                  f"{want}")
        return result, secs, counts

    # (a) eval_loop: one poll, one batch of 16 at k=256 (4 chunks)
    _, secs, _ = counted(
        "eval_loop (max_evals=1, k=256, max_batches=1)",
        lambda: train_lib.eval_loop(cfg, max_evals=1, k=EVAL_K,
                                    max_batches=1, device=device),
        per_chunk, EVAL_K // EVAL_CHUNK)
    with open(os.path.join(logdir, "eval_test_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check(len(rows) == 1 and rows[0]["step"] == TRAIN_STEPS + RESUME_STEPS
          and math.isfinite(rows[0]["bits_per_dim"]),
          f"eval_test_metrics.jsonl rows {rows}")
    summary["eval_loop"] = {"bits_per_dim": rows[0]["bits_per_dim"],
                            "step": rows[0]["step"], "seconds": secs}

    # (b) a 1-batch eval resumed to 2 batches against a straight 2-batch one
    prog = os.path.join(out, "eval_progress_eval_test.json")
    log = io.StringIO()
    with _default_tf32():
        straight = train_lib.evaluate(cfg, k=EVAL_K, max_batches=2,
                                      device=device)
        train_lib.evaluate(cfg, k=EVAL_K, max_batches=1,
                           progress_path=prog, progress_every=1,
                           device=device)
        check(os.path.isfile(prog), "no progress file after the 1-batch eval")
        with contextlib.redirect_stdout(log):
            resumed = train_lib.evaluate(cfg, k=EVAL_K, max_batches=2,
                                         progress_path=prog,
                                         progress_every=1, device=device)
    print("\n".join(f"[serve] {line}" for line in
                    log.getvalue().splitlines()))
    check("resuming at batch 1/2" in log.getvalue(), "the eval did not resume")
    check(os.path.isfile(prog), "the progress file went after a capped run")
    rel = abs(resumed - straight) / abs(straight)
    print(f"[serve] resumed eval {resumed!r} against a straight run "
          f"{straight!r}: {rel:.3e} relative (limit 1e-6)")
    check(rel <= 1e-6, f"resumed eval {rel} relative from the straight run")
    summary["resume"] = {"straight": straight, "resumed": resumed,
                         "rel_diff": rel}

    # (c) reconstruct: one eval forward of 16 images at k=1; the first
    # call of each kernel's wrapper captured, then held to its twin
    got: dict = {}
    cap, secs, recon_counts = counted(
        "reconstruct(num=16)",
        lambda: capture_inputs(ops, lambda: got.update(
            recon=train_lib.reconstruct(
                cfg, num=16, device=device,
                out_path=os.path.join(out, "recons.npy")))),
        per_chunk)
    recon = got["recon"]
    check(recon.shape == (16, 32, 32, 3) and recon.dtype == np.uint8,
          f"recon {recon.shape} {recon.dtype}")
    summary["recon_seconds"] = secs
    z, ctx, ws, bs, masks = cap["ar_stack"]
    mean, logscale, smp = cap["disc_logistic_logp"]
    check(z.shape[0] == cap["iaf_update"][0].shape[0] == mean.shape[0] == 16,
          "reconstruct's kernels did not run at N = 16")
    k1 = dict(route="cuda", source="iaf_torch/ops/csrc/ar_stack.cu",
              replaces="iaf_tpu/ops/ar_stack.py:115", counter="ar_stack")
    k3 = dict(route="triton", source="iaf_torch/ops/fused.py",
              replaces="iaf_tpu/ops/fused.py:43", counter="iaf_update")
    kernel_rows = [
        dict(name="ar_stack_recon", path="serve recon", shape=list(z.shape),
             **k1, **k1_forward(ops, ar_mod, z, ctx, ws, bs, masks,
                                "K1 recon"),
             plans=k1_plans(ops, ar_mod, "N=16 bf16", z, ctx, ws, bs,
                            False)),
        dict(name="iaf_update_recon", path="serve recon",
             shape=list(z.shape), **k3,
             **k3_forward(ops, cap["iaf_update"], "K3 recon")),
        dict(name="disc_logistic_logp_recon", path="serve recon",
             route="cuda", source="iaf_torch/ops/csrc/disc_logistic.cu",
             replaces="iaf_tpu/ops/fused.py:103",
             counter="disc_logistic_logp", shape=list(mean.shape),
             **k4_forward(ops, mean, logscale, smp, "K4 recon"))]
    del cap

    # (d) sample: the prior decode launches no kernel of the port; its
    # result under the default flags equals one with TF32 off everywhere
    temps = [1.0, 0.5]
    imgs, secs, _ = counted(
        "sample(num=16, temperature=[1.0, 0.5])",
        lambda: train_lib.sample(cfg, num=16, temperature=temps,
                                 device=device,
                                 out_path=os.path.join(out, "samples.npy")),
        {})
    tiles = [np.load(os.path.join(out, f"samples_T{t}.npy")) for t in temps]
    check(not np.array_equal(*tiles), "T=1.0 and T=0.5 gave the same tile")
    model = train_lib._serving_model(cfg, True, device)
    with torch.inference_mode():
        raw = cvae.cvae_sample(cfg, model, cfg.seed + 4242, 16, temps[-1])
    check(bool(torch.isfinite(raw).all()), "non-finite samples")
    check(np.array_equal(raw.cpu().numpy().astype(np.uint8), imgs),
          "sample() differs from cvae_sample on its key")
    print(f"[serve] sample: {secs:.3f} s a call ({len(temps)} "
          f"temperatures, checkpoint load included), images in "
          f"[{float(raw.min()):.1f}, {float(raw.max()):.1f}], equal to "
          "cvae_sample's with TF32 off in the whole process")
    summary["sample_seconds_per_call"] = secs

    # (e) invert_check at batch 2: K1 f32 (3xTF32) at N = 2 first, on
    # the inputs invert_check builds
    with torch.inference_mode():
        z0, context, ar_fn, z_prime = train_lib.inversion_inputs(
            cfg, model, 2)
        cap = capture_inputs(ops, lambda: ar_fn(z_prime), ("ar_stack",))
    # what an inverse that returns z' unchanged would be off by: the
    # round-trip limit below must be able to fail on this checkpoint
    unmoved = float(torch.max(torch.abs(z_prime - z0)))
    print(f"[serve] the top layer's flow moves z by {unmoved:.3e} (max "
          "abs): the round-trip error of a do-nothing inverse")
    check(unmoved > 1e-4, f"the flow moves z by {unmoved} <= 1e-4: the "
          "round-trip limit cannot fail")
    z, ctx, ws, bs, masks = cap["ar_stack"]
    check(z.dtype == torch.float32 and z.shape[0] == 2,
          f"the inversion's K1 input {z.dtype} {tuple(z.shape)}")
    row = _k1_f32_shape(ops, ar_mod, "N=2 inversion", z, ctx, ws, bs, masks,
                        False)
    row["plans"] = k1_plans(ops, ar_mod, "N=2 f32", z, ctx, ws, bs, False)
    kernel_rows.append(dict(name="ar_stack_f32_inversion", path="serve",
                            kernel_route="3xtf32", shape=list(z.shape),
                            **k1, **row))
    # the exact inverse only where it and Jacobi take under 120 s
    D = z_prime.shape[1] * z_prime.shape[2] * z_prime.shape[3]
    with torch.inference_mode():
        sweep = cuda_ms(lambda: ar_fn(z_prime), 50, 3) / 1e3
    predicted = 2 * D * sweep
    run_exact = predicted < 120.0
    print(f"[serve] one inversion sweep {sweep * 1e3:.4f} ms: exact and "
          f"Jacobi ({D} sweeps each) predicted {predicted:.1f} s, "
          + ("under 120 s: running the exact inverse" if run_exact else
             "over 120 s: run_exact=False"))
    cap, secs, inv_counts = counted(
        "invert_check(batch=2)",
        lambda: capture_inputs(ops, lambda: got.update(
            res=train_lib.invert_check(cfg, batch=2, run_exact=run_exact,
                                       device=device)), ("iaf_update",)),
        None)
    res = got["res"]
    # the flow's forward once, then every sweep the blocks run, idle ones
    # included
    want = {"ar_stack": 1 + inverse_sweeps(D, res["iters_fixed_point"],
                                           run_exact), "iaf_update": 1}
    check(inv_counts == _expect(inv_counts, want, 1),
          f"invert_check launches {inv_counts} != {want}")
    print(f"[serve] invert_check: D={D}, iters_fixed_point "
          f"{res['iters_fixed_point']}, " + ", ".join(
              f"{k} {v:.3e}" for k, v in res.items() if k.startswith("err"))
          + "; " + ", ".join(f"{k} {v:.3f} s" for k, v in res.items()
                             if k.startswith("t_")))
    from iaf_torch.models import inversion
    graphed_sweep = res["t_jacobi"] / _blocked(D, inversion.EXACT_BLOCK)
    print(f"[serve] invert_check {secs:.3f} s, K1 {inv_counts['ar_stack']} "
          f"launches; one sweep called alone {sweep * 1e3:.4f} ms, one "
          f"sweep of the graphed Jacobi loop {graphed_sweep * 1e3:.4f} ms "
          f"(the host loops: {INVERT_BEFORE[0]} s, {INVERT_BEFORE[1]} ms a "
          f"sweep)")
    check(res["err_jacobi"] < 1e-4 and res["err_fixed_point"] < 1e-4,
          f"inversion round trip {res}")
    if run_exact:
        check(res["err_exact"] < 1e-4, f"exact round trip {res}")
    check(cap["iaf_update"][0].shape[0] == 2,
          "invert_check's K3 did not run at N = 2")
    kernel_rows.append(dict(
        name="iaf_update_inversion", path="serve",
        shape=list(cap["iaf_update"][0].shape), **k3,
        **k3_forward(ops, cap["iaf_update"], "K3 inversion")))

    # the fixed-point inverse on the same z', card against the CPU twins
    cpu = cvae.CVAE(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_ctx, cpu_zp = context.cpu(), z_prime.cpu()

    def cpu_ar_fn(zq):
        m, s = cpu.blocks[-1].ar1(zq, cpu_ctx)
        return m * 0.1, s * 0.1

    with torch.inference_mode():
        z_card, n_card = invert_ar_fixed_point(ar_fn, z_prime)
        z_cpu, n_cpu = invert_ar_fixed_point(cpu_ar_fn, cpu_zp)
        err, rel = _rel_err(z_card.cpu(), z_cpu)
        # the counts at 1e-6 decide on a change of a few ulps of z; at a
        # tol halfway (in log) between the CPU's changes either side of
        # 1e-6 they must be equal
        deltas = sweep_changes(cpu_ar_fn, cpu_zp, 1e-6)
        tol = math.sqrt(deltas[-2] * deltas[-1])
        _, n_card_wp = invert_ar_fixed_point(ar_fn, z_prime, tol=tol)
        _, n_cpu_wp = invert_ar_fixed_point(cpu_ar_fn, cpu_zp, tol=tol)
    print(f"[serve] fixed-point inverse, card against the CPU twins: "
          f"{rel:.3e} of max (max abs {err:.3e}, limit 1e-5); sweeps at tol "
          f"1e-6: card {n_card}, CPU {n_cpu}; at tol {tol:.3e}: card "
          f"{n_card_wp}, CPU {n_cpu_wp}; the CPU's last changes "
          f"{[f'{d:.3e}' for d in deltas[-4:]]}")
    check(rel <= 1e-5, f"card fixed-point inverse {rel} of max from CPU's")
    check(n_card_wp == n_cpu_wp == len(deltas),
          f"fixed-point sweeps card {n_card_wp}, CPU {n_cpu_wp}, "
          f"{len(deltas)} changes")
    check(abs(n_card - n_cpu) <= 1, f"sweeps at 1e-6: {n_card}, {n_cpu}")
    summary["invert_check"] = {**res, "run_exact": run_exact,
                               "sweep_ms": sweep * 1e3,
                               "graphed_sweep_ms": graphed_sweep * 1e3,
                               "k1_launches": inv_counts["ar_stack"],
                               "flow_moves_z": unmoved,
                               "card_vs_cpu_rel_err": rel,
                               "iters_card": n_card, "iters_cpu": n_cpu,
                               "seconds": secs}
    return kernel_rows, {"serve": inv_counts,
                         "serve recon": recon_counts}, summary


def _blocked(sweeps: int, block: int) -> int:
    """The sweeps that blocks of ``block`` run to reach ``sweeps``."""
    return -(-sweeps // block) * block


def inverse_sweeps(D: int, fixed_point: int, run_exact: bool = True) -> int:
    """K1's launches in ``invert_check``'s inverses: the exact (where run)
    and Jacobi loops' D sweeps and the fixed point's, each rounded up to
    whole blocks (``models/inversion.py``)."""
    from iaf_torch.models import inversion
    return ((2 if run_exact else 1) * _blocked(D, inversion.EXACT_BLOCK)
            + _blocked(fixed_point, inversion.FIXED_POINT_BLOCK))


def _state_copy(cfg, state, device):
    """A training state on ``device`` with its own tensors, equal to
    ``state``'s."""
    from iaf_torch import optim
    from iaf_torch.models import get_model
    from iaf_torch.parallel import train_step as ts
    model = get_model(cfg).Model(cfg, device=device)
    model.load_state_dict(state.params.state_dict())
    opt = state.opt
    return ts.TrainState(model, optim.AdamaxState(
        opt.step.to(device, copy=True),
        *({k: v.to(device, copy=True) for k, v in part.items()}
          for part in (opt.m, opt.u, opt.ema))))


def _state_diffs(a, b, losses_a, losses_b) -> dict:
    """The largest absolute difference between two training states (and
    their losses), by part: loss, grad (None as zeros), param, m, u, ema,
    step."""
    import torch
    out = {"loss": max(abs(x - y) for x, y in zip(losses_a, losses_b))}
    pa = dict(a.params.named_parameters())
    pb = dict(b.params.named_parameters())

    def worst(pairs):
        return max(float((x - y).abs().max()) for x, y in pairs)

    def grad(p):
        return torch.zeros_like(p) if p.grad is None else p.grad
    out["grad"] = worst((grad(pa[k]), grad(pb[k])) for k in pa)
    out["param"] = worst((pa[k].detach(), pb[k].detach()) for k in pa)
    for part in ("m", "u", "ema"):
        out[part] = worst((getattr(a.opt, part)[k], getattr(b.opt, part)[k])
                          for k in pa)
    out["step"] = abs(int(a.opt.step) - int(b.opt.step))
    return out


def graph_vs_eager(ops, device, hp: str, steps: int = 3,
                   deterministic: bool = False) -> dict:
    """Phase 15(a): ``steps`` eager ``train_step``s on one copy of a state
    and the graphed step (``make_train_step``: warmed up, captured, then
    replayed) on another, same batches, keys and so noise; two more eager
    copies are the controls. Each part's limit is the largest difference,
    part by part, over the pairs eager-control 1, eager-control 2 and
    control 1-control 2: where all three are bitwise the graph must be
    bitwise; elsewhere it may differ from the eager run by at most
    ``NONDET_MARGIN`` times that limit. ``deterministic`` runs all four
    with cuDNN's deterministic algorithms."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.core.device import cudnn_deterministic
    from iaf_torch.parallel import train_step as ts
    cfg = Config().parse(hp + ",dataset=synthetic")
    tag = _label(cfg) + (", cuDNN deterministic" if deterministic else "")
    B = cfg.batch_size
    x = _train_images(cfg, B * steps)
    eager_runs = ("eager", "control 1", "control 2")
    with (cudnn_deterministic() if deterministic
          else contextlib.nullcontext()):
        states = {"eager": ts.init_train_state(cfg, 21, x[:B], device)}
        for name in eager_runs[1:] + ("graph",):
            states[name] = _state_copy(cfg, states["eager"], device)
        step = ts.make_train_step(cfg, states["graph"])
        losses = {name: [] for name in states}
        for i in range(steps):
            batch, key = x[i * B:(i + 1) * B], 1000 + i
            for name in eager_runs:
                losses[name].append(float(ts.train_step(
                    cfg, states[name], key, batch)[1]["loss"]))
            losses["graph"].append(float(step(states["graph"], key,
                                              batch)[1]["loss"]))
        torch.cuda.synchronize()
        step.close()

    def diffs(a, b):
        return _state_diffs(states[a], states[b], losses[a], losses[b])
    pairs = {f"{a} vs {b}": diffs(a, b) for a, b in (
        ("eager", "control 1"), ("eager", "control 2"),
        ("control 1", "control 2"))}
    ctrl = {part: max(d[part] for d in pairs.values())
            for part in pairs["eager vs control 1"]}
    got = diffs("eager", "graph")
    bitwise = all(v == 0 for v in ctrl.values())
    print(f"[graph] {tag}: {steps} eager steps against the graphed step "
          f"(1 warm-up, then {steps - 1} replays), batch {B}: losses "
          f"{losses['eager']} (eager) {losses['graph']} (graph); largest "
          f"difference by part, {pairs}; the limit (the largest of the "
          f"three) {ctrl}; eager vs graph {got}; the controls are "
          f"{'' if bitwise else 'NOT '}bitwise")
    for part, limit in ctrl.items():
        check(got[part] <= NONDET_MARGIN * limit,
              f"{tag}: the graphed step's {part} differs from the eager "
              f"step's by {got[part]} > {NONDET_MARGIN} x the controls' "
              f"{limit}")
    return {"control": ctrl, "pairs": pairs, "graph": got,
            "bitwise": bitwise, "losses": losses["graph"]}


def graph_check(ops, device, hp: str) -> dict:
    """Phase 15(a) on one cell (and 16(c)'s on MNIST): ``graph_vs_eager``,
    then, for an f32 cell or where the controls are not bitwise, the same
    steps on cuDNN's deterministic algorithms, which must be bitwise."""
    from iaf_torch.core.config import Config
    r = graph_vs_eager(ops, device, hp)
    cfg = Config().parse(hp)
    if cfg.compute_dtype == "float32" or not r["bitwise"]:
        r["deterministic"] = graph_vs_eager(ops, device, hp,
                                            deterministic=True)
        check(r["deterministic"]["bitwise"], f"{_label(cfg)}: eager runs "
              "differ on cuDNN's deterministic algorithms")
    return r


def _step_batches(cfg, n: int) -> list:
    """``n`` batches of ``cfg.batch_size`` training images."""
    B = cfg.batch_size
    x = _train_images(cfg, B * n)
    return [x[i * B:(i + 1) * B] for i in range(n)]


def _graphed_steps(cfg, state, batches, make_chunk=None):
    """The graphed step (``make_train_chunk``, or ``make_chunk``; one step
    a chunk, as ``train`` at steps_per_dispatch=1 runs it) over
    ``batches``, each step ending in a wait for its loss. Returns (the
    chunk, each step's seconds; the first is the warm-up and the
    capture)."""
    from iaf_torch.parallel import train_step as ts
    chunk = (make_chunk or ts.make_train_chunk)(cfg, state)
    graph = []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        float(chunk(state, 7, i, b[None])[1]["loss"][0])
        graph.append(time.perf_counter() - t0)
    return chunk, graph


def step_side_by_side(ops, device, hp: str, n: int = SIDE_BY_SIDE_STEPS
                      ) -> dict:
    """Phase 15(b): the median eager step (``train_step``) and the median
    graphed step (``make_train_chunk``, one step a chunk, as ``train`` at
    steps_per_dispatch=1 runs it) over the same ``n`` steps after two
    more, each step ending in a wait for its loss; then the device time of
    one graphed step by torch.profiler, and by CUDA events over 5."""
    from iaf_torch.core.config import Config
    from iaf_torch.core.rng import fold
    from iaf_torch.parallel import train_step as ts
    cfg = Config().parse(hp + ",dataset=synthetic")
    tag = _label(cfg)
    B = cfg.batch_size
    batches = _step_batches(cfg, n + 2)
    state = ts.init_train_state(cfg, 23, batches[0], device)
    eager = []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        float(ts.train_step(cfg, state, fold(7, i), b)[1]["loss"])
        eager.append(time.perf_counter() - t0)
    chunk, graph = _graphed_steps(cfg, state, batches)

    def one():
        return chunk(state, 7, 0, batches[0][None])
    prof = profile_phase(f"{tag}: one graphed training step (batch {B})",
                         one)
    ev = cuda_ms(one, iters=5, warmup=1)   # enqueued back to back
    chunk.close()
    med_e, med_g = statistics.median(eager[2:]), statistics.median(graph[2:])
    busy = prof["busy_ms"]
    if busy == 0:
        print(f"[graph] {tag}: the profiler recorded no kernel inside the "
              "graph; busy time from CUDA events")
        busy = ev
    print(f"[graph] {tag}: median step over {n} steps (after 2), batch {B}: "
          f"eager {med_e:.4f} s, graphed {med_g:.4f} s ({med_e / med_g:.2f}x);"
          f" graphed step's device busy {busy:.3f} ms (profiler "
          f"{prof['busy_ms']:.3f}, events {ev:.3f} ms), "
          f"{100 * busy / 1e3 / med_g:.1f} % of the graphed step; eager "
          f"steps {[round(t, 4) for t in eager]}, graphed "
          f"{[round(t, 4) for t in graph]} (the first: warm-up and capture)")
    check(med_g < med_e, f"{tag}: the graphed step ({med_g:.4f} s) is not "
          f"faster than the eager one ({med_e:.4f} s)")
    return {"eager_median_s": med_e, "graph_median_s": med_g,
            "graph_busy_ms": busy, "graph_events_ms": ev,
            "graph_profiler_busy_ms": prof["busy_ms"],
            "warm_up_and_capture_s": graph[0]}


def chunked_train_phase(ops, device, ref_logdir: str, S: int = 4,
                        steps: int = TRAIN_STEPS) -> dict:
    """Phase 15(d): from phase 9's step-``TRAIN_STEPS`` checkpoint,
    ``train_lib.train`` for ``steps`` more steps at steps_per_dispatch=1
    and at S (S + S + a tail), each in a logdir of its own: one loss row
    per step, the launch counts of ``steps`` steps each, and the two
    final states bitwise equal (params, m, u, EMA, step); then the run
    from init (``from_init_run``)."""
    import torch
    from iaf_torch import train_lib
    from iaf_torch.core.config import Config
    src = os.path.join(ref_logdir, f"ckpt-{TRAIN_STEPS:09d}.npz")
    total = TRAIN_STEPS + steps
    states, out = {}, {"steps_per_dispatch": S, "steps": steps}
    for spd in (1, S):
        logdir = os.path.join(HERE, "build", f"chip_smoke_train_s{spd}")
        shutil.rmtree(logdir, ignore_errors=True)
        os.makedirs(logdir)
        shutil.copy(src, logdir)
        cfg = Config().parse(PAPER + f",dataset=synthetic,log_every=1,"
                             f"ckpt_every={total},eval_every=0,"
                             f"steps_per_dispatch={spd}").replace(
                                 logdir=logdir)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            states[spd] = train_lib.train(cfg, max_steps=total,
                                          device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(f"at step {TRAIN_STEPS}" in log.getvalue(),
              f"S = {spd}: the run did not restore")
        check(counts == _expect(counts, PER_STEP, steps),
              f"S = {spd}: launch counts {counts}")
        _reserved(f"steps_per_dispatch={spd} run")
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        loss_steps = [r["step"] for r in rows if "loss" in r]
        check(loss_steps == list(range(TRAIN_STEPS + 1, total + 1)),
              f"S = {spd}: loss rows at steps {loss_steps}")
        rate = [r["steps_per_sec"] for r in rows if "steps_per_sec" in r]
        print(f"[chunked] steps_per_dispatch={spd}: steps {TRAIN_STEPS + 1}"
              f"-{total} from phase 9's checkpoint in {secs:.3f} s with "
              f"set-up, launches {counts}; {len(loss_steps)} loss rows; "
              f"steps/s at the {len(rate)} flushes "
              f"{[round(v, 3) for v in rate]}")
        out[f"s{spd}"] = {"seconds_with_setup": secs,
                          "loss_rows": len(loss_steps),
                          "steps_per_s_at_flushes": rate}
    a, b = states[1], states[S]
    worst = _states_worst(a, b)
    print(f"[chunked] steps_per_dispatch={S} against 1 from the same "
          f"checkpoint: largest difference {worst}, steps "
          f"{int(a.opt.step)} and {int(b.opt.step)}")
    check(int(a.opt.step) == int(b.opt.step) == total,
          "chunked run: optimizer step")
    check(all(v == 0 for v in worst.values()),
          f"steps_per_dispatch={S} differs from 1: {worst}")
    out["max_diff"] = worst
    out["from_init"] = from_init_run(ops, device, src, S)
    return out


def _states_worst(a, b) -> dict:
    """The largest absolute difference between two training states' params,
    m, u and EMA, by part."""
    worst = {"params": max(float((x - y).abs().max()) for x, y in zip(
        a.params.state_dict().values(), b.params.state_dict().values()))}
    for part in ("m", "u", "ema"):
        worst[part] = max(float((v - getattr(b.opt, part)[k]).abs().max())
                          for k, v in getattr(a.opt, part).items())
    return worst


def from_init_run(ops, device, ref_ckpt: str, S: int = 4) -> dict:
    """Phase 15(d) from init: ``train`` for ``TRAIN_STEPS`` steps at
    steps_per_dispatch=S from an empty logdir; its final state (params, m,
    u, EMA, step) bitwise equal to phase 9's S = 1 run at that step
    (``ref_ckpt``), since the data-dependent init runs on cuDNN's
    deterministic algorithms and the bf16 step repeats bit for bit."""
    import torch
    from iaf_torch import train_lib
    from iaf_torch.core import checkpoint as ckpt
    from iaf_torch.core.config import Config
    logdir = os.path.join(HERE, "build", f"chip_smoke_train_init_s{S}")
    shutil.rmtree(logdir, ignore_errors=True)
    cfg = Config().parse(PAPER + f",dataset=synthetic,log_every=1,"
                         f"ckpt_every={TRAIN_STEPS},eval_every=0,"
                         f"steps_per_dispatch={S}").replace(logdir=logdir)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_lib.train(cfg, max_steps=TRAIN_STEPS, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(counts == _expect(counts, PER_STEP, TRAIN_STEPS),
          f"from init, S = {S}: launch counts {counts}")
    _, ref, _ = train_lib.tree_to_state(ckpt.restore(ref_ckpt), cfg, device)
    worst = _states_worst(ref, state)
    print(f"[chunked] steps_per_dispatch={S} from init, steps 1-"
          f"{TRAIN_STEPS} in {secs:.3f} s with init and set-up, against "
          f"phase 9's S = 1 run at step {TRAIN_STEPS}: largest difference "
          f"{worst}, steps {int(state.opt.step)} and {int(ref.opt.step)}")
    check(int(state.opt.step) == int(ref.opt.step) == TRAIN_STEPS,
          "from init: optimizer step")
    check(all(v == 0 for v in worst.values()),
          f"from init, steps_per_dispatch={S} differs from phase 9: {worst}")
    return {"seconds_with_setup": secs, "max_diff": worst}


def f32_determinism_cost(ops, device, n: int = SIDE_BY_SIDE_STEPS) -> dict:
    """Phase 15(e): in the two f32 training cells, the median graphed step
    over the same ``n`` steps (after two more) from the same init, with
    cuDNN's default algorithms and with its deterministic ones, in turns
    (default, deterministic, deterministic, default). Returns each cell's
    medians and the cost: the deterministic medians' mean over the
    default ones', less 1."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.parallel import train_step as ts
    out = {}
    flags = torch.backends.cudnn
    saved = flags.deterministic
    try:
        for key, hp in (("paper f32", PAPER + ",compute_dtype=float32"),
                        ("5x5 f32", PAPER5 + ",compute_dtype=float32")):
            cfg = Config().parse(hp + ",dataset=synthetic")
            batches = _step_batches(cfg, n + 2)
            med = {"default": [], "deterministic": []}
            for det in (False, True, True, False):
                flags.deterministic = det
                state = ts.init_train_state(cfg, 23, batches[0], device)
                chunk, times = _graphed_steps(cfg, state, batches)
                chunk.close()
                med["deterministic" if det else "default"].append(
                    statistics.median(times[2:]))
                del state, chunk
                torch.cuda.empty_cache()
            cost = (statistics.mean(med["deterministic"])
                    / statistics.mean(med["default"]) - 1.0)
            print(f"[graph] {key}: median graphed step over {n} steps "
                  f"(after 2), batch {cfg.batch_size}: cuDNN's default "
                  f"algorithms {[round(v, 5) for v in med['default']]} s, "
                  f"deterministic {[round(v, 5) for v in med['deterministic']]}"
                  f" s (in turns: default, deterministic, deterministic, "
                  f"default): cost {100 * cost:+.2f} %")
            out[key] = {"default_s": med["default"],
                        "deterministic_s": med["deterministic"],
                        "cost": cost}
    finally:
        flags.deterministic = saved
    return out


def graph_phase(ops, device, ref_logdir: str) -> dict:
    """Phase 15: the captured training step against the eager one
    (bitwise, paper bf16 and f32, and the 5x5 config in bf16, whose K2
    forwards run on 64-pixel tiles at batch 32), eager and graphed
    medians side by side
    in the four training cells, and ``train`` at steps_per_dispatch=4.
    Returns {cell: side-by-side figures, "graph_vs_eager": ...,
    "chunked": ...}."""
    import torch
    t0 = time.perf_counter()
    out = {"graph_vs_eager": {}}
    for key, hp in (("paper", PAPER),
                    ("paper f32", PAPER + ",compute_dtype=float32"),
                    ("5x5", PAPER5)):
        out["graph_vs_eager"][key] = graph_check(ops, device, hp)
        torch.cuda.empty_cache()
    for key, hp in (("train", PAPER),
                    ("train_f32", PAPER + ",compute_dtype=float32"),
                    ("train_5x5", PAPER5),
                    ("train_5x5_f32", PAPER5 + ",compute_dtype=float32")):
        out[key] = step_side_by_side(ops, device, hp)
        torch.cuda.empty_cache()
        _reserved(f"{key} side by side")
    out["chunked"] = chunked_train_phase(ops, device, ref_logdir)
    out["f32_determinism"] = f32_determinism_cost(ops, device)
    out["phase_seconds"] = time.perf_counter() - t0
    print(f"[graph] phase 15: {out['phase_seconds']:.1f} s")
    return out


def init_twice(family, cfg, batch, device, label: str):
    """Phases 2 and 16(a): the data-dependent init on the card twice from
    one seed and one batch, every parameter bitwise equal (it runs on
    cuDNN's deterministic algorithms, ``core.device.cudnn_deterministic``);
    then once on cuDNN's default algorithms, as before that repair, for
    its seconds and whether it differs (printed). Returns (the first
    model, a summary)."""
    import torch
    from unittest import mock

    def timed():
        t0 = time.perf_counter()
        m = family.init_params(cfg, batch, rng=cfg.seed, device=device)
        torch.cuda.synchronize()
        return m, time.perf_counter() - t0

    def apart(a, b):
        sb = b.state_dict()
        return [k for k, v in a.state_dict().items()
                if not torch.equal(v, sb[k])]

    (a, t_a), (b, t_b) = timed(), timed()
    differ = apart(a, b)
    del b
    with mock.patch.object(family, "cudnn_deterministic",
                           contextlib.nullcontext):
        c, t_c = timed()
    default_apart = apart(a, c)
    del c
    torch.cuda.empty_cache()
    n = sum(p.numel() for p in a.parameters())
    leaves = len(list(a.parameters()))
    print(f"[init] {label}: {n} params in {leaves} leaves, compute_dtype="
          f"{cfg.compute_dtype}; two inits from seed {cfg.seed} on one "
          f"batch of {len(batch)}: "
          f"{'bitwise equal' if not differ else f'differ in {differ}'}, "
          f"{t_a:.3f} s and {t_b:.3f} s; on cuDNN's default algorithms (as "
          f"before the repair) {t_c:.3f} s, "
          + ("bitwise equal to them" if not default_apart else
             f"apart from them in {default_apart}"))
    check(not differ, f"{label}: two inits from one seed differ in {differ}")
    return a, {"params": n, "leaves": leaves, "seconds": [t_a, t_b],
               "default_algorithms_seconds": t_c,
               "default_algorithms_apart": default_apart}


def mnist_reference(device) -> None:
    """Phase 16(b): one f32 forward (8 images, k = 4) and one f32 gradient
    (train mode, 8 images) of the MNIST config on the card against the
    same on the CPU: same params and noise, TF32 off. log_w at 1e-5
    relative, every gradient leaf at 1e-4 of its max (None as zeros)."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.core.device import no_tf32
    from iaf_torch.models import mnist_vae as mv
    cfg = Config().parse(MNIST + ",compute_dtype=float32")
    x = _train_images(cfg, 8)
    gpu = mv.init_params(cfg, x, rng=17, device=device)
    cpu = mv.MnistVAE(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    g = torch.Generator().manual_seed(3)
    k = 4
    ev = torch.randn((8 * k, cfg.z_size), generator=g)
    tr = torch.randn((8, cfg.z_size), generator=g)
    with no_tf32():
        with torch.inference_mode():
            a = mv.apply_fn(cfg, gpu, 0, x, mode="eval", k=k,
                            noise={"z": ev.to(device)})
            b = mv.apply_fn(cfg, cpu, 0, x, mode="eval", k=k,
                            noise={"z": ev})
        mv.apply_fn(cfg, gpu, 0, x, noise={"z": tr.to(device)}).loss.backward()
        loss = mv.apply_fn(cfg, cpu, 0, x, noise={"z": tr}).loss
        loss.backward()
    lw_a, lw_b = a.log_w.cpu(), b.log_w
    rel = float(((lw_a - lw_b).abs() / lw_b.abs()).max())
    worst = 0.0
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        cp = cpu_params[name]
        want = torch.zeros_like(cp) if cp.grad is None else cp.grad
        got = torch.zeros_like(cp) if p.grad is None else p.grad.cpu()
        if float(want.abs().max()) > 0:
            worst = max(worst, _rel_err(got, want)[1])
    print(f"[reference] mnist f32, card vs CPU twins: eval forward (8 "
          f"images, k={k}) log_w max rel err {rel:.3e}; train loss "
          f"{float(loss.detach()):.4f}, worst gradient leaf error over its "
          f"max {worst:.3e}")
    check(bool(torch.isfinite(lw_a).all()), "mnist: non-finite log_w")
    check(rel <= 1e-5, f"mnist card vs CPU log_w rel err {rel} > 1e-5")
    check(worst <= 1e-4, f"mnist grad leaf err {worst} > 1e-4")


def mnist_serve(ops, device, cfg) -> dict:
    """Phase 16(f): on the training cell's logdir, under PyTorch's default
    TF32 flags (as the CLI runs them), ``sample(num=16, temperature=[1.0,
    0.5])`` and ``reconstruct(num=16)`` with no kernel launch: uint8
    [16, 28, 28, 1], the samples equal to ``mnist_vae.sample``'s on the
    same key and finite there, the two temperatures' tiles different;
    ``invert_check`` raises, the CIFAR family's only."""
    import numpy as np
    import torch
    from iaf_torch import train_lib
    from iaf_torch.models import mnist_vae as mv
    path = os.path.join(cfg.logdir, "samples.npy")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with _default_tf32(), contextlib.redirect_stdout(io.StringIO()):
        imgs = train_lib.sample(cfg, num=16, temperature=[1.0, 0.5],
                                out_path=path, device=device)
        t_sample = time.perf_counter() - t0
        t0 = time.perf_counter()
        recon = train_lib.reconstruct(cfg, num=16, device=device)
        t_recon = time.perf_counter() - t0
    counts = ops.launch_counts()
    tiles = [np.load(path.replace(".npy", f"_T{t}.npy")) for t in (1.0, 0.5)]
    with torch.inference_mode():
        raw = mv.sample(cfg, train_lib._serving_model(cfg, True, device),
                        cfg.seed + 4242, 16, 0.5)
    print(f"[mnist] sample: {imgs.dtype} {imgs.shape}, {t_sample:.3f} s for "
          f"2 temperatures; reconstruct: {recon.dtype} {recon.shape}, "
          f"{t_recon:.3f} s; launches {counts}")
    for a in (imgs, recon):
        check(a.dtype == np.uint8 and a.shape == (16, 28, 28, 1),
              f"mnist serving output {a.dtype} {a.shape}")
    check(bool(torch.isfinite(raw).all()), "mnist: non-finite samples")
    check(np.array_equal(imgs, raw.cpu().numpy().astype(np.uint8)),
          "mnist: sample() differs from mnist_vae.sample")
    check(not np.array_equal(*tiles), "the two temperatures' tiles equal")
    check(not any(counts.values()), f"mnist serving launched {counts}")
    try:
        train_lib.invert_check(cfg, device=device)
    except NotImplementedError as e:
        print(f"[mnist] invert_check raises: {e}")
        check("CIFAR family" in str(e), f"invert_check raised {e}")
    else:
        raise SmokeFailure("invert_check ran on the MNIST family")
    return {"sample_seconds": t_sample, "reconstruct_seconds": t_recon}


def mnist_phase(ops, device):
    """Phase 16: the MNIST family (``mnist_config`` at full width on
    binarized synthetic 28x28x1 images). Returns (the kernels rows, the
    path's launch counts as {"mnist": (eval, train)}, the summary)."""
    import types

    import torch
    from unittest import mock
    from iaf_torch.core.config import Config
    from iaf_torch.data import feed
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import mnist_vae
    from iaf_torch.parallel import train_step as ts
    t_phase = time.perf_counter()
    cfg = Config().parse(MNIST + f",eval_batch_size={EVAL_BATCH},"
                         f"eval_k_chunk={EVAL_CHUNK}")
    check(cfg == mnist_vae.mnist_config(
        dataset="synthetic", eval_batch_size=EVAL_BATCH,
        eval_k_chunk=EVAL_CHUNK), "MNIST is not mnist_config's hpconfig")
    summary = {}
    # (a) the init, twice
    x = _train_images(cfg, cfg.batch_size)
    model, summary["init"] = init_twice(mnist_vae, cfg, x, device, "mnist")
    check((summary["init"]["params"], summary["init"]["leaves"])
          == (MNIST_PARAMS, MNIST_LEAVES), f"mnist: {summary['init']}")
    # (b) the port against its CPU twins
    mnist_reference(device)
    # (c) training, counted; the resume binarizes from its own step on
    starts = []
    binarized = feed.binarized_iterator

    def spy(it, seed, start_step=0):
        starts.append(start_step)
        return binarized(it, seed, start_step=start_step)

    with mock.patch.object(feed, "binarized_iterator", spy):
        tcfg, _, train_counts, summary["train"] = train_phase(
            ops, device, MNIST, {"adamax_polyak": 1})
    check(starts == [0, TRAIN_STEPS], f"batches binarized from {starts}")
    with open(os.path.join(tcfg.logdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    nll = [(r["step"], r["nll_nats"]) for r in rows if "nll_nats" in r]
    check([s for s, _ in nll] == list(range(1, TRAIN_STEPS + RESUME_STEPS
                                            + 1))
          and all(math.isfinite(v) for _, v in nll), f"nll_nats rows {nll}")
    print(f"[mnist] nll_nats by step {[round(v, 2) for _, v in nll]}; "
          f"binarized from steps {starts}")
    r = summary["graph_vs_eager"] = graph_check(ops, device, MNIST)
    print(f"[mnist] graphed step against eager at batch {cfg.batch_size}: "
          + ("bitwise (the controls are bitwise)" if r["bitwise"] else
             f"within {NONDET_MARGIN}x controls that are not bitwise, and "
             "bitwise on cuDNN's deterministic algorithms"))
    torch.cuda.empty_cache()
    # (d) K5 on one real MNIST step's inputs
    kstate = ts.init_train_state(cfg, 11, x, device)
    ts.train_step(cfg, kstate, 3, x)
    row = adamax_phase(ops, cfg, kstate)
    check(row["leaves"] == MNIST_LEAVES, f"K5 over {row['leaves']} leaves")
    row.update(name="adamax_polyak_mnist", counter="adamax_polyak",
               path="mnist")
    del kstate
    torch.cuda.empty_cache()
    # (e) the IW eval, counted (no kernel), and one chunk profiled
    test = feed.dynamic_binarize(
        synthetic_dataset(cfg.image_size, cfg.channels).test_x,
        feed.binarize_rng(cfg.seed, -2))
    eval_counts, summary["main"] = eval_phase(
        ops, device, cfg, model, types.SimpleNamespace(test_x=test), {})

    def one_chunk():
        with torch.inference_mode():
            mnist_vae.apply_fn(cfg, model, 1, test[:EVAL_BATCH], mode="eval",
                               k=EVAL_CHUNK)
    summary["main"]["profile"] = profile_phase(
        f"mnist: one eval chunk ({EVAL_BATCH} images x {EVAL_CHUNK} "
        "samples)", one_chunk)
    del model
    # (f) serving on the training cell's logdir
    summary["serve"] = mnist_serve(ops, device, tcfg)
    summary["logdir"] = tcfg.logdir      # phase 18(e) exports from it
    # (g) eager and graphed steps side by side
    summary["train"]["side_by_side"] = step_side_by_side(ops, device, MNIST)
    torch.cuda.empty_cache()
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"[mnist] phase 16: {summary['phase_seconds']:.1f} s")
    return [row], {"mnist": (eval_counts, train_counts)}, summary


MULTI_CHILD_TIMEOUT = 600   # seconds for phase 17(e)'s two ranks
ACCUM_STEPS = 4             # phase 19(e): grad_accum=2 steps over 2 ranks


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def _group_of_one():
    """torchrun's environment for one rank in this process, so that the
    entry points make an NCCL group of world size 1; the group is
    destroyed and the environment restored after."""
    import torch.distributed as dist
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _split_chunk(cfg, state):
    """Phase 17(b)'s other design: ``make_train_chunk``'s chunk whose step
    is two CUDA graphs, the forward and backward (the free-bits
    all-reduce is inside the forward, so it stays captured) and then K5,
    with the gradient and metrics all-reduce between them, eager."""
    import torch
    from iaf_torch import ops as iops
    from iaf_torch.parallel import train_step as ts

    class SplitStep(ts.TrainStep):
        def _warm_up_and_capture(self):
            cur = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                metrics = self._body()                  # the eager step
            cur.wait_stream(self._stream)
            for t in metrics.values():
                t.record_stream(cur)
            fwd_bwd, update = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            with iops.launches_apart() as seen:
                with torch.cuda.graph(fwd_bwd, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    self._local = self._forward_backward()
                with torch.cuda.graph(update, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    self._update()
            self._graphs, self._per_replay = (fwd_bwd, update), seen
            return metrics

        def __call__(self, state, key, batch, noise=None):
            if not hasattr(self, "_graphs"):
                return super().__call__(state, key, batch, noise)
            self._load(key, batch, noise)
            fwd_bwd, update = self._graphs
            fwd_bwd.replay()
            metrics = self._reduce(self._local)
            update.replay()
            iops.add_launch_counts(self._per_replay)
            return state, metrics

    chunk = ts.make_train_chunk(cfg, state)
    chunk.step.close()
    chunk.step = SplitStep(cfg, state)
    return chunk


def _step_kernels(chunk, state, batches) -> dict:
    """One graphed step's device time by name (torch.profiler): {name:
    (ms, launches)}."""
    return {name: (ms, n) for name, ms, n in device_kernels(
        lambda: chunk(state, 7, 0, batches[0][None]), iters=3, warmup=0)}


def _nccl_ms(rows: dict) -> float:
    """The NCCL kernels' device time in ``_step_kernels``' rows (a name
    with "nccl" in it)."""
    return sum(ms for name, (ms, _) in rows.items() if "nccl" in name.lower())


def _busy_apart(base: dict, other: dict) -> dict:
    """Device ms by name where ``other``'s step differs from ``base``'s by
    more than 1 us (a name missing from one counts as 0 there)."""
    out = {}
    for name in set(base) | set(other):
        d = other.get(name, (0.0, 0))[0] - base.get(name, (0.0, 0))[0]
        if abs(d) > 1e-3:
            out[name[:60]] = round(d, 4)
    return out


_MULTI_CHILD = r"""
import json, os, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from iaf_torch.core.config import Config
from iaf_torch.core.device import full_f32
from iaf_torch.core.rng import fold
from iaf_torch.parallel import mesh
from iaf_torch.parallel import train_step as ts
from iaf_torch.core.device import resolve_device
dev = resolve_device("cuda")
mesh.init_distributed(dev)
r, n = mesh.rank(), mesh.world()
cfg = Config().parse(cs.PAPER + ",dataset=synthetic,compute_dtype=float32")
full_f32(cfg.compute_dtype, dev)
batches = cs._step_batches(cfg, cs.SIDE_BY_SIDE_STEPS + 2)
per = cfg.batch_size // n
state = ts.init_train_state(cfg, 23, batches[0][r * per:(r + 1) * per], dev)
step = ts.make_train_step(cfg, state)
times = []
for i, b in enumerate(batches):
    t0 = time.perf_counter()
    _, m = step(state, fold(7, i), b[r * per:(r + 1) * per])
    float(m["loss"])
    times.append(time.perf_counter() - t0)
    if i == 0 and r == 0:
        torch.save({k: p.grad.cpu() for k, p in
                    state.params.named_parameters()},
                   os.path.join(sys.argv[2], "grads_world2.pt"))
torch.cuda.synchronize()
torch.save({k: v.cpu() for k, v in state.params.state_dict().items()},
           os.path.join(sys.argv[2], f"params_rank{r}.pt"))
# one graphed step's device time, and the NCCL kernels' share: the same
# 3 calls on every rank (each has collectives the others must meet)
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    time.sleep(0.05)
    for i in range(3):
        step(state, fold(7, 100 + i), batches[i][r * per:(r + 1) * per])
    torch.cuda.synchronize()
dev = cs._device_events(prof)
busy = sum(us for _, us, _ in dev) / 3e3
nccl = sum(us for name, us, _ in dev if "nccl" in name.lower()) / 3e3
step.close()
# grad_accum=2 over the ranks: each micro-batch's rows gathered and
# regrouped as JAX reshards them
acfg = cfg.replace(grad_accum=2)
state = ts.init_train_state(acfg, 23, batches[0][r * per:(r + 1) * per], dev)
step = ts.make_train_step(acfg, state)
for i, b in enumerate(batches[:cs.ACCUM_STEPS]):
    float(step(state, fold(7, i), b[r * per:(r + 1) * per])[1]["loss"])
    if i == 0 and r == 0:
        torch.save({k: p.grad.cpu() for k, p in
                    state.params.named_parameters()},
                   os.path.join(sys.argv[2], "grads_world2_a2.pt"))
torch.cuda.synchronize()
torch.save({k: v.cpu() for k, v in state.params.state_dict().items()},
           os.path.join(sys.argv[2], f"params_rank{r}_a2.pt"))
step.close()
mesh.barrier("done")
print("MULTI_CHILD " + json.dumps({"rank": r, "world": n,
                                   "median_s": statistics.median(times[2:]),
                                   "busy_ms": busy, "nccl_ms": nccl,
                                   "times": times}), flush=True)
torch.distributed.destroy_process_group()
"""


def two_rank_phase(device) -> dict:
    """Phase 17(e), where two cards are visible: two processes with
    torchrun's environment (NCCL, ranks 0 and 1 on cards 0 and 1) train
    the paper f32 recipe at global batch 32 (16 a rank) for 10 graphed
    steps; the first step's mean gradient against one process's on the
    whole batch (this one, no group) at 1e-4 of each leaf's max, both
    ranks' parameters after the 10 steps bitwise equal, and the median
    step (steps 3-10) at world size 2 beside world size 1. Then phase
    19(e): the same two ranks at grad_accum=2 (the rows of each
    micro-batch gathered and regrouped), ``ACCUM_STEPS`` steps, the first
    step's gradient against one process at grad_accum=2 on the whole
    batch at 1e-4 and both ranks' parameters bitwise equal."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.core.device import full_f32
    from iaf_torch.core.rng import fold
    from iaf_torch.parallel import train_step as ts
    out_dir = os.path.join(HERE, "build", "chip_smoke_multi")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _MULTI_CHILD, HERE, out_dir], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=MULTI_CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0 and "MULTI_CHILD " in log,
              f"rank {r} of 2 failed (rc {p.returncode}):\n{log[-3000:]}")
    res = [json.loads(log.split("MULTI_CHILD ", 1)[1].splitlines()[0])
           for log in logs]

    # world size 1 on the whole batch, one process, no group, in f32 with
    # TF32 off as the ranks run it
    cfg = Config().parse(PAPER + ",dataset=synthetic,compute_dtype=float32")
    full_f32(cfg.compute_dtype, device)
    batches = _step_batches(cfg, SIDE_BY_SIDE_STEPS + 2)
    state = ts.init_train_state(cfg, 23, batches[0], device)
    step = ts.make_train_step(cfg, state)
    times = []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        float(step(state, fold(7, i), b)[1]["loss"])
        times.append(time.perf_counter() - t0)
        if i == 0:
            grads1 = {k: p.grad.detach().cpu().clone() for k, p in
                      state.params.named_parameters()}
    step.close()

    def rel_worst(got, want):
        return max(float((got[k] - g).abs().max())
                   / max(float(g.abs().max()), 1e-30)
                   for k, g in want.items())

    def ranks_equal(suffix):
        p0, p1 = (torch.load(os.path.join(out_dir,
                                          f"params_rank{r}{suffix}.pt"))
                  for r in range(2))
        return all(torch.equal(p0[k], p1[k]) for k in p0)
    worst = rel_worst(torch.load(os.path.join(out_dir, "grads_world2.pt")),
                      grads1)
    same = ranks_equal("")
    # phase 19(e): grad_accum=2, one process on the whole batch
    acfg = cfg.replace(grad_accum=2)
    state = ts.init_train_state(acfg, 23, batches[0], device)
    step = ts.make_train_step(acfg, state)
    float(step(state, fold(7, 0), batches[0])[1]["loss"])
    grads1_a2 = {k: p.grad.detach().cpu().clone() for k, p in
                 state.params.named_parameters()}
    step.close()
    del state
    worst_a2 = rel_worst(torch.load(os.path.join(out_dir,
                                                 "grads_world2_a2.pt")),
                         grads1_a2)
    same_a2 = ranks_equal("_a2")
    print(f"[multi] 19(e) grad_accum=2 over 2 ranks (NCCL), paper f32, "
          f"global batch {cfg.batch_size}: first step's mean gradient "
          f"against one process at grad_accum=2 on the whole batch, largest "
          f"difference {worst_a2:.3e} of its leaf's max (limit 1e-4); both "
          f"ranks' params after {ACCUM_STEPS} steps bitwise equal: "
          f"{same_a2}")
    check(worst_a2 <= 1e-4, f"2 ranks at grad_accum=2: the gradient differs "
          f"by {worst_a2} of max")
    check(same_a2, "the two ranks' parameters differ at grad_accum=2")
    med1 = statistics.median(times[2:])
    med2 = res[0]["median_s"]
    B = cfg.batch_size
    print(f"[multi] 2 ranks (NCCL), paper f32, global batch {B}: first "
          f"step's mean gradient against one process on the whole batch, "
          f"largest difference {worst:.3e} of its leaf's max (limit "
          f"1e-4); both ranks' params after {len(batches)} steps bitwise "
          f"equal: {same}; median step {med2:.4f} s at world size 2 "
          f"({B / med2:.1f} examples/s; rank 1 {res[1]['median_s']:.4f} s) "
          f"against {med1:.4f} s at world size 1 ({B / med1:.1f} "
          f"examples/s); a world-size-2 graphed step's device busy "
          f"{res[0]['busy_ms']:.3f} and {res[1]['busy_ms']:.3f} ms, NCCL "
          f"kernels {res[0]['nccl_ms']:.3f} and {res[1]['nccl_ms']:.3f} ms "
          f"(ranks 0 and 1)")
    check(worst <= 1e-4, f"2 ranks' gradient differs by {worst} of max")
    check(same, "the two ranks' parameters differ")
    return {"ran": True, "grad_rel_err": worst, "ranks_bitwise": same,
            "grad_accum_2": {"grad_rel_err": worst_a2,
                             "ranks_bitwise": same_a2},
            "median_s_world2": med2, "median_s_world1": med1,
            "busy_ms_world2": [x["busy_ms"] for x in res],
            "nccl_ms_world2": [x["nccl_ms"] for x in res],
            "examples_per_s_world2": B / med2,
            "examples_per_s_world1": B / med1}


def multi_phase(ops, device, ref_logdir: str) -> dict:
    """Phase 17: data parallelism (``parallel/mesh.py``) on the card: (a)
    at world size 1 over NCCL (a group made in this process), ``train``
    for 10 paper bf16 steps from init, the state bitwise equal to phase
    9's at step 10 and the launches ``PER_STEP`` a step, the NCCL
    kernels' device time in a graphed step; (b) the median graphed step
    over the same 8 steps with no group, with the group (the all-reduce
    captured in the graph, the design the port keeps) and with the
    graph split around the gradient all-reduce, in turns (no group,
    captured, split, no group); (c) ``evaluate`` at k=256 (2 batches) on
    phase 9's checkpoint bitwise equal to the same call with no group,
    and the batch-sharded k = 1 ELBO too; (d) ``sample`` at T = 1.0 and
    0.5 through the gather path bitwise equal to the call with no group;
    (e) two ranks on two cards (``two_rank_phase``) where two are
    visible, else a line saying it did not run."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from iaf_torch import train_lib
    from iaf_torch.core import checkpoint as ckpt
    from iaf_torch.core.config import Config
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.parallel import mesh
    from iaf_torch.parallel import train_step as ts
    from iaf_torch.parallel.eval_step import make_batch_sharded_elbo
    t0 = time.perf_counter()
    out: dict = {}
    cfg = Config().parse(PAPER + ",dataset=synthetic")
    batches = _step_batches(cfg, SIDE_BY_SIDE_STEPS + 2)
    serve = Config().parse(PAPER + ",dataset=synthetic").replace(
        logdir=ref_logdir)
    x = synthetic_dataset(cfg.image_size, cfg.channels).test_x[:EVAL_BATCH]
    med = {"no group": [], "captured": [], "split": []}

    busy: dict = {}

    def median_of(label, make_chunk, profiled=True):
        """The median graphed step, and the first run's profile."""
        state = ts.init_train_state(cfg, 23, batches[0], device)
        chunk, times = _graphed_steps(cfg, state, batches, make_chunk)
        med[label].append(statistics.median(times[2:]))
        if profiled and label not in busy:
            busy[label] = _step_kernels(chunk, state, batches)
        chunk.close()

    def no_group_refs():
        model = train_lib._serving_model(serve, True, device)
        return (train_lib.evaluate(serve, k=EVAL_K, max_batches=EVAL_BATCHES,
                                   device=device),
                make_batch_sharded_elbo(serve, device, k=1)(model, 5, x),
                [train_lib.sample(serve, num=16, temperature=t,
                                  device=device) for t in (1.0, 0.5)])

    with contextlib.redirect_stdout(io.StringIO()):
        ref_eval, ref_k1, ref_imgs = no_group_refs()
    median_of("no group", ts.make_train_chunk)
    with _group_of_one():
        # (a) train from init over NCCL at world size 1
        logdir = os.path.join(HERE, "build", "chip_smoke_train_nccl")
        shutil.rmtree(logdir, ignore_errors=True)
        tcfg = Config().parse(PAPER + f",dataset=synthetic,log_every=1,"
                              f"ckpt_every={TRAIN_STEPS},eval_every=0"
                              ).replace(logdir=logdir)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            trained = train_lib.train(tcfg, max_steps=TRAIN_STEPS,
                                      device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = ops.launch_counts()
        check(mesh.active() and dist.get_backend() == "nccl"
              and mesh.world() == 1, "no NCCL group of one formed")
        check(counts == _expect(counts, PER_STEP, TRAIN_STEPS),
              f"world size 1: launch counts {counts}")
        _, ref, _ = train_lib.tree_to_state(ckpt.restore(os.path.join(
            ref_logdir, f"ckpt-{TRAIN_STEPS:09d}.npz")), tcfg, device)
        worst = _states_worst(ref, trained)
        print(f"[multi] (a) NCCL at world size 1: train from init, "
              f"{TRAIN_STEPS} steps in {secs:.3f} s with init and set-up, "
              f"launches {counts}; against phase 9's step {TRAIN_STEPS}: "
              f"largest difference {worst}")
        check(all(v == 0 for v in worst.values()),
              f"world size 1 over NCCL differs from phase 9: {worst}")
        del trained, ref
        out["a"] = {"seconds_with_setup": secs, "max_diff": worst}
        # (b) the graphed step with the group: captured, then split
        median_of("captured", ts.make_train_chunk)
        median_of("split", _split_chunk, profiled=False)
        torch.cuda.empty_cache()
        # (c), (d) the evals and sampling through the group
        with contextlib.redirect_stdout(io.StringIO()):
            got_eval, got_k1, got_imgs = no_group_refs()
    median_of("no group", ts.make_train_chunk)
    torch.cuda.empty_cache()
    a, c, sp = (statistics.mean(med[k]) for k in ("no group", "captured",
                                                  "split"))
    nccl = _nccl_ms(busy["captured"])
    total = {k: sum(ms for ms, _ in v.values()) for k, v in busy.items()}
    print(f"[multi] (b) design: the gradient all-reduce captured in the "
          f"step's CUDA graph (kept); NCCL kernels in one graphed step at "
          f"world size 1: {nccl:.4f} ms of device time; device busy a "
          f"graphed step {({k: round(v, 3) for k, v in total.items()})} ms;"
          f" device ms by name, captured minus no group "
          f"{_busy_apart(busy['no group'], busy['captured'])}")
    print(f"[multi] (b) median graphed step over the same "
          f"{SIDE_BY_SIDE_STEPS} steps (after 2), paper bf16, batch "
          f"{cfg.batch_size}: no group {[round(v, 5) for v in med['no group']]}"
          f" s, NCCL group of one captured {med['captured'][0]:.5f} s "
          f"({1e3 * (c - a):+.3f} ms), split around the all-reduce "
          f"{med['split'][0]:.5f} s ({1e3 * (sp - a):+.3f} ms)")
    print(f"[multi] (c) evaluate k={EVAL_K} over {EVAL_BATCHES} batches: "
          f"{got_eval!r} bits/dim through the group, {ref_eval!r} without;"
          f" k = 1 batch-sharded ELBO equal: "
          f"{bool(torch.equal(got_k1, ref_k1))}")
    check(got_eval == ref_eval, "the eval through the group differs")
    check(torch.equal(got_k1, ref_k1) and bool(torch.isfinite(got_k1).all()),
          "the batch-sharded ELBO through the group differs")
    same = all(np.array_equal(u, v) for u, v in zip(got_imgs, ref_imgs))
    print(f"[multi] (d) sample(num=16) at T = 1.0 and 0.5 through the "
          f"gather: bitwise equal to the call with no group: {same}")
    check(same, "the samples through the group differ")
    out["b"] = {"design": "captured", "median_s": med,
                "captured_minus_no_group_ms": 1e3 * (c - a),
                "split_minus_no_group_ms": 1e3 * (sp - a),
                "nccl_device_ms_per_step": nccl,
                "device_busy_ms_per_step": total}
    out["c"] = {"bits_per_dim": got_eval, "k1_equal": True}
    out["d"] = {"samples_equal": same}
    if torch.cuda.device_count() >= 2:
        out["e"] = two_rank_phase(device)
    else:
        print(f"[multi] 2-rank phase not run: "
              f"{torch.cuda.device_count()} CUDA device visible")
        out["e"] = {"ran": False}
    out["phase_seconds"] = time.perf_counter() - t0
    print(f"[multi] phase 17: {out['phase_seconds']:.1f} s")
    return out


# phase 18: the launches of one artifact call on the paper config
# the paper elbo artifact's launches a call, the fused passes
# (``with_glue``) included
EXPORT_PER_CALL = {"ar_stack": 20, "iaf_update": 20, "disc_logistic_logp": 1,
                   "elu_bf16": 2, "residual_elu": 40, "up_stats": 20,
                   "posterior": 20, "kl_join": 20}
EXPORT_SEED = 4242
# phase 5's steady seconds per paper eval batch and phase 3's events ms of
# K1, K3 and K4 at N = 1024 when the wrappers launched the kernels directly,
# before their forwards went through torch ops (an H100 80GB HBM3 at 700 W)
BEFORE_OPS = {"seconds_per_batch": 0.6038, "ar_stack": 0.3987,
              "iaf_update": 0.0712, "disc_logistic_logp": 0.0283}
DISPATCH_CALLS = 200

# phase 18(b): a fresh process that imports only torch, ``iaf_torch.ops``
# and ``iaf_torch.core.export`` loads the elbo artifact argv[2] and scores
# argv[3]'s images on device argv[6] with the noise of key argv[4] into
# argv[5]
_EXPORT_CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from iaf_torch import ops
from iaf_torch.core.export import draw_noise, load_exported
fn = load_exported(sys.argv[2])
dev = torch.device(sys.argv[6])
x = torch.from_numpy(np.load(sys.argv[3])).to(dev)
noise = draw_noise(fn.contract, int(sys.argv[4]), dev)
ops.reset_launch_counts()
out = fn(x, *noise).cpu()
np.save(sys.argv[5], out.numpy())
print(json.dumps({
    "launches": {k: v for k, v in ops.launch_counts().items() if v},
    "model_code": sorted(m for m in sys.modules if m.startswith(
        ("iaf_torch.models", "iaf_torch.nn.layers", "iaf_torch.train_lib",
         "jax", "iaf_tpu")))}))
"""


def _iaf_nodes(fn) -> dict:
    """The ``iaf::`` torch ops in a loaded artifact's graph, counted."""
    found: dict = {}
    for n in fn.program.graph.nodes:
        name = str(n.target)
        if n.op == "call_function" and name.startswith("iaf."):
            found[name.split(".")[1]] = found.get(name.split(".")[1], 0) + 1
    return found


def _counted_call(ops, fn, *args):
    """``fn(*args)`` with the launch counters zeroed just before and read
    just after: (the result, seconds, the nonzero counts)."""
    import torch
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, {k: v for k, v in ops.launch_counts().items() if v}


def _held_to_eager(label: str, got_fn, want_fn) -> str:
    """The artifact's ``got_fn()`` against the eager ``want_fn()``, both
    under PyTorch's default TF32 flags (the loader sets the contract's):
    bitwise where two eager calls are bitwise; where they are not
    (cuDNN's default algorithms may sum in another order from call to
    call), bitwise with both on cuDNN's deterministic algorithms, where
    two eager calls must then agree. Returns which case held."""
    import torch
    from iaf_torch.core.device import cudnn_deterministic
    with _default_tf32():
        with torch.inference_mode():
            want, again = want_fn(), want_fn()
        if torch.equal(want, again):
            got = got_fn()
            case = "bitwise"
        else:
            spread = float((want - again).abs().max())
            with cudnn_deterministic():
                with torch.inference_mode():
                    want, again = want_fn(), want_fn()
                check(torch.equal(want, again), f"{label}: two eager calls "
                      "differ on cuDNN's deterministic algorithms")
                got = got_fn()
            case = (f"bitwise on cuDNN's deterministic algorithms (two eager "
                    f"calls on its default ones differ by {spread:.3e})")
    check(torch.equal(got, want), f"{label}: the artifact differs from eager "
          f"by {float((got - want).abs().max())} ({case.split(' (')[0]})")
    return case


def _load_timed(path: str, times: dict, key: str):
    """``load_exported(path)``, its seconds into ``times[key]``."""
    from iaf_torch.core import export
    t0 = time.perf_counter()
    fn = export.load_exported(path)
    times[key] = time.perf_counter() - t0
    return fn


def _serve_artifacts(ops, device, label, elbo, sample, eager_elbo,
                     eager_sample, x, per_call: dict) -> dict:
    """The loaded elbo artifact on ``x`` with ``draw_noise``'s tensors
    must launch exactly ``per_call`` and equal ``eager_elbo(seed)``
    (``_held_to_eager``); the sample artifact (unless None) at T = 1.0
    and 0.5 launch nothing and equal ``eager_sample(seed, T)``. Returns
    the seconds of the calls and which equality held."""
    import torch
    from iaf_torch.core import export
    out: dict = {}
    xt = torch.from_numpy(x).to(device)
    noise = export.draw_noise(elbo.contract, EXPORT_SEED, device)
    with _default_tf32():
        got, out["first_call_s"], counts = _counted_call(ops, elbo, xt,
                                                         *noise)
        _, out["call_s"], again = _counted_call(ops, elbo, xt, *noise)
    check(counts == per_call == again, f"{label}: the elbo artifact "
          f"launched {counts}, then {again}; want {per_call}")
    out["elbo"] = _held_to_eager(f"{label} elbo", lambda: elbo(xt, *noise),
                                 lambda: eager_elbo(EXPORT_SEED))
    line = (f"[export] {label}: elbo {tuple(got.shape)} launches {per_call} "
            f"a call, {out['elbo']} equal to eager; first call "
            f"{out['first_call_s']:.4f} s, next {out['call_s']:.4f} s")
    if sample is not None:
        s_noise = export.draw_noise(sample.contract, EXPORT_SEED, device)
        for t in (1.0, 0.5):
            temp = torch.tensor(t, device=device)
            with _default_tf32():
                _, out[f"sample_call_s_T{t}"], counts = _counted_call(
                    ops, sample, temp, *s_noise)
            check(counts == {}, f"{label}: the sample artifact launched "
                  f"{counts}")
            out[f"sample_T{t}"] = _held_to_eager(
                f"{label} sample T={t}", lambda: sample(temp, *s_noise),
                lambda: eager_sample(EXPORT_SEED, t))
        line += (f"; sample launches nothing, {out['sample_T1.0']} (T = 1.0)"
                 f" and {out['sample_T0.5']} (T = 0.5) equal to eager, "
                 f"{out['sample_call_s_T1.0']:.4f} s a call")
    print(line)
    return out


def _host_us(fn, n: int = DISPATCH_CALLS) -> tuple[float, float]:
    """(host microseconds a call to enqueue, microseconds a call until the
    card is done) over ``n`` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e6, (t2 - t0) / n * 1e6


def dispatch_cost(ops, device, model) -> dict:
    """Phase 18(f)'s direct measurement: the host time of a no-grad call
    of each kernel's torch op against the launch it wraps, called
    directly (K1 f32 at N = 2, ``invert_check``'s shape, from ``model``'s
    top AR net; K3 at N = 2; K4 at 2 images), in turns (op, direct,
    direct, op); the difference is the dispatcher's cost a launch. K1's
    public wrapper (its input checks, then the op) is timed beside them,
    in the same turns."""
    import torch
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    fused = importlib.import_module("iaf_torch.ops.fused")
    ar1 = model.blocks[-1].ar1
    with torch.inference_mode():
        ws, bs = ar1.folded(torch.float32)
        g = torch.Generator(device=device).manual_seed(8)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=device)
        z, ctx = randn(2, 16, 16, ws[0].shape[2]), randn(2, 16, 16,
                                                          ws[0].shape[3])
        a = [randn(2, 16, 16, 32) for _ in range(4)]
        mean, smp = randn(2, 32, 32, 3), torch.floor(randn(2, 32, 32, 3))
        ls = torch.full((1,), -2.0, device=device)
        cases = {
            "ar_stack_f32_n2": {
                "op": lambda: ar_mod.ar_stack_op(z, ctx, ws, bs),
                "direct": lambda: ar_mod._fwd(z, ctx, ws, bs, False)[0],
                "wrapper": lambda: ops.ar_stack(z, ctx, ws, bs, ar1.masks)},
            "iaf_update_n2": {
                "op": lambda: fused.iaf_update_op(*a)[0],
                "direct": lambda: fused._iaf_fwd(*a)[0]},
            "disc_logistic_logp_n2": {
                "op": lambda: fused.disc_logistic_op(mean, ls, smp,
                                                     1.0 / 256.0),
                "direct": lambda: fused._dl_fwd(mean, ls, smp,
                                                1.0 / 256.0)}}
        out = {}
        for name, calls in cases.items():
            want = calls["direct"]()
            check(all(torch.equal(c(), want) for c in calls.values()),
                  f"{name}: the op and the direct launch differ")
            order = ("op", "direct", *(("wrapper",) * 2 if "wrapper" in
                                       calls else ()), "direct", "op")
            runs: dict = {k: [] for k in calls}
            for which in order:
                runs[which].append(_host_us(calls[which]))
            host = {k: statistics.mean(r[0] for r in v)
                    for k, v in runs.items()}
            wall = {k: statistics.mean(r[1] for r in v)
                    for k, v in runs.items()}
            out[name] = {"host_us": host, "until_done_us": wall,
                         "dispatch_us": host["op"] - host["direct"]}
            print(f"[export] dispatch {name}: host "
                  + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
                  + f" us a call (the op +{host['op'] - host['direct']:.1f}"
                  f" us); until done "
                  + ", ".join(f"{k} {v:.1f}" for k, v in wall.items())
                  + f" us ({DISPATCH_CALLS} calls a turn, "
                  + " ".join(order) + ")")
    return out


def export_phase(ops, device, paper_logdir: str, mnist_logdir: str,
                 main: dict, rows: list) -> dict:
    """Phase 18: ``--mode export`` on the card: (a) ``export_saved`` on
    phase 9's logdir (paper bf16, EMA weights, k = 1, 16 images, 16
    samples), the elbo graph holding exactly 20 ``iaf.ar_stack``, 20
    ``iaf.iaf_update`` and 1 ``iaf.disc_logistic_logp``, the loaded elbo
    artifact launching exactly those and equal to the eager ``apply_fn``
    with ``draw_noise``'s tensors, the sample artifact launching nothing
    and equal to ``cvae_sample`` at T = 1.0 and 0.5 (``_held_to_eager``);
    (b) the same elbo artifact in a fresh process with no model code, the
    same bits and launches (run beside (c)-(f)); (c) the 5x5 config from
    a data-dependent init at k = 4: 60 ``iaf.masked_conv2d`` nodes,
    launches K2 = 60, K3 = 20, K4 = 1, equal to eager; (d) the f32 recipe
    (the paper widths cut to 4 IAF layers) exported for the card and the
    CPU, TF32 off in the contract: the card's elbo within 1e-5 relative
    of the CPU's on the same noise, the card's call made under the
    default TF32 flags; (e) phase 16's MNIST logdir, both artifacts
    launching nothing and equal to eager; (f) phase 5's steady seconds
    per eval batch and phase 3's K1, K3 and K4 events ms, now through the
    torch ops, beside the direct launches', and the dispatcher's host cost
    a launch measured directly (``dispatch_cost``)."""
    import numpy as np
    import torch
    from iaf_torch import train_lib
    from iaf_torch.core.config import resolve_config
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import cvae
    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "chip_smoke_export")
    shutil.rmtree(root, ignore_errors=True)
    summary: dict = {}

    # (a) from phase 9's checkpoint, as the CLI runs it
    cfg = resolve_config(paper_logdir, "", mode="export")
    x = synthetic_dataset(cfg.image_size, cfg.channels).test_x[
        :cfg.eval_batch_size]
    t0 = time.perf_counter()
    with _default_tf32():
        paths = train_lib.export_saved(cfg, out_dir=os.path.join(root, "a"),
                                       num_samples=EVAL_BATCH, k=1,
                                       device=device)
    summary["export_s"] = time.perf_counter() - t0
    print(f"[export] (a) paper bf16: export_saved {summary['export_s']:.2f} s"
          f" (" + ", ".join(f"{k} {os.path.getsize(p)} B"
                            for k, p in paths.items()) + ")")
    # (b) starts now and runs beside the rest of the phase
    np.save(os.path.join(root, "x.npy"), x)
    t_child = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", _EXPORT_CHILD, HERE, paths["elbo"],
         os.path.join(root, "x.npy"), str(EXPORT_SEED),
         os.path.join(root, "child.npy"), str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        summary.update(_export_rest(ops, device, cfg, paths, x, root, main,
                                    rows, mnist_logdir))
        out, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    summary["child_s"] = time.perf_counter() - t_child
    check(child.returncode == 0, f"the export child failed:\n{err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    model = train_lib._serving_model(cfg, True, device)
    with _default_tf32(), torch.inference_mode():
        want = cvae.apply_fn(cfg, model, EXPORT_SEED, x, mode="eval",
                             k=1).elbo_nats.cpu().numpy()
    check(res["model_code"] == [] and res["launches"] == EXPORT_PER_CALL,
          f"the export child: {res}")
    check(np.array_equal(np.load(os.path.join(root, "child.npy")), want),
          "the export child's elbo differs from eager")
    print(f"[export] (b) a fresh process with torch, iaf_torch.ops and "
          f"iaf_torch.core.export only: launches {res['launches']}, bitwise "
          f"equal to eager, no model code imported ({summary['child_s']:.2f}"
          f" s from its start, beside (c)-(f))")
    del model
    torch.cuda.empty_cache()
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"[export] phase 18: {summary['phase_seconds']:.1f} s")
    return summary


def _export_rest(ops, device, cfg, paths, x, root, main, rows,
                 mnist_logdir) -> dict:
    """Phase 18 (a)'s checks and (c)-(f), while (b)'s child runs."""
    import torch
    from iaf_torch import train_lib
    from iaf_torch.core import export
    from iaf_torch.core.config import Config, resolve_config
    from iaf_torch.core.device import tf32
    from iaf_torch.data import feed
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import cvae, mnist_vae
    summary: dict = {"load_s": {}}
    loads = summary["load_s"]
    ds = synthetic_dataset(cfg.image_size, cfg.channels)

    # (a)'s checks
    elbo = _load_timed(paths["elbo"], loads, "paper_elbo")
    sample = _load_timed(paths["sample"], loads, "paper_sample")
    nodes = _iaf_nodes(elbo)
    check(nodes == EXPORT_PER_CALL, f"the paper elbo graph holds {nodes}")
    check(elbo.contract["tf32"] == {"cudnn": True, "matmul": False}
          and elbo.contract["device"] == "cuda" and elbo.contract["use_ema"],
          f"the paper elbo contract: {elbo.contract}")
    model = train_lib._serving_model(cfg, True, device)
    summary["paper"] = _serve_artifacts(
        ops, device, "(a) paper bf16", elbo, sample,
        lambda s: cvae.apply_fn(cfg, model, s, x, mode="eval",
                                k=1).elbo_nats,
        lambda s, t: cvae.cvae_sample(cfg, model, s, EVAL_BATCH, t), x,
        EXPORT_PER_CALL)
    print(f"[export] (a) graph {nodes}; loads {loads}")
    del model, elbo, sample
    torch.cuda.empty_cache()

    # (c) the 5x5 config at k = 4, from a data-dependent init
    cfg5 = Config().parse(PAPER5 + ",dataset=synthetic")
    model5 = cvae.init_params(cfg5, ds.train_x[:32], rng=5, device=device)
    t0 = time.perf_counter()
    with _default_tf32():
        paths5 = export.export_artifacts(cfg5, model5,
                                         os.path.join(root, "c"),
                                         num_samples=EVAL_BATCH, k=4,
                                         batch_size=EVAL_BATCH)
    summary["5x5_export_s"] = time.perf_counter() - t0
    elbo = _load_timed(paths5["elbo"], loads, "5x5_elbo")
    per5 = with_glue({"masked_conv2d": 60, "iaf_update": 20,
                      "disc_logistic_logp": 1}, cfg5)
    nodes = _iaf_nodes(elbo)
    check(nodes == per5, f"the 5x5 elbo graph holds {nodes}")
    x16 = x[:EVAL_BATCH]
    summary["5x5"] = _serve_artifacts(
        ops, device, "(c) 5x5 bf16 k=4", elbo, None,
        lambda s: cvae.apply_fn(cfg5, model5, s, x16, mode="eval",
                                k=4).elbo_nats, None, x16, per5)
    print(f"[export] (c) 5x5: graph {nodes}, exported in "
          f"{summary['5x5_export_s']:.2f} s, loaded in {loads['5x5_elbo']:.2f}"
          " s")
    del model5, elbo
    torch.cuda.empty_cache()

    # (d) the f32 recipe, the card's artifact against the CPU's
    cfg32 = Config().parse(PAPER + ",dataset=synthetic,num_blocks=4,"
                           "compute_dtype=float32")
    model = cvae.init_params(cfg32, ds.train_x[:32], rng=17, device=device)
    t0 = time.perf_counter()
    with tf32(False, False):        # what full_f32 sets for the f32 recipe
        p32 = export.export_artifacts(cfg32, model, os.path.join(root, "d"),
                                      num_samples=4, k=1, batch_size=4,
                                      platforms=["cuda", "cpu"])
    summary["f32_export_s"] = time.perf_counter() - t0
    card = _load_timed(p32["elbo_cuda"], loads, "f32_elbo_cuda")
    host = _load_timed(p32["elbo_cpu"], loads, "f32_elbo_cpu")
    check(card.contract["tf32"] == {"cudnn": False, "matmul": False},
          f"the f32 contract: {card.contract['tf32']}")
    noise = export.draw_noise(host.contract, EXPORT_SEED, "cpu")
    with _default_tf32():
        a, _, counts = _counted_call(
            ops, card, torch.from_numpy(x[:4]).to(device),
            *[t.to(device) for t in noise])
    b = host(torch.from_numpy(x[:4]), *noise)
    rel = float(((a.cpu() - b).abs() / b.abs()).max())
    per4 = {"ar_stack": 4, "iaf_update": 4, "disc_logistic_logp": 1}
    print(f"[export] (d) f32 (4 IAF layers, 4 images), card artifact "
          f"against CPU artifact, same noise: elbo {b.tolist()}, max rel err "
          f"{rel:.3e}; card launches {counts}; exported for both in "
          f"{summary['f32_export_s']:.2f} s")
    check(counts == per4, f"f32 card artifact launched {counts}")
    check(rel <= 1e-5, f"f32 card vs CPU artifact rel err {rel} > 1e-5")
    summary["f32_rel_err"] = rel

    # (f) the dispatch cost, on the f32 model's top layer
    summary["dispatch"] = dispatch_cost(ops, device, model)
    del model, card, host
    torch.cuda.empty_cache()
    now = {"seconds_per_batch": main["seconds_per_batch"],
           **{r["name"]: r["ms"] for r in rows
              if r["name"] in ("ar_stack", "iaf_update",
                               "disc_logistic_logp")}}
    summary["through_ops"] = now
    for k, v in now.items():
        print(f"[export] (f) through the torch ops: {k} {v:.4f} "
              f"{'s a paper eval batch' if k == 'seconds_per_batch' else 'ms'}"
              f" (direct launches: {BEFORE_OPS[k]:.4f}; "
              f"{100 * (v / BEFORE_OPS[k] - 1):+.1f} %)")

    # (e) phase 16's MNIST logdir
    mcfg = resolve_config(mnist_logdir, "", mode="export")
    with _default_tf32():
        mpaths = train_lib.export_saved(mcfg, out_dir=os.path.join(root, "e"),
                                        num_samples=EVAL_BATCH, k=1,
                                        device=device)
    mmodel = train_lib._serving_model(mcfg, True, device)
    mx = feed.dynamic_binarize(
        synthetic_dataset(mcfg.image_size, mcfg.channels).test_x[
            :mcfg.eval_batch_size], feed.binarize_rng(mcfg.seed, -2))
    summary["mnist"] = _serve_artifacts(
        ops, device, "(e) mnist",
        _load_timed(mpaths["elbo"], loads, "mnist_elbo"),
        _load_timed(mpaths["sample"], loads, "mnist_sample"),
        lambda s: mnist_vae.apply_fn(mcfg, mmodel, s, mx, mode="eval",
                                     k=1).elbo_nats,
        lambda s, t: mnist_vae.sample(mcfg, mmodel, s, EVAL_BATCH, t), mx, {})
    del mmodel
    torch.cuda.empty_cache()
    return summary


# phase 19: remat runs each layer's forward kernels twice a step (once
# forward, once in the backward's recompute); the backward kernels, K4
# and K5 keep their counts
PER_STEP_REMAT = {**PER_STEP, "ar_stack": 40, "iaf_update": 40}
PER_STEP_5X5_REMAT = {**PER_STEP_5X5, "masked_conv2d": 120,
                      "iaf_update": 40}
REMAT = ",scan_blocks=true,remat=true"
LEVER_REPLAYS = 8        # phase 19: replays after the warm-up and capture


def _accum_per_step(per: dict, a: int) -> dict:
    """Launches a step at grad_accum=a: each micro-batch's forward and
    backward kernels a times, K5 once."""
    return {k: v if k == "adamax_polyak" else v * a for k, v in per.items()}


def _lever_run(ops, device, cfg, host0, batches, per_step: dict,
               label: str, keep: bool = False) -> tuple:
    """Phase 19, one lever: the graphed step (``make_train_chunk``, one
    step a chunk) on a copy of the host state ``host0`` on the card (the
    only state there) over ``batches`` (the warm-up and capture, then the
    replays), each step ending in a wait for its loss. Peak memory
    (``max_memory_allocated``) over the whole run beside what was
    allocated before it (the state and whatever the script still holds)
    and the state's own bytes; the median replay; launches exactly
    ``per_step`` a step. Returns (the final state on the host where
    ``keep``, else None; the figures)."""
    import torch
    gib = 2.0 ** 30
    state = _state_copy(cfg, host0, device)
    own = sum(t.numel() * t.element_size() for t in (
        list(state.params.state_dict().values())
        + [v for part in (state.opt.m, state.opt.u, state.opt.ema)
           for v in part.values()]))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    chunk, times = _graphed_steps(cfg, state, batches)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    chunk.close()
    n = len(batches)
    per = {k: v // n for k, v in counts.items() if v}
    med = statistics.median(times[1:])
    out = {"batch_size": cfg.batch_size, "grad_accum": cfg.grad_accum,
           "remat": bool(cfg.scan_blocks and cfg.remat),
           "peak_gib": peak / gib, "before_gib": base / gib,
           "state_gib": own / gib, "above_before_gib": (peak - base) / gib,
           "median_s": med, "examples_per_s": cfg.batch_size / med,
           "warm_up_and_capture_s": times[0], "launches_per_step": per}
    print(f"[memory] {label}: peak {peak / gib:.4f} GiB, "
          f"{(peak - base) / gib:.4f} GiB above the {base / gib:.4f} GiB "
          f"allocated before the run (the state's own params, m, u and EMA "
          f"{own / gib:.4f}), over the warm-up, the capture and {n - 1} "
          f"replays; median graphed step {med:.5f} s "
          f"({cfg.batch_size / med:.1f} examples/s); warm-up and capture "
          f"{times[0]:.2f} s; launches a step {per}")
    check(counts == _expect(counts, per_step, n),
          f"{label}: launch counts {counts} != {per_step} x {n}")
    return (_state_copy(cfg, state, "cpu") if keep else None), out


def memory_phase(ops, device) -> dict:
    """Phase 19, the training step's memory levers on the paper config in
    bf16 through the graphed step: (a) at batch 32 with grad_accum 1 and
    2 and with scan_blocks=true,remat=true, and the 5x5 config plain and
    under remat; (b) at batch 256 with grad_accum 1 and 8 and remat; for
    each the peak memory, the median step and the launches a step
    (remat: K1 = K3 = 40, 5x5 K2 = 120); (c) grad_accum=2 through an NCCL
    group of one (the micro-batch row gather captured in the graph),
    bitwise the run with no group; (d) the remat step's loss and every
    gradient leaf against the plain step's on cuDNN's deterministic
    algorithms, bitwise or within 1e-6 of each leaf's max (which held is
    printed)."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.core.device import cudnn_deterministic, resolve_device
    from iaf_torch.core.rng import fold
    from iaf_torch.parallel import mesh
    from iaf_torch.parallel import train_step as ts
    t0 = time.perf_counter()
    out: dict = {}
    n = LEVER_REPLAYS + 1

    def cell(hp, levers, key):
        """Each lever of ``levers`` ({label: (hp suffix, launches a
        step)}) from one init (on 32 images), kept on the host; returns
        (the plain config, the init, the batches, {label: (the final
        state on the host for A=2, the figures)})."""
        cfg = Config().parse(hp + ",dataset=synthetic")
        batches = _step_batches(cfg, n)
        host0 = _state_copy(cfg, ts.init_train_state(
            cfg, 23, batches[0][:32], device), "cpu")
        torch.cuda.empty_cache()
        got = {}
        for label, (extra, per) in levers.items():
            lcfg = Config().parse(hp + ",dataset=synthetic" + extra)
            got[label] = _lever_run(ops, device, lcfg, host0, batches,
                                    per, f"{key} {label}",
                                    keep=label == "A=2")
            torch.cuda.empty_cache()
        return cfg, host0, batches, got

    # (a) batch 32
    cfg, host0, batches, a32 = cell(PAPER, {
        "A=1": ("", PER_STEP),
        "A=2": (",grad_accum=2", _accum_per_step(PER_STEP, 2)),
        "remat": (REMAT, PER_STEP_REMAT)}, "paper b32")
    out["a"] = {k: v[1] for k, v in a32.items()}
    rcfg = Config().parse(PAPER + ",dataset=synthetic" + REMAT)
    # (c) grad_accum=2 through an NCCL group of one
    acfg = Config().parse(PAPER + ",dataset=synthetic,grad_accum=2")
    with _group_of_one():
        mesh.init_distributed(resolve_device("cuda"))
        check(mesh.active() and mesh.world() == 1, "no group of one formed")
        grouped, fig = _lever_run(ops, device, acfg, host0, batches,
                                  _accum_per_step(PER_STEP, 2),
                                  "paper b32 A=2, NCCL group of one",
                                  keep=True)
    worst = _states_worst(a32["A=2"][0], grouped)
    print(f"[memory] (c) grad_accum=2 through an NCCL group of one against "
          f"no group, {n} steps: largest difference {worst}")
    check(all(v == 0 for v in worst.values()),
          f"grad_accum=2 through a group of one differs: {worst}")
    out["c"] = {"max_diff": worst, **fig}
    # (d) remat against the plain step on deterministic algorithms
    grads, losses = {}, {}
    with cudnn_deterministic():
        for label, c in (("plain", cfg), ("remat", rcfg)):
            st = _state_copy(cfg, host0, device)
            step = ts.make_train_step(c, st)
            losses[label] = [float(step(st, fold(7, i), batches[i])[1]
                                   ["loss"]) for i in range(2)]
            grads[label] = {k: p.grad.detach().clone() for k, p in
                            st.params.named_parameters()}
            step.close()
            del st, step
    rel = max(float((grads["remat"][k] - g).abs().max())
              / max(float(g.abs().max()), 1e-30)
              for k, g in grads["plain"].items())
    bitwise = (losses["remat"] == losses["plain"] and all(
        torch.equal(grads["remat"][k], g) for k, g in grads["plain"].items()))
    print(f"[memory] (d) remat against the plain step on cuDNN's "
          f"deterministic algorithms (the warm-up, then one replay): losses "
          f"{losses['remat']} and {losses['plain']}; every gradient leaf "
          + ("bitwise equal" if bitwise else
             f"within {rel:.3e} of its max (limit 1e-6), not bitwise"))
    check(bitwise or (rel <= 1e-6 and all(
        abs(x - y) <= 1e-6 * abs(y) for x, y in zip(losses["remat"],
                                                    losses["plain"]))),
          f"remat differs from the plain step: {rel} of a leaf's max, "
          f"losses {losses}")
    out["d"] = {"bitwise": bitwise, "grad_rel_err": rel,
                "losses": losses}
    del a32, grouped, grads, host0
    torch.cuda.empty_cache()
    # the 5x5 config at batch 32: plain and remat (K2 = 120 a step)
    _, st5, b5, c5 = cell(PAPER5, {"A=1": ("", PER_STEP_5X5),
                                   "remat": (REMAT, PER_STEP_5X5_REMAT)},
                          "5x5 b32")
    out["a_5x5"] = {k: v[1] for k, v in c5.items()}
    del st5, b5, c5
    torch.cuda.empty_cache()
    # (b) batch 256
    _, st256, b256, c256 = cell(
        PAPER.replace("batch_size=32", "batch_size=256"), {
            "A=1": ("", PER_STEP),
            "A=8": (",grad_accum=8", _accum_per_step(PER_STEP, 8)),
            "remat": (REMAT, PER_STEP_REMAT)}, "paper b256")
    out["b"] = {k: v[1] for k, v in c256.items()}
    del st256, b256, c256
    torch.cuda.empty_cache()
    for key in ("a", "a_5x5", "b"):
        plain = out[key]["A=1"]
        for label, v in out[key].items():
            if label != "A=1":
                print(f"[memory] {key} {label} against A=1: memory above "
                      f"what was allocated before the run "
                      f"{v['above_before_gib'] / plain['above_before_gib']:.3f}"
                      f"x, median step "
                      f"{v['median_s'] / plain['median_s']:.3f}x")
    out["phase_seconds"] = time.perf_counter() - t0
    print(f"[memory] phase 19: {out['phase_seconds']:.1f} s")
    return out


LOOP_BATCHES = 5        # phase 20(a): eager and graphed batches each
HEARTBEAT_STEPS = 4     # phase 20(c): steps of train with eval_every=2


def _eval_cell(ops, device, cfg, model, batch, per_chunk: dict) -> dict:
    """Phase 20(a) in one eval cell: the graphed eval step
    (``make_graphed_eval_step``) against the eager one (``make_eval_step``)
    on one batch at k=256 with one key, the counters zeroed before each
    call and read after it (exactly ``per_chunk`` a chunk, either step):
    the graphed step's first call (warm-up, capture, replays), then
    ``LOOP_BATCHES`` calls of each in turns (A B B A ..., A eager), each
    ending in a wait; every graphed result bitwise the first eager one
    where the first three eager results (the controls) are bitwise equal,
    else within ``NONDET_MARGIN`` times their largest difference (phase
    15(a)'s rule). Then weights copied in place (``load_state_dict``, as
    ``eval_loop`` loads a checkpoint; perturbed by 5 % of each leaf's
    mean magnitude): one eager and one graphed call, the graphed one a
    replay of the same graph, held to the eager one by the same rule and
    apart from the old weights' result; the old weights copied back. The
    median seconds a batch and importance samples/s of each, and one
    graphed batch profiled (its device-busy share)."""
    import torch
    from iaf_torch.parallel.eval_step import (make_eval_step,
                                              make_graphed_eval_step)
    tag = _label(cfg)
    per_chunk = with_glue(per_chunk, cfg, model)
    steps = {"eager": make_eval_step(cfg, device, k=EVAL_K),
             "graph": make_graphed_eval_step(cfg, device, k=EVAL_K)}
    chunks = steps["graph"].n_chunks

    def counted(name):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = steps[name](model, 7, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = _expect(counts, per_chunk, chunks)
        check(counts == want, f"{tag} {name} eval: launch counts {counts} != "
              f"{want}")
        check(bool(torch.isfinite(out).all()), f"{tag} {name}: not finite")
        return out.clone(), secs

    def held(graphed, eager, controls) -> tuple[bool, float, float]:
        """(whether the controls are bitwise, the graph's largest
        difference, the limit), failing where the rule fails."""
        limit = max(float((a - b).abs().max()) for a, b in (
            (controls[0], controls[1]), (controls[0], controls[2]),
            (controls[1], controls[2])))
        diff = max(float((g - eager).abs().max()) for g in graphed)
        check(diff <= NONDET_MARGIN * limit, f"{tag}: the graphed eval step "
              f"differs from the eager one by {diff} > {NONDET_MARGIN} x the "
              f"controls' {limit}")
        return limit == 0, diff, limit

    first, t_first = counted("graph")
    got = {"eager": [], "graph": []}
    secs = {"eager": [], "graph": []}
    order = [n for i in range(LOOP_BATCHES)
             for n in (("eager", "graph") if i % 2 == 0 else
                       ("graph", "eager"))]
    for name in order:
        out, t = counted(name)
        got[name].append(out)
        secs[name].append(t)
    bitwise, diff, limit = held(got["graph"] + [first], got["eager"][0],
                                got["eager"])
    graph = steps["graph"]._graph
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(5)
    params = dict(model.named_parameters())
    moved = {k: v + 0.05 * v.abs().mean() * torch.randn(
        v.shape, generator=gen, device=device) if k in params else v
        for k, v in saved.items()}
    model.load_state_dict(moved)
    new_e = [counted("eager")[0] for _ in range(3)]
    new_g, _ = counted("graph")
    check(steps["graph"]._graph is graph and graph.graph is not None,
          f"{tag}: the weight copy made the step capture again")
    new_bitwise, new_diff, new_limit = held([new_g], new_e[0], new_e)
    check(not torch.equal(new_g, first), f"{tag}: the graphed step gave "
          "the old weights' result after the weights were copied in")
    model.load_state_dict(saved)
    prof = profile_phase(f"{tag}: one graphed eval batch ({EVAL_BATCH} "
                         f"images x {EVAL_K} samples, {chunks} chunks)",
                         lambda: steps["graph"](model, 7, batch))
    steps["graph"].close()
    med = {n: statistics.median(v) for n, v in secs.items()}
    rate = {n: EVAL_BATCH * EVAL_K / v for n, v in med.items()}
    busy = prof["busy_ms"] / prof["wall_ms"]
    print(f"[loops] {tag}: graphed eval step against eager, {chunks} chunks "
          f"a batch: "
          + ("bitwise (the controls are bitwise)" if bitwise else
             f"largest difference {diff:.3e} within {NONDET_MARGIN} x the "
             f"controls' {limit:.3e}")
          + "; after an in-place weight copy "
          + ("bitwise" if new_bitwise else
             f"{new_diff:.3e} within {NONDET_MARGIN} x {new_limit:.3e}")
          + f", a replay of the same graph; launches exact a chunk "
          f"{per_chunk}")
    print(f"[loops] {tag}: median of {LOOP_BATCHES} batches (A B B A): eager "
          f"{med['eager']:.4f} s/batch ({rate['eager']:.1f} importance "
          f"samples/s), graphed {med['graph']:.4f} s/batch "
          f"({rate['graph']:.1f}/s), graphed/eager "
          f"{med['graph'] / med['eager']:.4f}; graphed batch device busy "
          f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.1f} ms "
          f"({100 * busy:.1f} %); first graphed call (warm-up and capture) "
          f"{t_first:.4f} s; eager {[round(t, 4) for t in secs['eager']]}, "
          f"graphed {[round(t, 4) for t in secs['graph']]}")
    return {"bitwise": bitwise, "max_diff": diff, "control_limit": limit,
            "after_copy_bitwise": new_bitwise, "after_copy_max_diff": new_diff,
            "eager_median_s": med["eager"], "graph_median_s": med["graph"],
            "eager_samples_per_s": rate["eager"],
            "graph_samples_per_s": rate["graph"],
            "graph_busy_ms": prof["busy_ms"], "graph_wall_ms": prof["wall_ms"],
            "graph_busy_share": busy, "first_call_s": t_first,
            "eager_s": secs["eager"], "graph_s": secs["graph"],
            "chunks": chunks}


@contextlib.contextmanager
def _host_inverses():
    """Inside the block ``invert_check`` runs the host loops
    (``invert_ar_*_host``) instead of the blocked ones."""
    from iaf_torch.models import inversion
    names = ("invert_ar_exact", "invert_ar_jacobi", "invert_ar_fixed_point")
    saved = {n: getattr(inversion, n) for n in names}
    for n in names:
        setattr(inversion, n, getattr(inversion, n + "_host"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(inversion, n, fn)


def _inversion_loops(ops, cfg, model) -> dict:
    """Phase 20(b): ``invert_check``'s three inverses on the inputs it
    builds at batch 2 (``inversion_inputs``), each by the host loop
    (``*_host``) and by the blocked loop (on the card replayed graphs),
    the counters zeroed before and read after each: z bitwise equal, the
    fixed point's counts equal, K1's launches one a sweep (the blocks'
    idle sweeps included), the seconds of each and one sweep's ms."""
    import torch
    from iaf_torch import train_lib
    from iaf_torch.models import inversion as inv
    with torch.inference_mode():
        z0, _, ar_fn, zp = train_lib.inversion_inputs(cfg, model, 2)
    D = zp.shape[1] * zp.shape[2] * zp.shape[3]
    kw = dict(form=cfg.flow_update, gate_bias=cfg.gate_forget_bias)
    loops = {
        "exact": (lambda: (inv.invert_ar_exact_host(ar_fn, zp, **kw), D),
                  lambda: (inv.invert_ar_exact(ar_fn, zp, **kw), D)),
        "jacobi": (lambda: (inv.invert_ar_jacobi_host(ar_fn, zp, D, **kw), D),
                   lambda: (inv.invert_ar_jacobi(ar_fn, zp, D, **kw), D)),
        "fixed_point": (
            lambda: inv.invert_ar_fixed_point_host(ar_fn, zp, **kw),
            lambda: inv.invert_ar_fixed_point(ar_fn, zp, **kw))}
    blocks = {"exact": inv.EXACT_BLOCK, "jacobi": inv.EXACT_BLOCK,
              "fixed_point": inv.FIXED_POINT_BLOCK}
    out = {}
    for name, pair in loops.items():
        res = {}
        for how, fn in zip(("host", "graphed"), pair):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with torch.inference_mode():
                z, n = fn()
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            k1 = ops.launch_counts()["ar_stack"]
            sweeps = n if how == "host" else _blocked(n, blocks[name])
            check(k1 == sweeps, f"{name} {how}: K1 {k1} launches, "
                  f"{sweeps} sweeps")
            res[how] = dict(z=z, sweeps=n, seconds=t, k1=k1,
                            sweep_ms=1e3 * t / k1)
        h, g = res["host"], res["graphed"]
        check(torch.equal(h["z"], g["z"]) and h["sweeps"] == g["sweeps"],
              f"{name}: the graphed loop differs from the host loop "
              f"(sweeps {g['sweeps']}, {h['sweeps']})")
        err = float(torch.max(torch.abs(g["z"] - z0)))
        check(err < 1e-4, f"{name}: round trip {err}")
        print(f"[loops] inversion {name} (batch 2, D = {D}): graphed "
              f"bitwise the host loop, {g['sweeps']} sweeps, round trip "
              f"{err:.3e}; host {h['seconds']:.4f} s ({h['k1']} K1 launches, "
              f"{h['sweep_ms']:.4f} ms a sweep), graphed {g['seconds']:.4f} s "
              f"({g['k1']} K1 launches, {g['sweep_ms']:.4f} ms a sweep), "
              f"graphed/host {g['seconds'] / h['seconds']:.4f}")
        out[name] = {"sweeps": g["sweeps"], "round_trip": err,
                     **{f"{how}_{k}": v for how, r in res.items()
                        for k, v in r.items() if k != "z"}}
    return out


def _heartbeat_cell(ops, device) -> dict:
    """Phase 20(c): ``train`` at the paper config (bf16, batch 32) for
    ``HEARTBEAT_STEPS`` steps with the heartbeat eval every 2 steps (its
    graphed step: k = 64 in one chunk of 16 images, the first heartbeat
    the warm-up and capture, the second a replay of its graph) beside the
    same run with no heartbeat: launches exactly the steps' and the
    heartbeats' (K1 = K3 = 20, K4 = 1 a heartbeat), finite heartbeat
    rows, and the peak memory of each run with the train graph and the
    eval graph alive together."""
    import torch
    from iaf_torch import train_lib
    from iaf_torch.core.config import Config
    out = {}
    per_beat = {"ar_stack": 20, "iaf_update": 20, "disc_logistic_logp": 1}
    for every in (0, 2):
        logdir = os.path.join(HERE, "build", f"chip_smoke_heartbeat_{every}")
        shutil.rmtree(logdir, ignore_errors=True)
        cfg = Config().parse(
            PAPER + f",dataset=synthetic,log_every=1,ckpt_every=1000,"
            f"eval_every={every},image_summaries=false").replace(
                logdir=logdir)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        train_lib.train(cfg, max_steps=HEARTBEAT_STEPS, device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = ops.launch_counts()
        want = _expect(counts, PER_STEP, HEARTBEAT_STEPS)
        beats = HEARTBEAT_STEPS // every if every else 0
        for k, v in with_glue(per_beat, cfg).items():
            want[k] = want.get(k, 0) + v * beats
        check(counts == want, f"train eval_every={every}: launches {counts} "
              f"!= {want}")
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            evals = [json.loads(line)["eval_bits_per_dim"] for line in f
                     if "eval_bits_per_dim" in line]
        check(len(evals) == beats and all(map(math.isfinite, evals)),
              f"heartbeat rows {evals}")
        gib = 2.0 ** 30
        print(f"[loops] train, paper bf16, batch 32, {HEARTBEAT_STEPS} steps, "
              f"eval_every={every}: {secs:.3f} s with init, {beats} heartbeat "
              f"evals {evals}; peak memory {peak / gib:.3f} GiB "
              f"({(peak - base) / gib:.3f} GiB above the {base / gib:.3f} "
              f"allocated before); launches exact {counts}")
        out[f"eval_every_{every}"] = {"peak_gib": peak / gib,
                                      "above_before_gib": (peak - base) / gib,
                                      "seconds": secs, "heartbeats": evals}
    return out


def loops_phase(ops, device) -> dict:
    """Phase 20, the serving loops on the device: (a) ``_eval_cell`` in the
    five eval cells (paper, paper f32, 5x5, 5x5 f32, MNIST; each model
    from a data-dependent init, the f32 cells on the bf16 cells' models);
    (b) ``_inversion_loops`` on the paper model; (c) ``_heartbeat_cell``.
    The f32 cells run with TF32 off, as the f32 recipe runs on the card."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.data import feed
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import cvae, mnist_vae
    t0 = time.perf_counter()
    out: dict = {}
    ev = f",dataset=synthetic,eval_batch_size={EVAL_BATCH}," \
         f"eval_k_chunk={EVAL_CHUNK}"
    ds = synthetic_dataset(32, 3)
    batch = ds.test_x[:EVAL_BATCH]
    for hp, per in ((PAPER, {"ar_stack": 20, "iaf_update": 20,
                             "disc_logistic_logp": 1}),
                    (PAPER5, {"masked_conv2d": 60, "iaf_update": 20,
                              "disc_logistic_logp": 1})):
        cfg = Config().parse(hp + ev)
        model = cvae.init_params(cfg, ds.train_x[:32], rng=cfg.seed,
                                 device=device)
        for extra in ("", ",compute_dtype=float32"):
            c = Config().parse(hp + ev + extra)
            out[_label(c)] = _eval_cell(ops, device, c, model, batch, per)
        if hp == PAPER:
            out["inversion"] = _inversion_loops(ops, cfg, model)
        del model
        torch.cuda.empty_cache()
    cfg = Config().parse(MNIST + ev)
    model = mnist_vae.init_params(cfg, _train_images(cfg, cfg.batch_size),
                                  rng=cfg.seed, device=device)
    test = feed.dynamic_binarize(
        synthetic_dataset(cfg.image_size, cfg.channels).test_x[:EVAL_BATCH],
        feed.binarize_rng(cfg.seed, -2))
    out["mnist"] = _eval_cell(ops, device, cfg, model, test, {})
    del model
    torch.cuda.empty_cache()
    out["heartbeat"] = _heartbeat_cell(ops, device)
    out["phase_seconds"] = time.perf_counter() - t0
    print(f"[loops] phase 20: {out['phase_seconds']:.1f} s")
    return out


def run() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
        import iaf_torch
    except ImportError as e:
        raise SmokeFailure(f"iaf_torch is not beside this script: {e}")
    if os.path.dirname(os.path.dirname(os.path.abspath(iaf_torch.__file__))) \
            != HERE:
        raise SmokeFailure(f"iaf_torch imported from {iaf_torch.__file__}, "
                           f"not from {HERE}")
    from iaf_torch import ops
    from iaf_torch.core.config import Config
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import cvae

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # phase 1: build
    build_phase(ops, device)

    # phase 2: the paper config, data-dependent init (plain convs), twice
    cfg = Config().parse(PAPER + f",dataset=synthetic,eval_batch_size="
                         f"{EVAL_BATCH},eval_k_chunk={EVAL_CHUNK}")
    ds = synthetic_dataset(cfg.image_size, cfg.channels)
    model, init = init_twice(cvae, cfg, ds.train_x[:32], device,
                             f"paper config ({cfg.num_blocks} IAF layers, "
                             f"h={cfg.h_size}, z={cfg.z_size})")

    # phase 3: kernels against their twins on one real chunk's inputs
    def one_chunk():
        with torch.inference_mode():
            cvae.apply_fn(cfg, model, 1, ds.test_x[:EVAL_BATCH], mode="eval",
                          k=EVAL_CHUNK)
    rows = kernel_phase(ops, capture_inputs(ops, one_chunk), device)
    rows += glue_phase(ops, device)
    main_glue = glue_route_phase(cfg, model, ds.test_x[:EVAL_BATCH],
                                 EVAL_CHUNK, "paper")
    profile_phase(f"one eval chunk (16 images x {EVAL_CHUNK} samples)",
                  one_chunk)

    # phase 4: the port against the plain twins on a small input
    reference_phase(device)

    # phase 5: the main path, counted
    eval_counts, main = eval_phase(
        ops, device, cfg, model, ds,
        {"ar_stack": len(model.blocks), "iaf_update": len(model.blocks),
         "disc_logistic_logp": 1})

    # phase 6: the f32 recipe: K1's f32 kernels, eval and training, counted
    rows32, eval32, counts32, summary32 = f32_phases(ops, device, model, ds)
    rows += rows32
    del model
    torch.cuda.empty_cache()

    # phase 7: backward kernels and K5 against their twins on one real
    # training step's inputs (paper config, bf16, batch 32)
    from iaf_torch.parallel import train_step as ts
    tcfg = Config().parse(PAPER + ",dataset=synthetic")
    tbatch = ds.train_x[:tcfg.batch_size]
    tstate = ts.init_train_state(tcfg, 11, tbatch, device)
    cap = capture_train_step(
        ops, lambda: ts.train_step(tcfg, tstate, 3, tbatch))
    rows += backward_kernel_phase(ops, cap)
    forward_b32_phase(ops, cap, rows)
    rows.append(adamax_phase(ops, tcfg, tstate))
    del cap, tstate
    torch.cuda.empty_cache()

    # phase 8: one f32 training step, card against the CPU twins
    train_reference_phase(device)

    # phase 9: the training main path, counted, resumed, profiled
    tcfg, tstate, counts, summary = train_phase(ops, device)
    summary["profile"] = profile_phase(
        f"one training step (batch {tcfg.batch_size})",
        lambda: ts.train_step(tcfg, tstate, 99, tbatch))
    del tstate
    torch.cuda.empty_cache()

    # phase 10: K1 at the deepest chain it holds
    k1_depth_phase(ops, device)

    # phases 11 and 12: the 5x5 config through K2, bf16 and f32
    k2_rows, eval5, counts5, summary5, f32_5 = five_by_five_phases(
        ops, device, ds)
    k2_rows32, eval5_32, counts5_32, summary5_32 = f32_5
    rows += k2_rows + k2_rows32

    # phase 13: a 3x3 chain deeper than K1 holds, through K2
    deep_chain_phase(ops, device)

    # phase 14: the serving modes on phase 9's logdir
    t0 = time.perf_counter()
    serve_rows, serve_counts, serve = serve_phase(ops, device, tcfg)
    serve["phase_seconds"] = time.perf_counter() - t0
    print(f"[serve] phase 14: {serve['phase_seconds']:.1f} s")
    rows += serve_rows

    # phase 15: the captured training step: against the eager step, side
    # by side in the four training cells, and steps_per_dispatch=4
    graph = graph_phase(ops, device, tcfg.logdir)

    # phase 16: the MNIST family
    mnist_rows, mnist_counts, mnist = mnist_phase(ops, device)
    rows += mnist_rows

    # phase 17: data parallelism: NCCL at world size 1, two cards if seen
    multi = multi_phase(ops, device, tcfg.logdir)

    # phase 18: --mode export on the card, the kernels as torch ops
    exported = export_phase(ops, device, tcfg.logdir, mnist["logdir"], main,
                            rows)

    # phase 19: the training step's memory levers (grad_accum, remat)
    memory = memory_phase(ops, device)

    # phase 20: the serving loops on the device (graphed eval, inversion)
    loops = loops_phase(ops, device)
    for key, s in (("train", summary), ("train_f32", summary32["train"]),
                   ("train_5x5", summary5["train"]),
                   ("train_5x5_f32", summary5_32["train"])):
        s["side_by_side"] = graph[key]
    paths = {"paper": (eval_counts, counts), "5x5": (eval5, counts5),
             "paper f32": (eval32, counts32),
             "5x5 f32": (eval5_32, counts5_32),
             **{k: (dict.fromkeys(v, 0), v) for k, v in serve_counts.items()},
             **mnist_counts}
    for r in rows:     # each kernel's launches on the main path it is on
        ev, tr = paths[r.setdefault(
            "path", "5x5" if r["name"] in K2_NAMES else "paper")]
        key = r.get("counter", r["name"])
        r["launches"] = tr[key]
        if ev[key]:     # the forward kernels
            r["launches_eval"] = ev[key]
    for r in rows:
        dev = ("" if "device_ms" not in r else
               f" (device {r['device_ms']:.4f} ms, library "
               f"{r.get('library_device_ms')} ms)")
        print(f"[time] {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms{dev}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), launches "
              f"{r['launches']}")
    main["init"] = init
    main["glue_route"] = main_glue
    print(json.dumps({"main": main, "train": summary,
                      "main_f32": summary32["main"],
                      "train_f32": summary32["train"],
                      "main_5x5": summary5["main"],
                      "train_5x5": summary5["train"],
                      "main_5x5_f32": summary5_32["main"],
                      "train_5x5_f32": summary5_32["train"],
                      "serve": serve,
                      "graph_vs_eager": graph["graph_vs_eager"],
                      "train_chunked": graph["chunked"],
                      "train_f32_determinism": graph["f32_determinism"],
                      "graph_phase_seconds": graph["phase_seconds"],
                      "mnist": mnist, "multi": multi,
                      "export": exported, "memory": memory,
                      "loops": loops}))
    print(json.dumps({"kernels": rows}))
    return {"ok": True, "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}}


def _ab_k1_fwd(ops, k1, f32: bool = False) -> dict:
    """A/B case ``k1_fwd``: K1's forward at the eval shape (N = 1024) and
    at batch 32 with the pre-activations written, paper widths, inputs
    from a seed. With ``f32`` (case ``k1_fwd_f32``) the same in f32 (the
    f32 recipe's), full-mantissa inputs, the error against the twin in
    f64; whatever kernel the tree routes f32 to runs (before the 3xTF32
    route: the FMA kernel)."""
    import torch
    dtype = torch.float32 if f32 else torch.bfloat16
    gen = torch.Generator().manual_seed(5)
    ws, bs, _ = _paper_chain(2, gen)
    ws = [w.cuda().to(dtype) for w in ws]
    bs = [b.cuda() for b in bs]
    out = {}
    for label, n, pre in (("eval", 1024, False), ("b32", 32, True)):
        z = torch.randn(n, 16, 16, 32, generator=gen).cuda().to(dtype)
        c = torch.randn(n, 16, 16, 160, generator=gen).cuda()
        with torch.inference_mode():
            ref = ops.ar_stack_ref(*(_f64(z, c, ws, bs) if f32
                                     else (z, c, ws, bs)))
            err = _rel_err(k1._fwd(z, c, ws, bs, pre)[0], ref)[1]
            out[label] = (lambda z=z, c=c, pre=pre:  # noqa: E731
                          k1._fwd(z, c, ws, bs, pre), err)
    return out


def _ab_k1_fwd_small(ops, k1) -> dict:
    """A/B case ``k1_fwd_small``: K1's forward at the serving shapes, paper
    widths, inputs from a seed: N = 2 in f32 (``invert_check``'s, against
    the twin in f64) and N = 16 in bf16 (``recon``'s)."""
    import torch
    gen = torch.Generator().manual_seed(6)
    ws, bs, _ = _paper_chain(2, gen)
    out = {}
    for label, n, dtype in (("N=2 f32", 2, torch.float32),
                            ("N=16 bf16", 16, torch.bfloat16)):
        w = [x.cuda().to(dtype) for x in ws]
        b = [x.cuda() for x in bs]
        z = torch.randn(n, 16, 16, 32, generator=gen).cuda().to(dtype)
        c = torch.randn(n, 16, 16, 160, generator=gen).cuda()
        f32 = dtype == torch.float32
        with torch.inference_mode():
            ref = ops.ar_stack_ref(*(_f64(z, c, w, b) if f32
                                     else (z, c, w, b)))
            err = _rel_err(k1._fwd(z, c, w, b, False)[0], ref)[1]
            out[label] = (lambda z=z, c=c, w=w, b=b:  # noqa: E731
                          k1._fwd(z, c, w, b, False), err)
    return out


def _ab_k1_bwd_f32(ops, k1) -> dict:
    """A/B case ``k1_bwd_f32``: K1's f32 backward at batch 32, paper
    widths, the inputs and output gradient from a seed (full f32
    mantissas), the pre-activations from the tree's own f32 forward; the
    error (the largest of dz, dcontext, dW at the live taps and db, each
    over its max) against the twin in f64; whatever kernels the tree
    routes f32 to run (before the 3xTF32 route: the FMA kernels)."""
    import torch
    gen = torch.Generator().manual_seed(9)
    ws, bs, _ = _paper_chain(2, gen)
    ws = [w.float().cuda() for w in ws]
    bs = [b.float().cuda() for b in bs]
    z, c, g = (torch.randn(32, 16, 16, ch, generator=gen).cuda()
               for ch in (32, 160, 64))
    with torch.no_grad():
        pre = k1._fwd(z, c, ws, bs, True)[1]
    want = ops.ar_stack_bwd_ref(*_f64(z, c, ws, bs), g.double())
    err = max(rel for _, _, rel in _k1_bwd_errs(
        ops.ar_stack_bwd(z, ws, pre, g), want))
    return {"b32": (lambda: ops.ar_stack_bwd(z, ws, pre, g), err)}


def _k2_f32_convs(n: int, seed: int) -> dict:
    """The three 5x5 AR convs at the paper widths in f32, from a seed: per
    label (x [n,16,16,cin] on the card, the folded masked weights, the
    live taps), full f32 mantissas."""
    import numpy as np
    import torch
    from iaf_torch.nn.masks import get_conv_ar_mask, nonzero_taps
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for cin, cout, zd in ((32, 160, True), (160, 64, False),
                          (160, 160, False)):
        m = (get_conv_ar_mask(5, 5, cin, cout, zd) if cout % cin == 0
             or cin % cout == 0 else np.concatenate(
                 [get_conv_ar_mask(5, 5, cin, cout // 2, zd)] * 2, -1))
        w = (torch.randn(5, 5, cin, cout, generator=gen)
             / math.sqrt(13 * cin) * torch.from_numpy(m))
        x = torch.randn(n, 16, 16, cin, generator=gen)
        out[f"{cin}->{cout}"] = (x.cuda(), w.cuda(), nonzero_taps(m))
    return out


def _ab_k2_fwd(ops, k1, f32: bool = True) -> dict:
    """A/B case ``k2_fwd_f32``: K2's forward in f32 at the eval shape (N =
    1024) for the three 5x5 AR convs, inputs from a seed, the error
    against the twin in f64; whatever kernel the tree routes f32 to runs
    (before the 3xTF32 route: the FMA kernel). ``k2_fwd``: the same
    inputs in bf16, against the twin."""
    out = {}
    for label, (x, w, taps) in _k2_f32_convs(1024, 6).items():
        if not f32:
            x, w = x.bfloat16(), w.bfloat16()
        ref = ops.masked_conv2d_ref(*((x.double(), w.double()) if f32
                                      else (x, w)), taps)
        err = _rel_err(ops.masked_conv2d(x, w, taps), ref)[1]
        out[label] = (lambda x=x, w=w, taps=taps:  # noqa: E731
                      ops.masked_conv2d(x, w, taps), err, 10)
    return out


def _ab_k2_fwd_b32(ops, k1) -> dict:
    """A/B case ``k2_fwd_b32``: K2's forward at the 5x5 training step's
    batch 32 for the three 5x5 AR convs, inputs from a seed
    (``_k2_f32_convs(32, ...)``), in bf16 (against the twin) and in f32
    (against the twin in f64), each conv alone and the three in one call
    (``sum``), on the plan the tree picks (before ``fwd_plan``: 128-pixel
    tiles)."""
    import torch
    out = {}
    convs = _k2_f32_convs(32, 21)
    for tag, f32 in (("bf16", False), ("f32", True)):
        calls, errs = [], []
        for label, (x, w, taps) in convs.items():
            if not f32:
                x, w = x.bfloat16(), w.bfloat16()
            with torch.inference_mode():
                ref = ops.masked_conv2d_ref(*((x.double(), w.double()) if f32
                                              else (x, w)), taps)
                errs.append(_rel_err(ops.masked_conv2d(x, w, taps), ref)[1])
            calls.append(lambda x=x, w=w, taps=taps:  # noqa: E731
                         ops.masked_conv2d(x, w, taps))
            out[f"{tag} {label}"] = (calls[-1], errs[-1], 50)
        out[f"{tag} sum"] = (lambda calls=calls: [c() for c in calls],
                             max(errs), 50)
    return out


def _ab_k2_bwd_f32(ops, k1) -> dict:
    """A/B case ``k2_bwd_f32``: K2's backward in f32 at the training
    shape (batch 32) for the three 5x5 AR convs, inputs and output
    gradient from a seed, the error (dx and dW, the larger) against the
    twin in f64."""
    import torch
    out = {}
    for label, (x, w, taps) in _k2_f32_convs(32, 7).items():
        g = torch.randn(*x.shape[:3], w.shape[3],
                        generator=torch.Generator().manual_seed(8)).cuda()
        got = ops.masked_conv2d_bwd(x, w, g, taps)
        ref = ops.masked_conv2d_bwd_ref(x.double(), w.double(), g.double(),
                                        taps)
        err = max(_rel_err(a, b)[1] for a, b in zip(got, ref))
        out[label] = (lambda x=x, w=w, g=g, taps=taps:  # noqa: E731
                      ops.masked_conv2d_bwd(x, w, g, taps), err)
    return out


def _ab_f32_chunk(ops, k1, device="cuda", hp=PAPER,
                  kernel="ar_stack") -> dict:
    """A/B case ``f32_chunk``: one eval chunk of the paper config in f32
    (16 images x 64 samples; random weights from a data-dependent init on
    synthetic data; TF32 off, as ``train_lib`` sets it for the f32
    recipe), timed over 5 calls; the error is the chunk's log-weights
    against the same chunk with the twin of ``ops.kernel`` (K1's) in
    place of its kernel. ``f32_chunk_5x5``: the same for the 5x5 config
    and K2."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.models import cvae
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config().parse(hp + f",compute_dtype=float32,dataset=synthetic,"
                         f"eval_batch_size={EVAL_BATCH},eval_k_chunk="
                         f"{EVAL_CHUNK}")
    ds = synthetic_dataset(cfg.image_size, cfg.channels)
    model = cvae.init_params(cfg, ds.train_x[:32], rng=cfg.seed,
                             device=torch.device(device))
    x = ds.test_x[:EVAL_BATCH]

    def chunk():
        with torch.inference_mode():
            return cvae.apply_fn(cfg, model, 1, x, mode="eval",
                                 k=EVAL_CHUNK).log_w
    got = chunk()
    original = getattr(ops, kernel)
    setattr(ops, kernel, (
        lambda z, c, ws, bs, masks: ops.ar_stack_ref(z, c, ws, bs))
        if kernel == "ar_stack" else ops.masked_conv2d_ref)
    try:
        ref = chunk()
    finally:
        setattr(ops, kernel, original)
    return {"chunk": (chunk, _rel_err(got, ref)[1], 5)}


def _ab_f32_step(ops, k1) -> dict:
    """A/B case ``f32_step``: the forward and backward of one training
    step of the paper config in f32 at batch 32 (init from a seed on
    synthetic data; TF32 off, as ``train_lib`` sets it for the f32 recipe;
    the optimizer left out), timed over 3 calls: its device time is the
    step's busy time less K5's. The error is the worst gradient leaf's,
    over its max, against the same step with K1's twin in place of its
    kernels (autograd of the twin as its backward)."""
    import torch
    from iaf_torch.core.config import Config
    from iaf_torch.data.datasets import synthetic_dataset
    from iaf_torch.parallel import train_step as ts
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config().parse(PAPER + ",compute_dtype=float32,dataset=synthetic")
    ds = synthetic_dataset(cfg.image_size, cfg.channels)
    batch = ds.train_x[:cfg.batch_size]
    model = ts.init_train_state(cfg, 11, batch, "cuda").params
    batch = ts._device_batch(batch, model.h_top.device)

    def grads():
        g = ts._grads_and_metrics(cfg, model, 3, batch)[0]
        return {k: v.clone() for k, v in g.items() if v is not None}
    got = grads()
    original = ops.ar_stack
    ops.ar_stack = lambda z, c, ws, bs, masks: ops.ar_stack_ref(z, c, ws, bs)
    try:
        ref = grads()
    finally:
        ops.ar_stack = original
    err = max(_rel_err(got[k], ref[k])[1] for k in ref)
    return {"step": (lambda: ts._grads_and_metrics(cfg, model, 3, batch),
                     err, 3)}


def _k4_inputs(n: int, seed: int):
    """K4's inputs at the paper config's image size from a seed, on the
    card: samples on bin edges (images / 256 - 0.5), means near them, the
    log-scale at the model's init (0), and an upstream gradient a row."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    sample = torch.randint(0, 256, (n, 32, 32, 3), generator=gen) / 256.0 - 0.5
    mean = sample + 0.05 * torch.randn(sample.shape, generator=gen)
    g = torch.randn(n, generator=gen)
    return (mean.cuda(), torch.zeros(1, device="cuda"), sample.cuda(),
            g.cuda())


def _ab_k4_fwd(ops, k1) -> dict:
    """A/B case ``k4_fwd``: K4's forward at the eval shape (N = 1024) and
    at batch 32, inputs from a seed, the largest relative error of a row
    against the twin."""
    import torch
    out = {}
    for label, n in (("eval", 1024), ("b32", 32)):
        mean, ls, sample, _ = _k4_inputs(n, 10 + n)
        with torch.inference_mode():
            got = ops.disc_logistic_logp(mean, ls, sample)
            ref = ops.disc_logistic_ref(mean, ls, sample)
        out[label] = (lambda m=mean, l_=ls, s_=sample:  # noqa: E731
                      ops.disc_logistic_logp(m, l_, s_),
                      float(((got - ref).abs() / ref.abs()).max()))
    return out


def _ab_k4_bwd(ops, k1) -> dict:
    """A/B case ``k4_bwd``: K4's backward at batch 32, inputs and upstream
    gradient from a seed, the error (dmean over its max, dlogscale
    relative, the larger) against autograd of the twin."""
    mean, ls, sample, g = _k4_inputs(32, 12)
    got = ops.disc_logistic_bwd(mean, ls, sample, g)
    ref = ops.disc_logistic_bwd_ref(mean, ls, sample, g)
    err = max(_rel_err(a, b)[1] for a, b in zip(got, ref))
    return {"b32": (lambda: ops.disc_logistic_bwd(mean, ls, sample, g), err)}


# The A/B cases: each takes (ops, the K1 module) of the tree under test
# and returns {label: (a call of the kernel's wrapper or of the path
# around it, its relative error against the twin[, calls to time, 20 if
# not given])}; ``ab`` times every call by device time and events.
def _ab_wrappers(ops, k1) -> dict:
    """A/B case ``wrappers``: the no-grad public wrappers at the serving
    shapes where a call costs more host time than device time, K1 in f32
    at N = 2 (``invert_check``'s, paper widths, weights from a seed), K3
    at N = 2 and K4 at 2 images: by events, what a call costs its caller
    (the torch ops' dispatch included)."""
    import torch
    gen = torch.Generator().manual_seed(31)
    ws, bs, masks = _paper_chain(2, gen)
    ws, bs = [w.cuda() for w in ws], [b.cuda() for b in bs]
    z = torch.randn(2, 16, 16, 32, generator=gen).cuda()
    ctx = torch.randn(2, 16, 16, 160, generator=gen).cuda()
    a = [torch.randn(2, 16, 16, 32, generator=gen).cuda() for _ in range(4)]
    mean, ls, sample, _ = _k4_inputs(2, 33)
    with torch.inference_mode():
        k1_err = _rel_err(ops.ar_stack(z, ctx, ws, bs, masks),
                          ops.ar_stack_ref(z, ctx, ws, bs))[1]
        k3_err = _rel_err(ops.iaf_update(*a)[0], ops.iaf_update_ref(*a)[0])[1]
        k4_err = _rel_err(ops.disc_logistic_logp(mean, ls, sample),
                          ops.disc_logistic_ref(mean, ls, sample))[1]
    return {"k1_f32_n2": (lambda: ops.ar_stack(z, ctx, ws, bs, masks),
                          k1_err, 200),
            "k3_n2": (lambda: ops.iaf_update(*a), k3_err, 200),
            "k4_n2": (lambda: ops.disc_logistic_logp(mean, ls, sample),
                      k4_err, 200)}


AB_CASES = {"k1_fwd": _ab_k1_fwd,
            "k1_fwd_small": _ab_k1_fwd_small,
            "k1_fwd_f32": lambda ops, k1: _ab_k1_fwd(ops, k1, f32=True),
            "k1_bwd_f32": _ab_k1_bwd_f32,
            "f32_step": _ab_f32_step,
            "f32_chunk": _ab_f32_chunk,
            "k2_fwd_f32": _ab_k2_fwd,
            "k2_fwd": lambda ops, k1: _ab_k2_fwd(ops, k1, f32=False),
            "k2_fwd_b32": _ab_k2_fwd_b32,
            "k2_bwd_f32": _ab_k2_bwd_f32,
            "f32_chunk_5x5": lambda ops, k1: _ab_f32_chunk(
                ops, k1, hp=PAPER5, kernel="masked_conv2d"),
            "k4_fwd": _ab_k4_fwd,
            "k4_bwd": _ab_k4_bwd,
            "wrappers": _ab_wrappers}

# One process per tree for ``ab``: the iaf_torch beside argv[1], timed
# with this script's helpers (argv[2]) on case argv[3].
_AB_CHILD = r"""
import importlib, importlib.util, json, os, sys
root, here, cases = sys.argv[1:4]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("smoke", here)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from iaf_torch import ops
k1 = importlib.import_module("iaf_torch.ops.ar_stack")
assert os.path.dirname(k1.__file__).startswith(os.path.abspath(root)), \
    k1.__file__
out = {}
for case in cases.split(","):
    for label, (call, err, *n) in cs.AB_CASES[case](ops, k1).items():
        iters = n[0] if n else 20
        kernels = sorted(cs.device_kernels(call, iters), key=lambda k: -k[1])
        out[f"{case} {label}"] = {
            "rel_err": err, "ms": cs.cuda_ms(call, iters),
            "device_ms": sum(k[1] for k in kernels),
            "by_kernel": [[k[0][:60], k[1], k[2]] for k in kernels[:8]]}
print(json.dumps({"tree": root, "case": cases, **out}))
"""


# ``ab``'s case ``step``, one process per tree: ``train_lib.train`` of the
# paper bf16 config for AB_STEPS steps in the tree argv[1] (its kernels
# built first, all at once), logging every step into argv[2]; prints the
# median steady step (steps 3 on, each ending in a wait for its loss).
_AB_STEP_CHILD = r"""
import json, os, shutil, statistics, sys, threading
root, logdir, hp, steps = sys.argv[1:4] + [int(sys.argv[4])]
sys.path.insert(0, root)
from iaf_torch import train_lib
from iaf_torch.core.config import Config
from iaf_torch.ops import _build
assert os.path.dirname(_build.__file__).startswith(os.path.abspath(root)), \
    _build.__file__
builds = [threading.Thread(target=_build.load, args=(n,)) for n in (
    "ar_stack", "ar_stack_bwd", "masked_conv", "masked_conv_bwd",
    "disc_logistic")]
for t in builds:
    t.start()
for t in builds:
    t.join()
shutil.rmtree(logdir, ignore_errors=True)
cfg = Config().parse(hp + ",dataset=synthetic,log_every=1,ckpt_every=100000,"
                     "eval_every=0").replace(logdir=logdir)
train_lib.train(cfg, max_steps=steps)
with open(os.path.join(logdir, "metrics.jsonl")) as f:
    rows = [json.loads(line) for line in f]
step_s = [1.0 / r["steps_per_sec"] for r in rows[2:]]
print(json.dumps({"tree": root, "median_step_s": statistics.median(step_s),
                  "step_s": step_s, "losses": [r["loss"] for r in rows]}))
"""
AB_STEPS = 10
# Each step's loss in every A/B step run within this of the first run's:
# a tree whose data-dependent init does not run on cuDNN's deterministic
# algorithms starts each run from other last bits (its transposed conv),
# which 10 steps of Adamax carry to 1.5e-5 of the loss on an H100.
AB_STEP_REL = 1e-4


# ``ab``'s step cases: the config each trains
AB_STEP_CONFIGS = {"step": PAPER, "step_5x5": PAPER5,
                   "step_5x5_f32": PAPER5 + ",compute_dtype=float32"}


def ab_step(other: str, hp: str = PAPER) -> list[dict]:
    """The A/B cases ``step`` (the paper bf16 config), ``step_5x5`` and
    ``step_5x5_f32`` (``AB_STEP_CONFIGS``): ``train_lib.train`` for
    ``AB_STEPS`` steps of ``hp`` in the tree ``other`` (A) and in this one
    (B), A B B A, each a process of its own on the same card; each run's
    median steady step. Every run's losses must agree within
    ``AB_STEP_REL``."""
    runs = []
    for i, root in enumerate((other, HERE, HERE, other)):
        proc = subprocess.run(
            [sys.executable, "-c", _AB_STEP_CHILD, os.path.abspath(root),
             os.path.join(HERE, "build", f"chip_smoke_ab_step_{i}"), hp,
             str(AB_STEPS)], capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"A/B step run of {root} failed:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[A/B step] {root}: median steady step {r['median_step_s']:.4f}"
              f" s over steps 3-{AB_STEPS} "
              f"{[round(t, 4) for t in r['step_s']]}; last loss "
              f"{r['losses'][-1]}")
        runs.append(r)
    rel = max(abs(x - y) / abs(y) for r in runs
              for x, y in zip(r["losses"], runs[0]["losses"]))
    print(f"[A/B step] largest relative difference of a step's loss from "
          f"the first run's: {rel:.3e}")
    check(rel <= AB_STEP_REL, f"the A/B step runs' losses differ by {rel} "
          f"> {AB_STEP_REL}: {[r['losses'] for r in runs]}")
    return runs


# ``ab``'s case ``graph_check``, one process per run: phase 15(a)'s check
# of the paper f32 cell alone in the tree argv[1] (its kernels built first,
# all at once), as that tree's chip_smoke runs it: ``graph_check`` where
# the tree has it, else its older form (one control, the deterministic
# rerun only where the control is not bitwise). Prints whether it passed.
_AB_GRAPH_CHILD = r"""
import importlib.util, json, os, sys, threading
root = sys.argv[1]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location(
    "smoke", os.path.join(root, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
from iaf_torch import ops
from iaf_torch.ops import _build
assert os.path.dirname(_build.__file__).startswith(os.path.abspath(root)), \
    _build.__file__
builds = [threading.Thread(target=_build.load, args=(n,)) for n in (
    "ar_stack", "ar_stack_bwd", "masked_conv", "masked_conv_bwd",
    "disc_logistic")]
for t in builds:
    t.start()
for t in builds:
    t.join()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
hp = cs.PAPER + ",compute_dtype=float32"
try:
    if hasattr(cs, "graph_check"):
        r = cs.graph_check(ops, dev, hp)
    else:
        r = cs.graph_vs_eager(ops, dev, hp)
        if not r["bitwise"]:
            r["deterministic"] = cs.graph_vs_eager(ops, dev, hp,
                                                   deterministic=True)
            cs.check(r["deterministic"]["bitwise"], "eager runs differ on "
                     "cuDNN's deterministic algorithms")
    res = {"passed": True, "limit": r["control"], "graph": r["graph"],
           "deterministic_ran": "deterministic" in r}
except cs.SmokeFailure as e:
    res = {"passed": False, "error": str(e)}
print(json.dumps({"tree": root, **res}))
"""
GRAPH_CHECK_RUNS = 5     # ``graph_check``: runs of each tree


def ab_graph_check(other: str, runs: int = GRAPH_CHECK_RUNS) -> list[dict]:
    """The A/B case ``graph_check``: phase 15(a)'s f32 check alone,
    ``runs`` times in the tree ``other`` (A) and in this one (B), in the
    order A B B A A B ..., each run a process of its own on the same
    card; each run's pass or failure and the passes of each tree. A
    failed check is a result here, not a failure of the command."""
    order = [(other, HERE, HERE, other)[i % 4] for i in range(2 * runs)]
    out = []
    for i, root in enumerate(order):
        proc = subprocess.run(
            [sys.executable, "-c", _AB_GRAPH_CHILD, os.path.abspath(root)],
            capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"graph_check run of {root} failed:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[A/B graph_check] run {i + 1}, {root}: "
              + (f"passed; limit {r['limit']}, graph {r['graph']}, "
                 f"deterministic rerun {r['deterministic_ran']}"
                 if r["passed"] else f"FAILED: {r['error']}"), flush=True)
        out.append(r)
    for root in (other, HERE):
        got = [r["passed"] for r in out if r["tree"] == os.path.abspath(root)]
        print(f"[A/B graph_check] {root}: passed {sum(got)} of {len(got)}")
    return out


def ab(other: str, case: str = "k1_fwd", pairs: str = "2") -> list[dict]:
    """The A/B case ``case`` (``AB_CASES``, several joined by commas, or
    a step case of ``AB_STEP_CONFIGS``: ``ab_step``) run on the tree ``other`` (A) and on this one
    (B) in the order A B B A, repeated to ``pairs`` pairs (even), each run
    a process of its own on the same card, by device time and by events,
    each call held to its twin at 2e-2 of max. Prints, for each shape,
    both trees' mean device ms, B's change and in how many pairs B was the
    slower. Returns each run's numbers."""
    if case in AB_STEP_CONFIGS:
        return ab_step(other, AB_STEP_CONFIGS[case])
    if case == "graph_check":
        return ab_graph_check(other)
    unknown = [c for c in case.split(",") if c not in AB_CASES]
    check(not unknown, f"no A/B case {unknown}; cases: "
          f"{sorted(AB_CASES)} and {sorted(AB_STEP_CONFIGS)}")
    n_pairs = int(pairs)
    check(n_pairs >= 2 and n_pairs % 2 == 0, f"pairs {pairs}: an even "
          "number, at least 2")
    runs = []
    for root in (other, HERE, HERE, other) * (n_pairs // 2):
        proc = subprocess.run(
            [sys.executable, "-c", _AB_CHILD, os.path.abspath(root),
             os.path.abspath(__file__), case], capture_output=True,
            text=True, timeout=900)
        check(proc.returncode == 0, f"A/B run of {root} failed:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        labels = [k for k in r if k not in ("tree", "case")]
        print(f"[A/B] {root}: " + "; ".join(
            f"{k} device {r[k]['device_ms']:.4f} ms, events {r[k]['ms']:.4f} "
            f"ms, err {r[k]['rel_err']:.2e} of max" for k in labels))
        for k in labels:
            for name, ms, cnt in r[k]["by_kernel"]:
                print(f"[A/B]   {k} by kernel: {ms:.4f} ms x{cnt} {name}")
        check(all(r[k]["rel_err"] <= 2e-2 for k in labels),
              f"A/B run of {root} disagrees with the twin")
        runs.append(r)
    for k in labels:
        a_ms = [r[k]["device_ms"] for r in runs[0::4] + runs[3::4]]
        b_ms = [r[k]["device_ms"] for r in runs[1::4] + runs[2::4]]
        # the pairs in run order: (A, B), (B, A), ...
        pair = [(runs[i], runs[i + 1]) if i % 4 == 0 else
                (runs[i + 1], runs[i]) for i in range(0, len(runs), 2)]
        slower = sum(b[k]["device_ms"] > a[k]["device_ms"] for a, b in pair)
        a_mean, b_mean = statistics.mean(a_ms), statistics.mean(b_ms)
        print(f"[A/B summary] {k}: A {a_mean:.4f} device ms ({min(a_ms):.4f}"
              f"-{max(a_ms):.4f}), B {b_mean:.4f} ({min(b_ms):.4f}-"
              f"{max(b_ms):.4f}), B/A {100 * (b_mean / a_mean - 1):+.2f} %; "
              f"B slower in {slower} of {len(runs) // 2} pairs")
    return runs


def invert_plan_ab(pairs: int = 10, what: str = "plans") -> int:
    """``--invert-ab [PAIRS] [plans|loops]``: ``train_lib.invert_check`` at
    batch 2 (exact, Jacobi and fixed-point inverses, D = 8192) on the
    paper config's checkpoint after 2 steps on the synthetic set, A B B A
    to ``pairs`` pairs (even) in one process: with ``plans``, K1's forward
    on ``fwd_plan``'s plan (B: bands) against the whole-image plan (A),
    per plan one sweep's device and events ms first; with ``loops``, the
    blocked loops (B: on the card replayed graphs) against the host loops
    (A, ``_host_inverses``). Each run's seconds and K1 launches, the
    means, the spread of each and in how many pairs B was the slower."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    check(pairs >= 2 and pairs % 2 == 0, f"pairs {pairs}: an even number, "
          "at least 2")
    check(what in ("plans", "loops"), f"--invert-ab compares plans or "
          f"loops, not {what!r}")
    sys.path.insert(0, HERE)
    from iaf_torch import ops, train_lib
    from iaf_torch.core.config import Config
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    device = torch.device("cuda")
    build_phase(ops, device)
    ar_mod = importlib.import_module("iaf_torch.ops.ar_stack")
    logdir = os.path.join(HERE, "build", "chip_smoke_invert_ab")
    shutil.rmtree(logdir, ignore_errors=True)
    cfg = Config().parse(PAPER + ",dataset=synthetic,log_every=1,"
                         "ckpt_every=2,eval_every=0").replace(logdir=logdir)
    train_lib.train(cfg, max_steps=2, device=device)
    picked = ar_mod.fwd_plan

    def whole(dtype, n, h, w, cz, ch, cout, n_convs, sms):
        return ar_mod.whole_plan(n, h, sms)

    if what == "plans":
        names = {"A": "whole-image", "B": "fwd_plan"}
        arms = {"A": lambda: _planned(ar_mod, whole),
                "B": lambda: _planned(ar_mod, picked)}
        model = train_lib._serving_model(cfg, True, device)
        with torch.inference_mode(), _default_tf32():
            _, _, ar_fn, z_prime = train_lib.inversion_inputs(cfg, model, 2)
            z, _, ws, _, _ = capture_inputs(ops, lambda: ar_fn(z_prime),
                                            ("ar_stack",))["ar_stack"]
            shape = (z.dtype, *z.shape, ws[0].shape[-1], ws[-1].shape[-1],
                     len(ws), ar_mod._sms(z.device.index))
            for tag, fn in (("A", whole), ("B", picked)):
                with _planned(ar_mod, fn):
                    print(f"[invert {what}] {tag}: {fn(*shape)}, one sweep "
                          f"{device_ms(lambda: ar_fn(z_prime)):.4f} device "
                          f"ms, {cuda_ms(lambda: ar_fn(z_prime), 50, 3):.4f}"
                          " events ms")
    else:
        names = {"A": "host loops", "B": "graphed blocks"}
        arms = {"A": _host_inverses, "B": contextlib.nullcontext}
    secs = {"A": [], "B": []}
    by_run = []
    order = ("A", "B", "B", "A") * (pairs // 2)
    for tag in order:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with arms[tag](), _default_tf32():
            res = train_lib.invert_check(cfg, batch=2, device=device)
        torch.cuda.synchronize()
        secs[tag].append(time.perf_counter() - t0)
        by_run.append(secs[tag][-1])
        k1 = ops.launch_counts()["ar_stack"]
        print(f"[invert {what}] {tag}: invert_check {secs[tag][-1]:.3f} s, "
              f"K1 {k1} launches, t_exact {res['t_exact']:.3f} s, t_jacobi "
              f"{res['t_jacobi']:.3f} s, t_fixed_point "
              f"{res['t_fixed_point']:.4f} s ({res['iters_fixed_point']} "
              f"sweeps), errors {res['err_exact']:.3e} "
              f"{res['err_jacobi']:.3e} {res['err_fixed_point']:.3e}")
        check(max(res["err_exact"], res["err_jacobi"],
                  res["err_fixed_point"]) < 1e-4, f"round trip {res}")
    pair = [(by_run[i], by_run[i + 1]) if i % 4 == 0 else
            (by_run[i + 1], by_run[i]) for i in range(0, len(order), 2)]
    slower = sum(b > a for a, b in pair)
    a_mean, b_mean = statistics.mean(secs["A"]), statistics.mean(secs["B"])
    print(f"[invert {what}] invert_check seconds: A ({names['A']}) "
          f"{a_mean:.3f} ({min(secs['A']):.3f}-{max(secs['A']):.3f}), B "
          f"({names['B']}) "
          f"{b_mean:.3f} ({min(secs['B']):.3f}-{max(secs['B']):.3f}), B/A "
          f"{100 * (b_mean / a_mean - 1):+.2f} %; B slower in {slower} of "
          f"{len(pair)} pairs")
    print(json.dumps({f"invert_{what}": {"A": secs["A"], "B": secs["B"],
                                         "b_slower_pairs": slower}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


@contextlib.contextmanager
def _planned(ar_mod, plan):
    """Inside the block K1's forward takes ``plan`` (``fwd_plan``'s
    signature)."""
    saved = ar_mod.fwd_plan
    ar_mod.fwd_plan = plan
    try:
        yield
    finally:
        ar_mod.fwd_plan = saved


def multi_only() -> int:
    """``--multi``: the build and phases 17(e) and 19(e) alone, on a
    machine with two or more cards."""
    import torch
    if torch.cuda.device_count() < 2:
        raise SmokeFailure(f"--multi needs two cards; "
                           f"{torch.cuda.device_count()} visible")
    sys.path.insert(0, HERE)
    from iaf_torch import ops
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    device = torch.device("cuda")
    build_phase(ops, device)
    print(json.dumps({"multi": {"e": two_rank_phase(device)}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def memory_only() -> int:
    """``--memory``: the build and phase 19 (``memory_phase``) alone."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from iaf_torch import ops
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    build_phase(ops, device)
    print(json.dumps({"memory": memory_phase(ops, device)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def loops_only() -> int:
    """``--loops``: the build and phase 20 (``loops_phase``) alone."""
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from iaf_torch import ops
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    build_phase(ops, device)
    print(json.dumps({"loops": loops_phase(ops, device)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    """No arguments: the smoke run above. ``--ab DIR [CASE] [PAIRS]``: only
    ``ab`` of CASE (default ``k1_fwd``) against the tree unpacked at DIR
    (for example ``git archive`` of the parent commit under build/).
    ``--invert-ab [PAIRS] [plans|loops]``: ``invert_plan_ab``.
    ``--multi``: ``multi_only``; ``--memory``: ``memory_only``;
    ``--loops``: ``loops_only``."""
    try:
        if sys.argv[1:] == ["--multi"]:
            return multi_only()
        if sys.argv[1:] == ["--memory"]:
            return memory_only()
        if sys.argv[1:] == ["--loops"]:
            return loops_only()
        if sys.argv[1:] == ["--plans"]:
            return plans_only()
        if sys.argv[1:] == ["--k2-plans"]:
            return k2_plans_only()
        if sys.argv[1:] == ["--glue"]:
            return glue_only()
        if len(sys.argv) in (3, 4) and sys.argv[1] == "--invert-ab":
            return invert_plan_ab(int(sys.argv[2]), *sys.argv[3:])
        if sys.argv[1:] == ["--invert-ab"]:
            return invert_plan_ab()
        if len(sys.argv) in (3, 4, 5) and sys.argv[1] == "--ab":
            import torch
            if not torch.cuda.is_available():
                raise SmokeFailure("torch.cuda.is_available() is false")
            print(json.dumps({"ab": ab(*sys.argv[2:])}))
            return 0
        result = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
