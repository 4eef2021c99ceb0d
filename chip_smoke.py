#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing its lines and its seconds; any failed check raises
and the script exits non-zero without printing a result:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes tinyllama-1.1b, mamba2-1.3b and deepseek-moe-16b give it (the
   last: flash forward and backward at 16/16 heads of 128, paged decode
   at 8 slots of 16 kv heads of 128, xent at vocab 102400; mamba2's
   training: xent at its tied head, vocab 50280 padded to 50432, and on
   its 25216-column shard at tp 2; its split prefill: the SSD scan on a
   rank's 32 heads; the compressor's encode on a block of a leaf;
   deepseek served at split×2: flash forward and paged decode on a rank's
   8 q over 8 kv heads of 128; the dense family's rest, phase 33's
   models: flash forward at serving prefill and training, dq and dk/dv at
   training and paged decode at 8 slots, on qwen3-1.7b's 16 q over 8 kv
   heads of 128, gemma-2b's 8 over 1 of 256 and stablelm-3b's 32 over 32
   of 80, the new head dims in bf16 and f32, and xent at their loss
   heads: qwen3's tied vocab 151936 padded to 152064, gemma's tied
   256000, stablelm's 50304 padded to 50432 at hidden width 2560;
   jamba-v0.1-52b, phases 34–35: flash forward, dq and dk/dv at 32 q over
   8 kv heads of 128, xent at its untied head, E = 4096, V = 65536, and on
   its 32768-column shard at tp 2, the SSD scan at 128 heads of 64;
   grok-1-314b, phase 36: flash forward (prefill in bf16 and f32), dq and
   dk/dv at 48 q over 8 kv heads of 128, a group of 6, paged decode at
   group 6 (48/8 and a tp-2 rank's 24/4, bf16 and f32), xent at its
   untied head, E = 6144, V = 131072; the multimodal families, phase 37:
   qwen2-vl-2b's 12 q over 2 kv heads of 128 (flash forward at prefill
   and training, dq, dk/dv, paged decode at 8 slots) and its tied head,
   E = 1536, V = 152064; seamless-m4t-medium's 16 heads of 64 at its
   training step, the encoder (4 x 1024, non-causal), the
   cross-attention (Sq 2047 against Sk 1024) and the decoder (2047,
   causal), forward and backward, and its untied head, E = 1024,
   V = 256256), and at ragged ones
   (tolerance: values f32 2e-5, bf16 2e-2; gradients f32 2e-4, bf16 5e-2;
   the SSD scan 5e-4, as the reference holds its kernel; the int8
   quantize and dequantize bit for bit, a NaN included; the xent
   kernels also on tinyllama's vocab shard at tp 2, labels on both sides
   of it and the backward's ``col0`` past the shard's offset), and time the
   kernel, the plain version and one PyTorch library call computing the
   same function (a yardstick the port never calls; the plain versions
   and library calls of the flash, paged-decode and xent rows on
   PLAIN_REPS and LIBRARY_REPS calls); the flash forward,
   the flash backward's two kernels, the xent forward, paged decode and
   the SSD scan also against a second launch bit for bit, with their
   shares of the bound, ratio to the library call (the flash forward at
   the training step's shape too, paged decode at 8 slots and at one),
   and the ptxas registers and spills of the bf16 (tensor-core) builds,
   which must not spill; then the gradient compressor's fused
   error-feedback encode (``ef_absmax``, ``ef_requant``, ``ef_decode``)
   at tinyllama's largest gradient leaf, each kernel against its plain
   version and the whole ``compressed_psum`` (a world of one over NCCL)
   against ``compressed_psum_plain``, bit for bit (f32, bf16, a NaN),
   timed beside that eager yardstick, with their ptxas registers and
   spills (a spill fails);
4. the serving path: ``repro_torch.launch.serve`` serving tinyllama-1.1b
   at full width with the paged KV cache — 16 requests of 500 prompt
   tokens and 64 generated through 8 slots — with every kernel's launch
   count read around it;
5. the same driver with the dense KV cache, 4 requests;
6. a small model on the card against the same model on the CPU (the plain
   versions), logits within 1e-4;
7. where the time goes in serving: a prefill and a decode step on the host
   clock, then the device's busy share and top kernels under
   ``torch.profiler``;
8. the mamba2 serving path: the same driver serving mamba2-1.3b at full
   width with the dense cache — 8 requests of 500 prompt tokens and 64
   generated through 8 slots, then one of 2000 (bucket 2048, 8 chunks) —
   with every kernel's launch count read around each (the SSD scan once
   per layer and prefill, no other kernel); ``--cache paged`` with this
   arch exits non-zero;
9. a 2-layer f32 mamba2 at the kernel's real tile sizes (head dim 64,
   state 128, chunk 256) on the card against the CPU: prefill logits,
   each layer's state and 8 decode steps' logits within 5e-4;
10. where mamba2's serving time goes, as in 7;
11. the training path: ``repro_torch.launch.train`` training tinyllama-1.1b
    at full width (batch 4 x 2048, AdamW, remat full) for 8 steps, with
    every kernel's launch count read around it: finite, falling loss,
    tokens/s, peak device memory, the final checkpoint's write time;
12. training on the card against the CPU: a 2-layer f32 model's loss, every
    gradient leaf and the parameters after one AdamW step, within 1e-4;
13. resume on the card: 4 steps straight against 2 steps, then a relaunch
    to 4 on the same checkpoint directory; the resumed losses are equal;
14. where the time goes in one training step: forward, backward and
    optimizer on the host clock, then the device's busy share, top kernels
    and the port's kernels' device ms per step under ``torch.profiler``;
15. the compressed data-parallel training path: the same driver with
    ``--mesh 1x1x1 --compress-pod`` (a pod of one, through the process
    group's collectives) at full width for 8 steps, with every kernel's
    launch count read around it (each of the three fused encode kernels
    once per gradient leaf and step, quantize and dequantize never); then
    the same 8 steps with ``--mesh 1x1x1``
    alone (both final checkpoints gathered, not written: phase 11 times
    the full-width write), for the cost of the compression (at 4 steps the driver's
    schedule, warm-up 1 and cosine over 4, lifts step 3's loss above step
    0's with or without compression);
16. where the compression's time goes: ``compressed_psum_tree`` over
    gradients of the full model's leaf shapes, on the host clock, then
    under ``torch.profiler``;
17. compression on the card against the CPU: the CPU's step-0 gradients of
    a 2-layer f32 model through both sides' ``quantize_int8`` and
    ``compressed_psum_tree``, equal bit for bit (q, scale, reduced
    gradient, residual); then 3 compressed driver steps on each side from
    the same checkpoint, the losses within a tolerance derived from the
    int8 values that flip between the two sides' own gradients;
18. the planned training path: the driver with ``--auto --hw h100
    --profile`` at phase 11's configuration for 8 steps (the final
    checkpoint gathered, not written), with every
    kernel's launch count read around it: the strategy the cost model
    chose (it must equal ``auto_parallel`` called on the same graph), the
    predicted step (compute, comm, bubble) against the measured median of
    steps 1-7 and their spread, the calibration fit's rates and the
    prediction error before and after the fit (at least 7 observations,
    a non-empty report), the losses against phase 11's within phase 12's
    limit (1e-4 + 1e-4|x|), and the H100 table's serving predictions (a
    500-token prefill, a decode step at phase 7's 8 slots and live keys)
    beside phase 7's host-clock and device-busy times.  No bound is held
    on the predictions: how far they miss is the finding;
19. the pipeline interpreter (``core/pipeline.py::schedule_grads``, all
    stages in one process) at phase 11's configuration, one batch from the
    driver's stream in 4 micro-batches of 1 x 2048, under 1f1b at stage
    layers (11, 11) and gpipe at (12, 10): each loss and gradient leaf
    against ``planner.accumulate`` over the same micro-batches within bf16's
    limits, the buffer audit ([4, 4] and [2, 1]), the launch counts of
    every kernel around each call, the peak device memory of each, one
    step's time (PP_TIMED calls, after the checked ones) beside
    ``accumulate``'s, and the cost model's price
    of ``pipeline×2(µb=4)`` on the H100 table as a prediction;
20. the multi-rank engine through the plan (``compile_plan`` with
    ``StrategySpec(pp=2, micro_batches=4)``, ``pipeline_train_step_fn``):
    two processes spawned on ``cuda:0`` over a gloo group from a
    ``FileStore`` (NCCL refuses two ranks on one card, so activations
    cross through host memory), one gpipe step and PP_STEPS (2) AdamW
    steps of 1f1b at (11, 11) from the same seed, against the same steps
    of the
    unpipelined ``train_step_fn(micro_batches=4)`` here, losses within
    1e-4 + 1e-4|x|; each rank's launch counts, audit, peak memory under
    both schedules (1f1b's stage 0 no higher than gpipe's) and step times
    (two processes time-slice one card: no throughput); the allocator's
    trace of each schedule's first walk
    (``torch.cuda.memory._record_memory_history``) gives the blocks live
    at the walk's peak, by the port's line that allocated them;
21. heterogeneous placement, the pipeline: ``compile_plan`` over one H100
    beside one V100 (the cost model's tables; both stages run on this
    card) with ``StrategySpec(pp=2, micro_batches=4, schedule="1f1b")``
    and tinyllama's workload at 4 x 2048, overlap 0.5, must balance the
    stage layers to (19, 3) at a priced step of 216.59 ms; phase 20's way
    (two processes over gloo), PP_STEPS AdamW steps on those stages against
    phase 20's unpipelined losses within 1e-4 + 1e-4|x|, with each
    stage's launches, audit, walk and step peaks and step times; then
    phase 27's hardware-aware annotations on the same ranks: two stages
    recorded under ``wh.cluster(mesh, spec=<the same H100 + V100>)`` (on
    the meta device), each node's virtual device naming its stage's
    hardware, and ``compile_nested_plan`` with the same workload and
    overlap placing what ``compile_plan`` placed (stage layers, shares,
    every priced time; the memory term, which the schedule sets, printed
    beside it: the annotations name none, so their plan is gpipe), its
    one step from the same start equal to step 0 of these (loss and clip
    norm, bit for bit: both schedules run each stage's backward slots in
    micro-batch order);
22. heterogeneous placement, uneven data parallelism: the same pair at
    ``dp=2`` over tinyllama at full width and 4 layers (at 22 a replica
    with AdamW does not fit the V100 table), batch 8 x 2048, must balance
    the batch shares to (7, 1); rank 0 trains on 7 rows of each batch and
    rank 1 on 1 (PP_STEPS AdamW steps, the token-weighted mean), against one
    process on all 8 rows (the step-0 loss within 1e-4 + 1e-4|x|, every
    step-0 gradient leaf within bf16's 5e-2) and one summing the same
    shares' gradients with the same weights (every loss within 1e-4 +
    1e-4|x|, the step-0 gradients within 5e-2), both run first and
    freed; each rank's rows, launches, walk and step peaks and step
    times, and a timed gloo all-reduce of the 3.34 GB f32 gradient;
23. tensor parallelism: ``compile_plan(StrategySpec(tp=2))`` on a data 1
    x model 2 mesh, two ranks on ``cuda:0`` over gloo (the row-parallel
    sums of activations cross through host memory), tinyllama at full
    width and 4 layers, batch 2 x 2048, remat full, 2 AdamW steps at a
    constant 3e-4, against one process running the unsharded step on the
    same batches from the same seed (run first and freed): the step-0
    loss within bf16's 2e-2 + 2e-2|x|, each step-0 gradient leaf within
    5e-2 of the leaf's max, the losses of steps 1-2 within 2e-2 (AdamW's
    first steps amplify bf16's rounding: the same unsharded steps a row
    at a time are printed beside them as the yardstick); then the same
    at 2 layers in f32, every loss within 1e-4 + 1e-4|x| and each step-0
    gradient leaf within 2e-4 of the leaf's max; each rank's launches
    (the flash kernels on its 16 heads, the xent kernels on its 16000
    vocab columns), step peaks, step and gloo seconds, and the cost
    model's price of split×2 on the H100 table;
24. Whale's Case-2 hybrid ``replica×2{split×2}`` with ZeRO 0, 1 and 3 on
    four ranks on ``cuda:0`` over gloo, tinyllama at full width and 1
    layer (ZeRO-3's per-repeat gathers cross host memory), batch 2 x
    1024 (one row a replica), 2 steps each: zero=1 equal to zero=0 bit
    for bit (losses, and its state gathered into the checkpoint's layout
    in memory against zero=0's gathered checkpoint tree: only zero=0's
    and zero=3's are written), zero=3 within 1e-4 + 1e-4|x| in losses
    and parameters, zero=0's and zero=3's checkpoints restored into their
    ranks' blocks and zero=0's into zero=1's, bit for bit;
    each rank's peaks beside the state it holds, step and gloo seconds
    and launches; then phase 27's Case 2 on the same ranks: the hybrid
    recorded as annotations (``replica{split}``, on the meta device),
    ``compile_nested_plan`` deriving ``StrategySpec(dp=2, tp=2)``, its 2
    steps equal to zero=0's bit for bit; then phase 36 (d): Adafactor in
    f32 at ZeRO 0, 1 and 3, 2 steps each, ZeRO-1's and ZeRO-3's losses
    within 2e-5 + 2e-5|x| of ZeRO-0's and their gathered state
    (parameters, factored moments) within 2e-4 of each leaf's max, ZeRO-0's
    checkpoint restored into both levels' blocks and gathered back bit for
    bit;
25. Whale's nested hybrid, the plan ``--auto --hw v100`` picks for
    tinyllama at 4 x 2048 on four devices (``auto_parallel`` on the
    paper's V100 table must pick it; its price there and on the H100
    table printed as predictions): ``compile_plan(StrategySpec(tp=2,
    pp=2, micro_batches=4))`` on stage 2 x model 2, four ranks on
    ``cuda:0`` over gloo, full width and 4 layers (cut from 22 to hold
    the script's time: the plan is picked for the full model), remat full, AdamW at a
    constant 3e-4; one 1f1b step, then 2 steps of the planned gpipe, held
    against the unpipelined, unsharded losses (step 0 within 2e-2 +
    2e-2|x|, step 1 within 2e-2) and every step-0 gradient leaf against
    the unpipelined, unsharded gradient within 5e-2 of the leaf's max; then
    the same (2 steps) at 2 layers in f32, stage layers (1, 1), losses
    within 1e-4 + 1e-4|x| and gradients within 2e-4, its checkpoint
    gathered in the
    reference's padded layout and restored into every rank's blocks bit
    for bit; each rank's launches, audit, peaks of the walk and the step
    beside the state it holds, step and gloo seconds, and 1f1b's stage-0
    walk peak beside gpipe's; then phase 27's Case 4 on the same ranks:
    ``pipeline(4){stage{replica{split}}}`` over two stages recorded as
    annotations (on the meta device), its strategy equal to this phase's,
    ``lower()`` printing the p2p bridge at the stage boundary, and one
    gpipe step of ``compile_nested_plan``'s plan from the same weights and
    batch equal to this phase's first gpipe step bit for bit (loss and
    every step-0 gradient block);
26. serving over a mesh, the ranks on ``cuda:0`` over gloo: the serving
    driver's meshed branch (``serve.run`` with ``--mesh``) at split×2 on
    two ranks, full width and 4 layers (TP_SERVE_LAYERS: the depth cut
    from 22 to hold the script's time),
    paged with phase 4's requests, 32 tokens generated of their 64 (run
    1), and dense with 8 requests of 500
    + 16 tokens (run 2, the KV cache's sequence split over the two ranks);
    teacher-forced logits of 2 prefills and 16 decode steps, both caches,
    against one unsharded process (run 3: bf16 at 4 layers, no further
    apart than bf16's own error, the unsharded bf16 logits against the
    same weights' in f32, and a planted fault outside that gate; f32 at 2
    layers within 1e-4 + 1e-4|x|); data 2 x model 2 on four
    ranks at 2 layers with a pool that preempts, and its paged
    teacher-forced bf16 logits against the same gate (run 4);
    f32 at 2 layers, both caches, its tokens equal to the unsharded
    server's (run 5); ``serve --mesh 1x1`` through ``main`` at full width
    (run 6, a world of one over NCCL); each rank's launches (the flash
    forward on its 16 q heads over 2 kv heads, paged decode on its 2 kv
    heads), TTFT and TPOT on the host clock with their gloo seconds, the
    peak beside the weights and KV held, every rank's tokens equal, the
    tokens against the unsharded ones as a count;
27. Whale's annotations (``import repro_torch as wh``), Cases 1 and 2's
    head in this process (its meshed parts ran in phases 21, 24 and 25):
    tinyllama at full width and depth, its forward recorded under
    ``wh.cluster(mesh_shape=(1,))`` (a world of one over NCCL) with the
    embedding and each block under ``wh.replica()`` and the loss head
    under ``wh.split(dim=-1)``, run on the card while recording: 24
    nodes, ``cluster_repeats`` folding the 22 blocks into one group;
    ``graph_from_taskgraph``'s forward FLOPs beside ``model_graph``'s; a
    ``capture_meta`` of one block leaving ``torch.cuda.memory_allocated``
    and every launch count as they were; then 3 AdamW steps of
    ``compile_plan_from_cluster``'s plan equal, bit for bit (losses and
    every parameter), to 3 steps of ``compile_plan`` with the same
    strategy written out, on the same seed and batches, with the flash
    and xent launches;
28. the MoE family, deepseek-moe-16b (64 routed experts top-6, 2 shared):
    (a) the serving driver at full width and all 28 layers in bf16
    (``--overrides param_dtype=bfloat16``), paged (the path) and dense, 8
    requests of 256 + 32 tokens through 8 slots, with launches (flash
    forward 28 an admission, paged decode 28 a step), the peak beside
    the weights and KV and the decode step's median against its floor
    (31.0 GB of expert weights at 3.35 TB/s); teacher-forced logits
    (phase 26's) at 7 of the 28 layers paged through the
    kernels, dense, and paged through the plain versions on the card,
    each within TF_PAIR times bf16's own error (the same weights in f32
    through the f32 kernels);
    (b) the training driver at full width and 2 layers, batch 4 x 2048,
    AdamW, 3 steps: finite losses, ``moe_lb`` and ``moe_z``, launches,
    the peak beside AdamW's state (the final checkpoint gathered, its file
    write skipped), and step 0's loss and gradients through the kernels
    against the plain versions on the card (bf16's limits; the routed
    experts' within twice the larger of that and the same step a row at a
    time); (c) on two
    ranks over gloo, ``StrategySpec(tp=2, ep=2)`` (32 whole experts a
    rank) at full width and 1 layer in f32 (1e-4 + 1e-4|x|, gradients
    2e-4; the split's bf16 path runs in phase 32), against
    the unsharded steps, the routing assignments that differ counted, and
    the M6 nesting ``replica{split[experts]}`` recorded as annotations
    and lowered by ``compile_nested_plan``; (d) ``moe_block_ep`` on the
    two ranks at deepseek's block shape in f32 against ``moe_block``;
29. the compressed cross-pod reduction on blocks of leaves, four ranks on
    ``cuda:0`` over gloo, tinyllama at full width and 1 layer: at pod 2
    x data 2 (batch 4 x 1024, a row a rank) compressed ZeRO 0, 1 and 3
    for 2 steps each, ZeRO-1 and ZeRO-3 equal to ZeRO-0 bit for bit
    (losses, the handed step-0 gradients, the gathered parameters,
    moments and error carry), the three encode kernels once per leaf and
    step; at pod 2 x model 2 (batch 2 x 1024) one step, its handed
    gradient and error carry, gathered whole, against the same pods'
    whole in-pod leaves through ``compressed_psum_plain`` within one
    rounding, plus one quantum where an int8 value flips (on at most 1%
    of a leaf), and the same step with each block quantized against its
    own scale (the old per-shard scale, planted) outside that gate;
30. mamba2-1.3b training at full width and depth (48 layers, batch 4 x
    2048, remat full, AdamW, 2 steps; the SSD mixer through the
    differentiable chunked scan, as the reference trains it, the tied
    head through the xent kernels): losses, launches, tokens/s after step
    0, the peak beside the state; one step split into forward, backward
    and AdamW, its device busy time under torch.profiler and the share of
    it one layer's ``ssd_scan`` (two forwards and a backward) takes times
    48; step 0's loss and every gradient leaf through the kernels against
    the plain versions on the card (f32 at 2 layers within 1e-4 +
    1e-4|x|; bf16 at the first 8 of the 48 layers, within TF_PAIR
    times bf16's own error, leaf by leaf);
31. mamba2 over ``model`` (the SSD mixer's heads split; ``B``/``C``
    whole; the gated norm's sum of squares all-reduced), two ranks on
    ``cuda:0`` over gloo: split×2 training at 2 layers in f32, the loss
    and every step-0 gradient leaf against the unsharded step within
    1e-4 + 1e-4|x|; ``serve --mesh 1x2`` at full width, 8 layers in bf16
    and 2 in f32 (4 requests of 500 + 16; the SSD scan once per layer,
    prefill and rank; f32 tokens equal to the unsharded driver's); the
    teacher-forced logits and prefill states at full depth against one
    unsharded process, f32 within 1e-4 + 1e-4|x|, bf16 within TF_PAIR
    times bf16's own error, and a planted fault (the gated norm without
    its all-reduce) outside that gate;
32. the MoE family across the engine, deepseek-moe-16b at full width,
    ranks on ``cuda:0`` over gloo: (a) pipeline×2 on two ranks at 2
    layers, one a stage, batch 4 x 2048 in 4 micro-batches, 1f1b, 2
    AdamW steps in bf16 and one in f32, against the unpipelined,
    unsharded
    step of one process (bf16 within TF_PAIR times bf16's own error, the
    gap between that step in bf16 and in f32; f32 losses within 1e-4 +
    1e-4|x| and gradients within 2e-4 of each leaf's max), ``moe_lb`` and
    ``moe_z`` beside the unpipelined step's, each rank's peak, step and
    gloo seconds; (b) the same over model 2 on four ranks
    (``pipeline{split[experts]}``: 32 experts a rank), one step in bf16
    and one in f32; (c) data 2 in f32
    at 2 layers, a row a rank, the experts balanced over the global batch,
    against one process on both rows (1e-4 + 1e-4|x|, gradients 2e-4),
    and the old per-replica balance planted, which must miss that gate;
    (d) ``serve --mesh 1x2`` (32 experts, 8 q over 8 kv heads and 51200
    vocab columns a rank) at 2 layers in bf16, 8 slots, paged, and in f32
    at 2 layers (tokens equal to one unsharded process's), and ``--mesh
    2x2`` at 2 layers in bf16; teacher-forced logits against one unsharded
    process (bf16 within TF_PAIR times bf16's own error, f32 within 1e-4
    + 1e-4|x|), and a planted fault, the moe combine without its
    all-reduce over ``model``, outside the f32 gate; each rank's TTFT and
    TPOT with their gloo seconds and its peak beside the weights and KV
    it holds;
33. the dense family's rest, each at full width and depth: qwen3-1.7b
    (per-head qk-norm, tied head), gemma-2b (GeGLU, MQA, head dim 256,
    tied 256k head) and stablelm-3b (LayerNorm, head dim 80): (a) the
    serving driver in bf16, paged and dense, 8 requests of 256 + 16
    tokens through 8 slots: TTFT, TPOT, tokens/s, the peak beside the
    weights and KV, the flash and paged-decode launches; (b) the
    training driver, batch 4 x 2048, remat full, AdamW, 2 steps: finite
    losses, launches, tokens/s, forward, backward and AdamW on the host
    clock, the peak beside the parameters, gradients and moments (the
    final checkpoint neither copied to the host nor written), then the
    first step through the plain versions, its loss
    within 5% of theirs; (c)
    through the kernels against the plain versions on the card:
    teacher-forced logits at full depth in bf16 within TF_PAIR times
    bf16's own error and at 2 layers in f32 within 1e-4 + 1e-4|x|, and
    step 0's loss and every gradient leaf at 2 layers in f32 within 2e-4
    + 2e-4|x|;
34. the hybrid family on one card, jamba-v0.1-52b at full width (32 q
    over 8 kv heads of 128; SSD mixers of 128 heads of 64, state 128; 16
    experts of 14336 columns, top-2, on the odd blocks; a dense SwiGLU
    MLP on the even; vocab 65536): (a) the serving driver in bf16 at one
    period (8 layers: 1 attention, 7 SSD; all 32 take 103 GB), dense, 8
    requests of 256 + 16 tokens through 8 slots: TTFT, TPOT, tokens/s,
    the peak beside the weights, KV and SSD states, the flash and SSD
    scan launches (paged decode 0); (b) the training driver at the 2-layer
    pattern (``attn_period=2``: an SSD + dense block, then an attention +
    experts block), batch 4 x 2048, remat full, Adafactor (the
    reference's recipe for jamba), 3 steps: finite losses, ``moe_lb``,
    ``moe_z``, launches, tokens/s, forward, backward and Adafactor on the
    host clock, the peak beside the parameters, gradients and Adafactor's
    state, then one step through ``--auto`` (the planner's pick on one
    card, its step-0 loss that of the run without it); (c) through the
    kernels against the plain versions on the card: teacher-forced
    logits in bf16 at one period and at the 2-layer pattern, printed
    beside bf16's own error (not held: at random weights twice it allows
    more than a typical logit), at the 2-layer pattern in f32 within 1e-4
    + 1e-4|x|, step 0's loss, ``moe_lb``, ``moe_z`` and every gradient
    leaf there in f32 within 2e-4 + 2e-4|x|, and the routing choices that
    flip;
35. the ssm and hybrid families across the engine, two ranks on
    ``cuda:0`` over gloo: (a) mamba2-1.3b
    pipeline×2 at full width and 4 layers, 4 x 2048 in 4 micro-batches,
    1f1b, 2 AdamW steps in bf16 and one in f32, against
    the unpipelined
    step of one process (phase 32 (a)'s gates; the tied table's gradient
    summed over both stages); (b) jamba pipeline×2 at 4 layers of the
    2-layer pattern (a period a stage), f32, step 0 in 2 micro-batches of
    1 x 1024, and (c) jamba split×2 (tp 2 = ep 2: 16 q over 4 kv heads, 64
    SSD heads, 8 experts and 32768 vocab columns a rank) at the 2-layer
    pattern, f32, 2 x 1024, each against one process's step: loss,
    ``moe_lb`` and ``moe_z`` within 1e-4 + 1e-4|x|, each gradient leaf
    within 2e-4 of its max (every expert of an expert leaf on the first
    1/JB_EXPERT_ROWS of its rows), routing flips counted; each rank's
    peak, step and gloo seconds;
36. grok-1-314b (8 experts of 32768 columns, top-2, no shared; 48 q over
    8 kv heads of 128, a group of 6; GeGLU; untied vocab 131072): (a) the
    serving driver at full width and 4 layers in bf16 (21.29e9
    parameters, 39.66 GiB; all 64 layers take 628 GB), paged (the kernel
    at group 6) and dense, 8 requests of 256 + 16 through 8 slots: TTFT,
    TPOT against the decode step's floor (every weight but the table read
    once at 3.35 TB/s), the peak beside the weights and KV, the
    launches; teacher-forced logits at 1 layer in f32 through the kernels
    against the plain versions within 1e-4 + 1e-4|x|, routing flips
    counted; (b) the training driver at full width and 1 layer, batch 4
    x 2048, remat full, Adafactor (the reference's recipe), 2 steps:
    tokens/s, forward, backward and Adafactor on the host clock, the peak
    beside the f32 parameters and gradients (48.66 GiB) and Adafactor's
    state, the final checkpoint neither copied to the host nor written;
    step 0 at 1 x 2048 in f32 through the kernels against the plain
    versions (loss, ``moe_lb``, ``moe_z`` within 2e-4 + 2e-4|x|, every
    gradient leaf there on the first 1/GK_HELD of the embed dim of a leaf
    of 2^26 elements or more), routing flips counted; (c) the experts'
    d_ff split (grok's expert tensor parallelism) on two ranks over gloo:
    ``StrategySpec(tp=2)`` with 3 experts (a
    2-way axis divides 8; the rules prune ``experts`` and split every
    expert's 32768 columns), 1 layer, f32, 2 x 1024, 2 Adafactor steps,
    against one process: losses within 1e-4 + 1e-4|x|, the step-0
    gradient and the parameters after the last step within 1e-4 + 1e-4
    x each leaf's max (held parts through files a leaf), 0 routing flips;
    (d) Adafactor under ZeRO runs in phase 24's ranks;
37. the multimodal families at full width: (a) qwen2-vl-2b (28 layers,
    12 q over 2 kv heads of 128, M-RoPE, a tied 151936 vocab) served by
    the serving driver in bf16, paged and dense, 8 requests of 256 + 32
    (TTFT, TPOT, the peak beside weights and KV; flash forward 28 an
    admission, paged decode 28 a step); (b) trained by the training
    driver at full depth, 4 x 2048 with 64 patch embeddings a row, remat
    full, AdamW, 3 steps (tokens/s, forward, backward, AdamW, the peak
    beside the state; flash forward, dq, dk/dv and the xent kernels);
    (c) seamless-m4t-medium (12 + 12 layers, 16 heads of 64, LayerNorm,
    relu, an untied 256206 vocab) served through ``Model.prefill`` from
    8 rows of 1024 frames, then 31 greedy ``serve_step``s in bf16 (TTFT,
    TPOT; flash forward once per encoder layer and prefill), and trained
    at 4 x 2048 targets over 1024 frames (the cross-attention at Sq 2047,
    Sk 1024), AdamW, 3 steps (36 attentions a pass); (d) both at 2
    layers (seamless 2 + 2) in f32 through the kernels against the plain
    versions: teacher-forced logits, step 0's loss and every gradient
    leaf at 4 x 2048 within 1e-4 + 1e-4|x|, and the bf16 teacher-forced
    pair printed beside bf16's own error; (e) seamless's two-tower
    pipeline×2 on two ranks over gloo (the encoder on stage 0, the
    decoder and the loss on stage 1), 2 + 2 layers, f32, 2 x 1024 targets
    over 512 frames in 2 micro-batches: step 0's loss and every gradient
    leaf against one process, each rank's launches, peak, step and gloo
    seconds;
38. Whale's elastic runtime: ``repro_torch.launch.train --hosts`` at
    tinyllama's full width on pooled ranks over gloo, 2 x 1024 a step,
    each plan on a generation of the process group of its own: (a) a
    straggler evicted with a crash retry (2 layers f32, 2 hosts of 1
    rank, 12 steps); (b) a spot reclaim drained and the capacity regrown
    (1 layer bf16, 2 hosts and a spare rank: 2 → 1 → 2 ranks); (c) a
    missed deadline, the lost steps replayed from the last committed
    checkpoint; (d) a drift-triggered recalibration.  Each against the
    reference's events replayed over the injector's clock, every
    restore bit for bit, the stream byte for byte against a fresh
    ``TokenPipeline``, (a)'s final loss within 1e-4 + 1e-4|x| and (b)'s
    losses within twice bf16's own error of one process's; printed: each
    change's downtime (the group re-formed; the search, compile and
    restore) and the drain before it, checkpoint bytes and write
    seconds, tokens/s of each plan, peaks a rank, launches on each path.

The meshed phases 20–38 run their ranks in one pool of four processes on
``cuda:0`` (:class:`RankPool`), started before the kernels build (its
ranks reach the card and import what their tasks need while nvcc runs)
and stopped after phase 38: each phase hands its rank function to the
first two, three or four.

then the kernel table as one JSON line, the card line again, and the last
line ``{"ok": true, "device": {...}}``.  Needs no network; needs ``nvcc``
(``CUDA_HOME`` or ``/usr/local/cuda``).

``python3 chip_smoke.py --against DIR`` (DIR a checkout of another commit,
e.g. unpacked with ``git archive``) builds DIR's kernels beside this
tree's and runs only phase 3's paged-decode, SSD and quantize checks,
timing each call with both libraries in the order DIR, this, this, DIR,
then DIR's
``compressed_psum_tree`` (its ``optim/grad_compress.py`` over its
kernels) beside this tree's over tinyllama's gradient leaves, equal bit
for bit, in the same order; it drives no main path and prints no result
line.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12             # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.bfloat16": 2e-2, "torch.float32": 2e-5}
GRAD_TOL = {"torch.bfloat16": 5e-2, "torch.float32": 2e-4}
ARCH = "tinyllama-1.1b"
PAGED_ARGS = ["--arch", ARCH, "--cache", "paged", "--requests", "16",
              "--batch-slots", "8", "--prompt-len", "500", "--gen", "64",
              "--max-len", "1024", "--page-size", "64"]
DENSE_ARGS = ["--arch", ARCH, "--cache", "dense", "--requests", "4",
              "--batch-slots", "4", "--prompt-len", "500", "--gen", "32",
              "--max-len", "1024"]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
TRAIN_ARGS = ["--arch", ARCH, "--batch", str(TRAIN_BATCH), "--seq",
              str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--optimizer",
              "adamw", "--log-every", "1"]
SMALL = "n_heads=8,n_kv_heads=2,head_dim=64"     # the 2-layer f32 model
COMP_STEPS = 8                    # the compressed training path's steps
COMP_ARGS = ["--arch", ARCH, "--batch", str(TRAIN_BATCH), "--seq",
             str(TRAIN_SEQ), "--steps", str(COMP_STEPS), "--optimizer",
             "adamw", "--log-every", "1", "--mesh", "1x1x1"]
LEAF = 22 * 2048 * 5632           # tinyllama's largest gradient leaf (wi, wg)
MAMBA = "mamba2-1.3b"
MAMBA_ARGS = ["--arch", MAMBA, "--cache", "dense", "--requests", "8",
              "--batch-slots", "8", "--prompt-len", "500", "--gen", "64",
              "--max-len", "1024"]
MAMBA_LONG_ARGS = ["--arch", MAMBA, "--cache", "dense", "--requests", "1",
                   "--batch-slots", "1", "--prompt-len", "2000", "--gen", "16",
                   "--max-len", "4096"]
SSD_TOL = 5e-4            # the reference's tolerance for its SSD kernel
DEEPSEEK_VOCAB = 102400   # deepseek-moe-16b's vocab (the xent rows)
MAMBA_VOCAB, MAMBA_VP = 50280, 50432   # mamba2-1.3b's vocab, padded
#: a block the compressor runs on (phase 29): the table's data shard under
#: ZeRO-3 at data 2, 32000 x 2048 / 2
EF_BLOCK = 32000 * 2048 // 2
AGAINST = None            # --against: the kernel library of another checkout
AGAINST_DIR = None        # --against: that checkout
EF_KERNELS = (r"ef_(?:absmax|requant|decode)_kernelI(?:f|13__nv_bfloat16)"
              r"Li\d+E|ef_absmax_final_kernel")
CSRC = "src/repro_torch/kernels/csrc"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of one call, L2 flushed before each launch (the
    serving path finds its per-layer KV and weights cold).  After the
    flush the device spins ~0.1 ms (``torch.cuda._sleep``) so that the
    start event, the call's launches and the end event are all enqueued
    while it is still busy: the host's time to enqueue a small call does
    not count as the call's device time."""

    SPIN_CYCLES = 200_000

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int | None = None) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps or self.reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


#: phase 3's readings of a plain version and of its library yardstick: the
#: median of fewer calls than a kernel's (the plain attention and loss
#: heads materialise their scores and logits: the slowest calls of the
#: phase)
PLAIN_REPS = LIBRARY_REPS = 3


def timed(timer, fn) -> tuple:
    """fn's device time in ms with this tree's kernels and, under
    ``--against``, with the other checkout's, timed in the order other,
    this, this, other; returns (ms, other ms or None), each the mean of
    its two readings."""
    if AGAINST is None:
        return timer(fn), None
    from repro_torch.kernels import build
    with build.using(AGAINST):
        first = timer(fn)
    mine = timer(fn) + timer(fn)
    with build.using(AGAINST):
        last = timer(fn)
    return mine / 2, (first + last) / 2


def against_line(fn, want, tag: str, dtype, other_ms, tol=None) -> str:
    """Under ``--against``: the other checkout's output of fn held against
    want (a tuple of tensors), and its time for the kernel line."""
    if AGAINST is None:
        return ""
    from repro_torch.kernels import build
    with build.using(AGAINST):
        got = fn()
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        check_close(tag + " (--against)", g, w, dtype, tol)
    return f"  --against {other_ms:.4f} ms"


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got, want, dtype, tol=None) -> float:
    """|got - want| <= tol + tol·|want| everywhere (the reference's
    allclose policy, tests/kernel_harness.py); returns max |got - want|."""
    tol = TOL[str(dtype)] if tol is None else tol
    diff = (got.float() - want.float()).abs()
    bad = ~(diff <= tol + tol * want.float().abs())      # NaN counts as bad
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"{tol:g}; max |err| {float(diff.max()):.3e}")
    return float(diff.max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

#: the heads (q, kv, dim) of each model's kernel rows beside the main
#: path's (tinyllama's 32/4 of 64), as the kernels line nests them
HEAD_ROWS = {(16, 16, 128): "deepseek", (16, 8, 128): "qwen3",
             (8, 1, 256): "gemma", (32, 32, 80): "stablelm",
             (32, 8, 128): "jamba", (48, 8, 128): "grok",
             (12, 2, 128): "qwen2vl"}
#: seamless-m4t-medium's attention shapes (phase 37: 16/16 heads of 64 at
#: its training step, 4 x 2048 target tokens over 1024 source frames), as
#: the kernels line nests them: (B, Sq, Sk, causal) → name
ENCDEC_ROWS = {(4, 1024, 1024, False): "seamless_encoder",
               (4, 2047, 1024, False): "seamless_cross",
               (4, 2047, 2047, True): "seamless_decoder"}


def check_flash(torch, timer) -> dict:
    """The flash forward kernel against its plain version (o and lse) and
    against a second launch bit for bit: serving's prefill heads at B=1
    and S up to 1024, a cross shape, a rank's 16/2 heads of the prefill at
    split×2 (phase 26), the training step's shape (B=4, S=2048, 32/4
    heads, D=64, causal, bf16), and deepseek-moe-16b's (16/16 heads, D=128:
    its prefill at B=1, S=512 and its training step at B=4, S=2048; a
    rank's 8/8 heads of its prefill at split×2, phase 32), and the dense
    family's rest (phase 33): qwen3-1.7b's 16/8 heads of 128, gemma-2b's
    8/1 of 256 and stablelm-3b's 32/32 of 80, jamba-v0.1-52b's 32/8 of
    128 (phase 34) and grok-1-314b's 48/8 of 128 (phase 36: a group of 6,
    so a 64-row tile splits one query's heads), each at its serving
    prefill (B=1, S=256; f32 too at the new dims and at grok's) and its
    training step (B=4, S=2048), qwen2-vl-2b's 12/2 of 128 the same
    (phase 37) and seamless-m4t-medium's 16/16 of 64 at its training
    step (:data:`ENCDEC_ROWS`), each timed beside SDPA in this call (a
    plain version's and the library's medians of PLAIN_REPS and
    LIBRARY_REPS calls).  Prints the bf16
    (tensor-core) builds' ptxas registers and spills and fails on a
    spill.  Returns the row of the training shape, with the other models'
    training shapes' under their names (:data:`HEAD_ROWS`,
    :data:`ENCDEC_ROWS`)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash

    print_ptxas("flash_fwd_mma_kernel")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(1, 256, 256, True, (bf16, f32), 32, 4, 64),
             (1, 512, 512, True, (bf16, f32), 32, 4, 64),
             (1, 1024, 1024, True, (bf16, f32), 32, 4, 64),
             (1, 384, 1000, False, (bf16, f32), 32, 4, 64),
             (1, 512, 512, True, (bf16, f32), 16, 2, 64),
             (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, True, (bf16,), 32, 4, 64),
             (1, 512, 512, True, (bf16,), 16, 16, 128),
             (1, 512, 512, True, (bf16, f32), 8, 8, 128),
             (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, True, (bf16,), 16, 16, 128)]
    for H, K, D in ((16, 8, 128), (8, 1, 256), (32, 32, 80), (32, 8, 128),
                    (48, 8, 128), (12, 2, 128)):
        cases += [(1, 256, 256, True, (bf16,) if (H, D) in (
                       (16, 128), (32, 128)) else (bf16, f32), H, K, D),
                  (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, True, (bf16,), H, K, D)]
    cases += [(B, Sq, Sk, causal, (bf16,), 16, 16, 64)
              for B, Sq, Sk, causal in ENCDEC_ROWS]
    row = None
    for B, Sq, Sk, causal, dtypes, H, K, D in cases:
        for dtype in dtypes:
            q = torch.randn((B, Sq, H, D), generator=gen, device="cuda"
                            ).to(dtype)
            k = torch.randn((B, Sk, K, D), generator=gen, device="cuda"
                            ).to(dtype)
            v = torch.randn((B, Sk, K, D), generator=gen, device="cuda"
                            ).to(dtype)
            o, lse = flash.flash_attention(q, k, v, causal)
            again = flash.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            o_ref, lse_ref = flash.flash_attention_plain(q, k, v, causal)
            tag = (f"flash_fwd B={B} Sq={Sq} Sk={Sk} causal={causal} "
                   f"heads {H}/{K} D={D} {dtype}")
            err = max(check_close(tag + " o", o, o_ref, dtype),
                      check_close(tag + " lse", lse, lse_ref, dtype))
            assert_same_bits(tag, (o, lse), again)
            del o_ref, lse_ref, again
            ms = timer(lambda: flash.flash_attention(q, k, v, causal))
            plain_ms = timer(lambda: flash.flash_attention_plain(q, k, v,
                                                                 causal),
                             PLAIN_REPS)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), LIBRARY_REPS)
            flops = 4 * B * causal_pairs(Sq, Sk, causal) * H * D
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size() + lse.numel() * 4
            b_ms, b_by = bound(nbytes, flops, dtype)
            print(f"[kernel] {tag}: max_abs_err {err:.3e} (tol "
                  f"{TOL[str(dtype)]:g}); a second launch equal bit for bit"
                  f"  kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                  f"share of the bound {b_ms / ms:.3f})  plain "
                  f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms (kernel / sdpa "
                  f"{ms / lib_ms:.2f})  bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
            r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            if (B, Sq, Sk, causal) in ENCDEC_ROWS and H == 16:
                row[ENCDEC_ROWS[B, Sq, Sk, causal]] = r
            elif (B, Sq, causal, dtype) == (TRAIN_BATCH, TRAIN_SEQ, True,
                                            bf16):
                if D == 64:
                    row = r
                else:
                    row[HEAD_ROWS[H, K, D]] = r
            del q, k, v, o, lse, qt, kt, vt
            torch.cuda.empty_cache()
    return row


def check_paged(torch, timer) -> dict:
    """The paged-decode kernel against its plain version and a second
    launch bit for bit, timed beside SDPA over the same KV gathered dense
    beforehand, in this call: the serving shape (8 slots of ~500-1000
    keys, one inactive, 32/4 heads, D=64, page 64), a rank's 16/2 heads of
    it at split×2 and of 4 slots at data 2 x model 2 (phase 26), and one
    slot of 1000 keys (B=1), and deepseek-moe-16b's decode (8 slots, 16/16
    heads, D=128), a rank's 8/8 heads of it at split×2 and of 4 slots at
    data 2 x model 2 (phase 32), and 8 slots of the dense family's rest
    (phase 33): qwen3's 16/8 heads of 128, gemma's 8/1 of 256, stablelm's
    32/32 of 80; and grok-1-314b's group of 6 (phase 36): 8 slots of its
    48/8 heads of 128 and of a tp-2 rank's 24/4; and qwen2-vl-2b's 12/2
    of 128, a group of 6 (phase 37).  Prints the bf16
    (tensor-core) builds' ptxas registers
    and spills and fails on a spill.  Returns the row of the serving shape
    in bf16, with the other models' 8 slots under their names
    (:data:`HEAD_ROWS`)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import paged

    print_ptxas("paged_decode_mma_kernel")
    rng = np.random.default_rng(0)
    ps, mp = 64, 16
    pos8 = rng.integers(500, mp * ps, 8)
    pos8[3] = 0                                    # the inactive slot
    gen = torch.Generator(device="cuda").manual_seed(1)
    row = None
    for pos, H, K, D in ((pos8, 32, 4, 64), (pos8, 16, 2, 64),
                         (pos8[:4], 16, 2, 64), (np.array([999]), 32, 4, 64),
                         (pos8, 16, 16, 128), (pos8, 8, 8, 128),
                         (pos8[:4], 8, 8, 128), (pos8, 16, 8, 128),
                         (pos8, 8, 1, 256), (pos8, 32, 32, 80),
                         (pos8, 48, 8, 128), (pos8, 24, 4, 128),
                         (pos8, 12, 2, 128)):
        B = len(pos)
        P = 1 + B * mp
        table = np.zeros((B, mp), np.int32)
        perm = rng.permutation(np.arange(1, P)).tolist()
        for b in range(B):
            if pos[b] > 0:
                n = int(pos[b]) // ps + 1
                table[b, :n] = [perm.pop() for _ in range(n)]
        bt = torch.tensor(table, device="cuda")
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, H, D), generator=gen, device="cuda"
                            ).to(dtype)
            kp = torch.randn((P, ps, K, D), generator=gen, device="cuda"
                             ).to(dtype)
            vp = torch.randn((P, ps, K, D), generator=gen, device="cuda"
                             ).to(dtype)
            kp[0] = 0
            vp[0] = 0
            out = paged.paged_decode(q, kp, vp, bt, pos_t)
            again = paged.paged_decode(q, kp, vp, bt, pos_t)
            torch.cuda.synchronize()
            ref = paged.paged_decode_plain(q, kp, vp, bt, pos_t)
            tag = (f"paged_decode B={B} pos={pos.tolist()} heads {H}/{K} "
                   f"D={D} {dtype}")
            err = check_close(tag, out, ref, dtype)
            assert_same_bits(tag, (out,), (again,))
            if not torch.isfinite(out).all():
                raise AssertionError(f"{tag}: output not finite")
            call = lambda: paged.paged_decode(q, kp, vp, bt, pos_t)
            ms, other_ms = timed(timer, call)
            other = against_line(call, (ref,), tag, dtype, other_ms)
            plain_ms = timer(lambda: paged.paged_decode_plain(q, kp, vp, bt,
                                                              pos_t),
                             PLAIN_REPS)
            # yardstick: SDPA over the same KV gathered dense beforehand
            kd = kp[bt.long()].reshape(B, mp * ps, K, D).transpose(
                1, 2).contiguous()
            vd = vp[bt.long()].reshape(B, mp * ps, K, D).transpose(
                1, 2).contiguous()
            mask = (torch.arange(mp * ps, device="cuda")[None, :]
                    <= pos_t[:, None].long())[:, None, None, :]
            qd = q[:, :, None, :]
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=True), LIBRARY_REPS)
            live = int((pos + 1).sum())
            nbytes = (2 * q.numel() + 2 * live * K * D) * q.element_size() \
                + bt.numel() * 4 + B * 4
            flops = 4 * live * H * D
            b_ms, b_by = bound(nbytes, flops, dtype)
            print(f"[kernel] {tag}: max_abs_err {err:.3e} (tol "
                  f"{TOL[str(dtype)]:g}); a second launch equal bit for bit"
                  f"  kernel {ms:.4f} ms{other}  plain {plain_ms:.4f} ms  "
                  f"sdpa(pre-gathered) {lib_ms:.4f} ms (kernel / sdpa "
                  f"{ms / lib_ms:.2f})  bound {b_ms:.4f} ms ({b_by}, share "
                  f"{b_ms / ms:.3f})", flush=True)
            if (B, dtype) == (8, torch.bfloat16) and (
                    (H, K, D) == (32, 4, 64) or (H, K, D) in HEAD_ROWS):
                r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
                if D == 64:
                    row = r
                else:
                    row[HEAD_ROWS[H, K, D]] = r
            del q, kp, vp, kd, vd, out, again, ref
    return row


def causal_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs a top-left-aligned causal mask leaves live."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk


def ptxas_usage(pattern: str) -> dict:
    """{kernel[<ints>]: (registers, spill store bytes, spill load bytes)}
    from the build log's ``ptxas -v`` lines, for the entry functions whose
    mangled name holds ``pattern`` (a regex), with their leading int
    template arguments."""
    import re

    from repro_torch.kernels import build

    log = build.library_path().with_suffix(".log").read_text()
    name_re = re.compile(f"({pattern})" + r"(?:I((?:Li\d+E)+))?")
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = name_re.search(line)
            args = ",".join(re.findall(r"Li(\d+)E", m[2] or "")) if m else ""
            name = (m[1] + (f"<{args}>" if args else "")) if m else None
        elif name and "spill stores" in line:
            spills = tuple(int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif name and "Used" in line and "registers" in line:
            out[name] = (int(re.search(r"Used (\d+) registers", line)[1]),
                         *spills)
            name = None
    return out


def print_ptxas(pattern: str) -> None:
    """Print the registers and spills of the tensor-core builds whose names
    match ``pattern``; fail if one spills or none is found."""
    usage = ptxas_usage(pattern)
    if not usage:
        raise AssertionError(f"no ptxas lines for {pattern} in the build log")
    for name, (regs, stores, loads) in usage.items():
        print(f"[kernel] ptxas {name}: {regs} registers, spill stores "
              f"{stores} B, spill loads {loads} B", flush=True)
        if stores or loads:
            raise AssertionError(f"{name} spills registers")


def assert_same_bits(tag: str, first, second) -> None:
    """Tensors of one launch equal those of a second launch bit for bit."""
    import torch
    for a, b in zip(first, second):
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            raise AssertionError(f"{tag}: a second launch on the same inputs "
                                 f"gives other bits")


def check_flash_bwd(torch, timer) -> tuple:
    """The dq and dk/dv kernels against the plain backward, from the same
    (q, k, v, do, lse, delta), and each against a second launch bit for
    bit; returns the rows of the main path's shape (B=4, S=2048, 32/4
    heads, D=64, causal, bf16), with the other models' training shapes'
    under their names (:data:`HEAD_ROWS`: deepseek-moe-16b's 16/16 heads
    of 128, and the dense family's rest: qwen3's 16/8 of 128, gemma's 8/1
    of 256, stablelm's 32/32 of 80; f32 at the new dims at B=2,
    S=1000; jamba-v0.1-52b's 32/8 of 128; grok-1-314b's 48/8 of 128, a
    group of 6; qwen2-vl-2b's 12/2 of 128), and seamless-m4t-medium's
    16/16 of 64 under :data:`ENCDEC_ROWS`' names."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash

    print_ptxas("flash_bwd_[a-z]+_mma_kernel")
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(4, 2048, 2048, True, torch.bfloat16, 32, 4, 64),
             (4, 2048, 2048, True, torch.float32, 32, 4, 64),
             (2, 1000, 1000, True, torch.bfloat16, 32, 4, 64),
             (2, 1000, 1500, False, torch.bfloat16, 32, 4, 64),
             (2, 1000, 1500, False, torch.float32, 32, 4, 64),
             (4, 2048, 2048, True, torch.bfloat16, 16, 16, 128),
             (4, 2048, 2048, True, torch.bfloat16, 16, 8, 128),
             (4, 2048, 2048, True, torch.bfloat16, 8, 1, 256),
             (2, 1000, 1000, True, torch.float32, 8, 1, 256),
             (4, 2048, 2048, True, torch.bfloat16, 32, 32, 80),
             (2, 1000, 1000, True, torch.float32, 32, 32, 80),
             (4, 2048, 2048, True, torch.bfloat16, 32, 8, 128),
             (4, 2048, 2048, True, torch.bfloat16, 48, 8, 128),
             (4, 2048, 2048, True, torch.bfloat16, 12, 2, 128)]
    cases += [(B, Sq, Sk, causal, torch.bfloat16, 16, 16, 64)
              for B, Sq, Sk, causal in ENCDEC_ROWS]
    rows = None
    for B, Sq, Sk, causal, dtype, H, K, D in cases:
        rnd = lambda S, n: torch.randn((B, S, n, D), generator=gen,
                                       device="cuda").to(dtype)
        q, k, v, do = rnd(Sq, H), rnd(Sk, K), rnd(Sk, K), rnd(Sq, H)
        o, lse = flash.flash_attention(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1).reshape(B, Sq, K, H // K)
        args = (q, k, v, do, lse, delta, causal)
        dq = flash.flash_bwd_dq(*args)
        dk, dv = flash.flash_bwd_dkv(*args)
        again = (flash.flash_bwd_dq(*args), *flash.flash_bwd_dkv(*args))
        torch.cuda.synchronize()
        want = flash.flash_attention_bwd_plain(*args)
        tag = (f"flash_bwd B={B} Sq={Sq} Sk={Sk} causal={causal} heads "
               f"{H}/{K} D={D} {dtype}")
        gt = GRAD_TOL[str(dtype)]
        err = [check_close(f"{tag} {n}", g, w, dtype, gt)
               for n, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)]
        assert_same_bits(tag, (dq, dk, dv), again)
        del again
        ms_dq = timer(lambda: flash.flash_bwd_dq(*args))
        ms_dkv = timer(lambda: flash.flash_bwd_dkv(*args))
        plain_ms = timer(lambda: flash.flash_attention_bwd_plain(*args),
                         PLAIN_REPS)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = timer(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), LIBRARY_REPS)
        del out
        pairs = B * causal_pairs(Sq, Sk, causal)
        es = q.element_size()
        # the whole backward's least work, split between the two rows so
        # that they add up to it: 10 flop per live pair and dim (its five
        # products, each counted once) and each tensor moved once.  The dq
        # row takes dp = do·vᵀ and dq = ds·k (4) and the per-query tensors
        # (q, do, lse, delta in; dq out); the dk/dv row takes s = q·kᵀ,
        # dv = pᵀ·do and dk = dsᵀ·q (6) and the per-key ones (k, v in; dk,
        # dv out).  The two-kernel recompute does 14, not 10.
        b_dq = bound(3 * q.numel() * es + 2 * lse.numel() * 4,
                     4 * pairs * H * D, dtype)
        b_dkv = bound(2 * (k.numel() + v.numel()) * es, 6 * pairs * H * D,
                      dtype)
        b_all = bound((3 * q.numel() + 2 * k.numel() + 2 * v.numel()) * es
                      + 2 * lse.numel() * 4, 10 * pairs * H * D, dtype)
        size = " ".join(f"{n} {float(w.float().abs().max()):.2f}"
                        for n, w in zip(("dq", "dk", "dv"), want))
        both = ms_dq + ms_dkv
        print(f"[kernel] {tag}: max |plain| {size}; max_abs_err dq "
              f"{err[0]:.3e} dk {err[1]:.3e} "
              f"dv {err[2]:.3e} (tol {gt:g}); a second launch equal bit for "
              f"bit  dq kernel {ms_dq:.4f} ms "
              f"(bound {b_dq[0]:.4f}, {b_dq[1]}; share "
              f"{b_dq[0] / ms_dq:.3f})  dkv kernel {ms_dkv:.4f} ms "
              f"(bound {b_dkv[0]:.4f}, {b_dkv[1]}; share "
              f"{b_dkv[0] / ms_dkv:.3f})  both {both:.4f}"
              f" ms vs backward bound {b_all[0]:.4f} ms ({b_all[1]}, "
              f"10*pairs*H*D): {10 * pairs * H * D / both / 1e9:.1f} "
              f"TFLOP/s  plain {plain_ms:.4f} ms  sdpa backward "
              f"{lib_ms:.4f} ms (both / sdpa {both / lib_ms:.2f})",
              flush=True)
        pair = (dict(max_abs_err=err[0], ms=ms_dq, plain_ms=plain_ms,
                     bound_ms=b_dq[0], bound_by=b_dq[1], library_ms=lib_ms),
                dict(max_abs_err=max(err[1:]), ms=ms_dkv, plain_ms=plain_ms,
                     bound_ms=b_dkv[0], bound_by=b_dkv[1],
                     library_ms=lib_ms))
        if rows is None:
            rows = pair
        elif (B, dtype) == (4, torch.bfloat16):
            name = (ENCDEC_ROWS[B, Sq, Sk, causal] if (H, D) == (16, 64)
                    else HEAD_ROWS[H, K, D])
            rows[0][name], rows[1][name] = pair
        del q, k, v, do, o, lse, delta, dq, dk, dv, want, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return rows


#: the loss heads of the xent rows beside the main path's (tinyllama's
#: E = 2048, V = 32000): name, hidden width, vocab, padded vocab
XENT_ROWS = (("deepseek", 2048, DEEPSEEK_VOCAB, DEEPSEEK_VOCAB),
             ("mamba2", 2048, MAMBA_VOCAB, MAMBA_VP),
             ("qwen3", 2048, 151936, 152064),
             ("gemma", 2048, 256000, 256000),
             ("stablelm", 2560, 50304, 50432),
             ("jamba", 4096, 65536, 65536),
             ("grok", 6144, 131072, 131072),
             ("qwen2vl", 1536, 151936, 152064),
             ("seamless", 1024, 256206, 256256))


def check_xent(torch, timer) -> tuple:
    """The xent forward kernel against its plain version and a second
    launch bit for bit, at the training path's loss head (T = 4·2047,
    E = 2048, V = 32000), with a padded vocab, in f32, and at each of
    :data:`XENT_ROWS`' heads in bf16 (deepseek-moe-16b's, mamba2-1.3b's
    tied head, and the dense family's rest: qwen3-1.7b's and gemma-2b's
    tied heads, stablelm-3b's at E = 2560, jamba-v0.1-52b's untied head
    at E = 4096, grok-1-314b's at E = 6144, V = 131072, qwen2-vl-2b's
    tied head at E = 1536, seamless-m4t-medium's untied 256k head at
    E = 1024), timed beside
    ``F.cross_entropy(h @ W)`` in this call (with the bf16 build's ptxas
    registers and spills); then the backward's elementwise pass on one
    f32 chunk of each vocab (the main path's first and a padded last
    one, and each head's last chunk), against its plain version and a
    second launch bit for bit.  Returns the (forward, backward) rows of
    the main path's shapes, with each head's under its name."""
    import torch.nn.functional as F

    from repro_torch.kernels.xent import xent

    print_ptxas("xent_fwd_mma_kernel")
    gen = torch.Generator(device="cuda").manual_seed(3)
    T = TRAIN_BATCH * (TRAIN_SEQ - 1)
    bf16 = torch.bfloat16
    fwd_row = bwd_row = None
    for name, T_, E, vocab, V, dtype in (
            [(None, T, 2048, 32000, 32000, bf16),
             (None, T, 2048, 31900, 32000, bf16),
             (None, 1000, 2048, 31900, 32000, torch.float32)]
            + [(n, T, E, vocab, V, bf16) for n, E, vocab, V in XENT_ROWS]):
        h = torch.randn((T_, E), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((E, V), generator=gen, device="cuda")
             / math.sqrt(E)).to(dtype)
        labels = torch.randint(0, vocab, (T_,), generator=gen,
                               device="cuda", dtype=torch.int32)
        labels[0] = vocab - 1                       # the last real column
        nll, lse = xent.xent_fwd(h, w, labels, vocab)
        again = xent.xent_fwd(h, w, labels, vocab)
        torch.cuda.synchronize()
        want = xent.xent_fwd_plain(h, w, labels, vocab)
        tag = f"xent_fwd T={T_} E={E} V={V} vocab={vocab} {dtype}"
        if not (torch.isfinite(nll).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"{tag}: non-finite output")
        err = max(check_close(tag + " nll", nll, want[0], torch.float32),
                  check_close(tag + " lse", lse, want[1], torch.float32))
        assert_same_bits(tag, (nll, lse), again)
        del want, again
        ms = timer(lambda: xent.xent_fwd(h, w, labels, vocab))
        plain_ms = timer(lambda: xent.xent_fwd_plain(h, w, labels, vocab),
                         PLAIN_REPS)
        lab64 = labels.long()
        lib_ms = timer(lambda: F.cross_entropy(h @ w, lab64), LIBRARY_REPS)
        es = h.element_size()
        b_ms, b_by = bound((h.numel() + w.numel()) * es + 3 * T_ * 4,
                           2 * T_ * E * V, dtype)
        flops = 2 * T_ * E * V
        print(f"[kernel] {tag}: max_abs_err {err:.3e} (tol 2e-05); a second "
              f"launch equal bit for bit  kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s, share of the bound "
              f"{b_ms / ms:.3f})  plain {plain_ms:.4f} ms  "
              f"F.cross_entropy(h @ W) (two calls) {lib_ms:.4f} ms (kernel / "
              f"library {ms / lib_ms:.2f})  bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=lib_ms)
        if fwd_row is None:
            fwd_row = r
        elif name is not None:
            fwd_row[name] = r
        del h, w
        torch.cuda.empty_cache()

    V = 32000
    chunk = xent.bwd_chunk(T, V)
    lse = torch.randn((T,), generator=gen, device="cuda") + 10.0
    g_nll = torch.rand((T,), generator=gen, device="cuda")
    g_lse = torch.rand((T,), generator=gen, device="cuda") * 1e-3
    labels = torch.randint(0, V, (T,), generator=gen, device="cuda",
                           dtype=torch.int32)
    cases = [(None, 0, chunk, V), (None, V - V % chunk, V % chunk, V - 100),
             (None, 0, 4098, 3000)]
    for name, _, vocab, Vp in XENT_ROWS:
        c = xent.bwd_chunk(T, Vp)
        last = Vp % c or c
        cases.append((name, Vp - last, last, vocab))
    for name, col0, C, vocab in cases:
        logits = torch.randn((T, C), generator=gen, device="cuda") + 8.0
        args = (lse, labels, g_nll, g_lse, col0, vocab)
        want = xent.xent_bwd_plain(logits.clone(), *args)
        got = xent.xent_bwd(logits.clone(), *args)
        again = xent.xent_bwd(logits.clone(), *args)
        torch.cuda.synchronize()
        tag = f"xent_bwd T={T} chunk={C} col0={col0} vocab={vocab} f32"
        err = check_close(tag, got, want, torch.float32)
        assert_same_bits(tag, (got,), (again,))
        buf = logits.clone()
        ms = timer(lambda: xent.xent_bwd(buf, *args))
        plain_ms = timer(lambda: xent.xent_bwd_plain(buf, *args),
                         PLAIN_REPS)
        b_ms, b_by = bound(2 * logits.numel() * 4 + 4 * T * 4, 0,
                           torch.float32)
        print(f"[kernel] {tag}: max_abs_err {err:.3e} (tol 2e-05); a second "
              f"launch equal bit for bit  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  no library call  bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None)
        if bwd_row is None:
            bwd_row = r
        elif name is not None:
            bwd_row[name] = r
        del logits, want, got, again, buf
    return fwd_row, bwd_row


def check_ssd(torch, timer) -> dict:
    """The SSD chunked-scan kernel against its plain version (y and the
    final state within 5e-4) and a second launch bit for bit: mamba2-1.3b's
    prefill shape (B=1, S=512, 64 heads of 64, state 128, G=1, chunk 256,
    x and B/C bf16), S=2048 (8 chunks, the carry), S=8 (chunk = S), a
    ragged chunk of 40, a grouped f32 case, a rank's 32 heads of the
    prefill split over ``model`` at tp 2 (phase 31), and jamba-v0.1-52b's
    128 heads of 64 (phase 34; a rank's 64 at tp 2 is mamba2's shape).  bf16 runs the
    tensor-core kernel, f32 the FMA one.  Prints the tensor-core builds'
    ptxas registers and spills and fails on a spill.  Returns the row of
    the main path's shape, the split's under ``"split"`` and jamba's
    under ``"jamba"``."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ssd

    print_ptxas("ssd_scan_mma_kernel")
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(1, 512, 64, 64, 1, 128, 256, bf16),
             (1, 2048, 64, 64, 1, 128, 256, bf16),
             (1, 8, 64, 64, 1, 128, 256, bf16),
             (1, 120, 8, 64, 2, 64, 40, bf16),
             (2, 384, 8, 32, 2, 16, 128, f32),
             (2, 512, 32, 64, 1, 128, 256, bf16),
             (1, 512, 128, 64, 1, 128, 256, bf16)]
    row = None
    for B, S, H, P, G, N, chunk, dtype in cases:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        x = rnd(B, S, H, P).to(dtype)
        dt = F.softplus(rnd(B, S, H) - 1.0)
        A = -torch.exp(0.3 * rnd(H))
        Bm = (0.3 * rnd(B, S, G, N)).to(dtype)
        Cm = (0.3 * rnd(B, S, G, N)).to(dtype)
        args = (x, dt, A, Bm, Cm)
        want = ssd.ssd_scan_plain(*args, chunk=chunk)
        Q = min(chunk, S)
        plain_ms = timer(lambda: ssd.ssd_scan_plain(*args, chunk=chunk))
        # least work: C·Bᵀ once per (batch, group, chunk) over its causal
        # half; per head the intra-chunk product (same half), the carried
        # state's C·h and the state update, each once; at the peak of the
        # pipe the dtype's kernel runs on (bf16: the tensor cores)
        pairs = Q * (Q + 1) // 2 * (S // Q)
        flops = 2 * B * (G * pairs * N + H * pairs * P + 2 * H * S * N * P)
        nbytes = (x.numel() + Bm.numel() + Cm.numel()) * x.element_size() \
            + (dt.numel() + A.numel() + want[0].numel()
               + want[1].numel()) * 4
        b_ms, b_by = bound(nbytes, flops, dtype)
        y, h = ssd.ssd_scan(*args, chunk=chunk)
        again = ssd.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        tag = (f"ssd_scan B={B} S={S} H={H} P={P} G={G} N={N} chunk={Q} "
               f"{dtype}")
        err = max(check_close(tag + " y", y, want[0], f32, SSD_TOL),
                  check_close(tag + " state", h, want[1], f32, SSD_TOL))
        assert_same_bits(tag, (y, h), again)
        call = lambda: ssd.ssd_scan(*args, chunk=chunk)
        ms, other_ms = timed(timer, call)
        other = against_line(call, want, tag, f32, other_ms, SSD_TOL)
        print(f"[kernel] {tag}: max_abs_err {err:.3e} (tol {SSD_TOL:g}); a "
              f"second launch equal bit for bit{other}  kernel {ms:.4f} ms ("
              f"{flops / ms / 1e9:.1f} TFLOP/s of least work, share of the "
              f"bound {b_ms / ms:.3f})  plain {plain_ms:.4f} ms  no library "
              f"call  bound {b_ms:.4f} ms ({b_by}; operations at the {dtype} "
              f"peak, C·Bᵀ once per group and chunk)", flush=True)
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None)
        if row is None:
            row = r
        elif H in (32, 128):
            row["split" if H == 32 else "jamba"] = r
        del args, x, dt, Bm, Cm, want, y, h, again
    return row


def same_bits(a, b) -> bool:
    """Equal element for element, a NaN equal to a NaN."""
    import torch
    if a.dtype.is_floating_point:
        return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                    and torch.equal(torch.nan_to_num(a, nan=0.0),
                                    torch.nan_to_num(b, nan=0.0)))
    return bool(torch.equal(a, b))


def check_quant(torch, timer) -> tuple:
    """The int8 quantize and dequantize kernels against their plain
    versions, bit for bit (q, s, x): block 256 over 2^26 elements, one
    block over tinyllama's largest gradient leaf (the compressed training
    path's shape: one scale per tensor), a bf16 input, and a NaN in each
    of the two kernel paths (its block's scale NaN on both sides).
    Under ``--against`` only quantize, against the other tree's in the
    order other, this, this, other, equal bit for bit.  Returns the
    (quantize, dequantize) rows of the largest leaf."""
    from repro_torch.kernels.quant.quant import (dequantize,
                                                 dequantize_plain, quantize,
                                                 quantize_plain)

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = [(256, 1 << 26, torch.float32, False),
             (LEAF, LEAF, torch.float32, False),
             (1 << 26, 1 << 26, torch.bfloat16, False),
             (256, 1 << 20, torch.float32, True),
             (1 << 26, 1 << 26, torch.float32, True)]
    rows = None
    for block, T, dtype, nan in cases:
        x = (torch.randn((T,), generator=gen, device="cuda") * 1e-3
             ).to(dtype)
        if nan:
            x[T // 3] = float("nan")
        q, s = quantize(x, block=block)
        y = dequantize(q, s, block=block)
        torch.cuda.synchronize()
        qp, sp = quantize_plain(x, block)
        yp = dequantize_plain(qp, sp, block)
        tag = (f"quant block={block} T={T} {dtype}"
               f"{' with a NaN' if nan else ''}")
        if not (same_bits(q, qp) and same_bits(s, sp) and same_bits(y, yp)):
            raise AssertionError(
                f"{tag}: q differs at {int((q != qp).sum())}, s at "
                f"{int((s != sp).sum())}, x at {int((y != yp).sum())}")
        if nan and not (torch.isnan(s[(T // 3) // block])
                        and torch.isnan(sp[(T // 3) // block])):
            raise AssertionError(f"{tag}: the NaN's scale is not NaN")
        del qp, sp, yp
        nb = T // block
        es = x.element_size()
        b_q = bound(T * (es + 1) + nb * 4, 0, torch.float32)
        b_d = bound(T * (1 + 4) + nb * 4, 0, torch.float32)
        ms_q, other_q = timed(timer, lambda: quantize(x, block=block))
        if AGAINST is not None:
            from repro_torch.kernels import build
            with build.using(AGAINST):
                qo, so = quantize(x, block=block)
            if not (same_bits(qo, q) and same_bits(so, s)):
                raise AssertionError(f"{tag}: --against's quantize differs")
            del qo, so
            print(f"[kernel] {tag}: quantize {ms_q:.4f} ms, --against "
                  f"{other_q:.4f} ms (order --against, this, this, "
                  f"--against), equal bit for bit", flush=True)
            continue
        plain_q = timer(lambda: quantize_plain(x, block))
        ms_d = timer(lambda: dequantize(q, s, block=block))
        plain_d = timer(lambda: dequantize_plain(q, s, block))
        # dequantize's one PyTorch call: int8 · f32 promotes to f32 and
        # rounds once, as the kernel does; quantize has none (abs-max,
        # divide, round and clamp are four)
        qv, sv = q.view(nb, block), s[:, None]
        lib = torch.mul(qv, sv).reshape(-1)
        if not same_bits(lib, y):
            raise AssertionError(f"{tag}: torch.mul(q, s) differs from "
                                 f"dequantize at {int((lib != y).sum())}")
        del lib
        lib_d = timer(lambda: torch.mul(qv, sv))
        print(f"[kernel] {tag}: q, s, x equal bit for bit  quantize "
              f"{ms_q:.4f} ms (plain {plain_q:.4f}, bound {b_q[0]:.4f}, "
              f"{b_q[1]}, no library call)  dequantize {ms_d:.4f} ms (plain "
              f"{plain_d:.4f}, bound {b_d[0]:.4f}, {b_d[1]}, torch.mul "
              f"{lib_d:.4f})", flush=True)
        if (block, T, dtype) == (LEAF, LEAF, torch.float32):
            rows = (dict(max_abs_err=0.0, ms=ms_q, plain_ms=plain_q,
                         bound_ms=b_q[0], bound_by=b_q[1], library_ms=None),
                    dict(max_abs_err=0.0, ms=ms_d, plain_ms=plain_d,
                         bound_ms=b_d[0], bound_by=b_d[1], library_ms=lib_d))
        del x, q, s, y, qv, sv
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def world_of_one():
    """A default process group of one rank over NCCL (the compressor's
    collectives), destroyed on the way out."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def check_ef(torch, timer) -> tuple:
    """The compressor's fused error-feedback encode at tinyllama's largest
    gradient leaf with a carried error (f32, bf16, and f32 with a NaN):
    ef_absmax, ef_requant and ef_decode each against its plain version,
    and compressed_psum (the three around the collectives of a world of one
    over NCCL) against compressed_psum_plain, the op by op path through
    quantize and dequantize, all bit for bit.  Times the three kernels, their
    plain versions and, for ef_decode, ``torch.mul(total, smax)`` (its
    function at a world of one), and the fused compressed_psum beside the
    eager one in this call.  Then the same at a block of a leaf (EF_BLOCK
    elements, phase 29's table shard under ZeRO-3), the block's scale
    all-reduced over a split group (the world of one) as the compressed
    step runs a model shard or a ZeRO shard.  Prints the kernels' ptxas
    registers and spills and fails on a spill.  Returns the three rows of
    the f32 leaf, the block's under ``"block"``."""
    from repro_torch.kernels.quant.quant import (ef_absmax, ef_absmax_plain,
                                                 ef_decode, ef_decode_plain,
                                                 ef_requant,
                                                 ef_requant_plain)
    from repro_torch.optim import grad_compress as gc

    print_ptxas(EF_KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = None
    with world_of_one():
        for dtype, nan, n in ((torch.float32, False, LEAF),
                              (torch.bfloat16, False, LEAF),
                              (torch.float32, True, LEAF),
                              (torch.float32, False, EF_BLOCK)):
            x = (torch.randn((n,), generator=gen, device="cuda") * 1e-3
                 ).to(dtype)
            err = torch.randn((n,), generator=gen, device="cuda") * 1e-5
            if nan:
                x[n // 3] = float("nan")
            block = n != LEAF
            split = (None,) if block else ()    # the world of one's group
            tag = (f"ef encode T={n} {dtype} with a carried error"
                   f"{' and a NaN' if nan else ''}"
                   f"{', a block of a leaf' if block else ''}")
            s = ef_absmax(x, err)
            smax = s.clone()
            q2, e2 = ef_requant(x, err, s, smax)
            out = ef_decode(q2, smax, torch.empty_like(x), 1)
            torch.cuda.synchronize()
            if not same_bits(s, ef_absmax_plain(x, err)):
                raise AssertionError(f"{tag}: ef_absmax differs from plain")
            qp, ep = ef_requant_plain(x, err, s, smax)
            if not (same_bits(q2, qp) and same_bits(e2, ep)):
                raise AssertionError(
                    f"{tag}: ef_requant differs from plain at "
                    f"{int((q2 != qp).sum())} q2, {int((e2 != ep).sum())} "
                    f"errors")
            del qp, ep
            if not same_bits(out, ef_decode_plain(q2, smax,
                                                  torch.empty_like(x), 1)):
                raise AssertionError(f"{tag}: ef_decode differs from plain")
            fo, fe = gc.compressed_psum(x, None, err, split_groups=split)
            po, pe = gc.compressed_psum_plain(x, None, err,
                                              split_groups=split)
            if not (same_bits(fo, po) and same_bits(fe, pe)):
                raise AssertionError(
                    f"{tag}: compressed_psum differs from compressed_psum_"
                    f"plain at {int((fo != po).sum())} outputs, "
                    f"{int((fe != pe).sum())} errors")
            if nan and not (torch.isnan(s).all() and torch.isnan(fe).any()):
                raise AssertionError(f"{tag}: the NaN's scale is not NaN")
            del fo, fe, po, pe
            print(f"[kernel] {tag}: s, q2, error, output and compressed_psum "
                  f"equal their plain versions bit for bit", flush=True)
            if dtype == torch.float32 and not nan:
                n_el = n
                lib = torch.mul(q2, smax)
                if not same_bits(lib, out):
                    raise AssertionError(f"{tag}: torch.mul(total, smax) "
                                         f"differs from ef_decode")
                del lib
                b1 = bound(n_el * 8 + 4, 0, torch.float32)
                b2 = bound(n_el * 16 + 8, 0, torch.float32)
                b3 = bound(n_el * 8 + 4, 0, torch.float32)
                ms = [timer(lambda: ef_absmax(x, err)),
                      timer(lambda: ef_requant(x, err, s, smax, e2)),
                      timer(lambda: ef_decode(q2, smax, out, 1))]
                plain = [timer(lambda: ef_absmax_plain(x, err)),
                         timer(lambda: ef_requant_plain(x, err, s, smax, e2)),
                         timer(lambda: ef_decode_plain(q2, smax, out, 1))]
                lib_ms = timer(lambda: torch.mul(q2, smax, out=out))
                fused = timer(lambda: gc.compressed_psum(
                    x, None, err, split_groups=split))
                eager = timer(lambda: gc.compressed_psum_plain(
                    x, None, err, split_groups=split))
                names = ("ef_absmax", "ef_requant", "ef_decode")
                for name, t, p, b in zip(names, ms, plain, (b1, b2, b3)):
                    print(f"[kernel] {name} at T={n_el} f32: {t:.4f} ms "
                          f"(plain {p:.4f}, bound {b[0]:.4f}, {b[1]}, share "
                          f"{b[0] / t:.3f})", flush=True)
                print(f"[kernel] ef encode at T={n_el} f32: K1+K2+K3 "
                      f"{sum(ms):.4f} ms against a bound of "
                      f"{b1[0] + b2[0] + b3[0]:.4f} (32 B/element; K1+K2 "
                      f"{sum(ms[:2]):.4f} against {b1[0] + b2[0]:.4f}, K3 "
                      f"{ms[2]:.4f} against {b3[0]:.4f}); torch.mul(total, "
                      f"smax) {lib_ms:.4f}; compressed_psum (fused, with the "
                      f"collectives) {fused:.4f} ms against "
                      f"compressed_psum_plain (eager: quantize, dequantize "
                      f"and ~20 passes) {eager:.4f} ms in this call "
                      f"({eager / fused:.2f}x)", flush=True)
                got = tuple(dict(max_abs_err=0.0, ms=t, plain_ms=p,
                                 bound_ms=b[0], bound_by=b[1],
                                 library_ms=lb)
                            for t, p, b, lb in zip(ms, plain, (b1, b2, b3),
                                                   (None, None, lib_ms)))
                if rows is None:
                    rows = got
                else:
                    for row, r in zip(rows, got):
                        row["block"] = r
            del x, err, s, smax, q2, e2, out
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4-10: the serving driver at full width, and small-model agreement
# ---------------------------------------------------------------------------

def kernel_wrappers() -> dict:
    """Every kernel's wrapper by name; each counts its launches."""
    from repro_torch.kernels.flash_attention import flash, paged
    from repro_torch.kernels.quant.quant import (dequantize, ef_absmax,
                                                 ef_decode, ef_requant,
                                                 quantize)
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.xent import xent

    return {"flash_fwd": flash.flash_attention,
            "paged_decode": paged.paged_decode,
            "flash_bwd_dq": flash.flash_bwd_dq,
            "flash_bwd_dkv": flash.flash_bwd_dkv,
            "xent_fwd": xent.xent_fwd, "xent_bwd": xent.xent_bwd,
            "ssd_scan": ssd.ssd_scan, "quantize": quantize,
            "dequantize": dequantize, "ef_absmax": ef_absmax,
            "ef_requant": ef_requant, "ef_decode": ef_decode}


def reset_counts(kernels: dict) -> None:
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels: dict) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def serve_paged(torch, kernels) -> dict:
    from repro_torch.launch import serve

    reset_counts(kernels)
    summary, server = serve.run(serve.parse_args(PAGED_ARGS))
    counts = read_counts(kernels)
    print(f"[main] paged serve tokens crc32 {summary['tokens_crc32']:08x}",
          flush=True)
    layers = server.model.cfg.n_layers
    print(f"[main] paged serve: {summary['completed']} requests, "
          f"{summary['tokens']} tokens, {summary['steps']} decode steps in "
          f"{summary['seconds']:.3f} s = "
          f"{summary['tokens'] / summary['seconds']:.1f} tok/s; launches "
          f"{counts}", flush=True)
    if summary["completed"] != 16:
        raise AssertionError(f"paged serve completed {summary['completed']}")
    if counts["flash_fwd"] != layers * 16:
        raise AssertionError(f"flash launches {counts['flash_fwd']} != "
                             f"{layers} per admission x 16")
    if counts["paged_decode"] != layers * summary["steps"] or not counts[
            "paged_decode"]:
        raise AssertionError(f"paged launches {counts['paged_decode']} != "
                             f"{layers} per step x {summary['steps']}")
    if any(counts[n] for n in counts if n not in ("flash_fwd",
                                                   "paged_decode")):
        raise AssertionError(f"serving launched a training kernel: {counts}")
    for name, kv in server.pools.items():
        for key, pool in kv.items():
            if pool[:, 0].any():
                raise AssertionError(f"trash page of {name}/{key} written")
            if not torch.isfinite(pool).all():
                raise AssertionError(f"non-finite KV in {name}/{key}")
    print("[main] trash page all zero, KV pools finite", flush=True)
    return counts, summary


def serve_dense(kernels) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    reset_counts(kernels)
    summary = serve.main(DENSE_ARGS)
    counts = read_counts(kernels)
    print(f"[dense] {summary['completed']} requests, {summary['tokens']} "
          f"tokens, {summary['steps']} steps in {summary['seconds']:.3f} s "
          f"= {summary['tokens'] / summary['seconds']:.1f} tok/s; launches "
          f"{counts}", flush=True)
    layers = get_config(ARCH).n_layers
    if summary["completed"] != 4 or counts["flash_fwd"] != layers * 4 \
            or sum(counts.values()) != counts["flash_fwd"]:
        raise AssertionError("dense serve did not run as expected")


def small_model_agreement(torch) -> None:
    """A 2-layer f32 model (GQA 8:2, head_dim 64) on the card against the
    same weights on the CPU, where the wrappers run the plain versions:
    prefill, then paged decode steps."""
    from repro_torch.configs import get_config, shrink
    from repro_torch.models.lm import Model

    cfg = shrink(get_config(ARCH), n_heads=8, n_kv_heads=2, head_dim=64)
    cpu, gpu = Model(cfg, "cpu"), Model(cfg, "cuda")
    params = cpu.init(0)
    gparams = _to(params, "cuda")
    tokens = torch.randint(0, cfg.vocab, (1, 40),
                           generator=torch.Generator().manual_seed(0))
    last = torch.tensor([36])
    outs = {}
    for name, model, p in (("cpu", cpu, params), ("cuda", gpu, gparams)):
        dev = model.device
        logits, st = model.prefill(p, {"tokens": tokens.to(dev)},
                                   gen_budget=0, last_idx=last.to(dev))
        ps = 8
        pools = model.paged_pools(8, ps)
        for key in ("k", "v"):
            a = st["cache"]["p0"][key][:, 0, :40]
            pools["p0"][key][:, 1:6] = a.reshape(a.shape[0], 5, ps,
                                                 *a.shape[2:])
        table = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 0]], dtype=torch.int32,
                             device=dev)
        state = {"pools": pools, "block_table": table,
                 "pos": torch.tensor([37], dtype=torch.int32, device=dev)}
        seq = [logits]
        tok = logits[:, :cfg.vocab].argmax(-1)
        for _ in range(8):
            logits, state = model.serve_step_paged(p, tok, state)
            seq.append(logits)
            tok = logits[:, :cfg.vocab].argmax(-1)
        outs[name] = torch.stack(seq).cpu()
    worst = max_err(outs["cuda"], outs["cpu"])
    if not worst <= 1e-4:
        raise AssertionError(f"card vs cpu logits differ by {worst:.3e}")
    print(f"[agree] 2-layer f32 model, prefill + 8 paged steps: card vs cpu "
          f"max |logit err| {worst:.3e} (limit 1e-4)", flush=True)


def mamba2_paged_refusal():
    """``serve --arch mamba2 --cache paged`` started in a process of its
    own (:func:`serve_mamba2` reads its end)."""
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", MAMBA,
         "--cache", "paged"], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))


def serve_mamba2(torch, kernels, refusal) -> tuple:
    """The mamba2-1.3b serving driver at full width (dense cache): the
    main run, then one 2000-token prompt; the SSD scan must launch once
    per layer and prefill, and nothing else.  Then ``--cache paged`` with
    this arch must exit non-zero (``refusal``, the process
    :func:`mamba2_paged_refusal` started).  Returns the two runs'
    counts."""
    from repro_torch.launch import serve

    runs = []
    for args, n in ((MAMBA_ARGS, 8), (MAMBA_LONG_ARGS, 1)):
        reset_counts(kernels)
        summary, server = serve.run(serve.parse_args(args))
        counts = read_counts(kernels)
        layers = server.model.cfg.n_layers
        print(f"[mamba2] {' '.join(args[2:])}: {summary['completed']} "
              f"requests, {summary['tokens']} tokens, {summary['steps']} "
              f"decode steps in {summary['seconds']:.3f} s = "
              f"{summary['tokens'] / summary['seconds']:.1f} tok/s; launches "
              f"{counts}", flush=True)
        if summary["completed"] != n:
            raise AssertionError(f"mamba2 serve completed "
                                 f"{summary['completed']} of {n}")
        want = dict.fromkeys(counts, 0)
        want["ssd_scan"] = layers * n             # one per layer and prefill
        if counts != want:
            raise AssertionError(f"mamba2 launches {counts}, want {want}")
        state = server.state["cache"]["p0"]
        if not all(torch.isfinite(t).all() for t in state.values()) \
                or not state["h"].abs().max() > 0:
            raise AssertionError("mamba2 decode state not finite or zero")
        runs.append(counts)
        del server
        torch.cuda.empty_cache()
    _, err = refusal.communicate(timeout=300)
    last = (err.strip().splitlines() or [""])[-1]
    print(f"[mamba2] --cache paged: exit {refusal.returncode}: {last}",
          flush=True)
    if refusal.returncode == 0 or "does not support the paged" not in err:
        raise AssertionError("--cache paged with mamba2 did not refuse")
    return tuple(runs)


def mamba2_agreement(torch) -> None:
    """A 2-layer f32 mamba2 at the kernel's real tile sizes (4 heads of 64,
    state 128, chunk 256) on the card against the same weights on the CPU
    (the plain scan): a ragged batch-2 prefill over 1024 positions (4
    chunks; last tokens at 599 and 1023), each layer's h and conv, then 8
    decode steps' logits, within 5e-4."""
    from repro_torch.configs import get_config, shrink
    from repro_torch.models.lm import Model

    cfg = shrink(get_config(MAMBA), ssd_headdim=64, ssd_state=128,
                 ssd_chunk=256)
    cpu, gpu = Model(cfg, "cpu"), Model(cfg, "cuda")
    params = cpu.init(0)
    tokens = torch.randint(0, cfg.vocab, (2, 1024),
                           generator=torch.Generator().manual_seed(0))
    last = torch.tensor([599, 1023])
    outs, fed = {}, []
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        dev = model.device
        p = _to(params, dev)
        logits, st = model.prefill(p, {"tokens": tokens.to(dev)},
                                   last_idx=last.to(dev))
        seq = [logits]
        for i in range(8):
            if name == "cpu":            # the card decodes the CPU's tokens
                fed.append(logits[:, :cfg.vocab].argmax(-1))
            logits, st = model.serve_step(p, fed[i].to(dev), st)
            seq.append(logits)
        outs[name] = (torch.stack(seq).cpu(), _to(st["cache"], "cpu"))
    worst = {"logits": check_close("mamba2 logits", outs["cuda"][0],
                                   outs["cpu"][0], torch.float32, SSD_TOL)}
    for key in ("h", "conv"):
        # the state after 8 decode steps carries the prefill state
        worst[key] = check_close(f"mamba2 {key}", outs["cuda"][1]["p0"][key],
                                 outs["cpu"][1]["p0"][key], torch.float32,
                                 SSD_TOL)
    print(f"[agree] 2-layer f32 mamba2 (4 heads of 64, state 128, chunk "
          f"256), ragged batch-2 prefill over 1024 + 8 decode steps: card "
          f"vs cpu max |err| logits {worst['logits']:.3e}, h "
          f"{worst['h']:.3e}, conv {worst['conv']:.3e} (limit 5e-4 + "
          f"5e-4|x|)", flush=True)


def profiled(torch, fn, n: int) -> tuple:
    """``fn`` run ``n`` times under torch.profiler → (host ms per run,
    device busy ms per run — the union of its kernels' intervals — or None
    when the profiler saw no device activity, the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / n * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print("[time] profiler saw no device activity: busy share not "
              "measured", flush=True)
        return host_ms, None, prof
    busy, end = 0.0, float("-inf")
    for a, b in spans:                       # union of kernel intervals (µs)
        if b > end:
            busy += b - max(a, end)
            end = b
    return host_ms, busy / n / 1e3, prof


def where_the_time_goes(torch, arch: str = ARCH, cache: str = "paged") -> dict:
    """A serving configuration split by phase: one 500-token prefill,
    then decode steps of 8 live slots (~500-token contexts) — timed with
    the host clock around a sync, then each once more under torch.profiler
    for the device's busy share and its top kernels.  Returns the host ms
    of a prefill and of a decode step, their device-busy ms (None where
    the profiler saw no device), and the mean live keys a timed decode
    step reads (its slots' contexts, summed)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.serving.server import Request, Server

    cfg = get_config(arch)
    model = Model(cfg)
    server = Server(model, batch_slots=8, max_len=1024, cache=cache,
                    page_size=64)
    params = model.serving_params(model.init(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 500, dtype=np.int32)
               for _ in range(9)]
    server.admit(params, Request(99, prompts[8], max_new=2), 0)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(8):
        server.admit(params, Request(b, prompts[b], max_new=500), b)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) / 8 * 1e3
    for _ in range(3):
        server.step(params)
    n = 16

    def live_keys() -> int:
        return sum(len(r.prompt) + len(r.out_tokens)
                   for r in server.slots if r is not None)

    keys0 = live_keys()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        server.step(params)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    found = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
             "live_keys": (keys0 + live_keys() - 8) / 2,
             "prefill_busy_ms": None, "decode_step_busy_ms": None}
    print(f"[time] {arch} ({cache} cache): prefill of one 500-token prompt "
          f"(bucket 512): "
          f"{prefill_ms:.2f} ms; decode step, 8 slots: {step_ms:.2f} ms "
          f"({8 / step_ms * 1e3:.1f} tok/s)", flush=True)
    # the prefill as the server runs it: padded to its bucket, read at
    # the last real token
    tokens = torch.zeros((1, 512), dtype=torch.long, device="cuda")
    tokens[0, :500] = torch.tensor(prompts[8], device="cuda")
    last = torch.tensor([499], device="cuda")
    gen_budget = 0 if cache == "paged" else 1024 - 512
    # few calls under the profiler: its cost grows with the events (~70
    # eager ops a layer a step), the per-call averages do not
    runs = (("prefill", 1, lambda: model.prefill(
                params, {"tokens": tokens}, gen_budget, last)),
            ("decode step", 2, lambda: server.step(params)))
    for what, reps, fn in runs:
        host_ms, busy_ms, prof = profiled(torch, fn, reps)
        found[f"{what.replace(' ', '_')}_busy_ms"] = busy_ms
        if busy_ms is None:
            continue
        print(f"[time] under the profiler: {what} {host_ms:.2f} ms, device "
              f"busy {busy_ms:.3f} ms per {what}, idle share "
              f"{1 - busy_ms / host_ms:.3f}", flush=True)
        avgs = sorted(prof.key_averages(),
                      key=lambda e: -getattr(e, "self_device_time_total", 0))
        for e in avgs[:8]:
            t = getattr(e, "self_device_time_total", 0) / reps / 1e3
            print(f"[time]   {t:.4f} ms/{what}  x{e.count // reps:<4d} "
                  f"{e.key[:90]}", flush=True)
    return found


# ---------------------------------------------------------------------------
# phases 11-14: the training driver at full width, card against CPU, resume,
# and where the time goes in a training step
# ---------------------------------------------------------------------------

def train_expected(layers: int, steps: int, vp: int,
                   rows: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """Launches per run of the training path (remat "full", one
    micro-batch of ``rows`` sequences of ``seq``, attn_bwd_remat off): the
    checkpointed recompute runs each layer's forward twice."""
    from repro_torch.kernels.xent import xent

    T = rows * (seq - 1)
    return {"flash_fwd": 2 * layers * steps, "paged_decode": 0,
            "flash_bwd_dq": layers * steps, "flash_bwd_dkv": layers * steps,
            "xent_fwd": steps,
            "xent_bwd": steps * -(-vp // xent.bwd_chunk(T, vp)),
            "ssd_scan": 0, "quantize": 0, "dequantize": 0, "ef_absmax": 0,
            "ef_requant": 0, "ef_decode": 0}


def train_full(torch, kernels) -> dict:
    """The training path: the driver at full width, with the launch counts
    read around it and the final checkpoint's write timed."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config(ARCH)
    need = 3 * 4 * 1.2e9                    # params + mu + nu in f32
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        if free < 1.2 * need:
            raise RuntimeError(
                f"{tmp} has {free / 1e9:.1f} GB free; the full-width "
                f"checkpoint (params, mu, nu in f32) needs about "
                f"{need / 1e9:.1f} GB: set TMPDIR to a larger disk")
        saves = []
        save = CheckpointManager.save

        def timed_save(self, *a, **kw):
            t0 = time.perf_counter()
            out = save(self, *a, **kw)
            saves.append(time.perf_counter() - t0)
            return out

        CheckpointManager.save = timed_save
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        try:
            out = train.main(TRAIN_ARGS + ["--ckpt-dir", tmp])
        finally:
            CheckpointManager.save = save
        counts = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated()
        ckpt_bytes = sum(f.stat().st_size for f in os.scandir(
            os.path.join(tmp, f"step_{TRAIN_STEPS:08d}")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses, secs = out["losses"], out["step_seconds"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens * (len(secs) - 1) / sum(secs[1:])
    print(f"[train] tinyllama-1.1b full width, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, AdamW, remat full: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"[train] step seconds {[round(x, 3) for x in secs]}; steps 1-"
          f"{len(secs) - 1}: {sum(secs[1:]) / (len(secs) - 1):.3f} s/step = "
          f"{tok_s:.1f} tokens/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; final checkpoint {ckpt_bytes / 1e9:.2f} "
          f"GB written in {saves[-1]:.2f} s; launches {counts}", flush=True)
    if out["final_step"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"training stopped at {out['final_step']}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    want = train_expected(cfg.n_layers, TRAIN_STEPS, cfg.padded_vocab)
    if counts != want:
        raise AssertionError(f"training launches {counts}, want {want}")
    return counts, losses


def train_agreement(torch) -> None:
    """A 2-layer f32 model (GQA 8:2, head_dim 64, remat full) on the card
    against the same weights and batch on the CPU (the plain versions, and
    the sequence-chunked loss head in place of the fused kernels): loss,
    every gradient leaf, and the parameters after one AdamW step."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config, shrink
    from repro_torch.core.planner import loss_and_grads
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten

    cfg = dataclasses.replace(
        shrink(get_config(ARCH), n_heads=8, n_kv_heads=2, head_dim=64),
        remat="full")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 96))
    params = Model(cfg, "cpu").init(0)
    out = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, dev)
        p = _to(params, dev)
        loss, _, grads = loss_and_grads(
            model, p, {"tokens": torch.tensor(tokens, device=dev)})
        opt = adamw(lr=3e-4)                       # the driver's default
        opt.apply(grads, opt.init(p), p, 0)
        out[dev] = (loss.cpu(), _to(grads, "cpu"), _to(p, "cpu"))
    worst = {"loss": check_close("train loss", out["cuda"][0], out["cpu"][0],
                                 torch.float32, 1e-4)}
    for name, i in (("grad", 1), ("param after AdamW", 2)):
        paths, got = flatten(out["cuda"][i])
        want = flatten(out["cpu"][i])[1]
        worst[name] = max(check_close(f"{name} {path}", g.detach(),
                                      w.detach(), torch.float32, 1e-4)
                          for path, g, w in zip(paths, got, want))
    print(f"[agree] 2-layer f32 training step, card vs cpu: max |err| "
          f"loss {worst['loss']:.3e}, gradients {worst['grad']:.3e}, "
          f"parameters after one AdamW step {worst['param after AdamW']:.3e}"
          f" (limit 1e-4 + 1e-4|x|)", flush=True)


def train_resume(torch) -> None:
    """4 steps straight against 2 steps and a relaunch to 4 on the same
    checkpoint directory, on the small model on the card."""
    from repro_torch.launch import train

    args = ["--smoke", "--overrides", SMALL, "--batch", "2", "--seq", "128",
            "--log-every", "100"]
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        straight = train.main(args + ["--steps", "4", "--ckpt-dir", a])
        first = train.main(args + ["--steps", "2", "--ckpt-dir", b])
        rest = train.main(args + ["--steps", "4", "--ckpt-dir", b])
    got = first["losses"] + rest["losses"]
    print(f"[resume] straight {straight['losses']}; 2 steps "
          f"{first['losses']} then resumed {rest['losses']}", flush=True)
    if rest["final_step"] != 4 or len(rest["losses"]) != 2 \
            or got != straight["losses"]:
        raise AssertionError("the resumed run does not continue the loss "
                             "exactly")


def train_time(torch) -> None:
    """One full-width training step split on the host clock (forward,
    backward, optimizer, each ending in a sync), then one step under
    torch.profiler for the device's busy share and its top kernels."""
    import numpy as np
    from torch.autograd import DeviceType

    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten, unflatten

    cfg = get_config(ARCH)
    model = Model(cfg)
    params = model.init(0)
    opt = adamw(lr=1e-4)
    state = opt.init(params)
    paths, leaves = flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ))
    batch = {"tokens": torch.tensor(toks, device="cuda")}

    def step(times=None):
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.apply(unflatten(paths, list(grads)), state, params, 1)
        torch.cuda.synchronize()
        if times is not None:
            times.append((t1 - t0, t2 - t1, time.perf_counter() - t2))

    step()                                          # warm-up
    times = []
    for _ in range(2):
        step(times)
    fwd, bwd, upd = (min(t[i] for t in times) * 1e3 for i in range(3))
    total = fwd + bwd + upd
    print(f"[time] one training step (batch {TRAIN_BATCH} x {TRAIN_SEQ}): "
          f"forward {fwd:.1f} ms, backward (with the checkpointed "
          f"recompute) {bwd:.1f} ms, AdamW {upd:.1f} ms; total "
          f"{total:.1f} ms = {TRAIN_BATCH * TRAIN_SEQ / total * 1e3:.1f} "
          f"tokens/s", flush=True)
    prof_ms, busy_ms, prof = profiled(torch, step, 1)
    if busy_ms is None:
        return
    print(f"[time] under the profiler: step {prof_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / prof_ms:.3f}",
          flush=True)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    for e in kernels[:12]:                   # device kernels only, by time
        t = e.self_device_time_total / 1e3
        print(f"[time]   {t:9.2f} ms/step  x{e.count:<5d} {e.key[:90]}",
              flush=True)
    ours = {name: (sum(e.self_device_time_total for e in kernels
                       if any(k in e.key for k in keys)) / 1e3,
                   sum(e.count for e in kernels
                       if any(k in e.key for k in keys)))
            for name, keys in (("flash forward", ("flash_fwd_",)),
                               ("xent forward", ("xent_fwd_",
                                                 "xent_merge_")),
                               ("flash backward dq", ("flash_bwd_dq_",)),
                               ("flash backward dkv", ("flash_bwd_dkv_",)))}
    print("[time] the port's kernels: " + ", ".join(
        f"{name} {t:.2f} ms/step (x{n})" for name, (t, n) in ours.items()),
        flush=True)


# ---------------------------------------------------------------------------
# phases 15-16: the compressed data-parallel training path, and compression
# on the card against the CPU
# ---------------------------------------------------------------------------

def train_compressed(torch, kernels) -> tuple:
    """The driver with ``--mesh 1x1x1 --compress-pod`` at full width, then
    with ``--mesh 1x1x1`` alone, each with the launch counts and peak
    device memory read around it; neither final checkpoint is copied to
    the host or written (phase 11 times the full-width write).  Returns the
    compressed run's counts and the uncompressed run's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    from repro_torch.models.lm import Model
    from repro_torch.tree import flatten

    cfg = get_config(ARCH)
    leaves = len(flatten(Model(cfg, "meta").init(0))[1])     # 12
    runs = {}
    for name, extra in (("compressed", ["--compress-pod"]),
                        ("uncompressed", [])):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        written = []
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernels)
            with no_checkpoint_write(written):
                out = train.main(COMP_ARGS + extra + ["--ckpt-dir", tmp])
            counts = read_counts(kernels)
            peak = torch.cuda.max_memory_allocated()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        losses, secs = out["losses"], out["step_seconds"]
        tok_s = TRAIN_BATCH * TRAIN_SEQ * (len(secs) - 1) / sum(secs[1:])
        print(f"[{name}] mesh {out['mesh']}: losses "
              f"{[round(x, 4) for x in losses]}; step seconds "
              f"{[round(x, 4) for x in secs]}; steps 1-{len(secs) - 1}: "
              f"{sum(secs[1:]) / (len(secs) - 1):.4f} s/step = "
              f"{tok_s:.1f} tokens/s; peak device memory "
              f"{peak / 2**30:.2f} GiB; final checkpoint at step {written} "
              f"gathered (host copy and write skipped); launches {counts}",
              flush=True)
        if out["mesh"] != {"pod": 1, "data": 1, "model": 1}:
            raise AssertionError(f"{name}: mesh {out['mesh']}")
        if out["final_step"] != COMP_STEPS or len(losses) != COMP_STEPS:
            raise AssertionError(f"{name} stopped at {out['final_step']}")
        if not all(math.isfinite(x) for x in losses) \
                or losses[-1] >= losses[0]:
            raise AssertionError(f"{name}: loss not finite and falling: "
                                 f"{losses}")
        want = train_expected(cfg.n_layers, COMP_STEPS, cfg.padded_vocab)
        if extra:     # each fused encode kernel once per leaf and step
            want.update(ef_absmax=leaves * COMP_STEPS,
                        ef_requant=leaves * COMP_STEPS,
                        ef_decode=leaves * COMP_STEPS)
        if counts != want:
            raise AssertionError(f"{name} launches {counts}, want {want}")
        runs[name] = counts
    return runs["compressed"], runs["uncompressed"]


def leaf_grads(torch, seed: int) -> tuple:
    """Random gradients of tinyllama-1.1b's 12 leaf shapes on the card and
    their zero error tree; returns (grads, err, elements)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    from repro_torch.optim import grad_compress as gc
    from repro_torch.tree import flatten, unflatten

    paths, metas = flatten(Model(get_config(ARCH), "meta").init(0))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads = unflatten(paths, [torch.randn(m.shape, generator=gen,
                                          device="cuda") * 1e-3
                              for m in metas])
    return grads, gc.init_error_tree(grads), sum(m.numel() for m in metas)


def host_ms(torch, fn, n: int = 3) -> float:
    """fn's mean time on the host clock around a sync, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def compression_time(torch) -> None:
    """Where the compressed step's extra time goes: ``compressed_psum_tree``
    over gradients of tinyllama-1.1b's leaf shapes (a world of one, NCCL)
    on the host clock around a sync, then once under torch.profiler for
    its kernels by device time."""
    from torch.autograd import DeviceType

    from repro_torch.optim import grad_compress as gc

    grads, err, n = leaf_grads(torch, 6)
    with world_of_one():
        run = lambda: gc.compressed_psum_tree(grads, None, err)
        ms = host_ms(torch, run)
        host, busy_ms, prof = profiled(torch, run, 3)
    print(f"[time] compressed_psum_tree over tinyllama-1.1b's 12 gradient "
          f"leaves ({n / 1e9:.3f} G elements, a pod of one): {ms:.2f} ms "
          f"on the host clock", flush=True)
    if busy_ms is None:
        return
    print(f"[time] under the profiler: {host:.2f} ms, device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / host:.3f}",
          flush=True)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    for e in kernels[:12]:
        print(f"[time]   {e.self_device_time_total / 1e3:8.3f} ms  "
              f"x{e.count:<4d} {e.key[:90]}", flush=True)


def compression_against(torch) -> None:
    """Under ``--against``: the other checkout's ``compressed_psum_tree``
    (its ``optim/grad_compress.py``, loaded from its file, over its kernel
    library) beside this tree's over gradients of tinyllama-1.1b's leaf
    shapes in a world of one: equal bit for bit on the same inputs, then
    timed on the host clock around a sync in the order other, this, this,
    other."""
    import importlib.util

    from repro_torch.kernels import build
    from repro_torch.optim import grad_compress as gc
    from repro_torch.tree import flatten, tree_map

    spec = importlib.util.spec_from_file_location(
        "against_grad_compress",
        os.path.join(AGAINST_DIR, "src/repro_torch/optim/grad_compress.py"))
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    grads, err, n = leaf_grads(torch, 6)
    copy = lambda tree: tree_map(lambda t: t.clone(), tree)
    with world_of_one():
        with build.using(AGAINST):
            want = other.compressed_psum_tree(copy(grads), None, copy(err))
        got = gc.compressed_psum_tree(copy(grads), None, copy(err))
        torch.cuda.synchronize()
        for tree_got, tree_want in zip(got, want):
            for a, b in zip(flatten(tree_got)[1], flatten(tree_want)[1]):
                if not same_bits(a, b):
                    raise AssertionError("compressed_psum_tree: this tree "
                                         "and --against differ")
        del got, want
        this = lambda: gc.compressed_psum_tree(grads, None, err)
        that = lambda: other.compressed_psum_tree(grads, None, err)
        with build.using(AGAINST):
            first = host_ms(torch, that)
        mine = [host_ms(torch, this), host_ms(torch, this)]
        with build.using(AGAINST):
            last = host_ms(torch, that)
    print(f"[time] compressed_psum_tree over tinyllama-1.1b's 12 gradient "
          f"leaves ({n / 1e9:.3f} G elements, a pod of one), equal bit for "
          f"bit: --against {first:.2f} / {last:.2f} ms, this tree "
          f"{mine[0]:.2f} / {mine[1]:.2f} ms on the host clock (order "
          f"--against, this, this, --against)", flush=True)


def compressed_agreement(torch) -> None:
    """Compression on the card against the CPU, on a 2-layer f32 model
    (GQA 8:2, head_dim 64): the CPU's step-0 gradients through both sides'
    quantize_int8 and compressed_psum_tree (a world of one, gloo for CPU
    tensors and NCCL for CUDA ones), equal bit for bit; then 3 compressed
    driver steps on each side from one checkpoint, losses within a derived
    tolerance."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, shrink
    from repro_torch.core.planner import accumulate, loss_and_grads
    from repro_torch.launch import train
    from repro_torch.models.lm import Model
    from repro_torch.optim import grad_compress as gc
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten

    cfg = shrink(get_config(ARCH), n_heads=8, n_kv_heads=2, head_dim=64)
    params = Model(cfg, "cpu").init(0)
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)))
    grads = {}
    for dev in ("cpu", "cuda"):
        _, _, g = loss_and_grads(Model(cfg, dev), _to(params, dev),
                                 {"tokens": tokens.to(dev)})
        grads[dev] = g
    paths, g_cpu = flatten(grads["cpu"])
    g_card = flatten(grads["cuda"])[1]
    worst_g = max(check_close(f"grad {p}", a.cpu(), b, torch.float32, 2e-4)
                  for p, a, b in zip(paths, g_card, g_cpu))
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            out = {}
            for dev in ("cpu", "cuda"):
                g = {p: t.detach().to(dev, copy=True)
                     for p, t in zip(paths, g_cpu)}
                enc = {p: gc.quantize_int8(t) for p, t in g.items()}
                err = gc.init_error_tree(g)
                red, err = gc.compressed_psum_tree(g, None, err)
                out[dev] = (enc, red, err)
            # flips: each side quantising its own step-0 gradients
            own = [gc.quantize_int8(t)[0].cpu() for t in g_card]
        finally:
            dist.destroy_process_group()
    lr_max, steps = 3e-4, 3           # the driver's schedule peaks at --lr
    flips, g_flip = 0, 0.0
    for p, t, q_card in zip(paths, g_cpu, own):
        a, b = out["cuda"][0][p], out["cpu"][0][p]
        for name, x, y in (("q", a[0], b[0]), ("scale", a[1], b[1]),
                           ("residual", a[2], b[2]),
                           ("reduced", out["cuda"][1][p], out["cpu"][1][p]),
                           ("error", out["cuda"][2][p], out["cpu"][2][p])):
            if not same_bits(x.cpu(), y):
                raise AssertionError(f"compression of {p}: {name} differs "
                                     f"between card and cpu")
        flipped = q_card != b[0]
        flips += int(flipped.sum())
        g_flip += float(t.abs()[flipped].sum())
    # a flipped int8 value moves its parameter by at most 2·lr under AdamW
    # (the step is lr·m̂/(√v̂+ε)), so the loss by at most 2·lr·|∂L/∂θ| per
    # flip and step, on top of phase 12's card-vs-CPU limit
    tol = 1e-4 + steps * 2 * lr_max * g_flip
    print(f"[agree] compression of the same step-0 gradients: q, scale, "
          f"residual, reduced gradient and error equal bit for bit on card "
          f"and cpu (12 leaves); the two sides' own gradients differ by "
          f"{worst_g:.3e} and flip {flips} int8 values (sum |grad| there "
          f"{g_flip:.3e})", flush=True)
    init = {"params": params, "opt": adamw().init(params),
            "err": gc.init_error_tree(params)}
    losses = {}
    with tempfile.TemporaryDirectory() as root:
        for dev in ("cpu", "cuda"):
            d = os.path.join(root, dev)
            CheckpointManager(d).save(0, init, extra={"data": {
                "epoch": 0, "step": 0, "seed": 0}})
            losses[dev] = train.main(
                ["--smoke", "--overrides", SMALL, "--batch", "2", "--seq",
                 "128", "--steps", str(steps), "--log-every", "100",
                 "--mesh", "1x1x1", "--compress-pod", "--device", dev,
                 "--ckpt-dir", d])["losses"]
    worst = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"[agree] 3 compressed steps from one checkpoint: card "
          f"{losses['cuda']} vs cpu {losses['cpu']}: max |diff| "
          f"{worst:.3e} (limit 1e-4 + steps·2·lr·sum|grad at flips| = "
          f"{tol:.3e})", flush=True)
    if not worst <= tol:
        raise AssertionError("compressed training: card and cpu losses "
                             "differ beyond the limit")


# ---------------------------------------------------------------------------
# phase 18: the planned training path, and the cost model's predictions
# ---------------------------------------------------------------------------

PLANNED_ARGS = TRAIN_ARGS + ["--auto", "--hw", "h100", "--profile"]


@contextlib.contextmanager
def no_checkpoint_write(written: list):
    """The checkpoint manager's host copy and file write skipped: each
    save appends its step to ``written`` (the gather, a collective, still
    runs)."""
    from repro_torch.ckpt import checkpoint

    saved = (checkpoint.CheckpointManager._write, checkpoint._to_host)
    checkpoint.CheckpointManager._write = \
        lambda self, step, *a: written.append(step)
    checkpoint._to_host = lambda tree: ([], [])
    try:
        yield
    finally:
        checkpoint.CheckpointManager._write, checkpoint._to_host = saved


def train_planned(torch, kernels, losses11: list, serving: dict) -> dict:
    """The driver with ``--auto --hw h100 --profile`` at phase 11's
    configuration, with the launch counts read around it; its choice,
    prediction and calibration report held as the module docstring says,
    and the serving predictions beside phase 7's measured times."""
    from repro_torch.configs import get_config
    from repro_torch.core.auto import auto_parallel
    from repro_torch.core.cost_model import (H100_SXM, DeviceGroup,
                                             decode_step_time,
                                             lm_serving_meta, prefill_time,
                                             step_cost)
    from repro_torch.launch import train
    from repro_torch.models.lm import model_graph

    cfg = get_config(ARCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_planned_")
    written = []
    try:
        reset_counts(kernels)
        # phase 11 writes and times this configuration's checkpoint; here
        # the final one is neither copied to the host nor written
        with no_checkpoint_write(written):
            out = train.main(PLANNED_ARGS + ["--ckpt-dir", tmp])
        counts = read_counts(kernels)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    graph = model_graph(cfg, TRAIN_BATCH, TRAIN_SEQ)
    want = auto_parallel(graph, 1, H100_SXM)
    cost = step_cost(graph.workload_meta(), want, H100_SXM)
    secs = out["step_seconds"][1:]
    med = statistics.median(secs)
    prof = out["profile"]
    print(f"[plan] chosen: {out['strategy']} (auto_parallel on the same "
          f"graph: {want.describe()})", flush=True)
    print(f"[plan] predicted step on the h100 table {cost.total * 1e3:.2f} ms"
          f" (compute {cost.compute * 1e3:.2f}, comm {cost.comm * 1e3:.2f}, "
          f"bubble {cost.bubble * 1e3:.2f}; memory "
          f"{cost.mem_bytes / 2**30:.2f} GiB); measured median of steps "
          f"1-{len(secs)} {med * 1e3:.2f} ms (spread {min(secs) * 1e3:.2f}-"
          f"{max(secs) * 1e3:.2f}); measured / predicted "
          f"{med / cost.total:.3f}; losses "
          f"{[round(x, 4) for x in out['losses']]}; launches {counts}",
          flush=True)
    print("[plan] fitted rates " + ", ".join(
        f"{p} {prof['rates'][p]:.6g} (table {prof['prior_rates'][p]:.6g}, "
        f"confidence {prof['confidence'][p]:.3f})" for p in prof["rates"])
        + f"; {prof['observations']} observations; mean relative "
        f"prediction error {prof['error_before']:.4f} on the table, "
        f"{prof['error_after']:.4f} after the fit", flush=True)
    meta = lm_serving_meta(cfg)
    one = DeviceGroup("h100", H100_SXM, 1)
    pre_ms = prefill_time(meta, one, 500) * 1e3
    dec_ms = decode_step_time(meta, one, 8, serving["live_keys"]) * 1e3

    def beside(ms, busy):
        busy = "not measured" if busy is None else f"{busy:.3f} ms"
        return (f"measured (phase 7) {ms:.2f} ms host clock, device busy "
                f"{busy}")

    print(f"[plan] serving on the h100 table: prefill of one 500-token "
          f"prompt predicted {pre_ms:.3f} ms, "
          f"{beside(serving['prefill_ms'], serving['prefill_busy_ms'])}; "
          f"decode step at 8 slots, {serving['live_keys']:.1f} live keys, "
          f"predicted {dec_ms:.3f} ms, "
          f"{beside(serving['decode_step_ms'], serving['decode_step_busy_ms'])}",
          flush=True)
    if out["strategy"] != want.describe():
        raise AssertionError(f"--auto chose {out['strategy']}, "
                             f"auto_parallel {want.describe()}")
    if out["predicted_step_s"] != cost.total:
        raise AssertionError("the driver's prediction is not step_cost's")
    if prof["observations"] < TRAIN_STEPS - 1 or not prof["report"].strip():
        raise AssertionError(f"profile: {prof['observations']} observations,"
                             f" report {prof['report']!r}")
    if out["final_step"] != TRAIN_STEPS or len(out["losses"]) != TRAIN_STEPS:
        raise AssertionError(f"training stopped at {out['final_step']}")
    check_close("planned losses against phase 11's",
                torch.tensor(out["losses"]), torch.tensor(losses11),
                torch.float32, 1e-4)
    want_counts = train_expected(cfg.n_layers, TRAIN_STEPS, cfg.padded_vocab)
    if counts != want_counts:
        raise AssertionError(f"planned launches {counts}, want {want_counts}")
    return counts


# ---------------------------------------------------------------------------
# phases 19-20: the pipeline engine at full width
# ---------------------------------------------------------------------------

PP_MICRO = 4                    # micro-batches of 1 x TRAIN_SEQ
#: phase 19's cases: each schedule once, on the even and the uneven split
PP_CASES = (("1f1b", (11, 11)), ("gpipe", (12, 10)))
PP_IN_FLIGHT = {"gpipe": [4, 4], "1f1b": [2, 1]}
#: the multi-rank engine's AdamW steps (phases 20-22; step 1 is the first
#: that reads the optimizer's update)
PP_STEPS = 2
#: phase 19's timed calls of each step (after its checked, warm ones)
PP_TIMED = 1
PP_LR = 3e-4                    # constant: every step moves the weights


def pipeline_expected(layers: int, steps: int, vp: int,
                      head: bool = True, micro: int = PP_MICRO,
                      seq: int = TRAIN_SEQ) -> dict:
    """Launches of ``steps`` pipelined steps over ``layers`` attention
    layers (remat full, ``micro`` micro-batches of one row of ``seq``
    tokens): each layer's
    forward twice a micro-batch (its slot and the checkpointed recompute),
    its backward once; the loss head once a micro-batch where ``head``
    (the last stage)."""
    from repro_torch.kernels.xent import xent

    n = micro * steps
    T = seq - 1
    return {"flash_fwd": 2 * layers * n, "paged_decode": 0,
            "flash_bwd_dq": layers * n, "flash_bwd_dkv": layers * n,
            "xent_fwd": n if head else 0,
            "xent_bwd": n * -(-vp // xent.bwd_chunk(T, vp)) if head else 0,
            "ssd_scan": 0, "quantize": 0, "dequantize": 0, "ef_absmax": 0,
            "ef_requant": 0, "ef_decode": 0}


def host_median_s(torch, fn, n: int = 3) -> float:
    """Median wall seconds of ``fn`` over ``n`` calls, each ending in a
    sync."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def pipeline_interpreter(torch, kernels) -> dict:
    """Phase 19 (path A): ``schedule_grads`` at full width on the card,
    all stages in one process, under 1f1b at stage layers (11, 11) and
    gpipe at (12, 10), each held against ``accumulate`` over the same
    micro-batches (the same kernels, unpipelined), with its launch counts,
    buffer audit, peak memory and time beside the cost model's price of a
    two-card pipeline.  Returns one call's launch counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import H100_SXM, StrategySpec, step_cost
    from repro_torch.core.pipeline import schedule_grads
    from repro_torch.core.planner import accumulate
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models.lm import Model, model_graph
    from repro_torch.tree import flatten

    cfg = get_config(ARCH)
    model = Model(cfg)
    params = model.init(0)
    data = TokenPipeline(DataCfg(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 vocab=cfg.vocab, seed=0),
                         host_id=0, n_hosts=1)
    tokens = torch.as_tensor(np.asarray(data.next_batch()["tokens"])).cuda()

    def plain():
        return accumulate(model, params, {"tokens": tokens}, PP_MICRO)

    def piped(sched, sl):
        return schedule_grads(model, params, tokens, micro_batches=PP_MICRO,
                              schedule=sched, stage_layers=sl)

    bf16 = torch.bfloat16
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want_loss, _, want = plain()
    peaks = {"accumulate": torch.cuda.max_memory_allocated() - base}
    paths, want = flatten(want)
    base = torch.cuda.memory_allocated()
    expected = pipeline_expected(cfg.n_layers, 1, cfg.padded_vocab)
    first = None
    for sched, sl in PP_CASES:
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        loss, grads, stats = piped(sched, sl)
        torch.cuda.synchronize()
        counts = read_counts(kernels)
        peaks[sched, sl] = torch.cuda.max_memory_allocated() - base
        first = first or counts
        err_loss = check_close(f"{sched} {sl} loss", loss, want_loss, bf16)
        err_grad = max(check_close(f"{sched} {sl} grad {path}", g, w, bf16,
                                   GRAD_TOL[str(bf16)])
                       for path, g, w in zip(paths, flatten(grads)[1], want))
        del grads
        print(f"[pipe] schedule_grads {sched} stage_layers {sl}: loss "
              f"{float(loss):.6f} vs accumulate {float(want_loss):.6f}, max "
              f"|err| loss {err_loss:.3e}, gradients {err_grad:.3e} (limits "
              f"{TOL[str(bf16)]:g}, {GRAD_TOL[str(bf16)]:g} + same·|x|); "
              f"in flight {stats['per_stage_in_flight']}; ticks "
              f"{stats['n_ticks']}, bubble {stats['bubble_fraction']:.3f}; "
              f"peak above the resident state "
              f"{peaks[sched, sl] / 2**30:.2f} GiB; launches {counts}",
              flush=True)
        if stats["per_stage_in_flight"] != PP_IN_FLIGHT[sched] \
                or stats["stage_layers"] != sl:
            raise AssertionError(f"{sched} {sl}: stats {stats}")
        if counts != expected:
            raise AssertionError(f"{sched} {sl}: launches {counts}, want "
                                 f"{expected}")
    del want
    torch.cuda.empty_cache()
    t_plain = host_median_s(torch, plain, PP_TIMED)
    t_pipe = {sched: host_median_s(torch, lambda s=sched: piped(s, (11, 11)),
                                   PP_TIMED)
              for sched in ("gpipe", "1f1b")}
    prof_ms, busy_ms, _ = profiled(torch, lambda: piped("1f1b", (11, 11)),
                                   1)
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.1f} ms, idle share {1 - busy_ms / prof_ms:.3f}")
    print(f"[pipe] schedule_grads 1f1b under the profiler: {prof_ms:.1f} ms,"
          f" device busy {busy}", flush=True)
    tokens_n = TRAIN_BATCH * TRAIN_SEQ
    print(f"[pipe] one step's forward and backward, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} in {PP_MICRO} micro-batches, median of {PP_TIMED} "
          f"on the host clock (each after the checked runs above): "
          f"accumulate {t_plain * 1e3:.1f} ms "
          f"({tokens_n / t_plain:.1f} tokens/s), schedule_grads gpipe "
          f"{t_pipe['gpipe'] * 1e3:.1f} ms, 1f1b {t_pipe['1f1b'] * 1e3:.1f} "
          f"ms (ratio to accumulate {t_pipe['gpipe'] / t_plain:.3f}, "
          f"{t_pipe['1f1b'] / t_plain:.3f}); peak above the resident state: "
          f"accumulate {peaks['accumulate'] / 2**30:.2f} GiB", flush=True)
    meta = model_graph(cfg, TRAIN_BATCH, TRAIN_SEQ).workload_meta()
    for strat in (StrategySpec(), StrategySpec(pp=2, micro_batches=PP_MICRO),
                  StrategySpec(pp=2, micro_batches=PP_MICRO,
                               schedule="1f1b")):
        c = step_cost(meta, strat, H100_SXM)
        print(f"[pipe] step_cost {strat.describe()} on H100_SXM (a "
              f"prediction, no bound held): {c.total * 1e3:.2f} ms (compute "
              f"{c.compute * 1e3:.2f}, comm {c.comm * 1e3:.2f}, bubble "
              f"{c.bubble * 1e3:.2f}; memory {c.mem_bytes / 2**30:.2f} GiB)",
              flush=True)
    return first


def hetero_spec():
    """Phases 21-22's mixed cluster: one H100 beside one V100 (the
    paper's table), in the cost model's terms."""
    from repro_torch.core.cost_model import (H100_SXM, V100_PAPER,
                                             ClusterSpec, DeviceGroup)

    return ClusterSpec((DeviceGroup("h100", H100_SXM, 1),
                        DeviceGroup("v100", V100_PAPER, 1)))


def peak_blocks(snapshot: dict, skip: int = 0, top: int = 8) -> dict:
    """The allocator trace of ``torch.cuda.memory._snapshot()`` replayed on
    device 0: its allocations and completed frees in order, past its first
    ``skip`` entries (those before this recording began).  Returns
    ``{"peak": the largest sum of bytes allocated since then and still
    live, "sites": [[bytes, blocks, site], …] of the blocks live at that
    moment, largest first}``, each block named by the innermost frame of
    the port's code that allocated it, or where no Python frame did (the
    autograd engine's device thread) by its size."""
    trace = snapshot["device_traces"][0][skip:]
    live, cur, peak, at_peak = {}, 0, 0, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
    sites: dict = {}
    for ev in at_peak.values():
        site = f"no Python frame, {ev['size'] / 2**20:.1f} MiB blocks"
        for fr in ev.get("frames", []):
            name = fr.get("filename", "")
            if "repro_torch" in name:
                site = (f"{name.split('repro_torch/')[-1]}:{fr['line']} "
                        f"{fr['name']}")
                break
        got = sites.setdefault(site, [0, 0, site])
        got[0] += ev["size"]
        got[1] += 1
    return {"peak": peak,
            "sites": sorted(sites.values(), reverse=True)[:top]}


def _pipeline_rank(rank: int, store: str, out_dir: str,
                   hetero: bool = False) -> None:
    """One rank of phase 20 on ``cuda:0``: a gloo world of two over a
    FileStore; the plan's pipelined step under gpipe for one step, then
    under 1f1b for PP_STEPS from the same start, each with its peak memory,
    step times and (1f1b) launch counts; written to ``rank<r>.json``.
    With ``hetero`` (phase 21) only the 1f1b steps, on the stage layers
    that ``compile_plan`` balances over :func:`hetero_spec`."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.pipeline import wire_on_host
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models.lm import Model, model_graph
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import tree_map

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    kernels = kernel_wrappers()
    walk, norms, traced = [], [], {}

    def apply_after_walk(real_apply):
        def apply(*args, grad_norm, **kw):
            # the step's peak so far: its forward and backward walk
            walk.append(torch.cuda.max_memory_allocated())
            norms.append(float(grad_norm))
            if "on" in traced:          # the walk's allocator trace ends
                traced["blocks"] = peak_blocks(torch.cuda.memory._snapshot(),
                                               traced["skip"])
                torch.cuda.memory._record_memory_history(enabled=None)
                del traced["on"]
            return real_apply(*args, grad_norm=grad_norm, **kw)
        return apply

    cfg = get_config(ARCH)
    model = Model(cfg)
    out, init = {}, None
    runs = ((("1f1b", PP_STEPS),) if hetero else
            (("gpipe", 1), ("1f1b", PP_STEPS)))
    try:
        for sched, steps in runs:
            strat = StrategySpec(pp=2, micro_batches=PP_MICRO,
                                 schedule=sched)
            mesh = mesh_for_strategy(strat)
            if hetero:
                plan = compile_plan(
                    model, mesh, strat, cluster_spec=hetero_spec(),
                    workload_meta=model_graph(
                        cfg, TRAIN_BATCH, TRAIN_SEQ).workload_meta(),
                    overlap=0.5)
                out["priced_ms"] = plan.placement.cost.total * 1e3
            else:
                plan = compile_plan(model, mesh, strat)
            out["stage_layers"] = list(plan.stage_layers())
            if init is None:
                init = plan.init_pipeline_params(
                    0, stage_layers=None if hetero else (11, 11))
            params = tree_map(torch.clone, init)
            opt = adamw(lr=PP_LR)
            state = opt.init(params)
            opt = dataclasses.replace(opt,
                                      apply=apply_after_walk(opt.apply))
            step_fn = plan.pipeline_train_step_fn(opt)
            data = TokenPipeline(DataCfg(global_batch=TRAIN_BATCH,
                                         seq_len=TRAIN_SEQ, vocab=cfg.vocab,
                                         seed=0), host_id=0, n_hosts=1)
            group = mesh.get_group("stage")
            out["stage"] = mesh.get_local_rank("stage")
            out["wire"] = (f"{dist.get_backend(group)}, "
                           + ("host copies" if wire_on_host(
                               group, model.device) else "device tensors"))
            torch.cuda.synchronize()
            reset_counts(kernels)
            losses, secs, peaks = [], [], []
            walk.clear()
            norms.clear()
            for i in range(steps):
                toks = torch.as_tensor(
                    np.asarray(data.next_batch()["tokens"])).cuda()
                torch.cuda.reset_peak_memory_stats()
                if i == 0 and not hetero:
                    # which blocks make the walk's peak: the allocator's
                    # trace of step 0's walk (python frames only)
                    torch.cuda.memory._record_memory_history(
                        stacks="python", max_entries=1_000_000)
                    traced["on"] = True
                    traced["skip"] = len(
                        torch.cuda.memory._snapshot()["device_traces"][0])
                t0 = time.perf_counter()
                params, state, m = step_fn(params, state, toks, i)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                peaks.append(torch.cuda.max_memory_allocated())
                losses.append(float(m["loss"]))
            out[sched] = {"losses": losses, "seconds": secs,
                          "counts": read_counts(kernels),
                          "peak": max(peaks), "walk_peak": max(walk),
                          "norms": list(norms),
                          "in_flight": m["peak_in_flight"],
                          "blocks": traced.pop("blocks", None)}
            del params, state, step_fn
        if hetero:
            out["wh"] = _annotated_hetero(torch, plan, mesh, init)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _annotated_hetero(torch, plan, mesh, init: dict) -> dict:
    """Phase 27's hardware-aware annotations in a rank of phase 21: two
    stages recorded on the meta device under ``wh.cluster(mesh,
    spec=hetero_spec())``, each node's stage and the hardware its virtual
    device names; ``compile_nested_plan`` with the workload at TRAIN_BATCH
    x TRAIN_SEQ and overlap 0.5; whether its placement places what phase
    21's ``plan`` does; and one step of it from phase 21's start ``init``
    on the first batch: its loss, clip norm, launches and seconds."""
    import dataclasses

    import numpy as np

    import repro_torch as wh
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models.lm import model_graph
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import tree_map

    kernels = kernel_wrappers()
    cfg = plan.model.cfg
    t0 = time.perf_counter()
    with wh.cluster(mesh=mesh, spec=hetero_spec()) as cl:
        annotate_lm(wh, *meta_inputs(torch, cfg, TRAIN_BATCH), body=(),
                    head=(), stages=(cfg.n_layers // 2,) * 2)
    tags = sorted({(n.stage_index(), n.vdevice.hardware)
                   for n in cl.taskgraph.nodes})
    nested = wh.compile_nested_plan(
        cl, plan.model, workload_meta=model_graph(
            cfg, TRAIN_BATCH, TRAIN_SEQ).workload_meta(), overlap=0.5)
    params = tree_map(torch.clone, init)
    opt = adamw(lr=PP_LR)
    norms = []
    real_apply = opt.apply

    def apply(*args, grad_norm, **kw):
        norms.append(float(grad_norm))
        return real_apply(*args, grad_norm=grad_norm, **kw)

    step_fn = nested.pipeline_train_step_fn(
        dataclasses.replace(opt, apply=apply))
    data = TokenPipeline(DataCfg(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 vocab=cfg.vocab, seed=0), host_id=0,
                         n_hosts=1)
    toks = torch.as_tensor(np.asarray(data.next_batch()["tokens"])).cuda()
    torch.cuda.synchronize()
    reset_counts(kernels)
    _, _, m = step_fn(params, opt.init(params), toks, 0)
    torch.cuda.synchronize()
    return {"tags": tags, "strategy": nested.strategy.describe(),
            "stage_layers": list(nested.stage_layers()),
            "same_placement": placement_key(nested.placement)
            == placement_key(plan.placement),
            "priced_ms": nested.placement.cost.total * 1e3,
            "mem_gib": [p.cost.mem_bytes / 2**30
                        for p in (nested.placement, plan.placement)],
            "loss": float(m["loss"]), "norm": norms[0],
            "counts": read_counts(kernels),
            "total_s": time.perf_counter() - t0}


def _rank_records(out_dir: str, nprocs: int) -> list:
    """The ``rank<r>.json`` records the ranks wrote to ``out_dir``."""
    ranks = []
    for r in range(nprocs):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


#: the pool of rank processes the meshed phases share (main process only)
POOL_RANKS = 4
_POOL = None


def _patch_points() -> list:
    """The entry points a rank function may wrap for its timing or
    recording and leave wrapped (it was written for a process of its own):
    a pooled rank restores them after each task."""
    import torch.distributed as dist

    from repro_torch.ckpt import checkpoint
    from repro_torch.models import moe
    from repro_torch.serving import server as srv

    return ([(dist, n) for n in ("all_reduce", "all_gather", "broadcast",
                                 "reduce_scatter")]
            + [(srv.Server, "admit"), (srv.Server, "step"),
               (checkpoint.CheckpointManager, "_write"),
               (checkpoint.CheckpointManager, "save"), (moe, "_route")])


def _pool_worker(tasks, results) -> None:
    """One pooled rank on ``cuda:0``: runs each task ``(fn, rank, store,
    out_dir, args)`` as ``fn(rank, store, out_dir, *args)`` until it is
    given ``None``, each from the state a freshly spawned process has: the
    launch counts and the peak memory reset before it, the entry points of
    :func:`_patch_points` restored and the allocator's cache released
    after it.  Reports ``(rank, None or traceback, GiB allocated, GiB
    reserved)``, the last two after the cleanup."""
    import gc
    import traceback

    import torch

    torch.cuda.set_device(0)
    torch.cuda.init()
    points = _patch_points()
    kernels = kernel_wrappers()
    try:
        warm_process(torch)
    except Exception:   # noqa: BLE001 -- a cost, not a check: tasks run
        traceback.print_exc()
    while True:
        task = tasks.get()
        if task is None:
            return
        fn, rank, store, out_dir, args = task
        saved = [getattr(o, n) for o, n in points]
        reset_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        err = None
        try:
            fn(rank, store, out_dir, *args)
        except BaseException:   # noqa: BLE001 -- reported to the parent
            err = traceback.format_exc()
        finally:
            for (o, n), v in zip(points, saved):
                setattr(o, n, v)
            gc.collect()
            torch.cuda.empty_cache()
        results.put((rank, err, torch.cuda.memory_allocated() / 2**30,
                     torch.cuda.memory_reserved() / 2**30))


def warm_process(torch) -> None:
    """Pay here what a fresh process pays in its first step: the modules
    a first checkpointed backward imports (``torch.utils.checkpoint``'s
    policies bring in ``torch._dynamo``, sympy and
    ``torch.distributed.fsdp``, seconds on a machine that compiles their
    bytecode as it imports them), through one step of a model of a few
    thousand parameters on the host; then cuBLAS and the generator on the
    card in both dtypes.  It launches none of the port's kernels: their
    library may still be building."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.planner import loss_and_grads
    from repro_torch.models.lm import Model

    cfg = dataclasses.replace(get_config(ARCH), n_layers=1, d_model=64,
                              n_heads=4, n_kv_heads=2, head_dim=16,
                              d_ff=128, vocab=256)
    model = Model(cfg, "cpu")
    loss_and_grads(model, model.init(0),
                   {"tokens": torch.zeros((1, 16), dtype=torch.long)})
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn(256, 256, device="cuda", dtype=dtype)
        (a @ a).sum().item()


class RankPool:
    """``n`` processes spawned once, each opening ``cuda:0``, that run
    rank functions one task after another: a task of k ranks goes to the
    first k.  Spawning two ranks anew took 10.7–13.8 s on an NVIDIA H100
    80GB HBM3 (700 W), most of it each process reaching the card; the
    one pool (:func:`start_pool`, :func:`spawn_ranks`) is started before
    the kernels build, so that its ranks reach the card and import what
    their tasks need (:func:`warm_process`) while nvcc runs, and it serves
    every meshed phase.  Its ranks map device memory in
    growable segments (``expandable_segments``): what one rank frees is
    not stranded in a block the rank beside it cannot use, and the
    largest parts (deepseek's and jamba's pipeline stages, 32 GiB a rank)
    fit beside the idle ranks' contexts."""

    def __init__(self, n: int = POOL_RANKS):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.tasks = [ctx.SimpleQueue() for _ in range(n)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_pool_worker,
                                  args=(self.tasks[r], self.results),
                                  daemon=True) for r in range(n)]
        conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            for p in self.procs:
                p.start()
        finally:
            if conf is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf

    def run(self, fn, args: tuple, nprocs: int, timeout: float) -> list:
        import queue

        if nprocs > len(self.procs):
            raise ValueError(f"{nprocs} ranks, the pool holds "
                             f"{len(self.procs)}")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
        try:
            for r in range(nprocs):
                self.tasks[r].put((fn, r, os.path.join(tmp, "store"), tmp,
                                   args))
            deadline = time.monotonic() + timeout
            errs, done, held = {}, set(), {}
            while len(done) < nprocs:
                left = deadline - time.monotonic()
                if left <= 0 or not all(p.is_alive() for p in self.procs):
                    # a hung rank (or the peers of a failed one, waiting
                    # in a collective): the pool goes with it
                    self.close()
                    errs["pool"] = (f"a rank did not finish in {timeout} s"
                                    if left <= 0 else
                                    "a pooled rank process died")
                    break
                try:
                    r, err, *mem = self.results.get(timeout=min(left, 2.0))
                except queue.Empty:
                    continue
                done.add(r)
                held[r] = mem
                if err:
                    errs[r] = err
                    deadline = min(deadline, time.monotonic() + 30)
            if errs:
                raise AssertionError("rank(s) failed:\n" + "\n".join(
                    f"rank {r}: {e}" for r, e in errs.items()))
            print(f"[pool] {fn.__name__} on {nprocs} pooled ranks: GiB "
                  f"allocated, reserved after it "
                  f"{[[round(x, 3) for x in held[r]] for r in sorted(held)]}",
                  flush=True)
            return _rank_records(tmp, nprocs)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def close(self) -> None:
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


def close_pool() -> None:
    """Stop the pool's processes (the next meshed phase starts a new
    one)."""
    global _POOL
    if _POOL is not None:
        pool, _POOL = _POOL, None
        pool.close()


def start_pool() -> None:
    """Start the pool (:class:`RankPool`) unless it runs: its ranks reach
    the card while this process goes on."""
    global _POOL
    if _POOL is not None and not all(p.is_alive() for p in _POOL.procs):
        close_pool()                     # stopped by a rank that hung
    if _POOL is None:
        import atexit

        _POOL = RankPool()
        atexit.register(close_pool)


def spawn_ranks(fn, *args, timeout: float = 600, nprocs: int = 2) -> list:
    """Run ``fn(rank, store, out_dir, *args)`` on ``nprocs`` ranks of the
    pool (:func:`start_pool`; each rank on ``cuda:0``), and return their
    ``rank<r>.json`` records; a rank that fails or outlives ``timeout``
    seconds fails the phase (the pool is stopped where a rank hangs)."""
    start_pool()
    return _POOL.run(fn, args, nprocs, timeout)


def pipeline_engine(torch) -> tuple:
    """Phase 20 (path B): the multi-rank engine through the plan on two
    processes sharing ``cuda:0`` over gloo (NCCL refuses two ranks on one
    card), then the same PP_STEPS AdamW steps here through the unpipelined
    ``train_step_fn`` from the same seed; returns the ranks' summed 1f1b
    launch counts and the unpipelined losses."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.planner import compile_plan
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import adamw, global_norm

    cfg = get_config(ARCH)
    ranks = spawn_ranks(_pipeline_rank)
    ranks.sort(key=lambda x: x["stage"])

    # the unpipelined step on the same card, from the same seed and data
    model = Model(cfg)
    params = model.init(0)
    opt = adamw(lr=PP_LR)
    state = opt.init(params)
    norms = []

    def apply(grads, *args, **kw):
        norms.append(float(global_norm(grads)))
        return adamw_apply(grads, *args, **kw)

    adamw_apply = opt.apply
    opt = dataclasses.replace(opt, apply=apply)
    step_fn = compile_plan(model, None).train_step_fn(
        opt, micro_batches=PP_MICRO)
    data = TokenPipeline(DataCfg(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 vocab=cfg.vocab, seed=0),
                         host_id=0, n_hosts=1)
    want, secs = [], []
    for i in range(PP_STEPS):
        batch = {"tokens": torch.as_tensor(
            np.asarray(data.next_batch()["tokens"])).cuda()}
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch, i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        want.append(float(m["loss"]))
    del params, state
    torch.cuda.empty_cache()

    print(f"[pipe] wire: 2 ranks on 1 card ({ranks[0]['wire']}); "
          f"activations and cotangents cross through host memory",
          flush=True)
    expected = {0: pipeline_expected(11, PP_STEPS, cfg.padded_vocab,
                                     head=False),
                1: pipeline_expected(11, PP_STEPS, cfg.padded_vocab)}
    for s, r in enumerate(ranks):
        print(f"[pipe] stage {s}: 1f1b losses {r['1f1b']['losses']}, step "
              f"seconds {[round(x, 3) for x in r['1f1b']['seconds']]} (two "
              f"processes time-slice one card and cross host memory: no "
              f"throughput); peak device memory of the forward and "
              f"backward walk gpipe {r['gpipe']['walk_peak'] / 2**30:.3f} "
              f"GiB, 1f1b {r['1f1b']['walk_peak'] / 2**30:.3f} GiB, of the "
              f"whole step (AdamW's temporaries) gpipe "
              f"{r['gpipe']['peak'] / 2**30:.3f}, 1f1b "
              f"{r['1f1b']['peak'] / 2**30:.3f} GiB; in flight gpipe "
              f"{r['gpipe']['in_flight']}, 1f1b {r['1f1b']['in_flight']}; "
              f"launches {r['1f1b']['counts']}", flush=True)
        for sched in ("gpipe", "1f1b"):
            b = r[sched]["blocks"]
            print(f"[pipe] stage {s} {sched} step 0: the walk's peak "
                  f"{b['peak'] / 2**30:.3f} GiB above the state held when "
                  f"the allocator's trace began; live there, by the port's "
                  f"allocating line (GiB, blocks): "
                  + "; ".join(f"{site} {n / 2**30:.3f} ({k})"
                              for n, k, site in b["sites"]), flush=True)
        if r["1f1b"]["in_flight"] != PP_IN_FLIGHT["1f1b"][s] or \
                r["gpipe"]["in_flight"] != PP_IN_FLIGHT["gpipe"][s]:
            raise AssertionError(f"stage {s}: buffer audit {r}")
        if r["1f1b"]["counts"] != expected[s]:
            raise AssertionError(f"stage {s}: launches "
                                 f"{r['1f1b']['counts']}, want {expected[s]}")
        if r["1f1b"]["losses"] != ranks[0]["1f1b"]["losses"]:
            raise AssertionError("the stages report different losses")
    got = ranks[0]["1f1b"]["losses"]
    print(f"[pipe] {PP_STEPS} AdamW steps: pipelined 1f1b {got} vs "
          f"unpipelined train_step_fn {want} (step seconds "
          f"{[round(x, 3) for x in secs]})", flush=True)
    worst = check_close("pipelined losses against the unpipelined step",
                        torch.tensor(got), torch.tensor(want), torch.float32,
                        1e-4)
    print(f"[pipe] max |diff| {worst:.3e} (limit 1e-4 + 1e-4|x|); the "
          f"global norm AdamW clips by, summed stage by stage "
          f"{ranks[0]['1f1b']['norms']} vs over the whole tree {norms}",
          flush=True)
    if ranks[0]["1f1b"]["walk_peak"] > ranks[0]["gpipe"]["walk_peak"]:
        raise AssertionError("1f1b's stage 0 holds more memory than gpipe's")
    return {k: ranks[0]["1f1b"]["counts"][k] + ranks[1]["1f1b"]["counts"][k]
            for k in expected[0]}, want


# ---------------------------------------------------------------------------
# phases 21-22: heterogeneous placement
# ---------------------------------------------------------------------------

HETERO_LAYERS = (19, 3)         # the plan's stage layers at full depth
HETERO_PRICED_MS = 216.59       # its priced step (1f1b, overlap 0.5)
UNEVEN_LAYERS = 4               # a depth at which the plan balances (7, 1)
UNEVEN_BATCH = 8
UNEVEN_SHARES = (7, 1)


def hetero_pipeline(torch, want: list) -> dict:
    """Phase 21: the stage layers ``compile_plan`` balances over one H100
    and one V100, through the multi-rank engine on two processes sharing
    ``cuda:0`` over gloo (phase 20's way), PP_STEPS 1f1b AdamW steps held
    against phase 20's unpipelined losses ``want`` (the same seed, data
    and micro-batches), then phase 27's hardware-aware annotations on the
    same ranks; returns the ranks' summed launch counts of each."""
    from repro_torch.configs import get_config

    vp = get_config(ARCH).padded_vocab
    ranks = spawn_ranks(_pipeline_rank, True, timeout=300)
    ranks.sort(key=lambda x: x["stage"])
    sl = tuple(ranks[0]["stage_layers"])
    expected = {0: pipeline_expected(sl[0], PP_STEPS, vp, head=False),
                1: pipeline_expected(sl[1], PP_STEPS, vp)}
    print(f"[hetero] compile_plan(StrategySpec(pp=2, micro_batches="
          f"{PP_MICRO}, schedule='1f1b'), cluster_spec=h100 x1 + v100 x1, "
          f"workload_meta at {TRAIN_BATCH} x {TRAIN_SEQ}, overlap=0.5): "
          f"stage layers {sl}, priced step {ranks[0]['priced_ms']:.2f} ms "
          f"(a prediction for a real H100 + V100 pair; no bound held)",
          flush=True)
    if sl != HETERO_LAYERS or round(ranks[0]["priced_ms"], 2) \
            != HETERO_PRICED_MS:
        raise AssertionError(f"plan {sl}, {ranks[0]['priced_ms']} ms; want "
                             f"{HETERO_LAYERS}, {HETERO_PRICED_MS} ms")
    for s, r in enumerate(ranks):
        run = r["1f1b"]
        print(f"[hetero] stage {s} ({sl[s]} layers): losses "
              f"{run['losses']}, step seconds "
              f"{[round(x, 3) for x in run['seconds']]} (two processes "
              f"time-slice one card: no throughput); peak device memory "
              f"of the walk {run['walk_peak'] / 2**30:.3f} GiB, of the "
              f"step {run['peak'] / 2**30:.3f} GiB; in flight "
              f"{run['in_flight']}; launches {run['counts']}", flush=True)
        if run["in_flight"] != PP_IN_FLIGHT["1f1b"][s]:
            raise AssertionError(f"stage {s}: buffer audit {run}")
        if run["counts"] != expected[s]:
            raise AssertionError(f"stage {s}: launches {run['counts']}, "
                                 f"want {expected[s]}")
        if run["losses"] != ranks[0]["1f1b"]["losses"]:
            raise AssertionError("the stages report different losses")
    want_tags = [[s, g.hw.name] for s, g in enumerate(hetero_spec().groups)]
    for s, r in enumerate(ranks):
        o = r["wh"]
        print(f"[wh] hardware-aware annotations, stage {s}: (stage, "
              f"hardware) tags of the recorded nodes {o['tags']}; "
              f"compile_nested_plan: {o['strategy']}, stage layers "
              f"{o['stage_layers']}, priced step {o['priced_ms']:.2f} ms, "
              f"placement (stage layers, shares, every priced time) equal "
              f"to phase 21's {o['same_placement']}; its memory term "
              f"{o['mem_gib'][0]:.3f} GiB beside phase 21's "
              f"{o['mem_gib'][1]:.3f} (the annotations name no schedule: "
              f"gpipe's in-flight micro-batches against 1f1b's); one step "
              f"from the same start: loss "
              f"{o['loss']} and clip norm {o['norm']} against phase 21's "
              f"step 0 {r['1f1b']['losses'][0]}, {r['1f1b']['norms'][0]}; "
              f"launches {o['counts']}; {o['total_s']:.2f} s in all",
              flush=True)
        exp = pipeline_expected(sl[s], 1, vp, head=s == 1)
        if o["tags"] != want_tags or not o["same_placement"] \
                or o["loss"] != r["1f1b"]["losses"][0] \
                or o["norm"] != r["1f1b"]["norms"][0] or o["counts"] != exp:
            raise AssertionError(f"stage {s}: the annotated plan {o}")
    annotated = {k: ranks[0]["wh"]["counts"][k] + ranks[1]["wh"]["counts"][k]
                 for k in expected[0]}
    got = ranks[0]["1f1b"]["losses"]
    worst = check_close("planned-stage losses against the unpipelined step",
                        torch.tensor(got), torch.tensor(want), torch.float32,
                        1e-4)
    print(f"[hetero] {PP_STEPS} AdamW steps on {sl}: {got} vs unpipelined "
          f"{want}, max |diff| {worst:.3e} (limit 1e-4 + 1e-4|x|); the "
          f"clip norm summed stage by stage {ranks[0]['1f1b']['norms']}",
          flush=True)
    return {k: ranks[0]["1f1b"]["counts"][k] + ranks[1]["1f1b"]["counts"][k]
            for k in expected[0]}, annotated


def _uneven_rank(rank: int, store: str, out_dir: str, ref_grads: str
                 ) -> None:
    """One rank of phase 22 on ``cuda:0``: a gloo world of two; the plan
    ``compile_plan`` balances over :func:`hetero_spec` at ``dp=2`` deals
    this rank its share of each batch; PP_STEPS AdamW steps with its
    launch counts, step times (step 0's with rank 0's copy of its
    gradient to the host) and peak memory; rank 0 saves the step-0
    gradient it hands the optimizer to ``ref_grads``; then one timed gloo
    all-reduce of a gradient-shaped tree."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models.lm import Model, model_graph
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    kernels = kernel_wrappers()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=UNEVEN_LAYERS)
    model = Model(cfg)
    strat = StrategySpec(dp=2)
    try:
        mesh = mesh_for_strategy(strat, cluster_spec=hetero_spec())
        plan = compile_plan(model, mesh, strat, cluster_spec=hetero_spec(),
                            workload_meta=model_graph(
                                cfg, UNEVEN_BATCH, TRAIN_SEQ).workload_meta(),
                            overlap=0.5)
        params = plan.init_params(0)
        opt = adamw(lr=PP_LR)
        state = opt.init(params)
        real_apply = opt.apply
        first, walk = {}, []

        def apply(grads, *args, **kw):
            walk.append(torch.cuda.max_memory_allocated())
            if rank == 0 and not first:
                first.update((k, v.cpu()) for k, v in zip(*flatten(grads)))
            return real_apply(grads, *args, **kw)

        step_fn = plan.train_step_fn(dataclasses.replace(opt, apply=apply))
        data = TokenPipeline(DataCfg(global_batch=UNEVEN_BATCH,
                                     seq_len=TRAIN_SEQ, vocab=cfg.vocab,
                                     seed=0), host_id=0, n_hosts=1)
        torch.cuda.synchronize()
        reset_counts(kernels)
        losses, secs, peaks = [], [], []
        for i in range(PP_STEPS):
            batch = plan.batch_slice({"tokens": torch.as_tensor(
                np.asarray(data.next_batch()["tokens"]))})
            batch = {k: v.cuda() for k, v in batch.items()}
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batch, i)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated())
            losses.append(float(m["loss"]))
        if rank == 0:
            torch.save(first, ref_grads)
            first.clear()
        out = {"shares": list(plan.placement.batch_shares),
               "rows": plan.replica_rows()[rank],
               "priced_ms": plan.placement.cost.total * 1e3,
               "losses": losses, "tokens": float(m["tokens"]),
               "seconds": secs, "peak": max(peaks), "walk": max(walk),
               "counts": read_counts(kernels)}
        del state
        leaves = flatten(params)[1]
        out["reduce_bytes"] = sum(p.numel() * 4 for p in leaves)
        bufs = [torch.ones_like(p, dtype=torch.float32) for p in leaves]
        del params, leaves
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bufs:
            dist.all_reduce(b)
        torch.cuda.synchronize()
        out["reduce_s"] = time.perf_counter() - t0
        if not all(bool((b == 2).all()) for b in bufs):
            raise AssertionError("the timed all-reduce summed wrong")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def one_process(torch, split: bool) -> dict:
    """Phase 22's references, in this process: PP_STEPS AdamW steps of
    the UNEVEN_LAYERS-layer model from seed 0 on each batch of
    UNEVEN_BATCH rows, either whole (one gradient over all rows) or ``split`` into the
    planned shares, each share's gradient taken alone and the shares
    summed with the token weights the data-parallel step uses (the ranks'
    arithmetic without their collectives).  Returns the losses, the step-0
    gradient on the host, step seconds and the peaks of the walk and of
    the step."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.planner import loss_and_grads
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten, unflatten

    cfg = dataclasses.replace(get_config(ARCH), n_layers=UNEVEN_LAYERS)
    model = Model(cfg)
    params = model.init(0)
    opt = adamw(lr=PP_LR)
    state = opt.init(params)
    data = TokenPipeline(DataCfg(global_batch=UNEVEN_BATCH, seq_len=TRAIN_SEQ,
                                 vocab=cfg.vocab, seed=0),
                         host_id=0, n_hosts=1)
    bounds, lo = [], 0
    for n in (UNEVEN_SHARES if split else (UNEVEN_BATCH,)):
        bounds.append((lo, lo + n))
        lo += n
    out = {"losses": [], "seconds": [], "walk": 0, "peak": 0}
    for i in range(PP_STEPS):
        toks = torch.as_tensor(np.asarray(data.next_batch()["tokens"])).cuda()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        parts = [loss_and_grads(model, params, {"tokens": toks[a:b]})
                 for a, b in bounds]
        if split:
            n = [m["tokens"].float() for _, m, _ in parts]
            total = sum(n[1:], n[0]).clamp_min(1.0)
            w = [x / total for x in n]
            paths = flatten(parts[0][2])[0]
            grads = unflatten(paths, [
                sum((flatten(g)[1][j] * wi for (_, _, g), wi
                     in zip(parts[1:], w[1:])), flatten(parts[0][2])[1][j]
                    * w[0]) for j in range(len(paths))])
            loss = sum((l.float() * wi for (l, _, _), wi in zip(parts, w)))
        else:
            loss, _, grads = parts[0]
        del parts
        out["walk"] = max(out["walk"], torch.cuda.max_memory_allocated())
        if i == 0:
            out["grads"] = {k: v.cpu() for k, v in zip(*flatten(grads))}
        params, state = opt.apply(grads, state, params, i)
        del grads
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(loss))
        out["peak"] = max(out["peak"], torch.cuda.max_memory_allocated())
    del params, state
    torch.cuda.empty_cache()
    return out


def uneven_dp(torch) -> dict:
    """Phase 22: the batch shares ``compile_plan`` balances over one H100
    and one V100 at ``dp=2`` (tinyllama at full width, 4 layers), rank 0
    training on 7 rows of each batch of 8 and rank 1 on 1, against two
    references run here first and freed before the ranks start
    (:func:`one_process`): all 8 rows whole, the step-0 loss within phase
    20's limit and every step-0 gradient leaf within bf16's; and the same
    shares' token-weighted sum, the losses of every step within phase
    20's limit and the step-0 gradients within bf16's.  Returns the
    ranks' summed launch counts."""
    from repro_torch.configs import get_config

    refs = {}
    for name, split in (("whole", False), ("split", True)):
        refs[name] = r = one_process(torch, split)
        print(f"[uneven] one process, {UNEVEN_LAYERS} layers, {name} "
              f"{UNEVEN_SHARES if split else UNEVEN_BATCH} rows: losses "
              f"{r['losses']}, step seconds "
              f"{[round(x, 3) for x in r['seconds']]}, peak device memory "
              f"of the walk {r['walk'] / 2**30:.3f} GiB, of the step "
              f"{r['peak'] / 2**30:.3f} GiB", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_uneven_")
    try:
        path = os.path.join(tmp, "grads.pt")
        ranks = spawn_ranks(_uneven_rank, path, timeout=300)
        got = torch.load(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bf16 = torch.bfloat16
    grad_err = {}
    for name, r in refs.items():
        worst = worst_rel = 0.0
        for k, w in r.pop("grads").items():
            g, w = got[k].cuda(), w.cuda()
            worst = max(worst, check_close(
                f"uneven step-0 grad {k} against {name}", g, w, bf16,
                GRAD_TOL[str(bf16)]))
            worst_rel = max(worst_rel, float((g - w).abs().max()
                                             / w.abs().max().clamp_min(1e-30)))
        grad_err[name] = (worst, worst_rel)
    del got
    vp = get_config(ARCH).padded_vocab
    for r, out in enumerate(ranks):
        exp = train_expected(UNEVEN_LAYERS, PP_STEPS, vp, rows=out["rows"])
        print(f"[uneven] rank {r}: {out['rows']} of each batch's "
              f"{UNEVEN_BATCH} rows, losses {out['losses']}, step seconds "
              f"{[round(x, 3) for x in out['seconds']]} (two processes "
              f"time-slice one card, gradients summed by gloo through host "
              f"memory: no throughput); peak device memory of the walk "
              f"{out['walk'] / 2**30:.3f} GiB, of the step "
              f"{out['peak'] / 2**30:.3f} GiB; launches {out['counts']}",
              flush=True)
        if out["counts"] != exp:
            raise AssertionError(f"rank {r}: launches {out['counts']}, want "
                                 f"{exp}")
        if out["losses"] != ranks[0]["losses"]:
            raise AssertionError("the ranks report different losses")
    shares = tuple(ranks[0]["shares"])
    print(f"[uneven] compile_plan(StrategySpec(dp=2), cluster_spec=h100 x1 "
          f"+ v100 x1, workload_meta at {UNEVEN_BATCH} x {TRAIN_SEQ}, "
          f"overlap=0.5): batch shares {shares}, priced step "
          f"{ranks[0]['priced_ms']:.2f} ms (a prediction for a real pair; "
          f"no bound held); gloo all-reduce of "
          f"{ranks[0]['reduce_bytes'] / 1e9:.3f} GB of f32 gradient leaves "
          f"from the card through host memory: "
          f"{ranks[0]['reduce_s']:.3f} s, {ranks[1]['reduce_s']:.3f} s",
          flush=True)
    if shares != UNEVEN_SHARES or [o["rows"] for o in ranks] \
            != list(UNEVEN_SHARES):
        raise AssertionError(f"shares {shares}, rows "
                             f"{[o['rows'] for o in ranks]}")
    got = torch.tensor(ranks[0]["losses"])
    diff = {k: [abs(a - b) for a, b in zip(ranks[0]["losses"], r["losses"])]
            for k, r in refs.items()}
    diff["split-whole"] = [abs(a - b) for a, b in zip(
        refs["split"]["losses"], refs["whole"]["losses"])]
    check_close("uneven-share losses against the split reference", got,
                torch.tensor(refs["split"]["losses"]), torch.float32, 1e-4)
    check_close("uneven-share step-0 loss against all rows whole", got[:1],
                torch.tensor(refs["whole"]["losses"][:1]), torch.float32,
                1e-4)
    print(f"[uneven] {PP_STEPS} AdamW steps, |diff| of the losses by step: "
          f"ranks against the split reference {diff['split']}, against all "
          f"rows whole {diff['whole']} (held at step 0; limit 1e-4 + "
          f"1e-4|x|), the split reference against whole "
          f"{diff['split-whole']}; step-0 gradients max |diff| (limit "
          f"{GRAD_TOL[str(bf16)]:g} + same·|x|) and max relative to each "
          f"leaf's max: against split {grad_err['split'][0]:.3e}, "
          f"{grad_err['split'][1]:.3e}; against whole "
          f"{grad_err['whole'][0]:.3e}, {grad_err['whole'][1]:.3e}; tokens "
          f"summed over the ranks {ranks[0]['tokens']:.0f}", flush=True)
    return {k: ranks[0]["counts"][k] + ranks[1]["counts"][k]
            for k in ranks[0]["counts"]}


# ---------------------------------------------------------------------------
# phases 23-24: tensor parallelism and ZeRO
# ---------------------------------------------------------------------------

TP_BATCH = 2                    # phase 23: batch 2 x TRAIN_SEQ, 2 steps
TP_STEPS = 2
#: phase 23's runs: name -> (layers, activation dtype); bf16 at 4 layers
#: is the path (cut from 22 to hold the script's time: the split step is
#: the same at every depth), f32 at 2 layers holds it to f32's limits
TP_RUNS = {"bf16": (4, "bfloat16"), "f32": (2, "float32")}
TP_LATER_LIMIT = 2e-2           # |loss diff| at steps 1-2 (PERF.md, PR 22)
TP_F32_LIMIT = 1e-4
ZERO_LAYERS = 1                 # phase 24: depth cut (gloo through host)
ZERO_BATCH = 2                  # one row a data replica
ZERO_SEQ = 1024                 # phase 24's sequence (cut to save time)
ZERO_STEPS = 2
ZERO_STAGES = (0, 1, 3)


def time_collectives(torch, dist, stats: dict) -> None:
    """Wrap this process's ``torch.distributed`` collectives so each call
    adds its wall seconds (the card synchronized before and after) to
    ``stats["s"]`` and one to ``stats["n"]``: the gloo seconds of a step."""
    for name in ("all_reduce", "all_gather", "broadcast", "reduce_scatter"):
        real = getattr(dist, name)

        def timed(*a, _real=real, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            torch.cuda.synchronize()
            stats["s"] += time.perf_counter() - t0
            stats["n"] += 1
            return out

        setattr(dist, name, timed)


def check_xent_shard(torch) -> None:
    """Phase 3's loss head on a vocab shard, as the tensor-parallel path
    runs it: the forward kernel on tinyllama's second column half at tp 2
    (c0 = 16000, 16000 columns, T = 2·2047) with the labels shifted by
    -c0, labels on both sides of the shard, against its plain version;
    then the backward pass on one chunk of the shard with the global lse
    and ``col0 = c0 + chunk offset``, against its plain version.  The
    same on mamba2-1.3b's tied head at tp 2 (c0 = 25216 of 50432 columns,
    vocab 50280: the shard holds the padding), whose forward is also held
    against a second launch bit for bit, and on jamba-v0.1-52b's head at
    tp 2 (E = 4096, 32768 of 65536 columns)."""
    for V, Vp, E in ((32000, 32000, 2048), (MAMBA_VOCAB, MAMBA_VP, 2048),
                     (65536, 65536, 4096)):
        _xent_shard(torch, V, Vp, E)


def _xent_shard(torch, V: int, Vp: int, E: int) -> None:
    from repro_torch.kernels.xent import xent

    gen = torch.Generator(device="cuda").manual_seed(23)
    c0 = Vp // 2
    Vs = Vp // 2
    T = TP_BATCH * (TRAIN_SEQ - 1)
    h = torch.randn((T, E), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((E, Vs), generator=gen, device="cuda")
         / math.sqrt(E)).bfloat16()
    labels = torch.randint(0, V, (T,), generator=gen, device="cuda",
                           dtype=torch.int32)
    labels[:3] = torch.tensor([5, c0 + 7, V - 1], dtype=torch.int32)
    local = labels - c0
    nll, lse = xent.xent_fwd(h, w, local, V - c0)
    again = xent.xent_fwd(h, w, local, V - c0)
    want = xent.xent_fwd_plain(h, w, local, V - c0)
    torch.cuda.synchronize()
    tag = f"xent_fwd vocab shard c0={c0} Vs={Vs} T={T} E={E} bf16"
    err = max(check_close(tag + " nll", nll, want[0], torch.float32),
              check_close(tag + " lse", lse, want[1], torch.float32))
    assert_same_bits(tag, (nll, lse), again)
    own = int(((local >= 0) & (local < Vs)).sum())
    print(f"[kernel] {tag}: max_abs_err {err:.3e} (tol 2e-05); {own} of "
          f"{T} labels inside the shard", flush=True)
    chunk = xent.bwd_chunk(T, Vs)
    j = chunk                          # the shard's second chunk
    C = min(chunk, Vs - j)
    logits = h[:, :].float() @ w[:, j:j + C].float()
    g_nll = torch.rand((T,), generator=gen, device="cuda")
    g_lse = torch.rand((T,), generator=gen, device="cuda") * 1e-3
    glob = lse + 0.5                    # a global lse above the shard's
    args = (glob, labels, g_nll, g_lse, c0 + j, V)
    got = xent.xent_bwd(logits.clone(), *args)
    want = xent.xent_bwd_plain(logits.clone(), *args)
    torch.cuda.synchronize()
    tag = f"xent_bwd vocab shard chunk={C} col0={c0 + j} vocab={V} f32"
    err = check_close(tag, got, want, torch.float32)
    print(f"[kernel] {tag}: max_abs_err {err:.3e} (tol 2e-05)", flush=True)


def _tp_cfg(name: str):
    import dataclasses

    from repro_torch.configs import get_config

    layers, dtype = TP_RUNS[name]
    return dataclasses.replace(get_config(ARCH), n_layers=layers,
                               dtype=dtype)


def _tp_steps(torch, plan, first: dict, stats: dict | None = None,
              micro_batches: int = 1) -> dict:
    """TP_STEPS AdamW steps (a constant PP_LR) of ``plan`` from seed 0 on
    the driver's stream of TP_BATCH x TRAIN_SEQ batches: losses, step
    seconds, peaks, and with ``stats`` the gloo seconds of each step;
    ``first`` gets the step-0 gradient (this rank's blocks) on the host."""
    import dataclasses

    import numpy as np

    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten

    params = plan.init_params(0)
    opt = adamw(lr=PP_LR)
    state = plan.init_opt(opt, params)
    real_apply = opt.apply

    def apply(grads, *args, **kw):
        if not first:
            first.update((k, v.cpu()) for k, v in zip(*flatten(grads)))
        return real_apply(grads, *args, **kw)

    step_fn = plan.train_step_fn(dataclasses.replace(opt, apply=apply),
                                 micro_batches=micro_batches)
    data = TokenPipeline(DataCfg(global_batch=TP_BATCH, seq_len=TRAIN_SEQ,
                                 vocab=plan.model.cfg.vocab, seed=0),
                         host_id=0, n_hosts=1)
    out = {"losses": [], "seconds": [], "peaks": [], "gloo_s": []}
    for i in range(TP_STEPS):
        batch = plan.batch_slice({"tokens": torch.as_tensor(
            np.asarray(data.next_batch()["tokens"])).cuda()})
        torch.cuda.reset_peak_memory_stats()
        s0 = stats["s"] if stats else 0.0
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch, i)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["gloo_s"].append((stats["s"] if stats else 0.0) - s0)
        out["peaks"].append(torch.cuda.max_memory_allocated())
        out["losses"].append(float(m["loss"]))
    return out


def _tp_rank(rank: int, store: str, out_dir: str, ref_dir: str) -> None:
    """One rank of phase 23 on ``cuda:0``: a gloo world of two, the plan
    ``StrategySpec(tp=2)`` on data 1 x model 2, each of TP_RUNS through
    :func:`_tp_steps` (the bf16 run with its launch counts); this rank's
    step-0 gradient blocks against the same blocks of the unsharded
    gradient in ``ref_dir/<run>.pt`` (max |diff| and max |ref| per
    leaf)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import sharding
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.models.lm import Model
    from repro_torch.tree import flatten

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    kernels = kernel_wrappers()
    stats = {"s": 0.0, "n": 0}
    strat = StrategySpec(tp=2)
    out = {}
    try:
        mesh = mesh_for_strategy(strat)
        time_collectives(torch, dist, stats)
        for name in TP_RUNS:
            plan = compile_plan(Model(_tp_cfg(name)), mesh, strat)
            first = {}
            torch.cuda.synchronize()
            reset_counts(kernels)
            n0 = stats["n"]
            run = _tp_steps(torch, plan, first, stats)
            run["counts"] = read_counts(kernels)
            run["collectives"] = stats["n"] - n0
            ref = torch.load(os.path.join(ref_dir, f"{name}.pt"), mmap=True)
            specs = dict(zip(*flatten(plan.param_specs)))
            run["grads"] = {}
            for path, g in first.items():
                w = sharding.shard_leaf(ref[path], specs[path], plan.rules)
                run["grads"][path] = [float((g - w).abs().max()),
                                      float(w.abs().max())]
            run["local_params"] = sum(p.numel() for p in first.values())
            run["model_rank"] = plan.rules.index("model")
            out[name] = run
            del ref, first, plan
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def train_tp(torch) -> dict:
    """Phase 23: ``split×2``.  For each of TP_RUNS (bf16 at full width and
    8 layers, the path; f32 at 2 layers, the agreement) one process runs the
    unsharded step here first (the same seed and batches) and saves its
    step-0 gradient; then two ranks on ``cuda:0`` over gloo train the
    same steps through ``compile_plan(StrategySpec(tp=2))``.  Everything
    is printed before it is held: bf16, the step-0 loss within 2e-2 +
    2e-2|x|, each step-0 gradient leaf within 5e-2 of the leaf's max, the
    losses of steps 1-2 within TP_LATER_LIMIT; f32, every loss within
    TP_F32_LIMIT + TP_F32_LIMIT|x| and each step-0 gradient leaf within
    2e-4 of the leaf's max; the ranks' losses equal; each rank's bf16
    launches those of one model's steps on its vocab shard.  Returns the
    ranks' summed bf16 launch counts."""
    from repro_torch.core.cost_model import H100_SXM, StrategySpec, step_cost
    from repro_torch.core.planner import compile_plan
    from repro_torch.models.lm import Model, model_graph
    from repro_torch.tree import flatten

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    want = {}
    try:
        for name in TP_RUNS:
            first = {}
            model = Model(_tp_cfg(name))
            want[name] = r = _tp_steps(torch, compile_plan(model, None),
                                       first)
            torch.save(first, os.path.join(tmp, f"{name}.pt"))
            del first
            torch.cuda.empty_cache()
            print(f"[tp] one process, unsharded, {name} "
                  f"{TP_RUNS[name][0]} layers: losses {r['losses']}, step "
                  f"seconds {[round(x, 3) for x in r['seconds']]}, peak "
                  f"device memory {max(r['peaks']) / 2**30:.3f} GiB",
                  flush=True)
        # bf16's rounding alone: the same unsharded steps a row at a time
        rows = _tp_steps(torch, compile_plan(Model(_tp_cfg("bf16")), None),
                         {}, micro_batches=TP_BATCH)["losses"]
        torch.cuda.empty_cache()
        noise = [abs(a - b) for a, b in zip(rows, want["bf16"]["losses"])]
        print(f"[tp] one process, unsharded, bf16, {TP_BATCH} micro-batches "
              f"of one row: losses {rows}, |diff| by step from one "
              f"micro-batch {noise} (bf16's rounding, amplified by AdamW's "
              f"first steps: the yardstick for split×2's steps 1-2)",
              flush=True)
        ranks = spawn_ranks(_tp_rank, tmp, timeout=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks.sort(key=lambda r: r["bf16"]["model_rank"])
    total = sum(v.numel() for v in flatten(Model(_tp_cfg("bf16"),
                                                 "meta").param_shapes())[1])
    cfg = _tp_cfg("bf16")
    exp = train_expected(cfg.n_layers, TP_STEPS, cfg.padded_vocab // 2,
                         rows=TP_BATCH)
    fails = []
    for name in TP_RUNS:
        got, ref = ranks[0][name]["losses"], want[name]["losses"]
        for r, out in enumerate(ranks):
            run = out[name]
            print(f"[tp] {name}, model rank {r}: {run['local_params']:,} "
                  f"parameters; losses {run['losses']}, step seconds "
                  f"{[round(x, 3) for x in run['seconds']]} (host clock; "
                  f"two processes time-slice one card, activations summed "
                  f"by gloo through host memory: no throughput), gloo "
                  f"seconds {[round(x, 3) for x in run['gloo_s']]} over "
                  f"{run['collectives']} collectives, peak device memory "
                  f"of each step "
                  f"{[round(x / 2**30, 3) for x in run['peaks']]} GiB; "
                  f"launches {run['counts']}", flush=True)
            if name == "bf16" and run["counts"] != exp:
                fails.append(f"model rank {r}: launches {run['counts']}, "
                             f"want {exp}")
            if run["losses"] != got:
                fails.append(f"{name}: the ranks report different losses")
        rel = {}
        for path in ranks[0][name]["grads"]:
            diff = max(o[name]["grads"][path][0] for o in ranks)
            top = max(o[name]["grads"][path][1] for o in ranks)
            rel[path] = diff / max(top, 1e-30)
        worst = max(rel, key=rel.get)
        diffs = [abs(a - b) for a, b in zip(got, ref)]
        print(f"[tp] {name} split×2 against unsharded: losses {got} vs "
              f"{ref}, |diff| by step {diffs}; step-0 gradients' max |diff| "
              f"relative to the leaf's max: worst {rel[worst]:.3e} "
              f"({worst}), median "
              f"{statistics.median(rel.values()):.3e}", flush=True)
        if name == "bf16":
            if diffs[0] > 2e-2 + 2e-2 * abs(ref[0]):
                fails.append(f"bf16 step-0 loss |diff| {diffs[0]}")
            if max(diffs[1:]) > TP_LATER_LIMIT:
                fails.append(f"bf16 steps 1-2 |diff| {diffs[1:]} above "
                             f"{TP_LATER_LIMIT}")
            limit = GRAD_TOL[str(torch.bfloat16)]
        else:
            if any(d > TP_F32_LIMIT + TP_F32_LIMIT * abs(x)
                   for d, x in zip(diffs, ref)):
                fails.append(f"f32 losses |diff| {diffs}")
            limit = GRAD_TOL[str(torch.float32)]
        fails += [f"{name} step-0 gradient {p}: {v:.3e} of the leaf's max"
                  for p, v in rel.items() if v > limit]
    priced = step_cost(model_graph(cfg, TP_BATCH, TRAIN_SEQ).workload_meta(),
                       StrategySpec(tp=2), H100_SXM)
    print(f"[tp] {ranks[0]['bf16']['local_params']:,} of {total:,} "
          f"parameters a rank at {cfg.n_layers} layers; the cost model's "
          f"price of "
          f"split×2 at {TP_BATCH} x {TRAIN_SEQ} on H100_SXM, a price over "
          f"NVLink and not a reading: {priced.total * 1e3:.2f} ms (compute "
          f"{priced.compute * 1e3:.2f}, comm {priced.comm * 1e3:.2f})",
          flush=True)
    if fails:
        raise AssertionError("; ".join(fails))
    return {k: sum(r["bf16"]["counts"][k] for r in ranks) for k in exp}


def _zero_rank(rank: int, store: str, out_dir: str, ckpt_root: str) -> None:
    """One rank of phase 24 on ``cuda:0``: a gloo world of four, the plan
    ``StrategySpec(dp=2, tp=2, zero=z)`` for each z of ZERO_STAGES over
    tinyllama at full width and ZERO_LAYERS layers; ZERO_STEPS AdamW steps
    each from the same seed and batches, with peak memory, step and gloo
    seconds and launch counts.  zero=0's and zero=3's gathered checkpoints
    are written from rank 0 to ``ckpt_root/z<z>`` and restored into this
    rank's blocks; zero=1's state is gathered the same way in memory
    (``gather_state``, no file) and held on rank 0 against zero=0's
    gathered tree, and zero=0's checkpoint is restored into zero=1's
    blocks — each bit for bit.  Then phase 27's Case 2:
    ``replica×2{split×2}`` recorded as annotations on the meta device,
    ``compile_nested_plan`` of them, and its ZERO_STEPS steps the same
    way.  Then phase 36 (d), Adafactor over the split and under ZeRO
    (:func:`_zero_adafactor`)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch as wh
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten, tree_map

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    kernels = kernel_wrappers()
    stats = {"s": 0.0, "n": 0}
    time_collectives(torch, dist, stats)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=ZERO_LAYERS)

    def run(plan, opt) -> tuple:
        params = plan.init_params(0)
        st = {"params": params, "opt": plan.init_opt(opt, params)}
        state_bytes = 2 * sum(p.numel() * 4 for p in
                              flatten(st["params"])[1]) + sum(
            p.numel() * 4 for p in flatten(st["opt"])[1])
        step_fn = plan.train_step_fn(opt)
        data = TokenPipeline(DataCfg(global_batch=ZERO_BATCH,
                                     seq_len=ZERO_SEQ, vocab=cfg.vocab,
                                     seed=0), host_id=0, n_hosts=1)
        torch.cuda.synchronize()
        reset_counts(kernels)
        losses, secs, peaks, gloo = [], [], [], []
        for i in range(ZERO_STEPS):
            batch = plan.batch_slice({"tokens": torch.as_tensor(
                np.asarray(data.next_batch()["tokens"]))})
            batch = {k: v.cuda() for k, v in batch.items()}
            torch.cuda.reset_peak_memory_stats()
            s0 = stats["s"]
            t0 = time.perf_counter()
            p, o, m = step_fn(st["params"], st["opt"], batch, i)
            torch.cuda.synchronize()
            st = {"params": p, "opt": o}
            secs.append(time.perf_counter() - t0)
            gloo.append(stats["s"] - s0)
            peaks.append(torch.cuda.max_memory_allocated())
            losses.append(float(m["loss"]))
        return st, {"losses": losses, "seconds": secs, "gloo_s": gloo,
                    "peak": max(peaks), "state_bytes": state_bytes,
                    "counts": read_counts(kernels)}

    def same(a: dict, b: dict) -> bool:
        """The same paths, dtypes, shapes and bits (``a``'s leaves
        compared on ``b``'s device)."""
        (pa, la), (pb, lb) = flatten(a), flatten(b)
        return pa == pb and all(
            x.dtype == y.dtype and torch.equal(x.to(y.device), y)
            for x, y in zip(la, lb))

    out, gathered0, ckpt0 = {}, {}, None
    try:
        for z in ZERO_STAGES:
            strat = StrategySpec(dp=2, tp=2, zero=z)
            plan = compile_plan(Model(cfg), mesh_for_strategy(strat), strat)
            opt = adamw(lr=PP_LR)
            st, rec = run(plan, opt)
            t0 = time.perf_counter()
            if z == 1:
                # what zero=1's checkpoint would hold, gathered in memory
                full = plan.gather_state(st, opt)
                rec["gathered_equal"] = full is None or same(full, gathered0)
                del full
                gathered0.clear()
                _, back, _ = plan.restore_state(ckpt0, opt)
                rec.update(save_s=None, restored=same(back, st))
            else:
                def gather(tree, plan=plan, opt=opt, keep=z == 0):
                    # zero=0's tree kept in host memory, off the peaks of
                    # the steps that follow
                    full = plan.gather_state(tree, opt)
                    if keep and full is not None:
                        gathered0.update(tree_map(torch.Tensor.cpu, full))
                    return full

                ckpt = CheckpointManager(
                    os.path.join(ckpt_root, f"z{z}"), keep=1,
                    rank=dist.get_rank(), barrier=dist.barrier,
                    gather=gather)
                ckpt.save(ZERO_STEPS, st)
                rec["save_s"] = time.perf_counter() - t0
                _, back, _ = plan.restore_state(ckpt, opt)
                rec["restored"] = same(back, st)
                if z == 0:
                    ckpt0 = ckpt
            rec["check_s"] = time.perf_counter() - t0
            out[str(z)] = rec
            del st, back, plan
            torch.cuda.empty_cache()

        # phase 27, Case 2: the same hybrid, annotated
        t0 = time.perf_counter()
        mesh = mesh_for_strategy(StrategySpec(dp=2, tp=2))
        with wh.cluster(mesh=mesh) as cl:
            annotate_lm(wh, *meta_inputs(torch, cfg, ZERO_BATCH),
                        body=("replica", "split"), head=("replica", "split"))
        plan = wh.compile_nested_plan(cl, Model(cfg))
        _, rec = run(plan, adamw(lr=PP_LR))
        rec.update(strategy=dataclasses.asdict(plan.strategy),
                   describe=wh.lower(cl).describe(),
                   nodes=len(cl.taskgraph.nodes),
                   vdevices=sorted({str(n.vdevice) for n in
                                    cl.taskgraph.nodes}),
                   total_s=time.perf_counter() - t0)
        out["wh"] = rec
        out["adafactor"] = _zero_adafactor(
            torch, dist, dataclasses.replace(cfg, dtype="float32"), run,
            same, ckpt_root)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _zero_adafactor(torch, dist, cfg, run, same, ckpt_root: str) -> dict:
    """Phase 36 (d) in a rank of phase 24: Adafactor (the reference's
    recipe for its archs of 50B and more) at data 2 x model 2 in f32 with
    ZeRO 0, 1 and 3, ZERO_STEPS steps each (``run``): ZeRO-1's and
    ZeRO-3's state, gathered into the checkpoint's layout, against
    ZeRO-0's (its factored means summed over the blocks, so within f32's
    rounding), and ZeRO-0's checkpoint restored into ZeRO-1's and
    ZeRO-3's blocks and gathered back equal to it bit for bit (the
    factored moments' layout under each level).  Returns per level its
    run's record, the gaps and ``restored``."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import adafactor
    from repro_torch.tree import flatten, tree_map

    out, whole0, ckpt0 = {}, None, None
    for z in ZERO_STAGES:
        strat = StrategySpec(dp=2, tp=2, zero=z)
        plan = compile_plan(Model(cfg), mesh_for_strategy(strat), strat)
        opt = adafactor(lr=PP_LR)
        st, rec = run(plan, opt)
        full = plan.gather_state(st, opt)
        if full is not None:
            full = tree_map(torch.Tensor.cpu, full)
        if z == 0:
            whole0 = full
            ckpt0 = CheckpointManager(
                os.path.join(ckpt_root, "adafactor"), keep=1,
                rank=dist.get_rank(), barrier=dist.barrier,
                gather=lambda tree, plan=plan, opt=opt: plan.gather_state(
                    tree, opt))
            ckpt0.save(ZERO_STEPS, st)
        else:
            if full is not None:
                rec["gaps"] = {
                    p: [max_err(a, b), float(b.abs().max())]
                    for p, a, b in zip(flatten(full)[0], flatten(full)[1],
                                       flatten(whole0)[1])}
            _, back, _ = plan.restore_state(ckpt0, opt)
            again = plan.gather_state(back, opt)
            rec["restored"] = again is None or same(again, whole0)
            del back, again
        out[str(z)] = rec
        del st, plan, full
        torch.cuda.empty_cache()
    return out


def train_hybrid_zero(torch) -> dict:
    """Phase 24: ``replica×2{split×2}`` (Whale's Case-2 hybrid) with ZeRO
    at 0, 1 and 3 on four ranks sharing ``cuda:0`` over gloo, tinyllama
    at full width and ZERO_LAYERS layers, batch ZERO_BATCH x ZERO_SEQ,
    ZERO_STEPS steps each.  Held: zero=1 equals zero=0 bit for bit (every
    rank's losses, and its whole state gathered into the checkpoint's
    layout equal to zero=0's gathered checkpoint tree: gathered in memory,
    not written); zero=3 within 1e-4 + 1e-4|x| of zero=0 in losses and
    parameters; zero=0's and zero=3's checkpoints restore into their
    ranks' blocks, and zero=0's into zero=1's, bit for bit; the launches
    those of the model on its vocab shard.  Then phase 27's Case 2 from
    the same ranks: the annotated ``replica×2{split×2}`` must derive
    ``StrategySpec(dp=2, tp=2)`` and its steps equal zero=0's bit for
    bit.  Returns the ranks' summed launch counts, and the annotated
    plan's."""
    import dataclasses
    import filecmp
    import io
    import pathlib

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import StrategySpec

    cfg = get_config(ARCH)
    root = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    try:
        ranks = spawn_ranks(_zero_rank, root, nprocs=4, timeout=900)
        exp = train_expected(ZERO_LAYERS, ZERO_STEPS, cfg.padded_vocab // 2,
                             rows=ZERO_BATCH // 2, seq=ZERO_SEQ)
        for r, out in enumerate(ranks):
            for z in map(str, ZERO_STAGES):
                o = out[z]
                save = (f"none written: gathered in memory against zero=0's "
                        f"and zero=0's restored, {o['check_s']:.2f} s"
                        if o["save_s"] is None else
                        f"{o['save_s']:.2f} s, with the restore "
                        f"{o['check_s']:.2f} s")
                print(f"[zero] rank {r} zero={z}: losses {o['losses']}, "
                      f"step seconds {[round(x, 3) for x in o['seconds']]} "
                      f"(host clock; four processes time-slice one card), "
                      f"gloo seconds {[round(x, 3) for x in o['gloo_s']]}, "
                      f"peak device memory {o['peak'] / 2**30:.3f} GiB "
                      f"beside the state it holds (parameters, gradients, "
                      f"AdamW moments) {o['state_bytes'] / 2**30:.3f} GiB; "
                      f"checkpoint save {save}; launches {o['counts']}",
                      flush=True)
                if o["counts"] != exp:
                    raise AssertionError(f"rank {r} zero={z}: launches "
                                         f"{o['counts']}, want {exp}")
                if not o["restored"]:
                    raise AssertionError(f"rank {r} zero={z}: the "
                                         f"checkpoint restored other blocks")
                if o["losses"] != ranks[0][z]["losses"]:
                    raise AssertionError("the ranks report different losses")
            if out["1"]["losses"] != out["0"]["losses"] \
                    or not out["1"]["gathered_equal"]:
                raise AssertionError(f"rank {r}: zero=1 (losses "
                                     f"{out['1']['losses']}) differs from "
                                     f"zero=0 (losses {out['0']['losses']})")
        step = f"step_{ZERO_STEPS:08d}"
        z0, z3 = (os.path.join(root, f"z{z}", step) for z in (0, 3))
        names = sorted(os.listdir(z0))
        with open(os.path.join(z0, "MANIFEST.json")) as f:
            paths = json.load(f)["paths"]
        arrays = {f"arr_{i:05d}.npy" for i in range(len(paths))}
        same3 = filecmp.cmpfiles(z0, z3, sorted(set(names) - arrays),
                                 shallow=False)[0]
        worst = {}
        for i, path in enumerate(paths):
            # each array file read once: compared byte for byte, then
            # parsed from the same bytes
            name = f"arr_{i:05d}.npy"
            ra, rb = (pathlib.Path(d, name).read_bytes() for d in (z0, z3))
            if ra == rb:
                same3.append(name)
            a = torch.from_numpy(np.load(io.BytesIO(ra)))
            b = torch.from_numpy(np.load(io.BytesIO(rb)))
            del ra, rb
            head = path.split("/")[0] if path.startswith("params") else \
                "/".join(path.split("/")[:2])
            worst[head] = max(worst.get(head, 0.0), max_err(a, b))
            if path.startswith("params"):
                check_close(f"zero=3 {path} against zero=0", b, a,
                            torch.float32, 1e-4)
        l0, l3 = ranks[0]["0"]["losses"], ranks[0]["3"]["losses"]
        check_close("zero=3 losses against zero=0", torch.tensor(l3),
                    torch.tensor(l0), torch.float32, 1e-4)
        print(f"[zero] zero=1 equals zero=0 bit for bit: losses {l0} on "
              f"every rank, its state gathered into the checkpoint's layout "
              f"equal to zero=0's gathered checkpoint tree (every path, "
              f"dtype, shape and bit); zero=3 losses {l3} (max |diff| "
              f"{max(abs(a - b) for a, b in zip(l0, l3)):.3e}), its gathered "
              f"checkpoint against zero=0's max |diff| {worst} (parameters "
              f"held at 1e-4 + 1e-4|x|), {len(same3)} of {len(names)} files "
              f"byte for byte; zero=0's and zero=3's checkpoints restored "
              f"into their ranks' blocks, and zero=0's into zero=1's, bit "
              f"for bit",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    af_counts = _zero_adafactor_report(torch, ranks, cfg)
    want = dataclasses.asdict(StrategySpec(dp=2, tp=2))
    for r, out in enumerate(ranks):
        o = out["wh"]
        print(f"[wh] Case 2 rank {r}: {o['nodes']} nodes recorded on the "
              f"meta device, virtual devices {o['vdevices']}; lower: "
              f"{o['describe']}; compile_nested_plan's {ZERO_STEPS} steps "
              f"{o['losses']} vs zero=0's {out['0']['losses']}; "
              f"launches {o['counts']}; {o['total_s']:.2f} s in all "
              f"(recording, compiling, the steps)", flush=True)
        if o["strategy"] != want:
            raise AssertionError(f"Case 2 derived {o['strategy']}, want "
                                 f"{want}")
        if o["losses"] != out["0"]["losses"] or o["counts"] != exp:
            raise AssertionError(f"rank {r}: the annotated Case 2 differs "
                                 f"from zero=0 ({o['losses']}, "
                                 f"{o['counts']})")
    return {k: sum(r[z]["counts"][k] for r in ranks
                   for z in map(str, ZERO_STAGES)) for k in exp}, {
        k: sum(r["wh"]["counts"][k] for r in ranks) for k in exp}, af_counts


def _zero_adafactor_report(torch, ranks: list, cfg) -> dict:
    """Print and hold phase 36 (d) (:func:`_zero_adafactor`): every
    level's losses within 2e-5 + 2e-5|x| of ZeRO-0's and equal on every
    rank, ZeRO-1's and ZeRO-3's gathered state (parameters and factored
    moments) within 2e-4 + 2e-4 x each leaf's max of ZeRO-0's, ZeRO-0's
    checkpoint restored into each level bit for bit, the launches those
    of phase 24's model.  Returns the launches summed over ranks and
    levels."""
    exp = train_expected(ZERO_LAYERS, ZERO_STEPS, cfg.padded_vocab // 2,
                         rows=ZERO_BATCH // 2, seq=ZERO_SEQ)
    fails = []
    lim, glim = TOL[str(torch.float32)], GRAD_TOL[str(torch.float32)]
    for r, out in enumerate(ranks):
        af = out["adafactor"]
        l0 = af["0"]["losses"]
        for z in map(str, ZERO_STAGES):
            o = af[z]
            worst = ""
            if "gaps" in o:
                share = {p: d / (glim + glim * top)
                         for p, (d, top) in o["gaps"].items()}
                w = max(share, key=share.get)
                worst = (f"; its gathered state against zero=0's: worst "
                         f"share of 2e-4 + 2e-4 x the leaf's max "
                         f"{share[w]:.3f} ({w})")
                fails += [f"rank {r} zero={z} {p}: share {v:.3f}"
                          for p, v in share.items() if not v <= 1]
            restored = "" if z == "0" else (
                "; zero=0's checkpoint restored into its blocks and "
                "gathered back " + ("bit for bit" if o["restored"]
                                    else "DIFFERENT"))
            print(f"[zero] Adafactor rank {r} zero={z} (f32): losses "
                  f"{o['losses']}, step seconds "
                  f"{[round(x, 3) for x in o['seconds']]}, peak "
                  f"{o['peak'] / 2**30:.3f} GiB beside "
                  f"{o['state_bytes'] / 2**30:.3f} GiB of state{worst}"
                  f"{restored}; launches {o['counts']}", flush=True)
            if o["counts"] != exp:
                fails.append(f"rank {r} zero={z}: launches {o['counts']}")
            if z != "0" and not o["restored"]:
                fails.append(f"rank {r} zero={z}: zero=0's checkpoint "
                             f"restored other blocks")
            if o["losses"] != ranks[0]["adafactor"][z]["losses"] or not all(
                    abs(a - b) <= lim + lim * abs(b)
                    for a, b in zip(o["losses"], l0)):
                fails.append(f"rank {r} zero={z}: losses {o['losses']} "
                             f"against zero=0's {l0}")
    if fails:
        raise AssertionError("Adafactor under ZeRO: " + "; ".join(fails))
    return {k: sum(out["adafactor"][z]["counts"][k] for out in ranks
                   for z in map(str, ZERO_STAGES)) for k in exp}


# ---------------------------------------------------------------------------
# phase 25: Whale's nested hybrid, the plan --auto picks on the paper's
# V100 cluster
# ---------------------------------------------------------------------------

NESTED = dict(tp=2, pp=2, micro_batches=PP_MICRO)
#: phase 25's runs: name -> (layers, activation dtype, stage layers); bf16
#: at 4 layers is the path (cut from 22 to hold the script's time: the
#: nested hybrid runs the same code at every depth, and the plan is still
#: picked for the full model), f32 at 2 layers holds it to f32's limits
NESTED_RUNS = {"bf16": (4, "bfloat16", (2, 2)),
               "f32": (2, "float32", (1, 1))}
NESTED_STEPS = 2
NESTED_F32_LIMIT = 1e-4


def _nested_cfg(name: str):
    import dataclasses

    from repro_torch.configs import get_config

    layers, dtype, _ = NESTED_RUNS[name]
    return dataclasses.replace(get_config(ARCH), n_layers=layers,
                               dtype=dtype)


def _nested_rank(rank: int, store: str, out_dir: str, ref_dir: str) -> None:
    """One rank of phase 25 on ``cuda:0``: a gloo world of four, the plan
    ``StrategySpec(tp=2, pp=2, micro_batches=4)`` on stage 2 x data 1 x
    model 2.  For each of NESTED_RUNS from seed 0 on the driver's stream
    of TRAIN_BATCH x TRAIN_SEQ batches (AdamW at a constant PP_LR): the
    bf16 run one step under 1f1b, then NESTED_STEPS under the planned
    gpipe from the same start; the f32 run NESTED_STEPS of gpipe, then its
    checkpoint gathered in the reference's padded layout (rank 0 writes)
    and restored into every rank's blocks.  Each run's losses, step and
    gloo seconds, peaks (of the walk and the step), in-flight peak, launch
    counts, and its step-0 gradient blocks against the same blocks of the
    unpipelined, unsharded gradient in ``ref_dir/<run>.pt`` (max |diff|
    and max |ref| per leaf)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core import sharding
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.pipeline import _rows as stage_rows
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten, tree_map

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    kernels = kernel_wrappers()
    stats = {"s": 0.0, "n": 0}
    time_collectives(torch, dist, stats)
    strat = StrategySpec(**NESTED)
    out = {}
    try:
        mesh = mesh_for_strategy(strat)
        stage = mesh.get_local_rank("stage")
        out.update(stage=stage, model=mesh.get_local_rank("model"))
        for name, (_, _, sl) in NESTED_RUNS.items():
            plan = compile_plan(Model(_nested_cfg(name)), mesh, strat)
            if plan.stage_layers() != sl:
                raise AssertionError(f"stage layers {plan.stage_layers()}")
            init = plan.init_pipeline_params(0)
            ref = torch.load(os.path.join(ref_dir, f"{name}.pt"), mmap=True)
            specs = dict(zip(*flatten(sharding.within_stage(
                plan.param_specs))))
            runs = ((("1f1b", 1), ("gpipe", NESTED_STEPS)) if name == "bf16"
                    else (("gpipe", NESTED_STEPS),))
            for sched, steps in runs:
                params = tree_map(torch.clone, init)
                opt = adamw(lr=PP_LR)
                state = opt.init(params)
                held = 4 * (2 * sum(p.numel() for p in flatten(params)[1])
                            + sum(p.numel() for p in flatten(state)[1]))
                first, walk = {}, []
                real_apply = opt.apply

                def apply(grads, *args, real_apply=real_apply, first=first,
                          walk=walk, **kw):
                    walk.append(torch.cuda.max_memory_allocated())
                    if not first:
                        first.update((k, v.cpu()) for k, v in
                                     zip(*flatten(grads)))
                    return real_apply(grads, *args, **kw)

                spied = dataclasses.replace(opt, apply=apply)
                step_fn = plan.pipeline_train_step_fn(spied, schedule=sched)
                data = TokenPipeline(DataCfg(
                    global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                    vocab=plan.model.cfg.vocab, seed=0), host_id=0,
                    n_hosts=1)
                torch.cuda.synchronize()
                reset_counts(kernels)
                n0 = stats["n"]
                rec = {"losses": [], "seconds": [], "gloo_s": [],
                       "peaks": []}
                for i in range(steps):
                    toks = plan.batch_slice({"tokens": torch.as_tensor(
                        np.asarray(data.next_batch()["tokens"]))})["tokens"]
                    toks = toks.cuda()
                    torch.cuda.reset_peak_memory_stats()
                    s0 = stats["s"]
                    t0 = time.perf_counter()
                    params, state, m = step_fn(params, state, toks, i)
                    torch.cuda.synchronize()
                    rec["seconds"].append(time.perf_counter() - t0)
                    rec["gloo_s"].append(stats["s"] - s0)
                    rec["peaks"].append(torch.cuda.max_memory_allocated())
                    rec["losses"].append(float(m["loss"]))
                rec.update(counts=read_counts(kernels),
                           collectives=stats["n"] - n0, walk=walk,
                           in_flight=m["peak_in_flight"], held=held,
                           local_params=sum(p.numel() for p in
                                            flatten(params)[1]))
                rec["grads"] = {}
                for path, g in first.items():
                    w = ref[path]
                    if path.startswith("blocks/"):
                        w = stage_rows(w, stage, sl)
                    w = sharding.shard_leaf(w, specs[path], plan.rules)
                    rec["grads"][path] = [float((g.float() - w).abs().max()),
                                          float(w.abs().max())]
                out[f"{name}/{sched}"] = rec
                if name == "bf16" and sched == "gpipe":
                    out["wh"] = _annotated_nested(
                        torch, plan, mesh, init, first, rec["losses"][0])
                del first
            if name == "f32":
                ck = os.path.join(ref_dir, "ck")
                ckpt = CheckpointManager(
                    ck, keep=1, rank=dist.get_rank(), barrier=dist.barrier,
                    gather=lambda tree, plan=plan, opt=opt:
                        plan.gather_pipeline_state(tree, opt, sl))
                st = {"params": params, "opt": state}
                t0 = time.perf_counter()
                ckpt.save(NESTED_STEPS, st)
                out["save_s"] = time.perf_counter() - t0
                at, back, _ = plan.restore_pipeline_state(ckpt, opt, sl)
                out["restored"] = at == NESTED_STEPS and all(
                    torch.equal(a, b) for a, b in zip(flatten(back)[1],
                                                      flatten(st)[1]))
                with open(os.path.join(ck, f"step_{NESTED_STEPS:08d}",
                                       "MANIFEST.json")) as f:
                    manifest = json.load(f)
                out["ckpt_shapes"] = dict(zip(manifest["paths"],
                                              manifest["shapes"]))
                del back, st
            del init, ref, params, state, step_fn, plan
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _annotated_nested(torch, plan, mesh, init: dict, first: dict,
                      loss0: float) -> dict:
    """Phase 27's Case 4 in a rank of phase 25: ``pipeline(PP_MICRO){stage
    {replica{split}}}`` over two stages recorded as annotations on the
    meta device, lowered, and one gpipe step of ``compile_nested_plan``'s
    plan from phase 25's start ``init`` on its first batch.  Returns the
    derived strategy, the lowered graph's description and p2p bridges, and
    whether the step's loss (``loss0``) and step-0 gradient blocks
    (``first``) equal phase 25's explicitly compiled gpipe step's bit for
    bit, with its launches and seconds."""
    import dataclasses

    import numpy as np

    import repro_torch as wh
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten, tree_map

    kernels = kernel_wrappers()
    cfg = plan.model.cfg
    t0 = time.perf_counter()
    with wh.cluster(mesh=mesh) as cl:
        annotate_lm(wh, *meta_inputs(torch, cfg, TRAIN_BATCH),
                    body=("replica", "split"), head=("replica", "split"),
                    stages=plan.stage_layers())
    low = wh.lower(cl)
    nested = wh.compile_nested_plan(cl, plan.model)
    params = tree_map(torch.clone, init)
    opt = adamw(lr=PP_LR)
    grads = {}
    real_apply = opt.apply

    def apply(g, *args, **kw):
        grads.update((k, v.cpu()) for k, v in zip(*flatten(g)))
        return real_apply(g, *args, **kw)

    step_fn = nested.pipeline_train_step_fn(
        dataclasses.replace(opt, apply=apply))
    data = TokenPipeline(DataCfg(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 vocab=cfg.vocab, seed=0), host_id=0,
                         n_hosts=1)
    toks = nested.batch_slice({"tokens": torch.as_tensor(
        np.asarray(data.next_batch()["tokens"]))})["tokens"].cuda()
    torch.cuda.synchronize()
    reset_counts(kernels)
    _, _, m = step_fn(params, opt.init(params), toks, 0)
    torch.cuda.synchronize()
    return {"strategy": dataclasses.asdict(nested.strategy),
            "stage_layers": list(nested.stage_layers()),
            "describe": low.describe(),
            "p2p": [f"{e.src}→{e.dst} ({e.bridge.reason}, "
                    f"{e.bridge.bytes} bytes)"
                    for e in low.edges if e.bridge.kind == "p2p"],
            "loss": float(m["loss"]), "same_loss": float(m["loss"]) == loss0,
            "same_grads": sorted(grads) == sorted(first) and all(
                torch.equal(grads[k], first[k]) for k in first),
            "counts": read_counts(kernels),
            "total_s": time.perf_counter() - t0}


def _unpipelined_reference(torch, name: str, path: str) -> list:
    """The unpipelined, unsharded step of NESTED_RUNS[name] from seed 0 on
    the same batches: NESTED_STEPS AdamW steps' losses, and the step-0
    gradient (``accumulate`` over PP_MICRO micro-batches) saved to
    ``path`` on the host."""
    import dataclasses

    import numpy as np

    from repro_torch.core.planner import compile_plan
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten

    model = Model(_nested_cfg(name))
    params = model.init(0)
    opt = adamw(lr=PP_LR)
    state = opt.init(params)
    first = {}
    real_apply = opt.apply

    def apply(grads, *args, **kw):
        if not first:
            first.update((k, v.cpu()) for k, v in zip(*flatten(grads)))
        return real_apply(grads, *args, **kw)

    step_fn = compile_plan(model, None).train_step_fn(
        dataclasses.replace(opt, apply=apply), micro_batches=PP_MICRO)
    data = TokenPipeline(DataCfg(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 vocab=model.cfg.vocab, seed=0),
                         host_id=0, n_hosts=1)
    losses = []
    for i in range(NESTED_STEPS):
        batch = {"tokens": torch.as_tensor(
            np.asarray(data.next_batch()["tokens"])).cuda()}
        params, state, m = step_fn(params, state, batch, i)
        losses.append(float(m["loss"]))
    del params, state
    torch.save(first, path)
    return losses


def train_nested(torch) -> dict:
    """Phase 25: Whale's nested hybrid ``split×2 pipeline×2(µb=4)``, the
    plan ``auto_parallel`` picks for tinyllama at 4 x 2048 on 4 devices of
    the paper's V100 table (it must), priced on that table and on
    ``H100_SXM`` as predictions.  The unpipelined, unsharded references
    run here first (their step-0 gradients saved for the ranks to read by
    mmap); then four ranks on ``cuda:0`` over gloo run :func:`_nested_rank`.
    Printed before anything is held: each rank's launches (the flash
    kernels on its stage's layers and 16 heads, the xent kernels on its
    16000 vocab columns at the last stage), buffer audit, peak memory of
    the walk and of the step beside the state it holds, step and gloo
    seconds, and 1f1b's stage-0 walk peak beside gpipe's.  Held: bf16 at
    4 layers, against the unpipelined losses, the step-0 loss of both
    schedules within 2e-2 + 2e-2|x| and gpipe's step 1 within
    TP_LATER_LIMIT, every step-0 gradient leaf within 5e-2 of the leaf's
    max; f32 at 2 layers, every loss within NESTED_F32_LIMIT +
    NESTED_F32_LIMIT|x| and each step-0 gradient leaf within 2e-4 of the
    leaf's max; the ranks' losses equal; each rank's launches those of its
    stage; the audit; the gathered checkpoint in the reference's padded
    layout, restored into every rank's blocks bit for bit.  Returns the
    ranks' summed bf16 launch counts, and the annotated Case 4's."""
    import dataclasses

    from repro_torch.core.auto import auto_parallel
    from repro_torch.core.cost_model import (H100_SXM, V100_PAPER,
                                             StrategySpec, step_cost)
    from repro_torch.models.lm import Model, model_graph
    from repro_torch.tree import flatten

    cfg = _nested_cfg("bf16")
    strat = StrategySpec(**NESTED)
    # the plan is picked for the full model; the run is cut to cfg's depth
    graph = model_graph(dataclasses.replace(cfg, n_layers=22), TRAIN_BATCH,
                        TRAIN_SEQ)
    picked = auto_parallel(graph, 4, V100_PAPER)
    print(f"[nested] auto_parallel over 4 x {V100_PAPER.name} at "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: {picked.describe()}", flush=True)
    if picked != strat:
        raise AssertionError(f"the search picks {picked}, phase 25 runs "
                             f"{strat}")
    for hw in (V100_PAPER, H100_SXM):
        c = step_cost(graph.workload_meta(), strat, hw)
        print(f"[nested] step_cost {strat.describe()} on {hw.name} (a "
              f"prediction, not a reading): {c.total * 1e3:.2f} ms (compute "
              f"{c.compute * 1e3:.2f}, comm {c.comm * 1e3:.2f}, bubble "
              f"{c.bubble * 1e3:.2f}; memory {c.mem_bytes / 2**30:.2f} GiB "
              f"a device)", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nested_")
    want = {}
    t0 = time.perf_counter()
    try:
        for name in NESTED_RUNS:
            want[name] = _unpipelined_reference(
                torch, name, os.path.join(tmp, f"{name}.pt"))
            torch.cuda.empty_cache()
        print(f"[nested] unpipelined, unsharded: bf16 at "
              f"{NESTED_RUNS['bf16'][0]} layers, losses {want['bf16']}; f32 "
              f"at 2 layers, losses {want['f32']}", flush=True)
        t1 = time.perf_counter()
        ranks = spawn_ranks(_nested_rank, tmp, nprocs=4, timeout=600)
        print(f"[nested] seconds: the unpipelined references {t1 - t0:.1f}; "
              f"four ranks {time.perf_counter() - t1:.1f}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks.sort(key=lambda r: (r["stage"], r["model"]))
    total = sum(v.numel() for v in flatten(Model(cfg, "meta")
                                           .param_shapes())[1])
    fails = []
    for r in ranks:
        s, k = r["stage"], r["model"]
        for run in ("bf16/1f1b", "bf16/gpipe", "f32/gpipe"):
            o = r[run]
            print(f"[nested] {run} stage {s} model {k}: "
                  f"{o['local_params']:,} of {total:,} parameters; losses "
                  f"{o['losses']}, step seconds "
                  f"{[round(x, 3) for x in o['seconds']]} (host clock; four "
                  f"processes time-slice one card), gloo seconds "
                  f"{[round(x, 3) for x in o['gloo_s']]} over "
                  f"{o['collectives']} collectives (the wire's "
                  f"point-to-point messages not among them); peak device "
                  f"memory of each step's walk "
                  f"{[round(x / 2**30, 3) for x in o['walk']]} GiB, of each "
                  f"step "
                  f"{[round(x / 2**30, 3) for x in o['peaks']]} GiB beside "
                  f"the state it holds (parameters, gradients, AdamW "
                  f"moments) {o['held'] / 2**30:.3f} GiB; in flight "
                  f"{o['in_flight']}; launches {o['counts']}", flush=True)
            sched = run.split("/")[1]
            if o["in_flight"] != PP_IN_FLIGHT[sched][s]:
                fails.append(f"{run} stage {s}: in flight {o['in_flight']}")
            if o["losses"] != ranks[0][run]["losses"]:
                fails.append(f"{run}: the ranks report different losses")
            if run.startswith("bf16"):
                exp = pipeline_expected(
                    NESTED_RUNS["bf16"][2][s], len(o["losses"]),
                    cfg.padded_vocab // 2, head=s == 1)
                if o["counts"] != exp:
                    fails.append(f"{run} stage {s} model {k}: launches "
                                 f"{o['counts']}, want {exp}")
        print(f"[nested] stage {s} model {k}: step 0's walk peaks under "
              f"1f1b {r['bf16/1f1b']['walk'][0] / 2**30:.3f} GiB beside "
              f"gpipe's {r['bf16/gpipe']['walk'][0] / 2**30:.3f} GiB",
              flush=True)
    for run in ("bf16/1f1b", "bf16/gpipe", "f32/gpipe"):
        name = run.split("/")[0]
        got, ref = ranks[0][run]["losses"], want[name]
        diffs = [abs(a - b) for a, b in zip(got, ref)]
        rel = {}
        for path in ranks[0][run]["grads"]:
            diff = max(o[run]["grads"][path][0] for o in ranks)
            top = max(o[run]["grads"][path][1] for o in ranks)
            rel[path] = diff / max(top, 1e-30)
        worst = max(rel, key=rel.get)
        print(f"[nested] {run} against the unpipelined, unsharded step: "
              f"losses {got} vs {ref[:len(got)]}, |diff| by step {diffs}; "
              f"step-0 gradients' max |diff| relative to the leaf's max: "
              f"worst {rel[worst]:.3e} ({worst}), median "
              f"{statistics.median(rel.values()):.3e}", flush=True)
        if name == "bf16":
            if diffs[0] > 2e-2 + 2e-2 * abs(ref[0]):
                fails.append(f"{run} step-0 loss |diff| {diffs[0]}")
            if len(diffs) > 1 and max(diffs[1:]) > TP_LATER_LIMIT:
                fails.append(f"{run} later steps |diff| {diffs[1:]} above "
                             f"{TP_LATER_LIMIT}")
            limit = GRAD_TOL[str(torch.bfloat16)]
        else:
            if any(d > NESTED_F32_LIMIT + NESTED_F32_LIMIT * abs(x)
                   for d, x in zip(diffs, ref)):
                fails.append(f"{run} losses |diff| {diffs}")
            limit = GRAD_TOL[str(torch.float32)]
        fails += [f"{run} step-0 gradient {p}: {v:.3e} of the leaf's max"
                  for p, v in rel.items() if v > limit]
    shapes = ranks[0]["ckpt_shapes"]
    print(f"[nested] f32 checkpoint gathered in the reference's padded "
          f"layout in {ranks[0]['save_s']:.2f} s (embed/table "
          f"{shapes['params/embed/table']}, blocks/p0/attn/wq "
          f"{shapes['params/blocks/p0/attn/wq']}); restored into every "
          f"rank's blocks bit for bit: "
          f"{all(r['restored'] for r in ranks)}", flush=True)
    if not all(r["restored"] for r in ranks):
        fails.append("the checkpoint restored other blocks")
    want_strat = dataclasses.asdict(strat)
    for r in ranks:
        s, k, o = r["stage"], r["model"], r["wh"]
        print(f"[wh] Case 4 stage {s} model {k}: compile_nested_plan "
              f"derives {o['strategy']}, stage layers {o['stage_layers']}; "
              f"lower: {o['describe']}; p2p bridges {o['p2p']}; one gpipe "
              f"step's loss {o['loss']} equal to phase 25's explicitly "
              f"compiled step {o['same_loss']}, its step-0 gradient blocks "
              f"bit for bit {o['same_grads']}; launches {o['counts']}; "
              f"{o['total_s']:.2f} s in all (recording, compiling, the "
              f"step)", flush=True)
        exp = pipeline_expected(NESTED_RUNS["bf16"][2][s], 1,
                                cfg.padded_vocab // 2, head=s == 1)
        if o["strategy"] != want_strat or not o["p2p"] \
                or not o["same_loss"] or not o["same_grads"] \
                or o["counts"] != exp:
            fails.append(f"Case 4 stage {s} model {k}: {o}")
    if fails:
        raise AssertionError("; ".join(fails))
    return {k: sum(r[run]["counts"][k] for r in ranks
                   for run in ("bf16/1f1b", "bf16/gpipe"))
            for k in ranks[0]["bf16/gpipe"]["counts"]}, {
        k: sum(r["wh"]["counts"][k] for r in ranks)
        for k in ranks[0]["wh"]["counts"]}


# ---------------------------------------------------------------------------
# phase 26: serving over a mesh
# ---------------------------------------------------------------------------

#: runs 1-3 serve tinyllama's full width at this depth (cut from 22 to
#: hold the script's time: the multi-rank serving path is the same at
#: every depth)
TP_SERVE_LAYERS = 4
TP_DEPTH = ["--overrides", f"n_layers={TP_SERVE_LAYERS}"]
#: run 1: phase 4's paged workload (16 requests of 500 through 8 slots)
#: at TP_SERVE_LAYERS layers, 32 tokens generated of its 64 (cut to hold
#: the script's time: two waves of 31 steps)
TP_PAGED_ARGS = [a if PAGED_ARGS[i - 1] != "--gen" else "32"
                 for i, a in enumerate(PAGED_ARGS)] + TP_DEPTH
#: run 2: the dense, sequence-split cache; each rank holds 512 of the
#: 1024 rows, and the 15 decode steps write rows 500-514
TP_DENSE_ARGS = ["--arch", ARCH, "--cache", "dense", "--requests", "8",
                 "--batch-slots", "8", "--prompt-len", "500", "--gen", "16",
                 "--max-len", "1024"] + TP_DEPTH
#: run 4: data 2 x model 2 at DP_TP_LAYERS layers (cut from 4 to hold the
#: script's time), a pool of 66 usable pages: 8 admissions take 64, the
#: growth past row 512 preempts
DP_TP_LAYERS = 2
DP_TP_ARGS = PAGED_ARGS + ["--overrides", f"n_layers={DP_TP_LAYERS}",
                           "--pages", "67"]
#: run 5: f32 at 2 layers
F32_SERVE = ["--requests", "4", "--batch-slots", "4", "--prompt-len", "500",
             "--gen", "16", "--max-len", "1024", "--overrides",
             "n_layers=2,dtype=float32"]
TF_STEPS = 16                   # teacher-forced decode steps
TF_PROMPT = 500                 # two prompts of this many tokens
#: teacher-forced runs: name -> (layers, activation dtype, caches)
TF_RUNS = {"bf16": (TP_SERVE_LAYERS, "bfloat16", ("paged", "dense")),
           "f32": (2, "float32", ("paged", "dense")),
           "f32_deep": (TP_SERVE_LAYERS, "float32", ("paged", "dense"))}
TF_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: a bf16 run's yardstick: bf16's own error, the unsharded bf16 run's
#: paged logits against the same weights' in f32 at the same depth
TF_YARDSTICK = {"bf16": "f32_deep"}
#: the bf16 gate in yardsticks: two bf16 computations of the same logits,
#: each within bf16's own error of the f32 ones, lie within twice it of
#: each other
TF_PAIR = 2.0
#: the runs of one depth share one draw of the weights
TF_DEPTHS = {TP_SERVE_LAYERS: ("bf16", "f32_deep"), 2: ("f32",)}


def _tf_model(torch, name: str):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model

    layers, dtype, _ = TF_RUNS[name]
    return Model(dataclasses.replace(get_config(ARCH), n_layers=layers,
                                     dtype=dtype))


def teacher_forced(torch, model, plan, params, cache: str,
                   state_out: dict | None = None):
    """Two prompts of TF_PROMPT tokens prefilled into a Server's two slots
    (``plan`` over a mesh, or ``None``), then TF_STEPS decode steps fed
    fixed tokens: each prefill's logits, then every step's for both slots,
    as one (2 + 2·TF_STEPS, Vp) f32 host tensor (gathered over the
    mesh).  ``state_out`` (dense cache) receives the decode state's leaves
    after both prefills, whole (gathered by the state specs), on the
    host."""
    import numpy as np

    from repro_torch.serving.server import Request, Server

    rng = np.random.default_rng(26)
    V = model.cfg.vocab
    prompts = [rng.integers(0, V, TF_PROMPT) for _ in range(2)]
    forced = torch.as_tensor(rng.integers(0, V, (TF_STEPS, 2)))
    server = Server(model, plan, batch_slots=2, max_len=1024, eos_id=-1,
                    cache=cache, page_size=64)
    rows = []
    real_prefill, real_step = server.plan.prefill_fn, server._step

    def prefill_fn(gb):
        fn = real_prefill(gb)

        def run(*a, **kw):
            logits, st = fn(*a, **kw)
            rows.append(logits.float().cpu())
            return logits, st
        return run

    def step(*a):
        logits, st = real_step(*a)
        rows.append(server.plan.gather_slots(logits).float().cpu())
        return logits, st

    server.plan.prefill_fn, server._step = prefill_fn, step
    try:
        for i, p in enumerate(prompts):
            server.admit(params, Request(i, p, max_new=1 << 30), i)
        if state_out is not None:
            from repro_torch.core import sharding
            from repro_torch.tree import flatten
            specs = flatten(server.plan.state_specs(2, 1024)["cache"])[1]
            for (path, v), spec in zip(zip(*flatten(server.state["cache"])),
                                       specs):
                if server.plan.rules is not None:
                    v = sharding.gather_leaf(v, spec, server.plan.rules)
                state_out[path] = v.float().cpu()
        for t in forced:
            server.tokens = t.to(server.device)
            server.step(params)
    finally:
        del server.plan.prefill_fn
    return torch.cat(rows)


def tf_gap(got, want, tol: float) -> dict:
    """Max |diff| of two teacher-forced logit tables, and the worst
    |diff| / (tol + tol|want|) (above 1 fails); a NaN counts as an
    infinite gap."""
    d = (got - want).abs().nan_to_num(nan=math.inf)
    return {"max_abs": float(d.max()),
            "worst": float((d / (tol + tol * want.abs())).max()),
            "rows": [float(f"{x:.3g}") for x in d.amax(-1)]}


def instrument_servers(torch, stats: dict, rec: dict) -> None:
    """Wrap the Server's ``admit`` and ``step`` so each call adds its host
    seconds (ending in a sync) and its gloo seconds (``stats``, from
    :func:`time_collectives`) to ``rec``; the first admission of a run
    resets the peak memory, so the run's peak is its serving peak."""
    from repro_torch.serving import server as srv

    for name in ("admit", "step"):
        real = getattr(srv.Server, name)

        def timed(self, *a, _real=real, _name=name, **kw):
            if _name == "admit" and not rec["admit"]:
                torch.cuda.reset_peak_memory_stats()
            g0, t0 = stats["s"], time.perf_counter()
            out = _real(self, *a, **kw)
            torch.cuda.synchronize()
            rec[_name].append((time.perf_counter() - t0, stats["s"] - g0))
            return out

        setattr(srv.Server, name, timed)


def _held_bytes(torch, server) -> tuple:
    """(weight bytes, KV bytes) this rank holds: its blocks of the serving
    parameters (bf16 or f32 but the f32 leaves) and its pools or cache."""
    import math

    from repro_torch.tree import flatten

    plan, model = server.plan, server.model
    size = plan.rules.axis_size
    w = 0
    paths, shapes = flatten(model.param_shapes())
    for path, m, spec in zip(paths, shapes, flatten(plan.param_specs)[1]):
        n = math.prod(d // size(e) for d, e in zip(m.shape, spec))
        leaf = path.split("/")[-1]
        w += n * (4 if leaf in model.F32_LEAVES
                  else torch.empty((), dtype=model.cfg.adtype).element_size())
    kv = server.pools if server.cache == "paged" else server.state["cache"]
    return w, sum(t.numel() * t.element_size() for t in flatten(kv)[1])


def _serve_run(torch, kernels, argv: list, rec: dict) -> dict:
    """One run of the serving driver's meshed branch (``serve.run``) on
    this rank, with launches, admission and step seconds, peaks and
    bytes held."""
    from repro_torch.launch import serve

    rec["admit"], rec["step"] = [], []
    reset_counts(kernels)
    summary, server = serve.run(serve.parse_args(argv))
    out = {k: summary[k] for k in ("completed", "tokens", "steps", "seconds",
                                   "tokens_crc32", "out_tokens",
                                   "preemptions")}
    out["counts"] = read_counts(kernels)
    out["peak"] = torch.cuda.max_memory_allocated()
    out["weights"], out["kv"] = _held_bytes(torch, server)
    out["admit"], out["step"] = list(rec["admit"]), list(rec["step"])
    out["model_rank"] = server.plan.rules.index("model")
    out["data_rank"] = server.plan.rules.index("data")
    for kv in (server.pools.values() if server.cache == "paged" else ()):
        for key, pool in kv.items():
            if pool[:, 0].any() or not torch.isfinite(pool).all():
                out["bad_pool"] = True
    return out


def _tf_compare(torch, names: tuple, plan_mesh, ref_dir: str,
                out: dict, only: tuple | None = None) -> None:
    """Run each of TF_RUNS[names] (one depth: one draw of the weights, each
    run serving its own cast of it) under ``plan_mesh`` for each of its
    caches (``only`` these, where given) and hold the logits against the
    unsharded process's (in ``ref_dir``).  With all its caches the bf16
    run runs its dense cache once more with a planted fault, the max of
    the sequence-split softmax left unreduced (each rank's own), which the
    bf16 gate must reject."""
    from repro_torch.core import sharding
    from repro_torch.core.planner import compile_plan

    masters = None
    for name in names:
        model = _tf_model(torch, name)
        plan = compile_plan(model, plan_mesh)
        if masters is None:
            masters = plan.init_params(0)
        params = model.serving_params(masters)
        _, dtype, caches = TF_RUNS[name]
        runs = [(cache, cache) for cache in only or caches]
        if name == "bf16" and plan_mesh is not None and only is None:
            runs.append(("dense", "dense_fault"))
        for cache, tag in runs:
            real = sharding.all_reduce_max
            if tag.endswith("_fault"):
                sharding.all_reduce_max = lambda m, split: m
            try:
                got = teacher_forced(torch, model, plan, params, cache)
            finally:
                sharding.all_reduce_max = real
            want = torch.load(os.path.join(ref_dir,
                                           f"tf_{name}_{cache}.pt"))
            out[f"tf/{name}/{tag}"] = tf_gap(got, want, TF_TOL[dtype])
        del params


def _serve_tp_rank(rank: int, store: str, out_dir: str, ref_dir: str) -> None:
    """One rank of phase 26 runs 1-3 and 5 on ``cuda:0``: a gloo world of
    two, every run through ``serve.run`` with ``--mesh 1x2`` (the driver's
    meshed branch) or through the plan's Server (teacher-forced)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import parse_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    kernels = kernel_wrappers()
    stats, rec = {"s": 0.0, "n": 0}, {"admit": [], "step": []}
    out = {}
    try:
        time_collectives(torch, dist, stats)
        instrument_servers(torch, stats, rec)
        mesh = ["--mesh", "1x2"]
        out["paged"] = _serve_run(torch, kernels, TP_PAGED_ARGS + mesh, rec)
        torch.cuda.empty_cache()
        out["dense"] = _serve_run(torch, kernels, TP_DENSE_ARGS + mesh, rec)
        torch.cuda.empty_cache()
        for cache in ("paged", "dense"):
            out[f"f32/{cache}"] = _serve_run(
                torch, kernels, ["--arch", ARCH, "--cache", cache,
                                 "--page-size", "64"] + F32_SERVE + mesh,
                rec)
        # f32_deep is the bf16 run's yardstick, run unsharded only
        for names in (("bf16",), ("f32",)):
            _tf_compare(torch, names, parse_mesh("1x2"), ref_dir, out)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _serve_dp_tp_rank(rank: int, store: str, out_dir: str,
                      ref_dir: str) -> None:
    """One rank of phase 26 run 4 on ``cuda:0``: a gloo world of four,
    ``--mesh 2x2`` at DP_TP_LAYERS layers with a pool that preempts, then
    the teacher-forced paged run at TP_SERVE_LAYERS layers."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import parse_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    kernels = kernel_wrappers()
    stats, rec = {"s": 0.0, "n": 0}, {"admit": [], "step": []}
    out = {}
    try:
        time_collectives(torch, dist, stats)
        instrument_servers(torch, stats, rec)
        out["paged"] = _serve_run(torch, kernels,
                                  DP_TP_ARGS + ["--mesh", "2x2"], rec)
        _tf_compare(torch, ("bf16",), parse_mesh("2x2"), ref_dir, out,
                    only=("paged",))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _unsharded_references(torch, ref_dir: str) -> dict:
    """Run here, before the ranks: each TF_RUNS entry's teacher-forced
    logits saved to ``ref_dir`` for the ranks to read; the unsharded
    driver's tokens of run 4's and run 5's workloads."""
    from repro_torch.launch import serve

    for names in TF_DEPTHS.values():
        masters = None
        for name in names:
            model = _tf_model(torch, name)
            if masters is None:
                masters = model.init(0)
            params = model.serving_params(masters)
            for cache in TF_RUNS[name][2]:
                torch.save(teacher_forced(torch, model, None, params, cache),
                           os.path.join(ref_dir, f"tf_{name}_{cache}.pt"))
            del params
        del masters
        torch.cuda.empty_cache()
    want = {"dp_tp": serve.main(DP_TP_ARGS),
            "paged": serve.main(TP_PAGED_ARGS)}
    for cache in ("paged", "dense"):
        want[f"f32/{cache}"] = serve.main(["--arch", ARCH, "--cache", cache,
                                           "--page-size", "64"] + F32_SERVE)
    torch.cuda.empty_cache()
    return want


def _same_tokens(got: dict, want: dict) -> tuple:
    """(tokens equal position by position, tokens in ``want``), the
    requests keyed by id (JSON turns the keys into strings)."""
    same = total = 0
    for rid, toks in want.items():
        mine = got.get(str(rid), got.get(rid, []))
        total += len(toks)
        same += sum(a == b for a, b in zip(mine, toks))
    return same, total


def _report_run(tag: str, ranks: list, run: str, layers: int,
                fails: list) -> None:
    """Print each rank's line of one served run; fail on a rank whose
    tokens or launches differ from what the run must give."""
    first = ranks[0][run]
    for r in ranks:
        o = r[run]
        adm = [a for a, _ in o["admit"]]
        stp = [s for s, _ in o["step"]]
        print(f"[serve-tp] {tag} data {o['data_rank']} model "
              f"{o['model_rank']}: {o['completed']} requests, {o['tokens']} "
              f"tokens, {o['steps']} steps, {o['preemptions']} preemptions "
              f"in {o['seconds']:.3f} s (host clock; ranks time-slice one "
              f"card and sum activations through host memory: not a "
              f"throughput); admission (TTFT without queueing) median "
              f"{statistics.median(adm) * 1e3:.1f} ms, of it gloo "
              f"{statistics.median(g for _, g in o['admit']) * 1e3:.1f}; "
              f"decode step (TPOT) median {statistics.median(stp) * 1e3:.1f}"
              f" ms, of it gloo "
              f"{statistics.median(g for _, g in o['step']) * 1e3:.1f}; "
              f"peak device memory while serving {o['peak'] / 2**30:.3f} "
              f"GiB beside weights {o['weights'] / 2**30:.3f} + KV "
              f"{o['kv'] / 2**30:.3f} GiB held; launches {o['counts']}",
              flush=True)
        if o["tokens_crc32"] != first["tokens_crc32"] \
                or o["out_tokens"] != first["out_tokens"]:
            fails.append(f"{tag}: the ranks report different tokens")
        if o.get("bad_pool"):
            fails.append(f"{tag}: a trash page written or a pool not finite")
        prefills = len(first["out_tokens"]) + o["preemptions"]
        want = {"flash_fwd": layers * prefills,
                "paged_decode": layers * o["steps"] if "paged" in run
                else 0}
        got = {k: o["counts"][k] for k in want}
        if got != want or sum(o["counts"].values()) != sum(got.values()):
            fails.append(f"{tag}: launches {o['counts']}, want {want}")


def serve_tp(torch, kernels, paged4: dict) -> dict:
    """Phase 26: serving over a mesh.  Here first, unsharded: the
    teacher-forced logits of TF_RUNS and the tokens of runs 1, 4 and 5's
    workloads.  Then two ranks on ``cuda:0`` over gloo (NCCL refuses two
    ranks on one card) serve through the driver's meshed branch at split×2
    (run 1: phase 4's requests, paged, full width and TP_SERVE_LAYERS
    layers, 32 tokens generated of their 64; run 2: dense, the
    sequence-split cache; run 5: f32 at 2 layers, both caches) and hold the teacher-forced logits (run 3, both
    caches at TP_SERVE_LAYERS layers; run 5's in f32); four ranks serve
    data 2 x model 2 at DP_TP_LAYERS layers with a pool
    that preempts (run 4).  Then the driver's ``--mesh 1x1`` at full width
    in this process (run 6).  Printed before anything is held: each rank's
    launches, TTFT and TPOT with their gloo seconds, peaks beside the
    weights and KV held, the tokens against the unsharded ones as a count.
    Held: every rank's tokens equal; launches those of its admissions and
    steps; the teacher-forced logits in f32 (2 layers) within 1e-4 +
    1e-4|x|; in bf16 within 2e-2 + 2e-2|x| scaled by TF_PAIR times
    bf16's own error at the same depth (the yardstick: the worst share of
    that limit of the unsharded bf16 logits against the same weights' in
    f32, which exceeds 1 at depth), and a planted fault (the dense cache's
    max left unreduced) must fall outside that gate; f32 tokens equal to the
    unsharded server's; run 4 preempts.  Returns the launch counts of
    runs 1, 2, 4 and 6, summed over ranks."""
    from repro_torch.launch import serve

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_tp_")
    t00 = time.perf_counter()
    try:
        want = _unsharded_references(torch, tmp)
        yard = {b: tf_gap(*(torch.load(os.path.join(tmp, f"tf_{n}_paged.pt"))
                            for n in (b, f)), TF_TOL["bfloat16"])
                for b, f in TF_YARDSTICK.items()}
        t0 = time.perf_counter()
        ranks = spawn_ranks(_serve_tp_rank, tmp, timeout=400)
        t1 = time.perf_counter()
        ranks4 = spawn_ranks(_serve_dp_tp_rank, tmp, nprocs=4, timeout=300)
        print(f"[serve-tp] the unsharded references {t0 - t00:.1f} s; two "
              f"ranks {t1 - t0:.1f} s; four ranks "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks.sort(key=lambda r: r["paged"]["model_rank"])
    ranks4.sort(key=lambda r: (r["paged"]["data_rank"],
                               r["paged"]["model_rank"]))
    fails = []
    _report_run(f"run 1 split×2 paged, {TP_SERVE_LAYERS} layers", ranks,
                "paged", TP_SERVE_LAYERS, fails)
    _report_run(f"run 2 split×2 dense, {TP_SERVE_LAYERS} layers", ranks,
                "dense", TP_SERVE_LAYERS, fails)
    _report_run(f"run 4 data 2 x model 2 paged, {DP_TP_LAYERS} layers",
                ranks4, "paged", DP_TP_LAYERS, fails)
    for cache in ("paged", "dense"):
        _report_run(f"run 5 split×2 {cache} f32, 2 layers", ranks,
                    f"f32/{cache}", 2, fails)
    for tag, got, ref in (
            ("run 1 against one unsharded process at "
             f"{TP_SERVE_LAYERS} layers", ranks[0]["paged"], want["paged"]),
            ("run 4 against one unsharded process at "
             f"{DP_TP_LAYERS} layers",
             ranks4[0]["paged"], want["dp_tp"]),
            ("run 5 paged f32 against the unsharded server",
             ranks[0]["f32/paged"], want["f32/paged"]),
            ("run 5 dense f32 against the unsharded server",
             ranks[0]["f32/dense"], want["f32/dense"])):
        same, total = _same_tokens(got["out_tokens"], ref["out_tokens"])
        print(f"[serve-tp] {tag}: {same} of {total} tokens equal position "
              f"by position; crc32 {got['tokens_crc32']:08x} vs "
              f"{ref['tokens_crc32']:08x}", flush=True)
        if tag.startswith("run 5") and same != total:
            fails.append(f"{tag}: f32 tokens differ")
    if not ranks4[0]["paged"]["preemptions"]:
        fails.append("run 4 never preempted")
    for b, f in TF_YARDSTICK.items():
        print(f"[serve-tp] yardstick {b}: bf16's own error, one unsharded "
              f"process's teacher-forced paged logits at {TF_RUNS[b][0]} "
              f"layers in bf16 against the same weights in f32: max |diff| "
              f"{yard[b]['max_abs']:.3e}, worst share of 0.02 + 0.02|x| "
              f"{yard[b]['worst']:.3f}; the gate {TF_PAIR:g} x it",
              flush=True)
    for rs, names in ((ranks, ("bf16", "f32")), (ranks4, ("bf16",))):
        for name in names:
            for key in sorted(k for k in rs[0]
                              if k.startswith(f"tf/{name}/")):
                cache = key.split("/")[2]
                gaps = [r[key] for r in rs]
                gap = max(g["max_abs"] for g in gaps)
                worst = max(g["worst"] for g in gaps)
                tol = TF_TOL[TF_RUNS[name][1]]
                print(f"[serve-tp] teacher-forced {name} ({TF_RUNS[name][0]}"
                      f" layers) {cache}: logits of 2 prefills and "
                      f"{TF_STEPS} steps x 2 slots against one unsharded "
                      f"process, max |diff| {gap:.3e}, worst share of "
                      f"{tol:g} + {tol:g}|x| {worst:.3f}; max |diff| by row "
                      f"(2 prefills, then the steps' slots) "
                      f"{gaps[0]['rows']}", flush=True)
                if name in TF_YARDSTICK:
                    # the limit's own measure (share of tol + tol|x|),
                    # scaled to bf16's own error at this depth
                    gate = TF_PAIR * yard[name]["worst"]
                    beyond = worst > gate
                    if beyond != cache.endswith("_fault"):
                        fails.append(f"{key}: worst share {worst:.3f} "
                                     f"{'beyond' if beyond else 'within'} "
                                     f"the bf16 gate {gate:.3f}")
                elif worst > 1:
                    fails.append(f"{key} logits outside {tol:g} + {tol:g}|x|")
    reset_counts(kernels)
    one = serve.main(PAGED_ARGS + ["--mesh", "1x1"])
    one_counts = read_counts(kernels)
    print(f"[serve-tp] run 6 serve --mesh 1x1 --cache paged (a world of one "
          f"over NCCL, through main): {one['completed']} requests, "
          f"{one['tokens']} tokens, {one['steps']} steps in "
          f"{one['seconds']:.3f} s; crc32 {one['tokens_crc32']:08x} vs "
          f"phase 4's {paged4['tokens_crc32']:08x}; launches {one_counts}",
          flush=True)
    if one["completed"] != 16 or one_counts["paged_decode"] != \
            22 * one["steps"] or one_counts["flash_fwd"] != 22 * 16:
        fails.append(f"run 6: {one['completed']} requests, launches "
                     f"{one_counts}")
    if fails:
        raise AssertionError("; ".join(fails))

    def total(rs, run):
        return {k: sum(r[run]["counts"][k] for r in rs) for k in one_counts}

    return {"serve_tp": total(ranks, "paged"),
            "serve_tp_dense": total(ranks, "dense"),
            "serve_dp_tp": total(ranks4, "paged"),
            "serve_mesh_1x1": one_counts}


# ---------------------------------------------------------------------------
# phase 27: Whale's annotations (its meshed parts run in the ranks of phases
# 21, 24 and 25)
# ---------------------------------------------------------------------------

WH_STEPS = 3                    # the annotated Case 1/2 plan's AdamW steps


def annotate_lm(wh, model, params, tokens, *, body: tuple, head: tuple,
                stages: tuple | None = None):
    """Record tinyllama's forward as Whale subgraphs into the active
    cluster and return its loss: ``embed`` and ``block0`` … under the
    ``body`` scopes (e.g. ``("replica", "split")``), ``head`` (the final
    norm and the loss head) under the ``head`` scopes; with ``stages``
    (layers a stage) all inside ``wh.pipeline(micro_batch=PP_MICRO)``, one
    ``wh.stage()`` a stage, the embedding in the first and the head in the
    last.  On meta ``params`` and ``tokens`` nothing runs anywhere: the
    kernels' wrappers take their plain versions there, inside
    ``kernels.abstract()``."""
    import torch

    from repro_torch import kernels
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map

    cfg, (bcfg,) = model.cfg, model.stack.pattern
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    mask = torch.ones((B, S - 1), dtype=torch.float32, device=tokens.device)

    def scopes(kinds, stack):
        for k in kinds:
            stack.enter_context(getattr(wh, k)())

    def block(p, x, pos):
        return tfm.apply_block(p, x, pos, bcfg)[0]

    groups = (cfg.n_layers,) if stages is None else tuple(stages)
    i = 0
    with kernels.abstract(), contextlib.ExitStack() as outer:
        if stages is not None:
            outer.enter_context(wh.pipeline(micro_batch=PP_MICRO))
        for s, n in enumerate(groups):
            with contextlib.ExitStack() as st:
                if stages is not None:
                    st.enter_context(wh.stage())
                with contextlib.ExitStack() as inner:
                    scopes(body, inner)
                    if s == 0:
                        x = wh.sub("embed", lambda p, t: layers.embed(
                            p, t, cfg.padded_vocab).to(cfg.adtype))(
                                params["embed"], tokens)
                    for _ in range(n):
                        x = wh.sub(f"block{i}", block)(tree_map(
                            lambda t: t[i], params["blocks"]["p0"]), x,
                            positions)
                        i += 1
                if s == len(groups) - 1:
                    with contextlib.ExitStack() as inner:
                        scopes(head, inner)
                        nll, _, n_tok = wh.sub("head", model.head_loss)(
                            {k: params[k] for k in ("final_norm", "head")
                             if k in params}, x, tokens, mask)
    return nll / n_tok


def meta_inputs(torch, cfg, rows: int) -> tuple:
    """tinyllama at ``cfg`` on the meta device, its parameter shapes, and
    a (rows, TRAIN_SEQ) batch of token ids: what the meshed ranks record
    their annotations over, allocating nothing."""
    from repro_torch.models.lm import Model

    model = Model(cfg, "meta")
    return model, model.param_shapes(), torch.empty(
        (rows, TRAIN_SEQ), dtype=torch.int64, device="meta")


def placement_key(pl) -> tuple:
    """What a :class:`~repro_torch.core.hetero.HeteroPlacement` places:
    the stage layers and batch shares, and the priced times of the step
    and of each unit (its group, layers and rows) — all but the memory
    term, which depends on the schedule (gpipe holds more micro-batches
    in flight than 1f1b), and the ``strategy`` it carries."""
    def times(c):
        return (c.compute, c.comm, c.bubble, c.total, c.feasible)
    return (pl.layer_alloc, pl.batch_shares, times(pl.cost), tuple(
        (u.kind, u.group, u.layers, u.batch, times(u.cost))
        for u in pl.units))


def whale_annotations(torch, kernels) -> dict:
    """Phase 27, Cases 1 and 2's head on one process (a world of one over
    NCCL that ``wh.cluster`` starts): tinyllama at full width and depth,
    its forward recorded under ``wh.cluster(mesh_shape=(1,))`` — the
    embedding and 22 blocks under ``wh.replica()``, the loss head under
    ``wh.split(dim=-1)`` — on batch TRAIN_BATCH x TRAIN_SEQ, bf16.  Held:
    24 nodes, ``cluster_repeats`` folding the blocks into one group of 22;
    a ``capture_meta`` of one block leaves ``torch.cuda.memory_allocated``
    and every launch count unchanged; ``compile_plan_from_cluster``'s
    strategy equals the one written out, and its WH_STEPS AdamW steps
    equal, bit for bit (losses and every parameter), those of
    ``compile_plan`` with that strategy, from the same seed and batches;
    its launches those of the training path.  Printed: the graph's
    forward FLOPs from ``graph_from_taskgraph`` beside ``model_graph``'s.
    Returns the annotated plan's launch counts."""
    import numpy as np
    import torch.distributed as dist

    import repro_torch as wh
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.ir import capture_meta
    from repro_torch.core.planner import compile_plan
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models import transformer as tfm
    from repro_torch.models.lm import Model, model_graph
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten, tree_map

    cfg = get_config(ARCH)
    model = Model(cfg)
    data = TokenPipeline(DataCfg(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 vocab=cfg.vocab, seed=0), host_id=0,
                         n_hosts=1)
    batches = [torch.as_tensor(np.asarray(data.next_batch()["tokens"]))
               .cuda() for _ in range(WH_STEPS)]
    cl = wh.cluster(mesh_shape=(1,), axis_names=("data",))
    try:
        params = model.init(0)
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        with cl, torch.no_grad():
            loss = float(annotate_lm(wh, model, params, batches[0],
                                     body=("replica",), head=("split",)))
        torch.cuda.synchronize()
        tg = cl.taskgraph
        groups = [(g["nodes"][0].name, len(g["nodes"]),
                   g["nodes"][0].strategy_kinds())
                  for g in tg.cluster_repeats()]
        print(f"[wh] Case 1 + Case 2's head on {cl.shape} (a world of one "
              f"over {dist.get_backend()}): the annotated "
              f"forward, run on the card while recording, loss {loss:.6f} in "
              f"{time.perf_counter() - t0:.2f} s, launches "
              f"{read_counts(kernels)}; {len(tg.nodes)} nodes, "
              f"cluster_repeats (first node, size, scopes) {groups}; "
              f"virtual devices "
              f"{sorted({(n.vdevice.name, n.vdevice.axes) for n in tg.nodes})}",
              flush=True)
        if len(tg.nodes) != cfg.n_layers + 2 or [g[1] for g in groups] \
                != [1, cfg.n_layers, 1]:
            raise AssertionError(f"recorded graph {groups}")
        ours = wh.graph_from_taskgraph(tg, TRAIN_BATCH).workload_meta()
        cfgs = model_graph(cfg, TRAIN_BATCH, TRAIN_SEQ).workload_meta()
        print(f"[wh] forward FLOPs: graph_from_taskgraph(tg, "
              f"{TRAIN_BATCH}) {ours.fwd_flops:.6e} (counted on the meta "
              f"device: attention's full S x S scores, the head at the "
              f"padded vocab) beside model_graph(cfg, {TRAIN_BATCH}, "
              f"{TRAIN_SEQ}) {cfgs.fwd_flops:.6e} (analytic: causal half); "
              f"ratio {ours.fwd_flops / cfgs.fwd_flops:.4f}; parameter "
              f"bytes {ours.param_bytes:.6e} beside {cfgs.param_bytes:.6e}",
              flush=True)
        one = tree_map(lambda t: t[0], params["blocks"]["p0"])
        x = torch.zeros((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model),
                        dtype=cfg.adtype, device="cuda")
        pos = torch.arange(TRAIN_SEQ, device="cuda")[None].expand(
            TRAIN_BATCH, TRAIN_SEQ)
        (bcfg,) = model.stack.pattern
        torch.cuda.synchronize()
        reset_counts(kernels)
        before = torch.cuda.memory_allocated()
        _, outs, flops, _ = capture_meta(
            lambda p, h, q: tfm.apply_block(p, h, q, bcfg)[0], one, x, pos)
        after = torch.cuda.memory_allocated()
        launched = {k: v for k, v in read_counts(kernels).items() if v}
        print(f"[wh] capture_meta of one block at {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}: output {outs[0].shape} {outs[0].dtype}, "
              f"{flops:.6e} FLOPs; torch.cuda.memory_allocated {before} "
              f"before, {after} after; launches {launched or 'none'}",
              flush=True)
        if before != after or launched:
            raise AssertionError("the meta capture allocated or launched on "
                                 "the card")
        del params, one, x
        torch.cuda.empty_cache()

        written = StrategySpec(dp=1, vocab_split=True)
        derived = wh.strategy_from_taskgraph(cl)
        if derived != written:
            raise AssertionError(f"derived {derived}, want {written}")
        runs = {}
        for name, plan in (
                ("annotated", wh.compile_plan_from_cluster(cl, model)),
                ("explicit", compile_plan(model, cl.mesh, written))):
            p = plan.init_params(0)
            opt = adamw(lr=PP_LR)
            st = plan.init_opt(opt, p)
            step = plan.train_step_fn(opt)
            torch.cuda.synchronize()
            reset_counts(kernels)
            losses, secs = [], []
            for i, toks in enumerate(batches):
                t0 = time.perf_counter()
                p, st, m = step(p, st, plan.batch_slice({"tokens": toks}), i)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
            runs[name] = {"losses": losses, "seconds": secs, "params": p,
                          "counts": read_counts(kernels),
                          "strategy": plan.strategy.describe()}
            del st, step
            torch.cuda.empty_cache()
        a, b = runs["annotated"], runs["explicit"]
        same = all(torch.equal(u, v) for u, v in zip(
            flatten(a["params"])[1], flatten(b["params"])[1]))
        print(f"[wh] compile_plan_from_cluster: {a['strategy']} ({derived}); "
              f"{WH_STEPS} AdamW steps {a['losses']} (step seconds "
              f"{[round(t, 3) for t in a['seconds']]}) vs compile_plan with "
              f"the strategy written out {b['losses']}: losses equal "
              f"{a['losses'] == b['losses']}, every parameter equal bit for "
              f"bit {same}; launches {a['counts']}", flush=True)
        if a["losses"] != b["losses"] or not same:
            raise AssertionError("the annotated plan's steps differ from the "
                                 "explicitly compiled plan's")
        exp = train_expected(cfg.n_layers, WH_STEPS, cfg.padded_vocab)
        if a["counts"] != exp:
            raise AssertionError(f"launches {a['counts']}, want {exp}")
        if not all(math.isfinite(x) for x in a["losses"]):
            raise AssertionError(f"losses {a['losses']}")
        return a["counts"]
    finally:
        cl.close()


# ---------------------------------------------------------------------------
# phase 28: the MoE family (deepseek-moe-16b)
# ---------------------------------------------------------------------------

MOE = "deepseek-moe-16b"
MOE_SERVE = ["--arch", MOE, "--overrides", "param_dtype=bfloat16",
             "--requests", "8", "--batch-slots", "8", "--prompt-len", "256",
             "--gen", "32", "--max-len", "512"]
MOE_PAGED_ARGS = MOE_SERVE + ["--cache", "paged", "--page-size", "64"]
MOE_DENSE_ARGS = MOE_SERVE + ["--cache", "dense"]
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 3
MOE_TRAIN_ARGS = ["--arch", MOE, "--overrides",
                  f"n_layers={MOE_TRAIN_LAYERS}", "--batch",
                  str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
                  str(MOE_TRAIN_STEPS), "--optimizer", "adamw",
                  "--log-every", "1"]
#: the split's runs: name -> (layers, activation dtype): f32 at 1 layer,
#: held to f32's limits (the split's bf16 path runs in phase 32,
#: pipelined over model 2 and served split×2)
MOE_SPLIT_RUNS = {"f32": (1, "float32")}
MOE_SPLIT_BATCH, MOE_SPLIT_STEPS = 2, 2
MOE_EP_ROWS = 2                 # moe_block_ep: one row of 2048 a rank
#: the depth of the teacher-forced runs of (a) (of 28, cut to hold the
#: script's time; the driver serves all 28)
MOE_TF_LAYERS = 7
#: decode's floor: every expert weight read once a step (31.0 GB at
#: 3.35 TB/s; the port runs every expert on its capacity buffer)
MOE_EXPERT_BYTES = 28 * 64 * 3 * 2048 * 1408 * 2


@contextlib.contextmanager
def plain_on_card():
    """The kernels' wrappers run their plain PyTorch versions on CUDA
    tensors too (flash, paged decode, xent, the SSD scan): the plain path
    on the card."""
    from repro_torch.kernels.flash_attention import flash, paged
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.xent import xent

    mods = (flash, paged, xent, ssd)
    real = [m.plain for m in mods]
    for m in mods:
        m.plain = lambda t: True
    try:
        yield
    finally:
        for m, r in zip(mods, real):
            m.plain = r


def _moe_cfg(**kw):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE), **kw)


def moe_serve(torch, kernels) -> tuple:
    """Phase 28 (a): the serving driver on deepseek-moe-16b at full width
    and depth in bf16, paged (the path) and dense, 8 requests of 256 + 32
    tokens through 8 slots: launches (flash forward 28 an admission,
    paged decode 28 a step), the peak beside the weights and KV, the
    decode step's median against its floor.  Then teacher-forced logits
    (phase 26's: 2 prompts of 500, 16 forced steps) of one draw in bf16
    at MOE_TF_LAYERS layers:
    paged through the kernels, dense, and paged through the plain
    versions on the card; dense and plain each held within TF_PAIR times
    the larger of its and the paged run's own error (each against the
    same weights in f32 through the f32 kernels) of the paged run.  Then
    f32 at 2 layers, where routing seldom flips: paged through the
    kernels against the plain versions within 1e-4 + 1e-4|x|.  Returns
    the paged and dense runs' launch counts."""
    from repro_torch.core.planner import compile_plan
    from repro_torch.launch import serve
    from repro_torch.models.lm import Model, param_count
    from repro_torch.serving import server as srv
    from repro_torch.tree import flatten

    steps = []
    out = {}
    with host_timed(torch, srv.Server, "step", steps, live_slots):
        for cache, argv in (("paged", MOE_PAGED_ARGS),
                            ("dense", MOE_DENSE_ARGS)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            steps.clear()
            reset_counts(kernels)
            summary, server = serve.run(serve.parse_args(argv))
            counts = read_counts(kernels)
            peak = torch.cuda.max_memory_allocated()
            kv = server.pools if cache == "paged" else server.state["cache"]
            kv_bytes = sum(t.numel() * t.element_size()
                           for t in flatten(kv)[1])
            layers = server.model.cfg.n_layers
            n_params = param_count(server.model.param_shapes())
            full = [t for t, n in steps if n == 8]
            med = statistics.median(full or [t for t, _ in steps])
            floor = MOE_EXPERT_BYTES / PEAK_BYTES_PER_S
            print(f"[moe] serve {cache}: {summary['completed']} requests, "
                  f"{summary['tokens']} tokens, {summary['steps']} decode "
                  f"steps in {summary['seconds']:.3f} s; {n_params:,} "
                  f"parameters ({n_params * 2 / 2**30:.2f} GiB in bf16), KV "
                  f"{kv_bytes / 2**30:.3f} GiB, peak device memory "
                  f"{peak / 2**30:.2f} GiB; decode step median "
                  f"{med * 1e3:.2f} ms (host clock, synced; {len(full)} "
                  f"steps with 8 live slots) against the floor "
                  f"{floor * 1e3:.2f} ms (every expert weight read once: "
                  f"{MOE_EXPERT_BYTES / 1e9:.2f} GB at 3.35 TB/s), "
                  f"{med / floor:.2f}x; launches {counts}", flush=True)
            if summary["completed"] != 8:
                raise AssertionError(f"moe serve {cache}: "
                                     f"{summary['completed']} requests")
            want_pd = layers * summary["steps"] if cache == "paged" else 0
            if counts["flash_fwd"] != layers * 8 \
                    or counts["paged_decode"] != want_pd \
                    or sum(counts.values()) != counts["flash_fwd"] + want_pd:
                raise AssertionError(f"moe serve {cache}: launches {counts}")
            out[cache] = (counts, summary)
            del server
    torch.cuda.empty_cache()
    t_served = time.perf_counter()
    same, total = _same_tokens(out["paged"][1]["out_tokens"],
                               out["dense"][1]["out_tokens"])
    print(f"[moe] paged against dense tokens: {same} of {total} equal "
          f"position by position (random weights: flat logits, so a bf16 "
          f"near-tie may flip an argmax; the teacher-forced logits below "
          f"are what is held)", flush=True)

    model = Model(_moe_cfg(param_dtype="bfloat16", n_layers=MOE_TF_LAYERS))
    plan = compile_plan(model, None)
    params = model.serving_params(plan.init_params(0))
    tf = {"paged": teacher_forced(torch, model, plan, params, "paged"),
          "dense": teacher_forced(torch, model, plan, params, "dense")}
    with plain_on_card():
        tf["plain"] = teacher_forced(torch, model, plan, params, "paged")
    # the same weights in f32 (15.7 GB at 7 layers), largest leaf first,
    # each bf16 leaf freed as it goes
    leaves = sorted(((node, k) for node in _dicts(params) for k, v in
                     node.items() if isinstance(v, torch.Tensor)),
                    key=lambda nk: -nk[0][nk[1]].numel())
    for node, k in leaves:
        node[k] = node[k].float()
    del leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m32 = Model(_moe_cfg(param_dtype="float32", dtype="float32",
                         n_layers=MOE_TF_LAYERS))
    tf["f32"] = teacher_forced(torch, m32, compile_plan(m32, None), params,
                               "paged")
    print(f"[moe] the f32 yardstick's run: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
          f"{torch.cuda.mem_get_info()[1] / 2**30:.2f}", flush=True)
    del params
    torch.cuda.empty_cache()
    tol = TF_TOL["bfloat16"]
    own = {n: tf_gap(tf[n], tf["f32"], tol) for n in ("paged", "dense",
                                                      "plain")}
    for n, g in own.items():
        print(f"[moe] yardstick {n}: bf16's own error, its teacher-forced "
              f"logits against the same weights in f32 (paged, the f32 "
              f"kernels) at {MOE_TF_LAYERS} layers: max |diff| "
              f"{g['max_abs']:.3e}, "
              f"worst share of 0.02 + 0.02|x| {g['worst']:.3f}", flush=True)
    fails = []
    for name in ("dense", "plain"):
        # two bf16 computations, each within its own error of f32, lie
        # within the sum of the two of each other
        gate = TF_PAIR * max(own["paged"]["worst"], own[name]["worst"])
        g = tf_gap(tf[name], tf["paged"], tol)
        print(f"[moe] teacher-forced {name} against paged through the "
              f"kernels: max |diff| {g['max_abs']:.3e}, worst share "
              f"{g['worst']:.3f} against the gate {gate:.3f} ({TF_PAIR:g} "
              f"x the larger own error); by row {g['rows']}", flush=True)
        if not g["worst"] <= gate:
            fails.append(f"teacher-forced {name}: {g['worst']:.3f} beyond "
                         f"the gate {gate:.3f}")
    if not all(torch.isfinite(t).all() for t in tf.values()):
        fails.append("non-finite teacher-forced logits")
    del tf
    # f32, where routing seldom flips: through the kernels against the
    # plain versions within f32's limit
    m2 = Model(_moe_cfg(n_layers=2, dtype="float32"))
    plan2 = compile_plan(m2, None)
    params = m2.serving_params(plan2.init_params(0))
    got = teacher_forced(torch, m2, plan2, params, "paged")
    with plain_on_card():
        want = teacher_forced(torch, m2, plan2, params, "paged")
    del params
    g = tf_gap(got, want, TF_TOL["float32"])
    print(f"[moe] teacher-forced f32 at 2 layers, paged through the kernels "
          f"against the plain versions: max |diff| {g['max_abs']:.3e}, "
          f"worst share of 1e-4 + 1e-4|x| {g['worst']:.3f}", flush=True)
    if not g["worst"] <= 1:
        fails.append("f32 teacher-forced logits outside 1e-4 + 1e-4|x|")
    torch.cuda.empty_cache()
    print(f"[moe] serving seconds: the teacher-forced runs "
          f"{time.perf_counter() - t_served:.1f}", flush=True)
    if fails:
        raise AssertionError("; ".join(fails))
    return out["paged"][0], out["dense"][0]


def _dicts(tree: dict):
    """``tree`` and every dict inside it."""
    yield tree
    for v in tree.values():
        if isinstance(v, dict):
            yield from _dicts(v)


def _first_batch(torch, vocab: int, rows: int, seq: int = TRAIN_SEQ) -> dict:
    import numpy as np

    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    data = TokenPipeline(DataCfg(global_batch=rows, seq_len=seq,
                                 vocab=vocab, seed=0), host_id=0, n_hosts=1)
    return {"tokens": torch.as_tensor(
        np.asarray(data.next_batch()["tokens"])).cuda()}


def moe_train(torch, kernels) -> dict:
    """Phase 28 (b): the training driver on deepseek-moe-16b at full width
    and MOE_TRAIN_LAYERS layers, batch 4 x 2048, AdamW, MOE_TRAIN_STEPS
    steps: finite losses, ``moe_lb`` and ``moe_z``, the launches, the peak
    beside AdamW's state (the final checkpoint is gathered, neither copied
    to the host nor written: phase 11 writes one); then step 0's loss and
    every gradient leaf through the kernels against the plain versions on
    the card (bf16: 2e-2 + 2e-2|x|, each leaf within 5e-2 of its max, the
    routed experts' within TF_PAIR times the larger of that and the same
    step a row at a time: :func:`hold_grads`)."""
    from repro_torch.core.planner import accumulate, loss_and_grads
    from repro_torch.launch import train
    from repro_torch.models.lm import Model, param_count
    from repro_torch.tree import flatten

    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    written = []
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        with no_checkpoint_write(written):
            res = train.main(MOE_TRAIN_ARGS + ["--ckpt-dir", tmp])
        counts = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = _moe_cfg(n_layers=MOE_TRAIN_LAYERS)
    n = param_count(Model(cfg, "meta").param_shapes())
    exp = train_expected(MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, cfg.padded_vocab)
    secs = res["step_seconds"]
    tok = TRAIN_BATCH * TRAIN_SEQ
    print(f"[moe] train {MOE_TRAIN_LAYERS} layers: {n:,} parameters; losses "
          f"{res['losses']}, moe_lb {res['moe_lb']}, moe_z {res['moe_z']}; "
          f"step seconds {[round(x, 3) for x in secs]} "
          f"({tok / statistics.median(secs[1:]):.0f} tok/s after step 0); "
          f"peak device memory {peak / 2**30:.2f} GiB beside parameters, "
          f"gradients and AdamW moments {16 * n / 1e9:.2f} GB; final "
          f"checkpoint gathered at step {written} (host copy and write "
          f"skipped); launches {counts}", flush=True)
    if not all(math.isfinite(x) for x in res["losses"] + res["moe_lb"]
               + res["moe_z"]) or min(res["moe_lb"]) <= 0:
        raise AssertionError(f"moe train: losses {res['losses']}, moe_lb "
                             f"{res['moe_lb']}, moe_z {res['moe_z']}")
    if counts != exp:
        raise AssertionError(f"moe train: launches {counts}, want {exp}")
    torch.cuda.empty_cache()

    model = Model(cfg)
    params = model.init(0)
    batch = _first_batch(torch, cfg.vocab, TRAIN_BATCH)
    loss, _, g = loss_and_grads(model, params, batch)
    g = dict(zip(*flatten(g)))
    # bf16's rounding alone: the same step a row at a time (phase 23's
    # yardstick), its routing flips included
    _, _, g_rows = accumulate(model, params, batch, TRAIN_BATCH)
    yard = grad_gaps(dict(zip(*flatten(g_rows))), g)
    del g_rows
    with plain_on_card():
        loss_p, _, g_p = loss_and_grads(model, params, batch)
    del params
    rel = grad_gaps(g, dict(zip(*flatten(g_p))))
    del g, g_p
    torch.cuda.empty_cache()
    print(f"[moe] train step 0 through the kernels against the plain "
          f"versions on the card: loss {float(loss):.6f} vs "
          f"{float(loss_p):.6f}", flush=True)
    fails = hold_grads("moe train step 0", rel, yard,
                       GRAD_TOL[str(torch.bfloat16)])
    check_close("moe train step-0 loss", loss.detach(), loss_p.detach(),
                torch.bfloat16)
    if fails:
        raise AssertionError("; ".join(fails))
    return counts


#: the routed experts' leaves: a token whose top-6 set flips moves its
#: whole gradient from one expert to another
ROUTED = ("/moe/w_in", "/moe/w_gate", "/moe/w_out")


def grad_gaps(got: dict, want: dict) -> dict:
    """Per leaf, max |got − want| relative to the leaf's max |want|."""
    return {p: max_err(got[p], w) / max(float(w.abs().max()), 1e-30)
            for p, w in want.items()}


def hold_grads(tag: str, rel: dict, yard: dict | None, limit: float) -> list:
    """Print and hold per-leaf gradient gaps between two bf16 computations
    (``yard`` given) or against an f32 one: every leaf within ``limit`` of
    its max, but in bf16 the routed experts' within TF_PAIR times the
    larger of ``limit`` and the same leaf's gap in ``yard`` (bf16's own
    rounding: the step a row at a time) — two computations, each within
    its own error, lie within twice it of each other, and a flipped
    top-6 set moves a whole token's gradient between experts.  Returns
    the failures."""
    def lim(p):
        if yard is None or not p.endswith(ROUTED):
            return limit
        return TF_PAIR * max(limit, yard[p])

    dense = {p: v for p, v in rel.items() if not p.endswith(ROUTED)}
    experts = {p: v for p, v in rel.items() if p.endswith(ROUTED)}
    wd = max(dense, key=dense.get)
    we = max(experts, key=experts.get)
    print(f"[moe] {tag}: gradients' max |diff| relative to the leaf's max: "
          f"worst outside the routed experts {dense[wd]:.3e} ({wd}; limit "
          f"{limit:g}), median {statistics.median(dense.values()):.3e}; "
          f"worst routed {experts[we]:.3e} ({we}; limit {lim(we):.3e}"
          + (f", the row-at-a-time yardstick {yard[we]:.3e}"
             if yard is not None else "") + ")", flush=True)
    return [f"{tag} gradient {p}: {v:.3e} of the leaf's max beyond "
            f"{lim(p):.3e}" for p, v in rel.items() if v > lim(p)]


def _route_recorder(torch, record: list):
    """Wrap ``moe._route`` so each call appends its expert ids (host)."""
    from repro_torch.models import moe

    real = moe._route

    def route(*a, **kw):
        out = real(*a, **kw)
        record.append(out[2].detach().sort(-1).values.cpu())
        return out

    moe._route = route
    return real


def _moe_steps(torch, plan, params, first: dict, routing: list,
               stats: dict | None = None) -> dict:
    """MOE_SPLIT_STEPS AdamW steps (a constant PP_LR) of ``plan`` from
    ``params`` on the driver's stream of MOE_SPLIT_BATCH x TRAIN_SEQ
    batches: losses, step and gloo seconds; ``first`` gets the step-0
    gradient, ``routing`` step 0's first forward's expert ids."""
    import dataclasses

    import numpy as np

    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models import moe
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten

    opt = adamw(lr=PP_LR)
    state = plan.init_opt(opt, params)
    real_apply = opt.apply

    def apply(grads, *args, **kw):
        if not first:
            first.update(zip(*flatten(grads)))
        return real_apply(grads, *args, **kw)

    step_fn = plan.train_step_fn(dataclasses.replace(opt, apply=apply))
    data = TokenPipeline(DataCfg(global_batch=MOE_SPLIT_BATCH,
                                 seq_len=TRAIN_SEQ,
                                 vocab=plan.model.cfg.vocab, seed=0),
                         host_id=0, n_hosts=1)
    out = {"losses": [], "seconds": [], "gloo_s": []}
    layers = plan.model.cfg.n_layers
    for i in range(MOE_SPLIT_STEPS):
        batch = plan.batch_slice({"tokens": torch.as_tensor(
            np.asarray(data.next_batch()["tokens"])).cuda()})
        rec = []
        real = _route_recorder(torch, rec) if i == 0 else None
        s0 = stats["s"] if stats else 0.0
        t0 = time.perf_counter()
        try:
            params, state, m = step_fn(params, state, batch, i)
            torch.cuda.synchronize()
        finally:
            if real is not None:
                moe._route = real
        out["seconds"].append(time.perf_counter() - t0)
        out["gloo_s"].append((stats["s"] if stats else 0.0) - s0)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            routing.extend(rec[:layers])
    return out


def _moe_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of phase 28 (c, d) on ``cuda:0``, a gloo world of two.
    (d) ``moe_block_ep`` at deepseek's block shape in f32 on this rank's
    row and 32 experts, against ``moe_block`` on both rows and all 64
    experts here.  (c) For each of MOE_SPLIT_RUNS, rank 0 first runs the
    unsharded steps while rank 1 waits; then both run
    ``compile_plan(StrategySpec(tp=2, ep=2))`` from the same draw (each
    rank draws the model and keeps its blocks), its step-0 gradient
    gathered onto rank 0 leaf by leaf and held there; then, at f32, the
    plan ``compile_nested_plan`` lowers from the M6 nesting recorded as
    annotations (``replica{split[experts]}``: dp 1, ep 2, the vocab
    whole), its losses against the unsharded ones."""
    import dataclasses

    import torch
    import torch.distributed as dist

    import repro_torch as wh
    from repro_torch.core import sharding
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.models import moe
    from repro_torch.models.lm import Model
    from repro_torch.tree import flatten, unflatten

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    kernels = kernel_wrappers()
    stats = {"s": 0.0, "n": 0}
    time_collectives(torch, dist, stats)
    world = dist.group.WORLD
    out = {}
    try:
        # (d) moe_block_ep against moe_block
        t0 = time.perf_counter()
        mcfg = _moe_cfg().moe_cfg()
        gen = torch.Generator(device="cuda").manual_seed(28)
        full = moe.init_moe(gen, mcfg, torch.float32, "cuda")
        x = torch.randn((MOE_EP_ROWS, TRAIN_SEQ, mcfg.d_model),
                        generator=gen, device="cuda")
        ct = torch.randn(x.shape, generator=gen, device="cuda")
        leaves = lambda p: dict(zip(*flatten(p)))
        p = {k: v.requires_grad_(True) for k, v in leaves(full).items()}
        xr = x.clone().requires_grad_(True)
        y, aux = moe.moe_block(unflatten(list(p), list(p.values())), xr,
                               mcfg)
        ((y * ct).sum() + aux["lb_loss"] + aux["z_loss"]).backward()
        want = {"y": y.detach(), "lb": aux["lb_loss"].detach(),
                "z": aux["z_loss"].detach(), "gx": xr.grad,
                **{f"g/{k}": v.grad for k, v in p.items()}}
        del y, aux, xr
        El = mcfg.n_experts // 2
        rows = slice(rank, rank + 1)
        loc = {k: (v.detach()[rank * El:(rank + 1) * El] if k.startswith(
            "w_") else v.detach()).clone().requires_grad_(True)
            for k, v in p.items()}
        del p
        xl = x[rows].clone().requires_grad_(True)
        reset_counts(kernels)
        y, aux = moe.moe_block_ep(unflatten(list(loc), list(loc.values())),
                                  xl, mcfg, world)
        ((y * ct[rows]).sum() + aux["lb_loss"] + aux["z_loss"]).backward()
        got = {"y": y.detach(), "lb": aux["lb_loss"].detach(),
               "z": aux["z_loss"].detach(), "gx": xl.grad,
               **{f"g/{k}": v.grad for k, v in loc.items()}}
        errs = {}
        for k, g in got.items():
            w = want[k]
            if k in ("y", "gx"):
                w = w[rows]
            elif k.startswith("g/w_"):
                w = w[rank * El:(rank + 1) * El]
            tol = TOL["torch.float32"] if k in ("y", "lb", "z") \
                else GRAD_TOL["torch.float32"]
            scale = 1.0 if k in ("y", "lb", "z") else max(
                float(w.abs().max()), 1e-30)
            errs[k] = check_close(f"moe_block_ep {k}", g / scale, w / scale,
                                  torch.float32, tol)
        out["ep"] = {"errs": errs, "s": time.perf_counter() - t0,
                     "counts": read_counts(kernels)}
        del want, got, loc, full, x, ct, y, aux
        torch.cuda.empty_cache()

        # (c) the split with the experts over the model axis
        strat = StrategySpec(tp=2, ep=2)
        mesh = mesh_for_strategy(strat)
        for name, (layers, dtype) in MOE_SPLIT_RUNS.items():
            cfg = _moe_cfg(n_layers=layers, dtype=dtype)
            run = {}
            ref_first, ref_routing = {}, []
            if rank == 0:
                model = Model(cfg)
                r = _moe_steps(torch, compile_plan(model, None),
                               model.init(0), ref_first, ref_routing)
                run["ref"] = r
                ref_first = {k: v.cpu() for k, v in ref_first.items()}
                torch.cuda.empty_cache()
            dist.barrier()
            model = Model(cfg)
            plan = compile_plan(model, mesh, strat)
            first, routing = {}, []
            torch.cuda.synchronize()
            reset_counts(kernels)
            n0 = stats["n"]
            r = _moe_steps(torch, plan, plan.shard(model.init(0),
                                                   plan.param_specs),
                           first, routing, stats=stats)
            r["counts"] = read_counts(kernels)
            r["collectives"] = stats["n"] - n0
            r["local_params"] = sum(v.numel() for v in first.values())
            r["local_experts"] = int(first["blocks/p0/moe/w_in"].shape[1])
            specs = dict(zip(*flatten(plan.param_specs)))
            rel = {}
            for path in sorted(first):
                g = sharding.gather_leaf(first[path], specs[path], plan.rules)
                if rank == 0:
                    w = ref_first[path].to(g.device)
                    rel[path] = max_err(g, w) / max(float(w.abs().max()),
                                                    1e-30)
                del g
            del first
            run["split"] = r
            if rank == 0:
                run["grads_rel"] = rel
                flips = sum(int((a != b).any(-1).sum())
                            for a, b in zip(routing, ref_routing))
                run["routing"] = [flips, sum(a.shape[0] * a.shape[1]
                                             for a in routing)]
            del plan, ref_first
            torch.cuda.empty_cache()
            if name == "f32":
                # the M6 nesting, recorded and lowered
                with wh.cluster(mesh=mesh) as cl:
                    w8 = {"w": torch.ones((8, 8), device="cuda")}
                    net = lambda p, h: h @ p["w"]
                    with wh.replica():
                        h = wh.sub("attn", net)(w8, torch.ones(
                            (4, 8), device="cuda"))
                        with wh.split(experts=True):
                            h = wh.sub("moe", net)(w8, h)
                        wh.sub("out", net)(w8, h)
                nested = wh.compile_nested_plan(cl, model)
                r = _moe_steps(torch, nested, nested.shard(
                    model.init(0), nested.param_specs), {}, [])
                run["m6"] = {"losses": r["losses"],
                             "strategy": dataclasses.asdict(nested.strategy),
                             "describe": wh.lower(cl).describe()}
                del nested
                torch.cuda.empty_cache()
            out[name] = run
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def moe_family(torch, kernels) -> dict:
    """Phase 28: (a) serving, (b) training, (c, d) the expert split and
    ``moe_block_ep`` on two ranks; the launch counts of each path."""
    free, total = torch.cuda.mem_get_info()
    print(f"[moe] device memory free at the start: {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    paged, dense = moe_serve(torch, kernels)
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    train = moe_train(torch, kernels)
    t2 = time.perf_counter()
    torch.cuda.empty_cache()
    split = moe_split(torch)
    print(f"[moe] seconds: serving {t1 - t0:.1f}, training {t2 - t1:.1f}, "
          f"the two ranks {time.perf_counter() - t2:.1f}", flush=True)
    return {"serve_moe": paged, "serve_moe_dense": dense,
            "train_moe": train, "train_moe_split": split}


def moe_split(torch) -> dict:
    """Phase 28 (c, d) from two ranks on ``cuda:0`` over gloo
    (:func:`_moe_rank`).  Everything is printed before it is held:
    ``moe_block_ep`` within f32's 2e-5 (values) and 2e-4 of each leaf's
    max (gradients) of ``moe_block``; the split in f32 at 1 layer, every
    loss within 1e-4 + 1e-4|x| and each gradient leaf within 2e-4 of the
    unsharded step's; the routing assignments that differ from the
    unsharded step-0 forward counted; the M6 nesting derives
    ``StrategySpec(ep=2, vocab_split=False)`` and its losses hold to the
    f32 limit.  Returns the ranks' summed launches of the split."""
    import dataclasses

    from repro_torch.core.cost_model import StrategySpec

    ranks = spawn_ranks(_moe_rank, timeout=600)
    fails = []
    for r, o in enumerate(ranks):
        print(f"[moe] moe_block_ep rank {r} (f32, 1 row of {TRAIN_SEQ}, 32 "
              f"of 64 experts, top-6 + 2 shared) against moe_block on 2 "
              f"rows and 64 experts: max |err| {o['ep']['errs']} (gradients "
              f"relative to the leaf's max); {o['ep']['s']:.2f} s; launches "
              f"{o['ep']['counts']}", flush=True)
        if any(o["ep"]["counts"].values()):
            fails.append("moe_block_ep launched a kernel")
    (name, (layers, _)), = MOE_SPLIT_RUNS.items()
    cfg = _moe_cfg(n_layers=layers)
    exp = train_expected(layers, MOE_SPLIT_STEPS, cfg.padded_vocab // 2,
                         rows=MOE_SPLIT_BATCH)
    ref = ranks[0][name]["ref"]["losses"]
    got = ranks[0][name]["split"]["losses"]
    for r, o in enumerate(ranks):
        s = o[name]["split"]
        print(f"[moe] split {name} ({layers} layers), model rank {r}: "
              f"{s['local_params']:,} parameters, {s['local_experts']} "
              f"experts a layer; losses {s['losses']}, step seconds "
              f"{[round(x, 3) for x in s['seconds']]} (two processes "
              f"time-slice one card), gloo seconds "
              f"{[round(x, 3) for x in s['gloo_s']]} over "
              f"{s['collectives']} collectives; launches {s['counts']}",
              flush=True)
        if s["losses"] != got:
            fails.append(f"{name}: the ranks report different losses")
        if s["counts"] != exp:
            fails.append(f"split rank {r}: launches {s['counts']}, want "
                         f"{exp}")
    rel = ranks[0][name]["grads_rel"]
    diffs = [abs(a - b) for a, b in zip(got, ref)]
    flips, total = ranks[0][name]["routing"]
    print(f"[moe] split {name} against unsharded: losses {got} vs {ref}, "
          f"|diff| by step {diffs}; routing: {flips} of {total} tokens' "
          f"top-6 sets differ from the unsharded step-0 forward", flush=True)
    if any(d > TP_F32_LIMIT + TP_F32_LIMIT * abs(x)
           for d, x in zip(diffs, ref)):
        fails.append(f"f32 losses |diff| {diffs}")
    fails += hold_grads("split f32 step 0 against unsharded", rel, None,
                        GRAD_TOL[str(torch.float32)])
    m6 = ranks[0][name]["m6"]
    want = dataclasses.asdict(StrategySpec(ep=2, vocab_split=False))
    m6d = [abs(a - b) for a, b in zip(m6["losses"], ref)]
    print(f"[moe] M6 nesting replica{{split[experts]}} recorded on 2 ranks: "
          f"lower: {m6['describe']}; compile_nested_plan's losses "
          f"{m6['losses']} vs unsharded {ref}, |diff| {m6d}", flush=True)
    if m6["strategy"] != want:
        fails.append(f"M6 nesting derived {m6['strategy']}")
    if any(d > TP_F32_LIMIT + TP_F32_LIMIT * abs(x)
           for d, x in zip(m6d, ref)):
        fails.append(f"M6 nesting losses |diff| {m6d}")
    if fails:
        raise AssertionError("; ".join(fails))
    return {k: sum(r[name]["split"]["counts"][k] for r in ranks)
            for k in exp}


# ---------------------------------------------------------------------------
# phase 29: the compressed cross-pod reduction over model shards and ZeRO
# ---------------------------------------------------------------------------

CB_SEQ = 1024                   # phase 29: tinyllama's width, one layer
CB_STEPS = 2                    # step 1 carries step 0's error
CB_ZEROS = (0, 1, 3)
CB_MAX_FLIPS = 0.01             # int8 flips allowed against the yardstick


def block_gaps(torch, got, want, quantum: float, ulps_of: float) -> dict:
    """Elementwise gaps of one leaf against its yardstick: |d| within four
    roundings (of |want| and of ``ulps_of``) is a rounding; beyond that,
    at most one ``quantum`` more is a flipped int8 value; any more is a
    miss.  Returns the max |d|, the flips and the misses."""
    eps = torch.finfo(torch.float32).eps
    d = (got.float() - want.float()).abs()
    tight = 4 * eps * (want.float().abs() + abs(ulps_of)) + 1e-30
    flips = d > tight
    miss = d > (quantum + tight) * (1 + 1e-6)
    return {"max_abs": float(d.max()), "flips": int(flips.sum()),
            "misses": int(miss.sum()), "n": d.numel()}


def _cb_rank(rank: int, store: str, out_dir: str) -> None:
    """One rank of phase 29 on ``cuda:0``, in a gloo world of four.
    (a) pod 2 x data 2, compressed ZeRO 0, 1 and 3: CB_STEPS AdamW steps
    each from the same seed and batches (4 x CB_SEQ, a row a rank), with
    step and gloo seconds, peaks and launches; rank 0 holds ZeRO-1's and
    ZeRO-3's step-0 handed gradients and their gathered parameters,
    moments and error carry after the steps against ZeRO-0's, bit for bit.
    (b) pod 2 x model 2 (2 x CB_SEQ): one compressed step; its in-pod
    gradients, handed gradients and error carry gathered whole over
    ``model``; on model rank 0 of each pod the same pods' whole in-pod
    leaves through ``compressed_psum_plain`` on the pod group, and every
    leaf's gaps (:func:`block_gaps`).  (c) (b) with the block's scale its
    own (the MAX over ``model`` left out): the planted fault."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import sharding
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.models.lm import Model
    from repro_torch.optim import grad_compress as gc
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten, tree_map

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    kernels = kernel_wrappers()
    stats = {"s": 0.0, "n": 0}
    time_collectives(torch, dist, stats)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=1)

    def plan_of(strat):
        return compile_plan(Model(cfg), mesh_for_strategy(strat, pods=2),
                            strat, compress_pod=True)

    def batches(plan, rows, n):
        data = TokenPipeline(DataCfg(global_batch=rows, seq_len=CB_SEQ,
                                     vocab=cfg.vocab, seed=0), host_id=0,
                             n_hosts=1)
        return [{k: v.cuda() for k, v in plan.batch_slice({
            "tokens": torch.as_tensor(np.asarray(
                data.next_batch()["tokens"]))}).items()} for _ in range(n)]

    def spy(seen):
        opt = adamw(lr=PP_LR)
        real = opt.apply

        def apply(grads, state, p, step, **kw):
            if step == 0:
                seen["handed"] = dict(zip(*flatten(grads)))
                seen["handed"] = {k: v.clone() for k, v in
                                  seen["handed"].items()}
            return real(grads, state, p, step, **kw)
        return dataclasses.replace(opt, apply=apply)

    def gathered(tree: dict, plan) -> dict:
        return {k: sharding.gather_leaf(v, s, plan.rules) for (k, v), s in
                zip(tree.items(), flatten(plan.param_specs)[1])}

    out = {"zero": {}}
    try:
        whole0 = handed0 = None
        for z in CB_ZEROS:
            plan = plan_of(StrategySpec(dp=4, zero=z))
            seen = {}
            opt = spy(seen)
            params = plan.init_params(0)
            st = {"params": params, "opt": plan.init_opt(opt, params),
                  "err": gc.init_error_tree(params)}
            step = plan.train_step_fn(opt, compress_pod=True)
            rec = {"losses": [], "seconds": [], "gloo_s": [], "peak": 0}
            torch.cuda.synchronize()
            reset_counts(kernels)
            for i, batch in enumerate(batches(plan, 4, CB_STEPS)):
                torch.cuda.reset_peak_memory_stats()
                s0, t0 = stats["s"], time.perf_counter()
                p, o, m, e = step(st["params"], st["opt"], batch, i,
                                  st["err"])
                torch.cuda.synchronize()
                st = {"params": p, "opt": o, "err": e}
                rec["seconds"].append(time.perf_counter() - t0)
                rec["gloo_s"].append(stats["s"] - s0)
                rec["peak"] = max(rec["peak"],
                                  torch.cuda.max_memory_allocated())
                rec["losses"].append(float(m["loss"]))
            rec["counts"] = read_counts(kernels)
            rec["leaves"] = len(flatten(params)[1])
            rec["split"] = {k: list(v.shape) for k, v in
                            zip(*flatten(st["params"]))}
            handed = gathered(seen.pop("handed"), plan)
            full = plan.gather_state(st, opt)
            if rank == 0:
                full = tree_map(torch.Tensor.cpu, full)
                handed = {k: v.cpu() for k, v in handed.items()}
                if z == 0:
                    whole0, handed0 = full, handed
                else:
                    (pa, la), (pb, lb) = flatten(full), flatten(whole0)
                    rec["state_equal"] = pa == pb and all(
                        torch.equal(a, b) for a, b in zip(la, lb))
                    rec["err_equal"] = all(
                        torch.equal(a, b) for a, b in zip(
                            flatten(full["err"])[1],
                            flatten(whole0["err"])[1]))
                    rec["handed_equal"] = all(
                        torch.equal(handed[k], v) for k, v in
                        handed0.items())
            out["zero"][str(z)] = rec
            del st, p, o, e, params, full, handed, plan
            torch.cuda.empty_cache()
        del whole0, handed0

        # (b) and (c): pod 2 x model 2
        for tag in ("split", "planted"):
            plan = plan_of(StrategySpec(dp=2, tp=2))
            seen = {}
            real_tree, real_max = gc.compressed_psum_tree, gc._leaf_max

            def spy_tree(grads, group, err_tree, **kw):
                seen["inpod"] = {k: v.clone() for k, v in
                                 zip(*flatten(grads))}
                return real_tree(grads, group, err_tree, **kw)

            gc.compressed_psum_tree = spy_tree
            if tag == "planted":
                gc._leaf_max = lambda s, groups: s
            opt = spy(seen)
            params = plan.init_params(0)
            step = plan.train_step_fn(opt, compress_pod=True)
            (batch,) = batches(plan, 2, 1)
            torch.cuda.synchronize()
            reset_counts(kernels)
            s0, t0 = stats["s"], time.perf_counter()
            try:
                _, _, m, err = step(params, plan.init_opt(opt, params),
                                    batch, 0, gc.init_error_tree(params))
                torch.cuda.synchronize()
            finally:
                gc.compressed_psum_tree, gc._leaf_max = real_tree, real_max
            rec = {"seconds": time.perf_counter() - t0,
                   "gloo_s": stats["s"] - s0, "loss": float(m["loss"]),
                   "counts": read_counts(kernels),
                   "split": {k: list(v.shape) for k, v in
                             zip(*flatten(params))}}
            inpod = gathered(seen.pop("inpod"), plan)
            handed = gathered(seen.pop("handed"), plan)
            err = gathered(dict(zip(*flatten(err))), plan)
            if plan.rules.index("model") == 0:
                pod_g = plan.mesh.get_group("pod")
                gaps = {}
                for k, x in inpod.items():
                    smax = x.abs().max().reshape(1) / 127
                    dist.all_reduce(smax, op=dist.ReduceOp.MAX,
                                    group=pod_g)
                    smax = float(smax)
                    po, pe = gc.compressed_psum_plain(x, pod_g, None)
                    gaps[k] = {
                        "out": block_gaps(torch, handed[k], po, smax / 2,
                                          0.0),
                        "err": block_gaps(torch, err[k], pe, 2 * smax,
                                          127 * smax),
                        "bits": bool(torch.equal(handed[k], po)
                                     and torch.equal(err[k], pe))}
                    del po, pe
                rec["gaps"] = gaps
            out[tag] = rec
            del inpod, handed, err, params, plan
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _cb_verdict(gaps: dict) -> tuple:
    """(holds, worst leaf line) of a run's per-leaf gaps: every leaf's out
    and err without a miss and with flips on at most CB_MAX_FLIPS of its
    elements."""
    ok, worst, line = True, -1.0, ""
    for k, g in gaps.items():
        for what in ("out", "err"):
            x = g[what]
            share = x["flips"] / x["n"]
            if x["misses"] or share > CB_MAX_FLIPS:
                ok = False
            score = x["misses"] + share
            if score > worst:
                worst = score
                line = (f"{k} {what}: max |diff| {x['max_abs']:.3e}, "
                        f"{x['flips']} flips of {x['n']}, {x['misses']} "
                        f"beyond a quantum")
    return ok, line


def compressed_blocks(torch) -> dict:
    """Phase 29: the compressed cross-pod reduction on blocks of leaves,
    four ranks sharing ``cuda:0`` over gloo (:func:`_cb_rank`),
    tinyllama at full width and one layer.  Printed: each ZeRO level's
    losses, step and gloo seconds, peak and launches a rank; the
    pod 2 x model 2 step's gaps against the whole leaves through
    ``compressed_psum_plain``.  Held: ZeRO-1 and ZeRO-3 equal ZeRO-0 bit
    for bit (losses; the handed gradients; parameters, moments and error
    carry after the steps); the three encode kernels launch once per leaf
    and step on every rank; the split step within one rounding, plus one
    quantum where an int8 value flips (on at most 1% of a leaf), and the
    planted per-block scale outside that gate.  Returns the launches of
    ZeRO-3's steps and of the split step, summed over ranks."""
    t0 = time.perf_counter()
    ranks = spawn_ranks(_cb_rank, nprocs=4, timeout=500)
    print(f"[compress-blocks] four ranks {time.perf_counter() - t0:.1f} s",
          flush=True)
    fails = []
    for r, o in enumerate(ranks):
        for z, rec in o["zero"].items():
            print(f"[compress-blocks] rank {r} pod 2 x data 2 zero={z} "
                  f"(blocks {rec['split']['embed/table']} of the table): "
                  f"losses {rec['losses']}; step seconds "
                  f"{[round(x, 3) for x in rec['seconds']]}, gloo "
                  f"{[round(x, 3) for x in rec['gloo_s']]}; peak "
                  f"{rec['peak'] / 2**30:.3f} GiB; launches {rec['counts']}",
                  flush=True)
            want = rec["leaves"] * CB_STEPS
            if any(rec["counts"][k] != want for k in
                   ("ef_absmax", "ef_requant", "ef_decode")) \
                    or rec["counts"]["quantize"] \
                    or rec["counts"]["dequantize"]:
                fails.append(f"rank {r} zero={z}: launches "
                             f"{rec['counts']}, want {want} of each encode "
                             f"kernel")
            if rec["losses"] != o["zero"]["0"]["losses"]:
                fails.append(f"rank {r} zero={z}: losses differ from zero=0")
            if r == 0 and z != "0":
                flags = {k: rec[k] for k in ("handed_equal", "state_equal",
                                             "err_equal")}
                print(f"[compress-blocks] zero={z} against zero=0 bit for "
                      f"bit: {flags}", flush=True)
                if not all(flags.values()):
                    fails.append(f"zero={z} differs from zero=0: {flags}")
    caught = []
    for tag in ("split", "planted"):
        for r, o in enumerate(ranks):
            rec = o[tag]
            if "gaps" not in rec:
                continue
            ok, line = _cb_verdict(rec["gaps"])
            bits = sum(g["bits"] for g in rec["gaps"].values())
            print(f"[compress-blocks] rank {r} pod 2 x model 2 {tag} "
                  f"(wi shards {rec['split']['blocks/p0/mlp/wi']}): loss "
                  f"{rec['loss']:.6f}, step {rec['seconds']:.3f} s (gloo "
                  f"{rec['gloo_s']:.3f}); against the pods' whole leaves "
                  f"through compressed_psum_plain: {bits} of "
                  f"{len(rec['gaps'])} leaves bit for bit, worst {line}; "
                  f"{'within' if ok else 'outside'} the gate; launches "
                  f"{rec['counts']}", flush=True)
            if tag == "split" and not ok:
                fails.append(f"pod 2 x model 2, rank {r}: outside the gate")
            if tag == "planted":
                caught.append(not ok)
    if not any(caught):
        fails.append("the planted per-block scale passed the gate")
    if fails:
        raise AssertionError("; ".join(fails))

    def total(get):
        return {k: sum(get(o)[k] for o in ranks)
                for k in ranks[0]["split"]["counts"]}

    return {"train_compressed_zero3": total(
                lambda o: o["zero"]["3"]["counts"]),
            "train_compressed_split": total(lambda o: o["split"]["counts"])}


# ---------------------------------------------------------------------------
# phase 30: mamba2-1.3b training at full width and depth
# ---------------------------------------------------------------------------

M2_TRAIN_STEPS = 2
#: the depth of step 0's bf16 agreement through the kernels against the
#: plain versions (of 48, cut to hold the script's time; f32 holds it at
#: 2 layers)
M2_AGREE_LAYERS = 8
M2_TRAIN_ARGS = ["--arch", MAMBA, "--batch", str(TRAIN_BATCH), "--seq",
                 str(TRAIN_SEQ), "--steps", str(M2_TRAIN_STEPS),
                 "--optimizer", "adamw", "--log-every", "1"]


def mamba2_train(torch, kernels) -> dict:
    """Phase 30: the training driver on mamba2-1.3b at full width and
    depth (48 layers, batch 4 x 2048, AdamW, remat full; the SSD mixer
    through the differentiable chunked scan, the tied head through the
    xent kernels), M2_TRAIN_STEPS steps: finite losses, launches (the xent
    kernels only), tokens/s after step 0, the peak beside the state (the
    final checkpoint gathered, neither copied to the host nor written).  Then
    one step split on the host clock (forward, backward, AdamW), one step
    under torch.profiler (device busy, top kernels), and one layer's
    ``ssd_scan`` (two forwards, as remat full runs it, and a backward)
    under the profiler at the step's shape: its share of the step's device
    time.  Then step 0's loss and every gradient leaf through the kernels
    against the plain versions on the card: a 2-layer f32 model within
    1e-4 + 1e-4|x|; the full model in bf16 within TF_PAIR times bf16's own
    error per leaf (the plain bf16 step against the same weights' f32
    step, relative to the leaf's max)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.planner import loss_and_grads
    from repro_torch.kernels.xent import xent
    from repro_torch.launch import train
    from repro_torch.models import mamba2
    from repro_torch.models.lm import Model, param_count
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten, tree_map, unflatten

    cfg = get_config(MAMBA)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mamba2_train_")
    written = []
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        with no_checkpoint_write(written):
            res = train.main(M2_TRAIN_ARGS + ["--ckpt-dir", tmp])
        counts = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = param_count(Model(cfg, "meta").param_shapes())
    T = TRAIN_BATCH * (TRAIN_SEQ - 1)
    want = dict.fromkeys(counts, 0)
    want["xent_fwd"] = M2_TRAIN_STEPS
    want["xent_bwd"] = M2_TRAIN_STEPS * -(-cfg.padded_vocab
                                          // xent.bwd_chunk(T,
                                                            cfg.padded_vocab))
    secs = res["step_seconds"]
    tok = TRAIN_BATCH * TRAIN_SEQ
    print(f"[mamba2-train] {n:,} parameters, 48 layers, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses {res['losses']}; step "
          f"seconds {[round(x, 3) for x in secs]} "
          f"({tok / statistics.median(secs[1:]):.1f} tok/s after step 0); "
          f"peak device memory {peak / 2**30:.2f} GiB beside parameters, "
          f"gradients and AdamW moments {16 * n / 1e9:.2f} GB; final "
          f"checkpoint gathered at step {written} (host copy and write "
          f"skipped); launches {counts}", flush=True)
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"mamba2 train: losses {res['losses']}")
    if counts != want:
        raise AssertionError(f"mamba2 train: launches {counts}, want {want}")
    torch.cuda.empty_cache()

    # where the time goes
    model = Model(cfg)
    params = model.init(0)
    opt = adamw(lr=1e-4)
    state = opt.init(params)
    paths, leaves = flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    toks = np.random.default_rng(0).integers(0, cfg.vocab,
                                             (TRAIN_BATCH, TRAIN_SEQ))
    batch = {"tokens": torch.tensor(toks, device="cuda")}

    def step(times=None):
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.apply(unflatten(paths, list(grads)), state, params, 1)
        torch.cuda.synchronize()
        if times is not None:
            times.append((t1 - t0, t2 - t1, time.perf_counter() - t2))

    step()                                          # warm-up
    times = []
    step(times)
    fwd, bwd, upd = (x * 1e3 for x in times[0])
    print(f"[mamba2-train] one step on the host clock: forward {fwd:.1f} "
          f"ms, backward (with the checkpointed recompute) {bwd:.1f} ms, "
          f"AdamW {upd:.1f} ms; total {fwd + bwd + upd:.1f} ms = "
          f"{tok / (fwd + bwd + upd) * 1e3:.1f} tokens/s", flush=True)
    step_ms, busy_ms, prof = profiled(torch, step, 1)
    del state, opt
    torch.cuda.empty_cache()
    # one layer's scan at the step's shape, as remat full runs it: the
    # forward, its recompute in the backward, and the backward
    scfg = cfg.ssd_cfg()
    gen = torch.Generator(device="cuda").manual_seed(30)
    H, P, N = scfg.n_heads, scfg.headdim, scfg.d_state
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    x = rnd(TRAIN_BATCH, TRAIN_SEQ, H, P).bfloat16().requires_grad_(True)
    dt = torch.nn.functional.softplus(rnd(TRAIN_BATCH, TRAIN_SEQ, H) - 1.0
                                      ).requires_grad_(True)
    A = -torch.exp(0.3 * rnd(H))
    Bm = (0.3 * rnd(TRAIN_BATCH, TRAIN_SEQ, 1, N)).bfloat16(
        ).requires_grad_(True)
    Cm = (0.3 * rnd(TRAIN_BATCH, TRAIN_SEQ, 1, N)).bfloat16(
        ).requires_grad_(True)

    def scan_layer():
        with torch.no_grad():
            mamba2.ssd_scan(x, dt, A, Bm, Cm, scfg.chunk)
        y, h = mamba2.ssd_scan(x, dt, A, Bm, Cm, scfg.chunk)
        torch.autograd.grad(y.float().sum() + h.sum(), (x, dt, Bm, Cm))

    scan_layer()
    _, scan_busy, _ = profiled(torch, scan_layer, 1)
    del x, dt, Bm, Cm
    if busy_ms is not None and scan_busy is not None:
        share = cfg.n_layers * scan_busy / busy_ms
        print(f"[mamba2-train] under the profiler: step {step_ms:.1f} ms, "
              f"device busy {busy_ms:.1f} ms, idle share "
              f"{1 - busy_ms / step_ms:.3f}; one layer's ssd_scan (two "
              f"forwards and a backward, bf16 x and B/C as the model feeds "
              f"them) busy {scan_busy:.2f} ms: {cfg.n_layers} layers "
              f"{cfg.n_layers * scan_busy:.1f} ms, share of the step's "
              f"device time {share:.3f}", flush=True)
        from torch.autograd import DeviceType
        top = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
        for e in top[:10]:
            print(f"[mamba2-train]   {e.self_device_time_total / 1e3:9.2f} "
                  f"ms/step  x{e.count:<5d} {e.key[:90]}", flush=True)
    del prof
    for p in leaves:
        p.requires_grad_(False)
    del leaves

    # step 0 through the kernels against the plain versions
    data_batch = _first_batch(torch, cfg.vocab, TRAIN_BATCH)
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    m32 = Model(small)
    p32 = m32.init(0)
    loss_k, _, g_k = loss_and_grads(m32, p32, data_batch)
    with plain_on_card():
        loss_p, _, g_p = loss_and_grads(m32, p32, data_batch)
    worst = max(check_close(f"mamba2 f32 2 layers {k}", g, gp,
                            torch.float32, 1e-4)
                for (k, g), gp in zip(zip(*flatten(g_k)), flatten(g_p)[1]))
    check_close("mamba2 f32 2 layers loss", loss_k, loss_p, torch.float32,
                1e-4)
    print(f"[mamba2-train] step 0, 2 layers f32, through the kernels "
          f"against the plain versions on the card: loss {float(loss_k):.6f}"
          f" vs {float(loss_p):.6f}; every gradient leaf within 1e-4 + "
          f"1e-4|x| (max |diff| {worst:.3e})", flush=True)
    del m32, p32, g_k, g_p
    torch.cuda.empty_cache()

    # bf16 at M2_AGREE_LAYERS of the 48 layers (cut to hold the script's
    # time): the first rows of every stacked leaf
    deep = dataclasses.replace(cfg, n_layers=M2_AGREE_LAYERS)
    model = Model(deep)
    params = dict(params, blocks=tree_map(lambda p: p[:M2_AGREE_LAYERS],
                                          params["blocks"]))
    loss_k, _, g_k = loss_and_grads(model, params, data_batch)
    g_k = dict(zip(*flatten(g_k)))
    with plain_on_card():
        loss_p, _, g_p = loss_and_grads(model, params, data_batch)
    g_p = dict(zip(*flatten(g_p)))
    rel = grad_gaps(g_k, g_p)
    del g_k
    torch.cuda.empty_cache()
    f32 = Model(dataclasses.replace(deep, dtype="float32"))
    loss_f, _, g_f = loss_and_grads(f32, params, data_batch)
    yard = grad_gaps(g_p, dict(zip(*flatten(g_f))))
    del g_f, g_p, params
    torch.cuda.empty_cache()
    gate = {k: TF_PAIR * yard[k] for k in rel}
    worst = max(rel, key=lambda k: rel[k] / max(gate[k], 1e-30))
    loss_gap, loss_yard = abs(float(loss_k - loss_p)), abs(float(loss_p
                                                                - loss_f))
    print(f"[mamba2-train] step 0, {M2_AGREE_LAYERS} layers bf16, through "
          f"the "
          f"kernels "
          f"against the plain versions on the card: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f} (f32 "
          f"{float(loss_f):.6f}; |diff| {loss_gap:.3e} against bf16's own "
          f"{loss_yard:.3e}); gradients' max |diff| relative to the leaf's "
          f"max: worst share of the gate {rel[worst] / gate[worst]:.3f} "
          f"({worst}: {rel[worst]:.3e} against bf16's own {yard[worst]:.3e}"
          f"), median gap {statistics.median(rel.values()):.3e}, median "
          f"bf16's own {statistics.median(yard.values()):.3e}", flush=True)
    fails = [f"mamba2 train step 0 gradient {k}: {rel[k]:.3e} beyond "
             f"{gate[k]:.3e}" for k in rel if not rel[k] <= gate[k]]
    if not loss_gap <= TF_PAIR * loss_yard + 1e-6:
        fails.append(f"mamba2 train step-0 loss: {loss_gap:.3e} beyond "
                     f"{TF_PAIR:g} x {loss_yard:.3e}")
    if fails:
        raise AssertionError("; ".join(fails))
    return counts


# ---------------------------------------------------------------------------
# phase 31: mamba2 over a model axis (the SSD mixer's heads split)
# ---------------------------------------------------------------------------

M2_SPLIT_LAYERS = 2             # training split x2, f32
M2_SERVE_ARGS = ["--arch", MAMBA, "--cache", "dense", "--requests", "4",
                 "--batch-slots", "4", "--prompt-len", "500", "--gen", "16",
                 "--max-len", "1024"]
#: the depth served split in bf16 (cut from 48 to hold the script's time:
#: each layer's gated norm and ``wo`` cross host memory at every step;
#: the teacher-forced runs below hold all 48)
M2_SERVE_LAYERS = 8
M2_SERVE_BF16 = M2_SERVE_ARGS + ["--overrides",
                                 f"n_layers={M2_SERVE_LAYERS}"]
#: f32 at 2 layers: the split's tokens equal the unsharded run's
M2_SERVE_F32 = M2_SERVE_ARGS + ["--overrides", "dtype=float32,n_layers=2"]
#: teacher-forced runs of mamba2: name -> (layers, activation dtype);
#: the runs of one depth share one draw of the weights
M2_TF = {"bf16": (48, "bfloat16"), "f32": (48, "float32"),
         "f32_2": (2, "float32")}
M2_DEPTHS = {48: ("bf16", "f32"), 2: ("f32_2",)}
#: each run's yardstick, from the unsharded process: bf16's own error
#: (against the same weights in f32), and at 48 layers f32's own
#: sensitivity (against the same weights each moved by one ulp); none at
#: 2 layers (1e-4 + 1e-4|x|)
M2_YARDSTICK = {"bf16": "f32", "f32": "f32_ulp"}


def _m2_model(torch, **kw):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    return Model(dataclasses.replace(get_config(MAMBA), **kw))


def _one_ulp(torch, tree: dict) -> dict:
    """``tree`` with every element moved by one ulp, up or down at random
    (a seeded draw): the smallest change of the weights there is."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _one_ulp(torch, v)
            continue
        up = torch.rand(v.shape, generator=gen, device=v.device) < 0.5
        inf = torch.full_like(v, math.inf)
        out[k] = torch.where(up, torch.nextafter(v, inf),
                             torch.nextafter(v, -inf))
    return out


def _m2_tf_all(torch, plan_of, ref_dir: str, out: dict | None) -> None:
    """The teacher-forced runs of M2_TF (one draw of the weights a depth,
    each run serving its own cast), their logits and prefill states
    written to ``ref_dir`` (``out`` None: the unsharded process, which also
    runs the 48-layer f32 weights moved by one ulp, f32's own yardstick)
    or held against those (``out``: a rank, which also runs the f32 runs
    with the planted fault: the gated norm over its own heads)."""
    from repro_torch.models import mamba2

    for layers, names in M2_DEPTHS.items():
        masters = None
        for name in names:
            dtype = M2_TF[name][1]
            model = _m2_model(torch, n_layers=layers, dtype=dtype)
            plan = plan_of(model)
            if masters is None:
                masters = (plan.init_params(0) if plan is not None
                           else model.init(0))
            runs = [(name, masters)]
            if out is None and name == "f32" and layers == 48:
                runs.append(("f32_ulp", _one_ulp(torch, masters)))
            if out is not None and dtype == "float32":
                runs.append((name + "_fault", masters))
            for tag, weights in runs:
                params = model.serving_params(weights)
                state = {}
                real = mamba2.sum_over_heads
                if tag.endswith("_fault"):
                    mamba2.sum_over_heads = lambda t, split: t
                try:
                    got = teacher_forced(torch, model, plan, params,
                                         "dense", state)
                finally:
                    mamba2.sum_over_heads = real
                del params
                if out is None:
                    torch.save((got, state),
                               os.path.join(ref_dir, f"m2_{tag}.pt"))
                    continue
                want, want_state = torch.load(os.path.join(
                    ref_dir, f"m2_{name}.pt"))
                tol = TF_TOL[dtype]
                out[f"tf/{tag}"] = tf_gap(got, want, tol)
                for k, v in state.items():      # by layer
                    out[f"state/{tag}/{k}"] = tf_gap(
                        v.flatten(1), want_state[k].flatten(1), tol)
            torch.cuda.empty_cache()
        del masters
        torch.cuda.empty_cache()


def _m2_split_rank(rank: int, store: str, out_dir: str, ref_dir: str) -> None:
    """One rank of phase 31 on ``cuda:0``, in a gloo world of two: (a)
    ``split×2`` training at M2_SPLIT_LAYERS layers in f32, batch
    TP_BATCH x TRAIN_SEQ, one step: the loss and the gathered step-0
    gradient against the unsharded process's (``ref_dir``), each leaf
    within 1e-4 + 1e-4|x|; (b) the serving driver's meshed branch
    (``--mesh 1x2``) at M2_SERVE_LAYERS layers in bf16 and 2 in f32; (c)
    the teacher-forced runs (:func:`_m2_tf_all`)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.core import sharding
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    kernels = kernel_wrappers()
    stats = {"s": 0.0, "n": 0}
    time_collectives(torch, dist, stats)
    out = {}
    try:
        strat = StrategySpec(tp=2)
        model = _m2_model(torch, n_layers=M2_SPLIT_LAYERS, dtype="float32")
        plan = compile_plan(model, mesh_for_strategy(strat), strat)
        seen = {}
        opt = adamw(lr=PP_LR)
        real = opt.apply

        def apply(grads, *a, **kw):
            seen["g"] = grads
            return real(grads, *a, **kw)

        params = plan.init_params(0)
        step = plan.train_step_fn(dataclasses.replace(opt, apply=apply))
        batch = _first_batch(torch, model.cfg.vocab, TP_BATCH)
        reset_counts(kernels)
        s0, t0 = stats["s"], time.perf_counter()
        _, _, m = step(params, plan.init_opt(opt, params), batch, 0)
        torch.cuda.synchronize()
        rec = {"seconds": time.perf_counter() - t0,
               "gloo_s": stats["s"] - s0, "loss": float(m["loss"]),
               "counts": read_counts(kernels),
               "wz": list(params["blocks"]["p0"]["ssd"]["wz"].shape)}
        want_loss, want = torch.load(os.path.join(ref_dir, "m2_train.pt"),
                                     mmap=True)
        worst = 0.0
        for (k, g), spec in zip(zip(*flatten(seen.pop("g"))),
                                flatten(plan.param_specs)[1]):
            g = sharding.gather_leaf(g, spec, plan.rules)
            worst = max(worst, check_close(f"mamba2 split x2 {k}", g,
                                           want[k].cuda(), torch.float32,
                                           1e-4))
        check_close("mamba2 split x2 loss", torch.tensor(rec["loss"]),
                    torch.tensor(want_loss), torch.float32, 1e-4)
        rec["worst_grad"] = worst
        rec["want_loss"] = want_loss
        out["train"] = rec
        del params, seen, want, plan
        torch.cuda.empty_cache()

        for tag, argv in (("bf16", M2_SERVE_BF16), ("f32", M2_SERVE_F32)):
            reset_counts(kernels)
            s0 = stats["s"]
            summary, server = serve.run(serve.parse_args(
                argv + ["--mesh", "1x2"]))
            out[f"serve/{tag}"] = {
                **{k: summary[k] for k in ("completed", "tokens", "steps",
                                           "seconds", "tokens_crc32",
                                           "out_tokens")},
                "gloo_s": stats["s"] - s0, "counts": read_counts(kernels),
                "h": list(server.state["cache"]["p0"]["h"].shape)}
            del server
            torch.cuda.empty_cache()
        _m2_tf_all(torch, lambda model: compile_plan(model, parse_mesh(
            "1x2")), ref_dir, out)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mamba2_split(torch) -> dict:
    """Phase 31: mamba2 over ``model``.  Here first, unsharded: the 2-layer
    f32 step-0 loss and gradient (a temporary file the ranks read by mmap),
    the teacher-forced logits and prefill states of M2_TF with their
    yardsticks, and the 2-layer f32 driver's tokens.  Then two ranks on
    ``cuda:0`` over gloo (:func:`_m2_split_rank`).  Held: the split step's
    loss and every gradient leaf within 1e-4 + 1e-4|x|; the served runs
    complete, their SSD launches one per layer, prefill and rank, and
    nothing else; the 2-layer f32 tokens equal the unsharded driver's;
    teacher-forced logits and prefill states at 2 layers in f32 within
    1e-4 + 1e-4|x|, at 48 layers within TF_PAIR times the yardstick of
    M2_YARDSTICK (the worst share of the limit of 0.02 or 1e-4 by which the
    unsharded run's own cast or one-ulp weights move them), and the
    planted fault outside the f32 gates.  At 48 random layers a change of
    one rounding grows by orders of magnitude (PERF.md): hence the
    yardsticks, and a 2-layer run, where none is needed.  Returns the
    launches of the split training step and of the bf16 served run,
    summed over ranks."""
    from repro_torch.core.planner import loss_and_grads
    from repro_torch.launch import serve
    from repro_torch.tree import flatten

    tmp = tempfile.mkdtemp(prefix="chip_smoke_m2_split_")
    t00 = time.perf_counter()
    try:
        model = _m2_model(torch, n_layers=M2_SPLIT_LAYERS, dtype="float32")
        loss, _, g = loss_and_grads(model, model.init(0),
                                    _first_batch(torch, model.cfg.vocab,
                                                 TP_BATCH))
        torch.save((float(loss), {k: v.cpu() for k, v in
                                  zip(*flatten(g))}),
                   os.path.join(tmp, "m2_train.pt"))
        del g, model
        torch.cuda.empty_cache()
        _m2_tf_all(torch, lambda model: None, tmp, None)
        want = serve.main(M2_SERVE_F32)
        torch.cuda.empty_cache()
        yard = {}
        for name, ref in M2_YARDSTICK.items():
            a, b = (torch.load(os.path.join(tmp, f"m2_{n}.pt"))
                    for n in (name, ref))
            tol = TF_TOL[M2_TF[name][1]]
            yard[f"tf/{name}"] = tf_gap(a[0], b[0], tol)
            for k in a[1]:
                yard[f"state/{name}/{k}"] = tf_gap(
                    a[1][k].flatten(1), b[1][k].flatten(1), tol)
            print(f"[mamba2-split] yardstick {name} (48 layers, unsharded, "
                  f"against {ref}): logits max |diff| "
                  f"{yard[f'tf/{name}']['max_abs']:.3e}, worst share of "
                  f"{tol:g} + {tol:g}|x| {yard[f'tf/{name}']['worst']:.3f}; "
                  f"by row {yard[f'tf/{name}']['rows']}", flush=True)
            del a, b
        t0 = time.perf_counter()
        ranks = spawn_ranks(_m2_split_rank, tmp, timeout=500)
        print(f"[mamba2-split] the unsharded references {t0 - t00:.1f} s; "
              f"two ranks {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fails = []
    for r, o in enumerate(ranks):
        t = o["train"]
        if t["counts"]["xent_fwd"] != 1 or t["counts"]["ssd_scan"]:
            fails.append(f"rank {r} split training: launches "
                         f"{t['counts']}")
        print(f"[mamba2-split] rank {r} split×2 training, {M2_SPLIT_LAYERS} "
              f"layers f32 (wz {t['wz']}): loss {t['loss']:.6f} vs the "
              f"unsharded {t['want_loss']:.6f}; every step-0 gradient leaf "
              f"within 1e-4 + 1e-4|x| (max |diff| {t['worst_grad']:.3e}); "
              f"step {t['seconds']:.3f} s, gloo {t['gloo_s']:.3f}; launches "
              f"{t['counts']}", flush=True)
        for tag, layers in (("bf16", M2_SERVE_LAYERS), ("f32", 2)):
            s = o[f"serve/{tag}"]
            print(f"[mamba2-split] rank {r} serve --mesh 1x2 {tag}, "
                  f"{layers} layers: {s['completed']} requests, "
                  f"{s['tokens']} tokens, {s['steps']} steps in "
                  f"{s['seconds']:.3f} s (gloo {s['gloo_s']:.3f}; ranks "
                  f"time-slice one card), state h {s['h']} a rank; launches "
                  f"{s['counts']}", flush=True)
            wantc = dict.fromkeys(s["counts"], 0)
            wantc["ssd_scan"] = layers * s["completed"]
            if s["completed"] != 4 or s["counts"] != wantc:
                fails.append(f"rank {r} serve {tag}: {s['completed']} "
                             f"requests, launches {s['counts']}")
        same, total = _same_tokens(o["serve/f32"]["out_tokens"],
                                   want["out_tokens"])
        print(f"[mamba2-split] rank {r} f32 tokens at 2 layers against the "
              f"unsharded driver: {same} of {total} equal", flush=True)
        if same != total:
            fails.append(f"rank {r}: f32 tokens differ")
        for key, gap in sorted(o.items()):
            if not key.startswith(("tf/", "state/")):
                continue
            what, tag = key.split("/")[:2]
            name = tag.removesuffix("_fault")
            dtype = M2_TF[name][1]
            ystick = yard.get(key.replace(tag, name, 1))
            if ystick is None:
                gate, line = 1.0, "the gate 1"
            else:
                gate = TF_PAIR * ystick["worst"]
                line = (f"the yardstick {ystick['worst']:.3f}, the gate "
                        f"{gate:.3f}")
            beyond = gap["worst"] > gate
            print(f"[mamba2-split] rank {r} {key} ({M2_TF[name][0]} "
                  f"layers): max |diff| {gap['max_abs']:.3e}, worst share "
                  f"of {TF_TOL[dtype]:g} + {TF_TOL[dtype]:g}|x| "
                  f"{gap['worst']:.3f} ({line}): "
                  f"{'beyond' if beyond else 'within'}", flush=True)
            if tag.endswith("_fault"):
                if what == "tf" and not beyond:
                    fails.append(f"rank {r} {key}: the planted fault within "
                                 f"{gate:.3f}")
            elif beyond:
                fails.append(f"rank {r} {key}: {gap['worst']:.3f} beyond "
                             f"{gate:.3f}")
    if fails:
        raise AssertionError("; ".join(fails))

    def total(get):
        return {k: sum(get(o)[k] for o in ranks)
                for k in ranks[0]["train"]["counts"]}

    return {"train_mamba2_split": total(lambda o: o["train"]["counts"]),
            "serve_mamba2_split": total(lambda o: o["serve/bf16"]["counts"])}


# ---------------------------------------------------------------------------
# phase 32: the MoE family across the engine
# ---------------------------------------------------------------------------

#: (a, b): deepseek at full width and 2 layers, one a stage (AdamW's state
#: at 28 layers, ~270 GB, fits no card), on launch.train's stream of
#: TRAIN_BATCH x TRAIN_SEQ batches in PP_MICRO micro-batches of a row,
#: 1f1b, AdamW at a constant PP_LR (bf16 at 2 steps in (a), 1 in (b))
MOE_PP_LAYERS, MOE_PP_STEPS = 2, 2
#: the runs of (a) and (b): name -> (activation dtype, steps); bf16 is the
#: path, f32 holds its step 0 to f32's limits
MOE_PP_RUNS = {"bf16": ("bfloat16", MOE_PP_STEPS), "f32": ("float32", 1)}
MOE_PP_TP_RUNS = dict(MOE_PP_RUNS, bf16=("bfloat16", 1))
#: (a) and (b): world -> the model axis beside pipeline×2 (data 1)
MOE_PP_MODEL = {2: 1, 4: 2}
#: (c): data 2 in f32 at 2 layers, a row of TRAIN_SEQ a replica
MOE_DP_BATCH = 2
#: (d): the depth served at split×2 and data 2 x model 2.  Each rank of
#: a meshed plan draws the whole model and rank 0's draw is broadcast
#: through host memory over gloo (31.4 GB at 28 layers in bf16, twice
#: over, and an f32 yardstick of 62.9 GB beside it), so the meshed runs
#: serve 2 layers (split×2 cut from 4 to hold the script's time); phase
#: 28 serves all 28 on one card
MOE_TP_LAYERS, MOE_DPTP_LAYERS = 2, 2
MOE_TP_SERVE = ["--arch", MOE, "--cache", "paged", "--page-size", "64",
                "--requests", "8", "--batch-slots", "8", "--prompt-len",
                "256", "--gen", "32", "--max-len", "512"]
MOE_TP_ARGS = MOE_TP_SERVE + ["--overrides", "param_dtype=bfloat16,"
                              f"n_layers={MOE_TP_LAYERS}"]
MOE_DPTP_ARGS = MOE_TP_SERVE + ["--overrides", "param_dtype=bfloat16,"
                                f"n_layers={MOE_DPTP_LAYERS}"]
MOE_F32_ARGS = MOE_TP_SERVE[:6] + [
    "--requests", "4", "--batch-slots", "4", "--prompt-len", "256", "--gen",
    "16", "--max-len", "512", "--overrides",
    f"param_dtype=bfloat16,n_layers={MOE_DPTP_LAYERS},dtype=float32"]
#: (d)'s teacher-forced runs: name -> (layers, activation dtype); the
#: weights of a depth are one bf16 draw, cast for the f32 runs
MOE_TF = {"bf16": (MOE_TP_LAYERS, "bfloat16"),
          "f32_yard": (MOE_TP_LAYERS, "float32"),
          "f32": (MOE_DPTP_LAYERS, "float32")}


def _moe_steps_log(rec: dict) -> str:
    return (f"losses {[round(x, 6) for x in rec['losses']]}, moe_lb "
            f"{[round(x, 6) for x in rec['moe_lb']]}, moe_z "
            f"{[round(x, 6) for x in rec['moe_z']]}")


def _leaf_file(d: str, path: str) -> str:
    return os.path.join(d, path.replace("/", "~") + ".bin")


#: bytes of a leaf that cross to its file at a time, through one pinned
#: host buffer (:func:`_write_leaf`)
STAGE_BYTES = 1 << 28
_STAGE = []


def _write_leaf(torch, name: str, x) -> None:
    """``x``'s elements to the file ``name``, raw, in C order; a tensor on
    the card crosses through one pinned host buffer, STAGE_BYTES at a
    time (a pageable copy of a whole leaf faults in fresh host pages as
    it goes, gigabytes of them for an expert leaf)."""
    flat = x.detach().contiguous().reshape(-1).view(torch.uint8)
    with open(name, "wb") as f:
        if flat.device.type != "cuda":
            f.write(flat.numpy().data)
            return
        if not _STAGE:
            _STAGE.append(torch.empty(STAGE_BYTES, dtype=torch.uint8,
                                      pin_memory=True))
        buf = _STAGE[0]
        for i in range(0, flat.numel(), STAGE_BYTES):
            part = flat[i:i + STAGE_BYTES]
            buf[:part.numel()].copy_(part)
            f.write(buf[:part.numel()].numpy().data)


def _read_leaf(torch, d: str, path: str):
    """The leaf :func:`_save_leaves` wrote for ``path`` in ``d``, mapped
    from its file (its pages read as they are touched)."""
    with open(os.path.join(d, "meta.json")) as f:
        dtype, shape = json.load(f)[path]
    return torch.from_file(_leaf_file(d, path), size=math.prod(shape),
                           dtype=getattr(torch, dtype)).view(shape)


def _save_leaves(torch, d: str, leaves) -> None:
    """Each ``(path, tensor)`` or ``(path, tensor, max |x|)`` of
    ``leaves`` to a file of its own in ``d`` (:func:`_write_leaf`; a rank
    maps only the rows it needs, :func:`_read_leaf`), its dtype and shape
    added to ``d/meta.json`` and its max |x| (the tensor's where none is
    given) to ``d/tops.json``."""
    os.makedirs(d, exist_ok=True)
    records = {}
    for what in ("tops", "meta"):
        name = os.path.join(d, f"{what}.json")
        records[what] = {}
        if os.path.exists(name):
            with open(name) as f:
                records[what] = json.load(f)
    for path, g, *top in leaves:
        _write_leaf(torch, _leaf_file(d, path), g)
        records["meta"][path] = [str(g.dtype).removeprefix("torch."),
                                 list(g.shape)]
        records["tops"][path] = (top[0] if top else float(
            torch.linalg.vector_norm(g.detach(), float("inf"))))
    for what, rec in records.items():
        with open(os.path.join(d, f"{what}.json"), "w") as f:
            json.dump(rec, f)


def _leaf_gaps(torch, grads: dict, d: str, cut=None,
               chunk: int = 1 << 26) -> dict:
    """Per leaf of this rank's gradient ``grads`` ({path: tensor} on the
    card): [max |diff| against the reference's leaf in ``d``, cut on the
    host to this rank's block by ``cut(path, leaf)`` (whole without),
    max |x| of the whole reference leaf], a leaf at a time and ``chunk``
    elements at a time on the card (ranks that share it beside their
    weights and gradients leave no room for a whole expert leaf); a NaN
    is an infinite gap."""
    with open(os.path.join(d, "tops.json")) as f:
        tops = json.load(f)
    out = {}
    for path, g in grads.items():
        w = _read_leaf(torch, d, path)
        if cut is not None:
            w = cut(path, w)
        w, gf = w.reshape(-1), g.detach().reshape(-1)
        if w.numel() != gf.numel():
            raise AssertionError(f"{path}: {w.numel()} reference elements "
                                 f"for a block of {gf.numel()}")
        worst = torch.zeros((), device=g.device)
        for i in range(0, gf.numel(), chunk):
            part = w[i:i + chunk].to(g.device).float()
            part.sub_(gf[i:i + chunk].float())
            worst = torch.maximum(worst, torch.linalg.vector_norm(
                part, float("inf")).nan_to_num(nan=math.inf))
            del part
        out[path] = [float(worst), tops[path]]
    return out


def _record_opt(torch, apply):
    """An optimizer with no state that calls ``apply(grads)`` and leaves
    the parameters as they are: a step's gradient, read and let go."""
    from repro_torch.optim.optimizer import Optimizer

    def step(grads, state, params, i, **kw):
        apply(grads)
        return params, state

    return Optimizer(init=lambda params: {}, apply=step, name="record")


def _unpiped(torch, model, steps: int, d: str) -> dict:
    """The unpipelined, unsharded step of ``model`` from seed 0: ``steps``
    AdamW steps (at PP_LR) of ``train_step_fn(micro_batches=PP_MICRO)``
    on launch.train's stream of TRAIN_BATCH x TRAIN_SEQ; losses,
    ``moe_lb``, ``moe_z``, step seconds and the peak; the step-0 gradient
    to ``d``, a file a leaf (:func:`_save_leaves`)."""
    import dataclasses

    import numpy as np

    from repro_torch.core.planner import compile_plan
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten

    params = model.init(0)
    opt = adamw(lr=PP_LR)
    state = opt.init(params)
    saved = []
    real_apply = opt.apply

    def apply(grads, *args, **kw):
        if not saved:
            _save_leaves(torch, d, zip(*flatten(grads)))
            saved.append(True)
        return real_apply(grads, *args, **kw)

    step_fn = compile_plan(model, None).train_step_fn(
        dataclasses.replace(opt, apply=apply), micro_batches=PP_MICRO)
    data = TokenPipeline(DataCfg(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                 vocab=model.cfg.vocab, seed=0),
                         host_id=0, n_hosts=1)
    rec = {"losses": [], "moe_lb": [], "moe_z": [], "seconds": []}
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        batch = {"tokens": torch.as_tensor(
            np.asarray(data.next_batch()["tokens"])).cuda()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch, i)
        torch.cuda.synchronize()
        rec["seconds"].append(time.perf_counter() - t0)
        for k in ("loss", "moe_lb", "moe_z"):
            rec["losses" if k == "loss" else k].append(float(m[k]))
    rec["peak"] = torch.cuda.max_memory_allocated()
    del params, state
    return rec


def _pp_references(torch, model_of, runs: dict, d: str,
                   steps: int | None = None) -> dict:
    """The unpipelined, unsharded steps of a pipelined part (phase 32 (a,
    b), phase 35 (a)): for each of ``runs`` (name -> (activation dtype,
    steps)) :func:`_unpiped` of ``model_of(dtype)`` (``steps`` steps
    each, or the run's own), its step-0 gradient to ``d/<name>``; and
    bf16's own error, the gap between the bf16 and f32 runs: the largest
    over the steps of the loss's and the aux's (``own_loss``), and each
    step-0 gradient leaf's max |diff| relative to the f32 leaf's max
    (``own``)."""
    refs = {"pp": {n: _unpiped(torch, model_of(dt), steps or k,
                               os.path.join(d, n))
                   for n, (dt, k) in runs.items()}}
    torch.cuda.empty_cache()
    with open(os.path.join(d, "f32", "tops.json")) as f:
        tops = json.load(f)
    refs["own"] = {p: max_err(*(
        _read_leaf(torch, os.path.join(d, n), p).cuda()
        for n in ("bf16", "f32"))) / max(top, 1e-30)
        for p, top in tops.items()}
    refs["own_loss"] = {k: max(abs(a - b) for a, b in zip(
        refs["pp"]["bf16"][k], refs["pp"]["f32"][k]))
        for k in ("losses", "moe_lb", "moe_z")}
    torch.cuda.empty_cache()
    return refs


def _pp_part(torch, model_of, strat, runs: dict, ref_dir: str, kernels,
             stats: dict, whole: dict | None = None) -> dict:
    """A rank of a pipelined part (phase 32 (a, b), phase 35 (a)): this
    stage's rows of the whole model (``whole``, or a draw of it here), cut
    within the stage as ``init_pipeline_params`` cuts them, then for each
    of ``runs`` (name -> (activation dtype, steps)) ``model_of(dtype)``'s
    steps under ``strat`` (1f1b) through ``pipeline_train_step_fn``,
    AdamW at PP_LR on launch.train's stream of TRAIN_BATCH x TRAIN_SEQ:
    losses, ``moe_lb``, ``moe_z``, step and gloo seconds, peaks beside the
    state held, launches, and the step-0 gradient blocks against the
    unpipelined ones in ``ref_dir/<name>`` (:func:`_pp_references`)."""
    import dataclasses

    import numpy as np

    from repro_torch.core import sharding
    from repro_torch.core.pipeline import _rows, stage_state
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.data.pipeline import DataCfg, TokenPipeline
    from repro_torch.optim.optimizer import adamw
    from repro_torch.tree import flatten, tree_map

    mesh = mesh_for_strategy(strat)
    stage = mesh.get_local_rank("stage")
    out = {"stage": stage, "model": mesh.get_local_rank("model")}
    init = None
    for name, (dtype, steps) in runs.items():
        plan = compile_plan(model_of(dtype), mesh, strat)
        sl = plan.stage_layers()
        specs = sharding.within_stage(plan.param_specs)
        if init is None:            # f32 masters: one draw serves every run
            init = plan.shard(stage_state(
                whole if whole is not None else plan.model.init(0), stage,
                sl), specs)
        params = tree_map(torch.clone, init)
        opt = adamw(lr=PP_LR)
        state = opt.init(params)
        held = 4 * (2 * sum(p.numel() for p in flatten(params)[1])
                    + sum(p.numel() for p in flatten(state)[1]))
        flat = dict(zip(*flatten(specs)))
        gaps = {}

        def cut(path, w, sl=sl, flat=flat, rules=plan.rules):
            if path.startswith("blocks/"):
                w = _rows(w, stage, sl)
            return sharding.shard_leaf(w, flat[path], rules)

        def apply(grads, *args, real_apply=opt.apply, gaps=gaps, cut=cut,
                  ref=os.path.join(ref_dir, name), **kw):
            if not gaps:
                gaps.update(_leaf_gaps(torch, dict(zip(*flatten(grads))),
                                       ref, cut))
            return real_apply(grads, *args, **kw)

        step_fn = plan.pipeline_train_step_fn(
            dataclasses.replace(opt, apply=apply))
        data = TokenPipeline(DataCfg(
            global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            vocab=plan.model.cfg.vocab, seed=0), host_id=0, n_hosts=1)
        torch.cuda.synchronize()
        reset_counts(kernels)
        rec = {"losses": [], "moe_lb": [], "moe_z": [], "seconds": [],
               "gloo_s": [], "peaks": []}
        for i in range(steps):
            toks = plan.batch_slice({"tokens": torch.as_tensor(
                np.asarray(data.next_batch()["tokens"]))})["tokens"].cuda()
            torch.cuda.reset_peak_memory_stats()
            s0 = stats["s"]
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, toks, i)
            torch.cuda.synchronize()
            rec["seconds"].append(time.perf_counter() - t0)
            rec["gloo_s"].append(stats["s"] - s0)
            rec["peaks"].append(torch.cuda.max_memory_allocated())
            for k in ("loss", "moe_lb", "moe_z"):
                rec["losses" if k == "loss" else k].append(float(m[k]))
        moe = [b["moe"] for b in params["blocks"].values() if "moe" in b]
        rec.update(counts=read_counts(kernels), held=held, grads=gaps,
                   stage_layers=list(sl),
                   experts=int(moe[0]["w_in"].shape[1]) if moe else 0,
                   vp=int(params["head"]["w"].shape[1] if "head" in params
                          else params["embed"]["table"].shape[0]))
        out[name] = rec
        del params, state, step_fn, plan
        torch.cuda.empty_cache()
    del init
    torch.cuda.empty_cache()
    return out


def _pp_report(torch, prefix: str, what: str, outs: list, refs: dict,
               runs: dict, attn: int, fails: list) -> dict:
    """Print a pipelined part's ranks (``outs``, :func:`_pp_part`'s
    records) beside the unpipelined steps (``refs``,
    :func:`_pp_references`) and hold them: bf16's losses, ``moe_lb`` and
    ``moe_z`` (every step) and each step-0 gradient leaf within TF_PAIR
    times bf16's own error; f32 within 1e-4 + 1e-4|x| (values) and 2e-4
    of each leaf's max (gradients); the ranks' losses equal; each rank's
    launches those of its stage (``attn`` attention layers a stage, the
    loss head on the last).  Returns the bf16 run's launches summed over
    the ranks."""
    own, own_loss = refs["own"], refs["own_loss"]
    for name, (_, steps) in runs.items():
        want = refs["pp"][name]
        for o in outs:
            r = o[name]
            print(f"{prefix} {what} {name}, stage {o['stage']} model "
                  f"{o['model']} (layers {r['stage_layers']}, "
                  f"{r['experts']} experts a layer, {r['vp']} vocab "
                  f"columns): {_moe_steps_log(r)}; step seconds "
                  f"{[round(x, 3) for x in r['seconds']]}, gloo "
                  f"{[round(x, 3) for x in r['gloo_s']]} (ranks time-slice "
                  f"one card); peak {max(r['peaks']) / 2**30:.2f} GiB "
                  f"beside {r['held'] / 2**30:.2f} GiB of parameters, "
                  f"gradients and moments held; launches {r['counts']}",
                  flush=True)
            if r["losses"] != outs[0][name]["losses"]:
                fails.append(f"{what} {name}: the ranks report different "
                             f"losses")
            exp = pipeline_expected(attn, steps, r["vp"],
                                    head=o["stage"] == 1)
            if r["counts"] != exp:
                fails.append(f"{what} {name} stage {o['stage']}: launches "
                             f"{r['counts']}, want {exp}")
        got = outs[0][name]
        diffs = {k: [abs(a - b) for a, b in zip(got[k], want[k])]
                 for k in ("losses", "moe_lb", "moe_z")}
        print(f"{prefix} {what} {name} against the unpipelined step: "
              f"|diff| losses {diffs['losses']}, moe_lb {diffs['moe_lb']}, "
              f"moe_z {diffs['moe_z']}", flush=True)
        rs = [o[name] for o in outs]
        if name == "bf16":
            for k, ds in diffs.items():
                gate = TF_PAIR * own_loss[k]
                fails += [f"{what} bf16 step-{i} {k} |diff| {d:.3e} beyond "
                          f"{gate:.3e}" for i, d in enumerate(ds)
                          if d > gate]
            fails += _moe_grad_lines(f"{what} bf16", rs,
                                     lambda p: TF_PAIR * own[p], prefix)
        else:
            for k, ds in diffs.items():
                fails += [f"{what} f32 step-{i} {k} |diff| {d:.3e}"
                          for i, (d, x) in enumerate(zip(ds, want[k]))
                          if d > TP_F32_LIMIT + TP_F32_LIMIT * abs(x)]
            fails += _moe_grad_lines(f"{what} f32", rs,
                                     lambda p: GRAD_TOL[str(torch.float32)],
                                     prefix)
    return {k: sum(o["bf16"]["counts"][k] for o in outs)
            for k in outs[0]["bf16"]["counts"]}


def _pp_refs_lines(prefix: str, layers: int, refs: dict) -> None:
    """Print the unpipelined steps of :func:`_pp_references` at ``layers``
    layers and bf16's own error."""
    for n, r in refs["pp"].items():
        print(f"{prefix} unpipelined {n}, {layers} layers, {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} in {PP_MICRO} micro-batches: "
              f"{_moe_steps_log(r)}; step seconds "
              f"{[round(x, 3) for x in r['seconds']]}; peak "
              f"{r['peak'] / 2**30:.2f} GiB", flush=True)
    own, own_loss = refs["own"], refs["own_loss"]
    ow = max(own, key=own.get)
    print(f"{prefix} bf16's own error (unpipelined bf16 against f32, same "
          f"weights and batches): loss {own_loss['losses']:.3e}, moe_lb "
          f"{own_loss['moe_lb']:.3e}, moe_z {own_loss['moe_z']:.3e} "
          f"(largest over the steps); step-0 gradients relative to the "
          f"leaf's max: median {statistics.median(own.values()):.3e}, "
          f"largest {own[ow]:.3e} ({ow})", flush=True)


def _moe_pp_model(dtype: str):
    """Phase 32 (a, b)'s model: deepseek at MOE_PP_LAYERS layers."""
    from repro_torch.models.lm import Model
    return Model(_moe_cfg(n_layers=MOE_PP_LAYERS, dtype=dtype))


def _moe_draw(model) -> dict:
    """``model``'s parameters from seed 0, drawn by this rank.  The ranks
    of phase 32 share one card, so every rank's draw is the same and none
    is broadcast (the plan's ``init_params`` broadcasts rank 0's, for
    ranks on several cards: gigabytes through host memory over gloo)."""
    return model.init(0)


def _moe_dp_plan(torch):
    """Phase 32 (c)'s plan, ``StrategySpec(dp=2)`` over deepseek at full
    width and 2 layers in f32 (a world of two)."""
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.models.lm import Model

    strat = StrategySpec(dp=2)
    return compile_plan(Model(_moe_cfg(n_layers=MOE_PP_LAYERS,
                                       dtype="float32")),
                        mesh_for_strategy(strat), strat)


def _moe_dp_part(torch, ref_dir: str, kernels, stats: dict, plan,
                 params: dict) -> dict:
    """Phase 32 (c) in a rank of a world of two: :func:`_moe_dp_plan` from
    ``params`` (its ``init_params``), one step on this rank's row of the
    global batch (a recording optimizer: no state), with the experts'
    balance over the global batch and then with the old per-replica
    balance planted (no mean over data); each step's loss, ``moe_lb``,
    ``moe_z``, launches, seconds, and its gradient against one process's
    on both rows in ``ref_dir/dp``."""
    from repro_torch.core import sharding
    from repro_torch.tree import flatten

    seen = {}
    step_fn = plan.train_step_fn(_record_opt(torch, lambda g: seen.update(
        _leaf_gaps(torch, dict(zip(*flatten(g))),
                   os.path.join(ref_dir, "dp")))))
    batch = plan.batch_slice(_first_batch(torch, plan.model.cfg.vocab,
                                          MOE_DP_BATCH))
    out = {}
    real = sharding.batch_splits
    for tag, balance in (("global", True), ("per_replica", False)):
        if not balance:
            sharding.batch_splits = lambda: ()
        reset_counts(kernels)
        s0 = stats["s"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            _, _, m = step_fn(params, {}, batch, 0)
            torch.cuda.synchronize()
        finally:
            sharding.batch_splits = real
        out[tag] = {"loss": float(m["loss"]), "moe_lb": float(m["moe_lb"]),
                    "moe_z": float(m["moe_z"]),
                    "seconds": time.perf_counter() - t0,
                    "gloo_s": stats["s"] - s0,
                    "counts": read_counts(kernels), "grads": dict(seen)}
        seen.clear()
    torch.cuda.empty_cache()
    return out


def _moe_tf_masters(torch, layers: int, plan_mesh):
    """Phase 32 (d)'s weights at ``layers``: one bf16 draw from seed 0
    (:func:`_moe_draw`), this rank's blocks of it under ``plan_mesh``
    (whole without)."""
    from repro_torch.core.planner import compile_plan
    from repro_torch.models.lm import Model

    model = Model(_moe_cfg(n_layers=layers, param_dtype="bfloat16"))
    if plan_mesh is None:
        return model.init(0)
    plan = compile_plan(model, plan_mesh)
    return plan.shard(_moe_draw(model), plan.param_specs)


def _moe_tf(torch, name: str, plan_mesh, masters, fault: bool = False):
    """Teacher-forced logits of MOE_TF[name] (paged) from ``masters``,
    under ``plan_mesh`` or unsharded; ``fault``: the moe combine's
    all-reduce over ``model`` left out (each rank's partial sum)."""
    import types

    from repro_torch.core import sharding
    from repro_torch.core.planner import compile_plan
    from repro_torch.models import moe
    from repro_torch.models.lm import Model

    layers, dtype = MOE_TF[name]
    model = Model(_moe_cfg(n_layers=layers, dtype=dtype,
                           param_dtype="bfloat16"))
    plan = compile_plan(model, plan_mesh)
    params = model.serving_params(masters)
    if fault:
        moe.sharding = types.SimpleNamespace(
            **dict(vars(sharding), reduce_from=lambda x, split: x))
    try:
        return teacher_forced(torch, model, plan, params, "paged")
    finally:
        moe.sharding = sharding


def _moe_serve_part(torch, world: int, ref_dir: str, kernels,
                    rec: dict) -> dict:
    """Phase 32 (d) in a rank: with ``world`` 2 at split×2 (``--mesh
    1x2``: 32 experts, 8 q over 8 kv heads, 51200 vocab columns a rank)
    ``serve.run``'s meshed branch at MOE_TP_LAYERS layers in bf16 (8 slots,
    paged) and at MOE_DPTP_LAYERS in f32, then the teacher-forced runs
    (bf16 at MOE_TP_LAYERS, f32 at MOE_DPTP_LAYERS also with the planted
    fault); with ``world`` 4 at data 2 x model 2 ``serve.run`` at
    MOE_DPTP_LAYERS in bf16 and the f32 teacher-forced run.  Each
    gap against the unsharded process's logits in ``ref_dir``."""
    from repro_torch.launch.mesh import parse_mesh

    spec = "1x2" if world == 2 else "2x2"
    out = {}
    mesh = ["--mesh", spec]
    out["paged"] = _serve_run(torch, kernels, (
        MOE_TP_ARGS if world == 2 else MOE_DPTP_ARGS) + mesh, rec)
    torch.cuda.empty_cache()
    if world == 2:
        out["paged_f32"] = _serve_run(torch, kernels, MOE_F32_ARGS + mesh,
                                      rec)
        torch.cuda.empty_cache()
    depths = sorted({MOE_TP_LAYERS, MOE_DPTP_LAYERS}) if world == 2 \
        else (MOE_DPTP_LAYERS,)
    for layers in depths:
        masters = _moe_tf_masters(torch, layers, parse_mesh(spec))
        for name in (n for n, (ly, _) in MOE_TF.items()
                     if ly == layers and n != "f32_yard"):
            tol = TF_TOL[MOE_TF[name][1]]
            want = torch.load(os.path.join(ref_dir, f"tf_{name}.pt"))
            faults = (False, True) if world == 2 and name == "f32" \
                else (False,)
            for fault in faults:
                got = _moe_tf(torch, name, parse_mesh(spec), masters, fault)
                out[f"tf/{name}" + ("_fault" if fault else "")] = \
                    tf_gap(got, want, tol)
        del masters
        torch.cuda.empty_cache()
    return out


def _moe_engine_rank(rank: int, store: str, out_dir: str, ref_dir: str,
                     world: int) -> None:
    """One rank of phase 32 on ``cuda:0`` over gloo: with ``world`` 2 (a)
    pipeline×2, (c) the balance at data 2 and (d) serving at split×2;
    with 4 (b) pipeline×2 over model 2 and (d) serving at data 2 x model
    2; each part's record and seconds."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.cost_model import StrategySpec

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    kernels = kernel_wrappers()
    stats, rec = {"s": 0.0, "n": 0}, {"admit": [], "step": []}
    out = {"seconds": {}}
    try:
        time_collectives(torch, dist, stats)
        instrument_servers(torch, stats, rec)
        t0 = time.perf_counter()
        dp = whole = None
        if world == 2:
            # one draw of the whole f32 model serves (a) and (c)
            dp = _moe_dp_plan(torch)
            whole = _moe_draw(dp.model)
        out["seconds"]["draw"] = time.perf_counter() - t0
        mp = MOE_PP_MODEL[world]
        parts = [("pp", lambda: _pp_part(
            torch, _moe_pp_model, StrategySpec(
                pp=2, tp=mp, ep=mp, micro_batches=PP_MICRO,
                schedule="1f1b"),
            MOE_PP_RUNS if world == 2 else MOE_PP_TP_RUNS,
            os.path.join(ref_dir, "pp"), kernels, stats, whole))]
        if world == 2:
            parts.append(("dp", lambda: _moe_dp_part(torch, ref_dir,
                                                     kernels, stats, dp,
                                                     whole)))
        parts.append(("serve", lambda: _moe_serve_part(
            torch, world, ref_dir, kernels, rec)))
        for name, fn in parts:
            t0 = time.perf_counter()
            out[name] = fn()
            if name == "dp":
                dp = whole = None
            torch.cuda.empty_cache()
            # the ranks share the card: none starts a part while another
            # still holds the last one's memory
            dist.barrier()
            out["seconds"][name] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _moe_grad_lines(tag: str, outs: list, gate_of,
                    prefix: str = "[moe-engine]") -> list:
    """Combine the ranks' per-leaf [max |diff|, max |ref|] records
    ``outs`` (the max over ranks), print the worst leaf, and hold each
    leaf's max |diff| / max |ref| within ``gate_of(path)``; returns the
    failures."""
    paths = {}
    for o in outs:
        for path, (d, top) in o["grads"].items():
            d0, _ = paths.get(path, (0.0, top))
            paths[path] = (max(d0, d), top)
    rel = {p: d / max(top, 1e-30) for p, (d, top) in paths.items()}
    share = {p: r / gate_of(p) for p, r in rel.items()}
    worst = max(share, key=share.get)
    print(f"{prefix} {tag}: step-0 gradients, max |diff| relative to the "
          f"leaf's max: worst share of its gate {share[worst]:.3f} ({worst}: "
          f"{rel[worst]:.3e} against {gate_of(worst):.3e}); median relative "
          f"gap {statistics.median(rel.values()):.3e} over {len(rel)} leaves",
          flush=True)
    return [f"{tag} gradient {p}: {rel[p]:.3e} beyond {gate_of(p):.3e}"
            for p in rel if rel[p] > gate_of(p)]


def _moe_references(torch, ref_dir: str) -> dict:
    """Phase 32's unsharded references, here before the ranks: (a, b) the
    unpipelined steps in bf16 and f32 and bf16's own error
    (:func:`_pp_references`); (c) one process's step on both rows of the
    global batch (f32, its loss and aux, its gradient to ``ref_dir/dp``);
    (d) the teacher-forced logits of
    MOE_TF, bf16's own error at MOE_TP_LAYERS, and ``serve.main``'s tokens of
    the ranks' f32 workload."""
    from repro_torch.core.planner import loss_and_grads
    from repro_torch.launch import serve
    from repro_torch.models.lm import Model
    from repro_torch.tree import flatten

    refs = _pp_references(torch, _moe_pp_model, MOE_PP_RUNS,
                          os.path.join(ref_dir, "pp"), MOE_PP_STEPS)
    model = _moe_pp_model("float32")
    loss, m, g = loss_and_grads(model, model.init(0), _first_batch(
        torch, model.cfg.vocab, MOE_DP_BATCH))
    refs["dp"] = {"loss": float(loss), "moe_lb": float(m["moe_lb"]),
                  "moe_z": float(m["moe_z"])}
    _save_leaves(torch, os.path.join(ref_dir, "dp"), zip(*flatten(g)))
    del g, model
    torch.cuda.empty_cache()
    for layers in sorted({MOE_TP_LAYERS, MOE_DPTP_LAYERS}):
        masters = _moe_tf_masters(torch, layers, None)
        for name in (n for n, (ly, _) in MOE_TF.items() if ly == layers):
            torch.save(_moe_tf(torch, name, None, masters),
                       os.path.join(ref_dir, f"tf_{name}.pt"))
        del masters
        torch.cuda.empty_cache()
    refs["yard"] = tf_gap(*(torch.load(os.path.join(ref_dir, f"tf_{n}.pt"))
                            for n in ("bf16", "f32_yard")),
                          TF_TOL["bfloat16"])
    refs["tokens"] = serve.main(MOE_F32_ARGS)
    torch.cuda.empty_cache()
    return refs


def _moe_report_pp(torch, ranks: dict, refs: dict, fails: list) -> dict:
    """Phase 32 (a, b): print each rank's runs beside the unpipelined
    step's and hold them (:func:`_pp_report`); the bf16 runs' launches
    summed over the ranks, by path."""
    _pp_refs_lines("[moe-engine]", MOE_PP_LAYERS, refs)
    return {"train_moe_pipeline" if world == 2 else "train_moe_pipeline_tp":
            _pp_report(torch, "[moe-engine]", "(a) pipeline×2" if world == 2
                       else "(b) pipeline×2 over model 2",
                       [o["pp"] for o in rs], refs,
                       MOE_PP_RUNS if world == 2 else MOE_PP_TP_RUNS, 1,
                       fails)
            for world, rs in ranks.items()}


def _moe_report_dp(torch, ranks: list, refs: dict, fails: list) -> dict:
    """Phase 32 (c): print both balances' readings and hold them
    (:func:`moe_engine`); the global balance's launches summed over the
    ranks."""
    limit = GRAD_TOL[str(torch.float32)]
    want = refs["dp"]
    outs = [o["dp"] for o in ranks]
    for tag in ("global", "per_replica"):
        beyond = []
        for r, o in enumerate(outs):
            s = o[tag]
            print(f"[moe-engine] (c) data 2, {tag} balance, rank {r}: loss "
                  f"{s['loss']:.7f} vs one process on both rows "
                  f"{want['loss']:.7f} (|diff| "
                  f"{abs(s['loss'] - want['loss']):.3e}); moe_lb "
                  f"{s['moe_lb']:.7f} vs {want['moe_lb']:.7f}, moe_z "
                  f"{s['moe_z']:.7f} vs {want['moe_z']:.7f}; step "
                  f"{s['seconds']:.3f} s, gloo {s['gloo_s']:.3f}; launches "
                  f"{s['counts']}", flush=True)
            for k, x, w in (("loss", s["loss"], want["loss"]),
                            ("moe_lb", s["moe_lb"], want["moe_lb"]),
                            ("moe_z", s["moe_z"], want["moe_z"])):
                if abs(x - w) > TP_F32_LIMIT + TP_F32_LIMIT * abs(w):
                    beyond.append(f"rank {r} {k} |diff| {abs(x - w):.3e}")
        beyond += _moe_grad_lines(f"(c) data 2, {tag} balance",
                                  [o[tag] for o in outs], lambda p: limit)
        if tag == "global":
            fails += beyond
        elif not beyond:
            fails.append("(c) the planted per-replica balance within the "
                         "gate")
        else:
            print(f"[moe-engine] (c) the planted per-replica balance misses "
                  f"the gate: {'; '.join(beyond[:4])}", flush=True)
    return {"train_moe_dp": {k: sum(o["global"]["counts"][k] for o in outs)
                             for k in outs[0]["global"]["counts"]}}


def _moe_report_serve(ranks: dict, refs: dict, fails: list) -> dict:
    """Phase 32 (d): print each rank's served runs and teacher-forced gaps
    and hold them (:func:`moe_engine`); the bf16 ``serve.run`` launches
    summed over the ranks."""
    rs2 = sorted((o["serve"] for o in ranks[2]),
                 key=lambda r: r["paged"]["model_rank"])
    rs4 = sorted((o["serve"] for o in ranks[4]),
                 key=lambda r: (r["paged"]["data_rank"],
                                r["paged"]["model_rank"]))
    _report_run(f"(d) split×2 paged bf16, {MOE_TP_LAYERS} layers", rs2,
                "paged", MOE_TP_LAYERS, fails)
    _report_run(f"(d) split×2 paged f32, {MOE_DPTP_LAYERS} layers", rs2,
                "paged_f32", MOE_DPTP_LAYERS, fails)
    _report_run(f"(d) data 2 x model 2 paged bf16, {MOE_DPTP_LAYERS} layers",
                rs4, "paged", MOE_DPTP_LAYERS, fails)
    same, total = _same_tokens(rs2[0]["paged_f32"]["out_tokens"],
                               refs["tokens"]["out_tokens"])
    print(f"[moe-engine] (d) split×2 f32 against one unsharded process: "
          f"{same} of {total} tokens equal position by position", flush=True)
    if same != total:
        fails.append("(d) split×2 f32: tokens differ")
    yard = refs["yard"]
    print(f"[moe-engine] (d) yardstick: bf16's own error, one unsharded "
          f"process's teacher-forced logits at {MOE_TP_LAYERS} layers in "
          f"bf16 against the same weights in f32: max |diff| "
          f"{yard['max_abs']:.3e}, worst share of 0.02 + 0.02|x| "
          f"{yard['worst']:.3f}; the gate {TF_PAIR:g} x it", flush=True)
    for what, rs in (("split×2", rs2), ("data 2 x model 2", rs4)):
        for key in sorted(k for k in rs[0] if k.startswith("tf/")):
            name = key[3:].removesuffix("_fault")
            layers, dtype = MOE_TF[name]
            worst = max(r[key]["worst"] for r in rs)
            gap = max(r[key]["max_abs"] for r in rs)
            gate = TF_PAIR * yard["worst"] if dtype == "bfloat16" else 1.0
            beyond = worst > gate
            print(f"[moe-engine] (d) {what} teacher-forced {key[3:]} "
                  f"({layers} layers): max |diff| {gap:.3e}, worst share of "
                  f"{TF_TOL[dtype]:g} + {TF_TOL[dtype]:g}|x| {worst:.3f} "
                  f"against the gate {gate:.3f}: "
                  f"{'beyond' if beyond else 'within'}", flush=True)
            if key.endswith("_fault"):
                if dtype == "float32" and not beyond:
                    fails.append(f"(d) {key}: the planted fault within the "
                                 f"f32 gate")
            elif beyond:
                fails.append(f"(d) {what} {key}: {worst:.3f} beyond "
                             f"{gate:.3f}")

    def total(rs):
        return {k: sum(r["paged"]["counts"][k] for r in rs)
                for k in rs[0]["paged"]["counts"]}

    return {"serve_moe_tp": total(rs2), "serve_moe_dp_tp": total(rs4)}


def moe_engine(torch, kernels) -> dict:
    """Phase 32: the MoE family across the engine.  Here first, unsharded,
    the references (:func:`_moe_references`); then two ranks on ``cuda:0``
    over gloo run (a) pipeline×2, (c) the balance at data 2 and (d)
    serving at split×2, and four ranks (b) pipeline×2 over model 2 and (d)
    serving at data 2 x model 2 (:func:`_moe_engine_rank`).  Everything is
    printed before it is held:

    - (a, b): bf16 losses, ``moe_lb`` and ``moe_z`` (every step) and each
      step-0 gradient leaf within TF_PAIR times bf16's own error of the
      unpipelined bf16 step; f32 within 1e-4 + 1e-4|x| (values) and 2e-4
      of each leaf's max (gradients); the ranks' losses equal; each rank's
      launches those of its stage;
    - (c): the global balance's loss, ``moe_lb`` and ``moe_z`` within
      1e-4 + 1e-4|x| and each gradient leaf within 2e-4 of its max of one
      process on both rows; the planted per-replica balance outside that
      gate;
    - (d): every rank's tokens equal; launches those of its admissions and
      steps; the f32 tokens equal to the unsharded ``serve.main``'s;
      teacher-forced logits in bf16 within TF_PAIR times bf16's own error
      at MOE_TP_LAYERS, in f32 within 1e-4 + 1e-4|x|; the planted fault
      (the moe combine without its all-reduce over ``model``) outside the
      f32 gate.

    Returns the launches of each path, summed over its ranks."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_engine_")
    t00 = time.perf_counter()
    try:
        refs = _moe_references(torch, tmp)
        t0 = time.perf_counter()
        ranks = {2: spawn_ranks(_moe_engine_rank, tmp, 2, timeout=600)}
        t1 = time.perf_counter()
        ranks[4] = spawn_ranks(_moe_engine_rank, tmp, 4, nprocs=4,
                               timeout=600)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    parts = {w: {k: round(max(o["seconds"][k] for o in rs), 1)
                 for k in rs[0]["seconds"]} for w, rs in ranks.items()}
    print(f"[moe-engine] seconds: the unsharded references {t0 - t00:.1f}; "
          f"two ranks {t1 - t0:.1f} (parts {parts[2]}); four ranks "
          f"{t2 - t1:.1f} (parts {parts[4]})", flush=True)
    fails = []
    counts = _moe_report_pp(torch, ranks, refs, fails)
    counts.update(_moe_report_dp(torch, ranks[2], refs, fails))
    counts.update(_moe_report_serve(ranks, refs, fails))
    if fails:
        raise AssertionError("; ".join(fails))
    return counts


# ---------------------------------------------------------------------------
# phase 33: the dense family's rest
# ---------------------------------------------------------------------------

#: the configs, and what each brings to the dense family
DENSE_REST = {"qwen3-1.7b": "qk-norm, tied head, 16/8 heads of 128",
              "gemma-2b": "GeGLU, MQA 8/1 heads of 256, tied 256k head",
              "stablelm-3b": "LayerNorm, MHA 32/32 heads of 80"}
DR_SERVE = ["--requests", "8", "--batch-slots", "8", "--prompt-len", "256",
            "--gen", "16", "--max-len", "512"]
DR_TRAIN_STEPS = 2


def live_slots(server) -> int:
    """A Server's slots that hold a request."""
    return sum(r is not None for r in server.slots)


@contextlib.contextmanager
def host_timed(torch, obj, name: str, out: list, tag=None):
    """``obj.<name>`` timed on the host clock, the card synchronized before
    and after: each call appends (seconds, ``tag(first argument)``) to
    ``out``; the attribute is restored on exit."""
    real = getattr(obj, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = real(*a, **kw)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0, tag(a[0]) if tag else None))
        return r

    setattr(obj, name, timed)
    try:
        yield
    finally:
        setattr(obj, name, real)


def dense_rest_serve(torch, kernels, arch: str, tag: str = "dense-rest",
                     serve_args: tuple = tuple(DR_SERVE)) -> dict:
    """Phase 33 (a): ``serve.run`` on ``arch`` at full width and depth in
    bf16, paged (64-row pages) and dense, 8 requests of 256 + 16 tokens
    (``serve_args``; phase 37 gives 256 + 32) through 8 slots: TTFT (one
    admission, its prefill and first token),
    TPOT (a decode step at 8 live slots), tokens/s, the peak beside the
    weights and KV, and the launches (flash forward one per layer and
    admission, paged decode one per layer and step, nothing else)."""
    from repro_torch.launch import serve
    from repro_torch.models.lm import param_count
    from repro_torch.serving import server as srv
    from repro_torch.tree import flatten

    out = {}
    for cache in ("paged", "dense"):
        argv = (["--arch", arch, "--cache", cache] + list(serve_args)
                + (["--page-size", "64"] if cache == "paged" else []))
        admits, steps = [], []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        with host_timed(torch, srv.Server, "admit", admits), \
                host_timed(torch, srv.Server, "step", steps, live_slots):
            summary, server = serve.run(serve.parse_args(argv))
        counts = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated()
        kv = server.pools if cache == "paged" else server.state["cache"]
        kv_bytes = sum(t.numel() * t.element_size() for t in flatten(kv)[1])
        layers = server.model.cfg.n_layers
        n = param_count(server.model.param_shapes())
        full = [t for t, k in steps if k == 8]
        ttft = statistics.median(t for t, _ in admits)
        tpot = statistics.median(full or [t for t, _ in steps])
        print(f"[{tag}] {arch} serve {cache}: {summary['completed']} "
              f"requests, {summary['tokens']} tokens, {summary['steps']} "
              f"decode steps in {summary['seconds']:.3f} s "
              f"({summary['tokens'] / summary['seconds']:.1f} tok/s); TTFT "
              f"{ttft * 1e3:.2f} ms (median admission: a 256-token prefill "
              f"and its first token), TPOT {tpot * 1e3:.2f} ms (median "
              f"decode step, {len(full)} with 8 live slots), host clock, "
              f"synced; {n:,} parameters ({n * 2 / 2**30:.2f} GiB in bf16), "
              f"KV {kv_bytes / 2**30:.3f} GiB, peak device memory "
              f"{peak / 2**30:.2f} GiB; launches {counts}", flush=True)
        if summary["completed"] != 8:
            raise AssertionError(f"{arch} serve {cache}: "
                                 f"{summary['completed']} requests")
        want_pd = layers * summary["steps"] if cache == "paged" else 0
        if counts["flash_fwd"] != layers * len(admits) \
                or counts["paged_decode"] != want_pd \
                or sum(counts.values()) != counts["flash_fwd"] + want_pd:
            raise AssertionError(f"{arch} serve {cache}: launches {counts}")
        out[cache] = counts
        del server
        torch.cuda.empty_cache()
    return out


#: the plain run's witness of the driver's bf16 losses: each step's loss
#: through the kernels within this share of the plain versions', over
#: the first DR_WITNESS_STEPS steps (1 of 3: the plain versions' steps
#: are the slowest of the phase)
DR_WITNESS_REL = 0.05
DR_WITNESS_STEPS = 1


def timed_train(torch, kernels, argv: list, steps: int,
                witness: int = 0) -> dict:
    """``train.main(argv)`` for ``steps`` steps with a fresh checkpoint
    directory, remat full, AdamW: the result, the launches, the peak and,
    on the host clock, each step's forward (``Model.loss_fn``) and AdamW
    (``apply``); the backward is the rest of the step.  With ``witness``
    the same first ``witness`` steps again through the plain versions on
    the card (:func:`plain_on_card`): their losses, seconds and peak.
    The final checkpoint is neither copied to the host nor written."""
    import dataclasses

    from repro_torch.launch import train
    from repro_torch.models.lm import Model

    fwd, upd, written = [], [], []
    real_adamw = train.adamw

    def timed_adamw(*a, **kw):
        o = real_adamw(*a, **kw)

        def apply(*aa, **kk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = o.apply(*aa, **kk)
            torch.cuda.synchronize()
            upd.append(time.perf_counter() - t0)
            return r
        return dataclasses.replace(o, apply=apply)

    def drive(n):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return train.main(argv + ["--steps", str(n), "--optimizer", "adamw",
                                  "--log-every", "1", "--ckpt-dir", tmp])

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    train.adamw = timed_adamw
    try:
        with no_checkpoint_write(written):
            reset_counts(kernels)
            with host_timed(torch, Model, "loss_fn", fwd):
                out["res"] = drive(steps)
            out["counts"] = read_counts(kernels)
            out["peak"] = torch.cuda.max_memory_allocated()
            train.adamw = real_adamw
            if witness:
                with plain_on_card():
                    t0 = time.perf_counter()
                    out["plain"] = drive(witness)["losses"]
                    out["plain_s"] = time.perf_counter() - t0
                out["plain_peak"] = torch.cuda.max_memory_allocated()
    finally:
        train.adamw = real_adamw
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    secs = out["res"]["step_seconds"]
    if not len(secs) == len(fwd) == len(upd) == steps:
        raise AssertionError(f"{argv}: {len(secs)} steps, {len(fwd)} "
                             f"forwards, {len(upd)} updates")
    out["fwd_ms"] = statistics.median(t for t, _ in fwd[1:]) * 1e3
    out["opt_ms"] = statistics.median(upd[1:]) * 1e3
    out["bwd_ms"] = statistics.median(s - f - o for s, (f, _), o in
                                      zip(secs[1:], fwd[1:], upd[1:])) * 1e3
    out["written"] = written
    return out


def dense_rest_train(torch, kernels, arch: str) -> dict:
    """Phase 33 (b): ``train.main`` on ``arch`` at full width and depth,
    batch 4 x 2048, remat full, AdamW, DR_TRAIN_STEPS steps
    (:func:`timed_train`): finite losses, the launches, tokens/s after
    step 0 and, in those steps, the forward, AdamW and the backward on
    the host clock; the peak beside the parameters, gradients and
    moments.  Then the first DR_WITNESS_STEPS steps through the plain
    versions on the card, the witness of the losses' course: each step's
    loss through the kernels within DR_WITNESS_REL of the plain run's."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model, param_count

    cfg = get_config(arch)
    run = timed_train(torch, kernels, ["--arch", arch, "--batch",
                                       str(TRAIN_BATCH), "--seq",
                                       str(TRAIN_SEQ)],
                      DR_TRAIN_STEPS, DR_WITNESS_STEPS)
    res, counts, peak, plain = (run["res"], run["counts"], run["peak"],
                                run["plain"])
    n = param_count(Model(cfg, "meta").param_shapes())
    secs = res["step_seconds"]
    tok = TRAIN_BATCH * TRAIN_SEQ
    print(f"[dense-rest] {arch} train, {cfg.n_layers} layers, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: {n:,} parameters; losses "
          f"{res['losses']}; step seconds {[round(x, 3) for x in secs]} "
          f"({tok / statistics.median(secs[1:]):.1f} tok/s after step 0); "
          f"after step 0, medians: forward {run['fwd_ms']:.1f} ms, backward "
          f"(the recompute included) {run['bwd_ms']:.1f} ms, AdamW "
          f"{run['opt_ms']:.1f} ms; peak "
          f"device memory {peak / 2**30:.2f} GiB beside parameters, "
          f"gradients and AdamW moments {16 * n / 1e9:.2f} GB; final "
          f"checkpoint at step {run['written']} (host copy and write "
          f"skipped); launches {counts}", flush=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(res["losses"], plain)]
    print(f"[dense-rest] {arch} train through the plain versions (the "
          f"first {DR_WITNESS_STEPS} driver steps, bf16): losses {plain} in "
          f"{run['plain_s']:.1f} s, peak {run['plain_peak'] / 2**30:.2f} "
          f"GiB; kernels against plain |diff| / |plain| "
          f"{[f'{x:.2e}' for x in rel]} (gate {DR_WITNESS_REL})", flush=True)
    if not all(math.isfinite(x) for x in res["losses"] + plain):
        raise AssertionError(f"{arch} train: losses {res['losses']}, "
                             f"plain {plain}")
    if len(plain) != DR_WITNESS_STEPS or not max(rel) <= DR_WITNESS_REL:
        raise AssertionError(f"{arch} train: losses {res['losses']} through "
                             f"the kernels, {plain} through the plain "
                             f"versions")
    exp = train_expected(cfg.n_layers, DR_TRAIN_STEPS, cfg.padded_vocab)
    if counts != exp:
        raise AssertionError(f"{arch} train: launches {counts}, want {exp}")
    return counts


def dense_rest_agreement(torch, arch: str) -> None:
    """Phase 33 (c): the kernels against their plain versions on the card
    (:func:`plain_on_card`).  Teacher-forced logits (phase 26's: 2
    prompts of 500, 16 forced steps, paged): at full depth in bf16, the
    plain run within TF_PAIR times the larger of the two runs' own error
    (each against the same weights in f32 through the f32 kernels); at 2
    layers in f32 within 1e-4 + 1e-4|x|.  Step 0's loss and every
    gradient leaf at 2 layers in f32 (batch 4 x 2048) within 2e-4 +
    2e-4|x|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.planner import compile_plan, loss_and_grads
    from repro_torch.models.lm import Model
    from repro_torch.tree import flatten

    cfg = get_config(arch)
    model = Model(cfg)
    plan = compile_plan(model, None)
    params = model.serving_params(plan.init_params(0))
    tf = {"paged": teacher_forced(torch, model, plan, params, "paged")}
    with plain_on_card():
        tf["plain"] = teacher_forced(torch, model, plan, params, "paged")
    # the same weights in f32, leaf by leaf
    for node in _dicts(params):
        for k, v in node.items():
            if isinstance(v, torch.Tensor):
                node[k] = v.float()
    m32 = Model(dataclasses.replace(cfg, dtype="float32"))
    tf["f32"] = teacher_forced(torch, m32, compile_plan(m32, None), params,
                               "paged")
    del params
    torch.cuda.empty_cache()
    tol = TF_TOL["bfloat16"]
    own = {k: tf_gap(tf[k], tf["f32"], tol) for k in ("paged", "plain")}
    gate = TF_PAIR * max(own["paged"]["worst"], own["plain"]["worst"])
    g = tf_gap(tf["plain"], tf["paged"], tol)
    print(f"[dense-rest] {arch} teacher-forced bf16, {cfg.n_layers} layers: "
          f"bf16's own error (against the same weights in f32) worst share "
          f"of 0.02 + 0.02|x| {own['paged']['worst']:.3f} through the "
          f"kernels, {own['plain']['worst']:.3f} through the plain "
          f"versions; kernels against plain max |diff| {g['max_abs']:.3e}, "
          f"worst share {g['worst']:.3f} against the gate {gate:.3f}",
          flush=True)
    fails = []
    if not g["worst"] <= gate:
        fails.append(f"teacher-forced bf16: {g['worst']:.3f} beyond "
                     f"{gate:.3f}")
    if not all(torch.isfinite(t).all() for t in tf.values()):
        fails.append("non-finite teacher-forced logits")
    del tf
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    m2 = Model(small)
    plan2 = compile_plan(m2, None)
    p2 = m2.serving_params(plan2.init_params(0))
    got = teacher_forced(torch, m2, plan2, p2, "paged")
    with plain_on_card():
        want = teacher_forced(torch, m2, plan2, p2, "paged")
    g = tf_gap(got, want, TF_TOL["float32"])
    del p2, got, want
    batch = _first_batch(torch, cfg.vocab, TRAIN_BATCH)
    p2 = m2.init(0)
    loss_k, _, g_k = loss_and_grads(m2, p2, batch)
    with plain_on_card():
        loss_p, _, g_p = loss_and_grads(m2, p2, batch)
    lim = GRAD_TOL[str(torch.float32)]
    worst = max(check_close(f"{arch} f32 2 layers gradient {k}", a, b,
                            torch.float32, lim)
                for (k, a), b in zip(zip(*flatten(g_k)), flatten(g_p)[1]))
    check_close(f"{arch} f32 2 layers loss", loss_k, loss_p, torch.float32,
                lim)
    print(f"[dense-rest] {arch} f32, 2 layers, through the kernels against "
          f"the plain versions: teacher-forced max |diff| "
          f"{g['max_abs']:.3e}, worst share of 1e-4 + 1e-4|x| "
          f"{g['worst']:.3f}; step 0 loss {float(loss_k):.6f} vs "
          f"{float(loss_p):.6f}, every gradient leaf within 2e-4 + 2e-4|x| "
          f"(max |diff| {worst:.3e})", flush=True)
    if not g["worst"] <= 1:
        fails.append("f32 teacher-forced logits outside 1e-4 + 1e-4|x|")
    del p2, g_k, g_p
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{arch}: " + "; ".join(fails))


def dense_rest(torch, kernels) -> dict:
    """Phase 33: the dense family's rest, qwen3-1.7b, gemma-2b and
    stablelm-3b, each served (:func:`dense_rest_serve`), trained
    (:func:`dense_rest_train`) and held against the plain versions
    (:func:`dense_rest_agreement`).  Returns each path's launches."""
    counts = {}
    for arch, what in DENSE_REST.items():
        t0 = time.perf_counter()
        print(f"[dense-rest] {arch}: {what}", flush=True)
        name = arch.split("-")[0]
        served = dense_rest_serve(torch, kernels, arch)
        counts[f"serve_{name}"] = served["paged"]
        counts[f"serve_{name}_dense"] = served["dense"]
        counts[f"train_{name}"] = dense_rest_train(torch, kernels, arch)
        dense_rest_agreement(torch, arch)
        print(f"[dense-rest] {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 34: the hybrid family, jamba-v0.1-52b, on one card
# ---------------------------------------------------------------------------

JAMBA = "jamba-v0.1-52b"
#: (a) one period of jamba (1 attention + 7 SSD blocks, 4 of them with 16
#: experts), 13.27e9 parameters: 26.5 GB in bf16.  All 32 layers take
#: 103 GB, more than one card holds
JB_SERVE_LAYERS = 8
JB_SERVE = ["--arch", JAMBA, "--cache", "dense", "--overrides",
            f"n_layers={JB_SERVE_LAYERS},param_dtype=bfloat16"] + DR_SERVE
#: (b, c) and phase 35: the pattern at attn_period=2, an SSD + dense
#: block then an attention + experts block, every block kind at its
#: published widths (3.68e9 parameters at 2 layers)
JB_PATTERN = "attn_period=2,attn_offset=1"
JB_TRAIN_STEPS = 3
JB_TRAIN_ARGS = ["--arch", JAMBA, "--overrides", f"n_layers=2,{JB_PATTERN}",
                 "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                 "--steps", str(JB_TRAIN_STEPS), "--optimizer", "adafactor",
                 "--log-every", "1"]
#: (c)'s f32 step-0 rows of TRAIN_SEQ (f32 weights and two gradient
#: trees of 14.7 GB each beside the activations)
JB_GRAD_ROWS = 2


def _jamba_cfg(**kw):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(JAMBA), **kw)


def _jamba_pattern(layers: int, **kw):
    return _jamba_cfg(n_layers=layers, attn_period=2, attn_offset=1, **kw)


def jamba_serve(torch, kernels) -> dict:
    """Phase 34 (a): ``serve.run`` on jamba at full width, one period in
    bf16, dense (the hybrid has no paged cache), 8 requests of 256 + 16
    tokens through 8 slots: TTFT (an admission: a 256-token prefill and
    its first token), TPOT (a decode step at 8 live slots), tokens/s, the
    peak beside the weights, KV and SSD states, and the launches: flash
    forward once per attention layer and admission, the SSD scan once per
    SSD layer and admission, nothing else (paged decode 0)."""
    from repro_torch.launch import serve
    from repro_torch.models.lm import param_count
    from repro_torch.serving import server as srv
    from repro_torch.tree import flatten

    admits, steps = [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    with host_timed(torch, srv.Server, "admit", admits), \
            host_timed(torch, srv.Server, "step", steps, live_slots):
        summary, server = serve.run(serve.parse_args(JB_SERVE))
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    stack = server.model.stack
    held = {"attn": 0, "ssd": 0}
    for i, b in enumerate(stack.pattern):
        held[b.mixer] += sum(t.numel() * t.element_size() for t in
                             flatten(server.state["cache"][f"p{i}"])[1])
    n_attn = stack.n_rep * sum(b.mixer == "attn" for b in stack.pattern)
    n_ssd = stack.n_layers - n_attn
    n = param_count(server.model.param_shapes())
    full = [t for t, k in steps if k == 8]
    ttft = statistics.median(t for t, _ in admits)
    tpot = statistics.median(full or [t for t, _ in steps])
    print(f"[jamba] serve dense, {stack.n_layers} layers ({n_attn} attention,"
          f" {n_ssd} SSD), bf16: {summary['completed']} requests, "
          f"{summary['tokens']} tokens, {summary['steps']} decode steps in "
          f"{summary['seconds']:.3f} s ("
          f"{summary['tokens'] / summary['seconds']:.1f} tok/s); TTFT "
          f"{ttft * 1e3:.2f} ms (median admission: a 256-token prefill and "
          f"its first token), TPOT {tpot * 1e3:.2f} ms (median decode step, "
          f"{len(full)} with 8 live slots), host clock, synced; {n:,} "
          f"parameters ({n * 2 / 2**30:.2f} GiB in bf16), KV "
          f"{held['attn'] / 2**30:.3f} GiB, SSD states "
          f"{held['ssd'] / 2**30:.3f} GiB, peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {counts}", flush=True)
    if summary["completed"] != 8:
        raise AssertionError(f"jamba serve: {summary['completed']} requests")
    want = dict.fromkeys(counts, 0)
    want.update(flash_fwd=n_attn * len(admits), ssd_scan=n_ssd * len(admits))
    if counts != want:
        raise AssertionError(f"jamba serve: launches {counts}, want {want}")
    del server
    torch.cuda.empty_cache()
    return counts


def jamba_train(torch, kernels) -> dict:
    """Phase 34 (b): ``train.main`` on jamba at full width and the 2-layer
    pattern (:data:`JB_PATTERN`), batch 4 x 2048, remat full, Adafactor
    (the reference's recipe for the archs of 50B and more), JB_TRAIN_STEPS
    steps: finite losses, ``moe_lb`` and ``moe_z``, the launches, tokens/s
    after step 0 and, in those steps, the forward (``loss_fn``),
    Adafactor (``apply``) and the backward (the rest of the step) on the
    host clock; the peak beside the parameters, gradients and Adafactor's
    state.  The final checkpoint is neither copied to the host nor
    written.  Then one step through ``--auto``: the planner's pick on one
    card and its step-0 loss, equal to the run's without it."""
    import dataclasses

    from repro_torch.launch import train
    from repro_torch.models.lm import Model, param_count
    from repro_torch.tree import flatten

    cfg = _jamba_pattern(2)
    fwd, upd, written, held = [], [], [], []
    real_adafactor = train.adafactor

    def timed_adafactor(*a, **kw):
        o = real_adafactor(*a, **kw)

        def init(params):
            st = o.init(params)
            held.append(sum(t.numel() * t.element_size()
                            for t in flatten(st)[1]
                            if isinstance(t, torch.Tensor)))
            return st

        def apply(*aa, **kk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = o.apply(*aa, **kk)
            torch.cuda.synchronize()
            upd.append(time.perf_counter() - t0)
            return r
        return dataclasses.replace(o, init=init, apply=apply)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_jamba_")
    train.adafactor = timed_adafactor
    try:
        with no_checkpoint_write(written):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernels)
            with host_timed(torch, Model, "loss_fn", fwd):
                res = train.main(JB_TRAIN_ARGS + ["--ckpt-dir", tmp])
            counts = read_counts(kernels)
            peak = torch.cuda.max_memory_allocated()
            train.adafactor = real_adafactor
            shutil.rmtree(tmp, ignore_errors=True)
            torch.cuda.empty_cache()
            # the planner's pick on one card: the same plan, the same
            # step 0
            auto = train.main(JB_TRAIN_ARGS + ["--steps", "1", "--auto",
                                               "--ckpt-dir", tmp])
    finally:
        train.adafactor = real_adafactor
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    n = param_count(Model(cfg, "meta").param_shapes())
    secs = res["step_seconds"]
    if not len(secs) == len(fwd) == len(upd) == JB_TRAIN_STEPS:
        raise AssertionError(f"jamba train: {len(secs)} steps, {len(fwd)} "
                             f"forwards, {len(upd)} updates")
    f_ms = statistics.median(t for t, _ in fwd[1:]) * 1e3
    o_ms = statistics.median(upd[1:]) * 1e3
    b_ms = statistics.median(s - f - o for s, (f, _), o in
                             zip(secs[1:], fwd[1:], upd[1:])) * 1e3
    tok = TRAIN_BATCH * TRAIN_SEQ
    print(f"[jamba] train, 2 layers ({JB_PATTERN}: SSD + dense MLP, "
          f"attention + 16 experts), batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"Adafactor: {n:,} parameters; losses {res['losses']}, moe_lb "
          f"{res['moe_lb']}, moe_z {res['moe_z']}; step seconds "
          f"{[round(x, 3) for x in secs]} "
          f"({tok / statistics.median(secs[1:]):.1f} tok/s after step 0); "
          f"after step 0, medians: forward {f_ms:.1f} ms, backward (the "
          f"recompute included) {b_ms:.1f} ms, Adafactor {o_ms:.1f} ms; "
          f"peak device memory {peak / 2**30:.2f} GiB beside parameters "
          f"and gradients {8 * n / 2**30:.2f} GiB (f32) and Adafactor's "
          f"state {held[0] / 2**30:.3f} GiB; final checkpoint at step "
          f"{written} (host copy and write skipped); launches {counts}",
          flush=True)
    print(f"[jamba] train --auto on one card: [auto] chose "
          f"{auto['strategy']}; step-0 loss {auto['losses'][0]!r} against "
          f"{res['losses'][0]!r} without --auto", flush=True)
    if (auto["strategy"], auto["losses"][0]) != (res["strategy"],
                                                 res["losses"][0]):
        raise AssertionError(f"jamba train --auto: {auto['strategy']}, "
                             f"{auto['losses']}")
    vals = res["losses"] + res["moe_lb"] + res["moe_z"]
    if not all(math.isfinite(x) for x in vals) or min(res["moe_lb"]) <= 0:
        raise AssertionError(f"jamba train: losses {res['losses']}, moe_lb "
                             f"{res['moe_lb']}, moe_z {res['moe_z']}")
    exp = train_expected(1, JB_TRAIN_STEPS, cfg.padded_vocab)
    if counts != exp:
        raise AssertionError(f"jamba train: launches {counts}, want {exp}")
    return counts


def _jamba_bf16_pair(torch, cfg, routed) -> dict:
    """Teacher-forced logits (phase 26's: 2 prompts of 500, 16 forced
    steps, dense) of ``cfg`` in bf16 from one bf16 draw, through the
    kernels and through the plain versions (:func:`plain_on_card`), and
    bf16's own error: each run against the same weights in f32 through
    the f32 kernels (shares of 0.02 + 0.02|x|).  Returns the two runs'
    gap, their own errors, the median |logit|, what twice the larger own
    error would allow at it, and the routing choices that flip between
    the runs."""
    import dataclasses

    from repro_torch.core.planner import compile_plan
    from repro_torch.models.lm import Model

    model = Model(cfg)
    plan = compile_plan(model, None)
    params = model.serving_params(plan.init_params(0))
    rk, rp = {}, {}
    tf = {"kernels": routed(lambda: teacher_forced(
        torch, model, plan, params, "dense"), rk)}
    with plain_on_card():
        tf["plain"] = routed(lambda: teacher_forced(
            torch, model, plan, params, "dense"), rp)
    flips = _keyed_flips(rk, rp)
    del rk, rp
    for node in _dicts(params):         # the same weights in f32, in place
        for k, v in node.items():
            if isinstance(v, torch.Tensor):
                node[k] = v.float()
    m32 = Model(dataclasses.replace(cfg, dtype="float32"))
    tf["f32"] = teacher_forced(torch, m32, compile_plan(m32, None), params,
                               "dense")
    del params
    torch.cuda.empty_cache()
    tol = TF_TOL["bfloat16"]
    own = {k: tf_gap(tf[k], tf["f32"], tol)["worst"]
           for k in ("kernels", "plain")}
    out = {"gap": tf_gap(tf["plain"], tf["kernels"], tol), "own": own,
           "flips": flips, "median": float(tf["f32"].float().abs().median()),
           "finite": all(bool(torch.isfinite(t).all()) for t in tf.values())}
    out["allows"] = TF_PAIR * max(own.values()) * (tol + tol * out["median"])
    return out


def jamba_agreement(torch) -> None:
    """Phase 34 (c): the kernels against their plain versions on the card
    (:func:`plain_on_card`: flash, xent and the SSD scan).  Teacher-forced
    logits in bf16 (:func:`_jamba_bf16_pair`) at one period and at the
    2-layer pattern are printed, not held: at random weights bf16's own
    error there lets twice it (phases 26 and 33's gate) allow more than
    a typical logit, so such a gate would hold nothing; phase 3 holds the
    bf16 builds at jamba's shapes.  At the 2-layer pattern in f32,
    teacher-forced logits within 1e-4 + 1e-4|x|, and step 0's loss and
    every gradient leaf (JB_GRAD_ROWS x 2048) within 2e-4 + 2e-4|x|.
    Each pair's routing choices that flip are counted and printed."""
    from repro_torch.core.planner import compile_plan, loss_and_grads
    from repro_torch.models import moe
    from repro_torch.models.lm import Model
    from repro_torch.tree import flatten

    def routed(fn, record):
        real = _route_by_micro(torch, record, {"mb": 0})
        try:
            return fn()
        finally:
            moe._route = real

    fails = []
    for layers, cfg in (
            (JB_SERVE_LAYERS, _jamba_cfg(n_layers=JB_SERVE_LAYERS,
                                         param_dtype="bfloat16")),
            (2, _jamba_pattern(2, param_dtype="bfloat16"))):
        r = _jamba_bf16_pair(torch, cfg, routed)
        g, flips = r["gap"], r["flips"]
        print(f"[jamba] teacher-forced bf16, {layers} layers"
              f"{'' if layers == JB_SERVE_LAYERS else f' ({JB_PATTERN})'}: "
              f"bf16's own error (against the same weights in f32) worst "
              f"share of 0.02 + 0.02|x| {r['own']['kernels']:.3f} through "
              f"the kernels, {r['own']['plain']:.3f} through the plain "
              f"versions; kernels against plain max |diff| "
              f"{g['max_abs']:.3e}, worst share {g['worst']:.3f}; twice "
              f"the own error would allow {r['allows']:.3e} at the median "
              f"|logit| {r['median']:.3e} (printed, not held); routing: "
              f"{flips[0]} of "
              f"{flips[1]} tokens' expert sets differ "
              f"({flips[0] / flips[1]:.4f})", flush=True)
        if not r["finite"]:
            fails.append(f"non-finite teacher-forced logits at {layers} "
                         f"layers")
    small = _jamba_pattern(2, dtype="float32")
    m2 = Model(small)
    plan2 = compile_plan(m2, None)
    p2 = m2.serving_params(plan2.init_params(0))
    rk, rp = {}, {}
    got = routed(lambda: teacher_forced(torch, m2, plan2, p2, "dense"), rk)
    with plain_on_card():
        want = routed(lambda: teacher_forced(torch, m2, plan2, p2, "dense"),
                      rp)
    g = tf_gap(got, want, TF_TOL["float32"])
    tf_flips = _keyed_flips(rk, rp)
    del p2, got, want
    torch.cuda.empty_cache()
    batch = _first_batch(torch, small.vocab, JB_GRAD_ROWS)
    p2 = m2.init(0)
    rk, rp = {}, {}
    loss_k, m_k, g_k = routed(lambda: loss_and_grads(m2, p2, batch), rk)
    with plain_on_card():
        loss_p, m_p, g_p = routed(lambda: loss_and_grads(m2, p2, batch), rp)
    step_flips = _keyed_flips(rk, rp)
    lim = GRAD_TOL[str(torch.float32)]
    worst = max(check_close(f"jamba f32 2 layers gradient {k}", a, b,
                            torch.float32, lim)
                for (k, a), b in zip(zip(*flatten(g_k)), flatten(g_p)[1]))
    for k, a, b in (("loss", loss_k, loss_p),
                    ("moe_lb", m_k["moe_lb"], m_p["moe_lb"]),
                    ("moe_z", m_k["moe_z"], m_p["moe_z"])):
        check_close(f"jamba f32 2 layers {k}", a, b, torch.float32, lim)
    print(f"[jamba] f32, 2 layers ({JB_PATTERN}), through the kernels "
          f"against the plain versions: teacher-forced max |diff| "
          f"{g['max_abs']:.3e}, worst share of 1e-4 + 1e-4|x| "
          f"{g['worst']:.3f} (routing flips {tf_flips[0]} of "
          f"{tf_flips[1]}); step 0 at {JB_GRAD_ROWS} x {TRAIN_SEQ}: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f}, moe_lb "
          f"{float(m_k['moe_lb']):.6f} vs {float(m_p['moe_lb']):.6f}, "
          f"moe_z {float(m_k['moe_z']):.6f} vs {float(m_p['moe_z']):.6f}, "
          f"every gradient leaf within 2e-4 + 2e-4|x| (max |diff| "
          f"{worst:.3e}); routing flips {step_flips[0]} of "
          f"{step_flips[1]}", flush=True)
    if not g["worst"] <= 1:
        fails.append("f32 teacher-forced logits outside 1e-4 + 1e-4|x|")
    del p2, g_k, g_p
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError("jamba: " + "; ".join(fails))


def jamba(torch, kernels) -> dict:
    """Phase 34: jamba-v0.1-52b on one card: served at one period
    (:func:`jamba_serve`), trained at the 2-layer pattern
    (:func:`jamba_train`) and held against the plain versions
    (:func:`jamba_agreement`).  Returns each path's launches."""
    t0 = time.perf_counter()
    counts = {"serve_jamba": jamba_serve(torch, kernels)}
    t1 = time.perf_counter()
    counts["train_jamba"] = jamba_train(torch, kernels)
    t2 = time.perf_counter()
    jamba_agreement(torch)
    print(f"[jamba] seconds: serve {t1 - t0:.1f}, train {t2 - t1:.1f}, "
          f"agreement {time.perf_counter() - t2:.1f}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 35: the ssm and hybrid families across the engine
# ---------------------------------------------------------------------------

#: (a) mamba2 at full width and 4 layers, 2 a stage, on launch.train's
#: stream of TRAIN_BATCH x TRAIN_SEQ in PP_MICRO micro-batches, 1f1b,
#: AdamW at PP_LR: name -> (activation dtype, steps); bf16 is the path,
#: f32 holds its step 0 to f32's limits (phase 32's runs)
M2_PP_LAYERS = 4
M2_PP_RUNS = {"bf16": ("bfloat16", 2), "f32": ("float32", 1)}
#: (b) jamba at 4 layers of JB_PATTERN (one period a stage), f32, step 0
#: in 2 micro-batches of one row of JB_PP_SEQ: each of the two ranks on
#: one card holds 25.4 GiB of weights and gradients beside its
#: activations (the SSD mixer's chunked form at 128 heads grows with the
#: row)
JB_PP_LAYERS, JB_PP_MICRO, JB_PP_SEQ = 4, 2, 1024
#: (c) jamba split x2 (tp 2 = ep 2) at 2 layers of JB_PATTERN, f32, step
#: 0 on JB_TP_ROWS x JB_TP_SEQ
JB_TP_ROWS, JB_TP_SEQ = 2, 1024
#: (b, c): every expert of an expert leaf is held element by element on
#: the first 1/JB_EXPERT_ROWS of its rows (the whole f32 leaves through
#: files, ~40 GB, cost a minute); the max |x| is the whole leaf's
JB_EXPERT_ROWS = 8


def _expert_rows(path: str, g):
    """The rows of ``g`` held in phase 35 (b, c): an expert leaf's first
    1/JB_EXPERT_ROWS of each expert's rows, every other leaf whole."""
    if not path.endswith(ROUTED):
        return g
    return g[..., :g.shape[-2] // JB_EXPERT_ROWS, :]


def _route_by_micro(torch, record: dict, cur: dict):
    """Wrap ``moe._route`` so each call files its expert ids (sorted, on
    the host) under (the layer's router fingerprint, its micro-batch, the
    call's count for that pair): a forward and its checkpointed recompute
    file two entries, whatever order a schedule runs them in.  The
    micro-batch is ``cur["mb"]``, or where ``cur`` has an ``order`` (a
    stage's slots that route, in its schedule's order) the one of the
    layer's call by its count."""
    from repro_torch.models import moe

    real = moe._route

    def route(params, x, cfg, split=None):
        out = real(params, x, cfg, split)
        layer = tuple(params["router"]["w"].reshape(-1)[:4].tolist())
        mb = (cur["order"][sum(1 for k in record if k[0] == layer)]
              if "order" in cur else cur["mb"])
        n = sum(1 for k in record if k[:2] == (layer, mb))
        record[(layer, mb, n)] = out[2].detach().sort(-1).values.cpu()
        return out

    moe._route = route
    return real


def _keyed_flips(got: dict, want: dict) -> list:
    """[tokens whose expert set differs, tokens] over the routing calls
    ``got`` files (:func:`_route_by_micro`; a rank's layers), against the
    same keys of ``want``."""
    missing = set(got) - set(want)
    if missing:
        raise AssertionError(f"routing calls without a reference: "
                             f"{len(missing)}")
    return [sum(int((got[k] != want[k]).any(-1).sum()) for k in got),
            sum(v.numel() // v.shape[-1] for v in got.values())]


def _m2_pp_model(dtype: str):
    """Phase 35 (a)'s model: mamba2 at M2_PP_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model
    return Model(dataclasses.replace(get_config(MAMBA),
                                     n_layers=M2_PP_LAYERS, dtype=dtype))


def _jb_pp_reference(torch, d: str) -> dict:
    """(b)'s unpipelined step of one process: jamba at JB_PP_LAYERS layers
    of JB_PATTERN in f32 on the first JB_PP_MICRO rows, a row a
    micro-batch, each micro-batch's loss over JB_PP_MICRO backed into the
    leaves' ``.grad`` in place.  Each repeat's slice of a stacked leaf is
    a leaf of its own here (``loss_fn`` takes the blocks as a list of
    repeats, as a pipeline stage gives them), so no backward stacks a
    copy of a whole leaf's gradient: 54.5 GB of weights and gradients,
    and no third tree.  Returns the loss,
    ``moe_lb`` and ``moe_z`` (means over the micro-batches), the seconds
    and the peak; the gradient (stacked on the host) and the routing by
    micro-batch to ``d``."""
    from repro_torch.models import moe
    from repro_torch.models.lm import Model
    from repro_torch.tree import flatten, tree_map

    model = Model(_jamba_pattern(JB_PP_LAYERS, dtype="float32"))
    params = model.init(0)
    n = model.stack.n_rep
    reps = [tree_map(lambda p, r=r: p[r].detach().requires_grad_(True),
                     params["blocks"]) for r in range(n)]
    top = {k: tree_map(lambda p: p.requires_grad_(True), v)
           for k, v in params.items() if k != "blocks"}
    toks = _first_batch(torch, model.cfg.vocab, JB_PP_MICRO,
                        JB_PP_SEQ)["tokens"]
    routes, cur = {}, {"mb": 0}
    real = _route_by_micro(torch, routes, cur)
    rec = {"loss": 0.0, "moe_lb": 0.0, "moe_z": 0.0}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for i in range(JB_PP_MICRO):
            cur["mb"] = i
            loss, m = model.loss_fn(dict(top, blocks=reps),
                                    {"tokens": toks[i:i + 1]})
            (loss / JB_PP_MICRO).backward()
            for k, v in (("loss", loss), ("moe_lb", m["moe_lb"]),
                         ("moe_z", m["moe_z"])):
                rec[k] += float(v.detach()) / JB_PP_MICRO
        torch.cuda.synchronize()
    finally:
        moe._route = real
    rec["seconds"] = time.perf_counter() - t0
    rec["peak"] = torch.cuda.max_memory_allocated()
    del params
    paths, rep_leaves = flatten(reps[0])[0], [flatten(r)[1] for r in reps]

    def stacked():               # a leaf's rows stacked on the host, then
        for i, path in enumerate(paths):            # let go on the card
            top = max(float(torch.linalg.vector_norm(ls[i].grad,
                                                     float("inf")))
                      for ls in rep_leaves)
            rows = [_expert_rows(path, ls[i].grad).cpu() for ls in rep_leaves]
            for ls in rep_leaves:
                ls[i].grad = None
            yield f"blocks/{path}", torch.stack(rows), top

    _save_leaves(torch, d, [(q, x.grad) for q, x in zip(*flatten(top))])
    _save_leaves(torch, d, stacked())
    torch.save(routes, os.path.join(d, "routes.pt"))
    del reps, top, rep_leaves
    return rec


def _jb_tp_reference(torch, d: str) -> dict:
    """(c)'s unsharded step of one process: jamba at 2 layers of
    JB_PATTERN in f32 on JB_TP_ROWS x JB_TP_SEQ; its loss, ``moe_lb``,
    ``moe_z``, routing, seconds and peak; the gradient to ``d``."""
    from repro_torch.core.planner import loss_and_grads
    from repro_torch.models import moe
    from repro_torch.models.lm import Model
    from repro_torch.tree import flatten

    model = Model(_jamba_pattern(2, dtype="float32"))
    params = model.init(0)
    batch = _first_batch(torch, model.cfg.vocab, JB_TP_ROWS, JB_TP_SEQ)
    routes = {}
    real = _route_by_micro(torch, routes, {"mb": 0})
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        loss, m, g = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
    finally:
        moe._route = real
    rec = {"loss": float(loss), "moe_lb": float(m["moe_lb"]),
           "moe_z": float(m["moe_z"]), "seconds": time.perf_counter() - t0,
           "peak": torch.cuda.max_memory_allocated()}
    del params
    _save_leaves(torch, d, ((p, _expert_rows(p, x), float(
        torch.linalg.vector_norm(x, float("inf"))))
        for p, x in zip(*flatten(g))))
    torch.save(routes, os.path.join(d, "routes.pt"))
    return rec


def _draw_in_turn(torch, dist, model, keep):
    """``keep(model.init(0))`` on every rank, one rank at a time (the ranks
    share one card, and the whole model's draw is its weights once more):
    each rank keeps only what ``keep`` cuts from its draw."""
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = keep(model.init(0))
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _jb_pp_part(torch, dist, d: str, kernels, stats: dict) -> dict:
    """(b) in a rank: jamba pipeline×2 in f32, this stage's period drawn in
    turn (:func:`_draw_in_turn`), step 0 through ``pipeline_train_step_fn``
    with a recording optimizer: loss, ``moe_lb``, ``moe_z``, step and
    gloo seconds, peak beside the weights and gradients held, launches,
    routing flips against the unpipelined step's by micro-batch, and
    the gradient against ``d/jb_pp``."""
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.pipeline import _rows, stage_state
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.core.schedule import FWD, make_schedule
    from repro_torch.models import moe
    from repro_torch.models.lm import Model
    from repro_torch.tree import flatten

    strat = StrategySpec(pp=2, micro_batches=JB_PP_MICRO, schedule="1f1b")
    mesh = mesh_for_strategy(strat)
    stage = mesh.get_local_rank("stage")
    plan = compile_plan(Model(_jamba_pattern(JB_PP_LAYERS,
                                             dtype="float32")), mesh, strat)
    sl = plan.stage_layers()
    params = _draw_in_turn(torch, dist, plan.model,
                           lambda whole: stage_state(whole, stage, sl))
    drawn = torch.cuda.memory_allocated()
    n = sum(p.numel() for p in flatten(params)[1])
    ref = os.path.join(d, "jb_pp")
    gaps = {}

    def cut(path, w):
        return _rows(w, stage, sl) if path.startswith("blocks/") else w

    step_fn = plan.pipeline_train_step_fn(_record_opt(
        torch, lambda g: gaps.update(_leaf_gaps(
            torch, {p: _expert_rows(p, x) for p, x in zip(*flatten(g))},
            ref, cut))))
    toks = _first_batch(torch, plan.model.cfg.vocab, JB_PP_MICRO,
                        JB_PP_SEQ)["tokens"]
    # this stage's slots in the schedule's order: each forward routes, and
    # each backward's checkpointed recompute routes again
    recompute = plan.model.stack.remat != "none"
    order = [row[stage][0] for row in make_schedule(
        "1f1b", 2, JB_PP_MICRO).ticks
        if row[stage] is not None and (row[stage][1] == FWD or recompute)]
    routes = {}
    real_route = _route_by_micro(torch, routes, {"order": order})
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    s0 = stats["s"]
    t0 = time.perf_counter()
    try:
        params, _, m = step_fn(params, {}, toks, 0)
        torch.cuda.synchronize()
    finally:
        moe._route = real_route
    rec = {k: float(m[k]) for k in ("loss", "moe_lb", "moe_z")}
    rec.update(seconds=time.perf_counter() - t0, gloo_s=stats["s"] - s0,
               peak=torch.cuda.max_memory_allocated(),
               reserved=torch.cuda.max_memory_reserved(), held=8 * n,
               drawn=drawn, counts=read_counts(kernels), grads=gaps,
               stage=stage, stage_layers=list(sl),
               flips=_keyed_flips(routes, torch.load(
                   os.path.join(ref, "routes.pt"))))
    del params, step_fn
    torch.cuda.empty_cache()
    return rec


def _jb_tp_part(torch, dist, d: str, kernels, stats: dict) -> dict:
    """(c) in a rank: jamba split×2 (tp 2 = ep 2: 16 q over 4 kv heads, 64
    SSD heads, 8 experts, half the MLP columns and 32768 vocab columns a
    rank) in f32, its blocks of the draw made in turn, step 0 through
    ``train_step_fn`` with a recording optimizer: loss, ``moe_lb``,
    ``moe_z``, seconds, peak, launches, routing flips and the gradient
    against ``d/jb_tp``."""
    from repro_torch.core import sharding
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.models import moe
    from repro_torch.models.lm import Model
    from repro_torch.tree import flatten

    strat = StrategySpec(tp=2, ep=2)
    plan = compile_plan(Model(_jamba_pattern(2, dtype="float32")),
                        mesh_for_strategy(strat), strat)
    params = _draw_in_turn(torch, dist, plan.model,
                           lambda whole: plan.shard(whole, plan.param_specs))
    drawn = torch.cuda.memory_allocated()
    n = sum(p.numel() for p in flatten(params)[1])
    specs = dict(zip(*flatten(plan.param_specs)))
    ref = os.path.join(d, "jb_tp")
    gaps = {}
    step_fn = plan.train_step_fn(_record_opt(
        torch, lambda g: gaps.update(_leaf_gaps(
            torch, {p: _expert_rows(p, x) for p, x in zip(*flatten(g))},
            ref, lambda p, w: sharding.shard_leaf(w, specs[p], plan.rules)))))
    batch = plan.batch_slice(_first_batch(torch, plan.model.cfg.vocab,
                                          JB_TP_ROWS, JB_TP_SEQ))
    routes = {}
    real_route = _route_by_micro(torch, routes, {"mb": 0})
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    s0 = stats["s"]
    t0 = time.perf_counter()
    try:
        params, _, m = step_fn(params, {}, batch, 0)
        torch.cuda.synchronize()
    finally:
        moe._route = real_route
    blocks = params["blocks"]
    rec = {k: float(m[k]) for k in ("loss", "moe_lb", "moe_z")}
    rec.update(seconds=time.perf_counter() - t0, gloo_s=stats["s"] - s0,
               peak=torch.cuda.max_memory_allocated(), held=8 * n,
               drawn=drawn, counts=read_counts(kernels), grads=gaps,
               experts=int(blocks["p1"]["moe"]["w_in"].shape[1]),
               ssd_heads=int(blocks["p0"]["ssd"]["A_log"].shape[-1]),
               vp=int(params["head"]["w"].shape[1]),
               line=plan.split_line(),
               flips=_keyed_flips(routes, torch.load(
                   os.path.join(ref, "routes.pt"))))
    del params, step_fn
    torch.cuda.empty_cache()
    return rec


def _hybrid_engine_rank(rank: int, store: str, out_dir: str,
                        ref_dir: str) -> None:
    """One rank of phase 35 on ``cuda:0`` over gloo (a world of two): (a)
    mamba2 pipeline×2, (b) jamba pipeline×2, (c) jamba split×2; each
    part's record and seconds."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.cost_model import StrategySpec

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    kernels = kernel_wrappers()
    stats = {"s": 0.0, "n": 0}
    out = {"seconds": {}}
    try:
        time_collectives(torch, dist, stats)
        parts = (("m2_pp", lambda: _pp_part(
            torch, _m2_pp_model, StrategySpec(
                pp=2, micro_batches=PP_MICRO, schedule="1f1b"), M2_PP_RUNS,
            os.path.join(ref_dir, "m2"), kernels, stats)),
            ("jb_pp", lambda: _jb_pp_part(torch, dist, ref_dir, kernels,
                                          stats)),
            ("jb_tp", lambda: _jb_tp_part(torch, dist, ref_dir, kernels,
                                          stats)))
        for name, fn in parts:
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.empty_cache()
            dist.barrier()              # as in :func:`_moe_engine_rank`
            out["seconds"][name] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _hybrid_references(torch, d: str) -> dict:
    """Phase 35's unsharded references, here before the ranks: (a) the
    unpipelined mamba2 steps in bf16 and f32 and bf16's own error
    (:func:`_pp_references`); (b) and (c) jamba's single-process steps
    (:func:`_jb_pp_reference`, :func:`_jb_tp_reference`)."""
    refs = {"m2": _pp_references(torch, _m2_pp_model, M2_PP_RUNS,
                                 os.path.join(d, "m2"))}
    refs["jb_pp"] = _jb_pp_reference(torch, os.path.join(d, "jb_pp"))
    torch.cuda.empty_cache()
    refs["jb_tp"] = _jb_tp_reference(torch, os.path.join(d, "jb_tp"))
    torch.cuda.empty_cache()
    return refs


def _hybrid_report(torch, ranks: list, refs: dict) -> tuple:
    """Print and hold phase 35's ranks against the references
    (:func:`hybrid_engine`); returns (the failures, each path's launches
    summed over the ranks)."""
    fails = []
    f32_lim = GRAD_TOL[str(torch.float32)]

    def close(x, want):
        return abs(x - want) <= TP_F32_LIMIT + TP_F32_LIMIT * abs(want)

    _pp_refs_lines("[hybrid-engine] (a) mamba2", M2_PP_LAYERS, refs["m2"])
    counts = {"train_mamba2_pipeline": _pp_report(
        torch, "[hybrid-engine]", "(a) mamba2 pipeline×2",
        [o["m2_pp"] for o in ranks], refs["m2"], M2_PP_RUNS, 0, fails)}
    for part, what in (("jb_pp", "(b) jamba pipeline×2"),
                       ("jb_tp", "(c) jamba split×2")):
        want = refs[part]
        rows, seq = ((JB_PP_MICRO, JB_PP_SEQ) if part == "jb_pp"
                     else (JB_TP_ROWS, JB_TP_SEQ))
        print(f"[hybrid-engine] {what}: one process's step on {rows} x "
              f"{seq}: loss "
              f"{want['loss']:.6f}, moe_lb {want['moe_lb']:.6f}, moe_z "
              f"{want['moe_z']:.6f} in {want['seconds']:.3f} s, peak "
              f"{want['peak'] / 2**30:.2f} GiB", flush=True)
        outs = [o[part] for o in ranks]
        for rank, r in enumerate(outs):
            extra = (f"stage {r['stage']} (layers {r['stage_layers']})"
                     if part == "jb_pp" else
                     f"{r['experts']} experts, {r['ssd_heads']} SSD heads, "
                     f"{r['vp']} vocab columns; {r['line']}")
            if "reserved" in r:
                extra += (f", {r['reserved'] / 2**30:.2f} GiB reserved at "
                          f"most")
            print(f"[hybrid-engine] {what} rank {rank}, {extra}: loss "
                  f"{r['loss']:.6f}, moe_lb {r['moe_lb']:.6f}, moe_z "
                  f"{r['moe_z']:.6f}; step {r['seconds']:.3f} s, gloo "
                  f"{r['gloo_s']:.3f} s (ranks time-slice one card); "
                  f"{r['drawn'] / 2**30:.2f} GiB after the draw, peak "
                  f"{r['peak'] / 2**30:.2f} GiB beside "
                  f"{r['held'] / 2**30:.2f} GiB of weights and gradients; "
                  f"routing flips {r['flips'][0]} of {r['flips'][1]} "
                  f"tokens; launches {r['counts']}", flush=True)
            for k in ("loss", "moe_lb", "moe_z"):
                if not close(r[k], want[k]):
                    fails.append(f"{what} rank {rank} {k}: {r[k]!r} "
                                 f"against {want[k]!r}")
            if part == "jb_pp":
                exp = pipeline_expected(1, 1, 65536, head=r["stage"] == 1,
                                        micro=JB_PP_MICRO, seq=JB_PP_SEQ)
            else:
                exp = train_expected(1, 1, r["vp"], rows=JB_TP_ROWS,
                                     seq=JB_TP_SEQ)
            if r["counts"] != exp:
                fails.append(f"{what} rank {rank}: launches {r['counts']}, "
                             f"want {exp}")
        fails += _moe_grad_lines(what, outs, lambda p: f32_lim,
                                 "[hybrid-engine]")
        path = ("train_jamba_pipeline" if part == "jb_pp"
                else "train_jamba_tp")
        counts[path] = {k: sum(o["counts"][k] for o in outs)
                        for k in outs[0]["counts"]}
    return fails, counts


def hybrid_engine(torch, kernels) -> dict:
    """Phase 35: the ssm and hybrid families across the engine.  Here
    first, unsharded, the references (:func:`_hybrid_references`); then two
    ranks on ``cuda:0`` over gloo run (a) mamba2 pipeline×2, (b) jamba
    pipeline×2 and (c) jamba split×2 (:func:`_hybrid_engine_rank`).
    Everything is
    printed before it is held:

    - (a): bf16 losses (every step) and each step-0 gradient leaf within
      TF_PAIR times bf16's own error of the unpipelined bf16 step; f32
      within 1e-4 + 1e-4|x| (the loss) and 2e-4 of each leaf's max (the
      gradients: the tied table's the sum of both stages'); the ranks'
      losses equal; each rank's launches those of its stage (the loss
      head's on the last);
    - (b), (c): the loss, ``moe_lb`` and ``moe_z`` within 1e-4 +
      1e-4|x| of one process's step, each gradient leaf within 2e-4 of
      its max; the launches of the rank's layers and head.

    Returns the launches of each path, summed over its ranks."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hybrid_engine_")
    t00 = time.perf_counter()
    try:
        refs = _hybrid_references(torch, tmp)
        t0 = time.perf_counter()
        ranks = spawn_ranks(_hybrid_engine_rank, tmp, timeout=600)
        t1 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    parts = {k: round(max(o["seconds"][k] for o in ranks), 1)
             for k in ranks[0]["seconds"]}
    print(f"[hybrid-engine] seconds: the unsharded references "
          f"{t0 - t00:.1f}; two ranks {t1 - t0:.1f} (parts {parts})",
          flush=True)
    fails, counts = _hybrid_report(torch, ranks, refs)
    if fails:
        raise AssertionError("; ".join(fails))
    return counts


# ---------------------------------------------------------------------------
# phase 36: grok-1-314b
# ---------------------------------------------------------------------------

GROK = "grok-1-314b"
#: (a) the depth served in bf16 (39.7 GiB of weights; all 64 take 586 GiB)
GK_SERVE_LAYERS = 4
GK_SERVE = ["--arch", GROK, "--overrides",
            f"n_layers={GK_SERVE_LAYERS},param_dtype=bfloat16"] + DR_SERVE
#: (b) the driver at full width and 1 layer (6.531e9 parameters: f32
#: parameters and gradients take 48.7 GiB), Adafactor, the reference's
#: recipe for grok
GK_TRAIN_STEPS = 2
GK_TRAIN_ARGS = ["--arch", GROK, "--overrides", "n_layers=1", "--batch",
                 str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
                 str(GK_TRAIN_STEPS), "--optimizer", "adafactor",
                 "--log-every", "1"]
#: (b) step 0 through the kernels against the plain versions in f32 on
#: GK_GRAD_ROWS x TRAIN_SEQ (two gradient trees of 26.1 GB do not fit
#: beside each other: the first one's held rows wait on the host)
GK_GRAD_ROWS = 1
#: (c) the expert-TP split on 2 ranks: a 2-way axis divides grok's 8
#: experts, so 3 (the reference reaches the fallback only on its 16-way
#: axis), at 1 layer, f32, GK_TP_ROWS x GK_TP_SEQ, GK_TP_STEPS Adafactor
#: steps at PP_LR
GK_TP_EXPERTS, GK_TP_ROWS, GK_TP_SEQ, GK_TP_STEPS = 3, 2, 1024, 2
#: (b, c): a leaf of at least 2^26 elements is held element by element on
#: the first 1/GK_HELD of its ``embed`` dim (never split over model, so a
#: rank's block cuts the same way); the max |x| is the whole leaf's
GK_HELD = 8


def _grok_cfg(**kw):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(GROK), **kw)


def _gk_cuts(model) -> dict:
    """{path: the ``embed`` dim} of the leaves of ``model`` of 2^26
    elements or more (the whole leaf's count, whatever a rank holds)."""
    from repro_torch.tree import flatten

    axes = dict(zip(*flatten(model.axes())))
    return {p: axes[p].index("embed")
            for p, m in zip(*flatten(model.param_shapes()))
            if m.numel() >= 1 << 26 and "embed" in axes[p]}


def _gk_held(cuts: dict, path: str, x):
    """The part of leaf ``path`` (or a rank's block of it) held element by
    element: the first 1/GK_HELD of its ``embed`` dim where ``cuts`` (of
    :func:`_gk_cuts`) names the leaf, else the whole."""
    if path not in cuts:
        return x
    i = cuts[path]
    return x.narrow(i, 0, x.shape[i] // GK_HELD)


def _gk_floor_bytes(model) -> int:
    """A decode step's least read: every weight once (bf16, the router in
    f32) but the embedding table, of which it reads one row a slot."""
    from repro_torch.tree import flatten

    return sum(m.numel() * (4 if "/router/" in p else 2)
               for p, m in zip(*flatten(model.param_shapes()))
               if p != "embed/table")


def grok_serve(torch, kernels) -> dict:
    """Phase 36 (a): ``serve.run`` on grok at full width and
    GK_SERVE_LAYERS layers in bf16, paged (64-row pages; the kernel's
    group of 6) and dense, 8 requests of 256 + 16 tokens through 8 slots:
    TTFT, TPOT, tokens/s, the peak beside the weights and KV, the decode
    step against its floor (every weight but the table read once), the
    launches (flash forward one per layer and admission, paged decode one
    per layer and step, nothing else).  Then teacher-forced logits
    (phase 26's, paged) at 1 layer in f32 through the kernels against the
    plain versions on the card within 1e-4 + 1e-4|x|, and the routing
    choices that flip between them."""
    from repro_torch.core.planner import compile_plan
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.lm import Model, param_count
    from repro_torch.serving import server as srv
    from repro_torch.tree import flatten

    out = {}
    for cache in ("paged", "dense"):
        argv = (GK_SERVE + ["--cache", cache]
                + (["--page-size", "64"] if cache == "paged" else []))
        admits, steps = [], []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        with host_timed(torch, srv.Server, "admit", admits), \
                host_timed(torch, srv.Server, "step", steps, live_slots):
            summary, server = serve.run(serve.parse_args(argv))
        counts = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated()
        kv = server.pools if cache == "paged" else server.state["cache"]
        kv_bytes = sum(t.numel() * t.element_size() for t in flatten(kv)[1])
        layers = server.model.cfg.n_layers
        n = param_count(server.model.param_shapes())
        floor = _gk_floor_bytes(server.model) / PEAK_BYTES_PER_S
        full = [t for t, k in steps if k == 8]
        ttft = statistics.median(t for t, _ in admits)
        tpot = statistics.median(full or [t for t, _ in steps])
        print(f"[grok] serve {cache}, {layers} layers, bf16: "
              f"{summary['completed']} requests, {summary['tokens']} tokens, "
              f"{summary['steps']} decode steps in {summary['seconds']:.3f} s "
              f"({summary['tokens'] / summary['seconds']:.1f} tok/s); TTFT "
              f"{ttft * 1e3:.2f} ms (median admission: a 256-token prefill "
              f"and its first token), TPOT {tpot * 1e3:.2f} ms (median "
              f"decode step, {len(full)} with 8 live slots), host clock, "
              f"synced, against the floor {floor * 1e3:.2f} ms (every weight "
              f"but the table read once at 3.35 TB/s), {tpot / floor:.2f}x; "
              f"{n:,} parameters ({n * 2 / 2**30:.2f} GiB in bf16), KV "
              f"{kv_bytes / 2**30:.3f} GiB, peak device memory "
              f"{peak / 2**30:.2f} GiB; launches {counts}", flush=True)
        if summary["completed"] != 8:
            raise AssertionError(f"grok serve {cache}: "
                                 f"{summary['completed']} requests")
        want_pd = layers * summary["steps"] if cache == "paged" else 0
        if counts["flash_fwd"] != layers * len(admits) \
                or counts["paged_decode"] != want_pd \
                or sum(counts.values()) != counts["flash_fwd"] + want_pd:
            raise AssertionError(f"grok serve {cache}: launches {counts}")
        out[cache] = counts
        del server
        torch.cuda.empty_cache()

    def routed(fn, record):
        real = _route_by_micro(torch, record, {"mb": 0})
        try:
            return fn()
        finally:
            moe._route = real

    model = Model(_grok_cfg(n_layers=1, dtype="float32"))
    plan = compile_plan(model, None)
    params = model.serving_params(plan.init_params(0))
    rk, rp = {}, {}
    got = routed(lambda: teacher_forced(torch, model, plan, params, "paged"),
                 rk)
    with plain_on_card():
        want = routed(lambda: teacher_forced(torch, model, plan, params,
                                             "paged"), rp)
    del params
    torch.cuda.empty_cache()
    g = tf_gap(got, want, TF_TOL["float32"])
    flips = _keyed_flips(rk, rp)
    print(f"[grok] teacher-forced f32 at 1 layer, paged through the kernels "
          f"against the plain versions: max |diff| {g['max_abs']:.3e}, "
          f"worst share of 1e-4 + 1e-4|x| {g['worst']:.3f}; routing flips "
          f"{flips[0]} of {flips[1]} tokens", flush=True)
    if not g["worst"] <= 1:
        raise AssertionError("grok: f32 teacher-forced logits outside "
                             "1e-4 + 1e-4|x|")
    return out


def grok_train(torch, kernels) -> dict:
    """Phase 36 (b): ``train.main`` on grok at full width and 1 layer,
    batch 4 x 2048, remat full, Adafactor (the reference's recipe),
    GK_TRAIN_STEPS steps: finite losses, ``moe_lb`` and ``moe_z``, the
    launches, tokens/s after step 0 and, in those steps, the forward,
    backward and Adafactor on the host clock; the peak beside the
    parameters and gradients (48.7 GiB reckoned) and Adafactor's state.
    The final checkpoint is neither copied to the host nor written.  Then
    step 0's loss, ``moe_lb``, ``moe_z`` and every gradient leaf (its
    held part, :func:`_gk_held`) through the kernels against the plain
    versions on the card, f32, GK_GRAD_ROWS x 2048, within 2e-4 +
    2e-4|x|, and the routing choices that flip."""
    import dataclasses

    from repro_torch.core.planner import loss_and_grads
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.models.lm import Model, param_count
    from repro_torch.tree import flatten

    cfg = _grok_cfg(n_layers=1)
    fwd, upd, written, held = [], [], [], []
    real_adafactor = train.adafactor

    def timed_adafactor(*a, **kw):
        o = real_adafactor(*a, **kw)

        def init(params):
            st = o.init(params)
            held.append(sum(t.numel() * t.element_size()
                            for t in flatten(st)[1]))
            return st

        def apply(*aa, **kk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = o.apply(*aa, **kk)
            torch.cuda.synchronize()
            upd.append(time.perf_counter() - t0)
            return r
        return dataclasses.replace(o, init=init, apply=apply)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_grok_")
    train.adafactor = timed_adafactor
    try:
        with no_checkpoint_write(written):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kernels)
            with host_timed(torch, Model, "loss_fn", fwd):
                res = train.main(GK_TRAIN_ARGS + ["--ckpt-dir", tmp])
            counts = read_counts(kernels)
            peak = torch.cuda.max_memory_allocated()
    finally:
        train.adafactor = real_adafactor
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    n = param_count(Model(cfg, "meta").param_shapes())
    secs = res["step_seconds"]
    if not len(secs) == len(fwd) == len(upd) == GK_TRAIN_STEPS:
        raise AssertionError(f"grok train: {len(secs)} steps, {len(fwd)} "
                             f"forwards, {len(upd)} updates")
    f_ms = statistics.median(t for t, _ in fwd[1:]) * 1e3
    o_ms = statistics.median(upd[1:]) * 1e3
    b_ms = statistics.median(s - f - o for s, (f, _), o in
                             zip(secs[1:], fwd[1:], upd[1:])) * 1e3
    tok = TRAIN_BATCH * TRAIN_SEQ
    print(f"[grok] train, 1 layer, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"Adafactor: {n:,} parameters; losses {res['losses']}, moe_lb "
          f"{res['moe_lb']}, moe_z {res['moe_z']}; step seconds "
          f"{[round(x, 3) for x in secs]} "
          f"({tok / statistics.median(secs[1:]):.1f} tok/s after step 0); "
          f"after step 0, medians: forward {f_ms:.1f} ms, backward (the "
          f"recompute included) {b_ms:.1f} ms, Adafactor {o_ms:.1f} ms; "
          f"peak device memory {peak / 2**30:.2f} GiB beside parameters "
          f"and gradients {8 * n / 2**30:.2f} GiB (f32) and Adafactor's "
          f"state {held[0] / 2**30:.4f} GiB; final checkpoint at step "
          f"{written} (host copy and write skipped); launches {counts}",
          flush=True)
    vals = res["losses"] + res["moe_lb"] + res["moe_z"]
    if not all(math.isfinite(x) for x in vals) or min(res["moe_lb"]) <= 0:
        raise AssertionError(f"grok train: losses {res['losses']}, moe_lb "
                             f"{res['moe_lb']}, moe_z {res['moe_z']}")
    exp = train_expected(1, GK_TRAIN_STEPS, cfg.padded_vocab)
    if counts != exp:
        raise AssertionError(f"grok train: launches {counts}, want {exp}")

    # step 0 through the kernels, its held parts on the host, then the
    # plain versions
    model = Model(dataclasses.replace(cfg, dtype="float32"))
    cuts = _gk_cuts(model)
    params = model.init(0)
    batch = _first_batch(torch, cfg.vocab, GK_GRAD_ROWS)

    def step0(record):
        real = _route_by_micro(torch, record, {"mb": 0})
        try:
            loss, m, g = loss_and_grads(model, params, batch)
        finally:
            moe._route = real
        return loss, m, g

    rk, rp = {}, {}
    loss_k, m_k, g = step0(rk)
    want = {p: (_gk_held(cuts, p, x).cpu(), float(
        torch.linalg.vector_norm(x, float("inf"))))
        for p, x in zip(*flatten(g))}
    del g
    torch.cuda.empty_cache()
    with plain_on_card():
        loss_p, m_p, g = step0(rp)
    lim = GRAD_TOL[str(torch.float32)]
    worst = max(check_close(f"grok f32 gradient {p}",
                            _gk_held(cuts, p, x), want[p][0].cuda(),
                            torch.float32, lim)
                for p, x in zip(*flatten(g)))
    for k, a, b in (("loss", loss_k, loss_p),
                    ("moe_lb", m_k["moe_lb"], m_p["moe_lb"]),
                    ("moe_z", m_k["moe_z"], m_p["moe_z"])):
        check_close(f"grok f32 {k}", a, b, torch.float32, lim)
    flips = _keyed_flips(rk, rp)
    print(f"[grok] f32, 1 layer, step 0 at {GK_GRAD_ROWS} x {TRAIN_SEQ} "
          f"through the kernels against the plain versions: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f}, moe_lb "
          f"{float(m_k['moe_lb']):.6f} vs {float(m_p['moe_lb']):.6f}, moe_z "
          f"{float(m_k['moe_z']):.6f} vs {float(m_p['moe_z']):.6f}, every "
          f"gradient leaf (1/{GK_HELD} of the embed dim of the large ones) "
          f"within 2e-4 + 2e-4|x| (max |diff| {worst:.3e}); routing flips "
          f"{flips[0]} of {flips[1]}", flush=True)
    del params, g, want
    torch.cuda.empty_cache()
    return counts


def _gk_routes(torch, record: list):
    """Wrap ``moe._route`` so each call appends its expert ids (sorted, on
    the host) to ``record``, in call order: (c)'s steps update the router,
    so a call is known by its place, not by its weights."""
    from repro_torch.models import moe

    real = moe._route

    def route(params, x, cfg, split=None):
        out = real(params, x, cfg, split)
        record.append(out[2].detach().sort(-1).values.cpu())
        return out

    moe._route = route
    return real


def _gk_flips(got: list, want: list) -> list:
    """[tokens whose expert set differs, tokens] over two runs' routing
    calls in order (:func:`_gk_routes`)."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} routing calls against "
                             f"{len(want)}")
    return [sum(int((a != b).any(-1).sum()) for a, b in zip(got, want)),
            sum(a.numel() // a.shape[-1] for a in got)]


def _gk_tp_model(torch):
    from repro_torch.models.lm import Model
    return Model(_grok_cfg(n_layers=1, n_experts=GK_TP_EXPERTS,
                           dtype="float32"))


def _gk_saving(torch, o, d: str, cuts: dict):
    """``o`` whose step-0 ``apply`` first saves each gradient leaf's held
    part (:func:`_gk_held`) to ``d``."""
    import dataclasses

    from repro_torch.tree import flatten

    def apply(grads, state, params, step, **kw):
        if step == 0:
            _save_leaves(torch, d, ((p, _gk_held(cuts, p, x), float(
                torch.linalg.vector_norm(x, float("inf"))))
                for p, x in zip(*flatten(grads))))
        return o.apply(grads, state, params, step, **kw)

    return dataclasses.replace(o, apply=apply)


def _gk_tp_reference(torch, d: str) -> dict:
    """(c)'s unsharded run of one process: grok at 1 layer with
    GK_TP_EXPERTS experts in f32, GK_TP_STEPS Adafactor steps on
    GK_TP_ROWS x GK_TP_SEQ; its losses, routing, seconds and peak; the
    step-0 gradient to ``d/grads`` and the parameters after the last step
    to ``d/params`` (the held parts)."""
    from repro_torch.core.planner import compile_plan
    from repro_torch.models import moe
    from repro_torch.optim.optimizer import adafactor
    from repro_torch.tree import flatten

    model = _gk_tp_model(torch)
    cuts = _gk_cuts(model)
    plan = compile_plan(model, None)
    params = plan.init_params(0)
    o = _gk_saving(torch, adafactor(lr=PP_LR), os.path.join(d, "grads"),
                   cuts)
    state = plan.init_opt(o, params)
    step_fn = plan.train_step_fn(o)
    batch = _first_batch(torch, model.cfg.vocab, GK_TP_ROWS, GK_TP_SEQ)
    routes = []
    real = _gk_routes(torch, routes)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for i in range(GK_TP_STEPS):
            params, state, m = step_fn(params, state, batch, i)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
    finally:
        moe._route = real
    rec = {"losses": losses, "seconds": time.perf_counter() - t0,
           "peak": torch.cuda.max_memory_allocated()}
    _save_leaves(torch, os.path.join(d, "params"), (
        (p, _gk_held(cuts, p, x), float(torch.linalg.vector_norm(
            x, float("inf")))) for p, x in zip(*flatten(params))))
    torch.save(routes, os.path.join(d, "routes.pt"))
    del params, state
    torch.cuda.empty_cache()
    return rec


def _gk_tp_part(torch, dist, d: str, kernels, stats: dict) -> dict:
    """(c) in a rank: grok split×2 over model with GK_TP_EXPERTS experts
    (the rules prune ``experts`` and split every expert's d_ff: 16384 of
    32768 columns a rank; 24 q over 4 kv heads; 65536 vocab columns), its
    block of the draw made in turn, GK_TP_STEPS Adafactor steps through
    ``train_step_fn``: losses, seconds, peak, launches, routing flips,
    the step-0 gradient and the parameters after the last step against
    ``d``'s."""
    import dataclasses

    from repro_torch.core import sharding
    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.models import moe
    from repro_torch.optim.optimizer import adafactor
    from repro_torch.tree import flatten

    strat = StrategySpec(tp=2)
    plan = compile_plan(_gk_tp_model(torch), mesh_for_strategy(strat), strat)
    cuts = _gk_cuts(plan.model)
    params = _draw_in_turn(torch, dist, plan.model,
                           lambda whole: plan.shard(whole, plan.param_specs))
    drawn = torch.cuda.memory_allocated()
    n = sum(p.numel() for p in flatten(params)[1])
    specs = dict(zip(*flatten(plan.param_specs)))

    def cut(path, w):
        return sharding.shard_leaf(w, specs[path], plan.rules)

    gaps = {}
    real_af = adafactor(lr=PP_LR)

    def apply(grads, state, p, step, **kw):
        if step == 0:
            gaps.update(_leaf_gaps(torch, {
                q: _gk_held(cuts, q, x) for q, x in zip(*flatten(grads))},
                os.path.join(d, "grads"), cut))
        return real_af.apply(grads, state, p, step, **kw)

    o = dataclasses.replace(real_af, apply=apply)
    state = plan.init_opt(o, params)
    step_fn = plan.train_step_fn(o)
    batch = plan.batch_slice(_first_batch(torch, plan.model.cfg.vocab,
                                          GK_TP_ROWS, GK_TP_SEQ))
    routes = []
    real_route = _gk_routes(torch, routes)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    s0 = stats["s"]
    t0 = time.perf_counter()
    losses = []
    try:
        for i in range(GK_TP_STEPS):
            params, state, m = step_fn(params, state, batch, i)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
    finally:
        moe._route = real_route
    moe_p = params["blocks"]["p0"]["moe"]
    rec = {"losses": losses, "seconds": time.perf_counter() - t0,
           "gloo_s": stats["s"] - s0,
           "peak": torch.cuda.max_memory_allocated(), "held": 8 * n,
           "drawn": drawn, "counts": read_counts(kernels), "grads": gaps,
           "params": _leaf_gaps(torch, {
               q: _gk_held(cuts, q, x) for q, x in zip(*flatten(params))},
               os.path.join(d, "params"), cut),
           "w_in": list(moe_p["w_in"].shape),
           "w_out": list(moe_p["w_out"].shape),
           "vp": int(params["head"]["w"].shape[1]), "line": plan.split_line(),
           "flips": _gk_flips(routes, torch.load(
               os.path.join(d, "routes.pt")))}
    del params, state, step_fn
    torch.cuda.empty_cache()
    return rec


def _grok_rank(rank: int, store: str, out_dir: str, ref_dir: str) -> None:
    """One rank of phase 36 (c) on ``cuda:0`` over gloo (a world of two)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    kernels = kernel_wrappers()
    stats = {"s": 0.0, "n": 0}
    try:
        time_collectives(torch, dist, stats)
        t0 = time.perf_counter()
        out = _gk_tp_part(torch, dist, ref_dir, kernels, stats)
        dist.barrier()
        out["part_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def grok_split(torch) -> dict:
    """Phase 36 (c): the experts' d_ff split over model (grok's expert
    tensor parallelism) on two ranks on ``cuda:0`` over gloo, against one
    process's run here
    first (:func:`_gk_tp_reference`): the losses, each step-0 gradient
    leaf and each parameter after the last step within 1e-4 + 1e-4 x the
    leaf's max |x| (their held parts, :func:`_gk_held`), 0 routing flips,
    the launches of the rank's layer and head.  Returns the launches
    summed over the ranks."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_grok_tp_")
    t00 = time.perf_counter()
    try:
        want = _gk_tp_reference(torch, tmp)
        t0 = time.perf_counter()
        ranks = spawn_ranks(_grok_rank, tmp, timeout=600)
        t1 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[grok] (c) expert-TP split×2, {GK_TP_EXPERTS} experts (cut from "
          f"8: a 2-way axis divides 8), 1 layer, f32, {GK_TP_ROWS} x "
          f"{GK_TP_SEQ}, Adafactor: one process's losses {want['losses']} in "
          f"{want['seconds']:.3f} s, peak {want['peak'] / 2**30:.2f} GiB; "
          f"seconds: the reference {t0 - t00:.1f}, two ranks {t1 - t0:.1f}",
          flush=True)
    fails = []
    lim = TP_F32_LIMIT
    for rank, r in enumerate(ranks):
        print(f"[grok] (c) rank {rank}, w_in {r['w_in']}, w_out "
              f"{r['w_out']}, {r['vp']} vocab columns; {r['line']}: losses "
              f"{r['losses']}; {GK_TP_STEPS} steps {r['seconds']:.3f} s, gloo "
              f"{r['gloo_s']:.3f} s (ranks time-slice one card); "
              f"{r['drawn'] / 2**30:.2f} GiB after the draw, peak "
              f"{r['peak'] / 2**30:.2f} GiB beside {r['held'] / 2**30:.2f} "
              f"GiB of weights and gradients; routing flips "
              f"{r['flips'][0]} of {r['flips'][1]} tokens; launches "
              f"{r['counts']}", flush=True)
        for a, b in zip(r["losses"], want["losses"]):
            if not abs(a - b) <= lim + lim * abs(b):
                fails.append(f"rank {rank} losses {r['losses']} against "
                             f"{want['losses']}")
        if r["flips"][0]:
            fails.append(f"rank {rank}: {r['flips'][0]} routing flips")
        if r["w_in"][-1] * 2 != 32768 or r["w_in"][1] != GK_TP_EXPERTS:
            fails.append(f"rank {rank}: w_in {r['w_in']}, not the experts' "
                         f"d_ff split")
        exp = train_expected(1, GK_TP_STEPS, r["vp"], rows=GK_TP_ROWS,
                             seq=GK_TP_SEQ)
        if r["counts"] != exp:
            fails.append(f"rank {rank}: launches {r['counts']}, want {exp}")
    for what in ("grads", "params"):
        worst, leaves = 0.0, {}
        for r in ranks:
            for p, (diff, top) in r[what].items():
                leaves[p] = max(leaves.get(p, 0.0), diff / (lim + lim * top))
        worst_p = max(leaves, key=leaves.get)
        print(f"[grok] (c) {what}: worst share of 1e-4 + 1e-4 x the leaf's "
              f"max {leaves[worst_p]:.3f} ({worst_p}) over {len(leaves)} "
              f"leaves", flush=True)
        fails += [f"{what} {p}: share {v:.3f}" for p, v in leaves.items()
                  if not v <= 1]
    if fails:
        raise AssertionError("grok split: " + "; ".join(fails))
    return {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}


def grok(torch, kernels) -> dict:
    """Phase 36: grok-1-314b on one card: (a) served at GK_SERVE_LAYERS
    layers (:func:`grok_serve`), (b) trained at 1 layer with Adafactor
    (:func:`grok_train`), (c) the experts' d_ff split on two ranks
    (:func:`grok_split`); (d), Adafactor under ZeRO, runs in phase 24's
    ranks.  Returns each path's launches."""
    t0 = time.perf_counter()
    counts = {f"serve_grok_{k}": v for k, v in
              grok_serve(torch, kernels).items()}
    t1 = time.perf_counter()
    counts["train_grok"] = grok_train(torch, kernels)
    t2 = time.perf_counter()
    counts["train_grok_tp"] = grok_split(torch)
    print(f"[grok] seconds: serve {t1 - t0:.1f}, train {t2 - t1:.1f}, "
          f"split {time.perf_counter() - t2:.1f}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 37: the multimodal families, qwen2-vl-2b and seamless-m4t-medium
# ---------------------------------------------------------------------------

VLM_ARCH, ENCDEC_ARCH = "qwen2-vl-2b", "seamless-m4t-medium"
MM_TRAIN_STEPS = 3
#: (a) 8 requests of 256 + 32 tokens through 8 slots
MM_SERVE = ("--requests", "8", "--batch-slots", "8", "--prompt-len", "256",
            "--gen", "32", "--max-len", "512")
#: seamless's source frames a row, in training (its cross-attention at
#: Sq = 2047 against Sk = 1024) and in serving
MM_SRC = 1024
MM_SERVE_ROWS = 8
MM_PREFILLS = 3                 # (c) prefills timed: TTFT is their median
MM_GEN = 31                     # (c) greedy steps after BOS
#: (e) the two-tower pipeline: rows x target tokens over source frames a
#: row, in micro-batches, at 2 + 2 layers in f32
MM_PP_ROWS, MM_PP_SEQ, MM_PP_SRC, MM_PP_MICRO = 2, 1024, 512, 2


def _mm_cfg(arch: str, **kw):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **kw)


def _mm_small(arch: str, dtype: str = "float32"):
    """``arch`` at 2 layers (seamless 2 + 2), full width."""
    from repro_torch.models.lm import Model

    kw = (dict(n_layers=4, n_enc_layers=2, n_dec_layers=2)
          if arch == ENCDEC_ARCH else dict(n_layers=2))
    return Model(_mm_cfg(arch, dtype=dtype, **kw))


def _mm_batch(torch, cfg, rows: int, seq: int, src: int = MM_SRC) -> dict:
    """The training driver's first batch for ``cfg`` (its
    ``MultimodalPipeline``): the tokens and the patch embeddings, or
    ``src`` frames a row, on the card."""
    import numpy as np

    from repro_torch.data.pipeline import DataCfg, MultimodalPipeline
    data = MultimodalPipeline(
        DataCfg(global_batch=rows, seq_len=seq, vocab=cfg.vocab, seed=0),
        modality=cfg.family, d_model=cfg.d_model,
        frontend_len=cfg.frontend_len if cfg.family == "vlm" else 0,
        src_len=src if cfg.family == "encdec" else 0, host_id=0, n_hosts=1)
    return {k: torch.as_tensor(np.asarray(v)).cuda()
            for k, v in data.next_batch().items()}


def _attn_layers(cfg) -> int:
    """The attention layers one pass runs: seamless's encoder's, and its
    decoder's twice (self and cross)."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_dec_layers
    return cfg.n_layers


def mm_train(torch, kernels, arch: str, extra: list) -> dict:
    """Phase 37 (b), (c): ``train.main`` on ``arch`` at full width and
    depth, batch 4 x 2048 (seamless's targets over MM_SRC frames a row),
    remat full, AdamW, MM_TRAIN_STEPS steps (:func:`timed_train`): finite
    losses, tokens/s after step 0, the forward, backward and AdamW, the
    peak beside the parameters, gradients and moments, and the launches:
    the flash forward twice per attention (the recompute), dq and dk/dv
    once, the loss head once a step."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Model, param_count

    cfg = get_config(arch)
    run = timed_train(torch, kernels, ["--arch", arch, "--batch",
                                       str(TRAIN_BATCH), "--seq",
                                       str(TRAIN_SEQ)] + extra,
                      MM_TRAIN_STEPS)
    res, counts = run["res"], run["counts"]
    n = param_count(Model(cfg, "meta").param_shapes())
    secs = res["step_seconds"]
    tok = TRAIN_BATCH * TRAIN_SEQ
    print(f"[multimodal] {arch} train, {_attn_layers(cfg)} attention "
          f"layers, batch {TRAIN_BATCH} x {TRAIN_SEQ} {' '.join(extra)}: "
          f"{n:,} parameters; losses {res['losses']}; step seconds "
          f"{[round(x, 3) for x in secs]} "
          f"({tok / statistics.median(secs[1:]):.1f} target tok/s after "
          f"step 0); after step 0, medians: forward "
          f"{run['fwd_ms']:.1f} ms, backward (the recompute included) "
          f"{run['bwd_ms']:.1f} ms, AdamW {run['opt_ms']:.1f} ms; peak "
          f"device memory {run['peak'] / 2**30:.2f} GiB beside parameters, "
          f"gradients and AdamW moments {16 * n / 2**30:.2f} GiB; launches "
          f"{counts}", flush=True)
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"{arch} train: losses {res['losses']}")
    exp = train_expected(_attn_layers(cfg), MM_TRAIN_STEPS, cfg.padded_vocab)
    if counts != exp:
        raise AssertionError(f"{arch} train: launches {counts}, want {exp}")
    return counts


def mm_serve_encdec(torch, kernels) -> dict:
    """Phase 37 (c): seamless-m4t-medium at full width and depth in bf16,
    served through ``Model.prefill({"frames"})`` and ``serve_step`` (the
    reference's way: its Server does not serve an encoder–decoder):
    MM_SERVE_ROWS rows of MM_SRC frames prefilled MM_PREFILLS times, then
    MM_GEN greedy steps from the last.  TTFT (the median prefill: the
    encoder, the decode state and the BOS step), TPOT (the median step),
    the peak beside the weights and the decode state, on the host clock,
    synced; the launches: the flash forward once per encoder layer and
    prefill, and nothing in the decode steps (the decoder's self and
    cross-attention decode in plain PyTorch, as the reference's)."""
    from repro_torch.models.lm import Model, param_count
    from repro_torch.tree import flatten

    model = Model(_mm_cfg(ENCDEC_ARCH))
    cfg = model.cfg
    params = model.serving_params(model.init(0))
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(37)
    frames = torch.randn((MM_SERVE_ROWS, MM_SRC, cfg.d_model), generator=gen,
                         device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    steps, toks, ttfts = [], [], []
    with torch.no_grad():
        for _ in range(MM_PREFILLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, st = model.prefill(params, {"frames": frames},
                                       gen_budget=MM_GEN + 1)
            tok = logits[:, :cfg.vocab].argmax(-1)
            torch.cuda.synchronize()
            ttfts.append(time.perf_counter() - t0)
        at_prefill = read_counts(kernels)
        toks.append(tok)
        for _ in range(MM_GEN):
            t0 = time.perf_counter()
            logits, st = model.serve_step(params, tok, st)
            tok = logits[:, :cfg.vocab].argmax(-1)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            toks.append(tok)
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    state = sum(t.numel() * t.element_size() for t in flatten(st)[1])
    n = param_count(model.param_shapes())
    out = torch.stack(toks, 1)
    finite = bool(torch.isfinite(logits).all())
    print(f"[multimodal] {ENCDEC_ARCH} serve (prefill from frames, then "
          f"serve_step): {MM_SERVE_ROWS} rows of {MM_SRC} frames, "
          f"{MM_GEN} greedy steps after BOS; TTFT "
          f"{statistics.median(ttfts) * 1e3:.2f} ms (median of "
          f"{MM_PREFILLS} prefills, the first {ttfts[0] * 1e3:.2f}: the "
          f"encoder, the decode state's cross K/V and the BOS step), TPOT "
          f"{statistics.median(steps) * 1e3:.2f} ms (median step at "
          f"{MM_SERVE_ROWS} rows), host clock, synced; {n:,} parameters "
          f"({n * 2 / 2**30:.2f} GiB in bf16), decode state "
          f"{state / 2**30:.3f} GiB, peak device memory "
          f"{peak / 2**30:.2f} GiB; first row's tokens "
          f"{out[0, :8].tolist()}…; launches {counts}", flush=True)
    fails = []
    if not finite or not bool(((out >= 0) & (out < cfg.vocab)).all()):
        fails.append("non-finite logits or tokens outside the vocab")
    want = cfg.n_enc_layers * MM_PREFILLS
    if counts["flash_fwd"] != want or counts != at_prefill \
            or sum(counts.values()) != want:
        fails.append(f"launches {counts}, want {want} flash forwards at "
                     f"the prefills and none after")
    del params, st, frames
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{ENCDEC_ARCH} serve: " + "; ".join(fails))
    return counts


def _encdec_forced(torch, model, params) -> "torch.Tensor":
    """seamless's teacher-forced logits: 2 rows of MM_SRC frames
    prefilled (BOS), then TF_STEPS fixed tokens, each step's logits, as
    one (2 + 2·TF_STEPS, Vp) f32 host tensor."""
    import numpy as np

    rng = np.random.default_rng(37)
    frames = torch.as_tensor(rng.standard_normal(
        (2, MM_SRC, model.cfg.d_model)).astype(np.float32)).cuda()
    forced = torch.as_tensor(rng.integers(0, model.cfg.vocab,
                                          (TF_STEPS, 2))).cuda()
    rows = []
    with torch.no_grad():
        logits, st = model.prefill(params, {"frames": frames},
                                   gen_budget=TF_STEPS + 1)
        rows.append(logits.float().cpu())
        for t in forced:
            logits, st = model.serve_step(params, t, st)
            rows.append(logits.float().cpu())
    return torch.cat(rows)


def _forced(torch, model, params):
    if model.cfg.family == "encdec":
        return _encdec_forced(torch, model, params)
    from repro_torch.core.planner import compile_plan
    return teacher_forced(torch, model, compile_plan(model, None), params,
                          "paged")


def mm_agreement(torch, arch: str) -> None:
    """Phase 37 (d): the kernels against their plain versions on the card
    (:func:`plain_on_card`), ``arch`` at 2 layers (seamless 2 + 2), full
    width, f32: teacher-forced logits (qwen2-vl: phase 26's two prompts
    of 500 and TF_STEPS forced steps through the paged Server; seamless:
    :func:`_encdec_forced`) and step 0's loss and every gradient leaf at
    4 x 2048 (qwen2-vl with its patch embeddings, seamless over MM_SRC
    frames), each within 1e-4 + 1e-4|x|.  The teacher-forced logits in
    bf16, kernels against plain, are printed beside bf16's own error (the
    same weights in f32), not held."""
    from repro_torch.core.planner import loss_and_grads
    from repro_torch.tree import flatten

    lim = TP_F32_LIMIT
    m32 = _mm_small(arch)
    p32 = m32.init(0)
    tf = {"f32": _forced(torch, m32, p32)}
    with plain_on_card():
        tf["f32_plain"] = _forced(torch, m32, p32)
    m16 = _mm_small(arch, "bfloat16")
    p16 = m16.serving_params(p32)
    tf["bf16"] = _forced(torch, m16, p16)
    with plain_on_card():
        tf["bf16_plain"] = _forced(torch, m16, p16)
    del p16
    g32 = tf_gap(tf["f32"], tf["f32_plain"], lim)
    own = tf_gap(tf["bf16"], tf["f32"], TF_TOL["bfloat16"])
    pair = tf_gap(tf["bf16"], tf["bf16_plain"], TF_TOL["bfloat16"])
    batch = _mm_batch(torch, m32.cfg, TRAIN_BATCH, TRAIN_SEQ)
    loss_k, _, g_k = loss_and_grads(m32, p32, batch)
    with plain_on_card():
        loss_p, _, g_p = loss_and_grads(m32, p32, batch)
    fails = []
    worst = 0.0
    for (k, a), b in zip(zip(*flatten(g_k)), flatten(g_p)[1]):
        try:
            worst = max(worst, check_close(f"{arch} gradient {k}", a, b,
                                           torch.float32, lim))
        except AssertionError as e:
            fails.append(str(e))
    try:
        check_close(f"{arch} loss", loss_k, loss_p, torch.float32, lim)
    except AssertionError as e:
        fails.append(str(e))
    print(f"[multimodal] {arch} at 2 layers, f32, through the kernels "
          f"against the plain versions: teacher-forced max |diff| "
          f"{g32['max_abs']:.3e}, worst share of 1e-4 + 1e-4|x| "
          f"{g32['worst']:.3f}; step 0 at {TRAIN_BATCH} x {TRAIN_SEQ}: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f}, every gradient leaf "
          f"within 1e-4 + 1e-4|x| (max |diff| {worst:.3e}); bf16 (printed, "
          f"not held): kernels against plain max |diff| "
          f"{pair['max_abs']:.3e}, worst share of 0.02 + 0.02|x| "
          f"{pair['worst']:.3f}, beside bf16's own error (the kernels' bf16 "
          f"against f32) {own['max_abs']:.3e}, worst share "
          f"{own['worst']:.3f}", flush=True)
    if not g32["worst"] <= 1:
        fails.append(f"f32 teacher-forced logits: worst share "
                     f"{g32['worst']:.3f}")
    if not all(torch.isfinite(t).all() for t in tf.values()):
        fails.append("non-finite teacher-forced logits")
    del p32, g_k, g_p, tf
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{arch} agreement: " + "; ".join(fails))


def _mm_pp_part(torch, dist, d: str, kernels, stats: dict) -> dict:
    """(e) in a rank: seamless at 2 + 2 layers, f32, through the two-tower
    engine (``make_encdec_pipeline_loss``) at pipeline×2 over
    MM_PP_MICRO micro-batches, the whole tree drawn in turn on each rank
    (stage-replicated): the loss, seconds, gloo seconds, peak, launches
    and every gradient leaf against ``d``'s."""
    import importlib

    from repro_torch.core.cost_model import StrategySpec
    from repro_torch.core.planner import compile_plan, mesh_for_strategy
    from repro_torch.tree import flatten

    pipe = importlib.import_module("repro_torch.core.pipeline")
    model = _mm_small(ENCDEC_ARCH)
    strat = StrategySpec(pp=2, micro_batches=MM_PP_MICRO)
    plan = compile_plan(model, mesh_for_strategy(strat), strat)
    params = _draw_in_turn(torch, dist, model, lambda whole: whole)
    n = sum(p.numel() for p in flatten(params)[1])
    batch = _mm_batch(torch, model.cfg, MM_PP_ROWS, MM_PP_SEQ, MM_PP_SRC)
    fn = pipe.make_encdec_pipeline_loss(model, plan.rules,
                                        micro_batches=MM_PP_MICRO)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    s0 = stats["s"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = fn(params, batch["frames"], batch["tokens"])
    torch.cuda.synchronize()
    rec = {"loss": float(loss), "seconds": time.perf_counter() - t0,
           "gloo_s": stats["s"] - s0,
           "peak": torch.cuda.max_memory_allocated(), "held": 8 * n,
           "counts": read_counts(kernels),
           "stage": plan.mesh.get_local_rank("stage"),
           "line": plan.split_line(),
           "grads": _leaf_gaps(torch, dict(zip(*flatten(grads))), d)}
    del params, grads
    torch.cuda.empty_cache()
    return rec


def _mm_pp_rank(rank: int, store: str, out_dir: str, ref_dir: str) -> None:
    """One rank of phase 37 (e) on ``cuda:0`` over gloo (a world of
    two)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    kernels = kernel_wrappers()
    stats = {"s": 0.0, "n": 0}
    try:
        time_collectives(torch, dist, stats)
        out = _mm_pp_part(torch, dist, ref_dir, kernels, stats)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mm_pipeline(torch) -> dict:
    """Phase 37 (e): seamless's two-tower pipeline×2 on two ranks on
    ``cuda:0`` over gloo (the encoder on stage 0, the decoder and the loss
    on stage 1), against one process's ``loss_and_grads`` here first on
    the whole batch: the loss within 1e-4 + 1e-4|x| and every step-0
    gradient leaf within 1e-4 + 1e-4 x the leaf's max on both ranks (the
    gradients are summed over the stages), each rank's launches (its
    tower's attention, the loss head on stage 1).  Returns the launches
    summed over the ranks."""
    from repro_torch.core.planner import loss_and_grads
    from repro_torch.kernels.xent import xent
    from repro_torch.tree import flatten

    tmp = tempfile.mkdtemp(prefix="chip_smoke_encdec_pp_")
    t00 = time.perf_counter()
    try:
        model = _mm_small(ENCDEC_ARCH)
        params = model.init(0)
        batch = _mm_batch(torch, model.cfg, MM_PP_ROWS, MM_PP_SEQ, MM_PP_SRC)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        one = {"loss": float(loss), "seconds": time.perf_counter() - t0,
               "peak": torch.cuda.max_memory_allocated()}
        _save_leaves(torch, tmp, zip(*flatten(grads)))
        del params, grads, batch
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = spawn_ranks(_mm_pp_rank, tmp, timeout=600)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = model.cfg
    print(f"[multimodal] (e) {ENCDEC_ARCH} two-tower pipeline×2, 2 + 2 "
          f"layers, f32, {MM_PP_ROWS} x {MM_PP_SEQ} target tokens over "
          f"{MM_PP_SRC} frames a row, {MM_PP_MICRO} micro-batches: one "
          f"process's step-0 loss {one['loss']:.6f} in "
          f"{one['seconds']:.3f} s, peak {one['peak'] / 2**30:.2f} GiB; "
          f"seconds: the reference {t1 - t00:.1f}, two ranks {t2 - t1:.1f}",
          flush=True)
    lim = TP_F32_LIMIT
    M, mb = MM_PP_MICRO, MM_PP_ROWS // MM_PP_MICRO
    T = mb * (MM_PP_SEQ - 1)
    chunks = -(-cfg.padded_vocab // xent.bwd_chunk(T, cfg.padded_vocab))
    fails = []
    for r in ranks:
        s = r["stage"]
        attn = cfg.n_enc_layers if s == 0 else 2 * cfg.n_dec_layers
        exp = {k: 0 for k in r["counts"]}
        exp.update(flash_fwd=2 * attn * M, flash_bwd_dq=attn * M,
                   flash_bwd_dkv=attn * M,
                   xent_fwd=M if s == 1 else 0,
                   xent_bwd=M * chunks if s == 1 else 0)
        shares = {p: diff / (lim + lim * top)
                  for p, (diff, top) in r["grads"].items()}
        worst = max(shares, key=shares.get)
        print(f"[multimodal] (e) stage {s}: {r['line']}; loss "
              f"{r['loss']:.6f}; step {r['seconds']:.3f} s, gloo "
              f"{r['gloo_s']:.3f} s (the gradients summed over the stages; "
              f"ranks time-slice one card); peak {r['peak'] / 2**30:.2f} GiB "
              f"beside {r['held'] / 2**30:.2f} GiB of weights and "
              f"gradients; step-0 gradients: worst share of 1e-4 + 1e-4 x "
              f"the leaf's max {shares[worst]:.3f} ({worst}) over "
              f"{len(shares)} leaves; launches {r['counts']}", flush=True)
        if not abs(r["loss"] - one["loss"]) <= lim + lim * abs(one["loss"]):
            fails.append(f"stage {s} loss {r['loss']} against "
                         f"{one['loss']}")
        fails += [f"stage {s} {p}: share {v:.3f}" for p, v in shares.items()
                  if not v <= 1]
        if r["counts"] != exp:
            fails.append(f"stage {s}: launches {r['counts']}, want {exp}")
    if sorted(r["stage"] for r in ranks) != [0, 1]:
        fails.append(f"stages {[r['stage'] for r in ranks]}")
    if fails:
        raise AssertionError("encdec pipeline: " + "; ".join(fails))
    return {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}


def multimodal(torch, kernels) -> dict:
    """Phase 37: the multimodal families at full width on one card:
    (a) qwen2-vl-2b served at full depth, paged and dense
    (:func:`dense_rest_serve`); (b) trained at full depth
    (:func:`mm_train`); (c) seamless-m4t-medium served from frames and
    trained at full depth (:func:`mm_serve_encdec`, :func:`mm_train`);
    (d) both held against the plain versions at 2 layers
    (:func:`mm_agreement`); (e) seamless's two-tower pipeline on two
    ranks (:func:`mm_pipeline`).  Returns each path's launches."""
    t = [time.perf_counter()]
    served = dense_rest_serve(torch, kernels, VLM_ARCH, tag="multimodal",
                              serve_args=MM_SERVE)
    counts = {"serve_qwen2vl": served["paged"],
              "serve_qwen2vl_dense": served["dense"]}
    t.append(time.perf_counter())
    counts["train_qwen2vl"] = mm_train(torch, kernels, VLM_ARCH, [])
    t.append(time.perf_counter())
    counts["serve_seamless"] = mm_serve_encdec(torch, kernels)
    counts["train_seamless"] = mm_train(torch, kernels, ENCDEC_ARCH,
                                        ["--src-seq", str(MM_SRC)])
    t.append(time.perf_counter())
    for arch in (VLM_ARCH, ENCDEC_ARCH):
        mm_agreement(torch, arch)
    t.append(time.perf_counter())
    counts["train_seamless_pp"] = mm_pipeline(torch)
    t.append(time.perf_counter())
    parts = ("qwen2-vl serve", "qwen2-vl train", "seamless serve and train",
             "agreement", "pipeline")
    print("[multimodal] seconds: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(parts, t, t[1:])), flush=True)
    return counts


#: phase 38: Whale's elastic runtime at tinyllama's full width through
#: ``train --hosts`` on pooled ranks over gloo (the depth and steps cut)
EL_BATCH, EL_SEQ = 2, 1024
EL_BASE = ["--arch", ARCH, "--batch", str(EL_BATCH), "--seq", str(EL_SEQ),
           "--log-every", "1", "--seed", "0"]
#: scenario: (ranks, steps, depth and dtype, the elastic flags)
EL_RUNS = {
    "evict": (2, 12, "n_layers=2,dtype=float32",
              ["--hosts", "2", "--inject-slow", "1:4:5", "--inject-crash",
               "9", "--straggler-warmup", "2", "--patience", "2",
               "--save-every", "4"]),
    "spot": (3, 12, "n_layers=1",
             ["--hosts", "2", "--devices-per-host", "1", "--inject-preempt",
              "1:4:2", "--inject-join", "2:8:1", "--max-rebalances", "4",
              "--save-every", "4"]),
    "lost": (2, 8, "n_layers=1",
             ["--hosts", "2", "--inject-preempt", "1:6:0", "--save-every",
              "4"]),
    "drift": (2, 12, "n_layers=1",
              ["--hosts", "2", "--calibrate", "--inject-drift", "1:1:101:3",
               "--drift-skew", "0.08", "--drift-patience", "2",
               "--straggler-warmup", "5", "--save-every", "100"]),
}
#: each scenario's events (kind, step, host or hosts): the reference's
#: sources, state machine and policy replayed over the injector's clock
#: for the same scenario (tests/test_torch_elastic.py, CASES "evict",
#: "spot", "lost", "drift")
EL_EVENTS = {
    "evict": [["flag", 5, 1], ["evict", 6, [1]], ["rebalance", 6, None]],
    "spot": [["preempt_warn", 4, 1], ["evict", 5, [1]],
             ["rebalance", 5, None], ["join", 9, [2]],
             ["rebalance", 9, None]],
    "lost": [["preempt_warn", 6, 1], ["host_lost", 6, 1], ["evict", 7, [1]],
             ["rebalance", 4, None]],
    "drift": [["drift", 11, None], ["recalibrate", 11, None]],
}
#: (b)'s bf16 losses against an uninterrupted run: within this many times
#: bf16's own error (the uninterrupted bf16 run against f32), as phase 26
#: holds bf16
EL_BF16_PAIR = 2.0


def _el_argv(name: str, ckpt: str) -> list:
    _, steps, depth, flags = EL_RUNS[name]
    return EL_BASE + ["--steps", str(steps), "--overrides", depth,
                      "--ckpt-dir", ckpt] + flags


def _elastic_rank(rank: int, store: str, out_dir: str, name: str,
                  nprocs: int, ckpt: str) -> None:
    """One launch rank of phase 38 on ``cuda:0`` over gloo: ``train.main``
    with ``--hosts`` as under torchrun, recording each executed step (its
    loss and synced seconds), the consumed stream, the steps saved, each
    write's bytes and seconds (the final save's write skipped), and after
    every change the restored state on the new rank 0 against the
    checkpoint it read, bit for bit; the launches and the peak."""
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import checkpoint
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.launch.mesh import leave_group
    from repro_torch.runtime import controller
    from repro_torch.tree import flatten

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, nprocs),
                            rank=rank, world_size=nprocs)
    n_steps = EL_RUNS[name][1]
    kernels = kernel_wrappers()
    rec = {"rank": rank, "steps": [], "seen": [], "saves": [], "writes": [],
           "restored": [], "gloo_s": 0.0}
    stats = {"s": 0.0, "n": 0}
    Ctl, Ckpt = controller.ClusterController, checkpoint.CheckpointManager
    saved = [(pipeline.TokenPipeline, "next_batch"),
             (Ctl, "_build_step_fn"), (Ctl, "_replan"), (Ckpt, "save"),
             (Ckpt, "save_async"), (Ckpt, "_write")]
    real = {n: getattr(o, n) for o, n in saved}

    def next_batch(self):
        b = real["next_batch"](self)
        rec["seen"].append(b["tokens"].tobytes().hex())
        return b

    def build(self, plan):
        fn = real["_build_step_fn"](self, plan)

        def one(i, st):
            s0 = stats["s"]
            t0 = time.perf_counter()
            out = fn(i, st)
            rec["steps"].append([i, self.losses[-1],
                                 time.perf_counter() - t0, stats["s"] - s0])
            return out
        return one

    def replan(self, kind, hardware):
        out = real["_replan"](self, kind, hardware)
        if out is not None:
            step, plan, state = out
            whole = (plan.gather_state(state, self.optimizer)
                     if plan.sharded else state)
            if dist.get_rank() == 0:
                t0 = time.perf_counter()
                files, _ = self.ckpt.restore(step, whole)
                same = all(torch.equal(a, b) for a, b in
                           zip(flatten(whole)[1], flatten(files)[1]))
                rec["restored"].append([step, len(flatten(whole)[1]), same,
                                        time.perf_counter() - t0])
        return out

    def save(self, step, tree, *, extra=None):
        rec["saves"].append(step)
        if step < n_steps:
            return real["save"](self, step, tree, extra=extra)
        self.wait()                     # the final save: collective, unwritten
        self._gathered(tree)
        self._sync()
        return None

    def save_async(self, step, tree, *, extra=None):
        rec["saves"].append(step)
        if step < n_steps:
            return real["save_async"](self, step, tree, extra=extra)
        self.wait()                     # at the last step: unwritten
        self._gathered(tree)
        return None

    def write(self, step, paths, leaves, extra):
        t0 = time.perf_counter()
        out = real["_write"](self, step, paths, leaves, extra)
        rec["writes"].append([step, sum(a.nbytes for a in leaves),
                              time.perf_counter() - t0])
        return out

    for (o, n), fn in zip(saved, (next_batch, build, replan, save,
                                  save_async, write)):
        setattr(o, n, fn)
    time_collectives(torch, dist, stats)
    try:
        reset_counts(kernels)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train.main(_el_argv(name, ckpt))
        rec["seconds"] = time.perf_counter() - t0
        rec["counts"] = read_counts(kernels)
        rec["peak"] = torch.cuda.max_memory_allocated()
        rec["gloo_s"] = stats["s"]
        rec.update(final_step=out["final_step"], phase=out["phase"],
                   events=out["events"], losses=out["losses"],
                   profile={g: {k: p[k] for k in ("observations", "rates",
                                                  "prior_rates",
                                                  "error_before",
                                                  "error_after")}
                            for g, p in out.get("profile", {}).items()})
    finally:
        for (o, n) in saved:
            setattr(o, n, real[n])
        leave_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _el_uninterrupted(torch, name: str, depth: str) -> list:
    """The losses of one process over ``name``'s steps at ``depth`` (no
    ``--hosts``: the plain driver, the same weights and stream), its final
    checkpoint unwritten."""
    from repro_torch.launch import train

    steps = EL_RUNS[name][1]
    d = tempfile.mkdtemp(prefix="chip_smoke_el_ref_")
    try:
        with no_checkpoint_write([]):
            out = train.main(EL_BASE + ["--steps", str(steps), "--overrides",
                                        depth, "--save-every", "1000",
                                        "--ckpt-dir", d])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    return out["losses"]


def _el_stream(n: int) -> list:
    """A fresh ``TokenPipeline``'s first ``n`` batches as hex."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataCfg, TokenPipeline

    p = TokenPipeline(DataCfg(global_batch=EL_BATCH, seq_len=EL_SEQ,
                              vocab=get_config(ARCH).vocab, seed=0),
                      host_id=0, n_hosts=1)
    return [p.next_batch()["tokens"].tobytes().hex() for _ in range(n)]


def _el_run(torch, name: str) -> list:
    nprocs = EL_RUNS[name][0]
    ckpt = tempfile.mkdtemp(prefix=f"chip_smoke_el_{name}_")
    try:
        return spawn_ranks(_elastic_rank, name, nprocs, ckpt, timeout=600,
                           nprocs=nprocs)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _el_report(name: str, ranks: list, fails: list) -> dict:
    """Print a scenario's readings and hold its common gates: the events
    (kinds, steps, hosts) against the reference's replay, DONE at the
    last step on every rank, every restore bit for bit, the same loss
    history on every rank, and launches of the training kernels.  Returns
    the launches summed over the ranks."""
    r0 = ranks[0]
    got = [[e["kind"], e.get("step"), e.get("host", e.get("hosts"))]
           for e in r0["events"]]
    steps = EL_RUNS[name][1]
    print(f"[elastic] ({name}) events {got}; phase {r0['phase']} at step "
          f"{r0['final_step']}", flush=True)
    if got != EL_EVENTS[name]:
        fails.append(f"{name}: events {got}, want {EL_EVENTS[name]}")
    for r in ranks:
        if (r["phase"], r["final_step"]) != ("DONE", steps):
            fails.append(f"{name} rank {r['rank']}: {r['phase']} at "
                         f"{r['final_step']}")
        if r["losses"] != r0["losses"]:
            fails.append(f"{name} rank {r['rank']}: another loss history")
    restores = [x for r in ranks for x in r["restored"]]
    changes = [e for e in r0["events"]
               if e["kind"] in ("rebalance", "recalibrate")]
    if sorted(x[0] for x in restores) != sorted(e["step"] for e in changes) \
            or not all(x[2] for x in restores):
        fails.append(f"{name}: restores {restores} for changes at "
                     f"{[e['step'] for e in changes]}")
    for e in changes:
        print(f"[elastic] ({name}) {e['kind']} at step {e['step']} onto "
              f"{e['strategy']}: downtime {e['downtime_s']:.3f} s = group "
              f"re-formed {e['regroup_s']:.3f} + search, compile and "
              f"restore {e['restore_s']:.3f}; before it the drain "
              f"{e['drain_s']:.3f} s (the accepted event to the segment's "
              f"end, its final save included where it saved)", flush=True)
    for x in restores:
        print(f"[elastic] ({name}) restored step {x[0]}: {x[1]} leaves "
              f"equal to the checkpoint bit for bit: {x[2]} (read back in "
              f"{x[3]:.2f} s)", flush=True)
    writes = [w for r in ranks for w in r["writes"]]
    for w in writes:
        print(f"[elastic] ({name}) checkpoint step {w[0]}: "
              f"{w[1] / 1e9:.3f} GB written in {w[2]:.2f} s "
              f"({w[1] / 1e9 / max(w[2], 1e-9):.2f} GB/s)", flush=True)
    # tokens/s of each plan: the steps between changes, each segment's
    # first step left out
    bounds = [e["step"] for e in changes]
    segs, cur, last = [], [], None
    for i, loss, dt, gloo in r0["steps"]:
        if last is not None and (i != last + 1 or i in bounds):
            segs.append(cur)
            cur = []
        cur.append((dt, gloo))
        last = i
    segs.append(cur)
    tok = EL_BATCH * EL_SEQ
    print(f"[elastic] ({name}) launch rank 0, each plan's steps after its "
          f"first: " + "; ".join(
              f"median {statistics.median(d for d, _ in s[1:]):.3f} s "
              f"({tok / statistics.median(d for d, _ in s[1:]):,.1f} "
              f"tokens/s, gloo {statistics.median(g for _, g in s[1:]):.3f}"
              f" s)" for s in segs if len(s) > 1), flush=True)
    print(f"[elastic] ({name}) peaks a rank (GiB) "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks]}; seconds in "
          f"main {[round(r['seconds'], 1) for r in ranks]}", flush=True)
    counts = {k: sum(r["counts"][k] for r in ranks) for k in r0["counts"]}
    print(f"[elastic] ({name}) launches over the ranks {counts}",
          flush=True)
    trained = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
               "xent_bwd")
    if not all(counts[k] > 0 for k in trained) or any(
            counts[k] for k in counts if k not in trained):
        fails.append(f"{name}: launches {counts}")
    return counts


def elastic(torch, kernels) -> dict:
    """Phase 38: Whale's elastic runtime at tinyllama's full width (2048
    wide, 32 q over 4 kv heads of 64, d_ff 5632, vocab 32000; random
    weights from seed 0, AdamW) through ``train --hosts`` on pooled ranks
    over gloo, 2 x 1024 a step, each plan on a generation of the process
    group of its own: (a) a straggler evicted with a crash retry, 2
    layers f32, 2 hosts of 1 rank; (b) a spot reclaim drained and the
    capacity regrown, 1 layer bf16, 2 hosts and a spare rank (2 → 1 → 2
    ranks over three generations); (c) a missed deadline, the lost steps
    replayed from the last committed checkpoint; (d) a drift-triggered
    recalibration.  Gates: each scenario's events against the
    reference's replay, every restore bit for bit, the stream byte for
    byte against a fresh ``TokenPipeline`` (replays where they belong),
    (a)'s final loss within 1e-4 + 1e-4|x| of one process's 12 steps,
    (b)'s losses within twice bf16's own error of one process's, (c) no
    save at the abort, (d) a recalibration and no eviction.  Returns the
    launches of each path summed over its ranks."""
    t = [time.perf_counter()]
    fails, counts = [], {}
    want = _el_stream(max(r[1] for r in EL_RUNS.values()))
    ref_a = _el_uninterrupted(torch, "evict", EL_RUNS["evict"][2])
    ref_b = _el_uninterrupted(torch, "spot", EL_RUNS["spot"][2])
    ref_b32 = _el_uninterrupted(torch, "spot", "n_layers=1,dtype=float32")
    t.append(time.perf_counter())
    for name in EL_RUNS:
        ranks = _el_run(torch, name)
        counts[f"train_elastic_{name}"] = _el_report(name, ranks, fails)
        r0 = ranks[0]
        done = [s for s, *_ in r0["steps"]]
        if name == "evict":
            x, y = r0["losses"][-1], ref_a[-1]
            print(f"[elastic] (evict) final loss {x:.6f} against one "
                  f"process's 12 steps {y:.6f} (gap {abs(x - y):.3g}, "
                  f"limit {TP_F32_LIMIT * (1 + abs(y)):.3g}); the crash at "
                  f"step 9 retried: steps run {done}", flush=True)
            if not abs(x - y) <= TP_F32_LIMIT * (1 + abs(y)):
                fails.append(f"evict: final loss {x} against {y}")
            if r0["seen"] != want[:12]:
                fails.append("evict: the stream is not a fresh pipeline's")
        elif name == "spot":
            own = max(abs(a - b) for a, b in zip(ref_b, ref_b32))
            gap = max(abs(a - ref_b[s]) for s, a, *_ in r0["steps"])
            print(f"[elastic] (spot) bf16 losses {[round(v, 5) for v in r0['losses']]} "
                  f"beside one process's {[round(v, 5) for v in ref_b]}: "
                  f"worst gap {gap:.4g} against bf16's own error "
                  f"{own:.4g} (one process's bf16 against its f32; limit "
                  f"{EL_BF16_PAIR} x)", flush=True)
            if not gap <= EL_BF16_PAIR * own:
                fails.append(f"spot: bf16 gap {gap} against {own}")
            if r0["seen"] != want[:12] or done != list(range(12)):
                fails.append(f"spot: stream or steps {done}")
            spare = next(r for r in ranks if r["rank"] == 2)
            print(f"[elastic] (spot) launch rank 2 (the spare) ran "
                  f"{len(spare['steps'])} steps: first-fit gave the joining "
                  f"host the evicted host's rank 1", flush=True)
        elif name == "lost":
            lost = EL_EVENTS["lost"][1][1]
            back = EL_EVENTS["lost"][3][1]
            n = EL_RUNS["lost"][1]
            saved = sorted({s for r in ranks for s in r["saves"]})
            print(f"[elastic] (lost) steps run {done}; saves {saved}",
                  flush=True)
            if done != list(range(lost + 1)) + list(range(back, n)):
                fails.append(f"lost: steps run {done}")
            if lost + 1 in saved:
                fails.append(f"lost: a save at the abort ({saved})")
            if r0["seen"] != want[:lost + 1] + want[back:n]:
                fails.append("lost: the stream is not exactly once")
        else:
            kinds = [e["kind"] for e in r0["events"]]
            for g, p in r0["profile"].items():
                print(f"[elastic] (drift) {g}: {p['observations']} "
                      f"observations; fitted rates {p['rates']} against the "
                      f"table's {p['prior_rates']}; prediction error "
                      f"{p['error_before']:.4f} on the table, "
                      f"{p['error_after']:.4f} after the fit", flush=True)
            if "recalibrate" not in kinds or "evict" in kinds:
                fails.append(f"drift: events {kinds}")
            if r0["seen"] != want[:EL_RUNS["drift"][1]]:
                fails.append("drift: the stream")
        t.append(time.perf_counter())
    parts = ("references", *EL_RUNS)
    print("[elastic] seconds: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(parts, t, t[1:])), flush=True)
    if fails:
        raise AssertionError("elastic: " + "; ".join(fails))
    return counts


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def _to(tree, device):
    """A copy of ``tree`` on ``device`` (a copy even where it already
    lies there, so a run that updates it in place leaves ``tree`` be)."""
    return {k: _to(v, device) if isinstance(v, dict)
            else v.detach().to(device, copy=True) for k, v in tree.items()}


def main() -> None:
    import argparse
    import pathlib

    import torch

    global AGAINST, AGAINST_DIR
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR", help="a checkout of another "
                    "commit: time its paged decode, SSD scan, quantize and "
                    "compressed_psum_tree beside this tree's, and stop there")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from repro_torch.kernels import build

    card = card_line()
    refusal = None
    if not args.against:
        # the pool's ranks and phase 8's refusal reach the card and import
        # what they need while the kernels build, not while phase 3 times
        # them (a plain version's time there is bound by its host)
        start_pool()
        refusal = mamba2_paged_refusal()
    print("[card] nvidia-smi name, power.limit:", flush=True)
    print(card, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    with phase("build"):
        so = build.build()
        print(f"[build] {so.name}", flush=True)
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line \
                    or line.startswith("=="):
                print("[build]", line.strip(), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(torch)
    if args.against:
        csrc = pathlib.Path(args.against).resolve() / CSRC
        if not csrc.is_dir():
            raise SystemExit(f"chip_smoke: no {CSRC} under {args.against}")
        with phase("build --against"):
            AGAINST = build.build(csrc)
            AGAINST_DIR = str(pathlib.Path(args.against).resolve())
            print(f"[build] --against {AGAINST}", flush=True)
        with phase("kernels --against"):
            check_paged(torch, timer)
            check_ssd(torch, timer)
            check_quant(torch, timer)
        del timer
        torch.cuda.empty_cache()
        with phase("compressed_psum_tree --against"):
            compression_against(torch)
        return
    with phase("kernels"):
        rows = {"flash_fwd": check_flash(torch, timer),
                "paged_decode": check_paged(torch, timer)}
        rows["flash_bwd_dq"], rows["flash_bwd_dkv"] = check_flash_bwd(
            torch, timer)
        rows["xent_fwd"], rows["xent_bwd"] = check_xent(torch, timer)
        check_xent_shard(torch)
        rows["ssd_scan"] = check_ssd(torch, timer)
        rows["quantize"], rows["dequantize"] = check_quant(torch, timer)
        rows["ef_absmax"], rows["ef_requant"], rows["ef_decode"] = check_ef(
            torch, timer)
    del timer
    torch.cuda.empty_cache()

    kernels = kernel_wrappers()
    with phase("serve (paged, main serving path)"):
        serve_counts, paged4 = serve_paged(torch, kernels)
    with phase("serve (dense)"):
        serve_dense(kernels)
    with phase("serve agreement"):
        small_model_agreement(torch)
    with phase("serve time breakdown"):
        serve_times = where_the_time_goes(torch)
    torch.cuda.empty_cache()
    with phase("serve mamba2 (dense, main path of the ssm family)"):
        mamba_counts, mamba_long_counts = serve_mamba2(torch, kernels,
                                                       refusal)
    with phase("mamba2 agreement"):
        mamba2_agreement(torch)
    with phase("mamba2 time breakdown"):
        where_the_time_goes(torch, MAMBA, "dense")
    torch.cuda.empty_cache()
    with phase("train (main training path)"):
        train_counts, train_losses = train_full(torch, kernels)
    torch.cuda.empty_cache()
    with phase("train agreement"):
        train_agreement(torch)
    with phase("train resume"):
        train_resume(torch)
    with phase("train time breakdown"):
        train_time(torch)
    torch.cuda.empty_cache()
    with phase("train compressed (main path of the data-parallel slice)"):
        comp_counts, mesh_counts = train_compressed(torch, kernels)
    with phase("compressed step time breakdown"):
        compression_time(torch)
    torch.cuda.empty_cache()
    with phase("compressed agreement"):
        compressed_agreement(torch)
    torch.cuda.empty_cache()
    with phase("train planned (--auto --hw h100 --profile)"):
        planned_counts = train_planned(torch, kernels, train_losses,
                                       serve_times)
    torch.cuda.empty_cache()
    with phase("pipeline interpreter (schedule_grads, path A)"):
        interp_counts = pipeline_interpreter(torch, kernels)
    torch.cuda.empty_cache()
    with phase("pipeline engine (2 ranks on one card, path B)"):
        engine_counts, unpiped = pipeline_engine(torch)
    torch.cuda.empty_cache()
    with phase("heterogeneous pipeline (planned stage layers, 2 ranks)"):
        hetero_counts, wh_hetero = hetero_pipeline(torch, unpiped)
    torch.cuda.empty_cache()
    with phase("uneven data parallelism (planned batch shares, 2 ranks)"):
        uneven_counts = uneven_dp(torch)
    torch.cuda.empty_cache()
    with phase("tensor parallelism (split×2, 4 layers, 2 ranks)"):
        tp_counts = train_tp(torch)
    torch.cuda.empty_cache()
    with phase("replica×2{split×2} with ZeRO 0/1/3 (4 ranks)"):
        zero_counts, wh_case2, zero_af_counts = train_hybrid_zero(torch)
    torch.cuda.empty_cache()
    with phase("Whale's nested hybrid (split×2 pipeline×2, 4 ranks)"):
        nested_counts, wh_case4 = train_nested(torch)
    torch.cuda.empty_cache()
    with phase("serving over a mesh (split×2, data 2 x model 2; 2 and 4 "
               "ranks)"):
        serve_tp_counts = serve_tp(torch, kernels, paged4)
    torch.cuda.empty_cache()
    with phase("Whale's annotations (Case 1 + Case 2's head, one process; "
               "Cases 2 and 4 and the hardware-aware plan ran in phases "
               "24, 25 and 21)"):
        wh_case1 = whale_annotations(torch, kernels)
    torch.cuda.empty_cache()
    with phase("the MoE family (deepseek-moe-16b: serving at full depth, "
               "training, the expert split on 2 ranks)"):
        moe_counts = moe_family(torch, kernels)
    torch.cuda.empty_cache()
    with phase("the compressed cross-pod reduction over model shards and "
               "ZeRO (4 ranks)"):
        cb_counts = compressed_blocks(torch)
    torch.cuda.empty_cache()
    with phase("mamba2-1.3b training (full width and depth, one process)"):
        m2_train_counts = mamba2_train(torch, kernels)
    torch.cuda.empty_cache()
    with phase("mamba2 over model (split×2 training and serving, 2 ranks)"):
        m2_split_counts = mamba2_split(torch)
    torch.cuda.empty_cache()
    with phase("the MoE family across the engine (deepseek-moe-16b: "
               "pipeline×2 and over model 2, the balance at data 2, served "
               "split×2 and data 2 x model 2; 2 and 4 ranks)"):
        moe_engine_counts = moe_engine(torch, kernels)
    torch.cuda.empty_cache()
    with phase("the dense family's rest (qwen3-1.7b, gemma-2b, stablelm-3b: "
               "served paged and dense, trained, held against the plain "
               "versions)"):
        dense_counts = dense_rest(torch, kernels)
    torch.cuda.empty_cache()
    with phase("the hybrid family on one card (jamba-v0.1-52b: served at "
               "one period, trained at the 2-layer pattern, held against "
               "the plain versions)"):
        jamba_counts = jamba(torch, kernels)
    torch.cuda.empty_cache()
    with phase("the ssm and hybrid families across the engine (mamba2 and "
               "jamba pipeline×2, jamba split×2; 2 ranks)"):
        hybrid_counts = hybrid_engine(torch, kernels)
    torch.cuda.empty_cache()
    with phase("grok-1-314b (served at 4 layers, trained at 1 with "
               "Adafactor, the experts' d_ff split on 2 ranks)"):
        grok_counts = grok(torch, kernels)
    torch.cuda.empty_cache()
    with phase("the multimodal families (qwen2-vl-2b and "
               "seamless-m4t-medium: served and trained at full width, "
               "held against the plain versions, the two-tower pipeline "
               "on 2 ranks)"):
        mm_counts = multimodal(torch, kernels)
    torch.cuda.empty_cache()
    with phase("Whale's elastic runtime (train --hosts at tinyllama's width: "
               "a straggler evicted, a spot reclaim drained and regrown, a "
               "missed deadline, a drift recalibrated; 2 and 3 ranks)"):
        el_counts = elastic(torch, kernels)
    close_pool()

    meta = {
        "flash_fwd": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                      "src/repro/kernels/flash_attention/flash.py:52"),
        "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                         "src/repro/kernels/flash_attention/paged.py:45"),
        "flash_bwd_dq": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                         "src/repro/kernels/flash_attention/flash.py:109"),
        "flash_bwd_dkv": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                          "src/repro/kernels/flash_attention/flash.py:155"),
        "xent_fwd": ("src/repro_torch/kernels/csrc/xent_fwd.cu",
                     "src/repro/kernels/xent/xent.py:36"),
        "xent_bwd": ("src/repro_torch/kernels/csrc/xent_bwd.cu",
                     "src/repro/kernels/xent/ops.py:91"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd/ssd.py:31"),
        "quantize": ("src/repro_torch/kernels/csrc/quant.cu",
                     "src/repro/kernels/quant/quant.py:22"),
        "dequantize": ("src/repro_torch/kernels/csrc/quant.cu",
                       "src/repro/kernels/quant/quant.py:29"),
        "ef_absmax": ("src/repro_torch/kernels/csrc/quant.cu",
                      "src/repro/kernels/quant/quant.py:22"),
        "ef_requant": ("src/repro_torch/kernels/csrc/quant.cu",
                       "src/repro/kernels/quant/quant.py:22"),
        "ef_decode": ("src/repro_torch/kernels/csrc/quant.cu",
                      "src/repro/kernels/quant/quant.py:22"),
    }
    table = []
    for name in rows:
        by_path = {"serve": serve_counts[name], "train": train_counts[name],
                   "serve_mamba2": mamba_counts[name],
                   "serve_mamba2_long": mamba_long_counts[name],
                   "train_compressed": comp_counts[name],
                   "train_mesh_uncompressed": mesh_counts[name],
                   "train_planned": planned_counts[name],
                   "train_pipeline_interpreter": interp_counts[name],
                   "train_pipeline_engine": engine_counts[name],
                   "train_pipeline_hetero": hetero_counts[name],
                   "train_uneven_dp": uneven_counts[name],
                   "train_tp": tp_counts[name],
                   "train_hybrid_zero": zero_counts[name],
                   "train_zero_adafactor": zero_af_counts[name],
                   "train_pipeline_tp": nested_counts[name],
                   **{path: c[name] for path, c in serve_tp_counts.items()},
                   "train_annotated": wh_case1[name],
                   "train_annotated_case2": wh_case2[name],
                   "train_annotated_case4": wh_case4[name],
                   "train_annotated_hetero": wh_hetero[name],
                   **{path: c[name] for path, c in moe_counts.items()},
                   **{path: c[name] for path, c in cb_counts.items()},
                   "train_mamba2": m2_train_counts[name],
                   **{path: c[name] for path, c in m2_split_counts.items()},
                   **{path: c[name] for path, c in
                      moe_engine_counts.items()},
                   **{path: c[name] for path, c in dense_counts.items()},
                   **{path: c[name] for path, c in jamba_counts.items()},
                   **{path: c[name] for path, c in hybrid_counts.items()},
                   **{path: c[name] for path, c in grok_counts.items()},
                   **{path: c[name] for path, c in mm_counts.items()},
                   **{path: c[name] for path, c in el_counts.items()}}
        table.append(dict(name=name, route="cuda", source=meta[name][0],
                          replaces=meta[name][1],
                          launches=sum(by_path.values()),
                          launches_by_path=by_path, **rows[name]))
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
