#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on an NVIDIA GPU: build, check, run, train, time.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases; the first failure ends the run with a non-zero exit, nothing is
caught:
 1. require CUDA; print the card, its power limit and its SM clock;
 2. build every kernel from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
 3. hold each kernel against its plain PyTorch version on the card, at
    every shape the three paper models give it at batch 64, for packed and
    canonical LUTs of afm16 and mitchell8, an M=10 table (read from global
    memory), the asymmetric cross-format tables fp16xbf16 and bf16xfp16
    (M=10, global; operand A keeps 10 bits, B 7, and the mirror) and afm16
    faulted by ``bitflip:rate=1e-3,seed=0``; every result must be bitwise
    equal;
 3b. the conv weight-gradient kernel the same way, at every conv of
    resnet-mini and LeNet-5: batch 64 for afm16 packed (shared memory) and
    afm10 packed (global memory), batch 4 for the other tables; then
    each shape's plan (printed with its grid: ``approx_conv.dw_plan``,
    ``dw_grid``) on batch 4 buffers mixing zeros, -0.0, subnormals, inf and
    NaN into x and g, held bit for bit (+0.0 and -0.0 differ);
 3c. the conv kernel at every data-gradient shape of those convs (the
    error read undilated with ``input_dilation`` = the stride, flipped
    IO-transposed weights, explicit pads) against its plain version on the
    dilated error, split over the tables as in 3b; then the conv kernel,
    forward and data gradient, on batch 4 buffers with zeros, -0.0,
    subnormals, inf and NaN, bit for bit, and each shape's conv plan
    (``approx_conv.conv_plan``) and grid (``conv_grid``);
 4. inference: resnet-mini at full width (batch 64, 32x32x3 images from
    the port's ``vision_dataset``, random weights from a seed) under
    ``amsim``/afm16 for a few batches; the launch counters must read 15
    conv + 1 GEMM launches per forward and the logits must be finite and
    bitwise equal to ``amsim_torch`` on the card; then lenet-5 and
    lenet-300-100 the same way;
 4b. training: resnet-mini at full width, ``amsim``/afm16, sgdm lr 0.05,
    clip 1.0, 3 steps from seed-0 weights; the counters must read 29
    conv-kernel launches (15 forward + 14 dx: the stem's input needs
    none), 15 dw and 3 GEMM per step, and loss and parameters after step 1
    must be bitwise equal to the same step under ``amsim_torch`` (with
    ``torch.use_deterministic_algorithms``); then lenet-5 (3 / 2 / 9) and
    lenet-300-100 (0 / 0 / 8); then ``train_one`` on lenet-300-100 for one
    epoch of 512 images under fp32, bf16, afm16 and afm32 (``direct``):
    the mean loss of each second half of the epoch must be below the first
    half's, and the Table III deltas are printed;
 5. per-forward times (CUDA events) of native, amsim and amsim_torch with
    the device's busy time (torch.profiler; "not measured" when it records
    no device activity);
 5b. per-training-step times of native and amsim for each model with the
    device's busy time and idle share, and each kernel's device time at
    the shapes of one resnet-mini step (CUDA events around calls queued
    behind a spin kernel) beside its bound and its plain version's time;
    each GEMM shape also with its launch plan (``approx_gemm.gemm_plan``:
    path, tile, table) and its grid (``approx_gemm.gemm_grid``: blocks on
    the SMs) and the time of exact-fp32 ``torch.matmul`` at
    the same shape (a different function, no LUT: the paper's Table V
    native yardstick, not a library time); each dw shape with its plan,
    grid and chain floor (its positions x the clocks of a dependent float
    add at the max SM clock: no fold order that keeps the bits is shorter);
    each conv shape with its plan and grid, and its lookups: those the
    kernel makes on values of its input (at the data gradient only the
    error's real values: equal to the lookups on real values) and those on
    padding taps, which it stages as +0.0;
LM serving (granite-3-2b at full width, ``configs/granite_3_2b.py``):
 3d. the attention kernel and the three decode-chain kernels against their
    plain versions at the serving path's full-width shapes, with afm16
    packed (shared memory), afm10 packed (global memory), fp16xbf16 and
    the faulted afm16: causal
    prefill, decode over a ring with unwritten slots, both decode forms;
    every result bitwise equal; the attention kernel also at the card
    tests' path shapes (granite-3-2b's prefill and a decode over a ring of
    160, granite-moe's decode with G = 3, a prefill of 512 into a ring of
    512), each with its plan and grid and the lookups its tiles make beside
    those on valid keys (the causal diagonal's share), on zeros, -0.0 and
    subnormals with inf and NaN in the unwritten slots, and under every
    tile and table form of ``approx_attention.ATTN_TILES``, bit for bit
    (+0.0 and -0.0 differ); the back half's cooperative grid (blocks
    on the card's SMs, work items of each phase); the GEMM kernel at the
    head (4 rows, the column path) and at every projection of a 4 x 64
    prefill (q, k/v, gate/up, down: each register tile those launch); and the kernels' expf/rsqrtf against torch.exp/torch.rsqrt
    over a sweep of float32;
 4c. depth 2, batch 2, prompt 16, 4 new tokens, with a ring of 64 slots
    (2 chain launches a layer) and of 160 (3): logits and tokens under
    ``amsim`` bitwise equal to ``amsim_torch``; the counters must read 7
    GEMM + 1 attention launches a layer and 1 head GEMM for the prefill,
    and 2 or 3 chain/attention launches a layer plus 1 head GEMM a step;
 5c. full depth (40 layers), batch 4, prompt 64, 32 new tokens, under
    ``amsim`` and ``native``: prefill ms, ms per decode step, tokens/s,
    device idle share, the amsim/native ratio, and each serving kernel's
    device time per prefill and per decode step beside its bound and its
    plain version's time, and the qkv and back-half grids at the run's
    shapes (blocks, work items); each GEMM shape with its plan and the
    exact-fp32 torch.matmul time as in 5b.
MoE serving (granite-moe-3b-a800m at full width,
``configs/granite_moe_3b_a800m.py``):
 3e. the batched GEMM kernel at the expert banks' shapes at a capacity of
    512 under afm16 and of 64 under the other tables (also with dead tail
    rows, an all-dead expert's B holding inf and NaN) and a ragged shape, the router GEMM at 4 rows, and the wo+norm
    and expert-bank chain kernels at 4 rows (with and without the wo bias;
    the wo+norm grid printed: ``decode_chain.wo_norm_grid``)
    and at capacities 8 and 64,
    on the buffer ``moe_ffn`` scatters for a decode step of 4 tokens, and
    on one with dead rows (zero, -0.0 and subnormal rows between live ones,
    an all-dead expert whose banks hold inf and NaN), against their plain
    versions with the table forms of 3d (afm16, afm10, fp16xbf16: the
    faulted afm16 is afm16's form); every result bit for bit equal (+0.0
    and -0.0 differ);
 4d. depth 2, batch 2, prompt 16, 4 new tokens, ring 64: prefill logits,
    every decode step's logits and the tokens under ``amsim`` bitwise equal
    to ``amsim_torch``; then a prefill of 2 x 520 tokens (capacity 264: the
    expert FFN as three batched GEMMs), logits bitwise equal; the counters
    must read 5 GEMM (wq, wk, wv, wo, router), 1 attention and 1 expert-bank
    launch a layer plus 1 head GEMM for the short prefill, 5 GEMM, 1
    attention and 3 batched GEMM a layer plus the head for the long one,
    and qkv, attention, wo+norm, router GEMM and expert banks once a layer
    plus the head a decode step;
 5d. full depth (32 layers), batch 4, prompt 64, 32 new tokens, ring 96,
    under ``amsim`` and ``native``: prefill ms, ms per decode step,
    tokens/s, device idle share, the amsim/native ratio; one timed prefill
    of 4 x 512 tokens under both; each kernel's device time at the
    shapes of these runs beside its bound and its plain version's time,
    the qkv grid, and the live rows, banks and grid of the measured decode
    step's expert banks and the wo+norm grid; each GEMM shape with its
    plan (and the live row
    tiles of the capacity-512 buffers) and the exact-fp32 torch.matmul
    time; and layer 0's expert FFN on the 4 x 512 prefill's capacity-512
    buffer by both routes (the expert-bank kernel and three batched
    GEMMs): same bits, the device time of each.
LM training (both LMs, ``launch.train.make_lm_train_step``: adamw,
``cosine_schedule(3e-4, 10, 3)``, remat; after the serving phases):
 5e. granite-moe's adamw step at depth 1, 1 x 8 (its top-8-of-40 MoE
    layer) under amsim and amsim_torch with deterministic algorithms: the
    loss, the parameters and the next gradient bitwise, the launches
    (granite-3-2b's two adamw steps at depth 2 are held so in 6a); a resume
    through the trainer (2 steps, a checkpoint under
    ``build/chip_smoke_ckpt/``, a restore into a model drawn from another
    seed, 1 step) bitwise equal to 3 steps straight; then 2 steps of each
    model at full width and full depth (which must fit the card's free
    memory: ``train_fits``), batch 4 x 64: each
    step's wall ms, CUDA-event ms and loss (step 2 also its device busy
    time from torch.profiler), the peak memory, the launches of each step,
    and granite-moe's every kernel shape of step 1 timed (granite-3-2b's:
    6b), with its bound and plan, and
    held bitwise against its plain version at its first call, inside the
    step (a GEMM of more than 1e10 lookups, an LM head at 256 rows, on its
    first and last output tiles and every 13th column: ``held_columns``).
The numerics surface (``core/policy.py`` tables, ``core/fpstages.py``,
``core/faults.py``, ``launch/sweep.py``, ``launch/faultsweep.py``; after
5e; 6b first, then 6a, 6c and 6d):
 6a. granite-3-2b depth 2 at full width, batch 1 x 8, 2 adamw steps with
    deterministic algorithms: a uniform ``PolicyTable`` of amsim/afm16
    bitwise the flat policy (losses, parameters after step 2, the gradient
    at the next batch; the same launches); the mixed table
    ``qkv=mitchell8,attn_score=bf16,dw=native,default=afm16`` bitwise
    between ``amsim`` and ``amsim_torch``, with the launches the table
    dictates (``table_train_want``: no dw GEMM where dw runs native, the
    attention as two batched GEMMs where its two sites differ);
 6b. ``python -m repro_torch.launch.sweep``'s ``main`` on granite-3-2b at
    full width and depth, batch 4 x 64, 2 adamw steps a point: the fp32
    baseline and ``default=fp16xbf16`` (the mixed table is 6a's); each point's
    losses against the baseline, ms a step (wall; step 2's device busy
    time from torch.profiler), peak memory, launches by kernel each step
    (as ``table_train_want`` counts them), the train steps built (one) and
    the tables uploaded; then every kernel shape of the fp16xbf16 point's
    step 1 held bitwise against its plain version and timed under
    fp16xbf16 and under afm16 on the same operands;
 6c. granite-3-2b depth 2 serving (batch 2, prompt 16, 4 new tokens, ring
    64) under ``unembed=native,default=fp16xbf16`` (the fused decode
    chain engages: its sites share a leaf) and ``wd=bf16,default=afm16``
    (it does not: the per-op path): logits and greedy tokens bitwise
    between ``amsim`` and ``amsim_torch``, the launches as the table
    dictates;
 6d. ``python -m repro_torch.launch.faultsweep``'s ``main`` on resnet-mini
    at full width (batch 64, 40 sgdm steps a point, ``amsim``) with
    deterministic algorithms: bitflip at rates 0, 1e-4 and 1e-3 and
    stuck1 at 1e-3; the launches of each step, the tables uploaded (none
    for the clean point, one for each faulted table), test accuracy
    against the rate; a zero-rate spec bitwise the clean point; each
    faulted point again for one step under ``amsim`` and ``amsim_torch`` at
    batch 16 with 64 test images, bitwise alike (loss, test accuracy);
    then a training step's time with the clean and with the faulted table,
    in turns.
Continuous batching (``serve/scheduler.py``, ``serve/paged_cache.py``,
``python -m repro_torch.launch.serve --stream``; after 6d):
 7a. the attention kernel and ``fused_attn_out_mlp`` with per-row
    positions ((B, S) and (B, T)) against their plain versions, bit for bit,
    with the tables of 3d: decode ticks of 8 slots at their own positions
    (dead ones among them) over Tcap 304 (the 3-launch form) and 128 (the
    2-launch form), a paged prefill of 1 x 256 over Tcap 304, inf and NaN
    in every key no row may read; per-row positions that agree across the
    rows give the bits of shared ones; each timed at those shapes (afm16);
 7b. depth 2 at full width: a ragged two-tier stream (exact=native,
    cheap=amsim:afm16, pools of 4 pages), with preemption, for granite-3-2b
    and granite-moe (the per-row kernels are held against their plain
    versions in 7a); the per-op path (``REPRO_DECODE_FUSED=0``, the one
    kill switch this script sets) the chain's tokens; one request's paged
    decode logits bitwise the ring engine's; a windowed stream
    (sliding_window 8) recycling a 5-page pool, token for token the same
    under amsim_torch (no deterministic algorithms: the trash page's
    colliding writes all carry zeros, so dead rows read the same on every
    run);
 7c. granite-3-2b at full width and depth: 16 requests, prompts of 32-256
    tokens from the seed, 16 new tokens each, tiers exact=native and
    cheap=amsim:afm16 in turn, 8 slots a lane, pages of 16, one arrival a
    tick, through ``launch.serve``'s engine with nothing around it:
    tokens/s, decode ticks and their wall ms, prefill ms an admission by
    bucket, pages at their high-water mark, one decode build a tier; then
    the same stream again with its counters zeroed just before it and a
    probe around each tick: the same tokens, the launches of each kernel
    and a tick's, device-to-host waits a tick (counted under
    ``torch.cuda.set_sync_debug_mode("warn")``), the probe's wall beside
    the clean run's, and a full tick's device busy time (preemption is
    driven on the card in 7b, its token identity in
    ``tests/test_torch_scheduler.py``);
 7d. granite-moe-3b-a800m at full width and depth: 8 requests of 16 new
    tokens on one amsim:afm16 tier, the same numbers (the probed run's
    tokens those of the clean run: the MoE stream repeats without
    deterministic algorithms).
The launches of 7c's and of 7d's probed run are printed on their own
lines; the kernels line keeps the launches of the earlier paths.
The SSM families (``models/ssm.py``: mamba2-780m, and zamba2-1.2b with its
weight-shared attention block; after 7d):
 8a. the kernels of their paths at full width (depth 2, the hybrid's shared
    block after every 2nd layer), captured from the entry points under
    amsim/afm16 -- a serving prefill of 4 x 64 and a decode step of each
    model (zamba2 also with its window cut to 32: a ring shorter than the
    prompt), the SSD products and the attention of a training step at 1 x
    512 (two chunks of 256) -- each distinct shape again under the table
    forms of 3d (as 3e) against its plain version, bit for bit, with its
    plan, grid and device time;
 8b. depth 2 at full width: serving at batch 1, prompt 16, 4 new tokens
    under amsim and amsim_torch (zamba2 again with its window cut to 8, so
    that the ring wraps): prefill logits, decode logits and tokens bitwise,
    the launches each kernel must make; an adamw step of each with the
    chunk cut to 16, mamba2 at 1 x 32 (two chunks: the state recurrence and
    every SSD gradient product run), zamba2 at 1 x 16 with its shared block
    after both layers (the two applications' gradients add up), under both with
    deterministic algorithms: the loss, the parameters and the next
    gradient bitwise, the launches;
 8c. full width and depth: each model served at batch 4, prompt 64, 8 new
    tokens under amsim (prefill ms, ms a decode step, tokens/s, idle shares,
    launches, the GEMM kernel's time at the prefill's and a decode step's
    shapes), then (after phase 9, the mesh's ranks gone from the card) 2
    adamw steps at 4 x 256 (remat for mamba2, none in the hybrid stack, as
    in JAX): wall ms, busy ms, peak memory, launches a
    step, finite losses, and step 1's SSD batched products (a row of one
    chunk runs the scores and intra-chunk products alone) timed beside
    their bounds, each bitwise its plain version.
The launches of each of 8c's runs are printed on their own lines; the
kernels line keeps the launches of the earlier paths.
The encoder-decoder (``models/encdec.py``: whisper-base, its encoder and
cross-attention bidirectional over 1500 frames; after 8c's serving, 8c's
training following it):
 9a. the kernels of its path at full width and depth 2, captured under
    amsim/afm16 from ``encode`` (2 x 1500 frames), the decode of a 4-token
    prompt and a decode step (``serve_step``), and the batched products and
    attention of a training step at 1 x 64 -- each distinct shape again
    under the tables of 3d against its plain version, bit for bit, with its
    plan, grid and device time; the encoder attention timed under every
    tile and table form; then the attention kernel at causal=False on
    zeros, -0.0 and subnormals with inf and NaN in every unwritten key,
    under every tile and table form, bit for bit;
 9b. depth 2 at full width: greedy decoding of 1 x 1500 frames, prompt 4,
    4 new tokens under amsim and amsim_torch: the encoder states, every
    step's logits and the tokens bitwise, the launches (an encoder layer 6
    GEMMs + 1 attention, a decoder layer 10 GEMMs + 2 attentions each
    decode, the head 1 GEMM); an adamw step at 1 x 64 over 1500 frames at
    depth 1 + 1 (the encoder's backward still chunks its 1500 queries)
    under both with deterministic algorithms: the loss, the parameters and
    the next gradient bitwise, the launches;
 9c. full width and depth: greedy decoding at batch 4 over 1500 frames,
    prompt 4, 16 new tokens under native and amsim (encode ms, prompt ms,
    ms a decode step, tokens/s, idle shares, launches, the GEMM and
    attention kernels' time at the encode's and a step's shapes beside
    their bounds); then 2 adamw steps at 4 x 64 over 1500 frames with
    remat: wall ms, busy ms, peak memory, launches a step, finite losses,
    step 1's attention and batched shapes timed beside their bounds, each
    bitwise its plain version.
The launches of 9c's runs are printed on their own lines.
The rest of the dense registry (``configs/llava_next_34b.py``,
``qwen2_5_32b.py``, ``qwen1_5_110b.py``, ``stablelm_12b.py``: heads of 128
and 160, q/k/v biases, llava's patch embeddings before its text; after 9c):
 10a. the kernels of the dense path at the new shapes against their plain
    versions, bit for bit, under afm16 packed and afm10 (a global table):
    the attention kernel at heads of 128 (G = 7, 5) and 160 (G = 4),
    causal prefills and decode steps over rings with unwritten slots
    (llava's last 16 prefill positions over its 2976 keys, scores in the
    global scratch), under its plan and every tile x table form, on special
    values too, each plan and grid printed, and timed under afm16 at the
    path's own shapes (llava's whole prefill over 2976 keys, the 4 x 64
    prefills and the steps of the others); ``fused_qkv_norm``,
    ``fused_attn_out_mlp`` and ``fused_out_mlp`` in 10c's decode forms
    (ZOO_CHAIN): stablelm-12b's and qwen2.5-32b's 4 rows over a ring of 96
    (attention+out-mlp), llava-next-34b's 1 row over 2976 (out-mlp),
    qwen1.5-110b's at 1 row of 10c's 4 over 72, with their grids; the GEMM
    at qwen1.5's d_ff 49152 (4 and 16 rows) and its vocab of 152064 (4
    rows), on ``held_columns``, with its plan; each timed under afm16 beside
    its bound;
 10b. depth 1 at full width under amsim and amsim_torch with deterministic
    algorithms: llava (its frontend cut to 8 patches) prefilled through
    ``lm_forward(embeds=, caches=)`` with 4 text tokens, qwen2.5 (biases)
    and stablelm (heads of 160) with prompts of 4, then a greedy step
    through the decode chain: the prefill's and every step's logits and
    the tokens bitwise, the launches; stablelm's adamw step at 1 x 4 and
    the gradient after it bitwise;
 10c. full width: stablelm-12b at full depth (40 layers, 48.6 GB) served
    at batch 4, prompt 64, 32 new under native and amsim; llava-next-34b at
    depth 4 prefilled with 2880 patches and 64 text tokens, then 32 greedy
    steps over a ring of 2976; qwen2.5-32b at depth 8 served 4 x 64, 32
    new; qwen1.5-110b at depth 2 served 4 x 64, 8 new (amsim): prefill ms
    (and its device busy time in a profiled rerun), ms a decode step, busy,
    idle share, tokens/s, peak memory, the launches; then 2 training steps
    each of stablelm (adamw, depth 2, 4 x 64), llava (adamw, depth 1, 1 x
    (2880 + 64)) and qwen1.5 (adafactor, depth 1, 4 x 64): wall, busy,
    peak memory, launches, finite losses.
The launches of 10c's runs are printed on their own lines; the kernels
line keeps the launches of the earlier paths.
llama4-maverick-400b-a17b (``configs/llama4_maverick_400b_a17b.py``:
(dense, MoE) pairs, 128 routed experts, top-1, beside an always-on shared
expert; after 10c, with everything before it freed): one pair at full
width with all 128 experts (18.55 G parameters, 74.2 GB) drawn once on the
card with the generator, the free memory printed first;
 11a. the kernels of its serving path captured under amsim/afm16 from a
    prefill of 4 x 64 (the 256-row projections, router and shared expert,
    the attention, the expert banks at E 128, C 8 and the head), a decode
    step of its 4 rows over a ring of 96
    (``fused_qkv_norm``, ``fused_attn_out_mlp`` at d 5120 / d_ff 8192, the
    MoE layer's attention, ``fused_wo_norm`` at d 5120, the router (4 x 5120
    x 128), shared-expert and head GEMMs at 4 rows, the banks on the buffer a
    step of 4 tokens scatters) and a step over a ring of 160
    (``fused_out_mlp``, the 3-launch form), each again under afm16 packed and
    afm10 (a global table) against its plain version, bit for bit (the
    banks on all 128 experts: the plain version computes the live ones, 8
    at a time, and writes +0.0 over the dead ones, as the kernel does; the
    prefill's under afm10 on the first live row of each live expert and
    +0.0 at every dead row); a GEMM of more than 1e10 lookups (the head at
    256 rows, the FFN projections) on every 71st column; each call's device
    time under afm16 beside its bound, its plan and grid;
 11b. amsim against amsim_torch with deterministic algorithms: the same
    model served a prompt of 1 x 4 and 2 greedy steps (the prefill's and
    every step's logits and the tokens bitwise, the launches); then, with
    the model freed, one adafactor step at full width and depth 2 with the
    experts cut to 16 at 1 x 4 (the loss bitwise; the parameters and the
    next gradient by ``fingerprint``: an int64 a 2^24 elements, the sum of
    the int32 bit patterns times fixed random odd weights, since both runs'
    35.7 GB do not fit the card together);
 11c. the same model served at batch 4, prompt 64, 32 new tokens under
    native and amsim (prefill ms and its busy time in a profiled rerun, ms a
    decode step, busy, idle share, tokens/s, peak memory, the launches, 11a's
    kernel times of the prefill and of a step beside their bounds); then 2
    adafactor steps at 4 x 64, depth 2, 16 experts (``train_full``: wall,
    busy, peak memory against ``train_fits``, launches, finite losses; every
    kernel shape of step 1 timed beside its bound and held against its
    plain version inside the step, a GEMM of more than 1e10 lookups on
    every 71st column, the banks on the first live row of each expert).
The launches of 11c's runs are printed on their own lines.
The mesh (``launch/mesh.py``, ``distributed/``): four ranks on the one
card through ``launch.mesh.spawn`` (gloo: NCCL refuses two ranks of one
communicator on one device; the backend line first), amsim/afm16, a 2x2
(data, model) mesh and a (4, 1) one over the same ranks.  The spawn starts
after 6b, everything before it freed, and runs beside 6a, 6c, 6d, 7, 8
(8c's training apart) and 9, whose models leave the ranks room on the
card (the main run waits for it before 8c's training, which follows 9),
so the times of both are taken on a shared card and host; its checks and
lines follow 11c:
 12a. the sharded contracts at full-width shapes, kernel against kernel:
    granite-3-2b's wq/wo and wg/wd at a 4 x 64 prefill, the column-parallel
    forward bitwise the single-device kernel on the whole operands, the
    row-parallel forward, the column dx and the batch-split dw bitwise the
    k-split oracle (the same kernel on the slices, the partials added in
    shard order); attention with heads and rows split, forward and VJP
    bitwise; resnet-mini's 8 convs at batch 64 on (4, 1), forward and dx
    bitwise, dw the batch-split oracle; ``compressed_all_reduce`` of a
    2048 x 8192 gradient bitwise the composition computed on one rank;
 12b. granite-3-2b at full width and depth on the 2x2 mesh (each rank
    draws the layers from the seed and keeps its blocks), a 4 x 64 prefill
    and 8 greedy tokens: logits and tokens bitwise the k-split oracle
    (``distributed.oracle.ksplit``: the single-device per-op run, chain off,
    with each row-parallel sum split as the mesh splits it), which a row sum
    missing one shard is not; against the unsplit per-op run a reading of
    what the split sums alone move (relative norm up to the first token
    where the two part, the tokens equal wherever its top-2 margin exceeds
    the largest logit gap); prefill ms, ms a step, tokens/s, the
    collectives a step and their share of its wall (host clock), peak
    memory a rank and the card's memory.used;
 12c. granite-3-2b at full width, depth 4, on the 2x2 mesh: step 1's loss
    and every gradient leaf bitwise the k-split oracle
    (``distributed.oracle.ksplit_loss_and_grads``), which a row sum missing
    one shard is not, and their readings against the unsplit step; then an
    adamw step at 4 x 64 (clip 1.0), ms a step and memory a rank;
    resnet-mini data-parallel on (4, 1), 2 sgdm steps at batch 64, step 1
    against the single-device step (``MESH_VISION_RTOL``);
 12d. ``REPRO_SHARD_FUSED=0`` at depth 2 (the replicated dispatch, the
    chain on the gathered weights): logits and tokens bitwise the
    single-device run's with the chain on.
Every kernel of 12b and 12c must launch on every rank; the kernels line
carries each kernel's launches a rank there (``mesh_launches_per_rank``).
Every family on the mesh, in the same spawn after 12d (amsim/afm16 unless
named; the oracle runs on rank 0, the unsplit runs are readings of what
the split sums alone move):
 13a. granite-moe-3b-a800m at full width and depth through
    ``ContinuousBatchingEngine(mesh=)``: 6 requests of 16-48 prompt tokens
    and 8-16 new ones from the seed, one arrival a tick, 4 slots (two a
    data rank), pages of 16, so that admissions (a B = 1 prefill on its
    owner's "model" group beside decoding slots) and retirements happen;
    the pools' spec (None, None, "model", None); tokens/s, ms a tick,
    collectives a tick, GB a rank.  The stream under afm16, then under
    native: the tokens and every forward's logits (each prefill's on its
    owner, each tick's data block) bitwise the k-split oracle's stream
    (``ksplit``: each data rank's slots in turn, the banks in the mesh's
    blocks of experts; on the card ``native``'s products are cuBLAS's,
    whose bits depend on the rows and batch of a call, which the printed
    witness shows), and against the unsplit single-device stream (a
    reading; CPU tests hold native's bitwise);
 13b. granite-moe at full width, depth 4, 4 x 64: step 1's loss (its aux
    loss the whole batch's routing) and every gradient leaf bitwise the
    oracle (``ksplit_loss_and_grads``: the data blocks in lockstep, each
    MoE layer's routing exchanged), a row sum missing one shard not; then
    one adamw step, its ms, collectives, GB a rank;
 13c. mamba2-780m and zamba2-1.2b at full width, depth 24 (of 48 and 38;
    cut for time), served 4 x 64 and 4 new tokens, bitwise the oracle
    (each data rank's rows in turn: the recurrence's exact float32
    einsums are cuBLAS's); one training step at 4 x 256 bitwise the
    oracle, mamba2 at depth 4 and zamba2 at 12 (its shared block applied
    twice; depth cut for time: every weight gradient's data sum goes
    through gloo's host copies);
 13d. whisper-base at full width and depth: an encode of 4 x 1500 frames
    and 8 greedy tokens (encoder states, tokens, logits) and one training
    step at 4 x 64 over 1500 frames, bitwise the oracle;
 13e. granite-moe's decode under ``REPRO_SHARD_FUSED=0`` at depth 2, 4 x
    64 and 4 new: ``fused_qkv_norm``, ``fused_wo_norm`` and
    ``fused_moe_ffn`` launch on the gathered weights and banks, logits and
    tokens bitwise the single-device chain run.
Every kernel of 13a-13d's mesh runs must launch on every rank; the kernels
line carries each one's launches a rank there
(``mesh_families_launches_per_rank``).
``python3 chip_smoke.py --phase 5e,8,12`` (any of 5e, 7, 8, 9, 10, 11, 12,
13) runs phases 1, 2 and those alone, in that order (12 and 13 in one
spawn), and prints no result lines.
The line before the last is a JSON object with one row per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace; set before CUDA starts.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
BATCH = 64
N_BATCHES = 3
TRAIN_STEPS = 3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
LOOKUPS_PER_SM_PER_CLOCK = 32      # shared-memory gathers: one per bank
FADD_CLOCKS = 4                    # latency of a dependent float add (the dw chain floor)
# "name|spec": the table of ``name`` faulted by a spec of core/faults.py.
FAULTED_AFM16 = "afm16|bitflip:rate=1e-3,seed=0"
LUT_CASES = [("afm16", True), ("afm16", False), ("mitchell8", True),
             ("mitchell8", False), ("afm10", True), ("afm10", False), ("fp16xbf16", True),
             ("bf16xfp16", True), (FAULTED_AFM16, True)]
# The gradient kernels are checked at batch 64 with one shared-memory and
# one global-memory table, and at batch 4 with the others.
FULL_BATCH_LUTS = [("afm16", True), ("afm10", True)]
SMALL_BATCH = 4
# Every GEMM of the three models at batch 64, plus a ragged one.
GEMM_SHAPES = [(64, 784, 120), (64, 120, 84), (64, 84, 10), (64, 784, 300),
               (64, 300, 100), (64, 100, 10), (64, 64, 10), (67, 130, 33)]
# Every distinct conv of resnet-mini and lenet-5 at batch 64:
# (x shape, w shape, stride), all SAME.
CONV_SHAPES = [
    ((64, 32, 32, 3), (3, 3, 3, 16), 1),     # resnet stem
    ((64, 32, 32, 16), (3, 3, 16, 16), 1),   # stage 1
    ((64, 32, 32, 16), (3, 3, 16, 32), 2),   # stage 2 c1, pads (0, 1)
    ((64, 32, 32, 16), (1, 1, 16, 32), 2),   # stage 2 proj
    ((64, 16, 16, 32), (3, 3, 32, 32), 1),   # stage 2
    ((64, 16, 16, 32), (3, 3, 32, 64), 2),   # stage 3 c1
    ((64, 16, 16, 32), (1, 1, 32, 64), 2),   # stage 3 proj
    ((64, 8, 8, 64), (3, 3, 64, 64), 1),     # stage 3
    ((64, 28, 28, 1), (5, 5, 1, 6), 1),      # lenet-5 conv 1
    ((64, 14, 14, 6), (5, 5, 6, 16), 1),     # lenet-5 conv 2
]
# Launches per training step: (conv kernel: fwd + dx, dw kernel, GEMM kernel).
TRAIN_LAUNCHES = {"resnet-mini": (29, 15, 3), "lenet-5": (3, 2, 9), "lenet-300-100": (0, 0, 8)}
# LM serving: the arch, the tables of phase 3d, and the runs of 4c and 5c.
LM_ARCH = "granite-3-2b"
SERVE_LUTS = [("afm16", True), ("afm10", True), ("fp16xbf16", True), (FAULTED_AFM16, True)]
# 3e and 8a: afm16's shared-memory table and fp16xbf16's global, asymmetric
# one (the faulted afm16 is afm16's table form, 3d and 7a hold it; afm10's
# symmetric global table is held at the dense kernels in 3d and 10a)
FORM_LUTS = [SERVE_LUTS[0], SERVE_LUTS[2]]
DEPTH2 = dict(n_layers=2, batch=2, prompt=16, new=4, rings=(64, 160))
FULL = dict(batch=4, prompt=64, new=32)
LONG_RING = 160      # a ring over 128 slots: the chain's 3-launch form
# MoE serving: the arch, and the runs of 4d and 5d.  4 x 64 tokens give a
# capacity of 64 rows an expert and a decode step of 4 tokens one of 8 (the
# expert-bank kernel); 4 x 512 tokens give 512 (the batched GEMM kernel).
MOE_ARCH = "granite-moe-3b-a800m"
MOE_DEPTH2 = dict(n_layers=2, batch=2, prompt=16, new=4, ring=64)
MOE_FULL = dict(batch=4, prompt=64, new=32)
MOE_LONG = dict(batch=4, prompt=512)
# 4d's long prefill: the least tokens whose capacity (264) takes the batched
# route, so that its plain version stays short.
MOE_DEPTH2_LONG = dict(batch=2, prompt=520)
# 3e holds the banks' batched products at a capacity of 512 under the first
# table, and of 64 (the training backward's) under the others.
MOE_CHECK_C = (512, 64)
MOE_SOURCES = {
    "approx_gemm_batched": ("approx_gemm.cu", "src/repro/kernels/approx_gemm.py:72"),
    "fused_wo_norm": ("decode_chain.cu", "src/repro/kernels/decode_chain.py:646"),
    "fused_moe_ffn": ("decode_chain.cu", "src/repro/kernels/decode_chain.py:739"),
}


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` with the host out of the way: a
    spin kernel holds the stream while ``reps`` calls queue up behind it, so
    CUDA events around the calls time the card's work alone.  The spin grows
    until all calls were queued before it ended."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 10_000_000                      # ~5 ms at 2 GHz
    for _ in range(5):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()           # the spin still held the stream
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise SystemExit("chip_smoke FAILED: the host could not queue the calls ahead of the card")


def profiled(fn):
    """(``fn()``, the device busy ms of that call): the summed durations of
    the device activity torch.profiler records (the device alone), None
    when it records none (CUPTI does not always deliver its records)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return out, (us / 1e3 if us else None)


def busy_ms(fn, reps: int, tries: int = 3) -> float | None:
    """Mean device busy ms per ``fn()`` (``profiled`` over ``reps`` calls),
    None when a few profiles in a row record no device activity."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        _, ms = profiled(lambda: [fn() for _ in range(reps)])
        if ms:
            return ms / reps
    return None


def busy_text(busy: float | None, wall: float) -> str:
    if busy is None:
        return "device busy not measured: torch.profiler recorded no device activity"
    return f"device busy {busy:.4f} ms, idle share {1 - busy / wall:.3f}"


def require(cond: bool, what: str):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def special_values(shape, gen, dev):
    """Random normals with zeros, -0.0, subnormals, inf, -inf and NaN mixed
    in, one element in 12 each."""
    v = torch.randn(shape, generator=gen)
    pick = torch.randint(0, 12, shape, generator=gen)
    v[pick == 0] = 0.0
    v[pick == 1] = -0.0
    v[pick == 2] = v[pick == 2] * 1e-39
    v[pick == 3] = float("inf")
    v[pick == 4] = -float("inf")
    v[pick == 5] = float("nan")
    return v.to(dev)


def dw_plan_of(w_shape, lut):
    """The dw plan and its C grid for a (kh, kw, c, o) gradient."""
    from repro_torch.kernels import approx_conv
    kh, kw, c, o = w_shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = approx_conv.dw_plan(kh, kw, c, o, lut, sms)
    return plan, approx_conv.dw_grid(plan, kh, kw, c, o, lut)


def conv_plan_of(shape, lut):
    """The conv plan and its C grid for an ``approx_conv.ConvShape``."""
    from repro_torch.kernels import approx_conv
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = approx_conv.conv_plan(shape, lut, sms)
    return plan, approx_conv.conv_grid(plan, shape, lut)


def conv_launch_shapes(xs, ws, stride, pads) -> dict:
    """{"fwd": ..., "dx": ...}: the ``approx_conv.ConvShape`` of a conv of x
    ``xs`` and w ``ws`` and of its data gradient (the error read undilated,
    input_dilation = stride, as ``ops._conv_dx`` launches it)."""
    from repro_torch.kernels import approx_conv, ops
    fwd = approx_conv.conv_shape(xs, ws, stride, pads)
    w_rt, dpads = ops.conv_dx_weights(torch.zeros(ws), (fwd.oh, fwd.ow), xs[1:3], stride, pads)
    dx = approx_conv.conv_shape((xs[0], fwd.oh, fwd.ow, ws[3]), tuple(w_rt.shape), 1, dpads,
                                stride)
    return {"fwd": fwd, "dx": dx}


def conv_dx_pair(g, w, xs, stride, pads, lut, M):
    """The conv kernel at the data gradient of a conv of x ``xs`` (the error
    g read undilated, input_dilation = stride) and its plain version on the
    dilated error that ``ops.conv_dx_operands`` materialises: (kernel's,
    plain's, pads)."""
    from repro_torch.kernels import approx_conv, ops
    w_rt, dpads = ops.conv_dx_weights(w, tuple(g.shape[1:3]), xs[1:3], stride, pads)
    out = approx_conv.approx_conv2d_fused(g, w_rt, lut, M, stride=1, padding=dpads,
                                          input_dilation=stride)
    gd, w_rt, _ = ops.conv_dx_operands(g, w, xs[1:3], stride, pads)
    return out, approx_conv.approx_conv2d_plain(gd, w_rt, lut, M, 1, dpads), dpads


def taps(n_out: int, n_in: int, k: int, stride: int, pad: int, real_every: int = 1) -> int:
    """(output index, kernel tap) pairs of one spatial axis that land inside
    the input, and on one of its real values when the input is dilated by
    ``real_every`` (zeros inserted between them)."""
    return sum(0 <= i < n_in and i % real_every == 0
               for i in (y * stride + kk - pad for y in range(n_out) for kk in range(k)))


# ------------------------------------------------------------ LM serving
def _ring_positions(T: int, written: int, device) -> torch.Tensor:
    """Positions of a ring of T slots after ``written`` tokens; unwritten
    slots hold the POS_PAD sentinel."""
    from repro_torch.kernels.common import POS_PAD
    pos = torch.full((T,), POS_PAD, dtype=torch.int32)
    for p in range(max(0, written - T), written):
        pos[p % T] = p
    return pos.to(device)


def serving_kernel_checks(dev, gen, lut_case) -> dict:
    """Phase 3d: the four serving kernels against their plain versions at
    granite-3-2b's full width; returns each kernel's largest |difference|."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import decode_chain as chain
    cfg = get_arch(LM_ARCH)
    d, F, H, KV, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S = FULL["batch"], FULL["prompt"]
    T_short = FULL["prompt"] + FULL["new"]

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen).to(dev) * scale

    w = dict(g1=1 + 0.1 * randn(d), g2=1 + 0.1 * randn(d), wq=randn(d, H * dh, scale=d ** -0.5),
             wk=randn(d, KV * dh, scale=d ** -0.5), wv=randn(d, KV * dh, scale=d ** -0.5),
             wo=randn(H * dh, d, scale=(H * dh) ** -0.5), wg=randn(d, F, scale=d ** -0.5),
             wu=randn(d, F, scale=d ** -0.5), wd=randn(F, d, scale=F ** -0.5))
    x, attn = randn(B, d), randn(B, H * dh, scale=0.3)
    back = [w[n] for n in ("g2", "wo", "wg", "wu", "wd")]
    err = {k: 0.0 for k in ("approx_attention", "fused_qkv_norm", "fused_out_mlp",
                            "fused_attn_out_mlp", "approx_gemm")}

    def held(name, out, ref, what):
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        e = max((a - b).abs().max().item() for a, b in zip(outs, refs))
        require(all(torch.equal(a, b) for a, b in zip(outs, refs)), f"{name} {what}: max|d|={e}")
        err[name] = max(err[name], e)

    for lut_name, packed in SERVE_LUTS:
        lut, M = lut_case(lut_name, packed)
        tag = f"{lut_name} {'packed' if packed else 'canonical'}"
        # Causal prefill of S tokens into a ring of T_short slots.
        q, k, v = randn(B, S, H, dh), randn(B, T_short, KV, dh), randn(B, T_short, KV, dh)
        args = (q, k, v, torch.arange(S, dtype=torch.int32, device=dev),
                _ring_positions(T_short, S, dev))
        held("approx_attention", attn_mod.approx_attention(*args, lut, M),
             attn_mod.approx_attention_plain(*args, lut, M, causal=True, window=0),
             f"{tag} prefill {tuple(q.shape)} over T={T_short}")
        # Decode over a ring longer than 128 with unwritten slots.
        written = 100
        q1, k1, v1 = randn(B, 1, H, dh), randn(B, LONG_RING, KV, dh), randn(B, LONG_RING, KV, dh)
        dargs = (q1, k1, v1, torch.tensor([written - 1], dtype=torch.int32, device=dev),
                 _ring_positions(LONG_RING, written, dev))
        held("approx_attention", attn_mod.approx_attention(*dargs, lut, M),
             attn_mod.approx_attention_plain(*dargs, lut, M, causal=True, window=0),
             f"{tag} decode over a ring of {LONG_RING}, {written} written")
        qkv = (x, w["g1"], w["wq"], w["wk"], w["wv"])
        attention_plan_checks(dev, gen, lut, M, tag)
        held("fused_qkv_norm", chain.fused_qkv_norm(*qkv, lut, M, eps=cfg.norm_eps),
             chain.fused_qkv_norm_plain(*qkv, lut, M, eps=cfg.norm_eps), tag)
        held("fused_out_mlp", chain.fused_out_mlp(x, attn, *back, lut, M, eps=cfg.norm_eps),
             chain.fused_out_mlp_plain(x, attn, *back, lut, M, eps=cfg.norm_eps), tag)
        # The 2-launch form: a ring of T_short <= 128 slots, T_short - 10 written.
        written = T_short - 10
        sargs = (q1, k[:, :T_short].contiguous(), v[:, :T_short].contiguous(),
                 torch.tensor([written - 1], dtype=torch.int32, device=dev),
                 _ring_positions(T_short, written, dev))
        held("fused_attn_out_mlp",
             chain.fused_attn_out_mlp(x, *sargs, *back, lut, M, eps=cfg.norm_eps),
             chain.fused_attn_out_mlp_plain(x, *sargs, *back, lut, M, eps=cfg.norm_eps,
                                            causal=True, window=0), tag)
        from repro_torch.kernels import approx_gemm as gemm_mod
        # the head at decode, then every prefill projection: each tile
        # instance the main path launches, at its own shape
        for m, k, n in ((B, d, cfg.vocab), (B * S, d, KV * dh), (B * S, d, H * dh),
                        (B * S, d, F), (B * S, F, d)):
            a, b = randn(m, k), randn(k, n, scale=k ** -0.5)
            held("approx_gemm", gemm_mod.approx_gemm(a, b, lut, M),
                 gemm_mod.approx_gemm_plain(a, b, lut, M), f"{tag} {(m, k, n)}")
            print(f"{tag}: approx_gemm {(m, k, n)} {gemm_plan_text(a, b, lut)}")
            del a, b
        for kname, heads in (("fused_out_mlp", 0), ("fused_attn_out_mlp", H)):
            print(f"{tag}: {kname} grid at {B} rows (blocks on "
                  f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, work items "
                  f"a phase): {chain.back_half_grid(B, d, F, lut, heads=heads, kv_heads=KV)}")
        print(f"serving kernels == plain (bitwise): {tag} LUT at {LM_ARCH} widths: attention "
              f"prefill {tuple(q.shape)} over a ring of {T_short} and decode over {LONG_RING}; "
              f"qkv, out-mlp and attention+out-mlp at {B} rows; GEMM at the head and every "
              f"prefill projection")
    # The kernels' transcendentals against torch's, over every 101st bit pattern.
    bits = torch.arange(0, 2 ** 32, 101, dtype=torch.int64, device=dev)
    xs = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)
    xs = xs[~torch.isnan(xs)].contiguous()
    e, r = chain.device_exp_rsqrt(xs)
    for fname, got, want in (("expf", e, torch.exp(xs)), ("rsqrtf", r, torch.rsqrt(xs))):
        both_nan = torch.isnan(got) & torch.isnan(want)
        differ = (got.view(torch.int32) != want.view(torch.int32)) & ~both_nan
        ulps = (got.view(torch.int32).to(torch.int64) - want.view(torch.int32).to(torch.int64)
                ).abs()[differ]
        print(f"libm: kernel {fname} vs torch on {xs.numel()} float32 values: "
              f"{int(differ.sum())} differ (max {int(ulps.max()) if ulps.numel() else 0} ulp)")
        require(int(differ.sum()) == 0, f"kernel {fname} differs from torch on "
                f"{int(differ.sum())} values, e.g. {xs[differ][:4].tolist()}")
    return err


# The attention kernel's path shapes (tests/test_torch_cuda.py
# ATTN_PATH_CASES): (label, B, S, H, KV, ring slots, keys written), dh 64.
ATTN_PATH_SHAPES = [("granite-3-2b prefill 4x64 ring 96", 4, 64, 32, 8, 96, 64),
                    ("granite-3-2b decode ring 160", 4, 1, 32, 8, 160, 96),
                    ("granite-moe decode ring 96 (G = 3)", 4, 1, 24, 8, 96, 80),
                    ("prefill 1x512 ring 512", 1, 512, 32, 8, 512, 512)]


def attention_lookups(plan, shape, q_pos, k_pos) -> tuple[int, int]:
    """(lookups the kernel's tiles make, lookups on valid keys) of a causal
    attention: a tile makes R x KB x dh for each K slab where a row of it
    has a valid key and R x vkb x dh for each V slab (all the slabs of a
    tile with a row that has no valid key: its p is not zero there)."""
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels.common import attention_mask
    G = shape.H // shape.KV
    mask = attention_mask(q_pos.cpu().repeat_interleave(G), k_pos.cpu(), causal=True, window=0)
    made = 0
    for _, _, _, r0, r1 in attn_mod.attention_tiles(plan, shape, 1):
        m = mask[r0:r1]
        for t0 in range(0, shape.T, plan.key_slab):
            made += plan.rows * plan.key_slab * shape.dh * int(bool(
                m[:, t0:t0 + plan.key_slab].any()))
        every = not bool(m.any(dim=1).all())
        for t0 in range(0, shape.T, plan.value_slab):
            made += plan.rows * plan.value_slab * shape.dh * int(
                every or bool(m[:, t0:t0 + plan.value_slab].any()))
    return made, 2 * int(mask.sum()) * shape.dh * shape.B * shape.KV


def attention_plan_checks(dev, gen, lut, M, tag, shapes=ATTN_PATH_SHAPES):
    """Phase 3d's attention checks at ATTN_PATH_SHAPES (see the module
    doc), and 10a's at ZOO_ATTN_SHAPES (an 8th entry: the head dim, else
    64): bit for bit as int32, +0.0 and -0.0 apart."""
    from repro_torch.kernels import approx_attention as attn_mod
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan_of = attn_mod.attention_plan

    def bits(args, what):
        out = attn_mod.approx_attention(*args, lut, M)
        ref = attn_mod.approx_attention_plain(*args, lut, M, causal=True, window=0)
        same = torch.equal(out.view(torch.int32), ref.view(torch.int32))
        require(same, f"approx_attention {tag} {what}: not bitwise equal to its plain version "
                f"(max|d| {(out - ref).abs().max().item()})")

    packed = lut.dtype == torch.int16
    nbytes = lut.numel() * lut.element_size()
    tables = ["smem canonical", "smem packed"] if packed and 2 * nbytes <= 128 * 1024 else \
        [plan_of(attn_mod.AttnShape(1, 1, 1, 1, 1, 64), lut, sms).table]
    for label, B, S, H, KV, T, written, *head in shapes:
        dh = head[0] if head else 64
        shape = attn_mod.AttnShape(B, S, H, KV, T, dh)
        k_pos = _ring_positions(T, written, dev)
        q_pos = torch.arange(written - S, written, dtype=torch.int32, device=dev)
        q, k, v = (torch.randn(s, generator=gen).to(dev) for s in
                   ((B, S, H, dh), (B, T, KV, dh), (B, T, KV, dh)))
        plan = plan_of(shape, lut, sms)
        made, live = attention_lookups(plan, shape, q_pos, k_pos)
        print(f"{tag}: approx_attention {label}: plan {plan}; grid "
              f"{attn_mod.attention_grid(plan, shape, lut)}; lookups made {made} beside {live} "
              f"on valid keys ({made / live:.2f}x)")
        bits((q, k, v, q_pos, k_pos), label)
        # zeros, -0.0 and subnormals anywhere; inf and NaN in unwritten slots
        sq, sk, sv = (special_values(t.shape, gen, dev) for t in (q, k, v))
        sq = torch.where(torch.isfinite(sq), sq, q)
        written_slots = (k_pos >= 0)[None, :, None, None]
        sk = torch.where(written_slots & ~torch.isfinite(sk), k, sk)
        sv = torch.where(written_slots & ~torch.isfinite(sv), v, sv)
        bits((sq, sk, sv, q_pos, k_pos), f"{label} on special values")
        if label.startswith("prefill 1x512"):
            continue          # every plan at the three serving shapes
        for tile in range(len(attn_mod.ATTN_TILES)):
            for table in tables:
                space = attn_mod.SMEM_BLOCK_MAX - attn_mod._table_bytes(table, packed, nbytes)
                layout = attn_mod.attention_layout(tile, dh, T, space)
                if layout is None:
                    continue
                forced = attn_mod._tile_plan(shape, tile, table, layout, plan.path)
                attn_mod.attention_plan = lambda *a, f=forced: f
                try:
                    bits((q, k, v, q_pos, k_pos), f"{label} forced {forced}")
                finally:
                    attn_mod.attention_plan = plan_of
        print(f"{tag}: approx_attention {label} == plain (bitwise): random values, special "
              f"values, every tile x table form {tables}")


def serving_counters():
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import approx_gemm as gemm_mod
    from repro_torch.kernels import decode_chain as chain
    return {"approx_attention": attn_mod.approx_attention,
            "fused_qkv_norm": chain.fused_qkv_norm, "fused_out_mlp": chain.fused_out_mlp,
            "fused_attn_out_mlp": chain.fused_attn_out_mlp, "approx_gemm": gemm_mod.approx_gemm}


def serve_want(cfg, steps: int, ring: int) -> dict:
    """Launches of a dense LM's prefill and ``steps`` decode steps under
    amsim, in ``serving_counters``' order: a layer's attention and 7 GEMMs
    at the prefill and the head's GEMM; a decode step's qkv and
    attention+out-mlp a layer (a ring of at most FUSE_ATTN_MAX_T slots) or
    qkv, attention and out-mlp (more), and the head."""
    from repro_torch.kernels import ops
    L, two = cfg.n_layers, ring <= ops.FUSE_ATTN_MAX_T
    return {"approx_attention": L + (0 if two else L * steps), "fused_qkv_norm": L * steps,
            "fused_out_mlp": 0 if two else L * steps, "fused_attn_out_mlp": L * steps if two else 0,
            "approx_gemm": 7 * L + 1 + steps}


def serving_depth2(dev, serve_launches: dict):
    """Phase 4c: depth 2 at full width, amsim bitwise amsim_torch, launch
    counts per prefill and per decode step."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.models.transformer import init_lm, init_lm_caches
    from repro_torch.serve.engine import ServingEngine
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=DEPTH2["n_layers"])
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompts = torch.randint(0, cfg.vocab, (DEPTH2["batch"], DEPTH2["prompt"]),
                            generator=torch.Generator().manual_seed(SEED)).to(dev)
    counters = serving_counters()
    L, steps = cfg.n_layers, DEPTH2["new"] - 1
    for ring in DEPTH2["rings"]:
        fused = ring <= 128
        want = serve_want(cfg, steps, ring)
        results, launches = {}, {}
        torch.use_deterministic_algorithms(True)
        try:
            for mode in ("amsim", "amsim_torch"):
                policy = NumericsPolicy(mode=mode, multiplier="afm16")
                engine = ServingEngine(model, policy, max_len=ring)
                for fn in counters.values():
                    fn.launches = 0
                toks, logits = engine.generate(prompts, DEPTH2["new"], return_logits=True)
                torch.cuda.synchronize()
                got = {k: fn.launches for k, fn in counters.items()}
                full, _, _ = engine.prefill(prompts, init_lm_caches(cfg, prompts.shape[0], ring,
                                                                    dev))
                results[mode] = (toks, logits, full)
                if mode == "amsim":
                    require(got == want, f"depth-2 serving, ring {ring}: launches {got}, want "
                            f"{want}")
                    launches = got
                    for k, n in got.items():
                        serve_launches[k] = serve_launches.get(k, 0) + n
        except RuntimeError as e:
            if "deterministic" in str(e):
                raise SystemExit(f"chip_smoke FAILED: serving has an op without a "
                                 f"deterministic CUDA implementation: {e}")
            raise
        finally:
            torch.use_deterministic_algorithms(False)
        (t_a, l_a, f_a), (t_p, l_p, f_p) = results["amsim"], results["amsim_torch"]
        require(bool(torch.isfinite(l_a).all()) and bool(torch.isfinite(f_a).all()),
                f"depth-2 serving, ring {ring}: logits not finite")
        require(torch.equal(f_a, f_p), f"depth-2 prefill logits, ring {ring}: amsim differs from "
                f"amsim_torch by {(f_a - f_p).abs().max().item()}")
        require(torch.equal(l_a, l_p) and torch.equal(t_a, t_p),
                f"depth-2 decode, ring {ring}: amsim differs from amsim_torch (logits max|d| "
                f"{(l_a - l_p).abs().max().item()}, tokens equal {torch.equal(t_a, t_p)})")
        print(f"{LM_ARCH} depth {L}, batch {DEPTH2['batch']}, prompt {DEPTH2['prompt']}, "
              f"{DEPTH2['new']} new tokens, ring {ring} ({'2' if fused else '3'} chain launches a "
              f"layer): prefill logits, {steps} decode steps' logits and tokens bitwise equal to "
              f"amsim_torch; amsim launches {launches}; tokens {t_a[0].tolist()}")
    del model
    torch.cuda.empty_cache()


def _live_keys(q_pos, k_pos, causal=True, window=0) -> int:
    """Valid (query, key) pairs of the mask: of one batch row for shared
    positions, of all rows for per-row ones."""
    from repro_torch.kernels.common import attention_mask
    return int(attention_mask(q_pos.cpu(), k_pos.cpu(), causal=causal, window=window).sum())


def _pairs(B, q_pos, k_pos, kw) -> int:
    """Valid (query, key) pairs of a batch of B rows."""
    live = _live_keys(q_pos, k_pos, kw.get("causal", True), kw.get("window", 0))
    return live * (B if q_pos.ndim == 1 else 1)


def serving_costs(kname, args, kw, lut_bytes_):
    """(bytes each input read once and each output written once, LUT
    lookups this run's data needs) of one call of a serving kernel."""
    f = 4
    if kname == "approx_attention":
        q, k, v, q_pos, k_pos = args[:5]
        B, S, H, dh = q.shape
        return (f * (2 * q.numel() + k.numel() + v.numel()) + 4 * (q_pos.numel() + k_pos.numel())
                + lut_bytes_, 2 * H * _pairs(B, q_pos, k_pos, kw) * dh)
    if kname == "fused_qkv_norm":
        x, g1, *ws = args[:5]
        n = sum(wt.shape[1] for wt in ws)
        return (f * (x.numel() + g1.numel() + sum(wt.numel() for wt in ws) + x.shape[0] * n)
                + lut_bytes_, x.shape[0] * x.shape[1] * n)
    if kname == "fused_out_mlp":
        x, attn, g2, wo, wg, wu, wd = args[:7]
        weights = wo.numel() + wg.numel() + wu.numel() + wd.numel()
        return (f * (2 * x.numel() + attn.numel() + g2.numel() + weights) + lut_bytes_,
                x.shape[0] * weights)
    x, q, k, v, q_pos, k_pos, g2, wo, wg, wu, wd = args[:11]
    B, S, H, dh = q.shape
    weights = wo.numel() + wg.numel() + wu.numel() + wd.numel()
    return (f * (2 * x.numel() + q.numel() + k.numel() + v.numel() + g2.numel() + weights)
            + 4 * (q_pos.numel() + k_pos.numel()) + lut_bytes_,
            x.shape[0] * weights + 2 * H * _pairs(B, q_pos, k_pos, kw) * dh)


# Where each serving wrapper takes its LUT.
LUT_ARG = {"approx_attention": 5, "fused_qkv_norm": 5, "fused_out_mlp": 7,
           "fused_attn_out_mlp": 11}
SERVE_SOURCES = {
    "approx_attention": ("approx_attention.cu", "src/repro/kernels/approx_attention.py:121"),
    "fused_qkv_norm": ("decode_chain.cu", "src/repro/kernels/decode_chain.py:102"),
    "fused_out_mlp": ("decode_chain.cu", "src/repro/kernels/decode_chain.py:213"),
    "fused_attn_out_mlp": ("decode_chain.cu", "src/repro/kernels/decode_chain.py:379"),
}


def qkv_grid_of(args) -> dict:
    """``decode_chain.qkv_grid`` of a captured ``fused_qkv_norm`` call."""
    from repro_torch.kernels import decode_chain as chain
    x, _, wq, wk, wv, lut = args[:6]
    return chain.qkv_grid(x.shape[0], wq.shape[1], wk.shape[1], wv.shape[1], lut)


def serving_full_depth(dev, lookups_per_s, smi_line, serve_launches, serve_err) -> list:
    """Phase 5c: granite-3-2b at full width and depth, amsim and native;
    returns the four serving kernels' JSON rows."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import decode_chain as chain
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import lut_bytes
    from repro_torch.models.transformer import init_lm, init_lm_caches
    from repro_torch.serve.engine import ServingEngine
    cfg = get_arch(LM_ARCH)
    L, B, P, N = cfg.n_layers, FULL["batch"], FULL["prompt"], FULL["new"]
    ring = P + N
    t0 = time.perf_counter()
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    weight_bytes = 4 * sum(p.numel() for p in model.parameters())
    print(f"{LM_ARCH} at full width and depth ({L} layers, {weight_bytes / 1e9:.2f} GB of float32 "
          f"weights) drawn on the card in {time.perf_counter() - t0:.1f} s; batch {B}, prompt {P}, "
          f"{N} new tokens, ring {ring} ({smi_line}):")
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=torch.Generator().manual_seed(SEED))
    prompts = prompts.to(dev)
    counters = serving_counters()
    want = dict(zip(counters, (L, L * (N - 1), 0, L * (N - 1), 7 * L + 1 + (N - 1))))
    amsim = NumericsPolicy(mode="amsim", multiplier="afm16")
    res = {}
    for pname, policy in (("native", NumericsPolicy()), ("amsim", amsim)):
        engine = ServingEngine(model, policy, max_len=ring)
        engine.generate(prompts, 2)          # warm-up: LUT upload, library handles
        for fn in counters.values():
            fn.launches = 0
        timings = {}
        toks = engine.generate(prompts, N, timings=timings)
        got = {k: fn.launches for k, fn in counters.items()}
        if pname == "amsim":
            require(got == want, f"full-depth serving: launches {got}, want {want}")
            for k, n in got.items():
                serve_launches[k] = serve_launches.get(k, 0) + n
        require(toks.shape == (B, N) and bool((toks >= 0).all() & (toks < cfg.vocab).all()),
                f"full-depth {pname}: tokens out of range")
        caches = init_lm_caches(cfg, B, ring, dev)
        _, nxt, caches = engine.prefill(prompts, caches)
        busy_step = busy_ms(lambda: engine.step(nxt, caches), reps=3)
        busy_pre = busy_ms(lambda: engine.prefill(prompts, init_lm_caches(cfg, B, ring, dev)),
                           reps=1)
        pre_ms = timings["prefill_s"] * 1e3
        step_ms = timings["decode_s"] * 1e3 / timings["decode_steps"]
        res[pname] = (pre_ms, step_ms)
        print(f"  {pname}: prefill {pre_ms:.2f} ms ({busy_text(busy_pre, pre_ms)}), "
              f"{step_ms:.3f} ms per decode step ({busy_text(busy_step, step_ms)}), "
              f"{B * N / (timings['prefill_s'] + timings['decode_s']):.2f} tokens/s; tokens "
              f"{toks[0, :8].tolist()}")
    print(f"  amsim/native: prefill {res['amsim'][0] / res['native'][0]:.2f}x, decode step "
          f"{res['amsim'][1] / res['native'][1]:.2f}x")

    # Each serving kernel at the shapes of this run: capture its calls in an
    # amsim prefill, a decode step, and a decode step over a ring of more
    # than 128 slots (the 3-launch form).
    names = list(SERVE_SOURCES) + ["approx_gemm"]
    originals = {k: getattr(ops, k) for k in names}
    calls = {}

    def capture(ctx, kname):
        def wrapped(*a, **kw):
            kept = tuple(t.clone() if torch.is_tensor(t) and t.dtype == torch.int32 else t
                         for t in a)
            calls.setdefault((ctx, kname), []).append((kept, kw))
            return originals[kname](*a, **kw)
        return wrapped

    def captured_run(ctx, fn):
        for k in names:
            setattr(ops, k, capture(ctx, k))
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            for k, f in originals.items():
                setattr(ops, k, f)

    engine = ServingEngine(model, amsim, max_len=ring)
    caches = init_lm_caches(cfg, B, ring, dev)
    captured_run("prefill", lambda: engine.prefill(prompts, caches))
    _, nxt, caches = engine.prefill(prompts, init_lm_caches(cfg, B, ring, dev))
    captured_run("decode", lambda: engine.step(nxt, caches))
    long_engine = ServingEngine(model, amsim, max_len=LONG_RING)
    long_caches = init_lm_caches(cfg, B, LONG_RING, dev)
    _, nxt_l, long_caches = long_engine.prefill(prompts, long_caches)
    captured_run(f"decode, ring {LONG_RING}", lambda: long_engine.step(nxt_l, long_caches))

    plains = {"approx_attention": attn_mod.approx_attention_plain,
              "fused_qkv_norm": chain.fused_qkv_norm_plain,
              "fused_out_mlp": chain.fused_out_mlp_plain,
              "fused_attn_out_mlp": chain.fused_attn_out_mlp_plain}
    per = {}   # (ctx, kernel) -> (launches, ms, plain ms, bound ms, ops-bound?)
    print(f"serving kernels at the shapes of this run (device ms from CUDA events around 5 calls "
          f"queued behind a spin kernel, times the launches; {smi_line}):")
    for (ctx, kname), cl in sorted(calls.items()):
        args, kw = cl[0]
        fn = originals[kname]
        n = len(cl)
        if kname == "approx_gemm":
            # One time per distinct GEMM shape, times its launches.
            shapes = {}
            for a, k in cl:
                shapes.setdefault((tuple(a[0].shape), tuple(a[1].shape)), []).append((a, k))
            total = bound = 0.0
            for (sa, sb), same in shapes.items():
                a, k = same[0]
                t = queued_ms(lambda: fn(*a, **k), reps=5)
                total += t * len(same)
                nbytes, lookups = gemm_costs(a[0], a[1], a[2])
                tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
                bound += tb * len(same)
                print(f"  {ctx}: approx_gemm {sa}x{sb}: {t * len(same):.4f} ms over "
                      f"{len(same)} launches ({t:.4f} ms each), bound {tb * len(same):.4f} ms ("
                      f"{bound_kind(nbytes, lookups, lookups_per_s)}); "
                      f"{gemm_plan_text(a[0], a[1], a[2])}; {matmul_text(a[0], a[1])}")
            print(f"  {ctx}: approx_gemm: {total:.4f} ms over {n} launches, bound {bound:.4f} ms")
            per[(ctx, kname)] = (n, total, None, bound, None)
            continue
        t = queued_ms(lambda: fn(*args, **kw), reps=5)
        require(t > 0, f"no device time measured for {kname} in the {ctx}")
        nbytes, lookups = serving_costs(kname, args, kw, lut_bytes(args[LUT_ARG[kname]]))
        plain_kw = dict(kw)
        if kname in ("approx_attention", "fused_attn_out_mlp"):
            plain_kw.setdefault("causal", True)
            plain_kw.setdefault("window", 0)
        tp = cuda_ms(lambda: plains[kname](*args, **plain_kw), reps=1, warmup=0)
        tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
        ops_bound = lookups / lookups_per_s >= nbytes / HBM_BYTES_PER_S
        per[(ctx, kname)] = (n, t * n, tp * n, tb * n, ops_bound)
        if kname in ("fused_out_mlp", "fused_attn_out_mlp"):
            heads = cfg.n_heads if kname == "fused_attn_out_mlp" else 0
            grid = chain.back_half_grid(B, cfg.d_model, cfg.d_ff, args[LUT_ARG[kname]],
                                        heads=heads, kv_heads=cfg.n_kv_heads)
            print(f"  {ctx}: {kname} grid at {B} rows (work items a phase): {grid}")
        if kname == "fused_qkv_norm":
            print(f"  {ctx}: {kname} grid at {B} rows: {qkv_grid_of(args)}")
        print(f"  {ctx}: {kname}: {t * n:.4f} ms over {n} launches ({t:.4f} ms each), bound "
              f"{tb * n:.4f} ms ({'operations' if ops_bound else 'bytes'}: {nbytes} B, "
              f"{lookups} lookups a launch), plain {tp * n:.2f} ms")
    rows = []
    # The row's work: the kernel's launches in one full-depth prefill
    # (attention) or decode step (the chain kernels; the 3-launch form's
    # for fused_out_mlp).
    ctx_of = {"approx_attention": "prefill", "fused_qkv_norm": "decode",
              "fused_attn_out_mlp": "decode", "fused_out_mlp": f"decode, ring {LONG_RING}"}
    for kname, (src, replaces) in SERVE_SOURCES.items():
        require(serve_launches.get(kname, 0) > 0, f"{kname} never launched on the serving path")
        n, ms, plain_ms, bound, ops_bound = per[(ctx_of[kname], kname)]
        rows.append({"name": kname, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
                     "launches": serve_launches[kname], "max_abs_err": serve_err[kname],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "operations" if ops_bound else "bytes", "library_ms": None})
        print(f"kernel {kname} (replaces {replaces}): {ms:.4f} ms on device per full-depth "
              f"{ctx_of[kname]} over {n} launches, bound {bound:.4f} ms ({rows[-1]['bound_by']}), "
              f"plain {plain_ms:.2f} ms, max|d| {serve_err[kname]}; {serve_launches[kname]} "
              f"launches on the serving path (phases 4c and 5c); no PyTorch call computes a "
              f"LUT product, so no library time")
    del model, engine, long_engine, caches, long_caches, calls
    torch.cuda.empty_cache()
    return rows


def gemm_costs(a, b, lut, live_rows=None, live_batches=None):
    """(bytes, lookups) of a (batched) LUT GEMM a (..., m, k) @ b (..., k,
    n): each input read once and the output written once.  ``live_rows``
    (rows of a that are not all zero) and ``live_batches`` (batch elements
    with such a row) count what the data needs: a zero row of a costs no
    lookups and its batch element's b need not be read."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = a.numel() // (m * k)
    rows = batch * m if live_rows is None else live_rows
    batches = batch if live_batches is None else live_batches
    from repro_torch.kernels.common import lut_bytes
    return 4 * (rows * k + batches * k * n + batch * m * n) + lut_bytes(lut), rows * k * n


def gemm_plan_text(a, b, lut) -> str:
    """The launch plan of approx_gemm(_batched)(a, b, lut) and the grid the
    launch gives it, and for a batched product the row tiles that hold a
    live row."""
    from repro_torch.kernels import approx_gemm as gemm_mod
    batch = a.shape[0] if a.ndim == 3 else 1
    m, n = a.shape[-2], b.shape[-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = gemm_mod.gemm_plan(batch, m, a.shape[-1], n, lut, sms)
    grid = gemm_mod.gemm_grid(plan, batch, m, n, lut)
    text = (f"plan: {plan}; grid {grid['blocks']} blocks on {sms} SMs, {grid['smem']} B "
            f"shared a block")
    if a.ndim == 3:
        live_tiles, total = gemm_mod.live_row_tiles(a, plan)
        text += f"; {live_tiles} of {total} row tiles live"
    return text


def matmul_text(a, b) -> str:
    """Device time of exact-fp32 torch.matmul at the GEMM's shape."""
    require(not torch.backends.cuda.matmul.allow_tf32, "torch.matmul would run in TF32")
    t = queued_ms(lambda: torch.matmul(a, b), reps=5)
    return f"exact-fp32 torch.matmul {t:.4f} ms (another function: no LUT)"


def bound_kind(nbytes, lookups, lookups_per_s) -> str:
    return "operations" if lookups / lookups_per_s >= nbytes / HBM_BYTES_PER_S else "bytes"


def live(t) -> tuple[int, int]:
    """(rows of the last dim that are not all zero, leading batch elements
    holding such a row) of a (B, rows, n) tensor: the capacity rows that
    hold a token, and the experts that hold one."""
    nz = (t != 0).any(dim=-1)
    return int(nz.sum()), int(nz.any(dim=-1).sum())


def moe_costs(kname, args, kw):
    """(bytes, lookups) of one call of an MoE serving kernel, counting what
    this run's data needs (only capacity rows that hold a token)."""
    from repro_torch.kernels.common import lut_bytes
    if kname == "approx_gemm_batched":
        a, b, lut = args[:3]
        rows, batches = live(a)
        return gemm_costs(a, b, lut, rows, batches)
    if kname == "fused_wo_norm":
        x, attn, g2, wo, lut = args[:5]
        bo = kw.get("bo")
        n_in = sum(t.numel() for t in (x, attn, g2, wo, bo) if t is not None)
        return 4 * (n_in + 2 * x.numel()) + lut_bytes(lut), x.shape[0] * wo.numel()
    h, wg, wu, wd, lut = args[:5]
    rows, experts = live(h)
    E, C, d = h.shape
    F = wg.shape[-1]
    return (4 * (rows * d + experts * 3 * d * F + E * C * d) + lut_bytes(lut),
            rows * 3 * d * F)


def moe_counters():
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import approx_gemm as gemm_mod
    from repro_torch.kernels import decode_chain as chain
    return {"approx_gemm": gemm_mod.approx_gemm,
            "approx_gemm_batched": gemm_mod.approx_gemm_batched,
            "approx_attention": attn_mod.approx_attention, "fused_qkv_norm": chain.fused_qkv_norm,
            "fused_wo_norm": chain.fused_wo_norm, "fused_moe_ffn": chain.fused_moe_ffn}


def moe_want(L: int, *, prefill: bool, steps: int, batched: bool = False) -> dict:
    """Launches of a prefill (or none) and ``steps`` decode steps of an L-layer
    MoE stack under amsim."""
    pre = int(prefill)
    return {"approx_gemm": (5 * L + 1) * pre + (L + 1) * steps,
            "approx_gemm_batched": 3 * L * pre if batched else 0,
            "approx_attention": L * (pre + steps), "fused_qkv_norm": L * steps,
            "fused_wo_norm": L * steps,
            "fused_moe_ffn": L * (pre * (not batched) + steps)}


def zero_launches(counters):
    for fn in counters.values():
        fn.launches = 0


def launches_of(counters) -> dict:
    return {k: fn.launches for k, fn in counters.items()}


def moe_kernel_checks(dev, gen, lut_case) -> dict:
    """Phase 3e: the three MoE serving kernels against their plain versions
    at granite-moe-3b-a800m's full width, under ``FORM_LUTS``; returns each
    one's largest |difference|."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import approx_gemm as gemm_mod
    from repro_torch.kernels import decode_chain as chain
    cfg = get_arch(MOE_ARCH)
    d, K, E, F = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.moe.n_experts, cfg.moe.d_ff

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen).to(dev) * scale

    err = {k: 0.0 for k in (*MOE_SOURCES, "approx_gemm")}

    def held(name, out, ref, what):
        """Bit for bit: +0.0 and -0.0 differ here."""
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        e = max((a - b).abs().max().item() for a, b in zip(outs, refs))
        require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(outs, refs)), f"{name} {what}: max|d|={e}")
        err[name] = max(err[name], e)

    routed = routed_decode_buffer(dev, gen, cfg)
    live = chain.live_rows(routed)
    dead_rows = randn(E, 64, d)
    tiny = (torch.randn((64, d), generator=gen) * 1e-39).to(dev)      # subnormal
    dead_rows[0] = -tiny                          # expert 0: every row dead (inf/NaN banks)
    dead_rows[1:, 1::4] = 0.0
    dead_rows[1:, 2::4] = -0.0
    dead_rows[1:, 3::4] = tiny[3::4]

    for i, (lut_name, packed) in enumerate(FORM_LUTS):
        lut, M = lut_case(lut_name, packed)
        tag = f"{lut_name} {'packed' if packed else 'canonical'}"
        C = MOE_CHECK_C[min(i, 1)]
        for B, m, k, n in ((E, C, d, F), (E, C, F, d), (3, 67, 130, 33)):
            a, b = randn(B, m, k), randn(B, k, n, scale=k ** -0.5)
            held("approx_gemm_batched", gemm_mod.approx_gemm_batched(a, b, lut, M),
                 gemm_mod.approx_gemm_batched_plain(a, b, lut, M), f"{tag} {(B, m, k, n)}")
        # Dead tail rows as moe_ffn leaves them; expert 0 all dead, inf/NaN in its B.
        a, b = randn(E, C, d), randn(E, d, F, scale=d ** -0.5)
        tail = torch.zeros((C, d), device=dev)
        tail[1::3], tail[2::3] = -0.0, tiny[0]
        for e, n_live in enumerate(torch.randint(0, C, (E,), generator=gen).tolist()):
            a[e, n_live:] = tail[n_live:]
        a[0] = tail
        b[0, ::3], b[0, 1::3], b[0, 2::3] = float("inf"), float("nan"), -float("inf")
        held("approx_gemm_batched", gemm_mod.approx_gemm_batched(a, b, lut, M),
             gemm_mod.approx_gemm_batched_plain(a, b, lut, M), f"{tag} dead tail rows")
        print(f"{tag}: approx_gemm_batched {(E, C, d, F)} with dead tail rows "
              f"{gemm_plan_text(a, b, lut)}")
        del a, b
        a, b = randn(4, d), randn(d, E, scale=d ** -0.5)
        held("approx_gemm", gemm_mod.approx_gemm(a, b, lut, M),
             gemm_mod.approx_gemm_plain(a, b, lut, M), f"{tag} router {(4, d, E)}")
        print(f"{tag}: approx_gemm router {(4, d, E)} {gemm_plan_text(a, b, lut)}")
        x, attn = randn(4, d), randn(4, K, scale=0.3)
        g2, wo, bo = 1 + 0.1 * randn(d), randn(K, d, scale=K ** -0.5), 0.1 * randn(d)
        for bias in ({}, {"bo": bo}):
            held("fused_wo_norm", chain.fused_wo_norm(x, attn, g2, wo, lut, M, eps=cfg.norm_eps,
                                                      **bias),
                 chain.fused_wo_norm_plain(x, attn, g2, wo, lut, M, eps=cfg.norm_eps, **bias),
                 f"{tag} 4 rows {'with' if bias else 'without'} bo")
        print(f"{tag}: fused_wo_norm (4, {d}) x ({K}, {d}) grid {chain.wo_norm_grid(4, d, lut)} "
              f"(cooperative blocks, wo items of 8 columns)")
        banks = (randn(E, d, F, scale=d ** -0.5), randn(E, d, F, scale=d ** -0.5),
                 randn(E, F, d, scale=F ** -0.5))
        for C in (8, 64):
            h = randn(E, C, d)
            held("fused_moe_ffn", chain.fused_moe_ffn(h, *banks, lut, M),
                 chain.fused_moe_ffn_plain(h, *banks, lut, M), f"{tag} C={C}")
        held("fused_moe_ffn", chain.fused_moe_ffn(routed, *banks, lut, M),
             chain.fused_moe_ffn_plain(routed, *banks, lut, M), f"{tag} routed decode buffer")
        bad = [b.clone() for b in banks]
        for b in bad:
            b[0, ::3], b[0, 1::3], b[0, 2::3] = float("inf"), float("nan"), -float("inf")
        held("fused_moe_ffn", chain.fused_moe_ffn(dead_rows, *bad, lut, M),
             chain.fused_moe_ffn_plain(dead_rows, *bad, lut, M), f"{tag} dead rows")
        del bad
        print(f"MoE serving kernels == plain (bitwise): {tag} LUT at {MOE_ARCH} widths: batched "
              f"GEMM ({E}, {C}, {d})x({E}, {d}, {F}) (also with dead tail rows), ({E}, {C}, "
              f"{F})x({E}, {F}, {d}) and (3, 67, 130)x(3, 130, 33), the router GEMM; wo+norm "
              f"at 4 rows with and without bo; expert banks at C=8, 64, "
              f"on the buffer moe_ffn scatters for a decode step of 4 tokens ({int(live.sum())} "
              f"live rows in {int((live > 0).sum())} of {E} banks) and at C=64 with "
              f"{int((chain.live_rows(dead_rows) == 0).sum())} all-dead expert (inf/NaN banks) and "
              f"zero, -0.0 and subnormal rows between live ones in the others")
    return err


def routed_decode_buffer(dev, gen, cfg):
    """The capacity buffer ``moe.moe_ffn`` scatters at ``cfg``'s widths for a
    decode step of 4 tokens (C = 8), with a random router."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.kernels.time_chain import routed_buffer
    d, E = cfg.d_model, cfg.moe.n_experts
    h = routed_buffer(cfg, (torch.randn((d, E), generator=gen) * d ** -0.5).to(dev),
                      torch.randn((1, 4, d), generator=gen).to(dev),
                      NumericsPolicy(mode="amsim", multiplier="afm16"))
    require(h.shape == (E, 8, d), f"moe_ffn scattered a buffer of {tuple(h.shape)}, want "
            f"{(E, 8, d)}")
    return h


def moe_serving_depth2(dev, moe_launches: dict):
    """Phase 4d: depth 2 at full width, amsim bitwise amsim_torch for a
    short prefill and decode and for a 2 x 520 prefill, with launch counts.
    Of the long prefill, the stack's output (after the final norm) is held
    bitwise between the two modes, and the tied head (1040 x 1536 x 49155,
    ~79 G plain lookups) under amsim bitwise its plain version on
    ``held_columns``; the engine's amsim logits are that head's output."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.core.multipliers import get_multiplier
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.kernels import ops
    from repro_torch.kernels.approx_gemm import approx_gemm, approx_gemm_plain
    from repro_torch.models.moe import capacity as moe_capacity
    from repro_torch.models.transformer import _final_hidden, init_lm, init_lm_caches
    from repro_torch.serve.engine import ServingEngine
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_DEPTH2["n_layers"])

    def long_caches():
        return init_lm_caches(cfg, MOE_DEPTH2_LONG["batch"], MOE_DEPTH2_LONG["prompt"], dev)

    require(moe_capacity(cfg, MOE_DEPTH2_LONG["batch"] * MOE_DEPTH2_LONG["prompt"])
            > ops.MOE_FFN_MAX_C, f"4d: {MOE_DEPTH2_LONG} does not take the batched route")
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    cpu_gen = torch.Generator().manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (MOE_DEPTH2["batch"], MOE_DEPTH2["prompt"]),
                            generator=cpu_gen).to(dev)
    long_prompts = torch.randint(0, cfg.vocab, (MOE_DEPTH2_LONG["batch"],
                                                MOE_DEPTH2_LONG["prompt"]), generator=cpu_gen).to(dev)
    counters = moe_counters()
    L, ring, steps = cfg.n_layers, MOE_DEPTH2["ring"], MOE_DEPTH2["new"] - 1
    want = moe_want(L, prefill=True, steps=steps)
    want_long = moe_want(L, prefill=True, steps=0, batched=True)
    results = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("amsim", "amsim_torch"):
            policy = NumericsPolicy(mode=mode, multiplier="afm16")
            engine = ServingEngine(model, policy, max_len=ring)
            zero_launches(counters)
            toks, logits = engine.generate(prompts, MOE_DEPTH2["new"], return_logits=True)
            torch.cuda.synchronize()
            got = launches_of(counters)
            full, _, _ = engine.prefill(prompts, init_lm_caches(cfg, prompts.shape[0], ring, dev))
            zero_launches(counters)
            long_logits = (ServingEngine(model, policy, max_len=MOE_DEPTH2_LONG["prompt"]).prefill(
                long_prompts, long_caches())[0] if mode == "amsim" else None)
            torch.cuda.synchronize()
            got_long = launches_of(counters)
            with torch.no_grad():
                hidden = _final_hidden(model, long_prompts, policy, None, long_caches(),
                                       cfg.sliding_window, False)[0]
            results[mode] = (toks, logits, full, long_logits, hidden)
            if mode == "amsim":
                require(got == want, f"{MOE_ARCH} depth-2 serving: launches {got}, want {want}")
                require(got_long == want_long, f"{MOE_ARCH} depth-2 prefill of {MOE_DEPTH2_LONG}: "
                        f"launches {got_long}, want {want_long}")
                for k in counters:
                    moe_launches[k] = moe_launches.get(k, 0) + got[k] + got_long[k]
                launches = (got, got_long)
    except RuntimeError as e:
        if "deterministic" in str(e):
            raise SystemExit(f"chip_smoke FAILED: MoE serving has an op without a deterministic "
                             f"CUDA implementation: {e}")
        raise
    finally:
        torch.use_deterministic_algorithms(False)
    (t_a, l_a, f_a, g_a, h_a), (t_p, l_p, f_p, _, h_p) = results["amsim"], results["amsim_torch"]
    require(all(bool(torch.isfinite(v).all()) for v in (l_a, f_a, g_a)),
            f"{MOE_ARCH} depth-2 serving: logits not finite")
    require(torch.equal(f_a, f_p), f"{MOE_ARCH} depth-2 prefill logits: amsim differs from "
            f"amsim_torch by {(f_a - f_p).abs().max().item()}")
    require(torch.equal(l_a, l_p) and torch.equal(t_a, t_p),
            f"{MOE_ARCH} depth-2 decode: amsim differs from amsim_torch (logits max|d| "
            f"{(l_a - l_p).abs().max().item()}, tokens equal {torch.equal(t_a, t_p)})")
    require(_same([h_a], [h_p]), f"{MOE_ARCH} depth-2 prefill of {MOE_DEPTH2_LONG}: the stack's "
            f"output under amsim differs from amsim_torch by {(h_a - h_p).abs().max().item()}")
    h2, head = h_a.reshape(-1, cfg.d_model), model.embed.transposed()
    lut, M = ops._amsim_lut(get_multiplier("afm16"), dev), get_multiplier("afm16").mantissa_bits
    same, held = held_against_plain("approx_gemm", approx_gemm, approx_gemm_plain,
                                    (h2, head, lut, M), {})
    require(same and _same([g_a.reshape(h2.shape[0], -1)], [approx_gemm(h2, head, lut, M)]),
            f"{MOE_ARCH} depth-2 prefill of {MOE_DEPTH2_LONG}: the head's kernel differs from "
            f"its plain version ({held}) or from the engine's logits")
    print(f"{MOE_ARCH} depth {L}, batch {MOE_DEPTH2['batch']}, prompt {MOE_DEPTH2['prompt']}, "
          f"{MOE_DEPTH2['new']} new tokens, ring {ring}: prefill logits (capacity 8), {steps} "
          f"decode steps' logits and tokens bitwise equal to amsim_torch; amsim launches "
          f"{launches[0]}; tokens {t_a[0].tolist()}")
    print(f"{MOE_ARCH} depth {L}, prefill of {MOE_DEPTH2_LONG['batch']} x "
          f"{MOE_DEPTH2_LONG['prompt']} tokens (capacity "
          f"{moe_capacity(cfg, MOE_DEPTH2_LONG['batch'] * MOE_DEPTH2_LONG['prompt'])}: the "
          f"batched route): the stack's output bitwise equal to amsim_torch, the head "
          f"(logits {tuple(g_a.shape)}) bitwise its plain version on {held}; amsim launches "
          f"{launches[1]}")
    del model, results
    torch.cuda.empty_cache()


def expert_banks_at_long_capacity(model, cfg, policy, calls, smi_line):
    """The two routes of layer 0's expert FFN on the 4 x 512 prefill's
    capacity buffer (C = 512): the expert-bank kernel against the three
    batched GEMMs (``mlp.ffn``, the route taken above ``ops.MOE_FFN_MAX_C``),
    same bits, device time of each."""
    from repro_torch.kernels import decode_chain as chain
    from repro_torch.kernels import ops
    from repro_torch.models.mlp import ffn
    ctx = f"prefill {MOE_LONG['batch']}x{MOE_LONG['prompt']}"
    (buf, _, lut, M), _, _ = next(v for (c, k, _), v in calls.items()
                                  if c == ctx and k == "approx_gemm_batched"
                                  and v[0][0].shape[-1] == cfg.d_model)
    ew = model.layers[0].moe["experts"]
    banks = [ew[n].w for n in ("wg", "wu", "wd")]
    with torch.no_grad():
        fused = chain.fused_moe_ffn(buf, *banks, lut, M)
        batched = ffn(ew, buf, policy, cfg.act)
    require(torch.equal(fused.view(torch.int32), batched.view(torch.int32)),
            f"expert banks at C={buf.shape[1]}: the kernel differs from the batched GEMMs by "
            f"{(fused - batched).abs().max().item()}")
    live = chain.live_rows(buf)
    with torch.no_grad():
        t_fused = queued_ms(lambda: chain.fused_moe_ffn(buf, *banks, lut, M), reps=3)
        t_batched = queued_ms(lambda: ffn(ew, buf, policy, cfg.act), reps=3)
    print(f"  {ctx}: layer 0's expert FFN at C={buf.shape[1]} ({int(live.sum())} live rows of "
          f"{buf.shape[0] * buf.shape[1]}; routes split at MOE_FFN_MAX_C = {ops.MOE_FFN_MAX_C}): "
          f"expert-bank kernel {t_fused:.4f} ms, three batched GEMMs {t_batched:.4f} ms, same "
          f"bits ({smi_line})")


def moe_serving_full_depth(dev, lookups_per_s, smi_line, moe_launches, moe_err) -> list:
    """Phase 5d: granite-moe-3b-a800m at full width and depth, amsim and
    native; returns the three MoE kernels' JSON rows."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.kernels import approx_gemm as gemm_mod
    from repro_torch.kernels import decode_chain as chain
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import lut_bytes
    from repro_torch.models.transformer import init_lm, init_lm_caches
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.kernels import approx_attention as attn_mod
    cfg = get_arch(MOE_ARCH)
    L, B, P, N = cfg.n_layers, MOE_FULL["batch"], MOE_FULL["prompt"], MOE_FULL["new"]
    ring = P + N
    t0 = time.perf_counter()
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    weight_bytes = 4 * sum(p.numel() for p in model.parameters())
    print(f"{MOE_ARCH} at full width and depth ({L} layers, {weight_bytes / 1e9:.2f} GB of float32 "
          f"weights) drawn on the card in {time.perf_counter() - t0:.1f} s; batch {B}, prompt {P}, "
          f"{N} new tokens, ring {ring} ({smi_line}):")
    cpu_gen = torch.Generator().manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=cpu_gen).to(dev)
    long_prompts = torch.randint(0, cfg.vocab, (MOE_LONG["batch"], MOE_LONG["prompt"]),
                                 generator=cpu_gen).to(dev)
    counters = moe_counters()
    amsim = NumericsPolicy(mode="amsim", multiplier="afm16")
    res = {}
    for pname, policy in (("native", NumericsPolicy()), ("amsim", amsim)):
        engine = ServingEngine(model, policy, max_len=ring)
        engine.generate(prompts, 2)          # warm-up: LUT upload, library handles
        zero_launches(counters)
        timings = {}
        toks = engine.generate(prompts, N, timings=timings)
        got = launches_of(counters)
        if pname == "amsim":
            want = moe_want(L, prefill=True, steps=N - 1)
            require(got == want, f"{MOE_ARCH} full-depth serving: launches {got}, want {want}")
            for k, n in got.items():
                moe_launches[k] = moe_launches.get(k, 0) + n
        require(toks.shape == (B, N) and bool((toks >= 0).all() & (toks < cfg.vocab).all()),
                f"{MOE_ARCH} full-depth {pname}: tokens out of range")
        caches = init_lm_caches(cfg, B, ring, dev)
        _, nxt, caches = engine.prefill(prompts, caches)
        busy_step = busy_ms(lambda: engine.step(nxt, caches), reps=3)
        busy_pre = busy_ms(lambda: engine.prefill(prompts, init_lm_caches(cfg, B, ring, dev)),
                           reps=1)
        pre_ms = timings["prefill_s"] * 1e3
        step_ms = timings["decode_s"] * 1e3 / timings["decode_steps"]
        # The long prefill: capacity 512, the expert FFN as three batched GEMMs.
        long_engine = ServingEngine(model, policy, max_len=MOE_LONG["prompt"])
        long_caches = init_lm_caches(cfg, MOE_LONG["batch"], MOE_LONG["prompt"], dev)
        zero_launches(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        long_logits, _, _ = long_engine.prefill(long_prompts, long_caches)
        torch.cuda.synchronize()
        long_ms = (time.perf_counter() - t0) * 1e3
        got = launches_of(counters)
        if pname == "amsim":
            want = moe_want(L, prefill=True, steps=0, batched=True)
            require(got == want, f"{MOE_ARCH} full-depth prefill of {MOE_LONG}: launches {got}, "
                    f"want {want}")
            for k, n in got.items():
                moe_launches[k] = moe_launches.get(k, 0) + n
        require(bool(torch.isfinite(long_logits).all()), f"{MOE_ARCH} long prefill {pname}: "
                f"logits not finite")
        del long_logits, long_caches
        res[pname] = (pre_ms, step_ms, long_ms)
        print(f"  {pname}: prefill {pre_ms:.2f} ms ({busy_text(busy_pre, pre_ms)}), "
              f"{step_ms:.3f} ms per decode step ({busy_text(busy_step, step_ms)}), "
              f"{B * N / (timings['prefill_s'] + timings['decode_s']):.2f} tokens/s; prefill of "
              f"{MOE_LONG['batch']} x {MOE_LONG['prompt']} tokens {long_ms:.2f} ms; tokens "
              f"{toks[0, :8].tolist()}")
    print(f"  amsim/native: prefill {res['amsim'][0] / res['native'][0]:.2f}x, decode step "
          f"{res['amsim'][1] / res['native'][1]:.2f}x, prefill of {MOE_LONG['batch']} x "
          f"{MOE_LONG['prompt']} {res['amsim'][2] / res['native'][2]:.2f}x")

    # Each kernel of the path at the shapes of this run: keep the first call
    # of every distinct shape and count the calls, in an amsim prefill, a
    # decode step and the long prefill.  The MoE kernels are also held
    # against their plain versions' time; the others are timed for the
    # breakdown only (their rows come from phases 5b and 5c).
    names = ["approx_gemm", "approx_attention", "fused_qkv_norm", *MOE_SOURCES]
    originals = {k: getattr(ops, k) for k in names}
    calls = {}   # (ctx, kernel, shapes) -> [args, kw, count]

    def capture(ctx, kname):
        def wrapped(*a, **kw):
            key = (ctx, kname, tuple(tuple(t.shape) for t in a if torch.is_tensor(t)))
            if key not in calls:
                kept = tuple(t.clone() if torch.is_tensor(t) and t.dtype == torch.int32 else t
                             for t in a)
                calls[key] = [kept, kw, 0]
            calls[key][2] += 1
            return originals[kname](*a, **kw)
        return wrapped

    def captured_run(ctx, fn):
        for k in names:
            setattr(ops, k, capture(ctx, k))
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            for k, f in originals.items():
                setattr(ops, k, f)

    engine = ServingEngine(model, amsim, max_len=ring)
    captured_run("prefill", lambda: engine.prefill(prompts, init_lm_caches(cfg, B, ring, dev)))
    _, nxt, caches = engine.prefill(prompts, init_lm_caches(cfg, B, ring, dev))
    captured_run("decode", lambda: engine.step(nxt, caches))
    long_engine = ServingEngine(model, amsim, max_len=MOE_LONG["prompt"])
    captured_run(f"prefill {MOE_LONG['batch']}x{MOE_LONG['prompt']}", lambda: long_engine.prefill(
        long_prompts, init_lm_caches(cfg, MOE_LONG["batch"], MOE_LONG["prompt"], dev)))

    plains = {"approx_gemm": gemm_mod.approx_gemm_plain,
              "approx_gemm_batched": gemm_mod.approx_gemm_batched_plain,
              "fused_wo_norm": chain.fused_wo_norm_plain,
              "fused_moe_ffn": chain.fused_moe_ffn_plain}
    per = {}   # (ctx, kernel) -> [launches, ms, plain ms, bound ms, bytes s, lookups s]
    print(f"MoE serving kernels at the shapes of this run (device ms from CUDA events around 5 "
          f"calls queued behind a spin kernel, times the launches; bounds count the capacity rows "
          f"that hold a token; {smi_line}):")
    for (ctx, kname, shapes), (args, kw, n) in calls.items():
        fn = originals[kname]
        t = queued_ms(lambda: fn(*args, **kw), reps=5)
        require(t > 0, f"no device time measured for {kname} in the {ctx}")
        tp = 0.0
        if kname == "approx_gemm":
            nbytes, lookups = gemm_costs(*args[:3])
        elif kname in LUT_ARG:
            nbytes, lookups = serving_costs(kname, args, kw, lut_bytes(args[LUT_ARG[kname]]))
        else:
            nbytes, lookups = moe_costs(kname, args, kw)
            tp = cuda_ms(lambda: plains[kname](*args, **kw), reps=1, warmup=0)
        tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
        acc = per.setdefault((ctx, kname), [0, 0.0, 0.0, 0.0, 0.0, 0.0])
        for i, v in enumerate((n, t * n, tp * n, tb * n, n * nbytes / HBM_BYTES_PER_S,
                               n * lookups / lookups_per_s)):
            acc[i] += v
        extra = f", plain {tp * n:.2f} ms" if kname in MOE_SOURCES else ""
        if kname in ("approx_gemm", "approx_gemm_batched"):
            extra += f"; {gemm_plan_text(*args[:3])}; {matmul_text(*args[:2])}"
        if kname == "fused_qkv_norm":
            extra += f"; grid {qkv_grid_of(args)}"
        if kname == "fused_wo_norm":
            extra += f"; grid {chain.wo_norm_grid(*args[0].shape, args[4])}"
        if kname == "fused_moe_ffn":
            h = args[0]
            live = chain.live_rows(h)
            grid = chain.moe_ffn_grid(*h.shape, args[1].shape[-1], args[4], live=live.tolist())
            extra += (f"; layer 0: {int(live.sum())} live rows of {h.shape[0] * h.shape[1]} in "
                      f"{int((live > 0).sum())} of {h.shape[0]} banks, grid {grid}")
        print(f"  {ctx}: {kname} {list(shapes)}: {t * n:.4f} ms over {n} launches ({t:.4f} ms "
              f"each), bound {tb * n:.4f} ms ({bound_kind(nbytes, lookups, lookups_per_s)}: "
              f"{nbytes} B, {lookups} lookups a launch){extra}")
    for (ctx, kname), (n, ms, tp, tb, _, _) in sorted(per.items()):
        print(f"  {ctx}: {kname}: {ms:.4f} ms over {n} launches, bound {tb:.4f} ms"
              + (f", plain {tp:.2f} ms" if kname in MOE_SOURCES else ""))
    long_ctx = f"prefill {MOE_LONG['batch']}x{MOE_LONG['prompt']}"
    n, ms, _, tb, _, _ = per[(long_ctx, "approx_attention")]
    a = next(a for (c, kn, _), (a, _, _) in calls.items()
             if c == long_ctx and kn == "approx_attention")
    plan = attn_mod.attention_plan(attn_mod.attention_shape(a[0].shape, a[1].shape),
                                   a[LUT_ARG["approx_attention"]],
                                   torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"  attention of the {long_ctx}: {ms:.4f} ms over {n} launches ({ms / n:.4f} ms each), "
          f"bound {tb:.4f} ms; plan {plan} ({smi_line})")
    expert_banks_at_long_capacity(model, cfg, amsim, calls, smi_line)
    rows = []
    # The row's work: the kernel's launches in one full-depth decode step
    # (the chain kernels) or one full-depth prefill of 4 x 512 tokens (the
    # batched GEMM).
    ctx_of = {"approx_gemm_batched": f"prefill {MOE_LONG['batch']}x{MOE_LONG['prompt']}",
              "fused_wo_norm": "decode", "fused_moe_ffn": "decode"}
    for kname, (src, replaces) in MOE_SOURCES.items():
        require(moe_launches.get(kname, 0) > 0, f"{kname} never launched on the MoE serving path")
        n, ms, plain_ms, bound, bytes_s, ops_s = per[(ctx_of[kname], kname)]
        rows.append({"name": kname, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
                     "launches": moe_launches[kname], "max_abs_err": moe_err[kname],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "operations" if ops_s >= bytes_s else "bytes",
                     "library_ms": None})
        print(f"kernel {kname} (replaces {replaces}): {ms:.4f} ms on device per full-depth "
              f"{ctx_of[kname]} over {n} launches, bound {bound:.4f} ms ({rows[-1]['bound_by']}), "
              f"plain {plain_ms:.2f} ms, max|d| {moe_err[kname]}; {moe_launches[kname]} launches "
              f"on the MoE serving path (phases 4d and 5d); no PyTorch call computes a LUT "
              f"product, so no library time")
    del model, engine, long_engine, caches, calls
    torch.cuda.empty_cache()
    return rows


# A GEMM launch of more lookups than this (an LM head at 256 training rows)
# is held against its plain version on a set of its output columns that
# reaches every lane of the launch's tiles and the ragged edge: the first
# and the last output tile of its plan, and every HELD_COLUMN_STRIDE-th
# column (odd, so coprime to every tile width and to a thread's 1 or 2
# register columns).  The kernel's output is the path's own launch; the
# plain version runs on those columns of b (an output column depends on its
# column of b alone).  An expert-bank launch of more lookups is held on the
# first live row of each expert that holds one (an output row depends on
# its row of h alone), and on +0.0 at every dead row.
HELD_COLUMNS_MIN = 1e10
HELD_COLUMN_STRIDE = 13


def held_columns(batch: int, m: int, k: int, n: int, lut,
                 stride: int = HELD_COLUMN_STRIDE) -> tuple[list, str]:
    """(the output columns held of a GEMM of ``batch`` (m, k) @ (k, n), what
    they are): the first and last output tiles and every ``stride``-th
    column (odd)."""
    from repro_torch.kernels import approx_gemm as gemm_mod
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tn = gemm_mod.gemm_plan(batch, m, k, n, lut, sms).tile[1]
    last = (n - 1) // tn * tn
    cols = sorted(set(range(min(tn, n))) | set(range(last, n)) | set(range(0, n, stride)))
    return cols, (f"{len(cols)} of {n} columns: the first tile's {min(tn, n)}, the last "
                  f"tile's {n - last} and every {stride}th")


@torch.no_grad()
def held_against_plain(kname, fn, plain, args, kw, min_lookups=HELD_COLUMNS_MIN,
                       stride=HELD_COLUMN_STRIDE):
    """(the kernel's output bitwise its plain version, as int32 views; what
    was held) of one call: a GEMM (2-D or batched) of more than
    ``min_lookups`` lookups on ``held_columns`` (every ``stride``-th
    column), an expert-bank launch of more on the first live row of each
    live expert and +0.0 at every dead row, any other call whole."""
    out = fn(*args, **kw)
    if kname.startswith("approx_gemm") and gemm_costs(*args[:3])[1] > min_lookups:
        a, b, lut, *rest = args
        cols, what = held_columns(a.shape[0] if a.ndim == 3 else 1, *a.shape[-2:], b.shape[-1],
                                  lut, stride)
        idx = torch.tensor(cols, device=b.device)
        # detached: a captured b may be a view of a parameter that the
        # optimizer has since updated in place (the tied head's emb.T)
        ref = plain(a, b.detach().index_select(-1, idx).contiguous(), lut, *rest, **kw)
        out = out.index_select(-1, idx)
    elif kname == "fused_moe_ffn" and moe_costs(kname, args, kw)[1] > min_lookups:
        from repro_torch.kernels.common import live_elements
        h = args[0]
        live_rows = live_elements(h).any(dim=-1)                  # (E, C)
        experts = torch.nonzero(live_rows.any(dim=1))[:, 0]
        held = torch.zeros_like(live_rows)
        held[experts, live_rows.to(torch.float32).argmax(dim=1)[experts]] = True
        ref = plain(h.masked_fill(~held[..., None], 0.0), *args[1:], **kw)
        dead_zero = not bool(out[~live_rows].view(torch.int32).any())
        return (dead_zero and torch.equal(out[held].view(torch.int32), ref[held].view(torch.int32)),
                f"the first live row of each of its {len(experts)} live experts (of "
                f"{int(live_rows.sum())} live rows), and +0.0 at every dead row")
    else:
        ref = plain(*args, **kw)
        what = "every output"
    return torch.equal(out.contiguous().view(torch.int32), ref.view(torch.int32)), what


# ------------------------------------------------------------ LM training
TRAIN_LR = 3e-4
TRAIN_FULL = dict(batch=4, seq=64, steps=2)          # the schedule spans these 2 steps
# 5e's resume and 6a's depth-2 runs: one row of 8 tokens, 2 steps (the plain
# versions' cost grows with the rows).
TRAIN_DEPTH2 = dict(n_layers=2, batch=1, seq=8, steps=2)
# 5e's granite-moe step bitwise amsim_torch: one MoE layer, one row of 8.
TRAIN_MOE1 = dict(n_layers=1, batch=1, seq=8, steps=1)
TRAIN_ARCHS = (LM_ARCH, MOE_ARCH)
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"        # .gitignore lists build/


def train_counters():
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import approx_gemm as gemm_mod
    from repro_torch.kernels import decode_chain as chain
    return {"approx_gemm": gemm_mod.approx_gemm,
            "approx_gemm_batched": gemm_mod.approx_gemm_batched,
            "approx_attention": attn_mod.approx_attention, "fused_moe_ffn": chain.fused_moe_ffn}


def train_want(cfg, seq: int) -> dict:
    """Launches of one LM training step under amsim with remat
    (tests/test_torch_cuda.py ``lm_train_launches``): a dense layer's 7
    GEMMs forward, 7 recomputed and 14 backward, attention forward and
    recomputed, 6 batched GEMMs for each query chunk of its backward (one
    up to 1024 positions: ``_bwd_chunks``); an MoE layer's 5 GEMMs
    likewise (and a shared expert's 3), the expert banks twice and 9
    batched GEMMs for their backward; the head's 3 GEMMs.  A llama4 stack
    has a dense layer and an MoE layer a pair."""
    moe = 0 if cfg.moe is None else cfg.n_layers // cfg.moe.interleave
    dense = cfg.n_layers - moe
    shared = 12 if cfg.moe is not None and cfg.moe.n_shared_experts else 0
    chunks = _bwd_chunks(seq)
    return {"approx_gemm": 28 * dense + (20 + shared) * moe + 3,
            "approx_gemm_batched": 6 * chunks * dense + (9 + 6 * chunks) * moe,
            "approx_attention": 2 * (dense + moe), "fused_moe_ffn": 2 * moe}


def train_setup(cfg, policy, dev, seed=SEED):
    """(model, optimizer state, step) of ``launch.train``'s step builder."""
    from repro_torch.launch.train import make_lm_train_step
    from repro_torch.models.encdec import init_encdec
    from repro_torch.models.transformer import init_lm
    init = init_encdec if cfg.family == "encdec" else init_lm
    model = init(cfg, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt, step = make_lm_train_step(cfg, policy, lr=TRAIN_LR, steps=TRAIN_FULL["steps"])
    return model, opt.init(dict(model.named_parameters())), step


def train_fits(cfg) -> tuple[bool, str]:
    """Whether a full-width training step of ``cfg`` fits the card's free
    memory, by what its peak holds.  Under adamw: five copies of the
    parameters (parameters, gradients, two moments and the updates; the
    clip briefly holds two of the gradients) and five of the largest leaf
    (the temporaries of its update, whose root is taken in float64).  Under
    adafactor: three copies (parameters, clipped gradients, updates), two
    more of every tensor that a JAX leaf stacks (the update stacks the
    gradients and the parameters of each such leaf, ``lm_stacks``, even a
    stack of one layer) and one of the largest leaf (its update's
    temporary).  Plus 4 GB for activations, the logits and the allocator.
    Free is the card's free memory and what the allocator holds unused (a
    small live tensor can keep a freed segment of gigabytes reserved)."""
    from repro_torch.models.encdec import encdec_param_shapes, encdec_stacks
    from repro_torch.models.transformer import lm_param_shapes, lm_stacks
    encdec = cfg.family == "encdec"
    sizes = {n: 4 * math.prod(s)
             for n, s in (encdec_param_shapes if encdec else lm_param_shapes)(cfg).items()}
    param_bytes, largest = sum(sizes.values()), max(sizes.values())
    if cfg.optimizer == "adamw":
        need = 5 * param_bytes + 5 * largest
    else:
        stacks = (encdec_stacks if encdec else lm_stacks)(cfg)
        need = 3 * param_bytes + 2 * sum(sizes[n] for ns in stacks.values() for n in ns) + largest
    need += 4e9
    free = (torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
            - torch.cuda.memory_allocated())
    return need <= free, (f"{param_bytes / 1e9:.2f} GB of parameters: ~{need / 1e9:.1f} GB "
                          f"needed, {free / 1e9:.1f} GB free")


def train_full(dev, arch, lookups_per_s, smi_line, shape=TRAIN_FULL, capture=None,
               capture_step=3, stride=HELD_COLUMN_STRIDE, n_layers=None,
               n_experts=None) -> dict:
    """Phase 5e (and 8c, 9c, 10c, 11c), one model: ``cfg.optimizer`` steps under
    ``amsim``/afm16 at full width and full depth (or ``n_layers``; an MoE
    arch's experts cut to ``n_experts``), which
    must fit the card (``train_fits``), at ``shape`` (batch, seq, steps), each
    step timed (host wall clock to the loss read back; CUDA events over
    the step; torch.profiler's device busy time of step 2), the launches of
    each step, the peak memory, and, in a run of at least ``capture_step``
    steps, each kernel of ``capture`` (default: all) at each shape of that
    step, at its first call there: its device time, and the kernel held
    bitwise against its plain version (``held_against_plain``, every
    ``stride``-th column of a large GEMM), inside the step, so that no
    tensor of the step outlives it.  Returns the launches of the run
    (counters zeroed before each step, summed)."""
    from repro_torch.configs.base import cut, get_arch
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.approx_attention import approx_attention_plain
    from repro_torch.kernels.approx_gemm import approx_gemm_batched_plain, approx_gemm_plain
    from repro_torch.kernels.common import lut_bytes
    from repro_torch.kernels.decode_chain import fused_moe_ffn_plain
    full = get_arch(arch)
    cfg = cut(full, n_layers=n_layers or full.n_layers, n_experts=n_experts)
    gc.collect()                 # an earlier run's model, if a cycle holds it
    torch.cuda.empty_cache()
    fits, why = train_fits(cfg)
    require(fits, f"{arch} training at depth {cfg.n_layers}: {why}")
    depth_note = (f"full depth ({cfg.n_layers} layers)" if cfg.n_layers == full.n_layers
                  else f"depth {cfg.n_layers} of {full.n_layers}: at full depth "
                  f"{train_fits(full)[1]}")
    if n_experts is not None:
        depth_note += f"; {n_experts} of its {full.moe.n_experts} experts"
    B, S, steps = shape["batch"], shape["seq"], shape["steps"]
    policy = NumericsPolicy(mode="amsim", multiplier="afm16")
    torch.cuda.reset_peak_memory_stats()
    model, state, step = train_setup(cfg, policy, dev)
    if cfg.family == "encdec":
        counters, want = encdec_counters(), encdec_train_want(cfg, S)
    elif cfg.ssm is None:
        counters, want = train_counters(), train_want(cfg, S)
    else:
        counters, want = ssm_counters(), ssm_train_want(cfg, S)
    remat = cfg.remat and not cfg.attn_every     # the hybrid stack has none, as in JAX
    print(f"{arch} training at full width, {depth_note}; this run: {why}; batch {B}, seq {S}, "
          f"{cfg.optimizer}, cosine_schedule({TRAIN_LR}, 10, {steps}), remat {remat}, "
          f"amsim/afm16 ({smi_line}):")
    plain_of = {"approx_gemm": approx_gemm_plain, "approx_gemm_batched": approx_gemm_batched_plain,
                "approx_attention": approx_attention_plain, "fused_moe_ffn": fused_moe_ffn_plain}
    calls = {}                                 # (kernel, shapes) -> [count, what was held]
    originals = {k: getattr(ops, k) for k in counters}
    run = dict.fromkeys(want, 0)

    def hold(kname, args, kw) -> dict:
        fn = originals[kname]
        counts = launches_of(counters)       # the check's own launches are not the step's
        with torch.no_grad():
            t = queued_ms(lambda: fn(*args, **kw), reps=3)
        if kname == "approx_attention":
            nbytes, lookups = serving_costs(kname, args, kw, lut_bytes(args[5]))
        elif kname == "approx_gemm":
            nbytes, lookups = gemm_costs(*args[:3])
        else:
            nbytes, lookups = moe_costs(kname, args, kw)
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        same, what = held_against_plain(kname, fn, plain_of[kname], args, kw, stride=stride)
        torch.cuda.synchronize()
        for k, f in counters.items():
            f.launches = counts[k]
        pass_ = ""
        if kname == "approx_gemm":
            pass_ = " dw" if args[0].shape[1] == B * S else " fwd/dx"
        return dict(t=t, nbytes=nbytes, lookups=lookups, same=same, what=what, pass_=pass_,
                    t_plain=(time.perf_counter() - t_plain) * 1e3,
                    note=(f"; {gemm_plan_text(*args[:3])}" if kname.startswith("approx_gemm")
                          else ""))

    def captured(kname):
        def wrapped(*a, **kw):
            key = (kname, tuple(tuple(t.shape) for t in a if isinstance(t, torch.Tensor)))
            if key not in calls:       # held at once: no tensor of the step outlives it
                calls[key] = [0, hold(kname, a, kw)]
            calls[key][0] += 1
            return originals[kname](*a, **kw)
        return wrapped

    for i in range(steps):
        batch = lm_batch(cfg, (B, S), i, dev)
        zero_launches(counters)
        if i == capture_step - 1:
            for k in capture or counters:
                setattr(ops, k, captured(k))
        try:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            busy = None
            if i == 1:
                (state, metrics), busy = profiled(lambda: step(model, state, batch))
            else:
                state, metrics = step(model, state, batch)
            loss = float(metrics["loss"])
            end.record()
            wall = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        finally:
            for k, fn in originals.items():
                setattr(ops, k, fn)
        extra = []
        if i == 1:         # the profiled step's wall holds the profiler's own cost
            extra.append(f"device busy {busy:.4f} ms (torch.profiler)" if busy is not None
                         else busy_text(None, wall))
        if i == capture_step - 1:
            extra.append("each kernel's shapes timed and held against their plain versions "
                         "inside it")
        got = launches_of(counters)
        require(got == want, f"{arch} training step {i + 1}: launches {got}, want {want}")
        for k, n in got.items():
            run[k] += n
        require(all(map(math.isfinite, (loss, float(metrics["grad_norm"])))),
                f"{arch} training step {i + 1}: loss {loss}, grad norm {metrics['grad_norm']}")
        aux = f", aux {float(metrics['aux']):.6f}" if "aux" in metrics else ""
        print(f"  step {i + 1}: {wall:.1f} ms wall, {start.elapsed_time(end):.1f} ms on device "
              f"(CUDA events over the step){'; ' + '; '.join(extra) if extra else ''}; loss "
              f"{loss:.6f}, xent {float(metrics['xent']):.6f}{aux}, grad norm "
              f"{float(metrics['grad_norm']):.6f}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated); launches a step "
          f"{ {k: v for k, v in want.items() if v} }")
    sums = {}
    for (kname, shapes), (n, r) in sorted(calls.items(), key=lambda c: c[0]):
        require(r["t"] > 0, f"no device time measured for {kname} at {shapes}")
        require(r["same"], f"{arch} training: {kname} at {shapes} differs from its plain version "
                f"({r['what']})")
        bound = max(r["nbytes"] / HBM_BYTES_PER_S, r["lookups"] / lookups_per_s) * 1e3
        print(f"  {kname}{r['pass_']} {shapes} x {n}: {r['t']:.4f} ms on device each (bound "
              f"{bound:.4f} ms, {bound_kind(r['nbytes'], r['lookups'], lookups_per_s)}; "
              f"{r['lookups']} lookups), bitwise its plain version on {r['what']} "
              f"({r['t_plain']:.1f} ms with the check){r['note']}")
        s = sums.setdefault(f"{kname}{r['pass_']}", [0, 0.0, 0.0])
        s[0] += n
        s[1] += n * r["t"]
        s[2] += n * bound
    for name, (n, t, bound) in sums.items():
        print(f"  kernel {name}: {t:.2f} ms on device a training step over {n} launches, bound "
              f"{bound:.2f} ms")
    del model, state, step, calls
    torch.cuda.empty_cache()
    return run


def depth2_run(cfg, policy, dev, counters, shape=None):
    """adamw steps of ``cfg`` under ``policy`` at ``shape`` (batch, seq,
    steps; default ``TRAIN_DEPTH2``): (losses, parameters after them, the
    gradient at the next batch, launches of each step, seconds)."""
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models.encdec import encdec_loss
    from repro_torch.models.transformer import lm_loss
    loss_fn = encdec_loss if cfg.family == "encdec" else lm_loss
    shape = TRAIN_DEPTH2 if shape is None else shape
    B, S, steps = shape["batch"], shape["seq"], shape["steps"]
    model, state, step = train_setup(cfg, policy, dev)
    t0 = time.perf_counter()
    losses, launches = [], []
    for i in range(steps):
        zero_launches(counters)
        state, metrics = step(model, state, lm_batch(cfg, (B, S), i, dev))
        losses.append(metrics["loss"])
        launches.append(launches_of(counters))
    loss, _ = loss_fn(model, lm_batch(cfg, (B, S), steps, dev), policy)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    return (losses, [p.detach() for p in model.parameters()], grads, launches,
            time.perf_counter() - t0)


def _same(xs, ys) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(xs, ys))


def train_step_bitwise(dev, cfg, label, shape, counters, want) -> None:
    """adamw steps of ``cfg`` at ``shape`` under amsim and amsim_torch with
    deterministic algorithms (the embedding's and the MoE gather's
    backward are atomic scatters without them): the losses, the parameters
    after the steps and the gradient at the next batch bitwise (int32
    views); the amsim launches of each step equal ``want``."""
    from repro_torch.core.policy import NumericsPolicy
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("amsim", "amsim_torch"):
            runs[mode] = depth2_run(cfg, NumericsPolicy(mode=mode, multiplier="afm16"), dev,
                                    counters, shape)
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    (l_a, p_a, g_a, n_a, t_a), (l_p, p_p, g_p, n_p, t_p) = runs["amsim"], runs["amsim_torch"]
    steps = shape["steps"]
    require(n_a == [want] * steps and n_p == [dict.fromkeys(want, 0)] * steps,
            f"{label} training launches: amsim {n_a}, amsim_torch {n_p}, want {want} a step")
    require(all(bool(torch.isfinite(v)) for v in l_a), f"{label} losses {l_a}")
    require(_same(l_a, l_p), f"{label} training losses: amsim {l_a}, amsim_torch {l_p}")
    require(_same(p_a, p_p), f"{label} training: parameters after step {steps} differ")
    require(_same(g_a, g_p), f"{label} training: gradients after step {steps} differ")
    print(f"{label}: batch {shape['batch']} x {shape['seq']}, {steps} {cfg.optimizer} "
          f"step{'s' if steps > 1 else ''}{' (remat)' if cfg.remat and not cfg.attn_every else ''}"
          f": losses {[round(float(v), 6) for v in l_a]}, parameters after step {steps} and the "
          f"gradient at batch {steps} bitwise equal to amsim_torch ({len(p_a)} tensors); amsim "
          f"launches a step { {k: v for k, v in want.items() if v} }; {t_a:.1f} s amsim, "
          f"{t_p:.1f} s amsim_torch")
    del runs
    torch.cuda.empty_cache()


def train_resume(dev):
    """Phase 5e: 3 ``amsim`` steps straight against 2 steps through the
    trainer with a checkpoint, a restore into a model drawn from another
    seed and 1 more step: parameters bitwise equal."""
    import dataclasses
    import shutil
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.train.trainer import Trainer, TrainerConfig, TrainerState
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=TRAIN_DEPTH2["n_layers"])
    policy = NumericsPolicy(mode="amsim", multiplier="afm16")
    shape = (TRAIN_DEPTH2["batch"], TRAIN_DEPTH2["seq"])
    batch_fn = lambda s: lm_batch(cfg, shape, s, dev)  # noqa: E731
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    try:
        straight, state, step = train_setup(cfg, policy, dev)
        for i in range(3):
            state, _ = step(straight, state, batch_fn(i))
        logs = []
        tcfg = TrainerConfig(total_steps=2, ckpt_dir=str(CKPT_DIR), ckpt_every=2, keep=1,
                             log_every=1, log_fn=logs.append)
        first, state, step = train_setup(cfg, policy, dev)
        Trainer(step, batch_fn, tcfg).run(TrainerState(first, state))
        del first, state
        t0 = time.perf_counter()
        fresh, state, step = train_setup(cfg, policy, dev, seed=SEED + 1)
        end = Trainer(step, batch_fn, dataclasses.replace(tcfg, total_steps=3)).run(
            TrainerState(fresh, state))
        torch.cuda.synchronize()
        ckpt_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    require(end.step == 3, f"resume ended at step {end.step}")
    require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(fresh.parameters(), straight.parameters())),
            "resume: parameters after 2 steps + checkpoint + restore + 1 step differ from 3 steps")
    print(f"{LM_ARCH} depth {cfg.n_layers} resume: 3 amsim steps straight == 2 steps, a "
          f"checkpoint, a restore into a model drawn from seed {SEED + 1} and 1 step (bitwise, "
          f"{sum(1 for _ in fresh.parameters())} tensors); restore + step + save {ckpt_s:.1f} s; "
          f"trainer log: {' | '.join(logs)}")
    del straight, fresh, end
    torch.cuda.empty_cache()


def lm_training(dev, lookups_per_s, smi_line) -> dict:
    """Phase 5e: LM training on the card; returns {arch: launches of its
    full-width run}.  granite-moe's top-8-of-40 MoE layer steps bitwise
    amsim_torch here at depth 1 (``TRAIN_MOE1``); granite-3-2b's depth-2
    adamw steps are held so in 6a; granite-3-2b's step-1 kernel shapes are
    held in 6b (under fp16xbf16, timed under afm16 too), granite-moe's
    here."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=TRAIN_MOE1["n_layers"])
    train_step_bitwise(dev, cfg, f"{MOE_ARCH} depth {cfg.n_layers}", TRAIN_MOE1,
                       train_counters(), train_want(cfg, TRAIN_MOE1["seq"]))
    train_resume(dev)
    return {arch: train_full(dev, arch, lookups_per_s, smi_line,
                             capture_step=0 if arch == LM_ARCH else 1)
            for arch in TRAIN_ARCHS}


# ------------------------------------------------- the numerics surface
MIXED_TABLE = "qkv=mitchell8,attn_score=bf16,dw=native,default=afm16"
# 6b's points beside the fp32 baseline (the mixed table's launches and bits
# are held at depth 2 in 6a)
SWEEP_POINTS = ("default=fp16xbf16",)
SERVE_TABLES = {"unembed=native,default=fp16xbf16": True, "wd=bf16,default=afm16": False}
# The campaign under amsim (the accuracy curve), and its faulted points again
# for BITWISE_STEPS under amsim and amsim_torch, at FAULT_BITWISE's batch and
# test set (the plain versions' cost grows with the images).
FAULT_RUN = dict(arch="resnet-mini", steps=40, batch=64, rates="0,1e-4,1e-3", stuck1="1e-3")
BITWISE_STEPS = 1
FAULT_BITWISE = dict(batch=16, n_test=64)
# Where a kernel wrapper takes its table (the argument after it is M).
LUT_SLOT = {"approx_gemm": 2, "approx_gemm_batched": 2, "approx_attention": 5}


def table_train_want(cfg, policy) -> dict:
    """Launches of one training step of a dense LM under ``policy`` (a flat
    policy or a table): each projection's forward (twice under remat), dx
    and dw where that leaf is ``amsim``; the fused attention kernel where
    both attention sites share an ``amsim`` leaf (its backward recomputes
    the einsum lowering: 2 batched GEMMs forward, 4 backward), else the
    einsum lowering in the forward (twice under remat) and 4 batched GEMMs
    backward, each under its site's leaf; the tied head's 3 GEMMs."""
    from repro_torch.kernels import ops

    def on(site, pass_):
        leaf = policy.resolve(site, pass_=pass_)
        return int(leaf.mode == "amsim" and not leaf.is_native)

    L, fwd = cfg.n_layers, 1 + int(cfg.remat)
    gemm = L * sum(n * (fwd * on(s, "fwd") + on(s, "dx") + on(s, "dw"))
                   for s, n in (("qkv", 3), ("wo", 1), ("wg", 1), ("wu", 1), ("wd", 1)))
    head = "unembed" if cfg.tie_embeddings else "head"
    gemm += on(head, "fwd") + on(head, "dx") + on(head, "dw")
    fused = ops.fused_attention_enabled(policy)
    einsum_fwd = 1 if fused else fwd
    batched = L * sum(einsum_fwd * on(s, "fwd") + 2 * on(s, "dx")
                      for s in ("attn_score", "attn_value"))
    return {"approx_gemm": gemm, "approx_gemm_batched": batched,
            "approx_attention": fwd * L if fused else 0, "fused_moe_ffn": 0}


def table_depth2(dev):
    """Phase 6a: granite-3-2b depth 2, 2 adamw steps under deterministic
    algorithms: a uniform table bitwise the flat policy; the mixed table
    bitwise between amsim and amsim_torch; launches as the table dictates."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import (NumericsPolicy, PolicyRule, PolicyTable,
                                         table_from_assignments)
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=TRAIN_DEPTH2["n_layers"])
    B, S, steps = TRAIN_DEPTH2["batch"], TRAIN_DEPTH2["seq"], TRAIN_DEPTH2["steps"]
    counters = train_counters()
    require(table_train_want(cfg, NumericsPolicy(mode="amsim", multiplier="afm16"))
            == train_want(cfg, S), "table_train_want of the flat policy differs from train_want")
    policies = {"flat": NumericsPolicy(mode="amsim", multiplier="afm16"),
                "uniform": PolicyTable((PolicyRule("amsim", "afm16"),)),
                "mixed amsim": table_from_assignments(MIXED_TABLE),
                "mixed amsim_torch": table_from_assignments(MIXED_TABLE,
                                                            default_mode="amsim_torch")}
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, policy in policies.items():
            runs[name] = depth2_run(cfg, policy, dev, counters)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in (("flat", "uniform"), ("mixed amsim", "mixed amsim_torch")):
        (l_a, p_a, g_a, _, _), (l_b, p_b, g_b, _, _) = runs[a], runs[b]
        require(all(bool(torch.isfinite(v)) for v in l_a), f"6a {a}: losses {l_a}")
        require(_same(l_a, l_b) and _same(p_a, p_b) and _same(g_a, g_b),
                f"6a: {a} and {b} differ (losses {[float(v) for v in l_a]} and "
                f"{[float(v) for v in l_b]})")
    want_mixed = table_train_want(cfg, policies["mixed amsim"])
    for name, want in (("flat", train_want(cfg, S)), ("uniform", train_want(cfg, S)),
                       ("mixed amsim", want_mixed),
                       ("mixed amsim_torch", dict.fromkeys(want_mixed, 0))):
        require(runs[name][3] == [want] * steps,
                f"6a {name}: launches {runs[name][3]}, want {want} a step")
    print(f"{LM_ARCH} depth {cfg.n_layers}, batch {B}, seq {S}, {steps} adamw steps: the uniform "
          f"table amsim/afm16 bitwise the flat policy (losses "
          f"{[round(float(v), 6) for v in runs['flat'][0]]}, parameters, the next gradient; "
          f"launches {train_want(cfg, S)} a step); the mixed table {MIXED_TABLE!r} bitwise between "
          f"amsim and amsim_torch (losses {[round(float(v), 6) for v in runs['mixed amsim'][0]]}; "
          f"amsim launches {want_mixed} a step); seconds "
          + ", ".join(f"{k} {v[4]:.1f}" for k, v in runs.items()))
    del runs
    torch.cuda.empty_cache()


def numerics_sweep(dev, lookups_per_s, smi_line) -> dict:
    """Phase 6b: ``launch.sweep.main`` on granite-3-2b at full width and
    depth; each step's launches, step 2's busy time, and step 1's kernel
    calls of the fp16xbf16 point held bitwise against their plain versions
    and timed under fp16xbf16 and afm16.  Returns the launches of the
    phase by kernel."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.lutgen import get_packed_lut
    from repro_torch.core.policy import NumericsPolicy, table_from_assignments
    from repro_torch.kernels import ops
    from repro_torch.kernels.approx_attention import approx_attention_plain
    from repro_torch.kernels.approx_gemm import approx_gemm_batched_plain, approx_gemm_plain
    from repro_torch.kernels.common import lut_bytes, lut_tensor
    from repro_torch.launch import sweep
    cfg = get_arch(LM_ARCH)
    B, S, steps = TRAIN_FULL["batch"], TRAIN_FULL["seq"], TRAIN_FULL["steps"]
    counters = train_counters()
    originals = {k: getattr(ops, k) for k in counters}
    records = []                    # one a step built: launches a step, busy, step-1 calls

    def wrapper(step):
        # Only the last point's calls are timed: drop an earlier point's, whose
        # captured weights would hold its model's storage alive.
        for rec in records:
            rec["calls"].clear()
        rec = {"launches": [], "busy": None, "calls": {}}
        records.append(rec)

        def capture(kname):
            def wrapped(*a, **kw):
                key = (kname, tuple(tuple(t.shape) for t in a if isinstance(t, torch.Tensor)))
                rec["calls"].setdefault(key, [0, a, kw])[0] += 1
                return originals[kname](*a, **kw)
            return wrapped

        def timed_step(model, state, batch):
            i = len(rec["launches"])
            zero_launches(counters)
            try:
                if i == 1:
                    out, rec["busy"] = profiled(lambda: step(model, state, batch))
                else:
                    if i == 0:
                        for k in counters:
                            setattr(ops, k, capture(k))
                    out = step(model, state, batch)
                    torch.cuda.synchronize()
            finally:
                for k, fn in originals.items():
                    setattr(ops, k, fn)
            rec["launches"].append(launches_of(counters))
            return out
        return timed_step

    torch.cuda.empty_cache()
    argv = ["--arch", LM_ARCH, "--steps", str(steps), "--batch", str(B), "--seq", str(S),
            "--out", str(ROOT / "build" / "chip_smoke_sweep.json")]
    for spec in SWEEP_POINTS:
        argv += ["--point", spec]
    print(f"{LM_ARCH} sweep at full width and depth (python -m repro_torch.launch.sweep "
          f"{' '.join(argv)}; {smi_line}):")
    uploads = dict(ops.lut_uploads)
    report = sweep.main(argv, step_wrapper=wrapper)
    require(len(records) == 1 + len(SWEEP_POINTS), f"6b: {len(records)} train steps built for "
            f"{1 + len(SWEEP_POINTS)} points")
    require(all(n == 1 for n in ops.lut_uploads.values()),
            f"6b: a table was uploaded more than once: {ops.lut_uploads}")
    entries = [("fp32 baseline", NumericsPolicy(), report["baseline"])] + [
        (spec, table_from_assignments(spec), pt) for spec, pt in zip(SWEEP_POINTS,
                                                                      report["points"])]
    phase_launches = {}
    for (label, policy, entry), rec in zip(entries, records):
        want = table_train_want(cfg, policy)
        require(rec["launches"] == [want] * steps,
                f"6b {label}: launches {rec['launches']}, want {want} a step")
        require(all(map(math.isfinite, entry["losses"])), f"6b {label}: losses {entry['losses']}")
        for k, n in want.items():
            phase_launches[k] = phase_launches.get(k, 0) + n * steps
        busy = ("not measured: torch.profiler recorded no device activity" if rec["busy"] is None
                else f"{rec['busy']:.1f} ms")
        delta = entry.get("final_vs_baseline")
        print(f"  {label}: losses {[round(v, 6) for v in entry['losses']]}"
              + (f" (final vs baseline {delta:+.6f})" if delta is not None else "")
              + f"; ms a step (wall, to the loss read back) "
              f"{[round(v, 1) for v in entry['step_ms']]}, step 2 device busy {busy}; peak "
              f"{entry['peak_bytes'] / 1e9:.2f} GB; launches a step {want}; "
              f"{entry['traces']} step built, {entry['uploads']} tables uploaded")
    new = {k: n for k, n in ops.lut_uploads.items() if k not in uploads}
    print(f"  tables first uploaded in this phase: "
          f"{[(k[0], 'packed' if k[2] else 'canonical') for k in new]}")
    # The fp16xbf16 point's step-1 kernel calls: bitwise their plain
    # versions, and timed under fp16xbf16 and under afm16 on the same operands.
    afm16 = lut_tensor(get_packed_lut("afm16"), dev)
    x16 = lut_tensor(get_packed_lut("fp16xbf16"), dev)
    plain_of = {"approx_gemm": approx_gemm_plain, "approx_gemm_batched": approx_gemm_batched_plain,
                "approx_attention": approx_attention_plain}
    sums = {}
    for (kname, shapes), (n, args, kw) in sorted(records[-1]["calls"].items(),
                                                  key=lambda c: c[0]):
        fn, slot = originals[kname], LUT_SLOT[kname]
        lut, M = args[slot], args[slot + 1]
        require(M == 10 and torch.equal(lut, x16),
                f"6b: {kname} at {shapes} did not get the fp16xbf16 table")
        same, what = held_against_plain(kname, fn, plain_of[kname], args, kw)
        require(same, f"6b fp16xbf16: {kname} at {shapes} differs from its plain version "
                f"({what})")
        swapped = (*args[:slot], afm16, 7, *args[slot + 2:])
        t_x = queued_ms(lambda: fn(*args, **kw), reps=3)
        t_a = queued_ms(lambda: fn(*swapped, **kw), reps=3)
        if kname == "approx_attention":
            nbytes, lookups = serving_costs(kname, args, kw, lut_bytes(lut))
        elif kname == "approx_gemm":
            nbytes, lookups = gemm_costs(*args[:3])
        else:
            nbytes, lookups = moe_costs(kname, args, kw)
        bound = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
        note = f"; {gemm_plan_text(*args[:3])}" if kname.startswith("approx_gemm") else ""
        print(f"  fp16xbf16 {kname} {shapes} x {n}: {t_x:.4f} ms on device each, afm16 {t_a:.4f} "
              f"(x{t_x / t_a:.2f}), bound {bound:.4f} ms; bitwise its plain version on "
              f"{what}{note}")
        s = sums.setdefault(kname, [0, 0.0, 0.0, 0.0])
        for i, v in enumerate((n, n * t_x, n * t_a, n * bound)):
            s[i] += v
    for kname, (n, t_x, t_a, bound) in sums.items():
        print(f"  kernel {kname} a training step ({n} launches): fp16xbf16 {t_x:.2f} ms, afm16 "
              f"{t_a:.2f} ms on the same operands (x{t_x / t_a:.2f}), bound {bound:.2f} ms")
    del records, entries
    torch.cuda.empty_cache()
    return phase_launches


def table_serving(dev) -> dict:
    """Phase 6c: granite-3-2b depth-2 serving under two tables, amsim
    bitwise amsim_torch, the chain engaged as the table dictates.  Returns
    the amsim launches by kernel."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import table_from_assignments
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ServingEngine
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=DEPTH2["n_layers"])
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompts = torch.randint(0, cfg.vocab, (DEPTH2["batch"], DEPTH2["prompt"]),
                            generator=torch.Generator().manual_seed(SEED)).to(dev)
    counters = serving_counters()
    L, steps, ring = cfg.n_layers, DEPTH2["new"] - 1, 64
    total = {}
    for spec, chain in SERVE_TABLES.items():
        tables = {mode: table_from_assignments(spec, default_mode=mode)
                  for mode in ("amsim", "amsim_torch")}
        require(ops.decode_chain_enabled(tables["amsim"]) is chain,
                f"6c {spec}: decode_chain_enabled is not {chain}")
        head = int(not tables["amsim"].resolve("unembed").is_native)
        # (attention, qkv, out-mlp, attention+out-mlp, GEMM): prefill + steps
        want = (dict(zip(counters, (L, L * steps, 0, L * steps, 7 * L + head * (1 + steps))))
                if chain else dict(zip(counters, (L * (1 + steps), 0, 0, 0,
                                                  (7 * L + head) * (1 + steps)))))
        results = {}
        torch.use_deterministic_algorithms(True)
        try:
            for mode, table in tables.items():
                zero_launches(counters)
                toks, logits = ServingEngine(model, table, max_len=ring).generate(
                    prompts, DEPTH2["new"], return_logits=True)
                torch.cuda.synchronize()
                results[mode] = (toks, logits, launches_of(counters))
        finally:
            torch.use_deterministic_algorithms(False)
        (t_a, l_a, n_a), (t_p, l_p, n_p) = results["amsim"], results["amsim_torch"]
        require(n_a == want and not any(n_p.values()),
                f"6c {spec}: launches {n_a} (amsim_torch {n_p}), want {want}")
        require(bool(torch.isfinite(l_a).all()) and torch.equal(l_a, l_p) and torch.equal(t_a, t_p),
                f"6c {spec}: amsim differs from amsim_torch (logits max|d| "
                f"{(l_a - l_p).abs().max().item()})")
        for k, n in n_a.items():
            total[k] = total.get(k, 0) + n
        print(f"{LM_ARCH} depth {L} serving under {spec!r} ({'fused chain' if chain else 'per-op'}"
              f", ring {ring}): logits and tokens bitwise between amsim and amsim_torch; amsim "
              f"launches {n_a}; tokens {t_a[0].tolist()}")
    del model
    torch.cuda.empty_cache()
    return total


def fault_campaign(dev, smi_line) -> dict:
    """Phase 6d: ``launch.faultsweep.main`` on resnet-mini under amsim with
    deterministic algorithms, launches and uploads counted; a zero-rate
    spec bitwise the clean point; each faulted point bitwise between amsim
    and amsim_torch over ``BITWISE_STEPS`` at FAULT_BITWISE's sizes; then a
    step's time with the clean and the faulted table.  Returns the campaign's launches by
    kernel."""
    from repro_torch.configs.paper_models import VISION_REGISTRY
    from repro_torch.core import faults
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.core.multipliers import get_multiplier
    from repro_torch.kernels import ops
    from repro_torch.kernels.approx_conv import approx_conv2d_dw, approx_conv2d_fused
    from repro_torch.kernels.approx_gemm import approx_gemm
    from repro_torch.launch import faultsweep
    counters = {"approx_conv2d_fused": approx_conv2d_fused, "approx_conv2d_dw": approx_conv2d_dw,
                "approx_gemm": approx_gemm}
    # The clean tables on the card before the campaign: its clean points upload none.
    ops._amsim_lut(get_multiplier("afm16"), dev)
    ops._oracle_lut(get_multiplier("afm16"), dev)
    per_step = dict(zip(counters, TRAIN_LAUNCHES[FAULT_RUN["arch"]]))
    step_launches = []

    def wrapper(step):
        def counted(*a):
            zero_launches(counters)
            out = step(*a)
            step_launches.append(launches_of(counters))
            return out
        return counted

    common = ["--arch", FAULT_RUN["arch"], "--steps", str(FAULT_RUN["steps"]), "--batch",
              str(FAULT_RUN["batch"]), "--mode", "amsim", "--multiplier", "afm16", "--lr", "0.05"]
    points = []
    torch.use_deterministic_algorithms(True)
    try:
        for kind, rates in (("bitflip", FAULT_RUN["rates"]), ("stuck1", FAULT_RUN["stuck1"])):
            del step_launches[:]
            rep = faultsweep.main(common + ["--model", kind, "--rates", rates],
                                  step_wrapper=wrapper)
            require(step_launches == [per_step] * (FAULT_RUN["steps"] * len(rep["points"])),
                    f"6d {kind}: launches a step {step_launches}, want {per_step}")
            points += [dict(p, model=kind) for p in rep["points"]]
        problem = faultsweep.vision_problem(VISION_REGISTRY[FAULT_RUN["arch"]],
                                            batch=FAULT_RUN["batch"], lr=0.05, seed=0, device=dev)
        amsim, plain = (NumericsPolicy(mode=m, multiplier="afm16") for m in ("amsim",
                                                                             "amsim_torch"))
        zero = faultsweep.run_fault_point(problem, amsim, faults.FaultSpec(kind="bitflip",
                                                                           rate=0.0),
                                          steps=FAULT_RUN["steps"])
        small = faultsweep.vision_problem(VISION_REGISTRY[FAULT_RUN["arch"]], lr=0.05, seed=0,
                                          device=dev, **FAULT_BITWISE)
        pairs = [(p, [faultsweep.run_fault_point(small, pol, faults.FaultSpec(**p["spec"]),
                                                 steps=BITWISE_STEPS) for pol in (amsim, plain)])
                 for p in points if p["spec"] is not None]
    finally:
        torch.use_deterministic_algorithms(False)
    clean = points[0]
    require(clean["spec"] is None and zero["losses"] == clean["losses"]
            and zero["test_acc"] == clean["test_acc"] and zero["uploads"] == 0,
            f"6d: the zero-rate spec (losses {zero['losses'][-3:]}, {zero['uploads']} uploads) "
            f"differs from the clean point (losses {clean['losses'][-3:]})")
    for pt in points:
        want = 0 if pt["spec"] is None else 1
        require(pt["uploads"] == want and pt["traces"] == 1,
                f"6d {pt['model']} {pt['label']}: {pt['uploads']} tables uploaded (want {want}), "
                f"{pt['traces']} steps built")
        print(f"  resnet-mini {FAULT_RUN['steps']} sgdm steps, {pt['model']} {pt['label']}: test "
              f"accuracy {pt['test_acc']:.4f}, final loss {pt['final_loss']:.6f}, "
              f"{pt['uploads']} tables uploaded, median step "
              f"{sorted(pt['step_ms'])[len(pt['step_ms']) // 2]:.2f} ms")
    for pt, (a, p) in pairs:
        require(a["losses"] == p["losses"] and a["test_acc"] == p["test_acc"]
                and p["uploads"] == 1,
                f"6d {pt['model']} {pt['label']}, {BITWISE_STEPS} steps: amsim (losses "
                f"{a['losses']}, acc {a['test_acc']}) differs from amsim_torch (losses "
                f"{p['losses']}, acc {p['test_acc']}, {p['uploads']} uploads)")
        print(f"  {pt['model']} {pt['label']}, {BITWISE_STEPS} steps at batch "
              f"{FAULT_BITWISE['batch']}, {FAULT_BITWISE['n_test']} test images: amsim bitwise "
              f"amsim_torch (losses {[round(v, 6) for v in a['losses']]}, test accuracy "
              f"{a['test_acc']:.4f}; "
              f"amsim_torch {sorted(p['step_ms'])[0]:.0f} ms a step, its faulted canonical table "
              f"uploaded once)")
    print("  test accuracy against the rate: " + ", ".join(
        f"{pt['model']} {pt['rate']:g}: {pt['test_acc']:.4f}" for pt in points))
    # A training step's time with the clean table and with the faulted one, in turns.
    from repro_torch.models.vision import init_vision, vision_loss
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.step import make_train_step
    cfg = VISION_REGISTRY[FAULT_RUN["arch"]]
    model = init_vision(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    opt = make_optimizer("sgdm", 0.05)
    step = make_train_step(lambda m, b: vision_loss(m, b, NumericsPolicy("amsim", "afm16")), opt)
    box = [opt.init(dict(model.named_parameters()))]
    batch = problem["batch_fn"](0)

    def one():
        box[0], _ = step(model, box[0], batch)

    times = []
    for spec in (None, FAULTED_AFM16.split("|")[1], FAULTED_AFM16.split("|")[1], None):
        with faults.inject(spec):
            times.append(cuda_ms(one, reps=10, warmup=2))
    print(f"  resnet-mini amsim training step, batch {FAULT_RUN['batch']} ({smi_line}): clean "
          f"{times[0]:.4f} / {times[3]:.4f} ms, faulted ({FAULTED_AFM16.split('|')[1]}) "
          f"{times[1]:.4f} / {times[2]:.4f} ms (CUDA events, 10 steps each, in turns)")
    return {k: n * FAULT_RUN["steps"] * len(points) for k, n in per_step.items()}


def numerics_surface(dev, lookups_per_s, smi_line, phase_done, after_sweep=None):
    """Phase 6: the numerics surface on the card, 6b first (the largest
    model), then ``after_sweep`` (if any), 6a, 6c and 6d; every kernel of
    its path (6b-6d) must have launched there."""
    launches = numerics_sweep(dev, lookups_per_s, smi_line)
    phase_done("6b sweep, full width")
    if after_sweep is not None:
        after_sweep()
    table_depth2(dev)
    phase_done("6a tables, depth 2")
    for name, run in (("6c serving under tables", lambda: table_serving(dev)),
                      ("6d fault campaign", lambda: fault_campaign(dev, smi_line))):
        for k, n in run().items():
            launches[k] = launches.get(k, 0) + n
        phase_done(name)
    for kname in ("approx_gemm", "approx_gemm_batched", "approx_attention", "fused_qkv_norm",
                  "fused_attn_out_mlp", "approx_conv2d_fused", "approx_conv2d_dw"):
        require(launches.get(kname, 0) > 0, f"{kname} never launched on the numerics path")
    print(f"launches on the numerics path (6b-6d, amsim): {launches}")


# ------------------------------------------------- continuous batching
# Phase 7: the paged scheduler (``serve/scheduler.py``) through the
# entry points of ``python -m repro_torch.launch.serve --stream``.
# 7c's stream: 16 requests, prompts of 32-256 tokens, 16 new tokens each,
# tiers exact=native and cheap=amsim:afm16 in turn, 8 slots a lane, pages
# of 16, one arrival a tick; 7d: granite-moe, 8 requests of 16 new tokens,
# one amsim tier.  7b: depth 2, 6 requests, prompts of 4-40 tokens, 6 new
# tokens (a table of 3 pages: Tcap 48, the chain's 2-launch form).
STREAM = ["--stream", "16", "--min-prompt-len", "32", "--prompt-len", "256", "--new-tokens",
          "16", "--tiers", "exact=native,cheap=amsim:afm16", "--capacity", "8", "--page-size",
          "16", "--arrival-every", "1", "--seed", str(SEED)]
MOE_STREAM = ["--arch", MOE_ARCH, "--stream", "8", "--min-prompt-len", "32", "--prompt-len",
              "256", "--new-tokens", "16", "--tiers", "cheap=amsim:afm16", "--capacity", "8",
              "--page-size", "16", "--seed", str(SEED)]
STREAM_DEPTH2 = ["--n-layers", "2", "--stream", "6", "--min-prompt-len", "4", "--prompt-len",
                 "40", "--new-tokens", "6", "--tiers", "exact=native,cheap=amsim:afm16",
                 "--capacity", "4", "--page-size", "16", "--seed", str(SEED)]
# Decode ticks of 8 slots at their own positions (one or two dead) over
# Tcap 304 (7c's table: 19 pages of 16, the 3-launch form) and 128 (the
# 2-launch form): (starts, live) by Tcap.
TICKS = {304: ([0, 17, 100, 250, 303, 5, 60, 0], [1, 1, 1, 1, 1, 1, 1, 0]),
         128: ([3, 40, 127, 0, 64, 90, 11, 0], [1, 1, 1, 0, 1, 1, 1, 0])}
PAGED_PREFILL = 256      # 7c's largest bucket, at start 0 over Tcap 304


def paged_positions(S: int, T: int, starts, live, dev):
    """Positions of a paged batch (``models/attention._paged_cache_update``):
    row b's queries at starts[b] .. + S - 1, its keys valid below
    starts[b] + S when the row is live, every key unwritten when dead."""
    from repro_torch.kernels.common import POS_PAD
    starts = torch.tensor(starts, dtype=torch.int32)[:, None]
    live = torch.tensor(live, dtype=torch.bool)[:, None]
    t = torch.arange(T, dtype=torch.int32)[None]
    q = starts + torch.arange(S, dtype=torch.int32)[None]
    k = torch.where(live & (t < starts + S), t, POS_PAD)
    return q.to(dev), k.to(torch.int32).to(dev)


def poison_unread_keys(k, v, k_pos, gen):
    """inf, -inf and NaN in the K and V of every key no row may read:
    released pages keep their old contents, the trash page takes every
    masked write."""
    bad = (k_pos < 0)[:, :, None, None].expand_as(k)
    for a in (k, v):
        pick = torch.randint(0, 3, a.shape, generator=gen).to(a.device)
        for i, value in enumerate((float("inf"), -float("inf"), float("nan"))):
            a[:] = torch.where(bad & (pick == i), value, a)


def timed(fn):
    """(fn(), its milliseconds on the card by CUDA events, run once)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def stream_kernel_checks(dev, gen, lut_case, lookups_per_s) -> dict:
    """Phase 7a: the attention kernel and fused_attn_out_mlp with per-row
    positions at the stream's shapes against their plain versions, bit for
    bit, and per-row positions that agree against shared ones; returns each
    kernel's largest |difference| and prints its time at those shapes."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import decode_chain as chain
    from repro_torch.kernels.common import lut_bytes
    cfg = get_arch(LM_ARCH)
    d, F, H, KV, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    C = 8

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen).to(dev) * scale

    w = dict(g2=1 + 0.1 * randn(d), wo=randn(H * dh, d, scale=(H * dh) ** -0.5),
             wg=randn(d, F, scale=d ** -0.5), wu=randn(d, F, scale=d ** -0.5),
             wd=randn(F, d, scale=F ** -0.5))
    back = [w[n] for n in ("g2", "wo", "wg", "wu", "wd")]
    x = randn(C, d)
    err = {"approx_attention": 0.0, "fused_attn_out_mlp": 0.0}

    def held(name, out, ref, what):
        e = (out - ref).abs().nan_to_num(0.0).max().item()
        require(same_bits(out, ref), f"{name} per-row {what}: the bits differ (max|d| {e})")
        err[name] = max(err[name], e)

    def attention_case(S, T, starts, live):
        q_pos, k_pos = paged_positions(S, T, starts, live, dev)
        B = q_pos.shape[0]
        q, k, v = randn(B, S, H, dh), randn(B, T, KV, dh), randn(B, T, KV, dh)
        poison_unread_keys(k, v, k_pos, gen)
        return [q, k, v, q_pos, k_pos]

    cases = {f"decode tick of {C} slots over Tcap {T}": attention_case(1, T, *TICKS[T])
             for T in TICKS}
    cases[f"paged prefill of 1 x {PAGED_PREFILL} over Tcap 304"] = attention_case(
        PAGED_PREFILL, 304, [0], [1])
    kw = dict(causal=True, window=0)
    for lut_name, packed in SERVE_LUTS:
        lut, M = lut_case(lut_name, packed)
        tag = f"{lut_name} {'packed' if packed else 'canonical'}"
        for what, args in cases.items():
            out, t = timed(lambda: attn_mod.approx_attention(*args, lut, M))
            ref, tp = timed(lambda: attn_mod.approx_attention_plain(*args, lut, M, **kw))
            held("approx_attention", out, ref, f"{tag} {what}")
            if lut_name == "afm16":
                t = queued_ms(lambda: attn_mod.approx_attention(*args, lut, M), reps=5)
                nbytes, lookups = serving_costs("approx_attention", args, kw, lut_bytes(lut))
                tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
                plan = attn_mod.attention_plan(
                    attn_mod.attention_shape(args[0].shape, args[1].shape), lut,
                    torch.cuda.get_device_properties(0).multi_processor_count)
                print(f"  approx_attention per-row, {what}: {t:.4f} ms on device (bound "
                      f"{tb:.4f} ms: {bound_kind(nbytes, lookups, lookups_per_s)}), plain "
                      f"{tp:.2f} ms; plan {plan}")
        # the 2-launch form of a tick: the attention phase, then the back half
        args = cases[f"decode tick of {C} slots over Tcap 128"]
        out, t = timed(lambda: chain.fused_attn_out_mlp(x, *args, *back, lut, M,
                                                        eps=cfg.norm_eps))
        ref, tp = timed(lambda: chain.fused_attn_out_mlp_plain(x, *args, *back, lut, M,
                                                               eps=cfg.norm_eps, **kw))
        held("fused_attn_out_mlp", out, ref, f"{tag} decode tick of {C} slots over Tcap 128")
        if lut_name == "afm16":
            t = queued_ms(lambda: chain.fused_attn_out_mlp(x, *args, *back, lut, M,
                                                           eps=cfg.norm_eps), reps=5)
            cargs = (x, *args, *back)
            nbytes, lookups = serving_costs("fused_attn_out_mlp", cargs, kw, lut_bytes(lut))
            tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
            print(f"  fused_attn_out_mlp per-row, {C} slots over Tcap 128: {t:.4f} ms on device "
                  f"(bound {tb:.4f} ms: {bound_kind(nbytes, lookups, lookups_per_s)}), plain "
                  f"{tp:.2f} ms")
            # The 3-launch tick's other two kernels at the stream's 8 rows.
            attn = randn(C, H * dh, scale=0.3)
            qkv = (x, 1 + 0.1 * randn(d), randn(d, H * dh, scale=d ** -0.5),
                   randn(d, KV * dh, scale=d ** -0.5), randn(d, KV * dh, scale=d ** -0.5))
            for kname, fn, cargs in (
                    ("fused_qkv_norm", chain.fused_qkv_norm, qkv),
                    ("fused_out_mlp", chain.fused_out_mlp, (x, attn, *back))):
                t = queued_ms(lambda: fn(*cargs, lut, M, eps=cfg.norm_eps), reps=5)
                nbytes, lookups = serving_costs(kname, cargs, {}, lut_bytes(lut))
                tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
                print(f"  {kname} at {C} rows: {t:.4f} ms on device (bound {tb:.4f} ms: "
                      f"{bound_kind(nbytes, lookups, lookups_per_s)})")
        # Per-row positions that agree across the rows: the shared bits.
        for T in TICKS:
            q_pos = torch.tensor([T - 5], dtype=torch.int32, device=dev)
            k_pos = _ring_positions(T, T - 4, dev)
            q, k, v = randn(C, 1, H, dh), randn(C, T, KV, dh), randn(C, T, KV, dh)
            rows = (q_pos.expand(C, 1).contiguous(), k_pos.expand(C, T).contiguous())
            require(same_bits(attn_mod.approx_attention(q, k, v, *rows, lut, M),
                              attn_mod.approx_attention(q, k, v, q_pos, k_pos, lut, M)),
                    f"approx_attention {tag}: per-row positions that agree differ from shared "
                    f"ones over T={T}")
            if T <= 128:
                require(same_bits(
                    chain.fused_attn_out_mlp(x, q, k, v, *rows, *back, lut, M, eps=cfg.norm_eps),
                    chain.fused_attn_out_mlp(x, q, k, v, q_pos, k_pos, *back, lut, M,
                                             eps=cfg.norm_eps)),
                    f"fused_attn_out_mlp {tag}: per-row positions that agree differ from shared "
                    f"ones over T={T}")
        print(f"per-row kernels == plain (bit for bit): {tag} LUT at {LM_ARCH} widths: attention "
              f"at {', '.join(cases)}; attention+out-mlp at {C} slots over Tcap 128; inf and NaN "
              f"in every unread key; per-row positions that agree give the shared bits")
    return err


def stream_args(argv, **changes):
    """``launch.serve``'s arguments of ``argv``, with ``changes`` set."""
    from repro_torch.launch import serve as serve_cli
    args = serve_cli.build_parser().parse_args(argv)
    vars(args).update(changes)
    return args


def stream_outcome(engine) -> dict:
    return {rid: (r.out, r.status, r.preemptions, r.tier) for rid, r in engine.finished.items()}


def run_stream_once(model, args, n_pages=None):
    """The stream of ``args`` through ``launch.serve``'s engine (``n_pages``
    pages a lane); returns (engine, wall seconds of its run)."""
    from repro_torch.launch import serve as serve_cli
    engine = serve_cli.stream_engine(args, model, n_pages)
    stream = serve_cli.synthetic_stream(args, model.cfg.vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(stream)
    torch.cuda.synchronize()
    return engine, time.perf_counter() - t0


def stream_depth2(dev) -> dict:
    """Phase 7b: depth 2 at full width.  A ragged two-tier stream (granite-3-2b
    and granite-moe, pools of 4 pages to preempt); granite-3-2b's per-op
    path (REPRO_DECODE_FUSED=0) the chain's tokens; one request's paged
    decode logits bitwise the ring engine's; a windowed stream recycling a
    5-page pool, amsim token for token amsim_torch."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import init_lm
    counters = {**serving_counters(), **moe_counters()}
    for arch in (LM_ARCH, MOE_ARCH):
        args = stream_args(["--arch", arch, *STREAM_DEPTH2])
        cfg = dataclasses.replace(get_arch(arch), n_layers=args.n_layers)
        model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        max_len = args.prompt_len + args.new_tokens + 1
        pool = 4   # 3 usable pages a lane: two residents overcommit it
        zero_launches(counters)
        eng, _ = run_stream_once(model, args, pool)
        chain_outcome = stream_outcome(eng)
        got = launches_of(counters)
        want = ("approx_gemm", "approx_attention", "fused_qkv_norm") + (
            ("fused_attn_out_mlp",) if arch == LM_ARCH else ("fused_wo_norm", "fused_moe_ffn"))
        require(all(got[k] > 0 for k in want), f"{arch} depth-2 stream: launches {got}")
        pre = sum(r.preemptions for r in eng.finished.values())
        require(pre > 0, f"{arch} depth-2 stream: no preemption in pools of {pool} pages")
        print(f"{arch} depth 2, a stream of {args.stream} requests (prompts "
              f"{args.min_prompt_len}-{args.prompt_len}, {args.new_tokens} new tokens, "
              f"Tcap {-(-max_len // args.page_size) * args.page_size}): "
              f"{eng.decode_ticks} decode ticks, {pre} preemptions, launches "
              f"{ {k: n for k, n in got.items() if n} }")
        if arch == LM_ARCH:
            os.environ["REPRO_DECODE_FUSED"] = "0"
            try:
                zero_launches(counters)
                eng, _ = run_stream_once(model, args, pool)
            finally:
                del os.environ["REPRO_DECODE_FUSED"]
            got = launches_of(counters)
            require(got["fused_qkv_norm"] == got["fused_attn_out_mlp"] == 0,
                    f"REPRO_DECODE_FUSED=0 still launched the chain: {got}")
            require(stream_outcome(eng) == chain_outcome, "the per-op path (REPRO_DECODE_FUSED=0) "
                    "gives other tokens than the chain")
            print("  the per-op path (REPRO_DECODE_FUSED=0, no chain launch) gives the chain's "
                  "tokens")
            paged_vs_ring(model, dev)
            windowed_stream(model)
        del model
        torch.cuda.empty_cache()


def paged_vs_ring(model, dev):
    """One request of 16 tokens and 8 decode steps under amsim: the paged
    cache's logits (4 pages of 16 in position order) bitwise the ring
    engine's over 64 slots."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.models.transformer import init_paged_lm_caches, lm_forward
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.scheduler import _merge_control
    cfg = model.cfg
    policy = NumericsPolicy(mode="amsim", multiplier="afm16")
    ring, ps, new = 64, 16, 8
    prompt = torch.randint(1, cfg.vocab, (1, 16), generator=torch.Generator().manual_seed(SEED))
    prompt = prompt.to(dev)
    toks, logits = ServingEngine(model, policy, max_len=ring).generate(prompt, new,
                                                                       return_logits=True)
    pools = init_paged_lm_caches(cfg, ring // ps + 1, ps, dev)
    ptab = torch.arange(1, ring // ps + 1, dtype=torch.int32, device=dev)[None]
    live = torch.ones((1,), dtype=torch.bool, device=dev)
    kept, tok = [], prompt
    for i in range(new):
        start = torch.full((1,), 0 if i == 0 else prompt.shape[1] + i - 1, dtype=torch.int32,
                           device=dev)
        lg, _, _ = lm_forward(model, tok, policy,
                              caches=_merge_control(pools, ptab, live, start))
        kept.append(lg[:, -1:])
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    paged = torch.cat(kept, dim=1)
    torch.cuda.synchronize()
    require(same_bits(paged, logits), f"paged decode logits differ from the ring engine's by "
            f"{(paged - logits).abs().max().item()}")
    print(f"  one request, prompt 16, {new} tokens under amsim: the paged cache's logits "
          f"(pages of {ps}, per-row positions) bitwise the ring engine's ({ring} slots)")


def windowed_stream(model):
    """sliding_window=8: a request of 40 new tokens inside a 5-page pool of
    4-token pages; amsim == amsim_torch, every page back at the end."""
    import copy
    import dataclasses
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.serve.scheduler import ContinuousBatchingEngine
    mw = copy.copy(model)           # the same weights under the windowed config
    mw.cfg = dataclasses.replace(model.cfg, sliding_window=8)
    prompt = torch.randint(1, mw.cfg.vocab, (5,), generator=torch.Generator().manual_seed(SEED))
    outs = []
    for mode in ("amsim", "amsim_torch"):
        eng = ContinuousBatchingEngine(mw, NumericsPolicy(mode=mode, multiplier="afm16"),
                                       max_len=64, capacity=1, page_size=4, n_pages=5)
        rid = eng.submit(prompt.tolist(), 40)
        outs.append(eng.drain()[rid])
        require(eng.n_free_pages["default"] == 4 and eng.pages_high["default"] <= 4,
                f"windowed stream: {eng.n_free_pages} pages free at the end, "
                f"{eng.pages_high} at most held")
    require(outs[0] == outs[1], "windowed stream: amsim tokens differ from amsim_torch")
    print(f"  windowed stream (sliding_window 8): 40 tokens in a pool of 4 usable pages of 4, "
          f"pages recycled, amsim == amsim_torch; tokens {outs[0][:8]}")


class StreamProbe:
    """Counts, for each lane of ``engine``, the kernel launches of each
    decode tick (around its step) and the device-to-host waits of each
    decode tick (upload, step, read-back) under
    ``torch.cuda.set_sync_debug_mode("warn")``, which warns at each wait."""

    def __init__(self, engine, counters, records):
        self.launches = {n: [] for n in engine._lanes}
        self.waits = {n: [] for n in engine._lanes}
        for name, lane in engine._lanes.items():
            lane.step = self._counted(lane.step, name, counters)
        orig = engine._decode

        def decode(lane, finished):
            n0, t0 = len(records), lane.decode_ticks
            orig(lane, finished)
            if lane.decode_ticks > t0:
                self.waits[lane.name].append(len(records) - n0)
        engine._decode = decode

    def _counted(self, step, name, counters):
        def counted(*a):
            before = launches_of(counters)
            out = step(*a)
            self.launches[name].append({k: n - before[k] for k, n in launches_of(counters).items()})
            return out
        return counted

    def per_tick(self, name) -> dict:
        ticks = self.launches[name]
        total = {k: sum(t[k] for t in ticks) for k in (ticks[0] if ticks else {})}
        return {k: n / len(ticks) for k, n in total.items() if n}


def probed_stream(model, args, counters, n_pages=None):
    """The stream of ``args`` through ``launch.serve``'s engine with a
    ``StreamProbe``; returns (engine, probe, wall seconds)."""
    import warnings
    from repro_torch.launch import serve as serve_cli
    engine = serve_cli.stream_engine(args, model, n_pages)
    stream = serve_cli.synthetic_stream(args, model.cfg.vocab)
    with warnings.catch_warnings(record=True) as records:
        warnings.simplefilter("always")
        probe = StreamProbe(engine, counters, records)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            engine.run(stream)
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return engine, probe, wall


def tick_busy(engine, name) -> tuple:
    """(wall ms, busy ms) of one decode step of lane ``name`` with every
    slot live, at positions spread over the table, after the stream (a step
    at fixed shape: dead slots cost what live ones do)."""
    lane = engine._lanes[name]
    C, n_ptab, ps = engine.capacity, engine.n_ptab, engine.page_size
    tcap = n_ptab * ps
    dev = engine.device
    pages = torch.arange(1, C * n_ptab + 1, dtype=torch.int32) % (lane.alloc.n_pages - 1) + 1
    ptab = pages.reshape(C, n_ptab).to(dev)
    start = torch.linspace(16, tcap - 2, C).to(torch.int32).to(dev)
    live = torch.ones((C,), dtype=torch.bool, device=dev)
    tokens = torch.ones((C, 1), dtype=torch.int32, device=dev)
    step = lane._step          # the built step itself, not the probe around it

    def one():
        step(tokens, live, start, ptab, lane.caches)
    return cuda_ms(one, reps=3), busy_ms(one, reps=2)


def report_probe(engine, probe, wall, smi_line, busy=None) -> None:
    for name, lane in engine._lanes.items():
        ticks = lane.decode_ticks
        waits = probe.waits[name]
        line = (f"  tier {name}: {ticks} decode ticks, launches a tick "
                f"{ {k: round(v, 3) for k, v in probe.per_tick(name).items()} }, device-to-host "
                f"waits a tick {sum(waits) / max(len(waits), 1):.2f} (max {max(waits or [0])})")
        if busy and name in busy:
            w, b = busy[name]
            line += (f"; a full tick ({engine.capacity} slots live, Tcap "
                     f"{engine.n_ptab * engine.page_size}): {w:.3f} ms by CUDA events, "
                     f"{busy_text(b, w)}")
        print(line)
    print(f"  ({smi_line})")


def clean_then_probed(model, args, counters, smi_line, what) -> tuple:
    """The stream of ``args`` as ``python -m repro_torch.launch.serve``
    runs it (``run_stream``: nothing around the engine; its numbers
    printed), then again with ``counters`` zeroed just before it and a
    ``StreamProbe`` under ``set_sync_debug_mode("warn")``: it must emit the
    same tokens.  Prints the probed run's launches, waits and a full
    tick's busy time, and its wall beside the clean one's.  Returns (the
    clean engine's outcome, its report, the probed run's launches)."""
    from repro_torch.launch import serve as serve_cli
    torch.cuda.synchronize()
    engine, rep = serve_cli.run_stream(args, model)
    torch.cuda.synchronize()
    require(all(r.status == "ok" and len(r.out) == args.new_tokens
                for r in engine.finished.values()) and len(engine.finished) == args.stream,
            f"the {what} did not complete every request")
    clean = stream_outcome(engine)
    del engine
    torch.cuda.empty_cache()
    zero_launches(counters)
    engine, probe, wall = probed_stream(model, args, counters)
    got = launches_of(counters)
    require(stream_outcome(engine) == clean, f"the {what} run again (probed) emitted other "
            f"tokens: a stream must repeat, with no deterministic algorithms asked for")
    busy = {n: tick_busy(engine, n) for n in engine._lanes}
    print(f"  again with counters and a probe around each tick (the same tokens): "
          f"{wall:.3f} s against the clean run's {rep['stream']['s']:.3f} s")
    report_probe(engine, probe, wall, smi_line, busy)
    print(f"launches on the {what} (its probed run): {got}")
    del engine
    torch.cuda.empty_cache()
    return clean, rep, got


def stream_full(dev, smi_line) -> dict:
    """Phase 7c: granite-3-2b at full width and depth, the stream of
    ``STREAM`` through ``launch.serve``'s engine (clean, then probed).
    Returns the launches of the probed run."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import init_lm
    args = stream_args(STREAM)
    cfg = get_arch(args.arch)
    t0 = time.perf_counter()
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    torch.cuda.synchronize()
    print(f"{args.arch} at full width and depth ({cfg.n_layers} layers) drawn in "
          f"{time.perf_counter() - t0:.1f} s; `python -m repro_torch.launch.serve "
          f"{' '.join(STREAM)}` ({smi_line}):")
    counters = serving_counters()
    _, _, got = clean_then_probed(model, args, counters, smi_line, "granite-3-2b stream")
    for k in ("approx_gemm", "approx_attention", "fused_qkv_norm", "fused_out_mlp"):
        require(got[k] > 0, f"{k} never launched on the stream: {got}")
    del model
    torch.cuda.empty_cache()
    return got


def moe_stream_full(dev, smi_line) -> dict:
    """Phase 7d: granite-moe-3b-a800m at full width and depth, the stream
    of ``MOE_STREAM`` (clean, then probed: the same tokens).  Returns the
    launches of the probed run."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import init_lm
    args = stream_args(MOE_STREAM)
    cfg = get_arch(args.arch)
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    print(f"{args.arch} at full width and depth ({cfg.n_layers} layers): `python -m "
          f"repro_torch.launch.serve {' '.join(MOE_STREAM)}` ({smi_line}):")
    _, _, got = clean_then_probed(model, args, moe_counters(), smi_line, "granite-moe stream")
    for k in ("approx_gemm", "approx_attention", "fused_qkv_norm", "fused_wo_norm",
              "fused_moe_ffn"):
        require(got[k] > 0, f"{k} never launched on the MoE stream: {got}")
    print("  (the MoE tick's waits: the capacity scatter's boolean index, models/moe.py)")
    del model
    torch.cuda.empty_cache()
    return got


def continuous_batching(dev, gen, lut_case, lookups_per_s, smi_line, phase_done) -> None:
    """Phase 7: 7a-7d; 7c and 7d print their own launches."""
    err = stream_kernel_checks(dev, gen, lut_case, lookups_per_s)
    phase_done("7a per-row kernels vs plain")
    stream_depth2(dev)
    phase_done("7b streams, depth 2")
    stream_full(dev, smi_line)
    phase_done("7c stream, full depth")
    moe_stream_full(dev, smi_line)
    phase_done("7d MoE stream, full depth")
    print(f"per-row max|d| {err}")


# ------------------------------------------------- the SSM families
# Phase 8: Mamba2 (SSD) and the zamba2 hybrid through ``ServingEngine`` and
# ``launch.train``'s step.  At a cut depth the hybrid's shared block comes
# after every 2nd layer (``ssm_cfg``), so that depth 2 runs it once.
SSM_ARCHS = ("mamba2-780m", "zamba2-1.2b")
# 8b trains mamba2 on rows of 2 chunks of 16 (the chunk-state recurrence and
# every SSD gradient product run; the plain versions' cost grows with the
# rows), zamba2 on one chunk (its shared block is what it adds); the
# products at the config's chunk of 256 are held in 8a and 8c.  8b takes
# one step of it and the gradient after it (6a holds adamw's second step).
SSM_DEPTH2 = dict(batch=1, prompt=16, new=4, window=8, train_batch=1, seq=32, chunk=16,
                  steps=1)
SSM_FULL = dict(batch=4, prompt=64, new=8, capture_ring=96)    # 8a's ring: 64 + 32
SSM_TRAIN = dict(batch=4, seq=256, steps=2)
SSM_CUT_WINDOW = 32          # 8a: a zamba2 prefill of 64 tokens into a ring of 32
SSM_CAPTURE_SEQ = 512        # 8a: a training row of two chunks at the config's 256
# 8a does not replay GEMM shapes that 3d holds under the same tables
# (granite-3-2b's FFN at 4 x 64 rows: the shared block's wg/wu/wd).
SSM_KNOWN_GEMMS = {((256, 2048), (2048, 8192)), ((256, 8192), (8192, 2048))}
# 8a holds a product of more lookups than this (the heads at 4 x 64 rows)
# under the first table only: its plain version takes seconds a table.
SSM_ALL_TABLES_MAX = 6e9
# Where a kernel wrapper takes its table (M follows it).
SSM_LUT_SLOT = {**LUT_SLOT, **LUT_ARG}


def ssm_counters():
    from repro_torch.kernels import approx_gemm as gemm_mod
    return {**serving_counters(), "approx_gemm_batched": gemm_mod.approx_gemm_batched}


def ssm_plains():
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import approx_gemm as gemm_mod
    from repro_torch.kernels import decode_chain as chain
    return {"approx_gemm": gemm_mod.approx_gemm_plain,
            "approx_gemm_batched": gemm_mod.approx_gemm_batched_plain,
            "approx_attention": attn_mod.approx_attention_plain,
            "fused_qkv_norm": chain.fused_qkv_norm_plain,
            "fused_out_mlp": chain.fused_out_mlp_plain,
            "fused_attn_out_mlp": chain.fused_attn_out_mlp_plain}


def ssm_cfg(arch, n_layers=None, **changes):
    """``arch`` at full width; at a cut depth (``n_layers``) the hybrid's
    shared block after every 2nd layer."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    cfg = get_arch(arch)
    if n_layers is not None:
        changes["n_layers"] = n_layers
        if cfg.attn_every:
            changes["attn_every"] = 2
    return dataclasses.replace(cfg, **changes)


def _shared_blocks(cfg) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def ssm_serve_want(cfg, *, prefill: bool, steps: int, ring: int) -> dict:
    """Launches of a prefill (or none) and ``steps`` decode steps under
    amsim: a Mamba2 layer's 2 GEMMs (in_proj, out_proj; its recurrence runs
    no kernel), each shared block's 7 GEMMs and attention in the prefill
    and its 2 chain launches a decode step (3 over a ring above 128), the
    head's GEMM."""
    L, A, pre = cfg.n_layers, _shared_blocks(cfg), int(prefill)
    fused = ring <= 128
    return {"approx_gemm": (2 * L + 7 * A + 1) * pre + (2 * L + 1) * steps,
            "approx_gemm_batched": 0,
            "approx_attention": A * pre + (0 if fused else A) * steps,
            "fused_qkv_norm": A * steps, "fused_out_mlp": (0 if fused else A) * steps,
            "fused_attn_out_mlp": (A if fused else 0) * steps}


def ssm_train_want(cfg, seq: int) -> dict:
    """Launches of one training step at ``seq`` tokens a row under amsim: a
    Mamba2 layer's 2 GEMMs forward and two gradient products of each; its
    SSD products, 4 forward and 8 backward, or 2 and 4 when the row is one
    chunk (the scan then runs the scores and intra-chunk products alone);
    the forward again in the backward under remat (mamba2; the hybrid stack
    has none, as in JAX); each shared block's 7 GEMMs + 14 backward, one
    attention and 6 batched GEMMs of its recomputed gradient; the head's
    3."""
    L, A = cfg.n_layers, _shared_blocks(cfg)
    r = 2 if cfg.remat and not cfg.attn_every else 1
    ssd = 2 if seq > cfg.ssm.chunk else 1
    return {"approx_gemm": (2 * r + 4) * L + 21 * A + 3,
            "approx_gemm_batched": (2 * r + 4) * ssd * L + 6 * A, "approx_attention": A,
            "fused_qkv_norm": 0, "fused_out_mlp": 0, "fused_attn_out_mlp": 0}


def call_costs(kname, args, kw) -> tuple[int, int]:
    """(bytes, lookups this run's data needs) of one captured call of a
    kernel wrapper: the GEMMs, the attention, the decode chain and the MoE
    kernels."""
    from repro_torch.kernels.common import lut_bytes
    if kname.startswith("approx_gemm"):
        return gemm_costs(*args[:3])
    if kname in ("fused_wo_norm", "fused_moe_ffn"):
        return moe_costs(kname, args, kw)
    return serving_costs(kname, args, kw, lut_bytes(args[SSM_LUT_SLOT[kname]]))


def ssm_plan_text(kname, args, kw) -> str:
    """The launch plan and grid of a captured call."""
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import decode_chain as chain
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lut = args[SSM_LUT_SLOT[kname]]
    if kname.startswith("approx_gemm"):
        return gemm_plan_text(*args[:3])
    if kname == "approx_attention":
        shape = attn_mod.attention_shape(args[0].shape, args[1].shape, kw.get("causal", True))
        plan = attn_mod.attention_plan(shape, lut, sms)
        return f"plan {plan}; grid {attn_mod.attention_grid(plan, shape, lut)}"
    if kname == "fused_qkv_norm":
        return f"grid {qkv_grid_of(args)}"
    x = args[0]
    fused = kname == "fused_attn_out_mlp"
    heads, kv = (args[1].shape[2], args[2].shape[2]) if fused else (0, 0)
    wg = args[8] if fused else args[4]
    grid = chain.back_half_grid(x.shape[0], x.shape[1], wg.shape[1], lut, heads=heads,
                                kv_heads=kv)
    return f"grid (work items a phase) {grid}"


def ssm_capture(dev) -> dict:
    """8a's calls: the kernels of the SSM paths at full width, depth 2,
    under amsim/afm16 -- each model served at batch 4, prompt 64 (the
    prefill and a decode step; zamba2 again with its window cut to
    ``SSM_CUT_WINDOW``: a ring shorter than the prompt), and the batched
    SSD products and the attention of one training forward and backward at
    1 x ``SSM_CAPTURE_SEQ`` (two chunks: the chunk-state and inter-chunk
    products run).  {(kernel, shapes, kw): (args cloned, kw, where)}, a call
    a distinct shape."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm, init_lm_caches, lm_loss
    from repro_torch.serve.engine import ServingEngine
    names = list(SSM_LUT_SLOT)
    originals = {k: getattr(ops, k) for k in names}
    calls, where = {}, [""]
    amsim = NumericsPolicy(mode="amsim", multiplier="afm16")

    def capture(kname, keep):
        def wrapped(*a, **kw):
            key = (kname, tuple(tuple(t.shape) for t in a if torch.is_tensor(t)),
                   tuple(sorted(kw.items())))
            if keep and key not in calls:
                calls[key] = (tuple(t.clone() if torch.is_tensor(t) else t for t in a), kw,
                              where[0])
            return originals[kname](*a, **kw)
        return wrapped

    B, P = SSM_FULL["batch"], SSM_FULL["prompt"]
    ring = SSM_FULL["capture_ring"]
    for arch in SSM_ARCHS:
        cfg = ssm_cfg(arch, 2)
        model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        prompts = torch.randint(0, cfg.vocab, (B, P),
                                generator=torch.Generator().manual_seed(SEED)).to(dev)
        runs = [(f"{arch} serving", cfg)]
        if cfg.attn_every:
            runs.append((f"{arch} serving, window {SSM_CUT_WINDOW}",
                         ssm_cfg(arch, 2, sliding_window=SSM_CUT_WINDOW)))
        for label, rcfg in runs:
            model.cfg = rcfg
            engine = ServingEngine(model, amsim, max_len=ring)
            for k in names:
                setattr(ops, k, capture(k, True))
            try:
                where[0] = f"{label} prefill"
                _, nxt, caches = engine.prefill(prompts, init_lm_caches(rcfg, B, ring, dev))
                where[0] = f"{label} decode"
                engine.step(nxt, caches)
                torch.cuda.synchronize()
            finally:
                for k, f in originals.items():
                    setattr(ops, k, f)
        model.cfg = cfg
        batch = lm_batch(cfg, (1, SSM_CAPTURE_SEQ), 0, dev)
        for k in names:
            setattr(ops, k, capture(k, k in ("approx_gemm_batched", "approx_attention")))
        try:
            where[0] = f"{arch} training 1 x {SSM_CAPTURE_SEQ}"
            loss, _ = lm_loss(model, batch, amsim)
            torch.autograd.grad(loss, list(model.parameters()))
            torch.cuda.synchronize()
        finally:
            for k, f in originals.items():
                setattr(ops, k, f)
        del model, engine, caches, loss
        torch.cuda.empty_cache()
    return calls


def ssm_kernel_checks(dev, lut_case, lookups_per_s) -> dict:
    """Phase 8a: each captured call (``ssm_capture``) again under each
    table form of 3d (``FORM_LUTS``) against its plain version, bit for bit as int32 (+0.0 and
    -0.0 apart); each shape's plan and grid, and its device time under
    afm16.  Returns each kernel's largest |difference|."""
    from repro_torch.kernels import ops
    calls = ssm_capture(dev)
    plains = ssm_plains()
    kernels = {k: getattr(ops, k) for k in SSM_LUT_SLOT}
    err = dict.fromkeys(SSM_LUT_SLOT, 0.0)
    for i, (lut_name, packed) in enumerate(FORM_LUTS):
        lut, M = lut_case(lut_name, packed)
        tag = f"{lut_name} {'packed' if packed else 'canonical'}"
        held = skipped = large = 0
        for (kname, shapes, _), (args, kw, where) in calls.items():
            if kname == "approx_gemm" and shapes[:2] in SSM_KNOWN_GEMMS:
                skipped += 1
                continue
            if i and call_costs(kname, args, kw)[1] > SSM_ALL_TABLES_MAX:
                large += 1
                continue
            slot = SSM_LUT_SLOT[kname]
            a = list(args)
            a[slot], a[slot + 1] = lut, M
            plain_kw = dict(kw)
            if kname in ("approx_attention", "fused_attn_out_mlp"):
                plain_kw.setdefault("causal", True)
                plain_kw.setdefault("window", 0)
            out, ref = kernels[kname](*a, **kw), plains[kname](*a, **plain_kw)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            e = max((x - y).abs().max().item() for x, y in zip(outs, refs))
            require(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                        for x, y in zip(outs, refs)),
                    f"8a {kname} {tag} at {shapes} ({where}): not bitwise its plain version, "
                    f"max|d| {e}")
            err[kname] = max(err[kname], e)
            held += 1
            if i == 0:
                t = queued_ms(lambda: kernels[kname](*a, **kw), reps=3)
                nbytes, lookups = call_costs(kname, a, kw)
                tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
                print(f"  {where}: {kname} {shapes}: {t:.4f} ms on device (bound {tb:.4f} ms, "
                      f"{bound_kind(nbytes, lookups, lookups_per_s)}; {lookups} lookups); "
                      f"{ssm_plan_text(kname, a, kw)}")
            del out, ref, outs, refs
        first = f", {large} held under the first table only" if large else ""
        print(f"SSM kernels == plain (bitwise): {tag}, {held} shapes of the SSM paths "
              f"({skipped} GEMM shapes held in 3d{first})")
    del calls
    torch.cuda.empty_cache()
    return err


def ssm_serving_depth2(dev, cfg, label) -> None:
    """8b serving: batch 1, prompt 16, 4 new tokens under amsim and
    amsim_torch (deterministic algorithms): prefill logits, every decode
    step's logits and tokens bitwise; the amsim launches."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.models.transformer import init_lm, init_lm_caches
    from repro_torch.serve.engine import ServingEngine
    B, P, N = SSM_DEPTH2["batch"], SSM_DEPTH2["prompt"], SSM_DEPTH2["new"]
    max_len = P + N
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompts = torch.randint(0, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(SEED)).to(dev)
    counters = ssm_counters()
    ring = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    want = ssm_serve_want(cfg, prefill=True, steps=N - 1, ring=ring)
    results = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("amsim", "amsim_torch"):
            engine = ServingEngine(model, NumericsPolicy(mode=mode, multiplier="afm16"),
                                   max_len=max_len)
            zero_launches(counters)
            toks, logits = engine.generate(prompts, N, return_logits=True)
            torch.cuda.synchronize()
            got = launches_of(counters)
            full, _, _ = engine.prefill(prompts, init_lm_caches(cfg, B, max_len, dev))
            results[mode] = (toks, logits, full)
            if mode == "amsim":
                require(got == want, f"8b {label}: launches {got}, want {want}")
    finally:
        torch.use_deterministic_algorithms(False)
    (t_a, l_a, f_a), (t_p, l_p, f_p) = results["amsim"], results["amsim_torch"]
    require(bool(torch.isfinite(l_a).all()) and bool(torch.isfinite(f_a).all()),
            f"8b {label}: logits not finite")
    require(_same([f_a], [f_p]), f"8b {label}: prefill logits differ from amsim_torch by "
            f"{(f_a - f_p).abs().max().item()}")
    require(_same([l_a], [l_p]) and torch.equal(t_a, t_p),
            f"8b {label}: decode differs from amsim_torch (logits max|d| "
            f"{(l_a - l_p).abs().max().item()}, tokens equal {torch.equal(t_a, t_p)})")
    print(f"{label}: batch {B}, prompt {P}, {N} new tokens, "
          f"{'ring ' + str(ring) if cfg.attn_every else 'no attention'}: prefill logits, "
          f"{N - 1} decode steps' logits and tokens bitwise equal to amsim_torch; amsim launches "
          f"{ {k: v for k, v in want.items() if v} }; tokens {t_a[0].tolist()}")
    del model, results
    torch.cuda.empty_cache()


def ssm_train_depth2(dev, cfg, label, seq) -> None:
    """8b training: an adamw step at 1 x ``seq``, bitwise amsim_torch
    (``train_step_bitwise``)."""
    shape = dict(batch=SSM_DEPTH2["train_batch"], seq=seq, steps=SSM_DEPTH2["steps"])
    train_step_bitwise(dev, cfg, label, shape, ssm_counters(), ssm_train_want(cfg, seq))


def ssm_serving_full(dev, arch, lookups_per_s, smi_line) -> None:
    """8c serving: ``arch`` at full width and depth, batch 4, prompt 64, 8
    new tokens under amsim: prefill ms, ms a decode step, tokens/s, idle
    shares; the run's launches (counters zeroed just before it) on a line
    of their own; the GEMM kernel's device time at the prefill's and a
    decode step's shapes."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm, init_lm_caches
    from repro_torch.serve.engine import ServingEngine
    cfg = get_arch(arch)
    B, P, N = SSM_FULL["batch"], SSM_FULL["prompt"], SSM_FULL["new"]
    max_len = P + N
    ring = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    t0 = time.perf_counter()
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    weight_bytes = 4 * sum(p.numel() for p in model.parameters())
    print(f"{arch} at full width and depth ({cfg.n_layers} layers, {_shared_blocks(cfg)} shared "
          f"blocks, {weight_bytes / 1e9:.2f} GB of float32 weights) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; batch {B}, prompt {P}, {N} new tokens"
          f"{', ring ' + str(ring) if cfg.attn_every else ''} ({smi_line}):")
    prompts = torch.randint(0, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(SEED)).to(dev)
    counters = ssm_counters()
    want = ssm_serve_want(cfg, prefill=True, steps=N - 1, ring=ring)
    amsim = NumericsPolicy(mode="amsim", multiplier="afm16")
    for pname, policy in (("amsim", amsim),):
        engine = ServingEngine(model, policy, max_len=max_len)
        engine.generate(prompts, 2)          # warm-up
        zero_launches(counters)
        timings = {}
        toks = engine.generate(prompts, N, timings=timings)
        got = launches_of(counters)
        require(got == want, f"8c {arch} serving: launches {got}, want {want}")
        require(toks.shape == (B, N) and bool((toks >= 0).all() & (toks < cfg.vocab).all()),
                f"8c {arch} {pname}: tokens out of range")
        caches = init_lm_caches(cfg, B, max_len, dev)
        _, nxt, caches = engine.prefill(prompts, caches)
        busy_step = busy_ms(lambda: engine.step(nxt, caches), reps=3)
        busy_pre = busy_ms(lambda: engine.prefill(prompts, init_lm_caches(cfg, B, max_len, dev)),
                           reps=1)
        pre_ms = timings["prefill_s"] * 1e3
        step_ms = timings["decode_s"] * 1e3 / timings["decode_steps"]
        print(f"  {pname}: prefill {pre_ms:.2f} ms ({busy_text(busy_pre, pre_ms)}), "
              f"{step_ms:.3f} ms per decode step ({busy_text(busy_step, step_ms)}), "
              f"{B * N / (timings['prefill_s'] + timings['decode_s']):.2f} tokens/s; tokens "
              f"{toks[0, :8].tolist()}")
    print(f"launches on the {arch} serving run (8c, amsim, prefill and {N - 1} decode steps): "
          f"{got}")
    # The GEMM kernel at this run's shapes: a prefill and a decode step.
    original = ops.approx_gemm
    for ctx in ("prefill", "decode step"):
        shapes = {}

        def wrapped(*a, **kw):
            shapes.setdefault((tuple(a[0].shape), tuple(a[1].shape)), [a, 0])[1] += 1
            return original(*a, **kw)

        caches = init_lm_caches(cfg, B, max_len, dev)
        _, nxt, caches = engine.prefill(prompts, caches)
        ops.approx_gemm = wrapped
        try:
            if ctx == "prefill":
                engine.prefill(prompts, init_lm_caches(cfg, B, max_len, dev))
            else:
                engine.step(nxt, caches)
            torch.cuda.synchronize()
        finally:
            ops.approx_gemm = original
        total = bound = 0.0
        n_all = 0
        for (sa, sb), (a, n) in sorted(shapes.items()):
            t = queued_ms(lambda: original(*a), reps=3)
            nbytes, lookups = gemm_costs(*a[:3])
            tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
            total, bound, n_all = total + n * t, bound + n * tb, n_all + n
            print(f"  {ctx}: approx_gemm {sa}x{sb} x {n}: {t:.4f} ms each, bound {tb:.4f} ms "
                  f"({bound_kind(nbytes, lookups, lookups_per_s)}); {gemm_plan_text(*a[:3])}")
        print(f"  {ctx}: approx_gemm {total:.2f} ms on device over {n_all} launches, bound "
              f"{bound:.2f} ms")
    del model, engine, caches
    torch.cuda.empty_cache()


def ssm_families(dev, lut_case, lookups_per_s, smi_line, phase_done, train=True) -> dict:
    """Phase 8: 8a-8c; 8c prints each full-depth run's launches on a line of
    its own; 8c's training unless not ``train`` (``ssm_training``).
    Returns each kernel's largest |difference| in 8a."""
    import dataclasses
    err = ssm_kernel_checks(dev, lut_case, lookups_per_s)
    phase_done("8a SSM kernels vs plain")
    for arch in SSM_ARCHS:
        cfg = ssm_cfg(arch, 2)
        label = f"{arch} depth 2" + (", shared block after layer 2" if cfg.attn_every else "")
        ssm_serving_depth2(dev, cfg, label)
        if cfg.attn_every:
            ssm_serving_depth2(dev, ssm_cfg(arch, 2, sliding_window=SSM_DEPTH2["window"]),
                               f"{label}, window {SSM_DEPTH2['window']}")
        chunk, seq = SSM_DEPTH2["chunk"], SSM_DEPTH2["seq"]
        tcfg = ssm_cfg(arch, 2, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
        if cfg.attn_every:      # the shared block after both layers: its gradients add up
            tcfg = dataclasses.replace(tcfg, attn_every=1)
            label, seq = f"{arch} depth 2, the shared block after layers 1 and 2", chunk
        ssm_train_depth2(dev, tcfg, f"{label}, chunk {chunk}", seq)
    phase_done("8b SSM serving and training, depth 2")
    for arch in SSM_ARCHS:
        ssm_serving_full(dev, arch, lookups_per_s, smi_line)
    phase_done("8c SSM serving, full depth")
    if train:
        ssm_training(dev, lookups_per_s, smi_line, phase_done)
    return err


def ssm_training(dev, lookups_per_s, smi_line, phase_done) -> None:
    """8c's training: each model's ``SSM_TRAIN`` steps at full width and
    depth, its launches on a line of their own."""
    for arch in SSM_ARCHS:
        run = train_full(dev, arch, lookups_per_s, smi_line, shape=SSM_TRAIN,
                         capture=("approx_gemm_batched",), capture_step=1)
        print(f"launches on the {arch} training run (8c, {SSM_TRAIN['steps']} steps at "
              f"{SSM_TRAIN['batch']} x {SSM_TRAIN['seq']}): {run}")
    phase_done("8c SSM training, full depth")


# ------------------------------------------------- the encoder-decoder
# Phase 9: whisper-base (``models/encdec.py``) through ``encode``, greedy
# decoding (``serve_step`` with ring caches) and ``launch.train``'s step.
# Its encoder and cross-attention run the attention kernel bidirectionally
# (``causal=False``) over the 1500 frames.
ENCDEC_ARCH = "whisper-base"
# 9a captures at batch 2; 9b decodes one row and trains one step and the
# gradient after it (6a holds adamw's second step).
ENCDEC_DEPTH2 = dict(batch=2, serve_batch=1, prompt=4, new=4, train_batch=1, seq=64, steps=1,
                     train_layers=1)
ENCDEC_FULL = dict(batch=4, prompt=4, new=16)
ENCDEC_TRAIN = dict(batch=4, seq=64, steps=2)
# 9a holds a product of more lookups than this under the first table only.
ENCDEC_ALL_TABLES_MAX = 6e9
# 9a's bidirectional special-value shapes: (label, B, S, H, KV, T, unwritten
# keys); the unwritten keys (k_pos < 0) hold inf and NaN, which no row reads.
ENCDEC_SPECIAL_SHAPES = [("encoder-like 2x96 over 200 frames", 2, 96, 8, 8, 200, 40),
                         ("cross decode 4x1 over 1500 frames", 4, 1, 8, 8, 1500, 100),
                         ("cross prefill 2x4 over 1500 frames", 2, 4, 8, 8, 1500, 7)]


def encdec_counters():
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import approx_gemm as gemm_mod
    return {"approx_gemm": gemm_mod.approx_gemm,
            "approx_gemm_batched": gemm_mod.approx_gemm_batched,
            "approx_attention": attn_mod.approx_attention}


def encdec_cfg(n_layers=None):
    """whisper-base at full width; at a cut depth ``n_layers`` encoder and as
    many decoder layers."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    cfg = get_arch(ENCDEC_ARCH)
    if n_layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=n_layers, n_enc_layers=n_layers)


def encdec_serve_want(cfg, new: int) -> dict:
    """Launches of an ``encode`` and ``new`` greedy tokens under amsim (the
    prompt's decode, then new - 1 steps): an encoder layer's 6 GEMMs (q, k,
    v, wo, wu, wd) and attention; a decoder layer's 10 GEMMs (self and
    cross q/k/v/wo, wu, wd) and 2 attentions each decode; the head's GEMM
    each decode.  The gelu decoder takes no chain kernel."""
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    return {"approx_gemm": 6 * Le + (10 * Ld + 1) * new, "approx_gemm_batched": 0,
            "approx_attention": Le + 2 * Ld * new}


def _bwd_chunks(S: int) -> int:
    """Query chunks of the attention backward's recompute at S queries
    (``ops._attention_bwd``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import best_chunk
    bqc = best_chunk(ops._BWD_Q_CHUNK, S)
    return S // bqc if S > bqc > ops._BWD_Q_CHUNK // 16 else 1


def encdec_train_want(cfg, seq: int) -> dict:
    """Launches of one training step under amsim with remat: each layer's
    GEMMs forward, recomputed and twice backward (dx, dw); its attentions
    forward and recomputed, and 6 batched GEMMs (the score and value
    products, their 4 gradients) for each query chunk of each attention's
    backward (the encoder's 1500 frames split in 2 chunks of 750); the
    head's 3 GEMMs."""
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    return {"approx_gemm": 4 * 6 * Le + 4 * 10 * Ld + 3,
            "approx_gemm_batched": 6 * Le * _bwd_chunks(cfg.n_frontend_tokens)
            + 2 * 6 * Ld * _bwd_chunks(seq),
            "approx_attention": 2 * Le + 4 * Ld}


def encdec_inputs(cfg, batch: int, prompt: int, dev):
    """(frames (batch, F, d), prompts (batch, prompt)) drawn from SEED."""
    gen = torch.Generator().manual_seed(SEED)
    frames = torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen)
    return frames.to(dev), prompts.to(dev)


def encdec_capture(dev) -> dict:
    """9a's calls: the kernels of the path at full width, depth 2, under
    amsim/afm16 -- an ``encode`` of 2 x 1500 frames, the decode of a prompt
    of 4 tokens, a decode step, and the batched products and attention of a
    training step at 1 x 64 over 1500 frames.  {(kernel, shapes, kw): (args
    cloned, kw, where)}, a call a distinct shape."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    names = list(encdec_counters())
    originals = {k: getattr(ops, k) for k in names}
    calls, where = {}, [""]
    amsim = NumericsPolicy(mode="amsim", multiplier="afm16")

    def capture(kname, keep):
        def wrapped(*a, **kw):
            key = (kname, tuple(tuple(t.shape) for t in a if torch.is_tensor(t)),
                   tuple(sorted(kw.items())))
            if keep and key not in calls:
                calls[key] = (tuple(t.clone() if torch.is_tensor(t) else t for t in a), kw,
                              where[0])
            return originals[kname](*a, **kw)
        return wrapped

    cfg = encdec_cfg(2)
    B, P = ENCDEC_DEPTH2["batch"], ENCDEC_DEPTH2["prompt"]
    model = encdec.init_encdec(cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
    frames, prompts = encdec_inputs(cfg, B, P, dev)
    for k in names:
        setattr(ops, k, capture(k, True))
    try:
        where[0] = f"encode {B} x {cfg.n_frontend_tokens}"
        enc = encdec.encode(model, frames, amsim)
        caches = encdec.init_encdec_caches(cfg, B, P + ENCDEC_DEPTH2["new"], dev)
        where[0] = f"decode of a {P}-token prompt"
        _, nxt, caches = encdec.serve_step(model, prompts, enc, caches, amsim)
        where[0] = "decode step"
        encdec.serve_step(model, nxt, enc, caches, amsim)
        torch.cuda.synchronize()
    finally:
        for k, f in originals.items():
            setattr(ops, k, f)
    batch = lm_batch(cfg, (1, ENCDEC_DEPTH2["seq"]), 0, dev)
    for k in names:
        setattr(ops, k, capture(k, k != "approx_gemm"))
    try:
        where[0] = f"training 1 x {ENCDEC_DEPTH2['seq']} over {cfg.n_frontend_tokens} frames"
        loss, _ = encdec.encdec_loss(model, batch, amsim)
        torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
    finally:
        for k, f in originals.items():
            setattr(ops, k, f)
    del model, enc, caches, loss
    torch.cuda.empty_cache()
    return calls


def encdec_tile_times(calls, lut_case):
    """The encoder's attention (2 x 1500 over 1500, causal=False) timed under
    every tile and table form of afm16 packed, beside the plan's pick: the
    plan ranks tiles by a rate fitted on causal shapes whose scores fit in
    shared memory, and picks here a tile whose scores sit in global
    memory."""
    from repro_torch.kernels import approx_attention as attn_mod
    lut, M = lut_case("afm16", True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    q, k, v, q_pos, k_pos = next(args[:5] for (kname, shapes, _), (args, kw, _) in calls.items()
                                 if kname == "approx_attention" and shapes[0][1] > 1000)
    shape = attn_mod.attention_shape(q.shape, k.shape, False)
    plan_of = attn_mod.attention_plan
    picked = plan_of(shape, lut, sms)
    nbytes = lut.numel() * lut.element_size()
    times = []
    for tile in range(len(attn_mod.ATTN_TILES)):
        for table in ("smem canonical", "smem packed"):
            space = attn_mod.SMEM_BLOCK_MAX - attn_mod._table_bytes(table, True, nbytes)
            layout = attn_mod.attention_layout(tile, shape.dh, shape.T, space)
            if layout is None:
                continue
            forced = attn_mod._tile_plan(shape, tile, table, layout, "prefill")
            attn_mod.attention_plan = lambda *a, f=forced: f
            try:
                t = queued_ms(lambda: attn_mod.approx_attention(q, k, v, q_pos, k_pos, lut, M,
                                                                causal=False), reps=3)
            finally:
                attn_mod.attention_plan = plan_of
            times.append((t, forced))
    print(f"  encoder attention {tuple(q.shape)} over {shape.T} frames under afm16 packed, every "
          f"tile and table form (the plan picks: {picked}):")
    for t, forced in sorted(times, key=lambda x: x[0]):
        print(f"    {t:.4f} ms: {forced}{'  <- the plan' if forced == picked else ''}")


def bidirectional_attention_checks(dev, gen, lut, M, tag):
    """9a: the attention kernel at causal=False on zeros, -0.0 and
    subnormals in q, k and v, with inf and NaN in every unwritten key
    (k_pos < 0, which no row may read), at ``ENCDEC_SPECIAL_SHAPES``, under
    the plan and every tile x table form, bit for bit as int32."""
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels.common import POS_PAD
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan_of = attn_mod.attention_plan
    packed = lut.dtype == torch.int16
    nbytes = lut.numel() * lut.element_size()
    tables = ["smem canonical", "smem packed"] if packed and 2 * nbytes <= 128 * 1024 else \
        [plan_of(attn_mod.AttnShape(1, 1, 1, 1, 1, 64), lut, sms).table]
    dh = 64
    for label, B, S, H, KV, T, unwritten in ENCDEC_SPECIAL_SHAPES:
        shape = attn_mod.AttnShape(B, S, H, KV, T, dh, False)
        k_pos = torch.arange(T, dtype=torch.int32)
        k_pos[torch.randperm(T, generator=gen)[:unwritten]] = POS_PAD
        k_pos = k_pos.to(dev)
        q_pos = torch.arange(S, dtype=torch.int32, device=dev)
        q, k, v = (special_values(s, gen, dev) for s in
                   ((B, S, H, dh), (B, T, KV, dh), (B, T, KV, dh)))
        q = torch.where(torch.isfinite(q), q, 0.0)
        readable = (k_pos >= 0)[None, :, None, None]
        k = torch.where(readable & ~torch.isfinite(k), -0.0, k)
        v = torch.where(readable & ~torch.isfinite(v), 1e-39, v)
        args = (q, k, v, q_pos, k_pos)
        plan = plan_of(shape, lut, sms)
        plans = [plan]
        for tile in range(len(attn_mod.ATTN_TILES)):
            for table in tables:
                space = attn_mod.SMEM_BLOCK_MAX - attn_mod._table_bytes(table, packed, nbytes)
                layout = attn_mod.attention_layout(tile, dh, T, space)
                if layout is not None:
                    plans.append(attn_mod._tile_plan(shape, tile, table, layout, plan.path))
        ref = attn_mod.approx_attention_plain(*args, lut, M, causal=False, window=0)
        for forced in plans:
            attn_mod.attention_plan = lambda *a, f=forced: f
            try:
                out = attn_mod.approx_attention(*args, lut, M, causal=False)
            finally:
                attn_mod.attention_plan = plan_of
            require(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
                    f"9a approx_attention {tag} {label}, causal=False, special values, plan "
                    f"{forced}: not bitwise its plain version")
        print(f"{tag}: approx_attention {label}, causal=False == plain (bitwise) on zeros, -0.0, "
              f"subnormals, inf and NaN in {unwritten} unwritten keys: the plan ({plan}) and "
              f"{len(plans) - 1} forced tile x table forms")


def encdec_kernel_checks(dev, gen, lut_case, lookups_per_s) -> dict:
    """Phase 9a: each captured call (``encdec_capture``) again under every
    table of 3d against its plain version, bit for bit as int32; each
    shape's plan, grid and device time under afm16; the encoder attention
    under every tile; then ``bidirectional_attention_checks``.  Returns each
    kernel's largest |difference|."""
    from repro_torch.kernels import ops
    calls = encdec_capture(dev)
    plains = ssm_plains()
    kernels = {k: getattr(ops, k) for k in encdec_counters()}
    err = dict.fromkeys(kernels, 0.0)
    for i, (lut_name, packed) in enumerate(SERVE_LUTS):
        lut, M = lut_case(lut_name, packed)
        tag = f"{lut_name} {'packed' if packed else 'canonical'}"
        held = large = 0
        for (kname, shapes, _), (args, kw, where) in calls.items():
            if i and call_costs(kname, args, kw)[1] > ENCDEC_ALL_TABLES_MAX:
                large += 1
                continue
            slot = SSM_LUT_SLOT[kname]
            a = list(args)
            a[slot], a[slot + 1] = lut, M
            out, ref = kernels[kname](*a, **kw), plains[kname](*a, **kw)
            e = (out - ref).abs().max().item()
            require(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
                    f"9a {kname} {tag} at {shapes} {dict(kw)} ({where}): not bitwise its plain "
                    f"version, max|d| {e}")
            err[kname] = max(err[kname], e)
            held += 1
            if i == 0:
                t = queued_ms(lambda: kernels[kname](*a, **kw), reps=3)
                nbytes, lookups = call_costs(kname, a, kw)
                tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
                print(f"  {where}: {kname} {shapes} {dict(kw)}: {t:.4f} ms on device (bound "
                      f"{tb:.4f} ms, {bound_kind(nbytes, lookups, lookups_per_s)}; {lookups} "
                      f"lookups); {ssm_plan_text(kname, a, kw)}")
            del out, ref
        first = f", {large} held under the first table only" if large else ""
        print(f"encdec kernels == plain (bitwise): {tag}, {held} shapes of the whisper-base "
              f"path{first}")
        bidirectional_attention_checks(dev, gen, lut, M, tag)
    encdec_tile_times(calls, lut_case)
    del calls
    torch.cuda.empty_cache()
    return err


def encdec_serving_depth2(dev) -> None:
    """9b serving: depth 2, greedy decoding of 1 x 1500 frames, prompt 4, 8
    new tokens under amsim and amsim_torch (deterministic algorithms): the
    encoder states, every step's logits and the tokens bitwise; the amsim
    launches."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.models import encdec
    cfg = encdec_cfg(2)
    B, P, N = ENCDEC_DEPTH2["serve_batch"], ENCDEC_DEPTH2["prompt"], ENCDEC_DEPTH2["new"]
    model = encdec.init_encdec(cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
    frames, prompts = encdec_inputs(cfg, B, P, dev)
    counters = encdec_counters()
    want = encdec_serve_want(cfg, N)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("amsim", "amsim_torch"):
            t0 = time.perf_counter()
            zero_launches(counters)
            runs[mode] = encdec.greedy(model, frames, prompts, N,
                                       NumericsPolicy(mode=mode, multiplier="afm16"))
            torch.cuda.synchronize()
            runs[mode] += (launches_of(counters), time.perf_counter() - t0)
    finally:
        torch.use_deterministic_algorithms(False)
    (e_a, t_a, l_a, n_a, s_a), (e_p, t_p, l_p, n_p, s_p) = runs["amsim"], runs["amsim_torch"]
    require(n_a == want and set(n_p.values()) == {0},
            f"9b whisper-base serving launches: amsim {n_a}, amsim_torch {n_p}, want {want}")
    require(bool(torch.isfinite(e_a).all()) and bool(torch.isfinite(l_a).all()),
            "9b whisper-base: encoder states or logits not finite")
    require(_same([e_a], [e_p]), f"9b whisper-base: encoder states differ from amsim_torch by "
            f"{(e_a - e_p).abs().max().item()}")
    require(_same([l_a], [l_p]) and torch.equal(t_a, t_p),
            f"9b whisper-base: decoding differs from amsim_torch (logits max|d| "
            f"{(l_a - l_p).abs().max().item()}, tokens equal {torch.equal(t_a, t_p)})")
    print(f"{ENCDEC_ARCH} depth 2 + 2: greedy decoding of {B} x {cfg.n_frontend_tokens} frames, "
          f"prompt {P}, {N} new tokens: encoder states, every step's logits and the tokens "
          f"bitwise equal to amsim_torch; amsim launches {n_a}; {s_a:.1f} s amsim, {s_p:.1f} s "
          f"amsim_torch; tokens {t_a[0].tolist()}")
    del model, runs
    torch.cuda.empty_cache()


def encdec_train_depth2(dev) -> None:
    """9b training: an adamw step at 1 x 64 over 1500 frames, one encoder
    and one decoder layer (the encoder's backward still chunks its 1500
    queries), under amsim and amsim_torch with deterministic algorithms: the
    loss, the parameters and the gradient at the next batch bitwise; the
    amsim launches."""
    from repro_torch.core.policy import NumericsPolicy
    cfg = encdec_cfg(ENCDEC_DEPTH2["train_layers"])
    counters = encdec_counters()
    shape = dict(batch=ENCDEC_DEPTH2["train_batch"], seq=ENCDEC_DEPTH2["seq"],
                 steps=ENCDEC_DEPTH2["steps"])
    want = encdec_train_want(cfg, shape["seq"])
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("amsim", "amsim_torch"):
            runs[mode] = depth2_run(cfg, NumericsPolicy(mode=mode, multiplier="afm16"), dev,
                                    counters, shape)
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    (l_a, p_a, g_a, n_a, t_a), (l_p, p_p, g_p, n_p, t_p) = runs["amsim"], runs["amsim_torch"]
    steps = shape["steps"]
    require(n_a == [want] * steps and n_p == [dict.fromkeys(want, 0)] * steps,
            f"9b whisper-base training launches: amsim {n_a}, amsim_torch {n_p}, want {want}")
    require(all(bool(torch.isfinite(v)) for v in l_a), f"9b whisper-base losses {l_a}")
    require(_same(l_a, l_p), f"9b whisper-base training losses: amsim {l_a}, amsim_torch {l_p}")
    require(_same(p_a, p_p), f"9b whisper-base training: parameters after step {steps} differ")
    require(_same(g_a, g_p), f"9b whisper-base training: gradients after step {steps} differ")
    print(f"{ENCDEC_ARCH} depth {cfg.n_enc_layers} + {cfg.n_layers}: batch {shape['batch']} x "
          f"{shape['seq']} over "
          f"{cfg.n_frontend_tokens} frames, {steps} adamw steps (remat): losses "
          f"{[round(float(v), 6) for v in l_a]}, parameters after step {steps} and the gradient at "
          f"batch {steps} bitwise equal to amsim_torch ({len(p_a)} tensors); amsim launches a "
          f"step {want}; {t_a:.1f} s amsim, {t_p:.1f} s amsim_torch")
    del runs
    torch.cuda.empty_cache()


def timed_greedy(model, frames, prompts, new: int, policy):
    """``models.encdec.greedy``'s calls, timed: (tokens, encode ms, prompt
    decode ms, ms a decode step), host wall clock with the card synchronized
    around each part."""
    from repro_torch.models import encdec
    B, P = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = encdec.encode(model, frames, policy)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    caches = encdec.init_encdec_caches(model.cfg, B, P + new, frames.device)
    _, nxt, caches = encdec.serve_step(model, prompts, enc, caches, policy)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    toks = [nxt]
    for _ in range(new - 1):
        _, nxt, caches = encdec.serve_step(model, nxt, enc, caches, policy)
        toks.append(nxt)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return (torch.cat(toks, dim=1), (t1 - t0) * 1e3, (t2 - t1) * 1e3,
            (t3 - t2) * 1e3 / max(new - 1, 1))


def encdec_serving_full(dev, lookups_per_s, smi_line) -> dict:
    """9c serving: whisper-base at full width and depth, greedy decoding at
    batch 4 over 1500 frames, prompt 4, 32 new tokens under native and
    amsim: encode ms, prompt ms, ms a decode step, tokens/s, idle shares;
    the amsim run's launches (counters zeroed just before it); the GEMM and
    attention kernels' device time at the encode's and a decode step's
    shapes beside their bounds.  Returns the amsim run's launches."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    cfg = encdec_cfg()
    B, P, N = ENCDEC_FULL["batch"], ENCDEC_FULL["prompt"], ENCDEC_FULL["new"]
    t0 = time.perf_counter()
    model = encdec.init_encdec(cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
    torch.cuda.synchronize()
    weight_bytes = 4 * sum(p.numel() for p in model.parameters())
    print(f"{ENCDEC_ARCH} at full width and depth ({cfg.n_enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, {weight_bytes / 1e9:.2f} GB of float32 weights) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; batch {B}, {cfg.n_frontend_tokens} frames, prompt "
          f"{P}, {N} new tokens ({smi_line}):")
    frames, prompts = encdec_inputs(cfg, B, P, dev)
    counters = encdec_counters()
    want = encdec_serve_want(cfg, N)
    amsim = NumericsPolicy(mode="amsim", multiplier="afm16")
    res, got = {}, None
    for pname, policy in (("native", NumericsPolicy()), ("amsim", amsim)):
        timed_greedy(model, frames, prompts, 2, policy)          # warm-up
        zero_launches(counters)
        toks, enc_ms, pre_ms, step_ms = timed_greedy(model, frames, prompts, N, policy)
        if pname == "amsim":
            got = launches_of(counters)
            require(got == want, f"9c whisper-base serving: launches {got}, want {want}")
        require(toks.shape == (B, N) and bool((toks >= 0).all() & (toks < cfg.vocab).all()),
                f"9c whisper-base {pname}: tokens out of range")
        enc = encdec.encode(model, frames, policy)
        require(bool(torch.isfinite(enc).all()), f"9c whisper-base {pname}: encoder states")
        caches = encdec.init_encdec_caches(cfg, B, P + N, dev)
        logits, nxt, caches = encdec.serve_step(model, prompts, enc, caches, policy)
        require(bool(torch.isfinite(logits).all()), f"9c whisper-base {pname}: logits")
        busy_enc = busy_ms(lambda: encdec.encode(model, frames, policy), reps=1)
        busy_step = busy_ms(lambda: encdec.serve_step(model, nxt, enc, caches, policy), reps=3)
        total_s = (enc_ms + pre_ms + step_ms * (N - 1)) / 1e3
        res[pname] = (enc_ms, pre_ms, step_ms)
        print(f"  {pname}: encode {enc_ms:.2f} ms ({busy_text(busy_enc, enc_ms)}), prompt "
              f"{pre_ms:.2f} ms, {step_ms:.3f} ms per decode step "
              f"({busy_text(busy_step, step_ms)}), {B * N / total_s:.2f} tokens/s (encode "
              f"included); tokens {toks[0, :8].tolist()}")
    print(f"  amsim/native: encode {res['amsim'][0] / res['native'][0]:.2f}x, decode step "
          f"{res['amsim'][2] / res['native'][2]:.2f}x")
    print(f"launches on the {ENCDEC_ARCH} serving run (9c, amsim, encode, prompt and {N - 1} "
          f"decode steps): {got}")
    # The GEMM and attention kernels at this run's shapes: an encode and a decode step.
    originals = {k: getattr(ops, k) for k in ("approx_gemm", "approx_attention")}
    enc = encdec.encode(model, frames, amsim)
    caches = encdec.init_encdec_caches(cfg, B, P + N, dev)
    _, nxt, caches = encdec.serve_step(model, prompts, enc, caches, amsim)
    for ctx in ("encode", "decode step"):
        shapes = {}

        def wrapped(kname):
            def call(*a, **kw):
                key = (kname, tuple(tuple(t.shape) for t in a[:2]), tuple(sorted(kw.items())))
                shapes.setdefault(key, [a, kw, 0])[2] += 1
                return originals[kname](*a, **kw)
            return call

        for k in originals:
            setattr(ops, k, wrapped(k))
        try:
            if ctx == "encode":
                encdec.encode(model, frames, amsim)
            else:
                encdec.serve_step(model, nxt, enc, caches, amsim)
            torch.cuda.synchronize()
        finally:
            for k, f in originals.items():
                setattr(ops, k, f)
        sums = {}
        for (kname, sh, _), (a, kw, n) in sorted(shapes.items()):
            t = queued_ms(lambda: originals[kname](*a, **kw), reps=3)
            nbytes, lookups = call_costs(kname, a, kw)
            tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
            s = sums.setdefault(kname, [0.0, 0.0, 0])
            s[0], s[1], s[2] = s[0] + n * t, s[1] + n * tb, s[2] + n
            print(f"  {ctx}: {kname} {sh} {dict(kw)} x {n}: {t:.4f} ms each, bound {tb:.4f} ms "
                  f"({bound_kind(nbytes, lookups, lookups_per_s)}; {lookups} lookups); "
                  f"{ssm_plan_text(kname, a, kw)}")
        for kname, (t, tb, n) in sums.items():
            print(f"  {ctx}: {kname} {t:.2f} ms on device over {n} launches, bound {tb:.2f} ms")
    del model, enc, caches
    torch.cuda.empty_cache()
    return got


def encoder_decoder(dev, gen, lut_case, lookups_per_s, smi_line, phase_done) -> dict:
    """Phase 9: 9a-9c; 9c prints each full-depth run's launches on a line of
    its own.  Returns each kernel's largest |difference| in 9a."""
    err = encdec_kernel_checks(dev, gen, lut_case, lookups_per_s)
    phase_done("9a encdec kernels vs plain")
    encdec_serving_depth2(dev)
    encdec_train_depth2(dev)
    phase_done("9b encdec decoding and training, depth 2")
    encdec_serving_full(dev, lookups_per_s, smi_line)
    run = train_full(dev, ENCDEC_ARCH, lookups_per_s, smi_line, shape=ENCDEC_TRAIN,
                     capture=("approx_gemm_batched", "approx_attention"), capture_step=1)
    print(f"launches on the {ENCDEC_ARCH} training run (9c, {ENCDEC_TRAIN['steps']} steps at "
          f"{ENCDEC_TRAIN['batch']} x {ENCDEC_TRAIN['seq']} over 1500 frames): {run}")
    phase_done("9c encdec decoding and training, full depth")
    return err


# ------------------------------------------------- the rest of the dense registry
# Phase 10: llava-next-34b (2880 patch embeddings before the text:
# ``lm_forward(embeds=, caches=)``, ``lm_loss``'s crop), qwen2.5-32b and
# qwen1.5-110b (q/k/v biases added after the chain's q/k/v products;
# qwen1.5 trains with adafactor) and stablelm-12b (heads of 160), through
# the dense block's kernels at heads of 128 and 160 and at widths up to d
# 8192, d_ff 49152 and a vocab of 152064.
ZOO = {"llava": "llava-next-34b", "qwen2.5": "qwen2.5-32b", "qwen1.5": "qwen1.5-110b",
       "stablelm": "stablelm-12b"}
ZOO_LUTS = [("afm16", True), ("afm10", True)]   # one shared-memory and one global table
# 10a's attention shapes (label, B, S, H, KV, ring slots, keys written, dh):
# causal prefills and decode steps over rings with unwritten slots at the
# zoo's heads; llava's last 16 prefill positions (112 rows a group) over its
# ring of 2976 keep their scores (R x 2976 floats a tile) in the global
# scratch at tiles of 16 rows and more.
ZOO_ATTN_SHAPES = [("llava prefill 1x16 ring 48 (dh 128, G 7)", 1, 16, 56, 8, 48, 40, 128),
                   ("llava decode ring 160 (dh 128, G 7)", 1, 1, 56, 8, 160, 100, 128),
                   ("llava prefill positions 2928-2943 ring 2976 (dh 128)", 1, 16, 56, 8, 2976,
                    2944, 128),
                   ("llava decode ring 2976 (dh 128)", 1, 1, 56, 8, 2976, 2950, 128),
                   ("qwen2.5 decode ring 96 (dh 128, G 5)", 4, 1, 40, 8, 96, 70, 128),
                   ("stablelm prefill 4x16 ring 48 (dh 160, G 4)", 4, 16, 32, 8, 48, 40, 160),
                   ("stablelm decode ring 160 (dh 160, G 4)", 4, 1, 32, 8, 160, 100, 160)]
# 10a times the attention kernel (no plain version) at the path's own
# shapes, as ZOO_ATTN_SHAPES: llava's whole prefill and a step over its ring
# of 2976; the 4 x 64 prefills and the steps of the others.
ZOO_ATTN_TIMED = [("llava prefill 1x2944 ring 2976", 1, 2944, 56, 8, 2976, 2944, 128),
                  ("llava decode ring 2976", 1, 1, 56, 8, 2976, 2945, 128),
                  ("stablelm prefill 4x64 ring 96", 4, 64, 32, 8, 96, 64, 160),
                  ("stablelm decode ring 96", 4, 1, 32, 8, 96, 65, 160),
                  ("qwen2.5 prefill 4x64 ring 96", 4, 64, 40, 8, 96, 64, 128),
                  ("qwen1.5 prefill 4x64 ring 72", 4, 64, 64, 8, 72, 64, 128)]
# 10a's chain: (arch, rows, ring) of 10c's decode steps, held in the form
# the ring takes there (attention+out-mlp up to FUSE_ATTN_MAX_T slots, else
# attention apart and out-mlp).  The plain versions fold the back half's
# weights once a row at under 1 G lookups a second, so qwen1.5-110b (2.6 G
# lookups a row) is held at 1 of its 4 rows.
ZOO_CHAIN = (("stablelm", 4, 96), ("qwen2.5", 4, 96), ("llava", 1, 2976), ("qwen1.5", 1, 72))
# 10a's GEMMs: qwen1.5-110b's up and down projections (d_ff 49152) at a
# decode step's 4 rows (the column path) and 16 rows (the tiled path), and
# its head (vocab 152064) at 4 rows; each held on ``held_columns``.
ZOO_GEMMS = ((4, 8192, 49152), (4, 49152, 8192), (16, 8192, 49152), (4, 8192, 152064))
# 10b: depth 1 at full width, amsim against amsim_torch: (prompt, frontend
# patches) of a prefill, then ZOO_STEPS greedy steps; stablelm then one
# adamw step at 1 x 4.  The plain versions make a few G lookups a second,
# and the heads (0.5-0.8 G lookups a position at these vocabularies) take
# most of it: each position costs about a second.
ZOO_DEPTH1 = {"llava": (4, 8), "qwen2.5": (4, 0), "stablelm": (4, 0)}
ZOO_STEPS = 1
ZOO_TRAIN1 = dict(batch=1, seq=4, steps=1)
# 10c: (arch, depth, batch, prompt, new, policies served) and the training
# runs (arch, depth, batch, seq, steps).  llava's prompt is its 2880
# patches and 64 text tokens.
ZOO_SERVE = (("stablelm", None, 4, 64, 32, ("native", "amsim")),
             ("llava", 4, 1, 64, 32, ("amsim",)),
             ("qwen2.5", 8, 4, 64, 32, ("amsim",)),
             ("qwen1.5", 2, 4, 64, 8, ("amsim",)))
ZOO_TRAIN = (("stablelm", 2, 4, 64, 2), ("llava", 1, 1, 2944, 2), ("qwen1.5", 1, 4, 64, 2))


def zoo_counters():
    return {**serving_counters(), **{k: v for k, v in train_counters().items()
                                     if k != "fused_moe_ffn"}}


def zoo_cfg(key, n_layers=None, **changes):
    import dataclasses
    from repro_torch.configs.base import get_arch
    cfg = get_arch(ZOO[key])
    if n_layers is not None:
        changes["n_layers"] = n_layers
    return dataclasses.replace(cfg, **changes) if changes else cfg


def zoo_inputs(cfg, batch: int, prompt: int, patches: int, dev):
    """(text tokens (batch, prompt), patch embeddings (batch, patches, d) or
    None), drawn from SEED."""
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen).to(dev)
    embeds = (torch.randn((batch, patches, cfg.d_model), generator=gen).to(dev) if patches
              else None)
    return tokens, embeds


def zoo_greedy(model, tokens, embeds, steps: int, ring: int, policy, last_only=False):
    """A prefill (the patches first) into rings of ``ring`` slots through
    ``lm_forward(embeds=, caches=)``, then ``steps`` greedy decode steps of
    ``serve.engine.make_serve_step``: (tokens (B, steps + 1), the logits of
    the prefill (its last position's with ``last_only``) and of each step,
    prefill ms, ms a step); the times are the host's wall clock with the
    card synchronized around each part."""
    from repro_torch.models.transformer import init_lm_caches, lm_forward
    from repro_torch.serve.engine import make_serve_step
    caches = init_lm_caches(model.cfg, tokens.shape[0], ring, tokens.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches, _ = lm_forward(model, tokens, policy, embeds=embeds, caches=caches)
    nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step = make_serve_step(model, policy)
    toks, kept = [nxt], [logits[:, -1:] if last_only else logits]
    for _ in range(steps):
        lg, nxt, caches = step(nxt, caches)
        toks.append(nxt)
        kept.append(lg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (torch.cat(toks, 1), kept, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(steps, 1))


def zoo_kernel_checks(dev, gen, lut_case, lookups_per_s) -> dict:
    """Phase 10a: each kernel of the path at the zoo's new shapes against
    its plain version, bit for bit as int32, under ZOO_LUTS: the attention
    kernel at heads of 128 and 160 (``attention_plan_checks``: the plan,
    every tile x table form, special values); ``fused_qkv_norm`` and the
    back half in 10c's decode forms (ZOO_CHAIN: ``fused_attn_out_mlp`` over
    a ring of at most FUSE_ATTN_MAX_T slots, else ``fused_out_mlp``; both
    where the ring fits the first form, as earlier slices held them); the
    GEMM at qwen1.5's d_ff and vocab on ``held_columns``.  Operands are
    drawn once on the card and held under each table.  Each shape's plan
    and grid and its device time under afm16 beside its bound, and each
    block's seconds.  Returns each kernel's largest |difference|."""
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import approx_gemm as gemm_mod
    from repro_torch.kernels import decode_chain as chain
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import lut_bytes
    err = dict.fromkeys(("approx_attention", "fused_qkv_norm", "fused_out_mlp",
                         "fused_attn_out_mlp", "approx_gemm"), 0.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dgen = torch.Generator(device=dev).manual_seed(SEED)
    luts = [(f"{name} {'packed' if packed else 'canonical'}", *lut_case(name, packed))
            for name, packed in ZOO_LUTS]

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=dgen, device=dev) * scale

    def held(name, out, ref, what):
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        e = max((a - b).abs().max().item() for a, b in zip(outs, refs))
        require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(outs, refs)), f"10a {name} {what}: max|d|={e}")
        err[name] = max(err[name], e)

    def timed(name, fn, args, nbytes, lookups):
        t = queued_ms(lambda: fn(*args), reps=3)
        tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
        return (f"{name} {t:.4f} ms on device (bound {tb:.4f} ms, "
                f"{bound_kind(nbytes, lookups, lookups_per_s)}; {lookups} lookups)")

    t0 = time.perf_counter()
    for tag, lut, M in luts:
        attention_plan_checks(dev, gen, lut, M, tag, shapes=ZOO_ATTN_SHAPES)
    _, lut, M = luts[0]
    for label, B, S, H, KV, T, written, dh in ZOO_ATTN_TIMED:
        q, k, v = randn(B, S, H, dh), randn(B, T, KV, dh), randn(B, T, KV, dh)
        args = (q, k, v, torch.arange(written - S, written, dtype=torch.int32, device=dev),
                _ring_positions(T, written, dev), lut, M)
        plan = attn_mod.attention_plan(attn_mod.AttnShape(B, S, H, KV, T, dh), lut, sms)
        cost = serving_costs("approx_attention", args, {}, lut_bytes(lut))
        print(f"  {label} (dh {dh}): "
              f"{timed('approx_attention', attn_mod.approx_attention, args, *cost)} on valid "
              f"keys; {plan}")
        del q, k, v, args
    print(f"  10a attention: {time.perf_counter() - t0:.1f} s")
    for key, B, ring in ZOO_CHAIN:
        t0 = time.perf_counter()
        cfg = zoo_cfg(key)
        d, F, H, KV, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        eps = cfg.norm_eps
        w = dict(g1=1 + 0.1 * randn(d), g2=1 + 0.1 * randn(d),
                 wq=randn(d, H * dh, scale=d ** -0.5), wk=randn(d, KV * dh, scale=d ** -0.5),
                 wv=randn(d, KV * dh, scale=d ** -0.5),
                 wo=randn(H * dh, d, scale=(H * dh) ** -0.5), wg=randn(d, F, scale=d ** -0.5),
                 wu=randn(d, F, scale=d ** -0.5), wd=randn(F, d, scale=F ** -0.5))
        x, attn = randn(B, d), randn(B, H * dh, scale=0.3)
        back = [w[n] for n in ("g2", "wo", "wg", "wu", "wd")]
        qkv = (x, w["g1"], w["wq"], w["wk"], w["wv"])
        written, fused = ring - 26, ring <= ops.FUSE_ATTN_MAX_T
        sargs = ((randn(B, 1, H, dh), randn(B, ring, KV, dh), randn(B, ring, KV, dh),
                  torch.tensor([written - 1], dtype=torch.int32, device=dev),
                  _ring_positions(ring, written, dev)) if fused else ())
        for i, (tag, lut, M) in enumerate(luts):
            held("fused_qkv_norm", chain.fused_qkv_norm(*qkv, lut, M, eps=eps),
                 chain.fused_qkv_norm_plain(*qkv, lut, M, eps=eps), f"{tag} {key}")
            held("fused_out_mlp", chain.fused_out_mlp(x, attn, *back, lut, M, eps=eps),
                 chain.fused_out_mlp_plain(x, attn, *back, lut, M, eps=eps), f"{tag} {key}")
            text = "the attention apart (the ring exceeds the attention phase's)"
            if fused:
                held("fused_attn_out_mlp",
                     chain.fused_attn_out_mlp(x, *sargs, *back, lut, M, eps=eps),
                     chain.fused_attn_out_mlp_plain(x, *sargs, *back, lut, M, eps=eps,
                                                    causal=True, window=0), f"{tag} {key}")
                text = (f"attention phase, {written} written: "
                        f"{chain.attention_phase_plan(B, H, KV, ring, dh, lut)}")
            print(f"{tag}: {key} chain at {B} rows (d {d}, d_ff {F}, {H}/{KV} heads of {dh}) "
                  f"== plain (bitwise): qkv grid {chain.qkv_grid(B, H * dh, KV * dh, KV * dh, lut)}"
                  f"; back-half grid {chain.back_half_grid(B, d, F, lut, heads=H, kv_heads=KV)}; "
                  f"a ring of {ring}, {text}")
            for name, fn, args in (() if i else (
                    ("fused_qkv_norm", chain.fused_qkv_norm, (*qkv, lut, M)),
                    ("fused_out_mlp", chain.fused_out_mlp, (x, attn, *back, lut, M)),
                    *((("fused_attn_out_mlp", chain.fused_attn_out_mlp,
                        (x, *sargs, *back, lut, M)),) if fused else ()))):
                cost = serving_costs(name, args, {}, lut_bytes(lut))
                print(f"  {key} {B} rows: "
                      f"{timed(name, lambda *a, fn=fn: fn(*a, eps=eps), args, *cost)}")
        print(f"  10a {key} chain: {time.perf_counter() - t0:.1f} s")
        del w, back, qkv, sargs
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for m, k, n in ZOO_GEMMS:
        a, b = randn(m, k), randn(k, n, scale=k ** -0.5)
        for i, (tag, lut, M) in enumerate(luts):
            same, what = held_against_plain("approx_gemm", gemm_mod.approx_gemm,
                                            gemm_mod.approx_gemm_plain, (a, b, lut, M), {},
                                            min_lookups=0)
            require(same, f"10a approx_gemm {tag} {(m, k, n)}: not bitwise its plain version "
                    f"({what})")
            note = (f"{tag}: approx_gemm {(m, k, n)} == plain (bitwise, {what}); "
                    f"{gemm_plan_text(a, b, lut)}")
            if i == 0:
                note += "; " + timed("approx_gemm", gemm_mod.approx_gemm, (a, b, lut, M),
                                     *gemm_costs(a, b, lut))
            print(note)
        del a, b
    torch.cuda.empty_cache()
    print(f"  10a GEMMs: {time.perf_counter() - t0:.1f} s")
    print(f"10a: {sms} SMs; every zoo shape bitwise its plain version under "
          f"{[t for t, _, _ in luts]}")
    return err


def zoo_depth1(dev) -> None:
    """Phase 10b: depth 1 at full width, amsim against amsim_torch with
    deterministic algorithms: a prefill (llava: 8 patches, the frontend cut
    from 2880, then 4 text tokens; the qwen2.5 and stablelm prompts of 4)
    into rings through ``lm_forward(embeds=, caches=)``, then ZOO_STEPS
    greedy steps through the decode chain (qwen2.5's biases added after its
    q/k/v products): the prefill's and every step's logits and the tokens
    bitwise, the amsim launches; then one adamw step of stablelm at 1 x 4
    and the gradient after it: the loss, the parameters and the gradient
    bitwise, the launches."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.models.transformer import init_lm
    counters = zoo_counters()
    for key, (prompt, patches) in ZOO_DEPTH1.items():
        cfg = zoo_cfg(key, 1, **({"n_frontend_tokens": patches} if patches else {}))
        ring = patches + prompt + ZOO_STEPS
        model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        tokens, embeds = zoo_inputs(cfg, 1, prompt, patches, dev)
        want = {**serve_want(cfg, ZOO_STEPS, ring), "approx_gemm_batched": 0}
        runs = {}
        torch.use_deterministic_algorithms(True)
        try:
            for mode in ("amsim", "amsim_torch"):
                t0 = time.perf_counter()
                zero_launches(counters)
                toks, kept, _, _ = zoo_greedy(model, tokens, embeds, ZOO_STEPS, ring,
                                              NumericsPolicy(mode=mode, multiplier="afm16"))
                runs[mode] = (toks, kept, launches_of(counters), time.perf_counter() - t0)
        finally:
            torch.use_deterministic_algorithms(False)
        (t_a, l_a, n_a, s_a), (t_p, l_p, n_p, s_p) = runs["amsim"], runs["amsim_torch"]
        require(n_a == want and set(n_p.values()) == {0},
                f"10b {cfg.name} depth 1 serving launches: amsim {n_a}, amsim_torch {n_p}, "
                f"want {want}")
        require(l_a[0].shape == (1, patches + prompt, cfg.vocab)
                and all(bool(torch.isfinite(lg).all()) for lg in l_a),
                f"10b {cfg.name}: prefill logits {tuple(l_a[0].shape)} or not finite")
        require(_same(l_a, l_p) and torch.equal(t_a, t_p),
                f"10b {cfg.name}: amsim differs from amsim_torch (logits max|d| "
                f"{max((a - b).abs().max().item() for a, b in zip(l_a, l_p))}, tokens equal "
                f"{torch.equal(t_a, t_p)})")
        print(f"{cfg.name} depth 1 at full width: prefill of {patches} patches + {prompt} tokens "
              f"(logits {tuple(l_a[0].shape)}), {ZOO_STEPS} greedy steps over a ring of {ring}: "
              f"logits and tokens bitwise equal to amsim_torch; amsim launches {n_a}; "
              f"{s_a:.1f} s amsim, {s_p:.1f} s amsim_torch; tokens {t_a[0].tolist()}")
        del model, runs
        torch.cuda.empty_cache()
    cfg = zoo_cfg("stablelm", 1)
    tc = train_counters()
    want = train_want(cfg, ZOO_TRAIN1["seq"])
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("amsim", "amsim_torch"):
            runs[mode] = depth2_run(cfg, NumericsPolicy(mode=mode, multiplier="afm16"), dev, tc,
                                    ZOO_TRAIN1)
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    (l_a, p_a, g_a, n_a, t_a), (l_p, p_p, g_p, n_p, t_p) = runs["amsim"], runs["amsim_torch"]
    steps = ZOO_TRAIN1["steps"]
    require(n_a == [want] * steps and n_p == [dict.fromkeys(want, 0)] * steps,
            f"10b {cfg.name} training launches: amsim {n_a}, amsim_torch {n_p}, want {want}")
    require(all(bool(torch.isfinite(v)) for v in l_a), f"10b {cfg.name} losses {l_a}")
    require(_same(l_a, l_p) and _same(p_a, p_p) and _same(g_a, g_p),
            f"10b {cfg.name} training: amsim and amsim_torch differ (losses {l_a}, {l_p})")
    print(f"{cfg.name} depth 1 at full width (heads of {cfg.head_dim}): batch "
          f"{ZOO_TRAIN1['batch']} x {ZOO_TRAIN1['seq']}, {steps} adamw step: loss "
          f"{[round(float(v), 6) for v in l_a]}, parameters and the next gradient bitwise equal "
          f"to amsim_torch ({len(p_a)} tensors); amsim launches {want}; {t_a:.1f} s amsim, "
          f"{t_p:.1f} s amsim_torch")
    del runs
    torch.cuda.empty_cache()


def zoo_serve_full(dev, key, depth, batch, prompt, new, modes, smi_line) -> dict:
    """Phase 10c serving: one zoo model at full width (and ``depth``, or
    full depth), weights drawn on the card: for each mode a warm-up, then a
    timed prefill (llava's of its 2880 patches and ``prompt`` text tokens)
    and ``new`` - 1 greedy steps, with the launches (amsim: counters zeroed
    just before the run, held to ``serve_want``), the device busy time
    of the prefill and of a step, the peak memory, tokens/s.  Returns the
    amsim run's launches."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.models.transformer import init_lm, init_lm_caches, lm_forward
    from repro_torch.serve.engine import make_serve_step
    cfg = zoo_cfg(key, depth)
    patches = cfg.n_frontend_tokens
    ring = patches + prompt + new
    gc.collect()                 # the previous run's model, if a cycle holds it
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    weight_bytes = 4 * sum(p.numel() for p in model.parameters())
    full = zoo_cfg(key).n_layers
    depth_note = "full depth" if cfg.n_layers == full else f"depth {cfg.n_layers} of {full}"
    print(f"{cfg.name} at full width, {depth_note} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}{', q/k/v biases' if cfg.qkv_bias else ''}; "
          f"{weight_bytes / 1e9:.2f} GB of float32 weights) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; batch {batch}, "
          + (f"{patches} patches + " if patches else "")
          + f"prompt {prompt}, {new} new tokens, ring {ring} ({smi_line}):")
    tokens, embeds = zoo_inputs(cfg, batch, prompt, patches, dev)
    counters = zoo_counters()
    got = None
    for mode in modes:
        policy = (NumericsPolicy() if mode == "native"
                  else NumericsPolicy(mode=mode, multiplier="afm16"))
        warm_tokens, warm_embeds = zoo_inputs(cfg, batch, 8, min(patches, 16), dev)
        zoo_greedy(model, warm_tokens, warm_embeds, 1, 8 + min(patches, 16) + 1, policy)
        zero_launches(counters)
        toks, kept, pre_ms, step_ms = zoo_greedy(model, tokens, embeds, new - 1, ring, policy,
                                                 last_only=True)
        if mode == "amsim":
            got = launches_of(counters)
            want = {**serve_want(cfg, new - 1, ring), "approx_gemm_batched": 0}
            require(got == want, f"10c {cfg.name} serving: launches {got}, want {want}")
        require(toks.shape == (batch, new) and bool((toks >= 0).all() & (toks < cfg.vocab).all())
                and all(bool(torch.isfinite(lg).all()) for lg in kept),
                f"10c {cfg.name} {mode}: tokens out of range or logits not finite")
        caches = init_lm_caches(cfg, batch, ring, dev)
        (_, caches, _), busy_pre = profiled(lambda: lm_forward(model, tokens, policy,
                                                               embeds=embeds, caches=caches))
        nxt = toks[:, -1:]
        step = make_serve_step(model, policy)
        busy_step = busy_ms(lambda: step(nxt, caches), reps=3)
        total_s = (pre_ms + step_ms * (new - 1)) / 1e3
        print(f"  {mode}: prefill {pre_ms:.2f} ms (" + (
            f"device busy {busy_pre:.2f} ms in a profiled rerun" if busy_pre is not None
            else "device busy not measured") + f"), {step_ms:.3f} ms per decode step "
              f"({busy_text(busy_step, step_ms)}), {batch * new / total_s:.2f} tokens/s; peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; tokens "
              f"{toks[0, :8].tolist()}")
        del caches, step
    print(f"launches on the {cfg.name} serving run (10c, amsim, prefill and {new - 1} decode "
          f"steps): {got}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return got


def dense_zoo(dev, gen, lut_case, lookups_per_s, smi_line, phase_done) -> tuple:
    """Phase 10: 10a-10c; 10c prints each run's launches on a line of its
    own.  Returns (each kernel's largest |difference| in 10a, the launches
    of 10c's amsim runs summed, to show that each kernel ran there)."""
    err = zoo_kernel_checks(dev, gen, lut_case, lookups_per_s)
    phase_done("10a zoo kernels vs plain")
    zoo_depth1(dev)
    phase_done("10b zoo amsim vs amsim_torch, depth 1")
    launches = {}
    for key, depth, batch, prompt, new, modes in ZOO_SERVE:
        for k, n in zoo_serve_full(dev, key, depth, batch, prompt, new, modes,
                                   smi_line).items():
            launches[k] = launches.get(k, 0) + n
    for key, depth, batch, seq, steps in ZOO_TRAIN:
        run = train_full(dev, ZOO[key], lookups_per_s, smi_line,
                         shape=dict(batch=batch, seq=seq, steps=steps), n_layers=depth)
        print(f"launches on the {ZOO[key]} training run (10c, {steps} steps at {batch} x {seq}, "
              f"depth {depth}): {run}")
        for k, n in run.items():
            launches[k] = launches.get(k, 0) + n
    phase_done("10c zoo serving and training, full width")
    return err, launches


# ------------------------------------------------------------------ llama4
# Phase 11: llama4-maverick-400b-a17b (``configs/llama4_maverick_400b_a17b.py``):
# (dense, MoE) pairs, 128 routed experts (top-1) beside an always-on shared
# expert, d 5120, 40/8 heads of 128, d_ff 8192, vocab 202048.  One pair with
# every expert holds 18.55 G float32 parameters (74.2 GB): it is drawn once
# on the card and served at depth 2.  Training holds parameters, gradients
# and updates, so it cuts the experts to 16 (Llama-4-Scout's count).
LLAMA4_ARCH = "llama4-maverick-400b-a17b"
LLAMA4_DEPTH = 2
LLAMA4_TRAIN_EXPERTS = 16
LLAMA4_SERVE = dict(batch=4, prompt=64, new=32)    # 11c; 11a captures its prefill and a step
LLAMA4_LONG_RING = 160      # 11a: a step over more than FUSE_ATTN_MAX_T slots (3 launches)
LLAMA4_BITWISE = dict(batch=1, prompt=4, steps=2)  # 11b serving
LLAMA4_TRAIN1 = dict(batch=1, seq=4, steps=1)      # 11b training
LLAMA4_TRAIN = dict(batch=4, seq=64, steps=2)      # 11c training; its first step held
# 11a and 11c's training hold a GEMM of more than HELD_COLUMNS_MIN lookups
# (the head at 256 rows, the 256-row FFN projections, the banks' backward)
# on every 71st column (odd, so every lane and register column; every 13th
# would be 20 G plain lookups for a head).  11a holds the expert banks whole
# under afm16 (their plain version computes the live experts alone, as the
# kernel does: a 4 x 64 prefill's ~85 of 128, ~20 s), and under afm10 the
# prefill's buffer on the first live row of each live expert
# (``held_against_plain``).
LLAMA4_HEAD_STRIDE = 71
# Where each kernel wrapper of the path takes its table (M follows it).
LLAMA4_LUT_SLOT = {"approx_gemm": 2, **LUT_ARG, "fused_wo_norm": 4, "fused_moe_ffn": 4}


def llama4_cfg(n_experts=None):
    from repro_torch.configs.base import cut, get_arch
    return cut(get_arch(LLAMA4_ARCH), n_layers=LLAMA4_DEPTH, n_experts=n_experts)


def llama4_counters():
    return {**serving_counters(), **moe_counters()}


def llama4_serve_want(cfg, steps: int, ring: int) -> dict:
    """Launches of a prefill and ``steps`` decode steps of (dense, MoE)
    pairs under amsim: at the prefill, a pair's 7 dense GEMMs, 5 of its MoE
    layer (q/k/v/o, router) and 3 of its shared expert, two attentions and
    the expert banks (a capacity of at most MOE_FFN_MAX_C), and the head; a
    decode step's dense layer qkv and attention+out-mlp (a ring of at most
    FUSE_ATTN_MAX_T slots) or qkv, attention and out-mlp, its MoE layer
    qkv, attention, wo+norm, the router's and the shared expert's 4 GEMMs
    and the banks, and the head."""
    from repro_torch.kernels import ops
    P, two = cfg.n_layers // 2, ring <= ops.FUSE_ATTN_MAX_T
    return {"approx_attention": 2 * P + (1 if two else 2) * P * steps,
            "fused_qkv_norm": 2 * P * steps, "fused_out_mlp": 0 if two else P * steps,
            "fused_attn_out_mlp": P * steps if two else 0,
            "approx_gemm": 15 * P + 1 + (4 * P + 1) * steps, "approx_gemm_batched": 0,
            "fused_wo_norm": P * steps, "fused_moe_ffn": P * (1 + steps)}


def llama4_capture(model, dev) -> dict:
    """11a's calls under amsim/afm16 at the path's shapes: a prefill of 4 x
    64 into a ring of 96 (its 256-row projections, router and shared
    expert, the attention, the expert banks and the head), a decode step of
    its 4 rows (every kernel: the dense layer's qkv and attention+out-mlp,
    the MoE layer's attention, wo+norm, router, shared expert and banks,
    the head), and a step over a ring of LLAMA4_LONG_RING (the attention
    and the dense layer's out-mlp apart).
    {(kernel, shapes, part): [calls, args, kw]}, a distinct shape a part;
    the tensors that are not the model's parameters cloned."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm_caches
    from repro_torch.serve.engine import ServingEngine
    cfg = model.cfg
    params = {p.data_ptr() for p in model.parameters()}
    originals = {k: getattr(ops, k) for k in LLAMA4_LUT_SLOT}
    calls, part = {}, ["", ()]

    def capture(kname):
        def wrapped(*a, **kw):
            label, keep = part
            if kname in keep:
                key = (kname, tuple(tuple(t.shape) for t in a if torch.is_tensor(t)), label)
                if key not in calls:
                    calls[key] = [0, tuple(t.clone() if torch.is_tensor(t)
                                           and t.data_ptr() not in params else t for t in a),
                                  dict(kw)]
                calls[key][0] += 1
            return originals[kname](*a, **kw)
        return wrapped

    B, P = LLAMA4_SERVE["batch"], LLAMA4_SERVE["prompt"]
    ring = P + LLAMA4_SERVE["new"]
    prompts = torch.randint(0, cfg.vocab, (B, P),
                            generator=torch.Generator().manual_seed(SEED)).to(dev)
    runs = ((ring, (f"prefill {B}x{P}", ("approx_gemm", "approx_attention", "fused_moe_ffn")),
             (f"decode step, ring {ring}", tuple(originals))),
            (LLAMA4_LONG_RING, ("", ()),
             (f"decode step, ring {LLAMA4_LONG_RING}", ("approx_attention", "fused_out_mlp"))))
    for k in originals:
        setattr(ops, k, capture(k))
    try:
        for T, prefill, step in runs:
            engine = ServingEngine(model, NumericsPolicy(mode="amsim", multiplier="afm16"),
                                   max_len=T)
            part[:] = prefill
            _, nxt, caches = engine.prefill(prompts, init_lm_caches(cfg, B, T, dev))
            part[:] = step
            engine.step(nxt, caches)
            torch.cuda.synchronize()
    finally:
        for k, f in originals.items():
            setattr(ops, k, f)
    return calls


def llama4_plan_text(kname, args, kw) -> str:
    from repro_torch.kernels import decode_chain as chain
    if kname == "fused_wo_norm":
        return f"grid {chain.wo_norm_grid(args[0].shape[0], args[0].shape[1], args[4])}"
    if kname == "fused_moe_ffn":
        h, wg = args[:2]
        live = chain.live_rows(h)
        grid = chain.moe_ffn_grid(*h.shape, wg.shape[2], args[4], live=live.tolist())
        return (f"{int(live.sum())} live rows in {int((live > 0).sum())} of {h.shape[0]} "
                f"experts; grid {grid}")
    return ssm_plan_text(kname, args, kw)


def llama4_kernel_checks(model, dev, lut_case, lookups_per_s) -> tuple[dict, dict]:
    """Phase 11a: each captured call (``llama4_capture``) again under
    ZOO_LUTS against its plain version, bit for bit as int32 (+0.0 and -0.0
    apart), a GEMM of more than HELD_COLUMNS_MIN lookups on
    ``held_columns`` (every LLAMA4_HEAD_STRIDE-th column), the prefill's
    expert banks under afm10 on the first live row of each live expert;
    each call's device time under afm16 beside its bound, with its plan and
    grid.
    Returns (each kernel's largest |difference|, {(kernel, part, shapes):
    (device ms, bound ms, calls)})."""
    from repro_torch.kernels import decode_chain as chain
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    calls = llama4_capture(model, dev)
    print(f"  11a: {len(calls)} calls captured in {time.perf_counter() - t0:.1f} s")
    plains = {**ssm_plains(), "fused_wo_norm": chain.fused_wo_norm_plain,
              "fused_moe_ffn": chain.fused_moe_ffn_plain}
    kernels = {k: getattr(ops, k) for k in LLAMA4_LUT_SLOT}
    err = dict.fromkeys(LLAMA4_LUT_SLOT, 0.0)
    times = {}
    for i, (lut_name, packed) in enumerate(ZOO_LUTS):
        lut, M = lut_case(lut_name, packed)
        tag = f"{lut_name} {'packed' if packed else 'canonical'}"
        t_table = time.perf_counter()
        for (kname, shapes, part), (n, args, kw) in calls.items():
            slot = LLAMA4_LUT_SLOT[kname]
            a = list(args)
            a[slot], a[slot + 1] = lut, M
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if kname in ("approx_gemm", "fused_moe_ffn"):
                whole = kname == "fused_moe_ffn" and i == 0
                same, what = held_against_plain(
                    kname, kernels[kname], plains[kname], a, kw,
                    min_lookups=math.inf if whole else HELD_COLUMNS_MIN, stride=LLAMA4_HEAD_STRIDE)
                require(same, f"11a {kname} {tag} at {shapes} ({part}): not bitwise its plain "
                        f"version ({what})")
                e = 0.0
            else:
                what = "every output"
                plain_kw = dict(kw)
                if kname in ("approx_attention", "fused_attn_out_mlp"):
                    plain_kw.setdefault("causal", True)
                    plain_kw.setdefault("window", 0)
                out, ref = kernels[kname](*a, **kw), plains[kname](*a, **plain_kw)
                outs = out if isinstance(out, tuple) else (out,)
                refs = ref if isinstance(ref, tuple) else (ref,)
                e = max((x - y).abs().max().item() for x, y in zip(outs, refs))
                require(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                            for x, y in zip(outs, refs)),
                        f"11a {kname} {tag} at {shapes} ({part}): not bitwise its plain "
                        f"version, max|d| {e}")
                del out, ref, outs, refs
            torch.cuda.synchronize()
            note = (f"{tag}: {part}: {kname} {shapes[:-1]} x {n}: bitwise its plain version on "
                    f"{what} ({time.perf_counter() - t1:.1f} s with the check)")
            err[kname] = max(err[kname], e)
            if i == 0:
                t = queued_ms(lambda: kernels[kname](*a, **kw), reps=3)
                nbytes, lookups = call_costs(kname, a, kw)
                tb = max(nbytes / HBM_BYTES_PER_S, lookups / lookups_per_s) * 1e3
                times[(kname, part, shapes)] = (t, tb, n)
                note += (f"; {t:.4f} ms on device (bound {tb:.4f} ms, "
                         f"{bound_kind(nbytes, lookups, lookups_per_s)}; {lookups} lookups); "
                         f"{llama4_plan_text(kname, a, kw)}")
            print(note)
        print(f"11a: {tag}: every llama4 shape bitwise its plain version "
              f"({time.perf_counter() - t_table:.1f} s)")
    del calls
    torch.cuda.empty_cache()
    return err, times


def llama4_serving_bitwise(model, dev) -> None:
    """Phase 11b serving: depth 2 at full width with all 128 experts, a
    prompt of LLAMA4_BITWISE, then greedy steps through the decode chain
    under amsim and amsim_torch with deterministic algorithms: the
    prefill's and every step's logits and the tokens bitwise, the amsim
    launches."""
    from repro_torch.core.policy import NumericsPolicy
    cfg = model.cfg
    B, P, steps = (LLAMA4_BITWISE[k] for k in ("batch", "prompt", "steps"))
    ring = P + steps
    tokens = torch.randint(0, cfg.vocab, (B, P),
                           generator=torch.Generator().manual_seed(SEED)).to(dev)
    counters = llama4_counters()
    want = llama4_serve_want(cfg, steps, ring)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("amsim", "amsim_torch"):
            t0 = time.perf_counter()
            zero_launches(counters)
            toks, kept, _, _ = zoo_greedy(model, tokens, None, steps, ring,
                                          NumericsPolicy(mode=mode, multiplier="afm16"))
            runs[mode] = (toks, kept, launches_of(counters), time.perf_counter() - t0)
    finally:
        torch.use_deterministic_algorithms(False)
    (t_a, l_a, n_a, s_a), (t_p, l_p, n_p, s_p) = runs["amsim"], runs["amsim_torch"]
    require(n_a == want and set(n_p.values()) == {0},
            f"11b {cfg.name} serving launches: amsim {n_a}, amsim_torch {n_p}, want {want}")
    require(l_a[0].shape == (B, P, cfg.vocab) and all(bool(torch.isfinite(lg).all())
                                                      for lg in l_a),
            f"11b {cfg.name}: prefill logits {tuple(l_a[0].shape)} or not finite")
    require(_same(l_a, l_p) and torch.equal(t_a, t_p),
            f"11b {cfg.name}: amsim differs from amsim_torch (logits max|d| "
            f"{max((a - b).abs().max().item() for a, b in zip(l_a, l_p))}, tokens equal "
            f"{torch.equal(t_a, t_p)})")
    print(f"{cfg.name} depth {cfg.n_layers} at full width, {cfg.moe.n_experts} experts: a prompt "
          f"of {B} x {P}, {steps} greedy steps over a ring of {ring}: the prefill's and every "
          f"step's logits and the tokens bitwise equal to amsim_torch; amsim launches "
          f"{ {k: v for k, v in n_a.items() if v} }; {s_a:.1f} s amsim, {s_p:.1f} s amsim_torch; "
          f"tokens {t_a[0].tolist()}")


def llama4_serve_full(model, dev, smi_line, times) -> dict:
    """Phase 11c serving: depth 2 at full width with all 128 experts, batch
    4, prompt 64, 32 new tokens under native and amsim: for each a warm-up,
    then a timed prefill and 31 greedy steps, the amsim launches (counters
    zeroed just before the run, held to ``llama4_serve_want``), the device
    busy time of the prefill (a profiled rerun) and of a step, tokens/s and
    the peak memory; then 11a's device times of the prefill's and of a
    decode step's kernels beside their bounds.  Returns the amsim run's
    launches."""
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.models.transformer import init_lm_caches, lm_forward
    from repro_torch.serve.engine import make_serve_step
    cfg = model.cfg
    B, P, new = (LLAMA4_SERVE[k] for k in ("batch", "prompt", "new"))
    ring = P + new
    tokens = torch.randint(0, cfg.vocab, (B, P),
                           generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    counters = llama4_counters()
    torch.cuda.reset_peak_memory_stats()
    print(f"{cfg.name} at full width, depth {cfg.n_layers} (one (dense, MoE) pair, "
          f"{cfg.moe.n_experts} experts, top-{cfg.moe.top_k}, a shared expert): batch {B}, prompt "
          f"{P}, {new} new tokens, ring {ring} ({smi_line}):")
    got = None
    for mode in ("native", "amsim"):
        policy = (NumericsPolicy() if mode == "native"
                  else NumericsPolicy(mode=mode, multiplier="afm16"))
        zoo_greedy(model, tokens[:, :8], None, 1, 9, policy)
        zero_launches(counters)
        toks, kept, pre_ms, step_ms = zoo_greedy(model, tokens, None, new - 1, ring, policy,
                                                 last_only=True)
        if mode == "amsim":
            got = launches_of(counters)
            want = llama4_serve_want(cfg, new - 1, ring)
            require(got == want, f"11c {cfg.name} serving: launches {got}, want {want}")
        require(toks.shape == (B, new) and bool((toks >= 0).all() & (toks < cfg.vocab).all())
                and all(bool(torch.isfinite(lg).all()) for lg in kept),
                f"11c {cfg.name} {mode}: tokens out of range or logits not finite")
        caches = init_lm_caches(cfg, B, ring, dev)
        (_, caches, _), busy_pre = profiled(lambda: lm_forward(model, tokens, policy,
                                                               caches=caches))
        nxt = toks[:, -1:]
        step = make_serve_step(model, policy)
        busy_step = busy_ms(lambda: step(nxt, caches), reps=3)
        total_s = (pre_ms + step_ms * (new - 1)) / 1e3
        print(f"  {mode}: prefill {pre_ms:.2f} ms (" + (
            f"device busy {busy_pre:.2f} ms in a profiled rerun" if busy_pre is not None
            else "device busy not measured") + f"), {step_ms:.3f} ms per decode step "
              f"({busy_text(busy_step, step_ms)}), {B * new / total_s:.2f} tokens/s; peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; tokens "
              f"{toks[0, :8].tolist()}")
        del caches, step
    print(f"launches on the {cfg.name} serving run (11c, amsim, prefill and {new - 1} decode "
          f"steps): {got}")
    for part in (f"prefill {B}x{P}", f"decode step, ring {ring}"):
        rows = [(k, t, tb, n) for (k, p, _), (t, tb, n) in sorted(times.items()) if p == part]
        print(f"  11a's kernels of the {part} (device ms x calls, bound): "
              + "; ".join(f"{k} {t:.4f} x {n} ({tb:.4f})" for k, t, tb, n in rows)
              + f"; in all {sum(t * n for _, t, _, n in rows):.3f} ms against "
              f"{sum(tb * n for _, _, tb, n in rows):.3f}")
    return got


FINGERPRINT_CHUNK = 1 << 24


def fingerprint(t: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """A tensor's bits as one int64 a chunk of 2^24 elements: the sum of
    each int32 bit pattern times a fixed random odd int64 weight (wrapping
    mod 2^64).  Two different bit patterns give the same value of a chunk
    with probability ~2^-63, so equal fingerprints are the bitwise check of
    tensors too large to hold twice."""
    v = t.detach().reshape(-1).view(torch.int32)
    out = []
    for i in range(0, v.numel(), FINGERPRINT_CHUNK):
        c = v[i:i + FINGERPRINT_CHUNK].to(torch.int64)
        out.append(torch.sum(c * weights[:c.numel()]))
    return torch.stack(out)


def llama4_train_bitwise(dev) -> None:
    """Phase 11b training: one adafactor step at full width, depth 2, the
    experts cut to LLAMA4_TRAIN_EXPERTS, at LLAMA4_TRAIN1, under amsim and
    amsim_torch with deterministic algorithms: the loss bitwise, the
    parameters and the gradient at the next batch by their ``fingerprint``s
    (both runs' tensors do not fit the card together), the amsim
    launches."""
    from repro_torch.core.policy import NumericsPolicy
    cfg = llama4_cfg(LLAMA4_TRAIN_EXPERTS)
    counters = train_counters()
    want = train_want(cfg, LLAMA4_TRAIN1["seq"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    weights = torch.randint(-2 ** 62, 2 ** 62, (FINGERPRINT_CHUNK,), generator=gen, device=dev,
                            dtype=torch.int64) * 2 + 1
    torch.use_deterministic_algorithms(True)
    try:
        l_a, p_a, g_a, n_a, t_a = depth2_run(cfg, NumericsPolicy(mode="amsim", multiplier="afm16"),
                                             dev, counters, LLAMA4_TRAIN1)
        t0 = time.perf_counter()
        nbytes = 4 * sum(p.numel() for p in p_a)
        n_tensors = len(p_a)
        f_a = [[fingerprint(t, weights) for t in ts] for ts in (p_a, g_a)]
        printed = time.perf_counter() - t0
        del p_a, g_a
        gc.collect()
        torch.cuda.empty_cache()
        l_p, p_p, g_p, n_p, t_p = depth2_run(cfg, NumericsPolicy(mode="amsim_torch",
                                                                 multiplier="afm16"),
                                             dev, counters, LLAMA4_TRAIN1)
    finally:
        torch.use_deterministic_algorithms(False)
    steps = LLAMA4_TRAIN1["steps"]
    require(n_a == [want] * steps and n_p == [dict.fromkeys(want, 0)] * steps,
            f"11b {cfg.name} training launches: amsim {n_a}, amsim_torch {n_p}, want {want}")
    require(all(bool(torch.isfinite(v)) for v in l_a), f"11b {cfg.name} losses {l_a}")
    require(all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(l_a, l_p)),
            f"11b {cfg.name} training: amsim and amsim_torch losses differ")
    t0 = time.perf_counter()
    for what, fs, ys in (("parameters", f_a[0], p_p), ("gradients", f_a[1], g_p)):
        require(all(torch.equal(f, fingerprint(y, weights)) for f, y in zip(fs, ys)),
                f"11b {cfg.name} training: amsim and amsim_torch {what} differ")
    printed += time.perf_counter() - t0
    print(f"{cfg.name} depth {cfg.n_layers} at full width, {cfg.moe.n_experts} experts "
          f"({nbytes / 1e9:.2f} GB of parameters): batch {LLAMA4_TRAIN1['batch']} x "
          f"{LLAMA4_TRAIN1['seq']}, {steps} {cfg.optimizer} step: loss "
          f"{[round(float(v), 6) for v in l_a]} bitwise, the parameters and the next gradient "
          f"equal to amsim_torch's by fingerprint ({n_tensors} tensors each, an int64 a 2^24 "
          f"elements); amsim launches { {k: v for k, v in want.items() if v} }; {t_a:.1f} s "
          f"amsim, {t_p:.1f} s amsim_torch, {printed:.1f} s fingerprinting")
    del p_p, g_p
    gc.collect()
    torch.cuda.empty_cache()


def llama4(dev, lut_case, lookups_per_s, smi_line, phase_done) -> tuple:
    """Phase 11: the model drawn once (everything before it freed), 11a, 11b
    and 11c's serving on it, then, with it freed, 11b's and 11c's training
    at 16 experts; 11c prints each run's launches on a line of its own.
    Returns (each kernel's largest |difference| in 11a, the launches of
    11c's amsim runs summed)."""
    from repro_torch.models.transformer import init_lm, lm_param_shapes
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama4_cfg()
    free, total = torch.cuda.mem_get_info()
    need = 4 * sum(math.prod(s) for s in lm_param_shapes(cfg).values())
    print(f"phase 11: {free / 1e9:.2f} GB of {total / 1e9:.2f} GB free before {cfg.name} at "
          f"depth {cfg.n_layers} ({need / 1e9:.2f} GB of float32 parameters) is drawn")
    require(need < free, f"{cfg.name} at depth {cfg.n_layers} does not fit the free memory")
    t0 = time.perf_counter()
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name} drawn on the card in {time.perf_counter() - t0:.1f} s at full width (d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, {cfg.moe.n_experts} experts of d_ff {cfg.moe.d_ff}, top-{cfg.moe.top_k}, "
          f"{cfg.moe.n_shared_experts} shared, vocab {cfg.vocab}), depth {cfg.n_layers}: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    err, times = llama4_kernel_checks(model, dev, lut_case, lookups_per_s)
    phase_done("11a llama4 kernels vs plain")
    llama4_serving_bitwise(model, dev)
    phase_done("11b llama4 serving, amsim vs amsim_torch")
    launches = llama4_serve_full(model, dev, smi_line, times)
    phase_done("11c llama4 serving, full width")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    llama4_train_bitwise(dev)
    phase_done("11b llama4 training, amsim vs amsim_torch")
    run = train_full(dev, LLAMA4_ARCH, lookups_per_s, smi_line, shape=LLAMA4_TRAIN,
                     capture_step=1, stride=LLAMA4_HEAD_STRIDE, n_layers=LLAMA4_DEPTH,
                     n_experts=LLAMA4_TRAIN_EXPERTS)
    print(f"launches on the {LLAMA4_ARCH} training run (11c, {LLAMA4_TRAIN['steps']} steps at "
          f"{LLAMA4_TRAIN['batch']} x {LLAMA4_TRAIN['seq']}, depth {LLAMA4_DEPTH}, "
          f"{LLAMA4_TRAIN_EXPERTS} experts): {run}")
    for k, n in run.items():
        launches[k] = launches.get(k, 0) + n
    phase_done("11c llama4 training, full width")
    return err, launches


# ------------------------------------------------------------ 12. the mesh
MESH_SHAPE = (2, 2)                                  # (data, model): four ranks
DP_SHAPE = (4, 1)                                    # resnet-mini data-parallel
MESH_SERVE = dict(batch=4, prompt=64, new=8)
MESH_TRAIN = dict(n_layers=4, batch=4, seq=64, steps=1)
MESH_KILL = dict(n_layers=2, new=4)
MESH_VISION_RTOL = 1e-4     # resnet-mini's loss and parameters after step 1
MESH_TIMEOUT = 900       # phases 12 and 13 in one spawn
MESH_KERNELS = ("approx_gemm", "approx_gemm_batched", "approx_attention",
                "approx_conv2d_fused", "approx_conv2d_dw")


def mesh_counters():
    from repro_torch.kernels import approx_attention as attn_mod
    from repro_torch.kernels import approx_conv as conv_mod
    from repro_torch.kernels import approx_gemm as gemm_mod
    from repro_torch.kernels import decode_chain as chain
    return {"approx_gemm": gemm_mod.approx_gemm,
            "approx_gemm_batched": gemm_mod.approx_gemm_batched,
            "approx_attention": attn_mod.approx_attention,
            "approx_conv2d_fused": conv_mod.approx_conv2d_fused,
            "approx_conv2d_dw": conv_mod.approx_conv2d_dw,
            "fused_qkv_norm": chain.fused_qkv_norm, "fused_out_mlp": chain.fused_out_mlp,
            "fused_attn_out_mlp": chain.fused_attn_out_mlp}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / max(float(b.float().norm()), 1e-30))


def _bitwise(a, b) -> bool | str:
    if torch.equal(a.view(torch.int32), b.view(torch.int32)):
        return True
    return f"max|d| {(a - b).abs().max().item():.3g}"


def mesh_contracts(mesh, dp) -> dict:
    """12a on this rank: the contract rows at granite-3-2b's full-width
    shapes (one layer, a 4 x 64 prefill) on the 2x2 mesh, resnet-mini's
    convs on the (4, 1) mesh, and compressed_all_reduce of a 2048 x 8192
    gradient on the (4, 1) mesh; every reference through the same kernels
    on the whole tensors (each rank builds them: the same seeded draws)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.distributed import shard_fused as sf
    from repro_torch.distributed.compression import (compressed_all_reduce, dequantize_int8,
                                                     quantize_int8)
    from repro_torch.kernels import ops
    dev = mesh.device
    pol = NumericsPolicy(mode="amsim", multiplier="afm16")
    leaf = pol.resolve(None)
    cfg = get_arch(LM_ARCH)
    B, S, d, F = MESH_SERVE["batch"], MESH_SERVE["prompt"], cfg.d_model, cfg.d_ff
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def rows(t, m=mesh):
        return m.block(t, m.data_axes, 0)

    def cols(t, dim=-1):
        return mesh.block(t, "model", dim)

    out = {}
    x, h = randn(B, S, d), randn(B, S, F)
    for name, (w_in, w_out, n) in {"wq/wo": (randn(d, H * dh, scale=d ** -0.5),
                                             randn(H * dh, d, scale=(H * dh) ** -0.5), H * dh),
                                   "wg/wd": (randn(d, F, scale=d ** -0.5),
                                             randn(F, d, scale=F ** -0.5), F)}.items():
        inp = x
        ref = ops.policy_matmul(inp, w_in, pol)
        out[f"{name} column forward bitwise"] = _bitwise(
            sf.column_parallel_matmul(rows(inp), cols(w_in), pol, mesh), cols(rows(ref)))
        y = ref if name == "wq/wo" else h
        half = n // 2
        oracle = (ops.policy_matmul(y[..., :half], w_out[:half], pol)
                  + ops.policy_matmul(y[..., half:], w_out[half:], pol))
        out[f"{name} row forward == k-split oracle"] = _bitwise(
            sf.row_parallel_matmul(cols(rows(y)), cols(w_out, 0), pol, mesh), rows(oracle))
        g = randn(B, S, n)
        xl, wl = rows(inp).clone().requires_grad_(), cols(w_in).clone().requires_grad_()
        dx, dw = torch.autograd.grad(sf.column_parallel_matmul(xl, wl, pol, mesh), (xl, wl),
                                     cols(rows(g)))
        dx_oracle = (ops._matmul_nograd(g[..., :half], w_in[:, :half].T, leaf)
                     + ops._matmul_nograd(g[..., half:], w_in[:, half:].T, leaf))
        out[f"{name} column dx == k-split oracle"] = _bitwise(dx, rows(dx_oracle))
        dw_oracle = sf._dw(inp[:B // 2], g[:B // 2], leaf) + sf._dw(inp[B // 2:], g[B // 2:], leaf)
        out[f"{name} column dw (batch split) == k-split oracle"] = _bitwise(dw, cols(dw_oracle))
    q, k, v = randn(B, S, H, dh), randn(B, S, KV, dh), randn(B, S, KV, dh)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    full = [t.clone().requires_grad_() for t in (q, k, v)]
    aref = ops.policy_attention(*full, pos, pos, pol, True, 0)
    gref = torch.autograd.grad((aref ** 2).sum(), full)
    loc = [cols(rows(t), 2).clone().requires_grad_() for t in (q, k, v)]
    aout = sf.sharded_attention(*loc, pos, pos, pol, causal=True, window=0)
    out["attention forward bitwise"] = _bitwise(aout, cols(rows(aref.detach()), 2))
    gsh = torch.autograd.grad((aout ** 2).sum(), loc)
    out["attention dq dk dv bitwise"] = all(
        _bitwise(a, cols(rows(b), 2)) is True for a, b in zip(gsh, gref)) or "differ"

    with dp:
        n_dp = dp.data_size
        for i, (xs, ws, stride) in enumerate(CONV_SHAPES[:8]):       # resnet-mini's convs
            xc, wc = randn(*xs), randn(*ws, scale=0.1)
            xr, wr = xc.clone().requires_grad_(), wc.clone().requires_grad_()
            cref = ops.approx_conv2d(xr, wr, stride, "SAME", pol)
            gx_ref, _ = torch.autograd.grad((cref ** 2).sum(), (xr, wr))
            xl, wl = rows(xc, dp).clone().requires_grad_(), wc.clone().requires_grad_()
            cout = sf.sharded_conv2d(xl, wl, stride, "SAME", pol, dp)
            gx, gw = torch.autograd.grad((cout ** 2).sum(), (xl, wl))
            pads = ops.conv_pads(xs[1], xs[2], ws[0], ws[1], stride, "SAME")
            gfull, m = 2.0 * cref.detach(), xs[0] // n_dp
            oracle = None
            for r in range(n_dp):
                part = ops._conv_dw(xc[r * m:(r + 1) * m], wc.shape,
                                    gfull[r * m:(r + 1) * m].contiguous(), stride, pads,
                                    pol.resolve("conv", pass_="dw"))
                oracle = part if oracle is None else oracle + part
            tag = f"resnet-mini conv {i} {xs}x{ws}/s{stride}"
            out[f"{tag} forward bitwise"] = _bitwise(cout, rows(cref.detach(), dp))
            out[f"{tag} dx bitwise"] = _bitwise(gx, rows(gx_ref, dp))
            out[f"{tag} dw == batch-split oracle"] = _bitwise(gw, oracle)
        grad = torch.randn((2048, 8192), generator=torch.Generator(device=dev).manual_seed(
            SEED + 1 + dp.rank), device=dev) * 0.01
        mean, ef = compressed_all_reduce({"g": grad}, {"g": torch.zeros_like(grad)}, dp, "data")
        every = dp.all_gather(grad, "data")
        scale = None
        for g in every:
            s = quantize_int8(g)[1]
            scale = s if scale is None else torch.maximum(scale, s)
        qs = [quantize_int8(g, scale) for g in every]
        total = qs[0][0].to(torch.int32)
        for q_, _, _ in qs[1:]:
            total = total + q_.to(torch.int32)
        want = dequantize_int8(total, scale, qs[0][2], grad.shape) / n_dp
        out["compressed_all_reduce 2048 x 8192 == the composition on one rank"] = _bitwise(
            mean["g"], want)
        out["its error feedback == the composition's"] = _bitwise(
            ef["g"], grad - dequantize_int8(qs[dp.rank][0], scale, qs[dp.rank][2], grad.shape))
    return out


def single_device_ctx():
    from repro_torch.launch.mesh import single_device
    return single_device()


def _timed_generate(engine, prompts, new, mesh=None):
    """(tokens, logits, seconds, the mesh's collectives and their seconds)."""
    if mesh is not None:
        mesh.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, logits = engine.generate(prompts, new, return_logits=True)
    torch.cuda.synchronize()
    stats = dict(mesh.stats) if mesh is not None else None
    return toks, logits, time.perf_counter() - t0, stats


def _agreement(toks, ref_toks, logits, ref_logits) -> dict:
    """Tokens and logits of a run against the single-device run's, up to
    the first token where they part (past it the two runs read different
    prompts): the relative norm of the logit difference, its largest
    entry, and each parting checked against the reference's top-2 margin
    there."""
    B, n = ref_toks.shape
    first = n
    for i in range(n):
        if not torch.equal(toks[:, i], ref_toks[:, i]):
            first = i
            break
    upto = first + 1 if first < n else n      # the inputs agree up to the parting step
    gap = (logits[:, :upto] - ref_logits[:, :upto]).abs().max().item()
    rel = _rel(logits[:, :upto], ref_logits[:, :upto])
    top2 = torch.topk(ref_logits, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])
    bad = [(b, i) for b in range(B) for i in range(upto)
           if toks[b, i] != ref_toks[b, i] and margin[b, i].item() > gap]
    return {"first_parting": first, "positions": B * n, "equal": int((toks == ref_toks).sum()),
            "rel": rel, "gap": gap, "parted_above_margin": bad,
            "min_margin": margin[:, :upto].min().item()}


def mesh_serving(mesh, counters) -> dict:
    """12b on this rank: granite-3-2b at full width and depth on the 2x2
    mesh, a 4 x 64 prefill and 8 greedy tokens; then (rank 0) the
    single-device per-op run (the chain off) of the same weights and prompts,
    and the mesh's prefill with a row sum missing one shard (the wrong
    variant)."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ServingEngine
    dev, cfg = mesh.device, get_arch(LM_ARCH)
    pol = NumericsPolicy(mode="amsim", multiplier="afm16")
    B, S, new = MESH_SERVE["batch"], MESH_SERVE["prompt"], MESH_SERVE["new"]
    prompts = torch.randint(0, cfg.vocab, (B, S), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    t0 = time.perf_counter()
    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev,
                    mesh=mesh)
    torch.cuda.synchronize()
    out = {"draw_s": time.perf_counter() - t0,
           "params_gb": sum(p.numel() for p in model.parameters()) * 4 / 1e9}
    engine = ServingEngine(model, pol, max_len=S + new, mesh=mesh)
    _timed_generate(engine, prompts[:, :8], 2, mesh)                # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, t_pre, st_pre = _timed_generate(engine, prompts, 1, mesh)
    zero_launches(counters)
    toks, logits, t_all, st_all = _timed_generate(engine, prompts, new, mesh)
    out["launches"] = launches_of(counters)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    steps = new - 1
    out.update(prefill_s=t_pre, total_s=t_all, tokens_per_s=B * new / t_all,
               step_ms=1e3 * (t_all - t_pre) / steps,
               coll_prefill=st_pre["collectives"],
               coll_step=(st_all["collectives"] - st_pre["collectives"]) / steps,
               coll_step_share=(st_all["seconds"] - st_pre["seconds"]) / (t_all - t_pre))
    whole = mesh.all_gather          # the wrong variant: each row sum keeps shard 0 alone
    mesh.ordered_sum = lambda t, axes: whole(t, axes)[0] if axes == "model" else \
        type(mesh).ordered_sum(mesh, t, axes)
    _, wrong_logits, _, _ = _timed_generate(engine, prompts, 1, mesh)
    del mesh.ordered_sum
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        from repro_torch.distributed.oracle import ksplit
        from repro_torch.launch.mesh import MeshShape
        ref = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        with ksplit(ref, MeshShape(MESH_SHAPE)):       # the k-split oracle, the chain off
            otoks, ologits, rt, _ = _timed_generate(ServingEngine(ref, pol, max_len=S + new),
                                                    prompts, new)
        out["oracle_tokens"] = torch.equal(toks, otoks)
        out["oracle_logits"] = _bitwise(logits, ologits)
        out["wrong_oracle"] = _bitwise(wrong_logits[:, :1], ologits[:, :1])
        os.environ["REPRO_DECODE_FUSED"] = "0"
        try:        # the unsplit per-op run: what the mesh's split sums alone move
            with single_device_ctx():
                rtoks, rlogits, _, _ = _timed_generate(ServingEngine(ref, pol, max_len=S + new),
                                                       prompts, new)
        finally:
            del os.environ["REPRO_DECODE_FUSED"]
        out["agreement"] = _agreement(toks, rtoks, logits, rlogits)
        out["wrong_rel"] = _rel(wrong_logits[:, :1], rlogits[:, :1])
        out["single_s"] = rt
        out["single_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _grads_of(model, batch, pol, mesh=None):
    from repro_torch.distributed.sharding import gather_tensor
    from repro_torch.models.transformer import lm_loss
    loss, _ = lm_loss(model, batch, pol)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    if mesh is not None:
        grads = [gather_tensor(g, getattr(p, "spec", ()), mesh)
                 for g, p in zip(grads, params.values())]
    return loss.detach(), dict(zip(params, grads))


def mesh_training(mesh, dp, counters) -> dict:
    """12c on this rank: granite-3-2b at full width and depth 4 on the 2x2
    mesh, step 1's loss and gradient (gathered) against the single-device
    one (rank 0), then MESH_TRAIN's adamw steps timed; resnet-mini
    data-parallel on the (4, 1) mesh, 2 sgdm steps at batch 64, step 1's
    loss and parameters against the single-device step (rank 0)."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs.base import get_arch
    from repro_torch.configs.paper_models import VISION_REGISTRY
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.data.pipeline import lm_batch, vision_batches, vision_dataset
    from repro_torch.launch.train import make_lm_train_step
    from repro_torch.models.transformer import init_lm
    from repro_torch.models.vision import init_vision, vision_loss
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.step import make_train_step
    dev = mesh.device
    pol = NumericsPolicy(mode="amsim", multiplier="afm16")
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=MESH_TRAIN["n_layers"])
    B, S, steps = MESH_TRAIN["batch"], MESH_TRAIN["seq"], MESH_TRAIN["steps"]
    out = {}

    def rows(batch, m=mesh):
        return {k: m.block(v, m.data_axes, 0) for k, v in batch.items()}

    model = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev,
                    mesh=mesh)
    loss, grads = _grads_of(model, rows(lm_batch(cfg, (B, S), 0, dev)), pol, mesh)
    whole = mesh.all_gather          # the wrong variant: each row sum keeps shard 0 alone
    mesh.ordered_sum = lambda t, axes: whole(t, axes)[0] if axes == "model" else \
        type(mesh).ordered_sum(mesh, t, axes)
    _, wrong = _grads_of(model, rows(lm_batch(cfg, (B, S), 0, dev)), pol, mesh)
    del mesh.ordered_sum
    if mesh.rank == 0:
        from repro_torch.distributed.oracle import ksplit_loss_and_grads
        from repro_torch.launch.mesh import MeshShape
        batch = lm_batch(cfg, (B, S), 0, dev)
        ref = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        oloss, ograds = ksplit_loss_and_grads(ref, batch, pol, MeshShape(MESH_SHAPE))
        with single_device_ctx():       # the unsplit step: what the split sums alone move
            rloss, rgrads = _grads_of(ref, batch, pol)
        del ref
        out["lm_step1"] = {
            "loss": float(loss), "ref_loss": float(rloss), "loss_bitwise": _bitwise(loss, oloss),
            "leaves": len(ograds),
            "differ": [n for n, g in ograds.items() if _bitwise(grads[n], g) is not True],
            "wrong_equal": [n for n, g in ograds.items() if _bitwise(wrong[n], g) is True],
            "loss_rel": abs(float(loss) - float(rloss)) / abs(float(rloss)),
            "worst_grad_rel": max((_rel(grads[n], g), n) for n, g in rgrads.items()),
            "wrong_worst_rel": max((_rel(wrong[n], g), n) for n, g in rgrads.items())}
        del ograds, rgrads
    del grads, wrong
    gc.collect()
    torch.cuda.empty_cache()
    opt, step = make_lm_train_step(cfg, pol, lr=TRAIN_LR, steps=steps)
    state = opt.init(dict(model.named_parameters()))
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches(counters)
    mesh.reset_stats()
    times, losses = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(model, state, rows(lm_batch(cfg, (B, S), i, dev)))
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    out["lm_launches"] = launches_of(counters)
    out["lm"] = {"ms": [1e3 * t for t in times], "losses": losses,
                 "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                 "collectives": mesh.stats["collectives"] / steps,
                 "coll_share": mesh.stats["seconds"] / sum(times)}
    del model, state, opt, step
    gc.collect()
    torch.cuda.empty_cache()

    vcfg = VISION_REGISTRY["resnet-mini"]
    data = vision_dataset(vcfg.name, BATCH * 2, 0, vcfg.input_hw, vcfg.input_ch, vcfg.n_classes,
                          seed=SEED)
    batches = [{"x": torch.from_numpy(bt["x"]).to(dev), "y": torch.from_numpy(bt["y"]).to(dev)}
               for bt in vision_batches(data, BATCH, 0)][:2]

    def fresh():
        m = init_vision(vcfg, generator=torch.Generator().manual_seed(SEED), device=dev)
        o = make_optimizer("sgdm", 0.05)
        return m, o.init(dict(m.named_parameters())), make_train_step(
            lambda mm, b: vision_loss(mm, b, pol), o, clip_norm=1.0)

    with dp:
        vm, vstate, vstep = fresh()
        zero_launches(counters)
        vlosses, vtimes = [], []
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vstate, metrics = vstep(vm, vstate, rows(b, dp))
            vlosses.append(float(metrics["loss"]))
            vtimes.append(time.perf_counter() - t0)
            if i == 0:
                after1 = [p.detach().clone() for p in vm.parameters()]
        out["vision_launches"] = launches_of(counters)
        out["vision"] = {"losses": vlosses, "ms": [1e3 * t for t in vtimes]}
    if mesh.rank == 0:
        with single_device_ctx():
            rm, rstate, rstep = fresh()
            _, rmetrics = rstep(rm, rstate, batches[0])
            out["vision_step1"] = {
                "loss_rel": abs(vlosses[0] - float(rmetrics["loss"])) / abs(float(rmetrics["loss"])),
                "worst_param_rel": max(_rel(a, b.detach()) for a, b in zip(after1, rm.parameters()))}
    dist.barrier()
    return out


def mesh_kill_switch(mesh, counters) -> dict:
    """12d on this rank: REPRO_SHARD_FUSED=0 at depth 2 on the 2x2 mesh,
    the replicated dispatch (the chain on the gathered weights), against
    the single-device run with the chain on (rank 0): logits and tokens."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ServingEngine
    dev = mesh.device
    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=MESH_KILL["n_layers"])
    pol = NumericsPolicy(mode="amsim", multiplier="afm16")
    B, S, new = MESH_SERVE["batch"], MESH_SERVE["prompt"], MESH_KILL["new"]
    prompts = torch.randint(0, cfg.vocab, (B, S), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = init_lm(cfg, generator=gen, device=dev, mesh=mesh)
    os.environ["REPRO_SHARD_FUSED"] = "0"
    try:
        zero_launches(counters)
        toks, logits, t, _ = _timed_generate(ServingEngine(model, pol, max_len=S + new, mesh=mesh),
                                             prompts, new, mesh)
        out = {"launches": launches_of(counters), "s": t}
    finally:
        del os.environ["REPRO_SHARD_FUSED"]
    if mesh.rank == 0:
        with single_device_ctx():
            ref = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
            rtoks, rlogits, _, _ = _timed_generate(ServingEngine(ref, pol, max_len=S + new),
                                                   prompts, new)
        out["tokens_bitwise"] = torch.equal(toks, rtoks)
        out["logits_bitwise"] = _bitwise(logits, rlogits)
    dist.barrier()
    return out


# ------------------------------------------- 13. every family on the mesh
FAM_MOE = "granite-moe-3b-a800m"
FAM_STREAM = dict(requests=6, prompt=(16, 48), new=(8, 16), capacity=4, page=16)
FAM_MOE_TRAIN = dict(n_layers=4, batch=4, seq=64, steps=1)
# mamba2 and zamba2: served at depth 24 (of 48 and 38: cut for time); one
# training step at 4 x 256 (a chunk a row) at a cut depth (time: every
# weight gradient's data sum goes through gloo's host copies), zamba2's
# applying its shared block twice
FAM_SSM = {"mamba2-780m": dict(train_layers=4), "zamba2-1.2b": dict(train_layers=12)}
FAM_SSM_SERVE = dict(batch=4, prompt=64, new=4, n_layers=24)
FAM_SSM_TRAIN = dict(batch=4, seq=256)
FAM_WHISPER = "whisper-base"
FAM_WHISPER_SERVE = dict(batch=4, prompt=4, new=8)
FAM_WHISPER_TRAIN = dict(batch=4, seq=64)
FAM_KILL = dict(n_layers=2, batch=4, prompt=64, new=4)
FAM_KERNELS = ("approx_gemm", "approx_gemm_batched", "approx_attention")


def fam_cfg(arch, n_layers=None):
    """An arch of phase 13 at full width, its depth cut to ``n_layers``."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    cfg = get_arch(arch)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def family_counters():
    from repro_torch.kernels import decode_chain as chain
    return {**mesh_counters(), "fused_wo_norm": chain.fused_wo_norm,
            "fused_moe_ffn": chain.fused_moe_ffn}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _params_gb(model) -> float:
    return sum(p.numel() for p in model.parameters()) * 4 / 1e9


def _afm16():
    from repro_torch.core.policy import NumericsPolicy
    return NumericsPolicy(mode="amsim", multiplier="afm16")


def _fam_init(cfg, dev, mesh=None):
    """The arch's model from ``SEED`` on ``dev``: this rank's blocks under a
    mesh, every tensor without one."""
    from repro_torch.models.encdec import init_encdec
    from repro_torch.models.transformer import init_lm
    init = init_encdec if cfg.family == "encdec" else init_lm
    return init(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev,
                mesh=mesh)


def _fam_grads(model, batch, pol, mesh=None):
    """(loss, {name: gradient}) of one step's loss, the gradients gathered
    under a mesh."""
    from repro_torch.distributed.sharding import gather_tensor
    from repro_torch.models.encdec import encdec_loss
    from repro_torch.models.transformer import lm_loss
    loss_fn = encdec_loss if model.cfg.family == "encdec" else lm_loss
    loss, metrics = loss_fn(model, batch, pol)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    if mesh is not None:
        grads = [gather_tensor(g, getattr(p, "spec", ()), mesh)
                 for g, p in zip(grads, params.values())]
    return (loss.detach(), dict(zip(params, grads)),
            {k: float(v.detach()) for k, v in metrics.items()})


def _missing_shard(mesh):
    """The wrong variant: each row sum over "model" keeps shard 0 alone."""
    whole = mesh.all_gather
    mesh.ordered_sum = lambda t, axes: whole(t, axes)[0] if axes == "model" else \
        type(mesh).ordered_sum(mesh, t, axes)


def _step_verdict(mesh, model, batch, pol, dev, counters, wrong=False) -> dict:
    """A training step's loss and gathered gradients on the mesh (its
    launches counted), with ``wrong`` the missing-shard variant's, and
    (rank 0) both against the k-split oracle and the unsplit single-device
    step (a reading)."""
    from repro_torch.distributed.oracle import ksplit_loss_and_grads
    from repro_torch.launch.mesh import MeshShape
    rows = {k: mesh.block(v, mesh.data_axes, 0) for k, v in batch.items()}
    _reset_peak(dev)
    zero_launches(counters)
    t0 = time.perf_counter()
    loss, grads, metrics = _fam_grads(model, rows, pol, mesh)
    _sync(dev)
    out = {"step_s": time.perf_counter() - t0, "metrics": metrics,
           "launches": launches_of(counters), "peak_gb": _peak_gb(dev)}
    if wrong:
        _missing_shard(mesh)
        _, wrong, _ = _fam_grads(model, rows, pol, mesh)
        del mesh.ordered_sum
    if mesh.rank == 0:
        ref = _fam_init(model.cfg, dev)
        oloss, ograds = ksplit_loss_and_grads(ref, batch, pol, MeshShape(MESH_SHAPE))
        with single_device_ctx():
            rloss, rgrads, _ = _fam_grads(ref, batch, pol)
        del ref
        out.update(
            loss=float(loss), ref_loss=float(rloss), loss_bitwise=_bitwise(loss, oloss),
            leaves=len(ograds),
            differ=[n for n, g in ograds.items() if _bitwise(grads[n], g) is not True],
            loss_rel=abs(float(loss) - float(rloss)) / abs(float(rloss)),
            worst_grad_rel=max((_rel(grads[n], g), n) for n, g in rgrads.items()))
        if wrong:
            out.update(
                wrong_equal=[n for n, g in ograds.items() if _bitwise(wrong[n], g) is True],
                wrong_worst_rel=max((_rel(wrong[n], g), n) for n, g in rgrads.items()))
        del ograds, rgrads
    del grads, wrong
    _free(dev)
    return out


def fam_requests(cfg) -> list:
    """13a's stream: FAM_STREAM's requests drawn from ``SEED`` with numpy,
    one arrival a tick."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    lo, hi = FAM_STREAM["prompt"]
    nlo, nhi = FAM_STREAM["new"]
    return [(i, rng.integers(1, cfg.vocab, size=int(rng.integers(lo, hi + 1))).tolist(),
             int(rng.integers(nlo, nhi + 1)), "default")
            for i in range(FAM_STREAM["requests"])]


def _tapped():
    """A context: every forward of the paged scheduler's lane steps, in
    turn, as [(tokens, logits)] on the host (a prefill's on its owner's
    ranks, a tick's rows of this rank's data block)."""
    import contextlib

    from repro_torch.serve import scheduler

    @contextlib.contextmanager
    def tap():
        calls, forward = [], scheduler.lm_forward

        def tapped(model, tokens, policy, **kw):
            out = forward(model, tokens, policy, **kw)
            calls.append((tokens.cpu(), out[0].cpu()))
            return out
        scheduler.lm_forward = tapped
        try:
            yield calls
        finally:
            scheduler.lm_forward = forward
    return tap()


def _run_stream(model, pol, stream, dev, mesh=None):
    """The stream through ``ContinuousBatchingEngine``, its forwards tapped:
    (engine, wall seconds, ({rid: tokens}, [(tokens, logits)]))."""
    from repro_torch.serve.scheduler import ContinuousBatchingEngine
    max_len = FAM_STREAM["prompt"][1] + FAM_STREAM["new"][1] + 1
    eng = ContinuousBatchingEngine(model, {"default": pol}, max_len=max_len,
                                   capacity=FAM_STREAM["capacity"], page_size=FAM_STREAM["page"],
                                   mesh=mesh)
    _sync(dev)
    t0 = time.perf_counter()
    with _tapped() as calls:
        eng.run(stream)
    _sync(dev)
    wall = time.perf_counter() - t0
    return eng, wall, ({rid: list(r.out) for rid, r in eng.finished.items()}, calls)


def _ticks(calls) -> list:
    """Each decode tick's (tokens, logits) of a single-device stream, a
    tick that ran in data blocks (the oracle's) put back together."""
    out, part = [], []
    for c in calls:
        if c[0].shape[1] == 1:
            part.append(c)
            if sum(t.shape[0] for t, _ in part) == FAM_STREAM["capacity"]:
                out.append(tuple(torch.cat(x) for x in zip(*part)))
                part = []
    return out


def _paired_calls(runs, want) -> list | str:
    """The mesh's stream, ``runs`` each data rank's ({rid: tokens}, calls),
    against a single-device one ``want``: [(the mesh's logits, want's,
    same inputs)], a decode tick's the data ranks' blocks put together, a
    prefill's its owner's of the same prompt; or where they do not pair."""
    calls = want[1]
    ticks = _ticks(calls)
    prefills = [c for c in calls if c[0].shape[1] > 1]
    mine = [[c for c in r[1] if c[0].shape[1] > 1] for r in runs]
    got_ticks = [[c for c in r[1] if c[0].shape[1] == 1] for r in runs]
    if sum(map(len, mine)) != len(prefills) or any(len(t) != len(ticks) for t in got_ticks):
        return (f"{[len(m) for m in mine]} prefills and {[len(t) for t in got_ticks]} ticks "
                f"against {len(prefills)} and {len(ticks)}")
    pairs = []
    for i, (tw, lw) in enumerate(ticks):
        tg, lg = (torch.cat(x) for x in zip(*(t[i] for t in got_ticks)))
        pairs.append((lg, lw, torch.equal(tg, tw)))
    for tw, lw in prefills:
        owner = next((m for m in mine if m and torch.equal(m[0][0], tw)), None)
        if owner is None:
            return f"no data rank prefilled a prompt of {tw.shape[1]} tokens"
        pairs.append((owner.pop(0)[1], lw, True))
    return pairs


def _stream_verdict(runs, want) -> bool | str:
    """True when every request's tokens are ``want``'s and every paired
    forward's logits bitwise, else what differs."""
    if any(r[0] != want[0] for r in runs):
        return "tokens differ"
    pairs = _paired_calls(runs, want)
    if isinstance(pairs, str):
        return pairs
    bad = [i for i, (a, b, same) in enumerate(pairs) if not same or _bitwise(a, b) is not True]
    return True if not bad else (f"{len(bad)} of {len(pairs)} forwards differ, the first "
                                 f"{_bitwise(*pairs[bad[0]][:2])}")


def _stream_gap(runs, want) -> tuple:
    """(tokens equal, tokens, the logits' largest |d| and relative norm over
    the forwards whose inputs agree)."""
    toks = want[0]
    eq = sum(x == y for rid in toks for x, y in zip(runs[0][0][rid], toks[rid]))
    n = sum(len(t) for t in toks.values())
    pairs = _paired_calls(runs, want)
    if isinstance(pairs, str):
        return eq, n, math.nan, math.nan
    same = [(a, b) for a, b, s in pairs if s]
    gap = max(float((a - b).abs().max()) for a, b in same)
    num = sum(float((a - b).norm() ** 2) for a, b in same)
    den = sum(float(b.norm() ** 2) for _, b in same)
    return eq, n, gap, (num / max(den, 1e-30)) ** 0.5


def _gathered_runs(mesh, run) -> list | None:
    """On rank 0, each data rank's ({rid: tokens}, calls) of a stream (its
    first "model" rank's: the logits are gathered over "model"); None
    elsewhere."""
    import torch.distributed as dist
    mine = (mesh.index(mesh.data_axes), run if mesh.index("model") == 0 else None)
    every = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(mine, every, dst=0)
    if mesh.rank:
        return None
    return [r for _, r in sorted((d, r) for d, r in every if r is not None)]


def _shape_witness(model, dev) -> dict:
    """Whether ``native``'s products are bitwise at the mesh's shapes of a
    call on this card: layer 0's expert banks on a buffer of C = 8 (a tick's
    or a B = 1 prefill's) as one call over every expert against one a
    "model" block of them; the tied head on 4 rows against 2 + 2."""
    from repro_torch.models.moe import _Bank
    from repro_torch.models.mlp import ffn
    from repro_torch.core.policy import NumericsPolicy
    cfg, pol, n = model.cfg, NumericsPolicy(), MESH_SHAPE[1]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ew = model.layers[0].moe["experts"]
    buf = torch.randn((cfg.moe.n_experts, 8, cfg.d_model), generator=gen, device=dev)
    x = torch.randn((4, cfg.d_model), generator=gen, device=dev)
    w = model.embed.emb.detach().T
    with torch.no_grad():
        whole = ffn(ew, buf, pol, cfg.act)
        blocks = torch.cat([ffn({k: _Bank(lin.w.chunk(n, 0)[i]) for k, lin in ew.items()}, b,
                                pol, cfg.act) for i, b in enumerate(buf.chunk(n, 0))])
        head = x @ w
        halves = torch.cat([x[:2] @ w, x[2:] @ w])
    return {"banks": _bitwise(whole, blocks), "head": _bitwise(head, halves)}


def fam_stream(mesh, counters) -> dict:
    """13a on this rank: granite-moe-3b-a800m at full width and depth
    through ``ContinuousBatchingEngine(mesh=)``: the stream under afm16
    (counted, timed), then under native; (rank 0) each against the k-split
    oracle's stream, and against the unsplit single-device stream (a
    reading), and native's bits at the mesh's shapes of a call."""
    import torch.distributed as dist
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.distributed.oracle import ksplit
    from repro_torch.launch.mesh import MeshShape
    dev, cfg = mesh.device, fam_cfg(FAM_MOE)
    stream = fam_requests(cfg)
    t0 = time.perf_counter()
    model = _fam_init(cfg, dev, mesh)
    _sync(dev)
    out = {"draw_s": time.perf_counter() - t0, "params_gb": _params_gb(model),
           "requests": [(len(p), n) for _, p, n, _ in stream]}
    _reset_peak(dev)
    mesh.reset_stats()
    zero_launches(counters)
    eng, wall, got = _run_stream(model, _afm16(), stream, dev, mesh)
    out["launches"] = launches_of(counters)
    lane = eng._lanes["default"]
    tokens = sum(len(t) for t in got[0].values())
    out.update(wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall, ticks=lane.decode_ticks,
               tick_ms=1e3 * sum(lane.decode_s) / max(lane.decode_ticks, 1),
               admissions=sum(len(v) for v in lane.prefill_s.values()),
               prefill_ms=1e3 * sum(sum(v) for v in lane.prefill_s.values())
               / max(sum(len(v) for v in lane.prefill_s.values()), 1),
               collectives=mesh.stats["collectives"], coll_s=mesh.stats["seconds"],
               preemptions=sum(r.preemptions for r in eng.finished.values()),
               pages_high=lane.pages_high, peak_gb=_peak_gb(dev),
               pool_specs=lane.cache_specs[0]["pool_k"])
    del eng, lane
    got = _gathered_runs(mesh, got)
    _, out["native_s"], nat = _run_stream(model, NumericsPolicy(), stream, dev, mesh)
    nat = _gathered_runs(mesh, nat)
    del model
    _free(dev)
    if mesh.rank == 0:
        ref = _fam_init(cfg, dev)
        for name, pol, runs in (("afm16", _afm16(), got), ("native", NumericsPolicy(), nat)):
            with ksplit(ref, MeshShape(MESH_SHAPE)):
                _, t_oracle, oracle = _run_stream(ref, pol, stream, dev)
            with single_device_ctx():
                os.environ["REPRO_DECODE_FUSED"] = "0"
                try:
                    _, _, unsplit = _run_stream(ref, pol, stream, dev)
                finally:
                    del os.environ["REPRO_DECODE_FUSED"]
            out[name] = {"oracle": _stream_verdict(runs, oracle), "oracle_s": t_oracle,
                         "gap": _stream_gap(runs, unsplit)}
            del oracle, unsplit
        out["witness"] = _shape_witness(ref, dev)
        del ref
        _free(dev)
    dist.barrier()
    return out


def fam_moe_train(mesh, counters) -> dict:
    """13b on this rank: granite-moe at full width, depth 4, 4 x 64: step
    1's loss and gradients against the k-split oracle (rank 0), then
    FAM_MOE_TRAIN's adamw steps timed."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch.train import make_lm_train_step
    dev = mesh.device
    cfg = fam_cfg(FAM_MOE, FAM_MOE_TRAIN["n_layers"])
    B, S, steps = FAM_MOE_TRAIN["batch"], FAM_MOE_TRAIN["seq"], FAM_MOE_TRAIN["steps"]
    model = _fam_init(cfg, dev, mesh)
    out = _step_verdict(mesh, model, lm_batch(cfg, (B, S), 0, dev), _afm16(), dev, counters,
                        wrong=True)
    del out["launches"]          # the adamw steps below are the path's
    opt, step = make_lm_train_step(cfg, _afm16(), lr=TRAIN_LR, steps=steps)
    state = opt.init(dict(model.named_parameters()))
    _reset_peak(dev)
    zero_launches(counters)
    mesh.reset_stats()
    times, losses = [], []
    for i in range(steps):
        rows = {k: mesh.block(v, mesh.data_axes, 0) for k, v in lm_batch(cfg, (B, S), i,
                                                                          dev).items()}
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step(model, state, rows)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    out["launches"] = launches_of(counters)
    out.update(ms=[1e3 * t for t in times], losses=losses, peak_gb=_peak_gb(dev),
               params_gb=_params_gb(model), collectives=mesh.stats["collectives"] / steps,
               coll_share=mesh.stats["seconds"] / sum(times))
    del model, state, opt, step
    _free(dev)
    dist.barrier()
    return out


def _by_data_block(fn, *tensors):
    """``fn`` run on each data rank's rows of ``tensors`` in turn, each
    output concatenated over the blocks: the single-device run of a mesh's
    serving where a row's ops are row-local only at a fixed row count (the
    SSM recurrence's exact float32 einsums are cuBLAS's, which picks its
    algorithm by the rows of a call)."""
    D = MESH_SHAPE[0]
    outs = [fn(*(t.chunk(D, 0)[d] for t in tensors)) for d in range(D)]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


def _serve_verdict(mesh, model, pol, dev, prompts, new, counters) -> dict:
    """A batch served on the mesh (counted, timed) against (rank 0) the
    k-split oracle's run (each data rank's rows in turn) and the unsplit
    per-op run (a reading)."""
    from repro_torch.distributed.oracle import ksplit
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.serve.engine import ServingEngine
    S = prompts.shape[1]
    engine = ServingEngine(model, pol, max_len=S + new, mesh=mesh)
    _reset_peak(dev)
    zero_launches(counters)
    toks, logits, t, st = _timed_generate(engine, prompts, new, mesh)
    out = {"s": t, "collectives": st["collectives"], "coll_s": st["seconds"],
           "tokens_per_s": prompts.shape[0] * new / t, "launches": launches_of(counters),
           "peak_gb": _peak_gb(dev)}
    if mesh.rank == 0:
        ref = _fam_init(model.cfg, dev)
        with ksplit(ref, MeshShape(MESH_SHAPE)):
            otoks, ologits = _by_data_block(
                lambda p: _timed_generate(ServingEngine(ref, pol, max_len=S + new), p, new)[:2],
                prompts)
        os.environ["REPRO_DECODE_FUSED"] = "0"
        try:
            with single_device_ctx():
                rtoks, rlogits, _, _ = _timed_generate(ServingEngine(ref, pol, max_len=S + new),
                                                       prompts, new)
        finally:
            del os.environ["REPRO_DECODE_FUSED"]
        del ref
        out.update(tokens=torch.equal(toks, otoks), logits=_bitwise(logits, ologits),
                   agreement=_agreement(toks, rtoks, logits, rlogits))
    _free(dev)
    return out


def fam_ssm(mesh, counters, arch) -> dict:
    """13c on this rank for ``arch``: served at FAM_SSM_SERVE's depth (4 x
    64 and its new tokens), then one training step at 4 x 256 at FAM_SSM's
    depth, each against the k-split oracle (rank 0)."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import lm_batch
    dev, cfg = mesh.device, fam_cfg(arch, FAM_SSM_SERVE["n_layers"])
    B, S, new = FAM_SSM_SERVE["batch"], FAM_SSM_SERVE["prompt"], FAM_SSM_SERVE["new"]
    prompts = torch.randint(0, cfg.vocab, (B, S), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    model = _fam_init(cfg, dev, mesh)
    out = {"params_gb": _params_gb(model)}
    out["serve"] = _serve_verdict(mesh, model, _afm16(), dev, prompts, new, counters)
    del model
    _free(dev)
    tcfg = fam_cfg(arch, FAM_SSM[arch]["train_layers"])
    model = _fam_init(tcfg, dev, mesh)
    batch = lm_batch(tcfg, (FAM_SSM_TRAIN["batch"], FAM_SSM_TRAIN["seq"]), 0, dev)
    out["train"] = _step_verdict(mesh, model, batch, _afm16(), dev, counters)
    out["launches"] = {k: n + out["serve"]["launches"][k]
                       for k, n in out["train"]["launches"].items()}
    del model
    _free(dev)
    dist.barrier()
    return out


def fam_whisper(mesh, counters) -> dict:
    """13d on this rank: whisper-base at full width and depth: an encode of
    4 x 1500 frames and FAM_WHISPER_SERVE's greedy tokens, then one training
    step at 4 x 64 over 1500 frames, each against the k-split oracle
    (rank 0; its decoding each data rank's rows in turn)."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.distributed.oracle import ksplit
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.encdec import greedy
    dev, cfg = mesh.device, fam_cfg(FAM_WHISPER)
    B, P, new = FAM_WHISPER_SERVE["batch"], FAM_WHISPER_SERVE["prompt"], FAM_WHISPER_SERVE["new"]
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    frames = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model), generator=g, device=dev)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=g, device=dev)
    model = _fam_init(cfg, dev, mesh)
    pol = _afm16()

    def rows(t):
        return mesh.block(t, mesh.data_axes, 0)

    greedy(model, rows(frames)[:, :64], rows(prompts), 2, pol)           # warm-up
    _reset_peak(dev)
    zero_launches(counters)
    mesh.reset_stats()
    _sync(dev)
    t0 = time.perf_counter()
    enc, toks, logits = greedy(model, rows(frames), rows(prompts), new, pol)
    _sync(dev)
    out = {"s": time.perf_counter() - t0, "collectives": mesh.stats["collectives"],
           "params_gb": _params_gb(model)}
    enc, toks, logits = (mesh.all_gather(t.contiguous(), mesh.data_axes, dim=0)
                         for t in (enc, toks, logits))
    launches = launches_of(counters)
    out["peak_gb"] = _peak_gb(dev)
    if mesh.rank == 0:
        ref = _fam_init(cfg, dev)
        with ksplit(ref, MeshShape(MESH_SHAPE)):
            oenc, otoks, ologits = _by_data_block(
                lambda f, p: greedy(ref, f, p, new, pol), frames, prompts)
        os.environ["REPRO_DECODE_FUSED"] = "0"
        try:
            with single_device_ctx():
                renc, rtoks, rlogits = greedy(ref, frames, prompts, new, pol)
        finally:
            del os.environ["REPRO_DECODE_FUSED"]
        del ref
        out.update(enc=_bitwise(enc, oenc), tokens=torch.equal(toks, otoks),
                   logits=_bitwise(logits, ologits), enc_rel=_rel(enc, renc),
                   agreement=_agreement(toks, rtoks, logits, rlogits))
    _free(dev)
    batch = lm_batch(cfg, (FAM_WHISPER_TRAIN["batch"], FAM_WHISPER_TRAIN["seq"]), 0, dev)
    out["train"] = _step_verdict(mesh, model, batch, pol, dev, counters)
    out["launches"] = {k: n + launches[k] for k, n in out["train"]["launches"].items()}
    del model
    _free(dev)
    dist.barrier()
    return out


def fam_kill_switch(mesh, counters) -> dict:
    """13e on this rank: granite-moe's decode under REPRO_SHARD_FUSED=0 at
    depth 2 (the chain, its MoE launches too, on the gathered weights)
    against the single-device run with the chain on (rank 0)."""
    import torch.distributed as dist
    from repro_torch.serve.engine import ServingEngine
    dev = mesh.device
    cfg = fam_cfg(FAM_MOE, FAM_KILL["n_layers"])
    B, S, new = FAM_KILL["batch"], FAM_KILL["prompt"], FAM_KILL["new"]
    prompts = torch.randint(0, cfg.vocab, (B, S), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    model = _fam_init(cfg, dev, mesh)
    os.environ["REPRO_SHARD_FUSED"] = "0"
    try:
        zero_launches(counters)
        toks, logits, t, _ = _timed_generate(ServingEngine(model, _afm16(), max_len=S + new,
                                                           mesh=mesh), prompts, new, mesh)
        out = {"launches": launches_of(counters), "s": t}
    finally:
        del os.environ["REPRO_SHARD_FUSED"]
    if mesh.rank == 0:
        with single_device_ctx():
            ref = _fam_init(cfg, dev)
            rtoks, rlogits, _, _ = _timed_generate(ServingEngine(ref, _afm16(), max_len=S + new),
                                                   prompts, new)
        out["tokens_bitwise"] = torch.equal(toks, rtoks)
        out["logits_bitwise"] = _bitwise(logits, rlogits)
        del ref
    del model
    _free(dev)
    dist.barrier()
    return out


def families_rank(mesh, done) -> dict:
    """Phase 13 on one rank of the 2x2 mesh: 13a-13e, each one's seconds
    through ``done``."""
    counters = family_counters()
    out = {"13a": fam_stream(mesh, counters)}
    done("13a granite-moe stream, full depth")
    out["13b"] = fam_moe_train(mesh, counters)
    done("13b granite-moe training, depth 4")
    out["13c"] = {arch: fam_ssm(mesh, counters, arch) for arch in FAM_SSM}
    done("13c mamba2 and zamba2")
    out["13d"] = fam_whisper(mesh, counters)
    done("13d whisper-base")
    out["13e"] = fam_kill_switch(mesh, counters)
    done("13e granite-moe kill switch")
    return out


def mesh_rank(mesh, which=("12", "13")) -> dict:
    """Phases 12 and 13 (``which``) on one rank of the 2x2 mesh (and of the
    (4, 1) mesh over the same ranks): 12a-12d, 13a-13e, with each one's
    seconds."""
    from repro_torch.launch.mesh import Mesh
    secs, t0 = {}, time.perf_counter()

    def done(name):
        nonlocal t0
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    out = {}
    if "12" in which:
        counters = mesh_counters()
        dp = Mesh(DP_SHAPE, device=mesh.device, timeout=MESH_TIMEOUT)
        out["contracts"] = mesh_contracts(mesh, dp)
        done("12a contracts at full width")
        out["serve"] = mesh_serving(mesh, counters)
        done("12b serving, full width and depth")
        out["train"] = mesh_training(mesh, dp, counters)
        done("12c training")
        out["kill"] = mesh_kill_switch(mesh, counters)
        done("12d kill switch")
    if "13" in which:
        out["families"] = families_rank(mesh, done)
    out["seconds"] = secs
    out["smi_used"] = smi("memory.used") if mesh.rank == 0 else None
    return out


def mesh_start(smi_line, which=("12", "13")) -> dict:
    """Phases 12 and 13 (``which``) in one spawn, started in a thread of its
    own: four ranks on the one card (``launch.mesh.spawn``, gloo),
    amsim/afm16.  The main run goes on beside it; ``mesh_join`` waits."""
    import threading

    from repro_torch.launch.mesh import spawn
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phases {' and '.join(which)}: {MESH_SHAPE[0] * MESH_SHAPE[1]} ranks on "
          f"{torch.cuda.device_count()} card(s); four ranks sharing one card measure "
          f"correctness, launches, collectives and memory, not a speed-up ({smi_line})")
    job = {"which": which, "t0": time.perf_counter()}

    def run():
        try:
            job["ranks"] = spawn(mesh_rank, MESH_SHAPE, device="cuda", timeout=MESH_TIMEOUT,
                                 args=(which,))
        except BaseException as e:      # noqa: BLE001 - raised again in mesh_join
            job["error"] = e
        job["total"] = time.perf_counter() - job["t0"]
    job["thread"] = threading.Thread(target=run, daemon=True)
    job["thread"].start()
    return job


def mesh_join(job) -> dict:
    """Wait for ``mesh_start``'s spawn; raise its failure.  Returns its
    phases' seconds (the ranks' start and join, then each phase's on rank
    0)."""
    job["thread"].join()
    if "error" in job:
        raise job["error"]
    print(f"phases {' and '.join(job['which'])}: the spawn ended {job['total']:.1f} s after "
          f"its start")
    r0 = job["ranks"][0]
    secs = {f"{'/'.join(job['which'])} ranks started and joined":
            job["total"] - sum(r0["seconds"].values())}
    secs.update(r0["seconds"])
    return secs


def mesh_report(job, smi_line) -> tuple:
    """Returns ({kernel: [launches on each rank]} of phase 12's main path
    (12b's serving, 12c's training), the same of phase 13's (13a-13d's mesh
    runs)), its checks passed and its lines printed."""
    ranks, which = job["ranks"], job["which"]
    return (report_mesh(ranks, smi_line) if "12" in which else {},
            report_families(ranks, smi_line) if "13" in which else {})


def report_mesh(ranks, smi_line) -> dict:
    """Phase 12's checks and lines, from every rank's results; its launches
    a rank."""
    r0 = ranks[0]
    # 12a
    for check in r0["contracts"]:
        verdicts = [r["contracts"][check] for r in ranks]
        require(all(v is True for v in verdicts), f"12a {check}: {verdicts}")
    print(f"12a: {len(r0['contracts'])} contracts hold on every rank, at granite-3-2b's full-width "
          f"shapes (a 4 x 64 prefill on the 2x2 mesh), resnet-mini's 8 convs at batch 64 and a "
          f"2048 x 8192 gradient on the (4, 1) mesh:")
    for check in r0["contracts"]:
        print(f"  {check}")
    # 12b
    s0 = r0["serve"]
    ag = s0["agreement"]
    require(s0["oracle_tokens"] and s0["oracle_logits"] is True,
            f"12b against the k-split oracle: tokens {s0['oracle_tokens']}, logits "
            f"{s0['oracle_logits']}")
    require(s0["wrong_oracle"] is not True, "12b: the wrong variant is bitwise the oracle")
    require(not ag["parted_above_margin"],
            f"12b tokens parted where the top-2 margin exceeds the gap: {ag}")
    for r in ranks:
        for k in ("approx_gemm", "approx_attention"):
            require(r["serve"]["launches"][k] > 0, f"12b rank {r['serve']} never launched {k}")
    print(f"12b: {LM_ARCH} at full width and depth ({s0['params_gb']:.2f} GB of parameters a "
          f"rank, drawn and cut in {s0['draw_s']:.1f} s) on the 2x2 mesh: prefill "
          f"{MESH_SERVE['batch']} x {MESH_SERVE['prompt']} {1e3 * s0['prefill_s']:.1f} ms, "
          f"{s0['step_ms']:.1f} ms a decode step, {s0['tokens_per_s']:.2f} tokens/s "
          f"({MESH_SERVE['new']} new; the single-device per-op run {s0['single_s']:.2f} s); "
          f"collectives: {s0['coll_prefill']} a prefill, {s0['coll_step']:.1f} a step, "
          f"{s0['coll_step_share']:.3f} of a step's wall (rank 0, host clock; {smi_line})")
    print(f"  logits and tokens bitwise the k-split oracle (distributed.oracle.ksplit: the "
          f"single-device per-op run with the row sums split as the mesh splits them; a row sum "
          f"missing one shard is not: {s0['wrong_oracle']}); against the unsplit per-op run "
          f"(a reading: the split sums alone) rel {ag['rel']:.3g}, the wrong variant "
          f"{s0['wrong_rel']:.3g}, largest |d| {ag['gap']:.3g}; tokens equal at {ag['equal']} "
          f"of {ag['positions']}, first parting at step {ag['first_parting']} of "
          f"{MESH_SERVE['new']}, none where the top-2 margin exceeds the gap (smallest margin "
          f"{ag['min_margin']:.3g})")
    print("  peak memory a rank (torch.cuda.max_memory_allocated): "
          + ", ".join(f"rank {i} {r['serve']['peak_gb']:.2f} GB" for i, r in enumerate(ranks))
          + f"; rank 0's single-device run {s0['single_peak_gb']:.2f} GB; nvidia-smi memory.used "
          f"{r0['smi_used']} at the end of the phase")
    # 12c
    t = r0["train"]
    lm1 = t["lm_step1"]
    require(lm1["loss_bitwise"] is True and not lm1["differ"],
            f"12c step 1 against the k-split oracle: loss {lm1['loss_bitwise']}, leaves that "
            f"differ {lm1['differ'][:8]}")
    require(len(lm1["wrong_equal"]) < lm1["leaves"], "12c: the wrong variant is the oracle's")
    require(all(math.isfinite(v) for r in ranks for v in r["train"]["lm"]["losses"]),
            "12c losses not finite")
    v1 = t["vision_step1"]
    require(v1["loss_rel"] <= MESH_VISION_RTOL and v1["worst_param_rel"] <= MESH_VISION_RTOL,
            f"12c resnet-mini step 1 against the single-device step: {v1}")
    print(f"12c: {LM_ARCH} at full width, depth {MESH_TRAIN['n_layers']}, 2x2 mesh, adamw "
          f"{MESH_TRAIN['batch']} x {MESH_TRAIN['seq']}, clip 1.0: step-1 loss {lm1['loss']:.6f} "
          f"and all {lm1['leaves']} gradient leaves bitwise the k-split oracle "
          f"(distributed.oracle.ksplit_loss_and_grads; a row sum missing one shard leaves "
          f"{len(lm1['wrong_equal'])} of them equal); against the unsplit step (a reading: the "
          f"split sums alone) loss {lm1['ref_loss']:.6f} (rel {lm1['loss_rel']:.3g}), worst leaf "
          f"rel {lm1['worst_grad_rel'][0]:.3g} ({lm1['worst_grad_rel'][1]}), the wrong variant's "
          f"{lm1['wrong_worst_rel'][0]:.3g} ({lm1['wrong_worst_rel'][1]}); ms a step "
          + ", ".join(f"{m:.1f}" for m in t["lm"]["ms"])
          + f"; losses {[round(v, 5) for v in t['lm']['losses']]}; {t['lm']['collectives']:.0f} "
          f"collectives a step, {t['lm']['coll_share']:.3f} of its wall; peak a rank "
          + ", ".join(f"{r['train']['lm']['peak_gb']:.2f}" for r in ranks) + " GB")
    print(f"  resnet-mini data-parallel on the (4, 1) mesh, 2 sgdm steps at batch {BATCH}: losses "
          f"{[round(v, 5) for v in t['vision']['losses']]}, ms a step "
          + ", ".join(f"{m:.1f}" for m in t["vision"]["ms"])
          + f"; step 1 against the single-device step: loss rel {v1['loss_rel']:.3g}, worst "
          f"parameter rel {v1['worst_param_rel']:.3g} (tolerance {MESH_VISION_RTOL})")
    # 12d
    k0 = r0["kill"]
    require(k0["tokens_bitwise"] and k0["logits_bitwise"] is True,
            f"12d REPRO_SHARD_FUSED=0 against the single-device chain run: {k0}")
    for r in ranks:
        require(r["kill"]["launches"]["fused_qkv_norm"] > 0, "12d: the chain never launched")
    print(f"12d: REPRO_SHARD_FUSED=0 at depth {MESH_KILL['n_layers']}, {MESH_SERVE['batch']} x "
          f"{MESH_SERVE['prompt']} and {MESH_KILL['new']} new: the replicated dispatch's logits "
          f"and tokens bitwise the single-device run's (chain on); {k0['s']:.2f} s; launches on "
          f"rank 0 {k0['launches']}")
    launches = {k: [r["serve"]["launches"].get(k, 0) + r["train"]["lm_launches"].get(k, 0)
                    + r["train"]["vision_launches"].get(k, 0) for r in ranks]
                for k in MESH_KERNELS}
    for k, per_rank in launches.items():
        require(all(n > 0 for n in per_rank), f"phase 12: {k} never launched on a rank: {per_rank}")
    print(f"launches on the mesh's path (12b serving, 12c training), per rank: {launches}")
    return launches


def _step_line(v) -> str:
    wrong = ("" if "wrong_equal" not in v else
             f" (a row sum missing one shard leaves {len(v['wrong_equal'])} of them equal)")
    return (f"step-1 loss {v['loss']:.6f} and all {v['leaves']} gradient leaves bitwise the "
            f"k-split oracle{wrong}; against the unsplit step (a reading) loss rel "
            f"{v['loss_rel']:.3g}, worst leaf rel {v['worst_grad_rel'][0]:.3g} "
            f"({v['worst_grad_rel'][1]})" + ("" if "wrong_equal" not in v else
                                              f", the wrong variant's "
                                              f"{v['wrong_worst_rel'][0]:.3g}"))


def _require_step(v, what):
    require(v["loss_bitwise"] is True and not v["differ"],
            f"{what} step 1 against the k-split oracle: loss {v['loss_bitwise']}, leaves that "
            f"differ {v['differ'][:8]}")
    if "wrong_equal" in v:
        require(len(v["wrong_equal"]) < v["leaves"], f"{what}: the wrong variant is the oracle's")


def report_stream(ranks, smi_line) -> None:
    """13a's checks and lines, from every rank's results."""
    a = ranks[0]["families"]["13a"]
    for name in ("afm16", "native"):
        require(a[name]["oracle"] is True,
                f"13a {name} against the k-split oracle's stream: {a[name]['oracle']}")
    require(a["pool_specs"] == (None, None, "model", None), f"13a pools {a['pool_specs']}")
    print(f"13a: {FAM_MOE} at full width and depth ({a['params_gb']:.2f} GB of parameters a "
          f"rank, drawn in {a['draw_s']:.1f} s) through ContinuousBatchingEngine(mesh=) on the "
          f"2x2 mesh: {len(a['requests'])} requests (prompt, new) {a['requests']}, capacity "
          f"{FAM_STREAM['capacity']} (two slots a data rank), pages of {FAM_STREAM['page']}, KV "
          f"heads over \"model\" (pools {a['pool_specs']}): {a['tokens']} tokens in "
          f"{a['wall_s']:.2f} s, {a['tokens_per_s']:.2f} tokens/s, {a['ticks']} decode ticks "
          f"({a['tick_ms']:.1f} ms a tick), {a['admissions']} admissions ({a['prefill_ms']:.1f} "
          f"ms a B = 1 prefill), {a['collectives']} collectives "
          f"({a['collectives'] / max(a['ticks'], 1):.1f} a tick, admissions included; "
          f"{a['coll_s']:.2f} s of the wall, host clock), {a['preemptions']} preemptions, "
          f"pages high-water {a['pages_high']}; peak a rank "
          + ", ".join(f"{r['families']['13a']['peak_gb']:.2f}" for r in ranks)
          + f" GB (rank 0; {smi_line})")
    for name in ("afm16", "native"):
        eq, n, gap, rel = a[name]["gap"]
        print(f"  {name}: tokens and every forward's logits bitwise the k-split oracle's stream "
              f"(each data rank's slots in turn, the banks in the mesh's blocks of experts; its "
              f"single-device run {a[name]['oracle_s']:.2f} s); against the unsplit "
              f"single-device stream (a reading) tokens equal at {eq} of {n}, logits largest "
              f"|d| {gap:.3g}, rel {rel:.3g}"
              + (f" (the mesh's stream {a['native_s']:.2f} s)" if name == "native" else ""))
    w = a["witness"]
    print(f"  native at the mesh's shapes of a call, against the unsplit call (why the oracle "
          f"makes the mesh's calls): layer 0's banks at C = 8, one call of "
          f"{fam_cfg(FAM_MOE).moe.n_experts} experts against one a \"model\" block: bitwise "
          f"{w['banks']}; the head on 4 rows against 2 + 2: bitwise {w['head']}")


def report_families(ranks, smi_line) -> dict:
    """Phase 13's checks and lines, from every rank's results; its launches
    a rank (13a-13d's mesh runs; 13e's kill switch apart)."""
    f0 = ranks[0]["families"]
    report_stream(ranks, smi_line)
    # 13b
    b = f0["13b"]
    _require_step(b, "13b")
    require(all(math.isfinite(v) for r in ranks for v in r["families"]["13b"]["losses"]),
            "13b losses not finite")
    print(f"13b: {FAM_MOE} at full width, depth {FAM_MOE_TRAIN['n_layers']}, 2x2 mesh, adamw "
          f"{FAM_MOE_TRAIN['batch']} x {FAM_MOE_TRAIN['seq']}: " + _step_line(b)
          + f"; the aux loss (the whole batch's routing) {b['metrics']['aux']:.6f}; ms a step "
          + ", ".join(f"{m:.1f}" for m in b["ms"]) + f"; losses "
          f"{[round(v, 5) for v in b['losses']]}; {b['collectives']:.0f} collectives a step, "
          f"{b['coll_share']:.3f} of its wall; {b['params_gb']:.2f} GB of parameters a rank, "
          f"peak " + ", ".join(f"{r['families']['13b']['peak_gb']:.2f}" for r in ranks) + " GB")
    # 13c
    for arch, c in f0["13c"].items():
        sv, tr = c["serve"], c["train"]
        require(sv["tokens"] and sv["logits"] is True,
                f"13c {arch} serving against the k-split oracle: {sv['tokens']}, {sv['logits']}")
        _require_step(tr, f"13c {arch}")
        ag = sv["agreement"]
        print(f"13c: {arch} served at full width, depth {FAM_SSM_SERVE['n_layers']} "
              f"({c['params_gb']:.2f} GB a rank) "
              f"{FAM_SSM_SERVE['batch']} x {FAM_SSM_SERVE['prompt']} and "
              f"{FAM_SSM_SERVE['new']} new in {sv['s']:.2f} s ({sv['tokens_per_s']:.2f} "
              f"tokens/s, {sv['collectives']} collectives, {sv['coll_s']:.2f} s of them; peak "
              f"{sv['peak_gb']:.2f} GB): tokens and logits bitwise the k-split oracle; against "
              f"the unsplit per-op run rel {ag['rel']:.3g}, tokens equal at {ag['equal']} of "
              f"{ag['positions']}")
        print(f"  trained at depth {FAM_SSM[arch]['train_layers']}, {FAM_SSM_TRAIN['batch']} x "
              f"{FAM_SSM_TRAIN['seq']}: " + _step_line(tr) + f"; the step {tr['step_s']:.2f} s "
              f"a rank, peak {tr['peak_gb']:.2f} GB")
    # 13d
    d = f0["13d"]
    require(d["enc"] is True and d["tokens"] and d["logits"] is True,
            f"13d against the k-split oracle: encode {d['enc']}, tokens {d['tokens']}, logits "
            f"{d['logits']}")
    _require_step(d["train"], "13d")
    ag = d["agreement"]
    print(f"13d: {FAM_WHISPER} at full width and depth ({d['params_gb']:.3f} GB a rank): an "
          f"encode of {FAM_WHISPER_SERVE['batch']} x 1500 frames and {FAM_WHISPER_SERVE['new']} "
          f"greedy tokens in {d['s']:.2f} s ({d['collectives']} collectives; peak "
          f"{d['peak_gb']:.2f} GB): encoder states, tokens and logits bitwise the k-split "
          f"oracle; against the unsplit per-op run encoder states rel {d['enc_rel']:.3g}, "
          f"logits rel {ag['rel']:.3g}, tokens equal at {ag['equal']} of {ag['positions']}")
    print(f"  one training step at {FAM_WHISPER_TRAIN['batch']} x {FAM_WHISPER_TRAIN['seq']} "
          f"over 1500 frames: " + _step_line(d["train"])
          + f"; {d['train']['step_s']:.2f} s a rank")
    # 13e
    e = f0["13e"]
    require(e["tokens_bitwise"] and e["logits_bitwise"] is True,
            f"13e REPRO_SHARD_FUSED=0 against the single-device chain run: {e}")
    for r in ranks:
        for k in ("fused_qkv_norm", "fused_wo_norm", "fused_moe_ffn"):
            require(r["families"]["13e"]["launches"][k] > 0, f"13e: {k} never launched")
    print(f"13e: {FAM_MOE} under REPRO_SHARD_FUSED=0 at depth {FAM_KILL['n_layers']}, "
          f"{FAM_KILL['batch']} x {FAM_KILL['prompt']} and {FAM_KILL['new']} new: the chain on "
          f"the gathered weights and banks, logits and tokens bitwise the single-device chain "
          f"run; {e['s']:.2f} s; launches on rank 0 {e['launches']}")
    launches = {}
    for k in family_counters():
        per_rank = []
        for r in ranks:
            f = r["families"]
            per_rank.append(f["13a"]["launches"].get(k, 0) + f["13b"]["launches"].get(k, 0)
                            + sum(c["launches"].get(k, 0) for c in f["13c"].values())
                            + f["13d"]["launches"].get(k, 0))
        launches[k] = per_rank
    for k in FAM_KERNELS:
        require(all(n > 0 for n in launches[k]),
                f"phase 13: {k} never launched on a rank: {launches[k]}")
    print(f"launches on the families' mesh path (13a-13d), per rank: {launches}")
    return launches


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # "--phase 5e,8,12" (any of 5e, 7, 8, 9, 10, 11, 12, 13): phases 1, 2 and
    # those alone, in that order (12 and 13 in one spawn), without the result
    # lines.
    phases = ("5e", "7", "8", "9", "10", "11", "12", "13")
    only = argv[1].split(",") if len(argv) == 2 and argv[0] == "--phase" else None
    if argv and (only is None or not set(only) <= set(phases)):
        print(f"chip_smoke: unknown arguments {argv} (none, or --phase and a comma-separated "
              f"list of {', '.join(phases)})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.paper_models import VISION_REGISTRY
    from repro_torch.core import faults
    from repro_torch.core.lutgen import get_lut, get_packed_lut
    from repro_torch.core.multipliers import get_multiplier
    from repro_torch.core.policy import NumericsPolicy
    from repro_torch.data.pipeline import vision_batches, vision_dataset
    from repro_torch.kernels import _build, approx_conv, ops
    from repro_torch.kernels.approx_conv import (approx_conv2d_dw, approx_conv2d_dw_plain,
                                                 approx_conv2d_fused, approx_conv2d_plain,
                                                 conv_out_shape, conv_pads)
    from repro_torch.kernels.approx_gemm import approx_gemm, approx_gemm_plain
    from repro_torch.kernels.common import lut_bytes, lut_in_smem, lut_tensor
    from repro_torch.models.vision import init_vision, vision_forward, vision_loss
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.convergence import build_policies, train_one
    from repro_torch.train.step import make_train_step

    dev = torch.device(DEVICE)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(name, seconds=None):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase if seconds is None else seconds
        t_phase = now

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def lut_case(lut_name, packed):
        name, _, spec = lut_name.partition("|")
        M = get_multiplier(name).mantissa_bits
        table = get_packed_lut(name) if packed else get_lut(name)
        if spec:
            table = faults.apply_faults(table, M, faults.parse_spec(spec), packed=packed,
                                        mult=get_multiplier(name).name)
        return lut_tensor(table, dev), M

    # ---------------------------------------------------------- 1. card
    name = torch.cuda.get_device_name(0)
    smi_line = smi("name,power.limit")
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"device: {name} (count {torch.cuda.device_count()}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi_line}; max SM clock {sm_mhz:.0f} MHz")
    lookups_per_s = torch.cuda.get_device_properties(0).multi_processor_count \
        * LOOKUPS_PER_SM_PER_CLOCK * sm_mhz * 1e6
    phase_done("1 card")

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing (cached)'}")
    for lib, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib}: {line.strip()}")
    phase_done("2 build")
    for phase in only or ():
        if phase == "5e":
            lm_training(dev, lookups_per_s, smi_line)
            phase_done("5e LM training")
        if phase == "7":
            continuous_batching(dev, gen, lut_case, lookups_per_s, smi_line, phase_done)
        if phase == "8":
            ssm_families(dev, lut_case, lookups_per_s, smi_line, phase_done)
        if phase == "9":
            encoder_decoder(dev, gen, lut_case, lookups_per_s, smi_line, phase_done)
        if phase == "10":
            dense_zoo(dev, gen, lut_case, lookups_per_s, smi_line, phase_done)
        if phase == "11":
            llama4(dev, lut_case, lookups_per_s, smi_line, phase_done)
        if phase == "12" or (phase == "13" and "12" not in only):
            job = mesh_start(smi_line, tuple(p for p in ("12", "13") if p in only))
            for k, v in mesh_join(job).items():
                phase_done(k, v)
            mesh_report(job, smi_line)
    if only:
        print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
        return 0

    # ------------------------------------- 3. kernels vs plain on the card
    max_err = {"approx_gemm": 0.0, "approx_conv2d_fused": 0.0, "approx_conv2d_dw": 0.0}
    for lut_name, packed in LUT_CASES:
        lut, M = lut_case(lut_name, packed)
        where = "shared" if lut_in_smem(lut) else "global"
        for m, k, n in GEMM_SHAPES:
            a, b = randn(m, k), randn(k, n)
            out, ref = approx_gemm(a, b, lut, M), approx_gemm_plain(a, b, lut, M)
            err = (out - ref).abs().max().item()
            require(torch.equal(out, ref), f"approx_gemm {lut_name} packed={packed} "
                    f"({m},{k},{n}): max|d|={err}")
            max_err["approx_gemm"] = max(max_err["approx_gemm"], err)
        for xs, ws, stride in CONV_SHAPES:
            x, w = randn(*xs), randn(*ws)
            pads = conv_pads(xs[1], xs[2], ws[0], ws[1], stride, "SAME")
            out = approx_conv2d_fused(x, w, lut, M, stride=stride, padding="SAME")
            ref = approx_conv2d_plain(x, w, lut, M, stride, pads)
            err = (out - ref).abs().max().item()
            require(torch.equal(out, ref), f"approx_conv2d_fused {lut_name} packed={packed} "
                    f"{xs}x{ws}/s{stride}: max|d|={err}")
            max_err["approx_conv2d_fused"] = max(max_err["approx_conv2d_fused"], err)
        print(f"kernels == plain (bitwise): {lut_name} M={M} "
              f"{'packed' if packed else 'canonical'} LUT ({lut_bytes(lut)} B, {where} memory): "
              f"{len(GEMM_SHAPES)} GEMM + {len(CONV_SHAPES)} conv shapes")
    phase_done("3 forward kernels vs plain")

    # ------------------- 3b/3c. the gradient kernels vs plain on the card
    for lut_name, packed in LUT_CASES:
        lut, M = lut_case(lut_name, packed)
        batch = BATCH if (lut_name, packed) in FULL_BATCH_LUTS else SMALL_BATCH
        for xs, ws, stride in CONV_SHAPES:
            xs = (batch, *xs[1:])
            kh, kw, _, o = ws
            pads = conv_pads(xs[1], xs[2], kh, kw, stride, "SAME")
            oh, ow = conv_out_shape(xs[1], xs[2], kh, kw, stride, pads)
            x, g = randn(*xs), randn(batch, oh, ow, o)
            out = approx_conv2d_dw(x, g, lut, M, kh=kh, kw=kw, stride=stride, padding="SAME")
            ref = approx_conv2d_dw_plain(x, g, lut, M, kh, kw, stride, pads)
            err = (out - ref).abs().max().item()
            require(torch.equal(out, ref), f"approx_conv2d_dw {lut_name} packed={packed} "
                    f"{xs}x{ws}/s{stride}: max|d|={err}")
            max_err["approx_conv2d_dw"] = max(max_err["approx_conv2d_dw"], err)
            out, ref, dpads = conv_dx_pair(g, randn(*ws), xs, stride, pads, lut, M)
            err = (out - ref).abs().max().item()
            require(out.shape == xs and torch.equal(out, ref),
                    f"approx_conv2d_fused at the dx shape of {xs}x{ws}/s{stride} ({lut_name} "
                    f"packed={packed}, error {tuple(g.shape)} dilated by {stride}, pads "
                    f"{dpads}): max|d|={err}")
            max_err["approx_conv2d_fused"] = max(max_err["approx_conv2d_fused"], err)
        print(f"gradient kernels == plain (bitwise): {lut_name} "
              f"{'packed' if packed else 'canonical'}, batch {batch}: dw kernel and the conv "
              f"kernel at the dx shape of {len(CONV_SHAPES)} convs (the error undilated, "
              f"input_dilation = stride)")
        # Each shape's plans (the batch does not enter them) on special values.
        for xs, ws, stride in CONV_SHAPES:
            kh, kw, _, o = ws
            plan, grid = dw_plan_of(ws, lut)
            pads = conv_pads(xs[1], xs[2], kh, kw, stride, "SAME")
            oh, ow = conv_out_shape(xs[1], xs[2], kh, kw, stride, pads)
            if (lut_name, packed) in FULL_BATCH_LUTS:
                print(f"  dw {xs}x{ws}/s{stride}: {plan}; grid {grid}")
                for pass_, shape in conv_launch_shapes(xs, ws, stride, pads).items():
                    cplan, cgrid = conv_plan_of(shape, lut)
                    print(f"  conv {pass_} {xs}x{ws}/s{stride}: {cplan}; grid {cgrid}")
            xs = (SMALL_BATCH, *xs[1:])
            x, g = special_values(xs, gen, dev), special_values((xs[0], oh, ow, o), gen, dev)
            out = approx_conv2d_dw(x, g, lut, M, kh=kh, kw=kw, stride=stride, padding="SAME")
            ref = approx_conv2d_dw_plain(x, g, lut, M, kh, kw, stride, pads)
            require(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
                    f"approx_conv2d_dw {lut_name} packed={packed} {xs}x{ws}/s{stride} on special "
                    f"values, plan {plan}: the bits differ")
            w = special_values(ws, gen, dev)
            out = approx_conv2d_fused(x, w, lut, M, stride=stride, padding="SAME")
            ref = approx_conv2d_plain(x, w, lut, M, stride, pads)
            require(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
                    f"approx_conv2d_fused {lut_name} packed={packed} {xs}x{ws}/s{stride} on "
                    f"special values: the bits differ")
            out, ref, _ = conv_dx_pair(g, w, xs, stride, pads, lut, M)
            require(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
                    f"approx_conv2d_fused at the dx shape of {xs}x{ws}/s{stride} ({lut_name} "
                    f"packed={packed}) on special values: the bits differ")
        print(f"  dw and conv kernels (forward and dx) == plain (bit for bit) on x, w and g "
              f"with zeros, -0.0, subnormals, inf and NaN, batch {SMALL_BATCH}")
    phase_done("3b/3c gradient kernels vs plain")

    # ------------------------------ 3d. serving kernels vs plain on the card
    serve_err = serving_kernel_checks(dev, gen, lut_case)
    max_err["approx_gemm"] = max(max_err["approx_gemm"], serve_err.pop("approx_gemm"))
    phase_done("3d serving kernels vs plain")
    moe_err = moe_kernel_checks(dev, gen, lut_case)
    max_err["approx_gemm"] = max(max_err["approx_gemm"], moe_err.pop("approx_gemm"))
    phase_done("3e MoE serving kernels vs plain")

    # ----------------------------------------------------- 4. main path
    amsim = NumericsPolicy(mode="amsim", multiplier="afm16")
    plain = NumericsPolicy(mode="amsim_torch", multiplier="afm16")
    native = NumericsPolicy()
    want = {"resnet-mini": (15, 1), "lenet-5": (2, 3), "lenet-300-100": (0, 3)}
    runs, datasets = {}, {}
    counters = {"approx_conv2d_fused": approx_conv2d_fused, "approx_conv2d_dw": approx_conv2d_dw,
                "approx_gemm": approx_gemm}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return tuple(fn.launches for fn in counters.values())

    for model_name, (n_conv, n_gemm) in want.items():
        cfg = VISION_REGISTRY[model_name]
        model = init_vision(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
        data = vision_dataset(cfg.name, BATCH * N_BATCHES, 0, cfg.input_hw, cfg.input_ch,
                              cfg.n_classes, seed=SEED)
        datasets[model_name] = data
        xs = [torch.from_numpy(bt["x"]).to(dev) for bt in vision_batches(data, BATCH, 0)]
        zero_counts()
        logits = [vision_forward(model, x, amsim) for x in xs]
        torch.cuda.synchronize()
        launches = read_counts()
        require(launches == (n_conv * len(xs), 0, n_gemm * len(xs)),
                f"{model_name}: launches (conv, dw, gemm) = {launches}, want "
                f"{(n_conv * len(xs), 0, n_gemm * len(xs))}")
        for x, out in zip(xs, logits):
            require(out.shape == (BATCH, cfg.n_classes) and bool(torch.isfinite(out).all()),
                    f"{model_name}: logits {tuple(out.shape)} not finite")
            ref = vision_forward(model, x, plain)
            require(torch.equal(out, ref), f"{model_name}: amsim logits differ from amsim_torch "
                    f"by {(out - ref).abs().max().item()}")
        agree = torch.cat([(vision_forward(model, x, native).argmax(-1) == out.argmax(-1))
                           for x, out in zip(xs, logits)]).float().mean().item()
        print(f"{model_name}: {len(xs)} batches of {BATCH}, launches conv {launches[0]} gemm "
              f"{launches[2]}, logits finite and bitwise equal to amsim_torch; argmax agrees "
              f"with native on {agree:.3f} of images")
        runs[model_name] = (model, xs[0])
    phase_done("4 inference")

    # ------------------------------------------------- 4b. training path
    def train_batches(model_name):
        return [{"x": torch.from_numpy(bt["x"]).to(dev), "y": torch.from_numpy(bt["y"]).to(dev)}
                for bt in vision_batches(datasets[model_name], BATCH, 0)]

    def fresh(model_name, policy):
        """A model from the seed-0 weights, its sgdm state and its step."""
        cfg = VISION_REGISTRY[model_name]
        model = init_vision(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
        opt = make_optimizer("sgdm", 0.05)
        step = make_train_step(lambda m, b: vision_loss(m, b, policy), opt, clip_norm=1.0)
        return model, opt.init(dict(model.named_parameters())), step

    main_launches = {}
    for model_name, per_step in TRAIN_LAUNCHES.items():
        batches = train_batches(model_name)[:TRAIN_STEPS]
        model, state, step = fresh(model_name, amsim)
        losses, step1 = [], None
        torch.use_deterministic_algorithms(True)
        try:
            zero_counts()
            for i, b in enumerate(batches):
                before = read_counts()
                state, metrics = step(model, state, b)
                torch.cuda.synchronize()
                got = tuple(a - c for a, c in zip(read_counts(), before))
                require(got == per_step, f"{model_name} train step {i + 1}: launches (conv fwd+dx, "
                        f"dw, gemm) = {got}, want {per_step}")
                losses.append(metrics["loss"])
                if i == 0:
                    step1 = (metrics["loss"].clone(),
                             [p.detach().clone() for p in model.parameters()])
            total = read_counts()
            ref_model, ref_state, ref_step = fresh(model_name, plain)
            _, ref_metrics = ref_step(ref_model, ref_state, batches[0])
            torch.cuda.synchronize()
        except RuntimeError as e:
            if "deterministic" in str(e):
                raise SystemExit(f"chip_smoke FAILED: {model_name}: an op of the training step "
                                 f"has no deterministic CUDA implementation: {e}")
            raise
        finally:
            torch.use_deterministic_algorithms(False)
        require(all(bool(torch.isfinite(v)) for v in losses), f"{model_name}: loss not finite")
        require(torch.equal(step1[0], ref_metrics["loss"]),
                f"{model_name}: step-1 loss under amsim {step1[0].item()} differs from "
                f"amsim_torch {ref_metrics['loss'].item()}")
        for (pname, p_ref), p in zip(ref_model.named_parameters(), step1[1]):
            require(torch.equal(p, p_ref), f"{model_name}: parameter {pname} after step 1 "
                    f"differs from amsim_torch by {(p - p_ref).abs().max().item()}")
        if not main_launches:
            main_launches = dict(zip(counters, total))
        print(f"{model_name} training: {TRAIN_STEPS} steps of {BATCH}, launches per step (conv "
              f"fwd+dx, dw, gemm) {per_step}, losses "
              f"{' '.join(f'{float(v):.4f}' for v in losses)}; step 1 loss and parameters "
              f"bitwise equal to amsim_torch")
    phase_done("4b training step")

    cfg = VISION_REGISTRY["lenet-300-100"]
    conv_data = vision_dataset(cfg.name, 512, 512, cfg.input_hw, cfg.input_ch, cfg.n_classes,
                               seed=SEED)
    accs = {}
    for pname, pol in build_policies("amsim").items():
        curve, acc, _, losses = train_one(cfg, pol, conv_data, epochs=1, device=dev)
        half = len(losses) // 2
        require(sum(losses[half:]) / (len(losses) - half) < sum(losses[:half]) / half,
                f"lenet-300-100 {pname}: loss did not fall: {losses}")
        accs[pname] = acc
        print(f"  lenet-300-100 {pname:6s} ({pol.mode}): loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} over {len(losses)} steps, train acc {curve[0]:.3f}, test acc "
              f"{acc:.4f}")
    print(f"  Table III deltas (1 epoch of 512): AFM32 - FP32 {accs['afm32'] - accs['fp32']:+.4f}, "
          f"AFM16 - bfloat16 {accs['afm16'] - accs['bf16']:+.4f}")
    phase_done("4b convergence (lenet-300-100, 4 multipliers)")

    # ------------------------------------- 4c. LM serving at depth 2
    serve_launches = {}
    serving_depth2(dev, serve_launches)
    phase_done("4c serving, depth 2")
    moe_launches = {}
    moe_serving_depth2(dev, moe_launches)
    phase_done("4d MoE serving, depth 2")

    # ------------------------------------------------------ 5. timings
    print(f"per-forward times at batch {BATCH} (CUDA events, after warm-up; device busy "
          f"from torch.profiler; {smi_line}):")
    for model_name, (model, x) in runs.items():
        t_nat = cuda_ms(lambda: vision_forward(model, x, native), reps=50, warmup=3)
        t_am = cuda_ms(lambda: vision_forward(model, x, amsim), reps=20, warmup=2)
        t_pl = cuda_ms(lambda: vision_forward(model, x, plain), reps=2)
        busy_nat = busy_ms(lambda: vision_forward(model, x, native), reps=10)
        busy_am = busy_ms(lambda: vision_forward(model, x, amsim), reps=10)
        print(f"  {model_name}: native {t_nat:.4f} ms ({busy_text(busy_nat, t_nat)}), amsim "
              f"{t_am:.4f} ms ({busy_text(busy_am, t_am)}), amsim_torch {t_pl:.2f} ms; "
              f"amsim/native = {t_am / t_nat:.2f}x (the paper's yardstick: native only 8x "
              f"faster than AMSim)")
    phase_done("5 forward timings")

    # --------------------------------------------------- 5b. step timings
    print(f"per-training-step times at batch {BATCH} (sgdm, clip 1.0; CUDA events after "
          f"warm-up; device busy from torch.profiler; {smi_line}):")
    for model_name in TRAIN_LAUNCHES:
        b = train_batches(model_name)[0]
        times = {}
        for pname, pol in (("native", native), ("amsim", amsim)):
            model, state, step = fresh(model_name, pol)
            box = [state]

            def one():
                box[0], _ = step(model, box[0], b)

            wall = cuda_ms(one, reps=10, warmup=2)
            busy = busy_ms(one, reps=5)
            times[pname] = (wall, busy)
        (t_nat, b_nat), (t_am, b_am) = times["native"], times["amsim"]
        by_device = (f", {b_am / b_nat:.2f}x by device time"
                     if b_nat is not None and b_am is not None else "")
        print(f"  {model_name}: native (TFnG) {t_nat:.4f} ms ({busy_text(b_nat, t_nat)}), amsim "
              f"(ATxG) {t_am:.4f} ms ({busy_text(b_am, t_am)}); amsim/native = "
              f"{t_am / t_nat:.2f}x by wall{by_device}")

    # Each kernel at the shapes of one resnet-mini training step: capture its calls.
    calls = {k: [] for k in counters}
    dx_stride = [0]   # the forward stride while the data gradient runs, else 0
    originals = {"approx_gemm": ops.approx_gemm, "approx_conv2d_fused": ops.approx_conv2d_fused,
                 "approx_conv2d_dw": ops.approx_conv2d_dw, "_conv_dx": ops._conv_dx}

    def capture(kname):
        def wrapped(*a, **kw):
            calls[kname].append((a, kw, dx_stride[0]))
            return originals[kname](*a, **kw)
        return wrapped

    def conv_dx(*a, **kw):
        dx_stride[0] = a[3]
        try:
            return originals["_conv_dx"](*a, **kw)
        finally:
            dx_stride[0] = 0

    for kname in counters:
        setattr(ops, kname, capture(kname))
    ops._conv_dx = conv_dx
    try:
        model, state, step = fresh("resnet-mini", amsim)
        step(model, state, train_batches("resnet-mini")[0])
        torch.cuda.synchronize()
    finally:
        for kname, fn in originals.items():
            setattr(ops, kname, fn)

    def gemm_cost(a, b, lut, M):
        m, k = a.shape
        n = b.shape[1]
        nbytes = 4 * (m * k + k * n + m * n) + lut_bytes(lut)
        return nbytes, m * k * n, m * k * n, lambda: approx_gemm_plain(a, b, lut, M), 0

    def conv_call_shape(x, w, lut=None, M=None, stride=1, padding="SAME", input_dilation=1):
        """The ``approx_conv.ConvShape`` of a call of approx_conv2d_fused."""
        d = input_dilation
        hd, wd = ((s - 1) * d + 1 for s in x.shape[1:3])
        pads = conv_pads(hd, wd, w.shape[0], w.shape[1], stride, padding)
        return approx_conv.conv_shape(x.shape, w.shape, stride, pads, d), pads

    def conv_cost(x, w, lut, M, stride=1, padding="SAME", input_dilation=1):
        """Bytes, lookups the kernel makes on values of its input (with an
        input dilation d, on the taps of the dilated input that it visits:
        its real values only, none of the inserted zeros), lookups on real
        values, the plain version, and the products the kernel makes on
        padding taps, which it stages as +0.0."""
        shape, pads = conv_call_shape(x, w, stride=stride, padding=padding,
                                      input_dilation=input_dilation)
        n, c, o, d = shape.n, shape.c, shape.o, shape.dilation
        hd, wd = (shape.h - 1) * d + 1, (shape.w - 1) * d + 1
        visited = sum(n * ay.q_n * ax.q_n * ay.t_n * ax.t_n * c * o
                      for _, _, ay, ax in approx_conv.conv_classes(shape))
        real = n * o * c * taps(shape.oh, hd, shape.kh, stride, pads[0], d) \
            * taps(shape.ow, wd, shape.kw, stride, pads[2], d)
        made = real    # a visited tap lands on a real value or in the padding
        nbytes = 4 * (x.numel() + w.numel() + n * shape.oh * shape.ow * o) + lut_bytes(lut)
        return (nbytes, made, real,
                lambda: approx_conv2d_plain(x, w, lut, M, stride, pads, d), visited - made)

    def dw_cost(x, g, lut, M, kh, kw, stride=1, padding="SAME"):
        n, h, wid, c = x.shape
        _, oh, ow, o = g.shape
        pads = conv_pads(h, wid, kh, kw, stride, padding)
        lookups = n * c * o * taps(oh, h, kh, stride, pads[0]) * taps(ow, wid, kw, stride, pads[2])
        nbytes = 4 * (x.numel() + g.numel() + kh * kw * c * o) + lut_bytes(lut)
        return nbytes, lookups, lookups, lambda: approx_conv2d_dw_plain(x, g, lut, M, kh, kw,
                                                                        stride, pads), 0

    rows_out = []
    # (source, TPU kernel it replaces, wrapper, cost model)
    sources = {
        "approx_gemm": ("approx_gemm.cu", "src/repro/kernels/approx_gemm.py:57",
                        originals["approx_gemm"], gemm_cost),
        "approx_conv2d_fused": ("approx_conv.cu", "src/repro/kernels/approx_conv.py:105",
                                originals["approx_conv2d_fused"], conv_cost),
        "approx_conv2d_dw": ("approx_conv_dw.cu", "src/repro/kernels/approx_conv.py:225",
                             originals["approx_conv2d_dw"], dw_cost),
    }
    print("kernels at the shapes of one resnet-mini training step, from CUDA events: device "
          "time with the calls queued behind a spin kernel (a wrapper enqueues its one kernel "
          "and nothing else), and wrapper call time (host launch path included):")
    for kname, (src, replaces, fn, cost) in sources.items():
        sums = {}   # pass -> [ms, call_ms, plain_ms, bound_ms, n, made, real, padding]
        floors = {}  # pass -> the dw chain floor, ms
        bytes_s = ops_s = 0.0
        for args, kw, stride in calls[kname]:
            nbytes, made, real, plain_fn, padding = cost(*args, **kw)
            t_call = cuda_ms(lambda: fn(*args, **kw), reps=10, warmup=2)
            t = queued_ms(lambda: fn(*args, **kw), reps=5)
            require(t > 0, f"no device time measured for {kname} at {args[0].shape}")
            tp = cuda_ms(plain_fn, reps=1, warmup=0)
            tb = max(nbytes / HBM_BYTES_PER_S, real / lookups_per_s) * 1e3
            shapes = " ".join(str(tuple(a.shape)) for a in args[:2])
            pass_ = "dx" if stride else {"approx_gemm": "fwd+dx+dw",
                                         "approx_conv2d_dw": "dw"}.get(kname, "fwd")
            note = ""
            if kname == "approx_gemm":
                note = f"; {gemm_plan_text(*args[:3])}; {matmul_text(*args[:2])}"
            if kname == "approx_conv2d_dw":
                x, g = args[:2]
                floor = g.numel() // g.shape[3] * FADD_CLOCKS / (sm_mhz * 1e3)
                plan, grid = dw_plan_of((kw["kh"], kw["kw"], x.shape[3], g.shape[3]), args[2])
                note = f"; chain floor {floor:.4f} ms; {plan}; grid {grid}"
                floors[pass_] = floors.get(pass_, 0.0) + floor
            if kname == "approx_conv2d_fused":
                plan, grid = conv_plan_of(conv_call_shape(*args, **kw)[0], args[2])
                note = (f"; {padding} more on padding taps staged as +0.0; "
                        f"{'no' if made == real else made - real} inserted zeros multiplied; "
                        f"{plan}; grid {grid}")
            print(f"  {kname} [{pass_}] {shapes} {kw}: {t:.4f} ms on device, {t_call:.4f} ms "
                  f"per call (plain {tp:.2f} ms, bound {tb:.4f} ms, {made} lookups made, "
                  f"{real} on real values, {nbytes} B){note}")
            s = sums.setdefault(pass_, [0.0] * 4 + [0] * 4)
            for i, v in enumerate((t, t_call, tp, tb, 1, made, real, padding)):
                s[i] += v
            bytes_s += nbytes / HBM_BYTES_PER_S
            ops_s += real / lookups_per_s
        ms, call_ms, plain_ms, bound, n_calls = (sum(s[i] for s in sums.values())
                                                 for i in range(5))
        for pass_, (t, t_call, tp, tb, n, made, real, padding) in sums.items():
            print(f"kernel {kname} [{pass_}]: {t:.4f} ms on device per resnet-mini step over {n} "
                  f"launches ({t_call:.4f} ms per-call time), bound {tb:.4f} ms, {made} lookups "
                  f"made, {real} on real values"
                  + (f", {padding} on padding taps" if kname == "approx_conv2d_fused" else "")
                  + (f", chain floor {floors[pass_]:.4f} ms" if pass_ in floors else "")
                  + f", plain {tp:.2f} ms")
        rows_out.append({
            "name": kname, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": main_launches[kname],
            "max_abs_err": max_err[kname], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes", "library_ms": None})
        print(f"kernel {kname} (replaces {replaces}): {ms:.4f} ms on device per resnet-mini "
              f"step over {n_calls} launches ({call_ms:.4f} ms per-call time), bound "
              f"{bound:.4f} ms ({rows_out[-1]['bound_by']}), plain {plain_ms:.2f} ms, max|d| "
              f"{max_err[kname]}; {main_launches[kname]} launches in {TRAIN_STEPS} resnet-mini "
              f"training steps; no PyTorch call computes a LUT product, so no library time")
    phase_done("5b step and kernel timings")

    # ---------------------------- 5c. LM serving at full depth, timed
    rows_out += serving_full_depth(dev, lookups_per_s, smi_line, serve_launches, serve_err)
    phase_done("5c serving, full depth")
    rows_out += moe_serving_full_depth(dev, lookups_per_s, smi_line, moe_launches, moe_err)
    phase_done("5d MoE serving, full depth")

    # ------------------------------------------------- 5e. LM training
    train_launches = lm_training(dev, lookups_per_s, smi_line)
    for kname in ("approx_gemm", "approx_gemm_batched", "approx_attention", "fused_moe_ffn"):
        require(any(run[kname] for run in train_launches.values()),
                f"{kname} never launched on the LM training path")
    phase_done("5e LM training")

    # ------------------------------------------- 6. the numerics surface
    # 12 and 13, the mesh (four ranks on the card, one spawn), start after
    # 6b and run beside 6a, 6c, 6d, 7, 8 (its training apart) and 9, whose
    # models leave the ranks room on the card (6b, 8c's training and phases
    # 10-11 would not); the main run waits for them before 8c's training
    jobs = []
    numerics_surface(dev, lookups_per_s, smi_line, phase_done,
                     after_sweep=lambda: jobs.append(mesh_start(smi_line)))

    # ---------------------------------------------- 7. continuous batching
    continuous_batching(dev, gen, lut_case, lookups_per_s, smi_line, phase_done)

    # ---------------------------------------------- 8. the SSM families
    ssm_err = ssm_families(dev, lut_case, lookups_per_s, smi_line, phase_done, train=False)

    # ---------------------------------------------- 9. the encoder-decoder
    encdec_err = encoder_decoder(dev, gen, lut_case, lookups_per_s, smi_line, phase_done)
    job = jobs[0]
    mesh_s = mesh_join(job)
    phase_done("12/13 waited for")
    ssm_training(dev, lookups_per_s, smi_line, phase_done)

    # ------------------------------------ 10. the rest of the dense registry
    zoo_err, zoo_launches = dense_zoo(dev, gen, lut_case, lookups_per_s, smi_line, phase_done)
    for kname in ("approx_gemm", "approx_gemm_batched", "approx_attention", "fused_qkv_norm",
                  "fused_out_mlp", "fused_attn_out_mlp"):
        require(zoo_launches.get(kname, 0) > 0, f"{kname} never launched on phase 10's path")

    # ---------------------------------- 11. llama4-maverick-400b-a17b
    llama4_err, llama4_launches = llama4(dev, lut_case, lookups_per_s, smi_line, phase_done)
    for kname in ("approx_gemm", "approx_gemm_batched", "approx_attention", "fused_qkv_norm",
                  "fused_attn_out_mlp", "fused_wo_norm", "fused_moe_ffn"):
        require(llama4_launches.get(kname, 0) > 0, f"{kname} never launched on phase 11's path")
    # ------------------------------ 12 and 13: the mesh's checks and lines
    mesh_launches, family_launches = mesh_report(job, smi_line)
    # each row keeps its own path's launches, beside the time of that run;
    # phases 10 and 11 print theirs on lines of their own (10c, 11c); the
    # mesh's paths, per rank, stand beside them
    for row in rows_out:
        for err in (ssm_err, encdec_err, zoo_err, llama4_err):
            if row["name"] in err:
                row["max_abs_err"] = max(row["max_abs_err"], err[row["name"]])
        row["mesh_launches_per_rank"] = mesh_launches.get(row["name"], [0] * 4)
        row["mesh_families_launches_per_rank"] = family_launches.get(row["name"], [0] * 4)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; whole script {sum(phase_s.values()):.1f}; beside phases 6a-9: "
          + ", ".join(f"{k} {v:.1f}" for k, v in mesh_s.items()))

    print(smi_line)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
