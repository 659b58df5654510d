#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the ftIMM stack on one NVIDIA GPU:
serving and training.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, nvcc (PATH or
/usr/local/cuda/bin) and no network.  Phases, in order:

1. the card's name and power limit, as nvidia-smi reports them;
2. [build] the eight ftIMM kernels from src/repro_torch/kernels/ftimm/csrc,
   one nvcc per source, all started together;
3. [check] hold each kernel against its plain PyTorch version on the card:
   the shapes that serving qwen3-1.7b, mixtral-8x7b and
   llama4-scout-17b-a16e gives it (decode at 4 slots, and the bucket
   prefills), the shapes of the recurrent path (mamba2-370m's and
   zamba2-7b's SSM in / out projections, N = 4384 / 14576, at 4, 40 and
   300 rows, their unembeds, and zamba2's shared block: q / k / v, o and
   down with the residual, the gate/up pair, the fp32 QK^T / PV at
   head_dim 112), the shapes of [families] (whisper-base's decode
   projections, its unembed at N = 51872 (a 32-column edge tile), the frame
   projection, encoder and cross K / V over 1500 rows (a 92-row edge), the
   encoder's non-causal fp32 QK^T / PV and the cross-attention decode over
   1024-row KV blocks; llava-next-34b's decode projections, 7168 -> 2 x
   20480 pair, 64000-row unembed, the patch projection at 576 and 4 x 576
   rows, the prefill at 600 and 2432 rows and the fp32 decode attention
   over the 896-row paged view, 7 query heads a group), the shapes
   training gives the two backward kernels (the llama4-scout expert dW, T = 1024 routed rows; the split-K kernel at the
   T2 dW shapes of qwen3-1.7b and the llama4-scout router, nsplit 2 / 4 /
   8), unaligned shapes, every trans, the epilogues, the shared 2-D
   operand, and ragged group distributions (4 rows to 4 distinct groups,
   all rows to one group, empty groups, a group spanning several tiles,
   rows outside every group, totals not a multiple of 16), and the
   tensor-core and weight-stream bodies of ftimm_gemm, ftimm_gemm_grouped,
   ftimm_gemm_ragged and the three SwiGLU pairs, and the tensor-core
   bodies of the ragged dW and of split-K (its partials summed in split
   order inside the kernel, nsplit 2 / 4 / 8 / 40) called directly at
   extents that are not tile multiples (every trans each body takes, both
   outputs, the epilogues with (G, N) vectors and the grouped residual, a
   shared 2-D operand, 1 / 4 / 16 rows, one or several K slices, a K tail
   at every group's edge, the ragged distributions: empty groups, a group
   of exactly 16 rows, rows outside every group), and at the MoE and qwen
   home shapes; the grouped kernel's rows body at the decode attention
   shapes of every family, at 1 / 3 / 7 / 8 rows a group over rows of no
   multiple of its widths, with K slices, each epilogue field and a
   shared 2-D operand, its reruns bitwise and NaN past K in either
   operand kept out.  Then the planner's body choice through the dispatch layer
   (a misaligned operand takes the FMA body, 4 rows the stream -- so does
   every bf16 decode GEMM of the recurrent path and of [families] -- 200
   the tensor cores; mixtral's 16-row expert buffers, llama4's 4 routed rows
   and qwen's 4 decode rows of the dense gate/up pair the grouped / ragged
   stream, for the down projection and the gate/up pairs, 128, 320 and
   1024 rows the tensor cores, fp32 the FMA body; qwen's and llava's fp32
   decode QK^T / PV the rows body, 9 rows a group or a misaligned cache the
   FMA body) and bit-identical reruns of the streams (the pairs' at 1 and 4 K slices), the tensor-core ragged
   dW, the grouped / ragged / dense tensor cores and pairs and split-K's
   tensor cores at qwen's dW shape.  Normwise
   tolerance max|kernel - plain| / max|plain|: 2e-2 for a bf16 output
   (2^-8 is one bf16 ulp), 1e-4 for fp32 (the same fp32 products summed in
   another order);
4. [reference] small and full-width references: qwen3-1.7b-smoke in fp32,
   its weights on the card and on the CPU (where every GEMM takes the plain
   version): prefill logits within 1e-4 normwise and the same greedy tokens
   from ServeEngine; then each MoE model in fp32 at full width and 2
   layers, card against CPU: a prefill and two decode steps must choose the
   same experts for every token in every layer, and then give logits within
   1e-3 normwise (in bf16 one rounding can move a near-tied token to another
   expert, which is a different routing, not an error); then whisper-base
   and llava-next-34b: the smoke configs as qwen's (their frames / patches
   seeded), and in fp32 at full width, card against CPU, whisper at full
   depth (6 + 6 layers, 1500 seeded frames) and llava at 1 layer (576
   seeded patches, a 24-token prompt), a prefill and two decode steps: the
   logits and every cache leaf (the cross K / V too) within 1e-3;
5. [serve] qwen3-1.7b at full width and depth (28 layers), then
   mixtral-8x7b and llama4-scout-17b-a16e at full width and 8 layers
   (neither fits one 80 GB card whole; 8 layers keep whole periods of each
   window pattern), random bf16 weights from seed 0, one model on the card
   at a time, through ServeEngine: 6 greedy requests over 4 slots, prompts
   in two length buckets, 16 new tokens each.  The launch counts are zeroed
   just before each run and read just after; every kernel of that model's
   path must have launched, and every ftimm_gemm of a decode step (4
   rows) and every bf16 SwiGLU pair or expert launch (gate/up pair and
   down) of at most 16 rows (qwen's 4 decode rows, mixtral's 16 rows an
   expert, llama4's 4 routed rows) must have taken a stream body, of more
   rows (the bucket prefills) the tensor cores, the fp32 attention
   products of a decode step (2 rows a group) the rows body and those of
   the prefills (more than 8 rows) the FMA body.  Then one prompt's
   full-width qwen3 prefill logits are held against the plain versions on
   the CPU (5e-2 normwise:
   28 bf16 layers, each of whose activations may round one bf16 ulp apart);
6. [recurrent] mamba2-370m (SSM, 48 layers) and zamba2-7b (hybrid: 81
   Mamba2 layers, one shared attention + MLP block after every 6) on
   ServeEngine's dense-slot rung.  fp32 references, card against CPU:
   the smoke configs (zamba2 at 5 layers: 2 groups and a remainder),
   prefill logits within 1e-4 and the same greedy tokens; full width at a
   depth cut (mamba2 2 layers, zamba2 7: a group of 6 and a remainder of
   1), a prefill and 2 decode steps, the logits and every cache leaf
   within 1e-3.  Then both at full width and depth in bf16, random
   weights from seed 0, one on the card at a time: 6 greedy requests over
   4 slots, prompts of 2, 17, 40 and 300 tokens (the last spans more than
   one SSD chunk), 16 new tokens each.  Every kernel of the path must
   launch, with no non-finite logits; every ftimm_gemm of at most 4 rows
   (decode, the conv tails, the 2-token prompt) on the stream body, the
   dense pair of at most 16 rows on the stream and more on the tensor
   cores, the fp32 attention on the rows body at most 8 rows a group
   (decode, the 2-token prompt) and on the FMA body past it; one decode
   step launches ftimm_gemm 97 times (mamba2) or 228, the pair 13 and the
   grouped kernel 26 times (zamba2).  Prints the decode median, the
   prefill walls,
   peak memory, launches a step and ``profile_decode``'s device busy,
   idle share and device time by kernel group;
7. [families] whisper-base (encdec: 6 encoder layers over 1500 frames, 6
   decoder layers with cross-attention) at full width and depth on the
   dense-slot rung (slot caches of 320 rows, each slot's cross K / V), and
   llava-next-34b (vlm) at full width and 16 layers (68 GB whole in bf16;
   depth is the only cut) on the paged rung with buckets, each request's
   576 patch rows in its pages before its prompt; bf16, random weights
   from seed 0, one model on the card at a time, the stub frontends' zero
   frames / patches; [recurrent]'s 6 requests.  Every kernel of the path
   must launch, with no non-finite logits; every ftimm_gemm of at most 4
   rows on the stream body, the pair of at most 16 rows on the stream and
   more on the tensor cores, the fp32 attention on the rows body at most
   8 rows a group (decode) and on the FMA body past it; one decode step
   launches ftimm_gemm 43 / 81 times, the pair 6 / 16 and the
   grouped kernel 36 / 32 (whisper's cross-attention spans two 1024-row
   blocks); llava's pages held 576 + prompt + 15 rows a request.  Prints
   the decode median, the prefill walls (whisper's with its encoder),
   peak memory, launches a step and ``profile_decode``'s device busy,
   idle share and device time by kernel group;
7a. [archs] gemma3-4b (34 layers, 8/4 heads of 256, qk-norm, five layers
   of window 1024 to one global, a 262,144-row tied unembed), minitron-4b
   (32 layers, a 256,000-row unembed) and qwen3-8b (36 layers, d 4096,
   d_ff 12288): their decode shapes against the plain versions (gemma3's
   fp32 QK^T / PV at head_dim 256 over the 1,120-row paged view, the
   unembeds ``nt`` to fp32 at 4 rows, the three pairs); an fp32
   reference each, card against CPU, through a page table (gemma3 at 6
   layers over a 1,100-token prompt, the others at 2 layers over 64
   tokens, then 4 paged decode steps: logits and pools within 1e-3); then
   each served at full width and depth in bf16 on the paged rung, one at
   a time: [serve]'s 6 requests, and for gemma3 two more of 1,100 tokens
   (8 new tokens each; their windowed layers drop rows).  Every kernel of
   the path must launch, with no fault, the pool must drain; a decode step
   launches ftimm_gemm 5 x layers + 1 times on the stream, the pair once
   and the fp32 attention twice a layer on the rows body.  Prints the decode
   median, the prefill walls, peak memory, launches a step and
   ``profile_decode``'s device busy, idle share and device time by kernel
   group;
8. [train-reference] training in fp32, card against CPU, same weights and
   batches: qwen3-1.7b at full width and 2 layers, 2 AdamW steps of batch 2
   x seq 32 (the loss of each step and every step-1 gradient leaf within
   1e-3 normwise); llama4-scout-17b-a16e at full width and 1 layer, one
   forward / backward of 64 tokens (the same experts for every token on
   both, then the loss and every gradient leaf within 1e-3); whisper-base,
   llava-next-34b, mamba2-370m and zamba2-7b (5 layers) at -smoke, one
   forward / backward of 2 x 32 tokens (and the seeded frames / patches):
   the loss and every gradient leaf within 1e-4;
9. [train] through ``Trainer``, bf16 compute on fp32 masters, AdamW (the
   first 5 steps of a 20-step warmup to lr 3e-4), seq 128 x batch 8 (the
   launcher's defaults), one model on the card at a time: qwen3-1.7b at
   full width and depth (28 layers), and llama4-scout-17b-a16e and
   mixtral-8x7b at full width and 1 layer (fp32 masters, gradients and
   moments of 2 layers do not fit one 80 GB card), then whisper-base and
   mamba2-370m at full width and depth, llava-next-34b at 1 layer (576
   patches a sample) and zamba2-7b at 7 layers (a group of 6 and a
   remainder; its masters and moments at 81 layers exceed 80 GB).
   The launch counts are zeroed just before each run and read just after;
   every kernel of that model's training path must have launched
   (``ftimm_gemm_ragged_dw`` for llama4-scout's expert dW, the grouped
   kernel for mixtral's).  The loss must be finite and lower at step 5 than
   at step 1; ftimm_gemm must have taken the tensor-core or stream body
   for every bf16 product of 128 or more columns, the FMA body only for
   the mixed and fp32 pairs (the fp32 cotangents of the logits and the
   router) and the bf16 routers the planner gives it, the ragged dW,
   every bf16 x bf16 grouped and ragged expert product and qwen's dense
   gate/up pair (56 launches a step: 28 layers, forward and remat) the
   tensor cores, and the fp32 attention (128 and more rows a group) and
   mixed grouped / ragged products the FMA body.  Prints the median step
   time, tokens/s and peak device memory.  Every distinct kernel call of these runs is recorded (kernel,
   operand shapes, strides and dtypes, trans, tile, epilogue, out dtype;
   the ragged offsets as routed);
10. [train-check] each recorded call replayed on random operands of its
   shapes against the kernel's plain version, at the tolerances of
   [check]: the forward, remat, dX and dW products of the seven training
   runs' steps, the mixed bf16 x fp32 products of the fp32 logits' and router's
   cotangents included;
11. [train-schedule] the launcher's own schedule for a 5-step run (a 1-step
   warmup to lr 3e-4, ``launch.train.opt_config``): llama4-scout at 1 layer
   in bf16 and in fp32 compute from the same masters and batches, and
   qwen3-1.7b at 28 layers in bf16.  The losses are recorded, not gated
   (with this 1-step warmup they spike at full width, in fp32 as in bf16);
   the gates are that bf16 and fp32 give the same step-1 loss within 1e-2
   and the same step-2 loss within 5e-2;
11a. [train-dots] qwen3-1.7b at 28 layers, 3 AdamW steps of 8 x 128 with
   remat "full" and "dots" from the same seed and batches (PyTorch's own
   ops in their deterministic algorithms): the losses and every gradient
   leaf of every step bitwise equal, and each step's launches lower under
   "dots" by exactly 5 ftimm_gemm and one ftimm_gemm_swiglu a layer (the
   forward products it keeps); both peak memories and step medians;
12. [autotune] the measured plan store on qwen3-1.7b at full width: every
   GEMM signature its main path plans (recorded at the dispatch layer
   while it serves the 6 requests -- decode at 4 rows, the 128- and
   256-row bucket prefills -- and takes two train steps of 8 x 128: the
   forward, dX and dW) tuned on the card at its served shape, the top 4
   of the CMR shortlist each (``core.gemm.autotune``, operands rotated
   past the L2); per signature the analytic plan and its time, the
   measured winner and its time and the model's estimate; each winner
   re-timed beside the analytic plan on new operands (it must not be above
   1.10x); a calibration fitted on the decode and prefill signatures and
   its prediction error on the training ones, before and after, and the
   signatures whose analytic pick it would move, each timed under both
   picks (reported, not gated; the calibration is not stored, so the
   store serves measured plans only and unstored shapes plan as before);
   the store saved to ``build/plan_cache_<card>.json``,
   cleared and loaded back (every plan adopted, none quarantined); the 6
   requests served again on the stored plans (every plan served must be
   ``cached``, the first decode step's logits on the same inputs within
   2e-2 normwise of the analytic run's; the greedy tokens that agree and
   both decode-step medians are printed); then one stored record with
   nsplit 4 for qwen's gate / up dW, (1024, 2048)^T (1024, 6144), and two
   qwen train steps: ``ftimm_gemm_splitk`` must launch, and the losses and
   the step-1 gradient norm must stay within 1e-3 of the analytic steps';
13. [quant] the quantized type paths (int8 / fp8 / weight-only int8,
   ``core.quant``): ``ftimm_gemm``'s FMA body at every quantized code
   (qwen's and llama4's 4 decode rows, 128 prefill rows, unaligned
   extents; nn, and nt for the straight-through dX) and
   ``ftimm_gemm_ragged``'s at llama4's decode distribution (4 rows to 4 of
   16 experts) and a prefill distribution with an empty expert and rows no
   expert owns, (G, N) dequant vectors, each against its plain version:
   int8 x int8 bitwise (an exact int32 sum and the same fp32 flush), the
   others within the [check] tolerances (fp32 sums of exact products in
   another order); the tensor-core and stream bodies and the kernels
   without the quantized codes must raise on int8 operands; one forward /
   backward each of ``matmul(quant=)`` (with a bias / silu / residual
   tail) and ``ragged_matmul(quant=)`` for w8, int8 and fp8_e4m3, card vs
   CPU (1e-4).  Then llama4-scout-17b-a16e-w8 at full width and 8 layers
   and -int8 / -w4 at 2 layers (a depth cut), [serve]'s 6 requests, each
   served twice: the greedy tokens must agree, every ``ftimm_gemm_ragged``
   launch must be its FMA body on 1-byte panels and no ragged SwiGLU pair
   may launch, and the first decode step's logits must lie within 5e-2
   (Frobenius-normwise, the reference's MoE bound) of the same weights
   served unquantized (w8, int8; w4 reported); the decode-step median and
   peak memory; for w8 ``launch.profile_serve``'s device ms a step by
   kernel group with the per-call weight quantization as its own line;
   that pass's time for one expert stack; and each quantized path at the
   decode shapes timed as [time] does, beside its bound (bytes / 3.35
   TB/s with 1-byte weights, or operations / 1,979 TOP/s for int8 and fp8,
   989 for bf16 x int8) and its yardstick: ``torch._int_mm`` /
   ``torch._scaled_mm`` where their shape and type rules allow,
   dequantize + ``torch.matmul`` / ``torch._grouped_mm`` (two calls) for
   w8;
13a. [chaos] the chaos sites (``repro_torch.runtime.chaos``) on
   qwen3-1.7b at full width and 4 layers, paged rung, bf16:
   ``kernel_fused`` armed on one decode step's o / down + residual
   projections, on its gate/up pairs and on all of them (the degraded
   counter rises by the faults armed, the step's logits within 2e-2 of the
   clean step's, the unfused spellings on the kernels: the identity
   ftimm_gemm, two ftimm_gemm for a pair, no plain version); ``kernel``
   on a CUDA tensor raises KernelLaunchFailure with no launch and no plain
   version; [serve]'s 6 requests clean and under ``transient_decode@1x2``
   (tokens bit-identical, 2 retries), ``nan_logits`` and
   ``page_exhaustion`` (the re-prefilled request's in-vocabulary tokens,
   its re-prefill logits and its next step's within 2e-2 of the clean
   run's, the pool drained) and ``bucket_miss`` (one exact prefill within
   2e-2 of the bucketed one); ``plan_save_crash`` leaves the store on disk
   intact.  Every other phase must end with no degraded serving;
13b. [contracts] the static contracts (``repro_torch.analysis``) on the
   card: the device's opt-in shared memory per block (PyTorch's device
   properties, or the CUDA runtime's attribute) must hold
   ``HopperSpec.smem_per_block`` and every footprint the sweep admits (the
   full sweep, with [autotune]'s stored records); under
   ``REPRO_VERIFY=1`` qwen3-1.7b at 4 layers, mixtral-8x7b and
   llama4-scout at 1 layer serve [serve]'s 6 requests, llama4 takes one
   train step at 1 layer and qwen's dW ``tn`` runs through a stored
   nsplit-4 record: every kernel launched, each kernel's distinct plans
   checked (printed), no ContractError; every body of every kernel at K =
   200 (no tile's step divides it) on operands that are views into NaN
   (past K, M, N and the groups; the ragged kernels' rows no group owns
   NaN too), finite and within the [check] tolerances of the plain
   version; a store of three corrupt records (an uncompiled tile, a
   footprint over budget, split-K on the SwiGLU pair) loaded on the card:
   each quarantined with its code, each call then served by its analytic
   plan;
13c. [roofline] for every config a phase profiled (mamba2-370m,
   zamba2-7b, whisper-base, llava-next-34b at 16 layers, gemma3-4b,
   minitron-4b, qwen3-8b, llama4-scout-w8 at 8 layers), at its served
   depth and the profiled window's cache rows: ``roofline.step_perf``'s
   bytes and t_memory, the parameter bytes allocated on the card against
   ``param_count()`` x the served width (within 2 %), and
   ``profile_decode``'s device busy over the bound;
13d. [dist] the mesh executors on process groups.  One H100 cannot run
   NCCL across GPUs (NCCL refuses two ranks on one GPU), so two ranks
   spawned after the build share cuda:0 over gloo (the host transport:
   every exchange staged through host memory), meeting on a file://
   store.  (a) each rank, bf16, against the one-rank call on the card:
   ``dist_matmul`` k_parallel (gather and ring) at qwen3-1.7b's
   down-projection (4, 6144)·(6144, 2048) + residual and m_parallel at a
   prefill's (1024, 2048)·(2048, 6144), within 2e-2 normwise;
   ``ep_ragged_moe`` forward and backward at llama4-scout's experts (16,
   5120 x 8192 / 8192 x 5120), 64 rows skewed, all on one expert (rank
   0's window empty) and balanced, both schedules, within 2e-2, each
   rank launching the ragged pair, the ragged product and the ragged dW;
   the identity round trip bitwise; ``ep_ring`` armed on both ranks and
   on rank 0 only: both take the gather rung, counted on both, bitwise
   the gather schedule's result.  (b) llama4-scout at full width and 8
   layers on a (data 1, model 2) mesh, experts cut over "model" as they
   are drawn (8 of 16 a rank), flash-decode over 40 of the 80 cache rows
   a rank: 4 prompts of 50 tokens, ``prefill`` and 16 scalar-position
   ``decode_step`` s fed the one-rank run's greedy tokens (that run first,
   in this process, the card freed after it).  Held row by row: every
   expert choice equal, or flipped at a near tie (the one-rank top-1
   minus top-2 router logit < 0.1: one bf16 rounding moves such a token,
   a different routing, not an error), and each row's logits before its
   first flip within 5e-2 normwise with the same greedy token; the same
   run in fp32 at 2 layers and 4 steps: every choice equal, logits within
   1e-3, greedy tokens equal.  Each rank's decode median, launches a
   step by kernel (flash-decode's ``ftimm_gemm_grouped``, EP's ragged
   pair and product), staged bytes and host syncs a step.  (c) a one-rank
   NCCL world (the device transport): (a)'s ``ep_ragged_moe`` and
   ``dist_matmul`` calls bitwise the one-device composition of the same
   products.  A rank's failure or the world's timeout fails the phase;
13e. [mesh-train] training on a mesh (``Trainer(mesh=...)``): two ranks
   share cuda:0 over gloo, as in [dist]; the one-rank runs first, in this
   process.  2 steps of 8 x 128 (bf16 on fp32 masters, AdamW) a case,
   each beside the one-rank ``Trainer`` from the same seed: (a)
   qwen3-1.7b, 2 layers, (data 2, model 1), ZeRO-3: the losses within
   2e-2 relative a step, and in fp32 compute within 1e-5;
   (b) the same on (data 1, model 2), tensor parallel: every rank's
   ``ftimm_gemm`` and ``ftimm_gemm_swiglu`` launched on its half panels
   (the recorded shapes: wq (2048, 1024), wo (1024, 2048), the pair
   (2048, 3072), down (3072, 2048); no whole panel); (c)
   llama4-scout-17b-a16e, 1 layer, (data 2), the experts over data (8 a
   rank), each rank launching the ragged pair, product and dW, the losses
   within 2e-2; (d) mamba2-370m, 48 layers, (data 1, model 2) with its SSD
   heads over model: the losses within 2e-2, then 4 prompts of 40 tokens
   prefilled into the head-cut dense-slot cache and 8 decode steps fed
   the one-rank run's greedy tokens, in fp32 compute: every call's logits
   (the real vocabulary) within 1e-3 of the one-rank run's and the greedy
   tokens equal, or flipped where the two tokens' one-rank logits differ
   by at most twice the row's largest logit difference; the same in bf16
   reported (48 random bf16 layers in another summation order); (e)
   ``compress_allreduce`` of 4,194,304 fp32 elements a rank: 1 byte an
   element plus the 4-byte max staged each way, the mean within 0.2 of
   the fp32 mean; the elastic re-mesh: ``ElasticRunner`` at
   qwen3-1.7b-smoke in fp32, 12
   steps of 8 x 32: a ``shard_loss`` at step 6 (1 rank lost) re-meshes (2,
   1) onto (1, 1) and restores step 4: the history, and steps 6-11 within
   1e-5 of the clean run's.  (f) mixtral-8x7b, 1 layer, (data 2),
   capacity dispatch with the rows cut over data, once with the experts
   whole (ZeRO-3) and once over data (``moe_ep``): each rank launching the
   grouped pair and down product, the losses within 2e-2 and the first
   step's gradient norm too (in bf16 the later norms carry a step's
   rounding through the routing: reported), and the copies the capacity
   keeps in the first forward summed over the ranks equal to the one-rank
   run's; (g) whisper-base, full
   depth, (data 1, model 2), tensor parallel (the encoder, the cross
   projections and the cross-attention on the rank's heads): within 2e-2,
   and in fp32 within 1e-5; (h) qwen3-1.7b, 2 layers, (data 2), ZeRO-1
   (the parameters TP only, the moments at ZeRO-3: a rank holds about half
   the moments): within 2e-2, and at 2 layers in fp32 within 1e-5 (the
   gradient norms of every fp32 step too).  No
   plain version runs in (a)-(d), (f)-(h).  Per case and rank: staged
   bytes a step, the step median, parameters, moments and peak memory,
   launches by kernel;
13f. [placed] the measured placed search: ``autotune_gemm`` /
   ``autotune_batched_gemm`` / ``autotune_ragged_gemm`` with 2 shards at
   qwen3-1.7b's decode gate / up (4 x 2048 x 6144), its fp32 attention PV
   (32 x 2 x 96 x 128) and llama4-scout's decode expert down (16 groups,
   4 rows, 8192 x 5120), stored, saved, reloaded and served by the
   planner as "cached" (each winner one of its options; every local GEMM
   launched its kernel); then on the two gloo ranks sharing the card
   ``calibrate_ici(store=False)`` (the fitted fraction printed: host
   staging on one card, not NVLink) and both ``time_placed_*_e2e`` at the
   same dense and ragged shapes, each row's measured time beside the
   planner's; gated on finite times, not on which strategy wins;
13g. [dryrun] the production-mesh dry run (``launch.dryrun``): every
   ``--all`` cell on the abstract 16 x 16 mesh -- the baseline, and
   ep_moe, serve_tp, ssm_shard, zero1 and l4_ep_model where they apply --
   lowered on ``meta`` by DR_WORKERS CPU processes (each cell's dominant
   term, t_bound and memory a device printed; a failed cell fails the
   phase); meanwhile on two ranks sharing the card over gloo
   (``REPRO_RAGGED_A2A=dense``) three steps run for real -- [mesh-train]'s
   qwen3-1.7b ZeRO-3 train step on (2, 1), [dist]'s llama4-scout EP decode
   step and qwen3-1.7b's TP decode step with its KV cache on (1, 2) --
   each recorded (``collective.record``) and held to the same case
   lowered on ``Mesh.abstract`` in the same process: the same (op, bytes,
   axes) calls, the same argument bytes; the TP decode's fp32 logits
   within 1e-5 of one rank's and its greedy tokens equal; each step's
   tracked peak printed beside ``torch.cuda.max_memory_allocated`` (no
   gate); each rank's launches of the three steps (zeroed just before
   each, read just after) join the kernels line's ``launches_by_run``;
13h. [paper] the paper's own comparison (paper Fig. 4): the seven shapes
   of the reference's ``benchmarks/single_core.py`` (T1 (2^20, 32 / 64,
   32 / 64), T2 (32 / 64, 2^20, 32 / 64), T3 (20480, 20480, 32 / 96), a
   regular 4096^3 control), each in fp32 and bf16, through ``ops.gemm``
   with ``plan_gemm(...).kernel_kwargs()`` (as the dispatch layer runs
   it; where ``ops.gemm``'s clamp changes its FMA tile, also as planned,
   ``clamp=False``) and with ``tgemm_plan(...).kernel_kwargs()`` (the
   TGEMM baseline, paper Alg. 1: one fixed tile, unclamped; run once
   where both plans take the same body and tile); every case held to its
   plain version (a case outside its tolerance fails the run), its launch
   counted from 0 by kernel and body; then timed (the median of 3: CUDA
   events around one call of 5 ms or more, else ``time_ms`` runs of
   about 100 ms) beside ``torch.matmul`` and the plain version.  One line
   per case: the adaptive body and tile, both medians, the measured TGEMM
   / adaptive ratio beside the CMR model's, ``torch.matmul``'s and the
   plain version's times, the bound, ``upper_bound_fraction`` and the
   card's name and power limit;
14. [time] each kernel at the decode-step shapes of the model it serves, and
   the two backward kernels at the training shapes (split-K on its
   tensor-core and FMA bodies), and ftimm_gemm at qwen3-1.7b's training
   forward shapes, its unembed and the mixed fp32 x bf16 unembed dX, qwen's
   dense gate/up pair on the FMA body beside the planned stream at decode,
   at both bucket prefills and on the tensor cores and the FMA body at the
   1024 training rows, and the MoE expert-down products and gate/up pairs
   on the FMA body beside the planned stream at decode and on the tensor
   cores and the FMA body at mixtral's training capacity 320 and llama4's
   1024 routed rows, and the decode attention products of PERF.md's rows
   2, 2r, 2e, 2v and 2g (QK^T and PV) on the grouped kernel's FMA body
   beside their planned calls on its rows body and ``torch.bmm`` (CUDA
   events around calls enqueued behind a sleep kernel, so the card runs
   them back to back; operands rotated through
   more copies than the 50 MB L2 holds) beside its plain version, one
   PyTorch library call where one computes the same function
   (``torch.bmm`` / ``torch._grouped_mm`` for the MoE expert products,
   ``torch.matmul`` for the split-K kernel, which is also timed beside
   ``ftimm_gemm`` at nsplit = 1; for the bf16 SwiGLU pairs, which no one
   call computes, two such calls -- ``torch.matmul`` for the dense pair --
   and the elementwise silu(g) * u, reported apart as ``yardstick_ms``),
   and its bound: the
   larger of the bytes this input needs / 3.35 TB/s and its operations /
   peak (989 TFLOP/s bf16, 67 TFLOP/s fp32; NVIDIA's H100 SXM data sheet).
   A ragged call's bytes count only the expert panels its rows reach (the
   ragged dW: every panel it writes).

It prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as
the last line.  Any failure raises and exits non-zero before that line.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.sweep import run_sweep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import quant as QUANT  # noqa: E402
from repro_torch.core.gemm import autotune, plan_store, tuner  # noqa: E402
from repro_torch.core.gemm.cmr import H100  # noqa: E402
from repro_torch.core.gemm import dispatch as D  # noqa: E402
from repro_torch.core.gemm import (batched_matmul, grouped_matmul,  # noqa: E402
                                   grouped_swiglu, matmul, matmul_swiglu,
                                   plan_batched_gemm, plan_gemm,
                                   plan_ragged_gemm, ragged_matmul,
                                   ragged_swiglu, tgemm_plan,
                                   upper_bound_fraction)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels.ftimm import kernel as K  # noqa: E402
from repro_torch.kernels.ftimm import ops  # noqa: E402
from repro_torch.kernels.ftimm.epilogue import Epilogue  # noqa: E402
from repro_torch.launch.profile_serve import profile_decode  # noqa: E402
from repro_torch.launch.timing import sleep_ms_per_mcycle, time_ms  # noqa: E402
from repro_torch.launch.train import opt_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.ssm import ssm_dims  # noqa: E402
from repro_torch.models.weights import to_numpy_tree  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.roofline import build_roofline  # noqa: E402
from repro_torch.roofline import model_flops_estimate, step_perf  # noqa: E402
from repro_torch.roofline.perf_model import served_width  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import Trainer, make_train_step  # noqa: E402

BF16, FP32 = torch.bfloat16, torch.float32
I8, E4, E5 = torch.int8, torch.float8_e4m3fn, torch.float8_e5m2
CPU = torch.device("cpu")
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {BF16: 989e12, FP32: 67e12, I8: 1979e12, E4: 1979e12,
              E5: 1979e12}
TOL = {BF16: 2e-2, FP32: 1e-4}
MOE_REF_TOL = 1e-3
_TPU = "src/repro/kernels/ftimm/kernel.py"
REPLACES = {"ftimm_gemm": f"{_TPU}:202",
            "ftimm_gemm_swiglu": f"{_TPU}:872",
            "ftimm_gemm_grouped": f"{_TPU}:322",
            "ftimm_gemm_grouped_swiglu": f"{_TPU}:920",
            "ftimm_gemm_ragged": f"{_TPU}:506",
            "ftimm_gemm_ragged_swiglu": f"{_TPU}:620",
            "ftimm_gemm_ragged_dw": f"{_TPU}:698",
            "ftimm_gemm_splitk": f"{_TPU}:759"}
ARCH, MIXTRAL, LLAMA4 = "qwen3-1.7b", "mixtral-8x7b", "llama4-scout-17b-a16e"
MAMBA, ZAMBA = "mamba2-370m", "zamba2-7b"
WHISPER, LLAVA = "whisper-base", "llava-next-34b"
GEMMA, MINITRON, QWEN8 = "gemma3-4b", "minitron-4b", "qwen3-8b"
NEW_ARCHS = (GEMMA, MINITRON, QWEN8)    # [archs], full width and depth
RECURRENT = (MAMBA, ZAMBA)      # served at full width and depth
FRONTENDS = (WHISPER, LLAVA)    # the stub-frontend families ([families])
MOE_LAYERS = 8          # served depth of the MoE models (width as published)
REF_LAYERS = 2          # depth of their fp32 card-vs-CPU reference
# The kernels each run must launch (serving, then training), and the run
# whose step each kernel's entry in the kernels line is timed for.  The
# analytic planner never picks split-K (nsplit > 1, as in the reference):
# its entry is timed per call at qwen's dW shapes, and its launches are
# read from [autotune]'s qwen train steps, which reach it through a stored
# plan record (LAUNCH_RUN).
PATH_KERNELS = {
    ("serve", ARCH): ("ftimm_gemm", "ftimm_gemm_swiglu", "ftimm_gemm_grouped"),
    ("serve", MIXTRAL): ("ftimm_gemm", "ftimm_gemm_grouped",
                         "ftimm_gemm_grouped_swiglu"),
    ("serve", LLAMA4): ("ftimm_gemm", "ftimm_gemm_grouped",
                        "ftimm_gemm_ragged", "ftimm_gemm_ragged_swiglu"),
    ("serve", MAMBA): ("ftimm_gemm",),
    ("serve", ZAMBA): ("ftimm_gemm", "ftimm_gemm_swiglu",
                       "ftimm_gemm_grouped"),
    ("serve", WHISPER): ("ftimm_gemm", "ftimm_gemm_swiglu",
                         "ftimm_gemm_grouped"),
    ("serve", LLAVA): ("ftimm_gemm", "ftimm_gemm_swiglu",
                       "ftimm_gemm_grouped"),
    **{("serve", a): ("ftimm_gemm", "ftimm_gemm_swiglu", "ftimm_gemm_grouped")
       for a in NEW_ARCHS},
    ("train", ARCH): ("ftimm_gemm", "ftimm_gemm_swiglu", "ftimm_gemm_grouped"),
    ("train", LLAMA4): ("ftimm_gemm", "ftimm_gemm_grouped",
                        "ftimm_gemm_ragged", "ftimm_gemm_ragged_swiglu",
                        "ftimm_gemm_ragged_dw"),
    ("train", MIXTRAL): ("ftimm_gemm", "ftimm_gemm_grouped",
                         "ftimm_gemm_grouped_swiglu"),
    ("train", WHISPER): ("ftimm_gemm", "ftimm_gemm_swiglu",
                         "ftimm_gemm_grouped"),
    ("train", LLAVA): ("ftimm_gemm", "ftimm_gemm_swiglu",
                       "ftimm_gemm_grouped"),
    ("train", MAMBA): ("ftimm_gemm",),
    ("train", ZAMBA): ("ftimm_gemm", "ftimm_gemm_swiglu",
                       "ftimm_gemm_grouped")}
HOME = {"ftimm_gemm": ("serve", ARCH), "ftimm_gemm_swiglu": ("serve", ARCH),
        "ftimm_gemm_grouped": ("serve", ARCH),
        "ftimm_gemm_grouped_swiglu": ("serve", MIXTRAL),
        "ftimm_gemm_ragged": ("serve", LLAMA4),
        "ftimm_gemm_ragged_swiglu": ("serve", LLAMA4),
        "ftimm_gemm_ragged_dw": ("train", LLAMA4),
        "ftimm_gemm_splitk": ("train", ARCH)}
LAUNCH_RUN = {"ftimm_gemm_splitk": ("autotune", ARCH)}
SLOTS, NEW_TOKENS, PAGE, MAX_LEN = 4, 16, 16, 96
PROMPT_LENS = (24, 24, 24, 50, 50, 50)     # buckets 32 and 64
L2_BYTES = 50e6
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 5, 128, 8
TRAIN_TOKENS = TRAIN_SEQ * TRAIN_BATCH
# None: the full depth.  zamba2 at 7 layers (a group of 6 and a remainder
# of 1): its fp32 masters and moments at 81 layers exceed 80 GB.
TRAIN_LAYERS = {ARCH: None, LLAMA4: 1, MIXTRAL: 1, WHISPER: None, LLAVA: 1,
                MAMBA: None, ZAMBA: 7}
TRAIN_REF_TOL = 1e-3
# The 5 steps are the start of a 20-step warmup to the launcher's lr 3e-4.
# At full width an Adam step moves every weight by about lr (a sign step),
# so each logit moves by about lr x d_model: with the launcher's 1-step
# warmup for a 5-step run that is O(1) nats a step, and the loss spikes
# above its start, in fp32 compute as in bf16 ([train-schedule] shows it;
# PERF.md, Findings).
TRAIN_WARMUP = 20
# [recurrent]: the dense-slot rung.  Prompts of 2 tokens (the conv tail's
# zero row), 17, 40 and 300 (more than one SSD chunk: 256 for mamba2, 128
# for zamba2); slot caches of REC_MAX_LEN rows.
REC_PROMPT_LENS = (2, 17, 40, 300, 17, 40)
REC_MAX_LEN = 320
REC_PREFILL_ROWS = (40, 300)    # the exact-length prefills [check] holds
REC_SMOKE_LAYERS = {MAMBA: None, ZAMBA: 5}   # zamba2: 2 groups + 1
REC_REF_LAYERS = {MAMBA: 2, ZAMBA: 7}        # zamba2: 1 group of 6 + 1
REC_REF_TOL = 1e-3
# [families]: whisper-base at full width and depth on the dense-slot rung
# (slot caches of REC_MAX_LEN rows; its 1500 encoder rows' cross K / V in
# each slot), llava-next-34b at full width and FAM_LAYERS[LLAVA] layers
# (the whole model is 68 GB in bf16; depth is the only cut) on the paged
# rung, each request's 576 patch rows in front of its prompt.  Prompts as
# [recurrent]'s.
FAM_LAYERS = {WHISPER: None, LLAVA: 16}
FAM_REF_LAYERS = {WHISPER: None, LLAVA: 1}   # the fp32 references
# [archs]: gemma3-4b, minitron-4b and qwen3-8b served at full width and
# depth on the paged rung; gemma3 also takes two requests of LONG_PROMPT
# tokens (LONG_NEW new tokens each), so its five windowed layers of six
# (window 1024) drop rows in decode.  The fp32 references, card against
# CPU: (layers, prompt tokens), then ARCH_REF_STEPS paged decode steps.
LONG_PROMPT, LONG_NEW = 1100, 8
ARCH_MAX_LEN = {GEMMA: 1120, MINITRON: MAX_LEN, QWEN8: MAX_LEN}
ARCH_REF = {GEMMA: (6, LONG_PROMPT), MINITRON: (2, 64), QWEN8: (2, 64)}
ARCH_REF_STEPS = 4
CHAOS_LAYERS = 4        # [chaos]: qwen3-1.7b at full width, 4 layers
DOTS_STEPS = 3          # [train-dots]: qwen3-1.7b, remat "full" vs "dots"


def log(*args) -> None:
    print(*args, flush=True)


def depth(phase: str, arch: str) -> int:
    if phase == "train":
        return TRAIN_LAYERS[arch] or get_config(arch).num_layers
    if arch in FRONTENDS:
        return FAM_LAYERS[arch] or get_config(arch).num_layers
    full = arch in (ARCH,) + RECURRENT + NEW_ARCHS
    return get_config(arch).num_layers if full else MOE_LAYERS


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(normwise relative error, max abs error); raises on non-finite."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"bad output {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite")
    err = (got - want).abs().max().item()
    return err / max(want.abs().max().item(), 1e-30), err


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def param_bytes(model) -> int:
    """The bytes of a model's parameters as allocated on the card."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


# ---------------------------------------------------------------------------
# Kernel cases: inputs, the kernel path, the plain version, a library call
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Case:
    kernel: str
    label: str
    make: object            # gen -> tuple of input tensors
    run: object             # inputs -> output, through core.gemm / ops
    plain: object           # inputs -> output, the plain version
    library: object | None  # inputs -> output, one PyTorch call
    nbytes: int             # what this input needs: each input read once
                            # (a ragged call: only the panels its rows
                            # reach), each output written once
    flops: float
    dtype: torch.dtype      # the operands' type (picks the peak)
    out_dtype: torch.dtype
    per_step: int = 0       # launches in one step (0: not on the path)
    model: str = ARCH       # whose step ``per_step`` counts
    phase: str = "serve"    # "serve" (a decode step) or "train" (a step)
    timed: bool = False     # timed even with per_step 0
    entry_calls: int = 0    # calls the kernels line sums for a kernel that
                            # no step launches (split-K)
    yardstick: object | None = None  # inputs -> output through more than
                            # one PyTorch call (the SwiGLU pairs: a library
                            # GEMM per panel, then silu(g) * u), timed
                            # beside the kernel, not a library_ms


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def _name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _size(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def dense_case(label, m, k, n, *, trans="nn", dtype=BF16, out=None,
               residual=False, per_step=0, phase="serve", timed=False,
               b_dtype=None, model=ARCH) -> Case:
    """``b_dtype``: B's type when it differs from A's (an fp32 cotangent
    against bf16 weights: no one PyTorch call takes the pair, and the
    bound counts fp32 operations)."""
    out = out or dtype
    b_dtype = b_dtype or dtype
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    epi = Epilogue(residual=True) if residual else None

    def make(gen):
        res = _randn(gen, (m, n), dtype) if residual else None
        return (_randn(gen, sa, dtype), _randn(gen, sb, b_dtype, k ** -0.5),
                res)

    def ops_(a, b):
        return (a.t() if trans == "tn" else a, b.t() if trans == "nt" else b)

    def library(a, b, res):
        a, b = ops_(a, b)
        return torch.matmul(a, b) if res is None else torch.addmm(res, a, b)

    nbytes = (m * k * _size(dtype) + k * n * _size(b_dtype)
              + (m * n * _size(dtype) if residual else 0) + m * n * _size(out))
    return Case(
        "ftimm_gemm", label, make,
        lambda a, b, r: matmul(a, b, trans=trans, out_dtype=out,
                               epilogue=epi, residual=r),
        lambda a, b, r: K.ftimm_gemm_plain(a, b, trans=trans, out_dtype=out,
                                           epilogue=epi or K.IDENTITY,
                                           residual=r),
        library if b_dtype == dtype else None, nbytes, 2.0 * m * n * k,
        FP32 if FP32 in (dtype, b_dtype) else dtype, out, per_step, model,
        phase=phase, timed=timed)


def body_case(label, m, k, n, *, body, trans="nn", out=BF16, kslices=1,
              tile=(128, 128, 64), epi=None) -> Case:
    """``ftimm_gemm``'s tensor-core or stream body called directly (the
    planner may choose another at this shape), bf16 operands; ``epi`` with
    an (N,) fp32 bias or scale vector and a bf16 (M, N) residual."""
    epi = epi or K.IDENTITY
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    bm, bn, bk = tile

    def make(gen):
        vec = (_randn(gen, (n,), FP32) if epi.bias or epi.scale_vec
               else None)
        res = _randn(gen, (m, n), BF16) if epi.residual else None
        return (_randn(gen, sa, BF16), _randn(gen, sb, BF16, k ** -0.5),
                vec, res)

    def kw(vec, res):
        return dict(trans=trans, out_dtype=out, epilogue=epi,
                    bias=vec if epi.bias else None,
                    scale=vec if epi.scale_vec else None, residual=res)

    return Case(
        "ftimm_gemm", f"{body} {label}", make,
        lambda a, b, v, r: K.ftimm_gemm(a, b, bm=bm, bn=bn, bk=bk, body=body,
                                        kslices=kslices, **kw(v, r)),
        lambda a, b, v, r: K.ftimm_gemm_plain(a, b, **kw(v, r)),
        None, (m * k + k * n) * 2 + m * n * _size(out), 2.0 * m * n * k,
        BF16, out)


def splitk_case(label, m, k, n, nsplit, *, trans="tn", dtype=BF16,
                epilogue=False, entry_calls=0, timed=False,
                body="fma") -> Case:
    """The split-K kernel through ``ops.gemm(nsplit=...)`` on ``body``
    ("fma": the tile ``ops`` clamps to; "tc": the 128 x 128 tensor-core
    tile, K cut at its bk of 64); ``epilogue`` adds bias + silu +
    residual, applied after the sum."""
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    epi = (Epilogue(bias=True, activation="silu", residual=True) if epilogue
           else None)
    bm, bn, bk = (K.TC_TILES[0] if body == "tc"
                  else ops.clamp_tile(m, n, 128, 128))
    ns = ops.clamp_nsplit(k, bk, nsplit)

    def make(gen):
        extra = ((_randn(gen, (n,), FP32), _randn(gen, (m, n), dtype))
                 if epilogue else (None, None))
        return (_randn(gen, sa, dtype), _randn(gen, sb, dtype, k ** -0.5),
                *extra)

    def library(a, b, bias, res):
        a = a.t() if trans == "tn" else a
        b = b.t() if trans == "nt" else b
        return torch.matmul(a, b)

    nbytes = ((m * k + k * n + m * n) * _size(dtype)
              + ((4 * n + m * n * _size(dtype)) if epilogue else 0))
    return Case(
        "ftimm_gemm_splitk", f"{body} {label}", make,
        lambda a, b, bias, res: ops.gemm(a, b, bm=bm, bn=bn, bk=bk,
                                         trans=trans, nsplit=nsplit,
                                         epilogue=epi, bias=bias,
                                         residual=res, body=body),
        lambda a, b, bias, res: K.ftimm_gemm_splitk_plain(
            a, b, bk=bk, nsplit=ns, trans=trans, epilogue=epi or K.IDENTITY,
            bias=bias, residual=res, out_dtype=dtype),
        None if epilogue else library, nbytes, 2.0 * m * n * k, dtype, dtype,
        0, ARCH, "train", timed, entry_calls)


def _silu_mul(g, u, out):
    return (torch.nn.functional.silu(g.float()) * u.float()).to(out)


def _pair_matmul(x, wg, wu, out=None):
    """The dense pair through PyTorch: one ``matmul`` per panel, then
    silu(g) * u."""
    return _silu_mul(torch.matmul(x, wg), torch.matmul(x, wu), out or x.dtype)


def swiglu_case(label, m, k, n, *, dtype=BF16, per_step=0, phase="serve",
                timed=False, model=ARCH) -> Case:
    """The dense pair through ``matmul_swiglu`` (the planned body)."""
    def make(gen):
        return (_randn(gen, (m, k), dtype),
                _randn(gen, (k, n), dtype, k ** -0.5),
                _randn(gen, (k, n), dtype, k ** -0.5))

    return Case("ftimm_gemm_swiglu", label, make,
                lambda x, g, u: matmul_swiglu(x, g, u),
                lambda x, g, u: K.ftimm_gemm_swiglu_plain(x, g, u),
                None, (m * k + 2 * k * n + m * n) * _size(dtype),
                4.0 * m * n * k, dtype, dtype, per_step, model, phase=phase,
                timed=timed,
                yardstick=_pair_matmul if dtype == BF16 else None)


def swiglu_body_case(label, m, k, n, *, body, out=BF16, kslices=1,
                     dim_order="mn", phase="serve", timed=False) -> Case:
    """``ftimm_gemm_swiglu``'s ``body`` called directly on bf16 operands
    (the FMA body at the tile the planner gives it)."""
    fma = plan_gemm(m, k, n, 2, _size(out), panels=2, a_ok=False)
    bm, bn, bk = _body_tile(body, fma)

    def make(gen):
        return (_randn(gen, (m, k), BF16),
                _randn(gen, (k, n), BF16, k ** -0.5),
                _randn(gen, (k, n), BF16, k ** -0.5))

    return Case(
        "ftimm_gemm_swiglu", f"{body} {label}", make,
        lambda x, wg, wu: K.ftimm_gemm_swiglu(
            x, wg, wu, bm=bm, bn=bn, bk=bk, out_dtype=out, body=body,
            kslices=kslices, dim_order=dim_order),
        lambda x, wg, wu: K.ftimm_gemm_swiglu_plain(x, wg, wu, out_dtype=out),
        None, (m * k + 2 * k * n) * 2 + m * n * _size(out), 4.0 * m * n * k,
        BF16, out, phase=phase, timed=timed,
        yardstick=functools.partial(_pair_matmul, out=out))


def grouped_case(label, g, m, k, n, *, trans="nn", shared="none", dtype=FP32,
                 per_step=0, model=ARCH) -> Case:
    """fp32 (attention) or bf16 (the capacity-MoE down projection)."""
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]

    def make(gen):
        a = _randn(gen, sa if shared == "a" else (g,) + sa, dtype)
        b = _randn(gen, sb if shared == "b" else (g,) + sb, dtype, k ** -0.5)
        return a, b

    def library(a, b):
        a = a.transpose(-1, -2) if trans == "tn" else a
        b = b.transpose(-1, -2) if trans == "nt" else b
        return torch.bmm(a, b) if a.ndim == b.ndim == 3 else torch.matmul(a, b)

    ga, gb = (1 if shared == "a" else g), (1 if shared == "b" else g)
    return Case("ftimm_gemm_grouped", label, make,
                lambda a, b: batched_matmul(a, b, trans=trans,
                                            out_dtype=dtype),
                lambda a, b: K.ftimm_gemm_grouped_plain(a, b, trans=trans,
                                                        out_dtype=dtype),
                library, (ga * m * k + gb * k * n + g * m * n) * _size(dtype),
                2.0 * g * m * n * k, dtype, dtype, per_step, model)


def _pair_bmm(x, wg, wu, out=None):
    """The grouped pair through PyTorch: one ``bmm`` (a ``matmul`` for a
    shared 2-D x) per panel, then silu(g) * u."""
    mm = torch.bmm if x.ndim == 3 else torch.matmul
    return _silu_mul(mm(x, wg), mm(x, wu), out or x.dtype)


def _pair_grouped_mm(x, wg, wu, offs, out=None):
    """The ragged pair through PyTorch: one ``_grouped_mm`` per panel, then
    silu(g) * u (for calls whose every row a group owns)."""
    gm = functools.partial(torch._grouped_mm, offs=offs[1:])
    return _silu_mul(gm(x, wg), gm(x, wu), out or x.dtype)


def grouped_swiglu_case(label, g, m, k, n, *, shared=False, dtype=BF16,
                        per_step=0, model=MIXTRAL) -> Case:
    def make(gen):
        x = _randn(gen, (m, k) if shared else (g, m, k), dtype)
        return (x, _randn(gen, (g, k, n), dtype, k ** -0.5),
                _randn(gen, (g, k, n), dtype, k ** -0.5))

    gx = 1 if shared else g
    return Case("ftimm_gemm_grouped_swiglu", label, make,
                lambda x, wg, wu: grouped_swiglu(x, wg, wu),
                lambda x, wg, wu: K.ftimm_gemm_grouped_swiglu_plain(x, wg, wu),
                None, (gx * m * k + 2 * g * k * n + g * m * n) * _size(dtype),
                4.0 * g * m * n * k, dtype, dtype, per_step, model,
                yardstick=_pair_bmm if dtype == BF16 else None)


def grouped_swiglu_body_case(label, g, m, k, n, *, body, shared=False,
                             out=BF16, kslices=1, phase="serve",
                             timed=False) -> Case:
    """``ftimm_gemm_grouped_swiglu``'s ``body`` called directly on bf16
    operands (the FMA body at the tile the planner gives it)."""
    fma = plan_batched_gemm(g, m, k, n, 2, _size(out),
                            "a" if shared else "none", panels=2,
                            a_major=None)
    bm, bn, bk = _body_tile(body, fma)

    def make(gen):
        return (_randn(gen, (m, k) if shared else (g, m, k), BF16),
                _randn(gen, (g, k, n), BF16, k ** -0.5),
                _randn(gen, (g, k, n), BF16, k ** -0.5))

    gx = 1 if shared else g
    return Case(
        "ftimm_gemm_grouped_swiglu", f"{body} {label}", make,
        lambda x, wg, wu: K.ftimm_gemm_grouped_swiglu(
            x, wg, wu, bm=bm, bn=bn, bk=bk, out_dtype=out, body=body,
            kslices=kslices),
        lambda x, wg, wu: K.ftimm_gemm_grouped_swiglu_plain(x, wg, wu,
                                                            out_dtype=out),
        None, (gx * m * k + 2 * g * k * n) * 2 + g * m * n * _size(out),
        4.0 * g * m * n * k, BF16, out, model=MIXTRAL, phase=phase,
        timed=timed,
        yardstick=functools.partial(_pair_bmm, out=out))


def _body_tile(body: str, fma_plan) -> tuple[int, int, int]:
    if body == "tc":
        return K.GROUP_TC_TILE
    if body == "stream":
        return (K.GSTREAM_ROWS, K.STREAM_STRIP, 64)
    return fma_plan.bm, fma_plan.bn, fma_plan.bk


def grouped_body_case(label, g, m, k, n, *, body, trans="nn", shared="none",
                      out=BF16, kslices=1, epi=None, phase="serve",
                      timed=False) -> Case:
    """``ftimm_gemm_grouped``'s ``body`` called directly on bf16 operands
    (the FMA body at the tile the planner gives it); ``epi`` with (G, N)
    fp32 bias / scale vectors and a (G, M, N) bf16 residual."""
    epi = epi or K.IDENTITY
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    fma = plan_batched_gemm(g, m, k, n, 2, _size(out), shared, a_major=None)
    bm, bn, bk = _body_tile(body, fma)

    def make(gen):
        vec = (_randn(gen, (g, n), FP32) if epi.bias or epi.scale_vec
               else None)
        res = _randn(gen, (g, m, n), BF16) if epi.residual else None
        return (_randn(gen, sa if shared == "a" else (g,) + sa, BF16),
                _randn(gen, sb if shared == "b" else (g,) + sb, BF16,
                       k ** -0.5), vec, res)

    def kw(vec, res):
        return dict(trans=trans, out_dtype=out, epilogue=epi,
                    bias=vec if epi.bias else None,
                    scale=vec if epi.scale_vec else None, residual=res)

    def library(a, b, vec, res):
        a = a.transpose(-1, -2) if trans == "tn" else a
        b = b.transpose(-1, -2) if trans == "nt" else b
        return torch.bmm(a, b).to(out)

    ga, gb = (1 if shared == "a" else g), (1 if shared == "b" else g)
    return Case(
        "ftimm_gemm_grouped", f"{body} {label}", make,
        lambda a, b, v, r: K.ftimm_gemm_grouped(
            a, b, bm=bm, bn=bn, bk=bk, body=body, kslices=kslices,
            dim_order=fma.dim_order if body == "fma" else "mn", **kw(v, r)),
        lambda a, b, v, r: K.ftimm_gemm_grouped_plain(a, b, **kw(v, r)),
        library if epi.is_identity and shared == "none" else None,
        (ga * m * k + gb * k * n) * 2 + g * m * n * _size(out),
        2.0 * g * m * n * k, BF16, out, model=MIXTRAL, phase=phase,
        timed=timed)


def rows_body_case(label, g, m, k, n, *, trans, body, shared="none",
                   epi=None, per_step=0, model=ARCH,
                   timed=False) -> Case:
    """``ftimm_gemm_grouped``'s few-rows fp32 ``body`` ("rows" at its cut,
    ``rows_tile``; "fma" at the tile the planner gives the FMA body) called
    directly on fp32 operands laid out as the decode attention lays them
    out; ``epi`` with (G, N) fp32 vectors and a (G, M, N) fp32 residual.
    Its yardstick is ``torch.bmm`` on the same operands."""
    epi = epi or K.IDENTITY
    sa = (m, k)
    sb = (n, k) if trans == "nt" else (k, n)
    fma = plan_batched_gemm(g, m, k, n, 4, 4, shared, trans=trans,
                            b_rows=False)
    bm, bn, bk = (K.rows_tile(g, k, n, trans) if body == "rows"
                  else (fma.bm, fma.bn, fma.bk))

    def make(gen):
        vec = (_randn(gen, (g, n), FP32) if epi.bias or epi.scale_vec
               else None)
        res = _randn(gen, (g, m, n), FP32) if epi.residual else None
        return (_randn(gen, sa if shared == "a" else (g,) + sa, FP32),
                _randn(gen, sb if shared == "b" else (g,) + sb, FP32,
                       k ** -0.5), vec, res)

    def kw(vec, res):
        return dict(trans=trans, epilogue=epi,
                    bias=vec if epi.bias else None,
                    scale=vec if epi.scale_vec else None, residual=res)

    def library(a, b, vec, res):
        return torch.bmm(a, b.transpose(1, 2) if trans == "nt" else b)

    ga, gb = (1 if shared == "a" else g), (1 if shared == "b" else g)
    return Case(
        "ftimm_gemm_grouped", f"{body} {label}", make,
        lambda a, b, v, r: K.ftimm_gemm_grouped(
            a, b, bm=bm, bn=bn, bk=bk, body=body,
            dim_order=fma.dim_order if body == "fma" else "mn", **kw(v, r)),
        lambda a, b, v, r: K.ftimm_gemm_grouped_plain(a, b, **kw(v, r)),
        library if epi.is_identity and shared == "none" else None,
        (ga * m * k + gb * k * n + g * m * n) * 4, 2.0 * g * m * n * k,
        FP32, FP32, per_step, model, timed=timed)


def _offsets(sizes, device) -> torch.Tensor:
    return torch.tensor([0, *np.cumsum(sizes).tolist()], dtype=torch.int32,
                        device=device)


def _grouped_mm(x, w, offs, vec):
    """One PyTorch call for the ragged product, where this PyTorch has one
    and it takes these operands (``library_ms``; the port never calls it)."""
    return torch._grouped_mm(x, w, offs=offs[1:])


def ragged_case(label, sizes, k, n, *, trans="nn", dtype=BF16, epi=None,
                tail=0, per_step=0, model=LLAMA4) -> Case:
    """``sizes``: rows per group; ``tail`` more rows that no group owns."""
    g, t = len(sizes), sum(sizes) + tail
    w_shape = (g, k, n) if trans == "nn" else (g, n, k)
    vec_of = (lambda v, flag: v if flag else None)

    def make(gen):
        vec = _randn(gen, (g, n), FP32) if epi is not None else None
        return (_randn(gen, (t, k), dtype), _randn(gen, w_shape, dtype,
                                                    k ** -0.5),
                _offsets(sizes, gen.device), vec)

    def run(x, w, offs, vec):
        if epi is None and trans == "nn":
            return ragged_matmul(x, w, offs)
        return ops.ragged_gemm(x, w, offs, trans=trans, epilogue=epi,
                               bias=vec_of(vec, epi and epi.bias),
                               scale=vec_of(vec, epi and epi.scale_vec))

    def plain(x, w, offs, vec):
        return K.ftimm_gemm_ragged_plain(
            x, w, offs, trans=trans, epilogue=epi or K.IDENTITY,
            bias=vec_of(vec, epi and epi.bias),
            scale=vec_of(vec, epi and epi.scale_vec))

    touched = sum(1 for s in sizes if s)
    nbytes = ((t * k + touched * k * n + t * n) * _size(dtype)
              + (4 * g * n if epi is not None else 0))
    library = _grouped_mm if epi is None and trans == "nn" and not tail \
        else None
    return Case("ftimm_gemm_ragged", label, make, run, plain, library,
                nbytes, 2.0 * (t - tail) * k * n, dtype, dtype, per_step,
                model)


def ragged_body_case(label, sizes, k, n, *, body, trans="nn", out=BF16,
                     kslices=1, epi=None, tail=0, phase="serve",
                     timed=False) -> Case:
    """``ftimm_gemm_ragged``'s ``body`` called directly on bf16 operands
    (the FMA body at the tile the planner gives it); ``epi`` with (G, N)
    fp32 bias / scale vectors; ``tail`` more rows that no group owns."""
    g, t = len(sizes), sum(sizes) + tail
    epi = epi or K.IDENTITY
    w_shape = (g, k, n) if trans == "nn" else (g, n, k)
    fma = plan_ragged_gemm(g, t, k, n, 2, _size(out), a_ok=False)
    bm, bn, bk = _body_tile(body, fma)

    def make(gen):
        vec = (_randn(gen, (g, n), FP32) if epi.bias or epi.scale_vec
               else None)
        return (_randn(gen, (t, k), BF16),
                _randn(gen, w_shape, BF16, k ** -0.5),
                _offsets(sizes, gen.device), vec)

    def kw(vec):
        return dict(trans=trans, out_dtype=out, epilogue=epi,
                    bias=vec if epi.bias else None,
                    scale=vec if epi.scale_vec else None)

    touched = sum(1 for s in sizes if s)
    return Case(
        "ftimm_gemm_ragged", f"{body} {label}", make,
        lambda x, w, o, v: K.ftimm_gemm_ragged(
            x, w, o, bm=bm, bn=bn, bk=bk, body=body, kslices=kslices,
            **kw(v)),
        lambda x, w, o, v: K.ftimm_gemm_ragged_plain(x, w, o, **kw(v)),
        (lambda x, w, o, v: _grouped_mm(x, w, o, v).to(out))
        if epi.is_identity and trans == "nn" and not tail else None,
        (t * k + touched * k * n) * 2 + t * n * _size(out),
        2.0 * (t - tail) * k * n, BF16, out, model=LLAMA4, phase=phase,
        timed=timed)


def ragged_swiglu_case(label, sizes, k, n, *, dtype=BF16, tail=0,
                       per_step=0, model=LLAMA4) -> Case:
    g, t = len(sizes), sum(sizes) + tail

    def make(gen):
        return (_randn(gen, (t, k), dtype),
                _randn(gen, (g, k, n), dtype, k ** -0.5),
                _randn(gen, (g, k, n), dtype, k ** -0.5),
                _offsets(sizes, gen.device))

    touched = sum(1 for s in sizes if s)
    return Case("ftimm_gemm_ragged_swiglu", label, make,
                lambda x, wg, wu, o: ragged_swiglu(x, wg, wu, o),
                lambda x, wg, wu, o: K.ftimm_gemm_ragged_swiglu_plain(
                    x, wg, wu, o),
                None, (t * k + 2 * touched * k * n + t * n) * _size(dtype),
                4.0 * (t - tail) * k * n, dtype, dtype, per_step, model,
                yardstick=(_pair_grouped_mm if dtype == BF16 and not tail
                           else None))


def ragged_swiglu_body_case(label, sizes, k, n, *, body, out=BF16,
                            kslices=1, tail=0, phase="serve",
                            timed=False) -> Case:
    """``ftimm_gemm_ragged_swiglu``'s ``body`` called directly on bf16
    operands (the FMA body at the tile the planner gives it); ``tail`` more
    rows that no group owns."""
    g, t = len(sizes), sum(sizes) + tail
    fma = plan_ragged_gemm(g, t, k, n, 2, _size(out), panels=2, a_ok=False)
    bm, bn, bk = _body_tile(body, fma)

    def make(gen):
        return (_randn(gen, (t, k), BF16),
                _randn(gen, (g, k, n), BF16, k ** -0.5),
                _randn(gen, (g, k, n), BF16, k ** -0.5),
                _offsets(sizes, gen.device))

    touched = sum(1 for s in sizes if s)
    return Case(
        "ftimm_gemm_ragged_swiglu", f"{body} {label}", make,
        lambda x, wg, wu, o: K.ftimm_gemm_ragged_swiglu(
            x, wg, wu, o, bm=bm, bn=bn, bk=bk, out_dtype=out, body=body,
            kslices=kslices),
        lambda x, wg, wu, o: K.ftimm_gemm_ragged_swiglu_plain(
            x, wg, wu, o, out_dtype=out),
        None, (t * k + 2 * touched * k * n) * 2 + t * n * _size(out),
        4.0 * (t - tail) * k * n, BF16, out, model=LLAMA4, phase=phase,
        timed=timed,
        yardstick=(functools.partial(_pair_grouped_mm, out=out)
                   if not tail else None))


def ragged_dw_case(label, sizes, d, f, *, dtype=BF16, tail=0,
                   per_step=0) -> Case:
    """dW[g] = x[rows_g]^T dy[rows_g] through the planned ragged-K kernel;
    ``tail`` more rows that no group owns."""
    g, t = len(sizes), sum(sizes) + tail

    def make(gen):
        return (_randn(gen, (t, d), dtype), _randn(gen, (t, f), dtype),
                _offsets(sizes, gen.device))

    def run(x, dy, offs):
        x_mn, dy_mn = K.ragged_dw_operands_mn(x, dy)
        plan = plan_ragged_gemm(g, t, d, f, _size(dtype), _size(dtype),
                                ragged="k", a_ok=x_mn, b_ok=dy_mn)
        return ops.ragged_gemm_dw(x, dy, offs, bm=plan.bm, bn=plan.bn,
                                  bk=plan.bk, body=plan.body)

    def library(x, dy, offs):
        return torch._grouped_mm(x.t(), dy, offs=offs[1:])

    return Case("ftimm_gemm_ragged_dw", label, make, run,
                lambda x, dy, o: K.ftimm_gemm_ragged_dw_plain(x, dy, o),
                None if tail else library,
                (t * d + t * f + g * d * f) * _size(dtype),
                2.0 * (t - tail) * d * f, dtype, dtype, per_step, LLAMA4,
                "train")


def train_cases() -> list[Case]:
    """The two backward kernels at the training shapes (seq 128 x batch 8
    = 1024 tokens): the llama4-scout expert dW (its gate / up and down
    panels, with the launches of one 1-layer train step) under random
    top-1 routing, and the split-K kernel on its tensor-core and FMA
    bodies at the T2 dW shapes of qwen3-1.7b (q / o and gate / up
    projections) and of the llama4-scout router, with ``ftimm_gemm``
    (nsplit 1) and ``torch.matmul`` at the same qwen shapes beside it; and
    qwen3-1.7b's gate/up pair at the 1024 training rows on the tensor cores
    and the FMA body."""
    l4, qw = get_config(LLAMA4), get_config(ARCH)
    e, d, f = l4.num_experts, l4.d_model, l4.d_ff
    routed = np.random.default_rng(7).multinomial(
        TRAIN_TOKENS, [1.0 / e] * e).tolist()
    cases = [ragged_dw_case("llama4 train gate/up dW", routed, d, f,
                            per_step=2),
             ragged_dw_case("llama4 train down dW", routed, f, d, per_step=1)]
    # The expert-down forward of training on the tensor cores and on the
    # FMA body: mixtral's capacity 320, llama4's 1024 routed rows.
    mix = get_config(MIXTRAL)
    c = MOE.capacity(TRAIN_TOKENS, mix.num_experts, mix.top_k,
                     mix.capacity_factor, dtype=BF16)
    for body in ("tc", "fma"):
        cases += [grouped_body_case(
                      f"mixtral train down C={c}", mix.num_experts, c,
                      mix.d_ff, mix.d_model, body=body, phase="train",
                      timed=True),
                  ragged_body_case(f"llama4 train down T={TRAIN_TOKENS}",
                                   routed, f, d, body=body, phase="train",
                                   timed=True),
                  grouped_swiglu_body_case(
                      f"mixtral train gate/up C={c}", mix.num_experts, c,
                      mix.d_model, mix.d_ff, body=body, phase="train",
                      timed=True),
                  ragged_swiglu_body_case(
                      f"llama4 train gate/up T={TRAIN_TOKENS}", routed, d, f,
                      body=body, phase="train", timed=True)]
    dq, fq = qw.d_model, qw.d_ff
    order = plan_gemm(TRAIN_TOKENS, dq, fq, 2, 2, panels=2).dim_order
    for body in ("tc", "fma"):
        cases.append(swiglu_body_case(
            f"qwen train gate/up {TRAIN_TOKENS}", TRAIN_TOKENS, dq, fq,
            body=body, dim_order=order, phase="train", timed=True))
    # The kernels line times split-K's tensor-core body at nsplit 4.
    for n in (dq, fq):
        for body in ("tc", "fma"):
            for ns in (2, 4, 8):
                cases.append(splitk_case(
                    f"qwen train dW {dq}x{n} nsplit {ns}", dq, TRAIN_TOKENS,
                    n, ns, entry_calls=int(ns == 4 and body == "tc"),
                    timed=True, body=body))
        cases.append(dense_case(f"qwen train dW {dq}x{n} nsplit 1", dq,
                                TRAIN_TOKENS, n, trans="tn", phase="train",
                                timed=True))
    for body in ("tc", "fma"):
        for ns in (2, 4, 8):
            cases.append(splitk_case(f"llama4 router dW {d}x{e} nsplit {ns}",
                                     d, TRAIN_TOKENS, e, ns, body=body))
    t, v = TRAIN_TOKENS, qw.vocab_padded
    cases += [
        dense_case(f"qwen train fwd q/o {t}x{dq}x{dq}", t, dq, dq,
                   phase="train", timed=True),
        dense_case(f"qwen train fwd down {t}x{fq}x{dq}", t, fq, dq,
                   phase="train", timed=True),
        dense_case(f"qwen train unembed {t}x{dq}x{v}", t, dq, v, trans="nt",
                   out=FP32, phase="train", timed=True),
        # the fp32 logits' cotangent against the bf16 table: FMA body
        dense_case(f"qwen train unembed dX fp32 x bf16 {t}x{v}x{dq}", t, v,
                   dq, dtype=FP32, b_dtype=BF16, out=BF16, phase="train",
                   timed=True)]
    return cases


def main_path_cases(cfg, view_len: int, bucket: int) -> list[Case]:
    """Every GEMM shape of one qwen3-1.7b decode step at SLOTS slots (with
    its launch count), and of one bucket prefill."""
    d, f, v, n_layers = cfg.d_model, cfg.d_ff, cfg.vocab_padded, cfg.num_layers
    hq, hkv = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_
    hd, groups = cfg.head_dim_, SLOTS * cfg.num_kv_heads
    qpg = cfg.num_heads // cfg.num_kv_heads        # query rows per kv head
    rows = SLOTS * bucket
    return [
        dense_case("decode q", SLOTS, d, hq, per_step=n_layers),
        dense_case("decode k/v", SLOTS, d, hkv, per_step=2 * n_layers),
        dense_case("decode o+res", SLOTS, hq, d, residual=True,
                   per_step=n_layers),
        dense_case("decode down+res", SLOTS, f, d, residual=True,
                   per_step=n_layers),
        dense_case("decode unembed", SLOTS, d, v, trans="nt", out=FP32,
                   per_step=1),
        swiglu_case("decode gate/up", SLOTS, d, f, per_step=n_layers),
        swiglu_body_case("decode gate/up", SLOTS, d, f, body="fma",
                         timed=True),
        grouped_case("decode qk^T", groups, qpg, hd, view_len, trans="nt",
                     per_step=n_layers),
        grouped_case("decode pv", groups, qpg, view_len, hd,
                     per_step=n_layers),
        dense_case("prefill q", rows, d, hq),
        dense_case("prefill k/v", rows, d, hkv),
        dense_case("prefill o+res", rows, hq, d, residual=True),
        dense_case("prefill down+res", rows, f, d, residual=True),
        swiglu_case("prefill gate/up bucket 32", SLOTS * 32, d, f,
                    timed=True),
        swiglu_case(f"prefill gate/up bucket {bucket}", rows, d, f,
                    timed=True),
        grouped_case("prefill qk^T", groups, bucket * qpg, hd, bucket,
                     trans="nt"),
        grouped_case("prefill pv", groups, bucket * qpg, bucket, hd),
    ]


def moe_path_cases() -> list[Case]:
    """The expert GEMMs of the two MoE models: one decode step at SLOTS
    slots (with its launch count at MOE_LAYERS layers) and the bucket
    prefills of the serving run, plus their router products."""
    mix, l4 = get_config(MIXTRAL), get_config(LLAMA4)
    cases = []
    e, d, f = mix.num_experts, mix.d_model, mix.d_ff
    for label, t in (("decode", SLOTS), ("bucket 32", SLOTS * 32),
                     ("bucket 64", SLOTS * 64)):
        c = MOE.capacity(t, e, mix.top_k, mix.capacity_factor, dtype=BF16)
        steps = MOE_LAYERS if label == "decode" else 0
        cases += [
            dense_case(f"mixtral {label} router", t, d, e, out=FP32),
            grouped_swiglu_case(f"mixtral {label} gate/up C={c}", e, c, d, f,
                                per_step=steps),
            grouped_case(f"mixtral {label} down C={c}", e, c, f, d,
                         dtype=BF16, per_step=steps, model=MIXTRAL)]
        if label == "decode":   # the FMA body beside the planned stream
            cases += [grouped_body_case(f"mixtral decode down C={c}", e, c,
                                        f, d, body="fma", timed=True),
                      grouped_swiglu_body_case(
                          f"mixtral decode gate/up C={c}", e, c, d, f,
                          body="fma", timed=True)]
    e, d, f = l4.num_experts, l4.d_model, l4.d_ff
    decode = [1 if i % 4 == 0 else 0 for i in range(e)]   # 4 distinct
    bucket = np.random.default_rng(5).multinomial(
        SLOTS * 64, [1.0 / e] * e).tolist()
    for label, sizes, steps in (("decode 4 experts", decode, MOE_LAYERS),
                                ("bucket 64", bucket, 0)):
        cases += [
            dense_case(f"llama4 {label} router", sum(sizes), d, e, out=FP32),
            ragged_swiglu_case(f"llama4 {label} gate/up", sizes, d, f,
                               per_step=steps),
            ragged_case(f"llama4 {label} down", sizes, f, d, per_step=steps)]
    cases += [ragged_body_case("llama4 decode 4 experts down", decode, f, d,
                               body="fma", timed=True),
              ragged_swiglu_body_case("llama4 decode 4 experts gate/up",
                                      decode, d, f, body="fma", timed=True)]
    return cases


def recurrent_path_cases() -> list[Case]:
    """Every GEMM shape of one decode step of mamba2-370m and zamba2-7b at
    SLOTS slots on the dense-slot rung (with its launch count at full
    depth), and of their exact-length prefills of REC_PREFILL_ROWS tokens:
    the SSM in / out projections (N = 4384 and 14576 end in a 32- and a
    112-column edge tile), the unembed, and zamba2's shared block -- q, k,
    v, o + residual, the gate/up pair, down + residual and the fp32 QK^T /
    PV at head_dim 112 -- applied after each of its 13 groups."""
    cases = []
    for arch in RECURRENT:
        cfg = get_config(arch)
        d, layers, tag = cfg.d_model, cfg.num_layers, arch.split("-")[0]
        di, heads, n = ssm_dims(d, cfg.ssm_state)
        groups = layers // cfg.attn_every if cfg.attn_every else 0
        for rows in (SLOTS,) + REC_PREFILL_ROWS:
            label = (f"{tag} decode" if rows == SLOTS
                     else f"{tag} prefill {rows}")
            dec = rows == SLOTS
            cases += [
                dense_case(f"{label} in_proj", rows, d, 2 * di + 2 * n + heads,
                           per_step=layers if dec else 0, model=arch),
                dense_case(f"{label} out_proj", rows, di, d,
                           per_step=layers if dec else 0, model=arch)]
            if not groups:
                continue
            hd, h = cfg.head_dim_, cfg.num_heads
            qkv = cfg.num_heads * hd
            cases += [
                dense_case(f"{label} shared q/k/v", rows, d, qkv,
                           per_step=3 * groups if dec else 0, model=arch),
                dense_case(f"{label} shared o+res", rows, qkv, d,
                           residual=True, per_step=groups if dec else 0,
                           model=arch),
                swiglu_case(f"{label} shared gate/up", rows, d, cfg.d_ff,
                            per_step=groups if dec else 0, model=arch),
                dense_case(f"{label} shared down+res", rows, cfg.d_ff, d,
                           residual=True, per_step=groups if dec else 0,
                           model=arch)]
            if dec:     # one query row a head over the whole slot cache
                cases += [
                    grouped_case(f"{label} shared qk^T", SLOTS * h, 1, hd,
                                 REC_MAX_LEN, trans="nt", per_step=groups,
                                 model=arch),
                    grouped_case(f"{label} shared pv", SLOTS * h, 1,
                                 REC_MAX_LEN, hd, per_step=groups,
                                 model=arch)]
            else:       # one prompt: one group a head
                cases += [
                    grouped_case(f"{label} shared qk^T", h, rows, hd, rows,
                                 trans="nt", model=arch),
                    grouped_case(f"{label} shared pv", h, rows, rows, hd,
                                 model=arch)]
        cases += [dense_case(f"{tag} decode unembed", SLOTS, d,
                             cfg.vocab_padded, trans="nt", out=FP32,
                             per_step=1, model=arch),
                  dense_case(f"{tag} prefill unembed", 1, d,
                             cfg.vocab_padded, trans="nt", out=FP32,
                             model=arch)]
    return cases


def family_path_cases() -> list[Case]:
    """Every GEMM shape of one decode step of whisper-base (full depth, the
    dense-slot rung, REC_MAX_LEN-row slot caches) and llava-next-34b
    (FAM_LAYERS[LLAVA] layers, the paged rung) at SLOTS slots, with its
    launch count, and their prefill shapes: whisper's frame projection,
    encoder projections and cross K / V over the 1500 encoder rows (a
    92-row edge on 128-row tiles), the encoder's non-causal fp32 QK^T / PV
    (two 1024-row KV blocks, the second padded), the cross-attention decode
    (1 row over those blocks, G = SLOTS x 8 heads) and the unembed's N =
    51872 (a 32-column edge tile); llava's patch projection (576 rows, and
    SLOTS x 576 in a bucket prefill), its projections and pair at 600 and
    SLOTS x 608 rows (a 32-bucket prefill), its decode over the 896-row
    paged view (576 patches + REC_MAX_LEN), 7 query heads a KV group."""
    wh, ll = get_config(WHISPER), get_config(LLAVA)
    d, f, layers = wh.d_model, wh.d_ff, wh.num_layers
    hd, heads = wh.head_dim_, wh.num_heads
    enc = wh.encoder_seq
    block = min(1024, enc)                    # the port's KV block
    cases = [
        dense_case("whisper decode q/k/v (self), q (cross)", SLOTS, d, d,
                   per_step=4 * layers, model=WHISPER),
        dense_case("whisper decode o+res (self, cross)", SLOTS, d, d,
                   residual=True, per_step=2 * layers, model=WHISPER),
        dense_case("whisper decode down+res", SLOTS, f, d, residual=True,
                   per_step=layers, model=WHISPER),
        dense_case(f"whisper decode unembed N={wh.vocab_padded}", SLOTS, d,
                   wh.vocab_padded, trans="nt", out=FP32, per_step=1,
                   model=WHISPER),
        swiglu_case("whisper decode gate/up", SLOTS, d, f, per_step=layers,
                    model=WHISPER),
        grouped_case("whisper decode self qk^T", SLOTS * heads, 1, hd,
                     REC_MAX_LEN, trans="nt", per_step=layers,
                     model=WHISPER),
        grouped_case("whisper decode self pv", SLOTS * heads, 1,
                     REC_MAX_LEN, hd, per_step=layers, model=WHISPER),
        grouped_case(f"whisper decode cross qk^T {block}-row block",
                     SLOTS * heads, 1, hd, block, trans="nt",
                     per_step=2 * layers, model=WHISPER),
        grouped_case(f"whisper decode cross pv {block}-row block",
                     SLOTS * heads, 1, block, hd, per_step=2 * layers,
                     model=WHISPER),
        dense_case(f"whisper frame_proj / enc q/k/v/o / cross k/v {enc}",
                   enc, d, d, model=WHISPER),
        dense_case(f"whisper encoder down+res {enc}", enc, f, d,
                   residual=True, model=WHISPER),
        swiglu_case(f"whisper encoder gate/up {enc}", enc, d, f,
                    model=WHISPER),
        grouped_case(f"whisper encoder qk^T {enc}x{block}", heads, enc, hd,
                     block, trans="nt", model=WHISPER),
        grouped_case(f"whisper encoder pv {enc}x{block}", heads, enc, block,
                     hd, model=WHISPER),
        dense_case(f"whisper prefill unembed N={wh.vocab_padded}", 1, d,
                   wh.vocab_padded,
                   trans="nt", out=FP32, model=WHISPER)]
    d, f, layers = ll.d_model, ll.d_ff, FAM_LAYERS[LLAVA]
    hq, hkv = ll.num_heads * ll.head_dim_, ll.num_kv_heads * ll.head_dim_
    qpg, p = ll.num_heads // ll.num_kv_heads, ll.num_patches
    view = math.ceil((REC_MAX_LEN + p) / PAGE) * PAGE
    bucket_rows = SLOTS * (p + 32)
    cases += [
        dense_case("llava decode q", SLOTS, d, hq, per_step=layers,
                   model=LLAVA),
        dense_case("llava decode k/v", SLOTS, d, hkv, per_step=2 * layers,
                   model=LLAVA),
        dense_case("llava decode o+res", SLOTS, hq, d, residual=True,
                   per_step=layers, model=LLAVA),
        dense_case("llava decode down+res", SLOTS, f, d, residual=True,
                   per_step=layers, model=LLAVA),
        dense_case("llava decode unembed", SLOTS, d, ll.vocab_padded,
                   trans="nt", out=FP32, per_step=1, model=LLAVA),
        swiglu_case("llava decode gate/up", SLOTS, d, f, per_step=layers,
                    model=LLAVA),
        grouped_case(f"llava decode qk^T {view}-row view",
                     SLOTS * ll.num_kv_heads, qpg, ll.head_dim_, view,
                     trans="nt", per_step=layers, model=LLAVA),
        grouped_case(f"llava decode pv {view}-row view",
                     SLOTS * ll.num_kv_heads, qpg, view, ll.head_dim_,
                     per_step=layers, model=LLAVA),
        dense_case(f"llava patch_proj {p}", p, d, d, model=LLAVA),
        dense_case(f"llava patch_proj {SLOTS}x{p}", SLOTS * p, d, d,
                   model=LLAVA),
        dense_case(f"llava prefill q {p + 24}", p + 24, d, hq, model=LLAVA),
        dense_case(f"llava prefill k/v {bucket_rows}", bucket_rows, d, hkv,
                   model=LLAVA),
        swiglu_case(f"llava prefill gate/up {p + 24}", p + 24, d, f,
                    model=LLAVA),
        swiglu_case(f"llava prefill gate/up {bucket_rows}", bucket_rows, d,
                    f, model=LLAVA)]
    return cases


def rows_shapes() -> list[tuple[str, str, int, int, int, int]]:
    """(label, model, G, M, head_dim, cache rows) of the decode attention
    products at SLOTS slots that PERF.md's rows 2, 2r, 2e, 2v and 2g
    time: qwen3-1.7b over its 96-row paged view, zamba2-7b's shared block
    and whisper-base's self-attention over the REC_MAX_LEN-row slot cache,
    whisper's cross-attention over one 1024-row block of its encoder rows,
    llava-next-34b over its 896-row view (7 query heads a KV group) and
    gemma3-4b over its 1,120-row view (head_dim 256)."""
    q, z, w, ll, gm = (get_config(a) for a in (ARCH, ZAMBA, WHISPER, LLAVA,
                                                GEMMA))

    def kv(cfg, model, view, label):
        return (label, model, SLOTS * cfg.num_kv_heads,
                cfg.num_heads // cfg.num_kv_heads, cfg.head_dim_, view)

    return [
        kv(q, ARCH, math.ceil(MAX_LEN / PAGE) * PAGE, "qwen3-1.7b"),
        kv(z, ZAMBA, REC_MAX_LEN, "zamba2-7b shared"),
        kv(w, WHISPER, REC_MAX_LEN, "whisper-base self"),
        kv(w, WHISPER, min(1024, w.encoder_seq), "whisper-base cross"),
        kv(ll, LLAVA, math.ceil((REC_MAX_LEN + ll.num_patches) / PAGE)
           * PAGE, "llava-next-34b"),
        kv(gm, GEMMA, ARCH_MAX_LEN[GEMMA], "gemma3-4b")]


def rows_path_cases() -> list[Case]:
    """Each decode attention product of ``rows_shapes``, QK^T ("nt") and PV
    ("nn"), on the rows body and on the FMA body, held against the plain
    version; the FMA body is timed beside the path's own planned calls --
    the rows body, the per-step cases of the phases' case lists -- and
    their ``torch.bmm``."""
    cases = []
    for label, model, g, m, hd, view in rows_shapes():
        for trans, k, n, what in (("nt", hd, view, "qk^T"),
                                  ("nn", view, hd, "pv")):
            for body in ("rows", "fma"):
                cases.append(rows_body_case(
                    f"{label} decode {what} G={g} M={m} {view} rows", g, m,
                    k, n, trans=trans, body=body, model=model,
                    timed=body == "fma"))
    return cases


def rows_edge_cases() -> list[Case]:
    """The rows body at extents that are no multiple of its widths: 1, 3, 7
    and 8 rows a group, a head_dim row of 132 floats (two float4s a lane,
    the second past the row for most lanes) over 261 cache rows, both
    trans; K slices on both (head_dim 300 in "nt", 300 cache rows in "nn")
    with each epilogue field and (G, N) vectors; a shared 2-D operand."""
    cases = []
    for trans in ("nt", "nn"):
        for m in (1, 3, 7, 8):
            k, n = (132, 261) if trans == "nt" else (261, 132)
            cases.append(rows_body_case(f"5x{m}x{k}x{n} {trans}", 5, m, k, n,
                                        trans=trans, body="rows"))
        for label, epi in NEW_BODY_EPILOGUES:
            cases.append(rows_body_case(f"3x3x300x200 {trans} (G,N) {label}",
                                        3, 3, 300, 200, trans=trans,
                                        body="rows", epi=epi))
        for shared in ("a", "b"):
            cases.append(rows_body_case(f"4x2x128x200 {trans} shared {shared}",
                                        4, 2, 128, 200, trans=trans,
                                        body="rows", shared=shared))
    return cases


def check_decode_bodies(cases: list[Case], dev) -> dict:
    """Each bf16 decode GEMM of the recurrent path, or of whisper's and
    llava's ([families]) (``ftimm_gemm`` and the dense pair at SLOTS rows),
    through the dispatch layer: it must take the stream body and agree with
    its plain version."""
    gen = torch.Generator(device=dev).manual_seed(4)
    seen = {}
    for c in cases:
        if c.per_step == 0 or c.dtype != BF16:
            continue
        inputs = c.make(gen)
        K.reset_launch_counts()
        got = c.run(*inputs)
        rel, _ = rel_err(got, c.plain(*inputs))
        bodies = {b: v for b, v in K.body_counts()[c.kernel].items() if v}
        seen[c.label] = bodies
        if bodies != {"stream": 1} or rel > TOL[c.out_dtype]:
            raise AssertionError(f"{c.label}: bodies {bodies}, normwise "
                                 f"{rel:.3g}")
    log(f"  {len(seen)} decode shapes through dispatch: all on the stream "
        "body")
    return seen


def edge_cases() -> list[Case]:
    """Unaligned shapes, every trans, the epilogues, the shared operand,
    and the ragged distributions."""
    cases = []
    for trans in ("nn", "tn", "nt"):
        for dtype in (BF16, FP32):
            cases.append(dense_case(f"33x257x65 {trans} {dtype}", 33, 257,
                                    65, trans=trans, dtype=dtype))
        cases.append(grouped_case(f"5x33x129x65 {trans} shared a", 5, 33,
                                  129, 65, trans=trans, shared="a"))
        cases.append(grouped_case(f"5x33x129x65 {trans} shared b", 5, 33,
                                  129, 65, trans=trans, shared="b"))
    cases.append(dense_case("33x257x65 residual", 33, 257, 65,
                            residual=True))
    cases.append(dense_case("33x257x65 bf16->fp32", 33, 257, 65, out=FP32))
    cases.append(swiglu_case("33x257x65", 33, 257, 65))
    cases.append(swiglu_case("33x257x65 fp32", 33, 257, 65, dtype=FP32))
    cases.append(grouped_case("5x33x129x65 bf16", 5, 33, 129, 65, dtype=BF16))
    for dtype in (BF16, FP32):
        cases.append(grouped_swiglu_case(f"5x33x129x65 {dtype}", 5, 33, 129,
                                         65, dtype=dtype))
        cases.append(grouped_swiglu_case(f"5x33x129x65 shared x {dtype}", 5,
                                         33, 129, 65, shared=True,
                                         dtype=dtype))
    dists = (("all rows to one group", [0, 37, 0, 0], 0),
             ("empty groups, T=25", [5, 0, 17, 3, 0], 0),
             ("one group over 9 tiles", [3, 150, 2], 0),
             ("4 rows outside every group", [5, 0, 17, 3], 4))
    for label, sizes, tail in dists:
        for dtype in (BF16, FP32):
            cases.append(ragged_case(f"{label} {dtype}", sizes, 257, 96,
                                     dtype=dtype, tail=tail))
            cases.append(ragged_swiglu_case(f"{label} {dtype}", sizes, 257,
                                            96, dtype=dtype, tail=tail))
    for dtype in (BF16, FP32):
        cases.append(ragged_case(f"nt, empty groups {dtype}",
                                 [5, 0, 17, 3, 0], 257, 96, trans="nt",
                                 dtype=dtype))
    for label, epi in (("(G,N) bias", Epilogue(bias=True)),
                       ("(G,N) scale, scalar scale, silu",
                        Epilogue(scale_vec=True, scale=0.5,
                                 activation="silu")),
                       ("(G,N) bias, gelu", Epilogue(bias=True,
                                                     activation="gelu"))):
        cases.append(ragged_case(label, [5, 0, 17, 3, 0], 257, 96, epi=epi))
    cases.append(ragged_case("(G,N) bias fp32", [5, 0, 17, 3, 0], 257, 96,
                             epi=Epilogue(bias=True), dtype=FP32))
    for label, sizes, tail in dists + (("balanced", [16, 16, 16, 16], 0),
                                       ("T = 0", [0, 0, 0], 0)):
        for dtype in (BF16, FP32):
            cases.append(ragged_dw_case(f"{label} {dtype}", sizes, 257, 96,
                                        dtype=dtype, tail=tail))
    for trans in ("nn", "tn", "nt"):
        for dtype in (BF16, FP32):
            for ns in (2, 4, 8):
                cases.append(splitk_case(f"33x257x65 {trans} {dtype} nsplit "
                                         f"{ns}", 33, 257, 65, ns,
                                         trans=trans, dtype=dtype))
            cases.append(splitk_case(f"33x257x65 {trans} {dtype} bias+silu"
                                     "+residual nsplit 4", 33, 257, 65, 4,
                                     trans=trans, dtype=dtype, epilogue=True))
    for body in ("fma", "tc"):
        cases.append(splitk_case("qwen train dW 2048x2048 bias+silu+residual"
                                 " nsplit 4", 2048, TRAIN_TOKENS, 2048, 4,
                                 epilogue=True, body=body))
    cases += new_body_cases()
    cases += pair_and_splitk_body_cases()
    return cases


def pair_and_splitk_body_cases() -> list[Case]:
    """The dense pair's stream and tensor-core bodies and split-K's
    tensor-core body called directly: K = 1032 and N = 264 (a K tail, a
    partial last strip and tile), both outputs; the pair's stream at 1 / 4
    / 16 rows and 1, 3 and 8 K slices, its tensor cores at 17 and 200 rows
    in both grid orders; split-K at every trans, nsplit 2 / 4 / 8 and 40
    (more splits than K steps), with the bias + silu + residual
    epilogue after the sum.  Then the pair at qwen3-1.7b's home shapes:
    the 4 decode rows on the stream at 1-16 slices and on the FMA body,
    the bucket prefills' 128 and 256 rows on the tensor cores."""
    k, n, cases = 1032, 264, []
    for out in (BF16, FP32):
        o = _name(out)
        for m in (1, 4, 16):
            for ks in (1, 3, 8):
                cases.append(swiglu_body_case(
                    f"pair {m}x{k}x{n} {ks} slices ->{o}", m, k, n,
                    body="stream", out=out, kslices=ks))
        for m in (17, 200):
            for order in ("mn", "nm"):
                cases.append(swiglu_body_case(
                    f"pair {m}x{k}x{n} {order} ->{o}", m, k, n, body="tc",
                    out=out, dim_order=order))
    for trans in ("nn", "tn", "nt"):
        for ns in (2, 4, 8, 40):
            cases.append(splitk_case(f"200x{k}x{n} {trans} nsplit {ns}", 200,
                                     k, n, ns, trans=trans, body="tc"))
        cases.append(splitk_case(f"200x{k}x{n} {trans} bias+silu+residual "
                                 "nsplit 4", 200, k, n, 4, trans=trans,
                                 epilogue=True, body="tc"))
    qw = get_config(ARCH)
    d, f = qw.d_model, qw.d_ff
    for ks in (1, 2, 4, 8, 16):
        cases.append(swiglu_body_case(f"qwen decode gate/up {ks} slices",
                                      SLOTS, d, f, body="stream", kslices=ks))
    cases.append(swiglu_body_case("qwen decode gate/up", SLOTS, d, f,
                                  body="fma"))
    for m in (SLOTS * 32, SLOTS * 64):
        cases.append(swiglu_body_case(f"qwen prefill gate/up {m}", m, d, f,
                                      body="tc"))
    return cases


NEW_BODY_EPILOGUES = (
    ("residual", Epilogue(residual=True)),
    ("bias+silu", Epilogue(bias=True, activation="silu")),
    ("bias+gelu+scale+residual", Epilogue(bias=True, activation="gelu",
                                          scale=0.5, residual=True)),
    ("scale_vec", Epilogue(scale_vec=True)))


def new_body_cases() -> list[Case]:
    """The tensor-core and stream bodies of ftimm_gemm and the
    tensor-core ragged dW at extents that are not tile multiples (every
    stride still a multiple of 16 bytes): every trans, both outputs, both
    tensor-core tiles, 1 / 4 / 16 rows and 1 or 3 K slices on the stream
    (with a short last slice and a partial last strip), the epilogues;
    the ragged dW's distributions at aligned widths."""
    cases = []
    for trans in ("nn", "tn", "nt"):
        for out in (BF16, FP32):
            for tile in K.TC_TILES:
                for m, k, n in ((40, 264, 72), (200, 1032, 264)):
                    cases.append(body_case(
                        f"{m}x{k}x{n} {trans} ->{_name(out)} {tile[1]}", m, k, n,
                        body="tc", trans=trans, out=out, tile=tile))
            for m in (1, 4, 16):
                for kslices, k in ((1, 520), (3, 1032)):
                    cases.append(body_case(
                        f"{m}x{k}x520 {trans} ->{_name(out)} {kslices} slices", m,
                        k, 520, body="stream", trans=trans, out=out,
                        kslices=kslices))
    for label, epi in NEW_BODY_EPILOGUES:
        for out in (BF16, FP32):
            cases.append(body_case(f"200x520x264 {label} ->{_name(out)}", 200, 520,
                                   264, body="tc", out=out, epi=epi))
            cases.append(body_case(f"4x1032x264 {label} ->{_name(out)} 5 slices",
                                   4, 1032, 264, body="stream", out=out,
                                   kslices=5, epi=epi))
    for label, sizes, tail in (("all rows to one group", [0, 37, 0, 0], 0),
                               ("empty groups", [5, 0, 17, 3, 0], 0),
                               ("one group over 9 tiles", [3, 150, 2], 0),
                               ("skewed", [0, 200, 1, 0, 0, 0, 0, 55], 0),
                               ("singleton", [1], 0),
                               ("rows outside every group", [5, 0, 17, 3], 4),
                               ("T = 0", [0, 0, 0], 0)):
        cases.append(ragged_dw_case(f"{label} 264x520 bf16", sizes, 264, 520,
                                    tail=tail))
    return cases + group_body_cases()


def group_body_cases() -> list[Case]:
    """The tensor-core and stream bodies of the grouped and ragged kernels
    and of their SwiGLU pairs called directly: K = 1032 and N = 264 not
    multiples of the 64-deep box or the 128-column tile (a K tail at every
    group's edge), every trans each body takes, a shared 2-D operand, both
    outputs, 1 / 4 / 16 rows a group and 1 or 3 K slices on the stream,
    (G, N) vectors and the residual at the flush; the ragged distributions
    (empty groups, a group of exactly 16 rows, rows outside every group,
    one group over several chunks); then both bodies and the FMA body at
    the MoE home shapes."""
    k, n, cases = 1032, 264, []
    for out in (BF16, FP32):
        o = _name(out)
        for trans in ("nn", "tn", "nt"):
            for shared in ("none", "a", "b"):
                cases.append(grouped_body_case(
                    f"5x200x{k}x{n} {trans} shared {shared} ->{o}", 5, 200,
                    k, n, body="tc", trans=trans, shared=shared, out=out))
        for trans in ("nn", "nt"):
            for m in (1, 4, 16):
                for ks in (1, 3):
                    cases.append(grouped_body_case(
                        f"5x{m}x{k}x{n} {trans} {ks} slices ->{o}", 5, m, k,
                        n, body="stream", trans=trans, out=out, kslices=ks))
            for shared in ("a", "b"):
                cases.append(grouped_body_case(
                    f"5x16x{k}x{n} {trans} shared {shared} ->{o}", 5, 16, k,
                    n, body="stream", trans=trans, shared=shared, out=out))
        for label, epi in NEW_BODY_EPILOGUES:
            for body, m, ks in (("tc", 200, 1), ("stream", 16, 3)):
                cases.append(grouped_body_case(
                    f"3x{m}x{k}x{n} (G,N) {label} ->{o}", 3, m, k, n,
                    body=body, out=out, kslices=ks, epi=epi))
        stream_dists = (("4 rows to 4 groups", [1, 0, 0, 1, 0, 1, 1, 0], 0),
                        ("a group of 16 rows", [0, 16, 0], 0),
                        ("empty groups", [5, 0, 7, 3, 0], 0),
                        ("rows outside every group", [2, 0, 3], 4))
        tc_dists = (("one group over 2 chunks", [3, 150, 2], 0),
                    ("skewed", [0, 200, 1, 0, 0, 0, 0, 55], 0),
                    ("rows outside every group", [40, 0, 88], 7))
        for trans in ("nn", "nt"):
            for body, dists in (("stream", stream_dists), ("tc", tc_dists)):
                for label, sizes, tail in dists:
                    for ks in ((1, 3) if body == "stream" else (1,)):
                        cases.append(ragged_body_case(
                            f"{label} {k}x{n} {trans} {ks} slices ->{o}",
                            sizes, k, n, body=body, trans=trans, out=out,
                            kslices=ks, tail=tail))
        for label, epi in NEW_BODY_EPILOGUES:
            if epi.residual:
                continue
            for body, sizes in (("stream", [5, 0, 7, 3, 0]),
                                ("tc", [3, 150, 2, 0])):
                cases.append(ragged_body_case(
                    f"(G,N) {label} {k}x{n} ->{o}", sizes, k, n, body=body,
                    out=out, kslices=2, epi=epi))
        cases += pair_body_cases(k, n, out)
    mix, l4 = get_config(MIXTRAL), get_config(LLAMA4)
    decode = [1 if i % 4 == 0 else 0 for i in range(l4.num_experts)]
    routed = np.random.default_rng(7).multinomial(
        TRAIN_TOKENS, [1.0 / l4.num_experts] * l4.num_experts).tolist()
    bucket = np.random.default_rng(5).multinomial(
        SLOTS * 64, [1.0 / l4.num_experts] * l4.num_experts).tolist()
    e, d, f = mix.num_experts, mix.d_model, mix.d_ff
    d4, f4 = l4.d_model, l4.d_ff
    for body in ("stream", "tc", "fma"):
        cases += [grouped_body_case("mixtral decode down C=16", e, 16, f, d,
                                    body=body),
                  ragged_body_case("llama4 decode 4 experts down", decode,
                                   f4, d4, body=body),
                  grouped_swiglu_body_case("mixtral decode gate/up C=16", e,
                                           16, d, f, body=body),
                  ragged_swiglu_body_case("llama4 decode 4 experts gate/up",
                                          decode, d4, f4, body=body)]
    cases += [grouped_body_case("mixtral train down C=320", e, 320, f, d,
                                body="tc"),
              ragged_body_case(f"llama4 train down T={TRAIN_TOKENS}", routed,
                               f4, d4, body="tc")]
    for c in (48, 80, 320):
        cases.append(grouped_swiglu_body_case(f"mixtral gate/up C={c}", e, c,
                                              d, f, body="tc"))
    for label, sizes in (("bucket 64", bucket), (f"T={TRAIN_TOKENS}", routed)):
        cases.append(ragged_swiglu_body_case(f"llama4 gate/up {label}",
                                             sizes, d4, f4, body="tc"))
    return cases


def pair_body_cases(k: int, n: int, out) -> list[Case]:
    """The SwiGLU pairs' stream and tensor-core bodies at K = k, N = n:
    1 / 4 / 16 rows a group at 1 and 3 K slices on the stream, 16 and 200
    rows on the tensor cores, each with its own x and with a shared 2-D x;
    the ragged distributions of the one-panel bodies."""
    cases, o = [], _name(out)
    for m, body, slices in ([(m, "stream", ks) for m in (1, 4, 16)
                             for ks in (1, 3)]
                            + [(16, "tc", 1), (200, "tc", 1)]):
        for shared in (False, True):
            cases.append(grouped_swiglu_body_case(
                f"pair 5x{m}x{k}x{n} {slices} slices{' shared x' * shared}"
                f" ->{o}", 5, m, k, n, body=body, shared=shared, out=out,
                kslices=slices))
    dists = {"stream": (("4 rows to 4 groups", [1, 0, 0, 1, 0, 1, 1, 0], 0),
                        ("a group of 16 rows", [0, 16, 0], 0),
                        ("empty groups", [5, 0, 7, 3, 0], 0),
                        ("rows outside every group", [2, 0, 3], 4)),
             "tc": (("one group over 2 chunks", [3, 150, 2], 0),
                    ("skewed", [0, 200, 1, 0, 0, 0, 0, 55], 0),
                    ("rows outside every group", [40, 0, 88], 7))}
    for body, cuts in dists.items():
        for label, sizes, tail in cuts:
            for ks in ((1, 3) if body == "stream" else (1,)):
                cases.append(ragged_swiglu_body_case(
                    f"pair {label} {k}x{n} {ks} slices ->{o}", sizes, k, n,
                    body=body, out=out, kslices=ks, tail=tail))
    return cases


def check_bodies(dev) -> dict:
    """The planner's body choice through the dispatch layer, and what the
    new bodies promise: a misaligned operand takes the FMA body; 4 rows the
    stream, 200 the tensor cores; the stream and the tensor-core ragged dW
    give bit-identical reruns."""
    gen = torch.Generator(device=dev).manual_seed(3)
    a = _randn(gen, (200, 2056), BF16)
    b = _randn(gen, (2048, 2048), BF16, 2048 ** -0.5)
    seen = {}
    for label, x in (("misaligned A (base + 2 bytes)", a[:, 1:2049]),
                     ("4 rows", a[:4, :2048]), ("200 rows", a[:, :2048])):
        K.reset_launch_counts()
        got = matmul(x, b)
        want = K.ftimm_gemm_plain(x, b)
        torch.cuda.synchronize()
        rel, _ = rel_err(got, want)
        bodies = {k: v for k, v in K.body_counts()["ftimm_gemm"].items() if v}
        seen[label] = bodies
        log(f"  {label}: bodies {bodies}, normwise {rel:.2e}")
        if rel > TOL[BF16]:
            raise AssertionError(f"{label}: normwise {rel:.3g}")
    want = {"misaligned A (base + 2 bytes)": {"fma": 1}, "4 rows": {"stream": 1},
            "200 rows": {"tc": 1}}
    if seen != want:
        raise AssertionError(f"planned bodies {seen}, expected {want}")
    x, w = _randn(gen, (4, 6144), BF16), _randn(gen, (6144, 2048), BF16)
    dw = ragged_dw_case("rerun", np.random.default_rng(7).multinomial(
        TRAIN_TOKENS, [1 / 16] * 16).tolist(), 5120, 8192)
    xs, dy, offs = dw.make(gen)
    K.reset_launch_counts()
    runs = [matmul(x, w, out_dtype=FP32) for _ in range(3)]
    dws = [dw.run(xs, dy, offs) for _ in range(2)]
    torch.cuda.synchronize()
    bodies = K.body_counts()
    if (bodies["ftimm_gemm"]["stream"] != 3
            or bodies["ftimm_gemm_ragged_dw"]["tc"] != 2):
        raise AssertionError(f"reruns took the bodies {bodies}")
    if not all(torch.equal(r, runs[0]) for r in runs[1:]):
        raise AssertionError("the stream body's reruns differ")
    if not torch.equal(dws[0], dws[1]):
        raise AssertionError("the tensor-core ragged dW's reruns differ")
    log("  stream (4 x 6144 x 2048) x3 and tensor-core ragged dW (llama4 "
        "gate/up) x2: bit-identical reruns")
    seen.update(check_group_bodies(gen))
    seen.update(check_rows_body(gen))
    seen.update(check_pair_and_splitk(gen))
    return seen


def check_pair_and_splitk(gen) -> dict:
    """qwen3-1.7b's gate/up pair through the dispatch layer: its 4 decode
    rows plan the group stream, 128 and 1024 rows the tensor cores, fp32
    the FMA body.  Then two runs of the pair's stream (1 and 4 K slices)
    and tensor cores, and of split-K's tensor-core body at qwen's dW shape
    (nsplit 2, 4, 8), give the same bits."""
    qw = get_config(ARCH)
    d, f = qw.d_model, qw.d_ff
    seen, want = {}, {}
    for rows, dtype, body in ((SLOTS, BF16, "stream"), (128, BF16, "tc"),
                              (TRAIN_TOKENS, BF16, "tc"),
                              (SLOTS, FP32, "fma")):
        c = swiglu_case("", rows, d, f, dtype=dtype)
        inputs = c.make(gen)
        K.reset_launch_counts()
        got = c.run(*inputs)
        rel, _ = rel_err(got, c.plain(*inputs))
        label = f"qwen gate/up {rows} rows {_name(dtype)}"
        seen[label] = {k: v for k, v in
                       K.body_counts()["ftimm_gemm_swiglu"].items() if v}
        want[label] = {body: 1}
        log(f"  ftimm_gemm_swiglu {label}: bodies {seen[label]}, normwise "
            f"{rel:.2e}")
        if rel > TOL[dtype]:
            raise AssertionError(f"ftimm_gemm_swiglu {label}: normwise "
                                 f"{rel:.3g}")
        del inputs, got
    if seen != want:
        raise AssertionError(f"planned bodies {seen}, expected {want}")
    reruns = [swiglu_body_case("qwen decode gate/up", SLOTS, d, f,
                               body="stream", kslices=ks) for ks in (1, 4)]
    reruns += [swiglu_body_case(f"qwen train gate/up {TRAIN_TOKENS}",
                                TRAIN_TOKENS, d, f, body="tc",
                                dim_order=order) for order in ("mn", "nm")]
    reruns += [splitk_case(f"qwen train dW {d}x{f} nsplit {ns}", d,
                           TRAIN_TOKENS, f, ns, body="tc")
               for ns in (2, 4, 8)]
    K.reset_launch_counts()
    for c in reruns:
        inputs = c.make(gen)
        runs = [c.run(*inputs) for _ in range(2)]
        torch.cuda.synchronize()
        if not torch.equal(runs[0], runs[1]):
            raise AssertionError(f"{c.kernel} {c.label}: reruns differ")
        del inputs, runs
    bodies = K.body_counts()
    if (bodies["ftimm_gemm_swiglu"] != {"fma": 0, "tc": 4, "stream": 4}
            or bodies["ftimm_gemm_splitk"] != {"fma": 0, "tc": 6}):
        raise AssertionError(f"reruns took the bodies {bodies}")
    log(f"  {len(reruns)} dense-pair stream / tensor-core and split-K "
        "tensor-core calls at qwen's shapes: bit-identical reruns")
    return seen


def check_group_bodies(gen) -> dict:
    """The grouped and ragged kernels and their SwiGLU pairs through the
    dispatch layer: bf16 mixtral expert buffers of 16 rows a group plan the
    stream, 320 the tensor cores, fp32 the FMA body; llama4's 4 routed rows
    the stream, 1024 the tensor cores.  Then two runs of each new body at
    the home shapes (the stream at 1 and 4 K slices) give the same bits."""
    mix, l4 = get_config(MIXTRAL), get_config(LLAMA4)
    e, f, d = mix.num_experts, mix.d_ff, mix.d_model
    routed = np.random.default_rng(7).multinomial(
        TRAIN_TOKENS, [1.0 / l4.num_experts] * l4.num_experts).tolist()
    decode = [1 if i % 4 == 0 else 0 for i in range(l4.num_experts)]
    seen, want = {}, {}
    for label, c, dtype, body in (("mixtral C=16 bf16", 16, BF16, "stream"),
                                  ("mixtral C=320 bf16", 320, BF16, "tc"),
                                  ("mixtral C=16 fp32", 16, FP32, "fma")):
        a = _randn(gen, (e, c, f), dtype)
        b = _randn(gen, (e, f, d), dtype, f ** -0.5)
        K.reset_launch_counts()
        got = grouped_matmul(a, b)
        rel, _ = rel_err(got, K.ftimm_gemm_grouped_plain(a, b))
        seen[label] = {k: v for k, v in
                       K.body_counts()["ftimm_gemm_grouped"].items() if v}
        want[label] = {body: 1}
        log(f"  grouped {label}: bodies {seen[label]}, normwise {rel:.2e}")
        if rel > TOL[dtype]:
            raise AssertionError(f"grouped {label}: normwise {rel:.3g}")
        del a, b, got
    for label, sizes, body in (("llama4 T=4", decode, "stream"),
                               (f"llama4 T={TRAIN_TOKENS}", routed, "tc")):
        x = _randn(gen, (sum(sizes), l4.d_ff), BF16)
        w = _randn(gen, (l4.num_experts, l4.d_ff, l4.d_model), BF16,
                   l4.d_ff ** -0.5)
        offs = _offsets(sizes, gen.device)
        K.reset_launch_counts()
        got = ragged_matmul(x, w, offs)
        rel, _ = rel_err(got, K.ftimm_gemm_ragged_plain(x, w, offs))
        seen[label] = {k: v for k, v in
                       K.body_counts()["ftimm_gemm_ragged"].items() if v}
        want[label] = {body: 1}
        log(f"  ragged {label}: bodies {seen[label]}, normwise {rel:.2e}")
        if rel > TOL[BF16]:
            raise AssertionError(f"ragged {label}: normwise {rel:.3g}")
        del x, w, got
    pairs = (("mixtral gate/up C=16 bf16",
              grouped_swiglu_case("", e, 16, d, f), "stream"),
             ("mixtral gate/up C=320 bf16",
              grouped_swiglu_case("", e, 320, d, f), "tc"),
             ("mixtral gate/up C=16 fp32",
              grouped_swiglu_case("", e, 16, d, f, dtype=FP32), "fma"),
             ("llama4 gate/up T=4", ragged_swiglu_case(
                 "", decode, l4.d_model, l4.d_ff), "stream"),
             (f"llama4 gate/up T={TRAIN_TOKENS}", ragged_swiglu_case(
                 "", routed, l4.d_model, l4.d_ff), "tc"))
    for label, c, body in pairs:
        inputs = c.make(gen)
        K.reset_launch_counts()
        got = c.run(*inputs)
        rel, _ = rel_err(got, c.plain(*inputs))
        seen[label] = {k: v for k, v in K.body_counts()[c.kernel].items()
                       if v}
        want[label] = {body: 1}
        log(f"  {c.kernel} {label}: bodies {seen[label]}, normwise "
            f"{rel:.2e}")
        if rel > TOL[c.out_dtype]:
            raise AssertionError(f"{c.kernel} {label}: normwise {rel:.3g}")
        del inputs, got
    if seen != want:
        raise AssertionError(f"planned bodies {seen}, expected {want}")
    reruns = [grouped_body_case("mixtral decode down C=16", e, 16, f, d,
                                body="stream", kslices=ks) for ks in (1, 4)]
    reruns += [ragged_body_case("llama4 decode down", decode, l4.d_ff,
                                l4.d_model, body="stream", kslices=ks)
               for ks in (1, 4)]
    reruns += [grouped_body_case("mixtral train down C=320", e, 320, f, d,
                                 body="tc"),
               ragged_body_case(f"llama4 train down T={TRAIN_TOKENS}", routed,
                                l4.d_ff, l4.d_model, body="tc")]
    for ks in (1, 4):
        reruns += [grouped_swiglu_body_case("mixtral decode gate/up C=16", e,
                                            16, d, f, body="stream",
                                            kslices=ks),
                   ragged_swiglu_body_case("llama4 decode gate/up", decode,
                                           l4.d_model, l4.d_ff,
                                           body="stream", kslices=ks)]
    reruns += [grouped_swiglu_body_case("mixtral train gate/up C=320", e,
                                        320, d, f, body="tc"),
               ragged_swiglu_body_case(f"llama4 train gate/up T={TRAIN_TOKENS}",
                                       routed, l4.d_model, l4.d_ff,
                                       body="tc")]
    for c in reruns:
        inputs = c.make(gen)
        runs = [c.run(*inputs) for _ in range(2)]
        torch.cuda.synchronize()
        if not torch.equal(runs[0], runs[1]):
            raise AssertionError(f"{c.kernel} {c.label}: reruns differ")
        del inputs, runs
    log(f"  {len(reruns)} grouped / ragged (and SwiGLU pair) stream and "
        "tensor-core calls at the home shapes: bit-identical reruns")
    return seen


def check_rows_body(gen) -> dict:
    """The grouped kernel's rows body through the dispatch layer and what
    it promises.  qwen3-1.7b's and llava's decode QK^T / PV, their K / V
    laid out as ``models.attention`` lays them out, plan the rows body; 9
    rows a group and a cache whose rows are not 16-byte aligned plan the
    FMA body.  Then: reruns bit-identical (one K slice and several, both
    trans), and NaN past K in either operand -- A's columns or B's rows /
    elements past K -- stays out."""
    cfg = get_config(ARCH)
    seen, want = {}, {}
    b, kvh, hd = SLOTS, cfg.num_kv_heads, cfg.head_dim_
    cache = _randn(gen, (b, 96, kvh, hd), BF16)

    def cache_rows(c):      # as models.attention._bmm_qk / _bmm_pv
        return c.to(FP32).permute(0, 2, 1, 3).reshape(b * kvh, -1, hd)

    for label, m, kf in (
            ("qwen decode, 2 rows", 2, cache_rows(cache)),
            ("llava-like, 7 rows", 7, cache_rows(cache)),
            ("9 rows", 9, cache_rows(cache)),
            ("rows 8 bytes off", 2, torch.empty(
                b * kvh * 96 * hd + 2, dtype=FP32,
                device=gen.device)[2:].view(b * kvh, 96, hd).copy_(
                    cache_rows(cache)))):
        q = _randn(gen, (b * kvh, m, hd), FP32)
        planned = "rows" if m <= K.ROWS_MAX and kf.data_ptr() % 16 == 0 \
            else "fma"
        for trans, a, bb in (("nt", q, kf), ("nn", None, kf)):
            if a is None:
                a = _randn(gen, (b * kvh, m, kf.shape[1]), FP32)
            K.reset_launch_counts()
            got = batched_matmul(a, bb, trans=trans, out_dtype=FP32)
            rel, _ = rel_err(got, K.ftimm_gemm_grouped_plain(a, bb,
                                                             trans=trans))
            key = f"rows {label} {trans}"
            seen[key] = {k: v for k, v in
                         K.body_counts()["ftimm_gemm_grouped"].items() if v}
            want[key] = {planned: 1}
            if rel > TOL[FP32]:
                raise AssertionError(f"{key}: normwise {rel:.3g}")
    if seen != want:
        raise AssertionError(f"planned bodies {seen}, expected {want}")
    log(f"  rows body through dispatch: {seen}")
    reruns = 0
    for g, m, k, n, trans in ((32, 2, 128, 96, "nt"), (32, 2, 96, 128, "nn"),
                              (16, 2, 1120, 256, "nn"),
                              (3, 5, 600, 257, "nt"), (32, 7, 896, 128, "nn")):
        c = rows_body_case("", g, m, k, n, trans=trans, body="rows")
        inputs = c.make(gen)
        runs = [c.run(*inputs) for _ in range(3)]
        torch.cuda.synchronize()
        if not all(torch.equal(r, runs[0]) for r in runs[1:]):
            raise AssertionError(f"rows {g}x{m}x{k}x{n} {trans}: reruns "
                                 "differ")
        reruns += 1
    nan = {}
    for trans in ("nt", "nn"):
        for side in ("a", "b"):
            g, m, k, n = 4, 3, 300, 200
            a = _randn(gen, (g, m, k), FP32)
            bb = _randn(gen, (g, n, k) if trans == "nt" else (g, k, n), FP32,
                        k ** -0.5)
            if side == "a":
                pad = torch.full((g, m, k + 8), float("nan"),
                                 device=gen.device)
                pad[..., :k] = a
                a = pad[..., :k]
            elif trans == "nt":
                pad = torch.full((g, n, k + 8), float("nan"),
                                 device=gen.device)
                pad[..., :k] = bb
                bb = pad[..., :k]
            else:
                pad = torch.full((g, k + 5, n), float("nan"),
                                 device=gen.device)
                pad[:, :k] = bb
                bb = pad[:, :k]
            for tile in (K.rows_tile(g, k, n, trans),
                         (K.ROWS_MAX, 64, 64) if trans == "nt"
                         else (K.ROWS_MAX, 128, 70)):
                got = K.ftimm_gemm_grouped(a, bb, bm=tile[0], bn=tile[1],
                                           bk=tile[2], trans=trans,
                                           body="rows")
                rel, _ = rel_err(got, K.ftimm_gemm_grouped_plain(
                    a, bb, trans=trans))
                key = f"NaN past K in {side.upper()} {trans} {tile}"
                nan[key] = rel
                if not bool(torch.isfinite(got).all()) or rel > TOL[FP32]:
                    raise AssertionError(f"rows {key}: normwise {rel:.3g}")
    log(f"  rows body: {reruns} shapes' reruns bit-identical; NaN past K in "
        f"either operand stays out ({len(nan)} calls, worst normwise "
        f"{max(nan.values()):.1e})")
    return seen


def check(cases: list[Case], dev) -> dict[str, float]:
    """Every case's kernel against its plain version; max abs error per
    kernel.  Raises on a mismatch."""
    worst: dict[str, float] = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for c in cases:
        inputs = c.make(gen)
        got = c.run(*inputs)
        want = c.plain(*inputs)
        torch.cuda.synchronize()
        rel, err = rel_err(got, want)
        if got.dtype != c.out_dtype or rel > TOL[c.out_dtype]:
            raise AssertionError(f"{c.kernel} {c.label}: normwise error "
                                 f"{rel:.3g} > {TOL[c.out_dtype]} "
                                 f"({got.dtype})")
        worst[c.kernel] = max(worst.get(c.kernel, 0.0), err)
        log(f"  ok  {c.kernel:25s} {c.label:40s} normwise {rel:.2e}")
        del inputs, got, want
    return worst


def library_ms(c: Case, fn, inputs, reps,
               sleep_ms) -> tuple[float | None, str]:
    """The time of ``fn``, the case's library call (or its yardstick), or
    None and why: it must run on these operands and agree with the plain
    version."""
    if fn is None:
        return None, "no single PyTorch call computes this function"
    try:
        got = fn(*inputs[0])
    except (RuntimeError, TypeError, ValueError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    rel, _ = rel_err(got, c.plain(*inputs[0]))
    if rel > max(TOL.get(got.dtype, 0.0), TOL[c.out_dtype]):
        return None, f"disagrees with the plain version (normwise {rel:.2e})"
    return time_ms(fn, inputs, reps, sleep_ms), ""


def timings(cases: list[Case], dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(2)
    sleep_ms = sleep_ms_per_mcycle()
    rows = []
    for c in cases:
        if not (c.per_step or c.timed):
            continue
        copies = min(max(math.ceil(3 * L2_BYTES / c.nbytes), 1), 64)
        inputs = [c.make(gen) for _ in range(copies)]
        reps = max(20, copies)
        t_bytes = c.nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = c.flops / PEAK_FLOPS[c.dtype] * 1e3
        lib, why = library_ms(c, c.library, inputs, reps, sleep_ms)
        if why:
            log(f"  {c.kernel} {c.label}: library_ms null ({why})")
        yard, ywhy = library_ms(c, c.yardstick, inputs, reps, sleep_ms)
        if c.yardstick is not None and ywhy:
            log(f"  {c.kernel} {c.label}: yardstick_ms null ({ywhy})")
        rows.append({
            "kernel": c.kernel, "label": c.label, "model": c.model,
            "phase": c.phase, "per_step": c.per_step,
            "entry_calls": c.entry_calls,
            "ms": time_ms(c.run, inputs, reps, sleep_ms),
            "plain_ms": time_ms(c.plain, inputs, reps, sleep_ms),
            "library_ms": lib, "library_note": why or None,
            "yardstick_ms": yard, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops})
        del inputs
        free_card()
    return rows


# ---------------------------------------------------------------------------
# References
# ---------------------------------------------------------------------------

def small_reference(dev, arch: str = ARCH,
                    layers: int | None = None) -> None:
    """``arch``-smoke (at ``layers`` layers) in fp32: the kernels on the
    card against the plain versions on the CPU, same weights."""
    cfg = dataclasses.replace(get_config(arch + "-smoke"),
                              compute_dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    cpu_model = M.init_params(cfg, 0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    toks = np.random.default_rng(3).integers(2, cfg.vocab_size, (2, 12))
    out = {}
    for name, model, device in (("cpu", cpu_model, CPU),
                                ("gpu", gpu_model, dev)):
        batch = {"tokens": torch.as_tensor(toks).to(device),
                 **frontend(cfg, 2, device)}
        logits, _ = M.prefill(model, cfg, batch,
                              M.make_cache(cfg, 2, 12, device=device))
        prompts = [np.asarray(p, np.int32) for p in toks] + [toks[0, :5]]
        reqs = ServeEngine(cfg, model, batch_slots=2, max_len=32,
                           device=device).run(
            [Request(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)])
        out[name] = (logits.cpu(), [r.out_tokens for r in reqs])
    rel, _ = rel_err(out["gpu"][0], out["cpu"][0])
    if rel > 1e-4:
        raise AssertionError(f"{cfg.name} prefill logits: normwise "
                             f"{rel:.3g}")
    if out["gpu"][1] != out["cpu"][1]:
        raise AssertionError(f"{cfg.name} tokens differ: {out['gpu'][1]} "
                             f"vs {out['cpu'][1]}")
    log(f"  {cfg.name} ({cfg.num_layers} layers) fp32 reference: logits "
        f"normwise {rel:.2e}, {sum(map(len, out['gpu'][1]))} tokens "
        "identical")


def frontend(cfg, b: int, device, seed: int = 9) -> dict:
    """The stub frontends' inputs of ``b`` rows, N(0, 0.02^2) from ``seed``
    (the same on every device): ``frames`` (encdec), ``patch_embeds``
    (vlm); nothing for the other families."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "encdec":
        out["frames"] = (cfg.encoder_seq, cfg.d_model)
    if cfg.num_patches:
        out["patch_embeds"] = (cfg.num_patches, cfg.d_model)
    return {k: torch.as_tensor(rng.standard_normal((b,) + shape).astype(
        np.float32) * 0.02).to(device) for k, shape in out.items()}


def moe_reference(arch: str, dev) -> dict:
    """``arch`` in fp32 at full width and REF_LAYERS layers: a 20-token
    prefill of 2 prompts and two decode steps on the card (the kernels) and
    on the CPU (the plain versions), same weights.  Every layer's expert
    choices must be equal, then the logits within MOE_REF_TOL normwise."""
    cfg = dataclasses.replace(get_config(arch), num_layers=REF_LAYERS,
                              compute_dtype="float32")
    t0 = time.monotonic()
    gpu_model = M.init_params(cfg, 0, device=dev)
    cpu_model = copy.deepcopy(gpu_model).to(CPU)
    rng = np.random.default_rng(6)
    prompt = rng.integers(2, cfg.vocab_size, (2, 20))
    nxt = rng.integers(2, cfg.vocab_size, (2, 2))
    runs = {}
    router = MOE._router
    for name, model, device in (("gpu", gpu_model, dev),
                                ("cpu", cpu_model, CPU)):
        choices = []

        def recording(x, w, e, k, _sink=choices):
            out = router(x, w, e, k)
            _sink.append(out[1].cpu())
            return out

        MOE._router = recording
        try:
            t1 = time.monotonic()
            cache = M.make_cache(cfg, 2, 24, device=device)
            logits, cache = M.prefill(
                model, cfg, {"tokens": torch.as_tensor(prompt).to(device)},
                cache)
            out = [logits.cpu()]
            for step in range(2):
                logits, cache = M.decode_step(
                    model, cfg, torch.as_tensor(nxt[:, step:step + 1]).to(
                        device), cache, 20 + step)
                out.append(logits.cpu())
            secs = time.monotonic() - t1
        finally:
            MOE._router = router
        runs[name] = (out, choices, secs)
    del gpu_model, cpu_model
    free_card()
    (g_out, g_choice, g_s), (c_out, c_choice, c_s) = runs["gpu"], runs["cpu"]
    if len(g_choice) != 3 * REF_LAYERS or len(g_choice) != len(c_choice):
        raise AssertionError(f"{arch}: {len(g_choice)} / {len(c_choice)} "
                             "router calls recorded")
    for i, (a, b) in enumerate(zip(g_choice, c_choice)):
        if not torch.equal(a, b):
            raise AssertionError(f"{arch}: router call {i} chose other "
                                 f"experts on the card: {a.tolist()} vs "
                                 f"{b.tolist()}")
    rel = max(rel_err(a, b)[0] for a, b in zip(g_out, c_out))
    if rel > MOE_REF_TOL:
        raise AssertionError(f"{arch} fp32 reference: logits normwise "
                             f"{rel:.3g} > {MOE_REF_TOL}")
    tokens = sum(int(c.numel()) for c in g_choice)
    log(f"  {arch} fp32, {REF_LAYERS} layers, full width: "
        f"{len(g_choice)} router calls, {tokens} expert choices equal; "
        f"logits normwise {rel:.2e} (card {g_s:.1f} s, CPU {c_s:.1f} s, "
        f"{time.monotonic() - t0:.1f} s in all)")
    return {"router_calls": len(g_choice), "expert_choices": tokens,
            "logits_normwise": rel}


def full_width_reference(engine: ServeEngine, dev) -> float:
    """One prompt's full-width prefill logits: kernels on the card against
    the plain versions on the CPU, same weights."""
    cfg, model = engine.cfg, engine.params
    toks = np.random.default_rng(4).integers(2, cfg.vocab_size, (1, 24))
    gpu, _ = M.prefill(model, cfg, {"tokens": torch.as_tensor(toks).to(dev)},
                       M.make_cache(cfg, 1, 24, device=dev))
    gpu = gpu.cpu()
    model.to("cpu")
    t0 = time.monotonic()
    cpu, _ = M.prefill(model, cfg, {"tokens": torch.as_tensor(toks)},
                       M.make_cache(cfg, 1, 24, device=CPU))
    rel, _ = rel_err(gpu, cpu)
    log(f"  full-width prefill logits, card vs plain on the CPU "
        f"({time.monotonic() - t0:.1f} s): normwise {rel:.2e}, argmax "
        f"{int(gpu.argmax())} vs {int(cpu.argmax())}")
    if rel > 5e-2:
        raise AssertionError(f"full-width logits: normwise {rel:.3g}")
    return rel


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def serve(arch: str, dev) -> tuple[dict, ServeEngine, dict]:
    """Serve ``arch`` at full width (MOE_LAYERS layers for the MoE models)
    through ServeEngine; the launch counts of just this run."""
    cfg = get_config(arch)
    if arch != ARCH:
        cfg = dataclasses.replace(cfg, num_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    model = M.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    moe = (f", {cfg.num_experts} experts top-{cfg.top_k} "
           f"({cfg.moe_dispatch})" if cfg.family == "moe" else "")
    log(f"  {arch}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim_}, "
        f"d_ff {cfg.d_ff}{moe}, vocab {cfg.vocab_size}, windows "
        f"{cfg.window_pattern}; init {time.monotonic() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    engine = ServeEngine(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN,
                         page_size=PAGE, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]

    K.reset_launch_counts()
    t0 = time.monotonic()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = K.launch_counts()
    bodies = K.body_counts()
    decode = list(engine.walls["decode"])
    prefill = {}
    for bkt, s in engine.walls["prefill"]:
        prefill.setdefault(bkt, []).append(s)

    for r in reqs:
        if not r.done or r.timed_out or len(r.out_tokens) != NEW_TOKENS:
            raise AssertionError(f"{arch} request {r.rid} did not finish: "
                                 f"{len(r.out_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{arch} request {r.rid}: token out of "
                                 "range")
    if any(engine.faults.values()):
        raise AssertionError(f"{arch} engine faults: {engine.faults}")
    missing = [k for k in PATH_KERNELS[("serve", arch)] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{arch}: {missing} never launched: {launches}")
    engine.alloc.check()

    # Outside the timed run: serve the first prompts again for a few tokens
    # with every kernel call recorded; each ftimm_gemm of a decode step
    # (SLOTS rows) must take the stream body.  The plans are a function of
    # the shapes, so the timed run's decode steps took the same bodies.
    again = [Request(rid=len(reqs) + i, prompt=r.prompt, max_new_tokens=3)
             for i, r in enumerate(reqs[:SLOTS])]
    with CallRecorder() as recorder:
        engine.run(again)
    by_rows = gemm_calls_by_rows_and_body(recorder)
    decode_bodies = {b: n for (m, b), n in by_rows.items() if m <= SLOTS}
    if set(decode_bodies) != {"stream"}:
        raise AssertionError(f"{arch} decode GEMMs took the bodies "
                             f"{decode_bodies}, not only the stream")
    # Each bf16 expert launch (gate/up pair and down) of at most 16 rows (a
    # group: mixtral's decode capacity; in all: llama4's SLOTS routed decode
    # rows) on the stream, of more (the bucket prefills) on the tensor
    # cores; fp32 attention on the rows body at decode (at most ROWS_MAX
    # rows a group), on the FMA body in the prefills.  So too qwen's dense
    # gate/up pair: its SLOTS decode rows on the stream, the prefills' on
    # the tensor cores.
    expert = group_calls_by_body(recorder)
    for (kernel, pair, rows, body), n in expert.items():
        planned = (fp32_group_body(kernel, pair, rows) if pair != "bf16"
                   else "stream" if rows <= K.GSTREAM_ROWS else "tc")
        if body != planned:
            raise AssertionError(f"{arch}: {kernel} {pair} calls of {rows} "
                                 f"rows took the {body} body ({expert})")
    # ... and so did the timed run: its bf16 pair launches took the stream
    # (decode) and the tensor cores (prefill), none the FMA body.
    pair = {ARCH: "ftimm_gemm_swiglu", MIXTRAL: "ftimm_gemm_grouped_swiglu",
            LLAMA4: "ftimm_gemm_ragged_swiglu"}[arch]
    if not (bodies[pair]["stream"] and bodies[pair]["tc"]
            and not bodies[pair]["fma"]):
        raise AssertionError(f"{arch}: {pair} bodies {bodies[pair]}")

    tokens = sum(len(r.out_tokens) for r in reqs)
    stats = {"layers": cfg.num_layers, "requests": len(reqs),
             "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall, "decode_steps": len(decode),
             "decode_step_median_ms": statistics.median(decode[1:]) * 1e3,
             "prefill_ms": {str(b): [s * 1e3 for s in v]
                            for b, v in sorted(prefill.items())},
             "peak_device_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
             "buckets": list(engine.buckets),
             "view_len": engine.kv.table.shape[1] * PAGE,
             "launches": launches, "bodies": bodies,
             "ftimm_gemm_calls_by_rows_and_body_untimed": {
                 f"{m} {b}": n for (m, b), n in sorted(by_rows.items())},
             "grouped_ragged_calls_by_pair_rows_and_body_untimed": {
                 " ".join(map(str, key)): n
                 for key, n in sorted(expert.items())}}
    log(f"  served {len(reqs)} requests, {tokens} tokens in {wall:.2f} s: "
        f"{stats['tokens_per_s']:.1f} tokens/s; {len(decode)} decode steps,"
        f" median {stats['decode_step_median_ms']:.2f} ms (first "
        f"{decode[0] * 1e3:.1f} ms); bucket prefill ms "
        + ", ".join(f"{b}: {[round(x, 1) for x in v]}"
                    for b, v in stats["prefill_ms"].items())
        + f"; peak device memory {stats['peak_device_gb']:.2f} GB")
    log(f"  launches in the serving run: {launches}; bodies {bodies}; "
        f"ftimm_gemm calls by (rows, body) in {len(again)} more requests of "
        f"3 tokens, untimed: "
        f"{stats['ftimm_gemm_calls_by_rows_and_body_untimed']}; grouped / "
        "ragged calls by (kernel, pair, rows, body): "
        f"{stats['grouped_ragged_calls_by_pair_rows_and_body_untimed']}")
    for r in reqs[:2]:
        log(f"  req {r.rid} ({len(r.prompt)} prompt tokens): {r.out_tokens}")
    return stats, engine, launches


# ---------------------------------------------------------------------------
# The recurrent families: mamba2-370m (SSM) and zamba2-7b (hybrid)
# ---------------------------------------------------------------------------

def recurrent_reference(arch: str, dev) -> dict:
    """``arch`` in fp32 at full width and REC_REF_LAYERS layers: a 20-token
    prefill of 2 prompts and two decode steps on the card (the kernels) and
    on the CPU (the plain versions), same weights.  The logits and every
    cache leaf (the SSM state h and conv window; zamba2's shared-block K /
    V) must agree within REC_REF_TOL normwise."""
    return card_cpu_reference(dataclasses.replace(
        get_config(arch), num_layers=REC_REF_LAYERS[arch],
        compute_dtype="float32"), dev, rows=2, prompt_len=20)


def card_cpu_reference(cfg, dev, *, rows: int, prompt_len: int) -> dict:
    """``cfg`` (fp32): a prefill of ``rows`` seeded prompts of
    ``prompt_len`` tokens (after the stub frontends' seeded frames or
    patches) and two decode steps on the card (the kernels) and on the CPU
    (the plain versions), same weights.  The logits and every cache leaf
    must agree within REC_REF_TOL normwise."""
    arch = cfg.name
    t0 = time.monotonic()
    gpu_model = M.init_params(cfg, 0, device=dev)
    cpu_model = copy.deepcopy(gpu_model).to(CPU)
    rng = np.random.default_rng(8)
    prompt = rng.integers(2, cfg.vocab_size, (rows, prompt_len))
    nxt = rng.integers(2, cfg.vocab_size, (rows, 2))
    depth = prompt_len + (cfg.num_patches or 0)
    runs = {}
    for name, model, device in (("gpu", gpu_model, dev),
                                ("cpu", cpu_model, CPU)):
        t1 = time.monotonic()
        cache = M.make_cache(cfg, rows, prompt_len + 4, device=device)
        logits, cache = M.prefill(
            model, cfg, {"tokens": torch.as_tensor(prompt).to(device),
                         **frontend(cfg, rows, device)}, cache)
        out = [logits]
        for step in range(2):
            logits, cache = M.decode_step(
                model, cfg, torch.as_tensor(nxt[:, step:step + 1]).to(device),
                cache, depth + step)
            out.append(logits)
        # The padded vocab rows hold -1e30 on both sides: compare the rest.
        out = [t[:, :cfg.vocab_size].cpu() for t in out]
        runs[name] = (out, {k: v.cpu() for k, v in cache.items()},
                      time.monotonic() - t1)
    del gpu_model, cpu_model
    free_card()
    (g_out, g_cache, g_s), (c_out, c_cache, c_s) = runs["gpu"], runs["cpu"]
    logits_rel = max(rel_err(a, b)[0] for a, b in zip(g_out, c_out))
    state_rel = {k: rel_err(g_cache[k], c_cache[k])[0] for k in g_cache}
    worst = max(logits_rel, *state_rel.values())
    log(f"  {arch} fp32, {cfg.num_layers} layers"
        + (f" (encoder {cfg.encoder_layers}, {cfg.encoder_seq} frames)"
           if cfg.encoder_layers else "")
        + (f" ({cfg.num_patches} patches)" if cfg.num_patches else "")
        + f", full width, {rows} x {prompt_len} tokens: logits "
        f"normwise {logits_rel:.2e}, cache leaves "
        + ", ".join(f"{k} {v:.2e}" for k, v in state_rel.items())
        + f" (card {g_s:.1f} s, CPU {c_s:.1f} s, "
        f"{time.monotonic() - t0:.1f} s in all)")
    if worst > REC_REF_TOL:
        raise AssertionError(f"{arch} fp32 reference: normwise {worst:.3g} "
                             f"> {REC_REF_TOL}")
    return {"layers": cfg.num_layers, "logits_normwise": logits_rel,
            "cache_normwise": state_rel}


def decode_launches(engine: ServeEngine, dev) -> dict[str, int]:
    """Kernel launches of one fused decode step over every slot of
    ``engine`` (after its run; the paged rung through its page table), and
    the check that they are the path's.  SSM and hybrid: two SSM
    projections a layer, the unembed, and after each of the hybrid's groups
    q, k, v, o and down, the gate/up pair and the two fp32 attention
    products.  whisper and llava: q, k, v, o and down a layer (whisper's
    cross-attention adds its q and o), the unembed; the gate/up pair a
    layer; the fp32 QK^T and PV a layer over the self cache, and over each
    1024-row block of the encoder rows."""
    cfg = engine.cfg
    cache, table = ((engine.kv.cache(), engine.kv.device_table())
                    if engine.paged else (engine.cache, None))
    K.reset_launch_counts()
    M.decode_step(engine.params, cfg,
                  torch.zeros((engine.b, 1), dtype=torch.long, device=dev),
                  cache, torch.as_tensor(engine.pos, dtype=torch.long),
                  page_table=table)
    torch.cuda.synchronize()
    got = {k: v for k, v in K.launch_counts().items() if v}
    layers = cfg.num_layers
    if cfg.family in ("ssm", "hybrid"):
        groups = layers // cfg.attn_every if cfg.attn_every else 0
        want = {"ftimm_gemm": 2 * layers + 5 * groups + 1}
        if groups:
            want.update(ftimm_gemm_swiglu=groups,
                        ftimm_gemm_grouped=2 * groups)
    else:
        blocks = math.ceil(cfg.encoder_seq / 1024)
        want = {"ftimm_gemm": 5 * layers + 1 + (2 * layers if blocks else 0),
                "ftimm_gemm_swiglu": layers,
                "ftimm_gemm_grouped": 2 * layers * (1 + blocks)}
    if got != want:
        raise AssertionError(f"{cfg.name}: a decode step launched {got}, "
                             f"the path has {want}")
    return got


def serve_family(arch: str, dev) -> tuple[dict, dict, dict]:
    """Serve ``arch`` at full width (``depth("serve", arch)`` deep: the
    recurrent models and whisper-base whole, llava-next-34b at
    FAM_LAYERS[LLAVA]) through ServeEngine: mamba2, zamba2 and whisper on
    the dense-slot rung (slot caches of REC_MAX_LEN rows), llava on the
    paged rung with buckets (each request's patch rows in its pages).  6
    greedy requests of REC_PROMPT_LENS tokens over SLOTS slots, NEW_TOKENS
    each; the stub frontends' zero frames / patches.  Returns (stats, the
    launch counts of just this run, its body counts)."""
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=depth("serve", arch))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    model = M.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in model.parameters())
    attn = (f"heads {cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim_}, "
            f"d_ff {cfg.d_ff}")
    log(f"  {arch}: {cfg.num_layers} layers, d {cfg.d_model}, "
        + (f"SSM state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
           if cfg.ssm_state else "")
        + (f"a shared attention + MLP block after every {cfg.attn_every} "
           f"({attn}), " if cfg.attn_every else "")
        + (f"{attn}, " if not cfg.ssm_state else "")
        + (f"an encoder of {cfg.encoder_layers} over {cfg.encoder_seq} "
           "frames, " if cfg.encoder_layers else "")
        + (f"{cfg.num_patches} patch rows, " if cfg.num_patches else "")
        + f"vocab {cfg.vocab_size}; init {time.monotonic() - t0:.1f} s, "
        f"{params / 1e9:.3f} B params")
    engine = ServeEngine(cfg, model, batch_slots=SLOTS, max_len=REC_MAX_LEN,
                         page_size=PAGE, device=dev)
    paged = engine.paged
    if paged != (cfg.family in E.PAGED_FAMILIES):
        raise AssertionError(f"{arch} took the wrong rung (paged: {paged})")
    leaves = engine.kv.cache() if paged else engine.cache
    cache_gb = {k: t.numel() * t.element_size() / 1e9
                for k, t in leaves.items()}
    held: dict[int, int] = {}
    alloc = engine.alloc.alloc if paged else None
    if paged:
        def tracking(n, owner):
            pages = alloc(n, owner)
            held[owner] = held.get(owner, 0) + n
            return pages

        engine.alloc.alloc = tracking
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, max_new_tokens=NEW_TOKENS, prompt=rng.integers(
        2, cfg.vocab_size, n).astype(np.int32))
        for i, n in enumerate(REC_PROMPT_LENS)]

    K.reset_launch_counts()
    t0 = time.monotonic()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, bodies = K.launch_counts(), K.body_counts()
    decode = list(engine.walls["decode"])
    prefill = [[b, s * 1e3] for b, s in engine.walls["prefill"]]
    for r in reqs:
        if not r.done or r.timed_out or len(r.out_tokens) != NEW_TOKENS:
            raise AssertionError(f"{arch} request {r.rid} did not finish: "
                                 f"{len(r.out_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{arch} request {r.rid}: token out of "
                                 "range")
    if any(engine.faults.values()):     # non-finite logits quarantine
        raise AssertionError(f"{arch} engine faults: {engine.faults}")
    missing = [k for k in PATH_KERNELS[("serve", arch)] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{arch}: {missing} never launched: {launches}")
    rows_held = {}
    if paged:
        # Each request's pages held its patch rows, its prompt and every
        # decoded row but the last token's (which no step writes).
        engine.alloc.alloc = alloc
        engine.alloc.check()
        for r in reqs:
            rows = engine.extra + len(r.prompt) + NEW_TOKENS - 1
            rows_held[r.rid] = rows
            if held[id(r)] != E.pages_for(rows, PAGE):
                raise AssertionError(
                    f"{arch} request {r.rid}: {held[id(r)]} pages held, "
                    f"{E.pages_for(rows, PAGE)} hold its {rows} rows")

    # Untimed: the first prompts again for 3 tokens with every kernel call
    # recorded.  Every ftimm_gemm of at most SLOTS rows (decode, the
    # 2-token prompt, the 3-row conv tails, the 1-row prefill unembed) must
    # take the stream body; the dense pair of at most 16 rows the stream,
    # of more the body its plan names (the tensor cores, but the FMA body
    # for whisper's narrow 512 x 2048 pair at 17 and 40 rows); the fp32
    # attention the rows body at most ROWS_MAX rows a group (decode, the
    # 2-token prompt), else the FMA body.
    again = [Request(rid=len(reqs) + i, prompt=r.prompt, max_new_tokens=3)
             for i, r in enumerate(reqs[:SLOTS])]
    with CallRecorder() as recorder:
        engine.run(again)
    by_rows = gemm_calls_by_rows_and_body(recorder)
    small = {b: n for (m, b), n in by_rows.items() if m <= SLOTS}
    if set(small) != {"stream"}:
        raise AssertionError(f"{arch} GEMMs of <= {SLOTS} rows took the "
                             f"bodies {small}, not only the stream")
    grouped = group_calls_by_body(recorder)
    for (kernel, pair, rows, body), n in grouped.items():
        planned = (fp32_group_body(kernel, pair, rows) if pair != "bf16"
                   else "stream" if rows <= K.GSTREAM_ROWS
                   else plan_gemm(rows, cfg.d_model, cfg.d_ff, 2, 2,
                                  panels=2).body)
        if body != planned:
            raise AssertionError(f"{arch}: {kernel} {pair} calls of {rows} "
                                 f"rows took the {body} body ({grouped})")
    per_step = decode_launches(engine, dev)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del engine
    free_card()

    prof = profile_decode(cfg, model, slots=SLOTS, prompt_len=24, warm=3,
                          steps=5, device=dev)
    prof.pop("top_kernels")
    tokens = sum(len(r.out_tokens) for r in reqs)
    stats = {"layers": cfg.num_layers, "params_b": params / 1e9,
             "param_bytes": param_bytes(model),
             "requests": len(reqs), "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall, "decode_steps": len(decode),
             "decode_step_median_ms": statistics.median(decode[1:]) * 1e3,
             "prefill_ms": prefill, "cache_gb": cache_gb,
             "peak_device_gb": peak, "rows_held_by_request": rows_held,
             "launches": launches, "bodies": bodies,
             "launches_per_decode_step": per_step,
             "ftimm_gemm_calls_by_rows_and_body_untimed": {
                 f"{m} {b}": n for (m, b), n in sorted(by_rows.items())},
             "group_calls_by_pair_rows_and_body_untimed": {
                 " ".join(map(str, key)): n
                 for key, n in sorted(grouped.items())},
             "profile": prof}
    if paged:
        shown = "bucket prefill ms (bucket, ms) " + ", ".join(
            f"{b}: {ms:.1f}" for b, ms in prefill)
    else:
        shown = ("exact prefill ms by prompt length"
                 + (f" (each with the {cfg.encoder_seq}-frame encoder) "
                    if cfg.encoder_seq else " ")
                 + ", ".join(f"{n}: {ms:.1f}" for n, (_, ms) in zip(
                     REC_PROMPT_LENS, prefill)))
    log(f"  served {len(reqs)} requests, {tokens} tokens in {wall:.2f} s: "
        f"{stats['tokens_per_s']:.1f} tokens/s; {len(decode)} decode steps, "
        f"median {stats['decode_step_median_ms']:.2f} ms (first "
        f"{decode[0] * 1e3:.1f} ms); {shown}; "
        + ("page pool" if paged else "slot cache") + " GB "
        + ", ".join(f"{k} {v:.4f}" for k, v in cache_gb.items())
        + f"; peak device memory {peak:.2f} GB"
        + (f"; rows held a request {rows_held}" if rows_held else ""))
    log(f"  launches in the serving run: "
        f"{ {k: v for k, v in launches.items() if v} }; bodies "
        f"{ {k: v for k, v in bodies.items() if any(v.values())} }; one "
        f"decode step launches {per_step}; ftimm_gemm calls by (rows, body)"
        f" in {len(again)} more requests of 3 tokens, untimed: "
        f"{stats['ftimm_gemm_calls_by_rows_and_body_untimed']}")
    log(f"  profile_decode, {SLOTS} slots, 5 steps: wall median "
        f"{prof['step_wall_ms']:.2f} ms, device busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share "
        f"{prof['idle_share']:.3f}, {prof['launches_per_step']:.0f} device "
        "launches a step; device ms a step by group: "
        + ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(
            prof["device_ms_per_step"].items(), key=lambda kv: -kv[1])))
    for r in reqs[:2]:
        log(f"  req {r.rid} ({len(r.prompt)} prompt tokens): {r.out_tokens}")
    del model
    free_card()
    return stats, launches, bodies


def recurrent_phase(dev) -> tuple[dict, dict, dict]:
    """[recurrent]: the smoke and full-width fp32 references of both
    families, then each served at full width and depth, one model on the
    card at a time.  Returns (stats, launches and bodies by run)."""
    out = {"reference": {}, "serve": {}}
    launches, bodies = {}, {}
    for arch in RECURRENT:
        small_reference(dev, arch, REC_SMOKE_LAYERS[arch])
        out["reference"][arch] = recurrent_reference(arch, dev)
    for arch in RECURRENT:
        out["serve"][arch], launches[("serve", arch)], bodies[
            ("serve", arch)] = serve_family(arch, dev)
    return out, launches, bodies


# ---------------------------------------------------------------------------
# The stub-frontend families: whisper-base (encdec) and llava-next-34b (vlm)
# ---------------------------------------------------------------------------

def family_reference(arch: str, dev) -> dict:
    """``arch`` in fp32 at full width, card against CPU: whisper-base at
    full depth (6 + 6 layers, 1500 seeded frames), llava-next-34b at
    FAM_REF_LAYERS layers (576 seeded patches in front of the prompt); a
    prefill of 24 tokens and two decode steps, the logits and every cache
    leaf (whisper's cross K / V included) within REC_REF_TOL."""
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    if FAM_REF_LAYERS[arch]:
        cfg = dataclasses.replace(cfg, num_layers=FAM_REF_LAYERS[arch])
    return card_cpu_reference(cfg, dev, rows=1, prompt_len=24)


def families_phase(dev) -> tuple[dict, dict, dict]:
    """[families]: whisper-base and llava-next-34b served at full width
    (llava at FAM_LAYERS[LLAVA] layers), one model on the card at a time.
    Returns (stats, launches and bodies by run)."""
    out, launches, bodies = {}, {}, {}
    torch.zeros(1, device=dev)      # the allocator's stats need a context
    for arch in FRONTENDS:
        out[arch], launches[("serve", arch)], bodies[("serve", arch)] = \
            serve_family(arch, dev)
    return out, launches, bodies


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

class CallRecorder:
    """Notes the distinct kernel calls of a run: while it is entered, every
    kernel wrapper of ``K`` is wrapped so that each call records the kernel,
    each tensor argument's shape, strides and dtype, and the other
    arguments (a call's integer tensors -- the group offsets -- are kept on
    the card as the first such call gave them: cloned, no host sync).  The
    calls themselves go through the wrappers unchanged, launches counted as
    ever."""

    def __init__(self):
        self.calls: dict[tuple, dict] = {}
        self._saved: dict[str, object] = {}

    def __enter__(self):
        for name in K.KERNELS:
            self._saved[name] = fn = getattr(K, name)
            setattr(K, name, functools.partial(self._record, name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(K, name, fn)

    @staticmethod
    def _key(x):
        if isinstance(x, torch.Tensor):
            return ("tensor", tuple(x.shape), x.stride(), x.dtype)
        return x

    @staticmethod
    def _spec(x):
        if isinstance(x, torch.Tensor) and x.dtype in (torch.int32,
                                                       torch.int64):
            return x.detach().clone()
        return CallRecorder._key(x)

    def _record(self, name, fn, *args, **kwargs):
        key = (name, tuple(map(self._key, args)),
               tuple((k, self._key(v)) for k, v in sorted(kwargs.items())))
        call = self.calls.get(key)
        if call is None:
            call = self.calls[key] = {
                "kernel": name, "count": 0,
                "args": [self._spec(a) for a in args],
                "kwargs": {k: self._spec(v) for k, v in kwargs.items()}}
        call["count"] += 1
        return fn(*args, **kwargs)


def gemm_calls_by_rows_and_body(recorder: CallRecorder) -> dict:
    """``ftimm_gemm`` launches of a recorded run by (rows M, body)."""
    out: dict[tuple[int, str], int] = {}
    for call in recorder.calls.values():
        if call["kernel"] != "ftimm_gemm":
            continue
        a, b = call["args"][:2]
        key = (K.mkn(call["kwargs"].get("trans", "nn"), a[1], b[1])[0],
               call["kwargs"].get("body", "fma"))
        out[key] = out.get(key, 0) + call["count"]
    return out


GROUP_KERNELS = ("ftimm_gemm_swiglu", "ftimm_gemm_grouped",
                 "ftimm_gemm_grouped_swiglu", "ftimm_gemm_ragged",
                 "ftimm_gemm_ragged_swiglu")


def group_calls_by_body(recorder: CallRecorder) -> dict[tuple, int]:
    """Launches of the three SwiGLU pairs and the grouped and ragged
    kernels in a recorded run by (kernel, operand pair "bf16", "fp32" or
    "mixed", rows a group (the dense pair and the ragged kernels: all
    rows), body)."""
    out: dict[tuple, int] = {}
    for call in recorder.calls.values():
        name = call["kernel"]
        if name not in GROUP_KERNELS:
            continue
        a, b = call["args"][:2]
        pair = ("bf16" if a[3] == b[3] == BF16
                else "fp32" if a[3] == b[3] == FP32 else "mixed")
        trans = call["kwargs"].get("trans", "nn")
        rows = (K.mkn(trans, a[1][-2:], b[1][-2:])[0]
                if name.startswith("ftimm_gemm_grouped") else a[1][0])
        key = (name, pair, rows, call["kwargs"].get("body", "fma"))
        out[key] = out.get(key, 0) + call["count"]
    return out


def fp32_group_body(kernel: str, pair: str, rows: int) -> str:
    """The body a grouped / ragged kernel or pair call that is not bf16 x
    bf16 plans: the grouped kernel's fp32 products of at most ROWS_MAX
    rows a group (decode attention) the rows body, every other (the fp32
    attention of prefill and training, the mixed pairs) the FMA body."""
    return ("rows" if kernel == "ftimm_gemm_grouped" and pair == "fp32"
            and rows <= K.ROWS_MAX else "fma")


def gemm_bodies_by_pair(recorder: CallRecorder) -> dict[str, int]:
    """``ftimm_gemm`` launches of a recorded run by operand pair (bf16 x
    bf16 with N >= 128, bf16 x bf16 with N < 128, or a mixed / fp32 pair)
    and body."""
    out: dict[str, int] = {}
    for call in recorder.calls.values():
        if call["kernel"] != "ftimm_gemm":
            continue
        a, b = call["args"][:2]
        trans = call["kwargs"].get("trans", "nn")
        n = K.mkn(trans, a[1], b[1])[2]
        if a[3] == b[3] == BF16:
            pair = "bf16" if n >= 128 else "bf16 N<128"
        else:
            pair = "mixed/fp32"
        key = f"{pair} {call['kwargs'].get('body', 'fma')}"
        out[key] = out.get(key, 0) + call["count"]
    return dict(sorted(out.items()))


def check_train_bodies(arch: str, by_pair: dict, bodies: dict,
                       expert: dict) -> None:
    """A bf16 training run launches ``ftimm_gemm`` through the tensor-core
    and stream bodies, and the FMA body only for the mixed and fp32 pairs
    (the fp32 cotangents of the logits and the router) and for the bf16
    products of fewer than 128 columns that the CMR model plans on it (the
    routers' 8 or 16 experts); the ragged dW takes the tensor cores; the
    grouped and ragged kernels and the three SwiGLU pairs take the tensor
    cores for their bf16 x bf16 products and, for the fp32 attention
    products (128 and more rows a group) and the mixed pairs, the body
    ``fp32_group_body`` names: the FMA body (``expert``:
    ``group_calls_by_body``); qwen3-1.7b launches its dense pair on the
    tensor cores twice a layer a step (the forward and its remat)."""
    for (kernel, pair, rows, body), n in expert.items():
        if body != ("tc" if pair == "bf16"
                    else fp32_group_body(kernel, pair, rows)):
            raise AssertionError(f"{arch} train: {kernel} {pair} calls of "
                                 f"{rows} rows took the {body} body "
                                 f"({expert})")
    bad = {k: v for k, v in by_pair.items()
           if k.startswith("bf16 fma") or (k.startswith("mixed/fp32")
                                            and not k.endswith(" fma"))}
    if bad:
        raise AssertionError(f"{arch} train: ftimm_gemm bodies {by_pair}")
    fma = sum(v for k, v in by_pair.items() if k.endswith(" fma"))
    if fma != bodies["ftimm_gemm"]["fma"]:
        raise AssertionError(f"{arch} train: {fma} FMA calls recorded, "
                             f"{bodies['ftimm_gemm']['fma']} counted")
    dw = bodies["ftimm_gemm_ragged_dw"]
    if dw["fma"]:
        raise AssertionError(f"{arch} train: the ragged dW took the FMA "
                             f"body: {dw}")
    if arch == ARCH:
        want = {"fma": 0, "tc": 2 * depth("train", arch) * TRAIN_STEPS,
                "stream": 0}
        if bodies["ftimm_gemm_swiglu"] != want:
            raise AssertionError(f"{arch} train: ftimm_gemm_swiglu bodies "
                                 f"{bodies['ftimm_gemm_swiglu']}, expected "
                                 f"{want}")


def _strided(spec, gen):
    """A tensor of random values with the recorded shape, strides and
    dtype (any strides: transposed views, a group stride of 0)."""
    _, shape, stride, dtype = spec
    size = (1 + sum((n - 1) * st for n, st in zip(shape, stride))
            if all(shape) else 0)
    base = torch.randn(size, generator=gen, device=gen.device).to(dtype)
    return base.as_strided(shape, stride)


def recorded_cases(recorder: CallRecorder, arch: str) -> list[Case]:
    """One case per distinct kernel call of a training run: the wrapper
    (the kernel) and its plain version on the same random operands of the
    recorded shapes, strides and dtypes, with the recorded offsets."""
    cases = []
    for call in recorder.calls.values():
        name = call["kernel"]
        kernel, plain = getattr(K, name), getattr(K, f"{name}_plain")
        plain_kw = inspect.signature(plain).parameters

        def make(gen, call=call):
            def real(x):
                if isinstance(x, tuple) and x and x[0] == "tensor":
                    return _strided(x, gen)
                return x
            return (([real(a) for a in call["args"]],
                     {k: real(v) for k, v in call["kwargs"].items()}),)

        tensors = [a for a in (*call["args"], *call["kwargs"].values())
                   if isinstance(a, tuple) and a and a[0] == "tensor"]
        out = call["kwargs"].get("out_dtype") or tensors[0][3]
        shapes = " x ".join(
            f"{tuple(t[1])}{'' if t[2] == _contiguous(t[1]) else 'T'}"
            f" {str(t[3]).removeprefix('torch.')}" for t in tensors)
        label = (f"{arch} train {call['kwargs'].get('trans', '')} {shapes} "
                 f"-> {str(out).removeprefix('torch.')} "
                 f"x{call['count'] / TRAIN_STEPS:g}/step")
        cases.append(Case(
            name, label, make,
            lambda c, fn=kernel: fn(*c[0], **c[1]),
            lambda c, fn=plain, kw=plain_kw: fn(
                *c[0], **{k: v for k, v in c[1].items() if k in kw}),
            None, 0, 0.0, tensors[0][3], out, model=arch, phase="train"))
    return cases


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def _grad_tree(model) -> dict:
    return to_numpy_tree({n: p.grad for n, p in model.named_parameters()})


def _worst_leaf(got: dict, want: dict, prefix: str = "") -> tuple[float, str]:
    """The largest normwise error over the leaves of two trees."""
    worst = (0.0, "")
    for key in sorted(want):
        name = f"{prefix}{key}"
        if isinstance(want[key], dict):
            worst = max(worst, _worst_leaf(got[key], want[key], name + "/"))
        else:
            rel, _ = rel_err(torch.as_tensor(got[key]),
                             torch.as_tensor(want[key]))
            worst = max(worst, (rel, name))
    return worst


def train_reference_qwen(dev) -> dict:
    """qwen3-1.7b at full width and REF_LAYERS layers in fp32: 2 AdamW
    steps of batch 2 x seq 32 on the card (the kernels) and on the CPU (the
    plain versions), from the same weights and batches.  The loss of each
    step and every step-1 gradient leaf within TRAIN_REF_TOL normwise."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=REF_LAYERS,
                              compute_dtype="float32")
    t0 = time.monotonic()
    gpu_model = M.init_params(cfg, 0, device=dev, dtype=cfg.param_dtype)
    cpu_model = copy.deepcopy(gpu_model).to(CPU)
    data = SyntheticLM(cfg, ShapeConfig("ref", 32, 2, "train"), seed=0)
    step = make_train_step(cfg, OptConfig(warmup_steps=1, total_steps=2))
    runs = {}
    for name, model, device in (("gpu", gpu_model, dev),
                                ("cpu", cpu_model, CPU)):
        opt = init_opt_state(dict(model.named_parameters()))
        losses, grads = [], None
        for i in range(2):
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in data.host_batch(i).items()}
            model, opt, m = step(model, opt, batch)
            losses.append(float(m["loss"]))
            grads = grads or _grad_tree(model)
        runs[name] = (losses, grads)
    del gpu_model, cpu_model
    free_card()
    (g_loss, g_grads), (c_loss, c_grads) = runs["gpu"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(g_loss, c_loss))
    grad_rel, leaf = _worst_leaf(g_grads, c_grads)
    log(f"  {ARCH} fp32, {REF_LAYERS} layers, full width, 2 AdamW steps: "
        f"losses card {g_loss} / CPU {c_loss} (rel {loss_rel:.2e}); step-1 "
        f"gradients worst normwise {grad_rel:.2e} ({leaf}); "
        f"{time.monotonic() - t0:.1f} s")
    if loss_rel > TRAIN_REF_TOL or grad_rel > TRAIN_REF_TOL:
        raise AssertionError(f"{ARCH} train reference: loss {loss_rel:.3g}, "
                             f"gradient {grad_rel:.3g} ({leaf}) > "
                             f"{TRAIN_REF_TOL}")
    return {"losses_gpu": g_loss, "losses_cpu": c_loss,
            "loss_rel": loss_rel, "grad_normwise": grad_rel}


def train_reference_llama4(dev) -> dict:
    """llama4-scout at full width and 1 layer in fp32: one forward /
    backward of 64 tokens on the card and on the CPU, same weights.  Every
    router call must choose the same experts, then the loss and every
    gradient leaf within TRAIN_REF_TOL normwise."""
    cfg = dataclasses.replace(get_config(LLAMA4), num_layers=1,
                              compute_dtype="float32")
    t0 = time.monotonic()
    gpu_model = M.init_params(cfg, 0, device=dev, dtype=cfg.param_dtype)
    cpu_model = copy.deepcopy(gpu_model).to(CPU)
    host = SyntheticLM(cfg, ShapeConfig("ref", 32, 2, "train"),
                       seed=0).host_batch(0)
    router = MOE._router
    runs = {}
    for name, model, device in (("gpu", gpu_model, dev),
                                ("cpu", cpu_model, CPU)):
        choices = []

        def recording(x, w, e, k, _sink=choices):
            out = router(x, w, e, k)
            _sink.append(out[1].cpu())
            return out

        MOE._router = recording
        try:
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in host.items()}
            total, _ = M.loss_fn(model, cfg, batch)
            total.backward()
        finally:
            MOE._router = router
        runs[name] = (total.item(), _grad_tree(model), choices)
        del model
    del gpu_model, cpu_model
    free_card()
    (g_loss, g_grads, g_ch), (c_loss, c_grads, c_ch) = runs["gpu"], runs["cpu"]
    if len(g_ch) != len(c_ch) or not all(torch.equal(a, b)
                                         for a, b in zip(g_ch, c_ch)):
        raise AssertionError(f"{LLAMA4} train reference: the card chose "
                             "other experts than the CPU")
    loss_rel = abs(g_loss - c_loss) / abs(c_loss)
    grad_rel, leaf = _worst_leaf(g_grads, c_grads)
    log(f"  {LLAMA4} fp32, 1 layer, full width, 64 tokens: {len(g_ch)} "
        f"router calls, {sum(int(c.numel()) for c in g_ch)} expert choices "
        f"equal; loss {g_loss:.6f} / {c_loss:.6f} (rel {loss_rel:.2e}); "
        f"gradients worst normwise {grad_rel:.2e} ({leaf}); "
        f"{time.monotonic() - t0:.1f} s")
    if loss_rel > TRAIN_REF_TOL or grad_rel > TRAIN_REF_TOL:
        raise AssertionError(f"{LLAMA4} train reference: loss {loss_rel:.3g},"
                             f" gradient {grad_rel:.3g} ({leaf}) > "
                             f"{TRAIN_REF_TOL}")
    return {"loss_gpu": g_loss, "loss_cpu": c_loss, "loss_rel": loss_rel,
            "grad_normwise": grad_rel, "router_calls": len(g_ch)}


def train_reference_smoke(arch: str, dev) -> dict:
    """``arch``-smoke in fp32 (zamba2 at REC_SMOKE_LAYERS: 2 groups and a
    remainder): one forward / backward of a 2 x 32 synthetic batch (with
    its seeded frames or patches) on the card and on the CPU, same
    weights; the loss and every gradient leaf within 1e-4 normwise."""
    cfg = dataclasses.replace(get_config(arch + "-smoke"),
                              compute_dtype="float32")
    if REC_SMOKE_LAYERS.get(arch):
        cfg = dataclasses.replace(cfg, num_layers=REC_SMOKE_LAYERS[arch])
    gpu_model = M.init_params(cfg, 0, device=dev, dtype=cfg.param_dtype)
    cpu_model = copy.deepcopy(gpu_model).to(CPU)
    host = SyntheticLM(cfg, ShapeConfig("ref", 32, 2, "train"),
                       seed=0).host_batch(0)
    runs = {}
    for name, model, device in (("gpu", gpu_model, dev),
                                ("cpu", cpu_model, CPU)):
        total, _ = M.loss_fn(model, cfg, {k: torch.as_tensor(v).to(device)
                                          for k, v in host.items()})
        total.backward()
        runs[name] = (total.item(), _grad_tree(model))
    del gpu_model, cpu_model
    free_card()
    (g_loss, g_grads), (c_loss, c_grads) = runs["gpu"], runs["cpu"]
    loss_rel = abs(g_loss - c_loss) / abs(c_loss)
    grad_rel, leaf = _worst_leaf(g_grads, c_grads)
    stubs = sorted(set(host) - {"tokens", "labels", "loss_mask"})
    log(f"  {cfg.name} fp32, {cfg.num_layers} layers, 2 x 32 tokens"
        + (f" (+ {', '.join(stubs)})" if stubs else "")
        + f": loss {g_loss:.6f} / {c_loss:.6f} (rel {loss_rel:.2e}); "
        f"gradients worst normwise {grad_rel:.2e} ({leaf})")
    if loss_rel > 1e-4 or grad_rel > 1e-4:
        raise AssertionError(f"{cfg.name} train reference: loss "
                             f"{loss_rel:.3g}, gradient {grad_rel:.3g} "
                             f"({leaf}) > 1e-4")
    return {"loss_gpu": g_loss, "loss_cpu": c_loss, "loss_rel": loss_rel,
            "grad_normwise": grad_rel, "worst_leaf": leaf}


def train(arch: str, dev, opt_cfg: OptConfig, *, compute_dtype=None,
          gate: bool = True) -> tuple[dict, dict, CallRecorder]:
    """Train ``arch`` at full width (TRAIN_LAYERS deep) for TRAIN_STEPS
    steps through ``Trainer``: bf16 compute (or ``compute_dtype``), fp32
    masters, AdamW on ``opt_cfg``; the launch counts and the distinct
    kernel calls of just this run.  ``gate``: the loss must fall and every
    kernel of the path must have launched."""
    cfg = get_config(arch)
    if TRAIN_LAYERS[arch]:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS[arch])
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    shape = ShapeConfig("chip", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(cfg, shape, opt_cfg, seed=0, log_every=1, device=dev)
    K.reset_launch_counts()
    t0 = time.monotonic()
    with CallRecorder() as recorder:
        model, opt = trainer.run(TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = K.launch_counts()
    params = sum(p.numel() for p in model.parameters())
    del model, opt
    log_ = trainer.metrics_log
    losses = [m["loss"] for m in log_]
    if len(log_) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{arch} train: losses {losses}")
    if gate and not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} train: loss did not decrease: {losses}")
    missing = [k for k in PATH_KERNELS[("train", arch)] if launches[k] == 0]
    if gate and missing:
        raise AssertionError(f"{arch} train: {missing} never launched: "
                             f"{launches}")
    bodies = K.body_counts()
    by_pair = gemm_bodies_by_pair(recorder)
    expert = group_calls_by_body(recorder)
    if gate:
        check_train_bodies(arch, by_pair, bodies, expert)
    walls = [log_[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                   for a, b in zip(log_, log_[1:])]
    median = statistics.median(walls[1:])
    stats = {"layers": cfg.num_layers, "params": params,
             "steps": TRAIN_STEPS, "tokens_per_step": TRAIN_TOKENS,
             "losses": losses, "aux_losses": [m["aux_loss"] for m in log_],
             "grad_norms": [m["grad_norm"] for m in log_],
             "lrs": [m["lr"] for m in log_], "step_s": walls, "step_median_s": median,
             "tokens_per_s": TRAIN_TOKENS / median, "wall_s": wall,
             "peak_device_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
             "launches": launches,
             "launches_per_step": {k: v / TRAIN_STEPS
                                   for k, v in launches.items() if v},
             "bodies": bodies, "ftimm_gemm_bodies_by_pair": by_pair,
             "grouped_ragged_calls_by_pair_rows_and_body": {
                 " ".join(map(str, key)): n
                 for key, n in sorted(expert.items())}}
    log(f"  {arch}: {cfg.num_layers} layers, {params / 1e9:.3f} B params, "
        f"{cfg.compute_dtype} compute, {TRAIN_STEPS} steps of {TRAIN_BATCH} "
        f"x {TRAIN_SEQ}, lr {[f'{x:.2e}' for x in stats['lrs']]}: losses "
        f"{[round(x, 4) for x in losses]}; step s "
        f"{[round(x, 3) for x in walls]} (median {median:.3f} s, first "
        f"{walls[0]:.2f} s), {stats['tokens_per_s']:.1f} tokens/s; peak "
        f"device memory {stats['peak_device_gb']:.2f} GB")
    log(f"  launches per step: {stats['launches_per_step']}; "
        f"{len(recorder.calls)} distinct kernel calls; bodies {bodies}; "
        f"ftimm_gemm launches by operand pair and body: {by_pair}; grouped /"
        " ragged launches by (kernel, pair, rows, body): "
        f"{stats['grouped_ragged_calls_by_pair_rows_and_body']}")
    free_card()
    return stats, launches, recorder


def schedule_witness(dev) -> dict:
    """The launcher's own schedule for a run of TRAIN_STEPS steps (a 1-step
    warmup to lr 3e-4, then cosine): llama4-scout at 1 layer in bf16 and in
    fp32 compute from the same fp32 masters and batches, and qwen3-1.7b at
    28 layers in bf16.  Whether the loss falls is recorded, not gated (the
    [train] phase gates it on a gentler warmup).  The gates: bf16 and fp32
    agree before any update (the step-1 loss within 1e-2) and after the
    first, full-lr update (the step-2 loss within 5e-2: one bf16 step moves
    the loss as the fp32 step does, so a spike there is the schedule's)."""
    runs = {}
    for arch, dtype in ((LLAMA4, "bfloat16"), (LLAMA4, "float32"),
                        (ARCH, "bfloat16")):
        stats, _, _ = train(arch, dev, opt_config(TRAIN_STEPS, 3e-4),
                            compute_dtype=dtype, gate=False)
        runs[f"{arch} {dtype}"] = {k: stats[k] for k in (
            "losses", "aux_losses", "grad_norms", "lrs", "step_median_s",
            "peak_device_gb")}
    bf, fp = (runs[f"{LLAMA4} {d}"]["losses"] for d in ("bfloat16",
                                                         "float32"))
    for i, tol in ((0, 1e-2), (1, 5e-2)):
        if abs(bf[i] - fp[i]) > tol * abs(fp[i]):
            raise AssertionError(f"{LLAMA4} step-{i + 1} loss bf16 {bf[i]} "
                                 f"vs fp32 {fp[i]} (> {tol} relative)")
    return runs


# ---------------------------------------------------------------------------
# Measured tuning: the plan store on qwen3-1.7b's main path
# ---------------------------------------------------------------------------

TUNE_TOP_K = 4
RETIME_LIMIT = 1.10     # a winner re-timed above this x the analytic plan:
                        # the harness picked by noise
SPLITK_RECORD = {"body": "tc", "bm": 128, "bn": 128, "bk": 64,
                 "dim_order": "mn", "nsplit": 4}
# Per planner of the dispatch layer: its family's search, replay and
# candidate generator, which all name their arguments as the planner does.
FAMILIES = {"plan_gemm": (autotune.autotune_gemm, autotune.time_dense_plans,
                          tuner.gemm_candidates),
            "plan_batched_gemm": (autotune.autotune_batched_gemm,
                                  autotune.time_batched_plans,
                                  tuner.batched_candidates),
            "plan_ragged_gemm": (autotune.autotune_ragged_gemm,
                                 autotune.time_ragged_plans,
                                 tuner.ragged_candidates)}


class PlanRecorder:
    """Notes the distinct planner calls of a run, by phase: while entered,
    the dispatch layer's three planners are wrapped so that each call
    counts its arguments (the signature, widths and layout flags the plan
    store keys on) under ``phase``; the engine's ``decode_step`` is wrapped
    to set the phase "decode" for its calls and to keep the first decode
    step's inputs and logits.  Plans are computed as ever."""

    def __init__(self):
        self.calls: dict[tuple, int] = {}
        self.phase = "other"
        self.decode_steps = 0
        self.first_decode = None      # (cloned inputs, logits)
        self._saved: dict[str, object] = {}

    def __enter__(self):
        for name in FAMILIES:
            self._saved[name] = fn = getattr(D, name)
            setattr(D, name, functools.partial(self._plan, name, fn))
        self._decode = E.decode_step
        E.decode_step = self._decode_step
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(D, name, fn)
        E.decode_step = self._decode

    def _plan(self, name, fn, *args, **kwargs):
        key = (self.phase, name, args, tuple(sorted(kwargs.items())))
        self.calls[key] = self.calls.get(key, 0) + 1
        return fn(*args, **kwargs)

    def _decode_step(self, model, cfg, tokens, cache, pos, page_table=None):
        if self.first_decode is None:
            inputs = (tokens.clone(), {k: v.clone() for k, v in
                                       cache.items()},
                      pos.clone(), page_table.clone())
        prev, self.phase = self.phase, "decode"
        try:
            logits, cache = self._decode(model, cfg, tokens, cache, pos,
                                         page_table=page_table)
        finally:
            self.phase = prev
        self.decode_steps += 1
        if self.first_decode is None:
            self.first_decode = (inputs, logits.clone())
        return logits, cache

    def signatures(self, phase: str | None = None) -> dict[tuple, int]:
        """{(planner, args, kwargs): calls} of ``phase`` (None: all)."""
        out: dict[tuple, int] = {}
        for (ph, *sig), n in self.calls.items():
            if phase is None or ph == phase:
                out[tuple(sig)] = out.get(tuple(sig), 0) + n
        return out


def _plan_str(p) -> str:
    return (f"{p.body} {p.bm}x{p.bn}x{p.bk} {p.dim_order}"
            + (f" k/{p.kslices}" if p.body == "stream" else "")
            + (f" nsplit {p.nsplit}" if p.nsplit > 1 else "")
            + ("" if p.fuse else " unfused"))


def _named(name: str, args, kwargs) -> dict:
    """A recorded planner call's arguments by name.  ``fp8`` is left out:
    the tuner times 1-byte operands as int8, and qwen's calls are wide.
    ``b_rows`` is left out too: the tuner makes its own operands, whose
    rows the grouped rows body reads."""
    call = dict(inspect.signature(getattr(tuner, name)).bind(
        *args, **dict(kwargs)).arguments)
    call.pop("b_rows", None)
    if call.pop("fp8", False):
        raise AssertionError(f"{name}{args}: the tuner does not time fp8")
    return call


def _retime(name: str, call: dict, plans, dev) -> list[float]:
    """``plans`` timed again, on operands made from another seed:
    ``time_dense_plans`` and its counterparts."""
    return FAMILIES[name][1](plans=plans, device=dev, seed=1, **call)


def _argmin(name: str, call: dict, spec):
    """The CMR argmin of a recorded call under ``spec``, whatever the store
    holds (the layout ``trans`` keys the store; of the candidates only the
    grouped rows body's cut follows it)."""
    flags = {k: v for k, v in call.items()
             if k != "trans" or name == "plan_batched_gemm"}
    return tuner.argmin_plan(FAMILIES[name][2](spec=spec, **flags))


def _qwen_steps(dev, steps: int) -> tuple[list[dict], dict, dict]:
    """``steps`` qwen3-1.7b train steps (28 layers, [train]'s batch, seed
    and optimizer) under the current plans; its metrics, body counts and
    launch counts."""
    cfg = get_config(ARCH)
    shape = ShapeConfig("chip", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    free_card()
    trainer = Trainer(cfg, shape, OptConfig(warmup_steps=TRAIN_WARMUP,
                                            total_steps=10 * TRAIN_WARMUP),
                      seed=0, log_every=1, device=dev)
    K.reset_launch_counts()
    model, opt = trainer.run(steps)
    torch.cuda.synchronize()
    bodies, launches = K.body_counts(), K.launch_counts()
    del model, opt
    free_card()
    return trainer.metrics_log, bodies, launches


def _serve_qwen(model, cfg, dev, recorder=None) -> tuple[list, list]:
    """chip_smoke's 6 requests on ``model`` through a fresh ServeEngine;
    the requests and the decode-step walls."""
    engine = ServeEngine(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN,
                         page_size=PAGE, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, n).astype(
        np.int32), max_new_tokens=NEW_TOKENS)
        for i, n in enumerate(PROMPT_LENS)]
    if recorder is None:
        engine.run(reqs)
    else:
        with recorder:
            engine.run(reqs)
    torch.cuda.synchronize()
    if any(engine.faults.values()) or not all(r.done for r in reqs):
        raise AssertionError(f"serving faults {engine.faults}")
    return reqs, list(engine.walls["decode"])


def autotune_phase(dev) -> dict:
    """[autotune]: tune every GEMM signature of qwen3-1.7b's main path at
    its served shape on the card, re-time each winner beside its analytic
    plan, calibrate, round-trip the store through a file, serve again with
    the stored plans, and send qwen's dW through a stored split-K record."""
    tuner.clear_plan_cache()
    cfg = get_config(ARCH)

    # 1. The analytic run: serving (decode and the bucket prefills) and two
    # train steps, every planner call recorded.
    model = M.init_params(cfg, 0, device=dev)
    serve_rec = PlanRecorder()
    reqs_a, walls_a = _serve_qwen(model, cfg, dev, serve_rec)
    train_rec = PlanRecorder()
    with train_rec:
        log_a, _, _ = _qwen_steps(dev, 2)
    decode = serve_rec.signatures("decode")
    sigs = [("decode", s) for s in decode]
    sigs += [("prefill", s) for s in serve_rec.signatures("other")
             if s not in decode]
    seen = {s for _, s in sigs}
    sigs += [("train", s) for s in train_rec.signatures() if s not in seen]
    log(f"  {len(sigs)} signatures: "
        + ", ".join(f"{sum(1 for p, _ in sigs if p == ph)} {ph}"
                    for ph in ("decode", "prefill", "train")))

    # 2. Tune each at its served shape, then re-time winner and analytic.
    t0 = time.monotonic()
    rows, results = [], []
    for phase, (name, args, kwargs) in sigs:
        call = _named(name, args, kwargs)
        r = FAMILIES[name][0](**call, top_k=TUNE_TOP_K, device=dev)
        if r.measured_dims != r.dims:
            raise AssertionError(f"{r.key} scaled to {r.measured_dims}")
        results.append((phase, r))
        t_win, t_ana = _retime(name, call, [r.plan, r.analytic_plan], dev)
        per_step = (decode.get((name, args, kwargs), 0)
                    / max(serve_rec.decode_steps, 1))
        rows.append({
            "phase": phase, "key": r.key, "per_decode_step": per_step,
            "analytic": _plan_str(r.analytic_plan),
            "analytic_us": r.t_analytic * 1e6,
            "winner": _plan_str(r.plan), "winner_us": r.t_measured * 1e6,
            "model_us": r.plan.est.t_total * 1e6,
            "retime_winner_us": t_win * 1e6,
            "retime_analytic_us": t_ana * 1e6,
            "changed": r.plan != dataclasses.replace(r.analytic_plan,
                                                     mode="measured")})
        row = rows[-1]
        log(f"  {phase:7s} {r.key:58s} analytic "
            f"{row['analytic']:26s} {row['analytic_us']:9.1f} us | winner "
            f"{row['winner']:26s} {row['winner_us']:9.1f} us | model "
            f"{row['model_us']:9.1f} us | re-timed {t_win * 1e6:9.1f} / "
            f"{t_ana * 1e6:9.1f} us")
        if t_win > RETIME_LIMIT * t_ana:
            raise AssertionError(f"{r.key}: the winner re-timed at "
                                 f"{t_win / t_ana:.3f}x the analytic plan")
    tune_s = time.monotonic() - t0

    # 3. Calibrate on decode and prefill; judge on the training signatures.
    # Not stored: the store serves measured plans only, and the picks the
    # calibration would move are timed beside the analytic ones instead.
    fit = [r for ph, r in results if ph != "train"]
    held = [(r.est_measured, r.t_measured) for ph, r in results
            if ph == "train"]
    cal = autotune.calibrate(fit, store=False)
    calib = {"flops_frac": cal.flops_frac, "bw_frac": cal.bw_frac,
             "n_samples": cal.n_samples,
             "heldout_error_before": autotune.prediction_error(held),
             "heldout_error_after": autotune.prediction_error(
                 held, cal.flops_frac, cal.bw_frac),
             "heldout_bias_before": autotune.geomean_ratio(held),
             "heldout_bias_after": autotune.geomean_ratio(
                 held, cal.flops_frac, cal.bw_frac)}
    log(f"  calibration on {cal.n_samples} decode / prefill signatures: "
        f"flops_frac {cal.flops_frac:.4g}, bw_frac {cal.bw_frac:.4g}; on "
        f"the {len(held)} training signatures prediction error "
        f"{calib['heldout_error_before']:.3f}x -> "
        f"{calib['heldout_error_after']:.3f}x (bias "
        f"{calib['heldout_bias_before']:.3f} -> "
        f"{calib['heldout_bias_after']:.3f})")
    cal_spec = tuner.H100.calibrated(cal.flops_frac, cal.bw_frac)
    moved = []
    for (phase, (name, args, kwargs)), (_, r) in zip(sigs, results):
        call = _named(name, args, kwargs)
        ana, pick = (_argmin(name, call, sp) for sp in (tuner.H100, cal_spec))
        if _plan_str(ana) == _plan_str(pick):
            continue
        t_cal, t_ana = _retime(name, call, [pick, ana], dev)
        moved.append({"phase": phase, "key": r.key,
                      "analytic": _plan_str(ana),
                      "calibrated": _plan_str(pick),
                      "analytic_us": t_ana * 1e6,
                      "calibrated_us": t_cal * 1e6})
        log(f"  calibrated pick {phase:7s} {r.key:58s} analytic "
            f"{moved[-1]['analytic']:26s} {t_ana * 1e6:9.1f} us | calibrated "
            f"{moved[-1]['calibrated']:26s} {t_cal * 1e6:9.1f} us")
    ratios = [x["calibrated_us"] / x["analytic_us"] for x in moved]
    calib.update(moved=moved, moved_geomean=math.exp(
        sum(map(math.log, ratios)) / len(ratios)) if ratios else 1.0)
    log(f"  the calibration moves {len(moved)} of {len(sigs)} analytic picks; "
        f"calibrated / analytic time geomean {calib['moved_geomean']:.3f}"
        + (f", {min(ratios):.3f}-{max(ratios):.3f}" if ratios else ""))

    # 4. The store through a file.
    kind = plan_store.device_kind()
    path = ROOT / "build" / f"plan_cache_{kind}.json"
    autotune.save_plan_cache(str(path))
    plan_store.reset_store()
    adopted = autotune.load_plan_cache(str(path))
    store = plan_store.get_store()
    if adopted != len(results) or store.quarantined:
        raise AssertionError(f"store round trip: {adopted} of "
                             f"{len(results)} adopted, quarantined "
                             f"{store.quarantined}")
    log(f"  store: {adopted} plans saved to {path.relative_to(ROOT)} and "
        "loaded back, none quarantined")

    # 5. Serve again with the stored plans.
    tuner.PLAN_MODE_COUNTS.clear()
    reqs_c, walls_c = _serve_qwen(model, cfg, dev)
    modes = tuner.plan_mode_stats()
    served = {fam: v for fam, v in modes.items() if fam != "epilogue"}
    if any(set(v) != {"cached"} for v in served.values()):
        raise AssertionError(f"served plans not all cached: {modes}")
    inputs, logits_a = serve_rec.first_decode
    with torch.no_grad():
        logits_c, _ = M.decode_step(model, cfg, inputs[0], inputs[1],
                                    inputs[2], page_table=inputs[3])
    rel, _ = rel_err(logits_c, logits_a)
    if rel > TOL[BF16]:
        raise AssertionError(f"first decode step logits, stored vs analytic "
                             f"plans: normwise {rel:.3g} > {TOL[BF16]}")
    agree = sum(x == y for a, c in zip(reqs_a, reqs_c)
                for x, y in zip(a.out_tokens, c.out_tokens))
    total = sum(len(r.out_tokens) for r in reqs_a)
    med_a, med_c = (statistics.median(w[1:]) * 1e3 for w in (walls_a,
                                                             walls_c))
    dec = [r for r in rows if r["phase"] == "decode"]
    gemm_a = sum(r["per_decode_step"] * r["analytic_us"] for r in dec) / 1e3
    gemm_w = sum(r["per_decode_step"] * r["winner_us"] for r in dec) / 1e3
    log(f"  served with the stored plans: plan modes {served}; first decode "
        f"step logits normwise {rel:.2e} from the analytic run's; greedy "
        f"tokens agree {agree} / {total}; decode-step median "
        f"{med_a:.2f} ms analytic, {med_c:.2f} ms stored; the decode step's "
        f"GEMMs {gemm_a:.3f} ms analytic, {gemm_w:.3f} ms measured "
        f"(device, summed per signature)")
    del model
    free_card()

    # 6. A stored split-K record for the gate / up panels' dW,
    # (1024, 2048)^T (1024, 6144) in qwen.
    plan_store.reset_store()
    tuner.clear_planner_caches()
    dw_mkn = (cfg.d_model, TRAIN_TOKENS, cfg.d_ff)
    dw = [(args, kw) for (name, args, kw) in train_rec.signatures()
          if name == "plan_gemm" and args[:3] == dw_mkn
          and dict(kw).get("trans") == "tn"]
    if len(dw) != 1:
        raise AssertionError(f"qwen's dW signature: {dw}")
    (m, k, n, ib, ob), kw = dw[0]
    plan_store.get_store().put(tuner.dense_key(m, k, n, ib, ob, **dict(kw)),
                               SPLITK_RECORD)
    tuner.clear_planner_caches()
    log_s, bodies, splitk_launches = _qwen_steps(dev, 2)
    splitk = bodies["ftimm_gemm_splitk"]
    if not splitk["tc"]:
        raise AssertionError(f"ftimm_gemm_splitk did not launch: {bodies}")
    cmp = {}
    for key, i in (("loss", 0), ("loss", 1), ("grad_norm", 0)):
        a, b = log_a[i][key], log_s[i][key]
        cmp[f"step{i + 1}_{key}"] = [a, b]
        if abs(a - b) > TRAIN_REF_TOL * abs(a):
            raise AssertionError(f"split-K step {i + 1} {key} {b} vs "
                                 f"analytic {a} (> {TRAIN_REF_TOL})")
    log(f"  split-K record (nsplit 4, tc) at "
        f"{tuner.dense_key(m, k, n, ib, ob, **dict(kw))}: {splitk['tc']} "
        "launches in 2 qwen train steps; analytic vs split-K "
        + ", ".join(f"{k_} {a:.6g} / {b:.6g}" for k_, (a, b) in cmp.items()))
    tuner.clear_plan_cache()
    return {"signatures": len(sigs), "changed": sum(r["changed"]
                                                    for r in rows),
            "tune_s": tune_s, "rows": rows, "calibration": calib,
            "store_path": str(path.relative_to(ROOT)), "adopted": adopted,
            "served_plan_modes": served, "first_decode_logits_rel": rel,
            "greedy_agree": [agree, total],
            "decode_step_median_ms": {"analytic": med_a, "stored": med_c},
            "decode_gemm_device_ms": {"analytic": gemm_a,
                                      "measured": gemm_w},
            "splitk": {"launches_tc": splitk["tc"], **cmp},
            "launches": splitk_launches}


# ---------------------------------------------------------------------------
# Quantization: the 1-byte type paths of ftimm_gemm and ftimm_gemm_ragged,
# and llama4-scout served with quantized experts
# ---------------------------------------------------------------------------

QUANT_PAIRS = ((BF16, I8), (FP32, I8), (I8, I8), (E4, E4), (E5, E5))
QUANT_DX_PAIRS = tuple((a, b) for a in (BF16, FP32) for b in (I8, E4, E5))
# Served depth per mode: w8 at the [serve] depth, the others a depth cut.
QUANT_LAYERS = {"w8": MOE_LAYERS, "int8": 2, "w4": 2}
# The reference's MoE bound (tests/test_quant.py), Frobenius-normwise, on
# the first decode step's logits against the same weights unquantized.
# Gated for w8 and int8; w4 (7 levels) is reported.
QUANT_REF_TOL = 5e-2
QUANT_GATED = ("w8", "int8")


def _q(t: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """An fp32 tensor as a quantized operand of ``dtype`` and the scale
    that decodes it: int8 codes at its own per-tensor scale, fp8 scaled
    into the format's range, or a plain cast (scale 1)."""
    if dtype == I8:
        s = QUANT.symmetric_scale(t)
        return QUANT.quantize(t, s), s
    if dtype in (E4, E5):
        return QUANT.quantize_fp8(t, "e4m3" if dtype == E4 else "e5m2")
    return t.to(dtype), torch.ones((), device=t.device)


def _pair_name(pair) -> str:
    return " x ".join(_name(d).replace("float8_", "") for d in pair)


def _peak_dtype(pair):
    """The type whose peak bounds a pair's operations: a 1-byte pair at
    the int8 / fp8 tensor-core rate, a mixed one at its float operand's."""
    a, b = pair
    return a if _size(a) == 1 and _size(b) == 1 else (
        FP32 if FP32 in pair else BF16)


def quant_dense_case(label, m, k, n, *, pair, out, trans="nn", epi=True,
                     library=False, timed=False) -> Case:
    """``ftimm_gemm`` planned through the dispatch layer on pre-quantized
    operands (1-byte codes take its FMA body), the (N,) dequant vector at
    the flush (``epi``).  ``library``: the yardstick where one PyTorch call
    computes the same function (no epilogue then): ``torch._int_mm`` for
    int8 x int8, ``torch._scaled_mm`` for fp8 (B column-major, as it
    requires); for bf16 x int8, dequantize + ``torch.matmul``, two calls
    (``yardstick``)."""
    a_dt, b_dt = pair
    sb = (k, n) if trans == "nn" else (n, k)
    e = Epilogue(scale_vec=True) if epi else K.IDENTITY
    col_major = library and _size(a_dt) == 1 and a_dt != I8

    def make(gen):
        # The dequant vector decodes the product as the quantized matmul's
        # does (the two scales), times a per-column factor in [0.5, 1.5).
        b, sb_ = _q(_randn(gen, sb, FP32), b_dt)
        if col_major:
            b = b.t().contiguous().t()
        a, sa_ = _q(_randn(gen, (m, k), FP32), a_dt)
        return (a, b, sa_ * sb_ * (torch.rand(n, generator=gen,
                                                device=gen.device) + 0.5))

    def run(a, b, sv):
        return D._run_dense(a, b, trans, out, e, scale=sv if epi else None)

    def plain(a, b, sv):
        return K.ftimm_gemm_plain(a, b, trans=trans, out_dtype=out,
                                  epilogue=e, scale=sv if epi else None)

    lib = yard = None
    if library and pair == (I8, I8):
        lib = lambda a, b, sv: torch._int_mm(a, b)  # noqa: E731
    elif library and col_major:
        def lib(a, b, sv):
            one = torch.ones((), device=a.device)
            return torch._scaled_mm(a, b, scale_a=one, scale_b=one,
                                    out_dtype=out)
    elif library:       # in the activations' type, as a library call is
        yard = lambda a, b, sv: torch.matmul(  # noqa: E731
            a, QUANT.dequantize(b, sv, dtype=a_dt))
    nbytes = (m * k * _size(a_dt) + k * n * _size(b_dt) + 4 * n
              + m * n * _size(out))
    return Case("ftimm_gemm", f"{_pair_name(pair)} {label}", make, run,
                plain, lib, nbytes, 2.0 * m * n * k, _peak_dtype(pair), out,
                model=LLAMA4, phase="quant", timed=timed, yardstick=yard)


def quant_ragged_case(label, sizes, k, n, *, pair, out, tail=0,
                      library=False, timed=False) -> Case:
    """``ftimm_gemm_ragged`` planned through the dispatch layer on
    pre-quantized panels with the (G, N) dequant vector; ``tail`` rows no
    group owns.  ``library``: for bf16 x int8, dequantize +
    ``torch._grouped_mm``, two calls (``yardstick``); no PyTorch call
    takes int8 x int8 per group."""
    a_dt, b_dt = pair
    g, t = len(sizes), sum(sizes) + tail
    e = Epilogue(scale_vec=True)

    def make(gen):
        (x, sx), (w, sw) = (_q(_randn(gen, shape, FP32), dt) for shape, dt
                            in (((t, k), a_dt), ((g, k, n), b_dt)))
        return (x, w, _offsets(sizes, gen.device),
                sx * sw * (torch.rand(g, n, generator=gen,
                                      device=gen.device) + 0.5))

    def run(x, w, offs, sv):
        return D._run_ragged(x, w, offs, "nn", out, scale=sv)

    def plain(x, w, offs, sv):
        return K.ftimm_gemm_ragged_plain(x, w, offs, out_dtype=out,
                                         epilogue=e, scale=sv)

    yard = None
    if library and a_dt == BF16 and b_dt == I8 and not tail:
        yard = lambda x, w, offs, sv: torch._grouped_mm(  # noqa: E731
            x, QUANT.dequantize(w, sv[:, None, :], dtype=BF16),
            offs=offs[1:])          # bf16 out: held at bf16's tolerance
    touched = sum(1 for s in sizes if s)
    nbytes = (t * k * _size(a_dt) + touched * k * n * _size(b_dt)
              + 4 * touched * n + t * n * _size(out))
    return Case("ftimm_gemm_ragged", f"{_pair_name(pair)} {label}", make,
                run, plain, None, nbytes, 2.0 * (t - tail) * k * n,
                _peak_dtype(pair), out, model=LLAMA4, phase="quant",
                timed=timed, yardstick=yard)


def quant_cases() -> tuple[list[Case], list[Case]]:
    """(checked, timed): every quantized code of ``ftimm_gemm`` at qwen's
    and llama4's decode rows, a 128-row prefill and unaligned extents, nn
    (the forward) and nt (the straight-through dX); of
    ``ftimm_gemm_ragged`` at every shape the quantized llama4 serve
    launches: the decode distribution (4 rows to 4 of 16 experts), gate/up
    (5120 -> 8192) and down (8192 -> 5120), and the bucket prefills' 128
    and 256 routed rows (one expert empty) at the serve's output types
    (gate/up fp32, down bf16); and at an unaligned prefill distribution
    with an empty group and rows no group owns.  Timed: the decode shapes
    of the quantized llama4 step and their yardsticks."""
    l4, qw = get_config(LLAMA4), get_config(ARCH)
    e, d, f = l4.num_experts, l4.d_model, l4.d_ff
    decode = [1 if i % 4 == 0 else 0 for i in range(e)]
    rng = np.random.default_rng(9)

    def spread(rows):               # ``rows`` over e experts, expert 3 empty
        sizes = rng.multinomial(rows, [1.0 / (e - 1)] * (e - 1)).tolist()
        return sizes[:3] + [0] + sizes[3:]

    prefill = spread(123)
    buckets = {rows: spread(rows) for rows in (128, 256)}
    checked = []
    for pair in QUANT_PAIRS:
        for out in (BF16, FP32):
            checked += [
                quant_dense_case(f"qwen decode {qw.d_model}x{qw.d_ff}", 4,
                                 qw.d_model, qw.d_ff, pair=pair, out=out),
                quant_dense_case(f"llama4 decode {d}x{f}", 4, d, f,
                                 pair=pair, out=out),
                quant_dense_case(f"prefill 128 rows {qw.d_model}x{qw.d_ff}",
                                 128, qw.d_model, qw.d_ff, pair=pair,
                                 out=out),
                quant_dense_case("unaligned 33x257x65", 33, 257, 65,
                                 pair=pair, out=out),
                quant_ragged_case("llama4 decode gate/up", decode, d, f,
                                  pair=pair, out=out),
                quant_ragged_case("llama4 decode down", decode, f, d,
                                  pair=pair, out=out),
                quant_ragged_case(f"prefill {sum(prefill)}+5 rows (an empty "
                                  "expert, 5 unowned) 1100x1000", prefill,
                                  1100, 1000, pair=pair, out=out, tail=5)]
        for rows, sizes in buckets.items():
            checked += [
                quant_ragged_case(f"llama4 prefill {rows} rows gate/up",
                                  sizes, d, f, pair=pair, out=FP32),
                quant_ragged_case(f"llama4 prefill {rows} rows down", sizes,
                                  f, d, pair=pair, out=BF16)]
    for pair in QUANT_DX_PAIRS:
        checked += [
            quant_dense_case(f"dX nt llama4 decode {f}x{d}", 4, f, d,
                             pair=pair, out=FP32, trans="nt", epi=False),
            quant_dense_case("dX nt unaligned 33x257x65", 33, 257, 65,
                             pair=pair, out=FP32, trans="nt", epi=False)]
    timed = [
        quant_ragged_case("llama4 decode gate/up (w8)", decode, d, f,
                          pair=(BF16, I8), out=FP32, library=True,
                          timed=True),
        quant_ragged_case("llama4 decode down (w8)", decode, f, d,
                          pair=(BF16, I8), out=BF16, library=True,
                          timed=True),
        quant_ragged_case("llama4 decode gate/up (int8)", decode, d, f,
                          pair=(I8, I8), out=FP32, timed=True),
        quant_ragged_case("llama4 decode down (int8)", decode, f, d,
                          pair=(I8, I8), out=BF16, timed=True)]
    # Dense (the matmul(quant=) API's; no model path quantizes a dense
    # layer): w8 with its dequant vector beside dequantize + matmul, int8
    # and fp8 bare beside torch._int_mm / torch._scaled_mm.
    for label, m in (("decode", 4), ("prefill 128 rows", 128)):
        timed += [quant_dense_case(f"{label} {d}x{f}", m, d, f, pair=pair,
                                   out=FP32 if pair[0] == I8 else BF16,
                                   epi=pair == (BF16, I8), library=True,
                                   timed=True)
                  for pair in ((BF16, I8), (I8, I8), (E4, E4), (E5, E5))]
    return checked, timed


def check_quant(cases: list[Case], dev) -> dict[str, float]:
    """Each quantized case against its plain version on the card: int8 x
    int8 bitwise (an exact int32 sum, the same fp32 flush), the mixed and
    fp8 pairs within TOL (fp32 sums of exact products in another order)."""
    worst: dict[str, float] = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    for c in cases:
        inputs = c.make(gen)
        got, want = c.run(*inputs), c.plain(*inputs)
        torch.cuda.synchronize()
        rel, err = rel_err(got, want)
        exact = inputs[0].dtype == inputs[1].dtype == I8
        ok = torch.equal(got, want) if exact else rel <= TOL[c.out_dtype]
        if got.dtype != c.out_dtype or not ok:
            raise AssertionError(f"{c.kernel} {c.label} -> {c.out_dtype}: "
                                 f"normwise {rel:.3g}"
                                 + (" (must be bitwise)" if exact else ""))
        worst[c.kernel] = max(worst.get(c.kernel, 0.0), err)
        log(f"  ok  {c.kernel:18s} {c.label:66s} -> {_name(c.out_dtype):8s} "
            + ("bitwise" if exact else f"normwise {rel:.2e}"))
    return worst


def check_quant_refusals(dev) -> None:
    """The tensor-core and stream bodies, and every kernel without the
    quantized codes, raise on a 1-byte operand, each with its own message;
    nothing launches.  The card tests call this too."""
    gen = torch.Generator(device=dev).manual_seed(5)
    a, _ = _q(_randn(gen, (4, 256), FP32), I8)
    b, _ = _q(_randn(gen, (256, 256), FP32), I8)
    x = _randn(gen, (4, 256), BF16)
    w, _ = _q(_randn(gen, (2, 256, 256), FP32), I8)
    offs = _offsets([2, 2], dev)
    body = (ValueError, "body cannot take")
    calls = [(f"ftimm_gemm {name}", body, functools.partial(
                 K.ftimm_gemm, a, b, bm=tile[0], bn=tile[1], bk=tile[2],
                 out_dtype=FP32, body=name))
             for name, tile in (("tc", K.TC_TILES[0]), ("stream", K.TILES[0]))]
    calls += [(f"ftimm_gemm_ragged {name}", body, functools.partial(
                  K.ftimm_gemm_ragged, x, w, offs, bm=16, bn=32, bk=64,
                  out_dtype=FP32, body=name)) for name in ("tc", "stream")]
    calls += [("ftimm_gemm_grouped", (NotImplementedError,
                                      "ftimm_gemm_ragged"),
               lambda: K.ftimm_gemm_grouped(a[None], b[None], bm=16, bn=32,
                                            bk=64, out_dtype=FP32)),
              ("ftimm_gemm_ragged_swiglu", (NotImplementedError, ""),
               lambda: K.ftimm_gemm_ragged_swiglu(x, w, w, offs, bm=16, bn=32,
                                                  bk=64, out_dtype=FP32)),
              ("ftimm_gemm_splitk", (NotImplementedError, ""),
               lambda: K.ftimm_gemm_splitk(a, b, bm=16, bn=32, bk=64,
                                           nsplit=2, out_dtype=FP32))]
    K.reset_launch_counts()
    for label, (exc, words), call in calls:
        try:
            call()
        except exc as err:
            if words not in str(err):
                raise AssertionError(f"{label}: {err!r} does not say "
                                     f"{words!r}") from err
            continue
        raise AssertionError(f"{label} took a 1-byte operand")
    if any(K.launch_counts().values()):
        raise AssertionError(f"refused calls launched: {K.launch_counts()}")
    log(f"  {len(calls)} refusals: the tensor-core and stream bodies and the "
        "kernels without the quantized codes raise on int8 operands")


def check_quant_backward(dev, modes=("w8", "int8", "fp8_e4m3")) -> dict:
    """matmul(quant=) with a bias / silu / residual tail and
    ragged_matmul(quant=), forward and straight-through backward, card
    against the plain versions on the CPU, same inputs, for each of
    ``modes``.  The card tests call this too."""
    gen = torch.Generator().manual_seed(9)
    shapes = ((40, 300), (300, 72), (72,), (40, 72), (21, 300),
              (3, 300, 72), (40, 72))
    a, b, bias, res, x, w, cot = (torch.randn(s, generator=gen)
                                  for s in shapes)
    offs = torch.tensor([0, 9, 9, 21], dtype=torch.int32)
    epi = Epilogue(bias=True, activation="silu", residual=True)
    worst = {}
    for mode in modes:
        grads = []          # on the CPU, then on the card
        for d in (CPU, dev):
            ins = [t.detach().to(d).requires_grad_()
                   for t in (a, b, bias, res, x, w)]
            y = matmul(ins[0], ins[1], quant=mode, out_dtype=FP32,
                       epilogue=epi, bias=ins[2], residual=ins[3])
            z = ragged_matmul(ins[4], ins[5], offs.to(d), quant=mode,
                              out_dtype=FP32)
            ((y * cot.to(d)).sum() + (z ** 2).sum()).backward()
            grads.append([y.detach(), z.detach()] + [t.grad for t in ins])
        rel = max(rel_err(g.cpu(), c)[0] for g, c in zip(grads[1],
                                                          grads[0]))
        if rel > TOL[FP32]:
            raise AssertionError(f"quant={mode} backward: normwise {rel:.3g}")
        worst[mode] = rel
        log(f"  quant={mode}: forward and straight-through backward (dense "
            f"with a tail, ragged), card vs CPU: normwise {rel:.2e}")
    return worst


def serve_quant(mode: str, dev, profile: bool = False) -> dict:
    """llama4-scout with ``mode`` experts at full width and
    QUANT_LAYERS[mode] layers through ServeEngine, [serve]'s 6 requests;
    served twice (the second run recorded): the tokens must agree, every
    ragged launch must be the FMA body on 1-byte panels and no ragged
    SwiGLU pair may launch; the first decode step's logits against the
    same weights unquantized."""
    cfg = dataclasses.replace(get_config(f"{LLAMA4}-{mode}"),
                              num_layers=QUANT_LAYERS[mode])
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    model = M.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    runs = []
    for rec in (False, True):
        engine = ServeEngine(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN,
                             page_size=PAGE, device=dev)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(prompts)]
        K.reset_launch_counts()
        recorder = CallRecorder() if rec else contextlib.nullcontext()
        with PlanRecorder() as first, recorder:
            t0 = time.monotonic()
            engine.run(reqs)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        for r in reqs:
            if not r.done or len(r.out_tokens) != NEW_TOKENS:
                raise AssertionError(f"{cfg.name} request {r.rid} did not "
                                     f"finish: {len(r.out_tokens)} tokens")
        runs.append((reqs, wall, list(engine.walls["decode"]),
                     K.launch_counts(), K.body_counts(), recorder, first))
    # Timing and logits from the first run; the counts from the second,
    # the one the recorder saw.
    (reqs, wall, decode, _, _, _, first), \
        (reqs2, _, _, launches, bodies, recorder, _) = runs
    if [r.out_tokens for r in reqs] != [r.out_tokens for r in reqs2]:
        raise AssertionError(f"{cfg.name}: greedy tokens differ between two "
                             "runs")
    ragged = {}         # (x type, W type, rows, output type, body): calls
    for c in recorder.calls.values():
        if c["kernel"] == "ftimm_gemm_ragged":
            (_, (t, _), _, x_dt), (_, _, _, w_dt) = c["args"][:2]
            key = (_name(x_dt), _name(w_dt), t,
                   _name(c["kwargs"].get("out_dtype") or x_dt),
                   c["kwargs"].get("body", "fma"))
            ragged[key] = ragged.get(key, 0) + c["count"]
    bad = [key for key in ragged
           if key[1] not in ("int8", "float8_e4m3fn", "float8_e5m2")
           or key[4] != "fma"]
    rb = bodies["ftimm_gemm_ragged"]
    if not ragged or bad or launches["ftimm_gemm_ragged_swiglu"] \
            or not sum(rb.values()) == rb["fma"] \
            == launches["ftimm_gemm_ragged"] == sum(ragged.values()):
        raise AssertionError(f"{cfg.name}: ragged calls {bad}, launches "
                             f"{launches}, bodies {bodies}")
    if launches["ftimm_gemm_ragged"] < 3 * cfg.num_layers * len(decode):
        raise AssertionError(f"{cfg.name}: {launches['ftimm_gemm_ragged']} "
                             f"ragged launches in {len(decode)} decode steps")
    if first.first_decode is None:
        raise AssertionError(f"{cfg.name}: no decode step")
    inputs, logits = first.first_decode
    with torch.no_grad():
        want, _ = M.decode_step(model, dataclasses.replace(cfg, quant="none"),
                                inputs[0], inputs[1], inputs[2],
                                page_table=inputs[3])
    diff = (logits.float() - want.float())
    rel = float(torch.linalg.norm(diff) / torch.linalg.norm(want.float()))
    maxrel, _ = rel_err(logits, want)
    if mode in QUANT_GATED and rel > QUANT_REF_TOL:
        raise AssertionError(f"{cfg.name}: first decode step logits "
                             f"{rel:.3g} from unquantized > {QUANT_REF_TOL}")
    out = {"layers": cfg.num_layers, "init_s": init_s, "wall_s": wall,
           "tokens": sum(len(r.out_tokens) for r in reqs),
           "decode_steps": len(decode),
           "decode_step_median_ms": statistics.median(decode[1:]) * 1e3,
           "peak_device_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": launches, "ragged_bodies": bodies["ftimm_gemm_ragged"],
           "ragged_calls_by_x_w_rows_out_body": {
               " ".join(map(str, key)): n for key, n in sorted(
                   ragged.items())},
           "first_decode_logits_rel_fro": rel,
           "first_decode_logits_rel_max": maxrel,
           "gated": mode in QUANT_GATED}
    log(f"  {cfg.name} at {cfg.num_layers} layers (init {init_s:.1f} s): "
        f"{out['tokens']} tokens in {wall:.2f} s, {len(decode)} decode steps,"
        f" median {out['decode_step_median_ms']:.2f} ms; peak device memory "
        f"{out['peak_device_gb']:.2f} GB; ftimm_gemm_ragged {launches['ftimm_gemm_ragged']}"
        f" launches, all FMA on 1-byte panels, no ragged SwiGLU pair; "
        f"tokens identical over two runs; first decode step logits vs "
        f"unquantized: {rel:.3e} Frobenius, {maxrel:.3e} max-normwise"
        + (f" (gate {QUANT_REF_TOL})" if mode in QUANT_GATED else
           " (reported, not gated)"))
    if profile:
        prof = profile_decode(cfg, model, slots=SLOTS, device=dev)
        top = prof.pop("top_kernels")
        log(f"  profile_serve --arch {LLAMA4}-{mode} --layers "
            f"{cfg.num_layers}: device busy {prof['device_busy_ms']:.2f} "
            f"ms / step, wall {prof['step_wall_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.3f}")
        for group, ms in sorted(prof["device_ms_per_step"].items(),
                                key=lambda kv: -kv[1]):
            log(f"    {group:34s} {ms:9.3f} ms / step")
        for name, count, ms in top[:6]:
            log(f"    top {ms:8.3f} ms x{count:<4d} {name[:90]}")
        out["profile"] = prof
        out["param_bytes"] = param_bytes(model)
    del model
    free_card()
    return out


def quant_pass_ms(dev) -> dict:
    """Device ms of the dispatch layer's per-call weight quantization of
    one llama4 expert stack, (16, 5120, 8192) bf16, per mode; a decode
    step runs it 3 times a layer."""
    l4 = get_config(LLAMA4)
    gen = torch.Generator(device=dev).manual_seed(8)
    w = [_randn(gen, (l4.num_experts, l4.d_model, l4.d_ff), BF16)
         for _ in range(2)]
    sleep = sleep_ms_per_mcycle()
    out = {}
    for mode in ("w8", "w4", "int8"):
        qcfg = QUANT.QuantConfig(mode)
        out[mode] = time_ms(lambda t: D._quantize_weight(t, qcfg),
                            [(t,) for t in w], 4, sleep)
    gb = w[0].numel() * 2 / 1e9
    log(f"  weight quantization of one expert stack ({gb:.2f} GB bf16): "
        + ", ".join(f"{m} {ms:.3f} ms" for m, ms in out.items())
        + f"; one bf16 read is {gb / HBM_BYTES_PER_S * 1e12:.3f} ms; x "
        f"{3 * MOE_LAYERS} a decode step at {MOE_LAYERS} layers")
    del w
    free_card()
    return out


def quant_phase(dev) -> tuple[dict, dict[str, float], list[dict]]:
    checked, timed = quant_cases()
    worst = check_quant(checked, dev)
    check_quant_refusals(dev)
    backward = check_quant_backward(dev)
    free_card()
    serving = {}
    for mode in ("w8", "int8", "w4"):
        serving[mode] = serve_quant(mode, dev, profile=mode == "w8")
    passes = quant_pass_ms(dev)
    rows = timings(timed, dev)
    for r in rows:
        log(f"  {r['kernel']:18s} {r['label']:52s} kernel "
            f"{r['ms'] * 1e3:9.1f} us  plain {r['plain_ms'] * 1e3:9.1f} us  "
            f"library " + ("-" if r["library_ms"] is None
                           else f"{r['library_ms'] * 1e3:.1f}")
            + " us  yardstick " + ("-" if r["yardstick_ms"] is None
                                   else f"{r['yardstick_ms'] * 1e3:.1f}")
            + f" us  bound {r['bound_ms'] * 1e3:7.1f} us ({r['bound_by']})")
    return ({"backward_rel": backward, "serving": serving,
             "quant_pass_ms": passes, "checked": len(checked)}, worst, rows)


# ---------------------------------------------------------------------------
# The kernels line
# ---------------------------------------------------------------------------

# What each SwiGLU pair's yardstick_ms times: no one PyTorch call computes
# the pair.
# ---------------------------------------------------------------------------
# [archs]: the last three dense architectures
# ---------------------------------------------------------------------------

def arch_path_cases(arch: str) -> list[Case]:
    """Every GEMM shape of one decode step of ``arch`` at SLOTS slots on
    the paged rung (with its launch count at full depth), the attention
    over the served page view: q, k / v, o and down with the residual, the
    tied unembed ``nt`` to fp32 (gemma3's 262,144 rows, minitron's 256,000),
    the gate/up pair, and the fp32 QK^T / PV (gemma3 at head_dim 256)."""
    cfg = get_config(arch)
    d, f, v, n_layers = cfg.d_model, cfg.d_ff, cfg.vocab_padded, cfg.num_layers
    hq, hkv = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_
    hd, groups = cfg.head_dim_, SLOTS * cfg.num_kv_heads
    qpg = cfg.num_heads // cfg.num_kv_heads
    view = E.pages_for(ARCH_MAX_LEN[arch], PAGE) * PAGE
    return [
        dense_case(f"{arch} decode q", SLOTS, d, hq, per_step=n_layers,
                   model=arch),
        dense_case(f"{arch} decode k/v", SLOTS, d, hkv,
                   per_step=2 * n_layers, model=arch),
        dense_case(f"{arch} decode o+res", SLOTS, hq, d, residual=True,
                   per_step=n_layers, model=arch),
        dense_case(f"{arch} decode down+res", SLOTS, f, d, residual=True,
                   per_step=n_layers, model=arch),
        dense_case(f"{arch} decode unembed", SLOTS, d, v, trans="nt",
                   out=FP32, per_step=1, model=arch),
        swiglu_case(f"{arch} decode gate/up", SLOTS, d, f,
                    per_step=n_layers, model=arch),
        grouped_case(f"{arch} decode qk^T hd {hd}", groups, qpg, hd, view,
                     trans="nt", per_step=n_layers, model=arch),
        grouped_case(f"{arch} decode pv hd {hd}", groups, qpg, view, hd,
                     per_step=n_layers, model=arch),
    ]


def arch_reference(arch: str, dev) -> dict:
    """``arch`` in fp32 at full width and ARCH_REF layers, card against
    CPU, same weights: a prefill of one seeded prompt, its rows inserted
    into a page pool (pages in reverse order), then ARCH_REF_STEPS decode
    steps through the page table.  The logits of every step and both page
    pools must agree within REC_REF_TOL normwise.  gemma3 runs 6 layers
    (five with the 1024 window, one global) over a 1,100-token prompt, so
    its windowed layers drop rows in decode."""
    layers, prompt_len = ARCH_REF[arch]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              compute_dtype="float32")
    t0 = time.monotonic()
    gpu_model = M.init_params(cfg, 0, device=dev)
    cpu_model = copy.deepcopy(gpu_model).to(CPU)
    rng = np.random.default_rng(11)
    prompt = rng.integers(2, cfg.vocab_size, (1, prompt_len))
    nxt = rng.integers(2, cfg.vocab_size, (1, ARCH_REF_STEPS))
    cap = prompt_len + ARCH_REF_STEPS
    n_pages = E.pages_for(cap, PAGE)
    pages = list(range(n_pages, 0, -1))
    runs = {}
    for name, model, device in (("gpu", gpu_model, dev),
                                ("cpu", cpu_model, CPU)):
        t1 = time.monotonic()
        one = M.make_cache(cfg, 1, prompt_len, device=device)
        logits, one = M.prefill(
            model, cfg, {"tokens": torch.as_tensor(prompt).to(device)}, one)
        kv = E.PagedKV.build(cfg, slots=1, max_len=cap,
                             num_pages=n_pages + 1, page_size=PAGE,
                             device=device)
        have = E.pages_for(prompt_len, PAGE)
        kv.insert(0, pages[:have], one["k"][:, 0], one["v"][:, 0])
        del one
        out = [logits]
        for step in range(ARCH_REF_STEPS):
            pos = prompt_len + step
            need = E.pages_for(pos + 1, PAGE)
            if need > have:
                kv.extend_slot(0, pages[have:need], have)
                have = need
            logits, _ = M.decode_step(
                model, cfg, torch.as_tensor(nxt[:, step:step + 1]).to(device),
                kv.cache(), torch.as_tensor([pos]),
                page_table=kv.device_table())
            out.append(logits)
        runs[name] = ([t[:, :cfg.vocab_size].cpu() for t in out],
                      {k: t.cpu() for k, t in kv.cache().items()},
                      time.monotonic() - t1)
        del kv
    del gpu_model, cpu_model
    free_card()
    (g_out, g_pool, g_s), (c_out, c_pool, c_s) = runs["gpu"], runs["cpu"]
    logits_rel = [rel_err(a, b)[0] for a, b in zip(g_out, c_out)]
    pool_rel = {k: rel_err(g_pool[k], c_pool[k])[0] for k in g_pool}
    worst = max(*logits_rel, *pool_rel.values())
    log(f"  {arch} fp32, {layers} layers (windows "
        f"{cfg.windows()}), full width, a {prompt_len}-token prompt and "
        f"{ARCH_REF_STEPS} paged decode steps: logits normwise by step "
        + ", ".join(f"{x:.2e}" for x in logits_rel) + "; pools "
        + ", ".join(f"{k} {x:.2e}" for k, x in pool_rel.items())
        + f" (card {g_s:.1f} s, CPU {c_s:.1f} s, "
        f"{time.monotonic() - t0:.1f} s in all)")
    if worst > REC_REF_TOL:
        raise AssertionError(f"{arch} fp32 paged reference: normwise "
                             f"{worst:.3g} > {REC_REF_TOL}")
    return {"layers": layers, "prompt_len": prompt_len,
            "windows": list(cfg.windows()),
            "logits_normwise_by_step": logits_rel, "pool_normwise": pool_rel}


def serve_arch(arch: str, dev) -> tuple[dict, dict, dict]:
    """Serve ``arch`` at full width and depth, bf16, random weights from
    seed 0, on the paged rung through ServeEngine: PROMPT_LENS's 6
    requests of NEW_TOKENS, and for gemma3 two more of LONG_PROMPT tokens
    and LONG_NEW new tokens each (their history passes the 1024 window).
    Every request must finish with in-vocabulary tokens and no fault, every
    kernel of the path launch, the pages drain; a decode step launches
    ftimm_gemm 5 x layers + 1 times (all on the stream body), the pair
    once and the two fp32 attention products twice a layer (rows body).
    Returns (stats, the launch counts of just this run, its body counts)."""
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    model = M.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in model.parameters())
    log(f"  {arch}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim_}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, qk_norm {cfg.qk_norm}, windows "
        f"{cfg.window_pattern}; init {time.monotonic() - t0:.1f} s, "
        f"{params / 1e9:.3f} B params")
    engine = ServeEngine(cfg, model, batch_slots=SLOTS,
                         max_len=ARCH_MAX_LEN[arch], page_size=PAGE,
                         device=dev)
    rng = np.random.default_rng(0)
    lens = list(PROMPT_LENS) + ([LONG_PROMPT] * 2 if arch == GEMMA else [])
    news = [NEW_TOKENS] * len(PROMPT_LENS) + [LONG_NEW] * (len(lens)
                                                           - len(PROMPT_LENS))
    reqs = [Request(rid=i, max_new_tokens=m, prompt=rng.integers(
        2, cfg.vocab_size, n).astype(np.int32))
        for i, (n, m) in enumerate(zip(lens, news))]
    K.reset_launch_counts()
    t0 = time.monotonic()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, bodies = K.launch_counts(), K.body_counts()
    decode = list(engine.walls["decode"])
    prefill = [[b, s * 1e3] for b, s in engine.walls["prefill"]]
    for r in reqs:
        if not r.done or r.timed_out or len(r.out_tokens) != r.max_new_tokens:
            raise AssertionError(f"{arch} request {r.rid} did not finish: "
                                 f"{len(r.out_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{arch} request {r.rid}: token out of "
                                 "range")
    if any(engine.faults.values()):
        raise AssertionError(f"{arch} engine faults: {engine.faults}")
    missing = [k for k in PATH_KERNELS[("serve", arch)] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{arch}: {missing} never launched: {launches}")
    engine.alloc.check()
    if engine.alloc.available != engine.alloc.total:
        raise AssertionError(f"{arch}: the page pool did not drain")
    deepest = max(len(r.prompt) + len(r.out_tokens) - 1 for r in reqs)
    per_step = decode_launches(engine, dev)
    step_bodies = {k: {b: n for b, n in v.items() if n}
                   for k, v in K.body_counts().items() if any(v.values())}
    if set(step_bodies["ftimm_gemm"]) != {"stream"} or set(
            step_bodies["ftimm_gemm_grouped"]) != {"rows"}:
        raise AssertionError(f"{arch}: a decode step's bodies {step_bodies}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    view = engine.kv.table.shape[1] * PAGE
    del engine
    free_card()
    prof = profile_decode(cfg, model, slots=SLOTS, prompt_len=24, warm=3,
                          steps=5, device=dev)
    prof.pop("top_kernels")
    tokens = sum(len(r.out_tokens) for r in reqs)
    stats = {"layers": cfg.num_layers, "params_b": params / 1e9,
             "param_bytes": param_bytes(model),
             "requests": len(reqs), "prompt_lens": lens, "tokens": tokens,
             "wall_s": wall, "tokens_per_s": tokens / wall,
             "decode_steps": len(decode),
             "decode_step_median_ms": statistics.median(decode[1:]) * 1e3,
             "prefill_ms": prefill, "peak_device_gb": peak,
             "deepest_history": deepest, "view_len": view,
             "launches": launches, "bodies": bodies,
             "launches_per_decode_step": per_step,
             "bodies_per_decode_step": step_bodies, "profile": prof}
    log(f"  served {len(reqs)} requests, {tokens} tokens in {wall:.2f} s: "
        f"{stats['tokens_per_s']:.1f} tokens/s; {len(decode)} decode steps, "
        f"median {stats['decode_step_median_ms']:.2f} ms (first "
        f"{decode[0] * 1e3:.1f} ms); prefill ms (bucket or None, ms) "
        + ", ".join(f"{b}: {ms:.1f}" for b, ms in prefill)
        + f"; deepest history {deepest} rows over a {view}-row page view; "
        f"peak device memory {peak:.2f} GB")
    log(f"  one decode step launches {per_step}, bodies {step_bodies}; "
        f"profile_decode, {SLOTS} slots, 5 steps: wall median "
        f"{prof['step_wall_ms']:.2f} ms, device busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share "
        f"{prof['idle_share']:.3f}, {prof['launches_per_step']:.0f} device "
        "launches a step; device ms a step by group: "
        + ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(
            prof["device_ms_per_step"].items(), key=lambda kv: -kv[1])))
    for r in reqs[:1] + reqs[len(PROMPT_LENS):]:
        log(f"  req {r.rid} ({len(r.prompt)} prompt tokens): {r.out_tokens}")
    del model
    free_card()
    return stats, launches, bodies


def archs_phase(dev) -> tuple[dict, dict, dict]:
    """[archs]: each new architecture's fp32 paged reference, then served
    at full width and depth, one model on the card at a time.  Returns
    (stats, launches and bodies by run)."""
    out = {"reference": {}, "serve": {}}
    launches, bodies = {}, {}
    for arch in NEW_ARCHS:
        out["reference"][arch] = arch_reference(arch, dev)
        out["serve"][arch], launches[("serve", arch)], bodies[
            ("serve", arch)] = serve_arch(arch, dev)
    return out, launches, bodies


# ---------------------------------------------------------------------------
# [chaos]: the chaos sites and the fused -> unfused rung on the card
# ---------------------------------------------------------------------------

class LogitsRecorder:
    """While entered, every logits tensor ``engine`` computes is kept on
    the host: decode rows by (request id, index of the token they give),
    prefill rows (bucketed or exact) by the token history they read."""

    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self.decode: dict[tuple[int, int], torch.Tensor] = {}
        self.prefill: dict[tuple, torch.Tensor] = {}
        self._saved = {}

    def __enter__(self):
        eng = self.engine
        for name in ("decode_step", "prefill_bucket", "prefill"):
            self._saved[name] = getattr(E, name)

        def decode(*args, **kw):
            logits, cache = self._saved["decode_step"](*args, **kw)
            rows = logits.float().cpu()
            for i, r in enumerate(eng.active):
                if r is not None:
                    self.decode[(r.rid, len(r.out_tokens))] = rows[i]
            return logits, cache

        def prefill(model, cfg, batch, cache, *lens):
            fn = self._saved["prefill_bucket" if lens else "prefill"]
            logits, cache = fn(model, cfg, batch, cache, *lens)
            toks = batch["tokens"].cpu().numpy()
            n = lens[0].tolist() if lens else [toks.shape[1]] * len(toks)
            rows = logits.float().cpu()
            for j in range(len(toks)):
                self.prefill[tuple(toks[j, :n[j]].tolist())] = rows[j]
            return logits, cache

        E.decode_step, E.prefill_bucket, E.prefill = decode, prefill, prefill
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(E, name, fn)


class PlainCounter:
    """Counts the calls of every kernel's plain version while entered."""

    def __init__(self):
        self.calls = 0
        self._saved = {}

    def __enter__(self):
        for name in K.KERNELS:
            plain = name + "_plain"
            self._saved[plain] = fn = getattr(K, plain)

            def counted(*a, _fn=fn, **kw):
                self.calls += 1
                return _fn(*a, **kw)
            setattr(K, plain, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(K, name, fn)


def _chaos_engine(cfg, model, dev) -> ServeEngine:
    return ServeEngine(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN,
                       page_size=PAGE, device=dev)


def _chaos_requests(prompts) -> list[Request]:
    return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]


def _degraded_fused() -> int:
    return tuner.degraded_stats().get("dense:fused->unfused", 0)


def chaos_fused(cfg, model, dev, prompts) -> dict:
    """``kernel_fused`` armed on one decode step of 4 busy slots: on the o
    + residual and down + residual projections only, on the gate/up pairs
    only, and on all of them.  Each faulted step's logits must lie within
    TOL[BF16] of the clean step's; the degraded counter must rise by the
    faults armed; the launch counts must show the unfused spellings on the
    kernels (an epilogue: the identity ftimm_gemm instead of the fused
    one; a pair: two ftimm_gemm instead of ftimm_gemm_swiglu, all on the
    stream body), and no plain version may run."""
    engine = _chaos_engine(cfg, model, dev)
    for r in _chaos_requests(prompts[:SLOTS]):
        engine.submit(r)
    engine.step()
    engine.step()
    layers = cfg.num_layers
    pair_occ: list[int] = []
    real_pair = D._fused_pair

    def step(plan):
        last = torch.as_tensor([[r.out_tokens[-1]] for r in engine.active],
                               dtype=torch.long).to(dev)
        K.reset_launch_counts()
        with chaos.chaos(plan), PlainCounter() as plain:
            logits, _ = M.decode_step(
                engine.params, cfg, last, engine.kv.cache(),
                torch.as_tensor(engine.pos, dtype=torch.long),
                page_table=engine.kv.device_table())
            torch.cuda.synchronize()
        if plain.calls:
            raise AssertionError(f"[chaos] {plain.calls} plain-version "
                                 "calls on the card")
        return (logits.float().cpu(), K.launch_counts(),
                K.body_counts()["ftimm_gemm"])

    def spy(*args, **kw):
        pair_occ.append(probe.counters.get("kernel_fused", 0))
        return real_pair(*args, **kw)

    probe = chaos.FaultPlan([])
    D._fused_pair = spy
    try:
        clean, clean_launches, _ = step(probe)
    finally:
        D._fused_pair = real_pair
    n_fused = probe.counters["kernel_fused"]
    epi_occ = [o for o in range(n_fused) if o not in pair_occ]
    if len(pair_occ) != layers or len(epi_occ) != 2 * layers:
        raise AssertionError(f"[chaos] {n_fused} fused launches a step, "
                             f"{len(pair_occ)} of them pairs")
    base = {"ftimm_gemm": 5 * layers + 1, "ftimm_gemm_swiglu": layers,
            "ftimm_gemm_grouped": 2 * layers}
    if {k: v for k, v in clean_launches.items() if v} != base:
        raise AssertionError(f"[chaos] clean step launched {clean_launches}")
    out = {"fused_launches_per_step": n_fused}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for name, occ, pairs in (("epilogues", epi_occ, 0),
                                 ("pairs", pair_occ, layers),
                                 ("all", list(range(n_fused)), layers)):
            before = _degraded_fused()
            plan = chaos.FaultPlan([chaos.Fault("kernel_fused", at=o)
                                    for o in occ])
            logits, launches, gemm_bodies = step(plan)
            rel, _ = rel_err(logits, clean)
            counted = _degraded_fused() - before
            want = dict(base, ftimm_gemm=base["ftimm_gemm"] + 2 * pairs,
                        ftimm_gemm_swiglu=layers - pairs)
            got = {k: v for k, v in launches.items() if v}
            want = {k: v for k, v in want.items() if v}
            if plan.fired.get("kernel_fused", 0) != len(occ) or counted != len(
                    occ):
                raise AssertionError(f"[chaos] {name}: {len(occ)} faults, "
                                     f"{counted} degraded servings")
            if got != want or set(
                    b for b, n in gemm_bodies.items() if n) != {"stream"}:
                raise AssertionError(f"[chaos] {name}: launched {got} "
                                     f"({gemm_bodies}), want {want}")
            if rel > TOL[BF16]:
                raise AssertionError(f"[chaos] {name}: logits normwise "
                                     f"{rel:.3g} from the clean step")
            out[name] = {"faults": len(occ), "degraded": counted,
                         "logits_normwise": rel, "launches": got}
            log(f"  kernel_fused on the {name} ({len(occ)} faults): "
                f"degraded +{counted}, launches {got}, logits normwise "
                f"{rel:.2e} from the clean step")
    warned = [str(r.message) for r in rec
              if "gemm dispatch degraded" in str(r.message)]
    if len(warned) != 1:
        raise AssertionError(f"[chaos] rung warnings: {warned}")
    engine.run([])
    return out


def chaos_kernel(dev) -> dict:
    """The ``kernel`` site on CUDA tensors raises KernelLaunchFailure out
    of the call: no launch, no plain version (kernel or raise)."""
    a = torch.randn((SLOTS, 2048), device=dev).to(BF16)
    b = torch.randn((2048, 2048), device=dev).to(BF16)
    K.reset_launch_counts()
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("kernel")])), \
            PlainCounter() as plain:
        try:
            matmul(a, b)
        except chaos.KernelLaunchFailure as e:
            raised = str(e)
        else:
            raise AssertionError("[chaos] the kernel site did not raise")
        matmul(a, b)
        torch.cuda.synchronize()
    launched = K.launch_counts()["ftimm_gemm"]
    if plain.calls or launched != 1:
        raise AssertionError(f"[chaos] kernel site: {plain.calls} plain "
                             f"calls, {launched} launches")
    log(f"  kernel on a CUDA tensor: raised ({raised}); the next call "
        "launched once, no plain version ran")
    return {"raised": raised, "plain_calls": plain.calls}


def _recovered(vocab, clean_rec, rec, clean, reqs, what) -> dict:
    """The requests that ``what`` sent back through a prefill: every token
    in the vocabulary; the re-prefill's logits within TOL[BF16] of the
    clean run's decode logits for the same token, and the first decode step
    after it within TOL[BF16] of the clean run's (compared when the
    re-prefill chose the clean run's token, so that both steps read the
    same history); the tokens that agree with the clean run's."""
    for r in reqs:
        if not all(0 <= t < vocab for t in r.out_tokens):
            raise AssertionError(f"[chaos] {what}: request {r.rid} emitted "
                                 f"{r.out_tokens}")
    redone = [(key, r) for r in reqs for key in rec.prefill
              if len(key) > len(r.prompt)
              and key[:len(r.prompt)] == tuple(r.prompt.tolist())
              and list(key[len(r.prompt):]) == r.out_tokens[
                  :len(key) - len(r.prompt)]]
    if not redone:
        raise AssertionError(f"[chaos] {what}: no request was re-prefilled")
    out = {}
    for key, r in redone:
        t = len(key) - len(r.prompt)
        rel_pre, _ = rel_err(rec.prefill[key], clean_rec.decode[(r.rid, t)])
        if rel_pre > TOL[BF16]:
            raise AssertionError(f"[chaos] {what}: request {r.rid}'s "
                                 f"re-prefill logits normwise {rel_pre:.3g}")
        rel_next = None
        if (r.out_tokens[t] == clean[r.rid][t]
                and (r.rid, t + 1) in rec.decode):
            rel_next, _ = rel_err(rec.decode[(r.rid, t + 1)],
                                  clean_rec.decode[(r.rid, t + 1)])
            if rel_next > TOL[BF16]:
                raise AssertionError(f"[chaos] {what}: request {r.rid}'s "
                                     f"first step after the re-prefill: "
                                     f"normwise {rel_next:.3g}")
        agree = sum(a == b for a, b in zip(r.out_tokens, clean[r.rid]))
        out[r.rid] = {"reprefilled_at_token": t,
                      "reprefill_logits_normwise": rel_pre,
                      "next_step_logits_normwise": rel_next,
                      "tokens_agreeing": agree, "tokens": len(r.out_tokens)}
        log(f"  {what}: request {r.rid} re-prefilled at token {t}: logits "
            f"normwise {rel_pre:.2e} from the clean decode, next step "
            + (f"{rel_next:.2e}" if rel_next is not None else
               "not compared (the re-prefill chose another token)")
            + f"; {agree} of {len(r.out_tokens)} tokens as the clean run")
    return out


def chaos_phase(dev) -> dict:
    """[chaos]: qwen3-1.7b at full width and CHAOS_LAYERS layers on the
    paged rung, bf16.  The fused -> unfused rung on a decode step, the
    ``kernel`` site's raise, then PROMPT_LENS's 6 requests served clean
    and under each engine site: ``transient_decode@1x2`` (bit-identical
    tokens, 2 retries), ``nan_logits`` and ``page_exhaustion`` (a slot
    re-prefilled: the bounds of ``_recovered``; the pool checked and
    drained), ``bucket_miss`` (the exact prefill, within TOL[BF16] of the
    bucketed one); and ``plan_save_crash`` (the on-disk store intact)."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=CHAOS_LAYERS)
    model = M.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    out = {"fused": chaos_fused(cfg, model, dev, prompts),
           "kernel": chaos_kernel(dev)}

    eng = _chaos_engine(cfg, model, dev)
    growth: list[bool] = []
    real_alloc = eng._alloc_pages

    def alloc(req, n, *, active_slot=None):
        growth.append(active_slot is not None)
        return real_alloc(req, n, active_slot=active_slot)

    eng._alloc_pages = alloc
    with LogitsRecorder(eng) as clean_rec:
        clean = [r.out_tokens for r in eng.run(_chaos_requests(prompts))]

    def faulted(fault):
        engine = _chaos_engine(cfg, model, dev)
        reqs = _chaos_requests(prompts)
        with chaos.chaos(chaos.FaultPlan([fault])) as plan, \
                LogitsRecorder(engine) as rec:
            engine.run(reqs)
        if plan.fired.get(fault.site) != fault.count:
            raise AssertionError(f"[chaos] {fault.site}: fired {plan.fired}")
        return engine, reqs, rec

    engine, reqs, _ = faulted(chaos.Fault("transient_decode", at=1,
                                          count=2))
    if [r.out_tokens for r in reqs] != clean or engine.faults[
            "transient_retries"] != 2:
        raise AssertionError(f"[chaos] transient_decode: {engine.faults}")
    out["transient_decode"] = {"retries": 2, "tokens_identical": True}
    log("  transient_decode@1x2: 2 retries, tokens bit-identical")

    engine, reqs, rec = faulted(chaos.Fault("nan_logits", at=3, slot=1))
    if engine.faults["nonfinite_quarantined"] != 1:
        raise AssertionError(f"[chaos] nan_logits: {engine.faults}")
    out["nan_logits"] = _recovered(cfg.vocab_size, clean_rec, rec, clean,
                                   reqs, "nan_logits")

    at = growth.index(True)
    engine, reqs, rec = faulted(chaos.Fault("page_exhaustion", at=at))
    engine.alloc.check()
    if (engine.faults["preemptions"] < 1
            or engine.alloc.available != engine.alloc.total):
        raise AssertionError(f"[chaos] page_exhaustion: {engine.faults}")
    out["page_exhaustion"] = {
        "at_allocation": at, "preemptions": engine.faults["preemptions"],
        "requests": _recovered(cfg.vocab_size, clean_rec, rec, clean, reqs,
                               "page_exhaustion")}

    engine, reqs, rec = faulted(chaos.Fault("bucket_miss", at=0))
    key = tuple(prompts[0].tolist())
    rel, _ = rel_err(rec.prefill[key], clean_rec.prefill[key])
    exact = [b for b, _ in engine.walls["prefill"] if b is None]
    if engine.faults["bucket_misses"] != 1 or len(exact) != 1 or rel > TOL[
            BF16]:
        raise AssertionError(f"[chaos] bucket_miss: {engine.faults}, "
                             f"{len(exact)} exact prefills, normwise {rel}")
    agree = sum(a == b for r, c in zip(reqs, clean)
                for a, b in zip(r.out_tokens, c))
    out["bucket_miss"] = {"prefill_logits_normwise": rel,
                          "tokens_agreeing": agree,
                          "tokens": sum(map(len, clean))}
    log(f"  bucket_miss: one exact-length prefill, logits normwise {rel:.2e}"
        f" from the bucketed one; {agree} of {sum(map(len, clean))} tokens "
        "as the clean run")

    d = ROOT / "build" / "chaos"
    d.mkdir(parents=True, exist_ok=True)
    path = d / "plans.json"
    st = plan_store.PlanStore()
    kind = plan_store.device_kind(dev)
    st.put("dense|64x64x64|ib2|ob2", {"bm": 16, "bn": 32, "bk": 64}, kind)
    st.save(str(path))
    before = path.read_bytes()
    st.put("dense|128x64x64|ib2|ob2", {"bm": 16, "bn": 32, "bk": 64}, kind)
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("plan_save_crash")])):
        try:
            st.save(str(path))
        except chaos.ChaosError:
            pass
        else:
            raise AssertionError("[chaos] plan_save_crash did not fire")
    litter = [p.name for p in d.iterdir() if p.name.startswith(".plan_cache")]
    if path.read_bytes() != before or litter:
        raise AssertionError(f"[chaos] plan_save_crash left {litter}")
    if plan_store.PlanStore().load(str(path)) != 1:
        raise AssertionError("[chaos] the store did not load back")
    path.unlink()
    out["plan_save_crash"] = {"store_intact": True}
    log("  plan_save_crash: the store on disk byte-identical, no temp file")
    out["degraded"] = tuner.degraded_stats()
    # The degraded servings counted here were injected: the phases after
    # this one start from an empty census.
    tuner.DEGRADED_COUNTS.clear()
    D._WARNED_RUNGS.clear()
    del model
    free_card()
    return out


# ---------------------------------------------------------------------------
# [train-dots]: remat="dots" against remat="full"
# ---------------------------------------------------------------------------

def train_dots_phase(dev, opt_cfg: OptConfig) -> dict:
    """qwen3-1.7b at full width and depth, bf16 compute on fp32 masters,
    DOTS_STEPS AdamW steps of TRAIN_BATCH x TRAIN_SEQ, from the same seed
    and batches with remat "full" and "dots".  The losses and every
    gradient leaf of every step must be bitwise equal (PyTorch's own ops
    in their deterministic algorithms: the embedding's index backward
    otherwise accumulates with atomics); each step's ftimm_gemm and
    ftimm_gemm_swiglu launches must be lower under "dots" by exactly the
    forward products it does not recompute: 5 and 1 a layer."""
    base = get_config(ARCH)
    shape = ShapeConfig("dots", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    data = SyntheticLM(base, shape, seed=0)
    batches = [{k: torch.as_tensor(v).to(dev)
                for k, v in data.host_batch(s).items()}
               for s in range(DOTS_STEPS)]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs, full_grads = {}, []
    try:
        for remat in ("full", "dots"):
            cfg = dataclasses.replace(base, remat=remat)
            free_card()
            torch.cuda.reset_peak_memory_stats(dev)
            model = M.init_params(cfg, 0, device=dev, dtype=cfg.param_dtype)
            opt = init_opt_state(dict(model.named_parameters()))
            step_fn = make_train_step(cfg, opt_cfg)
            losses, walls, launches = [], [], []
            for i, batch in enumerate(batches):
                K.reset_launch_counts()
                t0 = time.monotonic()
                model, opt, m = step_fn(model, opt, batch)
                torch.cuda.synchronize()
                walls.append(time.monotonic() - t0)
                launches.append(K.launch_counts())
                losses.append(m["loss"].item())
                grads = {n: p.grad for n, p in model.named_parameters()}
                if remat == "full":
                    full_grads.append({n: g.cpu() for n, g in grads.items()})
                    continue
                diff = [n for n, g in grads.items()
                        if not torch.equal(g.cpu(), full_grads[i][n])]
                if diff:
                    raise AssertionError(f"[train-dots] step {i}: gradients "
                                         f"differ from remat='full': {diff}")
            runs[remat] = {
                "losses": losses, "step_s": walls,
                "step_median_s": statistics.median(walls[1:]),
                "peak_device_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "launches_per_step": [{k: v for k, v in c.items() if v}
                                      for c in launches]}
            del model, opt, grads
    finally:
        torch.use_deterministic_algorithms(was)
        full_grads.clear()
        free_card()
    full, dots = runs["full"], runs["dots"]
    if full["losses"] != dots["losses"]:
        raise AssertionError(f"[train-dots] losses {full['losses']} vs "
                             f"{dots['losses']}")
    layers = base.num_layers
    for i, (f, d) in enumerate(zip(full["launches_per_step"],
                                   dots["launches_per_step"])):
        saved = {k: f.get(k, 0) - d.get(k, 0)
                 for k in ("ftimm_gemm", "ftimm_gemm_swiglu")}
        if saved != {"ftimm_gemm": 5 * layers, "ftimm_gemm_swiglu": layers}:
            raise AssertionError(f"[train-dots] step {i}: launches full {f}"
                                 f", dots {d}")
    for remat, r in runs.items():
        log(f"  remat={remat!r}: losses {r['losses']}; step s "
            f"{[round(x, 3) for x in r['step_s']]} (median "
            f"{r['step_median_s']:.3f}); peak device memory "
            f"{r['peak_device_gb']:.2f} GB; launches a step "
            f"{r['launches_per_step'][-1]}")
    log(f"  losses and every gradient of {DOTS_STEPS} steps bitwise equal; "
        f"'dots' launches {5 * layers} ftimm_gemm and {layers} "
        "ftimm_gemm_swiglu fewer a step")
    return {"layers": layers, "steps": DOTS_STEPS, **runs}


# ---------------------------------------------------------------------------
# [contracts]: the static contracts against the card, REPRO_VERIFY=1 on it,
# NaN past every remainder, and the quarantine of corrupt records
# ---------------------------------------------------------------------------

VERIFY_LAYERS = {ARCH: 4, MIXTRAL: 1, LLAMA4: 1}   # served under REPRO_VERIFY
POISON_K = 200      # no tile's K step (16, 32, 64) nor a slice divides it


def smem_optin(dev) -> int:
    """The device's opt-in shared memory per block, as PyTorch reports it
    (or the CUDA runtime: cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    props = torch.cuda.get_device_properties(dev)
    value = getattr(props, "shared_memory_per_block_optin", None)
    if value:
        return int(value)
    import ctypes
    rt = ctypes.CDLL("libcudart.so")
    out = ctypes.c_int()
    if rt.cudaDeviceGetAttribute(ctypes.byref(out), 97, dev.index or 0):
        raise RuntimeError("cudaDeviceGetAttribute failed")
    return out.value


def _verify_serve(arch: str, dev) -> None:
    """[serve]'s 6 requests at VERIFY_LAYERS[arch] layers, every request
    finished."""
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=VERIFY_LAYERS[arch])
    model = M.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    done = _chaos_engine(cfg, model, dev).run(_chaos_requests(prompts))
    if any(len(r.out_tokens) != NEW_TOKENS for r in done):
        raise AssertionError(f"{arch}: a request did not finish under "
                             "REPRO_VERIFY")
    del model
    free_card()


def _verify_train(dev) -> float:
    """One llama4-scout train step at 1 layer, 2 x 64 tokens."""
    cfg = dataclasses.replace(get_config(LLAMA4), num_layers=1)
    trainer = Trainer(cfg, ShapeConfig("verify", 64, 2, "train"), OptConfig(),
                      seed=0, log_every=1, device=dev)
    model, opt = trainer.run(1)
    loss = trainer.metrics_log[0]["loss"]
    del model, opt, trainer
    free_card()
    if not math.isfinite(loss):
        raise AssertionError(f"llama4 train step under REPRO_VERIFY: {loss}")
    return loss


def _splitk_call(dev) -> float:
    """qwen's gate / up dW, (1024, 2048)^T (1024, 6144) ``tn``, through a
    stored nsplit-4 record; its normwise error against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(11)
    a = _randn(gen, (TRAIN_TOKENS, 2048), BF16)
    b = _randn(gen, (TRAIN_TOKENS, 6144), BF16, TRAIN_TOKENS ** -0.5)
    a_ok, b_ok = K.gemm_operands_ok(a, b, "tn")
    plan_store.get_store().put(
        tuner.dense_key(2048, TRAIN_TOKENS, 6144, 2, 2, b_bytes=2, a_ok=a_ok,
                        b_ok=b_ok, trans="tn"), SPLITK_RECORD)
    tuner.clear_planner_caches()
    got = matmul(a, b, trans="tn")
    rel, _ = rel_err(got, K.ftimm_gemm_plain(a, b, trans="tn"))
    plan_store.reset_store()
    tuner.clear_planner_caches()
    if rel > TOL[BF16]:
        raise AssertionError(f"split-K under REPRO_VERIFY: {rel:.3g}")
    return rel


def verify_on_card(dev) -> dict:
    """(b): REPRO_VERIFY=1 over runs that together launch all eight kernels;
    every planned call's contracts asserted before its launch, counted by
    kernel."""
    os.environ["REPRO_VERIFY"] = "1"
    tuner.clear_plan_cache()
    K.reset_launch_counts()
    try:
        for arch in (ARCH, MIXTRAL, LLAMA4):
            _verify_serve(arch, dev)
        loss = _verify_train(dev)
        splitk_rel = _splitk_call(dev)
    finally:
        del os.environ["REPRO_VERIFY"]
    checked, launches = D.verify_stats(), K.launch_counts()
    missing = [k for k in K.KERNELS if not checked.get(k) or not launches[k]]
    if missing:
        raise AssertionError(f"REPRO_VERIFY: {missing} not checked or not "
                             f"launched: plans {checked}, launches {launches}")
    log(f"  REPRO_VERIFY=1: qwen3-1.7b at {VERIFY_LAYERS[ARCH]} layers, "
        f"mixtral-8x7b and llama4-scout at 1 layer served ({len(PROMPT_LENS)}"
        f" requests each), one llama4 train step at 1 layer (loss "
        f"{loss:.4f}), qwen's dW through a stored nsplit-4 record "
        f"({splitk_rel:.2e} from plain); distinct plans checked by kernel "
        f"{checked}; launches {launches}; no ContractError")
    tuner.clear_plan_cache()
    return {"plans_checked": checked, "launches": launches,
            "llama4_train_loss": loss, "splitk_rel": splitk_rel}


def _poisoned(gen, shape, dtype, scale=1.0, nan_rows=()) -> torch.Tensor:
    """A (..., rows, cols) view into a larger buffer of NaN: every element
    past its rows, its columns and its groups is NaN, and so are the rows
    ``nan_rows`` of the view; rows stay 16-byte aligned (the tensor cores'
    and streams' operands)."""
    cols = shape[-1] + 8
    cols += -cols % 8
    full = [s + 3 for s in shape[:-1]] + [cols]
    buf = torch.full(full, float("nan"), dtype=dtype, device=gen.device)
    view = buf[tuple(slice(0, s) for s in shape)]
    view.copy_(_randn(gen, shape, dtype, scale))
    for r in nan_rows:
        view[..., r, :] = float("nan")
    return view


def poison_cases(gen) -> list[tuple[str, str, object, object, torch.dtype]]:
    """(kernel, label, run, plain, output type) for each body of each
    kernel at K = POISON_K, every operand a view into NaN (``_poisoned``);
    the ragged kernels' rows no group owns NaN too."""
    k = POISON_K
    s = k ** -0.5

    def pz(shape, dtype, scale=1.0, nan_rows=()):
        return _poisoned(gen, shape, dtype, scale, nan_rows)

    cases = []
    for body, dt, m in (("fma", FP32, 100), ("tc", BF16, 130),
                        ("stream", BF16, 4)):
        tile = {"fma": K.TILES[1], "tc": K.TC_TILES[0],
                "stream": (4, 128, 64)}[body]
        a, b = pz((m, k), dt), pz((k, 300), dt, s)
        bt = pz((300, k), dt, s)
        for trans, bb in (("nn", b), ("nt", bt)):
            for ks in ((1, 2) if body == "stream" else (1,)):
                cases.append((
                    "ftimm_gemm", f"{body} {trans} x{ks}",
                    functools.partial(K.ftimm_gemm, a, bb, bm=tile[0],
                                      bn=tile[1], bk=tile[2], trans=trans,
                                      body=body, kslices=ks),
                    functools.partial(K.ftimm_gemm_plain, a, bb, trans=trans),
                    dt))
        x, wg, wu = pz((m, k), dt), pz((k, 300), dt, s), pz((k, 300), dt, s)
        cases.append(("ftimm_gemm_swiglu", body, functools.partial(
            K.ftimm_gemm_swiglu, x, wg, wu, bm=32, bn=64, bk=32, body=body),
            functools.partial(K.ftimm_gemm_swiglu_plain, x, wg, wu), dt))
        gm = min(m, 16) if body == "stream" else m // 5
        ga, gb = pz((3, gm, k), dt), pz((3, k, 150), dt, s)
        cases.append(("ftimm_gemm_grouped", body, functools.partial(
            K.ftimm_gemm_grouped, ga, gb, bm=32, bn=64, bk=32, body=body),
            functools.partial(K.ftimm_gemm_grouped_plain, ga, gb), dt))
        gu = pz((3, k, 150), dt, s)
        cases.append(("ftimm_gemm_grouped_swiglu", body, functools.partial(
            K.ftimm_gemm_grouped_swiglu, ga, gb, gu, bm=32, bn=64, bk=32,
            body=body), functools.partial(K.ftimm_gemm_grouped_swiglu_plain,
                                          ga, gb, gu), dt))
        sizes = (3, 0, 6, 2) if body == "stream" else (10, 0, 27, 8)
        offs = _offsets(sizes, gen.device)
        t = sum(sizes) + 5              # 5 rows no group owns
        xr = pz((t, k), dt, nan_rows=range(sum(sizes), t))
        wr, ur = pz((4, k, 150), dt, s), pz((4, k, 150), dt, s)
        cases.append(("ftimm_gemm_ragged", body, functools.partial(
            K.ftimm_gemm_ragged, xr, wr, offs, bm=32, bn=64, bk=32,
            body=body), functools.partial(K.ftimm_gemm_ragged_plain, xr, wr,
                                          offs), dt))
        cases.append(("ftimm_gemm_ragged_swiglu", body, functools.partial(
            K.ftimm_gemm_ragged_swiglu, xr, wr, ur, offs, bm=32, bn=64,
            bk=32, body=body), functools.partial(
                K.ftimm_gemm_ragged_swiglu_plain, xr, wr, ur, offs), dt))
        if body == "stream":
            continue
        tile = K.TILES[1] if body == "fma" else K.TC_TILES[0]
        sizes = (40, 0, 61, 39)
        offs = _offsets(sizes, gen.device)
        t = sum(sizes) + 10
        xd = pz((t, 100), dt, nan_rows=range(sum(sizes), t))
        dy = pz((t, 120), dt)
        cases.append(("ftimm_gemm_ragged_dw", body, functools.partial(
            K.ftimm_gemm_ragged_dw, xd, dy, offs, bm=tile[0], bn=tile[1],
            bk=tile[2], body=body), functools.partial(
                K.ftimm_gemm_ragged_dw_plain, xd, dy, offs), dt))
        sa, sb = pz((m, k), dt), pz((k, 150), dt, s)
        cases.append(("ftimm_gemm_splitk", f"{body} nsplit 3",
                      functools.partial(K.ftimm_gemm_splitk, sa, sb,
                                        bm=tile[0], bn=tile[1], bk=tile[2],
                                        nsplit=3, body=body),
                      functools.partial(K.ftimm_gemm_splitk_plain, sa, sb,
                                        bk=tile[2], nsplit=3), dt))
    # The grouped rows body: fp32, 5 rows a group, at its cut and at one
    # of 64-wide K slices ("nt") / 70-row ones ("nn").
    ra = pz((3, 5, k), FP32)
    for trans, rb in (("nt", pz((3, 150, k), FP32, s)),
                      ("nn", pz((3, k, 150), FP32, s))):
        for tile in (K.rows_tile(3, k, 150, trans),
                     (K.ROWS_MAX, 64, 64) if trans == "nt"
                     else (K.ROWS_MAX, 128, 70)):
            cases.append(("ftimm_gemm_grouped", f"rows {trans} {tile}",
                          functools.partial(
                              K.ftimm_gemm_grouped, ra, rb, bm=tile[0],
                              bn=tile[1], bk=tile[2], trans=trans,
                              body="rows"),
                          functools.partial(K.ftimm_gemm_grouped_plain, ra,
                                            rb, trans=trans), FP32))
    return cases


def check_poisoned(dev) -> dict[str, float]:
    """(c): each body of each kernel against its plain version with NaN
    past every remainder; the output must be finite and within TOL."""
    gen = torch.Generator(device=dev).manual_seed(12)
    worst: dict[str, float] = {}
    K.reset_launch_counts()
    for kernel, label, run, plain, dt in poison_cases(gen):
        rel, _ = rel_err(run(), plain())
        if rel > TOL[dt]:
            raise AssertionError(f"{kernel} {label} with NaN past K = "
                                 f"{POISON_K}: {rel:.3g} > {TOL[dt]}")
        worst[f"{kernel} {label}"] = rel
    bodies = K.body_counts()
    unused = [(k, b) for k, v in bodies.items() for b, n in v.items()
              if not n]
    if unused:
        raise AssertionError(f"bodies the poisoned cases missed: {unused}")
    log(f"  NaN past K = {POISON_K} (not a multiple of any tile's step), M, "
        f"N, the groups and the rows no group owns: {len(worst)} cases, "
        "every body of every kernel, all finite; worst normwise "
        + ", ".join(f"{k} {v:.1e}" for k, v in sorted(
            worst.items(), key=lambda kv: -kv[1])[:4]))
    free_card()
    return worst


def quarantine_on_card(dev) -> dict:
    """(d): a store of three corrupt records for qwen's decode signatures,
    loaded on the card: each quarantined with its code, each call then
    served by its analytic plan, within TOL of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(13)
    x, x2 = _randn(gen, (4, 2048), BF16), _randn(gen, (4, 6144), BF16)
    w = _randn(gen, (2048, 6144), BF16, 2048 ** -0.5)
    w2 = _randn(gen, (6144, 2048), BF16, 6144 ** -0.5)
    wu = _randn(gen, (2048, 6144), BF16, 2048 ** -0.5)
    up_ok, down_ok = K.gemm_operands_ok(x, w, "nn"), K.gemm_operands_ok(
        x2, w2, "nn")
    x_k, w_ok = K.swiglu_operands(x, w, wu)
    records = {
        tuner.dense_key(4, 2048, 6144, 2, 2, b_bytes=2, a_ok=up_ok[0],
                        b_ok=up_ok[1]): (
            {"body": "fma", "bm": 100, "bn": 32, "bk": 64},
            "tile_not_compiled"),
        tuner.dense_key(4, 6144, 2048, 2, 2, b_bytes=2, a_ok=down_ok[0],
                        b_ok=down_ok[1]): (
            {"body": "stream", "bm": 4, "bn": 128, "bk": 4096},
            "smem_over_budget"),
        tuner.dense_key(4, 2048, 6144, 2, 2, panels=2, b_bytes=2, a_ok=x_k,
                        b_ok=w_ok): (
            {"body": "fma", "bm": 16, "bn": 32, "bk": 64, "nsplit": 2},
            "splitk_nonlinear_epilogue")}
    path = ROOT / "build" / "corrupt_plans.json"
    path.write_text(json.dumps({
        "schema": plan_store.SCHEMA_VERSION,
        "device_kind": plan_store.device_kind(dev),
        "entries": {key: rec for key, (rec, _) in records.items()}}))
    tuner.clear_plan_cache()
    adopted = autotune.load_plan_cache(str(path))
    quarantined = dict(plan_store.get_store().quarantined)
    wrong = {key: quarantined.get(key) for key, (_, code) in records.items()
             if code not in quarantined.get(key, [])}
    if adopted or wrong:
        raise AssertionError(f"corrupt records: {adopted} adopted, codes "
                             f"{wrong}")
    errs = {"up": rel_err(matmul(x, w), K.ftimm_gemm_plain(x, w))[0],
            "down": rel_err(matmul(x2, w2), K.ftimm_gemm_plain(x2, w2))[0],
            "pair": rel_err(matmul_swiglu(x, w, wu),
                            K.ftimm_gemm_swiglu_plain(x, w, wu))[0]}
    modes = tuner.plan_mode_stats()
    if modes.get("dense") != {"analytic": 3, "quarantined": 3} or max(
            errs.values()) > TOL[BF16]:
        raise AssertionError(f"after the quarantine: plan modes {modes}, "
                             f"errors {errs}")
    log(f"  corrupt store loaded on the card: 0 adopted, quarantined "
        f"{quarantined}; the three calls served by their analytic plans "
        f"({modes['dense']}), normwise from plain "
        + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    tuner.clear_plan_cache()
    return {"quarantined": quarantined, "plan_modes": modes["dense"],
            "rel_err": errs}


def contracts_phase(dev, store_path: str | None) -> dict:
    """[contracts]: (a) the budget of the static contracts and of every
    footprint the sweep admits against the card's opt-in shared memory per
    block; (b) REPRO_VERIFY=1 on the card (``verify_on_card``); (c)
    contract 3, NaN past every remainder (``check_poisoned``); (d) corrupt
    records quarantined on the card (``quarantine_on_card``)."""
    optin = smem_optin(dev)
    t0 = time.monotonic()
    report = run_sweep(cache_path=store_path)
    sweep_s = time.monotonic() - t0
    admitted = max(report["smem_admitted"].values())
    log(f"  opt-in shared memory per block: {optin} B (the device); "
        f"HopperSpec.smem_per_block {H100.smem_per_block} B; the largest "
        f"footprint the sweep admits {admitted} B; sweep of "
        f"{report['candidates_checked']} candidates, "
        f"{report['coverage_contracts']} store contracts, "
        f"{report['ragged_row_proofs']} ragged row proofs and "
        f"{report['plan_cache']['entries']} stored records ({store_path}) "
        f"in {sweep_s:.1f} s, {len(report['violations'])} violations")
    if report["violations"] or max(H100.smem_per_block, admitted) > optin:
        raise AssertionError(f"budget {H100.smem_per_block} / admitted "
                             f"{admitted} vs the device's {optin}; "
                             f"violations {report['violations'][:3]}")
    return {"smem_optin": optin, "smem_per_block": H100.smem_per_block,
            "smem_admitted": report["smem_admitted"], "sweep_s": sweep_s,
            "sweep_candidates": report["candidates_checked"],
            "stored_records": report["plan_cache"]["entries"],
            "verify": verify_on_card(dev), "poisoned": check_poisoned(dev),
            "quarantine": quarantine_on_card(dev)}


# ---------------------------------------------------------------------------
# [roofline]: the perf model's bound for each profiled decode step
# ---------------------------------------------------------------------------

PROFILE_ROWS = 24 + 3 + 5 // 2      # profile_decode: prompt, warm, mid-window


def roofline_phase(profiled: dict[str, dict]) -> dict:
    """For each config a phase profiled (``profile_decode``, 4 slots), at
    the depth it served: ``step_perf``'s bytes and t_memory at that decode
    shape (the cache rows of the profiled window, the patch rows in front
    for llava), the parameter bytes allocated on the card against
    ``param_count()`` x the served width (within 2 %), and the profiled
    device busy over the bound."""
    out = {}
    for name, stats in profiled.items():
        cfg = dataclasses.replace(get_config(name), num_layers=stats["layers"])
        prof = stats["profile"]
        shape = ShapeConfig("profiled decode",
                            seq_len=PROFILE_ROWS + cfg.num_patches,
                            global_batch=prof["slots"], kind="decode")
        perf = step_perf(cfg, shape)
        roof = build_roofline(arch=name, shape=shape.name,
                              analytic_flops=perf.flops,
                              analytic_bytes=perf.bytes_hbm,
                              model_flops=model_flops_estimate(cfg, shape,
                                                               "decode"))
        counted = cfg.param_count() * served_width(cfg)
        allocated = stats["param_bytes"]
        if abs(counted - allocated) > 0.02 * allocated:
            raise AssertionError(f"{name}: param_count x width {counted} B "
                                 f"vs {allocated} B allocated")
        busy = prof["device_busy_ms"]
        out[name] = {"layers": cfg.num_layers, "bytes": perf.bytes_hbm,
                     "weights_bytes": perf.breakdown["weights"][1],
                     "t_memory_ms": roof.t_memory * 1e3,
                     "t_compute_ms": roof.t_compute * 1e3,
                     "param_bytes_counted": counted,
                     "param_bytes_allocated": allocated,
                     "device_busy_ms": busy,
                     "busy_over_bound": busy / (roof.t_bound * 1e3),
                     "roofline_fraction": roof.roofline_fraction}
        log(f"  {name} at {cfg.num_layers} layers, {prof['slots']} x "
            f"{shape.seq_len} rows: step_perf {perf.bytes_hbm / 1e9:.4f} GB "
            f"(weights {perf.breakdown['weights'][1] / 1e9:.4f}) -> "
            f"t_memory {roof.t_memory * 1e3:.3f} ms; parameters "
            f"{allocated / 1e9:.4f} GB allocated, param_count x "
            f"{served_width(cfg)} B = {counted / 1e9:.4f} GB "
            f"({counted / allocated - 1:+.2%}); device busy {busy:.3f} ms "
            f"= {out[name]['busy_over_bound']:.2f} x the bound")
    return out


def roofline_dist(dist_out: dict) -> dict:
    """[dist]'s llama4-scout decode on two ranks priced expert-parallel
    (``step_perf(ep_shards=2)``) at its depth and decode shape: the
    ``moe_a2a`` bytes a step beside each rank's measured staged bytes a
    step.  Printed, not gated: the model prices the two exchange legs'
    wire bytes over NVLink, the ranks stage every collective's operands
    through host memory (the flash-decode merge and the routing too)."""
    cfg = _llama4_path_cfg("bf16")
    rows = DIST_PROMPTS
    shape = ShapeConfig("dist decode", seq_len=DIST_MAX_LEN,
                        global_batch=rows, kind="decode")
    perf = step_perf(cfg, shape, ep_shards=DIST_RANKS)
    a2a = perf.breakdown["moe_a2a"][2]
    staged = [s["staged_bytes_per_step"] for s in dist_out["serve"]
              if s["kind"] == "bf16"]
    log(f"  [dist] llama4-scout {cfg.num_layers} l., {rows} x "
        f"{DIST_MAX_LEN} rows, ep_shards {DIST_RANKS}: moe_a2a "
        f"{a2a:.0f} B a step (both ranks' wire bytes), staged by each rank "
        f"{[round(x) for x in staged]} B a step")
    return {"layers": cfg.num_layers, "rows": rows, "moe_a2a_bytes": a2a,
            "staged_bytes_per_step": staged}


# ---------------------------------------------------------------------------
# [dist]: the mesh executors on process groups
# ---------------------------------------------------------------------------

DIST_RANKS = 2
DIST_TIMEOUT = 900          # seconds the spawned world may take in all
DIST_TRANSPORT = "host (gloo: one GPU, NCCL needs one GPU a rank)"
DIST_PROMPTS, DIST_PROMPT_LEN = 4, 50
DIST_STEPS = 16
DIST_MAX_LEN = 80           # 40 cache rows a rank
SERVE_TOL = 5e-2            # full_width_reference's bf16 bound
EP_ROWS = 64
EP_ROUTINGS = {             # llama4-scout's 16 experts, 64 routed rows
    "skewed": [34] + [2] * 15,
    "one_expert": [0] * 12 + [EP_ROWS] + [0] * 3,   # rank 0's window empty
    "balanced": [4] * 16}
QWEN_DOWN = (4, 6144, 2048)         # k_parallel: decode down + residual
QWEN_PREFILL = (1024, 2048, 6144)   # m_parallel: a prefill's gate / up


def _seeded(shape, seed, dev, scale=1.0, dtype=BF16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _ep_inputs(dev, routing: str):
    """llama4-scout's expert panels (all 16) and one routing's rows."""
    cfg = get_config(LLAMA4)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    offs = _offsets(EP_ROUTINGS[routing], dev)
    x = _seeded((EP_ROWS, d), 1, dev)
    ct = _seeded((EP_ROWS, d), 2, dev)
    panels = (_seeded((e, d, f), 3, dev, d ** -0.5),
              _seeded((e, d, f), 4, dev, d ** -0.5),
              _seeded((e, f, d), 5, dev, f ** -0.5))
    return x, ct, panels, offs


def _local_panels(panels, mesh, axis, grad=False):
    nc, s = mesh.axis_size(axis), mesh.axis_index(axis)
    g_l = panels[0].shape[0] // nc
    return [w[s * g_l:(s + 1) * g_l].detach().clone().requires_grad_(grad)
            for w in panels]


def _one_device_moe(x, panels, offs, ct=None):
    """The one-rank call: the ragged pair and down product on all panels
    (with ``ct``: its backward too)."""
    grad = ct is not None
    xs = x.detach().clone().requires_grad_(grad)
    ws = [w.detach().clone().requires_grad_(grad) for w in panels]
    y = ragged_matmul(ragged_swiglu(xs, ws[0], ws[1], offs), ws[2], offs)
    if not grad:
        return y, None, None
    y.backward(ct)
    return y.detach(), xs.grad, [w.grad for w in ws]


def _launched(before: dict) -> dict:
    now = K.launch_counts()
    return {k: now[k] - before.get(k, 0) for k in now if now[k] - before.get(
        k, 0)}


def _worst(pairs) -> float:
    return max(rel_err(got, want)[0] for got, want in pairs)


def dist_executor_cases(dev, mesh, axis) -> list[dict]:
    """(a): each executor call on this rank beside the one-rank call on the
    card; per case the worst normwise error, this rank's launches by
    kernel, staged bytes and host syncs."""
    from repro_torch.core.gemm import collective as COLL
    from repro_torch.core.gemm import distributed as X
    rank = mesh.axis_index(axis)
    cases = []

    def run(name, fn, tol=None, bitwise=False):
        COLL.reset_counts()
        tuner.DEGRADED_COUNTS.clear()
        before = K.launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        err, extra = fn()
        torch.cuda.synchronize(dev)
        row = {"case": name, "rank": rank, "worst": err,
               "launches": _launched(before), **COLL.counts(),
               "s": time.monotonic() - t0, **extra}
        if bitwise and err != 0.0:
            raise AssertionError(f"[dist] {name}: not bitwise ({err})")
        if tol is not None and err > tol:
            raise AssertionError(f"[dist] {name}: error {err} > {tol}")
        cases.append(row)

    m, k, n = QWEN_DOWN
    a, b = _seeded((m, k), 6, dev), _seeded((k, n), 7, dev, k ** -0.5)
    res = _seeded((m, n), 8, dev)
    want = matmul(a, b, epilogue=Epilogue(residual=True), residual=res)
    for sched in ("gather", "ring"):
        run(f"dist_matmul k_parallel {sched} {m}x{k}x{n} +residual",
            lambda sched=sched: (rel_err(X.dist_matmul(
                a, b, mesh=mesh, axis=axis, strategy="k_parallel",
                schedule=sched, epilogue=Epilogue(residual=True),
                residual=res), want)[0], {}), tol=TOL[BF16])
    m, k, n = QWEN_PREFILL
    a, b = _seeded((m, k), 9, dev), _seeded((k, n), 10, dev, k ** -0.5)
    want = matmul(a, b)
    run(f"dist_matmul m_parallel {m}x{k}x{n}",
        lambda: (rel_err(X.dist_matmul(a, b, mesh=mesh, axis=axis,
                                       strategy="m_parallel"), want)[0], {}),
        tol=TOL[BF16])
    del a, b, res, want

    eye = torch.eye(get_config(LLAMA4).d_model, device=dev, dtype=BF16)
    for routing in EP_ROUTINGS:
        x, ct, panels, offs = _ep_inputs(dev, routing)
        y1, dx1, dw1 = _one_device_moe(x, panels, offs, ct)
        g_l = panels[0].shape[0] // mesh.axis_size(axis)
        for sched in ("gather", "ring"):
            def ep_case(sched=sched):
                local = _local_panels(panels, mesh, axis, grad=True)
                xg = x.detach().clone().requires_grad_(True)
                y = X.ep_ragged_moe(xg, *local, offs, mesh=mesh, axis=axis,
                                    schedule=sched)
                y.backward(ct)
                dws = [w.grad for w in local]
                mine = [wd[rank * g_l:(rank + 1) * g_l] for wd in dw1]
                return _worst([(y, y1), (xg.grad, dx1), *zip(dws, mine)]), {}
            run(f"ep_ragged_moe {routing} {sched} fwd+bwd", ep_case,
                tol=TOL[BF16])
            eyes = eye.expand(g_l, -1, -1).contiguous()

            def roundtrip(sched=sched):
                got = X.ep_ragged_matmul(x, eyes, offs, mesh=mesh, axis=axis,
                                         schedule=sched)
                return (got.float() - x.float()).abs().max().item(), {}
            run(f"identity round trip {routing} {sched}", roundtrip,
                bitwise=True)
            del eyes
        del x, ct, panels, y1, dx1, dw1
        free_card()
    return cases


def dist_ladder_cases(dev, mesh, axis, armed_on: tuple[int, ...]) -> dict:
    """The ladder with ``ep_ring`` armed on the ranks ``armed_on``: every
    rank must take the gather rung (counted on each) and give the gather
    schedule's result bitwise."""
    from repro_torch.core.gemm import distributed as X
    rank = mesh.axis_index(axis)
    x, _, panels, offs = _ep_inputs(dev, "skewed")
    local = _local_panels(panels, mesh, axis)
    want = X.ep_ragged_moe(x, *local, offs, mesh=mesh, axis=axis,
                           schedule="gather")
    tuner.DEGRADED_COUNTS.clear()
    plan = chaos.parse_env("ep_ring@0") if rank in armed_on else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with chaos.chaos(plan):
            got = X.ep_ragged_moe(x, *local, offs, mesh=mesh, axis=axis,
                                  schedule="ring")
    degraded = tuner.degraded_stats()
    tuner.DEGRADED_COUNTS.clear()
    if degraded != {"ep:ring->gather": 1} or not torch.equal(got, want):
        raise AssertionError(f"[dist] ladder armed on {armed_on}: rank "
                             f"{rank} degraded {degraded}, equal "
                             f"{torch.equal(got, want)}")
    return {"armed_on": list(armed_on), "rank": rank, "degraded": degraded,
            "bitwise_gather": True}


# The two served runs of (b): bf16 at MOE_LAYERS layers (the main path),
# and fp32 at REF_LAYERS layers (the gated reference: no near-tie routing).
DIST_RUNS = {"bf16": (MOE_LAYERS, "bfloat16", DIST_STEPS),
             "fp32": (REF_LAYERS, "float32", 4)}
NEAR_TIE = 0.1      # top-1 minus top-2 router logit of a flipped choice


def _llama4_path_cfg(kind: str = "bf16"):
    layers, dtype, _ = DIST_RUNS[kind]
    return dataclasses.replace(get_config(LLAMA4), num_layers=layers,
                               compute_dtype=dtype)


def _dist_prompts(cfg) -> torch.Tensor:
    rng = np.random.default_rng(24)
    return torch.as_tensor(rng.integers(2, cfg.vocab_size, (
        DIST_PROMPTS, DIST_PROMPT_LEN)).astype(np.int64))


@contextlib.contextmanager
def _routing_log(calls: list):
    """Record each router call's expert choices and input rows (kept on
    the device until the run ends)."""
    router = MOE._router

    def recording(x, w, e, k):
        out = router(x, w, e, k)
        calls.append((out[1].detach().clone(), x.detach().clone()))
        return out

    MOE._router = recording
    try:
        yield calls
    finally:
        MOE._router = router


def _drive_llama4(model, cfg, dev, steps: int, tokens=None):
    """``prefill`` then ``steps`` scalar-position ``decode_step`` s, greedy
    (or, with ``tokens`` (B, steps), fed those): -> the logits of every
    call and every router call's choices and inputs on the CPU, the
    tokens, the decode walls and the launches of the path."""
    from repro_torch.core.gemm import collective as COLL
    prompts = _dist_prompts(cfg).to(dev)
    cache = M.make_cache(cfg, DIST_PROMPTS, DIST_MAX_LEN, device=dev)
    calls: list = []
    K.reset_launch_counts()
    COLL.reset_counts()
    with _routing_log(calls):
        logits, cache = M.prefill(model, cfg, {"tokens": prompts}, cache)
        torch.cuda.synchronize(dev)
        before, coll0 = K.launch_counts(), COLL.counts()
        outs, fed, walls = [logits], [], []
        pos = DIST_PROMPT_LEN
        for i in range(steps):
            nxt = (logits.argmax(-1) if tokens is None
                   else tokens[:, i].to(dev))[:, None]
            fed.append(nxt)
            t0 = time.monotonic()
            logits, cache = M.decode_step(model, cfg, nxt, cache, pos)
            torch.cuda.synchronize(dev)
            walls.append(time.monotonic() - t0)
            outs.append(logits)
            pos += 1
    launches = K.launch_counts()
    coll = COLL.counts()
    per_step = {k: (launches[k] - before[k]) / steps
                for k in launches if launches[k] - before[k]}
    return {"logits": [o.float().cpu() for o in outs],
            "routing": [(i.cpu(), x.cpu()) for i, x in calls],
            "tokens": torch.cat(fed, dim=1).cpu(),
            "decode_ms": [w * 1e3 for w in walls],
            "decode_median_ms": statistics.median(walls) * 1e3,
            "launches": launches, "launches_per_step": per_step,
            "staged_bytes_per_step": (coll["staged_bytes"]
                                      - coll0["staged_bytes"]) / steps,
            "host_syncs_per_step": (coll["host_syncs"]
                                    - coll0["host_syncs"]) / steps,
            "prefill_staged_bytes": coll0["staged_bytes"],
            "cache_rows": cache["k"].shape[2]}


def dist_one_rank(kind: str, dev, work: Path) -> dict:
    """The one-rank run of ``kind`` in this process (greedy), its tokens
    saved for the ranks; the logits, routing and router weights kept on
    the CPU, the card freed."""
    cfg = _llama4_path_cfg(kind)
    model = M.init_params(cfg, 0, device=dev)
    with torch.no_grad():
        out = _drive_llama4(model, cfg, dev, DIST_RUNS[kind][2])
    out["routers"] = [blk.moe.router.detach().float().cpu()
                      for blk in model.layers]
    del model
    free_card()
    torch.save({"tokens": out["tokens"]}, work / f"one_{kind}.pt")
    return out


def dist_serve_rank(dev, work: Path, kind: str) -> dict:
    """(b) on this rank: llama4-scout at full width on a (data 1, model 2)
    mesh, experts cut over "model" as they are drawn, the cache's sequence
    cut over "model", fed the one-rank run's greedy tokens; its logits and
    routing saved for the parent."""
    from repro_torch.core import dist as DIST
    from repro_torch.launch import sharding as SHARD
    from repro_torch.launch.mesh import make_mesh
    cfg = _llama4_path_cfg(kind)
    mesh = make_mesh((1, DIST_RANKS), ("data", "model"), backend="gloo",
                     device=dev)
    ax = SHARD.expert_axis(mesh, True, "model", cfg.num_experts)
    if ax != "model":
        raise AssertionError(f"[dist] expert axis {ax!r}, not 'model'")
    ctx = DIST.DistContext(mesh, sp_decode=True, moe_ep_axis=ax)
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    model = M.init_params(cfg, 0, device=dev, dist=ctx)
    torch.cuda.synchronize(dev)
    experts = {w.moe.w_gate.shape[0] for w in model.layers}
    if experts != {cfg.num_experts // DIST_RANKS}:
        raise AssertionError(f"[dist] a rank holds {experts} experts")
    want = torch.load(work / f"one_{kind}.pt")
    with torch.no_grad(), DIST.use_dist(ctx):
        out = _drive_llama4(model, cfg, dev, DIST_RUNS[kind][2],
                            tokens=want["tokens"])
    rank = mesh.axis_index("model")
    torch.save({"logits": out.pop("logits"),
                "routing": [i for i, _ in out.pop("routing")]},
               work / f"rank{rank}_{kind}.pt")
    out.pop("tokens")
    out.update(rank=rank, kind=kind, layers=cfg.num_layers,
               param_gb=param_bytes(model) / 1e9,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               experts=experts.pop())
    del model
    free_card()
    return out


def dist_hold(kind: str, one: dict, rank_out: dict, work: Path) -> dict:
    """Hold one rank's run of ``kind`` against the one-rank run, sequence
    by sequence (nothing mixes the batch rows).  fp32: every expert choice
    equal, the logits within MOE_REF_TOL, the greedy tokens equal.  bf16:
    a row's expert choice may flip only at a near tie -- each row's first
    flipped choices have a one-rank top-1 minus top-2 router logit under
    NEAR_TIE (one bf16 rounding moves such a token to another expert: a
    different routing, not an error) -- and every row's logits before its
    first flip must lie within SERVE_TOL with the same greedy token; after
    it the row is reported, not gated."""
    got = torch.load(work / f"rank{rank_out['rank']}_{kind}.pt")
    layers = rank_out["layers"]
    if len(got["routing"]) != len(one["routing"]):
        raise AssertionError(f"[dist] {kind}: {len(got['routing'])} router "
                             f"calls, one rank {len(one['routing'])}")
    first: dict[int, tuple[int, int]] = {}      # row -> (step, call)
    flips, gaps = 0, []
    for i, (mine, (want, x)) in enumerate(zip(got["routing"],
                                              one["routing"])):
        step = i // layers
        per_row = DIST_PROMPT_LEN if step == 0 else 1
        bad = (mine != want).any(dim=-1).nonzero().flatten().tolist()
        flips += len(bad)
        for t in bad:
            first.setdefault(t // per_row, (step, i))
        fresh = [t for t in bad if first[t // per_row][1] == i]
        if fresh:
            logit = x[fresh].float() @ one["routers"][i % layers]
            top = logit.topk(2, dim=-1).values
            gaps += (top[:, 0] - top[:, 1]).tolist()
    errs, same = [], []
    for j, (g, w) in enumerate(zip(got["logits"], one["logits"])):
        for row in range(g.shape[0]):
            if row in first and j >= first[row][0]:
                continue
            errs.append(rel_err(g[row], w[row])[0])
            same.append(bool(g[row].argmax() == w[row].argmax()))
    everything = [rel_err(g, w)[0] for g, w in zip(got["logits"],
                                                   one["logits"])]
    tol = MOE_REF_TOL if kind == "fp32" else SERVE_TOL
    if ((kind == "fp32" and flips) or any(g >= NEAR_TIE for g in gaps)
            or max(errs, default=0.0) > tol or not all(same)):
        raise AssertionError(
            f"[dist] {kind} rank {rank_out['rank']}: {flips} expert "
            f"choices flipped (rows' first flips {first}, gaps {gaps}), "
            f"gated logits {errs}, greedy equal {same}")
    return {"expert_choices": sum(int(i.numel()) for i in got["routing"]),
            "flipped": flips, "first_flip_gaps": gaps,
            "rows_flipped": {r: s for r, (s, _) in sorted(first.items())},
            "gated": len(errs), "worst_logits_gated": max(errs, default=0.0),
            "greedy_equal_gated": all(same),
            "worst_logits": max(everything)}


def dist_rank(rank: int, device: str, store: str, work: str, out_q) -> None:
    """One rank of the [dist] world: gloo with its tensors on ``device``
    (cuda:0 for both ranks: the host transport), the executor cases, the
    ladder, then the served path."""
    import traceback

    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_mesh
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        tdist.init_process_group("gloo", init_method=f"file://{store}",
                                 rank=rank, world_size=DIST_RANKS)
        mesh = make_mesh((DIST_RANKS,), ("x",), backend="gloo", device=dev)
        res = {"transport": mesh.transport, "backend": mesh.backend}
        t0 = time.monotonic()
        res["executors"] = dist_executor_cases(dev, mesh, "x")
        res["ladder"] = [dist_ladder_cases(dev, mesh, "x", armed)
                         for armed in ((0, 1), (0,))]
        res["executors_s"] = time.monotonic() - t0
        free_card()
        t0 = time.monotonic()
        res["serve"] = {kind: dist_serve_rank(dev, Path(work), kind)
                        for kind in DIST_RUNS}
        res["serve_s"] = time.monotonic() - t0
        out_q.put(("ok", rank, res))
    except BaseException:       # noqa: BLE001 -- reported, and the phase fails
        out_q.put(("error", rank, traceback.format_exc()))
    finally:
        if "tdist" in locals() and tdist.is_initialized():
            tdist.destroy_process_group()


def dist_world(work: Path, dev) -> list[dict]:
    """Spawn the DIST_RANKS ranks, all on ``dev``; wait for each one's
    result (a rank's failure or the world's timeout fails the phase); stop
    them all."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=dist_rank,
                         args=(r, str(dev), str(work / "store"), str(work),
                               out_q))
             for r in range(DIST_RANKS)]
    for p in procs:
        p.start()
    results = [None] * DIST_RANKS
    deadline = time.monotonic() + DIST_TIMEOUT
    try:
        for _ in range(DIST_RANKS):
            left = deadline - time.monotonic()
            try:
                status, rank, value = out_q.get(timeout=max(left, 1))
            except queue.Empty:
                raise AssertionError(f"[dist] the {DIST_RANKS}-rank world "
                                     f"did not finish in {DIST_TIMEOUT} s"
                                     ) from None
            if status != "ok":
                raise AssertionError(f"[dist] rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results


def nccl_world_of_one(dev, work: Path) -> dict:
    """(c): a one-rank NCCL world on the card (the device transport) runs
    (a)'s ``ep_ragged_moe`` (a one-rank axis takes the gather schedule and
    the dense realization: the probe needs two ranks, as the reference's)
    and ``dist_matmul`` (three modes) calls; each must be bitwise the
    one-device composition of the same products (the collectives of one
    rank move nothing, and the executors take no shortcut)."""
    import torch.distributed as tdist
    from repro_torch.core.gemm import collective as COLL
    from repro_torch.core.gemm import distributed as X
    from repro_torch.launch.mesh import make_mesh
    backend = "nccl" if dev.type == "cuda" else "gloo"
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    tdist.init_process_group(backend, init_method=f"file://{work}/one",
                             rank=0, world_size=1)
    out = {}
    try:
        mesh = make_mesh((1,), ("x",), device=dev)
        if mesh.backend != backend or (backend == "nccl") != (
                mesh.transport == "device"):
            raise AssertionError(f"[dist] one-rank mesh {mesh.backend} / "
                                 f"{mesh.transport}")
        COLL.reset_counts()
        before = K.launch_counts()
        x, _, panels, offs = _ep_inputs(dev, "skewed")
        want, _, _ = _one_device_moe(x, panels, offs)
        for sched in ("gather", "ring"):      # a one-rank axis runs gather
            got = X.ep_ragged_moe(x, *panels, offs, mesh=mesh, axis="x",
                                  schedule=sched)
            out[f"ep_ragged_moe {sched}"] = torch.equal(got, want)
        out["exchange"] = COLL.exchange_method(mesh, "x")
        del x, panels, want
        m, k, n = QWEN_DOWN
        a, b = _seeded((m, k), 6, dev), _seeded((k, n), 7, dev, k ** -0.5)
        res = _seeded((m, n), 8, dev)
        epi = Epilogue(residual=True)
        want = epi.apply(matmul(a, b, out_dtype=FP32),
                         residual=res).to(BF16)
        for sched in ("gather", "ring"):
            got = X.dist_matmul(a, b, mesh=mesh, axis="x",
                                strategy="k_parallel", schedule=sched,
                                epilogue=epi, residual=res)
            out[f"dist_matmul k_parallel {sched}"] = torch.equal(got, want)
        got = X.dist_matmul(a, b, mesh=mesh, axis="x", strategy="m_parallel",
                            epilogue=epi, residual=res)
        out["dist_matmul m_parallel"] = torch.equal(
            got, matmul(a, b, epilogue=epi, residual=res))
        torch.cuda.synchronize(dev)
        launched = _launched(before)
    finally:
        tdist.destroy_process_group()
    bad = [name for name, ok in out.items() if ok is False]
    if bad:
        raise AssertionError(f"[dist] one-rank NCCL not bitwise: {bad}")
    return {"bitwise": out, "launches": launched}


def dist_phase(dev) -> tuple[dict, dict]:
    """[dist]: the one-rank llama4 runs (in this process, their results
    moved to the CPU and the card freed), the 2-rank gloo world on cuda:0
    ((a) the executors, the ladder; (b) llama4 served across the two
    ranks, bf16 and the fp32 reference), then (c) the one-rank NCCL world.
    -> (the phase's figures, each rank's launches of the bf16 path)."""
    import tempfile
    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="dist_") as tmp:
        work = Path(tmp)
        t0 = time.monotonic()
        one = {kind: dist_one_rank(kind, dev, work) for kind in DIST_RUNS}
        one_s = time.monotonic() - t0
        log(f"  one rank, bf16: decode median "
            f"{one['bf16']['decode_median_ms']:.2f} ms, launches a step "
            f"{one['bf16']['launches_per_step']}")
        t0 = time.monotonic()
        ranks = dist_world(work, dev)
        world_s = time.monotonic() - t0
        serve = []
        for r in ranks:
            for kind, s in r["serve"].items():
                held = dist_hold(kind, one[kind], s, work)
                if kind == "bf16":
                    for name in ("ftimm_gemm_grouped", "ftimm_gemm",
                                 "ftimm_gemm_ragged_swiglu",
                                 "ftimm_gemm_ragged"):
                        if not s["launches_per_step"].get(name):
                            raise AssertionError(
                                f"[dist] rank {s['rank']}: no {name} in a "
                                "decode step")
                serve.append({**s, **held})
        for r in ranks:
            for c in r["executors"]:
                need = ["ftimm_gemm_ragged_swiglu", "ftimm_gemm_ragged"]
                if "fwd+bwd" in c["case"]:
                    need.append("ftimm_gemm_ragged_dw")
                if c["case"].startswith("ep_ragged_moe") and not all(
                        c["launches"].get(k) for k in need):
                    raise AssertionError(f"[dist] {c['case']} rank "
                                         f"{c['rank']}: launches "
                                         f"{c['launches']}")
        t0 = time.monotonic()
        nccl = nccl_world_of_one(dev, work)
        nccl_s = time.monotonic() - t0
    for r in ranks:
        for c in r["executors"]:
            log(f"  rank {c['rank']} {c['case']:48s} worst {c['worst']:.2e} "
                f"staged {c['staged_bytes']} B syncs {c['host_syncs']} "
                f"launches {c['launches']}")
    for s in serve:
        log(f"  rank {s['rank']} {s['kind']} ({s['layers']} l.): "
            f"{s['experts']} experts, {s['cache_rows']} cache rows, params "
            f"{s['param_gb']:.2f} GB, peak {s['peak_gb']:.2f} GB; decode "
            f"median {s['decode_median_ms']:.2f} ms (one rank "
            f"{one[s['kind']]['decode_median_ms']:.2f} ms); a step: "
            f"{s['launches_per_step']}, staged "
            f"{s['staged_bytes_per_step']:.0f} B, host syncs "
            f"{s['host_syncs_per_step']:.1f}; {s['flipped']} of "
            f"{s['expert_choices']} expert choices flipped (rows' first "
            f"flip steps {s['rows_flipped']}, gaps {s['first_flip_gaps']});"
            f" logits {s['worst_logits_gated']:.2e} over {s['gated']} gated "
            f"(row, call) pairs, {s['worst_logits']:.2e} in all")
    launches = {(f"dist rank {s['rank']}", LLAMA4): s.pop("launches")
                for s in serve if s["kind"] == "bf16"}
    for s in serve:
        s.pop("launches", None)
    out = {"transport": DIST_TRANSPORT,
           "one_rank": {kind: {k: o[k] for k in (
               "decode_median_ms", "decode_ms", "launches_per_step",
               "cache_rows")} for kind, o in one.items()},
           "ranks": [{k: v for k, v in r.items() if k != "serve"}
                     for r in ranks],
           "serve": serve, "nccl_world_of_one": nccl,
           "seconds": {"one_rank": one_s, "world": world_s, "nccl": nccl_s,
                       "phase": time.monotonic() - t_phase}}
    log(json.dumps({"dist": out}))
    return out, launches


# ---------------------------------------------------------------------------
# [mesh-train]: training on a mesh, two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

MT_RANKS = 2
MT_TIMEOUT = 900            # seconds the spawned world may take in all
MT_STEPS = 2                # a case's steps (3 would near the time limit)
MT_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
MT_SERVE = (4, 40, 8)       # (d): prompts, prompt tokens, decode steps
MT_SERVE_KINDS = ("float32", "bfloat16")    # (d)'s compute dtypes
MT_COMPRESS = 1 << 22       # (e): fp32 elements of a rank's gradient
MT_ELASTIC = (12, 32, 8, "shard_loss@6:chips=1")   # steps, seq, batch, fault
# qwen3-1.7b's depth in (a) / (b) and under ZeRO-1 (h): a ZeRO step stages
# every parameter's fp32 gradient through gloo (23 GB at 28 layers, ~1 GB/s
# on one card), and the whole script has a time limit.
MT_QWEN_LAYERS = 2
MT_ZERO1_LAYERS = 2
# case -> (arch, (data, model), layers (None: all), compute dtype,
# Trainer options); "a32" / "b32" / "h32": (a) / (b) / (h) at 2 layers in
# fp32, "g32": (g) in fp32, "f32": (f_ep) in fp32 (experts over data: the
# fp32 experts' ZeRO gather would stage ~30 GB a step); "zero1": the
# parameters at ``named_specs(zero_stage=1)``, the moments at ZeRO-3.
MT_CASES = {
    "a": (ARCH, (2, 1), MT_QWEN_LAYERS, "bfloat16", {}),
    "a32": (ARCH, (2, 1), 2, "float32", {}),
    "b": (ARCH, (1, 2), MT_QWEN_LAYERS, "bfloat16", {}),
    "b32": (ARCH, (1, 2), 2, "float32", {}),
    "c": (LLAMA4, (2, 1), 1, "bfloat16", {"moe_ep": True}),
    "d": (MAMBA, (1, 2), None, "bfloat16", {"ssm_head_shard": True}),
    "f": (MIXTRAL, (2, 1), 1, "bfloat16", {}),
    "f_ep": (MIXTRAL, (2, 1), 1, "bfloat16", {"moe_ep": True}),
    "f32": (MIXTRAL, (2, 1), 1, "float32", {"moe_ep": True}),
    "g": (WHISPER, (1, 2), None, "bfloat16", {}),
    "g32": (WHISPER, (1, 2), None, "float32", {}),
    "h": (ARCH, (2, 1), MT_ZERO1_LAYERS, "bfloat16", {"zero1": True}),
    "h32": (ARCH, (2, 1), 2, "float32", {"zero1": True})}
MT_ONE_RANK = {"a": "a", "a32": "a32", "b": "a", "b32": "a32", "c": "c",
               "d": "d", "f": "f", "f_ep": "f", "f32": "f32", "g": "g",
               "g32": "g32",
               "h": "h", "h32": "a32"}
MT_NEW = ("f", "f_ep", "f32", "g", "g32", "h", "h32")   # gradient norms held too
MT_CAPACITY = ("f", "f_ep", "f32")      # kept copies held against one rank's
MT_KERNELS = {"a": ("ftimm_gemm", "ftimm_gemm_swiglu", "ftimm_gemm_grouped"),
              "b": ("ftimm_gemm", "ftimm_gemm_swiglu", "ftimm_gemm_grouped"),
              "c": ("ftimm_gemm", "ftimm_gemm_grouped",
                    "ftimm_gemm_ragged_swiglu", "ftimm_gemm_ragged",
                    "ftimm_gemm_ragged_dw"),
              "d": ("ftimm_gemm",),
              "f": ("ftimm_gemm", "ftimm_gemm_grouped_swiglu",
                    "ftimm_gemm_grouped"),
              "f_ep": ("ftimm_gemm", "ftimm_gemm_grouped_swiglu",
                       "ftimm_gemm_grouped"),
              "g": ("ftimm_gemm", "ftimm_gemm_swiglu", "ftimm_gemm_grouped"),
              "h": ("ftimm_gemm", "ftimm_gemm_swiglu", "ftimm_gemm_grouped")}
# (b): the weight panels (K, N) a rank's forward GEMMs read -- qwen3-1.7b's
# halves -- and the whole ones none may read.
MT_TP_HALVES = {"ftimm_gemm": [(2048, 1024), (2048, 512), (1024, 2048),
                               (3072, 2048)],
                "ftimm_gemm_swiglu": [(2048, 3072)]}
MT_TP_WHOLE = {"ftimm_gemm": [(2048, 2048), (6144, 2048)],
               "ftimm_gemm_swiglu": [(2048, 6144)]}


def mt_cfg(case: str):
    arch, _, layers, cdt, _ = MT_CASES[case]
    cfg = dataclasses.replace(get_config(arch), compute_dtype=cdt)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def mt_opt() -> OptConfig:
    return OptConfig(warmup_steps=TRAIN_WARMUP, total_steps=10 * TRAIN_WARMUP)


def mt_shape() -> ShapeConfig:
    return ShapeConfig("chip", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                       kind="train")


def mt_walls(log_: list[dict]) -> list[float]:
    return [log_[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                  for a, b in zip(log_, log_[1:])]


def mt_serve(cfg, model, dev, tokens=None) -> dict:
    """(d)'s request list: MT_SERVE's prompts prefilled into the dense-slot
    cache (head-cut under ``ssm_head_shard``), then its decode steps, each
    fed the greedy token or ``tokens``'s."""
    n, length, steps = MT_SERVE
    g = torch.Generator().manual_seed(11)
    prompts = torch.randint(1, cfg.vocab_size, (n, length), generator=g)
    cache = M.make_cache(cfg, n, length + steps, device=dev)
    with torch.no_grad():
        logits, cache = M.prefill(model, cfg, {"tokens": prompts.to(dev)},
                                  cache)
        outs, toks = [logits.float().cpu()], []
        for i in range(steps):
            nxt = logits.argmax(-1) if tokens is None else tokens[i].to(dev)
            toks.append(nxt.cpu())
            logits, cache = M.decode_step(model, cfg, nxt[:, None], cache,
                                          length + i)
            outs.append(logits.float().cpu())
    return {"logits": outs, "tokens": toks,
            "cache": {k: list(v.shape) for k, v in cache.items()}}


class KeepCounter:
    """While entered, ``moe.capacity_slots`` counts each call's kept and
    routed (token, k) copies (device tensors, read at the end: no host
    sync in the step)."""

    def __init__(self):
        self._calls: list = []

    def __enter__(self):
        self._saved = MOE.capacity_slots

        def counted(gate_idx, num_experts, cap):
            slot, keep = self._saved(gate_idx, num_experts, cap)
            self._calls.append((keep.sum(), keep.numel()))
            return slot, keep

        MOE.capacity_slots = counted
        return self

    def __exit__(self, *exc):
        MOE.capacity_slots = self._saved

    def counts(self) -> list[tuple[int, int]]:
        """(kept, routed) of each call, in call order."""
        return [(int(k), n) for k, n in self._calls]


def mt_one_rank(case: str, dev, work: Path) -> dict:
    """The one-rank ``Trainer`` run of ``case`` in this process (and (d)'s
    request list, its greedy tokens saved for the ranks)."""
    cfg = mt_cfg(case)
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, mt_shape(), mt_opt(), seed=0, log_every=1, device=dev)
    with KeepCounter() as kept:
        model, opt = tr.run(MT_STEPS)
    torch.cuda.synchronize(dev)
    walls = mt_walls(tr.metrics_log)
    out = {"losses": [m["loss"] for m in tr.metrics_log],
           "grad_norms": [m["grad_norm"] for m in tr.metrics_log],
           "step_s": walls, "step_median_s": statistics.median(walls[1:]),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "kept": kept.counts()}
    del model, opt, tr
    free_card()
    if case == "d":
        out["serve"] = {}
        for kind in MT_SERVE_KINDS:
            scfg = dataclasses.replace(cfg, compute_dtype=kind)
            model = M.init_params(scfg, 1, device=dev)
            served = out["serve"][kind] = mt_serve(scfg, model, dev)
            del model
            free_card()
            torch.save({"tokens": served["tokens"]},
                       work / f"mt_one_d_{kind}.pt")
    return out


def mt_recorded_panels(recorder: CallRecorder) -> dict[str, list]:
    """The weight panels (K, N) of the recorded forward ("nn") GEMMs and
    SwiGLU pairs with bf16 operands."""
    out: dict[str, set] = {"ftimm_gemm": set(), "ftimm_gemm_swiglu": set()}
    for call in recorder.calls.values():
        name = call["kernel"]
        if name not in out or call["kwargs"].get("trans", "nn") != "nn":
            continue
        b = call["args"][1]
        if b[3] == BF16:
            out[name].add(tuple(b[1]))
    return {k: sorted(v) for k, v in out.items()}


def mt_train_case(case: str, dev) -> dict:
    """One case of [mesh-train] on this rank: ``Trainer(mesh=...)`` for
    MT_STEPS steps.  -> its losses, step walls, staged bytes, parameters,
    peak memory, launches and recorded panels."""
    from repro_torch.core.gemm import collective as COLL
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    arch, dims, _, cdt, kw = MT_CASES[case]
    kw = dict(kw)
    cfg = mt_cfg(case)
    mesh = make_mesh(dims, ("data", "model"), backend="gloo", device=dev)
    free_card()
    if kw.pop("zero1", False):
        # The specs from the whole model's shapes, drawn and dropped.
        named = dict(M.init_params(cfg, 0, device=dev, dtype=cfg.param_dtype)
                     .named_parameters())
        kw["shardings"] = {"params": sharding.named_specs(named, mesh,
                                                          zero_stage=1),
                           "opt": sharding.named_specs(named, mesh)}
        del named
        free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, mt_shape(), mt_opt(), mesh=mesh, seed=0, log_every=1,
                 **kw)
    COLL.reset_counts()
    K.reset_launch_counts()
    with CallRecorder() as rec, PlainCounter() as plain, \
            KeepCounter() as kept:
        model, opt = tr.run(MT_STEPS)
    torch.cuda.synchronize(dev)
    staged = COLL.counts()["staged_bytes"]
    launches = K.launch_counts()
    params = sum(p.numel() for p in model.parameters())
    moments = sum(t.numel() for t in opt["m"].values())
    log_ = tr.metrics_log
    walls = mt_walls(log_)
    del model, opt, tr
    free_card()
    return {"case": case, "arch": arch, "mesh": list(dims), "dtype": cdt,
            "layers": cfg.num_layers, "rank": mesh.axis_index(("data",
                                                                "model")),
            "plain_calls": plain.calls,
            "losses": [m["loss"] for m in log_],
            "grad_norms": [m["grad_norm"] for m in log_],
            "step_s": walls, "step_median_s": statistics.median(walls[1:]),
            "staged_bytes_per_step": staged / MT_STEPS,
            "params_rank": params, "moments_rank": moments,
            "kept": kept.counts(),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": dict(launches),
            "launches_per_step": {k: v / MT_STEPS
                                  for k, v in launches.items() if v},
            "panels": mt_recorded_panels(rec)}


def mt_serve_case(dev, work: Path) -> dict:
    """(d)'s request list on this rank, in fp32 and in bf16 compute:
    mamba2-370m's serving weights whole (the seed of the one-rank run),
    the SSM cache cut to this rank's heads under ``ssm_head_shard``, fed
    the one-rank run's greedy tokens."""
    from repro_torch.core import dist as DIST
    from repro_torch.core.gemm import collective as COLL
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, MT_RANKS), ("data", "model"), backend="gloo",
                     device=dev)
    ctx = DIST.DistContext(mesh, ssm_head_shard=True)
    outs = {}
    for kind in MT_SERVE_KINDS:
        cfg = dataclasses.replace(mt_cfg("d"), compute_dtype=kind)
        free_card()
        model = M.init_params(cfg, 1, device=dev)
        want = torch.load(work / f"mt_one_d_{kind}.pt")
        COLL.reset_counts()
        K.reset_launch_counts()
        t0 = time.monotonic()
        with DIST.use_dist(ctx), PlainCounter() as plain:
            out = mt_serve(cfg, model, dev, tokens=want["tokens"])
        torch.cuda.synchronize(dev)
        out.update(wall_s=time.monotonic() - t0, plain_calls=plain.calls,
                   staged_bytes=COLL.counts()["staged_bytes"],
                   launches={k: v for k, v in K.launch_counts().items()
                             if v})
        outs[kind] = out
        del model
    free_card()
    return outs


def mt_compress_case(dev) -> dict:
    """(e): ``compress_allreduce`` of MT_COMPRESS fp32 elements a rank on
    CUDA tensors over gloo: the staged bytes and the mean's error."""
    from repro_torch.core.gemm import collective as COLL
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import compress_allreduce
    mesh = make_mesh((MT_RANKS,), ("dp",), backend="gloo", device=dev)
    g = _seeded((MT_COMPRESS,), 30 + mesh.axis_index("dp"), dev, 0.01, FP32)
    err = torch.zeros_like(g)
    COLL.reset_counts()
    mean, new_err = compress_allreduce(g, err, mesh, "dp")
    torch.cuda.synchronize(dev)
    staged = COLL.counts()["staged_bytes"]
    true = COLL.raw_all_reduce(g, mesh, "dp") / MT_RANKS
    rel = float((mean - true).abs().max() / true.abs().max())
    return {"elements": MT_COMPRESS, "staged_bytes": staged,
            "expected_staged_bytes": 2 * (MT_COMPRESS + 4),
            "mean_rel_err": rel,
            "err_finite": bool(torch.isfinite(new_err).all())}


def mt_elastic_case(dev, work: Path) -> dict:
    """(f): ``ElasticRunner`` on the two ranks, clean and with MT_ELASTIC's
    fault; the host logic at qwen3-1.7b-smoke in fp32."""
    from repro_torch.runtime.elastic import ElasticRunner
    steps, seq, batch, fault = MT_ELASTIC
    cfg = dataclasses.replace(get_config(ARCH + "-smoke"),
                              compute_dtype="float32")
    out = {}
    for name, spec in (("clean", None), ("faulted", fault)):
        runner = ElasticRunner(cfg, ShapeConfig("elastic", seq, batch,
                                                "train"),
                               OptConfig(lr=1e-3, warmup_steps=2,
                                         total_steps=steps),
                               ckpt_dir=str(work / f"elastic_{name}"),
                               model_parallel=1, seed=0, ckpt_every=4,
                               log_every=1, backend="gloo", device=dev)
        plan = chaos.parse_env(spec) if spec else chaos.FaultPlan()
        with chaos.chaos(plan):
            left = runner.run(steps) is None
        out[name] = {"history": runner.history, "left": left,
                     "losses": {m["step"]: m["loss"]
                                for m in runner.metrics_log}}
    return out


def mt_rank(rank: int, device: str, store: str, work: str, out_q) -> None:
    """One rank of the [mesh-train] world: every case in turn."""
    import traceback

    import torch.distributed as tdist
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        tdist.init_process_group("gloo", init_method=f"file://{store}",
                                 rank=rank, world_size=MT_RANKS)
        res, secs = {}, {}
        for case in MT_CASES:
            t0 = time.monotonic()
            res[case] = mt_train_case(case, dev)
            secs[case] = time.monotonic() - t0
        t0 = time.monotonic()
        res["d_serve"] = mt_serve_case(dev, Path(work))
        res["e"] = mt_compress_case(dev)
        secs["d_serve+e"] = time.monotonic() - t0
        t0 = time.monotonic()
        res["elastic"] = mt_elastic_case(dev, Path(work))
        secs["elastic"] = time.monotonic() - t0
        res["seconds"] = secs
        out_q.put(("ok", rank, res))
    except BaseException:       # noqa: BLE001 -- reported, and the phase fails
        out_q.put(("error", rank, traceback.format_exc()))
    finally:
        if "tdist" in locals() and tdist.is_initialized():
            tdist.destroy_process_group()


def mt_hold(case: str, one: dict, got: dict) -> dict:
    """One rank's run of ``case`` against the one-rank run."""
    want = one[MT_ONE_RANK[case]]
    tol = MT_TOL[MT_CASES[case][3]]
    errs = [abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                 want["losses"])]
    if (len(errs) != MT_STEPS or max(errs) > tol
            or not all(map(math.isfinite, got["losses"]))):
        raise AssertionError(f"[mesh-train] ({case}) rank {got['rank']}: "
                             f"losses {got['losses']} against one rank's "
                             f"{want['losses']} (tolerance {tol})")
    gn_errs = [abs(g - w) / abs(w) for g, w in zip(got["grad_norms"],
                                                    want["grad_norms"])]
    # Gradient norms: every step in fp32; in bf16 the first step's (the
    # weights still equal), as later ones carry the steps' bf16 rounding
    # through the routing (a capacity drop or a near-tie expert choice
    # moves the norm), reported.
    gated = gn_errs if MT_CASES[case][3] == "float32" else gn_errs[:1]
    if case in MT_NEW and (len(gn_errs) != MT_STEPS or max(gated) > tol):
        raise AssertionError(f"[mesh-train] ({case}) rank {got['rank']}: "
                             f"gradient norms {got['grad_norms']} against "
                             f"one rank's {want['grad_norms']}")
    if got["plain_calls"]:
        raise AssertionError(f"[mesh-train] ({case}): {got['plain_calls']} "
                             "plain versions ran on CUDA tensors")
    if (MT_CASES[case][4].get("zero1")
            and not got["moments_rank"] < 0.55 * got["params_rank"]):
        raise AssertionError(f"[mesh-train] ({case}) rank {got['rank']}: "
                             f"{got['moments_rank']} moment elements for "
                             f"{got['params_rank']} parameter elements")
    need = MT_KERNELS.get(case, ())
    if MT_CASES[case][3] == "bfloat16" and not all(
            got["launches"].get(k) for k in need):
        raise AssertionError(f"[mesh-train] ({case}) rank {got['rank']}: "
                             f"launches {got['launches']}, need {need}")
    if case == "b":
        for name, halves in MT_TP_HALVES.items():
            seen = set(map(tuple, got["panels"][name]))
            missing = [h for h in halves if h not in seen]
            whole = [w for w in MT_TP_WHOLE[name] if w in seen]
            if missing or whole:
                raise AssertionError(
                    f"[mesh-train] (b) rank {got['rank']}: {name} panels "
                    f"{sorted(seen)}; missing halves {missing}, whole "
                    f"{whole}")
    return {"loss_rel_errs": errs, "grad_norm_rel_errs": gn_errs, "tol": tol}


def mt_hold_kept(case: str, one: dict, ranks: list[dict]) -> dict:
    """(f): the copies the capacity kept in each ``capacity_slots`` call
    (every rank on its rows) summed over the ranks against the one-rank
    run's, and the routed copies likewise.  Gated: the first forward's
    call in bf16 (the later ones see weights a bf16 step apart, reported),
    every call in fp32."""
    want = one[MT_ONE_RANK[case]]["kept"]
    calls = [r[case]["kept"] for r in ranks]
    summed = [tuple(map(sum, zip(*c))) for c in zip(*calls)]
    gated = len(want) if MT_CASES[case][3] == "float32" else 1
    if (not summed or summed[:gated] != want[:gated]
            or len(summed) != len(want)):
        raise AssertionError(f"[mesh-train] ({case}): kept / routed copies "
                             f"{summed[:gated]} over the ranks, one rank "
                             f"{want[:gated]} ({len(summed)} / {len(want)} "
                             "calls)")
    return {"first_forward": {"kept": want[0][0], "routed": want[0][1],
                              "dropped": want[0][1] - want[0][0]},
            "calls_equal": sum(a == b for a, b in zip(summed, want)),
            "calls": len(want), "gated_calls": gated}


def mt_hold_serve(one: dict, got: dict) -> dict:
    """(d)'s request list on one rank against the one-rank run, over the
    real vocabulary (the padded slots hold -1e30), by compute dtype: the
    logits' normwise error of every call and the greedy flips, each with
    the two tokens' one-rank logit gap and the row's largest logit
    difference.  Gated in fp32: every call within REC_REF_TOL, a flip
    only where the gap is at most twice the row's difference (a tie
    within the rounding).  bf16 is reported: 48 bf16 layers of random
    weights carry another summation order (the head-cut panels take other
    kernel bodies and the row sums round once) far from the start."""
    vocab = mt_cfg("d").vocab_size
    ref = one["d"]["serve"]
    # bf16's own distance from fp32 on one rank, the same weights, the
    # prefill logits: the scale the bf16 mesh difference is read against.
    out = {"one_rank_bf16_vs_fp32_prefill": rel_err(
        ref["bfloat16"]["logits"][0][:, :vocab],
        ref["float32"]["logits"][0][:, :vocab])[0]}
    for kind, mine in got.items():
        want = one["d"]["serve"][kind]
        errs, gaps = [], []
        for g, w in zip(mine["logits"], want["logits"]):
            g, w = g[:, :vocab], w[:, :vocab]
            errs.append(rel_err(g, w)[0])
            for r in (g.argmax(-1) != w.argmax(-1)).nonzero().flatten():
                gaps.append((float(w[r].max() - w[r, g[r].argmax()]),
                             float((g[r] - w[r]).abs().max())))
        bad = (mine["plain_calls"] or not mine["launches"].get("ftimm_gemm")
               or (kind == "float32" and (
                   max(errs) > REC_REF_TOL
                   or any(gap > 2 * err for gap, err in gaps))))
        if bad:
            raise AssertionError(f"[mesh-train] (d) serve {kind}: logits "
                                 f"{errs}, greedy flips (gap, row error) "
                                 f"{gaps}, plain {mine['plain_calls']}, "
                                 f"launches {mine['launches']}")
        out[kind] = {"logits_errs": errs, "worst_logits": max(errs),
                     "greedy_flips": len(gaps),
                     "flip_gaps_and_row_errors": gaps,
                     "cache": mine["cache"],
                     "staged_bytes": mine["staged_bytes"],
                     "wall_s": mine["wall_s"],
                     "launches": mine["launches"]}
    return out


def mt_hold_elastic(ranks: list[dict]) -> dict:
    """The elastic re-mesh on both ranks: the faulted history and the
    recovered losses."""
    out = []
    for rank, r in enumerate(ranks):
        f, c = r["elastic"]["faulted"], r["elastic"]["clean"]
        hist = [h.get("failure") for h in f["history"]]
        ok = (hist == [None, "HostFailure", None]
              and f["history"][0]["mesh"] == (2, 1)
              and f["history"][2]["mesh"] == (1, 1)
              and f["left"] == (rank == 1) and len(c["history"]) == 1)
        errs = []
        if rank == 0:
            ok = ok and f["history"][2]["start"] == 5
            steps = MT_ELASTIC[0]
            errs = [abs(f["losses"][s] - c["losses"][s]) / c["losses"][s]
                    for s in range(6, steps)]
            ok = ok and len(errs) == steps - 6 and max(errs) <= 1e-5
        if not ok:
            raise AssertionError(f"[mesh-train] (elastic) rank {rank}: "
                                 f"history "
                                 f"{f['history']}, clean {c['history']}, "
                                 f"loss errors {errs}")
        out.append({"history": f["history"], "loss_rel_errs": errs})
    return {"ranks": out}


def spawn_world(target, phase: str, work: Path, dev, timeout: float,
                ranks: int = MT_RANKS) -> list[dict]:
    """Spawn ``ranks`` processes running ``target(rank, device, store, work,
    out_q)`` on ``dev``; wait for each one's result (a rank's failure or
    the timeout fails ``phase``); stop them all."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    store = work / f"{phase}_store"
    procs = [ctx.Process(target=target,
                         args=(r, str(dev), str(store), str(work), out_q))
             for r in range(ranks)]
    for p in procs:
        p.start()
    results = [None] * ranks
    deadline = time.monotonic() + timeout
    try:
        for _ in range(ranks):
            try:
                status, rank, value = out_q.get(
                    timeout=max(deadline - time.monotonic(), 1))
            except queue.Empty:
                raise AssertionError(f"[{phase}] the {ranks}-rank world did "
                                     f"not finish in {timeout} s") from None
            if status != "ok":
                raise AssertionError(f"[{phase}] rank {rank} failed:\n"
                                     f"{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results



def mesh_train_phase(dev) -> tuple[dict, dict]:
    """[mesh-train]: the one-rank runs in this process, then the two ranks
    on the card.  -> (the phase's figures, each rank's launches of (a)-(d)
    in bf16)."""
    import tempfile
    t_phase = time.monotonic()
    torch.zeros(1, device=dev)          # the card's context, before its stats
    with tempfile.TemporaryDirectory(prefix="mesh_train_") as tmp:
        work = Path(tmp)
        t0 = time.monotonic()
        one = {case: mt_one_rank(case, dev, work)
               for case in sorted(set(MT_ONE_RANK.values()))}
        one_s = time.monotonic() - t0
        t0 = time.monotonic()
        ranks = spawn_world(mt_rank, "mesh-train", work, dev, MT_TIMEOUT)
        world_s = time.monotonic() - t0
    held, launches = {}, {}
    for r, res in enumerate(ranks):
        for case in MT_CASES:
            got = res[case]
            held[(case, r)] = {**{k: v for k, v in got.items()
                                  if k not in ("launches", "panels")},
                               **mt_hold(case, one, got)}
            if MT_CASES[case][3] == "bfloat16":
                launches[(f"mesh-train ({case}) rank {r}",
                          MT_CASES[case][0])] = got["launches"]
        e = res["e"]
        if (e["staged_bytes"] != e["expected_staged_bytes"]
                or e["mean_rel_err"] >= 0.2 or not e["err_finite"]):
            raise AssertionError(f"[mesh-train] (e) rank {r}: {e}")
    serve = [mt_hold_serve(one, res["d_serve"]) for res in ranks]
    elastic = mt_hold_elastic(ranks)
    kept = {case: mt_hold_kept(case, one, ranks) for case in MT_CAPACITY}
    for case in MT_CASES:
        w = one[MT_ONE_RANK[case]]
        for r in range(MT_RANKS):
            h = held[(case, r)]
            log(f"  ({case}) {h['arch']} {h['layers']} l. {h['dtype']} mesh "
                f"{tuple(h['mesh'])} rank {r}: losses "
                f"{[round(x, 5) for x in h['losses']]} (one rank "
                f"{[round(x, 5) for x in w['losses']]}, worst "
                f"{max(h['loss_rel_errs']):.2e}); step median "
                f"{h['step_median_s']:.3f} s (one rank "
                f"{w['step_median_s']:.3f} s); staged "
                f"{h['staged_bytes_per_step'] / 1e9:.3f} GB a step; params "
                f"{h['params_rank'] / 1e9:.3f} B, moments "
                f"{h['moments_rank'] / 1e9:.3f} B, peak {h['peak_gb']:.2f} "
                f"GB (one rank {w['peak_gb']:.2f} GB); gradient norms "
                f"{[round(x, 4) for x in h['grad_norms']]} (one rank "
                f"{[round(x, 4) for x in w['grad_norms']]}); launches a step "
                f"{h['launches_per_step']}")
    for case, k in kept.items():
        log(f"  ({case}) capacity copies, first forward: {k['first_forward']}"
            f" summed over the ranks = one rank's; {k['calls_equal']} of "
            f"{k['calls']} capacity_slots calls equal ({k['gated_calls']} "
            "gated)")
    log(f"  (d) one rank, bf16 against fp32 prefill logits: "
        f"{serve[0]['one_rank_bf16_vs_fp32_prefill']:.2e}")
    for r, (served, res) in enumerate(zip(serve, ranks)):
        for kind in MT_SERVE_KINDS:
            sv = served[kind]
            per_call = [f"{x:.2e}" for x in sv["logits_errs"]]
            log(f"  (d) serve {kind} rank {r}: logits worst "
                f"{sv['worst_logits']:.2e} ({per_call}), "
                f"{sv['greedy_flips']} greedy flips (gap, row error) "
                f"{sv['flip_gaps_and_row_errors']}, cache {sv['cache']}, "
                f"staged {sv['staged_bytes']} B, {sv['wall_s']:.2f} s")
        log(f"  (e) rank {r}: staged {res['e']['staged_bytes']} B for "
            f"{MT_COMPRESS} elements, mean {res['e']['mean_rel_err']:.3e}; "
            f"seconds {res['seconds']}")
    log(f"  (elastic) {elastic}")
    for r in range(MT_RANKS):
        log(f"  (b) rank {r} panels: {ranks[r]['b']['panels']}")
    out = {"transport": DIST_TRANSPORT,
           "one_rank": {c: {k: v for k, v in o.items() if k != "serve"}
                        for c, o in one.items()},
           "cases": {f"{c} rank {r}": h for (c, r), h in held.items()},
           "serve": serve, "compress": [res["e"] for res in ranks],
           "elastic": elastic, "capacity_kept": kept,
           "seconds": {"one_rank": one_s, "world": world_s,
                       "ranks": [res["seconds"] for res in ranks],
                       "phase": time.monotonic() - t_phase}}
    log(json.dumps({"mesh_train": out}, default=str))
    return out, launches


# ---------------------------------------------------------------------------
# [placed]: the measured placed search, and its mesh measurements
# ---------------------------------------------------------------------------

PLACED_SHARDS = 2
PLACED_TIMEOUT = 300
PLACED_REPEATS = 10
# (autotune function, its positional signature, planner, planner's
# positional signature): qwen3-1.7b's decode gate / up and fp32 attention
# PV, llama4-scout's decode expert down.
PLACED_CASES = {
    "dense": ("autotune_gemm", (4, 2048, 6144, 2, 2), plan_gemm),
    "batched": ("autotune_batched_gemm", (32, 2, 96, 128, 4, 4),
                plan_batched_gemm),
    "ragged": ("autotune_ragged_gemm", (16, 4, 8192, 5120, 2, 2),
               plan_ragged_gemm)}
PLACED_KERNELS = {"dense": "ftimm_gemm", "batched": "ftimm_gemm_grouped",
                  "ragged": "ftimm_gemm_ragged"}
PLACED_E2E = {"ragged": (16, 4, 8192, 5120), "dense": (4, 6144, 2048)}


def placed_rank(rank: int, device: str, store: str, work: str,
                out_q) -> None:
    """One rank of the [placed] world: ``calibrate_ici(store=False)``, then
    both end-to-end placed timings in bf16, each with its launches."""
    import traceback

    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_mesh
    try:
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        tdist.init_process_group("gloo", init_method=f"file://{store}",
                                 rank=rank, world_size=PLACED_SHARDS)
        mesh = make_mesh((PLACED_SHARDS,), ("x",), backend="gloo",
                         device=dev)
        res = {}
        t0 = time.monotonic()
        cal = autotune.calibrate_ici(mesh, "x", repeats=PLACED_REPEATS,
                                     store=False)
        res["ici"] = {"cal": cal.to_json(),
                      "seconds": time.monotonic() - t0,
                      "stored": plan_store.get_store().calibration
                      is not None}
        for kind, dims in PLACED_E2E.items():
            fn = (autotune.time_placed_ragged_e2e if kind == "ragged"
                  else autotune.time_placed_dense_e2e)
            K.reset_launch_counts()
            t0 = time.monotonic()
            rows = fn(*dims, mesh=mesh, axis="x", in_bytes=2, out_bytes=2,
                      repeats=PLACED_REPEATS)
            torch.cuda.synchronize(dev)
            res[kind] = {"rows": rows, "launches": dict(K.launch_counts()),
                         "seconds": time.monotonic() - t0}
        out_q.put(("ok", rank, res))
    except BaseException:       # noqa: BLE001 -- reported, and the phase fails
        out_q.put(("error", rank, traceback.format_exc()))
    finally:
        if "tdist" in locals() and tdist.is_initialized():
            tdist.destroy_process_group()


def placed_search(dev, work: Path) -> dict:
    """The three placed searches in this process, stored, the store saved,
    cleared and reloaded, and the planner's placed plans read back."""
    out = {}
    autotune.clear_plan_store()
    for kind, (fn, dims, _) in PLACED_CASES.items():
        K.reset_launch_counts()
        t0 = time.monotonic()
        r = getattr(autotune, fn)(*dims, num_shards=PLACED_SHARDS,
                                  device=dev, repeats=PLACED_REPEATS)
        torch.cuda.synchronize(dev)
        launched = K.launch_counts()[PLACED_KERNELS[kind]]
        opts = {"dense": tuner.dense_placement_options,
                "batched": tuner.batched_placement_options,
                "ragged": tuner.ragged_placement_options}[kind]
        strategies = {(o.placement.strategy, o.placement.schedule)
                      for o in opts(*dims[:-2], PLACED_SHARDS, *dims[-2:])}
        won = (r.plan.placement.strategy, r.plan.placement.schedule)
        if (won not in strategies or not launched
                or not all(map(math.isfinite, (r.t_measured,
                                               r.t_analytic)))):
            raise AssertionError(f"[placed] {kind}: winner {won} of "
                                 f"{sorted(strategies)}, launches {launched},"
                                 f" times {r.t_measured} / {r.t_analytic}")
        out[kind] = {"key": r.key, "strategy": won[0], "schedule": won[1],
                     "tile": [r.plan.body, r.plan.bm, r.plan.bn, r.plan.bk],
                     "t_measured_us": r.t_measured * 1e6,
                     "t_analytic_us": r.t_analytic * 1e6,
                     "analytic": [r.analytic_plan.placement.strategy,
                                  r.analytic_plan.placement.schedule],
                     "local_timed": len(r.timed), "launches": launched,
                     "seconds": time.monotonic() - t0}
    path = str(work / "placed_plans.json")
    autotune.save_plan_cache(path)
    autotune.clear_plan_store()
    loaded = autotune.load_plan_cache(path)
    for kind, (_, dims, planner) in PLACED_CASES.items():
        served = planner(*dims, num_shards=PLACED_SHARDS)
        got = (served.mode, served.placement.strategy,
               served.placement.schedule)
        want = ("cached", out[kind]["strategy"], out[kind]["schedule"])
        if got != want:
            raise AssertionError(f"[placed] {kind}: served {got}, stored "
                                 f"{want}")
        out[kind]["served"] = served.mode
    autotune.clear_plan_store()
    out["records_loaded"] = loaded
    if loaded < len(PLACED_CASES):
        raise AssertionError(f"[placed] {loaded} records read back")
    return out


def placed_phase(dev) -> tuple[dict, dict]:
    """[placed]: the searches in this process, then the two ranks sharing
    the card.  -> (the phase's figures, the launches of each search and of
    each rank's end-to-end timings)."""
    import tempfile
    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="placed_") as tmp:
        work = Path(tmp)
        search = placed_search(dev, work)
        free_card()
        ranks = spawn_world(placed_rank, "placed", work, dev, PLACED_TIMEOUT,
                            ranks=PLACED_SHARDS)
    launches = {}
    for kind in PLACED_CASES:
        s = search[kind]
        log(f"  {kind} {s['key']}: {s['strategy']} / {s['schedule']} "
            f"{s['tile']}, {s['t_measured_us']:.1f} us (analytic placed "
            f"choice {s['analytic']} {s['t_analytic_us']:.1f} us), served "
            f"{s['served']}; {s['launches']} launches of "
            f"{PLACED_KERNELS[kind]}")
    for r, res in enumerate(ranks):
        frac = res["ici"]["cal"]["ici_frac"]
        if (not math.isfinite(frac) or frac <= 0
                or res["ici"]["stored"]):
            raise AssertionError(f"[placed] rank {r}: calibrate_ici "
                                 f"{res['ici']}")
        log(f"  rank {r} calibrate_ici: ici_frac {frac:.4g} (host staging "
            f"over gloo on one card, not NVLink; not stored)")
        for kind, kernel in (("ragged", "ftimm_gemm_ragged"),
                             ("dense", "ftimm_gemm")):
            e2e = res[kind]
            bad = [row for row in e2e["rows"]
                   if not (math.isfinite(row["t_measured"])
                           and row["t_measured"] > 0
                           and math.isfinite(row["t_model"]))]
            if bad or not e2e["launches"].get(kernel):
                raise AssertionError(f"[placed] rank {r} {kind} e2e: {e2e}")
            launches[(f"placed {kind} e2e rank {r}", ARCH)] = e2e["launches"]
            for row in e2e["rows"]:
                log(f"  rank {r} {kind} {PLACED_E2E[kind]} "
                    f"{row['strategy']:15s} {row['schedule']:6s} measured "
                    f"{row['t_measured'] * 1e3:9.3f} ms, model "
                    f"{row['t_model'] * 1e3:9.4f} ms")
            e2e.pop("launches")
    out = {"transport": DIST_TRANSPORT, "search": search,
           "ranks": [{k: v for k, v in res.items()} for res in ranks],
           "seconds": time.monotonic() - t_phase}
    log(json.dumps({"placed": out}, default=str))
    return out, launches


# ---------------------------------------------------------------------------
# [dryrun]: the production-mesh dry run -- every production cell on the
# abstract 16 x 16 mesh, beside real steps held to their abstract twins
# ---------------------------------------------------------------------------

DR_RANKS = 2
DR_TIMEOUT = 600            # seconds the spawned world may take in all
DR_WORKERS = 8              # processes lowering the production cells
DR_QWEN_LAYERS = 2          # qwen3-1.7b's depth in the real twins
DR_L4_LAYERS = 2            # llama4-scout's depth in [dist]'s EP decode twin
DR_TRAIN = (128, 8)         # (seq, batch) of the ZeRO-3 train twin
DR_DECODE = (64, 4)         # (cache rows, rows) of the TP decode twin: 63
                            # prompt tokens, the decoded token in the last row
DR_TOL = 1e-5               # fp32 TP decode against one rank's
# The variants lowered beside the baseline, each where it applies.
DR_VARIANTS = {
    "ep_moe": lambda cfg, shape: cfg.family == "moe",
    "serve_tp": lambda cfg, shape: shape.kind != "train",
    "ssm_shard": lambda cfg, shape: cfg.family in ("ssm", "hybrid"),
    "zero1": lambda cfg, shape: shape.kind == "train",
    "l4_ep_model": lambda cfg, shape: cfg.name == LLAMA4}


def dr_qwen_train(mesh, dev) -> dict:
    """[mesh-train]'s qwen3-1.7b ZeRO-3 (the dry run's baseline cell at
    DR_QWEN_LAYERS layers, DR_TRAIN tokens), on ``mesh`` and ``dev``."""
    from repro_torch.launch import dryrun as DR
    cfg = dataclasses.replace(get_config(ARCH), num_layers=DR_QWEN_LAYERS)
    cell = DR.build_cell(cfg, ShapeConfig("dr_train", *DR_TRAIN, "train"),
                         mesh, "baseline")
    return {"state": cell.state, "dist": cell.dist,
            "argument_size": cell.argument_size,
            "run": lambda: cell.step(*cell.args)}


def dr_qwen_decode(mesh, dev) -> dict:
    """qwen3-1.7b decoding under TP with its KV cache, fp32 (the dry run's
    serve_tp cell at DR_QWEN_LAYERS layers, DR_DECODE): ``pre`` prefills
    the cache, ``run`` decodes the last row and returns the logits."""
    from repro_torch.core import dist as DIST
    from repro_torch.launch import dryrun as DR
    cfg = dataclasses.replace(get_config(ARCH), num_layers=DR_QWEN_LAYERS,
                              compute_dtype="float32")
    rows, b = DR_DECODE
    cell = DR.build_cell(cfg, ShapeConfig("dr_decode", rows, b, "decode"),
                         mesh, "serve_tp")
    model, cache, tokens, pos = cell.args
    prompts = torch.as_tensor(np.random.default_rng(27).integers(
        2, cfg.vocab_size, (b, pos))).to(dev)

    def pre():
        with DIST.use_dist(cell.dist):
            M.prefill(model, cfg, {"tokens": prompts}, cache)

    return {"state": cell.state, "dist": cell.dist, "cfg": cfg,
            "argument_size": cell.argument_size, "pre": pre,
            "prompts": prompts, "tokens": tokens, "pos": pos,
            "run": lambda: M.decode_step(model, cfg, tokens, cache, pos)[0]}


def dr_llama4_decode(mesh, dev) -> dict:
    """[dist]'s llama4-scout EP decode (experts over "model", the cache's
    sequence over "model", the other weights whole) at DR_L4_LAYERS
    layers: ``pre`` prefills, ``run`` decodes one step."""
    from repro_torch.core import dist as DIST
    from repro_torch.launch import sharding as SHARD
    cfg = dataclasses.replace(_llama4_path_cfg("bf16"),
                              num_layers=DR_L4_LAYERS)
    ctx = DIST.DistContext(mesh, sp_decode=True,
                           moe_ep_axis=SHARD.expert_axis(
                               mesh, True, "model", cfg.num_experts))
    model = M.init_params(cfg, 0, device=dev, dist=ctx)
    with DIST.use_dist(ctx):
        cache = M.make_cache(cfg, DIST_PROMPTS, DIST_MAX_LEN, device=dev)
    prompts = _dist_prompts(cfg).to(dev)
    tokens = prompts[:, -1:].clone()
    state = [list(model.parameters()), cache, tokens]

    def pre():
        with DIST.use_dist(ctx):
            M.prefill(model, cfg, {"tokens": prompts}, cache)

    def run():
        with DIST.use_dist(ctx):
            return M.decode_step(model, cfg, tokens, cache,
                                 DIST_PROMPT_LEN)[0]

    from repro_torch.launch.dryrun import _unique_bytes
    return {"state": state, "dist": None, "pre": pre, "run": run,
            "argument_size": _unique_bytes(state) + 4}


# case -> (builder, (data, model), kernels its step must launch)
DR_CASES = {
    "qwen-zero3-train": (dr_qwen_train, (2, 1),
                         ("ftimm_gemm", "ftimm_gemm_swiglu",
                          "ftimm_gemm_grouped")),
    "llama4-ep-decode": (dr_llama4_decode, (1, 2),
                         ("ftimm_gemm", "ftimm_gemm_grouped",
                          "ftimm_gemm_ragged", "ftimm_gemm_ragged_swiglu")),
    "qwen-tp-decode": (dr_qwen_decode, (1, 2),
                       ("ftimm_gemm", "ftimm_gemm_swiglu",
                        "ftimm_gemm_grouped"))}


def dr_twin(case: str, dev, mesh) -> dict:
    """One real case on this rank: its collectives recorded over the step
    (the launch counts zeroed just before it and read just after), its
    exact argument bytes and the card's peak over the step; then the same
    case lowered on ``Mesh.abstract`` of the mesh's shape (``meta``, this
    process's planner state) and held to it: the same (op, bytes, axes)
    calls, the same argument bytes."""
    from collections import Counter

    from repro_torch.core import dist as DIST
    from repro_torch.core.gemm import collective as COLL
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.dryrun import _unique_bytes
    from repro_torch.launch.mesh import Mesh
    build, shape, need = DR_CASES[case]
    c = build(mesh, dev)
    with torch.no_grad():
        if "pre" in c:
            c["pre"]()
    real_bytes = _unique_bytes(c["state"])      # the card's storages
    torch.cuda.synchronize(dev)
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    with DIST.use_dist(c["dist"]), COLL.record() as rec:
        out = c["run"]()
    torch.cuda.synchronize(dev)
    launched = K.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    missing = [k for k in need if not launched.get(k)]
    if missing:
        raise AssertionError(f"[dryrun] {case}: no {missing} in the step "
                             f"({launched})")
    twin_mesh = Mesh.abstract(shape, ("data", "model"), device="meta",
                              shared_device=True)
    t = build(twin_mesh, torch.device("meta"))
    run = DR.trace(t["run"], t["state"], t["dist"], count_flops=False)
    mine = Counter((e.op, e.bytes, e.axis) for e in rec)
    twin = Counter((e.op, e.bytes, e.axis) for e in run["entries"])
    if mine != twin or not mine:
        raise AssertionError(f"[dryrun] {case}: the real step recorded "
                             f"{sorted(mine.items())}, its abstract twin "
                             f"{sorted(twin.items())}")
    if (t["argument_size"] != c["argument_size"]
            or _unique_bytes(t["state"]) != real_bytes):
        raise AssertionError(f"[dryrun] {case}: argument bytes "
                             f"{c['argument_size']} ({real_bytes} in the "
                             f"card's storages) real, {t['argument_size']} "
                             "abstract")
    by_op = {op: [sum(e.bytes for e in rec if e.op == op),
                  sum(1 for e in rec if e.op == op)]
             for op in sorted({e.op for e in rec})}
    res = {"collectives": by_op, "argument_size": c["argument_size"],
           "tracked_peak": t["argument_size"] + run["temp_size"],
           "card_peak": peak, "launches": launched,
           "abstract_s": run["seconds"]}
    if case == "qwen-tp-decode":
        res.update(dr_hold_decode(c, out, dev))
    return res


def dr_hold_decode(c: dict, logits, dev) -> dict:
    """The TP decode's logits and greedy tokens against one rank's decode
    of the same weights (the same draw, whole) and prompts."""
    cfg = c["cfg"]
    with torch.no_grad():
        model = M.init_params(cfg, 0, device=dev, dtype=cfg.param_dtype)
        model.requires_grad_(False)
        cache = M.make_cache(cfg, c["prompts"].shape[0], DR_DECODE[0],
                             device=dev)
        M.prefill(model, cfg, {"tokens": c["prompts"]}, cache)
        want = M.decode_step(model, cfg, c["tokens"], cache, c["pos"])[0]
    err = rel_err(logits.float(), want.float())[0]
    same = bool((logits.argmax(-1) == want.argmax(-1)).all())
    del model, cache
    free_card()
    if err > DR_TOL or not same:
        raise AssertionError(f"[dryrun] qwen-tp-decode: logits {err:.2e} "
                             f"from one rank's, greedy equal {same}")
    return {"logits_rel_err": err, "greedy_equal": same}


def dr_rank(rank: int, device: str, store: str, work: str, out_q) -> None:
    """One rank of the [dryrun] world: each real case against its twin."""
    import traceback

    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_mesh
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        os.environ["REPRO_RAGGED_A2A"] = "dense"
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        tdist.init_process_group("gloo", init_method=f"file://{store}",
                                 rank=rank, world_size=DR_RANKS)
        meshes = {shape: make_mesh(shape, ("data", "model"), backend="gloo",
                                   device=dev)
                  for shape in sorted({s for _, s, _ in DR_CASES.values()})}
        res = {}
        for case, (_, shape, _) in DR_CASES.items():
            t0 = time.monotonic()
            res[case] = dr_twin(case, dev, meshes[shape])
            res[case]["seconds"] = time.monotonic() - t0
            free_card()
        out_q.put(("ok", rank, res))
    except BaseException:       # noqa: BLE001 -- reported, and the phase fails
        out_q.put(("error", rank, traceback.format_exc()))
    finally:
        if "tdist" in locals() and tdist.is_initialized():
            tdist.destroy_process_group()


def dr_cells() -> list[tuple[str, str, str]]:
    """Every --all cell on pod16x16 under the baseline, and under each of
    DR_VARIANTS where it applies; the costliest first."""
    from repro_torch.configs import SHAPES, list_archs
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            cells.append((arch, name, "baseline"))
            cells += [(arch, name, v) for v, applies in DR_VARIANTS.items()
                      if applies(cfg, shape)]
    cost = {"train": 0, "prefill": 1, "decode": 2}
    return sorted(cells, key=lambda c: (cost[SHAPES[c[1]].kind],
                                        -get_config(c[0]).num_layers))


def dr_cell(cell: tuple) -> dict:
    """One production cell (a worker of the [dryrun] pool): its status,
    dominant term, bound and memory a device."""
    import traceback

    from repro_torch.launch import dryrun as DR
    torch.set_num_threads(1)
    arch, shape, variant = cell
    t0 = time.monotonic()
    try:
        r = DR.run_cell(arch, shape, variant=variant, save=False,
                        count_flops=False)
    except Exception:   # noqa: BLE001 -- a failed cell fails the phase
        return {"cell": DR.cell_name(arch, shape, False, variant),
                "status": "failed", "error": traceback.format_exc()[-2000:]}
    out = {"cell": r["cell"], "status": r["status"],
           "seconds": time.monotonic() - t0}
    if r["status"] == "ok":
        roof = r["roofline"]
        out.update(dominant=roof["dominant"], t_bound=roof["t_bound"],
                   t_compute=roof["t_compute"], t_memory=roof["t_memory"],
                   t_collective=roof["t_collective"],
                   peak_memory=r["memory"]["peak_memory"],
                   argument_size=r["memory"]["argument_size"],
                   coll_by_type=roof["coll_by_type"])
    else:
        out["reason"] = r["reason"]
    return out


def dryrun_phase(dev) -> tuple[dict, dict]:
    """[dryrun]: every production cell lowered by a pool of DR_WORKERS
    processes on the CPU (``meta``: nothing allocated) while the real twins
    run on DR_RANKS ranks sharing the card over gloo.  -> (the phase's
    figures, each rank's launches of the twins' steps)."""
    import multiprocessing as mp
    import tempfile
    t_phase = time.monotonic()
    cells = dr_cells()
    # The pool lowers the cells on the CPU while the twins' ranks run on
    # the card: the phase takes about the longer of the two.
    with mp.get_context("spawn").Pool(DR_WORKERS) as pool:
        pending = pool.map_async(dr_cell, cells, chunksize=1)
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
            ranks = spawn_world(dr_rank, "dryrun", Path(tmp), dev,
                                DR_TIMEOUT, ranks=DR_RANKS)
        twins_s = time.monotonic() - t0
        lowered = pending.get(timeout=DR_TIMEOUT)
    cells_s = time.monotonic() - t_phase
    failed = [c for c in lowered if c["status"] == "failed"]
    for c in lowered:
        if c["status"] == "ok":
            log(f"  [ok {c['seconds']:.1f}s] {c['cell']} "
                f"dominant={c['dominant']} t_bound={c['t_bound']:.3e}s "
                f"mem/dev={c['peak_memory'] / 2**30:.2f}GiB")
        elif c["status"] == "skipped":
            log(f"  [skipped] {c['cell']}: {c['reason']}")
    if failed:
        raise AssertionError("[dryrun] failed cells:\n" + "\n".join(
            f"{c['cell']}: {c['error']}" for c in failed))
    counts = {s: sum(c["status"] == s for c in lowered)
              for s in ("ok", "skipped", "failed")}
    log(f"  done: {counts['ok']} ok, {counts['skipped']} skipped, "
        f"{counts['failed']} failed ({cells_s:.1f} s, {DR_WORKERS} "
        f"processes; the twins {twins_s:.1f} s beside them)")
    launches = {}
    for r, res in enumerate(ranks):
        for case, c in res.items():
            launches[(f"dryrun rank {r}", case)] = c.pop("launches")
            log(f"  rank {r} {case}: collectives (bytes, count) by op "
                f"{c['collectives']} = its abstract twin's; argument "
                f"{c['argument_size']} B both; tracked peak "
                f"{c['tracked_peak'] / 2**20:.1f} MiB, card peak "
                f"{c['card_peak'] / 2**20:.1f} MiB (ratio "
                f"{c['tracked_peak'] / c['card_peak']:.2f})"
                + (f"; logits {c['logits_rel_err']:.2e} from one rank's"
                   if "logits_rel_err" in c else ""))
    out = {"cells": lowered, "counts": counts, "twins": ranks,
           "seconds": {"cells": cells_s, "twins": twins_s,
                       "phase": time.monotonic() - t_phase}}
    log(f"  [dryrun] phase {out['seconds']['phase']:.1f} s")
    log(json.dumps({"dryrun": out}))
    return out, launches


# ---------------------------------------------------------------------------
# [paper]: the paper's single-core comparison on the card -- the adaptive
# plan against the fixed TGEMM blocking (paper Alg. 1) at the paper's shapes
# ---------------------------------------------------------------------------

# benchmarks/single_core.py's CASES (name, M, K, N), copied: the paper's
# three irregular types and a regular control.
PAPER_CASES = (("t1_tall_small", 2**20, 32, 32),
               ("t1_tall_small_k64", 2**20, 64, 64),
               ("t2_skinny_tall", 32, 2**20, 32),
               ("t2_skinny_tall_n64", 64, 2**20, 64),
               ("t3_regular_tall", 20480, 20480, 32),
               ("t3_regular_tall_n96", 20480, 20480, 96),
               ("regular_control", 4096, 4096, 4096))
PAPER_DTYPES = (FP32, BF16)
PAPER_RUN = ("paper", "single_core shapes")     # its launches_by_run key
PAPER_TRIALS = 3            # time_ms runs; a case's time is their median
PAPER_TRIAL_MS = 100.0      # device time a run aims at: 3 to 20 calls
PAPER_LONG_MS = 5.0         # a call this long is timed alone


def paper_case(label, m, k, n, dtype, plan, *, clamp: bool) -> Case:
    """``ops.gemm(a, b, clamp=clamp, **plan.kernel_kwargs())`` on (M, K)
    x (K, N) operands of ``dtype`` (and output).  ``clamp`` True runs the
    plan as the dispatch layer does (an FMA tile clamped to the extent),
    False as planned (TGEMM's fixed tile padded by masking)."""
    kw = dict(plan.kernel_kwargs(), clamp=clamp)

    def make(gen):
        return (_randn(gen, (m, k), dtype),
                _randn(gen, (k, n), dtype, k ** -0.5))

    return Case("ftimm_gemm", label, make,
                lambda a, b: ops.gemm(a, b, out_dtype=dtype, **kw),
                lambda a, b: K.ftimm_gemm_plain(a, b, out_dtype=dtype),
                torch.matmul, (m * k + k * n + m * n) * _size(dtype),
                2.0 * m * n * k, dtype, dtype, model=PAPER_RUN[1],
                phase=PAPER_RUN[0], timed=True)


def paper_ran(plan, m: int, k: int, n: int, width: int, clamp: bool):
    """(body, tile, grid order, K slices) that ``ops.gemm`` runs for the
    plan, and the CMR model's time of it."""
    tile = (plan.bm, plan.bn, plan.bk)
    if plan.body == "fma" and clamp:
        tile = ops.clamp_tile(m, n, plan.bm, plan.bn,
                              K.fma_tiles(width, width))
    e = tuner.dense_estimate(m, k, n, width, width, body=plan.body,
                             bm=tile[0], bn=tile[1], bk=tile[2],
                             dim_order=plan.dim_order, kslices=plan.kslices)
    return (plan.body, tile, plan.dim_order, plan.kslices), e.t_total


def paper_median_ms(fn, inputs, sleep_ms: float) -> float:
    """The median of PAPER_TRIALS times of ``fn``.  A call of PAPER_LONG_MS
    or more (timed alone first) is timed alone with CUDA events
    (``ops.bench``), its launch a negligible share; a shorter one is a
    ``time_ms`` run of about PAPER_TRIAL_MS of device time (3 to 20 calls
    back to back)."""
    first = ops.bench(fn, *inputs[0], repeats=1) * 1e3
    if first >= PAPER_LONG_MS:
        return ops.bench(fn, *inputs[0], warmup=0,
                         repeats=PAPER_TRIALS) * 1e3
    reps = min(max(int(PAPER_TRIAL_MS / max(first, 1e-3)), 3), 20)
    return statistics.median(time_ms(fn, inputs, reps, sleep_ms)
                             for _ in range(PAPER_TRIALS))


def paper_phase(dev, card: str) -> tuple[dict, dict, dict]:
    """[paper]: each of PAPER_CASES in fp32 and bf16 through ``ops.gemm``
    with the adaptive plan (``plan_gemm``, analytic: the store is cleared)
    as the dispatch layer runs it and, where the clamp changes its FMA
    tile, as planned; and with the TGEMM baseline (``tgemm_plan``) as
    planned, unless it runs the adaptive plan's body and tile ("same
    plan").  Every case is held to its plain version (``check``: a case
    outside its tolerance raises); those runs are the phase's launches,
    counted from 0 and checked by kernel and body.  Then each is timed
    (``paper_median_ms``) beside ``torch.matmul`` and the plain version,
    with its bound (the operands read once and the output written once
    at 3.35 TB/s, or its FLOPs at the dtype's peak).
    -> (figures, launches, bodies) for the kernels line."""
    t_phase = time.monotonic()
    autotune.clear_plan_store()
    rows, cases = [], []
    for name, m, k, n in PAPER_CASES:
        for dtype in PAPER_DTYPES:
            w = _size(dtype)
            ours, fixed = plan_gemm(m, k, n, w, w), tgemm_plan(m, k, n, w, w)
            if ours.mode != "analytic":
                raise AssertionError(f"[paper] {name}: plan {ours.mode}")
            label = f"{name} {_name(dtype)}"
            row = {"name": name, "m": m, "k": k, "n": n,
                   "dtype": _name(dtype), "t_model_planned": ours.est.t_total,
                   "t_model_tgemm": fixed.est.t_total,
                   "upper_bound_fraction": upper_bound_fraction(
                       m, n, k, in_bytes=w), "cases": {}}
            runs = {"adaptive": (ours, True), "planned": (ours, False),
                    "tgemm": (fixed, False)}
            seen = {}
            for kind, (plan, clamp) in runs.items():
                ran, t_model = paper_ran(plan, m, k, n, w, clamp)
                row[f"ran_{kind}"] = ran
                row[f"t_model_{kind}"] = t_model
                if ran in seen:         # the same body and tile runs
                    row["cases"][kind] = seen[ran]
                    continue
                seen[ran] = kind
                c = paper_case(f"{kind} {label}", m, k, n, dtype, plan,
                               clamp=clamp)
                row["cases"][kind] = c
                cases.append((c, plan.body))
            rows.append(row)
    K.reset_launch_counts()
    worst = check([c for c, _ in cases], dev)
    launches, bodies = K.launch_counts(), K.body_counts()
    want = {b: sum(body == b for _, body in cases) for b in K.BODIES}
    if (launches["ftimm_gemm"] != len(cases)
            or any(v for kname, v in launches.items()
                   if kname != "ftimm_gemm")
            or bodies["ftimm_gemm"] != want):
        raise AssertionError(f"[paper] {len(cases)} cases ({want}) "
                             f"launched {launches}, bodies {bodies}")
    free_card()
    gen = torch.Generator(device=dev).manual_seed(4)
    sleep_ms = sleep_ms_per_mcycle()
    out = []
    for row in rows:
        first = row["cases"]["adaptive"]
        inputs = [first.make(gen)]
        lib = torch.matmul(*inputs[0])
        rel, _ = rel_err(lib, first.plain(*inputs[0]))
        if rel > TOL[first.out_dtype]:
            raise AssertionError(f"[paper] {first.label}: torch.matmul "
                                 f"disagrees with the plain version ({rel})")
        ms = {}
        for kind, c in row["cases"].items():
            if isinstance(c, Case):
                ms[kind] = paper_median_ms(c.run, inputs, sleep_ms)
        for kind, c in row["cases"].items():
            if not isinstance(c, Case):
                ms[kind] = ms[c]
        lib_ms = paper_median_ms(torch.matmul, inputs, sleep_ms)
        plain_ms = paper_median_ms(first.plain, inputs, sleep_ms)
        del inputs, lib
        free_card()
        t_bytes = first.nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = first.flops / PEAK_FLOPS[first.dtype] * 1e3
        r = {k: v for k, v in row.items() if k != "cases"}
        r.update({"ms": ms, "matmul_ms": lib_ms, "plain_ms": plain_ms,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "same_plan": row["ran_tgemm"] == row["ran_planned"],
                  "measured_ratio": ms["tgemm"] / ms["adaptive"],
                  "modeled_ratio": (row["t_model_tgemm"]
                                    / row["t_model_planned"]),
                  "modeled_ratio_as_run": (row["t_model_tgemm"]
                                           / row["t_model_adaptive"]),
                  "measured_ratio_planned": ms["tgemm"] / ms["planned"]})
        out.append(r)
        body, tile, order, _ = r["ran_adaptive"]
        planned = ("" if r["ran_planned"] == r["ran_adaptive"] else
                   f" (planned {r['ran_planned'][1]}: "
                   f"{ms['planned']:.4f} ms)")
        tg = ("same plan" if r["same_plan"] else
              f"tgemm {r['ran_tgemm'][0]} {r['ran_tgemm'][1]} "
              f"{ms['tgemm']:.4f} ms")
        as_run = r["modeled_ratio_as_run"]
        log(f"  [paper] {r['name']:19s} {r['dtype']:8s} adaptive {body} "
            f"{tile} {order} {ms['adaptive']:.4f} ms{planned} | {tg} | "
            f"tgemm / adaptive measured {r['measured_ratio']:.3f}x, modeled "
            f"{r['modeled_ratio']:.3f}x (as run {as_run:.3f}x) | "
            f"torch.matmul {lib_ms:.4f} ms | plain {plain_ms:.4f} ms | "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | "
            f"upper_bound_fraction {r['upper_bound_fraction']:.4f} | {card}")
    res = {"rows": out, "cases": len(cases), "max_abs_err": worst,
           "launches": launches["ftimm_gemm"], "bodies": want,
           "seconds": time.monotonic() - t_phase}
    log(json.dumps({"paper": res}))
    return res, {PAPER_RUN: launches}, {PAPER_RUN: bodies}


def check_not_degraded(phase: str) -> None:
    """A phase other than [chaos] must end with no degraded serving: a real
    fused-kernel failure may not hide behind the rung."""
    degraded = tuner.plan_mode_stats().get("degraded")
    if degraded:
        raise AssertionError(f"[{phase}] degraded servings: {degraded}")


YARDSTICKS = {
    "ftimm_gemm_swiglu": "two torch.matmul (one per panel), then silu(g) * u",
    "ftimm_gemm_grouped_swiglu": "two torch.bmm (one per panel), then "
                                 "silu(g) * u",
    "ftimm_gemm_ragged_swiglu": "two torch._grouped_mm (one per panel), "
                                "then silu(g) * u"}


def kernel_entries(rows, launches, worst, bodies,
                   quant_rows=()) -> list[dict]:
    """One entry per kernel, its numbers from its home run; the quantized
    type paths of ``ftimm_gemm`` and ``ftimm_gemm_ragged`` ([quant]) ride
    along in their entries' ``quant`` lists."""
    entries = []
    for name in K.KERNELS:
        phase, model = home = HOME[name]
        mine = [r for r in rows if r["kernel"] == name and r["model"] == model
                and r["phase"] == phase]
        calls = [(r["per_step"] or r["entry_calls"], r) for r in mine]
        total = {key: sum(n * r[key] for n, r in calls)
                 for key in ("ms", "plain_ms", "bound_ms")}
        lib = (None if any(r["library_ms"] is None for n, r in calls if n)
               else sum(n * r["library_ms"] for n, r in calls))
        yard = (None if any(r["yardstick_ms"] is None for n, r in calls if n)
                else sum(n * r["yardstick_ms"] for n, r in calls))
        t_bytes = sum(n * r["bytes_ms"] for n, r in calls)
        t_ops = sum(n * r["ops_ms"] for n, r in calls)
        if name == "ftimm_gemm_splitk":
            per = ("one call each at qwen3-1.7b's T2 dW shapes (1024 tokens "
                   "-> 2048x2048 and 2048x6144), nsplit 4, tensor-core "
                   "body; launches: [autotune]'s 2 qwen train steps, which "
                   "reach it through a stored nsplit-4 record (the "
                   "analytic planner never picks nsplit > 1)")
        elif phase == "train":
            per = (f"one train step of {model} at {depth(phase, model)} "
                   f"layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
        else:
            per = (f"one decode step of {model} at {depth(phase, model)} "
                   f"layers, {SLOTS} slots")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/ftimm/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[LAUNCH_RUN.get(name, home)][name],
            "max_abs_err": worst[name], "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib, "per": per,
            **({"yardstick_ms": yard, "yardstick": YARDSTICKS[name]}
               if yard is not None else {}),
            "launches_by_run": {f"{p} {m}": launches[(p, m)][name]
                                for p, m in launches},
            **({"bodies_by_run": {f"{p} {m}": bodies[(p, m)][name]
                                  for p, m in bodies}}
               if name in K.body_counts() else {}),
            "shapes": [{k: r[k] for k in ("model", "phase", "label",
                                          "per_step", "entry_calls", "ms",
                                          "plain_ms",
                                          "library_ms", "library_note",
                                          "yardstick_ms", "bound_ms",
                                          "bound_by")}
                       for r in rows if r["kernel"] == name],
            **({"quant": [{k: r[k] for k in (
                "label", "ms", "plain_ms", "library_ms", "library_note",
                "yardstick_ms", "bound_ms", "bound_by")}
                for r in quant_rows if r["kernel"] == name]}
               if any(r["kernel"] == name for r in quant_rows) else {})})
    return entries


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 is fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    phases = {}
    t_all = time.monotonic()

    t0 = time.monotonic()
    K.build()
    phases["build"] = time.monotonic() - t0
    log(f"[build] {len(K.KERNELS)} kernels in {phases['build']:.1f} s")

    t0 = time.monotonic()
    cfg = get_config(ARCH)
    view_len = math.ceil(MAX_LEN / PAGE) * PAGE
    qwen_cases = main_path_cases(cfg, view_len, bucket=64)
    moe_cases = moe_path_cases()
    rec_cases = recurrent_path_cases()
    fam_cases = family_path_cases()
    trn_cases = train_cases()
    rows_cases = rows_path_cases()
    log("[check] kernels against their plain versions")
    worst = check(qwen_cases + moe_cases + rec_cases + fam_cases + trn_cases
                  + edge_cases() + rows_cases + rows_edge_cases(), dev)
    bodies_check = check_bodies(dev)
    bodies_check["recurrent decode"] = check_decode_bodies(rec_cases, dev)
    bodies_check["families decode"] = check_decode_bodies(fam_cases, dev)
    free_card()
    phases["check"] = time.monotonic() - t0
    log(f"[check] done in {phases['check']:.1f} s")
    check_not_degraded("check")

    t0 = time.monotonic()
    log("[reference] small input, and the MoE models in fp32 at full width")
    small_reference(dev, ARCH)
    refs = {arch: moe_reference(arch, dev) for arch in (MIXTRAL, LLAMA4)}
    log("[reference] whisper-base and llava-next-34b: the smoke configs, and "
        "fp32 at full width (whisper at full depth, llava at 1 layer)")
    fam_refs = {}
    for arch in FRONTENDS:
        small_reference(dev, arch)
        fam_refs[arch] = family_reference(arch, dev)
    phases["reference"] = time.monotonic() - t0
    log(f"[reference] done in {phases['reference']:.1f} s")
    check_not_degraded("reference")

    t0 = time.monotonic()
    log("[serve] full width")
    stats, launches = {}, {}
    for arch in (ARCH, MIXTRAL, LLAMA4):
        stats[arch], engine, launches[("serve", arch)] = serve(arch, dev)
        if arch == ARCH:
            if stats[arch]["view_len"] != view_len:
                raise AssertionError(f"decode attends {stats[arch]['view_len']}"
                                     f" rows, timed at {view_len}")
            full_width_reference(engine, dev)
        del engine
        free_card()
    phases["serve"] = time.monotonic() - t0
    log(f"[serve] done in {phases['serve']:.1f} s")
    check_not_degraded("serve")

    t0 = time.monotonic()
    log("[recurrent] mamba2-370m and zamba2-7b on the dense-slot rung: "
        "fp32 references, then served at full width and depth")
    recurrent, rec_launches, rec_bodies = recurrent_phase(dev)
    launches.update(rec_launches)
    phases["recurrent"] = time.monotonic() - t0
    log(f"[recurrent] done in {phases['recurrent']:.1f} s")
    check_not_degraded("recurrent")

    t0 = time.monotonic()
    log("[families] whisper-base (encdec, dense-slot rung, full depth) and "
        f"llava-next-34b (vlm, paged rung, {FAM_LAYERS[LLAVA]} layers) "
        "served at full width")
    families, fam_launches, fam_bodies = families_phase(dev)
    launches.update(fam_launches)
    phases["families"] = time.monotonic() - t0
    log(f"[families] done in {phases['families']:.1f} s")
    check_not_degraded("families")

    t0 = time.monotonic()
    log("[archs] gemma3-4b, minitron-4b and qwen3-8b: their decode shapes "
        "against the plain versions, fp32 paged references, then served at "
        "full width and depth")
    arch_cases = [c for a in NEW_ARCHS for c in arch_path_cases(a)]
    for name, err in check(arch_cases, dev).items():
        worst[name] = max(worst.get(name, 0.0), err)
    free_card()
    archs, arch_launches, arch_bodies = archs_phase(dev)
    launches.update(arch_launches)
    phases["archs"] = time.monotonic() - t0
    log(f"[archs] done in {phases['archs']:.1f} s")
    check_not_degraded("archs")

    t0 = time.monotonic()
    log("[train-reference] fp32 training, card against CPU, full width")
    train_refs = {ARCH: train_reference_qwen(dev),
                  LLAMA4: train_reference_llama4(dev)}
    for arch in (WHISPER, LLAVA, MAMBA, ZAMBA):
        train_refs[arch + "-smoke"] = train_reference_smoke(arch, dev)
    phases["train_reference"] = time.monotonic() - t0
    log(f"[train-reference] done in {phases['train_reference']:.1f} s")
    check_not_degraded("train-reference")

    t0 = time.monotonic()
    log("[train] full width, bf16 compute on fp32 masters, AdamW")
    train_stats, train_calls = {}, []
    opt_cfg = OptConfig(warmup_steps=TRAIN_WARMUP,
                        total_steps=10 * TRAIN_WARMUP)
    for arch in (ARCH, LLAMA4, MIXTRAL, WHISPER, LLAVA, MAMBA, ZAMBA):
        train_stats[arch], launches[("train", arch)], recorder = train(
            arch, dev, opt_cfg)
        train_calls += recorded_cases(recorder, arch)
    phases["train"] = time.monotonic() - t0
    log(f"[train] done in {phases['train']:.1f} s")
    check_not_degraded("train")

    t0 = time.monotonic()
    log(f"[train-check] the {len(train_calls)} distinct kernel calls of the "
        f"{len(train_stats)} training runs, each against its plain version")
    for name, err in check(train_calls, dev).items():
        worst[name] = max(worst.get(name, 0.0), err)
    free_card()
    phases["train_check"] = time.monotonic() - t0
    log(f"[train-check] done in {phases['train_check']:.1f} s")
    check_not_degraded("train-check")

    t0 = time.monotonic()
    log("[train-schedule] the launcher's schedule (1-step warmup to 3e-4)")
    witness = schedule_witness(dev)
    phases["train_schedule"] = time.monotonic() - t0
    log(f"[train-schedule] done in {phases['train_schedule']:.1f} s")
    check_not_degraded("train-schedule")

    t0 = time.monotonic()
    log(f"[train-dots] qwen3-1.7b, {DOTS_STEPS} steps with remat 'full' and "
        "'dots'")
    dots = train_dots_phase(dev, opt_cfg)
    phases["train_dots"] = time.monotonic() - t0
    log(f"[train-dots] done in {phases['train_dots']:.1f} s")
    check_not_degraded("train-dots")

    t0 = time.monotonic()
    log("[autotune] qwen3-1.7b's GEMM signatures measured on the card")
    tuned = autotune_phase(dev)
    launches[("autotune", ARCH)] = tuned.pop("launches")
    phases["autotune"] = time.monotonic() - t0
    log(f"[autotune] done in {phases['autotune']:.1f} s")
    check_not_degraded("autotune")

    t0 = time.monotonic()
    log("[quant] the quantized type paths of ftimm_gemm and "
        "ftimm_gemm_ragged, and llama4-scout served with quantized experts")
    quant, quant_worst, quant_rows = quant_phase(dev)
    for name, err in quant_worst.items():
        worst[name] = max(worst.get(name, 0.0), err)
    phases["quant"] = time.monotonic() - t0
    log(f"[quant] done in {phases['quant']:.1f} s")
    check_not_degraded("quant")

    t0 = time.monotonic()
    log(f"[chaos] the chaos sites on qwen3-1.7b at {CHAOS_LAYERS} layers")
    chaos_out = chaos_phase(dev)
    phases["chaos"] = time.monotonic() - t0
    log(f"[chaos] done in {phases['chaos']:.1f} s")

    t0 = time.monotonic()
    log("[contracts] the static contracts on the card: the shared-memory "
        "budget, REPRO_VERIFY=1, NaN past every remainder, corrupt records")
    contracts_out = contracts_phase(dev, tuned["store_path"])
    phases["contracts"] = time.monotonic() - t0
    log(f"[contracts] done in {phases['contracts']:.1f} s")
    check_not_degraded("contracts")

    t0 = time.monotonic()
    log(f"[dist] the mesh executors on process groups: {DIST_RANKS} ranks on "
        f"one card over {DIST_TRANSPORT}, llama4-scout at {MOE_LAYERS} "
        "layers across them, and a one-rank NCCL world")
    free_card()
    dist_out, dist_launches = dist_phase(dev)
    launches.update(dist_launches)
    phases["dist"] = time.monotonic() - t0
    log(f"[dist] done in {phases['dist']:.1f} s")
    check_not_degraded("dist")

    t0 = time.monotonic()
    log(f"[mesh-train] training on a mesh: {MT_RANKS} ranks on one card "
        f"over {DIST_TRANSPORT}; qwen3-1.7b ZeRO-3 and tensor parallel, "
        "llama4-scout expert parallel, mamba2-370m head-sharded, the int8 "
        "all-reduce, the elastic re-mesh, mixtral-8x7b's capacity MoE with "
        "the rows cut over data, whisper-base tensor parallel, qwen3-1.7b "
        "ZeRO-1")
    free_card()
    mesh_train, mt_launches = mesh_train_phase(dev)
    launches.update(mt_launches)
    phases["mesh_train"] = time.monotonic() - t0
    log(f"[mesh-train] done in {phases['mesh_train']:.1f} s")
    check_not_degraded("mesh-train")

    t0 = time.monotonic()
    log(f"[placed] the measured placed search ({PLACED_SHARDS} shards) and "
        f"its mesh measurements on {PLACED_SHARDS} ranks over "
        f"{DIST_TRANSPORT}")
    free_card()
    placed, placed_launches = placed_phase(dev)
    launches.update(placed_launches)
    phases["placed"] = time.monotonic() - t0
    log(f"[placed] done in {phases['placed']:.1f} s")
    check_not_degraded("placed")

    t0 = time.monotonic()
    log("[dryrun] the production-mesh dry run: every cell on the abstract "
        "16 x 16 mesh, and real steps on two ranks against their abstract "
        "twins")
    free_card()
    dryrun, dr_launches = dryrun_phase(dev)
    launches.update(dr_launches)
    phases["dryrun"] = time.monotonic() - t0
    log(f"[dryrun] done in {phases['dryrun']:.1f} s")
    check_not_degraded("dryrun")

    t0 = time.monotonic()
    log("[paper] the paper's single-core shapes in fp32 and bf16: the "
        "adaptive plan against the fixed TGEMM blocking, beside "
        "torch.matmul")
    free_card()
    paper, paper_launches, paper_bodies = paper_phase(dev, card)
    launches.update(paper_launches)
    phases["paper"] = time.monotonic() - t0
    log(f"[paper] done in {phases['paper']:.1f} s")
    check_not_degraded("paper")

    t0 = time.monotonic()
    log("[roofline] the perf model's bound for every profiled decode step")
    profiled = {**recurrent["serve"], **families, **archs["serve"],
                f"{LLAMA4}-w8": quant["serving"]["w8"]}
    roofline = roofline_phase(profiled)
    roofline["dist_ep"] = roofline_dist(dist_out)
    phases["roofline"] = time.monotonic() - t0
    log(f"[roofline] done in {phases['roofline']:.1f} s")

    t0 = time.monotonic()
    log("[time] decode-step and training shapes")
    rows = timings(qwen_cases + moe_cases + rec_cases + fam_cases + trn_cases
                   + arch_cases + rows_cases, dev)
    check_not_degraded("time")
    phases["time"] = time.monotonic() - t0
    log(f"[time] done in {phases['time']:.1f} s")

    log("kernels:")
    for r in rows:
        lib_s, yard_s = ("-" if r[key] is None else f"{r[key] * 1e3:.1f}"
                         for key in ("library_ms", "yardstick_ms"))
        log(f"  {r['kernel']:25s} {r['label']:32s} x{r['per_step']:<3d} "
            f"kernel {r['ms'] * 1e3:9.1f} us  plain "
            f"{r['plain_ms'] * 1e3:9.1f} us  library {lib_s:>9s} us  "
            f"two calls + silu {yard_s:>9s} us  "
            f"bound {r['bound_ms'] * 1e3:7.1f} us ({r['bound_by']})")
    phases["all"] = time.monotonic() - t_all
    log(json.dumps({"bodies_check": bodies_check, "serve": stats,
                    "moe_reference": refs, "recurrent": recurrent,
                    "family_reference": fam_refs, "families": families,
                    "train_reference": train_refs, "train": train_stats,
                    "train_schedule": witness, "autotune": tuned,
                    "quant": quant, "archs": archs, "train_dots": dots,
                    "chaos": chaos_out, "contracts": contracts_out,
                    "dist": dist_out, "mesh_train": mesh_train,
                    "placed": placed, "dryrun": dryrun, "paper": paper,
                    "roofline": roofline, "phases_s": phases}))
    log(card)
    bodies = {("serve", a): stats[a]["bodies"] for a in stats}
    bodies.update(rec_bodies)
    bodies.update(fam_bodies)
    bodies.update(arch_bodies)
    bodies.update(paper_bodies)
    bodies.update({("train", a): train_stats[a]["bodies"]
                   for a in train_stats})
    print(json.dumps({"kernels": kernel_entries(rows, launches, worst,
                                                bodies, quant_rows)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
