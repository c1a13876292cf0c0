#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives
the port on the card, phase by phase; any failed phase raises and the
script exits non-zero. It exits non-zero before doing anything when
there is no CUDA device or no ``src/repro_torch`` beside it.

1. The card (``nvidia-smi`` name and power limit) and the kernel build:
   one ``nvcc`` per source, all started together, each waited for just
   before the first step that needs it (``kahan_matmul.cu``, the
   longest, builds on beside phases 2-3's reduction and flash steps).
2. Kernel parity. Reductions: for every built-in scheme x U in {1, 8} x
   {float32, float64, bfloat16}, the (s, c) grids of ``kahan_dot_grid``
   and ``kahan_sum_grid`` -- single and batched -- equal their plain
   PyTorch versions bit for bit, and a batched launch equals a loop of
   single ones: [3, n] for n up to 5 steps and for n spanning two full
   load rings of the one-row plan and a partial stage; at U = 8 batch 8
   over two of its rings and the serving shape [4, 57344]; the deep case
   again on operands one element off 16 bytes (the element-copy path).
   Both copy paths and the two-rings case are checked to have run in
   every wrapper; the plans covered are logged. Flash: for every
   built-in scheme x causal / not (B7) x q_groups in {1, 2}, at
   OLMo-1B's head dim with Sq and Skv off their blocks and Skv over 3
   k-blocks, at 4 and 48 head-rows, the raw (l, acc) grids of
   ``flash_accumulators`` (B7) and ``flash_chunk_accumulators`` (B8)
   equal their plain version bit for bit, and B8 rows at block-aligned
   offsets equal B7's rows bit for bit, also where B7 runs 64-row tiles
   and B8 16-row ones. Matmul: for every built-in scheme
   x {float32, float64}, with M, N and K padded by the engine (M 1 and 37,
   N 200, K 1100; and a K of 16 blocks), operands in bf16 and float32, the
   (s, c) grids of ``matmul_accumulators`` (B5) equal ``matmul_plain``
   bit for bit, bf16 operands equal the same operands promoted first,
   ``matmul_accumulators_batched`` (B6) equals its plain version and a
   loop of B5, the rows of an M = 64 product equal M = 1 products of the
   same rows, and the autograd backward of ``ops.matmul`` launches B5
   twice and equals B5 on (g, bT) and (aT, g). The M <= 8 path on
   unpadded rows: M in {1, 3, 8} x 1, 4 and 16 K-blocks x N a multiple of
   the CTA's 16 columns and not, for every scheme, float32 (float32
   operands, and bf16 ones up to 4 K-blocks) and float64, equal to
   ``matmul_plain`` bit for bit; operands whose rows are not 16-byte
   aligned (staged without cp.async); B6 at batch 4 and M 1 equal to a
   loop of B5. The M > 8 path: M in {9, 32, 37, 64, 100, 300} x 1, 3 and
   4 K-blocks and M 37 x 17 K-blocks (not on bf16 operands), x N 200, every scheme, float32 (bf16 and float32
   operands) and float64, equal to ``matmul_plain`` bit for bit; B6 at
   batch 3 equal to a loop of B5; rows
   0, 8, 31 and M - 1 of M in {9, 64, 300} equal M = 1 products. The
   column scan of the compensated global norm (``kahan_sq_columns``)
   against its plain loop, bit for bit, on float32 and bf16 leaves
   (tall, one row, ragged rows and columns). Subnormals (the kernels
   are built with ``-ftz=true``; the plain versions flush op for op as
   XLA does on the CPU): every reduction wrapper for every scheme in
   float32 and bf16 on products and sums that underflow, on products a
   few ulps either side of ``tiny`` (x86 flushes (1 - 2^-24) tiny and
   keeps (1 - 2^-23) tiny (1 + 2^-23), and so must the card), and on
   bf16 subnormal operands into a float32 accumulate; B5 at M 3 and 37;
   B7 and B8 where ``exp`` underflows; the column scan; bit for bit.
   The compute dtypes of every TPU kernel (``dtype_parity``): B5 in
   bfloat16 compute (each op computed in float32 and rounded once) for
   every scheme at M 1, 3, 8 (the rows path) and 9, 37, 64, 300 (the
   tiles) x 1, 4 and 17 K-blocks, B6 in bfloat16 equal to its plain
   version and a loop of B5, and B5 at OLMo-1B's q projection (M 1) and
   its chunk gate/up (M 64); B7 and B8 in bfloat16 and in float64 for
   every scheme, causal and not, G 1 and 2 (BH 4 and 16) at OLMo-1B's
   head dim, B8 rows == B7 rows, and B8 at OLMo-1B's serving chunk; each
   bit for bit against its plain version.
3. Kernel times: each kernel at the shape its main path gives it (dot and
   sum at the paper's in-memory size n = 2^27 for every scheme, with each
   scheme's time over naive's, the paper's metric; batched dot and sum
   at [8, 2^24], the serving telemetry at [max_slots, 57344]; each with
   its plan, copy path, share of the bytes bound and the time of the
   kernel before its load ring; phase 7 prints the machine model beside
   each), B7 at
   OLMo-1B's head shape [16, 2048, 128] causal, B8 at the serving chunk
   [16, 64, 128] against both serve runs' cache lengths, B5 at OLMo-1B's
   projection shapes at decode (M 1, the served shape, and M 8 for
   comparison with the padded rows of earlier runs) and in a 64- and a
   32-token chunk plus the up projection of a 2048-token prefill, B6 at 4 chunk-sized q projections; each matmul
   and flash row with the tile (and cluster size or ring depth) the
   kernel chose and its share of the mul+add ceiling, 2·M·N·K or 4·BH·dh
   times the (query, key) pairs the causal mask keeps (unpadded) over
   half the float32 fma rate; the flash rows also
   with the time of the 16-row kernel they replace), device time of
   launches captured in a CUDA graph (back-to-back launches timed with
   CUDA events beside the reductions and flash),
   beside its bound (bytes or float32 operations, both counted on the
   function's own inputs, not the engine's padding),
   its plain version's time and one PyTorch call computing the same
   function (``library_ms``, a yardstick the port never calls:
   ``scaled_dot_product_attention`` in float32 with the same mask for the
   flash kernels, ``torch.matmul`` / ``bmm`` on the operands promoted to
   float32, TF32 off, for the matmul kernels). The training rows: B5 at
   every shape and operand pair a train step gives it (forward and
   recompute bf16 x bf16, dA = g @ W^T float32 x bf16, dB = a^T @ g bf16
   x float32, 1024 tokens a microbatch; the engine copies and widens
   none), with the B5 time a step they add up to; B3 at the largest
   parameter leaf (2^28 float32); the column scan at the embedding's
   [51200, 2048] gradient and a [16, 2048, 8192] one
   (``torch.linalg.vecdot(x, x, dim=0)`` as its library call). The
   compute dtypes (``dtype_times``, each row with its parity check): B7
   at the entry shape and B8 at phase 14(c)'s chunk [16, 64, 128]
   against 72 rows, B5 at the decode q/k/v/o (M 1) and chunk gate/up (M
   64) shapes and B4 at the telemetry's [4, 57344], in bfloat16 and in
   float64, B6 at the batched shape in bfloat16, and B5 at M 4 in
   float32 (phase 14(b)'s vmapped tick). Their bounds count operations
   at the peak for the dtype (bfloat16 989 TFLOP/s, float64 67 TFLOP/s
   on the FP64 tensor cores: NVIDIA's H100 data sheet) and the library
   call runs in the same dtype.
4. The main path's paths, each with every launch count set to 0 just
   before it and read just after it. Serving OLMo-1B at its published
   width (random bf16 weights from a seeded generator, dense KV,
   ``track_stats=True``, scheme kahan): the 4-request trace with chunked
   scan prefill, the same trace with ``kahan_attention=True,
   prefill_mode="flash"``, and one long request (1920-token prompt) under
   flash, and the same trace again with ``kahan_matmul=True`` as well
   (every dense projection through B5). Checked: every request emits its
   tokens, the telemetry is finite, the sum kernel launched once per
   decode tick and finished prefill, B8 exactly n_layers per chunk of
   width > 1 under flash and never under scan, B5 exactly 7 * n_layers
   per prefill chunk and decode position with ``kahan_matmul`` and never
   without it, no other kernel while serving, one tick's telemetry
   equals the plain version's bit for bit, and a 64-token chunk's logits
   with ``kahan_matmul`` are close to the flash run's (relative L2 below
   5e-2, the same argmax). One decode position is profiled with and
   without ``kahan_matmul`` (device kernels, cuBLAS gemm/gemv kernels).
   Entry points: the paper's ``ops.dot / asum / batched_dot /
   batched_asum`` once each, ``TransformerLM.prefill`` on a 2048-token
   prompt (B7 once per layer; its logits finite and close to the
   materialized attention path's), the ``flash_attention`` veneer once,
   ``ops.matmul`` at the 2048-token up projection and
   ``ops.batched_matmul`` once.
5. Solo vs interleaved: request 0 replayed alone emits bitwise the same
   tokens and telemetry, under scan, under flash and with
   ``kahan_matmul``.
6. Training: OLMo-1B at its published width and depth trained by the
   port's ``Trainer`` (random bf16 weights from seed 0, the synthetic
   Markov stream at seq 256 and global batch 8 in 2 microbatches, 4
   steps, warmup 1, KahanAdamW at lr ``TRAIN_LR``), twice, each with the
   launch counts reset just before it: run A (cuBLAS projections, the
   compensated tree norm through the column scan) and run B
   (``kahan_matmul``: every projection, its recompute and its backward
   on B5; ``kahan_norm=False``: B3 once a leaf). Checked: every loss and
   grad norm finite, the step-4 loss below the step-1 loss in both runs,
   run B's step-1 loss and grad norm within ``STEP1_LOSS_RTOL`` and
   ``STEP1_GRAD_NORM_RTOL`` of run A's, B5
   launched 4 * 7 * 16 * 2 = 896 times a step and B3 once a parameter
   leaf in run B, the column scan once a leaf in run A, nothing else;
   the tree norm as the kernel on a tree of the gradients' shapes, and
   as the plain loop on its embedding leaf, its (s, c) bitwise equal to
   the kernel's; and at the
   smoke config, a run that crashes after step 2 resumes to step 4 with
   params and optimizer state bitwise equal to the uninterrupted run.
   Logged per run: wall ms a step after the first, tokens/s, device-busy
   ms of one more profiled step, peak memory, losses and grad norms, the
   port's kernels' ms and launches a step.
7. The paper on the card: B1 (dot) and B3 (sum) for every built-in
   scheme x U in {1, 2, 4, 8, 16}, each grid bitwise equal to its plain
   version at n = 2^22; each timed at n = 2^27 float32 (graph time)
   beside its bytes bound, its CTAs and SMs, its time over naive's at the
   same U, and the machine model's prediction and bounding term
   (``repro_torch.core.ecm``) on this card's load-only bandwidth
   (``torch.sum`` over 2^28 float32, a yardstick of the machine, not on
   the port's path) and clock under load, with one SM's load rate fitted
   on the naive dot at U = 1 alone; the saturation U predicted and
   measured (the least U within 5% of U = 16). Then the reference's
   accuracy ladder (GenDot at n = 2^20, conditions 1 and 10 and the
   reference's 1e4 to 1e12) through ``ops.dot`` on the card: every
   a-priori bound at every condition, kahan <= naive and pairwise <=
   1.01 naive where the achieved condition is below 1/eps (only the
   conditions 1 and 10 at this n), dot2 two digits below kahan at 1e10.
   Phase 3's B1-B4 rows beside the model of this run's machine. The
   model's error is printed, not gated. One JSON line ``{"ecm": [...],
   "phase3": [...], "ladder": [...]}``, a row per (op, scheme, U), per
   phase-3 row and per condition.
8. The distributed slice: two ranks share the card over gloo (NCCL
   refuses two ranks on one device), spawned with
   ``torch.multiprocessing`` over a ``FileStore`` under ``build/``.
   Each runs ``sharded_asum`` and ``sharded_dot`` at n = 2^27 (B3, B1 on
   its 2^26 block), ``sharded_matmul`` [1024, 2048] x [2048, 8192] with
   K split 2 (B5), ``activation_sq_norm`` at [4, 57344] on the
   batch-sharded mesh (B4, 2 requests a rank), ``deterministic_mean``
   and ``compressed_psum`` on a [2048, 8192] leaf, twice, then OLMo-1B
   at full width, CUT to 2 of its 16 layers (``DIST_LAYERS``), on
   ``make_local_mesh()`` (phase 6's run A, ``DIST_TRAIN_STEPS`` (1)
   step, twice), its loss
   folded through ``sharded_asum``. Checked:
   every result the same bits on both ranks and in both runs, equal to
   the same kernels' per-shard grids folded here by
   ``merge_accumulators`` / ``merge_accumulator_grids`` and to the plain
   versions' sharded fold; B1, B3, B4 and B5 twice a rank; the
   trainer's loss the same bits on both ranks and run to run, equal to
   the sharded fold of its microbatch losses recomputed here, within
   1e-6 (relative) of their local Kahan fold, B3 once a step. Logged:
   the gather's µs a call, the sharded sum's ms beside B3's alone, each
   rank's peak memory, the phase's seconds.

9. The dense family and the paged layout: deepseek-7b, stablelm-3b,
   qwen2.5-3b (QKV bias, GQA 8) and internvl2-2b (256 patch embeddings
   spliced over its prompts) at their published width and depth (bf16,
   random weights from seed 0), one at a time, each freed before the
   next, each serving three staggered requests (prompts of 48, 96 and
   160 tokens, internvl's of 256 patches plus 32 text tokens, 8 new
   tokens each) under flash prefill with ``kahan_attention``
   (``max_slots=4``, ``prefill_chunk=64``, telemetry, kahan, U = 8),
   the launch counts reset just before. Checked: B8 n_layers times a
   chunk and B4 once a tick and finished prefill, nothing else; one
   tick's telemetry bitwise equal to the plain version; request 0 alone
   == interleaved, bitwise; a 64-token chunk's flash logits within phase
   4's relative L2 of 5e-2 of the scan path's; qwen2.5-3b also serves
   one request with ``kahan_matmul`` (B5 7 times a layer, chunk and
   decode position; the QKV bias after B5) and its chunk logits against
   flash (relative L2 below 5e-2, the same argmax, as in phase 4). Then deepseek-7b on the paged layout (``page_size`` 16): the
   trace's tokens and telemetry bitwise equal to the dense run's, again
   in a pool whose every other page is held (scattered page tables ==
   contiguous), a 64-token shared prefix admitted by reference equal to
   its private prefill (``prefix_hit_tokens`` > 0), the free list back
   to its initial size. Phase 2 first holds the kernels at these shapes
   against their plain versions, bitwise: B1-B4 on [4, vocab] rows of
   each config, B7/B8 at dh 80 and at G 8, B5 on operands the engine
   pads (K 11008, 6912) and at N 256. Logged per config: params and
   peak GiB, tokens/s, decode-tick ms, prefill ms per position, and the
   KV bytes the dense rows hold against the paged live pages; one JSON
   line ``{"slice": {...}}``.
10. The MoE family. deepseek-v2-lite-16b at its published width and
   depth (27 layers, MLA with a 512-wide latent, 64 experts top-6 and 2
   shared, a dense first layer; bf16, random weights from seed 0) at
   the first 4 of its 27 layers (a cut for the script's time limit)
   serves phase 9's trace with flash prefill asked for, which the engine
   resolves to the scan body (MLA and capacity routing have no parallel
   chunk), the launch counts reset just before: B4 once a tick and
   finished prefill, nothing else; one tick's telemetry bitwise equal to
   the plain version; request 0 alone == interleaved, bitwise; the same
   trace at that depth on the paged layout (``page_size`` 16), paged
   equal to dense bitwise, the pool free at the end, ``dropped_frac`` 0
   at every single-position MoE call; at the same 4 layers the
   whole-prompt ``TransformerLM.prefill`` of the 160-token
   prompt at capacity factor 16 against the scan chunk's last logits,
   in float32 compute on the bf16 weights within relative L2 2e-3 and
   the same argmax, and in bf16 logged with the tokens routed to other
   experts; one request with ``kahan_matmul`` at the same 4 layers (B5
   28 times a position: MLA's q, dkv, kr and o, the dense layer's MLP
   and the shared experts) and a 16-token scan chunk's logits against
   the cuBLAS path, in
   float32 compute within relative L2 5e-2 and the same argmax, in bf16
   logged with the tokens routed to other experts; at all 27 layers one
   profiled decode position (host ms,
   device-busy ms, kernels). Then llama4-maverick-400b-a17b at its
   published width CUT to 2 of its 48 layers (one dense+MoE superblock;
   d 5120, 40/8 heads, 128 experts top-1, vocabulary 202048): one
   request on the dense layout and its whole-prompt prefill against the
   scan chunk as deepseek's (float32 compute gated, bf16 logged).
   Phase 2 first holds B5 (kahan) at M 1 and 64 on every projection of
   both configs and B1-B4 at their [4, vocab], bitwise. Logged per
   config: params, init peak and peak GiB, tokens/s, decode-tick ms,
   prefill ms per position, KV bytes a token and held; one JSON line
   ``{"moe": {...}}``.
11. The hybrid family. hymba-1.5b at its published width and depth (32
   layers, d 1600, 25 heads over 5, attention and a selective SSM in
   every layer, 1024-token sliding-window rings on 29 layers, global
   layers {0, 15, 31}; bf16, random weights from seed 0, no cut) serves
   ``SCAN_TRACE`` (prompts of 16, 32 and 80 tokens: phase 9's trace cut
   in depth) with flash prefill asked for, which the engine
   resolves to the scan body (the SSM recurrence and the rings have no
   parallel chunk), the launch counts reset just before: B4 once a tick
   and finished prefill, nothing else; one tick's telemetry bitwise
   equal to the plain version; request 0 alone == interleaved, bitwise
   (the paged layout, held to dense on the CPU, is cut for time); one
   request with ``kahan_matmul`` (B5 7 times a layer and position: q,
   k, v, o, gate, up, down; the SSM's contractions stay plain, as in
   the reference).
   Then the rings wrap at the published window: ``HymbaLM.prefill`` of a
   1088-token prompt under ``kahan_attention`` (B7 on the 3 global
   layers, [25, S, 64] over 5 KV heads) and 8 greedy ``decode_step``s
   against the wrapped rings, each step's logits against a prefill of
   the prompt and the tokens so far: in float32 compute on the bf16
   weights within relative L2 2e-3 (the reference test's tolerance) and
   the same argmax; B7 3 times a prefill. One profiled
   decode position. Phase 2 first holds B4 on [4, 32001] (every scheme),
   B7/B8 at dh 64 with GQA groups of 5 and B5 at M 1 and 64 on hymba's
   projections (K 1600 and 5504, N 320, all padded by the engine),
   bitwise. Logged: params, init peak and peak GiB, tokens/s, decode-tick
   ms, prefill ms per position, the KV held (rings, global layers, SSM
   state); one JSON line ``{"hybrid": {...}}``.
12. The xLSTM family. xlstm-1.3b at its published width and depth (48
   blocks: 6 groups of 7 mLSTM and one sLSTM, d 2048, 4 heads, chunk
   512; bf16, random weights from seed 0, no cut) serves ``SCAN_TRACE``
   with flash prefill and the paged layout asked for, which the engine
   resolves to the scan body and the dense layout (recurrent state
   only), the launch counts reset just before: B4 once a tick and
   finished prefill, nothing else (its projections are einsums, as in
   the reference); one tick's telemetry bitwise equal to the plain
   version; request 0 alone == interleaved, bitwise (a slot reused
   after an eviction is held to a fresh engine on the CPU,
   ``tests/test_torch_xlstm.py``). Then ``XLSTMLM.prefill`` of a
   640-token prompt (two 512-token chunks, the second padded) and
   ``XLSTM_STEPS`` (4) greedy ``decode_step``s, each step's logits against a prefill of the
   prompt and the tokens so far: with the bf16 weights, the compute and
   every float32 cast in float64 within relative L2 2e-3 and the same
   argmax (in bf16 and float32 compute rounding alone parts the two
   bodies, amplified block by block: ``scripts/xlstm_conditioning.py``);
   no kernel launched. One profiled decode position. Logged: params,
   init peak and peak GiB, the state bytes, tokens/s, decode-tick ms,
   prefill ms per position; one JSON line ``{"xlstm": {...}}``.
13. The encoder-decoder family. whisper-large-v3 at its published width
   and depth (32 encoder and 32 decoder layers, d 1280, 20 heads of 64,
   GELU MLP of 5120, 1500 frames; bf16, random weights from seed 0, no
   cut), each request with frames [1500, 1280] drawn from the seed,
   serves phase 9's trace under flash prefill with ``kahan_attention``,
   the launch counts reset just before: B8 32 times a chunk, B4 once a
   tick and finished prefill, nothing else; one tick's telemetry bitwise
   equal to the plain version; request 0 alone == interleaved, bitwise;
   the paged layout (``page_size`` 16: only the self-attention K/V page,
   the cross K/V stay dense slot rows) equal to dense bitwise, the pool
   free at the end; one request with ``kahan_matmul`` (B5 6 times an
   encoder layer a request at M 1500, 8 times a decoder layer a chunk
   and position); the encoder alone under ``kahan_matmul`` (B5 192
   times); ``EncDecLM.prefill`` of the 160-token prompt (B7 32 times)
   against the chunked path over the same ``prefill_begin``, relative L2
   below 5e-2 and the same argmax. One profiled decode position. Phase 2
   first holds B4 on [4, 50304] and [4, 51866] (every scheme), B7/B8 at
   dh 64 and G 1 (BH 20 and 80) and B5 at M 1, 64 and 1500 on whisper's
   projections (K 1280 and 5120, N 1280 and 5120, padded by the engine),
   bitwise. Logged: params, init peak and peak GiB, tokens/s,
   decode-tick ms, prefill ms per position, the self-attention K/V dense
   against live pages and the cross K/V apart; one JSON line
   ``{"encdec": {...}}``.
14. The vmap dispatch, the vmapped slot loop and the compute dtypes,
   on OLMo-1B at its published width and depth with phase 4's weights
   (run right after phase 5, each path with the launch counts reset just
   before it). (a) ``torch.func.vmap`` of ``ops.dot`` and ``ops.asum``
   over [8, 2^24] float32 and of ``ops.matmul`` over 4 chunks [64, 2048]
   against one unbatched bf16 weight: exactly one B2, B4 and B6 launch,
   equal to the batched entry point and to a loop of single calls,
   bitwise. (b) Phase 4's trace with ``slot_loop="vmap"`` (dense, flash
   prefill, ``kahan_matmul``, telemetry): B5 7 * 16 times a chunk and a
   decode tick (one step for all running slots), B8 16 times a chunk, B4
   once a tick and finished prefill; tokens/s and host ms a tick beside
   phase 4's scan run of the same trace; the first tick's logits against
   the scan run's (relative L2 below 5e-2, the same argmax, in every
   running row); the telemetry and greedy tokens against scan's, logged;
   one 4-slot tick profiled vmapped and scanned (host ms, device busy);
   then ``0:16:12,0:16:2,0:16:12,3:256:2`` with one chunk a step, where
   a slot is PREFILLING between two running ones: every vmapped tick
   leaves the cache rows of the slots it does not run bitwise as they
   were. (c) ``0:64:8`` under ``Policy(compute_dtype="bfloat16")`` and
   again under "float64" (flash prefill, ``kahan_matmul``): every B5
   and B8 launch in that compute dtype, the counts as phase 4's; and
   phase 4's 2048-token ``TransformerLM.prefill`` under each (B7 16
   times, in that dtype; logits finite, logged beside float32's); one
   JSON line ``{"vmap": {...}}``.
15. The sharded steps and the dry run (``shard_path``).
16. The contract tooling's SASS level (``cost_path``): the cost auditor
   (``repro_torch.analysis.costmodel`` with ``register_sass``, what
   ``python -m repro_torch.analysis --cost --sass --strict`` runs) on the
   card's toolkit. ``csrc/cost_probe.cu`` (one kernel a built-in scheme x
   float32 / float64 / bfloat16 x dot / sum path, each applying the
   scheme's ``update<S>`` / ``mul_update<S>`` of ``schemes.cuh`` to one
   loaded element; built in phase 1's pool with the kernels' flags) is
   disassembled with ``cuobjdump``: one line a probe with its FADD /
   FMUL / FFMA (DADD / DMUL / DFMA) counts beside the scheme's declared
   mix and the ECM time of that mix over naive's on the H100 model (2^27
   elements, U = 8); then one census line of the shipping libraries
   (kahan_reduce, kahan_matmul, kahan_flash as phase 1 built them): no
   tensor-core opcode in B1-B6 and no FFMA in the B3/B4 sum
   instantiations. Any finding of the audit (the CPU cost cells
   included) fails the phase.
17. Every family's train step (``family_train_path``): qwen2.5-3b,
   internvl2-2b, deepseek-v2-lite-16b, hymba-1.5b, xlstm-1.3b and
   whisper-large-v3 at their published widths (random weights from seed
   0, the configs' dtypes), depth cut as ``FAMILY_CUTS`` says with every
   kind of block kept, through the port's ``make_train_step`` at phase
   6's batch (seq 256, global batch 8, 2 microbatches, warmup 1, lr
   ``TRAIN_LR``): run A (cuBLAS projections, the column-scan norm) and
   run B (``kahan_matmul``, B3 once a leaf) from the same weights and
   batches, each step 1, step 1 again from the same state (bitwise: every
   param and moment leaf, loss, grad norm) and step 2 under the profiler;
   deepseek-v2-lite's A and B in float32 compute, gated, and in its own
   bf16, logged. Checked: every loss and grad norm finite, run B's step-1
   loss and grad norm within phase 6's limits of run A's, each step's B5
   (``train_b5_per_step``), B3 and column-scan counts exact and nothing
   else launched, the peak below 80 GB. Before them B5's autograd
   backward at K or N padded by the engine (11008, 2816) bitwise against
   the plain version, and B5's training rows (``family_train_times``);
   after them one smoke step of every family under
   ``torch.use_deterministic_algorithms(True, warn_only=True)``, gated on
   no op without a deterministic CUDA path, and the crash-restart at
   deepseek-v2-lite's smoke config (``resume_check``). Logged per run
   with the card: wall ms a step after the first, device-busy ms of the
   profiled step, B5 ms, peak GiB; one JSON line ``{"family_train":
   {...}}``.

The last three lines are the card (``nvidia-smi`` name and power
limit), one JSON object ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``. The kernels line has one row per
kernel and path it runs on (``"path"``: "entry", "serve" for the scan
trace, "serve-flash" for the same trace under flash, "serve-matmul" for
it with ``kahan_matmul`` too, "serve-long" for the long request,
"train-a" and "train-b" for the two training runs, "sharded" for phase
8's sharded calls and "sharded-train" for its trainer, both rank 0's
counts, "serve-<arch>" for each of phase 9's configs,
"serve-qwen2.5-3b-matmul" for its ``kahan_matmul`` request and
"serve-deepseek-7b-paged" for the paged trace; phase 10's
"serve-deepseek-v2-lite" (and "-paged", "-matmul") and
"serve-llama4-maverick-2l"; phase 11's "serve-hymba-1.5b" (and
"-matmul", and "-prefill" for the ring check's float32 prefills, B7);
phase 12's "serve-xlstm-1.3b"; phase 13's "serve-whisper-large-v3" (and
"-paged", "-matmul"), "whisper-encode-matmul" (the encoder alone, B5)
and "whisper-prefill" (``EncDecLM.prefill``, B7); phase 14's "vmap-dot",
"vmap-asum" and "vmap-matmul" (timed at phase 3's batched shapes),
"serve-vmap" (B5 timed at M 4), "serve-bf16" / "serve-f64" (B4, B5
and B8 timed in that compute dtype, B5 at the decode q/k/v/o shape) and
"prefill-bf16" / "prefill-f64" (B7 at the entry shape in that dtype);
phase 17's "train-<arch>-a" / "-b" (and deepseek-v2-lite's
"train-deepseek-v2-lite-16b-bfloat16-a" / "-b"), each run's three steps:
its ``launches`` are
that path's count and its times were taken at that path's shape (B5 on "serve-matmul": the decode q/k/v/o
shape at M 1, the one launched most; on "train-b" the up projection's
forward at 1024 tokens; B3 on "train-b" the largest leaf; the column
scan on "train-a" and "sharded-train" the embedding's gradient; on
"sharded" one rank's block, requests or K-slice; B3 on "sharded-train"
the loss fold's one element a rank, padded to one block; on phase 9's
paths B4 at the config's [4, vocab] telemetry padded by the engine, B8
at its [H, 64, dh] chunk against its cache with its GQA groups, B5 on
"serve-qwen2.5-3b-matmul" phase 3's [1, 2048] x [2048, 2048] decode q/o
shape; on "serve-deepseek-v2-lite-matmul" the shared experts' decode
gate/up [1, 2048] x [2048, 2816], the projection launched most; on
"serve-hymba-1.5b-matmul" the decode q/o [1, 1600] x [1600, 1600], on
"serve-hymba-1.5b-prefill" B7 at [25, 1088, 64] over 5 KV heads; on
"serve-whisper-large-v3-matmul" the decode q/k/v/o [1, 1280] x [1280,
1280], on "whisper-encode-matmul" the encoder's q/k/v/o [1500, 1280] x
[1280, 1280], both padded by the engine to K 1536; on "whisper-prefill"
B7 at [20, 160, 64]; on phase 17's run B paths B5 at
``FAMILY_B5_ROW``'s padded shape of that config, B3 and the column scan
at phase 3's training rows).
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TRACE = "0:64:16,0:128:16,2:32:16,5:96:16"
LONG_TRACE = "0:1920:64"
PAPER_N = 1 << 27
PREFILL_LEN = 2048          # OLMo-1B's published context
LIBRARIES = ("kahan_reduce", "kahan_flash", "kahan_matmul")
#: seconds after which every thread's stack goes to standard error: a run
#: past its 1200 s limit then shows where it was
STACKS_AFTER_S = 1140
#: phase 16's probe source (built with the libraries, never launched)
COST_PROBE = "cost_probe"
#: dense projections per layer with kahan_matmul (q, k, v, o, gate, up,
#: down), each one B5 launch per prefill chunk and per decode position
PROJECTIONS = 7


#: phase 6: OLMo-1B trained at the reference launcher's defaults (seq
#: 256, global batch 8) in 2 microbatches, 4 steps, warmup 1
TRAIN_STEPS = 4
TRAIN_SEQ = 256
TRAIN_BATCH = 8
TRAIN_MICRO = 2
#: the learning rate of both runs. With warmup 1 the first update runs
#: at rate 0 (warmup_cosine(0, warmup=1) is 0) and the next three at the
#: full rate, cosine-decayed; the launcher's 3e-4 there makes the second
#: update, the first that moves, a step of about the rate on every weight
#: (Adam's first ratios are near +-1), and the loss jumps: in the JAX
#: reference too, which the port follows step for step at full width
#: (tests/test_torch_train.py::test_full_width_at_lr_3e4_follows_the_reference).
#: The launcher's own warmup of 20 steps runs steps 2-4 at 1.5e-5 to
#: 4.5e-5; this rate is of that order
TRAIN_LR = 1e-5
#: run B's (kahan_matmul) step-1 loss and grad norm against run A's, same
#: params and batch, relative: bf16 activations rounded from two float32
#: products (cuBLAS's and B5's) of 16 layers, and two compensated norms
#: (the tree norm and B3's fold). Measured on an H100 at 700 W: 1.29e-5
#: and 7.2e-5; the grad norm is where B5's backward (dA, dB) shows
STEP1_LOSS_RTOL = 1e-4
STEP1_GRAD_NORM_RTOL = 5e-4

#: phase 7: the sweep's parity length (the plain loop at U = 1 and the
#: paper's n would take minutes), a row's time "within" its time at the
#: largest U (the measured saturation U), the load-only bandwidth's length,
#: and the accuracy ladder at the largest power of two whose GenDot draws
#: take at most about 20 s on the host: 2^20 (2^21 takes about twice as
#: long). The ladder is the reference's conditions (tests/test_schemes.py,
#: 1e4 to 1e12) below two more, 1 and 10: GenDot's achieved condition
#: grows with n, and at 2^20 only these two stay below 1/eps (about 3e6
#: and 7e6; 1e4 achieves 2e9), where the orderings can be gated
SWEEP_PARITY_N = 1 << 22
SATURATED_WITHIN = 0.05
LOAD_ONLY_N = 1 << 28
LADDER_N = 1 << 20
LADDER_CONDS = (1e0, 1e1, 1e4, 1e6, 1e8, 1e10, 1e12)

#: phase 8: the sharded slice on two gloo ranks sharing the one card:
#: asum and dot at the paper's n (2^26 a rank), a matmul with K split 2,
#: the serving telemetry's shape (2 requests a rank), a [2048, 8192]
#: leaf through the compressed all-reduce, and OLMo-1B trained on the
#: mesh (phase 6's run A, DIST_TRAIN_STEPS steps, twice, cut to
#: DIST_LAYERS layers)
DIST_RANKS = 2
#: seconds the two ranks of phase 8 or of phase 15 have, together, to end
#: (they take under a minute on the H100)
RANKS_S = 240
DIST_N = 1 << 27
DIST_MATMUL = (1024, 2048, 8192)
DIST_ACT = (4, 57344)
DIST_LEAF = (2048, 8192)
#: one train step (two until PR 32: ROADMAP A5's first cut for the
#: script's time limit; the step's checks are the same for any count)
DIST_TRAIN_STEPS = 1
#: the layers of phase 8's OLMo-1B (of 16: the script's time limit; phase
#: 6 trains all 16 on one rank)
DIST_LAYERS = 2

#: phase 9: the dense family at published width and depth, the trace
#: each serves (a VLM's prompts are its patches plus SLICE_VLM_TEXT text
#: tokens), and the page size of the paged run
SLICE_ARCHS = ("deepseek-7b", "stablelm-3b", "qwen2.5-3b", "internvl2-2b")
SLICE_NEW = 8
SLICE_TRACE = f"0:48:{SLICE_NEW},1:96:{SLICE_NEW},2:160:{SLICE_NEW}"
#: phase 9's trace cut in depth for the families whose prefill resolves to
#: the scan body (hymba, xlstm: one position at a time on the host): the
#: third prompt still spans two 64-token chunks
SCAN_TRACE = f"0:16:{SLICE_NEW},1:32:{SLICE_NEW},2:80:{SLICE_NEW}"
SLICE_VLM_TEXT = 32
PAGE_SIZE = 16
#: phase 10: the MoE family. deepseek-v2-lite at its published width and
#: depth serves phase 9's trace; llama4-maverick at its published width
#: cut to one dense+MoE superblock (its 48 layers hold about 800 GB)
MOE_ARCH = "deepseek-v2-lite-16b"
LLAMA4 = "llama4-maverick-400b-a17b"
LLAMA4_LAYERS = 2
LLAMA4_TRACE = "0:32:4"
MOE_CHECK_CAPACITY = 16.0
#: deepseek-v2-lite's trace, paged and kahan_matmul runs and its prefill
#: and cuBLAS comparisons take its first MOE_CUT_LAYERS layers (the dense
#: prefix and 3 MoE layers): the script's time limit; its decode profile
#: keeps all 27
MOE_CUT_LAYERS = 4
#: the gate of a MoE config's prefill against its scan chunk, in float32
#: compute on the bf16 weights: the reference test's tolerance. In bf16
#: the two bodies' roundings send tokens to other experts (deepseek-v2-
#: lite: 9 of 160 in the first MoE layer, about 50 in the last; its 27
#: layers' logits part by 1.3e-1, relative L2), and so does kahan_matmul
#: against cuBLAS: bf16 is logged, float32 gated
MOE_PREFILL_REL = 2e-3
#: the B5 row of the kahan_matmul path: the shared experts' gate/up at a
#: decode position, the projection launched most (twice a MoE layer)
MOE_B5_ROW = "dsv2-decode-shared-gate-up"

#: phase 11: the hybrid family. hymba-1.5b at its published width and
#: depth serves SCAN_TRACE; its rings wrap in a whole-prompt prefill
#: of HYMBA_RING_PROMPT tokens (past the 1024-token window) and
#: HYMBA_RING_STEPS greedy decode steps after it, each step's logits held
#: to a prefill of the prompt and the tokens so far within relative L2
#: HYMBA_RING_REL (the reference test's tolerance) in float32 compute on
#: the bf16 weights
HYMBA = "hymba-1.5b"
HYMBA_RING_PROMPT = 1088
HYMBA_RING_STEPS = 8
HYMBA_RING_REL = 2e-3
#: the B5 row of hymba's kahan_matmul path: the decode q/o projection
HYMBA_B5_ROW = "hymba-decode-qo"

#: phase 12: the xLSTM family. xlstm-1.3b at its published width and
#: depth serves SCAN_TRACE; a whole-prompt prefill of
#: XLSTM_PROMPT tokens crosses the 512-token chunk and takes the pad path,
#: then XLSTM_STEPS greedy decode steps, each step's logits held to a
#: prefill of the prompt and the tokens so far within relative L2
#: XLSTM_REL (the reference test's tolerance) with the bf16 weights, the
#: compute and every float32 cast of the model in float64. At this width
#: and depth with random weights each mLSTM block amplifies a
#: perturbation of its input, and float32 rounding alone parts the two
#: bodies by about 0.2 (``scripts/xlstm_conditioning.py``): only float64
#: separates a fault from rounding
XLSTM = "xlstm-1.3b"
XLSTM_PROMPT = 640
XLSTM_STEPS = 4            # 8 until PR 32 (the script's time limit)
XLSTM_REL = 2e-3
#: phase 13: the encoder-decoder family. whisper-large-v3 at its
#: published width and depth serves phase 9's trace with each request's
#: frames; its whole-prompt prefill (B7) is held to the chunked path over
#: the same ``prefill_begin`` within phase 4's relative L2
WHISPER = "whisper-large-v3"
WHISPER_REL = 5e-2
#: the B5 rows of whisper: the encoder's q/k/v/o at M 1500 and a decode
#: position's, the projections launched most; the B7 row of its prefill
WHISPER_ENCODE_ROW = "whisper-encode-qkvo"
WHISPER_DECODE_ROW = "whisper-decode-qkvo"
WHISPER_PREFILL_ROW = "whisper-prefill"

#: the schemes with a device function, and the reduction wrappers
#: phase 14: ``torch.func.vmap`` of the entry points over 8 rows of 2^24
#: (phase 3's batched shape), a trace that keeps slot 1 PREFILLING (one
#: chunk a step) between two running slots, and the short request served
#: in bfloat16 and float64 compute
VMAP_ROWS, VMAP_N = 8, 1 << 24
VMAP_PREFILL_TRACE = "0:16:12,0:16:2,0:16:12,3:256:2"
DTYPE_TRACE = "0:64:8"

#: phase 15: the sharded steps that ``launch.specs.build_cell`` and the
#: sharding rules make, on two gloo ranks sharing the one card. OLMo-1B
#: at its published width, cut to SHARD_LAYERS of its 16 layers (the
#: script's time limit; phases 4-7 keep the full depth): a train step on
#: a (data 2, model 1) mesh over a global batch of SHARD_TRAIN (batch,
#: tokens), and a prefill of SHARD_PROMPT then SHARD_DECODE decode steps
#: on a (data 1, model 2) mesh against a cache of SHARD_MAX_LEN positions
#: sharded on them. Then the dry run of SHARD_DRYRUN's cells (arch,
#: shape, both meshes), a subprocess a row, started beside the build and
#: limited to SHARD_DRYRUN_S seconds from the start
SHARD_LAYERS = 2
SHARD_TRAIN = (4, 512)
SHARD_PROMPT = (2, 512)
SHARD_DECODE = 4
SHARD_MAX_LEN = 1024
SHARD_DRYRUN = (("xlstm-1.3b", "decode_32k", True),
                ("olmo-1b", "train_4k", False))
SHARD_DRYRUN_S = 300
#: the serving logits' limit against the unsharded steps (float32
#: compute: PERF.md §2's)
SHARD_SERVE_RTOL = 2e-3

SCHEMES = ("naive", "kahan", "pairwise", "dot2")
REDUCTIONS = ("dot_accumulators", "dot_accumulators_batched",
              "sum_accumulators", "sum_accumulators_batched")

#: device ms of the reduction rows (phase 3, graph-timed) for the kernel
#: before its load ring (one 128-thread CTA a row of cells, 8 steps of
#: loads drained before each chain burst), keyed (wrapper, scheme or
#: label), taken by this script's phase 3 on an NVIDIA H100 80GB HBM3 at
#: 700 W; logged beside each new time
REDUCE_BEFORE_MS = {
    ("dot_accumulators", "naive"): 1.4104,
    ("dot_accumulators", "kahan"): 1.4400,
    ("dot_accumulators", "pairwise"): 1.3799,
    ("dot_accumulators", "dot2"): 1.9964,
    ("sum_accumulators", "naive"): 0.5636,
    ("sum_accumulators", "kahan"): 0.6671,
    ("sum_accumulators", "pairwise"): 0.5691,
    ("sum_accumulators", "dot2"): 1.0572,
    ("dot_accumulators_batched", "kahan"): 0.3664,
    ("sum_accumulators_batched", "kahan"): 0.1794,
    ("sum_accumulators_batched", "serve"): 0.0022,
}

#: device ms of the flash rows (B7 entry, B8 serve, B8 serve-long) for
#: the kernel before its register-tiled redesign (16 query rows a CTA,
#: scalar synchronous staging), taken by this script's graph timing on an
#: NVIDIA H100 80GB HBM3 at 700 W; logged beside each new time
FLASH_BEFORE_MS = {"entry": 7.2962, "serve": 0.0952, "serve-long": 0.8863,
                   # bfloat16 and float64 in the 16-row tile
                   "entry-bf16": 10.6330, "serve-bf16": 0.0448,
                   "entry-f64": 10.7227, "serve-f64": 0.0481}

#: device ms of the bfloat16 and float64 matmul rows (phase 3) for the
#: kernel before its redesign (bfloat16 computed on 16-bit registers,
#: widened at every op; float64 in 32-row tiles staged through registers),
#: taken by this script's graph timing on an NVIDIA H100 80GB HBM3 at
#: 700 W; logged beside each new time
MATMUL_BEFORE_MS = {"decode-qkvo-bf16": 0.0161, "chunk-gate-up-bf16": 0.5654,
                    "batched-bf16": 0.5655, "decode-qkvo-f64": 0.0301,
                    "chunk-gate-up-f64": 0.4215}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


#: when the script started (``stamp`` counts from here)
STARTED = time.perf_counter()


def stamp(what: str) -> None:
    """One line on standard error: the seconds since the start and the
    step about to run, so that a run stopped at its limit shows how far it
    got."""
    print(f"# chip_smoke at {time.perf_counter() - STARTED:.1f} s: {what}",
          file=sys.stderr, flush=True)


class Steps:
    """Runs the script's steps in order, each stamped and timed;
    ``seconds`` maps each step to its time."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, what: str, fn, *args):
        stamp(what)
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[what] = round(time.perf_counter() - t0, 1)
        return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card and the build ------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    log(f"# card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False)
    dryrun = DryRun()
    try:
        run_all(torch, card, dryrun)
    finally:
        dryrun.stop()
        faulthandler.cancel_dump_traceback_later()
    return 0


def run_all(torch, card: str, dryrun) -> None:
    """Phases 1-17 and the closing lines (``main``)."""
    with ThreadPoolExecutor(len(LIBRARIES) + 1) as pool:
        run_phases(torch, card, dryrun, pool)


def run_phases(torch, card: str, dryrun, pool) -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    sources = LIBRARIES + (COST_PROBE,)

    def build(name):
        _build.build(name)
        return f"{name}.cu {time.perf_counter() - t0:.1f} s"

    built = {name: pool.submit(build, name) for name in sources}

    def ready(name):
        """Waits for ``name``'s build, loads it, logs its time."""
        done = built[name].result()
        if name in LIBRARIES:
            _build.library(name)
        log(f"# phase 1: built {done} after the build started (one nvcc a "
            f"source, all started together, beside the dry run of phase "
            f"15(c); each waited for where it is first needed)")

    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    cfg = get_config("olmo-1b")
    kernels = Kernels(torch, dev)
    run = Steps()
    run("phase 1 kahan_reduce.cu", ready, "kahan_reduce")
    run("phase 2 parity", kernels.parity)
    run("phase 1 kahan_flash.cu", ready, "kahan_flash")
    run("phase 2 flash parity", kernels.flash_parity, cfg.head_dim)
    run("phase 3 times", kernels.times, PAPER_N)
    run("phase 3 flash times", kernels.flash_times, cfg, PREFILL_LEN,
        serve_max_len(TRACE), serve_max_len(LONG_TRACE))
    run("phase 1 kahan_matmul.cu", ready, "kahan_matmul")
    run("phase 2 matmul parity", kernels.matmul_parity)
    run("phase 2 slice parity", kernels.slice_parity,
        [get_config(name) for name in SLICE_ARCHS])
    run("phase 2 moe parity", kernels.moe_parity,
        [get_config(MOE_ARCH), get_config(LLAMA4)])
    run("phase 2 hybrid parity", kernels.hybrid_parity, get_config(HYMBA))
    run("phase 2 family parity", kernels.family_parity, get_config(XLSTM),
        get_config(WHISPER))
    run("phase 3 matmul times", kernels.matmul_times, cfg, PREFILL_LEN)
    run("phase 2 dtype parity", kernels.dtype_parity, cfg)
    run("phase 3 dtype times", kernels.dtype_times, cfg, PREFILL_LEN,
        serve_max_len(DTYPE_TRACE))
    run("phase 2 column parity", kernels.column_parity)
    run("phase 2 subnormal parity", kernels.subnormal_parity)
    run("phase 3 train times", kernels.train_times, cfg,
        TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ)
    serve_stats = run("phases 4-5", main_path, torch, kernels, cfg, PAPER_N)
    log(json.dumps({"serve": serve_stats}))
    log(json.dumps({"vmap": run("phase 14", vmap_path, torch, kernels,
                                cfg)}))
    train_stats = run("phase 6", train_path, torch, kernels, cfg)
    train_stats["b5_rows_per_step"] = kernels.train_b5
    log(json.dumps({"train": train_stats}))
    log(json.dumps(run("phase 7", paper_path, torch, kernels, card)))
    log(json.dumps({"dist": run("phase 8", dist_path, torch, kernels,
                                dist_spec(cfg))}))
    log(json.dumps({"slice": run("phase 9", slice_path, torch, kernels)}))
    log(json.dumps({"moe": run("phase 10", moe_path, torch, kernels)}))
    log(json.dumps({"hybrid": run("phase 11", hybrid_path, torch,
                                  kernels)}))
    log(json.dumps({"xlstm": run("phase 12", xlstm_path, torch, kernels)}))
    log(json.dumps({"encdec": run("phase 13", whisper_path, torch,
                                  kernels)}))
    log(json.dumps({"sharded": run("phase 15", shard_path, torch, kernels,
                                   shard_spec(cfg), dryrun)}))
    run("phase 1 cost_probe.cu", ready, COST_PROBE)
    log(json.dumps({"cost": run("phase 16", cost_path)}))
    log(json.dumps({"family_train": run("phase 17", family_train_path, torch,
                                        kernels, card)}))
    log(f"# chip_smoke steps, seconds each: {json.dumps(run.seconds)}")
    log(f"# chip_smoke took {time.perf_counter() - STARTED:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels.rows()}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def serve_max_len(trace: str) -> int:
    """The per-slot cache length a trace is served with (prompt + new
    tokens of its longest request), as the launcher fits it."""
    from repro_torch.launch.serve import parse_trace

    return max(p + n for _, p, n, _ in parse_trace(trace, 0.0))


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events,
    after warm-up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, launches: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of ``fn()``: ``launches`` calls captured
    in one CUDA graph (after warm-up), replayed ``replays`` times between
    CUDA events. For kernels shorter than their wrapper's enqueue on the
    host, where back-to-back calls would time the host."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def clock_under_load(torch, fn, launches: int = 20, replays: int = 300):
    """The card's SM clock (MHz) and power draw (W), as ``nvidia-smi``
    reads them while ``replays`` replays of ``launches`` captured calls of
    ``fn()`` run (enqueued first, so the sample falls inside them)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    for _ in range(replays):
        graph.replay()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    torch.cuda.synchronize()
    mhz, watts = (float(v) for v in out.split(","))
    return mhz, watts


#: the H100 SXM's peak rate (TFLOP/s) for operations of each compute
#: dtype other than float32 (whose 67 the machine model holds), dense, at
#: 700 W: bfloat16 on the tensor cores, 989 (NVIDIA's H100
#: data sheet); float64 on the FP64 tensor cores, 67 (NVIDIA's H100 data
#: sheet); and float64 outside them, 34 (the same sheet), the rate of the
#: CUDA cores that run the float64 chains
PEAK_TFLOPS = {"bfloat16": 989.0, "float64": 67.0}
F64_CORE_TFLOPS = 34.0


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def bound_ms(n_bytes: float, n_ops: float, dtype=None):
    """(least time in ms, what bounds it) for ``n_bytes`` moved once and
    ``n_ops`` operations of ``dtype`` (float32 by default) on the H100:
    its published HBM rate and the peak for the operations' type
    (``PEAK_TFLOPS``; float32's as the machine model,
    ``repro_torch.core.ecm.H100``, holds it)."""
    from repro_torch.core.ecm import H100

    rate = PEAK_TFLOPS.get(dtype_name(dtype), H100.fp32_tflops)
    bytes_ms = n_bytes / (H100.hbm_gbs * 1e6)
    ops_ms = n_ops / (rate * 1e9)
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def flash_flops(bh: int, sq: int, skv: int, dh: int, q_off: int) -> int:
    """The FLOPs causal flash attention needs: a multiply and an add for
    each term of q k^T and of p v, over the (query, key) pairs the mask
    keeps. Row i of a chunk at ``q_off`` sees min(q_off + i + 1, skv)
    keys; padded rows and keys count nothing."""
    pairs = sum(min(q_off + i + 1, skv) for i in range(sq))
    return 4 * bh * pairs * dh


def fma_ceiling_ms(flops: float, dtype=None) -> float:
    """``flops`` at half the CUDA cores' fma rate: the mul+add ceiling of
    a chain that may not fuse its products (no fma, no tensor cores). A
    float32 or bfloat16 chain (bfloat16 ops are float32 ops, rounded) at
    half the float32 peak, a float64 one at half ``F64_CORE_TFLOPS``."""
    from repro_torch.core.ecm import H100

    rate = F64_CORE_TFLOPS if dtype_name(dtype) == "float64" else \
        H100.fp32_tflops
    return flops / (rate / 2 * 1e9)


class Kernels:
    """Phases 2 and 3, and the JSON rows of the six wrappers."""

    def __init__(self, torch, dev):
        from repro_torch.kernels import (engine, flash_attention, kahan_dot,
                                         kahan_matmul, kahan_sum, schemes)

        self.torch = torch
        self.dev = dev
        self.engine, self.kd, self.ks, self.schemes = (engine, kahan_dot,
                                                       kahan_sum, schemes)
        self.fa = flash_attention
        self.km = kahan_matmul
        self.gen = torch.Generator(device=dev).manual_seed(0)
        self.err = {name: 0.0 for name in engine.WRAPPERS}
        self.timing = {}
        #: (wrapper, path) -> the timing label of that path's shape, for
        #: the paths of phase 9
        self.path_labels = {}

    def data(self, shape, dtype):
        torch = self.torch
        x = torch.randn(shape, generator=self.gen, device=self.dev,
                        dtype=torch.float64)
        e = torch.randint(-8, 8, shape, generator=self.gen, device=self.dev)
        return (x * torch.exp2(e.double())).to(dtype)

    def normal(self, shape):
        return self.torch.randn(shape, generator=self.gen, device=self.dev)

    def compare(self, name, got, want, what):
        torch = self.torch
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"{name} {what}: kernel != plain")
            d = (g.double() - w.double()).abs().max().item()
            self.err[name] = max(self.err[name], d)

    # -- 2. parity ------------------------------------------------------------
    def parity(self):
        """The four reduction wrappers against their plain versions,
        bitwise, for every built-in scheme x U in {1, 8} x {float32,
        float64, bfloat16}: [3, n] for n in 1, 8192 + 5, 3 * 8192 + 37, 5 *
        8192 (padded by the engine) and n spanning two full load rings of
        the one-row plan and a partial stage; at U = 8 also batch 8 over
        two of its rings and the serving shape [4, 57344] (7 steps, one
        partial stage); the deep [3, n] case again on operands one element
        off 16 bytes (views of a larger buffer: the element-copy path). Every
        row of a batched launch equals a single launch of that row, which
        is the batch-1 case."""
        torch = self.torch
        kd, ks = self.kd, self.ks
        seen = {name: set() for name in REDUCTIONS}
        cases = 0
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            for name in SCHEMES:
                sch = self.schemes.get(name)
                for unroll in (1, 8):
                    eng = self.engine.CompensatedReduction(
                        scheme=sch, unroll=unroll, compute_dtype=dtype)
                    cells = 1024 * unroll
                    deep = self.ring_n(1, cells, dtype)
                    shapes = [(3, n) for n in (1, 8192 + 5, 3 * 8192 + 37,
                                               5 * 8192, deep)]
                    if unroll == 8:
                        shapes += [(8, self.ring_n(8, cells, dtype)),
                                   (4, 57344)]
                    for batch, n in shapes:
                        what = f"{name} U={unroll} {dtype} [{batch}, {n}]"
                        a = self.data((batch, n), dtype)
                        b = self.data((batch, n), dtype)
                        ap, bp = eng._prep2d(a), eng._prep2d(b)
                        kw = dict(scheme=sch, unroll=unroll)
                        plain = (kd.dot_plain(ap, bp, **kw),
                                 ks.sum_plain(ap, **kw))
                        self.reduction_case(ap, bp, plain, kw, what, seen)
                        cases += 1
                        if n == deep:
                            self.reduction_case(
                                self.off16(ap), self.off16(bp), plain, kw,
                                f"{what}, one element off 16 bytes", seen)
                            cases += 1
        sync(torch, self.dev)
        for wrapper, runs in seen.items():
            paths = {copy for _, copy, _ in runs}
            check(paths == {"cp.async", "element"},
                  f"{wrapper}: the cp.async and the element-copy paths did "
                  f"not both run ({sorted(paths)})")
            check(any(rings for _, _, rings in runs),
                  f"{wrapper}: no case spanned two full rings and a partial "
                  f"stage")
        plans = sorted({plan for runs in seen.values()
                        for plan, _, _ in runs})
        log(f"# phase 2: {cases} reduction parity cases x 4 wrappers bitwise "
            f"equal to their plain versions; batched == loop of single "
            f"launches; 16-byte and element copies both ran in every "
            f"wrapper, and each spanned two full rings and a partial stage; "
            f"{len(plans)} plans (chains, depth, stages, shared bytes): "
            f"{plans}")

    def ring_n(self, batch, cells, dtype):
        """A row length spanning two full load rings and a partial stage of
        the sum kernel's plan for ``batch`` rows (the dot's ring holds no
        more steps)."""
        itemsize = self.torch.empty((), dtype=dtype).element_size()
        sms = (self.torch.cuda.get_device_properties(
            self.dev).multi_processor_count if self.dev.type == "cuda"
            else 132)
        _, depth, stages, _ = self.kd.reduce_plan(batch, cells, 1 << 30,
                                                  itemsize, 1, sms)
        return (2 * stages * depth + 3) * cells

    def off16(self, x):
        """A copy of ``x`` as a view one element into a larger buffer: the
        same values, not 16-byte aligned."""
        buf = self.torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view

    def reduction_case(self, ap, bp, plain, kw, what, seen):
        """Single launches of every row and one batched launch of the dot
        and the sum against ``plain`` (the plain versions' grids), and
        batched == the loop; notes each launch's plan, copy path and
        whether it spanned two full rings and a partial stage."""
        torch = self.torch
        kd, ks = self.kd, self.ks
        batch, n = ap.shape
        steps = n // (1024 * kw["unroll"])
        kernels = (
            ("dot_accumulators", "dot_accumulators_batched",
             lambda i: kd.dot_accumulators(ap[i], bp[i], **kw),
             lambda: kd.dot_accumulators_batched(ap, bp, **kw), plain[0]),
            ("sum_accumulators", "sum_accumulators_batched",
             lambda i: ks.sum_accumulators(ap[i], **kw),
             lambda: ks.sum_accumulators_batched(ap, **kw), plain[1]))
        for one, many, single_fn, batched_fn, want in kernels:
            single = []
            for i in range(batch):
                single.append(single_fn(i))
                self.note_plan(one, steps, seen)
                self.compare(one, single[i], (want[0][i], want[1][i]), what)
            batched = batched_fn()
            self.note_plan(many, steps, seen)
            self.compare(many, batched, want, what)
            check(all(torch.equal(batched[0][i], single[i][0])
                      and torch.equal(batched[1][i], single[i][1])
                      for i in range(batch)),
                  f"batched {one} != loop of single launches ({what})")

    def note_plan(self, name, steps, seen):
        fn = self.engine.WRAPPERS[name]
        _, depth, stages, _ = fn.plan
        rings = steps > 2 * stages * depth and steps % depth != 0
        seen[name].add((fn.plan, fn.copy, rings))

    def flash_parity(self, dh: int,
                     heads=((4, 1), (4, 2), (48, 1), (48, 2)), dtype=None):
        """B7 and B8 against their plain version, bitwise: Sq = 300 and
        Skv = 600 (blocks 256: Sq padded to 512, Skv to 768 = 3 k-blocks,
        60 padded keys masked), every built-in scheme, at each (BH,
        q_groups) of ``heads``: by default q_groups 1 and 2 at BH 4 (B7 in
        16-row tiles) and BH 48 (B7 in 64-row tiles, B8's 64-row chunks in
        16-row tiles: rows equal across tile heights). ``dtype``: the
        compute dtype (float32 by default; bfloat16's tall tile is 64
        rows too, float64's 32). At least one case must run B7 in the
        dtype's tall tile beside B8 in 16-row tiles: in float32 always,
        in the others where ``heads`` reaches BH 48."""
        torch, fa = self.torch, self.fa
        dtype = dtype or torch.float32
        sq, skv, bk = 300, 600, 256
        cases = 0
        plans = set()
        for bh, groups in heads:
            eng = self.engine.CompensatedReduction(scheme="kahan",
                                                   compute_dtype=dtype)
            q, k, v, bq, bk, _, _ = eng._flash_prep(
                "flash_parity", self.normal((bh, sq, dh)),
                self.normal((bh // groups, skv, dh)),
                self.normal((bh // groups, skv, dh)), 256, bk, groups)
            for name in ("naive", "kahan", "pairwise", "dot2"):
                sch = self.schemes.get(name)
                kw = dict(block_q=bq, block_k=bk, scheme=sch, kv_len=skv,
                          q_groups=groups)
                for causal in (True, False):
                    what = f"{name} causal={causal} G={groups}"
                    got = fa.flash_accumulators(q, k, v, causal=causal, **kw)
                    want = fa.flash_plain(q, k, v, scheme=sch, block_k=bk,
                                          kv_len=skv, causal=causal,
                                          q_groups=groups)
                    self.compare("flash_accumulators", got, want, what)
                    cases += 1
                full = fa.flash_accumulators(q, k, v, causal=True, **kw)
                full_rows = fa.flash_accumulators.plan[0]
                for off in (0, 64, 256):
                    w = 64
                    qc = q[:, off:off + w].contiguous()
                    kwc = dict(kw, block_q=w)
                    got = fa.flash_chunk_accumulators(qc, k, v, off, **kwc)
                    want = fa.flash_plain(qc, k, v, scheme=sch, block_k=bk,
                                          kv_len=skv, causal=True, q_off=off,
                                          q_groups=groups)
                    self.compare("flash_chunk_accumulators", got, want,
                                 f"{name} G={groups} q_off={off}")
                    check(all(torch.equal(g, f[:, off:off + w])
                              for g, f in zip(got, full)),
                          f"B8 rows at q_off={off} != B7 rows ({name}, "
                          f"G={groups})")
                    plans.add((bh, full_rows,
                               fa.flash_chunk_accumulators.plan[0]))
                    cases += 1
        sync(torch, self.dev)
        tall = fa.TILE_ROWS[torch.empty((), dtype=dtype).element_size()][0]
        check((dtype != torch.float32 and max(bh for bh, _ in heads) < 48)
              or any(r7 == tall and r8 == 16 for _, r7, r8 in plans),
              f"no parity case ran B7 in {tall}-row tiles beside B8 in "
              f"16-row tiles: (BH, B7 rows, B8 rows) {sorted(plans)}")
        log(f"# phase 2: {cases} {dtype} flash parity cases (dh={dh}, Sq={sq}, "
            f"Skv={skv}, block_k={bk}, (BH, G) {list(heads)}) bitwise equal "
            f"to the plain version; B8 rows at aligned offsets == B7 rows, "
            f"bitwise ((BH, B7 tile rows, B8 tile rows): {sorted(plans)})")

    # -- 3. times -------------------------------------------------------------
    def time_one(self, name, scheme, args, plain_fn, library_fn, reps=20,
                 label=None, valid=None):
        """Kernel / plain / library times of one wrapper on padded
        float32 inputs, plus the kernel-vs-plain check at this shape. The
        kernel and library times are device times of launches captured in
        a CUDA graph; back-to-back launches timed with events beside
        them. ``valid``: the function's own input shape where the engine
        zero-pads it (the telemetry's [4, vocab]); the bound counts it,
        not the padding."""
        torch = self.torch
        sch = self.schemes.get(scheme)
        wrapper = self.engine.WRAPPERS[name]
        kernel = lambda: wrapper(*args, scheme=sch, unroll=8)  # noqa: E731
        got = kernel()
        sync(torch, self.dev)
        t0 = time.perf_counter()
        want = plain_fn(sch)
        sync(torch, self.dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        self.compare(name, got, want, f"{scheme} at {tuple(args[0].shape)}")
        grid_bytes = 2 * got[0].numel() * got[0].element_size()
        del got, want
        ms = graph_ms(torch, kernel, reps)
        events_ms = cuda_ms(torch, kernel, reps)
        library_ms = graph_ms(torch, library_fn, reps)
        n_elem = math.prod(valid) if valid else args[0].numel()
        in_bytes = len(args) * n_elem * args[0].element_size()
        mix = sch.instruction_mix
        ops = n_elem * (mix.flops if name.startswith("dot") else mix.adds)
        least, by = bound_ms(in_bytes + grid_bytes, ops, args[0].dtype)
        key = (name, label or scheme)
        before = REDUCE_BEFORE_MS.get(key)
        row = {"ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": least, "bound_by": by,
               "bound_share": least / ms, "before_ms": before,
               "plan": getattr(wrapper, "plan", None),
               "copy": getattr(wrapper, "copy", None),
               "shape": list(args[0].shape), "scheme": scheme,
               "dtype": dtype_name(args[0].dtype),
               "gbytes_per_s": (in_bytes + grid_bytes) / ms / 1e6}
        self.timing[key] = row
        was = f"; before the ring {before:.4f}" if before else ""
        log(f"# {name} {label or scheme} {row['shape']}: kernel {ms:.4f} ms "
            f"device ({events_ms:.4f} back to back{was}; "
            f"{row['gbytes_per_s']:.0f} GB/s), {by} bound {least:.4f} ms "
            f"({100 * least / ms:.1f}%), plan {row['plan']} "
            f"{row['copy']}, plain "
            f"{plain_ms:.1f} ms, library {library_ms:.4f} ms "
            f"(events {cuda_ms(torch, library_fn, reps):.4f})")

    def times(self, paper_n):
        """Dot and sum at ``paper_n`` for every scheme, with the kahan /
        naive ratio (the paper's metric); the batched wrappers at [8,
        paper_n / 8]; the serving telemetry's launch."""
        torch = self.torch
        kd, ks = self.kd, self.ks
        f32 = torch.float32
        a = self.data((paper_n,), f32)
        b = self.data((paper_n,), f32)
        for scheme in SCHEMES:
            self.time_one(
                "dot_accumulators", scheme, (a, b),
                lambda s: [t[0] for t in kd.dot_plain(a[None], b[None],
                                                       scheme=s)],
                lambda: torch.dot(a, b))
            self.time_one(
                "sum_accumulators", scheme, (a,),
                lambda s: [t[0] for t in ks.sum_plain(a[None], scheme=s)],
                lambda: torch.sum(a))
        # the chain floor depends on the clock: sample it under the sum
        sch = self.schemes.get("kahan")
        mhz, watts = clock_under_load(
            torch, lambda: ks.sum_accumulators(a, scheme=sch))
        self.reduce_clock = {"sm_mhz": mhz, "power_w": watts}
        steps = paper_n // 8192
        for name in ("dot_accumulators", "sum_accumulators"):
            ms = {sch: self.timing[(name, sch)]["ms"] for sch in SCHEMES}
            log(f"# {name} [{paper_n}] over naive: "
                + ", ".join(f"{sch} {ms[sch] / ms['naive']:.3f}"
                            for sch in SCHEMES)
                + "; cycles a chain step at the sampled clock: "
                + ", ".join(f"{sch} {ms[sch] * mhz * 1e3 / steps:.1f}"
                            for sch in SCHEMES))
        log(f"# reductions: SM clock {mhz:.0f} MHz, {watts:.1f} W under the "
            f"kahan sum at [{paper_n}]")
        a2, b2 = a.view(8, -1), b.view(8, -1)
        self.time_one("dot_accumulators_batched", "kahan", (a2, b2),
                      lambda s: kd.dot_plain(a2, b2, scheme=s),
                      lambda: torch.linalg.vecdot(a2, b2))
        self.time_one("sum_accumulators_batched", "kahan", (a2,),
                      lambda s: ks.sum_plain(a2, scheme=s),
                      lambda: torch.sum(a2, dim=1))
        # the serving telemetry's launch: [max_slots, 50304] squared logits,
        # padded to 7 * 8192
        x = self.data((4, 57344), f32)
        self.time_one("sum_accumulators_batched", "kahan", (x,),
                      lambda s: ks.sum_plain(x, scheme=s),
                      lambda: torch.sum(x, dim=1), reps=200, label="serve",
                      valid=(4, 50304))
        del a, b, a2, b2

    def time_flash(self, name, label, q, k, v, q_off, reps, groups=1,
                   dtype=None):
        """One flash wrapper (scheme kahan) at the engine's padded shapes
        for q [BH, Sq, dh] and the cache k/v [BH / groups, Skv, dh] (GQA
        through the kernel's ``bh // G`` row) in the compute ``dtype``
        (float32 by default): kernel, plain and library
        (``scaled_dot_product_attention`` in that dtype, the same causal
        mask on absolute positions, on k/v repeated to BH rows beforehand)
        times, and the parity check."""
        torch, fa = self.torch, self.fa
        F = torch.nn.functional
        dtype = dtype or torch.float32
        q, k, v = (x.to(dtype) for x in (q, k, v))
        sch = self.schemes.get("kahan")
        bh, sq, dh = q.shape
        skv = k.shape[1]
        eng = self.engine.CompensatedReduction(scheme=sch,
                                               compute_dtype=dtype)
        qp, kp, vp, bq, bk, _, _ = eng._flash_prep(name, q, k, v, 256, 256,
                                                   groups)
        kw = dict(block_q=bq, block_k=bk, scheme=sch, kv_len=skv,
                  q_groups=groups)
        if name == "flash_accumulators":
            kernel = lambda: fa.flash_accumulators(  # noqa: E731
                qp, kp, vp, causal=True, **kw)
        else:
            kernel = lambda: fa.flash_chunk_accumulators(  # noqa: E731
                qp, kp, vp, q_off, **kw)
        got = kernel()
        sync(torch, self.dev)
        t0 = time.perf_counter()
        want = fa.flash_plain(qp, kp, vp, scheme=sch, block_k=bk, kv_len=skv,
                              causal=True, q_off=q_off, q_groups=groups)
        sync(torch, self.dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        self.compare(name, got, want, f"kahan at {label} {tuple(q.shape)} "
                     f"G={groups}")
        del got, want
        # device time (launches captured in a CUDA graph: a 64-row B8
        # launch is about as short as its wrapper's host enqueue) and,
        # beside it, back-to-back launches timed with events
        ms = graph_ms(torch, kernel, reps)
        events_ms = cuda_ms(torch, kernel, reps)
        mask = ((q_off + torch.arange(sq, device=self.dev))[:, None]
                >= torch.arange(skv, device=self.dev)[None, :])
        kr, vr = (x.repeat_interleave(groups, dim=0) for x in (k, v))
        library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q[None], kr[None], vr[None], attn_mask=mask), reps)
        del kr, vr
        flops = flash_flops(bh, sq, skv, dh, q_off)
        # q, k, v read once and (l_s, l_c, a_s, a_c) written once, unpadded
        n_bytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                      + 2 * (bh * sq + q.numel()))
        least, by = bound_ms(n_bytes, flops, dtype)
        # the fixed chains' own ceiling: a separate rounded multiply and
        # add per term, at half the fma rate
        ceiling = fma_ceiling_ms(flops, dtype)
        rows, smem = getattr(fa, name).plan
        row = {"ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": least, "bound_by": by,
               "mul_add_ceiling_ms": ceiling, "ceiling_share": ceiling / ms,
               "tile_rows": rows, "ring_stages": fa.RING_STAGES,
               "smem_bytes": smem,
               "before_ms": FLASH_BEFORE_MS.get(label),
               "shape": [bh, sq, dh], "skv": skv, "q_groups": groups,
               "scheme": "kahan", "dtype": dtype_name(dtype),
               "tflops": flops / ms / 1e9}
        self.timing[(name, label)] = row
        before = FLASH_BEFORE_MS.get(label)
        was = (f"; 16-row kernel before the redesign {before:.4f}" if before
               else "")
        log(f"# {name} {label} q {[bh, sq, dh]} kv {skv} G={groups} "
            f"{dtype_name(dtype)}: kernel "
            f"{ms:.4f} ms device ({events_ms:.4f} back to back; "
            f"{row['tflops']:.2f} TFLOP/s{was}), {by} bound "
            f"{least:.4f} ms, "
            f"mul+add ceiling {ceiling:.4f} ms ({100 * ceiling / ms:.1f}%), "
            f"tile {rows} rows, {fa.RING_STAGES}-stage ring, {smem} B "
            f"shared, plain {plain_ms:.1f} ms, library (sdpa "
            f"{dtype_name(dtype)}) {library_ms:.4f} ms")

    def flash_times(self, cfg, prefill_len, serve_len, long_len):
        """B7 at the entry path's shape (every head of a 2048-token
        prefill), B8 at the serving chunk against each serve run's
        cache."""
        h, dh = cfg.n_heads, cfg.head_dim
        self.time_flash("flash_accumulators", "entry",
                        self.normal((h, prefill_len, dh)),
                        self.normal((h, prefill_len, dh)),
                        self.normal((h, prefill_len, dh)), 0, reps=10)
        for label, length in (("serve", serve_len), ("serve-long", long_len)):
            # the last full chunk of a prompt that fills the cache
            off = (length - 64) // 64 * 64
            self.time_flash("flash_chunk_accumulators", label,
                            self.normal((h, 64, dh)),
                            self.normal((h, length, dh)),
                            self.normal((h, length, dh)), off, reps=50)

    # -- the dense family's shapes (phases 2 and 9) ---------------------------
    def slice_parity(self, cfgs):
        """Phase 2 at the shapes phase 9 gives the kernels, before it runs
        them: B1-B4 on the telemetry's [4, vocab] rows of each config
        (padded by the engine to 8 U 128), every scheme at U = 8; B7 and
        B8 at stablelm-3b's head dim 80 (G 1, BH 4, 32 and 48) and at
        qwen2.5-3b's GQA G 8 (dh 128, BH 16 and 48); B5 on bf16 operands
        the engine pads, K 11008 (the down projection of deepseek-7b and
        qwen2.5-3b) and 6912 (stablelm-3b's) at M 1 and 64, and qwen's k/v
        N 256: every scheme at M 1, kahan at M 64."""
        torch = self.torch
        cases = sum(self.vocab_parity(cfg) for cfg in cfgs)
        log(f"# phase 2: {cases} reduction parity cases at the telemetry's "
            f"[4, vocab] of {[c.name for c in cfgs]} bitwise equal to the "
            f"plain versions")
        self.flash_parity(80, heads=((4, 1), (32, 1), (48, 1)))
        self.flash_parity(128, heads=((16, 8), (48, 8)))
        cases = 0
        for m, k, n in ((1, 11008, 4096), (64, 11008, 2048),
                        (1, 6912, 2560), (64, 6912, 2560), (1, 2048, 256),
                        (64, 2048, 256)):
            for name in SCHEMES if m == 1 else ("kahan",):
                self.padded_matmul_case(name, m, k, n)
                cases += 1
        sync(torch, self.dev)
        log(f"# phase 2: {cases} matmul parity cases at K 11008 and 6912 "
            f"(padded by the engine) and N 256, M 1 and 64, bitwise equal to "
            f"the plain version")

    def padded_matmul_case(self, name, m, k, n):
        """B5 on bf16 ``[m, k] x [k, n]`` operands as the engine pads them
        for scheme ``name``, against ``matmul_plain``, bitwise."""
        torch, km = self.torch, self.km
        eng = self.engine.CompensatedReduction(scheme=name)
        a = self.normal((m, k)).bfloat16()
        b = self.normal((k, n)).bfloat16()
        blocks = eng._matmul_blocks(m, n, k, None, None, None)
        ap, bp = eng._prep_matmul(a, b, blocks)
        kw = dict(scheme=eng.scheme, block_m=blocks[0], block_n=blocks[1],
                  block_k=blocks[2], compute_dtype=torch.float32)
        got = km.matmul_accumulators(ap, bp, **kw)
        want = km.matmul_plain(ap[None], bp[None], scheme=eng.scheme,
                               block_k=blocks[2], compute_dtype=torch.float32)
        self.compare("matmul_accumulators", got, (want[0][0], want[1][0]),
                     f"{name} bf16 {m}x{k}x{n} padded to {list(bp.shape)}")

    def vocab_parity(self, cfg):
        """B1-B4 on the telemetry's [4, vocab] rows of ``cfg`` (padded by
        the engine to 8 U 128), every scheme at U = 8, bitwise; returns
        the cases run."""
        torch = self.torch
        seen = {name: set() for name in REDUCTIONS}
        for name in SCHEMES:
            sch = self.schemes.get(name)
            eng = self.engine.CompensatedReduction(scheme=sch, unroll=8)
            a = self.data((4, cfg.vocab_size), torch.float32)
            b = self.data((4, cfg.vocab_size), torch.float32)
            ap, bp = eng._prep2d(a), eng._prep2d(b)
            kw = dict(scheme=sch, unroll=8)
            plain = (self.kd.dot_plain(ap, bp, **kw),
                     self.ks.sum_plain(ap, **kw))
            self.reduction_case(ap, bp, plain, kw,
                                f"{name} [4, {cfg.vocab_size}] "
                                f"({cfg.name})", seen)
        return len(SCHEMES)

    def moe_parity(self, cfgs):
        """Phase 2 at the shapes phase 10 gives the kernels: B1-B4 on the
        telemetry's [4, vocab] of each MoE config (llama4's 202048), and
        B5 (kahan, bf16 operands as the engine pads them) at M 1 and 64
        on every projection of the path: deepseek-v2-lite's MLA q, dkv,
        kr and o (N 3072, 512, 64, 2048), its shared experts (N 2816, K
        2816) and dense first layer (N and K 10944); llama4's q, k/v and
        o (N 5120, 1024), dense MLP (N and K 16384) and shared expert (N
        and K 8192)."""
        cases = sum(self.vocab_parity(cfg) for cfg in cfgs)
        log(f"# phase 2: {cases} reduction parity cases at the telemetry's "
            f"[4, vocab] of {[c.name for c in cfgs]} bitwise equal to the "
            f"plain versions")
        shapes = [(k, n) for cfg in cfgs for k, n in moe_projections(cfg)]
        for m in (1, 64):
            for k, n in shapes:
                self.padded_matmul_case("kahan", m, k, n)
        sync(self.torch, self.dev)
        log(f"# phase 2: {2 * len(shapes)} matmul parity cases at the MoE "
            f"family's projections [K, N] {shapes}, M 1 and 64, bitwise "
            f"equal to the plain version")

    def telemetry_times(self, cfg, label):
        """B4 at ``cfg``'s serving telemetry: [4, vocab], padded by the
        engine."""
        torch = self.torch
        eng = self.engine.CompensatedReduction(scheme="kahan", unroll=8)
        x = eng._prep2d(self.data((4, cfg.vocab_size), torch.float32))
        self.time_one("sum_accumulators_batched", "kahan", (x,),
                      lambda s: self.ks.sum_plain(x, scheme=s),
                      lambda: torch.sum(x, dim=1), reps=200, label=label,
                      valid=(4, cfg.vocab_size))

    def slice_times(self, cfg, max_len):
        """Phase 9's rows at one config's serving shapes: B4 at the
        telemetry's [4, vocab] (padded by the engine), B8 at the last full
        64-token chunk of a prompt that fills a ``max_len`` cache (H query
        heads over KV cache heads); for qwen2.5-3b, B5 at its decode and
        64-token chunk projections (k/v N 256, gate/up N 11008 and down K
        11008, padded by the engine; q/o are phase 3's [2048, 2048])."""
        label = f"serve-{cfg.name}"
        self.telemetry_times(cfg, label)
        h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        off = (max_len - 64) // 64 * 64
        self.time_flash("flash_chunk_accumulators", label,
                        self.normal((h, 64, dh)),
                        self.normal((kvh, max_len, dh)),
                        self.normal((kvh, max_len, dh)), off, reps=50,
                        groups=h // kvh)
        if cfg.name != "qwen2.5-3b":
            return
        d, f = cfg.d_model, cfg.d_ff
        kv = cfg.n_kv_heads * cfg.head_dim
        for where, m, reps in (("decode", 1, 50), ("chunk", 64, 20)):
            self.time_matmul(f"qwen-{where}-kv", m, d, kv, reps=reps)
            self.time_matmul(f"qwen-{where}-gate-up", m, d, f, reps=reps,
                             pads=True)
            self.time_matmul(f"qwen-{where}-down", m, f, d, reps=reps,
                             pads=True)

    def moe_times(self, cfg, label):
        """Phase 10's rows at one MoE config's serving shapes: B4 at the
        telemetry's [4, vocab] (padded by the engine); for
        deepseek-v2-lite, B5 at the decode (M 1) projections particular
        to it: MLA's q (N 3072) and kr (N 64, padded), the shared
        experts' gate/up (N 2816) and down (K 2816, padded)."""
        self.telemetry_times(cfg, label)
        if cfg.mla is None:
            return
        d, m = cfg.d_model, cfg.mla
        shared = cfg.moe.n_shared * cfg.moe.d_ff_shared
        self.time_matmul("dsv2-decode-q", 1, d,
                         cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim),
                         reps=50)
        self.time_matmul("dsv2-decode-kr", 1, d, m.qk_rope_dim, reps=50,
                         pads=True)
        self.time_matmul(MOE_B5_ROW, 1, d, shared, reps=50)
        self.time_matmul("dsv2-decode-shared-down", 1, shared, d, reps=50,
                         pads=True)

    # -- the hybrid family's shapes (phases 2 and 11) -------------------------
    def hybrid_parity(self, cfg):
        """Phase 2 at the shapes phase 11 gives the kernels: B1-B4 on the
        telemetry's [4, vocab] (hymba's 32001, padded by the engine to
        32768), every scheme; B7 and B8 at dh 64 with GQA groups of 5 (BH
        5, 25 and 60), every scheme, causal or not, Sq and Skv off their
        blocks; B5 (kahan, bf16 operands as the engine pads them) at M 1
        and 64 on every projection: q/o [1600, 1600], k/v [1600, 320],
        gate/up [1600, 5504] and down [5504, 1600]."""
        cases = self.vocab_parity(cfg)
        log(f"# phase 2: {cases} reduction parity cases at the telemetry's "
            f"[4, {cfg.vocab_size}] of {cfg.name} bitwise equal to the plain "
            f"versions")
        g = cfg.n_heads // cfg.n_kv_heads
        self.flash_parity(cfg.head_dim, heads=((g, g), (cfg.n_heads, g),
                                               (12 * g, g)))
        shapes = hybrid_projections(cfg)
        for m in (1, 64):
            for k, n in shapes:
                self.padded_matmul_case("kahan", m, k, n)
        sync(self.torch, self.dev)
        log(f"# phase 2: {2 * len(shapes)} matmul parity cases at "
            f"{cfg.name}'s projections [K, N] {shapes} (padded by the "
            f"engine), M 1 and 64, bitwise equal to the plain version")

    def hybrid_times(self, cfg, label, prefill_len):
        """Phase 11's rows at hymba's serving shapes: B4 at the
        telemetry's [4, vocab] (padded by the engine); B5 at the decode (M
        1) projections, each padded by the engine (K 1600 to 2048, N to a
        multiple of 256); B7 at the whole-prompt prefill of the ring check,
        ``prefill_len`` tokens, its H heads over the KV heads."""
        self.telemetry_times(cfg, label)
        d, kv, f = cfg.d_model, cfg.n_kv_heads * cfg.head_dim, cfg.d_ff
        for name, k, n in ((HYMBA_B5_ROW, d, d), ("hymba-decode-kv", d, kv),
                           ("hymba-decode-gate-up", d, f),
                           ("hymba-decode-down", f, d)):
            self.time_matmul(name, 1, k, n, reps=50, pads=True)
        h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.time_flash("flash_accumulators", f"{label}-prefill",
                        self.normal((h, prefill_len, dh)),
                        self.normal((kvh, prefill_len, dh)),
                        self.normal((kvh, prefill_len, dh)), 0, reps=10,
                        groups=h // kvh)

    # -- the xLSTM and encoder-decoder families (phases 2, 12, 13) -------------
    def family_parity(self, xcfg, wcfg):
        """Phase 2 at the shapes phases 12 and 13 give the kernels: B1-B4
        on the telemetry's [4, vocab] of xlstm-1.3b (50304, padded by the
        engine to 57344) and whisper-large-v3 (51866, padded to 57344),
        every scheme; B7 and B8 at whisper's dh 64 with G 1 (BH 20, one
        request's heads, and BH 80), every scheme, causal or not, Sq and
        Skv off their blocks; B5 (kahan, bf16 operands as the engine pads
        them: K 1280 to 1536) at M 1, 64 and 1500 (the encoder's frames)
        on whisper's projections: q/k/v/o [1280, 1280], up [1280, 5120]
        and down [5120, 1280]."""
        cases = self.vocab_parity(xcfg) + self.vocab_parity(wcfg)
        log(f"# phase 2: {cases} reduction parity cases at the telemetry's "
            f"[4, {xcfg.vocab_size}] of {xcfg.name} and [4, "
            f"{wcfg.vocab_size}] of {wcfg.name} bitwise equal to the plain "
            f"versions")
        self.flash_parity(wcfg.head_dim, heads=((wcfg.n_heads, 1),
                                                (4 * wcfg.n_heads, 1)))
        shapes = whisper_projections(wcfg)
        for m in (1, 64, wcfg.encoder.n_frames):
            for k, n in shapes:
                self.padded_matmul_case("kahan", m, k, n)
        sync(self.torch, self.dev)
        log(f"# phase 2: {3 * len(shapes)} matmul parity cases at "
            f"{wcfg.name}'s projections [K, N] {shapes} (padded by the "
            f"engine), M 1, 64 and {wcfg.encoder.n_frames}, bitwise equal to "
            f"the plain version")

    def whisper_times(self, cfg, label, max_len, prefill_len):
        """Phase 13's rows at whisper's serving shapes: B4 at the
        telemetry; B8 at the last full 64-token chunk of a prompt that
        fills a ``max_len`` cache ([20, 64, 64], G 1); B7 at the
        whole-prompt prefill of ``prefill_len`` tokens; B5 at the
        encoder's M 1500 and at a decode position's M 1, each projection
        padded by the engine (K 1280 to 1536)."""
        self.telemetry_times(cfg, label)
        h, dh = cfg.n_heads, cfg.head_dim
        off = (max_len - 64) // 64 * 64
        self.time_flash("flash_chunk_accumulators", label,
                        self.normal((h, 64, dh)), self.normal((h, max_len, dh)),
                        self.normal((h, max_len, dh)), off, reps=50)
        self.time_flash("flash_accumulators", WHISPER_PREFILL_ROW,
                        self.normal((h, prefill_len, dh)),
                        self.normal((h, prefill_len, dh)),
                        self.normal((h, prefill_len, dh)), 0, reps=20)
        d, f = cfg.d_model, cfg.d_ff
        for where, m, reps in (("encode", cfg.encoder.n_frames, 10),
                               ("decode", 1, 50)):
            self.time_matmul(f"whisper-{where}-qkvo", m, d, d, reps=reps,
                             pads=True)
            self.time_matmul(f"whisper-{where}-up", m, d, f, reps=reps,
                             pads=True)
            self.time_matmul(f"whisper-{where}-down", m, f, d, reps=reps,
                             pads=True)

    # -- matmul (B5, B6) -------------------------------------------------------
    def matmul_parity(self):
        """B5 and B6 against ``matmul_plain``, bitwise, at shapes the
        engine pads (see the module docstring, phase 2)."""
        torch, km = self.torch, self.km
        f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
        cases = 0
        for dtype in (f32, f64):
            for name in ("naive", "kahan", "pairwise", "dot2"):
                eng = self.engine.CompensatedReduction(scheme=name,
                                                       compute_dtype=dtype)
                for m, k, n in ((1, 1100, 200), (37, 1100, 200),
                                (8, 8192, 256)):
                    for odt in ((f32, bf16) if dtype == f32 else (f64,)):
                        what = f"{name} {dtype} operands {odt} {m}x{k}x{n}"
                        a = self.normal((m, k)).to(odt)
                        b = self.normal((k, n)).to(odt)
                        blocks = eng._matmul_blocks(m, n, k, None, None, None)
                        ap, bp = eng._prep_matmul(a, b, blocks)
                        check(ap.dtype == bp.dtype == odt,
                              f"the engine copied {odt} operands ({what})")
                        kw = dict(scheme=eng.scheme, block_m=blocks[0],
                                  block_n=blocks[1], block_k=blocks[2],
                                  compute_dtype=dtype)
                        got = km.matmul_accumulators(ap, bp, **kw)
                        want = km.matmul_plain(ap[None], bp[None],
                                               scheme=eng.scheme,
                                               block_k=blocks[2],
                                               compute_dtype=dtype)
                        self.compare("matmul_accumulators", got,
                                     (want[0][0], want[1][0]), what)
                        if odt == bf16:
                            promoted = km.matmul_accumulators(
                                ap.float(), bp.float(), **kw)
                            check(all(torch.equal(g, p) for g, p in
                                      zip(got, promoted)),
                                  f"bf16 operands != promoted first ({what})")
                        cases += 1
                # B6 against its plain version and a loop of B5
                a = self.normal((3, 37, 1100)).to(dtype)
                b = self.normal((3, 1100, 200)).to(dtype)
                blocks = eng._matmul_blocks(37, 200, 1100, None, None, None)
                ap, bp = eng._prep_matmul(a, b, blocks)
                kw = dict(scheme=eng.scheme, block_m=blocks[0],
                          block_n=blocks[1], block_k=blocks[2],
                          compute_dtype=dtype)
                got = km.matmul_accumulators_batched(ap, bp, **kw)
                want = km.matmul_plain(ap, bp, scheme=eng.scheme,
                                       block_k=blocks[2], compute_dtype=dtype)
                self.compare("matmul_accumulators_batched", got, want,
                             f"{name} {dtype} [3, 37, 1100] x [3, 1100, 200]")
                for i in range(3):
                    one = km.matmul_accumulators(ap[i], bp[i], **kw)
                    check(all(torch.equal(g[i], o) for g, o in zip(got, one)),
                          f"B6 != a loop of B5 ({name}, {dtype})")
                # rows of an M = 64 product == M = 1 products (both tiles)
                a = self.normal((64, 2048)).to(dtype)
                b = self.normal((2048, 512)).to(dtype)
                full = eng.matmul(a, b)
                for r in (0, 31, 63):
                    check(torch.equal(eng.matmul(a[r:r + 1], b),
                                      full[r:r + 1]),
                          f"row {r} of an M = 64 product != its M = 1 product "
                          f"({name}, {dtype})")
                cases += 2
        cases += self.matmul_backward()
        cases += self.matmul_rows_parity()
        cases += self.matmul_grid_parity()
        sync(torch, self.dev)
        log(f"# phase 2: {cases} matmul parity cases bitwise equal to the "
            f"plain version (B5, B6); bf16 operands == promoted first; B6 == "
            f"a loop of B5; rows invariant to M; backward == B5 on (g, bT) "
            f"and (aT, g), 2 launches; the M <= 8 path on unpadded rows; "
            f"the M > 8 tiles (TM 32, 64, 128) over 1-17 K-blocks split "
            f"over clusters")

    def matmul_grid_parity(self):
        """The M > 8 path against ``matmul_plain``, bitwise: M in {9, 32,
        37, 64, 100, 300} (every tile height, masked rows) x 1, 3 and 4
        K-blocks of 128, and M 37 x 17 (a cluster split that does not
        divide the K-blocks, more rounds than ranks; the plain chain's time
        grows with K; bf16 operands, widened on load, at the first three
        only) x N = 200 (ragged), for
        every scheme, float32 (bf16 and float32 operands) and float64; B6
        at batch 3 equal to a loop of B5; rows 0, 8, 31 and M - 1 of M in
        {9, 64, 300} equal M = 1 products (across the rows / grid
        boundary)."""
        torch, km = self.torch, self.km
        f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
        cases = 0
        for dtype in (f32, f64):
            for name in ("naive", "kahan", "pairwise", "dot2"):
                sch = self.schemes.get(name)
                kw = dict(scheme=sch, block_m=8, block_n=200, block_k=128,
                          compute_dtype=dtype)
                shallow = [(m, steps) for m in (9, 32, 37, 64, 100, 300)
                           for steps in (1, 3, 4)]
                # one deep row (six until PR 32: the script's time limit)
                deep = [(37, 17)]
                for odt in ((f32, bf16) if dtype == f32 else (f64,)):
                    for m, steps in shallow + (deep if odt != bf16 else []):
                        a = self.normal((m, steps * 128)).to(odt)
                        b = self.normal((steps * 128, 200)).to(odt)
                        got = km.matmul_accumulators(a, b, **kw)
                        want = km.matmul_plain(a[None], b[None], scheme=sch,
                                               block_k=128,
                                               compute_dtype=dtype)
                        self.compare("matmul_accumulators", got,
                                     (want[0][0], want[1][0]),
                                     f"{name} {dtype} operands {odt} M={m} "
                                     f"{steps} K-blocks, N=200")
                        cases += 1
                for m in (9, 64, 300):
                    a = self.normal((3, m, 2048)).to(dtype)
                    b = self.normal((3, 2048, 200)).to(dtype)
                    got = km.matmul_accumulators_batched(a, b, **kw)
                    for i in range(3):
                        one = km.matmul_accumulators(a[i], b[i], **kw)
                        check(all(torch.equal(g[i], o)
                                  for g, o in zip(got, one)),
                              f"B6 at M {m} != a loop of B5 ({name}, "
                              f"{dtype})")
                    for r in sorted({0, 8, 31, m - 1} & set(range(m))):
                        one = km.matmul_accumulators(a[0, r:r + 1], b[0],
                                                     **kw)
                        check(all(torch.equal(g[0, r:r + 1], o)
                                  for g, o in zip(got, one)),
                              f"row {r} of M = {m} != its M = 1 product "
                              f"({name}, {dtype})")
                    cases += 1
        return cases

    def matmul_rows_parity(self):
        """The M <= 8 path on unpadded rows against ``matmul_plain``,
        bitwise: M in {1, 3, 8} x 1, 4 and 16 K-blocks of 128 (bf16
        operands 1 and 4) x N = 256 and 200 (a multiple of the CTA's 16
        columns and not) for every scheme and dtype; rows that are not
        16-byte aligned (N 131, K-blocks of 100); B6 at batch 4, M 1 == a
        loop of B5."""
        torch, km = self.torch, self.km
        f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
        cases = 0
        for dtype in (f32, f64):
            for name in ("naive", "kahan", "pairwise", "dot2"):
                sch = self.schemes.get(name)
                for odt in ((f32, bf16) if dtype == f32 else (f64,)):
                    shapes = [(m, steps * 128, n, 128) for m in (1, 3, 8)
                              for steps in ((1, 4) if odt == bf16
                                            else (1, 4, 16))
                              for n in (256, 200)]
                    for m, k, n, bk in shapes + [(3, 300, 131, 100)]:
                        a = self.normal((m, k)).to(odt)
                        b = self.normal((k, n)).to(odt)
                        kw = dict(scheme=sch, block_m=8, block_n=n,
                                  block_k=bk, compute_dtype=dtype)
                        got = km.matmul_accumulators(a, b, **kw)
                        want = km.matmul_plain(a[None], b[None], scheme=sch,
                                               block_k=bk,
                                               compute_dtype=dtype)
                        self.compare("matmul_accumulators", got,
                                     (want[0][0], want[1][0]),
                                     f"{name} {dtype} operands {odt} M={m} "
                                     f"{k}x{n} block_k={bk}")
                        cases += 1
                a = self.normal((4, 1, 2048)).to(dtype)
                b = self.normal((4, 2048, 384)).to(dtype)
                kw = dict(scheme=sch, block_m=8, block_n=128, block_k=512,
                          compute_dtype=dtype)
                got = km.matmul_accumulators_batched(a, b, **kw)
                for i in range(4):
                    one = km.matmul_accumulators(a[i], b[i], **kw)
                    check(all(torch.equal(g[i], o) for g, o in zip(got, one)),
                          f"B6 at M 1 != a loop of B5 ({name}, {dtype})")
                cases += 1
        return cases

    def matmul_backward(self):
        """The autograd backward of ``ops.matmul`` (bf16 a, float32 b as
        in a projection) launches B5 twice and equals B5 on (g, bT) and
        (aT, g) at the forward's blocks, bit for bit."""
        torch = self.torch
        from repro_torch.kernels import ops

        a = self.normal((20, 700)).requires_grad_()
        b = self.normal((700, 300)).requires_grad_()
        g = self.normal((20, 300))
        out = ops.matmul(a.bfloat16(), b, scheme="kahan")
        counter = self.engine.WRAPPERS["matmul_accumulators"]
        before = counter.launches
        out.backward(g)
        check(counter.launches == before + 2,
              f"the backward launched B5 {counter.launches - before} times")
        # the forward's blocks: (min(256, 24), min(256, 384), min(512, 768))
        kw = dict(scheme="kahan", block_m=24, block_n=256, block_k=512)
        da = ops.matmul(g, b.detach().T, **kw).bfloat16().float()
        db = ops.matmul(a.detach().bfloat16().T, g, **kw)
        check(torch.equal(a.grad, da) and torch.equal(b.grad, db),
              "matmul backward != B5 on (g, bT) and (aT, g)")
        return 1

    def padded_backward_parity(self):
        """Phase 17: the autograd backward of ``ops.matmul`` (bf16 a and
        weight, a float32 gradient, as a projection's) at
        ``PADDED_BACKWARD``'s shapes, whose K or N the engine zero-pads:
        dA = g @ Wᵀ and dB = aᵀ @ g bitwise equal to the plain version on
        the operands ``_prep_matmul`` pads at the backward's blocks, and
        unpadded on the way out."""
        torch, km = self.torch, self.km
        from repro_torch.core import kahan as K
        from repro_torch.kernels import ops

        eng = self.engine.CompensatedReduction(scheme="kahan")

        def plain(x, y, blocks):
            xp, yp = eng._prep_matmul(x, y, blocks)
            s, c = km.matmul_plain(xp[None], yp[None], scheme=eng.scheme,
                                   block_k=blocks[2],
                                   compute_dtype=torch.float32)
            return K.add(s[0], c[0])[:, :y.shape[1]]

        for m, k, n in PADDED_BACKWARD:
            a = self.normal((m, k)).bfloat16().requires_grad_()
            w = self.normal((k, n)).bfloat16().requires_grad_()
            g = self.normal((m, n))
            ops.matmul(a, w, scheme="kahan").backward(g)
            fwd = eng._matmul_blocks(m, n, k, None, None, None)
            da = plain(g, w.detach().T.contiguous(),
                       eng._matmul_blocks(m, k, n, *fwd)).to(a.dtype)
            db = plain(a.detach().T.contiguous(), g,
                       eng._matmul_blocks(k, n, m, *fwd)).to(w.dtype)
            for got, want, what in ((a.grad, da, "dA"), (w.grad, db, "dB")):
                check(got.shape == want.shape and same_bits(torch, got, want),
                      f"B5's {what} at [{m}, {k}] x [{k}, {n}] (padded) != "
                      f"the plain version")
        sync(torch, self.dev)
        log(f"# phase 17: B5's backward (dA and dB) at {PADDED_BACKWARD}, K "
            f"or N padded by the engine, bitwise equal to the plain version "
            f"and unpadded")

    def family_train_times(self):
        """Phase 17's B5 rows, at 1024 tokens a microbatch: qwen2.5-3b's
        padded backward of the up projection (dA = g @ Wᵀ, K 11008; dB =
        aᵀ @ g, N 11008), deepseek-v2-lite's shared-expert gate/up (N 2816)
        and MLA q (N 3072) in float32 compute (float32 activations against
        bf16 weights), hymba-1.5b's up projection (K 1600, N 5504) and
        whisper-large-v3's encoder q/k/v/o and up over 4 x 1500 frames (K
        1280), each padded by the engine."""
        torch = self.torch
        f32, bf16 = torch.float32, torch.bfloat16
        t = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ
        frames = TRAIN_BATCH // TRAIN_MICRO * 1500
        for label, m, k, n, dts in (
                ("train-qwen-dA-up", t, 11008, 2048, (f32, bf16)),
                ("train-qwen-dB-up", 2048, t, 11008, (bf16, f32)),
                ("train-deepseek-shared-up", t, 2048, 2816, (f32, bf16)),
                ("train-deepseek-mla-q", t, 2048, 3072, (f32, bf16)),
                ("train-hymba-up", t, 1600, 5504, (bf16, bf16)),
                ("train-whisper-encode-qkvo", frames, 1280, 1280,
                 (bf16, bf16)),
                ("train-whisper-encode-up", frames, 1280, 5120,
                 (bf16, bf16))):
            self.time_matmul(label, m, k, n, reps=3, dtypes=dts, pads=True)

    def time_matmul(self, label, m, k, n, batch=None, reps=20,
                    dtypes=None, pads=False, compute_dtype=None):
        """B5 (or B6 with ``batch``) at ``[M, K] x [K, N]`` with bf16
        operands (or ``dtypes``: the backward's float32 gradient against
        bf16 weights and activations), as the projections give it (the
        engine pads, copies and widens nothing at these widths, which is
        checked): kernel, plain and library (``torch.matmul``
        / ``bmm`` on the operands promoted to float32, TF32 off) times,
        and the parity check. The timed launches cycle through copies of
        the operands that together exceed the 50 MB L2 cache twice, as a
        decode position finds the weights cold, and are captured in a CUDA
        graph: a decode-shape launch is shorter than the wrapper's
        enqueue on the host. ``pads``: a K off ``block_k`` (11008), which
        the engine zero-pads; the kernel is timed on the padded operands
        it gets. ``compute_dtype``: float32 by default; the library call
        then runs in the compute dtype (bf16 on the tensor cores)."""
        torch, km = self.torch, self.km
        cdt = compute_dtype or torch.float32
        lead = () if batch is None else (batch,)
        name = ("matmul_accumulators" if batch is None
                else "matmul_accumulators_batched")
        wrapper = self.engine.WRAPPERS[name]
        eng = self.engine.CompensatedReduction(scheme="kahan",
                                               compute_dtype=cdt)
        a_dt, b_dt = dtypes or (torch.bfloat16, torch.bfloat16)
        a = self.normal((*lead, m, k)).to(a_dt)
        b = self.normal((*lead, k, n)).to(b_dt)
        blocks = eng._matmul_blocks(m, n, k, None, None, None)
        ap, bp = eng._prep_matmul(a, b, blocks)
        check(pads or (ap.shape == a.shape and bp.data_ptr() == b.data_ptr()),
              f"the engine padded or copied operands at {label}")
        check(pads or ap.data_ptr() == a.data_ptr(),
              f"the engine copied operands at {label}")
        check(ap.dtype == a_dt and bp.dtype == b_dt,
              f"the engine widened operands at {label}")
        kpad, npad = ap.shape[-1], bp.shape[-1]
        kw = dict(scheme=eng.scheme, block_m=blocks[0], block_n=blocks[1],
                  block_k=blocks[2], compute_dtype=cdt)
        got = wrapper(ap, bp, **kw)
        sync(torch, self.dev)
        t0 = time.perf_counter()
        want = km.matmul_plain(ap.reshape(-1, m, kpad),
                               bp.reshape(-1, kpad, npad),
                               scheme=eng.scheme, block_k=blocks[2],
                               compute_dtype=cdt)
        sync(torch, self.dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if batch is None:
            want = (want[0][0], want[1][0])
        self.compare(name, got, want, f"kahan at {label}")
        del want, got
        operands = cold_copies(torch, (ap, bp))
        ms = graph_ms(torch, cycle(lambda x, y: wrapper(x, y, **kw),
                                   operands), reps)
        promoted = cold_copies(torch, (ap.to(cdt), bp.to(cdt)))
        library_ms = graph_ms(torch, cycle(torch.matmul, promoted), reps)
        del operands, promoted
        nb = 1 if batch is None else batch
        # the function's own bytes: the operands as given (not the padding
        # the engine adds), the (s, c) grids written once
        n_bytes = (a.numel() * a.element_size()
                   + b.numel() * b.element_size()
                   + 2 * nb * m * n * torch.empty((), dtype=cdt).element_size())
        flops = 2 * nb * m * n * k
        least, by = bound_ms(n_bytes, flops, cdt)
        # the fixed chain's own ceiling: a separate multiply and add per
        # term, at half the fma rate
        ceiling = fma_ceiling_ms(flops, cdt)
        tm, tn, split = km.grid_plan(nb, m, npad, kpad, blocks[2], cdt)
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": least, "bound_by": by,
               "shape": [*lead, m, k, n], "scheme": "kahan",
               "dtype": dtype_name(cdt),
               "operands": [str(a_dt)[6:], str(b_dt)[6:]],
               "block_k": blocks[2], "tflops": flops / ms / 1e9,
               "gbytes_per_s": n_bytes / ms / 1e6,
               "mul_add_ceiling_ms": ceiling,
               "ceiling_share": ceiling / ms,
               "tile": [tm, tn] if tm else None, "cluster": split or None,
               "before_ms": MATMUL_BEFORE_MS.get(label)}
        self.timing[(name, label)] = row
        plan = (f"tile {tm}x{tn}, cluster {split}" if tm
                else "rows path (M <= 8)")
        before = MATMUL_BEFORE_MS.get(label)
        was = f"; before the redesign {before:.4f}" if before else ""
        log(f"# {name} {label} {row['shape']} {dtype_name(cdt)} compute: "
            f"kernel {ms:.4f} ms "
            f"({row['tflops']:.2f} TFLOP/s, {row['gbytes_per_s']:.0f} GB/s"
            f"{was}), "
            f"{by} bound {least:.4f} ms, mul+add ceiling {ceiling:.4f} ms "
            f"({100 * ceiling / ms:.1f}%), {plan}, plain {plain_ms:.1f} ms, "
            f"library ({dtype_name(cdt)} matmul) {library_ms:.4f} ms")

    def matmul_times(self, cfg, prefill_len):
        """B5 at every projection shape of OLMo-1B at decode (M 1, as
        served; M 8, the padded rows earlier runs timed) and in a 64- and a
        32-token chunk (the serving trace's chunks), and at the up
        projection of a ``prefill_len``-token prefill; B6 at 4
        chunk-sized q projections."""
        d, f = cfg.d_model, cfg.d_ff
        hd = cfg.n_heads * cfg.head_dim
        shapes = (("qkvo", d, hd), ("gate-up", d, f), ("down", f, d))
        for label, m, reps in (("decode", 1, 50), ("decode8", 8, 50),
                               ("chunk", 64, 20), ("chunk32", 32, 20)):
            for proj, k, n in shapes:
                self.time_matmul(f"{label}-{proj}", m, k, n, reps=reps)
        self.time_matmul("prefill-up", prefill_len, d, f, reps=5)
        self.time_matmul("batched", 64, d, hd, batch=4, reps=10)
        # per layer: 4 q/k/v/o, 2 gate/up and 1 down launch
        per_layer = (("qkvo", 4), ("gate-up", 2), ("down", 1))
        self.matmul_totals = {
            f"{label}_{key}": cfg.n_layers * sum(
                n * self.timing[("matmul_accumulators", f"{label}-{p}")][key]
                for p, n in per_layer)
            for label in ("decode", "decode8", "chunk", "chunk32")
            for key in ("ms", "bound_ms", "library_ms", "mul_add_ceiling_ms")}
        t = self.matmul_totals
        log(f"# B5 per decode position ({PROJECTIONS * cfg.n_layers} "
            f"launches, M 1): {t['decode_ms']:.3f} ms, bound "
            f"{t['decode_bound_ms']:.3f} ms, f32 matmul "
            f"{t['decode_library_ms']:.3f} ms (at M 8: {t['decode8_ms']:.3f} "
            f"ms); per 64-token chunk {t['chunk_ms']:.3f} ms, bound "
            f"{t['chunk_bound_ms']:.3f} ms, mul+add ceiling "
            f"{t['chunk_mul_add_ceiling_ms']:.3f} ms, f32 matmul "
            f"{t['chunk_library_ms']:.3f} ms; per 32-token chunk "
            f"{t['chunk32_ms']:.3f} ms")

    # -- the compute dtypes of this slice (phases 2 and 3) ---------------------
    def dtype_parity(self, cfg):
        """B5/B6 in bfloat16 compute and B7/B8 in bfloat16 and float64
        against their plain versions, bitwise. Matmul, every scheme: M in
        {1, 3, 8} (the rows path) and {9, 37, 64, 300} (the tiles) x 1, 4
        and 17 K-blocks of 128 x N 200; B6 at [3, 37, 1024] x [3, 1024,
        200] equal to its plain version and a loop of B5; M 1 and 37 on
        subnormal-reaching and on large operands; OLMo-1B's
        projections at M 1 ([1, d] x [d, H dh]) and in a 64-token chunk
        ([64, d] x [d, d_ff]). Flash in each dtype: ``flash_parity`` at
        OLMo-1B's head dim (every scheme, causal and not, G 1 and 2, B8
        rows == B7 rows; at BH 48 B7 takes the dtype's tall tile, 64 rows
        in bfloat16 and 32 in float64) and B8 at OLMo-1B's serving chunk
        [H, 64, dh] against 112 cached rows."""
        torch, km, fa = self.torch, self.km, self.fa
        bf16, f64 = torch.bfloat16, torch.float64
        cases = 0
        for name in SCHEMES:
            sch = self.schemes.get(name)
            kw = dict(scheme=sch, block_m=8, block_n=200, block_k=128,
                      compute_dtype=bf16)
            for m in (1, 3, 8, 9, 37, 64, 300):
                for steps in (1, 4, 17):
                    a = self.normal((m, steps * 128)).to(bf16)
                    b = self.normal((steps * 128, 200)).to(bf16)
                    got = km.matmul_accumulators(a, b, **kw)
                    want = km.matmul_plain(a[None], b[None], scheme=sch,
                                           block_k=128, compute_dtype=bf16)
                    self.compare("matmul_accumulators", got,
                                 (want[0][0], want[1][0]),
                                 f"{name} bfloat16 M={m} {steps} K-blocks")
                    cases += 1
            a = self.normal((3, 37, 1024)).to(bf16)
            b = self.normal((3, 1024, 200)).to(bf16)
            got = km.matmul_accumulators_batched(a, b, **kw)
            want = km.matmul_plain(a, b, scheme=sch, block_k=128,
                                   compute_dtype=bf16)
            self.compare("matmul_accumulators_batched", got, want,
                         f"{name} bfloat16 [3, 37, 1024] x [3, 1024, 200]")
            for i in range(3):
                one = km.matmul_accumulators(a[i], b[i], **kw)
                check(all(torch.equal(g[i], o) for g, o in zip(got, one)),
                      f"bfloat16 B6 != a loop of B5 ({name})")
            cases += 1
            # subnormal-reaching operands (a fifth subnormal, products
            # below 2^-126) and large ones (products near 2^110, no sum
            # near bfloat16's largest finite value), rows path and tiles
            for lo, hi in ((-70, -50), (40, 56)):
                for m in (1, 37):
                    a = self.sub_data((m, 4 * 128), bf16, lo, hi)
                    b = self.sub_data((4 * 128, 200), bf16, lo, hi)
                    got = km.matmul_accumulators(a, b, **kw)
                    want = km.matmul_plain(a[None], b[None], scheme=sch,
                                           block_k=128, compute_dtype=bf16)
                    self.compare("matmul_accumulators", got,
                                 (want[0][0], want[1][0]),
                                 f"{name} bfloat16 M={m} operands 2^[{lo}, "
                                 f"{hi}) with subnormals")
                    cases += 1
        eng = self.engine.CompensatedReduction(scheme="kahan",
                                               compute_dtype=bf16)
        d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
        for m, k, n in ((1, d, hd), (64, d, cfg.d_ff)):
            a = self.normal((m, k)).to(bf16)
            b = self.normal((k, n)).to(bf16)
            blocks = eng._matmul_blocks(m, n, k, None, None, None)
            got = km.matmul_accumulators(
                a, b, scheme=eng.scheme, block_m=blocks[0],
                block_n=blocks[1], block_k=blocks[2], compute_dtype=bf16)
            want = km.matmul_plain(a[None], b[None], scheme=eng.scheme,
                                   block_k=blocks[2], compute_dtype=bf16)
            self.compare("matmul_accumulators", got, (want[0][0], want[1][0]),
                         f"kahan bfloat16 OLMo-1B [{m}, {k}] x [{k}, {n}]")
            cases += 1
        sync(torch, self.dev)
        log(f"# phase 2: {cases} bfloat16 matmul parity cases bitwise equal "
            f"to the plain version (B5 on both paths, subnormal-reaching "
            f"and large operands, B6 == its plain version and a loop of "
            f"B5, OLMo-1B's q and chunk gate/up shapes)")
        h, dh = cfg.n_heads, cfg.head_dim
        for dtype in (bf16, f64):
            self.flash_parity(dh, heads=((4, 1), (16, 2), (48, 1)),
                              dtype=dtype)
            sch = self.schemes.get("kahan")
            ceng = self.engine.CompensatedReduction(scheme=sch,
                                                    compute_dtype=dtype)
            q, k, v, bq, bk, _, _ = ceng._flash_prep(
                "dtype_parity", self.normal((h, 64, dh)),
                self.normal((h, 112, dh)), self.normal((h, 112, dh)), 256,
                256, 1)
            got = fa.flash_chunk_accumulators(q, k, v, 48, block_q=bq,
                                              block_k=bk, scheme=sch,
                                              kv_len=112)
            want = fa.flash_plain(q, k, v, scheme=sch, block_k=bk, kv_len=112,
                                  causal=True, q_off=48)
            self.compare("flash_chunk_accumulators", got, want,
                         f"kahan {dtype} OLMo-1B chunk [{h}, 64, {dh}] at "
                         f"48 against 112 rows")
        sync(torch, self.dev)
        log(f"# phase 2: B8 in bfloat16 and float64 at OLMo-1B's serving "
            f"chunk [{h}, 64, {dh}] bitwise equal to the plain version")

    def dtype_times(self, cfg, prefill_len, serve_len):
        """Phase 3 in the compute dtypes of this slice, each with its
        parity check, bound (operations at the dtype's peak,
        ``PEAK_TFLOPS``) and library call in the same dtype: B7 at the
        entry shape and B8 at the serving chunk in bfloat16 and float64;
        B5 at the decode q/k/v/o shape (M 1) and the 64-token chunk's
        gate/up in bfloat16 and float64 (float64 operands: the engine
        widens bf16 weights for a float64 compute dtype), B6 at the
        batched shape in bfloat16; B4 at the serving telemetry's [4,
        57344] in both; and B5 at M 4 in float32, the decode shape of
        phase 14's vmapped tick."""
        torch = self.torch
        h, dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model
        hd = h * dh
        off = (serve_len - 64) // 64 * 64
        self.time_matmul("decode4-qkvo", 4, d, hd, reps=50)
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float64, "f64")):
            self.time_flash("flash_accumulators", f"entry-{tag}",
                            self.normal((h, prefill_len, dh)),
                            self.normal((h, prefill_len, dh)),
                            self.normal((h, prefill_len, dh)), 0, reps=5,
                            dtype=dtype)
            self.time_flash("flash_chunk_accumulators", f"serve-{tag}",
                            self.normal((h, 64, dh)),
                            self.normal((h, serve_len, dh)),
                            self.normal((h, serve_len, dh)), off, reps=50,
                            dtype=dtype)
            ops_dt = (dtype, dtype)
            self.time_matmul(f"decode-qkvo-{tag}", 1, d, hd, reps=50,
                             dtypes=ops_dt, compute_dtype=dtype)
            self.time_matmul(f"chunk-gate-up-{tag}", 64, d, cfg.d_ff,
                             reps=20, dtypes=ops_dt, compute_dtype=dtype)
            x = self.data((4, 57344), dtype)
            self.time_one("sum_accumulators_batched", "kahan", (x,),
                          lambda s, x=x: self.ks.sum_plain(x, scheme=s),
                          lambda x=x: torch.sum(x, dim=1), reps=200,
                          label=f"serve-{tag}", valid=(4, 50304))
        self.time_matmul("batched-bf16", 64, d, hd, batch=4, reps=10,
                         compute_dtype=torch.bfloat16)

    def column_parity(self):
        """The column-scan kernel (``kahan_columns``) against its plain
        loop, bitwise, on float32 and bf16 leaves: tall, wide, one row,
        rows off its 16-row batch, trailing sizes off its 128-thread
        CTA."""
        torch = self.torch
        from repro_torch.core.kahan import column_sq_plain
        from repro_torch.kernels import kahan_columns

        cases = 0
        for rows, trail in ((300, (37, 5)), (2, (65,)), (1, (7,)),
                            (41, (1,)), (17, (129,)), (1000, (2048,))):
            for dtype in (torch.float32, torch.bfloat16):
                x = self.data((rows, *trail), dtype)
                got = kahan_columns.column_sq_accumulators(x)
                want = column_sq_plain(x.float())
                self.compare("column_sq_accumulators", got, want,
                             f"[{rows}, {trail}] {dtype}")
                cases += 1
        log(f"# phase 2: {cases} column-scan cases bitwise equal to the "
            f"plain loop (float32 and bf16 leaves, ragged rows and columns)")

    # -- 2. subnormal-reaching data (C2) --------------------------------------
    def sub_data(self, shape, dtype, lo, hi):
        """Normal values scaled by 2^e, e in [lo, hi), a fifth of them
        scaled into float32's subnormal range and a twentieth signed
        zeros, as ``dtype`` (a bfloat16 subnormal stays one)."""
        torch, gen, dev = self.torch, self.gen, self.dev
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
        e = torch.randint(lo, hi, shape, generator=gen, device=dev)
        sub = torch.rand(shape, generator=gen, device=dev) < 0.2
        e = torch.where(sub, torch.randint(-149, -127, shape, generator=gen,
                                           device=dev), e)
        x = x * torch.exp2(e.double())
        zero = torch.rand(shape, generator=gen, device=dev) < 0.05
        return torch.where(zero, x * 0, x).to(dtype)

    def boundary_pair(self, shape, dtype):
        """(a, b) whose float32 products lie a few units of the last place
        on either side of ``tiny`` = 2^-126: a = +-(1 - j 2^-24) 2^k, b =
        +-tiny (1 + i 2^-23) 2^-k, i, j in 0..3, k in -3..3 (x86, and so
        the reference, flushes (1 - 2^-24) tiny and keeps (1 - 2^-23) tiny
        (1 + 2^-23))."""
        torch, gen, dev = self.torch, self.gen, self.dev

        def ints(lo, hi):
            return torch.randint(lo, hi, shape, generator=gen,
                                 device=dev).double()

        def sign():
            return ints(0, 2) * 2 - 1

        k = ints(-3, 4)
        a = sign() * (1 - ints(0, 4) * 2.0 ** -24) * torch.exp2(k)
        b = sign() * 2.0 ** -126 * (1 + ints(0, 4) * 2.0 ** -23)
        return a.to(dtype), (b * torch.exp2(-k)).to(dtype)

    def subnormal_parity(self):
        """Every kernel against its flushing plain version, bitwise, on
        data that reaches float32's subnormal range: subnormal inputs,
        products and sums that underflow, the products at the ``tiny``
        boundary, bf16 subnormal operands (the kernels are built with
        ``-ftz=true``; the plain versions flush op for op as XLA does on
        the CPU). Returns the number of cases."""
        torch = self.torch
        kd, ks, km, fa = self.kd, self.ks, self.km, self.fa
        f32, bf16 = torch.float32, torch.bfloat16
        cases = 0
        seen = {name: set() for name in REDUCTIONS}
        n = 3 * 8192 + 37
        for dtype in (f32, bf16):
            for name in SCHEMES:
                sch = self.schemes.get(name)
                for unroll in (1, 8):
                    eng = self.engine.CompensatedReduction(
                        scheme=sch, unroll=unroll, compute_dtype=dtype)
                    kw = dict(scheme=sch, unroll=unroll)
                    data = {
                        "products underflow": (
                            self.sub_data((3, n), dtype, -75, -52),
                            self.sub_data((3, n), dtype, -75, -52)),
                        "sums underflow": (
                            self.sub_data((3, n), dtype, -135, -110),
                            self.sub_data((3, n), dtype, -135, -110)),
                        "tiny boundary": self.boundary_pair((3, n), dtype)}
                    for label, (a, b) in data.items():
                        ap, bp = eng._prep2d(a), eng._prep2d(b)
                        plain = (kd.dot_plain(ap, bp, **kw),
                                 ks.sum_plain(ap, **kw))
                        self.reduction_case(
                            ap, bp, plain, kw,
                            f"{name} U={unroll} {dtype} {label}", seen)
                        cases += 1
                # bf16 subnormal operands into a float32 accumulate
                if dtype == bf16:
                    eng = self.engine.CompensatedReduction(scheme=sch,
                                                           unroll=8)
                    a = self.sub_data((3, n), bf16, -75, -52)
                    b = self.sub_data((3, n), bf16, -75, -52)
                    ap, bp = eng._prep2d(a), eng._prep2d(b)
                    kw = dict(scheme=sch, unroll=8)
                    self.reduction_case(
                        ap, bp, (kd.dot_plain(ap, bp, **kw),
                                 ks.sum_plain(ap, **kw)), kw,
                        f"{name} bf16 subnormal operands, float32", seen)
                    cases += 1
        # matmul: both tile paths (M 3 and 37), float32 and bf16 operands
        for name in SCHEMES:
            eng = self.engine.CompensatedReduction(scheme=name)
            for m in (3, 37):
                for odt in (f32, bf16):
                    a = self.sub_data((m, 1100), odt, -75, -52)
                    b = self.sub_data((1100, 200), odt, -75, -52)
                    if odt == f32:
                        a[0], b[:, 0] = self.boundary_pair((1100,), f32)
                    blocks = eng._matmul_blocks(m, 200, 1100, None, None,
                                                None)
                    ap, bp = eng._prep_matmul(a, b, blocks)
                    kw = dict(scheme=eng.scheme, block_m=blocks[0],
                              block_n=blocks[1], block_k=blocks[2],
                              compute_dtype=f32)
                    got = km.matmul_accumulators(ap, bp, **kw)
                    want = km.matmul_plain(ap[None], bp[None],
                                           scheme=eng.scheme,
                                           block_k=blocks[2],
                                           compute_dtype=f32)
                    self.compare("matmul_accumulators", got,
                                 (want[0][0], want[1][0]),
                                 f"{name} {odt} operands M={m}, subnormal")
                    cases += 1
        # flash: scores whose exp underflows, subnormal v
        eng = self.engine.CompensatedReduction(scheme="kahan")
        sq, skv, bh, dh = 300, 600, 4, 128
        q, k, v, bq, bk, _, _ = eng._flash_prep(
            "subnormal_parity", self.normal((bh, sq, dh)) * 6,
            self.normal((bh, skv, dh)) * 6,
            self.sub_data((bh, skv, dh), f32, -130, -100), 256, 256, 1)
        for name in SCHEMES:
            sch = self.schemes.get(name)
            got = fa.flash_accumulators(q, k, v, block_q=bq, block_k=bk,
                                        scheme=sch, kv_len=skv, causal=True,
                                        q_groups=1)
            want = fa.flash_plain(q, k, v, scheme=sch, block_k=bk,
                                  kv_len=skv, causal=True)
            self.compare("flash_accumulators", got, want,
                         f"{name}, exp underflows, subnormal v")
            qc = q[:, 64:128].contiguous()
            got = fa.flash_chunk_accumulators(qc, k, v, 64, block_q=64,
                                              block_k=bk, scheme=sch,
                                              kv_len=skv, q_groups=1)
            want = fa.flash_plain(qc, k, v, scheme=sch, block_k=bk,
                                  kv_len=skv, causal=True, q_off=64)
            self.compare("flash_chunk_accumulators", got, want,
                         f"{name}, exp underflows, subnormal v")
            cases += 2
        # column scan: squares that underflow, subnormal entries
        from repro_torch.core.kahan import column_sq_plain
        from repro_torch.kernels import kahan_columns

        for dtype in (f32, bf16):
            for lo, hi in ((-75, -52), (-140, -100)):
                x = self.sub_data((300, 37, 5), dtype, lo, hi)
                got = kahan_columns.column_sq_accumulators(x)
                self.compare("column_sq_accumulators", got,
                             column_sq_plain(x.float()),
                             f"{dtype} subnormal, e in [{lo}, {hi})")
                cases += 1
        sync(torch, self.dev)
        log(f"# phase 2: {cases} subnormal-reaching cases bitwise equal to "
            f"the flushing plain versions (every reduction x scheme x "
            f"float32 / bf16, products and sums that underflow, products at "
            f"the tiny boundary, bf16 subnormal operands; B5 at M 3 and 37; "
            f"B7 and B8 with exp underflowing; the column scan)")
        return cases

    def dist_times(self, spec):
        """Phase 8's rows, at one rank's shapes: B3 and B1 on its block of
        the sharded sum and dot, B4 on its two requests, B5 on its
        K-slice (float32 operands), and B3 on the trainer's loss fold (one
        microbatch loss a rank, padded to one block)."""
        torch, kd, ks = self.torch, self.kd, self.ks
        f32 = torch.float32
        half = spec["n"] // DIST_RANKS
        x, y = self.data((half,), f32), self.data((half,), f32)
        self.time_one("sum_accumulators", "kahan", (x,),
                      lambda s: [t[0] for t in ks.sum_plain(x[None],
                                                            scheme=s)],
                      lambda: torch.sum(x), label="sharded")
        self.time_one("dot_accumulators", "kahan", (x, y),
                      lambda s: [t[0] for t in kd.dot_plain(
                          x[None], y[None], scheme=s)],
                      lambda: torch.dot(x, y), label="sharded")
        del x, y
        rows, cols = spec["act"]
        sq = self.data((rows // DIST_RANKS, cols), f32)
        self.time_one("sum_accumulators_batched", "kahan", (sq,),
                      lambda s: ks.sum_plain(sq, scheme=s),
                      lambda: torch.sum(sq, dim=1), reps=200,
                      label="sharded")
        one = torch.zeros(8192, device=self.dev)
        one[0] = 2.5
        self.time_one("sum_accumulators", "kahan", (one,),
                      lambda s: [t[0] for t in ks.sum_plain(one[None],
                                                            scheme=s)],
                      lambda: torch.sum(one), reps=200, label="sharded-loss")
        m, k, n = spec["matmul"]
        self.time_matmul("sharded", m, k // DIST_RANKS, n,
                         dtypes=(f32, f32))

    def shard_times(self, spec, flash_call):
        """Phase 15's rows at a rank's shapes: the sharded norm's largest
        local leaf (the embedding's [V_pad, d / 2] on the (data 2, model
        1) mesh) through B3 (its squares) and the column scan, and B7 on
        one rank's head-rows of the prefill."""
        torch, ks = self.torch, self.ks
        cfg = spec["cfg"]
        shape = (cfg.padded_vocab, cfg.d_model // DIST_RANKS)
        sq = self.data((math.prod(shape),), torch.float32) ** 2
        self.time_one("sum_accumulators", "kahan", (sq,),
                      lambda s: [t[0] for t in ks.sum_plain(sq[None],
                                                            scheme=s)],
                      lambda: torch.sum(sq), reps=5, label="sharded-norm")
        del sq
        self.time_columns("sharded-norm", shape)
        q, k = flash_call["q"], flash_call["k"]
        self.time_flash("flash_accumulators", "sharded-heads",
                        self.normal(tuple(q.shape)),
                        self.normal(tuple(k.shape)),
                        self.normal(tuple(k.shape)), 0, reps=10,
                        groups=q.shape[0] // k.shape[0])

    def train_times(self, cfg, tokens):
        """Phase 3's training rows: B5 at every (shape, operand pair) a
        train step of ``tokens`` tokens a microbatch gives it with
        ``kahan_matmul`` (forward and recompute bf16 x bf16; dA = g @ W^T
        float32 x bf16; dB = a^T @ g bf16 x float32), with the totals a
        step predicts; B3 at the largest parameter leaf (2^28 float32
        squares); the column scan at the embedding's [V_pad, d] gradient
        and at a [16, d, d_ff] one."""
        torch = self.torch
        f32, bf16 = torch.float32, torch.bfloat16
        d, f = cfg.d_model, cfg.d_ff
        hd = cfg.n_heads * cfg.head_dim
        t = tokens
        # (label, M, K, N, operand dtypes, launches a layer and microbatch)
        shapes = (
            ("train-qkvo", t, d, hd, (bf16, bf16), 8),
            ("train-up", t, d, f, (bf16, bf16), 4),
            ("train-down", t, f, d, (bf16, bf16), 2),
            ("train-dA-qkvo", t, hd, d, (f32, bf16), 4),
            ("train-dA-up", t, f, d, (f32, bf16), 2),
            ("train-dA-down", t, d, f, (f32, bf16), 1),
            ("train-dB-qkvo", d, t, hd, (bf16, f32), 4),
            ("train-dB-up", d, t, f, (bf16, f32), 2),
            ("train-dB-down", f, t, d, (bf16, f32), 1))
        for label, m, k, n, dts, _ in shapes:
            self.time_matmul(label, m, k, n, reps=3, dtypes=dts)
        per = cfg.n_layers * TRAIN_MICRO
        keys = ("ms", "bound_ms", "library_ms", "mul_add_ceiling_ms")
        self.train_b5 = {
            key: per * sum(self.timing[("matmul_accumulators", lab)][key] * c
                           for lab, *_, c in shapes)
            for key in keys}
        self.train_b5["launches"] = per * sum(c for *_, c in shapes)
        t5 = self.train_b5
        log(f"# B5 per train step ({t5['launches']} launches at {tokens} "
            f"tokens a microbatch, from the rows above): {t5['ms']:.1f} ms, "
            f"operations bound {t5['bound_ms']:.1f} ms, mul+add ceiling "
            f"{t5['mul_add_ceiling_ms']:.1f} ms, f32 matmul "
            f"{t5['library_ms']:.1f} ms")
        x = self.data((1 << 28,), f32)
        self.time_one("sum_accumulators", "kahan", (x,),
                      lambda s: [v[0] for v in self.ks.sum_plain(
                          x[None], scheme=s)],
                      lambda: torch.sum(x), reps=5, label="train")
        del x
        self.time_columns("train", (cfg.padded_vocab, d), plain=False)
        self.time_columns("train-wide", (cfg.n_layers, d, f))

    def time_columns(self, label, shape, plain=True):
        """The column scan on a float32 ``shape`` leaf: kernel (graph-
        timed), its plain loop (host clock, once) bitwise equal, and
        ``torch.linalg.vecdot(x, x, dim=0)`` as the library call. Without
        ``plain`` the loop is left to phase 6, which runs it on the same
        shape (the embedding's gradient) and fills in its time."""
        torch = self.torch
        from repro_torch.core.kahan import column_sq_plain
        from repro_torch.kernels import kahan_columns

        wrapper = kahan_columns.column_sq_accumulators
        x = self.data(shape, torch.float32)
        plain_ms = None
        if plain:
            got = wrapper(x)
            sync(torch, self.dev)
            t0 = time.perf_counter()
            want = column_sq_plain(x)
            sync(torch, self.dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            self.compare("column_sq_accumulators", got, want,
                         f"{label} {shape}")
            del got, want
        ms = graph_ms(torch, lambda: wrapper(x), 5, 3)
        library_ms = graph_ms(torch, lambda: torch.linalg.vecdot(x, x, dim=0),
                              5, 3)
        cols = x.numel() // shape[0]
        n_bytes = x.numel() * 4 + 2 * cols * 4
        least, by = bound_ms(n_bytes, 5 * x.numel())
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": least, "bound_by": by, "shape": list(shape),
               "gbytes_per_s": n_bytes / ms / 1e6}
        self.timing[("column_sq_accumulators", label)] = row
        loop = (f"plain loop {plain_ms:.1f} ms (bitwise equal)" if plain
                else "plain loop in phase 6")
        log(f"# column_sq_accumulators {label} {list(shape)}: kernel "
            f"{ms:.4f} ms ({row['gbytes_per_s']:.0f} GB/s), {by} bound "
            f"{least:.4f} ms, {loop}, library (vecdot) {library_ms:.4f} ms")
        del x

    def rows(self):
        """One JSON row per wrapper and path that launches it, with that
        path's launch count, timed at that path's shape."""
        src = "src/repro_torch/csrc/"
        replaces = {
            "dot_accumulators": "src/repro/kernels/kahan_dot.py:89",
            "dot_accumulators_batched": "src/repro/kernels/kahan_dot.py:139",
            "sum_accumulators": "src/repro/kernels/kahan_sum.py:63",
            "sum_accumulators_batched": "src/repro/kernels/kahan_sum.py:105",
            "flash_accumulators":
                "src/repro/kernels/flash_attention.py:262",
            "flash_chunk_accumulators":
                "src/repro/kernels/flash_attention.py:377",
            "matmul_accumulators": "src/repro/kernels/kahan_matmul.py:101",
            "matmul_accumulators_batched":
                "src/repro/kernels/kahan_matmul.py:153",
            # no pallas_call: the lax.scan of tree_kahan_sq_norm
            "column_sq_accumulators": "src/repro/core/kahan.py:403",
        }
        # every (kernel, path) pair that launched, timed at that path's
        # shape: the reductions at the phase-3 sizes, B4 on every serving
        # path at the telemetry shape, B7 at the prefill shape, B8 at each
        # serving run's cache length, B5 at the decode q/k/v/o shape when
        # serving and at the 2048-token up projection on the entry path,
        # B6 at its batched shape
        special = {("flash_chunk_accumulators", "serve-long"): "serve-long",
                   ("matmul_accumulators", "entry"): "prefill-up",
                   ("matmul_accumulators", "serve-matmul"): "decode-qkvo",
                   ("matmul_accumulators_batched", "entry"): "batched",
                   ("matmul_accumulators", "train-b"): "train-up",
                   ("sum_accumulators", "train-b"): "train",
                   ("column_sq_accumulators", "train-a"): "train",
                   ("sum_accumulators", "sharded"): "sharded",
                   ("dot_accumulators", "sharded"): "sharded",
                   ("sum_accumulators_batched", "sharded"): "sharded",
                   ("matmul_accumulators", "sharded"): "sharded",
                   ("sum_accumulators", "sharded-train"): "sharded-loss",
                   ("column_sq_accumulators", "sharded-train"): "train"}
        special.update(self.path_labels)
        rows = []
        for path, counts in self.launches.items():
            for name in replaces:
                if counts[name]:
                    default = ("serve" if path.startswith("serve")
                               else "entry" if name.startswith("flash")
                               else "kahan")
                    rows.append((name, path,
                                 special.get((name, path), default)))
        out = []
        for name, path, label in rows:
            t = self.timing[(name, label)]
            out.append({
                "name": name, "route": "cuda",
                "source": src + ("kahan_flash.cu" if name.startswith("flash")
                                 else "kahan_matmul.cu"
                                 if name.startswith("matmul")
                                 else "kahan_reduce.cu"),
                "replaces": replaces[name], "path": path,
                "launches": self.launches[path][name],
                "max_abs_err": self.err[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": t["shape"]})
        return out


def paper_path(torch, kernels, card):
    """Phase 7: the paper's question on the card. B1 (dot) and B3 (sum)
    for every built-in scheme at U in ``ecm.UNROLLS``: each (s, c) grid
    bitwise equal to its plain version at ``SWEEP_PARITY_N``; each timed at
    the paper's n = 2^27 float32 (graph time) beside its bytes bound and
    the machine model's prediction (``repro_torch.core.ecm``) on this
    card's measured clock and load-only bandwidth, with one SM's load rate
    fitted on the naive dot at U = 1 and no other row; the saturation U
    predicted and measured; phase 3's B1-B4 rows beside the same model.
    Then the accuracy ladder (``LADDER_CONDS``) through ``ops.dot`` on the
    card. Raises on a parity, bound or ordering failure and on a
    prediction that is not finite; the model's error is recorded, not
    gated. Returns the JSON object ``{"ecm": [...], "phase3": [...],
    "ladder": [...]}``."""
    from repro_torch.core import ecm, numerics
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    dev, kd, ks = kernels.dev, kernels.kd, kernels.ks
    f32 = torch.float32
    wrappers = {"dot": kd.dot_accumulators, "sum": ks.sum_accumulators}
    plains = {"dot": lambda a, b, **kw: kd.dot_plain(a[None], b[None], **kw),
              "sum": lambda a, b, **kw: ks.sum_plain(a[None], **kw)}
    cases = 0
    a = kernels.data((SWEEP_PARITY_N,), f32)
    b = kernels.data((SWEEP_PARITY_N,), f32)
    for op, fn in wrappers.items():
        for name in SCHEMES:
            sch = kernels.schemes.get(name)
            for unroll in ecm.UNROLLS:
                args = (a, b) if op == "dot" else (a,)
                got = fn(*args, scheme=sch, unroll=unroll)
                want = plains[op](a, b, scheme=sch, unroll=unroll)
                kernels.compare(fn.__name__, got, (want[0][0], want[1][0]),
                                f"{name} U={unroll} [{SWEEP_PARITY_N}]")
                cases += 1
    sync(torch, dev)
    log(f"# phase 7: {cases} grids (dot and sum x {len(SCHEMES)} schemes x "
        f"U {list(ecm.UNROLLS)}) at n = {SWEEP_PARITY_N} bitwise equal to "
        f"their plain versions")

    # the machine: load-only bandwidth b_S, and the clock under load
    x = kernels.normal((LOAD_ONLY_N,))
    load_ms = graph_ms(torch, lambda: torch.sum(x))
    load_gbs = x.numel() * x.element_size() / load_ms / 1e6
    del x
    a = kernels.data((PAPER_N,), f32)
    b = kernels.data((PAPER_N,), f32)
    kahan = kernels.schemes.get("kahan")
    mhz, watts = clock_under_load(
        torch, lambda: ks.sum_accumulators(a, scheme=kahan))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    machine = dataclasses.replace(ecm.H100, sms=sms, clock_mhz=mhz,
                                  load_gbs=load_gbs, sm_load_gbs=None)
    log(f"# phase 7 machine: b_S {load_gbs:.1f} GB/s (torch.sum over "
        f"{LOAD_ONLY_N} float32, {load_ms:.4f} ms), SM clock {mhz:.0f} MHz "
        f"and {watts:.1f} W under the kahan sum, {sms} SMs; {card}")

    measured = {}
    for op, fn in wrappers.items():
        args = (a, b) if op == "dot" else (a,)
        for name in SCHEMES:
            sch = kernels.schemes.get(name)
            for unroll in ecm.UNROLLS:
                call = lambda: fn(*args, scheme=sch, unroll=unroll)  # noqa: E731,B023
                ms = graph_ms(torch, call)
                measured[(op, name, unroll)] = (ms, fn.plan, fn.copy)
    fit = ecm.fit_sm_load_gbs(machine, ecm.gpu_kernel_for_scheme(
        "naive", op="dot"), PAPER_N, 1, measured[("dot", "naive", 1)][0])
    machine = dataclasses.replace(machine, sm_load_gbs=fit)
    log(f"# phase 7 model: one SM's load rate fitted on the naive dot at U "
        f"= 1: {fit if fit is None else round(fit, 2)} GB/s (None: no limit "
        f"beyond the other terms)")

    rows = []
    for op in wrappers:
        streams = 2 if op == "dot" else 1
        for name in SCHEMES:
            kern = ecm.gpu_kernel_for_scheme(name, op=op)
            mix = kernels.schemes.get(name).instruction_mix
            top = measured[(op, name, ecm.UNROLLS[-1])][0]
            u_meas = next(u for u in ecm.UNROLLS if measured[(op, name, u)][0]
                          <= (1 + SATURATED_WITHIN) * top)
            for unroll in ecm.UNROLLS:
                ms, plan, copy = measured[(op, name, unroll)]
                r = ecm.ecm_gpu(machine, kern, PAPER_N, unroll)
                check(math.isfinite(r.pred_ms) and r.pred_ms > 0,
                      f"model: no finite prediction for {op} {name} "
                      f"U={unroll}")
                ctas = 1024 * unroll // plan[0]
                check(r.ctas == ctas and r.chains == plan[0],
                      f"model: {op} {name} U={unroll} plans {r.ctas} CTAs of "
                      f"{r.chains} chains, the wrapper launched {ctas} of "
                      f"{plan[0]}")
                cells = 1024 * unroll
                least, by = bound_ms(
                    (PAPER_N * streams + 2 * cells) * 4,
                    PAPER_N * (mix.flops if op == "dot" else mix.adds))
                err = ecm.model_relative_error(r.pred_ms, ms)
                over = ms / measured[(op, "naive", unroll)][0]
                rows.append({
                    "op": op, "scheme": name, "unroll": unroll,
                    "ctas": ctas, "sms": min(ctas, sms), "ms": ms,
                    "bound_ms": least, "model_ms": r.pred_ms,
                    "model_bound": r.bound, "model_error": err,
                    "over_naive": over,
                    "cycles_a_step": ms * mhz * 1e3 / r.steps,
                    "terms_ms": {"hbm": r.t_hbm_ms, "chain": r.t_chain_ms,
                                 "issue": r.t_issue_ms, "sm": r.t_sm_ms},
                    "u_s_model": r.u_s, "u_s_measured": u_meas})
                log(f"# phase 7 {op} {name} U={unroll}: {ctas} CTAs on "
                    f"{min(ctas, sms)} SMs (plan {plan} {copy}), {ms:.4f} "
                    f"ms ({by} bound {least:.4f}, "
                    f"{100 * least / ms:.1f}%), model "
                    f"{r.pred_ms:.4f} ({r.bound}; {r.shorthand()}), error "
                    f"{100 * err:.1f}%, over naive {over:.3f}, "
                    f"{ms * mhz * 1e3 / r.steps:.1f} cycles a step")
            log(f"# phase 7 {op} {name}: u_s model {r.u_s}, measured "
                f"{u_meas} (the least U within {100 * SATURATED_WITHIN:.0f}% "
                f"of U={ecm.UNROLLS[-1]})")
    del a, b
    beside = []
    for (kname, label), t in kernels.timing.items():
        if not kname.startswith(("dot_accumulators", "sum_accumulators")):
            continue
        shape = t["shape"]
        r = ecm.ecm_gpu_for_scheme(
            machine, t["scheme"], shape[-1], 8,
            op="dot" if kname.startswith("dot") else "sum",
            batch=shape[0] if len(shape) == 2 else 1)
        check(math.isfinite(r.pred_ms) and r.pred_ms > 0,
              f"model: no finite prediction for {kname} {label}")
        err = ecm.model_relative_error(r.pred_ms, t["ms"])
        beside.append({"name": kname, "label": label, "shape": shape,
                       "unroll": 8, "ms": t["ms"], "model_ms": r.pred_ms,
                       "model_bound": r.bound, "model_error": err})
        log(f"# phase 7 model beside phase 3: {kname} {label} {shape} U=8: "
            f"{t['ms']:.4f} ms, model {r.pred_ms:.4f} ({r.bound}), error "
            f"{100 * err:.1f}%")

    # the reference's accuracy ladder on GenDot data, through ops.dot
    t1 = time.perf_counter()
    errs, achieved, bounds = {}, {}, {}
    for cond in LADDER_CONDS:
        x, y, exact, achieved[cond] = numerics.gen_dot(
            LADDER_N, cond, seed=int(math.log10(cond)))
        xt, yt = (torch.from_numpy(v).to(dev) for v in (x, y))
        errs[cond] = {name: numerics.relative_error(
            float(ops.dot(xt, yt, scheme=name, unroll=1)), exact)
            for name in SCHEMES}
        bounds[cond] = {name: kernels.schemes.get(name).error_bound(
            LADDER_N, achieved[cond]) for name in SCHEMES}
    gen_s = time.perf_counter() - t1
    saturation = 1.0 / kernels.schemes.EPS32
    live = [c for c in LADDER_CONDS if achieved[c] < saturation]
    check(len(live) >= 2, f"ladder: only {live} of the conditions "
          f"achieved below 1/eps = {saturation:.3e} at n = {LADDER_N}; "
          f"the ordering gates would not run")
    for cond in LADDER_CONDS:
        e, ach = errs[cond], achieved[cond]
        what = f"ladder cond {cond:.0e} (achieved {ach:.3e}): {e}"
        check(e["dot2"] <= 1e-2 * e["kahan"]
              and e["dot2"] <= 1e-2 * e["naive"], what)
        if cond in live:
            check(e["kahan"] <= e["naive"]
                  and e["pairwise"] <= e["naive"] * 1.01, what)
        else:
            check(e["kahan"] <= e["naive"] * 3.0, what)
        for name in SCHEMES:
            bound = bounds[cond][name]
            check(math.isfinite(bound) and e[name] <= bound,
                  f"{name}: error {e[name]:.3e} above its a-priori bound "
                  f"{bound:.3e} at cond {cond:.0e} (achieved {ach:.3e})")
    check(errs[1e10]["kahan"] >= 100.0 * errs[1e10]["dot2"],
          f"dot2 not 2 digits below kahan at cond 1e10: {errs[1e10]}")
    for cond in LADDER_CONDS:
        log(f"# phase 7 ladder n={LADDER_N} cond {cond:.0e} (achieved "
            f"{achieved[cond]:.3e}{'' if cond in live else ', above 1/eps'}"
            f"): " + ", ".join(
                f"{k} {v:.3e} (bound {bounds[cond][k]:.2e})"
                for k, v in errs[cond].items()))
    tight = sorted({(c, k) for c in LADDER_CONDS for k in SCHEMES
                    if bounds[c][k] < 1.0})
    log(f"# phase 7: every a-priori bound holds at every condition; a bound "
        f"below 1 (one that an answer of the right magnitude could break) "
        f"only for {tight}, the others at or above 1 hold by any such "
        f"answer (GenDot's achieved condition grows with n: at least "
        f"{min(achieved.values()):.2e} at n = {LADDER_N}); the orderings "
        f"kahan <= naive and pairwise <= 1.01 naive gated at the "
        f"{len(live)} conditions achieved below 1/eps {live}, kahan <= 3 "
        f"naive above it; dot2 "
        f"{errs[1e10]['kahan'] / errs[1e10]['dot2']:.0f}x below kahan at "
        f"1e10 (GenDot {gen_s:.1f} s on the host); phase 7 took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"ecm": rows, "phase3": beside,
            "ladder": [{"cond": c, "achieved": achieved[c],
                        "errors": errs[c], "bounds": bounds[c]}
                       for c in LADDER_CONDS]}


L2_BYTES = 50e6


def cold_copies(torch, tensors):
    """Copies of ``tensors`` (the first is the tensors themselves) that
    together hold at least twice the L2 cache, so that cycling through
    them reads every operand from device memory."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, math.ceil(2 * L2_BYTES / size))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def cycle(fn, operand_sets):
    """``fn`` over the next operand set at each call."""
    state = {"i": 0}

    def call():
        args = operand_sets[state["i"] % len(operand_sets)]
        state["i"] += 1
        return fn(*args)

    return call


def serve_run(torch, kernels, cfg, model, params, trace, prefill_mode,
              max_len=None, phase="4", prepare=None, body=None, max_slots=4,
              policy=None, **engine_kw):
    """Serve ``trace`` once with every launch count reset just before and
    read just after; times every decode tick and prefill chunk. Checks
    what holds on every serving path: each request emits its tokens, the
    telemetry is finite and positive, and the sum kernel launched once
    per decode tick and once per finished prefill. ``max_len`` (default:
    fitted to the trace) and ``engine_kw`` (the paged layout's fields) go
    to the ``EngineConfig``; ``prepare(engine)`` runs before the trace;
    ``body`` is the chunk body the engine must resolve ``prefill_mode``
    to (default: ``prefill_mode`` itself); ``max_slots`` the decode
    batch (default 4); ``policy`` the engine's (default: scheme kahan,
    float32). ``captured`` holds the first and the last decode tick's
    logits and telemetry.
    Under the paged layout the stats carry the peak pages in use and
    whether a live page table was ever scattered."""
    stamp(f"phase {phase} {cfg.name}: serve {trace} ({prefill_mode}, "
          f"kahan_matmul={cfg.kahan_matmul})")
    from repro_torch.kernels import Policy
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import build_requests, parse_trace
    from repro_torch.serve import EngineConfig, InferenceEngine

    dev = kernels.dev
    cells = parse_trace(trace, 0.0)
    requests, arrivals = build_requests(cfg, cells, seed=0)
    ec = EngineConfig(max_slots=max_slots,
                      max_len=max_len or serve_max_len(trace),
                      prefill_chunk=64, track_stats=True,
                      policy=policy or Policy(scheme="kahan"),
                      prefill_mode=prefill_mode, **engine_kw)
    engine = InferenceEngine(cfg, ec, model=model, params=params)
    body = body or prefill_mode
    check(engine.prefill_body == body,
          f"engine resolved prefill body {engine.prefill_body!r}, wanted "
          f"{body!r}")
    if prepare is not None:
        prepare(engine)
    tick_ms, chunk_ms, chunk_pos, widths, positions = [], [], [], [], []
    pages = {"peak": 0, "scattered": False}
    captured = {}
    sum_kernel = kernels.engine.WRAPPERS["sum_accumulators_batched"]
    flash_kernels = [kernels.engine.WRAPPERS[n] for n in
                     ("flash_accumulators", "flash_chunk_accumulators")]

    def timed_tick(running, events, _orig=engine._decode_tick):
        before = sum_kernel.launches
        flash_before = [f.launches for f in flash_kernels]
        sync(torch, dev)
        t0 = time.perf_counter()
        _orig(running, events)
        sync(torch, dev)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        positions.append(len(running))
        check(sum_kernel.launches == before + 1,
              "the telemetry sum kernel did not launch exactly once in a "
              "decode tick")
        check([f.launches for f in flash_kernels] == flash_before,
              "a flash kernel launched in a decode tick")
        if engine.kv_layout == "paged":
            pages["peak"] = max(pages["peak"],
                                engine.page_stats()["pages_in_use"])
            for lease in engine._leases.values():
                live = [int(p) for p in lease.table[:lease.n_pages]]
                pages["scattered"] |= any(b - a != 1 for a, b in
                                          zip(live, live[1:]))

    def timed_chunk(slot, h, events, _orig=engine._run_chunk):
        start = h.prefill_pos
        sync(torch, dev)
        t0 = time.perf_counter()
        _orig(slot, h, events)
        sync(torch, dev)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        chunk_pos.append(h.prefill_pos - start)
        widths.append(engine.last_chunks[-1][1])

    def captured_norms(logits, _orig=engine._norms):
        out = _orig(logits)
        if logits.shape[0] == ec.max_slots:       # a decode tick's batch
            captured["logits"], captured["norms"] = logits.clone(), out.clone()
            captured.setdefault("first_logits", captured["logits"])
        return out

    engine._decode_tick = timed_tick
    engine._run_chunk = timed_chunk
    engine._norms = captured_norms

    reset_launch_counts()
    sync(torch, dev)
    t0 = time.perf_counter()
    served = engine.run(requests, arrivals)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = launch_counts()

    n_tok = 0
    for (arrival, plen, new, _), req in zip(cells, requests):
        h = served[req.request_id]
        check(len(h.tokens) == new, f"request {req.request_id} emitted "
              f"{len(h.tokens)} of {new} tokens")
        check(all(0 <= t < cfg.vocab_size for t in h.tokens),
              f"request {req.request_id}: token outside the vocabulary")
        check(len(h.telemetry) == new and all(math.isfinite(v) and v > 0
                                               for v in h.telemetry),
              f"request {req.request_id}: telemetry not finite")
        n_tok += len(h.tokens)
    n_ticks = len(tick_ms)
    check(counts["sum_accumulators_batched"] == n_ticks + len(cells),
          f"sum kernel launched {counts['sum_accumulators_batched']} times "
          f"for {n_ticks} decode ticks + {len(cells)} finished prefills")
    n_prompt = sum(chunk_pos)
    stats = {
        "trace": trace, "prefill_mode": prefill_mode,
        "kahan_attention": cfg.kahan_attention,
        "kahan_matmul": cfg.kahan_matmul, "requests": len(cells),
        "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "decode_ticks": n_ticks, "decode_positions": sum(positions),
        "decode_tick_ms_mean": sum(tick_ms) / max(n_ticks, 1),
        "decode_tick_ms_min": min(tick_ms, default=None),
        "decode_s": sum(tick_ms) / 1e3,
        "prefill_chunks": len(chunk_ms), "chunk_widths": widths,
        "prefill_s": sum(chunk_ms) / 1e3,
        "prefill_chunk_ms_mean": sum(chunk_ms) / len(chunk_ms),
        "prefill_ms_per_position": sum(chunk_ms) / n_prompt,
        "prompt_positions": n_prompt, "prefill_body": body,
        "prefill_positions_per_s": n_prompt / (sum(chunk_ms) / 1e3),
        "launches": counts,
        "max_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "kv_layout": engine.kv_layout, "max_len": ec.max_len,
        "slot_loop": ec.slot_loop,
        "compute_dtype": dtype_name(ec.policy.compute_dtype),
    }
    if engine.kv_layout == "paged":
        stats.update(peak_pages=pages["peak"], scattered=pages["scattered"],
                     page_stats=engine.page_stats(),
                     page_bytes=engine.slots.page_bytes)
    log(f"# phase {phase} {cfg.name} [{prefill_mode}, "
        f"kahan_attention={cfg.kahan_attention}, "
        f"kahan_matmul={cfg.kahan_matmul}, {engine.kv_layout}, "
        f"slot_loop {ec.slot_loop}, {dtype_name(ec.policy.compute_dtype)}] "
        f"{trace}: "
        f"{len(cells)} requests, {n_tok} tokens in {wall:.2f} s "
        f"({stats['tokens_per_s']:.1f} tokens/s); {len(chunk_ms)} prefill "
        f"chunks in {stats['prefill_s']:.2f} s "
        f"({stats['prefill_ms_per_position']:.3f} ms per position); "
        f"{n_ticks} decode ticks in {stats['decode_s']:.2f} s "
        f"({stats['decode_tick_ms_mean']:.2f} ms mean); launches {counts}")
    return ec, requests, served, captured, stats


def check_tick_telemetry(torch, kernels, cfg, ec, captured, phase):
    """One decode tick's telemetry (``captured`` by ``serve_run``) against
    the plain version on the same logits, bitwise."""
    stamp(f"phase {phase} {cfg.name}: the telemetry against the plain "
          f"version")
    from repro_torch.kernels.engine import Accumulator, CompensatedReduction

    logits = captured["logits"][:, :cfg.vocab_size]
    eng = CompensatedReduction(scheme=ec.policy)
    sq = eng._prep2d(logits.float() * logits.float())
    s, c = kernels.ks.sum_plain(sq, scheme=eng.scheme, unroll=eng.unroll)
    check(torch.equal(Accumulator(s, c).total(), captured["norms"]),
          f"{cfg.name}: decode-tick telemetry differs from the plain version")
    log(f"# phase {phase} {cfg.name}: one tick's telemetry bitwise equal to "
        f"the plain version")


def check_solo(cfg, ec, model, params, req, served, what, phase):
    """``req`` served alone emits bitwise the tokens and telemetry it
    emitted interleaved in ``served``."""
    stamp(f"phase {phase} {what}: request {req.request_id} alone")
    from repro_torch.serve import InferenceEngine

    solo = InferenceEngine(cfg, ec, model=model, params=params).run(
        [req])[req.request_id]
    both = served[req.request_id]
    check(solo.tokens == both.tokens,
          f"request {req.request_id}: tokens differ solo vs interleaved "
          f"({what})")
    differ = [(i, x, y) for i, (x, y) in enumerate(zip(solo.telemetry,
                                                      both.telemetry))
              if x != y]
    check(solo.telemetry == both.telemetry,
          f"request {req.request_id}: telemetry differs solo vs interleaved "
          f"({what}): (position, solo, interleaved) {differ[:4]}, "
          f"{len(solo.telemetry)} and {len(both.telemetry)} values")
    log(f"# phase {phase} [{what}]: request {req.request_id} alone == "
        f"interleaved, bitwise ({len(solo.tokens)} tokens and telemetry "
        f"values)")


def check_flash_launches(cfg, stats, what):
    """Under flash, B8 ran n_layers times per chunk of width > 1 (a
    width-1 tail runs the decode mode, as in the reference); with
    ``kahan_matmul`` B5 ran once per projection, layer, prefill chunk and
    decode position, and never without it; B6, B7 and the dot / single
    sum kernels never."""
    counts = stats["launches"]
    wide = sum(1 for w in stats["chunk_widths"] if w > 1)
    check(counts["flash_chunk_accumulators"] == cfg.n_layers * wide,
          f"{what}: B8 launched {counts['flash_chunk_accumulators']} times "
          f"for {wide} chunks x {cfg.n_layers} layers")
    units = stats["prefill_chunks"] + stats["decode_positions"]
    want = PROJECTIONS * cfg.n_layers * units if cfg.kahan_matmul else 0
    check(counts["matmul_accumulators"] == want,
          f"{what}: B5 launched {counts['matmul_accumulators']} times, "
          f"want {want} ({PROJECTIONS} x {cfg.n_layers} layers x {units} "
          f"chunks and decode positions)" if cfg.kahan_matmul else
          f"{what}: B5 launched without kahan_matmul")
    for name in ("flash_accumulators", "dot_accumulators",
                 "dot_accumulators_batched", "sum_accumulators",
                 "matmul_accumulators_batched"):
        check(counts[name] == 0,
              f"{what}: {name} launched {counts[name]} times while serving")


def main_path(torch, kernels: Kernels, cfg, paper_n):
    """Phases 4 and 5: the port's main paths, each with the launch counts
    reset just before it, then solo vs interleaved."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model

    dev = kernels.dev
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    flash_cfg = cfg.replace(kahan_attention=True)
    flash_model = build_model(flash_cfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"# phase 4: OLMo-1B {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads} ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"({cfg.padded_vocab} padded), {n_params / 1e9:.3f} B params "
        f"{cfg.param_dtype}")

    # -- serving: scan, flash on the same trace, and one long flash request
    ec, requests, served, captured, scan = serve_run(
        torch, kernels, cfg, model, params, TRACE, "scan")
    for name in kernels.engine.WRAPPERS:
        check((scan["launches"][name] > 0)
              == (name == "sum_accumulators_batched"),
              f"{name} launched {scan['launches'][name]} times while "
              f"serving under scan")
    check_tick_telemetry(torch, kernels, cfg, ec, captured, "4")
    scan["decode_position"] = profile_decode_step(torch, model, params, dev,
                                                  ec.max_len)

    fec, _, fserved, _, flash = serve_run(
        torch, kernels, flash_cfg, flash_model, params, TRACE, "flash")
    check_flash_launches(flash_cfg, flash, "flash serving")
    flash["chunk_profile"] = profile_flash_chunk(torch, flash_model, params,
                                                 dev, fec.max_len)
    agree = [sum(a == b for a, b in zip(served[r.request_id].tokens,
                                        fserved[r.request_id].tokens))
             for r in requests]
    flash["greedy_tokens_equal_to_scan"] = agree
    log(f"# phase 4: prefill {flash['prefill_ms_per_position']:.3f} ms per "
        f"position under flash vs {scan['prefill_ms_per_position']:.3f} "
        f"under scan; {flash['tokens_per_s']:.1f} vs "
        f"{scan['tokens_per_s']:.1f} tokens/s; greedy tokens equal to scan's "
        f"per request (not checked): {agree}")
    matmul_cfg = flash_cfg.replace(kahan_matmul=True)
    matmul_model = build_model(matmul_cfg, dev)
    mec, _, mserved, mcaptured, mm = serve_run(
        torch, kernels, matmul_cfg, matmul_model, params, TRACE, "flash")
    check_flash_launches(matmul_cfg, mm, "kahan_matmul serving")
    mm["decode_position"] = profile_decode_step(torch, matmul_model, params,
                                                dev, mec.max_len)
    mm["chunk_profile"] = profile_flash_chunk(torch, matmul_model, params,
                                              dev, mec.max_len)
    mm["cublas_kernels_dropped_per_position"] = (
        scan["decode_position"]["cublas_kernels"]
        - mm["decode_position"]["cublas_kernels"])
    mm["chunk_logits"] = compare_chunk_logits(torch, kernels, cfg,
                                              flash_model, matmul_model,
                                              params)
    mm["dense_enqueue_us"] = dense_enqueue_cost(torch, kernels, cfg)
    log(f"# phase 4 [kahan_matmul vs flash]: {mm['tokens_per_s']:.1f} vs "
        f"{flash['tokens_per_s']:.1f} tokens/s; decode tick "
        f"{mm['decode_tick_ms_mean']:.2f} vs "
        f"{flash['decode_tick_ms_mean']:.2f} ms mean; prefill "
        f"{mm['prefill_ms_per_position']:.3f} vs "
        f"{flash['prefill_ms_per_position']:.3f} ms per position; gemm/gemv "
        f"kernels per decode position "
        f"{mm['decode_position']['cublas_kernels']} vs "
        f"{scan['decode_position']['cublas_kernels']} (dropped "
        f"{mm['cublas_kernels_dropped_per_position']}; "
        f"{PROJECTIONS * cfg.n_layers} projections)")
    _, _, _, _, long = serve_run(torch, kernels, flash_cfg, flash_model,
                                 params, LONG_TRACE, "flash")
    check_flash_launches(flash_cfg, long, "long flash request")
    long["chunk_profile"] = profile_flash_chunk(
        torch, flash_model, params, dev, serve_max_len(LONG_TRACE))

    # -- the entry points: the paper's reductions, prefill, the veneer
    a = kernels.data((paper_n,), torch.float32)
    b = kernels.data((paper_n,), torch.float32)
    prompt = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN),
                           generator=kernels.gen, device=dev)
    heads = [kernels.normal((cfg.n_heads, PREFILL_LEN, cfg.head_dim))
             for _ in range(3)]
    hd = cfg.n_heads * cfg.head_dim
    up = [kernels.normal((PREFILL_LEN, cfg.d_model)).bfloat16(),
          kernels.normal((cfg.d_model, cfg.d_ff)).bfloat16()]
    qs = [kernels.normal((4, 64, cfg.d_model)).bfloat16(),
          kernels.normal((4, cfg.d_model, hd)).bfloat16()]
    sync(torch, dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    totals = [ops.dot(a, b), ops.asum(a),
              ops.batched_dot(a.view(8, -1), b.view(8, -1)),
              ops.batched_asum(a.view(8, -1))]
    t1 = time.perf_counter()
    flash_logits, _ = flash_model.prefill(
        params, prompt, flash_model.init_cache(1, PREFILL_LEN))
    sync(torch, dev)
    prefill_ms = (time.perf_counter() - t1) * 1e3
    veneer = flash_attention(*heads, scheme="kahan")
    t2 = time.perf_counter()
    products = [ops.matmul(*up), ops.batched_matmul(*qs)]
    sync(torch, dev)
    matmul_ms = (time.perf_counter() - t2) * 1e3
    entry_counts = launch_counts()
    kernels.launches = {"entry": entry_counts, "serve": scan["launches"],
                        "serve-flash": flash["launches"],
                        "serve-matmul": mm["launches"],
                        "serve-long": long["launches"]}
    log(f"# main path launch counts: the entry points {entry_counts} "
        f"(reductions {1e3 * (t1 - t0):.1f} ms, {PREFILL_LEN}-token flash "
        f"prefill {prefill_ms:.1f} ms)")
    for name in list(kernels.engine.WRAPPERS)[:4]:
        check(entry_counts[name] > 0,
              f"{name} never launched by the paper's entry points")
    check(entry_counts["flash_accumulators"] == cfg.n_layers + 1,
          f"B7 launched {entry_counts['flash_accumulators']} times for "
          f"{cfg.n_layers} prefill layers + 1 veneer call")
    check(entry_counts["flash_chunk_accumulators"] == 0,
          "B8 launched on the entry path")
    check(entry_counts["matmul_accumulators"] == 1
          and entry_counts["matmul_accumulators_batched"] == 1,
          f"B5 / B6 launched {entry_counts['matmul_accumulators']} / "
          f"{entry_counts['matmul_accumulators_batched']} times for one "
          f"ops.matmul and one ops.batched_matmul")
    check(all(bool(torch.isfinite(t).all())
              for t in totals + [veneer] + products),
          "non-finite result from the entry points")
    # the 2048-token up projection against float32 torch.matmul, within
    # 1e-5 of |a| @ |b| (the block products' rounding, fixed order)
    af, bf = up[0].float(), up[1].float()
    scale = torch.matmul(af.abs(), bf.abs())
    up_err = float(((products[0] - torch.matmul(af, bf)).abs()
                    / scale).max())
    log(f"# entry: ops.matmul {list(af.shape)} x {list(bf.shape)} and "
        f"ops.batched_matmul {[4, 64, cfg.d_model, hd]} in {matmul_ms:.1f} "
        f"ms; the product within {up_err:.2e} of |a| @ |b| of float32 "
        f"torch.matmul")
    check(up_err < 1e-5, f"ops.matmul differs from float32 torch.matmul by "
          f"{up_err:.2e} of |a| @ |b|")
    del af, bf, scale, products
    check(flash_logits.shape == (1, cfg.padded_vocab)
          and bool(torch.isfinite(flash_logits[:, :cfg.vocab_size]).all()),
          "prefill logits not finite / of the wrong shape")
    # the same prompt through the materialized attention core
    plain_logits, _ = model.prefill(params, prompt,
                                    model.init_cache(1, PREFILL_LEN))
    fl, pl = (x[0, :cfg.vocab_size].double() for x in (flash_logits,
                                                       plain_logits))
    rel = float((fl - pl).norm() / pl.norm())
    log(f"# entry: {PREFILL_LEN}-token prefill logits, flash vs materialized "
        f"attention: relative L2 {rel:.3e}, argmax {int(fl.argmax())} vs "
        f"{int(pl.argmax())}")
    check(rel < 0.1, f"flash prefill logits differ from the materialized "
          f"path's by {rel:.3e} (relative L2)")
    del a, b, heads

    # -- 5. solo vs interleaved ------------------------------------------------
    req0 = requests[0]
    for what, c, m, e, out in (("scan", cfg, model, ec, served),
                               ("flash", flash_cfg, flash_model, fec,
                                fserved),
                               ("kahan_matmul", matmul_cfg, matmul_model,
                                mec, mserved)):
        check_solo(c, e, m, params, req0, out, what, "5")
    # phase 14 serves the kahan_matmul run's trace again, vmapped
    kernels.phase4 = {"cfg": matmul_cfg, "model": matmul_model,
                      "params": params, "served": mserved, "stats": mm,
                      "captured": mcaptured, "flash_model": flash_model,
                      "prompt": prompt, "flash_logits": flash_logits}
    return {"scan": scan, "flash": flash, "matmul": mm, "flash_long": long,
            "entry_prefill_ms": prefill_ms, "entry_logits_rel_l2": rel,
            "entry_matmul_ms": matmul_ms, "entry_matmul_err": up_err,
            "b5_totals": kernels.matmul_totals,
            "reduce_clock": kernels.reduce_clock}


def vmap_path(torch, kernels, cfg):
    """Phase 14 (after phase 5, on phase 4's weights): the vmap dispatch,
    the vmapped slot loop and the compute dtypes of this slice on
    OLMo-1B. Returns the phase's stats."""
    t0 = time.perf_counter()
    out = {"entries": vmap_entries(torch, kernels, cfg)}
    out["serve"] = vmap_serve(torch, kernels)
    out["dtypes"] = dtype_serve(torch, kernels)
    del kernels.phase4
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 14 took {out['seconds']:.1f} s")
    return out


def vmap_entries(torch, kernels, cfg):
    """Phase 14(a): ``torch.func.vmap`` of ``ops.dot``, ``ops.asum`` and
    ``ops.matmul`` on the card, each with the launch counts reset just
    before it: exactly one launch of B2, B4 or B6 and none other, equal to
    the batched entry point and to a loop of single calls, bitwise. dot
    and asum over [8, 2^24] float32 rows; matmul over 4 chunks [64, d]
    against one unbatched bf16 weight [d, H dh] (broadcast by the rule)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts

    a = kernels.data((VMAP_ROWS, VMAP_N), torch.float32)
    b = kernels.data((VMAP_ROWS, VMAP_N), torch.float32)
    x = kernels.normal((4, 64, cfg.d_model)).bfloat16()
    w = kernels.normal((cfg.d_model, cfg.n_heads * cfg.head_dim)).bfloat16()
    cases = (
        ("vmap-dot", "dot_accumulators_batched",
         lambda: torch.func.vmap(lambda p, q: ops.dot(p, q))(a, b),
         lambda: ops.batched_dot(a, b),
         lambda: torch.stack([ops.dot(a[i], b[i])
                              for i in range(VMAP_ROWS)])),
        ("vmap-asum", "sum_accumulators_batched",
         lambda: torch.func.vmap(lambda p: ops.asum(p))(a),
         lambda: ops.batched_asum(a),
         lambda: torch.stack([ops.asum(a[i]) for i in range(VMAP_ROWS)])),
        ("vmap-matmul", "matmul_accumulators_batched",
         lambda: torch.func.vmap(lambda p: ops.matmul(p, w))(x),
         lambda: ops.batched_matmul(x, w.expand(4, *w.shape)),
         lambda: torch.stack([ops.matmul(x[i], w) for i in range(4)])))
    stats = {}
    for path, wrapper, vmapped, batched, loop in cases:
        sync(torch, kernels.dev)
        reset_launch_counts()
        got = vmapped()
        sync(torch, kernels.dev)
        counts = launch_counts()
        check(counts[wrapper] == 1 and sum(counts.values()) == 1,
              f"{path}: torch.func.vmap launched {counts}, want one "
              f"{wrapper}")
        kernels.launches[path] = counts
        check(torch.equal(got, batched()),
              f"{path}: vmapped != the batched entry point")
        check(torch.equal(got, loop()), f"{path}: vmapped != a loop of "
              f"single calls")
        stats[path] = {"launches": counts[wrapper],
                       "shape": list(got.shape)}
    kernels.path_labels[("matmul_accumulators_batched", "vmap-matmul")] = (
        "batched")
    log(f"# phase 14(a): torch.func.vmap of ops.dot and ops.asum over "
        f"[{VMAP_ROWS}, {VMAP_N}] and of ops.matmul over [4, 64, "
        f"{cfg.d_model}] x one [{cfg.d_model}, {w.shape[1]}] weight: one "
        f"B2, B4 and B6 launch each, bitwise equal to the batched entry "
        f"points and to loops of single calls")
    return stats


def check_vmap_launches(cfg, stats, what):
    """The vmapped tick runs each projection ONCE for all running slots:
    with ``kahan_matmul``, B5 7 * n_layers times a prefill chunk and a
    decode TICK; B8 n_layers times a chunk of width > 1; nothing else but
    the telemetry."""
    counts = stats["launches"]
    wide = sum(1 for w in stats["chunk_widths"] if w > 1)
    units = stats["prefill_chunks"] + stats["decode_ticks"]
    for name, want in (("flash_chunk_accumulators", cfg.n_layers * wide),
                       ("matmul_accumulators",
                        PROJECTIONS * cfg.n_layers * units),
                       ("flash_accumulators", 0), ("dot_accumulators", 0),
                       ("dot_accumulators_batched", 0),
                       ("sum_accumulators", 0),
                       ("matmul_accumulators_batched", 0)):
        check(counts[name] == want, f"{what}: {name} launched "
              f"{counts[name]} times, want {want}")


def vmap_serve(torch, kernels):
    """Phase 14(b): phase 4's trace served again with ``slot_loop="vmap"``
    (dense layout, flash prefill, ``kahan_matmul``, telemetry) on phase
    4's weights, beside phase 4's scan run of it in this call: tokens/s,
    host ms a tick, the first tick's logits (relative L2 below 5e-2 and
    the same argmax in every running row), the telemetry; one tick of 4
    slots profiled both ways; then a trace that keeps a slot PREFILLING
    between running slots (one chunk a step), where every vmapped tick
    leaves the rows of the slots it does not run bitwise as they were."""
    from repro_torch.kernels import Policy
    from repro_torch.kernels.schemes import use_policy
    from repro_torch.models.common import cache_leaves
    from repro_torch.serve.slots import gather_row

    p4 = kernels.phase4
    cfg, model, params = p4["cfg"], p4["model"], p4["params"]
    scan, sserved = p4["stats"], p4["served"]
    ec, _, served, captured, st = serve_run(
        torch, kernels, cfg, model, params, TRACE, "flash", phase="14",
        slot_loop="vmap")
    check_vmap_launches(cfg, st, "vmapped serving")
    kernels.launches["serve-vmap"] = st["launches"]
    kernels.path_labels[("matmul_accumulators", "serve-vmap")] = (
        "decode4-qkvo")
    first, sfirst = captured["first_logits"], p4["captured"]["first_logits"]
    rows = [i for i in range(ec.max_slots) if bool(sfirst[i].any())]
    rels, same = [], []
    for i in range(ec.max_slots):
        v = first[i, :cfg.vocab_size].double()
        s = sfirst[i, :cfg.vocab_size].double()
        if i in rows:
            rels.append(float((v - s).norm() / s.norm()))
            same.append(int(v.argmax()) == int(s.argmax()))
        else:
            check(not bool(v.any()), f"vmapped tick: logits in idle row {i}")
    check(rows and max(rels) < 5e-2 and all(same),
          f"vmapped first tick's logits vs scan's: relative L2 {rels}, "
          f"same argmax {same}")
    tel = {rid: max(abs(x - y) / abs(y) for x, y in zip(
        served[rid].telemetry, sserved[rid].telemetry)) for rid in served}
    agree = {rid: sum(x == y for x, y in zip(served[rid].tokens,
                                             sserved[rid].tokens))
             for rid in served}

    # one tick of 4 running slots, profiled both ways
    max_len = ec.max_len
    cache = model.init_cache(4, max_len)
    toks = torch.ones(4, dtype=torch.long, device=kernels.dev)
    pos = torch.tensor([40, 60, 80, 100], device=kernels.dev)
    one = [gather_row(cache, s) for s in range(4)]
    with use_policy(Policy(scheme="kahan")):
        ticks = {
            "vmap": profile_step(
                torch, kernels.dev,
                lambda i: model.decode_step(params, cache, toks, pos),
                "phase 14 vmapped tick (4 slots)"),
            "scan": profile_step(
                torch, kernels.dev,
                lambda i: [model.decode_step(params, one[s], toks[s:s + 1],
                                             int(pos[s]))
                           for s in range(4)],
                "phase 14 scanned tick (4 slots)")}
    del cache, one

    # a PREFILLING row between running rows keeps its bits across ticks
    seen = {"ticks": 0, "between": 0}

    def spy_on(engine):
        orig = engine._vmapped_step

        def spy(running, logits):
            idle = [s for s in range(engine.ec.max_slots) if s not in running]
            before = {s: [t.clone() for t in cache_leaves(
                gather_row(engine.slots.cache, s))] for s in idle}
            orig(running, logits)
            for s in idle:
                check(all(torch.equal(x, y) for x, y in zip(
                    before[s], cache_leaves(gather_row(engine.slots.cache,
                                                       s)))),
                      f"a vmapped tick changed slot {s}'s row, which it does "
                      f"not run")
            seen["ticks"] += 1
            pre = [s for s in engine.scheduler.prefilling]
            seen["between"] += any(min(running) < s < max(running)
                                   for s in pre)

        engine._vmapped_step = spy

    _, _, _, _, pst = serve_run(
        torch, kernels, cfg, model, params, VMAP_PREFILL_TRACE, "flash",
        phase="14", slot_loop="vmap", prefill_budget=1, prepare=spy_on)
    check(seen["between"] > 0, f"no vmapped tick ran with a PREFILLING slot "
          f"between running ones ({seen})")
    stats = {"serve": st, "scan_tokens_per_s": scan["tokens_per_s"],
             "scan_decode_tick_ms_mean": scan["decode_tick_ms_mean"],
             "first_tick_rel_l2": rels, "first_tick_same_argmax": same,
             "telemetry_max_rel_vs_scan": tel,
             "greedy_tokens_equal_to_scan": agree, "tick_profile": ticks,
             "prefilling_check": dict(seen, trace=VMAP_PREFILL_TRACE,
                                      tokens_per_s=pst["tokens_per_s"])}
    log(f"# phase 14(b) [vmap vs scan, flash + kahan_matmul, dense] {TRACE}: "
        f"{st['tokens_per_s']:.1f} vs {scan['tokens_per_s']:.1f} tokens/s; "
        f"decode tick {st['decode_tick_ms_mean']:.2f} vs "
        f"{scan['decode_tick_ms_mean']:.2f} ms mean (host clock); a 4-slot "
        f"tick {ticks['vmap']['host_ms']:.2f} vs {ticks['scan']['host_ms']:.2f}"
        f" ms host, {ticks['vmap']['device_busy_ms'] or 0:.3f} vs "
        f"{ticks['scan']['device_busy_ms'] or 0:.3f} ms device busy; first "
        f"tick's logits vs scan's: relative L2 {rels}, same argmax {same}; "
        f"telemetry max relative difference per request {tel}; greedy "
        f"tokens equal to scan's per request {agree}; {seen['ticks']} "
        f"vmapped ticks of {VMAP_PREFILL_TRACE} (one chunk a step) left "
        f"every row they do not run bitwise as it was, {seen['between']} "
        f"with a PREFILLING slot between running ones")
    return stats


def dtype_serve(torch, kernels):
    """Phase 14(c): one short request (``DTYPE_TRACE``) on phase 4's
    weights with flash prefill and ``kahan_matmul`` under
    ``Policy(compute_dtype="bfloat16")`` and again under "float64", the
    launch counts reset just before each: B5 7 times a layer and a chunk
    or decode position, B8 n_layers times a chunk, B4 once a tick and
    finished prefill, each of B5's and B8's launches in that compute
    dtype (counted by wrapping their ``_launch``); then phase 4's
    2048-token ``TransformerLM.prefill`` under the same policy (B7 once a
    layer, in that dtype), its logits finite and beside phase 4's
    float32 ones."""
    from repro_torch.kernels import Policy
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts
    from repro_torch.kernels.schemes import use_policy

    p4 = kernels.phase4
    cfg, model, params = p4["cfg"], p4["model"], p4["params"]
    km, fa = kernels.km, kernels.fa
    stats = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float64, "f64")):
        seen, rows = {}, {}
        orig_mm, orig_fa = km._launch, fa._launch

        def mm_spy(a, b, *, compute_dtype, counter, **kw):
            key = ("matmul", dtype_name(compute_dtype))
            seen[key] = seen.get(key, 0) + 1
            rows[a.shape[1]] = rows.get(a.shape[1], 0) + 1
            return orig_mm(a, b, compute_dtype=compute_dtype,
                           counter=counter, **kw)

        def fa_spy(q, k, v, **kw):
            key = ("flash", dtype_name(q.dtype))
            seen[key] = seen.get(key, 0) + 1
            return orig_fa(q, k, v, **kw)

        km._launch, fa._launch = mm_spy, fa_spy
        try:
            _, requests, served, _, st = serve_run(
                torch, kernels, cfg, model, params, DTYPE_TRACE, "flash",
                phase="14", policy=Policy(scheme="kahan",
                                          compute_dtype=dtype_name(dtype)))
        finally:
            km._launch, fa._launch = orig_mm, orig_fa
        path = f"serve-{tag}"
        check_flash_launches(cfg, st, path)
        counts = st["launches"]
        check(seen == {("matmul", dtype_name(dtype)):
                       counts["matmul_accumulators"],
                       ("flash", dtype_name(dtype)):
                       counts["flash_chunk_accumulators"]}
              and counts["matmul_accumulators"] > 0
              and counts["flash_chunk_accumulators"] > 0,
              f"{path}: B5 / B8 launches by compute dtype {seen}, counts "
              f"{counts}")
        # B5 a chunk (M 64, the tiles) apart from a decode position (M 1,
        # the rows path): 7 a layer each
        _, prompt, new = (int(x) for x in DTYPE_TRACE.split(":"))
        per = PROJECTIONS * cfg.n_layers
        want_rows = {64: per * (prompt // 64), 1: per * (new - 1)}
        check(rows == want_rows, f"{path}: B5 launches by M {rows}, want "
              f"{want_rows}")
        kernels.launches[path] = counts
        for name in ("sum_accumulators_batched", "flash_chunk_accumulators"):
            kernels.path_labels[(name, path)] = path
        kernels.path_labels[("matmul_accumulators", path)] = (
            f"decode-qkvo-{tag}")
        h = served[requests[0].request_id]
        stats[tag] = {"serve": st, "tokens": h.tokens,
                      "telemetry": h.telemetry,
                      "launches_by_dtype": {f"{k[0]}:{k[1]}": n
                                            for k, n in seen.items()},
                      "b5_launches_by_m": rows}
        log(f"# phase 14(c) [{dtype_name(dtype)} compute] {DTYPE_TRACE}: "
            f"tokens {h.tokens}, telemetry {h.telemetry[:3]}...; B5 and B8 "
            f"launches by compute dtype {seen}; B5 by M {rows} (M 64 on "
            f"kahan_matmul_grid, M 1 on kahan_matmul_rows)")

        fmodel, prompt = p4["flash_model"], p4["prompt"]
        seen.clear()
        fa._launch = fa_spy
        try:
            sync(torch, kernels.dev)
            reset_launch_counts()
            t0 = time.perf_counter()
            with use_policy(Policy(scheme="kahan",
                                   compute_dtype=dtype_name(dtype))):
                logits, _ = fmodel.prefill(
                    params, prompt, fmodel.init_cache(1, prompt.shape[1]))
            sync(torch, kernels.dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
        finally:
            fa._launch = orig_fa
        counts = launch_counts()
        ppath = f"prefill-{tag}"
        check(counts["flash_accumulators"] == cfg.n_layers
              and sum(counts.values()) == cfg.n_layers
              and seen == {("flash", dtype_name(dtype)): cfg.n_layers},
              f"{ppath}: launches {counts}, by compute dtype {seen}")
        kernels.launches[ppath] = counts
        kernels.path_labels[("flash_accumulators", ppath)] = f"entry-{tag}"
        got = logits[0, :cfg.vocab_size].double()
        ref = p4["flash_logits"][0, :cfg.vocab_size].double()
        check(bool(torch.isfinite(got).all()),
              f"{ppath}: prefill logits not finite")
        rel = float((got - ref).norm() / ref.norm())
        stats[tag].update(prefill_ms=prefill_ms, prefill_rel_l2_vs_f32=rel,
                          prefill_same_argmax=int(got.argmax())
                          == int(ref.argmax()))
        log(f"# phase 14(c) [{dtype_name(dtype)} compute] the "
            f"{prompt.shape[1]}-token TransformerLM.prefill: {prefill_ms:.1f} "
            f"ms, B7 {cfg.n_layers} times in {dtype_name(dtype)}; logits vs "
            f"phase 4's float32 compute: relative L2 {rel:.3e}, argmax "
            f"{int(got.argmax())} vs {int(ref.argmax())}")
    return stats


def train_path(torch, kernels, cfg):
    """Phase 6: OLMo-1B trained by the port's ``Trainer`` at full width
    and depth, run A (cuBLAS projections, KahanAdamW with the compensated
    tree norm: the column-scan kernel) and run B (``kahan_matmul``: every
    projection, its recompute and its backward on B5; the engine-folded
    norm: B3 once a leaf), each with the launch counts reset just before
    it; then the norm as a loop and as a kernel, and a crash-restart at
    the smoke config."""
    from repro_torch.optim import AdamWConfig

    dev = kernels.dev
    a = train_run(torch, kernels, cfg, AdamWConfig(lr=TRAIN_LR), "A")
    b = train_run(torch, kernels, cfg.replace(kahan_matmul=True),
                  AdamWConfig(lr=TRAIN_LR, kahan_norm=False), "B")
    leaves, tall = a.pop("leaves"), a.pop("tall_leaves")
    b.pop("leaves"), b.pop("tall_leaves")
    for run in (a, b):
        losses = run["loss"]
        check(all(math.isfinite(x) for x in losses + run["grad_norm"]),
              f"run {run['name']}: a loss or grad norm is not finite")
        check(losses[-1] < losses[0],
              f"run {run['name']}: the step-{TRAIN_STEPS} loss "
              f"{losses[-1]:.4f} is not below the step-1 loss "
              f"{losses[0]:.4f}")
    rel = abs(b["loss"][0] - a["loss"][0]) / a["loss"][0]
    check(rel < STEP1_LOSS_RTOL,
          f"run B's step-1 loss {b['loss'][0]:.6f} differs from run A's "
          f"{a['loss'][0]:.6f} by {rel:.2e} (relative)")
    rel_g = abs(b["grad_norm"][0] - a["grad_norm"][0]) / a["grad_norm"][0]
    check(rel_g < STEP1_GRAD_NORM_RTOL,
          f"run B's step-1 grad norm {b['grad_norm'][0]:.6f} differs from "
          f"run A's {a['grad_norm'][0]:.6f} by {rel_g:.2e} (relative)")
    b5 = 4 * PROJECTIONS * cfg.n_layers * TRAIN_MICRO
    ca, cb = a["launches"], b["launches"]
    check(cb["matmul_accumulators"] == TRAIN_STEPS * b5,
          f"run B launched B5 {cb['matmul_accumulators']} times in "
          f"{TRAIN_STEPS} steps, not {TRAIN_STEPS} x {b5}")
    check(cb["sum_accumulators"] == TRAIN_STEPS * leaves,
          f"run B launched B3 {cb['sum_accumulators']} times in "
          f"{TRAIN_STEPS} steps, not {TRAIN_STEPS} x {leaves} leaves")
    check(ca["column_sq_accumulators"] == TRAIN_STEPS * tall,
          f"run A launched the column scan {ca['column_sq_accumulators']} "
          f"times in {TRAIN_STEPS} steps, not {TRAIN_STEPS} x {tall}")
    for run, allowed in ((a, {"column_sq_accumulators"}),
                         (b, {"matmul_accumulators", "sum_accumulators"})):
        for name, n in run["launches"].items():
            check(n == 0 or name in allowed,
                  f"run {run['name']}: {name} launched {n} times")
    log(f"# phase 6: run B's step-1 loss within {rel:.2e} of run A's "
        f"(limit {STEP1_LOSS_RTOL}), its grad norm within {rel_g:.2e} "
        f"(limit {STEP1_GRAD_NORM_RTOL}); B5 {b5} and B3 {leaves} launches a "
        f"step, the column scan {tall}; losses fall in both runs")
    kernels.launches["train-a"] = ca
    kernels.launches["train-b"] = cb
    stamp("phase 6: the crash-restart")
    resume = resume_check(torch, dev)
    return {"A": a, "B": b, "step1_loss_rel": rel,
            "step1_grad_norm_rel": rel_g, "resume": resume,
            "b5_launches_per_step": b5, "b3_launches_per_step": leaves}


def train_run(torch, kernels, cfg, opt, name):
    """One training run of ``TRAIN_STEPS`` steps through ``Trainer.run``,
    launch counts reset just before and read just after; its
    ``failure_hook`` synchronises and marks each step's start. Then one
    more step under the profiler (device-busy time, kernel time by name)
    and, for run A, the norm as a loop and as a kernel."""
    import gc

    from repro_torch.core import tree as T
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts
    from repro_torch.optim import apply_update
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.trainer import batch_to_device

    dev = kernels.dev
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tc = TrainConfig(steps=TRAIN_STEPS, microbatches=TRAIN_MICRO, warmup=1,
                     log_every=1, ckpt_every=10 ** 9, opt=opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    marks = []

    def mark(step):
        sync(torch, dev)
        marks.append(time.perf_counter())

    stamp(f"phase 6 run {name}: the trainer")
    trainer = Trainer(cfg, tc, data, failure_hook=mark, seed=0, device=dev)
    sync(torch, dev)
    stamp(f"phase 6 run {name}: {TRAIN_STEPS} steps")
    reset_launch_counts()
    trainer.run()
    sync(torch, dev)
    marks.append(time.perf_counter())
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    step_ms = [(y - x) * 1e3 for x, y in zip(marks, marks[1:])]
    hist = trainer.metrics_history
    t0 = time.perf_counter()
    batch = batch_to_device(data.batch_at(TRAIN_STEPS), dev)
    data_ms = (time.perf_counter() - t0) * 1e3
    stamp(f"phase 6 run {name}: the profiled step")
    prof = profile_once(torch, dev, lambda: trainer.step_fn(
        trainer.params, trainer.opt_state, batch))
    # the optimizer step alone, on a tree of the gradients' shapes (the
    # first moments' copy)
    grads = T.tree_map(torch.clone, trainer.opt_state.m)
    opt_prof = profile_once(torch, dev, lambda: apply_update(
        opt, trainer.params, grads, trainer.opt_state))
    del grads
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = step_ms[1:]
    wall = sum(steady) / len(steady)
    leaves = T.leaves(trainer.params)
    out = {"name": name, "kahan_matmul": cfg.kahan_matmul,
           "kahan_norm": opt.kahan_norm,
           "loss": [m["loss"] for m in hist],
           "grad_norm": [m["grad_norm"] for m in hist],
           "step_ms": step_ms, "wall_ms_per_step": wall,
           "tokens_per_s": tokens / wall * 1e3,
           "batch_host_ms": data_ms,
           "device_busy_ms_per_step": prof["busy_ms"],
           "device_busy_share": prof["busy_ms"] / wall,
           "profiled_step_ms": prof["host_ms"],
           "kernel_ms_per_step": prof["by_kernel"],
           "top_kernels_ms": prof["top"],
           "optimizer_ms": opt_prof["host_ms"],
           "optimizer_device_ms": opt_prof["busy_ms"],
           "optimizer_top_kernels_ms": opt_prof["top"],
           "peak_bytes": peak, "peak_share": peak / total,
           "launches": counts,
           "leaves": len(leaves),
           "tall_leaves": sum(x.dim() >= 2 and x.shape[0] > 1
                              for x in leaves)}
    log(f"# phase 6 run {name} (kahan_matmul={cfg.kahan_matmul}, "
        f"kahan_norm={opt.kahan_norm}): {wall:.1f} ms a step after the "
        f"first ({step_ms[0]:.1f} the first; batch made on the host in "
        f"{data_ms:.1f} ms), {out['tokens_per_s']:.0f} tokens/s, device "
        f"busy {prof['busy_ms']:.1f} ms a step ({100 * out['device_busy_share']:.1f}%), "
        f"peak {peak / 2 ** 30:.2f} GiB ({100 * peak / total:.1f}% of the "
        f"card); loss {[round(x, 4) for x in out['loss']]}, grad norm "
        f"{[round(x, 4) for x in out['grad_norm']]}")
    log(f"# phase 6 run {name}: kernels in the profiled step "
        f"{prof['by_kernel']}; top {prof['top']}; the optimizer step alone "
        f"{opt_prof['host_ms']:.1f} ms, {opt_prof['busy_ms']:.1f} ms of it "
        f"on the device, top {opt_prof['top']}")
    if name == "A":
        stamp("phase 6: the norm as a loop and as a kernel")
        out["norm"] = norm_loop_vs_kernel(torch, kernels, trainer.opt_state.m)
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: kernel names of the port's wrappers in a profiler trace
PORT_KERNELS = {"kahan_matmul": "B5", "kahan_sum_grid": "B3",
                "kahan_sq_columns": "column scan"}


def device_events(torch, dev, fn):
    """One call of ``fn`` under ``torch.profiler``: its host ms and the
    device kernels it ran, ``[(ms, name, count)]`` (none on the CPU). On
    the card it records the device's activity alone: what is read here,
    without the host operators whose recording and sorting took most of
    a profiled train step's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA if dev.type == "cuda"
                  else ProfilerActivity.CPU]
    sync(torch, dev)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        host_ms = (time.perf_counter() - t0) * 1e3
    # the recorded activities summed by name, as ``key_averages()`` sums
    # them, without building its Python event tree (seconds a step with
    # tens of thousands of kernels; since PR 32)
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_hidden_event():
            got = by_name.setdefault(e.name(), [0, 0])
            got[0] += e.duration_ns()
            got[1] += 1
    return host_ms, [(ns / 1e6, name, n) for name, (ns, n) in by_name.items()]


def profile_once(torch, dev, fn):
    """One call of ``fn`` under ``torch.profiler``: host ms, device-busy
    ms (the sum of device kernel times) and the port's kernels' ms and
    counts by name."""
    host_ms, events = device_events(torch, dev, fn)
    by_kernel = {}
    for ms, key, n in events:
        for part, label in PORT_KERNELS.items():
            if part in key:
                got = by_kernel.setdefault(label, [0.0, 0])
                got[0] += ms
                got[1] += n
    top = [[key[:60], ms, n] for ms, key, n in sorted(events,
                                                       reverse=True)[:6]]
    return {"host_ms": host_ms, "busy_ms": sum(e[0] for e in events),
            "by_kernel": by_kernel, "top": top}


def norm_loop_vs_kernel(torch, kernels, tree):
    """The compensated tree norm of a float32 tree of the gradients'
    shapes (run A's first moments) as the kernel runs it
    (``tree_kahan_sq_norm``: one column-scan launch a leaf), and the
    plain loop over the rows of the leaf phase 3's train row is timed at
    (the embedding's [V_pad, d]; phase 2 holds the scan to its loop on
    the other kinds of leaf): its (s, c) vectors bitwise equal the
    kernel's, and its time is that row's plain time."""
    from repro_torch.core import tree as T
    from repro_torch.core.kahan import column_sq_plain, tree_kahan_sq_norm
    from repro_torch.kernels.kahan_columns import column_sq_accumulators

    dev = kernels.dev
    tree_kahan_sq_norm(tree)
    sync(torch, dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    norm = tree_kahan_sq_norm(tree)
    end.record()
    sync(torch, dev)
    kernel_ms = start.elapsed_time(end)
    row = kernels.timing[("column_sq_accumulators", "train")]
    tall = [leaf for leaf in T.leaves(tree)
            if leaf.dim() >= 2 and leaf.shape[0] > 1]
    leaf = next(x for x in tall if list(x.shape) == list(row["shape"]))
    want = column_sq_accumulators(leaf)
    sync(torch, dev)
    t0 = time.perf_counter()
    got = column_sq_plain(leaf)
    sync(torch, dev)
    loop_ms = (time.perf_counter() - t0) * 1e3
    kernels.compare("column_sq_accumulators", want, got,
                    f"run A's {list(leaf.shape)} leaf")
    row["plain_ms"] = loop_ms
    log(f"# phase 6: the compensated tree norm ({float(norm):.6e}) "
        f"{kernel_ms:.3f} ms a step through the column-scan kernel "
        f"({len(tall)} leaves); the plain loop over the rows of its "
        f"{list(leaf.shape)} leaf {loop_ms:.1f} ms, (s, c) bitwise equal to "
        f"the kernel's")
    return {"kernel_ms": kernel_ms, "loop_ms": loop_ms,
            "loop_shape": list(leaf.shape), "tall_leaves": len(tall)}


def resume_check(torch, dev, arch="olmo-1b"):
    """At ``arch``'s smoke config on the card: a run that crashes after
    step 2 (``FailureInjector``) and resumes from its checkpoint under
    ``run_with_restarts`` reaches step 4 with params and optimizer state
    bitwise equal to the uninterrupted run's (``kahan_matmul`` on, so B5
    and the one-hot embedding backward are in the step; at a MoE config
    the fixed-order backward of the dispatch and the pick too)."""
    import tempfile

    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.ft import FailureInjector, run_with_restarts
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke(arch).replace(kahan_matmul=True)

    def make(ckpt_dir, hook=None):
        tc = TrainConfig(steps=4, microbatches=2, warmup=1, log_every=1,
                         ckpt_every=2, ckpt_dir=ckpt_dir,
                         opt=AdamWConfig(lr=1e-3))
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=8))
        return Trainer(cfg, tc, data, failure_hook=hook, seed=0, device=dev)

    with tempfile.TemporaryDirectory() as tmp:
        ref = make(os.path.join(tmp, "ref"))
        ref.run()
        injector = FailureInjector(fail_at=[2])
        resumed, restarts = run_with_restarts(
            lambda: make(os.path.join(tmp, "ft"), injector), max_restarts=2)
    check(restarts == 1 and resumed.step == 4,
          f"crash-restart ({arch}): {restarts} restarts, step "
          f"{resumed.step}")
    pairs = list(zip(T.leaves((ref.params, ref.opt_state)),
                     T.leaves((resumed.params, resumed.opt_state))))
    same = sum(torch.equal(x, y) for x, y in pairs)
    check(same == len(pairs),
          f"crash-restart ({arch}): {len(pairs) - same} of {len(pairs)} "
          f"param / optimizer leaves differ from the uninterrupted run")
    log(f"# a {arch} smoke-config run crashed after step 2 resumed to step "
        f"4 with all {len(pairs)} param and optimizer leaves bitwise equal "
        f"to the uninterrupted run's")
    return {"arch": arch, "leaves": len(pairs), "restarts": restarts}


def dense_enqueue_cost(torch, kernels, cfg, calls=200):
    """Host microseconds to enqueue one decode q projection (``dense`` on
    [1, 1, d] bf16 against [d, H, dh] bf16), plain (cuBLAS) and
    compensated (B5 through ``ops.matmul``): ``calls`` calls on the host
    clock without a synchronise, then the total once the card is done."""
    from repro_torch.models.layers import dense

    x = kernels.normal((1, 1, cfg.d_model)).bfloat16()
    p = {"w": kernels.normal((cfg.d_model, cfg.n_heads,
                              cfg.head_dim)).bfloat16()}
    out = {}
    for compensated in (False, True):
        fn = lambda: dense(p, x, torch.bfloat16,  # noqa: E731
                           compensated=compensated)
        fn()
        sync(torch, kernels.dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        enqueued = time.perf_counter() - t0
        sync(torch, kernels.dev)
        total = time.perf_counter() - t0
        key = "compensated" if compensated else "plain"
        out[key] = {"enqueue_us": enqueued / calls * 1e6,
                    "total_us": total / calls * 1e6}
    log(f"# phase 4: one decode q projection, host us per call (enqueue / "
        f"total): plain {out['plain']['enqueue_us']:.1f} / "
        f"{out['plain']['total_us']:.1f}, compensated "
        f"{out['compensated']['enqueue_us']:.1f} / "
        f"{out['compensated']['total_us']:.1f}")
    return out


def compare_chunk_logits(torch, kernels, cfg, flash_model, matmul_model,
                         params, phase="4"):
    """One 64-token chunk at offset 0 through the flash model and the
    ``kahan_matmul`` model: the last position's logits within 5e-2
    (relative L2) and the same argmax."""
    w = 64
    toks = torch.randint(0, cfg.vocab_size, (1, w), generator=kernels.gen,
                         device=kernels.dev)
    out = []
    for m in (flash_model, matmul_model):
        logits, _ = m.prefill_chunk_parallel(params, toks,
                                             m.init_cache(1, w), 0, w)
        out.append(logits[0, :cfg.vocab_size].double())
    fl, ml = out
    rel = float((ml - fl).norm() / fl.norm())
    same = int(ml.argmax()) == int(fl.argmax())
    log(f"# phase {phase} {cfg.name}: a {w}-token chunk's logits with "
        f"kahan_matmul vs flash: "
        f"relative L2 {rel:.3e}, argmax {int(ml.argmax())} vs "
        f"{int(fl.argmax())}")
    check(rel < 5e-2 and same, f"kahan_matmul chunk logits "
          f"differ from the flash run's: relative L2 {rel:.3e}, same argmax "
          f"{same}")
    return {"rel_l2": rel, "same_argmax": same}


def profile_step(torch, dev, step, what, reps=5):
    """Host time and device-busy time of ``step(i)``: host time is the mean
    of ``reps`` unprofiled calls after one warm-up; device-busy time sums
    the device kernels ``torch.profiler`` records in one more call (None
    when it records no device time)."""
    step(0)                                             # warm-up
    sync(torch, dev)
    t0 = time.perf_counter()
    for i in range(1, reps + 1):
        step(i)
    sync(torch, dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    _, kernels = device_events(torch, dev, lambda: step(reps + 1))
    busy_ms = sum(k[0] for k in kernels)
    top = sorted(kernels, reverse=True)[:6]
    out = {"host_ms": host_ms,
           "device_busy_ms": busy_ms or None,
           "device_idle_share": 1 - busy_ms / host_ms if busy_ms else None,
           "device_kernels": sum(k[2] for k in kernels),
           "cublas_kernels": sum(n for _, key, n in kernels
                                 if is_cublas(key)),
           "top_kernels_ms": [[name[:60], ms, n] for ms, name, n in top]}
    log(f"# {what}: {host_ms:.2f} ms host clock, device busy "
        f"{busy_ms:.3f} ms in {out['device_kernels']} kernels "
        f"({out['cublas_kernels']} gemm/gemv); top {out['top_kernels_ms']}")
    return out


def is_cublas(kernel_name: str) -> bool:
    """A cuBLAS / cuBLASLt product kernel: gemm and gemv kernels, and the
    ``nvjet`` kernels cuBLASLt runs on Hopper."""
    name = kernel_name.lower()
    return any(word in name for word in ("gemm", "gemv", "nvjet"))


def profile_decode_step(torch, model, params, dev, max_len, prepare=None):
    """One batch-1 decode position: the unit a decode tick runs per slot
    and scan prefill per prompt position. ``prepare(cache)`` fills the
    cache first (an encoder-decoder's ``prefill_begin``)."""
    stamp(f"a profiled decode position of {type(model).__name__}")
    cache = model.init_cache(1, max_len)
    if prepare is not None:
        prepare(cache)
    tok = torch.tensor([1], device=dev)
    return profile_step(
        torch, dev, lambda i: model.decode_step(params, cache, tok, i),
        "decode position")


def profile_flash_chunk(torch, model, params, dev, max_len):
    """One 64-token flash prefill chunk, the last full chunk of a prompt
    that fills a ``max_len`` cache (the unit flash prefill runs per
    chunk)."""
    w = min(64, max_len)
    off = (max_len - w) // w * w
    cache = model.init_cache(1, max_len)
    toks = torch.ones((1, w), dtype=torch.long, device=dev)
    return profile_step(
        torch, dev,
        lambda i: model.prefill_chunk_parallel(params, toks, cache, off, w),
        f"flash chunk of {w} at offset {off} (cache {max_len})")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -- 9. the dense family and the paged layout ---------------------------------

def slice_max_len(cfg) -> int:
    """The cache length phase 9 serves ``cfg``'s trace with (the paged run
    on deepseek-7b must match the dense one's cache length)."""
    return page_max_len(slice_trace(cfg))


def page_max_len(trace: str) -> int:
    """The cache length a trace is served with: fitted to the trace,
    rounded up to a page."""
    return -(-serve_max_len(trace) // PAGE_SIZE) * PAGE_SIZE


def slice_trace(cfg) -> str:
    """Three staggered requests, 8 new tokens each: prompts of 48, 96 and
    160 tokens, or for a VLM config its patch positions plus 32 text
    tokens (the patches spliced over the first positions)."""
    if cfg.vision is None:
        return SLICE_TRACE
    plen = cfg.vision.n_patches + SLICE_VLM_TEXT
    return ",".join(f"{a}:{plen}:{SLICE_NEW}" for a in range(3))


def slice_path(torch, kernels):
    """Phase 9: each config of ``SLICE_ARCHS`` at its published width and
    depth (bf16, random weights from seed 0) serving its trace under
    flash prefill with ``kahan_attention`` (``max_slots=4``,
    ``prefill_chunk=64``, telemetry, kahan, U = 8), each path with the
    launch counts reset just before it; then the paged layout on
    deepseek-7b. Returns the phase's stats."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = kernels.dev
    t0 = time.perf_counter()
    out = {}
    for name in SLICE_ARCHS:
        cfg = get_config(name).replace(kahan_attention=True)
        max_len = slice_max_len(cfg)
        stamp(f"phase 9 {name}")
        kernels.slice_times(cfg, max_len)
        # an engine and its timing wrappers form a reference cycle that
        # holds the last config's params until a collection
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = build_model(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        stats = slice_config(torch, kernels, cfg, model, params, max_len)
        if name == "deepseek-7b":
            stats["paged"] = paged_path(torch, kernels, cfg, model, params,
                                        max_len, stats["served"],
                                        stats["serve"])
        stats.pop("served")
        stats["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"# phase 9 {name}: {cfg.n_layers}L d={cfg.d_model} "
            f"H={cfg.n_heads}/{cfg.n_kv_heads} dh={cfg.head_dim} "
            f"ff={cfg.d_ff} vocab={cfg.vocab_size}: params "
            f"{stats['params_gib']:.2f} GiB, peak {stats['peak_gib']:.2f} "
            f"GiB, {stats['serve']['tokens_per_s']:.1f} tokens/s, decode "
            f"tick {stats['serve']['decode_tick_ms_mean']:.2f} ms mean, "
            f"prefill {stats['serve']['prefill_ms_per_position']:.3f} ms "
            f"per position")
        out[name] = stats
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 9 took {out['seconds']:.1f} s")
    return out


def slice_config(torch, kernels, cfg, model, params, max_len):
    """Phase 9 (a) for one config: its trace under flash (B8 n_layers
    times a chunk, B4 once a tick and finished prefill, nothing else),
    one tick's telemetry against the plain version, request 0 alone ==
    interleaved, and a 64-token chunk's flash logits within phase 4's
    tolerance of the scan path's; for qwen2.5-3b one request with
    ``kahan_matmul`` as well (the QKV bias after B5)."""
    path = f"serve-{cfg.name}"
    ec, requests, served, captured, st = serve_run(
        torch, kernels, cfg, model, params, slice_trace(cfg), "flash",
        max_len=max_len, phase="9")
    check_flash_launches(cfg, st, path)
    kernels.launches[path] = st["launches"]
    for name in ("sum_accumulators_batched", "flash_chunk_accumulators"):
        kernels.path_labels[(name, path)] = path
    check_tick_telemetry(torch, kernels, cfg, ec, captured, "9")
    check_solo(cfg, ec, model, params, requests[0], served, cfg.name, "9")
    stats = {"params_gib": sum(t.numel() * t.element_size()
                               for t in _leaves(params)) / 2**30,
             "serve": st, "served": served,
             "chunk_logits": scan_vs_flash_chunk(torch, kernels, cfg, model,
                                                 params, requests[-1])}
    if cfg.name == "qwen2.5-3b":
        from repro_torch.models import build_model

        mcfg = cfg.replace(kahan_matmul=True)
        mmodel = build_model(mcfg, kernels.dev)
        trace = SLICE_TRACE.split(",")[0]
        mpath = f"{path}-matmul"
        _, _, _, _, mst = serve_run(torch, kernels, mcfg, mmodel, params,
                                    trace, "flash", max_len=max_len,
                                    phase="9")
        check_flash_launches(mcfg, mst, mpath)
        kernels.launches[mpath] = mst["launches"]
        kernels.path_labels[("sum_accumulators_batched", mpath)] = path
        kernels.path_labels[("flash_chunk_accumulators", mpath)] = path
        # q and o, launched most beside k and v: phase 3's [1, 2048] x
        # [2048, 2048] decode row
        kernels.path_labels[("matmul_accumulators", mpath)] = "decode-qkvo"
        stats["matmul"] = mst
        stats["matmul_chunk_logits"] = compare_chunk_logits(
            torch, kernels, cfg, model, mmodel, params, phase="9")
    return stats


def scan_vs_flash_chunk(torch, kernels, cfg, model, params, req):
    """The first 64-token chunk of ``req`` (the trace's longest prompt,
    with its patch embeddings) through the flash body and through the
    scan body (64 decode steps):
    the last position's logits within phase 4's tolerance (relative L2
    below 5e-2)."""
    w = min(64, len(req.prompt))
    toks = torch.as_tensor(req.prompt[:w], dtype=torch.long,
                           device=kernels.dev)[None]
    extras = {k: torch.as_tensor(v, device=kernels.dev)[None]
              for k, v in (req.extras or {}).items()}
    out = []
    for body in (model.prefill_chunk_parallel, model.prefill_chunk):
        logits, _ = body(params, toks, model.init_cache(1, w), 0, w,
                         **extras)
        out.append(logits[0, :cfg.vocab_size].double())
    fl, sl = out
    rel = float((fl - sl).norm() / sl.norm())
    same = int(fl.argmax()) == int(sl.argmax())
    log(f"# phase 9 {cfg.name}: a {w}-token chunk's logits, flash vs scan: "
        f"relative L2 {rel:.3e}, argmax {int(fl.argmax())} vs "
        f"{int(sl.argmax())}")
    check(rel < 5e-2, f"{cfg.name}: flash chunk logits differ from the scan "
          f"path's by {rel:.3e} (relative L2)")
    return {"rel_l2": rel, "same_argmax": same}


def paged_path(torch, kernels, cfg, model, params, max_len, dense,
               dense_stats):
    """Phase 9 (b) on deepseek-7b: the trace under the paged layout
    (``page_size`` 16) equals the dense run bitwise, tokens and telemetry;
    again in a pool fragmented first (every other page held), scattered
    == contiguous; a 64-token shared prefix admitted by reference equals
    its private prefill bitwise, with ``prefix_hit_tokens`` > 0; the free
    list back to its initial size after each. Logs the KV bytes the dense
    rows hold against the paged live pages."""
    import numpy as np

    from repro_torch.kernels import Policy
    from repro_torch.serve import (EngineConfig, InferenceEngine, Request,
                                   SamplingParams)

    trace = slice_trace(cfg)
    path = f"serve-{cfg.name}-paged"
    runs = {}

    def same(a, b, what):
        for rid in a:
            check(a[rid].tokens == b[rid].tokens
                  and a[rid].telemetry == b[rid].telemetry,
                  f"{cfg.name}: request {rid} differs, {what}")

    held = []

    def fragment(engine):
        pages = engine.pages.alloc(engine.pages.free_count)
        engine.pages.free(pages[::2])
        held.extend(pages[1::2])
        runs["engine"] = engine

    for name, prepare in (("contiguous", None), ("fragmented", fragment)):
        _, _, served, _, st = serve_run(
            torch, kernels, cfg, model, params, trace, "flash",
            max_len=max_len, phase="9", prepare=prepare, kv_layout="paged",
            page_size=PAGE_SIZE)
        check_flash_launches(cfg, st, f"{path} ({name})")
        same(served, dense, f"paged ({name}) vs dense")
        runs[name] = st
    kernels.launches[path] = runs["contiguous"]["launches"]
    for name in ("sum_accumulators_batched", "flash_chunk_accumulators"):
        kernels.path_labels[(name, path)] = f"serve-{cfg.name}"
    check(runs["fragmented"]["scattered"]
          and not runs["contiguous"]["scattered"],
          f"{cfg.name}: page tables scattered "
          f"{runs['fragmented']['scattered']} in the fragmented pool, "
          f"{runs['contiguous']['scattered']} in the fresh one")
    engine = runs.pop("engine")
    engine.pages.free(held)
    for name in ("contiguous", "fragmented"):
        st = runs[name]["page_stats"]
        check(st["free_pages"] == st["num_pages"] - (
            len(held) if name == "fragmented" else 0),
              f"{cfg.name}: {st['free_pages']} pages free of "
              f"{st['num_pages']} after the {name} run")
    check(engine.pages.free_count == engine.num_pages,
          "the fragmented pool did not return to its initial size")

    # shared vs private: a 64-token prefix, resumed at the chunk boundary
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, cfg.vocab_size, (64,))
    donor, benef = (
        Request(prompt=list(prefix) + list(rng.integers(0, cfg.vocab_size,
                                                        (tail,))),
                sampling=SamplingParams(max_new_tokens=SLICE_NEW),
                request_id=rid)
        for rid, tail in ((0, 32), (1, 48)))
    kw = dict(max_slots=4, max_len=max_len, prefill_chunk=64,
              track_stats=True, policy=Policy(scheme="kahan"),
              prefill_mode="flash", kv_layout="paged", page_size=PAGE_SIZE)
    private = InferenceEngine(cfg, EngineConfig(**kw), model=model,
                              params=params).run([benef])
    engine = InferenceEngine(cfg, EngineConfig(prefix_cache=True, **kw),
                             model=model, params=params)
    engine.run([donor])
    shared = engine.run([benef])
    st = engine.page_stats()
    check(st["prefix_hit_tokens"] > 0,
          f"{cfg.name}: the beneficiary never hit the shared prefix")
    same(shared, private, "shared prefix vs private")
    check(st["free_pages"] + st["prefix_pages"] == st["num_pages"],
          f"{cfg.name}: pages leaked with the prefix cache: {st}")
    freed = engine.prefix.evict(st["prefix_pages"])
    engine.slots.reset_pages(freed)
    engine.pages.free(freed)
    check(engine.pages.free_count == engine.num_pages,
          "the prefix-cache pool did not return to its initial size")
    contiguous = runs["contiguous"]
    dense_bytes = 4 * max_len * contiguous["page_bytes"] // PAGE_SIZE
    live_bytes = contiguous["peak_pages"] * contiguous["page_bytes"]
    log(f"# phase 9 {cfg.name} paged (page_size {PAGE_SIZE}): tokens and "
        f"telemetry == dense, scattered == contiguous, shared prefix == "
        f"private ({st['prefix_hit_tokens']} tokens by reference), bitwise; "
        f"free list back to {engine.num_pages} pages; KV bytes held: dense "
        f"{dense_bytes / 2**20:.1f} MiB (4 x {max_len} rows) vs paged live "
        f"{live_bytes / 2**20:.1f} MiB at peak "
        f"({contiguous['peak_pages']} pages); {contiguous['tokens_per_s']:.1f}"
        f" tokens/s paged vs {dense_stats['tokens_per_s']:.1f} dense")
    return {"contiguous": contiguous, "fragmented": runs["fragmented"],
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "dense_kv_bytes": dense_bytes, "paged_live_kv_bytes": live_bytes}


# -- 10. the MoE family -------------------------------------------------------

def moe_projections(cfg):
    """The distinct [K, N] of the B5 projections a MoE config runs under
    ``kahan_matmul``: attention's (MLA's q, dkv, kr, o; or GQA's q, k/v,
    o), the dense layers' MLP and the shared experts'."""
    d, h = cfg.d_model, cfg.n_heads
    if cfg.mla is not None:
        m = cfg.mla
        attn = [(d, h * (m.qk_nope_dim + m.qk_rope_dim)),
                (d, m.kv_lora_rank), (d, m.qk_rope_dim),
                (h * m.v_head_dim, d)]
    else:
        attn = [(d, h * cfg.head_dim), (d, cfg.n_kv_heads * cfg.head_dim),
                (h * cfg.head_dim, d)]
    mo = cfg.moe
    shared = mo.n_shared * (mo.d_ff_shared or mo.d_ff_expert)
    mlp = [(d, cfg.d_ff), (cfg.d_ff, d), (d, shared), (shared, d)]
    return list(dict.fromkeys(attn + mlp))


def b5_per_position(model) -> int:
    """B5 launches a position under ``kahan_matmul``: attention's four
    projections a layer and three for its dense MLP or shared experts
    (the router, the routed experts and a hybrid's SSM stay plain)."""
    if model.cfg.moe is None:
        return PROJECTIONS * model.cfg.n_layers
    per = 0
    for seg in model.segments:
        for kind in (("dense", "moe") if seg.kind == "super"
                     else (seg.kind,)):
            mlp = kind == "dense" or bool(model.cfg.moe.n_shared)
            per += seg.n_layers * (4 + 3 * mlp)
    return per


def check_scan_launches(model, stats, what):
    """Under the scan body no flash kernel runs; with ``kahan_matmul`` B5
    ran ``b5_per_position`` times a prompt and a decode position, and
    never without it; B6 and the dot / single sum kernels never."""
    counts = stats["launches"]
    units = stats["prompt_positions"] + stats["decode_positions"]
    want = b5_per_position(model) * units if model.cfg.kahan_matmul else 0
    check(counts["matmul_accumulators"] == want,
          f"{what}: B5 launched {counts['matmul_accumulators']} times, want "
          f"{want} ({units} positions)")
    for name in ("flash_accumulators", "flash_chunk_accumulators",
                 "dot_accumulators", "dot_accumulators_batched",
                 "sum_accumulators", "matmul_accumulators_batched"):
        check(counts[name] == 0,
              f"{what}: {name} launched {counts[name]} times while serving")


@contextlib.contextmanager
def moe_drops(torch, dev):
    """While active, every ``moe_apply`` call adds its ``dropped_frac`` to
    a device sum: single-position calls (decode steps and scan prefill
    positions) to ``"one"``, wider ones to ``"wide"``, with their counts
    (no host sync a call)."""
    from repro_torch.models import moe

    orig = moe.moe_apply
    acc = {"one": torch.zeros((), device=dev), "wide": torch.zeros(
        (), device=dev), "one_calls": 0, "wide_calls": 0}

    def recording(p, cfg, x):
        y, met = orig(p, cfg, x)
        key = "one" if x.shape[1] == 1 else "wide"
        acc[key] += met["dropped_frac"]
        acc[f"{key}_calls"] += 1
        return y, met

    moe.moe_apply = recording
    try:
        yield acc
    finally:
        moe.moe_apply = orig


def moe_model(torch, dev, cfg):
    """``cfg``'s model and random weights from seed 0 on the card, all
    earlier memory freed first; (model, params, params GiB, init peak
    GiB)."""
    stamp(f"{cfg.name}: the model and its weights")
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    sync(torch, dev)
    gib = sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30
    return model, params, gib, torch.cuda.max_memory_allocated(dev) / 2**30


@contextlib.contextmanager
def moe_routes():
    """While active, each MoE layer call appends its tokens' top-k expert
    ids, sorted, [tokens, k], to the list it yields."""
    from repro_torch.models import moe

    routes, route = [], moe.route

    def recording(p, cfg, xg, s):
        out = route(p, cfg, xg, s)
        routes.append(out.expert_idx.reshape(-1, cfg.moe.top_k)
                      .sort(-1).values)
        return out

    moe.route = recording
    try:
        yield routes
    finally:
        moe.route = route


def rerouted(torch, layers, a, b):
    """Tokens whose experts differ in each of ``layers`` MoE layers
    between two runs' ``moe_routes`` records over the same positions: a
    whole-prompt call a layer, or (scan) a call a layer and position."""
    def per_layer(routes):
        return [torch.cat(routes[i::layers]) for i in range(layers)]

    return [int((x != y).any(-1).sum())
            for x, y in zip(per_layer(a), per_layer(b))]


def compare_logits(what, cfg, x, y, rel_max, moved):
    """Relative L2 of the last-position logits ``y`` against ``x`` and
    whether their argmax agrees, logged with the tokens routed to other
    experts by layer; gated (relative L2 below ``rel_max``, the same
    argmax, finite) unless ``rel_max`` is None."""
    import torch

    x, y = (t[0, :cfg.vocab_size].double() for t in (x, y))
    rel = float((y - x).norm() / x.norm())
    same = int(x.argmax()) == int(y.argmax())
    finite = bool(torch.isfinite(x).all() and torch.isfinite(y).all())
    log(f"# phase 10 {cfg.name}: {what}, {cfg.compute_dtype} compute: "
        f"relative L2 {rel:.3e}"
        f"{' (logged)' if rel_max is None else f' (gate {rel_max})'}, "
        f"argmax {int(y.argmax())} vs {int(x.argmax())}, finite {finite}; "
        f"tokens routed to other experts by layer {moved}")
    check(finite, f"{cfg.name}: {what}: logits not finite")
    if rel_max is not None:
        check(rel < rel_max and same, f"{cfg.name}: {what} "
              f"({cfg.compute_dtype}): relative L2 {rel:.3e}, same argmax "
              f"{same}")
    return {"compute_dtype": cfg.compute_dtype, "rel_l2": rel,
            "same_argmax": same, "rerouted_tokens": moved, "gate": rel_max}


def prefill_vs_scan(torch, kernels, cfg, params, prompt, rel_max):
    """Whole-prompt ``TransformerLM.prefill`` of ``prompt`` against the
    scan chunk's last logits at capacity factor 16 (the reference's
    ``test_decode_matches_prefill``), the model computing in
    ``cfg.compute_dtype`` on the bf16 weights (``compare_logits``); the
    prefill's ``dropped_frac`` logged."""
    from repro_torch.models import build_model

    dev = kernels.dev
    wide = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CHECK_CAPACITY))
    model = build_model(wide, dev)
    toks = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    n = toks.shape[1]
    with moe_routes() as full_routes, moe_drops(torch, dev) as drops:
        full, _ = model.prefill(params, toks, model.init_cache(1, n))
    with moe_routes() as scan_routes:
        scan, _ = model.prefill_chunk(params, toks, model.init_cache(1, n),
                                      0, n)
    out = compare_logits(
        f"whole-prompt prefill of {n} tokens vs the scan chunk, capacity "
        f"factor {MOE_CHECK_CAPACITY}", wide, scan, full, rel_max,
        rerouted(torch, model.moe_layers, full_routes, scan_routes))
    out["prefill_dropped"] = float(drops["wide"])
    log(f"# phase 10 {cfg.name}: the prefill's dropped_frac summed over "
        f"{drops['wide_calls']} MoE layers {out['prefill_dropped']}")
    return out


def matmul_vs_cublas(torch, kernels, cfg, params, prompt, rel_max):
    """``prompt`` through the scan chunk with and without
    ``kahan_matmul``, the model computing in ``cfg.compute_dtype``
    (``compare_logits``)."""
    from repro_torch.models import build_model

    dev = kernels.dev
    toks = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    w = toks.shape[1]
    out, routes = [], []
    for c in (cfg, cfg.replace(kahan_matmul=True)):
        model = build_model(c, dev)
        layers = model.moe_layers
        with moe_routes() as r:
            out.append(model.prefill_chunk(params, toks,
                                           model.init_cache(1, w), 0, w)[0])
        routes.append(r)
    return compare_logits(f"a {w}-token scan chunk with kahan_matmul vs "
                          f"cuBLAS", cfg, *out, rel_max,
                          rerouted(torch, layers, *routes))


def moe_path(torch, kernels):
    """Phase 10: deepseek-v2-lite-16b at its published width and depth,
    then llama4-maverick at its published width cut to one superblock
    (bf16, random weights from seed 0, ``max_slots=4``,
    ``prefill_chunk=64``, telemetry, kahan, U = 8), each run with the
    launch counts reset just before it. Returns the phase's stats."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    out = {MOE_ARCH: moe_deepseek(torch, kernels, get_config(MOE_ARCH))}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(LLAMA4).replace(n_layers=LLAMA4_LAYERS)
    out[LLAMA4] = moe_llama4(torch, kernels, cfg)
    out["seconds"] = time.perf_counter() - t0
    log(f"# phase 10 took {out['seconds']:.1f} s")
    return out


def moe_deepseek(torch, kernels, cfg):
    """Phase 10 on deepseek-v2-lite-16b: phase 9's trace with flash
    prefill requested, resolved to the scan body (MLA and capacity
    routing have no parallel chunk), at the first ``MOE_CUT_LAYERS``
    layers (a cut for the script's time limit); request 0 alone ==
    interleaved; the paged layout (``page_size`` 16) at that depth ==
    dense with the pool free at the end and ``dropped_frac`` 0 on every
    single-position MoE call; the whole-prompt prefill of the 160-token
    prompt against the scan chunk (gated in float32 compute, logged in
    bf16); one request with ``kahan_matmul`` (B5 at every projection but
    the routed experts' a position); a 16-token chunk with
    ``kahan_matmul`` against the cuBLAS path, all at ``MOE_CUT_LAYERS``
    layers; one profiled decode position at the full depth."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import build_model

    dev = kernels.dev
    path = "serve-deepseek-v2-lite"
    max_len = slice_max_len(cfg)
    kernels.moe_times(cfg, path)
    model, params, params_gib, init_gib = moe_model(torch, dev, cfg)
    # the trace, its solo check, the paged layout and kahan_matmul run the
    # first MOE_CUT_LAYERS layers (the script's time limit); the dense run
    # at that depth is the paged run's reference
    ccfg = cfg.replace(n_layers=MOE_CUT_LAYERS)
    cmodel = build_model(ccfg, dev)
    cparams = dict(params, moe_blocks=tree_map(
        lambda t: t[:MOE_CUT_LAYERS - cfg.moe.first_k_dense],
        params["moe_blocks"]))
    ec, requests, served, captured, st = serve_run(
        torch, kernels, ccfg, cmodel, cparams, SLICE_TRACE, "flash",
        max_len=max_len, phase="10", body="scan")
    check_scan_launches(cmodel, st, path)
    kernels.launches[path] = st["launches"]
    kernels.path_labels[("sum_accumulators_batched", path)] = path
    check_tick_telemetry(torch, kernels, ccfg, ec, captured, "10")
    check_solo(ccfg, ec, cmodel, cparams, requests[0], served, ccfg.name,
               "10")
    with moe_drops(torch, dev) as drops:
        _, _, paged, _, pst = serve_run(
            torch, kernels, ccfg, cmodel, cparams, SLICE_TRACE, "flash",
            max_len=max_len, phase="10", body="scan", kv_layout="paged",
            page_size=PAGE_SIZE)
    check_scan_launches(cmodel, pst, f"{path}-paged")
    kernels.launches[f"{path}-paged"] = pst["launches"]
    kernels.path_labels[("sum_accumulators_batched", f"{path}-paged")] = path
    for rid in served:
        check(paged[rid].tokens == served[rid].tokens
              and paged[rid].telemetry == served[rid].telemetry,
              f"{cfg.name}: request {rid} differs, paged vs dense "
              f"({MOE_CUT_LAYERS} layers)")
    ps = pst["page_stats"]
    check(ps["free_pages"] == ps["num_pages"],
          f"{cfg.name}: {ps['free_pages']} pages free of {ps['num_pages']} "
          f"after the paged run")
    n_moe = cmodel.moe_layers
    positions = pst["prompt_positions"] + pst["decode_positions"]
    check(drops["one_calls"] == n_moe * positions
          and float(drops["one"]) == 0.0,
          f"{cfg.name}: dropped_frac summed to {float(drops['one'])} over "
          f"{drops['one_calls']} single-position MoE calls ({n_moe} layers "
          f"x {positions} positions)")
    token_bytes = pst["page_bytes"] // PAGE_SIZE
    dense_bytes = ec.max_slots * max_len * token_bytes
    live_bytes = pst["peak_pages"] * pst["page_bytes"]
    log(f"# phase 10 {cfg.name} paged (page_size {PAGE_SIZE}), CUT to "
        f"{MOE_CUT_LAYERS} of {cfg.n_layers} layers: tokens and telemetry == "
        f"dense at that depth, bitwise; pool free at the end; dropped_frac 0 "
        f"on all {drops['one_calls']} single-position MoE calls; KV "
        f"{token_bytes / 1024:.1f} KiB a token (MLA's latent and rope key "
        f"x {MOE_CUT_LAYERS} layers); held: dense {dense_bytes / 2**20:.1f} "
        f"MiB ({ec.max_slots} x {max_len} rows) vs paged live "
        f"{live_bytes / 2**20:.1f} MiB at peak ({pst['peak_pages']} pages)")

    cf32 = ccfg.replace(compute_dtype="float32")
    stats = {"params_gib": params_gib, "init_peak_gib": init_gib,
             "serve": st, "cut": f"the trace, solo, paged, kahan_matmul "
             f"and the prefill and cuBLAS comparisons at {MOE_CUT_LAYERS} of "
             f"{cfg.n_layers} layers",
             "paged": pst, "kv_bytes_per_token": token_bytes,
             "dense_kv_bytes": dense_bytes, "paged_live_kv_bytes": live_bytes,
             "prefill_vs_scan": [prefill_vs_scan(
                 torch, kernels, c, cparams, requests[-1].prompt, gate)
                 for c, gate in ((ccfg, None), (cf32, MOE_PREFILL_REL))]}

    mcfg = ccfg.replace(kahan_matmul=True)
    mmodel = build_model(mcfg, dev)
    mpath = f"{path}-matmul"
    _, _, _, _, mst = serve_run(torch, kernels, mcfg, mmodel, cparams,
                                SLICE_TRACE.split(",")[0], "flash",
                                max_len=max_len, phase="10", body="scan")
    check_scan_launches(mmodel, mst, mpath)
    kernels.launches[mpath] = mst["launches"]
    kernels.path_labels[("sum_accumulators_batched", mpath)] = path
    kernels.path_labels[("matmul_accumulators", mpath)] = MOE_B5_ROW
    stats["matmul"] = mst
    stats["matmul_vs_cublas"] = [
        matmul_vs_cublas(torch, kernels, c, cparams, requests[0].prompt[:16],
                         gate)
        for c, gate in ((ccfg, None), (cf32, 5e-2))]
    stats["decode_profile"] = profile_decode_step(torch, model, params, dev,
                                                  max_len)
    stats["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"# phase 10 {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads} MLA r={cfg.mla.kv_lora_rank} "
        f"E={cfg.moe.n_experts} top-{cfg.moe.top_k} +{cfg.moe.n_shared} "
        f"shared vocab={cfg.vocab_size} (the trace, solo, paged and "
        f"kahan_matmul runs and the prefill and cuBLAS comparisons at "
        f"{MOE_CUT_LAYERS} layers): params "
        f"{params_gib:.2f} GiB, init peak {init_gib:.2f} GiB, peak "
        f"{stats['peak_gib']:.2f} GiB, {st['tokens_per_s']:.2f} tokens/s, "
        f"decode tick {st['decode_tick_ms_mean']:.2f} ms mean, prefill "
        f"{st['prefill_ms_per_position']:.3f} ms per position (scan); one "
        f"decode position {stats['decode_profile']['host_ms']:.2f} ms host, "
        f"{stats['decode_profile']['device_busy_ms'] or 0:.3f} ms device "
        f"busy, {stats['decode_profile']['device_kernels']} kernels")
    return stats


def moe_llama4(torch, kernels, cfg):
    """Phase 10 on llama4-maverick at its published width cut to
    ``LLAMA4_LAYERS`` layers (one dense+MoE superblock; the 48 layers
    need about 800 GB): one request on the dense layout under the scan
    body, and its prompt's whole-prompt prefill against the scan chunk
    at capacity factor 16."""
    dev = kernels.dev
    path = f"serve-llama4-maverick-{cfg.n_layers}l"
    kernels.moe_times(cfg, path)
    model, params, params_gib, init_gib = moe_model(torch, dev, cfg)
    _, requests, served, _, st = serve_run(
        torch, kernels, cfg, model, params, LLAMA4_TRACE, "flash",
        phase="10", body="scan")
    check_scan_launches(model, st, path)
    kernels.launches[path] = st["launches"]
    kernels.path_labels[("sum_accumulators_batched", path)] = path
    stats = {"cut": f"n_layers {cfg.n_layers} of 48 (one superblock)",
             "params_gib": params_gib, "init_peak_gib": init_gib,
             "serve": st, "prefill_vs_scan": [prefill_vs_scan(
                 torch, kernels, c, params, requests[0].prompt, gate)
                 for c, gate in ((cfg, None),
                                 (cfg.replace(compute_dtype="float32"),
                                  MOE_PREFILL_REL))]}
    stats["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"# phase 10 {cfg.name} CUT to {cfg.n_layers} of 48 layers: "
        f"d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"E={cfg.moe.n_experts} top-{cfg.moe.top_k} ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size}: params {params_gib:.2f} GiB, init peak "
        f"{init_gib:.2f} GiB, peak {stats['peak_gib']:.2f} GiB, "
        f"{st['tokens_per_s']:.2f} tokens/s, decode tick "
        f"{st['decode_tick_ms_mean']:.2f} ms mean")
    del model, params
    return stats


def decode_vs_prefill(torch, cfg, model, params, prompt, prefill, steps,
                      rel_max, phase):
    """``prefill(tokens)`` -> (last logits, cache) of ``prompt``, then
    ``steps`` greedy ``decode_step``s, each step's logits against
    ``prefill`` of the prompt and the tokens so far: relative L2 and
    argmax, gated below ``rel_max``. Returns the steps' errors and the
    first prefill's ms."""
    stamp(f"phase {phase} {cfg.name}: decode vs prefill, "
          f"{cfg.compute_dtype} compute")
    dev = model.device
    n = len(prompt)
    seq = [int(t) for t in prompt]
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, cache = prefill(seq)
    sync(torch, dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out = []
    for i in range(steps):
        tok = int(torch.argmax(logits[0, :cfg.vocab_size]))
        seq.append(tok)
        logits = model.decode_step(params, cache,
                                   torch.tensor([tok], device=dev), n + i)
        full, _ = prefill(seq)
        x, y = (t[0, :cfg.vocab_size].double() for t in (full, logits))
        out.append({"pos": n + i, "rel_l2": float((y - x).norm() / x.norm()),
                    "same_argmax": int(x.argmax()) == int(y.argmax()),
                    "finite": bool(torch.isfinite(y).all()
                                   and torch.isfinite(x).all())})
    worst = max(st["rel_l2"] for st in out)
    rels = ", ".join(f"{st['rel_l2']:.3e}" for st in out)
    log(f"# phase {phase} {cfg.name}: prefill of {n} tokens "
        f"({cfg.compute_dtype} compute) in {prefill_ms:.1f} ms, then {steps} "
        f"decode steps vs a prefill of prompt + tokens: relative L2 "
        f"[{rels}], worst {worst:.3e} (gate {rel_max}), argmax equal "
        f"{[st['same_argmax'] for st in out]}")
    check(all(st["finite"] for st in out),
          f"{cfg.name}: decode-vs-prefill logits not finite "
          f"({cfg.compute_dtype})")
    check(worst < rel_max and all(st["same_argmax"] for st in out),
          f"{cfg.name} ({cfg.compute_dtype}): decode vs prefill relative L2 "
          f"{worst:.3e}, argmax {[st['same_argmax'] for st in out]}")
    return {"compute_dtype": cfg.compute_dtype, "prompt": n,
            "prefill_ms": prefill_ms, "steps": out, "worst_rel_l2": worst,
            "gate": rel_max}


@contextlib.contextmanager
def widened_casts(torch):
    """While active, ``Tensor.float`` returns float64: the model's float32
    casts (the gates, the states, the norms) widen with its compute, as
    the CPU tests widen both sides' gradients."""
    orig = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = orig


def check_no_kernels(counts, what, allowed=()):
    """No wrapper but ``allowed`` launched in ``counts``."""
    for name, n in counts.items():
        if name not in allowed:
            check(n == 0, f"{what}: {name} launched {n} times")


# -- 11. the hybrid family ----------------------------------------------------

def hybrid_projections(cfg):
    """The distinct [K, N] of the B5 projections hymba runs under
    ``kahan_matmul``: q/o, k/v, gate/up and down (its SSM's contractions
    stay plain)."""
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.head_dim
    return list(dict.fromkeys([(d, cfg.n_heads * cfg.head_dim), (d, kv),
                               (cfg.n_heads * cfg.head_dim, d),
                               (d, cfg.d_ff), (cfg.d_ff, d)]))


def hybrid_state_bytes(engine):
    """Bytes the engine's cache holds, by kind: the ring buffers
    (``"kv_ring"`` leaves), the global layers' K/V held densely
    (``"kv_seq"`` leaves kept as slot rows; 0 under the paged layout,
    whose pool ``page_stats`` counts) and the SSM state, over all
    slots."""
    from repro_torch.models.common import cache_leaves

    out = {"ring": 0, "global_dense": 0, "ssm": 0}
    specs = engine.model.cache_specs()
    for seg, c in engine.slots.cache.items():
        for kind, leaves, names in (("kv", c["kv"], specs[seg]["kv"]),
                                    ("ssm", c["ssm"], specs[seg]["ssm"])):
            for leaf, axes in zip(cache_leaves(leaves), names):
                n = leaf.numel() * leaf.element_size()
                if kind == "ssm":
                    out["ssm"] += n
                elif "kv_ring" in axes:
                    out["ring"] += n
                elif engine.kv_layout == "dense":
                    out["global_dense"] += n
    return out


def ring_wrap(torch, kernels, cfg, params, prompt, rel_max):
    """``HymbaLM.prefill`` of ``prompt`` (past the window: its rings
    wrap) under ``kahan_attention`` (B7 on the global layers), then
    ``HYMBA_RING_STEPS`` greedy ``decode_step``s against the wrapped
    rings, each step's logits against a whole-prompt prefill of the
    prompt and the tokens so far (``decode_vs_prefill``, gated below
    ``rel_max``). The launch counts are reset just
    before and read just after. Returns the step errors, the counts and
    the prefill's ms."""
    stamp(f"phase 11 {cfg.name}: the ring wrap, {cfg.compute_dtype} "
          f"compute")
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts
    from repro_torch.models import build_model

    dev = kernels.dev
    model = build_model(cfg.replace(kahan_attention=True), dev)
    n = len(prompt)

    def prefill(tokens):
        toks = torch.as_tensor(tokens, dtype=torch.long, device=dev)[None]
        return model.prefill(params, toks, model.init_cache(
            1, n + HYMBA_RING_STEPS))

    reset_launch_counts()
    out = decode_vs_prefill(torch, cfg, model, params, prompt, prefill,
                            HYMBA_RING_STEPS, rel_max, "11")
    sync(torch, dev)
    counts = launch_counts()
    n_global = sum(1 for seg in model.segments if seg.window <= 0)
    want = n_global * (1 + HYMBA_RING_STEPS)
    log(f"# phase 11 {cfg.name}: the prompt wraps the "
        f"{cfg.sliding_window}-row rings; B7 launched "
        f"{counts['flash_accumulators']} times")
    check(counts["flash_accumulators"] == want,
          f"{cfg.name}: B7 launched {counts['flash_accumulators']} times in "
          f"the ring check, want {want} ({n_global} global layers x "
          f"{1 + HYMBA_RING_STEPS} prefills)")
    check_no_kernels(counts, f"{cfg.name} ring check", ("flash_accumulators",))
    out["launches"] = counts
    return out


def hybrid_path(torch, kernels):
    """Phase 11: hymba-1.5b at its published width and depth, no cut
    (bf16, random weights from seed 0, ``max_slots=4``,
    ``prefill_chunk=64``, telemetry, kahan, U = 8), each path with the
    launch counts reset just before it: ``SCAN_TRACE`` with flash asked
    for and the scan body resolved (B4 once a tick and finished prefill,
    nothing else), its telemetry against the plain version, request 0
    alone == interleaved, one request with ``kahan_matmul`` (B5 7 times
    a layer and position); the ring wrap of ``ring_wrap`` in float32
    compute (gated); one profiled decode position. Returns the phase's
    stats."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    dev = kernels.dev
    cfg = get_config(HYMBA)
    path = f"serve-{cfg.name}"
    max_len = page_max_len(SCAN_TRACE)
    kernels.hybrid_times(cfg, path, HYMBA_RING_PROMPT)
    model, params, params_gib, init_gib = moe_model(torch, dev, cfg)
    dense_state = {}
    ec, requests, served, captured, st = serve_run(
        torch, kernels, cfg, model, params, SCAN_TRACE, "flash",
        max_len=max_len, phase="11", body="scan",
        prepare=lambda e: dense_state.update(hybrid_state_bytes(e)))
    check_scan_launches(model, st, path)
    kernels.launches[path] = st["launches"]
    kernels.path_labels[("sum_accumulators_batched", path)] = path
    check_tick_telemetry(torch, kernels, cfg, ec, captured, "11")
    check_solo(cfg, ec, model, params, requests[0], served, cfg.name, "11")
    n_ring = sum(seg.n_layers for seg in model.segments if seg.window > 0)
    log(f"# phase 11 {cfg.name}: KV held over {ec.max_slots} slots: rings "
        f"{dense_state['ring'] / 2**20:.1f} MiB ({n_ring} layers x "
        f"{cfg.sliding_window} rows), global layers "
        f"{dense_state['global_dense'] / 2**20:.2f} MiB ({ec.max_slots} x "
        f"{max_len} rows), SSM state {dense_state['ssm'] / 2**20:.2f} MiB; "
        f"the paged layout is held to dense on the CPU only "
        f"(tests/test_torch_hybrid.py)")

    mcfg = cfg.replace(kahan_matmul=True)
    mmodel = build_model(mcfg, dev)
    mpath = f"{path}-matmul"
    _, _, _, _, mst = serve_run(torch, kernels, mcfg, mmodel, params,
                                SCAN_TRACE.split(",")[0], "flash",
                                max_len=max_len, phase="11", body="scan")
    check_scan_launches(mmodel, mst, mpath)
    kernels.launches[mpath] = mst["launches"]
    kernels.path_labels[("sum_accumulators_batched", mpath)] = path
    kernels.path_labels[("matmul_accumulators", mpath)] = HYMBA_B5_ROW
    del mmodel

    prompt = torch.randint(0, cfg.vocab_size, (HYMBA_RING_PROMPT,),
                           generator=torch.Generator().manual_seed(0))
    ring = [ring_wrap(torch, kernels, cfg.replace(compute_dtype="float32"),
                      params, prompt, HYMBA_RING_REL)]
    ppath = f"{path}-prefill"
    kernels.launches[ppath] = ring[-1]["launches"]
    kernels.path_labels[("flash_accumulators", ppath)] = ppath
    profile = profile_decode_step(torch, model, params, dev, max_len)
    stats = {"params_gib": params_gib, "init_peak_gib": init_gib,
             "serve": st, "matmul": mst,
             "state_bytes_dense": dense_state, "ring_wrap": ring,
             "decode_profile": profile,
             "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 11 {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} window {cfg.sliding_window}, "
        f"global {list(cfg.global_attn_layers)}, SSM d_state "
        f"{cfg.ssm.d_state} (no cut): params {params_gib:.2f} GiB, init peak "
        f"{init_gib:.2f} GiB, peak {stats['peak_gib']:.2f} GiB, "
        f"{st['tokens_per_s']:.2f} tokens/s (kahan_matmul "
        f"{mst['tokens_per_s']:.2f}),"
        f" decode tick {st['decode_tick_ms_mean']:.2f} ms mean, prefill "
        f"{st['prefill_ms_per_position']:.3f} ms per position (scan); one "
        f"decode position {profile['host_ms']:.2f} ms host, "
        f"{profile['device_busy_ms'] or 0:.3f} ms device busy, "
        f"{profile['device_kernels']} kernels; phase 11 took "
        f"{stats['seconds']:.1f} s")
    return stats


# -- 12. the xLSTM family -----------------------------------------------------

def state_bytes(engine, *keys):
    """Bytes of the engine's cache under ``keys`` of its top level, over
    all slots (every leaf when no key is given)."""
    from repro_torch.models.common import cache_leaves

    cache = engine.slots.cache
    trees = [cache[k] for k in keys] if keys else [cache]
    return sum(leaf.numel() * leaf.element_size()
               for tree in trees for leaf in cache_leaves(tree))


def xlstm_path(torch, kernels):
    """Phase 12: xlstm-1.3b at its published width and depth, no cut
    (bf16, random weights from seed 0, ``prefill_chunk=64``, telemetry,
    kahan, U = 8), each path with the launch counts reset just before it:
    ``SCAN_TRACE`` with flash and the paged layout asked for, the scan
    body and the dense layout resolved (B4 once a tick and finished
    prefill, nothing else: the projections are einsums, as in the
    reference), its telemetry against the plain version, request 0 alone
    == interleaved; the whole-prompt ``XLSTMLM.prefill`` of
    ``XLSTM_PROMPT`` tokens (two 512-token chunks, the second padded) and
    ``XLSTM_STEPS`` greedy decode steps against prefills of the prompt
    and the tokens so far, in float64 with the casts widened (gated); one
    profiled decode position. Returns the phase's stats."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.common import map_cache_leaves

    t_phase = time.perf_counter()
    dev = kernels.dev
    cfg = get_config(XLSTM)
    path = f"serve-{cfg.name}"
    max_len = page_max_len(SCAN_TRACE)
    kernels.telemetry_times(cfg, path)
    model, params, params_gib, init_gib = moe_model(torch, dev, cfg)
    state = {}
    ec, requests, served, captured, st = serve_run(
        torch, kernels, cfg, model, params, SCAN_TRACE, "flash",
        max_len=max_len, phase="12", body="scan", kv_layout="paged",
        page_size=PAGE_SIZE,
        prepare=lambda e: state.update(bytes=state_bytes(e)))
    check(st["kv_layout"] == "dense", f"{cfg.name}: the paged layout "
          f"resolved to {st['kv_layout']}, want dense (nothing pages)")
    check_no_kernels(st["launches"], path, ("sum_accumulators_batched",))
    kernels.launches[path] = st["launches"]
    kernels.path_labels[("sum_accumulators_batched", path)] = path
    check_tick_telemetry(torch, kernels, cfg, ec, captured, "12")
    check_solo(cfg, ec, model, params, requests[0], served, cfg.name, "12")
    reset_launch_counts()
    prompt = torch.randint(0, cfg.vocab_size, (XLSTM_PROMPT,),
                           generator=torch.Generator().manual_seed(0))
    c = cfg.replace(compute_dtype="float64")
    m = build_model(c, dev)
    p = tree_map(lambda t: t.double(), params)

    def prefill(tokens):
        toks = torch.as_tensor(tokens, dtype=torch.long, device=dev)[None]
        cache = map_cache_leaves(lambda t: t.double(), m.init_cache(1, 0))
        return m.prefill(p, toks, cache)

    with widened_casts(torch):
        entry = [decode_vs_prefill(torch, c, m, p, prompt.tolist(), prefill,
                                   XLSTM_STEPS, XLSTM_REL, "12")]
    del p
    sync(torch, dev)
    check_no_kernels(launch_counts(), f"{cfg.name} prefill check")
    profile = profile_decode_step(torch, model, params, dev, max_len)
    stats = {"params_gib": params_gib, "init_peak_gib": init_gib,
             "serve": st, "state_bytes": state["bytes"],
             "state_bytes_per_slot": state["bytes"] // ec.max_slots,
             "prefill_check": entry, "decode_profile": profile,
             "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 12 {cfg.name}: {cfg.n_layers} blocks "
        f"({cfg.n_layers // cfg.xlstm.slstm_every} groups of "
        f"{cfg.xlstm.slstm_every - 1} mLSTM + 1 sLSTM) d={cfg.d_model} "
        f"H={cfg.n_heads} chunk {cfg.xlstm.chunk} (no cut): params "
        f"{params_gib:.2f} GiB, init peak {init_gib:.2f} GiB, peak "
        f"{stats['peak_gib']:.2f} GiB, state {state['bytes'] / 2**30:.3f} "
        f"GiB over {ec.max_slots} slots, {st['tokens_per_s']:.2f} tokens/s, "
        f"decode tick {st['decode_tick_ms_mean']:.2f} ms mean, prefill "
        f"{st['prefill_ms_per_position']:.3f} ms per position (scan); one "
        f"decode position {profile['host_ms']:.2f} ms host, "
        f"{profile['device_busy_ms'] or 0:.3f} ms device busy, "
        f"{profile['device_kernels']} kernels; phase 12 took "
        f"{stats['seconds']:.1f} s")
    return stats


# -- 13. the encoder-decoder family -------------------------------------------

def whisper_projections(cfg):
    """The distinct [K, N] of whisper's B5 projections: q/k/v/o, up and
    down (the cross K/V fill stays plain)."""
    d = cfg.d_model
    return [(d, d), (d, cfg.d_ff), (cfg.d_ff, d)]


def check_whisper_launches(cfg, stats, what):
    """Under flash with ``kahan_attention``: B8 n_layers times a chunk of
    width > 1; with ``kahan_matmul``, B5 6 times an encoder layer a
    request (q, k, v, o, up, down at its frames) and 8 times a decoder
    layer a chunk and a decode position (self-attention's q, k, v, o, the
    cross-attention's q and o, up and down), never without it; B4 once a
    tick and finished prefill (``serve_run``); nothing else."""
    counts = stats["launches"]
    wide = sum(1 for w in stats["chunk_widths"] if w > 1)
    want8 = cfg.n_layers * wide if cfg.kahan_attention else 0
    check(counts["flash_chunk_accumulators"] == want8,
          f"{what}: B8 launched {counts['flash_chunk_accumulators']} times, "
          f"want {want8}")
    units = stats["prefill_chunks"] + stats["decode_positions"]
    want5 = ((6 * cfg.encoder.n_layers * stats["requests"]
              + 8 * cfg.n_layers * units) if cfg.kahan_matmul else 0)
    check(counts["matmul_accumulators"] == want5,
          f"{what}: B5 launched {counts['matmul_accumulators']} times, want "
          f"{want5}")
    check_no_kernels(counts, what, ("flash_chunk_accumulators",
                                    "matmul_accumulators",
                                    "sum_accumulators_batched"))


def whisper_path(torch, kernels):
    """Phase 13: whisper-large-v3 at its published width and depth, no
    cut (32 encoder and 32 decoder layers; bf16, random weights from seed
    0, ``max_slots=4``, ``prefill_chunk=64``, telemetry, kahan, U = 8;
    each request with frames [1500, 1280] drawn from the seed), each path
    with the launch counts reset just before it: phase 9's trace under
    flash prefill with ``kahan_attention`` (B8 32 times a chunk, B4 once
    a tick and finished prefill), its telemetry against the plain
    version, request 0 alone == interleaved, the paged layout
    (``page_size`` 16: only the self-attention K/V page, the cross K/V
    stay dense slot rows) == dense, one request with ``kahan_matmul`` (B5
    at the encoder's M 1500 and the decoder's chunks and positions); the
    encoder alone under ``kahan_matmul``; ``EncDecLM.prefill`` of the
    longest prompt (B7 32 times) against the chunked path over the same
    ``prefill_begin``, relative L2 below phase 4's 5e-2 and the same
    argmax; one profiled decode position. Returns the phase's stats."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    dev = kernels.dev
    cfg = get_config(WHISPER).replace(kahan_attention=True)
    path = f"serve-{cfg.name}"
    max_len = slice_max_len(cfg)
    longest = max(int(c.split(":")[1]) for c in SLICE_TRACE.split(","))
    kernels.whisper_times(cfg, path, max_len, longest)
    model, params, params_gib, init_gib = moe_model(torch, dev, cfg)
    dense_bytes = {}

    def measure(engine):
        dense_bytes.update(kv=state_bytes(engine, "kv"),
                           cross=state_bytes(engine, "xk", "xv"))

    ec, requests, served, captured, st = serve_run(
        torch, kernels, cfg, model, params, SLICE_TRACE, "flash",
        max_len=max_len, phase="13", prepare=measure)
    check_whisper_launches(cfg, st, path)
    kernels.launches[path] = st["launches"]
    for name in ("sum_accumulators_batched", "flash_chunk_accumulators"):
        kernels.path_labels[(name, path)] = path
    check_tick_telemetry(torch, kernels, cfg, ec, captured, "13")
    check_solo(cfg, ec, model, params, requests[0], served, cfg.name, "13")

    _, _, paged, _, pst = serve_run(
        torch, kernels, cfg, model, params, SLICE_TRACE, "flash",
        max_len=max_len, phase="13", kv_layout="paged", page_size=PAGE_SIZE)
    check(pst["kv_layout"] == "paged", f"{cfg.name}: the paged layout "
          f"resolved to {pst['kv_layout']}")
    check_whisper_launches(cfg, pst, f"{path}-paged")
    kernels.launches[f"{path}-paged"] = pst["launches"]
    for name in ("sum_accumulators_batched", "flash_chunk_accumulators"):
        kernels.path_labels[(name, f"{path}-paged")] = path
    for rid in served:
        check(paged[rid].tokens == served[rid].tokens
              and paged[rid].telemetry == served[rid].telemetry,
              f"{cfg.name}: request {rid} differs, paged vs dense")
    ps = pst["page_stats"]
    check(ps["free_pages"] == ps["num_pages"],
          f"{cfg.name}: {ps['free_pages']} pages free of {ps['num_pages']} "
          f"after the paged run")
    live_bytes = pst["peak_pages"] * pst["page_bytes"]
    log(f"# phase 13 {cfg.name} paged (page_size {PAGE_SIZE}): tokens and "
        f"telemetry == dense, bitwise; pool free at the end. Over "
        f"{ec.max_slots} slots: self-attention K/V dense "
        f"{dense_bytes['kv'] / 2**20:.2f} MiB ({ec.max_slots} x {max_len} "
        f"rows, {pst['page_bytes'] // PAGE_SIZE} B a token) vs paged live "
        f"{live_bytes / 2**20:.2f} MiB at peak ({pst['peak_pages']} pages); "
        f"cross K/V {dense_bytes['cross'] / 2**30:.3f} GiB, dense slot rows "
        f"in both layouts")

    mcfg = cfg.replace(kahan_matmul=True)
    mmodel = build_model(mcfg, dev)
    mpath = f"{path}-matmul"
    _, mreqs, _, _, mst = serve_run(torch, kernels, mcfg, mmodel, params,
                                    SLICE_TRACE.split(",")[0], "flash",
                                    max_len=max_len, phase="13")
    check_whisper_launches(mcfg, mst, mpath)
    kernels.launches[mpath] = mst["launches"]
    for name in ("sum_accumulators_batched", "flash_chunk_accumulators"):
        kernels.path_labels[(name, mpath)] = path
    kernels.path_labels[("matmul_accumulators", mpath)] = WHISPER_DECODE_ROW
    frames = torch.as_tensor(mreqs[0].extras["frames"], device=dev)[None]
    reset_launch_counts()
    enc = mmodel.encode(params, frames)
    sync(torch, dev)
    ecounts = launch_counts()
    want = 6 * cfg.encoder.n_layers
    check(ecounts["matmul_accumulators"] == want,
          f"{cfg.name}: the encoder launched B5 "
          f"{ecounts['matmul_accumulators']} times, want {want}")
    check_no_kernels(ecounts, "whisper encode", ("matmul_accumulators",))
    check(bool(torch.isfinite(enc).all()), f"{cfg.name}: encoder output "
          f"not finite under kahan_matmul")
    kernels.launches["whisper-encode-matmul"] = ecounts
    kernels.path_labels[("matmul_accumulators", "whisper-encode-matmul")] = (
        WHISPER_ENCODE_ROW)
    del mmodel, enc

    req = requests[-1]
    toks = torch.as_tensor(req.prompt, dtype=torch.long, device=dev)[None]
    frames = torch.as_tensor(req.extras["frames"], device=dev)[None]
    n = toks.shape[1]
    reset_launch_counts()
    sync(torch, dev)
    t0 = time.perf_counter()
    full, _ = model.prefill(params, toks, model.init_cache(1, n), frames)
    sync(torch, dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pcounts = launch_counts()
    check(pcounts["flash_accumulators"] == cfg.n_layers,
          f"{cfg.name}: prefill launched B7 {pcounts['flash_accumulators']} "
          f"times, want {cfg.n_layers}")
    check_no_kernels(pcounts, "whisper prefill", ("flash_accumulators",))
    kernels.launches[WHISPER_PREFILL_ROW] = pcounts
    kernels.path_labels[("flash_accumulators", WHISPER_PREFILL_ROW)] = (
        WHISPER_PREFILL_ROW)
    cache = model.prefill_begin(params, model.init_cache(1, n), frames)
    for off in range(0, n, 64):
        w = min(64, n - off)
        chunked, cache = model.prefill_chunk_parallel(
            params, toks[:, off:off + w], cache, off, w)
    x, y = (t[0, :cfg.vocab_size].double() for t in (full, chunked))
    rel = float((x - y).norm() / y.norm())
    same = int(x.argmax()) == int(y.argmax())
    log(f"# phase 13 {cfg.name}: EncDecLM.prefill of {n} tokens (B7 "
        f"{pcounts['flash_accumulators']} times, {prefill_ms:.1f} ms) vs the "
        f"chunked path over the same prefill_begin: relative L2 {rel:.3e}, "
        f"argmax {int(x.argmax())} vs {int(y.argmax())}")
    check(rel < WHISPER_REL and same,
          f"{cfg.name}: prefill vs chunked path relative L2 {rel:.3e}, same "
          f"argmax {same}")
    profile = profile_decode_step(
        torch, model, params, dev, max_len,
        prepare=lambda cache: model.prefill_begin(params, cache, frames))
    stats = {"params_gib": params_gib, "init_peak_gib": init_gib,
             "serve": st, "paged": pst, "matmul": mst,
             "encode_launches": ecounts["matmul_accumulators"],
             "kv_bytes_dense": dense_bytes["kv"],
             "cross_kv_bytes": dense_bytes["cross"],
             "paged_live_kv_bytes": live_bytes,
             "prefill_vs_chunked": {"rel_l2": rel, "same_argmax": same,
                                    "prefill_ms": prefill_ms, "prompt": n},
             "decode_profile": profile,
             "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 13 {cfg.name}: {cfg.encoder.n_layers}+{cfg.n_layers}L "
        f"d={cfg.d_model} H={cfg.n_heads} ff={cfg.d_ff} GELU, "
        f"{cfg.encoder.n_frames} frames (no cut): params {params_gib:.2f} "
        f"GiB, init peak {init_gib:.2f} GiB, peak {stats['peak_gib']:.2f} "
        f"GiB, {st['tokens_per_s']:.2f} tokens/s (paged "
        f"{pst['tokens_per_s']:.2f}, kahan_matmul {mst['tokens_per_s']:.2f}),"
        f" decode tick {st['decode_tick_ms_mean']:.2f} ms mean, prefill "
        f"{st['prefill_ms_per_position']:.3f} ms per position (flash, the "
        f"encoder included); one decode position {profile['host_ms']:.2f} "
        f"ms host, {profile['device_busy_ms'] or 0:.3f} ms device busy, "
        f"{profile['device_kernels']} kernels; phase 13 took "
        f"{stats['seconds']:.1f} s")
    return stats


# -- 8. the sharded slice on two ranks ----------------------------------------

def dist_spec(cfg, device="cuda"):
    """What phase 8's ranks run, passed to each (its sizes, the model:
    ``cfg`` cut to DIST_LAYERS layers)."""
    return {"device": device, "n": DIST_N, "matmul": DIST_MATMUL,
            "act": DIST_ACT, "leaf": DIST_LEAF,
            "cfg": cfg.replace(n_layers=DIST_LAYERS),
            "steps": DIST_TRAIN_STEPS, "micro": TRAIN_MICRO,
            "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "lr": TRAIN_LR}


def dist_inputs(torch, dev, rank, spec):
    """Phase 8's inputs, made on ``dev`` from seeds: the same tensors on
    every rank (each passes the whole tensor and reduces its block), but
    the compressed leaf, which is each rank's own."""
    gen = torch.Generator(device=dev).manual_seed(8)

    def wide(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        e = torch.randint(-8, 8, shape, generator=gen, device=dev)
        return x * torch.exp2(e.float())

    m, k, n = spec["matmul"]
    out = {"x": wide(spec["n"]), "y": wide(spec["n"]), "a": wide(m, k),
           "b": wide(k, n), "act": wide(*spec["act"]),
           "values": torch.tensor([1.25, -3.5e-3], device=dev)}
    leaf = torch.Generator(device=dev).manual_seed(80 + rank)
    out["leaf"] = torch.randn(spec["leaf"], generator=leaf, device=dev)
    return out


def dist_cases(torch, mesh, d):
    """The sharded entry points once each (``repro_torch.distributed``)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.models.layers import activation_sq_norm

    return {"asum": coll.sharded_asum(mesh, d["x"]),
            "dot": coll.sharded_dot(mesh, d["x"], d["y"]),
            "matmul": coll.sharded_matmul(mesh, d["a"], d["b"]),
            "act": activation_sq_norm(d["act"], mesh=mesh),
            "mean": coll.deterministic_mean(mesh, d["values"]),
            "compressed": compressed_psum(d["leaf"], mesh.get_group("data"))}


def dist_rank(rank, store, out, spec):
    """One rank of phase 8, in its own process on the one card: a gloo
    group over a ``FileStore``, the local mesh, the sharded entry points
    twice (launch counts reset just before, read just after), the
    gather's and the sharded sum's times, then OLMo-1B trained at full
    width and depth on the 2-rank mesh, twice. Writes its results to
    ``out`` (``torch.save``). ``spec``: ``dist_spec``."""
    import gc

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import kahan as K
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import engine
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.trainer import batch_to_device

    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, DIST_RANKS),
                            rank=rank, world_size=DIST_RANKS)
    mesh = make_local_mesh(device=dev)
    group = mesh.get_group("data")
    d = dist_inputs(torch, dev, rank, spec)
    res = {"runs": []}
    engine.reset_launch_counts()
    for _ in range(2):
        res["runs"].append(dist_cases(torch, mesh, d))
    sync(torch, dev)
    res["launches"] = engine.launch_counts()
    # the gather of one U = 8 grid, host clock a call; the sharded sum,
    # device time between events (gloo's host round trip included)
    grid = torch.zeros((64, 128), device=dev)
    for _ in range(3):
        K.gather_ranks(grid, group)
    sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(50):
        K.gather_ranks(grid, group)
    sync(torch, dev)
    res["gather_us"] = (time.perf_counter() - t0) / 50 * 1e6
    from repro_torch.distributed import collectives as coll

    res["sharded_sum_ms"] = cuda_ms(
        torch, lambda: coll.sharded_asum(mesh, d["x"]), reps=10) if cuda \
        else None
    res["runs"] = [{k: v.cpu() for k, v in run.items()}
                   for run in res["runs"]]
    del d, grid
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # OLMo-1B on the mesh: run A's settings (cuBLAS projections, the
    # column-scan norm), the loss folded through the sharded sum
    cfg = spec["cfg"]
    tc = TrainConfig(steps=spec["steps"], microbatches=spec["micro"],
                     warmup=1, log_every=1, ckpt_every=10 ** 9,
                     opt=AdamWConfig(lr=spec["lr"]))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=spec["seq"],
                                  global_batch=spec["batch"]))
    res["train"] = []
    for _ in range(2):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        trainer = Trainer(cfg, tc, data, seed=0, device=dev, mesh=mesh)
        micro = []
        loss_fn = trainer.model.loss

        def recording(params, batch, _f=loss_fn):
            loss, metrics = _f(params, batch)
            micro.append(loss.detach().float().clone())
            return loss, metrics

        trainer.model.loss = recording
        losses = []
        engine.reset_launch_counts()
        sync(torch, dev)
        t0 = time.perf_counter()
        for step in range(spec["steps"]):
            batch = batch_to_device(data.batch_at(step), dev)
            trainer.params, trainer.opt_state, m = trainer.step_fn(
                trainer.params, trainer.opt_state, batch)
            losses.append(m["loss"].detach().clone())
        sync(torch, dev)
        res["train"].append({
            "loss": torch.stack(losses).cpu(),
            "micro": torch.stack(micro).cpu(),
            "launches": engine.launch_counts(),
            "seconds": time.perf_counter() - t0,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else 0})
        del trainer, m, batch
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    res["total_bytes"] = (torch.cuda.get_device_properties(dev).total_memory
                          if cuda else 1)
    torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


def dist_path(torch, kernels, spec):
    """Phase 8: the sharded compensated reductions over
    ``torch.distributed`` and the trainer's sharded loss fold, on two
    ranks sharing the one card (gloo: NCCL refuses two ranks on one
    device), started with ``torch.multiprocessing`` over a ``FileStore``.
    Gates: every result the same bits on both ranks and in both runs;
    equal to ``merge_accumulators`` / ``merge_accumulator_grids`` over the
    per-shard grids this process computes with the same kernels on the
    same card, and to the plain versions' sharded fold; the trainer's
    loss the same bits on both ranks and run to run, equal to the sharded
    fold of its microbatch losses recomputed here and within 1e-6
    (relative) of their local Kahan fold."""
    import gc
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.core import kahan as K

    t_start = time.perf_counter()
    dev = kernels.dev
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    scratch = Path(tempfile.mkdtemp(prefix="dist-", dir=ROOT / "build"))
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=dist_rank, args=(
            r, str(scratch / "store"), str(scratch / f"rank{r}.pt"), spec))
            for r in range(DIST_RANKS)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + RANKS_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.perf_counter()))
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
            check(p.exitcode == 0, f"phase 8: rank {r} exited with "
                  f"{p.exitcode}")
        ranks = [torch.load(scratch / f"rank{r}.pt", weights_only=False)
                 for r in range(DIST_RANKS)]
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    def same(x, y):
        return (x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)))

    # 1. the same bits on both ranks and in both runs
    for r, res in enumerate(ranks):
        for key, val in res["runs"][0].items():
            check(same(val, res["runs"][1][key]),
                  f"phase 8: {key} differs run to run on rank {r}")
            if key != "act":
                check(same(val, ranks[0]["runs"][0][key]),
                      f"phase 8: {key} differs between ranks 0 and {r}")
    # 2. against the per-shard grids of the same kernels here, and the
    # plain versions' sharded fold
    want_kernel, want_plain = dist_expected(torch, kernels, dev, spec)
    for key, want in want_kernel.items():
        for r, res in enumerate(ranks):
            got = res["runs"][0][key]
            w = want[r] if key == "act" else want
            check(same(got, w.cpu()),
                  f"phase 8: {key} on rank {r} != the kernels' per-shard "
                  f"grids folded here")
            w = want_plain[key][r] if key == "act" else want_plain[key]
            check(same(got, w.cpu()),
                  f"phase 8: {key} on rank {r} != the plain versions' "
                  f"sharded fold")
    counts = ranks[0]["launches"]
    for name, n in (("sum_accumulators", 2), ("dot_accumulators", 2),
                    ("matmul_accumulators", 2),
                    ("sum_accumulators_batched", 2)):
        check(counts[name] == n, f"phase 8: {name} launched {counts[name]} "
              f"times on rank 0 in two runs of the sharded calls, not {n}")
    # 3. the trainer
    ref = ranks[0]["train"][0]
    eng = kernels.engine.CompensatedReduction()
    for r, res in enumerate(ranks):
        for i, run in enumerate(res["train"]):
            check(same(run["loss"], ref["loss"]),
                  f"phase 8: the trainer's loss on rank {r} run {i} != rank "
                  f"0 run 0's")
            check(bool(torch.isfinite(run["loss"]).all()),
                  "phase 8: a trainer loss is not finite")
    steps, n_micro = spec["steps"], spec["micro"]
    micro = ref["micro"].view(steps, n_micro).to(dev)
    local_rel = []
    for step in range(steps):
        shards = micro[step].view(DIST_RANKS, -1)
        accs = [eng.sum_accumulators(s) for s in shards]
        folded = kernels.engine.merge_accumulators(
            torch.stack([a.s for a in accs]), torch.stack([a.c for a in accs]))
        sharded = folded / n_micro
        check(same(sharded.cpu(), ref["loss"][step]),
              f"phase 8: step {step + 1}'s loss != the sharded fold of its "
              f"microbatch losses recomputed here")
        s = c = torch.zeros((), device=dev)
        for v in micro[step]:
            s, c = K.kahan_step(s, c, v)
        local = (s + c) / n_micro
        local_rel.append(abs(float(sharded) - float(local))
                         / abs(float(local)))
        check(local_rel[-1] <= 1e-6,
              f"phase 8: step {step + 1}'s sharded loss is {local_rel[-1]:.2e}"
              f" (relative) from the local fold's")
    tcounts = ref["launches"]
    check(tcounts["sum_accumulators"] == steps,
          f"phase 8: the trainer launched B3 {tcounts['sum_accumulators']} "
          f"times in {steps} steps, not once a step (the loss fold)")
    for name, n in tcounts.items():
        check(n == 0 or name in ("sum_accumulators", "column_sq_accumulators"),
              f"phase 8: the trainer launched {name} {n} times")
    kernels.launches["sharded"] = counts
    kernels.launches["sharded-train"] = tcounts
    kernels.dist_times(spec)
    b3 = kernels.timing[("sum_accumulators", "kahan")]["ms"]
    peaks = [max(run["peak_bytes"] for run in res["train"]) for res in ranks]
    total = ranks[0]["total_bytes"]
    seconds = time.perf_counter() - t_start
    out = {"seconds": seconds, "gather_us": ranks[0]["gather_us"],
           "sharded_sum_ms": ranks[0]["sharded_sum_ms"],
           "single_rank_b3_ms": b3,
           "train_loss": ref["loss"].tolist(),
           "train_seconds": [run["seconds"] for run in ranks[0]["train"]],
           "local_fold_rel": local_rel,
           "peak_bytes": peaks, "card_bytes": total,
           "launches": counts, "train_launches": tcounts}
    log(f"# phase 8: 2 gloo ranks on the one card; sharded asum and dot at "
        f"n = {spec['n']}, matmul {list(spec['matmul'])} with K split 2, "
        f"activation_sq_norm {list(spec['act'])}, deterministic_mean, "
        f"compressed_psum {list(spec['leaf'])}: the same "
        f"bits on both ranks and in both runs, equal to the kernels' "
        f"per-shard grids folded here and to the plain versions' sharded "
        f"fold; B1, B3, B4, B5 twice each on a rank")
    log(f"# phase 8: the gather {out['gather_us']:.1f} us a call (one "
        f"[64, 128] grid, host clock); the sharded sum at n = {spec['n']} "
        f"{out['sharded_sum_ms']} ms (events, both ranks on one card) "
        f"against the single-rank B3 row {b3} ms (recorded, not gated)")
    log(f"# phase 8: OLMo-1B trained on the 2-rank mesh at full width, "
        f"CUT to {spec['cfg'].n_layers} of 16 layers, {steps} steps twice: "
        f"loss "
        f"{[round(x, 4) for x in out['train_loss']]} the same bits on both "
        f"ranks and run to run, equal to the sharded fold of its microbatch "
        f"losses recomputed here, within {max(local_rel):.1e} of the local "
        f"fold; peak {', '.join(f'{p / 2**30:.2f}' for p in peaks)} GiB a "
        f"rank of {total / 2**30:.1f}; {out['train_seconds'][0]:.1f} s the "
        f"first run's {steps} steps; phase 8 took {seconds:.1f} s")
    return out


def dist_expected(torch, kernels, dev, spec):
    """Phase 8's results as this process computes them on the card from
    the same inputs: the per-shard grids of the same kernels folded by
    ``merge_accumulators`` / ``merge_accumulator_grids``, and the plain
    versions' per-shard grids folded the same way."""
    from repro_torch.core import kahan as K
    from repro_torch.distributed.compression import dequantize, quantize

    engine, kd, ks, km = kernels.engine, kernels.kd, kernels.ks, kernels.km
    eng = engine.CompensatedReduction()
    d = [dist_inputs(torch, dev, r, spec) for r in range(DIST_RANKS)]
    x, y, a, b = d[0]["x"], d[0]["y"], d[0]["a"], d[0]["b"]
    n = DIST_RANKS
    xs, ys = x.view(n, -1), y.view(n, -1)
    kc = a.shape[1] // n
    a_sh = [a[:, r * kc:(r + 1) * kc].contiguous() for r in range(n)]
    b_sh = [b[r * kc:(r + 1) * kc] for r in range(n)]

    def pair(acc):
        return acc.s, acc.c

    def fold(grids):
        return engine.merge_accumulators(torch.stack([g[0] for g in grids]),
                                         torch.stack([g[1] for g in grids]))

    def fold_grids(grids):
        m, cols = a.shape[0], b.shape[1]
        return engine.merge_accumulator_grids(
            torch.stack([g[0] for g in grids]),
            torch.stack([g[1] for g in grids]))[:m, :cols]

    sch, u = eng.scheme, eng.unroll
    blocks = eng._matmul_blocks(a.shape[0], b.shape[1], kc, None, None, None)
    sq = d[0]["act"].reshape(spec["act"][0], -1) ** 2
    per = spec["act"][0] // n
    v = d[0]["values"]
    zero = torch.zeros((), device=dev)
    pairs = [K.kahan_step(zero, zero, v[r]) for r in range(n)]
    s = c = zero
    for ps, pc in pairs:
        s, c = K.kahan_combine(s, c, ps, pc)
    mean = K.div(K.add(s, c), K.scalar_like(n, s))
    scale = torch.max(torch.stack([dd["leaf"].abs().max() for dd in d]))
    total = sum(quantize(dd["leaf"], scale).to(torch.int32) for dd in d)
    compressed = dequantize(total, scale)
    common = {"mean": mean, "compressed": compressed}
    kernel = dict(common)
    kernel["asum"] = fold([pair(eng.sum_accumulators(s_))
                           for s_ in xs])
    kernel["dot"] = fold([pair(eng.dot_accumulators(p, q))
                          for p, q in zip(xs, ys)])
    kernel["matmul"] = fold_grids([pair(eng.matmul_accumulators(p, q))
                                   for p, q in zip(a_sh, b_sh)])
    kernel["act"] = [eng.batched_asum(sq[r * per:(r + 1) * per])
                     for r in range(n)]
    plain = dict(common)
    plain["asum"] = fold([tuple(g[0] for g in ks.sum_plain(
        eng._prep1d(s_)[None], scheme=sch, unroll=u)) for s_ in xs])
    plain["dot"] = fold([tuple(g[0] for g in kd.dot_plain(
        eng._prep1d(p)[None], eng._prep1d(q)[None], scheme=sch, unroll=u))
        for p, q in zip(xs, ys)])
    plain_grids = []
    for p, q in zip(a_sh, b_sh):
        pp, qq = eng._prep_matmul(p, q, blocks)
        gs, gc_ = km.matmul_plain(pp[None], qq[None], scheme=sch,
                                  block_k=blocks[2],
                                  compute_dtype=torch.float32)
        pad = (-a.shape[0]) % blocks[0]
        plain_grids.append(tuple(torch.nn.functional.pad(g[0], (0, 0, 0, pad))
                                 for g in (gs, gc_)))
    plain["matmul"] = fold_grids(plain_grids)
    plain["act"] = []
    for r in range(n):
        grids = ks.sum_plain(eng._prep2d(sq[r * per:(r + 1) * per]),
                             scheme=sch, unroll=u)
        plain["act"].append(engine.Accumulator(*grids).total())
    return kernel, plain


# ---------------------------------------------------------------------------
# Phase 15: the sharded steps (DeviceMesh / DTensor) and the dry run
# ---------------------------------------------------------------------------

def shard_spec(cfg, device="cuda"):
    """What phase 15's ranks run: OLMo-1B cut to SHARD_LAYERS layers, the
    shapes, the device."""
    return {"cfg": cfg.replace(n_layers=SHARD_LAYERS), "device": device,
            "train": SHARD_TRAIN, "prompt": SHARD_PROMPT,
            "decode": SHARD_DECODE, "max_len": SHARD_MAX_LEN,
            "lr": TRAIN_LR}


def shard_batch(torch, dev, cfg, spec):
    """The train batch (every rank the whole global batch) and the
    prompt tokens, from seeds."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train.trainer import batch_to_device

    b, s = spec["train"]
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                  global_batch=b))
    gen = torch.Generator(device=dev).manual_seed(15)
    prompt = torch.randint(0, cfg.vocab_size, spec["prompt"], generator=gen,
                           device=dev)
    return batch_to_device(data.batch_at(0), dev), prompt


def shard_models(spec):
    """(train config, serve config): the cut OLMo-1B, and the same with
    ``kahan_attention`` and float32 compute."""
    cfg = spec["cfg"]
    return cfg, cfg.replace(kahan_attention=True, compute_dtype="float32")


def shard_params(torch, model, dev):
    """Random weights from seed 0 (the same bits on every rank and in the
    parent)."""
    return model.init(torch.Generator(device=dev).manual_seed(0))


def shard_opt(kahan_norm, lr):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig

    return TrainConfig(steps=1, warmup=1,
                       opt=AdamWConfig(lr=lr, kahan_norm=kahan_norm))


@contextlib.contextmanager
def flash_capture(torch, calls):
    """Record every B7 call (``flash_attention``'s q, k, v and output, on
    the host) into ``calls``."""
    from repro_torch.kernels import flash_attention as fa

    inner = fa.flash_attention

    def recording(q, k, v, **kw):
        out = inner(q, k, v, **kw)
        calls.append({"q": q.cpu(), "k": k.cpu(), "v": v.cpu(),
                      "out": out.cpu(), "kw": kw})
        return out

    fa.flash_attention = recording
    try:
        yield calls
    finally:
        fa.flash_attention = inner


def comm_host_ms(torch, prof):
    """Host ms of the collectives in a profiled step, by kind."""
    kinds = {"all-gather": ("all_gather", "allgather"),
             "reduce-scatter": ("reduce_scatter",),
             "all-reduce": ("all_reduce", "allreduce"),
             "wait": ("wait_tensor",)}
    out = {k: 0.0 for k in kinds}
    for e in prof.key_averages():
        for kind, names in kinds.items():
            if any(n in e.key for n in names):
                out[kind] += e.cpu_time_total / 1e3
    return out


@contextlib.contextmanager
def gloo_cuda_all_gather(torch):
    """DTensor's all-gathers through c10d's ``all_gather_into_tensor``:
    gloo's functional all-gather crashes on CUDA tensors in the card's
    torch (SIGSEGV on both ranks under torch 2.11, where c10d's
    all-gather and the functional reduce-scatter and all-reduce work:
    ``scripts/gloo_cuda_probe.py``)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh

    def pg(group):
        if isinstance(group, tuple):
            return group[0].get_group(group[1])
        if isinstance(group, DeviceMesh):
            return group.get_group()
        if isinstance(group, str):
            return dist.distributed_c10d._resolve_process_group(group)
        return group

    def all_gather_tensor(self, gather_dim, group, tag=""):
        group = pg(group)
        n = dist.get_world_size(group)
        x = self.contiguous()
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        if gather_dim:
            out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
        return out

    inner = funcol.all_gather_tensor
    funcol.all_gather_tensor = all_gather_tensor
    try:
        yield
    finally:
        funcol.all_gather_tensor = inner


def shard_rank(rank, store, out, spec):
    """One rank of phase 15, in its own process on the one card: a gloo
    world of 2 over a ``FileStore``. (a) the train step that
    ``build_cell`` and TRAIN_RULES make on a (data 2, model 1) mesh, with
    the column-scan norm and with B3's, twice each (launch counts reset
    just before, read just after each), then one more profiled for the
    collectives' host time; (b) on a (data 1, model 2) mesh under
    SERVE_RULES the prefill (B7 on the rank's heads, each call recorded)
    and SHARD_DECODE decode steps. Writes its results to ``out``."""
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    sys.path.insert(0, str(ROOT / "src"))

    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, DIST_RANKS),
                            rank=rank, world_size=DIST_RANKS)
    with gloo_cuda_all_gather(torch) if cuda else contextlib.nullcontext():
        shard_steps(rank, out, spec, dev)
    dist.barrier()
    dist.destroy_process_group()


def shard_steps(rank, out, spec, dev):
    """``shard_rank``'s work in its initialised world."""
    import gc

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import engine
    from repro_torch.launch.specs import (build_cell, distribute_args,
                                          run_sharded)
    from repro_torch.models import build_model
    from repro_torch.optim import init as opt_init

    cuda = dev.type == "cuda"
    names = ("data", "model")
    cfg, scfg = shard_models(spec)
    batch, prompt = shard_batch(torch, dev, cfg, spec)
    res = {"train": {}}

    # (a) the train step, data-parallel with FSDP weights
    mesh = init_device_mesh(dev.type, (DIST_RANKS, 1), mesh_dim_names=names)
    model = build_model(cfg, dev)
    b, s = spec["train"]
    shape = ShapeSpec("shard-train", "train", s, b)
    for kahan_norm in (True, False):
        runs = []
        for _ in range(2):
            tc = shard_opt(kahan_norm, spec["lr"])
            cell = build_cell(cfg, shape, tc, model=model)
            params = shard_params(torch, model, dev)
            args = distribute_args(mesh, shd.TRAIN_RULES, cell,
                                   (params, opt_init(tc.opt, params), batch))
            del params
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            engine.reset_launch_counts()
            sync(torch, dev)
            t0 = time.perf_counter()
            _, _, m = run_sharded(cell, mesh, shd.TRAIN_RULES, args)
            sync(torch, dev)
            runs.append({"loss": m["loss"].full_tensor().float().cpu(),
                         "grad_norm": m["grad_norm"].float().cpu(),
                         "launches": engine.launch_counts(),
                         "seconds": time.perf_counter() - t0,
                         "peak_bytes": torch.cuda.max_memory_allocated(dev)
                         if cuda else 0})
            del args, m, cell
            gc.collect()
        res["train"][kahan_norm] = runs
        log(f"# phase 15 rank {rank}: train step (kahan_norm={kahan_norm}) "
            f"twice, {runs[-1]['seconds']:.2f} s the second")
    from torch.profiler import ProfilerActivity, profile

    tc = shard_opt(True, spec["lr"])
    cell = build_cell(cfg, shape, tc, model=model)
    params = shard_params(torch, model, dev)
    args = distribute_args(mesh, shd.TRAIN_RULES, cell,
                           (params, opt_init(tc.opt, params), batch))

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_sharded(cell, mesh, shd.TRAIN_RULES, args)
        sync(torch, dev)
    res["comm_ms"] = comm_host_ms(torch, prof)
    log(f"# phase 15 rank {rank}: profiled step done")
    del args, params, cell, model, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (b) prefill and decode, heads and the cache's positions on "model"
    smesh = init_device_mesh(dev.type, (1, DIST_RANKS), mesh_dim_names=names)
    rules = shd.SERVE_RULES
    smodel = build_model(scfg, dev)
    pb = spec["prompt"][0]
    pcell = build_cell(scfg, ShapeSpec("p", "prefill", spec["max_len"], pb),
                       model=smodel)
    dcell = build_cell(scfg, ShapeSpec("d", "decode", spec["max_len"], pb),
                       model=smodel)
    params, tokens, cache = distribute_args(
        smesh, rules, pcell, (shard_params(torch, smodel, dev),
                              {"tokens": prompt},
                              smodel.init_cache(pb, spec["max_len"])))
    res["cache_placements"] = str(cache["blocks"][0].placements)
    calls = []
    engine.reset_launch_counts()
    with flash_capture(torch, calls):
        logits, cache = run_sharded(pcell, smesh, rules,
                                    (params, tokens, cache))
    sync(torch, dev)
    res["prefill_launches"] = engine.launch_counts()
    log(f"# phase 15 rank {rank}: prefill done")
    res["flash"] = calls
    res["logits"] = [logits.full_tensor().cpu()]
    t0 = time.perf_counter()
    for i in range(spec["decode"]):
        tok = torch.argmax(res["logits"][-1][:, :scfg.vocab_size], -1)
        tok = distribute_args(smesh, rules, dcell,
                              (None, None, tok.to(dev), None))[2]
        logits, cache = run_sharded(dcell, smesh, rules,
                                    (params, cache, tok,
                                     spec["prompt"][1] + i))
        res["logits"].append(logits.full_tensor().cpu())
    sync(torch, dev)
    res["decode_ms"] = (time.perf_counter() - t0) / spec["decode"] * 1e3
    torch.save(res, out)


def shard_unsharded(torch, kernels, spec):
    """The same steps on this process, unsharded: the train step under
    both norms (loss, grad norm, peak memory), the prefill and decode
    steps (logits)."""
    stamp("phase 15: the unsharded steps")
    import gc

    from repro_torch.core import tree as T
    from repro_torch.models import build_model
    from repro_torch.optim import init as opt_init
    from repro_torch.train import make_train_step
    from repro_torch.train.serve import make_decode_step, make_prefill_step

    dev = kernels.dev
    cfg, scfg = shard_models(spec)
    batch, prompt = shard_batch(torch, dev, cfg, spec)
    out = {"train": {}}
    model = build_model(cfg, dev)
    for kahan_norm in (True, False):
        tc = shard_opt(kahan_norm, spec["lr"])
        params = T.tree_map(lambda p: p.requires_grad_(),
                            shard_params(torch, model, dev))
        state = opt_init(tc.opt, params)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _, _, m = make_train_step(model, cfg, tc)(params, state, batch)
        sync(torch, dev)
        out["train"][kahan_norm] = {
            "loss": m["loss"].float().cpu(),
            "grad_norm": m["grad_norm"].float().cpu(),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0}
        del params, state, m
        gc.collect()
    smodel = build_model(scfg, dev)
    params = shard_params(torch, smodel, dev)
    cache = smodel.init_cache(spec["prompt"][0], spec["max_len"])
    logits, cache = make_prefill_step(smodel)(params, {"tokens": prompt},
                                              cache)
    out["logits"] = [logits.cpu()]
    decode = make_decode_step(smodel)
    for i in range(spec["decode"]):
        tok = torch.argmax(logits[:, :scfg.vocab_size], -1)
        logits, cache = decode(params, cache, tok, spec["prompt"][1] + i)
        out["logits"].append(logits.cpu())
    del params, cache, smodel, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


class DryRun:
    """Phase 15(c): the dry run of SHARD_DRYRUN's cells, each row of it in
    a subprocess of its own (the host's CPU, fake tensors, a fake world of
    256 or 512 ranks). It needs no kernel and no card, so the script starts
    it beside the build, and phase 15 reads it: SHARD_DRYRUN_S seconds from
    the start for all of them; each cell must reach ``status: ok``.
    ``stop`` ends what still runs and removes the outputs."""

    def __init__(self):
        import tempfile

        (ROOT / "build").mkdir(parents=True, exist_ok=True)
        self.outdir = Path(tempfile.mkdtemp(prefix="dryrun-",
                                            dir=ROOT / "build"))
        self.deadline = time.perf_counter() + SHARD_DRYRUN_S
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.procs = []
        for i, (arch, shape, both) in enumerate(SHARD_DRYRUN):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out",
                   str(self.outdir)] + (["--both-meshes"] if both else [])
            err = open(self.outdir / f"stderr{i}.txt", "w")
            self.procs.append(subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                stderr=err))
            err.close()

    def cells(self):
        """Waits for every cell (until the deadline), checks each and logs
        its terms; returns them."""
        cells = []
        for i, ((arch, shape, both), proc) in enumerate(zip(SHARD_DRYRUN,
                                                            self.procs)):
            left = max(0.0, self.deadline - time.perf_counter())
            try:
                rc = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"chip_smoke: phase 15(c): the dry run "
                                   f"of {arch} x {shape} passed the "
                                   f"{SHARD_DRYRUN_S} s limit")
            err = (self.outdir / f"stderr{i}.txt").read_text()
            check(rc == 0, f"phase 15(c): the dry run of {arch} x {shape} "
                  f"exited with {rc}: {err[-1500:]}")
            for mesh in (("16x16", "2x16x16") if both else ("16x16",)):
                cell = json.loads((self.outdir / f"{arch}__{shape}__{mesh}"
                                   f".json").read_text())
                check(cell["status"] == "ok", f"phase 15(c): {arch} x {shape}"
                      f" x {mesh}: status {cell['status']}")
                keep = ("arch", "shape", "mesh", "chips", "flops_per_device",
                        "bytes_per_device", "collective_bytes_per_device",
                        "compute_s", "memory_s", "collective_s", "dominant",
                        "roofline_fraction", "peak_memory_bytes",
                        "kernel_work", "setup_s", "step_s")
                cells.append({k: cell[k] for k in keep})
                log(f"# phase 15(c): {arch} x {shape} x {mesh} "
                    f"({cell['chips']} fake ranks): compute "
                    f"{cell['compute_s'] * 1e3:.3f} ms, memory "
                    f"{cell['memory_s'] * 1e3:.3f} ms, collective "
                    f"{cell['collective_s'] * 1e3:.3f} ms, dominant "
                    f"{cell['dominant']}, roofline fraction "
                    f"{cell['roofline_fraction']:.4f}; setup "
                    f"{cell['setup_s']} s and step {cell['step_s']} s on the "
                    f"host, beside the build and phases 2-14")
        return cells

    def stop(self):
        import shutil

        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.outdir, ignore_errors=True)


def shard_path(torch, kernels, spec, dryrun):
    """Phase 15: the sharded steps on two gloo ranks sharing the card,
    against the unsharded steps of this process, then the dry run
    (``dryrun``, a ``DryRun`` started with the script).
    Gates: (a) the train step's loss within STEP1_LOSS_RTOL and its grad
    norm within STEP1_GRAD_NORM_RTOL of the unsharded step's (relative),
    under the column-scan norm and under B3's; the loss and the norm the
    same bits on both ranks and in both runs; the column scan launched
    under the first, B3 under the second. (b) the prefill and every
    decode step's logits within SHARD_SERVE_RTOL (relative L2) of the
    unsharded steps' with the same argmax on every row, the same bits on
    both ranks; B7 launched once a layer on each rank, its outputs on the
    rank's heads bitwise equal to one unsharded launch over both ranks'
    heads. (c) every dry-run cell ``status: ok``."""
    import gc
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    t_start = time.perf_counter()
    dev = kernels.dev
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stamp("phase 15: the two ranks")
    scratch = Path(tempfile.mkdtemp(prefix="shard-", dir=ROOT / "build"))
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=shard_rank, args=(
            r, str(scratch / "store"), str(scratch / f"rank{r}.pt"), spec))
            for r in range(DIST_RANKS)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + RANKS_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.perf_counter()))
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
            check(p.exitcode == 0, f"phase 15: rank {r} exited with "
                  f"{p.exitcode}")
        ranks = [torch.load(scratch / f"rank{r}.pt", weights_only=False)
                 for r in range(DIST_RANKS)]
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    t_ranks = time.perf_counter() - t_start
    want = shard_unsharded(torch, kernels, spec)

    def same(x, y):
        return (x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)))

    # (a) the train step
    rel = {}
    for kahan_norm in (True, False):
        ref = ranks[0]["train"][kahan_norm][0]
        for r, res in enumerate(ranks):
            for i, run in enumerate(res["train"][kahan_norm]):
                for q in ("loss", "grad_norm"):
                    check(same(run[q], ref[q]), f"phase 15(a): {q} "
                          f"(kahan_norm={kahan_norm}) on rank {r} run {i} != "
                          f"rank 0 run 0's")
        for q, limit in (("loss", STEP1_LOSS_RTOL),
                         ("grad_norm", STEP1_GRAD_NORM_RTOL)):
            u = float(want["train"][kahan_norm][q])
            got = float(ref[q])
            rel[(kahan_norm, q)] = abs(got - u) / abs(u)
            check(rel[(kahan_norm, q)] <= limit,
                  f"phase 15(a): the sharded {q} {got:.6f} "
                  f"(kahan_norm={kahan_norm}) is "
                  f"{rel[(kahan_norm, q)]:.2e} from the unsharded step's "
                  f"{u:.6f}, over {limit}")
    ca = ranks[0]["train"][True][0]["launches"]
    cb = ranks[0]["train"][False][0]["launches"]
    check(ca["column_sq_accumulators"] > 0, "phase 15(a): the column scan "
          "never launched under kahan_norm")
    check(cb["sum_accumulators"] > 0, "phase 15(a): B3 never launched under "
          "kahan_norm=False")
    for name, n in list(ca.items()) + list(cb.items()):
        check(n == 0 or name in ("sum_accumulators",
                                 "column_sq_accumulators"),
              f"phase 15(a): the sharded step launched {name} {n} times")
    # (b) prefill and decode
    serve_rel = []
    for i, u in enumerate(want["logits"]):
        u = u[:, :spec["cfg"].vocab_size].double()
        for r, res in enumerate(ranks):
            check(same(res["logits"][i], ranks[0]["logits"][i]),
                  f"phase 15(b): step {i}'s logits on rank {r} != rank 0's")
        g = ranks[0]["logits"][i][:, :spec["cfg"].vocab_size].double()
        serve_rel.append(float((g - u).norm() / u.norm()))
        check(serve_rel[-1] <= SHARD_SERVE_RTOL,
              f"phase 15(b): step {i}'s sharded logits are "
              f"{serve_rel[-1]:.2e} (relative L2) from the unsharded step's")
        check(bool((g.argmax(-1) == u.argmax(-1)).all()),
              f"phase 15(b): step {i}'s argmax differs from the unsharded "
              f"step's")
    layers = spec["cfg"].n_layers
    pc = ranks[0]["prefill_launches"]
    check(pc["flash_accumulators"] == layers,
          f"phase 15(b): B7 launched {pc['flash_accumulators']} times in the "
          f"prefill on rank 0, not once a layer ({layers})")
    check(len(ranks[0]["flash"]) == layers and len(ranks[1]["flash"])
          == layers, "phase 15(b): B7 not recorded once a layer")
    from repro_torch.kernels import flash_attention as fa

    b = spec["prompt"][0]
    for layer in range(layers):
        # a rank's head-rows are [batch, its heads]-major: the unsharded
        # launch takes every rank's heads in rank order within each row
        calls = [res["flash"][layer] for res in ranks]
        q, k, v = (torch.cat([c[n].view(b, -1, *c[n].shape[1:])
                              for c in calls], 1).flatten(0, 1).to(dev)
                   for n in ("q", "k", "v"))
        one = fa.flash_attention(q, k, v, **calls[0]["kw"]).cpu()
        one = one.view(b, DIST_RANKS, -1, *one.shape[1:])
        for r, c in enumerate(calls):
            check(same(c["out"], one[:, r].flatten(0, 1).contiguous()),
                  f"phase 15(b): layer {layer}: B7 on rank {r}'s heads != "
                  f"the unsharded launch's")
    kernels.launches["sharded-train-a"] = ca
    kernels.launches["sharded-train-b"] = cb
    kernels.launches["sharded-serve"] = pc
    kernels.path_labels.update({
        ("column_sq_accumulators", "sharded-train-a"): "sharded-norm",
        ("sum_accumulators", "sharded-train-b"): "sharded-norm",
        ("flash_accumulators", "sharded-serve"): "sharded-heads"})
    stamp("phase 15: the rows' times")
    kernels.shard_times(spec, ranks[0]["flash"][0])
    stamp("phase 15: the dry run's end")
    t_dry = time.perf_counter()
    cells = dryrun.cells()
    t_dry = time.perf_counter() - t_dry
    seconds = time.perf_counter() - t_start
    tr = {str(k): {"sharded": [run["peak_bytes"] for res in ranks
                               for run in res["train"][k]],
                   "unsharded": want["train"][k]["peak_bytes"],
                   "seconds": [run["seconds"] for run in
                               ranks[0]["train"][k]]}
          for k in (True, False)}
    out = {"seconds": seconds, "ranks_seconds": t_ranks,
           "dryrun_seconds": t_dry, "layers": layers,
           "train_rel": {f"{k[1]}_{k[0]}": v for k, v in rel.items()},
           "train_loss": float(ranks[0]["train"][True][0]["loss"]),
           "grad_norm": {str(k): float(ranks[0]["train"][k][0]["grad_norm"])
                         for k in (True, False)},
           "train": tr, "comm_host_ms": ranks[0]["comm_ms"],
           "serve_rel": serve_rel, "decode_ms": ranks[0]["decode_ms"],
           "cache_placements": ranks[0]["cache_placements"],
           "launches": {"train-a": ca, "train-b": cb, "serve": pc},
           "dryrun": cells}
    log(f"# phase 15(a): OLMo-1B ({layers} of 16 layers) train step on a "
        f"(data 2, model 1) mesh, batch {list(spec['train'])}: loss and "
        f"grad norm the same bits on both ranks and in two runs; against "
        f"the unsharded step loss {rel[(True, 'loss')]:.2e} / "
        f"{rel[(False, 'loss')]:.2e}, grad norm "
        f"{rel[(True, 'grad_norm')]:.2e} / {rel[(False, 'grad_norm')]:.2e}"
        f" (column scan / B3: {ca['column_sq_accumulators']} / "
        f"{cb['sum_accumulators']} launches a step); peak "
        f"{max(tr['True']['sharded']) / 2**30:.2f} GiB a rank against "
        f"{tr['True']['unsharded'] / 2**30:.2f} unsharded; collectives "
        f"{ {k: round(v, 2) for k, v in out['comm_host_ms'].items()} } "
        f"host ms a step")
    log(f"# phase 15(b): prefill {list(spec['prompt'])} then "
        f"{spec['decode']} decode steps on a (data 1, model 2) mesh, cache "
        f"{out['cache_placements']}: logits within "
        f"{max(serve_rel):.2e} of the unsharded steps', the same argmax, "
        f"the same bits on both ranks; B7 {layers} times a rank on its "
        f"{ranks[0]['flash'][0]['q'].shape[0]} head-rows, bitwise equal to "
        f"the unsharded launch's; {out['decode_ms']:.1f} ms a decode step")
    log(f"# phase 15 took {seconds:.1f} s (ranks {t_ranks:.1f}, waiting "
        f"for the dry run {t_dry:.1f})")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the cost auditor's SASS level
# ---------------------------------------------------------------------------

def cost_path():
    """Phase 16: ``costmodel.audit`` with the SASS level registered (the
    probes of ``csrc/cost_probe.cu`` and the census of the shipping
    libraries, from phase 1's builds), its probe lines and census line
    logged. Gate: no finding. Returns the per-probe counts and the
    census totals."""
    from repro_torch.analysis import costmodel, targets
    from repro_torch.core import ecm
    from repro_torch.kernels import schemes
    from repro_torch.perf import sass_analysis

    t0 = time.perf_counter()
    costmodel.register_sass()
    report = costmodel.audit()
    for v in report.violations:
        log(f"# phase 16 finding: {v.format()}")
    out = {"probes": {}, "findings": len(report.violations),
           "cells": report.files}
    naive = {}
    probes = sorted(t for t in targets.names()
                    if t.startswith("sass.probe."))
    arts = {t: targets.get(t).build() for t in probes}
    for tid, art in arts.items():
        if art.scheme == "naive":
            naive[(art.path, art.dtype)] = art.adds + art.muls
    for tid, art in arts.items():
        want = costmodel.declared_probe_mix(art)
        streams = 2 if art.path == "dot" else 1
        elem = {"f32": 4, "f64": 8, "bf16": 2}[art.dtype]
        flops = art.adds + art.muls
        dep = ecm.CHAIN_OPS.get(schemes.get(art.scheme).device_id, flops)
        kernel = ecm.GPUKernel(name=tid, streams=streams, elem_bytes=elem,
                               flops=flops, dep_ops=dep)
        base = dataclasses.replace(kernel, flops=naive[(art.path,
                                                        art.dtype)],
                                   dep_ops=1)
        r = ecm.ecm_gpu(ecm.H100, kernel, costmodel.RATIO_N,
                        costmodel.RATIO_UNROLL)
        b = ecm.ecm_gpu(ecm.H100, base, costmodel.RATIO_N,
                        costmodel.RATIO_UNROLL)
        ratio = r.pred_ms / b.pred_ms
        moves = {op: n for op, n in art.opcodes.items()
                 if op in sass_analysis.CONVERSION_OPS}
        log(f"# phase 16 probe {art.path} {art.scheme} {art.dtype}: SASS "
            f"{art.adds} adds + {art.muls} muls "
            f"{sass_analysis.float_ops(art.opcodes)}, declared {want[0]} + "
            f"{want[1]}; conversions {moves or 'none'}; ECM {ratio:.4f}x "
            f"naive ({r.bound}-bound)")
        out["probes"][tid] = {"adds": art.adds, "muls": art.muls,
                              "declared": list(want), "ecm_ratio": ratio,
                              "bound": r.bound, "conversions": moves}
    census = targets.get("sass.census").build()
    tally = {}
    for fn, ops in census.functions.items():
        kernel = sass_analysis.kernel_of(fn)
        row = tally.setdefault(kernel, {"functions": 0, "tensor_core": 0,
                                        "FFMA": 0, "DFMA": 0, "FADD": 0,
                                        "DADD": 0, "FMUL": 0})
        row["functions"] += 1
        row["tensor_core"] += sum(n for op, n in ops.items()
                                  if op in sass_analysis.TENSOR_CORE_OPS)
        for op in ("FFMA", "DFMA", "FADD", "DADD", "FMUL"):
            row[op] += ops.get(op, 0)
    log(f"# phase 16 census: {len(census.functions)} kernel functions in "
        f"{', '.join(costmodel.SHIPPING)}: "
        + "; ".join(f"{k} {v}" for k, v in sorted(tally.items())))
    out["census"] = tally
    # each flash instantiation's conversions beside its arithmetic, and
    # those of the matmul kernels in bfloat16 (Bf16) and float64 (ddd)
    # compute (the bfloat16 tiles round with F2FP)
    shown = {"flash": {}, "matmul": {}}
    for fn, ops in sorted(census.functions.items()):
        kernel = sass_analysis.kernel_of(fn)
        if kernel == "kahan_flash_grid" or (
                kernel.startswith("kahan_matmul")
                and ("Bf16" in fn or "dddLi" in fn)):
            name = fn[fn.index(kernel):]
            row = {op: ops.get(op, 0)
                   for op in ("F2FP", "F2F", "PRMT", "FADD", "FMUL", "DADD",
                              "DMUL", "LDS")}
            shown["flash" if kernel == "kahan_flash_grid"
                  else "matmul"][name] = row
            log(f"# phase 16 census {name}: {row}")
    out["flash_functions"] = shown["flash"]
    out["matmul_functions"] = shown["matmul"]
    seconds = time.perf_counter() - t0
    out["seconds"] = seconds
    log(f"# phase 16 took {seconds:.1f} s ({report.files} audited cells, "
        f"{len(report.violations)} findings)")
    check(not report.violations,
          f"phase 16: {len(report.violations)} cost finding(s): "
          + "; ".join(v.format() for v in report.violations[:5]))
    return out


# -- 17. every family's train step --------------------------------------------

#: phase 17: each family's config at its published width (random weights
#: from seed 0, the config's own dtypes), its depth cut to what the
#: phase's time allows with every kind of block kept: qwen2.5-3b 2 of 36
#: layers, internvl2-2b 2 of 24, deepseek-v2-lite-16b 2 of 27 (its dense
#: first layer and one MoE layer), hymba-1.5b 4 of 32 (global, window,
#: window, global), xlstm-1.3b 8 of 48 (one group: 7 mLSTM and 1 sLSTM
#: block), whisper-large-v3 2 of 32 encoder and 2 of 32 decoder layers
#: (the encoder over its 1500 frames). Phase 6's batch, lr and limits
#: (internvl2-2b's sequences carry its 256 patches before the 256 tokens)
FAMILY_TRAIN = ("qwen2.5-3b", "internvl2-2b", "deepseek-v2-lite-16b",
                "hymba-1.5b", "xlstm-1.3b", "whisper-large-v3")
FAMILY_CUTS = {"qwen2.5-3b": dict(n_layers=2),
               "internvl2-2b": dict(n_layers=2),
               "deepseek-v2-lite-16b": dict(n_layers=2),
               "hymba-1.5b": dict(n_layers=4, global_attn_layers=(0, 3)),
               "xlstm-1.3b": dict(n_layers=8),
               "whisper-large-v3": dict(n_layers=2, encoder_layers=2)}
#: the configs whose runs A and B are compared in float32 compute, their
#: own compute dtype's runs logged beside: bf16 reroutes MoE tokens
#: between two bodies (phase 10)
FAMILY_TRAIN_F32 = ("deepseek-v2-lite-16b",)
#: the timing row (``Kernels.family_train_times``) of each run B's B5
#: launches in the kernels line: a padded projection of its own shapes
FAMILY_B5_ROW = {"qwen2.5-3b": "train-qwen-dA-up",
                 "internvl2-2b": "train-up",
                 "deepseek-v2-lite-16b": "train-deepseek-shared-up",
                 "hymba-1.5b": "train-hymba-up",
                 "whisper-large-v3": "train-whisper-encode-up"}
#: B5's padded backward, held bitwise to the plain version: [M, K] x [K,
#: N] with K or N off the engine's blocks (qwen2.5-3b's up and down
#: 11008 -> 11264, deepseek-v2-lite's shared expert 2816 -> 3072)
PADDED_BACKWARD = ((128, 2048, 11008), (128, 11008, 2048),
                   (128, 2048, 2816), (128, 2816, 2048))
#: the smoke configs stepped once each under the deterministic-algorithm
#: probe: every family, llama4-maverick too
PROBE_ARCHS = ("olmo-1b", "qwen2.5-3b", "internvl2-2b",
               "deepseek-v2-lite-16b", "llama4-maverick-400b-a17b",
               "hymba-1.5b", "xlstm-1.3b", "whisper-large-v3")
#: the card's memory: a run's peak must stay below it
CARD_BYTES = 80e9


def family_config(name):
    """``name``'s published config cut to ``FAMILY_CUTS[name]``."""
    from repro_torch.configs import get_config

    cut = dict(FAMILY_CUTS[name])
    cfg = get_config(name)
    enc = cut.pop("encoder_layers", None)
    if enc is not None:
        cut["encoder"] = dataclasses.replace(cfg.encoder, n_layers=enc)
    return cfg.replace(**cut)


def train_data(cfg, seq, batch):
    """The synthetic stream of ``cfg``'s train step: patch embeddings for
    a VLM, frames for an encoder-decoder."""
    from repro_torch.data import DataConfig, SyntheticLM

    return SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        vision_patches=cfg.vision.n_patches if cfg.vision else 0,
        d_model=cfg.d_model,
        n_frames=cfg.encoder.n_frames if cfg.encoder else 0))


def train_b5_per_step(model) -> int:
    """B5 launches a train step of ``TRAIN_MICRO`` microbatches under
    ``kahan_matmul``, from the code: each projection of a layer run under
    ``torch.utils.checkpoint`` four times a microbatch (forward, recompute,
    dA, dB), each of whisper's encoder (run once, outside it) three times;
    xLSTM's projections are einsums in the reference too (none)."""
    cfg = model.cfg
    if cfg.xlstm is not None:
        per = 0
    elif cfg.encoder is not None:
        per = 3 * 6 * cfg.encoder.n_layers + 4 * 8 * cfg.n_layers
    elif cfg.moe is not None:
        per = 4 * b5_per_position(model)
    else:
        per = 4 * PROJECTIONS * cfg.n_layers
    return per * TRAIN_MICRO


def same_bits(torch, x, y) -> bool:
    """``x`` and ``y`` hold the same bits (a zero's sign included)."""
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        x, y = (t.view(ints[t.element_size()]) for t in (x, y))
    return torch.equal(x, y)


def family_train_path(torch, kernels, card):
    """Phase 17: every family's train step on the card, through the port's
    ``make_train_step`` (``family_train`` a config); B5's padded backward
    against its plain version; one smoke step of every family under the
    deterministic-algorithm probe; the crash-restart at the MoE smoke
    config."""
    kernels.padded_backward_parity()
    kernels.family_train_times()
    out = {}
    for name in FAMILY_TRAIN:
        cfg = family_config(name)
        if name in FAMILY_TRAIN_F32:
            out[name] = family_train(torch, kernels,
                                     cfg.replace(compute_dtype="float32"),
                                     card, gate=True)
            out[f"{name}-{cfg.compute_dtype}"] = family_train(
                torch, kernels, cfg, card, gate=False)
        else:
            out[name] = family_train(torch, kernels, cfg, card, gate=True)
    stamp("phase 17: the deterministic-algorithm probe")
    out["probe"] = deterministic_probe(torch, kernels.dev)
    stamp("phase 17: the crash-restart at the MoE smoke config")
    out["resume"] = resume_check(torch, kernels.dev, "deepseek-v2-lite-16b")
    return out


def family_train(torch, kernels, cfg, card, gate):
    """Phase 17 on one config: the model and its weights once, then run A
    (cuBLAS projections, the column-scan norm) and run B
    (``kahan_matmul``, ``kahan_norm=False``: B3 once a leaf) from the same
    weights and batches (``family_run``). Checked: every loss and grad
    norm finite; with ``gate``, run B's step-1 loss and grad norm within
    phase 6's limits of run A's; each step's launch counts; the first
    step repeated bitwise in each run; the peak below the card's memory.
    Logged with the card: wall ms a step after the first, device-busy ms
    of the profiled step, B5 ms a step, peak GiB."""
    from repro_torch.core import tree as T
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.trainer import batch_to_device

    dev = kernels.dev
    what = f"{cfg.name} ({cfg.n_layers} layers, {cfg.compute_dtype})"
    stamp(f"phase 17 {what}: the model and its weights")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # a VLM's patches take the first positions, masked out of the loss:
    # its sequences carry them before phase 6's 256 text tokens
    seq = TRAIN_SEQ + (cfg.vision.n_patches if cfg.vision else 0)
    data = train_data(cfg, seq, TRAIN_BATCH)
    batches = [batch_to_device(data.batch_at(i), dev) for i in range(2)]
    model = build_model(cfg, dev)
    start = model.init(torch.Generator(device=dev).manual_seed(0))
    leaves = T.leaves(start)
    tall = sum(x.dim() >= 2 and x.shape[0] > 1 for x in leaves)
    b5 = train_b5_per_step(model)
    want = {"A": {"column_sq_accumulators": tall},
            "B": {"matmul_accumulators": b5, "sum_accumulators": len(leaves)}}
    runs = {}
    for run, rcfg, opt in (
            ("A", cfg, AdamWConfig(lr=TRAIN_LR)),
            ("B", cfg.replace(kahan_matmul=True),
             AdamWConfig(lr=TRAIN_LR, kahan_norm=False))):
        rmodel = model if run == "A" else build_model(rcfg, dev)
        runs[run] = family_run(torch, kernels.dev, rmodel, rcfg, start,
                               batches, opt, f"{what} run {run}", card)
        for i, counts in enumerate(runs[run].pop("counts")):
            for name, n in counts.items():
                check(n == want[run].get(name, 0),
                      f"phase 17 {what} run {run} step {i + 1}: {name} "
                      f"launched {n} times, want {want[run].get(name, 0)}")
    peak = torch.cuda.max_memory_allocated(dev)
    a, b = runs["A"], runs["B"]
    for run in (a, b):
        check(all(math.isfinite(x) and x > 0
                  for x in run["loss"] + run["grad_norm"]),
              f"phase 17 {what}: a loss or grad norm is not finite and "
              f"positive: {run['loss']}, {run['grad_norm']}")
    rel = abs(b["loss"][0] - a["loss"][0]) / a["loss"][0]
    rel_g = abs(b["grad_norm"][0] - a["grad_norm"][0]) / a["grad_norm"][0]
    if gate:
        check(rel < STEP1_LOSS_RTOL,
              f"phase 17 {what}: run B's step-1 loss {b['loss'][0]:.6f} "
              f"differs from run A's {a['loss'][0]:.6f} by {rel:.2e}")
        check(rel_g < STEP1_GRAD_NORM_RTOL,
              f"phase 17 {what}: run B's step-1 grad norm "
              f"{b['grad_norm'][0]:.6f} differs from run A's "
              f"{a['grad_norm'][0]:.6f} by {rel_g:.2e}")
    check(peak < CARD_BYTES,
          f"phase 17 {what}: peak {peak / 2 ** 30:.2f} GiB")
    path = f"train-{cfg.name}" + ("" if gate else f"-{cfg.compute_dtype}")
    kernels.launches[f"{path}-a"] = a["launches"]
    kernels.launches[f"{path}-b"] = b["launches"]
    kernels.path_labels[("column_sq_accumulators", f"{path}-a")] = "train"
    kernels.path_labels[("sum_accumulators", f"{path}-b")] = "train"
    if b5:
        kernels.path_labels[("matmul_accumulators", f"{path}-b")] = (
            FAMILY_B5_ROW[cfg.name])
    log(f"# phase 17 {what} on {card}: run B's step-1 loss within {rel:.2e} "
        f"of run A's (limit {STEP1_LOSS_RTOL}{'' if gate else ', logged'}), "
        f"grad norm within {rel_g:.2e} (limit {STEP1_GRAD_NORM_RTOL}); B5 "
        f"{b5}, B3 {len(leaves)} and the column scan {tall} launches a step; "
        f"peak {peak / 2 ** 30:.2f} GiB; first step repeated bitwise in both "
        f"runs")
    out = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                      "compute_dtype": cfg.compute_dtype,
                      "param_dtype": cfg.param_dtype},
           "A": a, "B": b, "step1_loss_rel": rel, "step1_grad_norm_rel": rel_g,
           "gated": gate, "b5_launches_per_step": b5,
           "b3_launches_per_step": len(leaves), "column_scans_per_step": tall,
           "peak_bytes": peak, "card": card}
    del model, start, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_run(torch, dev, model, cfg, start, batches, opt, what, card):
    """One run of ``make_train_step`` (``TRAIN_MICRO`` microbatches,
    warmup 1) from the weights ``start``: step 1, step 1 again from the
    same params, fresh optimizer state and batch (every param and moment
    leaf, the loss and the grad norm bitwise equal to the first's; its
    wall ms the step's time after the first), then step 2 under the
    profiler (device-busy ms, the port's kernels' ms). Each step's launch
    counts (reset just before it) go back under ``counts``, their sum
    under ``launches``."""
    from repro_torch.core import tree as T
    from repro_torch.kernels.engine import launch_counts, reset_launch_counts
    from repro_torch.optim import init as opt_init
    from repro_torch.train import TrainConfig, make_train_step

    step = make_train_step(model, cfg, TrainConfig(
        steps=2, microbatches=TRAIN_MICRO, warmup=1, opt=opt))
    params = T.tree_map(lambda p: p.clone().requires_grad_(), start)
    counts, metrics = [], []

    def fresh():
        with torch.no_grad():
            for p, s in zip(T.leaves(params), T.leaves(start)):
                p.copy_(s)
        return opt_init(opt, params)

    def one(state, batch):
        reset_launch_counts()
        _, state, m = step(params, state, batch)
        sync(torch, dev)
        counts.append(launch_counts())
        metrics.append({k: m[k].detach().clone() for k in ("loss",
                                                             "grad_norm")})
        return state

    stamp(f"phase 17 {what}: step 1")
    state = one(fresh(), batches[0])
    first = [x.clone() for x in T.leaves((params, state))]
    state = fresh()
    stamp(f"phase 17 {what}: step 1 again")
    t0 = time.perf_counter()
    state = one(state, batches[0])
    wall = (time.perf_counter() - t0) * 1e3
    again = T.leaves((params, state))
    differ = sum(not same_bits(torch, x, y) for x, y in zip(first, again))
    differ += sum(not same_bits(torch, metrics[0][k], metrics[1][k])
                  for k in ("loss", "grad_norm"))
    check(differ == 0,
          f"phase 17 {what}: step 1 repeated from the same state gave other "
          f"bits in {differ} of {len(first) + 2} leaves and metrics")
    del first, again
    stamp(f"phase 17 {what}: step 2, profiled")
    box = {}
    prof = profile_once(torch, dev, lambda: box.update(
        state=one(state, batches[1])))
    del box, params
    loss = [float(m["loss"]) for m in metrics]
    norm = [float(m["grad_norm"]) for m in metrics]
    total = {k: sum(c[k] for c in counts) for k in counts[0]}
    b5_ms, b5_n = prof["by_kernel"].get("B5", [0.0, 0])
    log(f"# phase 17 {what} on {card}: {wall:.1f} ms a step after the "
        f"first, device busy {prof['busy_ms']:.1f} ms in the profiled step "
        f"({prof['host_ms']:.1f} ms under the profiler), B5 {b5_ms:.1f} ms "
        f"in {b5_n} launches; loss {[round(x, 5) for x in loss]}, grad norm "
        f"{[round(x, 5) for x in norm]}; top {prof['top']}")
    return {"loss": loss, "grad_norm": norm, "wall_ms_per_step": wall,
            "device_busy_ms_per_step": prof["busy_ms"],
            "device_busy_share": prof["busy_ms"] / wall,
            "profiled_step_ms": prof["host_ms"], "b5_ms_per_step": b5_ms,
            "b5_launches_profiled": b5_n,
            "kernel_ms_per_step": prof["by_kernel"],
            "top_kernels_ms": prof["top"], "counts": counts,
            "launches": total}


def deterministic_probe(torch, dev):
    """One train step of each of ``PROBE_ARCHS``' smoke configs
    (``kahan_matmul`` on, 2 microbatches) under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the ops
    torch reports as having no deterministic CUDA implementation (an
    atomic order), by config. The note that cuBLAS wants a fixed workspace
    (``CUBLAS_WORKSPACE_CONFIG``, about streams that share one) is listed
    apart. Gate: no op of the first kind."""
    import warnings

    from repro_torch.configs import get_smoke
    from repro_torch.core import tree as T
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import init as opt_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.trainer import batch_to_device

    atomic, workspace = {}, {}
    for name in PROBE_ARCHS:
        cfg = get_smoke(name).replace(kahan_matmul=True)
        model = build_model(cfg, dev)
        params = T.tree_map(lambda p: p.requires_grad_(), model.init(
            torch.Generator(device=dev).manual_seed(0)))
        opt = AdamWConfig(lr=TRAIN_LR)
        step = make_train_step(model, cfg, TrainConfig(
            steps=2, microbatches=TRAIN_MICRO, warmup=1, opt=opt))
        batch = batch_to_device(train_data(cfg, 32, 4).batch_at(0), dev)
        state = opt_init(opt, params)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                step(params, state, batch)
                sync(torch, dev)
        finally:
            torch.use_deterministic_algorithms(False)
        msgs = sorted({str(w.message).splitlines()[0][:200] for w in caught})
        workspace[name] = [m for m in msgs if "CuBLAS" in m
                           or "CUBLAS_WORKSPACE_CONFIG" in m]
        atomic[name] = [m for m in msgs if "deterministic" in m
                        and m not in workspace[name]]
    log(f"# phase 17: the deterministic-algorithm probe (one smoke step of "
        f"each family, warn_only): ops without a deterministic CUDA path "
        f"{atomic}; the cuBLAS workspace note in "
        f"{sorted(n for n, m in workspace.items() if m)}")
    check(not any(atomic.values()),
          f"phase 17: ops without a deterministic CUDA path on a train "
          f"step: {atomic}")
    return {"atomic": atomic, "cublas_workspace": workspace}


if __name__ == "__main__":
    sys.exit(main())
