#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which raises on failure (exit code != 0):

1. the card: name, count, and `nvidia-smi` name and power limit;
2. build the CUDA kernels from `src/repro_torch/kernels/csrc` from scratch
   (nvcc, with `-Xptxas -v`: registers, shared memory and spills per
   kernel; the ranks of phase 8 load these libraries); the
   FISTA/ISTA GEMV and SGEMM (`fista_gemv_kernel`, `fista_gemm_kernel`),
   the rank-n update (`rank_update_kernel`), the logistic gradient
   (`logistic_grad_kernel`, `logistic_grad_rows_kernel`) and its unfused
   pair (`logistic_residual_kernel`, `logistic_backproject_kernel`), the
   group threshold (`group_threshold_kernel`), the bf16 Hopper flash
   forward (`flash_fwd_wgmma`) and the f32 one (`flash_fwd_tf32x3`), one
   instance of each at each of H = 64, 128 and 256, must not spill, and
   the f32 one's SASS (`cuobjdump -sass`) must hold TF32 HMMA at each H;
3. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at ragged ones, max abs error <= 1e-5 * max|plain|
   per output (both accumulate in f32, in another order); the rank-n
   update also at the streaming ingest's (8, 1024, 256), with Sigma
   exactly symmetric, the unfused pair's Sigma bitwise the fused one's,
   and its block tile as its launcher chooses it held to
   `ops.rank_plan`; the logistic
   gradient also at the large-p point m = 4, n = 256, p = 8192, and twice,
   to show that its sample reduction gives the same bits every run, the
   fused kernel's plan as its launcher chooses and launches it held to
   `ops.plan` and printed (a cluster launch where its cluster is above 1),
   its ticket counters at zero after the calls, and also in its two modes
   above p = 19,328, at (4, 256, 19329) (a shared-memory ring) and
   (1, 8, 100003) (X read twice); the unfused pair's launch plan as its
   launcher chooses it held to
   `ops.unfused_plan` and one call of the pair launching each of its two
   kernels once; the
   ISTA steps (batched and single-task), the unfused rank pair and the
   group threshold at their path shapes and at ragged ones (p = 129,
   r = 7, m = 3; (2, 7, 129); (1001, 5)), each twice for the same bits
   (the threshold's lanes a row as its launcher chooses them held to
   `ops.row_lanes`),
   and the GEMV's plan and the SGEMM's block tile as their launchers
   choose them held to `ops.gemv_plan` and `ops.gemm_plan`;
   the flash-attention forward in f32 at (B, S, N, K, H) = (2, 256, 8, 2,
   64), a ragged (1, 200, 4, 1, 128), (1, 512, 4, 1, 256) with window 64
   and a non-causal case, within 2e-5 * max|plain|, and in bf16 at the
   serving path's (4, 2048, 32, 8, 64), at minitron-4b's H = 128
   (4, 2048, 24, 8, 128), at the ragged and windowed
   shapes and at (1, 300, 4, 2, 64) with window 40 (T not a multiple of
   the bf16 kernel's 128-key tile, the window cutting its tiles), and at
   phase 9's prefill shapes: (4, 2048, 16, 16, 128), (4, 3072, 16, 8,
   128), (4, 2048, 16, 1, 256) with window 2048, and (4, 4096, 16, 16, 64)
   not causal, and at H = 256 (64-key tiles) also a ragged non-causal
   (1, 300, 4, 1) against T = 333 and (1, 700, 4, 2) with window 96,
   against the plain version on the f32 upcast of the same
   inputs; in both dtypes each query row's output within a relative l2
   error of the plain row (1e-4 in f32, 1e-2 in bf16: the output's
   scale falls with the row, as 1 / sqrt(row + 1), so a bar on
   max|plain|, set by row 0, would not follow it), each twice for the
   same bits; at each of these shapes also the training forward
   (`flash_attention_fwd_lse`) twice: its output the serving call's bits,
   its row log-sum-exp the same bits twice and within 1e-5 (f32) and
   1e-4 (bf16) of max(1, |lse|) of the plain lse, and (1, 300, 4, 2, 64)
   non-causal with window 50 against T = 100, whose rows s >= 149 see no
   key (lse -1e30), in both dtypes; in f32 also at the f32 copies'
   shapes (`f32_flash_shapes`: 10b's (4, 2048, 32, 8, 64), phase 6's
   (2, 2048, 32, 8, 64), 9a's (2, 2048, 16, 16, 128) and a 13c-rg rank's
   (1, 2048, 8, 1, 256) with window 2048) under the same bars; and the
   kernels a call runs on the card (`torch.profiler`): a bf16 call at
   H = 64, 128 and 256 `flash_fwd_wgmma` of its H alone, an f32 call at
   those four shapes `flash_fwd_tf32x3` of its H alone;
4. the regression path at full width: `dsml_fit` (DSML Algorithm 1) on
   m = 16 tasks, n = 512 samples, p = 1024 features, through the kernels
   (launch counts zeroed just before, read just after), then with
   `use_kernel=False` on the card as the reference: beta_u within
   1e-4 * max|beta_u| after 1000 chained FISTA iterations, identical
   support; 4a. one more fit under `obs.torchprof.span_trace`: at least
   99 % of its device time matched to its launch by correlation id, the
   `dsml.fit` span's within 1 % of the busy time, device and idle ms by
   span printed, one `engine.solve.*` record for each of the two solves
   and one `dispatch.route` record each of its three plans (kernel);
4b. the logistic path (paper Section 4) at the same widths:
   `dsml_logistic_fit` on `gen_classification` data, 600 lasso and 600
   debias iterations, launch counts zeroed just before and read just after,
   then the plain path on the card: beta_u and beta_local within
   1e-4 * max|.|, identical support;
4c. the remaining DSML kernels and the regression baselines at the
   configuration of phase 4 (launch counts zeroed just before, read just
   after, every new count > 0): `rank_update_unfused` against
   `rank_update` on the fit's X, y; `group_threshold` of the fit's
   beta_u' at its Lambda, whose keep must be the fit's support and whose
   rows the fit's beta_tilde (the master step, eq. 5-6); `ista_solve` on
   task 0 (400 steps) against its plain path, within 1e-4 * max|beta|
   with an identical support; `ista_step` at r = p and
   `ista_step_batched` at r = 1 and r = p against their plain versions;
   `solve_lasso_eq2_grid` over k = 8 values of lambda (128 tasks) against
   its plain path; `group_lasso`, `icap` and `dirty_model` (400
   iterations each) against their plain paths, with wall time and
   support size;
5. times: each kernel alone (CUDA events, mean of 20 back-to-back
   launches into preallocated outputs after a warm-up; and again with the
   L2 cache flushed before each launch, since back to back an input of up
   to 50 MB stays in L2, as it does in the solver loops) beside its bound,
   its plain version, the nearest PyTorch call, and the wrapper as the
   main path calls it (checks and allocation included), and for the SGEMM,
   rank-n and flash rows the achieved TFLOP/s; the rank-n update also
   weighted (the logistic fit's Hessian launch) and at the streaming
   ingest's (8, 1024, 256), and flash also at H = 128, each beside its
   PyTorch call; for every row also the device time alone of the kernel
   and of its PyTorch call (`graph_ms`, `library_graph_ms`: 20 launches
   captured in one CUDA graph and replayed between CUDA events, so that
   no host issue is timed; `torch.profiler`'s device time where a launch
   cannot be captured, with the reason); an empty kernel's `graph_ms`,
   the floor of any launch, beside the group threshold's row; #9 with
   its lse at the training shape (4, 2048, 32, 8, 64) beside SDPA's
   forward on inputs that require a gradient, and the plain blockwise
   attention backward and SDPA's backward at that shape; #9 in f32 at the
   f32 copies' four shapes, each beside the floor of its full-f32
   products as three TF32 products on the tensor cores (`bound_ms`,
   495 / 3 TFLOP/s, the kernel's and SDPA's design), the FP32 FMA bound
   (`fma_bound_ms`, 67 TFLOP/s) and SDPA in f32 (`sdpa_yardstick`: k
   and v expanded outside the call where `enable_gqa` takes the math
   path, `library_note`); and
   each fit's wall time on both paths;
6. the serving path at full width, the cell of
   `repro_torch/serving/cell.py`: granite-3-2b (40 layers, d 2048, 32/8
   heads of 64, bf16) from a seeded `torch.Generator`, `greedy_generate`
   on a batch of 4 prompts of 2048 random ids and 16 new tokens, launch
   counts zeroed just before and read just after (`flash_attention` 40
   times, one per layer's prefill, and nothing else), then the same with
   `use_kernel=False` on the card: the prefill's last logits within
   0.1 * max|logits|, the shared tokens counted, prefill and decode
   times, tokens per second and peak memory; the kernel run once more
   step by step (`serve_trace`: each step's logits), whose tokens must
   be `greedy_generate`'s and which phase 13a holds its sharded steps
   to; then an f32 copy of the same
   widths at 4 layers (batch 2, prompt 2048, 8 new tokens), whose kernel
   and plain paths must give identical tokens and last logits within
   1e-4 * max|logits|;
7. the streaming service (`repro_torch.stream`), each sub-phase with the
   launch counts zeroed just before and read just after:
   7a. phase 4's data ingested in 4 chunks of 128 rows: Sigma and c
       within 1e-5 * max|.| of `sufficient_stats` on all 512 rows; a cold
       `refit` (400 + 600 iterations) with phase 4's support and beta_u
       within 1e-4 * max|beta_u|; `rank_update` 4, GEMV 400 and SGEMM 600
       launches and nothing else;
   7b. `StreamingDsmlService` at m = 16, p = 1024 (refit_every 1024, the
       guard, a checkpoint store) fed 24 chunks of 256 rows of one seeded
       AR(0.5) regime whose support moves at chunk 12, chunk 5 poisoned
       with a NaN row (`repro_torch.testing.apply_batch_fault`), which must
       be quarantined with (Sigma, c, counts) bitwise unchanged, while a
       client thread submits single rows to a `ServingFront(max_batch=64,
       max_delay_ms=2)`: `rank_update` exactly once a chunk, a refit's
       GEMV and SGEMM once an iteration it ran and the health check's ISTA
       step once; the ingest p50 and rows/s, the cold and warm refit
       times, generations and rollbacks, `serve.request_ms` p50/p99
       overall and while a refit runs, a checkpoint save, peak memory;
       every front result scored by a generation that was published
       while its request was in flight, and equal to that generation's
       model; the same chunks with `use_kernel=False` on the card: the
       same generations, cadence and supports, beta_tilde within
       1e-4 * max|.|; `restore()` into a fresh service: the last
       checkpoint's generation and bits; the refits' `engine.solve.*`
       records against the iterations each refit returned, one
       `stream.ingest{waited=True}` span a chunk, an unguarded service's
       spans (`waited=False`, the issue alone), and a warm refit's device
       and idle ms by span;
   7c. `benchmarks/stream_bench.py`'s full configuration, (8, 1024, 256),
       8 chunks, refit_every 1024: `rank_update` once a chunk (row 4i's
       launches), ingest times;
   7d. `refit_logistic` on phase 4b's data, generation 0 (cold) then 1
       (warm), against its plain path on the card (beta_u within
       1e-4 * max|.|, the same support), the cold one also against phase
       4b's fit; `logistic_grad` 600, `rank_update` 2 (the step sizes' and
       the weighted Hessian's), SGEMM 600 launches each.

8. the distributed path (`repro_torch.substrate`), each rank a process
   (`run_probe`, `file://` rendezvous) that loads the kernels phase 2
   built and fails the phase if it compiles any, with launch counts,
   the collective ledger and a count of the `torch.distributed` calls
   (`count_collectives`) zeroed just before each fit or ingest and read
   just after:
   8a. one NCCL rank: `dsml_fit_sharded` on phase 4's data, phase 4's
       bits, one all-gather of 16 x 1024 x 4 bytes, launches 1 / 400 /
       600, the host ms of its `dsml.fit_sharded` and `dsml.allgather`
       spans;
   8b. four gloo ranks on the one card, 4 tasks each: beta_tilde within
       1e-5 * max|.| of phase 4's, its support, one collective a rank,
       launches 1 / 400 / 600 a rank; whether the bits are phase 4's is
       printed (`gemv_plan` depends on m);
   8c. on a 2 x 2 data x task mesh, phase 7a's chunks through
       `feed_chunk` + `ingest_sharded` (Sigma, c within 1e-5 * max|.| of
       7a's; one `rank_update` and two all-reduces a chunk a rank), then
       phase 7b's first 9 chunks through `StreamingDsmlService(mesh=,
       ckpt_dir=)`: 7b's generations, intervals and supports at every
       chunk, beta_tilde within 1e-4 * max|.|; the checkpoint's gather
       over task timed, one global file written by rank (0, 0), and a
       fresh service on every rank restoring its own block bit for bit
       at one agreed generation (one `pmin` a mesh dim);
   8d. the sparse probe on granite-3-2b unreduced (phase 6's bf16
       weights from seed 0): `synthetic_probe_tasks` (m 4, n 96, seq 16,
       6 active dims), `sparse_probe_fit` through the kernels against
       `use_kernel=False` on the card (the same support, Lambda within
       1e-4 relative, beta_tilde within 1e-4 * max|.|), then sharded
       over 4 gloo ranks, one task each (the same support,
       1e-5 * max|.|); the recovery
       counts and R^2 printed;
   with each fit's wall time, spawn and rendezvous times, the all-gather
   alone (CUDA events) and each rank's peak memory;
9. the rest of the model zoo at full width, random weights from seeded
   generators on the card, each family as phase 6's cell (4 prompts of
   2048 random ids, 16 new tokens, launch counts zeroed just before and
   read just after, against `use_kernel=False` on the card: the prefill's
   last logits within 0.1 * max|logits|, the shared tokens counted; for
   the MoE families against the plain path making the kernel path's
   routing choices, since a bf16 rounding moves tokens across a top-k
   or capacity boundary; the free plain path may route at most a tenth
   of the tokens otherwise at the first MoE layer, and its error and
   its routing flips per layer are printed beside it), each after the
   last one's memory is freed:
   9a. deepseek-moe-16b unreduced (28 layers, the first dense, 64 routed
       experts top-6 and 2 shared, 16.4 B parameters in bf16):
       `flash_attention` 28 times and nothing else; prefill and decode
       times, tokens/s, peak memory, the MoE drop fraction at the prefill
       (C = 960) and at decode (C = 1); an f32 copy at 4 layers (the
       dense head and 3 MoE layers, routing free; batch 2, 8 tokens)
       with identical tokens and last logits within 1e-4 * max|logits|
       on both paths;
   9b. recurrentgemma-9b (flash 12 times: H = 256, one kv head, window
       2048, decode wrapping the ring), internvl2-2b (24 times at S =
       3072: 1024 stub patches ahead of the prompt), seamless-m4t-medium
       (12 non-causal over 4096 stub frames, counted inside the encoder
       on their own, 12 causal; cross attention plain), qwen3-moe-30b-a3b cut to 12 of its 48 layers (12 times);
       mamba2-1.3b (48 layers, no kernel), and its f32 copy at 2 layers
       (batch 1, prompt 256, 8 tokens) with the card's tokens the CPU's
       and last logits within 1e-4 * max|logits|;
   9c. `moe_apply_a2a` on 4 gloo ranks on the card (a 2 x 2 data x model
       mesh, one MoE layer at deepseek-moe-16b's widths, 32 experts a
       rank, f32, capacity_factor 8): each rank within 1e-5 * max|.| of
       `moe_apply` on the whole batch, one `all_to_all_experts` out and
       one back and no other collective, the all-to-all's time.
10. training (`repro_torch.training`), after phase 9's models are freed:
   10a. granite-3-2b unreduced in bf16 (phase 6's weights, seed 0), one
        batch of 4 x 2048 from `synthetic_lm_batches` (seed 1), remat
        on: one loss-and-gradient evaluation through the kernels (launch
        counts zeroed just before and read just after: `flash_attention`
        80 times, the forward and its recompute, and nothing else) and
        one on the plain path (`use_kernel=False`, no launch): the loss
        within 1e-4 relative, the global gradient norm within 1e-3
        relative, each gradient leaf within a relative l2 error of 0.05
        (the worst printed); the f32 control, the same weights upcast on
        the plain path: the kernel path's worst leaf against its
        gradient at most 1.1 x the plain path's; then, with their AdamW
        state, 8 steps of `make_train_step` on that batch (peak_lr 1e-3,
        warmup 1) with every loss and gradient norm finite and the last
        loss below the first; the step's wall time after the first, tokens/s,
        the share of the bf16 peak, peak memory; one step under
        `torch.profiler`: device busy and idle share, and device time in
        GEMMs, #9, the plain attention backward, the optimizer and the
        rest;
   10b. an f32 copy at 4 layers (batch 4 x 2048): flash 8 times
        (`flash_fwd_kernel` with its lse), the loss within 1e-5 relative
        and each gradient leaf within 1e-4 * max|g| of the plain path's;
        `adamw_update` on two copies of the state with the same
        gradients gives the same bits.
   10c. the families that fit one card, unreduced in bf16 by 10a's
        procedure (`train_family_phase`, TRAIN10C), each after the last
        one's memory is freed: internvl2-2b (its 1024 stub patches ahead
        of each sequence: S = 3072), seamless-m4t-medium (4096 stub
        frames through its non-causal encoder), mamba2-1.3b and
        minitron-4b. Each: one loss and gradient through the kernels at
        4 x 2048 (`flash_attention` exactly 48, 36 with 12 inside the
        encoder, 0 and 64 times, and nothing else) and one on the plain
        path (no launch): the loss within 1e-4 relative, the norm within
        1e-3, each leaf within 0.05 relative l2 or 2 x the plain path's
        distance from the f32 control (the same weights upcast on the
        plain path, the bf16 gradients waiting on the host); then the
        AdamW state and 4 steps (minitron-4b's at 1 x 2048: its 54.6 GiB
        of state leave no room for more sequences' f32 logits over
        256000 tokens), every loss finite and the last below the first, the
        step wall, tokens/s, the share of the bf16 peak, peak memory,
        and one more step under `torch.profiler`: device busy and idle
        share by part.

11. sharded training (`launch/train.py`'s sharded path: the rules as
   DTensor placements, ZeRO-1 AdamW), each rank a process on the one
   card (gloo: NCCL refuses two ranks on one card), started by
   `run_probe`, loading phase 2's kernels, after phase 10's state is
   freed; 10a writes what 11a compares with (its kernel run's loss,
   global gradient norm and the gradients of layer 0, the last layer,
   `embed`, `head` and `final_norm`):
   11a. granite-3-2b unreduced in bf16 on 2 ranks as a (1, 2) mesh,
        phase 10a's weights and batch, remat: one loss and gradient
        through the kernels, #9 80 times on each rank at its local heads
        (4, 2048, 16, 4, 64) and nothing else, against 10a: the loss
        within 1e-4 relative, the norm within 1e-3, each saved leaf
        within 0.05 relative l2 (10a's bars); then 3 AdamW steps, every
        loss finite and the last below the first; a step's wall,
        tokens/s, each rank's peak memory, the collectives of a step by
        kind with their bytes (`launch.hlo.Counters`), one activation
        all-reduce's own time;
   11b. an f32 copy at 4 layers on 4 ranks as a (2, 2) mesh (ZeRO over
        `data`; #9 as `flash_fwd_kernel` with its lse, 8 launches a rank
        a step): each of two steps from the unsharded step's state
        before it (computed here, on the card) against that step: every
        gradient leaf within 1e-4 · max|g| (10b's bar), the loss and the
        gradient norm within 1e-5 relative, every master element within
        1e-5 (absolute, a unit weight's scale) plus the most that the
        sharded and unsharded gradients' difference at that element can
        move AdamW's step (1.25 lr / eps times it; it matters only where
        the gradient is within about 1e-8 of 0), at most a thousandth of
        the elements past the 1e-5 alone, each parameter its master's
        bits.
   Phase 3 and 5 gain #9 at 11a's per-rank shape, with its lse, beside
   SDPA, and at 10c's four instances with the lse (internvl2-2b's (4,
   3072, 16, 8, 128), the seamless encoder's (4, 4096, 16, 16, 64) not
   causal and its decoder's (4, 2048, 16, 16, 64), minitron-4b's (4,
   2048, 24, 8, 128)), each beside SDPA's forward with a gradient and,
   for the backward, the plain blockwise one beside SDPA's.

12. the MoE, RG-LRU hybrid and SSM families trained sharded on 2 gloo
   ranks of the one card as a (1, 2) mesh (`train_zoo_sharded_phase`),
   full width, bf16, remat, 10a's seeds and AdamW settings, the depth
   cut (ZOO12): 12a deepseek-moe-16b at 3 of 28 layers (the dense head
   and 2 MoE layers, expert parallel, the global batch's routing), 12b
   qwen3-moe-30b-a3b at 2 of 48, 12c recurrentgemma-9b at one (rec, rec,
   local_attn) group of 38 layers with the batch cut to 2 x 2048 (its
   256k-vocabulary logits), 12d mamba2-1.3b at 24 of 48 layers (head
   parallel, `w_in` and `conv_w` gathered through the ledger; 10c trains
   it unreduced on one card). Each family's
   unsharded bf16 kernel run (one loss and gradient, remat) is taken
   first in this process, saved and freed; then, in one pair of ranks,
   each family's loss and gradient through the kernels (#9 on each
   rank's local heads: 5, 4 and 2 launches a rank, none for mamba2, and
   nothing else), the MoE routed as the unsharded run (every route call
   replayed), against it by 11a's bars (loss 1e-4, norm 1e-3, each saved
   leaf 0.05 relative l2: the tail's, the stack's first and last layers,
   `embed`, `head`, `final_norm`); then 2 AdamW steps, the first routing
   freely: the share of tokens whose top-k set flips at the first MoE
   layer at most 0.1, the drop fractions, the loss falling, a step's
   wall, tokens/s, each rank's peak memory, the last step's collectives
   by kind, bytes and op (no DTensor all-gather: the gathers are the
   ledger's). 12e: f32 copies on 4 ranks as (2, 2), deepseek-moe-16b
   at 2 layers with its capacity binding (capacity factor 0.5) and
   mamba2-1.3b at 1 layer, each held to the unsharded f32 step by 11b's
   bars (`f32_sharded_check`, 11b's own procedure). Phase 3 and 5 gain
   #9 at 12a-12c's per-rank shapes, with the lse, beside SDPA.

13. serving sharded on gloo ranks of the one card
   (`serve_sharded_phase`, `SERVE13_PROGRAM`): `serving.engine`'s
   prefill and decode steps on parameters placed by `param_pspecs`, the
   request batch by `batch_pspecs`, the caches coming out placed by
   `cache_pspecs` (every leaf checked), each decode step fed the
   unsharded run's token before it (teacher forcing), the launch counts
   zeroed just before the prefill and read after the last decode step,
   every rank's collectives counted by op (no DTensor all-gather):
   13a. granite-3-2b unreduced in bf16 on 2 ranks as (1, 2), phase 6's
        weights and request batch (4 x 2048, 16 new tokens): a warm-up
        prefill (its collectives counted), then the prefill and 15 decode
        steps timed, each held to phase 6's kernel run (recorded step by
        step, `serve_trace`) by TOL_SERVE_BF16 · max|logits|, #9 40
        times a rank at (4, 2048, 16, 4, 64) and nothing else; then one
        more step, its collectives counted; the prefill and decode walls,
        tokens/s, a rank's peak memory, the greedy tokens shared;
   13b. on the same ranks, SERVE13B: deepseek-moe-16b at 3 of 28 layers
        (routed as its unsharded run; a free prefill's flips at the first
        MoE layer held to TOL_ROUTE_FLIPS), recurrentgemma-9b at one
        group of 38, mamba2-1.3b, seamless-m4t-medium (#9 inside its
        encoder counted on its own) and internvl2-2b unreduced, each held
        to its unsharded kernel run (taken first in this process) by
        TOL_SERVE_BF16 · max|logits|, under the collective counters;
   13c. f32 copies on 4 ranks as (2, 2) (granite at 4 layers,
        deepseek-moe-16b at 2 with capacity factor 0.5, recurrentgemma-9b
        at one group, mamba2-1.3b at 2 layers), batch 2, 8 new tokens:
        the unsharded f32 run's greedy tokens and logits within TOL_FIT ·
        max|logits|.
   Phase 3 and 5 gain #9 without the lse at 13a-13b's five per-rank
   prefill shapes, beside SDPA.

14. the launch-plan autotuning (`autotune_phase`, `kernels/autotune.py`)
   under a fresh cache directory of its own:
   14a. each plan of each swept kernel, through its wrapper's `block=`,
        held to the plain version within 1e-5 * max|plain| (the FISTA
        step and the rank-n update also to the rule's bits), timed by
        events (mean of 20) and by graph, then swept, with the rule's
        choice and the sweep's winner: the FISTA step at phase 4's
        (16, 1024, 1) and (16, 1024, 1024), the rank-n update at phase
        4's (16, 512, 1024) and 7c's (8, 1024, 256), the fused logistic
        gradient at (16, 512, 1024) and (4, 256, 8192);
   14b. `dsml_fit` on phase 4's data with the swept plans, its three
        plans memory hits: beta_u and the support bit for bit phase 4's;
   14c. the memory cache cleared, the fit again: its three plans disk
        hits, no sweep (the `autotune.cache` counter), phase 4's bits.
15. granite-4.0-h-small's training products at the benchmark cell's
   shapes (`hybrid_moe_phase`; `python chip_smoke.py 15` runs it alone):
   15a. the held experts' grouped products (`moe.grouped_mm`, one
        `torch.mm` a group) over 20,480 rows in 9 groups, one empty, 4096
        -> 768 and 768 -> 4096 in bf16, forward and backward, held to the
        float64 products within 1e-2 * max|want|, with their launches,
        times and bound;
   15b. #9 with its lse at (2, 8192, 32, 8, 128), causal, scale 1/128,
        held to the plain forward (rows within 1e-2, the lse 1e-4), one
        launch a call, timed against its bound and SDPA at that scale,
        and the plain training backward against SDPA's.

The engine's plans (`block=None` on the card) are the ones timed fastest
(`kernels/autotune.py`), in a cache directory of the run's own that the
ranks inherit. Every timed engine call runs after a warm-up call of its
shapes (or a service that warmed them when it started: 7b and 7c give
`chunk_n`), so no sweep falls inside a timed window, and a sweep's
launches are not counted.

It prints one JSON line of kernels (launches per run from phases 4-4c,
6, 7c, 9 and 10, #9 with its lse taking 10a's kernel loss-and-gradient
run's, its 10c rows each family's kernel loss-and-gradient run's, its
11a per-rank row 11a's rank 0's, its phase 12 per-rank rows
12a-12c's rank 0's and its phase 13 per-rank rows 13a-13b's rank 0's;
its f32 rows the f32 copy that launches each: 10b's kernel
loss-and-gradient run, phase 6's and 9a's kernel generate, 13c-rg's rank
0; phase 8's, over its ranks and its own fits, as `launches_phase8`,
phase 11's, over its 11a ranks, as `launches_phase11`, phase 12's, over
its ranks, as `launches_phase12`, and phase 13's, over its 13a-13c ranks,
as `launches_phase13`) and, last, the result line. With no CUDA device it
raises before printing any result.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): f32 FMA outside the tensor
# cores, dense bf16 and TF32 on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12                # dense TF32 on the tensor cores
# full-f32 products as three TF32 products (hi.lo, lo.hi, hi.hi)
PEAK_TF32X3_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = 3.35e12

M, N, P, S = 16, 512, 1024, 16          # the main path's configuration
LARGE_P = (4, 256, 8192)                # benchmarks/largep_logistic.py
INGEST = (8, 1024, 256)                 # benchmarks/stream_bench.py
# (B, S, N, K, H): minitron-4b's attention (configs/registry.py) at the
# serving cell's batch and prompt
FLASH_H128 = (4, 2048, 24, 8, 128)
# prompts of the f32 serving copies (phase 6, 9a): the first two of the batch
F32_COPY_BATCH = 2
TOL_KERNEL = 1e-5                       # x max|plain|, per output
# (m, p, k) of the benchmark's lambda-grid cell (`bench/configs/
# dsml-reg-p200.json`, `bench/traffic/lambda-grid.json`): #1a's grid row
GRID_CELL = (1024, 200, 8)
# (m, p, r) of the debias step of the benchmark's fit cell (`dsml-reg.fit`:
# 1024 tasks at p = 200, r = p): #1b's row at the paper's widths, where the
# SGEMM's rule takes the short-row tile
CELL_1B = (1024, 200, 200)
TOL_FIT = 1e-4                          # x max|.|, after chained FISTA steps
TOL_FLASH = 2e-5                        # x max|plain|, f32
# worst relative l2 error of a query row's output
TOL_FLASH_ROW = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the training forward's row log-sum-exp, x max(1, |lse|) elementwise: both
# sides sum the same f32 scores of the same (bf16) inputs in another
# order, the bf16 kernel through exp2
TOL_LSE = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
TOL_SERVE_BF16 = 0.1                    # x max|logits|; a wrong head map: O(1)
# x tokens: the bf16 plain path's rounding moves this share of the first
# MoE layer's top-k sets at most (H100 80GB HBM3, 700 W: deepseek-moe-16b
# 452, qwen3-moe-30b-a3b 413 of 8192); a routing fault moves most of them
TOL_ROUTE_FLIPS = 0.1
CHUNKS_8C = 9                           # 7b's chunks through the sharded service
# phase 9: the other families at full width, each serving phase 6's
# request batch (`serving/cell.py`: 4 prompts of 2048 ids, 16 new tokens)
ZOO_MOE = "deepseek-moe-16b"            # 9a, unreduced
ZOO_MOE_F32_LAYERS = 4                  # 9a's f32 copy: dense head + 3 MoE
# 9b, each with its depth cut: qwen3-moe-30b-a3b at 12 of its 48 layers
# (its 61 GB in bf16 leave no room for the plain path's activations)
ZOO_OTHERS = (("recurrentgemma-9b", {}), ("internvl2-2b", {}),
              ("seamless-m4t-medium", {}), ("qwen3-moe-30b-a3b",
                                            {"n_layers": 12}))
ZOO_SSM = "mamba2-1.3b"                 # reaches no kernel
A2A_TOKENS = 512                        # 9c: a sequence's tokens, 4 of them
# phase 10: training granite-3-2b unreduced on phase 6's weights (seed 0),
# one batch of synthetic_lm_batches from seed 1
TRAIN_BATCH, TRAIN_SEQ, TRAIN_BATCH_SEED = 4, 2048, 1
TRAIN_STEPS = 8
TRAIN_LR = 1e-3
TRAIN_F32_LAYERS = 4
# kernel path against the plain path in bf16 (each backward recomputes
# the scores as its forward computed them; the forwards round q.k and the
# output differently at bf16 level, which 40 layers carry into the loss
# and the gradients): the loss relative, the global norm relative, each
# gradient leaf's relative l2 error. Measured 1.47e-5, 5.11e-5 and 0.0411
# (layer 0's wq) on an H100 80GB HBM3 at 700 W, where the f32 control
# puts each bf16 path's worst leaf 0.041-0.043 off the f32 gradient, so
# that 0.0411 is the two paths' own rounding; a wrong lse or scale moves
# them by O(1)
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GNORM = 1e-3
TOL_TRAIN_GRAD = 0.05
# the kernel path's worst leaf against the f32 gradient, as a multiple of
# the plain path's (measured 0.955 there): the kernel's forward keeps q.k
# in f32, so its gradient is to be no further from the f32 one
TOL_TRAIN_GRAD_F32 = 1.1
# phase 10c: the families that fit one card, trained there unreduced in
# bf16 by 10a's procedure (its seeds and batch, remat): (run, arch, the
# AdamW steps' batch). Each loss and gradient on both paths, and the f32
# control, at TRAIN_BATCH; each leaf of the kernel path's gradient held
# to the plain path's by TOL_TRAIN_GRAD or ZOO12_NOISE times the plain
# path's own distance from the f32 control, whichever is larger (phase
# 12's bar). minitron-4b's steps take 1 x 2048: its train state (bf16
# parameters, f32 master and moments) is 54.64 GiB, and its loss and
# gradient at 4 x 2048 peak at 48.51 GiB with its parameters alone
# (H100 80GB HBM3, 700 W), so 46.8 GiB more of master and moments do
# not fit; at 2 x 2048 the steps ran out of memory in this script (3.91
# GiB asked with 74.55 GiB allocated of 79.18: earlier phases hold about
# 3.4 GiB), its f32 logits over 256000 tokens and their gradient's
# temporaries taking about 6 GiB a sequence
TRAIN10C = (("10c-vlm", "internvl2-2b", TRAIN_BATCH),
            ("10c-audio", "seamless-m4t-medium", TRAIN_BATCH),
            ("10c-ssm", "mamba2-1.3b", TRAIN_BATCH),
            ("10c-dense", "minitron-4b", 1))
TRAIN10C_STEPS = 4                      # then one more under the profiler
# phase 11: granite-3-2b trained sharded on gloo ranks of the one card.
# 11a: phase 10a's weights and batch, bf16, a (1, TP_MODEL) mesh; held to
# 10a's kernel run with 10a's bars; then TP_STEPS AdamW steps. 11b: an f32
# copy at TRAIN_F32_LAYERS layers on a (2, 2) mesh, each of its two steps
# from the unsharded step's state before it, held to that step
TP_MODEL = 2
TP_STEPS = 3
SHARDED_MESH_11B = (2, 2)
# 11b holds every gradient leaf to 1e-4 · max|g| (10b's bar for f32
# gradients summed in two orders on the card; 9.35e-6 read at step 1,
# H100 80GB HBM3, 700 W), and each master element after the update to
# 1e-5 · max(1, max|w|) plus what the difference d between the sharded
# and the unsharded gradient at that element can move AdamW's step:
# ADAM_SLOPE_11B · lr · d / eps. The step m̂ / (sqrt(v̂) + eps) changes
# with its gradient by at most lr / eps at count 1 (lr g / (|g| + eps)),
# and (0.526 + 0.716) lr / eps at count 2 (b1 0.9, b2 0.95: the slope of
# m̂, and |m̂| / sqrt(v̂) <= 1 times the slope of sqrt(v̂)); the clip
# scales both gradients alike. It matters where the gradient is within
# about 1e-8 of 0: on the card an element of layers/0/mlp/w_up whose
# unsharded gradient is exactly 0 moved 1.865e-05 at step 1, twice
# (H100 80GB HBM3, 700 W). At most MAX_SLOPED_11B of the elements may
# need more than the 1e-5 bar, as the CPU test's `_check_step` caps its
# band of tiny gradients
ADAM_SLOPE_11B = 1.25
ADAM_EPS = 1e-8                         # adamw_update's default
MAX_SLOPED_11B = 1e-3
# phase 12: the MoE, RG-LRU hybrid and SSM families trained sharded on 2
# gloo ranks of the one card as a (1, TP_MODEL) mesh, full width, bf16,
# remat, 10a's seeds and AdamW settings: (run, arch, changes, batch), the
# depth cut so that both ranks' state (about 20 B a parameter) and the
# batch's activations fit the card; recurrentgemma-9b's 256k-vocabulary
# logits also cut its batch to 2 x 2048; mamba2-1.3b (whole on each rank)
# is cut to half its layers for the script's time: its gloo-bound
# sharded steps took about 20 s each at 48 (H100 80GB HBM3, 700 W), and
# phase 10c trains it unreduced on one card. Each is held to its unsharded
# bf16 kernel run, taken first here, by 11a's bars; an MoE's share of
# tokens whose top-k set flips at the first MoE layer by
# TOL_ROUTE_FLIPS. Then ZOO12_STEPS AdamW steps. A leaf whose gradient
# sums terms that cancel is far from its f32 value in any bf16 run
# (mamba2-1.3b's layers/0/ssd/A_log: 0.145 between the sharded and the
# unsharded run on an H100 80GB HBM3 at 700 W, where every other leaf of
# the four runs was under 0.03): each leaf is held to TOL_TRAIN_GRAD or
# to ZOO12_NOISE times the unsharded bf16 run's own relative l2 distance
# from an f32 control (the same weights upcast, the plain path, the MoE
# routed as the bf16 run), whichever is larger. Two runs whose rounding
# errors are alike and independent part by about sqrt(2) times it
ZOO12_NOISE = 2.0
ZOO12 = (("12a", "deepseek-moe-16b", {"n_layers": 3}, TRAIN_BATCH),
         ("12b", "qwen3-moe-30b-a3b", {"n_layers": 2}, TRAIN_BATCH),
         ("12c", "recurrentgemma-9b", {"n_layers": 3}, 2),
         ("12d", "mamba2-1.3b", {"n_layers": 24}, TRAIN_BATCH))
ZOO12_STEPS = 2
# 12e: f32 copies on SHARDED_MESH_11B's ranks, the fewest layers that
# hold one of each kind (deepseek-moe-16b: its dense head and one MoE
# layer, with C = ceil(T K 0.5 / E) slots an expert, so that the capacity
# binds), each held to the unsharded f32 step by 11b's bars: one step,
# the unsharded one taken by rank 0 in memory (11b's files at these
# widths passed the 45 GiB a run may write to the machine's disk)
ZOO12E = (("12e-moe", "deepseek-moe-16b",
           {"n_layers": 2, "moe": {"capacity_factor": 0.5}}),
          ("12e-ssm", "mamba2-1.3b", {"n_layers": 1}))

# phase 13: serving sharded on gloo ranks of the one card. 13a:
# granite-3-2b unreduced in bf16 on a (1, TP_MODEL) mesh, phase 6's
# weights and request batch, each step held to phase 6's unsharded
# kernel run by TOL_SERVE_BF16 (the run recorded step by step,
# `serve_trace`). 13b: the other family kinds at full width on the same
# ranks, each held to its own unsharded kernel run, taken first here; the
# depth cut to phase 12's cuts where the two ranks' weights or the time
# would not allow more (deepseek-moe-16b's 16.4 B parameters twice over
# do not fit the card): (run, arch, changes)
SERVE13B = (("13b-moe", "deepseek-moe-16b", {"n_layers": 3}),
            ("13b-rg", "recurrentgemma-9b", {"n_layers": 3}),
            ("13b-ssm", "mamba2-1.3b", {}),
            ("13b-audio", "seamless-m4t-medium", {}),
            ("13b-vlm", "internvl2-2b", {}))
# 13c: f32 copies on SHARDED_MESH_11B's 4 ranks, batch 2 (one row a data
# rank), prompt 2048 and 8 new tokens as phase 6's f32 copy, each held to
# its unsharded f32 kernel run by 11b's f32 bar (1e-4 · max|logits|) with
# the same greedy tokens: deepseek-moe-16b with its capacity binding, and
# the channel-parallel RG-LRU and head-parallel SSD prefill and decode
# (their conv windows moved between layouts by `place.reshard`)
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
SERVE13C = (("13c-dense", "granite-3-2b", {"n_layers": 4, **F32}),
            ("13c-moe", "deepseek-moe-16b",
             {"n_layers": 2, "moe": {"capacity_factor": 0.5}, **F32}),
            ("13c-rg", "recurrentgemma-9b", {"n_layers": 3, **F32}),
            ("13c-ssm", "mamba2-1.3b", {"n_layers": 2, **F32}))
SERVE13C_BATCH, SERVE13C_STEPS = 2, 8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, max |b|)."""
    return (torch.max(torch.abs(a - b)).item(),
            torch.max(torch.abs(b)).item())


def row_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows of ||got_r - ref_r|| / ||ref_r||, a row being the
    last axis."""
    num = torch.linalg.vector_norm(got - ref, dim=-1)
    den = torch.linalg.vector_norm(ref, dim=-1)
    return torch.max(num / torch.clamp_min(den, 1e-30)).item()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in f32."""
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm((a - b).ravel())
            / torch.clamp_min(torch.linalg.vector_norm(b.ravel()),
                              1e-30)).item()


def bound(flops: float, nbytes: float,
          peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time on the card in ms, and what sets it, for work done at
    the peak rate `peak` (FLOP/s)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel from `nvcc -Xptxas -v`."""
    out, fn, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split(":", 1)[1].strip()
            out.append(f"  {fn}: {used}; {spill}")
    return out


def pct(values, q: float) -> float:
    """The q-quantile (0..1) of `values`, linear between order
    statistics, as `repro_torch.obs` computes it."""
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


def charge_lines(label: str, ch, calls: int = 1) -> list[str]:
    """A `torchprof.SpanCharge`'s device ms and idle ms a call by span."""
    per = 1e3 / calls
    by = sorted(ch.spans.items(), key=lambda kv: -kv[1][1])
    idle = sorted(ch.idle.items(), key=lambda kv: -kv[1])
    return [f"{label}: device ms by span (self / inclusive), "
            f"{ch.launched_s / max(ch.device_s, 1e-30) * 100:.2f} % of "
            "device time matched to its launch: " + "; ".join(
                f"{n} {a * per:.4f} / {b * per:.4f}" for n, (a, b) in by),
            f"{label}: idle ms by kind and span (busy "
            f"{ch.busy_s * per:.3f} of {ch.window_s * per:.3f}): "
            + "; ".join(f"{k} {n} {s * per:.4f}" for (k, n), s in idle)]


def solve_records(obs) -> dict:
    """The `engine.solve.*` records by kind: (calls, iterations used,
    their ceiling, early exits)."""
    kinds = {c["labels"]["kind"] for c in obs.get_registry().snapshot()[
        "counters"] if c["name"] == "engine.solve.calls"}
    return {k: (obs.counter_total("engine.solve.calls", kind=k),
                obs.hist_stats("engine.solve.iters_used", kind=k)["sum"],
                obs.hist_stats("engine.solve.iters_ceiling", kind=k)["sum"],
                obs.counter_total("engine.solve.early_exit", kind=k))
            for k in kinds}


def grid_shared(obs) -> dict:
    """The `engine.grid.shared` records: (lambdas, passes over Sigma a
    step, path) -> count."""
    return {(c["labels"]["lams"], c["labels"]["passes"],
             c["labels"]["outcome"]): c["value"]
            for c in obs.get_registry().snapshot()["counters"]
            if c["name"] == "engine.grid.shared"}


def route_records(obs) -> dict:
    """The `dispatch.route` records: (kernel, outcome, blocks) -> count."""
    return {(c["labels"]["kernel"], c["labels"]["outcome"],
             c["labels"]["blocks"]): c["value"]
            for c in obs.get_registry().snapshot()["counters"]
            if c["name"] == "dispatch.route"}


def tf32_hmma(lib: Path) -> dict[str, int]:
    """{H: TF32 HMMA instructions in `flash_fwd_tf32x3<H>`'s SASS} of the
    built flash library, by `cuobjdump -sass` from the CUDA toolkit."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.match(r"\S*flash_fwd_tf32x3ILi(\d+)E", part)
        if m:
            out[m.group(1)] = len(re.findall(r"HMMA[.\w]*TF32", part))
    return out


def flash_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a flash call over s positions computes."""
    if not causal:
        return s * s
    seen = np.arange(1, s + 1, dtype=np.int64)
    return int(np.minimum(seen, window or s).sum())


def zoo_flash_shapes(get_config) -> dict:
    """The flash calls of phase 9's prefills: name -> ((B, S, N, K, H),
    causal, window), from the configurations (the VLM's patches ahead of
    its prompt; the enc-dec's encoder over its frames)."""
    from repro_torch.serving import cell

    def shape(arch, s):
        c = get_config(arch)
        return (cell.BATCH, s, c.n_heads, c.n_kv_heads, c.resolved_head_dim)

    vlm, rg = get_config("internvl2-2b"), get_config("recurrentgemma-9b")
    audio = get_config("seamless-m4t-medium")
    return {
        "flash_attention_moe": (shape(ZOO_MOE, cell.PROMPT), True, 0),
        "flash_attention_vlm": (shape(vlm.name, cell.PROMPT
                                      + vlm.n_frontend_tokens), True, 0),
        "flash_attention_h256": (shape(rg.name, cell.PROMPT), True,
                                 rg.window),
        "flash_attention_noncausal": (shape(audio.name,
                                            audio.n_frontend_tokens),
                                      False, 0),
    }


def f32_flash_shapes() -> dict:
    """#9's float32 instances, from the f32 copies that launch them:
    {row: ((B, S, N, the kv heads read, H), window, lse)}. 10b's training
    copy of granite-3-2b (TRAIN_BATCH x TRAIN_SEQ, with the lse), phase
    6's granite-3-2b copy and 9a's deepseek-moe-16b copy (F32_COPY_BATCH
    prompts), and a rank of 13c-rg's recurrentgemma-9b copy on
    SHARDED_MESH_11B (its share of the batch and of the q heads, the one
    kv head replicated, the window)."""
    from repro_torch.serving import cell

    def shape(arch, b, split=1, s=cell.PROMPT):
        c = config_of(arch, {})
        n, k = c.n_heads // split, c.n_kv_heads
        kv = k // split if k % split == 0 else max(1, n // (c.n_heads // k))
        return (b, s, n, kv, c.resolved_head_dim)

    rg = config_of("recurrentgemma-9b", {})
    data, model = SHARDED_MESH_11B
    return {
        "flash_attention_f32_lse": (
            shape(cell.ARCH, TRAIN_BATCH, s=TRAIN_SEQ), 0, True),
        "flash_attention_f32": (shape(cell.ARCH, F32_COPY_BATCH), 0, False),
        "flash_attention_f32_h128": (shape(ZOO_MOE, F32_COPY_BATCH), 0,
                                     False),
        "flash_attention_f32_h256": (
            shape(rg.name, SERVE13C_BATCH // data, model), rg.window, False),
    }


def prefill_logits(params, cfg, prompt, steps, frontend=None,
                   use_kernel=None):
    """One prefill, as `greedy_generate` runs it: its last logits (f32)
    and its wall time."""
    from repro_torch.models import Batch, forward_prefill
    from repro_torch.serving.engine import frontend_offset
    off = frontend_offset(cfg, frontend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = forward_prefill(
        params, cfg, Batch(tokens=prompt, frontend=frontend),
        cache_len=prompt.shape[1] + off + steps, use_kernel=use_kernel)
    torch.cuda.synchronize()
    del caches
    return logits.float(), time.perf_counter() - t0


def generate(params, cfg, prompt, steps, frontend=None, use_kernel=None):
    """`greedy_generate` with the launch counts zeroed just before and
    read just after; (tokens, wall seconds, launches)."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.serving.engine import greedy_generate
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, steps=steps,
                          frontend=frontend, use_kernel=use_kernel)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(LAUNCHES)


def serve_checks(label, cfg, out, prompt, steps, got, want_flash):
    """The generated tokens' shape, the prompt kept, the vocabulary, and
    `flash_attention` launched `want_flash` times and nothing else."""
    from repro_torch.kernels.common import LAUNCHES
    b, s = prompt.shape
    check(out.shape == (b, s + steps) and out.dtype == prompt.dtype,
          f"{label}: generated shape {tuple(out.shape)}")
    check(bool(torch.equal(out[:, :s], prompt)),
          f"{label}: the prompt changed")
    check(bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
          f"{label}: a token outside the vocabulary")
    want = dict.fromkeys(LAUNCHES, 0)
    want["flash_attention"] = want_flash
    check(got == want, f"{label}: launches {got}, expected "
          f"flash_attention={want_flash} and nothing else")


def stream_phase(dev, card, data, res, cdata, cres, cfit_args, lam, mu,
                 Lam) -> int:
    """Phase 7: the streaming service (`repro_torch.stream`) on the card.
    Returns the `rank_update` launches of 7c's run (row 4i), and 7a's
    state statistics and 7b's first chunks with the kernel path's outcome
    at each (for phase 8c)."""
    import shutil
    import tempfile
    import threading

    from repro_torch import obs
    from repro_torch.core import sufficient_stats
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch.profile_serve import device_report
    from repro_torch.launch.stream_online import draw_chunk, make_regime
    from repro_torch.obs import torchprof
    from repro_torch.stream import (
        ServingFront, StreamingDsmlService, ingest, init_stream_state,
        refit, refit_health, refit_logistic,
    )
    from repro_torch.testing import apply_batch_fault, make_clean_batch

    def only(**counts) -> dict:
        want = dict.fromkeys(LAUNCHES, 0)
        want.update(counts)
        return want

    def delta(before: dict) -> dict:
        return {k: LAUNCHES[k] - before[k] for k in LAUNCHES}

    # ---- 7a. additivity at full width ---------------------------------
    Xs, ys = data.Xs, data.ys
    Sig_all, c_all = sufficient_stats(Xs, ys)
    chunks_a = [(Xs[:, i:i + 128].contiguous(), ys[:, i:i + 128].contiguous())
                for i in range(0, N, 128)]
    torch.cuda.synchronize()
    reset_launches()
    st = init_stream_state(M, P, device=dev)
    for X, y in chunks_a:
        st = ingest(st, X, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info = refit(st, lam, mu, Lam, lasso_iters=400, debias_iters=600,
                     warm=False)
    torch.cuda.synchronize()
    refit_a_ms = (time.perf_counter() - t0) * 1e3
    launches_a = dict(LAUNCHES)
    check(launches_a == only(rank_update=4, fista_step_gemv=400,
                             fista_step_gemm=600),
          f"7a: launches {launches_a}")
    for name, a, b in (("Sigma", st.Sigmas, Sig_all), ("c", st.cs, c_all)):
        err, scale = max_err(a, b)
        check(err <= TOL_KERNEL * scale, f"7a: chunked {name} err {err} > "
              f"{TOL_KERNEL} * {scale}")
        print(f"stream 7a: {name} of 4 chunks of 128 rows vs sufficient_stats "
              f"of the {N} rows: max abs err {err:.3g} (max {scale:.3g})")
    check(bool(torch.all(st.counts == N)), "7a: counts")
    check(bool(torch.equal(st.support, res.support)),
          "7a: the refit's support differs from phase 4's dsml_fit")
    err, scale = max_err(st.beta_u, res.beta_u)
    check(err <= TOL_FIT * scale, f"7a: refit beta_u err {err} > "
          f"{TOL_FIT} * {scale}")
    print(f"stream 7a: cold refit (400 + 600 iterations) vs phase 4's "
          f"dsml_fit: beta_u max abs err {err:.3g} (max {scale:.3g}), the "
          f"same support ({int(st.support.sum())}); wall {refit_a_ms:.1f} "
          f"ms, no front running; launches {launches_a} {card}")

    # ---- 7b. the service while serving --------------------------------
    gen = torch.Generator(device=dev).manual_seed(7)
    chol, B, _ = make_regime(gen, P, M, S, device=dev)
    chunks = []
    for i in range(24):
        if i == 12:                            # the support moves
            chol, B, _ = make_regime(gen, P, M, S, device=dev)
        chunks.append(draw_chunk(gen, chol, B, 256))
    chunks[5] = apply_batch_fault(*chunks[5], "nan",
                                  np.random.default_rng(5))
    client_rows = np.random.default_rng(11).standard_normal(
        (4096, P)).astype(np.float32)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    kw = dict(lam=lam, mu=mu, Lam=Lam, refit_every=1024, device=dev,
              chunk_n=256)
    svc = StreamingDsmlService(M, P, guard=True, ckpt_dir=ckpt_dir, **kw)
    # each generation's publication and each request, bracketed by the
    # Unix clock, the clock of the obs spans they are laid beside
    published = {0: (float("-inf"), float("-inf"),
                     svc.serving().beta_tilde)}
    publish = svc.publish_model

    def timed_publish():
        t0 = time.time()
        snap = publish()
        published[snap.generation] = (t0, time.time(), snap.beta_tilde)
        return snap

    svc.publish_model = timed_publish
    done, futures = [], []
    stop = threading.Event()

    def client(front):
        i = 0
        while not stop.is_set():
            row = client_rows[i % len(client_rows)]
            t0 = time.time()
            fut = front.submit(row)
            fut.add_done_callback(lambda f, t0=t0, row=row: done.append(
                (t0, time.time(), row, f.result())))
            futures.append(fut)
            i += 1
            time.sleep(0.0005)

    obs.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    front = ServingFront(svc, max_batch=64, max_delay_ms=2.0).start()
    th = threading.Thread(target=client, args=(front,))
    th.start()
    time.sleep(0.05)                           # traffic before chunk 0
    trail = []                     # per chunk: kernel path's outcome
    for i, (X, y) in enumerate(chunks):
        if i == 5:
            pre = (svc.state.Sigmas, svc.state.cs, svc.state.counts)
            pre_bits = [t.clone() for t in pre]
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = svc.ingest(X, y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d = delta(before)
        trail.append((t0, t1, out, svc.generation, svc._interval,
                      svc.state.support, svc.state.beta_tilde))
        if out is None:
            check(d == only(rank_update=1), f"7b chunk {i}: launches {d}")
        elif out.lasso_iters_run is not None:
            check(d == only(rank_update=1,
                            fista_step_gemv=out.lasso_iters_run,
                            fista_step_gemm=out.debias_iters_run,
                            ista_step_batched_gemv=1),
                  f"7b chunk {i}: refit launches {d}")
        if i == 5:
            check(out is None and svc.guard.total_quarantined == 1
                  and svc.guard.ledger[-1].reason == "nonfinite",
                  "7b: the NaN chunk was not quarantined")
            check(all(torch.equal(a, b) for a, b in zip(
                (svc.state.Sigmas, svc.state.cs, svc.state.counts),
                pre_bits)) and svc.state.Sigmas is pre[0],
                  "7b: the quarantined chunk changed (Sigma, c)")
    time.sleep(0.05)
    stop.set()
    th.join(30)
    check(front.stop(timeout=30) and not th.is_alive(),
          "7b: the front or its client did not stop")
    launches_b = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # the refits' solve records against what each refit returned, and
    # the fold's span by whether it waited on the guard's health read
    refits = [t[2] for t in trail
              if t[2] is not None and t[2].lasso_iters_run is not None]
    solves = solve_records(obs)
    ran = len(refits) + svc.rollbacks        # a rollback returns no count
    check(solves["lasso_eq2"][0] == solves["debias"][0] == ran
          and (svc.rollbacks or (
              solves["lasso_eq2"][1] == sum(r.lasso_iters_run
                                            for r in refits)
              and solves["debias"][1] == sum(r.debias_iters_run
                                             for r in refits))),
          f"7b: solve records {solves} against the refits' iterations")
    waited = {w: obs.hist_stats("stream.ingest.ms", waited=w)
              for w in (True, False)}
    check(waited[True] is not None
          and waited[True]["count"] == len(chunks) and waited[False] is None,
          f"7b: the guarded service's ingest spans {waited}")
    check(launches_b["rank_update"] == len(chunks),
          f"7b: {launches_b['rank_update']} rank_update launches for "
          f"{len(chunks)} chunks")
    check(all(f.done() and f.exception() is None for f in futures),
          "7b: a request failed or never resolved")
    gens = sorted(published)
    for t_sub, t_done, row, r in done:
        g = r.generation
        check(g in published, f"7b: a result of unpublished generation {g}")
        nxt = [h for h in gens if h > g]
        check(published[g][0] <= t_done
              and (not nxt or published[nxt[0]][1] >= t_sub),
              f"7b: generation {g} was not the published model while a "
              "request was in flight")
        want = published[g][2].cpu().numpy() @ row
        check(np.max(np.abs(r.scores[:, 0] - want))
              <= TOL_KERNEL * max(np.max(np.abs(want)), 1e-30),
              f"7b: a result differs from generation {g}'s model")
    # a request "during a refit" overlaps a `stream.refit` span (the
    # solves and the health check; not the checkpoint after them)
    refit_spans = [(e["ts_ns"] / 1e9, (e["ts_ns"] + e["dur_ns"]) / 1e9)
                   for e in obs.get_registry().trace_events()
                   if e["name"] == "stream.refit"]
    refit_ms = [(b - a) * 1e3 for a, b in refit_spans]
    lat, lat_refit, lat_quiet = [], [], []
    for t0, t1, _, _ in done:
        lat.append((t1 - t0) * 1e3)
        (lat_refit if any(t0 < b and t1 > a for a, b in refit_spans)
         else lat_quiet).append(lat[-1])
    check(len(lat_refit) > 0 and len(lat_quiet) > 0 and len(refit_ms) > 1,
          "7b: no request overlapped a refit, or none did not, or no warm "
          "refit ran")
    ingest_ms = [(t1 - t0) * 1e3 for i, (t0, t1, out, *_) in
                 enumerate(trail) if out is None and i != 5]
    # with the front stopped: guarded ingests into a service that does
    # not refit, a warm refit of the served state and its health check,
    # then one of each under the profiler
    quiet = StreamingDsmlService(M, P, lam=lam, mu=mu, Lam=Lam,
                                 refit_every=10**9, device=dev)
    quiet_ms = []
    for X, y in chunks[6:12]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quiet.ingest(X, y)
        torch.cuda.synchronize()
        quiet_ms.append((time.perf_counter() - t0) * 1e3)

    def warm_refit():
        cand, _ = refit(svc.state, lam, mu, Lam,
                        lasso_iters=svc.warm_lasso_iters,
                        debias_iters=svc.warm_debias_iters)
        return refit_health(cand, lam)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(warm_refit().healthy, "7b: the quiet warm refit is unhealthy")
    quiet_refit_ms = (time.perf_counter() - t0) * 1e3
    prof_dir = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    for label, fn in (("a chunk's ingest", lambda: quiet.ingest(*chunks[12])),
                      ("a warm refit and its health check", warm_refit)):
        with torchprof.profiler_trace(prof_dir) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        device_report(f"stream 7b profile, {label} (front stopped)", prof,
                      wall_s, 1)
    shutil.rmtree(prof_dir)
    # the same chunks into an unguarded service: its spans time the issue
    loose = StreamingDsmlService(M, P, lam=lam, mu=mu, Lam=Lam,
                                 refit_every=10**9, device=dev, guard=False)
    for X, y in chunks[6:12]:
        loose.ingest(X, y)
    torch.cuda.synchronize()
    issued = obs.hist_stats("stream.ingest.ms", waited=False)
    check(issued is not None and issued["count"] == 6,
          f"7b: the unguarded ingests' spans {issued}")
    del loose
    torch.cuda.synchronize()
    with torchprof.span_trace() as box:
        warm_refit()
        torch.cuda.synchronize()
    for line in charge_lines("stream 7b a warm refit and its health "
                             "check, traced", box["charge"]):
        print(f"{line} {card}")
    print(f"stream 7b ingest spans, the front stopped: unguarded "
          f"(waited=False, the issue alone) mean {issued['mean']:.3f} ms "
          f"over {issued['count']} chunks; guarded (waited=True) "
          f"{pct(quiet_ms, 0.5):.3f} ms p50 to a synchronize "
          f"{card}")
    t0 = time.perf_counter()
    ckpt_path = svc.checkpoint()
    ckpt_ms = (time.perf_counter() - t0) * 1e3
    ckpt_mib = os.path.getsize(ckpt_path) / 2**20
    fresh = StreamingDsmlService(M, P, ckpt_dir=ckpt_dir, **kw)
    check(fresh.restore() == svc.generation,
          "7b: restore() did not return the last checkpoint's generation")
    check(all(a.device == b.device and torch.equal(a, b)
              for a, b in zip(fresh.state, svc.state)),
          "7b: restore() did not return the last checkpoint's bits")
    del fresh
    shutil.rmtree(ckpt_dir)
    sizes = [int(s.sum()) for _, _, _, _, _, s, _ in trail]
    print(f"stream 7b: {len(chunks)} chunks of (16, 256, 1024), the support "
          f"moved at chunk 12, chunk 5 NaN-poisoned and quarantined with "
          f"(Sigma, c, counts) bitwise unchanged; generations "
          f"{svc.generation}, rollbacks {svc.rollbacks}, refits at chunks "
          f"{[i for i, t in enumerate(trail) if t[2] is not None]}, "
          f"intervals {[t[4] for t in trail]}, support sizes {sizes}; "
          f"launches {launches_b} (rank_update 1 a chunk; a refit: the "
          f"GEMV once a lasso iteration, the SGEMM once a debias "
          f"iteration, ista_step_batched once)")
    print(f"stream 7b times, the front serving: ingest p50 "
          f"{pct(ingest_ms, 0.5):.3f} ms a chunk (to a synchronize; "
          f"{len(ingest_ms)} chunks without a refit), "
          f"{M * 256 / pct(ingest_ms, 0.5) * 1e3:.0f} rows/s; refit cold "
          f"{refit_ms[0]:.1f} ms, warm p50 {pct(refit_ms[1:], 0.5):.1f} ms "
          f"(max {max(refit_ms[1:]):.1f}; stream.refit spans); checkpoint "
          f"save {ckpt_ms:.1f} ms ({ckpt_mib:.1f} MiB); peak memory "
          f"{peak_gib:.2f} GiB {card}")
    print(f"stream 7b records: refits' solves {solves} (calls, "
          f"iterations used, their ceiling, early exits); "
          f"stream.ingest.ms{{waited=True}} mean "
          f"{waited[True]['mean']:.3f} ms over {waited[True]['count']} "
          f"chunks (the fused guard's read waits on the fold) {card}")
    print(f"stream 7b times, the front stopped: ingest p50 "
          f"{pct(quiet_ms, 0.5):.3f} ms a chunk ({len(quiet_ms)} chunks, "
          f"{M * 256 / pct(quiet_ms, 0.5) * 1e3:.0f} rows/s); a warm refit "
          f"and its health check {quiet_refit_ms:.1f} ms {card}")
    print(f"stream 7b serving front (max_batch 64, max_delay 2 ms, one "
          f"client, a row every 0.5 ms): {len(lat)} requests, "
          f"serve.request_ms p50 {pct(lat, 0.5):.3f} p99 "
          f"{pct(lat, 0.99):.3f}; during a refit ({len(lat_refit)}): "
          f"p50 {pct(lat_refit, 0.5):.3f} p99 {pct(lat_refit, 0.99):.3f} "
          f"max {max(lat_refit):.3f}; outside refits ({len(lat_quiet)}): "
          f"p50 {pct(lat_quiet, 0.5):.3f} p99 {pct(lat_quiet, 0.99):.3f}; "
          f"batches {obs.counter_total('serve.batches'):.0f}, mean rows "
          f"{obs.hist_stats('serve.batch_rows')['mean']:.2f} {card}")

    # the same chunks on the plain path on the card, with no front
    ref = StreamingDsmlService(M, P, guard=True, use_kernel=False, **kw)
    before = dict(LAUNCHES)
    worst = 0.0
    for i, (X, y) in enumerate(chunks):
        out = ref.ingest(X, y)
        _, _, got, g, interval, support, beta = trail[i]
        check((out is None) == (got is None) and ref.generation == g
              and ref._interval == interval,
              f"7b chunk {i}: the plain path's cadence differs")
        check(bool(torch.equal(ref.state.support, support)),
              f"7b chunk {i}: the plain path's support differs")
        err, scale = max_err(beta, ref.state.beta_tilde)
        check(err <= TOL_FIT * scale, f"7b chunk {i}: beta_tilde err {err} "
              f"> {TOL_FIT} * {scale}")
        worst = max(worst, err)
    check(dict(LAUNCHES) == before, "7b: the plain path launched a kernel")
    print(f"stream 7b plain path (use_kernel=False, on the card): the same "
          f"generations, cadence and supports at every chunk; beta_tilde "
          f"max abs err {worst:.3g}")

    # ---- 7c. the ingest shape of row 4i -------------------------------
    rng = np.random.default_rng(0)
    m_i, n_i, p_i = INGEST
    chunks_i = [make_clean_batch(rng, m_i, n_i, p_i, device=dev)
                for _ in range(8)]
    svc_i = StreamingDsmlService(
        m_i, p_i, lam=0.4, mu=0.2, Lam=1.0, guard=False, refit_every=n_i,
        max_refit_interval=4 * n_i, lasso_iters=200, debias_iters=200,
        refit_tol=1e-5, device=dev, chunk_n=n_i)
    torch.cuda.synchronize()
    reset_launches()
    times_i, refits_i = [], []
    for i, (X, y) in enumerate(chunks_i):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        out = svc_i.ingest(X, y)
        torch.cuda.synchronize()
        (times_i if out is None else refits_i).append(
            (time.perf_counter() - t0) * 1e3)
        check(delta(before)["rank_update"] == 1,
              f"7c chunk {i}: rank_update launched {delta(before)}")
    launches_c = LAUNCHES["rank_update"]
    check(launches_c == len(chunks_i), f"7c: {launches_c} launches")
    # what phase 8c holds its sharded ingest and service against
    carried = {"Sigmas": st.Sigmas, "cs": st.cs, "chunks": chunks[:CHUNKS_8C],
               "trail": [(out is None, g, interval, support, beta)
                         for _, _, out, g, interval, support, beta
                         in trail[:CHUNKS_8C]]}
    print(f"stream 7c ({m_i}, {n_i}, {p_i}) x {len(chunks_i)} chunks, "
          f"refit_every {n_i} (benchmarks/stream_bench.py's full "
          f"configuration): rank_update {launches_c} launches, one a chunk; "
          f"ingest without a refit p50 {pct(times_i, 0.5):.3f} ms "
          f"({len(times_i)} chunks, {m_i * n_i / pct(times_i, 0.5) * 1e3:.0f}"
          f" rows/s), with a refit p50 {pct(refits_i, 0.5):.1f} ms "
          f"({len(refits_i)}); generation {svc_i.generation} {card}")

    # ---- 7d. refit_logistic, cold then warm ---------------------------
    cX, cy, lam_c, mu_c, Lam_c = cfit_args
    st_k = st_p = init_stream_state(M, P, device=dev)
    for g in (0, 1):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        st_k, _ = refit_logistic(st_k, cX, cy, lam_c, mu_c, Lam_c)
        torch.cuda.synchronize()
        k_ms = (time.perf_counter() - t0) * 1e3
        launches_d = dict(LAUNCHES)
        check(launches_d == only(rank_update=2, logistic_grad=600,
                                 fista_step_gemm=600),
              f"7d generation {g}: launches {launches_d}")
        t0 = time.perf_counter()
        st_p, _ = refit_logistic(st_p, cX, cy, lam_c, mu_c, Lam_c,
                                 use_kernel=False)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        check(dict(LAUNCHES) == launches_d,
              "7d: the plain path launched a kernel")
        err, scale = max_err(st_k.beta_u, st_p.beta_u)
        check(err <= TOL_FIT * scale, f"7d generation {g}: beta_u err {err} "
              f"> {TOL_FIT} * {scale}")
        check(bool(torch.equal(st_k.support, st_p.support)),
              f"7d generation {g}: supports differ")
        if g == 0:
            e0, s0 = max_err(st_k.beta_u, cres.beta_u)
            check(e0 <= TOL_FIT * s0 and bool(torch.equal(st_k.support,
                                                          cres.support)),
                  "7d: the cold refit differs from phase 4b's fit")
        print(f"stream 7d refit_logistic generation {g} -> {g + 1} "
              f"({'cold' if g == 0 else 'warm'}, 600 + 600 iterations): "
              f"beta_u max abs err vs plain {err:.3g} (max {scale:.3g}), "
              f"the same support ({int(st_k.support.sum())}); launches "
              f"{launches_d} (rank_update: the step sizes' and the weighted "
              f"Hessian's); wall kernels {k_ms:.1f} ms, plain {p_ms:.1f} ms "
              f"{card}")
    return launches_c, carried


# the program every rank of phase 8 runs (`run_probe`: one process a
# rank on the one card, `file://` rendezvous); `@SPEC@` is its JSON spec
RANK_PROGRAM = r"""
import json, time
T0 = time.time()
import torch
import torch.distributed as dist
from repro_torch import obs
from repro_torch.core import dsml_fit_sharded
from repro_torch.kernels import _build
from repro_torch.kernels.common import LAUNCHES, reset_launches
from repro_torch.multitask import ProbeData, sparse_probe_fit
from repro_torch.stream import (
    StreamingDsmlService, ingest_sharded, init_stream_state,
)
from repro_torch.substrate import (
    all_gather_tasks, data_task_mesh, feed_chunk, init_from_env, task_mesh,
)
from repro_torch.testing import count_collectives

spec = json.load(open("@SPEC@"))
dev = torch.device("cuda")
T1 = time.time()
rank, world = init_from_env(device=dev)
T2 = time.time()
_build.build()
out = dict(rank=rank, world=world, backend=dist.get_backend(),
           spawn_s=T0 - spec["t_spawn"], import_s=T1 - T0,
           rendezvous_s=T2 - T1, compiled=sorted(_build.BUILD_SECONDS))
lam, mu, Lam = spec["lam"], spec["mu"], spec["Lam"]
data = torch.load(spec["data"])
Xs, ys = data["Xs"].to(dev), data["ys"].to(dev)


def counted(fn):
    # fn() with launches, the ledger, the wrapped torch.distributed calls
    # and the peak memory zeroed just before and read just after
    torch.cuda.synchronize()
    reset_launches()
    obs.reset()
    torch.cuda.reset_peak_memory_stats()
    with count_collectives() as calls:
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return r, dict(
        wall_ms=wall * 1e3, launches={k: v for k, v in LAUNCHES.items() if v},
        calls=dict(calls), peak_mib=torch.cuda.max_memory_allocated() / 2**20,
        ledger={op: [obs.counter_total("collective.calls", op=op),
                     obs.counter_total("collective.bytes", op=op)]
                for op in ("all_gather_tasks", "psum_stats", "pmax",
                           "pmin")})


def gather_ms(x, mesh):
    # the all-gather alone, CUDA events around it on this rank
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    all_gather_tasks(x, mesh)
    torch.cuda.synchronize()
    e0.record()
    all_gather_tasks(x, mesh)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def save(name, obj):
    torch.save(obj, f"{spec['out']}/{name}_rank{rank}.pt")


if "fit" in spec["phases"]:
    mesh = task_mesh()
    ml = Xs.shape[0] // world
    X = Xs[rank * ml:(rank + 1) * ml].contiguous()
    y = ys[rank * ml:(rank + 1) * ml].contiguous()
    dsml_fit_sharded(X, y, lam, mu, Lam, mesh, lasso_iters=2,
                     debias_iters=2)
    res, out["fit"] = counted(lambda: dsml_fit_sharded(X, y, lam, mu, Lam,
                                                       mesh))
    out["fit"]["span_ms"] = {n: obs.hist_stats(f"{n}.ms")["sum"]
                             for n in ("dsml.fit_sharded", "dsml.allgather")}
    out["fit"]["gather_ms"] = gather_ms(res.beta_u, mesh)
    save("fit", {k: v.cpu() for k, v in res._asdict().items()})

if "ingest" in spec["phases"]:
    mesh2 = data_task_mesh(n_task=2)
    t = mesh2.get_coordinate()[1]
    ml = Xs.shape[0] // 2
    chunks = [(Xs[:, i:i + 128].contiguous(), ys[:, i:i + 128].contiguous())
              for i in range(0, Xs.shape[1], 128)]
    state0 = init_stream_state(ml, Xs.shape[2], device=dev)

    def run():
        st = state0
        for X, y in chunks:
            st = ingest_sharded(st, *feed_chunk(X, y, mesh2), mesh2)
        return st

    run()
    st, out["ingest"] = counted(run)
    ref = torch.load(spec["st7a"])
    rows = slice(t * ml, (t + 1) * ml)
    for name in ("Sigmas", "cs"):
        want = ref[name][rows].to(dev)
        out["ingest"][name] = [
            torch.max(torch.abs(getattr(st, name) - want)).item(),
            torch.max(torch.abs(want)).item()]
    chunks7b = [(X.to(dev), y.to(dev)) for X, y in torch.load(spec["chunks7b"])]
    svc_args = dict(lam=lam, mu=mu, Lam=Lam, refit_every=1024, device=dev,
                    guard=True, mesh=mesh2, ckpt_dir=spec["ckpt"])
    svc = StreamingDsmlService(Xs.shape[0], Xs.shape[2], **svc_args)
    trail = []

    def run_service():
        for X, y in chunks7b:
            info = svc.ingest(X, y)
            trail.append((info is None, svc.generation, svc._interval,
                          svc.state.support.cpu(),
                          svc.state.beta_tilde.cpu()))

    _, out["service"] = counted(run_service)
    out["service"]["pmax"] = out["service"]["ledger"]["pmax"][0]
    save("service", trail)
    # the checkpoint a refit writes: the gather of the task blocks over
    # task (data-coordinate-0 ranks), rank (0, 0) writing, the agreement;
    # then a fresh service on every rank restores its block
    torch.cuda.synchronize()
    t = time.perf_counter()
    svc._global_tree()
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t
    _, ck = counted(svc.checkpoint)
    fresh = StreamingDsmlService(Xs.shape[0], Xs.shape[2], **svc_args)
    restored, rs = counted(fresh.restore)
    out["ckpt"] = dict(
        gather_ms=gather_s * 1e3, checkpoint_ms=ck["wall_ms"],
        restore_ms=rs["wall_ms"], gathers=ck["ledger"]["all_gather_tasks"],
        pmin=[ck["ledger"]["pmin"][0], rs["ledger"]["pmin"][0]],
        generation=svc.generation, restored=restored,
        same=all(torch.equal(getattr(fresh.state, f), getattr(svc.state, f))
                 for f in svc.state._fields))

if "probe" in spec["phases"]:
    probe = torch.load(spec["probe"])
    ml = probe["features"].shape[0] // world
    pdata = ProbeData(
        probe["features"][rank * ml:(rank + 1) * ml].to(dev).contiguous(),
        probe["targets"][rank * ml:(rank + 1) * ml].to(dev).contiguous())
    mesh = task_mesh()
    sparse_probe_fit(pdata, mesh=mesh, lasso_iters=2, debias_iters=2)
    res, out["probe"] = counted(lambda: sparse_probe_fit(pdata, mesh=mesh))
    save("probe", {k: v.cpu() for k, v in res._asdict().items()})

dist.destroy_process_group()
print("RANK8 " + json.dumps(out))
"""


def distributed_phase(dev, card, data, res, carried, lam, mu, Lam) -> dict:
    """Phase 8: the distributed path on the card, each rank a process.
    Returns the launches per kernel of the phase (ranks and parent)."""
    import shutil
    import tempfile

    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.multitask import (
        default_threshold, probe_predict, sparse_probe_fit,
        synthetic_probe_tasks,
    )
    from repro_torch.serving import cell
    from repro_torch.substrate import run_probe

    total: dict[str, int] = {}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def fit_launches(gemm: int) -> dict:
        return {"rank_update": 1, "fista_step_gemv": 400,
                "fista_step_gemm": gemm}

    def ranks(world, backend, phases, tmp):
        """Run RANK_PROGRAM as `world` ranks; every rank's JSON line, its
        saved tensors by name, and the wall time of the whole run."""
        spec = dict(lam=lam, mu=mu, Lam=Lam, phases=phases, out=tmp,
                    data=f"{tmp}/data.pt", st7a=f"{tmp}/st7a.pt",
                    chunks7b=f"{tmp}/chunks7b.pt", probe=f"{tmp}/probe.pt",
                    ckpt=f"{tmp}/ckpt8c",
                    t_spawn=time.time())
        path = f"{tmp}/spec_{backend}_{world}.json"
        Path(path).write_text(json.dumps(spec))
        t0 = time.perf_counter()
        run = run_probe(RANK_PROGRAM.replace("@SPEC@", path), world=world,
                        backend=backend, timeout=600, pg_timeout=300)
        wall = time.perf_counter() - t0
        check(run.ok, f"phase 8 ranks ({backend}, {world}) failed:\n"
              f"{run.report()}")
        lines = []
        for i, r in enumerate(run.ranks):
            found = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("RANK8 ")]
            check(len(found) == 1, f"rank {i}: no result line:\n{r.stdout}")
            line = json.loads(found[0][len("RANK8 "):])
            check(line["compiled"] == [],
                  f"rank {i} recompiled kernels: {line['compiled']}")
            lines.append(line)
        saved = {name: [torch.load(f"{tmp}/{name}_rank{i}.pt")
                        for i in range(world)]
                 for name in ("fit", "service", "probe")
                 if Path(f"{tmp}/{name}_rank0.pt").exists()}
        starts = [ln["spawn_s"] + ln["import_s"] for ln in lines]
        rdv = [ln["rendezvous_s"] for ln in lines]
        print(f"phase 8 {backend} x {world}: the whole run {wall:.1f} s; "
              f"spawn to imports done {min(starts):.1f}-{max(starts):.1f} "
              f"s, rendezvous {min(rdv):.2f}-{max(rdv):.2f} s; no rank "
              f"compiled a kernel {card}")
        return lines, saved

    def fit_checks(label, lines, saved, world, exact):
        ml = M // world
        same_bits, worst = True, 0.0
        for i, (line, got) in enumerate(zip(lines, saved)):
            st = line["fit"]
            check(st["launches"] == fit_launches(600),
                  f"{label} rank {i}: launches {st['launches']}")
            check(sum(st["calls"].values()) == 1,
                  f"{label} rank {i}: collectives {st['calls']}")
            check(st["ledger"]["all_gather_tasks"] ==
                  [1, world * ml * P * 4],
                  f"{label} rank {i}: ledger {st['ledger']}")
            rows = slice(i * ml, (i + 1) * ml)
            for name in ("beta_tilde", "beta_u", "beta_local"):
                want = getattr(res, name)[rows].cpu()
                same_bits &= bool(torch.equal(got[name], want))
                err, scale = max_err(got[name], want)
                check(err <= TOL_KERNEL * scale, f"{label} rank {i} {name}:"
                      f" err {err} > {TOL_KERNEL} * {scale}")
                if name == "beta_tilde":
                    worst = max(worst, err)
            same_bits &= bool(torch.equal(got["beta_u_all"],
                                          res.beta_u.cpu()))
            check(bool(torch.equal(got["support"], res.support.cpu())),
                  f"{label} rank {i}: the support differs from phase 4's")
            add(st["launches"])
        if exact:
            check(same_bits, f"{label}: not phase 4's bits")
        walls = [ln["fit"]["wall_ms"] for ln in lines]
        print(f"phase {label} dsml_fit_sharded ({world} x {ml} tasks, n {N}, "
              f"p {P}, 400 + 600): the same support as phase 4, "
              f"{'the same bits' if same_bits else 'not the same bits'}, "
              f"beta_tilde max abs err {worst:.3g} (max "
              f"{torch.max(torch.abs(res.beta_tilde)).item():.3g}); "
              f"each rank launches {lines[0]['fit']['launches']} and issues "
              f"one collective ({lines[0]['fit']['calls']}), ledger "
              f"{lines[0]['fit']['ledger']['all_gather_tasks']} (calls, "
              f"bytes); fit wall {min(walls):.1f}-{max(walls):.1f} ms; "
              f"all-gather alone "
              f"{[round(ln['fit']['gather_ms'], 4) for ln in lines]} ms; "
              f"host spans (dsml.fit_sharded, dsml.allgather) "
              f"{[[round(v, 3) for v in ln['fit']['span_ms'].values()]
                  for ln in lines]} ms; "
              f"peak {[round(ln['fit']['peak_mib']) for ln in lines]} MiB "
              f"{card}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        torch.save({"Xs": data.Xs.cpu(), "ys": data.ys.cpu()},
                   f"{tmp}/data.pt")
        torch.save({"Sigmas": carried["Sigmas"].cpu(),
                    "cs": carried["cs"].cpu()}, f"{tmp}/st7a.pt")
        torch.save([(X.cpu(), y.cpu()) for X, y in carried["chunks"]],
                   f"{tmp}/chunks7b.pt")

        # ---- 8d, this process: granite-3-2b's features and the fits ----
        cfg, params, _ = cell.make_cell(dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        pdata, psupport = synthetic_probe_tasks(
            torch.Generator(device=dev).manual_seed(1), params, cfg, m=4,
            n=96, seq=16, s_active=6)
        torch.cuda.synchronize()
        feat_s = time.perf_counter() - t0
        check(not any(LAUNCHES.values()), f"8d features: {dict(LAUNCHES)}")
        del params
        check(pdata.features.shape == (4, 96, cfg.d_model) and bool(
            torch.isfinite(pdata.features).all()), "8d: the features")
        sparse_probe_fit(pdata, lasso_iters=2, debias_iters=2)   # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        pk = sparse_probe_fit(pdata)
        torch.cuda.synchronize()
        probe_k_s = time.perf_counter() - t0
        launches_d = {k: v for k, v in LAUNCHES.items() if v}
        check(launches_d == fit_launches(400), f"8d launches {launches_d}")
        add(launches_d)
        t0 = time.perf_counter()
        pp = sparse_probe_fit(pdata, use_kernel=False)
        torch.cuda.synchronize()
        probe_p_s = time.perf_counter() - t0
        check({k: v for k, v in LAUNCHES.items() if v} == launches_d,
              "8d: the plain path launched a kernel")
        lam_k, lam_p = default_threshold(pk.beta_u), \
            default_threshold(pp.beta_u)
        # Lambda is read off beta_u, which the paths sum in another order
        check(abs(lam_k - lam_p) <= TOL_FIT * lam_p,
              f"8d: Lambda {lam_k} against the plain path's {lam_p}")
        check(bool(torch.equal(pk.support, pp.support)),
              "8d: the support differs from the plain path's")
        err, scale = max_err(pk.beta_tilde, pp.beta_tilde)
        check(err <= TOL_FIT * scale, f"8d beta_tilde: err {err} > "
              f"{TOL_FIT} * {scale}")
        tp = int(torch.sum(pk.support & psupport))
        fp = int(torch.sum(pk.support & ~psupport))
        pred = probe_predict(pk, pdata.features)
        r2 = 1 - float(torch.var(pred - pdata.targets, correction=0)
                       / torch.var(pdata.targets, correction=0))
        print(f"phase 8d {cfg.name} unreduced ({cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.compute_dtype}), 4 tasks x 96 sequences "
              f"of 16 tokens: features {feat_s * 1e3:.1f} ms (no flash "
              f"launch: 16 x 16 scores take the dense branch); "
              f"sparse_probe_fit (400 + 400) kernels {probe_k_s * 1e3:.1f} "
              f"ms, plain {probe_p_s * 1e3:.1f} ms; Lambda {lam_k!r} "
              f"(plain {lam_p!r}), the same support "
              f"({int(pk.support.sum())}), "
              f"beta_tilde max abs err {err:.3g} (max {scale:.3g}); "
              f"recovered {tp}/{int(psupport.sum())} true dims, {fp} false "
              f"positives, R^2 {r2:.3f}; launches {launches_d} {card}")
        torch.save({"features": pdata.features.cpu(),
                    "targets": pdata.targets.cpu()}, f"{tmp}/probe.pt")

        # ---- 8a. one rank over NCCL -------------------------------------
        lines, saved = ranks(1, "nccl", ["fit"], tmp)
        check(lines[0]["backend"] == "nccl", "8a backend")
        fit_checks("8a", lines, saved["fit"], 1, exact=True)

        # ---- 8b-8d. four ranks on the one card over gloo ----------------
        lines, saved = ranks(4, "gloo", ["fit", "ingest", "probe"], tmp)
        fit_checks("8b", lines, saved["fit"], 4, exact=False)

        n_chunks = N // 128
        ml = M // 2
        for i, line in enumerate(lines):
            st = line["ingest"]
            check(st["launches"] == {"rank_update": n_chunks},
                  f"8c rank {i}: launches {st['launches']}")
            check(st["calls"] == {"all_reduce": 2 * n_chunks},
                  f"8c rank {i}: collectives {st['calls']}")
            check(st["ledger"]["psum_stats"] == [
                2 * n_chunks, n_chunks * 2 * 4 * (ml * P * P + ml * P)],
                f"8c rank {i}: ledger {st['ledger']}")
            for name in ("Sigmas", "cs"):
                err, scale = st[name]
                check(err <= TOL_KERNEL * scale, f"8c rank {i} {name}: err "
                      f"{err} > {TOL_KERNEL} * {scale}")
            add(st["launches"])
        errs = [(ln["ingest"]["Sigmas"][0], ln["ingest"]["cs"][0])
                for ln in lines]
        print(f"phase 8c ingest_sharded on a 2 x 2 data x task mesh, phase "
              f"7a's {n_chunks} chunks of 128 rows: Sigma, c max abs err vs "
              f"7a {errs} (max {lines[0]['ingest']['Sigmas'][1]:.3g}, "
              f"{lines[0]['ingest']['cs'][1]:.3g}); each rank one "
              f"rank_update and two all-reduces a chunk; wall "
              f"{[round(ln['ingest']['wall_ms'], 1) for ln in lines]} ms "
              f"for the {n_chunks} chunks {card}")

        trail = carried["trail"]
        worst = 0.0
        for i, (line, got) in enumerate(zip(lines, saved["service"])):
            for c, (g, w) in enumerate(zip(got, trail)):
                check(g[:3] == w[:3], f"8c service rank {i} chunk {c}: "
                      f"{g[:3]} != phase 7b's {w[:3]}")
                check(bool(torch.equal(g[3], w[3].cpu())),
                      f"8c service rank {i} chunk {c}: the support differs")
                rows = slice((i % 2) * ml, (i % 2 + 1) * ml)
                err, scale = max_err(g[4], w[4][rows].cpu())
                check(err <= TOL_FIT * scale, f"8c service rank {i} chunk {c}: beta_tilde err {err} > "
                      f"{TOL_FIT} * {scale}")
                worst = max(worst, err)
            st = line["service"]
            check(st["launches"].get("rank_update") == len(trail) - 1,
                  f"8c service rank {i}: launches {st['launches']}")
            check(st["pmax"] == 2 * sum(not w[0] for w in trail),
                  f"8c service rank {i}: {st['pmax']} pmax")
            add(st["launches"])
        for i, line in enumerate(lines):
            ck = line["ckpt"]
            check(ck["same"] and ck["restored"] == ck["generation"],
                  f"8c rank {i}: restored generation {ck['restored']} of "
                  f"{ck['generation']}, the same bits: {ck['same']}")
            check(ck["pmin"] == [2, 2], f"8c rank {i}: pmin {ck['pmin']}")
            # 7 task fields: Sigmas and Ms (m_local, p, p) each
            check(ck["gathers"][0] == (7 if i < 2 else 0),
                  f"8c rank {i}: checkpoint gathers {ck['gathers']}")
        gathered = lines[0]["ckpt"]["gathers"][1]
        print(f"phase 8c the sharded service's checkpoint in one shared "
              f"directory (global (16, 1024, 1024) layout, rank (0, 0) "
              f"writes): the gather over task on the data-0 ranks "
              f"({gathered / 2**20:.0f} MiB by the ledger, Sigma 64 MiB of "
              f"it) {[round(ln['ckpt']['gather_ms'], 1) for ln in lines]} "
              f"ms, the whole checkpoint "
              f"{[round(ln['ckpt']['checkpoint_ms'], 1) for ln in lines]} "
              f"ms; a fresh service on every rank restored generation "
              f"{lines[0]['ckpt']['restored']} (one pmin a mesh dim), its "
              f"own block bit for bit, in "
              f"{[round(ln['ckpt']['restore_ms'], 1) for ln in lines]} ms "
              f"{card}")
        print(f"phase 8c StreamingDsmlService(mesh=2 x 2) on phase 7b's "
              f"first {len(trail)} chunks (the NaN chunk 5 quarantined, "
              f"refits at chunks "
              f"{[c for c, w in enumerate(trail) if not w[0]]}): phase 7b's "
              f"generations, intervals and supports at every chunk on every "
              f"rank, beta_tilde max abs err {worst:.3g}; wall "
              f"{[round(ln['service']['wall_ms'], 1) for ln in lines]} ms; "
              f"launches rank 0 {lines[0]['service']['launches']} {card}")

        ml = 1
        for i, (line, got) in enumerate(zip(lines, saved["probe"])):
            st = line["probe"]
            check(st["launches"] == fit_launches(400),
                  f"8d rank {i}: launches {st['launches']}")
            check(sum(st["calls"].values()) == 1,
                  f"8d rank {i}: collectives {st['calls']}")
            check(bool(torch.equal(got["support"], pk.support.cpu())),
                  f"8d rank {i}: the support differs")
            err, scale = max_err(got["beta_tilde"], pk.beta_tilde[i:i + 1]
                                 .cpu())
            check(err <= TOL_KERNEL * scale, f"8d rank {i}: beta_tilde err "
                  f"{err} > {TOL_KERNEL} * {scale}")
            add(st["launches"])
        print(f"phase 8d the probe sharded over 4 ranks, one task each: the "
              f"single-process support, beta_tilde within {TOL_KERNEL} * "
              f"max; one collective a rank; fit wall "
              f"{[round(ln['probe']['wall_ms'], 1) for ln in lines]} ms, "
              f"peak {[round(ln['probe']['peak_mib']) for ln in lines]} MiB "
              f"{card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 8 launches (ranks and this process): {total}")
    return total


# the program every rank of phase 9c runs (`run_probe`, gloo, the one
# card): one MoE layer at deepseek-moe-16b's widths in f32, its experts
# split over `model`, its tokens over `data`; `@OUT@` is a directory
A2A_PROGRAM = r"""
import dataclasses, json, time
import torch
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models.moe import init_moe_params, moe_apply
from repro_torch.models.moe_shard_map import moe_apply_a2a
from repro_torch.substrate import (
    all_to_all_experts, data_model_mesh, init_from_env,
)
from repro_torch.testing import count_collectives

dev = torch.device("cuda")
rank, world = init_from_env(device=dev)
mesh = data_model_mesh(2)               # (data, model) = divmod(rank, 2)
cfg = get_config("@ARCH@").replace(param_dtype="float32",
                                   compute_dtype="float32")
cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
# every rank draws the same layer and batch from the same seeds
p = init_moe_params(torch.Generator(device=dev).manual_seed(0), cfg,
                    torch.float32)
x = torch.randn((4, @TOKENS@, cfg.d_model), device=dev,
                generator=torch.Generator(device=dev).manual_seed(1))
ref, _ = moe_apply(p, x, cfg)
dc, mc = mesh.get_coordinate()
E_loc = cfg.moe.n_experts // 2
mine = {**p, "experts": {k: v[mc * E_loc:(mc + 1) * E_loc].contiguous()
                         for k, v in p["experts"].items()}}
xb = x[2 * dc:2 * dc + 2].contiguous()
moe_apply_a2a(mine, xb, cfg, mesh)          # warm-up
torch.cuda.synchronize()
obs.reset()
with count_collectives() as calls:
    t = time.perf_counter()
    out, _ = moe_apply_a2a(mine, xb, cfg, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
ledger = [obs.counter_total("collective.calls", op="all_to_all_experts"),
          obs.counter_total("collective.calls")]
want = ref[2 * dc:2 * dc + 2]
T = xb.shape[0] * xb.shape[1]
C = -(-T * cfg.moe.top_k * 8 // cfg.moe.n_experts)
send = torch.zeros((2, E_loc, C, cfg.d_model), device=dev)
all_to_all_experts(send, mesh, "model")
torch.cuda.synchronize()
t = time.perf_counter()
all_to_all_experts(send, mesh, "model")
torch.cuda.synchronize()
a2a_ms = (time.perf_counter() - t) * 1e3
print("RANK9 " + json.dumps({
    "err": (out - want).abs().max().item(), "scale": want.abs().max().item(),
    "calls": dict(calls), "wall_ms": wall * 1e3, "a2a_ms": a2a_ms,
    "a2a_mib": send.numel() * 4 / 2**20, "C": C, "ledger": ledger}))
"""


def zoo_model(arch, dev, **changes):
    """(cfg, params, prompt, frontend) of a phase-9 family: the serving
    cell's request batch (`serving/cell.py`) for `get_config(arch)` with
    `changes`, and its stub frontend where it has one."""
    from repro_torch.serving import cell
    cfg, params, prompt = cell.make_cell(dev, arch, **changes)
    return cfg, params, prompt, cell.make_frontend(cfg, dev)


def param_gib(params) -> tuple[float, int]:
    """(GiB, count) of a parameter tree."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    return (sum(t.numel() * t.element_size() for t in leaves) / 2**30,
            sum(t.numel() for t in leaves))


def moe_drop_fractions(params, cfg, prompt):
    """The MoE layers' drop fractions (mean over layers) in the prefill
    and the decode step of a 2-token `greedy_generate`: its `moe_apply`
    calls are recorded (the phase's warm-up)."""
    from repro_torch.models import backbone
    seen, inner = [], backbone.moe_apply

    def recording(p, x, c):
        out, aux = inner(p, x, c)
        seen.append((x.shape[0] * x.shape[1], aux["moe_drop_frac"]))
        return out, aux

    backbone.moe_apply = recording
    try:
        generate(params, cfg, prompt, 2)
    finally:
        backbone.moe_apply = inner
    b = prompt.shape[0]
    pre = [float(f) for t, f in seen if t > b]
    dec = [float(f) for t, f in seen if t == b]
    return sum(pre) / len(pre), sum(dec) / len(dec)


@contextmanager
def moe_routes(routes: list, replay: bool = False):
    """Within the block, every `moe.route` call appends its top-k experts
    to `routes`, or, with `replay`, takes the next of `routes` instead
    (weighted by its own probabilities, renormalised over them), so that
    a run makes another run's routing choices and capacity drops."""
    from repro_torch.models import moe
    inner, recorded = moe.route, iter(list(routes))

    def hooked(logits, K):
        probs, top_w, top_e = inner(logits, K)
        if replay:
            top_e = next(recorded)
            top_w = torch.gather(probs, 1, top_e)
            top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
        else:
            routes.append(top_e)
        return probs, top_w, top_e

    moe.route = hooked
    try:
        yield routes
    finally:
        moe.route = inner


@contextmanager
def encoder_launches(counts: list):
    """Within the block, each `_encoder_forward` call appends the
    `flash_attention` launches made inside it (the count read just
    before and just after it) to `counts`."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models import backbone
    inner = backbone._encoder_forward

    def counted(*args, **kwargs):
        before = LAUNCHES["flash_attention"]
        out = inner(*args, **kwargs)
        counts.append(LAUNCHES["flash_attention"] - before)
        return out

    backbone._encoder_forward = counted
    try:
        yield counts
    finally:
        backbone._encoder_forward = inner


@contextmanager
def moe_drops(seen: list):
    """Within the block, each `moe_apply` call of the model appends its
    drop fraction to `seen` (a float; on DTensors this rank's replica,
    read without a collective)."""
    from repro_torch.models import backbone
    from repro_torch.sharding.place import local
    inner = backbone.moe_apply

    def recording(p, x, c):
        out, aux = inner(p, x, c)
        seen.append(float(local(aux["moe_drop_frac"])))
        return out, aux

    backbone.moe_apply = recording
    try:
        yield seen
    finally:
        backbone.moe_apply = inner


def route_flips(a: list, b: list) -> list[int]:
    """Per MoE layer, the tokens whose top-k expert sets differ."""
    return [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, y in zip(a, b)]


def serve_family(card, label, cfg, params, prompt, fe, want_flash,
                 warm=True):
    """Phase 6's serving check for one family: `greedy_generate` through
    the kernels (launch counts zeroed just before, read just after) and
    with `use_kernel=False` on the card, the prefill's last logits within
    TOL_SERVE_BF16 · max|logits|, the shared tokens counted, and the
    times. Returns (launches, the encoder's flash launches within them).

    MoE routing is discontinuous: in bf16 the two attention paths'
    rounding moves some tokens across a top-k or capacity boundary, and
    such a token's output changes by O(1), which later layers carry on.
    So for an MoE family the bar holds the kernel path against the plain
    path making the kernel path's routing choices (`moe_routes`); the
    free plain path's routing may differ at the first MoE layer for at
    most TOL_ROUTE_FLIPS of the tokens, and its last logits' error and
    its flips per layer are printed beside it."""
    from repro_torch.serving import cell
    steps = cell.NEW_TOKENS
    if warm:
        generate(params, cfg, prompt, 2, fe)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with encoder_launches([]) as enc:
        out, gen_s, launches = generate(params, cfg, prompt, steps, fe)
    peak = torch.cuda.max_memory_allocated() / 2**30
    serve_checks(f"{label} kernels", cfg, out, prompt, steps, launches,
                 want_flash)
    enc_launches = sum(enc)
    check(enc_launches == (cfg.n_encoder_layers
                           if cfg.arch_type == "encdec" else 0),
          f"{label}: the encoder launched flash {enc_launches} times")
    out_p, gen_p_s, launches_p = generate(params, cfg, prompt, steps, fe,
                                          use_kernel=False)
    serve_checks(f"{label} plain", cfg, out_p, prompt, steps, launches_p, 0)
    with moe_routes([]) as routes_k:
        logits_k, pre_s = prefill_logits(params, cfg, prompt, steps, fe)
    with moe_routes([]) as routes_p:
        logits_p, pre_p_s = prefill_logits(params, cfg, prompt, steps, fe,
                                           use_kernel=False)
    check(bool(torch.isfinite(logits_k).all()),
          f"{label}: prefill logits not finite")
    err, scale = max_err(logits_k, logits_p)
    held = "the plain path"
    if cfg.moe is not None:
        free = err / scale
        with moe_routes(routes_k, replay=True):
            logits_pin, _ = prefill_logits(params, cfg, prompt, steps, fe,
                                           use_kernel=False)
        err, scale = max_err(logits_k, logits_pin)
        flips = route_flips(routes_k, routes_p)
        tokens = routes_k[0].shape[0]
        check(flips[0] <= TOL_ROUTE_FLIPS * tokens, f"{label}: the plain "
              f"path routed {flips[0]} of {tokens} tokens otherwise at the "
              f"first MoE layer > {TOL_ROUTE_FLIPS} of them")
        held = (f"the plain path routed as the kernel path (free: "
                f"{free:.4g} of max|logits|; tokens routed otherwise per "
                f"MoE layer {flips} of {routes_k[0].shape[0]})")
    check(err <= TOL_SERVE_BF16 * scale, f"{label} prefill logits vs "
          f"{held}: err {err} > {TOL_SERVE_BF16} * {scale}")
    b, s = prompt.shape
    shared = int((out[:, s:] == out_p[:, s:]).sum())
    decode_ms = (gen_s - pre_s) / (steps - 1) * 1e3
    gib, count = param_gib(params)
    print(f"phase {label} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}"
          f", {cfg.compute_dtype}, {count / 1e9:.2f} B parameters, "
          f"{gib:.2f} GiB), batch {b}, prompt {s}"
          f"{'' if fe is None else f' + {fe.shape[1]} stub {cfg.frontend}'}"
          f", {steps} new tokens: launches "
          f"{ {k: v for k, v in launches.items() if v} }"
          f"{f' ({enc_launches} in the encoder)' if enc_launches else ''}"
          f"; prefill last "
          f"logits vs {held}: max abs err {err:.4g} = {err / scale:.4g} of "
          f"max|logits| {scale:.4g}; {shared} of {b * steps} generated "
          f"tokens shared with the plain path; generate {gen_s * 1e3:.1f} ms "
          f"(plain {gen_p_s * 1e3:.1f}), prefill {pre_s * 1e3:.1f} ms "
          f"(plain {pre_p_s * 1e3:.1f}), decode {decode_ms:.2f} ms per "
          f"token step, {b * steps / gen_s:.1f} tokens/s; peak "
          f"{peak:.2f} GiB ({base / 2**30:.2f} before) {card}")
    return launches, enc_launches


def f32_copy_check(card, label, cfg, params, prompt, steps, want_flash):
    """An f32 copy: the kernel and plain paths give identical tokens and
    last logits within TOL_FIT · max|logits|. Returns the kernel run's
    flash launches."""
    out, gen_s, launches = generate(params, cfg, prompt, steps)
    serve_checks(f"{label} f32", cfg, out, prompt, steps, launches,
                 want_flash)
    out_p, _, _ = generate(params, cfg, prompt, steps, use_kernel=False)
    check(bool(torch.equal(out, out_p)),
          f"{label} f32: kernel and plain paths gave different tokens")
    with moe_routes([]) as routes_k:
        lk, _ = prefill_logits(params, cfg, prompt, steps)
    with moe_routes([]) as routes_p:
        lp, _ = prefill_logits(params, cfg, prompt, steps, use_kernel=False)
    err, scale = max_err(lk, lp)
    check(err <= TOL_FIT * scale, f"{label} f32 prefill logits: err {err} "
          f"> {TOL_FIT} * {scale}")
    flips = (f"; routing free, tokens routed otherwise per MoE layer "
             f"{route_flips(routes_k, routes_p)} of {routes_k[0].shape[0]}"
             if routes_k else "")
    print(f"phase {label} f32 at {cfg.n_layers} layers (batch "
          f"{prompt.shape[0]}, prompt {prompt.shape[1]}, {steps} new "
          f"tokens): identical tokens on both paths; prefill last logits "
          f"max abs err {err:.3g} (max|logits| {scale:.3g}){flips}; launches "
          f"{launches['flash_attention']} flash; generate "
          f"{gen_s * 1e3:.1f} ms {card}")
    return launches["flash_attention"]


def zoo_phase(dev, card) -> dict:
    """Phase 9: the non-dense families served at full width. Returns the
    flash launches of each phase-9 kernel row's run."""
    from repro_torch.configs import get_config
    from repro_torch.serving import cell
    from repro_torch.substrate import run_probe

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    runs = {}
    # ---- 9a. deepseek-moe-16b, unreduced --------------------------------
    free()
    cfg, params, prompt, fe = zoo_model(ZOO_MOE, dev)
    drop_pre, drop_dec = moe_drop_fractions(params, cfg, prompt)
    b = prompt.shape[0]
    mc = cfg.moe
    c_pre = math.ceil(b * cell.PROMPT * mc.top_k * mc.capacity_factor
                      / mc.n_experts)
    print(f"phase 9a {cfg.name} MoE drop fraction (mean over its "
          f"{cfg.n_layers - mc.first_k_dense} MoE layers): prefill "
          f"{drop_pre:.4f} (C = {c_pre}), decode {drop_dec:.4f} (C = 1 at "
          f"{b} tokens) {card}")
    launches, _ = serve_family(card, f"9a {cfg.name}", cfg, params, prompt,
                               fe, cfg.n_layers, warm=False)
    runs["flash_attention_moe"] = launches["flash_attention"]
    del params
    free()
    cfg32, p32, _, _ = zoo_model(ZOO_MOE, dev, n_layers=ZOO_MOE_F32_LAYERS,
                                 param_dtype="float32",
                                 compute_dtype="float32")
    runs["flash_attention_f32_h128"] = f32_copy_check(
        card, f"9a {cfg.name}", cfg32, p32, prompt[:F32_COPY_BATCH], 8,
        ZOO_MOE_F32_LAYERS)
    del p32

    # ---- 9b. the other families, each after the last one's memory -------
    for arch, cut in ZOO_OTHERS:
        free()
        cfg, params, prompt, fe = zoo_model(arch, dev, **cut)
        n_attn = sum(k in ("attn", "local_attn", "moe")
                     for k in cfg.layer_kinds())
        want = n_attn + (cfg.n_encoder_layers if cfg.arch_type == "encdec"
                         else 0)
        launches, enc_launches = serve_family(
            card, f"9b {cfg.name}" + (f" (cut to {cut['n_layers']} of "
                                      f"{get_config(arch).n_layers} layers)"
                                      if cut else ""),
            cfg, params, prompt, fe, want)
        runs[arch] = launches["flash_attention"]
        if cfg.arch_type == "encdec":
            runs["flash_attention_noncausal"] = enc_launches
        del params
    free()
    cfg, params, prompt, fe = zoo_model(ZOO_SSM, dev)
    t0 = time.perf_counter()
    out, gen_s, launches = generate(params, cfg, prompt, cell.NEW_TOKENS)
    serve_checks(f"9b {cfg.name}", cfg, out, prompt, cell.NEW_TOKENS,
                 launches, 0)
    _, pre_s = prefill_logits(params, cfg, prompt, cell.NEW_TOKENS)
    gib, count = param_gib(params)
    print(f"phase 9b {cfg.name} ({cfg.n_layers} SSD layers, d "
          f"{cfg.d_model}, {cfg.compute_dtype}, {count / 1e9:.2f} B "
          f"parameters, {gib:.2f} GiB), batch {cell.BATCH}, prompt "
          f"{cell.PROMPT}, {cell.NEW_TOKENS} new tokens: no kernel "
          f"launched; "
          f"generate {gen_s * 1e3:.1f} ms, prefill {pre_s * 1e3:.1f} ms, "
          f"decode {(gen_s - pre_s) / (cell.NEW_TOKENS - 1) * 1e3:.2f} ms "
          f"per "
          f"token step {card}")
    del params
    free()
    cfg32, p32, prompt32, _ = zoo_model(ZOO_SSM, dev, n_layers=2,
                                        param_dtype="float32",
                                        compute_dtype="float32")
    prompt32 = prompt32[:1, :256]
    out, _, launches = generate(p32, cfg32, prompt32, 8)
    serve_checks(f"9b {cfg.name} f32", cfg32, out, prompt32, 8, launches, 0)
    lk, _ = prefill_logits(p32, cfg32, prompt32, 8)
    cpu = torch.device("cpu")

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cpu(v) for v in t]
        return t.to(cpu)

    from repro_torch.models import Batch, forward_prefill
    from repro_torch.serving.engine import greedy_generate
    p_cpu = to_cpu(p32)
    out_cpu = greedy_generate(p_cpu, cfg32, prompt32.cpu(), steps=8)
    lc, _ = forward_prefill(p_cpu, cfg32, Batch(tokens=prompt32.cpu()),
                            cache_len=256 + 8)
    check(bool(torch.equal(out.cpu(), out_cpu)),
          f"9b {cfg.name} f32: the card's tokens differ from the CPU's")
    err, scale = max_err(lk.cpu(), lc.float())
    check(err <= TOL_FIT * scale, f"9b {cfg.name} f32 prefill logits vs "
          f"the CPU: err {err} > {TOL_FIT} * {scale}")
    print(f"phase 9b {cfg.name} f32 at 2 layers (batch 1, prompt 256, 8 "
          f"new tokens): the card's tokens are the CPU's; prefill last "
          f"logits max abs err {err:.3g} (max|logits| {scale:.3g}) {card}")
    del p32, p_cpu
    free()

    # ---- 9c. moe_apply_a2a on 4 gloo ranks ------------------------------
    t0 = time.perf_counter()
    run = run_probe(A2A_PROGRAM.replace("@ARCH@", ZOO_MOE).replace(
        "@TOKENS@", str(A2A_TOKENS)), world=4, timeout=300, pg_timeout=120)
    wall = time.perf_counter() - t0
    check(run.ok, f"phase 9c ranks failed:\n{run.report()}")
    lines = []
    for i, r in enumerate(run.ranks):
        found = [ln for ln in r.stdout.splitlines() if ln.startswith("RANK9 ")]
        check(len(found) == 1, f"9c rank {i}: no result line:\n{r.stdout}")
        line = json.loads(found[0][len("RANK9 "):])
        check(line["err"] <= TOL_KERNEL * line["scale"], f"9c rank {i}: "
              f"err {line['err']} > {TOL_KERNEL} * {line['scale']}")
        check(line["calls"] == {"all_to_all_single": 2} and
              line["ledger"] == [2, 2], f"9c rank {i}: collectives "
              f"{line['calls']}, ledger {line['ledger']}")
        lines.append(line)
    print(f"phase 9c moe_apply_a2a on a 2 x 2 data x model mesh of gloo "
          f"ranks on the one card ({ZOO_MOE}'s widths, 32 experts a rank, "
          f"f32, capacity_factor 8, {2 * A2A_TOKENS} tokens a data rank, "
          f"C_loc {lines[0]['C']}): each rank within "
          f"{max(ln['err'] / ln['scale'] for ln in lines):.3g} of max|.| of "
          f"moe_apply on the whole batch; one all_to_all_experts out and one "
          f"back, no other collective; the layer "
          f"{[round(ln['wall_ms'], 1) for ln in lines]} ms, one "
          f"all-to-all of {lines[0]['a2a_mib']:.0f} MiB a rank "
          f"{[round(ln['a2a_ms'], 1) for ln in lines]} ms; the whole run "
          f"{wall:.1f} s {card}")
    # the seamless encoder's launches, counted on their own; its
    # decoder's causal ones run the H = 64 body of row flash_attention
    return {"flash_attention_moe": runs["flash_attention_moe"],
            "flash_attention_vlm": runs["internvl2-2b"],
            "flash_attention_h256": runs["recurrentgemma-9b"],
            "flash_attention_noncausal": runs["flash_attention_noncausal"],
            "flash_attention_f32_h128": runs["flash_attention_f32_h128"]}


def flash_backward_times(shape, qkv, card, causal: bool = True) -> dict:
    """The training attention's backward at `shape` (B, S, N, K, H),
    causal or not: the plain blockwise backward as the training path runs it
    after the kernel (`flash_attention_bwd` from the kernel's out and lse,
    scores in f32) and SDPA's backward (`torch.autograd.grad` through its forward),
    by CUDA events, beside their bound (5 products of the pairs the mask
    keeps, 2.5 x the forward's; q, k, v, out, dout and lse read, dq, dk, dv
    written)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.timing import time_ms
    from repro_torch.models import attention_core as ac
    fb, fs, fn, fk, fh = shape
    q, k, v = qkv
    gen = torch.Generator(device=q.device).manual_seed(3)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    out, lse = flash_ops.flash_attention_fwd_lse(q, k, v, causal=causal)
    plain_ms = time_ms(lambda: ac.flash_attention_bwd(
        q, k, v, out, lse, dout, causal=causal, window=0, scores_f32=True),
        reps=5, warm=1)
    req = [t.transpose(1, 2).detach().requires_grad_() for t in qkv]
    o = torch.nn.functional.scaled_dot_product_attention(
        *req, is_causal=causal, enable_gqa=True)
    d_t = dout.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, req, d_t,
                                                 retain_graph=True))
    pairs = fb * fn * flash_pairs(fs, causal, 0)
    elems = fb * fs * fh
    bwd_bound, how = bound(2.5 * 4 * pairs * fh,
                           2 * (3 * fn * elems + 2 * fk * elems)
                           + 4 * fb * fn * fs + 2 * (fn + 2 * fk) * elems,
                           PEAK_BF16_FLOPS)
    print(f"time flash backward at {shape} bf16 causal={causal}: plain "
          f"blockwise "
          f"{plain_ms:.4f} ms, SDPA's backward {lib_ms:.4f} ms, bound "
          f"{bwd_bound:.4f} ms ({how}) {card}")
    return {"plain_bwd_ms": plain_ms, "library_bwd_ms": lib_ms,
            "bwd_bound_ms": bwd_bound}


def train_forward_flops(cfg, b: int, s: int) -> float:
    """A forward pass over b sequences of s tokens, for the dense, VLM,
    enc-dec and SSD stacks (not the MoE's): 2 flops a weight a position
    for every weight a product applies (a layer's over the decoder's
    positions, the VLM's patches included; the encoder's, and the cross
    attention's k and v, over the frames; the head over the tokens; the
    SSD block's depthwise conv too), 4 H flops a visible (query, key)
    pair a head for each attention (causal self attention, the encoder's
    and the cross attention's over every frame), and the SSD block's
    chunked scan, 2 Q (N + P) + 4 N P a position a head (chunk Q, state
    N, head dim P: the intra-chunk scores and output, the chunk states
    and the inter-chunk output)."""
    from repro_torch.models.backbone import _stack_kinds
    from repro_torch.tree import named_leaves
    frames = cfg.n_frontend_tokens if cfg.arch_type == "encdec" else 0
    s_dec = s + (cfg.n_frontend_tokens if cfg.arch_type == "vlm" else 0)
    leaves = named_leaves(init_params_shapes(cfg))
    weights = 0
    for name, t in leaves.items():
        if t.ndim < 2 or (name == "embed" and "head" in leaves):
            continue
        if name in ("embed", "head"):
            positions = s
        elif name.startswith("encoder/") or name.endswith(
                ("/cross/wk", "/cross/wv")):
            positions = frames
        else:
            positions = s_dec
        weights += t.numel() * positions
    n, h = cfg.n_heads, cfg.resolved_head_dim
    kinds = _stack_kinds(cfg)
    n_attn = sum(k in ("attn", "local_attn") for k in kinds)
    attn = n_attn * 4 * b * n * flash_pairs(s_dec, True, cfg.window) * h
    if frames:
        attn += 4 * b * n * h * (cfg.n_encoder_layers * frames * frames
                                 + n_attn * s * frames)
    scan = 0
    if cfg.ssd is not None:
        sc = cfg.ssd
        scan = sum(k == "ssd" for k in kinds) * b * s * sc.n_heads * (
            2 * sc.chunk * (sc.state_dim + sc.head_dim)
            + 4 * sc.state_dim * sc.head_dim)
    return 2 * b * weights + attn + scan


def train_profile(prof, wall_s: float) -> dict:
    """A profiled train step's device time (ms): busy (the union of its
    kernels' intervals), idle share, and by part: #9's forward
    (`flash_fwd`), the plain attention backward and the optimizer (the
    kernels inside the device's spans of the `attention_core._flash_bwd`
    and `optim.adamw_update` ranges), GEMMs (by name) and the rest
    (elementwise passes, norms, casts, copies)."""
    from repro_torch.launch.profile_serve import _group
    events = prof.events()
    ranges = ("attention_core._flash_bwd", "optim.adamw_update")
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in ranges]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(b - a for a, b in spans)
    parts = dict.fromkeys(("flash #9 forward", "plain attention backward",
                           "optimizer", "GEMMs", "elementwise and other"),
                          0.0)
    # each kernel once, from the device's timeline: #9 by its name, the
    # kernels inside a range's span on the device (the profiler draws
    # each `record_function` range there too) to that range, the rest
    # by name
    marks = {r: sorted((e.time_range.start, e.time_range.end)
                       for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.name == r) for r in ranges}

    def inside(r, a, b):
        i = bisect.bisect_right(marks[r], (a, float("inf"))) - 1
        return i >= 0 and marks[r][i][0] <= a and b <= marks[r][i][1]

    by_name: dict = {}
    for e in dev_events:
        a, b = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        if "flash_fwd" in e.name:
            parts["flash #9 forward"] += b - a
        elif inside(ranges[0], a, b):
            parts["plain attention backward"] += b - a
        elif inside(ranges[1], a, b):
            parts["optimizer"] += b - a
        elif _group(e.name) == "matrix products":
            parts["GEMMs"] += b - a
        else:
            parts["elementwise and other"] += b - a
    out = {"wall_ms": wall_s * 1e3, "busy_ms": busy / 1e3,
           "idle_share": max(0.0, 1 - busy / (wall_s * 1e6)),
           "kernels": len(dev_events), "kernel_ms": total / 1e3,
           "spans": {r: len(m) for r, m in marks.items()},
           "top": [(name[:90], us / 1e3) for name, us in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:10]]}
    out.update({k: v / 1e3 for k, v in parts.items()})
    return out


def free_card() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_batch(cfg, dev, batch: int = TRAIN_BATCH):
    """One batch of `synthetic_lm_batches` from TRAIN_BATCH_SEED: `batch`
    sequences of TRAIN_SEQ tokens, and the stub frontend (the VLM's
    patches, the enc-dec's frames: (batch, n_frontend_tokens, d_model))
    where `cfg` has one."""
    from repro_torch.data.synth_tokens import synthetic_lm_batches
    gen = torch.Generator(device=dev).manual_seed(TRAIN_BATCH_SEED)
    fe = (cfg.n_frontend_tokens, cfg.d_model) if cfg.frontend else None
    return next(synthetic_lm_batches(gen, vocab=cfg.vocab, batch=batch,
                                     seq=TRAIN_SEQ, frontend_shape=fe))


def grads_on(cfg, params, batch, use_kernel):
    """make_grad_fn's (loss, gradients) with remat, the launch counts
    zeroed just before and read just after, and the wall time."""
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.training.step import make_grad_fn
    fn = make_grad_fn(cfg, remat=True, use_kernel=use_kernel)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    loss, _, grads = fn(params, batch)
    torch.cuda.synchronize()
    return loss, grads, dict(LAUNCHES), time.perf_counter() - t0


def worst_leaf_of(gk, gp):
    """The worst leaf's relative l2 error of `gk` against `gp`, and its
    name."""
    from repro_torch.tree import named_leaves, tree_leaves
    worst, name = 0.0, "?"
    for (leaf, a), b in zip(named_leaves(gk).items(), tree_leaves(gp)):
        rel = rel_l2(a, b)
        if rel >= worst:
            worst, name = rel, leaf
    return worst, name


def want_launches(n: int) -> dict:
    """Every kernel's count 0 but flash_attention's, `n`."""
    from repro_torch.kernels.common import LAUNCHES
    want = dict.fromkeys(LAUNCHES, 0)
    want["flash_attention"] = n
    return want


def train_phase(dev, card, save_dir) -> dict:
    """Phase 10: training. 10a granite-3-2b unreduced in bf16 (loss and
    gradient on both paths, 8 steps, the step's time, a profile); 10b an
    f32 copy at 4 layers. Returns the flash launches of 10a's kernel
    loss-and-gradient run and the numbers the JSON line carries; writes
    what phase 11a compares with to `save_dir`/ref10a.pt: the kernel
    path's loss, its global gradient norm and the gradients of
    `SHARDED_LEAVES`."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamWState, adamw_update, global_norm
    from repro_torch.serving import cell
    from repro_torch.training.step import (
        TrainState, init_train_state, make_train_step,
    )
    from repro_torch.tree import named_leaves, tree_leaves, tree_map
    from torch.profiler import ProfilerActivity, profile

    free_card()
    out = {}
    # ---- 10a. granite-3-2b unreduced, bf16 --------------------------------
    cfg = get_config(cell.ARCH)
    base = torch.cuda.memory_allocated()
    # the parameters init_train_state draws from this seed, first without
    # their AdamW state (37 GB), which leaves room for the f32 control
    params = init_params(
        torch.Generator(device=dev).manual_seed(cell.PARAM_SEED), cfg)
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = train_batch(cfg, dev)
    tokens = batch.tokens.numel()
    loss_k, grads_k, launches_k, wall_k = grads_on(cfg, params, batch, None)
    check(launches_k == want_launches(2 * cfg.n_layers),
          f"10a kernel path launches {launches_k}, expected flash_attention="
          f"{2 * cfg.n_layers} (forward and recompute) and nothing else")
    loss_p, grads_p, launches_p, wall_p = grads_on(cfg, params, batch, False)
    check(launches_p == want_launches(0),
          f"10a plain path launches {launches_p}")
    gn_k, gn_p = global_norm(grads_k).item(), global_norm(grads_p).item()
    lk, lp = loss_k.item(), loss_p.item()
    check(math.isfinite(lk) and math.isfinite(gn_k) and gn_k > 0,
          f"10a loss {lk}, grad_norm {gn_k}")
    worst, worst_leaf = worst_leaf_of(grads_k, grads_p)
    # the control: the same loss's gradient in f32 at the same (bf16)
    # weights on the plain path, from which each bf16 path's gradient
    # is off by its own rounding
    cfg_f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    loss_32, grads_32, _, _ = grads_on(
        cfg_f32, tree_map(lambda p: p.float(), params), batch, False)
    l32 = loss_32.item()
    worst_k32, leaf_k32 = worst_leaf_of(grads_k, grads_32)
    worst_p32, leaf_p32 = worst_leaf_of(grads_p, grads_32)
    print(f"phase 10a {cfg.name} unreduced ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters, bf16), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat: "
          f"loss kernel {lk:.6f} plain {lp:.6f} (rel {abs(lk - lp) / abs(lp):.3g}, "
          f"bar {TOL_TRAIN_LOSS}); grad_norm kernel {gn_k:.6g} plain "
          f"{gn_p:.6g} (rel {abs(gn_k - gn_p) / gn_p:.3g}, bar "
          f"{TOL_TRAIN_GNORM}); worst leaf relative l2 {worst:.4g} at "
          f"{worst_leaf} (bar {TOL_TRAIN_GRAD}); flash launches "
          f"{launches_k['flash_attention']} / {launches_p['flash_attention']}; "
          f"loss-and-grad wall {wall_k * 1e3:.1f} ms (plain "
          f"{wall_p * 1e3:.1f}) {card}")
    print(f"phase 10a f32 control (the same weights upcast, plain path): "
          f"loss {l32:.6f} (kernel rel {abs(lk - l32) / abs(l32):.3g}, plain "
          f"rel {abs(lp - l32) / abs(l32):.3g}); worst leaf relative l2 "
          f"against the f32 gradient: kernel path {worst_k32:.4g} at "
          f"{leaf_k32}, plain path {worst_p32:.4g} at {leaf_p32} {card}")
    check(abs(lk - lp) <= TOL_TRAIN_LOSS * abs(lp),
          f"10a loss: kernel {lk} vs plain {lp}")
    check(abs(gn_k - gn_p) <= TOL_TRAIN_GNORM * gn_p,
          f"10a grad_norm: kernel {gn_k} vs plain {gn_p}")
    check(worst <= TOL_TRAIN_GRAD, f"10a gradient {worst_leaf}: relative "
          f"l2 error {worst} > {TOL_TRAIN_GRAD}")
    check(worst_k32 <= TOL_TRAIN_GRAD_F32 * worst_p32,
          f"10a the kernel path's gradient is {worst_k32} off the f32 "
          f"gradient at {leaf_k32}, the plain path's {worst_p32}")
    out["launches"] = launches_k["flash_attention"]
    torch.save({"loss": lk, "gnorm": gn_k,
                "grads": {name: g.cpu() for name, g in named_leaves(grads_k)
                          .items() if sharded_leaf(name, cfg)}},
               f"{save_dir}/ref10a.pt")
    del params, grads_k, grads_p, grads_32
    free_card()

    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(
        torch.Generator(device=dev).manual_seed(cell.PARAM_SEED), cfg)
    state_gib = (torch.cuda.memory_allocated() - base) / 2**30
    print(f"phase 10a train state (bf16 parameters, f32 master and "
          f"moments): {state_gib:.2f} GiB")
    step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup=1, total_steps=100)
    losses, norms, walls = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        walls.append(time.perf_counter() - t0)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(all(math.isfinite(x) for x in losses + norms),
          f"10a losses {losses}, grad norms {norms}")
    check(losses[-1] < losses[0], f"10a the loss did not fall: {losses}")
    step_s = sum(walls[1:]) / len(walls[1:])
    fwd = train_forward_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    mfu, hfu = (3 * fwd / step_s / PEAK_BF16_FLOPS,
                4 * fwd / step_s / PEAK_BF16_FLOPS)
    print(f"phase 10a {TRAIN_STEPS} steps of make_train_step on one batch "
          f"(peak_lr {TRAIN_LR}, warmup 1): losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]} {card}")
    print(f"phase 10a step wall {step_s * 1e3:.1f} ms (mean of steps 2-"
          f"{TRAIN_STEPS}; all {[round(w * 1e3, 1) for w in walls]}), "
          f"{tokens / step_s:.0f} tokens/s; model FLOPs 3 x forward "
          f"{3 * fwd / 1e12:.1f} TFLOP a step ({mfu:.4f} of the bf16 "
          f"peak), with the recompute 4 x {4 * fwd / 1e12:.1f} TFLOP "
          f"({hfu:.4f}); peak memory {peak_gib:.2f} GiB (state included), "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB with what "
          f"earlier phases hold {card}")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rep = train_profile(prof, wall)
    del prof
    print(f"phase 10a profile of one step: wall {rep['wall_ms']:.1f} ms, "
          f"device busy {rep['busy_ms']:.1f} ms (idle share "
          f"{rep['idle_share']:.4f}), {rep['kernels']} kernels, kernel time "
          f"{rep['kernel_ms']:.1f} ms (range spans on the device: "
          f"{rep['spans']}); by part: " + ", ".join(
              f"{k} {rep[k]:.1f} ms" for k in (
                  "GEMMs", "flash #9 forward", "plain attention backward",
                  "elementwise and other", "optimizer")) + f" {card}")
    for name, ms in rep["top"]:
        print(f"    {ms:9.3f} ms  {name}")
    out.update(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
               peak_gib=peak_gib, mfu=mfu, losses=losses, profile=rep)
    del state, m
    free_card()

    # ---- 10b. an f32 copy at 4 layers -------------------------------------
    cfg32 = cfg.replace(n_layers=TRAIN_F32_LAYERS, param_dtype="float32",
                        compute_dtype="float32")
    s32 = init_train_state(
        torch.Generator(device=dev).manual_seed(cell.PARAM_SEED), cfg32)
    b32 = train_batch(cfg32, dev)
    l32k, g32k, launches32, _ = grads_on(cfg32, s32.params, b32, None)
    check(launches32 == want_launches(2 * TRAIN_F32_LAYERS),
          f"10b kernel path launches {launches32}")
    l32p, g32p, _, _ = grads_on(cfg32, s32.params, b32, False)
    rel = abs(l32k.item() - l32p.item()) / abs(l32p.item())
    check(rel <= TOL_KERNEL, f"10b loss: kernel {l32k.item()} vs plain "
          f"{l32p.item()}")
    worst32 = 0.0
    for a, b in zip(tree_leaves(g32k), tree_leaves(g32p)):
        err, scale = max_err(a, b)
        check(err <= TOL_FIT * scale, f"10b a gradient leaf {tuple(a.shape)}"
              f": err {err} > {TOL_FIT} * {scale}")
        worst32 = max(worst32, err / max(scale, 1e-30))
    # one update of two copies of the state with the same gradients
    copies = [TrainState(tree_map(torch.clone, s32.params),
                         AdamWState(*(tree_map(torch.clone, t)
                                      for t in s32.opt[:3]), s32.opt.count),
                         s32.step) for _ in range(2)]
    lr = torch.tensor(TRAIN_LR, device=dev)
    done = [adamw_update(g32k, c.opt, c.params, lr=lr) for c in copies]
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves([done[0][0], *done[0][1][:3]]),
        tree_leaves([done[1][0], *done[1][1][:3]])))
    check(same, "10b adamw_update gave other bits on a copy of the state")
    print(f"phase 10b {cfg.name} f32 at {TRAIN_F32_LAYERS} layers (batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}): flash launches "
          f"{launches32['flash_attention']}; loss kernel {l32k.item():.7f} "
          f"plain {l32p.item():.7f} (rel {rel:.3g}, bar {TOL_KERNEL}); worst "
          f"gradient leaf {worst32:.3g} of max|g| (bar {TOL_FIT}); "
          f"adamw_update on two copies: the same bits {card}")
    out["launches_f32"] = launches32["flash_attention"]
    del s32, g32k, g32p, copies, done
    free_card()
    return out


def train10c_flash_shapes() -> dict:
    """{row: (shape, causal)}: #9 with its lse at the (B, S, N, K, H) of
    phase 10c's loss-and-gradient runs (TRAIN_BATCH): internvl2-2b's over
    its patches and tokens, seamless-m4t-medium's encoder over its frames
    (not causal) and its decoder, and minitron-4b's."""
    from repro_torch.configs import get_config

    def shape(arch, s):
        c = get_config(arch)
        return (TRAIN_BATCH, s, c.n_heads, c.n_kv_heads, c.resolved_head_dim)

    vlm = get_config("internvl2-2b")
    audio = get_config("seamless-m4t-medium")
    return {
        "flash_attention_lse_vlm": (
            shape(vlm.name, TRAIN_SEQ + vlm.n_frontend_tokens), True),
        "flash_attention_lse_noncausal": (
            shape(audio.name, audio.n_frontend_tokens), False),
        "flash_attention_lse_audio_dec": (shape(audio.name, TRAIN_SEQ), True),
        "flash_attention_lse_h128": (shape("minitron-4b", TRAIN_SEQ), True),
    }


def train_family(label, arch, step_batch, dev, card) -> dict:
    """One run of phase 10c: `arch` unreduced in bf16 from 10a's seeds.
    The loss and gradient with remat on the kernel path (#9 exactly
    `flash_launches` times, the encoder's launches counted on their own,
    nothing else) and on the plain path (no launch), held to each other
    by 10a's loss and norm bars and each leaf by TOL_TRAIN_GRAD or
    ZOO12_NOISE times the plain path's distance from the f32 control (the
    same weights upcast, the plain path, computed with the two bf16
    gradients moved to the host); then the AdamW state and
    TRAIN10C_STEPS steps at `step_batch` x TRAIN_SEQ, every loss finite
    and the last below the first, and one more step under the profiler.
    Returns #9's launches of the kernel run (all, and the encoder's) and
    the step's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import global_norm
    from repro_torch.serving import cell
    from repro_torch.training.step import init_train_state, make_train_step
    from repro_torch.tree import named_leaves, tree_map
    from torch.profiler import ProfilerActivity, profile

    t_run = time.perf_counter()
    free_card()
    cfg = get_config(arch)
    base = torch.cuda.memory_allocated()
    params = init_params(
        torch.Generator(device=dev).manual_seed(cell.PARAM_SEED), cfg)
    n_params = sum(t.numel() for t in named_leaves(params).values())
    batch = train_batch(cfg, dev)
    want = flash_launches(cfg)
    n_enc = cfg.n_encoder_layers if cfg.arch_type == "encdec" else 0
    enc: list = []
    torch.cuda.reset_peak_memory_stats()
    with encoder_launches(enc):
        loss_k, grads_k, launches_k, wall_k = grads_on(cfg, params, batch,
                                                       None)
    peak_k = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(launches_k == want_launches(want) and
          enc == ([n_enc] if n_enc else []),
          f"{label} kernel path launches {launches_k}, the encoder's {enc}: "
          f"expected flash_attention={want} (the encoder's {n_enc} once, "
          f"each decoder layer's forward and recompute) and nothing else")
    loss_p, grads_p, launches_p, wall_p = grads_on(cfg, params, batch, False)
    check(launches_p == want_launches(0),
          f"{label} plain path launches {launches_p}")
    lk, lp = loss_k.item(), loss_p.item()
    gn_k, gn_p = global_norm(grads_k).item(), global_norm(grads_p).item()
    check(math.isfinite(lk) and math.isfinite(gn_k) and gn_k > 0,
          f"{label} loss {lk}, grad_norm {gn_k}")
    flat_k, flat_p = named_leaves(grads_k), named_leaves(grads_p)
    kp = {n: rel_l2(flat_k[n], flat_p[n]) for n in flat_k}
    # the f32 control needs the room: the bf16 gradients wait on the host
    t0 = time.perf_counter()
    host_k = {n: t.cpu() for n, t in flat_k.items()}
    host_p = {n: t.cpu() for n, t in flat_p.items()}
    host_s = time.perf_counter() - t0
    del grads_k, grads_p, flat_k, flat_p
    params = tree_map(lambda t: t.float(), params)
    free_card()
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    loss_32, g32, _, wall_32 = grads_on(cfg32, params, batch, False)
    del params
    g32 = named_leaves(g32)
    l32 = loss_32.item()
    noise = {n: rel_l2(host_p[n].to(dev), g) for n, g in g32.items()}
    k32 = {n: rel_l2(host_k[n].to(dev), g) for n, g in g32.items()}
    del g32, host_k, host_p
    bars = {n: max(TOL_TRAIN_GRAD, ZOO12_NOISE * noise[n]) for n in kp}
    near = max(kp, key=lambda n: kp[n] / bars[n])
    worst_k32, worst_p32 = max(k32, key=k32.get), max(noise, key=noise.get)
    enc_note = (f" ({enc[0]} in the encoder, once: it runs outside the "
                f"checkpoints)" if n_enc else "")
    print(f"phase {label} {cfg.name} unreduced ({cfg.n_layers} layers"
          + (f" and {n_enc} encoder layers" if n_enc else "") +
          f", d {cfg.d_model}, {n_params / 1e9:.3f} B parameters, bf16), "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}"
          + (f" with {cfg.n_frontend_tokens} {cfg.frontend} positions a "
             f"sequence" if cfg.frontend else "") +
          f", remat: loss kernel {lk:.6f} plain {lp:.6f} (rel "
          f"{abs(lk - lp) / abs(lp):.3g}, bar {TOL_TRAIN_LOSS}); grad_norm "
          f"kernel {gn_k:.6g} plain {gn_p:.6g} (rel "
          f"{abs(gn_k - gn_p) / gn_p:.3g}, bar {TOL_TRAIN_GNORM}); the leaf "
          f"nearest its bar of {len(kp)}: {near} relative l2 {kp[near]:.4g}, "
          f"bar {bars[near]:.4g} (the larger of {TOL_TRAIN_GRAD} and "
          f"{ZOO12_NOISE} x the plain path's {noise[near]:.4g} off the f32 "
          f"control), the worst leaf {max(kp.values()):.4g}; flash launches "
          f"{launches_k['flash_attention']}{enc_note} / "
          f"{launches_p['flash_attention']}"
          + ("" if want else " (no kernel on this family's path)") +
          f"; loss-and-grad wall {wall_k * 1e3:.1f} ms (plain "
          f"{wall_p * 1e3:.1f}), peak {peak_k:.2f} GiB {card}")
    print(f"phase {label} f32 control (the same weights upcast, plain path, "
          f"{wall_32 * 1e3:.1f} ms; the bf16 gradients moved to the host in "
          f"{host_s:.1f} s): loss {l32:.6f} (kernel rel "
          f"{abs(lk - l32) / abs(l32):.3g}, plain rel "
          f"{abs(lp - l32) / abs(l32):.3g}); the worst leaf off the f32 "
          f"gradient: kernel path {k32[worst_k32]:.4g} at {worst_k32}, plain "
          f"path {noise[worst_p32]:.4g} at {worst_p32} {card}")
    check(abs(lk - lp) <= TOL_TRAIN_LOSS * abs(lp),
          f"{label} loss: kernel {lk} vs plain {lp}")
    check(abs(gn_k - gn_p) <= TOL_TRAIN_GNORM * gn_p,
          f"{label} grad_norm: kernel {gn_k} vs plain {gn_p}")
    check(kp[near] <= bars[near], f"{label} gradient {near}: relative l2 "
          f"error {kp[near]} > {bars[near]}")
    free_card()

    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(
        torch.Generator(device=dev).manual_seed(cell.PARAM_SEED), cfg)
    state_gib = (torch.cuda.memory_allocated() - base) / 2**30
    if step_batch != TRAIN_BATCH:
        batch = train_batch(cfg, dev, step_batch)
    tokens = batch.tokens.numel()
    step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup=1, total_steps=100)
    losses, norms, walls = [], [], []
    for _ in range(TRAIN10C_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        walls.append(time.perf_counter() - t0)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(all(math.isfinite(x) for x in losses + norms),
          f"{label} losses {losses}, grad norms {norms}")
    check(losses[-1] < losses[0], f"{label} the loss did not fall: {losses}")
    step_s = sum(walls[1:]) / len(walls[1:])
    fwd = train_forward_flops(cfg, step_batch, TRAIN_SEQ)
    mfu = 3 * fwd / step_s / PEAK_BF16_FLOPS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rep = train_profile(prof, wall)
    idle = max(0.0, 1 - rep["busy_ms"] / (step_s * 1e3))
    del prof, state, m, batch
    cut = "" if step_batch == TRAIN_BATCH else \
        f" (the batch cut from {TRAIN_BATCH}: the state and the logits)"
    print(f"phase {label} train state {state_gib:.2f} GiB; "
          f"{TRAIN10C_STEPS} steps of make_train_step at batch {step_batch}"
          f" x {TRAIN_SEQ}{cut} (peak_lr {TRAIN_LR}, warmup 1): losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}; step wall {step_s * 1e3:.1f} ms "
          f"(mean of steps 2-{TRAIN10C_STEPS}; all "
          f"{[round(w * 1e3, 1) for w in walls]}), {tokens / step_s:.0f} "
          f"tokens/s; model FLOPs 3 x forward {3 * fwd / 1e12:.1f} TFLOP a "
          f"step ({mfu:.4f} of the bf16 peak); peak memory {peak_gib:.2f} "
          f"GiB (state included) {card}")
    print(f"phase {label} profile of one step: wall {rep['wall_ms']:.1f} ms,"
          f" device busy {rep['busy_ms']:.1f} ms, idle share "
          f"{rep['idle_share']:.4f} of its wall and {idle:.4f} of the "
          f"unprofiled steps' (the profiler's own host cost is in the "
          f"first), {rep['kernels']} kernels; by part: "
          + ", ".join(f"{k} {rep[k]:.1f} ms" for k in (
              "GEMMs", "flash #9 forward", "plain attention backward",
              "elementwise and other", "optimizer")) +
          f"; {time.perf_counter() - t_run:.1f} s for the run {card}")
    free_card()
    return {"launches": launches_k["flash_attention"],
            "encoder": enc[0] if enc else 0, "step_ms": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "mfu": mfu,
            "peak_gib": peak_gib, "idle_share": idle,
            "losses": losses}


def train_family_phase(dev, card) -> dict:
    """Phase 10c: each run of TRAIN10C by `train_family`, after the last
    one's memory is freed. Returns #9's launches by row of
    `train10c_flash_shapes`."""
    runs = {arch: train_family(label, arch, batch, dev, card)
            for label, arch, batch in TRAIN10C}
    audio = runs["seamless-m4t-medium"]
    return {"flash_attention_lse_vlm": runs["internvl2-2b"]["launches"],
            "flash_attention_lse_noncausal": audio["encoder"],
            "flash_attention_lse_audio_dec":
                audio["launches"] - audio["encoder"],
            "flash_attention_lse_h128": runs["minitron-4b"]["launches"]}


def sharded_leaf(name: str, cfg) -> bool:
    """The leaves phase 11a holds to 10a: layer 0's, the last layer's,
    the embedding, the head and the final norm."""
    return name.startswith(("layers/0/", f"layers/{cfg.n_layers - 1}/")) \
        or name in ("embed", "head", "final_norm")


TRAIN11_PROGRAM = r"""
import json, logging, math, sys, time
import numpy as np
import torch
import torch.distributed as dist
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
from repro_torch.checkpoint.io import restore_pytree
from repro_torch.data.synth_tokens import synthetic_lm_batches
from repro_torch.kernels import _build
from repro_torch.kernels.common import LAUNCHES, reset_launches
from repro_torch.launch.hlo import Counters
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.optim.adamw import global_norm
from repro_torch.sharding.place import distribute_tree, full
from repro_torch.sharding.rules import (
    NamedSharding, batch_pspecs, logits_pspec, named, opt_pspecs,
    param_pspecs,
)
from repro_torch.substrate import init_from_env
from repro_torch.training.step import (
    init_sharded_train_state, init_train_state, make_grad_fn,
    make_train_step,
)
from repro_torch.tree import named_leaves

spec = json.load(open("@SPEC@"))
dev = torch.device("cuda")
rank, world = init_from_env(device=dev)
_build.build()
out = dict(rank=rank, world=world, compiled=sorted(_build.BUILD_SECONDS),
           device=torch.cuda.current_device())
mesh = make_host_mesh(spec["model"], device_type="cuda")
sys.path.insert(0, spec["root"])
from chip_smoke import config_of, moe_drops, moe_routes, rel_l2, route_flips


# the seed's batch of n rows, placed on the mesh; the logits' spec
def placed_batch(cfg, n):
    batch = next(synthetic_lm_batches(
        torch.Generator(device=dev).manual_seed(spec["batch_seed"]),
        vocab=cfg.vocab, batch=n, seq=spec["seq"]))
    return (distribute_tree(batch, batch_pspecs(mesh, n), mesh),
            NamedSharding(mesh, logits_pspec(mesh, cfg.padded_vocab,
                                             spec["seq"])))


cfg = config_of(spec["arch"], spec["changes"])
sb, lp = placed_batch(cfg, spec["batch"])


def gen():
    return torch.Generator(device=dev).manual_seed(spec["param_seed"])


def make_step(state, cfg=cfg, lp=lp):
    return make_train_step(
        cfg, peak_lr=spec["lr"], warmup=1, total_steps=100,
        logits_pspec=lp,
        grads_pspec=named(mesh, opt_pspecs(state.params, mesh)))


# n steps of `step` from `state` on `sb`, the first within the context
# `first`: the losses, norms, walls (ms), the last step's collectives by
# kind and by op, and the peak memory
def timed_steps(step, state, sb, n, first=None):
    torch.cuda.reset_peak_memory_stats()
    losses, norms, walls = [], [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == n - 1:
            with Counters() as c:
                state, m = step(state, sb)
        elif i == 0 and first is not None:
            with first:
                state, m = step(state, sb)
        else:
            state, m = step(state, sb)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return state, dict(
        losses=losses, norms=norms, walls_ms=walls, calls=c.calls(),
        bytes=c.collectives(), ops=c.ops(),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)


if spec["phase"] == "11a":
    params = init_params(gen(), cfg)
    sp = distribute_tree(params, param_pspecs(params, mesh), mesh)
    del params
    grad_fn = make_grad_fn(cfg, remat=True, logits_pspec=lp)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    loss, _, grads = grad_fn(sp, sb)
    torch.cuda.synchronize()
    out["grad_wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = dict(LAUNCHES)
    out["loss"], out["gnorm"] = loss.item(), global_norm(grads).item()
    ref = torch.load(spec["ref10a"]) if rank == 0 else None
    worst, worst_leaf = 0.0, "?"
    for name, g in named_leaves(grads).items():
        if name in spec["leaves"]:
            g = full(g)
            if rank == 0:
                r = rel_l2(g, ref["grads"][name].to(dev))
                if r >= worst:
                    worst, worst_leaf = r, name
    out["worst"], out["worst_leaf"] = worst, worst_leaf
    if rank == 0:
        out["ref_loss"], out["ref_gnorm"] = ref["loss"], ref["gnorm"]
    del grads, sp, ref
    torch.cuda.empty_cache()

    state = init_sharded_train_state(gen(), cfg, mesh)
    state, got = timed_steps(make_step(state), state, sb, spec["steps"])
    out.update(got)
    del state
    torch.cuda.empty_cache()
    # one activation all-reduce alone: the (batch, seq, d) bf16 residual
    # stream every tensor-parallel block sums over `model`
    x = torch.randn((spec["batch"], spec["seq"], cfg.d_model), device=dev
                    ).to(torch.bfloat16)
    group = mesh.get_group("model")
    dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        dist.all_reduce(x, group=group)
    e1.record()
    torch.cuda.synchronize()
    out["allreduce_ms"] = e0.elapsed_time(e1) / 5
    out["allreduce_bytes"] = x.numel() * x.element_size()

# 12e: rank 0 takes the unsharded f32 step itself, from the seed's state,
# before its sharded state exists (the others wait in their first
# collective): its gradient and new master by name, as 11b's files hold
# them, on the host; its metrics into `out`
def unsharded_step():
    ustate = init_train_state(gen(), cfg)
    batch = next(synthetic_lm_batches(
        torch.Generator(device=dev).manual_seed(spec["batch_seed"]),
        vocab=cfg.vocab, batch=spec["batch"], seq=spec["seq"]))
    drops = []
    with moe_drops(drops):
        _, _, g = make_grad_fn(cfg, remat=True)(ustate.params, batch)
    ref = {f"grad/{n}": x.cpu() for n, x in named_leaves(g).items()}
    del g
    reset_launches()
    ustate, m = make_train_step(cfg, peak_lr=spec["lr"], warmup=1,
                                total_steps=100)(ustate, batch)
    torch.cuda.synchronize()
    out["ref"] = dict(loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
                      lr=float(m["lr"]), launches=dict(LAUNCHES), drops=drops)
    ref.update({f"master/{n}": x.cpu()
                for n, x in named_leaves(ustate.opt.master).items()})
    del ustate, batch, m
    torch.cuda.empty_cache()
    return ref


if spec["phase"] in ("11b", "12e"):
    held = unsharded_step() if spec["phase"] == "12e" and rank == 0 \
        else None
    state = init_sharded_train_state(gen(), cfg, mesh)
    step = make_step(state)
    grad_fn = make_grad_fn(cfg, remat=True, logits_pspec=lp)
    out["steps"] = []
    plan = ([(start, lambda want=want: np.load(want))
             for start, want in spec["states"]] if spec["phase"] == "11b"
            else [(None, lambda: held)])
    for k, (start, reference) in enumerate(plan):
        if start is not None:
            state = restore_pytree(start, state)
        ref = reference() if rank == 0 else None
        # the gradient this step takes, each leaf gathered; rank 0 keeps
        # it for the update's bar
        _, _, grads = grad_fn(state.params, sb)
        gworst, gsh = {}, {}
        for name, g in named_leaves(grads).items():
            g = full(g)
            if rank == 0:
                w = torch.as_tensor(ref[f"grad/{name}"], device=dev)
                gsh[name] = g.float()
                gworst[name] = [torch.max(torch.abs(gsh[name] - w)).item(),
                                torch.max(torch.abs(w)).item()]
        del grads
        reset_launches()
        state, m = step(state, sb)
        torch.cuda.synchronize()
        got = dict(loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
                   launches=dict(LAUNCHES), worst={}, sloped=0, n=0,
                   grads=gworst)
        lr = float(m["lr"])
        params = named_leaves(state.params)
        for name, x in named_leaves(state.opt.master).items():
            x, p = full(x), full(params[name])
            if rank:
                continue
            # f32: each parameter is its master weight, cast to f32
            got["params_are_master"] = got.get("params_are_master", True) \
                and bool(torch.equal(p, x))
            w = torch.as_tensor(ref[f"master/{name}"], device=dev)
            gref = torch.as_tensor(ref[f"grad/{name}"], device=dev)
            g = gsh.pop(name)
            plain = spec["tol"] * max(1.0, torch.abs(w).max().item())
            slope = spec["slope"] * lr / spec["eps"] * torch.abs(g - gref)
            err = torch.abs(x - w)
            # the element that takes the largest share of its bar, with
            # its gradients (unsharded, sharded)
            i = int(torch.argmax(err / (plain + slope)))
            got["worst"][name] = [
                err.flatten()[i].item(), plain, slope.flatten()[i].item(),
                gref.flatten()[i].item(), g.flatten()[i].item()]
            got["sloped"] += int((err > plain).sum())
            got["n"] += err.numel()
        out["steps"].append(got)

if spec["phase"] == "12":
    import contextlib
    out["runs"] = []
    for run in spec["runs"]:
        cfg = config_of(run["arch"], run["changes"])
        sb, lp = placed_batch(cfg, run["batch"])
        params = init_params(gen(), cfg)
        sp = distribute_tree(params, param_pspecs(params, mesh), mesh)
        del params
        grad_fn = make_grad_fn(cfg, remat=True, logits_pspec=lp)
        # the unsharded run's routing, every call of it, replayed: the
        # comparison's discontinuity (a bf16 rounding that moves a token
        # across a top-k or capacity boundary) taken out
        routes = [t.to(dev) for t in torch.load(run["routes"])]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with moe_routes(routes, replay=True):
            loss, _, grads = grad_fn(sp, sb)
        torch.cuda.synchronize()
        got = dict(label=run["label"], launches=dict(LAUNCHES),
                   grad_wall_ms=(time.perf_counter() - t0) * 1e3,
                   loss=loss.item(), gnorm=global_norm(grads).item())
        ref = torch.load(run["ref"]) if rank == 0 else None
        # each saved leaf against its bar: the larger of tol and noise
        # times the unsharded run's own distance from the f32 control
        worst = (0.0, 0.0, 1.0, "?")
        for name, g in named_leaves(grads).items():
            if name in run["leaves"]:
                g = full(g)
                if rank == 0:
                    r = rel_l2(g, ref["grads"][name].to(dev))
                    bar = max(spec["tol"], spec["noise"] * ref["noise"][name])
                    if r / bar >= worst[0] / worst[2]:
                        worst = (r, ref["noise"][name], bar, name)
        got.update(worst=worst[0], worst_noise=worst[1], worst_bar=worst[2],
                   worst_leaf=worst[3])
        if rank == 0:
            got.update(ref_loss=ref["loss"], ref_gnorm=ref["gnorm"],
                       ref_drops=ref["drops"])
        del grads, sp, ref
        torch.cuda.empty_cache()
        # the first step routes freely: its first MoE layer's choices
        # against the unsharded run's, and its drop fractions
        free, drops = [], []
        state = init_sharded_train_state(gen(), cfg, mesh)
        first = contextlib.ExitStack()
        first.enter_context(moe_routes(free))
        first.enter_context(moe_drops(drops))
        state, steps = timed_steps(make_step(state, cfg, lp), state, sb,
                                   spec["steps"], first)
        got.update(steps, drops=drops)
        if free:
            got["flips"] = route_flips(free[:1], routes[:1])[0]
            got["tokens"] = free[0].shape[0]
        del free, routes
        del state
        torch.cuda.empty_cache()
        out["runs"].append(got)

dist.destroy_process_group()
print("RANK11 " + json.dumps(out))
"""


def train_base() -> dict:
    """The rank program's spec entries every training phase shares:
    phase 10a's weights, batch seed and shape, and learning rate."""
    from repro_torch.serving import cell
    return dict(arch=cell.ARCH, param_seed=cell.PARAM_SEED,
                batch_seed=TRAIN_BATCH_SEED, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, lr=TRAIN_LR, changes={}, root=str(ROOT))


def run_ranks(label, world, spec, tmp, card, program=None,
              tag: str = "RANK11", timeout: float = 900,
              pg_timeout: float = 600) -> list:
    """`program` (`TRAIN11_PROGRAM` where None), whose ranks print their
    result on a line that starts with `tag`, with `spec` on `world` gloo
    ranks of the one card (`run_probe`); each rank's result line, checked
    to have loaded phase 2's kernels and to sit on card 0."""
    from repro_torch.substrate import run_probe
    path = f"{tmp}/spec_{label}.json"
    Path(path).write_text(json.dumps(spec))
    t0 = time.perf_counter()
    run = run_probe((program or TRAIN11_PROGRAM).replace("@SPEC@", path),
                    world=world, timeout=timeout, pg_timeout=pg_timeout)
    wall = time.perf_counter() - t0
    check(run.ok, f"phase {label} ranks failed:\n{run.report()}")
    lines = []
    for i, r in enumerate(run.ranks):
        found = [ln for ln in r.stdout.splitlines()
                 if ln.startswith(tag + " ")]
        check(len(found) == 1, f"{label} rank {i}: no result line:\n"
              f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        line = json.loads(found[0][len(tag) + 1:])
        check(line["compiled"] == [],
              f"{label} rank {i} recompiled kernels: {line['compiled']}")
        check(line["device"] == 0, f"{label} rank {i} on card "
              f"{line['device']}")
        lines.append(line)
    print(f"phase {label}: {world} gloo ranks on the one card, the "
          f"whole run {wall:.1f} s {card}")
    return lines


def config_of(arch: str, changes: dict):
    """`arch`'s configuration with `changes` (a `moe` entry: a dict of the
    nested MoE fields), as the rank program builds it."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    changes = dict(changes)
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(cfg.moe, **changes["moe"])
    return cfg.replace(**changes)


def flash_launches(cfg) -> int:
    """#9's launches in one remat loss-and-gradient of `cfg` at sequences
    that take the long branch: two for each attention layer of the
    scanned stack (the forward and the recompute), one for each of the
    tail's (the MoE head) and of the encoder's, which run outside
    remat."""
    from repro_torch.models.backbone import stack_plan
    pat, n_groups, tail = stack_plan(cfg)
    attn = ("attn", "local_attn", "moe")
    encoder = cfg.n_encoder_layers if cfg.arch_type == "encdec" else 0
    return 2 * sum(k in attn for k in pat * n_groups) + \
        sum(k in attn for k in tail) + encoder


def f32_sharded_check(label, arch, changes, dev, card, tmp,
                      in_rank: bool = False) -> None:
    """An f32 copy of `arch` with `changes` trained on SHARDED_MESH_11B's
    ranks (ZeRO over `data`) against the unsharded step, by 11b's bars:
    every gradient leaf within TOL_FIT · max|g|, the loss and the norm
    within TOL_KERNEL relative, each master element within TOL_KERNEL ·
    max(1, max|w|) plus ADAM_SLOPE_11B lr / eps times the two gradients'
    difference there (at most MAX_SLOPED_11B of them past the first term
    alone), each parameter its master's bits; #9 as many times on each
    rank as on one card. 11b: each of two steps from the unsharded
    step's state before it, computed here on the card, written to files
    and freed before the ranks start. With `in_rank` (12e): one step from
    the seed's state, whose unsharded twin rank 0 takes itself and holds
    in memory (nothing written to the disk: a full-width f32 state and
    its gradients are tens of GB)."""
    from repro_torch.checkpoint.io import save_pytree
    from repro_torch.data.synth_tokens import synthetic_lm_batches
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models.backbone import _stack_kinds
    from repro_torch.serving import cell
    from repro_torch.training.step import (
        init_train_state, make_grad_fn, make_train_step,
    )
    from repro_torch.tree import named_leaves

    changes = {**changes, "param_dtype": "float32",
               "compute_dtype": "float32"}
    cfg32 = config_of(arch, changes)
    want_flash = flash_launches(cfg32)
    n_moe = sum(k == "moe" for k in _stack_kinds(cfg32))
    world = SHARDED_MESH_11B[0] * SHARDED_MESH_11B[1]
    spec = dict(train_base(), arch=arch, model=SHARDED_MESH_11B[1],
                changes=changes, tol=TOL_KERNEL, slope=ADAM_SLOPE_11B,
                eps=ADAM_EPS)
    states, want, drops = [], [], []
    if in_rank:
        b = run_ranks(label, world, dict(spec, phase="12e"), tmp, card)
        ref = b[0]["ref"]
        check(ref["launches"].get("flash_attention", 0) == want_flash,
              f"{label} unsharded step launches {ref['launches']}")
        want.append((ref["loss"], ref["grad_norm"], ref["lr"]))
        drops = ref["drops"]
    else:
        state = init_train_state(
            torch.Generator(device=dev).manual_seed(cell.PARAM_SEED), cfg32)
        batch = next(synthetic_lm_batches(
            torch.Generator(device=dev).manual_seed(TRAIN_BATCH_SEED),
            vocab=cfg32.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ))
        step = make_train_step(cfg32, peak_lr=TRAIN_LR, warmup=1,
                               total_steps=100)
        grad_fn = make_grad_fn(cfg32, remat=True)
        for k in range(2):
            if k:
                save_pytree(f"{tmp}/s{label}_{k}", state)
            with moe_drops(drops if not k else []):
                _, _, grads = grad_fn(state.params, batch)
            flat_g = {f"grad/{n}": g.cpu().numpy()
                      for n, g in named_leaves(grads).items()}
            del grads
            reset_launches()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            check(LAUNCHES["flash_attention"] == want_flash,
                  f"{label} unsharded step launches {dict(LAUNCHES)}")
            flat = {**flat_g,
                    **{f"master/{n}": x.cpu().numpy()
                       for n, x in named_leaves(state.opt.master).items()}}
            np.savez(f"{tmp}/want{label}_{k}.npz", **flat)
            del flat, flat_g
            states.append([f"{tmp}/s{label}_{k}.npz" if k else None,
                           f"{tmp}/want{label}_{k}.npz"])
            want.append((m["loss"].item(), m["grad_norm"].item(),
                         float(m["lr"])))
        del state, batch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        b = run_ranks(label, world, dict(spec, phase="11b", states=states),
                        tmp, card)
    if n_moe:
        # the capacity binds where C holds fewer than the T·K choices;
        # the forward's layers first, then remat's recompute
        drops = drops[:n_moe]
        print(f"phase {label} unsharded step 1's MoE drop fractions "
              f"{[round(x, 4) for x in drops]} (capacity_factor "
              f"{cfg32.moe.capacity_factor}) {card}")
        check(cfg32.moe.capacity_factor >= 1 or min(drops) > 0,
              f"{label}: the capacity does not bind: drops {drops}")
    for k, ((loss, gnorm, lr), got) in enumerate(zip(want,
                                                     b[0]["steps"])):
        check(got["params_are_master"], f"{label} step {k}: a parameter is not "
              "its f32 master weight")
        for i, ln in enumerate(b):
            fl = ln["steps"][k]["launches"].get("flash_attention", 0)
            check(fl == want_flash, f"{label} rank {i} step {k} "
                  f"flash launches {fl}")
        check(abs(got["loss"] - loss) <= TOL_KERNEL * abs(loss),
              f"{label} step {k} loss {got['loss']} vs unsharded {loss}")
        check(abs(got["grad_norm"] - gnorm) <= TOL_KERNEL * gnorm,
              f"{label} step {k} grad_norm {got['grad_norm']} vs {gnorm}")
        gmax, gleaf = 0.0, "?"
        for name, (err, scale) in got["grads"].items():
            # 10b's bar for f32 gradients summed in two orders on the card
            check(err <= TOL_FIT * scale, f"{label} step {k} gradient {name}:"
                  f" err {err} > {TOL_FIT} * {scale}")
            if err / max(scale, 1e-30) >= gmax:
                gmax, gleaf = err / max(scale, 1e-30), name
        # the update (see ADAM_SLOPE_11B): the element that takes the
        # largest share of its bar, its gradients printed
        share, at = 0.0, None
        for name, (err, plain, slope, gref, gsh) in got["worst"].items():
            check(err <= plain + slope, f"{label} step {k} master {name}: err "
                  f"{err} > {plain} + {slope} (the gradient there "
                  f"{gsh} sharded, {gref} unsharded)")
            if err / (plain + slope) >= share:
                share, at = err / (plain + slope), (name, err, plain, slope,
                                                    gref, gsh)
        check(got["sloped"] <= MAX_SLOPED_11B * got["n"],
              f"{label} step {k}: {got['sloped']} of {got['n']} master elements "
              f"past {TOL_KERNEL} absolute")
        name, err, plain, slope, gref, gsh = at
        print(f"phase {label} {cfg32.name} f32 at {cfg32.n_layers} layers "
              f"({changes}), mesh "
              f"{SHARDED_MESH_11B}, step {k + 1}: loss {got['loss']:.7f} "
              f"against unsharded {loss:.7f}, grad_norm "
              f"{got['grad_norm']:.7g} against {gnorm:.7g}; worst gradient "
              f"leaf {gmax:.3g} of its max|g| at {gleaf} (bar {TOL_FIT}); "
              f"master (each parameter its master's bits): "
              f"{got['sloped']} of {got['n']} elements past {plain:g} "
              f"(at most {MAX_SLOPED_11B:g} of them), the largest share of "
              f"its bar {share:.3g} at {name}: off by {err:.4g}, bar "
              f"{plain:g} + {slope:.4g} ({ADAM_SLOPE_11B} lr / eps times the "
              f"gradients' difference there: {gsh:.6g} sharded, {gref:.6g} "
              f"unsharded, lr {lr:g}); flash (f32, with lse) "
              f"{want_flash} launches a rank {card}")


def train_sharded_phase(dev, card, tmp) -> dict:
    """Phase 11: granite-3-2b's train step sharded over gloo ranks of the
    one card (`launch/train.py`'s path: `init_sharded_train_state`, the
    batch placed by `batch_pspecs`, `make_train_step` with the
    reference's `logits_pspec` and `grads_pspec`). 11a: the full model in
    bf16 on a (1, TP_MODEL) mesh, phase 10a's weights and batch: one loss
    and gradient through the kernels (#9 on each rank's local heads)
    against 10a's saved kernel run, then TP_STEPS AdamW steps. 11b: an
    f32 copy at TRAIN_F32_LAYERS layers on a (2, 2) mesh (ZeRO over
    `data`), each of two steps from the unsharded step's state before it
    against that step. Returns the flash launches of 11a's rank 0 and of
    the phase."""
    from repro_torch.configs import get_config
    from repro_torch.serving import cell
    from repro_torch.tree import named_leaves

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = get_config(cell.ARCH)

    # ---- 11a. granite-3-2b unreduced, bf16, (1, TP_MODEL) --------------
    leaves = [n for n in named_leaves(init_params_shapes(cfg))
              if sharded_leaf(n, cfg)]
    a = run_ranks("11a", TP_MODEL, dict(
        train_base(), phase="11a", model=TP_MODEL, steps=TP_STEPS,
        leaves=leaves, ref10a=f"{tmp}/ref10a.pt"), tmp, card)
    r0 = a[0]
    per_rank = [ln["launches"] for ln in a]
    for i, got in enumerate(per_rank):
        want = dict.fromkeys(got, 0)
        want["flash_attention"] = 2 * cfg.n_layers
        check(got == want, f"11a rank {i} launches {got}, expected "
              f"flash_attention={2 * cfg.n_layers} (forward and recompute "
              "on its local heads) and nothing else")
    lk, l10 = r0["loss"], r0["ref_loss"]
    gk, g10 = r0["gnorm"], r0["ref_gnorm"]
    print(f"phase 11a {cfg.name} unreduced, bf16, mesh (1, {TP_MODEL}), "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat, through the kernels: "
          f"loss {lk:.6f} against 10a's {l10:.6f} (rel "
          f"{abs(lk - l10) / abs(l10):.3g}, bar {TOL_TRAIN_LOSS}); grad_norm "
          f"{gk:.6g} against {g10:.6g} (rel {abs(gk - g10) / g10:.3g}, bar "
          f"{TOL_TRAIN_GNORM}); worst of {len(leaves)} leaves relative l2 "
          f"{r0['worst']:.4g} at {r0['worst_leaf']} (bar {TOL_TRAIN_GRAD}); "
          f"flash launches a rank {[ln['launches']['flash_attention'] for ln in a]}; "
          f"loss-and-grad wall {[round(ln['grad_wall_ms'], 1) for ln in a]} "
          f"ms {card}")
    check(abs(lk - l10) <= TOL_TRAIN_LOSS * abs(l10),
          f"11a loss {lk} vs 10a {l10}")
    check(abs(gk - g10) <= TOL_TRAIN_GNORM * g10,
          f"11a grad_norm {gk} vs 10a {g10}")
    check(r0["worst"] <= TOL_TRAIN_GRAD, f"11a gradient {r0['worst_leaf']}:"
          f" relative l2 error {r0['worst']} > {TOL_TRAIN_GRAD}")
    losses = r0["losses"]
    check(all(math.isfinite(x) for x in losses + r0["norms"]),
          f"11a losses {losses}, grad norms {r0['norms']}")
    check(losses[-1] < losses[0], f"11a the loss did not fall: {losses}")
    step_ms = r0["walls_ms"][1]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 11a {TP_STEPS} AdamW steps (peak_lr {TRAIN_LR}, warmup 1):"
          f" losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in r0['norms']]}; step walls "
          f"{[round(w, 1) for w in r0['walls_ms']]} ms (the last under the "
          f"collective counters); a step {step_ms:.1f} ms (step 2), "
          f"{tokens / step_ms * 1e3:.0f} tokens/s; peak memory a rank "
          f"{[round(ln['peak_gib'], 2) for ln in a]} GiB {card}")
    print(f"phase 11a collectives of a step on rank 0, by kind: calls "
          f"{r0['calls']}, bytes {r0['bytes']}; one activation all-reduce "
          f"({r0['allreduce_bytes'] / 2**20:.0f} MiB bf16 over `model`) "
          f"{r0['allreduce_ms']:.2f} ms on rank 0 (CUDA events, mean of 5) "
          f"{card}")

    # ---- 11b. f32 at TRAIN_F32_LAYERS layers, (2, 2), against the parent --
    f32_sharded_check("11b", cell.ARCH, {"n_layers": TRAIN_F32_LAYERS},
                      dev, card, tmp)
    return {"launches_11a": r0["launches"]["flash_attention"],
            "launches": {"flash_attention_lse_tp2": sum(
                ln["launches"]["flash_attention"] for ln in a)}}


# phase 12's bf16 runs whose #9 per-rank instance is a row of its own
ZOO12_ROWS = {"12a": "flash_attention_lse_moe_tp2",
              "12b": "flash_attention_lse_qwen3_tp2",
              "12c": "flash_attention_lse_h256_tp2"}


def zoo12_flash_shapes() -> dict:
    """{row: (shape, window)}: #9's per-rank instance in phase 12's runs,
    (batch, S, N / TP_MODEL, the kv heads a rank reads, H): K / TP_MODEL
    where it divides, else the kv heads of the rank's q heads (a
    replicated `wk`/`wv`, each rank slicing its own)."""
    out = {}
    for label, arch, changes, batch in ZOO12:
        if label not in ZOO12_ROWS:
            continue
        cfg = config_of(arch, changes)
        n, k = cfg.n_heads // TP_MODEL, cfg.n_kv_heads
        kv = k // TP_MODEL if k % TP_MODEL == 0 else \
            max(1, n // (cfg.n_heads // k))
        out[ZOO12_ROWS[label]] = ((batch, TRAIN_SEQ, n, kv,
                                   cfg.resolved_head_dim), cfg.window)
    return out


def zoo_leaves(cfg) -> list:
    """The leaves phase 12 holds to the unsharded run: the tail's first
    layer (the MoE head), the stack's first and last, the embedding, the
    head and the final norm."""
    from repro_torch.tree import named_leaves
    names = list(named_leaves(init_params_shapes(cfg)))
    last = max(int(n.split("/")[1]) for n in names
               if n.startswith("layers/"))
    keep = ("tail/0/", "layers/0/", f"layers/{last}/")
    return [n for n in names if n.startswith(keep)
            or n in ("embed", "head", "final_norm")]


def train_zoo_sharded_phase(dev, card, tmp) -> dict:
    """Phase 12: the MoE, RG-LRU hybrid and SSM families' train step
    sharded over TP_MODEL gloo ranks of the one card as a (1, TP_MODEL)
    mesh (`launch/train.py`'s path), each run of ZOO12 at full width in
    bf16 with its depth cut: first its unsharded kernel run here (one
    loss and gradient with remat; #9's launches counted; the first MoE
    layer's routing and each MoE layer's drops recorded), saved and
    freed; then, in one pair of ranks, each run's loss and gradient
    through the kernels (launch counts zeroed just before, read just
    after) held to it by 11a's bars, the MoE's routing flips by
    TOL_ROUTE_FLIPS, and ZOO12_STEPS AdamW steps: the loss falling, step
    walls, tokens/s, each rank's peak memory, the last step's
    collectives by kind and by op (no DTensor all-gather). Then 12e:
    ZOO12E's f32 copies on SHARDED_MESH_11B (`f32_sharded_check`).
    Returns rank 0's and both ranks' #9 launches by row."""
    from repro_torch.data.synth_tokens import synthetic_lm_batches
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.models.backbone import _stack_kinds
    from repro_torch.optim.adamw import global_norm
    from repro_torch.serving import cell
    from repro_torch.training.step import make_grad_fn
    from repro_torch.tree import named_leaves, tree_map

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    runs = []
    for label, arch, changes, batch_n in ZOO12:
        cfg = config_of(arch, changes)
        leaves = zoo_leaves(cfg)
        n_moe = sum(k == "moe" for k in _stack_kinds(cfg))
        params = init_params(
            torch.Generator(device=dev).manual_seed(cell.PARAM_SEED), cfg)
        n_params = sum(p.numel() for p in named_leaves(params).values())
        batch = next(synthetic_lm_batches(
            torch.Generator(device=dev).manual_seed(TRAIN_BATCH_SEED),
            vocab=cfg.vocab, batch=batch_n, seq=TRAIN_SEQ))
        routes, drops = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with moe_routes(routes), moe_drops(drops):
            loss, _, grads = make_grad_fn(cfg, remat=True)(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want_flash = flash_launches(cfg)
        got = dict(LAUNCHES)
        check(got == {**dict.fromkeys(got, 0),
                      "flash_attention": want_flash},
              f"{label} unsharded launches {got}, expected flash_attention"
              f"={want_flash} and nothing else")
        flat = named_leaves(grads)
        ref = {"loss": loss.item(), "gnorm": global_norm(grads).item(),
               "grads": {n: flat[n] for n in leaves}, "drops": drops[:n_moe]}
        del grads, flat
        # the f32 control: the bf16 run's distance from it, leaf by leaf
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        params = tree_map(lambda t: t.float(), params)
        with moe_routes(list(routes), replay=True):
            _, _, g32 = make_grad_fn(cfg32, remat=True, use_kernel=False)(
                params, batch)
        g32 = named_leaves(g32)
        ref["noise"] = {n: rel_l2(ref["grads"][n], g32[n]) for n in leaves}
        del g32
        torch.save(ref, f"{tmp}/ref{label}.pt")
        torch.save([t.cpu() for t in routes], f"{tmp}/routes{label}.pt")
        print(f"phase {label} {arch} {changes} unsharded, bf16, batch "
              f"{batch_n} x {TRAIN_SEQ}, remat, {n_params / 1e9:.3f} B "
              f"parameters: loss {ref['loss']:.6f}, grad_norm "
              f"{ref['gnorm']:.6g}, flash launches {want_flash}, MoE drop "
              f"fractions {[round(x, 4) for x in ref['drops']]}; "
              f"loss-and-grad {wall * 1e3:.1f} ms, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
        runs.append(dict(label=label, arch=arch, changes=changes,
                         batch=batch_n, leaves=leaves,
                         ref=f"{tmp}/ref{label}.pt",
                         routes=f"{tmp}/routes{label}.pt", flash=want_flash,
                         n_moe=n_moe, n_params=n_params))
        noisy = max(ref["noise"], key=ref["noise"].get)
        print(f"phase {label} f32 control (the weights upcast, the plain "
              f"path{', routed as the bf16 run' if n_moe else ''}): the "
              f"bf16 run's leaves {min(ref['noise'].values()):.3g}-"
              f"{ref['noise'][noisy]:.3g} relative l2 off it, the most at "
              f"{noisy} {card}")
        del params, batch, ref, routes, loss
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    lines = run_ranks("12", TP_MODEL, dict(
        train_base(), phase="12", model=TP_MODEL, steps=ZOO12_STEPS,
        tol=TOL_TRAIN_GRAD, noise=ZOO12_NOISE,
        runs=[{k: r[k] for k in ("label", "arch", "changes", "batch",
                                 "leaves", "ref", "routes")}
              for r in runs]),
        tmp, card)
    rank0, both = {}, {}
    for k, run in enumerate(runs):
        label, got = run["label"], [ln["runs"][k] for ln in lines]
        r0 = got[0]
        for i, g in enumerate(got):
            fl = g["launches"].get("flash_attention", 0)
            check(fl == run["flash"] and
                  sum(g["launches"].values()) == fl,
                  f"{label} rank {i} launches {g['launches']}, expected "
                  f"flash_attention={run['flash']} (forward and recompute "
                  "on its local heads) and nothing else")
            functional = [op for op in g["ops"]
                          if op.startswith("_c10d_functional")
                          and "all_gather" in op]
            check(not functional, f"{label} rank {i}: DTensor all-gathers "
                  f"{functional} in a step")
        lk, lr = r0["loss"], r0["ref_loss"]
        gk, gr = r0["gnorm"], r0["ref_gnorm"]
        flips, routed = "", ""
        if run["n_moe"]:
            share = r0["flips"] / r0["tokens"]
            routed = " (routed as the unsharded run, every call replayed)"
            flips = (f"; free routing (the first step): top-k sets flipped "
                     f"at the first MoE layer {r0['flips']} of "
                     f"{r0['tokens']} tokens ({share:.4f}, bar "
                     f"{TOL_ROUTE_FLIPS}), drop fractions sharded "
                     f"{[round(x, 4) for x in r0['drops'][:run['n_moe']]]}"
                     f", unsharded {[round(x, 4) for x in r0['ref_drops']]}")
        print(f"phase {label} {run['arch']} {run['changes']}, bf16, mesh "
              f"(1, {TP_MODEL}), batch {run['batch']} x {TRAIN_SEQ}, remat, "
              f"through the kernels{routed}: loss {lk:.6f} against unsharded "
              f"{lr:.6f} (rel {abs(lk - lr) / abs(lr):.3g}, bar "
              f"{TOL_TRAIN_LOSS}); grad_norm {gk:.6g} against {gr:.6g} (rel "
              f"{abs(gk - gr) / gr:.3g}, bar {TOL_TRAIN_GNORM}); the leaf "
              f"nearest its bar of {len(run['leaves'])}: {r0['worst_leaf']} "
              f"relative l2 {r0['worst']:.4g}, bar {r0['worst_bar']:.4g} "
              f"(the larger of {TOL_TRAIN_GRAD} and {ZOO12_NOISE} x the "
              f"unsharded run's {r0['worst_noise']:.4g} off the f32 "
              f"control); flash launches a "
              f"rank {[g['launches'].get('flash_attention', 0) for g in got]}"
              f"; loss-and-grad wall "
              f"{[round(g['grad_wall_ms'], 1) for g in got]} ms{flips} "
              f"{card}")
        check(abs(lk - lr) <= TOL_TRAIN_LOSS * abs(lr),
              f"{label} loss {lk} vs unsharded {lr}")
        check(abs(gk - gr) <= TOL_TRAIN_GNORM * gr,
              f"{label} grad_norm {gk} vs unsharded {gr}")
        check(r0["worst"] <= r0["worst_bar"], f"{label} gradient "
              f"{r0['worst_leaf']}: relative l2 error {r0['worst']} > "
              f"{r0['worst_bar']}")
        if run["n_moe"]:
            check(r0["flips"] <= TOL_ROUTE_FLIPS * r0["tokens"],
                  f"{label}: {r0['flips']} of {r0['tokens']} tokens routed "
                  "to another top-k set at the first MoE layer")
        losses = r0["losses"]
        check(all(math.isfinite(x) for x in losses + r0["norms"]),
              f"{label} losses {losses}, grad norms {r0['norms']}")
        check(losses[-1] < losses[0], f"{label} the loss did not fall: "
              f"{losses}")
        step_ms = r0["walls_ms"][-1]
        tokens = run["batch"] * TRAIN_SEQ
        print(f"phase {label} {ZOO12_STEPS} AdamW steps (peak_lr {TRAIN_LR},"
              f" warmup 1): losses {[round(x, 4) for x in losses]}, grad "
              f"norms {[round(x, 4) for x in r0['norms']]}; step walls "
              f"{[round(w, 1) for w in r0['walls_ms']]} ms (the last under "
              f"the collective counters); a step {step_ms:.1f} ms (the "
              f"last), {tokens / step_ms * 1e3:.0f} tokens/s; peak memory a "
              f"rank {[round(g['peak_gib'], 2) for g in got]} GiB; "
              f"collectives of the last step on rank 0: calls {r0['calls']},"
              f" bytes {r0['bytes']}, by op {r0['ops']} {card}")
        if label in ZOO12_ROWS:
            rank0[ZOO12_ROWS[label]] = r0["launches"]["flash_attention"]
            both[ZOO12_ROWS[label]] = sum(
                g["launches"]["flash_attention"] for g in got)

    # ---- 12e. f32 copies on (2, 2) against the unsharded f32 step -------
    for label, arch, changes in ZOO12E:
        f32_sharded_check(label, arch, changes, dev, card, tmp, in_rank=True)
    return {"launches": rank0, "launches_phase12": both}


@torch.no_grad()
def serve_trace(params, cfg, prompt, steps, frontend=None) -> dict:
    """The unsharded greedy run step by step, as `greedy_generate` runs it:
    the prefill's last logits and each decode step's (f32, on the host)
    and the tokens each gives, for phase 13 to hold its sharded steps
    to."""
    from repro_torch.models import Batch
    from repro_torch.serving.engine import (
        frontend_offset, make_prefill_step, make_serve_step,
    )
    off, s = frontend_offset(cfg, frontend), prompt.shape[1]
    logits, caches = make_prefill_step(cfg, cache_len=s + off + steps)(
        params, Batch(tokens=prompt, frontend=frontend))
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out = {"logits": [logits[:, -1].float().cpu()], "tokens": [tok.cpu()]}
    serve = make_serve_step(cfg)
    for i in range(steps - 1):
        tok, logits, caches = serve(params, tok[:, None], s + off + i,
                                    caches)
        out["logits"].append(logits[:, -1].float().cpu())
        out["tokens"].append(tok.cpu())
    return out


SERVE13_PROGRAM = r"""
import contextlib, json, logging, sys, time
import torch
import torch.distributed as dist
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
from repro_torch.kernels import _build
from repro_torch.kernels.common import LAUNCHES, reset_launches
from repro_torch.launch.hlo import Counters
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Batch, init_params
from repro_torch.serving import cell
from repro_torch.serving.engine import (
    frontend_offset, make_prefill_step, make_serve_step,
)
from repro_torch.sharding.place import distribute_tree, full
from repro_torch.sharding.rules import (
    batch_pspecs, cache_pspecs, param_pspecs, placements,
)
from repro_torch.substrate import init_from_env
from repro_torch.tree import named_leaves

spec = json.load(open("@SPEC@"))
dev = torch.device("cuda")
rank, world = init_from_env(device=dev)
_build.build()
out = dict(rank=rank, world=world, compiled=sorted(_build.BUILD_SECONDS),
           device=torch.cuda.current_device(), runs=[])
mesh = make_host_mesh(spec["model"], device_type="cuda")
sys.path.insert(0, spec["root"])
from chip_smoke import config_of, encoder_launches, moe_routes, route_flips


def ms_since(t0):
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def worst(got, want, vocab):
    # max |got - want| over max |want|, on the vocabulary's columns
    got, want = got[..., :vocab].float(), want[..., :vocab].to(got.device)
    return (torch.max(torch.abs(got - want)) /
            torch.max(torch.abs(want))).item()


for run in spec["runs"]:
    cfg = config_of(run["arch"], run["changes"])
    params = init_params(
        torch.Generator(device=dev).manual_seed(cell.PARAM_SEED), cfg)
    sp = distribute_tree(params, param_pspecs(params, mesh), mesh)
    del params
    torch.cuda.empty_cache()
    B, steps = run["batch"], run["steps"]
    prompt = cell.make_prompt(cfg, dev, B)
    fe = cell.make_frontend(cfg, dev, B)
    S, off = prompt.shape[1], frontend_offset(cfg, fe)
    sb = distribute_tree(Batch(tokens=prompt, frontend=fe),
                         batch_pspecs(mesh, B, fe is not None), mesh)
    ref = torch.load(run["ref"])
    routes = ([t.to(dev) for t in torch.load(run["routes"])]
              if run["routes"] else None)
    prefill = make_prefill_step(cfg, cache_len=S + off + steps)
    serve = make_serve_step(cfg)
    got = dict(label=run["label"])

    def routing():
        return (moe_routes(routes, replay=True) if routes is not None
                else contextlib.nullcontext())

    if run["warm"]:
        # a prefill that warms the path up, its collectives counted
        with routing(), Counters() as c:
            logits, caches = prefill(sp, sb)
        torch.cuda.synchronize()
        got.update(prefill_calls=c.calls(), prefill_bytes=c.collectives(),
                   prefill_ops=c.ops())
        del logits, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # without a warm-up, the timed prefill's collectives are counted
    counted = contextlib.nullcontext(None) if run["warm"] else Counters()
    enc, walls, errs, agree = [], [], [], []
    reset_launches()
    with encoder_launches(enc), routing():
        with counted as c:
            t0 = time.perf_counter()
            logits, caches = prefill(sp, sb)
            got["prefill_ms"] = ms_since(t0)
        if c is not None:
            got.update(prefill_calls=c.calls(),
                       prefill_bytes=c.collectives(), prefill_ops=c.ops())
        want = named_leaves(cache_pspecs(mesh, caches, B))
        got["misplaced"] = [k for k, t in named_leaves(caches).items()
                            if tuple(t.placements)
                            != placements(want[k], mesh)]
        errs.append(worst(full(logits)[:, -1], ref["logits"][0],
                          cfg.padded_vocab))
        # each step fed the unsharded run's token before it (teacher
        # forcing: one near-tie does not carry on)
        for i in range(steps - 1):
            tok = distribute_tree(ref["tokens"][i].to(dev)[:, None],
                                  batch_pspecs(mesh, B).tokens, mesh)
            t0 = time.perf_counter()
            nxt, logits, caches = serve(sp, tok, S + off + i, caches)
            walls.append(ms_since(t0))
            errs.append(worst(full(logits)[:, -1], ref["logits"][i + 1],
                              cfg.vocab))
            agree.append(int((full(nxt).cpu()
                              == ref["tokens"][i + 1]).sum()))
    got.update(launches=dict(LAUNCHES), encoder=sum(enc),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               decode_ms=walls, errs=errs, agree=agree,
               tokens=B * (steps - 1))
    # one more step (routed freely: the unsharded run has no such step),
    # its collectives counted
    tok = distribute_tree(ref["tokens"][steps - 1].to(dev)[:, None],
                          batch_pspecs(mesh, B).tokens, mesh)
    with Counters() as c:
        serve(sp, tok, S + off + steps - 1, caches)
    got.update(decode_calls=c.calls(), decode_bytes=c.collectives(),
               decode_ops=c.ops())
    del logits, caches
    if routes is not None:
        # the routing left free: the first MoE layer's top-k sets against
        # the unsharded run's
        free = []
        with moe_routes(free):
            prefill(sp, sb)
        got["flips"] = route_flips(free[:1], routes[:1])[0]
        got["routed"] = free[0].shape[0]
    del sp
    torch.cuda.empty_cache()
    out["runs"].append(got)

dist.destroy_process_group()
print("RANK13 " + json.dumps(out))
"""


# phase 13's runs whose #9 per-rank instance (no lse) is a row of its own
SERVE13_ROWS = {"13a": "flash_attention_tp2",
                "13b-moe": "flash_attention_moe_tp2",
                "13b-rg": "flash_attention_h256_tp2",
                "13b-vlm": "flash_attention_vlm_tp2",
                "13b-audio": "flash_attention_noncausal_tp2"}


# 13c's run whose #9 per-rank instance is an f32 row of its own
SERVE13C_ROWS = {"13c-rg": "flash_attention_f32_h256"}


def serve13_flash_shapes() -> dict:
    """{row: ((B, S, N / TP_MODEL, the kv heads a rank reads, H), causal,
    window)}: #9 without its lse at the per-rank shapes of phase 13's
    prefills, from the configurations (the VLM's patches ahead of its
    prompt; the enc-dec's encoder over its frames, not causal; the
    seamless decoder's causal calls run the H = 64 body of the granite
    row); K / TP_MODEL kv heads where it divides, else those of the
    rank's q heads (a replicated `wk`/`wv`)."""
    from repro_torch.serving import cell

    def shape(arch, s):
        c = config_of(arch, {})
        n, k = c.n_heads // TP_MODEL, c.n_kv_heads
        kv = k // TP_MODEL if k % TP_MODEL == 0 else \
            max(1, n // (c.n_heads // k))
        return (cell.BATCH, s, n, kv, c.resolved_head_dim)

    vlm = config_of("internvl2-2b", {})
    audio = config_of("seamless-m4t-medium", {})
    return {
        "flash_attention_tp2": (shape(cell.ARCH, cell.PROMPT), True, 0),
        "flash_attention_moe_tp2": (shape("deepseek-moe-16b", cell.PROMPT),
                                    True, 0),
        "flash_attention_h256_tp2": (
            shape("recurrentgemma-9b", cell.PROMPT), True,
            config_of("recurrentgemma-9b", {}).window),
        "flash_attention_vlm_tp2": (
            shape(vlm.name, cell.PROMPT + vlm.n_frontend_tokens), True, 0),
        "flash_attention_noncausal_tp2": (
            shape(audio.name, audio.n_frontend_tokens), False, 0),
    }


def attention_layers(cfg) -> int:
    """The layers of `cfg` whose prefill runs #9 once (the encoder's
    aside)."""
    return sum(kind in ("attn", "local_attn", "moe")
               for kind in cfg.layer_kinds())


def serve_reference(label, arch, changes, dev, tmp, batch, steps,
                    replay: bool = True) -> dict:
    """An unsharded kernel run of phase 13 taken here: `serve_trace` of
    `arch` with `changes` on its request batch, saved to `tmp` (with
    `replay`, every MoE route call too, for the sharded run to make); the
    rank program's entry for the run."""
    from repro_torch.models import init_params
    from repro_torch.serving import cell
    cfg = config_of(arch, changes)
    params = init_params(
        torch.Generator(device=dev).manual_seed(cell.PARAM_SEED), cfg)
    prompt = cell.make_prompt(cfg, dev, batch)
    fe = cell.make_frontend(cfg, dev, batch)
    routes = []
    with moe_routes(routes):
        trace = serve_trace(params, cfg, prompt, steps, fe)
    torch.save(trace, f"{tmp}/ref{label}.pt")
    replay = replay and bool(routes)
    if replay:
        torch.save([t.cpu() for t in routes], f"{tmp}/routes{label}.pt")
    del params, prompt, fe, routes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(label=label, arch=arch, changes=changes, batch=batch,
                steps=steps, ref=f"{tmp}/ref{label}.pt", warm=False,
                routes=f"{tmp}/routes{label}.pt" if replay else None)


def serve_sharded_phase(dev, card, tmp) -> dict:
    """Phase 13: prefill and decode sharded over gloo ranks of the one
    card (`serving.engine`'s steps on parameters placed by
    `param_pspecs`, the batch by `batch_pspecs`; the caches come out
    placed by `cache_pspecs`), each decode step fed the unsharded run's
    token before it. 13a: granite-3-2b unreduced in bf16 on a (1,
    TP_MODEL) mesh against phase 6's kernel run (`{tmp}/ref13a.pt`); a
    warm-up prefill, then the prefill and NEW_TOKENS - 1 decode steps
    timed with the launch counts zeroed just before and read just after,
    then one more step under the collective counters. 13b: SERVE13B's
    families on the same ranks, each against its unsharded kernel run
    taken first here (the MoE routed as it, every route call replayed,
    then a free prefill's flips), under the collective counters. 13c:
    SERVE13C's f32 copies on SHARDED_MESH_11B's 4 ranks, the same tokens
    and logits within TOL_FIT · max|logits|. Returns rank 0's #9
    launches by row and both ranks' (`launches_phase13`)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import cell

    steps = cell.NEW_TOKENS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    runs = [dict(label="13a", arch=cell.ARCH, changes={}, batch=cell.BATCH,
                 steps=steps, ref=f"{tmp}/ref13a.pt", warm=True,
                 routes=None)]
    for label, arch, changes in SERVE13B:
        runs.append(serve_reference(label, arch, changes, dev, tmp,
                                    cell.BATCH, steps))
    base = dict(model=TP_MODEL, root=str(ROOT))
    lines = run_ranks("13ab", TP_MODEL, dict(base, runs=runs), tmp, card,
                      SERVE13_PROGRAM, "RANK13", 600, 300)
    rank0, both = {}, {}
    for k, run in enumerate(runs):
        label, got = run["label"], [ln["runs"][k] for ln in lines]
        r0 = got[0]
        cfg = config_of(run["arch"], run["changes"])
        full_cfg = get_config(run["arch"])
        n_attn = attention_layers(cfg)
        enc = cfg.n_encoder_layers if cfg.arch_type == "encdec" else 0
        for i, g in enumerate(got):
            fl = g["launches"].get("flash_attention", 0)
            check(fl == n_attn + enc and sum(g["launches"].values()) == fl
                  and g["encoder"] == enc,
                  f"{label} rank {i} launches {g['launches']} ({g['encoder']}"
                  f" in the encoder), expected flash_attention="
                  f"{n_attn + enc} ({enc} in the encoder) on its local heads "
                  "and nothing else")
            ops = {**g["prefill_ops"], **g["decode_ops"]}
            functional = [op for op in ops if op.startswith(
                "_c10d_functional") and "all_gather" in op]
            check(not functional, f"{label} rank {i}: DTensor all-gathers "
                  f"{functional}")
            check(g["misplaced"] == [], f"{label} rank {i}: cache leaves "
                  f"placed otherwise than cache_pspecs: {g['misplaced']}")
        worst_step = max(r0["errs"][1:])
        check(r0["errs"][0] <= TOL_SERVE_BF16
              and worst_step <= TOL_SERVE_BF16, f"{label}: the prefill's "
              f"last logits {r0['errs'][0]:.4g} and the worst decode step's"
              f" {worst_step:.4g} of max|logits| off the unsharded run, bar"
              f" {TOL_SERVE_BF16}")
        cut = (f" cut to {cfg.n_layers} of {full_cfg.n_layers} layers"
               if cfg.n_layers != full_cfg.n_layers else " unreduced")
        flips = ""
        if run["routes"]:
            check(r0["flips"] <= TOL_ROUTE_FLIPS * r0["routed"],
                  f"{label}: free routing flipped {r0['flips']} of "
                  f"{r0['routed']} tokens' top-k sets at the first MoE layer")
            flips = (f"; routed as the unsharded run (every call replayed); "
                     f"free routing flips {r0['flips']} of {r0['routed']} "
                     f"tokens' top-k sets at the first MoE layer (bar "
                     f"{TOL_ROUTE_FLIPS})")
        prefill_ms, decode = r0["prefill_ms"], r0["decode_ms"]
        step_ms = sum(decode) / len(decode)
        total_s = (prefill_ms + sum(decode)) / 1e3
        counted = ("" if run["warm"] else
                   " (the prefill under the collective counters, no "
                   "warm-up)")
        print(f"phase {label} {cfg.name}{cut}, {cfg.compute_dtype}, mesh "
              f"(1, {TP_MODEL}), batch {run['batch']} x {cell.PROMPT}, "
              f"{steps} new tokens: prefill last logits "
              f"{r0['errs'][0]:.4g} of max|logits| off the unsharded kernel"
              f" run, the decode steps' worst {worst_step:.4g} (bar "
              f"{TOL_SERVE_BF16}); greedy tokens the unsharded run's "
              f"{sum(r0['agree'])} of {r0['tokens']}{flips}; every cache "
              f"leaf placed as cache_pspecs; flash launches a rank "
              f"{[g['launches'].get('flash_attention', 0) for g in got]}"
              f"{f' ({enc} in the encoder)' if enc else ''} {card}")
        print(f"phase {label} times{counted}: prefill {prefill_ms:.1f} ms, "
              f"decode {step_ms:.2f} ms per token step (mean of "
              f"{len(decode)}; {[round(x, 1) for x in decode]}), "
              f"{run['batch'] * steps / total_s:.1f} tokens/s; peak memory "
              f"a rank {[round(g['peak_gib'], 2) for g in got]} GiB {card}")
        print(f"phase {label} collectives on rank 0: the prefill calls "
              f"{r0['prefill_calls']}, bytes {r0['prefill_bytes']}, by op "
              f"{r0['prefill_ops']}; a decode step calls "
              f"{r0['decode_calls']}, bytes {r0['decode_bytes']}, by op "
              f"{r0['decode_ops']} {card}")
        if label in SERVE13_ROWS:
            row = SERVE13_ROWS[label]
            fl = [g["launches"]["flash_attention"] - g["encoder"]
                  if label != "13b-audio" else g["encoder"] for g in got]
            rank0[row], both[row] = fl[0], sum(fl)

    # ---- 13c. f32 copies on (2, 2) ----------------------------------------
    runs = [serve_reference(label, arch, changes, dev, tmp, SERVE13C_BATCH,
                            SERVE13C_STEPS, replay=False)
            for label, arch, changes in SERVE13C]
    world = SHARDED_MESH_11B[0] * SHARDED_MESH_11B[1]
    lines = run_ranks("13c", world, dict(
        base, model=SHARDED_MESH_11B[1], runs=runs), tmp, card,
        SERVE13_PROGRAM, "RANK13", 600, 300)
    for k, run in enumerate(runs):
        got = [ln["runs"][k] for ln in lines]
        r0 = got[0]
        cfg = config_of(run["arch"], run["changes"])
        n_attn = attention_layers(cfg)
        for i, g in enumerate(got):
            check(g["launches"].get("flash_attention", 0) == n_attn
                  and sum(g["launches"].values()) == n_attn,
                  f"{run['label']} rank {i} launches {g['launches']}, "
                  f"expected flash_attention={n_attn} and nothing else")
            check(g["misplaced"] == [], f"{run['label']} rank {i}: "
                  f"misplaced {g['misplaced']}")
        check(sum(r0["agree"]) == r0["tokens"], f"{run['label']}: "
              f"{sum(r0['agree'])} of {r0['tokens']} greedy tokens the "
              "unsharded f32 run's")
        check(max(r0["errs"]) <= TOL_FIT, f"{run['label']}: logits "
              f"{max(r0['errs'])} of max|logits| off the unsharded f32 run")
        if run["label"] in SERVE13C_ROWS:
            fl = [g["launches"]["flash_attention"] for g in got]
            row = SERVE13C_ROWS[run["label"]]
            rank0[row], both[row] = fl[0], sum(fl)
        moe = run["changes"].get("moe")
        print(f"phase {run['label']} {cfg.name} f32 at {cfg.n_layers} "
              f"layers{f' {moe}' if moe else ''}, mesh "
              f"{SHARDED_MESH_11B}, batch {run['batch']} x {cell.PROMPT}, "
              f"{run['steps']} new tokens: greedy tokens the unsharded f32 "
              f"run's ({r0['tokens']} of {r0['tokens']}); the prefill's "
              f"and the decode steps' logits at most {max(r0['errs']):.3g} "
              f"of max|logits| off it (bar {TOL_FIT}); flash (f32) "
              f"{n_attn} launches a rank {card}")
    return {"launches": rank0, "launches_phase13": both}


def autotune_phase(dev, card, data, res, fit_args) -> dict:
    """Phase 14: the launch-plan autotuning (`kernels/autotune.py`) under
    a fresh cache directory. 14a: each plan of each swept kernel at phase
    4's shapes (the lasso's and the debias's FISTA step, the fit's rank-n
    update, the logistic gradient at phase 4b's and the large-p point's)
    and at 7c's ingest shape, launched through its wrapper's `block=` and
    held to the plain version (the regression kernels also to the rule's
    bits), timed (events, mean of 20, and graph), then swept, with the
    rule's choice and the winner. 14b: `dsml_fit` on phase 4's data with
    the autotuned plans, bit for bit phase 4's beta_u and support. 14c:
    the same lookups again are memory hits, and after the memory cache is
    cleared disk hits: no sweep (`autotune.cache`). Returns the sweeps by
    kernel and shape, for the record."""
    from repro_torch import obs
    from repro_torch.core import dsml_fit
    from repro_torch.core.engine import power_iteration_batched
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ista_step import ops as ista_ops
    from repro_torch.kernels.logistic_grad import ops as logistic_ops
    from repro_torch.kernels.rank_update import ops as rank_ops
    from repro_torch.launch.timing import graph_ms, time_ms

    t_phase = time.perf_counter()
    old_dir = os.environ.get("REPRO_TORCH_CACHE_DIR")
    tmp = tempfile.TemporaryDirectory(prefix="chip14_")
    os.environ["REPRO_TORCH_CACHE_DIR"] = tmp.name
    autotune.clear_memory_cache()
    obs.reset()

    def events(event: str) -> float:
        return obs.counter_total("autotune.cache", event=event)

    def label(cand) -> str:
        return "x".join(map(str, cand)) if isinstance(cand, tuple) \
            else str(cand)

    def swept(kernel, candidates, lookup):
        """The lookup's winner and each candidate's time in its sweep."""
        def total(cand):
            h = obs.hist_stats("autotune.candidate_us", kernel=kernel,
                               candidate=label(cand))
            return h["sum"] if h else 0.0
        before = {c: total(c) for c in candidates}
        misses = events("miss_sweep")
        won = lookup()
        check(events("miss_sweep") == misses + 1,
              f"14a {kernel}: the first lookup did not sweep")
        return won, {label(c): total(c) - before[c] for c in candidates}

    sweeps = {}

    def each_plan(kernel, shape, candidates, rule, call, plain, kern,
                  lookup, exact):
        want = plain()
        base = call(None)
        times = {}
        for cand in candidates:
            got = call(cand)
            for a, b in zip(got, want):
                err, scale = max_err(a, b)
                check(err <= TOL_KERNEL * scale, f"14a {kernel} {shape} "
                      f"block={cand}: err {err} > {TOL_KERNEL} * {scale}")
            check(not exact or all(torch.equal(a, b)
                                   for a, b in zip(got, base)),
                  f"14a {kernel} {shape} block={cand}: not the rule's bits")
            fn = kern(cand)
            times[label(cand)] = (time_ms(fn), graph_ms(fn)[0])
        won, sweep_us = swept(kernel, candidates, lookup)
        check(won in candidates, f"14a {kernel} {shape}: winner {won}")
        sweeps[f"{kernel} {shape}"] = dict(
            rule=label(rule), winner=label(won), sweep_us=sweep_us,
            events_ms={k: v[0] for k, v in times.items()},
            graph_ms={k: v[1] for k, v in times.items()})
        print(f"phase 14a {kernel} at {shape}: every plan within "
              f"{TOL_KERNEL} * max|plain|"
              f"{' and the rule' + chr(39) + 's bits' if exact else ''}; "
              f"events / graph ms "
              + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                          for k, v in times.items())
              + f"; rule {label(rule)}, sweep winner {label(won)} (sweep "
              f"us: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                  sweep_us.items()) + f") {card}")

    try:
        # ---- 14a. every plan of the FISTA step: phase 4's shapes -------
        Sig, _ = rank_ops.rank_update(data.Xs, data.ys, use_kernel=False)
        etas = 1.0 / torch.clamp_min(power_iteration_batched(Sig), 1e-12)
        lams = torch.full((M,), 0.05, device=dev)
        g = torch.Generator(device=dev).manual_seed(14)
        for r in (1, P):
            z = 0.3 * torch.randn((M, P, r), generator=g, device=dev)
            x = z + 0.1 * torch.randn((M, P, r), generator=g, device=dev)
            c = 0.5 * torch.randn((M, P, r), generator=g, device=dev)
            xn, zn = torch.empty_like(z), torch.empty_like(z)
            args = (Sig, z, x, c, etas, lams, np.float32(0.6))
            rule = ista_ops.kernel_gemv_plan(M, P, dev)[:2] if r == 1 \
                else ista_ops.kernel_gemm_plan(M, P, r, dev)[:2]
            each_plan(
                "fista_step", (M, P, r), autotune.block_candidates(M, P, r),
                rule, lambda b: ista_ops.fista_step_batched(*args, block=b),
                lambda: ista_ops.fista_step_batched(*args, use_kernel=False),
                lambda b: lambda: ista_ops.launch(
                    *args, xn, zn, ista_ops.check_block("14a", r, b)),
                lambda: autotune.autotune_block(M, P, r, device=dev),
                exact=True)
            del z, x, c, xn, zn, args
        del Sig
        # ---- the rank-n update: the fit's and 7c's ingest shapes -------
        for m, n, p in ((M, N, P), INGEST):
            if (m, n, p) == (M, N, P):
                X, y = data.Xs, data.ys
            else:
                X = torch.randn((m, n, p), generator=g, device=dev)
                y = torch.randn((m, n), generator=g, device=dev)
            Sout = torch.empty((m, p, p), device=dev)
            cout = torch.empty((m, p), device=dev)
            tile = rank_ops.kernel_rank_plan(m, p, dev)[0]
            each_plan(
                "rank_update", (m, n, p), autotune.rank_candidates(m, n, p),
                next(t for t in rank_ops.RANK_TILES if t[0] == tile),
                lambda b: rank_ops.rank_update(X, y, block=b),
                lambda: rank_ops.rank_update(X, y, use_kernel=False),
                lambda b: lambda: rank_ops.launch(
                    X, y, None, Sout, cout, rank_ops.check_block("14a", b)),
                lambda: autotune.autotune_rank_block(m, n, p, device=dev),
                exact=True)
            del X, y, Sout, cout
        # ---- the fused logistic gradient: 4b's and the large-p point ---
        sms, optin = logistic_ops._device_limits(dev)
        for m, n, p in ((M, N, P), LARGE_P):
            X = torch.randn((m, n, p), generator=g, device=dev)
            y = torch.where(torch.rand((m, n), generator=g, device=dev)
                            < 0.5, 1.0, -1.0)
            B = torch.randn((m, p), generator=g, device=dev) / np.sqrt(p)
            G = torch.empty((m, p), device=dev)

            def kern(b, m=m, n=n, p=p, X=X, y=y, B=B, G=G):
                pl = logistic_ops.plan(m, n, p, sms, optin, vec=True,
                                       cluster=b)
                work = torch.empty((m, pl.chunks, p), device=dev)
                cnt = torch.zeros(m * b, dtype=torch.int32, device=dev)
                return lambda: logistic_ops.launch(X, y, B, G, work, cnt, b)

            each_plan(
                "logistic_grad", (m, n, p),
                autotune.logistic_candidates(m, n, p),
                logistic_ops.kernel_plan(m, n, p, True, dev)[0].cluster,
                lambda b: (logistic_ops.logistic_grad(X, y, B, block=b),),
                lambda: (logistic_ops.logistic_grad(X, y, B,
                                                    use_kernel=False),),
                kern, lambda: autotune.autotune_logistic_block(
                    m, n, p, device=dev),
                exact=False)
            del X, y, B, G

        # ---- 14b. dsml_fit with the autotuned plans ---------------------
        misses, hits = events("miss_sweep"), events("hit_memory")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = dsml_fit(*fit_args)
        torch.cuda.synchronize()
        fit_ms = (time.perf_counter() - t0) * 1e3
        check(events("miss_sweep") == misses
              and events("hit_memory") == hits + 3,
              "14b: dsml_fit did not find its three plans in memory")
        check(bool(torch.equal(fit.beta_u, res.beta_u))
              and bool(torch.equal(fit.support, res.support)),
              "14b: the autotuned dsml_fit is not phase 4's bits")
        print(f"phase 14b dsml_fit (m={M}, n={N}, p={P}) with the autotuned "
              f"plans (" + ", ".join(
                  f"{k}: {sweeps[k]['winner']}" for k in (
                      f"fista_step {(M, P, 1)}", f"fista_step {(M, P, P)}",
                      f"rank_update {(M, N, P)}")) + f"): beta_u and the "
              f"support bit for bit phase 4's; wall {fit_ms:.1f} ms {card}")

        # ---- 14c. the warm lookups: memory, then disk ------------------
        autotune.clear_memory_cache()
        fit = dsml_fit(*fit_args)
        check(events("miss_sweep") == misses and events("hit_disk") == 3,
              f"14c: after the memory cache was cleared, dsml_fit swept "
              f"({events('miss_sweep') - misses}) or missed the file "
              f"({events('hit_disk')} disk hits)")
        check(bool(torch.equal(fit.beta_u, res.beta_u)),
              "14c: the fit from the file's plans is not phase 4's bits")
        entries = json.loads(autotune.cache_path().read_text())
        check(autotune.cache_path().name == "repro_torch_autotune.json"
              and len(entries) == len(sweeps),
              f"14c: the cache file holds {sorted(entries)}")
        print(f"phase 14c lookups after the sweeps: {events('hit_memory'):.0f}"
              f" memory hits, {events('hit_disk'):.0f} disk hits, "
              f"{events('miss_sweep'):.0f} sweeps in all (one a key, "
              f"{len(entries)} keys in {autotune.cache_path().name}: "
              f"{entries})")
    finally:
        autotune.clear_memory_cache()
        if old_dir is None:
            os.environ.pop("REPRO_TORCH_CACHE_DIR", None)
        else:
            os.environ["REPRO_TORCH_CACHE_DIR"] = old_dir
        tmp.cleanup()
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s {card}")
    return sweeps


def init_params_shapes(cfg):
    """`init_params`' tree for `cfg` on the `meta` device (names and
    shapes, no memory)."""
    from repro_torch.launch.specs import meta_train_state
    return meta_train_state(cfg).params


def hybrid_moe_phase(dev, card) -> dict:
    """Phase 15: the products of granite-4.0-h-small's training cell at
    its shapes, each against its plain version. (a) The held experts'
    grouped products (`moe.grouped_mm`, one `torch.mm` a group) over the
    cell's 20,480 routed rows in 9 groups, one empty, K 4096 -> N 768 and
    768 -> 4096, bf16: y, and through autograd dx and dw, against the
    float64 products group by group (within 1e-2 of max|want|: the
    output's bf16 rounding), with the kernels a call launches and the
    time of the forward and of forward and backward against their bound.
    (b) #9 with its lse at (2, 8192, 32, 8, 128), causal, softmax scale
    1/128, no rotary: against the plain forward at that scale on the f32
    upcast (each row's output within 1e-2 in l2, the lse within 1e-4),
    one launch a call (`LAUNCHES`), its time against the bound and SDPA's
    at the same scale; and the training backward (the plain path) against
    SDPA's. Returns the rows it prints."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_fwd_lse,
    )
    from repro_torch.launch.timing import kernel_launches, time_ms
    from repro_torch.models.layers import flash_attention_train
    from repro_torch.models.moe import grouped_mm
    bf16, f64 = torch.bfloat16, torch.float64
    g = torch.Generator(device=dev).manual_seed(15)
    rows = {}
    counts = [3000, 0, 2500, 1, 4000, 2275, 2300, 2000, 4404]
    R = sum(counts)
    for K, N in ((4096, 768), (768, 4096)):
        x = torch.randn((R, K), generator=g, device=dev).to(bf16)
        w = (torch.randn((len(counts), K, N), generator=g, device=dev)
             * K ** -0.5).to(bf16)
        dy = torch.randn((R, N), generator=g, device=dev).to(bf16)
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = grouped_mm(xs, ws, counts)
        dx, dw = torch.autograd.grad(y, (xs, ws), dy)
        a = 0
        errs = [0.0, 0.0, 0.0]
        y = y.detach()
        for e, n in enumerate(counts):
            if not n:                    # an empty group's dw: zeros
                continue
            xe, dye, we = x[a:a + n].to(f64), dy[a:a + n].to(f64), \
                w[e].to(f64)
            for i, (got, want) in enumerate((
                    (y[a:a + n], xe @ we), (dx[a:a + n], dye @ we.T),
                    (dw[e], xe.T @ dye))):
                scale = max(float(want.abs().max()), 1e-30)
                errs[i] = max(errs[i], float((got.to(f64) - want).abs()
                                             .max()) / scale)
            a += n
        check(max(errs) <= 1e-2 and all(
            bool((dw[e] == 0).all()) for e, n in enumerate(counts) if not n),
            f"15a: grouped products ({K} -> {N}) off the float64 products "
            f"by {errs}")

        def fwd():
            return grouped_mm(x, w, counts)

        def fwd_bwd():
            torch.autograd.grad(grouped_mm(xs, ws, counts), (xs, ws), dy)
        flops = 2.0 * R * K * N
        nbytes = 2 * (R * (K + N) + len(counts) * K * N)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        ms, ms3 = time_ms(fwd), time_ms(fwd_bwd)
        row = {"name": f"grouped_mm_{K}x{N}", "errors": errs,
               "launches": len(kernel_launches(fwd)),
               "launches_fwd_bwd": len(kernel_launches(fwd_bwd)),
               "ms": ms, "fwd_bwd_ms": ms3, "bound_ms": b_ms,
               "bound_by": b_by, "fwd_bwd_bound_ms": 3 * b_ms}
        rows[row["name"]] = row
        print(f"15a {row['name']} {card}: {row['launches']} launches, "
              f"{ms:.4f} ms, bound {b_ms:.4f} ({b_ms / ms:.1%}); forward "
              f"and backward {row['launches_fwd_bwd']} launches, "
              f"{ms3:.4f} ms ({3 * b_ms / ms3:.1%}); errors {errs}")

    B, S, Nh, Kh, H = 2, 8192, 32, 8, 128
    q = torch.randn((B, S, Nh, H), generator=g, device=dev).to(bf16)
    k, v = (torch.randn((B, S, Kh, H), generator=g, device=dev).to(bf16)
            for _ in range(2))
    before = LAUNCHES["flash_attention"]
    out, lse = flash_attention_fwd_lse(q, k, v, scale=1 / 128)
    launches = LAUNCHES["flash_attention"] - before
    want_out, want_lse = flash_attention_fwd_lse(
        q.float(), k.float(), v.float(), scale=1 / 128, use_kernel=False)
    lse_err = float((torch.abs(lse - want_lse)
                     / torch.clamp_min(torch.abs(want_lse), 1.0)).max())
    row_err_ = float((torch.linalg.vector_norm(out.float() - want_out, dim=-1)
                      / torch.linalg.vector_norm(want_out, dim=-1)).max())
    del want_out, want_lse
    check(launches == 1 and lse_err <= 1e-4 and row_err_ <= 1e-2,
          f"15b: #9 at scale 1/128: {launches} launches, lse {lse_err}, "
          f"rows {row_err_}")
    flops = 4.0 * B * Nh * H * flash_pairs(S, True, 0)
    nbytes = 2 * (2 * B * S * Nh * H + 2 * B * S * Kh * H) + 4 * B * Nh * S
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    ms = time_ms(lambda: flash_attention_fwd_lse(q, k, v, scale=1 / 128))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=1 / 128, enable_gqa=True)
    sdpa_ms = time_ms(sdpa)
    dout = torch.randn((B, S, Nh, H), generator=g, device=dev).to(bf16)
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    fwd = flash_attention_train(*ts, scale=1 / 128)
    bwd_ms = time_ms(lambda: torch.autograd.grad(fwd, ts, dout,
                                                 retain_graph=True),
                     reps=3, warm=1)
    so = sdpa()
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        so, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True))
    row = {"name": "flash_attention_lse_granite4h", "launches": launches,
           "lse_err": lse_err, "row_err": row_err_, "ms": ms,
           "bound_ms": b_ms, "bound_by": b_by, "sdpa_ms": sdpa_ms,
           "plain_bwd_ms": bwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms}
    rows[row["name"]] = row
    print(f"15b #9 (2, 8192, 32, 8, 128) causal, scale 1/128 {card}: "
          f"{launches} launch, {ms:.4f} ms, bound {b_ms:.4f} "
          f"({b_ms / ms:.1%}), SDPA {sdpa_ms:.4f}; the plain backward "
          f"{bwd_ms:.2f} ms, SDPA's {sdpa_bwd_ms:.4f}; lse {lse_err:.2e}, "
          f"rows {row_err_:.2e}")
    print(json.dumps({"phase15": rows}))
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on an NVIDIA card")
    from repro_torch.core import (
        dirty_model, dsml_fit, dsml_logistic_fit, gen_classification,
        gen_regression, group_lasso, hamming, icap, solve_lasso_eq2_grid,
    )
    from repro_torch.core.engine import (
        power_iteration_batched, scaled_identity_m0, solve_lasso_batched,
    )
    from repro_torch.core.solvers import lasso_stats_step_scale
    from repro_torch import obs
    from repro_torch.kernels import _build
    from repro_torch.configs import get_config
    from repro_torch.obs import torchprof
    from repro_torch.launch.timing import (
        device_kernel_names, graph_ms, kernel_launches, sdpa_yardstick,
        time_ms, time_ms_cold,
    )
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.group_threshold import ops as threshold_ops
    from repro_torch.kernels.group_threshold.ops import group_threshold
    from repro_torch.kernels.group_threshold.ref import group_threshold_ref
    from repro_torch.kernels.ista_step import ops as ista_ops
    from repro_torch.kernels.ista_step.ops import (
        fista_step_batched, fista_step_grid, ista_solve, ista_step,
        ista_step_batched,
    )
    from repro_torch.kernels.ista_step.ref import (
        fista_step_batched_ref, fista_step_grid_ref, ista_step_batched_ref,
        ista_step_ref,
    )
    from repro_torch.kernels.logistic_grad import ops as logistic_ops
    from repro_torch.kernels.logistic_grad.ops import (
        logistic_grad, logistic_grad_unfused,
    )
    from repro_torch.kernels.logistic_grad.ref import logistic_grad_ref
    from repro_torch.kernels.rank_update import ops as rank_ops
    from repro_torch.kernels.rank_update.ops import (
        rank_update, rank_update_unfused,
    )
    from repro_torch.kernels.rank_update.ref import (
        rank_c_ref, rank_sigma_ref, rank_update_ref,
    )
    from repro_torch.serving import cell

    dev = torch.device("cuda")
    # the engine's autotuned plans (`kernels/autotune.py`) are timed into a
    # cache of this run's own, which the ranks of phases 8-13 inherit
    run_cache = tempfile.TemporaryDirectory(prefix="chip_autotune_")
    os.environ["REPRO_TORCH_CACHE_DIR"] = run_cache.name

    t_start = time.perf_counter()
    # ---- 1. the card ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind} x{count}; nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 2")
    # ---- 2. build ---------------------------------------------------------
    # from scratch, so that every source compiles here and its spills are
    # checked; the ranks of phase 8 load these libraries as they are
    for old in _build.BUILD_DIR.glob("lib*"):
        old.unlink()
    t0 = time.perf_counter()
    _build.build()
    check(sorted(_build.BUILD_LOG) == sorted(
        src.stem for src in _build.CSRC.glob("*.cu")),
        f"phase 2 compiled {sorted(_build.BUILD_LOG)}")
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc per source: {_build.BUILD_SECONDS})")
    for src, log in _build.BUILD_LOG.items():
        print(f"ptxas {src}.cu:")
        for line in ptxas_lines(log):
            print(line)
            if any(k in line for k in ("fista_gemm_kernel",
                                       "fista_gemv_kernel",
                                       "rank_update_kernel",
                                       "logistic_grad_kernel",
                                       "logistic_grad_rows_kernel",
                                       "logistic_residual_kernel",
                                       "logistic_backproject_kernel",
                                       "group_threshold_kernel",
                                       "flash_fwd_wgmma",
                                       "flash_fwd_tf32x3")):
                check(" 0 bytes spill stores" in line,
                      f"a redesigned kernel spills: {line}")
    flash_log = "\n".join(ptxas_lines(_build.BUILD_LOG["flash_attention"]))
    built = {name: sorted(set(re.findall(name + r"ILi(\d+)E", flash_log)),
                          key=int)
             for name in ("flash_fwd_wgmma", "flash_fwd_tf32x3")}
    check(all(h == ["64", "128", "256"] for h in built.values()) and
          "flash_fwd_kernel" not in flash_log,
          f"flash_attention.cu built {built} and the old f32 body: "
          f"{'flash_fwd_kernel' in flash_log}")
    # the f32 body's products run on the tensor cores, as TF32 HMMA
    hmma = tf32_hmma(_build.BUILD_DIR / "libflash_attention.so")
    check(sorted(hmma, key=int) == ["64", "128", "256"] and
          all(hmma.values()), f"flash_fwd_tf32x3's TF32 HMMA by H: {hmma}")
    print(f"SASS flash_fwd_tf32x3: TF32 HMMA instructions by H {hmma}")

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 3")
    # ---- 3. kernel vs plain -----------------------------------------------
    g = torch.Generator(device=dev).manual_seed(1)
    errs: dict[str, float] = {}

    def rank_inputs(m, n, p):
        X = torch.randn((m, n, p), generator=g, device=dev)
        y = torch.randn((m, n), generator=g, device=dev)
        w = 0.5 + torch.rand((m, n), generator=g, device=dev)
        return X, y, w

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem_optin = torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin

    def check_rank(label, X, y, w):
        """The fused kernel against its plain version; Sigma exactly
        symmetric and the unfused pair's Sigma bitwise the fused one's;
        the launcher's tile held to `rank_plan`."""
        m, _, p = X.shape
        plan = rank_ops.rank_plan(m, p, sms)
        check(rank_ops.kernel_rank_plan(m, p, dev) ==
              (plan.tile, plan.blocks, sms), f"rank_update tile at {label}: "
              f"the launcher's differs from rank_plan's {plan}")
        got = rank_update(X, y, w, use_kernel=True)
        ref = rank_update(X, y, w, use_kernel=False)
        unf = rank_update_unfused(X, y, w, use_kernel=True)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, b in zip(("Sigma", "c"), got, ref):
            err, scale = max_err(a, b)
            check(err <= TOL_KERNEL * scale,
                  f"rank_update {label} {name}: err {err} > "
                  f"{TOL_KERNEL} * {scale}")
            worst = max(worst, err)
        check(bool(torch.equal(got[0], got[0].mT)),
              f"rank_update {label}: Sigma not exactly symmetric")
        check(bool(torch.equal(unf[0], got[0])), f"rank_update {label}: the "
              "unfused Sigma differs from the fused one")
        print(f"check rank_update {label}: max abs err {worst:.3g}; Sigma "
              f"exactly symmetric, the unfused Sigma the same bits; "
              f"{plan.tile} x {plan.tile} tiles, {plan.blocks} blocks of "
              f"{plan.threads} threads on {sms} SMs")
        return worst

    X, y, w = rank_inputs(M, N, P)
    errs["rank_update"] = check_rank(f"({M},{N},{P})", X, y, None)
    errs["rank_update_weighted"] = check_rank(f"({M},{N},{P}) weighted",
                                              X, y, w)
    Xr, yr, wr = rank_inputs(3, 500, 1000)
    check_rank("(3,500,1000)", Xr, yr, None)
    check_rank("(3,500,1000) weighted", Xr, yr, wr)
    Xi, yi, _ = rank_inputs(*INGEST)
    errs["rank_update_ingest"] = check_rank("({},{},{})".format(*INGEST), Xi,
                                            yi, None)
    check_rank("(2,7,129) weighted", *rank_inputs(2, 7, 129))

    def fista_inputs(Sigmas, r, lam):
        m, p, _ = Sigmas.shape
        etas = 1.0 / torch.clamp_min(power_iteration_batched(Sigmas), 1e-12)
        z = 0.05 * torch.randn((m, p, r), generator=g, device=dev)
        x = z + 0.01 * torch.randn((m, p, r), generator=g, device=dev)
        c = (torch.eye(p, device=dev).expand(m, p, p).contiguous() if r == p
             else 0.1 * torch.randn((m, p, r), generator=g, device=dev))
        lams = torch.full((m,), lam, device=dev)
        return Sigmas, z, x, c, etas, lams, np.float32(0.7)

    def check_fista(label, args):
        got = fista_step_batched(*args, use_kernel=True)
        ref = fista_step_batched(*args, use_kernel=False)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, b in zip(("x_next", "z_next"), got, ref):
            err, scale = max_err(a, b)
            check(err <= TOL_KERNEL * scale,
                  f"fista_step_batched {label} {name}: err {err} > "
                  f"{TOL_KERNEL} * {scale}")
            worst = max(worst, err)
        print(f"check fista_step_batched {label}: max abs err {worst:.3g}")
        return worst

    Sig, _ = rank_update(X, y, use_kernel=False)
    lam = 4.0 * float(np.sqrt(np.log(P) / N))
    mu = float(np.sqrt(np.log(P) / N))
    gemv_args = fista_inputs(Sig, 1, 0.5 * lam)
    gemm_args = fista_inputs(Sig, P, mu)
    errs["fista_step_gemv"] = check_fista(f"r=1 p={P}", gemv_args)
    errs["fista_step_gemm"] = check_fista(f"r=p={P}", gemm_args)
    Sig_r, _ = rank_update(Xr, yr, use_kernel=False)
    check_fista("r=1 p=1000", fista_inputs(Sig_r, 1, 0.5 * lam))
    check_fista("r=p=1000", fista_inputs(Sig_r, 1000, mu))
    # #1b at the fit cell's shape: the plain version's bar, and the bits of
    # the 128 x 64 tile (every output one FMA chain over k in order)
    # (a generator of its own, so that the draws after it keep theirs)
    g_1b = torch.Generator(device=dev).manual_seed(35)
    m_1b, p_1b, _ = CELL_1B
    X_1b = torch.randn((m_1b, 120, p_1b), generator=g_1b, device=dev)
    Sig_1b = torch.bmm(X_1b.mT, X_1b) / 120
    z_1b = 0.05 * torch.randn(CELL_1B, generator=g_1b, device=dev)
    args_1b = (Sig_1b, z_1b,
               z_1b + 0.01 * torch.randn(CELL_1B, generator=g_1b, device=dev),
               torch.eye(p_1b, device=dev).expand(*CELL_1B).contiguous(),
               1.0 / torch.clamp_min(power_iteration_batched(Sig_1b), 1e-12),
               torch.full((m_1b,), mu, device=dev), np.float32(0.7))
    del X_1b, z_1b
    errs["fista_step_gemm_p200"] = check_fista(
        "r=p={}, {} tasks".format(CELL_1B[1], CELL_1B[0]), args_1b)
    tile_1b = ista_ops.kernel_gemm_plan(*CELL_1B, dev)[:2]
    check(all(torch.equal(a, b) for a, b in zip(
        fista_step_batched(*args_1b),
        fista_step_batched(*args_1b, block=(128, 64)))),
        f"fista_step_batched at {CELL_1B}: the rule's {tile_1b} tile does "
        "not give the bits of 128 x 64")
    print(f"check fista_step_batched at {CELL_1B}: the rule's "
          f"{tile_1b[0]} x {tile_1b[1]} tile gives the bits of 128 x 64")

    def grid_inputs(Sigmas, k, lam):
        """The lambda grid's step on `Sigmas` at k values of lambda up to
        `lam`, and the same k m problems tiled for the r == 1 kernel."""
        m, p, _ = Sigmas.shape
        etas = 1.0 / torch.clamp_min(power_iteration_batched(Sigmas), 1e-12)
        z = 0.05 * torch.randn((k, m, p), generator=g, device=dev)
        x = z + 0.01 * torch.randn((k, m, p), generator=g, device=dev)
        c = 0.1 * torch.randn((m, p), generator=g, device=dev)
        lams = lam * torch.logspace(-1, 0, k, device=dev)
        theta = np.float32(0.7)
        tiled = (Sigmas.repeat(k, 1, 1), z.reshape(k * m, p, 1),
                 x.reshape(k * m, p, 1), c.repeat(k, 1)[..., None],
                 etas.repeat(k), lams.repeat_interleave(m), theta)
        return (Sigmas, z, x, c, etas, lams, theta), tiled

    def check_grid(label, args, tiled):
        """The grid's step against its plain version, and the same bits as
        the r == 1 kernel on the tiled problems."""
        got = fista_step_grid(*args, use_kernel=True)
        want = fista_step_batched(*tiled, use_kernel=True)
        ref = fista_step_grid(*args, use_kernel=False)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, w, b in zip(("x_next", "z_next"), got, want, ref):
            check(bool(torch.equal(a, w.reshape(a.shape))),
                  f"fista_step_grid {label} {name}: not the tiled launch's "
                  "bits")
            err, scale = max_err(a, b)
            check(err <= TOL_KERNEL * scale,
                  f"fista_step_grid {label} {name}: err {err} > "
                  f"{TOL_KERNEL} * {scale}")
            worst = max(worst, err)
        print(f"check fista_step_grid {label}: the tiled launch's bits; max "
              f"abs err vs plain {worst:.3g}")
        return worst

    # the benchmark's lambda-grid cell: 1024 tasks at p 200, 8 lambdas
    Xg = torch.randn((GRID_CELL[0], 2 * GRID_CELL[1], GRID_CELL[1]),
                     generator=g, device=dev)
    Sig_g = torch.einsum("tni,tnj->tij", Xg, Xg) / (2 * GRID_CELL[1])
    del Xg
    grid_args, grid_tiled = grid_inputs(Sig_g, GRID_CELL[2], 0.5 * lam)
    grid4c_args, grid4c_tiled = grid_inputs(Sig, 8, 0.5 * lam)
    errs["fista_step_gemv_grid"] = check_grid(
        "({},{},k {})".format(*GRID_CELL), grid_args, grid_tiled)
    errs["fista_step_gemv_grid_4c"] = check_grid(
        f"({M},{P},k 8)", grid4c_args, grid4c_tiled)
    for shape in ((M, P), (1, P), (3, 1000), (8 * M, P)):
        plan = ista_ops.gemv_plan(*shape, sms)
        check(ista_ops.kernel_gemv_plan(*shape, dev) ==
              (plan.rows_per_warp, plan.warps, sms),
              f"GEMV plan at {shape}: the launcher's differs from "
              f"gemv_plan's {plan}")
        print(f"GEMV plan at {shape}: {plan} on {sms} SMs")
    for shape in ((M, P, P), (1, P, P), (3, 1000, 1000), (3, 129, 7)):
        plan = ista_ops.gemm_plan(*shape, sms)
        check(ista_ops.kernel_gemm_plan(*shape, dev) == (plan.bm, plan.bn,
                                                         sms),
              f"SGEMM tile at {shape}: the launcher's differs from "
              f"gemm_plan's {plan}")
        print(f"SGEMM tile at {shape}: {plan.bm} x {plan.bn}, "
              f"{plan.blocks} blocks of {plan.threads} threads on {sms} SMs")
    check(ista_ops.kernel_gemm_tiles() == ista_ops.GEMM_TILES,
          f"the library's SGEMM tiles {ista_ops.kernel_gemm_tiles()} are "
          f"not GEMM_TILES {ista_ops.GEMM_TILES}")

    def logistic_inputs(m, n, p):
        X = torch.randn((m, n, p), generator=g, device=dev)
        y = torch.where(torch.rand((m, n), generator=g, device=dev) < 0.5,
                        1.0, -1.0)
        B = torch.randn((m, p), generator=g, device=dev) / float(np.sqrt(p))
        return X, y, B

    def check_logistic(label, args):
        """Both kernels against their plain version, twice for the same
        bits; the fused kernel's plan held to `plan` as its launcher
        chooses it and as it launched it; the unfused pair's plan held to
        `unfused_plan`, and one call of it launching each of its two
        kernels once."""
        m_, n_, p_ = args[0].shape
        vec = logistic_ops.vectorized(args[0], args[2])
        fplan = logistic_ops.plan(m_, n_, p_, sms, smem_optin, vec=vec)
        check(logistic_ops.kernel_plan(m_, n_, p_, vec, dev) ==
              (fplan, sms), f"fused plan at {label}: the launcher's "
              f"differs from plan's {fplan}")
        G_ = torch.empty((m_, p_), device=dev)
        ran = logistic_ops.launch(
            *args, G_, torch.empty((m_, fplan.chunks, p_), device=dev),
            logistic_ops.ticket_counters(dev, m_ * fplan.cluster))
        check(ran == fplan, f"fused kernel at {label} ran {ran}, not the "
              f"plan {fplan}")
        print(f"fused plan at {label}: {ran} ("
              + (f"a cluster launch of {ran.cluster} blocks a cluster, "
                 if ran.cluster > 1 else "no cluster, ")
              + f"{m_ * ran.chunks * ran.cluster} blocks)")
        plan = logistic_ops.unfused_plan(m_, n_, p_, sms)
        check(logistic_ops.kernel_unfused_plan(m_, n_, p_, dev) ==
              (plan.rows_per_warp, plan.warps_per_row, plan.cols, sms),
              f"unfused plan at "
              f"{label}: the launcher's differs from unfused_plan's {plan}")
        print(f"unfused plan at {label}: {plan}")
        worst = []
        for name, fn in (("logistic_grad", logistic_grad),
                         ("logistic_grad_unfused", logistic_grad_unfused)):
            before = dict(LAUNCHES)
            got = fn(*args, use_kernel=True)
            if name == "logistic_grad_unfused":
                check(all(LAUNCHES[k] == before[k] + 1 for k in (
                    "logistic_z", "logistic_backproject")),
                    f"{name} {label}: not one launch of each kernel")
            again = fn(*args, use_kernel=True)
            ref = fn(*args, use_kernel=False)
            torch.cuda.synchronize()
            err, scale = max_err(got, ref)
            check(err <= TOL_KERNEL * scale,
                  f"{name} {label}: err {err} > {TOL_KERNEL} * {scale}")
            check(bool(torch.equal(got, again)),
                  f"{name} {label}: two launches gave different bits")
            print(f"check {name} {label}: max abs err {err:.3g} "
                  f"(max|plain| {scale:.3g}), same bits on a second launch")
            worst.append(err)
        return worst

    lg_args = logistic_inputs(M, N, P)
    lg_large = logistic_inputs(*LARGE_P)
    (errs["logistic_grad"],
     errs["logistic_grad_unfused"]) = check_logistic(f"({M},{N},{P})",
                                                     lg_args)
    (errs["logistic_grad_p8192"],
     errs["logistic_grad_unfused_p8192"]) = check_logistic(
         "({},{},{})".format(*LARGE_P), lg_large)
    check_logistic("(3,500,1000)", logistic_inputs(3, 500, 1000))
    check_logistic("(2,7,129)", logistic_inputs(2, 7, 129))
    # the fused kernel's other modes: a shared-memory ring, X read twice
    check_logistic("(4,256,19329)", logistic_inputs(4, 256, 19329))
    check_logistic("(1,8,100003)", logistic_inputs(1, 8, 100003))
    torch.cuda.synchronize()
    check(int(logistic_ops.ticket_counters(dev, 1).abs().sum()) == 0,
          "the fused kernel left a ticket counter above zero")

    def check_kernel(name, label, fn, *args):
        """`fn` launched twice and on its plain path; every float output
        within TOL_KERNEL * max|plain|, every other output equal, and the
        two launches the same bits. Returns the max abs error."""
        def outs(use_kernel):
            out = fn(*args, use_kernel=use_kernel)
            return out if isinstance(out, tuple) else (out,)
        got, again, ref = outs(True), outs(True), outs(False)
        torch.cuda.synchronize()
        worst = 0.0
        for a, b in zip(got, ref):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{name} {label}: shape or dtype")
            if a.is_floating_point():
                err, scale = max_err(a.float(), b.float())
                check(err <= TOL_KERNEL * scale,
                      f"{name} {label}: err {err} > {TOL_KERNEL} * {scale}")
                worst = max(worst, err)
            else:
                check(bool(torch.equal(a, b)), f"{name} {label}: differs")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name} {label}: two launches gave different bits")
        print(f"check {name} {label}: max abs err {worst:.3g}, same bits "
              "on a second launch")
        return worst

    def ista_inputs(Sigmas, r, lam):
        m, p, _ = Sigmas.shape
        etas = 1.0 / torch.clamp_min(power_iteration_batched(Sigmas), 1e-12)
        b = 0.05 * torch.randn((m, p, r), generator=g, device=dev)
        c = (torch.eye(p, device=dev).expand(m, p, p).contiguous() if r == p
             else 0.1 * torch.randn((m, p, r), generator=g, device=dev))
        return Sigmas, b, c, etas, torch.full((m,), lam, device=dev)

    def single(args):
        Sigmas, b, c, etas, lams = args
        return Sigmas[0], b[0], c[0], etas[0], lams[0]

    isb_gemv = ista_inputs(Sig, 1, 0.5 * lam)
    isb_gemm = ista_inputs(Sig, P, mu)
    errs["ista_step_batched_gemv"] = check_kernel(
        "ista_step_batched", f"r=1 p={P}", ista_step_batched, *isb_gemv)
    errs["ista_step_batched_gemm"] = check_kernel(
        "ista_step_batched", f"r=p={P}", ista_step_batched, *isb_gemm)
    errs["ista_step_gemv"] = check_kernel(
        "ista_step", f"r=1 p={P}", ista_step, *single(isb_gemv))
    errs["ista_step_gemm"] = check_kernel(
        "ista_step", f"r=p={P}", ista_step, *single(isb_gemm))
    Xg, yg, _ = rank_inputs(3, 200, 129)
    Sig_g, _ = rank_update(Xg, yg, use_kernel=False)
    for r in (1, 7):
        rag = ista_inputs(Sig_g, r, 0.1)
        check_kernel("ista_step_batched", f"m=3 p=129 r={r}",
                     ista_step_batched, *rag)
        check_kernel("ista_step", f"p=129 r={r}", ista_step, *single(rag))
    errs["rank_update_sigma"] = errs["rank_update_c"] = check_kernel(
        "rank_update_unfused", f"({M},{N},{P})", rank_update_unfused, X, y)
    check_kernel("rank_update_unfused", f"({M},{N},{P}) weighted",
                 rank_update_unfused, X, y, w)
    Xs2, ys2, ws2 = rank_inputs(2, 7, 129)
    check_kernel("rank_update_unfused", "(2,7,129)", rank_update_unfused,
                 Xs2, ys2)
    check_kernel("rank_update_unfused", "(2,7,129) weighted",
                 rank_update_unfused, Xs2, ys2, ws2)

    def threshold_input(p, m, dtype=torch.float32):
        scale = 0.1 + 2.0 * torch.rand((p, 1), generator=g, device=dev)
        B = torch.randn((p, m), generator=g, device=dev) * scale
        return (B / float(np.sqrt(m))).to(dtype)

    check(all(threshold_ops.kernel_row_lanes(v) == threshold_ops.row_lanes(v)
              for v in range(1, 70)),
          "group_threshold: the launcher's lanes a row differ from "
          "row_lanes'")
    B_gt = threshold_input(P, M)
    errs["group_threshold"] = check_kernel(
        "group_threshold", f"({P},{M})", group_threshold, B_gt, 0.8)
    check_kernel("group_threshold", f"({P},{M}) bf16", group_threshold,
                 threshold_input(P, M, torch.bfloat16), 0.8)
    check_kernel("group_threshold", "(1001,5)", group_threshold,
                 threshold_input(1001, 5), 0.8)
    check_kernel("group_threshold", "(1001,5) bf16", group_threshold,
                 threshold_input(1001, 5, torch.bfloat16), 0.8)

    def flash_inputs(b, s, n, k, h, dtype, t=None):
        t = s if t is None else t
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, s, n, h), (b, t, k, h), (b, t, k, h)))

    def check_flash(shape, dtype, causal=True, window=0, t=None):
        """The kernel twice and the plain version on the f32 upcast of the
        same inputs (T = t keys, S by default); every query row within
        TOL_FLASH_ROW[dtype] of the plain row (relative l2) and, in f32,
        max abs error <= TOL_FLASH * max|plain|. The training forward
        (`flash_attention_fwd_lse`) twice: its output the serving call's
        bits, its lse the same bits on a second launch and within
        TOL_LSE[dtype] * max(1, |lse|) of the plain lse."""
        qkv = flash_inputs(*shape, dtype, t)
        got = flash_attention(*qkv, causal=causal, window=window,
                              use_kernel=True)
        again = flash_attention(*qkv, causal=causal, window=window,
                                use_kernel=True)
        lse_out, lse = flash_ops.flash_attention_fwd_lse(
            *qkv, causal=causal, window=window, use_kernel=True)
        _, lse_again = flash_ops.flash_attention_fwd_lse(
            *qkv, causal=causal, window=window, use_kernel=True)
        ref, lse_ref = flash_ops.flash_attention_fwd_lse(
            *(t.float() for t in qkv), causal=causal, window=window,
            use_kernel=False)
        torch.cuda.synchronize()
        label = (f"{shape} {str(dtype).split('.')[-1]} causal={causal} "
                 f"window={window}" + (f" T={t}" if t is not None else ""))
        check(got.shape == ref.shape and got.dtype == dtype,
              f"flash_attention {label}: shape or dtype")
        err, scale = max_err(got.float(), ref)
        rows = row_err(got.float(), ref)
        check(rows <= TOL_FLASH_ROW[dtype], f"flash_attention {label}: a "
              f"row's relative error {rows} > {TOL_FLASH_ROW[dtype]}")
        check(dtype != f32 or err <= TOL_FLASH * scale, f"flash_attention "
              f"{label}: err {err} > {TOL_FLASH} * {scale}")
        check(bool(torch.equal(got, again)),
              f"flash_attention {label}: two launches gave different bits")
        check(bool(torch.equal(lse_out, got)), f"flash_attention {label}: "
              "the lse launch's output is not the serving call's bits")
        check(bool(torch.equal(lse, lse_again)), f"flash_attention {label}:"
              " two lse launches gave different bits")
        lse_err = (torch.abs(lse - lse_ref)
                   / torch.clamp_min(torch.abs(lse_ref), 1.0)).max().item()
        lse_abs[(shape, dtype)] = torch.max(torch.abs(lse - lse_ref)).item()
        check(lse_err <= TOL_LSE[dtype], f"flash_attention {label}: lse "
              f"error {lse_err} > {TOL_LSE[dtype]} * max(1, |lse|)")
        print(f"check flash_attention {label}: worst row relative err "
              f"{rows:.3g} (bar {TOL_FLASH_ROW[dtype]:g}), max abs err "
              f"{err:.3g} (max|plain| {scale:.3g}), same bits on a second "
              f"launch; lse err {lse_err:.3g} of max(1, |lse|) (bar "
              f"{TOL_LSE[dtype]:g}), the serving call's output bits, the "
              "same lse bits twice")
        return err, qkv

    f32, bf16 = torch.float32, torch.bfloat16
    serve_cfg = get_config(cell.ARCH)
    flash_path = (cell.BATCH, cell.PROMPT, serve_cfg.n_heads,
                  serve_cfg.n_kv_heads, serve_cfg.resolved_head_dim)
    lse_abs: dict = {}            # (shape, dtype) -> max |lse - plain|
    check_flash((2, 256, 8, 2, 64), f32)
    check_flash((1, 200, 4, 1, 128), f32)
    check_flash((1, 512, 4, 1, 256), f32, window=64)
    check_flash((2, 256, 8, 2, 64), f32, causal=False)
    # the f32 copies' instances (10b with its lse, 6, 9a, 13c-rg's rank)
    f32_flash, f32_qkv = f32_flash_shapes(), {}
    for name, (shape, window, lse) in f32_flash.items():
        err, f32_qkv[name] = check_flash(shape, f32, window=window)
        errs[name] = lse_abs[(shape, f32)] if lse else err
    errs["flash_attention"], flash_qkv = check_flash(flash_path, bf16)
    errs["flash_attention_lse"] = lse_abs[(flash_path, bf16)]
    errs["flash_attention_h128"], flash_qkv128 = check_flash(FLASH_H128, bf16)
    # the sharded train step's per-rank shape (phase 11a): granite's q and
    # kv heads split over a model axis of TP_MODEL
    flash_tp = (cell.BATCH, cell.PROMPT, serve_cfg.n_heads // TP_MODEL,
                serve_cfg.n_kv_heads // TP_MODEL,
                serve_cfg.resolved_head_dim)
    _, flash_qkv_tp = check_flash(flash_tp, bf16)
    errs["flash_attention_lse_tp2"] = lse_abs[(flash_tp, bf16)]
    # phase 12's per-rank instances: deepseek-moe-16b's and
    # qwen3-moe-30b-a3b's H = 128 heads, recurrentgemma-9b's H = 256 with
    # its one replicated kv head and its window, each with the lse
    zoo12_flash, zoo12_qkv = zoo12_flash_shapes(), {}
    for name, (shape, window) in zoo12_flash.items():
        _, zoo12_qkv[name] = check_flash(shape, bf16, window=window)
        errs[name] = lse_abs[(shape, bf16)]
    # phase 13's per-rank instances, without the lse: the sharded
    # prefills of granite-3-2b, deepseek-moe-16b, recurrentgemma-9b,
    # internvl2-2b and seamless-m4t-medium's encoder
    serve13_flash, serve13_qkv = serve13_flash_shapes(), {}
    for name, (shape, causal, window) in serve13_flash.items():
        errs[name], serve13_qkv[name] = check_flash(
            shape, bf16, causal=causal, window=window)
    # the shapes of phase 9's prefills: H = 128 with G = 1 and 2, H = 256
    # with one kv head and a window, and the encoder's non-causal H = 64
    zoo_flash, zoo_qkv = zoo_flash_shapes(get_config), {}
    for name, (shape, causal, window) in zoo_flash.items():
        errs[name], zoo_qkv[name] = check_flash(shape, bf16, causal=causal,
                                                window=window)
    # phase 10c's instances with the lse: internvl2-2b's over its patches
    # and seamless-m4t-medium's non-causal encoder are phase 9's prefill
    # shapes and minitron-4b's is FLASH_H128, each checked above with its
    # lse; the seamless decoder's is new
    checked = {(FLASH_H128, True): flash_qkv128,
               **{(z[0], z[1]): zoo_qkv[name] for name, z in zoo_flash.items()
                  if not z[2]}}
    train10c_flash, train10c_qkv = train10c_flash_shapes(), {}
    for name, (shape, causal) in train10c_flash.items():
        if (shape, causal) not in checked:
            _, checked[(shape, causal)] = check_flash(shape, bf16,
                                                      causal=causal)
        train10c_qkv[name] = checked[(shape, causal)]
        errs[name] = lse_abs[(shape, bf16)]
        print(f"check {name} {shape} causal={causal}: the output and the "
              f"lse held above, max |lse - plain| {errs[name]:.3g}")
    check_flash((1, 200, 4, 1, 128), bf16)
    check_flash((1, 512, 4, 1, 256), bf16, window=64)
    check_flash((1, 300, 4, 2, 64), bf16, window=40)
    # H = 256 (64-key tiles) beside the zoo's recurrentgemma-9b row above:
    # a ragged non-causal S against T, and a window cutting the tiles
    check_flash((1, 300, 4, 1, 256), bf16, causal=False, t=333)
    check_flash((1, 700, 4, 2, 256), bf16, window=96)
    # rows s >= 149 see no key (non-causal, window 50, T = 100): lse -1e30
    for dtype in (f32, bf16):
        check_flash((1, 300, 4, 2, 64), dtype, causal=False, window=50,
                    t=100)
    # every bf16 call runs the Hopper design of its head dim, and nothing
    # of the f32 body
    h256_shape, _, h256_window = zoo_flash["flash_attention_h256"]
    for shape, qkv, window in ((flash_path, flash_qkv, 0),
                               (FLASH_H128, flash_qkv128, 0),
                               (h256_shape, zoo_qkv["flash_attention_h256"],
                                h256_window)):
        names = device_kernel_names(
            lambda: flash_attention(*qkv, window=window))
        check([n for n in names if "flash" in n] == [
            n for n in names if f"flash_fwd_wgmma<{shape[4]}>" in n] != [],
            f"flash_attention {shape} bf16 ran {names}")
        fb_, fs_, fn_, _, fh_ = shape
        print(f"flash launch at {shape} bf16: "
              f"{flash_ops.launch_plan(fb_, fs_, fn_, fh_, bf16)}; runs "
              f"{[n for n in names if 'flash' in n]}")

    # and every f32 call the 3xTF32 body of its head dim alone, launched
    # as `launch_plan` says
    for name, (shape, window, _) in f32_flash.items():
        runs = kernel_launches(
            lambda: flash_attention(*f32_qkv[name], window=window))
        fb_, fs_, fn_, _, fh_ = shape
        plan = flash_ops.launch_plan(fb_, fs_, fn_, fh_, f32)
        want = {"grid": [fb_ * fn_, -(-fs_ // plan.rows), 1],
                "block": [plan.threads, 1, 1], "smem": plan.smem_bytes}
        check(plan.design == "tf32x3" and len(runs) == 1 and
              f"flash_fwd_tf32x3<{fh_}>" in runs[0]["name"] and
              {k: runs[0][k] for k in want} == want,
              f"flash_attention {shape} f32 ran {runs}, its plan {plan}")
        print(f"flash launch at {shape} f32: {plan}; runs {runs}")

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 4")
    # ---- 4. the main path at full width -----------------------------------
    data = gen_regression(torch.Generator(device=dev).manual_seed(0),
                          m=M, n=N, p=P, s=S, signal_low=0.3, device=dev)
    Lam = 1.0
    fit_args = (data.Xs, data.ys, lam, mu, Lam)
    dsml_fit(*fit_args)                                  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = dsml_fit(*fit_args)
    torch.cuda.synchronize()
    fit_kernel_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    print(f"main path launches: {launches}")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rank_update=1, fista_step_gemv=400, fista_step_gemm=600)
    check(launches == want,
          f"dsml_fit did not run through the kernels as expected: {launches}")

    t0 = time.perf_counter()
    ref = dsml_fit(*fit_args, use_kernel=False)
    torch.cuda.synchronize()
    fit_plain_s = time.perf_counter() - t0
    check(dict(LAUNCHES) == launches, "the plain path launched a kernel")

    for name, t in zip(res._fields, res):
        check(t.shape == getattr(ref, name).shape, f"{name} shape")
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
    err, scale = max_err(res.beta_u, ref.beta_u)
    check(err <= TOL_FIT * scale,
          f"dsml_fit beta_u: err {err} > {TOL_FIT} * {scale}")
    check(bool(torch.equal(res.support, ref.support)), "supports differ")
    norms = torch.linalg.vector_norm(res.beta_u.T, dim=-1)
    margin = torch.min(torch.abs(norms - Lam)).item()
    ham = int(hamming(res.support, data.support))
    print(f"dsml_fit (m={M}, n={N}, p={P}, s={S}): beta_u max abs err vs "
          f"plain {err:.3g} (max|beta_u| {scale:.3g}); support size "
          f"{int(res.support.sum())}, identical; threshold margin "
          f"{margin:.4g}; hamming to the true support {ham}")
    print(f"dsml_fit wall: kernels {fit_kernel_s * 1e3:.1f} ms, plain "
          f"{fit_plain_s * 1e3:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB {card}")
    # 4a. one fit traced: its device work and the card's idle charged to
    # the engine's spans, and its solve and plan records
    obs.reset()
    torch.cuda.synchronize()
    with torchprof.span_trace() as box:
        dsml_fit(*fit_args)
        torch.cuda.synchronize()
    ch = box["charge"]
    check(ch.launched_s >= 0.99 * ch.device_s,
          f"4a: {ch.launched_s} of {ch.device_s} s matched to a launch")
    fit_s = ch.spans.get("dsml.fit", (0.0, 0.0))[1]
    check(abs(fit_s - ch.busy_s) <= 0.01 * ch.busy_s,
          f"4a: dsml.fit holds {fit_s} s of the {ch.busy_s} s busy")
    solves, routes = solve_records(obs), route_records(obs)
    check(solves == {"lasso_eq2": (1, 400, 400, 0),
                     "debias": (1, 600, 600, 0)}, f"4a: solves {solves}")
    by_kernel: dict = {}
    for (kernel, outcome, _), n in routes.items():
        by_kernel[kernel, outcome] = by_kernel.get((kernel, outcome), 0) + n
    check(by_kernel == {("fista_step_batched", "kernel"): 2,
                        ("rank_update", "kernel"): 1}, f"4a: routes {routes}")
    for line in charge_lines("dsml_fit traced", ch):
        print(f"{line} {card}")
    print(f"dsml_fit records: solves {solves} (calls, iterations, ceiling, "
          f"early exits); plans {routes}")

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 4b")
    # ---- 4b. the logistic path at full width ------------------------------
    cdata = gen_classification(torch.Generator(device=dev).manual_seed(0),
                               m=M, n=N, p=P, s=S, device=dev)
    lam_c = float(np.sqrt(np.log(P) / N))
    Lam_c = 0.75
    cfit_args = (cdata.Xs, cdata.ys, lam_c, 2.0 * lam_c, Lam_c)
    dsml_logistic_fit(*cfit_args)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    cres = dsml_logistic_fit(*cfit_args)
    torch.cuda.synchronize()
    cfit_kernel_s = time.perf_counter() - t0
    claunches = dict(LAUNCHES)
    print(f"logistic path launches: {claunches}")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rank_update=2, logistic_grad=600, fista_step_gemm=600)
    check(claunches == want, "dsml_logistic_fit did not run through the "
          f"kernels as expected: {claunches}")

    t0 = time.perf_counter()
    cref = dsml_logistic_fit(*cfit_args, use_kernel=False)
    torch.cuda.synchronize()
    cfit_plain_s = time.perf_counter() - t0
    check(dict(LAUNCHES) == claunches, "the plain path launched a kernel")

    for name, t in zip(cres._fields, cres):
        check(t.shape == getattr(cref, name).shape, f"{name} shape")
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
    for name in ("beta_u", "beta_local"):
        err, scale = max_err(getattr(cres, name), getattr(cref, name))
        check(err <= TOL_FIT * scale,
              f"dsml_logistic_fit {name}: err {err} > {TOL_FIT} * {scale}")
        print(f"dsml_logistic_fit {name}: max abs err vs plain {err:.3g} "
              f"(max|{name}| {scale:.3g})")
    check(bool(torch.equal(cres.support, cref.support)),
          "logistic supports differ")
    norms = torch.linalg.vector_norm(cres.beta_u.T, dim=-1)
    margin = torch.min(torch.abs(norms - Lam_c)).item()
    ham = int(hamming(cres.support, cdata.support))
    print(f"dsml_logistic_fit (m={M}, n={N}, p={P}, s={S}, lam={lam_c:.4g}, "
          f"Lam={Lam_c}): support size {int(cres.support.sum())}, "
          f"identical; threshold margin {margin:.4g}; hamming to the true "
          f"support {ham}")
    print(f"dsml_logistic_fit wall: kernels {cfit_kernel_s * 1e3:.1f} ms, "
          f"plain {cfit_plain_s * 1e3:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB {card}")

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 4c")
    # ---- 4c. the remaining DSML kernels and the baselines -----------------
    def wall(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    Xs, ys = data.Xs, data.ys
    Sig0, c0 = rank_update(Xs, ys, use_kernel=False)
    etas0 = 1.0 / torch.clamp_min(power_iteration_batched(Sig0), 1e-12)
    eye = torch.eye(P, device=dev)
    M0 = scaled_identity_m0(Sig0)
    lam_max = 2.0 * torch.max(torch.abs(c0)).item()
    grid = torch.tensor(lam_max * np.geomspace(1.0, 0.01, 8),
                        dtype=torch.float32, device=dev)
    base = float(np.sqrt(np.log(P) / N))      # benchmarks/paper_common.py
    baselines = {"group_lasso": (group_lasso, (Xs, ys, 2.0 * base, 400)),
                 "icap": (icap, (Xs, ys, 4.0 * base, 400)),
                 "dirty_model": (dirty_model, (Xs, ys, 2.0 * base, base,
                                               400))}
    for fn, args in baselines.values():         # warm-up: first-call costs
        fn(*args[:-1], 5)
    solve_lasso_eq2_grid(Sig0, c0, grid, iters=5)   # and the grid's plan
    torch.cuda.synchronize()
    reset_launches()
    t4c = time.perf_counter()
    unf = rank_update_unfused(Xs, ys)
    fused = rank_update(Xs, ys)
    filtered, keep = group_threshold(res.beta_u.T, Lam)
    sol, sol_s = wall(ista_solve, Sig0[0], c0[0], 0.5 * lam, iters=400)
    step_p = ista_step(Sig0[0], M0[0], eye, etas0[0], mu)
    isb1 = ista_step_batched(Sig0, res.beta_local, c0, etas0, 0.5 * lam)
    isbp = ista_step_batched(Sig0, M0, eye.expand(M, P, P).contiguous(),
                             etas0, mu)
    shared_before = grid_shared(obs)
    Bgrid, grid_s = wall(solve_lasso_eq2_grid, Sig0, c0, grid, iters=400)
    shared_4c = grid_shared(obs)
    base_out = {name: wall(fn, *args) for name, (fn, args)
                in baselines.items()}
    torch.cuda.synchronize()
    t4c = time.perf_counter() - t4c
    launches_4c = dict(LAUNCHES)
    print(f"phase 4c launches: {launches_4c}")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rank_update_sigma=1, rank_update_c=1, rank_update=4,
                group_threshold=1, ista_step_gemv=400, ista_step_gemm=1,
                ista_step_batched_gemv=1, ista_step_batched_gemm=1,
                fista_step_gemv=400)
    check(launches_4c == want,
          f"phase 4c did not run through the kernels as expected: "
          f"{launches_4c}")
    new_keys = ("ista_step_batched_gemv", "ista_step_batched_gemm",
                "ista_step_gemv", "ista_step_gemm", "rank_update_sigma",
                "rank_update_c", "group_threshold")
    check(all(launches_4c[k] > 0 for k in new_keys),
          "a new kernel did not launch in phase 4c")

    for name, a, b in zip(("Sigma", "c"), unf, fused):
        err, scale = max_err(a, b)
        check(err <= TOL_KERNEL * scale, f"rank_update_unfused {name} vs "
              f"rank_update: err {err} > {TOL_KERNEL} * {scale}")
        print(f"rank_update_unfused {name} vs rank_update at ({M},{N},{P}): "
              f"max abs err {err:.3g} (max {scale:.3g})")
    check(bool(torch.equal(unf[0], fused[0])),
          "rank_update_unfused Sigma differs from rank_update's")
    check(bool(torch.equal(keep, res.support)),
          "group_threshold keep differs from dsml_fit's support")
    check(bool(torch.equal(filtered.T, res.beta_tilde)),
          "group_threshold rows differ from dsml_fit's beta_tilde")
    print(f"group_threshold of beta_u' at Lam={Lam}: keep equals the fit's "
          f"support ({int(keep.sum())} rows), filtered' equals beta_tilde")

    sol_ref, sol_ref_s = wall(ista_solve, Sig0[0], c0[0], 0.5 * lam,
                              iters=400, use_kernel=False)
    err, scale = max_err(sol, sol_ref)
    check(err <= TOL_FIT * scale,
          f"ista_solve: err {err} > {TOL_FIT} * {scale}")
    check(bool(torch.equal(sol != 0, sol_ref != 0)),
          "ista_solve supports differ")
    print(f"ista_solve (p={P}, 400 steps, lam={0.5 * lam:.4g}): max abs err "
          f"vs plain {err:.3g} (max|beta| {scale:.3g}); support "
          f"{int((sol != 0).sum())}, identical; wall kernels "
          f"{sol_s * 1e3:.1f} ms, plain {sol_ref_s * 1e3:.1f} ms {card}")
    for name, got, ref in (
            ("ista_step r=p", step_p,
             ista_step_ref(Sig0[0], M0[0], eye, etas0[0], mu)),
            ("ista_step_batched r=1", isb1,
             ista_step_batched_ref(Sig0, res.beta_local[..., None],
                                   c0[..., None], etas0, 0.5 * lam)[..., 0]),
            ("ista_step_batched r=p", isbp,
             ista_step_batched_ref(Sig0, M0, eye.expand(M, P, P), etas0,
                                   mu))):
        err, scale = max_err(got, ref)
        check(err <= TOL_KERNEL * scale,
              f"{name}: err {err} > {TOL_KERNEL} * {scale}")
        print(f"{name} on the fit's statistics: max abs err vs plain "
              f"{err:.3g} (max {scale:.3g})")

    shared_4c = {key: n - shared_before.get(key, 0)
                 for key, n in shared_4c.items()
                 if n != shared_before.get(key, 0)}
    check(shared_4c == {(8, 1, "kernel"): 1},
          f"solve_lasso_eq2_grid's engine.grid.shared records: {shared_4c}")
    Bgrid_tiled = solve_lasso_batched(
        Sig0.repeat(8, 1, 1), c0.repeat(8, 1),
        (0.5 * grid).repeat_interleave(M), iters=400,
        etas=lasso_stats_step_scale(Sig0).repeat(8))
    check(bool(torch.equal(Bgrid, Bgrid_tiled.reshape(8, M, P))),
          "solve_lasso_eq2_grid: not the bits of the tiled solve")
    print(f"solve_lasso_eq2_grid: the bits of the {8 * M} problems solved "
          f"on Sigma tiled 8 times; engine.grid.shared {shared_4c} "
          "(lambdas, passes over Sigma a step, path)")
    Bgrid_ref, grid_ref_s = wall(solve_lasso_eq2_grid, Sig0, c0, grid,
                                 iters=400, use_kernel=False)
    check(Bgrid.shape == (8, M, P) and bool(torch.isfinite(Bgrid).all()),
          "grid shape or values")
    err, scale = max_err(Bgrid, Bgrid_ref)
    check(err <= TOL_FIT * scale,
          f"solve_lasso_eq2_grid: err {err} > {TOL_FIT} * {scale}")
    sizes = [int(b.any(0).sum()) for b in Bgrid]
    print(f"solve_lasso_eq2_grid (k=8, {8 * M} tasks, lam {lam_max:.4g} .. "
          f"{lam_max / 100:.4g}): max abs err vs plain {err:.3g} "
          f"(max|B| {scale:.3g}); union support per lam {sizes}; wall "
          f"kernels {grid_s * 1e3:.1f} ms, plain {grid_ref_s * 1e3:.1f} ms "
          f"{card}")
    for name, (fn, args) in baselines.items():
        out, secs = base_out[name]
        ref_out, ref_s = wall(fn, *args, use_kernel=False)
        out = out if isinstance(out, tuple) else (out,)
        ref_out = ref_out if isinstance(ref_out, tuple) else (ref_out,)
        worst = 0.0
        for a, b in zip(out, ref_out):
            check(a.shape == (P, M) and bool(torch.isfinite(a).all()),
                  f"{name}: shape or values")
            err, scale = max_err(a, b)
            check(err <= TOL_FIT * scale,
                  f"{name}: err {err} > {TOL_FIT} * {scale}")
            worst = max(worst, err)
        rows = int((torch.linalg.vector_norm(out[0], dim=1) > 0).sum())
        ham = int(hamming(torch.linalg.vector_norm(out[0], dim=1) > 1e-3,
                          data.support))
        print(f"{name} (400 iterations): support {rows} rows, hamming "
              f"{ham} to the true support; max abs err vs plain "
              f"{worst:.3g}; "
              f"wall kernels {secs * 1e3:.1f} ms, plain {ref_s * 1e3:.1f} "
              f"ms {card}")
    print(f"phase 4c wall (kernel paths): {t4c * 1e3:.1f} ms {card}")

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 5")
    # ---- 5. times ---------------------------------------------------------
    m, n, p = M, N, P
    # Sigma is symmetric by construction: its least work is the upper
    # triangle (p (p + 1) / 2 dot products of length n per task) plus c;
    # the output bytes are the whole of Sigma
    def rank_work(m, n, p, weighted=False):
        """The least work of the fused update (Sigma's upper triangle, c,
        and w x where weighted) and its bytes (X, y, w in; Sigma, c out)."""
        return (m * n * p * (p + 1) + 2 * m * n * p + weighted * m * n * p,
                4 * (m * n * p + (1 + weighted) * m * n + m * p * p + m * p))

    rank_bound = bound(*rank_work(m, n, p))
    gemv_bound = bound(2 * m * p * p,
                       4 * (m * p * p + 3 * m * p + 2 * m + 2 * m * p))
    gemm_bound = bound(2 * m * p * p * p,
                       4 * (m * p * p + 3 * m * p * p + 2 * m + 2 * m * p * p))
    bound_1b = bound(2 * m_1b * p_1b ** 3,
                     4 * (6 * m_1b * p_1b * p_1b + 2 * m_1b))
    out_1b = (torch.empty_like(args_1b[1]), torch.empty_like(args_1b[1]))

    def grid_row(name, args, tiled):
        """#1a on a lambda grid: each Sigma and c read once, the k m
        iterates read twice and written twice; its yardstick is the r == 1
        kernel on the problems tiled (`library_ms`)."""
        gk, gm, gp = args[1].shape
        out = (torch.empty_like(args[1]), torch.empty_like(args[1]))
        tiled_out = (torch.empty_like(tiled[1]), torch.empty_like(tiled[1]))
        library_note[name] = ("the r == 1 kernel on Sigma, c and eta tiled "
                              f"{gk} times")
        return (name, "src/repro_torch/kernels/csrc/fista_step.cu",
                "src/repro/kernels/ista_step/kernel.py:108",
                bound(2 * gk * gm * gp * gp,
                      4 * (gm * gp * gp + gm * gp + 4 * gk * gm * gp + gm
                           + gk)),
                lambda: ista_ops.launch_grid(*args, *out),
                lambda: fista_step_grid(*args),
                lambda: fista_step_grid_ref(*args),
                lambda: ista_ops.launch(*tiled, *tiled_out))

    Xt = X.transpose(1, 2)
    S_out, c_out = torch.empty_like(Sig), torch.empty((m, p), device=dev)
    gemv_out = (torch.empty_like(gemv_args[1]), torch.empty_like(gemv_args[1]))
    gemm_out = (torch.empty_like(gemm_args[1]), torch.empty_like(gemm_args[1]))
    def flash_flops(shape, causal=True, window=0):
        fb, fs, fn, _, fh = shape
        return 4 * fb * fn * flash_pairs(fs, causal, window) * fh

    def flash_row(name, shape, qkv, causal=True, window=0,
                  peak=PEAK_BF16_FLOPS):
        """The pairs the mask keeps (the causal triangle, or all) at the
        peak rate `peak` (the bf16 tensor cores, or 3xTF32 for f32); q,
        k, v and out once each. SDPA has no window: a row's window covers
        its whole prompt (window >= S); `sdpa_yardstick` expands k and v
        outside the call where `enable_gqa` takes the math path (f32)."""
        fb, fs, fn, fk, fh = shape
        check(window == 0 or window >= fs, f"{name}: SDPA has no window")
        fq, fkk, fv = qkv
        f_out = torch.empty_like(fq)
        lib, library_note[name] = sdpa_yardstick(fq, fkk, fv, causal)
        return (name, "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/kernel.py:83",
                bound(flash_flops(shape, causal, window),
                      fq.element_size()
                      * (2 * fb * fs * fn * fh + 2 * fb * fs * fk * fh),
                      peak),
                lambda: flash_ops.launch(fq, fkk, fv, f_out, causal=causal,
                                         window=window),
                lambda: flash_attention(fq, fkk, fv, causal=causal,
                                        window=window),
                lambda: flash_attention(fq, fkk, fv, causal=causal,
                                        window=window, use_kernel=False),
                lib)

    def flash_lse_row(name, shape, qkv, window=0, causal=True,
                      peak=PEAK_BF16_FLOPS):
        """#9 with its lse, as the training forward launches it: q, k, v
        and out once each, and the lse; beside SDPA's forward on inputs
        that require a gradient (it then writes its own logsumexp). SDPA
        has no window: a row's window covers its whole sequence."""
        fb, fs, fn, fk, fh = shape
        check(window == 0 or window >= fs, f"{name}: SDPA has no window")
        fq, fkk, fv = qkv
        f_out = torch.empty_like(fq)
        f_lse = torch.empty((fb, fn, fs), device=dev)
        lib, library_note[name] = sdpa_yardstick(fq, fkk, fv, causal,
                                                 grad=True)
        return (name, "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/kernel.py:83",
                bound(flash_flops(shape, causal, window),
                      fq.element_size()
                      * (2 * fb * fs * fn * fh + 2 * fb * fs * fk * fh)
                      + 4 * fb * fn * fs, peak),
                lambda: flash_ops.launch(fq, fkk, fv, f_out, lse=f_lse,
                                         causal=causal, window=window),
                lambda: flash_ops.flash_attention_fwd_lse(
                    fq, fkk, fv, causal=causal, window=window),
                lambda: flash_ops.flash_attention_fwd_lse(
                    fq, fkk, fv, causal=causal, window=window,
                    use_kernel=False),
                lib)

    library_note: dict = {}   # flash rows: how SDPA was called
    # the f32 rows: bound by full-f32 products as three TF32 products on
    # the tensor cores (the kernel's and SDPA's design), and beside it the
    # FP32 FMA bound
    f32_rows = [
        (flash_lse_row if lse else flash_row)(
            name, shape, f32_qkv[name], window=window,
            peak=PEAK_TF32X3_FLOPS)
        for name, (shape, window, lse) in f32_flash.items()]
    fma_bound = {name: flash_flops(shape, window=window)
                 / PEAK_F32_FLOPS * 1e3
                 for name, (shape, window, _) in f32_flash.items()}

    # the weighted launch's yardstick: one bmm on (w X)' computed aside
    Xwt = (X * w[..., None]).transpose(1, 2)
    Xit = Xi.transpose(1, 2)
    Si_out = torch.empty((INGEST[0], INGEST[2], INGEST[2]), device=dev)
    ci_out = torch.empty((INGEST[0], INGEST[2]), device=dev)
    rows = [
        flash_row("flash_attention", flash_path, flash_qkv),
        flash_row("flash_attention_h128", FLASH_H128, flash_qkv128),
        flash_lse_row("flash_attention_lse", flash_path, flash_qkv),
        flash_lse_row("flash_attention_lse_tp2", flash_tp, flash_qkv_tp),
        *(flash_lse_row(name, shape, zoo12_qkv[name], window)
          for name, (shape, window) in zoo12_flash.items()),
        *(flash_lse_row(name, shape, train10c_qkv[name], causal=causal)
          for name, (shape, causal) in train10c_flash.items()),
        *(flash_row(name, shape, zoo_qkv[name], causal, window)
          for name, (shape, causal, window) in zoo_flash.items()),
        *(flash_row(name, shape, serve13_qkv[name], causal, window)
          for name, (shape, causal, window) in serve13_flash.items()),
        *f32_rows,
        ("rank_update", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:121", rank_bound,
         lambda: rank_ops.launch(X, y, None, S_out, c_out),
         lambda: rank_update(X, y),
         lambda: rank_update_ref(X, y),
         lambda: torch.bmm(Xt, X)),
        # the logistic fit's Hessian launch: Sigma = X'WX/n, c = X'Wy/n
        ("rank_update_weighted", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:121",
         bound(*rank_work(m, n, p, weighted=True)),
         lambda: rank_ops.launch(X, y, w, S_out, c_out),
         lambda: rank_update(X, y, w),
         lambda: rank_update_ref(X, y, w),
         lambda: torch.bmm(Xwt, X)),
        # one chunk of the streaming service's ingest
        ("rank_update_ingest", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:121",
         bound(*rank_work(*INGEST)),
         lambda: rank_ops.launch(Xi, yi, None, Si_out, ci_out),
         lambda: rank_update(Xi, yi),
         lambda: rank_update_ref(Xi, yi),
         lambda: torch.bmm(Xit, Xi)),
        ("fista_step_gemv", "src/repro_torch/kernels/csrc/fista_step.cu",
         "src/repro/kernels/ista_step/kernel.py:108", gemv_bound,
         lambda: ista_ops.launch(*gemv_args, *gemv_out),
         lambda: fista_step_batched(*gemv_args),
         lambda: fista_step_batched_ref(*gemv_args),
         lambda: torch.bmm(Sig, gemv_args[1])),
        ("fista_step_gemm", "src/repro_torch/kernels/csrc/fista_step.cu",
         "src/repro/kernels/ista_step/kernel.py:108", gemm_bound,
         lambda: ista_ops.launch(*gemm_args, *gemm_out),
         lambda: fista_step_batched(*gemm_args),
         lambda: fista_step_batched_ref(*gemm_args),
         lambda: torch.bmm(Sig, gemm_args[1])),
        # the fit cell's debias step, the rule's (short-row) tile
        ("fista_step_gemm_p200", "src/repro_torch/kernels/csrc/fista_step.cu",
         "src/repro/kernels/ista_step/kernel.py:108", bound_1b,
         lambda: ista_ops.launch(*args_1b, *out_1b),
         lambda: fista_step_batched(*args_1b),
         lambda: fista_step_batched_ref(*args_1b),
         lambda: torch.bmm(Sig_1b, args_1b[1])),
        *(grid_row(name, args, tiled) for name, args, tiled in (
            ("fista_step_gemv_grid", grid_args, grid_tiled),
            ("fista_step_gemv_grid_4c", grid4c_args, grid4c_tiled))),
    ]
    for suffix, (Xl, yl, Bl) in (("", lg_args), ("_p8192", lg_large)):
        lm, ln, lp = Xl.shape
        pl = logistic_ops.plan(lm, ln, lp, sms, smem_optin)
        G = torch.empty((lm, lp), device=dev)
        work = torch.empty((lm, pl.chunks, lp), device=dev)
        counters = torch.zeros(lm * pl.cluster, dtype=torch.int32,
                               device=dev)
        rbuf = torch.empty((lm, ln), device=dev)
        rl = yl * torch.sigmoid(-yl * torch.bmm(Xl, Bl[..., None])[..., 0])
        Xlt = Xl.transpose(1, 2)
        # no PyTorch call computes this function: the library row is
        # its two products, X b and X' r, timed together
        lib = (lambda Xl=Xl, Bl=Bl, Xlt=Xlt, rl=rl:
               (torch.bmm(Xl, Bl[..., None]), torch.bmm(Xlt, rl[..., None])))
        rows += [
            ("logistic_grad" + suffix,
             "src/repro_torch/kernels/csrc/logistic_grad.cu",
             "src/repro/kernels/logistic_grad/kernel.py:149",
             bound(4 * lm * ln * lp,
                   4 * (lm * ln * lp + lm * ln + 2 * lm * lp)),
             lambda a=(Xl, yl, Bl, G, work, counters):
                 logistic_ops.launch(*a),
             lambda a=(Xl, yl, Bl): logistic_grad(*a),
             lambda a=(Xl, yl, Bl): logistic_grad_ref(*a),
             lib),
            # its own two-dispatch contract: X read twice, r written and
            # read back through device memory
            ("logistic_grad_unfused" + suffix,
             "src/repro_torch/kernels/csrc/logistic_grad.cu",
             "src/repro/kernels/logistic_grad/kernel.py:198",
             bound(4 * lm * ln * lp,
                   4 * (2 * lm * ln * lp + 2 * lm * lp + 3 * lm * ln)),
             lambda a=(Xl, yl, Bl, rbuf, G): logistic_ops.launch_unfused(*a),
             lambda a=(Xl, yl, Bl): logistic_grad_unfused(*a),
             lambda a=(Xl, yl, Bl): logistic_grad_unfused(*a,
                                                          use_kernel=False),
             lib),
        ]
    # the step without momentum, m tasks and one task (m = 1): Sigma,
    # beta, c and the output, no x and no z'
    def ista_row(name, args, counter):
        Sl, bl, cl, el, ll = args
        tm, tp, tr = bl.shape
        out = torch.empty_like(bl)
        wrapped = args if counter == "ista_step_batched" else \
            (Sl[0], bl[0], cl[0], el[0], ll[0])
        wrapper = ista_step_batched if counter == "ista_step_batched" \
            else ista_step
        plain = ista_step_batched_ref if counter == "ista_step_batched" \
            else ista_step_ref
        return (name, "src/repro_torch/kernels/csrc/fista_step.cu",
                "src/repro/kernels/ista_step/kernel.py:" +
                ("153" if counter == "ista_step_batched" else "196"),
                bound(2 * tm * tp * tp * tr,
                      4 * (tm * tp * tp + 3 * tm * tp * tr + 2 * tm)),
                lambda: ista_ops.launch_ista(*args, out, counter),
                lambda: wrapper(*wrapped),
                lambda: plain(*wrapped),
                lambda: torch.bmm(Sl, bl))

    def one_task(args):
        Sl, bl, cl, el, ll = args
        return (Sl[:1].contiguous(), bl[:1].contiguous(),
                cl[:1].contiguous(), el[:1].contiguous(), ll[:1].contiguous())

    rows += [
        ista_row("ista_step_batched_gemv", isb_gemv, "ista_step_batched"),
        ista_row("ista_step_batched_gemm", isb_gemm, "ista_step_batched"),
        ista_row("ista_step_gemv", one_task(isb_gemv), "ista_step"),
        ista_row("ista_step_gemm", one_task(isb_gemm), "ista_step"),
    ]
    c_out2 = torch.empty((m, p), device=dev)
    yt = y[..., None]
    gt_out = torch.empty_like(B_gt)
    gt_keep = torch.empty(P, dtype=torch.int8, device=dev)
    pg, mg = B_gt.shape
    rows += [
        # Sigma alone: the symmetric least work, X in and Sigma out
        ("rank_update_sigma", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:162",
         bound(m * n * p * (p + 1), 4 * (m * n * p + m * p * p)),
         lambda: rank_ops.launch_sigma(X, None, S_out),
         lambda: rank_update_unfused(X, y),
         lambda: rank_sigma_ref(X),
         lambda: torch.bmm(Xt, X)),
        # c alone: X, y in, c out
        ("rank_update_c", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:162",
         bound(2 * m * n * p, 4 * (m * n * p + m * n + m * p)),
         lambda: rank_ops.launch_c(X, y, None, c_out2),
         lambda: rank_update_unfused(X, y),
         lambda: rank_c_ref(X, y),
         lambda: torch.bmm(Xt, yt)),
        # B in, B out, the int8 keep column
        ("group_threshold", "src/repro_torch/kernels/csrc/group_threshold.cu",
         "src/repro/kernels/group_threshold/kernel.py:28",
         bound(2 * pg * mg + pg, 4 * 2 * pg * mg + pg),
         lambda: threshold_ops.launch(B_gt, 0.8, gt_out, gt_keep),
         lambda: group_threshold(B_gt, 0.8),
         lambda: group_threshold_ref(B_gt, 0.8),
         lambda: B_gt * (torch.linalg.vector_norm(B_gt, dim=1,
                                                  keepdim=True) > 0.8)),
    ]
    shapes = {"rank_update": (m, n, p), "fista_step_gemv": (m, p, 1),
              "fista_step_gemv_grid": GRID_CELL,
              "fista_step_gemv_grid_4c": (m, p, 8),
              "fista_step_gemm": (m, p, p),
              "fista_step_gemm_p200": CELL_1B,
              "logistic_grad": (M, N, P), "logistic_grad_unfused": (M, N, P),
              "logistic_grad_p8192": LARGE_P,
              "logistic_grad_unfused_p8192": LARGE_P,
              "ista_step_batched_gemv": (m, p, 1),
              "ista_step_batched_gemm": (m, p, p),
              "ista_step_gemv": (1, p, 1), "ista_step_gemm": (1, p, p),
              "rank_update_sigma": (m, n, p), "rank_update_c": (m, n, p),
              "group_threshold": (pg, mg), "flash_attention": flash_path,
              "rank_update_weighted": (m, n, p),
              "rank_update_ingest": INGEST,
              "flash_attention_h128": FLASH_H128,
              "flash_attention_lse": flash_path,
              "flash_attention_lse_tp2": flash_tp,
              **{name: z[0] for name, z in zoo_flash.items()},
              **{name: z[0] for name, z in zoo12_flash.items()},
              **{name: z[0] for name, z in train10c_flash.items()},
              **{name: z[0] for name, z in serve13_flash.items()},
              **{name: z[0] for name, z in f32_flash.items()}}
    # the redesigned kernels' least work, for their achieved rate
    row_flops = {"flash_attention": flash_flops(flash_path),
                 "flash_attention_h128": flash_flops(FLASH_H128),
                 "flash_attention_lse": flash_flops(flash_path),
                 "flash_attention_lse_tp2": flash_flops(flash_tp),
                 **{name: flash_flops(shape, window=window)
                    for name, (shape, window) in zoo12_flash.items()},
                 **{name: flash_flops(shape, causal)
                    for name, (shape, causal) in train10c_flash.items()},
                 **{name: flash_flops(*z) for name, z in zoo_flash.items()},
                 **{name: flash_flops(*z)
                    for name, z in serve13_flash.items()},
                 **{name: flash_flops(shape, window=window)
                    for name, (shape, window, _) in f32_flash.items()},
                 "fista_step_gemm": 2 * m * p * p * p,
                 "fista_step_gemm_p200": 2 * m_1b * p_1b ** 3,
                 "ista_step_gemm": 2 * p * p * p,
                 "rank_update": rank_work(m, n, p)[0],
                 "rank_update_weighted": rank_work(m, n, p, True)[0],
                 "rank_update_ingest": rank_work(*INGEST)[0],
                 "rank_update_sigma": m * n * p * (p + 1)}
    kernels = []              # launches per run are added after phase 6
    for (name, source, replaces, (bound_ms, bound_by), kern, wrapper, plain,
         lib) in rows:
        ms, wrap_ms = time_ms(kern), time_ms(wrapper)
        plain_ms, lib_ms = time_ms(plain), time_ms(lib)
        cold_ms = time_ms_cold(kern)
        (g_ms, g_how), (lg_ms, lg_how) = graph_ms(kern), graph_ms(lib)
        print(f"time {name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {plain_ms:.4f} ms, library {lib_ms:.4f} "
              f"ms, wrapper {wrap_ms:.4f} ms, kernel with L2 flushed "
              f"{cold_ms:.4f} ms; device only: kernel {g_ms:.4f} ms "
              f"({g_how}), library {lg_ms:.4f} ms ({lg_how}) {card}")
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "shape": list(shapes[name]),
               "max_abs_err": errs[name], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "cold_ms": cold_ms, "wrapper_ms": wrap_ms,
               "graph_ms": g_ms, "library_graph_ms": lg_ms,
               "graph_method": g_how, "library_graph_method": lg_how}
        if name.startswith("flash_attention"):
            # the backend SDPA picks, by the kernels it runs on the card
            row["library_kernels"] = device_kernel_names(lib)
            print(f"library {name}: SDPA runs {row['library_kernels']}")
        if name in library_note:
            row["library_note"] = library_note[name]
        if name in fma_bound:
            row["fma_bound_ms"] = fma_bound[name]
            print(f"f32 {name}: SDPA with {library_note[name]}; kernel "
                  f"{g_ms:.4f} ms by graph against the 3xTF32 bound "
                  f"{bound_ms:.4f} ({bound_ms / g_ms:.1%} of its rate) and "
                  f"the FMA bound {fma_bound[name]:.4f} "
                  f"({fma_bound[name] / g_ms:.1%}); kernel / SDPA "
                  f"{g_ms / lg_ms:.3f} by graph, {ms / lib_ms:.3f} by "
                  f"events {card}")
        if name in row_flops:
            row["tflops"] = row_flops[name] / ms / 1e9
            row["graph_tflops"] = row_flops[name] / g_ms / 1e9
            print(f"rate {name}: kernel {row['tflops']:.1f} TFLOP/s by "
                  f"events, {row['graph_tflops']:.1f} by graph ("
                  f"{bound_ms / g_ms:.1%} of the bound's rate); library "
                  f"{row_flops[name] / lib_ms / 1e9:.1f} TFLOP/s by events, "
                  f"{row_flops[name] / lg_ms / 1e9:.1f} by graph; graph "
                  f"kernel / library {g_ms / lg_ms:.3f} {card}")
        kernels.append(row)
    # the floor of any launch: a kernel that does nothing, timed as the
    # rows are, beside the group threshold (a launch-bound kernel)
    empty = lambda: threshold_ops.launch_empty(dev)       # noqa: E731
    floor_ms, (floor_g, floor_how) = time_ms(empty), graph_ms(empty)
    print(f"time empty kernel (the launch floor): events {floor_ms:.4f} ms; "
          f"device only {floor_g:.4f} ms ({floor_how}) {card}")
    next(r for r in kernels if r["name"] == "flash_attention_lse").update(
        flash_backward_times(flash_path, flash_qkv, card))
    for name, (shape, causal) in train10c_flash.items():
        next(r for r in kernels if r["name"] == name).update(
            flash_backward_times(shape, train10c_qkv[name], card, causal))
    next(r for r in kernels if r["name"] == "group_threshold").update(
        launch_floor_ms=floor_ms, launch_floor_graph_ms=floor_g)
    # row 1b at the cell's shape: the 128 x 64 tile forced, beside the
    # rule's tile and bmm(Sigma, Z)
    wide_1b = lambda: ista_ops.launch(                      # noqa: E731
        *args_1b, *out_1b, ista_ops.check_block("5", p_1b, (128, 64)))
    row_1b = next(r for r in kernels if r["name"] == "fista_step_gemm_p200")
    row_1b.update(tile=list(tile_1b), wide_tile_ms=time_ms(wide_1b),
                  wide_tile_graph_ms=graph_ms(wide_1b)[0])
    print(f"time fista_step_gemm_p200 at {CELL_1B} (events / graph ms): "
          f"the rule's {tile_1b[0]} x {tile_1b[1]} tile {row_1b['ms']:.4f} / "
          f"{row_1b['graph_ms']:.4f}, 128 x 64 forced "
          f"{row_1b['wide_tile_ms']:.4f} / {row_1b['wide_tile_graph_ms']:.4f},"
          f" bmm(Sigma, Z) {row_1b['library_ms']:.4f} / "
          f"{row_1b['library_graph_ms']:.4f}; bound {bound_1b[0]:.4f} "
          f"({bound_1b[1]}) {card}")
    # the fit cell's own path: one dsml_fit at its (m, n, p) (`bench/
    # configs/dsml-reg-p200.json`), after a warm-up that sweeps its plans;
    # its r = p launches are the row's count, and its debias solve's plan
    # (`dispatch.route`) the rule's tile
    data_1b = gen_regression(torch.Generator(device=dev).manual_seed(35),
                             m=m_1b, n=120, p=p_1b, s=10, device=dev)
    mu_1b = float(np.sqrt(np.log(p_1b) / 120))
    fit_1b = (data_1b.Xs, data_1b.ys, 4.0 * mu_1b, mu_1b, 8.0)
    dsml_fit(*fit_1b)
    torch.cuda.synchronize()
    routes_0 = route_records(obs)
    reset_launches()
    dsml_fit(*fit_1b)
    torch.cuda.synchronize()
    launches_1b = LAUNCHES["fista_step_gemm"]
    routes_1b = {k: n - routes_0.get(k, 0)
                 for k, n in route_records(obs).items()
                 if n != routes_0.get(k, 0)}
    rule_1b = "x".join(str(b) for b in next(
        t for t in ista_ops.GEMM_TILES if t[:2] == tile_1b))
    check(launches_1b == 600, f"dsml_fit at {CELL_1B}: {launches_1b} "
          "launches of fista_step_gemm, not its 600 debias steps")
    check(routes_1b.get(("fista_step_batched", "kernel", rule_1b)) == 1,
          f"dsml_fit at {CELL_1B}: plans {routes_1b}, not the rule's "
          f"{rule_1b} once")
    print(f"dsml_fit at {CELL_1B} (n = 120): {launches_1b} launches of "
          f"fista_step_gemm; plans {routes_1b}, the debias solve's the "
          f"rule's {rule_1b}")
    # the grid rows' inputs (the tiled copies 1.8 GB) are not needed again
    del rows, grid_args, grid_tiled, grid4c_args, grid4c_tiled, Sig_g
    del args_1b, out_1b, Sig_1b, wide_1b, data_1b, fit_1b
    free_card()

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 6")
    # ---- 6. the serving path at full width -------------------------------
    steps = cell.NEW_TOKENS
    base_mem = torch.cuda.memory_allocated()
    cfg, params, prompt = cell.make_cell(dev)
    batch, plen = prompt.shape
    weights_gib = (torch.cuda.memory_allocated() - base_mem) / 2**30
    generate(params, cfg, prompt, 2)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    out, gen_s, serve_launches = generate(params, cfg, prompt, steps)
    peak_total_gib = torch.cuda.max_memory_allocated() / 2**30
    peak_gib = peak_total_gib - base_mem / 2**30
    print(f"serving path launches: {serve_launches}")
    serve_checks(f"{cfg.name} kernels", cfg, out, prompt, steps,
                 serve_launches, cfg.n_layers)
    out_p, gen_plain_s, plain_launches = generate(params, cfg, prompt, steps,
                                                  use_kernel=False)
    serve_checks(f"{cfg.name} plain", cfg, out_p, prompt, steps,
                 plain_launches, 0)
    logits_k, pre_s = prefill_logits(params, cfg, prompt, steps)
    logits_p, pre_plain_s = prefill_logits(params, cfg, prompt, steps,
                                           use_kernel=False)
    check(bool(torch.isfinite(logits_k).all()), "prefill logits not finite")
    err, scale = max_err(logits_k, logits_p)
    check(err <= TOL_SERVE_BF16 * scale, f"{cfg.name} prefill logits: err "
          f"{err} > {TOL_SERVE_BF16} * {scale}")
    shared = int((out[:, plen:] == out_p[:, plen:]).sum())
    decode_ms = (gen_s - pre_s) / (steps - 1) * 1e3
    print(f"{cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"{cfg.compute_dtype}), batch {batch}, prompt {plen}, "
          f"{steps} new tokens: prefill last logits vs plain max abs "
          f"err {err:.4g} = {err / scale:.4g} of max|logits| {scale:.4g}; "
          f"{shared} of {batch * steps} generated tokens shared "
          f"with the plain path")
    print(f"{cfg.name} serving wall: generate {gen_s * 1e3:.1f} ms (plain "
          f"{gen_plain_s * 1e3:.1f}), prefill {pre_s * 1e3:.1f} ms (plain "
          f"{pre_plain_s * 1e3:.1f}), decode {decode_ms:.2f} ms per token "
          f"step ((generate - prefill) / {steps - 1}), "
          f"{batch * steps / gen_s:.1f} tokens/s; weights "
          f"{weights_gib:.2f} GiB; peak during generate {peak_gib:.2f} GiB "
          f"(weights included), {peak_total_gib:.2f} GiB with what earlier "
          f"phases hold {card}")
    # the kernel run step by step, which phase 13a holds its sharded
    # steps to
    tmp13 = tempfile.TemporaryDirectory(prefix="chip13_")
    trace = serve_trace(params, cfg, prompt, steps)
    torch.save(trace, f"{tmp13.name}/ref13a.pt")
    check(torch.equal(torch.stack(trace["tokens"], 1), out[:, plen:].cpu()),
          f"{cfg.name} the kernel run step by step for phase 13a: its "
          "tokens are not greedy_generate's")
    print(f"{cfg.name} the kernel run step by step for phase 13a: its "
          "tokens are greedy_generate's")
    del params, logits_k, logits_p, trace

    cfg32, p32, _ = cell.make_cell(dev, n_layers=4, param_dtype="float32",
                                   compute_dtype="float32")
    prompt32 = prompt[:F32_COPY_BATCH]
    out32, gen32_s, launches32 = generate(p32, cfg32, prompt32, 8)
    serve_checks(f"{cfg.name} f32 4 layers", cfg32, out32, prompt32, 8,
                 launches32, cfg32.n_layers)
    out32_p, _, _ = generate(p32, cfg32, prompt32, 8, use_kernel=False)
    check(bool(torch.equal(out32, out32_p)),
          "f32 4 layers: kernel and plain paths gave different tokens")
    l32, _ = prefill_logits(p32, cfg32, prompt32, 8)
    l32_p, _ = prefill_logits(p32, cfg32, prompt32, 8, use_kernel=False)
    err, scale = max_err(l32, l32_p)
    check(err <= TOL_FIT * scale, f"f32 4 layers prefill logits: err {err} "
          f"> {TOL_FIT} * {scale}")
    print(f"{cfg.name} f32 at 4 layers (batch 2, prompt {plen}, 8 new "
          f"tokens): identical tokens on both paths; prefill last logits "
          f"max abs err {err:.3g} (max|logits| {scale:.3g}); generate "
          f"{gen32_s * 1e3:.1f} ms {card}")
    del p32

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 7")
    # ---- 7. the streaming service ------------------------------------------
    launches_ingest, carried = stream_phase(dev, card, data, res, cdata,
                                            cres, cfit_args, lam, mu, Lam)

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 8")
    # ---- 8. the distributed path ---------------------------------------
    launches_8 = distributed_phase(dev, card, data, res, carried, lam, mu,
                                   Lam)

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 9")
    # ---- 9. the rest of the model zoo at full width ----------------------
    launches_9 = zoo_phase(dev, card)

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 10")
    # ---- 10. training -------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip11_") as tmp11:
        trained = train_phase(dev, card, tmp11)

        print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
              "phase 10c")
        # ---- 10c. the families that fit the card, unreduced ---------------
        launches_10c = train_family_phase(dev, card)

        print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
              "phase 11")
        # ---- 11. sharded training -----------------------------------------
        sharded = train_sharded_phase(dev, card, tmp11)

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 12")
    # ---- 12. the other families trained sharded ---------------------------
    with tempfile.TemporaryDirectory(prefix="chip12_") as tmp12:
        zoo_sharded = train_zoo_sharded_phase(dev, card, tmp12)

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 13")
    # ---- 13. serving sharded ----------------------------------------------
    serving = serve_sharded_phase(dev, card, tmp13.name)
    tmp13.cleanup()

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 14")
    # ---- 14. the launch-plan autotuning -----------------------------------
    autotune_phase(dev, card, data, res, fit_args)
    run_cache.cleanup()

    print(f"elapsed {time.perf_counter() - t_start:.1f} s before "
          "phase 15")
    # ---- 15. granite-4.0-h-small's training products ---------------------
    hybrid_moe_phase(dev, card)

    # launches per run: the regression rows from phase 4, the logistic
    # rows from phase 4b (the unfused pair is not on either path), the
    # rows of the third slice from phase 4c, flash from phase 6, the
    # ingest shape's row from phase 7c's 8 chunks, the zoo's flash rows
    # from phase 9; a row at another shape than its path's takes its
    # kernel's count, but minitron-4b's H = 128 shape, which no path
    # serves (9a's H = 128 launches are row flash_attention_moe's), 0;
    # both lambda-grid rows take 4c's grid solve's count (one launch a
    # step at any shape; no phase solves a grid at the benchmark cell's)
    run_launches = {**launches,
                    "rank_update_weighted": claunches["rank_update"],
                    "rank_update_ingest": launches_ingest,
                    "flash_attention_h128": 0,
                    "logistic_grad": claunches["logistic_grad"],
                    "logistic_grad_p8192": claunches["logistic_grad"],
                    "logistic_grad_unfused": claunches["logistic_z"],
                    "logistic_grad_unfused_p8192": claunches["logistic_z"],
                    **{k: launches_4c[k] for k in new_keys},
                    "fista_step_gemv_grid": launches_4c["fista_step_gemv"],
                    "fista_step_gemm_p200": launches_1b,
                    "fista_step_gemv_grid_4c":
                        launches_4c["fista_step_gemv"],
                    "flash_attention": serve_launches["flash_attention"],
                    **launches_9,
                    "flash_attention_lse": trained["launches"],
                    "flash_attention_f32_lse": trained["launches_f32"],
                    "flash_attention_f32": launches32["flash_attention"],
                    "flash_attention_lse_tp2": sharded["launches_11a"],
                    **launches_10c,
                    **zoo_sharded["launches"], **serving["launches"]}
    print(json.dumps({"kernels": [
        {**row, "launches": run_launches[row["name"]],
         "launches_phase8": launches_8.get(row["name"], 0),
         "launches_phase11": sharded["launches"].get(row["name"], 0),
         "launches_phase12": zoo_sharded["launches_phase12"].get(
             row["name"], 0),
         "launches_phase13": serving["launches_phase13"].get(
             row["name"], 0)}
        for row in kernels]}))
    print(f"elapsed {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


def phase_15_alone() -> None:
    """`python chip_smoke.py 15`: phase 15 by itself, after the card's
    name and limit."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}; torch {torch.__version__}")
    hybrid_moe_phase(torch.device("cuda"), f"[{smi}]")
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    if sys.argv[1:] == ["15"]:
        phase_15_alone()
    else:
        main()
