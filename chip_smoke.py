#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py    # full llama3.2-3b (28 layers, every format), full recurrentgemma-9b, full xlstm-125m,
                             # full olmoe-1b-7b, full musicgen-medium, llama-3.2-vision-90b at full width

Phases, each printed on lines of its own; any failure raises and the exit
code is non-zero:

1. card      the ``nvidia-smi`` name and power limit line;
2. build     nvcc builds every kernel from ``src/repro_torch/csrc``, all
             sources at once, a build thread each (each source's compile
             time); meanwhile phase 5's model is quantized in every format
             (no hand-written kernel runs there), then phase 4 runs (its
             source builds in seconds) and phase 3 checks each kernel as
             its source is built, while the slowest sources (``bcq_mm.cu``,
             ``uniform_mm.cu``) still compile;
3. kernels   each of the seven quantized-matmul kernels against its plain
             PyTorch version at the main path's leaf shapes (B = 1, 4 and the
             prefill row count) and the reference's kernel sweep, with bf16
             and f32 inputs (``ternary_mm`` also with bf16 x and f32 scales
             and the reverse: bf16/bf16 takes its tensor cores, the other
             three its group-table kernel): max error against the tolerance
             (2e-4 for all: kernel and plain version widen the same inputs
             to f32 and differ only in summation order), the same bits on a
             rerun, kernel time, plain time, the byte /
             operation bound (the format's own planes, scales, x and output)
             and ``library_ms`` (``torch.matmul`` of bf16 x against the
             pre-dequantized bf16 weight, the paper's cuBLAS baseline, timed
             here only). ``dequant_materialize`` is held to its plain version
             bit for bit, and its pipeline ``dequant_mm`` (materialise, then
             an f32 GEMM) is checked and timed beside it, GEMM alone too.
             The bf16 leaf times of ``codebook_mm``, ``lutgemm``, ``bcq_mm``,
             ``bcq_mm_fused``, ``uniform_mm`` and ``ternary_mm`` are also
             printed as multiples of their bounds and of the library call,
             with the decode steps of K3, of the bcq path (K1 + K2), of K5
             and of K4 at B = 1, 4 and 64 beside the library's (the paper's
             Table 3 comparison). Each row of a 16-row call of K3, K1, K2,
             K5 and K4 at ``wo`` must equal the row called alone, bit for
             bit, as must each row of a K1 and a K4 call 8 rows wider than
             its row slab, in bf16 and f32 (K4: both paths). K1 and K5 at
             ``wo`` for q = 1..8, and K4's group-table path, on the table
             path and the direct path (both checked, both timed) give the
             measurement behind ``grouptable.TABLE_MAX_Q``. Last, the dense
             check (asserted): dense bf16 (``utils.matmul_rows``) and
             ``dequant_mm`` products of 4, 9, 16 and 64 decode rows at
             ``wo`` and ``w_gate_up`` must give each row the bits of the row
             alone (fixed tiles of rows, so cuBLAS sees one shape), and what
             the tiles cost a B = 4 decode step against one product. The
             speculative path's shapes (bf16): K1/K2 and K3 at q' = 1 and 2
             planes on the five leaves at B = 1, 4, the verify's 4·(γ+1) =
             20 rows and the draft prefill's 64, at q = 4 at 20 rows, and K4
             at 20 rows, each checked and timed with its byte bound; K1/K2
             at q' = 2 and q = 4 at phase 6's prompt lengths, checked; and
             each path's decode step at every q and B. Prompt rows (asserted):
             dense bf16 and ``dequant_mm`` rows of a 544-row prompt at
             ``wo`` and ``w_gate_up`` equal the same rows in a 32-row call
             (``utils.PROMPT_TILE``), and the tiles' cost on a dense bf16
             prefill of 512 and 8192 tokens, one product against tiles of 64
             and 128 rows;
4. flash     ``flash_attention`` (K8) against its plain version (``_sdpa``
             under a causal mask, run one batch row at a time) at
             llama3.2-3b's heads (24 / 8, Dh 128) for B in {1, 4} and S in
             {1, 16, 17, 100, 512, 2048, 8192}, at the reference test's four
             shapes and at Dh 16 and 64, in bf16 (rtol = atol = 3e-2) and f32
             (2e-4), the reference test's own ``assert_allclose``, and in bf16 also
             per query row: max|Δ| over the row's Dh values within 2^-6 of
             the row's max|plain| (``BF16_ROW_TOL``: twice one bf16 ulp of
             the output; the long rows' values fall as 1/sqrt(S), below the
             absolute limit); a rerun must give the same bits. Timed like the other kernels, beside
             ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
             on the same bf16 inputs (the library yardstick, never on a path),
             each with its achieved TFLOP/s (the causal pairs' operations over
             its time). bf16 runs on the tensor cores, f32 on the CUDA cores.
             The offset entry (queries at ``q_start``, keys a view of the
             first ``q_start + Sq`` rows of a cache whose later rows are NaN)
             at (q_start, Sq) = (512, 32), (7168, 1024), (384, 128) and (544,
             3), B = 1, bf16 and f32: against its plain version, each row bitwise equal to the
             same row of one cold launch over the whole sequence, the same
             bits on a rerun, read in place; timed beside SDPA with
             ``causal_lower_right``, its bound the larger of 4·H·Dh·Sq·
             (q_start + (Sq+1)/2) operations and the bytes of q, out and K/V
             rows [0, Sk);
5. main path full-width llama3.2-3b with random weights from a seed, once
             per format, each quantized on the card (q=4, g=128, iters=4)
             and served by an ``Engine`` with fused QKV / gate-up:
             - ``bcq``: ``generate`` for 4 prompts batched, once per request
               as ``--sequential`` serves them, and batched again with every
               quantized linear on the paper's LUT kernel;
             - ``uniform``, ``dequant``, ``ternary``, ``codebook``:
               ``generate`` batched; every ternary linear of the bf16 model
               must take K4's tensor-core path.
             Every prefill's attention runs on K8. Launch counts are set to
             0 just before each path's run and read just after; each path
             must launch its kernels the expected number of times and take
             the ref oracle never. Decode steps replay a captured graph,
             whose launches the census adds once a replay from its capture's
             counts. Every capture is dumped (``CUDAGraph.debug_dump``) and
             its graph's kernel nodes must be, wrapper by wrapper, the
             launches its capture counted (K1 and K2 together: one device
             kernel; K4's tensor-core ones apart): ``inspect_captures``. A
             traced rerun of each path's batched ``generate`` must have the
             census of one such run, and its trace must show launches of
             every kernel the census counted and no more launches than it
             (a trace is a lower bound: the profiler drops records; the
             census counts one launch a row slab where a call is wider than
             a slab, ``grouptable.Plan.slab_rows``). Each path's logits are then held against
             the same engine under ``impl_mode("ref")``, and a reduced f32
             model per format against its oracle within the kernels'
             tolerance. Meanwhile a process of its own runs the dry run
             (``launch/dryrun.py``, on meta tensors) of the steps phases 10
             and 17 hold it to (``DryRun``);
6. serving   the continuous-batching path on the bcq model: 12 requests of
             16 new tokens, prompts of 16 to 512 tokens (so K8 sees ragged
             S), greedy and sampled, through 4 slots with chunk 8. Every
             admission prefills through K8; greedy completions must equal a
             solo ``generate`` of each request, with the largest logit
             difference between a slot batch and solo forwards reported;
             tok/s, TTFT p50/p95 and the device's busy share are reported;
             the launches expected count one a row slab of each prompt's
             rows (``slab_launches``), and the profiled rerun's trace is
             held to the census as in phase 5.
             Then one request of ``LONG_SEQ_THRESHOLD`` = 8192 prompt tokens
             and 8 new tokens through the scheduler: its prefill time and
             peak device memory above the resident weights and cache, against
             the ~6.4 GB of f32 logits per layer that ``_sdpa`` would need,
             and its greedy tokens against the same request under
             ``impl_mode("ref")`` (``_sdpa_qchunked`` at this length);
7. spec      self-speculative decoding (``SpecConfig(2, 4)``; ternary
             ``(1, 4)``) at full width and the first ``SPEC_LAYERS`` = 8 of
             the 28 layers (views of phase 5's weights, ``depth_view``: the
             smoke's time budget): a batched ``generate`` (4
             prompts of 16 tokens, 16 new) on the bcq model, on it under
             ``impl_mode("lutgemm")`` and on the ternary model must give the
             plain greedy tokens; each run's launches, counted by (kernel,
             planes, rows) (``kernel_census``), must be what the chunk
             structure predicts (both prefills at q and q' planes, γ + 1 draft
             steps at q' planes and B rows, one verify at q planes and
             B·(γ+1) rows a chunk), K8 twice a layer, the ref oracle never,
             and every (kernel, planes, rows) launched must be one phase 3
             held to its plain version. A fourth run drafts with all q = 4
             planes (``SpecConfig(4, 4)``: the draft is the target) and must
             accept every proposal, so the verify's rows 1..γ, the
             multi-token commit and the draft cache's continuity are
             exercised at that depth. Then phase 6's 12 requests through a speculative 4-slot
             scheduler, the temperature-1.0 requests opted out: every greedy
             and opted-out request must equal its solo plain ``generate`` at
             the same depth,
             with the launches predicted the same way. Each run prints its
             acceptance, chunks, tok/s and TTFT beside the plain run's, and
             the device-busy share of a profiled second run; the device time
             of one draft step, one q = 4 step and one verify forward too;
8. prefix    the prefix cache and chunked prefill on the bcq model at 28
             layers: 12 requests sharing a 512-token system prompt, each
             with a 16-64-token tail and 16 new tokens (temperatures 0, 1.0,
             0.7), through 4 slots, chunk 8, after a warm-up of 6 of them on
             a cache of their own: a cold wave and an identical
             warm wave against one ``PrefixCache(block_tokens=16, max_bytes
             = 256 MB)`` with ``prefill_chunk=128``, then the same requests
             whole-shot without a cache. Every request's tokens and its
             last-prompt logits must be equal (bitwise) in all three, greedy
             ones equal to solo ``generate``, the warm wave must hit on every
             request, the accounting must be clean, and K8 must launch L
             times a prefill dispatch (offset ones counted apart); then each
             admission's device time cold against warm. Then phase 6's
             8192-token request through a 1-slot scheduler with
             ``prefill_chunk=1024`` (8 chunks, the last at q_start = 7168):
             tokens and last-prompt logits bitwise equal to phase 6's
             whole-shot run, its prefill time and peak memory beside it.
             What a cold wave costs: the cold wave, a cold wave with
             whole-shot admissions and the run without a cache, each again
             on a fresh cache, untraced and then traced (device busy share,
             device ms by part: K8, K1/K2, copies, the rest). Last, every
             shape the phase launched is held to its plain version: each
             (kernel, planes, rows, leaf) of K1/K2 that phase 3 did not
             check is checked, and each K8 (q_start, Sq) against its plain
             version and the rows of one cold launch;
9. kernels  one JSON line listing every kernel, its launches
             (``spec_launches``: on phase 7's runs; K8's ``offset_launches``:
             on phase 8's; K9's on phase 12's main path, K10's and K11's on
             phase 13's, K12's on phase 14's) and its numbers,
             printed last but one;
10. graphs   captured decode and the int8 cache, at 28 layers. Every
             format's batched ``generate`` of phase 5 (and bcq under
             ``impl_mode("lutgemm")``): 16 greedy decode steps replayed
             from the engine's decode graph (``infer/graphs.py``) against
             the eager loop, every step's logits bit for bit, then a sampled
             ``generate`` with the graph and with ``scan=False``, tokens and
             census equal; a traced rerun of each loop has its census and
             its trace shows every counted kernel, as in phase 5; each
             loop's wall, tok/s, device-busy share,
             kernel-wrapper launches and traced device events a step, and
             the graph's pool (the reserved memory its capture took, with
             the allocator's cache emptied first: ``inspect_captures``).
             Phase 6's 12 requests through 4 slots with the slot graph and
             with the eager slot loop (``engine._EAGER_SLOT_STEPS``): tokens
             and census equal, the same trace checks, wall, tok/s, TTFT and
             busy share of each. Then the int8 cache (``kv_cache_dtype="int8"``): the
             decode step's device time with the bf16 and the int8 cache at
             B = 64 and 4, ``max_seq`` 2048 (graph replays, median of 7),
             with the caches' and each capture's pool bytes; full-width int8 decode
             logits within 5% (relative L2, the reference's bound) of the
             bf16 cache's on the same tokens, prefill logits equal; greedy
             speculative == plain and slot == solo (12 requests, greedy and
             sampled) bit for bit; a warm prefix-cache admission and the
             8192-token request in 8 chunks, each within 5% of its cold
             whole-shot admission. The dry run of each of the four decode
             steps (bcq q = 4, 1 x 1 mesh): its argument bytes, the params
             as quantized plus the cache, equal the engine's resident
             tensors' bytes exactly (``[dryrun]`` lines);
11. session  the async serving session (``launch/server.py::ServeSession``,
             driven in-process with asyncio: the card's machine has no
             aiohttp) on the bcq model at 28 layers, phase 6's 12 requests,
             4 slots, chunk 8, each session on a fresh slot state: observed
             (tracer on the engine and the scheduler, metrics registry) and
             unobserved, every stream bit for bit phase 6's solo
             ``generate``, the decode chunks replaying the slot graph
             captured on the pump thread, the launches as phase 6 expects
             them; the observed session's Chrome trace valid with all 12
             request lanes, ``counters_agree`` empty and the Prometheus
             ``kernel_launches_total`` equal to the census. One request
             cancelled at its first tokens (its budget 4x): the survivors
             exact. A warmed session (its graph captured before) profiled
             by ``torch.profiler`` started and stopped on the pump thread
             (``ServeSession.call_on_pump``), its first 2 requests, 8 new
             tokens each (a solo stream's first 8), the trace written to
             ``chiprun_out/serve_profile.json`` (~25 MB): every
             ``engine/*`` scope the run entered must be in it, and each
             scope's count, host ms and device ms (kernels by the
             correlation of their launch) are printed. Last, tok/s observed
             against unobserved, 3 warmed runs each, alternating, medians
             (printed, not bounded);
12. hybrid   recurrentgemma-9b (the hybrid family: 26 RG-LRU blocks and 12
             local-attention blocks on a 2048-row ring, Dh 256, one KV
             head) at full width and all 38 layers, random weights from
             seed 0, bcq quantized on the card (q = 4, g = 128, iters = 4),
             after every earlier model is freed. K9 (``rglru_scan``)
             against its plain loop bit for bit at (B, S) = (1, 3000), (4,
             1), (64, 1), (4, 20), W = 4096, timed by graph replay beside
             its byte bound, each line with its path (ring or short) and
             blocks. The main path: a batched ``generate`` (4
             prompts of 16 tokens, 32 new) in a counted window, K1/K2 and
             K9 launched as the blocks predict, K8 and the oracle never;
             captured against eager, logits, sampled tokens and census bit
             for bit (every capture's graph nodes its counted launches,
             ``inspect_captures``), each loop profiled. At the first 14
             layers (``HYBRID_SIDE_LAYERS``: 4 of the 12 (rglru, rglru,
             local_attn) patterns and the remainder, views of the weights;
             the smoke's time budget since phase 15): a 3000-token prompt
             (the ring wraps inside the prefill) and 32 new tokens: prefill
             time, decode tok/s, peak memory above the weights, 8
             teacher-forced steps against ``impl_mode("ref")`` within 3e-2
             of max|logit|, K8 never. 8 requests (prompts of 16..2600
             tokens, 16 new) on 4 slots == solo ``generate``;
             ``SpecConfig(2, 4)`` greedy == plain on 2 prompts of 2100
             tokens (the acceptance printed). A wave of 6 requests sharing
             a 512-token prompt, cold then warm against a prefix cache,
             tokens and last-prompt logits bit for bit, and a 2200-token
             prompt that neither matches nor commits; the int8 ring cache's
             forced decode logits within 5% (relative L2) of the bf16
             cache's and its slot == solo. Every (kernel, planes, rows,
             leaf) of K1-K4 these runs launched is held to its plain
             version. Last, uniform, ternary, codebook, dequant and bcq on
             ``lutgemm`` at full width and 5 layers: one batched
             ``generate`` each, launches counted, logits within 3e-2 of
             the ref path. K9 joins the kernels line;
13. xlstm    xlstm-125m (the ssm family: 6 mLSTM and 6 sLSTM cells, d_model
             768, 4 heads, mLSTM Dh 384, sLSTM Dh 192, no MLP) at full width
             and all 12 layers, random weights from seed 0, bcq on the card.
             K10 (``mlstm_scan``) and K11 (``slstm_scan``) against their
             plain loops within 2e-4 at (B, S) = (4, 1), (4, 5), (1, 3000),
             (64, 1), the same bits on a rerun, a scan of S <= 5 equal to
             S single steps, timed by graph replay beside their bounds
             (K10's no-FMA instruction floor too), each line with its
             plan's blocks. The main path: a batched ``generate`` (4 × 16 + 32) in a counted
             window, K1 67, K10 6 and K11 6 launches a forward, K2, K8 and
             the oracle never; captured against eager (logits, sampled
             tokens, census bit for bit; the graph's kernel nodes K1 67, K10
             6, K11 6), each loop profiled; logits against the ref path as
             in phase 12. A 3000-token prompt and 32 new tokens (prefill
             time, decode tok/s, peak memory, 8 forced steps against the ref
             path); 8 requests (16..2600 tokens) on 4 slots == solo;
             ``SpecConfig(2, 4)`` greedy == plain and ``SpecConfig(4, 4)``
             accepting every proposal; a 512-token shared prompt cold then
             warm against a prefix cache of boundary states, tokens and
             last-prompt logits bit for bit. Then uniform, ternary,
             codebook, dequant and bcq on ``lutgemm`` at full width and
             depth, launches counted, logits against the ref path; every
             (kernel, planes, rows, leaf) of K1-K7 the phase launched is
             held to its plain version. K10 and K11 join the kernels line;
14. moe      olmoe-1b-7b (the MoE family: 16 ``attn_moe`` layers, d_model
             2048, 16 heads of 128, 64 experts, top-8, ``moe_d_ff`` 1024) at
             full width and depth, random weights from seed 0, bcq on the
             card (q = 4, g = 128, iters = 4; time, packed GB, solver peak).
             K12 (``expert_mm``: every expert of a bank in one launch, its
             empty row tiles skipped, gate and up paired) at olmoe's two
             bank shapes for capacities 8, 16 and 80 (a decode step at B =
             4, the batched prefill, a 512-token prompt), bf16 and f32:
             within 2e-4 of its plain version, every expert's rows bit for
             bit K1 called on that expert alone (also with per-expert row
             counts: empty experts, partial tiles, the rest zero), the same
             bits on a rerun, one launch a bank, timed beside its byte
             bound, its plain version and ``torch.bmm`` of bf16 buffers
             against the bank pre-dequantized to bf16; uniform's K12 at one
             shape; the decode step itself (16 layers of gate + up paired,
             then down, on a random top-8 routing of 4 tokens: 32 launches)
             timed beside its bound over the live experts and over all, the
             library's bmm and its plain version, and held to K1 bit for
             bit; K8 at olmoe's heads. The
             main path: a batched ``generate`` (4 × 16 + 32 new) in a counted
             window, K1, K2, K8 and K12 launched as the parameter tree
             predicts (``forward_counts_of``), the oracle never; captured
             against eager (logits, sampled tokens, census bit for bit; the
             graph's kernel nodes its counted launches); both decode loops
             profiled (device ms a step, busy share, ms by part: K12, K1/K2,
             the dispatch's sorts / scans / scatters / gathers, the rest;
             the largest kernels), and one MoE layer's dispatch (router,
             sorts, buffers, combine) timed apart: ``moe_apply`` less its
             two K12 launches on the same routing. Logits: the f32-compute kernel path
             within 3e-2 of the f32-weight oracle (gated), the bf16 paths'
             distances and the share of (token, layer) top-8 sets the bf16
             kernel and ref paths agree on (reported). A 512-token prompt at
             B = 1: prefill time, peak memory, launches. The four refusals
             (slots, speculation, prefix cache, chunked prefill) raise with
             the reference's words. Every launched K12 bank shape was held
             to its plain version, every K1/K2 shape is checked. Last,
             llama4-maverick reduced (d_model 512, 128 experts, top-1, the
             shared expert, dense / MoE interleaved every 2 of 4 layers, bf16
             through the kernels): K12 at E = 128 against its plain version,
             a batched ``generate`` with the predicted census, captured ==
             eager. K12 joins the kernels line;
15. families the vlm and audio families, bcq on the card (q = 4, g = 128,
             iters = 4; time, packed GB, solver peak), each model alone on
             the card. musicgen-medium (48 ``attn`` layers, d_model 1536, 24
             heads of 64, d_ff 6144, 2048 codes; frame-embedding inputs) at
             full width and depth: K8 at its heads against its plain
             version; a batched ``generate`` of 4 × 16 seeded bf16 frames +
             32 codes through an ``embed_fn`` over a seeded bf16 codebook
             (2048 × 1536) in a counted window, K1 / K2 / K8 launched as the
             parameter tree predicts (``forward_counts_of``), the oracle
             never; captured against eager (every step's logits, a sampled
             run's codes and census, bit for bit; the graph's kernel nodes
             its counted launches); both decode loops profiled (device ms a
             step, busy share, ms by part); the batched prefill and a
             512-frame prompt (time, peak memory, launches); the
             f32-compute kernel path within 3e-2 of the f32-weight oracle.
             llama-3.2-vision-90b (d_model 8192, 64 / 8 heads of 128, d_ff
             28672, vocab 128256, 1601 image tokens) at full width and one
             period of its 100 layers (4 ``attn``, 1 ``cross``; the whole
             model cannot be quantized on one card): K8 at its heads and K1
             at the cross block's ``wk`` / ``wv`` over 4 × 1601 image rows
             against their plain versions, timed beside their bounds; the
             same main path with seeded bf16 image embeddings (4, 1601,
             8192), the cross attention of a decode step timed apart;
             ``SpecConfig(2, 4)`` greedy == plain; a ``generate`` without
             image embeddings == one given zeroed ones; the prefill; the
             f32-compute oracle check. Every (kernel, planes, rows, leaf)
             of K1 / K2 both models launched is held to its plain version;
16. tp       tensor-parallel serving (``Engine(mesh=...)``): llama3.2-3b
             bcq at full width and depth split over two ranks on the one
             card (``launch/_ranks.py``: spawned processes, gloo, since
             NCCL refuses two ranks of one communicator on one GPU; the
             collectives are host round trips, so this shows correctness
             and shard-shape kernel times, not TP speed). Phase 5's packed
             weights reach the ranks through a file under a temporary
             directory (not quantized again); each rank loads the built
             kernels, never compiles. Gates: the f32-compute model's greedy
             tokens at tp = 2 equal tp = 1's (run here on the same packed
             weights), its prefill and step logits within 1e-3 of
             max|logit| (the reference's ``LOGIT_TOL``); the bf16 model's
             distance to tp = 1 and to the f32-weight oracle and its first
             differing token reported (the 3e-2 watch rule); every rank
             the same tokens and logits; at the first 8 layers, within the
             tp = 2 engine, slot == solo (phase 6's 12 requests, 4 slots,
             chunk 8), ``SpecConfig(2, 4)`` == plain and warm == cold
             (phase 8's 512-token shared prompt), bit for bit; 2L + 1
             collectives a forward; K1/K2 and K8 launched on each rank's
             main path (counts reset just before, read just after, in the
             kernels line as ``tp_launches``) and every launched (kernel,
             planes, rows, shard leaf) and K8 shape at the local heads (12
             / 4 of 128) held to its plain version. Printed: each rank's
             device ms of a decode step and of the prefill by part (K1/K2,
             K8, the collectives' copies, the rest), K1/K2 at each shard
             leaf beside its byte bound, its plain version and the library,
             tok/s with the card named;
17. train    the training runtime (``train/``, ``launch/train.py``) and
             the paper's whole workflow. llama3.2-3b at full width and
             depth, bf16 parameters from ``init_params(cfg, seed=0)``,
             trained ``TRAIN_STEPS`` steps of 4 x 256 ``MarkovCorpus``
             tokens through ``launch/train.py``'s ``main --full-size``
             (remat, AdamW; the step's forward and backward on the plain
             route, ``impl_mode("ref")``, as the reference trains): each
             step's loss and wall, the peak memory and the straggler
             count; the loss finite and its last value below its first.
             The dry run of the step (1 x 1 mesh, every layer traced): its
             argument bytes (params, AdamW state, a batch) equal the card's
             tensors exactly, and its predicted peak (arguments +
             temporaries) is within 25% of the measured peak
             (``max_memory_allocated`` above the memory allocated before
             the run), both on one ``[dryrun]`` line with their ratio.
             The trained weights quantized to bcq (q = 4, g = 128, iters =
             4) and served: a batched ``generate`` (4 x 16 + 16) whose K1/K2
             and K8 launches the census counts (each above 0, as the
             parameter tree predicts, counts reset just before and read just
             after, in the kernels line as ``train_launches``), every
             launched shape held to its plain version; the held-out NLL of
             the dense and the bcq model on a fresh corpus batch (the
             paper's Figs. 5/6 quantity, reported); the kernel path's
             logits against the ref path and the f32-weight oracle (the
             f32-compute arm gated, bf16 reported under the 3e-2 watch
             rule). One ``loss_fn`` gradient of a reduced f32 llama3.2-3b
             on the card against the CPU's, within ``GRAD_TOL`` of each
             leaf's max|g|; a CUDA forward with grad-requiring inputs
             outside ``impl_mode("ref")`` raises (K8, K1, and through the
             model). The reduced model through the CLI with ``--ckpt-dir``:
             a SIGTERM stops it with a final checkpoint at that step, which
             restores onto the card bit for bit, and a rerun resumes from
             it to the end;
18. last line ``{"ok": true, "device": {...}}``.

Timing: repeated calls after warm-up are captured in a CUDA graph and timed
with CUDA events around its replay (median of 7), so a time is the device's
and not the host's per-call cost. Weight copies
are rotated so that repeated launches read weights from device memory, not
from the 50 MB L2, as a decode step does. Phase 5 also traces one batched
``generate`` per format with ``torch.profiler`` for the device's busy time
by kernel, and reads each path's peak device memory.

It needs a CUDA GPU and the repository's ``src/`` beside it; without either
it exits non-zero before printing any result. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
import weakref
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = torch.device("cuda")

# H100 SXM data-sheet peaks (dense): HBM rate, f32 CUDA-core and bf16
# tensor-core rates
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# f32 instructions a second, one a lane: 132 SMs x 128 lanes at the 1.98 GHz
# boost clock (67 TFLOP/s counts an FMA as two operations)
F32_ISSUE_PER_S = 132 * 128 * 1.98e9
# kernel vs its plain version, rtol = atol, for f32 and bf16 inputs alike: both
# sides widen the same x and scales to f32 and accumulate in f32
KERNEL_TOL = 2e-4
LOGITS_REL_TOL = 3e-2  # engine vs ref oracle, bf16 model: max|Δ| / max|ref|

Q, G = 4, 128
PROMPTS, PROMPT_LEN, NEW_TOKENS = 4, 16, 16
# (leaf, k, o, fused out_dims or None) of llama3.2-3b
LEAVES = {
    "wqkv": (3072, 5120, (3072, 1024, 1024)),
    "wo": (3072, 3072, None),
    "w_gate_up": (3072, 16384, (8192, 8192)),
    "w_down": (8192, 3072, None),
    "lm_head": (3072, 128256, None),
}
SWEEP = [  # (B, k, o, q, g): the reference's kernel sweep
    (1, 512, 256, 2, 64),
    (8, 512, 128, 4, 512),
    (8, 1024, 256, 3, 128),
    (16, 512, 384, 1, 8),
    (4, 1024, 128, 5, 1024),
    (2, 2048, 256, 2, 2048),
]
# kernel: (CUDA source, replaced TPU kernel, leaves it serves, format)
KERNELS = {
    "bcq_mm": ("csrc/bcq_mm.cu", "src/repro/kernels/bcq_mm.py:138", ("wo", "w_down", "lm_head"), "bcq"),
    "bcq_mm_fused": ("csrc/bcq_mm.cu", "src/repro/kernels/bcq_mm_fused.py:63", ("wqkv", "w_gate_up"), "bcq"),
    "lutgemm": ("csrc/lutgemm.cu", "src/repro/kernels/lutgemm.py:149", tuple(LEAVES), "bcq"),
    "uniform_mm": ("csrc/uniform_mm.cu", "src/repro/kernels/uniform_mm.py:130", tuple(LEAVES), "uniform"),
    "dequant_materialize": ("csrc/dequant_mm.cu", "src/repro/kernels/dequant_mm.py:106", tuple(LEAVES),
                            "dequant"),
    "ternary_mm": ("csrc/ternary_mm.cu", "src/repro/kernels/ternary_mm.py:140", tuple(LEAVES), "ternary"),
    "codebook_mm": ("csrc/codebook_mm.cu", "src/repro/kernels/codebook_mm.py:145", tuple(LEAVES), "codebook"),
}
FLASH = ("flash_attention", "csrc/flash_attn.cu", "src/repro/kernels/flash_attn.py:109")
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}  # the reference test's tolerances
LLAMA_HEADS = (24, 8, 128)  # llama3.2-3b: H, Hkv, Dh
FLASH_S = (1, 16, 17, 100, 512, 2048, 8192)
# K8's offset entry (a prompt chunk, or a suffix after a cached prefix): (q_start, Sq) at B = 1
# (the first chunk, the last chunk of the 8192-token prompt) and two shapes of phase 8's:
# a 128-query chunk at a tile-aligned q_start and a 3-token warm suffix that straddles a key tile
FLASH_OFFSETS = ((512, 32), (7168, 1024), (384, 128), (544, 3))
FLASH_EXTRA = [  # (B, S, H, Hkv, Dh): the reference test's shapes, then Dh 16 and 64
    (2, 512, 4, 4, 64), (1, 1024, 8, 2, 32), (2, 512, 6, 1, 64), (1, 512, 2, 2, 128),
    (2, 300, 4, 2, 16), (1, 777, 8, 4, 64),
]
# the continuous-batching phase: prompt lengths over 16..512 (ragged for K8)
SERVE_PROMPT_LENS = (16, 512, 37, 200, 100, 17, 300, 64, 450, 129, 24, 256)
SERVE_SLOTS, SERVE_CHUNK = 4, 8
# self-speculative decoding (phase 7): q' draft planes, gamma proposals a chunk;
# a speculative dispatch of the scheduler runs SPEC_CHUNK chunks
SPEC_Q, SPEC_GAMMA, SPEC_Q_TERNARY = 2, 4, 1
SPEC_CHUNK = 2
VERIFY_ROWS = PROMPTS * (SPEC_GAMMA + 1)  # a batched generate's verify: B·(γ+1) rows
DRAFT_Q = (1, 2)
# the bcq model's leaves and the kernel each one launches (fused leaves: K2)
BCQ_LEAF_KERNELS = {"wqkv": "bcq_mm_fused", "wo": "bcq_mm", "w_gate_up": "bcq_mm_fused", "w_down": "bcq_mm",
                    "lm_head": "bcq_mm"}
LONG_NEW = 8
LONG_CHUNK = 1024  # phase 8: the 8192-token request prefilled in chunks of this many tokens
# phase 8, the prefix cache: 12 requests share a system prompt of PREFIX_LEN
# tokens, each with its own tail of 16..64 tokens
PREFIX_LEN, PREFIX_BLOCK, PREFIX_CHUNK, PREFIX_CACHE_BYTES = 512, 16, 128, 256 << 20
PREFIX_TAILS = (16, 64, 23, 40, 31, 57, 18, 48, 35, 62, 27, 44)
# dense prompt rows (phase 3): the widths timed, and the row tiles compared
PROMPT_ROWS = (512, 8192)
PROMPT_TILES = (64, 128)
# the formats served after bcq, with the kernel each one's path launches
FORMAT_KERNEL = {"uniform": "uniform_mm", "dequant": "dequant_materialize", "ternary": "ternary_mm",
                 "codebook": "codebook_mm"}
# part of the device kernel names of each format's path (bcq: K1 and K2; ternary's
# bf16 model: K4's tensor-core kernel)
PROFILE_TAG = {"bcq": "BCQGroups", "uniform": "UniformGroups", "dequant": "dequant_kernel",
               "ternary": "ternary_tc_kernel", "codebook": "codebook_kernel"}
# the (x, scales) dtype pairs each kernel is checked at: K4 takes the tensor
# cores for bf16/bf16 and the group-table kernel for the other three
SAME_DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32))
DTYPE_PAIRS = {"ternary_mm": SAME_DTYPES + ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))}
# part of K8's device kernel names: bf16 on the tensor cores, f32 on the CUDA cores
FLASH_TAGS = ("flash_tc_kernel", "flash_kernel")
# part of the device kernel names each kernel wrapper launches, one kernel a
# call: K1 and K2 launch one kernel, grouptable_kernel over BCQGroups, so a
# trace holds their sum; K4 its tensor-core kernel or the group table over
# TernaryGroups; K8 either of its two kernels
TRACE_TAGS = {
    ("bcq_mm", "bcq_mm_fused"): ("BCQGroups",),
    ("lutgemm",): ("lutgemm_kernel",),
    ("uniform_mm",): ("UniformGroups",),
    ("dequant_materialize",): ("dequant_kernel",),
    ("ternary_mm",): ("ternary_tc_kernel", "TernaryGroups"),
    ("codebook_mm",): ("codebook_kernel",),
    ("flash_attention",): FLASH_TAGS,
    ("rglru_scan",): ("rglru_scan_kernel",),
    ("mlstm_scan",): ("mlstm_scan_kernel",),
    ("slstm_scan",): ("slstm_scan_kernel",),
    ("expert_mm",): ("expert_grouptable_kernel",),
}
# K12's device kernel; its name also holds its format's decoder (BCQGroups, ...), so
# a name holding it counts as K12's alone (``tagged``)
EXPERT_TAG = "expert_grouptable_kernel"


def tagged(text, tags):
    """Whether a device kernel's name (or a graph node's statement) ``text``
    is one of the kernels ``tags`` names: K1's tag matches K12's names too,
    which count for K12 only."""
    return any(tag in text for tag in tags) and (EXPERT_TAG in tags or EXPERT_TAG not in text)
L2_BYTES = 50 * 2**20
# phase 10: the decode step's device time with the bf16 and the int8 cache,
# at these widths (the widest first) and this cache length; int8
# logits within the reference's bound of the bf16 cache's
INT8_BATCHES, INT8_MAX_SEQ = (64, 4), 2048
INT8_REL_L2 = 5e-2  # tests/test_models.py::test_int8_kv_cache_decode_close_to_exact


# phase 11: the serving session's runs (each on a fresh slot state, so each
# captures its slot graph); the profiled window serves the first
# SESSION_PROFILED requests, PROFILED_NEW tokens each (one decode chunk):
# its Chrome trace holds ~2700 kernel events a decode step, ~0.8 KB each
# (4 requests of 16 tokens wrote 66.2 MB)
SESSION_OVERHEAD_RUNS, SESSION_PROFILED, PROFILED_NEW = 3, 2, SERVE_CHUNK
SESSION_CANCEL = 3  # the request cancelled mid-flight (index into phase 6's 12)
POOL_BYTES = weakref.WeakKeyDictionary()  # DecodeGraph → device memory its capture reserved
CAPTURE_THREADS = weakref.WeakKeyDictionary()  # DecodeGraph → the thread that captured it
GRAPH_NODES = weakref.WeakKeyDictionary()  # DecodeGraph → {wrapper group: kernel nodes in its CUDA graph}
GRAPH_DIR = ROOT / "chiprun_out" / "graphs"  # a graph's DOT dump, kept where it disagrees


def graph_kernel_nodes(dot):
    """{wrapper group (``TRACE_TAGS``): kernel nodes} of a CUDA graph's DOT
    dump (``cudaGraphDebugDotPrint``), each node statement counted once by
    the kernel name it holds; K4's tensor-core nodes also apart."""
    stmts = re.split(r'(?m)^(?=\s*"[^"\n]+"\s*\[)', dot)[1:]
    nodes = {"+".join(group): sum(tagged(st, tags) for st in stmts)
             for group, tags in TRACE_TAGS.items()}
    nodes["ternary_mm on the tensor cores"] = sum("ternary_tc_kernel" in st for st in stmts)
    return nodes


def capture_counts(graph):
    """{wrapper group: launches} a decode graph's capture counted (the counts
    each replay adds), in ``graph_kernel_nodes``'s keys."""
    from repro_torch.kernels import COUNTERS

    delta = {(obj.__name__, attr): d for (obj, attr), d in zip(COUNTERS, graph.delta)}
    out = {"+".join(group): sum(delta[(w, "launches")] for w in group) for group in TRACE_TAGS}
    out["ternary_mm on the tensor cores"] = delta[("ternary_mm", "tc_launches")]
    return out


def inspect_captures():
    """From here on every decode-graph capture (``infer/graphs.py``) is
    checked and measured. Its CUDA graph is made in debug mode and dumped
    (DOT): the kernel nodes it recorded must be, wrapper by wrapper, the
    launches its capture counted, which every replay adds to the census
    (a replay runs every node of its graph; at decode widths a call is one
    launch, never a row slab's several). And ``POOL_BYTES`` records the
    device memory the capture reserved: the allocator's cache emptied
    first, reserved bytes after the capture less before it. Checks and
    measurements of this script's, kept out of the serving path."""
    from repro_torch.infer.graphs import DecodeGraph

    real, Graph = DecodeGraph._capture, torch.cuda.CUDAGraph
    kept = []  # whether the graph being captured keeps its cudaGraph_t (keep_graph)

    def debug_graph():
        try:
            g = Graph(keep_graph=True)
            kept.append(True)
        except TypeError:  # a torch without keep_graph keeps it in debug mode
            g = Graph()
            kept.append(False)
        g.enable_debug_mode()
        return g

    def inspected(graph):
        CAPTURE_THREADS[graph] = threading.current_thread().name
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        kept.clear()
        torch.cuda.CUDAGraph = debug_graph
        try:
            real(graph)
        finally:
            torch.cuda.CUDAGraph = Graph
        if kept[0]:
            graph.graph.instantiate()
        POOL_BYTES[graph] = torch.cuda.memory_reserved() - before
        GRAPH_DIR.mkdir(parents=True, exist_ok=True)
        path = GRAPH_DIR / f"graph-{id(graph):x}.dot"
        with warnings.catch_warnings():  # debug_dump warns that it is a debugging call
            warnings.simplefilter("ignore")
            graph.graph.debug_dump(str(path))
        if not path.is_file():
            raise SystemExit(f"chip_smoke: CUDAGraph.debug_dump wrote no {path} (torch {torch.__version__})")
        nodes, counted = graph_kernel_nodes(path.read_text()), capture_counts(graph)
        if nodes != counted:
            raise SystemExit(f"chip_smoke: a decode graph (B = {graph.batch}, impl mode {graph.mode}) recorded "
                             f"kernel nodes {nodes}, its capture counted {counted} (dump: {path})")
        path.unlink()
        GRAPH_NODES[graph] = nodes

    DecodeGraph._capture = inspected


def log(*a):
    print(*a, flush=True)


def _calls(fn, args_list, inner):
    """Run ``inner`` calls of ``fn``, cycling through ``args_list``."""
    for i in range(inner):
        fn(*args_list[i % len(args_list)])


def _median_event_ms(run, inner, reps):
    """Median over ``reps`` of CUDA-event time around ``run()``, over ``inner``."""
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


def time_ms(fn, args_list, *, reps=7, inner=None):
    """Time of one call of ``fn`` after warm-up, cycling through ``args_list``
    (rotated weight copies). ``inner`` calls are captured once in a CUDA graph
    and its replays are timed: the device's time, without the host's per-call
    cost (Python, ctypes, allocator), which at decode shapes can exceed the
    kernel's."""
    inner = inner or max(len(args_list), 5)
    _calls(fn, args_list[:3], min(3, len(args_list)))  # lazy attributes, library handles
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        _calls(fn, args_list, inner)
    g.replay()
    torch.cuda.synchronize()
    return _median_event_ms(g.replay, inner, reps)


def n_copies(nbytes):
    return max(1, min(32, math.ceil(2.5 * L2_BYTES / max(nbytes, 1))))


def kernel_fns():
    """kernel name → (wrapper checked, plain version). ``dequant_materialize``
    is checked through its pipeline ``dequant_mm`` here and on its own in
    :func:`check_kernel`."""
    from repro_torch import kernels as K

    return {
        "bcq_mm": (K.bcq_mm, K.bcq_mm_plain),
        "bcq_mm_fused": (K.bcq_mm_fused, K.bcq_mm_plain),
        "lutgemm": (K.lutgemm, K.lutgemm_plain),
        "uniform_mm": (K.uniform_mm, K.uniform_mm_plain),
        "dequant_materialize": (K.dequant_mm, K.dequant_mm_plain),
        "ternary_mm": (K.ternary_mm, K.ternary_mm_plain),
        "codebook_mm": (K.codebook_mm, K.codebook_mm_plain),
    }


def format_planes(fmt, k, o, q, g, gen):
    """Random packed planes and f32 scales of ``fmt`` on the card, with
    weights of about 1/sqrt(k) (BCQ: its q planes sum to that)."""
    from repro_torch.core.formats import get_format

    f = get_format(fmt)
    dev = DEVICE
    packed = torch.randint(0, 256, (f.planes(q), k // 8, o), generator=gen, device=dev, dtype=torch.uint8)
    shape = f.scales_shape(q, k // g, o)
    u = (torch.rand(shape, generator=gen, device=dev) + 0.5) / math.sqrt(k)
    if fmt == "bcq":
        u = u / math.sqrt(q)
    elif fmt in ("uniform", "dequant"):  # (s, z): codes centred on 0
        s = u[0] / 2**q
        u = torch.stack([s, -s * (2**q - 1) / 2])
    elif fmt == "codebook":
        u = torch.randn(shape, generator=gen, device=dev) / math.sqrt(k)
    return packed, u


def check_kernel(name, B, k, o, q, g, dtype, gen, out_dims=None, s_dtype=None):
    """One kernel vs its plain version at one shape, x in ``dtype`` and the
    scales in ``s_dtype`` (default: ``dtype``), and against itself on a
    rerun (same bits) → record dict."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.kernels import dequant_materialize, dequant_materialize_plain

    fn, plain = kernel_fns()[name]
    fmt = KERNELS[name][3]
    f = get_format(fmt)
    s_dtype = s_dtype or dtype
    x = torch.randn((B, k), generator=gen, device=DEVICE).to(dtype)
    planes, scale_elems = f.planes(q), math.prod(f.scales_shape(q, k // g, o))
    wbytes = planes * (k // 8) * o + scale_elems * torch.finfo(s_dtype).bits // 8
    weights = []
    for _ in range(n_copies(wbytes)):
        packed, scales = format_planes(fmt, k, o, q, g, gen)
        weights.append((packed, scales.to(s_dtype)))
    packed, scales = weights[0]
    call = (lambda p, s: fn(x, p, s, g=g, out_dims=out_dims)) if out_dims else (lambda p, s: fn(x, p, s, g=g))
    y = call(packed, scales)
    y = torch.cat(y, dim=-1) if out_dims else y
    torch.cuda.synchronize()
    ref = plain(x, packed, scales, g=g)
    err = (y - ref).abs().max().item()
    again = call(packed, scales)
    same_bits = bool(torch.equal(torch.cat(again, dim=-1) if out_dims else again, y))
    tol = KERNEL_TOL
    ok = bool(torch.allclose(y, ref, rtol=tol, atol=tol)) and bool(torch.isfinite(y).all()) and same_bits
    extra = {}
    if name == "dequant_materialize":
        # the kernel: materialise (k, o) f32, held to its plain version bit for bit
        w = dequant_materialize(packed, scales, g=g)
        exact = bool(torch.equal(w, dequant_materialize_plain(packed, scales, g=g)))
        ok = ok and exact
        xf = x.float()
        extra = dict(materialize_exact=exact, dequant_mm_ms=time_ms(call, weights),
                     gemm_ms=time_ms(lambda w: torch.matmul(xf, w), [(w,)]))
        del w
        ms = time_ms(lambda p, s: dequant_materialize(p, s, g=g), weights)
        plain_ms = time_ms(lambda p, s: dequant_materialize_plain(p, s, g=g), [(packed, scales)], reps=3, inner=2)
        nbytes = wbytes + k * o * 4  # planes and scales read, the dense f32 weight written
        ops = 2.0 * k * o  # a product and a sum per weight, f32
        ops_ms = ops / PEAK_OPS[torch.float32] * 1e3
    else:
        ms = time_ms(call, weights)
        plain_ms = time_ms(lambda p, s: plain(x, p, s, g=g), [(packed, scales)], reps=3, inner=2)
        nbytes = x.numel() * x.element_size() + wbytes + B * o * 4
        ops_ms = 2.0 * B * k * o / PEAK_OPS[torch.promote_types(dtype, s_dtype)] * 1e3
    # library yardstick: bf16 x @ pre-dequantized bf16 weight
    w16 = f.dequantize(QuantizedTensor(packed=packed, scales=scales, g=g, k=k, o=o, fmt=fmt),
                       dtype=torch.bfloat16)
    x16 = x.to(torch.bfloat16)
    lib_ws = [(w16,)] + [(w16.clone(),) for _ in range(n_copies(w16.numel() * 2) - 1)]
    library_ms = time_ms(lambda w: torch.matmul(x16, w), lib_ws)
    del lib_ws, w16
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    rec = dict(
        kernel=name, format=fmt, B=B, k=k, o=o, q=planes, g=g, dtype=str(dtype).replace("torch.", ""),
        s_dtype=str(s_dtype).replace("torch.", ""), max_abs_err=err, tol=tol, same_bits=same_bits, ok=ok,
        ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations", **extra,
    )
    more = "".join(f"  {key} {val:.4f}" for key, val in extra.items() if key.endswith("_ms"))
    log(
        f"  {name:19s} B={B:<3d} k={k:<5d} o={o:<6d} q={planes} g={g:<4d} {rec['dtype']:8s} "
        f"{'' if s_dtype == dtype else 'scales ' + rec['s_dtype'] + ' '}"
        f"err {err:.2e} (tol {tol:g}) bits {'same' if same_bits else 'DIFFER'} {'ok' if ok else 'FAIL'}  ms {ms:.4f}  "
        f"plain {plain_ms:.4f}  bound {rec['bound_ms']:.4f} ({rec['bound_by']})  library {library_ms:.4f}"
        f"{more}"
    )
    return rec


class Builds:
    """Every CUDA source compiling at once, a build thread each (phase 2),
    so that work which needs none of the slow sources runs meanwhile:
    ``wait(*sources)`` joins those builds (all with none named) and fails
    the smoke if one failed; ``as_ready(names, source_of)`` yields names as
    their sources finish; ``seconds`` holds each finished source's compile
    time."""

    def __init__(self):
        from repro_torch.kernels import _build

        self.t0 = time.perf_counter()
        self.errors = {}
        self.seconds = {}
        self.threads = {n: threading.Thread(target=self._run, args=(_build, n), name=f"build-{n}")
                        for n in _build.kernel_names()}
        for t in self.threads.values():
            t.start()

    def _run(self, build, name):
        t0 = time.perf_counter()
        try:
            build.build([name])
        except BaseException as e:  # raised in the main thread by wait()
            self.errors[name] = e
        self.seconds[name] = time.perf_counter() - t0

    def wait(self, *sources):
        for n in sources or self.threads:
            self.threads[n].join()
        bad = {n: e for n, e in self.errors.items() if n in (sources or self.threads)}
        if bad:
            raise SystemExit(f"chip_smoke: the build of {sorted(bad)} failed:\n" + "\n".join(map(str, bad.values())))

    def as_ready(self, names, source_of):
        left = list(names)
        while left:
            ready = [n for n in left if not self.threads[source_of(n)].is_alive()]
            if not ready:
                time.sleep(0.1)
                continue
            for n in ready:
                self.wait(source_of(n))
                left.remove(n)
                yield n


def phase_kernels(gen, builds):
    """Every kernel of ``KERNELS`` against its plain version at the leaves and
    the sweep, each as soon as its source is built → records."""
    records = []
    prefill_rows = PROMPTS * PROMPT_LEN
    for name in builds.as_ready(KERNELS, lambda n: Path(KERNELS[n][0]).stem):
        leaves = KERNELS[name][2]
        for leaf in leaves:
            k, o, dims = LEAVES[leaf]
            for B in (1, PROMPTS, prefill_rows):
                for dtype, s_dtype in DTYPE_PAIRS.get(name, SAME_DTYPES):
                    out_dims = dims if name == "bcq_mm_fused" else None
                    rec = check_kernel(name, B, k, o, Q, G, dtype, gen, out_dims, s_dtype)
                    rec["leaf"] = leaf
                    records.append(rec)
        for B, k, o, q, g in SWEEP:
            for dtype, s_dtype in DTYPE_PAIRS.get(name, SAME_DTYPES):
                out_dims = (o // 2, o - o // 2) if name == "bcq_mm_fused" else None
                rec = check_kernel(name, B, k, o, q, g, dtype, gen, out_dims, s_dtype)
                rec["leaf"] = "sweep"
                records.append(rec)
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} kernel checks disagree with their plain versions: {bad[:3]}")
    every_width = (1, PROMPTS, prefill_rows)
    for name, batches in (("codebook_mm", every_width), ("lutgemm", (1, PROMPTS)), ("bcq_mm", every_width),
                          ("bcq_mm_fused", every_width), ("uniform_mm", every_width), ("ternary_mm", every_width)):
        for r in records:
            if r["kernel"] == name and r["leaf"] != "sweep" and is_bf16(r) and r["B"] in batches:
                log(f"  {name:12s} {r['leaf']:9s} B={r['B']:<3d} {r['ms'] * 1e3:9.2f} us = "
                    f"{r['ms'] / r['bound_ms']:6.1f}x its bound ({r['bound_by']}), "
                    f"{r['ms'] / r['library_ms']:5.2f}x the library")
    # the paper's Table 3 comparison: one decode step on each path's kernels against cuBLAS
    for path, names in STEP_PATHS.items():
        for B in (1, PROMPTS, prefill_rows):
            step = path_step(records, names, B)
            log(f"  {path} decode step B={B} bf16: {step['ms']:.3f} ms, library {step['library_ms']:.3f} ms "
                f"({step['ms'] / step['library_ms']:.2f}x), bound {step['bound_ms']:.3f} ms")
    rows_equal_solo(gen)
    return records


def is_bf16(r):
    """A record of bf16 x with bf16 scales, the bf16 model's main path."""
    return r["dtype"] == "bfloat16" and r.get("s_dtype", r["dtype"]) == "bfloat16"


def step_counts(n_layers):
    """How often one decode step of llama3.2-3b runs each leaf: once a layer, ``lm_head`` once."""
    return {"wqkv": n_layers, "wo": n_layers, "w_gate_up": n_layers, "w_down": n_layers, "lm_head": 1}


def decode_step(records, name, B, n_layers=28):
    """``name``'s bf16 times at batch ``B`` summed over one decode step of
    llama3.2-3b (each leaf once a layer, ``lm_head`` once)."""
    every = step_counts(n_layers)
    rs = [(r, every[r["leaf"]]) for r in records
          if r["kernel"] == name and r["leaf"] in every and r["B"] == B and is_bf16(r)]
    return {key: sum(r[key] * n for r, n in rs) for key in ("ms", "library_ms", "bound_ms", "plain_ms")}


def path_step(records, names, B, n_layers=28):
    """The bf16 decode step at batch ``B`` of a path whose leaves ``names``
    serve between them (K1 + K2 for bcq)."""
    steps = [decode_step(records, name, B, n_layers) for name in names]
    return {key: sum(st[key] for st in steps) for key in steps[0]}


# a decode step's kernels, by path: K3 alone, bcq's K1 + K2, K5 alone, K4 (tensor cores) alone
STEP_PATHS = {"lutgemm": ("lutgemm",), "bcq (bcq_mm + bcq_mm_fused)": ("bcq_mm", "bcq_mm_fused"),
              "uniform_mm": ("uniform_mm",), "ternary_mm": ("ternary_mm",)}


def rows_equal_solo(gen, B=16):
    """Batch invariance at ``wo``: each row of a ``B``-row call of K3, K1,
    K2, K5 and K4, and of a K1 and a K4 call 8 rows wider than their row
    slab (two launches), equals the same row called alone, bit for bit, in
    bf16 and f32 (for K4: the tensor-core path and the group-table path)."""
    from repro_torch.kernels import grouptable
    from repro_torch.kernels.ternary_mm import tc_plan

    k, o, _ = LEAVES["wo"]
    fns = kernel_fns()
    bcq_slab = grouptable.plan("bcq", k, o, Q, G, torch.bfloat16, torch.bfloat16).slab_rows(1 << 20)

    def ternary_slab(dtype):  # bf16: the tensor-core plan's slab; f32: the group-table plan's
        if dtype == torch.bfloat16:
            return tc_plan(k, o, G).slab_rows(1 << 20)
        return grouptable.plan("ternary", k, o, 2, G, dtype, dtype).slab_rows(1 << 20)

    if max(bcq_slab, ternary_slab(torch.bfloat16), ternary_slab(torch.float32)) >= 1 << 20:
        raise SystemExit("chip_smoke: a plan at wo takes no row slabs; the slab check needs a split")

    for name, slab in (("lutgemm", None), ("bcq_mm", None), ("bcq_mm_fused", None), ("uniform_mm", None),
                       ("ternary_mm", None), ("bcq_mm", lambda d: bcq_slab), ("ternary_mm", ternary_slab)):
        fn = fns[name][0]
        dims = (o // 2, o - o // 2) if name == "bcq_mm_fused" else None

        def call(x, p, s):
            return torch.cat(fn(x, p, s, g=G, out_dims=dims), dim=-1) if dims else fn(x, p, s, g=G)

        for dtype in (torch.bfloat16, torch.float32):
            rows = B if slab is None else slab(dtype) + 8
            x = torch.randn((rows, k), generator=gen, device=DEVICE).to(dtype)
            packed, scales = format_planes(KERNELS[name][3], k, o, Q, G, gen)
            scales = scales.to(dtype)
            full = call(x, packed, scales)
            differ = [r for r in range(rows) if not torch.equal(call(x[r : r + 1], packed, scales), full[r : r + 1])]
            log(f"  {name} wo rows of B={rows} against each row alone, {str(dtype).replace('torch.', '')}: "
                f"{rows - len(differ)}/{rows} bitwise equal")
            if differ:
                raise SystemExit(f"chip_smoke: {name} rows {differ[:8]} of a {rows}-row call differ from the row "
                                 f"called alone")


def table_limit(gen, B=PROMPTS):
    """K1 and K5 at ``wo`` (bf16, B = 4) for q = 1..8, and K4's group-table
    path (f32 x, bf16 alpha: the f32 model's; q = 2 planes), on the table
    path and the direct path, each held to its plain version and timed: the
    measurement behind ``grouptable.TABLE_MAX_Q`` → records."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import (bcq_mm, bcq_mm_plain, grouptable, ternary_mm, ternary_mm_plain, uniform_mm,
                                     uniform_mm_plain)

    k, o, _ = LEAVES["wo"]
    plan = grouptable.plan
    records = []
    try:
        for name, fn, plain, fmt, qs, x_dtype in (
                ("bcq_mm", bcq_mm, bcq_mm_plain, "bcq", range(1, 9), torch.bfloat16),
                ("uniform_mm", uniform_mm, uniform_mm_plain, "uniform", range(1, 9), torch.bfloat16),
                ("ternary_mm", ternary_mm, ternary_mm_plain, "ternary", (2,), torch.float32)):
            for q in qs:
                x = torch.randn((B, k), generator=gen, device=DEVICE).to(x_dtype)
                f = get_format(fmt)
                weights = []
                for _ in range(n_copies(f.planes(q) * k // 8 * o)):
                    packed, scales = format_planes(fmt, k, o, q, G, gen)
                    weights.append((packed, scales.to(torch.bfloat16)))
                ref = plain(x, *weights[0], g=G)
                row = dict(kernel=name, q=q, chosen="table" if q <= grouptable.TABLE_MAX_Q[fmt] else "direct")
                for path in ("table", "direct"):
                    grouptable.plan = functools.partial(plan, table=path == "table")
                    err = (fn(x, *weights[0], g=G) - ref).abs().max().item()
                    if not err <= KERNEL_TOL:
                        raise SystemExit(f"chip_smoke: {name} q={q} {path} path differs from its plain version: {err}")
                    row[f"{path}_ms"] = time_ms(lambda p, s: fn(x, p, s, g=G), weights)
                    row[f"{path}_err"] = err
                grouptable.plan = plan
                log(f"  {name:10s} wo B={B} q={q} x {str(x_dtype).replace('torch.', '')}: "
                    f"table {row['table_ms'] * 1e3:8.2f} us, direct "
                    f"{row['direct_ms'] * 1e3:8.2f} us (errors {row['table_err']:.1e} / {row['direct_err']:.1e}); "
                    f"the plan takes the {row['chosen']} path")
                records.append(row)
    finally:
        grouptable.plan = plan
    return records


def dense_rows_check(gen):
    """Queue 3's repair, asserted: dense bf16 linears (``utils.matmul_rows``)
    and ``dequant_mm`` told its rows are decode rows give each row of a B-row
    call the bits of the row called alone, at B in {4, 9, 16, 64}, at
    ``wo`` and ``w_gate_up``; tolerance 0. Then what the repair costs: per
    leaf at B = 1, 4 and 64, one product before (``torch.matmul``; for
    ``dequant`` materialise, then one f32 product) against the row tiles
    after, summed over a decode step → dict of records and steps."""
    from repro_torch.kernels import dequant_materialize, dequant_mm
    from repro_torch.utils import ROW_TILE, matmul_rows

    out = []
    for leaf in ("wo", "w_gate_up"):
        k, o, _ = LEAVES[leaf]
        w16 = (torch.randn((k, o), generator=gen, device=DEVICE) / math.sqrt(k)).to(torch.bfloat16)
        packed, scales = format_planes("dequant", k, o, Q, G, gen)
        scales = scales.to(torch.bfloat16)
        for B in (4, 9, 16, 64):
            x = torch.randn((B, k), generator=gen, device=DEVICE).to(torch.bfloat16)
            for path, call in (("dense bf16", lambda a: matmul_rows(a[:, None], w16)[:, 0]),
                               ("dequant_mm", lambda a: dequant_mm(a, packed, scales, g=G, token_rows=True))):
                full = call(x).float()
                alone = torch.cat([call(x[r : r + 1]) for r in range(B)]).float()
                diff = (full - alone).abs().max().item()
                rows = int((full != alone).any(dim=-1).sum())
                log(f"  {path:10s} {leaf:9s} B={B:<2d}: {rows}/{B} rows differ from the row alone, "
                    f"max|d| {diff:.3e} (tolerance 0)")
                out.append(dict(path=path, leaf=leaf, B=B, rows_differ=rows, max_abs_diff=diff))
    bad = [r for r in out if r["rows_differ"]]
    if bad:
        raise SystemExit(f"chip_smoke: dense / dequant rows differ from the row alone: {bad[:4]}")

    costs, steps = [], {}
    widths = (1, PROMPTS, PROMPTS * PROMPT_LEN)
    for leaf, (k, o, _) in LEAVES.items():
        w16 = (torch.randn((k, o), generator=gen, device=DEVICE) / math.sqrt(k)).to(torch.bfloat16)
        ws = [(w16,)] + [(w16.clone(),) for _ in range(n_copies(w16.numel() * 2) - 1)]
        qs = []
        for _ in range(n_copies(Q * k // 8 * o)):
            packed, scales = format_planes("dequant", k, o, Q, G, gen)
            qs.append((packed, scales.to(torch.bfloat16)))
        for B in widths:
            x = torch.randn((B, k), generator=gen, device=DEVICE).to(torch.bfloat16)
            xf = x.float()
            rec = dict(leaf=leaf, B=B,
                       dense_before_ms=time_ms(lambda w: torch.matmul(x, w), ws),
                       dense_after_ms=time_ms(lambda w: matmul_rows(x[:, None], w), ws),
                       dequant_before_ms=time_ms(lambda p, s: torch.matmul(xf, dequant_materialize(p, s, g=G)), qs),
                       dequant_after_ms=time_ms(lambda p, s: dequant_mm(x, p, s, g=G, token_rows=True), qs))
            log(f"  cost at {leaf:9s} B={B:<3d}: dense bf16 {rec['dense_before_ms'] * 1e3:8.2f} -> "
                f"{rec['dense_after_ms'] * 1e3:8.2f} us, dequant {rec['dequant_before_ms'] * 1e3:8.2f} -> "
                f"{rec['dequant_after_ms'] * 1e3:8.2f} us")
            costs.append(rec)
        del ws, w16, qs
    every = step_counts(28)
    for B in widths:
        steps[B] = {key: sum(r[key] * every[r["leaf"]] for r in costs if r["B"] == B)
                    for key in ("dense_before_ms", "dense_after_ms", "dequant_before_ms", "dequant_after_ms")}
        st = steps[B]
        log(f"  decode step B={B} (28 layers): dense bf16 {st['dense_before_ms']:.3f} -> "
            f"{st['dense_after_ms']:.3f} ms, dequant {st['dequant_before_ms']:.3f} -> "
            f"{st['dequant_after_ms']:.3f} ms (before: one product; after: tiles of {ROW_TILE} rows)")
    return dict(rows=out, costs=costs, steps=steps)


def prompt_tiles_check(gen):
    """Prompt rows (``utils.PROMPT_TILE``), asserted: a dense bf16
    product (``utils.matmul_rows``) and ``dequant_mm`` of a 544-row prompt
    at ``wo`` and ``w_gate_up`` give its rows the bits of the same rows in a
    32-row call (a chunk or a warm suffix), tile-aligned or not; tolerance
    0. Then the cost, on a dense bf16 prefill of 512 and 8192 tokens: the
    four layer leaves at those rows as one product, and in tiles of 64 and
    of 128 rows, summed over 28 layers → dict."""
    from repro_torch.kernels import dequant_mm
    from repro_torch.utils import PROMPT_TILE, matmul_row_tiles, matmul_rows

    checks = []
    for leaf in ("wo", "w_gate_up"):
        k, o, _ = LEAVES[leaf]
        w16 = (torch.randn((k, o), generator=gen, device=DEVICE) / math.sqrt(k)).to(torch.bfloat16)
        packed, scales = format_planes("dequant", k, o, Q, G, gen)
        scales = scales.to(torch.bfloat16)
        x = torch.randn((1, 544, k), generator=gen, device=DEVICE).to(torch.bfloat16)
        full, dfull = matmul_rows(x, w16), dequant_mm(x[0], packed, scales, g=G)
        for start in (512, 500, 77):
            part = x[:, start : start + 32]
            dense_ok = torch.equal(matmul_rows(part, w16), full[:, start : start + 32])
            deq_ok = torch.equal(dequant_mm(part[0], packed, scales, g=G), dfull[start : start + 32])
            checks.append(dict(leaf=leaf, start=start, dense=dense_ok, dequant=deq_ok))
            log(f"  prompt rows {start}..{start + 31} of 544 at {leaf:9s} in a 32-row call (tiles of "
                f"{PROMPT_TILE}): dense bf16 {'equal' if dense_ok else 'DIFFER'}, dequant_mm "
                f"{'equal' if deq_ok else 'DIFFER'} (tolerance 0)")
    if not all(c["dense"] and c["dequant"] for c in checks):
        raise SystemExit(f"chip_smoke: prompt rows differ by the call they are in: {checks}")

    costs = []
    for leaf in ("wqkv", "wo", "w_gate_up", "w_down"):
        k, o, _ = LEAVES[leaf]
        w16 = (torch.randn((k, o), generator=gen, device=DEVICE) / math.sqrt(k)).to(torch.bfloat16)
        ws = [(w16,)] + [(w16.clone(),) for _ in range(n_copies(w16.numel() * 2) - 1)]
        for S in PROMPT_ROWS:
            x = torch.randn((S, k), generator=gen, device=DEVICE).to(torch.bfloat16)
            rec = dict(leaf=leaf, S=S, one_ms=time_ms(lambda w: torch.matmul(x, w), ws))
            for tile in PROMPT_TILES:
                rec[f"tile{tile}_ms"] = time_ms(lambda w, t=tile: matmul_row_tiles(x, w, t), ws)
            costs.append(rec)
        del ws, w16
    forward = {}
    for S in PROMPT_ROWS:
        keys = ["one_ms"] + [f"tile{t}_ms" for t in PROMPT_TILES]
        forward[S] = {key: 28 * sum(r[key] for r in costs if r["S"] == S) for key in keys}
        f = forward[S]
        log(f"  dense bf16 prefill of {S} tokens, the four layer leaves over 28 layers: one product "
            f"{f['one_ms']:.3f} ms; " + ", ".join(
                f"tiles of {t} {f[f'tile{t}_ms']:.3f} ms ({f[f'tile{t}_ms'] / f['one_ms'] - 1:+.1%})"
                for t in PROMPT_TILES) + f"; utils.PROMPT_TILE = {PROMPT_TILE}")
    return dict(checks=checks, costs=costs, forward=forward)


def flash_plain_rows(q, k, v):
    """K8's plain version one batch row at a time: the same function (rows
    are independent), with one row's ``(H, S, S)`` f32 logits live at once."""
    from repro_torch.kernels import flash_attention_plain

    return torch.cat([flash_attention_plain(q[b : b + 1], k[b : b + 1], v[b : b + 1])
                      for b in range(q.shape[0])])


def sdpa_library(q, k, v):
    """The library yardstick: one fused PyTorch attention call on the same
    (B, S, H, Dh) inputs. Timed only; the port never calls it."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True
    ).transpose(1, 2)


def check_flash(B, S, H, Hkv, Dh, dtype, gen):
    """K8 vs its plain version at one shape → record dict."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attn import BF16_ROW_TOL, row_rel_err

    def rand(heads):
        return torch.randn((B, S, heads, Dh), generator=gen, device=DEVICE).to(dtype)

    nbytes = (2 * B * S * H * Dh + 2 * B * S * Hkv * Dh) * (4 if dtype == torch.float32 else 2)
    inputs = [(rand(H), rand(Hkv), rand(Hkv)) for _ in range(n_copies(nbytes))]
    q, k, v = inputs[0]
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = flash_plain_rows(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    row_err = row_rel_err(out, ref)
    tol = FLASH_TOL[dtype]
    within = bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol))  # the reference test's assert
    del ref
    same_bits = bool(torch.equal(flash_attention(q, k, v), out))
    row_tol = BF16_ROW_TOL if dtype == torch.bfloat16 else None
    ok = (within and (row_tol is None or row_err <= row_tol) and same_bits
          and bool(torch.isfinite(out).all()) and out.dtype == dtype)
    ms = time_ms(flash_attention, inputs)
    plain_ms = time_ms(flash_plain_rows, [(q, k, v)], reps=3, inner=1)
    library_ms = time_ms(sdpa_library, inputs) if dtype == torch.bfloat16 else None
    # the work this data needs: q k^T and p v over the S(S+1)/2 causal pairs
    ops = 4.0 * B * H * Dh * (S * (S + 1) / 2)
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    rec = dict(
        kernel=FLASH[0], B=B, S=S, H=H, Hkv=Hkv, Dh=Dh, dtype=str(dtype).replace("torch.", ""),
        max_abs_err=err, tol=tol, row_rel_err=row_err, row_tol=row_tol, same_bits=same_bits, ok=ok,
        ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    rec["tflops"] = ops / ms / 1e9
    rec["library_tflops"] = None if library_ms is None else ops / library_ms / 1e9
    lib = "-" if library_ms is None else f"{library_ms:.4f} ({rec['library_tflops']:.1f} TFLOP/s)"
    log(f"  flash_attention B={B} S={S:<5d} H={H:<2d}/{Hkv:<2d} Dh={Dh:<3d} {rec['dtype']:8s} "
        f"err {err:.2e} (rtol = atol = {tol:g}) row {row_err:.2e}{'' if row_tol is None else f' (tol {row_tol:g})'} "
        f"bits {'same' if same_bits else 'DIFFER'} {'ok' if ok else 'FAIL'}  "
        f"ms {ms:.4f} ({rec['tflops']:.1f} TFLOP/s)  plain {plain_ms:.4f}  "
        f"bound {rec['bound_ms']:.4f} ({rec['bound_by']})  library {lib}")
    return rec


def sdpa_lower_right(q, k, v):
    """The library yardstick of the offset entry: one fused PyTorch attention
    call with the causal mask aligned to the last key
    (``torch.nn.attention.bias.causal_lower_right``). Timed only."""
    from torch.nn.attention.bias import causal_lower_right

    mask = causal_lower_right(q.shape[1], k.shape[1])
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, enable_gqa=True
    ).transpose(1, 2)


def flash_offset_inputs(q_start, sq, dtype, gen, B=1, heads=LLAMA_HEADS):
    """Inputs of K8's offset entry at ``heads`` (H, Hkv, Dh; default
    llama3.2-3b's): the queries of the whole sequence ``(B, Sk, H, Dh)`` and
    a K/V cache ``(2, B, Sk + 64, Hkv, Dh)`` whose rows past ``Sk = q_start
    + Sq`` hold NaN."""
    H, Hkv, Dh = heads
    sk = q_start + sq
    q_all = torch.randn((B, sk, H, Dh), generator=gen, device=DEVICE).to(dtype)
    cache = torch.full((2, B, sk + 64, Hkv, Dh), float("nan"), device=DEVICE, dtype=dtype)
    cache[:, :, :sk] = torch.randn((2, B, sk, Hkv, Dh), generator=gen, device=DEVICE).to(dtype)
    return q_all, cache


def flash_offset_verdict(q_all, cache, q_start, sq):
    """K8's offset entry on :func:`flash_offset_inputs`: queries ``q_all[:,
    q_start:]`` over the views ``cache[:, :, :q_start + Sq]``, against its
    plain version (the tolerances of :func:`check_flash`), each row against
    the same row of one cold launch over the whole sequence (bitwise), a
    rerun (bitwise), read in place → record."""
    from repro_torch.kernels import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attn import BF16_ROW_TOL, row_rel_err

    (H, Dh), Hkv = q_all.shape[2:], cache.shape[3]
    dtype, sk = q_all.dtype, q_start + sq
    q, k, v = q_all[:, q_start:], cache[0, :, :sk], cache[1, :, :sk]
    copies0 = flash_attention.copies
    out = flash_attention(q, k, v, q_start)
    torch.cuda.synchronize()
    plain = flash_attention_plain(q, k, v, q_start)
    err = (out.float() - plain.float()).abs().max().item()
    row_err = row_rel_err(out, plain)
    tol = FLASH_TOL[dtype]
    within = bool(torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol))
    del plain
    cold = flash_attention(q_all, k.contiguous(), v.contiguous())[:, q_start:]
    rows_equal = bool(torch.equal(out, cold))
    same_bits = bool(torch.equal(flash_attention(q, k, v, q_start), out))
    in_place = flash_attention.copies == copies0
    row_tol = BF16_ROW_TOL if dtype == torch.bfloat16 else None
    ok = (within and (row_tol is None or row_err <= row_tol) and rows_equal and same_bits and in_place
          and bool(torch.isfinite(out).all()))
    return dict(kernel=FLASH[0], B=q_all.shape[0], q_start=q_start, Sq=sq, Sk=sk, H=H, Hkv=Hkv, Dh=Dh,
                dtype=str(dtype).replace("torch.", ""), max_abs_err=err, tol=tol, row_rel_err=row_err,
                row_tol=row_tol, rows_equal_cold=rows_equal, same_bits=same_bits, in_place=in_place, ok=ok)


def check_flash_offset(q_start, sq, dtype, gen):
    """K8's offset entry at llama3.2-3b's heads, B = 1, checked as in
    :func:`flash_offset_verdict`, then timed beside ``sdpa_lower_right``
    → record."""
    from repro_torch.kernels import flash_attention, flash_attention_plain

    H, Hkv, Dh = LLAMA_HEADS
    sk = q_start + sq
    size = 4 if dtype == torch.float32 else 2
    nbytes = (2 * sq * H * Dh + 2 * sk * Hkv * Dh) * size  # q and out; K/V rows [0, Sk)
    sets = [flash_offset_inputs(q_start, sq, dtype, gen) for _ in range(n_copies(nbytes))]
    inputs = [(q_all[:, q_start:], cache[0, :, :sk], cache[1, :, :sk]) for q_all, cache in sets]
    rec = flash_offset_verdict(*sets[0], q_start, sq)
    err, row_err = rec["max_abs_err"], rec["row_rel_err"]
    rows_equal, same_bits, in_place, ok = rec["rows_equal_cold"], rec["same_bits"], rec["in_place"], rec["ok"]
    ms = time_ms(lambda q, k, v: flash_attention(q, k, v, q_start), inputs)
    plain_ms = time_ms(lambda q, k, v: flash_attention_plain(q, k, v, q_start), inputs[:1], reps=3, inner=1)
    library_ms = None
    if dtype == torch.bfloat16:
        try:
            library_ms = time_ms(sdpa_lower_right, inputs)
        except RuntimeError as e:  # the yardstick only: time it on K/V heads repeated instead
            log(f"  (SDPA with causal_lower_right refused enable_gqa: {str(e)[:200]}; timed with the K/V "
                f"heads repeated {H // Hkv}x)")
            wide = [(a, b.repeat_interleave(H // Hkv, 2), c.repeat_interleave(H // Hkv, 2)) for a, b, c in inputs]
            library_ms = time_ms(sdpa_lower_right, wide)
    ops = 4.0 * H * Dh * sq * (q_start + (sq + 1) / 2)
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
               bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    lib = "-" if library_ms is None else f"{library_ms:.4f}"
    log(f"  flash_attention offset q_start={q_start:<5d} Sq={sq:<5d} Sk={sk:<5d} {rec['dtype']:8s} err {err:.2e} "
        f"row {row_err:.2e} rows == cold launch {'yes' if rows_equal else 'NO'} bits "
        f"{'same' if same_bits else 'DIFFER'} in place {'yes' if in_place else 'NO'} {'ok' if ok else 'FAIL'}  "
        f"ms {ms:.4f} = {ms / rec['bound_ms']:.1f}x bound {rec['bound_ms']:.4f} ({rec['bound_by']})  plain "
        f"{plain_ms:.4f}  library (causal_lower_right SDPA) {lib}")
    return rec


def phase_flash(gen):
    H, Hkv, Dh = LLAMA_HEADS
    shapes = [(B, S, H, Hkv, Dh) for B in (1, PROMPTS) for S in FLASH_S] + FLASH_EXTRA
    records = [check_flash(*shape, dtype, gen) for shape in shapes
               for dtype in (torch.bfloat16, torch.float32)]
    offsets = [check_flash_offset(q_start, sq, dtype, gen) for q_start, sq in FLASH_OFFSETS
               for dtype in (torch.bfloat16, torch.float32)]
    bad = [r for r in records + offsets if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} flash_attention checks disagree with the plain version: {bad[:3]}")
    return records, offsets


def run_counted(fn):
    """``fn()`` with every launch count set to 0 just before it and read just
    after → (result, wall seconds, launch counts, ref-oracle dispatches)."""
    from repro_torch.kernels import launch_counts, qmatmul, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    ref0 = qmatmul.ref_calls
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, launch_counts(), qmatmul.ref_calls - ref0


def quantized_engine(cfg, params, fmt, max_seq=PROMPT_LEN + NEW_TOKENS + 8):
    """Quantize the dense ``params`` on the card in ``fmt`` and build the
    serving engine (fused QKV / gate-up)."""
    from repro_torch.infer import Engine

    return Engine(cfg, quantize_format(cfg, params, fmt), max_seq=max_seq, device="cuda")


def quantize_format(cfg, params, fmt):
    """The dense ``params`` quantized on the card in ``fmt`` (no hand-written
    kernel runs), with its time, packed bytes and solver peak logged."""
    from repro_torch.quant import QuantPolicy, quantize_params, quantized_bytes

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = quantize_params(params, QuantPolicy(q=Q, g=G, iters=4, fmt=fmt), device="cuda")
    torch.cuda.synchronize()
    log(f"  [{fmt}, {cfg.name}, {cfg.n_layers} layers] quantize_params {time.perf_counter() - t0:.1f}s "
        f"({quantized_bytes(qparams) / 1e9:.3f} GB packed; solver peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB above the dense model)")
    return qparams


def check_tokens(cfg, results):
    for res in results:
        if res.tokens.shape[1] != PROMPT_LEN + NEW_TOKENS or not (
            (res.tokens >= 0) & (res.tokens < cfg.vocab)
        ).all():
            raise SystemExit(f"chip_smoke: bad generated tokens {res.tokens.shape}")


def check_logits(engine, prompts, fmt, modes):
    """Each mode's prefill + one step logits vs the ref oracle's, within
    ``LOGITS_REL_TOL`` of max|ref| → worst relative error."""
    ref_logits = step_logits(engine, prompts, "ref")
    scale = ref_logits.abs().max().item()
    worst = 0.0
    for mode in modes:
        got = step_logits(engine, prompts, mode)
        if not torch.isfinite(got).all():
            raise SystemExit(f"chip_smoke: non-finite logits ({fmt}, {mode or 'auto'})")
        err = (got - ref_logits).abs().max().item()
        agree = (got.argmax(-1) == ref_logits.argmax(-1)).float().mean().item()
        log(f"  [{fmt}] logits {mode or 'auto'} vs ref: max|d| {err:.4e} of max|ref| {scale:.3f} "
            f"(tol {LOGITS_REL_TOL:g} relative), top-1 agreement {agree:.3f}")
        worst = max(worst, err / scale)
    if not worst <= LOGITS_REL_TOL:
        raise SystemExit(f"chip_smoke: [{fmt}] engine logits differ from the ref oracle by {worst:.3e} relative")
    return worst


def f32_oracle_engine(engine):
    """The same quantized weights, dequantized to f32, in an f32 model (the
    watch item's oracle, ROADMAP Queue 3)."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.infer import Engine
    from repro_torch.utils import tree_map

    def to_f32(leaf):
        if not isinstance(leaf, QuantizedTensor):
            return leaf.to(torch.float32)
        f = get_format(leaf.fmt)
        if leaf.packed.dim() == 3:
            return f.dequantize(leaf, dtype=torch.float32)
        return torch.stack([f.dequantize(leaf.replace(packed=leaf.packed[i], scales=leaf.scales[i]),
                                         dtype=torch.float32) for i in range(leaf.packed.shape[0])])

    cfg32 = dataclasses.replace(engine.cfg, param_dtype="float32", compute_dtype="float32")
    return Engine(cfg32, tree_map(to_f32, engine.params), max_seq=engine.max_seq, fuse=False, device="cuda")


def f32_oracle_check(engine, prompts, fmt, modes):
    """Each bf16 path's logits (the ref path's included) against the f32
    oracle under ``impl_mode("ref")``, max|d| / max|f32|. A kernel path no
    farther from it than the ref path is not at fault, whatever their
    distance from each other."""
    oracle = f32_oracle_engine(engine)
    want = step_logits(oracle, prompts, "ref")
    del oracle
    scale = want.abs().max().item()
    out = {}
    for mode in ("ref", *modes):
        got = step_logits(engine, prompts, mode)
        out[mode or "auto"] = (got - want).abs().max().item() / scale
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log(f"  [{fmt}] logits {mode or 'auto'} vs the f32-weight oracle: max|d| / max|f32| "
            f"{out[mode or 'auto']:.3e}, top-1 agreement {agree:.3f}")
    return out


def serve_bcq(cfg, packed, prompts, reqs):
    """The bcq path (``packed``: the model quantized in bcq): batched,
    sequential and LUT-kernel ``generate`` in one counted window."""
    import numpy as np

    from repro_torch.infer import Engine
    from repro_torch.kernels import impl_mode
    from repro_torch.launch.serve import drive_sequential

    engine = Engine(cfg, packed, max_seq=PROMPT_LEN + NEW_TOKENS + 8, device="cuda")
    engine.generate(prompts, 2)  # warm-up: library handles, allocator

    def run():
        t0 = time.perf_counter()
        batched = engine.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        t_batched = time.perf_counter() - t0
        seq_outs, t_seq = drive_sequential(engine, reqs, np.zeros(len(reqs)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with impl_mode("lutgemm"):
            lut = engine.generate(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        return batched, t_batched, seq_outs, t_seq, lut, time.perf_counter() - t0

    (batched, t_batched, seq_outs, t_seq, lut, t_lut), _, counts, ref_calls = run_counted(run)
    n_tok = PROMPTS * NEW_TOKENS
    log(f"  [bcq] generate batched ({PROMPTS}x{PROMPT_LEN} + {NEW_TOKENS}): {t_batched:.3f}s, "
        f"{n_tok / t_batched:.1f} tok/s")
    log(f"  [bcq] generate sequential ({PROMPTS} requests): {t_seq:.3f}s, {n_tok / t_seq:.1f} tok/s")
    log(f"  [bcq] generate batched on lutgemm: {t_lut:.3f}s, {n_tok / t_lut:.1f} tok/s")
    log(f"  [bcq] launches {json.dumps(counts)}, ref-oracle dispatches {ref_calls}")

    L = cfg.n_layers
    forwards = 1 + NEW_TOKENS  # prefill + one forward per sampled token
    expect = dict.fromkeys(counts, 0)
    expect.update({
        "bcq_mm": (1 + PROMPTS) * forwards * (2 * L + 1),
        "bcq_mm_fused": (1 + PROMPTS) * forwards * 2 * L,
        "lutgemm": forwards * (4 * L + 1),
        "flash_attention": (2 + PROMPTS) * L,  # every prefill's attention, one launch a layer
    })
    if counts != expect:
        raise SystemExit(f"chip_smoke: [bcq] launch counts {counts} != expected {expect}")
    if ref_calls:
        raise SystemExit(f"chip_smoke: the bcq path took the ref oracle {ref_calls} times")
    check_tokens(cfg, [batched, lut, *seq_outs])
    seq_tokens = np.concatenate([o.tokens for o in seq_outs])
    log(f"  [bcq] greedy rows identical, batched vs sequential: "
        f"{int((seq_tokens == batched.tokens).all(axis=1).sum())}/{PROMPTS}; "
        f"bcq_mm vs lutgemm: {int((lut.tokens == batched.tokens).all(axis=1).sum())}/{PROMPTS}")
    check_logits(engine, prompts, "bcq", (None, "lutgemm"))
    f32_rel = f32_oracle_check(engine, prompts, "bcq", (None, "lutgemm"))
    small_model_check("bcq")
    summary = dict(tok_s=n_tok / t_batched, wall_s=t_batched, seq_tok_s=n_tok / t_seq,
                   lutgemm_tok_s=n_tok / t_lut, f32_oracle_rel=f32_rel,
                   profile=profile_generate(engine, prompts, t_batched, "bcq", dict(
                       dict.fromkeys(counts, 0), bcq_mm=forwards * (2 * L + 1), bcq_mm_fused=forwards * 2 * L,
                       flash_attention=L)))
    return {k: counts[k] for k in ("bcq_mm", "bcq_mm_fused", "lutgemm")}, summary, engine


def serve_format(cfg, packed, prompts, fmt):
    """One of the other formats' paths (``packed``: the model quantized in
    ``fmt``): batched ``generate`` in a counted window → (its kernel's
    launches, tokens, summary)."""
    from repro_torch.infer import Engine
    from repro_torch.kernels import ternary_mm

    engine = Engine(cfg, packed, max_seq=PROMPT_LEN + NEW_TOKENS + 8, device="cuda")
    engine.generate(prompts, 2)  # warm-up
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, dt, counts, ref_calls = run_counted(lambda: engine.generate(prompts, NEW_TOKENS))
    peak = torch.cuda.max_memory_allocated()
    tc_launches = ternary_mm.tc_launches
    kernel = FORMAT_KERNEL[fmt]
    n_tok = PROMPTS * NEW_TOKENS
    log(f"  [{fmt}] generate batched ({PROMPTS}x{PROMPT_LEN} + {NEW_TOKENS}): {dt:.3f}s, "
        f"{n_tok / dt:.1f} tok/s; peak device memory {peak / 1e9:.3f} GB, "
        f"{(peak - base) / 1e9:.3f} GB above the resident {base / 1e9:.3f} GB")
    log(f"  [{fmt}] launches {json.dumps(counts)}, ref-oracle dispatches {ref_calls}")
    expect = dict.fromkeys(counts, 0)
    expect[kernel] = (1 + NEW_TOKENS) * (4 * cfg.n_layers + 1)
    expect["flash_attention"] = cfg.n_layers  # the prefill's attention
    if counts != expect:
        raise SystemExit(f"chip_smoke: [{fmt}] launch counts {counts} != expected {expect}")
    if ref_calls:
        raise SystemExit(f"chip_smoke: the {fmt} path took the ref oracle {ref_calls} times")
    # the bf16 model's ternary linears all take K4's tensor cores, no other path
    expect_tc = expect["ternary_mm"]
    if fmt == "ternary":
        log(f"  [{fmt}] of them on K4's tensor cores: {tc_launches} (expected {expect_tc})")
    if tc_launches != expect_tc:
        raise SystemExit(f"chip_smoke: [{fmt}] K4 took its tensor-core path {tc_launches} times, not {expect_tc}")
    check_tokens(cfg, [res])
    check_logits(engine, prompts, fmt, (None,))
    small_model_check(fmt)
    summary = dict(tok_s=n_tok / dt, wall_s=dt, peak_gb=peak / 1e9, transient_gb=(peak - base) / 1e9,
                   tc_launches=tc_launches, profile=profile_generate(engine, prompts, dt, fmt, counts))
    return counts[kernel], res.tokens, summary, engine


def prepare_main_path():
    """Phase 5's model at full width and depth, quantized in every format.
    No hand-written kernel runs here, so phase 2 runs it while the sources
    compile → (cfg, prompts, requests, {format: packed params})."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_requests
    from repro_torch.models import init_params
    from repro_torch.quant import quantized_bytes

    cfg = get_config("llama3.2-3b")
    log(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, layers {cfg.n_layers}, {cfg.param_dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.1f}s ({quantized_bytes(params) / 1e9:.3f} GB dense)")
    reqs = build_requests(cfg, PROMPTS, PROMPT_LEN, NEW_TOKENS, mixed_temperature=False)
    packed = {fmt: quantize_format(cfg, params, fmt) for fmt in ("bcq", *FORMAT_KERNEL)}
    return cfg, np.stack([r.prompt for r in reqs]), reqs, packed


def phase_main_path(prepared):
    """Phase 5 on :func:`prepare_main_path`'s models."""
    from repro_torch.kernels import flash_attention

    cfg, prompts, reqs, packed = prepared
    flash_attention.copies = 0
    counts, summary, bcq = serve_bcq(cfg, packed.pop("bcq"), prompts, reqs)
    engines = {"bcq": bcq}  # every format's engine: phase 7 speculates on ternary, phase 10 replays all
    summaries = {"bcq": summary}
    tokens = {}
    for fmt, kernel in FORMAT_KERNEL.items():
        counts[kernel], tokens[fmt], summaries[fmt], engines[fmt] = serve_format(cfg, packed.pop(fmt), prompts, fmt)
    counts["ternary_mm_tc"] = summaries["ternary"]["tc_launches"]
    same = int((tokens["uniform"] == tokens["dequant"]).all(axis=1).sum())
    log(f"  greedy rows identical, uniform vs dequant: {same}/{PROMPTS} (reported, not asserted: "
        f"the two kernels sum k in different orders)")
    log(f"  K8 inputs copied for the TMA's alignment on the main path: {flash_attention.copies}")
    if flash_attention.copies:
        raise SystemExit("chip_smoke: the model's q, k, v views did not reach K8 in place")
    return counts, cfg, summaries, engines, prompts


def serving_engine(engine, max_seq, prefix_cache=None, tracer=None):
    """The bcq engine's fused weights behind another cache length (no copy),
    with ``prefix_cache`` and ``tracer`` if given."""
    from repro_torch.infer import Engine

    return Engine(engine.cfg, engine.params, max_seq=max_seq, fuse=False, device="cuda",
                  prefix_cache=prefix_cache, tracer=tracer)


def serve_requests(cfg, lens, new_tokens, seed0):
    """One request per prompt length, prompts from the serve launcher's
    Markov corpus; temperatures cycle 0 (greedy), 1.0, 0.7."""
    import numpy as np

    from repro_torch.data import MarkovCorpus
    from repro_torch.infer import Request

    corpus = MarkovCorpus(cfg.vocab, seed=3)
    return [
        Request(prompt=corpus.sample(1, n, seed=seed0 + i)[0, :n].astype(np.int32),
                max_new_tokens=new_tokens, temperature=[0.0, 1.0, 0.7][i % 3], seed=10 + i)
        for i, n in enumerate(lens)
    ]


def slab_launches(leaf, rows, q=Q):
    """K1/K2 launches of one call of ``rows`` rows at ``leaf``: one a row slab
    (``grouptable.Plan.slab_rows``; decode widths take one)."""
    from repro_torch.kernels import grouptable

    k, o, _ = LEAVES[leaf]
    return -(-rows // grouptable.plan("bcq", k, o, q, G, torch.bfloat16, torch.bfloat16).slab_rows(rows))


def expect_forward_counts(counts, decode_steps, prompt_rows, n_layers, decode_rows=SERVE_SLOTS):
    """Launch counts of the bcq path over ``decode_steps`` decode forwards of
    ``decode_rows`` rows and one prefill of ``r`` rows for each ``r`` in
    ``prompt_rows`` (its ``lm_head`` at its last row; K8 once a layer): each
    call wider than a row slab launches once a slab (:func:`slab_launches`)."""
    expect = dict.fromkeys(counts, 0)
    forwards = [(decode_rows, decode_rows)] * decode_steps + [(r, 1) for r in prompt_rows]
    expect.update(
        bcq_mm=sum(n_layers * (slab_launches("wo", r) + slab_launches("w_down", r)) + slab_launches("lm_head", h)
                   for r, h in forwards),
        bcq_mm_fused=sum(n_layers * (slab_launches("wqkv", r) + slab_launches("w_gate_up", r)) for r, _ in forwards),
        flash_attention=len(prompt_rows) * n_layers)
    return expect


def slot_vs_solo_logits(engine, reqs):
    """Largest |logit difference| between a slot batch and solo batch-1
    forwards of the same requests: their prefill logits and one decode
    step's."""
    slots = engine.init_slots(len(reqs))
    for i, r in enumerate(reqs):
        engine.admit_slot(slots, i, r.prompt, max_new_tokens=2)
    prefill = slots["logits"].clone()
    toks, _, slots = engine.decode_slots(slots, 1)
    worst = 0.0
    for i, r in enumerate(reqs):
        l0, cache = engine.prefill(torch.as_tensor(r.prompt[None], device=DEVICE).long(), engine._make_cache(1))
        l1, _ = engine.decode(torch.tensor([[int(toks[i, 0])]], device=DEVICE), cache, r.prompt.size)
        worst = max(worst, (l0[0] - prefill[i]).abs().max().item(), (l1[0] - slots["logits"][i]).abs().max().item())
    return worst


def device_profile(run, cross_check=False, events=False):
    """Device busy time by kernel over ``run()``, traced with
    ``torch.profiler`` (CUDA activity only, which slows the host least) →
    (device ms, traced wall ms, {kernel: ms}). The device activities are
    summed straight from the trace's events (``kineto_results``, a private
    attribute, checked on torch 2.11): ``key_averages()`` builds a Python
    object per event (~70 us each), a minute for the ~10^5 kernels of a
    speculative run. Without that attribute the sum falls back to
    ``key_averages()``; ``cross_check`` computes both and fails unless they
    agree within 0.1% plus a microsecond an event (the rounding of the
    public sum). ``events``: also return the trace's device events by name
    ({kernel, copy or memset: how many ran}), which a CUDA graph's replay
    shows one by one as an eager launch."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    fast = _trace_device_ms(prof)
    if fast is None or cross_check:
        public, public_n = {}, {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0)
            if us > 0:
                public[ev.key] = public.get(ev.key, 0.0) + us / 1e3
                public_n[ev.key] = public_n.get(ev.key, 0) + ev.count
        if fast is None:
            fast = (public_n, public)
        else:
            n_events, a, b = sum(fast[0].values()), sum(fast[1].values()), sum(public.values())
            log(f"  device_profile cross-check (torch {torch.__version__}): trace events {a:.3f} ms over "
                f"{n_events} events, key_averages() {b:.3f} ms")
            if abs(a - b) > 1e-3 * b + 1e-3 * n_events:
                raise SystemExit(f"chip_smoke: the trace's device events sum to {a:.3f} ms, key_averages() to "
                                 f"{b:.3f} ms: the profiler's private event list changed meaning")
    counts, by_name = fast
    result = (sum(by_name.values()), traced_ms, by_name)
    return (*result, counts) if events else result


def _trace_device_ms(prof):
    """({kernel: events}, {kernel: ms}) of the trace's device activities, or
    None where this torch has no ``kineto_results`` event list."""
    try:
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
    except (AttributeError, ImportError):
        return None
    by_name, counts = {}, {}
    for ev in events:
        if ev.device_type() == DeviceType.CUDA:
            by_name[ev.name()] = by_name.get(ev.name(), 0.0) + ev.duration_ns() / 1e6
            counts[ev.name()] = counts.get(ev.name(), 0) + 1
    return counts, by_name


def traced_launches(by_count):
    """{kernel-wrapper group: device launches in a trace} (``TRACE_TAGS``)."""
    return {"+".join(group): sum(n for name, n in by_count.items() if tagged(name, tags))
            for group, tags in TRACE_TAGS.items()}


def check_trace_census(label, by_count, counts, tc_launches=None):
    """A run's launch census (``counts``: what the wrappers counted, each
    graph replay adding its capture's counts, which ``inspect_captures``
    holds to the graph's kernel nodes) beside the kernels its profiler trace
    saw run on the card, wrapper by wrapper (K1 and K2 as one: they launch
    one device kernel); with ``tc_launches``, K4's tensor-core launches too.
    The census counts launches, one a row slab where a call is wider than a
    slab (``grouptable.Plan.slab_rows``: prompt rows of a long admission).
    The profiler drops device records (on an H100 with torch 2.11, up to 43
    of a run's ~1900 launches of one kernel, none in most runs), so a trace
    is a lower bound. This fails where a trace holds more launches of a
    wrapper's kernel than the census counted, or none of one it counted →
    (traced launches, census less traced)."""
    traced = traced_launches(by_count)
    census = {"+".join(group): sum(counts[w] for w in group) for group in TRACE_TAGS}
    if tc_launches is not None:
        traced["ternary_mm on the tensor cores"] = sum(n for name, n in by_count.items() if "ternary_tc_kernel" in name)
        census["ternary_mm on the tensor cores"] = tc_launches
    if any(census[k] and not traced[k] for k in census):
        raise SystemExit(f"chip_smoke: [{label}] the trace holds no launch of a kernel the census counted: "
                         f"traced {traced}, census {census}")
    if any(traced[k] > census[k] for k in census):
        raise SystemExit(f"chip_smoke: [{label}] the trace holds more launches than the census counted: "
                         f"traced {traced}, census {census}")
    return traced, {k: census[k] - traced[k] for k in census if census[k] != traced[k]}


def phase_serving(bcq_engine):
    """Continuous batching of 12 requests (ragged prompts, greedy and
    sampled) through 4 slots on the bcq model → (K8 launches, summary)."""
    import numpy as np

    from repro_torch.launch.serve import drive_continuous

    cfg = bcq_engine.cfg
    L, n = cfg.n_layers, len(SERVE_PROMPT_LENS)
    engine = serving_engine(bcq_engine, max(SERVE_PROMPT_LENS) + NEW_TOKENS + 8)

    def serve(seed0):
        reqs = serve_requests(cfg, SERVE_PROMPT_LENS, NEW_TOKENS, seed0)
        sched, done, wall = drive_continuous(engine, reqs, np.zeros(n), n_slots=SERVE_SLOTS,
                                             chunk=SERVE_CHUNK)
        return reqs, sched, done, wall

    drive_continuous(engine, serve_requests(cfg, (16, 40), 2, 900), np.zeros(2), n_slots=SERVE_SLOTS,
                     chunk=SERVE_CHUNK)  # warm-up
    (reqs, sched, done, wall), _, counts, ref_calls = run_counted(lambda: serve(200))
    summ = sched.summary()
    tok_s = n * NEW_TOKENS / wall
    util = sched.steps_active / max(1, sched.decode_steps * SERVE_SLOTS)
    ttft = summ["ttft_s"]
    log(f"  [continuous] {n} requests (prompts {min(SERVE_PROMPT_LENS)}-{max(SERVE_PROMPT_LENS)} tokens, "
        f"{NEW_TOKENS} new each), {SERVE_SLOTS} slots, chunk {SERVE_CHUNK}: {wall:.3f}s, {tok_s:.1f} tok/s, "
        f"slot utilisation {util:.1%}, TTFT p50 {ttft['p50']:.3f}s p95 {ttft['p95']:.3f}s, "
        f"{sched.decode_steps} decode steps")
    log(f"  [continuous] launches {json.dumps(counts)}, ref-oracle dispatches {ref_calls}")
    expect = expect_forward_counts(counts, sched.decode_steps, [r.prompt.size for r in reqs], L)
    if counts != expect:
        raise SystemExit(f"chip_smoke: [continuous] launch counts {counts} != expected {expect}")
    if ref_calls:
        raise SystemExit(f"chip_smoke: the continuous path took the ref oracle {ref_calls} times")
    if len(done) != n or summ["by_state"] != {"finished": n}:
        raise SystemExit(f"chip_smoke: [continuous] not every request finished: {summ['by_state']}")

    by_rid = {c.rid: c.new_tokens for c in done}
    t0 = time.perf_counter()
    solos, _, solo_counts, _ = run_counted(lambda: [
        engine.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
        for r in reqs])
    solo_s = time.perf_counter() - t0
    if solo_counts["flash_attention"] != n * L:
        raise SystemExit(f"chip_smoke: solo generates launched K8 {solo_counts['flash_attention']} times, "
                         f"not {n * L}")
    same = [bool(np.array_equal(by_rid[r.rid], o.tokens[0, r.prompt.size:])) for r, o in zip(reqs, solos)]
    greedy = [r.temperature == 0 for r in reqs]
    worst = slot_vs_solo_logits(engine, [r for r in reqs if r.temperature == 0][:SERVE_SLOTS])
    log(f"  [continuous] slot == solo generate: greedy {sum(a for a, g in zip(same, greedy) if g)}/{sum(greedy)}, "
        f"sampled {sum(a for a, g in zip(same, greedy) if not g)}/{n - sum(greedy)} (sampled reported, "
        f"not asserted); largest logit difference slot batch vs solo forwards {worst:.3e}; "
        f"{n} solo generates {solo_s:.3f}s ({n * NEW_TOKENS / solo_s:.1f} tok/s one at a time)")
    if not all(a for a, g in zip(same, greedy) if g):
        raise SystemExit("chip_smoke: a greedy request served in a slot differs from its solo generate")

    (device_ms, traced_ms, by_name, by_count), _, traced_counts, _ = run_counted(
        lambda: device_profile(lambda: serve(300), events=True))
    traced, missed = check_trace_census("continuous", by_count, traced_counts)
    log(f"  [continuous] the traced run's launches by kernel {traced}; the census less the traced "
        f"{missed or 0} (the profiler drops records: a trace is a lower bound)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    flash_ms = sum(ms for name, ms in by_name.items() if any(t in name for t in FLASH_TAGS))
    log(f"  [continuous] profile of a second run: device busy {device_ms:.2f} ms of {traced_ms:.2f} ms traced "
        f"wall ({device_ms / traced_ms:.1%}; {device_ms / (wall * 1e3):.1%} of the untraced run's wall), "
        f"K8 {flash_ms:.2f} ms")
    for name, ms in top:
        log(f"    {ms:9.3f} ms  {name[:100]}")
    summary = dict(requests=n, wall_s=wall, tok_s=tok_s, slot_utilisation=util, ttft_s=ttft,
                   tpot_s=summ["tpot_s"], decode_steps=sched.decode_steps, greedy_same=same,
                   max_logit_diff_slot_vs_solo=worst, solo_s=solo_s, device_ms=device_ms,
                   traced_wall_ms=traced_ms, busy_share=device_ms / (wall * 1e3), flash_ms=flash_ms,
                   top=[[k, v] for k, v in top], traced_launches=traced, census_less_traced=missed)
    return counts["flash_attention"], summary, dict(engine=engine, solos=solos)


def synced_clock():
    """A lifecycle clock whose stamps include the device's work."""
    torch.cuda.synchronize()
    return time.perf_counter()


def forced_logits(engine, prompt, tokens, mode):
    """Under ``impl_mode(mode)``: the prompt's prefill, then ``tokens`` fed
    one decode step at a time → the ``(len(tokens), V)`` logits that chose
    each of them (teacher forcing: every path sees the same inputs)."""
    from repro_torch.kernels import impl_mode

    out = []
    with impl_mode(mode):
        logits, cache = engine.prefill(torch.as_tensor(prompt[None], device=DEVICE).long(), engine._make_cache(1))
        for t, tok in enumerate(tokens):
            out.append(logits[0])
            if t + 1 < len(tokens):
                logits, cache = engine.decode(torch.tensor([[int(tok)]], device=DEVICE), cache, prompt.size + t)
    return torch.stack(out)


def phase_long(bcq_engine):
    """One request of LONG_SEQ_THRESHOLD prompt tokens through the
    scheduler on the kernels, and again under impl_mode("ref"); then the
    kernel path's tokens teacher-forced through both paths and an f32-weight
    oracle, so the logits are compared on the same inputs → (summary, the
    whole-shot kernel path's last-prompt logits, its tokens)."""
    import numpy as np

    from repro_torch.infer import RequestState, Scheduler
    from repro_torch.kernels import impl_mode
    from repro_torch.models.layers import LONG_SEQ_THRESHOLD

    cfg = bcq_engine.cfg
    L, S = cfg.n_layers, LONG_SEQ_THRESHOLD
    engine = serving_engine(bcq_engine, S + LONG_NEW)
    (req,) = serve_requests(cfg, (S,), LONG_NEW, 500)  # greedy

    def run(mode):
        with impl_mode(mode):
            sched = Scheduler(engine, n_slots=1, chunk=SERVE_CHUNK, clock=synced_clock)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            rid = sched.submit(dataclasses.replace(req, rid=None))
            (c,) = sched.run()
            peak = torch.cuda.max_memory_allocated() - base
        stamps = dict(sched.outcomes[rid].history)
        prefill_s = stamps[RequestState.DECODING] - stamps[RequestState.PREFILLING]
        return c.new_tokens, prefill_s, peak, base, sched.decode_steps

    (toks, prefill_s, peak, base, steps), wall, counts, ref_calls = run_counted(lambda: run(None))
    logits_gb = LLAMA_HEADS[0] * S * S * 4 / 1e9  # _sdpa's f32 (H, S, S) logits for one layer, computed
    log(f"  [long] {S}-token prompt + {LONG_NEW} new tokens through the scheduler: {wall:.3f}s, prefill "
        f"{prefill_s:.3f}s; peak device memory {peak / 1e9:.3f} GB above the resident {base / 1e9:.3f} GB "
        f"(weights and cache); _sdpa would need {logits_gb:.2f} GB of f32 logits per layer (computed, not run)")
    log(f"  [long] launches {json.dumps(counts)}, ref-oracle dispatches {ref_calls}")
    expect = expect_forward_counts(counts, steps, [S], L, decode_rows=1)
    if counts != expect:
        raise SystemExit(f"chip_smoke: [long] launch counts {counts} != expected {expect}")
    if ref_calls:
        raise SystemExit(f"chip_smoke: the long request took the ref oracle {ref_calls} times")
    rtoks, rprefill_s, rpeak, _, _ = run("ref")
    same = bool(np.array_equal(toks, rtoks))
    log(f"  [long] under impl_mode('ref') (_sdpa_qchunked, dequantized weights): prefill {rprefill_s:.3f}s, "
        f"peak {rpeak / 1e9:.3f} GB above the same base; free-running greedy tokens "
        f"{'identical' if same else 'differ'}: {toks.tolist()} vs {rtoks.tolist()}")

    kl = forced_logits(engine, req.prompt, toks, None)
    if not torch.equal(kl.argmax(-1).cpu(), torch.as_tensor(toks).long()):
        raise SystemExit("chip_smoke: [long] teacher-forced kernel logits do not reproduce the served tokens")
    rl = forced_logits(engine, req.prompt, toks, "ref")
    oracle = f32_oracle_engine(engine)
    fl = forced_logits(oracle, req.prompt, toks, "ref")
    del oracle

    def rel(a, b):
        return ((a - b).abs().amax(-1) / b.abs().amax(-1)).max().item()

    def agree(a, b):
        return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    top2 = rl.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    diff = (kl - rl).abs().amax(-1).tolist()
    rel_kr, rel_kf, rel_rf = rel(kl, rl), rel(kl, fl), rel(rl, fl)
    log(f"  [long] teacher-forced on the kernel path's tokens, max|d| / max|logit| per step, worst of {LONG_NEW}: "
        f"kernel vs ref {rel_kr:.3e} (tol {LOGITS_REL_TOL:g}); against the f32-weight oracle kernel "
        f"{rel_kf:.3e}, ref {rel_rf:.3e}; top-1 agreement kernel/ref {agree(kl, rl):.3f}, kernel/f32 "
        f"{agree(kl, fl):.3f}, ref/f32 {agree(rl, fl):.3f}")
    log(f"  [long] per step, the ref path's top-1/top-2 margin vs max|kernel - ref|: "
        + ", ".join(f"{m:.3f}/{d:.3f}" for m, d in zip(margin, diff)))
    if not rel_kr <= LOGITS_REL_TOL:
        raise SystemExit(f"chip_smoke: the long request's logits differ from the ref path by {rel_kr:.3e} relative")
    decisive = [m > 2 * d for m, d in zip(margin, diff)]
    flips = [t for t, dec in enumerate(decisive)
             if dec and int(kl[t].argmax()) != int(rl[t].argmax())]
    if flips:
        raise SystemExit(f"chip_smoke: [long] the kernel and ref paths pick different tokens at decisive steps {flips}")
    summary = dict(prompt_len=S, new_tokens=LONG_NEW, wall_s=wall, prefill_s=prefill_s, peak_gb=peak / 1e9,
                   base_gb=base / 1e9, sdpa_logits_gb_per_layer=logits_gb, ref_prefill_s=rprefill_s,
                   ref_peak_gb=rpeak / 1e9, tokens_identical=same, tokens=toks.tolist(), ref_tokens=rtoks.tolist(),
                   rel_kernel_ref=rel_kr, rel_kernel_f32=rel_kf, rel_ref_f32=rel_rf, margins=margin,
                   max_abs_diff=diff, top1_kernel_ref=agree(kl, rl), top1_kernel_f32=agree(kl, fl),
                   top1_ref_f32=agree(rl, fl))
    return summary, kl[0].clone(), toks


def step_logits(engine, prompts, mode):
    """Prefill and one decode step's logits ``(2, B, V)`` under ``impl_mode(mode)``."""
    from repro_torch.kernels import impl_mode

    with impl_mode(mode):
        toks = torch.as_tensor(prompts, device=engine.device, dtype=torch.long)
        l0, cache = engine.prefill(toks, engine._make_cache(len(prompts)))
        l1, _ = engine.decode(toks[:, -1:], cache, toks.shape[1])
    return torch.stack([l0, l1])


def small_model_check(fmt):
    """The engine's kernel paths against its ref-oracle path on the serve
    launcher's reduced f32 llama3.2-3b in ``fmt``, within the kernels' f32
    tolerance: in f32 nothing but summation order separates them, while the
    full-width bf16 model above also rounds activations differently at
    every layer."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.infer import Engine
    from repro_torch.models import init_params, reduced
    from repro_torch.quant import QuantPolicy, quantize_params

    cfg = reduced(get_config("llama3.2-3b"), d_model=256, n_kv_heads=4, d_ff=512)
    params = quantize_params(init_params(cfg, seed=0, device="cuda"),
                             QuantPolicy(q=Q, g=G, iters=2, fmt=fmt), device="cuda")
    engine = Engine(cfg, params, max_seq=32, device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 8))
    ref = step_logits(engine, prompts, "ref")
    tol = KERNEL_TOL
    for mode in (None, "lutgemm") if fmt == "bcq" else (None,):
        got = step_logits(engine, prompts, mode)
        err = (got - ref).abs().max().item()
        ok = bool(torch.allclose(got, ref, rtol=tol, atol=tol))
        log(f"  [{fmt}] reduced f32 model ({cfg.n_layers} layers, d_model {cfg.d_model}): logits "
            f"{mode or 'auto'} vs ref max|d| {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: [{fmt}] reduced-model logits ({mode or 'auto'}) differ from the ref oracle")


def profile_generate(engine, prompts, untraced_s, fmt, expect):
    """Device busy time by kernel over one batched ``generate``, its decode
    steps replays of the engine's graph (captured beforehand, outside the
    trace). Its launch census must equal ``expect`` (one such ``generate``'s
    counts) and the kernels the trace saw run (:func:`check_trace_census`)."""
    from repro_torch.kernels import ternary_mm

    engine.generate(prompts, 2)  # this width's graph under this impl mode, captured
    (device_ms, traced_ms, by_name, by_count), _, counts, _ = run_counted(
        lambda: device_profile(lambda: engine.generate(prompts, NEW_TOKENS), cross_check=fmt == "bcq", events=True))
    if counts != expect:
        raise SystemExit(f"chip_smoke: [{fmt}] the traced generate's census {counts} != expected {expect}")
    traced, missed = check_trace_census(f"{fmt} generate", by_count, counts, ternary_mm.tc_launches)
    ours_ms = sum(ms for name, ms in by_name.items() if PROFILE_TAG[fmt] in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"  [{fmt}] profile of one batched generate: device busy {device_ms:.2f} ms of "
        f"{traced_ms:.2f} ms traced wall ({device_ms / traced_ms:.1%}; untraced wall "
        f"{untraced_s * 1e3:.2f} ms, busy {device_ms / (untraced_s * 1e3):.1%} of it), the format's "
        f"kernels {ours_ms:.2f} ms; kernel launches in the trace {({k: v for k, v in traced.items() if v})}, "
        f"the census less these {missed or 0}")
    for name, ms in top:
        log(f"    {ms:9.3f} ms  {name[:100]}")
    return dict(device_ms=device_ms, traced_wall_ms=traced_ms, untraced_wall_ms=untraced_s * 1e3,
                format_kernels_ms=ours_ms, top=[[name, ms] for name, ms in top], traced_launches=traced,
                census_less_traced=missed)


def draft_shapes(gen, records):
    """The speculative path's shapes (phase 3), bf16, each held to its plain
    version: K1/K2 and K3 at q' = 1 and 2 planes on the five leaves at B = 1,
    4, the verify's 4·(γ+1) = 20 rows and the draft prefill's 64 rows, at
    q = 4 at 20 rows, and K4 (the ternary verify) at 20 rows, each timed with
    its byte bound; K1/K2 at q' and q planes at each of phase 6's prompt
    lengths (the speculative scheduler's two prefills), checked only. Then
    each path's decode step at every q and B (``records`` holds the q = 4
    rows at B = 1 and 4) → (records, steps)."""
    recs = []
    widths = [(q, B) for q in DRAFT_Q for B in (1, PROMPTS, VERIFY_ROWS, PROMPTS * PROMPT_LEN)] + [(Q, VERIFY_ROWS)]
    timed_shapes = [(name, q, B) for name in ("bcq_mm", "bcq_mm_fused", "lutgemm") for q, B in widths]
    timed_shapes += [("ternary_mm", Q, VERIFY_ROWS)]
    for name, q, B in timed_shapes:
        for leaf in KERNELS[name][2]:
            k, o, dims = LEAVES[leaf]
            rec = check_kernel(name, B, k, o, q, G, torch.bfloat16, gen, dims if name == "bcq_mm_fused" else None)
            rec["leaf"] = leaf
            recs.append(rec)
    bad = [r for r in recs if not r["ok"]]
    for name in ("bcq_mm", "bcq_mm_fused"):
        for leaf in KERNELS[name][2]:
            k, o, dims = LEAVES[leaf]
            for q in (SPEC_Q, Q):
                for B in sorted(set(SERVE_PROMPT_LENS)):
                    rec = check_untimed(name, B, k, o, q, gen, dims if name == "bcq_mm_fused" else None)
                    rec["leaf"] = leaf
                    recs.append(rec)
                    bad += [] if rec["ok"] else [rec]
    if bad:
        raise SystemExit(f"chip_smoke: {len(bad)} draft-shape checks disagree with their plain versions: {bad[:3]}")
    log(f"  speculative path's shapes: {len(recs)} bf16 checks against the plain versions pass "
        f"(K1/K2/K3 at q'={DRAFT_Q} B={(1, PROMPTS, VERIFY_ROWS, PROMPTS * PROMPT_LEN)}, q={Q} B={VERIFY_ROWS}; "
        f"K4 B={VERIFY_ROWS}; K1/K2 at q={(SPEC_Q, Q)} over {len(set(SERVE_PROMPT_LENS))} prompt lengths)")
    steps = {}
    for path, names in (("bcq (bcq_mm + bcq_mm_fused)", ("bcq_mm", "bcq_mm_fused")), ("lutgemm", ("lutgemm",))):
        for B in (1, PROMPTS, VERIFY_ROWS):
            at = {q: path_step([r for r in records + recs if r["q"] == q and "ms" in r], names, B)
                  for q in (*DRAFT_Q, Q)}
            steps[f"{path} B={B}"] = {str(q): st for q, st in at.items()}
            log(f"  {path} decode step B={B} bf16: " + ", ".join(
                f"q={q} {st['ms']:.3f} ms (bound {st['bound_ms']:.3f})" for q, st in at.items())
                + f"; q'=2 / q=4 {at[2]['ms'] / at[Q]['ms']:.2f}x time, "
                f"{at[2]['bound_ms'] / at[Q]['bound_ms']:.2f}x bound")
    return recs, steps


def check_untimed(name, B, k, o, q, gen, out_dims=None, dtype=torch.bfloat16):
    """One kernel call, x in ``dtype`` and bf16 scales, against its plain
    version and a rerun, as in :func:`check_kernel`, without the timings
    → record dict."""
    fn, plain = kernel_fns()[name]
    x = torch.randn((B, k), generator=gen, device=DEVICE).to(dtype)
    packed, scales = format_planes(KERNELS[name][3], k, o, q, G, gen)
    scales = scales.to(torch.bfloat16)

    def call():
        return torch.cat(fn(x, packed, scales, g=G, out_dims=out_dims), dim=-1) if out_dims else fn(
            x, packed, scales, g=G)

    y = call()
    ref = plain(x, packed, scales, g=G)
    err = (y - ref).abs().max().item()
    same_bits = bool(torch.equal(call(), y))
    ok = bool(torch.allclose(y, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)) and bool(torch.isfinite(y).all()) and same_bits
    return dict(kernel=name, format=KERNELS[name][3], B=B, k=k, o=o, q=q, g=G, dtype=str(dtype).replace("torch.", ""),
                s_dtype="bfloat16", max_abs_err=err, tol=KERNEL_TOL, same_bits=same_bits, ok=ok)


def checked_shapes(records):
    """(kernel, planes, rows) of every bf16 leaf-shape check of phase 3."""
    return {(r["kernel"], r["q"], r["B"]) for r in records if r["leaf"] != "sweep" and is_bf16(r)}


def assert_checked(label, seen, checked):
    """Every (kernel, planes, rows) a counted run launched must have been
    held to its plain version in phase 3."""
    missing = sorted(set(seen) - checked)
    if missing:
        raise SystemExit(f"chip_smoke: [{label}] launched (kernel, planes, rows) {missing} that phase 3 never "
                         f"held to a plain version")


class _Counted:
    """A kernel wrapper seen through :func:`kernel_census`: counts each call
    by (kernel, planes, rows), then calls the wrapper. The wrapper counts its
    launches on its own module-level name, which now resolves here, so the
    counters pass through to the wrapper's."""

    def __init__(self, fn, name, seen, by_leaf):
        self._fn, self._name, self._seen, self._by_leaf = fn, name, seen, by_leaf

    def __call__(self, x, packed, scales, *a, **kw):
        leaf = (x.shape[-1], packed.shape[-1]) if self._by_leaf else ()
        self._seen[(self._name, packed.shape[0], x.shape[0], *leaf)] += 1
        return self._fn(x, packed, scales, *a, **kw)

    def __getattr__(self, attr):  # launches, tc_launches, ...
        return getattr(self._fn, attr)

    def __setattr__(self, attr, value):
        if attr.startswith("_"):
            object.__setattr__(self, attr, value)
        else:
            setattr(self._fn, attr, value)


@contextlib.contextmanager
def kernel_census(by_leaf=False):
    """Count every K1-K5 and K7 call, and K6's pipeline ``dequant_mm`` as
    ``dequant_materialize``, by (kernel, planes, rows) while the block runs
    (``by_leaf``: by (kernel, planes, rows, k, o)): the formats' ``matvec``
    imports the wrapper at each call, so the module attribute patched here
    sees them all."""
    seen = collections.Counter()
    patched = []
    for name in ("bcq_mm", "bcq_mm_fused", "lutgemm", "ternary_mm", "uniform_mm", "codebook_mm", "dequant_mm"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        fn = getattr(mod, name)
        setattr(mod, name, _Counted(fn, "dequant_materialize" if name == "dequant_mm" else name, seen, by_leaf))
        patched.append((mod, name, fn))
    try:
        yield seen
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


@contextlib.contextmanager
def flash_census():
    """Count every K8 call of the model by (B, q_start, Sq, dtype) while the
    block runs: ``models.layers`` holds the wrapper under its own name, which
    is patched here."""
    from repro_torch.models import layers

    seen = collections.Counter()
    real = layers.flash_attention

    def counted(q, k, v, q_start=0):
        seen[(q.shape[0], q_start, q.shape[1], q.dtype)] += 1
        return real(q, k, v, q_start)

    layers.flash_attention = counted
    try:
        yield seen
    finally:
        layers.flash_attention = real


def check_launched(label, seen, attn, records, gen, leaf_of=None, heads=LLAMA_HEADS, dtype=torch.bfloat16):
    """Hold every shape a phase launched to its plain version: each (kernel,
    planes, rows, k, o) of ``seen`` (:func:`kernel_census` by leaf) that
    phase 3's ``records`` did not check at that leaf, through
    :func:`check_untimed`, and each K8 (B, q_start, Sq, dtype) of ``attn``
    (:func:`flash_census`; None on a path without K8) through
    :func:`flash_offset_verdict` (plain version, rows of the cold launch,
    rerun) → records. ``leaf_of``: {(k, o): (leaf, fused out_dims)} of the
    model's packed linears (default llama3.2-3b's ``LEAVES``); ``heads``:
    K8's (H, Hkv, Dh); ``dtype``: the model's compute dtype, x's in the
    K1-K7 checks (phase 3's ``records`` count only for bf16)."""
    if not seen or attn is not None and not attn:
        raise SystemExit(f"chip_smoke: [{label}] the census saw no launches (K1-K7: {len(seen)}, K8: "
                         f"{None if attn is None else len(attn)})")
    done = {(r["kernel"], r["q"], r["B"], r["k"], r["o"]) for r in records if r["leaf"] != "sweep" and is_bf16(r)
            and dtype == torch.bfloat16}
    leaf_of = leaf_of or {(k, o): (leaf, dims) for leaf, (k, o, dims) in LEAVES.items()}
    recs = []
    for name, q, rows, k, o in sorted(set(seen) - done):
        leaf, dims = leaf_of[(k, o)]
        rec = check_untimed(name, rows, k, o, q, gen, dims if name == "bcq_mm_fused" else None, dtype)
        rec["leaf"] = leaf
        recs.append(rec)
        torch.cuda.empty_cache()  # a plain version at lm_head dequantizes ~4 GB of f32
    flash = [flash_offset_verdict(*flash_offset_inputs(q_start, sq, k_dtype, gen, B, heads), q_start, sq)
             for B, q_start, sq, k_dtype in sorted(attn or (), key=lambda t: (t[0], t[1], t[2], str(t[3])))]
    bad = [r for r in recs + flash if not r["ok"]]
    rows = sorted({r["B"] for r in recs})
    log(f"  [{label}] launched shapes held to their plain versions: {len(set(seen))} (kernel, planes, rows, leaf) "
        f"of K1-K7, {len(set(seen) - done)} of them not checked in phase 3 and checked now (rows {rows}); "
        f"{len(flash)} K8 (B, q_start, Sq) shapes (q_start {sorted({r['q_start'] for r in flash})}, Sq "
        f"{sorted({r['Sq'] for r in flash})}), largest K8 error {max((r['max_abs_err'] for r in flash), default=0):.2e}"
        f": {len(bad)} disagree")
    if bad:
        raise SystemExit(f"chip_smoke: [{label}] {len(bad)} launched shapes disagree with their plain versions: "
                         f"{bad[:3]}")
    return recs + flash


def forward_census(kernel_of, planes, rows, head_rows, n_layers, times=1):
    """The (kernel, planes, rows) calls of ``times`` forwards: each layer leaf
    once a layer at ``rows``, ``lm_head`` once at ``head_rows``."""
    c = collections.Counter()
    for leaf, kernel in kernel_of.items():
        c[(kernel, planes, head_rows if leaf == "lm_head" else rows)] += times * (1 if leaf == "lm_head" else n_layers)
    return c


def spec_paths(mode):
    """(target kernels, target planes, draft kernels, draft planes, SpecConfig)
    of each speculative path. "bcq q'=q" drafts with all q planes, so the
    draft is the target and every proposal must be accepted."""
    from repro_torch.infer import SpecConfig

    lut = dict.fromkeys(BCQ_LEAF_KERNELS, "lutgemm")
    return {
        "bcq": (BCQ_LEAF_KERNELS, Q, BCQ_LEAF_KERNELS, SPEC_Q, SpecConfig(SPEC_Q, SPEC_GAMMA)),
        "bcq q'=q": (BCQ_LEAF_KERNELS, Q, BCQ_LEAF_KERNELS, Q, SpecConfig(Q, SPEC_GAMMA)),
        "bcq lutgemm": (lut, Q, lut, SPEC_Q, SpecConfig(SPEC_Q, SPEC_GAMMA)),
        "ternary": (dict.fromkeys(BCQ_LEAF_KERNELS, "ternary_mm"), 2, BCQ_LEAF_KERNELS, SPEC_Q_TERNARY,
                    SpecConfig(SPEC_Q_TERNARY, SPEC_GAMMA)),
    }[mode]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def busy(run, wall_s):
    """Device busy ms of a profiled second run, and its share of the untraced run's wall."""
    device_ms, traced_ms, _ = device_profile(run)
    return dict(device_ms=device_ms, traced_wall_ms=traced_ms, busy_share=device_ms / (wall_s * 1e3))


def spec_generate_path(engine, prompts, path, checked):
    """Plain and speculative batched ``generate`` of the same prompts on one
    path: tokens equal, the speculative run's launches by (kernel, planes,
    rows) as the chunk structure predicts and each in ``checked`` (phase 3's
    shapes), K8 twice a layer (target and draft prefill), no ref-oracle
    dispatch; a q' = q draft must have every proposal accepted → summary."""
    import numpy as np

    from repro_torch.kernels import impl_mode

    kt, qt, kd, qd, spec = spec_paths(path)
    mode = "lutgemm" if path == "bcq lutgemm" else None
    L, B, n_tok = engine.cfg.n_layers, PROMPTS, PROMPTS * NEW_TOKENS
    with impl_mode(mode):
        engine.generate(prompts, 2, speculate=spec)  # warm-up: the draft view, allocator
        plain, t_plain = timed(lambda: engine.generate(prompts, NEW_TOKENS))
        _, ttft_plain = timed(lambda: engine.generate(prompts, 1))
        _, ttft_spec = timed(lambda: engine.generate(prompts, 1, speculate=spec))
        with kernel_census() as seen:
            res, dt, counts, ref_calls = run_counted(lambda: engine.generate(prompts, NEW_TOKENS, speculate=spec))
        from repro_torch.kernels import ternary_mm
        tc_launches = ternary_mm.tc_launches
        st = res.spec_stats
        prof_spec = busy(lambda: engine.generate(prompts, NEW_TOKENS, speculate=spec), dt)
        prof_plain = busy(lambda: engine.generate(prompts, NEW_TOKENS), t_plain)
    chunks, S = st["chunks"], PROMPT_LEN
    expect = (forward_census(kt, qt, B * S, B, L) + forward_census(kd, qd, B * S, B, L)
              + forward_census(kd, qd, B, B, L, chunks * (spec.gamma + 1))
              + forward_census(kt, qt, B * (spec.gamma + 1), B * (spec.gamma + 1), L, chunks))
    same = int((res.tokens == plain.tokens).all(axis=1).sum())
    log(f"  [spec {path}] q'={spec.q_draft} γ={spec.gamma}: accept rate {st['accept_rate']:.3f} "
        f"({st['accepted']}/{st['proposed']}), {chunks} chunks; {dt:.3f}s, {n_tok / dt:.1f} tok/s "
        f"(plain {t_plain:.3f}s, {n_tok / t_plain:.1f} tok/s); TTFT {ttft_spec:.3f}s (plain {ttft_plain:.3f}s); "
        f"device busy {prof_spec['device_ms']:.2f} ms, {prof_spec['busy_share']:.1%} of the wall "
        f"(plain {prof_plain['device_ms']:.2f} ms, {prof_plain['busy_share']:.1%})")
    log(f"  [spec {path}] greedy rows identical to plain: {same}/{PROMPTS}; launches {json.dumps(counts)}, "
        f"ref-oracle dispatches {ref_calls}")
    if same != PROMPTS:
        raise SystemExit(f"chip_smoke: [spec {path}] speculative greedy tokens differ from plain greedy")
    if qd == qt and not (st["accept_rate"] == 1.0 and st["accepted"] == st["proposed"] > 0):
        raise SystemExit(f"chip_smoke: [spec {path}] the draft is the target, yet only {st['accepted']}/"
                         f"{st['proposed']} proposals were accepted: a verify row differs from a decode step")
    if ref_calls:
        raise SystemExit(f"chip_smoke: [spec {path}] took the ref oracle {ref_calls} times")
    if dict(seen) != dict(expect):
        raise SystemExit(f"chip_smoke: [spec {path}] launches by (kernel, planes, rows) {dict(seen)} != "
                         f"predicted {dict(expect)}")
    assert_checked(f"spec {path}", seen, checked)
    if counts["flash_attention"] != 2 * L:
        raise SystemExit(f"chip_smoke: [spec {path}] K8 launched {counts['flash_attention']} times, not {2 * L}")
    if tc_launches != counts["ternary_mm"]:
        raise SystemExit(f"chip_smoke: [spec {path}] K4 took its tensor cores {tc_launches} of "
                         f"{counts['ternary_mm']} times")
    log(f"  [spec {path}] launches by (kernel, planes, rows) as predicted: "
        + ", ".join(f"{k}:{q}:{r}={n}" for (k, q, r), n in sorted(seen.items())))
    return dict(spec_stats=st, wall_s=dt, tok_s=n_tok / dt, plain_wall_s=t_plain, plain_tok_s=n_tok / t_plain,
                ttft_s=ttft_spec, plain_ttft_s=ttft_plain, profile=prof_spec, plain_profile=prof_plain,
                census={f"{k}:{q}:{r}": n for (k, q, r), n in seen.items()}, launches=counts,
                tokens_equal=same)


def step_device_ms(engine, spec):
    """Device time (profiler, busy ms over 3 calls) of one draft decode step
    at q', one q = 4 decode step and one verify forward, B = 4 at position
    16 of a filled cache."""
    from repro_torch.models import forward

    cfg, B = engine.cfg, PROMPTS
    toks = torch.randint(0, cfg.vocab, (B, PROMPT_LEN + spec.gamma + 1), device=DEVICE)
    _, cache = engine.prefill(toks[:, :PROMPT_LEN], engine._make_cache(B))
    pos = torch.full((B,), PROMPT_LEN, device=DEVICE)
    draft = engine.draft_params(spec.q_draft)
    runs = {
        f"draft step q'={spec.q_draft}": lambda: forward(cfg, draft, tokens=toks[:, PROMPT_LEN : PROMPT_LEN + 1],
                                                        cache=cache, pos=pos, logits_mode="last"),
        f"decode step q={Q}": lambda: forward(cfg, engine.params, tokens=toks[:, PROMPT_LEN : PROMPT_LEN + 1],
                                              cache=cache, pos=pos, logits_mode="last"),
        f"verify forward q={Q}, {spec.gamma + 1} tokens": lambda: forward(
            cfg, engine.params, tokens=toks[:, PROMPT_LEN:], cache=cache, pos=pos, logits_mode="all",
            chunked_decode=True),
    }
    out = {}
    for name, fn in runs.items():
        fn()
        device_ms, traced_ms, _ = device_profile(lambda: [fn() for _ in range(3)])
        out[name] = dict(device_ms=device_ms / 3, wall_ms=traced_ms / 3)
    log(f"  [spec] device time a forward (B={B}, {cfg.n_layers} layers, profiler busy ms; traced wall in brackets): "
        + ", ".join(
        f"{name} {v['device_ms']:.3f} ms [{v['wall_ms']:.1f}]" for name, v in out.items()))
    return out


def spec_serving(serving, plain_summary, checked):
    """Phase 6's 12 requests through ``Scheduler(speculate=SpecConfig(2, 4))``
    with 4 slots; the temperature-1.0 requests opt out. Every greedy and
    opted-out request must equal phase 6's solo plain ``generate`` of it;
    sampled speculative ones are reported. Launches as in
    :func:`spec_generate_path`."""
    import numpy as np

    from repro_torch.infer import SpecConfig
    from repro_torch.launch.serve import drive_continuous

    engine, solos = serving["engine"], serving["solos"]
    spec = SpecConfig(SPEC_Q, SPEC_GAMMA)
    L, n, slots = engine.cfg.n_layers, len(SERVE_PROMPT_LENS), SERVE_SLOTS

    def requests(seed0):
        reqs = serve_requests(engine.cfg, SERVE_PROMPT_LENS, NEW_TOKENS, seed0)
        for r in reqs:
            r.speculate = r.temperature != 1.0
        return reqs

    def serve(seed0):
        reqs = requests(seed0)
        sched, done, wall = drive_continuous(engine, reqs, np.zeros(n), n_slots=slots, chunk=SPEC_CHUNK,
                                             speculate=spec)
        return reqs, sched, done, wall

    drive_continuous(engine, serve_requests(engine.cfg, (16, 40), 2, 900), np.zeros(2), n_slots=slots,
                     chunk=SPEC_CHUNK, speculate=spec)  # warm-up
    with kernel_census() as seen:
        (reqs, sched, done, wall), _, counts, ref_calls = run_counted(lambda: serve(200))
    summ = sched.summary()
    if len(done) != n or summ["by_state"] != {"finished": n}:
        raise SystemExit(f"chip_smoke: [spec continuous] not every request finished: {summ['by_state']}")
    by_rid = {c.rid: c.new_tokens for c in done}
    same = [bool(np.array_equal(by_rid[r.rid], o.tokens[0, r.prompt.size:])) for r, o in zip(reqs, solos)]
    held = [r.temperature == 0 or not r.speculate for r in reqs]
    dispatches = sched.decode_steps // SPEC_CHUNK
    kt, kd = BCQ_LEAF_KERNELS, BCQ_LEAF_KERNELS
    expect = collections.Counter()
    for r in reqs:
        expect += forward_census(kt, Q, r.prompt.size, 1, L) + forward_census(kd, SPEC_Q, r.prompt.size, 1, L)
    expect += forward_census(kd, SPEC_Q, slots, slots, L, dispatches * SPEC_CHUNK * (SPEC_GAMMA + 1))
    expect += forward_census(kt, Q, slots * (SPEC_GAMMA + 1), slots * (SPEC_GAMMA + 1), L, dispatches * SPEC_CHUNK)
    tok_s, ttft = n * NEW_TOKENS / wall, summ["ttft_s"]
    prof = busy(lambda: serve(300), wall)
    ptt = plain_summary["ttft_s"]
    log(f"  [spec continuous] {n} requests, {slots} slots, {SPEC_CHUNK} chunks a dispatch, q'={SPEC_Q} "
        f"γ={SPEC_GAMMA}: {wall:.3f}s, {tok_s:.1f} tok/s (plain, phase 6: {plain_summary['tok_s']:.1f}), "
        f"TTFT p50 {ttft['p50']:.3f}s p95 {ttft['p95']:.3f}s (plain {ptt['p50']:.3f}s / {ptt['p95']:.3f}s), "
        f"draft acceptance ~{sched.spec_accept_rate:.3f}, {dispatches} dispatches; device busy "
        f"{prof['device_ms']:.2f} ms, {prof['busy_share']:.1%} of the wall (plain "
        f"{plain_summary['busy_share']:.1%})")
    log(f"  [spec continuous] greedy and opted-out requests == solo plain generate: "
        f"{sum(a for a, h in zip(same, held) if h)}/{sum(held)}; sampled speculative (reported, not asserted): "
        f"{sum(a for a, h in zip(same, held) if not h)}/{n - sum(held)} identical to the plain stream")
    log(f"  [spec continuous] launches {json.dumps(counts)}, ref-oracle dispatches {ref_calls}")
    if not all(a for a, h in zip(same, held) if h):
        raise SystemExit("chip_smoke: [spec continuous] a greedy or opted-out request differs from its solo generate")
    if ref_calls:
        raise SystemExit(f"chip_smoke: [spec continuous] took the ref oracle {ref_calls} times")
    if dict(seen) != dict(expect):
        raise SystemExit(f"chip_smoke: [spec continuous] launches by (kernel, planes, rows) {dict(seen)} != "
                         f"predicted {dict(expect)}")
    assert_checked("spec continuous", seen, checked)
    if counts["flash_attention"] != 2 * L * n:
        raise SystemExit(f"chip_smoke: [spec continuous] K8 launched {counts['flash_attention']} times, "
                         f"not {2 * L * n}")
    return dict(wall_s=wall, tok_s=tok_s, ttft_s=ttft, tpot_s=summ["tpot_s"], accept_rate=sched.spec_accept_rate,
                dispatches=dispatches, chunk_rows=sched.chunk_rows, held_same=same, profile=prof,
                plain_tok_s=plain_summary["tok_s"], plain_ttft_s=ptt, plain_busy_share=plain_summary["busy_share"],
                launches=counts)


SPEC_LAYERS = 8  # phase 7's depth: the first 8 of llama3.2-3b's 28 layers (the smoke's time budget)


def depth_view(engine, n_layers):
    """The first ``n_layers`` layers of an engine as an engine of their own:
    views of its stacked (fused) weights, no copy. The config's stages at
    ``n_layers`` must repeat the engine's patterns, each stage taking the
    first of its layers."""
    from repro_torch.infer import Engine

    cfg, params = layer_head(engine.cfg, engine.params, n_layers)
    return Engine(cfg, params, max_seq=engine.max_seq, fuse=False, device="cuda")


def layer_head(cfg, params, n_layers):
    """The first ``n_layers`` layers of a model: its config and views of
    its stacked weights, no copy. The config's stages at ``n_layers`` must
    repeat the model's patterns, each stage taking the first of its
    layers."""
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.utils import tree_map

    def head(leaf, n):
        if isinstance(leaf, QuantizedTensor):
            return leaf.replace(packed=leaf.packed[:n], scales=leaf.scales[:n])
        return leaf[:n]

    cut = dataclasses.replace(cfg, n_layers=n_layers, stages=None)
    if [p for p, _ in cut.stages] != [p for p, _ in cfg.stages]:
        raise SystemExit(f"chip_smoke: a {n_layers}-layer view of {cfg.name} has stages {cut.stages}, "
                         f"which do not repeat {cfg.stages}")
    return cut, dict(params, stages=tuple(tree_map(lambda leaf, n=n: head(leaf, n), stage)
                                          for (_, n), stage in zip(cut.stages, params["stages"])))


def spec_serving_view(bcq_engine, serving):
    """Phase 6's serving engine and solo ``generate``s, again at the depth
    of ``bcq_engine`` (a :func:`depth_view`), for phase 7's speculative
    scheduler."""
    engine = serving_engine(bcq_engine, serving["engine"].max_seq)
    reqs = serve_requests(engine.cfg, SERVE_PROMPT_LENS, NEW_TOKENS, 200)
    solos = [engine.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed) for r in reqs]
    return dict(engine=engine, solos=solos)


def phase_speculative(bcq_engine, ternary_engine, prompts, serving, plain_continuous, checked):
    """Self-speculative decoding at full width and ``SPEC_LAYERS`` layers
    (module docstring, phase 7) → (summary, launches summed over its runs)."""
    out, launches, took = {}, collections.Counter(), {}
    for path, engine in (("bcq", bcq_engine), ("bcq lutgemm", bcq_engine), ("ternary", ternary_engine),
                         ("bcq q'=q", bcq_engine)):
        t0 = time.perf_counter()
        out[path] = spec_generate_path(engine, prompts, path, checked)
        launches.update(out[path]["launches"])
        took[path] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["steps"] = step_device_ms(bcq_engine, spec_paths("bcq")[4])
    took["steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["continuous"] = spec_serving(serving, plain_continuous, checked)
    launches.update(out["continuous"]["launches"])
    took["continuous"] = time.perf_counter() - t0
    log("  [spec] phase wall by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in took.items()))
    out["took_s"] = took
    return out, launches


def prompt_key(prompt):
    """A prompt's token ids (host array or device tensor) as a dict key."""
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.cpu().numpy()
    return tuple(int(t) for t in prompt.reshape(-1))


def record_admissions(engine):
    """Keep the last-prompt logits of every admission the engine finishes,
    keyed by :func:`prompt_key` (patches ``finish_admission`` on the
    instance; ``admit_slot`` goes through it too). Undo with
    ``del engine.finish_admission``."""
    seen = {}
    real = engine.finish_admission

    def finish(slots, slot, pending):
        out = real(slots, slot, pending)
        seen[prompt_key(pending.prompt)] = out["logits"][slot].clone()
        return out

    engine.finish_admission = finish
    return seen


def prefix_requests(cfg):
    """12 requests sharing a ``PREFIX_LEN``-token system prompt, each with
    its own tail (``PREFIX_TAILS``); temperatures cycle 0, 1.0, 0.7."""
    import numpy as np

    from repro_torch.data import MarkovCorpus
    from repro_torch.infer import Request

    corpus = MarkovCorpus(cfg.vocab, seed=3)
    shared = corpus.sample(1, PREFIX_LEN, seed=99)[0, :PREFIX_LEN]
    return [
        Request(prompt=np.concatenate([shared, corpus.sample(1, t, seed=600 + i)[0, :t]]).astype(np.int32),
                max_new_tokens=NEW_TOKENS, temperature=[0.0, 1.0, 0.7][i % 3], seed=10 + i)
        for i, t in enumerate(PREFIX_TAILS)
    ]


def chunk_launches(sched, reqs, chunk):
    """The rows of each prefill dispatch of a scheduler run's admissions (one
    K8 launch a layer each: whole-shot, the prompt; chunked, the uncached
    rows in pieces of ``chunk``), and how many of them start at
    ``q_start > 0`` (offset unless the dispatch starts at 0)."""
    rows, offset = [], 0
    for r in reqs:
        rec = sched.outcomes[r.rid]
        todo = r.prompt.size - rec.prefix_hit_tokens
        n = 1 if chunk is None else -(-todo // chunk)
        if rec.prefill_chunks != n:
            raise SystemExit(f"chip_smoke: [prefix] request {r.rid} took {rec.prefill_chunks} prefill "
                             f"dispatches, not {n}")
        rows += [todo] if chunk is None else [min(chunk, todo - i * chunk) for i in range(n)]
        offset += n if rec.prefix_hit_tokens else n - 1
    return rows, offset


def phase_prefix(bcq_engine, long_whole, records, gen):
    """The prefix cache and chunked prefill at full width and depth
    (module docstring, phase 8), every shape it launched then held to its
    plain version (``records``: phase 3's) → summary."""
    with kernel_census(by_leaf=True) as seen, flash_census() as attn:
        out = prefix_runs(bcq_engine, long_whole)
    out["launched_checks"] = check_launched("prefix", seen, attn, records, gen)
    return out


def device_split(by_name):
    """A trace's device ms by part: K8, K1/K2, copies (copy kernels, cat,
    memcpy, memset) and the rest."""
    parts = dict.fromkeys(("K8", "K1/K2", "copies", "other"), 0.0)
    for name, ms in by_name.items():
        low = name.lower()
        part = ("K8" if any(t in name for t in FLASH_TAGS) else "K1/K2" if PROFILE_TAG["bcq"] in name
                else "copies" if any(t in low for t in ("copy", "memcpy", "memset")) else "other")
        parts[part] += ms
    return parts


def prefix_profiles(bcq_engine, max_seq):
    """What a cold wave costs against no cache: the cold wave (a fresh
    cache, ``prefill_chunk=PREFIX_CHUNK``), a cold wave with a fresh cache
    and whole-shot admissions, and the requests without a cache, each run
    once untraced and once traced (:func:`device_profile`), each run on an
    engine and cache of its own → {run: summary}."""
    import numpy as np

    from repro_torch.infer import PrefixCache
    from repro_torch.launch.serve import drive_continuous

    cfg, n = bcq_engine.cfg, len(PREFIX_TAILS)
    out = {}
    for name, cached, chunk in (("cold wave", True, PREFIX_CHUNK), ("cold wave, whole-shot", True, None),
                                ("no cache", False, None)):
        def wave():
            cache = PrefixCache(block_tokens=PREFIX_BLOCK, max_bytes=PREFIX_CACHE_BYTES) if cached else None
            engine = serving_engine(bcq_engine, max_seq, prefix_cache=cache)
            return drive_continuous(engine, prefix_requests(cfg), np.zeros(n), n_slots=SERVE_SLOTS,
                                    chunk=SERVE_CHUNK, prefill_chunk=chunk)

        sched, _, wall = wave()
        device_ms, traced_ms, by_name = device_profile(wave)
        parts = device_split(by_name)
        ttft = sched.summary()["ttft_s"]
        dispatches = sum(rec.prefill_chunks for rec in sched.outcomes.values())
        out[name] = dict(wall_s=wall, tok_s=n * NEW_TOKENS / wall, ttft_s=ttft, prefill_dispatches=dispatches,
                         decode_steps=sched.decode_steps, device_ms=device_ms, traced_wall_ms=traced_ms,
                         busy_share=device_ms / (wall * 1e3), device_by_part=parts)
        log(f"  [prefix profile] {name}: {wall:.3f}s, {n * NEW_TOKENS / wall:.1f} tok/s, TTFT p50 "
            f"{ttft['p50']:.3f}s p95 {ttft['p95']:.3f}s, {dispatches} prefill dispatches, {sched.decode_steps} "
            f"decode steps; traced: device busy {device_ms:.2f} ms of {traced_ms:.2f} ms traced wall "
            f"({device_ms / traced_ms:.1%}; {device_ms / (wall * 1e3):.1%} of the untraced wall); device ms by "
            "part: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    return out


def prefix_runs(bcq_engine, long_whole):
    """Phase 8's runs (module docstring) → summary."""
    import numpy as np

    from repro_torch.infer import PrefixCache
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.serve import drive_continuous

    cfg = bcq_engine.cfg
    L, n = cfg.n_layers, len(PREFIX_TAILS)
    max_seq = PREFIX_LEN + max(PREFIX_TAILS) + NEW_TOKENS + 8
    cache = PrefixCache(block_tokens=PREFIX_BLOCK, max_bytes=PREFIX_CACHE_BYTES)
    warm = serving_engine(bcq_engine, max_seq, prefix_cache=cache)
    plain = serving_engine(bcq_engine, max_seq)
    runs, out = {}, {}
    # warm-up, as in phase 6: 6 of the requests, chunked, on a cache of their own (4 miss, 2 hit)
    drive_continuous(serving_engine(bcq_engine, max_seq, prefix_cache=PrefixCache(
        block_tokens=PREFIX_BLOCK, max_bytes=PREFIX_CACHE_BYTES)), prefix_requests(cfg)[:SERVE_SLOTS + 2],
        np.zeros(SERVE_SLOTS + 2), n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK, prefill_chunk=PREFIX_CHUNK)
    copies0 = flash_attention.copies
    for name, engine, chunk in (("cold wave", warm, PREFIX_CHUNK), ("warm wave", warm, PREFIX_CHUNK),
                                ("no cache", plain, None)):
        logits = record_admissions(engine)
        reqs = prefix_requests(cfg)
        hits0 = cache.counters["hits"]
        (sched, done, wall), _, counts, ref_calls = run_counted(lambda: drive_continuous(
            engine, reqs, np.zeros(n), n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK, prefill_chunk=chunk))
        offset = flash_attention.offset_launches
        del engine.finish_admission
        summ = sched.summary()
        if len(done) != n or summ["by_state"] != {"finished": n}:
            raise SystemExit(f"chip_smoke: [prefix {name}] not every request finished: {summ['by_state']}")
        rows, offsets = chunk_launches(sched, reqs, chunk)
        dispatches = len(rows)
        expect = expect_forward_counts(counts, sched.decode_steps, rows, L)
        hit = [sched.outcomes[r.rid].prefix_hit_tokens for r in reqs]
        by_rid = {c.rid: c.new_tokens for c in done}
        runs[name] = dict(tokens=[by_rid[r.rid] for r in reqs], logits=[logits[prompt_key(r.prompt)] for r in reqs])
        ttft = summ["ttft_s"]
        out[name] = dict(wall_s=wall, tok_s=n * NEW_TOKENS / wall, ttft_s=ttft, tpot_s=summ["tpot_s"],
                         hit_tokens=hit, hits=cache.counters["hits"] - hits0 if engine is warm else 0,
                         prefill_dispatches=dispatches, launches=counts, offset_launches=offset,
                         cached_bytes=cache.cached_bytes if engine is warm else 0)
        log(f"  [prefix {name}] {n} requests ({PREFIX_LEN}-token shared prompt + {min(PREFIX_TAILS)}-"
            f"{max(PREFIX_TAILS)}-token tails, {NEW_TOKENS} new), {SERVE_SLOTS} slots, chunk {SERVE_CHUNK}, "
            f"prefill_chunk {chunk}: {wall:.3f}s, {n * NEW_TOKENS / wall:.1f} tok/s, TTFT p50 {ttft['p50']:.3f}s "
            f"p95 {ttft['p95']:.3f}s; hit tokens {sum(hit)} ({hit}); {dispatches} prefill dispatches; "
            f"K8 {counts['flash_attention']} launches, {offset} at q_start > 0")
        if counts != expect or offset != offsets * L:
            raise SystemExit(f"chip_smoke: [prefix {name}] launches {counts} (offset {offset}) != expected "
                             f"{expect} (offset {offsets * L})")
        if ref_calls:
            raise SystemExit(f"chip_smoke: [prefix {name}] took the ref oracle {ref_calls} times")
    c = cache.counters
    st = cache.stats()
    if flash_attention.copies != copies0:
        raise SystemExit("chip_smoke: [prefix] K8 copied a cache view instead of reading it in place")
    log(f"  [prefix] cache: {c['hits']} hits / {c['misses']} misses, {c['commits']} commits, {c['aborts']} "
        f"aborts, {c['evictions']} evictions, {st['cached_bytes'] / 1e6:.1f} MB cached in {st['nodes']} blocks "
        f"of {PREFIX_BLOCK} tokens (budget {PREFIX_CACHE_BYTES / 1e6:.1f} MB), pinned {st['pinned']}")
    if c["hits"] + c["misses"] != c["commits"] + c["aborts"] or st["pinned"]:
        raise SystemExit(f"chip_smoke: [prefix] the cache's accounting is not clean: {st}")
    if out["warm wave"]["hits"] != n or min(out["warm wave"]["hit_tokens"]) < PREFIX_LEN:
        raise SystemExit(f"chip_smoke: [prefix] the warm wave did not hit on every request: "
                         f"{out['warm wave']['hit_tokens']}")
    ref = runs["no cache"]
    for name in ("cold wave", "warm wave"):
        same_tok = [bool(np.array_equal(a, b)) for a, b in zip(runs[name]["tokens"], ref["tokens"])]
        same_log = [bool(torch.equal(a, b)) for a, b in zip(runs[name]["logits"], ref["logits"])]
        log(f"  [prefix] {name} vs whole-shot without a cache: tokens equal {sum(same_tok)}/{n}, last-prompt "
            f"logits bitwise equal {sum(same_log)}/{n}")
        out[name].update(tokens_equal=sum(same_tok), logits_equal=sum(same_log))
        if not (all(same_tok) and all(same_log)):
            raise SystemExit(f"chip_smoke: [prefix] the {name} differs from whole-shot admission: tokens "
                             f"{same_tok}, logits {same_log}")
    reqs = prefix_requests(cfg)
    greedy = [(i, r) for i, r in enumerate(reqs) if r.temperature == 0]
    for i, r in greedy:
        solo = plain.generate(r.prompt[None], r.max_new_tokens)
        if not np.array_equal(solo.tokens[0, r.prompt.size:], ref["tokens"][i]):
            raise SystemExit(f"chip_smoke: [prefix] greedy request {i} differs from its solo generate")
    log(f"  [prefix] greedy requests == solo generate: {len(greedy)}/{len(greedy)}")

    # each admission's prefill device time: cold (whole-shot, no cache) and warm (its blocks cached)
    cold_ms, warm_ms = [], []
    for r in reqs:
        for engine, dest in ((plain, cold_ms), (warm, warm_ms)):
            slots = engine.init_slots(1)
            ms, _, _ = device_profile(lambda: engine.admit_slot(slots, 0, r.prompt, max_new_tokens=NEW_TOKENS))
            dest.append(ms)
    log("  [prefix] admission device ms, cold -> warm: " + ", ".join(
        f"{r.prompt.size}: {a:.2f} -> {b:.2f}" for r, a, b in zip(reqs, cold_ms, warm_ms))
        + f"; total {sum(cold_ms):.2f} -> {sum(warm_ms):.2f} ms ({sum(warm_ms) / sum(cold_ms):.1%})")
    out.update(cold_admission_ms=cold_ms, warm_admission_ms=warm_ms, cache=st)
    if cache.pinned:
        raise SystemExit("chip_smoke: [prefix] pins left after the profiled admissions")
    del warm, plain
    out["profiles"] = prefix_profiles(bcq_engine, max_seq)
    out["long"] = long_chunked(bcq_engine, *long_whole)
    return out


def long_chunked(bcq_engine, whole, whole_logits, whole_tokens):
    """Phase 6's 8192-token request through a 1-slot scheduler with
    ``prefill_chunk=LONG_CHUNK``: 8 chunks, the last at q_start = 7168. Its
    tokens and last-prompt logits must equal the whole-shot run's, bitwise."""
    import numpy as np

    from repro_torch.infer import RequestState, Scheduler
    from repro_torch.kernels import flash_attention
    from repro_torch.models.layers import LONG_SEQ_THRESHOLD

    cfg = bcq_engine.cfg
    L, S = cfg.n_layers, LONG_SEQ_THRESHOLD
    engine = serving_engine(bcq_engine, S + LONG_NEW)
    (req,) = serve_requests(cfg, (S,), LONG_NEW, 500)  # phase 6's request
    logits = record_admissions(engine)

    def run():
        sched = Scheduler(engine, n_slots=1, chunk=SERVE_CHUNK, prefill_chunk=LONG_CHUNK, clock=synced_clock)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rid = sched.submit(dataclasses.replace(req, rid=None))
        (c,) = sched.run()
        peak = torch.cuda.max_memory_allocated() - base
        rec = sched.outcomes[rid]
        stamps = dict(rec.history)
        return c.new_tokens, stamps[RequestState.DECODING] - stamps[RequestState.PREFILLING], peak, rec.prefill_chunks

    (toks, prefill_s, peak, chunks), wall, counts, ref_calls = run_counted(run)
    offset = flash_attention.offset_launches
    del engine.finish_admission
    n_chunks = -(-S // LONG_CHUNK)
    same_tok = bool(np.array_equal(toks, whole_tokens))
    same_log = bool(torch.equal(logits[prompt_key(req.prompt)], whole_logits))
    log(f"  [prefix long] {S}-token prompt in {chunks} chunks of {LONG_CHUNK} (the last at q_start = "
        f"{(n_chunks - 1) * LONG_CHUNK}) + {LONG_NEW} new tokens: prefill {prefill_s:.3f}s against whole-shot "
        f"{whole['prefill_s']:.3f}s; peak device memory {peak / 1e9:.3f} GB above the resident (whole-shot "
        f"{whole['peak_gb']:.3f} GB); K8 {counts['flash_attention']} launches, {offset} at q_start > 0; "
        f"tokens {'equal' if same_tok else 'DIFFER'}, last-prompt logits "
        f"{'bitwise equal' if same_log else 'DIFFER'} to the whole-shot run")
    if chunks != n_chunks or counts["flash_attention"] != n_chunks * L or offset != (n_chunks - 1) * L:
        raise SystemExit(f"chip_smoke: [prefix long] {chunks} chunks, K8 {counts['flash_attention']} launches "
                         f"({offset} offset); expected {n_chunks}, {n_chunks * L} ({(n_chunks - 1) * L})")
    if ref_calls:
        raise SystemExit(f"chip_smoke: [prefix long] took the ref oracle {ref_calls} times")
    if not (same_tok and same_log):
        raise SystemExit("chip_smoke: [prefix long] the chunked prefill differs from the whole-shot one")
    return dict(prompt_len=S, chunk=LONG_CHUNK, chunks=chunks, prefill_s=prefill_s, whole_prefill_s=whole["prefill_s"],
                peak_gb=peak / 1e9, whole_peak_gb=whole["peak_gb"], wall_s=wall, launches=counts,
                offset_launches=offset, tokens_equal=same_tok, logits_equal=same_log)


# -- phase 10: captured decode and the int8 cache -----------------------------


def decode_loop(engine, prompts, captured, n=NEW_TOKENS):
    """Prefill ``prompts`` → a function that runs ``n`` greedy
    decode steps from the prefill's logits, through the engine's decode graph
    (``generate(scan=True)``'s) or eagerly into a fresh cache at scalar
    positions (``scan=False``'s), and returns their ``(B, n, V)`` logits.
    Run it again and it rewrites the same rows with the same values."""
    tokens = torch.as_tensor(prompts, device=DEVICE).long()
    b, s = tokens.shape
    graph = engine._generate_graph(b) if captured else None
    logits0, cache = engine.prefill(tokens, graph.cache if captured else engine._make_cache(b))

    def loop():
        logits, c, out = logits0, cache, []
        for step in range(n):
            tok = torch.argmax(logits, dim=-1)
            if captured:
                logits = graph(tok, s + step).clone()
            else:
                logits, c = engine.decode(tok[:, None], c, s + step)
            out.append(logits)
        return torch.stack(out, dim=1)

    return loop


def graph_path(engine, prompts, label, mode=None):
    """One format path, captured against eager: every step's logits and the
    sampled ``generate``'s tokens bit for bit, the census equal, and each
    decode loop's wall, tok/s, device-busy share and launches a step."""
    from repro_torch.kernels import impl_mode

    from repro_torch.kernels import ternary_mm

    n_tok = PROMPTS * NEW_TOKENS
    out, traces = {}, {}
    with impl_mode(mode):
        for name, captured in (("eager", False), ("graph", True)):
            loop = decode_loop(engine, prompts, captured)
            if captured:  # the graph's warm-up and capture, where phase 5 did not make them
                first = loop()
            again, wall, counts, _ = run_counted(loop)
            if captured and not torch.equal(first, again):
                raise SystemExit(f"chip_smoke: [graphs] {label}: a rerun of the replayed loop changed its logits")
            traced_loop = decode_loop(engine, prompts, captured)  # its prefill: outside the window
            (device_ms, traced_ms, _, traces[name]), _, traced_counts, _ = run_counted(
                lambda: device_profile(traced_loop, events=True))
            if traced_counts != counts:
                raise SystemExit(f"chip_smoke: [graphs] {label} {name}: the traced loop's census {traced_counts} "
                                 f"!= the untraced loop's {counts}")
            _, missed = check_trace_census(f"graphs, {label} {name}", traces[name], traced_counts,
                                           ternary_mm.tc_launches)
            out[name] = dict(logits=again, wall_s=wall, tok_s=n_tok / wall, device_ms=device_ms, census_less_traced=missed,
                             busy_share=device_ms / (wall * 1e3), traced_wall_ms=traced_ms,
                             launches_per_step=sum(counts.values()) / NEW_TOKENS,
                             device_kernels_per_step=sum(traces[name].values()) / NEW_TOKENS)
        logits_equal = torch.equal(out["graph"].pop("logits"), out["eager"].pop("logits"))
        runs = {}
        for name, scan in (("eager", False), ("graph", True)):
            runs[name] = run_counted(lambda: engine.generate(prompts, NEW_TOKENS, temperature=0.8, seed=7, scan=scan))
    tokens_equal = bool((runs["graph"][0].tokens == runs["eager"][0].tokens).all())
    counts_equal = runs["graph"][2] == runs["eager"][2]
    graph = engine._graphs[(PROMPTS, mode)]
    e, g = out["eager"], out["graph"]
    log(f"  [graphs] {label}: {NEW_TOKENS} decode steps at B = {PROMPTS}, eager {e['wall_s'] * 1e3:.2f} ms "
        f"({e['tok_s']:.1f} tok/s, device {e['device_ms']:.2f} ms, busy {e['busy_share']:.1%}) | graph "
        f"{g['wall_s'] * 1e3:.2f} ms ({g['tok_s']:.1f} tok/s, device {g['device_ms']:.2f} ms, busy "
        f"{g['busy_share']:.1%}): {g['tok_s'] / e['tok_s']:.2f}x; a step: {g['launches_per_step']:.0f} kernel-wrapper "
        f"launches (eager {e['launches_per_step']:.0f}), device events traced {g['device_kernels_per_step']} "
        f"(eager {e['device_kernels_per_step']}); logits equal {logits_equal}, sampled generate tokens equal "
        f"{tokens_equal}, census equal {counts_equal}; the graph's kernel nodes "
        f"{({k: v for k, v in GRAPH_NODES[graph].items() if v})} (its capture's counts); the census less the "
        f"traced launches {e['census_less_traced'] or 0} (eager), {g['census_less_traced'] or 0} (graph); pool "
        f"{POOL_BYTES[graph] / 1e6:.1f} MB, workspace {graph.workspace.nbytes() / 1e6:.2f} MB, {graph.replays} replays")
    if not (logits_equal and tokens_equal and counts_equal):
        raise SystemExit(f"chip_smoke: [graphs] {label}: the replayed graph differs from the eager loop "
                         f"(logits {logits_equal}, tokens {tokens_equal}, census {counts_equal}: "
                         f"{runs['graph'][2]} vs {runs['eager'][2]})")
    return dict(eager=e, graph=g, speedup=g["tok_s"] / e["tok_s"], pool_bytes=POOL_BYTES[graph],
                workspace_bytes=graph.workspace.nbytes(), generate_wall_s={k: v[1] for k, v in runs.items()})


def graph_serving(bcq_engine):
    """Phase 6's 12 requests through 4 slots, the slot graph against the
    eager slot loop: the same tokens at temperatures 0, 1.0 and 0.7, the same
    census; wall, tok/s, TTFT and busy share of each."""
    import numpy as np

    from repro_torch.infer import engine as engine_mod
    from repro_torch.launch.serve import drive_continuous

    cfg = bcq_engine.cfg
    n = len(SERVE_PROMPT_LENS)
    engine = serving_engine(bcq_engine, max(SERVE_PROMPT_LENS) + NEW_TOKENS + 8)

    def serve():
        reqs = serve_requests(cfg, SERVE_PROMPT_LENS, NEW_TOKENS, 200)
        sched, done, wall = drive_continuous(engine, reqs, np.zeros(n), n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK)
        by_rid = {c.rid: c.new_tokens for c in done}
        return [by_rid[r.rid] for r in reqs], sched, wall

    out, tokens, traces = {}, {}, {}
    for name, eager in (("eager", True), ("graph", False)):
        engine_mod._EAGER_SLOT_STEPS = eager
        try:  # no warm-up: phase 6 ran these requests on the same weights
            (toks, sched, wall), _, counts, _ = run_counted(serve)
            (device_ms, traced_ms, _, traces[name]), _, traced_counts, _ = run_counted(
                lambda: device_profile(serve, events=True))
        finally:
            engine_mod._EAGER_SLOT_STEPS = False
        if traced_counts != counts:
            raise SystemExit(f"chip_smoke: [graphs] continuous {name}: the traced run's census {traced_counts} "
                             f"!= the untraced run's {counts}")
        _, missed = check_trace_census(f"graphs, continuous {name}", traces[name], counts)
        tokens[name] = toks
        ttft = sched.summary()["ttft_s"]
        pool = POOL_BYTES[sched.slots["graphs"][None]] if not eager else 0
        out[name] = dict(wall_s=wall, tok_s=n * NEW_TOKENS / wall, ttft_s=ttft, device_ms=device_ms,
                         busy_share=device_ms / (wall * 1e3), traced_wall_ms=traced_ms, counts=counts,
                         decode_steps=sched.decode_steps, pool_bytes=pool, census_less_traced=missed,
                         launches_per_forward=sum(counts.values()) / (n + sched.decode_steps))
        log(f"  [graphs] continuous {name}: {wall:.3f}s, {n * NEW_TOKENS / wall:.1f} tok/s, TTFT p50 "
            f"{ttft['p50']:.3f}s p95 {ttft['p95']:.3f}s, {sched.decode_steps} decode steps; traced rerun: device "
            f"{device_ms:.2f} ms ({device_ms / (wall * 1e3):.1%} of the untraced wall); "
            f"{out[name]['launches_per_forward']:.0f} kernel-wrapper launches a forward, the census less the traced "
            f"launches {missed or 0}; pool {pool / 1e6:.1f} MB")
    same = [bool(np.array_equal(a, b)) for a, b in zip(tokens["graph"], tokens["eager"])]
    log(f"  [graphs] continuous: tokens equal, slot graph vs eager slot loop: {sum(same)}/{n} "
        f"(temperatures 0, 1.0, 0.7); census equal {out['graph']['counts'] == out['eager']['counts']}; "
        f"{out['graph']['tok_s'] / out['eager']['tok_s']:.2f}x tok/s")
    if not all(same) or out["graph"]["counts"] != out["eager"]["counts"]:
        raise SystemExit("chip_smoke: [graphs] the slot graph's tokens or census differ from the eager slot loop's")
    return dict(out, speedup=out["graph"]["tok_s"] / out["eager"]["tok_s"])


# -- the dry run's predictions, checked in phases 10 and 17 ---------------------

DRYRUN_PEAK_TOL = 0.25  # phase 17: the predicted peak within 25% of max_memory_allocated


def dryrun_cells(out_path):
    """The dry run (``launch/dryrun.py``: meta tensors, no card) of the
    steps phases 10 and 17 run, on a 1 x 1 mesh → JSON at ``out_path``:
    llama3.2-3b bcq q = 4 decode steps at B = 64 and 4 over
    ``INT8_MAX_SEQ`` rows with the bf16 and the int8 cache, and phase 17's
    train step (full width and depth, bf16, ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` tokens, remat, accum 1, every layer traced). Run in a
    process of its own, started in phase 5 (:class:`DryRun`)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import ShapeConfig
    from repro_torch.parallel.sharding import MeshAxes

    one = MeshAxes(("data",), "data", "model", (("data", 1), ("model", 1)))
    out = {}
    for kv in ("bfloat16", "int8"):
        cfg = dataclasses.replace(get_config("llama3.2-3b"), kv_cache_dtype=kv)
        for B in INT8_BATCHES:
            t = time.perf_counter()
            r = run_cell(cfg, ShapeConfig(f"decode_{INT8_MAX_SEQ}", INT8_MAX_SEQ, B, "decode"), one, Q, verbose=False)
            out[f"{kv}/B={B}"] = dict(parts=r["argument_parts"], temp=r["memory_analysis"]["temp_size"],
                                      seconds=time.perf_counter() - t)
    t = time.perf_counter()
    r = run_cell(get_config(TRAIN), ShapeConfig("train_card", TRAIN_SEQ, TRAIN_BATCH, "train"), one, 0, verbose=False,
                 accum=1)
    out["train"] = dict(parts=r["argument_parts"], temp=r["memory_analysis"]["temp_size"],
                        seconds=time.perf_counter() - t)
    Path(out_path).write_text(json.dumps(out))


class DryRun:
    """:func:`dryrun_cells` in a child process, started at construction
    (phase 5, once every source is built, so that its trace does not take
    cores from ``nvcc``; it ends before phase 10); ``result()`` waits for it
    and fails the smoke if it failed. ``waited_s`` sums the checks' seconds,
    waiting included."""

    def __init__(self, tmp_dir):
        import os

        self.path = Path(tmp_dir) / "dryrun.json"
        self.log_path = Path(tmp_dir) / "dryrun.log"
        self.t0 = time.perf_counter()
        self.waited_s = 0.0
        env = dict(os.environ, PYTHONPATH=str(SRC))
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                f"chip_smoke.dryrun_cells({str(self.path)!r})")
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=out,
                                         stderr=subprocess.STDOUT)
        self._out = None

    def result(self):
        if self._out is None:
            ended = self.proc.poll() is not None
            self.proc.wait(timeout=600)
            if self.proc.returncode != 0:
                raise SystemExit(f"chip_smoke: [dryrun] the dry run failed (exit {self.proc.returncode}):\n"
                                 f"{self.log_path.read_text()[-3000:]}")
            self._out = json.loads(self.path.read_text())
            log(f"  [dryrun] the dry run's process {'had ended by' if ended else 'was waited for at'} the first "
                f"check, {time.perf_counter() - self.t0:.1f}s after it began; its cells: "
                + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in self._out.items()))
        return self._out

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def dryrun_decode_check(dry, kv, B, param_bytes, cache_bytes):
    """Phase 10: the dry run's argument bytes of a decode step, params as
    quantized and cache, against the engine's resident tensors (exact)."""
    t = time.perf_counter()
    cell = dry.result()[f"{kv}/B={B}"]
    parts = cell["parts"]
    want = param_bytes + cache_bytes
    got = parts["params"] + parts["cache"]
    log(f"  [dryrun] decode B = {B}, {kv} cache over {INT8_MAX_SEQ} rows, bcq q = {Q}, 1 x 1 mesh: arguments "
        f"(params + cache) predicted {got} B (params {parts['params']}, cache {parts['cache']}; batch "
        f"{parts['batch']}), resident {want} B (params {param_bytes}, cache {cache_bytes}): equal {got == want}")
    dry.waited_s += time.perf_counter() - t
    if got != want or parts["params"] != param_bytes:
        raise SystemExit(f"chip_smoke: [dryrun] decode B = {B} {kv}: predicted {got} B, resident {want} B")


def dryrun_train_check(dry, resident, peak):
    """Phase 17: the dry run's argument bytes of the train step (params,
    AdamW state, batch) against the card's tensors (exact), and its
    predicted peak (arguments + temporaries) against ``peak``, the measured
    ``max_memory_allocated`` above the memory allocated before the run
    (within ``DRYRUN_PEAK_TOL``)."""
    t = time.perf_counter()
    cell = dry.result()["train"]
    parts = cell["parts"]
    args = sum(parts.values())
    predicted = args + cell["temp"]
    ratio = predicted / peak
    equal = parts == resident
    log(f"  [dryrun] train {TRAIN}, full width and depth, bf16, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat, accum 1, "
        f"1 x 1 mesh: arguments predicted {args} B {parts}, resident {sum(resident.values())} B {resident}: equal "
        f"{equal}; peak predicted {predicted / 1e9:.3f} GB (arguments {args / 1e9:.3f} + temporaries "
        f"{cell['temp'] / 1e9:.3f}), measured {peak / 1e9:.3f} GB: ratio {ratio:.4f} (bound 1 +- {DRYRUN_PEAK_TOL})")
    dry.waited_s += time.perf_counter() - t
    if not equal or abs(ratio - 1) > DRYRUN_PEAK_TOL:
        raise SystemExit(f"chip_smoke: [dryrun] train: arguments {parts} vs {resident}, peak ratio {ratio:.4f}")
    return dict(arguments=parts, resident=resident, predicted_peak=predicted, measured_peak=peak, ratio=ratio)


def rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def int8_steps(bcq_engine, dry):
    """The decode step's device time with the bf16 and the int8 cache at
    B = 64 and 4, ``max_seq`` 2048, as graph replays, median of 7; the
    caches' resident bytes and each capture's pool (the engine keeps one
    width's cache and graphs: the B = 4 ones replace the B = 64 ones); the
    dry run's argument bytes of each step against the resident ones
    (:func:`dryrun_decode_check`)."""
    from repro_torch.infer import Engine
    from repro_torch.quant import quantized_bytes
    from repro_torch.utils import tree_leaves

    out = {}
    for kv in ("bfloat16", "int8"):
        cfg = dataclasses.replace(bcq_engine.cfg, kv_cache_dtype=kv)
        engine = Engine(cfg, bcq_engine.params, max_seq=INT8_MAX_SEQ, fuse=False, device="cuda")
        for B in INT8_BATCHES:
            graph = engine._generate_graph(B)
            tok = torch.zeros((B,), dtype=torch.long, device=DEVICE)
            pos = torch.full((B,), INT8_MAX_SEQ // 2, dtype=torch.long, device=DEVICE)
            graph(tok, pos)  # warm-up
            graph(tok, pos)  # capture, then a replay
            ms = _median_event_ms(graph.graph.replay, 1, 7)
            cache_bytes = sum(leaf.nbytes for leaf in tree_leaves(graph.cache))
            out[(kv, B)] = dict(step_ms=ms, cache_bytes=cache_bytes, pool_bytes=POOL_BYTES[graph])
            dryrun_decode_check(dry, kv, B, quantized_bytes(engine.params), cache_bytes)
        log(f"  [int8] {kv} cache, max_seq {INT8_MAX_SEQ}: " + "; ".join(
            f"B = {B}: step {out[(kv, B)]['step_ms']:.3f} ms, cache {out[(kv, B)]['cache_bytes'] / 1e9:.3f} GB, "
            f"pool {out[(kv, B)]['pool_bytes'] / 1e9:.3f} GB" for B in INT8_BATCHES)
            + f"; then allocated: {torch.cuda.memory_allocated() / 1e9:.3f} GB (the weights, the last width's "
              f"cache and graph)")
        del engine, graph
        torch.cuda.empty_cache()
    for B in INT8_BATCHES:
        a, b = out[("int8", B)], out[("bfloat16", B)]
        log(f"  [int8] B = {B}: int8 step {a['step_ms'] / b['step_ms']:.2f}x the bf16 step, cache "
            f"{a['cache_bytes'] / b['cache_bytes']:.3f}x")
    return {f"{kv}/B={B}": v for (kv, B), v in out.items()}


def int8_exactness(bcq_engine, prompts):
    """The int8 cache at full width: decode logits within 5% (relative L2)
    of the bf16 cache's on the same tokens; slot == solo and greedy
    speculative == plain, bit for bit."""
    import numpy as np

    from repro_torch.infer import Engine, SpecConfig
    from repro_torch.launch.serve import drive_continuous

    cfg8 = dataclasses.replace(bcq_engine.cfg, kv_cache_dtype="int8")
    eng8 = Engine(cfg8, bcq_engine.params, max_seq=bcq_engine.max_seq, fuse=False, device="cuda")
    toks = torch.as_tensor(bcq_engine.generate(prompts, NEW_TOKENS).tokens, device=DEVICE).long()
    runs = {}
    for name, eng in (("bf16", bcq_engine), ("int8", eng8)):
        l0, cache = eng.prefill(toks[:, :PROMPT_LEN], eng._make_cache(PROMPTS))
        steps = []
        for t in range(PROMPT_LEN, PROMPT_LEN + NEW_TOKENS - 1):
            lg, cache = eng.decode(toks[:, t : t + 1], cache, t)
            steps.append(lg)
        runs[name] = (l0, steps)
    worst = max(rel_l2(a, b) for a, b in zip(runs["int8"][1], runs["bf16"][1]))
    prefill_same = torch.equal(runs["int8"][0], runs["bf16"][0])
    log(f"  [int8] full-width decode logits against the bf16 cache (teacher-forced, {NEW_TOKENS - 1} steps): "
        f"worst relative L2 {worst:.4f} (bound {INT8_REL_L2}); prefill logits equal {prefill_same}")
    n_spec = NEW_TOKENS // 2  # random weights accept ~nothing: a chunk a token, the host's pace
    spec = eng8.generate(prompts, n_spec, speculate=SpecConfig(SPEC_Q, SPEC_GAMMA))
    plain = eng8.generate(prompts, n_spec)
    spec_same = bool((spec.tokens == plain.tokens).all())
    serving = serving_engine(eng8, max(SERVE_PROMPT_LENS) + NEW_TOKENS + 8)
    reqs = serve_requests(cfg8, SERVE_PROMPT_LENS, NEW_TOKENS, 200)
    (sched, done, wall), _, counts, _ = run_counted(lambda: drive_continuous(
        serving, reqs, np.zeros(len(reqs)), n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK))
    by_rid = {c.rid: c.new_tokens for c in done}
    same = [bool(np.array_equal(by_rid[r.rid], serving.generate(r.prompt[None], r.max_new_tokens,
                                                                temperature=r.temperature, seed=r.seed)
                                .tokens[0, r.prompt.size:])) for r in reqs]
    greedy = [r.temperature == 0 for r in reqs]
    log(f"  [int8] greedy speculative == plain ({SpecConfig(SPEC_Q, SPEC_GAMMA)}): {spec_same}; slot == solo "
        f"through {SERVE_SLOTS} slots: greedy {sum(a for a, g in zip(same, greedy) if g)}/{sum(greedy)}, sampled "
        f"{sum(a for a, g in zip(same, greedy) if not g)}/{len(reqs) - sum(greedy)}; continuous {wall:.3f}s, "
        f"{len(reqs) * NEW_TOKENS / wall:.1f} tok/s")
    if not (worst < INT8_REL_L2 and prefill_same and spec_same and all(same)):
        raise SystemExit(f"chip_smoke: [int8] logits {worst:.4f} (bound {INT8_REL_L2}), prefill equal "
                         f"{prefill_same}, spec == plain {spec_same}, slot == solo {sum(same)}/{len(reqs)}")
    return dict(decode_rel_l2=worst, spec_equal=spec_same, slot_equal=sum(same), requests=len(reqs),
                continuous_tok_s=len(reqs) * NEW_TOKENS / wall), eng8


def admission_logits(engine, prompt, chunk=None):
    """One admission (whole-shot, or in ``chunk``-token pieces) into a fresh
    1-slot batch → its last-prompt logits and the pending admission."""
    slots = engine.init_slots(1)
    p = engine.begin_admission(prompt, max_new_tokens=1, chunked=chunk is not None)
    while not p.done:
        engine.advance_admission(p, chunk)
    engine.finish_admission(slots, 0, p)
    return slots["logits"][0].clone(), p


def int8_admissions(eng8):
    """Under int8 a warm or chunked admission attends dequantized rows where
    the cold whole-shot one attends fresh rows: a warm prefix-cache admission
    (phase 8's 512-token shared prompt) and the 8192-token request in 8
    chunks, each within 5% (relative L2) of its cold whole-shot admission."""
    from repro_torch.infer import PrefixCache
    from repro_torch.models.layers import LONG_SEQ_THRESHOLD

    cfg = eng8.cfg
    reqs = prefix_requests(cfg)[:2]
    cache = PrefixCache(block_tokens=PREFIX_BLOCK, max_bytes=PREFIX_CACHE_BYTES)
    warm_eng = serving_engine(eng8, max(r.prompt.size for r in reqs) + NEW_TOKENS + 8, prefix_cache=cache)
    cold, _ = admission_logits(warm_eng, reqs[0].prompt)  # a miss: commits the shared prompt's blocks
    cold2, _ = admission_logits(serving_engine(eng8, warm_eng.max_seq), reqs[1].prompt)
    warm, p = admission_logits(warm_eng, reqs[1].prompt)
    warm_rel = rel_l2(warm, cold2)
    (req,) = serve_requests(cfg, (LONG_SEQ_THRESHOLD,), LONG_NEW, 500)
    long_eng = serving_engine(eng8, LONG_SEQ_THRESHOLD + LONG_NEW)
    (whole, _), t_whole = timed(lambda: admission_logits(long_eng, req.prompt))
    (chunked, pc), t_chunked = timed(lambda: admission_logits(long_eng, req.prompt, LONG_CHUNK))
    long_rel = rel_l2(chunked, whole)
    log(f"  [int8] warm admission (hit {p.handle.length} of {reqs[1].prompt.size} tokens) against cold whole-shot: "
        f"relative L2 {warm_rel:.4f}; the {LONG_SEQ_THRESHOLD}-token prompt in {pc.prefill_chunks} chunks "
        f"({t_chunked:.3f}s) against whole-shot ({t_whole:.3f}s): {long_rel:.4f} (bound {INT8_REL_L2})")
    if not (p.handle.length >= PREFIX_LEN - PREFIX_BLOCK and warm_rel < INT8_REL_L2 and long_rel < INT8_REL_L2
            and pc.prefill_chunks == LONG_SEQ_THRESHOLD // LONG_CHUNK):
        raise SystemExit(f"chip_smoke: [int8] warm {warm_rel:.4f} (hit {p.handle.length}), chunked {long_rel:.4f} "
                         f"({pc.prefill_chunks} chunks)")
    return dict(warm_rel_l2=warm_rel, warm_hit=p.handle.length, long_rel_l2=long_rel, long_whole_s=t_whole,
                long_chunked_s=t_chunked)


def phase_graphs(engines, prompts, dry):
    """Phase 10 (module docstring) → summary."""
    from repro_torch.kernels import flash_attention

    out = {"paths": {}}
    for fmt, engine in engines.items():
        out["paths"][fmt] = graph_path(engine, prompts, fmt)
    out["paths"]["bcq on lutgemm"] = graph_path(engines["bcq"], prompts, "bcq on lutgemm", "lutgemm")
    out["continuous"] = graph_serving(engines["bcq"])
    out["int8_steps"] = int8_steps(engines["bcq"], dry)
    out["int8"], eng8 = int8_exactness(engines["bcq"], prompts)
    copies = flash_attention.copies
    out["int8"].update(int8_admissions(eng8))
    if flash_attention.copies != copies:
        raise SystemExit("chip_smoke: [int8] a dequantized K/V view did not reach K8 in place")
    return out


# -- phase 11: the serving session and observability --------------------------


def session_run(engine, reqs, *, observe, warm=False, cancel=None, profiler=None):
    """``reqs`` through a 4-slot ``ServeSession`` on ``engine``, in-process
    with asyncio and no sockets (the card's machine has no aiohttp); with
    ``observe`` the session's tracer is the engine's. ``warm``: a short
    request first, so the slot graph is captured before the window.
    ``cancel``: the index of a request cancelled at its first tokens.
    ``profiler``: started and stopped on the pump thread around the window →
    (session, [(tokens, terminal event)] in request order, the window's wall
    seconds, the tracer's events of the window)."""
    import asyncio

    from repro_torch.launch.server import ServeSession

    async def run():
        sess = ServeSession(engine, n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK, observe=observe,
                            tracer=engine.tracer if observe else None)
        async with sess:
            if warm:
                (first,) = serve_requests(engine.cfg, (16,), 2, 900)
                await (await sess.submit_stream(first)).drain()
            if profiler is not None:
                await sess.call_on_pump(profiler.start)
            mark = len(sess.tracer.events()) if observe else 0
            await sess.call_on_pump(torch.cuda.synchronize)
            t0 = time.perf_counter()
            streams = [await sess.submit_stream(dataclasses.replace(r, rid=None)) for r in reqs]
            first, ended = [], None
            if cancel is not None:
                async for ev in streams[cancel]:
                    if ev.kind == "tokens":
                        first = ev.tokens
                        break
                    ended = ev if ev.terminal else None
                streams[cancel].cancel("cancelled mid-flight by chip_smoke")
            results = await asyncio.gather(*(st.drain() for st in streams))
            if cancel is not None:
                toks, last = results[cancel]
                results[cancel] = (first + toks, ended or last)
            wall = time.perf_counter() - t0
            if profiler is not None:
                await sess.call_on_pump(profiler.stop)
            events = sess.tracer.events()[mark:] if observe else []
        return sess, results, wall, events

    return asyncio.run(asyncio.wait_for(run(), 600))


def check_streams(label, reqs, results, solo, skip=()):
    """Every stream (but ``skip``) finished with its solo ``generate``'s
    tokens, bit for bit → how many."""
    bad = [i for i, (r, (toks, last)) in enumerate(zip(reqs, results))
           if i not in skip and (last.kind != "done" or toks != solo[i])]
    if bad:
        raise SystemExit(f"chip_smoke: [session {label}] requests {bad} differ from phase 6's solo generate "
                         f"(or did not finish): {[results[i][1].to_json() for i in bad]}")
    return len(reqs) - len(skip)


def check_slot_graph(label, sess):
    """The session's decode chunks replayed its slot graph, captured on the
    pump thread."""
    graph = sess.sched.slots["graphs"][None]
    where = CAPTURE_THREADS.get(graph)
    if graph.graph is None or graph.replays == 0 or where != "repro-serve-pump":
        raise SystemExit(f"chip_smoke: [session {label}] slot graph captured {graph.graph is not None} on "
                         f"{where!r}, {graph.replays} replays")
    return graph.replays


def scope_device_times(path):
    """Per ``record_function`` range of a ``torch.profiler`` Chrome trace
    whose name starts with ``engine/``: {name: (count, host ms, device ms)},
    and the device ms no range claims. A device event (kernel, copy, set)
    belongs to the innermost range, on the launching thread, around the
    runtime call with its correlation id (for a graph replay, its
    ``cudaGraphLaunch``)."""
    events = json.loads(Path(path).read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges, launch, device = collections.defaultdict(list), {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, corr = ev.get("cat", ""), (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and ev["name"].startswith("engine/"):
            ranges[ev["tid"]].append((ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch[corr] = (ev["tid"], ev["ts"])
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((corr, ev["dur"]))
    out = {}
    for spans in ranges.values():
        for t0, t1, name in spans:
            c, host, dev = out.get(name, (0, 0.0, 0.0))
            out[name] = (c + 1, host + (t1 - t0) / 1e3, dev)
    unclaimed = 0.0
    for corr, dur in device:
        tid, ts = launch.get(corr, (None, None))
        inside = [(t0, name) for t0, t1, name in ranges.get(tid, ()) if t0 <= ts <= t1] if tid is not None else []
        if not inside:
            unclaimed += dur / 1e3
            continue
        name = max(inside)[1]  # the innermost: the latest start
        c, host, dev = out[name]
        out[name] = (c, host, dev + dur / 1e3)
    return out, unclaimed


def phase_session(bcq_engine, solos):
    """Phase 11 (module docstring): phase 6's 12 requests through the async
    serving session, observed and not, cancelled mid-flight, profiled, and
    timed observed against unobserved → summary."""
    import numpy as np

    from repro_torch.kernels import launch_counts, qmatmul
    from repro_torch.obs import Tracer, parse_prometheus, validate_chrome_trace
    from repro_torch.obs.metrics import counters_agree
    from repro_torch.obs.trace import request_lifecycles

    cfg = bcq_engine.cfg
    L, n = cfg.n_layers, len(SERVE_PROMPT_LENS)
    # phase 6's cache length: a decode row's sums run over all max_seq rows,
    # so the solo tokens hold at this length (the cancelled request's 4x
    # budget fits in it: 200 + 64 rows)
    max_seq = max(SERVE_PROMPT_LENS) + NEW_TOKENS + 8
    reqs = serve_requests(cfg, SERVE_PROMPT_LENS, NEW_TOKENS, 200)  # phase 6's
    solo = [o.tokens[0, r.prompt.size:].tolist() for r, o in zip(reqs, solos)]

    def engine(observe):
        """A fresh engine on the bcq weights (no copy): each session makes
        its slot state and captures its slot graph."""
        return serving_engine(bcq_engine, max_seq, tracer=Tracer() if observe else None)

    out = {}
    for name, observe in (("observed", True), ("unobserved", False)):
        eng = engine(observe)
        (sess, results, wall, events), _, counts, ref_calls = run_counted(
            lambda: session_run(eng, reqs, observe=observe))
        same = check_streams(name, reqs, results, solo)
        replays = check_slot_graph(name, sess)
        expect = expect_forward_counts(counts, sess.sched.decode_steps, [r.prompt.size for r in reqs], L)
        if counts != expect or ref_calls:
            raise SystemExit(f"chip_smoke: [session {name}] launches {counts} != expected {expect}, or the ref "
                             f"oracle took {ref_calls} dispatches")
        out[name] = dict(wall_s=wall, tok_s=n * NEW_TOKENS / wall, equal_to_solo=same, replays=replays,
                         decode_steps=sess.sched.decode_steps, launches=counts,
                         ttft_s=sess.sched.summary()["ttft_s"])
        log(f"  [session {name}] {n} requests, {SERVE_SLOTS} slots, chunk {SERVE_CHUNK}: streams == phase 6's solo "
            f"generate {same}/{n} (temperatures 0, 1.0, 0.7); slot graph captured on the pump thread, {replays} "
            f"replays; launches as expected {json.dumps(counts)}; {wall:.3f}s, {n * NEW_TOKENS / wall:.1f} tok/s")
        if not observe:
            continue
        trace = sess.trace_json()
        problems = validate_chrome_trace(trace)
        lanes = request_lifecycles(trace)
        missing = [last.rid for _, last in results if f"req:{last.rid}" not in lanes]
        disagree = counters_agree(sess.registry, sess.sched.counters)
        samples = parse_prometheus(sess.prometheus())
        census = {ls["kernel"]: v for ls, v in samples["kernel_launches_total"]}
        ref_scraped = samples["qmatmul_ref_calls_total"][0][1]
        scopes = sorted({e[1] for e in events if e[3] == "engine"})
        log(f"  [session observed] trace: {trace['otherData']['buffered']} events, {len(problems)} problems, "
            f"{len(lanes)} request lanes ({len(missing)} missing); counters_agree: {disagree or 'empty'}; "
            f"Prometheus kernel_launches_total {json.dumps(census)} (census {json.dumps(launch_counts())}); "
            f"engine scopes {scopes}")
        if problems or missing or disagree or census != launch_counts() or ref_scraped != qmatmul.ref_calls:
            raise SystemExit(f"chip_smoke: [session observed] trace problems {problems[:3]}, lanes missing "
                             f"{missing}, counters {disagree}, scrape {census} vs census {launch_counts()}")
        out[name].update(trace_events=trace["otherData"]["buffered"], scopes=scopes,
                         scraped_launches=census)

    # one request cancelled at its first streamed tokens (its budget 4x, so
    # the cancel lands mid-flight); the survivors are exact
    creqs = list(reqs)
    creqs[SESSION_CANCEL] = dataclasses.replace(reqs[SESSION_CANCEL], max_new_tokens=4 * NEW_TOKENS)
    if creqs[SESSION_CANCEL].prompt.size + 4 * NEW_TOKENS > max_seq:
        raise SystemExit(f"chip_smoke: [session cancel] request {SESSION_CANCEL}'s 4x budget does not fit max_seq")
    sess, results, wall, _ = session_run(engine(True), creqs, observe=True, cancel=SESSION_CANCEL)
    toks, last = results[SESSION_CANCEL]
    same = check_streams("cancel", reqs, results, solo, skip=(SESSION_CANCEL,))
    log(f"  [session cancel] request {SESSION_CANCEL} cancelled after {len(toks)} streamed tokens "
        f"({last.kind}, {last.status}); survivors == solo generate {same}/{n - 1}")
    if last.status != "cancelled" or sess.sched.counters["cancelled"] != 1:
        raise SystemExit(f"chip_smoke: [session cancel] the cancelled request ended {last.to_json()}")
    out["cancel"] = dict(streamed_before_cancel=len(toks), survivors_equal=same)

    # the profile: a warmed session (its slot graph captured before the
    # profiler starts), the profiler started and stopped on the pump thread
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass  # the profiler initialises on this thread, before it starts on the pump
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    preqs = [dataclasses.replace(r, max_new_tokens=PROFILED_NEW) for r in reqs[:SESSION_PROFILED]]
    sess, results, wall, events = session_run(engine(True), preqs, observe=True, warm=True, profiler=prof)
    check_streams("profiled", preqs, results, [t[:PROFILED_NEW] for t in solo])
    path = ROOT / "chiprun_out" / "serve_profile.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    by_scope, unclaimed = scope_device_times(path)
    entered = {e[1] for e in events if e[3] == "engine"}
    log(f"  [session profile] {len(preqs)} requests ({[r.prompt.size for r in preqs]} prompt tokens, "
        f"{PROFILED_NEW} new each) after a warm-up, {wall:.3f}s; {path.name} "
        f"{path.stat().st_size / 1e6:.1f} MB; per engine scope (count, host ms, device ms):")
    for name, (c, host, dev) in sorted(by_scope.items()):
        log(f"    {name:24s} {c:5d} {host:10.2f} {dev:10.2f}")
    log(f"    device ms claimed by no engine scope: {unclaimed:.2f}")
    if not entered or entered - set(by_scope):
        raise SystemExit(f"chip_smoke: [session profile] scopes entered {sorted(entered)}, in the profile "
                         f"{sorted(by_scope)}")
    out["profile"] = dict(wall_s=wall, requests=len(preqs), file_mb=path.stat().st_size / 1e6,
                          scopes={k: dict(count=c, host_ms=h, device_ms=d) for k, (c, h, d) in by_scope.items()},
                          unclaimed_device_ms=unclaimed)

    # overhead: observed against unobserved, warmed, alternating; printed, not bounded
    tok_s = {True: [], False: []}
    for _ in range(SESSION_OVERHEAD_RUNS):
        for observe in (True, False):
            _, results, wall, _ = session_run(engine(observe), reqs, observe=observe, warm=True)
            check_streams("overhead", reqs, results, solo)
            tok_s[observe].append(n * NEW_TOKENS / wall)
    med = {k: statistics.median(v) for k, v in tok_s.items()}
    log(f"  [session overhead] tok/s observed {[round(v, 1) for v in tok_s[True]]} (median {med[True]:.1f}) "
        f"against unobserved {[round(v, 1) for v in tok_s[False]]} (median {med[False]:.1f}): "
        f"{med[True] / med[False]:.3f}x")
    out["overhead"] = dict(observed_tok_s=tok_s[True], unobserved_tok_s=tok_s[False],
                           ratio=med[True] / med[False])
    return out


# -- phase 12: the hybrid family (recurrentgemma-9b) ---------------------------

HYBRID = "recurrentgemma-9b"
K9 = ("rglru_scan", "csrc/rglru_scan.cu", "src/repro/models/recurrent.py:83")
K9_SHAPES = ((1, 3000), (4, 1), (64, 1), (4, 20))  # (B, S): a long prompt, decode steps, a verify
HYBRID_NEW = 32  # the batched generate's and the long request's new tokens
HYBRID_LONG = 3000  # past the 2048-row ring: it wraps inside the prefill
HYBRID_FORCED = 8  # teacher-forced decode steps held to the ref path
HYBRID_SLOT_LENS, HYBRID_SLOT_NEW = (16, 2600, 100, 700, 40, 1500, 300, 64), 16
HYBRID_SPEC, HYBRID_SPEC_LEN, HYBRID_SPEC_NEW = (2, 4), 2100, 12  # prompts that wrap the ring
HYBRID_PREFIX_TAILS, HYBRID_BYPASS = (16, 64, 23, 40, 31, 57), 2200
HYBRID_INT8_LENS = (16, 300, 2100, 64)
HYBRID_FORMAT_LAYERS = 5  # one (rglru, rglru, local_attn) pattern and the (rglru, rglru) remainder
# the long prompt, slots, speculation, prefix cache and int8 runs: 4 of the 12 (rglru, rglru, local_attn) patterns
# and the (rglru, rglru) remainder (the smoke's time budget)
HYBRID_SIDE_LAYERS = 14


def hybrid_leaves(cfg):
    """{(k, o): (leaf, fused out_dims)} of the hybrid model's packed linears;
    the five RG-LRU linears and ``wo`` share (d, d) when lru_width == d."""
    d, qd, kv, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    return {(d, qd + 2 * kv): ("wqkv", (qd, kv, kv)), (qd, d): ("wo/w_x/w_y/w_a/w_i/w_out", None),
            (d, 2 * f): ("w_gate_up", (f, f)), (f, d): ("w_down", None), (d, cfg.vocab): ("lm_head", None)}


def check_rglru(gen, W):
    """K9 against its plain loop, bit for bit, at ``K9_SHAPES`` (B, S) and
    width W; kernel and plain times by graph replay (median of 7) beside the
    byte bound, 3·B·S·W f32 values plus h0 and h_last → records."""
    from repro_torch.kernels import rglru_scan, rglru_scan_plain
    from repro_torch.kernels.rglru_scan import plan

    pl, recs = plan(W), []
    for B, S in K9_SHAPES:
        a = torch.rand((B, S, W), generator=gen, device=DEVICE) * 0.2 + 0.8
        g = torch.randn((B, S, W), generator=gen, device=DEVICE) * 0.1
        h0 = torch.randn((B, W), generator=gen, device=DEVICE)
        hs, last = rglru_scan(a, g, h0)
        phs, plast = rglru_scan_plain(a, g, h0)
        again = rglru_scan(a, g, h0)
        same = bool(torch.equal(hs, phs) and torch.equal(last, plast))
        rerun = bool(torch.equal(again[0], hs) and torch.equal(again[1], last))
        ms = time_ms(rglru_scan, [(a, g, h0)])
        plain_ms = time_ms(rglru_scan_plain, [(a, g, h0)], inner=1 if S > 64 else None, reps=3 if S > 64 else 7)
        nbytes = (3 * B * S * W + 2 * B * W) * 4
        path, blocks = pl.path(S), pl.blocks(B, S)
        recs.append(dict(B=B, S=S, W=W, equal=same, same_bits=rerun, max_abs_err=(hs - phs).abs().max().item(),
                         ms=ms, plain_ms=plain_ms, bound_ms=nbytes / MEM_BYTES_PER_S * 1e3, bytes=nbytes,
                         path=path, blocks=blocks))
        r = recs[-1]
        log(f"  [K9 rglru_scan] B={B} S={S} W={W} ({path} kernel, {blocks} blocks): bit for bit {same}, rerun "
            f"{rerun}; {ms * 1e3:.2f} us "
            f"(plain {plain_ms * 1e3:.1f} us, {plain_ms / ms:.1f}x), bound {r['bound_ms'] * 1e3:.2f} us "
            f"(bytes, {nbytes / 1e6:.1f} MB at 3.35 TB/s): {ms / r['bound_ms']:.2f}x the bound")
    if not all(r["equal"] and r["same_bits"] for r in recs):
        raise SystemExit(f"chip_smoke: [hybrid] K9 differs from its plain version: {recs}")
    return recs


def hybrid_main(engine, prompts):
    """The phase's main path: a batched ``generate`` in a counted window, the
    census held to the model's blocks, then captured against eager → summary."""
    from repro_torch.kernels import ternary_mm

    cfg, L = engine.cfg, engine.cfg.n_layers
    counts_of = cfg.block_counts()
    n_rglru, n_local = counts_of["rglru"], counts_of["local_attn"]
    engine.generate(prompts, 2)  # the graph's warm-up and capture
    res, dt, counts, ref_calls = run_counted(lambda: engine.generate(prompts, HYBRID_NEW))
    forwards = 1 + HYBRID_NEW
    expect = dict.fromkeys(counts, 0)
    expect["bcq_mm"] = forwards * (5 * n_rglru + n_local + L + 1)  # RG-LRU linears, wo, w_down, lm_head
    expect["bcq_mm_fused"] = forwards * (n_local + L)  # wqkv, w_gate_up
    expect["rglru_scan"] = forwards * n_rglru
    log(f"  [hybrid] main path: generate batched ({len(prompts)}x{prompts.shape[1]} + {HYBRID_NEW}, replayed "
        f"graph) {dt:.3f}s, {len(prompts) * HYBRID_NEW / dt:.1f} tok/s; launches {json.dumps(counts)} "
        f"(expected {json.dumps(expect)}), ref-oracle dispatches {ref_calls}; K8 {counts['flash_attention']}")
    if counts != expect or ref_calls or ternary_mm.tc_launches:
        raise SystemExit(f"chip_smoke: [hybrid] main path launches {counts} != {expect} (ref {ref_calls})")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise SystemExit("chip_smoke: [hybrid] bad generated tokens")
    graph_l = decode_loop(engine, prompts, True, HYBRID_NEW)()
    eager_l = decode_loop(engine, prompts, False, HYBRID_NEW)()
    runs = {name: run_counted(lambda s=scan: engine.generate(prompts, HYBRID_NEW, temperature=0.8, seed=7, scan=s))
            for name, scan in (("eager", False), ("graph", True))}
    same = dict(logits=bool(torch.equal(graph_l, eager_l)),
                tokens=bool((runs["graph"][0].tokens == runs["eager"][0].tokens).all()),
                census=runs["graph"][2] == runs["eager"][2])
    graph = engine._graphs[(len(prompts), None)]
    nodes = {k: v for k, v in GRAPH_NODES[graph].items() if v}
    tok_s = {name: len(prompts) * HYBRID_NEW / runs[name][1] for name in runs}
    loop = {"graph": lambda: engine.generate(prompts, HYBRID_NEW), "eager":
            lambda: engine.generate(prompts, HYBRID_NEW, scan=False)}
    prof = {}
    for name, run in loop.items():
        _, wall, _, _ = run_counted(run)
        device_ms, _, by_name = device_profile(run)
        groups = collections.Counter()
        for k, v in by_name.items():
            groups["K1/K2" if "BCQGroups" in k else "K9" if "rglru_scan" in k else "other"] += v
        prof[name] = dict(wall_s=wall, device_ms=device_ms, busy=device_ms / (wall * 1e3),
                          by_part={k: round(v, 3) for k, v in groups.items()})
    step_ms = prof["graph"]["device_ms"] / forwards
    log(f"  [hybrid] captured against eager ({HYBRID_NEW} steps at B = {len(prompts)}): logits equal "
        f"{same['logits']}, sampled tokens equal {same['tokens']}, census equal {same['census']}; tok/s eager "
        f"{tok_s['eager']:.1f}, graph {tok_s['graph']:.1f}; the graph's kernel nodes {nodes} (its capture's counts), "
        f"pool {POOL_BYTES[graph] / 1e6:.1f} MB; device busy: graph {prof['graph']['device_ms']:.2f} ms "
        f"({prof['graph']['busy']:.1%}, by part {prof['graph']['by_part']}), eager {prof['eager']['device_ms']:.2f} "
        f"ms ({prof['eager']['busy']:.1%}); ~{step_ms:.3f} device ms a forward")
    if not all(same.values()):
        raise SystemExit(f"chip_smoke: [hybrid] the replayed graph differs from the eager loop: {same}")
    return counts, dict(wall_s=dt, tok_s=tok_s, same=same, nodes=nodes, pool_bytes=POOL_BYTES[graph],
                        profile=prof, device_ms_per_forward=step_ms)


def hybrid_long(engine, rng):
    """A ``HYBRID_LONG``-token prompt (the ring wraps inside the prefill) and
    ``HYBRID_NEW`` new tokens: prefill time, decode tok/s, peak memory above
    the weights; ``HYBRID_FORCED`` teacher-forced steps against the ref path
    within ``LOGITS_REL_TOL``; K8 never launched."""
    from repro_torch.kernels import launch_counts

    prompt = rng.integers(0, engine.cfg.vocab, HYBRID_LONG).astype(np.int32)
    tokens = torch.as_tensor(prompt[None], device=DEVICE).long()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with flash_census() as attn:
        (_, _), prefill_s, _, _ = run_counted(lambda: engine.prefill(tokens, engine._make_cache(1)))
        res, wall, counts, ref_calls = run_counted(lambda: engine.generate(prompt[None], HYBRID_NEW))
    peak = torch.cuda.max_memory_allocated() - base
    decode_s = wall - prefill_s
    log(f"  [hybrid long] {HYBRID_LONG}-token prompt + {HYBRID_NEW}: prefill {prefill_s:.3f}s, generate "
        f"{wall:.3f}s (decode ~{HYBRID_NEW / decode_s:.1f} tok/s at B = 1), peak {peak / 1e9:.3f} GB above the "
        f"resident {base / 1e9:.3f} GB; K8 launches {counts['flash_attention']} (census {sum(attn.values())}), "
        f"K9 {counts['rglru_scan']}, ref-oracle dispatches {ref_calls}")
    if attn or counts["flash_attention"] or ref_calls:
        raise SystemExit(f"chip_smoke: [hybrid long] K8 {dict(attn)}, ref {ref_calls}")
    forced = res.tokens[0, HYBRID_LONG : HYBRID_LONG + HYBRID_FORCED]
    dist = hybrid_logits_check(engine, f"hybrid long, {HYBRID_FORCED} forced steps",
                               lambda eng, mode: forced_logits(eng, prompt, forced, mode))
    return dict(prefill_s=prefill_s, wall_s=wall, decode_tok_s=HYBRID_NEW / decode_s, peak_gb=peak / 1e9,
                resident_gb=base / 1e9, logits=dist, k8=counts["flash_attention"])


def logits_distances(engine, run, mode=None):
    """``run(engine, mode)`` → logits under ``impl_mode(mode)``; the kernel
    path's and the ref path's logits, and the same packed weights in an
    f32-compute engine: its ref path (every weight dequantized to f32) is the
    oracle, its kernel path the f32-compute kernel path → {distances, each
    max|d| / max|.|; top-1 agreement of the bf16 paths}."""
    from repro_torch.infer import Engine

    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()  # noqa: E731
    k, r = run(engine, mode), run(engine, "ref")
    eng32 = Engine(dataclasses.replace(engine.cfg, compute_dtype="float32"), engine.params, max_seq=engine.max_seq,
                   fuse=False, device="cuda")
    oracle, k32 = run(eng32, "ref"), run(eng32, mode)
    del eng32
    return dict(kernel_ref=rel(k, r), kernel_oracle=rel(k, oracle), ref_oracle=rel(r, oracle),
                kernel_oracle_f32=rel(k32, oracle), top1_kernel_ref=(k.argmax(-1) == r.argmax(-1)).float().mean().item(),
                finite=bool(torch.isfinite(k).all()))


def log_logits(label, d, ok, gate):
    log(f"  [{label}] logits, max|d| / max|.|: bf16 kernel vs bf16 ref {d['kernel_ref']:.3e} (top-1 agreement "
        f"{d['top1_kernel_ref']:.3f}); against the f32-weight oracle: bf16 kernel {d['kernel_oracle']:.3e}, bf16 ref "
        f"{d['ref_oracle']:.3e}, f32-compute kernel {d['kernel_oracle_f32']:.3e} (tol {LOGITS_REL_TOL:g}; gate: "
        f"{gate}): {'ok' if ok else 'FAIL'}")
    if not (ok and d["finite"]):
        raise SystemExit(f"chip_smoke: [{label}] logits against the ref path and the f32-weight oracle: {d}")


def hybrid_logits_check(engine, label, run, mode=None):
    """The hybrid's logits against the ref path (:func:`logits_distances`).
    Two bf16 paths of this model sit ~5% of max|logit| apart at any prompt
    length, each 4-7% from the f32-weight oracle on an H100
    (``tools/hybrid_logits_probe.py``), so the comparison is adjudicated as
    the llama watch item is (ROADMAP Queue 3): the f32-compute kernel path
    must be within ``LOGITS_REL_TOL`` of the oracle, and the bf16 kernel
    path within it of the bf16 ref path, or of the oracle, or no farther
    from the oracle than the bf16 ref path is → {distances}."""
    d = logits_distances(engine, run, mode)
    ok = d["kernel_oracle_f32"] <= LOGITS_REL_TOL and (
        d["kernel_ref"] <= LOGITS_REL_TOL or d["kernel_oracle"] <= max(LOGITS_REL_TOL, d["ref_oracle"]))
    log_logits(label, d, ok, "f32-compute kernel vs oracle, and bf16 kernel vs bf16 ref or oracle")
    return d


def xlstm_logits_check(engine, label, run, mode=None):
    """xlstm-125m's logits gate is the f32-compute arm alone: the
    f32-compute kernel path within ``LOGITS_REL_TOL`` of the f32-weight
    oracle (:func:`logits_distances`). Its two bf16 paths each sit 4-7% of
    max|logit| from the oracle, and which of them is nearer varies with the
    format (on an H100 uniform's bf16 kernel path was 5.96e-2 from it and its
    bf16 ref path 5.74e-2), so the bf16 distances are reported, not gated;
    the bf16 kernels themselves are held to their plain versions shape by
    shape (:func:`check_launched`) → {distances}."""
    d = logits_distances(engine, run, mode)
    log_logits(label, d, d["kernel_oracle_f32"] <= LOGITS_REL_TOL, "f32-compute kernel vs oracle; bf16 reported")
    return d


def hybrid_requests(cfg, lens, new, seed):
    from repro_torch.infer import Request

    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32), max_new_tokens=new,
                    temperature=[0.0, 1.0, 0.7][i % 3], seed=seed + i, rid=i) for i, n in enumerate(lens)]


def hybrid_serve(engine, reqs, n_slots, **kw):
    from repro_torch.infer import Scheduler

    sched = Scheduler(engine, n_slots=n_slots, chunk=SERVE_CHUNK, **kw)
    for r in reqs:
        sched.submit(dataclasses.replace(r))
    return {c.rid: c.new_tokens.tolist() for c in sched.run()}


def hybrid_solo(engine, reqs):
    return {r.rid: engine.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature,
                                   seed=r.seed).tokens[0, r.prompt.size :].tolist() for r in reqs}


def hybrid_slots_and_spec(engine, rng):
    """Slots: ``HYBRID_SLOT_LENS`` requests on 4 slots == solo; speculation
    ``SpecConfig(2, 4)`` greedy == plain on prompts that wrap the ring."""
    from repro_torch.infer import SpecConfig

    reqs = hybrid_requests(engine.cfg, HYBRID_SLOT_LENS, HYBRID_SLOT_NEW, 300)
    t0 = synced_clock()
    solo = hybrid_solo(engine, reqs)
    t1 = synced_clock()
    got = hybrid_serve(engine, reqs, SERVE_SLOTS)
    t2 = synced_clock()
    equal = sum(got[r.rid] == solo[r.rid] for r in reqs)
    n_tok = len(reqs) * HYBRID_SLOT_NEW
    log(f"  [hybrid slots] {len(reqs)} requests (prompts {list(HYBRID_SLOT_LENS)}, {HYBRID_SLOT_NEW} new, "
        f"temperatures 0, 1.0, 0.7) on {SERVE_SLOTS} slots: == solo generate {equal}/{len(reqs)}; "
        f"{n_tok / (t2 - t1):.1f} tok/s continuous, {n_tok / (t1 - t0):.1f} one at a time")
    if equal != len(reqs):
        raise SystemExit("chip_smoke: [hybrid] a slot's tokens differ from its solo generate")
    prompts = rng.integers(0, engine.cfg.vocab, (2, HYBRID_SPEC_LEN))
    spec_cfg = SpecConfig(*HYBRID_SPEC)
    plain, plain_s, _, _ = run_counted(lambda: engine.generate(prompts, HYBRID_SPEC_NEW))
    spec, spec_s, counts, _ = run_counted(lambda: engine.generate(prompts, HYBRID_SPEC_NEW, speculate=spec_cfg))
    same = bool((spec.tokens == plain.tokens).all())
    st = spec.spec_stats
    log(f"  [hybrid spec] SpecConfig{HYBRID_SPEC} on 2 prompts of {HYBRID_SPEC_LEN} tokens (past the ring) + "
        f"{HYBRID_SPEC_NEW}: greedy == plain {same}; acceptance {st['accept_rate']:.3f} ({st['accepted']}/"
        f"{st['proposed']}, {st['chunks']} chunks); {spec_s:.3f}s (plain {plain_s:.3f}s); K9 {counts['rglru_scan']}")
    if not same:
        raise SystemExit("chip_smoke: [hybrid spec] speculative greedy differs from plain greedy")
    return dict(slots_equal=equal, slot_tok_s=n_tok / (t2 - t1), solo_tok_s=n_tok / (t1 - t0), spec_equal=same,
                spec_stats=st, spec_s=spec_s, plain_s=plain_s)


def hybrid_prefix(engine, rng):
    """A wave of requests sharing a 512-token prompt, cold then warm, against
    one prefix cache: tokens and last-prompt logits equal bit for bit, every
    warm request a hit; a ``HYBRID_BYPASS``-token prompt neither matches nor
    commits."""
    from repro_torch.infer import PrefixCache

    cfg = engine.cfg
    pc = PrefixCache(block_tokens=PREFIX_BLOCK, max_bytes=PREFIX_CACHE_BYTES * 4)
    eng = serving_engine(engine, engine.max_seq, prefix_cache=pc)
    shared = rng.integers(0, cfg.vocab, PREFIX_LEN)
    reqs = hybrid_requests(cfg, HYBRID_PREFIX_TAILS, HYBRID_SLOT_NEW, 400)
    for r in reqs:
        r.prompt = np.concatenate([shared, r.prompt]).astype(np.int32)
    waves, logits, walls = [], [], []
    for _ in range(2):
        seen = record_admissions(eng)
        t0 = synced_clock()
        waves.append(hybrid_serve(eng, reqs, SERVE_SLOTS))
        walls.append(synced_clock() - t0)
        del eng.finish_admission
        logits.append(seen)
    hits_warm = pc.counters["hits"]
    same_tokens = waves[0] == waves[1]
    same_logits = all(torch.equal(logits[0][k], logits[1][k]) for k in logits[0])
    long = rng.integers(0, cfg.vocab, HYBRID_BYPASS).astype(np.int32)
    before = (pc.counters["commits"], len(pc._nodes))
    bypass = []
    for _ in range(2):
        slots = eng.init_slots(1)
        eng.admit_slot(slots, 0, long, max_new_tokens=4)
        h = eng.take_prefix_handle()
        bypass.append((h.length, len(h.new_spans)))
    nodes_ok = len(pc._nodes) == before[1] and all(n.end <= eng._ring_rows for n in pc._nodes)
    log(f"  [hybrid prefix] {len(reqs)} requests sharing {PREFIX_LEN} tokens (+ tails {list(HYBRID_PREFIX_TAILS)}), "
        f"cold {walls[0]:.3f}s then warm {walls[1]:.3f}s: tokens equal {same_tokens}, last-prompt logits equal "
        f"{same_logits}; hits {pc.counters['hits']}, misses {pc.counters['misses']}, commits "
        f"{pc.counters['commits']}, {len(pc._nodes)} blocks with their recurrent snapshots; the {HYBRID_BYPASS}-"
        f"token prompt (hit, new blocks) {bypass}, trie unchanged {nodes_ok}")
    if not (same_tokens and same_logits and hits_warm >= len(reqs) and all(b == (0, 0) for b in bypass)
            and nodes_ok and pc.pinned == 0):
        raise SystemExit("chip_smoke: [hybrid prefix] warm != cold, or the wrapped prompt used the cache")
    return dict(cold_s=walls[0], warm_s=walls[1], counters=dict(pc.counters), blocks=len(pc._nodes))


def hybrid_int8(engine, rng):
    """The int8 ring cache on the same weights: forced decode logits within
    ``INT8_REL_L2`` of the bf16 cache's on a prompt that wraps the ring, and
    slot == solo bit for bit."""
    from repro_torch.infer import Engine

    cfg8 = dataclasses.replace(engine.cfg, kv_cache_dtype="int8")
    eng8 = Engine(cfg8, engine.params, max_seq=engine.max_seq, fuse=False, device="cuda")
    prompt = rng.integers(0, engine.cfg.vocab, HYBRID_SPEC_LEN).astype(np.int32)
    forced = engine.generate(prompt[None], HYBRID_FORCED).tokens[0, HYBRID_SPEC_LEN:]
    want = forced_logits(engine, prompt, forced, None)
    got = forced_logits(eng8, prompt, forced, None)
    rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    reqs = hybrid_requests(engine.cfg, HYBRID_INT8_LENS, HYBRID_SLOT_NEW, 500)
    solo = hybrid_solo(eng8, reqs)
    got_slots = hybrid_serve(eng8, reqs, 2)
    equal = sum(got_slots[r.rid] == solo[r.rid] for r in reqs)
    log(f"  [hybrid int8] forced decode logits vs the bf16 cache's: relative L2 {rel:.4f} (bound {INT8_REL_L2}); "
        f"slot == solo {equal}/{len(reqs)} (prompts {list(HYBRID_INT8_LENS)} on 2 slots)")
    if not (rel < INT8_REL_L2 and equal == len(reqs)):
        raise SystemExit(f"chip_smoke: [hybrid int8] relative L2 {rel:.4f}, slot == solo {equal}/{len(reqs)}")
    return dict(rel_l2=rel, slots_equal=equal)


def hybrid_formats(cfg, prompts):
    """The other formats (and bcq on the paper's LUT kernel) at full width and
    ``HYBRID_FORMAT_LAYERS`` layers: one batched ``generate`` each, launches
    counted, logits against the ref path within ``LOGITS_REL_TOL``."""
    from repro_torch.kernels import impl_mode
    from repro_torch.models import init_params

    cfg5 = dataclasses.replace(cfg, n_layers=HYBRID_FORMAT_LAYERS, stages=None)
    params = init_params(cfg5, seed=1, device="cuda")
    blocks = cfg5.block_counts()
    per_forward = 7 * blocks["rglru"] + 4 * blocks["local_attn"] + 1
    out = {}
    for fmt, mode in (("uniform", None), ("ternary", None), ("codebook", None), ("dequant", None),
                      ("bcq", "lutgemm")):
        engine = quantized_engine(cfg5, params, fmt)
        kernel = mode or FORMAT_KERNEL[fmt]
        with impl_mode(mode):
            engine.generate(prompts, 2)
            res, dt, counts, ref_calls = run_counted(lambda: engine.generate(prompts, NEW_TOKENS))
        want = (1 + NEW_TOKENS) * per_forward
        rel = hybrid_logits_check(engine, f"hybrid {fmt}{' on ' + mode if mode else ''}, prefill + 1 step",
                                  lambda eng, m: step_logits(eng, prompts, m), mode)
        log(f"  [hybrid {fmt}{' on ' + mode if mode else ''}] generate batched, {HYBRID_FORMAT_LAYERS} layers: "
            f"{dt:.3f}s; {kernel} {counts[kernel]} launches (expected {want}), K9 {counts['rglru_scan']}, "
            f"ref-oracle dispatches {ref_calls}")
        if counts[kernel] != want or ref_calls or counts["rglru_scan"] != (1 + NEW_TOKENS) * blocks["rglru"]:
            raise SystemExit(f"chip_smoke: [hybrid {fmt}] launches {counts}, expected {want} of {kernel}")
        out[fmt + ("_" + mode if mode else "")] = dict(wall_s=dt, logits=rel, launches=counts[kernel])
        del engine
    return out


def phase_hybrid(gen, records):
    """Phase 12 (module docstring) → (summary, K9 records, the main path's counts)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant import quantized_bytes

    cfg = get_config(HYBRID)
    k9 = check_rglru(gen, cfg.lru_width)
    log(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (Dh {cfg.d_head}), "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, window {cfg.window}, lru_width {cfg.lru_width}, layers "
        f"{cfg.n_layers} {cfg.block_counts()}, {cfg.param_dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.1f}s ({quantized_bytes(params) / 1e9:.3f} GB dense)")
    engine = quantized_engine(cfg, params, "bcq", HYBRID_LONG + HYBRID_NEW + 8)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, cfg.vocab, (PROMPTS, PROMPT_LEN))
    summary, walls = {}, {}
    side = depth_view(engine, HYBRID_SIDE_LAYERS)
    with kernel_census(by_leaf=True) as seen:
        t = time.perf_counter()
        counts, summary["main"] = hybrid_main(engine, prompts)
        walls["main"] = time.perf_counter() - t
        for name, fn in (("long", hybrid_long), ("slots_spec", hybrid_slots_and_spec), ("prefix", hybrid_prefix),
                         ("int8", hybrid_int8)):
            t = time.perf_counter()
            summary[name] = fn(side, rng)
            walls[name] = time.perf_counter() - t
    del side
    summary["checked"] = len(check_launched("hybrid", seen, None, records, gen, hybrid_leaves(cfg)))
    del engine
    torch.cuda.empty_cache()
    t = time.perf_counter()
    summary["formats"] = hybrid_formats(cfg, prompts)
    walls["formats"] = time.perf_counter() - t
    summary["walls"] = walls
    log(f"  [hybrid] phase wall by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return summary, k9, counts


# -- phase 13: the ssm family (xlstm-125m) -------------------------------------

XLSTM = "xlstm-125m"
K10 = ("mlstm_scan", "csrc/mlstm_scan.cu", "src/repro/models/recurrent.py:293")
K11 = ("slstm_scan", "csrc/slstm_scan.cu", "src/repro/models/recurrent.py:383")
XLSTM_SCAN_SHAPES = ((4, 1), (4, 5), (1, 3000), (64, 1))  # (B, S): decode steps, a verify, a long prompt, many rows
XLSTM_NEW = 32  # the batched generate's and the long request's new tokens
XLSTM_LONG = 3000
XLSTM_FORCED = 8  # teacher-forced decode steps held to the ref path
XLSTM_SLOT_LENS, XLSTM_SLOT_NEW = (16, 2600, 100, 700, 40, 1500, 300, 64), 16
XLSTM_SPEC = (2, 4)
# speculative runs' new tokens: the first from the prefill, then six chunks of γ + 1 and two tokens, so
# the run ends inside a chunk (a draft equal to the target must show accepted == committable)
XLSTM_SPEC_NEW = 1 + 6 * (XLSTM_SPEC[1] + 1) + 2
XLSTM_PREFIX_TAILS = (16, 64, 23, 40, 31, 57)
XLSTM_PREFIX_BYTES = 2 << 30  # ~14.2 MB of mLSTM state a block boundary: 32 blocks of the shared prompt and the tails'


def xlstm_leaves(cfg):
    """{(k, o): (leaf, None)} of xlstm-125m's packed linears."""
    from repro_torch.models.recurrent import mlstm_dims

    d, inner = cfg.d_model, mlstm_dims(cfg)[0]
    return {(d, inner): ("w_up/w_z", None), (inner, inner): ("wq/wk/wv", None), (inner, d): ("w_down", None),
            (d, d): ("slstm w_z/w_i/w_f/w_o/w_out", None), (d, cfg.vocab): ("lm_head", None)}


def xlstm_forward_counts(cfg):
    """Launches of one forward: every packed leaf once (6 + 5 a cell pair,
    the LM head once), K10 and K11 once a layer of their cell."""
    n = cfg.block_counts()
    return {"linears": 6 * n["mlstm"] + 5 * n["slstm"] + 1, "mlstm_scan": n["mlstm"], "slstm_scan": n["slstm"]}


def _scan_record(name, B, S, width, equal, same, steps_equal, err, ms, plain_ms, nbytes, ops, *, blocks,
                 instr=None):
    """A scan kernel's record at one shape: ``instr``, where given, counts
    the f32 instructions its products and sums need when rounded apart (no
    FMA), whose issue at one a lane on all 132 SMs is a floor beside the
    bytes and FLOP bounds."""
    bytes_ms, ops_ms = nbytes / MEM_BYTES_PER_S * 1e3, ops / PEAK_OPS[torch.float32] * 1e3
    r = dict(B=B, S=S, Dh=width, ok=equal and same and steps_equal, same_bits=same, scan_equals_steps=steps_equal,
             max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
             bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes,
             blocks=blocks)
    floor = ""
    if instr is not None:
        r["no_fma_floor_ms"] = instr / F32_ISSUE_PER_S * 1e3
        floor = f"; no-FMA floor {r['no_fma_floor_ms'] * 1e3:.2f} us ({instr / 1e9:.3f} G f32 instructions on 132 SMs)"
    log(f"  [{name}] B={B} S={S} Dh={width} ({blocks} blocks): err {err:.2e} (tol {KERNEL_TOL:g}), rerun same bits "
        f"{same}, scan == steps {steps_equal}; {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.1f} us, {plain_ms / ms:.1f}x), "
        f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}: {nbytes / 1e6:.2f} MB at 3.35 TB/s, {ops / 1e9:.3f} "
        f"GFLOP f32 at 67 TFLOP/s{floor}): {ms / r['bound_ms']:.2f}x the bound{'' if r['ok'] else '  FAIL'}")
    return r


def check_xlstm_scans(gen, cfg):
    """K10 and K11 against their plain loops at ``XLSTM_SCAN_SHAPES`` and
    xlstm-125m's heads (mLSTM Dh 384, sLSTM Dh 192, R in bf16): within
    ``KERNEL_TOL``, the same bits on a rerun, a scan of S ≤ 5 tokens equal
    to S single steps; kernel and plain times by graph replay (median of
    7; the plain loop at S = 3000 once a replay, 3 replays) beside the bound
    → (K10 records, K11 records)."""
    from repro_torch.kernels import mlstm_scan, mlstm_scan_plain, slstm_scan, slstm_scan_plain
    from repro_torch.kernels.mlstm_scan import plan as k10_plan, scale_for
    from repro_torch.kernels.slstm_scan import plan as k11_plan
    from repro_torch.models.recurrent import mlstm_dims

    NH, dm, ds = cfg.n_heads, mlstm_dims(cfg)[1], cfg.d_model // cfg.n_heads
    sc = scale_for(dm)
    k10, k11 = [], []
    for B, S in XLSTM_SCAN_SHAPES:
        xs = [torch.randn((B, S, NH, dm), generator=gen, device=DEVICE) for _ in range(3)]
        xs += [torch.randn((B, S, NH), generator=gen, device=DEVICE),
               torch.nn.functional.logsigmoid(torch.randn((B, S, NH), generator=gen, device=DEVICE) + 2.0)]
        state = [torch.randn((B, NH, dm, dm), generator=gen, device=DEVICE) * 0.1,
                 torch.randn((B, NH, dm), generator=gen, device=DEVICE), torch.randn((B, NH), generator=gen, device=DEVICE)]
        st, ps, again = ([t.clone() for t in state] for _ in range(3))
        h, _ = mlstm_scan(*xs, *st, sc)
        ph, _ = mlstm_scan_plain(*xs, *ps, sc)
        h2, _ = mlstm_scan(*xs, *again, sc)
        err = max((h - ph).abs().max().item(), *((a - b).abs().max().item() for a, b in zip(st, ps)))
        equal = all(torch.allclose(a, b, rtol=KERNEL_TOL, atol=KERNEL_TOL) for a, b in zip([h, *st], [ph, *ps]))
        same = bool(torch.equal(h, h2) and all(torch.equal(a, b) for a, b in zip(st, again)))
        steps_equal = True
        if S <= 5:
            step_st = [t.clone() for t in state]
            hs = [mlstm_scan(*(x[:, t : t + 1] for x in xs), *step_st, sc)[0] for t in range(S)]
            steps_equal = bool(torch.equal(torch.cat(hs, dim=1), h)
                               and all(torch.equal(a, b) for a, b in zip(step_st, st)))
        ms = time_ms(lambda: mlstm_scan(*xs, *st, sc), [()])
        long = S > 64
        plain_ms = time_ms(lambda: mlstm_scan_plain(*xs, *ps, sc), [()], inner=1 if long else None, reps=3 if long else 7)
        nbytes = (4 * B * S * NH * dm + 2 * B * S * NH + 2 * B * NH * (dm * dm + dm + 1)) * 4
        k10.append(_scan_record("K10 mlstm_scan", B, S, dm, equal, same, steps_equal, err, ms, plain_ms, nbytes,
                                4.0 * dm * dm * B * S * NH, blocks=k10_plan(dm).blocks(B, NH),
                                instr=5.0 * dm * dm * B * S * NH))
        pre = [torch.randn((B, S, NH, ds), generator=gen, device=DEVICE) for _ in range(4)]
        r = [(torch.randn((NH, ds, ds), generator=gen, device=DEVICE) / math.sqrt(ds)).to(cfg.pdtype) for _ in range(4)]
        state = [torch.randn((B, NH, ds), generator=gen, device=DEVICE) for _ in range(4)]
        state[2] = state[2].abs() + 0.5
        st, ps, again = ([t.clone() for t in state] for _ in range(3))
        hs, _ = slstm_scan(pre, r, st)
        phs, _ = slstm_scan_plain(pre, r, ps)
        hs2, _ = slstm_scan(pre, r, again)
        err = max((hs - phs).abs().max().item(), *((a - b).abs().max().item() for a, b in zip(st, ps)))
        equal = all(torch.allclose(a, b, rtol=KERNEL_TOL, atol=KERNEL_TOL) for a, b in zip([hs, *st], [phs, *ps]))
        same = bool(torch.equal(hs, hs2) and all(torch.equal(a, b) for a, b in zip(st, again)))
        steps_equal = True
        if S <= 5:
            step_st = [t.clone() for t in state]
            outs = [slstm_scan([p[:, t : t + 1] for p in pre], r, step_st)[0] for t in range(S)]
            steps_equal = bool(torch.equal(torch.cat(outs, dim=1), hs)
                               and all(torch.equal(a, b) for a, b in zip(step_st, st)))
        ms = time_ms(lambda: slstm_scan(pre, r, st), [()])
        plain_ms = time_ms(lambda: slstm_scan_plain(pre, r, ps), [()], inner=1 if long else None, reps=3 if long else 7)
        nbytes = (5 * B * S * NH * ds + 8 * B * NH * ds) * 4 + 4 * NH * ds * ds * r[0].element_size()
        k11_pl = k11_plan(ds, cfg.pdtype)
        k11.append(_scan_record("K11 slstm_scan", B, S, ds, equal, same, steps_equal, err, ms, plain_ms, nbytes,
                                8.0 * ds * ds * B * S * NH, blocks=NH * -(-B // k11_pl.rb) * k11_pl.cl))
    bad = [r for r in k10 + k11 if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: [xlstm] K10 / K11 differ from their plain versions: {bad}")
    return k10, k11


def xlstm_main(engine, prompts):
    """The phase's main path: a batched ``generate`` in a counted window, the
    census held to the model's cells, then captured against eager, the
    graph's kernel nodes its counted launches → (counts, summary)."""
    from repro_torch.kernels import ternary_mm

    cfg = engine.cfg
    per = xlstm_forward_counts(cfg)
    engine.generate(prompts, 2)  # the graph's warm-up and capture
    res, dt, counts, ref_calls = run_counted(lambda: engine.generate(prompts, XLSTM_NEW))
    forwards = 1 + XLSTM_NEW
    expect = dict.fromkeys(counts, 0)
    expect.update(bcq_mm=forwards * per["linears"], mlstm_scan=forwards * per["mlstm_scan"],
                  slstm_scan=forwards * per["slstm_scan"])
    log(f"  [xlstm] main path: generate batched ({len(prompts)}x{prompts.shape[1]} + {XLSTM_NEW}, replayed graph) "
        f"{dt:.3f}s, {len(prompts) * XLSTM_NEW / dt:.1f} tok/s; launches {json.dumps(counts)} (expected "
        f"{json.dumps(expect)}), ref-oracle dispatches {ref_calls}")
    if counts != expect or ref_calls or ternary_mm.tc_launches:
        raise SystemExit(f"chip_smoke: [xlstm] main path launches {counts} != {expect} (ref {ref_calls})")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise SystemExit("chip_smoke: [xlstm] bad generated tokens")
    graph_l = decode_loop(engine, prompts, True, XLSTM_NEW)()
    eager_l = decode_loop(engine, prompts, False, XLSTM_NEW)()
    runs = {name: run_counted(lambda s=scan: engine.generate(prompts, XLSTM_NEW, temperature=0.8, seed=7, scan=s))
            for name, scan in (("eager", False), ("graph", True))}
    same = dict(logits=bool(torch.equal(graph_l, eager_l)),
                tokens=bool((runs["graph"][0].tokens == runs["eager"][0].tokens).all()),
                census=runs["graph"][2] == runs["eager"][2])
    graph = engine._graphs[(len(prompts), None)]
    nodes = {k: v for k, v in GRAPH_NODES[graph].items() if v}
    want_nodes = {"bcq_mm+bcq_mm_fused": per["linears"], "mlstm_scan": per["mlstm_scan"],
                  "slstm_scan": per["slstm_scan"]}
    tok_s = {name: len(prompts) * XLSTM_NEW / runs[name][1] for name in runs}
    loop = {"graph": lambda: engine.generate(prompts, XLSTM_NEW), "eager":
            lambda: engine.generate(prompts, XLSTM_NEW, scan=False)}
    prof = {}
    for name, run in loop.items():
        _, wall, _, _ = run_counted(run)
        device_ms, _, by_name = device_profile(run)
        groups = collections.Counter()
        for k, v in by_name.items():
            groups["K1" if "BCQGroups" in k else "K10" if "mlstm_scan" in k else "K11" if "slstm_scan" in k
                   else "other"] += v
        prof[name] = dict(wall_s=wall, device_ms=device_ms, busy=device_ms / (wall * 1e3),
                          by_part={k: round(v, 3) for k, v in groups.items()})
    step_ms = prof["graph"]["device_ms"] / forwards
    log(f"  [xlstm] captured against eager ({XLSTM_NEW} steps at B = {len(prompts)}): logits equal {same['logits']}, "
        f"sampled tokens equal {same['tokens']}, census equal {same['census']}; tok/s eager {tok_s['eager']:.1f}, "
        f"graph {tok_s['graph']:.1f}; the graph's kernel nodes {nodes} (expected {want_nodes}), pool "
        f"{POOL_BYTES[graph] / 1e6:.1f} MB; device busy: graph {prof['graph']['device_ms']:.2f} ms "
        f"({prof['graph']['busy']:.1%}, by part {prof['graph']['by_part']}), eager {prof['eager']['device_ms']:.2f} "
        f"ms ({prof['eager']['busy']:.1%}, by part {prof['eager']['by_part']}); ~{step_ms:.3f} device ms a forward")
    if not all(same.values()) or nodes != want_nodes:
        raise SystemExit(f"chip_smoke: [xlstm] the replayed graph differs from the eager loop or its nodes from "
                         f"the prediction: {same}, {nodes}")
    dist = xlstm_logits_check(engine, "xlstm main path, prefill + 1 step",
                              lambda eng, mode: step_logits(eng, prompts, mode))
    return counts, dict(wall_s=dt, tok_s=tok_s, same=same, nodes=nodes, pool_bytes=POOL_BYTES[graph],
                        profile=prof, device_ms_per_forward=step_ms, logits=dist)


def xlstm_long(engine, rng):
    """A ``XLSTM_LONG``-token prompt and ``XLSTM_NEW`` new tokens: prefill
    time, decode tok/s, peak memory above the weights; ``XLSTM_FORCED``
    teacher-forced steps against the ref path."""
    prompt = rng.integers(0, engine.cfg.vocab, XLSTM_LONG).astype(np.int32)
    tokens = torch.as_tensor(prompt[None], device=DEVICE).long()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (_, _), prefill_s, pre_counts, _ = run_counted(lambda: engine.prefill(tokens, engine._make_cache(1)))
    res, wall, counts, ref_calls = run_counted(lambda: engine.generate(prompt[None], XLSTM_NEW))
    peak = torch.cuda.max_memory_allocated() - base
    decode_s = wall - prefill_s
    log(f"  [xlstm long] {XLSTM_LONG}-token prompt + {XLSTM_NEW}: prefill {prefill_s:.3f}s (K10 "
        f"{pre_counts['mlstm_scan']}, K11 {pre_counts['slstm_scan']} launches), generate {wall:.3f}s (decode "
        f"~{XLSTM_NEW / decode_s:.1f} tok/s at B = 1), peak {peak / 1e9:.3f} GB above the resident {base / 1e9:.3f} GB; "
        f"ref-oracle dispatches {ref_calls}")
    if ref_calls or counts["flash_attention"]:
        raise SystemExit(f"chip_smoke: [xlstm long] ref {ref_calls}, K8 {counts['flash_attention']}")
    forced = res.tokens[0, XLSTM_LONG : XLSTM_LONG + XLSTM_FORCED]
    dist = xlstm_logits_check(engine, f"xlstm long, {XLSTM_FORCED} forced steps",
                              lambda eng, mode: forced_logits(eng, prompt, forced, mode))
    return dict(prefill_s=prefill_s, wall_s=wall, decode_tok_s=XLSTM_NEW / decode_s, peak_gb=peak / 1e9,
                resident_gb=base / 1e9, logits=dist)


def xlstm_slots_and_spec(engine, rng, prompts):
    """Slots: ``XLSTM_SLOT_LENS`` requests on 4 slots == solo (each slot
    reused after a tenant: its state reset to the initial values);
    ``SpecConfig(2, 4)`` greedy == plain on the main path's prompts, and
    ``SpecConfig(4, 4)`` (the draft is the target) accepts every proposal
    before the cut."""
    from repro_torch.infer import SpecConfig

    reqs = hybrid_requests(engine.cfg, XLSTM_SLOT_LENS, XLSTM_SLOT_NEW, 600)
    t0 = synced_clock()
    solo = hybrid_solo(engine, reqs)
    t1 = synced_clock()
    got = hybrid_serve(engine, reqs, SERVE_SLOTS)
    t2 = synced_clock()
    equal = sum(got[r.rid] == solo[r.rid] for r in reqs)
    n_tok = len(reqs) * XLSTM_SLOT_NEW
    log(f"  [xlstm slots] {len(reqs)} requests (prompts {list(XLSTM_SLOT_LENS)}, {XLSTM_SLOT_NEW} new, temperatures "
        f"0, 1.0, 0.7) on {SERVE_SLOTS} slots: == solo generate {equal}/{len(reqs)}; {n_tok / (t2 - t1):.1f} tok/s "
        f"continuous, {n_tok / (t1 - t0):.1f} one at a time")
    if equal != len(reqs):
        raise SystemExit("chip_smoke: [xlstm] a slot's tokens differ from its solo generate")
    plain, plain_s, _, _ = run_counted(lambda: engine.generate(prompts, XLSTM_SPEC_NEW))
    out = {}
    for q_draft in (XLSTM_SPEC[0], Q):
        spec, spec_s, counts, _ = run_counted(
            lambda: engine.generate(prompts, XLSTM_SPEC_NEW, speculate=SpecConfig(q_draft, XLSTM_SPEC[1])))
        same = bool((spec.tokens == plain.tokens).all())
        st = spec.spec_stats
        log(f"  [xlstm spec] SpecConfig({q_draft}, {XLSTM_SPEC[1]}) on {len(prompts)}x{prompts.shape[1]} + "
            f"{XLSTM_SPEC_NEW}: greedy == plain {same}; acceptance {st['accept_rate']:.3f} ({st['accepted']}/"
            f"{st['proposed']}, {st['committable']} of them before the cut, {st['chunks']} chunks); {spec_s:.3f}s "
            f"(plain {plain_s:.3f}s); K10 {counts['mlstm_scan']}, K11 {counts['slstm_scan']}")
        if not same or (q_draft == Q and st["accepted"] != st["committable"]):
            raise SystemExit(f"chip_smoke: [xlstm spec] q'={q_draft}: speculative greedy differs from plain, or "
                             f"a draft equal to the target had a proposal rejected")
        out[f"q{q_draft}"] = dict(equal=same, spec_stats=st, wall_s=spec_s)
    return dict(slots_equal=equal, slot_tok_s=n_tok / (t2 - t1), solo_tok_s=n_tok / (t1 - t0), spec=out,
                plain_s=plain_s)


def xlstm_prefix(engine, rng):
    """A wave of requests sharing a 512-token prompt, cold then warm, against
    one prefix cache holding each block's boundary state: tokens and
    last-prompt logits equal bit for bit, every warm request a hit."""
    from repro_torch.infer import PrefixCache

    cfg = engine.cfg
    pc = PrefixCache(block_tokens=PREFIX_BLOCK, max_bytes=XLSTM_PREFIX_BYTES)
    eng = serving_engine(engine, engine.max_seq, prefix_cache=pc)
    shared = rng.integers(0, cfg.vocab, PREFIX_LEN)
    reqs = hybrid_requests(cfg, XLSTM_PREFIX_TAILS, XLSTM_SLOT_NEW, 700)
    for r in reqs:
        r.prompt = np.concatenate([shared, r.prompt]).astype(np.int32)
    waves, logits, walls = [], [], []
    for _ in range(2):
        seen = record_admissions(eng)
        t0 = synced_clock()
        waves.append(hybrid_serve(eng, reqs, SERVE_SLOTS))
        walls.append(synced_clock() - t0)
        del eng.finish_admission
        logits.append(seen)
    same_tokens = waves[0] == waves[1]
    same_logits = all(torch.equal(logits[0][k], logits[1][k]) for k in logits[0])
    snap_mb = sum(n.nbytes for n in pc._nodes) / 1e6
    log(f"  [xlstm prefix] {len(reqs)} requests sharing {PREFIX_LEN} tokens (+ tails {list(XLSTM_PREFIX_TAILS)}), "
        f"cold {walls[0]:.3f}s then warm {walls[1]:.3f}s: tokens equal {same_tokens}, last-prompt logits equal "
        f"{same_logits}; hits {pc.counters['hits']}, misses {pc.counters['misses']}, commits {pc.counters['commits']}, "
        f"{len(pc._nodes)} blocks with their boundary states, {snap_mb:.1f} MB")
    if not (same_tokens and same_logits and pc.counters["hits"] >= len(reqs) and pc.pinned == 0):
        raise SystemExit("chip_smoke: [xlstm prefix] warm != cold, or a warm request missed")
    return dict(cold_s=walls[0], warm_s=walls[1], counters=dict(pc.counters), blocks=len(pc._nodes), mb=snap_mb)


def xlstm_formats(cfg, params, prompts):
    """The other formats (and bcq on the paper's LUT kernel) at full width
    and depth: one batched ``generate`` each, launches counted, logits
    against the ref path; every launched (kernel, planes, rows, leaf) is
    kept for :func:`check_launched` → (summary, census)."""
    from repro_torch.kernels import impl_mode

    per = xlstm_forward_counts(cfg)
    out, seen_all = {}, collections.Counter()
    for fmt, mode in (("uniform", None), ("ternary", None), ("codebook", None), ("dequant", None),
                      ("bcq", "lutgemm")):
        engine = quantized_engine(cfg, params, fmt, PROMPT_LEN + NEW_TOKENS + 8)
        kernel = mode or FORMAT_KERNEL[fmt]
        with impl_mode(mode), kernel_census(by_leaf=True) as seen:
            engine.generate(prompts, 2)
            res, dt, counts, ref_calls = run_counted(lambda: engine.generate(prompts, NEW_TOKENS))
        seen_all.update(seen)
        want = (1 + NEW_TOKENS) * per["linears"]
        rel = xlstm_logits_check(engine, f"xlstm {fmt}{' on ' + mode if mode else ''}, prefill + 1 step",
                                 lambda eng, m: step_logits(eng, prompts, m), mode)
        log(f"  [xlstm {fmt}{' on ' + mode if mode else ''}] generate batched: {dt:.3f}s; {kernel} {counts[kernel]} "
            f"launches (expected {want}), K10 {counts['mlstm_scan']}, K11 {counts['slstm_scan']}, ref-oracle "
            f"dispatches {ref_calls}")
        if (counts[kernel] != want or ref_calls or counts["mlstm_scan"] != (1 + NEW_TOKENS) * per["mlstm_scan"]
                or counts["slstm_scan"] != (1 + NEW_TOKENS) * per["slstm_scan"]):
            raise SystemExit(f"chip_smoke: [xlstm {fmt}] launches {counts}, expected {want} of {kernel}")
        out[fmt + ("_" + mode if mode else "")] = dict(wall_s=dt, logits=rel, launches=counts[kernel])
        del engine
    return out, seen_all


def phase_xlstm(gen, records):
    """Phase 13 (module docstring) → (summary, K10 records, K11 records, the main path's counts)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant import quantized_bytes

    cfg = get_config(XLSTM)
    k10, k11 = check_xlstm_scans(gen, cfg)
    log(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}, mLSTM inner "
        f"{int(cfg.d_model * cfg.mlstm_proj_factor)}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, layers {cfg.n_layers} "
        f"{cfg.block_counts()}, {cfg.param_dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.1f}s ({quantized_bytes(params) / 1e9:.3f} GB dense)")
    engine = quantized_engine(cfg, params, "bcq", XLSTM_LONG + XLSTM_NEW + 8)
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, cfg.vocab, (PROMPTS, PROMPT_LEN))
    summary, walls = {}, {}
    with kernel_census(by_leaf=True) as seen:
        t = time.perf_counter()
        counts, summary["main"] = xlstm_main(engine, prompts)
        walls["main"] = time.perf_counter() - t
        for name, fn in (("long", lambda: xlstm_long(engine, rng)),
                         ("slots_spec", lambda: xlstm_slots_and_spec(engine, rng, prompts)),
                         ("prefix", lambda: xlstm_prefix(engine, rng))):
            t = time.perf_counter()
            summary[name] = fn()
            walls[name] = time.perf_counter() - t
    del engine
    torch.cuda.empty_cache()
    t = time.perf_counter()
    summary["formats"], seen_formats = xlstm_formats(cfg, params, prompts)
    walls["formats"] = time.perf_counter() - t
    del params
    torch.cuda.empty_cache()
    t = time.perf_counter()
    seen.update(seen_formats)
    summary["checked"] = len(check_launched("xlstm", seen, None, records, gen, xlstm_leaves(cfg)))
    walls["checked"] = time.perf_counter() - t
    summary["walls"] = walls
    log(f"  [xlstm] phase wall by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return summary, k10, k11, counts


# -- phase 14: the MoE family (olmoe-1b-7b; llama4-maverick reduced) -----------------

MOE = "olmoe-1b-7b"
LLAMA4 = "llama4-maverick-400b-a17b"
# K12 has no TPU kernel: it is the port's counterpart of the reference's _w dequantize and grouped einsums
K12 = ("expert_mm", "csrc/grouptable.cuh", "src/repro/models/moe.py:186")
MOE_NEW = 32  # the batched generate's new tokens
# parts of the device kernel names of the MoE dispatch's own ops (routing sorts, counts, buffers, combine)
DISPATCH_TAGS = ("sort", "scan", "scatter", "gather", "index")
MOE_LONG = 512
# llama4-maverick's shared expert, top-1 and dense / MoE interleaving at a width one card holds (every
# linear >= 128 wide, so each is packed)
LLAMA4_REDUCED = dict(d_model=512, d_ff=1024, moe_d_ff=512, n_experts=128, top_k=1, moe_period=2, n_layers=4,
                      param_dtype="bfloat16", compute_dtype="bfloat16")
LLAMA4_CAPS = (8, 80)
MOE_REFUSALS = {  # the reference's words, infer/engine.py
    "slots": "slot-batched serving does not support MoE models: shared expert capacity couples batch rows",
    "speculation": "speculative decoding does not support MoE models: shared expert capacity couples the "
                   "verified chunk's tokens, so the batched verify is not equivalent to step-by-step decode",
    "prefix cache": "prefix_cache requires a tokens-input, non-VLM, non-MoE model",
    "chunked prefill": "chunked prefill is unsupported for this architecture (ring-buffer/recurrent/MoE/VLM",
}


def bank_planes(kind, E, k, o, dtype, gen):
    """A bank of E experts' random packed planes and scales (``format_planes``
    each; scales in ``dtype``) → (packed (E, P, k/8, o), scales (E, S, k/G, o))."""
    planes = [format_planes(kind, k, o, Q, G, gen) for _ in range(E)]
    return torch.stack([p for p, _ in planes]), torch.stack([s for _, s in planes]).to(dtype)


def check_k12(kind, E, k, o, C, dtype, gen, bank=None, leaf=""):
    """K12 at one bank shape: within ``KERNEL_TOL`` of its plain version,
    every expert's rows bit for bit the format's kernel called on that expert
    alone, the same bits on a rerun, one launch; with per-expert row counts
    (empty experts, partial tiles, a count past C) the rows below each
    count bit for bit the same and the rest zero; timed (graph replays,
    every expert filled) beside its plain version, its bound (the bank's
    planes and scales, x and the f32 out read or written once; E·C·k·o
    products and sums at the inputs' peak) and the library call
    (``torch.bmm`` of bf16 buffers against the bank pre-dequantized to
    bf16) → record."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.kernels import bcq_mm, expert_mm, expert_mm_plain, launch_counts, ternary_mm, uniform_mm

    single = {"bcq": bcq_mm, "uniform": uniform_mm, "ternary": ternary_mm}[kind]
    packed, scales = bank if bank is not None else bank_planes(kind, E, k, o, dtype, gen)
    x = torch.randn((E, C, k), generator=gen, device=DEVICE).to(dtype)
    before = launch_counts()["expert_mm"]
    y = expert_mm(x, packed, scales, g=G, kind=kind)
    one_launch = launch_counts()["expert_mm"] - before == 1
    torch.cuda.synchronize()
    want = expert_mm_plain(x, packed, scales, g=G, kind=kind)
    err = (y - want).abs().max().item()
    within = bool(torch.allclose(y, want, rtol=KERNEL_TOL, atol=KERNEL_TOL)) and bool(torch.isfinite(y).all())
    del want
    each_out = torch.stack([single(x[e], packed[e], scales[e], g=G) for e in range(E)])
    each = bool(torch.equal(each_out, y))
    same = bool(torch.equal(expert_mm(x, packed, scales, g=G, kind=kind), y))
    rows = torch.randint(0, C + 2, (E,), generator=gen, device=DEVICE).to(torch.int32)
    rows[0] = 0
    live = torch.arange(C, device=DEVICE)[None, :] < rows[:, None]
    part = expert_mm(x, packed, scales, g=G, kind=kind, rows=rows)
    rows_ok = bool(torch.equal(part.view(torch.int32),
                               torch.where(live[..., None], each_out, torch.zeros_like(each_out)).view(torch.int32)))
    del each_out, part
    ms = time_ms(lambda: expert_mm(x, packed, scales, g=G, kind=kind), [()])
    plain_ms = time_ms(lambda: expert_mm_plain(x, packed, scales, g=G, kind=kind), [()], reps=3, inner=1)
    f = get_format(kind)
    w16 = f.dequantize(QuantizedTensor(packed=packed, scales=scales, g=G, k=k, o=o, fmt=kind), dtype=torch.bfloat16)
    x16 = x.to(torch.bfloat16)
    library_ms = time_ms(lambda: torch.bmm(x16, w16), [()])
    del w16, x16
    nbytes = packed.numel() + scales.numel() * scales.element_size() + x.numel() * x.element_size() + E * C * o * 4
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * E * C * k * o / PEAK_OPS[torch.promote_types(dtype, scales.dtype)] * 1e3
    rec = dict(kernel=K12[0], kind=kind, leaf=leaf, E=E, C=C, k=k, o=o, q=packed.shape[1], g=G,
               dtype=str(dtype).replace("torch.", ""), max_abs_err=err, tol=KERNEL_TOL, equals_each_expert=each,
               same_bits=same, rows_equal=rows_ok, one_launch=one_launch,
               ok=within and each and same and rows_ok and one_launch, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations", mb=nbytes / 1e6)
    log(f"  [K12 {kind}] {leaf or '-':11s} E={E:<3d} C={C:<2d} k={k:<4d} o={o:<4d} {rec['dtype']:8s} err {err:.2e} "
        f"(tol {KERNEL_TOL:g}), == each expert's {single.__name__} {each} (with row counts {rows_ok}), rerun same "
        f"bits {same}, one launch {one_launch} {'ok' if rec['ok'] else 'FAIL'}  {ms:.4f} ms = "
        f"{ms / rec['bound_ms']:.1f}x its bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, {nbytes / 1e6:.1f} MB), "
        f"plain {plain_ms:.3f} ms, library bmm {library_ms:.4f} ms ({ms / library_ms:.2f}x)")
    return rec


STEP_SETS = 4  # distinct bank sets the timed decode step cycles through (~0.86 GB: past the 50 MB L2)


def step_routing(gen, E, C, tokens, top):
    """Each expert's filled rows after ``tokens`` tokens each pick ``top``
    distinct experts at random, at most C: a decode step's ``rows``."""
    picks = torch.rand((tokens, E), generator=gen, device=DEVICE).argsort(-1)[:, :top]
    counts = torch.zeros(E, dtype=torch.int64, device=DEVICE).scatter_add_(0, picks.reshape(-1),
                                                                          torch.ones_like(picks.reshape(-1)))
    return torch.clamp_max(counts, C).to(torch.int32)


def k12_step(gen, cfg):
    """K12 as olmoe's decode step at B = 4 launches it: each of its 16 layers
    gate + up paired over one buffer, then down, each expert's rows from a
    random top-8 routing of 4 tokens (capacity 8), the buffers zero past
    them, ``STEP_SETS`` bank sets in turn. Held to K1 on each expert bit for
    bit (every layer's rows, the rest zero); timed by graph replays beside
    its plain version, the bytes of the live experts and of all experts
    (planes, scales, buffers and f32 outputs once) and the library's three
    bmm a layer against the banks pre-dequantized to bf16 → record."""
    from repro_torch.core.formats import get_format
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.kernels import bcq_mm, expert_mm, expert_mm_pair, expert_mm_plain, launch_counts

    E, d, F, L = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.n_layers
    C, bf = moe_caps(cfg)[0], torch.bfloat16
    sets = [[bank_planes("bcq", E, k, o, bf, gen) for k, o in ((d, F), (d, F), (F, d))] for _ in range(STEP_SETS)]
    layers = []
    for layer in range(L):
        rows = step_routing(gen, E, C, PROMPTS, cfg.top_k)
        live = (torch.arange(C, device=DEVICE)[None, :] < rows[:, None])[..., None]
        xb = torch.where(live, torch.randn((E, C, d), generator=gen, device=DEVICE), 0.0).to(bf)
        hb = torch.where(live, torch.randn((E, C, F), generator=gen, device=DEVICE), 0.0).to(bf)
        layers.append((rows, sets[layer % STEP_SETS], xb, hb, live))

    def step():
        for rows, (gate, up, down), xb, hb, _ in layers:
            expert_mm_pair(xb, gate, up, g=G, rows=rows)
            expert_mm(hb, *down, g=G, rows=rows)

    before = launch_counts()["expert_mm"]
    step()
    launches = launch_counts()["expert_mm"] - before
    equal = True
    for rows, (gate, up, down), xb, hb, live in layers:
        outs = [*expert_mm_pair(xb, gate, up, g=G, rows=rows), expert_mm(hb, *down, g=G, rows=rows)]
        for y, (packed, scales), xx in zip(outs, (gate, up, down), (xb, xb, hb)):
            each = torch.stack([bcq_mm(xx[e], packed[e], scales[e], g=G) for e in range(E)])
            equal &= bool(torch.equal(y.view(torch.int32), torch.where(live, each, 0.0).view(torch.int32)))
    ms = time_ms(step, [()], inner=3)
    r0, (g0, u0, d0), x0, h0, _ = layers[0]
    plain_ms = L * time_ms(lambda: (expert_mm_plain(x0, *g0, g=G, rows=r0), expert_mm_plain(x0, *u0, g=G, rows=r0),
                                    expert_mm_plain(h0, *d0, g=G, rows=r0)), [()], reps=3, inner=1)
    fmt = get_format("bcq")
    w16 = [[fmt.dequantize(QuantizedTensor(packed=p, scales=s, g=G, k=p.shape[2] * 8, o=p.shape[-1], fmt="bcq"),
                           dtype=bf) for p, s in bank_set] for bank_set in sets]

    def library():
        for layer, (_, _, xb, hb, _) in enumerate(layers):
            wg, wu, wd = w16[layer % STEP_SETS]
            torch.bmm(xb, wg), torch.bmm(xb, wu), torch.bmm(hb, wd)

    library_ms = time_ms(library, [()], inner=3)
    del w16
    per_expert = sum(p[0].numel() + p[1].numel() * p[1].element_size() for p in sets[0]) // E
    n_live = sum(int((rows > 0).sum()) for rows, *_ in layers)
    n_rows = sum(int(rows.sum()) for rows, *_ in layers)
    io_row = 2 * d + 2 * F * 4 + 2 * F + d * 4  # x read, gate and up written (f32), h read, down written (f32)
    bytes_ms = (n_live * per_expert + n_rows * io_row) / MEM_BYTES_PER_S * 1e3
    all_ms = L * (E * per_expert + E * C * io_row) / MEM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * n_rows * 3 * d * F / PEAK_OPS[bf] * 1e3
    rec = dict(kernel=K12[0], leaf="step", E=E, C=C, layers=L, launches=launches, live_experts=n_live / L,
               equals_each_expert=equal, ok=equal and launches == 2 * L, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_all_ms=all_ms, bound_by="bytes" if bytes_ms >= ops_ms else "operations", max_abs_err=0.0)
    log(f"  [K12 step] B = {PROMPTS}, {L} layers, {launches} launches (gate + up paired, then down), "
        f"{n_live / L:.1f} of {E} experts live a layer: == each expert's bcq_mm {equal}  {ms:.4f} ms = "
        f"{ms / rec['bound_ms']:.1f}x its bound over the live experts {rec['bound_ms']:.4f} ms (all experts "
        f"{all_ms:.4f} ms), library bmm {library_ms:.4f} ms ({ms / library_ms:.2f}x), plain {plain_ms:.1f} ms")
    return rec


def moe_caps(cfg):
    """The capacity rows of the phase's calls: a decode step at B = 4, the
    batched prefill of 4 × 16 tokens, the ``MOE_LONG``-token prompt (olmoe:
    8, 16, 80)."""
    from repro_torch.models.moe import capacity

    return tuple(capacity(cfg, t) for t in (PROMPTS, PROMPTS * PROMPT_LEN, MOE_LONG))


def check_k12_banks(gen, cfg):
    """K12 at olmoe-1b-7b's two bank shapes (w_gate / w_up: d → F, w_down: F →
    d), for every capacity of :func:`moe_caps`, bf16 and f32; uniform's K12
    at one shape; the decode step (:func:`k12_step`) → records (raises on
    any failure)."""
    E, d, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    recs = []
    for leaf, (k, o) in (("w_gate/w_up", (d, F)), ("w_down", (F, d))):
        for dtype in (torch.bfloat16, torch.float32):
            bank = bank_planes("bcq", E, k, o, dtype, gen)
            recs += [check_k12("bcq", E, k, o, C, dtype, gen, bank, leaf) for C in moe_caps(cfg)]
            del bank
    recs.append(check_k12("uniform", E, d, F, moe_caps(cfg)[0], torch.bfloat16, gen, leaf="w_gate/w_up"))
    recs.append(k12_step(gen, cfg))
    bad = [r for r in recs if not r["ok"]]
    if bad:
        raise SystemExit(f"chip_smoke: [moe] K12 differs from its plain version or from each expert's kernel: {bad}")
    return recs


class _CountedBank(_Counted):
    """K12's wrapper seen through :func:`k12_census`: counts each bank a call
    takes by (kind, E, C, k, o, x dtype), both of a pair; the launch counter
    passes through."""

    def __call__(self, x, *banks, **kw):
        pair = isinstance(banks[0], tuple)
        for _ in range(2 if pair else 1):
            o = (banks[0][0] if pair else banks[0]).shape[-1]
            self._seen[(kw.get("kind", "bcq"), *x.shape, o, str(x.dtype).replace("torch.", ""))] += 1
        return self._fn(x, *banks, **kw)


@contextlib.contextmanager
def k12_census():
    """Count every bank of every K12 call by (kind, E, C, k, o, x dtype)
    while the block runs (``ops.expert_matmul`` and ``expert_linear_pair``
    import the wrappers at each call, so the module attributes patched here
    see them all)."""
    mod = importlib.import_module("repro_torch.kernels.expert_mm")
    fns, seen = (mod.expert_mm, mod.expert_mm_pair), collections.Counter()
    mod.expert_mm = _CountedBank(fns[0], "expert_mm", seen, False)
    mod.expert_mm_pair = _CountedBank(fns[1], "expert_mm", seen, False)
    try:
        yield seen
    finally:
        mod.expert_mm, mod.expert_mm_pair = fns


def forward_counts_of(engine, batch, seq, image_rows=0):
    """Launches of one forward of ``batch`` rows of ``seq`` tokens (or
    frames) through a bcq engine of phases 14–15, from its fused parameter
    tree: K2 at every ``wqkv`` and dense ``w_gate_up``; K1 at ``wo``, a dense
    or shared ``w_down``, the shared expert's ``w_gate`` / ``w_up`` (an MoE
    MLP is not fused), a cross block's ``wq`` / ``wo`` over the token rows
    and, where the forward is given ``image_rows`` image rows (a prefill
    with image embeddings), its ``wk`` / ``wv`` over them, and the LM head
    (``batch`` rows: the last position's), one a row slab; K12 twice an MoE
    layer at any capacity (gate and up paired, then down); K8 once a
    self-attention layer of a prefill (seq > 1), never for a cross block
    (its attention is plain)."""
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.kernels import grouptable

    cfg, counts = engine.cfg, collections.Counter()
    rows = batch * seq

    def launches(qt, n):
        pl = grouptable.plan("bcq", qt.k, qt.o, qt.q, qt.g, cfg.cdtype, qt.scales.dtype)
        return -(-n // pl.slab_rows(n))

    def linears(tree, n, names=None):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                linears(leaf, n)
            elif isinstance(leaf, QuantizedTensor) and (names is None or name in names):
                counts["bcq_mm_fused" if name in ("wqkv", "w_gate_up") else "bcq_mm"] += launches(leaf, n)

    for (pattern, repeat), stage in zip(cfg.stages, engine.params["stages"]):
        for bi, btype in enumerate(pattern):
            blk = stage[f"b{bi}"]
            for _ in range(repeat):
                if btype == "cross":
                    linears(blk["attn"], rows, ("wq", "wo"))
                    if image_rows:
                        linears(blk["attn"], image_rows, ("wk", "wv"))
                else:
                    linears(blk["attn"], rows)
                    counts["flash_attention"] += int(seq > 1)
                mlp = blk["mlp"]
                if "router" in mlp:
                    counts["expert_mm"] += 2
                    linears(mlp.get("shared", {}), rows)
                else:
                    linears(mlp, rows)
    counts["bcq_mm"] += launches(engine.params["lm_head"], batch)
    return counts


def generate_counts(engine, batch, prompt_len, new, image_rows=0):
    """Launches of ``generate``: a prefill (given ``image_rows`` image
    rows), then ``new`` decode forwards (one a sampled token) → {wrapper:
    launches}, every other wrapper 0."""
    from repro_torch.kernels import launch_counts

    want = dict.fromkeys(launch_counts(), 0)
    for n, (b, s, img) in ((1, (batch, prompt_len, image_rows)), (new, (batch, 1, 0))):
        for name, v in forward_counts_of(engine, b, s, img).items():
            want[name] += n * v
    return want


def route_census():
    """Record every routing decision of ``models.moe`` while the block runs:
    each call's (T, k) expert sets, sorted per token, in call order."""
    from repro_torch.models import moe as M

    real, calls = M.route, []

    def recorded(logits, k):
        top_p, top_e = real(logits, k)
        calls.append(torch.sort(top_e, dim=-1).values.cpu())
        return top_p, top_e

    @contextlib.contextmanager
    def scope():
        M.route = recorded
        try:
            yield calls
        finally:
            M.route = real

    return scope()


def moe_main(engine, prompts):
    """The phase's main path: a batched ``generate`` in a counted window, the
    census held to :func:`generate_counts`; captured against eager (every
    decode step's logits, a sampled run's tokens and census, bit for bit;
    the graph's kernel nodes its counted launches, ``inspect_captures``);
    the replayed and eager decode loops profiled (device ms a step, busy
    share, ms by part) → (counts, summary)."""
    from repro_torch.kernels import ternary_mm

    cfg = engine.cfg
    b, s = prompts.shape
    engine.generate(prompts, 2)  # the graph's warm-up and capture
    res, dt, counts, ref_calls = run_counted(lambda: engine.generate(prompts, MOE_NEW))
    expect = generate_counts(engine, b, s, MOE_NEW)
    log(f"  [moe] main path: generate batched ({b}x{s} + {MOE_NEW}, replayed graph) {dt:.3f}s, "
        f"{b * MOE_NEW / dt:.1f} tok/s; launches {json.dumps(counts)} (expected {json.dumps(expect)}), ref-oracle "
        f"dispatches {ref_calls}")
    if counts != expect or ref_calls or ternary_mm.tc_launches:
        raise SystemExit(f"chip_smoke: [moe] main path launches {counts} != {expect} (ref {ref_calls})")
    if not ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise SystemExit("chip_smoke: [moe] bad generated tokens")
    graph_l = decode_loop(engine, prompts, True, MOE_NEW)()
    eager_l = decode_loop(engine, prompts, False, MOE_NEW)()
    runs = {name: run_counted(lambda sc=scan: engine.generate(prompts, MOE_NEW, temperature=0.8, seed=7, scan=sc))
            for name, scan in (("eager", False), ("graph", True))}
    same = dict(logits=bool(torch.equal(graph_l, eager_l)),
                tokens=bool((runs["graph"][0].tokens == runs["eager"][0].tokens).all()),
                census=runs["graph"][2] == runs["eager"][2])
    graph = engine._graphs[(b, None)]
    nodes = {k: v for k, v in GRAPH_NODES[graph].items() if v}
    step = forward_counts_of(engine, b, 1)
    want_nodes = {"bcq_mm+bcq_mm_fused": step["bcq_mm"] + step["bcq_mm_fused"], "expert_mm": step["expert_mm"]}
    tok_s = {name: b * MOE_NEW / runs[name][1] for name in runs}
    prof = {}
    for name, captured in (("graph", True), ("eager", False)):
        loop = decode_loop(engine, prompts, captured, MOE_NEW)
        loop()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        device_ms, _, by_name = device_profile(loop)
        parts = collections.Counter()
        for kname, ms in by_name.items():
            parts["K12" if EXPERT_TAG in kname else "K1/K2" if "BCQGroups" in kname
                  else "sort/scan/scatter/gather/index" if any(tag in kname.lower() for tag in DISPATCH_TAGS)
                  else "the rest"] += ms
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        prof[name] = dict(wall_s=wall, tok_s=b * MOE_NEW / wall, step_device_ms=device_ms / MOE_NEW,
                          busy=device_ms / (wall * 1e3),
                          step_ms_by_part={k: round(v / MOE_NEW, 4) for k, v in parts.items()},
                          top_kernels_step_ms=[(kname[:90], round(ms / MOE_NEW, 4)) for kname, ms in top])
    g, e = prof["graph"], prof["eager"]
    log(f"  [moe] captured against eager ({MOE_NEW} steps at B = {b}): logits equal {same['logits']}, sampled tokens "
        f"equal {same['tokens']}, census equal {same['census']}; the graph's kernel nodes {nodes} (expected "
        f"{want_nodes}), pool {POOL_BYTES[graph] / 1e6:.1f} MB; generate tok/s eager {tok_s['eager']:.1f}, graph "
        f"{tok_s['graph']:.1f}")
    log(f"  [moe] decode loop, a step: replayed {g['step_device_ms']:.3f} device ms ({g['tok_s']:.1f} tok/s, busy "
        f"{g['busy']:.1%}, ms by part {g['step_ms_by_part']}); eager {e['step_device_ms']:.3f} device ms "
        f"({e['tok_s']:.1f} tok/s, busy {e['busy']:.1%}, ms by part {e['step_ms_by_part']})")
    log(f"  [moe] the replayed step's largest kernels, ms a step: {g['top_kernels_step_ms']}")
    whole, banks = moe_dispatch_ms(engine, b)
    n_moe = cfg.block_counts()["attn_moe"]
    dispatch = dict(layer_ms=whole, banks_ms=banks, dispatch_ms=whole - banks, step_dispatch_ms=(whole - banks) * n_moe)
    log(f"  [moe] one MoE layer at B = {b} (graph replays): {whole:.4f} ms, its two K12 launches {banks:.4f} ms, "
        f"so the dispatch (router, sorts, counts, buffers, combine) {whole - banks:.4f} ms, "
        f"{dispatch['step_dispatch_ms']:.3f} ms a step of {n_moe} layers")
    if not all(same.values()) or nodes != want_nodes:
        raise SystemExit(f"chip_smoke: [moe] the replayed graph differs from the eager loop or its nodes from the "
                         f"prediction: {same}, {nodes}")
    return counts, dict(wall_s=dt, tok_s=tok_s, same=same, nodes=nodes, pool_bytes=POOL_BYTES[graph], loops=prof,
                        dispatch=dispatch)


def moe_dispatch_ms(engine, batch):
    """What one MoE layer's dispatch costs at a decode step of ``batch``
    rows, apart from its expert products: ``moe_apply`` on layer 0's
    weights (router, stable sorts, counts, buffers, the banks, combine)
    less its two K12 launches on buffers of the same shape and the same
    routing's row counts, each timed by graph replays → (whole ms, banks ms)."""
    from repro_torch.kernels import expert_linear, expert_linear_pair, linear
    from repro_torch.models import moe as M
    from repro_torch.models.model import layer_slice

    cfg, gen = engine.cfg, torch.Generator(device=DEVICE)
    gen.manual_seed(14)
    p = layer_slice(engine.params["stages"][0]["b0"], 0)["mlp"]
    cap = M.capacity(cfg, batch)
    x = torch.randn((batch, 1, cfg.d_model), generator=gen, device=DEVICE).to(cfg.cdtype)
    _, top_e = M.route(linear(x.reshape(batch, -1), p["router"], out_dtype=torch.float32), cfg.top_k)
    rows = M.dispatch(top_e, cfg.n_experts, cap)[-1]
    live = (torch.arange(cap, device=DEVICE)[None, :] < rows[:, None])[..., None]
    buf = torch.where(live, torch.randn((cfg.n_experts, cap, cfg.d_model), generator=gen, device=DEVICE), 0.0)
    h = torch.where(live, torch.randn((cfg.n_experts, cap, cfg.moe_d_ff), generator=gen, device=DEVICE), 0.0)
    buf, h = buf.to(cfg.cdtype), h.to(cfg.cdtype)
    whole = time_ms(lambda: M.moe_apply(p, cfg, x), [()])
    banks = time_ms(lambda: (expert_linear_pair(buf, p["w_gate"], p["w_up"], rows=rows),
                             expert_linear(h, p["w_down"], rows=rows)), [()])
    return whole, banks


def moe_logits(engine, prompts):
    """The gate: the f32-compute kernel path within ``LOGITS_REL_TOL`` of the
    f32-weight oracle (:func:`logits_distances`, as phase 13's); the bf16
    kernel path's distances to the ref path and the oracle are reported,
    with the share of (token, layer) top-k sets on which the bf16 kernel
    and ref paths route alike (a flip at a near tie moves the logits
    discontinuously) → {distances, routing agreement}."""
    with route_census() as kernel_sets:
        step_logits(engine, prompts, None)
    with route_census() as ref_sets:
        step_logits(engine, prompts, "ref")
    pairs = [(a, b) for ka, kb in zip(kernel_sets, ref_sets) for a, b in zip(ka, kb)]
    agree = sum(bool(torch.equal(a, b)) for a, b in pairs) / max(1, len(pairs))
    d = xlstm_logits_check(engine, "moe main path, prefill + 1 step",
                           lambda eng, mode: step_logits(eng, prompts, mode))
    log(f"  [moe] routing: the bf16 kernel and ref paths chose the same top-{engine.cfg.top_k} set for "
        f"{agree:.2%} of {len(pairs)} (token, layer) pairs")
    return dict(d, routing_agreement=agree, routed_pairs=len(pairs))


def moe_long(engine, rng):
    """One ``MOE_LONG``-token prompt at B = 1 (capacity 80 rows): its prefill
    time and peak memory above the resident model, and its launches."""
    prompt = torch.as_tensor(rng.integers(0, engine.cfg.vocab, (1, MOE_LONG)), device=DEVICE).long()
    engine.prefill(prompt, engine._make_cache(1))  # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (logits, _), dt, counts, ref_calls = run_counted(lambda: engine.prefill(prompt, engine._make_cache(1)))
    peak = torch.cuda.max_memory_allocated() - base
    want = dict.fromkeys(counts, 0)
    want.update(forward_counts_of(engine, 1, MOE_LONG))
    log(f"  [moe long] {MOE_LONG}-token prompt at B = 1: prefill {dt * 1e3:.1f} ms, peak {peak / 1e9:.3f} GB above "
        f"the resident {base / 1e9:.3f} GB; launches {json.dumps(counts)} (expected {json.dumps(want)}), ref-oracle "
        f"dispatches {ref_calls}")
    if counts != want or ref_calls or not torch.isfinite(logits).all():
        raise SystemExit(f"chip_smoke: [moe long] launches {counts} != {want}, ref {ref_calls}, or non-finite")
    return dict(prefill_s=dt, peak_gb=peak / 1e9, resident_gb=base / 1e9, launches=counts)


def moe_refusals(engine):
    """Each of the four paths the reference refuses for MoE raises with the
    reference's words."""
    from repro_torch.infer import Engine, PrefixCache, SpecConfig

    tries = {
        "slots": lambda: engine.init_slots(2),
        "speculation": lambda: engine.generate(np.zeros((1, 4), np.int64), 2, speculate=SpecConfig(SPEC_Q, SPEC_GAMMA)),
        "prefix cache": lambda: Engine(engine.cfg, engine.params, max_seq=64, fuse=False, device="cuda",
                                       prefix_cache=PrefixCache()),
        "chunked prefill": lambda: engine.begin_admission(np.arange(8), max_new_tokens=2, chunked=True),
    }
    said = {}
    for name, fn in tries.items():
        try:
            fn()
            said[name] = None
        except ValueError as e:
            said[name] = str(e)
    ok = {name: said[name] is not None and MOE_REFUSALS[name] in said[name] for name in tries}
    log(f"  [moe] refusals with the reference's words: {ok}")
    if not all(ok.values()):
        raise SystemExit(f"chip_smoke: [moe] a refusal is missing or worded otherwise: {said}")
    return ok


def llama4_reduced(gen):
    """llama4-maverick's three differences from olmoe (a shared expert, top-1,
    dense / MoE interleaving) on the card in bf16 through the kernels, at
    ``LLAMA4_REDUCED``: K12 at its 128-expert bank against its plain
    version; a batched ``generate`` whose census is the prediction, captured
    == eager (logits and sampled tokens) → summary."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, reduced

    cfg = reduced(get_config(LLAMA4), **LLAMA4_REDUCED)
    recs = [check_k12("bcq", cfg.n_experts, cfg.d_model, cfg.moe_d_ff, C, torch.bfloat16, gen, leaf="w_gate/w_up")
            for C in LLAMA4_CAPS]
    if not all(r["ok"] for r in recs):
        raise SystemExit(f"chip_smoke: [llama4] K12 at 128 experts differs from its plain version: {recs}")
    engine = quantized_engine(cfg, init_params(cfg, seed=0, device="cuda"), "bcq", PROMPT_LEN + NEW_TOKENS + 8)
    prompts = np.random.default_rng(41).integers(0, cfg.vocab, (PROMPTS, PROMPT_LEN))
    engine.generate(prompts, 2)
    res, dt, counts, ref_calls = run_counted(lambda: engine.generate(prompts, NEW_TOKENS))
    expect = generate_counts(engine, PROMPTS, PROMPT_LEN, NEW_TOKENS)
    graph_l = decode_loop(engine, prompts, True, NEW_TOKENS)()
    eager_l = decode_loop(engine, prompts, False, NEW_TOKENS)()
    sampled = [engine.generate(prompts, NEW_TOKENS, temperature=0.8, seed=3, scan=sc).tokens for sc in (True, False)]
    same = dict(logits=bool(torch.equal(graph_l, eager_l)), tokens=bool((sampled[0] == sampled[1]).all()))
    log(f"  [llama4 reduced] {cfg.stages}, {cfg.n_experts} experts top-{cfg.top_k}, shared expert "
        f"{cfg.shared_expert}, d_model {cfg.d_model}: generate {PROMPTS}x{PROMPT_LEN} + {NEW_TOKENS} {dt:.3f}s; "
        f"launches {json.dumps(counts)} (expected {json.dumps(expect)}), ref {ref_calls}; captured == eager {same}")
    if counts != expect or ref_calls or not all(same.values()):
        raise SystemExit(f"chip_smoke: [llama4 reduced] launches {counts} != {expect}, ref {ref_calls}, or the "
                         f"replayed graph differs from the eager loop: {same}")
    return dict(stages=str(cfg.stages), wall_s=dt, same=same, launches=counts, k12=recs)


def phase_moe(gen, records):
    """Phase 14 (module docstring) → (summary, K12 records, the main path's counts)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant import quantized_bytes

    cfg = get_config(MOE)
    walls = {}
    t = time.perf_counter()
    k12 = check_k12_banks(gen, cfg)
    flash = [check_flash(B, S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, torch.bfloat16, gen)
             for B, S in ((PROMPTS, PROMPT_LEN), (1, MOE_LONG))]
    if not all(r["ok"] for r in flash):
        raise SystemExit(f"chip_smoke: [moe] K8 at olmoe's heads differs from its plain version: {flash}")
    walls["kernels"] = time.perf_counter() - t
    log(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (Dh {cfg.d_head}), "
        f"{cfg.n_experts} experts top-{cfg.top_k}, moe_d_ff {cfg.moe_d_ff}, vocab {cfg.vocab}, layers "
        f"{cfg.n_layers} {cfg.block_counts()}, {cfg.param_dtype}")
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t:.1f}s ({quantized_bytes(params) / 1e9:.3f} GB dense)")
    engine = quantized_engine(cfg, params, "bcq", MOE_LONG + MOE_NEW + 8)
    del params
    torch.cuda.empty_cache()
    walls["build"] = time.perf_counter() - t
    rng = np.random.default_rng(14)
    prompts = rng.integers(0, cfg.vocab, (PROMPTS, PROMPT_LEN))
    summary = {}
    with kernel_census(by_leaf=True) as seen, k12_census() as banks:
        t = time.perf_counter()
        counts, summary["main"] = moe_main(engine, prompts)
        walls["main"] = time.perf_counter() - t
        for name, fn in (("logits", lambda: moe_logits(engine, prompts)), ("long", lambda: moe_long(engine, rng)),
                         ("refusals", lambda: moe_refusals(engine))):
            t = time.perf_counter()
            summary[name] = fn()
            walls[name] = time.perf_counter() - t
    checked_banks = {("bcq", r["E"], r["C"], r["k"], r["o"], r["dtype"]) for r in k12 if r["leaf"] != "step"}
    unchecked = sorted(set(banks) - checked_banks)
    if unchecked:
        raise SystemExit(f"chip_smoke: [moe] K12 launched at bank shapes it was not held to its plain version at: "
                         f"{unchecked}")
    t = time.perf_counter()
    leaf_of = {(cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim): ("wqkv", (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)),
               (cfg.q_dim, cfg.d_model): ("wo", None), (cfg.d_model, cfg.vocab): ("lm_head", None)}
    summary["checked"] = len(check_launched("moe", seen, None, records, gen, leaf_of))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    summary["llama4_reduced"] = llama4_reduced(gen)
    walls["checked_llama4"] = time.perf_counter() - t
    summary.update(k12_banks=sorted(banks), flash=flash, walls=walls)
    log(f"  [moe] phase wall by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return summary, k12, counts


# -- phase 15: the vlm and audio families (musicgen-medium; llama-3.2-vision-90b at one period) -----

MUSIC = "musicgen-medium"
VISION = "llama-3.2-vision-90b"
FAMILY_NEW = 32  # the batched generates' new tokens
MUSIC_LONG = 512  # frames of the long prompt
# one period of llama-3.2-vision-90b (4 attn blocks, 1 cross block): its 100 layers (90 B parameters) cannot be
# quantized on one card (the dense bf16 model alone is ~180 GB)
VISION_LAYERS = 5
FAMILY_NO_IMAGE_NEW = 8  # the generate without image embeddings


def family_leaves(cfg):
    """{(k, o): (leaf, fused out_dims)} of a vlm or audio model's packed linears."""
    d, qd, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    out = {(d, qd + 2 * kv): ("wqkv", (qd, kv, kv)), (qd, d): ("wo", None), (d, 2 * cfg.d_ff): ("w_gate_up", (cfg.d_ff,) * 2),
           (cfg.d_ff, d): ("w_down", None), (d, cfg.vocab): ("lm_head", None)}
    if cfg.family == "vlm":
        out[(d, qd)] = ("wo/wq" if (d, qd) == (qd, d) else "wq", None)
        out[(d, kv)] = ("wk/wv", None)
    return out


def family_inputs(cfg, seed, batch=PROMPTS, seq=PROMPT_LEN):
    """Seeded inputs on the card: token ids, or bf16 frame embeddings for an
    embeddings-input model; and bf16 image embeddings for a vlm model."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    if cfg.input_kind == "embeddings":
        prompts = torch.randn((batch, seq, cfg.d_model), generator=gen, device=DEVICE).to(torch.bfloat16)
    else:
        prompts = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=DEVICE)
    image = None
    if cfg.family == "vlm":
        image = torch.randn((batch, cfg.n_image_tokens, cfg.d_model), generator=gen, device=DEVICE).to(torch.bfloat16)
    return prompts, image


def generate_input(prompts):
    """What ``Engine.generate`` takes for a prompt of :func:`family_inputs`:
    token ids on the host, frame embeddings as they are."""
    return prompts if prompts.is_floating_point() else prompts.cpu().numpy()


def family_decode_loop(engine, prompts, image, captured, n=FAMILY_NEW):
    """:func:`decode_loop` for the vlm and audio families: the prefill is
    given the image embeddings; an embeddings-input model feeds each greedy
    code back through its ``embed_fn`` (on the host, between steps) →
    a function returning the ``(B, n, V)`` logits."""
    b, s = prompts.shape[:2]
    graph = engine._generate_graph(b) if captured else None
    logits0, cache = engine.prefill(prompts, graph.cache if captured else engine._make_cache(b), image)

    def loop():
        logits, c, out = logits0, cache, []
        for step in range(n):
            tok = torch.argmax(logits, dim=-1)[:, None]
            x = engine._embed(tok.cpu().numpy()) if engine.embed_fn is not None else tok
            if captured:
                logits = graph(x, s + step).clone()
            else:
                logits, c = engine.decode(x, c, s + step)
            out.append(logits)
        return torch.stack(out, dim=1)

    return loop


def family_step_logits(engine, prompts, image, mode):
    """Prefill and one decode step's logits ``(2, B, V)`` under
    ``impl_mode(mode)``, the inputs in the engine's compute dtype (the step
    feeds the prompt's last token or frame again)."""
    from repro_torch.kernels import impl_mode

    dt = engine.cfg.cdtype
    x = prompts.to(dt) if prompts.is_floating_point() else prompts
    img = None if image is None else image.to(dt)
    with impl_mode(mode):
        l0, cache = engine.prefill(x, engine._make_cache(len(x)), img)
        l1, _ = engine.decode(x[:, -1:], cache, x.shape[1])
    return torch.stack([l0, l1])


def cross_attention_ms(engine, batch):
    """One cross block's attention at a decode step of ``batch`` rows, by
    graph replay: ``_sdpa_decode`` of a query row over the whole image
    memory (``layers._memory_decode``), on a cache that holds a projected
    memory → ms (its ``wq`` / ``wo`` are K1's and not in it)."""
    from repro_torch.models import layers as L

    cfg, gen = engine.cfg, torch.Generator(device=DEVICE)
    gen.manual_seed(15)
    shape = (batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.d_head)
    k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(cfg.cdtype) for _ in range(2))
    q = torch.randn((batch, 1, cfg.n_heads, cfg.d_head), generator=gen, device=DEVICE).to(cfg.cdtype)
    return time_ms(lambda: L._memory_decode(q, k, v), [()])


def family_main(label, engine, prompts, image):
    """The main path of a phase 15 model: a batched ``generate`` in a counted
    window, the census held to :func:`generate_counts`; captured
    against eager (every decode step's logits, a sampled run's tokens and
    census, bit for bit; the graph's kernel nodes its counted launches); the
    replayed and eager decode loops profiled (device ms a step, busy share,
    ms by part: K1/K2, K8, the cross attention timed apart, the rest) →
    (counts, summary, greedy result)."""
    from repro_torch.kernels import ternary_mm

    cfg = engine.cfg
    b, s = prompts.shape[:2]
    image_rows = 0 if image is None else b * cfg.n_image_tokens
    gp = generate_input(prompts)
    engine.generate(gp, 2, image_emb=image)  # the graph's warm-up and capture
    res, dt, counts, ref_calls = run_counted(lambda: engine.generate(gp, FAMILY_NEW, image_emb=image))
    expect = generate_counts(engine, b, s, FAMILY_NEW, image_rows)
    log(f"  [{label}] main path: generate batched ({b}x{s} + {FAMILY_NEW}, replayed graph) {dt:.3f}s, "
        f"{b * FAMILY_NEW / dt:.1f} tok/s; launches {json.dumps(counts)} (expected {json.dumps(expect)}), ref-oracle "
        f"dispatches {ref_calls}")
    if counts != expect or ref_calls or ternary_mm.tc_launches:
        raise SystemExit(f"chip_smoke: [{label}] main path launches {counts} != {expect} (ref {ref_calls})")
    want_shape = (b, FAMILY_NEW) if cfg.input_kind == "embeddings" else (b, s + FAMILY_NEW)
    if res.tokens.shape != want_shape or not ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: [{label}] bad generated tokens {res.tokens.shape} (expected {want_shape})")
    graph_l = family_decode_loop(engine, prompts, image, True)()
    eager_l = family_decode_loop(engine, prompts, image, False)()
    runs = {name: run_counted(lambda sc=scan: engine.generate(gp, FAMILY_NEW, image_emb=image, temperature=0.8,
                                                              seed=7, scan=sc))
            for name, scan in (("eager", False), ("graph", True))}
    same = dict(logits=bool(torch.equal(graph_l, eager_l)),
                tokens=bool((runs["graph"][0].tokens == runs["eager"][0].tokens).all()),
                census=runs["graph"][2] == runs["eager"][2])
    graph = engine._graphs[(b, None)]
    nodes = {k: v for k, v in GRAPH_NODES[graph].items() if v}
    step = forward_counts_of(engine, b, 1)
    want_nodes = {"bcq_mm+bcq_mm_fused": step["bcq_mm"] + step["bcq_mm_fused"]}
    tok_s = {name: b * FAMILY_NEW / runs[name][1] for name in runs}
    n_cross = cfg.block_counts().get("cross", 0)
    cross_ms = cross_attention_ms(engine, b) * n_cross if n_cross else 0.0
    prof = {}
    for name, captured in (("graph", True), ("eager", False)):
        loop = family_decode_loop(engine, prompts, image, captured)
        if captured:
            loop()  # the eager loop ran above
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        device_ms, _, by_name = device_profile(loop)
        parts = collections.Counter()
        for kname, ms in by_name.items():
            parts["K1/K2" if "BCQGroups" in kname else "K8" if tagged(kname, FLASH_TAGS) else "other"] += ms / FAMILY_NEW
        parts["the cross attention (timed apart)"] = cross_ms
        parts["the rest"] = parts.pop("other", 0.0) - cross_ms
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        prof[name] = dict(wall_s=wall, tok_s=b * FAMILY_NEW / wall, step_device_ms=device_ms / FAMILY_NEW,
                          busy=device_ms / (wall * 1e3), step_ms_by_part={k: round(v, 4) for k, v in parts.items()},
                          top_kernels_step_ms=[(kname[:90], round(ms / FAMILY_NEW, 4)) for kname, ms in top])
    g, e = prof["graph"], prof["eager"]
    log(f"  [{label}] captured against eager ({FAMILY_NEW} steps at B = {b}): logits equal {same['logits']}, sampled "
        f"tokens equal {same['tokens']}, census equal {same['census']}; the graph's kernel nodes {nodes} (expected "
        f"{want_nodes}), pool {POOL_BYTES[graph] / 1e6:.1f} MB; generate tok/s eager {tok_s['eager']:.1f}, graph "
        f"{tok_s['graph']:.1f}")
    log(f"  [{label}] decode loop, a step: replayed {g['step_device_ms']:.3f} device ms ({g['tok_s']:.1f} tok/s, busy "
        f"{g['busy']:.1%}, ms by part {g['step_ms_by_part']}); eager {e['step_device_ms']:.3f} device ms "
        f"({e['tok_s']:.1f} tok/s, busy {e['busy']:.1%}, ms by part {e['step_ms_by_part']})")
    log(f"  [{label}] the replayed step's largest kernels, ms a step: {g['top_kernels_step_ms']}")
    if not all(same.values()) or nodes != want_nodes:
        raise SystemExit(f"chip_smoke: [{label}] the replayed graph differs from the eager loop or its nodes from the "
                         f"prediction: {same}, {nodes}")
    return counts, dict(wall_s=dt, tok_s=tok_s, same=same, nodes=nodes, pool_bytes=POOL_BYTES[graph], loops=prof,
                        cross_attention_step_ms=cross_ms), res


def family_prefill(label, engine, prompts, image):
    """One prefill of ``prompts`` (with the image embeddings): its time, peak
    memory above the resident model and its launches, held to
    :func:`forward_counts_of`."""
    b, s = prompts.shape[:2]
    engine.prefill(prompts, engine._make_cache(b), image)  # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (logits, _), dt, counts, ref_calls = run_counted(lambda: engine.prefill(prompts, engine._make_cache(b), image))
    peak = torch.cuda.max_memory_allocated() - base
    want = dict.fromkeys(counts, 0)
    want.update(forward_counts_of(engine, b, s, 0 if image is None else b * engine.cfg.n_image_tokens))
    log(f"  [{label} prefill] B = {b}, {s} {'frames' if prompts.is_floating_point() else 'tokens'}"
        f"{'' if image is None else f' + {image.shape[1]} image tokens'}: {dt * 1e3:.1f} ms, peak {peak / 1e9:.3f} GB "
        f"above the resident {base / 1e9:.3f} GB; launches {json.dumps(counts)} (expected {json.dumps(want)}), "
        f"ref-oracle dispatches {ref_calls}")
    if counts != want or ref_calls or not torch.isfinite(logits).all():
        raise SystemExit(f"chip_smoke: [{label} prefill] launches {counts} != {want}, ref {ref_calls}, or non-finite")
    return dict(ms=dt * 1e3, peak_gb=peak / 1e9, resident_gb=base / 1e9, launches=counts)


def family_engine(cfg, seed, max_seq, embed_fn=None):
    """Random weights from ``seed`` on the card, bcq-quantized there (q = 4,
    g = 128, iters = 4), in a serving engine → (engine, dense GB, packed GB,
    quantize s)."""
    from repro_torch.infer import Engine
    from repro_torch.models import init_params
    from repro_torch.quant import QuantPolicy, quantize_params, quantized_bytes

    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    dense = quantized_bytes(params) / 1e9
    log(f"  init {time.perf_counter() - t0:.1f}s ({dense:.3f} GB dense)")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = quantize_params(params, QuantPolicy(q=Q, g=G, iters=4, fmt="bcq"), device="cuda")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    packed = quantized_bytes(qparams) / 1e9
    log(f"  [bcq, {cfg.name}, {cfg.n_layers} layers] quantize_params {quant_s:.1f}s ({packed:.3f} GB packed; solver "
        f"peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB above the dense model)")
    del params
    torch.cuda.empty_cache()
    return Engine(cfg, qparams, max_seq=max_seq, device="cuda", embed_fn=embed_fn), dense, packed, quant_s


def music_phase(gen, records):
    """musicgen-medium at full width and depth → summary (module docstring)."""
    from repro_torch.configs import get_config

    cfg = get_config(MUSIC)
    walls, summary = {}, {}
    t = time.perf_counter()
    flash = [check_flash(B, S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, torch.bfloat16, gen)
             for B, S in ((PROMPTS, PROMPT_LEN), (1, MUSIC_LONG))]
    if not all(r["ok"] for r in flash):
        raise SystemExit(f"chip_smoke: [musicgen] K8 at musicgen's heads differs from its plain version: {flash}")
    walls["flash"] = time.perf_counter() - t
    log(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (Dh {cfg.d_head}), d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, layers {cfg.n_layers} {cfg.block_counts()}, input {cfg.input_kind}, "
        f"{cfg.param_dtype}")
    t = time.perf_counter()
    table = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=DEVICE).to(torch.bfloat16)  # a codebook

    def embed_fn(codes):  # numpy (B, 1) codes → (B, 1, D), the reference's contract
        return table[torch.as_tensor(codes, device=DEVICE).long()[:, 0]][:, None]

    engine, dense, packed, quant_s = family_engine(cfg, 0, MUSIC_LONG + FAMILY_NEW + 8, embed_fn)
    walls["build"] = time.perf_counter() - t
    prompts, _ = family_inputs(cfg, 150)
    summary.update(dense_gb=dense, packed_gb=packed, quantize_s=quant_s, flash=flash)
    with kernel_census(by_leaf=True) as seen:
        t = time.perf_counter()
        counts, summary["main"], _ = family_main("musicgen", engine, prompts, None)
        walls["main"] = time.perf_counter() - t
        t = time.perf_counter()
        summary["prefill"] = family_prefill("musicgen", engine, prompts, None)
        summary["long"] = family_prefill("musicgen", engine, family_inputs(cfg, 151, 1, MUSIC_LONG)[0], None)
        summary["logits"] = xlstm_logits_check(engine, "musicgen main path, prefill + 1 step",
                                               lambda eng, mode: family_step_logits(eng, prompts, None, mode))
        walls["long_logits"] = time.perf_counter() - t
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    summary["checked"] = len(check_launched("musicgen", seen, None, records, gen, family_leaves(cfg)))
    walls["checked"] = time.perf_counter() - t
    summary.update(walls=walls, launches=counts)
    log(f"  [musicgen] wall by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return summary


def vision_phase(gen, records):
    """llama-3.2-vision-90b at full width, one period deep → summary (module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.infer import SpecConfig

    cfg = dataclasses.replace(get_config(VISION), n_layers=VISION_LAYERS, stages=None)
    walls, summary = {}, {}
    t = time.perf_counter()
    flash = [check_flash(PROMPTS, PROMPT_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, torch.bfloat16, gen)]
    rows = PROMPTS * cfg.n_image_tokens
    k1 = check_kernel("bcq_mm", rows, cfg.d_model, cfg.kv_dim, Q, G, torch.bfloat16, gen)
    k1["leaf"] = "wk/wv"
    if not (flash[0]["ok"] and k1["ok"]):
        raise SystemExit(f"chip_smoke: [vision] K8 at its heads or K1 at the image rows differs from its plain "
                         f"version: {flash}, {k1}")
    log(f"  [vision] K1 at the cross block's wk / wv over {rows} image rows: {k1['ms']:.4f} ms, "
        f"{k1['ms'] / k1['bound_ms']:.2f}x its bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}), library "
        f"{k1['library_ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms")
    walls["kernels"] = time.perf_counter() - t
    log(f"  config {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (Dh {cfg.d_head}), d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_image_tokens} image tokens, layers {cfg.n_layers} of "
        f"{get_config(VISION).n_layers} {cfg.stages}, {cfg.param_dtype}")
    t = time.perf_counter()
    engine, dense, packed, quant_s = family_engine(cfg, 0, PROMPT_LEN + FAMILY_NEW + SPEC_GAMMA + 8)
    walls["build"] = time.perf_counter() - t
    prompts, image = family_inputs(cfg, 160)
    summary.update(dense_gb=dense, packed_gb=packed, quantize_s=quant_s, flash=flash, k1_image_rows=k1)
    with kernel_census(by_leaf=True) as seen:
        t = time.perf_counter()
        counts, summary["main"], plain = family_main("vision", engine, prompts, image)
        walls["main"] = time.perf_counter() - t
        t = time.perf_counter()
        summary["prefill"] = family_prefill("vision", engine, prompts, image)
        spec, dt, spec_counts, ref_calls = run_counted(
            lambda: engine.generate(generate_input(prompts), FAMILY_NEW, image_emb=image,
                                    speculate=SpecConfig(SPEC_Q, SPEC_GAMMA)))
        st = spec.spec_stats
        same = bool((spec.tokens == plain.tokens).all())
        flash_want = 2 * cfg.block_counts()["attn"]  # the target's and the draft's prefills
        log(f"  [vision spec] SpecConfig({SPEC_Q}, {SPEC_GAMMA}) greedy == plain {same}; acceptance "
            f"{st['accept_rate']:.3f} ({st['accepted']}/{st['proposed']}, {st['chunks']} chunks), {dt:.3f}s "
            f"({PROMPTS * FAMILY_NEW / dt:.1f} tok/s against the plain run's "
            f"{summary['main']['tok_s']['graph']:.1f}); K8 {spec_counts['flash_attention']} (expected {flash_want}), "
            f"ref-oracle dispatches {ref_calls}")
        if not same or ref_calls or spec_counts["flash_attention"] != flash_want:
            raise SystemExit(f"chip_smoke: [vision spec] speculative tokens differ from plain greedy ({same}), or "
                             f"launches {spec_counts}, ref {ref_calls}")
        summary["spec"] = dict(same=same, wall_s=dt, **{k: st[k] for k in ("accept_rate", "accepted", "proposed",
                                                                           "chunks", "committable")})
        none = engine.generate(generate_input(prompts), FAMILY_NO_IMAGE_NEW)
        zero = engine.generate(generate_input(prompts), FAMILY_NO_IMAGE_NEW, image_emb=torch.zeros_like(image))
        l_none = engine.prefill(prompts, engine._make_cache(PROMPTS))[0]
        l_zero = engine.prefill(prompts, engine._make_cache(PROMPTS), torch.zeros_like(image))[0]
        no_image = dict(tokens=bool((none.tokens == zero.tokens).all()), logits=bool(torch.equal(l_none, l_zero)))
        log(f"  [vision] generate without image embeddings == with zeroed ones: {no_image}")
        if not all(no_image.values()):
            raise SystemExit(f"chip_smoke: [vision] a generate without image embeddings differs from one given "
                             f"zeroed image memory: {no_image}")
        summary["no_image"] = no_image
        summary["logits"] = xlstm_logits_check(engine, "vision main path, prefill + 1 step",
                                               lambda eng, mode: family_step_logits(eng, prompts, image, mode))
        walls["spec_logits"] = time.perf_counter() - t
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    summary["checked"] = len(check_launched("vision", seen, None, records + [k1], gen, family_leaves(cfg)))
    walls["checked"] = time.perf_counter() - t
    summary.update(walls=walls, launches=counts)
    log(f"  [vision] wall by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return summary


def phase_families(gen, records):
    """Phase 15 (module docstring) → summary."""
    return dict(musicgen=music_phase(gen, records), vision=vision_phase(gen, records))


# -- phase 16: tensor-parallel serving, two ranks on one card ------------------

TP_RANKS = 2
# the bit-for-bit gates' depth: the first 8 of llama3.2-3b's 28 layers (the smoke's time budget)
TP_GATE_LAYERS = 8
TP_LOGIT_TOL = 1e-3  # the reference's LOGIT_TOL (tests/test_tp_serve.py:135), here of max|logit|
TP_SPEC = (2, 4)
TP_TIMEOUT_S = 300  # the ranks' whole run, their rendezvous and every collective
TP_STEPS = 8  # decode steps profiled a rank
TP_PART_TAGS = {"K1/K2": ("BCQGroups",), "K8": FLASH_TAGS, "collectives": ("Memcpy", "gloo", "nccl")}


def tp_leaves(cfg, n):
    """{(k, o): (leaf, fused out_dims)} of one rank's shards of llama3.2-3b's
    packed linears at tp = ``n``."""
    qd, kvd, d, ff = cfg.q_dim // n, cfg.kv_dim // n, cfg.d_model, cfg.d_ff // n
    return {(d, qd + 2 * kvd): ("wqkv", (qd, kvd, kvd)), (qd, d): ("wo", None), (d, 2 * ff): ("w_gate_up", (ff, ff)),
            (ff, d): ("w_down", None), (d, cfg.vocab // n): ("lm_head", None)}


def by_part(by_name, steps):
    """{part: device ms a step} of a profile's {kernel: ms}: K1/K2, K8, the
    collectives' device work (gloo's copies between card and host), the
    rest."""
    out = dict.fromkeys((*TP_PART_TAGS, "rest"), 0.0)
    for name, ms in by_name.items():
        part = next((p for p, tags in TP_PART_TAGS.items() if tagged(name, tags)), "rest")
        out[part] += ms / steps
    return out


def tp_profile(engine, prompts):
    """Device ms a step by part (:func:`by_part`) of ``TP_STEPS`` decode steps
    and of the batched prefill, and the host's wall a decode step."""
    toks = torch.as_tensor(prompts, device=DEVICE, dtype=torch.long)
    cache = engine._make_cache(len(prompts))
    state = {}

    def prefill():
        state["logits"], _ = engine.prefill(toks, cache)

    def decode():
        tok = state["logits"].argmax(-1)[:, None]
        for i in range(TP_STEPS):
            logits, _ = engine.decode(tok, cache, toks.shape[1] + i)
            tok = logits.argmax(-1)[:, None]

    pre_ms, _, pre_names = device_profile(prefill)
    dec_ms, wall_ms, dec_names = device_profile(decode)
    return dict(prefill=by_part(pre_names, 1), prefill_ms=pre_ms, decode=by_part(dec_names, TP_STEPS),
                decode_ms=dec_ms / TP_STEPS, decode_wall_ms=wall_ms / TP_STEPS)


def tp_gates(engine_of, full, prompts):
    """The bit-for-bit gates inside one TP engine at ``TP_GATE_LAYERS``
    layers: slot == solo (phase 6's 12 requests, 4 slots, chunk 8), spec ==
    plain (``SpecConfig(*TP_SPEC)``), warm == cold (phase 8's requests on a
    512-token shared prompt) → {gate: tokens and verdicts}."""
    from repro_torch.infer import PrefixCache, SpecConfig
    from repro_torch.launch.serve import drive_continuous

    cfg, params = layer_head(*full, TP_GATE_LAYERS)
    out = {}

    def run(engine, reqs):
        _, done, _ = drive_continuous(engine, reqs, np.zeros(len(reqs)), n_slots=SERVE_SLOTS, chunk=SERVE_CHUNK)
        got = {c.rid: np.asarray(c.new_tokens) for c in done}
        return [got[r.rid] for r in reqs]

    engine = engine_of(cfg, params, max(SERVE_PROMPT_LENS) + NEW_TOKENS + 8)
    reqs = serve_requests(cfg, SERVE_PROMPT_LENS, NEW_TOKENS, 200)
    solos = [engine.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
             .tokens[0, r.prompt.size:] for r in reqs]
    slots = run(engine, serve_requests(cfg, SERVE_PROMPT_LENS, NEW_TOKENS, 200))
    out["slot == solo"] = dict(ok=all(np.array_equal(a, b) for a, b in zip(slots, solos)), tokens=slots)
    plain = engine.generate(prompts, NEW_TOKENS).tokens
    spec = engine.generate(prompts, NEW_TOKENS, speculate=SpecConfig(*TP_SPEC))
    out["spec == plain"] = dict(ok=bool(np.array_equal(spec.tokens, plain)), tokens=spec.tokens,
                                accepted=spec.spec_stats["accepted"], proposed=spec.spec_stats["proposed"])
    del engine
    max_seq = PREFIX_LEN + max(PREFIX_TAILS) + NEW_TOKENS + 8
    warm = engine_of(cfg, params, max_seq, prefix_cache=PrefixCache(block_tokens=PREFIX_BLOCK,
                                                                      max_bytes=PREFIX_CACHE_BYTES))
    run(warm, prefix_requests(cfg))  # fills the cache
    hits = warm.prefix_cache.counters["hits"]
    warm_tokens = run(warm, prefix_requests(cfg))
    hits = warm.prefix_cache.counters["hits"] - hits
    del warm
    cold = run(engine_of(cfg, params, max_seq), prefix_requests(cfg))
    out["warm == cold"] = dict(ok=hits > 0 and all(np.array_equal(a, b) for a, b in zip(warm_tokens, cold)),
                               tokens=warm_tokens, warm_hits=hits)
    return out


def tp_rank(rank, n, path, prompts):
    """One rank of phase 16: loads phase 5's packed weights (built kernels
    only: a rank never compiles), serves the f32-compute and the bf16 model
    at 28 layers (counted, profiled, timed), runs the gates of
    :func:`tp_gates`, holds every launched shape to its plain version, and
    on rank 0 times K1/K2 at each shard leaf → results for the parent."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.infer import Engine
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.parallel import collective_counts, make_tp_mesh, reset_collective_counts
    from repro_torch.quant import quantized_bytes

    missing = [k for k in _build.kernel_names() if not _build._lib_path(k).exists()]
    if missing:
        raise RuntimeError(f"rank {rank}: kernels {missing} are not built; the parent builds them, a rank never does")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_tp_mesh(n)
    cfg = get_config("llama3.2-3b")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    t0 = time.perf_counter()
    params = torch.load(path, map_location="cpu", mmap=True, weights_only=False)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1600 + rank)
    seen = {torch.float32: collections.Counter(), torch.bfloat16: collections.Counter()}
    attn = collections.Counter()
    out = dict(rank=rank, backend=mesh.backend, device=str(torch.cuda.current_device()))

    def engine_of(cfg_, params_, max_seq, **kw):
        return Engine(cfg_, params_, max_seq=max_seq, device="cuda", mesh=mesh, **kw)

    max_seq = PROMPT_LEN + NEW_TOKENS + 8
    with kernel_census(by_leaf=True) as s32, flash_census() as a32:
        eng = engine_of(cfg32, params, max_seq)
        out["load_s"] = time.perf_counter() - t0
        out["local_gb"] = quantized_bytes(eng.params) / 1e9
        torch.cuda.synchronize()
        reset_launch_counts()
        reset_collective_counts()
        res = eng.generate(prompts, NEW_TOKENS)  # the f32-compute arm's main path
        torch.cuda.synchronize()
        out["f32"] = dict(tokens=res.tokens, captured=res.captured, launches=launch_counts(),
                          collectives=collective_counts(), logits=step_logits(eng, prompts, None).cpu().numpy())
    seen[torch.float32].update(s32)
    attn.update(a32)
    del eng
    with kernel_census(by_leaf=True) as s16, flash_census() as a16:
        eng = engine_of(cfg, params, max_seq)
        eng.generate(prompts, 2)  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        reset_collective_counts()
        t1 = time.perf_counter()
        res = eng.generate(prompts, NEW_TOKENS)  # the bf16 arm's main path
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        out["bf16"] = dict(tokens=res.tokens, launches=launch_counts(), collectives=collective_counts(),
                           tok_s=len(prompts) * NEW_TOKENS / wall, wall_s=wall,
                           logits=step_logits(eng, prompts, None).cpu().numpy())
        out["profile"] = tp_profile(eng, prompts)
        del eng
        t1 = time.perf_counter()
        out["gates"] = tp_gates(engine_of, (cfg, params), prompts)
        out["gates_s"] = time.perf_counter() - t1
    seen[torch.bfloat16].update(s16)
    attn.update(a16)
    heads = (cfg.n_heads // n, cfg.n_kv_heads // n, cfg.d_head)
    leaf_of = tp_leaves(cfg, n)
    checks = check_launched(f"tp rank {rank} f32", seen[torch.float32], None, [], gen, leaf_of, heads, torch.float32)
    checks += check_launched(f"tp rank {rank} bf16", seen[torch.bfloat16], attn, [], gen, leaf_of, heads)
    out["checked"] = len(checks)
    out["shapes"] = sorted({(k, o) for _, _, _, k, o in (*seen[torch.float32], *seen[torch.bfloat16])})
    out["leaves"] = []
    if rank == 0:  # the other rank waits: the two share the card
        for (k, o), (leaf, dims) in leaf_of.items():
            name = "bcq_mm_fused" if dims else "bcq_mm"
            rec = check_kernel(name, PROMPTS, k, o, Q, G, torch.bfloat16, gen, dims)
            rec["leaf"] = leaf
            out["leaves"].append(rec)
    dist.barrier()
    return out


def tp_reference(path, prompts):
    """tp = 1 in this process on the same packed weights: greedy tokens and
    prefill + one step's logits of the f32-compute and the bf16 model (the
    kernel path), and the f32-weight oracle's logits (the f32-compute model
    under ``impl_mode("ref")``)."""
    from repro_torch.configs import get_config
    from repro_torch.infer import Engine

    cfg = get_config("llama3.2-3b")
    params = torch.load(path, map_location="cuda", weights_only=False)
    out = {}
    for arm, c in (("f32", dataclasses.replace(cfg, compute_dtype="float32")), ("bf16", cfg)):
        eng = Engine(c, params, max_seq=PROMPT_LEN + NEW_TOKENS + 8, fuse=False, device="cuda")
        out[arm] = dict(tokens=eng.generate(prompts, NEW_TOKENS).tokens,
                        logits=step_logits(eng, prompts, None).cpu().numpy())
        if arm == "f32":
            out["oracle"] = step_logits(eng, prompts, "ref").cpu().numpy()
        del eng
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def first_difference(a, b):
    """(row, generated step) of the first token where ``a`` and ``b`` differ, or None."""
    diff = np.argwhere(a[:, PROMPT_LEN:] != b[:, PROMPT_LEN:])
    return None if not len(diff) else tuple(int(v) for v in diff[0])


def phase_tp(path, prompts):
    """Phase 16 (module docstring) → (summary, rank 0's launches on the main path)."""
    from repro_torch.configs import get_config
    from repro_torch.launch._ranks import describe, run_ranks

    cfg = get_config("llama3.2-3b")
    L = cfg.n_layers
    t0 = time.perf_counter()
    ref = tp_reference(path, prompts)
    log(f"  tp = 1 references (f32-compute, bf16, the f32-weight oracle) in {time.perf_counter() - t0:.1f}s")
    log(f"  {describe(TP_RANKS)}")
    t0 = time.perf_counter()
    ranks = run_ranks(tp_rank, TP_RANKS, (str(path), prompts), device="cuda", timeout=TP_TIMEOUT_S)
    log(f"  ranks ran in {time.perf_counter() - t0:.1f}s (spawn, load, shard, both arms, gates, checks)")
    r0 = ranks[0]
    bad = []
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())  # noqa: E731
    forwards = 1 + NEW_TOKENS
    for r in ranks:
        for arm in ("f32", "bf16"):
            got = r[arm]
            want = {"all_reduce": 2 * L * forwards, "all_gather": forwards, "broadcast": 0}
            if got["collectives"] != want:
                bad.append(f"rank {r['rank']} {arm}: collectives {got['collectives']} != 2L+1 a forward {want}")
            if not all(got["launches"][k] for k in ("bcq_mm", "bcq_mm_fused", "flash_attention")):
                bad.append(f"rank {r['rank']} {arm}: K1/K2/K8 not all launched on the main path: {got['launches']}")
        log(f"  [tp rank {r['rank']}] {r['backend']} on cuda:{r['device']}: loaded and sharded in {r['load_s']:.1f}s "
            f"({r['local_gb']:.3f} GB held), launches f32 {json.dumps(r['f32']['launches'])}, collectives "
            f"{r['f32']['collectives']} ({2 * L + 1} a forward x {forwards}), captured {r['f32']['captured']}; "
            f"{r['checked']} launched shapes held to their plain versions, shard (k, o) {r['shapes']}")
    for r in ranks[1:]:  # every rank the same tokens and logits (gathered whole)
        for arm in ("f32", "bf16"):
            for key in ("tokens", "logits"):
                if not np.array_equal(r[arm][key], r0[arm][key]):
                    bad.append(f"rank {r['rank']} {arm} {key} differ from rank 0's")
        for gate, g in r["gates"].items():
            if not all(np.array_equal(a, b) for a, b in zip(g["tokens"], r0["gates"][gate]["tokens"])):
                bad.append(f"rank {r['rank']} [{gate}] tokens differ from rank 0's")
    # 1. the f32-compute arm: tokens == tp = 1, logits within 1e-3 of max|logit|
    d32 = rel(r0["f32"]["logits"], ref["f32"]["logits"])
    same32 = bool(np.array_equal(r0["f32"]["tokens"], ref["f32"]["tokens"]))
    log(f"  [tp f32-compute, {L} layers] greedy tokens == tp = 1: {same32}; prefill + step logits max|d| / max|.| "
        f"{d32:.3e} (tol {TP_LOGIT_TOL:g}); against the f32-weight oracle {rel(r0['f32']['logits'], ref['oracle']):.3e}")
    if not same32:
        bad.append(f"f32 tokens differ from tp = 1 at {first_difference(r0['f32']['tokens'], ref['f32']['tokens'])}")
    if not d32 <= TP_LOGIT_TOL:
        bad.append(f"f32 logits {d32:.3e} of max|logit| from tp = 1 (tol {TP_LOGIT_TOL})")
    # 2. the bf16 arm: reported; the port's watch rule
    d16, d16o = rel(r0["bf16"]["logits"], ref["bf16"]["logits"]), rel(r0["bf16"]["logits"], ref["oracle"])
    d1o = rel(ref["bf16"]["logits"], ref["oracle"])
    first = first_difference(r0["bf16"]["tokens"], ref["bf16"]["tokens"])
    watch = "WATCH (ROADMAP Queue 3)" if d16 > LOGITS_REL_TOL else "under the watch rule"
    log(f"  [tp bf16, {L} layers] logits max|d| / max|.|: tp = 2 vs tp = 1 {d16:.3e} ({watch}, {LOGITS_REL_TOL:g}); "
        f"against the f32-weight oracle tp = 2 {d16o:.3e}, tp = 1 {d1o:.3e}; first differing token (row, step): "
        f"{first}")
    # 3. the bit-for-bit gates at TP_GATE_LAYERS layers
    for gate, g in r0["gates"].items():
        extra = {k: v for k, v in g.items() if k not in ("ok", "tokens")}
        log(f"  [tp {gate}, {TP_GATE_LAYERS} layers] {'ok' if g['ok'] else 'FAIL'} {extra}")
        if not all(r["gates"][gate]["ok"] for r in ranks):
            bad.append(f"[{gate}] failed at tp = {TP_RANKS}")
    # 4. the decode step by part, K1/K2 at the shard leaves, tok/s
    card = torch.cuda.get_device_name(0)
    for r in ranks:
        p = r["profile"]
        parts = ", ".join(f"{k} {v:.3f}" for k, v in p["decode"].items())
        pre = ", ".join(f"{k} {v:.3f}" for k, v in p["prefill"].items())
        log(f"  [tp rank {r['rank']}] bf16 decode step B={PROMPTS}: device {p['decode_ms']:.3f} ms ({parts}), host "
            f"wall {p['decode_wall_ms']:.3f} ms; prefill {PROMPTS}x{PROMPT_LEN}: device {p['prefill_ms']:.3f} ms "
            f"({pre}); generate {r['bf16']['tok_s']:.1f} tok/s on one {card} shared by {TP_RANKS} ranks (not a TP "
            f"speed figure); gates {r['gates_s']:.1f}s")
    for rec in r0["leaves"]:
        log(f"  [tp shard] {rec['kernel']:12s} {rec['leaf']:9s} k={rec['k']:<5d} o={rec['o']:<6d} B={rec['B']} "
            f"{rec['ms'] * 1e3:8.2f} us = {rec['ms'] / rec['bound_ms']:5.1f}x its bound {rec['bound_ms'] * 1e3:.2f} us "
            f"({rec['bound_by']}), plain {rec['plain_ms'] * 1e3:.1f} us, library {rec['library_ms'] * 1e3:.2f} us, "
            f"err {rec['max_abs_err']:.2e} {'ok' if rec['ok'] else 'FAIL'}")
        if not rec["ok"]:
            bad.append(f"{rec['kernel']} at shard {rec['leaf']} disagrees with its plain version")
    if bad:
        raise SystemExit(f"chip_smoke: [tp] {len(bad)} failures: {bad}")
    summary = dict(ranks=TP_RANKS, f32_logits_rel=d32, bf16_logits_rel=d16, bf16_oracle_rel=d16o,
                   tp1_bf16_oracle_rel=d1o, bf16_first_difference=first, watch=d16 > LOGITS_REL_TOL,
                   profiles=[r["profile"] for r in ranks], tok_s=[r["bf16"]["tok_s"] for r in ranks],
                   leaves=[{k: v for k, v in rec.items()} for rec in r0["leaves"]],
                   gates={gate: {k: v for k, v in g.items() if k != "tokens"} for gate, g in r0["gates"].items()},
                   checked=[r["checked"] for r in ranks])
    launches = collections.Counter(r0["f32"]["launches"]) + collections.Counter(r0["bf16"]["launches"])
    return summary, launches


TRAIN = "llama3.2-3b"
TRAIN_STEPS = 8  # full-width train steps through launch/train.py
TRAIN_BATCH, TRAIN_SEQ = 4, 256
TRAIN_LR = 3e-4
TRAIN_NEW = 16  # the trained model's batched generate: 4 x 16 + 16
TRAIN_NLL_SEED = 20_000  # a MarkovCorpus batch no train step drew
# card against CPU: one loss_fn gradient of a reduced f32 llama3.2-3b, the
# largest leaf error relative to that leaf's max|g| (stated before the first
# card run: f32 sums in other orders through 2 layers, ~1e-6 expected)
GRAD_TOL = 1e-4
GRAD_REDUCED = dict(d_model=256, n_layers=2, vocab=512)
CKPT_STEPS, CKPT_PREEMPT_AT = 6, 2  # the reduced CLI run: SIGTERM after step 2, resume to 6


def train_cli(argv, log_fn):
    """``launch/train.py``'s ``main(argv)`` with its log lines sent to
    ``log_fn``; the SIGTERM / SIGINT handlers its ``PreemptionGuard`` installs
    are put back after → main's (cfg, params, opt, history)."""
    import signal

    from repro_torch.launch import train as train_mod

    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        return train_mod.main(argv, log=log_fn)
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)


def train_full_width(dry=None):
    """llama3.2-3b at full width and depth, bf16, ``TRAIN_STEPS`` steps of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens through the CLI, held to the dry
    run's arguments and peak (:func:`dryrun_train_check`) when given one
    (``tools/train_logits_probe.py`` gives none) → (cfg, params, summary)."""
    from repro_torch.data import MarkovCorpus, batch_iterator
    from repro_torch.quant import quantized_bytes
    from repro_torch.utils import tree_leaves

    lines = []

    def tlog(msg):
        lines.append(msg)
        log(f"  [train] {msg}")

    from repro_torch.train import step as step_mod

    real_update, update_s = step_mod.adamw_update, []

    def timed_update(*a, **kw):  # the AdamW share of a step, between two syncs
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_update(*a, **kw)
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step_mod.adamw_update = timed_update
    try:
        cfg, params, opt, history = train_cli(
            ["--arch", TRAIN, "--full-size", "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH), "--seq",
             str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--log-every", "1", "--device", "cuda"], tlog)
    finally:
        step_mod.adamw_update = real_update
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n_params = sum(p.numel() for p in tree_leaves(params))
    step_ms = [float(m.group(1)) for m in (re.search(r"\((\d+) ms\)", line) for line in lines if line.startswith("step"))
               if m]
    steady = statistics.median(step_ms[1:])
    losses = [loss for _, loss in history]
    adamw_ms = statistics.median(update_s[1:]) * 1e3
    stragglers = sum(line.startswith("[straggler]") for line in lines)
    summary = dict(layers=cfg.n_layers, params=n_params, dense_gb=quantized_bytes(params) / 1e9, losses=losses,
                   step_ms=step_ms, steady_step_ms=steady, adamw_ms=adamw_ms,
                   tok_s=TRAIN_BATCH * TRAIN_SEQ / (steady / 1e3), wall_s=wall, peak_gb=peak / 1e9,
                   stragglers=stragglers)
    log(f"  [train] {cfg.name} at full width, {cfg.n_layers} layers, {n_params / 1e9:.3f} B parameters "
        f"({cfg.param_dtype}), {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens (remat, AdamW lr "
        f"{TRAIN_LR:g}) in {wall:.1f}s: loss {losses[0]:.4f} -> {losses[-1]:.4f}; a step {steady:.0f} ms (the median "
        f"of steps 1..{TRAIN_STEPS - 1}; step 0 {step_ms[0]:.0f} ms; of it AdamW {adamw_ms:.1f} ms, the median after "
        f"step 0, the rest forward and backward), {summary['tok_s']:.0f} tok/s; peak {peak / 1e9:.3f} GB (params, "
        f"gradients, moments and activations); stragglers {stragglers}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: [train] the loss did not fall, or is not finite: {losses}")
    if dry is not None:  # the step's arguments as the card holds them: params, AdamW state, a batch of the CLI's
        batch = next(batch_iterator(MarkovCorpus(cfg.vocab, seed=0), batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
        nbytes = lambda leaves: sum(t.numel() * t.element_size() for t in leaves)  # noqa: E731
        resident = {"params": nbytes(tree_leaves(params)),
                    "opt": nbytes([opt.step, *tree_leaves(opt.m), *tree_leaves(opt.v)]),
                    "batch": nbytes([torch.from_numpy(v).to(DEVICE) for v in batch.values()])}
        summary["dryrun"] = dryrun_train_check(dry, resident, peak)
    del opt
    return cfg, params, summary


def train_serve(cfg, params, records, gen):
    """The trained weights quantized to bcq on the card (q = 4, g = 128,
    iters = 4) and served: a batched ``generate`` (4 x 16 + 16) in a
    counted window, every launched K1/K2 and K8 shape held to its plain
    version; the held-out NLL of the dense and the quantized model; the
    logits of the kernel path against the ref path and the f32-weight
    oracle → (launch counts, summary)."""
    from repro_torch.data import MarkovCorpus
    from repro_torch.infer import Engine
    from repro_torch.models import forward
    from repro_torch.train import cross_entropy

    packed = quantize_format(cfg, params, "bcq")
    engine = Engine(cfg, packed, max_seq=PROMPT_LEN + TRAIN_NEW + 8, device="cuda")
    corpus = MarkovCorpus(cfg.vocab, seed=0)
    prompts = torch.from_numpy(corpus.sample(PROMPTS, PROMPT_LEN, seed=TRAIN_NLL_SEED + 1)[:, :PROMPT_LEN]).to(DEVICE)
    gp = generate_input(prompts)
    engine.generate(gp, 2)  # the graph's warm-up and capture
    with kernel_census(by_leaf=True) as seen, flash_census() as attn:
        res, dt, counts, ref_calls = run_counted(lambda: engine.generate(gp, TRAIN_NEW))
    expect = generate_counts(engine, PROMPTS, PROMPT_LEN, TRAIN_NEW)
    log(f"  [train serve] the trained weights, bcq: generate batched ({PROMPTS}x{PROMPT_LEN} + {TRAIN_NEW}, replayed "
        f"graph) {dt:.3f}s, {PROMPTS * TRAIN_NEW / dt:.1f} tok/s; launches {json.dumps(counts)} (expected "
        f"{json.dumps(expect)}), ref-oracle dispatches {ref_calls}")
    if (counts != expect or ref_calls or not counts["bcq_mm"] or not counts["bcq_mm_fused"]
            or not counts["flash_attention"]):
        raise SystemExit(f"chip_smoke: [train serve] launches {counts} != {expect} (ref {ref_calls})")
    if res.tokens.shape != (PROMPTS, PROMPT_LEN + TRAIN_NEW) or not ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: [train serve] bad generated tokens {res.tokens.shape}")
    # held-out next-token NLL, dense against bcq (the paper's Figs. 5/6 quantity; reported)
    batch = corpus.sample(TRAIN_BATCH, TRAIN_SEQ, seed=TRAIN_NLL_SEED)
    toks, labels = (torch.from_numpy(a).to(DEVICE) for a in (batch[:, :-1], batch[:, 1:].astype(np.int32)))
    with torch.no_grad():
        nll = {name: cross_entropy(forward(cfg, p, tokens=toks)[0], labels).item()
               for name, p in (("dense", params), ("bcq", engine.params))}
    log(f"  [train serve] held-out NLL ({TRAIN_BATCH} x {TRAIN_SEQ} tokens, corpus seed {TRAIN_NLL_SEED}): dense "
        f"{nll['dense']:.4f}, bcq q = {Q} {nll['bcq']:.4f} ({nll['bcq'] - nll['dense']:+.4f}; reported)")
    run = lambda eng, mode: family_step_logits(eng, prompts, None, mode)  # noqa: E731
    logits = xlstm_logits_check(engine, "train serve, prefill + 1 step", run)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    checked = check_launched("train serve", seen, attn, records, gen)
    return counts, dict(generate_s=dt, tok_s=PROMPTS * TRAIN_NEW / dt, nll=nll, logits=logits, checked=len(checked),
                        launches=counts)


def train_grads_and_guard():
    """One ``loss_fn`` gradient of a reduced f32 llama3.2-3b on the card
    against the CPU's (same init and batch), and the forward-only guard: a
    CUDA forward with grad-requiring inputs outside ``impl_mode("ref")``
    raises, for K8 and for K1, and through the model → summary."""
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovCorpus, batch_iterator
    from repro_torch.kernels import bcq_mm, flash_attention
    from repro_torch.models import forward, init_params, reduced
    from repro_torch.train import loss_and_grads
    from repro_torch.train.checkpoint import leaf_paths
    from repro_torch.utils import tree_map

    cfg = reduced(get_config(TRAIN), **GRAD_REDUCED)
    cpu = init_params(cfg, seed=0, device="cpu")
    card = tree_map(lambda t: t.to(DEVICE), cpu)
    batch = next(batch_iterator(MarkovCorpus(cfg.vocab, seed=0), batch=TRAIN_BATCH, seq_len=64))
    got = {}
    for name, p, dev in (("cpu", cpu, "cpu"), ("card", card, DEVICE)):
        got[name] = loss_and_grads(cfg, p, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    errs = {}
    for (key, gc_), (_, gg) in zip(leaf_paths(got["cpu"][1]), leaf_paths(got["card"][1])):
        errs[key] = (gg.cpu() - gc_).abs().max().item() / max(gc_.abs().max().item(), 1e-30)
    worst = max(errs, key=errs.get)
    loss_d = abs(got["card"][0]["loss"].item() - got["cpu"][0]["loss"].item())
    log(f"  [train grads] reduced f32 {cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} layers, vocab {cfg.vocab}), "
        f"one loss_fn gradient, card against CPU: loss {got['card'][0]['loss'].item():.6f} (|d| {loss_d:.2e}); "
        f"largest leaf error / the leaf's max|g| {errs[worst]:.3e} at {worst} (tol {GRAD_TOL:g}), median "
        f"{statistics.median(errs.values()):.3e} over {len(errs)} leaves")
    if not errs[worst] <= GRAD_TOL:
        raise SystemExit(f"chip_smoke: [train grads] card and CPU gradients differ by {errs[worst]:.3e} at {worst}")
    # the guard: each forward-only kernel refuses a grad-requiring input outside the ref route
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(17)
    q = torch.randn((1, 16, 24, 128), generator=gen, device=DEVICE).to(torch.bfloat16).requires_grad_(True)
    kv = torch.randn((1, 16, 8, 128), generator=gen, device=DEVICE).to(torch.bfloat16)
    x = torch.randn((4, 3072), generator=gen, device=DEVICE).requires_grad_(True)
    packed, scales = format_planes("bcq", 3072, 3072, Q, G, gen)
    grad_card = tree_map(lambda t: t.detach().requires_grad_(True), card)
    raised = {}
    for name, call in (("flash_attention", lambda: flash_attention(q, kv, kv)),
                       ("bcq_mm", lambda: bcq_mm(x, packed, scales, g=G)),
                       ("forward (K8)", lambda: forward(cfg, grad_card, tokens=torch.zeros((1, 8), dtype=torch.long,
                                                                                          device=DEVICE)))):
        try:
            call()
            raised[name] = None
        except RuntimeError as e:
            raised[name] = str(e).split(":")[0]
    log(f"  [train guard] a CUDA forward with grad-requiring inputs outside impl_mode('ref') raises: {raised}")
    if not all(raised.values()):
        raise SystemExit(f"chip_smoke: [train guard] a forward-only kernel took a grad-requiring input: {raised}")
    with torch.no_grad():
        bcq_mm(x, packed, scales, g=G)  # no_grad: the same inputs launch
    return dict(loss=got["card"][0]["loss"].item(), loss_abs_diff=loss_d, worst_rel=errs[worst], worst_leaf=worst,
                guard=raised)


def train_checkpoints():
    """The reduced config through the CLI with ``--ckpt-dir`` on the card: a
    SIGTERM after step ``CKPT_PREEMPT_AT`` stops the run with a final
    checkpoint at that step, which restores bit for bit onto the card; a
    rerun resumes from it and continues the step count to ``CKPT_STEPS`` →
    summary."""
    import os
    import signal

    from repro_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        argv = ["--steps", str(CKPT_STEPS), "--ckpt-dir", d, "--log-every", "1", "--device", "cuda"]
        lines = []

        def preempt(msg):
            lines.append(msg)
            if msg.startswith(f"step {CKPT_PREEMPT_AT:5d}"):
                os.kill(os.getpid(), signal.SIGTERM)  # the guard's handler sets its stop flag

        _, params, opt, _ = train_cli(argv, preempt)
        stopped = ckpt.latest_step(d)
        restored = ckpt.restore(d, stopped, {"params": params, "opt": opt})
        pairs = list(zip(ckpt.leaf_paths({"params": params, "opt": opt}), ckpt.leaf_paths(restored)))
        same = all(torch.equal(a, b) and a.dtype == b.dtype and b.device == a.device for (_, a), (_, b) in pairs)
        resumed = []
        train_cli(argv, resumed.append)
        final = ckpt.latest_step(d)
        steps = sorted(ckpt.all_steps(d))
    ran = [int(line.split()[1]) for line in resumed if line.startswith("step")]
    ok = (stopped == CKPT_PREEMPT_AT + 1 and same and resumed[0] == f"[restore] resumed from step {stopped}"
          and ran == list(range(stopped, CKPT_STEPS)) and final == CKPT_STEPS)
    log(f"  [train checkpoint] reduced {TRAIN} on the card, {CKPT_STEPS} steps: SIGTERM after step {CKPT_PREEMPT_AT} "
        f"-> '{[x for x in lines if x.startswith('[preempt]')]}', final checkpoint at step {stopped}; restored onto "
        f"the card {len(pairs)} leaves, bit for bit {same}; the rerun: '{resumed[0]}', steps {ran}, latest "
        f"checkpoint {final} (kept {steps}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: [train checkpoint] preemption, restore or resume failed")
    return dict(stopped_at=stopped, restored_bitwise=same, resumed_steps=ran, final=final)


def phase_train(gen, records, dry):
    """Phase 17 (module docstring) → (summary, K1/K2 and K8 launches of the
    trained model's main path)."""
    walls, summary = {}, {}
    t = time.perf_counter()
    cfg, params, summary["train"] = train_full_width(dry)
    walls["train"] = time.perf_counter() - t
    t = time.perf_counter()
    counts, summary["serve"] = train_serve(cfg, params, records, gen)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    walls["quantize_serve"] = time.perf_counter() - t
    t = time.perf_counter()
    summary["grads"] = train_grads_and_guard()
    walls["grads_guard"] = time.perf_counter() - t
    t = time.perf_counter()
    summary["checkpoint"] = train_checkpoints()
    walls["checkpoint"] = time.perf_counter() - t
    summary["walls"] = walls
    log(f"  [train] wall by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return summary, counts


def k12_line(k12, counts, cfg):
    """K12's entry of the kernels line: its launches on phase 14's main path;
    time, plain time, bound (over the live experts; over all of them beside
    it) and library time of one decode step's launches at B = 4
    (:func:`k12_step`: 16 layers of gate + up paired, then down), the bank
    shapes beside them."""
    (step,) = [r for r in k12 if r["leaf"] == "step"]
    name, src, replaces = K12
    return dict(name=name, route="cuda", source=f"src/repro_torch/{src}", replaces=replaces,
                launches=counts[name], max_abs_err=max(r["max_abs_err"] for r in k12),
                ms=step["ms"], plain_ms=step["plain_ms"], bound_ms=step["bound_ms"], bound_by=step["bound_by"],
                library_ms=step["library_ms"], bound_all_experts_ms=step["bound_all_ms"],
                step_launches=step["launches"], live_experts=step["live_experts"],
                shapes=[{k: r[k] for k in ("kind", "leaf", "E", "C", "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")} for r in k12 if r["leaf"] != "step"])


def scan_line(kernel, recs, counts, n_layers):
    """A scan kernel's entry of the kernels line (K10, K11): its launches on
    phase 13's main path; time, plain time and bound summed over one decode
    step's launches at B = 4 (one a layer of its cell), the other shapes
    beside them."""
    (step,) = [r for r in recs if (r["B"], r["S"]) == (PROMPTS, 1)]
    name, src, replaces = kernel
    return dict(name=name, route="cuda", source=f"src/repro_torch/{src}", replaces=replaces,
                launches=counts[name], max_abs_err=max(r["max_abs_err"] for r in recs),
                ms=step["ms"] * n_layers, plain_ms=step["plain_ms"] * n_layers, bound_ms=step["bound_ms"] * n_layers,
                bound_by=step["bound_by"], library_ms=None,
                shapes=[{k: r[k] for k in ("B", "S", "Dh", "ms", "plain_ms", "bound_ms", "bound_by")} for r in recs])


def k9_line(k9, counts, n_rglru):
    """K9's entry of the kernels line: its launches on phase 12's main path;
    times, plain time and bound summed over one decode step's launches at
    B = 4 (one a rglru layer), the other shapes beside them."""
    (step,) = [r for r in k9 if (r["B"], r["S"]) == (PROMPTS, 1)]
    name, src, replaces = K9
    return dict(name=name, route="cuda", source=f"src/repro_torch/{src}", replaces=replaces,
                launches=counts[name], max_abs_err=max(r["max_abs_err"] for r in k9),
                ms=step["ms"] * n_rglru, plain_ms=step["plain_ms"] * n_rglru, bound_ms=step["bound_ms"] * n_rglru,
                bound_by="bytes", library_ms=None,
                shapes=[{k: r[k] for k in ("B", "S", "W", "ms", "plain_ms", "bound_ms")} for r in k9])


def kernels_line(records, counts, n_layers, flash_records, spec_launches, flash_offsets, offset_launches):
    """Per kernel: its launches in its path's counted run and, in bf16 at the
    batched decode width, its time summed over one decode step's launches;
    for K8, in bf16, its time summed over the L launches of one
    8192-token prefill (one launch a layer at B = 1, S = 8192). Kernels on
    the speculative path also carry ``spec_launches``, their launches summed
    over phase 7's counted runs. K8 also carries its offset entry: its
    launches at ``q_start > 0`` over phase 8's counted runs
    (``offset_launches``) and, per checked (q_start, Sq) and dtype, one
    launch's numbers (``offset``)."""
    out = []
    every_leaf = step_counts(n_layers)
    per_step = {"bcq_mm": {"wo": n_layers, "w_down": n_layers, "lm_head": 1},
                "bcq_mm_fused": {"wqkv": n_layers, "w_gate_up": n_layers}}
    for name, (src, replaces, _, _) in KERNELS.items():
        leaves = per_step.get(name, every_leaf)
        rs = [r for r in records if r["kernel"] == name]
        step = [(r, leaves[r["leaf"]]) for r in rs
                if r["leaf"] in leaves and r["B"] == PROMPTS and is_bf16(r)]
        total = lambda key: sum(r[key] * n for r, n in step)  # noqa: E731
        out.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/{src}", replaces=replaces,
            launches=counts[name], max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
            library_ms=total("library_ms"),
        ))
        if name == "ternary_mm":
            out[-1]["tc_launches"] = counts["ternary_mm_tc"]
        out[-1]["spec_launches"] = spec_launches[name]
    H, Hkv, Dh = LLAMA_HEADS
    (r,) = [r for r in flash_records
            if (r["B"], r["S"], r["H"], r["Dh"], r["dtype"]) == (1, FLASH_S[-1], H, Dh, "bfloat16")]
    name, src, replaces = FLASH
    out.append(dict(
        name=name, route="cuda", source=f"src/repro_torch/{src}", replaces=replaces,
        launches=counts[name], max_abs_err=max(x["max_abs_err"] for x in flash_records),
        ms=r["ms"] * n_layers, plain_ms=r["plain_ms"] * n_layers, bound_ms=r["bound_ms"] * n_layers,
        bound_by=r["bound_by"], library_ms=r["library_ms"] * n_layers,
        spec_launches=spec_launches[name], offset_launches=offset_launches,
        offset=[{key: o[key] for key in ("q_start", "Sq", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")} for o in flash_offsets],
    ))
    return {"kernels": out}


def phase_wall(walls):
    """Log the wall seconds since the previous phase began (and keep them,
    in the order the phases ran, for the summary line)."""
    now = time.perf_counter()
    log(f"  (phase wall {now - walls['t']:.1f}s)")
    walls.setdefault("each", []).append(round(now - walls["t"], 1))
    walls["t"] = now


def main() -> int:
    tp_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))  # phase 16's weights file, the dry run's JSON
    procs = []
    try:
        return _main(tp_dir, procs)
    finally:
        for proc in procs:
            proc.stop()
        shutil.rmtree(tp_dir, ignore_errors=True)


def _main(tp_dir, procs) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    walls = {"t": time.perf_counter()}
    log("[1/17] card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), device {torch.cuda.get_device_name(0)}")

    phase_wall(walls)
    log("[2/17] build, every source at once; meanwhile phase 5's model quantized in every format")
    builds = Builds()
    prepared = prepare_main_path()

    phase_wall(walls)
    log("[4/17] flash_attention against its plain version (before phase 3: its source builds fast)")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    builds.wait("flash_attn")
    flash_records, flash_offsets = phase_flash(gen)

    phase_wall(walls)
    log("[3/17] kernels against their plain versions, each as its source is built")
    records = phase_kernels(gen, builds)
    builds.wait()
    paths = _build.build()  # all built: the paths only
    log(f"  built {sorted(paths)}: each source's compile took "
        f"{', '.join(f'{n} {t:.1f}s' for n, t in sorted(builds.seconds.items(), key=lambda x: x[1]))} "
        f"(the build began {time.perf_counter() - builds.t0:.1f}s ago)")
    for name in paths:  # ptxas -v: registers of every instantiation, and any spills
        regs, spills = [], []
        for line in _build.build_log(name).splitlines():
            line = line.strip()
            if "registers" in line:
                regs.append(int(line.split("Used ")[1].split(" registers")[0]))
            if "spill" in line and not line.startswith("0 bytes stack frame, 0 bytes spill stores"):
                spills.append(line)
        log(f"  {name}: {len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} registers, "
            f"{len(spills)} with stack or spills")
        for line in spills:
            log(f"    {line}")

    draft_records, draft_steps = draft_shapes(gen, records)
    limit_records = table_limit(gen)
    dense_rows = dense_rows_check(gen)
    prompt_tiles = prompt_tiles_check(gen)

    phase_wall(walls)
    log("[5/17] main path, one run per format; meanwhile, in a process of its own, the dry run of phases 10 and "
        "17's steps")
    dry = DryRun(tp_dir)
    procs.append(dry)
    inspect_captures()
    counts, cfg, summaries, engines, prompts = phase_main_path(prepared)
    del prepared
    bcq_engine, ternary_engine = engines["bcq"], engines["ternary"]
    tp_params = tp_dir / "llama3.2-3b-bcq.pt"  # phase 16 hands these packed weights to its ranks
    t0 = time.perf_counter()
    torch.save(bcq_engine.params, tp_params)
    log(f"  the bcq engine's packed weights saved for phase 16 ({tp_params.stat().st_size / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.1f}s")

    phase_wall(walls)
    log("[6/17] continuous serving and one long request")
    counts["flash_attention"], summaries["continuous"], serving = phase_serving(bcq_engine)
    summaries["long"], long_logits, long_tokens = phase_long(bcq_engine)

    phase_wall(walls)
    log(f"[7/17] self-speculative decoding (the first {SPEC_LAYERS} of {cfg.n_layers} layers)")
    spec_bcq = depth_view(bcq_engine, SPEC_LAYERS)
    summaries["speculative"], spec_launches = phase_speculative(spec_bcq, depth_view(ternary_engine, SPEC_LAYERS),
                                                                prompts, spec_serving_view(spec_bcq, serving),
                                                                summaries["continuous"],
                                                                checked_shapes(records + draft_records))
    del spec_bcq
    solos = serving["solos"]  # phase 11 holds its streams to them
    del ternary_engine, serving

    phase_wall(walls)
    log("[8/17] prefix cache and chunked prefill")
    summaries["prefix"] = phase_prefix(bcq_engine, (summaries["long"], long_logits, long_tokens),
                                       records + draft_records, gen)
    offset_launches = (sum(summaries["prefix"][run]["offset_launches"] for run in ("cold wave", "warm wave"))
                       + summaries["prefix"]["long"]["offset_launches"])
    del bcq_engine

    phase_wall(walls)
    log("[9/17] kernels (the JSON line is printed last but one)")
    line = kernels_line(records, counts, cfg.n_layers, flash_records, spec_launches, flash_offsets,
                        offset_launches)

    phase_wall(walls)
    log("[10/17] captured decode and the int8 cache")
    summaries["graphs"] = phase_graphs(engines, prompts, dry)

    phase_wall(walls)
    log("[11/17] serving session and observability")
    summaries["session"] = phase_session(engines["bcq"], solos)
    del engines
    gc.collect()
    torch.cuda.empty_cache()

    phase_wall(walls)
    log("[12/17] the hybrid family: recurrentgemma-9b at full width and depth")
    summaries["hybrid"], k9_records, hybrid_counts = phase_hybrid(gen, records + draft_records)
    from repro_torch.configs import get_config

    line["kernels"].append(k9_line(k9_records, hybrid_counts, get_config(HYBRID).block_counts()["rglru"]))
    gc.collect()
    torch.cuda.empty_cache()

    phase_wall(walls)
    log("[13/17] the ssm family: xlstm-125m at full width and depth")
    summaries["xlstm"], k10_records, k11_records, xlstm_counts = phase_xlstm(gen, records + draft_records)
    n_cells = get_config(XLSTM).block_counts()
    line["kernels"].append(scan_line(K10, k10_records, xlstm_counts, n_cells["mlstm"]))
    line["kernels"].append(scan_line(K11, k11_records, xlstm_counts, n_cells["slstm"]))
    gc.collect()
    torch.cuda.empty_cache()

    phase_wall(walls)
    log("[14/17] the MoE family: olmoe-1b-7b at full width and depth, llama4-maverick reduced")
    summaries["moe"], k12_records, moe_counts = phase_moe(gen, records + draft_records)
    line["kernels"].append(k12_line(k12_records, moe_counts, get_config(MOE)))
    gc.collect()
    torch.cuda.empty_cache()

    phase_wall(walls)
    log(f"[15/17] the vlm and audio families: {MUSIC} at full width and depth, {VISION} at full width and "
        f"{VISION_LAYERS} layers")
    summaries["families"] = phase_families(gen, records + draft_records)
    gc.collect()
    torch.cuda.empty_cache()

    phase_wall(walls)
    log(f"[16/17] tensor-parallel serving: llama3.2-3b over {TP_RANKS} ranks on one card")
    summaries["tp"], tp_launches = phase_tp(tp_params, prompts)
    for entry in line["kernels"]:
        if entry["name"] in ("bcq_mm", "bcq_mm_fused", "flash_attention"):
            entry["tp_launches"] = tp_launches[entry["name"]]
    gc.collect()
    torch.cuda.empty_cache()

    phase_wall(walls)
    log(f"[17/17] training: {TRAIN} at full width trained {TRAIN_STEPS} steps, checkpointed and resumed, quantized "
        "and served")
    summaries["train"], train_launches = phase_train(gen, records + draft_records, dry)
    for entry in line["kernels"]:
        if entry["name"] in ("bcq_mm", "bcq_mm_fused", "flash_attention"):
            entry["train_launches"] = train_launches[entry["name"]]
    phase_wall(walls)
    log(card)
    log(f"phase walls, s, in the order run (1, 2, 4, 3, 5, ..., 17): {walls['each']}; phases "
        f"{sum(walls['each']):.1f}s; the dry run's checks took {dry.waited_s:.2f}s of phases 10 and 17")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "layers": cfg.n_layers, "records": records, "flash_records": flash_records,
         "steps": {path: {B: path_step(records, names, B, cfg.n_layers) for B in (1, PROMPTS, PROMPTS * PROMPT_LEN)}
                   for path, names in STEP_PATHS.items()},
         "table_limit": limit_records, "dense_rows": dense_rows, "prompt_tiles": prompt_tiles,
         "flash_offsets": flash_offsets, "k9_records": k9_records, "k10_records": k10_records,
         "k11_records": k11_records, "k12_records": k12_records,
         "draft_records": draft_records, "draft_steps": draft_steps,
         "paths": summaries, "phase_walls_s": walls["each"], **line},
        indent=1))
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
