#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase raises and the script exits non-zero):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 is switched off for matmuls and cuDNN.
  2. the kernel build: every csrc/*.cu through nvcc, in parallel, timed;
     ptxas's registers, shared memory and spills for every kernel, and the
     SASS counted kernel by kernel: K1's library for IEEE division (FCHK,
     MUFU.RCP, CALL), K2's for the instructions of a (v, m) pair (FSET,
     FADD).
  3. each kernel against its plain PyTorch version on the card, at its
     path's shapes: K2-K5 at the sampler's (B=4, V=151936, M=31 and M=1)
     and at ragged V (1000, 257): K2 and K3 bit for bit (K2 counting above
     and below, also at B=64 with M=33, two candidate tiles, at the
     quantile clip's (1, 300) with M 15 and 255 (spec_k 4 and 8), and on
     rows of NaN, +-inf and +-0; K3
     also against the generic engine loop over K2, and on rows holding
     NaN, whose bracket is (NaN, NaN)), K4 and K5 within rtol 1e-5 / atol
     1e-6 (K5 at the engine's extreme temperatures 0.05 and 20 too), bit
     for bit run to run and between an eager call and CUDA-graph replay,
     one kernel launch a call (profiled), with K2's bound restated for
     the SASS's instructions a pair and K5's for its exponentials on the
     SFU, and the stage clock of K2, K4 and K5 (where a call's time goes,
     csrc/row_reduce.cuh); K1 at M in {1, 7, 31} and
     terms in {10, 10**4}, bit for bit, timed against a latency bound
     (2 (terms - 1) dependent steps of 4 FMA latencies at the card's top
     SM clock, the FMA latency measured beside it) and beside the first
     version's division (an __fdiv_rn a step, also with a zero numerator
     skipping it); K3 with its cluster geometry, and with the other
     cluster size;
     K6 at the served decode shape (B=4, n_kv=8,
     n_rep=4, head_dim 128, page 16, the chain of a 544-token context,
     L=1), at that shape with short positions (splits of the chain that
     hold only masked pages) and at L=3 with a page size that does not
     divide the context and a wrapped row, f32 within 1e-5 and bf16
     within 1e-2 (compared in f32), bit for bit run to run.  Each row:
     device time per call (CUDA-graph replay between CUDA events,
     L2-warm), time per eager call, the plain version's time, the least
     time the card could take and, where one PyTorch call computes the
     same function, its time.
  4. one solve per kind on the "hopper" backend under
     torch.cuda.set_sync_debug_mode("error") (the round loop never syncs),
     including count_above with a (B,) k tensor, which runs K2 through the
     engine; brackets against the "torch" backend; the launches those
     solves make under the tuner's decisions; count_below profiled: one
     K2 a round (x < c counted in place) and no negation kernel.
  5. the one-shot serving path: repro_torch.launch.serve (setup, then run,
     as its main does) for qwen3-4b at full width (36 layers, d_model
     2560, vocab 151936; random bf16 weights from a seed), 4 x 16 tokens
     sampled with top-k 40, top-p 0.9 and target entropy 3.0 on the
     "hopper" backend, each decode step one CUDA-graph replay
     (core/graphs.py; the first step eager, then captured); the launch
     counters must show what the tuner's decisions for the sampler's
     solves give (K3 once a token, K4 and K5 once a round and once for
     the sign at lo0: nine times a token at (rounds, spec_k) = (8, 5);
     a replay counts the launches its capture recorded); launches per
     token.
  6. a reference check: the sampler's masked logits on both backends, and
     greedy generate on reduced qwen3-4b, "hopper" against "torch".
  7. phase 5's serve.run on its session again, warm (every decode step a
     replay), timed; its tokens against the eager loop's (a host-integer
     position, no graph) on the same prompts and generator state, bit for
     bit; once more under torch.profiler (device busy time, idle share,
     launches per token, top kernels, and the sampler kernels K3-K5
     each).
  8. the paper path: repro_torch.launch.paper (its main, in-process): the
     Fig. 4 sweep (terms 10**4, n=24, k=1..5) and the Fig. 7 sweep (n=6,
     k=3, terms 10..5000) through K1, both solvers graphed, every
     runahead root equal to the serial root bit for bit; per row host ms,
     device ms (CUDA events), the speed-up on each and both ideals
     (round count n/ceil(n/k), evaluation count (n+1)/(ceil(n/k)+1));
     then each solve's eager body per k under set_sync_debug_mode("error")
     with K1 launched n + 1 and ceil(n/k) + 1 times, and its graph
     replay's root equal to the body's, bit for bit.
  9. the continuous path: repro_torch.launch.serve --continuous for
     qwen3-4b at full width, 8 requests (prompt 512, up to 32 new tokens)
     over 4 slots on a paged cache (page 16) through K6 and the sampler
     kernels, each decode step one replay of the step graph of its
     statics: every request served, K6 launched 36 times per decode step,
     K3-K5 as the tuner's decisions give for a decode step's 4 rows and
     an admission's 1; tok/s first (graphs
     captured: keys and capture time) and warm (the same server again,
     replays only), latency, dispatches and host syncs per step, peak
     memory; the streams equal the eager step body's (the same requests
     and seeds, no graph) bit for bit; a warm run under torch.profiler
     (K6 and K3-K5 each); three eager step bodies and three replays under
     set_sync_debug_mode("error") with the once-per-step token read
     outside that window.
 10. a reference check of the continuous path on reduced qwen3-4b (f32,
     prompts screened for greedy ties): paged K6 streams equal paged
     gather streams and the one-shot stream of every request.
 11. the training path: repro_torch.launch.train (its main, in-process)
     for internlm2-1.8b at full width and depth (24 layers, d_model 2048,
     GQA 16/8, head_dim 128, d_ff 8192, vocab 92544; random bf16 weights
     from seed 0), batch 2 x seq 4096 of SyntheticTokens, remat on, the
     quantile clip, AdamW: 1 warm-up step, 4 timed steps and 1 step under
     torch.profiler.  Every loss finite; K7 launched exactly 48 times per
     step (24 layers forward, 24 remat recomputes) and K2 exactly once
     per round of the quantile clip's solve, as the tuner decides it at
     (1, leaves) for the clip's budget of 32 steps; ms per step,
     tokens per second, peak memory, device busy time, idle share and
     K7's share of it.
 12. checkpoint and fault injection on the card: reduced internlm2-1.8b
     in a subprocess (--ckpt-every 5 --die-at-step 7) exits 42 with
     step_5 on disk; the rerun resumes from step 5, and its losses and
     final checkpoint equal an uninterrupted run's, bit for bit.
 13. the continuous path with a top_k per request: phase 9's serve (same
     8 requests, 4 slots, paged cache, "hopper" backends) with top_k 20,
     40, 50, 100 in turn, so a decode step whose live slots' k differ
     solves top-k per row on the engine through K2: every request served,
     K2 launched rounds + 1 times per such step (the rounds of the
     tuner's decision, and the probe at lo0: a per-row k leaves its sign
     unknown), K3 once per other sample; the
     step graphs captured (keys, capture time) and the streams equal the
     eager step body's bit for bit; tok/s first and warm, a profiled warm
     run of the first 4 requests (K2's time in situ; device busy time,
     idle share), three mixed-k replays under set_sync_debug_mode("error"),
     and the masked logits of a mixed-k batch at V=151936 on both
     backends (top-k alone bit for bit).
 14. fused decode horizons: phase 9's serve again at step_horizon 4 (one
     replay runs 4 decode steps; EOS and budgets detected on the card):
     the streams equal phase 9's per-step streams bit for bit; the
     counters (dispatches, horizons, all-idle iterations, host syncs per
     decode step), tok/s first and warm, a profiled warm run (idle
     share), peak memory; and the card's dispatch overhead, a graphed
     per-step step's host and sync time beyond its device time over that
     device time (core/tuning.py's DISPATCH_OVERHEAD).
 15. speculative serving at draft_len 4 on phase 9's layout (qwen3-4b
     full width, 4 slots, page 16, K6, the "hopper" backend): one
     decode_verify_paged over 4 rows on a live pool against 4 serial
     decode_step_paged steps on a copy (bf16: each row within 0.05 of its
     row's largest |logit|, argmax equal where the serial top-2 gap is
     clear of that, since a B*L-row forward may take other cuBLAS kernels
     than a B-row one; the all-rejected rollback restores every page but
     the null page bit for bit); an oracle drafter (acceptance >= 0.9)
     and a never-right one (acceptance 0) in f32 on prompts screened for
     greedy ties, the unembedding sharpened toward a fixed successor,
     their streams equal the per-step streams; the n-gram drafter on
     repetitive prompts with phase 9's sampler and greedy requests
     (acceptance, tokens per verify step, tok/s first and warm, a
     profiled warm run, dispatches and host syncs per verify step, host
     drafting ms, K6 = 36 x verify steps, K3-K5 per step with a sampled
     slot as the tuner's decisions for the 4 x L grid rows give, peak
     memory); verify-step graph replays against their
     eager bodies, paged and dense; step_horizon 4 with repeat-last
     drafts against per-step serving with the same drafter; and the
     device ms of one graphed verify step at L = 1, 2, 4, 8 beside
     core/tuning.py::decide_draft_len's price of overhead + L steps.
 16. the MoE family served: qwen2-moe-a2.7b at its published width and
     depth (24 layers, d_model 2048, 16/16 heads with QKV bias, 60
     experts padded to 64 of d_ff 1408, top-4, 4 shared units, vocab
     151936; 30.3 GB of random bf16 weights from seed 0).  One-shot with
     phase 5's traffic (K3-K5 as phase 5's; the
     graphed tokens equal the eager loop's), continuous on the dense ring
     with phase 9's requests and no pages (the streams equal the eager
     step body's), each profiled warm (device busy, idle share); the
     graphed decode step's device ms against its byte bound (every weight
     but the embedding: all 64 padded experts are read each step); the
     prefill of the one-shot prompts with capacity_mode "bisect", every
     layer's keep mask (K3, one launch a layer) equal to the "torch"
     backend's bit for bit, beside "fifo": the dropped fractions; K3 at
     that capacity shape (64, 1024) and the cut's decision against its
     plain version and torch.topk; peak memory.
 17. the MoE family trained: launch.train for granite-moe-3b-a800m at
     its published width (d_model 1536, 24/8 heads of 64, 40 experts
     padded to 48 of d_ff 512, top-8, vocab 49155), capacity "bisect",
     the quantile clip, AdamW, phase 11's batch 2 x 4096, 5 steps; the
     depth cut only as far as a byte reckoning against 70 GB forces
     (printed, beside the measured peak).  Every loss finite; per step K3
     twice a layer (forward and remat recompute), K2 once a round of the
     clip's decision, K7 twice a layer; ms a step, tok/s, dropped
     fraction, the last
     step profiled (K3, K2 and K7 in situ); K3 at the run's last
     capacity cut (48, 65536) and K2 at the clip's (1, leaves) shape
     with its decision's 2**spec_k - 1 candidates, each against its plain
     version.
 18. the tuner (core/tuning.py), on an empty cache: at the served shape
     (B=4, V=151936) and the sampler's budget of 8 x 5 = 40 steps, and at
     the quantile clip's (1, 300) and its budget of 8 x 4 = 32, the
     device ms of a graphed "hopper" solve at every spec_k from 1 to 8
     for each kind (top-k with a static k through K3's whole solve where
     the rounds are whole, with a per-row k through K2; top-p, entropy,
     quantile), brackets equal to the "torch" backend's (and how many
     equal the fixed spec_k's bit for bit), beside the analytic pick
     (held not slower than the fixed decomposition by more than the
     readings' spread), the measured pick and the fixed; K2, K4, K5 at
     every M = 2**k - 1 and the Hopper profile's constants fitted to the
     served shape's readings, each held within 25% of PROFILES["cuda"];
     every candidate geometry of the kernel tier for K2-K6 at their
     served shapes, timed, held to the plain version and bit-stable, and
     the measured pick; the launcher at full width, one-shot and
     continuous paged: by default (phase 5's and 9's mode) and with
     --backend auto --autotune (its cache in a temp dir) the streams
     equal the tuning.disabled() runs', and so do the replays with the
     solver tier's winners alone; with both tiers' winners the top-k-only
     tokens do; its "tuned <key> -> ..." lines; what --speculative
     --draft-len auto picks, beside what this run's phase 15 verify-step
     readings give, and a short speculative continuous serve through the
     launcher.
 19. the xlstm family served: xlstm-1.3b at its width and depth (48
     layers: 42 mLSTM, 6 sLSTM; d_model 2048, 4 heads of 512, vocab
     50304; 3.23 GB of random bf16 weights from seed 0) through
     launch.serve: one-shot with phase 5's traffic (graphed decode steps
     against the eager loop, bit for bit; K3-K5 as the tuner's decisions
     give), continuous on the dense ring (8 requests of 500 prompt
     tokens, not a multiple of the mLSTM chunk, n_new uniform in [16,
     32], 4 slots) per step (the streams equal the eager step body's)
     and at step_horizon 4 (the streams equal the per-step ones); tok/s
     first and warm, device busy and idle share (profiled: the warm
     one-shot serve, and 4 requests' graphed decode steps after their
     eager admissions), each admission's ms (timed in the eager serve;
     the sLSTM prefill is a serial loop), a graphed
     decode step's device ms, one-shot and continuous, against its byte
     bound (weights but the embedding, K/V, recurrent state read and
     written); an inactive lane's whole cache bit for bit across a
     graphed step while the live lanes' recurrent states move; prefill
     and 8 decode steps against the full forward's logits in f32 at full
     width, the depth cut to the first run of each kind (within
     RECURRENT_F32_TOL of the largest |logit|); no token >= the vocab;
     peak memory.
 20. the hymba family served, as phase 19: hymba-1.5b at its width and
     depth (32 layers: 3 global and 29 sliding-window (1024) attention ||
     SSM blocks, d_model 1600, 25/5 heads of 64, d_ff 5504, vocab 32001
     padded to 32128; 2.79 GB of bf16), one-shot at batch 2 x 4096 prompt
     tokens (K7 in the prefill, banded on 29 layers, 32 launches; the SWA
     ring wrapped), continuous with 1500-token prompts (past the window,
     under FLASH_MIN_SEQ); no token >= 32001 (the phantom columns sit at
     the row's max - 80 after the sampler's clamp).
 21. whisper-tiny served at full width and depth (4 encoder + 4 decoder
     layers, d_model 384, 6 heads of 64, vocab 51865 padded to 51968,
     encoder_len 1500; ~36M params, no cut): launch.serve one-shot, batch
     16 x 32 prompt tokens and 128 new with frames drawn from the seed
     (graphed steps against the eager loop, bit for bit; K3-K5 at
     (16, 51968)); continuous on the dense ring through the scheduler's
     admit(encoder_frames=): 16 requests, each with its own frames, 8
     slots, n_new uniform in [64, 128], two arriving a step, per step
     (against the eager step body) and at step_horizon 4 (equal streams);
     admission ms (the eager encoder), graphed steps against their byte
     bound (decoder weights, the tied unembedding, ring and encoder K/V),
     idle share, prefill + 8 steps against the f32 forward.
 22. qwen3-4b at full width with an int8 K/V cache on the dense ring:
     launch.serve's continuous runner on a server with cache_dtype int8,
     8 requests of 4096 prompt tokens (K7 in each admission, 36 launches
     each), n_new uniform in [16, 32], 4 slots; replays against the eager
     step body and step_horizon 4 against per step, bit for bit; a
     decode_verify over L = 4 against serial steps within phase 15's bf16
     tolerance, and its all-rejected rollback restoring codes and scales
     bit for bit; one int8 step against the f32 step within INT8_VS_BF16
     times the bf16 step's distance from it (and its distance from the
     bf16 step beside JAX's reduced-size 0.02); the graphed int8 step and
     the bf16 step at the same depth, each beside its byte bound.
 23. the hybrid family trained: launch.train for hymba-1.5b at its
     published width, phase 11's batch 2 x 4096, remat, the quantile
     clip, AdamW, 4 steps (step 0 warms up, steps 1-2 are timed, step 3
     is profiled), the depth cut to HYMBA_TRAIN_LAYERS (layers 0-16: two
     of the three global layers) by the run's time limit, or further if
     a byte reckoning against 70 GB forces it (printed beside the
     measured peak).  Every loss finite;
     per step K7 twice a layer (forward and remat recompute, banded on
     the sliding-window layers) and K2 once a round of the clip's
     decision, and the clip's bracket at the last step's per-leaf norms
     equal to the "torch" backend's bit for bit; ms a step, tok/s, peak
     memory, device busy, idle share, kernels a step and K7's share of
     the busy time; K2 at the clip's (1, leaves) shape against its plain
     version; at full width cut to layers 0-2 (one global, two
     sliding-window), f32 params, batch 1 x 4096, the loss and per-leaf
     gradients with K7 against those with its plain version (loss rtol
     1e-4, each gradient l2 rel 2e-2).
 24. the SSM family trained as phase 23: xlstm-1.3b at its width, its
     depth cut to XLSTM_TRAIN_LAYERS (2 sLSTM and 10 mLSTM layers) and
     batch 2 x 1024 (a sequence cut), both forced by the run's time limit
     (the sLSTM loops over time; a step launches ~1.6 * 10**4 kernels a
     layer); no attention, no K7; the card's
     loss and gradients in f32 at phase 19's reference depth (an sLSTM
     and 7 mLSTM layers), batch 2 x 200, against the CPU port's on the
     same weights within CARD_VS_CPU.
 25. the enc-dec family trained as phase 23: whisper-tiny at full width
     and depth through train.step.make_train_step (the launcher refuses
     enc-dec, as JAX's), 16 x 448 decoder tokens with (16, 1500, 384)
     bf16 frames, two microbatches; no K7 (448 and 1500 lie under
     FLASH_MIN_SEQ); the card against the CPU port in f32 at batch 2.
 26. the chip-level runahead (the paper's Fig. 6): 2 and then 4 ranks on
     the card (launch/mesh.py::spawn_local; gloo over CUDA tensors, since
     the ranks share one GPU), find_root_runahead_sharded with the
     paper's f through K1 on each rank's chunk of the 2**k - 1 points, N
     = 6, k = 2 at terms 10, 100, 1000 and 5000, k = 3 and 4 at 1000:
     every rank's root equal to the single-device serial root bit for
     bit, K1 launched 1 + ceil(N/k) times a solve on each rank; ms per
     solve (the slowest rank), of it in joins, beside the serial and the
     lane-level runahead solves (this process, graphed), and their
     ratios (Fig. 6's crossover); the join term (an f32 all-reduce of 4
     B to 1 MB) on each world, fitted to alpha * log2(ranks) + bytes /
     link_bw (core/tuning.py's PROFILES["cuda"] join constants).
 27. mesh-native continuous serving: qwen3-4b at full width and depth
     on four ranks sharing the card (each draws the weights from the
     seed, ~8 GB of bf16, and the checksums agree), phase 9's traffic
     paged (K6) under the 2x2, 4x1 and 1x4 meshes, and under 2x2 also on
     the dense ring and at step_horizon 4; the vocab meshes under the
     tuner's fixed decisions (vocab-sharded solves: K2, K4 and K5 on
     each rank's shard, one join a round), 4x1 under its "data"
     placement (K3 on each rank's one row), and one 2x2 serve in the
     default mode.  Every
     rank's launches equal what the decisions give for its steps and its
     own admissions; every rank's streams agree; the 1x4 paged streams
     equal phase 9's and the horizon-4 streams the per-step ones; the
     others are counted against phase 9's (a bf16 forward over 2 or 1
     rows rounds apart from one over 4).  The data splits are held on a
     screened workload: eight greedy and top-k requests on prompts whose
     greedy streams keep a top-1/top-2 gap above 1e-2, served in f32
     under 2x2 (paged and dense) and 4x1 (paged), their streams equal
     to rank 0's single-rank serve; the witness: one prefill and decode
     step of 4 rows against the same over 2 and 1 rows, bf16 within
     VERIFY_REL_TOL of the row's largest |logit|, f32 beside it.  tok/s
     beside phase 9's warm rate, ms a step and the share of the serve
     in joins.  The steps run eagerly: a collective does not go into a
     CUDA graph under gloo.
     The line's kernels carry the mesh paths ("mesh-runahead": phase 26,
     K1; "mesh-serve": phase 27, K2-K6), each measured at its shape: the
     2x2 mesh's vocab shard (2, 75968), 4x1's row, 2 slots of K6, K1 on
     two points; launches summed over the ranks.
 28. data-parallel training across ranks: launch.train's main (its
     default ``--mesh elastic``) on two ranks sharing the card over gloo,
     each drawing the global batch 2 x 4096 and keeping its row, the
     gradients all-reduced in bf16 buckets: internlm2-1.8b at its
     published width (remat, quantile clip: K2) and granite-moe-3b-a800m
     at its width with ``--capacity-mode bisect`` (K3 on the gathered
     assignments of both rows), 3 steps each, their depth cut only as far
     as a byte reckoning of one rank's share (MESH_TRAIN_BUDGET, printed
     beside the run) forces.  Every rank's params and state bit-identical
     after each step (``launch/train.py::check_replicas``, called from
     the launcher's ``on_state`` outside the profiled step); losses
     finite; per rank and
     step K7 twice a layer, K3 twice a layer (forward and remat
     recompute) and K2 as the clip's decision gives.  Step ms per rank,
     tok/s, peak memory per rank, the joins' ms and share of the step
     (``mesh.stats``), and device busy / idle of the last step on each
     rank.  At 2 layers in f32 (internlm2-1.8b, granite-moe-3b-a800m
     under FIFO and under bisect), the meshed step against the
     single-rank step on the same rank: loss rtol 1e-5; every routing
     call's expert ids equal and its gates within 1e-5 (a forward over
     one row rounds apart from one over two on the card); FIFO's keep
     masks equal bit for bit and the params' change per leaf at l2 rel
     < 1e-3 (the CPU tests' tolerances); under bisect each meshed cut
     alone equal to what the layer used, bit for bit, and its keeps equal
     the single-rank step's but where a gate lies within 1e-5 of its
     expert's threshold (at most MESH_F32's ``flips``), the params'
     change within ``bisect_delta_rel``.  Kill and resume across world
     sizes: reduced internlm2-1.8b on 2 ranks (``--host-devices 2``)
     killed at step 1 (exit 42, step_2 on disk), resumed on one rank; its
     losses within MESH_RESUME_RTOL of the uninterrupted 2-rank run's,
     and a resume from a copy of step_2 with AdamW's mu and nu zeroed
     outside it (the check sees lost optimizer state).  The line's
     kernels carry "mesh-train" rows: K7 at a rank's (1, 4096) share of
     internlm2's step, K3 at the capacity cut's (48, 65536) gathered
     scores, K2 at the clip's (1, leaves); launches summed over the ranks
     of both drives.

Whole-path profiles record device activity only and read its raw events
(``_profile_records``): a training step's ~10**5 kernels read back in
seconds, where key_averages' per-op tree took most of a minute.

Phases 4-17 run the paths as a user runs them: in the tuner's default
mode (the analytic solver tier and today's kernel geometry), on an empty
tuning cache, as a fresh checkout has.  Every launch count they hold is
read from the decisions the tuner reports for that path's run
(``tuning.explain``: K3 once a static top-k solve whose rounds are whole,
else a kernel once a round, and once more where the sign at lo0 is
unknown).  Phase 3 holds each kernel at today's geometry against its
plain version and the CPU emulation of its split, under
tuning.disabled().

Phase 3 also holds K7 (flash_fwd) at the training shape (B=2, S=4096,
16 q heads, 8 kv heads, head_dim 128) against its plain version in f32
at JAX's K7 tolerance (atol 2e-5 / rtol 1e-4) and, in bf16 (tensor
cores, p rounded to bf16 before P.V), by accuracy: its largest |diff|
from the f32 reference on the same inputs at most the bf16 plain
version's plus one bf16 ulp, and every element within one bf16 ulp of
itself plus one of its row's largest of the bf16 plain version at the
kernel's key tile (``flash_fwd.bf16_check``); and at a ragged banded
shape (S=1000,
window 128, f32, atol 2e-5 / rtol 1e-4); bit for bit run to run.  Its
bound counts the causal half of the score matrix at the bf16 tensor-core
rate (989 TFLOP/s); the achieved TFLOP/s is printed beside it.  At the
recurrent paths' shapes phase 3 holds K3-K5 at B=4 on xlstm's vocab row
(50304) and hymba's (32001 padded to 32128, the phantom columns at the
row's max - 80), and K7 at hymba's prefill (B=2, S=4096, 25/5 heads of
64, bf16) with window 1024 and 0 by ``bf16_check``, timed beside one SDPA
call with a boolean band mask and enable_gqa.

The line before the last is a JSON object listing the kernels, each with
the path its launch count was read on ("serve": phase 5; "paper": phase
8; "continuous": phase 9; "train": phase 11, for K7;
"continuous-mixed-k": phase 13, for K2, which the static-k serves do not
launch), and three more for the MoE paths, each measured at its path's
shapes: K3 as the capacity cut of phase 16's bisect prefill
("moe-prefill-bisect") and of phase 17's training ("moe-train"), and K2
as phase 17's quantile clip ("moe-train"); and for the recurrent paths,
K3-K5 at the vocab rows of phases 19 and 20 ("xlstm-serve",
"hymba-serve": their one-shot serves) and K7 at hymba's prefill shape
("hymba-prefill": phase 20's one-shot prefill); K3-K5 at whisper's
vocab row ("whisper-serve": phase 21's one-shot serve); and K3-K5 at the
served shape and K7 at qwen3-4b's 4096-token admission ("int8-serve":
phase 22's continuous serve); and for the families' training, K2 at
each quantile clip's (1, leaves) shape ("hymba-train", "xlstm-train",
"whisper-train": phases 23-25) and K7 at hymba's training shape
("hymba-train": its row is phase 3's at the same shape, hymba's
prefill).  A launch count is the wrappers' count of
eager launches plus,
for every graph replay, the launches its capture recorded.  Each entry's
bound_ms is the larger of its bytes and operations bounds; K1's chain of
dependent steps is bounded by latency instead, which its entry carries
as latency_bound_ms beside the operations bound.  The last line is
{"ok": true, "device": {...}}.
Nothing is printed as a result when torch sees no CUDA device or the
port's sources are not beside this file.
"""
from __future__ import annotations

import contextlib
import inspect
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
SFU_PER_CLOCK = 16              # exponentials an SM issues a clock (cc 9.0)
FP32_LANES = 128                # FP32 lanes of an SM: one instruction each
TOL = dict(rtol=1e-5, atol=1e-6)
PATH_B, PATH_V, PATH_M = 4, 151936, 31
SAMPLER_ARGV = ["--top-k", "40", "--top-p", "0.9", "--target-entropy", "3.0",
                "--backend", "hopper"]
SERVE_ARGV = ["--arch", "qwen3-4b", "--batch", "4", "--prompt-len", "64",
              "--new-tokens", "16"] + SAMPLER_ARGV
NEW_TOKENS = 16
CONT_ARGV = ["--arch", "qwen3-4b", "--continuous", "--requests", "8",
             "--slots", "4", "--arrival-burst", "2", "--prompt-len", "512",
             "--new-tokens", "32", "--page-size", "16", "--page-impl",
             "hopper"] + SAMPLER_ARGV
K1_TERMS = 10_000                 # the paper's term count
# K2: its SASS opcodes of a pair (a compare to 1.0 or 0.0, an f32 add), the
# first version's times (three launches a call; graph replay and eager, on
# an H100 80GB HBM3 at 700 W), and the quantile clip's shape
K2_SASS = ("FSET", "FADD")
K2_FIRST_MS = (0.0106, 0.0738)
K2_CLIP = (1, 300, 15)
# the quantile clip's candidates a round at spec_k 8 (the analytic tier's
# pick at the clip's budget of 32 steps on the Hopper profile)
K2_CLIP_WIDE = (1, 300, 255)
# phase 13: the per-request top_k of the continuous serve, in turn
MIXED_TOP_K = (20, 40, 50, 100)
# phase 14: the decode steps a fused horizon runs
HORIZON = 4
# phase 15: the draft length of the speculative serve, the draft lengths
# whose graphed verify step is timed, the bf16 tolerance of a verify row
# against its serial step (of the row's largest |logit|), and the period
# of the repetitive prompts the n-gram drafter reads
DRAFT_LEN = 4
VERIFY_LENS = (1, 2, 4, 8)
# phase 18: the sampler's budget, rounds x spec_k, and its decomposition;
# how far a constant of the Hopper profile fitted to a run's readings may
# lie from core/tuning.py's PROFILES["cuda"] (two runs on one card agreed
# within 5%)
TUNE_ROUNDS, TUNE_SPEC_K = 8, 5
PROFILE_SPREAD = 0.25
VERIFY_REL_TOL = 0.05
REPEAT_PERIOD = 8
# K1's latency bound: a bit-exact step is 4 dependent operations (the
# numerator's multiply, q0, rho, q: csrc/taylor_eval.cu) of 4 cycles each
# (an f32 FMA's dependent-issue latency)
K1_CHAIN_DEPTH, FMA_LATENCY = 4, 4
# K6 at the served decode shape: B=4 slots, n_kv=8, n_rep=4, head_dim 128,
# page 16, the 34-page chain of a 512 + 32 token context
K6_PATH = dict(B=4, nkv=8, nq=32, hd=128, P=16, C=544, L=1,
               pos=[520, 529, 537, 543])
# L=3, a page size that does not divide the context, the last row wrapped
K6_EDGE = dict(B=3, nkv=8, nq=32, hd=128, P=16, C=100, L=3,
               pos=[40, 96, 130])
# the served shape with short positions: slot 0 sees page 0 only, so 8 of
# its 9 chain splits hold only masked pages and must weigh exactly 0
K6_MASKED = dict(K6_PATH, pos=[5, 100, 300, 543])
# K7 at the training shape (internlm2-1.8b, batch 2 x 4096) and a ragged
# banded shape at JAX's own K7 tolerance
K7_PATH = dict(B=2, S=4096, H=16, Hk=8, D=128, window=0)
K7_EDGE = dict(B=1, S=1000, H=2, Hk=2, D=128, window=128)
TRAIN_ARGV = ["--arch", "internlm2-1.8b", "--steps", "6", "--batch", "2",
              "--seq", "4096", "--clip-mode", "quantile", "--log-every",
              "1", "--seed", "0"]
TRAIN_PROFILED_STEP = 5         # step 0 warms up, steps 1-4 are timed
# phase 16: qwen2-moe-a2.7b at full width and depth, phase 5's one-shot
# traffic and phase 9's requests on the dense ring (no pages)
MOE_SERVE_ARGV = ["--arch", "qwen2-moe-a2.7b", "--batch", "4",
                  "--prompt-len", "64", "--new-tokens", "16"] + SAMPLER_ARGV
MOE_CONT_ARGV = ["--arch", "qwen2-moe-a2.7b", "--continuous", "--requests",
                 "8", "--slots", "4", "--arrival-burst", "2", "--prompt-len",
                 "512", "--new-tokens", "32"] + SAMPLER_ARGV
# phase 17: granite-moe-3b-a800m at full width, phase 11's batch x seq,
# the bisect capacity cut; depth cut only as far as the byte reckoning
# against this budget (of the card's 80 GB) forces
MOE_TRAIN_STEPS = 5             # step 0 warms up, the last is profiled
MOE_TRAIN_ARGV = ["--arch", "granite-moe-3b-a800m", "--steps",
                  str(MOE_TRAIN_STEPS), "--batch", "2", "--seq", "4096",
                  "--capacity-mode", "bisect", "--clip-mode", "quantile",
                  "--log-every", "1", "--seed", "0"]
MOE_TRAIN_BUDGET = 70e9
# phases 19 and 20: the recurrent families at full width and depth with
# phase 5's sampler, one-shot and on the dense ring (8 requests, n_new
# uniform in [16, 32], two arriving a step, 4 slots) at step horizons 1
# and 4.  xlstm: phase 5's one-shot traffic, 500-token prompts (not a
# multiple of the mLSTM chunk); hymba: a 4096-token one-shot prompt (K7 in
# the prefill, the SWA ring wrapped), 1500-token prompts (past the window,
# under FLASH_MIN_SEQ)
XLSTM_SERVE_ARGV = ["--arch", "xlstm-1.3b", "--batch", "4", "--prompt-len",
                    "64", "--new-tokens", "16"] + SAMPLER_ARGV
XLSTM_CONT_ARGV = ["--arch", "xlstm-1.3b", "--continuous", "--requests", "8",
                   "--slots", "4", "--arrival-burst", "2", "--prompt-len",
                   "500", "--new-tokens", "32"] + SAMPLER_ARGV
HYMBA_SERVE_ARGV = ["--arch", "hymba-1.5b", "--batch", "2", "--prompt-len",
                    "4096", "--new-tokens", "16"] + SAMPLER_ARGV
HYMBA_CONT_ARGV = ["--arch", "hymba-1.5b", "--continuous", "--requests", "8",
                   "--slots", "4", "--arrival-burst", "2", "--prompt-len",
                   "1500", "--new-tokens", "32"] + SAMPLER_ARGV
# the f32 check of prefill + decode steps against the forward, depth cut
# to the first run of each kind: (prompt, positions compared) an arch (the
# hymba prompt runs past its window of 1024); its tolerance, a fraction of
# the logits' largest |value|
RECURRENT_CHECK = {"xlstm-1.3b": (100, 9), "hymba-1.5b": (1100, 9),
                   "whisper-tiny": (32, 9)}
RECURRENT_F32_TOL = 1e-3
# K3-K5 at the later paths' (B, vocab) rows, K7 at hymba's prefill and at
# the int8 serve's 4096-token admission (qwen3-4b at B = 1)
NEW_VOCABS = {"xlstm-serve": (PATH_B, 50304), "hymba-serve": (PATH_B, 32001),
              "whisper-serve": (16, 51865)}
K7_HYMBA = dict(B=2, S=4096, H=25, Hk=5, D=64, window=1024)
K7_INT8 = dict(B=1, S=4096, H=32, Hk=8, D=128, window=0)
# phase 21: whisper-tiny at full width and depth.  One-shot: batch
# transcription of 30 s segments, 16 x 32-token prompts and 128 new tokens
# (under the decoder's 448 positions, hf:openai/whisper-tiny
# max_target_positions); continuous: 16 requests, each with its own
# frames, over 8 slots of the dense ring, n_new uniform in [64, 128], two
# arriving a step, at step horizons 1 and 4
WHISPER_SERVE_ARGV = ["--arch", "whisper-tiny", "--batch", "16",
                      "--prompt-len", "32", "--new-tokens", "128"
                      ] + SAMPLER_ARGV
WHISPER_CONT = dict(requests=16, slots=8, prompt=32, new=128, burst=2)
WHISPER_WINDOW = 16             # graphed steps profiled, every slot live
# phase 22: qwen3-4b at full width with an int8 K/V cache on the dense
# ring: long-context chat, 8 requests of 4096 prompt tokens (K7 in each
# admission), n_new uniform in [16, 32], 4 slots.  The int8 step is held
# against the f32 step (f32 compute and cache) within INT8_VS_BF16 times
# the bf16 step's own distance from it.  JAX's contract, an int8 step
# within 0.02 of the largest |logit| of the bf16 step's
# (tests/test_models_smoke.py, held on the CPU at reduced size), cannot
# hold at this width and depth: the bf16 step alone lies 0.044 of the
# largest |logit| from the f32 step there (PERF.md, PR 23), and the
# int8 step's reading against it is printed beside the check
INT8_CONT_ARGV = ["--arch", "qwen3-4b", "--continuous", "--requests", "8",
                  "--slots", "4", "--arrival-burst", "2", "--prompt-len",
                  "4096", "--new-tokens", "32"] + SAMPLER_ARGV
INT8_VS_BF16 = 2.0
INT8_JAX_CONTRACT = 0.02
# phases 23-25: the hybrid, SSM and enc-dec families trained at full width
# as JAX's make_train_step trains them (remat, the quantile clip through
# K2, AdamW; random bf16 weights from seed 0); step 0 warms up, steps 1-2
# are timed, step 3 is profiled.  Their steps are host-bound (10**5-10**6
# eager launches), so the run's time limit cuts depth: hymba to its layers
# 0-16 (two of its three global layers; further only if the byte
# reckoning against MOE_TRAIN_BUDGET forces it) at phase 11's batch 2 x
# 4096 (K7 banded on its sliding-window layers); xlstm to 12 layers (its
# sLSTM at layers 0 and 8) at batch 2 x 1024, a sequence cut from
# train_4k's 4096 (the sLSTM is a loop over time, run twice forward under
# remat and once backward); whisper through train.step.make_train_step (the launcher
# refuses enc-dec, as JAX's: its batches carry no frames) at 16 x 448
# decoder tokens (the decoder's 448 positions, hf:openai/whisper-tiny)
# with (16, 1500, 384) bf16 frames, in two microbatches
FAMILY_TRAIN_STEPS = 4
HYMBA_TRAIN_LAYERS = 17
XLSTM_TRAIN_LAYERS = 12
_FAMILY_TRAIN_ARGV = ["--steps", str(FAMILY_TRAIN_STEPS), "--batch", "2",
                      "--clip-mode", "quantile", "--log-every", "1",
                      "--seed", "0"]
HYMBA_TRAIN_ARGV = ["--arch", "hymba-1.5b", "--seq", "4096"
                    ] + _FAMILY_TRAIN_ARGV
XLSTM_TRAIN_ARGV = ["--arch", "xlstm-1.3b", "--seq", "1024", "--layers",
                    str(XLSTM_TRAIN_LAYERS)] + _FAMILY_TRAIN_ARGV
WHISPER_TRAIN = dict(batch=16, seq=448, microbatches=2)
# the references: hymba at full width cut to its layers 0-2 (one global,
# two sliding-window), f32 params, batch 1 x 4096, the loss and gradients
# with K7 against those with its plain version (the forward in bf16, as
# trained); xlstm at phase 19's reference depth (an sLSTM and 7 mLSTM
# layers), batch 2 x 200 (past three mLSTM chunks), and whisper at full
# depth, batch 2 x 448 with frames, f32 params and forward (TF32 off): the
# card against the CPU port on the same weights and batch, within
# CARD_VS_CPU of the CPU's loss (rtol) and of each gradient's l2 norm.  On
# an H100 80GB HBM3 at 700 W the card read xlstm's loss 4.25e-7 and its
# worst gradient 1.7e-4 from the CPU's, whisper's 0 and 1.63e-6 (float
# sums in another order, carried through the recurrences)
HYMBA_REF = dict(layers=3, batch=1, seq=4096, loss_rtol=1e-4, grad_rel=2e-2)
XLSTM_REF = dict(layers=8, batch=2, seq=200)
WHISPER_REF = dict(batch=2, seq=448)
CARD_VS_CPU = dict(loss_rtol=1e-5, grad_rel=1e-3)
FAULT_ARGV = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cuda",
              "--steps", "10", "--batch", "4", "--seq", "64", "--clip-mode",
              "quantile", "--ckpt-every", "5", "--log-every", "1"]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def free_memory() -> None:
    """Collects the garbage earlier phases left (reference cycles that
    still hold device tensors) and returns the allocator's cached blocks,
    so that a phase's peak memory counts its own tensors."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _event_ms(run) -> float:
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def device_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one fn() call in ms, without the host's launch cost:
    ``calls`` calls captured in one CUDA graph, replayed ``reps`` times
    between CUDA events; the median replay over ``calls``.  Inputs stay
    in the 50 MB L2 between calls, as the sampler's logits do."""
    return statistics.median(device_ms_reps(fn, calls, reps))


def device_ms_reps(fn, calls: int = 20, reps: int = 5) -> list[float]:
    """``device_ms``'s ``reps`` readings, each a replay over ``calls``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = [_event_ms(graph.replay) / calls for _ in range(reps)]
    del graph
    return times


def call_ms(fn, reps: int = 20) -> float:
    """Median time of one fn() call between CUDA events, host launch cost
    included: what an eager caller such as the sampler pays."""
    fn()
    return statistics.median(_event_ms(fn) for _ in range(reps))


def replay_equals_eager(fn) -> bool:
    """fn()'s outputs from a CUDA-graph replay of one call equal an eager
    call's, bit for bit."""
    import torch

    def bits(out):
        return [t.view(torch.int32) for t in
                (out if isinstance(out, tuple) else (out,))]

    want = bits(fn())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = bits(fn())
    graph.replay()
    torch.cuda.synchronize()
    del graph
    return all(torch.equal(g, w) for g, w in zip(got, want))


def kernels_per_call(fn) -> dict:
    """The device kernels one eager fn() call launches, by name, counted
    under torch.profiler after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


# the kernel a "hopper" solve of each kind launches once a round, and
# the kernels the solves launch
ROUND_KERNEL = {"count_above": "multi_count", "count_below": "multi_count",
                "mass_at_or_above": "multi_mass",
                "entropy_at_temperature": "multi_entropy_moments"}
SOLVER_KERNELS = ("multi_count", "runahead_topk_threshold", "multi_mass",
                  "multi_entropy_moments")


def forget_decisions() -> None:
    """Clear the tuner's record of recent decisions (``tuning.explain``)
    before a path is driven, so that it reports that path's alone."""
    from repro_torch.core import tuning

    tuning.tuner().recent.clear()
    tuning.tuner().recent_kernels.clear()


def decisions(backend: str = "hopper") -> dict:
    """{(kind, B, fused): (Decision, budget)} of the solves that asked for
    ``backend`` since the record was cleared, from ``tuning.explain``;
    ``fused`` where the key is a static top-k's (K3's whole solve)."""
    from repro_torch.core import tuning

    out = {}
    for key, d in tuning.explain():
        parts = key.split("|")
        f = dict(p.split("=", 1) for p in parts if "=" in p)
        if f["pref"] != backend:
            continue
        k = (parts[0], int(f["B"]), parts[-1] == "fused")
        check(k not in out, f"two decisions for {k}: {tuning.explain()}")
        out[k] = (d, int(f["iters"]))
    return out


def decisions_note(backend: str = "hopper") -> str:
    """This path's decisions, one ``kind B=.. spec_k x rounds [source]``
    each."""
    return "; ".join(
        f"{kind} B={B}{' fused' if fused else ''} spec_k {d.spec_k} x "
        f"{d.rounds} rounds of {budget} steps [{d.source}]"
        for (kind, B, fused), (d, budget) in sorted(
            decisions(backend).items()))


def solver_launches(solves: dict) -> dict:
    """The K2-K5 launches that ``solves`` ({(kind, B, fused): number of
    solves}) make through the "hopper" backend under the decisions the
    tuner reports for them: K3's whole solve once where the key is fused
    and the decision's rounds are whole (``solve_kind`` passes
    ``iterations=`` otherwise, which takes the engine's loop); else the
    kind's kernel once a round, and once more for the sign at lo0, which
    the engine knows only for a static top-k or quantile target."""
    table = decisions()
    out = dict.fromkeys(SOLVER_KERNELS, 0)
    for (kind, B, fused), n in solves.items():
        if not n:
            continue
        check((kind, B, fused) in table,
              f"no decision for {kind} at B={B} (fused {fused}): "
              f"{sorted(table)}")
        d, budget = table[(kind, B, fused)]
        # K3's whole solve needs whole rows: never under a vocab split
        if fused and d.rounds * d.spec_k == budget and d.placement != "vocab":
            out["runahead_topk_threshold"] += n
            continue
        probe = kind != "count_below" and not (kind == "count_above"
                                                and fused)
        out[ROUND_KERNEL[kind]] += n * (d.rounds + int(probe))
    return out


def sampler_solves(samples: dict, per_row_k: int = 0) -> dict:
    """The solves of ``samples`` ({B: number of samples}) through phase
    5's sampler (a static top-k, top-p and the entropy temperature, one
    solve each a sample), ``per_row_k`` of the B = PATH_B samples with a
    top-k per row (the engine's loop over K2, no whole solve)."""
    out = {}
    for B, n in samples.items():
        for kind, fused in (("count_above", True),
                            ("mass_at_or_above", False),
                            ("entropy_at_temperature", False)):
            out[(kind, B, fused)] = out.get((kind, B, fused), 0) + n
    if per_row_k:
        out[("count_above", PATH_B, True)] -= per_row_k
        out[("count_above", PATH_B, False)] = per_row_k
    return out


def check_solver_launches(launches: dict, solves: dict, what: str) -> dict:
    """Checks that a path's K2-K5 launches are those its solves make under
    the decisions the tuner reports (``solver_launches``); returns them."""
    want = solver_launches(solves)
    got = {name: launches[name] for name in SOLVER_KERNELS}
    check(got == want, f"{what}: K2-K5 launches {got}, where the tuner's "
                       f"decisions ({decisions_note()}) give {want}")
    return want


def _stage_note(stages: dict) -> str:
    """The stage clock (csrc/row_reduce.cuh): us since a call's first
    block started, the median over blocks, then over 9 calls (min-max)."""
    return ("stage clock, us since the first block's start (median over "
            "blocks, then over 9 calls, min-max): " + ", ".join(
                f"{stage} {med:.2f} ({lo:.2f}-{hi:.2f})"
                for stage, (lo, med, hi) in stages.items()))


def _one_kernel(fn, name: str) -> str:
    """Checks that one eager fn() call launches the one device kernel
    ``name`` and nothing else; says so."""
    kernels = kernels_per_call(fn)
    check(len(kernels) == 1 and all(name in k and n == 1
                                    for k, n in kernels.items()),
          f"a call launched {kernels}, not one {name}")
    return f"1 {name} a call, profiled"


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_sm_clock_hz() -> float:
    """The card's top SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(smi)
    say(f"phase 1 card: {smi} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | TF32 off (matmul and cuDNN)")
    return smi


def phase_build():
    from repro_torch.kernels import build, row_reduce

    seconds = build.build_all(build.SOURCES + row_reduce.STAGE_BUILDS)
    say(f"phase 2 build: {len(build.SOURCES)} kernels and "
        f"{len(row_reduce.STAGE_BUILDS)} stage-clock variants in "
        f"{seconds:.1f}s (parallel nvcc, sm_90a)")
    for name in build.SOURCES:
        kernel = ""
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else ""
            elif "Used" in line or "spill" in line:
                say(f"  ptxas {name} {_short(kernel)}: {line.strip()}")
    # IEEE division in K1 (FCHK, its range check; MUFU.RCP; CALL, the slow
    # path's subroutine); K2's compare and add a pair
    _say_sass("taylor_eval", ("FCHK", "MUFU.RCP", "CALL"))
    _say_sass("multi_count", K2_SASS)


def _short(symbol: str) -> str:
    """A kernel's name from its mangled symbol (the last name of a nested
    one), with a bool template argument as <true> / <false>."""
    i = 3 if symbol.startswith("_ZN") else 2 if symbol.startswith("_Z") else 0
    name = ""
    while i and i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
        if not symbol.startswith("_ZN"):
            break
    rest = symbol[i:]
    return (name or symbol[:40]) + ("<true>" if rest.startswith("ILb1E") else
                                    "<false>" if rest.startswith("ILb0E")
                                    else "")


def _sass_counts(name: str, ops: tuple[str, ...]) -> dict | None:
    """Per kernel of a built library, how many SASS instructions have each
    opcode of ``ops`` (an opcode and its modifiers: "FSET" counts
    FSET.BF.GT.AND, not FSETP); None where the toolkit has no cuobjdump."""
    import re
    import shutil

    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = _short(line.split("Function :")[1].strip())
            counts[fn] = dict.fromkeys(ops, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if fn is not None and m:
            for op in ops:
                if m.group(1) == op or m.group(1).startswith(op + "."):
                    counts[fn][op] += 1
    return counts


def _say_sass(name: str, ops: tuple[str, ...]) -> dict | None:
    counts = _sass_counts(name, ops)
    say(f"  sass {name}: " + ("not measured (no cuobjdump)" if counts is None
                              else "; ".join(
        f"{fn} " + " ".join(f"{op} {n}" for op, n in c.items())
        for fn, c in counts.items())))
    return counts


def phase_kernels(gen):
    import torch

    from repro_torch.core import solver
    from repro_torch.kernels import multi_count as mc
    from repro_torch.kernels import multi_entropy as me
    from repro_torch.kernels import multi_mass as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import row_reduce
    from repro_torch.kernels import runahead_threshold as rt

    dev = torch.device("cuda")
    rows = {}

    def logits(B, V):
        return torch.randn((B, V), generator=gen, device=dev) * 2.0

    def between(x, M):
        """Candidates as the engine passes them: the interior columns of a
        (B, M + 2) grid, a row-strided view."""
        lo, hi = x.amin(-1, keepdim=True), x.amax(-1, keepdim=True)
        grid = lo + (hi - lo) * torch.rand((x.shape[0], M + 2), generator=gen,
                                           device=dev)
        grid[:, 1] = x[:, 7]              # a candidate equal to an element
        return grid[:, 1:-1]

    shapes = [(PATH_B, PATH_V, PATH_M), (PATH_B, PATH_V, 1), (3, 1000, 31),
              (3, 257, 31), (3, 1000, 1)]

    # K2: multi_count, exact, in both directions, one launch a call
    rows["multi_count"] = _row_k2(gen, logits, between, shapes)

    # K3: runahead_topk_threshold, exact against plain and the generic loop
    kw = dict(k_target=40, rounds=8, spec_k=5)
    err = 0.0
    for B, V, _ in shapes:
        x = logits(B, V)
        got = rt.runahead_topk_threshold_cuda(x, **kw)
        want = rt.runahead_topk_threshold_plain(x, **kw)
        prob = solver.problem("count_above", x, backend="hopper", k=40)
        loop = solver._solve_rounds(prob.multi_eval, prob.lo0, prob.hi0,
                                    rounds=8, spec_k=5, sign_lo=prob.sign_lo)
        for g, w, l in zip(got, want, loop):
            check(torch.equal(g, w), f"K3 differs from plain at {(B, V)}")
            check(torch.equal(g, l), f"K3 differs from the loop at {(B, V)}")
            err = max(err, (g - w).abs().max().item())
    # rows holding NaN (one lane; every lane): (NaN, NaN), as the plain
    # version and the reference give
    x = logits(PATH_B, PATH_V)
    x[1, 40] = float("nan")
    x[2] = float("nan")
    got = rt.runahead_topk_threshold_cuda(x, **kw)
    want = rt.runahead_topk_threshold_plain(x, **kw)
    for g, w in zip(got, want):
        check(torch.equal(g.isnan(), w.isnan())
              and torch.equal(g[~g.isnan()].view(torch.int32),
                              w[~w.isnan()].view(torch.int32))
              and bool(g[1:3].isnan().all()),
              f"K3 differs from plain on NaN rows: {g.tolist()} vs "
              f"{w.tolist()}")
    x = logits(PATH_B, PATH_V)
    # the work the bracket needs: min, max, the sign at lo0, and one count
    # per step of the serial bisection it equals bit for bit (the other
    # 2**spec_k - 1 - spec_k candidates of a round are runahead's spare work)
    n_cmp = 2 + 1 + kw["rounds"] * kw["spec_k"]
    clusters, size = rt.cluster_geometry(PATH_B, PATH_V)
    k3_ms = device_ms(lambda: ops.runahead_topk_threshold(x, **kw))
    topk_ms = device_ms(lambda: torch.topk(x, 40, dim=-1))
    other = 8 if clusters == 16 else 16
    ms_other = device_ms(lambda: rt.runahead_topk_threshold_cuda(
        x, clusters=other, **kw))
    rows["runahead_topk_threshold"] = dict(
        source="src/repro_torch/kernels/csrc/runahead_threshold.cu",
        replaces="src/repro/kernels/runahead_threshold.py:123",
        max_abs_err=err, ms=k3_ms,
        call_ms=call_ms(lambda: ops.runahead_topk_threshold(x, **kw)),
        plain_ms=device_ms(
            lambda: rt.runahead_topk_threshold_plain(x, **kw), calls=2),
        bound=bound_ms(4 * (x.numel() + 2 * PATH_B), 2 * x.numel() * n_cmp),
        library_ms=topk_ms,
        note=f"a cluster of {clusters} CTAs per row, {size} elements "
             f"({size * 4 / 1024:.1f} KiB) of shared memory each: "
             f"{PATH_B * clusters} CTAs of the card's 132 SMs for "
             f"B={PATH_B}; {k3_ms / topk_ms:.3f}x torch.topk; {other} CTAs "
             f"a row {ms_other:.4f} ms; rows holding NaN (one lane, a whole "
             f"row) give (NaN, NaN) as the plain version")

    # K4: multi_mass, tolerance and bit-stable run to run
    err = 0.0
    for B, V, M in shapes:
        p = torch.softmax(logits(B, V), dim=-1)
        taus = between(p, M)
        taus[:, -1] = 0.0                 # the engine's probe point (tau = 0)
        got = mm.multi_mass_cuda(p, taus)
        check(torch.equal(got, mm.multi_mass_cuda(p, taus)),
              f"K4 not bit-stable at {(B, V, M)}")
        want = mm.multi_mass_plain(p, taus)
        check(torch.allclose(got, want, **TOL), f"K4 differs at {(B, V, M)}")
        err = max(err, (got - want).abs().max().item())
    p = torch.softmax(logits(PATH_B, PATH_V), dim=-1)
    taus = between(p, PATH_M)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f_sm = max_sm_clock_hz()
    nb = row_reduce.blocks_per_row(PATH_B, PATH_V, sms)
    one = _one_kernel(lambda: ops.multi_mass(p, taus), "multi_mass_kernel")
    grid = (f"one launch per call ({one}); grid {PATH_B * nb} blocks of "
            f"{row_reduce.THREADS} ({nb} a row) on {sms} SMs")
    check(replay_equals_eager(lambda: mm.multi_mass_cuda(p, taus)),
          "K4 differs between eager and CUDA-graph replay")
    pairs = p.numel() * PATH_M
    # a compare, a select and an add a pair, one FP32 lane each
    issue_ms = 3 * pairs / (sms * FP32_LANES * f_sm) * 1e3
    rows["multi_mass"] = dict(
        source="src/repro_torch/kernels/csrc/multi_mass.cu",
        replaces="src/repro/kernels/multi_mass.py:65", max_abs_err=err,
        ms=device_ms(lambda: ops.multi_mass(p, taus)),
        call_ms=call_ms(lambda: ops.multi_mass(p, taus)),
        plain_ms=device_ms(lambda: mm.multi_mass_plain(p, taus)),
        probe_ms=device_ms(lambda: ops.multi_mass(p, taus[:, :1])),
        bound=bound_ms(4 * (p.numel() + 2 * taus.numel()), 3 * pairs),
        library_ms=None,
        note=f"{grid}; eager == graph replay bit for bit; instruction "
             f"issue of 3 a pair {issue_ms:.6f} ms ({FP32_LANES} FP32 lanes "
             f"x {sms} SMs at {f_sm / 1e9:.3f} GHz); " + _stage_note(
                 row_reduce.stage_times("multi_mass", p, taus, 1)))

    # K5: multi_entropy_moments, tolerance and bit-stable run to run
    err = 0.0
    for B, V, M in shapes:
        x = logits(B, V)
        z = x - x.amax(-1, keepdim=True)
        grid = torch.exp(torch.empty((B, M + 2), device=dev).uniform_(
            -3.0, 3.0, generator=gen))
        grid[:, -2] = 20.0                # the engine's bracket (t_hi)
        grid[:, 1] = 0.05                 # (t_lo)
        ts = grid[:, 1:-1]
        got = me.multi_entropy_moments_cuda(z, ts)
        again = me.multi_entropy_moments_cuda(z, ts)
        want = me.multi_entropy_moments_plain(z, ts)
        for g, a, w in zip(got, again, want):
            check(torch.equal(g, a), f"K5 not bit-stable at {(B, V, M)}")
            check(torch.allclose(g, w, **TOL), f"K5 differs at {(B, V, M)}")
            err = max(err, (g - w).abs().max().item())
    x = logits(PATH_B, PATH_V)
    z = x - x.amax(-1, keepdim=True)
    ts = torch.exp(torch.empty((PATH_B, PATH_M + 2), device=dev).uniform_(
        -3.0, 3.0, generator=gen))[:, 1:-1]
    check(replay_equals_eager(lambda: me.multi_entropy_moments_cuda(z, ts)),
          "K5 differs between eager and CUDA-graph replay")
    pairs = z.numel() * PATH_M
    # one exponential a pair on the SFU, and 4 FP32 flops (a multiply, an
    # add, an FMA); the larger bounds
    sfu_ms = pairs / (sms * SFU_PER_CLOCK * f_sm) * 1e3
    fp32 = bound_ms(4 * (z.numel() + 3 * ts.numel()), 4 * pairs)
    one = _one_kernel(lambda: ops.multi_entropy_moments(z, ts),
                      "multi_entropy_kernel")
    grid = (f"one launch per call ({one}); grid {PATH_B * nb} blocks of "
            f"{row_reduce.THREADS} ({nb} a row) on {sms} SMs")
    rows["multi_entropy_moments"] = dict(
        source="src/repro_torch/kernels/csrc/multi_entropy.cu",
        replaces="src/repro/kernels/multi_entropy.py:84", max_abs_err=err,
        ms=device_ms(lambda: ops.multi_entropy_moments(z, ts)),
        call_ms=call_ms(lambda: ops.multi_entropy_moments(z, ts)),
        plain_ms=device_ms(lambda: me.multi_entropy_moments_plain(z, ts)),
        probe_ms=device_ms(lambda: ops.multi_entropy_moments(z, ts[:, :1])),
        bound=max((sfu_ms, "operations"), fp32), library_ms=None,
        note=f"{grid}; eager == graph replay bit for bit; bound: one "
             f"exponential a pair at the SFU's {SFU_PER_CLOCK} a clock per "
             f"SM ({sms} SMs at {f_sm / 1e9:.3f} GHz) {sfu_ms:.6f} ms, "
             f"beside 4 FP32 flops a pair and the bytes {fp32[0]:.6f} ms "
             f"({fp32[1]}); " + _stage_note(
                 row_reduce.stage_times("multi_entropy", z, ts, 2)))

    rows["runahead_topk_threshold"]["library"] = "torch.topk"
    rows.update(_rows_k1(gen))
    rows.update(_rows_k6(gen))
    rows.update(_rows_k7(gen))
    for name, r in rows.items():
        say(f"phase 3 {name}: parity ok (max_abs_err {r['max_abs_err']:.3g}) "
            f"| device {r['ms']:.4f} ms per call ({r['call_ms']:.4f} ms with "
            f"the host's launch), plain {r['plain_ms']:.4f} ms, bound "
            + (f"{r['latency_bound'][0]:.6f} ms (latency; the operations "
               f"bound {r['bound'][0]:.6f} ms)" if "latency_bound" in r else
               f"{r['bound'][0]:.6f} ms ({r['bound'][1]})")
            + (f", {r['library']} {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
            + (f" | M=1 probe device {r['probe_ms']:.4f} ms"
               if "probe_ms" in r else "")
            + (f" | {r['note']}" if "note" in r else ""))
    return rows


def _special_rows(x):
    """x with +0 and -0 in every fifth lane, NaN lanes in the first row,
    +inf and -inf lanes in the last."""
    x = x.clone()
    x[:, 1::5] = 0.0
    x[:, 2::5] = -0.0
    x[0, 3::7] = float("nan")
    x[-1, 4::11] = float("inf")
    x[-1, 6::13] = float("-inf")
    return x


def _row_k2(gen, logits, between, shapes):
    """K2 against its plain version, bit for bit, counting above and below,
    at the sampler's shapes, B = 64 with two candidate tiles and the
    quantile clip's single row, on random rows and rows of NaN, +-inf and
    +-0 with candidates -0, +0, +-inf and NaN among them; run to run and
    between an eager call and graph replay; one launch a call; timed in
    both directions beside the first version, with its bound restated for
    the SASS's instructions a pair and its stage clock."""
    import torch

    from repro_torch.kernels import multi_count as mc
    from repro_torch.kernels import ops
    from repro_torch.kernels import row_reduce

    err = 0.0
    for B, V, M in shapes + [(64, PATH_V, 33), K2_CLIP, K2_CLIP_WIDE]:
        for special in (False, True):
            x = logits(B, V)
            taus = between(x, M)
            if special:
                x = _special_rows(x)
                specials = (-0.0, 0.0, float("inf"), float("-inf"),
                            float("nan"))
                for i, v in enumerate(specials[:max(0, M - 1)]):
                    taus[:, i + 1] = v
            for below in (False, True):
                got = mc.multi_count_cuda(x, taus, below)
                want = mc.multi_count_plain(x, taus, below)
                check(torch.equal(got, mc.multi_count_cuda(x, taus, below)),
                      f"K2 not bit-stable at {(B, V, M)}, below={below}")
                check(torch.equal(got, want), f"K2 differs at {(B, V, M)}, "
                      f"below={below}, special rows={special}")
                err = max(err, (got - want).abs().max().item())
    x = logits(PATH_B, PATH_V)
    taus = between(x, PATH_M)
    both = lambda: (mc.multi_count_cuda(x, taus),
                    mc.multi_count_cuda(x, taus, True))
    check(replay_equals_eager(both),
          "K2 differs between eager and CUDA-graph replay")
    one = [_one_kernel(lambda b=b: ops.multi_count(x, taus, below=b),
                       "multi_count_kernel") for b in (False, True)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f_sm = max_sm_clock_hz()
    nb = row_reduce.blocks_per_row(PATH_B, PATH_V, sms)
    pairs = x.numel() * PATH_M
    # instructions a pair from the SASS: the unrolled bodies compare each
    # of 32 candidates with 4 elements (add4) and 1 (add1), and add each
    # hit, beside 32 more FADDs (to_acc)
    sass = _sass_counts("multi_count", K2_SASS) or {}
    per_pair = [(c["FSET"] + c["FADD"] - 32) / (5 * 32)
                for c in sass.values()]
    ipp = max(per_pair) if per_pair else 2.0
    issue_ms = ipp * pairs / (sms * FP32_LANES * f_sm) * 1e3
    n_bytes = 4 * (x.numel() + 2 * taus.numel())
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    below_ms = device_ms(lambda: ops.multi_count(x, taus, below=True))
    below_call = call_ms(lambda: ops.multi_count(x, taus, below=True))
    clip = torch.rand(K2_CLIP[:2], generator=gen, device="cuda")
    clip_ms = [device_ms(lambda m=m: ops.multi_count(
        clip, clip[:, :m] * 0.9, below=True))
        for m in (K2_CLIP[2], K2_CLIP_WIDE[2])]
    return dict(
        source="src/repro_torch/kernels/csrc/multi_count.cu",
        replaces="src/repro/kernels/multi_count.py:69", max_abs_err=err,
        ms=device_ms(lambda: ops.multi_count(x, taus)),
        call_ms=call_ms(lambda: ops.multi_count(x, taus)),
        plain_ms=device_ms(lambda: mc.multi_count_plain(x, taus)),
        probe_ms=device_ms(lambda: ops.multi_count(x, taus[:, :1])),
        bound=bound_ms(n_bytes, ipp * pairs), library_ms=None,
        library="none (no single PyTorch call counts a row against M "
                "thresholds: torch.searchsorted needs a sort first)",
        note=f"one launch per call ({one[0]}; below: {one[1]}); grid "
             f"{PATH_B * nb} blocks of {row_reduce.THREADS} ({nb} a row); "
             f"eager == graph replay bit for bit; below (x < tau) device "
             f"{below_ms:.4f} ms ({below_call:.4f} eager); the first "
             f"version (3 launches: zero fill, count, cast) "
             f"{K2_FIRST_MS[0]:.4f} ms ({K2_FIRST_MS[1]:.4f} eager, H100 80GB "
             f"HBM3 at 700 W); the quantile clip's {K2_CLIP} below "
             f"{clip_ms[0]:.4f} ms, {K2_CLIP_WIDE} {clip_ms[1]:.4f} ms; "
             f"bound: bytes "
             f"{bytes_ms:.6f} ms, issue of {ipp:g} instructions a pair "
             f"(SASS: " + "; ".join(
                 f"{fn} " + " ".join(f"{op} {n}" for op, n in c.items())
                 for fn, c in sass.items()) + f") {issue_ms:.6f} ms "
             f"({FP32_LANES} lanes x {sms} SMs at {f_sm / 1e9:.3f} GHz); "
             + _stage_note(row_reduce.stage_times("multi_count", x, taus, 1)))


def _rows_k1(gen):
    """K1 against its plain version, bit for bit, at every point count a
    runahead round of the paper path uses (1 serial, up to 31 at k=5)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import taylor_eval as te

    for M in (1, 7, 31):
        for terms in (10, K1_TERMS):
            x = torch.rand((M,), generator=gen, device="cuda") + 1.0
            got = te.taylor_sincos_cuda(x, terms=terms)
            check(torch.equal(got, te.taylor_sincos_plain(x, terms=terms)),
                  f"K1 differs from its plain version at M={M}, "
                  f"terms={terms}")
    x = torch.rand((31,), generator=gen, device="cuda") + 1.0
    x1 = x[:1].clone()
    steps = 2 * (K1_TERMS - 1)
    # operations: per term and recurrence a multiply, a division, an add
    # and the two-operation denominator
    n_ops = 5 * steps * x.numel()
    # latency: each point is one chain of `steps` steps of K1_CHAIN_DEPTH
    # dependent operations of FMA_LATENCY cycles at the card's top SM clock
    f_sm = max_sm_clock_hz()
    lat_ms = steps * K1_CHAIN_DEPTH * FMA_LATENCY / f_sm * 1e3
    ms = device_ms(lambda: ops.taylor_sincos_eval(x, terms=K1_TERMS), calls=5)
    ms1 = device_ms(lambda: ops.taylor_sincos_eval(x1, terms=K1_TERMS),
                    calls=5)
    old_ms = [device_ms(lambda z=z: te.taylor_sincos_reference_cuda(
        x, terms=K1_TERMS, zero_shortcut=z), calls=2, reps=3)
        for z in (False, True)]
    fma = te.fma_latency_cycles()
    return {"taylor_sincos_eval": dict(
        source="src/repro_torch/kernels/csrc/taylor_eval.cu",
        replaces="src/repro/kernels/taylor_eval.py:61", max_abs_err=0.0,
        ms=ms, call_ms=call_ms(
            lambda: ops.taylor_sincos_eval(x, terms=K1_TERMS), reps=5),
        plain_ms=device_ms(lambda: te.taylor_sincos_plain(x, terms=K1_TERMS),
                           calls=1, reps=3),
        bound=bound_ms(8 * x.numel(), n_ops), library_ms=None,
        latency_bound=(lat_ms, "latency"),
        note=f"M=31, terms={K1_TERMS}: {ms / steps * 1e6:.2f} ns per "
             f"dependent term against the latency bound's "
             f"{lat_ms / steps * 1e6:.2f} ({K1_CHAIN_DEPTH} x {FMA_LATENCY} "
             f"cycles at {f_sm / 1e9:.3f} GHz; measured FMA latency "
             f"{fma:.2f} cycles); M=1 (a serial step) device {ms1:.4f} ms; "
             f"the first version's division (an __fdiv_rn a step) "
             f"{old_ms[0]:.4f} ms, with a zero numerator skipping it "
             f"{old_ms[1]:.4f} ms")}


def _k6_inputs(gen, shape, dtype):
    """Random pools, a table of distinct page ids (0 is the null page and
    is never named), positions and roped-like queries for K6."""
    import torch

    B, P, C, L = shape["B"], shape["P"], shape["C"], shape["L"]
    chain = -(-C // P)
    n_pages = B * chain + 1
    pool = [torch.randn((n_pages, P, shape["nkv"], shape["hd"]),
                        generator=gen, device="cuda").to(dtype)
            for _ in range(2)]
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm[:B * chain].reshape(B, chain).int()
    pos = torch.tensor(shape["pos"], dtype=torch.int32, device="cuda")
    q = torch.randn((B, L, shape["nq"], shape["hd"]), generator=gen,
                    device="cuda").to(dtype)
    return pool[0], pool[1], table, pos, q


def _rows_k6(gen):
    """K6 against its plain version at the served decode shape and at the
    edge shape, f32 and bf16 pools; timed at the served shape in bf16."""
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attend as pa
    from repro_torch.models.attention import _paged_slot_mask, paged_view

    err = 0.0
    for shape in (K6_PATH, K6_MASKED, K6_EDGE):
        for dtype, tol in ((torch.float32, dict(rtol=1e-5, atol=1e-5)),
                           (torch.bfloat16, dict(rtol=1e-2, atol=1e-2))):
            args = _k6_inputs(gen, shape, dtype)
            got = pa.paged_attend_cuda(*args, context=shape["C"])
            check(torch.equal(got, pa.paged_attend_cuda(
                *args, context=shape["C"])),
                  f"K6 not bit-stable at {shape}, {dtype}")
            want = pa.paged_attend_plain(*args, context=shape["C"])
            check(torch.allclose(got.float(), want.float(), **tol),
                  f"K6 differs from its plain version at {shape}, {dtype}")
            err = max(err, (got.float() - want.float()).abs().max().item())
    sh = K6_PATH
    pk, pv, table, pos, q = args = _k6_inputs(gen, sh, torch.bfloat16)
    C, P = sh["C"], sh["P"]
    # the pages this run's data needs: those holding positions <= pos + L-1
    pages = sum(min(table.shape[1], -(-(p + sh["L"]) // P))
                for p in sh["pos"])
    page_bytes = P * sh["nkv"] * sh["hd"] * 2 * 2           # K and V, bf16
    n_bytes = 2 * q.numel() * 2 + pages * page_bytes
    n_ops = 4 * sh["L"] * sh["nq"] * sh["hd"] * sum(
        min(C, p + sh["L"]) for p in sh["pos"])
    # the yardstick: SDPA over the already-gathered dense view, same mask
    # (the gather is not timed)
    k = paged_view(pk, table, C).transpose(1, 2)            # (B,nkv,C,hd)
    v = paged_view(pv, table, C).transpose(1, 2)
    pgrid = pos.long()[:, None] + torch.arange(sh["L"], device="cuda")
    mask = _paged_slot_mask(pgrid, C)[:, None]              # (B,1,L,C)
    qs = q.transpose(1, 2)                                  # (B,nq,L,hd)
    rep = sh["nq"] // sh["nkv"]
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, kr, vr, attn_mask=mask, scale=1.0 / math.sqrt(sh["hd"]))
    return {"paged_attend": dict(
        source="src/repro_torch/kernels/csrc/paged_attend.cu",
        replaces="src/repro/kernels/paged_attend.py:131", max_abs_err=err,
        ms=device_ms(lambda: ops.paged_attend(*args, context=C)),
        call_ms=call_ms(lambda: ops.paged_attend(*args, context=C)),
        plain_ms=device_ms(lambda: pa.paged_attend_plain(*args, context=C),
                           calls=2),
        bound=bound_ms(n_bytes, n_ops), library_ms=device_ms(sdpa),
        library="F.scaled_dot_product_attention (gathered view, gather "
                "not timed)",
        note=f"{pages} pages read, {n_bytes / 1e6:.2f} MB")}


def _k7_inputs(gen, shape, dtype):
    import torch

    B, S, D = shape["B"], shape["S"], shape["D"]
    return [torch.randn((B, S, h, D), generator=gen, device="cuda").to(dtype)
            for h in (shape["H"], shape["Hk"], shape["Hk"])]


def _rows_k7(gen):
    """K7 against its plain version at the training shape in f32 at JAX's
    own K7 tolerance and at the ragged banded shape in f32; in bf16 at the
    training shape by ``flash_fwd.bf16_check`` (its largest |diff| from
    the f32 reference on the same inputs at most the bf16 plain version's
    plus one bf16 ulp, and element by element against the bf16 plain
    version at the kernel's key tile); bit-stable run to run; timed at
    the training shape, with SDPA on the same inputs as the yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_fwd as ff
    from repro_torch.kernels import ops

    errs = {}
    for name, shape, dtype in (("path f32", K7_PATH, torch.float32),
                               ("path bf16", K7_PATH, torch.bfloat16),
                               ("edge f32", K7_EDGE, torch.float32)):
        q, k, v = _k7_inputs(gen, shape, dtype)
        kw = dict(window=shape["window"], n_rep=shape["H"] // shape["Hk"])
        got = ff.flash_fwd_cuda(q, k, v, **kw)
        check(torch.equal(got, ff.flash_fwd_cuda(q, k, v, **kw)),
              f"K7 not bit-stable at {shape}, {dtype}")
        want = ff.flash_fwd_plain(q, k, v, **kw)
        errs[name] = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            check(torch.allclose(got, want, rtol=1e-4, atol=2e-5),
                  f"K7 differs from its plain version at {shape}: max "
                  f"|diff| {errs[name]:.3g}")
            continue
        accuracy = ff.bf16_check(got, q, k, v, **kw)
        check(accuracy.ok,
              f"K7 bf16 less accurate than its plain version at {shape}: "
              f"{accuracy}")
    sh = K7_PATH
    q, k, v = _k7_inputs(gen, sh, torch.bfloat16)
    n_rep = sh["H"] // sh["Hk"]
    B, S, H, Hk, D = sh["B"], sh["S"], sh["H"], sh["Hk"], sh["D"]
    # the causal half of QK^T and of PV: 4 flops per (query, key <= query,
    # dim); Q, K, V read once and O written once, in bf16
    n_ops = 4 * B * H * D * S * (S + 1) / 2
    n_bytes = 2 * (2 * B * S * H * D + 2 * B * S * Hk * D)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    ms = device_ms(lambda: ops.flash_fwd(q, k, v, n_rep=n_rep), calls=5,
                   reps=3)
    return {"flash_fwd": dict(
        source="src/repro_torch/kernels/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_fwd.py:82",
        max_abs_err=max(errs.values()),
        ms=ms, call_ms=call_ms(lambda: ops.flash_fwd(q, k, v, n_rep=n_rep),
                               reps=5),
        plain_ms=device_ms(lambda: ff.flash_fwd_plain(q, k, v, n_rep=n_rep),
                           calls=1, reps=3),
        bound=bound_ms(n_bytes, n_ops, BF16_OPS_PER_S),
        library_ms=device_ms(sdpa, calls=5, reps=3),
        library="F.scaled_dot_product_attention(is_causal, enable_gqa)",
        note=f"B={B} S={S} H={H}/{Hk} D={D} bf16: {n_ops / 1e9:.1f} GFLOP, "
             f"{n_ops / ms / 1e9:.1f} TFLOP/s achieved; bf16 {accuracy}; "
             f"max |diff| from the plain version "
             + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))}



def _rows_new_paths(gen) -> dict:
    """Phase 3 at the later paths' shapes: K3-K5 at B=4 on the vocab rows
    of xlstm-1.3b (50304) and hymba-1.5b (32001, padded to 32128: its 127
    phantom columns at the row's max - 80, where the sampler's clamp puts
    the unembedding's -1e30) and at B=16 on whisper-tiny's (51865, padded
    to 51968: 103 phantom columns), K3 bit for bit, K4 and K5 within rtol
    1e-5 / atol 1e-6; K7 at hymba's prefill shape (B=2, S=4096, 25 query
    heads over 5 K/V heads, head_dim 64, bf16) with window 1024 (its 29
    sliding-window layers) and 0 (its 3 global ones), and at the int8
    serve's admission (qwen3-4b's B=1, S=4096, 32 query heads over 8 K/V
    heads, head_dim 128, causal), each by ``flash_fwd.bf16_check`` and
    bit-stable, timed beside its bound and one SDPA call (a boolean band
    mask for hymba, is_causal for qwen3; enable_gqa).  Returns {path:
    {kernel: row}}."""
    import torch

    from repro_torch.kernels import multi_entropy as me
    from repro_torch.kernels import multi_mass as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import runahead_threshold as rt

    out = {}
    kw = dict(k_target=40, rounds=8, spec_k=5)
    n_cmp = 2 + 1 + kw["rounds"] * kw["spec_k"]
    for path, (PB, vocab) in NEW_VOCABS.items():
        V = -(-vocab // 128) * 128
        x = torch.randn((PB, V), generator=gen, device="cuda") * 2.0
        x[:, vocab:] = x[:, :vocab].amax(-1, keepdim=True) - 80.0
        got = rt.runahead_topk_threshold_cuda(x, **kw)
        want = rt.runahead_topk_threshold_plain(x, **kw)
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"K3 differs from plain at {(PB, V)}")
        clusters, size = rt.cluster_geometry(PB, V)
        k3 = dict(
            source="src/repro_torch/kernels/csrc/runahead_threshold.cu",
            replaces="src/repro/kernels/runahead_threshold.py:123",
            max_abs_err=0.0,
            ms=device_ms(lambda: ops.runahead_topk_threshold(x, **kw)),
            call_ms=call_ms(lambda: ops.runahead_topk_threshold(x, **kw)),
            plain_ms=device_ms(lambda: rt.runahead_topk_threshold_plain(
                x, **kw), calls=2),
            bound=bound_ms(4 * (x.numel() + 2 * PB),
                           2 * x.numel() * n_cmp),
            library_ms=device_ms(lambda: torch.topk(x, 40, dim=-1)),
            library="torch.topk",
            note=f"({PB}, {V}), {V - vocab} phantom columns at max - 80; "
                 f"bit for bit; {clusters} CTAs a row of {size} elements")
        p = torch.softmax(x, dim=-1)
        lo, hi = p.amin(-1, keepdim=True), p.amax(-1, keepdim=True)
        taus = lo + (hi - lo) * torch.rand((PB, PATH_M), generator=gen,
                                           device="cuda")
        got, again = mm.multi_mass_cuda(p, taus), mm.multi_mass_cuda(p, taus)
        want = mm.multi_mass_plain(p, taus)
        check(torch.equal(got, again) and torch.allclose(got, want, **TOL),
              f"K4 differs from plain or is not bit-stable at {(PB, V)}")
        k4 = dict(
            source="src/repro_torch/kernels/csrc/multi_mass.cu",
            replaces="src/repro/kernels/multi_mass.py:65",
            max_abs_err=(got - want).abs().max().item(),
            ms=device_ms(lambda: ops.multi_mass(p, taus)),
            call_ms=call_ms(lambda: ops.multi_mass(p, taus)),
            plain_ms=device_ms(lambda: mm.multi_mass_plain(p, taus)),
            bound=bound_ms(4 * (p.numel() + 2 * taus.numel()),
                           3 * p.numel() * PATH_M),
            library_ms=None, library="none",
            note=f"({PB}, {V}) x M={PATH_M}; bit-stable")
        z = x - x.amax(-1, keepdim=True)
        ts = torch.exp(torch.empty((PB, PATH_M), device="cuda").uniform_(
            -3.0, 3.0, generator=gen))
        got = me.multi_entropy_moments_cuda(z, ts)
        again = me.multi_entropy_moments_cuda(z, ts)
        want = me.multi_entropy_moments_plain(z, ts)
        err = 0.0
        for g, a, w in zip(got, again, want):
            check(torch.equal(g, a) and torch.allclose(g, w, **TOL),
                  f"K5 differs from plain or is not bit-stable at "
                  f"{(PB, V)}")
            err = max(err, (g - w).abs().max().item())
        pairs = z.numel() * PATH_M
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        sfu_ms = pairs / (sms * SFU_PER_CLOCK * max_sm_clock_hz()) * 1e3
        k5 = dict(
            source="src/repro_torch/kernels/csrc/multi_entropy.cu",
            replaces="src/repro/kernels/multi_entropy.py:84",
            max_abs_err=err,
            ms=device_ms(lambda: ops.multi_entropy_moments(z, ts)),
            call_ms=call_ms(lambda: ops.multi_entropy_moments(z, ts)),
            plain_ms=device_ms(lambda: me.multi_entropy_moments_plain(z, ts)),
            bound=max((sfu_ms, "operations"),
                      bound_ms(4 * (z.numel() + 3 * ts.numel()), 4 * pairs)),
            library_ms=None, library="none",
            note=f"({PB}, {V}) x M={PATH_M}; bit-stable; the SFU's "
                 f"exponentials bound it")
        out[path] = {"runahead_topk_threshold": k3, "multi_mass": k4,
                     "multi_entropy_moments": k5}

    rows = {window: _k7_row(gen, K7_HYMBA, window, band_mask=True)
            for window in (K7_HYMBA["window"], 0)}
    for window, r in rows.items():
        say_row(f"phase 3 flash_fwd hymba-prefill window {window}", r)
    # the row of the path: its 29 banded layers' shape; the 3 global
    # layers' reading beside it
    g = rows[0]
    row = dict(rows[K7_HYMBA["window"]])
    row["note"] += (f" | window 0 (the global layers): {g['ms']:.4f} ms, "
                    f"bound {g['bound'][0]:.6f} ms, SDPA "
                    f"{g['library_ms']:.4f} ms")
    out["hymba-prefill"] = {"flash_fwd": row}
    for path, by_name in out.items():
        if path == "hymba-prefill":
            continue
        for name, r in by_name.items():
            say_row(f"phase 3 {name} {path}", r)
    # the int8 serve's admissions: qwen3-4b's 4096-token prefill at B = 1
    int8 = _k7_row(gen, K7_INT8, 0, band_mask=False)
    say_row("phase 3 flash_fwd int8-serve", int8)
    out["int8-serve"] = {"flash_fwd": int8}
    return out


def _k7_row(gen, sh: dict, window: int, band_mask: bool) -> dict:
    """K7 at a path's shape ``sh`` in bf16 with ``window``: bit-stable,
    held by ``flash_fwd.bf16_check``, timed beside its bound and one SDPA
    call (GQA; the causal band as a boolean mask where ``band_mask``, else
    is_causal)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_fwd as ff
    from repro_torch.kernels import ops

    B, S, H, Hk, D = sh["B"], sh["S"], sh["H"], sh["Hk"], sh["D"]
    n_rep = H // Hk
    q, k, v = _k7_inputs(gen, sh, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(S, device="cuda")
    got = ff.flash_fwd_cuda(q, k, v, window=window, n_rep=n_rep)
    check(torch.equal(got, ff.flash_fwd_cuda(q, k, v, window=window,
                                             n_rep=n_rep)),
          f"K7 not bit-stable at {sh}, window {window}")
    accuracy = ff.bf16_check(got, q, k, v, window=window, n_rep=n_rep)
    check(accuracy.ok, f"K7 bf16 less accurate than its plain version "
                       f"at {sh}, window {window}: {accuracy}")
    err = (got.float() - ff.flash_fwd_plain(
        q, k, v, window=window, n_rep=n_rep).float()).abs().max().item()
    w = window or S
    # the (query, key) pairs the band holds, 4 flops a pair and dim
    pairs = w * (w + 1) / 2 + (S - w) * w
    n_ops = 4 * B * H * D * pairs
    n_bytes = 2 * (2 * B * S * H * D + 2 * B * S * Hk * D)
    run = lambda: ops.flash_fwd(q, k, v, window=window,  # noqa: E731
                                n_rep=n_rep)
    if band_mask:
        band = pos[None, :] <= pos[:, None]
        if window:
            band &= pos[None, :] > pos[:, None] - window
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=band, enable_gqa=True)
        library = ("F.scaled_dot_product_attention(boolean band mask, "
                   "enable_gqa)")
    else:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        library = "F.scaled_dot_product_attention(is_causal, enable_gqa)"
    ms = device_ms(run, calls=5, reps=3)
    return dict(
        source="src/repro_torch/kernels/csrc/flash_fwd.cu",
        replaces="src/repro/kernels/flash_fwd.py:82", max_abs_err=err,
        ms=ms, call_ms=call_ms(run, reps=5),
        plain_ms=device_ms(lambda: ff.flash_fwd_plain(
            q, k, v, window=window, n_rep=n_rep), calls=1, reps=3),
        bound=bound_ms(n_bytes, n_ops, BF16_OPS_PER_S),
        library_ms=device_ms(sdpa, calls=5, reps=3), library=library,
        note=f"B={B} S={S} H={H}/{Hk} D={D} bf16, window {window}: "
             f"{n_ops / 1e9:.1f} GFLOP, {n_ops / ms / 1e9:.1f} TFLOP/s "
             f"achieved; {accuracy}")

def phase_solves(gen):
    import torch

    from repro_torch.core import solver
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    x = torch.randn((PATH_B, PATH_V), generator=gen, device=dev) * 2.0
    probs = torch.softmax(x, dim=-1)
    k_rows = torch.tensor([1, 40, 300, 5000], device=dev)
    cases = [("count_above", x, dict(k=40)),
             ("count_above", x, dict(k=k_rows)),
             ("mass_at_or_above", probs, dict(p=0.9)),
             ("entropy_at_temperature", x, dict(target=3.0)),
             ("count_below", x, dict(q=0.3))]
    torch.cuda.synchronize()
    ops.reset_launches()
    forget_decisions()
    out = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for kind, operand, params in cases:
            out.append(solver.solve_kind(kind, operand, backend="hopper",
                                         rounds=8, spec_k=5, **params))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = dict(ops.LAUNCHES)
    # one solve of each case: top-k with a static k is the fused key
    check_solver_launches(
        launches, {(kind, PATH_B, kind == "count_above"
                    and isinstance(params.get("k"), int)): 1
                   for kind, _, params in cases}, "phase 4 solves")
    (below, _), = [v for k, v in decisions().items()
                   if k[0] == "count_below"]
    for (kind, operand, params), (lo, hi) in zip(cases, out):
        rlo, rhi = solver.solve_kind(kind, operand, backend="torch",
                                     rounds=8, spec_k=5, **params)
        if kind.startswith("count"):
            check(torch.equal(lo, rlo) and torch.equal(hi, rhi),
                  f"{kind} bracket differs from the torch backend")
        else:
            check(torch.allclose(lo, rlo, rtol=1e-4, atol=1e-6)
                  and torch.allclose(hi, rhi, rtol=1e-4, atol=1e-6),
                  f"{kind} bracket differs from the torch backend")
    solver_kernels = ("multi_count", "runahead_topk_threshold", "multi_mass",
                      "multi_entropy_moments")
    check(all(launches[name] > 0 for name in solver_kernels),
          f"a solver kernel did not run in the solves: {launches}")
    # count_below counts x < c in place: one K2 a round of the tuner's
    # decision (q > 0 makes the sign at lo0 known) and no negation
    # kernel, of the operand or the candidates
    kernels = kernels_per_call(lambda: solver.solve_kind(
        "count_below", x, backend="hopper", rounds=8, spec_k=5, q=0.3))
    neg = {k: n for k, n in kernels.items() if "neg" in k.lower()}
    k2 = sum(n for k, n in kernels.items() if "multi_count_kernel" in k)
    check(not neg and k2 == below.rounds,
          f"count_below launched {k2} K2 kernels for {below.rounds} rounds "
          f"and negation kernels {neg}")
    say(f"phase 4 solves: {len(cases)} hopper solves with no host sync, "
        f"brackets match the torch backend; count_below: {k2} K2 launches "
        f"for {below.rounds} rounds, no negation kernel "
        f"({sum(kernels.values())} kernels a solve, profiled) | launches "
        f"{launches} | decisions: {decisions_note()}")
    return launches


def phase_serve():
    """serve.main's two steps, kept apart so that phase 7 can run the same
    session again: setup (flags, weights on the card), then run (prompts
    and generate, timed: its first decode step runs eagerly and captures
    the step graph, the rest replay it)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    session = serve.setup(SERVE_ARGV)
    torch.cuda.synchronize()
    ops.reset_launches()
    forget_decisions()
    served = serve.run(session)
    launches = dict(ops.LAUNCHES)
    toks = served.tokens
    check(tuple(toks.shape) == (4, NEW_TOKENS), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < 151936)).all()), "token out of range")
    check_solver_launches(launches, sampler_solves({PATH_B: NEW_TOKENS}),
                          "phase 5 serve")
    graphs = session.decode.graphs
    check(len(graphs.keys) == 1, f"decode graphs {graphs.keys}")
    n_tok = toks.numel()
    say(f"phase 5 serve: qwen3-4b full width, {n_tok} tokens in "
        f"{served.seconds:.3f}s = {n_tok / served.seconds:.1f} tok/s on "
        f"{torch.cuda.get_device_name(0)} (first call: one eager decode "
        f"step and the step graph's capture, {graphs.capture_s:.3f}s"
        f"; then {NEW_TOKENS - 2} replays) | hand-written kernel launches "
        f"per token {sum(launches.values()) / n_tok:.2f} | launches "
        f"{launches} | decisions: {decisions_note()} | row 0: "
        f"{toks[0].tolist()}")
    return launches, session


def phase_reference(gen):
    import dataclasses

    import torch

    from repro_torch.models.testing import reduced_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import generate
    from repro_torch.serving.sampler import SamplerConfig, masked_logits

    dev = torch.device("cuda")
    x = torch.randn((PATH_B, PATH_V), generator=gen, device=dev) * 3.0
    sc = SamplerConfig(top_k=40, top_p=0.9, target_entropy=3.0)
    zh = masked_logits(x, dataclasses.replace(sc, backend="hopper"))
    zt = masked_logits(x, sc)
    check(torch.equal(zh > -1e29, zt > -1e29), "sampler masks differ")
    check(torch.allclose(zh, zt, rtol=1e-4, atol=1e-5),
          "masked logits differ")

    cfg = reduced_config("qwen3-4b")
    g = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, g, torch.float32)
    prompt = torch.randint(0, cfg.vocab, (2, 8), generator=g, device=dev)
    streams = [generate(cfg, params, prompt, 8, None,
                        sampler=SamplerConfig(greedy=True, top_k=8,
                                              backend=be),
                        compute_dtype=torch.float32)
               for be in ("hopper", "torch")]
    check(torch.equal(*streams), "greedy streams differ between backends")
    say(f"phase 6 reference: masked logits (4, {PATH_V}) hopper == torch "
        f"(masks equal, max |diff| "
        f"{(zh - zt).abs().max().item():.3g}); reduced qwen3-4b greedy "
        f"streams equal")


def _profile_records(prof) -> tuple[list, dict]:
    """A finished device-activity profile read from its raw events, not
    from key_averages' per-op tree (a training step's ~10**5 kernels read
    back in seconds): the device's kernels, copies and sets by name as
    records with key_averages' fields (key, count, self_device_time_total
    in us), and the host's kernel and graph launch calls by API."""
    import types

    import torch

    by_name, calls = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            rec = by_name.setdefault(name, [0, 0])
            rec[0] += 1
            rec[1] += e.duration_ns()
        elif name.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch")):
            calls[name] = calls.get(name, 0) + 1
    kernels = [types.SimpleNamespace(key=name, count=n,
                                     self_device_time_total=ns / 1e3)
               for name, (n, ns) in by_name.items()]
    return kernels, calls


def profiled(run):
    """run() under torch.profiler, device activity only: (its result,
    device busy ms, wall ms traced, the device's kernels by name, the
    host's launch calls by API: kernel launches and graph launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, calls = _profile_records(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return out, busy_ms, wall_ms, kernels, calls


def say_profile(phase: str, busy_ms: float, wall_ms: float, kernels,
                calls: dict, n: int, unit: str, note: str = "") -> None:
    """The profile's device busy time and idle share, the kernels the card
    ran and the host's launch calls, each per ``unit`` (``n`` of them),
    and the kernels that took the most device time."""
    if not kernels:
        say(f"{phase} profile: the profiler recorded no device time "
            "(not measured)")
        return
    ran = sum(e.count for e in kernels)
    host = sum(calls.values())
    graphs = calls.get("cudaGraphLaunch", 0)
    say(f"{phase} profile: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"traced wall (idle share {1 - busy_ms / wall_ms:.3f}); {ran} "
        f"kernels ran on the card ({ran / n:.1f} per {unit}); the host made "
        f"{host} launch calls ({host / n:.1f} per {unit}), {graphs} of them "
        f"graph launches{note}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        say(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")


SAMPLER_KERNELS = (("K3", "runahead_topk"), ("K4", "multi_mass_kernel"),
                   ("K5", "multi_entropy_kernel"))


def say_kernel_times(phase: str, kernels, busy_ms: float,
                     which=SAMPLER_KERNELS) -> None:
    """Each sampler kernel's device time under the profiler, its share of
    the device's busy time, and its time a call."""
    for label, key in which:
        sel = [e for e in kernels if key in e.key]
        ms = sum(e.self_device_time_total for e in sel) / 1e3
        n = sum(e.count for e in sel)
        say(f"{phase} profile: {label} {ms:.2f} ms of {busy_ms:.1f} ms device "
            f"busy ({ms / busy_ms:.4f}), {ms / max(1, n):.4f} ms per call "
            f"({n} calls)")


def eager_generate(cfg, params, prompt, n_new, gen, sc, frames=None):
    """The one-shot decode as an eager loop with a host-integer position
    (no graph): the reference the step graph's replays are held to."""
    import torch

    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.serving.sampler import sample

    S = prompt.shape[1]
    logits, cache = prefill(cfg, params, prompt, S + n_new,
                            encoder_frames=frames)
    toks = [sample(logits, gen, sc)]
    for pos in range(S, S + n_new - 1):
        logits, cache = decode_step(cfg, params, toks[-1], pos, cache)
        toks.append(sample(logits, gen, sc))
    return torch.stack(toks, dim=1)


def phase_warm(session):
    """The one-shot serve.run on phase 5's session again, warm (every
    decode step a replay), then against the eager loop on the same
    prompts and generator state, then under torch.profiler: device busy
    time and idle share, launches per token, and the kernels that take
    the most device time."""
    import torch

    from repro_torch.launch import serve

    cfg, params, args, sc, gen, dev = session[:6]
    warm_s = serve.run(session).seconds
    state = gen.get_state()
    served = serve.run(session)
    gen.set_state(state)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    want = eager_generate(cfg, params, prompt, args.new_tokens, gen, sc)
    check(torch.equal(served.tokens, want),
          "the graphed one-shot tokens differ from the eager loop's")
    _, busy_ms, wall_ms, kernels, calls = profiled(
        lambda: serve.run(session))
    n_tok = args.batch * args.new_tokens
    say(f"phase 7 warm serve: {n_tok} tokens in {warm_s:.3f}s = "
        f"{n_tok / warm_s:.1f} tok/s on {torch.cuda.get_device_name(0)}; "
        f"tokens == the eager loop's (host-integer position, no graph) "
        f"bit for bit")
    say_profile("phase 7", busy_ms, wall_ms, kernels, calls, n_tok, "token")
    if kernels:
        say_kernel_times("phase 7", kernels, busy_ms)


def phase_paper():
    """launch.paper's main on the card (both solvers graphed), then each
    solve's eager body with host syncs forbidden, counting K1's launches,
    against its graph replay."""
    import torch

    from repro_torch.core import bisect, runahead
    from repro_torch.kernels import ops
    from repro_torch.launch import paper

    torch.cuda.synchronize()
    ops.reset_launches()
    rows = paper.main([])
    launches = dict(ops.LAUNCHES)
    check(launches["taylor_sincos_eval"] > 0 and sum(launches.values())
          == launches["taylor_sincos_eval"],
          f"the paper path did not run through K1 alone: {launches}")
    for fig in ("fig4", "fig7"):
        say(f"phase 8 paper {fig} (graphed solves): terms, n, k, threads, "
            f"rounds, serial ms host / device, runahead ms host / device, "
            f"speed-up host / device (ideals: round count, evaluation "
            f"count)")
        for r in rows:
            if r.fig == fig:
                say(f"  {r.terms:6d} {r.n:3d} {r.k:2d} {2 ** r.k - 1:3d} "
                    f"{r.rounds:3d} {r.serial_ms:9.4f} {r.serial_dev_ms:9.4f}"
                    f" {r.runahead_ms:9.4f} {r.runahead_dev_ms:9.4f} "
                    f"{r.speedup:6.2f}x {r.dev_speedup:6.2f}x "
                    f"({r.round_ideal:.2f}x, {r.eval_ideal:.2f}x)")
    f = paper.evaluator(K1_TERMS)
    a, b = paper.interval("cuda")
    n = paper.FIG4_N
    counts = []
    for k in (None,) + paper.FIG4_KS:
        if k is None:
            def body():
                return bisect._serial(f, a, b, iterations=n, mode="signbit")

            def solve():
                return bisect.find_root_serial(f, a, b, n, "signbit")
        else:
            def body():
                return runahead._runahead(f, None, a, b, iterations=n,
                                          spec_k=k, select="walk")

            def solve():
                return runahead.find_root_runahead(f, a, b, n, k)
        want = n + 1 if k is None else -(-n // k) + 1
        got = []
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for run in (body, solve):       # eager, then the replay
                ops.reset_launches()
                got.append(run())
                check(ops.LAUNCHES["taylor_sincos_eval"] == want,
                      f"K1 launched {ops.LAUNCHES['taylor_sincos_eval']} "
                      f"times in a solve at k={k}, expected {want}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(torch.equal(got[0], got[1]),
              f"k={k}: the graph replay's root differs from the eager body's")
        check(got[1].item() == rows[0].root, f"root differs at k={k}")
        counts.append(want)
    say(f"phase 8 paper: runahead == serial bit for bit at every (terms, k); "
        f"each graph replay's root == its eager body's; no host sync in the "
        f"bodies or the replays; K1 launches per solve, serial then k=1..5: "
        f"{counts} | {len(bisect.GRAPHS.keys)} solve graphs, captured in "
        f"{bisect.GRAPHS.capture_s:.3f}s | launches {launches}")
    return launches


class EagerGraphs:
    """A stand-in for core/graphs.py's Graphs that runs every body
    eagerly: the reference a path's graph replays are held against."""
    keys: list = []
    capture_s = 0.0

    def run(self, key, body, *args, device=None):
        return body(*args)


def streams(served) -> dict:
    return {c.rid: c.tokens for c in served.completions}


def say_graphs(phase: str, sched) -> None:
    keys = ", ".join(str(k) for k in sched.graphs.keys)
    say(f"{phase} graphs: {len(sched.graphs.keys)} captured in "
        f"{sched.graphs.capture_s:.3f}s (eager first step and capture "
        f"each): {keys}")


def sync_free_steps(phase: str, server, requests, extra=None) -> str:
    """Admit ``requests``, run one step outside the window (its key's
    graph captured if it was not), then three replays and three eager step
    bodies under set_sync_debug_mode("error"), the token reads outside."""
    import torch

    for r in requests:
        server.submit(r)
    server._admit_pending()
    sched = server.scheduler
    sched.step()
    graphs = sched.graphs
    for runner in (graphs, EagerGraphs()):
        sched.graphs = runner
        for _ in range(3):
            sched._ensure_step_args()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                nxt = sched.step_device()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if extra is not None:
                extra(sched)
            sched.commit(nxt)
    sched.graphs = graphs
    return (f"{phase}: 3 step replays and 3 eager step bodies ran under "
            f"set_sync_debug_mode('error'); one token read per step")


def phase_continuous():
    """launch.serve --continuous at full width on a paged cache through
    K6, each decode step a replay of its step graph: counts, timings
    (first run with the captures, then warm on the same server), the
    streams against the eager step body's, a profiled warm run,
    sync-free steps and replays, peak memory."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    session = serve.setup(CONT_ARGV)
    server = serve.server_for(session)
    torch.cuda.synchronize()
    ops.reset_launches()
    forget_decisions()
    served = serve.run_continuous(session, server)
    launches = dict(ops.LAUNCHES)
    s, c = served.scheduler, served.counts
    n_layers = session.cfg.n_layers
    n_steps = c["decode_steps"]
    check(len(served.completions) == 8, "not every request was served")
    check(launches["paged_attend"] == n_layers * n_steps,
          f"K6 launched {launches['paged_attend']} times for "
          f"{n_steps} decode steps of {n_layers} layers")
    # a decode step samples the 4 slots, an admission its one row
    check_solver_launches(
        launches, sampler_solves({PATH_B: n_steps, 1: c["admissions"]}),
        "phase 9 continuous")
    decided = decisions_note()
    check(c["dispatches"] == n_steps + 2 * c["admissions"]
          and c["host_syncs"] == n_steps + c["admissions"],
          f"dispatch counters {c}")
    n_tok = sum(len(x.tokens) for x in served.completions)
    lat = sorted(x.latency_s for x in served.completions)
    say(f"phase 9 continuous: qwen3-4b full width, 8 requests / {n_tok} "
        f"tokens in {served.seconds:.3f}s = {n_tok / served.seconds:.1f} "
        f"tok/s on {torch.cuda.get_device_name(0)} (first run, captures "
        f"included) | {n_steps} decode steps, {c['admissions']} admissions, "
        f"{c['dispatches']} dispatches and {c['host_syncs']} host syncs "
        f"({c['dispatches'] / n_steps:.2f} and "
        f"{c['host_syncs'] / n_steps:.2f} per step) | latency p50 "
        f"{lat[len(lat) // 2] * 1e3:.0f} ms, max {lat[-1] * 1e3:.0f} ms | "
        f"peak {s.peak_pages} pages | launches {launches} | decisions: "
        f"{decided}")
    say_graphs("phase 9", s)

    warm = serve.run_continuous(session, server)
    check(streams(warm) == streams(served), "warm streams differ")
    n_tok = sum(len(x.tokens) for x in warm.completions)
    lat = sorted(x.latency_s for x in warm.completions)
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    steps = warm.counts["decode_steps"]
    say(f"phase 9 continuous warm (the same server: replays only): {n_tok} "
        f"tokens in {warm.seconds:.3f}s = {n_tok / warm.seconds:.1f} tok/s, "
        f"{steps} steps ({warm.seconds / steps * 1e3:.1f} ms per step incl. "
        f"admissions), latency p50 {lat[len(lat) // 2] * 1e3:.0f} ms p99 "
        f"{p99 * 1e3:.0f} ms")
    eager_server = serve.server_for(session)
    eager_server.scheduler.graphs = EagerGraphs()
    eager = serve.run_continuous(session, eager_server)
    check(streams(eager) == streams(served),
          "the graphed streams differ from the eager step body's")
    say(f"phase 9 continuous: streams == the eager step body's bit for bit "
        f"(eager {sum(len(x.tokens) for x in eager.completions)} tokens in "
        f"{eager.seconds:.3f}s)")
    traced, busy_ms, wall_ms, kernels, calls = profiled(
        lambda: serve.run_continuous(session, server))
    n_k6 = n_layers * traced.counts["decode_steps"]
    say_profile("phase 9", busy_ms, wall_ms, kernels, calls,
                traced.counts["decode_steps"], "decode step", "; warm")
    k6 = [e for e in kernels if "paged_" in e.key]
    if kernels:
        k6_ms = sum(e.self_device_time_total for e in k6) / 1e3
        say(f"phase 9 profile: K6 (split and combine kernels) {k6_ms:.1f} ms "
            f"of {busy_ms:.1f} ms device busy ({k6_ms / busy_ms:.3f}), "
            f"{k6_ms / max(1, n_k6):.4f} ms per call ({n_k6} calls)")
        say_kernel_times("phase 9", kernels, busy_ms)
    note = sync_free_steps(
        "phase 9 continuous", serve.server_for(session),
        serve.continuous_requests(session.cfg, session.args,
                                  session.sampler)[:4])
    say(f"{note} | peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB (phase 9 took {time.perf_counter() - t0:.1f}s)")
    return launches, streams(served), n_tok / warm.seconds


def _screened_prompts(cfg, params, n: int, S: int, n_new: int, gen,
                      candidates: int = 4):
    """n prompts of S tokens (from ``candidates`` * n random ones) whose
    greedy one-shot streams keep a top-1 / top-2 logit gap above 1e-2 at
    every step (f32: far above the 1e-5 by which the paged paths may
    differ)."""
    import torch

    from repro_torch.models.decode import decode_step, prefill

    cand = torch.randint(0, cfg.vocab, (candidates * n, S), generator=gen,
                         device="cuda")
    logits, cache = prefill(cfg, params, cand, S + n_new,
                            compute_dtype=torch.float32)
    ok = torch.ones(cand.shape[0], dtype=torch.bool, device="cuda")
    for i in range(n_new):
        top2 = logits.topk(2, dim=-1).values
        ok &= top2[:, 0] - top2[:, 1] > 1e-2
        if i < n_new - 1:
            logits, cache = decode_step(cfg, params, logits.argmax(-1), S + i,
                                        cache, compute_dtype=torch.float32)
    rows = ok.nonzero()[:, 0].tolist()[:n]
    check(len(rows) == n, f"only {len(rows)} screened prompts")
    return cand[rows].tolist()


def phase_continuous_reference(gen):
    """On reduced qwen3-4b (f32, the unembedding sharpened toward a fixed
    successor token to widen greedy margins, prompts screened for ties):
    paged continuous streams through K6 equal those through the gather,
    and each equals its request's one-shot stream."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.testing import reduced_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.server import (
        Request,
        RunaheadServer,
        generate_oneshot_reference,
    )

    cfg = reduced_config("qwen3-4b")
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, g, torch.float32)
    perm = torch.randperm(cfg.vocab_padded, generator=g, device="cuda")
    params["unembed"] = params["unembed"] + 2.0 * params["embed"][perm].T
    context, n_new = 24, [5, 3, 1, 7, 4, 6]
    prompts = _screened_prompts(cfg, params, len(n_new), 6, max(n_new), g)
    reqs = [Request(i, p, n_new[i], seed=i,
                    sampler=SamplerConfig(greedy=True), arrival=i // 2)
            for i, p in enumerate(prompts)]
    streams = {}
    for impl in ("hopper", "gather"):
        ops.reset_launches()
        srv = RunaheadServer(cfg, params, n_slots=2, context=context,
                             page_size=5, page_impl=impl,
                             cache_dtype=torch.float32,
                             compute_dtype=torch.float32)
        streams[impl] = {c.rid: c.tokens for c in srv.run(reqs)}
        check((ops.LAUNCHES["paged_attend"] > 0) == (impl == "hopper"),
              f"K6 launches with impl {impl}: {ops.LAUNCHES}")
    check(streams["hopper"] == streams["gather"],
          "paged K6 streams differ from the gather's")
    for r in reqs:
        one = generate_oneshot_reference(cfg, params, r, context=context,
                                         compute_dtype=torch.float32)
        check(streams["hopper"][r.rid] == one,
              f"request {r.rid}: continuous {streams['hopper'][r.rid]} != "
              f"one-shot {one}")
    say(f"phase 10 continuous reference: reduced qwen3-4b, {len(reqs)} "
        f"screened greedy requests on 2 slots, page 5: K6 streams == gather "
        f"streams == one-shot per request; first tokens "
        f"{[streams['hopper'][r.rid][:3] for r in reqs]}")


def phase_train():
    """launch.train's main in-process at internlm2-1.8b's full width:
    losses, K7 and K2 launches per step, step time, tokens per second,
    peak memory, and the last step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    per_step, prof = [], {}

    def on_step(step, metrics):
        # launches of this step; the profiler brackets TRAIN_PROFILED_STEP
        per_step.append(dict(ops.LAUNCHES))
        if step == TRAIN_PROFILED_STEP - 1:
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif step == TRAIN_PROFILED_STEP:
            torch.cuda.synchronize()
            prof["wall_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].__exit__(None, None, None)

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    forget_decisions()
    out = train.main(TRAIN_ARGV, on_step=on_step)
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    check(len(losses) == 6 and all(map(math.isfinite, losses)),
          f"training losses not all finite: {losses}")
    n_layers = 24
    # the clip's solve, one a step: the (1, leaves) quantile of the
    # per-leaf norms, one K2 a round of the tuner's decision (q > 0 makes
    # the sign at lo0 known)
    want = solver_launches({("count_below", 1, False): 1})
    prev = {name: 0 for name in launches}
    for i, snap in enumerate(per_step):
        moved = {k: snap[k] - prev[k] for k in snap}
        check(moved["flash_fwd"] == 2 * n_layers,
              f"step {i}: K7 launched {moved['flash_fwd']} times, expected "
              f"{2 * n_layers}")
        check({k: moved[k] for k in SOLVER_KERNELS} == want,
              f"step {i}: the quantile clip launched {moved}, where the "
              f"tuner's decision ({decisions_note()}) gives {want}")
        prev = snap
    timed = out["step_seconds"][1:TRAIN_PROFILED_STEP]
    ms = statistics.median(timed) * 1e3
    n_tok = 2 * 4096
    say(f"phase 11 train: internlm2-1.8b full width (24 layers, d_model "
        f"2048, GQA 16/8, vocab 92544), batch 2 x 4096, remat, quantile "
        f"clip | losses {[round(x, 4) for x in losses]} | warm-up step "
        f"{out['step_seconds'][0] * 1e3:.0f} ms, steps 1-4 "
        f"{[round(t * 1e3, 1) for t in timed]} ms, median {ms:.1f} ms = "
        f"{n_tok / ms * 1e3:.0f} tok/s | peak memory {peak_gb:.2f} GB | "
        f"K7 {2 * n_layers} and K2 {per_step[0]['multi_count']} launches per "
        f"step (the clip: {decisions_note()}) | launches {launches}")
    kernels, calls = _profile_records(prof["p"])
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    say_profile("phase 11", busy_ms, prof["wall_ms"], kernels, calls, 1,
                "step", f"; one step (step {TRAIN_PROFILED_STEP})")
    k7_ms = sum(e.self_device_time_total for e in kernels
                if "flash_fwd_" in e.key) / 1e3
    if kernels:
        say(f"phase 11 profile: K7 {k7_ms:.1f} ms of {busy_ms:.1f} ms device "
            f"busy ({k7_ms / busy_ms:.3f}), {k7_ms / (2 * n_layers):.3f} ms "
            f"per call | by group: "
            + ", ".join(f"{g} {ms_:.1f} ms ({n_} launches)" for g, (ms_, n_)
                        in _kernel_groups(kernels).items()))
    return launches


def _kernel_groups(kernels) -> dict:
    """Device time and launches by kind of kernel: the hand-written ones,
    f32 GEMMs (the chunked flash_attend's einsums in the attention
    backward), the other GEMMs (the model's bf16 matmuls), elementwise
    and copy kernels, reductions, the rest."""
    groups = {}
    for e in kernels:
        key = e.key
        if "flash_fwd_" in key:
            g = "K7"
        elif "multi_count" in key:
            g = "K2"
        elif "sgemm" in key:
            g = "f32 GEMM"
        elif any(w in key for w in ("gemm", "nvjet", "cutlass", "cublas")):
            g = "other GEMM"
        elif any(w in key for w in ("elementwise", "copy", "Copy")):
            g = "elementwise"
        elif "reduce" in key.lower():
            g = "reduction"
        else:
            g = "other"
        ms_, n_ = groups.get(g, (0.0, 0))
        groups[g] = (ms_ + e.self_device_time_total / 1e3, n_ + e.count)
    return dict(sorted(groups.items(), key=lambda kv: -kv[1][0]))


def _capture_log(name: str):
    import logging

    lines = []

    class Handler(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Handler()
    logging.getLogger(name).addHandler(handler)
    return lines, handler


def phase_fault(cache: Path):
    """Reduced internlm2-1.8b on the card: killed at step 7 in a
    subprocess (on the tuning cache ``cache``, as this process), resumed
    from step_5 in-process; the resumed losses and final checkpoint equal
    an uninterrupted run's."""
    import json as _json
    import logging
    import os
    import tempfile

    from repro_torch.launch import train

    src = Path(__file__).resolve().parent / "src"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        killed, straight = os.path.join(tmp, "killed"), os.path.join(
            tmp, "straight")
        env = dict(os.environ, PYTHONPATH=str(src),
                   REPRO_TORCH_TUNING_CACHE=str(cache))
        died = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *FAULT_ARGV,
             "--ckpt-dir", killed, "--die-at-step", "7"],
            capture_output=True, text=True, env=env, timeout=600)
        check(died.returncode == 42, f"the killed run exited "
              f"{died.returncode}, not 42: {died.stderr[-2000:]}")
        check("step_5" in os.listdir(killed), f"no step_5 after the kill: "
              f"{os.listdir(killed)}")
        lines, handler = _capture_log("repro_torch.train")
        try:
            resumed = train.main(FAULT_ARGV + ["--ckpt-dir", killed])
        finally:
            logging.getLogger("repro_torch.train").removeHandler(handler)
        check("resumed from checkpoint step 5" in lines,
              f"the rerun did not resume from step 5: {lines[:3]}")
        check("step_10" in os.listdir(killed), "no final step_10")
        whole = train.main(FAULT_ARGV + ["--ckpt-dir", straight])

        def hashes(d):
            with open(os.path.join(d, "step_10", "manifest.json")) as f:
                return {k: v["sha256"] for k, v in
                        _json.load(f)["leaves"].items()}

        same_state = hashes(killed) == hashes(straight)
        check(resumed["losses"] == whole["losses"][5:],
              f"resumed losses {resumed['losses']} != uninterrupted "
              f"{whole['losses'][5:]}")
        check(same_state, "the resumed run's final checkpoint differs from "
                          "the uninterrupted run's")
    say(f"phase 12 fault: reduced internlm2-1.8b killed at step 7 (exit 42, "
        f"step_5 on disk), resumed from step 5; losses 5-9 "
        f"{resumed['losses']} equal the uninterrupted run's bit for bit, and "
        f"so does the final step_10 checkpoint (every leaf's sha256)")


def mixed_k_requests(session):
    """Phase 9's requests, each with its own top_k (MIXED_TOP_K in turn)."""
    import dataclasses

    from repro_torch.launch import serve

    reqs = serve.continuous_requests(session.cfg, session.args,
                                     session.sampler)
    for i, r in enumerate(reqs):
        r.sampler = dataclasses.replace(
            r.sampler, top_k=MIXED_TOP_K[i % len(MIXED_TOP_K)])
    return reqs


def phase_mixed_k(gen):
    """Phase 9's continuous serve, but with a top_k per request: while the
    live slots' k differ, a decode step's top-k is the engine's per-row
    solve through K2 (rounds, plus the probe at lo0 whose sign a per-row k
    leaves unknown); while they agree, K3.  Launch counts against that,
    tok/s, a profiled run (K2 in situ), sync-free decode steps, and the
    masked logits of a mixed-k batch on both backends."""
    import dataclasses

    import torch

    from repro_torch.core import solver
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import sampler as smp
    from repro_torch.serving.scheduler import _enable_bits, _static_top_k

    t0 = time.perf_counter()
    session = serve.setup(CONT_ARGV)
    sc = session.sampler
    # the engine knows the sign at lo0 only for a static k: a per-row-k
    # solve spends one more K2 launch on it (solver_launches counts it)
    probe = solver.problem("count_above", torch.zeros((1, 2)),
                           backend="torch",
                           k=torch.ones(1, dtype=torch.long)).sign_lo is None
    check(probe, "a per-row top-k solve knows its sign at lo0")

    def serve_mixed(server, n_requests=None):
        sched = server.scheduler
        before = (sched.n_decode_steps, sched.n_admissions)
        mixed = []
        inner = sched.step_device

        def step_device():            # is this step's top-k per row?
            enable, k_static, _ = sched._statics
            mixed.append(enable[1] and k_static is None)
            return inner()

        sched.step_device = step_device
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = server.run(mixed_k_requests(session)[:n_requests])
        torch.cuda.synchronize()
        del sched.step_device
        return (done, time.perf_counter() - t0,
                sched.n_decode_steps - before[0],
                sched.n_admissions - before[1], sum(mixed))

    server = serve.server_for(session)
    ops.reset_launches()
    forget_decisions()
    done, secs, n_steps, n_adm, n_mixed = serve_mixed(server)
    launches = dict(ops.LAUNCHES)
    n_tok = sum(len(c.tokens) for c in done)
    check(len(done) == 8, f"served {len(done)} of 8 requests")
    check(n_mixed > 0, "no decode step had mixed top_k")
    check_solver_launches(
        launches, sampler_solves({PATH_B: n_steps, 1: n_adm}, n_mixed),
        f"phase 13 ({n_mixed} mixed-k steps of {n_steps}, {n_adm} "
        f"admissions)")
    # K2 launches a mixed-k step's solve makes
    per_solve = solver_launches(
        {("count_above", PATH_B, False): 1})["multi_count"]
    (mixed_d, _) = decisions()[("count_above", PATH_B, False)]
    say(f"phase 13 mixed top-k: qwen3-4b full width, 8 requests with top_k "
        f"{MIXED_TOP_K} in turn / {n_tok} tokens in {secs:.3f}s = "
        f"{n_tok / secs:.1f} tok/s on {torch.cuda.get_device_name(0)} "
        f"(first run, captures included) | {n_steps} decode steps "
        f"({n_mixed} with mixed top_k), {n_adm} admissions | "
        f"K2 {per_solve} launches per mixed-k sample ({mixed_d.rounds} "
        f"rounds + 1 probe at lo0), {launches['multi_count']} in all | "
        f"launches {launches} | decisions: {decisions_note()}")
    say_graphs("phase 13", server.scheduler)
    first = {c.rid: c.tokens for c in done}
    eager_server = serve.server_for(session)
    eager_server.scheduler.graphs = EagerGraphs()
    eager = {c.rid: c.tokens for c in serve_mixed(eager_server)[0]}
    check(eager == first,
          "the graphed mixed-k streams differ from the eager step body's")

    done, secs, n_steps, _, n_mixed = serve_mixed(server)
    n_tok = sum(len(c.tokens) for c in done)
    check({c.rid: c.tokens for c in done} == first, "warm streams differ")
    say(f"phase 13 mixed top-k warm (the same server: replays only): "
        f"{n_tok} tokens in {secs:.3f}s = {n_tok / secs:.1f} tok/s, "
        f"{n_steps} steps ({secs / n_steps * 1e3:.1f} ms per step incl. "
        f"admissions); streams == the eager step body's bit for bit")
    # the profiled run serves the first 4 requests only, on a server that
    # served them once (its graphs captured outside the profiler)
    small = serve.server_for(session)
    serve_mixed(small, 4)
    (done, secs, n_steps, _, n_mixed), busy_ms, wall_ms, kernels, calls = (
        profiled(lambda: serve_mixed(small, 4)))
    say_profile("phase 13", busy_ms, wall_ms, kernels, calls, n_steps,
                "decode step", f"; the first {len(done)} requests, "
                f"{n_mixed} mixed-k steps, warm")
    if kernels:
        say_kernel_times("phase 13", kernels, busy_ms,
                         (("K2", "multi_count_kernel"),) + SAMPLER_KERNELS)

    # the device part of a mixed-k step never syncs, replayed or eager
    def k2_per_step(sched):
        check(sched._statics[1] is None, "the four slots share a top_k")

    ops.reset_launches()
    note = sync_free_steps("phase 13 mixed top-k", serve.server_for(session),
                           mixed_k_requests(session)[:4], k2_per_step)
    check(ops.LAUNCHES["multi_count"] == 7 * per_solve,
          f"7 mixed-k steps launched K2 {ops.LAUNCHES['multi_count']} "
          f"times, not {7 * per_solve}")

    # masked logits of one mixed-k batch, "hopper" against "torch": the
    # top-k masks bit for bit; with top-p and the entropy temperature (K4,
    # K5: float sums) the masks equal and the values within 1e-4
    x = torch.randn((len(MIXED_TOP_K), PATH_V), generator=gen,
                    device=session.device) * 3.0
    diffs = []
    for base in (smp.SamplerConfig(), sc):
        scs = [dataclasses.replace(base, top_k=k, backend="torch")
               for k in MIXED_TOP_K]
        kw = dict(spec_k=sc.spec_k, rounds=sc.rounds,
                  enable=_enable_bits(scs), top_k_static=_static_top_k(scs))
        slots = smp.SlotSamplers.stack(scs, x.device)
        zh, zt = (smp._masked_slot_logits(x, slots, backend=be, **kw)
                  for be in ("hopper", "torch"))
        check(torch.equal(zh > -1e29, zt > -1e29),
              f"mixed-k masks differ between backends ({base})")
        if base.top_p == 0.0 and base.target_entropy is None:
            check(torch.equal(zh, zt), "mixed top-k masked logits differ")
        check(torch.allclose(zh, zt, rtol=1e-4, atol=1e-5),
              "mixed-k masked logits differ")
        diffs.append((zh - zt).abs().max().item())
    say(f"{note}; K2 {per_solve} times a step; "
        f"masked logits ({len(MIXED_TOP_K)}, {PATH_V}) hopper == torch: "
        f"top-k alone bit for bit, with top-p and entropy masks equal (max "
        f"|diff| {diffs[1]:.3g}) (phase 13 took "
        f"{time.perf_counter() - t0:.1f}s)")
    return launches


def phase_horizon(per_step_streams: dict):
    """Phase 9's serve at step_horizon 4: streams against phase 9's
    per-step streams, the counters, tok/s first and warm, a profiled warm
    run, peak memory; then the card's dispatch overhead, measured on a
    per-step server of the same session."""
    import argparse

    import torch

    from repro_torch.core import tuning
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    session = serve.setup(CONT_ARGV + ["--step-horizon", str(HORIZON)])
    server = serve.server_for(session)
    torch.cuda.synchronize()
    ops.reset_launches()
    first = serve.run_continuous(session, server)
    launches = dict(ops.LAUNCHES)
    s, c = first.scheduler, first.counts
    n_steps = c["decode_steps"]
    check(s.step_horizon == HORIZON, f"step_horizon {s.step_horizon}")
    check(streams(first) == per_step_streams,
          "the fused streams differ from phase 9's per-step streams")
    check(c["decode_steps"] == HORIZON * c["horizons"]
          and c["dispatches"] == c["horizons"] + 2 * c["admissions"]
          and c["host_syncs"] == c["horizons"] + c["admissions"],
          f"horizon counters {c}")
    check(launches["paged_attend"] == session.cfg.n_layers * n_steps,
          f"K6 launched {launches['paged_attend']} times for {n_steps} "
          f"fused iterations")
    n_tok = sum(len(x.tokens) for x in first.completions)
    say(f"phase 14 horizons: step_horizon {HORIZON}, qwen3-4b full width, "
        f"8 requests / {n_tok} tokens in {first.seconds:.3f}s = "
        f"{n_tok / first.seconds:.1f} tok/s on "
        f"{torch.cuda.get_device_name(0)} (first run, captures included); "
        f"streams == phase 9's per-step streams bit for bit | "
        f"{c['horizons']} horizons, {n_steps} decode iterations "
        f"({c['wasted_steps']} all-idle), {c['admissions']} admissions, "
        f"{c['dispatches']} dispatches, {c['host_syncs']} host syncs "
        f"({c['host_syncs'] / n_steps:.3f} per decode iteration) | "
        f"launches {launches}")
    say_graphs("phase 14", s)
    warm = serve.run_continuous(session, server)
    check(streams(warm) == per_step_streams, "warm fused streams differ")
    say(f"phase 14 horizons warm (the same server: replays only): "
        f"{n_tok / warm.seconds:.1f} tok/s ({warm.seconds:.3f}s, "
        f"{warm.seconds / c['horizons'] * 1e3:.1f} ms per horizon incl. "
        f"admissions)")
    traced, busy_ms, wall_ms, kernels, calls = profiled(
        lambda: serve.run_continuous(session, server))
    say_profile("phase 14", busy_ms, wall_ms, kernels, calls,
                traced.counts["decode_steps"], "decode iteration",
                f"; {traced.counts['horizons']} horizons, warm")
    peak = torch.cuda.max_memory_allocated() / 1e9

    per_step = session._replace(args=argparse.Namespace(
        **dict(vars(session.args), step_horizon="1")))
    server = serve.server_for(per_step)
    for r in serve.continuous_requests(session.cfg, session.args,
                                       session.sampler)[:4]:
        server.submit(r)
    server._admit_pending()
    sched = server.scheduler
    sched.step()                         # its key's graph captured
    host, dev = [], []
    for _ in range(8):
        sched._ensure_step_args()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        a.record()
        nxt = sched.step_device()
        b.record()
        sched.commit(nxt)
        host.append((time.perf_counter() - t1) * 1e3)
        dev.append(a.elapsed_time(b))
    check(sched.n_active == 4, "a slot finished inside the measurement")
    h, d = statistics.median(host), statistics.median(dev)
    say(f"phase 14 dispatch overhead: {(h - d) / d:.4f} (a graphed per-step "
        f"decode step of 4 live slots: host {h:.3f} ms, device {d:.3f} ms, "
        f"median of 8) against core/tuning.py DISPATCH_OVERHEAD "
        f"{tuning.DISPATCH_OVERHEAD} | peak memory {peak:.2f} GB (phase 14 "
        f"took {time.perf_counter() - t0:.1f}s)")


class Oracle:
    """A draft source that proposes the recorded continuation of the
    request whose prompt opens the history, every token shifted by
    ``shift`` (0: always right; 1: never right)."""

    device_capable = False

    def __init__(self, book: dict, prompt_len: int, vocab: int,
                 shift: int = 0):
        self.book, self.S, self.V, self.shift = book, prompt_len, vocab, shift

    def __call__(self, history, n: int) -> list[int]:
        stream = self.book[tuple(history[:self.S])]
        done = len(history) - self.S
        out = stream[done:done + n]
        out = out + [out[-1] if out else history[-1]] * (n - len(out))
        return [(t + self.shift) % self.V for t in out]


def timed_run(server, requests, on_step=None):
    """server.run(requests) between device syncs: (streams, seconds, the
    scheduler's counters this run moved)."""
    import torch

    from repro_torch.launch import serve

    sched = server.scheduler
    before = serve.counters(sched)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.run(requests)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    moved = {k: v - before[k] for k, v in serve.counters(sched).items()}
    return {c.rid: c.tokens for c in done}, secs, moved


def _spec_verify_grid(session) -> None:
    """One decode_verify_paged over L = DRAFT_LEN on a live pool (phase 9's
    first 4 requests admitted and one step served) against L serial
    decode_step_paged steps on a copy of it; then the all-rejected
    rollback."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import decode

    cfg, params = session.cfg, session.params
    server = serve.server_for(session)
    for r in serve.continuous_requests(cfg, session.args,
                                       session.sampler)[:4]:
        server.submit(r)
    server.step()
    sched = server.scheduler
    check(sched.n_active == 4, "a slot finished in the first step")
    B, L, C = 4, DRAFT_LEN, sched.context
    g = torch.Generator(device="cuda").manual_seed(15)
    feed = torch.cat([sched.token[:, None], torch.randint(
        0, cfg.vocab, (B, L - 1), generator=g, device="cuda")], dim=1)
    pos, table = sched.pos.clone(), sched.table
    before = [(e["kv"].k.clone(), e["kv"].v.clone()) for e in sched.pool]
    copy = [{"kv": decode.KVCache(k=k.clone(), v=v.clone())}
            for k, v in before]
    grid, _, stash = decode.decode_verify_paged(
        cfg, params, feed, pos, sched.pool, table, context=C, impl="hopper")
    serial = torch.stack([decode.decode_step_paged(
        cfg, params, feed[:, l], pos + l, copy, table, context=C,
        impl="hopper")[0] for l in range(L)], dim=1)
    scale = serial.abs().amax(dim=-1)
    rel = (grid - serial).abs().amax(dim=-1) / scale          # (B, L)
    top2 = serial.topk(2, dim=-1).values
    clear = top2[..., 0] - top2[..., 1] > 2 * VERIFY_REL_TOL * scale
    same = grid.argmax(dim=-1) == serial.argmax(dim=-1)
    check(bool((rel <= VERIFY_REL_TOL).all()),
          f"verify rows differ from serial steps by {rel.tolist()} of the "
          f"row's largest |logit| (tolerance {VERIFY_REL_TOL})")
    check(bool(same[clear].all()), "a verify row's argmax differs from the "
          "serial step's where the serial top-2 gap is clear")
    decode.rollback_paged_runs(sched.pool, stash, table, pos,
                               torch.zeros_like(pos), context=C)
    for e, (k, v) in zip(sched.pool, before):
        check(torch.equal(e["kv"].k[:, 1:], k[:, 1:])
              and torch.equal(e["kv"].v[:, 1:], v[:, 1:]),
              "the all-rejected rollback did not restore the pool")
    say(f"phase 15 verify grid: qwen3-4b bf16, 4 live slots, one "
        f"decode_verify_paged over L={L} (K6) against {L} serial "
        f"decode_step_paged steps: max |dlogit| per row / the row's largest "
        f"|logit| = {[[round(x, 5) for x in row] for row in rel.tolist()]} "
        f"(tolerance {VERIFY_REL_TOL}: a B*L-row forward may take other "
        f"cuBLAS kernels than a B-row one); argmax equal on "
        f"{int(clear.sum())} of {B * L} rows whose serial top-2 gap exceeds "
        f"{2 * VERIFY_REL_TOL} of the row's largest |logit| "
        f"({int(same.sum())} of {B * L} equal in all); the all-rejected "
        f"rollback (n_keep 0) restores every page but the null page bit for "
        f"bit")


def _spec_forced_arms(session) -> None:
    """Both acceptance arms forced, in f32 on prompts screened for greedy
    ties, the unembedding sharpened toward a fixed successor token (phase
    10's move, at full width): an oracle drafter of the recorded per-step
    greedy streams and a drafter that is never right."""
    import torch

    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.server import Request, RunaheadServer

    cfg, params = session.cfg, session.params
    g = torch.Generator(device="cuda").manual_seed(16)
    perm = torch.randperm(cfg.vocab_padded, generator=g, device="cuda")
    sharp = dict(params, unembed=params["unembed"]
                 + 2.0 * params["embed"][perm].T)
    S, L = session.args.prompt_len, DRAFT_LEN
    n_new = [16, 20, 24, 18]
    prompts = _screened_prompts(cfg, sharp, len(n_new), S,
                                max(n_new) + L - 1, g, candidates=12)
    f32 = torch.float32
    sc = SamplerConfig(greedy=True, backend="hopper")

    def serve_greedy(budgets, **kw):
        srv = RunaheadServer(
            cfg, sharp, n_slots=4, context=S + max(n_new) + 2 * L,
            backend="hopper", page_size=16, page_impl="hopper",
            cache_dtype=f32, compute_dtype=f32, **kw)
        got, secs, c = timed_run(srv, [
            Request(i, p, b, seed=i, sampler=sc)
            for i, (p, b) in enumerate(zip(prompts, budgets))])
        return got, srv.scheduler, c

    # the per-step streams, recorded L - 1 tokens past each budget
    longer, _, _ = serve_greedy([b + L - 1 for b in n_new])
    want = {i: longer[i][:b] for i, b in enumerate(n_new)}
    ref, _, c_ref = serve_greedy(n_new)
    check(ref == want, "per-step greedy streams depend on their budgets")
    book = {tuple(p): longer[i] for i, p in enumerate(prompts)}
    notes = []
    for name, shift in (("oracle", 0), ("wrong", 1)):
        got, sched, c = serve_greedy(n_new, draft_len=L,
                                     drafter=Oracle(book, S, cfg.vocab,
                                                    shift))
        check(got == want, f"the {name} drafter's streams differ from the "
                           "per-step streams")
        rate = sched.acceptance_rate
        check(rate >= 0.9 if shift == 0 else sched.n_accepted == 0,
              f"the {name} drafter's acceptance {rate}")
        notes.append(f"{name}: acceptance {rate:.3f} ({c['accepted']} of "
                     f"{c['drafted']} drafts), {c['decode_steps']} verify "
                     f"steps")
    say(f"phase 15 forced arms: qwen3-4b f32, 4 screened greedy requests "
        f"(prompt {S}, n_new {n_new}), draft_len {L}: streams == the "
        f"per-step streams ({c_ref['decode_steps']} steps) for both | "
        + " | ".join(notes))


def spec_requests(session, seed: int = 15):
    """Phase 9's 8 requests (budgets, seeds, arrivals) on repetitive
    prompts (a random REPEAT_PERIOD-token pattern each, repeated to the
    prompt length); even requests take phase 9's sampler, odd ones are
    greedy."""
    import dataclasses

    import numpy as np

    from repro_torch.launch import serve

    cfg, args = session.cfg, session.args
    rng = np.random.default_rng(seed)
    reqs = serve.continuous_requests(cfg, args, session.sampler)
    for i, r in enumerate(reqs):
        pat = rng.integers(0, cfg.vocab, size=REPEAT_PERIOD).tolist()
        r.prompt = (pat * (args.prompt_len // REPEAT_PERIOD + 1))[
            :args.prompt_len]
        if i % 2:
            r.sampler = dataclasses.replace(r.sampler, greedy=True)
    return reqs


def _spec_ngram(session) -> dict:
    """The n-gram drafter on spec_requests: acceptance, tokens per verify
    step, tok/s first and warm, a profiled warm run, dispatches and host
    syncs per verify step, host drafting time, launch checks, peak
    memory.  Returns the first run's streams."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    n_layers = session.cfg.n_layers
    server = serve.server_for(session)
    sched = server.scheduler
    check(type(sched.drafter).__name__ == "NGramDrafter",
          f"drafter {sched.drafter}")
    reqs = spec_requests(session)
    n_sampled_adm = sum(not r.sampler.greedy for r in reqs)
    sampled_steps = []
    inner = sched.step_device

    def step_device():                  # did this step run the solves?
        sampled_steps.append(not sched._statics[2])
        return inner()

    sched.step_device = step_device
    ops.reset_launches()
    forget_decisions()
    first, secs, c = timed_run(server, reqs)
    launches = dict(ops.LAUNCHES)
    del sched.step_device
    n_steps, n_solve = c["decode_steps"], sum(sampled_steps)
    check(len(first) == len(reqs) and all(
        len(first[r.rid]) == r.n_new for r in reqs),
          "not every request served in full")
    check(launches["paged_attend"] == n_layers * n_steps,
          f"K6 launched {launches['paged_attend']} times for {n_steps} "
          f"verify steps of {n_layers} layers")
    # a verify step with a sampled slot solves over its 4 x L grid rows
    # at once, a sampled admission over its one row
    rows = PATH_B * sched.draft_len
    per_grid = solver_launches(sampler_solves({rows: 1}))
    check_solver_launches(
        launches, sampler_solves({rows: n_solve, 1: n_sampled_adm}),
        f"phase 15 n-gram ({n_solve} verify steps with a sampled slot, "
        f"{n_sampled_adm} sampled admissions)")
    decided = decisions_note()
    check(c["dispatches"] == n_steps + 2 * c["admissions"]
          and c["host_syncs"] == n_steps + c["admissions"],
          f"dispatch counters {c}")
    n_tok = sum(len(t) for t in first.values())
    per_step = (n_tok - c["admissions"]) / n_steps
    per_slot = 1 + c["accepted"] * (sched.draft_len - 1) / c["drafted"]
    say(f"phase 15 n-gram: qwen3-4b bf16 full width, 8 requests on "
        f"repetitive prompts (period {REPEAT_PERIOD}; 4 with phase 9's "
        f"sampler, 4 greedy), NGramDrafter, draft_len {sched.draft_len}: "
        f"acceptance {sched.acceptance_rate:.4f} ({c['accepted']} of "
        f"{c['drafted']} drafts), {per_step:.3f} tokens per verify step "
        f"over {n_steps} steps (4 slots; {per_slot:.3f} per live slot "
        f"before budget cuts) | {n_tok} tokens in {secs:.3f}s = "
        f"{n_tok / secs:.1f} tok/s (first run, captures included) | "
        f"{c['dispatches'] / n_steps:.3f} dispatches and "
        f"{c['host_syncs'] / n_steps:.3f} host syncs per verify step "
        f"(admissions included) | K6 {launches['paged_attend']} = "
        f"{n_layers} x {n_steps} steps; K3 {launches['runahead_topk_threshold']}"
        f", K4 {launches['multi_mass']}, K5 "
        f"{launches['multi_entropy_moments']} for {n_solve} steps with a "
        f"sampled slot ({per_grid['runahead_topk_threshold']}, "
        f"{per_grid['multi_mass']}, {per_grid['multi_entropy_moments']} "
        f"per step, over the 4x{sched.draft_len} grid rows) and "
        f"{n_sampled_adm} sampled admissions | decisions: {decided}")
    say_graphs("phase 15", sched)
    draft_s = sched.draft_s
    warm, secs, cw = timed_run(server, reqs)
    check(warm == first, "warm speculative streams differ")
    say(f"phase 15 n-gram warm (the same server: replays only): "
        f"{n_tok / secs:.1f} tok/s ({secs:.3f}s, {cw['decode_steps']} verify "
        f"steps, {secs / cw['decode_steps'] * 1e3:.2f} ms per step incl. "
        f"admissions) | host drafting {(sched.draft_s - draft_s) * 1e3:.2f} "
        f"ms in all, {(sched.draft_s - draft_s) / cw['decode_steps'] * 1e3:.3f}"
        f" ms per step")
    (_, secs_p, cp), busy_ms, wall_ms, kernels, calls = profiled(
        lambda: timed_run(server, reqs))
    say_profile("phase 15", busy_ms, wall_ms, kernels, calls,
                cp["decode_steps"], "verify step", "; n-gram, warm")
    if kernels:
        k6 = [e for e in kernels if "paged_" in e.key]
        k6_ms = sum(e.self_device_time_total for e in k6) / 1e3
        n_k6 = n_layers * cp["decode_steps"]
        say(f"phase 15 profile: K6 at L={DRAFT_LEN} (split and combine "
            f"kernels) {k6_ms:.1f} ms of {busy_ms:.1f} ms device busy "
            f"({k6_ms / busy_ms:.3f}), {k6_ms / n_k6:.4f} ms per call "
            f"({n_k6} calls)")
        say_kernel_times("phase 15", kernels, busy_ms)
    say(f"phase 15 n-gram: peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return first


def _spec_graphs(session, graphed: dict) -> None:
    """The verify steps' graph replays against their eager bodies: the
    n-gram serve (paged, sampled and greedy slots) and its first 4
    requests on the dense ring."""
    from repro_torch.launch import serve
    from repro_torch.serving.server import RunaheadServer

    reqs = spec_requests(session)
    eager = serve.server_for(session)
    eager.scheduler.graphs = EagerGraphs()
    got, secs, _ = timed_run(eager, reqs)
    check(got == graphed, "paged verify replays differ from the eager body")
    sc, args = session.sampler, session.args
    dense = {}
    for name, runner in (("graphs", None), ("eager", EagerGraphs())):
        srv = RunaheadServer(
            session.cfg, session.params, n_slots=args.slots,
            context=args.prompt_len + args.new_tokens + DRAFT_LEN - 1,
            spec_k=sc.spec_k, rounds=sc.rounds, backend=sc.backend,
            draft_len=DRAFT_LEN)
        if runner is not None:
            srv.scheduler.graphs = runner
        dense[name], _, c = timed_run(srv, reqs[:4])
    check(dense["graphs"] == dense["eager"],
          "dense verify replays differ from the eager body")
    say(f"phase 15 graphs: verify-step replays == eager bodies bit for bit, "
        f"paged ({len(reqs)} requests, sampled and greedy; eager "
        f"{secs:.3f}s) and dense (4 requests, {c['decode_steps']} steps)")


def _spec_fused(session) -> None:
    """step_horizon HORIZON with repeat-last drafts against per-step
    serving with the same drafter, on phase 9's workload."""
    import argparse

    from repro_torch.launch import serve
    from repro_torch.serving.draft import RepeatLastDrafter

    reqs = serve.continuous_requests(session.cfg, session.args,
                                     session.sampler)
    per_step = serve.server_for(session)
    per_step.scheduler.drafter = RepeatLastDrafter()
    want, secs1, c1 = timed_run(per_step, reqs)
    fused_session = session._replace(args=argparse.Namespace(
        **dict(vars(session.args), step_horizon=str(HORIZON))))
    fused = serve.server_for(fused_session)
    s = fused.scheduler
    check(s.step_horizon == HORIZON and isinstance(s.drafter,
                                                   RepeatLastDrafter),
          "the fused server does not draft on the card")
    got, secs, c = timed_run(fused, reqs)
    check(got == want, "fused speculative streams differ from per-step ones")
    check(c["decode_steps"] == HORIZON * c["horizons"]
          and c["dispatches"] == c["horizons"] + 2 * c["admissions"]
          and c["host_syncs"] == c["horizons"] + c["admissions"]
          and (c["drafted"], c["accepted"]) == (c1["drafted"],
                                                c1["accepted"]),
          f"fused counters {c} against per-step {c1}")
    say(f"phase 15 fused: step_horizon {HORIZON}, draft_len {DRAFT_LEN}, "
        f"RepeatLastDrafter on the card, phase 9's 8 requests: streams == "
        f"per-step speculative streams with the same drafter bit for bit "
        f"(the freeze mask agreed with the host slot table at every "
        f"iteration) | {c['horizons']} horizons, {c['decode_steps']} "
        f"iterations ({c['wasted_steps']} all-idle), acceptance "
        f"{c['accepted']} of {c['drafted']} | per-step {secs1:.3f}s, fused "
        f"{secs:.3f}s (first runs, captures included)")


def _spec_verify_ms(session) -> dict:
    """Device ms of one graphed verify step (4 live sampled slots, phase
    9's sampler) at each L of VERIFY_LENS: CUDA events around the step
    graph's replay alone, median of 9 replays, beside the least-squares
    line overhead + L rows through them (``tuning.verify_step_cost``)
    that ``--draft-len auto`` prices a verify step by."""
    import dataclasses

    import torch

    from repro_torch.core import tuning
    from repro_torch.launch import serve
    from repro_torch.serving.server import RunaheadServer

    sc, args = session.sampler, session.args
    n_new = 200
    reqs = serve.continuous_requests(session.cfg, args, sc)[:4]
    ms = {}
    for L in VERIFY_LENS:
        srv = RunaheadServer(
            session.cfg, session.params, n_slots=4,
            context=args.prompt_len + n_new + L, spec_k=sc.spec_k,
            rounds=sc.rounds, backend=sc.backend, page_size=16,
            page_impl="hopper", draft_len=L)
        for r in reqs:
            srv.submit(dataclasses.replace(r, n_new=n_new))
        srv.step()                       # admissions; the graph captured
        sched = srv.scheduler
        times, out = [], {}

        def replay():
            out["packed"] = sched.replay_step(L)

        for _ in range(9):
            sched._ensure_step_args()
            if L > 1:
                sched._write_drafts(L)
            sched._draw_noise(1, L)
            torch.cuda.synchronize()
            times.append(_event_ms(replay))
            sched.commit(out["packed"])
        check(sched.n_active == 4, "a slot finished inside the measurement")
        ms[L] = statistics.median(times)
        del srv, sched
    one = ms[1]
    row, overhead = tuning.verify_step_cost(ms)
    pick = tuning.decide_draft_len(acceptance=0.6, token_cost=row,
                                   overhead=overhead)
    rows = ", ".join(
        f"L={L}: {ms[L]:.3f} ms ({ms[L] / one:.3f}x the L=1 step; the line "
        f"overhead + L rows prices {(overhead + L * row) / one:.3f}x)"
        for L in VERIFY_LENS)
    say(f"phase 15 verify-step device ms (one graph replay, 4 live slots, "
        f"median of 9, CUDA events): {rows} | the line: overhead "
        f"{overhead:.4f} ms + {row:.4f} ms a row, decide_draft_len at "
        f"acceptance 0.6 picks L = {pick}")
    return ms


def phase_speculative() -> dict:
    """Speculative serving (draft_len DRAFT_LEN) at qwen3-4b's full width
    on phase 9's layout: the verify grid against serial steps, both
    acceptance arms forced, the n-gram drafter's readings, graph replays
    against eager bodies, fused speculative horizons, and the graphed
    verify step's device ms at each L of VERIFY_LENS."""
    import torch

    from repro_torch.launch import serve

    t0 = time.perf_counter()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    session = serve.setup(CONT_ARGV + ["--draft-len", str(DRAFT_LEN)])
    _spec_verify_grid(session)
    _spec_forced_arms(session)
    graphed = _spec_ngram(session)
    _spec_graphs(session, graphed)
    _spec_fused(session)
    verify_ms = _spec_verify_ms(session)
    say(f"phase 15 took {time.perf_counter() - t0:.1f}s")
    return verify_ms


# ---------------------------------------------------------------------------
# phases 16 and 17: the MoE family
# ---------------------------------------------------------------------------

class MoERecorder:
    """Wraps models/moe.py's ``moe_apply`` (each call's dropped fraction,
    kept on the card), ``_dispatch`` (each call's slots an expert in its
    buffer, ``slots``) and ``_bisect_keep`` (the last call's (scores,
    experts, e_pad, cap) in ``last``; with ``check_keep``, every "hopper"
    keep mask (K3) against the "torch" backend's on the same scores, and
    every call's operands)."""

    def __init__(self, check_keep: bool = False):
        self.check_keep = check_keep
        self.dropped, self.equal, self.operands = [], [], []
        self.slots = []

    def __enter__(self):
        from repro_torch.models import moe

        self._orig = apply, keep, dispatch = (moe.moe_apply, moe._bisect_keep,
                                              moe._dispatch)

        def recorded_apply(*a, **kw):
            out, stats = apply(*a, **kw)
            self.dropped.append(stats.dropped_frac.detach())
            return out, stats

        def recorded_dispatch(*a, **kw):
            d = dispatch(*a, **kw)
            self.slots.append(d.expert_in.shape[2])
            return d

        def checked_keep(scores, expert_id, e_pad, cap, backend="hopper"):
            got = keep(scores, expert_id, e_pad, cap, backend)
            self.last = (scores, expert_id, e_pad, cap)
            if self.check_keep:
                want = keep(scores, expert_id, e_pad, cap, "torch")
                self.equal.append(bool((got == want).all()))
                self.operands.append((scores, expert_id, e_pad, cap))
            return got

        moe.moe_apply, moe._bisect_keep, moe._dispatch = (
            recorded_apply, checked_keep, recorded_dispatch)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.moe_apply, moe._bisect_keep, moe._dispatch = self._orig

    def dropped_frac(self) -> float:
        import torch

        return float(torch.stack(self.dropped).mean())


def _capacity_row(operands, decision, note: str) -> dict:
    """K3 on the capacity cut's (e_pad, A) masked scores (k = cap, the
    path's decision's rounds and spec_k): bit for bit against its plain
    version on every recorded call's operand; timed (device, eager,
    plain, torch.topk) on the first."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import runahead_threshold as rt

    kw = dict(rounds=decision.rounds, spec_k=decision.spec_k)
    masks = []
    for scores, expert, e_pad, cap in operands:
        rows = torch.arange(e_pad, device=scores.device)[:, None]
        masks.append((torch.where(rows == expert[None, :], scores[None, :],
                                  -1.0), cap))
    err = 0.0
    for x, cap in masks:
        got = rt.runahead_topk_threshold_cuda(x, k_target=cap, **kw)
        want = rt.runahead_topk_threshold_plain(x, k_target=cap, **kw)
        for g, w in zip(got, want):
            check(torch.equal(g.view(torch.int32), w.view(torch.int32)),
                  f"K3 differs from plain at the capacity shape "
                  f"{tuple(x.shape)}, cap {cap}")
            err = max(err, (g - w).abs().max().item())
    x, cap = masks[0]
    E, A = x.shape
    clusters, size = rt.cluster_geometry(E, A)
    n_cmp = 2 + 1 + kw["rounds"] * kw["spec_k"]
    run = lambda: ops.runahead_topk_threshold(x, k_target=cap, **kw)
    return dict(
        source="src/repro_torch/kernels/csrc/runahead_threshold.cu",
        replaces="src/repro/kernels/runahead_threshold.py:123",
        max_abs_err=err, ms=device_ms(run), call_ms=call_ms(run),
        plain_ms=device_ms(lambda: rt.runahead_topk_threshold_plain(
            x, k_target=cap, **kw), calls=2),
        bound=bound_ms(4 * (x.numel() + 2 * E), 2 * x.numel() * n_cmp),
        library_ms=device_ms(lambda: torch.topk(x, cap, dim=-1)),
        library="torch.topk",
        note=f"({E}, {A}) masked scores, k = cap {cap}, spec_k "
             f"{kw['spec_k']} x {kw['rounds']} rounds, {len(masks)} calls "
             f"held bit for bit; {clusters} CTAs a row of {size} elements, "
             f"{E * clusters} CTAs on the card's 132 SMs; {note}")


def say_row(label: str, r: dict) -> None:
    say(f"{label}: parity ok (max_abs_err {r['max_abs_err']:.3g}) | device "
        f"{r['ms']:.4f} ms per call ({r['call_ms']:.4f} ms with the host's "
        f"launch), plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms "
        f"({r['bound'][1]})"
        + (f", {r['library']} {r['library_ms']:.4f} ms"
           if r["library_ms"] is not None else "") + f" | {r['note']}")


def _decode_bytes(cfg, params, cache_rows: int) -> int:
    """Bytes a batched decode step must read: every weight once (every
    padded expert's too: the einsums run over all of them) except the
    embedding table, whose B rows are gathered, and the KV cache rows."""
    from repro_torch.tree import leaves

    weights = sum(t.numel() * t.element_size() for t in leaves(params))
    embed = params["embed"]
    kv = (2 * cfg.n_layers * cache_rows * cfg.n_kv_heads * cfg.head_dim
          * 2)
    return weights - embed.numel() * embed.element_size() + kv


def phase_moe_serve(gen):
    """qwen2-moe-a2.7b at its published width and depth, random bf16
    weights from seed 0: one-shot serving (phase 5's traffic) and
    continuous serving on the dense ring (phase 9's requests, no pages),
    each decode step a graph replay held against its eager body; the
    bisect prefill's keep masks (K3) against the "torch" backend's, layer
    by layer; dropped fractions, tok/s, device busy and idle share, the
    graphed decode step's device ms against its byte bound, peak
    memory.  Returns (serve launches, bisect-prefill launches, K3's
    capacity row)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.decode import prefill
    from repro_torch.serving.engine import DecodeGraphs
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    free_memory()
    session = serve.setup(MOE_SERVE_ARGV)
    cfg, params, args = session.cfg, session.params, session.args
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    weights_gb = sum(t.numel() * t.element_size()
                     for t in leaves(params)) / 1e9
    ops.reset_launches()
    forget_decisions()
    served = serve.run(session)
    launches = dict(ops.LAUNCHES)
    toks = served.tokens
    check(tuple(toks.shape) == (4, NEW_TOKENS), f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "token out of range")
    check_solver_launches(launches, sampler_solves({PATH_B: NEW_TOKENS}),
                          "phase 16 MoE serve")
    decided = decisions_note()
    graphs = session.decode.graphs
    check(len(graphs.keys) == 1, f"decode graphs {graphs.keys}")
    warm_s = serve.run(session).seconds
    state = session.gen.get_state()
    again = serve.run(session)
    session.gen.set_state(state)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=session.gen, device="cuda")
    want = eager_generate(cfg, params, prompt, args.new_tokens, session.gen,
                          session.sampler)
    check(torch.equal(again.tokens, want),
          "the graphed MoE tokens differ from the eager loop's")
    n_tok = toks.numel()
    say(f"phase 16 moe serve: qwen2-moe-a2.7b full width and depth (24 "
        f"layers, d_model 2048, 16/16 heads, 64 padded experts of d_ff "
        f"1408, top-4, 4 shared units, vocab 151936), {weights_gb:.1f} GB "
        f"of bf16 weights drawn in {init_s:.1f}s | one-shot {n_tok} tokens: "
        f"first {served.seconds:.3f}s (one eager step and the capture, "
        f"{graphs.capture_s:.3f}s), warm {warm_s:.3f}s = "
        f"{n_tok / warm_s:.1f} tok/s; tokens == the eager loop's bit for "
        f"bit | launches {launches} | decisions: {decided} | row 0: "
        f"{toks[0].tolist()}")
    _, busy_ms, wall_ms, kernels, calls = profiled(lambda: serve.run(session))
    say_profile("phase 16 one-shot", busy_ms, wall_ms, kernels, calls, n_tok,
                "token", "; warm")
    key = graphs.keys[0]
    step_ms = statistics.median(
        _event_ms(lambda: graphs.run(key, None, device="cuda"))
        for _ in range(9))
    n_bytes = _decode_bytes(cfg, params, args.batch * (args.prompt_len
                                                       + args.new_tokens))
    step_bound = n_bytes / HBM_BYTES_PER_S * 1e3
    say(f"phase 16 graphed decode step (B=4, CUDA events around one "
        f"replay, median of 9): {step_ms:.3f} ms against its byte bound "
        f"{step_bound:.3f} ms ({n_bytes / 1e9:.2f} GB: every weight but the "
        f"embedding, all 64 padded experts, and the KV cache; "
        f"{step_bound / step_ms:.3f} of the bound)")

    # continuous serving on the dense ring: phase 9's requests, no pages
    cs = session._replace(args=serve.parse_args(MOE_CONT_ARGV),
                          decode=DecodeGraphs())
    server = serve.server_for(cs)
    ops.reset_launches()
    forget_decisions()
    first = serve.run_continuous(cs, server)
    cont = dict(ops.LAUNCHES)
    c = first.counts
    check(len(first.completions) == 8, "not every MoE request was served")
    check_solver_launches(
        cont, sampler_solves({PATH_B: c["decode_steps"],
                              1: c["admissions"]}),
        "phase 16 continuous MoE serve")
    warm = serve.run_continuous(cs, server)
    check(streams(warm) == streams(first), "warm MoE streams differ")
    eager_server = serve.server_for(cs)
    eager_server.scheduler.graphs = EagerGraphs()
    eager = serve.run_continuous(cs, eager_server)
    check(streams(eager) == streams(first),
          "the graphed MoE streams differ from the eager step body's")
    n_tok = sum(len(x.tokens) for x in warm.completions)
    lat = sorted(x.latency_s for x in warm.completions)
    steps = warm.counts["decode_steps"]
    say(f"phase 16 moe continuous (dense ring, 8 requests of 512 + up to 32 "
        f"tokens over 4 slots): first {first.seconds:.3f}s, warm "
        f"{warm.seconds:.3f}s = {n_tok / warm.seconds:.1f} tok/s, {steps} "
        f"steps ({warm.seconds / steps * 1e3:.1f} ms a step incl. "
        f"admissions), latency p50 {lat[len(lat) // 2] * 1e3:.0f} ms max "
        f"{lat[-1] * 1e3:.0f} ms; streams == the eager step body's bit for "
        f"bit | launches {cont}")
    say_graphs("phase 16 moe continuous", server.scheduler)
    traced, busy_ms, wall_ms, kernels, calls = profiled(
        lambda: serve.run_continuous(cs, server))
    say_profile("phase 16 continuous", busy_ms, wall_ms, kernels, calls,
                traced.counts["decode_steps"], "decode step", "; warm")
    del server, eager_server

    # the paper's capacity cut: bisect prefill, K3 against the "torch" keep
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=session.gen, device="cuda")
    context = args.prompt_len + args.new_tokens
    dropped = {}
    for mode in ("fifo", "bisect"):
        with MoERecorder(check_keep=mode == "bisect") as rec:
            ops.reset_launches()
            forget_decisions()
            prefill(cfg, params, prompt, context, capacity_mode=mode)
            torch.cuda.synchronize()
            prefill_launches = dict(ops.LAUNCHES)
        dropped[mode] = rec.dropped_frac()
    check(len(rec.equal) == cfg.n_layers and all(rec.equal),
          f"bisect keep masks (K3) differ from the torch backend's: "
          f"{rec.equal}")
    # the capacity cut: one solve a layer, a static k (the capacity) over
    # the (e_pad, A) masked scores
    e_pad = rec.operands[0][2]
    check_solver_launches(
        prefill_launches, {("count_above", e_pad, True): cfg.n_layers},
        "phase 16 bisect prefill")
    (cut, _) = decisions()[("count_above", e_pad, True)]
    _, busy_ms, wall_ms, kernels, calls = profiled(lambda: prefill(
        cfg, params, prompt, context, capacity_mode="bisect"))
    say(f"phase 16 bisect prefill (4 x 64 prompt tokens, A = "
        f"{rec.operands[0][0].numel()} assignments, cap "
        f"{rec.operands[0][3]}): every layer's K3 keep mask == the torch "
        f"backend's bit for bit ({cfg.n_layers} layers, "
        f"{prefill_launches['runahead_topk_threshold']} K3 launches; "
        f"{decisions_note()}) | dropped fraction fifo "
        f"{dropped['fifo']:.6f}, bisect {dropped['bisect']:.6f}")
    if kernels:
        say_kernel_times("phase 16 bisect prefill", kernels, busy_ms,
                         (("K3", "runahead_topk"),))
    row = _capacity_row(rec.operands, cut, "phase 16's bisect prefill")
    say_row("phase 16 K3 moe-prefill-bisect", row)
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"phase 16 peak memory {peak:.2f} GB (weights {weights_gb:.2f} GB) "
        f"(phase 16 took {time.perf_counter() - t0:.1f}s)")
    return launches, prefill_launches, row


def moe_train_depth(cfg, batch: int, seq: int) -> tuple[int, dict]:
    """The deepest cut of ``cfg`` (widths unchanged) whose reckoned peak
    fits MOE_TRAIN_BUDGET bytes, and the reckoning at full depth and at
    the cut: 18 B a parameter (bf16 params and gradients, f32 master, mu
    and nu, the clip's bf16 copy of the gradients), 16 B an element of
    the largest leaf (a run's stacked expert weight: AdamW's and the
    clip's f32 temporaries), the f32 logits three times over (logits,
    softmax, gradient), remat's saved layer inputs, and one layer's
    recompute (the token copies of dispatch and combine, the expert
    buffers)."""
    from repro_torch.models import moe

    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    e_pad = moe.padded_experts(cfg.n_experts)
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    layer = attn + 2 * d + d * e_pad + 3 * e_pad * d * f
    fixed = 2 * cfg.vocab_padded * d + d
    tokens = batch * seq
    cap = moe._capacity(tokens, cfg.n_experts, cfg.moe_top_k,
                        cfg.capacity_factor)

    def need(L: int) -> dict:
        P = fixed + L * layer
        parts = {
            "params": P,
            "state": 18 * P,
            "largest leaf": 16 * L * e_pad * d * f,
            "logits": 12 * tokens * cfg.vocab_padded,
            "remat inputs": 2 * L * tokens * d,
            "layer recompute": 2 * (4 * tokens * cfg.moe_top_k * d
                                    + 3 * e_pad * cap * (d + 3 * f)),
        }
        parts["total"] = sum(v for k, v in parts.items() if k != "params")
        return parts

    L = cfg.n_layers
    while L > 1 and need(L)["total"] > MOE_TRAIN_BUDGET:
        L -= 1
    return L, {"full": need(cfg.n_layers), "cut": need(L)}


def phase_moe_train(gen):
    """launch.train's main in-process for granite-moe-3b-a800m at its
    published width, --capacity-mode bisect, the quantile clip, AdamW, at
    phase 11's batch x sequence, cut in depth only as far as the byte
    reckoning forces: losses, K3, K2 and K7 launches per step, ms a step,
    tok/s, peak memory, dropped fraction, the last step profiled.
    Returns (launches, K3's capacity row, K2's clip row)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    t0 = time.perf_counter()
    cfg = get_config("granite-moe-3b-a800m")
    batch, seq = 2, 4096
    L, reckoned = moe_train_depth(cfg, batch, seq)
    gb = lambda parts: ", ".join(
        f"{k} {v / 1e9:.2f} G" + ("" if k == "params" else "B")
        for k, v in parts.items())
    say(f"phase 17 depth reckoning (budget {MOE_TRAIN_BUDGET / 1e9:.0f} GB "
        f"of the card's 80): full depth {cfg.n_layers} layers: "
        f"{gb(reckoned['full'])} | cut to {L} layers: {gb(reckoned['cut'])}")
    per_step, prof, norms = [], {}, {}

    def on_step(step, metrics):
        per_step.append(dict(ops.LAUNCHES))
        if step == MOE_TRAIN_STEPS - 2:
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif step == MOE_TRAIN_STEPS - 1:
            torch.cuda.synchronize()
            prof["wall_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].__exit__(None, None, None)

    def recorded_clip(grads, *a, **kw):
        out = clip(grads, *a, **kw)
        norms["last"] = out[1].detach()
        return out

    from repro_torch.train import step as train_step
    clip = train_step.clip_by_quantile
    train_step.clip_by_quantile = recorded_clip
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    forget_decisions()
    try:
        with MoERecorder() as rec:
            out = train.main(MOE_TRAIN_ARGV + ["--layers", str(L)],
                             on_step=on_step)
    finally:
        train_step.clip_by_quantile = clip
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    check(len(losses) == MOE_TRAIN_STEPS
          and all(map(math.isfinite, losses)),
          f"MoE training losses not all finite: {losses}")
    # per step: the capacity cut once a layer forward and once in its
    # remat recompute, a static k over the (e_pad, A) masked scores; the
    # clip's (1, leaves) quantile once
    e_pad = rec.last[2]
    want = solver_launches({("count_above", e_pad, True): 2 * L,
                            ("count_below", 1, False): 1})
    (cut, _) = decisions()[("count_above", e_pad, True)]
    (clip_d, _) = decisions()[("count_below", 1, False)]
    prev = {name: 0 for name in launches}
    for i, snap in enumerate(per_step):
        moved = {k: snap[k] - prev[k] for k in snap}
        check({k: moved[k] for k in SOLVER_KERNELS} == want,
              f"step {i}: the capacity cut and the clip launched {moved}, "
              f"where the tuner's decisions ({decisions_note()}) give "
              f"{want}")
        check(moved["flash_fwd"] == 2 * L,
              f"step {i}: K7 launched {moved['flash_fwd']} times")
        prev = snap
    timed = out["step_seconds"][1:MOE_TRAIN_STEPS - 1]
    ms = statistics.median(timed) * 1e3
    n_tok = batch * seq
    say(f"phase 17 moe train: granite-moe-3b-a800m full width (d_model "
        f"1536, 24/8 heads of 64, 48 padded experts of d_ff 512, top-8, "
        f"vocab 49155), depth cut {cfg.n_layers} -> {L} layers, batch "
        f"{batch} x {seq}, capacity bisect, remat, quantile clip, AdamW | "
        f"losses {[round(x, 4) for x in losses]} | warm-up step "
        f"{out['step_seconds'][0] * 1e3:.0f} ms, steps 1-"
        f"{MOE_TRAIN_STEPS - 2} {[round(t * 1e3, 1) for t in timed]} ms, "
        f"median {ms:.1f} ms = {n_tok / ms * 1e3:.0f} tok/s | peak memory "
        f"{peak_gb:.2f} GB (reckoned {reckoned['cut']['total'] / 1e9:.2f} "
        f"GB) | per step: K3 {want['runahead_topk_threshold']} (the "
        f"capacity cut, forward and recompute), K2 {want['multi_count']} "
        f"(the clip), K7 {2 * L} ({decisions_note()}) | dropped "
        f"fraction {rec.dropped_frac():.6f} over {len(rec.dropped)} MoE "
        f"calls | launches {launches}")
    kernels, calls = _profile_records(prof["p"])
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    say_profile("phase 17", busy_ms, prof["wall_ms"], kernels, calls, 1,
                "step", f"; one step (step {MOE_TRAIN_STEPS - 1})")
    if kernels:
        say_kernel_times("phase 17", kernels, busy_ms,
                         (("K3", "runahead_topk"), ("K2", "multi_count"),
                          ("K7", "flash_fwd_")))
        say("phase 17 profile by group: " + ", ".join(
            f"{g} {ms_:.1f} ms ({n_} launches)"
            for g, (ms_, n_) in _kernel_groups(kernels).items()))

    # K3 at the training capacity shape, on this run's last routing; K2
    # at the clip's (1, leaves) with the 2**spec_k - 1 candidates of the
    # clip's decision
    tokens = batch * seq
    scores, expert, e_pad, cap = rec.last
    check((e_pad, scores.numel()) == (48, tokens * cfg.moe_top_k),
          f"the last capacity cut had ({e_pad}, {scores.numel()})")
    k3_row = _capacity_row(
        [rec.last], cut, f"phase 17's training shape (batch {batch} x "
        f"{seq} tokens, top-{cfg.moe_top_k}), the run's last routing")
    k2_row = _k2_clip_row(gen, norms["last"], clip_d,
                          "this run's last step (granite-moe-3b-a800m)")
    say_row("phase 17 K3 moe-train", k3_row)
    say_row("phase 17 K2 moe-train", k2_row)
    say(f"phase 17 took {time.perf_counter() - t0:.1f}s")
    return launches, k3_row, k2_row


# ---------------------------------------------------------------------------
# phase 18: the tuner
# ---------------------------------------------------------------------------

def _with_backend(argv: list[str], backend: str) -> list[str]:
    """``argv`` with the value of ``--backend`` replaced."""
    i = argv.index("--backend")
    return argv[:i + 1] + [backend] + argv[i + 2:]


def _tune_cases(gen):
    """The solves the tuner decides on the default paths: the sampler's at
    the served shape (B=4, V=151936) and its budget, and the quantile
    clip's at (1, leaves) and its own.  (label, kind, operand, params,
    probe, fused, (rounds, spec_k)), ``probe`` where the engine spends an
    M=1 call on the sign at lo0, ``fused`` where K3's whole solve takes
    the budget's whole-round decompositions."""
    import torch

    from repro_torch.optim.clip import clip_by_quantile

    x = torch.randn((PATH_B, PATH_V), generator=gen, device="cuda") * 2.0
    probs = torch.softmax(x, dim=-1)
    k_rows = torch.tensor([1, 40, 300, 5000], device="cuda")
    norms = torch.rand(K2_CLIP[:2], generator=gen, device="cuda") + 0.1
    clip = {n: p.default for n, p in inspect.signature(
        clip_by_quantile).parameters.items() if n in ("q", "rounds",
                                                      "spec_k")}
    sampler = (TUNE_ROUNDS, TUNE_SPEC_K)
    return [
        ("top-k, static k (K3)", "count_above", x, dict(k=40), False, True,
         sampler),
        ("top-k, per-row k (K2)", "count_above", x, dict(k=k_rows), True,
         False, sampler),
        ("top-p (K4)", "mass_at_or_above", probs, dict(p=0.9), True, False,
         sampler),
        ("entropy (K5)", "entropy_at_temperature", x, dict(target=3.0), True,
         False, sampler),
        ("quantile (K2 below)", "count_below", x, dict(q=0.3), False, False,
         sampler),
        (f"the quantile clip {tuple(norms.shape)} (K2 below)", "count_below",
         norms, dict(q=clip["q"]), False, False,
         (clip["rounds"], clip["spec_k"])),
    ]


def _one_decision(kind, operand, **kw):
    """(key, decision) of one solve_kind call, from ``tuning.explain``
    (the tuner's record cleared first)."""
    from repro_torch.core import solver, tuning

    tuning.tuner().recent.clear()
    solver.solve_kind(kind, operand, **kw)
    [(key, decision)] = tuning.explain()
    return key, decision


def _tune_solves(gen, tmp: Path) -> list[dict]:
    """Device ms of a graphed "hopper" solve at every spec_k for each
    case's budget (rounds x spec_k steps), brackets against the "torch"
    backend at the same spec_k and against the hopper bracket at the
    fixed spec_k; the analytic, measured and fixed picks."""
    import torch

    from repro_torch.core import solver, tuning

    out = []
    for i, (label, kind, op, params, probe, fused, (rounds, spec_k)) in (
            enumerate(_tune_cases(gen))):
        kw = dict(rounds=rounds, spec_k=spec_k)
        times, brackets = {}, {}
        for k in range(1, 9):
            with tuning.override(spec_k=k):
                def fn():
                    return solver.solve_kind(kind, op, backend="hopper",
                                             **kw, **params)

                readings = device_ms_reps(fn, calls=10)
                lo, hi = brackets[k] = fn()
                rlo, rhi = solver.solve_kind(kind, op, backend="torch",
                                             **kw, **params)
            if kind.startswith("count"):
                same = torch.equal(lo, rlo) and torch.equal(hi, rhi)
            else:
                same = (torch.allclose(lo, rlo, rtol=1e-4, atol=1e-6)
                        and torch.allclose(hi, rhi, rtol=1e-4, atol=1e-6))
            check(same, f"{label}: the hopper bracket at spec_k {k} differs "
                        f"from the torch backend's")
            times[k] = (statistics.median(readings),
                        max(readings) - min(readings))
        # brackets equal to the fixed spec_k's bit for bit: the count
        # kinds' always (exact counts); K4's and K5's float sums can round
        # a candidate's value apart at another decomposition
        serial = sum(all(torch.equal(a, b) for a, b in zip(
            brackets[k], brackets[spec_k])) for k in brackets)
        key, analytic = _one_decision(kind, op, backend="hopper", **kw,
                                      **params)
        check(analytic.source == "model",
              f"{label}: the analytic decision came from {analytic.source}")
        cache = tmp / f"solve-{i}.json"
        tuning.set_cache_path(str(cache))
        with tuning.autotune():
            _, measured = _one_decision(kind, op, backend="hopper", **kw,
                                        **params)
        tuning.set_cache_path(str(tmp / "none.json"))
        us = json.loads(cache.read_text())["entries"][key]["measured_us"]
        a_ms, a_spread = times[analytic.spec_k]
        f_ms, f_spread = times[spec_k]
        say(f"phase 18 solve {label}: device ms of a graphed solve of "
            f"{rounds * spec_k} steps (median of 5 replays of 10 solves; "
            f"max-min in brackets) at spec_k "
            + ", ".join(f"{k}: {t:.4f} ({sp:.4f})"
                        for k, (t, sp) in times.items())
            + f" | brackets == the torch backend's at every spec_k, "
            f"{serial} of 8 bit for bit equal to the fixed spec_k's | "
            f"analytic pick spec_k {analytic.spec_k} x {analytic.rounds} "
            f"rounds [{analytic.source}] {a_ms:.4f} ms, measured pick "
            f"spec_k {measured.spec_k} [{measured.source}; us {us}], fixed "
            f"spec_k {spec_k} x {rounds} {f_ms:.4f} ms | {key}")
        out.append(dict(label=label, kind=kind, probe=probe, fused=fused,
                        served=tuple(op.shape) == (PATH_B, PATH_V),
                        budget=rounds * spec_k, fixed_k=spec_k, times=times,
                        analytic=(analytic.spec_k, a_ms, a_spread),
                        fixed=(f_ms, f_spread)))
    return out


def _check_analytic_picks(solves: list[dict]) -> None:
    """The analytic pick is not slower than the fixed decomposition by
    more than the spread of either's readings: at the served shape, and
    at the quantile clip's, which the training paths solve by default."""
    for s in solves:
        k, a_ms, a_spread = s["analytic"]
        f_ms, f_spread = s["fixed"]
        check(a_ms <= f_ms + max(a_spread, f_spread),
              f"{s['label']}: the analytic pick spec_k {k} ({a_ms:.4f} ms) "
              f"is slower than the fixed spec_k {s['fixed_k']} ({f_ms:.4f} "
              f"ms) by more than the spread")


def _kernel_ms_by_m(gen) -> dict:
    """Device ms of K2, K4 and K5 at the served (B, V) for M = 2**k - 1
    candidates, k = 1..8 (a round's at spec_k k), at today's geometry."""
    import torch

    from repro_torch.core import tuning
    from repro_torch.kernels import ops

    x = torch.randn((PATH_B, PATH_V), generator=gen, device="cuda") * 2.0
    probs = torch.softmax(x, dim=-1)
    z = x - x.amax(-1, keepdim=True)
    out = {}
    with tuning.disabled():
        for k in range(1, 9):
            M = (1 << k) - 1

            def cand(a, b):
                return torch.linspace(a, b, M, device="cuda").repeat(
                    PATH_B, 1)

            taus, ps, ts = cand(-3.0, 3.0), cand(1e-8, 1e-4), cand(0.05, 20)
            out[M] = {
                "count": device_ms(lambda: ops.multi_count(x, taus)),
                "mass_at_or_above": device_ms(
                    lambda: ops.multi_mass(probs, ps)),
                "entropy_at_temperature": device_ms(
                    lambda: ops.multi_entropy_moments(z, ts)),
            }
    say("phase 18 kernels by M: device ms of a call at (4, 151936), today's "
        "geometry: " + "; ".join(
            f"M={m}: K2 {r['count']:.4f}, K4 {r['mass_at_or_above']:.4f}, "
            f"K5 {r['entropy_at_temperature']:.4f}" for m, r in out.items()))
    return out


def _fit_profile(solves: list[dict], kernels: dict) -> None:
    """The Hopper profile's measured constants (core/tuning.py
    PROFILES["cuda"]), by least squares over this run's readings at the
    served shape, each held to the profile's within PROFILE_SPREAD: per
    kernel, a call at M candidates as launch + M * slope, the slope as
    the kind's operations a (v, m) pair in units of the f32 peak
    (kind_flops) and the mean launch as backend_overhead; the engine's
    round loop as its kernels' time (a probe call where the sign at lo0
    is unknown) plus rounds * (dispatch + spec_k * walk_step); K3's whole
    solve as launch + rounds * (per_round + 2**spec_k * per_point)."""
    import numpy as np

    from repro_torch.core import tuning

    B, V = PATH_B, PATH_V
    ms = sorted(kernels)
    kind_flops, launches = {}, []
    for name in ("count", "mass_at_or_above", "entropy_at_temperature"):
        A = np.array([[1.0, m] for m in ms])
        y = np.array([kernels[m][name] for m in ms]) * 1e-3
        (a, b), *_ = np.linalg.lstsq(A, y, rcond=None)
        launches.append(float(a))
        kind_flops[name] = float(b * F32_OPS_PER_S / (B * V))
    rows, ys, fused = [], [], []
    for s in solves:
        if not s["served"]:
            continue
        ev = "count" if s["kind"].startswith("count") else s["kind"]
        budget = s["budget"]
        for k, (t, _) in s["times"].items():
            rounds, t = -(-budget // k), t * 1e-3
            if s["fused"] and rounds * k == budget:
                fused.append(([1.0, rounds, rounds * (1 << k)], t))
                continue
            probe = kernels[1][ev] * 1e-3 if s["probe"] else 0.0
            ys.append(t - probe - rounds * kernels[(1 << k) - 1][ev] * 1e-3)
            rows.append([rounds, rounds * k])
    (dispatch, walk), *_ = np.linalg.lstsq(np.array(rows), np.array(ys),
                                           rcond=None)
    f, *_ = np.linalg.lstsq(np.array([r for r, _ in fused]),
                            np.array([t for _, t in fused]), rcond=None)
    prof = tuning.PROFILES["cuda"]
    pairs = {
        "dispatch": (float(dispatch), prof.dispatch),
        "walk_step": (float(walk), prof.walk_step),
        "backend_overhead": (float(np.mean(launches)),
                             prof.backend_overhead["hopper"]),
        "kind_flops count": (kind_flops["count"],
                             prof.kind_flops["count_above"]),
        "kind_flops mass": (kind_flops["mass_at_or_above"],
                            prof.kind_flops["mass_at_or_above"]),
        "kind_flops entropy": (kind_flops["entropy_at_temperature"],
                               prof.kind_flops["entropy_at_temperature"]),
    }
    for i, part in enumerate(("launch", "per round", "per point")):
        pairs[f"fused {part}"] = (float(f[i]), prof.fused["hopper"][i])
    off = {name: abs(fit / held - 1) for name, (fit, held) in pairs.items()}
    say("phase 18 profile fit (least squares over this run's readings, "
        "beside core/tuning.py PROFILES['cuda']): " + ", ".join(
            f"{name} {fit:.4g} (held {held:.4g}, {off[name]:.1%} off)"
            for name, (fit, held) in pairs.items()))
    check(max(off.values()) <= PROFILE_SPREAD,
          f"a fitted Hopper profile constant is more than "
          f"{PROFILE_SPREAD:.0%} off PROFILES['cuda']: recalibrate "
          f"core/tuning.py ({off})")


def _geometry_cases(gen):
    """(family, key shape, operands, the launcher at params, the plain
    version, exact) at the served shapes of K2-K6."""
    import torch

    from repro_torch.kernels import multi_count as mc
    from repro_torch.kernels import multi_entropy as me
    from repro_torch.kernels import multi_mass as mm
    from repro_torch.kernels import paged_attend as pa
    from repro_torch.kernels import runahead_threshold as rt

    x = torch.randn((PATH_B, PATH_V), generator=gen, device="cuda") * 2.0
    probs = torch.softmax(x, dim=-1)
    z = x - x.amax(-1, keepdim=True)
    lo, hi = x.amin(-1, keepdim=True), x.amax(-1, keepdim=True)
    taus = lo + (hi - lo) * torch.rand((PATH_B, PATH_M), generator=gen,
                                       device="cuda")
    ps = torch.rand((PATH_B, PATH_M), generator=gen, device="cuda") * 1e-4
    ts = 0.05 + 20 * torch.rand((PATH_B, PATH_M), generator=gen,
                                device="cuda")
    k6 = _k6_inputs(gen, K6_PATH, torch.bfloat16)
    B, P, nkv = K6_PATH["B"], K6_PATH["P"], K6_PATH["nkv"]
    chain = -(-K6_PATH["C"] // P)
    rows = (PATH_B, PATH_V, PATH_M)
    return [
        ("multi_count", rows, lambda p: mc.multi_count_cuda(x, taus, nb=p),
         lambda: mc.multi_count_plain(x, taus), True),
        ("multi_mass", rows, lambda p: mm.multi_mass_cuda(probs, ps, nb=p),
         lambda: mm.multi_mass_plain(probs, ps), False),
        ("multi_entropy_moments", rows,
         lambda p: me.multi_entropy_moments_cuda(z, ts, nb=p),
         lambda: me.multi_entropy_moments_plain(z, ts), False),
        ("runahead_topk", (PATH_B, PATH_V),
         lambda p: rt.runahead_topk_threshold_cuda(
             x, k_target=40, rounds=8, spec_k=5, clusters=p),
         lambda: rt.runahead_topk_threshold_plain(
             x, k_target=40, rounds=8, spec_k=5), True),
        ("paged_attend", (B, nkv, chain, P, K6_PATH["L"],
                          K6_PATH["nq"] // nkv, K6_PATH["hd"]),
         lambda p: pa.paged_attend_cuda(*k6, context=K6_PATH["C"],
                                        n_split=p),
         lambda: pa.paged_attend_plain(*k6, context=K6_PATH["C"]), False),
    ]


def _tune_geometry(gen, tmp: Path) -> None:
    """Every candidate geometry of the kernel tier at K2-K6's served
    shapes: device ms, held to the plain version (K2, K3 bit for bit; K4,
    K5 rtol 1e-5 / atol 1e-6; K6 bf16 within 1e-2, compared in f32) and
    bit-stable run to run; then the measured tier's pick."""
    import torch

    from repro_torch.core import tuning
    from repro_torch.kernels import ops

    def tensors(out):
        return out if isinstance(out, tuple) else (out,)

    tuning.set_cache_path(str(tmp / "kernels.json"))
    for name, shape, launch, plain, exact in _geometry_cases(gen):
        dtype = "bfloat16" if name == "paged_attend" else "float32"
        key = tuning.KernelKey(name, shape, dtype,
                               tuning.device_kind("cuda"))
        param = tuning.KERNEL_PARAMS[name]
        want = [w.float() for w in tensors(plain())]
        cells = []
        for cand in tuning.kernel_candidates(key):
            v = cand.params[param]
            got = [g.float() for g in tensors(launch(v))]
            again = [g.float() for g in tensors(launch(v))]
            for g, a, w in zip(got, again, want):
                check(torch.equal(g.view(torch.int32), a.view(torch.int32)),
                      f"{name} at {param}={v} is not bit-stable")
                if exact:
                    check(torch.equal(g, w), f"{name} at {param}={v} "
                                             f"differs from plain")
                elif name == "paged_attend":
                    check(torch.allclose(g, w, rtol=1e-2, atol=1e-2),
                          f"{name} at {param}={v} differs from plain")
                else:
                    check(torch.allclose(g, w, **TOL),
                          f"{name} at {param}={v} differs from plain")
            cells.append(f"{v}: {device_ms(lambda: launch(v)):.4f}")
        fixed = tuning.kernel_candidates(key)[0].params
        with tuning.autotune():
            d = tuning.decide_kernel(
                key, fixed=fixed,
                measure=lambda c: ops._measure_kernel(key, c,
                                                      torch.device("cuda")))
        say(f"phase 18 geometry {name} {shape}: device ms at {param} "
            + ", ".join(cells) + f" (today's {param}={fixed[param]}) | "
            f"every candidate == plain, bit-stable | measured pick "
            f"{d.label()} [{d.source}]")
    tuning.set_cache_path(str(tmp / "none.json"))


def _tuned_serves(tmp: Path, per_step_streams: dict) -> None:
    """The launcher at full width, one-shot and continuous paged, under
    tuning.disabled(); by default (the analytic solver tier, today's
    geometry: the streams equal the disabled runs', phase 9's for the
    continuous one); with --backend auto --autotune, its cache in a temp
    dir; replayed with only the solver tier's winners (streams equal the
    disabled runs') and with both (top-k-only streams equal the disabled
    run's); the decisions' ``tuned ... ->`` lines."""
    import torch

    from repro_torch.core import tuning
    from repro_torch.launch import serve

    one_shot = _with_backend(SERVE_ARGV, "auto")
    cont = _with_backend(CONT_ARGV, "auto")
    topk_only = _with_backend(
        ["--arch", "qwen3-4b", "--batch", "4", "--prompt-len", "64",
         "--new-tokens", str(NEW_TOKENS), "--top-k", "40",
         "--backend", "hopper"], "auto")
    full, solver_only = tmp / "serve.json", tmp / "serve-solver.json"
    with tuning.disabled():
        ref = serve.main(SERVE_ARGV).tokens
        ref_cont = streams(serve.main(CONT_ARGV))
        ref_topk = serve.main(topk_only).tokens
    check(torch.equal(serve.main(SERVE_ARGV).tokens, ref)
          and per_step_streams == ref_cont,
          "the default path's streams (the analytic solver tier) differ "
          "from the tuning.disabled() runs'")
    full.unlink(missing_ok=True)
    tuning.set_cache_path(str(full))
    t0 = time.perf_counter()
    tuning.tuner().recent.clear()
    tuning.tuner().recent_kernels.clear()
    tuned = serve.main(one_shot + ["--autotune"]).tokens
    tuned_cont = streams(serve.main(cont + ["--autotune"]))
    tune_s = time.perf_counter() - t0
    lines = ([f"tuned {k} -> {d.placement}/{d.backend} spec_k={d.spec_k} "
              f"rounds={d.rounds} [{d.source}]"
              for k, d in tuning.explain()]
             + [f"tuned {k} -> {d.label()} [{d.source}]"
                for k, d in tuning.explain_kernels()])
    for line in lines:
        say(f"phase 18 {line}")
    data = json.loads(full.read_text())
    check(data["entries"] and data["kernels"],
          "the autotuned serves kept no measured winner")
    solver_only.write_text(json.dumps(dict(data, kernels={})))
    tuning.set_cache_path(str(solver_only))
    tuning.tuner().recent_kernels.clear()
    replay = serve.main(one_shot).tokens
    replay_cont = streams(serve.main(cont))
    check(all(d.source in ("cache", "model") for _, d in tuning.explain())
          and all(d.source == "model" for _, d in tuning.explain_kernels()),
          "the solver-tier replay measured again")
    check(torch.equal(replay, ref) and replay_cont == ref_cont,
          "under the solver tier alone the streams differ from the "
          "tuning.disabled() run's")
    tuning.set_cache_path(str(full))
    replay_topk = serve.main(topk_only).tokens
    check(torch.equal(replay_topk, ref_topk),
          "top-k-only streams under both tiers differ from the "
          "tuning.disabled() run's")
    tuning.set_cache_path(str(tmp / "none.json"))
    say(f"phase 18 tuned serves: qwen3-4b full width, one-shot and "
        f"continuous paged: by default (phase 9's streams) tokens == the "
        f"tuning.disabled() runs'; with --backend auto --autotune "
        f"({tune_s:.1f}s, "
        f"{len(data['entries'])} solver and {len(data['kernels'])} kernel "
        f"winners kept); replayed with the solver tier's winners alone: "
        f"tokens == the tuning.disabled() runs' (one-shot row 0 "
        f"{replay[0].tolist()}; {len(replay_cont)} continuous streams); "
        f"with both tiers' winners: top-k-only tokens == the disabled "
        f"run's; the autotuned run's own row 0 {tuned[0].tolist()}, "
        f"{sum(tuned_cont[r] == per_step_streams[r] for r in tuned_cont)} "
        f"of {len(tuned_cont)} continuous streams equal phase 9's")


def _tuned_draft_len(verify_ms: dict) -> None:
    """What ``--speculative`` with ``--draft-len auto`` picks, and what
    this run's phase 15 verify-step readings would pick; a short
    speculative continuous serve through the launcher."""
    from repro_torch.core import tuning
    from repro_torch.launch import serve

    args = serve.parse_args(CONT_ARGV + ["--speculative"])
    launcher = serve.resolve_draft_len(args, serve.get_config(args.arch))
    row, overhead = tuning.verify_step_cost(verify_ms)
    here = tuning.decide_draft_len(acceptance=serve.ACCEPTANCE_PRIOR,
                                   token_cost=row, overhead=overhead)
    out = serve.main(CONT_ARGV + ["--speculative", "--requests", "4"])
    check(len(out.completions) == 4 and out.scheduler.max_draft_len > 1,
          "--continuous --speculative did not serve speculatively")
    say(f"phase 18 draft length: --speculative --draft-len auto picks L = "
        f"{launcher} (core/tuning.py VERIFY_STEP_MS: a verify step is "
        f"{tuning.verify_step_cost()[1] / tuning.verify_step_cost()[0]:.1f}"
        f" row costs of overhead); this run's phase 15 readings "
        f"{verify_ms} give {overhead / row:.1f} and L = {here}; the "
        f"speculative serve (4 requests): {out.counts['drafted']} drafted, "
        f"{out.counts['accepted']} accepted at draft_len "
        f"{out.scheduler.draft_len}")


def phase_tuning(gen, per_step_streams: dict, verify_ms: dict) -> None:
    """The tuner on the card: solve times at every spec_k with the
    analytic, measured and fixed picks; the profile fit; every kernel
    geometry's time; the tuned launcher; the draft length."""
    import tempfile

    from repro_torch.core import tuning

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        # no winner of an earlier run is replayed as an analytic pick
        tuning.set_cache_path(str(tmp / "none.json"))
        solves = _tune_solves(gen, tmp)
        _fit_profile(solves, _kernel_ms_by_m(gen))
        _check_analytic_picks(solves)
        _tune_geometry(gen, tmp)
        _tuned_serves(tmp, per_step_streams)
        _tuned_draft_len(verify_ms)
    say(f"phase 18 took {time.perf_counter() - t0:.1f}s")



# ---------------------------------------------------------------------------
# phases 19 and 20: the recurrent families
# ---------------------------------------------------------------------------

def _cache_bytes(cache) -> tuple[int, int]:
    """(K/V bytes, recurrent state bytes) of a cache."""
    from repro_torch.tree import leaves_with_path

    kv = state = 0
    for path, t in leaves_with_path(cache):
        n = t.numel() * t.element_size()
        if "/kv/" in path:
            kv += n
        else:
            state += n
    return kv, state


def _step_bound(params, cache) -> tuple[float, str]:
    """A batched decode step's byte bound (ms) over ``cache``: every weight
    read once but the embedding table (its B rows are gathered), every
    K/V row of the cache read (the dense ring is read whole, masked), and
    every recurrent state read and written once."""
    from repro_torch.tree import leaves

    weights = sum(t.numel() * t.element_size() for t in leaves(params))
    embed = params["embed"].numel() * params["embed"].element_size()
    kv, state = _cache_bytes(cache)
    n = weights - embed + kv + 2 * state
    return n / HBM_BYTES_PER_S * 1e3, (
        f"{n / 1e9:.3f} GB: weights but the embedding "
        f"{(weights - embed) / 1e9:.3f}, K/V {kv / 1e9:.3f}, recurrent "
        f"state {state / 1e9:.3f} read and written")


def _graph_ms(graphs, key) -> float:
    """Device ms of one replay of ``key``'s graph (CUDA events around one
    replay, median of 9)."""
    return statistics.median(
        _event_ms(lambda: graphs.run(key, None, device="cuda"))
        for _ in range(9))


def timed_admissions(server) -> list[float]:
    """Wraps ``server``'s scheduler's admit so that each admission's wall
    ms (prefill and first sample, the device synced before and after) is
    appended to the returned list."""
    import torch

    sched = server.scheduler
    admit, times = sched.admit, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = admit(*a, **kw)
        torch.cuda.synchronize()
        if ok:
            times.append((time.perf_counter() - t0) * 1e3)
        return ok

    sched.admit = timed
    return times


def _decode_window(label: str, server, requests) -> None:
    """Four requests admitted into a drained scheduler (eagerly, outside
    the window), then its graphed steps until they finish, profiled: the
    device's busy time and idle share while the card decodes.  (A whole
    serve's profile is dominated by the eager admissions' ~10**5 launches
    each, and reading it back takes minutes.)"""
    sched = server.scheduler
    check(sched.n_active == 0, "the scheduler still holds requests")
    for r in requests[:4]:
        check(sched.admit(r.rid, r.prompt, r.n_new, r.seed, r.sampler),
              "admission failed")

    def run():
        n = 0
        while sched.n_active:
            sched.step()
            n += 1
        return n

    n, busy_ms, wall_ms, kernels, calls = profiled(run)
    sched.pop_finished()
    say_profile(f"{label} continuous decode", busy_ms, wall_ms, kernels,
                calls, n, "decode step", "; 4 requests, the graphed steps "
                "after their admissions")


def _frozen_lanes(server, requests) -> str:
    """Two requests admitted into lanes 0 and 1 of a served scheduler: a
    graphed step leaves lanes 2 and 3 (stale state of earlier requests)
    bit for bit as they were, every cache leaf; the live lanes' recurrent
    states move.  Then the two are served to their end."""
    import torch

    from repro_torch.tree import leaves_with_path

    sched = server.scheduler
    check(sched.n_active == 0, "the scheduler still holds requests")
    for r in requests[:2]:
        check(sched.admit(r.rid, r.prompt, r.n_new, r.seed, r.sampler),
              "admission failed")
    check([s is not None for s in sched.slots] == [True, True, False, False],
          "lanes 0 and 1 are not the live ones")
    before = [(p, t[:, 2:].clone(), t[:, :2].clone())
              for p, t in leaves_with_path(sched.cache)]
    sched.step()
    torch.cuda.synchronize()
    moved = 0
    for (path, idle, live), (_, t) in zip(before,
                                          leaves_with_path(sched.cache)):
        check(torch.equal(t[:, 2:], idle),
              f"an inactive lane's {path} changed across a graphed step")
        if "/kv/" not in path:
            moved += not torch.equal(t[:, :2], live)
    n_state = sum("/kv/" not in p for p, _, _ in before)
    check(moved == n_state, f"{n_state - moved} of {n_state} recurrent "
                            f"leaves of the live lanes did not move")
    while sched.n_active:
        sched.step()
    sched.pop_finished()
    return (f"inactive lanes 2, 3 bit for bit across a graphed step in "
            f"all {len(before)} cache leaves; the live lanes' {n_state} "
            f"recurrent leaves moved")


def _prefill_reproduces_forward(arch: str, gen) -> str:
    """At full width in f32, the depth cut to the first run of each kind
    (whisper's 4 decoder layers and its whole encoder over f32 frames):
    the prefill's last logits and each decode step's against the
    full-sequence forward's at the same positions, max |diff| within
    RECURRENT_F32_TOL of the logits' largest |value|."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models import decode, transformer

    full = get_config(arch)
    plan = transformer.layer_plan(full)
    seen, depth = set(), 0
    for kind, count in plan:
        if kind in seen:
            break
        seen.add(kind)
        depth += count
    cfg = dataclasses.replace(full, n_layers=depth)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = transformer.init_params(cfg, g, torch.float32)
    S, n = RECURRENT_CHECK[arch]
    tokens = torch.randint(0, cfg.vocab, (1, S + n), generator=gen,
                           device="cuda")
    frames = (torch.randn((1, cfg.encoder_len, cfg.d_model), generator=gen,
                          device="cuda") if cfg.is_encdec else None)
    f32 = dict(compute_dtype=torch.float32)
    want, _ = transformer.forward(cfg, params, tokens, encoder_frames=frames,
                                  **f32)
    logits, cache = decode.prefill(cfg, params, tokens[:, :S], S + n,
                                   encoder_frames=frames, **f32)
    got = [logits]
    for pos in range(S, S + n - 1):
        logits, cache = decode.decode_step(cfg, params, tokens[:, pos], pos,
                                           cache, **f32)
        got.append(logits)
    got = torch.stack(got, dim=1)[..., :cfg.vocab]
    want = want[:, S - 1:S + n - 1, :cfg.vocab]
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    check(err <= RECURRENT_F32_TOL * top,
          f"{arch}: prefill + decode steps differ from the forward by "
          f"{err:.3g} (largest |logit| {top:.3g})")
    del params, cache
    return (f"f32, depth cut to {depth} layers ({transformer.layer_plan(cfg)})"
            f", prompt {S} + {n - 1} steps: prefill and steps == the forward "
            f"within {err:.3g} (largest |logit| {top:.3g}; tolerance "
            f"{RECURRENT_F32_TOL} of it)")


def phase_recurrent(phase: int, arch: str, oneshot_argv, cont_argv, gen,
                    describe: str) -> dict:
    """One recurrent family served as a user serves it: launch.serve's
    setup and runs at full width and depth, random bf16 weights from seed
    0; one-shot (its decode graph against the eager loop) and continuous
    on the dense ring at step horizons 1 and 4 (streams equal; the
    graphed steps' streams equal the eager step body's); tok/s, idle
    share, admission ms, graphed decode steps against their byte bounds,
    frozen lanes, prefill + steps against the forward, peak memory.
    Returns {path: launches}: ``<family>-serve`` (the one-shot run) and
    ``<family>-continuous``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.engine import DecodeGraphs
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    label = f"phase {phase}"
    family = arch.split("-")[0]
    free_memory()
    session = serve.setup(oneshot_argv)
    cfg, params, args = session.cfg, session.params, session.args
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    weights_gb = sum(t.numel() * t.element_size()
                     for t in leaves(params)) / 1e9
    ops.reset_launches()
    forget_decisions()
    served = serve.run(session)
    launches = dict(ops.LAUNCHES)
    toks = served.tokens
    check(tuple(toks.shape) == (args.batch, args.new_tokens),
          f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"a token >= {cfg.vocab} (a phantom column) was sampled")
    check_solver_launches(launches,
                          sampler_solves({args.batch: args.new_tokens}),
                          f"{label} {arch} serve")
    decided = decisions_note()
    graphs = session.decode.graphs
    check(len(graphs.keys) == 1, f"decode graphs {graphs.keys}")
    warm_s = serve.run(session).seconds
    state = session.gen.get_state()
    again = serve.run(session)
    session.gen.set_state(state)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=session.gen, device="cuda")
    want = eager_generate(cfg, params, prompt, args.new_tokens, session.gen,
                          session.sampler)
    check(torch.equal(again.tokens, want),
          f"the graphed {arch} tokens differ from the eager loop's")
    n_tok = toks.numel()
    say(f"{label} {family} serve: {arch} full width and depth ({describe}), "
        f"{weights_gb:.2f} GB of bf16 weights drawn in {init_s:.1f}s | "
        f"one-shot batch {args.batch} x prompt {args.prompt_len}, "
        f"{n_tok} tokens: first {served.seconds:.3f}s (one eager step and "
        f"the capture, {graphs.capture_s:.3f}s), warm {warm_s:.3f}s = "
        f"{n_tok / warm_s:.1f} tok/s; tokens == the eager loop's bit for "
        f"bit, none >= {cfg.vocab} | launches {launches} | decisions: "
        f"{decided} | row 0: {toks[0].tolist()}")
    _, busy_ms, wall_ms, kernels, calls = profiled(lambda: serve.run(session))
    say_profile(f"{label} one-shot", busy_ms, wall_ms, kernels, calls, n_tok,
                "token", "; warm")
    if kernels:
        say_kernel_times(f"{label} one-shot", kernels, busy_ms,
                         SAMPLER_KERNELS + (("K7", "flash_fwd_"),))
    key = graphs.keys[0]
    step_ms = _graph_ms(graphs, key)
    bound, what = _step_bound(params, session.decode._states[key].cache)
    say(f"{label} graphed one-shot decode step (B={args.batch}, CUDA events "
        f"around one replay, median of 9): {step_ms:.3f} ms against its "
        f"byte bound {bound:.3f} ms ({what}; {bound / step_ms:.3f} of the "
        f"bound)")
    paths = {f"{family}-serve": launches}
    session = session._replace(decode=DecodeGraphs())

    # continuous on the dense ring, per step and in fused horizons of 4
    cs = session._replace(args=serve.parse_args(cont_argv))
    server = serve.server_for(cs)
    ops.reset_launches()
    forget_decisions()
    first = serve.run_continuous(cs, server)
    cont = dict(ops.LAUNCHES)
    c = first.counts
    check(len(first.completions) == 8, f"not every {arch} request served")
    check(all(0 <= t < cfg.vocab for s in streams(first).values()
              for t in s), f"a token >= {cfg.vocab} was sampled")
    check_solver_launches(
        cont, sampler_solves({4: c["decode_steps"], 1: c["admissions"]}),
        f"{label} continuous {arch} serve")
    paths[f"{family}-continuous"] = cont
    warm = serve.run_continuous(cs, server)
    check(streams(warm) == streams(first), f"warm {arch} streams differ")
    eager_server = serve.server_for(cs)
    eager_server.scheduler.graphs = EagerGraphs()
    adm = timed_admissions(eager_server)
    eager = serve.run_continuous(cs, eager_server)
    check(streams(eager) == streams(first),
          f"the graphed {arch} streams differ from the eager step body's")
    del eager_server
    n_tok = sum(len(x.tokens) for x in warm.completions)
    lat = sorted(x.latency_s for x in warm.completions)
    steps = warm.counts["decode_steps"]
    say(f"{label} {family} continuous (dense ring, 8 requests of "
        f"{cs.args.prompt_len} + 16..32 tokens over 4 slots, step_horizon "
        f"1): first {first.seconds:.3f}s, warm {warm.seconds:.3f}s = "
        f"{n_tok / warm.seconds:.1f} tok/s, {steps} steps "
        f"({warm.seconds / steps * 1e3:.1f} ms a step incl. admissions), "
        f"latency p50 {lat[len(lat) // 2] * 1e3:.0f} ms max "
        f"{lat[-1] * 1e3:.0f} ms; streams == the eager step body's bit for "
        f"bit | launches {cont} | decisions: {decisions_note()}")
    say_graphs(f"{label} {family} continuous", server.scheduler)
    say(f"{label} admissions (prefill of {cs.args.prompt_len} tokens and the "
        f"first sample, synced; the eager serve's): median "
        f"{statistics.median(adm):.1f} ms, min {min(adm):.1f}, max "
        f"{max(adm):.1f} over {len(adm)}, {sum(adm) / 1e3:.3f}s in all")
    requests = serve.continuous_requests(cfg, cs.args, cs.sampler)
    _decode_window(label, server, requests)
    sched = server.scheduler
    [key] = [k for k in sched.graphs.keys if k[0] == "step"]
    step_ms = _graph_ms(sched.graphs, key)
    bound, what = _step_bound(params, sched.cache)
    say(f"{label} graphed continuous decode step (4 slots, CUDA events "
        f"around one replay, median of 9): {step_ms:.3f} ms against its "
        f"byte bound {bound:.3f} ms ({what}; {bound / step_ms:.3f} of the "
        f"bound)")
    say(f"{label} frozen lanes: " + _frozen_lanes(server, requests))

    hs = cs._replace(args=serve.parse_args(cont_argv + [
        "--step-horizon", str(HORIZON)]))
    fused_server = serve.server_for(hs)
    fused = serve.run_continuous(hs, fused_server)
    check(streams(fused) == streams(first),
          f"the {arch} fused streams differ from the per-step streams")
    fused_warm = serve.run_continuous(hs, fused_server)
    check(streams(fused_warm) == streams(first),
          f"the warm {arch} fused streams differ")
    f = fused_warm.counts
    say(f"{label} {family} horizons (step_horizon {HORIZON}): streams == "
        f"the per-step streams bit for bit | first {fused.seconds:.3f}s, "
        f"warm {fused_warm.seconds:.3f}s = "
        f"{n_tok / fused_warm.seconds:.1f} tok/s; {f['decode_steps']} "
        f"iterations in {f['horizons']} horizons ({f['wasted_steps']} "
        f"all-idle), {f['host_syncs']} host syncs")
    del server, fused_server
    say(f"{label} reference: {_prefill_reproduces_forward(arch, gen)}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"{label} peak memory {peak:.2f} GB (weights {weights_gb:.2f} GB) "
        f"({label} took {time.perf_counter() - t0:.1f}s)")
    return paths

def _whisper_step_bound(params, cache) -> tuple[float, str]:
    """A whisper decode step's byte bound (ms): the decoder's weights and
    final norm, the tied embedding read whole as the unembedding, the
    self-attention ring read whole (masked) and the encoder K/V read once.
    The encoder's weights are not read by a step, and of the position
    table only the B rows it gathers."""
    from repro_torch.tree import leaves, leaves_with_path

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in leaves(tree))

    weights = (nbytes(params["runs"]) + nbytes(params["final_norm"])
               + nbytes(params["embed"]))
    kv = enc = 0
    for path, t in leaves_with_path(cache):
        if "enc_" in path:
            enc += t.numel() * t.element_size()
        else:
            kv += t.numel() * t.element_size()
    n = weights + kv + enc
    return n / HBM_BYTES_PER_S * 1e3, (
        f"{n / 1e9:.4f} GB: decoder weights and the tied unembedding "
        f"{weights / 1e9:.4f}, ring K/V {kv / 1e9:.4f}, encoder K/V "
        f"{enc / 1e9:.4f}")


def whisper_requests(cfg, gen) -> list:
    """Phase 21's continuous workload: WHISPER_CONT's requests, each
    (rid, prompt, n_new, seed, its frames (1, T_enc, D) in bf16, arrival
    step), prompts and budgets from a seeded numpy generator, frames
    drawn on the card from ``gen``."""
    import numpy as np
    import torch

    w = WHISPER_CONT
    rng = np.random.default_rng(21)
    frames = torch.randn((w["requests"], cfg.encoder_len, cfg.d_model),
                         generator=gen, device="cuda", dtype=torch.bfloat16)
    return [(i, rng.integers(0, cfg.vocab, size=w["prompt"]).tolist(),
             int(rng.integers(w["new"] // 2, w["new"] + 1)), 2100 + i,
             frames[i:i + 1], i // w["burst"])
            for i in range(w["requests"])]


def serve_with_frames(sched, requests, sc) -> tuple[dict, list[float]]:
    """Serve ``requests`` (``whisper_requests``'s tuples) through the
    scheduler, each admitted with its own frames (the server takes none,
    in either package): at decode step t the requests arrived by t are
    admitted while a slot is free, then one ``step``.  Returns ({rid:
    tokens}, each admission's wall ms, the device synced around it)."""
    import torch

    todo, out, adm, t = list(requests), {}, [], 0
    while todo or sched.n_active:
        while todo and todo[0][5] <= t and sched.has_free_slot():
            rid, prompt, n_new, seed, frames, _ = todo.pop(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(sched.admit(rid, prompt, n_new, seed, sc,
                              encoder_frames=frames), "admission failed")
            torch.cuda.synchronize()
            adm.append((time.perf_counter() - t0) * 1e3)
        if sched.n_active:
            sched.step()
        for fin in sched.pop_finished():
            out[fin.rid] = list(fin.tokens)
        t += 1
    return out, adm


def phase_whisper(gen) -> dict:
    """whisper-tiny served as a user serves it, at full width and depth
    (random bf16 weights from seed 0): launch.serve one-shot (graph
    replays against the eager loop), and continuous on the dense ring
    through the scheduler's admit(encoder_frames=) per step (against the
    eager step body) and at step_horizon 4; tok/s, idle share, admission
    ms (the eager encoder), graphed steps against their byte bounds,
    prefill + steps against the f32 forward, peak memory.  Returns {path:
    launches}: ``whisper-serve`` (the one-shot run) and
    ``whisper-continuous``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.scheduler import ContinuousScheduler
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    label = "phase 21"
    free_memory()
    session = serve.setup(WHISPER_SERVE_ARGV)
    cfg, params, args, sc = (session.cfg, session.params, session.args,
                             session.sampler)
    torch.cuda.reset_peak_memory_stats()
    weights_mb = sum(t.numel() * t.element_size()
                     for t in leaves(params)) / 1e6
    ops.reset_launches()
    forget_decisions()
    served = serve.run(session)
    launches = dict(ops.LAUNCHES)
    toks = served.tokens
    check(tuple(toks.shape) == (args.batch, args.new_tokens),
          f"tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"a token >= {cfg.vocab} (a phantom column) was sampled")
    check_solver_launches(launches,
                          sampler_solves({args.batch: args.new_tokens}),
                          f"{label} whisper serve")
    decided = decisions_note()
    graphs = session.decode.graphs
    check(len(graphs.keys) == 1, f"decode graphs {graphs.keys}")
    warm_s = serve.run(session).seconds
    state = session.gen.get_state()
    again = serve.run(session)
    session.gen.set_state(state)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=session.gen, device="cuda")
    frames = torch.randn((args.batch, cfg.encoder_len, cfg.d_model),
                         generator=session.gen, device="cuda",
                         dtype=torch.bfloat16)
    want = eager_generate(cfg, params, prompt, args.new_tokens, session.gen,
                          sc, frames)
    check(torch.equal(again.tokens, want),
          "the graphed whisper tokens differ from the eager loop's")
    n_tok = toks.numel()
    say(f"{label} whisper serve: whisper-tiny full width and depth (4 "
        f"encoder + 4 decoder layers, d_model 384, 6 heads of 64, vocab "
        f"51865 padded to 51968, encoder_len 1500; "
        f"{cfg.param_count() / 1e6:.1f}M params, {weights_mb:.1f} MB of "
        f"bf16 weights with the 32768-row position table) | one-shot "
        f"batch {args.batch} x prompt {args.prompt_len} with frames (16, "
        f"1500, 384), {n_tok} tokens: first {served.seconds:.3f}s (one "
        f"eager step and the capture, {graphs.capture_s:.3f}s), warm "
        f"{warm_s:.3f}s = {n_tok / warm_s:.1f} tok/s; tokens == the eager "
        f"loop's bit for bit, none >= {cfg.vocab} | launches {launches} | "
        f"decisions: {decided} | row 0: {toks[0, :16].tolist()}")
    _, busy_ms, wall_ms, kernels, calls = profiled(lambda: serve.run(session))
    say_profile(f"{label} one-shot", busy_ms, wall_ms, kernels, calls, n_tok,
                "token", "; warm, the eager prefill and encoder included")
    if kernels:
        say_kernel_times(f"{label} one-shot", kernels, busy_ms)
    key = graphs.keys[0]
    step_ms = _graph_ms(graphs, key)
    bound, what = _whisper_step_bound(params,
                                      session.decode._states[key].cache)
    say(f"{label} graphed one-shot decode step (B={args.batch}, CUDA events "
        f"around one replay, median of 9): {step_ms:.3f} ms against its "
        f"byte bound {bound:.4f} ms ({what}; {bound / step_ms:.3f} of the "
        f"bound)")
    paths = {"whisper-serve": launches}
    del session

    # continuous on the dense ring: the scheduler's admit(encoder_frames=)
    w = WHISPER_CONT
    requests = whisper_requests(cfg, gen)

    def scheduler(**kw):
        return ContinuousScheduler(
            cfg, params, n_slots=w["slots"], context=w["prompt"] + w["new"],
            spec_k=sc.spec_k, rounds=sc.rounds, backend=sc.backend, **kw)

    sched = scheduler()
    ops.reset_launches()
    forget_decisions()
    t1 = time.perf_counter()
    first, _ = serve_with_frames(sched, requests, sc)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    cont = dict(ops.LAUNCHES)
    steps, n_adm = sched.n_decode_steps, sched.n_admissions
    check(len(first) == w["requests"], "not every whisper request served")
    check(all(0 <= t < cfg.vocab for s in first.values() for t in s),
          f"a token >= {cfg.vocab} was sampled")
    check_solver_launches(
        cont, sampler_solves({w["slots"]: steps, 1: n_adm}),
        f"{label} continuous whisper serve")
    paths["whisper-continuous"] = cont
    t1 = time.perf_counter()
    warm, adm = serve_with_frames(sched, requests, sc)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    check(warm == first, "warm whisper streams differ")
    eager = scheduler()
    eager.graphs = EagerGraphs()
    check(serve_with_frames(eager, requests, sc)[0] == first,
          "the graphed whisper streams differ from the eager step body's")
    del eager
    fused = scheduler(step_horizon=HORIZON)
    check(serve_with_frames(fused, requests, sc)[0] == first,
          "the whisper fused streams differ from the per-step streams")
    t1 = time.perf_counter()
    check(serve_with_frames(fused, requests, sc)[0] == first,
          "the warm whisper fused streams differ")
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t1
    n_tok = sum(len(x) for x in first.values())
    say(f"{label} whisper continuous (dense ring, {w['requests']} requests "
        f"of {w['prompt']} + {w['new'] // 2}..{w['new']} tokens, each with "
        f"its own frames, over {w['slots']} slots, {w['burst']} arriving a "
        f"step, step_horizon 1): first {first_s:.3f}s, warm {warm_s:.3f}s "
        f"= {n_tok / warm_s:.1f} tok/s, {steps} steps; streams == the eager "
        f"step body's bit for bit | step_horizon {HORIZON}: streams == the "
        f"per-step streams bit for bit, warm {fused_s:.3f}s = "
        f"{n_tok / fused_s:.1f} tok/s | launches {cont} | decisions: "
        f"{decisions_note()}")
    say_graphs(f"{label} whisper continuous", sched)
    say(f"{label} admissions (the eager encoder over 1500 frames, the "
        f"32-token prefill and the first sample, synced; the warm serve's): "
        f"median {statistics.median(adm):.1f} ms, min {min(adm):.1f}, max "
        f"{max(adm):.1f} over {len(adm)}, {sum(adm) / 1e3:.3f}s in all")
    # the device while the card decodes: every slot admitted (eagerly,
    # outside the window), then WHISPER_WINDOW graphed steps profiled (a
    # whole serve's profile holds ~4e5 kernels and takes a minute to read)
    for rid, prompt, n_new, seed, fr, _ in requests[:w["slots"]]:
        check(sched.admit(rid, prompt, n_new, seed, sc, encoder_frames=fr),
              "admission failed")

    def window():
        for _ in range(WHISPER_WINDOW):
            sched.step()
        return WHISPER_WINDOW

    _, busy_ms, wall_ms, kernels, calls = profiled(window)
    check(sched.n_active == w["slots"], "a request finished in the window")
    while sched.n_active:
        sched.step()
    sched.pop_finished()
    say_profile(f"{label} continuous decode", busy_ms, wall_ms, kernels,
                calls, WHISPER_WINDOW, "decode step",
                f"; {w['slots']} live slots, {WHISPER_WINDOW} graphed steps "
                "after their admissions")
    [key] = [k for k in sched.graphs.keys if k[0] == "step"]
    step_ms = _graph_ms(sched.graphs, key)
    bound, what = _whisper_step_bound(params, sched.cache)
    say(f"{label} graphed continuous decode step ({w['slots']} slots, CUDA "
        f"events around one replay, median of 9): {step_ms:.3f} ms against "
        f"its byte bound {bound:.4f} ms ({what}; {bound / step_ms:.3f} of "
        f"the bound)")
    del sched, fused
    say(f"{label} reference: "
        f"{_prefill_reproduces_forward('whisper-tiny', gen)}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"{label} peak memory {peak:.2f} GB ({label} took "
        f"{time.perf_counter() - t0:.1f}s)")
    return paths


def _int8_server(session, cache_dtype, **kw):
    """``serve.server_for``'s server for the session's continuous flags
    with the K/V cache in ``cache_dtype`` (the launcher has no int8 flag,
    as the JAX launcher has none)."""
    from repro_torch.serving.server import RunaheadServer

    cfg, params, args, sc = session[:4]
    return RunaheadServer(
        cfg, params, n_slots=args.slots,
        context=args.prompt_len + args.new_tokens, spec_k=sc.spec_k,
        rounds=sc.rounds, backend=sc.backend, cache_dtype=cache_dtype, **kw)


def _int8_verify_grid(session, server) -> str:
    """One decode_verify over L = DRAFT_LEN on the int8 ring (4 requests
    admitted) against L serial decode steps on a copy of it, within phase
    15's bf16 tolerance; then the all-rejected rollback, which must put
    every code and scale back bit for bit."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import decode
    from repro_torch.tree import leaves, tree_map

    cfg, params = session.cfg, session.params
    sched = server.scheduler
    check(sched.n_active == 0, "the scheduler still holds requests")
    for r in serve.continuous_requests(cfg, session.args,
                                       session.sampler)[:4]:
        check(sched.admit(r.rid, r.prompt, r.n_new, r.seed, r.sampler),
              "admission failed")
    B, L = 4, DRAFT_LEN
    g = torch.Generator(device="cuda").manual_seed(22)
    feed = torch.cat([sched.token[:, None], torch.randint(
        0, cfg.vocab, (B, L - 1), generator=g, device="cuda")], dim=1)
    pos = sched.pos.clone()
    before = [t.clone() for t in leaves(sched.cache)]
    copy = tree_map(torch.clone, sched.cache)
    grid, _, stash = decode.decode_verify(cfg, params, feed, pos,
                                          sched.cache)
    serial = torch.stack([decode.decode_step(
        cfg, params, feed[:, l], pos + l, copy)[0] for l in range(L)], dim=1)
    scale = serial.abs().amax(dim=-1)
    rel = (grid - serial).abs().amax(dim=-1) / scale           # (B, L)
    check(bool((rel <= VERIFY_REL_TOL).all()),
          f"int8 verify rows differ from serial steps by {rel.tolist()} of "
          f"the row's largest |logit| (tolerance {VERIFY_REL_TOL})")
    decode.rollback_cache_runs(sched.cache, stash, pos,
                               torch.zeros_like(pos))
    check(all(torch.equal(a, b) for a, b in zip(leaves(sched.cache),
                                                before)),
          "the all-rejected rollback did not restore the int8 codes and "
          "scales")
    n_leaves = len(before)
    del copy
    return (f"one decode_verify over L={L} on the int8 ring (4 live "
            f"slots) against {L} serial decode steps: max |dlogit| per row "
            f"/ the row's largest |logit| = "
            f"{[[round(x, 5) for x in row] for row in rel.tolist()]} "
            f"(tolerance {VERIFY_REL_TOL}); the all-rejected rollback "
            f"restores all {n_leaves} leaves (codes and scales) bit for bit")


def _int8_contract(session) -> str:
    """The int8 step at full width against the f32 step: one 4096-token
    prompt prefilled with int8 K/V, with bf16 K/V (both in bf16) and in
    f32 (compute and cache), one decode step each; the int8 step's max
    |diff| from the f32 step within INT8_VS_BF16 times the bf16 step's.
    The int8 step's distance from the bf16 step, the reading JAX's
    contract bounds at reduced size, is reported beside it."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import decode

    cfg, params = session.cfg, session.params
    r = serve.continuous_requests(cfg, session.args, session.sampler)[0]
    prompt = torch.tensor([r.prompt], device="cuda")
    S = prompt.shape[1]
    out = {}
    for name, kv, compute in (("int8", torch.int8, torch.bfloat16),
                              ("bf16", torch.bfloat16, torch.bfloat16),
                              ("f32", torch.float32, torch.float32)):
        _, cache = decode.prefill(cfg, params, prompt, S + 1, kv_dtype=kv,
                                  compute_dtype=compute)
        out[name], _ = decode.decode_step(cfg, params, prompt[:, -1], S,
                                          cache, compute_dtype=compute)
        del cache
    top = out["f32"].abs().max().item()

    def rel(a, b):
        return (out[a] - out[b]).abs().max().item() / top

    int8_err, bf16_err = rel("int8", "f32"), rel("bf16", "f32")
    check(int8_err <= INT8_VS_BF16 * bf16_err,
          f"the int8 step lies {int8_err:.4f} of the largest |logit| from "
          f"the f32 step, more than {INT8_VS_BF16} x the bf16 step's "
          f"{bf16_err:.4f}")
    return (f"one step after a {S}-token prefill, max |diff| / the f32 "
            f"step's largest |logit| ({top:.4g}): int8 {int8_err:.4f} from "
            f"the f32 step, bf16 {bf16_err:.4f} (int8 / bf16 "
            f"{int8_err / bf16_err:.3f}, limit {INT8_VS_BF16}); int8 from "
            f"bf16 {rel('int8', 'bf16'):.4f} (JAX's reduced-size contract "
            f"{INT8_JAX_CONTRACT}: bf16 alone lies {bf16_err:.4f} from f32 "
            f"at this width and depth)")


def phase_int8(gen) -> dict:
    """qwen3-4b at full width with an int8 K/V cache on the dense ring,
    served through launch.serve's continuous runner on a server with
    ``cache_dtype=torch.int8``: 8 requests of 4096-token prompts (K7 in
    each admission); graphed steps against the eager step body, fused
    horizons against per-step serving; a verify grid against serial steps
    and its rollback; the int8 step against the f32 and bf16 steps; the
    graphed int8 step and the
    bf16 step at the same depth, each beside its byte bound; admission
    ms, idle share, peak memory.  Returns {"int8-serve": launches}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    label = "phase 22"
    free_memory()
    session = serve.setup(INT8_CONT_ARGV)
    cfg, params, args = session.cfg, session.params, session.args
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    weights_gb = sum(t.numel() * t.element_size()
                     for t in leaves(params)) / 1e9
    server = _int8_server(session, torch.int8)
    sched = server.scheduler
    check(sched.cache[0]["kv"].quantized, "the ring is not int8")
    ops.reset_launches()
    forget_decisions()
    first = serve.run_continuous(session, server)
    launches = dict(ops.LAUNCHES)
    c = first.counts
    check(len(first.completions) == args.requests,
          "not every int8 request served")
    check(all(0 <= t < cfg.vocab for s in streams(first).values()
              for t in s), f"a token >= {cfg.vocab} was sampled")
    check_solver_launches(
        launches, sampler_solves({args.slots: c["decode_steps"],
                                  1: c["admissions"]}),
        f"{label} int8 serve")
    check(launches["flash_fwd"] == cfg.n_layers * c["admissions"],
          f"K7 launched {launches['flash_fwd']} times for "
          f"{c['admissions']} admissions of {cfg.n_layers} layers")
    warm = serve.run_continuous(session, server)
    check(streams(warm) == streams(first), "warm int8 streams differ")
    eager_server = _int8_server(session, torch.int8)
    eager_server.scheduler.graphs = EagerGraphs()
    adm = timed_admissions(eager_server)
    check(streams(serve.run_continuous(session, eager_server))
          == streams(first),
          "the graphed int8 streams differ from the eager step body's")
    del eager_server
    fused_server = _int8_server(session, torch.int8, step_horizon=HORIZON)
    check(streams(serve.run_continuous(session, fused_server))
          == streams(first),
          "the int8 fused streams differ from the per-step streams")
    del fused_server
    n_tok = sum(len(x.tokens) for x in warm.completions)
    steps = warm.counts["decode_steps"]
    say(f"{label} int8 serve: qwen3-4b full width and depth "
        f"({weights_gb:.2f} GB of bf16 weights drawn in {init_s:.3f}s), "
        f"int8 K/V on the dense ring, {args.requests} requests of "
        f"{args.prompt_len} + 16..32 tokens over {args.slots} slots: first "
        f"{first.seconds:.3f}s, warm {warm.seconds:.3f}s = "
        f"{n_tok / warm.seconds:.1f} tok/s, {steps} steps; streams == the "
        f"eager step body's and the step_horizon {HORIZON} streams bit for "
        f"bit | launches {launches} | decisions: {decisions_note()}")
    say_graphs(f"{label} int8", sched)
    say(f"{label} admissions (a {args.prompt_len}-token prefill through K7, "
        f"its ring quantized, and the first sample, synced; the eager "
        f"serve's): median {statistics.median(adm):.1f} ms, min "
        f"{min(adm):.1f}, max {max(adm):.1f} over {len(adm)}")
    requests = serve.continuous_requests(cfg, args, session.sampler)
    _decode_window(label + " int8", server, requests)
    [key] = [k for k in sched.graphs.keys if k[0] == "step"]
    step_ms = _graph_ms(sched.graphs, key)
    bound, what = _step_bound(params, sched.cache)
    say(f"{label} verify: {_int8_verify_grid(session, server)}")
    del server
    bf16_server = _int8_server(session, torch.bfloat16)
    serve.run_continuous(session, bf16_server)
    bsched = bf16_server.scheduler
    [bkey] = [k for k in bsched.graphs.keys if k[0] == "step"]
    bf16_ms = _graph_ms(bsched.graphs, bkey)
    bf16_bound, bf16_what = _step_bound(params, bsched.cache)
    del bf16_server
    say(f"{label} graphed decode steps at the same depth ({args.slots} slots "
        f"of {args.prompt_len + args.new_tokens} rows, CUDA events around "
        f"one replay, median of 9): int8 {step_ms:.3f} ms against its byte "
        f"bound {bound:.3f} ms ({what}; {bound / step_ms:.3f} of the "
        f"bound); bf16 {bf16_ms:.3f} ms against {bf16_bound:.3f} ms "
        f"({bf16_what}; {bf16_bound / bf16_ms:.3f} of the bound); int8 / "
        f"bf16 {step_ms / bf16_ms:.3f} (the ring is dequantized to bf16 "
        f"whole, in plain PyTorch, each layer of each step)")
    say(f"{label} contract: {_int8_contract(session)}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"{label} peak memory {peak:.2f} GB (weights {weights_gb:.2f} GB) "
        f"({label} took {time.perf_counter() - t0:.1f}s)")
    return {"int8-serve": launches}


# ---------------------------------------------------------------------------
# phases 23-25: the hybrid, SSM and enc-dec families trained
# ---------------------------------------------------------------------------

def _k2_clip_row(gen, norms, decision, note: str) -> dict:
    """K2 at the quantile clip's (1, leaves) shape: the per-leaf norms of
    a training step against the 2**spec_k - 1 candidates a round of the
    clip's decision, counting below, bit for bit against its plain
    version; timed beside its bound."""
    import torch

    from repro_torch.kernels import multi_count as mc
    from repro_torch.kernels import ops

    x = norms[None, :].float()
    M = 2 ** decision.spec_k - 1
    taus = x.amin() + (x.amax() - x.amin()) * torch.rand(
        (1, M), generator=gen, device="cuda")
    got = ops.multi_count(x, taus, below=True)
    want = mc.multi_count_plain(x, taus, True)
    check(torch.equal(got, want),
          f"K2 differs from plain at the clip's shape {tuple(x.shape)}")
    run = lambda: ops.multi_count(x, taus, below=True)  # noqa: E731
    return dict(
        source="src/repro_torch/kernels/csrc/multi_count.cu",
        replaces="src/repro/kernels/multi_count.py:69", max_abs_err=0.0,
        ms=device_ms(run), call_ms=call_ms(run),
        plain_ms=device_ms(lambda: mc.multi_count_plain(x, taus, True)),
        bound=bound_ms(4 * (x.numel() + 2 * M), 2 * x.numel() * M),
        library_ms=None, library="none",
        note=f"the quantile clip's (1, {x.shape[1]}) per-leaf norms of "
             f"{note}, {M} candidates (spec_k {decision.spec_k} x "
             f"{decision.rounds} rounds), counting below")


def _family_train(label: str, run, tokens: int, k7_per_step: int) -> dict:
    """Drives ``run(on_step)``, a training loop of FAMILY_TRAIN_STEPS
    steps that calls ``on_step(step, metrics)`` after each, on launch
    counters at 0 and an empty record of the tuner's decisions, the
    clip's per-leaf norms recorded and the last step profiled (device
    activity).  Checks: every loss finite; per step K7 ``k7_per_step``
    times and K2 once a round of the clip's decision; the clip's bracket
    at the last step's norms equal to the "torch" backend's bit for bit.
    Returns the run's readings."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import solver
    from repro_torch.kernels import ops
    from repro_torch.train import step as train_step

    n = FAMILY_TRAIN_STEPS
    per_step, prof, norms = [], {}, {}

    def on_step(step, metrics):
        per_step.append(dict(ops.LAUNCHES))
        if step == n - 2:
            prof["p"] = profile(activities=[ProfilerActivity.CUDA])
            prof["p"].__enter__()
            prof["t0"] = time.perf_counter()
        elif step == n - 1:
            torch.cuda.synchronize()
            prof["wall_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].__exit__(None, None, None)

    clip = train_step.clip_by_quantile

    def recorded_clip(grads, *a, **kw):
        out = clip(grads, *a, **kw)
        norms["last"] = out[1].detach()
        return out

    train_step.clip_by_quantile = recorded_clip
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    forget_decisions()
    try:
        out = run(on_step)
    finally:
        train_step.clip_by_quantile = clip
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    check(len(losses) == n and all(map(math.isfinite, losses)),
          f"{label}: training losses not all finite: {losses}")
    want = solver_launches({("count_below", 1, False): 1})
    (clip_d, _) = decisions()[("count_below", 1, False)]
    note = decisions_note()
    prev = dict.fromkeys(launches, 0)
    for i, snap in enumerate(per_step):
        moved = {k: snap[k] - prev[k] for k in snap}
        check(moved["flash_fwd"] == k7_per_step,
              f"{label} step {i}: K7 launched {moved['flash_fwd']} times, "
              f"expected {k7_per_step}")
        check({k: moved[k] for k in SOLVER_KERNELS} == want,
              f"{label} step {i}: the quantile clip launched {moved}, where "
              f"the tuner's decision ({decisions_note()}) gives {want}")
        prev = snap
    x = norms["last"].float()[None, :]
    brackets = [solver.solve_kind("count_below", x, q=0.95, backend=b,
                                  rounds=8, spec_k=4)
                for b in ("hopper", "torch")]
    check(all(torch.equal(a, b) for a, b in zip(*brackets)),
          f"{label}: the clip's bracket differs from the torch backend's")
    t_read = time.perf_counter()
    kernels, calls = _profile_records(prof["p"])
    read_s = time.perf_counter() - t_read
    timed = out["step_seconds"][1:n - 1]
    ms = statistics.median(timed) * 1e3
    return dict(
        losses=losses, launches=launches, peak_gb=peak_gb, ms=ms,
        tok_s=tokens / ms * 1e3, warmup_ms=out["step_seconds"][0] * 1e3,
        timed_ms=[round(t * 1e3, 1) for t in timed], k2=want["multi_count"],
        clip=clip_d, decisions=note, norms=norms["last"], kernels=kernels, calls=calls,
        busy_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
        wall_ms=prof["wall_ms"], read_s=read_s)


def say_family_train(label: str, what: str, r: dict,
                     which=(("K2", "multi_count"),)) -> None:
    """A family's training readings, its profiled step and its kernels'
    shares of the device's busy time."""
    say(f"{label}: {what} | losses {[round(x, 4) for x in r['losses']]} | "
        f"warm-up step {r['warmup_ms']:.0f} ms, steps 1-"
        f"{FAMILY_TRAIN_STEPS - 2} {r['timed_ms']} ms, median "
        f"{r['ms']:.1f} ms = {r['tok_s']:.0f} tok/s | peak memory "
        f"{r['peak_gb']:.2f} GB | per step: K2 {r['k2']} (the clip: "
        f"{r['decisions']}); the clip's bracket == the torch backend's "
        f"bit for bit | launches {r['launches']}")
    say_profile(label, r["busy_ms"], r["wall_ms"], r["kernels"], r["calls"],
                1, "step", f"; one step (step {FAMILY_TRAIN_STEPS - 1}), "
                           f"device activity read back in {r['read_s']:.1f}s")
    if r["kernels"]:
        say_kernel_times(label, r["kernels"], r["busy_ms"], which)
        say(f"{label} profile by group: " + ", ".join(
            f"{g} {ms_:.1f} ms ({n_} launches)"
            for g, (ms_, n_) in _kernel_groups(r["kernels"]).items()))


def _loss_and_grads(cfg, params, batch, tc) -> tuple[float, list]:
    """The training loss of ``batch`` and its gradient per leaf, as the
    train step's ``grads_of`` takes them."""
    import torch

    from repro_torch.train import step as train_step
    from repro_torch.tree import leaves, unflatten

    inputs = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = train_step.loss_fn(cfg, unflatten(params, inputs), batch, tc)
    return float(loss.detach()), list(torch.autograd.grad(loss, inputs))


def _grad_rel(got, want) -> tuple[float, int]:
    """The largest over the leaves of |got - want| / |want| in the l2
    norm (f32, on the CPU), and the index of its leaf."""
    import torch

    rels = []
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float().cpu()
        den = max(float(torch.linalg.vector_norm(w)), 1e-30)
        rels.append(float(torch.linalg.vector_norm(g - w)) / den)
    worst = max(range(len(rels)), key=rels.__getitem__)
    return rels[worst], worst


def _card_vs_cpu(cfg, batch: dict) -> str:
    """The loss and per-leaf gradients of ``batch`` on the card against
    the CPU port's on the same weights (f32, drawn on the card from seed
    0) with the forward in f32, checked within CARD_VS_CPU; says how
    close they came."""
    import contextlib
    import functools

    import torch

    from repro_torch.models import transformer
    from repro_torch.models.transformer import init_params
    from repro_torch.train import step as train_step
    from repro_torch.tree import leaves_with_path, tree_map

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32)
    tc = train_step.TrainConfig(param_dtype="float32")
    keep = train_step.forward
    train_step.forward = functools.partial(transformer.forward,
                                           compute_dtype=torch.float32)
    with contextlib.ExitStack() as stack:
        stack.callback(setattr, train_step, "forward", keep)
        card = _loss_and_grads(cfg, params, batch, tc)
        cpu = _loss_and_grads(cfg, tree_map(lambda t: t.cpu(), params),
                              {k: v.cpu() for k, v in batch.items()}, tc)
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    grad_rel, worst = _grad_rel(card[1], cpu[1])
    path = leaves_with_path(params)[worst][0]
    check(loss_rel <= CARD_VS_CPU["loss_rtol"]
          and grad_rel <= CARD_VS_CPU["grad_rel"],
          f"{cfg.name}: the card's loss {card[0]} and gradients (worst leaf "
          f"{path} at {grad_rel:.3g}) differ from the CPU port's "
          f"({cpu[0]}) past {CARD_VS_CPU}")
    return (f"the card's loss within {loss_rel:.3g} of the CPU port's, the "
            f"worst of {len(cpu[1])} gradients ({path}) at l2 rel "
            f"{grad_rel:.3g} (limits {CARD_VS_CPU})")


def hymba_train_depth(cfg, batch: int, seq: int,
                      most: int) -> tuple[int, dict]:
    """The deepest cut of hymba's ``cfg`` (widths unchanged), ``most``
    layers at most, whose reckoned peak fits MOE_TRAIN_BUDGET bytes, and
    the reckoning at full depth and at the cut: 18 B a parameter (bf16 params and gradients,
    f32 master, mu and nu, the clip's bf16 copy of the gradients), 16 B
    an element of the largest leaf (a run's stacked MLP weight: AdamW's
    and the clip's f32 temporaries), the f32 logits three times over,
    remat's saved layer inputs, and one layer's recompute: the SSM's
    chunked scan keeps, for every chunk of the sequence, its decay and
    increment, the log2(CHUNK) levels of the Hillis-Steele scan's pair
    and about 4 more (B, CHUNK, d_in, N) f32 tensors, beside the bf16
    activations of the attention and the MLP."""
    import dataclasses

    from repro_torch.models import ssm
    from repro_torch.models.transformer import layer_plan

    d, f = cfg.d_model, cfg.d_ff
    d_in = cfg.n_heads * cfg.head_dim
    tokens = batch * seq
    levels = math.ceil(math.log2(ssm.CHUNK))

    def need(L: int) -> dict:
        c = dataclasses.replace(cfg, n_layers=L)
        P = c.param_count()
        parts = {
            "params": P,
            "state": 18 * P,
            "largest leaf": 16 * max(n for _, n in layer_plan(c)) * d * f,
            "logits": 12 * tokens * cfg.vocab_padded,
            "remat inputs": 2 * L * tokens * d,
            "layer recompute": (4 * (2 * (levels + 1) + 4) * tokens * d_in
                                * cfg.ssm_state
                                + 2 * tokens * (3 * f + 6 * d_in + 4 * d)),
        }
        parts["total"] = sum(v for k, v in parts.items() if k != "params")
        return parts

    L = min(cfg.n_layers, most)
    while L > 1 and need(L)["total"] > MOE_TRAIN_BUDGET:
        L -= 1
    return L, {"full": need(cfg.n_layers), "cut": need(L)}


def _hymba_k7_reference() -> str:
    """hymba at full width cut to layers 0-2 (one global, two
    sliding-window), f32 params, batch 1 x 4096, the forward in bf16 as
    trained: the loss and per-leaf gradients with K7 (twice a layer:
    forward and remat recompute) against those with its plain version
    swapped in for that run only, within HYMBA_REF's tolerances."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels import flash_fwd as ff
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params, layer_plan
    from repro_torch.train import step as train_step
    from repro_torch.tree import leaves_with_path

    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              n_layers=HYMBA_REF["layers"])
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         torch.float32)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=HYMBA_REF["seq"],
                           global_batch=HYMBA_REF["batch"], seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch_at(0).items()}
    tc = train_step.TrainConfig(param_dtype="float32")
    ops.reset_launches()
    loss_k, grads_k = _loss_and_grads(cfg, params, batch, tc)
    k7 = ops.LAUNCHES["flash_fwd"]
    check(k7 == 2 * cfg.n_layers,
          f"the reference's step launched K7 {k7} times")
    kernel = ff.flash_fwd_cuda
    ff.flash_fwd_cuda = (lambda q, k, v, *, window=0, n_rep=1:
                         ff.flash_fwd_plain(q, k, v, window=window,
                                            n_rep=n_rep))
    try:
        loss_p, grads_p = _loss_and_grads(cfg, params, batch, tc)
    finally:
        ff.flash_fwd_cuda = kernel
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel, worst = _grad_rel(grads_k, grads_p)
    path = leaves_with_path(params)[worst][0]
    check(loss_rel <= HYMBA_REF["loss_rtol"]
          and grad_rel <= HYMBA_REF["grad_rel"],
          f"hymba's loss and gradients with K7 ({loss_k}, worst leaf {path} "
          f"at {grad_rel:.3g}) differ from its plain version's ({loss_p}) "
          f"past {HYMBA_REF}")
    return (f"full width, depth cut to layers 0-2 ({layer_plan(cfg)}), f32 "
            f"params, batch {HYMBA_REF['batch']} x {HYMBA_REF['seq']}: loss "
            f"with K7 ({k7} launches) {loss_k:.6f} against {loss_p:.6f} with "
            f"its plain version (rel {loss_rel:.3g}, limit "
            f"{HYMBA_REF['loss_rtol']}); worst of {len(grads_k)} gradients "
            f"({path}) at l2 rel {grad_rel:.3g} (limit "
            f"{HYMBA_REF['grad_rel']})")


def phase_hymba_train(gen) -> tuple[dict, dict]:
    """launch.train's main in-process for hymba-1.5b at its published
    width, phase 11's batch 2 x 4096, the quantile clip, its depth cut to
    HYMBA_TRAIN_LAYERS (further if the byte reckoning forces it): losses,
    K7 twice a layer a
    step (banded on the sliding-window layers), K2 as the clip's
    decision gives, ms a step, tok/s, peak memory, the last step
    profiled; K2 at the clip's shape; the K7 reference.  Returns
    (launches, {kernel: row})."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models.transformer import layer_plan

    t0 = time.perf_counter()
    label = "phase 23"
    cfg = get_config("hymba-1.5b")
    batch, seq = 2, 4096
    L, reckoned = hymba_train_depth(cfg, batch, seq, HYMBA_TRAIN_LAYERS)
    gb = lambda parts: ", ".join(  # noqa: E731
        f"{k} {v / 1e9:.2f} G" + ("" if k == "params" else "B")
        for k, v in parts.items())
    say(f"{label} depth reckoning (budget {MOE_TRAIN_BUDGET / 1e9:.0f} GB "
        f"of the card's 80; the run's time limit allows "
        f"{HYMBA_TRAIN_LAYERS} layers): full depth {cfg.n_layers} layers: "
        f"{gb(reckoned['full'])} | cut to {L} layers: {gb(reckoned['cut'])}")
    argv = HYMBA_TRAIN_ARGV + (["--layers", str(L)] if L < cfg.n_layers
                               else [])
    r = _family_train(label, lambda on_step: train.main(argv,
                                                        on_step=on_step),
                      batch * seq, 2 * L)
    plan = layer_plan(dataclasses.replace(cfg, n_layers=L))
    say_family_train(
        label, f"hymba-1.5b full width (d_model 1600, 25/5 heads of 64, SSM "
               f"state 16, d_ff 5504, vocab 32001 padded to 32128), depth "
               f"{L} of {cfg.n_layers} ({plan}), batch {batch} x {seq}, "
               f"remat, quantile clip, AdamW; K7 {2 * L} a step (forward and "
               f"remat recompute; banded (window {cfg.sliding_window}) but "
               f"on the global layers {cfg.global_layers}); peak reckoned "
               f"{reckoned['cut']['total'] / 1e9:.2f} GB", r,
        (("K7", "flash_fwd_"), ("K2", "multi_count")))
    k2 = _k2_clip_row(gen, r["norms"], r["clip"],
                      f"this run's last step (hymba-1.5b, {L} layers)")
    say_row(f"{label} K2 hymba-train", k2)
    say(f"{label} reference: {_hymba_k7_reference()}")
    say(f"{label} took {time.perf_counter() - t0:.1f}s")
    return r["launches"], {"multi_count": k2}


def phase_xlstm_train(gen) -> tuple[dict, dict]:
    """launch.train's main in-process for xlstm-1.3b at its published
    width and depth, batch 2 x 1024 (the sequence cut), the quantile
    clip: losses, no K7 (no attention), K2 as the clip's decision gives,
    ms a step, tok/s, peak memory, the last step profiled; K2 at the
    clip's shape; the card against the CPU port at phase 19's reference
    depth.  Returns (launches, {kernel: row})."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.models.transformer import layer_plan

    t0 = time.perf_counter()
    label = "phase 24"
    r = _family_train(label, lambda on_step: train.main(
        XLSTM_TRAIN_ARGV, on_step=on_step), 2 * 1024, 0)
    full = get_config("xlstm-1.3b")
    cut = dataclasses.replace(full, n_layers=XLSTM_TRAIN_LAYERS)
    say_family_train(
        label, f"xlstm-1.3b full width (d_model 2048, 4 heads of 512, vocab "
               f"50304), depth {XLSTM_TRAIN_LAYERS} of {full.n_layers} "
               f"({layer_plan(cut)}; the run's time limit), batch 2 x 1024 "
               f"(a sequence cut from train_4k's 4096: the sLSTM's loop over "
               f"time), remat, quantile clip, AdamW; no attention, no K7", r)
    k2 = _k2_clip_row(gen, r["norms"], r["clip"],
                      "this run's last step (xlstm-1.3b)")
    say_row(f"{label} K2 xlstm-train", k2)
    cfg = dataclasses.replace(get_config("xlstm-1.3b"),
                              n_layers=XLSTM_REF["layers"])
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=XLSTM_REF["seq"],
                           global_batch=XLSTM_REF["batch"], seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch_at(0).items()}
    say(f"{label} reference: f32, depth cut to {cfg.n_layers} layers "
        f"({layer_plan(cfg)}), batch {XLSTM_REF['batch']} x "
        f"{XLSTM_REF['seq']}: {_card_vs_cpu(cfg, batch)}")
    say(f"{label} took {time.perf_counter() - t0:.1f}s")
    return r["launches"], {"multi_count": k2}


def _whisper_train_loop(on_step, cfg, batch: int, seq: int,
                        microbatches: int) -> dict:
    """whisper-tiny trained as launch.train's main trains a decoder-only
    arch (its TrainConfig and schedule for FAMILY_TRAIN_STEPS steps,
    SyntheticTokens from seed 0, random bf16 weights from seed 0), each
    batch with (batch, encoder_len, d_model) bf16 frames drawn from the
    weights' generator: {losses, step_seconds}."""
    import torch

    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.train.step import TrainConfig, make_train_step

    n = FAMILY_TRAIN_STEPS
    tc = TrainConfig(lr=3e-4, warmup_steps=min(100, n // 10 + 1),
                     total_steps=n, n_microbatches=microbatches,
                     clip_mode="quantile")
    step_fn = make_train_step(cfg, tc, linear_warmup_cosine(
        tc.lr, tc.warmup_steps, tc.total_steps))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, getattr(torch, tc.param_dtype))
    opt = adamw_init(params)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                           seed=0)
    losses, seconds = [], []
    for step in range(n):
        b = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch_at(step).items()}
        b["frames"] = torch.randn((batch, cfg.encoder_len, cfg.d_model),
                                  generator=gen, device="cuda",
                                  dtype=torch.bfloat16)
        t = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        on_step(step, metrics)
    return {"losses": losses, "step_seconds": seconds}


def phase_whisper_train(gen) -> tuple[dict, dict]:
    """whisper-tiny trained at full width and depth through
    train.step.make_train_step: 16 x 448 decoder tokens with (16, 1500,
    384) bf16 frames, two microbatches (the frames split with the
    tokens), the quantile clip: losses, no K7 (448 and 1500 lie under
    FLASH_MIN_SEQ), K2 as the clip's decision gives, ms a step, tok/s,
    peak memory, the last step profiled; K2 at the clip's shape; the card
    against the CPU port at batch 2.  Returns (launches, {kernel:
    row})."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens

    t0 = time.perf_counter()
    label = "phase 25"
    cfg = get_config("whisper-tiny")
    wt = WHISPER_TRAIN
    r = _family_train(label, lambda on_step: _whisper_train_loop(
        on_step, cfg, wt["batch"], wt["seq"], wt["microbatches"]),
        wt["batch"] * wt["seq"], 0)
    say_family_train(
        label, f"whisper-tiny full width and depth (4 encoder + 4 decoder "
               f"layers, d_model 384, 6 heads of 64, vocab 51865 padded to "
               f"51968, no cut) through train.step.make_train_step (the "
               f"launcher refuses enc-dec, as JAX's), batch {wt['batch']} x "
               f"{wt['seq']} decoder tokens with ({wt['batch']}, "
               f"{cfg.encoder_len}, {cfg.d_model}) bf16 frames, "
               f"{wt['microbatches']} microbatches, remat, quantile clip, "
               f"AdamW; no K7", r)
    k2 = _k2_clip_row(gen, r["norms"], r["clip"],
                      "this run's last step (whisper-tiny)")
    say_row(f"{label} K2 whisper-train", k2)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=WHISPER_REF["seq"],
                           global_batch=WHISPER_REF["batch"], seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch_at(0).items()}
    batch["frames"] = torch.randn(
        (WHISPER_REF["batch"], cfg.encoder_len, cfg.d_model), generator=gen,
        device="cuda")
    say(f"{label} reference: f32, full depth, batch {WHISPER_REF['batch']} "
        f"x {WHISPER_REF['seq']} with frames: {_card_vs_cpu(cfg, batch)}")
    say(f"{label} took {time.perf_counter() - t0:.1f}s")
    return r["launches"], {"multi_count": k2}


# ---------------------------------------------------------------------------
# phases 26-27: the mesh, SPMD over torch.distributed ranks sharing the card
# ---------------------------------------------------------------------------

# phase 26: the Fig. 6 chip-level runahead; N = 6 steps at k = 2 over the
# term counts, then k = 3 and 4 at 1000 terms; payloads (bytes) of the
# join term's readings
MESH_N = 6
MESH_TERMS = (10, 100, 1000, 5000)
MESH_CASES = tuple((t, 2) for t in MESH_TERMS) + ((1000, 3), (1000, 4))
MESH_REPS = 9
JOIN_PAYLOADS = (4, 256, 16384, 1 << 20)
# phase 27: the meshes of four ranks on the one card, and the serves each
# runs: (mesh, paged, step horizon), phase 9's traffic
MESH_SPECS = ("2x2", "4x1", "1x4")
MESH_SERVES = tuple((m, True, 1) for m in MESH_SPECS) + (
    ("2x2", False, 1), ("2x2", True, HORIZON), ("2x2", False, HORIZON))


# phase 27's screened workload: the prompt length, each request's new
# tokens (greedy and top-k 40 in turn, two arriving a step), its context,
# and the serves, in f32 under tuning.disabled(): (mesh, paged)
SCREENED_S = 16
SCREENED_NEW = (6, 4, 8, 5, 7, 3, 6, 4)
SCREENED_CONTEXT = 32
SCREENED_SERVES = (("2x2", True), ("2x2", False), ("4x1", True))

# phase 28: data-parallel training on two ranks sharing the card, each
# drawing the global batch and keeping its row; every model at its
# published width, its depth cut only as far as the reckoning of one
# rank's share against MESH_TRAIN_BUDGET bytes forces (two ranks and this
# process share the card's 80 GB)
MESH_TRAIN_RANKS = 2
MESH_TRAIN_STEPS = 3            # step 0 warms up, the last is profiled
MESH_TRAIN_BUDGET = 30e9
MESH_TRAIN_ARGV = ["--steps", str(MESH_TRAIN_STEPS), "--batch", "2",
                   "--seq", "4096", "--clip-mode", "quantile", "--log-every",
                   "1", "--seed", "0"]
MESH_TRAIN_MODELS = (("internlm2-1.8b", []),
                     ("granite-moe-3b-a800m", ["--capacity-mode", "bisect"]))
# the meshed f32 step against the single-rank step: 2 layers at full
# width, the same global batch, one step at a constant lr
# (the CPU tests' tolerances: loss rtol 1e-5, the change 1e-3).  The
# card's f32 forward over one row a rank rounds apart from one over both
# rows (cuBLAS picks its kernels by shape), so the gathered gates are not
# bit-equal to the single-rank step's: the expert ids must be equal and
# the gates within gate_atol; FIFO's keeps, which read only the ids, are
# equal bit for bit.  Under bisect a keep flips where a gate rounds across
# its expert's threshold tau: each cut is held alone (the meshed step's
# own gathered operands through ``models/moe.py::_cut`` again, at the
# whole batch's capacity: its keep mask bit for bit), every flip against
# the single-rank step must lie within gate_atol of its expert's tau, and
# at most ``flips`` of them (8 were read over the 4 cuts, PR 26); one
# flipped assignment moves AdamW's first, sign-like update of its
# expert's weights, so bisect's params' change is held at
# ``bisect_delta_rel`` (0.00986 read with those 8 flips; FIFO, no flips,
# 2.1e-4).
MESH_F32 = dict(layers=2, batch=2, seq=4096, lr=1e-3, loss_rtol=1e-5,
                delta_rel=1e-3, gate_atol=1e-5, flips=32,
                bisect_delta_rel=3e-2)
MESH_F32_CASES = (("internlm2-1.8b", "fifo"),
                  ("granite-moe-3b-a800m", "fifo"),
                  ("granite-moe-3b-a800m", "bisect"))
# kill and resume across world sizes: killed on 2 ranks, resumed on one
MESH_KILL_ARGV = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "4",
                  "--batch", "2", "--seq", "64", "--clip-mode", "quantile",
                  "--lr", "3e-3", "--log-every", "1", "--seed", "0"]
# bf16, one row a rank against two: 2.17e-05 read (PR 26); a resume whose
# AdamW moments were lost (the control: a copy of the checkpoint with mu
# and nu zeroed) must miss it
MESH_RESUME_RTOL = 2e-4


def _mesh_argv(base: list[str], paged: bool, horizon: int) -> list[str]:
    """``base`` (phase 9's flags), on the dense ring where not ``paged``,
    at ``horizon``."""
    argv = list(base)
    if not paged:
        i = argv.index("--page-size")
        del argv[i:i + 4]                  # --page-size 16 --page-impl hopper
    return argv + ["--step-horizon", str(horizon)]


def _rank_runahead(cases, n: int, reps: int, payloads, cache: str) -> dict:
    """One rank of phase 26 (every rank of a 1 x world mesh): each case's
    chip-level root, its K1 launches a solve, its host ms (the median of
    ``reps``, a device sync at both ends) and the host ms of its joins;
    then the join term at each payload and the Fig. 6 join itself (an
    all-gather of one chunk of values)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import find_root_runahead_sharded, find_root_serial
    from repro_torch.core import tuning
    from repro_torch.kernels import ops
    from repro_torch.launch import paper
    from repro_torch.launch.mesh import Mesh

    tuning.set_cache_path(cache)
    mesh = Mesh((1, dist.get_world_size()), ("data", "model"))
    dev = mesh.device
    a, b = paper.interval(dev)
    rows = []
    for terms, k in cases:
        f = paper.evaluator(terms)
        serial = find_root_serial(f, a, b, n, "signbit")
        solve = lambda: find_root_runahead_sharded(f, a, b, n, k, mesh)
        solve()
        ops.reset_launches()
        root = solve()
        launches = dict(ops.LAUNCHES)
        mesh.stats.reset()
        host_ms, _, again = paper._timed(solve, dev, reps)
        rows.append(dict(
            terms=terms, k=k, root=root.item(), again=again.item(),
            serial=serial.item(), launches=launches, ms=host_ms,
            join_ms=mesh.stats.seconds / (reps + 1) * 1e3,
            joins=mesh.stats.count / (reps + 1)))
    joins = {p: tuning.join_term_measured(mesh, "model", p)["seconds"]
             for p in payloads}
    chunk = torch.zeros(-(-3 // mesh.axis_size("model")), device=dev)
    gather_ms = tuning.time_eager(lambda: mesh.all_gather(chunk, "model"),
                                  dev, reps) * 1e3
    # the same all-reduce of 4 B on a host tensor: gloo's transport alone
    host = torch.zeros(1)
    host_ms = tuning.time_eager(lambda: mesh.all_reduce(host, "model"),
                                host.device, reps) * 1e3
    return dict(rows=rows, joins=joins, gather_ms=gather_ms, host_ms=host_ms,
                device=(torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"))


def phase_mesh_runahead() -> dict:
    """Phase 26: find_root_runahead_sharded over 2 and 4 ranks sharing
    the card (gloo over CUDA tensors), K1 on each rank's chunk of the
    2**k - 1 points: every root equal to this process's single-device
    serial root, K1 launched 1 + ceil(N/k) times a solve on each rank;
    ms per solve beside the serial solve's and the lane-level runahead's
    (graphed, single device) and their ratio (Fig. 6's crossover); the
    join term at each payload, fitted to alpha * log2(ranks) + bytes /
    bandwidth.  Returns the K1 launches of one solve of each case, summed
    over the ranks of both worlds."""
    import numpy as np
    import torch

    from repro_torch.core import find_root_runahead, find_root_serial, tuning
    from repro_torch.launch import paper
    from repro_torch.launch.mesh import spawn_local

    free_memory()
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    a, b = paper.interval(dev)
    single = {}
    for terms, k in MESH_CASES:
        f = paper.evaluator(terms)
        s_ms, _, s_root = paper._timed(
            lambda: find_root_serial(f, a, b, MESH_N, "signbit"), dev,
            MESH_REPS)
        r_ms, _, r_root = paper._timed(
            lambda: find_root_runahead(f, a, b, MESH_N, k), dev, MESH_REPS)
        check(torch.equal(s_root, r_root), f"lane-level root differs at "
                                           f"{(terms, k)}")
        single[(terms, k)] = (s_ms, r_ms, s_root.item())
    launches = 0
    alphas, slopes = [], []
    for world in (2, 4):
        outs = spawn_local(_rank_runahead, world, device="cuda",
                           args=(MESH_CASES, MESH_N, MESH_REPS,
                                 JOIN_PAYLOADS, tuning.cache_path()))
        say(f"phase 26 chip-level runahead, {world} ranks on "
            f"{outs[0]['device']} (gloo over CUDA tensors, one card), N = "
            f"{MESH_N}: terms, k, rounds, K1 launches a solve a rank, "
            f"sharded ms (slowest rank), of it in joins, serial ms and "
            f"lane-level runahead ms (one process, graphed), serial / "
            f"sharded, lane-level / sharded")
        for i, (terms, k) in enumerate(MESH_CASES):
            s_ms, r_ms, s_root = single[(terms, k)]
            rounds = -(-MESH_N // k)
            for rank, out in enumerate(outs):
                r = out["rows"][i]
                check(r["root"] == s_root and r["again"] == s_root
                      and r["serial"] == s_root,
                      f"rank {rank} of {world}: chip-level root "
                      f"{r['root']!r} differs from the serial root "
                      f"{s_root!r} at terms {terms}, k {k}")
                check(r["launches"]["taylor_sincos_eval"] == 1 + rounds
                      and sum(r["launches"].values()) == 1 + rounds,
                      f"rank {rank}: a solve launched {r['launches']}, not "
                      f"K1 {1 + rounds} times")
                launches += r["launches"]["taylor_sincos_eval"]
            slow = max(outs, key=lambda out: out["rows"][i]["ms"])
            ms, join_ms = slow["rows"][i]["ms"], slow["rows"][i]["join_ms"]
            say(f"  {terms:5d} {k} {rounds} {1 + rounds} {ms:9.4f} "
                f"{join_ms:8.4f} ({outs[0]['rows'][i]['joins']:.0f} joins) "
                f"{s_ms:8.4f} {r_ms:8.4f} {s_ms / ms:6.3f}x "
                f"{r_ms / ms:6.3f}x")
        joins = {p: max(out["joins"][p] for out in outs)
                 for p in JOIN_PAYLOADS}
        lo, hi = min(JOIN_PAYLOADS), max(JOIN_PAYLOADS)
        alphas.append(joins[lo] / np.log2(world))
        slopes.append((joins[hi] - joins[lo]) / (hi - lo))
        say(f"phase 26 join term, {world} ranks (gloo over CUDA tensors, "
            f"one card; an f32 all-reduce, the median of 9, slowest rank): "
            + ", ".join(f"{p} B {sec * 1e3:.4f} ms"
                        for p, sec in joins.items())
            + f" | the Fig. 6 join (all-gather of one chunk) "
              f"{max(out['gather_ms'] for out in outs):.4f} ms | 4 B on "
              f"host tensors (gloo's transport alone) "
              f"{max(out['host_ms'] for out in outs):.4f} ms")
    # alpha * log2(ranks) from the smallest payload, bytes / link_bw from
    # the slope to the largest; the median over the worlds (a joint least-
    # squares fit goes negative on the readings' spread)
    alpha = float(np.median(alphas))
    link_bw = 1.0 / max(float(np.median(slopes)), 1e-12)
    say(f"phase 26 join fit (gloo over CUDA tensors on one card, NCCL "
        f"across GPUs not measured): join_alpha {alpha * 1e6:.2f} us per "
        f"log2(ranks), link_bw {link_bw:.4g} B/s "
        f"({time.perf_counter() - t0:.1f}s)")
    return {"taylor_sincos_eval": launches}


def _rank_serve(base: list[str], plan, cache: str) -> list:
    """One rank of phase 27: qwen3-4b's weights drawn from the seed on
    this rank (its checksum held against every rank's), then each serve
    of ``plan`` (mesh, paged, horizon, mode) with phase 9's traffic:
    streams, counters, launches held against the tuner's decisions (K2,
    K4 and K5 on the local shards, K3 where the rows are whole, K6 36
    times a decode step on the paged pool), joins.  Rank 0's serve of
    the first mesh is also timed per step."""
    import contextlib

    import torch
    import torch.distributed as dist

    from repro_torch.core import tuning
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import parse_mesh

    rank = dist.get_rank()
    tuning.set_cache_path(cache)
    session = serve.setup(base)
    torch.cuda.empty_cache()           # the weights' draw leaves blocks
    meshes = {}
    out = []
    for spec, paged, horizon, mode in plan:
        if spec not in meshes:
            meshes[spec] = parse_mesh(spec)
            serve.check_same_weights(meshes[spec], session.params)
        mesh = meshes[spec]
        s = session._replace(mesh=mesh, args=serve.parse_args(
            _mesh_argv(base, paged, horizon)))
        server = serve.server_for(s)
        serve.sync(session.device)
        ops.reset_launches()
        forget_decisions()
        mesh.stats.reset()
        ctx = tuning.disabled() if mode == "fixed" else (
            contextlib.nullcontext())
        with ctx:
            served = serve.run_continuous(s, server)
        launches = dict(ops.LAUNCHES)
        sched, c = served.scheduler, served.counts
        steps = c["decode_steps"]
        want = solver_launches(sampler_solves(
            {PATH_B: steps, 1: sched.n_prefills}))
        got = {name: launches[name] for name in SOLVER_KERNELS}
        on_card = session.device.type == "cuda"  # the CPU runs plain ones
        check(got == want or not on_card,
              f"rank {rank} {spec} paged={paged} h={horizon} {mode}: K2-K5 "
              f"launches {got}, where the decisions ({decisions_note()}) "
              f"give {want}")
        if paged and on_card:
            check(launches["paged_attend"] == session.cfg.n_layers * steps,
                  f"rank {rank}: K6 launched {launches['paged_attend']} "
                  f"times for {steps} steps")
        out.append(dict(
            spec=spec, paged=paged, horizon=horizon, mode=mode,
            streams=streams(served), seconds=served.seconds, steps=steps,
            tokens=sum(len(x.tokens) for x in served.completions),
            prefills=sched.n_prefills, local=sched.n_local,
            launches=launches, join_s=mesh.stats.seconds,
            joins=mesh.stats.count,
            decisions=sorted({f"{k.split('|')[0]} B={k.split('|')[1][2:]}: "
                              f"{d.placement} k{d.spec_k}x{d.rounds}"
                              for k, d in tuning.explain()})))
    return dict(plan=out, screened=_rank_screened(session, meshes))


def _rows_witness(cfg, params, prompts) -> dict:
    """One prefill and one decode step of ``prompts``' first 4 rows
    against the same forward over their first 2 and 1 rows (the rows of
    a 2x2 and a 4x1 mesh's data group), in bf16 (phase 9's serve) and in
    f32: for each dtype and row count, the largest |diff| of a shared
    row over that row's largest |logit|, and the rows whose greedy token
    differs."""
    import torch

    from repro_torch.models.decode import decode_step, prefill

    tokens = torch.tensor(prompts[:4], device="cuda")
    S = tokens.shape[1]
    out = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        full = None
        for n in (4, 2, 1):
            lg0, cache = prefill(cfg, params, tokens[:n], S + 1,
                                 compute_dtype=dt)
            nxt = (lg0 if full is None else full[0][:n]).argmax(-1)
            lg1, _ = decode_step(cfg, params, nxt, S, cache,
                                 compute_dtype=dt)
            if full is None:
                full = (lg0, lg1)
                continue
            rel, flips = 0.0, 0
            for got, want in zip((lg0, lg1), full):
                want = want[:n]
                rel = max(rel, ((got - want).abs().amax(-1)
                                / want.abs().amax(-1)).max().item())
                flips += int((got.argmax(-1) != want.argmax(-1)).sum())
            out[(name, n)] = (rel, flips)
    return out


def _rank_screened(session, meshes: dict) -> dict:
    """Phase 27's screened serves on one rank: eight requests (greedy
    and top-k 40 in turn) on prompts whose greedy f32 streams keep a
    top-1 / top-2 gap above 1e-2 (``_screened_prompts``, drawn on rank 0
    and broadcast), served in f32 (forward and cache) under
    ``tuning.disabled()`` (vocab-sharded solves under 2x2, "data" under
    4x1) by each mesh of ``SCREENED_SERVES``.  Rank 0 also serves them
    on its own, paged and dense (the reference), and reads
    ``_rows_witness``."""
    import dataclasses

    import torch

    from repro_torch.core import tuning
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.server import Request, RunaheadServer

    cfg, params = session.cfg, session.params
    world = meshes[SCREENED_SERVES[0][0]]
    prompts = None
    if world.rank == 0:
        g = torch.Generator(device=session.device).manual_seed(27)
        prompts = _screened_prompts(cfg, params, len(SCREENED_NEW),
                                    SCREENED_S, max(SCREENED_NEW), g)
    prompts = world.broadcast_object(prompts, world.axis_names, 0)
    reqs = [Request(i, p, n, seed=i, arrival=i // 2,
                    sampler=SamplerConfig(backend="hopper",
                                          greedy=i % 2 == 0, top_k=40))
            for i, (p, n) in enumerate(zip(prompts, SCREENED_NEW))]

    def serve(mesh, paged: bool) -> dict:
        pages = dict(page_size=16, page_impl="hopper") if paged else {}
        srv = RunaheadServer(cfg, params, n_slots=4,
                             context=SCREENED_CONTEXT, mesh=mesh,
                             backend="hopper", cache_dtype=torch.float32,
                             compute_dtype=torch.float32, **pages)
        with tuning.disabled():
            done = srv.run([dataclasses.replace(r) for r in reqs])
        return {c.rid: c.tokens for c in done}

    out = {"meshed": {(spec, paged): serve(meshes[spec], paged)
                      for spec, paged in SCREENED_SERVES}}
    if world.rank == 0:
        out["single"] = {paged: serve(None, paged) for paged in (True, False)}
        out["witness"] = _rows_witness(cfg, params, prompts)
    return out


def phase_mesh_serve(per_step_streams: dict, single_tok_s: float) -> dict:
    """Phase 27: phase 9's serve of qwen3-4b at full width and depth on
    four ranks sharing the card (about 8 GB of bf16 weights each): paged
    (K6) under the 2x2, 4x1 and 1x4 meshes, and 2x2 on the dense ring and
    at horizon 4.  The vocab meshes' serves run the tuner's fixed
    decisions (vocab-sharded solves: K2, K4, K5 on the local shards), 4x1
    its "data" placement (K3 on each rank's one row); one more 2x2 serve
    in the default mode.  The streams: 1x4 paged == phase 9's (the same
    rows in each forward); horizon 4 == per step; the others counted
    against phase 9's (a forward over 2 or 1 rows rounds apart from one
    over 4 in bf16; ``_rank_screened`` holds the data splits in f32 on
    screened prompts).  tok/s beside phase 9's warm figure, and the share
    of the serve spent in joins.  Returns the launches of the drive,
    summed over ranks."""
    import torch

    from repro_torch.core import tuning
    from repro_torch.launch.mesh import spawn_local

    free_memory()
    say(f"phase 27: this process holds "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB of the card before "
        f"the ranks start")
    t0 = time.perf_counter()
    plan = [(spec, paged, horizon, "fixed")
            for spec, paged, horizon in MESH_SERVES]
    plan.append(("2x2", True, 1, "default"))
    outs = spawn_local(_rank_serve, 4, device="cuda",
                       args=(CONT_ARGV, plan, tuning.cache_path()))
    launches = {}
    for out in outs:
        for r in out["plan"]:
            for name, n in r["launches"].items():
                launches[name] = launches.get(name, 0) + n
    by = {}
    for i, (spec, paged, horizon, mode) in enumerate(plan):
        rs = [out["plan"][i] for out in outs]
        for r in rs[1:]:
            check(r["streams"] == rs[0]["streams"],
                  f"{spec}: the ranks' streams differ")
        r = rs[0]
        by[(spec, paged, horizon, mode)] = r
        same = sum(r["streams"][rid] == toks
                   for rid, toks in per_step_streams.items())
        wall = max(x["seconds"] for x in rs)
        share = max(x["join_s"] for x in rs) / wall
        say(f"phase 27 mesh {spec} {'paged' if paged else 'dense'} "
            f"h={horizon} [{mode}]: {r['tokens']} tokens in {wall:.3f}s = "
            f"{r['tokens'] / wall:.1f} tok/s (phase 9 single rank, graphed "
            f"warm: {single_tok_s:.1f}) | {r['steps']} steps, "
            f"{wall / r['steps'] * 1e3:.1f} ms a step, joins "
            f"{share:.3f} of the serve ({max(x['joins'] for x in rs)} "
            f"collectives a rank) | {r['local']} slots a rank, prefills "
            f"by rank {[x['prefills'] for x in rs]} | streams equal to phase "
            f"9's: {same} of {len(per_step_streams)} | decisions: "
            f"{'; '.join(r['decisions'])}")
    check(by[("1x4", True, 1, "fixed")]["streams"] == per_step_streams,
          "the 1x4 mesh's paged streams differ from phase 9's")
    for spec, paged, horizon, mode in plan:
        if horizon > 1:
            check(by[(spec, paged, horizon, mode)]["streams"]
                  == by[(spec, paged, 1, mode)]["streams"],
                  f"{spec} paged={paged}: horizon {horizon} streams differ "
                  f"from per-step")
    check(by[("4x1", True, 1, "fixed")]["launches"][
        "runahead_topk_threshold"] > 0, "K3 did not run under 4x1's data "
                                        "placement")
    screened = outs[0]["screened"]
    for spec, paged in SCREENED_SERVES:
        got = screened["meshed"][(spec, paged)]
        for rank, out in enumerate(outs):
            check(out["screened"]["meshed"][(spec, paged)] == got,
                  f"screened {spec}: rank {rank}'s streams differ")
        check(got == screened["single"][paged],
              f"screened f32 serve under {spec} "
              f"{'paged' if paged else 'dense'}: streams {got} differ from "
              f"the single-rank serve's {screened['single'][paged]}")
    n_tok = sum(len(t) for t in screened["single"][True].values())
    say(f"phase 27 screened: {len(SCREENED_NEW)} requests (greedy and "
        f"top-k 40 in turn, {n_tok} tokens) on prompts screened for a "
        f"top-1/top-2 gap > 1e-2, f32 forward and cache, "
        f"tuning.disabled(): streams under "
        f"{', '.join(f'{m} ' + ('paged' if p else 'dense') for m, p in SCREENED_SERVES)}"
        f" == the single-rank serve's, on every rank")
    w = screened["witness"]
    say("phase 27 row-count witness (qwen3-4b full width, one prefill + "
        "one decode step of 4 rows vs the same forward over the first 2 "
        "and 1 rows; max |diff| / the row's max |logit|, greedy flips): "
        + "; ".join(f"{dt} {n} rows {w[(dt, n)][0]:.3g} "
                    f"({w[(dt, n)][1]} flips)"
                    for dt in ("bf16", "f32") for n in (2, 1)))
    for n in (2, 1):
        check(w[("bf16", n)][0] <= VERIFY_REL_TOL,
              f"a bf16 forward over {n} rows lies {w[('bf16', n)][0]:.3g} "
              f"of the row's largest |logit| from the 4-row forward")
    say(f"phase 27: every rank's streams agree; 1x4 paged == phase 9's; "
        f"horizon 4 == per step; screened 2x2 and 4x1 == single rank | "
        f"launches (all ranks) {launches} "
        f"({time.perf_counter() - t0:.1f}s)")
    return launches


def mesh_train_depth(cfg, tokens: int, budget: float) -> tuple[int, dict]:
    """The deepest cut of ``cfg`` (widths unchanged) whose reckoned peak on
    one rank of a data-parallel step fits ``budget`` bytes, and the
    reckoning at full depth and at the cut.  A rank holds the whole
    replicated state: 18 B a parameter (bf16 params and gradients, f32
    master, mu and nu, the clip's bf16 copy of the gradients); 3 buckets
    of the gradient all-reduce (``train/step.py::GRAD_BUCKET_BYTES``:
    the flattened bucket, its reduced copy, their mean); 16 B an element
    of the largest leaf (AdamW's and the clip's f32 temporaries); and for
    its own ``tokens``: the f32 logits three times over, remat's saved
    layer inputs and one layer's recompute (a MoE layer's expert buffer
    at the whole batch's capacity an expert, as phase 17 reckons it: a
    bound, a rank packing only its own kept tokens)."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.train.step import GRAD_BUCKET_BYTES

    d, f = cfg.d_model, cfg.d_ff
    e_pad = moe.padded_experts(cfg.n_experts) if cfg.is_moe else 0

    def need(L: int) -> dict:
        c = dataclasses.replace(cfg, n_layers=L)
        P = c.param_count()
        if cfg.is_moe:
            cap = moe._capacity(tokens * MESH_TRAIN_RANKS, cfg.n_experts,
                                cfg.moe_top_k, cfg.capacity_factor)
            leaf = max(L * e_pad * d * f, cfg.vocab_padded * d)
            layer = 2 * (4 * tokens * cfg.moe_top_k * d
                         + 3 * e_pad * cap * (d + 3 * f))
        else:
            leaf = max(L * d * f, cfg.vocab_padded * d)
            layer = 2 * tokens * (3 * f + 8 * d)
        parts = {
            "params": P,
            "state": 18 * P,
            "all-reduce buckets": 3 * GRAD_BUCKET_BYTES,
            "largest leaf": 16 * leaf,
            "logits": 12 * tokens * cfg.vocab_padded,
            "remat inputs": 2 * L * tokens * d,
            "layer recompute": layer,
        }
        parts["total"] = sum(v for k, v in parts.items() if k != "params")
        return parts

    L = cfg.n_layers
    while L > 1 and need(L)["total"] > budget:
        L -= 1
    return L, {"full": need(cfg.n_layers), "cut": need(L)}


@contextlib.contextmanager
def recording_cuts():
    """Each capacity cut (``models/moe.py::_cut``, over the whole batch:
    the meshed step's gathered assignments), in call order: its expert
    ids, gates, capacity and keep mask, and under bisect each expert's
    threshold tau (``capacity_threshold``'s)."""
    from repro_torch.models import moe

    cut, solve, cuts = moe._cut, moe.capacity_threshold, []

    def recorded(a_expert, a_gate, e_pad, cap, *rest):
        taus = []

        def recorded_solve(*a, **kw):
            taus.append(solve(*a, **kw))
            return taus[-1]

        moe.capacity_threshold = recorded_solve
        try:
            keep, pos = cut(a_expert, a_gate, e_pad, cap, *rest)
        finally:
            moe.capacity_threshold = solve
        cuts.append(dict(expert=a_expert.clone(), gate=a_gate.clone(),
                         cap=cap, keep=keep.clone(),
                         tau=taus[0].clone() if taus else None))
        return keep, pos

    moe._cut = recorded
    try:
        yield cuts
    finally:
        moe._cut = cut


def _mesh_f32_check(arch: str, mode: str, mesh) -> dict:
    """One f32 step of ``arch`` (capacity ``mode``) at MESH_F32's depth
    and batch, meshed and on this rank alone, from the same weights on the
    same global batch: both losses, the largest per-leaf l2 distance of
    the params' changes, and per routing call (each forward and remat
    recompute) the assignments whose expert id, gate bits or keep differ
    between the two, and the largest gate difference.  Per meshed cut
    also: its capacity, the keeps that differ from ``_cut`` run again on
    its own operands at the whole batch's capacity, and (bisect) the keep
    flips against the single-rank cut whose gate lies farther than
    gate_atol from its expert's tau in both runs."""
    import dataclasses
    import functools

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import moe, transformer
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import step as train_step
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(arch), n_layers=MESH_F32["layers"])
    kw = dict(param_dtype="float32", clip_mode="quantile",
              capacity_mode=mode)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=MESH_F32["seq"],
                           global_batch=MESH_F32["batch"], seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch_at(0).items()}
    p0 = [t.clone() for t in leaves(transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.float32))]
    lr = lambda s: torch.full((), MESH_F32["lr"], device="cuda")  # noqa
    orig, route = train_step.forward, moe._route
    routed = []

    def recorded_route(*a, **k):
        # each routing call's expert ids and gates (the meshed run's on
        # this rank's rows: gathered in rank order below)
        probs, idx, vals = route(*a, **k)
        routed.append((idx.detach().clone(), vals.detach().clone()))
        return probs, idx, vals

    train_step.forward = functools.partial(transformer.forward,
                                           compute_dtype=torch.float32)
    moe._route = recorded_route
    out = {}
    try:
        for name, m in (("mesh", mesh), ("single", None)):
            params = transformer.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                torch.float32)
            fn = train_step.make_train_step(
                cfg, train_step.TrainConfig(**kw), lr, mesh=m)
            routed.clear()
            with recording_cuts() as cuts:
                params, opt, metrics = fn(params, adamw_init(params), batch)
            calls = [(mesh.all_gather(i, mesh.axis_names),
                      mesh.all_gather(v, mesh.axis_names))
                     if m is not None else (i, v) for i, v in routed]
            out[name] = dict(loss=float(metrics["loss"]), cuts=cuts,
                             routed=calls, params=leaves(params))
            del params, opt, fn
            free_memory()
    finally:
        train_step.forward, moe._route = orig, route
    worst = 0.0
    for a, b, z in zip(out["mesh"]["params"], out["single"]["params"], p0):
        dz = (b - z).double()
        worst = max(worst, float((a - b).double().norm()
                                 / max(dz.norm(), 1e-30)))
    cuts = out["mesh"]["cuts"], out["single"]["cuts"]
    keeps = [c["keep"] for c in cuts[0]], [c["keep"] for c in cuts[1]]
    routed = out["mesh"]["routed"], out["single"]["routed"]
    cap, alone, far, near = None, [], [], 0.0
    for cm, cs in zip(*cuts):
        e_pad = moe.padded_experts(cfg.n_experts)
        cap = moe._capacity(MESH_F32["batch"] * MESH_F32["seq"],
                            cfg.n_experts, cfg.moe_top_k, cfg.capacity_factor)
        keep, _ = moe._cut(cm["expert"], cm["gate"], e_pad, cap, mode,
                           "hopper")
        alone.append(int((keep != cm["keep"]).sum()))
        flip = cm["keep"] != cs["keep"]
        if mode == "bisect" and bool(flip.any()):
            e = cs["expert"][flip]
            dist = torch.minimum((cm["gate"][flip] - cm["tau"][e]).abs(),
                                 (cs["gate"][flip] - cs["tau"][e]).abs())
            far.append(int((dist > MESH_F32["gate_atol"]).sum()))
            near = max(near, float(dist.max()))
    return dict(
        caps=[c["cap"] for c in cuts[0]], cap=cap, alone_diffs=alone,
        far_flips=far, flip_tau_dist=near,
        loss=(out["mesh"]["loss"], out["single"]["loss"]), delta_rel=worst,
        calls=(len(keeps[0]), len(keeps[1])),
        keep_diffs=[int((a != b).sum()) for a, b in zip(*keeps)],
        assignments=[int(k.numel()) for k in keeps[1]],
        expert_diffs=[int((a[0] != b[0]).sum()) for a, b in zip(*routed)],
        gate_diffs=[int((a[1] != b[1]).sum()) for a, b in zip(*routed)],
        gate_max_diff=max([float((a[1] - b[1]).abs().max())
                           for a, b in zip(*routed)] or [0.0]),
        dropped=[float(1 - k.float().mean()) for k in keeps[1]])


def _rank_mesh_train(runs, kill_argv: list[str], cache: str) -> dict:
    """One rank of phase 28: each (arch, argv, layers) of ``runs``
    through launch.train's main (this world is its elastic mesh), with
    its launches per step held against the decisions, the last step
    profiled, the clip's norms and (rank 0) the last capacity cut's
    operands kept; then the f32 checks (``_mesh_f32_check``) and the
    uninterrupted run of ``kill_argv``.  Returns numbers and numpy
    arrays only: a CPU tensor would cross to the parent as a shared-memory
    handle, which dies with the rank."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import tuning
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.train import step as train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    tuning.set_cache_path(cache)
    out = {"runs": []}
    mesh = make_elastic_mesh(model_parallel=1)

    def replicas(step, state):
        train.check_replicas(mesh, state, step)

    for arch, argv, L in runs:
        per_step, prof, norms = [], {}, {}

        def on_step(step, metrics):
            per_step.append(dict(ops.LAUNCHES))

        def on_state(step, state):
            # the last step profiled alone: the replica check (its digests
            # and all_gather) runs outside the window
            if step == MESH_TRAIN_STEPS - 1:
                torch.cuda.synchronize()
                prof["wall_ms"] = (time.perf_counter() - prof["t0"]) * 1e3
                prof["p"].__exit__(None, None, None)
            replicas(step, state)
            if step == MESH_TRAIN_STEPS - 2:
                torch.cuda.synchronize()
                prof["p"] = profile(activities=[ProfilerActivity.CUDA])
                prof["p"].__enter__()
                prof["t0"] = time.perf_counter()

        def recorded_clip(grads, *a, **kw):
            got = clip(grads, *a, **kw)
            norms["last"] = got[1].detach()
            return got

        clip = train_step.clip_by_quantile
        train_step.clip_by_quantile = recorded_clip
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        forget_decisions()
        try:
            with MoERecorder() as rec:
                res = train.main(argv + ["--layers", str(L)],
                                 on_step=on_step, on_state=on_state)
        finally:
            train_step.clip_by_quantile = clip
        launches = dict(ops.LAUNCHES)
        bisect = "--capacity-mode" in argv
        want = {("count_below", 1, False): 1}
        cut = None
        if bisect:
            e_pad = rec.last[2]
            want[("count_above", e_pad, True)] = 2 * L
            cut = decisions()[("count_above", e_pad, True)][0]
        want = solver_launches(want)
        prev = {name: 0 for name in launches}
        for i, snap in enumerate(per_step):
            moved = {k: snap[k] - prev[k] for k in snap}
            check({k: moved[k] for k in SOLVER_KERNELS} == want,
                  f"rank {rank} {arch} step {i}: the solves launched "
                  f"{moved}, where the decisions ({decisions_note()}) give "
                  f"{want}")
            check(moved["flash_fwd"] == 2 * L,
                  f"rank {rank} {arch} step {i}: K7 launched "
                  f"{moved['flash_fwd']} times, not {2 * L}")
            prev = snap
        kernels, calls = _profile_records(prof["p"])
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        clip_d = decisions()[("count_below", 1, False)][0]
        out["runs"].append(dict(
            arch=arch, layers=L, losses=res["losses"],
            step_seconds=res["step_seconds"],
            join_seconds=res["join_seconds"], world=res["world"],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=launches, busy_ms=busy_ms, wall_ms=prof["wall_ms"],
            kernels=sum(e.count for e in kernels),
            want=want, note=decisions_note(),
            norms=norms["last"].cpu().numpy(),
            clip=(clip_d.rounds, clip_d.spec_k),
            cut=None if cut is None else (cut.rounds, cut.spec_k),
            operands=(tuple(t.cpu().numpy() if hasattr(t, "cpu") else t
                            for t in rec.last)
                      if bisect and rank == 0 else None),
            dropped=rec.dropped_frac() if bisect else None,
            slots=(min(rec.slots), max(rec.slots)) if rec.slots else None))
        del res
    free_memory()
    out["f32"] = {(arch, mode): _mesh_f32_check(arch, mode, mesh)
                  for arch, mode in MESH_F32_CASES}
    out["kill_ref"] = train.main(kill_argv, on_state=replicas)["losses"]
    return out


def _zero_moments(src: str, dst: str) -> int:
    """A copy of the checkpoint ``src`` at ``dst`` with AdamW's first and
    second moments (the leaves under ``opt/mu`` and ``opt/nu``) zeroed,
    its manifest's digests rewritten; returns how many leaves."""
    import hashlib
    import os
    import shutil

    import numpy as np

    shutil.copytree(src, dst)
    path = os.path.join(dst, "manifest.json")
    manifest = json.loads(Path(path).read_text())
    n = 0
    for name, meta in manifest["leaves"].items():
        if name.split("/")[:2] in (["opt", "mu"], ["opt", "nu"]):
            f = os.path.join(dst, meta["file"])
            np.save(f, np.zeros_like(np.load(f)))
            meta["sha256"] = hashlib.sha256(Path(f).read_bytes()).hexdigest()
            n += 1
    Path(path).write_text(json.dumps(manifest))
    return n


def phase_mesh_train(gen) -> tuple[dict, dict]:
    """Phase 28: data-parallel training on MESH_TRAIN_RANKS ranks sharing
    the card (see the module docstring).  Returns (the launches of both
    drives summed over the ranks, the "mesh-train" kernel rows)."""
    import logging
    import os
    import tempfile
    import types

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tuning
    from repro_torch.launch import train
    from repro_torch.launch.mesh import spawn_local

    free_memory()
    say(f"phase 28: this process holds "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB of the card before "
        f"the ranks start")
    t0 = time.perf_counter()
    tokens = 4096                   # one row of the 2 x 4096 batch a rank
    gb = lambda parts: ", ".join(  # noqa: E731
        f"{k} {v / 1e9:.2f} G" + ("" if k == "params" else "B")
        for k, v in parts.items())
    runs = []
    for arch, extra in MESH_TRAIN_MODELS:
        cfg = get_config(arch)
        L, reckoned = mesh_train_depth(cfg, tokens, MESH_TRAIN_BUDGET)
        say(f"phase 28 {arch} depth reckoning (a rank's share, budget "
            f"{MESH_TRAIN_BUDGET / 1e9:.0f} GB a rank, {MESH_TRAIN_RANKS} "
            f"ranks on the card's 80): full depth {cfg.n_layers} layers: "
            f"{gb(reckoned['full'])} | cut to {L} layers: "
            f"{gb(reckoned['cut'])}")
        runs.append((arch, ["--arch", arch] + MESH_TRAIN_ARGV + extra, L))
    outs = spawn_local(_rank_mesh_train, MESH_TRAIN_RANKS, device="cuda",
                       args=(runs, MESH_KILL_ARGV, tuning.cache_path()),
                       timeout=900)
    launches = {}
    for i, (arch, _, L) in enumerate(runs):
        rs = [out["runs"][i] for out in outs]
        for r in rs:
            check(r["world"] == MESH_TRAIN_RANKS,
                  f"{arch}: trained on {r['world']} ranks")
            check(len(r["losses"]) == MESH_TRAIN_STEPS
                  and all(map(math.isfinite, r["losses"])),
                  f"{arch}: losses not all finite: {r['losses']}")
            check(r["losses"] == rs[0]["losses"],
                  f"{arch}: the ranks report different losses")
            for name, n in r["launches"].items():
                launches[name] = launches.get(name, 0) + n
        timed = [max(r["step_seconds"][j] for r in rs)
                 for j in range(1, MESH_TRAIN_STEPS)]
        ms = statistics.median(timed) * 1e3
        join = [statistics.median(r["join_seconds"][1:]) * 1e3 for r in rs]
        say(f"phase 28 mesh train {arch}: full width, depth {L}, "
            f"{MESH_TRAIN_RANKS} ranks sharing cuda:0 (gloo), global batch "
            f"2 x 4096 (one row a rank), remat, quantile clip"
            + (", capacity bisect" if rs[0]["cut"] else "")
            + f" | losses {[round(x, 4) for x in rs[0]['losses']]} | "
            f"warm-up step {rs[0]['step_seconds'][0] * 1e3:.0f} ms, steps "
            f"1-{MESH_TRAIN_STEPS - 1} {[round(t * 1e3, 1) for t in timed]} "
            f"ms (slowest rank), median {ms:.1f} ms = "
            f"{2 * tokens / ms * 1e3:.0f} tok/s | peak memory by rank "
            f"{[round(r['peak_gb'], 2) for r in rs]} GB | joins by rank "
            f"{[round(j, 1) for j in join]} ms a step, "
            f"{[round(j / ms, 3) for j in join]} of the step | per step and "
            f"rank: K7 {2 * L}, K3 {rs[0]['want']['runahead_topk_threshold']}"
            f", K2 {rs[0]['want']['multi_count']} ({rs[0]['note']})"
            + (f" | dropped fraction {rs[0]['dropped']:.6f}; a rank's expert "
               f"buffer holds its own kept tokens: "
               f"{[r['slots'] for r in rs]} (min, max) slots an expert by "
               f"rank, of the whole batch's capacity "
               f"{rs[0]['operands'][3]}"
               if rs[0]["dropped"] is not None else "")
            + " | params and state bit-identical across the ranks after "
            "every step (check_replicas)")
        for rank, r in enumerate(rs):
            say(f"phase 28 {arch} rank {rank} profile (last step): device "
                f"busy {r['busy_ms']:.1f} ms of {r['wall_ms']:.1f} ms traced "
                f"wall (idle share {1 - r['busy_ms'] / r['wall_ms']:.3f}), "
                f"{r['kernels']} kernels")
    for arch, mode in MESH_F32_CASES:
        for rank, out in enumerate(outs):
            c = out["f32"][(arch, mode)]
            what = f"{arch} {mode} f32 rank {rank}"
            rel = abs(c["loss"][0] - c["loss"][1]) / abs(c["loss"][1])
            check(rel <= MESH_F32["loss_rtol"],
                  f"{what}: meshed loss {c['loss'][0]} vs single "
                  f"{c['loss'][1]}")
            check(c["calls"][0] == c["calls"][1]
                  and not any(c["expert_diffs"]),
                  f"{what}: the routing calls or expert ids differ "
                  f"({c['calls']}, {c['expert_diffs']})")
            check(c["gate_max_diff"] <= MESH_F32["gate_atol"],
                  f"{what}: gates differ by {c['gate_max_diff']:.3g}")
            check(c["caps"] == [c["cap"]] * len(c["caps"])
                  and not any(c["alone_diffs"]),
                  f"{what}: the meshed cuts at capacities {c['caps']} (the "
                  f"whole batch's {c['cap']}) keep {c['alone_diffs']} "
                  f"assignments otherwise than _cut alone on their operands")
            if mode == "bisect":
                # a gate that rounds across its expert's tau flips its keep
                check(not any(c["far_flips"]),
                      f"{what}: {c['far_flips']} keeps flip farther than "
                      f"{MESH_F32['gate_atol']} from their expert's tau")
                check(sum(c["keep_diffs"]) <= MESH_F32["flips"],
                      f"{what}: {c['keep_diffs']} keeps differ of "
                      f"{c['assignments']}")
                check(c["delta_rel"] < MESH_F32["bisect_delta_rel"],
                      f"{what}: the params' change differs by "
                      f"{c['delta_rel']:.3g} of the single-rank step's")
            else:
                check(not any(c["keep_diffs"]),
                      f"{what}: keep masks differ {c['keep_diffs']}")
                check(c["delta_rel"] < MESH_F32["delta_rel"],
                      f"{what}: the params' change differs by "
                      f"{c['delta_rel']:.3g} of the single-rank step's")
        c = outs[0]["f32"][(arch, mode)]
        say(f"phase 28 f32 check {arch} {mode} ({MESH_F32['layers']} "
            f"layers, full width, 2 x 4096, one step): meshed loss "
            f"{c['loss'][0]:.7f} vs single-rank {c['loss'][1]:.7f}; the "
            f"params' change within {c['delta_rel']:.3g} per leaf (l2)"
            + (f"; {c['calls'][0]} routing calls: expert ids equal, gates "
               f"not bit-equal at {c['gate_diffs']} of "
               f"{c['assignments']} (max |diff| {c['gate_max_diff']:.3g}: "
               f"a forward over 1 row rounds apart from one over 2), keep "
               f"masks differ at {c['keep_diffs']}, each flip's gate within "
               f"{c['flip_tau_dist']:.3g} of its expert's tau (dropped "
               f"{[round(x, 4) for x in c['dropped']]}); each meshed cut "
               f"alone on its gathered operands at capacity {c['cap']}: "
               f"keep masks equal"
               if c["calls"][0] else ""))

    # kill on two ranks, resume on one
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_ckpt_") as d:
        ckpt = ["--ckpt-dir", d, "--ckpt-every", "2"]
        try:
            train.main(MESH_KILL_ARGV + ckpt + ["--host-devices", "2",
                                                "--die-at-step", "1"])
            code = 0
        except SystemExit as e:
            code = e.code
        check(code == 42, f"the killed 2-rank launch exited {code}, not 42")
        check(CheckpointManager(d).steps() == [2],
              f"after the kill: {os.listdir(d)}")
        lines, handler = _capture_log("repro_torch.train")
        try:
            resumed = train.main(MESH_KILL_ARGV + ckpt)
        finally:
            logging.getLogger("repro_torch.train").removeHandler(handler)
        # the control: the same resume with AdamW's moments lost
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_ctl_") as e:
            zeroed = _zero_moments(os.path.join(d, "step_2"),
                                   os.path.join(e, "step_2"))
            control = train.main(MESH_KILL_ARGV + ["--ckpt-dir", e])
    check("resumed from checkpoint step 2" in lines,
          f"the one-rank relaunch did not resume from step 2: {lines[:3]}")
    ref = outs[0]["kill_ref"][2:]
    worst, lost = (max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref))
                   for r in (resumed, control))
    check(len(resumed["losses"]) == len(ref) and worst <= MESH_RESUME_RTOL,
          f"resumed losses {resumed['losses']} vs the 2-rank run's {ref}")
    check(lost > MESH_RESUME_RTOL,
          f"a resume with AdamW's moments zeroed ({zeroed} leaves) came "
          f"within {lost:.3g} of the 2-rank run: the check cannot see it")
    say(f"phase 28 kill and resume: reduced internlm2-1.8b on 2 ranks "
        f"killed at step 1 (exit 42, step_2 on disk), resumed on 1 rank: "
        f"losses {resumed['losses']} vs the uninterrupted 2-rank run's "
        f"{ref} (largest rel diff {worst:.3g} <= {MESH_RESUME_RTOL}); the "
        f"control, step_2 with its {zeroed} AdamW mu and nu leaves zeroed: "
        f"losses {control['losses']}, largest rel diff {lost:.3g} > "
        f"{MESH_RESUME_RTOL}")

    # the kernels at a rank's shapes of the drives
    dense, moe_run = outs[0]["runs"][0], outs[0]["runs"][1]
    rows = {"flash_fwd": _k7_row(gen, dict(B=1, S=4096, H=16, Hk=8, D=128),
                                 0, False)}
    scores, expert, e_pad, cap = moe_run["operands"]
    rounds, spec_k = moe_run["cut"]
    rows["runahead_topk_threshold"] = _capacity_row(
        [(torch.from_numpy(scores).cuda(), torch.from_numpy(expert).cuda(),
          e_pad, cap)],
        types.SimpleNamespace(rounds=rounds, spec_k=spec_k),
        "phase 28's last capacity cut (granite-moe-3b-a800m, both ranks' "
        "assignments gathered)")
    rounds, spec_k = dense["clip"]
    rows["multi_count"] = _k2_clip_row(
        gen, torch.from_numpy(dense["norms"]).cuda(),
        types.SimpleNamespace(rounds=rounds, spec_k=spec_k),
        "phase 28's last step (internlm2-1.8b, rank 0)")
    rows["flash_fwd"]["note"] += "; a rank's share of phase 28's step"
    for name, r in rows.items():
        say_row(f"phase 28 {name} mesh-train", r)
    say(f"phase 28: launches (both drives, all ranks) {launches} "
        f"({time.perf_counter() - t0:.1f}s)")
    return launches, rows


# the file of each kernel's port and of the TPU kernel it replaces
KERNEL_FILES = {
    "multi_count": ("multi_count.cu", "multi_count.py:69"),
    "runahead_topk_threshold": ("runahead_threshold.cu",
                                "runahead_threshold.py:123"),
    "multi_mass": ("multi_mass.cu", "multi_mass.py:65"),
    "multi_entropy_moments": ("multi_entropy.cu", "multi_entropy.py:84"),
    "taylor_sincos_eval": ("taylor_eval.cu", "taylor_eval.py:61"),
    "paged_attend": ("paged_attend.cu", "paged_attend.py:131"),
}


def _shard_row(name: str, run, plain, exact: bool, bound, note: str,
               library=None, library_name: str = "none",
               plain_calls: int = 5, tol: dict = TOL) -> dict:
    """A kernel at a mesh path's shape: its output against its plain
    version (bit for bit where ``exact``, else within ``tol``, compared
    in f32), bit-stable run to run, timed (graph replay, eager call,
    plain, library)."""
    import torch

    outs = [o if isinstance(o, tuple) else (o,)
            for o in (run(), run(), plain())]
    err = 0.0
    for g, a, w in zip(*outs):
        check(torch.equal(g, a), f"{name} not bit-stable at {note}")
        ok = (torch.equal(g, w) if exact
              else torch.allclose(g.float(), w.float(), **tol))
        check(ok, f"{name} differs from its plain version at {note}")
        err = max(err, (g.float() - w.float()).abs().max().item())
    src, ref = KERNEL_FILES[name]
    return dict(source=f"src/repro_torch/kernels/csrc/{src}",
                replaces=f"src/repro/kernels/{ref}", max_abs_err=err,
                ms=device_ms(run), call_ms=call_ms(run),
                plain_ms=device_ms(plain, calls=plain_calls),
                bound=bound,
                library_ms=device_ms(library) if library else None,
                library=library_name, note=note)


def _mesh_rows(gen) -> dict:
    """The kernels at the mesh paths' shapes, each against its plain
    version: K2, K4, K5 on the 2x2 mesh's vocab shard (B = 2 slots a
    rank, V / 2 = 75968 columns, M = 31); K3 on the 4x1 mesh's one row a
    rank (1, 151936; "data"); K6 on 2 slots a rank (the 2x2 paged pool);
    K1 on phase 26's chunk at k = 2 over 2 ranks (2 points, 1000 terms).
    Returns {path: {kernel: row}}."""
    import torch

    from repro_torch.kernels import multi_count as mc
    from repro_torch.kernels import multi_entropy as me
    from repro_torch.kernels import multi_mass as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attend as pa
    from repro_torch.kernels import runahead_threshold as rt
    from repro_torch.kernels import taylor_eval as te

    B, V, M = 2, PATH_V // 2, PATH_M
    x = torch.randn((B, V), generator=gen, device="cuda") * 2.0
    lo, hi = x.amin(-1, keepdim=True), x.amax(-1, keepdim=True)
    taus = lo + (hi - lo) * torch.rand((B, M), generator=gen, device="cuda")
    shard = f"({B}, {V}) x M={M}, the 2x2 mesh's vocab shard"
    rows = {"multi_count": _shard_row(
        "multi_count", lambda: ops.multi_count(x, taus),
        lambda: mc.multi_count_plain(x, taus), True,
        bound_ms(4 * (x.numel() + 2 * taus.numel()), 2 * x.numel() * M),
        shard)}
    p = torch.softmax(x, dim=-1)
    pt = p.amin(-1, keepdim=True) + (p.amax(-1, keepdim=True) - p.amin(
        -1, keepdim=True)) * torch.rand((B, M), generator=gen, device="cuda")
    rows["multi_mass"] = _shard_row(
        "multi_mass", lambda: ops.multi_mass(p, pt),
        lambda: mm.multi_mass_plain(p, pt), False,
        bound_ms(4 * (p.numel() + 2 * pt.numel()), 3 * p.numel() * M),
        shard)
    z = x - x.amax(-1, keepdim=True)
    ts = torch.exp(torch.empty((B, M), device="cuda").uniform_(
        -3.0, 3.0, generator=gen))
    pairs = z.numel() * M
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_ms = pairs / (sms * SFU_PER_CLOCK * max_sm_clock_hz()) * 1e3
    rows["multi_entropy_moments"] = _shard_row(
        "multi_entropy_moments", lambda: ops.multi_entropy_moments(z, ts),
        lambda: me.multi_entropy_moments_plain(z, ts), False,
        max((sfu_ms, "operations"),
            bound_ms(4 * (z.numel() + 3 * ts.numel()), 4 * pairs)), shard)
    x1 = torch.randn((1, PATH_V), generator=gen, device="cuda") * 2.0
    kw = dict(k_target=40, rounds=8, spec_k=5)
    n_cmp = 2 + 1 + kw["rounds"] * kw["spec_k"]
    rows["runahead_topk_threshold"] = _shard_row(
        "runahead_topk_threshold",
        lambda: ops.runahead_topk_threshold(x1, **kw),
        lambda: rt.runahead_topk_threshold_plain(x1, **kw), True,
        bound_ms(4 * (x1.numel() + 2), 2 * x1.numel() * n_cmp),
        f"(1, {PATH_V}), the 4x1 mesh's row a rank (\"data\")",
        library=lambda: torch.topk(x1, 40, dim=-1),
        library_name="torch.topk", plain_calls=2)
    sh = dict(K6_PATH, B=2, pos=K6_PATH["pos"][:2])
    args = _k6_inputs(gen, sh, torch.bfloat16)
    C, P = sh["C"], sh["P"]
    pages = sum(min(args[2].shape[1], -(-(q + 1) // P)) for q in sh["pos"])
    n_bytes = 2 * args[4].numel() * 2 + pages * P * sh["nkv"] * sh["hd"] * 4
    n_ops = 4 * sh["nq"] * sh["hd"] * sum(min(C, q + 1) for q in sh["pos"])
    rows["paged_attend"] = dict(_shard_row(
        "paged_attend", lambda: ops.paged_attend(*args, context=C),
        lambda: pa.paged_attend_plain(*args, context=C), False,
        bound_ms(n_bytes, n_ops),
        "B=2 slots a rank (the 2x2 paged pool), bf16 within 1e-2 (phase "
        "3's bf16 tolerance)", plain_calls=2,
        tol=dict(rtol=1e-2, atol=1e-2)))
    pts = torch.rand((2,), generator=gen, device="cuda") + 1.0
    steps = 2 * (1000 - 1)
    lat_ms = steps * K1_CHAIN_DEPTH * FMA_LATENCY / max_sm_clock_hz() * 1e3
    k1 = _shard_row(
        "taylor_sincos_eval",
        lambda: ops.taylor_sincos_eval(pts, terms=1000),
        lambda: te.taylor_sincos_plain(pts, terms=1000), True,
        bound_ms(8 * pts.numel(), 5 * steps * pts.numel()),
        "2 points, 1000 terms: phase 26's chunk at k = 2 on 2 ranks",
        plain_calls=1)
    k1["latency_bound"] = (lat_ms, "latency")
    for name, r in list(rows.items()) + [("taylor_sincos_eval", k1)]:
        say_row(f"phase 27 {name} (mesh shape)", r)
    return {"mesh-serve": rows, "mesh-runahead": {"taylor_sincos_eval": k1}}


def _path_kernels(path_rows: dict, launches_by_path: dict) -> list:
    """The JSON line's entries of ``path_rows`` ({path: {kernel: row}}),
    each with its launch count on its path."""
    kernels = []
    for path, by_name in path_rows.items():
        for name, r in by_name.items():
            launches = launches_by_path[path][name]
            check(launches > 0, f"{name} was not launched on its path {path}")
            kernels.append(dict(
                name=name, route="cuda", source=r["source"],
                replaces=r["replaces"], path=path, launches=launches,
                launches_counted="eager launches and, per graph replay, the "
                                 "launches its capture recorded",
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                bound_by=r["bound"][1], library_ms=r["library_ms"]))
            if "latency_bound" in r:
                kernels[-1]["latency_bound_ms"] = r["latency_bound"][0]
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import tempfile

    from repro_torch.core import tuning

    t0 = time.perf_counter()
    smi = phase_card()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    # the paths run as a user runs them, in the tuner's default mode (the
    # analytic solver tier, today's kernel geometry) on an empty cache, as
    # in a fresh checkout; their launch counts follow the decisions it
    # reports.  Phase 3 holds each kernel at today's geometry against its
    # plain version and emulations, under tuning.disabled().
    with tempfile.TemporaryDirectory() as d:
        tuning.set_cache_path(str(Path(d) / "none.json"))
        with tuning.disabled():
            rows = phase_kernels(gen)
            path_rows = _rows_new_paths(gen)
        solve_launches = phase_solves(gen)
        serve_launches, session = phase_serve()
        phase_reference(gen)
        phase_warm(session)
        del session
        launches_by_path = {"solves": solve_launches, "serve": serve_launches,
                            "paper": phase_paper()}
        (launches_by_path["continuous"], per_step_streams,
         single_tok_s) = phase_continuous()
        phase_continuous_reference(gen)
        launches_by_path["train"] = phase_train()
        phase_fault(Path(d) / "none.json")
        launches_by_path["continuous-mixed-k"] = phase_mixed_k(gen)
        phase_horizon(per_step_streams)
        verify_ms = phase_speculative()
        (launches_by_path["moe-serve"], launches_by_path["moe-prefill-bisect"],
         k3_moe_serve) = phase_moe_serve(gen)
        launches_by_path["moe-train"], k3_moe_train, k2_moe_train = (
            phase_moe_train(gen))
        phase_tuning(gen, per_step_streams, verify_ms)
        launches_by_path.update(phase_recurrent(
            19, "xlstm-1.3b", XLSTM_SERVE_ARGV, XLSTM_CONT_ARGV, gen,
            "48 layers: 42 mLSTM and 6 sLSTM, d_model 2048, 4 heads of 512, "
            "vocab 50304"))
        launches_by_path.update(phase_recurrent(
            20, "hymba-1.5b", HYMBA_SERVE_ARGV, HYMBA_CONT_ARGV, gen,
            "32 layers: 3 global and 29 sliding-window (1024) attention || "
            "SSM blocks, d_model 1600, 25/5 heads of 64, SSM state 16, d_ff "
            "5504, vocab 32001 padded to 32128"))
        launches_by_path["hymba-prefill"] = launches_by_path["hymba-serve"]
        check(launches_by_path["hymba-prefill"]["flash_fwd"] == 32,
              "K7 did not run once a layer in hymba's 4096-token prefill")
        launches_by_path.update(phase_whisper(gen))
        launches_by_path.update(phase_int8(gen))
        for path, phase in (("hymba-train", phase_hymba_train),
                            ("xlstm-train", phase_xlstm_train),
                            ("whisper-train", phase_whisper_train)):
            launches_by_path[path], path_rows[path] = phase(gen)
        with tuning.disabled():
            path_rows.update(_mesh_rows(gen))
        launches_by_path["mesh-runahead"] = phase_mesh_runahead()
        launches_by_path["mesh-serve"] = phase_mesh_serve(per_step_streams,
                                                          single_tok_s)
        launches_by_path["mesh-train"], path_rows["mesh-train"] = (
            phase_mesh_train(gen))

    # the path whose run each kernel's launch count is read on: K2 runs
    # where the served requests' top_k differ (phase 13)
    paths = {"taylor_sincos_eval": "paper",
             "multi_count": "continuous-mixed-k",
             "paged_attend": "continuous", "flash_fwd": "train"}
    kernels = []
    for name, r in rows.items():
        path = paths.get(name, "serve")
        launches = launches_by_path[path][name]
        check(launches > 0, f"{name} was not launched on its path {path}")
        kernels.append(dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], path=path, launches=launches,
            launches_counted="eager launches and, per graph replay, the "
                             "launches its capture recorded",
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"]))
        if "latency_bound" in r:
            kernels[-1]["latency_bound_ms"] = r["latency_bound"][0]
    # the MoE paths: K3 as the capacity cut (its rows measured at the cut's
    # shapes), K2 as the quantile clip of MoE training
    for name, path, r in (
            ("runahead_topk_threshold", "moe-prefill-bisect", k3_moe_serve),
            ("runahead_topk_threshold", "moe-train", k3_moe_train),
            ("multi_count", "moe-train", k2_moe_train)):
        launches = launches_by_path[path][name]
        check(launches > 0, f"{name} was not launched on its path {path}")
        kernels.append(dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], path=path, launches=launches,
            launches_counted="eager launches and, per graph replay, the "
                             "launches its capture recorded",
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"]))
    # the later paths: K3-K5 at their vocab rows, K7 at hymba's prefill and
    # at the int8 serve's admissions; the int8 serve's K3-K5 run at the
    # served shape of phase 3's rows; the families' training: K2 at each
    # clip's shape, and K7 at hymba's, which its prefill's row holds
    path_rows["int8-serve"].update(
        {name: rows[name] for name in ("runahead_topk_threshold",
                                       "multi_mass", "multi_entropy_moments")})
    path_rows["hymba-train"]["flash_fwd"] = (
        path_rows["hymba-prefill"]["flash_fwd"])
    kernels += _path_kernels(path_rows, launches_by_path)
    say(f"total {time.perf_counter() - t0:.1f}s")
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
