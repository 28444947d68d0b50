"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python chip_smoke.py

Phases, each printing one JSON line:

1. ``build`` — builds the CUDA kernels from ``src/repro_torch/csrc``
   with nvcc (sm_90a, one process per source, all started together)
   and reports the build time and the card;
2. ``kernels`` — holds every kernel against its plain PyTorch version
   on the card, at edge sizes up to 2^24 and on the edge inputs each
   kernel must handle: K1 prefix count, K2 FNV-1a row hash, K3 group
   boundaries, K4 running segment ids, K6 radix rank and K10 shard rank
   (over ``repro_torch.kernels.partition_cases``: P in {1, 2, 4, 8, 32},
   uniform / one-bucket / half-hot destinations, fixed-stride or random
   offsets) bit-identical; K1, K4 and K3 (one-pass look-back scans)
   also over ``repro_torch.kernels.scan_cases``: sizes around the tile,
   each input kind (K3: sorted keys whose runs cross stripes, warp runs
   and tile edges, a key change at every tile edge, all equal,
   INT32_MIN/INT32_MAX runs, strictly increasing) repeated 50 times,
   views not 16-byte aligned, 200 replays of one captured CUDA graph on
   alternating inputs, and two calls on two streams at once; K5 (one
   memset and one launch) also over
   ``repro_torch.kernels.reduce_cases``: sizes around its batch, G in
   {1, 120, 256} and its shared limit and one either side, every op and
   dtype over NaN payloads, denormals and int32 extremes, ids outside
   [0, G), views not 16-byte aligned, 200 graph replays and two streams,
   bit for bit (float sums within their bound); K6 (a one-pass
   look-back rank) also over
   ``repro_torch.kernels.radix_cases``: sizes around its tile, five
   digit kinds, B in {1, 4, 7, 256, 1024}, each case repeated 20 times
   (at B <= 32 also equal to K10), graph replays and two streams;
   K10 (a one-pass look-back rank) also over ``partition_cases``' sizes
   around its tile, each case repeated 20 times, graph replays and two
   streams;
   K5 segmented reduction over {sum, min, max} x {int32, float32} and
   G in {1, 16, 4097, 2^20} with NaN, ±inf, -0.0, empty segments and a
   hot segment — bit-identical except float32 sums, which are held to
   the float32 accumulation bound (min/max compared after mapping every
   NaN to one code and -0.0 to +0.0);
3. ``e2e`` — a 2^24-row fact table joined to a 2^16-row dimension with
   a semantic filter on the dimension's text and a two-key group-by,
   optimised under the sort-merge join configuration and executed at
   ``kernel_impl="auto"``; it must launch K1-K4 and match the port's
   own ``kernel_impl="host"`` run in rows, row order, the six
   ExecStats fields and backend calls;
4. ``e2e_hash`` — the default configuration users run: the 2^24-row
   fact table joined to a 2^22-row user table and the dimension, both
   joins planned ``hash`` under ``CostParams()``, then the semantic
   filter and a group-by with count and int32/float32 min/max; it must
   launch K1, K4, K5 and K6 and match the host run the same way;
5. ``corpus`` — corpus queries of all five schemas at scale 1.0, under
   the sort-merge configuration and again under ``CostParams()`` (hash
   joins), each held to the host run in the same way;
6. ``stream`` — a standing query over a 2^20-row fact table fed 8
   micro-batches of 2^16 rows; the fact table is the build side of a
   hash join served by the incremental stream table, and after every
   batch the standing output equals a cold host run on the
   concatenated data;
7. ``e2e_sharded`` — the ``e2e_hash`` tables and query planned under
   ``CostParams(n_shards=4)`` and run by the partitioned mesh executor
   over four shards of the card (``make_data_mesh(4, devices=[card] *
   4)``), cold then warm on one executor; both held to the
   single-device kernel run and the host run in rows, order, the six
   ExecStats fields and backend calls; both joins ``partitioned``,
   collectives within 2 per join + 1 per grouped aggregate, K1, K2, K5
   and K10 launched; prints the walls, their split, the collectives by
   site and the peak memory;
8. ``sharded_stream`` — ``benchmarks/bench_sharded.py``'s workload at
   2^24 facts and 2^16 dims: its grouped aggregate and its join 8
   times each on the mesh and on one device, every output identical,
   the collective budget (aggregate <= 1 cold and 0 warm, join <= 2
   cold and exactly 1 warm), per-query walls of both. Four shards on
   one card measure the tier's kernels, layout and host merges, not
   an interconnect;
9. ``attention`` — K7 (flash attention) and K8 (flash-decode) against
   their plain versions on unit-normal inputs: K7 at S in {1, 63, 64,
   65, 128, 1000}, GQA group in {1, 2, 12}, head_dim in {36, 64, 80,
   128} (36 and 80 zero-padded to K7's tiles), causal and not, through
   the model's transposed (B, S, H, d) views,
   and causal with a sliding window of {1, 17, 64} at S = 1000; K8 at T
   in {1, 131, 1000} with rows of lengths {1, 2, T-1, T} in one batch,
   through the model's permuted (B, T, K, d) cache, and with the
   reference's slot mask over wrapped rings of 16 and 64 slots (entries
   above pos, entries too old for the window, empty slots); head_dim
   256 (paligemma-3b) at groups {1, 8} over one KV head: K7 causal, not
   and windowed, K8 under lengths (T up to 1500) and the slot mask; K7
   not causal with Sq in {1, 32, 65} against Sk in {63, 1500} (whisper's
   cross-attention) at head_dim 64 and 256; the VLM's prefix route
   (two K7 calls into one output) against the plain prefix-mask
   attention; within 1e-4
   (float32 sums over <= 1500 keys in another order); then K8 at the
   edges of its split over the cache (``check_decode_split``): lengths
   around its chunk over 131- and 4104-position caches, a full
   2048-slot ring, rings with dead chunks between live ones, each call
   equal bit for bit to a second one, and 200 graph replays per mask
   on alternating inputs. The sweep and its tolerance are
   ``repro_torch.kernels.attention_cases``, which the card tests share;
10. ``ssd`` — K9 (the SSD intra-chunk step) against its plain version,
   all four outputs, over ``repro_torch.kernels.ssd_cases``: chunk in
   {64, 128}, s in {1, chunk-1, chunk, chunk+1, 4 chunk+3} (padded as
   ``ops.ssd`` pads), (h, p, n) in {(1, 16, 16), (32, 64, 128),
   (50, 64, 16)}, b in {1, 16}, on the model's distribution (dt =
   softplus(3 N), A = -U[1, 16]: exp above the diagonal overflows) and
   strided layout; then ``ops.ssd`` against the sequential oracle at
   (1, 1000, 4, 16, 16, 128); within ``ssd_cases.tolerance``;
11. ``serve`` — starcoder2-3b at full width (30 layers, d_model 3072,
   24 query heads over 2 KV heads, head_dim 128, float32 weights from a
   seeded generator) behind ``ServingEngine(batch_size=16, max_seq=128,
   max_new_tokens=2)``: 256 prompts made from a seed, served
   continuously with K7/K8 (``attn_impl="auto"``) and again with the
   plain grouped einsum (``"ref"``); the answers must be identical, K7
   must launch once per layer per admission and K8 once per layer per
   round; prints admissions, rounds, prefill/decode device seconds
   (CUDA events around the scheduler's ``_admit``/``_round``), rates,
   syncs, peak memory and one admission's prefill-logit difference;
   then serves 64 of the prompts in two waves half a batch apart, so
   slots are freed and refilled while others are mid-decode, and holds
   the K7/K8 engine's token ids to the plain engine's there too;
12. ``llm_query`` — five corpus queries (one per schema, scale 0.1,
   ``CostParams()``) through per-schema ``FrontDoor``s sharing one
   runner over ``ModelBackend.from_engine`` on the same starcoder2-3b
   engine, once with K7/K8 and once with the plain attention: rows,
   order, ``llm_calls``, ``cache_hits``, ``pipeline_syncs``,
   ``serving_syncs``, backend calls and the token ids the model emitted
   for every prompt must be equal;
12b. ``serve_tp_dense`` — the starcoder2-3b weights laid out over a
   (1, 4) model mesh whose positions all lie on the card
   (``launch/mesh.py::make_mesh(1, 4, devices=[card] * 4)``,
   ``models/params.py::shard_params``: 6 query heads a rank over the
   one KV head they read), a kernel-path and a plain engine over it,
   128 prompts and the two-wave 64: answers and token ids identical
   between the paths and to a single-device engine's; K7/K8 once per
   layer per position per admission / round; prefill logits against
   the single-device prefill within TP_LOGIT_TOLERANCE of max|logit|;
   admission and round ms (eager) and peak memory;
12c. ``serve_tp_seq`` — the same weights over (1, 4) under
   ``shard_cache_seq`` (``TP_SEQ_MESHES``: the K/V caches split over
   the sequence, each rank 33 of the engine's 131 slots, the last 32,
   of both KV heads; each rank attends with all 24 heads over its
   slice and the slices combine by their log-sum-exps): ``serve_tp``'s
   checks against the same single-device answers, K8 once per layer
   per position per round and on its log-sum-exp route alone; then one
   admission whose prompts' lengths spread to ``max_seq``, so that its
   rows' positions reach every rank's slice and a round has empty rows
   beside live ones in a rank (``spread_admission``), its token ids on
   both paths equal to a single-device engine's; and ``serve_hybrid`` — the same serving checks with
   mamba2-370m (48 SSM layers, d_model 1024, 32 heads x 64, state 128,
   chunk 128) and hymba-1.5b (32 layers, d_model 1600, attention of 25
   query over 5 KV heads with window 2048 beside 50 SSM heads x 64,
   state 16, chunk 64) at full width, 128 prompts each, kernel path
   (K9, and K7/K8 for the hybrid) against the plain path (grouped
   einsum and ``ssd_chunked``, no kernel): identical answers and token
   ids (two-wave run included), K9 once per layer per admission, and
   one admission's prefill logits, SSM ``state`` and ``conv`` compared;
14. ``long_prefill`` — the shapes admissions never reach: mamba2-370m
   prefills 2 x 2048 tokens (16 chunks), hymba-1.5b 1 x 4096 tokens
   into a 4104-position cache (a 2048-slot ring; the window cuts) and
   decodes 8 steps past the wrap, both paths, logits (and the SSM
   state) within LONG_TOLERANCE of max|plain|;
14b. ``serve_tp_ssm`` — ``serve_tp``'s checks with the trees of
   ``serve_ssm`` and ``serve_hybrid`` (seed 0) laid out by
   ``shard_params``: mamba2-370m over (2, 2) (the SSM's weights FSDP over
   the data ranks, replicated over the tensor-parallel ranks, which
   share one call on the card; the vocabulary over two), hymba-1.5b over
   (2, 1), over (2, 2) under ``dp_over_tp`` (four data ranks, every
   weight whole), and over (1, 2) and (1, 4) without it (its 25 query
   heads 13 + 12 and 7 + 7 + 7 + 4 over the tensor ranks, a rank's
   heads in up to three runs, each inside one KV head's group or over
   whole groups); 128 prompts plus the two-wave 64 on both paths, held
   to those phases' one-device answers; K9 once per layer per data rank
   per admission, K7/K8 (window, slot mask) per run per position, each
   run's K7 and K8 shape timed in the kernels line;
15. ``llm_query_hybrid`` — Q13 and q8 through ``ModelBackend`` on the
   hymba-1.5b engines, held as ``llm_query`` holds its queries;
16. ``serve_moe`` — the same serving checks with olmoe-1b-7b at full
   width (16 layers, d_model 2048, 16 query over 16 KV heads x 128, 64
   experts of d_ff 1024 with top-8 routing at capacity factor 1.25;
   6,919,096,320 float32 parameters), 128 prompts, K7/K8 against the
   plain attention over one parameter tree: identical answers and token
   ids, K7 once per layer per admission, K8 once per layer per round;
   prints the predictions (a round's weight bytes and their bound, an
   admission's operations at the float32 peak and at the measured GEMM
   rate) beside the measured admission and round, and
   ``router_topk_diff``: the (token, layer) pairs whose top-8 expert
   set differs between the two paths' prefill of one admission, and
   the smallest top-8 / top-9 router probability gap (recorded, not
   gated);
17. ``llm_query_moe`` — Q13 and q8 through ``ModelBackend`` on the
   olmoe-1b-7b engines, held as ``llm_query`` holds its queries;
17b. ``serve_tp`` — ``serve_tp_dense``'s checks with the olmoe-1b-7b
   weights over a (1, 2) mesh (experts and heads over two
   tensor-parallel ranks, the single-device capacity: answers held to
   ``serve_moe``'s) and a (2, 2) mesh (the token chunks over two data
   ranks, so capacity is per chunk and answers may differ from one
   device's: counted; prefill logits held to one device's at capacity
   factor E/k, where no row drops), each tree freed before the next;
17c. ``llm_query_tp`` — Q13 and q8 (at scale 0.075) through
   ``ModelBackend`` on the (2, 2) engines, held as ``llm_query`` holds
   its queries;
18. ``serve_mla`` — deepseek-v3-671b at full width with its depth cut to
   one layer (``reduced``: 61 -> 1; d_model 7168, MLA over 128 heads
   with q/kv latent ranks 1536/512 and head widths 128 + 64 / 128, 256
   routed experts of gated d_ff 2048 at top-8 and capacity factor 1.25
   plus one shared expert, vocab 129280; 13,712,994,304 float32
   parameters, 54.85 GB), one engine (MLA has one path: the reference
   runs it outside any Pallas kernel), 128 prompts served continuously
   and again drained on the same engine: identical answers and token
   ids, no K7/K8 launch; the two-wave 64 twice, identical (which rows
   an expert's capacity of 1 keeps in a round depends on the other
   slots, so their differences from the drained answers are recorded);
   decode-matches-forward at full width (the absorbed decode against
   the materialised forward, within DECODE_TOLERANCE, at a capacity
   factor with no drops) with ``router_topk_diff`` between the two
   forms; the predictions beside the eager and graph-replayed admission
   and round; peak memory;
19. ``llm_query_mla`` — Q13 and q8 through ``ModelBackend`` on that
   engine, twice (rows, stats, calls and token ids identical); the
   query path's K1/K3/K4/K5 launches recorded, K7/K8 none;
19b. ``serve_tp_mla`` — that engine's answers, token ids and routings
   of the 128 prompts and of the two waves, and one admission's prefill
   logits, recorded (``mla_one_device``); the model freed; the same
   seeded tree made again and laid out leaf by leaf over (1, 2)
   (``shard_params(consume=True)``: 128 heads and 256 routed experts
   over two ranks; each whole leaf freed as its parts are made), then
   two engines over it, under the default policy (the latent cache one
   tensor a card) and under ``shard_cache_seq`` (each rank a slice of
   its positions): 128 prompts continuous and drained (identical), the
   two waves of 64; answers and ids held to one device's under
   ``hold_paths``' tie rule (a first routing split only at a top-k gap
   of at most ROUTE_TIE, then identical with one device's routings
   replayed), prefill logits within TP_LOGIT_TOLERANCE; no K7/K8
   launch; admission and round ms (eager) and peak memory, under the
   card's; then the tree is freed;
20. ``encdec`` — whisper-small at full width (12 + 12 layers, d_model
   768, 12 heads x 64, 1500 frames, vocab 51865; weights from a seeded
   generator) through the model's entry points (the reference's engine
   feeds tokens only): 16 rows of 1500 frame embeddings and 32 prompt
   tokens from a numpy seed, ``prefill(max_seq=64)`` then 16 greedy
   ``decode_step``s, on the kernel path (K7 bidirectional over the
   encoder, causal over the decoder, bidirectional with Sq != Sk for
   cross-attention; K8 on self and cross decode) and on the plain path:
   identical greedy ids, prefill logits within
   MULTIMODAL_LOGIT_TOLERANCE of max|logit|, K7 and K8 launches per
   layer by mode, decode-matches-forward within DECODE_TOLERANCE; CUDA
   events around the encoder, the prefill and each step; peak memory;
21. ``vlm`` — paligemma-3b at full width (18 layers, d_model 2048, 8
   query heads over 1 KV head x 256, gated d_ff 16384, vocab 257216),
   the same checks over 16 rows of 256 patch embeddings and 32 text
   tokens, ``prefill(max_seq=304)`` and 16 greedy steps from pos 288;
   K7's prefix route (causal over all rows, bidirectional over the image
   rows into the same output) and K8 at head_dim 256;
   decode-matches-forward at 2 rows; then the model is freed;
21b. ``mm_tp`` — after each of ``encdec`` and ``vlm``, its tree and
   inputs over model meshes of the card (``MM_TP_MESHES``: whisper-small
   at (2, 2) under ``dp_over_tp``, at (1, 2) and at (1, 2) under
   ``shard_cache_seq``, paligemma-3b at (1, 2), (2, 2) and (1, 2) under
   ``shard_cache_seq``), the same prefill and 16 greedy steps on both
   paths: greedy ids identical to one device's, prefill logits within
   TP_LOGIT_TOLERANCE of one device's, K7 and K8 launches per position
   and layer by mode, self decode on K8's log-sum-exp route under
   ``shard_cache_seq`` (its lengths route otherwise); CUDA events, peak
   memory;
22. ``train_equiv`` — three ``build_train_step`` steps of stablelm-tiny
   (2 microbatches, remat "full"), olmoe-tiny (remat "dots"),
   deepseek-tiny (MLA and the MTP loss; 2 microbatches, remat "full"),
   whisper-tiny (2 microbatches, remat "full") and paligemma-tiny (2
   microbatches, remat "dots"; the frames and patches from a numpy seed)
   from one set of weights on the card and on the CPU, every loss within
   TRAIN_TOLERANCE relative; then ``launch/train`` on the card with the
   tiny mamba2: killed after step 6 (exit 42) and resumed, its final
   ``loss=`` line equal to an uninterrupted run's (checkpoints in a
   temporary directory; whether the two final checkpoints are equal
   bit for bit is recorded);
23. ``train`` — stablelm-3b at full width (32 layers, d_model 2560, 32
   heads, gated d_ff 6912, vocab 50304: 2,795,276,800 float32
   parameters) on ``TokenStream(seed=7)`` at batch 8 x seq 128 with
   remat "full": the grad norm with and without remat within
   REMAT_TOLERANCE, the first step's loss with 2 microbatches and with 1
   within MICROBATCH_TOLERANCE, three more steps on one batch (2
   microbatches, fp32 moments) with finite, decreasing losses, one step
   with int8 moments;
   step times, tokens/s, model FLOP/s, ``apply_updates`` ms and peak
   memory; no checkpoint. Training runs the plain attention (the
   kernels have no backward), so it launches no kernel;
24. ``train_tp`` — training over the model mesh, every position on the
   card: qwen2.5-tiny at (2, 4) with replicated KV heads and olmoe-tiny
   at (2, 2), 3 fp32 steps on ``TokenStream(seed=7)`` at TRAIN_EQUIV,
   held to the same mesh on the CPU (and qwen to the card's one-device
   run) within TRAIN_TP_LOSS_TOLERANCE (losses) and
   TRAIN_TP_PARAM_TOLERANCE (every parameter); stablelm-3b at full width
   over (1, 2) and (2, 2): 3 steps on ``train``'s batches (batch 0,
   then batch 1 twice; 2 microbatches, remat "full", fp32 moments), each
   loss within TRAIN_TOLERANCE of ``train``'s, with step times, tokens/s,
   peak memory and the device's busy share of one more step under
   ``torch.profiler`` (``device_busy``; one device's step beside); the
   elastic
   restore: qwen-tiny trained 6 steps at (2, 2), checkpointed, restored
   at (1, 4) by ``CheckpointManager.restore(policy=, cfg=)`` and trained
   to step 9, its loss within TRAIN_TP_LOSS_TOLERANCE of an
   uninterrupted (2, 2) run's; mamba2-tiny at (2, 2), hymba-tiny and
   whisper-tiny at (2, 2) under ``dp_over_tp`` and paligemma-tiny at
   (1, 2) held as qwen is (frames and patches beside the tokens);
   deepseek-tiny (MLA with the MTP loss; no expert drops at its
   capacity factor) at (2, 2) and (1, 2) held to the CPU's mesh and the
   card's one device;
   mamba2-370m at full width over (2, 2) on ``train``'s batch shape, 3
   steps against one device at 2 and at 4 microbatches (TRAIN_TP_SSM,
   SSM_SPREAD_FACTOR), with step times and the model's own row-split
   gradient spread. No kernel launches (training runs the plain
   attention);
25. ``train_backend`` — ``examples/torch_train_backend.py`` on the card
   (backend-13m, 300 steps on ``make_ecommerce(seed=4)``'s labelled
   prompts), held-out accuracy above the majority class, a checkpoint
   in a temporary directory restored through ``CheckpointManager``, and
   ``examples/torch_serve_semantic_queries.py``'s plan (products ⋈
   previews, two semantic filters) under ``none`` and ``cost`` through
   ``ModelBackend`` on a K7/K8 engine and a plain one: answers, token
   ids, rows, ``llm_calls`` and ``cache_hits`` identical; F1 against
   the oracle and the YES share of the verdicts recorded;
26. the ``kernels`` line: per kernel, its launches in the run of the
   path it belongs to (``e2e`` for K1-K4, ``e2e_hash`` for K5 and K6,
   ``serve`` for K7 and K8, ``serve_ssm`` for K9, the cold
   ``e2e_sharded`` run for K10; every path's counts
   beside) and, at the largest shape that run gave it, its device time,
   its plain version's, the bound and one PyTorch library call's time
   where one computes the same function (``torch.cumsum`` for K1/K4,
   ``scaled_dot_product_attention`` for K7/K8; each timed as
   CUDA-graph replays, so no host work is counted, except K3's
   ``torch.unique_consecutive``, which syncs the host and is timed as
   one eager call), plus the wrapper's
   eager call time; the scans (K1, K3, K4), K5, K6, K7, K8, K9 and K10
   also list their device activity over 20 calls under
   ``torch.profiler`` (``device_kernels``: each kernel and memset with
   its count and device time per launch, beside the launches the
   wrappers counted; K3, K5, K6, K7, K8, K9 and K10 must show one data
   kernel per call, K3, K5, K6, K8 and K10 at most one memset beside
   it); K5 also at the radix histograms'
   shape (``radix_histogram``: int32 ones into 256 buckets, with
   ``index_add_`` as its library call and ``torch.bincount`` beside it,
   eager, since it syncs the host); K7 and K9, which run
   on the tensor cores as three TF32 products, carry their bound at
   that rate (a third of 495 TFLOP/s) beside the float32 CUDA-core one;
   K7 also with the hybrid's window and K8 with its slot mask at
   ``serve_hybrid``'s shapes (and both at ``long_prefill``'s: K8 over
   its 2048-slot ring with every slot live), K7 and K8 also at
   ``serve_moe``'s multi-head shapes (group 1), K7 and K8 also at each
   model mesh's shard shapes (``serve_tp_dense_1x4``, ``serve_tp_1x2``,
   ``serve_tp_2x2``, with those runs' launches), K8's log-sum-exp route
   at ``serve_tp_seq``'s rank slice (its first round's lengths at the
   second rank, and positions spread around the fourth, rows empty
   there: output and lse against the plain version, SDPA of the output
   alone beside), K7 and K8 also at every
   shape the ``encdec`` and ``vlm`` phases launched them at (with those
   launches: whisper's encoder, decoder and cross-attention, paligemma's
   prefix route at head_dim 256, and their decodes) and at every shape
   ``mm_tp`` launched them at, K7 with the window and K8 with the slot
   mask at ``serve_tp_ssm``'s hybrid shard shapes, K9 also at
   ``serve_hybrid``'s and ``long_prefill``'s shapes and at
   ``serve_tp_ssm``'s shard shapes (with those launches), with its head
   groups (``head_groups``) and blocks, K10
   also at P = 32 and beside K6 over the same P buckets.

Float32 matrix products run in full float32: TF32 is switched off for
cuBLAS and cuDNN, as the reference computes in float32.

It then prints the card's name and power limit as nvidia-smi reports
them and, last, ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; so does a machine without CUDA. Imports nothing of
the JAX package.
"""
from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM (NVIDIA data sheet): HBM3 rate and the float32 rate outside
# the tensor cores, the peak this script charges 32-bit integer ALU
# work against
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# float32-accurate products on the tensor cores as three TF32 products
# (K7, K9): a third of the dense TF32 rate, 495 TFLOP/s
PEAK_TF32X3_OPS_PER_S = 495e12 / 3
SORT_MERGE = dict(w_hash_build=1e9, w_host_join=1e9)
DEFAULT = {}  # CostParams(): every base-table join is planned hash
G_SIZES = (1, 16, 4097, 1 << 20)
F32_NAN_BITS = 0x7fc00000
STAT_FIELDS = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
               "sem_rows", "rel_rows")
EDGE_SIZES = (1, 1023, 1024, 1025, 65537, 1 << 24)
INT32_MAX = 2**31 - 1
SERVE_ARCH = "starcoder2-3b"
SERVE = dict(batch_size=16, max_seq=128, max_new_tokens=2)
SSM_ARCH = "mamba2-370m"
HYBRID_ARCH = "hymba-1.5b"
SSM_PROMPTS = 128
MOE_ARCH = "olmoe-1b-7b"
MOE_PROMPTS = SSM_PROMPTS
# deepseek-v3-671b at full width with its depth cut to one layer:
# 13,712,994,304 float32 parameters (54.85 GB); two layers (100.9 GB)
# do not fit on one card
# the model-parallel meshes served, (dp, tp) over shards of the card:
# olmoe at the single-device capacity (dp = 1) and split over two data
# ranks; starcoder2's 2 KV heads read by 4 tensor-parallel ranks;
# hymba's 25 query heads over its 5 KV heads at tp 2 (13 + 12) and 4
# (7 + 7 + 7 + 4), each rank's heads in runs inside a group or over
# whole groups (``sharding.model.head_runs``), one K7/K8 launch a run
TP_MESHES = {MOE_ARCH: ((1, 2), (2, 2)), SERVE_ARCH: ((1, 4),),
             SSM_ARCH: ((2, 2),),
             HYBRID_ARCH: ((2, 1), (2, 2, {"dp_over_tp": True}), (1, 2),
                           (1, 4))}
# serve_tp_seq: starcoder2's weights over (1, 4) with the caches split
# over the sequence (each rank 33 of the engine's 131 slots, the last 32,
# of both KV heads)
TP_SEQ_MESHES = ((1, 4, {"shard_cache_seq": True}),)
TP_LOGIT_TOLERANCE = 1e-4  # of max|logit|, mesh against one device
# a top-k router gap at most this is a near tie: the kernel path's and
# the plain path's float32 attention differ by ~1e-6 (relative), so
# such a tie may route a token to other experts on the two paths
ROUTE_TIE = 1e-6
MLA_ARCH = "deepseek-v3-671b"
MLA_REDUCED = {"num_layers": "61 -> 1"}
MLA_PROMPTS = SSM_PROMPTS
# serve_tp_mla: deepseek's one-layer tree over (1, 2) (128 heads and 256
# routed experts over two ranks), served under the default policy and
# under shard_cache_seq by two engines over the one sharded tree
MLA_TP_MESH = (1, 2)
MLA_TP_POLICIES = ({}, {"shard_cache_seq": True})
# decode against forward, absolute and relative: the reference's own
# decode-matches-forward tolerance (tests/test_models_smoke.py); the
# absorbed MLA decode and the materialised forward contract the latent
# in different orders
DECODE_TOLERANCE = 2e-3
# the encoder-decoder and VLM families at full width through the model's
# entry points (the reference's engine feeds tokens only): rows, prompt
# tokens, greedy decode steps, cache length, and the rows that
# decode-matches-forward runs at (a 16-row paligemma forward's logits
# alone are 4.8 GB)
MULTIMODAL = {
    "encdec": dict(arch="whisper-small", rows=16, prompt=32, steps=16,
                   max_seq=64, check_rows=16),
    "vlm": dict(arch="paligemma-3b", rows=16, prompt=32, steps=16,
                max_seq=256 + 32 + 16, check_rows=2)}
# the kernel path's prefill logits against the plain path's, of
# max|plain logit| (float32 attention sums in other orders through 12-18
# layers)
MULTIMODAL_LOGIT_TOLERANCE = 1e-3
# the query path's kernels an LLM query's relational work launches
QUERY_KERNELS = ("prefix_count", "group_boundaries", "running_segment_ids",
                 "segment_reduce")
# the float32 GEMM rate the dense model's prefill GEMMs reach on an H100
# (``serve``'s ``prefill_gemm_tflop_per_s``), beside the data sheet's
# peak, for the MoE predictions
MEASURED_GEMM_FLOP_PER_S = 44e12
# the kernels of the LLM tier, each path's launches of them
LLM_KERNELS = ("flash_attention", "decode_attention", "ssd_chunk")
# long_prefill: kernel path against plain path at full width, relative
# to max|plain|: 48 (32) layers of float32 in which the SSD's chunk sums
# (K9 against ssd_chunked), the attention sums (K7/K8 against the
# grouped einsum) and the GEMMs' inputs differ in their last bits; the
# chunk step alone is held to ssd_cases.tolerance, 2^-23 max|cum| of
# max|plain|: 1e-4 to 1e-3 at the |cum| of 10^3 to 10^4 that random
# dt·A reach in a chunk
LONG_TOLERANCE = 1e-3
# the hybrid's corpus queries through ModelBackend
HYBRID_QIDS = ("Q13", "q8")
# the corpus scale of ``llm_query`` and ``llm_query_tp`` (the other LLM
# query phases run at run_llm_query's 0.15): cut from 0.15 as the mesh
# phases of the SSM, hybrid, encoder-decoder and VLM families came in,
# to keep the script well inside its time limit
LLM_QUERY_SCALE = 0.1
LLM_QUERY_TP_SCALE = 0.075
# training: full-width stablelm-3b (the reference launch/train's default
# arch) at TRAIN; the tiny configurations of TRAIN_EQUIV_ARCHS, each
# with its microbatches and remat, card against CPU at TRAIN_EQUIV
TRAIN_ARCH = "stablelm-3b"
TRAIN = dict(batch_size=8, seq_len=128)
TRAIN_EQUIV = dict(batch_size=4, seq_len=32)
TRAIN_EQUIV_ARCHS = {
    "stablelm-3b": dict(num_microbatches=2, remat="full"),
    "olmoe-1b-7b": dict(num_microbatches=1, remat="dots"),
    "deepseek-v3-671b": dict(num_microbatches=2, remat="full"),
    "whisper-small": dict(num_microbatches=2, remat="full"),
    "paligemma-3b": dict(num_microbatches=2, remat="dots")}
TRAIN_TOLERANCE = 1e-4  # a loss on the card against the CPU's, relative
MICROBATCH_TOLERANCE = 1e-5  # 2 microbatches against 1 (the reference's)
REMAT_TOLERANCE = 1e-4  # grad norm under remat "full" against none
BACKEND_STEPS = 300
# training over the model mesh: the tiny meshes (arch -> (dp, tp),
# for_mesh keywords), the full-width meshes of TRAIN_ARCH, the elastic
# restore's (mesh, mesh resumed on, step saved, last step)
TRAIN_TP_TINY = (("qwen2.5-32b", (2, 4), {"shard_kv_heads": False}),
                 ("olmoe-1b-7b", (2, 2), {}),
                 ("mamba2-370m", (2, 2), {}),
                 ("hymba-1.5b", (2, 2), {"dp_over_tp": True}),
                 ("whisper-small", (2, 2), {"dp_over_tp": True}),
                 ("paligemma-3b", (1, 2), {}),
                 ("deepseek-v3-671b", (2, 2), {}),
                 ("deepseek-v3-671b", (1, 2), {}))
# the SSM at full width over (2, 2), train's batch shape, against one
# device (the same step: 2 microbatches, remat "full", fp32)
TRAIN_TP_SSM = (SSM_ARCH, (2, 2))
# mamba2-370m at random init amplifies the last bits of its forward into
# its gradients (``run_train_tp`` records how far one device's gradient of
# a batch lies from the mean of its halves' gradients, the same function
# in exact arithmetic: ``row_split_grad_rel``), so its losses after an
# Adam step part between layouts of the same function, one device's own
# at 2 and at 4 microbatches too. A later step's loss over the mesh is
# held within this factor of that spread (or within TRAIN_TOLERANCE)
SSM_SPREAD_FACTOR = 2.0
TRAIN_TP_MESHES = ((1, 2), (2, 2))
TRAIN_TP_ELASTIC = ((2, 2), (1, 4), 6, 9)
TRAIN_TP_LOSS_TOLERANCE = 1e-5  # absolute, mesh against one device/CPU
# absolute, every parameter after 3 steps: Adam's first step turns float
# noise in a gradient of a few eps into a move of part of lr
TRAIN_TP_PARAM_TOLERANCE = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing

def eager_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median time of one eager ``fn()`` call in ms, between two CUDA
    events recorded around it: the device time plus any time the card
    waits for the call's host work (allocation, checks, launches)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms(fn, reps: int = 30, inner: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` in ms, free of host work: ``fn`` is
    captured once into a CUDA graph (its allocations, checks and launch
    calls run at capture), and each of ``reps`` samples replays the
    graph ``inner`` times between two CUDA events. Returns the median
    sample over ``inner``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    return statistics.median(times)


# device_kernels' throwaway spins (~50 us each): late in a long run the
# profiler leaves out a window's first device records (~0.8 ms by PR 25's
# length, the whole window once): a window counts only if it kept at least
# one of its spins, so that nothing after them was left out; else it is run
# again with PAD_GROWTH times the spins, at most PAD_TRIES times in all
PAD_SPINS = 64
PAD_GROWTH = 4
PAD_TRIES = 4


def profiled_window(body) -> tuple:
    """``body()`` under ``torch.profiler`` (device activity only), after
    ``PAD_SPINS`` spin kernels, run again with more spins until the
    profiler kept one of them: returns the profiler, ``body``'s result
    and ``{"pad_spins", "spins_listed", "windows"}``. Raises if no window
    kept a spin."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pad = PAD_SPINS
    for window in range(1, PAD_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(100_000)
            result = body()
            torch.cuda.synchronize()
        spins = sum(e.count for e in prof.key_averages()
                    if "spin_kernel" in e.key)
        if spins:
            return prof, result, {"pad_spins": pad, "spins_listed": spins,
                                  "windows": window}
        pad *= PAD_GROWTH
    raise AssertionError(f"the profiler kept none of {pad // PAD_GROWTH} "
                         f"spins in {PAD_TRIES} windows")


def device_kernels(fn, calls: int = 20) -> dict:
    """Every device activity of ``calls`` eager ``fn()`` calls under
    ``torch.profiler`` (kernels and memsets by name), with its listed
    count and its device time per listed launch, the longest first,
    beside the launches the wrappers counted (``_build.LAUNCHES``) in
    the same calls. The window opens with spin kernels, left out of the
    listing (``profiled_window``): late in this script the profiler
    leaves out the first device records of each window, however long
    the host waits before them and however many calls follow."""
    import torch

    from repro_torch.kernels import _build

    fn()
    torch.cuda.synchronize()

    def body():
        before = sum(_build.LAUNCHES.values())
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return sum(_build.LAUNCHES.values()) - before

    prof, counted, pad = profiled_window(body)
    rows = [{"name": e.key, "count": e.count,
             "us_per_launch": e.self_device_time_total / e.count}
            for e in prof.key_averages() if e.self_device_time_total > 0
            and "spin_kernel" not in e.key]
    return {"calls": calls, "launches_counted": counted,
            "activities": sorted(rows, key=lambda r: -r["us_per_launch"]),
            **pad}


def one_data_kernel(label: str, fn, name: str, calls: int = 20,
                    memset: bool = False) -> dict:
    """``device_kernels(fn)``, which must show one launch per call: the
    wrappers counted ``calls`` launches, and the profiler lists one
    data kernel, ``name``, ``calls`` times, and (with ``memset``) at most
    one memset per call beside it."""
    listing = device_kernels(fn, calls)
    acts = listing["activities"]
    data = [a for a in acts if "Memset" not in a["name"]]
    sets = [a for a in acts if "Memset" in a["name"]]
    if listing["launches_counted"] != calls or len(data) != 1 or \
            name not in data[0]["name"] or data[0]["count"] != calls or \
            len(sets) > int(memset) or any(a["count"] > calls for a in sets):
        raise AssertionError(f"{label}: expected one {name} per call"
                             f"{' and at most one memset' if memset else ''}"
                             f", got {listing}")
    return listing


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bounds(n_bytes: float, n_ops: float) -> dict:
    """A tensor-core kernel's bound (K7, K9: operations at the
    three-TF32-product rate) and, beside it, the bound at the float32
    CUDA-core rate that the earlier design was held to."""
    b, by = bound_ms(n_bytes, n_ops, PEAK_TF32X3_OPS_PER_S)
    b32, by32 = bound_ms(n_bytes, n_ops)
    return {"bound_ms": b, "bound_by": by, "bound_f32_cores_ms": b32,
            "bound_f32_cores_by": by32}


# ------------------------------------------------------------ kernel checks

def _same(a, b, what: str) -> int:
    """Max absolute difference between a kernel's output ``a`` and its
    plain version's ``b``; raises unless they are bit-identical (the
    stated tolerance is 0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: shape/dtype {tuple(a.shape)} "
                             f"{a.dtype} vs {tuple(b.shape)} {b.dtype}")
    err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    if err:
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version by up to {err}")
    return err


def _marks_from_counts(counts, total: int, device):
    """+1 marks at each segment start (empty segments stack; starts at
    ``total`` drop), the K4 input the expansion builds."""
    import torch

    starts = torch.cumsum(counts, 0) - counts
    marks = torch.zeros(total + 1, dtype=torch.int32, device=device)
    marks.index_add_(0, starts.long(),
                     torch.ones_like(starts, dtype=torch.int32))
    return marks[:total].contiguous()


def minmax_bits(t):
    """float32 results as int32 codes for an exact comparison: every
    NaN maps to one code and -0.0 to +0.0; int32 passes through."""
    import torch

    if not t.is_floating_point():
        return t
    bits = (t + 0.0).view(torch.int32)
    return torch.where(torch.isnan(t), F32_NAN_BITS, bits)


def k5_cases(n: int, g: int, dtype, gen, device, finite: bool):
    """K5 inputs on ``device``: ids spread over [0, g) with every third
    segment empty, a hot segment taking ~90% of the rows, and sorted
    ids; float32 values carry NaN, ±inf, -0.0 and +0.0 unless
    ``finite``, int32 values span the whole range."""
    import torch

    if dtype == torch.int32:
        vals = torch.randint(-2**31, INT32_MAX, (n,), generator=gen,
                             device=device, dtype=torch.int32)
    else:
        vals = torch.randn(n, generator=gen, device=device) * 100
        if not finite:
            special = torch.tensor([float("nan"), float("inf"),
                                    -float("inf"), -0.0, 0.0],
                                   device=device)
            pick = torch.rand(n, generator=gen, device=device) < 0.05
            which = torch.randint(0, 5, (n,), generator=gen, device=device)
            vals = torch.where(pick, special[which], vals)
    spread = torch.randint(0, g, (n,), generator=gen, device=device,
                           dtype=torch.int32)
    if g > 2:
        spread = torch.where(spread % 3 == 1, spread - 1, spread)
    hot = torch.where(torch.rand(n, generator=gen, device=device) < 0.9,
                      g // 2, spread).to(torch.int32)
    return [(vals, spread), (vals, hot), (vals, torch.sort(spread)[0])]


def sum_error(got, vals, seg, g: int) -> tuple[float, float]:
    """Max |float32 segment sum - float64 sum| and its largest ratio to
    the float32 accumulation bound count * 2^-23 * sum|v|; raises where
    the error exceeds the bound."""
    import torch

    dev = vals.device
    idx = seg.long()
    exact = torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
        0, idx, vals.double())
    mag = torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
        0, idx, vals.double().abs())
    cnt = torch.zeros(g, dtype=torch.float64, device=dev).index_add_(
        0, idx, torch.ones(idx.shape[0], dtype=torch.float64, device=dev))
    err = (got.double() - exact).abs()
    bound = cnt * 2.0**-23 * mag
    if bool((err > bound).any()):
        raise AssertionError(f"K5 float sum g={g}: error {float(err.max())} "
                             f"beyond the float32 accumulation bound")
    ratio = torch.where(bound > 0, err / bound, torch.zeros_like(err))
    return float(err.max()), float(ratio.max())


def k6_digit_cases(n: int, gen, device, buckets: int = 256):
    """K6 digits: all equal, uniform, and skewed (half in one bucket)."""
    import torch

    few = torch.randint(0, min(buckets, 5), (n,), generator=gen,
                        device=device, dtype=torch.int32)
    skew = torch.where(torch.rand(n, generator=gen, device=device) < 0.5,
                       3, few).to(torch.int32)
    return [torch.full((n,), buckets - 1, dtype=torch.int32, device=device),
            torch.randint(0, buckets, (n,), generator=gen, device=device,
                          dtype=torch.int32), skew]


def check_kernels(device, sizes=EDGE_SIZES, seed: int = 0,
                  g_sizes=G_SIZES):
    """Every kernel against its plain version on ``device``. Returns
    the cases checked and the max absolute difference per kernel."""
    import torch

    from repro_torch.kernels.compact.compact import prefix_count_kernel
    from repro_torch.kernels.compact.ref import prefix_count_torch
    from repro_torch.kernels.expand.expand import running_segment_ids_kernel
    from repro_torch.kernels.expand.ref import running_segment_ids_torch
    from repro_torch.kernels.hash_dedup.group_build import (
        group_boundaries_kernel)
    from repro_torch.kernels.hash_dedup.hash_dedup import hash_rows_kernel
    from repro_torch.kernels.hash_dedup.ref import (
        group_boundaries_ref, hash_rows_np, hash_rows_ref)
    from repro_torch.kernels import partition_cases as PC
    from repro_torch.kernels import radix_cases as RC
    from repro_torch.kernels.hash_join.hash_join import (
        radix_rank_kernel, radix_rank_torch)
    from repro_torch.kernels.partition.partition import shard_rank_kernel
    from repro_torch.kernels.partition.ref import shard_rank_torch
    from repro_torch.kernels.segmented_reduce.ref import segment_reduce_torch
    from repro_torch.kernels.segmented_reduce.segmented_reduce import (
        segment_reduce_kernel)

    g = torch.Generator(device=device).manual_seed(seed)
    cases = {"prefix_count": 0, "hash_rows": 0, "group_boundaries": 0,
             "running_segment_ids": 0, "segment_reduce": 0,
             "radix_rank": 0, "shard_rank": 0}
    errs = dict.fromkeys(cases, 0)

    def same(name, a, b, what):
        errs[name] = max(errs[name], _same(a, b, what))
        cases[name] += 1

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=device,
                             dtype=torch.int32)

    for n in sizes:
        # K1: 0/1 flags, all-zero, all-one, small counts
        for flags in (rint(0, 2, (n,)), torch.zeros(n, dtype=torch.int32,
                      device=device), torch.ones(n, dtype=torch.int32,
                      device=device), rint(0, 5, (n,))):
            same("prefix_count", prefix_count_kernel(flags),
                 prefix_count_torch(flags), f"K1 n={n}")
        # K4: k > 1 marks where empty segments stack, trailing empties
        counts = rint(0, 4, (max(n // 2, 1),)).long()
        total = int(counts.sum())
        if total:
            marks = _marks_from_counts(counts, total, device)
            same("running_segment_ids", running_segment_ids_kernel(marks),
                 running_segment_ids_torch(marks), f"K4 n={total}")
        # K2: C in {1, 2, 4}, negative keys; also against numpy FNV
        for c in (1, 2, 4):
            keys = rint(-2**31, INT32_MAX, (n, c))
            kern = hash_rows_kernel(keys)
            same("hash_rows", kern, hash_rows_ref(keys), f"K2 n={n} c={c}")
            if n <= 65537:
                want = hash_rows_np(keys.cpu().numpy()).view(np.int32)
                if not np.array_equal(kern.cpu().numpy(), want):
                    raise AssertionError(f"K2 n={n} c={c}: differs from "
                                         f"hash_rows_np")
        # K3: sorted keys with a run of INT32_MAX (the reference's pad
        # value, an ordinary key here), a wide run, INT32_MIN ties,
        # all-equal
        top = torch.sort(rint(INT32_MAX - 8, INT32_MAX, (n,)))[0]
        top[n - n // 3:] = INT32_MAX
        wide = torch.sort(rint(-2**31, INT32_MAX, (n,)))[0]
        low = torch.sort(rint(-2**31, -2**31 + 3, (n,)))[0]
        for k in (top, wide, low, torch.full_like(top, 7)):
            bk, gk = group_boundaries_kernel(k)
            br, gr = group_boundaries_ref(k)
            same("group_boundaries", bk, br, f"K3 bnd n={n}")
            same("group_boundaries", gk, gr, f"K3 gid n={n}")
        # K6: all-equal, uniform and skewed digits
        for d in k6_digit_cases(n, g, device):
            base = RC.exclusive_bases(d, 256)
            same("radix_rank", radix_rank_kernel(d, base),
                 radix_rank_torch(d, base), f"K6 n={n}")
        # K10: P in {1, 2, 4, 8, 32}, uniform / one-bucket / half-hot
        # destinations, fixed-stride or random exclusive offsets
        for _, p, dkind, bkind in PC.sweep((n,)):
            d = PC.dest_case(dkind, n, p, g, device)
            b = PC.base_case(bkind, d, p, g)
            same("shard_rank", shard_rank_kernel(d, b),
                 shard_rank_torch(d, b, p),
                 f"K10 n={n} p={p} {dkind} {bkind}")
        # K5: every op and dtype over spread/hot/sorted ids
        for gs in g_sizes:
            for dt in (torch.int32, torch.float32):
                for op in ("sum", "min", "max"):
                    fsum = op == "sum" and dt == torch.float32
                    for v, sg in k5_cases(n, gs, dt, g, device, fsum):
                        kern = segment_reduce_kernel(v, sg, gs, op)
                        what = f"K5 {op} {dt} n={n} g={gs}"
                        if fsum:
                            err, ratio = sum_error(kern, v, sg, gs)
                            errs["segment_reduce_f32_sum"] = max(
                                errs.get("segment_reduce_f32_sum", 0.0), err)
                            errs["segment_reduce_f32_sum_over_bound"] = max(
                                errs.get("segment_reduce_f32_sum_over_bound",
                                         0.0), ratio)
                            cases["segment_reduce"] += 1
                            continue
                        plain = segment_reduce_torch(v, sg, gs, op)
                        if kern.dtype != plain.dtype or not torch.equal(
                                minmax_bits(kern), minmax_bits(plain)):
                            raise AssertionError(f"{what}: kernel differs "
                                                 f"from its plain version")
                        cases["segment_reduce"] += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cases, errs


def check_lookback(device, sizes=None, repeats=None, seed: int = 2):
    """K1, K4 and K3 over ``scan_cases``: every size and input kind (K3:
    every key kind), each call repeated ``repeats`` times against one
    plain result, the views at ``scan_cases.OFFSETS``, and on a card the
    graph replays and two streams. Returns the cases compared per
    kernel."""
    import torch

    from repro_torch.kernels import scan_cases as SC
    from repro_torch.kernels.compact.compact import prefix_count_kernel
    from repro_torch.kernels.compact.ref import prefix_count_torch
    from repro_torch.kernels.expand.expand import running_segment_ids_kernel
    from repro_torch.kernels.expand.ref import running_segment_ids_torch
    from repro_torch.kernels.hash_dedup.group_build import (
        group_boundaries_kernel)
    from repro_torch.kernels.hash_dedup.ref import group_boundaries_ref

    sizes = SC.SIZES if sizes is None else sizes
    repeats = SC.REPEATS if repeats is None else repeats
    g = torch.Generator(device=device).manual_seed(seed)
    k3 = SC.boundaries(group_boundaries_kernel)
    k3_plain = SC.boundaries(group_boundaries_ref)
    pairs = (("prefix_count", prefix_count_kernel, prefix_count_torch,
              SC.KINDS, SC.make_input, ("small", "ones")),
             ("running_segment_ids", running_segment_ids_kernel,
              running_segment_ids_torch, SC.KINDS, SC.make_input,
              ("small", "ones")),
             ("group_boundaries", k3, k3_plain, SC.KEY_KINDS, SC.make_keys,
              ("random", "increasing")))
    cases = {p[0]: 0 for p in pairs}
    for n in sizes:
        for name, kernel, plain, kinds, make, graphed in pairs:
            xs = {kind: make(kind, n, g, device) for kind in kinds}
            for kind, x in xs.items():
                want = plain(x)
                for r in range(repeats):
                    _same(kernel(x), want, f"{name} n={n} {kind} rep {r}")
                for off in SC.OFFSETS:
                    _same(kernel(SC.misaligned(x, off)), want,
                          f"{name} n={n} {kind} offset {off}")
                cases[name] += repeats + len(SC.OFFSETS)
            if device.type == "cuda":
                two = [xs[kind] for kind in graphed]
                wants = [plain(x) for x in two]
                cases[name] += SC.graph_replays(kernel, two, wants)
                cases[name] += SC.two_streams(kernel, two, wants)
            del xs
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cases


def check_reduce(device, sizes=None, segments=None, seed: int = 4):
    """K5 over ``reduce_cases``: every size, segment count, op, dtype and
    id kind against the plain version, the views at
    ``reduce_cases.OFFSETS``, and on a card the graph replays (int32
    sum, float32 min and max) and two streams. Returns the cases
    compared."""
    import torch

    from repro_torch.kernels import reduce_cases as RD
    from repro_torch.kernels import scan_cases as SC
    from repro_torch.kernels.segmented_reduce.ref import segment_reduce_torch
    from repro_torch.kernels.segmented_reduce.segmented_reduce import (
        segment_reduce_kernel)

    sizes = RD.SIZES if sizes is None else sizes
    segments = RD.SEGMENTS if segments is None else segments
    g = torch.Generator(device=device).manual_seed(seed)
    cases = 0
    for n in sizes:
        for gs in segments:
            ids = {k: RD.make_ids(k, n, gs, g, device) for k in RD.ID_KINDS}
            for dt in RD.DTYPES:
                for op in RD.OPS:
                    fsum = op == "sum" and dt == torch.float32
                    v = RD.make_values(dt, n, g, device, finite=fsum)
                    for kind, s in ids.items():
                        want = segment_reduce_torch(v, s, gs, op)
                        views = [(v, s)] + [
                            (RD.misaligned(v, o), RD.misaligned(s, o))
                            for o in RD.OFFSETS if kind == "uniform"]
                        for vv, ss in views:
                            got = segment_reduce_kernel(vv, ss, gs, op)
                            if not RD.held(got, want, v, s, gs, op):
                                raise AssertionError(
                                    f"K5 {op} {dt} n={n} g={gs} {kind} "
                                    f"offset {vv.storage_offset()}: "
                                    f"differs from its plain version")
                            cases += 1
            if device.type == "cuda" and gs in (120, 256):
                for dt, op in ((torch.int32, "sum"), (torch.float32, "min"),
                               (torch.float32, "max")):
                    two = [RD.packed(RD.make_values(dt, n, g, device),
                                     ids[k]) for k in ("uniform", "hot")]
                    wants = [segment_reduce_torch(
                        x[:n].view(dt), x[n:], gs, op).view(torch.int32)
                        for x in two]
                    kernel = RD.unpacking(segment_reduce_kernel, n, dt, gs,
                                          op)
                    cases += SC.graph_replays(kernel, two, wants,
                                              RD.REPLAYS)
                    cases += SC.two_streams(kernel, two, wants)
            del ids
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cases


def check_radix(device, sizes=None, repeats=None, seed: int = 3):
    """K6 over ``radix_cases``: every size, digit kind and bucket count,
    each call repeated ``repeats`` times against one plain result, at
    B <= 32 also against K10, and on a card the graph replays and two
    streams. Returns the cases compared."""
    import torch

    from repro_torch.kernels import radix_cases as RC
    from repro_torch.kernels import scan_cases as SC
    from repro_torch.kernels.hash_join.hash_join import (
        radix_rank_kernel, radix_rank_torch)
    from repro_torch.kernels.partition.partition import (
        MAX_SHARDS, shard_rank_kernel)

    sizes = RC.SIZES if sizes is None else sizes
    repeats = RC.REPEATS if repeats is None else repeats
    g = torch.Generator(device=device).manual_seed(seed)
    cases = 0
    for n in sizes:
        for buckets in RC.BUCKETS:
            for kind in RC.KINDS:
                d = RC.make_digits(kind, n, buckets, g, device)
                base = RC.exclusive_bases(d, buckets)
                want = radix_rank_torch(d, base)
                for r in range(repeats):
                    _same(radix_rank_kernel(d, base), want,
                          f"K6 n={n} B={buckets} {kind} rep {r}")
                cases += repeats
                if buckets <= MAX_SHARDS:
                    _same(radix_rank_kernel(d, base),
                          shard_rank_kernel(d, base),
                          f"K6 against K10 n={n} B={buckets} {kind}")
                    cases += 1
        if device.type == "cuda":
            for buckets in (4, 256):
                ds = [RC.make_digits(kind, n, buckets, g, device)
                      for kind in ("uniform", "skewed")]
                bases = [RC.exclusive_bases(d, buckets) for d in ds]
                xs = [RC.packed(d, b) for d, b in zip(ds, bases)]
                wants = [radix_rank_torch(d, b) for d, b in zip(ds, bases)]
                kernel = RC.unpacking(radix_rank_kernel, n)
                cases += SC.graph_replays(kernel, xs, wants, RC.REPLAYS)
                cases += SC.two_streams(kernel, xs, wants)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cases


def check_shard(device, sizes=None, repeats=None, seed: int = 4):
    """K10 over ``partition_cases``: every size, shard count,
    destination kind and offset kind, each call repeated ``repeats``
    times against one plain result with one launch counted per call,
    and on a card the graph replays and two streams at P = 4 and 32.
    Returns the cases compared."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import partition_cases as PC
    from repro_torch.kernels import radix_cases as RC
    from repro_torch.kernels import scan_cases as SC
    from repro_torch.kernels.partition.partition import shard_rank_kernel
    from repro_torch.kernels.partition.ref import shard_rank_torch

    sizes = PC.SIZES if sizes is None else sizes
    repeats = PC.REPEATS if repeats is None else repeats
    g = torch.Generator(device=device).manual_seed(seed)
    cases = 0
    for n, p, dkind, bkind in PC.sweep(sizes):
        d = PC.dest_case(dkind, n, p, g, device)
        b = PC.base_case(bkind, d, p, g)
        want = shard_rank_torch(d, b, p)
        before = _build.LAUNCHES["shard_rank"]
        for r in range(repeats):
            _same(shard_rank_kernel(d, b), want,
                  f"K10 n={n} p={p} {dkind} {bkind} rep {r}")
        launched = _build.LAUNCHES["shard_rank"] - before
        if device.type == "cuda" and launched != repeats:
            raise AssertionError(f"K10: {launched} launches for {repeats} "
                                 f"calls")
        cases += repeats
    if device.type == "cuda":
        for n in sizes:
            for p in (4, 32):
                ds = [PC.dest_case(k, n, p, g, device)
                      for k in ("uniform", "half")]
                bases = [PC.base_case(k, d, p, g)
                         for k, d in zip(PC.BASES, ds)]
                xs = [RC.packed(d, b) for d, b in zip(ds, bases)]
                wants = [shard_rank_torch(d, b, p)
                         for d, b in zip(ds, bases)]
                kernel = RC.unpacking(shard_rank_kernel, n)
                cases += SC.graph_replays(kernel, xs, wants, PC.REPLAYS)
                cases += SC.two_streams(kernel, xs, wants)
        torch.cuda.synchronize(device)
    return cases


# ---------------------------------------------------------------- the e2e

PHI_SEASONAL = ("Is the category '{cats.name}' seasonal? "
                "Answer YES or NO.")


def e2e_tables(n_events: int, n_cats: int, seed: int = 0):
    """Columns of ``events(event_id, cat_id, region)`` and
    ``cats(cat_id, name)``, made from ``seed``; ~20% of the events
    reference no category."""
    rng = np.random.default_rng(seed)
    events = {
        "event_id": np.arange(n_events, dtype=np.int64),
        "cat_id": rng.integers(0, int(n_cats * 1.25), n_events),
        "region": rng.integers(0, 16, n_events),
    }
    seasonal = rng.random(n_cats) < 0.5
    words = np.array(["winter", "garden", "office", "beach", "kitchen",
                      "travel", "school", "holiday"])
    kind = words[rng.integers(0, len(words), n_cats)]
    cats = {
        "cat_id": np.arange(n_cats, dtype=np.int64),
        "name": [f"{k} goods line {i}" for i, k in enumerate(kind)],
        "_seasonal": seasonal,
    }
    truths = {PHI_SEASONAL: lambda ctx: bool(ctx["cats"]["_seasonal"])}
    return {"events": events, "cats": cats}, {"cats": ["name"]}, truths


def e2e_plan(Q, col):
    return (Q.scan("events")
            .where(col("events.region") != 3)
            .join(Q.scan("cats"), "events.cat_id", "cats.cat_id")
            .sem_filter(PHI_SEASONAL)
            .group_by(["events.region", "cats.cat_id"],
                      [("count", "*", "n"), ("sum", "events.event_id", "s"),
                       ("avg", "events.event_id", "a")])
            .build())


def _freeze(recs):
    def fz(v):
        return "NaN" if isinstance(v, float) and v != v else v
    return [tuple((k, fz(v)) for k, v in sorted(r.items())) for r in recs]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_query(db, plan, out_cols, impl: str, split: dict | None = None,
              params: dict = SORT_MERGE):
    """Optimise ``plan`` under ``CostParams(**params)`` (by default the
    sort-merge configuration) and execute it at ``impl``. Returns
    (frozen rows, stats, backend calls); fills ``split`` with the
    host-clock seconds of each stage."""
    from repro_torch.core import CostParams, optimize
    from repro_torch.engine import Executor
    from repro_torch.semantic import OracleBackend, SemanticRunner

    t0 = time.perf_counter()
    cat = db.catalog()
    t1 = time.perf_counter()
    opt = optimize(plan, cat, strategy="cost", params=CostParams(**params))
    backend = OracleBackend(truths=db.truths)
    ex = Executor(db, SemanticRunner(backend), kernel_impl=impl)
    t2 = time.perf_counter()
    table, stats = ex.execute(opt.plan)
    _sync(db.device)
    t3 = time.perf_counter()
    rows = _freeze(db.materialize(table, list(out_cols)))
    _sync(db.device)
    t4 = time.perf_counter()
    if split is not None:
        split.update(catalog_s=t1 - t0, optimize_s=t2 - t1,
                     execute_s=t3 - t2, materialize_s=t4 - t3)
    return rows, stats, backend.calls


def hold_to_host(label: str, got, want) -> None:
    rows, stats, calls = got
    rows_h, stats_h, calls_h = want
    if rows != rows_h:
        raise AssertionError(f"{label}: rows differ from the host run "
                             f"({len(rows)} vs {len(rows_h)})")
    for f in STAT_FIELDS:
        if getattr(stats, f) != getattr(stats_h, f):
            raise AssertionError(f"{label}: {f} {getattr(stats, f)} != "
                                 f"host {getattr(stats_h, f)}")
    if calls != calls_h:
        raise AssertionError(f"{label}: backend calls {calls} != {calls_h}")
    if not all(np.isfinite(v) for r in rows for _, v in r
               if isinstance(v, float)):
        raise AssertionError(f"{label}: non-finite aggregate")


def run_e2e(device, n_events: int = 1 << 24, n_cats: int = 1 << 16
            ) -> dict:
    import torch

    from repro_torch.core import Q, col
    from repro_torch.engine import database_from_numpy
    from repro_torch.kernels import _build

    tables, texts, truths = e2e_tables(n_events, n_cats)
    t0 = time.perf_counter()
    db = database_from_numpy(tables, texts, truths, device=device)
    load_s = time.perf_counter() - t0
    out = ["events.region", "cats.cat_id", "agg.n", "agg.s", "agg.a"]
    plan = e2e_plan(Q, col)
    if db.device.type == "cuda":
        torch.cuda.synchronize(db.device)
        torch.cuda.reset_peak_memory_stats(db.device)
    _build.reset_launches()
    split = {}
    t0 = time.perf_counter()
    got = run_query(db, plan, out, "auto", split)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    shapes = dict(_build.MAX_SHAPES)
    peak = (torch.cuda.max_memory_allocated(db.device)
            if db.device.type == "cuda" else None)
    host_split = {}
    t0 = time.perf_counter()
    want = run_query(db, plan, out, "host", host_split)
    host_wall = time.perf_counter() - t0
    hold_to_host("e2e", got, want)
    if len(got[0]) == 0:
        raise AssertionError("e2e: empty result")
    return {"rows": len(got[0]), "n_events": n_events, "n_cats": n_cats,
            "load_s": load_s, "wall_s": wall, "split": split,
            "host_wall_s": host_wall, "host_split": host_split,
            "peak_device_bytes": peak, "launches": launches,
            "shapes": {k: list(v) for k, v in shapes.items()},
            "stats": {f: getattr(got[1], f) for f in STAT_FIELDS},
            "pipeline_syncs": got[1].pipeline_syncs,
            "join_physical": got[1].join_physical}


# ------------------------------------------------------- the e2e, hashed

def e2e_hash_tables(n_events: int, n_users: int, n_cats: int,
                    seed: int = 0):
    """``e2e_tables`` plus ``events.user_id`` (~9% dangling) and
    ``events.amount`` (finite float32), and ``users(user_id, tier)``
    with eight tiers."""
    tables, texts, truths = e2e_tables(n_events, n_cats, seed)
    rng = np.random.default_rng(seed + 1)
    ev = tables["events"]
    ev["user_id"] = rng.integers(0, int(n_users * 1.1), n_events)
    ev["amount"] = (rng.gamma(2.0, 50.0, n_events)
                    - 20.0).astype(np.float32)
    tables["users"] = {"user_id": np.arange(n_users, dtype=np.int64),
                       "tier": rng.integers(0, 8, n_users)}
    return tables, texts, truths


def e2e_hash_plan(Q, col):
    return (Q.scan("events")
            .where(col("events.region") != 3)
            .join(Q.scan("users"), "events.user_id", "users.user_id")
            .join(Q.scan("cats"), "events.cat_id", "cats.cat_id")
            .sem_filter(PHI_SEASONAL)
            .group_by(["events.region", "users.tier"],
                      [("count", "*", "n"),
                       ("min", "events.amount", "amin"),
                       ("max", "events.amount", "amax"),
                       ("min", "events.event_id", "emin"),
                       ("max", "events.event_id", "emax")])
            .build())


def run_e2e_hash(device, n_events: int = 1 << 24, n_users: int = 1 << 22,
                 n_cats: int = 1 << 16) -> dict:
    import torch

    from repro_torch.core import Q, col
    from repro_torch.engine import database_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels.hash_join import ref as hj_ref

    tables, texts, truths = e2e_hash_tables(n_events, n_users, n_cats)
    t0 = time.perf_counter()
    db = database_from_numpy(tables, texts, truths, device=device)
    load_s = time.perf_counter() - t0
    out = ["events.region", "users.tier", "agg.n", "agg.amin", "agg.amax",
           "agg.emin", "agg.emax"]
    plan = e2e_hash_plan(Q, col)
    if db.device.type == "cuda":
        torch.cuda.synchronize(db.device)
        torch.cuda.reset_peak_memory_stats(db.device)
    _build.reset_launches()
    hj_ref.reset_loop_fetches()
    split = {}
    t0 = time.perf_counter()
    got = run_query(db, plan, out, "auto", split, params=DEFAULT)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    shapes = dict(_build.MAX_SHAPES)
    loop_fetches = dict(hj_ref.LOOP_FETCHES)
    peak = (torch.cuda.max_memory_allocated(db.device)
            if db.device.type == "cuda" else None)
    host_split = {}
    t0 = time.perf_counter()
    want = run_query(db, plan, out, "host", host_split, params=DEFAULT)
    host_wall = time.perf_counter() - t0
    hold_to_host("e2e_hash", got, want)
    if len(got[0]) == 0:
        raise AssertionError("e2e_hash: empty result")
    if got[1].join_physical != {"hash": 2}:
        raise AssertionError(f"e2e_hash: joins served by "
                             f"{got[1].join_physical}, not two hash joins")
    return {"rows": len(got[0]), "n_events": n_events, "n_users": n_users,
            "n_cats": n_cats, "load_s": load_s, "wall_s": wall,
            "split": split, "host_wall_s": host_wall,
            "host_split": host_split, "peak_device_bytes": peak,
            "launches": launches, "radix_passes": launches["radix_rank"],
            "loop_fetches": loop_fetches,
            "loop_check_every": hj_ref.LOOP_CHECK_EVERY,
            "shapes": {k: list(v) for k, v in shapes.items()},
            "stats": {f: getattr(got[1], f) for f in STAT_FIELDS},
            "pipeline_syncs": got[1].pipeline_syncs,
            "host_pipeline_syncs": want[1].pipeline_syncs,
            "join_physical": got[1].join_physical}


# ------------------------------------------------------------- the corpus

def corpus_specs(Q, col, S):
    """(qid, schema, out_cols, builder) — corpus queries Q5, Q13, Q16,
    Q23, Q25 and q8 of ``benchmarks/corpus.py``, built with the port's
    ``Q``: every schema, two-table semantic templates (the sem_joins of
    Q16 and Q25) and grouped aggregates."""
    return [
        ("Q5", "bookreview", ["books.title", "reviews.review_id"],
         lambda: (Q.scan("books")
                  .join(Q.scan("reviews"), "books.book_id",
                        "reviews.book_id")
                  .where(col("reviews.rating") >= 3)
                  .sem_filter(S.BOOKS_ABOUT_AI)
                  .sem_filter(S.REVIEW_POSITIVE)
                  .select("books.title", "reviews.review_id").build())),
        ("Q13", "yelp", ["businesses.biz_id", "agg.cnt"],
         lambda: (Q.scan("businesses")
                  .join(Q.scan("yreviews"), "businesses.biz_id",
                        "yreviews.biz_id")
                  .sem_filter(S.YELP_REVIEW_SERVICE)
                  .group_by(["businesses.biz_id"], [("count", "*", "cnt")])
                  .build())),
        ("Q16", "googlelocal", ["places.place_id", "greviews.review_id"],
         lambda: (Q.scan("places")
                  .where(col("places.rating") >= 4.5)
                  .sem_join(Q.scan("greviews")
                            .where(col("greviews.rating") <= 2)
                            .where(col("greviews.time") >= 2022),
                            S.GL_REVIEW_DESCRIBES_PLACE)
                  .select("places.place_id", "greviews.review_id").build())),
        ("Q23", "tpch", ["part.p_partkey", "supplier.s_suppkey"],
         lambda: (Q.scan("part")
                  .join(Q.scan("partsupp"), "part.p_partkey",
                        "partsupp.ps_partkey")
                  .join(Q.scan("supplier"), "partsupp.ps_suppkey",
                        "supplier.s_suppkey")
                  .where(col("part.p_size").between(1, 40))
                  .sem_filter(S.PART_FRAGILE)
                  .sem_filter(S.SUPPLIER_RELIABLE)
                  .select("part.p_partkey", "supplier.s_suppkey").build())),
        ("Q25", "tpch", ["supplier.s_suppkey", "nation.n_name"],
         lambda: (Q.scan("supplier")
                  .sem_join(Q.scan("nation"), S.NATION_MATCHES_SUPPLIER)
                  .select("supplier.s_suppkey", "nation.n_name").build())),
        ("q8", "ecommerce", ["products.product_id", "agg.cnt"],
         lambda: (Q.scan("products")
                  .join(Q.scan("previews"), "products.product_id",
                        "previews.product_id")
                  .sem_filter(S.ECOM_REVIEW_POSITIVE)
                  .group_by(["products.product_id"], [("count", "*", "cnt")])
                  .build())),
    ]


def run_corpus(device, scale: float = 1.0, params: dict = SORT_MERGE
               ) -> dict:
    from repro_torch.core import Q, col
    from repro_torch.data import SCHEMAS
    from repro_torch.data import schemas as S
    from repro_torch.kernels import _build

    dbs = {}
    out = {}
    _build.reset_launches()
    for qid, schema, cols, build in corpus_specs(Q, col, S):
        if schema not in dbs:
            dbs[schema] = SCHEMAS[schema](seed=0, scale=scale, device=device)
        db = dbs[schema]
        t0 = time.perf_counter()
        got = run_query(db, build(), cols, "auto", params=params)
        wall = time.perf_counter() - t0
        hold_to_host(qid, got, run_query(db, build(), cols, "host",
                                         params=params))
        out[qid] = {"rows": len(got[0]), "wall_s": wall,
                    "llm_calls": got[1].llm_calls,
                    "join_physical": got[1].join_physical}
    return {"queries": out, "launches": dict(_build.LAUNCHES)}


# ---------------------------------------------------------- the stream

def stream_plan(Q):
    """The fact table as the BUILD side of a hash join (so every append
    grows the incremental stream table), the semantic filter on the
    probe side's text, and a group-by with count and min/max."""
    return (Q.scan("cats")
            .join(Q.scan("events"), "cats.cat_id", "events.cat_id")
            .sem_filter(PHI_SEASONAL)
            .group_by(["events.region"],
                      [("count", "*", "n"), ("min", "events.amount", "lo"),
                       ("max", "events.event_id", "hi")])
            .build())


def run_stream(device, n_base: int = 1 << 20, n_batch: int = 1 << 16,
               n_batches: int = 8, n_cats: int = 1 << 16,
               impl: str = "auto") -> dict:
    """A ``StreamSession`` over an ``n_base``-row fact table, fed
    ``n_batches`` appends of ``n_batch`` rows; after every batch the
    standing output must equal a cold ``kernel_impl="host"`` run on the
    concatenated data, and the batch's LLM calls the cold run's delta."""
    import torch

    from repro_torch.core import CostParams, Q, optimize
    from repro_torch.engine import Executor, database_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels.sync import HOST_SYNCS
    from repro_torch.semantic import OracleBackend, SemanticRunner
    from repro_torch.streaming import StreamSession

    total = n_base + n_batch * n_batches
    tables, texts, truths = e2e_hash_tables(total, 1 << 10, n_cats, seed=3)
    ev = tables.pop("events")
    tables.pop("users")
    tables["events"] = {k: v[:n_base] for k, v in ev.items()}
    db = database_from_numpy(tables, texts, truths, device=device)
    out_cols = ["events.region", "agg.n", "agg.lo", "agg.hi"]
    plan = optimize(stream_plan(Q), db.catalog(), strategy="cost",
                    params=CostParams()).plan
    _build.reset_launches()
    sess = StreamSession(db, OracleBackend(truths=db.truths),
                         kernel_impl=impl)
    t0 = time.perf_counter()
    sq = sess.register("q", plan, out_cols=out_cols)
    prime_s = time.perf_counter() - t0
    prev_cold_llm = sq.last_stats.llm_calls
    names = list(ev)
    batches = []
    for b in range(n_batches):
        lo = n_base + b * n_batch
        cols = {k: ev[k][lo:lo + n_batch].tolist() for k in names}
        recs = [dict(zip(names, row)) for row in zip(*cols.values())]
        probe0 = HOST_SYNCS.by_site.get("stream_probe", 0)
        t0 = time.perf_counter()
        d = sess.ingest("events", recs)["q"]
        if db.device.type == "cuda":
            torch.cuda.synchronize(db.device)
        ingest_s = time.perf_counter() - t0
        cold_ex = Executor(db, SemanticRunner(OracleBackend(
            truths=db.truths)), kernel_impl="host")
        cold_t, cold_st = cold_ex.execute(plan)
        cold = _freeze(db.materialize(cold_t, out_cols))
        if _freeze(d.output) != cold:
            raise AssertionError(f"stream: batch {b} differs from the cold "
                                 f"host run")
        if d.stats.llm_calls != cold_st.llm_calls - prev_cold_llm:
            raise AssertionError(f"stream: batch {b} llm_calls "
                                 f"{d.stats.llm_calls} != cold delta")
        prev_cold_llm = cold_st.llm_calls
        build = sess.ctx.builds[("events", "events.cat_id")]
        batches.append({
            "batch": b, "rows": db.tables["events"].capacity,
            "ingest_refresh_s": ingest_s,
            "stream_probe_syncs": HOST_SYNCS.by_site.get("stream_probe", 0)
            - probe0,
            "pipeline_syncs": d.stats.pipeline_syncs,
            "llm_calls": d.stats.llm_calls,
            "join_physical": d.stats.join_physical,
            "rebuilds": build.rebuilds, "inserts": build.inserts})
    if not all(b["join_physical"].get("stream") for b in batches):
        raise AssertionError("stream: a batch's join was not served by the "
                             "stream table")
    return {"n_base": n_base, "n_batch": n_batch, "prime_s": prime_s,
            "batches": batches, "launches": dict(_build.LAUNCHES)}


# ------------------------------------------------- the partitioned tier

def _execute(ex, db, plan, out_cols, split: dict):
    """Execute ``plan`` with ``ex`` and materialise ``out_cols``. Returns
    (frozen rows, stats, collectives by site); fills ``split`` with the
    host-clock seconds of each stage."""
    from repro_torch.kernels.sync import HOST_SYNCS

    coll0 = dict(HOST_SYNCS.by_collective)
    t0 = time.perf_counter()
    table, stats = ex.execute(plan)
    _sync(db.device)
    t1 = time.perf_counter()
    rows = _freeze(db.materialize(table, list(out_cols)))
    _sync(db.device)
    split.update(execute_s=t1 - t0,
                 materialize_s=time.perf_counter() - t1)
    by = {k: v - coll0.get(k, 0) for k, v in HOST_SYNCS.by_collective.items()
          if v != coll0.get(k, 0)}
    return rows, stats, by


def run_e2e_sharded(device, n_events: int = 1 << 24, n_users: int = 1 << 22,
                    n_cats: int = 1 << 16, n_shards: int = 4,
                    impl: str = "auto") -> dict:
    """``e2e_hash``'s tables and query planned under
    ``CostParams(n_shards=4)`` and run by the mesh executor over
    ``n_shards`` shards of one card at ``impl``, cold then warm (the
    same executor: the build sides' layouts are cached), each held to
    the single-device run at ``impl`` and the host run on the same
    card. (On the CPU ``auto`` is the host path, which skips the mesh:
    rehearse there with ``impl="kernel"``.)"""
    import torch

    from repro_torch.core import CostParams, Q, col, optimize
    from repro_torch.core.plan import Aggregate, Join
    from repro_torch.engine import Executor, database_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.semantic import OracleBackend, SemanticRunner
    from repro_torch.sharding import make_data_mesh

    tables, texts, truths = e2e_hash_tables(n_events, n_users, n_cats)
    t0 = time.perf_counter()
    db = database_from_numpy(tables, texts, truths, device=device)
    load_s = time.perf_counter() - t0
    out = ["events.region", "users.tier", "agg.n", "agg.amin", "agg.amax",
           "agg.emin", "agg.emax"]
    mesh = make_data_mesh(n_shards, devices=[device] * n_shards)
    t0 = time.perf_counter()
    cat = db.catalog()
    t1 = time.perf_counter()
    plan = optimize(e2e_hash_plan(Q, col), cat, strategy="cost",
                    params=CostParams(n_shards=n_shards)).plan
    plan_split = {"catalog_s": t1 - t0,
                  "optimize_s": time.perf_counter() - t1}
    joins = sum(isinstance(n, Join) for n in plan.walk())
    aggs = sum(bool(isinstance(n, Aggregate) and n.group_by)
               for n in plan.walk())

    def executor(impl, m=None):
        backend = OracleBackend(truths=db.truths)
        return Executor(db, SemanticRunner(backend), kernel_impl=impl,
                        mesh=m), backend

    ex, backend = executor(impl, mesh)
    runs = {}
    for label in ("cold", "warm"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        _build.reset_launches()
        split = {}
        calls0 = backend.calls
        t0 = time.perf_counter()
        rows, stats, by = _execute(ex, db, plan, out, split)
        wall = time.perf_counter() - t0
        runs[label] = {
            "rows": rows, "stats": stats, "calls": backend.calls - calls0,
            "wall_s": wall, "split": split, "by_collective": by,
            "launches": dict(_build.LAUNCHES),
            "shapes": {k: list(v) for k, v in _build.MAX_SHAPES.items()},
            "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None)}
    want = {}
    for label in ("single", "host"):
        e, b = executor(impl if label == "single" else "host")
        split = {}
        t0 = time.perf_counter()
        rows, stats, _ = _execute(e, db, plan, out, split)
        want[label] = {"rows": rows, "stats": stats, "calls": b.calls,
                       "wall_s": time.perf_counter() - t0, "split": split}
    for label, run in runs.items():
        got = (run["rows"], run["stats"], run["calls"])
        for other, w in want.items():
            hold_to_host(f"e2e_sharded {label} vs {other}", got,
                         (w["rows"], w["stats"], w["calls"]))
        st = run["stats"]
        if st.join_physical != {"partitioned": joins}:
            raise AssertionError(f"e2e_sharded {label}: joins served by "
                                 f"{st.join_physical}")
        if not 0 < st.collective_ops <= 2 * joins + aggs:
            raise AssertionError(f"e2e_sharded {label}: "
                                 f"{st.collective_ops} collectives")
    if len(runs["cold"]["rows"]) == 0:
        raise AssertionError("e2e_sharded: empty result")

    def summary(run):
        st = run["stats"]
        return {k: v for k, v in run.items() if k not in ("rows", "stats")
                } | {"stats": {f: getattr(st, f) for f in STAT_FIELDS},
                     "collective_ops": st.collective_ops,
                     "pipeline_syncs": st.pipeline_syncs,
                     "join_physical": st.join_physical}

    return {"rows": len(runs["cold"]["rows"]), "n_events": n_events,
            "n_users": n_users, "n_cats": n_cats, "n_shards": n_shards,
            "mesh": [str(d) for d in mesh.devices],
            "collective_budget": 2 * joins + aggs, "load_s": load_s,
            "plan_split": plan_split,
            "cold": summary(runs["cold"]), "warm": summary(runs["warm"]),
            "single_wall_s": want["single"]["wall_s"],
            "single_split": want["single"]["split"],
            "single_pipeline_syncs": want["single"]["stats"].pipeline_syncs,
            "host_wall_s": want["host"]["wall_s"],
            "host_split": want["host"]["split"]}


def sharded_stream_tables(n_facts: int, n_dims: int, seed: int = 0):
    """``benchmarks/bench_sharded.py``'s workload as columns: facts
    ``(fact_id, k1 in [0, 500), k2 in [0, 40), dim_id, v)`` and dims
    ``(dim_id, weight)``, made from ``seed``."""
    rng = np.random.default_rng(seed)
    facts = {"fact_id": np.arange(n_facts),
             "k1": rng.integers(0, 500, n_facts),
             "k2": rng.integers(0, 40, n_facts),
             "dim_id": rng.integers(0, n_dims, n_facts),
             "v": rng.normal(size=n_facts).astype(np.float32)}
    dims = {"dim_id": np.arange(n_dims),
            "weight": rng.normal(size=n_dims).astype(np.float32)}
    return {"facts": facts, "dims": dims}


def sharded_stream_plans(Q):
    agg = (Q.scan("facts")
           .group_by(["facts.k1", "facts.k2"],
                     aggs=[("count", "facts.v", "n"),
                           ("min", "facts.v", "lo"),
                           ("max", "facts.v", "hi")])
           .build())
    join = (Q.scan("facts")
            .join(Q.scan("dims"), "facts.dim_id", "dims.dim_id").build())
    return {"aggregate": (agg, ["facts.k1", "facts.k2", "agg.n", "agg.lo",
                                "agg.hi"], 1, 0),
            "join": (join, ["facts.fact_id", "dims.dim_id", "dims.weight"],
                     2, 1)}


def run_sharded_stream(device, n_facts: int = 1 << 24, n_dims: int = 1 << 16,
                       queries: int = 8, n_shards: int = 4,
                       impl: str = "auto") -> dict:
    """The grouped aggregate and the join of ``bench_sharded.py``, each
    run ``queries`` times by the mesh executor (``n_shards`` shards of
    one card) and by the single-device executor: every run's output
    columns identical, the reference's collective budget (aggregate
    <= 1 cold and 0 warm, join <= 2 cold and exactly 1 warm), per-query
    walls of both. (Rehearse on the CPU with ``impl="kernel"``.)"""
    from repro_torch.core import Q
    from repro_torch.engine import Executor, database_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels.util import to_numpy
    from repro_torch.semantic import OracleBackend, SemanticRunner
    from repro_torch.sharding import make_data_mesh

    db = database_from_numpy(sharded_stream_tables(n_facts, n_dims),
                             device=device)
    mesh = make_data_mesh(n_shards, devices=[device] * n_shards)
    runner = SemanticRunner(OracleBackend(truths={}))
    single = Executor(db, runner, kernel_impl=impl)
    part = Executor(db, runner, kernel_impl=impl, mesh=mesh)
    out = {"n_facts": n_facts, "n_dims": n_dims, "queries": queries,
           "n_shards": n_shards, "mesh": [str(d) for d in mesh.devices]}
    for name, (plan, cols, cold_max, warm) in sharded_stream_plans(
            Q).items():
        res = {}
        for label, ex in (("partitioned", part), ("single", single)):
            walls, colls, launches, last = [], [], [], None
            for _ in range(queries):
                _build.reset_launches()
                t0 = time.perf_counter()
                table, stats = ex.execute(plan)
                _sync(db.device)
                walls.append(time.perf_counter() - t0)
                colls.append(stats.collective_ops)
                launches.append(dict(_build.LAUNCHES))
                t = table.compact()
                cur = [to_numpy(t.col(c)) for c in cols]
                if last is not None and not all(
                        np.array_equal(a, b, equal_nan=True)
                        for a, b in zip(cur, last)):
                    raise AssertionError(f"sharded_stream {name} {label}: "
                                         f"a rerun's output differs")
                last = cur
            res[label] = {"walls_s": walls, "collectives": colls,
                          "launches": launches[0],
                          "warm_launches": launches[-1], "out": last}
        p, s = res["partitioned"], res["single"]
        if not all(np.array_equal(a, b, equal_nan=True)
                   for a, b in zip(p.pop("out"), s.pop("out"))):
            raise AssertionError(f"sharded_stream {name}: mesh output "
                                 f"differs from the single-device run")
        if p["collectives"][0] > cold_max or any(
                c != warm for c in p["collectives"][1:]):
            raise AssertionError(f"sharded_stream {name}: collectives "
                                 f"{p['collectives']} (budget {cold_max} "
                                 f"cold, {warm} warm)")
        if any(s["collectives"]):
            raise AssertionError(f"sharded_stream {name}: the single-device "
                                 f"run exchanged")
        res["rows_out"] = int(table.num_valid)
        out[name] = res
    return out


# ------------------------------------------------------- attention kernels

def check_attention(device, seq=None, groups=None, dims=None,
                    cache_lens=None, windows=None, window_seq=None,
                    ring_windows=None, seed: int = 0) -> dict:
    """K7 and K8 against their plain versions on ``device`` (unit-normal
    inputs from ``seed``, in the model's layouts) over the sweep of
    ``attention_cases`` (or the given one): K7 causal and not, and
    causal with a sliding window; K8 with per-row lengths, and with the
    slot mask over a wrapped ring; then head_dim 256 (K7 causal, not
    and windowed, K8 under both masks, at ``WIDE_GROUPS``), K7 not
    causal with Sq != Sk (``CROSS_QUERIES`` x ``CROSS_KEYS``) and the
    VLM's prefix route (``prefix_attention``: two K7 calls) against the
    plain prefix-mask attention (``PREFIX_CASES``); raises above its
    tolerance. Returns the cases and the worst max|Δ| per kernel and
    mask."""
    import torch

    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, prefix_attention)
    from repro_torch.kernels.flash_attention.ref import (
        attention_prefix_ref, attention_ref)

    seq = seq or AC.SEQ_LENS
    groups = groups or AC.GROUPS
    dims = dims or AC.HEAD_DIMS
    cache_lens = cache_lens or AC.CACHE_LENS
    windows = windows or AC.WINDOWS
    window_seq = window_seq or AC.WINDOW_SEQ
    ring_windows = ring_windows or AC.RING_WINDOWS
    impl = "kernel" if device.type == "cuda" else "ref"
    g = torch.Generator(device=device).manual_seed(seed)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0,
            "flash_attention_window": 0.0, "decode_attention_ring": 0.0,
            "flash_attention_wide": 0.0, "decode_attention_wide": 0.0,
            "flash_attention_cross": 0.0, "flash_attention_prefix": 0.0}
    cases = dict.fromkeys(errs, 0)

    def hold(name, got, want, what):
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not err <= AC.TOLERANCE:
            raise AssertionError(f"{what}: max|diff| {err} > "
                                 f"{AC.TOLERANCE}")
        errs[name] = max(errs[name], err)
        cases[name] += 1

    K, B = 2, 2
    for d in dims:
        for grp in groups:
            H = grp * K
            for S in seq:
                q = torch.randn(B, S, H, d, generator=g, device=device)
                k = torch.randn(B, S, K, d, generator=g, device=device)
                v = torch.randn(B, S, K, d, generator=g, device=device)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                for causal in (True, False):
                    hold("flash_attention",
                         flash_attention(qt, kt, vt, causal=causal,
                                         impl=impl),
                         attention_ref(qt, kt, vt, causal=causal),
                         f"K7 S={S} group={grp} d={d} causal={causal}")
            for T in cache_lens:
                lens = AC.decode_lengths(T)
                lengths = torch.tensor(lens, dtype=torch.int32,
                                       device=device)
                Bd = len(lens)
                q = torch.randn(Bd, H, d, generator=g, device=device)
                kc = torch.randn(Bd, T, K, d, generator=g, device=device)
                vc = torch.randn(Bd, T, K, d, generator=g, device=device)
                kt, vt = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
                hold("decode_attention",
                     decode_attention(q, kt, vt, lengths, impl=impl),
                     decode_attention_ref(q, kt, vt, lengths),
                     f"K8 T={T} lengths={lens} group={grp} d={d}")
            S = window_seq
            q = torch.randn(B, S, H, d, generator=g, device=device)
            k = torch.randn(B, S, K, d, generator=g, device=device)
            v = torch.randn(B, S, K, d, generator=g, device=device)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            for w in windows:
                hold("flash_attention_window",
                     flash_attention(qt, kt, vt, causal=True, window=w,
                                     impl=impl),
                     attention_ref(qt, kt, vt, causal=True, window=w),
                     f"K7 S={S} window={w} group={grp} d={d}")
            for W in ring_windows:
                rows = AC.ring_rows(W)
                sp = torch.tensor(AC.ring_slot_pos(W, rows),
                                  dtype=torch.int32, device=device)
                pos = torch.tensor([p for _, p in rows], dtype=torch.int32,
                                   device=device)
                Bd = len(rows)
                q = torch.randn(Bd, H, d, generator=g, device=device)
                kc, vc = (torch.randn(Bd, W, K, d, generator=g,
                                      device=device).permute(0, 2, 1, 3)
                          for _ in range(2))
                hold("decode_attention_ring",
                     decode_attention(q, kc, vc, slot_pos=sp, pos=pos,
                                      window=W, impl=impl),
                     decode_attention_ref(q, kc, vc, slot_pos=sp, pos=pos,
                                          window=W),
                     f"K8 ring W={W} rows={rows} group={grp} d={d}")

    def bshd(B, S, n, d):  # the model's (B, S, heads, d), transposed
        return torch.randn(B, S, n, d, generator=g,
                           device=device).transpose(1, 2)

    d, K = AC.WIDE_HEAD_DIM, 1
    for grp in AC.WIDE_GROUPS:
        for S in seq:
            q, k, v = bshd(B, S, grp, d), bshd(B, S, K, d), bshd(B, S, K, d)
            for causal, w in ((True, 0), (False, 0), (True, 17)):
                hold("flash_attention_wide",
                     flash_attention(q, k, v, causal=causal, window=w,
                                     impl=impl),
                     attention_ref(q, k, v, causal=causal, window=w),
                     f"K7 d={d} S={S} group={grp} causal={causal} "
                     f"window={w}")
        for T in cache_lens + (1500,):
            lengths = torch.tensor(AC.chunk_lengths(T), dtype=torch.int32,
                                   device=device)
            Bd = lengths.shape[0]
            q = torch.randn(Bd, grp, d, generator=g, device=device)
            kc, vc = (torch.randn(Bd, T, K, d, generator=g, device=device)
                      .permute(0, 2, 1, 3) for _ in range(2))
            hold("decode_attention_wide",
                 decode_attention(q, kc, vc, lengths, impl=impl),
                 decode_attention_ref(q, kc, vc, lengths),
                 f"K8 d={d} T={T} lengths={lengths.tolist()} group={grp}")
        W = ring_windows[-1]
        rows = AC.ring_rows(W)
        sp = torch.tensor(AC.ring_slot_pos(W, rows), dtype=torch.int32,
                          device=device)
        pos = torch.tensor([p for _, p in rows], dtype=torch.int32,
                           device=device)
        q = torch.randn(len(rows), grp, d, generator=g, device=device)
        kc, vc = (torch.randn(len(rows), W, K, d, generator=g,
                              device=device).permute(0, 2, 1, 3)
                  for _ in range(2))
        hold("decode_attention_wide",
             decode_attention(q, kc, vc, slot_pos=sp, pos=pos, window=W,
                              impl=impl),
             decode_attention_ref(q, kc, vc, slot_pos=sp, pos=pos,
                                  window=W),
             f"K8 d={d} ring W={W} group={grp}")
    for d in (64, AC.WIDE_HEAD_DIM):
        for Sq in AC.CROSS_QUERIES:
            for Sk in AC.CROSS_KEYS:
                q, k, v = bshd(B, Sq, 6, d), bshd(B, Sk, 2, d), \
                    bshd(B, Sk, 2, d)
                hold("flash_attention_cross",
                     flash_attention(q, k, v, causal=False, impl=impl),
                     attention_ref(q, k, v, causal=False),
                     f"K7 cross Sq={Sq} Sk={Sk} d={d}")
        for S, prefix in AC.PREFIX_CASES:
            q, k, v = bshd(B, S, 8, d), bshd(B, S, 1, d), bshd(B, S, 1, d)
            hold("flash_attention_prefix",
                 prefix_attention(q, k, v, prefix, impl=impl),
                 attention_prefix_ref(q, k, v, prefix),
                 f"K7 prefix route S={S} prefix={prefix} d={d}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"cases": cases, "max_abs_err": errs,
            "tolerance": AC.TOLERANCE}


def check_decode_split(device, groups=None, dims=(36, 64, 128),
                       seed: int = 4) -> dict:
    """K8 at the edges of its split over the cache (``attention_cases``):
    lengths at the chunk edges over 131- and 4104-position caches, a
    full 2048-slot ring, rings with dead chunks between live ones, each
    within the tolerance of the plain version and equal bit for bit on a
    second call; on a card, ``REPLAYS`` graph replays per mask on
    alternating inputs. Returns the cases and the worst max|diff|."""
    import torch

    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref)

    groups = groups or AC.GROUPS
    impl = "kernel" if device.type == "cuda" else "ref"
    g = torch.Generator(device=device).manual_seed(seed)
    out = {"cases": 0, "max_abs_err": 0.0, "graph_replays": 0}

    def operands(B, H, K, T, d):
        q = torch.randn(B, H, d, generator=g, device=device)
        kc, vc = (torch.randn(B, T, K, d, generator=g, device=device)
                  .permute(0, 2, 1, 3) for _ in range(2))
        return q, kc, vc

    def hold(run, want, what):
        got = run()
        err = float((got - want).abs().max())
        if not err <= AC.TOLERANCE or not torch.equal(run(), got):
            raise AssertionError(f"K8 {what}: max|diff| {err} > "
                                 f"{AC.TOLERANCE}, or a second call "
                                 f"differs")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["cases"] += 1

    sp_full, pos_full = AC.full_ring()
    rows, gpos, W = AC.gapped_ring()
    for d in dims:
        for grp in groups:
            K = 2
            for T in (131, AC.LONG_CACHE):
                lengths = torch.tensor(AC.chunk_lengths(T),
                                       dtype=torch.int32, device=device)
                q, kc, vc = operands(lengths.shape[0], grp * K, K, T, d)
                hold(lambda: decode_attention(q, kc, vc, lengths, impl=impl),
                     decode_attention_ref(q, kc, vc, lengths),
                     f"lengths {lengths.tolist()} group={grp} d={d}")
            for sp, pos, w in (([sp_full], [pos_full], AC.FULL_RING),
                               (rows, gpos, W)):
                spt = torch.tensor(sp, dtype=torch.int32, device=device)
                post = torch.tensor(pos, dtype=torch.int32, device=device)
                q, kc, vc = operands(len(sp), grp * K, K, len(sp[0]), d)
                hold(lambda: decode_attention(q, kc, vc, slot_pos=spt,
                                              pos=post, window=w, impl=impl),
                     decode_attention_ref(q, kc, vc, slot_pos=spt, pos=post,
                                          window=w),
                     f"ring of {len(sp[0])} group={grp} d={d}")
    if device.type == "cuda":
        from repro_torch.kernels.decode_attention.decode_attention import (
            decode_attention_kernel)

        lens = [torch.randint(1, 132, (16,), generator=g, device=device,
                              dtype=torch.int32) for _ in range(2)]
        xs = [(*operands(16, 24, 2, 131, 128), n) for n in lens]
        out["graph_replays"] += AC.graph_replays(
            decode_attention_kernel, xs,
            [decode_attention_ref(*x) for x in xs])
        spt = torch.tensor([sp_full], dtype=torch.int32, device=device)
        post = torch.tensor([pos_full], dtype=torch.int32, device=device)
        dead = torch.where(torch.arange(AC.FULL_RING, device=device) % 96
                           < 32, spt, -1)
        xs = [(*operands(1, 25, 5, AC.FULL_RING, 64), s, post)
              for s in (spt, dead)]

        def ring(q, k, v, s, p):
            return decode_attention_kernel(q, k, v, slot_pos=s, pos=p,
                                           window=AC.FULL_RING)

        out["graph_replays"] += AC.graph_replays(
            ring, xs, [decode_attention_ref(q, k, v, slot_pos=s, pos=p,
                                            window=AC.FULL_RING)
                       for q, k, v, s, p in xs])
        torch.cuda.synchronize(device)
    return out


# ------------------------------------------------------------ SSD kernel

def check_ssd(device, cases=None, oracle=None, seed: int = 0) -> dict:
    """K9 against its plain version ``ssd_chunk_ref`` on ``device``, all
    four outputs, over the ``ssd_cases`` sweep (or ``cases``), on the
    model's input distribution and strided layout; then ``ops.ssd``
    (K9 plus the torch recurrence) against the sequential oracle at
    ``ssd_cases.ORACLE_CASE`` (or ``oracle``, (b, s, h, p, n, chunk)).
    Each output within ``ssd_cases.tolerance`` of max(1, max|plain|).
    Returns the cases, the worst kernel-vs-plain error, the oracle's
    error and the worst error over its allowance."""
    import torch

    from repro_torch.kernels import ssd_cases as SC
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref, ssd_reference
    from repro_torch.kernels.ssd.ssd import ssd_chunk_kernel

    cuda = device.type == "cuda"
    step = ssd_chunk_kernel if cuda else ssd_chunk_ref
    g = torch.Generator(device=device).manual_seed(seed)
    worst = {"max_abs_err": 0.0, "oracle_max_abs_err": 0.0,
             "err_over_allowance": 0.0}

    def hold(got, want, tol, what, key="max_abs_err"):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: non-finite output")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        allow = tol * max(1.0, float(want.abs().max()))
        if not err <= allow:
            raise AssertionError(f"{what}: max|diff| {err} > {allow}")
        worst[key] = max(worst[key], err)
        worst["err_over_allowance"] = max(worst["err_over_allowance"],
                                          err / allow)

    sweep = cases or SC.sweep()
    for b, s, h, p, n, chunk in sweep:
        x, dt, A, B, C = SC.case_inputs(b, s, h, p, n, chunk, g, device)
        tol = SC.tolerance(SC.cum_max(dt, A, chunk))
        got = step(x, dt, A, B, C, chunk=chunk)
        want = ssd_chunk_ref(x, dt, A, B, C, chunk)
        for name, a, w in zip(("y_diag", "states", "decay", "cum"), got,
                              want):
            hold(a, w, tol, f"K9 {name} (b,s,h,p,n,chunk)="
                            f"{(b, s, h, p, n, chunk)}")
    case = oracle or SC.ORACLE_CASE
    b, s, h, p, n, chunk = case
    x, dt, A, B, C = SC.oracle_inputs(g, device, case)
    y, _ = ssd_ops.ssd(x, dt, A, B, C, chunk,
                       impl="kernel" if cuda else "ref")
    hold(y, ssd_reference(x, dt, A, B, C),
         SC.tolerance(SC.cum_max(dt, A, chunk)),
         f"ops.ssd vs the sequential oracle {(b, s, h, p, n, chunk)}",
         key="oracle_max_abs_err")
    if cuda:
        torch.cuda.synchronize(device)
    return {"cases": len(sweep), "oracle_case": [b, s, h, p, n, chunk],
            **worst, "tolerance": "ssd_cases.tolerance(max|cum|) = "
            "1e-5 + 2^-23 max|cum|, relative to max(1, max|plain|)"}


# ------------------------------------------------------------ the serving

def serve_prompts(n: int, seed: int = 0) -> list[str]:
    """``n`` prompts of 4-150 words from a fixed vocabulary, made from
    ``seed`` (longer ones are cut at ``max_seq`` tokens)."""
    rng = np.random.default_rng(seed)
    words = ["is", "the", "review", "positive", "product", "winter",
             "garden", "seasonal", "category", "answer", "yes", "no",
             "book", "about", "machine", "learning", "service", "slow",
             "supplier", "reliable", "fragile", "part", "place", "rating"]
    return [" ".join(rng.choice(words, int(rng.integers(4, 151))))
            for _ in range(n)]


def serve_engine_pair(device, cfg, params, serve=SERVE):
    """Two engines on the same weights: the kernel path (K7/K8/K9,
    "auto"; the plain path on a CPU rehearsal) and the plain path
    ("ref": the grouped einsum and ``ssd_chunked``, no kernel)."""
    from repro_torch.serving import ServingEngine

    return tuple(ServingEngine(cfg, params, device=device, attn_impl=i,
                               ssd_impl=i, **serve) for i in ("auto", "ref"))


def path_launches(cfg, admissions: int, rounds: int) -> dict:
    """The LLM kernels' launches a served run must make: K7 and K9 once
    per layer per admission, K8 once per layer per round, as far as the
    family has grouped-query attention (K7/K8; MLA has no kernel, as the
    reference runs it outside any Pallas kernel) and SSM heads (K9)."""
    attn = cfg.family != "ssm" and not cfg.use_mla
    ssm = cfg.family in ("ssm", "hybrid")
    L = cfg.num_layers
    return {"flash_attention": L * admissions * attn,
            "decode_attention": L * rounds * attn,
            "ssd_chunk": L * admissions * ssm}


def timed_serve(eng, prompts) -> tuple[list[str], dict]:
    """``eng.answer(prompts)`` with CUDA events recorded around every
    ``_admit`` and ``_round`` call of its scheduler (set on the
    instance here, so the engine itself carries no timing): their sums
    and each call's ms (an ``_admit`` call with nothing to admit takes
    ~0)."""
    import torch

    sched = eng.scheduler
    events = {"_admit": [], "_round": []}
    cuda = eng.device.type == "cuda"

    def wrap(name):
        fn = getattr(sched, name)

        def run():
            if not cuda:
                t0 = time.perf_counter()
                fn()
                events[name].append(time.perf_counter() - t0)
                return
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events[name].append((a, b))
        setattr(sched, name, run)

    # a wrapper already set on the instance (``record_serving``'s) is
    # wrapped in turn and restored after
    saved = {name: sched.__dict__.get(name) for name in events}
    for name in events:
        wrap(name)
    t0 = time.perf_counter()
    try:
        answers = eng.answer(prompts)
        if cuda:
            torch.cuda.synchronize(eng.device)
    finally:
        for name in events:
            if saved[name] is None:
                delattr(sched, name)
            else:
                setattr(sched, name, saved[name])
    wall = time.perf_counter() - t0

    def each_ms(name):
        if not cuda:
            return [t * 1e3 for t in events[name]]
        return [a.elapsed_time(b) for a, b in events[name]]

    admits, rounds = each_ms("_admit"), each_ms("_round")
    return answers, {"wall_s": wall, "prefill_s": sum(admits) / 1e3,
                     "decode_s": sum(rounds) / 1e3,
                     "admit_calls_ms": admits, "round_calls_ms": rounds}


def record_serving(eng) -> dict:
    """Wrap ``take`` and ``_admit`` of ``eng``'s scheduler on the
    instance (``unrecord_serving`` removes them): the record gathers the
    token ids of every completed request, in the order its ticket was
    taken, and counts the admissions made while another slot was
    mid-decode (a live slot that has already emitted a token)."""
    sched = eng.scheduler
    rec = {"ids": [], "mid_decode_admissions": 0}
    take, admit = sched.take, sched._admit

    def take_recorded(ticket):
        out = take(ticket)
        rec["ids"].extend(list(ids) for ids in out)
        return out

    def admit_recorded():
        busy = any(sched._slot_req[s].out_ids for s in sched.live_slots())
        before = eng.stats.batches
        admit()
        if busy and eng.stats.batches > before:
            rec["mid_decode_admissions"] += 1

    sched.take, sched._admit = take_recorded, admit_recorded
    return rec


def unrecord_serving(eng) -> None:
    del eng.scheduler.take, eng.scheduler._admit


def staggered_serve(eng, prompts, first: int) -> tuple[list[str], dict]:
    """Submit ``first`` prompts, run one round, then submit the rest and
    drain: the two waves stay a round apart, so each later admission
    refills slots while the other wave is mid-decode."""
    rec = record_serving(eng)
    try:
        head = eng.submit(prompts[:first])
        eng.poll()
        tail = eng.submit(prompts[first:])
        eng.drain()
        answers = eng.answers(head) + eng.answers(tail)
    finally:
        unrecord_serving(eng)
    return answers, rec


def run_serve(device, arch: str = SERVE_ARCH, n_prompts: int = 256,
              seed: int = 0, tiny: bool = False, serve=SERVE) -> dict:
    """The serving path at full width (``tiny`` for a CPU rehearsal):
    weights from a seeded generator on ``device``, ``n_prompts`` prompts
    through the kernel-path engine and the plain engine. Returns the
    phase's numbers and keeps the engines under ``"engines"`` for
    ``run_llm_query`` and ``run_long_prefill``."""
    import torch

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels import _build
    from repro_torch.kernels.sync import HOST_SYNCS
    from repro_torch.models import count_params, init_params, prefill

    cfg = get_tiny(arch) if tiny else get_config(arch)
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(seed), device=device)
    if cuda:
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    kern, plain = serve_engine_pair(device, cfg, params, serve)
    prompts = serve_prompts(n_prompts, seed)
    out = {"arch": cfg.name, "params": count_params(cfg),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "family": cfg.family, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "attn_window":
           cfg.attn_window, "ssm_heads": cfg.ssm_num_heads * (
               cfg.family in ("ssm", "hybrid")), "ssm_state": cfg.ssm_state,
           "ssm_chunk": cfg.ssm_chunk, "prompts": n_prompts,
           **serve, "init_s": init_s,
           "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32]}
    if cfg.num_experts:
        out["moe"] = moe_predictions(cfg, serve)
    answers = {}
    for label, eng in (("kernel", kern), ("plain", plain)):
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        rounds0 = HOST_SYNCS.by_site.get("serving_round", 0)
        _build.reset_launches()
        answers[label], t = timed_serve(eng, prompts)
        launches = dict(_build.LAUNCHES)
        shapes = dict(_build.MAX_SHAPES)
        st = eng.stats
        padded = st.prefill_positions
        out[label] = {
            **t, "admissions": st.batches, "decode_rounds": st.decode_steps,
            "prefill_tokens": st.prefill_tokens, "prefill_padded": padded,
            "prefill_tokens_per_s": st.prefill_tokens / t["prefill_s"],
            "prefill_padded_per_s": padded / t["prefill_s"],
            "decode_slot_steps": st.slot_steps,
            "decode_slot_steps_per_s": st.slot_steps / t["decode_s"],
            "decode_tokens": st.decode_tokens,
            "serving_round_syncs": HOST_SYNCS.by_site.get(
                "serving_round", 0) - rounds0,
            "occupancy": st.occupancy,
            "launches": {k: launches[k] for k in LLM_KERNELS},
            "shapes": {k: list(v) for k, v in shapes.items()},
            "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                  if cuda else None)}
    name = cfg.name
    if answers["kernel"] != answers["plain"]:
        diff = sum(a != b for a, b in zip(answers["kernel"],
                                          answers["plain"]))
        raise AssertionError(f"serve {name}: {diff} of {n_prompts} answers "
                             f"differ between the kernel and plain paths")
    if len(answers["kernel"]) != n_prompts or not all(answers["kernel"]):
        raise AssertionError(f"serve {name}: missing answers")
    k = out["kernel"]
    if k["serving_round_syncs"] != k["decode_rounds"]:
        raise AssertionError(f"serve {name}: not one serving_round sync "
                             f"per round")
    if cuda:
        want = path_launches(cfg, k["admissions"], k["decode_rounds"])
        if k["launches"] != want:
            raise AssertionError(f"serve {name}: launches {k['launches']} "
                                 f"!= {want}")
        if any(out["plain"]["launches"].values()):
            raise AssertionError(f"serve {name}: the plain engine launched "
                                 f"{out['plain']['launches']}")
    # one admission's prefill logits and cache leaves, both paths
    toks = torch.from_numpy(np.stack([kern.encode_row(p)[0] for p in
                                      prompts[:serve["batch_size"]]])
                            ).to(device)
    lg, routes = {}, {}
    for eng in (kern, plain):
        with record_routes(routes.setdefault(eng.attn_impl, [])):
            lg[eng.attn_impl] = prefill(cfg, params, {"tokens": toks},
                                        max_seq=kern.cache_len,
                                        attn_impl=eng.attn_impl,
                                        ssd_impl=eng.ssd_impl)
    (la, ca), (lb, cb) = lg[kern.attn_impl], lg[plain.attn_impl]
    if cfg.num_experts:
        out["router_topk_diff"] = router_topk_diff(
            routes[kern.attn_impl], routes[plain.attn_impl])
    if not all(bool(torch.isfinite(x).all())
               for x in (la, *(v for n, v in ca.items()
                               if n != "slot_pos"))):
        raise AssertionError(f"serve {name}: non-finite prefill logits or "
                             f"cache")
    out["prefill_logit_max_abs_diff"] = float((la - lb).abs().max())
    out["prefill_logit_max_abs"] = float(lb.abs().max())
    if "k" in ca:
        out["prefill_kv_max_abs_diff"] = max(
            float((ca[n] - cb[n]).abs().max()) for n in ("k", "v"))
        if not torch.equal(ca["slot_pos"], cb["slot_pos"]):
            raise AssertionError(f"serve {name}: slot_pos differs")
    for n in ("state", "conv"):
        if n in ca:
            out[f"prefill_{n}_max_abs_diff"] = float(
                (ca[n] - cb[n]).abs().max())
            out[f"prefill_{n}_max_abs"] = float(cb[n].abs().max())
    out["answers_identical"] = True
    if cuda:
        out["breakdown"] = serve_breakdown(kern, toks, out["kernel"])
    if cfg.num_experts:
        k = out["kernel"]
        out["moe"]["measured"] = {
            "admission_eager_ms": k["prefill_s"] / k["admissions"] * 1e3,
            "round_eager_ms": k["decode_s"] / k["decode_rounds"] * 1e3,
            **{n: out.get("breakdown", {}).get(n) for n in (
                "prefill_graph_ms", "decode_round_graph_ms",
                "prefill_gemm_ms", "prefill_moe_gemm_ms")}}
    # slots freed and refilled mid-decode: waves half a batch apart
    b = serve["batch_size"]
    stag = {eng.attn_impl: staggered_serve(eng, prompts[:4 * b], b // 2)
            for eng in (kern, plain)}
    (ka, kr), (pa, pr) = stag[kern.attn_impl], stag[plain.attn_impl]
    if ka != pa or kr["ids"] != pr["ids"]:
        raise AssertionError(f"serve {name} (staggered): answers differ "
                             f"between the kernel and plain paths")
    if not kr["mid_decode_admissions"]:
        raise AssertionError(f"serve {name} (staggered): no slot was "
                             f"refilled mid-decode")
    out["staggered"] = {"prompts": 4 * b, "first_wave": b // 2,
                        "mid_decode_admissions": kr["mid_decode_admissions"],
                        "tokens_compared": sum(map(len, kr["ids"]))}
    # K8's lengths in a first decode round of these prompts: pos + 1
    out["decode_lengths"] = [kern.encode_row(p)[1] for p in
                             prompts[:serve["batch_size"]]]
    out["cache_len"] = kern.cache_len
    out["answer_sample"] = answers["kernel"][:4]
    out["answers"] = answers["kernel"]
    out["engines"] = (kern, plain)
    return out


def first_flip(engines, prompt: str, steps: int) -> dict:
    """Where greedy ids part between ``engines`` on ``prompt`` alone:
    each engine prefills a batch of it and decodes ``steps`` steps
    (feeding the first engine's token); at the first step whose argmax
    differs, each engine's top-2 logit gap."""
    import torch

    ref = engines[0]
    b = ref.batch_size  # a full batch of it, so any mesh splits it
    toks = torch.from_numpy(np.stack([ref.encode_row(prompt)[0]] * b)
                            ).to(ref.device)
    n = ref.encode_row(prompt)[1]
    runs = []
    for eng in engines:
        _, cache = eng._prefill(toks)
        runs.append([cache, toks[:, n - 1].clone(),
                     torch.full((b,), n - 1, dtype=torch.int32,
                                device=ref.device)])
    for step in range(steps):
        top = []
        for eng, run in zip(engines, runs):
            logits, _ = eng._decode(run[0], runs[0][1], run[2])
            top.append(torch.topk(logits[0].float(), 2))
        ids = [int(t.indices[0]) for t in top]
        if len(set(ids)) > 1:
            return {"step": step, "ids": ids,
                    "top2_gap": [float(t.values[0] - t.values[1])
                                 for t in top]}
        for run in runs:
            run[1] = top[0].indices[:1].to(torch.int32).expand(b)
            run[2] = run[2] + 1
    return {"step": None}


def tp_launches(cfg, grid, admissions: int, rounds: int,
                seq: bool = False) -> dict:
    """K7 once per layer per run per position per admission, K8 once per
    layer per run per position per round (every (data, model) position
    of ``grid``, a ``MeshGrid``, attends over its rows and heads, in
    ``sharding.model.head_runs``: one run, or up to three where its
    query heads straddle KV groups, hymba-1.5b's 25 over 5 at tp 2 and
    4); under ``shard_cache_seq`` (``seq``) K8 once per position with
    every head; K9 once per layer per data rank per admission (the
    SSM's weights are replicated over the tensor-parallel ranks, which
    share one call on one card)."""
    from repro_torch.sharding.model import head_runs

    want = path_launches(cfg, admissions, rounds)
    runs = sum(len(head_runs(cfg.num_heads, cfg.num_kv_heads, grid.tp, t))
               if grid.tp > 1 and cfg.num_heads else 1
               for t in range(grid.tp)) * grid.dp
    shards = {"ssd_chunk": grid.dp, "flash_attention": runs,
              "decode_attention": grid.dp * grid.tp if seq else runs}
    return {k: v * shards[k] for k, v in want.items()}


def mesh_label(mesh) -> tuple:
    """(dp, tp, policy replace keywords, label) of a mesh entry (dp, tp)
    or (dp, tp, keywords): "2x2", "2x2_dp_over_tp"."""
    dp, tp, rep = (*mesh, {})[:3]
    return dp, tp, rep, "_".join([f"{dp}x{tp}", *sorted(
        k for k, v in rep.items() if v)])


def run_serve_tp(device, arch: str = MOE_ARCH, meshes=TP_MESHES[MOE_ARCH],
                 params=None, single=None, n_prompts: int = MOE_PROMPTS,
                 seed: int = 0, tiny: bool = False, serve=SERVE) -> dict:
    """The serving path over model-parallel meshes whose positions all
    lie on ``device`` (``make_mesh(dp, tp, devices=[device] * n)``):
    the weights ``params`` (made from ``seed`` when None) laid out by
    ``shard_params`` over each mesh in turn ((dp, tp), or (dp, tp,
    policy keywords) such as ``dp_over_tp``), a kernel-path and a plain
    engine over the sharded tree, ``n_prompts`` prompts and the
    two-wave 64 on both: answers and token ids identical between the
    paths; wherever the layout gives one device's function (every
    family but the MoE, and the MoE at dp = 1, the single-device
    capacity) also identical to ``single`` (the single-device kernel
    engine's answers, served here when None), else their differences
    counted (capacity is per data rank's token chunk); K7/K8/K9
    launches per shard (``tp_launches``), layer and admission or round;
    the mesh's prefill logits against the single-device
    prefill at capacity factor E/k (no drops) within
    TP_LOGIT_TOLERANCE of max|logit| (LONG_TOLERANCE for the SSM and
    the hybrid, whose 48 and 32 layers of float32 SSD sums part in
    their last bits between GEMMs and K9 blocks of another row count:
    mamba2-370m's (2, 2) mesh lies 1.4e-4 from one device's on the
    H100); admission and round ms (CUDA
    events, eager: the round is a host loop over the shards) and peak
    memory. Each mesh's tree is freed before the next but the last,
    whose engines come back under ``"engines"``."""
    import torch

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params, prefill
    from repro_torch.models.params import shard_params
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding.model import local_config, mesh_grid
    from repro_torch.sharding.policy import ShardingPolicy

    cfg = get_tiny(arch) if tiny else get_config(arch)
    cuda = device.type == "cuda"
    if params is None:
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(seed), device=device)
    prompts = serve_prompts(n_prompts, seed)
    if single is None:
        single = ServingEngine(cfg, params, device=device,
                               **serve).answer(prompts)
    b = serve["batch_size"]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "prompts": n_prompts,
           **serve, "meshes": {}}
    engines = None
    for mesh in meshes:
        dp, tp, rep, label = mesh_label(mesh)
        n = dp * tp
        pol = ShardingPolicy.for_mesh(make_mesh(
            dp, tp, devices=[device] * n)).replace(**rep)
        grid = mesh_grid(pol)
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        sp = shard_params(cfg, params, pol)
        if cuda:
            torch.cuda.synchronize(device)
        loc = local_config(cfg, mesh_grid(pol))
        mem = {"sharded": torch.cuda.memory_allocated(device)
               if cuda else None}
        res = {"dp": dp, "tp": tp, **rep,
               "grid": [grid.dp, grid.tp],
               "shard_s": time.perf_counter() - t0,
               "allocated_bytes": mem,
               "local": {k: getattr(loc, k) for k in (
                   "num_heads", "num_kv_heads", "d_ff", "num_experts")}}
        engs = tuple(ServingEngine(cfg, sp, device=device, attn_impl=i,
                                   ssd_impl=i, policy=pol, **serve)
                     for i in ("auto", "ref"))
        answers, routes = {}, {}
        for path, eng in zip(("kernel", "plain"), engs):  # noqa: B007
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            _build.reset_launches()
            with pinned_routes(record=routes.setdefault(path, [])):
                answers[path], t = timed_serve(eng, prompts)
            st = eng.stats
            res[path] = {
                "wall_s": t["wall_s"], "prefill_s": t["prefill_s"],
                "decode_s": t["decode_s"], "admissions": st.batches,
                "decode_rounds": st.decode_steps,
                "admission_eager_ms": t["prefill_s"] / st.batches * 1e3,
                "round_eager_ms": t["decode_s"] / st.decode_steps * 1e3,
                "launches": {k: _build.LAUNCHES[k] for k in LLM_KERNELS},
                "shapes": {k: list(v) for k, v in _build.MAX_SHAPES.items()
                           if k in LLM_KERNELS},
                "k8_routes": k8_routes(),
                "shape_launches": _shape_launches(),
                "peak_device_bytes": (torch.cuda.max_memory_allocated(
                    device) if cuda else None)}
        kern, plain = engs
        if cuda:
            mem["served"] = torch.cuda.memory_allocated(device)

        def replayed(run, routes_):
            with pinned_routes(replay=routes_["kernel"]):
                return run()

        res["route_tie"] = hold_paths(
            f"serve_tp {cfg.name} {label}", engs, prompts, answers, routes,
            lambda: replayed(lambda: plain.answer(prompts), routes))
        diff = sum(a != c for a, c in zip(answers["kernel"], single))
        res["answers_differing_from_single_device"] = diff
        if (dp == 1 or not cfg.num_experts) and diff:
            i = next(j for j, (a, c) in enumerate(zip(answers["kernel"],
                                                      single)) if a != c)
            raise AssertionError(
                f"serve_tp {cfg.name} {label}: {diff} answers differ from "
                f"the single-device engine's at the same capacity (prompt "
                f"{i}; the mesh alone: "
                f"{first_flip((kern,), prompts[i], 1)})")
        k = res["kernel"]
        if cuda:
            want = tp_launches(cfg, grid, k["admissions"],
                               k["decode_rounds"],
                               bool(rep.get("shard_cache_seq")))
            got = {n_: k["launches"][n_] for n_ in want}
            if got != want:
                raise AssertionError(f"serve_tp {cfg.name} {label}: "
                                     f"launches {got} != {want}")
            if any(res["plain"]["launches"].values()):
                raise AssertionError(f"serve_tp {label}: the plain engine "
                                     f"launched {res['plain']['launches']}")
            if rep.get("shard_cache_seq") and set(k["k8_routes"]) != {
                    "lengths_lse"}:
                raise AssertionError(f"serve_tp {cfg.name} {label}: K8 "
                                     f"routes {k['k8_routes']}, not its "
                                     f"log-sum-exp route alone")
        # the two waves a round apart, both paths
        waves, stag, sroutes = prompts[:4 * b], {}, {}
        for path, eng in zip(("kernel", "plain"), engs):
            with pinned_routes(record=sroutes.setdefault(path, [])):
                stag[path] = staggered_serve(eng, waves, b // 2)
        (ka, kr), (pa, _) = stag["kernel"], stag["plain"]
        res["staggered_route_tie"] = hold_paths(
            f"serve_tp {cfg.name} {label} (staggered)", engs, waves,
            {"kernel": ka, "plain": pa}, sroutes,
            lambda: replayed(lambda: staggered_serve(plain, waves,
                                                     b // 2)[0], sroutes))
        if not kr["mid_decode_admissions"]:
            raise AssertionError(f"serve_tp {label} (staggered): no slot "
                                 f"was refilled mid-decode")
        res["staggered"] = {"prompts": 4 * b, "tokens_compared": sum(
            map(len, kr["ids"])), "mid_decode_admissions":
            kr["mid_decode_admissions"]}
        if rep.get("shard_cache_seq"):
            res["spread_admission"] = spread_admission(
                f"serve_tp {cfg.name} {label}", engs, ServingEngine(
                    cfg, params, device=device, **serve), grid.tp)
        # one admission's prefill logits against one device's, where no
        # row drops (capacity factor E/k for the MoE)
        nd = (cfg.replace(moe_capacity_factor=cfg.num_experts
                          / cfg.experts_per_tok) if cfg.num_experts
              else cfg)
        toks = torch.from_numpy(np.stack([kern.encode_row(p_)[0]
                                          for p_ in prompts[:b]])
                                ).to(device)
        with torch.no_grad():
            lm, cm = prefill(nd, sp, {"tokens": toks},
                             max_seq=kern.cache_len, attn_impl="auto",
                             policy=pol)
            ls, _ = prefill(nd, params, {"tokens": toks},
                            max_seq=kern.cache_len, attn_impl="auto")
        scale = float(ls.abs().max())
        err = float((lm - ls).abs().max())
        tol = (LONG_TOLERANCE if cfg.family in ("ssm", "hybrid")
               else TP_LOGIT_TOLERANCE)
        if not (torch.isfinite(lm).all() and err <= tol * scale):
            raise AssertionError(f"serve_tp {cfg.name} {label}: prefill "
                                 f"logits {err} from one device's "
                                 f"(max|logit| {scale})")
        res["prefill_logit_max_abs_diff"] = err
        res["prefill_logit_max_abs"] = scale
        res["prefill_logit_tolerance"] = tol
        res["decode_lengths"] = [kern.encode_row(p_)[1]
                                 for p_ in prompts[:b // grid.dp]]
        res["attn_window"] = cfg.attn_window
        del lm, cm, ls
        out["meshes"][label] = res
        if mesh == meshes[-1]:
            engines = engs
        else:
            del engs, kern, plain, eng, sp
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    out["tolerance"] = TP_LOGIT_TOLERANCE
    out["answer_sample"] = answers["kernel"][:4]
    out["engines"] = engines
    out["single"] = single
    return out


def k8_routes() -> dict:
    """K8's launches since the last reset, by route (``lengths``,
    ``slot_mask``, ``lengths_lse``, ...)."""
    from repro_torch.kernels import _build

    out: dict = {}
    for (name, var, _), n in _build.SHAPE_LAUNCHES.items():
        if name == "decode_attention":
            out[var] = out.get(var, 0) + n
    return out


def spread_admission(label: str, engs, one, tp: int) -> dict:
    """One admission of a full batch whose prompts' lengths spread from
    3 tokens to ``max_seq``, so that the first decode positions lie in
    every tensor-parallel rank's slice of a cache split over the
    sequence, and a round has rows with nothing live in a rank's slice
    beside live ones: the mesh engines' (``engs``, kernel and plain
    path) token ids equal the single-device engine ``one``'s."""
    kern = engs[0]
    b = kern.batch_size
    words = ["is", "the", "review", "positive", "product", "winter",
             "garden", "seasonal", "category", "answer"]
    lens = [1 + (kern.max_seq - 2) * i // (b - 1) for i in range(b)]
    prompts = [" ".join(words[j % len(words)] for j in range(n))
               for n in lens]
    ids = {}
    for name, eng in (("kernel", engs[0]), ("plain", engs[1]),
                      ("one_device", one)):
        rec = record_serving(eng)
        try:
            eng.answer(prompts)
        finally:
            unrecord_serving(eng)
        ids[name] = rec["ids"]
    n = [kern.encode_row(p)[1] for p in prompts]
    c = -(-kern.cache_len // tp)
    reached = sorted({(m - 1) // c for m in n})
    if len(reached) < tp:
        raise AssertionError(f"{label} (spread): first decode positions "
                             f"reach ranks {reached} of {tp}")
    for name in ("kernel", "plain"):
        if ids[name] != ids["one_device"]:
            raise AssertionError(f"{label} (spread): the {name} path's ids "
                                 f"differ from one device's")
    return {"prompt_lengths": n, "slice": c, "ranks_reached": reached,
            "tokens_compared": sum(map(len, ids["kernel"]))}


def attn_weights(cfg) -> int:
    """Elements of one layer's attention projections: grouped-query
    wq/wk/wv/wo, or MLA's wdq, wuq, wdkv, wuk, wuv and wo."""
    D, H = cfg.d_model, cfg.num_heads
    if cfg.use_mla:
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        r, vh = cfg.kv_lora_rank, cfg.v_head_dim
        return (D * cfg.q_lora_rank + cfg.q_lora_rank * H * qk
                + D * (r + cfg.qk_rope_head_dim)
                + r * H * (cfg.qk_nope_head_dim + vh) + H * vh * D)
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return D * (H + 2 * K) * hd + H * hd * D


def moe_predictions(cfg, serve) -> dict:
    """What a MoE model's serving should cost, from its shapes: the
    weights a decode round must read (each expert's, since a round's
    capacity of at least one row an expert computes every expert; the
    router, attention, shared experts and LM head beside them) over the
    card's memory rate, and a full admission's operations (the experts'
    products over their capacity slots, the router, the attention
    projections, the shared experts) at the data sheet's float32 rate
    and at the GEMM rate ``serve`` measured."""
    from repro_torch.models.layers import moe_capacity

    B, S = serve["batch_size"], serve["max_seq"]
    L, D, E = cfg.num_layers, cfg.d_model, cfg.num_experts
    Fe = cfg.moe_d_ff or cfg.d_ff
    mats = 3 if cfg.gated_mlp else 2
    cap_admit, cap_round = moe_capacity(cfg, B * S), moe_capacity(cfg, B)
    expert_bytes = 4 * L * mats * E * D * Fe
    attn_w = L * attn_weights(cfg)
    shared_w = L * mats * D * Fe * cfg.num_shared_experts
    round_bytes = (expert_bytes + 4 * (attn_w + shared_w) + 4 * L * D * E
                   + 4 * D * cfg.vocab_size)
    expert_flop = 2 * L * mats * E * cap_admit * D * Fe
    attn_flop = 2 * B * S * attn_w
    shared_flop = 2 * B * S * shared_w
    admit_flop = (expert_flop + attn_flop + shared_flop
                  + 2 * B * S * L * D * E)
    return {"experts": E, "experts_per_tok": cfg.experts_per_tok,
            "moe_d_ff": Fe, "capacity_factor": cfg.moe_capacity_factor,
            "capacity_admission": cap_admit, "capacity_round": cap_round,
            "predicted": {
                "round_expert_bytes": expert_bytes,
                "round_weight_bytes": round_bytes,
                "round_bound_ms": round_bytes / PEAK_BYTES_PER_S * 1e3,
                "admission_expert_flop": expert_flop,
                "admission_attn_proj_flop": attn_flop,
                "admission_shared_flop": shared_flop,
                "admission_flop": admit_flop,
                "admission_ms_at_f32_peak":
                    admit_flop / PEAK_OPS_PER_S * 1e3,
                "admission_ms_at_measured_gemm_rate":
                    admit_flop / MEASURED_GEMM_FLOP_PER_S * 1e3}}


@contextlib.contextmanager
def pinned_routes(record: list | None = None, replay: list | None = None):
    """Within the block every routing of ``moe_route`` (its ``top_k``)
    is recorded into ``record`` (the ids and the gap between the k-th
    and (k+1)-th router probability, per token) or, with ``replay``,
    takes the ids of ``replay``'s calls in order, their probabilities
    gathered from this call's: the same expert choices on another
    path."""
    from repro_torch.models import layers

    top_k = layers.top_k
    calls = iter(replay or ())

    def routed(probs, k):
        if replay is not None:
            ids = next(calls)[0]
            if tuple(ids.shape) != (*probs.shape[:-1], k):
                raise AssertionError("replayed routes do not align")
            return probs.gather(-1, ids), ids
        vals, ids = top_k(probs, min(k + 1, probs.shape[-1]))
        record.append((ids[..., :k], vals[..., k - 1] - vals[..., -1]))
        return vals[..., :k], ids[..., :k]

    layers.top_k = routed
    try:
        yield
    finally:
        layers.top_k = top_k


def route_split(a: list, b: list) -> dict | None:
    """The first routing call whose top-k expert sets differ between two
    recorded runs, with the smallest k-th/(k+1)-th gap of the tokens
    that differ there (either run's), or None. Two near-equal
    probabilities inside the top k may swap places; that changes no
    set, so no expert's rows (an expert's rows keep token order)."""
    import torch

    for n, ((ia, ga), (ib, gb)) in enumerate(zip(a, b)):
        if ia.shape != ib.shape:
            return {"call": n, "gap": None}
        d = (ia.sort(dim=-1).values != ib.sort(dim=-1).values).any(dim=-1)
        if bool(d.any()):
            return {"call": n, "tokens": int(d.sum()),
                    "gap": float(torch.minimum(ga, gb)[d].min())}
    return None


def hold_paths(label: str, engines, prompts, answers: dict, routes: dict,
               rerun) -> dict | None:
    """The kernel-path and plain-path answers (``answers``, by path) of
    one run of ``prompts`` must be identical. Where they differ, the
    first routing that differs (``routes``, recorded by
    ``pinned_routes``) must be a top-k near tie, a k-th/(k+1)-th router
    gap of at most ROUTE_TIE, and ``rerun()`` (the plain path again with
    the kernel path's routes replayed) must give the kernel path's
    answers exactly; else the phase fails with the top-2 logit gaps
    where the ids part (``first_flip``). Returns None, or the record of
    the tie."""
    if answers["kernel"] == answers["plain"]:
        return None
    diff = [i for i, (a, b) in enumerate(zip(answers["kernel"],
                                             answers["plain"])) if a != b]
    split = route_split(routes["kernel"], routes["plain"])
    if split is None or split["gap"] is None or split["gap"] > ROUTE_TIE:
        try:  # a diagnosis only: never hide the failure behind its own
            alone = (first_flip(engines, prompts[diff[0]],
                                engines[0].max_new) if prompts else None)
        except Exception as e:  # noqa: BLE001
            alone = repr(e)[:300]
        raise AssertionError(
            f"{label}: {len(diff)} answers differ between the kernel and "
            f"plain paths (first routing split: {split}); alone: {alone}")
    if rerun() != answers["kernel"]:
        raise AssertionError(
            f"{label}: with the kernel path's routes replayed the plain "
            f"path still differs (routing split {split})")
    return {"answers_differing": len(diff), "first_route_split": split,
            "identical_with_routes_replayed": True}


@contextlib.contextmanager
def record_routes(calls: list):
    """Within the block, every ``moe_route`` call of the model records
    its tokens' top-k expert sets (sorted) and the gap between their
    k-th and (k+1)-th router probabilities into ``calls``, one entry a
    layer."""
    import torch

    from repro_torch.models import layers

    route = layers.moe_route

    def recorded(x, router, cap, k, *window):
        probs = torch.softmax(x.float() @ router, dim=-1)
        vals, ids = layers.top_k(probs, min(k + 1, probs.shape[-1]))
        calls.append((ids[:, :k].sort(dim=-1).values,
                      vals[:, k - 1] - vals[:, -1]))
        return route(x, router, cap, k, *window)

    layers.moe_route = recorded
    try:
        yield
    finally:
        layers.moe_route = route


def router_topk_diff(kern: list, plain: list) -> dict:
    """The (token, layer) pairs whose top-k expert set differs between
    the kernel path's and the plain path's prefill of one admission, and
    the smallest top-k / top-(k+1) probability gap either path saw
    (recorded, not gated: the gate is on the answers and token ids)."""
    if len(kern) != len(plain) or not kern:
        raise AssertionError("router_topk_diff: the paths routed "
                             f"{len(kern)} and {len(plain)} layers")
    differ = sum(int((a[0] != b[0]).any(dim=-1).sum())
                 for a, b in zip(kern, plain))
    gap = min(float(c[1].min()) for c in kern + plain)
    return {"differ": differ, "tokens_x_layers": len(kern)
            * kern[0][0].shape[0], "min_topk_gap": gap}


GEMM_LEAVES = ("wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate", "wdq",
               "wuq", "wdkv", "wuk", "wuv")


def serve_breakdown(eng, toks, run: dict) -> dict:
    """Where one admission's and one round's time goes on the kernel
    path of ``eng``: the admission's prefill of ``toks`` and one decode
    round over its cache, each as CUDA-graph replays (device time, no
    host work) beside the eager times ``run`` measured (``prefill_s`` /
    admissions, ``decode_s`` / rounds: device time plus the time the
    card waited on the host); and the projection GEMMs of the prefill
    alone (every layer's ``GEMM_LEAVES`` matrices at the admission's
    B x S rows, as graph replays)."""
    import torch

    from repro_torch.models import decode_step, prefill

    cfg, params = eng.cfg, eng.params
    B, S = toks.shape

    def run_prefill():
        return prefill(cfg, params, {"tokens": toks}, max_seq=eng.cache_len,
                       attn_impl=eng.attn_impl, ssd_impl=eng.ssd_impl)

    prefill_ms = time_ms(run_prefill, reps=3, inner=2, warmup=1)
    _, cache = run_prefill()
    tok = toks[:, -1].contiguous()
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=toks.device)
    decode_ms = time_ms(lambda: decode_step(cfg, params, cache, tok, pos,
                                            attn_impl=eng.attn_impl),
                        reps=5, inner=5, warmup=1)
    g = torch.Generator(device=toks.device).manual_seed(3)
    gemm_ms, gemm_flops = 0.0, 0
    moe = {}
    for pname, part in params["blocks"].items():
        if not isinstance(part, dict):
            continue
        if pname == "moe":
            moe = moe_gemms(cfg, part, B * S, g)
            gemm_ms += moe["ms"]
            gemm_flops += moe["flop"]
            continue
        for name, w in part.items():
            if name not in GEMM_LEAVES:
                continue
            w0 = w[0].reshape(w.shape[1], -1) if name != "wo" else \
                w[0].reshape(-1, w.shape[-1])
            x = torch.randn(B * S, w0.shape[0], generator=g,
                            device=toks.device)
            gemm_ms += cfg.num_layers * time_ms(lambda: x @ w0, reps=10,
                                                inner=5)
            gemm_flops += cfg.num_layers * 2 * B * S * w0.numel()
    del cache
    eager_prefill = run["prefill_s"] / run["admissions"] * 1e3
    eager_round = run["decode_s"] / run["decode_rounds"] * 1e3
    extra = ({"prefill_moe_gemm_ms": moe["ms"],
              "prefill_moe_gemm_tflop_per_s": moe["flop"] / moe["ms"] / 1e9}
             if moe else {})
    return {"rows": B, "seq": S,
            "prefill_eager_ms": eager_prefill, "prefill_graph_ms": prefill_ms,
            "prefill_gemm_ms": gemm_ms,
            "prefill_gemm_tflop_per_s": gemm_flops / gemm_ms / 1e9, **extra,
            "decode_round_eager_ms": eager_round,
            "decode_round_graph_ms": decode_ms,
            "decode_host_share": 1.0 - decode_ms / eager_round}


def moe_gemms(cfg, p, n_tokens: int, g) -> dict:
    """Device time (graph replays, times the layers) and operations of a
    prefill's MoE products over ``n_tokens`` rows: the router, then each
    expert's products over its capacity slots as ``torch.bmm``."""
    import torch

    from repro_torch.models.layers import moe_capacity

    E, D = cfg.num_experts, cfg.d_model
    Fe, L = p["w_in"].shape[-1], cfg.num_layers
    cap = moe_capacity(cfg, n_tokens)
    dev = p["w_in"].device
    x = torch.randn(n_tokens, D, generator=g, device=dev)
    xg = torch.randn(E, cap, D, generator=g, device=dev)
    h = torch.randn(E, cap, Fe, generator=g, device=dev)
    router = p["router"][0]
    ms = L * time_ms(lambda: x @ router, reps=10, inner=5)
    flop = L * 2 * n_tokens * D * E
    for name in ("w_in", "w_gate", "w_out"):
        if name in p:
            w, a = p[name][0], (h if name == "w_out" else xg)
            ms += L * time_ms(lambda: torch.bmm(a, w), reps=10, inner=5)
            flop += L * 2 * E * cap * D * Fe
    return {"ms": ms, "flop": flop}


def run_serve_mla(device, tiny: bool = False, n_prompts: int = MLA_PROMPTS,
                  seed: int = 0, serve=SERVE) -> dict:
    """deepseek-v3-671b at full width, its depth cut to one layer
    (``tiny`` for a CPU rehearsal): weights from a seeded generator, one
    engine (MLA has one path: the reference runs it outside any Pallas
    kernel), ``n_prompts`` prompts served continuously with CUDA events
    around every admission and round, then drained on the same engine:
    identical answers and token ids, and no K7/K8 launch. Then the
    two-wave 64 (slots refilled mid-decode), twice, identical;
    decode-matches-forward (``mla_decode_check``) with
    ``router_topk_diff`` between its two forms; one admission's prefill,
    and an admission and a round as graph replays. Returns the phase's
    numbers and keeps the engine under ``"engine"`` for
    ``run_llm_query``."""
    import torch

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels import _build
    from repro_torch.kernels.sync import HOST_SYNCS
    from repro_torch.models import count_params, init_params, prefill
    from repro_torch.serving import ServingEngine

    cfg = get_tiny(MLA_ARCH) if tiny else get_config(MLA_ARCH).replace(
        num_layers=1)
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(seed), device=device)
    if cuda:
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    eng = ServingEngine(cfg, params, device=device, **serve)
    prompts = serve_prompts(n_prompts, seed)
    name = cfg.name
    out = {"arch": name, "params": count_params(cfg),
           "reduced": {} if tiny else MLA_REDUCED,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "q_lora_rank": cfg.q_lora_rank,
           "kv_lora_rank": cfg.kv_lora_rank,
           "qk_head_dim": [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
           "v_head_dim": cfg.v_head_dim, "mtp_depth": cfg.mtp_depth,
           "shared_experts": cfg.num_shared_experts,
           "prompts": n_prompts, **serve, "init_s": init_s,
           "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32],
           "moe": moe_predictions(cfg, serve)}
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rounds0 = HOST_SYNCS.by_site.get("serving_round", 0)
    _build.reset_launches()
    answers, t = timed_serve(eng, prompts)
    launches = {k: _build.LAUNCHES[k] for k in LLM_KERNELS}
    st = eng.stats
    padded = st.prefill_positions
    run = {**t, "admissions": st.batches, "decode_rounds": st.decode_steps,
           "prefill_tokens": st.prefill_tokens, "prefill_padded": padded,
           "prefill_tokens_per_s": st.prefill_tokens / t["prefill_s"],
           "prefill_padded_per_s": padded / t["prefill_s"],
           "decode_slot_steps": st.slot_steps,
           "decode_slot_steps_per_s": st.slot_steps / t["decode_s"],
           "decode_tokens": st.decode_tokens,
           "serving_round_syncs": HOST_SYNCS.by_site.get(
               "serving_round", 0) - rounds0,
           "occupancy": st.occupancy, "launches": launches,
           "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else None)}
    out["continuous"] = run
    if len(answers) != n_prompts or not all(answers):
        raise AssertionError(f"serve_mla {name}: missing answers")
    if run["serving_round_syncs"] != run["decode_rounds"]:
        raise AssertionError(f"serve_mla {name}: not one serving_round "
                             f"sync per round")
    want = path_launches(cfg, run["admissions"], run["decode_rounds"])
    if launches != want or any(want.values()):
        raise AssertionError(f"serve_mla {name}: launches {launches}, "
                             f"not {want}")
    t0 = time.perf_counter()
    drained = eng.answer_drained(prompts)
    out["drained_wall_s"] = time.perf_counter() - t0
    # an answer is its token ids, up to a YES/NO that ends it (_detok)
    if drained != answers:
        diff = sum(a != b for a, b in zip(answers, drained))
        raise AssertionError(f"serve_mla {name}: {diff} of {n_prompts} "
                             f"continuous answers differ from the drained")
    out["answers_identical"] = True
    out["tokens_compared"] = sum(len(a.split()) for a in answers)
    # one admission's prefill: finite logits and latent cache
    toks = torch.from_numpy(np.stack([eng.encode_row(p)[0] for p in
                                      prompts[:serve["batch_size"]]])
                            ).to(device)
    logits, cache = prefill(cfg, params, {"tokens": toks},
                            max_seq=eng.cache_len)
    if set(cache) != {"ckv", "krope"} or not all(
            bool(torch.isfinite(x).all()) for x in (logits, *cache.values())):
        raise AssertionError(f"serve_mla {name}: prefill cache "
                             f"{sorted(cache)} or non-finite values")
    out["prefill_logit_max_abs"] = float(logits.abs().max())
    del logits, cache
    # slots freed and refilled mid-decode, twice on the engine: which
    # rows an expert's capacity keeps in a round depends on the other
    # slots' tokens, so these answers may differ from the drained ones
    # (recorded), but never between two runs
    b = serve["batch_size"]
    stag = [staggered_serve(eng, prompts[:4 * b], b // 2) for _ in range(2)]
    (sa, sr), (sa2, sr2) = stag
    if sa != sa2 or sr["ids"] != sr2["ids"]:
        raise AssertionError(f"serve_mla {name} (staggered): two runs on "
                             f"one engine differ")
    if not sr["mid_decode_admissions"]:
        raise AssertionError(f"serve_mla {name} (staggered): no slot was "
                             f"refilled mid-decode")
    out["staggered"] = {
        "prompts": 4 * b, "first_wave": b // 2,
        "mid_decode_admissions": sr["mid_decode_admissions"],
        "tokens_compared": sum(map(len, sr["ids"])),
        "differ_from_drained": sum(
            a != d for a, d in zip(sa, drained[:4 * b]))}
    out["decode_matches_forward"] = mla_decode_check(cfg, params, device,
                                                     seed)
    if cuda:
        out["breakdown"] = serve_breakdown(eng, toks, run)
    out["moe"]["measured"] = {
        "admission_eager_ms": run["prefill_s"] / run["admissions"] * 1e3,
        "round_eager_ms": run["decode_s"] / run["decode_rounds"] * 1e3,
        **{n: out.get("breakdown", {}).get(n) for n in (
            "prefill_graph_ms", "decode_round_graph_ms", "prefill_gemm_ms",
            "prefill_moe_gemm_ms")}}
    out["cache_len"] = eng.cache_len
    out["answer_sample"] = answers[:4]
    out["engine"] = eng
    return out


def mla_decode_check(cfg, params, device, seed: int = 0, batch: int = 2,
                     seq: int = 12, first: int = 8) -> dict:
    """Decode-matches-forward: prefill ``first`` of ``seq`` seeded
    tokens, then decode the rest one at a time (the absorbed form); each
    step's logits equal the full forward's (the materialised form) at
    that position within DECODE_TOLERANCE. The capacity factor is
    raised to at least E / k for this check, so no expert drops a row in
    either form (which rows drop depends on the batch shape, which
    differs between the two forms), as the reference's tiny
    configuration does (8.0 over 8 experts, top-2). Beside it,
    ``router_topk_diff`` between the two forms' routing of the decoded
    tokens."""
    import torch

    from repro_torch.models import decode_step, forward, prefill

    cfg = cfg.replace(moe_capacity_factor=max(
        cfg.moe_capacity_factor, cfg.num_experts / cfg.experts_per_tok))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(device)
    fwd, dec = [], []
    with torch.no_grad():
        with record_routes(fwd):
            full, _ = forward(cfg, params, {"tokens": toks})
        _, cache = prefill(cfg, params, {"tokens": toks[:, :first]},
                           max_seq=seq)
        worst = 0.0
        for t in range(first, seq):
            with record_routes(dec):
                lg, cache = decode_step(
                    cfg, params, cache, toks[:, t],
                    torch.full((batch,), t, dtype=torch.int32,
                               device=device))
            ok = torch.isclose(lg, full[:, t], rtol=DECODE_TOLERANCE,
                               atol=DECODE_TOLERANCE)
            worst = max(worst, float((lg - full[:, t]).abs().max()))
            if not bool(ok.all()) or not bool(torch.isfinite(lg).all()):
                raise AssertionError(
                    f"serve_mla decode-matches-forward: step {t} "
                    f"{worst} apart, beyond {DECODE_TOLERANCE}")
    L, k = cfg.num_layers, cfg.experts_per_tok
    # the forward routed (batch * seq) tokens a layer; each decode step
    # routed the batch's tokens at one position
    plain = [(fwd[l][0].view(batch, seq, k)[:, t],
              fwd[l][1].view(batch, seq)[:, t])
             for t in range(first, seq) for l in range(L)]
    return {"capacity_factor": cfg.moe_capacity_factor, "batch": batch,
            "prefill": first, "steps": seq - first,
            "max_abs_diff": worst,
            "max_abs_logit": float(full[:, first:].abs().max()),
            "tolerance": f"rtol = atol = {DECODE_TOLERANCE}",
            "router_topk_diff": router_topk_diff(dec, plain)}


def mla_one_device(eng, n_prompts: int = MLA_PROMPTS, seed: int = 0
                   ) -> dict:
    """What ``serve_tp_mla`` holds the mesh to, from ``serve_mla``'s
    one-device engine ``eng``: the answers, token ids and routings
    (``pinned_routes``) of ``n_prompts`` prompts served continuously,
    of the two waves of 64, and of one admission's prefill with its
    logits."""
    import torch

    from repro_torch.models import prefill

    prompts = serve_prompts(n_prompts, seed)
    b = eng.batch_size
    one = {"routes": [], "wave_routes": [], "prefill_routes": []}
    with pinned_routes(record=one["routes"]):
        rec = record_serving(eng)
        try:
            one["answers"] = eng.answer(prompts)
        finally:
            unrecord_serving(eng)
    one["ids"] = rec["ids"]
    with pinned_routes(record=one["wave_routes"]):
        one["waves"], wrec = staggered_serve(eng, prompts[:4 * b], b // 2)
    one["wave_ids"] = wrec["ids"]
    toks = torch.from_numpy(np.stack([eng.encode_row(p)[0]
                                      for p in prompts[:b]])).to(eng.device)
    with torch.no_grad(), pinned_routes(record=one["prefill_routes"]):
        one["logits"], _ = prefill(eng.cfg, eng.params, {"tokens": toks},
                                   max_seq=eng.cache_len)
    one["tokens"] = toks
    return one


def hold_to_one_device(label: str, want: list, routes: list, got: list,
                       got_routes: list, tp: int, rerun) -> dict | None:
    """A mesh run's answers ``got`` against one device's ``want``:
    ``hold_paths``' tie rule, the mesh's routings (``tp`` positions
    route the same tokens a layer at dp = 1) taken a position once, and
    ``rerun()`` the mesh run with one device's routings replayed at
    every position."""
    return hold_paths(label, (), None, {"kernel": want, "plain": got},
                      {"kernel": routes, "plain": got_routes[::tp]}, rerun)


def replay_each(routes: list, tp: int) -> list:
    """One device's routings, each repeated for the ``tp`` positions
    that route a layer's tokens on the mesh."""
    return [r for r in routes for _ in range(tp)]


def run_serve_tp_mla(device, one: dict, tiny: bool = False,
                     n_prompts: int = MLA_PROMPTS, seed: int = 0,
                     serve=SERVE, mesh=MLA_TP_MESH,
                     policies=MLA_TP_POLICIES) -> dict:
    """deepseek-v3-671b at full width (one layer; ``tiny`` for a CPU
    rehearsal) over a model mesh whose positions all lie on ``device``:
    the tree made again from ``serve_mla``'s seed and laid out leaf by
    leaf (``shard_params(consume=True)``: each whole leaf freed as its
    parts are made, so the whole tree and its parts are never on the
    card together), then two engines over it, one a policy of
    ``policies`` (the default, the latent cache one tensor a card; and
    ``shard_cache_seq``, each rank a slice of its positions): each
    serves ``n_prompts`` prompts continuously and drained (identical),
    then the two waves of 64; the continuous answers and ids and the
    two waves' held to one device's (``one``, from ``mla_one_device``)
    under ``hold_paths``' tie rule (a first routing split at a top-k
    gap of at most ROUTE_TIE, after which the answers with one device's
    routings replayed must be identical: the mesh sums its two ranks'
    attention and experts in another order); one admission's prefill
    logits within TP_LOGIT_TOLERANCE of one device's (with its routings
    replayed after such a split); no K7/K8 launch (MLA has no kernel).
    Records admission and round ms (CUDA events, eager), the latent
    cache's parts and bytes, and peak memory, which must stay under the
    card's."""
    import torch

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels import _build
    from repro_torch.models import count_params, init_params, prefill
    from repro_torch.models.params import shard_params
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding.model import mesh_grid

    cfg = get_tiny(MLA_ARCH) if tiny else get_config(MLA_ARCH).replace(
        num_layers=1)
    cuda = device.type == "cuda"
    dp, tp = mesh
    prompts = serve_prompts(n_prompts, seed)
    b = serve["batch_size"]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    base = _mesh_policy(device, dp, tp)
    tree = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                       device=device)
    sync()
    init_s = time.perf_counter() - t0
    sp = shard_params(cfg, tree, base, consume=True)
    del tree
    sync()
    out = {"arch": cfg.name, "params": count_params(cfg),
           "reduced": {} if tiny else MLA_REDUCED, "mesh": [dp, tp],
           "prompts": n_prompts, **serve, "init_s": init_s,
           "shard_s": time.perf_counter() - t0 - init_s,
           "shard_peak_device_bytes": (torch.cuda.max_memory_allocated(
               device) if cuda else None),
           "sharded_bytes": (torch.cuda.memory_allocated(device)
                             if cuda else None),
           "policies": {}}
    card = (torch.cuda.get_device_properties(device).total_memory
            if cuda else None)
    for rep in policies:
        pol = base.replace(**rep)
        label = mesh_label((dp, tp, rep))[3]
        eng = ServingEngine(cfg, sp, device=device, policy=pol, **serve)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        _build.reset_launches()
        routes = []
        with pinned_routes(record=routes):
            rec = record_serving(eng)
            try:
                answers, t = timed_serve(eng, prompts)
            finally:
                unrecord_serving(eng)
        st = eng.stats
        launches = {k: _build.LAUNCHES[k] for k in LLM_KERNELS}
        latent = eng.scheduler._cache["ckv"]
        res = {"grid": [mesh_grid(pol).dp, mesh_grid(pol).tp],
               "admissions": st.batches, "decode_rounds": st.decode_steps,
               "wall_s": t["wall_s"], "prefill_s": t["prefill_s"],
               "decode_s": t["decode_s"],
               "admission_eager_ms": t["prefill_s"] / st.batches * 1e3,
               "round_eager_ms": t["decode_s"] / st.decode_steps * 1e3,
               "launches": launches,
               "latent_cache_parts": len(latent.distinct()),
               "latent_cache_part_shape": list(latent.parts[0, 0].shape),
               "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                     if cuda else None)}
        if any(launches.values()):
            raise AssertionError(f"serve_tp_mla {label}: MLA launched "
                                 f"{launches}")
        if cuda and res["peak_device_bytes"] >= card:
            raise AssertionError(f"serve_tp_mla {label}: peak "
                                 f"{res['peak_device_bytes']} bytes")
        res["route_tie"] = hold_to_one_device(
            f"serve_tp_mla {label}", one["answers"], one["routes"], answers,
            routes, tp, lambda: _replayed(
                lambda: eng.answer(prompts), replay_each(one["routes"], tp)))
        if res["route_tie"] is None and rec["ids"] != one["ids"]:
            raise AssertionError(f"serve_tp_mla {label}: token ids differ "
                                 f"from one device's")
        drained = eng.answer_drained(prompts)
        if drained != answers:
            raise AssertionError(f"serve_tp_mla {label}: "
                                 f"{sum(a != c for a, c in zip(drained, answers))}"
                                 f" drained answers differ from the "
                                 f"continuous")
        waves, wroutes = prompts[:4 * b], []
        with pinned_routes(record=wroutes):
            wa, wrec = staggered_serve(eng, waves, b // 2)
        res["staggered_route_tie"] = hold_to_one_device(
            f"serve_tp_mla {label} (staggered)", one["waves"],
            one["wave_routes"], wa, wroutes, tp, lambda: _replayed(
                lambda: staggered_serve(eng, waves, b // 2)[0],
                replay_each(one["wave_routes"], tp)))
        if not wrec["mid_decode_admissions"]:
            raise AssertionError(f"serve_tp_mla {label} (staggered): no "
                                 f"slot was refilled mid-decode")
        res["staggered"] = {"prompts": 4 * b, "tokens_compared": sum(
            map(len, wrec["ids"])), "mid_decode_admissions":
            wrec["mid_decode_admissions"]}
        res["tokens_compared"] = sum(map(len, rec["ids"]))
        # one admission's prefill logits, with one device's routings
        # replayed where the mesh's first split at a near tie
        proutes = []
        with torch.no_grad():
            with pinned_routes(record=proutes):
                lm, _ = prefill(cfg, sp, {"tokens": one["tokens"]},
                                max_seq=eng.cache_len, policy=pol)
            split = route_split(one["prefill_routes"], proutes[::tp])
            if split is not None:
                if split["gap"] is None or split["gap"] > ROUTE_TIE:
                    raise AssertionError(f"serve_tp_mla {label}: prefill "
                                         f"routing split {split}")
                with pinned_routes(replay=replay_each(
                        one["prefill_routes"], tp)):
                    lm, _ = prefill(cfg, sp, {"tokens": one["tokens"]},
                                    max_seq=eng.cache_len, policy=pol)
        scale = float(one["logits"].abs().max())
        err = float((lm - one["logits"]).abs().max())
        if not (bool(torch.isfinite(lm).all())
                and err <= TP_LOGIT_TOLERANCE * scale):
            raise AssertionError(f"serve_tp_mla {label}: prefill logits "
                                 f"{err} from one device's (max|logit| "
                                 f"{scale})")
        res.update(prefill_logit_max_abs_diff=err,
                   prefill_logit_max_abs=scale, prefill_route_split=split,
                   answers_identical=res["route_tie"] is None)
        out["policies"][label] = res
        del eng, lm
        gc.collect()
    out["tolerance"] = TP_LOGIT_TOLERANCE
    out["card_bytes"] = card
    out["answer_sample"] = one["answers"][:4]
    del sp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _replayed(run, routes: list):
    with pinned_routes(replay=routes):
        return run()


def modal_inputs(cfg, rows: int, seed: int) -> dict:
    """The stub frontend's embeddings a family needs beside its tokens,
    unit-normal float32 from ``seed``: ``frames`` (rows, encoder_seq, D)
    for the encoder-decoder, ``patches`` (rows, num_image_tokens, D)
    for the VLM, none for the token-only families."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model), dtype=np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (rows, cfg.num_image_tokens, cfg.d_model), dtype=np.float32)}
    return {}


def _shape_launches() -> list[dict]:
    from repro_torch.kernels import _build

    return [{"kernel": name, "variant": var, "shape": list(shape),
             "launches": n}
            for (name, var, shape), n in sorted(
                _build.SHAPE_LAUNCHES.items(), key=str)
            if name in LLM_KERNELS]


def event_timed(fn, cuda: bool):
    """(fn(), ms): CUDA events around it on the card, the host clock on
    the CPU."""
    import torch

    if not cuda:
        t0 = time.perf_counter()
        r = fn()
        return r, 1e3 * (time.perf_counter() - t0)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    r = fn()
    b.record()
    b.synchronize()
    return r, a.elapsed_time(b)


def modal_launches(label: str, cfg, shape_launches, steps: int,
                   positions: int, cuda: bool) -> tuple[dict, dict]:
    """The encoder-decoder's or the VLM's kernel-path launches from
    ``_shape_launches`` entries: (K7 by mode, K8 by decode). On the card
    they must be per layer and position: K7 once an encoder layer
    (bidir) and once a decoder layer causal and cross for whisper, the
    prefix route's causal and bidir calls a layer for paligemma; K8
    once a layer and step on self (and cross) decode."""
    k7, k8 = {}, {}
    for e in shape_launches:
        if e["kernel"] == "flash_attention":
            Sq, Sk = e["shape"][3], e["shape"][4]
            mode = e["variant"] if Sq == Sk else "cross"
            k7[mode] = k7.get(mode, 0) + e["launches"]
        elif e["kernel"] == "decode_attention":
            kind = ("cross" if cfg.encoder_layers
                    and e["shape"][3] == cfg.encoder_seq else "self")
            k8[kind] = k8.get(kind, 0) + e["launches"]
    L, n = cfg.num_layers, positions
    if cfg.family == "encdec":
        want7 = {"bidir": cfg.encoder_layers * n, "causal": L * n,
                 "cross": L * n}
        want8 = {"self": steps * L * n, "cross": steps * L * n}
    else:  # the prefix route: a causal call and a bidir one per layer
        want7 = {"causal": L * n, "bidir": L * n}
        want8 = {"self": steps * L * n}
    if cuda and (k7 != want7 or k8 != want8):
        raise AssertionError(f"{label}: K7 launches {k7} (want {want7}), "
                             f"K8 {k8} (want {want8})")
    return k7, k8


def run_multimodal(device, phase: str, tiny: bool = False,
                   seed: int = 0) -> dict:
    """``MULTIMODAL[phase]``'s model at full width (``tiny`` for a CPU
    rehearsal) through its entry points, random weights from a seeded
    generator: ``rows`` prompts of ``prompt`` tokens with frames or
    patches from a numpy seed, ``prefill`` into ``max_seq`` positions,
    then ``steps`` greedy ``decode_step``s from ``pos = P + prompt`` (P
    the VLM's image positions), on the kernel path (``attn_impl=
    "auto"``: K7 in its modes, K8 on self and cross decode) and the
    plain path (``"ref"``) over one tree. Gates: identical greedy ids;
    prefill logits within MULTIMODAL_LOGIT_TOLERANCE of max|logit|; the
    kernel path's K7 and K8 launches, per layer, by mode and shape; and
    decode-matches-forward at ``check_rows`` rows (each step's logits
    against the forward over the prompt and the greedy ids, within
    DECODE_TOLERANCE). Records CUDA-event ms of the encoder (the second
    of two calls before the counted run), the prefill and each decode
    step, and the peak memory."""
    import torch

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels import _build
    from repro_torch.models import (
        count_params, decode_step, encode, forward, init_params, prefill)

    spec = MULTIMODAL[phase]
    cfg = (get_tiny if tiny else get_config)(spec["arch"])
    rows, S, steps = spec["rows"], spec["prompt"], spec["steps"]
    P = cfg.num_image_tokens
    max_seq = spec["max_seq"] if not tiny else P + S + steps
    cuda = device.type == "cuda"

    def timed(fn):
        return event_timed(fn, cuda)

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(seed), device=device)
    if cuda:
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (rows, S)).astype(np.int32)
    host = {"tokens": tokens, **modal_inputs(cfg, rows, seed + 1)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    out = {"arch": cfg.name, "family": cfg.family,
           "params": count_params(cfg),
           "tree_params": sum(v.numel() for _, v in _items(params)),
           "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
           "vocab": cfg.vocab_size, "rows": rows, "prompt": S,
           "image_tokens": P, "frames": cfg.encoder_seq, "steps": steps,
           "max_seq": max_seq, "init_s": init_s, "paths": {}}
    runs = {}
    for path, impl in (("kernel", "auto"), ("plain", "ref")):
        run = {}
        with torch.no_grad():
            if cfg.family == "encdec":  # a warm call, the second
                for _ in range(2):
                    _, run["encoder_ms"] = timed(
                        lambda: encode(cfg, params, batch["frames"], impl))
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            _build.reset_launches()
            (logits, cache), run["prefill_ms"] = timed(
                lambda: prefill(cfg, params, batch, max_seq=max_seq,
                                attn_impl=impl))
            ids, step_logits, step_ms = [logits.argmax(-1)], [], []
            pos = torch.full((rows,), P + S, dtype=torch.int32,
                             device=device)
            for _ in range(steps):
                (lg, cache), ms = timed(lambda: decode_step(
                    cfg, params, cache, ids[-1], pos, attn_impl=impl))
                step_ms.append(ms)
                step_logits.append(lg[:spec["check_rows"]].clone())
                ids.append(lg.argmax(-1))
                pos += 1
            launches = _llm_launches()
            shapes = _shape_launches()
        if cuda:
            run["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        del cache
        run.update(decode_ms=step_ms,
                   decode_ms_median=statistics.median(step_ms),
                   launches=launches, shape_launches=shapes)
        runs[path] = (logits, torch.stack(ids, 1), step_logits)
        out["paths"][path] = run
    (kl, kid, ksteps), (pl, pid, _) = runs["kernel"], runs["plain"]
    if not torch.equal(kid, pid):
        raise AssertionError(f"{phase}: greedy ids differ between the "
                             f"kernel and plain paths in "
                             f"{int((kid != pid).any(1).sum())} rows")
    scale = float(pl.abs().max())
    diff = float((kl - pl).abs().max())
    out.update(ids_identical=True, greedy_ids=int(kid.numel()),
               prefill_logit_diff=diff, max_abs_logit=scale,
               prefill_logit_tolerance=MULTIMODAL_LOGIT_TOLERANCE)
    if not diff <= MULTIMODAL_LOGIT_TOLERANCE * scale:
        raise AssertionError(f"{phase}: prefill logits {diff} apart, "
                             f"beyond {MULTIMODAL_LOGIT_TOLERANCE} of "
                             f"{scale}")
    k7, k8 = modal_launches(phase, cfg,
                            out["paths"]["kernel"]["shape_launches"], steps,
                            1, cuda)
    out.update(k7_by_mode=k7, k8_by_decode=k8,
               k8_lengths={"self": P + S + steps, "cross": cfg.encoder_seq})
    # decode-matches-forward on the kernel path: the forward over the
    # prompt and the greedy ids
    r = spec["check_rows"]
    full = {k: v[:r] for k, v in batch.items()}
    full["tokens"] = torch.cat([batch["tokens"][:r], kid[:r, :steps]], 1)
    with torch.no_grad():
        fl, _ = forward(cfg, params, full)
    worst = float((kl[:r] - fl[:, P + S - 1]).abs().max())
    for j, lg in enumerate(ksteps):
        ref = fl[:, P + S + j]
        worst = max(worst, float((lg - ref).abs().max()))
        if not bool(torch.isclose(lg, ref, rtol=DECODE_TOLERANCE,
                                  atol=DECODE_TOLERANCE).all()):
            raise AssertionError(f"{phase} decode-matches-forward: step "
                                 f"{j} {worst} apart, beyond "
                                 f"{DECODE_TOLERANCE}")
    out["decode_matches_forward"] = {
        "rows": r, "steps": steps, "max_abs_diff": worst,
        "max_abs_logit": float(fl[:, P + S - 1:].abs().max()),
        "tolerance": f"rtol = atol = {DECODE_TOLERANCE}"}
    del fl
    # for mm_tp, popped before the phase's line: the tree, the inputs and
    # the kernel path's prefill logits and greedy ids
    out["one_device"] = {"params": params, "batch": batch, "logits": kl,
                         "ids": kid}
    return out


# the encoder-decoder and the VLM over model meshes of the card (mm_tp):
# mesh entries as TP_MESHES'
MM_TP_MESHES = {"encdec": ((2, 2, {"dp_over_tp": True}), (1, 2),
                           (1, 2, {"shard_cache_seq": True})),
                "vlm": ((1, 2), (2, 2), (1, 2, {"shard_cache_seq": True}))}


def run_multimodal_tp(device, phase: str, one: dict, tiny: bool = False,
                      meshes=None) -> dict:
    """``MULTIMODAL[phase]``'s model over model meshes whose positions
    all lie on ``device``, through its entry points as
    ``run_multimodal`` runs it: ``one`` is that phase's ``one_device``
    (its tree, inputs, kernel-path prefill logits and greedy ids), laid
    out by ``shard_params`` over each of ``MM_TP_MESHES[phase]`` in
    turn; ``prefill`` and ``steps`` greedy ``decode_step``s on the
    kernel path and the plain path. Gates: identical greedy ids between
    the paths and equal to one device's (every layout of these families
    gives one device's function); the kernel path's prefill logits
    within TP_LOGIT_TOLERANCE of max|logit| of one device's; K7 and K8
    launches per position and layer, by mode, from
    ``_build.SHAPE_LAUNCHES``. Records CUDA-event ms of the prefill and
    each step (eager) and the peak memory."""
    import torch

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.params import shard_params
    from repro_torch.sharding.model import mesh_grid
    from repro_torch.sharding.policy import ShardingPolicy

    spec = MULTIMODAL[phase]
    cfg = (get_tiny if tiny else get_config)(spec["arch"])
    rows, S, steps = spec["rows"], spec["prompt"], spec["steps"]
    P = cfg.num_image_tokens
    max_seq = spec["max_seq"] if not tiny else P + S + steps
    cuda = device.type == "cuda"
    batch, want_ids = one["batch"], one["ids"]

    def timed(fn):
        return event_timed(fn, cuda)

    out = {"arch": cfg.name, "rows": rows, "prompt": S, "steps": steps,
           "max_seq": max_seq, "meshes": {}}
    for mesh in meshes or MM_TP_MESHES[phase]:
        dp, tp, rep, label = mesh_label(mesh)
        n = dp * tp
        pol = ShardingPolicy.for_mesh(make_mesh(
            dp, tp, devices=[device] * n)).replace(**rep)
        g = mesh_grid(pol)
        t0 = time.perf_counter()
        sp = shard_params(cfg, one["params"], pol)
        if cuda:
            torch.cuda.synchronize(device)
        res = {"dp": dp, "tp": tp, **rep, "grid": [g.dp, g.tp],
               "shard_s": time.perf_counter() - t0, "paths": {}}
        ids = {}
        for path, impl in (("kernel", "auto"), ("plain", "ref")):
            run = {}
            with torch.no_grad():
                if cuda:
                    torch.cuda.synchronize(device)
                    torch.cuda.reset_peak_memory_stats(device)
                _build.reset_launches()
                (logits, cache), run["prefill_ms"] = timed(
                    lambda: prefill(cfg, sp, batch, max_seq=max_seq,
                                    attn_impl=impl, policy=pol))
                got, step_ms = [logits.argmax(-1)], []
                pos = torch.full((rows,), P + S, dtype=torch.int32,
                                 device=device)
                for _ in range(steps):
                    (lg, cache), ms = timed(lambda: decode_step(
                        cfg, sp, cache, got[-1], pos, attn_impl=impl,
                        policy=pol))
                    step_ms.append(ms)
                    got.append(lg.argmax(-1))
                    pos += 1
                run.update(launches=_llm_launches(),
                           shape_launches=_shape_launches())
            if cuda:
                run["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
            del cache
            run.update(decode_ms=step_ms,
                       decode_ms_median=statistics.median(step_ms))
            ids[path] = torch.stack(got, 1)
            if path == "kernel":
                scale = float(one["logits"].abs().max())
                err = float((logits - one["logits"]).abs().max())
                res.update(prefill_logit_diff_vs_one_device=err,
                           max_abs_logit=scale)
                if not (bool(torch.isfinite(logits).all())
                        and err <= TP_LOGIT_TOLERANCE * scale):
                    raise AssertionError(
                        f"mm_tp {cfg.name} {label}: prefill logits {err} "
                        f"from one device's (max|logit| {scale})")
            res["paths"][path] = run
        for path, got in ids.items():
            if not torch.equal(got, want_ids):
                raise AssertionError(
                    f"mm_tp {cfg.name} {label}: the {path} path's greedy "
                    f"ids differ from one device's in "
                    f"{int((got != want_ids).any(1).sum())} rows")
        if any(res["paths"]["plain"]["launches"].values()):
            raise AssertionError(f"mm_tp {cfg.name} {label}: the plain "
                                 f"path launched")
        k7, k8 = modal_launches(f"mm_tp {cfg.name} {label}", cfg,
                                res["paths"]["kernel"]["shape_launches"],
                                steps, n, cuda)
        # under shard_cache_seq self decode reads each rank's slice of the
        # sequence through K8's log-sum-exp route; cross decode keeps its
        # lengths route over the whole xk/xv of its KV heads
        self_routes = {e["variant"] for e in res["paths"]["kernel"][
            "shape_launches"] if e["kernel"] == "decode_attention" and not (
                cfg.encoder_layers and e["shape"][3] == cfg.encoder_seq)}
        want_route = "lengths_lse" if rep.get("shard_cache_seq") \
            else "lengths"
        if cuda and self_routes != {want_route}:
            raise AssertionError(f"mm_tp {cfg.name} {label}: K8 self-decode "
                                 f"routes {self_routes}, not {want_route}")
        res.update(k7_by_mode=k7, k8_by_decode=k8, ids_identical=True,
                   greedy_ids=int(want_ids.numel()),
                   k8_self_route=sorted(self_routes))
        out["meshes"][label] = res
        del sp
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    out["tolerance"] = TP_LOGIT_TOLERANCE
    out["k8_lengths"] = {"self": P + S + steps, "cross": cfg.encoder_seq}
    return out


def run_long_prefill(device, ssm_eng, hybrid_eng, ssm_shape=(2, 2048),
                     hybrid_shape=(1, 4096), hybrid_max_seq: int = 4104,
                     steps: int = 8, seed: int = 0) -> dict:
    """Full width at the multi-tile shapes the 128-token admissions never
    reach: the SSM model's ``prefill`` at ``ssm_shape`` (B, S) (16 chunks
    of 128 at full width), both paths, logits and final ``state``
    compared; the hybrid's ``prefill`` at ``hybrid_shape`` with cache
    length ``hybrid_max_seq``, so that its ring holds W = 2048 slots and
    the window cuts, then ``steps`` decode steps past the wrap, both
    paths, logits compared at every step. Each within LONG_TOLERANCE of
    max|plain|; launches counted per path."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import decode_step, prefill

    cuda = device.type == "cuda"
    rng = np.random.default_rng(seed)

    def rel(a, b):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("long_prefill: non-finite output")
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def timed(fn):
        if not cuda:
            t0 = time.perf_counter()
            return fn(), time.perf_counter() - t0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        b.synchronize()
        return res, a.elapsed_time(b) / 1e3

    out = {"tolerance": LONG_TOLERANCE}
    # the SSM model: 16 chunks per row
    eng = ssm_eng
    cfg, params = eng.cfg, eng.params
    B, S = ssm_shape
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int32)).to(device)
    res = {}
    for impl in ("auto", "ref"):
        _build.reset_launches()
        (lg, cache), sec = timed(lambda: prefill(
            cfg, params, {"tokens": toks}, max_seq=S, attn_impl=impl,
            ssd_impl=impl))
        res[impl] = (lg, cache["state"], sec, dict(_build.LAUNCHES),
                     dict(_build.MAX_SHAPES))
    (la, sa, ta, na, shapes), (lb, sb, tb, nb, _) = res["auto"], res["ref"]
    ssm = {"arch": cfg.name, "batch": B, "seq": S,
           "chunks": S // cfg.ssm_chunk, "prefill_s": ta,
           "plain_prefill_s": tb,
           "logit_rel_diff": rel(la, lb), "state_rel_diff": rel(sa, sb),
           "logit_max_abs": float(lb.abs().max()),
           "state_max_abs": float(sb.abs().max()),
           "launches": {k: na[k] for k in LLM_KERNELS},
           "plain_launches": {k: nb[k] for k in LLM_KERNELS},
           "shapes": {k: list(v) for k, v in shapes.items()}}
    del res, cache, la, lb, sa, sb
    # the hybrid: the ring wraps and the window cuts
    eng = hybrid_eng
    cfg, params = eng.cfg, eng.params
    B, S = hybrid_shape
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + steps))
                            .astype(np.int32)).to(device)
    res = {}
    for impl in ("auto", "ref"):
        _build.reset_launches()
        (lg, cache), sec = timed(lambda: prefill(
            cfg, params, {"tokens": toks[:, :S]}, max_seq=hybrid_max_seq,
            attn_impl=impl, ssd_impl=impl))
        logits = [lg]
        t_dec = 0.0
        for i in range(steps):
            pos = torch.full((B,), S + i, dtype=torch.int32, device=device)
            (ld, cache), sec_d = timed(lambda: decode_step(
                cfg, params, cache, toks[:, S + i], pos, attn_impl=impl))
            logits.append(ld)
            t_dec += sec_d
        res[impl] = (logits, sec, t_dec, dict(_build.LAUNCHES),
                     dict(_build.MAX_SHAPES), cache["slot_pos"])
    ka, kb = res["auto"], res["ref"]
    W = ka[5].shape[2]
    hyb = {"arch": cfg.name, "batch": B, "seq": S,
           "cache_len": hybrid_max_seq, "ring_slots": W,
           "attn_window": cfg.attn_window, "decode_steps": steps,
           "prefill_s": ka[1], "plain_prefill_s": kb[1],
           "decode_s": ka[2], "plain_decode_s": kb[2],
           "logit_rel_diff_per_step": [rel(a, b) for a, b in
                                       zip(ka[0], kb[0])],
           "logit_max_abs": max(float(b.abs().max()) for b in kb[0]),
           "launches": {k: ka[3][k] for k in LLM_KERNELS},
           "plain_launches": {k: kb[3][k] for k in LLM_KERNELS},
           "shapes": {k: list(v) for k, v in ka[4].items()}}
    if not torch.equal(ka[5], kb[5]) or int(ka[5].max()) != S + steps - 1:
        raise AssertionError("long_prefill: ring slot_pos differs or the "
                             "decode steps did not wrap")
    del res, ka, kb
    worst = max([ssm["logit_rel_diff"], ssm["state_rel_diff"]]
                + hyb["logit_rel_diff_per_step"])
    if not worst <= LONG_TOLERANCE:
        raise AssertionError(f"long_prefill: kernel vs plain path "
                             f"{worst} > {LONG_TOLERANCE} of max|plain|")
    if cuda:
        want_ssm = {"flash_attention": 0, "decode_attention": 0,
                    "ssd_chunk": ssm_eng.cfg.num_layers}
        L = cfg.num_layers
        want_hyb = {"flash_attention": L, "decode_attention": L * steps,
                    "ssd_chunk": L}
        if ssm["launches"] != want_ssm or hyb["launches"] != want_hyb:
            raise AssertionError(f"long_prefill: launches {ssm['launches']}"
                                 f" / {hyb['launches']}")
        if any(ssm["plain_launches"].values()) or \
                any(hyb["plain_launches"].values()):
            raise AssertionError("long_prefill: the plain path launched a "
                                 "kernel")
    out.update(ssm=ssm, hybrid=hyb, worst_rel_diff=worst)
    return out


def run_llm_query(device, engines, scale: float = 0.15, qids=None,
                  second: str = "plain", route_ties: bool = False) -> dict:
    """Five corpus queries (one per schema; or those of ``qids``) through
    per-schema ``FrontDoor``s sharing one runner over
    ``ModelBackend.from_engine``, once per engine of ``engines`` (kernel
    path, plain path; or one engine twice, ``second="repeat"``, where
    the model has one path); everything the queries report must agree,
    and so must the token ids the model emitted for every backend prompt
    (with random weights the verdicts parse to False on both paths, so
    the ids are what holds the kernels to the plain path here). With
    ``route_ties`` (a mixture of experts over a model mesh, whose
    per-chunk capacity drops rows), ids that part at a router near tie
    are held as ``hold_paths`` holds them: the plain run again on the
    kernel run's routes must then agree in everything."""
    import torch

    from repro_torch.core import CostParams, Q, col, optimize
    from repro_torch.data import SCHEMAS
    from repro_torch.data import schemas as S
    from repro_torch.engine import FrontDoor
    from repro_torch.kernels import _build
    from repro_torch.semantic import ModelBackend, SemanticRunner
    from repro_torch.serving import ServingStats

    specs = [sp for sp in corpus_specs(Q, col, S)
             if (sp[0] in qids if qids else sp[0] != "Q25")]
    fields = ("llm_calls", "cache_hits", "null_skipped", "probe_rows",
              "pipeline_syncs", "serving_syncs")
    def run(eng) -> dict:
        # fresh tables per run: a table caches what its first run fetched
        dbs = {sp[1]: SCHEMAS[sp[1]](seed=0, scale=scale, device=device)
               for sp in specs}
        eng.stats = ServingStats()
        backend = ModelBackend.from_engine(eng)
        runner = SemanticRunner(backend)
        doors = {name: FrontDoor(db, runner, n_lanes=2)
                 for name, db in dbs.items()}
        rec = record_serving(eng)
        _build.reset_launches()
        queries = {}
        t_all = time.perf_counter()
        for qid, schema, cols, build in specs:
            db = dbs[schema]
            t0 = time.perf_counter()
            plan = optimize(build(), db.catalog(), strategy="cost",
                            params=CostParams()).plan
            t1 = time.perf_counter()
            table, stats = doors[schema].execute(plan)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t2 = time.perf_counter()
            rows = _freeze(db.materialize(table, list(cols)))
            t3 = time.perf_counter()
            queries[qid] = {
                "rows": rows, "stats": {f: getattr(stats, f)
                                        for f in fields},
                "split": {"optimize_s": t1 - t0, "execute_s": t2 - t1,
                          "materialize_s": t3 - t2}}
        wall = time.perf_counter() - t_all
        unrecord_serving(eng)
        return {"queries": queries, "calls": backend.calls,
                "wall_s": wall, "launches": dict(_build.LAUNCHES),
                "serving": eng.stats.snapshot(), **rec}

    routes: dict = {"kernel": [], "plain": []}
    with pinned_routes(record=routes["kernel"]):
        kern = run(engines[0])
    with pinned_routes(record=routes["plain"]):
        plain = run(engines[1])
    tie = None
    if kern["ids"] != plain["ids"] and route_ties:
        # a mixture of experts may route a near tie differently on the
        # two paths (hold_paths); the plain run again on the kernel
        # run's routes must then agree in everything below
        replay = {}

        def rerun():
            with pinned_routes(replay=routes["kernel"]):
                replay["run"] = run(engines[1])
            return replay["run"]["ids"]

        tie = hold_paths(f"llm_query {engines[0].cfg.name}", engines,
                         [], {"kernel": kern["ids"], "plain": plain["ids"]},
                         routes, rerun)
        plain = replay["run"]
    runs_of = f"the first and {second} runs"
    for qid, q in kern["queries"].items():
        p = plain["queries"][qid]
        if q["rows"] != p["rows"]:
            raise AssertionError(f"llm_query {qid}: rows differ between "
                                 f"{runs_of}")
        if q["stats"] != p["stats"]:
            raise AssertionError(f"llm_query {qid}: {q['stats']} != "
                                 f"{p['stats']}")
    if kern["calls"] != plain["calls"] or kern["calls"] == 0:
        raise AssertionError(f"llm_query: backend calls {kern['calls']} "
                             f"vs {plain['calls']}")
    if kern["ids"] != plain["ids"]:
        diff = sum(a != b for a, b in zip(kern["ids"], plain["ids"]))
        raise AssertionError(
            f"llm_query: the token ids of {diff} of {len(kern['ids'])} "
            f"answers (counts {len(kern['ids'])} vs {len(plain['ids'])}) "
            f"differ between {runs_of}")
    split = {k: sum(q["split"][k] for q in kern["queries"].values())
             for k in ("optimize_s", "execute_s", "materialize_s")}
    return {"arch": engines[0].cfg.name, "qids": list(kern["queries"]),
            "scale": scale, "backend_calls": kern["calls"],
            "answers_compared": len(kern["ids"]),
            "tokens_compared": sum(map(len, kern["ids"])),
            "mid_decode_admissions": kern["mid_decode_admissions"],
            "wall_s": kern["wall_s"], f"{second}_wall_s": plain["wall_s"],
            "split": split, "serving": kern["serving"],
            "launches": kern["launches"],
            f"{second}_launches": plain["launches"], "route_tie": tie,
            "queries": {qid: {"rows": len(q["rows"]), **q["stats"],
                              "split": q["split"]}
                        for qid, q in kern["queries"].items()}}


# ------------------------------------------------------------ training


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _llm_launches() -> dict:
    from repro_torch.kernels import _build

    return {k: _build.LAUNCHES[k] for k in LLM_KERNELS}


def train_losses(device, cfg, params, steps: int, **step_kw) -> list[float]:
    """``steps`` steps of ``build_train_step`` on ``TokenStream(seed=7)``
    at TRAIN_EQUIV's shape, with step i's frames or patches from
    ``modal_inputs`` at seed 100 + i for the encoder-decoder and the
    VLM; the losses."""
    import torch

    from repro_torch.training import (
        AdamWConfig, TokenStream, build_train_step, init_state)

    opt = AdamWConfig(lr=1e-3)
    data = TokenStream(cfg.vocab_size, seed=7, **TRAIN_EQUIV)
    state = init_state(params, opt)
    step = build_train_step(cfg, opt, **step_kw)
    out = []
    for i in range(steps):
        host = {"tokens": data[i]["tokens"], **modal_inputs(
            cfg, TRAIN_EQUIV["batch_size"], 100 + i)}
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        params, state, m = step(params, state, batch)
        out.append(float(m["loss"]))
    return out


def _launch_train(args: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))


def _finish(proc: subprocess.Popen, rc: int) -> str:
    """The stdout of ``proc`` once it exits with ``rc``."""
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    if proc.returncode != rc:
        raise AssertionError(f"train_equiv: launch/train exited "
                             f"{proc.returncode}, not {rc}: {stderr[-2000:]}")
    return stdout


def run_train_equiv(device, archs=TRAIN_EQUIV_ARCHS) -> dict:
    """Three train steps of each tiny configuration in ``archs`` from one
    set of weights (made on the CPU from seed 0), on ``device`` and on
    the CPU: every loss within TRAIN_TOLERANCE relative. Then
    ``launch/train`` on ``device``: the tiny mamba2 killed after step
    6 (``--simulate-failure 6``, exit 42) and resumed ends on the same
    ``final loss=`` line as an uninterrupted run, and its final
    checkpoint is compared with the uninterrupted run's bit for bit
    (recorded)."""
    import os
    import tempfile

    import torch

    from repro_torch.configs import get_tiny
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    from repro_torch.training import CheckpointManager

    out = {"shape": TRAIN_EQUIV, "steps": 3, "tolerance": TRAIN_TOLERANCE}
    _build.reset_launches()
    for arch, kw in archs.items():
        cfg = get_tiny(arch)
        host = init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        losses = {str(d): train_losses(d, cfg, _tree_to(host, d), 3, **kw)
                  for d in (device, torch.device("cpu"))}
        got, want = losses[str(device)], losses["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if not rel <= TRAIN_TOLERANCE:
            raise AssertionError(f"train_equiv {arch}: losses {got} on "
                                 f"{device} vs {want} on the CPU")
        out[arch] = {"step": kw, "losses": got, "cpu_losses": want,
                     "max_rel_diff": rel}
    out["launches"] = _llm_launches()
    dev = str(device)
    common = ["--arch", "mamba2-370m", "--tiny", "--device", dev,
              "--steps", "12", "--batch", "2", "--seq", "16",
              "--ckpt-every", "3", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp) / "a", Path(tmp) / "b"
        # the uninterrupted run and the one that fails, side by side
        p1 = _launch_train(common + ["--ckpt-dir", str(a)], env)
        p2 = _launch_train(common + ["--ckpt-dir", str(b),
                                     "--simulate-failure", "6"], env)
        out1 = _finish(p1, 0)
        _finish(p2, 42)
        out3 = _finish(_launch_train(common + ["--ckpt-dir", str(b)], env), 0)
        last = [o.strip().splitlines()[-1] for o in (out1, out3)]
        if "resumed from step 6" not in out3 or \
                "final loss=" not in last[0] or last[0] != last[1]:
            raise AssertionError(f"train_equiv launch/train: resumed "
                                 f"{last[1]!r} vs uninterrupted {last[0]!r}")
        ta = dict(_items(CheckpointManager(a).restore(12)[0]))
        tb = dict(_items(CheckpointManager(b).restore(12)[0]))
        bitwise = ta.keys() == tb.keys() and all(
            np.array_equal(v, tb[k]) for k, v in ta.items())
    out["launcher"] = {"device": dev, "final_line": last[0],
                       "resumed_line": last[1], "identical": True,
                       "checkpoint_bitwise_equal": bitwise,
                       "seconds": time.perf_counter() - t0}
    return out


def run_train(device, arch: str = TRAIN_ARCH, tiny: bool = False,
              shape=TRAIN, further: int = 3) -> dict:
    """Full-width training (``tiny`` for a CPU rehearsal) of ``arch``
    on ``TokenStream(seed=7)`` batches at ``shape``: the gradient norm
    with remat "full" and without remat (within REMAT_TOLERANCE); the
    first step's loss with 2 microbatches and with 1 (within
    MICROBATCH_TOLERANCE), from the same weights and zero state, on
    batch 0; then ``further`` steps with 2 microbatches and fp32
    moments, all on batch 1, each loss finite and below the one before
    (on fresh batches of random tokens the loss moves less in a few
    steps than from one batch to the next); one step with int8 moments
    on batch 2. Step
    times, tokens/s, model FLOP/s (8·N·tokens/s: forward, backward and
    the recomputed forward), ``apply_updates`` ms (CUDA events around
    it) and peak memory. No checkpoint is written."""
    import torch

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels import _build
    from repro_torch.models import count_params, init_params
    from repro_torch.training import AdamWConfig, TokenStream, init_state
    from repro_torch.training import train_step as TS
    from repro_torch.training.optimizer import global_norm

    cfg = get_tiny(arch) if tiny else get_config(arch)
    cuda = device.type == "cuda"
    n_params = count_params(cfg)
    data = TokenStream(cfg.vocab_size, seed=7, **shape)
    tokens = shape["batch_size"] * shape["seq_len"]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def fresh():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device=device)
        sync()
        return params

    def batch(i):
        return {"tokens": torch.from_numpy(data[i]["tokens"]).to(device)}

    apply_ms = []
    apply = TS.apply_updates

    def timed_apply(*a):
        if not cuda:
            return apply(*a)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        res = apply(*a)
        e1.record()
        apply_ms.append((e0, e1))
        return res

    def timed_step(step, params, state, i):
        sync()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch(i))
        loss = float(m["loss"])
        sync()
        return params, state, loss, time.perf_counter() - t0

    out = {"arch": cfg.name, "params": n_params, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, **shape,
           "tokens_per_step": tokens, "remat": "full",
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launches()
    TS.apply_updates = timed_apply
    try:
        params = fresh()
        norms, grad_s = {}, {}
        for remat in (None, "full"):
            sync()
            t0 = time.perf_counter()
            _, grads = TS.value_and_grad(cfg, params, batch(0), remat)
            norms[remat] = float(global_norm(grads))
            sync()
            grad_s[remat] = time.perf_counter() - t0
            del grads
        rel = abs(norms["full"] - norms[None]) / norms[None]
        if not rel <= REMAT_TOLERANCE:
            raise AssertionError(f"train: grad norm {norms['full']} under "
                                 f"remat 'full' vs {norms[None]}")
        out["grad_norm"] = {"none": norms[None], "full": norms["full"],
                            "rel_diff": rel,
                            "fwd_bwd_s": {"none": grad_s[None],
                                          "full": grad_s["full"]}}
        fp32 = AdamWConfig()
        first = {}
        for mb in (1, 2):
            if mb == 2:
                del params, state
                params = fresh()
            state = init_state(params, fp32)
            step = TS.build_train_step(cfg, fp32, num_microbatches=mb,
                                       remat="full")
            params, state, first[mb], secs = timed_step(step, params,
                                                        state, 0)
        rel = abs(first[2] - first[1]) / abs(first[1])
        if not rel <= MICROBATCH_TOLERANCE:
            raise AssertionError(f"train: first loss {first[2]} with 2 "
                                 f"microbatches vs {first[1]} with 1")
        losses, times = [], [secs]
        for _ in range(further):
            params, state, loss, secs = timed_step(step, params, state, 1)
            losses.append(loss)
            times.append(secs)
        if not all(np.isfinite(losses)) or \
                any(b >= a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"train: losses {losses} on one batch not "
                                 f"finite and decreasing")
        out["microbatch_first_loss"] = {"1": first[1], "2": first[2],
                                        "rel_diff": rel}
        out["losses_on_batch_1"] = losses
        out["microbatches"] = 2
        out["step_s"] = times
        step_s = statistics.median(times[1:])
        out["step_s_median"] = step_s
        out["tokens_per_s"] = tokens / step_s
        out["model_flop_per_s"] = 8 * n_params * tokens / step_s
        fp32_apply = len(apply_ms)
        del state
        gc.collect()
        int8 = AdamWConfig(moment_dtype="int8")
        state = init_state(params, int8)
        step = TS.build_train_step(cfg, int8, remat="full")
        params, state, loss8, secs8 = timed_step(step, params, state, 2)
        if not np.isfinite(loss8):
            raise AssertionError(f"train: int8-moment loss {loss8}")
        out["int8_step"] = {"loss": loss8, "step_s": secs8}
    finally:
        TS.apply_updates = apply
    if cuda:
        ms = [a.elapsed_time(b) for a, b in apply_ms]
        out["apply_updates_ms"] = {"fp32": ms[:fp32_apply],
                                   "int8": ms[fp32_apply:]}
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
    out["launches"] = _llm_launches()
    del params, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _mesh_policy(device, dp: int, tp: int, **kw):
    """``ShardingPolicy.for_mesh`` over a (dp, tp) mesh of ``device``
    repeated, ``for_mesh``'s keywords or ``ShardingPolicy`` fields
    (``dp_over_tp``) in ``kw``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.policy import ShardingPolicy

    mesh_kw = {k: v for k, v in kw.items() if k != "dp_over_tp"}
    return ShardingPolicy.for_mesh(
        make_mesh(dp, tp, devices=[device] * (dp * tp)), **mesh_kw
    ).replace(**{k: v for k, v in kw.items() if k == "dp_over_tp"})


def _mesh_train(cfg, params, policy, batches, opt, **step_kw):
    """``params`` (laid out over ``policy``'s mesh unless it is None)
    trained one step on each of ``batches``; (losses, params, state)."""
    from repro_torch.models.params import shard_params
    from repro_torch.training import build_train_step, init_state

    if policy is not None:
        params = shard_params(cfg, params, policy)
    state = init_state(params, opt)
    step = build_train_step(cfg, opt, policy=policy, **step_kw)
    losses = []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    return losses, params, state


def device_busy(fn, top: int = 8) -> dict:
    """One ``fn()`` under ``torch.profiler``: the device time of every
    kernel, memset and copy it ran, summed (one stream, so the device's
    busy time), beside the call's wall time and the busy share, the
    count of device activities and the ``top`` ones by device time
    (name, count, ms). The window opens with spin kernels, left out
    (``profiled_window``)."""
    import torch

    def body():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prof, wall, pad = profiled_window(body)
    acts = sorted((e for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and "spin_kernel" not in e.key),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in acts) / 1e6
    return {"device_busy_s": busy, "profiled_wall_s": wall,
            "busy_share": busy / wall,
            "activities": sum(e.count for e in acts),
            "top": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                    for e in acts[:top]], **pad}


def _max_param_diff(a: dict, b: dict) -> float:
    return max(float((x.cpu() - y.cpu()).abs().max())
               for (_, x), (_, y) in zip(_items(a), _items(b)))


def run_train_tp(device, single: dict, tiny: bool = False,
                 shape=TRAIN, meshes=TRAIN_TP_MESHES) -> dict:
    """Training over the model mesh (phase 24 of the module doc):
    ``single`` is the ``train`` phase's output, whose losses the
    full-width meshes are held to; ``tiny`` runs TRAIN_ARCH's tiny
    configuration in place of the full width (a CPU rehearsal)."""
    import tempfile

    import torch

    from repro_torch.configs import get_config, get_tiny
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    from repro_torch.models.params import shard_params
    from repro_torch.sharding import model as sm
    from repro_torch.sharding.policy import ShardingPolicy
    from repro_torch.training import (
        AdamWConfig, CheckpointManager, TokenStream, build_train_step,
        init_state)
    from repro_torch.training.train_step import value_and_grad

    cpu = torch.device("cpu")
    cuda = device.type == "cuda"
    fp32 = AdamWConfig(lr=1e-3)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def batches(cfg, steps, dev, shape=TRAIN_EQUIV):
        """TokenStream's batches, with the stub frontend's frames or
        patches beside them for the encoder-decoder and the VLM."""
        data = TokenStream(cfg.vocab_size, seed=7, **shape)
        return [{k: torch.from_numpy(v).to(dev) for k, v in {
            "tokens": data[i]["tokens"],
            **modal_inputs(cfg, shape["batch_size"], i)}.items()}
            for i in steps]

    _build.reset_launches()
    out = {"tiny": {}, "full_width": {}}
    for arch, (dp, tp), kw in TRAIN_TP_TINY:
        cfg = get_tiny(arch)
        host = init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        runs = {}
        for name, dev, pol in (
                ("card_mesh", device, _mesh_policy(device, dp, tp, **kw)),
                ("cpu_mesh", cpu, _mesh_policy(cpu, dp, tp, **kw)),
                ("card_one", device, None)):
            if name == "card_one" and cfg.num_experts and (
                    cfg.moe_capacity_factor
                    < cfg.num_experts / cfg.experts_per_tok):
                continue  # capacity per data-parallel chunk: no match
            losses, params, _ = _mesh_train(
                cfg, _tree_to(host, dev), pol, batches(cfg, range(3), dev),
                fp32, remat=None)
            runs[name] = (losses, sm.unshard(params, "cpu"))
        got = runs["card_mesh"]
        res = {"mesh": [dp, tp], **kw, "losses": got[0]}
        for name in ("cpu_mesh", "card_one"):
            if name not in runs:
                continue
            dl = max(abs(a - b) for a, b in zip(got[0], runs[name][0]))
            dparam = _max_param_diff(got[1], runs[name][1])
            res[f"vs_{name}"] = {"max_loss_diff": dl,
                                 "max_param_diff": dparam}
            if not (dl <= TRAIN_TP_LOSS_TOLERANCE
                    and dparam <= TRAIN_TP_PARAM_TOLERANCE):
                raise AssertionError(f"train_tp {arch} {dp}x{tp}: losses "
                                     f"{got[0]} vs {name} {runs[name][0]}, "
                                     f"max|dparam| {dparam}")
        out["tiny"][f"{arch} {dp}x{tp}"] = res

    cfg = get_tiny(TRAIN_ARCH) if tiny else get_config(TRAIN_ARCH)
    want = [single["microbatch_first_loss"]["2"],
            *single["losses_on_batch_1"][:2]]
    tokens = shape["batch_size"] * shape["seq_len"]
    full = batches(cfg, (0, 1), device, shape)

    def fresh(policy):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        params = shard_params(cfg, init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            device=device), policy)
        opt = AdamWConfig()  # train's optimizer
        return params, init_state(params, opt), build_train_step(
            cfg, opt, num_microbatches=2, remat="full", policy=policy)

    if cuda:  # the device's busy time in one device's step, beside
        params, state, step = fresh(ShardingPolicy.single())
        step(params, state, full[0])
        out["full_width"]["1x1"] = device_busy(
            lambda: step(params, state, full[1]))
        del params, state, step
    for dp, tp in meshes:
        params, state, step = fresh(_mesh_policy(device, dp, tp))
        losses, secs = [], []
        for b in (full[0], full[1], full[1]):
            sync()
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            sync()
            secs.append(time.perf_counter() - t0)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        if not rel <= TRAIN_TOLERANCE:
            raise AssertionError(f"train_tp {cfg.name} {dp}x{tp}: losses "
                                 f"{losses} vs one device's {want}")
        step_s = statistics.median(secs[1:])
        res = {"losses": losses, "single_losses": want,
               "max_rel_diff": rel, "step_s": secs,
               "step_s_median": step_s, "tokens_per_s": tokens / step_s,
               "single_step_s_median": single.get("step_s_median")}
        if cuda:
            res["peak_device_bytes"] = torch.cuda.max_memory_allocated(
                device)
            res.update(device_busy(lambda: step(params, state, full[1])))
        out["full_width"][f"{dp}x{tp}"] = res
        del params, state, step
    out["full_width_arch"] = {"arch": cfg.name, **shape, "microbatches": 2,
                              "remat": "full", "moments": "fp32"}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the SSM at full width: one device at 2 and at 4 microbatches (the
    # same function in exact arithmetic: its own spread), then the (2, 2)
    # mesh, from the same seed on the same batches
    arch, (dp, tp) = TRAIN_TP_SSM
    cfg = get_tiny(arch) if tiny else get_config(arch)
    ssm_batches = batches(cfg, (0, 1), device, shape)
    # the model's own conditioning: one device's gradient of the first
    # batch against the mean of its two halves' gradients
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    toks = ssm_batches[0]["tokens"]
    half = toks.shape[0] // 2
    _, g_all = value_and_grad(cfg, params, {"tokens": toks}, "full")
    _, g_a = value_and_grad(cfg, params, {"tokens": toks[:half]}, "full")
    _, g_b = value_and_grad(cfg, params, {"tokens": toks[half:]}, "full")
    row_split = max(
        float((a - (x + y) / 2).abs().max()) / max(float(a.abs().max()),
                                                   1e-30)
        for (_, a), (_, x), (_, y) in zip(_items(g_all), _items(g_a),
                                          _items(g_b)))
    del params, g_all, g_a, g_b
    ssm = {}
    for label, policy, mb in (
            ("1x1", ShardingPolicy.single(), 2),
            ("1x1_mb4", ShardingPolicy.single(), 4),
            (f"{dp}x{tp}", _mesh_policy(device, dp, tp), 2)):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        params = shard_params(cfg, init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            device=device), policy)
        opt = AdamWConfig()
        state = init_state(params, opt)
        step = build_train_step(cfg, opt, num_microbatches=mb,
                                remat="full", policy=policy)
        losses, secs = [], []
        for b in (ssm_batches[0], ssm_batches[1], ssm_batches[1]):
            sync()
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            sync()
            secs.append(time.perf_counter() - t0)
        ssm[label] = {"losses": losses, "step_s": secs,
                      "step_s_median": statistics.median(secs[1:]),
                      "tokens_per_s": tokens / statistics.median(secs[1:]),
                      "peak_device_bytes": (torch.cuda.max_memory_allocated(
                          device) if cuda else None)}
        del params, state, step
    one, mb4 = ssm["1x1"]["losses"], ssm["1x1_mb4"]["losses"]
    mesh = ssm[f"{dp}x{tp}"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh, one)]
    spread = [abs(a - b) / abs(b) for a, b in zip(mb4, one)]
    # the first loss (the same weights) within TRAIN_TOLERANCE; each later
    # one within it or within SSM_SPREAD_FACTOR of one device's own spread
    if not (rel[0] <= TRAIN_TOLERANCE and all(
            r <= max(TRAIN_TOLERANCE, SSM_SPREAD_FACTOR * s_)
            for r, s_ in zip(rel, spread))):
        raise AssertionError(f"train_tp {cfg.name} {dp}x{tp}: losses {mesh} "
                             f"vs one device's {one} (at 4 microbatches "
                             f"{mb4})")
    out["full_width_ssm"] = {"arch": cfg.name, **shape, "microbatches": 2,
                             "remat": "full", "moments": "fp32",
                             "rel_diff": rel, "one_device_spread": spread,
                             "row_split_grad_rel": row_split,
                             "spread_factor": SSM_SPREAD_FACTOR, **ssm}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    (dp, tp), (dp2, tp2), saved, last = TRAIN_TP_ELASTIC
    cfg = get_tiny("qwen2.5-32b")
    host = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    whole, _, _ = _mesh_train(cfg, _tree_to(host, device),
                              _mesh_policy(device, dp, tp),
                              batches(cfg, range(last), device), fp32,
                              remat=None)
    with tempfile.TemporaryDirectory() as tmp:
        _, params, state = _mesh_train(
            cfg, _tree_to(host, device), _mesh_policy(device, dp, tp),
            batches(cfg, range(saved), device), fp32, remat=None)
        mgr = CheckpointManager(tmp)
        mgr.save(saved, {"params": params, "opt": state})
        pol2 = _mesh_policy(device, dp2, tp2)
        tree, manifest = mgr.restore(policy=pol2, cfg=cfg)
    step = build_train_step(cfg, fp32, remat=None, policy=pol2)
    params, state = tree["params"], tree["opt"]
    for b in batches(cfg, range(saved, last), device):
        params, state, m = step(params, state, b)
    resumed = float(m["loss"])
    if not abs(resumed - whole[-1]) <= TRAIN_TP_LOSS_TOLERANCE:
        raise AssertionError(f"train_tp elastic restore: loss {resumed} "
                             f"vs uninterrupted {whole[-1]}")
    out["elastic"] = {"saved_on": [dp, tp], "resumed_on": [dp2, tp2],
                      "saved_step": manifest["step"], "last_step": last,
                      "loss": resumed, "uninterrupted_loss": whole[-1]}
    out["launches"] = _llm_launches()
    if any(out["launches"].values()):
        raise AssertionError(f"train_tp launched {out['launches']}")
    return out


def run_train_backend(device, steps: int = BACKEND_STEPS) -> dict:
    """``examples/torch_train_backend.py`` on ``device``: the 13M
    backend trained ``steps`` steps on ``make_ecommerce(seed=4)``'s
    labelled prompts (no kernel launches), its held-out accuracy beside
    the majority class; checkpointed to a temporary directory, restored
    through ``CheckpointManager`` and served by two engines, the kernel
    path (K7/K8) and the plain path, through
    ``examples/torch_serve_semantic_queries.py``'s products ⋈ previews
    plan under ``none`` and ``cost``: answers, verdicts, rows,
    ``llm_calls``, ``cache_hits`` and the token ids of every answer
    identical between the paths; F1 against the oracle and the YES
    share of the verdicts recorded."""
    import tempfile

    import torch

    from repro_torch.kernels import _build
    from repro_torch.serving import ServingEngine
    from repro_torch.training import CheckpointManager, HashTokenizer
    from repro_torch.training.backend import (
        EVAL_BATCHES, backend_config, train_backend)

    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_serve_semantic_queries as example
    finally:
        sys.path.remove(str(ROOT / "examples"))
    cfg = backend_config()
    _build.reset_launches()
    log = []
    params, info = train_backend(steps, device=device, log=log.append)
    out = {**info, "train_launches": _llm_launches(), "log": log}
    # the steps launch nothing; the held-out forward runs K7 per layer
    want = {k: 0 for k in LLM_KERNELS}
    if device.type == "cuda":
        want["flash_attention"] = cfg.num_layers * EVAL_BATCHES
    if out["train_launches"] != want:
        raise AssertionError(f"train_backend: launches {out['train_launches']}"
                             f" while training and scoring, not {want}")
    if not info["accuracy"] > info["majority_share"]:
        raise AssertionError(f"train_backend: held-out accuracy "
                             f"{info['accuracy']} not above the majority "
                             f"class {info['majority_share']}")
    with tempfile.TemporaryDirectory() as tmp:
        CheckpointManager(tmp).save(steps, {"params": params},
                                    extra={"arch": cfg.name,
                                           "accuracy": info["accuracy"]})
        tree, manifest = CheckpointManager(tmp).restore(device=device)
    restored = tree["params"]
    got = dict(_items(restored))
    if got.keys() != dict(_items(params)).keys() or not all(
            torch.equal(a, got[k]) for k, a in _items(params)):
        raise AssertionError("train_backend: the restored checkpoint "
                             "differs from the trained weights")
    runs = {}
    for impl in ("auto", "ref"):
        eng = ServingEngine(cfg, restored, tokenizer=HashTokenizer(
            cfg.vocab_size), batch_size=32, max_seq=48, max_new_tokens=2,
            device=device, attn_impl=impl, ssd_impl=impl)
        rec = record_serving(eng)
        _build.reset_launches()
        try:
            res = example.serve_plan(eng, device)
        finally:
            unrecord_serving(eng)
        runs[impl] = (res, rec["ids"], dict(_build.LAUNCHES))
    (kern, k_ids, k_launch), (plain, p_ids, p_launch) = \
        runs["auto"], runs["ref"]
    for strategy, r in kern.items():
        p = plain[strategy]
        for key in ("answers", "verdicts", "llm_calls", "cache_hits"):
            if r[key] != p[key]:
                raise AssertionError(f"train_backend {strategy}: {key} "
                                     f"differ between the kernel and plain "
                                     f"paths")
        if _freeze(r["rows"]) != _freeze(p["rows"]):
            raise AssertionError(f"train_backend {strategy}: rows differ")
    if k_ids != p_ids:
        raise AssertionError("train_backend: token ids differ between the "
                             "kernel and plain paths")
    if device.type == "cuda":
        require_launched("train_backend serve", k_launch, ATTN_KERNELS)
        if any(p_launch[k] for k in LLM_KERNELS):
            raise AssertionError(f"train_backend: the plain path launched "
                                 f"{p_launch}")
    verdicts = [v for r in kern.values() for v in r["verdicts"]]
    yes = sum(v is True for v in verdicts) / max(len(verdicts), 1)
    if not yes > 0:
        raise AssertionError("train_backend: every verdict is NO")
    out["serve"] = {
        s: {"f1": r["f1"], "rows": len(r["rows"]),
            "oracle_rows": r["oracle_rows"], "llm_calls": r["llm_calls"],
            "cache_hits": r["cache_hits"],
            "yes_share": sum(v is True for v in r["verdicts"])
            / max(len(r["verdicts"]), 1),
            "wall_s": r["wall_s"], "plain_wall_s": plain[s]["wall_s"]}
        for s, r in kern.items()}
    out["yes_share"] = yes
    out["answers_compared"] = len(k_ids)
    out["tokens_compared"] = sum(map(len, k_ids))
    out["launches"] = k_launch
    out["plain_launches"] = p_launch
    out["identical"] = True
    return out


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ------------------------------------------------- timing at main-path shapes

def sdpa_call(q, k, v, **kw):
    """``scaled_dot_product_attention`` over GQA operands — the library
    yardstick of K7/K8, never called by the port. Torch builds without
    ``enable_gqa`` get K/V repeated H-wide here, outside the call."""
    import torch.nn.functional as F

    group = q.shape[1] // k.shape[1]
    try:
        F.scaled_dot_product_attention(q[:1, :1, :1], k[:1, :1, :1],
                                       v[:1, :1, :1], enable_gqa=True)
    except TypeError:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        return lambda: F.scaled_dot_product_attention(q, k, v, **kw)
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)


def ssd_work(b, s, h, p, n, chunk) -> tuple[int, int]:
    """(bytes, operations) K9 must move and do at (b, s, h, p, n, chunk):
    x, dt, B, C read once, y_diag, states, decay and cum written once;
    2 l^2 n per (row, chunk) for C.B^T, 2 p per visible (i >= j) pair
    and head for y_diag, 2 l h p n per (row, chunk) for the states."""
    nc = s // chunk
    n_bytes = 4 * (2 * b * s * h * p + 2 * b * s * h + h + 2 * b * s * n
                   + b * nc * h * p * n + b * nc * h)
    cells = b * nc
    n_ops = cells * (2 * chunk * chunk * n + h * p * chunk * (chunk + 1)
                     + 2 * chunk * h * p * n)
    return n_bytes, n_ops


def window_pairs(S: int, window: int) -> int:
    """Visible (query, key) pairs of one causal (row, head) over S
    positions within ``window`` (0: none)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def kernel_rows(device, launches: dict, shapes: dict, max_err: dict,
                by_path: dict, decode_lengths, seed: int = 1,
                llm: dict | None = None, n_shards: int = 4) -> list[dict]:
    """Time each kernel at the largest shape its path's run gave it
    (``launches``/``shapes``: K1-K4 from ``e2e``, K5/K6 from
    ``e2e_hash``, K7/K8 from ``serve``, K9 from ``serve_ssm``; K8's rows
    hold the ``decode_lengths`` of a first decode round of the served
    prompts; ``llm`` adds K7 with the hybrid's window and K8 with its
    slot mask at ``serve_hybrid``'s and ``long_prefill``'s shapes, K7
    and K8 at ``serve_moe``'s multi-head shapes (group 1), K7 and K8 at
    every shape the ``encdec`` and ``vlm`` phases launched them at
    (``llm["multimodal"]``: each phase's shape launches and decode
    lengths), and K9 at ``long_prefill``'s and ``serve_hybrid``'s; K10 from
    ``e2e_sharded`` over ``n_shards`` buckets, with K6 at B = P and K10
    at P = 32 beside it):
    the kernel, its plain version and the library call each as
    CUDA-graph replays (device time only), and the kernel's wrapper also
    as one eager call between two events (``wrapper_eager_ms``, which
    adds the wrapper's host work where the card waits for it).
    ``by_path`` holds every path's launch counts."""
    import torch

    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import radix_cases as RC
    from repro_torch.kernels.attention_cases import TOLERANCE
    from repro_torch.kernels.compact.compact import prefix_count_kernel
    from repro_torch.kernels.compact.ref import prefix_count_torch
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_kernel)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref)
    from repro_torch.kernels.expand.expand import running_segment_ids_kernel
    from repro_torch.kernels.expand.ref import running_segment_ids_torch
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.hash_dedup.group_build import (
        group_boundaries_kernel)
    from repro_torch.kernels.hash_dedup.hash_dedup import hash_rows_kernel
    from repro_torch.kernels.hash_dedup.ref import (
        group_boundaries_ref, hash_rows_ref)
    from repro_torch.kernels.hash_join.hash_join import (
        radix_rank_kernel, radix_rank_torch)
    from repro_torch.kernels.hash_join.ops import _radix_order
    from repro_torch.kernels.partition.partition import shard_rank_kernel
    from repro_torch.kernels.partition.ref import shard_rank_torch
    from repro_torch.kernels.segmented_reduce.ref import segment_reduce_torch
    from repro_torch.kernels.segmented_reduce.segmented_reduce import (
        segment_reduce_kernel)
    from repro_torch.kernels import ssd_cases as SC
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd.ssd import head_groups, ssd_chunk_kernel

    g = torch.Generator(device=device).manual_seed(seed)
    llm = llm or {}
    rows = []

    def row(name, source, replaces, kern, plain, library, n_bytes, n_ops,
            shape, err=None, library_eager=False, tensor_cores=False,
            **extra):
        if err is None:
            outs, wants = kern(), plain()
            if not isinstance(outs, tuple):
                outs, wants = (outs,), (wants,)
            err = max([max_err.get(name, 0)] + [
                _same(a, b, name) for a, b in zip(outs, wants)])
        bounds = (tc_bounds(n_bytes, n_ops) if tensor_cores else
                  dict(zip(("bound_ms", "bound_by"),
                           bound_ms(n_bytes, n_ops))))
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in by_path.items()},
            "max_abs_err": err, "shape": list(shape),
            "ms": time_ms(kern), "plain_ms": time_ms(plain), **bounds,
            "library_ms": (None if library is None else eager_ms(library)
                           if library_eager else time_ms(library)),
            "wrapper_eager_ms": eager_ms(kern), **extra,
        })

    n = shapes["prefix_count"][0]
    flags = torch.randint(0, 2, (n,), generator=g, device=device,
                          dtype=torch.int32)
    row("prefix_count", "src/repro_torch/csrc/compact.cu",
        "src/repro/kernels/compact/compact.py:50",
        lambda: prefix_count_kernel(flags),
        lambda: prefix_count_torch(flags),
        lambda: torch.cumsum(flags, 0, dtype=torch.int32),
        8 * n, n, (n,), library_call="torch.cumsum(dtype=int32)",
        device_kernels=device_kernels(lambda: prefix_count_kernel(flags)))

    n, c = shapes["hash_rows"]
    keys = torch.randint(-2**31, INT32_MAX, (n, c), generator=g,
                         device=device, dtype=torch.int32)
    row("hash_rows", "src/repro_torch/csrc/hash_rows.cu",
        "src/repro/kernels/hash_dedup/hash_dedup.py:51",
        lambda: hash_rows_kernel(keys), lambda: hash_rows_ref(keys), None,
        4 * n * (c + 1), 16 * n * c, (n, c))

    n = shapes["group_boundaries"][0]
    sk = torch.sort(torch.randint(0, max(n // 4, 1), (n,), generator=g,
                                  device=device, dtype=torch.int32))[0]
    # the library yardstick: unique_consecutive's inverse is K3's gid;
    # it fetches its output size to the host, so it cannot be captured
    # in a CUDA graph and is timed eagerly, beside wrapper_eager_ms
    inverse = torch.unique_consecutive(sk, return_inverse=True)[1]
    if not torch.equal(inverse, group_boundaries_kernel(sk)[1].long()):
        raise AssertionError("K3's gid differs from unique_consecutive's "
                             "inverse")
    row("group_boundaries", "src/repro_torch/csrc/group_build.cu",
        "src/repro/kernels/hash_dedup/group_build.py:61",
        lambda: group_boundaries_kernel(sk),
        lambda: group_boundaries_ref(sk),
        lambda: torch.unique_consecutive(sk, return_inverse=True),
        12 * n, 3 * n, (n,), library_eager=True,
        library_call="torch.unique_consecutive(return_inverse=True), "
                     "eager (it syncs the host)",
        device_kernels=one_data_kernel(
            "K3", lambda: group_boundaries_kernel(sk),
            "lookback_scan_kernel", memset=True))

    n = shapes["running_segment_ids"][0]
    counts = torch.randint(0, 3, (n // 2 + 1,), generator=g, device=device)
    marks = _marks_from_counts(counts, n, device)
    row("running_segment_ids", "src/repro_torch/csrc/expand.cu",
        "src/repro/kernels/expand/expand.py:49",
        lambda: running_segment_ids_kernel(marks),
        lambda: running_segment_ids_torch(marks),
        lambda: torch.cumsum(marks, 0, dtype=torch.int32),
        8 * n, 2 * n, (n,), library_call="torch.cumsum(dtype=int32)",
        device_kernels=device_kernels(
            lambda: running_segment_ids_kernel(marks)))

    # K5 at the group-by's (rows, groups): float32 max, the aggregate
    # the path runs; min/max are exact, so held bit for bit here; and at
    # the radix histograms' (rows, 256): int32 sums of ones over 8-bit
    # digits (kernels/hash_join/ops.py::_radix_order), index_add_ the
    # library call there, and bincount (the same histogram of ones; it
    # fetches the largest digit to the host, so it is timed eagerly,
    # beside wrapper_eager_ms)
    n, gs = shapes["segment_reduce"]
    vals = torch.randn(n, generator=g, device=device) * 100
    seg = torch.randint(0, gs, (n,), generator=g, device=device,
                        dtype=torch.int32)
    seg64 = seg.long()
    kern5 = segment_reduce_kernel(vals, seg, gs, "max")
    if not torch.equal(kern5.view(torch.int32),
                       segment_reduce_torch(vals, seg, gs, "max")
                       .view(torch.int32)):
        raise AssertionError("K5 at the e2e_hash shape differs from its "
                             "plain version")
    nh = shapes["radix_rank"][0]
    digit = torch.randint(0, 256, (nh,), generator=g, device=device,
                          dtype=torch.int32)
    digit64 = digit.long()
    ones = torch.ones_like(digit)
    hist = segment_reduce_kernel(ones, digit, 256, "sum")
    if not torch.equal(hist, segment_reduce_torch(ones, digit, 256, "sum")):
        raise AssertionError("K5 at the radix histogram's shape differs "
                             "from its plain version")
    if not torch.equal(hist.long(), torch.bincount(digit, minlength=256)):
        raise AssertionError("K5 at the radix histogram's shape differs "
                             "from torch.bincount")
    hb, hby = bound_ms(8 * nh + 4 * 256, nh)
    histogram = {
        "shape": [nh, 256], "op": "sum", "dtype": "int32",
        "max_abs_err": 0,
        "ms": time_ms(lambda: segment_reduce_kernel(ones, digit, 256,
                                                    "sum")),
        "plain_ms": time_ms(lambda: segment_reduce_torch(ones, digit, 256,
                                                         "sum")),
        "bound_ms": hb, "bound_by": hby,
        "library_ms": time_ms(lambda: torch.zeros(
            256, dtype=torch.int32, device=device).index_add_(
                0, digit64, ones)),
        "library_call": "index_add_",
        "bincount_eager_ms": eager_ms(
            lambda: torch.bincount(digit, minlength=256)),
        "wrapper_eager_ms": eager_ms(lambda: segment_reduce_kernel(
            ones, digit, 256, "sum")),
        "device_kernels": one_data_kernel(
            "K5 histogram",
            lambda: segment_reduce_kernel(ones, digit, 256, "sum"),
            "segment_reduce_kernel", memset=True)}
    row("segment_reduce", "src/repro_torch/csrc/segment_reduce.cu",
        "src/repro/kernels/segmented_reduce/segmented_reduce.py:71",
        lambda: segment_reduce_kernel(vals, seg, gs, "max"),
        lambda: segment_reduce_torch(vals, seg, gs, "max"),
        lambda: torch.full((gs,), -float("inf"), device=device)
        .scatter_reduce_(0, seg64, vals, reduce="amax", include_self=True),
        8 * n + 4 * gs, n, (n, gs),
        err=max(max_err.get("segment_reduce", 0),
                max_err.get("segment_reduce_f32_sum", 0.0)),
        library_call="scatter_reduce_(amax)",
        exact_cases_max_abs_err=max_err.get("segment_reduce", 0),
        f32_sum_max_abs_err=max_err.get("segment_reduce_f32_sum", 0.0),
        f32_sum_max_err_over_bound=max_err.get(
            "segment_reduce_f32_sum_over_bound", 0.0),
        f32_sum_tolerance="count * 2^-23 * sum|v| per segment",
        device_kernels=one_data_kernel(
            "K5", lambda: segment_reduce_kernel(vals, seg, gs, "max"),
            "segment_reduce_kernel", memset=True),
        radix_histogram=histogram)
    del vals, seg, seg64, digit, digit64, ones

    # K6 at the largest radix pass: 8-bit digits of a slot key; the
    # chained order of a whole build side is timed beside it
    n = shapes["radix_rank"][0]
    hbits = max(int(2 * n - 1).bit_length(), 10)
    slot_key = torch.randint(0, 1 << hbits, (n,), generator=g,
                             device=device, dtype=torch.int32)
    digit = slot_key & 255
    base = RC.exclusive_bases(digit, 256)
    row("radix_rank", "src/repro_torch/csrc/radix_rank.cu",
        "src/repro/kernels/hash_join/hash_join.py:57",
        lambda: radix_rank_kernel(digit, base),
        lambda: radix_rank_torch(digit, base),
        lambda: torch.sort(digit, stable=True),
        8 * n, n, (n,), library_call="torch.sort(stable=True)",
        device_kernels=one_data_kernel(
            "K6", lambda: radix_rank_kernel(digit, base),
            "radix_rank_kernel", memset=True),
        order_key_bits=hbits,
        order_ms=time_ms(lambda: _radix_order(slot_key, key_bits=hbits)),
        order_argsort_ms=time_ms(
            lambda: torch.argsort(slot_key, stable=True)))
    order = _radix_order(slot_key, key_bits=hbits)
    if not torch.equal(order.long(), torch.argsort(slot_key, stable=True)):
        raise AssertionError("K6 chained order differs from the stable "
                             "argsort")

    # K10 at the largest source block the sharded e2e gave it: uniform
    # destinations (the key hash spreads rows evenly), the exchange's
    # fixed-stride offsets; K6 over the same P buckets, and K10 at P = 32,
    # beside it
    if "shard_rank" in shapes:
        n = shapes["shard_rank"][0]

        def k10_inputs(p):
            d = torch.randint(0, p, (n,), generator=g, device=device,
                              dtype=torch.int32)
            return d, torch.arange(p, dtype=torch.int32, device=device) * n

        dest, base = k10_inputs(n_shards)
        d32, b32 = k10_inputs(32)
        if not torch.equal(shard_rank_kernel(d32, b32),
                           shard_rank_torch(d32, b32, 32)):
            raise AssertionError("K10 at P = 32 differs from its plain "
                                 "version")
        if not torch.equal(radix_rank_kernel(dest, base),
                           shard_rank_kernel(dest, base)):
            raise AssertionError("K6 at B = P differs from K10")
        row("shard_rank", "src/repro_torch/csrc/shard_rank.cu",
            "src/repro/kernels/partition/partition.py:52",
            lambda: shard_rank_kernel(dest, base),
            lambda: shard_rank_torch(dest, base, n_shards),
            lambda: torch.sort(dest, stable=True),
            8 * n, n, (n, n_shards), library_call="torch.sort(stable=True)",
            k6_at_b_eq_p_ms=time_ms(lambda: radix_rank_kernel(dest, base)),
            at_p32_ms=time_ms(lambda: shard_rank_kernel(d32, b32)),
            at_p32_plain_ms=time_ms(lambda: shard_rank_torch(d32, b32, 32)),
            k6_at_p32_ms=time_ms(lambda: radix_rank_kernel(d32, b32)),
            device_kernels=one_data_kernel(
                "K10", lambda: shard_rank_kernel(dest, base),
                "shard_rank_kernel", memset=True))
        del dest, base, d32, b32

    # K7 at a full admission: the (B, S, H, d) projections as the model
    # passes them; 4d operations per visible (query, key) pair
    B, H, K, S, _, d = shapes["flash_attention"]
    q, k, v = (torch.randn(B, S, n, d, generator=g, device=device)
               .transpose(1, 2) for n in (H, K, K))
    kern7 = flash_attention_kernel(q, k, v, causal=True)
    err7 = float((kern7 - attention_ref(q, k, v, causal=True)).abs().max())
    if not err7 <= TOLERANCE:
        raise AssertionError(f"K7 at the serve shape: {err7} > {TOLERANCE}")
    pairs = B * H * S * (S + 1) // 2

    def k7_at(shape, window=0, path=None, causal=True, launches=None):
        """K7 at ``shape`` (B, H, K, Sq, Sk, d), causal (Sq = Sk) or
        not, within ``window`` when it is > 0: kernel, plain and SDPA
        (the window as a boolean mask) as graph replays, the bound over
        the visible pairs; with ``path``, that path's launches (or
        ``launches``, those at this shape) and the device listing."""
        B, H, K, Sq, Sk, d = shape
        q = torch.randn(B, Sq, H, d, generator=g,
                        device=device).transpose(1, 2)
        k, v = (torch.randn(B, Sk, K, d, generator=g, device=device)
                .transpose(1, 2) for _ in range(2))

        def kern():
            return flash_attention_kernel(q, k, v, causal=causal,
                                          window=window)

        def plain():
            return attention_ref(q, k, v, causal=causal, window=window)

        err = float((kern() - plain()).abs().max())
        if not err <= TOLERANCE:
            raise AssertionError(f"K7 causal {causal} window {window} at "
                                 f"{shape}: {err}")
        if window:
            dq = (torch.arange(Sq, device=device)[:, None]
                  - torch.arange(Sk, device=device)[None, :])
            library = sdpa_call(q, k, v, attn_mask=(dq >= 0) & (dq < window))
        else:
            library = sdpa_call(q, k, v, is_causal=causal)
        pairs = window_pairs(Sq, window) if causal else Sq * Sk
        out = {"shape": list(shape), "causal": causal, "window": window,
               "max_abs_err": err, "ms": time_ms(kern),
               "plain_ms": time_ms(plain), "library_ms": time_ms(library),
               **tc_bounds(4 * (2 * B * H * Sq * d + 2 * B * K * Sk * d),
                           4 * d * B * H * pairs)}
        if path:
            out.update(launches=by_path[path].get("flash_attention", 0)
                       if launches is None else launches, path=path,
                       wrapper_eager_ms=eager_ms(kern),
                       device_kernels=one_data_kernel(
                           f"K7 at {path}", kern, "flash_fwd_kernel"))
        del q, k, v
        return out

    k7_extra = {f"window_{label}": k7_at(shape, w)
                for label, (shape, w) in llm.get("k7", {}).items()}
    if "k7_moe" in llm:  # multi-head (group 1): olmoe's admissions
        k7_extra["at_serve_moe"] = k7_at(llm["k7_moe"], path="serve_moe")
    # each shard's local heads over a model mesh of the card
    for path, (k7s, _, _) in llm.get("tp", {}).items():
        k7_extra[f"at_{path}"] = k7_at(tuple(k7s), path=path)
    # the hybrid's window route on each data rank's rows
    for path, (k7s, window, _, _, _) in llm.get("tp_window", {}).items():
        k7_extra[f"at_{path}"] = k7_at(tuple(k7s), window, path=path)
    # and on each run of a tensor rank's heads (hymba at tp > 1)
    for path, (entries, window, _, _) in llm.get("tp_runs", {}).items():
        for e in entries:
            if e["kernel"] == "flash_attention":
                B, H, K = e["shape"][:3]
                k7_extra[f"at_{path}_run_{H}x{K}"] = k7_at(
                    tuple(e["shape"]), window, path=path,
                    launches=e["launches"])
    # the encoder-decoder's and the VLM's shapes, each with the launches
    # its phase's kernel path made at it: whisper's encoder (bidir),
    # decoder (causal) and cross-attention (bidir, Sq != Sk); paligemma's
    # prefix route (causal over all rows, bidir over the image rows)
    for phase, (entries, _) in llm.get("multimodal", {}).items():
        for e in entries:
            if e["kernel"] != "flash_attention":
                continue
            Sq, Sk = e["shape"][3], e["shape"][4]
            mode = e["variant"] if Sq == Sk else "cross"
            k7_extra[f"at_{phase}_{mode}"] = k7_at(
                tuple(e["shape"]), causal=e["variant"] == "causal",
                path=phase, launches=e["launches"])
    row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:97",
        lambda: flash_attention_kernel(q, k, v, causal=True),
        lambda: attention_ref(q, k, v, causal=True),
        sdpa_call(q, k, v, is_causal=True),
        4 * (2 * B * H * S * d + 2 * B * K * S * d), 4 * d * pairs,
        (B, H, K, S, S, d),
        err=max([err7, max_err.get("flash_attention", 0.0),
                 max_err.get("flash_attention_window", 0.0)]
                + [x["max_abs_err"] for x in k7_extra.values()]),
        causal=True, tolerance=TOLERANCE, tensor_cores=True,
        library_call="scaled_dot_product_attention(is_causal, gqa)",
        device_kernels=one_data_kernel(
            "K7", lambda: flash_attention_kernel(q, k, v, causal=True),
            "flash_fwd_kernel"),
        **k7_extra)

    # K8 over a (B, T, K, d) cache with the first decode round's lengths
    B, H, K, T, d = shapes["decode_attention"]
    lengths = torch.tensor(list(decode_lengths)[:B], dtype=torch.int32,
                           device=device)
    qd = torch.randn(B, H, d, generator=g, device=device)
    kc, vc = (torch.randn(B, T, K, d, generator=g, device=device)
              .permute(0, 2, 1, 3) for _ in range(2))
    kern8 = decode_attention_kernel(qd, kc, vc, lengths)
    err8 = float((kern8 - decode_attention_ref(qd, kc, vc, lengths))
                 .abs().max())
    if not err8 <= TOLERANCE:
        raise AssertionError(f"K8 at the serve shape: {err8} > {TOLERANCE}")
    live = int(lengths.clamp(max=T).sum())
    mask = (torch.arange(T, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    k8_extra = {}

    def k8_slot_mask(shape, lens, window, prefill_len, path=None,
                     launches=None):
        """K8 under the slot mask in the hybrid's first decode round:
        prefill wrote slots 0..prefill_len-1 and the round's slot pos =
        len - 1 holds pos; with ``path``, that path's launches (or
        ``launches``, those at this shape)."""
        Bh, Hh, Kh, Th, dh = shape
        ph = torch.tensor(list(lens)[:Bh], dtype=torch.int32,
                          device=device) - 1
        sp = torch.arange(Th, dtype=torch.int32, device=device).expand(
            Bh, Th).contiguous()
        sp[:, prefill_len:] = -1
        qh = torch.randn(Bh, Hh, dh, generator=g, device=device)
        kh, vh = (torch.randn(Bh, Th, Kh, dh, generator=g, device=device)
                  .permute(0, 2, 1, 3) for _ in range(2))

        def k8s():
            return decode_attention_kernel(qh, kh, vh, slot_pos=sp, pos=ph,
                                           window=window)

        def k8p():
            return decode_attention_ref(qh, kh, vh, slot_pos=sp, pos=ph,
                                        window=window)

        errh = float((k8s() - k8p()).abs().max())
        if not errh <= TOLERANCE:
            raise AssertionError(f"K8 slot mask at {shape}: {errh}")
        ok_h = (sp >= 0) & (sp <= ph[:, None])
        live_h = int(ok_h.sum())
        b_ms, b_by = bound_ms(
            4 * (2 * Bh * Hh * dh + 2 * Kh * dh * live_h + Bh * Th + Bh),
            4 * dh * Hh * live_h)
        row_ = {
            "shape": list(shape), "window": window, "live": live_h,
            "max_abs_err": errh, "ms": time_ms(k8s),
            "plain_ms": time_ms(k8p), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(sdpa_call(
                qh[:, :, None], kh, vh,
                attn_mask=ok_h[:, None, None, :])),
            "wrapper_eager_ms": eager_ms(k8s),
            "device_kernels": one_data_kernel(
                f"K8 slot mask{f' at {path}' if path else ''}", k8s,
                "decode_kernel", memset=True)}
        if path:
            row_.update(launches=by_path[path].get("decode_attention", 0)
                        if launches is None else launches, path=path)
        del qh, kh, vh
        return row_

    if "k8" in llm:
        shape, lens, window = llm["k8"]
        k8_extra["slot_mask_hybrid"] = k8_slot_mask(
            shape, lens, window, llm["k8_prefill_len"])
    for path, (_, window, k8s_, lens, plen) in llm.get("tp_window",
                                                       {}).items():
        k8_extra[f"slot_mask_at_{path}"] = k8_slot_mask(
            tuple(k8s_), lens, window, plen, path)
    for path, (entries, window, lens, plen) in llm.get("tp_runs",
                                                       {}).items():
        for e in entries:
            if e["kernel"] == "decode_attention":
                B, H, K = e["shape"][:3]
                k8_extra[f"slot_mask_at_{path}_run_{H}x{K}"] = k8_slot_mask(
                    tuple(e["shape"]), lens, window, plen, path,
                    e["launches"])
    if "k8_long" in llm:
        # long_prefill's decode: the 2048-slot ring wrapped, every slot
        # live
        (Bl, Hl, Kl, Tl, dl), window = llm["k8_long"]
        sp_l, pos_l = AC.full_ring(Tl)
        spl = torch.tensor([sp_l] * Bl, dtype=torch.int32, device=device)
        pl_ = torch.full((Bl,), pos_l, dtype=torch.int32, device=device)
        ql = torch.randn(Bl, Hl, dl, generator=g, device=device)
        kl, vl = (torch.randn(Bl, Tl, Kl, dl, generator=g, device=device)
                  .permute(0, 2, 1, 3) for _ in range(2))

        def k8l():
            return decode_attention_kernel(ql, kl, vl, slot_pos=spl,
                                           pos=pl_, window=window)

        def k8lp():
            return decode_attention_ref(ql, kl, vl, slot_pos=spl, pos=pl_,
                                        window=window)

        errl = float((k8l() - k8lp()).abs().max())
        if not errl <= TOLERANCE:
            raise AssertionError(f"K8 at long_prefill's ring: {errl}")
        ok_l = (spl >= 0) & (spl <= pl_[:, None]) & \
            (pl_[:, None] - spl < window)
        live_l = int(ok_l.sum())
        b_ms, b_by = bound_ms(
            4 * (2 * Bl * Hl * dl + 2 * Kl * dl * live_l + Bl * Tl + Bl),
            4 * dl * Hl * live_l)
        k8_extra["slot_mask_long_prefill"] = {
            "shape": [Bl, Hl, Kl, Tl, dl], "window": window,
            "live": live_l, "max_abs_err": errl, "ms": time_ms(k8l),
            "plain_ms": time_ms(k8lp), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(sdpa_call(
                ql[:, :, None], kl, vl, attn_mask=ok_l[:, None, None, :])),
            "wrapper_eager_ms": eager_ms(k8l),
            "device_kernels": one_data_kernel(
                "K8 long_prefill ring", k8l, "decode_kernel", memset=True)}
        del ql, kl, vl
    def k8_at(shape, lens, path, label):
        """K8 at ``shape`` (B, H, K, T, d) with ``lens`` (a first decode
        round's pos + 1, each row's), that path's launches."""
        Bm, Hm, Km, Tm, dm = shape
        lm = torch.tensor(list(lens)[:Bm], dtype=torch.int32, device=device)
        qm = torch.randn(Bm, Hm, dm, generator=g, device=device)
        km, vm = (torch.randn(Bm, Tm, Km, dm, generator=g, device=device)
                  .permute(0, 2, 1, 3) for _ in range(2))

        def k8m():
            return decode_attention_kernel(qm, km, vm, lm)

        errm = float((k8m() - decode_attention_ref(qm, km, vm, lm))
                     .abs().max())
        if not errm <= TOLERANCE:
            raise AssertionError(f"K8 at the {label} shape: {errm}")
        live_m = int(lm.clamp(max=Tm).sum())
        b_ms, b_by = bound_ms(
            4 * (2 * Bm * Hm * dm + 2 * Km * dm * live_m + Bm),
            4 * dm * Hm * live_m)
        mask_m = (torch.arange(Tm, device=device)[None, :]
                  < lm[:, None])[:, None, None, :]
        row_ = {
            "shape": list(shape), "live": live_m,
            "lengths": lm.tolist(), "max_abs_err": errm,
            "launches": by_path[path].get("decode_attention", 0),
            "path": path, "ms": time_ms(k8m),
            "plain_ms": time_ms(lambda: decode_attention_ref(qm, km, vm,
                                                             lm)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(sdpa_call(qm[:, :, None], km, vm,
                                            attn_mask=mask_m)),
            "wrapper_eager_ms": eager_ms(k8m),
            "device_kernels": one_data_kernel(
                f"K8 at {label}", k8m, "decode_kernel", memset=True)}
        del qm, km, vm
        return row_

    if "k8_moe" in llm:
        # multi-head (group 1): olmoe's first decode round, lengths
        shape, lens = llm["k8_moe"]
        k8_extra["at_serve_moe"] = k8_at(shape, lens, "serve_moe",
                                         "serve_moe")
    # each shard's local heads over a model mesh of the card
    for path, (k7s, k8s, lens) in llm.get("tp", {}).items():
        k8_extra[f"at_{path}"] = k8_at(tuple(k8s), lens, path, path)
    def k8_err(got, want, lm) -> float:
        """K8 against its plain version: the output, and on the
        log-sum-exp route also the lse of the rows with a live slot;
        there a row with nothing live must be exactly 0 and -inf."""
        if not isinstance(got, tuple):
            return float((got - want).abs().max())
        (o, lse), (wo, wl) = got, want
        live = lm > 0
        if bool(torch.isnan(o).any() or torch.isnan(lse).any()) or not (
                bool(torch.isneginf(lse[~live]).all())
                and not bool(o[~live].any())):
            raise AssertionError("K8's log-sum-exp route: a row with "
                                 "nothing live is not 0 and -inf")
        return max(float((o - wo).abs().max()), float(
            (lse[live] - wl[live]).abs().max()) if bool(live.any()) else 0.0)

    def k8_lse_at(shape, lens, path, label):
        """K8's log-sum-exp route at one rank's slice (B, H, K, n, d) of
        a cache split over the sequence, ``lens`` its lengths clamp(pos +
        1 - lo, 0, n) (0: a row with nothing live there), that path's
        launches; the library call is SDPA over the same mask, the
        output alone."""
        Bm, Hm, Km, Tm, dm = shape
        lm = torch.tensor(list(lens)[:Bm], dtype=torch.int32, device=device)
        qm = torch.randn(Bm, Hm, dm, generator=g, device=device)
        km, vm = (torch.randn(Bm, Tm, Km, dm, generator=g, device=device)
                  .permute(0, 2, 1, 3) for _ in range(2))

        def k8m():
            return decode_attention_kernel(qm, km, vm, lm, return_lse=True)

        def k8p():
            return decode_attention_ref(qm, km, vm, lm, return_lse=True)

        errm = k8_err(k8m(), k8p(), lm)
        if not errm <= TOLERANCE:
            raise AssertionError(f"K8 lse at the {label} shape: {errm}")
        live_m = int(lm.sum())
        b_ms, b_by = bound_ms(
            4 * (2 * Bm * Hm * dm + Bm * Hm + 2 * Km * dm * live_m + Bm),
            4 * dm * Hm * live_m)
        mask_m = (torch.arange(Tm, device=device)[None, :]
                  < lm[:, None])[:, None, None, :]
        row_ = {
            "route": "lengths_lse", "shape": list(shape), "live": live_m,
            "lengths": lm.tolist(), "empty_rows": int((lm == 0).sum()),
            "max_abs_err": errm,
            "launches": by_path[path].get("decode_attention", 0),
            "path": path, "ms": time_ms(k8m), "plain_ms": time_ms(k8p),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(sdpa_call(qm[:, :, None], km, vm,
                                            attn_mask=mask_m)),
            "library_call": "scaled_dot_product_attention(attn_mask, "
                            "gqa), the output alone",
            "wrapper_eager_ms": eager_ms(k8m),
            "device_kernels": one_data_kernel(
                f"K8 lse at {label}", k8m, "decode_kernel", memset=True)}
        del qm, km, vm
        return row_

    for label, (shape, lens, path) in llm.get("k8_lse", {}).items():
        k8_extra[f"lse_at_{label}"] = k8_lse_at(tuple(shape), lens, path,
                                                label)
    # the encoder-decoder's self and cross decode and the VLM's decode:
    # lengths, every row at its phase's last step (cross: every encoder
    # slot); under shard_cache_seq the self decode's log-sum-exp route
    # over a rank's slice, whose every slot is then live
    for phase, (entries, lens) in llm.get("multimodal", {}).items():
        for e in entries:
            if e["kernel"] != "decode_attention":
                continue
            Bm, Hm, Km, Tm, dm = e["shape"]
            kind = "cross" if Tm == lens["cross"] else "self"
            lse = e["variant"].endswith("_lse")
            lm = torch.full((Bm,), min(lens[kind], Tm), dtype=torch.int32,
                            device=device)
            qm = torch.randn(Bm, Hm, dm, generator=g, device=device)
            km, vm = (torch.randn(Bm, Tm, Km, dm, generator=g,
                                  device=device).permute(0, 2, 1, 3)
                      for _ in range(2))

            def k8m(qm=qm, km=km, vm=vm, lm=lm, lse=lse):
                return decode_attention_kernel(qm, km, vm, lm,
                                               return_lse=lse)

            def k8p(qm=qm, km=km, vm=vm, lm=lm, lse=lse):
                return decode_attention_ref(qm, km, vm, lm, return_lse=lse)

            errm = k8_err(k8m(), k8p(), lm)
            if not errm <= TOLERANCE:
                raise AssertionError(f"K8 at {phase} {kind} {e['shape']}: "
                                     f"{errm}")
            live_m = int(lm.sum())
            b_ms, b_by = bound_ms(
                4 * (2 * Bm * Hm * dm + Bm * Hm * lse + 2 * Km * dm * live_m
                     + Bm), 4 * dm * Hm * live_m)
            mask_m = (torch.arange(Tm, device=device)[None, :]
                      < lm[:, None])[:, None, None, :]
            k8_extra[f"at_{phase}_{kind}"] = {
                "route": e["variant"], "shape": list(e["shape"]),
                "live": live_m,
                "lengths": lm[0].item(), "max_abs_err": errm,
                "launches": e["launches"], "path": phase,
                "ms": time_ms(k8m), "plain_ms": time_ms(k8p),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(sdpa_call(qm[:, :, None], km, vm,
                                                attn_mask=mask_m)),
                "wrapper_eager_ms": eager_ms(k8m),
                "device_kernels": one_data_kernel(
                    f"K8 at {phase} {kind}", k8m, "decode_kernel",
                    memset=True)}
            del qm, km, vm
    row("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:78",
        lambda: decode_attention_kernel(qd, kc, vc, lengths),
        lambda: decode_attention_ref(qd, kc, vc, lengths),
        sdpa_call(qd[:, :, None], kc, vc, attn_mask=mask),
        4 * (2 * B * H * d + 2 * K * d * live + B), 4 * d * H * live,
        (B, H, K, T, d),
        err=max([err8, max_err.get("decode_attention", 0.0),
                 max_err.get("decode_attention_ring", 0.0)]
                + [x["max_abs_err"] for x in k8_extra.values()]),
        lengths=lengths.tolist(), tolerance=TOLERANCE,
        library_call="scaled_dot_product_attention(attn_mask, gqa)",
        chunk=AC.DECODE_CHUNK,
        device_kernels=one_data_kernel(
            "K8", lambda: decode_attention_kernel(qd, kc, vc, lengths),
            "decode_kernel", memset=True),
        **k8_extra)

    # K9 at a full admission of the SSM model, then at the other shapes
    # its paths gave it; the model's strided layout and distribution
    def k9_case(shape):
        b, s, h, p, n, chunk = shape
        x, dt, A, B, C = SC.case_inputs(b, s, h, p, n, chunk, g, device)
        got = ssd_chunk_kernel(x, dt, A, B, C, chunk=chunk)
        want = ssd_chunk_ref(x, dt, A, B, C, chunk)
        tol = SC.tolerance(SC.cum_max(dt, A, chunk))
        err = 0.0
        for a, w in zip(got, want):
            e = float((a - w).abs().max())
            if not e <= tol * max(1.0, float(w.abs().max())):
                raise AssertionError(f"K9 at {shape}: {e}")
            err = max(err, e)
        return (x, dt, A, B, C, chunk), err

    def k9_blocks(args):
        """K9's head groups (``head_groups``) and blocks at ``args``."""
        x, _, _, B, _, chunk = args
        b, s, h, p = x.shape
        groups = head_groups(b, s // chunk, h, chunk, p, B.shape[-1],
                             device)
        return {"groups": groups, "blocks": b * (s // chunk) * groups}

    def k9_at(shape, path=None):
        """K9 at ``shape``; with ``path``, that path's launches."""
        args, err = k9_case(tuple(shape))

        def kern():
            return ssd_chunk_kernel(*args[:5], chunk=args[5])

        row_ = {"shape": list(shape), "max_abs_err": err,
                "ms": time_ms(kern),
                "plain_ms": time_ms(lambda: ssd_chunk_ref(*args)),
                **tc_bounds(*ssd_work(*shape)), **k9_blocks(args)}
        if path:
            row_.update(launches=by_path[path].get("ssd_chunk", 0),
                        path=path, wrapper_eager_ms=eager_ms(kern))
        return row_

    extra9 = {f"at_{label}": k9_at(shape)
              for label, shape in llm.get("k9", {}).items()}
    # each data rank's rows over a model mesh of the card
    extra9.update({f"at_{path}": k9_at(shape, path)
                   for path, shape in llm.get("k9_tp", {}).items()})
    if "ssd_chunk" in shapes:
        shape = shapes["ssd_chunk"]
        args, err9 = k9_case(shape)
        row("ssd_chunk", "src/repro_torch/csrc/ssd.cu",
            "src/repro/kernels/ssd/ssd.py:68",
            lambda: ssd_chunk_kernel(*args[:5], chunk=args[5]),
            lambda: ssd_chunk_ref(*args), None, *ssd_work(*shape), shape,
            err=max([err9, max_err.get("ssd_chunk", 0.0)]
                    + [x["max_abs_err"] for x in extra9.values()]),
            tolerance="ssd_cases.tolerance: 1e-5 + 2^-23 max|cum|, of "
                      "max(1, max|plain|)", library_call=None,
            tensor_cores=True, **k9_blocks(args),
            device_kernels=one_data_kernel(
                "K9", lambda: ssd_chunk_kernel(*args[:5], chunk=args[5]),
                "ssd_chunk_kernel"),
            **extra9)
    return rows


# ------------------------------------------------------------------- main

# kernels each main path must launch
SORT_MERGE_KERNELS = ("prefix_count", "hash_rows", "group_boundaries",
                      "running_segment_ids")
HASH_KERNELS = ("prefix_count", "running_segment_ids", "segment_reduce",
                "radix_rank")
ATTN_KERNELS = ("flash_attention", "decode_attention")
SHARDED_KERNELS = ("prefix_count", "hash_rows", "shard_rank",
                   "segment_reduce")
TP_CARD_NOTE = ("every position of the model mesh lies on the one card: "
                "the shards run one after another and every collective "
                "is a copy on the card, so these times measure the "
                "sharded code path, not a multi-card interconnect")
SHARED_CARD_NOTE = ("four shards on one card: these times measure the "
                    "tier's kernels, layout and host merges, not an "
                    "interconnect")


def ptxas_report(log: str) -> dict:
    """nvcc's ``-Xptxas -v`` report: each source's register lines, and
    every kernel instance that spills (its mangled name and ptxas's
    stack and spill line)."""
    lines, spills, fn = [], [], None
    for ln in log.split("\n"):
        ln = ln.strip()
        if "registers" in ln or ln.startswith("== "):
            lines.append(ln)
        elif "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
        elif "spill stores" in ln and not ln.startswith(
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill"):
            spills.append({"function": fn, "line": ln})
    return {"lines": lines, "spills": spills}


def k8_lse_cases(tp_seq: dict, AC) -> dict:
    """The kernels line's K8 log-sum-exp rows at ``serve_tp_seq``'s rank
    slice (B, H, K, n, d): the first decode round's lengths at the
    second rank's slice [n, 2n) (rows whose position lies before it
    hold nothing live there), and positions spread around the fourth
    rank's (``attention_cases.slice_lengths``, several rows empty)."""
    out = {}
    for label, res in tp_seq["meshes"].items():
        shape = res["kernel"]["shapes"]["decode_attention"]
        n = shape[3]
        out[f"serve_tp_seq_{label}_rank1"] = (
            shape, [min(max(m - n, 0), n) for m in res["decode_lengths"]],
            f"serve_tp_seq_{label}")
        out[f"serve_tp_seq_{label}_empty_rows"] = (
            shape, AC.slice_lengths(shape[0], n, 3 * n),
            f"serve_tp_seq_{label}")
    return out


def require_launched(path: str, launches: dict, names) -> None:
    missing = [k for k in names if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention_cases as AC
    from repro_torch.kernels import partition_cases as PC
    from repro_torch.kernels import radix_cases as RC
    from repro_torch.kernels import reduce_cases as RD
    from repro_torch.kernels import scan_cases as SC

    device = torch.device("cuda", 0)
    # the reference computes in float32: no TF32 in matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_INFO.get("seconds"),
          "cached": _build.BUILD_INFO.get("cached"), "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    emit({"phase": "ptxas", **ptxas_report(_build.BUILD_INFO.get("log",
                                                                 ""))})

    t0 = time.perf_counter()
    cases, errs = check_kernels(device)
    lib_tile = _build.library().repro_lookback_tile()
    if lib_tile != SC.TILE:
        raise AssertionError(f"scan_cases.TILE {SC.TILE} differs from the "
                             f"library's look-back tile {lib_tile}")
    lookback = check_lookback(device)
    for k, c in lookback.items():
        cases[k] += c
    lib = _build.library()
    if lib.repro_radix_rank_tiles(RC.TILE) != 1 or \
            lib.repro_radix_rank_tiles(RC.TILE + 1) != 2:
        raise AssertionError(f"radix_cases.TILE {RC.TILE} is not the "
                             f"library's K6 tile")
    radix = check_radix(device)
    cases["radix_rank"] += radix
    if lib.repro_shard_rank_tiles(PC.TILE) != 1 or \
            lib.repro_shard_rank_tiles(PC.TILE + 1) != 2:
        raise AssertionError(f"partition_cases.TILE {PC.TILE} is not the "
                             f"library's K10 tile")
    shard = check_shard(device)
    cases["shard_rank"] += shard
    if (lib.repro_segment_reduce_batch(),
            lib.repro_segment_reduce_shared_max()) != (RD.BATCH,
                                                       RD.SHARED_MAX):
        raise AssertionError("reduce_cases.BATCH/SHARED_MAX differ from "
                             "the library's K5 batch and shared limit")
    reduce = check_reduce(device)
    cases["segment_reduce"] += reduce
    emit({"phase": "kernels", "bit_identical_cases": cases,
          "max_abs_err": errs, "tolerance": 0,
          "sizes": list(EDGE_SIZES),
          "lookback": {"tile": lib_tile, "sizes": list(SC.SIZES),
                       "kinds": list(SC.KINDS),
                       "key_kinds": list(SC.KEY_KINDS),
                       "repeats": SC.REPEATS,
                       "offsets": list(SC.OFFSETS),
                       "graph_replays": SC.REPLAYS, "streams": 2,
                       "cases": lookback},
          "radix": {"tile": RC.TILE, "sizes": list(RC.SIZES),
                    "kinds": list(RC.KINDS), "buckets": list(RC.BUCKETS),
                    "repeats": RC.REPEATS, "graph_replays": RC.REPLAYS,
                    "streams": 2, "cases": radix},
          "shard": {"tile": PC.TILE, "sizes": list(PC.SIZES),
                    "shards": list(PC.SHARDS), "dests": list(PC.DESTS),
                    "bases": list(PC.BASES), "repeats": PC.REPEATS,
                    "graph_replays": PC.REPLAYS, "streams": 2,
                    "cases": shard},
          "reduce": {"batch": RD.BATCH, "sizes": list(RD.SIZES),
                     "segments": list(RD.SEGMENTS),
                     "id_kinds": list(RD.ID_KINDS),
                     "offsets": list(RD.OFFSETS),
                     "graph_replays": RD.REPLAYS, "streams": 2,
                     "cases": reduce},
          "seconds": time.perf_counter() - t0, "gpu": smi})
    t0 = time.perf_counter()
    if lib.repro_decode_chunk() != AC.DECODE_CHUNK:
        raise AssertionError(f"attention_cases.DECODE_CHUNK "
                             f"{AC.DECODE_CHUNK} differs from the "
                             f"library's {lib.repro_decode_chunk()}")
    attn = check_attention(device)
    errs.update(attn["max_abs_err"])
    split = check_decode_split(device)
    errs["decode_attention_split"] = split["max_abs_err"]
    emit({"phase": "attention", **attn, "decode_split": split,
          "decode_chunk": AC.DECODE_CHUNK,
          "seconds": time.perf_counter() - t0, "gpu": smi})
    t0 = time.perf_counter()
    ssd = check_ssd(device)
    errs["ssd_chunk"] = ssd["max_abs_err"]
    emit({"phase": "ssd", **ssd, "seconds": time.perf_counter() - t0,
          "gpu": smi})

    e2e = run_e2e(device)
    emit({"phase": "e2e", **e2e, "gpu": smi})
    require_launched("e2e", e2e["launches"], SORT_MERGE_KERNELS)

    e2e_hash = run_e2e_hash(device)
    emit({"phase": "e2e_hash", **e2e_hash, "gpu": smi})
    require_launched("e2e_hash", e2e_hash["launches"], HASH_KERNELS)

    corpus = {}
    for config, params, need in (("sort_merge", SORT_MERGE,
                                  SORT_MERGE_KERNELS),
                                 ("default", DEFAULT, ("radix_rank",))):
        t0 = time.perf_counter()
        corpus[config] = run_corpus(device, params=params)
        emit({"phase": "corpus", "config": config, **corpus[config],
              "seconds": time.perf_counter() - t0, "gpu": smi})
        require_launched(f"corpus {config}", corpus[config]["launches"], need)

    t0 = time.perf_counter()
    stream = run_stream(device)
    emit({"phase": "stream", **stream, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    require_launched("stream", stream["launches"],
                     ("radix_rank", "segment_reduce"))

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = run_e2e_sharded(device)
    emit({"phase": "e2e_sharded", **sharded,
          "seconds": time.perf_counter() - t0, "gpu": smi,
          "note": SHARED_CARD_NOTE})
    require_launched("e2e_sharded", sharded["cold"]["launches"],
                     SHARDED_KERNELS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sstream = run_sharded_stream(device)
    emit({"phase": "sharded_stream", **sstream,
          "seconds": time.perf_counter() - t0, "gpu": smi,
          "note": SHARED_CARD_NOTE})
    require_launched("sharded_stream (aggregate)",
                     sstream["aggregate"]["partitioned"]["launches"],
                     ("hash_rows", "shard_rank", "segment_reduce"))
    require_launched("sharded_stream (join)",
                     sstream["join"]["partitioned"]["launches"],
                     ("hash_rows", "shard_rank"))
    torch.cuda.empty_cache()

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve = run_serve(device)
    engines = serve.pop("engines")
    serve.pop("answers")
    emit({"phase": "serve", **serve, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    require_launched("serve", serve["kernel"]["launches"], ATTN_KERNELS)

    t0 = time.perf_counter()
    llm = run_llm_query(device, engines, scale=LLM_QUERY_SCALE)
    emit({"phase": "llm_query", **llm, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    require_launched("llm_query", llm["launches"], ATTN_KERNELS)

    # starcoder2-3b's weights over a (1, 4) mesh of the card
    t0 = time.perf_counter()
    tp_dense = run_serve_tp(device, SERVE_ARCH, TP_MESHES[SERVE_ARCH],
                            params=engines[0].params)
    tp_dense.pop("engines")
    single_dense = tp_dense.pop("single")
    gc.collect()  # an engine and its scheduler refer to each other
    torch.cuda.empty_cache()
    emit({"phase": "serve_tp_dense", **tp_dense,
          "seconds": time.perf_counter() - t0, "gpu": smi,
          "note": TP_CARD_NOTE})
    for label, res in tp_dense["meshes"].items():
        require_launched(f"serve_tp_dense {label}",
                         res["kernel"]["launches"], ATTN_KERNELS)
    # the same weights over (1, 4) with the caches split over the
    # sequence, held to the same single-device answers
    t0 = time.perf_counter()
    tp_seq = run_serve_tp(device, SERVE_ARCH, TP_SEQ_MESHES,
                          params=engines[0].params, single=single_dense)
    del engines, single_dense
    tp_seq.pop("engines")
    tp_seq.pop("single")
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_tp_seq", **tp_seq,
          "seconds": time.perf_counter() - t0, "gpu": smi,
          "note": TP_CARD_NOTE})
    for label, res in tp_seq["meshes"].items():
        require_launched(f"serve_tp_seq {label}", res["kernel"]["launches"],
                         ATTN_KERNELS)

    served = {}
    for phase, arch, need in (("serve_ssm", SSM_ARCH, ("ssd_chunk",)),
                              ("serve_hybrid", HYBRID_ARCH, LLM_KERNELS)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        served[phase] = run_serve(device, arch=arch, n_prompts=SSM_PROMPTS)
        out = {k: v for k, v in served[phase].items()
               if k not in ("engines", "answers")}
        emit({"phase": phase, **out, "seconds": time.perf_counter() - t0,
              "gpu": smi})
        require_launched(phase, out["kernel"]["launches"], need)
    ssm, hyb = served["serve_ssm"], served["serve_hybrid"]

    t0 = time.perf_counter()
    long = run_long_prefill(device, ssm["engines"][0], hyb["engines"][0])
    emit({"phase": "long_prefill", **long,
          "seconds": time.perf_counter() - t0, "gpu": smi})
    require_launched("long_prefill (ssm)", long["ssm"]["launches"],
                     ("ssd_chunk",))
    require_launched("long_prefill (hybrid)", long["hybrid"]["launches"],
                     LLM_KERNELS)

    # serve_ssm's and serve_hybrid's trees over model meshes of the card,
    # held to their one-device answers
    t0 = time.perf_counter()
    tp_ssm = {}
    for arch, run in ((SSM_ARCH, ssm), (HYBRID_ARCH, hyb)):
        tp_ssm[arch] = run_serve_tp(device, arch, TP_MESHES[arch],
                                    params=run["engines"][0].params,
                                    single=run["answers"],
                                    n_prompts=SSM_PROMPTS)
        del tp_ssm[arch]["engines"], tp_ssm[arch]["single"]
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "serve_tp_ssm", **tp_ssm,
          "seconds": time.perf_counter() - t0, "gpu": smi,
          "note": TP_CARD_NOTE})
    for arch, need in ((SSM_ARCH, ("ssd_chunk",)),
                       (HYBRID_ARCH, LLM_KERNELS)):
        for label, res in tp_ssm[arch]["meshes"].items():
            require_launched(f"serve_tp_ssm {arch} {label}",
                             res["kernel"]["launches"], need)
    del ssm["engines"]
    gc.collect()

    t0 = time.perf_counter()
    llm_h = run_llm_query(device, hyb.pop("engines"), qids=HYBRID_QIDS)
    emit({"phase": "llm_query_hybrid", **llm_h,
          "seconds": time.perf_counter() - t0, "gpu": smi})
    require_launched("llm_query_hybrid", llm_h["launches"], LLM_KERNELS)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    moe = run_serve(device, arch=MOE_ARCH, n_prompts=MOE_PROMPTS)
    moe_engines = moe.pop("engines")
    moe_answers = moe.pop("answers")
    emit({"phase": "serve_moe", **moe, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    require_launched("serve_moe", moe["kernel"]["launches"], ATTN_KERNELS)
    t0 = time.perf_counter()
    llm_m = run_llm_query(device, moe_engines, qids=HYBRID_QIDS)
    emit({"phase": "llm_query_moe", **llm_m,
          "seconds": time.perf_counter() - t0, "gpu": smi})
    require_launched("llm_query_moe", llm_m["launches"], ATTN_KERNELS)

    # olmoe-1b-7b's weights over (1, 2) and (2, 2) meshes of the card,
    # held to serve_moe's answers at dp = 1
    t0 = time.perf_counter()
    tp = run_serve_tp(device, MOE_ARCH, TP_MESHES[MOE_ARCH],
                      params=moe_engines[0].params, single=moe_answers)
    tp_engines = tp.pop("engines")
    tp.pop("single")
    emit({"phase": "serve_tp", **tp, "seconds": time.perf_counter() - t0,
          "gpu": smi, "note": TP_CARD_NOTE})
    for label, res in tp["meshes"].items():
        require_launched(f"serve_tp {label}", res["kernel"]["launches"],
                         ATTN_KERNELS)
    t0 = time.perf_counter()
    llm_tp = run_llm_query(device, tp_engines, scale=LLM_QUERY_TP_SCALE,
                           qids=HYBRID_QIDS,
                           route_ties=True)
    emit({"phase": "llm_query_tp", **llm_tp,
          "seconds": time.perf_counter() - t0, "gpu": smi,
          "note": TP_CARD_NOTE})
    require_launched("llm_query_tp", llm_tp["launches"], ATTN_KERNELS)
    del moe_engines, tp_engines
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mla = run_serve_mla(device)
    mla_engine = mla.pop("engine")
    emit({"phase": "serve_mla", **mla, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    t0 = time.perf_counter()
    llm_mla = run_llm_query(device, (mla_engine, mla_engine),
                            qids=HYBRID_QIDS, second="repeat")
    emit({"phase": "llm_query_mla", **llm_mla,
          "seconds": time.perf_counter() - t0, "gpu": smi})
    require_launched("llm_query_mla", llm_mla["launches"], QUERY_KERNELS)
    if any(llm_mla["launches"][k] for k in LLM_KERNELS):
        raise AssertionError(f"llm_query_mla: MLA launched "
                             f"{llm_mla['launches']}")
    # one device's answers, routings and prefill logits for the mesh,
    # then the 54.85 GB model freed before its mesh tree is made
    t0 = time.perf_counter()
    one_mla = mla_one_device(mla_engine)
    del mla_engine
    gc.collect()
    torch.cuda.empty_cache()
    tp_mla = run_serve_tp_mla(device, one_mla)
    del one_mla
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_tp_mla", **tp_mla,
          "seconds": time.perf_counter() - t0, "gpu": smi,
          "note": TP_CARD_NOTE})

    mm, mm_tp = {}, {}
    for phase in MULTIMODAL:
        t0 = time.perf_counter()
        mm[phase] = run_multimodal(device, phase)
        one = mm[phase].pop("one_device")
        emit({"phase": phase, **mm[phase],
              "seconds": time.perf_counter() - t0, "gpu": smi})
        require_launched(phase, mm[phase]["paths"]["kernel"]["launches"],
                         ATTN_KERNELS)
        if any(mm[phase]["paths"]["plain"]["launches"].values()):
            raise AssertionError(f"{phase}: the plain path launched "
                                 f"{mm[phase]['paths']['plain']}")
        # the same tree and inputs over model meshes of the card
        t0 = time.perf_counter()
        mm_tp[phase] = run_multimodal_tp(device, phase, one)
        del one
        emit({"phase": "mm_tp", "family": phase, **mm_tp[phase],
              "seconds": time.perf_counter() - t0, "gpu": smi,
              "note": TP_CARD_NOTE})
        for label, res in mm_tp[phase]["meshes"].items():
            require_launched(f"mm_tp {phase} {label}",
                             res["paths"]["kernel"]["launches"],
                             ATTN_KERNELS)
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tequiv = run_train_equiv(device)
    emit({"phase": "train_equiv", **tequiv,
          "seconds": time.perf_counter() - t0, "gpu": smi})
    t0 = time.perf_counter()
    train = run_train(device)
    emit({"phase": "train", **train, "seconds": time.perf_counter() - t0,
          "gpu": smi})
    t0 = time.perf_counter()
    train_tp = run_train_tp(device, train)
    emit({"phase": "train_tp", **train_tp,
          "seconds": time.perf_counter() - t0, "gpu": smi,
          "note": TP_CARD_NOTE})
    t0 = time.perf_counter()
    tback = run_train_backend(device)
    emit({"phase": "train_backend", **tback,
          "seconds": time.perf_counter() - t0, "gpu": smi})
    gc.collect()
    torch.cuda.empty_cache()

    launches = dict(e2e["launches"])
    shapes = dict(e2e["shapes"])
    for k in ("segment_reduce", "radix_rank"):
        launches[k] = e2e_hash["launches"][k]
        shapes[k] = e2e_hash["shapes"][k]
    launches["shard_rank"] = sharded["cold"]["launches"]["shard_rank"]
    shapes["shard_rank"] = sharded["cold"]["shapes"]["shard_rank"]
    for k in ATTN_KERNELS:
        launches[k] = serve["kernel"]["launches"][k]
        shapes[k] = serve["kernel"]["shapes"][k]
    launches["ssd_chunk"] = ssm["kernel"]["launches"]["ssd_chunk"]
    shapes["ssd_chunk"] = ssm["kernel"]["shapes"]["ssd_chunk"]
    hshapes = hyb["kernel"]["shapes"]
    lshapes = long["hybrid"]["shapes"]
    window = hyb["attn_window"]
    llm_shapes = {
        "k7": {"serve_hybrid": (hshapes["flash_attention"], window),
               "long_prefill": (lshapes["flash_attention"], window)},
        "k8": (hshapes["decode_attention"], hyb["decode_lengths"], window),
        "k8_prefill_len": hyb["max_seq"],
        "k8_long": (lshapes["decode_attention"], window),
        "k7_moe": moe["kernel"]["shapes"]["flash_attention"],
        "k8_moe": (moe["kernel"]["shapes"]["decode_attention"],
                   moe["decode_lengths"]),
        "tp": {f"{phase}_{label}": (res["kernel"]["shapes"][
            "flash_attention"], res["kernel"]["shapes"]["decode_attention"],
            res["decode_lengths"])
            for phase, run in (("serve_tp_dense", tp_dense),
                               ("serve_tp", tp))
            for label, res in run["meshes"].items()},
        "k8_lse": k8_lse_cases(tp_seq, AC),
        "tp_window": {
            f"serve_tp_ssm_{label}": (
                res["kernel"]["shapes"]["flash_attention"],
                res["attn_window"],
                res["kernel"]["shapes"]["decode_attention"],
                res["decode_lengths"], hyb["max_seq"])
            for label, res in tp_ssm[HYBRID_ARCH]["meshes"].items()
            if res["grid"][1] == 1},
        # the hybrid at tp > 1: every run's K7 and K8 shape
        "tp_runs": {
            f"serve_tp_ssm_{label}": (
                res["kernel"]["shape_launches"], res["attn_window"],
                res["decode_lengths"], hyb["max_seq"])
            for label, res in tp_ssm[HYBRID_ARCH]["meshes"].items()
            if res["grid"][1] > 1},
        "k9_tp": {
            f"serve_tp_ssm_{arch}_{label}": res["kernel"]["shapes"][
                "ssd_chunk"]
            for arch, run in tp_ssm.items()
            for label, res in run["meshes"].items()},
        "multimodal": {
            **{phase: (out["paths"]["kernel"]["shape_launches"],
                       out["k8_lengths"]) for phase, out in mm.items()},
            **{f"mm_tp_{phase}_{label}": (
                res["paths"]["kernel"]["shape_launches"],
                out["k8_lengths"])
               for phase, out in mm_tp.items()
               for label, res in out["meshes"].items()}},
        "k9": {"serve_hybrid": hshapes["ssd_chunk"],
               "long_prefill_ssm": long["ssm"]["shapes"]["ssd_chunk"],
               "long_prefill_hybrid": lshapes["ssd_chunk"]}}
    rows = kernel_rows(device, launches, shapes, errs,
                       {"e2e": e2e["launches"],
                        "e2e_hash": e2e_hash["launches"],
                        "e2e_sharded": sharded["cold"]["launches"],
                        "e2e_sharded_warm": sharded["warm"]["launches"],
                        "sharded_stream_aggregate":
                            sstream["aggregate"]["partitioned"]["launches"],
                        "sharded_stream_join":
                            sstream["join"]["partitioned"]["launches"],
                        "serve": serve["kernel"]["launches"],
                        "llm_query": llm["launches"],
                        "serve_ssm": ssm["kernel"]["launches"],
                        "serve_hybrid": hyb["kernel"]["launches"],
                        "long_prefill_ssm": long["ssm"]["launches"],
                        "long_prefill_hybrid": long["hybrid"]["launches"],
                        "llm_query_hybrid": llm_h["launches"],
                        "serve_moe": moe["kernel"]["launches"],
                        "llm_query_moe": llm_m["launches"],
                        **{f"{phase}_{label}": res["kernel"]["launches"]
                           for phase, run in (("serve_tp_dense", tp_dense),
                                              ("serve_tp_seq", tp_seq),
                                              ("serve_tp", tp))
                           for label, res in run["meshes"].items()},
                        **{f"serve_tp_mla_{label}": res["launches"]
                           for label, res in tp_mla["policies"].items()},
                        "llm_query_tp": llm_tp["launches"],
                        "serve_mla": mla["continuous"]["launches"],
                        "llm_query_mla": llm_mla["launches"],
                        **{phase: out["paths"]["kernel"]["launches"]
                           for phase, out in mm.items()},
                        **{f"serve_tp_ssm_{label}": res["kernel"][
                            "launches"]
                           for label, res in tp_ssm[HYBRID_ARCH][
                               "meshes"].items()},
                        **{f"serve_tp_ssm_{arch}_{label}": res["kernel"][
                            "launches"]
                           for arch, run in tp_ssm.items()
                           for label, res in run["meshes"].items()},
                        **{f"mm_tp_{phase}_{label}": res["paths"]["kernel"][
                            "launches"]
                           for phase, out in mm_tp.items()
                           for label, res in out["meshes"].items()},
                        "train_equiv": tequiv["launches"],
                        "train": train["launches"],
                        "train_tp": train_tp["launches"],
                        "train_backend": tback["train_launches"],
                        "train_backend_serve": tback["launches"]},
                       serve["decode_lengths"], llm=llm_shapes,
                       n_shards=sharded["n_shards"])
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
