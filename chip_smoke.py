#!/usr/bin/env python3
"""Drive the port (repro_torch) on one CUDA card and check it: the build
(build_knn_graph), its exact truth (brute_force_knn), the query path
(graph_search), the two-stage int8 / bf16 build and search, the sharded
search and its circuit breaker and the sharded build
(core/distributed.py), the online store
(insert, delete, the router), its snapshots and cold starts
(core/persist.py), the retrieval scheduler in front of the online
store, and the LM serving path (yi-6b prefill, decode, continuous
batching, kNN-LM retrieval and its datastore's restore, and the datastore
grown while the LM decodes; gemma2-27b's local / global stack with its
mixed ring and linear cache; starcoder2-3b and codeqwen1.5-7b; the MoE
family: granite-moe-3b-a800m, and deepseek-v2-lite-16b's MLA latent
cache and weight-absorbed decode, served; the SSM / hybrid family:
mamba2-130m's Mamba-2 stack, and zamba2-1.2b's mamba segments with the
shared attention block, served; the audio and vision front ends:
hubert-xlarge's bidirectional encoder over frames, and internvl2-1b's
patch projector in front of its Qwen2 stack, served), and the training
path (the synthetic token pipeline ordered by the paper's greedy reorder
over a k-NN graph of the documents, loss_fn, AdamW, the guarded step and
loop, checkpoints and the fault policy; yi-6b) with its sharded state
(the logical-axis rules on the production meshes, FSDP steps on a
(data, model) mesh of logical shards, sharded checkpoints resharded
onto an elastic mesh). Run from the root of a checkout, on a machine
with an H100:

    python3 chip_smoke.py

Phases, each printed as one JSON line with ``t_s``, the seconds since the
script started (phases with several lanes print one line a lane):
  device       the card (nvidia-smi name and power limit), torch and CUDA
               versions; the capability must be (9, 0);
  sharding_check  the sharding rules on make_production_mesh(device=
               "meta"), (16, 16) and (2, 16, 16), for all ten configs at
               full size, no storage allocated: parameter leaves per spec,
               the largest shard's parameter and AdamW bytes beside the
               unsharded ones, cache bytes a shard at decode_32k
               (cache_shardings), input_specs and skip_reason per (arch,
               shape);
  dryrun_check  the dry-run (launch/dryrun.py) on the meta (16, 16)
               mesh of yi-6b x train_4k, prefill_32k and decode_32k,
               granite-moe-3b-a800m x decode_32k (MoE) and zamba2-1.2b x
               decode_32k (hybrid): each record's roofline line, memory a
               chip, depth cuts and the count's seconds; fails if the
               card's allocated memory moves;
  build_lib    nvcc builds src/repro_torch/kernels/csrc/*.cu (one nvcc per
               source, all started together): seconds, registers / shared
               memory / spills per kernel (and per template instance),
               ptxas's notes of wgmma it serialised, and the count of
               HGMMA in the SASS of each flash_attention device function
               (cuobjdump -sass): the bf16 kernel must have some, the f32
               kernel (flash_attention<...>) no HGMMA, HMMA or IMMA (fp32
               stays on the CUDA cores); of HMMA in each join's: the bf16
               join must have some (mma.sync), the fp32 join none; of IMMA
               in each int8 join instance: every one must have some (s8
               mma.sync); each fp32 search tile instance
               (knn_search_dists) no HGMMA, HMMA or IMMA; ptxas's spill
               bytes of the f32 attention and int8 join instances, the
               registers and spills of the search tiles (fp32, bf16,
               int8: at most 64 registers and no spill, or the script
               fails) and of the compaction's instances;
  build_check  mnist_like(16000, 784), DescentConfig(k=20, rho=1.0), built
               through the kernels and through their plain versions with
               the same generator seed, at precision f32, int8 and bf16:
               the recalls against an exact fp32 k-NN computed here, which
               nothing in the port uses; the quantized graphs' distances
               must be exact fp32 (check_graph); then three lanes:
               ref_iteration, one sampled iteration from one random init
               and one set of draws through the kernels (join_src wide
               enough that no incidence overflows), through the fused
               path's plain versions and through the lexsort
               backend="ref" path on the card, each fused list held to
               the "ref" list (compare_lists: distances within 1e-4 +
               1e-5 (|a|^2 + |b|^2); ids exact but where the paths order
               entries of equal distance differently, counted),
               evaluations equal, updates equal but for at most one a
               cut tie, no launch but on the kernels' side; ref_build, a
               whole "ref" build
               beside the fused one: its recall at least the fused
               build's - 0.02, its wall time, no launch; selection,
               builds with selection "heap" and "naive" through the
               kernels, each recall within 0.06 of turbo's
               (tests/test_core.py:80-92);
  search_check 2048 queries (the corpus's first rows plus 0.01 N(0, 1))
               against that kernel-built graph, SearchConfig(beam=32,
               rounds=48, expand=6, q_block=512), k_out=10, through the
               kernels, the plain versions and the greedy oracle with the
               same entries, and at int8 and bf16 through the kernels and
               the plain versions; recall against brute_force_knn; the
               quantized searches must return fp32 distances;
  build        path 1: mnist_like(70000, 784), DescentConfig(k=20),
               through the kernels; wall time, iterations, updates,
               dist_evals, the reorder's host time, peak memory, recall@20;
  build_int8, build_bf16
               paths 4-5: the same build at precision int8 and bf16 (the
               sampled joins through knn_join_dists_q8 / _bf16, the fp32
               re-rank through knn_search_dists once, no fp32 join);
  truth        path 2: brute_force_knn(x, x, 20) on that corpus through
               the pairwise kernel, held against the exact k-NN computed
               here (recall >= 0.999); the build's recall against both;
  search       path 3: 10000 queries (MNIST's test-split size) against the
               70000-point graph, same SearchConfig, k_out=10, through the
               kernels; wall time, queries per second, rounds, peak memory,
               recall@10 against brute_force_knn;
  search_int8, search_bf16
               paths 6-7: the same search at precision int8 and bf16 on
               the f32 graph (every round through knn_search_dists_q8 /
               _bf16, the fp32 re-rank through knn_search_dists once per
               block);
  sharded      path 13: graph_search_sharded over
               ShardMesh(["cuda:0"] * 4), four logical shards of 17500
               rows of path 1's corpus, each with its own
               build_knn_graph(k=20) subgraph; path 3's queries and
               SearchConfig (torch.cuda.device_count() printed beside).
               Main path: the replicated dispatch, the routed one
               (build_router over the global corpus, route_p 2, default
               route_cap) and exact_knn_sharded(x, 20), each timed. Lanes:
               p1, one shard over path 1's graph returns path 3's ids and
               distance bits (shard 0 draws from the batch key); replicated,
               the stable merge of four direct searches with the same
               entries, bitwise, at f32 and int8, recall and queries/s
               beside path 3's, one profile's idle share; routed, fan-out
               2, 0 dropped, searched == routed, recall and the overlap
               with replicated, then the JAX chaos bench's shape (1024 x
               16, shard 1 dead, route_cap 256: degraded recall >= 0.80
               against the survivors' truth, 0 dropped); dead, shard 1
               dead under a FaultPlan, replicated (cover_frac 0.75, the
               survivors' merge bitwise) and routed, no id of shard 1;
               breaker, ShardBreaker(4, min_samples 3, probe_every 50)
               under shard.degrade (2, 40.0) trips shard 2 within 4
               dispatches of 512 queries, and the next dispatch leaves it
               out; exact, ids equal to path 2's brute force but at ties
               (counted), distances within 1e-4 + 1e-5 (|a|^2 + |b|^2);
               fetch, fetch_rows_a2a on seeded ids with a cap some buckets
               overflow: rows bit-equal to x[ids] where ok, ok exactly the
               in-bucket non-negative ids;
  sharded_build
               path 14: build_knn_graph_sharded over
               ShardMesh(["cuda:0"] * 4) on path 1's corpus (four shards
               of 17500 rows), DescentConfig(k=20, reorder=False), one
               int key (torch.cuda.device_count() printed beside). Lane
               main: the build through the select kernel (the receiver
               select at 17500 x 480, c 60, and the polish select at
               17500 x 400, c 120): wall time beside path 1's,
               iterations, dist_evals, polish updates, peak memory, the
               graph's distances (check_graph), recall@20 against path
               2's truth beside path 1's, one profile's idle share; plain:
               the same build and key through the select's plain version
               (backend "plain", no launch), its lists and stats bit-equal
               to main's; fetch: the polish's fetch without padded
               buckets (_plan_fetch, _fetch_chunk in chunks of 100000
               ids) against fetch_rows_a2a on 1M seeded ids with a cap
               some buckets overflow, bitwise;
               step: make_sharded_iteration at main's shapes (rho 0.5),
               one iteration from main's init lists: its seconds and
               model_flops / seconds;
  online_check mnist_like(16000, 784): a store built on 14400 rows with
               OnlineConfig(router=RouterConfig()), 1600 rows inserted and
               1600 seeded rows deleted in batches of 400, through the
               kernels and through the plain versions (backend "plain")
               with the same draws: recall@20 of the live
               lists against an exact k-NN of the live rows, within 0.01;
               then the JAX router test's shape (64 clusters x 784 rows at
               d 16, per-cluster exact graphs) through the kernels: routed
               seeds reach recall@10 >= 0.85, random entries < 0.75;
  persist      lane quantized_first: on online_check's corpus, a routed
               int8 store of 14400 rows is snapshotted; the quantized-first
               restore answers 2048 queries at once (full rows of live
               ids), and after fp32_loader.apply it is the store, bit for
               bit, and answers bit-equal to it; a second snapshot torn by
               a FaultPlan (persist.torn on nl_idx.npy) makes
               restore_store() fall back to the first (fallback_from
               [2]) and quarantine the torn directory by rename;
  attention_check
               ops.attention through the kernel against its plain version
               (backend "ref") on the card, f32 (the SIMT kernel) and bf16
               (the wgmma kernel), in every mode (causal, window 64,
               softcap 20, non-causal, encoder with a window, GQA 8/2 and
               32/4, q_offset, one decode row, ragged Lq / Lk, Dv != Dq,
               rows that see no key, Dh 256 and 80, Dq 48 / Dv 32, a kv
               ring of 4096 keys): max error within 2e-3 at f32 and rtol
               1e-2 / atol 2e-3 at bf16 on rows that see a key, exactly 0
               on rows that see none;
  online       path 8: MutableKNNStore.build on rows [0, 60000) (k 20,
               rho 1.0, 15 iterations, routed), knn_insert of rows [60000,
               70000) in 20 batches of 500 (capacity 65536 -> 131072),
               knn_delete of 7000 seeded rows in 7 batches of 1000, and
               store.search of 10000 noisy queries, routed and with
               router "off": wall times, dist_evals, frontier and padded
               rows, peak memory, recall@20 of the live lists against an
               exact k-NN and against a from-scratch build of the 63000
               live rows, search recall@10 against brute_force_knn;
  persist      lane online_store: that path's final store (capacity
               131072, 70000 rows allocated, 63000 live, routed, f32; x
               alone 470 MB) is snapshotted (snapshot_store) under a
               temporary directory in build/, removed after; restored
               with restore_store(device="cuda") in this process and in a
               fresh Python process (this script with --restore-child,
               which imports no JAX and loads the library already built
               in build/), each bit for bit and answering the 10000
               queries with the live store's ids and bit-equal
               distances; one knn_insert of 500 rows with the same draws
               into the live and the restored store gives the same lists;
               a SnapshotWriter.save with an insert on this thread during
               the write restores as the store before the insert; bytes
               written, write and restore seconds (the host disk's) and
               their ratio to the online build's seconds;
  retrieval    path 11: serve/scheduler.RetrievalScheduler in front of
               that store's search (SearchConfig(beam=32, rounds=48,
               expand=6, q_block=512), k_out 10, the search path's 10000
               queries). Lane mixed: 8000 batch-lane queries queued, the
               other 2000 arriving as interactive bursts of 1-16 (seeded),
               each pumped alone before a batch dispatch of 512; every
               dispatch lane-pure, every search tile observed at the
               dispatch's q_block_bucket, all 10000 served, recall@10
               against brute force of the live rows within 0.01 of the
               direct store.search, no tombstoned id; per-lane p50 / p99
               latency and the batch lane's QPS beside the direct
               search's. Lane deadline: 2048 queries with deadline_ms half
               an uncut 2048-query dispatch's time (the clock stopped
               while they are submitted): answered in full with live ids,
               max_rounds_deadline > 0 in the search, time and recall
               beside the uncut dispatch's. Lane overload, twice:
               max_queue 256, drop-oldest-batch, 3000 arrivals on a
               virtual clock under a seeded FaultPlan (sched.burst prob
               0.1 x 8, sched.stall prob 0.05 x 0.25 s): equal shed and
               expired counts and rejected qids, submitted + injected =
               served + shed + expired. Lane cache (result_cache 4096):
               the 2000 interactive queries again are 2000 bit-equal
               hits; after a knn_insert of 500 rows and invalidate_cache,
               none. Then one profiled pass of 2048 batch-lane queries;
  lm_check     yi-6b at full width (32 layers, d 4096, 32/4 heads, d_ff
               11008, vocab 64000), weights drawn from the seed, matrices
               in bf16: a ragged 1537-token prompt's prefill logits and 4
               teacher-forced decode steps through the kernel and through
               the plain chunked attention, within 2e-2 of the logit scale
               of each other (tests/test_serve.py:53's bf16 limit), and the
               decode steps within 3e-2 of a forward over the longer
               prompt (its logits at the last 4 positions); every
               attention cache's kpos tags as ring_kpos says;
               flash_attention launched once per attention layer
               (``transformer.attention_layers``);
  lm_serve     path 9: repro_torch.launch.serve.serve_requests on that
               model: 4 slots, max_len 4096, 8 requests with prompt lengths
               drawn from the seed in [1000, 2048], 32 new tokens each:
               wall time, prefill seconds and time to first token per
               request, decode tokens per second, peak memory;
               flash_attention launched exactly 32 x 8 times (decode never
               launches it);
  knn_lm       path 10: examples/knn_serve.py steps 2-4 at full width: the
               hidden states (run_stack) of 16 seeded 2048-token sequences
               as keys (32752 x 4096), KNNDatastore.build(k=16),
               knn_logits of the 2048 hidden-state queries of a 17th
               sequence with seeded shared entries, interpolate: build and
               search seconds, recall@8 against brute_force_knn through
               the kernels and through the plain versions on the same
               graph and entries (within 0.01), mean log-likelihood at
               lambda 0 and 0.25; then step 5: ds.snapshot and
               KNNDatastore.restore(device="cuda") (no rebuild), the same
               queries and entries giving bit-equal knn_logits: snapshot
               bytes, write and restore seconds beside the build's;
  knn_grow     path 12: MutableKNNDatastore.build over knn_lm's 32752 keys
               (k 16, capacity 32768), grown by a ContinuousBatcher of
               lm_serve's slots and prompts (32 new tokens) that captures
               each step's last hidden state (serve/decode.decode_hidden,
               the keys' space) and the sampled token, knn_chunk 64,
               knn_router True (capacity 65536 after the first chunk),
               knn_snapshot_every 128 under build/ (removed after): n is
               32752 + 248, the values are the sampled tokens in capture
               order, the periodic snapshot restores as the datastore at
               its own step, the drain snapshot is at the final n, a
               second batcher with no store cold-starts bit-equal, the
               chunks replayed through the plain versions with the same
               draws give inserted rows whose recall@16 (against the exact
               k-NN of the live rows) is within 0.01 of the kernels', and
               knn_logits of knn_lm's 2048 queries with the same entries
               and draws are bit-equal on the drained and restored
               datastores: decode tokens/s beside lm_serve's, seconds per
               insert chunk, snapshot bytes, write and restore seconds
               (the host disk's), peak memory;
  dense_check  starcoder2-3b (LayerNorm, biased MLP, q/k/v and output
               biases, a 4096 window on every layer) and codeqwen1.5-7b
               (q/k/v biases, MHA 32/32) at full width, each cut to 2
               layers (``reduced``) and loaded after the model before it
               is freed: lm_check's two checks on a 4500-token prompt
               (past starcoder2's window), and every layer's kpos tags
               (ring_kpos);
  gemma2_check gemma2-27b at full width (d 4608, 32/16 heads, Dh 128,
               d_ff 36864, vocab 256000, window 4096, softcaps 50 / 30,
               tied embeddings), its depth cut from 46 to 8 layers (4
               local / global pairs; the full model's fp32 draw, 108.9
               GB, does not fit the card), weights from the seed,
               matrices in bf16: lm_check on a ragged 5001-token prompt
               (max_len 8192), the forward's logits taken at the last 4
               positions only; the kpos tags of every local ring (the
               last 4096 positions at pos % 4096) and global cache
               (0..L-1, then -1);
  lm_gemma2    path 15: serve_requests on that model: 4 slots, max_len
               8192, 8 requests with prompt lengths drawn from the seed
               in [4500, 6000] (every local ring wraps at prefill), 32
               new tokens each: the lm_serve figures;
               flash_attention launched exactly 8 x 8 times, 32 a layer
               kind (local, with the window; global);
  moe_check    granite-moe-3b-a800m (GQA 24/8 at Dh 64, scale 1/128, 40
               experts top-8 with renormalised gates, the granite
               multipliers, tied embeddings) at full width cut to 2
               layers, then deepseek-v2-lite-16b (MLA: 16 heads, Dq 192,
               Dv 128, a 512 + 64 latent cache; one dense layer of 10944,
               then 64 routed experts top-6 with 2 shared) at full width
               cut from 27 to 8 layers (``reduced``; 27 layers' fp32 draw
               would not fit the card beside its bf16 copy), each loaded
               after the model before it is freed: lm_check's two checks
               on a 1537-token prompt, every layer's kpos tags
               (ring_kpos), and repeat_check: the same prefill and decode
               step twice, bit-equal logits and cache leaves, and for
               deepseek the cache's bytes per token, 8 x (512 + 64) x 2;
  lm_deepseek  path 16: serve_requests on that deepseek model: lm_serve's
               slots, max_len, requests, prompt lengths and new tokens;
               the lm_serve figures; flash_attention launched exactly 8 x
               8 times; beside them the expert bytes a decode step reads
               (the dense-form MoE runs every expert: C = T = 4 <= 128)
               and the step's bound (every weight and the latent cache
               read once over 3.35 TB/s);
  ssm_check    mamba2-130m (24 Mamba-2 layers, d 768, 24 SSD heads of 64,
               state 128, chunk 256, vocab 50280, tied embeddings), then
               zamba2-1.2b (38 Mamba-2 layers, d 2048, 64 SSD heads of 64,
               state 64; one shared attention + GLU block, MHA 32/32 at Dh
               64, d_ff 8192, after every 6 mamba layers with a rank-128
               LoRA delta per invocation; vocab 32000), both at full width
               and full depth (``reduced``: none), weights from the seed,
               matrices in bf16, each loaded after the model before it is
               freed: lm_check on a 1537-token prompt (not a multiple of
               the 256-token chunk: the scan pads), flash_attention
               launched once per attention layer (0 in mamba2, 6 in
               zamba2: one per shared-block invocation), the kpos tags of
               zamba2's shared caches, every state finite after the 4
               steps and every conv tail bit-equal to the pre-conv inputs
               of the last 3 steps; repeat_check; mamba2's cache the
               same bytes a slot at 1537 and 4096 tokens (O(1) in the
               sequence); then mamba2 served at lm_serve's shape (lane
               serve: the lm_serve figures, no launch, the step's bound:
               every weight and the slots' whole cache read once over
               3.35 TB/s);
  lm_zamba2    path 17: serve_requests on that zamba2 model at lm_serve's
               shape: the lm_serve figures and the step's bound (every
               weight, the slots' f32 states and conv tails and the
               shared block's KV caches at max_len read once);
               flash_attention launched exactly 6 x 8 times; a profile of
               a served window (the first 2 requests, 4 new tokens each)
               with the SSD scan under a profiler range (its device
               time), and one of 4 decode steps alone over 4 prefilled
               slots (launches a step);
  frontend_check
               hubert-xlarge (48 layers, d 1280, MHA 16/16 at Dh 80, no
               rope, LayerNorm, GELU MLP, biases everywhere, vocab 504,
               encoder-only; frames of 512 through one biased dense) and
               internvl2-1b (the Qwen2-0.5B stack: 24 layers, d 896, GQA
               14/2 at Dh 64, QKV biases, rope 1e6, tied vocab 151655;
               256 patches of 1024 through fc1, tanh-GELU, fc2, ahead of
               the tokens) at full width, each cut to 2 layers and loaded
               after the model before it is freed, frames and patches
               seeded on the card: hubert's forward over a 1237-frame
               clip through the kernel and the plain attention within
               2e-2 of the logit scale, a launch a layer, repeated
               bit-equal, and bidirectional (the last frame redrawn
               changes the first position's logits; the same weights as a
               causal stack keep them bit for bit); internvl2's lm_check
               on 256 patches + 1537 tokens (its decode steps against the
               forward offset by the patches, kpos over the 1797
               positions) and repeat_check with the patches;
  audio_encode path 18: hubert-xlarge at full width and depth (reduced:
               none), bf16: 8 clips of 500-1500 frames drawn from the
               seed (10-30 s of 16 kHz speech at a 20 ms stride), each its
               own forward at B = 1, then one batch of 4 clips of 1000:
               seconds a clip beside its bound (operations: 2 a product
               weight and frame, 2 (Dq + Dv) a pair and head over 989
               TFLOP/s; or bytes), frames/s, peak memory; flash_attention
               launched exactly 48 x 9 times; one clip's forward profiled
               (launches a forward, idle share);
  lm_vlm       path 19: internvl2-1b at full width and depth (reduced:
               none), bf16: a ContinuousBatcher of 4 slots (max_len 2048)
               whose prefill_fn (this script's own) prefills each of 8
               requests' 64-1024 text tokens behind its own 256 seeded
               patches and returns the length counting them, 32 new
               tokens each: the lm_serve figures, the prefill lengths
               (patches + tokens), the step's bound; flash_attention
               launched exactly 24 x 8 times; then 4 text-only requests
               through serve_requests (lane text_only); a window of 2
               requests with 4 new tokens profiled, and 4 decode steps
               alone over 4 prefilled slots (launches a step);
  train_check  yi-6b at full width cut to 1 layer (about 0.70 G fp32
               parameters), weights from seed 0 as the train CLI draws
               them. Lane grads: one step's loss and gradients on the
               card against the same step on the CPU (1 x 256 tokens, f32
               activations, TF32 off), each leaf's error over its scale
               within 1e-4. Lane semantic_order: over the first 16384
               documents of path 20's corpus, through the kernels and
               through their plain versions on the same draws: the
               permutations (where they differ, the graphs must agree in
               0.99 of their slots), and one sampled iteration from the
               same init and draws, its lists held as compare_lists holds
               them. Lane checkpoint: TrainLoop with an async
               Checkpointer (every 2) over batches of 2 x 512; the
               step-2 checkpoint (about 8.4 GB, under build/, removed
               after) loads bit-equal to the state kept on the card; two
               steps from it give the first run's losses within 1e-4
               (bitwise or not, printed); a corrupted batch (its
               embeddings NaN) is skipped with params and state
               bit-equal; three in a row through FaultPolicy roll back to
               the step-2 checkpoint bit-equal; bytes, host copy, commit
               and load seconds. Lane attention_under_grad: the f32 and
               bf16 attention kernels raise under autograd (naming the
               plain path) and launch nothing, and launch under no_grad.
               Lane sharded_ckpt: the state placed on a (data 2, model 2)
               mesh of logical shards, one FSDP step (2 x 512), saved as
               sharded leaves (bytes, save s); a shard lost:
               elastic_mesh(["cuda:0"] * 3, model_axis=2) is (3, 1), where
               d_model 4096 falls back to replicas; loaded with
               shardings= onto it (load s), every gathered leaf bit-equal
               to the saved state's; one step there on a replicated batch
               against the unsharded step, held as path 21 holds its;
  train        path 20: 65536 documents of the synthetic source (vocab
               64000), each embedded by mean_pool_embeddings (d_proj 64)
               from its first 64 tokens (a shorter document repeated from
               its start), drawn by 8 worker processes; semantic_order
               (k 10) on the card through the build's kernels: build
               seconds, iterations, dist_evals, in-block fraction before
               and after; a TokenPipeline in that order at seq 4096 x
               batch 4 (loss_chunk 2048: two CE chunks) feeding 6 AdamW
               steps of 2 microbatches through TrainLoop on yi-6b at full
               width cut from 32 to 8 layers, fp32 parameters, bf16
               activations, the plain attention: the losses (finite, the
               last below the first, none skipped), seconds a step,
               tokens/s, model FLOPs (6 x tokens x the multiplying
               weights) over 989 TFLOP/s and the attention's fp32 FLOPs
               over 67 beside the step, peak memory; flash_attention
               never launched; one more step profiled (device only:
               launches a step, idle share);
  train_sharded  path 21: yi-6b at full width cut from 32 to 4 layers,
               fp32 parameters placed by sharding_tree on a (data 2,
               model 2) mesh of four logical shards on cuda:0, AdamW's
               moments placed like them; 3 FSDP steps of 2 x 4096 tokens
               (batches placed by batch_specs: a data group a row), each
               beside the unsharded step with 2 microbatches from the same
               parameters on the same batch: the loss within 1e-6
               relative, the grad norm 1e-5, every parameter and moment
               within 1e-6 of its leaf's largest magnitude; seconds a step
               and tokens/s both ways, the largest shard's parameter and
               moment bytes over the unsharded state's, peak memory; no
               kernel launched; one more FSDP step profiled (launches a
               step, idle share);
  roofline_check  one untimed call after a phase's timed runs, counted
               on the card by the op-level cost counter (launch/op_cost.py;
               one line a call): lm_serve's prefill of its first prompt
               through the bf16 attention kernel and one decode step on its
               cache (after lm_serve), path 20's train step (after its
               profile), path 13's exact_knn_sharded (the ring tiles and
               the merge kernel) and path 14's sharded iteration (the
               select kernel). Each call's kernels must be among its
               launches; its Roofline (launch/roofline.py) stands beside
               the phase's measured seconds (the count is the eager
               implementation's traffic; path 20's seconds stand beside
               train_flops' work bound too). The LM calls are counted
               again on meta twins of their inputs (the dry-run's count of
               the same cut) and the two counts must be equal, FLOPs by
               dtype and bytes; the train step's counted FLOPs stand
               beside train_flops' hand count, and the dry-run's peak
               estimate beside the allocator's. The sharded calls cannot
               run on meta: their counts stand beside their model FLOPs;
  large_k_check  on online_check's corpus (16000 x 784): lane kernels,
               the joins above C 64 (knn_join_dists_kernel_wide: the
               row's valid slots compacted, new x valid cross terms, a
               block a row, in panels at C 320; the int8 / bf16 wide
               kernels: sets of slots, a warp a (set, set) piece) at C
               92, 180, 256 and 320, fp32,
               int8 and bf16, and the selects above a padded W of 8192
               (knn_join_select_kernel_resident, the row's keys in shared
               memory, at W 16928 / c 273; knn_join_select_kernel_stream
               at 64800 / c 540 and 131072 / c 2048) on rows of ties, of
               -0.0 / +0.0 and of a straddled run, each against its plain
               version (evals exact, int8 and the selects bitwise, fp32
               and bf16 within 1e-4 + 1e-5 (|a|^2 + |b|^2)), one launch a
               call; lane merges, knn_merge and knn_merge_rows above a
               pool of 8192 (knn_merge_kernel_wide and its row form) at
               k 91 with c 8281 (the online store's pool, in shared
               memory) and c 12000 (past it: the scratch instance) on 512
               rows of ties, repeated candidate ids, candidate ids in the
               list, ids -1, -0.0 / +0.0 and the FLT_MAX sentinel,
               bitwise, one launch a call; lane builds,
               build_knn_graph(k=91) through the kernels and through the
               plain versions with the same
               generator seed (recalls against an exact k-NN within 0.01,
               both >= 0.84), the int8 and bf16 builds at k 91 (driven;
               recall >= the f32 build's - 0.02, distances exact fp32) and
               MutableKNNStore.build(k=48) (rho 1.0: C 96); lane online,
               knn_insert / knn_delete at k 91 on online_check's shape
               (path 22's descent, frontier chunk 512) through the kernels
               and through the plain versions on the same draws (the row
               merge at c 8281 launched; recall@91 of the live lists
               against an exact k-NN of the live rows within 0.01, both
               >= 0.84; the live lists checked), then a
               MutableKNNDatastore at k 91 on 4096 keys, two appends of
               256, one delete of 256, through the kernels (recall@91 >=
               0.84, the row merge at c 8281 launched);
  knn_build_k91  path 22: t-SNE's neighbour graph (scikit-learn's TSNE
               asks for 3 perplexity + 1 = 91 neighbours at perplexity
               30): build_knn_graph(k=91) at rho 0.5 on path 1's corpus
               (C 92, merge_k 273, receiver select W 16928, polish select
               W 8281 at c 546; the polish's gather in chunks of at most
               4 GB), through the kernels; wall time, iterations,
               dist_evals, launches, peak memory, recall@91 against an
               exact k-NN (>= 0.84), the graph's distances (check_graph),
               then one more build profiled: the idle share and the wide
               join's and resident select's device time (each > 0);
  online_k91   path 23: the online store at t-SNE's k on path 8's shape
               (path 1's corpus): MutableKNNStore.build on rows [0, 60000)
               at k 91, routed, at path 22's descent (rho 0.5, C 92: the
               phase's time goes to the updates), knn_insert of rows
               [60000, 70000) in 20 batches of 500 and knn_delete of 7000
               seeded rows in 7 batches of 1000, through the kernels; wall
               times of build, inserts and deletes, dist_evals against the
               build's, frontier and padded rows, peak memory, the live
               lists checked, recall@91 against an exact k-NN of the live
               rows (>= 0.84), launches (knn_merge_rows at c 8281
               required), and one more insert batch profiled (idle share);
  profile      every path but truth once more under torch.profiler (and
               a window of lm_serve, lm_gemma2 and lm_deepseek: the first
               4 requests, 8 new tokens each; and lm_gemma2's and
               lm_deepseek's decode steps alone, 16 over 4 prefilled
               slots; lm_zamba2's, audio_encode's and lm_vlm's as those
               phases say): device time by kernel name and the device's
               idle share;
  kernels      each kernel on the inputs a path gave it (recorded during
               that run), against its plain version: max error, kernel /
               plain / library times, the card's lower bound (and, for the
               online store's row forms, the time of their (n, k) copy);
               knn_join_select at every (W, c) the build, search and online
               paths recorded, each with torch.sort(stable=True) of the
               same masked keys as its library row (the merges: of the
               masked pool, plus gather); knn_merge_rows at every c the
               online path recorded; pairwise_sq_l2 also on the online
               path's centroid_assign tile, on the router's graph tile and
               on the sharded path's ring tile (two 17500-row blocks) and
               routed query-centroid tile; knn_join_select also at the
               sharded build's two widths; knn_join_dists also on the
               kNN-LM's and the online store's builds; knn_merge also on
               the search's pool; the fp32,
               bf16 and int8 search tiles also at round 6 of the first
               block (LATE_ROUND; round 2 is the second call), where the
               queries share fewer rows, each search tile with its valid
               candidates, distinct rows, distinct rows summed over groups
               of 16 consecutive queries (what a tile that read a row once
               per group would read), and its effective rate (valid rows x
               row bytes / time); the bf16
               tiles' library row torch.baddbmm(out_dtype=float32), beside
               it the same with a bf16 output; flash_attention at
               bf16 on the inputs the lm_serve prefill gave it, on the
               inputs of lm_gemma2's second local and second global
               prefill layers (window 4096, softcap 50, H 32/16, scale
               144^-0.5; their library row compiled flex_attention, the
               cap as its score_mod, the window as a block mask), on the
               inputs of lm_deepseek's second MLA prefill layer (H 16/16,
               Dq 192, Dv 128, scale 192^-0.5), of moe_check's granite
               second prefill layer (H 24/8, Dh 64, scale 1/128) and of
               lm_zamba2's second shared-block invocation (H 32/32, Dh 64,
               scale 1/8), of audio_encode's second layer of its first
               (longest) clip (H 16/16, Dh 80, non-causal, scale 80^-0.5)
               and of lm_vlm's second layer of its first request (H 14/2,
               Dh 64, causal over 256 patches + text), all five with
               scaled_dot_product_attention as
               their library row and the backend PyTorch's dispatcher picks for it named
               (torch._fused_sdp_choice), and at f32
               on attention_check's causal_gqa_32_4 inputs, with
               scaled_dot_product_attention as its library row.
Every path is driven with all launch counts set to 0 just before it and
read just after; each kernel of the path must have launched. Each model
is freed before the next is loaded and before the kernels phase. Then the line
{"kernels": [...]}: one entry per kernel, plus knn_join_select once per
further (W, c) that build, search or online recorded (``launches``: what
that width's calls added to the kernel's count in its path; these add up
to the path's count, or the script fails), knn_merge_rows once per
further c of the online path (every row-merge entry's ``launches`` is its
own c's; they add up to the path's count, or the script fails),
knn_join_dists once more on the kNN-LM's build and once on the online
store's, knn_merge once more on the search path, pairwise_sq_l2 once more
on the online path's centroid_assign tile and once on the router's graph
tile (``launches``: the calls at that key; FURTHER_ROWS), then once on
the sharded path's ring tile and once on its routed tile (``launches``:
that tile's calls in the path's main run), knn_join_select once at each
of the sharded build's two widths (``launches``: that width's calls in
the build's main run; they add up to the path's count), the fp32,
bf16 and int8 search tiles once more at round 6 (``launches``: 0, a second
reading of the launches the round-2 entry counts; ``call`` ends in
``:round=6``) and
flash_attention once more at f32 (``launches``: its calls in
attention_check; no main path runs attention at f32) and twice for
lm_gemma2 (``call`` ``lm_gemma2:flash_attention:local`` and ``:global``,
``launches``: that layer kind's calls in path 15), once for lm_deepseek
(``call`` ``lm_deepseek:flash_attention:mla``, ``launches``: its calls in
path 16), once for granite (``call`` ``moe_check:flash_attention``,
``launches``: its calls in moe_check's granite lm_check) and once for
zamba2 (``call`` ``lm_zamba2:flash_attention``, ``launches``: its calls
in path 17), once for hubert (``call`` ``audio_encode:flash_attention``,
``launches``: its calls in path 18) and once for internvl2 (``call``
``lm_vlm:flash_attention``, ``launches``: its calls in path 19 with
patches), and knn_join_dists, knn_join_select (each width) and knn_merge
once more each on path 20's semantic_order build (``launches``: that
key's calls in path 20), and, after each kernel's own entries, path 22's
calls (knn_join_dists at C 92, knn_join_select at W 16928 / c 273 and W
8281 / c 546, knn_merge), the k = 91 int8 and bf16 builds' joins (C
92; ``launches``: that key's calls in its run), knn_merge on
large_k_check's dense merge at k 91, c 8281 (``launches``: 0, no main
path merges a dense pool above 8192) and knn_merge_rows on path 23's
row merge at c 8281 (``launches``: that key's calls in path 23);
``call`` tells the entries apart. Last, {"ok": true, "device": ...}. Any failure
raises, and the script exits non-zero. With no CUDA card, or without the
repository's src/ beside it, it exits 2 and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

# the H100 SXM peaks (NVIDIA data sheet), PEAK_BYTES_PER_S,
# PEAK_FP32_PER_S, PEAK_BF16_PER_S and PEAK_INT8_PER_S: main() takes them
# from the port's roofline (launch/roofline.py), their one copy
REPLACES = {
    "knn_join_dists": "src/repro/kernels/knn_join.py:82",
    "knn_join_select": "src/repro/kernels/knn_join.py:152",
    "knn_merge": "src/repro/kernels/knn_merge.py:156",
    "pairwise_sq_l2": "src/repro/kernels/l2_blocked.py:63",
    "knn_search_dists": "src/repro/kernels/knn_search.py:66",
    "knn_search_dists_q8": "src/repro/kernels/l2_quant.py:92",
    "knn_search_dists_bf16": "src/repro/kernels/l2_quant.py:137",
    "knn_join_dists_q8": "src/repro/kernels/l2_quant.py:241",
    "knn_join_dists_bf16": "src/repro/kernels/l2_quant.py:279",
    "knn_compact": "src/repro/kernels/knn_merge.py:108",
    "knn_merge_rows": "src/repro/kernels/knn_merge.py:210",
    "knn_compact_rows": "src/repro/kernels/knn_merge.py:237",
    "flash_attention": "src/repro/kernels/flash_attention.py:86",
}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "knn_join_dists": CSRC + "knn_kernels.cu",
    "knn_join_select": CSRC + "knn_kernels.cu",
    "knn_merge": CSRC + "knn_kernels.cu",
    "pairwise_sq_l2": CSRC + "search_kernels.cu",
    "knn_search_dists": CSRC + "search_kernels.cu",
    "knn_search_dists_q8": CSRC + "quant_kernels.cu",
    "knn_search_dists_bf16": CSRC + "quant_kernels.cu",
    "knn_join_dists_q8": CSRC + "quant_kernels.cu",
    "knn_join_dists_bf16": CSRC + "quant_kernels.cu",
    "knn_compact": CSRC + "knn_kernels.cu",
    "knn_merge_rows": CSRC + "knn_kernels.cu",
    "knn_compact_rows": CSRC + "knn_kernels.cu",
    "flash_attention": CSRC + "attention_sm90.cu",       # bf16
}
F32_ATTENTION_SOURCE = CSRC + "attention_kernels.cu"
# the path that owns each kernel of the quantized paths and of the online
# path; those paths check only their own kernels (the others were checked
# on the f32 paths)
QUANT_OWNER = {
    "knn_join_dists_q8": "build_int8", "knn_join_dists_bf16": "build_bf16",
    "knn_search_dists_q8": "search_int8",
    "knn_search_dists_bf16": "search_bf16",
}
ONLINE_KERNELS = ("knn_compact", "knn_merge_rows", "knn_compact_rows")
SELECT_PATHS = ("build", "search", "online")   # their selects join the line
OWNED = {path: name for name, path in QUANT_OWNER.items()}
# the select runs on every graph path, at its own widths: each is checked;
# the online path's centroid_assign tiles are checked too, at the router's
# width, and its fp32 join (the store's build, C 40); the kNN-LM path
# checks its fp32 join alone (C 32 at d 4096)
CHECKED = {**{path: {name, "knn_join_select"} for path, name in OWNED.items()},
           "online": {*ONLINE_KERNELS, "knn_join_select", "pairwise_sq_l2",
                      "knn_join_dists"},
           "lm_serve": {"flash_attention"}, "knn_lm": {"knn_join_dists"},
           "lm_gemma2": {"flash_attention"},
           "moe_check": {"flash_attention"},
           "lm_deepseek": {"flash_attention"},
           "lm_zamba2": {"flash_attention"},
           "audio_encode": {"flash_attention"},
           "lm_vlm": {"flash_attention"},
           "train": {"knn_join_dists", "knn_join_select", "knn_merge"}}
CENTROID_KEY = "online:pairwise_sq_l2:centroid_assign"
# recorded calls that join the kernels line after their kernel's own entry,
# each with its own launches: the fp32 join of the kNN-LM's build (row 1a)
# and of the online store's (1b), the search's pool merge (3a), and the
# online path's two pairwise tiles, centroid_assign's (4a) and the
# router's graph (4b)
FURTHER_ROWS = {
    "knn_join_dists": ("knn_lm:knn_join_dists", "online:knn_join_dists"),
    "knn_merge": ("search:knn_merge",),
    "pairwise_sq_l2": (CENTROID_KEY, "online:pairwise_sq_l2"),
}
PRECISIONS = ("int8", "bf16")
N, CHECK_N, SEED = 70_000, 16_000, 0   # the main path's and the check's n
N_QUERIES, CHECK_QUERIES = 10_000, 2048
N_BASE, INSERT_BATCH, N_DELETE, DELETE_BATCH = 60_000, 500, 7000, 1000
CHECK_BASE, CHECK_BATCH = 14_400, 400     # online_check: 1600 in, 1600 out
TRUTH_CHUNK = 4096      # brute force: a 4096 x 70000 f32 tile is 1.15 GB
LM_ARCH = "yi-6b"
LM_CHECK_LEN, LM_CHECK_STEPS = 1537, 4     # lm_check: ragged prompt
LM_LIMIT, LM_DECODE_LIMIT = 2e-2, 3e-2      # tests/test_serve.py:53, :84
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_MAX_NEW = 4, 4096, 8, 32
LM_PROMPT_LENS = (1000, 2048)               # drawn from the seed, inclusive
LM_PROFILE_NEW = 8                          # the profiled window: one wave
# path 15 and its lanes: gemma2-27b at full width, its depth cut to 4
# (local, global) pairs (the full 46 layers' fp32 draw, 108.9 GB, does not
# fit the card); prompts past the 4096 window, so every local ring wraps
# at prefill; the other dense configs at full width, cut to 2 layers
GEMMA_ARCH, GEMMA_LAYERS, GEMMA_MAX_LEN = "gemma2-27b", 8, 8192
GEMMA_CHECK_LEN, GEMMA_PROMPT_LENS = 5001, (4500, 6000)
GEMMA_DECODE_PROFILE = 16                   # decode steps, profiled alone
DENSE_ARCHS, DENSE_LAYERS, DENSE_CHECK_LEN = (
    ("starcoder2-3b", "codeqwen1.5-7b"), 2, 4500)
# paths whose attention calls are recorded by layer kind (":local" with a
# window, ":global" without)
LAYER_KIND_TAGS = ("lm_gemma2",)
GEMMA_KEYS = ("lm_gemma2:flash_attention:local",
              "lm_gemma2:flash_attention:global")
# moe_check and path 16: granite-moe-3b-a800m at full width cut to 2
# layers (as dense_check), deepseek-v2-lite-16b at full width cut from 27
# to 8 layers (1 dense + 7 MoE: load_params draws fp32, then casts, so 27
# layers would need about 63 GB fp32 + 31 GB bf16 on the 80 GB card; 8
# need about 18 + 9); path 16 serves LM_REQUESTS prompts of
# LM_PROMPT_LENS as lm_serve does; the decode-only profile as lm_gemma2's
MOE_GRANITE, MOE_GRANITE_LAYERS = "granite-moe-3b-a800m", DENSE_LAYERS
DEEPSEEK_ARCH, DEEPSEEK_LAYERS = "deepseek-v2-lite-16b", 8
# the recorder's suffix for a path's attention calls where one layer kind
# runs them all (deepseek's MLA prefill)
ATTN_KIND_SUFFIX = {"lm_deepseek": ":mla"}
MOE_KEYS = ("lm_deepseek:flash_attention:mla", "moe_check:flash_attention")
# ssm_check and path 17: mamba2-130m and zamba2-1.2b at full width and
# full depth (reduced: none; zamba2's fp32 draw is about 4.8 GB); path 17
# serves LM_REQUESTS prompts of LM_PROMPT_LENS as lm_serve does, and its
# profile reads the SSD scan's device time under a profiler range
MAMBA_ARCH, ZAMBA_ARCH = "mamba2-130m", "zamba2-1.2b"
ZAMBA_KEYS = ("lm_zamba2:flash_attention",)
SSD_RANGE = "ssd_scan"
# path 17's profiles are cut to keep the profiler's host processing (about
# 1.3 ms an event) inside the time limit: a zamba2 prefill launches about
# 12000 kernels and a decode step about 2900, so the window is 2 requests
# with 4 new tokens each and the decode-only profile 4 steps
ZAMBA_PROFILE_REQUESTS, ZAMBA_PROFILE_NEW, ZAMBA_DECODE_PROFILE = 2, 4, 4
# frontend_check and paths 18-19: hubert-xlarge (precomputed audio frames,
# encoder only: forward is its entry point) and internvl2-1b (256 vision
# patches ahead of its Qwen2 stack), both at full width; the check cut to
# 2 layers, the paths at full depth (reduced: none; the fp32 draws are
# about 3.8 and 2.0 GB). Path 18: AUDIO_CLIPS clips of AUDIO_FRAMES frames
# (10-30 s of 16 kHz speech at HuBERT's 20 ms stride), each its own
# forward at B = 1, then one batch of AUDIO_BATCH clips of
# AUDIO_BATCH_FRAMES. Path 19: LM_REQUESTS requests of 256 seeded patches
# and VLM_TEXT_LENS text tokens, LM_MAX_NEW new tokens on LM_SLOTS slots,
# then VLM_TEXT_REQUESTS text-only requests through serve_requests
HUBERT_ARCH, VLM_ARCH, FRONTEND_LAYERS = "hubert-xlarge", "internvl2-1b", 2
AUDIO_CHECK_FRAMES = 1237                   # ragged: no multiple of 64
AUDIO_CLIPS, AUDIO_FRAMES = 8, (500, 1500)  # drawn from the seed, inclusive
AUDIO_BATCH, AUDIO_BATCH_FRAMES = 4, 1000
VLM_TEXT_LENS, VLM_MAX_LEN, VLM_TEXT_REQUESTS = (64, 1024), 2048, 4
# path 19's profiles, cut as path 17's: a window of 2 requests with 4 new
# tokens, and 4 decode steps alone
VLM_PROFILE_REQUESTS, VLM_PROFILE_NEW, VLM_DECODE_PROFILE = 2, 4, 4
FRONTEND_KEYS = ("audio_encode:flash_attention", "lm_vlm:flash_attention")
# train_check and path 20: the training path on yi-6b at full width, its
# depth cut from 32 to 8 layers (as lm_gemma2's and lm_deepseek's; the
# fp32 params, grads, microbatch accumulator and AdamW moments of 8 layers
# are about 38 GB beside the activations), train_check's to 1 (a
# checkpoint of about 8.4 GB). The corpus: TRAIN_DOCS documents of the
# synthetic source, each embedded by mean_pool_embeddings from its first
# TRAIN_DOC_TOKENS tokens (a shorter document repeated from its start to
# fill them), ordered by semantic_order (k TRAIN_K) on the card, then fed
# by a TokenPipeline at TRAIN_SEQ x TRAIN_BATCH (loss_chunk 2048 splits
# the CE in two) to TRAIN_STEPS AdamW steps of TRAIN_MICRO microbatches
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_CHECK_LAYERS = "yi-6b", 8, 1
TRAIN_DOCS, TRAIN_DOC_TOKENS, TRAIN_D_PROJ, TRAIN_K = 65536, 64, 64, 10
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 4, 2, 6
TRAIN_LR, TRAIN_WARMUP = 1e-3, 1
# train_check: the card's gradients against the CPU's at f32 activations
# (1 x TRAIN_GRAD_SEQ tokens) within TRAIN_GRAD_LIMIT of each leaf's scale
# (the CPU tests' bar against JAX); semantic_order through the kernels
# against its plain versions on the same draws over the first
# TRAIN_ORDER_DOCS documents; the checkpoint, resume, guard and rollback
# lanes at TRAIN_CKPT_BATCH x TRAIN_CKPT_SEQ, resumed losses within
# TRAIN_RESUME_LIMIT relative
TRAIN_GRAD_SEQ, TRAIN_GRAD_LIMIT = 256, 1e-4
TRAIN_ORDER_DOCS = 16384
TRAIN_CKPT_BATCH, TRAIN_CKPT_SEQ, TRAIN_RESUME_LIMIT = 2, 512, 1e-4
TRAIN_KERNELS = ("knn_join_dists", "knn_join_select", "knn_merge")
# sharding_check, path 21 (train_sharded) and train_check's sharded_ckpt
# lane: the sharding rules over the ten configs at full size on the
# production meshes (meta: no storage); yi-6b at full width on a
# SHARD_MESH (data, model) mesh of logical shards on cuda:0, its depth cut
# from 32 to SHARD_LAYERS, SHARD_STEPS FSDP steps of SHARD_BATCH x
# TRAIN_SEQ tokens beside the unsharded step with SHARD_BATCH
# microbatches from the same parameters, held to SHARD_LOSS_REL /
# SHARD_NORM_REL relative and SHARD_LEAF_REL of each leaf's largest
# magnitude; the checkpoint lane at train_check's size onto the
# (SHARD_LIVE, 1) mesh of elastic_mesh(["cuda:0"] * SHARD_LIVE,
# model_axis=2) after a shard is lost
SHARD_MESH, SHARD_LAYERS, SHARD_STEPS, SHARD_BATCH = (2, 2), 4, 3, 2
SHARD_LOSS_REL, SHARD_NORM_REL, SHARD_LEAF_REL = 1e-6, 1e-5, 1e-6
SHARD_LIVE = 3
KNN_SEQS, KNN_SEQ_LEN, KNN_K, KNN_BATCH = 16, 2048, 16, 4
KNN_CHUNK, KNN_SNAPSHOT_EVERY = 64, 128     # knn_grow: insert, snapshot
# retrieval: the interactive lane's queries and burst sizes, the deadline
# lane's batch, the overload runs' arrivals and their pump interval
RETR_INTERACTIVE, RETR_BURST, RETR_DEADLINE = 2000, (1, 16), 2048
RETR_OVERLOAD, RETR_PUMP_EVERY = 3000, 48
# path 13: logical shards on cuda:0, the fetch lane's ids a shard and
# bucket cap (the mean load, so some buckets overflow), the breaker lane's
# dispatch size and trip budget, the chaos gate (check_gate.py
# --chaos-floor)
SHARDS, SHARD_FETCH_M, SHARD_FETCH_CAP = 4, 4096, 1024
BREAKER_QUERIES, BREAKER_DISPATCHES, CHAOS_FLOOR = 512, 4, 0.80
# path 14: the sharded build's key, the fetch lane's ids a shard (1M in
# all), bucket cap (the mean load, so some buckets overflow) and chunk
# (three a shard, the last shorter), and the two select widths its main
# path must launch: the receiver select (8 * merge_k incidences, c
# merge_k) and the polish select (k^2, c 6k)
SB_KEY, SB_FETCH_M, SB_FETCH_CAP = SEED + 50, 250_000, 62_500
SB_FETCH_SPAN = 100_000
SB_WIDTHS = ((480, 60), (400, 120))
# large_k_check and path 22 (knn_build_k91): t-SNE's neighbour graph
# (scikit-learn's TSNE asks for min(n - 1, 3 perplexity + 1) = 91
# neighbours at its default perplexity of 30): build_knn_graph(k=91) at
# the default rho 0.5 on path 1's corpus (C 92, merge_k 273, receiver
# select 2 C x C = 16928, polish select k^2 = 8281 at c 6k = 546). The
# check's joins at C 92, 180, 256 and 320 (the fp32 join in panels) over
# JOIN_ROWS rows each, its selects
# at (W, c) over SELECT_ROWS rows each, and MutableKNNStore.build at k
# LARGE_K_STORE (rho 1.0: C 96)
TSNE_K = 91
LARGE_K_JOIN_C, LARGE_K_JOIN_ROWS = (92, 180, 256, 320), (4096, 2048, 1024,
                                                         512)
LARGE_K_SELECT_W = ((16928, 273), (64800, 540), (131072, 2048))
LARGE_K_SELECT_ROWS = (2048, 512, 256)
LARGE_K_STORE = 48
K91_TAG = "knn_build_k91"
# large_k_check's merges above a pool of 8192, on LARGE_K_MERGE_ROWS rows:
# the online store's k + k^2 = 8372 at k 91 and a pool past what the wide
# merge holds in shared memory (its scratch instance); its online lane at
# online_check's shape with a frontier chunk of LARGE_K_CHUNK (the plain
# version's gathered rows: 512 x 8281 x 896 floats, 15 GB); its datastore
# lane LARGE_K_DS keys, grown and shrunk by LARGE_K_DS_BATCH. Path 23
# (online_k91): path 8's shape at k 91
LARGE_K_MERGE_POOLS = ((TSNE_K, TSNE_K ** 2), (TSNE_K, 12000))
LARGE_K_MERGE_ROWS = 512
LARGE_K_CHUNK = 512
LARGE_K_DS, LARGE_K_DS_BATCH = 4096, 256
K91_ONLINE_TAG = "online_k91"
# per driven path: its dense merges above the register instances' pool
DRIVEN_WIDE_MERGES: dict[str, int] = {}
ATTN_F32_TOL = (2e-3, 2e-3)     # (rtol, atol): tests/test_kernels.py:122-137
ATTN_BF16_TOL = (1e-2, 2e-3)    # + one bf16 rounding of the output (2^-7)
# (Lq, Lk, H, Hkv, Dq, Dv, keyword arguments of ops.attention)
ATTN_MODES = {
    "causal_gqa_32_4": (1000, 1000, 32, 4, 128, 128, dict(causal=True)),
    "window_64": (1000, 1000, 8, 2, 128, 128, dict(causal=True, window=64)),
    "softcap_20": (512, 512, 8, 2, 128, 128,
                   dict(causal=True, softcap=20.0)),
    "noncausal": (333, 515, 8, 2, 64, 64, dict(causal=False)),
    "encoder_window": (600, 600, 8, 2, 64, 64,
                       dict(causal=False, window=64)),
    "gqa_8_2": (256, 256, 8, 2, 16, 16, dict(causal=True)),
    "q_offset": (100, 1124, 32, 4, 128, 128,
                 dict(causal=True, q_offset=1024)),
    "decode_row": (1, 2049, 32, 4, 128, 128,
                   dict(causal=True, q_offset=2048)),
    "ragged": (77, 301, 8, 2, 128, 128,
               dict(causal=True, q_offset=200, scale=0.05)),
    "dv_ne_dq": (300, 300, 16, 16, 192, 128, dict(causal=True)),
    "no_key_rows": (70, 40, 4, 2, 32, 32,
                    dict(causal=True, window=16, q_offset=20)),
    # the bf16 kernel's widths (TMA zero-fills panels past D) and its ring
    "dh_256": (300, 300, 4, 2, 256, 256, dict(causal=True)),
    "dh_80": (257, 257, 8, 2, 80, 80, dict(causal=True)),
    "dq48_dv32": (200, 200, 4, 2, 48, 32, dict(causal=True)),
    "long_kv_4096": (256, 4096, 8, 2, 128, 128,
                     dict(causal=True, q_offset=3840)),
}
ATTN_F32_KERNEL_MODE = "causal_gqa_32_4"   # its f32 call: the kernels line
# the search tiles are recorded again at this call of their key, round 6
# of the first query block, where the queries share fewer rows than at
# round 2; the sharing is counted over groups of SHARING_GROUP queries
LATE_ROUND = 6
SHARING_GROUP = 16
LATE_KEYS = ("search:knn_search_dists:W=120",
             "search_bf16:knn_search_dists_bf16:W=120",
             "search_int8:knn_search_dists_q8:W=120")
SEARCH_TILES = ("knn_search_dists", "knn_search_dists_bf16",
                "knn_search_dists_q8")
COMPACTIONS = ("knn_compact", "knn_compact_rows")
SEARCH_FIELDS = ("valid_candidates", "distinct_rows", "group_distinct_rows",
                 "effective_bytes_per_s")


def emit(phase: str, **fields) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - T0,
                      **fields}), flush=True)


def time_ms(fn, reps: int) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed between two CUDA events, after a warm-up. The graph keeps the
    host's launch cost out of the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    # the graph's private pool back to the card: path 22's join needs
    # tens of GB for its plain version's gathered copy
    torch.cuda.empty_cache()
    return ms


def timed(fn):
    """(fn(), seconds), the time ended by a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def exact_knn(x, k: int, chunk: int = 4096):
    """Exact fp32 k-NN ids by matmul plus the norms, TF32 off, self
    excluded by index. Held apart from the code under test."""
    import torch
    n = x.shape[0]
    x2 = (x * x).sum(1)
    out = torch.empty((n, k), dtype=torch.int64, device=x.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d = x2[s:e, None] + x2[None, :] - 2.0 * (x[s:e] @ x.T)
        d[torch.arange(e - s, device=x.device),
          torch.arange(s, e, device=x.device)] = torch.inf
        out[s:e] = d.topk(k, dim=1, largest=False).indices
    return out


def check_graph(x, dist, idx, rows: int = 2048,
                repeats_ok: bool = False) -> float:
    """The built graph is a graph of x: full rows of distinct ids, no
    self-loops, ascending finite distances that match fp64 distances
    recomputed for a sample of rows (to 1e-4 + 1e-5 * (|a|^2 + |b|^2): the
    norm expansion's cancellation). Returns the worst error over tol.
    ``repeats_ok`` lets a row keep a repeated id: both packages' random
    init draws with replacement and a merge never dedups the list, so on
    a small corpus a repeated true neighbor can survive the build (about
    3800 / n rows are expected to; ROADMAP.md, Queue 3)."""
    import torch
    n, k = idx.shape
    if not (torch.isfinite(dist).all() and (idx >= 0).all()
            and (idx < n).all()):
        raise AssertionError("build: lists are not full and finite")
    if (dist[:, 1:] < dist[:, :-1]).any():
        raise AssertionError("build: a row is not ascending")
    rows_all = torch.arange(n, device=idx.device)[:, None]
    if (idx == rows_all).any():
        raise AssertionError("build: a self-loop")
    srt = idx.sort(dim=1).values
    if (srt[:, 1:] == srt[:, :-1]).any() and not repeats_ok:
        raise AssertionError("build: a repeated id in a row")
    r = torch.randperm(n, device=x.device)[:rows]
    xa = x[r].double()
    xb = x[idx[r].long()].double()
    d64 = ((xa[:, None, :] - xb) ** 2).sum(-1)
    tol = 1e-4 + 1e-5 * ((xa * xa).sum(-1)[:, None] + (xb * xb).sum(-1))
    worst = float(((dist[r].double() - d64).abs() / tol).max())
    if worst > 1.0:
        raise AssertionError(f"build: distances off by {worst:.3g} x tol")
    return worst


class Recorder:
    """For one path: keeps a copy of the inputs of the second call of each
    kernel entry point in ``kernels/ops.py`` (per select width and search
    width) — for the join distances that is the first iteration after the
    reorder, where both candidate pools are full; for the search tile the
    second round of the first block (and, for LATE_KEYS, round
    LATE_ROUND of it too, under the key plus ``:round=6``; the script
    fails if that call is not the first block's), for attention (kept as
    ``flash_attention``, keyword arguments too) the second layer of the
    first prefill (in LAYER_KIND_TAGS' paths, the second of each kind:
    ``:local`` with a window, ``:global`` without; in ATTN_KIND_SUFFIX'
    paths, the key carries that suffix) — and the host time of
    the greedy reorder. It wraps the
    module attributes the path calls and restores them on exit; the
    wrapped functions are the ones the path would call, so each kernel
    launches as it would. Keys carry the path's tag.
    ``launched`` holds, per key, what the calls added to the kernel's
    count in ``_lib.LAUNCHES`` (the wrappers' own counts);
    ``wide_merges`` what the dense merges above a pool of MERGE_MAX_POOL
    added to ``knn_merge``'s (row 3d's launches)."""

    NAMES = ("knn_join_dists", "knn_join_select", "knn_merge",
             "pairwise_sq_l2", "knn_search_dists", "knn_search_dists_q8",
             "knn_search_dists_bf16", "knn_join_dists_q8",
             "knn_join_dists_bf16", "knn_compact", "knn_merge_rows",
             "knn_compact_rows", "attention", "centroid_assign")
    # entry points recorded under the kernel they launch
    KERNEL_OF = {"attention": "flash_attention",
                 "centroid_assign": "pairwise_sq_l2"}

    def __init__(self, tag: str):
        self.tag = tag
        self.calls: dict[str, tuple] = {}
        self.kwargs: dict[str, dict] = {}
        self.seen: dict[str, int] = {}
        self.launched: dict[str, int] = {}
        self.reorder_s: list[float] = []
        self.first_q: dict[str, int] = {}
        self.wide_merges = 0

    def __enter__(self):
        from repro_torch.core import nn_descent
        from repro_torch.kernels import ops
        self._ops, self._nd = ops, nn_descent
        self._saved = {n: getattr(ops, n) for n in self.NAMES}
        for name, fn in self._saved.items():
            setattr(ops, name, self._wrap(name, fn))
        self._reorder = nn_descent.greedy_reorder
        nn_descent.greedy_reorder = self._timed_reorder
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._ops, name, fn)
        self._nd.greedy_reorder = self._reorder

    def _wrap(self, name, fn):
        import torch
        from repro_torch.kernels import _lib
        from repro_torch.kernels.knn_merge import MERGE_MAX_POOL

        kernel = self.KERNEL_OF.get(name, name)

        def call(*args, **kw):
            key = f"{self.tag}:{kernel}"
            if name == "knn_join_select":
                key += f":W={args[0].shape[1]}:c={args[3]}"
            elif name in ("knn_search_dists", "knn_search_dists_bf16"):
                key += f":W={args[4].shape[1]}"
            elif name == "knn_search_dists_q8":
                key += f":W={args[6].shape[1]}"
            elif name == "knn_merge_rows":
                key += f":c={args[3].shape[1]}"
            elif name == "centroid_assign":
                key += ":centroid_assign"
            elif name == "attention" and self.tag in LAYER_KIND_TAGS:
                key += ":global" if kw.get("window") is None else ":local"
            elif name == "attention" and self.tag in ATTN_KIND_SUFFIX:
                key += ATTN_KIND_SUFFIX[self.tag]
            self.seen[key] = self.seen.get(key, 0) + 1
            if key in LATE_KEYS:
                # a block's queries are one slice of the padded batch
                if self.seen[key] == 1:
                    self.first_q[key] = args[0].data_ptr()
                elif self.seen[key] == LATE_ROUND:
                    if args[0].data_ptr() != self.first_q[key]:
                        raise AssertionError(
                            f"{key}: call {LATE_ROUND} is not the first "
                            "block's")
                    self.calls[f"{key}:round={LATE_ROUND}"] = tuple(
                        a.clone() for a in args)
                    self.kwargs[f"{key}:round={LATE_ROUND}"] = dict(kw)
            if self.seen[key] == 2:
                # centroid_assign's tile: pairwise_sq_l2(q, centroids)
                rec = (args[0].contiguous(), args[2].contiguous()) \
                    if name == "centroid_assign" else args
                self.calls[key] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in rec)
                self.kwargs[key] = dict(kw)
            before = _lib.LAUNCHES[kernel]
            out = fn(*args, **kw)
            added = _lib.LAUNCHES[kernel] - before
            self.launched[key] = self.launched.get(key, 0) + added
            if name == "knn_merge" and args[0].shape[1] \
                    + args[2].shape[1] > MERGE_MAX_POOL:
                self.wide_merges += added
            return out
        return call

    def _timed_reorder(self, nl):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self._reorder(nl)
        torch.cuda.synchronize()
        self.reorder_s.append(time.perf_counter() - t0)
        return out


def profile_run(run, top: int = 12, ranges=(), host_ops: bool = True) -> dict:
    """One more run of a path under ``torch.profiler``: device time by
    kernel name, the device kernels launched, and the device's busy share
    of the (profiled) wall time; for each name in ``ranges`` (a
    ``record_function`` range the run opens, ``ranged``), the device time
    of the kernels launched inside it. ``host_ops`` False traces the
    device alone (about half the events to process, no ranges).
    The profiler's own cost lengthens the wall time, so the idle share is
    an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _lib
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side events only: a CPU op's device time is its kernels'; a
    # range's own device-side span is not a kernel
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and e.key not in ranges), reverse=True)
    busy_s = sum(r[0] for r in rows) * 1e-6
    ours = {name: sum(r[0] for r in rows if f"{name}_kernel" in r[2]) * 1e-6
            for name in _lib.KERNELS}
    # the variants' own share of their kernel's (the wide joins, the
    # streamed select, ...)
    ours.update({name: sum(r[0] for r in rows if sub in r[2]) * 1e-6
                 for sub, name in _lib.VARIANTS.items()})
    # a profiler that saw no device activity measured nothing
    idle = 1.0 - busy_s / wall if busy_s > 0 else "not measured"
    out = {
        "profiled_wall_s": wall, "device_busy_s": busy_s,
        "device_idle_share": idle, "our_kernels_s": ours,
        "device_kernel_calls": sum(r[1] for r in rows),
        "top": [{"name": k[:90], "calls": c, "device_s": t * 1e-6}
                for t, c, k in rows[:top]],
    }
    if ranges:
        out["ranges"] = {name: {
            "calls": sum(e.count for e in events if e.key == name
                         and e.device_type == DeviceType.CPU),
            "device_s": sum(e.device_time_total for e in events
                            if e.key == name
                            and e.device_type == DeviceType.CPU) * 1e-6}
            for name in ranges}
    return out


class ranged:
    """``module.<name>`` wrapped in a ``record_function(name)`` range while
    the block runs, so that a profile can read the device time of the
    kernels launched inside it; the module's own callers look the name up
    at call time, so they run through the wrapper."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name

    def __enter__(self):
        import torch
        fn = self.fn = getattr(self.module, self.name)

        def wrapped(*args, **kw):
            with torch.profiler.record_function(self.name):
                return fn(*args, **kw)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def close_to_plain(name, got, want, scale) -> dict:
    """Hold a kernel's distances against its plain version's: +inf at the
    same places, and the finite ones within 1e-4 + 1e-5 * scale. The
    scale is the operands' squared norms, not the cancelled result:
    |a|^2 + |b|^2 - 2ab loses the leading digits the norms share, and two
    fp32 sums of dp products in another order differ by about
    eps * sqrt(dp) * |a||b|."""
    import torch
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError(f"{name}: +inf positions differ")
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    tol = 1e-4 + 1e-5 * scale[fin]
    worst = float((err / tol).max()) if err.numel() else 0.0
    if worst > 1.0:
        raise AssertionError(f"{name}: error {worst:.3g} x tol")
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "max_err_over_tol": worst}


def group_rows(ids, valid) -> int:
    """Distinct valid ids summed over groups of SHARING_GROUP consecutive
    queries: the rows a tile that read a row once per group would read."""
    import torch
    return sum(int(torch.unique(ids[s:s + SHARING_GROUP][
        valid[s:s + SHARING_GROUP]]).numel())
        for s in range(0, ids.shape[0], SHARING_GROUP))


def check_kernel(name, args, reps):
    """Kernel vs plain version on one recorded call; times and bound."""
    import torch
    from repro_torch.kernels import ops, ref
    fn = getattr(ops, name)
    got = fn(*args)
    want = fn(*args, backend="ref")
    torch.cuda.synchronize()
    entry = {"name": name, "shape": [list(a.shape) if hasattr(a, "shape")
                                     else a for a in args]}
    peak = PEAK_FP32_PER_S
    if name in QUANT_OWNER:
        flops, nbytes, peak = check_quant_kernel(name, args, got, want,
                                                 entry, reps)
    elif name == "knn_join_dists":
        (gd, gev), (wd, wev) = got, want
        x, x2, ids, cn = args
        if not torch.equal(gev, wev):
            raise AssertionError("knn_join_dists: evals differ")
        safe = ids.clamp_min(0).long()
        entry.update(close_to_plain(
            name, gd, wd, x2[safe][:, :, None] + x2[safe][:, None, :]))
        entry["tolerance"] = "1e-4 + 1e-5 * (x2[a] + x2[b]); inf, evals exact"
        pairs = int(gev.sum())
        flops = 2 * x.shape[1] * pairs
        nbytes = 4 * (x.numel() + x2.numel() + ids.numel() + gd.numel()
                      + gev.numel())
        valid = ids >= 0
        xg = x[safe].masked_fill_(~valid[:, :, None], 0.0)
        x2g = torch.where(valid, x2[safe], 0.0)
        base = x2g[:, :, None] + x2g[:, None, :]
        xgt = xg.transpose(1, 2)
        ok = ref._join_ok(ids, cn)

        def library():
            dd = torch.baddbmm(base, xg, xgt, alpha=-2.0)
            return torch.where(ok, dd.clamp_min(0.0), torch.inf)
        entry["library_ms"] = time_ms(library, reps)
        entry["library_call"] = "torch.baddbmm on gathered rows + mask"
        del xg, xgt, base
    elif name == "pairwise_sq_l2":
        a, b = args
        a2, b2 = (a * a).sum(1), (b * b).sum(1)
        entry.update(close_to_plain(name, got, want,
                                    a2[:, None] + b2[None, :]))
        entry["tolerance"] = "1e-4 + 1e-5 * (|a|^2 + |b|^2)"
        (m, d), n = a.shape, b.shape[0]
        flops = 2 * m * n * d + 2 * (m + n) * d
        nbytes = 4 * (m * d + n * d + m * n)

        def library():
            return torch.addmm(b2[None, :], a, b.T, alpha=-2.0).add_(
                a2[:, None]).clamp_min_(0.0)
        entry["library_ms"] = time_ms(library, reps)
        entry["library_call"] = "torch.addmm of the norms and -2 a@b.T, " \
            "clamped, TF32 off"
    elif name == "knn_search_dists":
        q, q2, x, x2, ids = args
        valid = (ids >= 0) & (ids < x.shape[0])
        safe = torch.where(valid, ids, 0).long()
        entry.update(close_to_plain(name, got, want,
                                    q2[:, None] + x2[safe]))
        entry["tolerance"] = "1e-4 + 1e-5 * (q2 + c2); inf exact"
        nq, dp = q.shape
        n_valid = int(valid.sum())
        rows = int(torch.unique(ids[valid]).numel())
        entry.update(valid_candidates=n_valid, distinct_rows=rows,
                     group_distinct_rows=group_rows(ids, valid),
                     row_bytes=4 * dp)
        # each distinct candidate row (and its norm) read once; the
        # queries, ids and output once
        nbytes = 4 * (rows * (dp + 1) + nq * (dp + 1) + 2 * ids.numel())
        flops = 2 * dp * n_valid
        xg = x[safe]
        base = (q2[:, None] + x2[safe])[:, :, None]
        qc = q[:, :, None]

        def library():
            dd = torch.baddbmm(base, xg, qc, alpha=-2.0)[:, :, 0]
            return torch.where(valid, dd.clamp_min(0.0), torch.inf)
        entry["library_ms"] = time_ms(library, reps)
        entry["library_call"] = "torch.baddbmm on gathered rows + mask"
        del xg, base
    else:
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel and plain differ")
        fin = torch.isfinite(want[0])
        entry["max_abs_err"] = float((got[0] - want[0]).abs()[fin].max()) \
            if fin.any() else 0.0
        entry["tolerance"] = "bitwise"
        if name == "knn_join_select":
            gd, gi, kth, c = args
            n, w = gd.shape
            nbytes = 8 * n * w + 4 * n + 8 * n * c
            flops = 2 * n * w                    # prefilter compares
            pool = torch.where((gi >= 0) & (gd < kth[:, None]), gd, ref.BIG)
            entry["library_ms"] = time_ms(
                lambda: torch.sort(pool, dim=1, stable=True), reps)
            entry["library_call"] = "torch.sort(stable=True) of masked keys"
        elif name == "knn_merge":
            cd, ci, qd, qi = args
            n, k = cd.shape
            c = qd.shape[1]
            nbytes = 8 * n * k + 8 * n * c + 8 * n * k + 4 * n
            # one dedup probe and one selection compare per pool entry
            flops = 2 * n * (k + c)
            # the yardstick's pool is masked beforehand, as for row 6a
            pool_d = torch.cat([
                torch.where(torch.isinf(cd), ref.BIG, cd),
                torch.where(ref.candidate_dups(ci, qi), ref.BIG, qd)], dim=1)
            pool_i = torch.cat([ci, qi], dim=1)

            def library():
                srt, order = torch.sort(pool_d, dim=1, stable=True)
                return srt[:, :k], torch.gather(pool_i, 1, order[:, :k])
            entry["library_ms"] = time_ms(library, reps)
            entry["library_call"] = "torch.sort(stable=True) of the masked " \
                "pool + gather"
        else:
            flops, nbytes = check_online_kernel(name, args, entry, reps)
    entry["ms"] = time_ms(lambda: fn(*args), reps)
    entry["plain_ms"] = time_ms(lambda: fn(*args, backend="ref"),
                                max(2, reps // 5))
    if name in SEARCH_TILES:
        entry["effective_bytes_per_s"] = entry["valid_candidates"] * \
            entry["row_bytes"] / (entry["ms"] * 1e-3)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    entry["bound_ms"] = max(t_bytes, t_ops)
    entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    entry["bytes"] = nbytes
    entry["operations"] = flops
    return entry


def check_online_kernel(name, args, entry, reps):
    """Bytes, operations and library yardstick of the online store's three
    kernels on one recorded call (their outputs were held bitwise against
    the plain versions already). The row forms return full copies of the
    (n, k) lists, so their bytes count the lists read and written once;
    ``copy_ms`` is the time of that copy alone. The library call is a
    stable ``torch.sort`` of the masked pool plus ``gather`` (and, for the
    row forms, ``index_copy_`` into a copy of the lists); the masks are
    made beforehand, as for the select's yardstick. Returns (operations,
    bytes)."""
    import torch
    from repro_torch.kernels import ref
    if name == "knn_compact":
        cd, ci, drop = args
        n, k = cd.shape
        keep = ~drop & (ci >= 0) & torch.isfinite(cd)
        # a key per entry, then a compare per pair of survivors (the
        # select's rank step: every survivor wins, c = k)
        flops = n * k + int((keep.sum(1) ** 2).sum())
        nbytes = 9 * n * k + 8 * n * k + 4 * n
        masked = torch.where(keep, cd, torch.inf)

        def library():
            srt, order = torch.sort(masked, dim=1, stable=True)
            return srt, torch.gather(ci, 1, order)
        entry["library_ms"] = time_ms(library, reps)
        entry["library_call"] = "torch.sort(stable=True) of masked keys " \
            "+ gather"
        return flops, nbytes
    cd, ci, rows = args[:3]
    n, k = cd.shape
    ok = rows >= 0
    safe = torch.where(ok, rows, 0).long()
    sel = torch.nonzero(ok)[:, 0]
    tgt = rows[sel].long()
    f = int(sel.numel())
    entry.update(frontier_rows=f, padded_rows=int(rows.numel()))
    if name == "knn_merge_rows":
        qd, qi = args[3:]
        c = qd.shape[1]
        sub_d, sub_i = cd[safe], ci[safe]
        pool_d = torch.cat([
            torch.where(torch.isinf(sub_d), ref.BIG, sub_d),
            torch.where(ref.candidate_dups(sub_i, qi), ref.BIG, qd)], dim=1)
        pool_i = torch.cat([sub_i, qi], dim=1)
        flops = 2 * f * (k + c)    # as knn_merge's
        nbytes = 16 * n * k + f * (8 * c + 8)
    else:
        drop = args[3]
        sub_d, sub_i = cd[safe], ci[safe]
        keep = ~drop & (sub_i >= 0) & torch.isfinite(sub_d)
        pool_d = torch.where(keep, sub_d, torch.inf)
        pool_i = sub_i
        flops = f * k + int((keep[sel].sum(1) ** 2).sum())   # as above
        nbytes = 16 * n * k + f * (k + 8)

    def library():
        srt, order = torch.sort(pool_d, dim=1, stable=True)
        md = srt[:, :k].index_select(0, sel)
        mi = torch.gather(pool_i, 1, order[:, :k]).index_select(0, sel)
        return (cd.clone().index_copy_(0, tgt, md),
                ci.clone().index_copy_(0, tgt, mi))
    entry["library_ms"] = time_ms(library, reps)
    entry["library_call"] = "torch.sort(stable=True) of the masked pool " \
        "+ gather + index_copy_ into a copy of the lists"
    entry["copy_ms"] = time_ms(lambda: (cd.clone(), ci.clone()), reps)
    return flops, nbytes


def check_quant_kernel(name, args, got, want, entry, reps):
    """The int8 / bf16 tiles against their plain versions (int8 bitwise,
    bf16 within the fp32 tiles' tolerance); a library yardstick; the bytes
    and operations of this call. Returns (operations, bytes, peak rate)."""
    import torch
    int8 = name.endswith("_q8")
    peak = PEAK_INT8_PER_S if int8 else PEAK_BF16_PER_S
    if name.startswith("knn_join"):
        data, x2, ids, cn = (args[0], args[2], args[3], args[4]) if int8 \
            else args
        (gd, gev), (wd, wev) = got, want
        if not torch.equal(gev, wev):
            raise AssertionError(f"{name}: evals differ")
        big_n = data.shape[0]
        valid = (ids >= 0) & (ids < big_n)
        safe = torch.where(valid, ids, 0).long()
        x2g = torch.where(valid, x2[safe], 0.0)
        scale = x2g[:, :, None] + x2g[:, None, :]
        pairs = int(gev.sum())
        out_bytes = 4 * (gd.numel() + gev.numel())
        # the whole mirror (rows, scales, norms) read once, ids, outputs
        nbytes = data.numel() * data.element_size() \
            + 4 * big_n * (2 if int8 else 1) + 4 * ids.numel() + out_bytes
        flops = 2 * data.shape[1] * pairs
        if not int8:
            xg = torch.where(valid[:, :, None], data[safe], 0)
            base = scale
            xgt = xg.transpose(1, 2)
            ok = torch.isfinite(wd)
    else:
        if int8:
            q, x, x2, ids = args[0], args[3], args[5], args[6]
            q2 = args[2]
        else:
            q, q2, x, x2, ids = args
        gd, wd = got, want
        big_n = x.shape[0]
        valid = (ids >= 0) & (ids < big_n)
        safe = torch.where(valid, ids, 0).long()
        scale = q2[:, None] + x2[safe]
        n_valid = int(valid.sum())
        rows = int(torch.unique(ids[valid]).numel())
        entry.update(valid_candidates=n_valid, distinct_rows=rows,
                     group_distinct_rows=group_rows(ids, valid),
                     row_bytes=x.shape[1] * x.element_size())
        row_bytes = x.shape[1] * x.element_size() + (8 if int8 else 4)
        # each distinct candidate row (and its scale, norm) read once; the
        # queries, ids and output once
        nbytes = (rows + q.shape[0]) * row_bytes + 8 * ids.numel()
        flops = 2 * x.shape[1] * n_valid
        if not int8:
            xg = x[safe]
            base = scale[:, :, None]
            xgt = q[:, :, None]
            ok = valid
    if not torch.equal(torch.isinf(gd), torch.isinf(wd)):
        raise AssertionError(f"{name}: +inf positions differ")
    fin = torch.isfinite(wd)
    err = (gd - wd).abs()[fin]
    entry["max_abs_err"] = float(err.max()) if err.numel() else 0.0
    if int8:
        if not torch.equal(gd, wd):
            raise AssertionError(f"{name}: kernel and plain differ")
        entry["tolerance"] = "bitwise; inf and evals exact"
        entry["library_ms"] = None
        entry["library_call"] = (
            "none: PyTorch has no batched int8 x int8 -> int32 product "
            "(torch._int_mm is 2-D only)")
    else:
        entry.update(close_to_plain(name, gd, wd, scale))
        entry["tolerance"] = "1e-4 + 1e-5 * (|a|^2 + |b|^2); inf exact"

        def library(bf16_out=False):
            if bf16_out:   # rounds every distance to bf16: not the function
                dd = torch.baddbmm(base.to(torch.bfloat16), xg, xgt,
                                   alpha=-2.0).float()
            else:
                dd = torch.baddbmm(base, xg, xgt, alpha=-2.0,
                                   out_dtype=torch.float32)
            if name.startswith("knn_search"):
                dd = dd[:, :, 0]
            return torch.where(ok, dd.clamp_min(0.0), torch.inf)
        entry["library_ms"] = time_ms(library, reps)
        entry["library_bf16_out_ms"] = time_ms(
            lambda: library(bf16_out=True), reps)
        entry["library_call"] = "torch.baddbmm(out_dtype=torch.float32) " \
            "on bf16 rows gathered beforehand + mask (library_bf16_out_ms: " \
            "the same with a bf16 output, which rounds every distance)"
    return flops, nbytes, peak


def width_of(entry) -> int:
    """The width that picks a kernel's representative call: the candidate
    width of a row merge, else the second dim of the first input."""
    shape = entry["shape"]
    return shape[3][1] if entry["name"] == "knn_merge_rows" else shape[0][1]


def drive(tag: str, run):
    """Drive one path: every launch count set to 0 just before it and
    read just after, its kernels' inputs recorded, its wall time and peak
    memory taken. Returns (output, wall_s, launches, peak_bytes,
    recorder)."""
    import torch
    from repro_torch.kernels import _lib
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    with Recorder(tag) as rec:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    DRIVEN_WIDE_MERGES[tag] = DRIVEN_WIDE_MERGES.get(tag, 0) \
        + rec.wide_merges
    return out, wall, launches, torch.cuda.max_memory_allocated(), rec


def require_launched(tag: str, launches: dict, names) -> None:
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag} path never launched {missing}")


def noisy_queries(x, nq: int, seed: int):
    """The JAX search bench's queries: the corpus's first rows plus
    0.01 * N(0, 1) noise (benchmarks/bench_search.py:113)."""
    import torch
    g = torch.Generator(device=x.device).manual_seed(seed)
    return x[:nq] + 0.01 * torch.randn(nq, x.shape[1], generator=g,
                                       device=x.device)


def check_search(dist, idx, n: int, k_out: int) -> None:
    """A search result over n rows: full rows of distinct ids in [0, n),
    finite ascending distances."""
    import torch
    if dist.shape != idx.shape or idx.shape[1] != k_out:
        raise AssertionError(f"search: shapes {dist.shape}, {idx.shape}")
    if not (torch.isfinite(dist).all() and (idx >= 0).all()
            and (idx < n).all()):
        raise AssertionError("search: rows are not full and finite")
    if (dist[:, 1:] < dist[:, :-1]).any():
        raise AssertionError("search: a row is not ascending")
    srt = idx.sort(dim=1).values
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError("search: a repeated id in a row")


def search_check(xc, gidx, scfg) -> dict:
    """The search through the kernels, through their plain versions and
    through the greedy oracle, on one graph with the same entries; recall
    against brute_force_knn."""
    import torch
    from repro_torch import brute_force_knn, graph_search, recall_at_k
    q = noisy_queries(xc, CHECK_QUERIES, SEED + 2)
    _, ti = brute_force_knn(xc, q, 10, exclude_self=False, chunk=TRUTH_CHUNK)
    g = torch.Generator(device=xc.device).manual_seed(SEED + 3)
    entry = torch.randperm(xc.shape[0], generator=g, device=xc.device)[
        :scfg.beam].to(torch.int32)
    from repro_torch.kernels import ref
    out = {}
    runs = [("plain", "f32"), ("auto", "f32"), ("ref", "f32")] + [
        (b, p) for p in PRECISIONS for b in ("plain", "auto")]
    for backend, prec in runs:
        cfg = dataclasses.replace(scfg, backend=backend, precision=prec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i = graph_search(xc, gidx, q, k_out=10, entry=entry, cfg=cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_search(d, i, xc.shape[0], 10)
        key = backend if prec == "f32" else f"{prec}_{backend}"
        out[key] = {"seconds": seconds, "recall_at_10": recall_at_k(i, ti)}
        if prec != "f32":
            # returned distances are the fp32 tile's, not quantized ones
            q2, x2 = (q * q).sum(1), (xc * xc).sum(1)
            want = ref.knn_search_dists(q, q2, xc, x2, i)
            out[key].update(close_to_plain(
                f"search_check {key}", d, want, q2[:, None] + x2[i.long()]))
    r = {b: v["recall_at_10"] for b, v in out.items()}
    if abs(r["auto"] - r["plain"]) > 0.01 or r["auto"] < r["ref"] - 0.02:
        raise AssertionError(f"search_check failed: {r}")
    for prec in PRECISIONS:
        if abs(r[f"{prec}_auto"] - r[f"{prec}_plain"]) > 0.01 \
                or r[f"{prec}_auto"] < r["auto"] - 0.03:
            raise AssertionError(f"search_check {prec} failed: {r}")
    return out


def run_online(x, n_base, ins_batch, dels, del_batch, cfg, descent,
               queries=None, search_off=None, k=20) -> dict:
    """The online path: a store of k-lists built on x[:n_base], the rest
    of x inserted in batches, ``dels`` deleted in batches, then (with
    ``queries``) one routed search and one with ``search_off``. Wall time
    of each step, ended by a synchronize."""
    import torch
    from repro_torch import MutableKNNStore, knn_delete, knn_insert
    g = torch.Generator(device=x.device).manual_seed(SEED)
    out = {"insert_s": [], "delete_s": [], "insert": [], "delete": []}
    (store, out["build_stats"]), out["build_s"] = timed(
        lambda: MutableKNNStore.build(x[:n_base], k, cfg=cfg,
                                      descent=descent, generator=g))
    out["capacity"] = [store.capacity]
    for s in range(n_base, x.shape[0], ins_batch):
        (store, st), sec = timed(
            lambda: knn_insert(store, x[s:s + ins_batch], generator=g))
        out["insert_s"].append(sec)
        out["insert"].append(st)
        out["capacity"].append(store.capacity)
    for s in range(0, dels.shape[0], del_batch):
        (store, st), sec = timed(
            lambda: knn_delete(store, dels[s:s + del_batch]))
        out["delete_s"].append(sec)
        out["delete"].append(st)
    if queries is not None:
        out["search"], out["search_s"] = timed(
            lambda: store.search(queries, k_out=10))
        out["search_off"], out["search_off_s"] = timed(
            lambda: store.search(queries, k_out=10, cfg=search_off))
    out["store"] = store
    return out


def live_truth(x, alive, k: int):
    """Store ids of the live rows, and the exact k-NN among them (as store
    ids)."""
    import torch
    live = torch.nonzero(alive[:x.shape[0]])[:, 0]
    return live, live[exact_knn(x[live], k)]


def check_live_lists(store, dead, rows: int = 2048) -> dict:
    """The live rows' lists after the online updates: ids >= 0 in a prefix
    with (+inf, -1) after it, every listed id live and never one of
    ``dead``, no self-loop, ascending finite distances within 1e-4 +
    1e-5 (|a|^2 + |b|^2) of fp64 distances on a sample of rows. Rows
    shorter than k and rows with a repeated id (a reference behavior,
    ROADMAP Queue 3) are counted, not refused."""
    import torch
    n = store.n
    x, alive = store.x[:n], store.alive[:n]
    live = torch.nonzero(alive)[:, 0]
    dist, idx = store.nl.dist[live], store.nl.idx[live]
    valid = idx >= 0
    if (valid[:, 1:] & ~valid[:, :-1]).any():
        raise AssertionError("online: a hole inside a list")
    if not torch.equal(valid, torch.isfinite(dist)):
        raise AssertionError("online: an id beside +inf or -1 beside a "
                             "distance")
    ids = idx[valid].long()
    if not alive[ids].all() or torch.isin(ids, dead).any():
        raise AssertionError("online: a tombstoned id in a live list")
    if (idx == live[:, None]).any():
        raise AssertionError("online: a self-loop")
    if (dist[:, 1:] < dist[:, :-1])[valid[:, 1:]].any():
        raise AssertionError("online: a list is not ascending")
    srt = torch.where(valid, idx, -2 - torch.arange(
        idx.shape[1], device=idx.device)).sort(dim=1).values
    repeated = int((srt[:, 1:] == srt[:, :-1]).any(1).sum())
    r = torch.randperm(live.numel(), device=x.device)[:rows]
    xa = x[live[r]].double()
    xb = x[idx[r].clamp_min(0).long()].double()
    d64 = ((xa[:, None, :] - xb) ** 2).sum(-1)
    tol = 1e-4 + 1e-5 * ((xa * xa).sum(-1)[:, None] + (xb * xb).sum(-1))
    err = ((dist[r].double() - d64).abs() / tol)[valid[r]]
    worst = float(err.max())
    if worst > 1.0:
        raise AssertionError(f"online: distances off by {worst:.3g} x tol")
    return {"dist_err_over_tol": worst,
            "rows_short_of_k": int((~valid[:, -1]).sum()),
            "rows_with_a_repeated_id": repeated}


def online_check(xc, dev) -> dict:
    """The online path at 16000 rows through the kernels and through the
    plain versions, same draws; recall@20 of the live lists."""
    import torch
    from repro_torch import (DescentConfig, OnlineConfig, RouterConfig,
                             recall_at_k)
    from repro_torch.kernels import _lib
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    dels = torch.randperm(CHECK_N, generator=g, device=dev)[:CHECK_N // 10]
    out = {}
    for backend in ("plain", "auto"):
        cfg = OnlineConfig(router=RouterConfig(), backend=backend)
        descent = DescentConfig(k=20, rho=1.0, max_iters=15, backend=backend)
        _lib.reset_launches()
        res = run_online(xc, CHECK_BASE, CHECK_BATCH, dels, CHECK_BATCH,
                         cfg, descent)
        store = res["store"]
        live, truth = live_truth(xc, store.alive, 20)
        out[backend] = {
            "recall_at_20": recall_at_k(store.nl.idx[live], truth),
            "insert_dist_evals": sum(st.dist_evals for st in res["insert"]),
            "delete_dist_evals": sum(st.dist_evals for st in res["delete"]),
            "seconds": res["build_s"] + sum(res["insert_s"])
            + sum(res["delete_s"]),
            "launches": {k: v for k, v in _lib.LAUNCHES.items() if v},
            **check_live_lists(store, dels)}
        if backend == "auto":
            require_launched("online_check", _lib.LAUNCHES, ONLINE_KERNELS)
        elif any(_lib.LAUNCHES.values()):
            raise AssertionError(f"online_check plain run launched "
                                 f"{_lib.LAUNCHES}")
    gap = abs(out["auto"]["recall_at_20"] - out["plain"]["recall_at_20"])
    out["recall_gap"] = gap
    if gap > 0.01:
        raise AssertionError(f"online_check failed: {out}")
    return out


def cluster_router_check(dev) -> dict:
    """The JAX router test's shape (tests/test_router.py:111-156): 64
    well-separated clusters x 784 rows at d 16, per-cluster exact graphs
    (no edge between clusters), 256 queries; 32 random entries against
    seeds routed by a 256-centroid router, through the kernels."""
    import torch
    from repro_torch import (RouterConfig, SearchConfig, brute_force_knn,
                             build_router, graph_search, recall_at_k)
    n_c, per, d, k = 64, 784, 16, 10
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    cent = torch.randn(n_c, d, generator=g, device=dev) * 12.0
    x = (cent[:, None, :] + torch.randn(n_c, per, d, generator=g,
                                        device=dev)).reshape(-1, d)
    gidx = torch.cat([exact_knn(x[c * per:(c + 1) * per], k) + c * per
                      for c in range(n_c)]).to(torch.int32)
    q = x[::196] + 0.01
    _, ti = brute_force_knn(x, q, k, exclude_self=False)
    cfg = SearchConfig(beam=32, rounds=24, expand=4)
    _, ri = graph_search(x, gidx, q, k_out=10, cfg=cfg, generator=torch.
                         Generator(device=dev).manual_seed(SEED + 11))
    router = build_router(x, cfg=RouterConfig(n_centroids=256, iters=6),
                          generator=torch.Generator(
                              device=dev).manual_seed(SEED + 13))
    _, si = graph_search(x, gidx, q, k_out=10, cfg=cfg, router=router,
                         generator=torch.Generator(
                             device=dev).manual_seed(SEED + 11))
    out = {"random_recall_at_10": recall_at_k(ri, ti),
           "routed_recall_at_10": recall_at_k(si, ti)}
    if out["random_recall_at_10"] >= 0.75 \
            or out["routed_recall_at_10"] < 0.85:
        raise AssertionError(f"online_check router shape failed: {out}")
    return out

def compare_lists(got, want, x2) -> dict:
    """Two (n, k) neighbor lists that two paths built from the same
    candidates by the norm expansion, summed in other orders: +inf at the
    same slots; distances slot by slot within 1e-4 + 1e-5 (|a|^2 + |b|^2)
    (``x2`` the rows' squared norms: the expansion cancels the digits the
    norms share); ids exact at every slot but where the paths order two
    entries whose distances agree within twice that differently: the id
    sits at such a slot of the other list, or ties with the row's k-th
    distance (one path's rounding kept it at the cut, the other's not).
    Counts both kinds; fails on any other difference."""
    import torch
    gd, gi, wd, wi = got.dist, got.idx, want.dist, want.idx
    fin = torch.isfinite(wd)
    if not torch.equal(torch.isfinite(gd), fin):
        raise AssertionError("lists: +inf at other slots")
    rows = torch.arange(wd.shape[0], device=wd.device)[:, None]
    tol = 1e-4 + 1e-5 * (x2[rows] + x2[wi.clamp_min(0).long()])
    over = torch.where(fin, (gd - wd).abs() / tol, 0.0)
    if bool((over > 1).any()):
        raise AssertionError(f"lists: distances off by {float(over.max())}"
                             " x the tolerance")
    mism = gi != wi
    near = (wd[:, None, :] - wd[:, :, None]).abs() \
        <= 2 * torch.maximum(tol[:, :, None], tol[:, None, :])
    held = ((gi[:, :, None] == wi[:, None, :]) & near).any(-1)
    at_cut = (wd - wd[:, -1:]).abs() <= 2 * torch.maximum(tol, tol[:, -1:])
    tie = mism & held
    cut = mism & ~held & at_cut
    other = int((mism & ~held & ~at_cut).sum())
    out = {"slots": int(mism.numel()), "id_mismatches": int(mism.sum()),
           "tie_order_mismatches": int(tie.sum()),
           "cut_tie_mismatches": int(cut.sum()),
           "rows_with_a_mismatch": int(mism.any(1).sum()),
           "other_mismatches": other,
           "dist_err_over_tol": float(over.max())}
    if other:
        raise AssertionError(f"lists: ids differ past tie order: {out}")
    return out


def ref_iteration_check(xc, dev) -> dict:
    """One sampled iteration at DescentConfig(k=20, rho=1.0) on the check
    corpus, from one random init and one set of draws, through the kernels
    (join_src = the largest in-degree of the candidate buffers, so no
    incidence overflows), through the fused path's plain versions and
    through the lexsort "ref" path on the card (tests/test_knn_join.py:195
    at 16000 x 784). Each fused list against the "ref" list as
    ``compare_lists`` holds them; evaluations equal; updates equal but for
    at most one a cut tie (a pair at the receiver's k-th distance that one
    path's rounding admits and the other's not); the "ref" and plain runs
    launch no kernel."""
    import torch
    from repro_torch import DescentConfig
    from repro_torch.core import heap, nn_descent, selection
    from repro_torch.core.layout import pad_features
    from repro_torch.kernels import _lib
    n, k = xc.shape[0], 20
    xp = pad_features(xc).contiguous()
    x2 = (xp * xp).sum(1)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    nl0 = heap.init_random_with_dists(xp, k, generator=g)
    draws = tuple(torch.rand(2 * n * k, generator=g, device=dev)
                  for _ in range(3))
    cands = selection.selection_turbo(nl0, k, draws=draws)
    ids = torch.cat([cands.new_idx, cands.old_idx], 1)
    src = int(torch.bincount(ids[ids >= 0].long()).max())
    out, lists = {"join_src": src}, {}
    for backend in ("auto", "plain", "ref"):
        cfg = DescentConfig(k=k, rho=1.0, join_src=src, backend=backend)
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lists[backend], upd, ev = nn_descent.nn_descent_iteration(
            xp, x2, nl0, cfg, draws=draws)
        torch.cuda.synchronize()
        out[backend] = {"seconds": time.perf_counter() - t0, "updates": upd,
                        "evals": ev, "launches": {
                            k: v for k, v in _lib.LAUNCHES.items() if v}}
    require_launched("build_check ref_iteration",
                     {**dict.fromkeys(_lib.KERNELS, 0),
                      **out["auto"]["launches"]},
                     ("knn_join_dists", "knn_join_select", "knn_merge"))
    if out["ref"]["launches"] or out["plain"]["launches"]:
        raise AssertionError(f"the ref / plain iteration launched: {out}")
    for backend in ("auto", "plain"):
        c = compare_lists(lists[backend], lists["ref"], x2)
        out[f"{backend}_vs_ref"] = c
        if out[backend]["evals"] != out["ref"]["evals"] or abs(
                out[backend]["updates"] - out["ref"]["updates"]) \
                > c["cut_tie_mismatches"]:
            raise AssertionError(f"ref iteration: updates / evals: {out}")
    return out


def same_store(got, want, what: str) -> None:
    """Two stores bit for bit: every array (floats by their bits), the
    router's stale count, n, d, the config and the mips bound."""
    import torch

    def bits(t):
        if t.dtype == torch.float32:
            return t.view(torch.int32)
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def arrays(s):
        out = {"x": s.x, "x2": s.x2, "alive": s.alive,
               **dict(zip(("nl_dist", "nl_idx", "nl_new"), s.nl))}
        if s.qs is not None:
            out.update(zip(("qs_data", "qs_scale", "qs_x2"), s.qs))
        r = s.router
        if r is not None:
            out.update(centroids=r.centroids, c2=r.c2, graph=r.graph,
                       assign=r.assign, counts=r.counts,
                       **dict(zip(("m_dist", "m_idx", "m_new"), r.members)))
        return out
    a, b = arrays(got), arrays(want)
    diff = [k for k in b if k not in a or a[k].dtype != b[k].dtype
            or not torch.equal(bits(a[k]), bits(b[k]))]
    if (got.router is None) != (want.router is None) or (
            want.router is not None and got.router.stale != want.router.stale):
        diff.append("router")
    if (got.n, got.d, got.cfg, got.mips_m) != (want.n, want.d, want.cfg,
                                              want.mips_m):
        diff.append("n, d, cfg or mips_m")
    if diff:
        raise AssertionError(f"{what}: the stores differ in {diff}")


def same_answers(got, want, what: str) -> None:
    """Two searches' (dist, idx): ids equal, distances bit-equal."""
    import torch
    (gd, gi), (wd, wi) = got, want
    if not (torch.equal(gi.to(wi.device), wi) and torch.equal(
            gd.to(wd.device).view(torch.int32), wd.view(torch.int32))):
        raise AssertionError(f"{what}: the answers differ")


def snapshot_dir():
    """A fresh directory for snapshots under the checkout's git-ignored
    build/ (removed by the caller)."""
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix="chip_smoke_snapshots_",
                                 dir=ROOT / "build"))


def persist_check(store, queries, rows, build_s: float) -> dict:
    """The online path's final store snapshotted and restored on the card:
    restored in this process and in a fresh Python process (this script,
    ``--restore-child``), each answering the path's queries with the live
    store's ids and bit-equal distances; an insert of ``rows`` with the
    same draws into the live and the restored store giving the same lists;
    then an async snapshot with an insert on this thread during the write,
    restored as the store before the insert."""
    import shutil

    import numpy as np
    import torch
    from repro_torch import knn_insert
    from repro_torch.core.persist import (SnapshotWriter, restore_store,
                                          snapshot_store)
    dev = store.x.device
    tmp = snapshot_dir()
    try:
        want = store.search(queries, k_out=10)
        step_dir, write_s = timed(lambda: snapshot_store(
            store, str(tmp / "sync"), store.n))
        nbytes = sum(f.stat().st_size for f in Path(step_dir).iterdir())
        r, restore_s = timed(lambda: restore_store(str(tmp / "sync"),
                                                   device="cuda"))
        same_store(r.store, store, "persist: restore in this process")
        same_answers(r.store.search(queries, k_out=10), want,
                     "persist: restored search")
        # a fresh process: the same restore and search, its answers on disk
        np.save(tmp / "queries.npy", queries.cpu().numpy())
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--restore-child",
             str(tmp / "sync"), str(tmp)], capture_output=True, text=True,
            timeout=600, cwd=ROOT)
        fresh_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"persist: the fresh process failed: "
                                 f"{proc.stderr[-3000:]}")
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        same_answers((torch.from_numpy(np.load(tmp / "child_dist.npy")),
                      torch.from_numpy(np.load(tmp / "child_idx.npy"))),
                     want, "persist: the fresh process's search")
        # the same insert into the live and the restored store
        outs = [knn_insert(s, rows, generator=torch.Generator(
            device=dev).manual_seed(SEED + 20))[0] for s in (store, r.store)]
        same_store(outs[1], outs[0], "persist: insert after restore")
        del outs, r
        # async: the capture is the store at save; an insert on this thread
        # runs while the writer copies and writes
        w = SnapshotWriter(str(tmp / "async"), keep=1)
        _, save_s = timed(lambda: w.save(store, store.n))
        (after, _), insert_s = timed(lambda: knn_insert(
            store, rows, generator=torch.Generator(device=dev).manual_seed(
                SEED + 21)))
        t0 = time.perf_counter()
        w.wait()
        wait_s = time.perf_counter() - t0
        # the sync snapshot, written before any insert, is the yardstick
        same_store(restore_store(str(tmp / "async"), device="cuda").store,
                   restore_store(str(tmp / "sync"), device="cuda").store,
                   "persist: the async snapshot")
        if after.n == store.n:
            raise AssertionError("persist: the insert added no row")
        return {
            "capacity": store.capacity, "allocated": store.n,
            "live": store.live_count(), "dp": int(store.x.shape[1]),
            "snapshot_bytes": nbytes, "write_s": write_s,
            "write_bytes_per_s": nbytes / write_s,
            "restore_s": restore_s, "restore_bytes_per_s": nbytes / restore_s,
            "fresh_process": {**fresh, "wall_s": fresh_wall},
            "online_build_s": build_s,
            "cold_start_over_build": restore_s / build_s,
            "fresh_cold_start_over_build": fresh["restore_s"] / build_s,
            "async": {"save_s": save_s, "insert_during_write_s": insert_s,
                      "wait_after_insert_s": wait_s},
            "disk": str(tmp.parent)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def restore_child(snap: str, out: str) -> int:
    """``--restore-child``: restore the snapshot in this fresh process,
    search the parent's queries, save the answers; print one JSON line."""
    t0 = time.perf_counter()
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.persist import restore_store
    from repro_torch.kernels import _lib
    import_s = time.perf_counter() - t0
    r, restore_s = timed(lambda: restore_store(snap, device="cuda"))
    q = torch.from_numpy(np.load(Path(out) / "queries.npy")).cuda()
    (d, i), search_s = timed(lambda: r.store.search(q, k_out=10))
    np.save(Path(out) / "child_dist.npy", d.cpu().numpy())
    np.save(Path(out) / "child_idx.npy", i.cpu().numpy())
    bad = [m for m in sys.modules if m in ("jax", "ml_dtypes")
           or m.startswith(("jax.", "repro.", "ml_dtypes."))]
    print(json.dumps({"import_s": import_s, "restore_s": restore_s,
                      "first_search_s": search_s,
                      "library_built_here": "seconds" in _lib.build_info,
                      "launches": {k: v for k, v in _lib.LAUNCHES.items()
                                   if v},
                      "imported_jax_repro_or_ml_dtypes": bad}), flush=True)
    return 1 if bad else 0


def quantized_first_check(xc, dev) -> dict:
    """On the check corpus: a routed int8 store of 14400 rows, snapshotted;
    the quantized-first restore answers at once (full rows of live ids
    from the dequantized mirror), and after ``fp32_loader.apply`` it is the
    store and answers bit-equal to it; then a second snapshot torn by a
    fault plan (``persist.torn`` on nl_idx.npy) makes the restore fall back
    to the first and quarantine (rename, not delete) the torn one."""
    import shutil
    import warnings

    import torch
    from repro_torch import (DescentConfig, MutableKNNStore, OnlineConfig,
                             RouterConfig)
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.core.persist import restore_store, snapshot_store
    store, _ = MutableKNNStore.build(
        xc[:CHECK_BASE], 20, cfg=OnlineConfig(precision="int8",
                                              router=RouterConfig()),
        descent=DescentConfig(k=20, rho=1.0, max_iters=15),
        generator=torch.Generator(device=dev).manual_seed(SEED + 9))
    q = noisy_queries(xc, CHECK_QUERIES, SEED + 2)
    want = store.search(q, k_out=10)
    tmp = snapshot_dir()
    try:
        snapshot_store(store, str(tmp), 1)
        qf, first_s = timed(lambda: restore_store(
            str(tmp), quantized_first=True, device="cuda"))
        (qd, qi), first_search_s = timed(lambda: qf.store.search(q,
                                                                 k_out=10))
        check_search(qd, qi, CHECK_BASE, 10)
        if not bool(store.alive[qi.long()].all()):
            raise AssertionError("quantized-first: a dead id returned")
        overlap = float((qi[:, :, None] == want[1][:, None, :]).any(-1)
                        .float().mean())
        done, apply_s = timed(lambda: qf.fp32_loader.apply(qf.store))
        same_store(done, store, "quantized-first after apply")
        same_answers(done.search(q, k_out=10), want,
                     "quantized-first after apply")
        plan = FaultPlan(specs=(FaultSpec(site="persist.torn",
                                          arg="nl_idx.npy"),))
        with plan.active():
            snapshot_store(store, str(tmp), 2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r = restore_store(str(tmp), device="cuda")
        if r.step != 1 or r.fallback_from != (2,) or not (
                tmp / "step_00000002.bad").is_dir() or (
                tmp / "step_00000002").exists():
            raise AssertionError(
                f"torn snapshot: step {r.step}, fallback {r.fallback_from}, "
                f"{sorted(os.listdir(tmp))}")
        same_store(r.store, store, "restore past the torn snapshot")
        return {"rows": CHECK_BASE, "precision": "int8",
                "restore_to_first_answer_s": first_s + first_search_s,
                "quantized_first_restore_s": first_s,
                "quantized_answers_in_exact_top10": overlap,
                "apply_s": apply_s, "torn_fallback_from": list(
                    r.fallback_from), "quarantined": "step_00000002.bad",
                "warnings": [str(w.message)[:160] for w in caught]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def seen_rows(lq: int, lk: int, causal=True, window=None, q_offset=0, **_):
    """(lq,) bool: the query rows that see at least one key, and the number
    of visible (q, k) pairs, from positions alone (the kernel's masks)."""
    import torch
    qpos = torch.arange(lq)[:, None] + q_offset
    kpos = torch.arange(lk)[None, :]
    ok = torch.ones((lq, lk), dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok.any(dim=1), int(ok.sum())


def hold_attention(name, got, want, q, k, kw) -> dict:
    """The kernel's output against the plain version's on the rows that see
    a key (rtol / atol by dtype, ATTN_*_TOL), exactly 0 on the rows that see
    none. Returns the errors and the visible pairs."""
    import torch
    seen, pairs = seen_rows(q.shape[1], k.shape[1], **kw)
    seen = seen.to(got.device)
    if not torch.equal(got[:, ~seen], torch.zeros_like(got[:, ~seen])):
        raise AssertionError(f"{name}: a row that sees no key is not 0")
    rtol, atol = ATTN_F32_TOL if q.dtype == torch.float32 else ATTN_BF16_TOL
    g, w = got[:, seen].float(), want[:, seen].float()
    err = (g - w).abs()
    worst = float((err / (atol + rtol * w.abs())).max()) if err.numel() \
        else 0.0
    if not torch.isfinite(g).all() or worst > 1.0:
        raise AssertionError(f"{name}: error {worst:.3g} x tol")
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "max_err_over_tol": worst, "rtol": rtol, "atol": atol,
            "rows_without_key": int((~seen).sum()), "pairs": pairs}


def attention_check(dev, record: dict) -> dict:
    """ops.attention through the kernels against their plain version on
    the card, in every ATTN_MODES mode at f32 and bf16 (batch 2). The f32
    inputs of ATTN_F32_KERNEL_MODE go to ``record`` (args, kwargs) for
    the kernels line, with the f32 launches."""
    import torch
    from repro_torch.kernels import _lib, ops
    out = {}
    record["f32_launches"] = 0
    for mode, (lq, lk, h, hkv, dq, dv, kw) in ATTN_MODES.items():
        for dt in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(SEED)
            q = torch.randn(2, lq, h, dq, generator=g, device=dev).to(dt)
            k = torch.randn(2, lk, hkv, dq, generator=g, device=dev).to(dt)
            v = torch.randn(2, lk, hkv, dv, generator=g, device=dev).to(dt)
            before = _lib.LAUNCHES["flash_attention"]
            got = ops.attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if _lib.LAUNCHES["flash_attention"] - before != 1:
                raise AssertionError(f"attention_check {mode}: no launch")
            want = ops.attention(q, k, v, backend="ref", **kw)
            key = f"{mode}:{str(dt).split('.')[-1]}"
            res = hold_attention(key, got, want, q, k, kw)
            if dt == torch.float32:
                record["f32_launches"] += 1
                if mode == ATTN_F32_KERNEL_MODE:
                    record["args"], record["kwargs"] = (q, k, v), kw
            out[key] = {k_: res[k_] for k_ in (
                "max_abs_err", "max_err_over_tol", "rows_without_key")}
    return out


def check_attention_kernel(args, kw, reps) -> dict:
    """The kernel against its plain version on one recorded call; times;
    the bound (bytes: q, k, v read once, o written once, over 3.35 TB/s;
    operations: 2 (Dq + Dv) per visible (q, k) pair and head, over the
    peak of the inputs' type); scaled_dot_product_attention on the same
    tensors as the library row, where it computes the same function (a
    causal or full mask from position 0), else flex_attention
    (``flex_attention_call``), with its error against the plain version
    beside."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    q, k, v = args
    got = ops.attention(q, k, v, **kw)
    want = ops.attention(q, k, v, backend="ref", **kw)
    torch.cuda.synchronize()
    entry = {"name": "flash_attention",
             "shape": [list(t.shape) for t in args], "dtype": str(q.dtype),
             "kwargs": kw}
    res = hold_attention("flash_attention", got, want, q, k, kw)
    entry.update(res)
    entry["tolerance"] = f"rtol {res['rtol']}, atol {res['atol']} on rows " \
        "that see a key; 0 on rows that see none"
    b, lq, h, dq = q.shape
    lk, dv = k.shape[1], v.shape[3]
    flops = 2 * (dq + dv) * res["pairs"] * b * h
    nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) \
        * q.element_size()
    peak = PEAK_BF16_PER_S if q.dtype == torch.bfloat16 else PEAK_FP32_PER_S
    entry["ms"] = time_ms(lambda: ops.attention(q, k, v, **kw), reps)
    entry["plain_ms"] = time_ms(
        lambda: ops.attention(q, k, v, backend="ref", **kw),
        max(2, reps // 5))
    plain_mask = kw.get("window") is None and kw.get("softcap") is None \
        and kw.get("q_offset", 0) == 0 and (lq == lk or not
                                            kw.get("causal", True))
    sdpa = None
    if plain_mask:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in args)
        sdpa_kw = dict(is_causal=kw.get("causal", True),
                       scale=kw.get("scale"), enable_gqa=h != k.shape[2])

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        try:
            sdpa()
        except RuntimeError as err:      # no backend takes these widths
            entry["library_refused"] = str(err)[:200]
            sdpa = None
    if sdpa is not None:
        entry["library_ms"] = time_ms(sdpa, reps)
        entry["library_call"] = "F.scaled_dot_product_attention(is_causal, " \
            f"enable_gqa={sdpa_kw['enable_gqa']}) on (B, H, L, D) copies " \
            "of the same tensors"
        entry["library_backend"] = sdpa_backend(qt, kt, vt, **sdpa_kw)
        seen = seen_rows(lq, lk, **kw)[0].to(want.device)
        entry["library_max_abs_err"] = float(
            (sdpa().transpose(1, 2)[:, seen].float()
             - want[:, seen].float()).abs().max())
    else:
        library = flex_attention_call(args, kw)
        lib_out = library().transpose(1, 2)
        entry["library_max_abs_err"] = float(
            (lib_out.float() - want.float()).abs().nan_to_num(0.0).max())
        del lib_out
        entry["library_ms"] = time_ms(library, reps)
        entry["library_call"] = "torch.compile(flex_attention)(score_mod " \
            "softcap * tanh(s / softcap), a causal / window block mask " \
            "built once, scale, enable_gqa=True) on (B, H, L, D) copies of " \
            "the same tensors"
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    entry["bound_ms"] = max(t_bytes, t_ops)
    entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    entry["bytes"] = nbytes
    entry["operations"] = flops
    return entry


def sdpa_backend(q, k, v, **kw) -> str:
    """Which scaled_dot_product_attention backend PyTorch's dispatcher
    picks for these (B, H, L, D) inputs: flash, efficient (the CUTLASS
    memory-efficient kernels), cudnn or math (plain GEMMs and a
    softmax)."""
    import torch
    from torch.nn.attention import SDPBackend
    choice = torch._fused_sdp_choice(q, k, v, **kw)
    return {int(SDPBackend.MATH): "math",
            int(SDPBackend.FLASH_ATTENTION): "flash",
            int(SDPBackend.EFFICIENT_ATTENTION): "efficient",
            int(SDPBackend.CUDNN_ATTENTION): "cudnn"}.get(choice,
                                                          str(choice))


def flex_attention_call(args, kw):
    """One PyTorch call that computes ``ops.attention(*args, **kw)`` where
    scaled_dot_product_attention cannot (a softcap, a window, a query
    offset): flex_attention, compiled as torch documents it, the cap as
    its score_mod, the causal / window mask from positions (q[0] at
    q_offset) as a block mask built here, out of any timed region. Takes
    and gives (B, H, L, D); a library yardstick only, never the port's."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    # inductor's and triton's caches stay inside the checkout
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    q, k, v = (t.transpose(1, 2).contiguous() for t in args)
    causal, window = kw.get("causal", True), kw.get("window")
    cap, off = kw.get("softcap"), kw.get("q_offset", 0)

    def mask_mod(b, h, qi, ki):
        qp = qi + off
        seen = ki >= 0
        if causal:
            seen = seen & (ki <= qp)
        if window is not None:
            seen = seen & (ki > qp - window)
        return seen

    def score_mod(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)

    mask = create_block_mask(mask_mod, None, None, q.shape[2], k.shape[2],
                             device=q.device)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(q, k, v, score_mod=None if cap is None else score_mod,
                      block_mask=mask, scale=kw.get("scale"),
                      enable_gqa=True)


def rel_err(got, want) -> float:
    """max |got - want| over the scale max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def ring_kpos(slots: int, length: int):
    """The kpos tags a cache of ``slots`` slots holds after ``length``
    tokens: position p at slot p % slots, the newest kept, -1 where no
    token landed (a linear cache: 0..length-1, then -1)."""
    import torch
    j = torch.arange(slots)
    pos = length - 1 - (length - 1 - j) % slots
    return torch.where(pos >= 0, pos, -1)


def lm_check(params, cfg, dev, n=LM_CHECK_LEN, seed=SEED + 9,
             max_len=None, patches=None) -> dict:
    """The model's prefill logits of a ragged ``n``-token prompt and 4
    teacher-forced decode steps, through the kernel and through the plain
    chunked attention, held against each other; the kernel run's decode
    steps against a forward over the longer prompt (its logits at the
    last 4 positions only); the kernel run's kpos tags, every attention
    cache's, against ``ring_kpos`` (local rings wrapped, linear caches
    filled to n + 4, then -1); flash_attention launched once per
    attention layer (``attention_layers``: none in mamba2, one per shared
    block invocation in zamba2). Where the model has mamba layers, every
    state of the kernel run's cache is finite after the 4 steps and every
    conv tail equals the decode steps' own last K-1 pre-conv inputs of
    that layer. With ``patches`` (1, P, frontend_dim), a vision model's
    prefill and forward take them ahead of the tokens: the prefill's
    logits and cache hold P + n positions, and the decode steps are held
    against the forward's last 4 positions, offset by P."""
    import numpy as np
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.models import ssm, transformer
    from repro_torch.models.model import embed_inputs, output_logits
    from repro_torch.models.params import tree_paths
    from repro_torch.serve import prefill, serve_step
    t = LM_CHECK_STEPS
    extra = {} if patches is None else {"patches": patches}
    n_pre = 0 if patches is None else patches.shape[1]
    max_len = max_len or n_pre + n + t
    want_launches = transformer.attention_layers(cfg)
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab, size=(1, n + t))).to(dev)
    # each decode step's pre-conv inputs, layer by layer (mamba_decode
    # looks in_proj up at call time)
    pre_conv, proj = [], ssm.in_proj

    def recorded(p, x, c):
        out = proj(p, x, c)
        pre_conv.append(out[1])
        return out
    runs = {}
    for backend in ("auto", "ref"):
        before = _lib.LAUNCHES["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, lengths = prefill(
            params, {"tokens": toks[:, :n], **extra}, cfg, max_len,
            backend=backend)
        steps = []
        ssm.in_proj = recorded if backend == "auto" else proj
        try:
            for i in range(t):
                lg, cache = serve_step(params, cache,
                                       toks[:, n + i:n + i + 1], lengths,
                                       cfg)
                lengths = lengths + 1
                steps.append(lg)
        finally:
            ssm.in_proj = proj
        torch.cuda.synchronize()
        runs[backend] = {
            "prefill": logits, "decode": torch.stack(steps, dim=1),
            "seconds": time.perf_counter() - t0,
            "launches": _lib.LAUNCHES["flash_attention"] - before}
        if backend == "auto":
            leaves = tree_paths(cache)
            kpos = {path: leaf.cpu() for path, leaf in leaves.items()
                    if path.endswith("kpos")}
            states_finite = all(bool(torch.isfinite(leaf).all())
                                for path, leaf in leaves.items()
                                if path.endswith("state"))
            tails = [c["conv"] for _, c, _, kind in transformer.stack_layers(
                params["stack"], cfg, cache) if kind == "mamba"]
        del cache
    x = transformer.run_stack(
        params["stack"], embed_inputs(params, {"tokens": toks, **extra},
                                      cfg), cfg)
    full = output_logits(params, x[:, -t:], cfg)
    del x
    kern, plain = runs["auto"], runs["ref"]
    kpos_ok = {path: bool((tags == ring_kpos(tags.shape[-1],
                                             n_pre + n + t)).all())
               for path, tags in kpos.items()}
    out = {
        "prefill_rel_err": rel_err(kern["prefill"], plain["prefill"]),
        "decode_rel_err": rel_err(kern["decode"], plain["decode"]),
        "decode_vs_forward_rel_err": rel_err(kern["decode"], full),
        "logit_scale": float(plain["prefill"].abs().max()),
        "argmax_agree": float((kern["prefill"].argmax(-1)
                               == plain["prefill"].argmax(-1))
                              .float().mean()),
        "seconds": {"kernel": kern["seconds"], "plain": plain["seconds"]},
        "launches": {"kernel": kern["launches"], "plain": plain["launches"],
                     "attention_layers": want_launches},
        "limits": {"kernel_vs_plain": LM_LIMIT,
                   "decode_vs_forward": LM_DECODE_LIMIT},
        "max_len": max_len,
        "kpos": {path: {"slots": int(tags.shape[-1]), "ok": kpos_ok[path]}
                 for path, tags in kpos.items()},
    }
    ssm_ok = len(pre_conv) == t * len(tails)
    if tails:
        # step i's inputs of layer j are pre_conv[i * layers + j]
        k1 = cfg.ssm_conv_kernel - 1
        conv_equal = all(torch.equal(tail, torch.cat(
            pre_conv[j::len(tails)][t - k1:], dim=1).to(tail.dtype))
            for j, tail in enumerate(tails))
        out["ssm"] = {"mamba_layers": len(tails),
                      "states_finite": states_finite,
                      "conv_tails_equal_last_inputs": conv_equal}
        ssm_ok = ssm_ok and states_finite and conv_equal
    finite = all(torch.isfinite(r[x]).all() for r in runs.values()
                 for x in ("prefill", "decode"))
    if (not finite or not ssm_ok or out["prefill_rel_err"] > LM_LIMIT
            or out["decode_rel_err"] > LM_LIMIT
            or out["decode_vs_forward_rel_err"] > LM_DECODE_LIMIT
            or kern["launches"] != want_launches or plain["launches"] != 0
            or bool(kpos) != (want_launches > 0)
            or not all(kpos_ok.values())
            or tuple(kern["prefill"].shape) != (1, n_pre + n, cfg.vocab)
            or int(lengths[0]) != n_pre + n + t):
        raise AssertionError(f"lm_check ({cfg.arch}) failed: {out}")
    return out


def lm_prompts(cfg, lens=LM_PROMPT_LENS, seed=SEED + 11) -> list:
    """LM_REQUESTS prompts with lengths drawn from the seed in ``lens``
    (inclusive)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = rng.randint(lens[0], lens[1] + 1, size=LM_REQUESTS)
    return [rng.randint(0, cfg.vocab, size=int(n)).astype(np.int32)
            for n in lens]


def check_served(reqs, stats, launches, cfg, tag="lm_serve") -> None:
    from repro_torch.models.transformer import attention_layers
    if not all(r.done and len(r.out) == LM_MAX_NEW for r in reqs):
        raise AssertionError(f"{tag}: a request was not served in full")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.out):
        raise AssertionError(f"{tag}: a token outside the vocabulary")
    want = attention_layers(cfg) * len(reqs)
    if launches["flash_attention"] != want:
        raise AssertionError(f"{tag}: flash_attention launched "
                             f"{launches['flash_attention']} times, not "
                             f"{want} (one per attention layer per "
                             "prefill)")


def served_fields(prompts, stats, wall: float) -> dict:
    """A server run's figures for its phase line: ``serve_requests``'
    stats, with ``wall`` the driven run's wall time."""
    return dict(
        prompt_lens=[len(p) for p in prompts], wall_s=wall,
        prefill_s=stats["prefill_s"],
        prefill_s_mean=statistics.mean(stats["prefill_s"]),
        ttft_s=stats["ttft_s"],
        ttft_s_median=statistics.median(stats["ttft_s"]),
        decode_steps=stats["decode_steps"], decode_s=stats["decode_s"],
        decode_tokens=stats["decode_tokens"],
        decode_tokens_per_s=stats["decode_tokens_per_s"],
        step_ms_mean=1e3 * stats["decode_s"] / stats["decode_steps"],
        tokens=stats["tokens"])


def load_cut(arch: str, n_layers: int | None, dev):
    """A registered config at full width with its depth cut to
    ``n_layers`` (None: full depth), its weights drawn from the seed
    (``load_params``), and the phase fields that say so."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import load_params
    from repro_torch.models import param_count
    full = get_config(arch)
    cfg = full if n_layers is None \
        else dataclasses.replace(full, n_layers=n_layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = load_params(cfg, dev)
    torch.cuda.synchronize()
    return cfg, params, {
        "arch": arch,
        "reduced": "none" if n_layers is None
        else {"n_layers": [full.n_layers, n_layers]},
        "params": param_count(cfg), "init_s": time.perf_counter() - t0}


def dense_family_run(dev):
    """The rest of the dense family at full width, each model loaded
    after the one before is freed: dense_check (starcoder2-3b, then
    codeqwen1.5-7b), then gemma2-27b's gemma2_check and path 15
    (lm_gemma2, driven, then profiled). Returns path 15's launches and
    recorder."""
    import torch
    from repro_torch.launch.serve import serve_requests
    # dense_check: starcoder2-3b (LayerNorm, biases, a 4096 window on every
    # layer) and codeqwen1.5-7b (q/k/v biases, MHA 32/32)
    for arch in DENSE_ARCHS:
        d_cfg, params, fields = load_cut(arch, DENSE_LAYERS, dev)
        emit("dense_check", **fields, prompt=DENSE_CHECK_LEN,
             steps=LM_CHECK_STEPS, **lm_check(
                 params, d_cfg, dev, n=DENSE_CHECK_LEN, seed=SEED + 60))
        del params
        torch.cuda.empty_cache()

    # gemma2-27b, cut to GEMMA_LAYERS (4 local / global pairs)
    g_cfg, params, fields = load_cut(GEMMA_ARCH, GEMMA_LAYERS, dev)
    emit("lm_model", **fields,
         memory_allocated=torch.cuda.memory_allocated(),
         cfg={k: str(v) for k, v in dataclasses.asdict(g_cfg).items()})
    emit("gemma2_check", **fields, prompt=GEMMA_CHECK_LEN,
         steps=LM_CHECK_STEPS, **lm_check(
             params, g_cfg, dev, n=GEMMA_CHECK_LEN, seed=SEED + 61,
             max_len=GEMMA_MAX_LEN))
    g_prompts = lm_prompts(g_cfg, GEMMA_PROMPT_LENS, SEED + 62)
    (reqs, stats), wall, launches, peak, rec = drive(
        "lm_gemma2", lambda: serve_requests(
            params, g_cfg, g_prompts, slots=LM_SLOTS,
            max_len=GEMMA_MAX_LEN, max_new=LM_MAX_NEW))
    check_served(reqs, stats, launches, g_cfg, "lm_gemma2")
    by_kind = {k.rsplit(":", 1)[1]: rec.launched.get(k, 0)
               for k in GEMMA_KEYS}
    if set(by_kind.values()) != {GEMMA_LAYERS // 2 * LM_REQUESTS}:
        raise AssertionError(f"lm_gemma2: flash_attention launches by "
                             f"layer kind {by_kind}")
    emit("lm_gemma2", arch=GEMMA_ARCH, reduced=fields["reduced"],
         slots=LM_SLOTS, max_len=GEMMA_MAX_LEN, requests=LM_REQUESTS,
         max_new=LM_MAX_NEW, window=g_cfg.window,
         **served_fields(g_prompts, stats, wall),
         max_memory_allocated=peak, launches=launches,
         flash_attention_by_kind=by_kind)
    emit("profile", path="lm_gemma2",
         window=f"{LM_SLOTS} requests, {LM_PROFILE_NEW} new tokens",
         **profile_run(lambda: serve_requests(
             params, g_cfg, g_prompts[:LM_SLOTS], slots=LM_SLOTS,
             max_len=GEMMA_MAX_LEN, max_new=LM_PROFILE_NEW)))
    # that window is mostly prefill: the decode steps alone, too
    emit("profile", path="lm_gemma2:decode",
         window=f"{LM_SLOTS} slots at {GEMMA_PROMPT_LENS[0]} tokens, "
                f"{GEMMA_DECODE_PROFILE} decode steps",
         **profile_run(decode_steps(params, g_cfg, dev, SEED + 63,
                                    GEMMA_PROMPT_LENS[0], GEMMA_MAX_LEN)))
    del reqs, stats, params
    torch.cuda.empty_cache()
    return launches, rec


def decode_steps(params, cfg, dev, seed, prompt_len, max_len,
                 steps=GEMMA_DECODE_PROFILE):
    """Prefill LM_SLOTS seeded prompts of ``prompt_len`` tokens in one
    batch (a ``max_len`` cache); return a closure that runs ``steps``
    greedy serve_steps on that cache, the served path's decode steps
    alone."""
    import numpy as np
    import torch
    from repro_torch.serve import prefill, serve_step
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab, size=(LM_SLOTS, prompt_len))).to(dev)
    logits, cache, lengths = prefill(params, {"tokens": toks}, cfg,
                                     max_len, last_only=True)

    def run():
        nonlocal logits, cache, lengths
        for _ in range(steps):
            logits, cache = serve_step(params, cache,
                                       logits.argmax(-1)[:, None], lengths,
                                       cfg)
            lengths = lengths + 1
    return run


def repeat_check(params, cfg, dev, seed, n=LM_CHECK_LEN,
                 patches=None) -> dict:
    """The same prefill of a seeded ``n``-token prompt (behind
    ``patches``, where given) and one decode step on its cache, twice:
    bit-equal logits and cache leaves (the MoE combine adds in a fixed
    order, no atomics). For an MLA model, also the cache's bytes per
    token: the latent and the rope key (without the int32 kpos tags) must
    be n_layers x (kv_lora_rank + qk_rope_dim) x 2 B."""
    import numpy as np
    import torch
    from repro_torch.models.params import tree_paths
    from repro_torch.serve import prefill, serve_step
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab, size=(1, n + 1))).to(dev)
    extra = {} if patches is None else {"patches": patches}
    n_pre = 0 if patches is None else patches.shape[1]
    runs = []
    for _ in range(2):
        logits, cache, lengths = prefill(
            params, {"tokens": toks[:, :n], **extra}, cfg, n_pre + n + 1)
        step, cache = serve_step(params, cache, toks[:, n:], lengths, cfg)
        torch.cuda.synchronize()
        runs.append((logits, step, tree_paths(cache)))
    (l0, s0, c0), (l1, s1, c1) = runs
    out = {"prefill_bit_equal": bool(torch.equal(l0, l1)),
           "step_bit_equal": bool(torch.equal(s0, s1)),
           "cache_bit_equal": all(torch.equal(c0[p], c1[p]) for p in c0)}
    if cfg.use_mla:
        per_tok = sum(leaf.numel() * leaf.element_size()
                      for path, leaf in c0.items()
                      if not path.endswith("kpos")) / (n + 1)
        want = cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
        out["cache_bytes_per_token"] = per_tok
        out["cache_bytes_per_token_want"] = want
        if per_tok != want:
            raise AssertionError(f"repeat_check ({cfg.arch}): the MLA cache "
                                 f"holds {per_tok} B a token, not {want}")
    if not all(v for k, v in out.items() if k.endswith("bit_equal")):
        raise AssertionError(f"repeat_check ({cfg.arch}) failed: {out}")
    return out


def moe_family_run(dev):
    """The MoE family at full width, each model loaded after the one
    before is freed: moe_check (granite-moe-3b-a800m cut to 2 layers,
    then deepseek-v2-lite-16b cut to 8: lm_check through the recorder,
    repeat_check), then path 16 (lm_deepseek: served, profiled, its decode
    steps profiled alone). Returns {tag: launches} and {tag: recorder}
    for moe_check (granite's lm_check) and lm_deepseek."""
    import torch
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import active_param_count
    from repro_torch.models.moe import moe_capacity
    from repro_torch.models.params import tree_leaves
    launches, recs = {}, {}
    # granite-moe-3b: GQA 24/8 at Dh 64, scale 1/128, 40 experts top-8
    # with renormalised gates, the granite multipliers, tied embeddings
    gr_cfg, params, fields = load_cut(MOE_GRANITE, MOE_GRANITE_LAYERS, dev)
    res, _, launches["moe_check"], _, recs["moe_check"] = drive(
        "moe_check", lambda: lm_check(params, gr_cfg, dev, seed=SEED + 70))
    emit("moe_check", **fields, active_params=active_param_count(gr_cfg),
         prompt=LM_CHECK_LEN, steps=LM_CHECK_STEPS, **res,
         repeat=repeat_check(params, gr_cfg, dev, SEED + 71))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # deepseek-v2-lite-16b: MLA (Dq 192, Dv 128), one dense layer, then
    # 64 routed experts top-6 with 2 shared ones
    ds_cfg, params, fields = load_cut(DEEPSEEK_ARCH, DEEPSEEK_LAYERS, dev)
    emit("lm_model", **fields, memory_allocated=torch.cuda.memory_allocated(),
         cfg={k: str(v) for k, v in dataclasses.asdict(ds_cfg).items()})
    emit("moe_check", **fields, active_params=active_param_count(ds_cfg),
         prompt=LM_CHECK_LEN, steps=LM_CHECK_STEPS,
         **lm_check(params, ds_cfg, dev, seed=SEED + 72),
         repeat=repeat_check(params, ds_cfg, dev, SEED + 73))

    # -- lm_deepseek: path 16, the server on that model
    d_prompts = lm_prompts(ds_cfg, LM_PROMPT_LENS, SEED + 74)
    (reqs, stats), wall, launches["lm_deepseek"], peak, \
        recs["lm_deepseek"] = drive("lm_deepseek", lambda: serve_requests(
            params, ds_cfg, d_prompts, slots=LM_SLOTS, max_len=LM_MAX_LEN,
            max_new=LM_MAX_NEW))
    check_served(reqs, stats, launches["lm_deepseek"], ds_cfg, "lm_deepseek")
    # a decode step's least time: every weight read once (the dense-form
    # MoE runs every expert at C = T = slots <= 128) and the latent cache
    # read once, over the card's memory rate
    n_moe = ds_cfg.n_layers - ds_cfg.first_k_dense
    expert_bytes = n_moe * ds_cfg.n_experts * 3 * ds_cfg.d_model \
        * ds_cfg.moe_d_ff * 2
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    step_bytes = param_bytes + ds_cfg.n_layers * LM_SLOTS \
        * LM_MAX_LEN * (ds_cfg.kv_lora_rank + ds_cfg.qk_rope_dim) * 2
    emit("lm_deepseek", arch=DEEPSEEK_ARCH, reduced=fields["reduced"],
         slots=LM_SLOTS, max_len=LM_MAX_LEN, requests=LM_REQUESTS,
         max_new=LM_MAX_NEW, **served_fields(d_prompts, stats, wall),
         max_memory_allocated=peak, launches=launches["lm_deepseek"],
         decode_capacity=moe_capacity(ds_cfg, LM_SLOTS),
         expert_bytes_per_step=expert_bytes, param_bytes=param_bytes,
         step_bytes=step_bytes,
         step_bound_ms=step_bytes / PEAK_BYTES_PER_S * 1e3)
    emit("profile", path="lm_deepseek",
         window=f"{LM_SLOTS} requests, {LM_PROFILE_NEW} new tokens",
         **profile_run(lambda: serve_requests(
             params, ds_cfg, d_prompts[:LM_SLOTS], slots=LM_SLOTS,
             max_len=LM_MAX_LEN, max_new=LM_PROFILE_NEW)))
    emit("profile", path="lm_deepseek:decode",
         window=f"{LM_SLOTS} slots at {LM_PROMPT_LENS[0]} tokens, "
                f"{GEMMA_DECODE_PROFILE} decode steps",
         **profile_run(decode_steps(params, ds_cfg, dev, SEED + 75,
                                    LM_PROMPT_LENS[0], LM_MAX_LEN)))
    del reqs, stats, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, recs


def step_bytes(params, cfg, max_len=LM_MAX_LEN) -> dict:
    """A decode step's least bytes over the card's memory rate: every
    weight (matrices in bf16, vectors in f32) and the whole cache of
    LM_SLOTS slots at ``max_len`` read once: the mamba layers' f32 states
    and conv tails, and the attention caches."""
    from repro_torch.models.params import bytes_params, tree_leaves, \
        tree_paths
    from repro_torch.serve import cache_schema
    p_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    cache = tree_paths(cache_schema(cfg, LM_SLOTS, max_len))
    ssm_bytes = bytes_params({p: d for p, d in cache.items()
                              if p.endswith(("conv", "state"))})
    c_bytes = bytes_params(cache)
    return {"param_bytes": p_bytes, "ssm_cache_bytes": ssm_bytes,
            "attention_cache_bytes": c_bytes - ssm_bytes,
            "step_bytes": p_bytes + c_bytes,
            "step_bound_ms": (p_bytes + c_bytes) / PEAK_BYTES_PER_S * 1e3}


def ssm_family_run(dev):
    """The SSM / hybrid family at full width and full depth, each model
    loaded after the one before is freed: ssm_check (mamba2-130m: lm_check,
    repeat_check, its cache's bytes a slot at two lengths, and the server
    at lm_serve's shape; zamba2-1.2b: lm_check, repeat_check), then path
    17 (lm_zamba2: served, profiled with the SSD scan under a range, its
    decode steps profiled alone). Returns path 17's launches and
    recorder."""
    import torch
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import ssm
    from repro_torch.models.params import bytes_params
    from repro_torch.serve import cache_schema
    # mamba2-130m: 24 Mamba-2 layers, attention-free
    m_cfg, params, fields = load_cut(MAMBA_ARCH, None, dev)
    emit("lm_model", **fields, memory_allocated=torch.cuda.memory_allocated(),
         cfg={k: str(v) for k, v in dataclasses.asdict(m_cfg).items()})
    slot_bytes = {n: bytes_params(cache_schema(m_cfg, 1, n))
                  for n in (LM_CHECK_LEN, LM_MAX_LEN)}
    if len(set(slot_bytes.values())) != 1:
        raise AssertionError(f"ssm_check: mamba2's cache grows with the "
                             f"sequence: {slot_bytes}")
    emit("ssm_check", **fields, prompt=LM_CHECK_LEN, steps=LM_CHECK_STEPS,
         **lm_check(params, m_cfg, dev, seed=SEED + 80),
         repeat=repeat_check(params, m_cfg, dev, SEED + 81),
         cache_bytes_per_slot=slot_bytes)
    m_prompts = lm_prompts(m_cfg, LM_PROMPT_LENS, SEED + 82)
    (reqs, stats), wall, m_launches, peak, _ = drive(
        "ssm_check", lambda: serve_requests(
            params, m_cfg, m_prompts, slots=LM_SLOTS, max_len=LM_MAX_LEN,
            max_new=LM_MAX_NEW))
    check_served(reqs, stats, m_launches, m_cfg, "ssm_check")
    emit("ssm_check", lane="serve", arch=MAMBA_ARCH, reduced="none",
         slots=LM_SLOTS, max_len=LM_MAX_LEN, requests=LM_REQUESTS,
         max_new=LM_MAX_NEW, **served_fields(m_prompts, stats, wall),
         max_memory_allocated=peak, launches=m_launches,
         **step_bytes(params, m_cfg))
    del reqs, stats, params
    gc.collect()
    torch.cuda.empty_cache()

    # zamba2-1.2b: 6 segments of 6 mamba layers, each followed by the
    # shared attention + GLU block (MHA 32/32, Dh 64), then 2 mamba layers
    z_cfg, params, fields = load_cut(ZAMBA_ARCH, None, dev)
    emit("lm_model", **fields, memory_allocated=torch.cuda.memory_allocated(),
         cfg={k: str(v) for k, v in dataclasses.asdict(z_cfg).items()})
    emit("ssm_check", **fields, prompt=LM_CHECK_LEN, steps=LM_CHECK_STEPS,
         **lm_check(params, z_cfg, dev, seed=SEED + 83),
         repeat=repeat_check(params, z_cfg, dev, SEED + 84))

    # -- lm_zamba2: path 17, the server on that model
    z_prompts = lm_prompts(z_cfg, LM_PROMPT_LENS, SEED + 85)
    (reqs, stats), wall, launches, peak, rec = drive(
        "lm_zamba2", lambda: serve_requests(
            params, z_cfg, z_prompts, slots=LM_SLOTS, max_len=LM_MAX_LEN,
            max_new=LM_MAX_NEW))
    check_served(reqs, stats, launches, z_cfg, "lm_zamba2")
    emit("lm_zamba2", arch=ZAMBA_ARCH, reduced="none", slots=LM_SLOTS,
         max_len=LM_MAX_LEN, requests=LM_REQUESTS, max_new=LM_MAX_NEW,
         **served_fields(z_prompts, stats, wall),
         max_memory_allocated=peak, launches=launches,
         **step_bytes(params, z_cfg))
    with ranged(ssm, SSD_RANGE):
        emit("profile", path="lm_zamba2",
             window=f"{ZAMBA_PROFILE_REQUESTS} requests, "
                    f"{ZAMBA_PROFILE_NEW} new tokens",
             **profile_run(lambda: serve_requests(
                 params, z_cfg, z_prompts[:ZAMBA_PROFILE_REQUESTS],
                 slots=LM_SLOTS, max_len=LM_MAX_LEN,
                 max_new=ZAMBA_PROFILE_NEW), ranges=(SSD_RANGE,)))
    prof = profile_run(decode_steps(params, z_cfg, dev, SEED + 86,
                                    LM_PROMPT_LENS[0], LM_MAX_LEN,
                                    ZAMBA_DECODE_PROFILE))
    emit("profile", path="lm_zamba2:decode",
         window=f"{LM_SLOTS} slots at {LM_PROMPT_LENS[0]} tokens, "
                f"{ZAMBA_DECODE_PROFILE} decode steps",
         launches_per_step=prof["device_kernel_calls"] / ZAMBA_DECODE_PROFILE,
         **prof)
    del reqs, stats, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def seeded_inputs(cfg, shape, seed: int, dev):
    """Seeded N(0, 1) frames or patches, ``shape`` + (frontend_dim,), f32,
    drawn on the card (the reference's front ends are stubs that take
    precomputed embeddings; no checkpoint is in the repository)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, cfg.frontend_dim, generator=g, device=dev)


def clip_lengths(seed: int = SEED + 90) -> list:
    """AUDIO_CLIPS clip lengths in frames, drawn from the seed in
    AUDIO_FRAMES (inclusive), the longest first: the recorder keeps the
    second attention call, layer 1 of the first clip (row 11h)."""
    import numpy as np
    lens = np.random.RandomState(seed).randint(
        AUDIO_FRAMES[0], AUDIO_FRAMES[1] + 1, size=AUDIO_CLIPS)
    return sorted((int(n) for n in lens), reverse=True)


def forward_bound(params, cfg, b: int, t: int) -> dict:
    """The least time of an encoder forward over ``b`` clips of ``t``
    frames, the larger of: its operations over the bf16 peak (2 a weight
    of every product matrix and frame: the front end, q / k / v / o, the
    MLP and the head; the token table is never read; and 2 (Dq + Dv) a
    (q, k) pair and head, every pair seen: bidirectional), and its bytes
    (every weight read once but the token table, the f32 frames read and
    the f32 logits written once) over the memory rate."""
    from repro_torch.models.params import tree_paths
    leaves = tree_paths(params)
    mat = sum(leaf.numel() for path, leaf in leaves.items()
              if path.split("/")[-1] in ("w", "wq", "wk", "wv", "wo"))
    attn = 2 * 2 * cfg.d_head * t * t * cfg.n_heads * cfg.n_layers
    flops = b * (2 * t * mat + attn)
    nbytes = sum(leaf.numel() * leaf.element_size()
                 for path, leaf in leaves.items() if path != "embed/table") \
        + b * t * 4 * (cfg.frontend_dim + cfg.vocab)
    t_ops = flops / PEAK_BF16_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"operations": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def encoder_check(params, cfg, dev, t=AUDIO_CHECK_FRAMES,
                  seed=SEED + 91) -> dict:
    """hubert's forward over one seeded clip of ``t`` frames through the
    kernel and through the plain chunked attention (``backend="ref"``),
    within LM_LIMIT of the logit scale of each other; flash_attention
    launched once a layer by the kernel run, never by the plain one; the
    kernel run again, bit-equal; bidirectional: the last frame replaced by
    a fresh draw changes the first position's logits, while the same
    weights run as a causal stack (``encoder_only`` off, the kernel's
    causal mask) keep them bit for bit."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.models import forward
    frames = seeded_inputs(cfg, (1, t), seed, dev)
    other = frames.clone()
    other[:, -1] = seeded_inputs(cfg, (1, 1), seed + 1, dev)[:, 0]
    causal = dataclasses.replace(cfg, encoder_only=False)
    runs = {}
    for lane, c, backend, x in (
            ("kernel", cfg, "auto", frames), ("plain", cfg, "ref", frames),
            ("repeat", cfg, "auto", frames),
            ("last_frame_changed", cfg, "auto", other),
            ("causal", causal, "auto", frames),
            ("causal_last_frame_changed", causal, "auto", other)):
        before = _lib.LAUNCHES["flash_attention"]
        logits, sec = timed(lambda: forward(params, {"frames": x}, c,
                                            backend=backend))
        runs[lane] = {"logits": logits, "seconds": sec,
                      "launches": _lib.LAUNCHES["flash_attention"] - before}
    kern, plain = runs["kernel"]["logits"], runs["plain"]["logits"]
    scale = float(plain.abs().max())

    def first_change(a, b):
        return float((runs[a]["logits"][:, 0]
                      - runs[b]["logits"][:, 0]).abs().max()) / scale
    out = {
        "rel_err": rel_err(kern, plain), "logit_scale": scale,
        "argmax_agree": float((kern.argmax(-1) == plain.argmax(-1))
                              .float().mean()),
        "repeat_bit_equal": bool(torch.equal(kern,
                                             runs["repeat"]["logits"])),
        "first_position_change": first_change("last_frame_changed",
                                              "kernel"),
        "causal_first_position_change": first_change(
            "causal_last_frame_changed", "causal"),
        "seconds": {k: v["seconds"] for k, v in runs.items()},
        "launches": {k: v["launches"] for k, v in runs.items()},
        "limit": LM_LIMIT}
    if (not torch.isfinite(kern).all() or out["rel_err"] > LM_LIMIT
            or tuple(kern.shape) != (1, t, cfg.vocab)
            or not out["repeat_bit_equal"]
            or not out["first_position_change"] > 0
            or out["causal_first_position_change"] != 0
            or runs["plain"]["launches"] != 0
            or any(v["launches"] != cfg.n_layers
                   for k, v in runs.items() if k != "plain")):
        raise AssertionError(f"frontend_check ({cfg.arch}) failed: {out}")
    return out


def audio_encode_run(params, cfg, clips, batch) -> dict:
    """Path 18's traffic: each clip of ``clips`` (1, T, frontend_dim) its
    own forward, then ``batch`` (AUDIO_BATCH, T, frontend_dim) in one;
    each forward's seconds (host clock ended by a synchronize), and
    whether every output is finite logits of its shape."""
    import torch
    from repro_torch.models import forward
    clip_s, ok = [], True
    for x in clips + [batch]:
        logits, sec = timed(lambda: forward(params, {"frames": x}, cfg))
        clip_s.append(sec)
        ok = ok and bool(torch.isfinite(logits).all()) and tuple(
            logits.shape) == (*x.shape[:2], cfg.vocab)
    return {"clip_s": clip_s[:-1], "batch_s": clip_s[-1], "ok": ok}


def vlm_serve(params, cfg, prompts, patches, *, max_new=LM_MAX_NEW,
              max_len=VLM_MAX_LEN) -> tuple:
    """serve_requests' run with a prefill of this script's own: a
    ContinuousBatcher of LM_SLOTS slots over a ``max_len`` cache whose
    prefill_fn prefills a request's tokens behind that request's
    ``patches`` (n_patches, frontend_dim) and returns the length counting
    them (the batcher's contract: last logits, one cache, length); decode
    runs on tokens. The batcher admits in submission order (nothing is
    shed), so the i-th prefill is the i-th prompt, which is checked.
    Returns (requests, stats): serve_requests' stats, and each prefill's
    ``lengths`` as prefill returned them."""
    import numpy as np
    import torch
    from repro_torch.serve import (ContinuousBatcher, Request, init_cache,
                                   prefill, serve_step, write_slot)
    dev = params["embed"]["table"].device
    prefill_s, first_at, step_s, lengths = [], [], [], []
    order = iter(range(len(prompts)))

    def prefill_fn(prompt):
        i = next(order)
        if not np.array_equal(prompt[0], prompts[i]):
            raise AssertionError("lm_vlm: a prefill out of submission order")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, one, n = prefill(
            params, {"tokens": torch.from_numpy(prompt).to(dev),
                     "patches": patches[i][None]}, cfg, max_len,
            last_only=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prefill_s.append(t1 - t0)
        first_at.append(t1)
        lengths.append(n)
        return logits, one, prompt.shape[1] + patches[i].shape[0]

    def step_fn(cache, tokens, lengths_):
        t0 = time.perf_counter()
        logits, cache = serve_step(params, cache, tokens.to(dev),
                                   lengths_.to(dev), cfg)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return logits, cache

    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new=max_new)
            for i, p in enumerate(prompts)]
    bat = ContinuousBatcher(LM_SLOTS, step_fn, prefill_fn, write_slot)
    for r in reqs:
        bat.submit(r)
    cache = init_cache(cfg, LM_SLOTS, max_len, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bat.run(cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_tokens = sum(len(r.out) - 1 for r in reqs)
    decode_s = sum(step_s)
    return reqs, {
        "requests": len(reqs), "tokens": sum(len(r.out) for r in reqs),
        "wall_s": wall, "prefill_s": prefill_s,
        "ttft_s": [t - t0 for t in first_at], "decode_steps": bat.steps,
        "decode_s": decode_s, "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / decode_s if decode_s
        else None,
        "lengths": [int(n[0]) for n in lengths]}


def frontend_family_run(dev):
    """The audio and vision front ends at full width, each model loaded
    after the one before is freed: frontend_check (hubert-xlarge, then
    internvl2-1b, each cut to 2 layers), then path 18 (audio_encode:
    hubert-xlarge at full depth, driven, then one clip's forward
    profiled) and path 19 (lm_vlm: internvl2-1b at full depth, served
    with patches, then text-only through serve_requests; a window and its
    decode steps profiled). Returns {tag: launches} and {tag: recorder}
    for paths 18 and 19."""
    import torch
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import forward
    launches, recs = {}, {}
    # frontend_check: hubert's encoder (bidirectional, MHA 16/16 at Dh 80)
    h_cfg, params, fields = load_cut(HUBERT_ARCH, FRONTEND_LAYERS, dev)
    emit("frontend_check", **fields, frames=AUDIO_CHECK_FRAMES,
         **encoder_check(params, h_cfg, dev))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # internvl2's patch prefix (GQA 14/2 at Dh 64, causal over L')
    v_cfg, params, fields = load_cut(VLM_ARCH, FRONTEND_LAYERS, dev)
    patches = seeded_inputs(v_cfg, (1, v_cfg.n_patches), SEED + 93, dev)
    emit("frontend_check", **fields, patches=v_cfg.n_patches,
         prompt=LM_CHECK_LEN, steps=LM_CHECK_STEPS,
         **lm_check(params, v_cfg, dev, seed=SEED + 94, patches=patches),
         repeat=repeat_check(params, v_cfg, dev, SEED + 95,
                             patches=patches))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- audio_encode: path 18, hubert-xlarge at full depth
    h_cfg, params, fields = load_cut(HUBERT_ARCH, None, dev)
    emit("lm_model", **fields, memory_allocated=torch.cuda.memory_allocated(),
         cfg={k: str(v) for k, v in dataclasses.asdict(h_cfg).items()})
    lens = clip_lengths()
    clips = [seeded_inputs(h_cfg, (1, n), SEED + 100 + i, dev)
             for i, n in enumerate(lens)]
    batch = seeded_inputs(h_cfg, (AUDIO_BATCH, AUDIO_BATCH_FRAMES),
                          SEED + 99, dev)
    res, wall, launches["audio_encode"], peak, recs["audio_encode"] = drive(
        "audio_encode", lambda: audio_encode_run(params, h_cfg, clips, batch))
    require_launched("audio_encode", launches["audio_encode"],
                     {"flash_attention"})
    want = h_cfg.n_layers * (AUDIO_CLIPS + 1)
    if not res["ok"] or launches["audio_encode"]["flash_attention"] != want:
        raise AssertionError(f"audio_encode: outputs ok {res['ok']}, "
                             f"flash_attention launched "
                             f"{launches['audio_encode']['flash_attention']}"
                             f" times, not {want}")
    prof = profile_run(lambda: forward(params, {"frames": clips[0]}, h_cfg))
    emit("profile", path="audio_encode",
         window=f"one forward of {lens[0]} frames", **prof)
    clip_bounds = [forward_bound(params, h_cfg, 1, n)["bound_ms"]
                   for n in lens]
    emit("audio_encode", arch=HUBERT_ARCH, reduced="none",
         clip_frames=lens, clip_s=res["clip_s"],
         seconds_per_clip=statistics.mean(res["clip_s"]),
         frames_per_s=sum(lens) / sum(res["clip_s"]),
         clip_bound_ms=clip_bounds,
         clip_s_over_bound=[s * 1e3 / b for s, b in
                            zip(res["clip_s"], clip_bounds)],
         batch=[AUDIO_BATCH, AUDIO_BATCH_FRAMES], batch_s=res["batch_s"],
         batch_frames_per_s=AUDIO_BATCH * AUDIO_BATCH_FRAMES / res["batch_s"],
         batch_bound=forward_bound(params, h_cfg, AUDIO_BATCH,
                                   AUDIO_BATCH_FRAMES),
         forward_bound_t1000=forward_bound(params, h_cfg, 1,
                                           AUDIO_BATCH_FRAMES),
         wall_s=wall, max_memory_allocated=peak,
         launches=launches["audio_encode"],
         launches_per_forward=prof["device_kernel_calls"],
         device_idle_share=prof["device_idle_share"])
    del params, clips, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- lm_vlm: path 19, internvl2-1b at full depth, served with patches
    v_cfg, params, fields = load_cut(VLM_ARCH, None, dev)
    emit("lm_model", **fields, memory_allocated=torch.cuda.memory_allocated(),
         cfg={k: str(v) for k, v in dataclasses.asdict(v_cfg).items()})
    prompts = lm_prompts(v_cfg, VLM_TEXT_LENS, SEED + 96)
    pts = [seeded_inputs(v_cfg, (v_cfg.n_patches,), SEED + 110 + i, dev)
           for i in range(len(prompts))]
    (reqs, stats), wall, launches["lm_vlm"], peak, recs["lm_vlm"] = drive(
        "lm_vlm", lambda: vlm_serve(params, v_cfg, prompts, pts))
    check_served(reqs, stats, launches["lm_vlm"], v_cfg, "lm_vlm")
    want = [v_cfg.n_patches + len(p) for p in prompts]
    if stats["lengths"] != want:
        raise AssertionError(f"lm_vlm: prefill lengths {stats['lengths']}, "
                             f"not {want} (patches + tokens)")
    emit("lm_vlm", arch=VLM_ARCH, reduced="none", slots=LM_SLOTS,
         max_len=VLM_MAX_LEN, requests=LM_REQUESTS, max_new=LM_MAX_NEW,
         patches=v_cfg.n_patches, prefill_lengths=stats["lengths"],
         **served_fields(prompts, stats, wall),
         max_memory_allocated=peak, launches=launches["lm_vlm"],
         **step_bytes(params, v_cfg, VLM_MAX_LEN))
    # text-only requests through the server's own path (no patches)
    t_prompts = lm_prompts(v_cfg, VLM_TEXT_LENS,
                           SEED + 97)[:VLM_TEXT_REQUESTS]
    (treqs, tstats), twall, tlaunches, tpeak, _ = drive(
        "lm_vlm_text", lambda: serve_requests(
            params, v_cfg, t_prompts, slots=LM_SLOTS, max_len=VLM_MAX_LEN,
            max_new=LM_MAX_NEW))
    check_served(treqs, tstats, tlaunches, v_cfg, "lm_vlm text_only")
    emit("lm_vlm", lane="text_only", arch=VLM_ARCH, slots=LM_SLOTS,
         max_len=VLM_MAX_LEN, requests=VLM_TEXT_REQUESTS,
         max_new=LM_MAX_NEW, **served_fields(t_prompts, tstats, twall),
         max_memory_allocated=tpeak, launches=tlaunches)
    emit("profile", path="lm_vlm",
         window=f"{VLM_PROFILE_REQUESTS} requests, {VLM_PROFILE_NEW} new "
                "tokens",
         **profile_run(lambda: vlm_serve(
             params, v_cfg, prompts[:VLM_PROFILE_REQUESTS], pts,
             max_new=VLM_PROFILE_NEW)))
    prof = profile_run(decode_steps(params, v_cfg, dev, SEED + 98,
                                    v_cfg.n_patches + VLM_TEXT_LENS[1],
                                    VLM_MAX_LEN, VLM_DECODE_PROFILE))
    emit("profile", path="lm_vlm:decode",
         window=f"{LM_SLOTS} slots at {v_cfg.n_patches + VLM_TEXT_LENS[1]} "
                f"tokens, {VLM_DECODE_PROFILE} decode steps",
         launches_per_step=prof["device_kernel_calls"] / VLM_DECODE_PROFILE,
         **prof)
    del reqs, stats, treqs, tstats, params, pts
    gc.collect()
    torch.cuda.empty_cache()
    return launches, recs


def doc_heads(span):
    """Documents [start, stop) of the synthetic source (vocabulary
    ``vocab``, seed SEED), each cut to its first TRAIN_DOC_TOKENS tokens;
    a shorter document is repeated from its start to fill them
    (``np.resize``). Runs in a worker process."""
    start, stop, vocab = span
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.data import SyntheticLMSource
    src = SyntheticLMSource(vocab, SEED)
    return np.stack([np.resize(src.doc(i), TRAIN_DOC_TOKENS)
                     for i in range(start, stop)])


def corpus_embeddings(vocab: int):
    """(TRAIN_DOCS, TRAIN_D_PROJ) float32 embeddings of the corpus's
    documents (``mean_pool_embeddings`` of ``doc_heads``) and the seconds
    they took. The documents are drawn by a pool of worker processes
    (one numpy RandomState a document, about 0.4 ms each on one core),
    closed before this returns."""
    import multiprocessing

    import numpy as np
    from repro_torch.data import mean_pool_embeddings
    t0 = time.perf_counter()
    spans = [(s, min(s + 4096, TRAIN_DOCS), vocab)
             for s in range(0, TRAIN_DOCS, 4096)]
    with multiprocessing.get_context("spawn").Pool(
            min(os.cpu_count() or 1, 8)) as pool:
        heads = np.concatenate(pool.map(doc_heads, spans))
    emb = mean_pool_embeddings(heads, d_proj=TRAIN_D_PROJ, vocab=vocab,
                               seed=SEED)
    return emb, time.perf_counter() - t0


def train_params(n_layers: int, dev):
    """TRAIN_ARCH at full width cut to ``n_layers``, its fp32 parameters
    drawn from seed 0 as the train CLI draws them (no bf16 cast: the
    optimizer updates fp32 masters), and the phase fields."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_tree, model_schema, param_count
    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    (params), init_s = timed(lambda: init_tree(
        torch.Generator(device=dev).manual_seed(0), model_schema(cfg)))
    return cfg, params, {
        "arch": TRAIN_ARCH,
        "reduced": {"n_layers": [full.n_layers, n_layers]},
        "params": param_count(cfg), "init_s": init_s}


def train_config(steps: int = TRAIN_STEPS, microbatches: int = TRAIN_MICRO):
    from repro_torch.train import OptimizerConfig, TrainConfig
    return TrainConfig(microbatches=microbatches, opt=OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=steps))


def token_batches(cfg, n: int, seq: int, batch: int, order=None) -> list:
    """The first ``n`` batches of a TokenPipeline over the corpus."""
    from repro_torch.data import DataConfig, TokenPipeline
    it = iter(TokenPipeline(
        DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                   seed=SEED, prefetch=0),
        process_index=0, process_count=1, order=order))
    return [next(it) for _ in range(n)]


def train_flops(cfg, batch: int, seq: int) -> dict:
    """A train step's work, the function's and the plain scan's own.
    Model FLOPs: 6 x tokens x the weights that multiply (every matrix but
    the embedding table, which is gathered). Of them the layers' run
    bf16 on the tensor cores and the head's fp32 (``matmul_f32``, TF32
    off). The attention's: 2 (Dq + Dv) a visible (q, k) pair and head,
    three times (the forward, the backward's two products of each kind),
    over the causal pairs. The bound: the layers' over 989 TFLOP/s plus
    the head's and the attention's over 67. Beside it, what the plain
    step runs on top: its chunked scan visits every (q, kv) block of the
    rectangle (yi-6b sets no triangle schedule and no window) and runs
    each forward twice (once more under the block checkpoints), and each
    CE chunk's head product runs again under its checkpoint."""
    import numpy as np
    from repro_torch.models import model_schema
    from repro_torch.models.params import is_matrix, tree_paths
    assert not cfg.triangle_schedule and cfg.window is None
    mats = {path: int(np.prod(d.shape)) for path, d in
            tree_paths(model_schema(cfg)).items()
            if is_matrix(d) and path != "embed/table"}
    head = mats.pop("lm_head/w")
    tokens = batch * seq
    layers = 6 * tokens * sum(mats.values())
    head_flops = 6 * tokens * head
    pair = 2 * (2 * cfg.d_head) * batch * cfg.n_heads * cfg.n_layers
    attn = 3 * pair * seq * (seq + 1) // 2
    chunked = seq > cfg.loss_chunk and seq % cfg.loss_chunk == 0
    return {"layer_weights": sum(mats.values()), "head_weights": head,
            "model_flops": layers + head_flops,
            "layer_flops_bf16": layers, "head_flops_fp32": head_flops,
            "attention_flops_fp32": attn,
            "plain_scan_attention_flops_fp32": 4 * pair * seq * seq,
            "plain_head_recompute_flops_fp32":
                2 * tokens * head if chunked else 0,
            "bound_s": layers / PEAK_BF16_PER_S
            + (head_flops + attn) / PEAK_FP32_PER_S}


def leaves_of(tree) -> list:
    from repro_torch.train.checkpoint import _leaf_paths
    return [t for _, t in _leaf_paths(tree)]


def same_leaves(got, want) -> bool:
    import torch
    a, b = leaves_of(got), leaves_of(want)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


class poisoned_batches:
    """While open, every batch's embeddings come out NaN (a corrupted
    batch injected into ``models.model.loss_fn``, which looks
    ``embed_inputs`` up at call time)."""

    def __enter__(self):
        from repro_torch.models import model as model_mod
        self.mod, self.fn = model_mod, model_mod.embed_inputs
        model_mod.embed_inputs = lambda *a, **kw: \
            self.fn(*a, **kw) * float("nan")
        return self

    def __exit__(self, *exc):
        self.mod.embed_inputs = self.fn


def train_grad_check(params, cfg) -> dict:
    """One step's loss and gradients on the card against the same step on
    the CPU: 1 x TRAIN_GRAD_SEQ tokens at f32 activations (TF32 off on the
    card), each leaf's max error over its max |grad| on the CPU."""
    import torch
    from repro_torch.models import loss_fn
    from repro_torch.models.params import tree_map, tree_paths
    f32 = dataclasses.replace(cfg, act_dtype=torch.float32)
    (batch,) = token_batches(cfg, 1, TRAIN_GRAD_SEQ, 1)
    got = {}
    for where, p in (("cuda", params),
                     ("cpu", tree_map(lambda t: t.cpu(), params))):
        leaves = list(tree_paths(p).values())
        for t in leaves:
            t.requires_grad_(True)
        try:
            t0 = time.perf_counter()
            loss, _ = loss_fn(p, batch, f32)
            grads = torch.autograd.grad(loss, leaves)
            seconds = time.perf_counter() - t0
        finally:
            for t in leaves:
                t.requires_grad_(False)
        got[where] = (float(loss), [g.cpu() for g in grads], seconds)
        del p, leaves, grads
    names = list(tree_paths(params))
    errs = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for n, a, b in zip(names, got["cuda"][1], got["cpu"][1])}
    loss_err = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    out = {"tokens": TRAIN_GRAD_SEQ, "loss": {"cuda": got["cuda"][0],
                                              "cpu": got["cpu"][0]},
           "loss_rel_err": loss_err, "grad_rel_err": errs,
           "worst_grad_rel_err": max(errs.values()),
           "limit": TRAIN_GRAD_LIMIT,
           "seconds": {"cuda": got["cuda"][2], "cpu": got["cpu"][2]}}
    if loss_err > TRAIN_GRAD_LIMIT or out["worst_grad_rel_err"] > \
            TRAIN_GRAD_LIMIT:
        raise AssertionError(f"train_check grads: {out}")
    return out


def train_order_check(emb, dev) -> dict:
    """semantic_order's build and reorder over the first TRAIN_ORDER_DOCS
    documents through the kernels and through their plain versions on
    the same draws, one build each: the permutations, equal or not
    (NN-Descent is chaotic: a near-tie that two orders of summation break
    apart in one iteration changes the candidates of the next, so whole
    builds part in a few percent of their slots); the two graphs' slot
    agreement and recall against an exact k-NN, within 0.01 of each
    other (build_check's bar); and one sampled iteration of the same
    build from the same init and draws both ways, the lists held as
    ``compare_lists`` holds them (ids exact but where entries of equal
    distance are ordered differently)."""
    import torch
    from repro_torch import recall_at_k
    from repro_torch.core import heap, nn_descent, selection
    from repro_torch.core.layout import pad_features
    from repro_torch.core.nn_descent import BuildDraws, DescentConfig
    from repro_torch.data.ordering import order_from_graph
    from repro_torch.kernels import _lib
    x = emb[:TRAIN_ORDER_DOCS].to(dev)
    n, k = x.shape[0], TRAIN_K
    g = torch.Generator(device=dev).manual_seed(SEED + 120)
    draws = BuildDraws(
        torch.randint(0, n, (n, k), generator=g, device=dev,
                      dtype=torch.int32),
        [tuple(torch.rand(2 * n * k, generator=g, device=dev)
               for _ in range(3)) for _ in range(8)])
    truth = exact_knn(x, k)
    out, orders, graphs = {"docs": n, "k": k}, {}, {}
    for backend in ("auto", "plain"):
        # semantic_order's build and its reorder, split to keep the graph
        cfg = DescentConfig(k=k, rho=1.0, max_iters=8, reorder=False,
                            backend=backend)
        _lib.reset_launches()
        (dist, graphs[backend], st), sec = timed(
            lambda: nn_descent.build_knn_graph(x, k, cfg=cfg, draws=draws,
                                               device=dev))
        launches = {kk: v for kk, v in _lib.LAUNCHES.items() if v}
        orders[backend], locality = order_from_graph(dist, graphs[backend])
        out[backend] = {"build_s": sec, "build_iters": st.iters,
                        "dist_evals": st.dist_evals, **locality,
                        "launches": launches,
                        "recall": recall_at_k(graphs[backend], truth)}
    require_launched("train_check order",
                     {**dict.fromkeys(_lib.KERNELS, 0),
                      **out["auto"]["launches"]}, TRAIN_KERNELS)
    if out["plain"]["launches"]:
        raise AssertionError(f"the plain semantic_order launched: {out}")
    differ = orders["auto"] != orders["plain"]
    out["order_equal"] = not differ.any()
    out["order_positions_differing"] = int(differ.sum())
    if differ.any():
        out["first_differing_position"] = int(differ.argmax())
    out["graph_slots_equal"] = float(
        (graphs["auto"] == graphs["plain"]).float().mean())
    out["recall_gap"] = abs(out["auto"]["recall"] - out["plain"]["recall"])
    if out["recall_gap"] > 0.01:
        raise AssertionError(f"train_check order: recalls differ: {out}")
    # one iteration from one init and one set of draws, both ways
    xp = pad_features(x).contiguous()
    x2 = (xp * xp).sum(1)
    nl0 = heap.init_random_with_dists(xp, k, idx=draws.init)
    cands = selection.selection_turbo(nl0, k, draws=draws.iters[0])
    ids = torch.cat([cands.new_idx, cands.old_idx], 1)
    src = int(torch.bincount(ids[ids >= 0].long()).max())
    lists = {}
    for backend in ("auto", "plain"):
        cfg = DescentConfig(k=k, rho=1.0, join_src=src, backend=backend)
        lists[backend], upd, ev = nn_descent.nn_descent_iteration(
            xp, x2, nl0, cfg, draws=draws.iters[0])
        out[f"iteration_{backend}"] = {"updates": upd, "evals": ev}
    out["iteration_kernels_vs_plain"] = compare_lists(
        lists["auto"], lists["plain"], x2)
    return out


def train_checkpoint_check(params, cfg, dev) -> dict:
    """The checkpoint, resume, guard and rollback lanes on TRAIN_CKPT_BATCH
    x TRAIN_CKPT_SEQ batches: two steps through TrainLoop with an async
    Checkpointer (every 2), the state at step 2 kept on the card; steps 3-4;
    the step-2 checkpoint loaded bit-equal to the kept state, and steps 3-4
    again from it (losses within TRAIN_RESUME_LIMIT of the first run's,
    bitwise or not); one corrupted batch (its embeddings NaN) skipped with
    params and optimizer state bit-equal; three in a row through TrainLoop
    and FaultPolicy (the first two skipped and counted as steps, as JAX's
    loop counts them) roll back to the step-2 checkpoint, bit-equal. The
    checkpoint directory (under build/) is removed after."""
    import shutil

    import torch
    from repro_torch.models.params import tree_map
    from repro_torch.train import TrainLoop, make_train_step
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.checkpoint import Checkpointer, config_hash
    from repro_torch.train.fault import FaultPolicy
    tc = train_config(steps=8, microbatches=1)
    step_fn = make_train_step(cfg, tc)
    batches = token_batches(cfg, 5, TRAIN_CKPT_SEQ, TRAIN_CKPT_BATCH)
    ck_dir = snapshot_dir()
    out = {"batch": TRAIN_CKPT_BATCH, "seq": TRAIN_CKPT_SEQ}
    try:
        ck = Checkpointer(str(ck_dir), every=2, keep=3, async_write=True,
                          cfg_hash=config_hash(cfg))
        saves = []
        save = ck.save

        def timed_save(*args, **kw):
            t0 = time.perf_counter()
            save(*args, **kw)
            saves.append((t0, time.perf_counter() - t0))
        ck.save = timed_save
        state = opt_mod.init(params)
        params, state, first = TrainLoop(
            cfg, tc, step_fn, checkpointer=ck, log_every=1).run(
                params, state, batches[:2])
        commit = time.perf_counter()     # the loop waits for the write
        kept = tree_map(torch.clone, {"params": params})
        kept["opt_state"] = type(state)(*(tree_map(torch.clone, f)
                                          for f in state))
        step_dir = ck_dir / "step_00000002"
        out["checkpoint"] = {
            "step": ck.latest_step(),
            "bytes": sum(f.stat().st_size for f in step_dir.iterdir()),
            "host_copy_s": saves[0][1], "save_to_commit_s":
                commit - saves[0][0]}
        params, state, run_a = TrainLoop(cfg, tc, step_fn, log_every=1).run(
            params, state, batches[2:4], start_step=2)
        del params, state
        (step, tree), load_s = timed(lambda: ck.load(like=kept))
        out["checkpoint"]["load_s"] = load_s
        if step != 2 or not same_leaves(tree, kept):
            raise AssertionError(f"train_check: the step-{step} checkpoint "
                                 "does not load bit-equal")
        params, state, run_b = TrainLoop(cfg, tc, step_fn, log_every=1).run(
            tree["params"], tree["opt_state"], batches[2:4], start_step=2)
        del tree
        la = [h["loss"] for h in run_a]
        lb = [h["loss"] for h in run_b]
        rel = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
        out["resume"] = {"losses": la, "resumed_losses": lb,
                         "max_rel_err": rel, "bitwise": la == lb,
                         "limit": TRAIN_RESUME_LIMIT,
                         "first_losses": [h["loss"] for h in first]}
        if rel > TRAIN_RESUME_LIMIT:
            raise AssertionError(f"train_check resume: {out['resume']}")
        # one corrupted batch: nothing written
        before = tree_map(torch.clone, {"params": params})
        before["opt_state"] = type(state)(*(tree_map(torch.clone, f)
                                            for f in state))
        with poisoned_batches():
            params, state, m = step_fn(params, state, batches[4])
        out["guard"] = {"skipped": int(m["skipped"]),
                        "loss_finite": bool(torch.isfinite(m["loss"])),
                        "unchanged": same_leaves(
                            {"params": params, "opt_state": state}, before)}
        del before
        if out["guard"]["skipped"] != 1 or not out["guard"]["unchanged"]:
            raise AssertionError(f"train_check guard: {out['guard']}")
        # three in a row: the fault policy rolls back to the checkpoint
        # (the loop saves nothing here: a skipped step still counts, as in
        # JAX's loop, and a save at step 6 would be the rollback's target)
        fault = FaultPolicy(ck, max_consecutive_skips=3)
        with poisoned_batches():
            params, state, hist = TrainLoop(
                cfg, tc, step_fn, fault=fault, log_every=1).run(
                    params, state, batches[:3], start_step=4)
        out["rollback"] = {
            "restarts": fault._restarts, "last_good_step": fault.last_good_step,
            "logged_steps": len(hist), "checkpoints": sorted(
                ck._list_steps()),
            "bit_equal_to_step_2": same_leaves(
                {"params": params, "opt_state": state}, kept)}
        # the two skipped steps before the third are logged, as JAX logs
        # them
        if fault._restarts != 1 or fault.last_good_step != 2 or \
                [h["skipped"] for h in hist] != [1, 1] or \
                not out["rollback"]["bit_equal_to_step_2"]:
            raise AssertionError(f"train_check rollback: {out['rollback']}")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    return out


def attention_grad_check(dev) -> dict:
    """The attention kernels refuse autograd: handed q that requires grad
    under grad mode, the f32 and the bf16 kernel raise (named the plain
    path) and launch nothing; under no_grad the same call launches."""
    import torch
    from repro_torch.kernels import _lib, ops
    out = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 121)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((1, 256, 8, 128), generator=g, device=dev,
                               dtype=dtype) for _ in range(3))
        qg = q.requires_grad_(True)
        _lib.reset_launches()
        try:
            ops.attention(qg, k, v)
            raise AssertionError("the attention kernel ran under autograd")
        except RuntimeError as e:
            msg = str(e)
        raised_launches = _lib.LAUNCHES["flash_attention"]
        with torch.no_grad():
            ops.attention(qg, k, v)
        out[str(dtype).split(".")[1]] = {
            "error": msg, "launches_when_raised": raised_launches,
            "launches_under_no_grad": _lib.LAUNCHES["flash_attention"]}
        if raised_launches or _lib.LAUNCHES["flash_attention"] != 1 or \
                "backend='ref'" not in msg:
            raise AssertionError(f"attention under grad: {out}")
    return out


def sharding_check() -> dict:
    """The sharding rules on make_production_mesh(device="meta"), single
    and multi-pod, for all ten configs at full size: the parameter leaves
    per spec, the largest shard's parameter and AdamW bytes (every shard
    holds one block of each leaf, all of one shape) beside the unsharded
    ones, the cache bytes a shard at decode_32k from cache_shardings, and
    input_specs / skip_reason per (arch, shape). Fails if the card's
    memory moved (nothing is allocated) or a leaf's blocks do not tile
    it."""
    import collections

    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config, input_specs, list_archs
    from repro_torch.launch import make_production_mesh
    from repro_torch.models import model_schema, sharding_tree
    from repro_torch.models.params import tree_leaves
    from repro_torch.serve import cache_schema, cache_shardings

    def shard_bytes(defs, shardings):
        one, full = 0, 0
        for d, sh in zip(defs, shardings):
            block = sh.shard_shape(d.shape)
            parts = int(np.prod(d.shape)) // max(int(np.prod(block)), 1) \
                if d.shape else 1
            blocks = len({tuple((i.start, i.stop) for i in idx)
                          for idx in sh.indices(d.shape)})
            if blocks != parts:
                raise AssertionError(f"sharding_check: {d.shape} {sh.spec}: "
                                     f"{blocks} blocks, {parts} parts")
            one += int(np.prod(block)) * d.dtype.itemsize
            full += int(np.prod(d.shape)) * d.dtype.itemsize
        return one, full

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        archs = {}
        for arch in list_archs():
            cfg = get_config(arch)
            defs = tree_leaves(model_schema(cfg))
            shs = tree_leaves(sharding_tree(model_schema(cfg), mesh))
            p_one, p_full = shard_bytes(defs, shs)
            row = {"leaves": len(defs), "leaves_per_spec": dict(
                collections.Counter(str(tuple(sh.spec)) for sh in shs)),
                "param_bytes_largest_shard": p_one,
                "param_bytes_unsharded": p_full,
                # m and v like their parameter, step replicated (int32)
                "adamw_bytes_largest_shard": 2 * p_one + 4,
                "adamw_bytes_unsharded": 2 * p_full + 4,
                "param_share_a_shard": p_one / p_full}
            dec = SHAPES["decode_32k"]
            if cfg.supports("decode_32k"):
                c_defs = tree_leaves(cache_schema(cfg, dec.global_batch,
                                                  dec.seq_len))
                c_shs = tree_leaves(cache_shardings(
                    cfg, dec.global_batch, dec.seq_len, mesh))
                c_one, c_full = shard_bytes(c_defs, c_shs)
                row["cache_bytes_a_shard_decode_32k"] = c_one
                row["cache_bytes_unsharded_decode_32k"] = c_full
            row["cells"] = {
                shape: {"skip_reason": cfg.skip_reason(shape),
                        "inputs": {k: [list(t.shape),
                                       str(t.dtype).split(".")[1]]
                                   for k, t in input_specs(cfg,
                                                           shape).items()}}
                for shape in SHAPES}
            archs[arch] = row
        out["multi_pod" if multi else "single_pod"] = {
            "mesh": mesh.shape, "archs": archs}
    out["seconds"] = time.perf_counter() - t0
    out["allocated_bytes"] = torch.cuda.memory_allocated() - before
    if out["allocated_bytes"] or len(out["single_pod"]["archs"]) != 10:
        raise AssertionError(f"sharding_check: {out['allocated_bytes']} "
                             "bytes allocated or archs missing")
    return out


def shard_bytes_share(params, state) -> dict:
    """The largest shard's parameter-plus-moment bytes (its blocks of
    params, m and v) and their share of the unsharded state's."""
    from repro_torch.models.params import tree_leaves
    leaves = [t for tree in (params, state.m, state.v)
              for t in tree_leaves(tree)]
    per_shard = [sum(t.addressable_shards[p].data.nbytes for t in leaves)
                 for p in range(leaves[0].sharding.mesh.size)]
    full = sum(t.shape.numel() * t.dtype.itemsize for t in leaves)
    return {"largest_shard_bytes": max(per_shard),
            "unsharded_state_bytes": full,
            "largest_shard_share": max(per_shard) / full}


def hold_sharded(mu, ms, pu, su, ps, ss) -> dict:
    """One sharded step against the unsharded one: the loss, the grad
    norm, and each parameter and moment leaf gathered (one at a time)
    against its unsharded twin, over the leaf's largest magnitude."""
    import torch
    from repro_torch.models.params import tree_leaves
    lu, ls = float(mu["loss"]), float(ms["loss"])
    gu, gs = float(mu["grad_norm"]), float(ms["grad_norm"])
    worst = {}
    for kind, tu, ts in (("param", pu, ps), ("m", su.m, ss.m),
                         ("v", su.v, ss.v)):
        errs = []
        for a, b in zip(tree_leaves(tu), tree_leaves(ts)):
            full = b.gather()
            errs.append(float((a - full).abs().max()
                              / a.abs().max().clamp_min(1e-30)))
            del full
        worst[kind] = max(errs)
    out = {"loss": [lu, ls], "loss_rel_diff": abs(lu - ls) / abs(lu),
           "grad_norm": [gu, gs], "grad_norm_rel_diff": abs(gu - gs) / abs(gu),
           "max_leaf_rel_diff": worst,
           "bit_equal_loss": lu == ls, "step": int(ss.step.gather()),
           "skipped": [int(mu["skipped"]), int(ms["skipped"])]}
    if out["loss_rel_diff"] > SHARD_LOSS_REL \
            or out["grad_norm_rel_diff"] > SHARD_NORM_REL \
            or max(worst.values()) > SHARD_LEAF_REL \
            or out["step"] != int(su.step) or any(out["skipped"]) \
            or not math.isfinite(ls):
        raise AssertionError(f"sharded step against unsharded: {out}")
    torch.cuda.synchronize()
    return out


def place_state(params, cfg, mesh):
    """``params`` placed by sharding_tree on ``mesh`` (copies) and a fresh
    AdamW state placed like them."""
    from repro_torch.models import device_put, model_schema, sharding_tree
    from repro_torch.models.params import tree_map
    from repro_torch.train import optimizer as opt_mod
    placed = tree_map(device_put, params, sharding_tree(model_schema(cfg),
                                                        mesh))
    return placed, opt_mod.init(placed)


def place_batch(batch, cfg, mesh, dev) -> dict:
    """A batch placed as ``batch_specs`` places train_4k's on ``mesh``."""
    import torch
    from repro_torch.configs import batch_specs
    from repro_torch.models import device_put
    specs = batch_specs(cfg, "train_4k", mesh)
    return {k: device_put(torch.as_tensor(v).to(dev), specs[k])
            for k, v in batch.items()}


def train_sharded_ckpt_check(params, cfg, dev) -> dict:
    """The sharded checkpoint lane at train_check's size: the state placed
    on a SHARD_MESH mesh, one FSDP step on TRAIN_CKPT_BATCH x
    TRAIN_CKPT_SEQ, saved as sharded leaves; a shard lost:
    elastic_mesh(["cuda:0"] * SHARD_LIVE, model_axis=2) gives (3, 1),
    where d_model 4096 does not split and falls back to replicas; loaded
    with shardings= onto it, every gathered leaf bit-equal to the saved
    state's; one step there on a replicated batch (batch_specs: 256 does
    not split by 3) against the unsharded step from the same state, held
    as path 21 holds its steps. The directory (under build/) is removed
    after."""
    import shutil

    import torch
    from repro_torch.launch import make_test_mesh
    from repro_torch.models import NamedSharding, PartitionSpec, model_schema
    from repro_torch.models import sharding_tree
    from repro_torch.models.params import tree_map
    from repro_torch.train import AdamState, elastic_mesh, make_train_step
    from repro_torch.train.checkpoint import Checkpointer, _leaf_paths
    tc = train_config(steps=8, microbatches=1)
    step_fn = make_train_step(cfg, tc)
    b0, b1 = token_batches(cfg, 2, TRAIN_CKPT_SEQ, TRAIN_CKPT_BATCH)
    mesh = make_test_mesh(SHARD_MESH, device=dev)
    placed, state = place_state(params, cfg, mesh)
    placed, state, m0 = step_fn(placed, state,
                                place_batch(b0, cfg, mesh, dev))
    ck_dir = snapshot_dir()
    out = {"mesh": mesh.shape, "batch": TRAIN_CKPT_BATCH,
           "seq": TRAIN_CKPT_SEQ, "first_loss": float(m0["loss"])}
    try:
        ck = Checkpointer(str(ck_dir), async_write=False)
        _, save_s = timed(lambda: ck.save(1, placed, state))
        step_dir = ck_dir / "step_00000001"
        with open(step_dir / "manifest.json") as f:
            kinds = {v["kind"] for v in json.load(f)["index"].values()}
        out["checkpoint"] = {
            "bytes": sum(f.stat().st_size for f in step_dir.iterdir()),
            "kinds": sorted(kinds), "save_s": save_s}
        live = elastic_mesh([dev] * SHARD_LIVE, model_axis=2)
        sh = sharding_tree(model_schema(cfg), live)
        rep = NamedSharding(live, PartitionSpec())
        (step, tree), load_s = timed(lambda: ck.load(
            like=(placed, state), shardings=(sh, AdamState(rep, sh, sh))))
        out["checkpoint"]["load_s"] = load_s
        old = dict(_leaf_paths({"params": placed, "opt_state": state}))
        equal = all(torch.equal(leaf.gather(), old[name].gather())
                    for name, leaf in _leaf_paths(tree))
        out["elastic"] = {
            "mesh": live.shape, "step": step, "bit_equal": equal,
            "embed_spec": str(tuple(
                tree["params"]["embed"]["table"].sharding.spec))}
        if kinds != {"sharded"} or step != 1 or not equal:
            raise AssertionError(f"train_check sharded_ckpt: {out}")
        del placed, state, old
        ps, ss = tree["params"], tree["opt_state"]
        pu = tree_map(lambda t: t.gather(), ps)
        su = AdamState(ss.step.gather(), tree_map(lambda t: t.gather(),
                                                  ss.m),
                       tree_map(lambda t: t.gather(), ss.v))
        batch = place_batch(b1, cfg, live, dev)
        out["elastic"]["batch_spec"] = str(tuple(
            batch["tokens"].sharding.spec))
        if tuple(batch["tokens"].sharding.spec) != (None, None):
            raise AssertionError(f"the {live.shape} batch is not replicated")
        pu, su, mu = step_fn(pu, su, b1)
        ps, ss, ms = step_fn(ps, ss, batch)
        out["elastic"]["step_vs_unsharded"] = hold_sharded(mu, ms, pu, su,
                                                           ps, ss)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    return out


def train_sharded_run(params, cfg, dev) -> dict:
    """Path 21: SHARD_STEPS FSDP steps on a SHARD_MESH mesh of logical
    shards on cuda:0 (parameters and moments placed by sharding_tree,
    batches of SHARD_BATCH x TRAIN_SEQ by batch_specs), each beside the
    unsharded step with SHARD_BATCH microbatches from the same parameters
    on the same batch (``params``, updated in place), and held to it.
    Returns the run's figures, the placed state, the step function and a
    further placed batch (for the profile)."""
    import torch
    from repro_torch.launch import make_test_mesh
    from repro_torch.train import make_train_step
    from repro_torch.train import optimizer as opt_mod
    mesh = make_test_mesh(SHARD_MESH, device=dev)
    placed, ss = place_state(params, cfg, mesh)
    su = opt_mod.init(params)
    step_s = make_train_step(cfg, train_config(microbatches=1))
    step_u = make_train_step(cfg, train_config(microbatches=SHARD_BATCH))
    batches = token_batches(cfg, SHARD_STEPS + 1, TRAIN_SEQ, SHARD_BATCH)
    rows, secs = [], {"sharded": [], "unsharded": []}
    for b in batches[:SHARD_STEPS]:
        pb = place_batch(b, cfg, mesh, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, su, mu = step_u(params, su, b)
        float(mu["loss"])
        t1 = time.perf_counter()
        placed, ss, ms = step_s(placed, ss, pb)
        float(ms["loss"])
        t2 = time.perf_counter()
        secs["unsharded"].append(t1 - t0)
        secs["sharded"].append(t2 - t1)
        rows.append(hold_sharded(mu, ms, params, su, placed, ss))
    return {"mesh": mesh.shape, "steps": rows, "step_s": secs,
            **shard_bytes_share(placed, ss), "placed": placed, "state": ss,
            "step_fn": step_s,
            "next_batch": place_batch(batches[-1], cfg, mesh, dev)}


def train_run(params, cfg, emb, dev) -> dict:
    """Path 20: semantic_order over the corpus on the card, then
    TRAIN_STEPS steps of TrainLoop over a TokenPipeline in that order.
    Returns the run's figures, its final params and state, the step
    function and the next batch (for the profile)."""
    import itertools

    import torch
    from repro_torch.data import DataConfig, TokenPipeline, semantic_order
    from repro_torch.train import TrainLoop, make_train_step
    from repro_torch.train import optimizer as opt_mod
    (order, ostats), order_s = timed(lambda: semantic_order(
        emb, k=TRAIN_K, generator=torch.Generator(device=dev).manual_seed(
            SEED), device=dev))
    tc = train_config()
    step_fn = make_train_step(cfg, tc)
    state = opt_mod.init(params)
    batches = iter(TokenPipeline(
        DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                   vocab=cfg.vocab, seed=SEED),
        process_index=0, process_count=1, order=order))
    marks = []
    t0 = time.perf_counter()
    # the loop logs every step: its float() of the metrics syncs
    params, state, hist = TrainLoop(cfg, tc, step_fn, log_every=1).run(
        params, state, itertools.islice(batches, TRAIN_STEPS),
        callback=lambda m: marks.append(time.perf_counter()))
    return {"order_s": order_s, "order_stats": ostats,
            "order_is_permutation": sorted(order.tolist()) == list(
                range(TRAIN_DOCS)),
            "hist": hist, "step_s": [b - a for a, b in
                                     zip([t0] + marks, marks)],
            "params": params, "state": state, "step_fn": step_fn,
            "next_batch": next(batches)}


def train_family_run(dev):
    """The corpus's embeddings, train_check (TRAIN_ARCH cut to
    TRAIN_CHECK_LAYERS), then path 20 (train: TRAIN_LAYERS, driven, then
    one more step profiled), then path 21 (train_sharded: SHARD_LAYERS
    on SHARD_MESH logical shards, driven, then one more FSDP step
    profiled). Returns path 20's launches and recorder (path 21 launches
    no kernel)."""
    import torch
    from repro_torch.configs import get_config
    emb, emb_s = corpus_embeddings(get_config(TRAIN_ARCH).vocab)
    cfg, params, fields = train_params(TRAIN_CHECK_LAYERS, dev)
    emit("train_check", **fields, lane="grads",
         **train_grad_check(params, cfg))
    emit("train_check", lane="semantic_order",
         **train_order_check(emb, dev))
    emit("train_check", **fields, lane="checkpoint",
         **train_checkpoint_check(params, cfg, dev))
    emit("train_check", lane="attention_under_grad",
         **attention_grad_check(dev))
    emit("train_check", **fields, lane="sharded_ckpt",
         **train_sharded_ckpt_check(params, cfg, dev))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- train: path 20, yi-6b at full width, TRAIN_LAYERS layers
    cfg, params, fields = train_params(TRAIN_LAYERS, dev)
    emit("lm_model", **fields, memory_allocated=torch.cuda.memory_allocated(),
         cfg={k: str(v) for k, v in dataclasses.asdict(cfg).items()})
    res, wall, launches, peak, rec = drive(
        "train", lambda: train_run(params, cfg, emb, dev))
    del params
    require_launched("train", launches, TRAIN_KERNELS)
    hist = res["hist"]
    losses = [h["loss"] for h in hist]
    if launches["flash_attention"] or not res["order_is_permutation"] or \
            len(losses) != TRAIN_STEPS or any(h["skipped"] for h in hist) \
            or not all(map(math.isfinite, losses)) \
            or losses[-1] >= losses[0]:
        raise AssertionError(f"train: launches {launches}, losses {losses}, "
                             f"skipped {[h['skipped'] for h in hist]}")
    prof = profile_run(lambda: res["step_fn"](
        res["params"], res["state"], res["next_batch"]), host_ops=False)
    emit("profile", path="train", window="one train step (step 7)", **prof)
    work = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    s_step = statistics.median(res["step_s"][1:])
    # -- roofline_check: one more step counted on the card and on meta
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in res["next_batch"].items()}
    step_args = (res["params"], res["state"], batch)
    roofline_lane("train step (path 20)",
                  lambda: res["step_fn"](*step_args), s_step,
                  work["model_flops"], (),
                  meta_run=lambda: res["step_fn"](*meta_twin(step_args)),
                  args=step_args, work_bound_s=work["bound_s"],
                  train_flops=work,
                  peak_of_the_timed_steps=peak)
    del batch, step_args
    emit("train", **fields, docs=TRAIN_DOCS, doc_tokens=TRAIN_DOC_TOKENS,
         d_proj=TRAIN_D_PROJ, embed_s=emb_s,
         semantic_order={"k": TRAIN_K, "build_s": res["order_s"],
                         **res["order_stats"]},
         seq=TRAIN_SEQ, batch=TRAIN_BATCH, microbatches=TRAIN_MICRO,
         loss_chunk=cfg.loss_chunk, steps=TRAIN_STEPS, lr=TRAIN_LR,
         loss=losses, grad_norm=[h["grad_norm"] for h in hist],
         step_s=res["step_s"], s_per_step=s_step,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / s_step, **work,
         layer_share_of_989=work["layer_flops_bf16"] / s_step
         / PEAK_BF16_PER_S,
         head_share_of_67=work["head_flops_fp32"] / s_step
         / PEAK_FP32_PER_S,
         attention_share_of_67=work["attention_flops_fp32"] / s_step
         / PEAK_FP32_PER_S,
         step_over_bound=s_step / work["bound_s"], wall_s=wall,
         max_memory_allocated=peak, launches=launches,
         launches_per_step=prof["device_kernel_calls"],
         device_idle_share=prof["device_idle_share"])
    del res
    gc.collect()
    torch.cuda.empty_cache()

    train_sharded_family(dev)
    return launches, rec


def train_sharded_family(dev) -> None:
    """Path 21 (train_sharded): yi-6b at full width, SHARD_LAYERS layers,
    FSDP over SHARD_MESH logical shards on cuda:0, driven, then one more
    FSDP step profiled. It launches no kernel."""
    import torch
    cfg, params, fields = train_params(SHARD_LAYERS, dev)
    res, wall, shard_launches, peak, _ = drive(
        "train_sharded", lambda: train_sharded_run(params, cfg, dev))
    del params
    if any(shard_launches.values()):
        raise AssertionError(f"train_sharded launched {shard_launches}")
    prof = profile_run(lambda: res["step_fn"](
        res["placed"], res["state"], res["next_batch"]), host_ops=False)
    emit("profile", path="train_sharded",
         window=f"one FSDP step (step {SHARD_STEPS + 1})", **prof)
    s_step = {k: statistics.median(v[1:]) for k, v in res["step_s"].items()}
    tokens = SHARD_BATCH * TRAIN_SEQ
    emit("train_sharded", **fields, mesh=res["mesh"],
         logical_shards_on=str(dev), seq=TRAIN_SEQ, batch=SHARD_BATCH,
         unsharded_microbatches=SHARD_BATCH, steps=res["steps"],
         step_s=res["step_s"], s_per_step=s_step,
         tokens_per_s={k: tokens / v for k, v in s_step.items()},
         largest_shard_bytes=res["largest_shard_bytes"],
         unsharded_state_bytes=res["unsharded_state_bytes"],
         largest_shard_share=res["largest_shard_share"],
         limits={"loss_rel": SHARD_LOSS_REL, "grad_norm_rel": SHARD_NORM_REL,
                 "leaf_rel": SHARD_LEAF_REL},
         wall_s=wall, max_memory_allocated=peak, launches=shard_launches,
         launches_per_step=prof["device_kernel_calls"],
         device_idle_share=prof["device_idle_share"])
    del res
    gc.collect()
    torch.cuda.empty_cache()


def knn_lm_run(params, cfg, dev, entry_seed: int):
    """examples/knn_serve.py steps 2-4 at full width (no training): keys
    are the hidden states of KNN_SEQS seeded sequences, the datastore's
    graph is built over them, the 17th sequence's hidden states query it
    through knn_logits, and the result is interpolated with the LM."""
    import numpy as np
    import torch
    from repro_torch.models import embed_inputs, output_logits, run_stack
    from repro_torch.serve import KNNDatastore, interpolate, knn_logits
    toks = torch.from_numpy(np.random.RandomState(SEED + 10).randint(
        0, cfg.vocab, size=(KNN_SEQS + 1, KNN_SEQ_LEN + 1))).to(dev)

    def hidden(batch):
        return run_stack(params["stack"],
                         embed_inputs(params, {"tokens": batch}, cfg), cfg)

    timing = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keys, vals = [], []
    for s in range(0, KNN_SEQS, KNN_BATCH):
        b = toks[s:s + KNN_BATCH, :KNN_SEQ_LEN]
        h = hidden(b)
        keys.append(h[:, :-1].reshape(-1, cfg.d_model).float())
        vals.append(b[:, 1:].reshape(-1))
    keys, vals = torch.cat(keys), torch.cat(vals)
    torch.cuda.synchronize()
    timing["collect_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = KNNDatastore.build(
        keys, vals, k=KNN_K, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    timing["build_s"] = time.perf_counter() - t0
    qseq = toks[KNN_SEQS:]
    h = hidden(qseq)
    q = h[0, :-1].float()
    lm_logits = output_logits(params, h[:, :-1], cfg)[0]
    tgt = qseq[0, 1:].long()
    entry = torch.randperm(keys.shape[0], device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(entry_seed))[:32].int()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    knl = knn_logits(ds, q, cfg.vocab, k=8, entry=entry)
    torch.cuda.synchronize()
    timing["search_s"] = time.perf_counter() - t0
    rows = torch.arange(tgt.shape[0], device=dev)
    ll = {}
    for lam in (0.0, 0.25):
        mixed = interpolate(lm_logits, knl, lam=lam) if lam \
            else torch.log_softmax(lm_logits, dim=-1)
        ll[str(lam)] = float(mixed[rows, tgt].mean())
    return {"ds": ds, "q": q, "entry": entry, "knl": knl, "timing": timing,
            "ll": ll, "keys": int(keys.shape[0])}


def knn_lm_restore(res, vocab: int) -> dict:
    """examples/knn_serve.py step 5: the datastore snapshotted and restored
    on the card (no rebuild); the same queries and entries give bit-equal
    knn_logits."""
    import shutil

    import torch
    from repro_torch.serve import KNNDatastore, knn_logits
    tmp = snapshot_dir()
    try:
        step_dir, write_s = timed(lambda: res["ds"].snapshot(str(tmp)))
        nbytes = sum(f.stat().st_size for f in Path(step_dir).iterdir())
        ds, restore_s = timed(lambda: KNNDatastore.restore(str(tmp),
                                                           device="cuda"))
        got = knn_logits(ds, res["q"], vocab, k=8, entry=res["entry"])
        if not torch.equal(got.view(torch.int32),
                           res["knl"].view(torch.int32)):
            raise AssertionError("knn_lm: the restored datastore's "
                                 "knn_logits differ")
        return {"snapshot_bytes": nbytes, "write_s": write_s,
                "restore_s": restore_s, "build_s": res["timing"]["build_s"],
                "restore_over_build": restore_s / res["timing"]["build_s"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def knn_lm_recall(res) -> dict:
    """Recall@8 of the datastore search (the one knn_logits ran) against
    brute_force_knn, through the kernels and through the plain versions
    with the same graph and entries."""
    from repro_torch import SearchConfig, brute_force_knn, graph_search
    from repro_torch import recall_at_k
    ds, q, entry = res["ds"], res["q"], res["entry"]
    _, truth = brute_force_knn(ds.keys, q, 8, exclude_self=False,
                               chunk=TRUTH_CHUNK)
    out = {}
    for backend in ("auto", "plain"):
        scfg = SearchConfig(beam=32, rounds=24, backend=backend)
        _, idx = graph_search(ds.keys, ds.graph_idx, q, k_out=8, cfg=scfg,
                              entry=entry)
        out[backend] = recall_at_k(idx, truth)
    gap = abs(out["auto"] - out["plain"])
    if gap > 0.01:
        raise AssertionError(f"knn_lm: recall through the kernels and the "
                             f"plain versions differ: {out}")
    return {"recall_at_8": out["auto"], "plain_recall_at_8": out["plain"],
            "recall_gap": gap}


def percentiles(ms) -> dict:
    import numpy as np
    if not ms:
        return {"n": 0}
    return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def retrieval_run(store, queries, qtruth, dead, rows) -> dict:
    """Path 11: the retrieval scheduler in front of the online store's
    search. Lanes: mixed (the interactive lane's seeded bursts, each
    pumped before the next, beside the batch lane at max_batch 512),
    deadline, overload (twice, on a virtual clock under a seeded
    FaultPlan), result cache; then one profiled pass of the batch lane.
    Every dispatch's search tile is observed at its q_block_bucket
    size."""
    import numpy as np
    import torch
    from repro_torch import SearchConfig, knn_insert, recall_at_k
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.core.graph_search import q_block_bucket
    from repro_torch.kernels import ops
    from repro_torch.serve import RetrievalScheduler, SchedulerConfig
    base = SearchConfig(beam=32, rounds=48, expand=6, q_block=512)
    dev = store.x.device
    host = queries.cpu().numpy()
    n_int = RETR_INTERACTIVE
    holder = {"store": store}
    log, blocks = [], []
    tile = ops.knn_search_dists

    def observed(*args, **kw):
        blocks.append(int(args[0].shape[0]))
        return tile(*args, **kw)

    def search_fn(qs, cfg):
        blocks.clear()
        out = holder["store"].search(qs, k_out=10, cfg=cfg)
        log.append((int(qs.shape[0]), cfg, sorted(set(blocks))))
        return out

    def answers(reqs):
        return (torch.from_numpy(np.stack([r.dist for r in reqs])),
                torch.from_numpy(np.stack([r.idx for r in reqs])))

    def served_ok(reqs, what):
        d, i = answers(reqs)
        check_search(d.to(dev), i.to(dev), store.n, 10)
        if not bool(store.alive[i.long().to(dev)].all()) or torch.isin(
                i.long().to(dev), dead.long()).any():
            raise AssertionError(f"retrieval {what}: a tombstoned id")

    out, lane_s = {}, {}
    ops.knn_search_dists = observed
    try:
        t_lane = time.perf_counter()
        # the yardsticks: the direct search of the same queries
        (dd, di), direct_s = timed(lambda: store.search(queries, k_out=10,
                                                        cfg=base))
        _, direct_batch_s = timed(lambda: store.search(
            queries[n_int:], k_out=10, cfg=base))
        direct_recall = recall_at_k(di, qtruth)
        # one uncut dispatch of RETR_DEADLINE queries (the deadline's base)
        s0 = RetrievalScheduler(search_fn, base_cfg=base, cfg=SchedulerConfig(
            max_queue=RETR_DEADLINE, max_batch=RETR_DEADLINE))
        r0 = [s0.submit(host[i], lane="batch") for i in range(RETR_DEADLINE)]
        _, uncut_s = timed(s0.pump)
        uncut_recall = recall_at_k(answers(r0)[1].to(dev),
                                   qtruth[:RETR_DEADLINE])

        # mixed: the batch lane queued, the interactive lane in bursts
        lane_s["direct_and_uncut"] = time.perf_counter() - t_lane
        t_lane = time.perf_counter()
        log.clear()
        s = RetrievalScheduler(search_fn, base_cfg=base, cfg=SchedulerConfig(
            max_queue=N_QUERIES, max_batch=512))
        reqs = [None] * N_QUERIES
        for i in range(n_int, N_QUERIES):
            reqs[i] = s.submit(host[i], lane="batch")
        rng = np.random.RandomState(SEED + 30)
        batch_pumps, lanes = [], []
        i = 0
        while i < n_int:
            b = int(rng.randint(RETR_BURST[0], RETR_BURST[1] + 1))
            for j in range(i, min(i + b, n_int)):
                reqs[j] = s.submit(host[j])
            got = s.pump()
            if [r.qid for r in got] != [reqs[j].qid
                                        for j in range(i, min(i + b, n_int))]:
                raise AssertionError("retrieval: a burst was not served "
                                     "alone and whole")
            lanes.append({r.lane for r in got})
            i += b
            if s.queue.lanes["batch"]:
                got, sec = timed(s.pump)
                batch_pumps.append(sec)
                lanes.append({r.lane for r in got})
        while len(s.queue):
            got, sec = timed(s.pump)
            batch_pumps.append(sec)
            lanes.append({r.lane for r in got})
        st = s.stats()
        if any(len(ln) != 1 for ln in lanes):
            raise AssertionError("retrieval: a dispatch mixed lanes")
        bad = [(nq, seen) for nq, cfg, seen in log
               if cfg.fixed_block or seen != [q_block_bucket(nq, cfg)]]
        if bad:
            raise AssertionError(f"retrieval: dispatches off their "
                                 f"q_block_bucket: {bad[:5]}")
        if st["served"] != N_QUERIES or any(r.idx is None for r in reqs):
            raise AssertionError(f"retrieval: served {st['served']} of "
                                 f"{N_QUERIES}")
        served_ok(reqs, "mixed")
        recall = recall_at_k(answers(reqs)[1].to(dev), qtruth)
        if abs(recall - direct_recall) > 0.01:
            raise AssertionError(f"retrieval: recall {recall} against the "
                                 f"direct search's {direct_recall}")
        n_batch = N_QUERIES - n_int
        out["mixed"] = {
            "interactive": n_int, "batch": n_batch, "dispatches":
                st["dispatches"], "bursts": len(lanes) - len(batch_pumps),
            "dispatch_sizes": sorted({nq for nq, _, _ in log}),
            "latency": {ln: percentiles(v)
                        for ln, v in st["latency_ms"].items()},
            "recall_at_10": recall, "direct_recall_at_10": direct_recall,
            "batch_lane_s": sum(batch_pumps),
            "batch_lane_queries_per_s": n_batch / sum(batch_pumps),
            "direct_batch_s": direct_batch_s,
            "direct_batch_queries_per_s": n_batch / direct_batch_s,
            "scheduler_cost_share": 1.0 - direct_batch_s / sum(batch_pumps),
            "direct_s": direct_s}

        # deadline: half an uncut dispatch's time; the clock stops while
        # the requests are submitted, so the budget is the search's
        lane_s["mixed"] = time.perf_counter() - t_lane
        t_lane = time.perf_counter()
        log.clear()
        paused = [0.0]
        sd = RetrievalScheduler(
            search_fn, base_cfg=base, cfg=SchedulerConfig(
                max_queue=RETR_DEADLINE, max_batch=RETR_DEADLINE),
            clock=lambda: time.monotonic() - paused[0])
        deadline_ms = 0.5e3 * uncut_s
        t0 = time.monotonic()
        rd = [sd.submit(host[i], lane="batch", deadline_ms=deadline_ms)
              for i in range(RETR_DEADLINE)]
        paused[0] += time.monotonic() - t0
        _, cut_s = timed(sd.pump)
        if any(r.rejection is not None or r.idx is None for r in rd):
            raise AssertionError("retrieval deadline: a request was not "
                                 "answered")
        served_ok(rd, "deadline")
        (nq, cfg, _), = log
        if not cfg.max_rounds_deadline > 0.0:
            raise AssertionError("retrieval deadline: no budget reached "
                                 "the search")
        out["deadline"] = {
            "queries": RETR_DEADLINE, "deadline_ms": deadline_ms,
            "max_rounds_deadline_s": cfg.max_rounds_deadline,
            "wall_s": cut_s, "recall_at_10": recall_at_k(
                answers(rd)[1].to(dev), qtruth[:RETR_DEADLINE]),
            "uncut_wall_s": uncut_s, "uncut_recall_at_10": uncut_recall}

        # overload, twice: the same shedding and expiry, nothing silent
        lane_s["deadline"] = time.perf_counter() - t_lane
        t_lane = time.perf_counter()

        def overload():
            clk = [0.0]
            so = RetrievalScheduler(
                search_fn, base_cfg=base, cfg=SchedulerConfig(
                    max_queue=256, shed_policy="drop-oldest-batch"),
                clock=lambda: clk[0])
            plan = FaultPlan(seed=SEED + 31, specs=(
                FaultSpec(site="sched.burst", prob=0.1, arg=8),
                FaultSpec(site="sched.stall", prob=0.05, arg=0.25)))
            rng = np.random.RandomState(SEED + 32)
            subs, done = [], []
            with plan.active():
                for t in range(RETR_OVERLOAD):
                    clk[0] += 1e-3
                    lane = "interactive" if rng.rand() < 0.3 else "batch"
                    subs.append(so.submit(
                        host[rng.randint(N_QUERIES)], lane=lane,
                        deadline_ms=100.0 if lane == "interactive"
                        else 1000.0))
                    if t % RETR_PUMP_EVERY == RETR_PUMP_EVERY - 1:
                        done += so.pump()
                done += so.run_until_drained()
            sto = so.stats()
            injected = 8 * plan.fired("sched.burst")
            served = {r.qid for r in done}
            return {"submitted": len(subs), "injected": injected,
                    "served": sto["served"], "shed": sto["shed"],
                    "expired": sto["expired"],
                    "dispatches": sto["dispatches"],
                    "stalls": plan.fired("sched.stall"),
                    "rejected_qids": sorted(set(range(so._next_qid))
                                            - served),
                    "codes": sorted({r.rejection.code for r in subs
                                     if r.rejection is not None})}, done
        runs = [overload() for _ in range(2)]
        a, b = runs[0][0], runs[1][0]
        for o, _ in runs:
            if o["submitted"] + o["injected"] != o["served"] + o["shed"] \
                    + o["expired"] or len(o["rejected_qids"]) != \
                    o["shed"] + o["expired"]:
                raise AssertionError(f"retrieval overload: requests "
                                     f"unaccounted for: {o}")
        if a != b or not a["shed"] or not a["expired"]:
            raise AssertionError(f"retrieval overload: the runs differ or "
                                 f"nothing was shed / expired: {a} {b}")
        served_ok(runs[0][1], "overload")
        out["overload"] = {k: v for k, v in a.items()
                           if k != "rejected_qids"}
        out["overload"]["rejected"] = len(a["rejected_qids"])
        out["overload"]["runs_equal"] = True

        # result cache: hits at admission, none after a mutation
        lane_s["overload"] = time.perf_counter() - t_lane
        t_lane = time.perf_counter()
        sc = RetrievalScheduler(search_fn, base_cfg=base, cfg=SchedulerConfig(
            max_queue=N_QUERIES, max_batch=512, result_cache=4096))
        first = [sc.submit(host[i]) for i in range(n_int)]
        sc.run_until_drained()
        again = [sc.submit(host[i]) for i in range(n_int)]
        hits = sc.stats()["cache_hits"]
        same = all(r.done and np.array_equal(r.idx, f.idx)
                   and np.array_equal(r.dist.view(np.int32),
                                      f.dist.view(np.int32))
                   for r, f in zip(again, first))
        if hits != n_int or not same or len(sc.queue):
            raise AssertionError(f"retrieval cache: {hits} hits of {n_int}, "
                                 f"bit-equal {same}")
        holder["store"], _ = knn_insert(store, rows, generator=torch.Generator(
            device=dev).manual_seed(SEED + 33))
        sc.invalidate_cache()
        after = [sc.submit(host[i]) for i in range(n_int)]
        if sc.stats()["cache_hits"] != hits or any(r.done for r in after):
            raise AssertionError("retrieval cache: a hit after the insert")
        sc.run_until_drained()
        holder["store"] = store
        out["cache"] = {"entries": n_int, "hits": hits, "bit_equal": same,
                        "hits_after_insert_and_invalidate": 0,
                        "inserted": int(rows.shape[0])}
        lane_s["cache"] = time.perf_counter() - t_lane
    finally:
        ops.knn_search_dists = tile

    # four dispatches of the batch lane: the profile's host processing
    # grows with its events
    def batch_lane():
        sp = RetrievalScheduler(search_fn, base_cfg=base, cfg=SchedulerConfig(
            max_queue=RETR_DEADLINE, max_batch=512))
        for i in range(n_int, n_int + RETR_DEADLINE):
            sp.submit(host[i], lane="batch")
        sp.run_until_drained()
    t_lane = time.perf_counter()
    prof = profile_run(batch_lane)
    lane_s["profile"] = time.perf_counter() - t_lane
    out["profile_batch_lane"] = {"queries": RETR_DEADLINE, **{
        k: prof[k] for k in ("profiled_wall_s", "device_busy_s",
                             "device_idle_share")}}
    out["lane_s"] = lane_s
    return out


def knn_grow_run(params, cfg, dev, res, prompts) -> dict:
    """Path 12: the kNN-LM datastore grown during decode. A
    MutableKNNDatastore over knn_lm's keys, a ContinuousBatcher of
    lm_serve's slots and prompts that captures each step's last hidden
    state (``decode_hidden``, the space of the datastore's keys) and the
    sampled token, inserts them in chunks of KNN_CHUNK with a router,
    writes one periodic async snapshot and a drain snapshot; then a cold
    start from them, the replay of the chunks through the plain versions
    with the same draws, and knn_logits on the drained and the restored
    datastores."""
    import shutil

    import torch
    from repro_torch import recall_at_k
    from repro_torch.core import persist
    from repro_torch.models import output_logits
    from repro_torch.serve import (ContinuousBatcher, MutableKNNDatastore,
                                   Request, init_cache, knn_logits, prefill,
                                   write_slot)
    from repro_torch.serve.decode import decode_hidden
    keys, vals = res["ds"].keys, res["ds"].values
    n0 = int(keys.shape[0])
    chunks, states = [], []

    class Grown(MutableKNNDatastore):
        """Keeps each chunk, its generator's state, its seconds and the
        datastore before and after it."""

        def append(self, k, v, *, generator=None, **kw):
            state = generator.get_state()
            (out, st), sec = timed(lambda: super(Grown, self).append(
                k, v, generator=generator, **kw))
            chunks.append({"keys": k, "values": v, "gen": state, "s": sec})
            states.append((self, out))
            return out, st

    (ds0, build_s) = timed(lambda: MutableKNNDatastore.build(
        keys, vals, k=KNN_K, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 13)))
    tmp = snapshot_dir()
    writes = []
    write_snapshot = persist.write_snapshot

    def timed_write(directory, step, arrays, meta, **kw):
        t0 = time.perf_counter()
        out = write_snapshot(directory, step, arrays, meta, **kw)
        writes.append({"step": step, "t0": t0, "t1": time.perf_counter(),
                       "s": time.perf_counter() - t0,
                       "bytes": sum(f.stat().st_size
                                    for f in Path(out).iterdir())})
        return out

    hidden, step_s, sampled, active = [None], [], [], []
    holder = {}

    def prefill_fn(prompt):
        logits, one, _ = prefill(
            params, {"tokens": torch.from_numpy(prompt).to(dev)}, cfg,
            LM_MAX_LEN, last_only=True)
        return logits, one, prompt.shape[1]

    def step_fn(cache, tokens, lengths):
        active.append([s.active for s in holder["bat"].slots])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, cache = decode_hidden(params, cache, tokens.to(dev),
                                 lengths.to(dev), cfg)
        logits = output_logits(params, x, cfg)[:, 0]
        hidden[0] = x[:, 0].float()
        torch.cuda.synchronize()
        step_s.append((t0, time.perf_counter()))
        return logits, cache

    def sampler(logits):
        t = torch.argmax(logits, -1)
        if logits.dim() == 2:
            sampled.append(t.cpu())
        return t

    def batcher(**kw):
        return ContinuousBatcher(
            LM_SLOTS, step_fn, prefill_fn, write_slot, sampler,
            knn_capture=lambda logits: hidden[0], knn_chunk=KNN_CHUNK,
            knn_snapshot_dir=str(tmp), device=dev, **kw)
    try:
        persist.write_snapshot = timed_write
        bat = batcher(knn_store=Grown(**vars(ds0)), knn_router=True,
                      knn_snapshot_every=KNN_SNAPSHOT_EVERY)
        holder["bat"] = bat
        reqs = [Request(rid=i, prompt=p, max_new=LM_MAX_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            bat.submit(r)
        cache = init_cache(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
        _, run_s = timed(lambda: bat.run(cache))
        del cache
        persist.write_snapshot = write_snapshot
        ds = bat.knn_store
        grown = len(prompts) * (LM_MAX_NEW - 1)
        if ds.store.n != n0 + grown or ds.store.live_count() != n0 + grown:
            raise AssertionError(f"knn_grow: n {ds.store.n}, not "
                                 f"{n0} + {grown}")
        want = torch.cat([t[torch.tensor(a)] for t, a in
                          zip(sampled, active)]).to(dev)
        if not torch.equal(ds.values[n0:n0 + grown].long(), want.long()):
            raise AssertionError("knn_grow: the values are not the sampled "
                                 "tokens in capture order")
        if [c["keys"].shape[0] for c in chunks] != [KNN_CHUNK] * (
                grown // KNN_CHUNK) + ([grown % KNN_CHUNK]
                                       if grown % KNN_CHUNK else []):
            raise AssertionError(f"knn_grow: chunks "
                                 f"{[c['keys'].shape[0] for c in chunks]}")
        # the periodic snapshot is its own step, the drain one the last
        steps = persist.list_snapshots(str(tmp))
        if steps[-1] != ds.store.n or len(steps) < 2:
            raise AssertionError(f"knn_grow: snapshots at {steps}")
        at = {after.store.n: after for _, after in states}
        restore_periodic_s = []
        for step in steps[:-1]:
            periodic, sec = timed(lambda: persist.restore_store(
                str(tmp), step=step, device=dev))
            restore_periodic_s.append(sec)
            same_store(periodic.store, at[step].store,
                       "knn_grow: a periodic snapshot")
            if not torch.equal(periodic.values, at[step].values):
                raise AssertionError("knn_grow: a periodic snapshot's "
                                     "values")
            del periodic
        # a cold start: a second batcher on the directory, no store
        b2, cold_s = timed(lambda: batcher())
        same_store(b2.knn_store.store, ds.store, "knn_grow: the cold start")
        if not torch.equal(b2.knn_store.values, ds.values):
            raise AssertionError("knn_grow: the cold start's values")
        # knn_logits, the same entries and draws, drained and restored
        def logits(d):
            return knn_logits(d, res["q"], cfg.vocab, k=8, entry=res["entry"],
                              generator=torch.Generator(device=dev)
                              .manual_seed(SEED + 14))
        (got, search_s) = timed(lambda: logits(ds))
        if not torch.equal(got.view(torch.int32),
                           logits(b2.knn_store).view(torch.int32)):
            raise AssertionError("knn_grow: knn_logits differ after the "
                                 "cold start")
        del b2
        # the chunks again through the plain versions, the same draws
        first = states[0][0]
        ds_p = MutableKNNDatastore(
            store=dataclasses.replace(first.store, cfg=dataclasses.replace(
                first.store.cfg, backend="plain")),
            values=first.values, build_stats={})
        for c in chunks:
            g = torch.Generator(device=dev)
            g.set_state(c["gen"])
            ds_p, _ = ds_p.append(c["keys"], c["values"], generator=g)
        n = ds.store.n
        x, x2 = ds.store.x[:n], ds.store.x2[:n]
        rows = torch.arange(n0, n, device=dev)
        d = x2[rows, None] + x2[None, :] - 2.0 * (x[rows] @ x.T)
        d[torch.arange(grown, device=dev), rows] = torch.inf
        truth = d.topk(KNN_K, dim=1, largest=False).indices
        rec = {"kernels": recall_at_k(ds.store.nl.idx[n0:n], truth),
               "plain": recall_at_k(ds_p.store.nl.idx[n0:n], truth)}
        del ds_p, d
        if abs(rec["kernels"] - rec["plain"]) > 0.01:
            raise AssertionError(f"knn_grow: inserted rows' recall through "
                                 f"the kernels and the plain versions: {rec}")
        periodic_w = [w for w in writes if w["step"] != steps[-1]]
        drain_w = [w for w in writes if w["step"] == steps[-1]]
        # decode steps that overlap a periodic write, and the others
        during = [b - a for a, b in step_s if any(
            a < w["t1"] and b > w["t0"] for w in periodic_w)]
        other = [b - a for a, b in step_s if all(
            a >= w["t1"] or b <= w["t0"] for w in periodic_w)]
        for w in writes:
            del w["t0"], w["t1"]
        decode_s = sum(b - a for a, b in step_s)
        return {
            "keys": n0, "grown": grown, "capacity": [ds0.store.capacity,
                                                    ds.store.capacity],
            "build_s": build_s, "run_s": run_s,
            "decode_steps": len(step_s), "decode_s": decode_s,
            "decode_tokens": grown,
            "decode_tokens_per_s": grown / decode_s,
            "step_ms_during_periodic_write": {
                "steps": len(during), "mean": 1e3 * sum(during) / max(
                    1, len(during))},
            "step_ms_otherwise": {"steps": len(other), "mean": 1e3 * sum(
                other) / max(1, len(other))},
            "chunks": [c["keys"].shape[0] for c in chunks],
            "insert_s": [c["s"] for c in chunks],
            "snapshots": steps, "periodic_write": periodic_w,
            "drain_write": drain_w,
            "restore_periodic_s": restore_periodic_s,
            "cold_start_s": cold_s, "knn_logits_s": search_s,
            "inserted_recall_at_16": rec["kernels"],
            "plain_inserted_recall_at_16": rec["plain"],
            "router_centroids": int(ds.store.router.centroids.shape[0]),
            "disk": str(tmp.parent),
            "outs": [r.out for r in reqs]}
    finally:
        persist.write_snapshot = write_snapshot
        shutil.rmtree(tmp, ignore_errors=True)


def same_bits(got, want) -> bool:
    """Equal shapes and bits (fp32 compared as int32)."""
    import torch
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.shape == want.shape and torch.equal(got, want)


def stable_merge(parts_d, parts_i, k: int):
    """The plain merge of per-shard lists (global ids): concatenated
    shard-major, a stable sort by distance, the first k, (+inf, -1) for
    empty slots. Held apart from the code under test."""
    import torch
    d, i = torch.cat(parts_d, 1), torch.cat(parts_i, 1)
    d = torch.where(i >= 0, d, torch.inf)
    sd, order = torch.sort(d, dim=1, stable=True)
    sd = sd[:, :k]
    si = torch.gather(i, 1, order)[:, :k]
    return sd, torch.where(torch.isfinite(sd), si, -1)


def shard_searches(x, gidx, q, ents, cfg, shards):
    """Each shard's direct graph_search on its rows and subgraph with the
    given entries, ids lifted to global."""
    import torch
    from repro_torch import graph_search
    n_local = x.shape[0] // len(shards)
    ds, is_ = [], []
    for p in shards:
        sl = slice(p * n_local, (p + 1) * n_local)
        d, i = graph_search(x[sl], gidx[sl], q, k_out=10, entry=ents[p],
                            cfg=cfg)
        ds.append(d)
        is_.append(torch.where(i >= 0, i + p * n_local, -1))
    return ds, is_


def ids_up_to_ties(x, q, got_d, got_i, want_d, want_i) -> dict:
    """Distances within 1e-4 + 1e-5 (|q|^2 + |x|^2); ids equal but where
    both ids lie at the same distance from the query to that tolerance
    (recomputed in fp64). Returns how many positions differ, how many of
    them hold bit-equal fp32 distances in both lists (ties of the kernel's
    values) and how many are exact ties in fp64, and the largest distance
    difference."""
    import torch
    if not torch.equal(torch.isfinite(got_d), torch.isfinite(want_d)):
        raise AssertionError("+inf positions differ")
    x2, q2 = (x * x).sum(1), (q * q).sum(1)
    tol = 1e-4 + 1e-5 * (q2[:, None] + x2[want_i.clamp_min(0).long()])
    fin = torch.isfinite(want_d)
    if ((got_d - want_d).abs()[fin] > tol[fin]).any():
        raise AssertionError("distances differ beyond 1e-4 + 1e-5 (|q|^2 "
                             "+ |x|^2)")
    r, c = torch.nonzero(got_i != want_i, as_tuple=True)
    qd = q[r].double()
    dg = ((x[got_i[r, c].long()].double() - qd) ** 2).sum(1)
    dw = ((x[want_i[r, c].long()].double() - qd) ** 2).sum(1)
    if ((dg - dw).abs() > tol[r, c]).any():
        raise AssertionError("ids differ at a distance that is not a tie")
    return {"tied_ids_that_differ": int(r.numel()),
            "of_them_equal_fp32_distances": int(
                (got_d[r, c] == want_d[r, c]).sum()),
            "of_them_exact_fp64_ties": int((dg == dw).sum()),
            "max_abs_dist_diff": float((got_d - want_d).abs()[fin].max())}


def fetch_check(mesh, x) -> dict:
    """fetch_rows_a2a on seeded random ids (SHARD_FETCH_M a shard, -1
    included) with a bucket cap near the mean load: rows bit-equal to
    x[ids] where ok, ok exactly the non-negative ids within their owner's
    first ``cap`` (by position), zero rows elsewhere."""
    import torch
    from repro_torch.core.distributed import fetch_rows_a2a
    P, n = mesh.size, x.shape[0]
    n_local = n // P
    g = torch.Generator(device=x.device).manual_seed(SEED + 31)
    ids = [torch.randint(-1, n, (SHARD_FETCH_M,), generator=g,
                         device=x.device, dtype=torch.int32)
           for _ in range(P)]
    (rows, ok), seconds = timed(lambda: fetch_rows_a2a(
        mesh, mesh.split(x), ids, cap=SHARD_FETCH_CAP))
    overflowed = 0
    for p in range(P):
        idp = ids[p].long()
        owner = torch.where(idp >= 0, idp // n_local, P)
        onehot = owner[:, None] == torch.arange(P + 1, device=x.device)
        rank = (onehot.cumsum(0) - 1).gather(1, owner[:, None])[:, 0]
        want_ok = (idp >= 0) & (rank < SHARD_FETCH_CAP)
        overflowed += int((onehot[:, :P].sum(0) > SHARD_FETCH_CAP).sum())
        if not torch.equal(ok[p], want_ok):
            raise AssertionError(f"fetch: shard {p}'s ok mask is wrong")
        if not same_bits(rows[p][want_ok], x[idp[want_ok]]) \
                or rows[p][~want_ok].any():
            raise AssertionError(f"fetch: shard {p}'s rows are wrong")
    if not 0 < overflowed < P * P:
        raise AssertionError(f"fetch: {overflowed} of {P * P} buckets "
                             "overflowed; the lane needs some, not all")
    return {"ids_per_shard": SHARD_FETCH_M, "cap": SHARD_FETCH_CAP,
            "fetched": int(sum(int(o.sum()) for o in ok)),
            "overflowed_buckets": overflowed, "seconds": seconds}


def chaos_shape_check(dev) -> dict:
    """The JAX chaos bench's sharded phase (benchmarks/bench_chaos.py:64-
    110) on the card: 4 shards of one tight cluster each (1024 x 16),
    per-shard graphs, a 16-centroid router, 128 queries, routed dispatch
    (route_p 2, route_cap 256) with shard 1 dead under a FaultPlan: the
    degraded recall against the attainable truth (brute force over the
    surviving rows) must reach CHAOS_FLOOR, with 0 dropped queries."""
    import torch
    from repro_torch.core import (DescentConfig, FaultPlan, FaultSpec,
                                  RouterConfig, SearchConfig, ShardMesh,
                                  brute_force_knn, build_knn_graph,
                                  build_router, graph_search_sharded,
                                  recall_at_k)
    P, n, d, dead = 4, 1024, 16, 1
    n_local = n // P
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    cent = torch.randn(P, d, generator=g, device=dev) * 8.0
    noise = torch.randn(P, n_local, d, generator=g, device=dev) * 0.5
    x = (cent[:, None, :] + noise).reshape(n, d)
    cfg = DescentConfig(k=10, rho=1.0, max_iters=10, reorder=False)
    gidx = torch.cat([build_knn_graph(
        x[s * n_local:(s + 1) * n_local], 10, cfg=cfg,
        generator=torch.Generator(device=dev).manual_seed(s))[1]
        for s in range(P)])
    router = build_router(x, cfg=RouterConfig(n_centroids=16, sample=1024),
                          generator=torch.Generator(
                              device=dev).manual_seed(SEED + 33))
    q = x[::8] + 0.01
    mesh = ShardMesh(["cuda:0"] * P)

    def dispatch():
        return graph_search_sharded(
            mesh, x, gidx, q, k_out=10,
            cfg=SearchConfig(beam=16, rounds=24, expand=4), router=router,
            route_p=2, route_cap=256, with_stats=True)
    _, ti_full = brute_force_knn(x, q, 10, exclude_self=False)
    _, gi_live, st_live = dispatch()
    with FaultPlan(specs=(FaultSpec(site="shard.dead", arg=dead),)).active():
        _, gi_dead, st_dead = dispatch()
    live_ids = torch.cat([torch.arange(s * n_local, (s + 1) * n_local,
                                       device=dev)
                          for s in range(P) if s != dead])
    _, tl = brute_force_knn(x[live_ids], q, 10, exclude_self=False)
    out = {"baseline_recall": recall_at_k(gi_live, ti_full),
           "degraded_recall": recall_at_k(gi_dead, live_ids[tl.long()]),
           "degraded_recall_full": recall_at_k(gi_dead, ti_full),
           "dropped_queries": st_dead["dropped_queries"],
           "degraded_shards": st_dead["degraded_shards"],
           "cover_frac": st_dead["cover_frac"], "floor": CHAOS_FLOOR}
    if out["degraded_recall"] < CHAOS_FLOOR or out["dropped_queries"] \
            or st_live["dropped_queries"] or st_dead["degraded_shards"] \
            != [dead] or (gi_dead.long() // n_local == dead).any():
        raise AssertionError(f"sharded chaos shape failed: {out}")
    return out


def sharded_run(x, graph, q, qt, truth, path_out, search_wall_s, scfg,
                dev):
    """Path 13: graph_search_sharded over ShardMesh(["cuda:0"] * SHARDS),
    each shard a subgraph of its own rows; exact_knn_sharded; the lanes
    p1, replicated, routed, dead, breaker, exact and fetch. ``graph`` is
    path 1's graph, ``truth`` path 2's (dist, idx), ``path_out`` path 3's
    (dist, idx) and ``qt`` its truth. Returns (lanes, kernel-line
    entries)."""
    import torch
    from repro_torch.core import (BreakerConfig, DescentConfig, FaultPlan,
                                  FaultSpec, RouterConfig, ShardBreaker,
                                  ShardMesh, build_knn_graph, build_router,
                                  exact_knn_sharded, graph_search_sharded,
                                  recall_at_k)
    from repro_torch.kernels import _lib
    P, n = SHARDS, x.shape[0]
    n_local = n // P
    lanes = {"device_count": torch.cuda.device_count()}

    # -- p1: one shard over path 1's graph draws path 3's entries (shard
    # 0's seed is the batch key) and returns its answer bit for bit
    (d1, i1), p1_s = timed(lambda: graph_search_sharded(
        ShardMesh(["cuda:0"]), x, graph, q, k_out=10, cfg=scfg))
    if not (same_bits(d1, path_out[0]) and same_bits(i1, path_out[1])):
        raise AssertionError("sharded p1: one shard differs from path 3")
    lanes["p1"] = {"wall_s": p1_s, "path3_wall_s": search_wall_s,
                   "bitwise": True}

    # -- the shards' subgraphs and the router over the global corpus
    dcfg = DescentConfig(k=20)
    (parts, build_s) = timed(lambda: [build_knn_graph(
        x[p * n_local:(p + 1) * n_local], 20, cfg=dcfg,
        generator=torch.Generator(device=dev).manual_seed(SEED + 40 + p))[1]
        for p in range(P)])
    gidx = torch.cat(parts)
    router, router_s = timed(lambda: build_router(
        x, cfg=RouterConfig(), generator=torch.Generator(
            device=dev).manual_seed(SEED + 45)))
    g = torch.Generator(device=dev).manual_seed(SEED + 46)
    ents = torch.stack([torch.randperm(n_local, generator=g, device=dev)[
        :scfg.beam] for _ in range(P)]).to(torch.int32)
    mesh = ShardMesh(["cuda:0"] * P)
    lanes["setup"] = {"shards": P, "n_local": n_local,
                      "devices": [str(d) for d in mesh.devices],
                      "subgraph_build_s": build_s, "router_s": router_s,
                      "centroids": int(router.centroids.shape[0])}

    # -- the main path: replicated, routed, exact; the pairwise launches
    # of the routed tile and the ring counted apart
    def main_path():
        out = {}
        for name, fn in (
                ("replicated", lambda: graph_search_sharded(
                    mesh, x, gidx, q, k_out=10, cfg=scfg, entries=ents,
                    with_stats=True)),
                ("routed", lambda: graph_search_sharded(
                    mesh, x, gidx, q, k_out=10, cfg=scfg, entries=ents,
                    router=router, route_p=2, with_stats=True)),
                ("exact", lambda: exact_knn_sharded(mesh, x, 20))):
            before = _lib.LAUNCHES["pairwise_sq_l2"]
            res, sec = timed(fn)
            out[name] = (res, sec, _lib.LAUNCHES["pairwise_sq_l2"] - before)
        return out
    res, wall, launches, peak, _ = drive("sharded", main_path)
    require_launched("sharded", launches, ("knn_search_dists",
                                           "knn_join_select", "knn_merge",
                                           "pairwise_sq_l2"))
    lanes.update(wall_s=wall, launches=launches, max_memory_allocated=peak)
    # -- roofline_check: the exact lane counted on the card (its ring
    # tiles and the merge kernel; 2 d operations a scored pair)
    roofline_lane("sharded exact_knn_sharded (path 13)",
                  lambda: exact_knn_sharded(mesh, x, 20), res["exact"][1],
                  2.0 * n * n * x.shape[1], ("pairwise_sq_l2", "knn_merge"),
                  shards=P)

    # -- replicated: the stable merge of four direct searches, bitwise
    (rd, ri, rst), rep_s, _ = res["replicated"]
    check_search(rd, ri, n, 10)
    parts_d, parts_i = shard_searches(x, gidx, q, ents, scfg, range(P))
    md, mi = stable_merge(parts_d, parts_i, 10)
    if not (same_bits(rd, md) and same_bits(ri, mi)):
        raise AssertionError("sharded replicated: not the stable merge of "
                             "the four direct searches")
    int8_cfg = dataclasses.replace(scfg, precision="int8")
    (qd8, qi8), int8_s = timed(lambda: graph_search_sharded(
        mesh, x, gidx, q, k_out=10, cfg=int8_cfg, entries=ents))
    md8, mi8 = stable_merge(*shard_searches(x, gidx, q, ents, int8_cfg,
                                            range(P)), 10)
    if not (same_bits(qd8, md8) and same_bits(qi8, mi8)):
        raise AssertionError("sharded int8: not the stable merge of the "
                             "four direct int8 searches")
    prof = profile_run(lambda: graph_search_sharded(
        mesh, x, gidx, q, k_out=10, cfg=scfg, entries=ents))
    lanes["replicated"] = {
        "wall_s": rep_s, "queries_per_s": q.shape[0] / rep_s,
        "path3_queries_per_s": q.shape[0] / search_wall_s,
        "recall_at_10": recall_at_k(ri, qt),
        "path3_recall_at_10": recall_at_k(path_out[1], qt), "stats": rst,
        "bitwise_to_direct_merge": True, "int8_wall_s": int8_s,
        "int8_recall_at_10": recall_at_k(qi8, qt),
        "int8_bitwise_to_direct_merge": True,
        "device_idle_share": prof["device_idle_share"],
        "profiled_wall_s": prof["profiled_wall_s"]}

    # -- routed: fan-out 2, nothing dropped; recall and the overlap with
    # the replicated answer (no floor: the shards are not cluster-aligned)
    (od, oi, ost), routed_s, route_tiles = res["routed"]
    check_search(od, oi, n, 10)
    if ost["fanout"] != 2 or ost["dropped_queries"] != 0 \
            or ost["searched_queries"] != ost["routed_queries"]:
        raise AssertionError(f"sharded routed: stats {ost}")
    lanes["routed"] = {
        "wall_s": routed_s, "queries_per_s": q.shape[0] / routed_s,
        "recall_at_10": recall_at_k(oi, qt), "stats": ost,
        "overlap_with_replicated": recall_at_k(oi, ri),
        "chaos_shape": chaos_shape_check(dev)}

    # -- dead: shard 1 dead under a FaultPlan, replicated and routed
    plan = FaultPlan(specs=(FaultSpec(site="shard.dead", arg=1),))
    with plan.active():
        (dd, di, dst), dead_s = timed(lambda: graph_search_sharded(
            mesh, x, gidx, q, k_out=10, cfg=scfg, entries=ents,
            with_stats=True))
    with plan.active():
        (_, dri, drst), dead_routed_s = timed(lambda: graph_search_sharded(
            mesh, x, gidx, q, k_out=10, cfg=scfg, entries=ents,
            router=router, route_p=2, with_stats=True))
    sd, si = stable_merge([parts_d[p] for p in (0, 2, 3)],
                          [parts_i[p] for p in (0, 2, 3)], 10)
    if (di.long() // n_local == 1).any() \
            or (dri.long() // n_local == 1).any() \
            or dst["cover_frac"] != 0.75 or dst["degraded_shards"] != [1] \
            or not (same_bits(dd, sd) and same_bits(di, si)):
        raise AssertionError(f"sharded dead: {dst}, {drst}")
    lanes["dead"] = {"replicated_wall_s": dead_s,
                     "replicated_recall_at_10": recall_at_k(di, qt),
                     "replicated_stats": dst, "routed_wall_s": dead_routed_s,
                     "routed_recall_at_10": recall_at_k(dri, qt),
                     "routed_stats": drst, "bitwise_to_survivors": True}

    # -- breaker: shard.degrade (2, 40.0) trips shard 2 within
    # BREAKER_DISPATCHES dispatches of BREAKER_QUERIES queries
    br = ShardBreaker(P, BreakerConfig(min_samples=3, probe_every=50))
    qb = q[:BREAKER_QUERIES]
    seconds = []
    slow = FaultPlan(seed=0, specs=(FaultSpec(site="shard.degrade",
                                              arg=(2, 40.0)),))
    with slow.active():
        for _ in range(BREAKER_DISPATCHES):
            _, sec = timed(lambda: graph_search_sharded(
                mesh, x, gidx, qb, k_out=10, cfg=scfg, breaker=br))
            seconds.append(sec)
            if br.open[2]:
                break
    tripped_after = len(seconds)
    (bd, bi, bst), sec = timed(lambda: graph_search_sharded(
        mesh, x, gidx, qb, k_out=10, cfg=scfg, with_stats=True, breaker=br))
    seconds.append(sec)
    if not br.open[2] or 2 not in bst["degraded_shards"] \
            or bst["cover_frac"] != 0.75 or (bi < 0).any() \
            or (bi.long() // n_local == 2).any():
        raise AssertionError(f"sharded breaker: {br.stats()}, {bst}")
    lanes["breaker"] = {"queries": BREAKER_QUERIES,
                        "tripped_after_dispatches": tripped_after,
                        "dispatch_s": seconds, "stats": bst}

    # -- exact: the ring against path 2's brute force
    (ed, ei), exact_s, ring_tiles = res["exact"]
    lanes["exact"] = {"wall_s": exact_s, "slots": ei.numel(),
                      **ids_up_to_ties(x, x, ed, ei, *truth)}
    lanes["fetch"] = fetch_check(mesh, x)

    # -- the kernels line's rows of this path: the ring tile and the
    # routed query-centroid tile, on the inputs the path gave them
    rows = []
    for call, args, launched in (
            ("ring", (x[:n_local].contiguous(),
                      x[n_local:2 * n_local].contiguous()), ring_tiles),
            ("route", (q.contiguous(), router.centroids.contiguous()),
             route_tiles)):
        e = check_kernel("pairwise_sq_l2", args, reps=10)
        e.update(route="cuda", source=SOURCES["pairwise_sq_l2"],
                 replaces=REPLACES["pairwise_sq_l2"], launches=launched,
                 path="sharded", call=f"sharded:pairwise_sq_l2:{call}")
        emit("kernels", **e)
        rows.append(e)
    return lanes, rows


def lean_fetch_check(mesh, x) -> dict:
    """The polish's fetch without padded buckets (_plan_fetch, then
    _fetch_chunk for each chunk of SB_FETCH_SPAN ids) against
    fetch_rows_a2a on SB_FETCH_M seeded ids a shard (-1 included) with a
    cap at the mean load: rows and masks bit-equal, some buckets
    overflowing and some not."""
    import torch
    from repro_torch.core.distributed import (_fetch_chunk, _plan_fetch,
                                              fetch_rows_a2a)
    P, n = mesh.size, x.shape[0]
    g = torch.Generator(device=x.device).manual_seed(SEED + 51)
    ids = [torch.randint(-1, n, (SB_FETCH_M,), generator=g,
                         device=x.device, dtype=torch.int32)
           for _ in range(P)]
    blocks = mesh.split(x)

    def lean():
        plans = _plan_fetch(mesh, n // P, ids, cap=SB_FETCH_CAP,
                            span=SB_FETCH_SPAN)
        return ([torch.cat([_fetch_chunk(mesh, blocks, plans, p, c)
                            for c in range(len(plans[p].bounds) - 1)])
                 for p in range(P)], [f.ok for f in plans])

    (want_rows, want_ok), a2a_s = timed(lambda: fetch_rows_a2a(
        mesh, blocks, ids, cap=SB_FETCH_CAP))
    (rows, ok), lean_s = timed(lean)
    overflowed = 0
    for p in range(P):
        if not (torch.equal(ok[p], want_ok[p])
                and same_bits(rows[p], want_rows[p])):
            raise AssertionError(f"sharded_build fetch: shard {p} differs "
                                 "from fetch_rows_a2a")
        owner = torch.where(ids[p] >= 0, ids[p].long() // (n // P), P)
        overflowed += int((torch.bincount(owner, minlength=P + 1)[:P]
                           > SB_FETCH_CAP).sum())
    if not 0 < overflowed < P * P:
        raise AssertionError(f"sharded_build fetch: {overflowed} of "
                             f"{P * P} buckets overflowed")
    return {"ids": P * SB_FETCH_M, "cap": SB_FETCH_CAP,
            "span": SB_FETCH_SPAN, "fetched": int(sum(int(o.sum()) for o in ok)),
            "overflowed_buckets": overflowed, "bitwise": True,
            "a2a_s": a2a_s, "lean_s": lean_s}


def sharded_build_run(x, truth_i, path1_wall_s, path1_recall, dev):
    """Path 14: build_knn_graph_sharded over ShardMesh(["cuda:0"] *
    SHARDS) on path 1's corpus, DescentConfig(k=20, reorder=False), key
    SB_KEY; lanes main, plain, fetch and step. ``truth_i`` is path 2's
    ids. Returns (lanes, kernel-line entries: the select at SB_WIDTHS)."""
    import torch
    from repro_torch.core import (DescentConfig, NeighborLists, ShardMesh,
                                  build_knn_graph_sharded,
                                  make_sharded_iteration, recall_at_k)
    from repro_torch.kernels import _lib
    n, d = x.shape
    mesh = ShardMesh(["cuda:0"] * SHARDS)
    cfg = DescentConfig(k=20, reorder=False)
    lanes = {"device_count": torch.cuda.device_count(), "shards": SHARDS,
             "n_local": n // SHARDS,
             "devices": [str(dv) for dv in mesh.devices],
             "cfg": dataclasses.asdict(cfg), "key": SB_KEY}

    def build(c=cfg, key=SB_KEY):
        return build_knn_graph_sharded(mesh, x, 20, cfg=c, key=key)

    # -- main: the build through the select kernel
    (dist, idx, st), wall, launches, peak, rec = drive("sharded_build",
                                                       build)
    require_launched("sharded_build", launches, ("knn_join_select",))
    graph_err = check_graph(x, dist, idx, repeats_ok=True)
    prof = profile_run(build)
    lanes["main"] = {
        "wall_s": wall, "path1_wall_s": path1_wall_s, **st,
        "max_memory_allocated": peak, "launches": launches,
        "recall_at_20": recall_at_k(idx, truth_i),
        "path1_recall_at_20": path1_recall, "dist_err_over_tol": graph_err,
        "device_idle_share": prof["device_idle_share"],
        "profiled_wall_s": prof["profiled_wall_s"], "top": prof["top"][:6]}

    # -- plain: the same build and draws through the select's plain
    # version, bit for bit
    _lib.reset_launches()
    (pd, pi, pst), plain_s = timed(lambda: build(
        dataclasses.replace(cfg, backend="plain")))
    if any(_lib.LAUNCHES.values()):
        raise AssertionError(f"sharded_build plain: launched "
                             f"{dict(_lib.LAUNCHES)}")
    if not (same_bits(pd, dist) and same_bits(pi, idx) and pst == st):
        raise AssertionError(f"sharded_build plain: differs from main "
                             f"({pst} against {st})")
    lanes["plain"] = {"wall_s": plain_s, "bitwise": True}
    del pd, pi

    # -- fetch: the polish's lean fetch against fetch_rows_a2a
    lanes["fetch"] = lean_fetch_check(mesh, x)

    # -- step: one iteration of main at its shapes, from its init lists
    step, flops = make_sharded_iteration(mesh, n=n, d=d, k=20, rho=cfg.rho)
    d0, i0, st0 = build(dataclasses.replace(cfg, max_iters=0, polish=0))
    nl0 = NeighborLists(d0, i0, torch.ones_like(i0, dtype=torch.bool))
    (_, upd, ev), first_s = timed(lambda: step(x, nl0, key=SB_KEY))
    (_, upd2, ev2), step_s = timed(lambda: step(x, nl0, key=SB_KEY))
    if (int(upd), int(ev)) != (int(upd2), int(ev2)) or st0["iters"]:
        raise AssertionError("sharded_build step: two calls differ")
    lanes["step"] = {"seconds": step_s, "first_call_s": first_s,
                     "model_flops": flops,
                     "model_flops_per_s": flops / step_s,
                     "updates": int(upd), "evals": int(ev)}
    # -- roofline_check: that iteration counted on the card (it cannot
    # run on meta: its compactions' shapes depend on the data)
    roofline_lane("sharded_build iteration (path 14)",
                  lambda: step(x, nl0, key=SB_KEY), step_s, flops,
                  ("knn_join_select",), shards=SHARDS, n=n, d=d, k=20)

    # -- the kernels line: the select at both widths, on the inputs the
    # main path gave it; the widths' launches add up to the path's count
    keys = {k: c for k, c in rec.calls.items()
            if k.startswith("sharded_build:knn_join_select:")}
    widths = sorted(tuple(int(v.split("=")[1]) for v in k.split(":")[2:])
                    for k in keys)
    per_width = sum(c for k, c in rec.launched.items()
                    if k.startswith("sharded_build:knn_join_select:"))
    if widths != sorted(SB_WIDTHS) \
            or per_width != launches["knn_join_select"]:
        raise AssertionError(f"sharded_build: select widths {widths}, "
                             f"{per_width} of {launches['knn_join_select']} "
                             "launches")
    rows = []
    for key in sorted(keys):
        e = check_kernel("knn_join_select", keys[key], reps=20)
        e.update(route="cuda", source=SOURCES["knn_join_select"],
                 replaces=REPLACES["knn_join_select"],
                 launches=rec.launched[key], path="sharded_build", call=key)
        emit("kernels", **e)
        rows.append(e)
    return lanes, rows


# -- the launch tooling: the dry-run on meta, the counter on the card

DRYRUN_CELLS = (("yi-6b", "train_4k"), ("yi-6b", "prefill_32k"),
                ("yi-6b", "decode_32k"),
                ("granite-moe-3b-a800m", "decode_32k"),     # MoE
                ("zamba2-1.2b", "decode_32k"))              # hybrid


def kernel_rows(rec, launches: dict, names) -> list:
    """Each recorded call of ``rec`` whose kernel is in ``names`` against
    its plain version (check_kernel), with that key's own launches, one
    "kernels" line each. The path's per-key select launches must add up
    to its count."""
    per_key = sum(c for k, c in rec.launched.items()
                  if k.startswith(f"{rec.tag}:knn_join_select:"))
    if per_key != launches["knn_join_select"]:
        raise AssertionError(f"{rec.tag}: select launches by width sum to "
                             f"{per_key} of {launches['knn_join_select']}")
    rows = []
    for key, call in sorted(rec.calls.items()):
        name = key.split(":")[1]
        if name not in names:
            continue
        e = check_kernel(name, call, reps=20)
        e.update(route="cuda", source=SOURCES[name], replaces=REPLACES[name],
                 launches=rec.launched[key], path=rec.tag, call=key,
                 calls_at_this_key=rec.seen[key],
                 launches_at_this_key=rec.launched[key])
        emit("kernels", **e)
        rows.append(e)
    return rows


def select_rows(kind: str, n: int, w: int, seed: int, dev):
    """(gd, gi, kth) rows for the streamed select: "ties" (six values),
    "zeros" (-0.0 and +0.0 beside 0.125) or "straddle" (two values, the
    c-th key inside a run spread over the whole row); +inf pads, ids -1,
    and a prefilter on every third row."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    r = torch.rand(n, w, generator=g, device=dev)
    if kind == "ties":
        gd = torch.randint(0, 6, (n, w), generator=g, device=dev) / 4.0
    elif kind == "zeros":
        gd = torch.where(r < 0.5, torch.full_like(r, -0.0),
                         torch.zeros_like(r))
        gd[r >= 0.7] = 0.125
    else:
        gd = torch.where(r < 0.04, 0.25, 0.5)
    gd[torch.rand(n, w, generator=g, device=dev) < 0.2] = torch.inf
    gi = torch.randint(-1, 99, (n, w), generator=g, device=dev,
                       dtype=torch.int32)
    kth = torch.full((n,), torch.inf, device=dev)
    kth[1::3] = 0.5
    return gd.float().contiguous(), gi, kth


def merge_pool_rows(n: int, k: int, c: int, seed: int, dev):
    """(cur_d, cur_i, cand_d, cand_i) for the merges above a pool of 8192,
    row r of kind r % 7: ties (list and candidates at one distance),
    repeated candidate ids (eight values), candidate ids already in the
    list, ids -1, -0.0 / +0.0 beside +0.25, the FLT_MAX sentinel (and
    list entries at +inf, -1 and 3e38), and a mix on a grid of ties."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    cur_d = torch.rand(n, k, generator=g, device=dev).sort(1).values
    cur_i = torch.randint(0, 40 * c, (n, k), generator=g, device=dev,
                          dtype=torch.int32)
    cand_d = (torch.rand(n, c, generator=g, device=dev) * 16).round() / 16
    cand_i = torch.randint(-1, 40 * c, (n, c), generator=g, device=dev,
                           dtype=torch.int32)
    kind = torch.arange(n, device=dev) % 7
    cur_d[kind == 0] = 0.5
    cand_d[kind == 0] = 0.5
    few = torch.randint(0, 8, (n, c), generator=g, device=dev,
                        dtype=torch.int32)
    cand_i = torch.where((kind == 1)[:, None], few, cand_i)
    pick = torch.randint(0, k, (n, c), generator=g, device=dev)
    cand_i = torch.where((kind == 2)[:, None], cur_i.gather(1, pick), cand_i)
    half = torch.rand(n, c, generator=g, device=dev) < 0.5
    cand_i = torch.where((kind == 3)[:, None] & half, -1, cand_i)
    zeros = torch.where(half, torch.full_like(cand_d, -0.0),
                        torch.zeros_like(cand_d))
    zeros[torch.rand(n, c, generator=g, device=dev) < 0.3] = 0.25
    cand_d = torch.where((kind == 4)[:, None], zeros, cand_d)
    cur_d[kind == 4, :k // 4] = 0.0
    fmax = torch.finfo(torch.float32).max
    sent = (kind == 5)[:, None] & (torch.rand(n, c, generator=g, device=dev)
                                   < 0.4)
    cand_d = torch.where(sent, fmax, cand_d)
    cur_d[kind == 5, k - 6:k - 3] = 3.0e38
    cur_d[kind == 5, k - 3:] = torch.inf
    cur_i[kind == 5, k - 3:] = -1
    return (cur_d.contiguous(), cur_i.contiguous(), cand_d.contiguous(),
            cand_i.contiguous())


def large_k_merge_check(dev):
    """The merges above a pool of 8192 against their plain version on the
    card, dense and row forms, at LARGE_K_MERGE_POOLS over
    LARGE_K_MERGE_ROWS rows of merge_pool_rows (the row form into lists
    three times as long, a seventh of its slots padding): distances bit for
    bit, ids and accepted counts exact, one launch a call. Returns (rows,
    the dense call at the first pool: row 3d's inputs)."""
    import torch
    from repro_torch.kernels import _lib, ops
    rows, call_3d = [], None
    n = LARGE_K_MERGE_ROWS
    for k, c in LARGE_K_MERGE_POOLS:
        cd, ci, qd, qi = merge_pool_rows(n, k, c, SEED + 70 + c, dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 71 + c)
        big_d = torch.rand(3 * n, k, generator=g, device=dev).sort(1).values
        big_i = torch.randint(0, 40 * c, (3 * n, k), generator=g, device=dev,
                              dtype=torch.int32)
        slot = torch.randperm(3 * n, generator=g, device=dev)[:n]
        big_d[slot], big_i[slot] = cd, ci
        at = slot.to(torch.int32)
        at[::7] = -1
        for name, args in (("knn_merge", (cd, ci, qd, qi)),
                           ("knn_merge_rows", (big_d, big_i, at, qd, qi))):
            fn = getattr(ops, name)
            before = _lib.LAUNCHES[name]
            got = fn(*args)
            torch.cuda.synchronize()
            launched = _lib.LAUNCHES[name] - before
            want = fn(*args, backend="ref")
            same = (torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(got[1], want[1])
                    and torch.equal(got[2], want[2]))
            if launched != 1 or not same:
                raise AssertionError(f"{name} k={k} c={c}: launches "
                                     f"{launched}, kernel and plain differ")
            rows.append({"name": name, "k": k, "c": c, "pool": k + c,
                         "rows": n, "accepted": int(want[2].sum()),
                         "tolerance": "bitwise (distance bits, ids, "
                                      "accepted counts)"})
        if call_3d is None:
            call_3d = (cd, ci, qd, qi)
    return rows, call_3d


def large_k_kernel_check(xc, dev) -> dict:
    """The wide joins and the streamed select against their plain versions
    on the card: the fp32, int8 and bf16 joins at LARGE_K_JOIN_C on
    the check corpus (padded, and its mirrors), ids with -1, an
    all-invalid row and a repeated id, cn = C / 2 (evals exact; int8
    bitwise; fp32 and bf16 within 1e-4 + 1e-5 (|a|^2 + |b|^2), +inf
    exact), and the select at
    LARGE_K_SELECT_W on rows of ties, of -0.0 / +0.0 and of a straddled
    run (bitwise: ids and distance bits); each call one launch."""
    import torch
    from repro_torch.core import quantize
    from repro_torch.core.layout import pad_features
    from repro_torch.kernels import _lib, ops
    xp = pad_features(xc).contiguous()
    x2 = (xp * xp).sum(1)
    width = quantize.mirror_width(xc.shape[1], xp.shape[1])
    mirrors = {p: quantize.quantize_corpus(xp, p, width=width)
               for p in PRECISIONS}
    big_n = xp.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    joins = []
    for c, n in zip(LARGE_K_JOIN_C, LARGE_K_JOIN_ROWS):
        ids = torch.randint(-1, big_n, (n, c), generator=g, device=dev,
                            dtype=torch.int32)
        ids[3] = -1
        ids[4, c - 1] = ids[4, 0]
        cn = c // 2
        for prec in ("f32",) + PRECISIONS:
            if prec == "f32":
                fn, name, n2 = ops.knn_join_dists, "knn_join_dists", x2
                args = (xp, x2, ids, cn)
            elif prec == "int8":
                m = mirrors[prec]
                fn, name, n2 = ops.knn_join_dists_q8, "knn_join_dists_q8", m.x2
                args = (m.data, m.scale, m.x2, ids, cn)
            else:
                m = mirrors[prec]
                fn, name = ops.knn_join_dists_bf16, "knn_join_dists_bf16"
                n2, args = m.x2, (m.data, m.x2, ids, cn)
            before = _lib.LAUNCHES[name]
            gd, gev = fn(*args)
            torch.cuda.synchronize()
            launched = _lib.LAUNCHES[name] - before
            wd, wev = fn(*args, backend="ref")
            if launched != 1 or not torch.equal(gev, wev):
                raise AssertionError(f"{name} C={c}: launches {launched}, "
                                     "evals equal: "
                                     f"{torch.equal(gev, wev)}")
            row = {"name": name, "C": c, "rows": n, "cn": cn,
                   "evals": int(gev.sum())}
            if prec == "int8":
                if not torch.equal(gd, wd):
                    raise AssertionError(f"{name} C={c}: kernel and plain "
                                         "differ")
                fin = torch.isfinite(wd)
                row.update(max_abs_err=float((gd - wd).abs()[fin].max()),
                           tolerance="bitwise")
            else:
                valid = (ids >= 0) & (ids < big_n)
                x2g = torch.where(valid, n2[ids.clamp(0, big_n - 1).long()],
                                  0.0)
                row.update(close_to_plain(
                    f"{name} C={c}", gd, wd,
                    x2g[:, :, None] + x2g[:, None, :]),
                    tolerance="1e-4 + 1e-5 * (|a|^2 + |b|^2); inf exact")
            joins.append(row)
            del gd, wd
    selects = []
    for (w, c), n in zip(LARGE_K_SELECT_W, LARGE_K_SELECT_ROWS):
        for kind in ("ties", "zeros", "straddle"):
            gd, gi, kth = select_rows(kind, n, w, SEED + w + len(kind), dev)
            before = _lib.LAUNCHES["knn_join_select"]
            od, oi = ops.knn_join_select(gd, gi, kth, c)
            torch.cuda.synchronize()
            launched = _lib.LAUNCHES["knn_join_select"] - before
            wd, wi = ops.knn_join_select(gd, gi, kth, c, backend="ref")
            if launched != 1 or not torch.equal(oi, wi) or not torch.equal(
                    od.view(torch.int32), wd.view(torch.int32)):
                raise AssertionError(f"knn_join_select W={w} c={c} {kind}: "
                                     f"launches {launched}, kernel and "
                                     "plain differ")
            selects.append({"W": w, "c": c, "rows": n, "kind": kind,
                            "winners": int((wi >= 0).sum()),
                            "tolerance": "bitwise (ids, distance bits)"})
    return {"joins": joins, "selects": selects}


def large_k_build_check(xc, dev):
    """Builds at large k on the check corpus: build_knn_graph(k=91) through
    the kernels and through their plain versions with the same generator
    seed (recalls against an exact k-NN within 0.01, both >= 0.84), the
    int8 and bf16 two-stage builds at k 91 (driven: their joins' calls
    recorded for the kernels line; recall >= the f32 build's - 0.02,
    distances exact fp32), and MutableKNNStore.build at k LARGE_K_STORE
    (rho 1.0: C 96). Returns (fields, [(recorder, launches, join)] of
    the quantized builds)."""
    import torch
    from repro_torch import (DescentConfig, MutableKNNStore,
                             build_knn_graph, recall_at_k)
    from repro_torch.kernels import _lib
    truth = exact_knn(xc, TSNE_K)
    out = {}
    for backend in ("plain", "auto"):
        _lib.reset_launches()
        cfg = DescentConfig(k=TSNE_K, backend=backend)
        (_, idx, st), sec = timed(lambda: build_knn_graph(
            xc, k=TSNE_K, cfg=cfg,
            generator=torch.Generator(device=dev).manual_seed(SEED)))
        launched = {k: v for k, v in _lib.LAUNCHES.items() if v}
        if backend == "auto":
            require_launched(f"k{TSNE_K} build", _lib.LAUNCHES, TRAIN_KERNELS)
        elif launched:
            raise AssertionError(f"the plain k{TSNE_K} build launched "
                                 f"{launched}")
        out[backend] = {"seconds": sec, "recall": recall_at_k(idx, truth),
                        "iters": st.iters, "dist_evals": st.dist_evals,
                        "launches": launched}
    gap = abs(out["auto"]["recall"] - out["plain"]["recall"])
    if gap > 0.01 or min(out["auto"]["recall"],
                         out["plain"]["recall"]) < 0.84:
        raise AssertionError(f"k{TSNE_K} build check failed: {out}")
    out["recall_gap"] = gap
    recs = []
    for prec in PRECISIONS:
        qcfg = DescentConfig(k=TSNE_K, precision=prec)
        (qd, qi, qst), wall, launches, peak, rec = drive(
            f"k{TSNE_K}_{prec}", lambda: build_knn_graph(
                xc, k=TSNE_K, cfg=qcfg,
                generator=torch.Generator(device=dev).manual_seed(SEED)))
        require_launched(rec.tag, launches, (OWNED[f"build_{prec}"],
                                             "knn_join_select", "knn_merge"))
        out[prec] = {"seconds": wall, "recall": recall_at_k(qi, truth),
                     "iters": qst.iters, "dist_evals": qst.dist_evals,
                     "max_memory_allocated": peak,
                     "dist_err_over_tol": check_graph(xc, qd, qi,
                                                      repeats_ok=True),
                     "launches": {k: v for k, v in launches.items() if v}}
        if out[prec]["recall"] < out["auto"]["recall"] - 0.02:
            raise AssertionError(f"k{TSNE_K} {prec} build: {out[prec]}")
        recs.append((rec, launches, OWNED[f"build_{prec}"]))
        del qd, qi
    _lib.reset_launches()
    (store, sst), sec = timed(lambda: MutableKNNStore.build(
        xc, LARGE_K_STORE,
        generator=torch.Generator(device=dev).manual_seed(SEED)))
    require_launched("MutableKNNStore.build", _lib.LAUNCHES, TRAIN_KERNELS)
    sidx = store.nl.idx[:xc.shape[0]]
    if not bool((sidx >= 0).all()) or sidx.device != xc.device:
        raise AssertionError("MutableKNNStore.build: lists not full")
    out["store"] = {"k": LARGE_K_STORE, "C": 2 * LARGE_K_STORE,
                    "seconds": sec, "iters": sst.iters,
                    "recall": recall_at_k(sidx, exact_knn(xc, LARGE_K_STORE)),
                    "launches": {k: v for k, v in _lib.LAUNCHES.items()
                                 if v}}
    return out, recs


def large_k_online_check(xc, dev) -> dict:
    """knn_insert / knn_delete at k 91 on online_check's shape (a routed
    store of CHECK_BASE rows at path 22's descent, the rest inserted and
    a tenth of the rows deleted in batches of CHECK_BATCH, a frontier
    chunk of LARGE_K_CHUNK) through the kernels and through the plain
    versions on the same draws: the row merge at c = 91^2 launched, the
    live lists checked (check_live_lists), recall@91 against an exact
    k-NN of the live rows within 0.01, both >= 0.84. Then
    MutableKNNDatastore at k 91 (its default descent: rho 1.0, C 182) on
    LARGE_K_DS keys, grown by two batches of LARGE_K_DS_BATCH and shrunk
    by one, through the kernels: the row merge at c = 91^2 launched, its
    live lists checked, recall@91 >= 0.84."""
    import torch
    from repro_torch import (DescentConfig, OnlineConfig, RouterConfig,
                             recall_at_k)
    from repro_torch.kernels import _lib
    from repro_torch.serve import MutableKNNDatastore
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    dels = torch.randperm(CHECK_N, generator=g, device=dev)[:CHECK_N // 10]
    wide = f"c={TSNE_K ** 2}"
    out = {}
    for backend in ("plain", "auto"):
        cfg = OnlineConfig(router=RouterConfig(), chunk=LARGE_K_CHUNK,
                           backend=backend)
        descent = DescentConfig(k=TSNE_K, backend=backend)
        _lib.reset_launches()
        with Recorder(f"k{TSNE_K}_online_{backend}") as rec:
            res = run_online(xc, CHECK_BASE, CHECK_BATCH, dels, CHECK_BATCH,
                             cfg, descent, k=TSNE_K)
        store = res["store"]
        live, truth = live_truth(xc, store.alive, TSNE_K)
        merged = sum(v for key, v in rec.launched.items()
                     if key.endswith(f"knn_merge_rows:{wide}"))
        out[backend] = {
            "recall_at_91": recall_at_k(store.nl.idx[live], truth),
            "insert_dist_evals": sum(st.dist_evals for st in res["insert"]),
            "delete_dist_evals": sum(st.dist_evals for st in res["delete"]),
            "seconds": res["build_s"] + sum(res["insert_s"])
            + sum(res["delete_s"]),
            "wide_row_merge_launches": merged,
            "launches": {k: v for k, v in _lib.LAUNCHES.items() if v},
            **check_live_lists(store, dels)}
        if backend == "auto":
            require_launched("large_k_check online", _lib.LAUNCHES,
                             ONLINE_KERNELS)
            if merged == 0:
                raise AssertionError(f"large_k_check online: no row merge "
                                     f"at {wide}: {rec.launched}")
        elif any(_lib.LAUNCHES.values()):
            raise AssertionError(f"large_k_check online plain run launched "
                                 f"{_lib.LAUNCHES}")
        del res, store
    gap = abs(out["auto"]["recall_at_91"] - out["plain"]["recall_at_91"])
    out["recall_gap"] = gap
    if gap > 0.01 or min(out["auto"]["recall_at_91"],
                         out["plain"]["recall_at_91"]) < 0.84:
        raise AssertionError(f"large_k_check online failed: {out}")

    keys = xc[:LARGE_K_DS + 2 * LARGE_K_DS_BATCH]
    vals = torch.arange(keys.shape[0], device=dev, dtype=torch.int32) % 50
    _lib.reset_launches()
    with Recorder(f"k{TSNE_K}_datastore") as rec:
        ds = MutableKNNDatastore.build(
            keys[:LARGE_K_DS], vals[:LARGE_K_DS], k=TSNE_K,
            router=RouterConfig(), device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 8))
        for s in range(LARGE_K_DS, keys.shape[0], LARGE_K_DS_BATCH):
            ds, _ = ds.append(keys[s:s + LARGE_K_DS_BATCH],
                              vals[s:s + LARGE_K_DS_BATCH],
                              generator=torch.Generator(
                                  device=dev).manual_seed(s))
        gone = torch.randperm(keys.shape[0], generator=g,
                              device=dev)[:LARGE_K_DS_BATCH]
        ds, _ = ds.delete(gone)
        torch.cuda.synchronize()
    merged = sum(v for key, v in rec.launched.items()
                 if key.endswith(f"knn_merge_rows:{wide}"))
    live, truth = live_truth(keys, ds.store.alive, TSNE_K)
    out["datastore"] = {
        "keys": LARGE_K_DS, "appended": 2 * LARGE_K_DS_BATCH,
        "deleted": LARGE_K_DS_BATCH, "wide_row_merge_launches": merged,
        "recall_at_91": recall_at_k(ds.store.nl.idx[live], truth),
        "launches": {k: v for k, v in _lib.LAUNCHES.items() if v},
        **check_live_lists(ds.store, gone)}
    if merged == 0 or out["datastore"]["recall_at_91"] < 0.84:
        raise AssertionError(f"large_k_check datastore: {out['datastore']}")
    return out


def online_k91_run(x, dev):
    """Path 23: the online store at t-SNE's k on path 8's shape, through
    the kernels, driven, its live lists checked and scored against an
    exact k-NN of the live rows, then one more insert batch profiled;
    its line printed. Returns its kernel rows (row 6e: the row merge at
    c = 91^2)."""
    import torch
    from repro_torch import (DescentConfig, OnlineConfig, RouterConfig,
                             knn_insert, recall_at_k)
    cfg = OnlineConfig(router=RouterConfig())
    descent = DescentConfig(k=TSNE_K)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    dels = torch.randperm(N, generator=g, device=dev)[:N_DELETE]
    res, wall, launches, peak, rec = drive(K91_ONLINE_TAG, lambda: run_online(
        x, N_BASE, INSERT_BATCH, dels, DELETE_BATCH, cfg, descent,
        k=TSNE_K))
    require_launched(K91_ONLINE_TAG, launches, ONLINE_KERNELS + (
        "knn_join_dists", "knn_join_select", "knn_merge", "knn_search_dists"))
    wide = f"{K91_ONLINE_TAG}:knn_merge_rows:c={TSNE_K ** 2}"
    if rec.launched.get(wide, 0) == 0:
        raise AssertionError(f"{K91_ONLINE_TAG}: no row merge at c = "
                             f"{TSNE_K ** 2}: {rec.launched}")
    store = res["store"]
    checks = check_live_lists(store, dels)
    live, truth = live_truth(x, store.alive, TSNE_K)
    recall = recall_at_k(store.nl.idx[live], truth)
    extra = noisy_queries(x, INSERT_BATCH, SEED + 23)
    prof = profile_run(lambda: knn_insert(
        store, extra, generator=torch.Generator(device=dev).manual_seed(
            SEED + 24)))
    ins, dl = res["insert"], res["delete"]
    build_evals = res["build_stats"].dist_evals
    ins_evals = sum(st.dist_evals for st in ins)
    del_evals = sum(st.dist_evals for st in dl)
    fields = {
        "n_base": N_BASE, "inserted": N - N_BASE,
        "insert_batch": INSERT_BATCH, "deleted": N_DELETE,
        "delete_batch": DELETE_BATCH, "live": int(live.numel()), "d": 784,
        "k": TSNE_K, "rho": descent.rho, "C": 2 * descent.rho_k,
        "cfg": dataclasses.asdict(cfg),
        "reduced": "the store's descent at path 22's settings (rho 0.5, "
                   "C 92) where path 8 builds at rho 1.0: the phase's "
                   "time goes to the updates, not to a second wide build",
        "wall_s": wall, "build_s": res["build_s"],
        "build_dist_evals": build_evals,
        "insert_s": {"median": statistics.median(res["insert_s"]),
                     "max": max(res["insert_s"]), "all": res["insert_s"]},
        "delete_s": res["delete_s"],
        "insert": {"dist_evals": ins_evals,
                   "frontier_rows": sum(st.frontier_rows for st in ins),
                   "padded_rows": sum(st.padded_rows for st in ins)},
        "delete": {"dist_evals": del_evals,
                   "frontier_rows": sum(st.frontier_rows for st in dl),
                   "padded_rows": sum(st.padded_rows for st in dl)},
        "insert_evals_over_build": ins_evals / build_evals,
        "delete_evals_over_build": del_evals / build_evals,
        "max_memory_allocated": peak, "launches": launches,
        "wide_row_merge_launches": rec.launched[wide],
        "recall_at_91": recall,
        "profiled_insert": {k: prof[k] for k in (
            "device_idle_share", "profiled_wall_s", "device_busy_s",
            "device_kernel_calls")},
        **checks}
    emit(K91_ONLINE_TAG, **fields)
    if recall < 0.84:
        raise AssertionError(f"{K91_ONLINE_TAG}: {fields}")
    e = check_kernel("knn_merge_rows", rec.calls[wide], reps=20)
    e.update(route="cuda", source=SOURCES["knn_merge_rows"],
             replaces=REPLACES["knn_merge_rows"],
             launches=rec.launched[wide], path=K91_ONLINE_TAG, call=wide,
             calls_at_this_key=rec.seen[wide],
             launches_at_this_key=rec.launched[wide])
    emit("kernels", **e)
    return [e]


def knn_build_k91_run(x, dev):
    """Path 22: build_knn_graph(k=91) on path 1's corpus, driven, its
    graph checked and scored against an exact k-NN, then built once more
    under the profiler (idle share; the wide join's and the resident
    select's device time, each > 0); its line printed. Returns its
    kernel rows."""
    import torch
    from repro_torch import DescentConfig, build_knn_graph, recall_at_k
    cfg = DescentConfig(k=TSNE_K)
    g = torch.Generator(device=dev).manual_seed(SEED)
    (dist, idx, st), wall, launches, peak, rec = drive(
        K91_TAG, lambda: build_knn_graph(x, k=TSNE_K, cfg=cfg, generator=g))
    require_launched(K91_TAG, launches, TRAIN_KERNELS)
    c_all = 2 * cfg.rho_k
    widths = {k for k in rec.calls if ":knn_join_select:" in k}
    want = {f"{K91_TAG}:knn_join_select:W={w}:c={c}" for w, c in (
        (2 * c_all * c_all, cfg.merge_k), (TSNE_K ** 2, 6 * TSNE_K))}
    join_c = rec.calls[f"{K91_TAG}:knn_join_dists"][2].shape[1]
    if widths != want or join_c != c_all:
        raise AssertionError(f"{K91_TAG}: join C {join_c}, selects {widths}")
    graph_err = check_graph(x, dist, idx, repeats_ok=True)
    repeated = int((idx.sort(dim=1).values.diff(dim=1) == 0).any(1).sum())
    del dist
    recall = recall_at_k(idx, exact_knn(x, TSNE_K))
    del idx
    prof = profile_run(lambda: build_knn_graph(
        x, k=TSNE_K, cfg=cfg,
        generator=torch.Generator(device=dev).manual_seed(SEED)))
    variants = {v: prof["our_kernels_s"][v] for v in (
        "knn_join_dists_wide", "knn_join_select_resident")}
    fields = {"n": x.shape[0], "d": x.shape[1], "k": TSNE_K, "rho": cfg.rho,
              "C": c_all, "merge_k": cfg.merge_k, "wall_s": wall,
              "iters": st.iters, "updates": list(st.updates),
              "polish_updates": list(st.polish_updates),
              "dist_evals": st.dist_evals, "max_memory_allocated": peak,
              "launches": launches, "recall_at_91": recall,
              "dist_err_over_tol": graph_err,
              "rows_with_a_repeated_id": repeated,
              "device_idle_share": prof["device_idle_share"],
              "profiled_wall_s": prof["profiled_wall_s"],
              "variant_device_s": variants}
    emit(K91_TAG, **fields)
    if recall < 0.84 or not all(variants.values()):
        raise AssertionError(f"{K91_TAG}: {fields}")
    return kernel_rows(rec, launches, TRAIN_KERNELS)


def dryrun_check() -> list:
    """The dry-run (launch/dryrun.py) of DRYRUN_CELLS on the single-pod
    meta mesh: each record's roofline line (JAX's ``_print_rec``), its
    memory a chip and the seconds the count took. Fails if the card's
    allocated memory moved (nothing is allocated on meta)."""
    import torch
    from repro_torch.launch import dryrun
    before = torch.cuda.memory_allocated()
    out = []
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.lower_cell(arch, shape, False)
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun_check: {arch} x {shape}: {rec}")
        out.append({"cell": f"{arch} x {shape} x single",
                    "line": dryrun.summary_line(rec),
                    "roofline": rec["roofline"], "memory": rec["memory"],
                    "depth": rec["depth"],
                    "counter": rec["counter"], "count_s": rec["compile_s"]})
    if torch.cuda.memory_allocated() != before:
        raise AssertionError("dryrun_check: the card's allocated memory "
                             f"moved ({before} -> "
                             f"{torch.cuda.memory_allocated()})")
    return out


def meta_twin(tree):
    """``tree`` (dicts, lists, tuples, NamedTuples of tensors) with each
    tensor a meta tensor of its shape, strides and dtype."""
    import torch
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: meta_twin(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [meta_twin(v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return tree


def tree_bytes(tree) -> int:
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def roofline_lane(call: str, run, seconds: float, model_flops: float,
                  kernels, meta_run=None, args=None, work_bound_s=None,
                  **extra) -> dict:
    """roofline_check: one untimed call of ``run`` on the card under the
    op-level cost counter (after its phase's timed runs, whose seconds
    are ``seconds``), the kernels ``kernels`` required among its
    launches; its Roofline (launch/roofline.py: one chip) beside the
    seconds. The counted roofline is this implementation's traffic (every
    eager op's bytes), not a bound on the work: with ``work_bound_s``
    (the work's own least time, which no change of the implementation
    moves) the seconds stand beside it too. With ``meta_run`` (the same call on meta twins of its
    inputs, the dry-run's count of the same cut) the two counts must be
    equal, FLOPs (by dtype) and bytes; with ``args`` (the call's inputs)
    the dry-run's peak estimate (their bytes plus the tracker's peak on
    meta) stands beside the allocator's peak, and the tracker's peak
    beside the allocator's rise above what was allocated before the call
    (other phases' tensors are alive too)."""
    import torch
    from repro_torch.kernels import _lib
    from repro_torch.launch import op_cost
    from repro_torch.launch.roofline import roofline_from_cost
    torch.cuda.synchronize()
    before = dict(_lib.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    allocated = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with op_cost.counting() as counter:
        run()
        torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in _lib.LAUNCHES.items()}
    require_launched(f"roofline_check {call}", launched, kernels)
    card = counter.cost
    rl = roofline_from_cost(card, 1, model_flops)
    fields = {"call": call, "seconds": seconds, "counted_call_s": counted_s,
              "launches": {k: v for k, v in launched.items() if v},
              "card": card.totals(), "roofline": rl.as_dict(),
              "step_time_s": rl.step_time, "bottleneck": rl.bottleneck,
              "seconds_over_roofline": seconds / rl.step_time,
              "work_bound_s": work_bound_s,
              "seconds_over_work_bound": seconds / work_bound_s
              if work_bound_s else None,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "peak_above_allocated": torch.cuda.max_memory_allocated()
              - allocated, **extra}
    if meta_run is not None:
        meta = op_cost.analyze(meta_run)
        fields["meta"] = meta.totals()
        fields["meta_equal"] = (
            (meta.flops, meta.bytes, dict(meta.flops_by_dtype))
            == (card.flops, card.bytes, dict(card.flops_by_dtype)))
        if not fields["meta_equal"]:
            raise AssertionError(
                f"roofline_check {call}: the card counted {card.flops} "
                f"FLOPs, {card.bytes} bytes; meta {meta.flops}, "
                f"{meta.bytes}")
        if args is not None:
            fields["peak_estimate_bytes"] = tree_bytes(args) \
                + meta.peak_bytes
            fields["peak_above_args_estimate"] = meta.peak_bytes
    emit("roofline_check", **fields)
    return fields


def roofline_lm_lanes(params, cfg, prompt) -> None:
    """roofline_check's serving lanes: one prefill of ``prompt`` (an
    lm_serve prompt) through the bf16 attention kernel, then one decode
    step on its cache; each timed once, then counted on the card and on
    meta."""
    import torch
    from repro_torch.models import active_param_count
    from repro_torch.serve import prefill, serve_step
    dev = params["embed"]["table"].device
    batch = {"tokens": torch.as_tensor(prompt, dtype=torch.int32,
                                       device=dev)[None]}
    n = active_param_count(cfg)
    seq = batch["tokens"].shape[1]

    def run_prefill(p=params, b=batch):
        return prefill(p, b, cfg, LM_MAX_LEN, last_only=True)
    (logits, cache, lengths), secs = timed(run_prefill)
    roofline_lane("lm_serve prefill", run_prefill, secs, 2.0 * n * seq,
                  ("flash_attention",),
                  meta_run=lambda: run_prefill(meta_twin(params),
                                               meta_twin(batch)),
                  tokens=seq)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

    def run_step(p=params, c=cache, t=tok, n_=lengths):
        return serve_step(p, c, t, n_, cfg)
    _, secs = timed(run_step)
    roofline_lane("lm_serve decode step", run_step, secs, 2.0 * n, (),
                  meta_run=lambda: run_step(meta_twin(params),
                                            meta_twin(cache),
                                            meta_twin(tok),
                                            meta_twin(lengths)),
                  slots=1, max_len=LM_MAX_LEN)



def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global PEAK_BYTES_PER_S, PEAK_FP32_PER_S, PEAK_BF16_PER_S, \
        PEAK_INT8_PER_S
    from repro_torch.launch.roofline import (
        HBM_BW as PEAK_BYTES_PER_S,
        PEAK_FLOPS_BF16 as PEAK_BF16_PER_S,
        PEAK_FLOPS_FP32 as PEAK_FP32_PER_S,
        PEAK_OPS_INT8 as PEAK_INT8_PER_S,
    )
    from repro_torch import (
        DescentConfig,
        OnlineConfig,
        RouterConfig,
        SearchConfig,
        brute_force_knn,
        build_knn_graph,
        graph_search,
        recall_at_k,
    )
    from repro_torch.core import datasets
    from repro_torch.core.device import pin_fp32
    from repro_torch.kernels import _lib, ref

    pin_fp32()
    dev = torch.device("cuda")

    # -- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         capability=list(cap), torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 card; got capability {cap}")

    # -- sharding_check: the rules on the production meshes, no storage
    emit("sharding_check", **sharding_check())

    # -- dryrun_check: the dry-run's cells on meta, no storage
    emit("dryrun_check", cells=dryrun_check())

    # -- build_lib
    _lib.build(force=True)
    _lib.lib()
    so = Path(_lib.build_info["path"])
    sass = {op: _lib.sass_functions(so, op)
            for op in ("HGMMA", "HMMA", "IMMA")}
    hgmma = {k: v for k, v in sass["HGMMA"].items()
             if k.startswith("flash_attention")}
    # the joins: the bf16 one on the tensor cores, the fp32 one never
    hmma = {k: v for k, v in sass["HMMA"].items()
            if k.startswith(("knn_join_dists<", "knn_join_dists_wide",
                             "knn_join_dists_bf16"))}
    # the int8 join on the tensor cores (s8 mma.sync)
    imma = {k: v for k, v in sass["IMMA"].items()
            if k.startswith("knn_join_dists_q8")}
    # the f32 attention: fp32 on the CUDA cores, no tensor-core opcode
    f32_attn = {f"{op}:{k}": v for op, counts in sass.items()
                for k, v in counts.items() if k.startswith("flash_attention<")}
    # the fp32 search tile (16- and 4-byte loads): fp32 on the CUDA cores,
    # no tensor-core opcode
    f32_search = {f"{op}:{k}": v for op, counts in sass.items()
                  for k, v in counts.items()
                  if k.startswith("knn_search_dists<")}
    spills = {k: v.get("spill_store_bytes", 0)
              for k, v in _lib.build_info["kernels"].items()
              if k.startswith(("flash_attention<", "knn_join_dists_q8<"))}
    search_tiles = {k: v for k, v in _lib.build_info["kernels"].items()
                    if k.split("<")[0] in SEARCH_TILES}
    compactions = {k: v for k, v in _lib.build_info["kernels"].items()
                   if "<" in k and k.split("<")[0] in COMPACTIONS}
    # the joins above C 64 and the select above a padded W of 8192
    large_k = {k: v for k, v in _lib.build_info["kernels"].items()
               if k.split("<")[0].endswith(("_wide", "_stream"))}
    emit("build_lib", seconds=_lib.build_info["seconds"],
         path=str(so.relative_to(ROOT)),
         kernels=_lib.build_info["kernels"], hgmma_in_sass=hgmma,
         hmma_in_sass=hmma, imma_in_sass=imma,
         f32_attention_tensor_ops_in_sass=f32_attn,
         f32_search_tensor_ops_in_sass=f32_search,
         spill_store_bytes_of_new_instances=spills,
         search_tiles=search_tiles, compaction_instances=compactions,
         large_k_instances=large_k,
         ptxas_performance_notes=_lib.build_info["performance_notes"])
    sm90 = [v for k, v in hgmma.items()
            if k.startswith("flash_attention_sm90")]
    if not sm90 or not all(sm90):
        raise AssertionError(f"the bf16 attention kernel has no HGMMA: "
                             f"{hgmma}")
    bf16_join = [v for k, v in hmma.items() if "_bf16" in k]
    f32_join = [v for k, v in hmma.items() if "_bf16" not in k]
    if not bf16_join or not all(bf16_join) or not f32_join or any(f32_join):
        raise AssertionError(f"HMMA in the joins' SASS: {hmma} (the bf16 "
                             "join must have it, the fp32 join none)")
    if not imma or not all(imma.values()):
        raise AssertionError(f"the int8 join has no IMMA: {imma}")
    if not f32_attn or any(f32_attn.values()):
        raise AssertionError(f"tensor-core opcodes in the f32 attention "
                             f"kernel's SASS: {f32_attn}")
    if len(f32_search) != 6 or any(f32_search.values()):
        raise AssertionError(f"tensor-core opcodes in the fp32 search "
                             f"tile's SASS: {f32_search}")
    q8_tile = search_tiles.get("knn_search_dists_q8", {})
    if q8_tile.get("registers", 99) > 64 or q8_tile.get(
            "spill_store_bytes", 0):
        raise AssertionError(f"the int8 search tile passes 64 registers "
                             f"or spills: {q8_tile}")

    # -- build_check: kernels vs plain versions, same generator seed
    xc = datasets.mnist_like(CHECK_N, 784, seed=SEED + 1,
                             device=dev)
    truth_c = exact_knn(xc, 20)
    check = {"auto": {"seconds": []}, "plain": {"seconds": []}}
    for backend in ("plain", "auto", "auto", "plain"):   # in turns
        g = torch.Generator(device=dev).manual_seed(SEED)
        cfg = DescentConfig(k=20, rho=1.0, backend=backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, idx, st = build_knn_graph(xc, k=20, cfg=cfg, generator=g)
        torch.cuda.synchronize()
        check[backend]["seconds"].append(time.perf_counter() - t0)
        check[backend].update(recall=recall_at_k(idx, truth_c),
                              iters=st.iters, dist_evals=st.dist_evals)
        if backend == "auto":
            idx_c = idx
    gap = abs(check["auto"]["recall"] - check["plain"]["recall"])
    emit("build_check", n=CHECK_N, d=784, k=20, rho=1.0,
         kernels=check["auto"], plain=check["plain"], recall_gap=gap)
    if gap > 0.01 or min(v["recall"] for v in check.values()) < 0.84:
        raise AssertionError(f"build_check failed: {check}")
    # the quantized builds, kernels and plain versions, same seed
    for prec in PRECISIONS:
        qcheck = {}
        for backend in ("plain", "auto"):
            g = torch.Generator(device=dev).manual_seed(SEED)
            cfg = DescentConfig(k=20, rho=1.0, backend=backend,
                                precision=prec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist, idx, st = build_knn_graph(xc, k=20, cfg=cfg, generator=g)
            torch.cuda.synchronize()
            qcheck[backend] = {
                "seconds": time.perf_counter() - t0,
                "recall": recall_at_k(idx, truth_c), "iters": st.iters,
                "dist_evals": st.dist_evals,
                "dist_err_over_tol": check_graph(xc, dist, idx,
                                                 repeats_ok=True),
                "rows_with_a_repeated_id": int(
                    (idx.sort(dim=1).values.diff(dim=1) == 0).any(1).sum())}
        qgap = abs(qcheck["auto"]["recall"] - qcheck["plain"]["recall"])
        emit("build_check", n=CHECK_N, d=784, k=20, rho=1.0, precision=prec,
             kernels=qcheck["auto"], plain=qcheck["plain"], recall_gap=qgap,
             f32_kernels_recall=check["auto"]["recall"])
        if qgap > 0.01 or qcheck["auto"]["recall"] < \
                check["auto"]["recall"] - 0.02:
            raise AssertionError(f"build_check {prec} failed: {qcheck}")
    # the lexsort "ref" path: one iteration against the kernels' from one
    # state and one set of draws, then a whole build beside the fused one
    emit("build_check", n=CHECK_N, d=784, k=20, rho=1.0,
         lane="ref_iteration", **ref_iteration_check(xc, dev))
    _lib.reset_launches()
    (_, idx, st), ref_s = timed(lambda: build_knn_graph(
        xc, k=20, cfg=DescentConfig(k=20, rho=1.0, backend="ref"),
        generator=torch.Generator(device=dev).manual_seed(SEED)))
    ref_build = {"seconds": ref_s, "recall": recall_at_k(idx, truth_c),
                 "iters": st.iters, "dist_evals": st.dist_evals,
                 "launches": {k: v for k, v in _lib.LAUNCHES.items() if v}}
    emit("build_check", n=CHECK_N, d=784, k=20, rho=1.0, lane="ref_build",
         ref=ref_build, kernels={k: check["auto"][k] for k in (
             "seconds", "recall", "iters", "dist_evals")})
    if ref_build["launches"] or ref_build["recall"] < \
            check["auto"]["recall"] - 0.02:
        raise AssertionError(f"build_check ref build failed: {ref_build}")
    # the paper's heap and naive selections, through the kernels
    sel = {}
    for name in ("heap", "naive"):
        _lib.reset_launches()
        (_, idx, st), sec = timed(lambda: build_knn_graph(
            xc, k=20, cfg=DescentConfig(k=20, rho=1.0, selection=name),
            generator=torch.Generator(device=dev).manual_seed(SEED)))
        require_launched(f"build_check {name}", _lib.LAUNCHES,
                         ("knn_join_dists", "knn_join_select", "knn_merge"))
        sel[name] = {"seconds": sec, "recall": recall_at_k(idx, truth_c),
                     "iters": st.iters, "dist_evals": st.dist_evals}
    emit("build_check", n=CHECK_N, d=784, k=20, rho=1.0, lane="selection",
         turbo_recall=check["auto"]["recall"], **sel)
    if any(abs(v["recall"] - check["auto"]["recall"]) > 0.06
           for v in sel.values()):
        raise AssertionError(f"build_check selections failed: {sel}")
    del truth_c

    # -- search_check: kernels vs plain versions vs the greedy oracle
    scfg = SearchConfig(beam=32, rounds=48, expand=6, q_block=512)
    emit("search_check", n=CHECK_N, d=784, queries=CHECK_QUERIES, k_out=10,
         cfg=dataclasses.asdict(scfg), **search_check(xc, idx_c, scfg))
    del idx_c

    # -- online_check: the online path, kernels vs plain versions, and the
    # router's cluster shape
    emit("online_check", n=CHECK_N, d=784, base=CHECK_BASE,
         batch=CHECK_BATCH, **online_check(xc, dev))
    emit("online_check", shape="64 clusters x 784 rows, d 16",
         **cluster_router_check(dev))
    emit("persist", lane="quantized_first", n=CHECK_N, d=784,
         **quantized_first_check(xc, dev))
    del xc

    # -- attention_check: the attention kernel against its plain version
    f32_attention = {}
    emit("attention_check", batch=2,
         tolerance={"f32": ATTN_F32_TOL, "bf16": ATTN_BF16_TOL,
                    "rows_without_key": "exactly 0"},
         modes=attention_check(dev, f32_attention))

    # -- build: path 1, the build at the paper's headline shape
    x = datasets.mnist_like(N, 784, seed=SEED, device=dev)
    cfg = DescentConfig(k=20)
    g = torch.Generator(device=dev).manual_seed(SEED)
    (dist, idx, st), wall, launches_b, peak, rec_b = drive(
        "build", lambda: build_knn_graph(x, k=20, cfg=cfg, generator=g))
    st_wall = wall
    graph_err = check_graph(x, dist, idx)
    exact = exact_knn(x, 20)
    recall = recall_at_k(idx, exact)
    emit("build", n=N, d=784, k=20, rho=cfg.rho, wall_s=wall,
         iters=st.iters, updates=list(st.updates),
         polish_updates=list(st.polish_updates), dist_evals=st.dist_evals,
         reorder_host_s=rec_b.reorder_s, max_memory_allocated=peak,
         launches=launches_b, recall_at_20=recall,
         dist_err_over_tol=graph_err)
    require_launched("build", launches_b,
                     ("knn_join_dists", "knn_join_select", "knn_merge"))
    del dist

    # -- build_int8, build_bf16: paths 4-5, the two-stage quantized builds
    launches, recs = {"build": launches_b}, {"build": rec_b}
    for prec in PRECISIONS:
        tag = f"build_{prec}"
        qcfg = dataclasses.replace(cfg, precision=prec)
        g = torch.Generator(device=dev).manual_seed(SEED)
        (qd, qi, qst), wall, launches[tag], peak, recs[tag] = drive(
            tag, lambda: build_knn_graph(x, k=20, cfg=qcfg, generator=g))
        emit(tag, n=N, d=784, k=20, rho=qcfg.rho, precision=prec,
             wall_s=wall, f32_wall_s=st_wall, iters=qst.iters,
             updates=list(qst.updates),
             polish_updates=list(qst.polish_updates),
             dist_evals=qst.dist_evals, max_memory_allocated=peak,
             launches=launches[tag], recall_at_20=recall_at_k(qi, exact),
             f32_recall_at_20=recall,
             dist_err_over_tol=check_graph(x, qd, qi))
        lq = launches[tag]
        require_launched(tag, lq, (OWNED[tag], "knn_join_select",
                                   "knn_merge", "knn_search_dists"))
        # the fp32 join never runs (the polish scores with a plain batched
        # product); the fp32 tile runs once, the re-rank
        if lq["knn_join_dists"] != 0 or lq["knn_search_dists"] != 1:
            raise AssertionError(f"{tag}: fp32 launches {lq}")
        del qd, qi

    # -- truth: path 2, the exact k-NN through the pairwise kernel
    (td, ti), wall, launches_t, peak, rec_t = drive(
        "truth", lambda: brute_force_knn(x, x, 20, chunk=TRUTH_CHUNK))
    if not (torch.isfinite(td).all() and (td[:, 1:] >= td[:, :-1]).all()):
        raise AssertionError("truth: distances not finite and ascending")
    agree = recall_at_k(ti, exact)
    emit("truth", n=N, d=784, k=20, chunk=TRUTH_CHUNK, wall_s=wall,
         max_memory_allocated=peak, launches=launches_t,
         recall_vs_exact_knn=agree,
         build_recall_at_20={"brute_force_knn": recall_at_k(idx, ti),
                             "exact_knn": recall})
    require_launched("truth", launches_t, ("pairwise_sq_l2",))
    if agree < 0.999:
        raise AssertionError(f"truth: recall {agree} against exact_knn")
    del exact

    # -- search: path 3, the query path on the 70000-point graph
    q = noisy_queries(x, N_QUERIES, SEED + 4)
    (sd, si), wall, launches_s, peak, rec_s = drive(
        "search", lambda: graph_search(x, idx, q, k_out=10, cfg=scfg))
    require_launched("search", launches_s,
                     ("knn_search_dists", "knn_join_select", "knn_merge"))
    check_search(sd, si, N, 10)
    _, qt = brute_force_knn(x, q, 10, exclude_self=False, chunk=TRUTH_CHUNK)
    blocks = -(-N_QUERIES // scfg.q_block)
    emit("search", n=N, d=784, queries=N_QUERIES, k_out=10,
         cfg=dataclasses.asdict(scfg), wall_s=wall,
         queries_per_s=N_QUERIES / wall, blocks=blocks,
         # shared entries seed by one matrix product, so each launch of
         # the search tile is one round of one block
         rounds=launches_s["knn_search_dists"],
         rounds_per_block=launches_s["knn_search_dists"] / blocks,
         max_memory_allocated=peak, launches=launches_s,
         recall_at_10=recall_at_k(si, qt))
    f32_search = {"wall_s": wall, "recall_at_10": recall_at_k(si, qt)}

    # -- search_int8, search_bf16: paths 6-7, the two-stage quantized
    # searches on the f32 graph
    launches.update(truth=launches_t, search=launches_s)
    recs.update(truth=rec_t, search=rec_s)
    x2_full = (x * x).sum(1)
    q2_full = (q * q).sum(1)
    for prec in PRECISIONS:
        tag = f"search_{prec}"
        qscfg = dataclasses.replace(scfg, precision=prec)
        (qd, qi), wall, launches[tag], peak, recs[tag] = drive(
            tag, lambda: graph_search(x, idx, q, k_out=10, cfg=qscfg))
        check_search(qd, qi, N, 10)
        lq = launches[tag]
        tile = OWNED[tag]
        require_launched(tag, lq, (tile, "knn_join_select", "knn_merge"))
        if lq["knn_search_dists"] != blocks:
            raise AssertionError(f"{tag}: {lq['knn_search_dists']} fp32 "
                                 f"re-ranks for {blocks} blocks")
        exact_d = close_to_plain(
            f"{tag} returned distances", qd,
            ref.knn_search_dists(q, q2_full, x, x2_full, qi),
            q2_full[:, None] + x2_full[qi.long()])
        emit(tag, n=N, d=784, queries=N_QUERIES, k_out=10, precision=prec,
             cfg=dataclasses.asdict(qscfg), wall_s=wall,
             queries_per_s=N_QUERIES / wall, blocks=blocks,
             rounds=lq[tile], rounds_per_block=lq[tile] / blocks,
             max_memory_allocated=peak, launches=lq,
             recall_at_10=recall_at_k(qi, qt), f32=f32_search,
             fp32_distances=exact_d)
        del qd, qi

    # -- sharded: path 13, the sharded search and its breaker
    sharded, sharded_rows = sharded_run(
        x, idx, q, qt, (td, ti), (sd, si), f32_search["wall_s"], scfg, dev)
    emit("sharded", n=N, d=784, queries=N_QUERIES, k_out=10,
         cfg=dataclasses.asdict(scfg), **sharded)

    # -- sharded_build: path 14, the sharded NN-Descent build
    sharded_build, sharded_build_rows = sharded_build_run(
        x, ti, st_wall, recall_at_k(idx, ti), dev)
    emit("sharded_build", n=N, d=784, k=20, **sharded_build)
    del sd, si, qt, td, ti

    # -- online: path 8, the online store at MNIST's split sizes
    ocfg = OnlineConfig(router=RouterConfig())
    odescent = DescentConfig(k=20, rho=1.0, max_iters=15)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    dels = torch.randperm(N, generator=g, device=dev)[:N_DELETE]
    search_off = SearchConfig(beam=32, rounds=24, expand=ocfg.seed_expand,
                              q_block=ocfg.q_block, router="off")

    def online_run():
        return run_online(x, N_BASE, INSERT_BATCH, dels, DELETE_BATCH, ocfg,
                          odescent, queries=q, search_off=search_off)
    res, wall, launches["online"], peak, recs["online"] = drive(
        "online", online_run)
    require_launched("online", launches["online"], ONLINE_KERNELS + (
        "pairwise_sq_l2", "knn_search_dists", "knn_join_select",
        "knn_merge"))
    store = res["store"]
    dead_ids = dels.long()
    checks = check_live_lists(store, dels)
    live, truth = live_truth(x, store.alive, 20)
    online_recall = recall_at_k(store.nl.idx[live], truth)
    _, qtruth = brute_force_knn(x[live], q, 10, exclude_self=False,
                                chunk=TRUTH_CHUNK)
    qtruth = live[qtruth.long()]
    search = {}
    for key in ("search", "search_off"):
        sd, si = res[key]
        check_search(sd, si, N, 10)
        if torch.isin(si.long(), dead_ids).any():
            raise AssertionError(f"online {key}: a tombstoned id returned")
        search[key] = {"wall_s": res[key + "_s"],
                       "queries_per_s": N_QUERIES / res[key + "_s"],
                       "recall_at_10": recall_at_k(si, qtruth)}
    del sd, si
    # the yardstick: a from-scratch build of the live rows
    _, ridx, rst = build_knn_graph(
        x[live], k=20, cfg=odescent,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    rebuild_recall = recall_at_k(live[ridx.long()], truth)
    ins, dl = res["insert"], res["delete"]
    ins_evals = sum(st.dist_evals for st in ins)
    emit("online", n_base=N_BASE, inserted=N - N_BASE,
         insert_batch=INSERT_BATCH, deleted=N_DELETE,
         delete_batch=DELETE_BATCH, live=int(live.numel()), d=784, k=20,
         cfg=dataclasses.asdict(ocfg), wall_s=wall,
         build_s=res["build_s"], build_dist_evals=res[
             "build_stats"].dist_evals,
         centroids=int(store.router.centroids.shape[0]),
         capacity=sorted(set(res["capacity"])),
         insert_s={"median": statistics.median(res["insert_s"]),
                   "max": max(res["insert_s"]), "all": res["insert_s"]},
         delete_s=res["delete_s"],
         insert={"dist_evals": ins_evals,
                 "frontier_rows": sum(st.frontier_rows for st in ins),
                 "padded_rows": sum(st.padded_rows for st in ins)},
         delete={"dist_evals": sum(st.dist_evals for st in dl),
                 "frontier_rows": sum(st.frontier_rows for st in dl),
                 "padded_rows": sum(st.padded_rows for st in dl)},
         router_stale=store.router.stale, search=search,
         max_memory_allocated=peak, launches=launches["online"],
         recall_at_20=online_recall,
         rebuild={"recall_at_20": rebuild_recall,
                  "dist_evals": rst.dist_evals,
                  "insert_evals_over_rebuild": ins_evals / rst.dist_evals},
         **checks)
    del ridx

    # -- persist: the online path's final store, snapshotted and restored
    emit("persist", lane="online_store", queries=N_QUERIES,
         insert_batch=INSERT_BATCH, **persist_check(
             store, q, noisy_queries(x, INSERT_BATCH, SEED + 21),
             res["build_s"]))

    # -- retrieval: path 11, the retrieval scheduler on that store
    rres, wall, launches["retrieval"], peak, _ = drive(
        "retrieval", lambda: retrieval_run(
            store, q, qtruth, dels,
            noisy_queries(x, INSERT_BATCH, SEED + 22)))
    require_launched("retrieval", launches["retrieval"], (
        "knn_search_dists", "knn_join_select", "knn_merge",
        "pairwise_sq_l2", "knn_merge_rows"))
    emit("retrieval", n=store.n, live=store.live_count(), d=784,
         queries=N_QUERIES, k_out=10, cfg=dataclasses.asdict(
             SearchConfig(beam=32, rounds=48, expand=6, q_block=512)),
         wall_s=wall, max_memory_allocated=peak,
         launches=launches["retrieval"], **rres)
    del res, store, qtruth

    # -- profile: the builds and the searches again under torch.profiler
    for prec in ("f32",) + PRECISIONS:
        suffix = "" if prec == "f32" else f"_{prec}"
        bcfg = dataclasses.replace(cfg, precision=prec)
        qscfg = dataclasses.replace(scfg, precision=prec)
        emit("profile", path="build" + suffix, **profile_run(
            lambda: build_knn_graph(
                x, k=20, cfg=bcfg,
                generator=torch.Generator(device=dev).manual_seed(SEED))))
        emit("profile", path="search" + suffix, **profile_run(
            lambda: graph_search(x, idx, q, k_out=10, cfg=qscfg)))
    emit("profile", path="online", **profile_run(online_run))

    # -- large_k_check and path 22 (knn_build_k91): t-SNE's k = 91 graph
    xc = datasets.mnist_like(CHECK_N, 784, seed=SEED + 1, device=dev)
    emit("large_k_check", n=CHECK_N, d=784, lane="kernels",
         **large_k_kernel_check(xc, dev))
    merge_rows, call_3d = large_k_merge_check(dev)
    emit("large_k_check", lane="merges", merges=merge_rows)
    fields, quant_recs = large_k_build_check(xc, dev)
    emit("large_k_check", n=CHECK_N, d=784, k=TSNE_K, lane="builds",
         **fields)
    emit("large_k_check", n=CHECK_N, d=784, k=TSNE_K, lane="online",
         **large_k_online_check(xc, dev))
    k91_rows = [e for rec, lq, name in quant_recs
                for e in kernel_rows(rec, lq, (name,))]
    # row 3d: the dense merge at the online pool, timed on a check lane's
    # call; its launches are the main paths' dense merges above a pool of
    # MERGE_MAX_POOL, read once every path has run
    row_3d = check_kernel("knn_merge", call_3d, reps=20)
    row_3d.update(route="cuda", source=SOURCES["knn_merge"],
                  replaces=REPLACES["knn_merge"], path="large_k_check",
                  call=f"large_k_check:knn_merge:c={call_3d[2].shape[1]}")
    k91_rows.append(row_3d)
    del xc, quant_recs, call_3d
    k91_rows += knn_build_k91_run(x, dev)
    k91_rows += online_k91_run(x, dev)
    del x, idx, q, x2_full, q2_full, dels
    gc.collect()
    torch.cuda.empty_cache()

    # -- the LM paths: yi-6b at full width, weights drawn from the seed
    # (no published weights in the repository), matrices cast to bf16
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import load_params, serve_requests
    from repro_torch.models import param_count
    lm_cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = load_params(lm_cfg, dev)
    torch.cuda.synchronize()
    emit("lm_model", arch=LM_ARCH, params=param_count(lm_cfg),
         init_s=time.perf_counter() - t0,
         memory_allocated=torch.cuda.memory_allocated(),
         cfg={k: str(v) for k, v in dataclasses.asdict(lm_cfg).items()})

    # -- lm_check: prefill and decode through the kernel vs the plain scan
    emit("lm_check", arch=LM_ARCH, prompt=LM_CHECK_LEN,
         steps=LM_CHECK_STEPS, **lm_check(params, lm_cfg, dev))

    # -- lm_serve: path 9, the server at full width
    prompts = lm_prompts(lm_cfg)

    def lm_serve_run():
        return serve_requests(params, lm_cfg, prompts, slots=LM_SLOTS,
                              max_len=LM_MAX_LEN, max_new=LM_MAX_NEW)
    (reqs, stats), wall, launches["lm_serve"], peak, recs["lm_serve"] = \
        drive("lm_serve", lm_serve_run)
    check_served(reqs, stats, launches["lm_serve"], lm_cfg)
    served_outs = [r.out for r in reqs]
    served_tps = stats["decode_tokens_per_s"]
    emit("lm_serve", arch=LM_ARCH, slots=LM_SLOTS, max_len=LM_MAX_LEN,
         requests=LM_REQUESTS, max_new=LM_MAX_NEW,
         **served_fields(prompts, stats, wall),
         max_memory_allocated=peak, launches=launches["lm_serve"])
    # a short window of the same server: processing the whole run's
    # profile (about 100k events) took 150 s of host time
    emit("profile", path="lm_serve",
         window=f"{LM_SLOTS} requests, {LM_PROFILE_NEW} new tokens",
         **profile_run(lambda: serve_requests(
             params, lm_cfg, prompts[:LM_SLOTS], slots=LM_SLOTS,
             max_len=LM_MAX_LEN, max_new=LM_PROFILE_NEW)))
    del reqs, stats

    # -- roofline_check: a prefill and a decode step counted on the card
    roofline_lm_lanes(params, lm_cfg, prompts[0])

    # -- knn_lm: path 10, kNN-LM retrieval over the port's graph
    res, wall, launches["knn_lm"], peak, recs["knn_lm"] = drive(
        "knn_lm", lambda: knn_lm_run(params, lm_cfg, dev, SEED + 12))
    require_launched("knn_lm", launches["knn_lm"], (
        "flash_attention", "knn_join_dists", "knn_join_select", "knn_merge",
        "knn_search_dists"))
    emit("knn_lm", arch=LM_ARCH, sequences=KNN_SEQS, seq_len=KNN_SEQ_LEN,
         keys=res["keys"], d=lm_cfg.d_model, k=KNN_K,
         queries=int(res["q"].shape[0]), k_out=8, beam=32, rounds=24,
         wall_s=wall, **res["timing"], build_stats=res["ds"].build_stats,
         log_likelihood=res["ll"], max_memory_allocated=peak,
         launches=launches["knn_lm"], **knn_lm_recall(res),
         restore=knn_lm_restore(res, lm_cfg.vocab))

    # -- knn_grow: path 12, the datastore grown while the LM decodes
    gres, wall, launches["knn_grow"], peak, _ = drive(
        "knn_grow", lambda: knn_grow_run(params, lm_cfg, dev, res, prompts))
    require_launched("knn_grow", launches["knn_grow"], (
        "flash_attention", "knn_join_dists", "knn_join_select", "knn_merge",
        "knn_search_dists", "knn_merge_rows", "pairwise_sq_l2"))
    outs = gres.pop("outs")
    emit("knn_grow", arch=LM_ARCH, slots=LM_SLOTS, requests=LM_REQUESTS,
         max_new=LM_MAX_NEW, d=lm_cfg.d_model, k=KNN_K, chunk=KNN_CHUNK,
         snapshot_every=KNN_SNAPSHOT_EVERY, wall_s=wall,
         lm_serve_decode_tokens_per_s=served_tps,
         requests_with_lm_serve_tokens=sum(
             a == b for a, b in zip(outs, served_outs)),
         max_memory_allocated=peak, launches=launches["knn_grow"], **gres)
    del res, params
    # knn_grow's batcher and its step function hold each other (a cycle
    # through the step's closure), and with them yi-6b's weights: collect
    # them before the next model loads
    gc.collect()
    torch.cuda.empty_cache()

    launches["lm_gemma2"], recs["lm_gemma2"] = dense_family_run(dev)
    moe_launches, moe_recs = moe_family_run(dev)
    launches.update(moe_launches)
    recs.update(moe_recs)
    launches["lm_zamba2"], recs["lm_zamba2"] = ssm_family_run(dev)
    fe_launches, fe_recs = frontend_family_run(dev)
    launches.update(fe_launches)
    recs.update(fe_recs)
    launches["train"], recs["train"] = train_family_run(dev)

    # -- kernels: each against its plain version on the recorded inputs
    owner = {"pairwise_sq_l2": "truth", "knn_search_dists": "search",
             **QUANT_OWNER, **dict.fromkeys(ONLINE_KERNELS, "online"),
             "flash_attention": "lm_serve"}
    entries = {}
    selects = {}       # (W, c) -> entry, from the first of SELECT_PATHS
    calls = {k: c for rec in recs.values() for k, c in rec.calls.items()}
    kwargs = {k: c for rec in recs.values() for k, c in rec.kwargs.items()}
    seen = {k: c for rec in recs.values() for k, c in rec.seen.items()}
    launched = {k: c for rec in recs.values()
                for k, c in rec.launched.items()}
    # the per-(W, c) select launches add up to each path's count, and so
    # do the online path's row merges by c and its pairwise tiles (direct
    # calls and centroid_assign's)
    for tag, name in [*((t, "knn_join_select") for t in SELECT_PATHS),
                      ("train", "knn_join_select"),
                      ("online", "knn_merge_rows"),
                      ("online", "pairwise_sq_l2")]:
        per_key = sum(c for k, c in launched.items()
                      if k == f"{tag}:{name}" or k.startswith(
                          f"{tag}:{name}:"))
        if per_key != launches[tag][name]:
            raise AssertionError(
                f"{tag}: {name} launches by width sum to {per_key}, the "
                f"path launched {launches[tag][name]}")
    merges = {}        # c -> entry, the online path's row merges
    further = {}       # key -> entry, the calls of FURTHER_ROWS
    late = {}          # name -> entry, the search tiles at LATE_ROUND
    train_rows = {}    # key -> entry, path 20's build (semantic_order)
    for key, call in sorted(calls.items()):
        tag, name = key.split(":")[:2]
        if tag in CHECKED and name not in CHECKED[tag]:
            continue
        if name == "flash_attention":
            e = check_attention_kernel(call, kwargs[key], reps=20)
        else:
            e = check_kernel(name, call, reps=20)
        base = key.split(":round=")[0]
        e.update(route="cuda", source=SOURCES[name],
                 replaces=REPLACES[name], launches=launches[tag][name],
                 path=tag, call=key, calls_at_this_key=seen[base],
                 launches_at_this_key=launched[base])
        emit("kernels", **e)
        if base != key:
            # a second reading of the launches the round-2 entry counts
            late[name] = {**e, "launches": 0}
            continue
        if name == "knn_join_select" and tag in SELECT_PATHS:
            wc = tuple(key.split(":")[2:])
            prev = selects.get(wc)
            if prev is None or SELECT_PATHS.index(tag) < SELECT_PATHS.index(
                    prev["path"]):
                selects[wc] = e
        if tag == "online" and name == "knn_merge_rows":
            # each width's entry carries that width's launches
            merges[int(key.split(":c=")[1])] = {
                **e, "launches": e["launches_at_this_key"]}
        if key in FURTHER_ROWS.get(name, ()):
            further[key] = {**e, "launches": e["launches_at_this_key"]}
        if key in (*GEMMA_KEYS, *MOE_KEYS, *ZAMBA_KEYS, *FRONTEND_KEYS):
            further[key] = {**e, "launches": e["launches_at_this_key"]}
        if tag == "train":
            # rows of their own: each key with its own launches
            train_rows[key] = {**e, "launches": e["launches_at_this_key"]}
            continue
        # the line keeps one entry per kernel, from the path that owns
        # it; the build's widest select (the receiver select) and the
        # online path's widest row merge stand for their kernels
        if tag != owner.get(name, "build"):
            continue
        if name == "knn_merge_rows":
            e = merges[int(key.split(":c=")[1])]
        if name not in entries or width_of(e) > width_of(entries[name]):
            entries[name] = e
    missing = [k for keys in (*FURTHER_ROWS.values(), GEMMA_KEYS, MOE_KEYS,
                              ZAMBA_KEYS, FRONTEND_KEYS)
               for k in keys if k not in further]
    missing += [k for k in LATE_KEYS if k.split(":")[1] not in late]
    missing += [f"train:{n}" for n in TRAIN_KERNELS
                if not any(k.split(":")[1] == n for k in train_rows)]
    if missing:
        raise AssertionError(f"no second call recorded at {missing}")
    # flash_attention at f32: the SIMT kernel on attention_check's inputs
    f32 = check_attention_kernel(f32_attention["args"],
                                 f32_attention["kwargs"], reps=20)
    f32.update(route="cuda", source=F32_ATTENTION_SOURCE,
               replaces=REPLACES["flash_attention"],
               launches=f32_attention["f32_launches"],
               path="attention_check",
               call=f"attention_check:flash_attention:{ATTN_F32_KERNEL_MODE}"
                    ":float32")
    emit("kernels", **f32)
    entries["flash_attention"]["call"] += ":bfloat16"
    row_3d.update(launches=sum(DRIVEN_WIDE_MERGES.values()),
                  launches_by_path={
                      t: v for t, v in DRIVEN_WIDE_MERGES.items() if v})
    emit("kernels", **row_3d)
    line = []
    for n in _lib.KERNELS:
        line.append(entries[n])
        if n == "flash_attention":
            line.append(f32)
            line.extend(further[k] for k in (*GEMMA_KEYS, *MOE_KEYS,
                                             *ZAMBA_KEYS, *FRONTEND_KEYS))
        if n == "knn_join_select":
            # every other recorded (W, c), with that width's launches
            for wc, e in sorted(selects.items(),
                                key=lambda kv: int(kv[0][0][2:])):
                if e is not entries[n]:
                    line.append(
                        {**e, "launches": e["launches_at_this_key"]})
            line.extend(sharded_build_rows)
        line.extend(further[k] for k in FURTHER_ROWS.get(n, ()))
        line.extend(e for k, e in sorted(train_rows.items())
                    if k.split(":")[1] == n)
        if n == "pairwise_sq_l2":
            line.extend(sharded_rows)
        if n in late:
            line.append(late[n])
        if n == "knn_merge_rows":
            # every other recorded c of the online path
            line.extend(e for c, e in sorted(merges.items())
                        if e is not entries[n])
        # path 22's calls and the k = 91 quantized builds' joins
        line.extend(e for e in k91_rows if e["name"] == n)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call")
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in keys},
         **{k: e[k] for k in SEARCH_FIELDS if k in e}} for e in line]}),
          flush=True)

    if any(m in ("jax", "ml_dtypes")
           or m.startswith(("jax.", "repro.", "ml_dtypes."))
           for m in sys.modules):
        raise AssertionError("the port imported JAX, the JAX package or "
                             "ml_dtypes")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--restore-child"]:
        sys.exit(restore_child(*sys.argv[2:4]))
    sys.exit(main())
