"""Drive the PyTorch/CUDA port on one H100 and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

1. print the card's name and power limit; build every CUDA kernel from
   ``zero_transformer_tpu_torch/csrc`` with nvcc (one process per source,
   in parallel) and print the build time;
2. kernels: hold each kernel against its plain PyTorch version at the
   serving path's shapes and on edge cases, in bf16 (atol/rtol 2e-2) and
   float32 (atol 1e-4); hold the bf16 tensor-core flash kernel besides to
   an emulation of its own rounding (one bf16 ulp plus 2^-13 per output,
   at most 0.1 % of outputs different) and show that this check catches a
   causal limit or validity mask one key off; K1 twice on the same inputs
   writes the same bits; K4 (paged decode) also on a ``long`` case (B 4,
   8192 keys, 8 query heads on 2 kv heads of 128: full 8-CTA clusters
   streaming through the kernel's ring) and on clusters of 3 and of 1 CTA,
   and twice on the same inputs writes the same bits (main and long); time
   kernel, plain version and a PyTorch library call computing the same
   function (a yardstick only), and K4's device time both hot and cold
   (the calls rotate over copies of the pools that together touch twice
   the 50 MB L2, as the decode tick's layers each read their own pools);
3. serving: seed-initialise the ``125m`` zoo model in bf16, start the port's
   engine and HTTP server on 127.0.0.1 (4 slots, cache 1024, page 16,
   chunk 64) and answer concurrent greedy ``POST /generate`` requests; the
   kernel launch counts are zeroed just before and read just after, and
   both kernels must have run;
4. parity: the same model with ``attention_impl="xla"`` (the plain path)
   against the kernels on prefill logits and four decode steps: float32
   within atol 1e-4, bf16 no farther from the float32 plain path than the
   bf16 plain path plus 2e-2; then greedy agreement of a whole engine run;
5. profile: ten decode ticks of four streams under ``torch.profiler``:
   device busy time per tick against the ticks' wall time;
6. training kernels: the differentiable flash entry (K1 with lse, K2 dq,
   K3 dk/dv) through ``torch.autograd`` against ``flash_reference`` and
   ``flash_bwd_reference`` at the training shape (B 8, T = S = 1024, 12
   heads of 64, bf16), at 580m's one-card shape (B 1, T = S 8192, 12 heads
   of 128, bf16) and on GQA, non-ALiBi, non-causal, ragged-T and D 128
   cases: float32 within atol 1e-4; bf16 K1 within the emulation bar of
   phase 2 plus one p-rounding flip (phase 8's), which at both timed shapes
   must reject a causal limit or validity mask one key off; bf16 K2/K3
   within one bf16 ulp plus 6e-3 of the largest |grad| of the float32
   reference on the same o and lse, and at both timed shapes the same bar
   must reject a reference whose causal limit is one key off; K1, K2 and K3
   twice on the same inputs write the same bits; times of kernel, plain
   version and the backward of
   ``scaled_dot_product_attention`` with the ALiBi float bias (a yardstick);
7. training: ``125m`` at full width and depth, bf16 over float32 master
   params, seed-0 weights: (a) one micro-batch's loss and grads through the
   kernels against the plain path (``attention_impl="xla"``) in bf16 and in
   float32; (b) the launch counts of one optimizer step of B 8 x accum 4 x
   T 1024 (12 x accum each for ``flash_train_fwd``, ``flash_dq``,
   ``flash_dkv``); (c) the loss over 20 steps on one repeated batch at a
   constant learning rate must fall, and two steps run under
   ``torch.profiler`` (device busy share, largest kernels); (d) the trainer CLI on
   ``configs/train_125m.yaml`` with synthetic data takes a few steps and
   reports tokens/s, step ms and the model-FLOPs share of 989 TFLOP/s;
8. packed kernels: K1 (with lse), K2 and K3 with the packed-document mask
   (``doc_ids``) through ``torch.autograd`` against their plain versions at
   ``byte_25m``'s training shape (B 32, T = S 512, 8 heads of 64) in bf16
   and float32, on GQA and D 128 cases, over documents that start at keys
   63, 64 and 65, separators at 0 and T-1, one-token documents, a row with
   no separator and real packed rows of the repo's text; the bars of phase
   6, and the bf16 bars must reject plain versions given inclusive-cumsum
   ids (each separator moved into the next document); times of kernel,
   plain version and SDPA with one float bias of ALiBi + causal + documents;
9. packed: ``byte_25m`` at full width and depth on the repo's own text
   (``*.md``, ``docs/*.md``, ``.py``; held out by document hash): the
   port's ``prepare`` writes tar shards, the kernel path meets the plain
   path on one packed micro-batch (phase 7's bars), the trainer runs
   ``configs/train_e2e_bytes.yaml`` for 300 steps (8 launches of each
   ``_docs`` counter per step, a validation loss below the held-out bytes'
   unigram entropy), the eval harness scores the trained model (bits per
   byte below that entropy and within 0.01 of the plain path's; last-word
   and choice accuracy), and the trainer CLI takes 20 steps on the shards;
   then the trained model with weight-only int8 scores bits per byte within
   log2(1.02) of its bf16 value (JAX's 2 % perplexity budget), and serves
   eight held-out prompts in-process twice, in bf16 and with int8 KV plus
   int8 weights: the share of greedy tokens before the first divergence;
10. int8 kernels: K4 over int8 pools with float32 scales (the TPU kernel's
   int8 branch) against its plain version at the serving shapes (T 1, 3
   and 8; offsets 0 to 1023), GQA, D 128, a trash-page row and a
   NaN-poisoned row, bf16 (atol/rtol 2e-2) and float32 (atol 1e-4); the bf16
   bar must reject plain versions that read the scale of the next position
   or of the next kv head; the ``long`` case's int8 twin; bit-equal reruns
   (main and long); times of the kernel (hot and cold, as in phase 2), the
   plain version, the bf16 K4 on the dequantized pools and a library
   yardstick;
11. int8 serving: the serving phase with ``125m``'s weights quantized to
   int8 and an int8 KV cache (the CLI's ``--quantize int8 --kv-cache-dtype
   int8``): every request done, K4's int8 branch and K1 launched, the bf16
   K4 never; then the parity and profile phases on that engine.

12. sp_kernels: ``flash_partial`` (K1 at global offsets, f32 output) and
   ``flash_grads`` (K2/K3 given the global lse and delta, f32 grads) against
   their plain versions at 580m's ring shape (B 1, a 2048-token shard, 12
   heads of 128) in bf16 and f32, a GQA and a D 64 case: the diagonal, a
   past and a future shard of a 3-shard row, with and without separate
   query and key document ids; the bf16 bars must reject a plain version
   one key off in kv_offset and one that reads the query ids as key ids; a
   future shard writes o = 0, lse = -1e30 and zero grads; K2 and K3 twice
   on a past shard write the same bits; times of kernel, plain version and
   SDPA with the block's float bias (and its backward); K1 twice on a past
   shard writes the same bits;
13. sequence_parallel: 580m at full width with its depth cut 18 -> 4
   (``SP_LAYERS``) at T 8192 over 4 ranks (NCCL with a card per
   rank on a 4-card machine, else 4 ranks sharing card 0 over gloo): the
   ring at the layer shape against the one-card ``flash_attention`` on the
   gathered tensors, one ring train step against the one-card step (loss,
   grad cosines, bit-equal params across ranks, exact launch counts, peak
   memory, the transfers' share under ``torch.profiler``), plain and packed,
   then the trainer CLI under ``torch.distributed.run`` for 3 steps of
   ``configs/train_580m_8k.yaml`` at 2 layers (``SP_CLI_LAYERS``) and,
   beside it on the same card, the same CLI on one card (their step time,
   tokens/s and model-FLOPs share logged as ``contended_*``); the one-card
   reference step's launches give the D 128 rows of the kernel table. In
   the same 4-rank world, the same two steps with ``cp_impl: ulysses``
   (three all-to-alls to the whole row at 3 heads a rank, one K1 call over
   T 8192, the all-to-all back; K2/K3 in the backward): the ring's bars
   against the same one-card steps, exactly 2L K1 and L K2/K3 launches a
   rank (``_docs`` when packed), the all-to-alls' share of a profiled
   step; then K1-K3 at that rank shape with the slopes of heads 3-5
   against their plain versions (which the slopes of heads 0-2 must miss),
   timed: the ``_ulysses`` rows.

14. train_1_3b: ``configs/train_1_3b_1chip.yaml``'s path (1_3b, remat,
   ``loss_chunk`` 256, Adafactor, B 4 x accum 16, a bf16 accumulator):
   (a) K1-K3 at its shape (B 4, T = S = 1024, 16 heads of 128, causal
   ALiBi) in bf16 and f32 with phase 6's bars, controls, bit-equal reruns
   and timings; (b) one micro-batch at full width and depth, seed-0
   weights: the chunked loss and grads against the full logits and
   against the plain path (``attention_impl="xla"``) in bf16, loss within
   5e-4 and grad cosines at least 0.999, and against the float32 plain
   path (phase 7's bars), with each run's peak memory; (c) the
   launches of one optimizer step: 24 x 16 x 2 of K1 (the remat recompute
   runs it again), 24 x 16 of K2 and of K3; (d) Adafactor holds exactly 4N
   bytes of params plus 4 per element of JAX's factored statistics, and
   20 steps on one repeated batch lower the loss; (e) the trainer CLI on
   the recipe for 3 steps (synthetic data, no eval, its checkpoint
   deleted): tokens/s, step ms, the model-FLOPs share, peak memory, and
   the peak of a step with the full logits (one step, ``loss_chunk``
   None);
   (f) 125m at dropout 0.1: remat on and off give bit-equal grads, each
   site keeps 1 - p of its elements within 5 sigma, the same key the same
   bits. Phase 13's trainer CLIs run 580m at its own dropout 0.1. (d) also
   times the anomaly guard at 1.3B: steps of one micro-batch with and
   without it, interleaved, and the Adafactor step with and without its
   gate (CUDA events).

15. resilience (run after training): ``configs/train_125m.yaml``'s
   resilience block on 125m at full width and depth, B 8 x T 1024, through
   the port's ``Trainer`` (K1-K3 in the guarded step; the cuts are
   printed): (a) guard on against guard off on the same batches: params
   and optimizer state bit-equal after 14 steps, the synchronising calls of
   a non-log step equal (``torch.cuda.set_sync_debug_mode("warn")``), step
   ms over interleaved blocks (off, on, off, on) and the optimizer step
   alone with and without its gate; (b) ``skip_batch`` with NaN at the
   non-log steps 4 and 5: the run ends at step 8 with finite params, the
   carry's count 2, the optimizer's count 6, and the state bit-equal to a
   guard-off run fed the same batches without those two; (c) the block's
   ``rollback`` with NaN at three steps in a row: one rollback, to the
   snapshot of step 4, whose tensors' digests after the restore equal
   theirs at capture, the ``anomaly_rollback`` event, the run completes;
   the snapshot's bytes and capture ms; (d) a ``hang`` (watchdog 10 s)
   and a ``sigterm``, each under ``Supervisor``: one restart each, from
   the force-saved / preemption step, and the state bit-equal to an
   uninterrupted run's at step 8; the watchdog's detection time and the
   restart's ms; (e) K1-K3 launch 12 times each a guarded step, exactly;
   (f) every step directory of the phase deleted.

16. llama_kernels: K1-K4 at ``llama3_8b``'s shapes with ALiBi off and 32
   query heads on 8 kv heads of 128, under the bars above: the serving
   chunk (B 4, T 64 over a cache of 8192, bf16 with the emulation and its
   causal and validity controls, and f32), K4 decode (B 4, T 1, page 16,
   cache 8192) over bf16, f32 and int8 pools (the bf16 bars must reject a
   plain version that sees one key fewer, and the int8 scale controls),
   the training entry at B 1, T = S 8192 (phase 6's bars and controls; the
   emulation on 12 of the 32 query heads, its float64 scores' size) and the
   ring's shards of T 8192 over 4 ranks (phase 12 without ALiBi); each
   timed against its plain version and SDPA with ``enable_gqa``;
17. llama_serving: ``llama3_8b`` at full width and depth (32 layers, seed-0
   weights, bf16) behind the HTTP server with paged KV (page 16, cache
   8192, chunk 64, 4 slots): phase 3's six requests and phase 5's profile;
   phase 4's parity at the same bars (and the float32 paths' greedy tokens
   equal outside ties) on its width at 8 layers (``LLAMA_PARITY_LAYERS``);
   then the same with int8 weights (the untied head and the gate included,
   quantized on the card with ``quantize_model``) and an int8 cache, with
   phase 11's parity;
18. llama_training: ``llama3_8b`` at full width with its depth cut 32 -> 4
   (1,923,125,248 params), bf16 over float32 master params, AdamW, B 1 x T
   8192, remat, ``loss_chunk`` 1024: one micro-batch at T 2048 through the
   kernels against the plain path in bf16 and float32 (phase 7's bars; the
   plain path's [1, 32, T, T] scores do not fit at 8192); one optimizer
   step under each ``remat_policy`` (none, dots, qkv_mlp) with exactly 8 K1,
   4 K2 and 4 K3 launches, its step ms and peak memory beside the peak
   predicted from the code; the trainer CLI on ``configs/train_125m.yaml
   --set model.size=llama3_8b model.n_layers=4 ...`` for 3 steps (no
   checkpoint: its saves are dropped; the cuts are printed).
19. generate: ``inference.generate`` over the slab cache (a page view of
   the ``[B, cache_len]`` slab through an identity block table, so K1 takes
   the prompt and verify windows past 8 tokens, K4 every decode step and
   shorter verify windows) and speculative decoding. (a) ``125m`` at full
   width and depth, seed-0 weights, bf16, B 4 x T 256, 64 new tokens, cache
   1024: greedy ``generate`` with exactly 12 K1 and 12 x 63 K4 launches and
   no host sync (one a step with an EOS to watch), ``stream_tokens`` equal
   to it greedy and sampled (one seed), ``generate_speculative`` at
   draft_len 4 (K4 verify windows) and 8 (K1) on a repetitive prompt, with
   exact launches and at most one sync a forward; the prefill logits no
   farther from the float32 plain path than the bf16 plain path's plus
   2e-2; on float32 models speculation equal to greedy decoding and the
   kernel path's greedy tokens equal to the plain path's (``attention_impl=
   "xla"``), both outside ties of twice the f32 bar (``agree_or_tie``), and
   the prefill logits within 1e-4; then all of it but the sampled run with
   int8 weights and an int8 cache (ties of two int8 caches within 2e-3;
   their f32 logits reported). Readings: ms per token, prefill ms, tokens per forward, syncs
   per forward, launches per token. (b) ``llama3_8b`` at full width, its
   depth cut to 16 layers (``LLAMA_CUT_LAYERS``: the run's time), B 1 x T
   512, 32 new tokens, cache 8192: (a)'s greedy checks and
   readings in bf16, then its float32 checks at full width with the depth
   cut to 8 layers (8 GB models, built one at a time). The kernel rows of
   those shapes. (c) The serve CLI in processes of its own
   on an ``.npz`` of 125m (deleted after): ``--prompt``, ``--speculative
   4`` and the REPL on piped stdin, each printing what the same
   ``TextGenerator`` prints in process. (d) Phase 3's six requests on
   float32 engines at ``--draft-k`` 0 and 4: streams equal outside ties of
   twice the f32 bar, acceptance and ITL beside draft_k 0's.

20. serving_policy: serving's policy layer on the paged engine. (a)
   ``125m`` at full width and depth: eight requests on a 512-token system
   prompt (8 chunks) with suffixes of 20-100 tokens, 32 new tokens, greedy,
   the first alone until its prefill is banked, on engines with the prefix
   cache on (256 chunks, the serve CLI's default) and off, in float32
   (streams equal outside ties of twice the f32 bar) and bf16 (the first
   divergence and its gap, no bar), then once over an int8 cache; exact
   counts (56 hits, the misses as ``PrefixCache.lookup`` counts them, 56
   prefill chunks saved, one K1 launch a layer and prefill tick, one K4 a
   layer and decode tick, no copy-on-write, after retirement every page in
   use held once, by the index); the TTFT p50 of the seven hit requests on
   and off; the kernel rows of K1 on the chunk after a hit and K4 over rows
   whose leading pages are shared. (b) Inside llama_serving: ``llama3_8b``
   at 32 layers, four requests on a 1,024-token prefix, exact counts, every
   attention read against the plain read of the same pools at the bf16
   bar. (c) The serve CLI (125m, float32, ``.npz`` files under
   ``build/serving_policy``, deleted): ``/healthz`` until READY, ``POST
   /admin/reload`` with a stream in flight (200, the stream whole, prefix
   entries 0, the next greedy stream equal to a fresh engine's on the new
   weights), a truncated file 409 with the engine READY, SIGTERM with a
   stream in flight (it finishes, ``drain_done``, exit 0). (d) In process:
   ``/healthz`` 503 before the scheduler runs, tick faults (one, then three
   in a row: the breaker, the rebuild, READY; device memory back within one
   pool), a gold request preempting one of four batch streams, ``/metrics``
   as Prometheus text equal to the snapshot. (e) Host ms per decode tick
   and ITL p50 with the CLI's defaults against ``--prefix-cache 0
   --no-trace``.

21. disagg: disaggregated prefill/decode roles and live stream migration.
   (a) ``125m`` at full width and depth in float32, bf16 and over an int8
   cache: a prefill-role and a decode-role engine over one model, joined
   in process through the page-span wire format; four prompts of 130-512
   tokens, each alone on the prefill engine, 32 new tokens: the imported
   pages (scale pools included) and carries bit-equal to the exported
   ones, K1 once a layer and chunk and no K4 on the prefill engine, no K1
   and K4 once a layer and decode tick on the decode engine, no prefill
   chunk and no replayed token there, the streams equal to a mixed
   engine's outside ties (float32 twice the f32 bar, bf16 and int8 0.03);
   bytes a token, and each stream's prefill, export (to the host),
   encode, decode and import (to the card) times. (b) Two mixed bf16
   engines, greedy and sampled: one stream moved mid-decode and one
   mid-prefill, both equal to their unmoved streams, two exports two
   device syncs and their imports none (``set_sync_debug_mode``). (c) Two serve CLI processes,
   ``--role prefill`` and ``--role decode`` (125m, float32, serving_policy's
   seed-0 ``.npz``): ``/healthz`` roles, ``/generate`` with ``prefill_to``
   ends ``migrated``, ``/attach`` streams (a)'s mixed tokens, a ship to a
   dead port fails the stream retryably with a flight dump, SIGTERM exits
   0. (d) ``llama3_8b`` at full width and 16 layers (``LLAMA_CUT_LAYERS``),
   bf16 then its cache in int8 (the
   same weights): a 512-token prompt handed off (pages bit-equal, launches
   exact), then again with every attention read held to the plain read of
   the same pools at the bf16 bar. The kernel rows of K1 on a prefill
   chunk and K4 over imported pages (bf16, int8).

22. slab_serving: the slab KV layout (``kv_layout="slab"``: each slot a
   fixed row of the cache, the pools seen through an identity table). (a)
   ``125m`` at full width and depth, seed-0 weights, bf16: phase 3's six
   requests through the one-shot bucketed prefill (``prefill_chunk=0``):
   K1 launches 12 a prompt, K4 12 a decode tick, no chunk tick, each
   prompt's bucket the host rule's, every attention read within the bf16
   bar of the plain read of the same pools; in float32 each stream against
   ``generate()`` of its prompt alone (equal outside ties of twice the f32
   bar); each prompt's bucket, TTFT and ITL beside the paged engine's on
   the same requests, a lone 512-token prompt's TTFT one-shot and chunked,
   the decode tick's host and device ms. (b) Ten lengths with
   ``max_prefill_buckets=2``: buckets, ``prefill_bucket_capped`` and
   ``prefill_buckets`` equal the host rule's; streams as in (a). (c) The
   chunked slab with the prefix cache (span copies) against the paged
   engine (page sharing) on serving_policy's burst: hits, misses and
   chunks saved equal, streams equal outside ties of 0.03; the bytes and
   ms of one hit's copy. (d) ``fused_tail=False``: streams byte-identical
   to the fused tick's, greedy and sampled, and one host sync a tick more.
   (e) The serve CLI with ``--prefill-chunk 0``: JAX's fallback message, a
   request on the slab answered, SIGTERM exit 0. The kernel rows of K1 on a
   512-token bucket over 1,024 keys and K4 on the slab's decode.

23. router: the fleet router (``python -m
   zero_transformer_tpu_torch.serve_router``) in processes on the card,
   125m in bf16 on the kept seed-0 ``.npz``: two mixed replicas (the serve
   CLI and ``--replica-worker``), a router; a ``--role prefill`` and a
   ``--role decode`` CLI and a second router. (a) Requests on one shared
   prompt go where ``PrefixAffinity`` sends them, the routed SSE ids equal
   a direct request's, both replicas run K4; (e) the router's Prometheus
   ``/metrics`` parses, ``/slo`` lists every default objective,
   ``/admin/trace`` passes ``verify_stitched``; routed against direct TTFT
   and ITL; (b) a rolling ``POST /admin/reload`` with two live streams
   drops none; (c) SIGKILL of the replica serving a live stream: it resumes
   on the survivor, equal to the unkilled stream outside ties of 0.03, one
   failover, the dead replica's relayed tokens replayed; (d) the
   prefill/decode split: one disaggregated dispatch, none replayed, the
   stream equal to the mixed one. Every child exits 0 but the killed one.

24. tensor_serving: tensor-parallel serving at TP 2 (NCCL with a card a
   rank where two are visible, else two ranks sharing card 0 over gloo),
   one world of ranks for (a)-(c), after the one-card references: (a)
   125m in float32, the six serving requests through the engine (rank 0
   schedules and announces each device program, rank 1 follows): streams
   equal the one-card engine's, a forced prefill and decode step's logits
   within 2e-4 of one card's, K1 and K4 launched on each rank as often as
   on one card, each rank's weight and KV bytes half of one card's, and a
   profiled decode tick (its ms, the ``tensor_group.*`` spans' share); (b)
   125m in bf16, then int8 weights over the int8 KV cache (the first four
   serving requests, 16 new tokens): every attention read of every rank
   held to its plain read at the bf16 bar; (c)
   llama3_8b at 32 layers in bf16 (weights drawn on the card a tensor at a
   time, the rank's slice kept): K1 and K4 launched on each rank as often
   as on one card, every attention read held to its plain read at the bf16
   bar, each rank's weight and KV bytes half of one card's, peak memory per
   rank; the forced prefill and decode step's logits within one card's own
   bf16-to-float32 spread of one card's, and the streams' partings from one
   card's only where one card's top-2 gap is within twice that bar (in bf16
   another order of the row-parallel sums parts them at near ties); in
   float32 at full width and 8 layers (as the generate phase holds
   llama3_8b's float32 exactness), greedy streams equal one card's outside
   top-2 gaps of 0.03 (gaps taken in float32 off the final hidden states); (d) ``serve --server --tensor 2`` (float32)
   answers one HTTP request with the one-card stream and drains on
   SIGTERM with exit 0, and ``--prompt ... --tensor 2`` answers. The
   kernel rows of K1 and K4 at a rank's heads: 125m's heads 6-11 with
   their slopes (the plain version with the slopes of heads 0-5 must miss
   the bar), llama3_8b's 16 query on 4 kv heads.
25. tensor_training: training over a ``tensor`` axis (``mesh.tensor``), in
   four parts, with the backend printed (gloo with the ranks sharing card
   0, NCCL with a card a rank): (a) 125m at full width, depth
   ``DP_LAYERS``, data 2 x tensor 2 inside data_parallel's 4-rank world:
   ZeRO 0-3 with AdamW (stage 3 with the chunked loss) and Adafactor at
   stage 1, 3 steps each, losses within LOSS_MARGIN and grad norms within
   GRAD_NORM_RTOL of the one-card trainer on the same global batches, the
   whole params bit-equal on every rank and the replicated leaves across
   the tensor ranks, bytes a rank by the ZeRO formula over one tensor
   rank's params beside the data-4 figure, the stage-2 save holding the
   one-card tree, resumed at data 4 x tensor 1 within the bars; (b) 580m at
   T 8192, ``SP_LAYERS`` layers, tensor 2 x sequence 2 inside
   sequence_parallel's world, through the ring and through Ulysses: loss
   within LOSS_MARGIN of the one-card step, every grad's cosine to the
   one-card grads' slice at least COS_BAR, exact launches; (c) llama3_8b at
   full width, 4 layers, over tensor 2 on 2 spawned ranks, bf16, AdamW, no
   remat: ``llama_training``'s first 3 one-card steps replayed (its batches, from
   the same seeded weights), losses and grad norms within the bars, the
   peak a rank; (d) beside (c), the trainer CLI under
   ``torch.distributed.run`` over data 2 x tensor 2 (125m, 2 layers, 3
   steps). Then K1-K3 at every new shard shape with each rank's slopes
   against their plain versions (a plain version handed the slopes of
   the head range with the tensor offset dropped must miss the bars):
   the ``_tp``, ``_tp_ring``, ``_tp_ulysses`` and ``_tp_llama`` rows.

Each phase prints its seconds and the disk it leaves, after its step,
checkpoint and build directories are deleted; the run prints every
phase's seconds and the total before the kernel table.

``--phases k4_anatomy`` (never part of a full run) shows where the paged
decode kernel's time goes at phase 2's main and long cases: it rebuilds
``csrc/paged_attention.cu`` apart as the kernel, a variant that skips the
compute, one that issues no copies and one that stamps each phase of each
CTA with the card's clock, and prints their device times and the phases'
durations.

``--phases tc_fit`` (never part of a full run) prints, for the serving
chunks of llama3_8b (ALiBi off) and 125m, the share of K1's bf16 outputs
that differ from its emulation with exact sums rounded once and with the
tensor cores' adder at 24-27 bits (``tc_accumulate``; 26 is the fit the
ALiBi-off phases use).

``--phases sequence_parallel_f32`` (never part of a full run) repeats
phase 13's parity with the model in float32, so that every kernel on both
sides takes its f32 path: the ring's distance to the one-card step without
bf16 rounding.

``--phases a,b,...`` builds the kernels and runs the named phases only
(kernels, serving, parity, profile, int8_kernels, int8_serving,
train_kernels, training, resilience, train_1_3b, packed_kernels, packed, sp_kernels,
sequence_parallel, data_parallel, llama_kernels, llama_serving, llama_training, generate,
serving_policy, disagg, slab_serving, router, tensor_serving, tensor_training, data_parallel_nccl,
sequence_parallel_f32, k4_anatomy and tc_fit; parity needs serving; tensor_training runs its parts (a) and
(b) inside data_parallel's and sequence_parallel's worlds and replays llama_training's steps, so
naming it adds those three phases); the kernel table then lists the kernels whose phases ran.

The last two lines of standard output are the kernel table as one JSON
object and ``{"ok": true, "device": {...}}`` (a full run only). Without CUDA the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
L2_BYTES = 50e6
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2), torch.float32: dict(atol=1e-4, rtol=0.0)}
# the bf16 flash kernel against the emulation of its own rounding. Set from
# readings on an H100 at the kernel phase's cases: 0.01-0.03 % of outputs
# differ at all, by at most one ulp, or by up to 6.1e-5 on outputs near zero
# (five ulps at 5.8e-4); lse within 4.8e-7. A key missing from a ~250-key
# window moves most outputs of its rows by ~4e-3.
MMA_ATOL = 2.0**-13
MMA_DIFFER_SHARE = 1e-3
MMA_LSE_ATOL = 1e-4
K1_KEY_TILE = 64  # keys per tile of the bf16 K1 kernel (csrc/flash_fwd.cu BK): its online softmax's steps
# The H100's tensor-core adder, as fitted to K1 on the card (``--phases
# tc_fit``): each wgmma k-step of TC_K bf16 products and the f32
# accumulator are aligned to the largest exponent among them and truncated
# toward zero at 2^(e_max - TC_BITS), summed exactly, and the sum truncated
# toward zero to f32 (``tc_accumulate``). Without ALiBi a row's weight
# spreads over thousands of keys, and the emulation that sums each tile's
# products exactly and rounds once (kept for the ALiBi cases, where it was
# set) lands 0.70 % of llama3_8b's serving-chunk outputs one ulp off, this
# model 0.002 %.
TC_K, TC_BITS = 16, 26

# 125m serving shapes (ServingConfig defaults at cache_len 1024)
H, D, PAGE, CACHE, CHUNK, SLOTS = 12, 64, 16, 1024, 64, 4
# K4's long case: a row of 8192 keys (full 8-CTA clusters of 1024 keys,
# streamed through the kernel's ring), 8 query heads on 2 kv heads of 128
LONG_CACHE, LONG_HQ, LONG_KVH, LONG_D = 8192, 8, 2, 128
LONG_OFFSETS = [100, 3000, 6001, 8191]


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 30) -> float:
    """Device time per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel (``torch.cuda._sleep``), so that the calls'
    kernels run back to back on the device. ``time_ms``'s events also count
    the host's time between launches, which decides the reading when one
    call's kernels take less than its Python wrapper. The reading counts
    only if the start event was still pending when the host had queued
    every call; otherwise the spin is made longer. (``torch.profiler``
    sessions this short miss launches of the port's kernels: they read
    0.0 ms for a 0.2 ms kernel.)"""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        if cycles >= 1 << 32:
            raise AssertionError("device_ms: the calls were not queued within a ~2 s spin (does fn sync?)")
        cycles *= 4


def compare(got: torch.Tensor, ref: torch.Tensor, dtype, what: str) -> float:
    """Fail unless ``got`` matches ``ref`` (NaN where ref is NaN); returns
    the largest absolute error over finite entries."""
    got, ref = got.float(), ref.float()
    nan_ref = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan_ref):
        raise AssertionError(f"{what}: NaN pattern differs from the plain version")
    ok = ~nan_ref
    err = (got[ok] - ref[ok]).abs()
    tol = TOL[dtype]
    bad = err > tol["atol"] + tol["rtol"] * ref[ok].abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        raise AssertionError(f"{what}: max |err| {max_err} beyond {tol}")
    return max_err


# ------------------------------------------------------------------ kernels


def flash_case(B, T, S, KVH, dtype, offsets, valid_lens, seed, Hq=H, Dh=D):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, T, Hq, Dh, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, KVH, Dh, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, KVH, Dh, generator=g, device="cuda").to(dtype)
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    seg = (torch.arange(S, device="cuda")[None, :] < torch.tensor(valid_lens, device="cuda")[:, None]).int()
    return q, k, v, offs, seg


def paged_case(B, T, n_blocks, KVH, dtype, offsets, seed, trash_row=None, nan_row=None, Hq=H, Dh=D):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = B * n_blocks + 1
    q = torch.randn(B, T, Hq, Dh, generator=g, device="cuda").to(dtype)
    kp = torch.randn(n_pages, PAGE, KVH, Dh, generator=g, device="cuda").to(dtype)
    vp = torch.randn(n_pages, PAGE, KVH, Dh, generator=g, device="cuda").to(dtype)
    # ragged: each row maps the blocks its offset needs, in shuffled order;
    # the rest of its table stays on the trash page 0
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = torch.zeros(B, n_blocks, dtype=torch.int32)
    used = 0
    for b, off in enumerate(offsets):
        need = min(n_blocks, -(-(off + T) // PAGE))
        table[b, :need] = perm[used:used + need]
        used += need
    if trash_row is not None:
        table[trash_row] = 0
    if nan_row is not None:
        q[nan_row] = float("nan")
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    return q, kp, vp, table.to("cuda"), offs


def window_pairs(offsets, T: int, cache: int) -> int:
    """(query, key) pairs one head computes for causal windows of T queries
    at ``offsets``: query t of a row at offset o sees min(o + t + 1, cache)
    keys."""
    return sum(min(o + t + 1, cache) for o in offsets for t in range(T))


def flash_bound(B, T, offsets, KVH, dtype, Hq=H, Dh=D, cache=CACHE):
    """Least time for this call: the bytes it must move (q, the K/V keys the
    causal limit admits, the validity mask, out) against HBM, or its flops
    over the causal (query, key) pairs (``window_pairs``) against the
    dtype's peak, whichever is larger."""
    el = torch.finfo(dtype).bits // 8
    keys = sum(min(o + T, cache) for o in offsets)
    nbytes = 2 * B * T * Hq * Dh * el + 2 * keys * KVH * Dh * el + 4 * B * cache
    flops = 4 * window_pairs(offsets, T, cache) * Dh * Hq
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def paged_bound(B, T, offsets, KVH, dtype, Hq=H, Dh=D, cache=CACHE, shared_keys=0):
    """Least time for K4 over bf16/f32 pools: q, the visible keys' K/V rows,
    the table, the offsets and out against HBM, or the flops over the causal
    (query, key) pairs against the dtype's peak, whichever is larger. The
    ``shared_keys`` leading keys that every row maps to the same pages are
    one input, read once."""
    el = torch.finfo(dtype).bits // 8
    keys = sum(min(o + T, cache) for o in offsets) - (B - 1) * shared_keys
    nbytes = 2 * B * T * Hq * Dh * el + 2 * keys * KVH * Dh * el + 4 * B * (cache // PAGE) + 4 * B
    flops = 4 * window_pairs(offsets, T, cache) * Dh * Hq
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def k4_touched_bytes(offsets, T, KVH, row_bytes, cache=CACHE) -> int:
    """Bytes of the pools one K4 call reads: the K and V rows of every
    visible key and kv head, ``row_bytes`` each (D * 2 in bf16, D + 4 for
    int8 with its scale)."""
    return 2 * sum(min(o + T, cache) for o in offsets) * KVH * row_bytes


def cold_device_ms(call, pools, touched: int) -> tuple:
    """Device time per call with the pools cold in L2, as the decode tick
    finds them (each of its layers reads its own pools): ``call(*pools)``
    rotates over copies of ``pools``, at least 8 and enough that one
    rotation touches twice the 50 MB L2. Returns (ms, copies)."""
    n = max(8, math.ceil(2 * L2_BYTES / touched))
    copies = [tuple(p.clone() for p in pools) for _ in range(n)]
    turn = iter(range(1 << 30))
    ms = device_ms(lambda: call(*copies[next(turn) % n]))
    del copies
    torch.cuda.empty_cache()
    return ms, n


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) of |x|."""
    _, e = torch.frexp(x.float().abs().clamp(min=2.0**-30))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def tc_accumulate(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, bits: int = TC_BITS) -> torch.Tensor:
    """``acc + a @ b`` for one tensor-core k-step, as the H100's adder sums
    it: ``a`` [..., M, TC_K] and ``b`` [..., TC_K, N] hold bf16 values,
    ``acc`` [..., M, N] float32. Every product (exact in float32) and
    ``acc`` are truncated toward zero to multiples of 2^(e_max - bits),
    e_max the largest exponent among them (``frexp``'s), the integers
    summed exactly, and the sum truncated toward zero to float32. Column
    blocks keep the products' tensor under 2^28 elements."""
    M, N = a.shape[-2], b.shape[-1]
    step = max(1, (1 << 28) // (a[..., 0, 0].numel() * M * TC_K))
    out = torch.empty_like(acc)
    for n0 in range(0, N, step):
        terms = a.float()[..., :, None, :] * b.float()[..., :, n0:n0 + step].transpose(-1, -2)[..., None, :, :]
        part = acc[..., n0:n0 + step]
        e_max = torch.maximum(torch.frexp(part)[1], torch.frexp(terms)[1].amax(-1))
        # float64: the quantum of tiny terms lies below float32's range
        quantum = torch.ldexp(torch.ones_like(part, dtype=torch.float64), e_max - bits)
        units = (torch.trunc(part / quantum).to(torch.int64)
                 + torch.trunc(terms / quantum[..., None]).to(torch.int64).sum(-1))
        exact = units.double() * quantum
        rounded = exact.float()
        out[..., n0:n0 + step] = torch.where(rounded.double().abs() > exact.abs(),
                                             torch.nextafter(rounded, torch.zeros_like(rounded)), rounded)
        del terms, units, exact, rounded
    return out


def flash_mma_emulation(q, k, v, offsets, seg, docs=None, with_flip=False, kv_offsets=0, k_docs=None,
                        round_out=True, key_tile=K1_KEY_TILE, round_p=True, causal=True, alibi=True,
                        tensor_core=None):
    """The bf16 tensor-core kernel's arithmetic, step by step: scores from
    the bf16 inputs (exact products, summed in float64, then float32), the
    biases in the kernel's order (ALiBi + causal, then the document mask
    when ``docs`` [B, T] is given, then validity), an online softmax over
    its ``key_tile``-key tiles with m and l in float32 from the unrounded P, P
    rounded to bf16 before the P.V product (exact products summed in
    float64; ``round_p=False`` keeps P in float32), and the output rounded
    to bf16 once. A tile past a row's
    causal limit, which the kernel skips, adds exp(-1e10 - m) = 0 here, so
    every tile is visited.
    Returns ``(out [B, T, H, D] bf16, lse [B, H, T] f32)``; with
    ``with_flip`` also ``flip`` [B, T, H, 1]: how far one p rounded to the
    neighbouring bf16 value can move an output of the row, 2^-7 * max over
    keys of (softmax weight * max |v|) (a bf16 ulp is at most 2^-7 of the
    value). The tensor cores' f32 score sums differ from the exact sum in
    the last bit now and then, and where that flips the rounding of a large
    p, the kernel lands that far from this emulation. ``kv_offsets`` (int or
    [B]) puts the keys at global positions and ``k_docs`` [B, S] gives them
    ids of their own (``flash_partial``); ``round_out=False`` keeps the
    output in float32; a row that sees no key (causal, every key after it)
    is 0 with lse -1e30, as the kernel writes it. ``causal=False`` drops
    the causal mask (ALiBi stays); ``alibi=False`` gives every head slope 0
    (JAX's ``_slopes_arg`` without ALiBi), so the bias adds exact zeros.
    ``tensor_core`` (the adder's bits, TC_BITS) sums q.k and each tile's
    p.v (after the rescale) as the H100's tensor cores do, TC_K at a time
    (``tc_accumulate``), in place of exact sums rounded once."""
    from zero_transformer_tpu_torch.ops.flash import row_offsets, slopes_on
    from zero_transformer_tpu_torch.ops.positions import NEG_INF

    B, T, Hq, Dq = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = Hq // KVH
    kd = k.double().repeat_interleave(G, dim=2).transpose(1, 2)  # [B, H, S, D]
    vd = v.double().repeat_interleave(G, dim=2).transpose(1, 2)
    qd = q.double().transpose(1, 2)
    if tensor_core:
        kt = kd.transpose(-1, -2)
        s = torch.zeros(B, Hq, T, S, device=q.device)
        for c in range(0, Dq, TC_K):
            s = tc_accumulate(s, qd[..., c:c + TC_K], kt[..., c:c + TC_K, :], tensor_core)
        del kt
    else:
        s = (qd @ kd.transpose(-1, -2)).float()  # [B, H, T, S]
    offs = row_offsets(offsets, B, q.device)
    kv_offs = row_offsets(kv_offsets, B, q.device)
    dist = (offs[:, None, None] + torch.arange(T, device=q.device)[:, None]
            - (kv_offs[:, None, None] + torch.arange(S, device=q.device)))
    slopes = slopes_on(Hq, str(q.device), True) if alibi else torch.zeros(Hq, device=q.device)
    bias = 0.0 - slopes[None, :, None, None] * dist.clamp(min=0)[:, None].float()
    if causal:
        bias = bias + torch.where(dist >= 0, 0.0, NEG_INF)[:, None]
    x = s * (1.0 / Dq**0.5) + bias
    if docs is not None:
        k_docs = docs if k_docs is None else k_docs
        x = x + torch.where(docs[:, :, None] == k_docs[:, None, :], 0.0, NEG_INF)[:, None]
    x = x + torch.where(seg != 0, 0.0, NEG_INF)[:, None, None, :]
    m = torch.full((B, Hq, T, 1), -1e30, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(B, Hq, T, Dq, dtype=torch.float64, device=q.device)
    for j in range(0, S, key_tile):
        xt = x[..., j:j + key_tile]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(xt - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = (p.bfloat16() if round_p else p).double()
        if tensor_core:
            o32 = (o * alpha.double()).float()
            for c in range(0, xt.shape[-1], TC_K):
                o32 = tc_accumulate(o32, pv[..., c:c + TC_K], vd[:, :, j + c:j + c + TC_K], tensor_core)
            o = o32.double()
        else:
            o = (o * alpha.double() + pv @ vd[:, :, j:j + key_tile]).float().double()
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    out = o.float() / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    dead = (dist.amax(-1) < 0)[:, None, :] & causal  # [B, 1, T]: the row sees no key
    out = torch.where(dead[..., None], 0.0, out)
    lse = torch.where(dead, -1e30, lse)
    out = (out.bfloat16() if round_out else out).transpose(1, 2)
    if not with_flip:
        return out, lse
    vmax = v.float().abs().amax(-1).repeat_interleave(G, dim=2).transpose(1, 2)[:, :, None, :]  # [B, H, 1, S]
    flip = 2.0**-7 * (torch.softmax(x, dim=-1) * vmax).amax(-1, keepdim=True)  # [B, H, T, 1]
    return out, lse, flip.transpose(1, 2)


def mma_miss(got: torch.Tensor, emu: torch.Tensor, flip=0.0):
    """How far ``got`` is from the emulation: the largest |got - emu| over
    its bar (one bf16 ulp of emu plus MMA_ATOL, plus ``flip`` where given)
    and the share of outputs that differ at all."""
    err = (got.float() - emu.float()).abs()
    over = float((err / (bf16_ulp(emu) + MMA_ATOL + flip)).max())
    return over, float((err > 0).float().mean())


def check_mma(got, lse, q, k, v, offs, seg, label, shifted, docs=None, doc_control=None, flip=False,
              causal=True, alibi=True, tensor_core=None, controls=("causal_limit_plus_1", "validity_minus_1")):
    """Hold the bf16 tensor-core kernel to its own rounding against
    ``flash_mma_emulation``: every output within one bf16 ulp plus MMA_ATOL,
    at most MMA_DIFFER_SHARE of the outputs different at all, lse within
    MMA_LSE_ATOL. With ``shifted``, also show that the check catches a kernel
    whose causal limit or validity mask is one key off: the emulation with
    every offset one later (one more key visible per row) and with every
    row's last valid key masked must each fail those bars. With
    ``doc_control`` (other document ids), the emulation under those ids
    must fail them too. With ``flip``, every bar also allows one rounding
    flip of a p (``flash_mma_emulation``'s ``flip``): at byte_25m's training
    shape (8.4M outputs) the bar without it misses by up to 9x, with and
    without document ids alike; the reading without the allowance is
    reported as ``over_without_flip``. ``causal=False``: the kernel ran
    without the causal mask; ``alibi=False``: without ALiBi;
    ``tensor_core`` (TC_BITS): the emulation sums as the tensor cores do
    (``flash_mma_emulation``). ``controls`` names the ``shifted`` ones to
    run."""
    kw = dict(causal=causal, alibi=alibi, tensor_core=tensor_core)
    if flip:
        emu, emu_lse, allowance = flash_mma_emulation(q, k, v, offs, seg, docs, with_flip=True, **kw)
    else:
        (emu, emu_lse), allowance = flash_mma_emulation(q, k, v, offs, seg, docs, **kw), 0.0
    over, share = mma_miss(got, emu, allowance)
    lse_err = float((lse - emu_lse).abs().max())
    if not (over <= 1.0 and share <= MMA_DIFFER_SHARE and lse_err <= MMA_LSE_ATOL):
        miss = (got.float() - emu.float()).abs() / (bf16_ulp(emu) + MMA_ATOL + allowance)
        worst = tuple(int(i) for i in torch.unravel_index(miss.argmax(), miss.shape))
        raise AssertionError(f"flash {label} vs the mma emulation: max err {over} of its bar at "
                             f"[b, t, h, d] = {list(worst)} (kernel {float(got[worst])}, emulation "
                             f"{float(emu[worst])}), {share} of outputs differ (bar {MMA_DIFFER_SHARE}), "
                             f"lse {lse_err} (bar {MMA_LSE_ATOL})")
    out = {"max_err_over_bar": over, "differ_share": share, "lse_max_abs_err": lse_err}
    if flip:
        out["over_without_flip"] = mma_miss(got, emu)[0]
    shifted_to = {}
    if shifted:
        last = seg.int().cumsum(1) == seg.int().sum(1, keepdim=True)
        fewer = seg.bool() & ~(last & seg.bool())  # each row's last valid key masked
        shifted_to = {"causal_limit_plus_1": (offs + 1, seg, docs), "validity_minus_1": (offs, fewer.int(), docs)}
        shifted_to = {what: shifted_to[what] for what in controls}
    if doc_control is not None:
        shifted_to["inclusive_doc_ids"] = (offs, seg, doc_control)
    for what, (o2, s2, d2) in shifted_to.items():
        s_over, s_share = mma_miss(got, flash_mma_emulation(q, k, v, o2, s2, d2, **kw)[0], allowance)
        if s_over <= 1.0 and s_share <= MMA_DIFFER_SHARE:
            raise AssertionError(f"flash {label}: the {what} emulation passes the bars "
                                 f"({s_over}, {s_share}); the check cannot tell them apart")
        out[what] = {"max_err_over_bar": s_over, "differ_share": s_share}
    return out


def sdpa_bias(B, T, S, offsets, seg, dtype, heads=H, alibi=True, slopes=None):
    """The float bias of ALiBi (``alibi``; ``slopes`` [heads]: a shard's own
    table), the causal limit at ``offsets`` and the validity mask ``seg``:
    ``[B, heads, T, S]``, or ``[B, 1, T, S]`` without ALiBi (the same for
    every head)."""
    from zero_transformer_tpu_torch.ops.positions import NEG_INF, alibi_slopes

    q_pos = torch.tensor(offsets, device="cuda")[:, None] + torch.arange(T, device="cuda")
    dist = q_pos[:, :, None] - torch.arange(S, device="cuda")
    if slopes is None:
        slopes = alibi_slopes(heads, "cuda") if alibi else torch.zeros(1, device="cuda")
    bias = -slopes[None, :, None, None] * dist.clamp(min=0)[:, None].float()
    bias = bias + torch.where(dist >= 0, 0.0, NEG_INF)[:, None]
    bias = bias + torch.where(seg != 0, 0.0, NEG_INF)[:, None, None, :]
    return bias.to(dtype)


def kernel_phase():
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import flash, paged_attention as pa

    rows = {}
    # ---- K1: flash_serving forward, chunked prefill windows
    main_offsets = [0, 256, 512, 896]
    cases = [
        ("main", 4, CHUNK, CACHE, H, torch.bfloat16, main_offsets, [o + CHUNK for o in main_offsets]),
        ("f32", 4, CHUNK, CACHE, H, torch.float32, main_offsets, [o + CHUNK for o in main_offsets]),
        ("edges", 3, CHUNK, CACHE, H, torch.bfloat16, [0, 64, 960], [5, 100, 1000]),
        ("gqa_ragged_T", 2, 40, 256, 4, torch.bfloat16, [16, 200], [56, 240]),
    ]
    for label, B, T, S, KVH, dtype, offs_l, lens in cases:
        q, k, v, offs, seg = flash_case(B, T, S, KVH, dtype, offs_l, lens, seed=len(label))
        got, lse = flash.flash_serving(q, k, v, causal=True, alibi=True, q_offset=offs,
                                       segment_ids=seg, return_lse=True)
        ref, ref_lse = flash.flash_reference(q, k, v, causal=True, alibi=True, q_offset=offs,
                                             segment_ids=seg)
        torch.cuda.synchronize()
        err = compare(got, ref, dtype, f"flash {label}")
        compare(lse, ref_lse, torch.float32 if dtype == torch.float32 else dtype, f"flash lse {label}")
        line = {"kernel": "flash_serving_fwd", "case": label, "dtype": str(dtype), "max_err": err}
        if dtype == torch.bfloat16:
            line["mma"] = check_mma(got, lse, q, k, v, offs, seg, label, shifted=label == "main")
        log(line)
        if label == "main":
            check_deterministic_fwd(lambda: flash.flash_serving(q, k, v, causal=True, alibi=True, q_offset=offs,
                                                                segment_ids=seg, return_lse=True), "serving main")
            kern = time_ms(lambda: flash.flash_serving(q, k, v, causal=True, alibi=True,
                                                       q_offset=offs, segment_ids=seg))
            plain = time_ms(lambda: flash.flash_reference(q, k, v, causal=True, alibi=True,
                                                          q_offset=offs, segment_ids=seg))
            bias = sdpa_bias(B, T, S, offs_l, seg, dtype)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias))
            bound, by = flash_bound(B, T, offs_l, KVH, dtype)
            dev = device_ms(lambda: flash.flash_serving(q, k, v, causal=True, alibi=True,
                                                        q_offset=offs, segment_ids=seg))
            rows["flash_serving_fwd"] = dict(max_abs_err=err, ms=kern, device_ms=dev, plain_ms=plain,
                                             library_ms=lib, bound_ms=bound, bound_by=by)
            log({"kernel": "flash_serving_fwd", **rows["flash_serving_fwd"]})

    # ---- K4: paged decode
    main_offsets = [5, 300, 700, 1000]
    cases = [  # (label, B, T, KVH, dtype, offsets, trash_row, nan_row[, Hq, D, cache])
        ("main", 4, 1, H, torch.bfloat16, main_offsets, None, None),
        ("f32", 4, 1, H, torch.float32, main_offsets, None, None),
        ("edges", 4, 1, H, torch.bfloat16, [0, 15, 16, 1023], None, None),
        ("trash_nan", 4, 1, H, torch.bfloat16, [0, 63, 64, 500], 0, 2),
        ("verify_gqa", 3, 5, 4, torch.bfloat16, [10, 127, 600], None, None),
        ("verify_f32", 2, 8, H, torch.float32, [0, 1000], None, None),
        ("long", 4, 1, LONG_KVH, torch.bfloat16, LONG_OFFSETS, None, None, LONG_HQ, LONG_D, LONG_CACHE),
        # clusters of 3 and of 1 CTA: caches of 3 pages and of one
        ("three_splits", 4, 1, H, torch.bfloat16, [0, 17, 40, 47], None, None, H, D, 3 * PAGE),
        ("one_split_f32", 2, 3, 4, torch.float32, [0, 13], None, None, H, D, PAGE),
    ]
    for label, B, T, KVH, dtype, offs_l, trash_row, nan_row, *shape in cases:
        Hq, Dh, cache = shape or (H, D, CACHE)
        q, kp, vp, table, offs = paged_case(B, T, cache // PAGE, KVH, dtype, offs_l, seed=len(label) + 7,
                                            trash_row=trash_row, nan_row=nan_row, Hq=Hq, Dh=Dh)
        causal = T > 1
        got = pa.paged_attention(q, kp, vp, table, offs, causal=causal, alibi=True)
        ref = pa.paged_reference(q, kp, vp, table, offs, causal=causal, alibi=True)
        torch.cuda.synchronize()
        err = compare(got, ref, dtype, f"paged {label}")
        if nan_row is not None and not bool(torch.isnan(got[nan_row]).all()):
            raise AssertionError("paged: a NaN-poisoned q row did not come out NaN")
        line = {"kernel": "paged_attention", "case": label, "dtype": str(dtype), "shape": [B, T, Hq, KVH, Dh],
                "cache": cache, "max_err": err}
        if label in ("main", "long"):
            check_deterministic_fwd(lambda: (pa.paged_attention(q, kp, vp, table, offs, causal=causal, alibi=True),),
                                    f"K4 {label}", kernel="k4_o")
        if label == "long":
            call = lambda k_, v_: pa.paged_attention(q, k_, v_, table, offs, causal=False, alibi=True)  # noqa: E731
            line["device_ms"] = device_ms(lambda: call(kp, vp))
            line["device_ms_cold"], line["cold_copies"] = cold_device_ms(
                call, (kp, vp), k4_touched_bytes(offs_l, T, KVH, 2 * Dh, cache))
        log(line)
        if label == "main":
            kern = time_ms(lambda: pa.paged_attention(q, kp, vp, table, offs, causal=False, alibi=True))
            plain = time_ms(lambda: pa.paged_reference(q, kp, vp, table, offs, causal=False, alibi=True))
            valid = (torch.arange(CACHE, device="cuda")[None, :] < offs[:, None] + T).int()
            bias = sdpa_bias(B, T, CACHE, offs_l, valid, dtype)

            def library():
                kk = pa.gather_pages(kp, table).transpose(1, 2)
                vv = pa.gather_pages(vp, table).transpose(1, 2)
                return F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv, attn_mask=bias)

            lib = time_ms(library)
            bound, by = paged_bound(B, T, offs_l, KVH, dtype)
            call = lambda k_, v_: pa.paged_attention(q, k_, v_, table, offs, causal=False, alibi=True)  # noqa: E731
            dev = device_ms(lambda: call(kp, vp))
            cold, copies = cold_device_ms(call, (kp, vp), k4_touched_bytes(offs_l, T, KVH, 2 * D))
            rows["paged_attention"] = dict(max_abs_err=err, ms=kern, device_ms=dev, device_ms_cold=cold,
                                           cold_copies=copies, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                           bound_by=by)
            log({"kernel": "paged_attention", **rows["paged_attention"]})
    return rows


# ------------------------------------------------------------- int8 kernels


def within(got: torch.Tensor, ref: torch.Tensor, dtype) -> bool:
    """Whether ``compare`` would pass: the same NaN pattern and every
    finite entry within the dtype's bar."""
    try:
        compare(got, ref, dtype, "control")
    except AssertionError:
        return False
    return True


def int8_paged_case(B, T, Hq, KVH, Dh, dtype, offsets, seed, trash_row=None, nan_row=None, cache=CACHE):
    """q and int8 K/V pools quantized by the model's ``_quantize_kv`` from
    random K/V whose magnitude varies by up to e^2 either way between
    (position, kv head) rows, every 7th position all zero; the trash page 0
    keeps zero values and zero scales, as ``allocate_pools`` leaves it."""
    from zero_transformer_tpu_torch.models.gpt import _quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    n_blocks = cache // PAGE
    n_pages = B * n_blocks + 1
    q = torch.randn(B, T, Hq, Dh, generator=g, device="cuda").to(dtype)
    pools = []
    for _ in range(2):
        x = torch.randn(n_pages, PAGE, KVH, Dh, generator=g, device="cuda")
        x = x * torch.exp(torch.rand(n_pages, PAGE, KVH, 1, generator=g, device="cuda") * 4 - 2)
        x[:, ::7] = 0.0
        xq, xs = _quantize_kv(x)
        xq[0], xs[0] = 0, 0.0
        pools += [xq, xs]
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = torch.zeros(B, n_blocks, dtype=torch.int32)
    used = 0
    for b, off in enumerate(offsets):
        need = min(n_blocks, -(-(off + T) // PAGE))
        table[b, :need] = perm[used:used + need]
        used += need
    if trash_row is not None:
        table[trash_row] = 0
    if nan_row is not None:
        q[nan_row] = float("nan")
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    kq, ks, vq, vs = pools
    return q, kq, vq, ks, vs, table.to("cuda"), offs


def int8_paged_bound(B, T, offsets, Hq, KVH, Dh, dtype, cache=CACHE):
    """Least time for K4 over int8 pools: q read and the output written in
    ``dtype``, each visible key's int8 K and V rows and float32 scales, the
    table and offsets read once, against HBM; or the flops over the causal
    (query, key) pairs against the dtype's peak, whichever is larger."""
    el = torch.finfo(dtype).bits // 8
    keys = sum(min(o + T, cache) for o in offsets)
    nbytes = 2 * B * T * Hq * Dh * el + 2 * keys * KVH * (Dh + 4) + 4 * B * (cache // PAGE) + 4 * B
    flops = 4 * window_pairs(offsets, T, cache) * Dh * Hq
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def shift_scales(sc: torch.Tensor, what: str) -> torch.Tensor:
    """A scale pool as a kernel that reads the wrong scale would see it:
    each position the scale of the next position in the pool, or each kv
    head the scale of the next kv head."""
    if what == "next_position":
        return sc.reshape(-1, sc.shape[2], 1).roll(-1, 0).reshape(sc.shape)
    return sc.roll(-1, 2)


# (label, B, T, Hq, KVH, D, dtype, offsets, trash_row, nan_row); "main" is
# the 125m serving decode shape of the kernel phase's K4 "main"
INT8_CASES = [
    ("main", 4, 1, H, H, D, torch.bfloat16, [5, 300, 700, 1000], None, None),
    ("f32", 4, 1, H, H, D, torch.float32, [5, 300, 700, 1000], None, None),
    ("edges", 4, 1, H, H, D, torch.bfloat16, [0, 63, 64, 65], None, None),
    ("edges_f32", 4, 1, H, H, D, torch.float32, [300, 1023, 64, 0], None, None),
    ("verify_T3", 4, 3, H, H, D, torch.bfloat16, [0, 63, 300, 1020], None, None),
    ("verify_T3_f32", 4, 3, H, H, D, torch.float32, [64, 65, 1000, 7], None, None),
    ("verify_T8", 2, 8, H, H, D, torch.bfloat16, [64, 1016], None, None),
    ("verify_T8_f32", 2, 8, H, H, D, torch.float32, [65, 1000], None, None),
    ("gqa", 4, 1, H, 4, D, torch.bfloat16, [63, 300, 700, 1023], None, None),
    ("gqa_T3_f32", 3, 3, H, 4, D, torch.float32, [10, 127, 600], None, None),
    ("d128", 3, 1, 8, 8, 128, torch.bfloat16, [0, 65, 1023], None, None),
    ("d128_gqa_f32", 3, 3, 8, 2, 128, torch.float32, [64, 300, 1000], None, None),
    ("trash_nan", 4, 1, H, H, D, torch.bfloat16, [0, 63, 64, 500], 0, 2),
    ("trash_nan_f32", 4, 1, H, H, D, torch.float32, [300, 63, 64, 1023], 1, 3),
    # the kernel phase's K4 "long" (cache LONG_CACHE)
    ("long", 4, 1, LONG_HQ, LONG_KVH, LONG_D, torch.bfloat16, LONG_OFFSETS, None, None),
]


def int8_kernel_phase():
    """K4's int8 branch against its plain version (gather the pages and
    scales, dequantize, the reference attention)."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.models.gpt import _quantize_kv
    from zero_transformer_tpu_torch.ops import paged_attention as pa

    # the model's quantizer on the card rounds as on the CPU, where the
    # tests pin it bit for bit to JAX's _quantize_kv
    g = torch.Generator(device="cuda").manual_seed(399)
    x = torch.randn(257, PAGE, H, D, generator=g, device="cuda")
    x = x * torch.exp(torch.rand(257, PAGE, H, 1, generator=g, device="cuda") * 8 - 4)
    (cq, cs), (hq, hs) = _quantize_kv(x), _quantize_kv(x.cpu())
    if not (torch.equal(cq.cpu(), hq) and torch.equal(cs.cpu().view(torch.int32), hs.view(torch.int32))):
        raise AssertionError("_quantize_kv on the card differs from the CPU's bits")
    log({"quantize_kv_card_equals_cpu": {"rows": x.numel() // D, "equal": True}})

    rows = {}
    for label, B, T, Hq, KVH, Dh, dtype, offs_l, trash_row, nan_row in INT8_CASES:
        cache = LONG_CACHE if label == "long" else CACHE
        q, kq, vq, ks, vs, table, offs = int8_paged_case(B, T, Hq, KVH, Dh, dtype, offs_l, len(label) + 400,
                                                         trash_row, nan_row, cache)
        kw = dict(causal=T > 1, alibi=True)
        got = pa.paged_attention(q, kq, vq, table, offs, k_scale=ks, v_scale=vs, **kw)
        ref = pa.paged_reference(q, kq, vq, table, offs, k_scale=ks, v_scale=vs, **kw)
        torch.cuda.synchronize()
        err = compare(got, ref, dtype, f"paged int8 {label}")
        if nan_row is not None and not bool(torch.isnan(got[nan_row]).all()):
            raise AssertionError(f"paged int8 {label}: a NaN-poisoned q row did not come out NaN")
        if trash_row is not None and not bool((got[trash_row] == 0).all()):
            raise AssertionError(f"paged int8 {label}: a row on the zero-scale trash page is not all zero")
        line = {"kernel": "paged_attention_int8", "case": label, "dtype": str(dtype),
                "shape": [B, T, Hq, KVH, Dh], "max_err": err}
        if label in ("main", "gqa", "verify_T3"):
            # the bar must see the scale walk: a plain version that reads the
            # scale of the next position, or of the next kv head, fails it
            for what in ("next_position", "next_kv_head"):
                bad = pa.paged_reference(q, kq, vq, table, offs, k_scale=shift_scales(ks, what),
                                         v_scale=shift_scales(vs, what), **kw)
                if within(got, bad, dtype):
                    raise AssertionError(f"paged int8 {label}: the {what} scale control passes the bar")
                line[f"{what}_control_max_err"] = float((got.float() - bad.float()).nan_to_num().abs().max())
        # the pools with their scales, as a call takes them
        call = lambda kq_, vq_, ks_, vs_: pa.paged_attention(q, kq_, vq_, table, offs, k_scale=ks_,  # noqa: E731
                                                             v_scale=vs_, **kw)
        touched = k4_touched_bytes(offs_l, T, KVH, Dh + 4, cache)
        if label in ("main", "long"):
            check_deterministic_fwd(lambda: (call(kq, vq, ks, vs),), f"K4 int8 {label}", kernel="k4_o")
        if label == "long":
            line["device_ms"] = device_ms(lambda: call(kq, vq, ks, vs))
            line["device_ms_cold"], line["cold_copies"] = cold_device_ms(call, (kq, vq, ks, vs), touched)
        log(line)
        if label != "main":
            continue
        kern = time_ms(lambda: pa.paged_attention(q, kq, vq, table, offs, k_scale=ks, v_scale=vs, **kw))
        kern_dev = device_ms(lambda: pa.paged_attention(q, kq, vq, table, offs, k_scale=ks, v_scale=vs, **kw))
        kern_cold, copies = cold_device_ms(call, (kq, vq, ks, vs), touched)
        plain = time_ms(lambda: pa.paged_reference(q, kq, vq, table, offs, k_scale=ks, v_scale=vs, **kw))
        kd, vd = pa.dequantize(kq, ks, dtype), pa.dequantize(vq, vs, dtype)
        bf16_k4 = time_ms(lambda: pa.paged_attention(q, kd, vd, table, offs, **kw))
        bf16_k4_dev = device_ms(lambda: pa.paged_attention(q, kd, vd, table, offs, **kw))
        valid = (torch.arange(CACHE, device="cuda")[None, :] < offs[:, None] + T).int()
        bias = sdpa_bias(B, T, CACHE, offs_l, valid, dtype)

        def library():
            kk = pa.dequantize(pa.gather_pages(kq, table), pa.gather_pages(ks, table), dtype).transpose(1, 2)
            vv = pa.dequantize(pa.gather_pages(vq, table), pa.gather_pages(vs, table), dtype).transpose(1, 2)
            return F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv, attn_mask=bias)

        lib = time_ms(library)
        bound, by = int8_paged_bound(B, T, offs_l, Hq, KVH, Dh, dtype)
        rows["paged_attention_int8"] = dict(max_abs_err=err, ms=kern, device_ms=kern_dev, device_ms_cold=kern_cold,
                                            cold_copies=copies, plain_ms=plain, library_ms=lib, bound_ms=bound,
                                            bound_by=by)
        log({"kernel": "paged_attention_int8", "shape": [B, T, Hq, KVH, Dh], "offsets": offs_l,
             "bf16_k4_on_dequantized_pools_ms": bf16_k4,
             "bf16_k4_on_dequantized_pools_device_ms": bf16_k4_dev, **rows["paged_attention_int8"]})
    return rows


# ------------------------------------------------ K4 anatomy (opt-in phase)

# each "marks" stamp: (name, source line it goes after, or before when the
# name starts with "<")
K4_MARKS = (
    ("start", "  cg::cluster_group cluster = cg::this_cluster();\n"),
    ("rows_q_loaded", "hopper::mbar_init(&full[st], THREADS);\n  }\n  __syncthreads();\n"),
    ("first_tile", "hopper::mbar_wait(&full[slot], (j / n_stages) & 1);  // each warp on its own: no CTA barrier\n"),
    ("<tiles_done", "  // merge the warp's key groups"),
    ("<ctas_merged", "  // the CTA's (m, l, o) into the leader's inbox"),
    ("cluster_started", "  hopper::cluster_wait();\n  float* lead_m = "),
    ("<inbox_written", "  hopper::cluster_arrive();  // release"),
    ("<cluster_done", "  if (split != 0) return;\n"),
)


def k4_variant(name: str) -> str:
    """``csrc/paged_attention.cu`` rewritten for ``k4_anatomy``: "no_compute"
    skips every tile's keys (copies and waits stay), "no_copies" issues no
    K/V copy (the compute reads whatever the ring holds), "marks" has thread
    0 of each CTA store %globaltimer at each of ``K4_MARKS`` (slot 9: its
    tile count) into a device array that ``k4_marks_read`` copies out."""
    from zero_transformer_tpu_torch.ops import _build

    src = (_build.CSRC / "paged_attention.cu").read_text()

    def sub(old, new):
        if src.count(old) != 1:
            raise AssertionError(f"k4_anatomy: the kernel source no longer has {old!r} once")
        return src.replace(old, new)

    if name == "no_compute":
        src = sub("    const int kt_end = min(TILE, n_local - j * TILE);\n", "    const int kt_end = 0;\n")
    elif name == "no_copies":
        src = sub("hopper::copy16(", "if (false) hopper::copy16(")
    elif name == "marks":
        cta = "(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * 12"
        stamp = ("  if (threadIdx.x == 0) {{ unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
                 "\"=l\"(t_)); k4_marks[" + cta + " + {i}] = t_; }}\n")
        src = sub("namespace cg = cooperative_groups;\n",
                  "namespace cg = cooperative_groups;\n__device__ unsigned long long k4_marks[16384 * 12];\n")
        for i, (mark, line) in enumerate(K4_MARKS):
            text = stamp.format(i=i)
            if mark == "first_tile":
                text = "    if (j == 0) {\n" + text + "    }\n"
            if mark == "<tiles_done":
                text += "  if (threadIdx.x == 0) k4_marks[" + cta + " + 9] = n_tiles;\n"
            if line.endswith("float* lead_m = "):  # between the wait and the next line
                src = sub(line, line.replace("float* lead_m", text.strip() + "\n  float* lead_m"))
            else:
                src = sub(line, text + line if mark.startswith("<") else line + text)
        src += ('\nextern "C" int k4_marks_read(void* dst, int n) {\n'
                '  return (int)cudaMemcpyFromSymbol(dst, k4_marks, (size_t)n * 12 * 8);\n}\n')
    return src


def k4_anatomy_phase():
    """Where K4's time goes, at the kernel phase's main and long cases:
    device time of the kernel and of two variants (no compute, no copies),
    built apart from the same source under ``build/k4_anatomy/``; then the
    marks variant's per-CTA phase durations (median and maximum over CTAs
    with a live key) and its start-to-end span."""
    import ctypes

    from zero_transformer_tpu_torch.ops import _build, paged_attention as pa
    from zero_transformer_tpu_torch.ops.flash import slopes_on

    out = _build.BUILD_DIR.parent / "k4_anatomy"
    out.mkdir(parents=True, exist_ok=True)
    names = ("kernel", "no_compute", "no_copies", "marks")
    procs = {}
    for name in names:
        (out / f"{name}.cu").write_text(k4_variant(name))
        procs[name] = subprocess.Popen([_build._nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o",
                                        str(out / f"{name}.so"), str(out / f"{name}.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode:
            raise AssertionError(f"k4_anatomy: nvcc failed for {name}:\n{log_text}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
        libs[name].paged_attention.argtypes = _build.SIGNATURES["paged_attention"]["paged_attention"]
    libs["marks"].k4_marks_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for label, B, KVH, offs_l, Hq, Dh, cache in (("main", 4, H, [5, 300, 700, 1000], H, D, CACHE),
                                                 ("long", 4, LONG_KVH, LONG_OFFSETS, LONG_HQ, LONG_D, LONG_CACHE)):
        q, kp, vp, table, offs = paged_case(B, 1, cache // PAGE, KVH, torch.bfloat16, offs_l, seed=len(label) + 7,
                                            Hq=Hq, Dh=Dh)
        o = torch.empty_like(q)
        per, n = pa.split_plan(table.shape[1], PAGE)
        slopes = slopes_on(Hq, "cuda", True)
        args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(), offs.data_ptr(), slopes.data_ptr(),
                o.data_ptr(), 1, B, 1, Hq, KVH, Dh, PAGE, table.shape[1], per, n, Dh**-0.5, 0, 1,
                torch.cuda.current_stream().cuda_stream)
        ref = pa.paged_attention(q, kp, vp, table, offs, causal=False, alibi=True)
        line = {"k4_anatomy": label}
        for name in names[:3]:
            _build.check(libs[name].paged_attention(*args), f"k4_anatomy {name}")
            torch.cuda.synchronize()
            if name == "kernel" and not torch.equal(o, ref):
                raise AssertionError("k4_anatomy: the rebuilt kernel differs from the package's")
            line[f"{name}_device_ms"] = device_ms(lambda: libs[name].paged_attention(*args))
        R = Hq // KVH
        n_cta = n * KVH * -(-R // (1 if R == 1 else 2 if R == 2 else 4 if R <= 4 else 8)) * B
        torch.cuda._sleep(1 << 22)
        _build.check(libs["marks"].paged_attention(*args), "k4_anatomy marks")
        torch.cuda.synchronize()
        t = np.zeros(n_cta * 12, np.uint64)
        libs["marks"].k4_marks_read(t.ctypes.data, n_cta)
        t = t.reshape(n_cta, 12).astype(np.int64)
        live = t[:, 9] > 0
        stamps = t[live][:, :len(K4_MARKS)]
        steps = np.diff(stamps, axis=1) / 1e3
        line["marks_us"] = {
            "ctas": n_cta, "live_ctas": int(live.sum()),
            "span": float((t[:, len(K4_MARKS) - 1].max() - t[:, 0].min()) / 1e3),
            **{f"{K4_MARKS[i][0].lstrip('<')}->{K4_MARKS[i + 1][0].lstrip('<')}": [float(np.median(steps[:, i])),
                                                                                  float(steps[:, i].max())]
               for i in range(len(K4_MARKS) - 1)},
        }
        log(line)


# ------------------------------------------------------------------ serving

PROMPT_LENS = (5, 63, 64, 65, 300, 900)
MAX_NEW = 32
SEED = 0


def prompt_text(n: int, salt: int) -> str:
    """``n`` printable non-space bytes (one byte-tokenizer token each)."""
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    return "".join(alphabet[(7 * i + 3 * salt + i // 11) % len(alphabet)] for i in range(n))


# the CLI's --kv-cache-dtype int8 --quantize int8
INT8 = dict(kv="int8", weights="int8")


def build_engine(impl: str, dtype=torch.bfloat16, kv: str = "auto", weights: str = "none", name: str = "125m",
                 state=None, cache_len: int = CACHE, draft_k: int = 0, **cfg):
    """The serving engine over ``name`` with seed-``SEED`` weights (or
    ``state``), its KV cache in ``kv`` ("auto" or "int8"); ``weights="int8"``
    quantizes the weights with ``quant.quantize_model`` (the values of the
    CLI's host route ``--quantize int8``, computed where the weights lie);
    ``cfg``: more config overrides (``n_layers``). An earlier engine's
    memory is collected first: an 8B model in float32 is 32 GB."""
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.models.quant import quantize_model
    from zero_transformer_tpu_torch.serving import ServingEngine

    gc.collect()

    model = model_getter(name, dtype=dtype, device="cuda", seed=SEED if state is None else None,
                         attention_impl=impl, kv_cache_dtype=kv, **cfg)
    if state is not None:
        model.load_state_dict(state)
    if weights == "int8":
        model = quantize_model(model)
    return ServingEngine(model, n_slots=SLOTS, cache_len=cache_len, sampling=SamplingConfig(greedy=True),
                         prefill_chunk=CHUNK, page_size=PAGE, draft_k=draft_k, device="cuda")


def http(method: str, url: str, body=None, timeout: float = 300.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def serving_phase(int8: bool = False, name: str = "125m", cache_len: int = CACHE, label: str = "serving",
                  draft_k: int = 0, dtype=torch.bfloat16, after=None):
    """``name`` (125m) in ``dtype`` behind the port's HTTP server; concurrent
    greedy requests. With ``int8``: int8 weights and KV cache, served through
    K4's int8 branch. With ``draft_k``: every decode tick verifies that many
    prompt-lookup drafts a slot (the CLI's ``--draft-k``). ``after(engine)``
    runs once the readings are printed, on the same engine."""
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.serve import ByteTokenizer
    from zero_transformer_tpu_torch.serving import ServingServer

    label = f"int8_{label}" if int8 else label
    t_build = time.perf_counter()
    engine = build_engine("auto", dtype, name=name, cache_len=cache_len, draft_k=draft_k, **(INT8 if int8 else {}))
    build_s = time.perf_counter() - t_build
    # warm-up (cuBLAS handles, the allocator, both kernels) through the
    # trash page only: an all-zero table at position 0 touches no slot
    with torch.no_grad():
        zeros = torch.zeros(SLOTS, cache_len // PAGE, dtype=torch.int32, device="cuda")
        at0 = torch.zeros(SLOTS, dtype=torch.int32, device="cuda")
        for T in (CHUNK, 1):
            engine.model.forward_paged(torch.zeros(SLOTS, T, dtype=torch.long, device="cuda"),
                                       engine.pools, zeros, at0)
    torch.cuda.synchronize()
    server = ServingServer(engine, ByteTokenizer(), host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        for _ in range(600):
            try:
                if http("GET", base + "/healthz", timeout=10)[0] == 200:
                    break
            except urllib.error.HTTPError:
                time.sleep(0.05)
        results = [None] * len(PROMPT_LENS)

        def client(i, n):
            body = {"prompt": prompt_text(n, i), "max_new_tokens": MAX_NEW, "seed": i,
                    "stream": i % 2 == 1}
            code, text = http("POST", base + "/generate", body)
            if body["stream"]:
                events = [json.loads(x[6:]) for x in text.splitlines() if x.startswith("data: ")]
                toks = [e["token"] for e in events if "token" in e]
                results[i] = (code, events[-1]["status"], toks)
            else:
                doc = json.loads(text)
                results[i] = (code, doc["status"], doc["tokens"])

        _build.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i, n)) for i, n in enumerate(PROMPT_LENS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        _, text = http("GET", base + "/metrics")
        metrics = json.loads(text)
    finally:
        server.stop()
    for i, n in enumerate(PROMPT_LENS):
        if results[i] is None:
            raise AssertionError(f"request with a {n}-token prompt got no answer")
        code, status, toks = results[i]
        if code != 200 or status != "done" or len(toks) != MAX_NEW:
            raise AssertionError(f"{n}-token prompt: HTTP {code}, {status}, {len(toks)} tokens")
    if metrics["poisoned_slots"]:
        raise AssertionError(f"{metrics['poisoned_slots']} slots saw non-finite logits")
    paged = "paged_attention_int8" if int8 else "paged_attention"
    if not all(launches[k] > 0 for k in ("flash_serving_fwd", paged)):
        raise AssertionError(f"a kernel of the {label} path never launched: {launches}")
    if int8 and launches["paged_attention"]:
        raise AssertionError(f"the int8 path launched the bf16 paged kernel: {launches}")
    summary = {
        "requests": len(PROMPT_LENS), "prompt_lens": PROMPT_LENS, "max_new_tokens": MAX_NEW,
        "wall_s": wall, "tokens_out": metrics["tokens_out"],
        "ttft_ms_p50": metrics["ttft_ms_p50"], "ttft_ms_p99": metrics["ttft_ms_p99"],
        "itl_ms_p50": metrics["itl_ms_p50"], "itl_ms_p99": metrics["itl_ms_p99"],
        "decode_tok_s": metrics["decode_tok_s"], "decode_ticks": metrics["decode_ticks"],
        "prefill_ticks": metrics["prefill_ticks"],
        "kv_cache_dtype": metrics["kv_cache_dtype"], "kv_pool_bytes": metrics["kv_pool_bytes"],
        "param_quant": metrics["param_quant"], "weight_bytes": metrics["weight_bytes"],
        "paged_launches_per_decode_tick": launches[paged] / metrics["decode_ticks"],
        "flash_launches_per_prefill_tick": launches["flash_serving_fwd"] / metrics["prefill_ticks"],
        "launches": {k: c for k, c in launches.items() if c},
        "model": name, "layers": engine.cfg.n_layers, "cache_len": cache_len, "engine_build_s": build_s,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        **({k: metrics[k] for k in ("draft_k", "spec_ticks", "draft_tokens", "accepted_tokens", "acceptance_rate")}
           if draft_k else {}),
    }
    log({label: summary})
    if after is not None:
        after(engine)
    return launches, [r[2] for r in results], summary


def kernel_times(prof) -> dict:
    """{kernel name: (device ms, launches)} from a ``torch.profiler`` run.
    Kernel events only: CPU ops also carry the device time of what they
    launched, and counting both would double it; user annotations
    (``record_function`` spans, which the profiler also lays on the device
    timeline) are not kernels either."""
    kernels = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA") and not getattr(ev, "is_user_annotation", False):
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            kernels[ev.key] = (dev_us / 1e3, ev.count)
    return kernels


def top_kernels(kernels: dict, n: int, per: int, width: int) -> dict:
    """The ``n`` largest kernels by device time, in ms per tick or step
    (``per`` of them), under their names cut to ``width`` characters;
    kernels whose cut names coincide are summed."""
    out = {}
    for k, (ms, _) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:n]:
        out[k[:width]] = out.get(k[:width], 0.0) + ms / per
    return out


def profile_phase(ticks: int = 10, int8: bool = False, name: str = "125m", cache_len: int = CACHE,
                  label: str = "profile"):
    """Where a decode tick's time goes: four 300-token streams prefilled,
    then ``ticks`` decode ticks under ``torch.profiler``. Device busy time is
    the sum of the CUDA kernels' self time; its share of the ticks' wall time
    says how far the host holds the card back. (The host clock around the
    profiled ticks includes the profiler's own overhead; the untraced tick
    time is the serving phase's ITL.) ``int8``: int8 weights and KV cache."""
    from torch.profiler import ProfilerActivity, profile

    engine = build_engine("auto", name=name, cache_len=cache_len, **(INT8 if int8 else {}))
    for i in range(SLOTS):
        engine.submit(list(prompt_text(300, 70 + i).encode()), max_new_tokens=ticks + 10, seed=i)
    while engine.active_count < SLOTS:
        engine.step()
    engine.step()  # one tick with every slot decoding, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_times(prof)
    busy_ms = sum(ms for ms, _ in kernels.values())
    log({f"int8_{label}" if int8 else label: {
        "decode_ticks": ticks, "slots": SLOTS, "wall_ms_per_tick": wall_ms / ticks,
        "device_busy_ms_per_tick": busy_ms / ticks if kernels else "not measured",
        "device_busy_share": busy_ms / wall_ms if kernels else "not measured",
        "device_launches_per_tick": sum(c for _, c in kernels.values()) / ticks,
        "top_kernels_ms_per_tick": top_kernels(kernels, 8, ticks, 60),
    }})


def forced_logits(engine, prompts, table, forced=None, steps: int = 4):
    """Prefill ``prompts`` chunk by chunk through ``forward_paged``, then
    decode ``steps`` tokens: the given ``forced`` tokens, or greedy. Returns
    the logits [B, V] (float32) of the prefill's last position and of each
    decode step, and the tokens fed."""
    from zero_transformer_tpu_torch.inference.generate import allocate_pools

    B = len(prompts)
    lens = [len(p) for p in prompts]
    pools = allocate_pools(engine.cfg, table.shape[0] * table.shape[1] + 1, PAGE, "cuda")
    model = engine.model
    fill, last = [0] * B, [None] * B
    with torch.no_grad():
        while any(f < n for f, n in zip(fill, lens)):
            rows = [b for b in range(B) if fill[b] < lens[b]]
            toks = [prompts[b][fill[b]:fill[b] + CHUNK] for b in rows]
            toks = [t + [0] * (CHUNK - len(t)) for t in toks]
            offs = torch.tensor([fill[b] for b in rows], dtype=torch.int32, device="cuda")
            h = model.forward_paged(torch.tensor(toks, device="cuda"), pools, table[rows], offs)
            for r, b in enumerate(rows):
                if fill[b] + CHUNK >= lens[b]:
                    last[b] = model.logits(h[r, lens[b] - 1 - fill[b]]).float()
                fill[b] = min(fill[b] + CHUNK, lens[b])
        out, fed = [torch.stack(last)], []
        for step in range(steps):
            tok = out[-1].argmax(-1) if forced is None else forced[step]
            fed.append(tok)
            offs = torch.tensor([n + step for n in lens], dtype=torch.int32, device="cuda")
            out.append(model.logits(model.forward_paged(tok[:, None], pools, table, offs)[:, 0]).float())
    return out, fed


def checked_reads(engine, prompts, table, forced, dtype=torch.float32):
    """``forced_logits`` on the kernel path, with every layer's attention
    call held against the plain path's read of the same pools: the call
    runs again with ``attention_impl="xla"`` on the same input over a copy
    of the pools as they were before it. Both paths write the same values
    (and int8 scales; checked bit for bit), so only the reads differ: the
    attention output (the out projection's input) must agree within
    ``dtype``'s bar (float32 atol 1e-4, bf16 2e-2). Control (an int8 cache
    at float32): the plain read of pools whose scales are each the next
    position's must miss that bar in every decode call. Returns the logits
    and the readings."""
    import copy

    from zero_transformer_tpu_torch.models.gpt import KVPools
    from zero_transformer_tpu_torch.ops.paged_attention import MAX_DECODE_T

    blocks = engine.model.blocks
    seen = []
    err = {"prefill": 0.0, "decode": 0.0}
    control = []
    hooks = [blk.attn.out.register_forward_pre_hook(lambda _m, args: seen.append(args[0].float()))
             for blk in blocks]
    fwd = type(blocks[0].attn).forward_paged

    controlled = engine.cfg.kv_cache_dtype == "int8" and dtype == torch.float32
    reads = {"prefill": 0, "decode": 0}

    def checked(x, pools, block_table, offsets, cache_len=None, flash=False, *, attn, plain):
        before = KVPools(*(None if t is None else t.clone() for t in (pools.k, pools.v, pools.k_scale,
                                                                        pools.v_scale)))
        out = fwd(attn, x, pools, block_table, offsets, cache_len, flash)
        got = seen.pop()
        if controlled:  # the pools as the call found them, each scale the next position's
            shifted = dataclasses.replace(before, k=before.k.clone(), v=before.v.clone(),
                                          k_scale=shift_scales(before.k_scale, "next_position"),
                                          v_scale=shift_scales(before.v_scale, "next_position"))
        fwd(plain, x, before, block_table, offsets, cache_len, flash)
        want = seen.pop()
        if not all(a is b or torch.equal(a, b) for a, b in ((pools.k, before.k), (pools.v, before.v),
                                                            (pools.k_scale, before.k_scale),
                                                            (pools.v_scale, before.v_scale))):
            raise AssertionError("the kernel and plain paths wrote different pools")
        kind = "prefill" if x.shape[1] > MAX_DECODE_T else "decode"
        err[kind] = max(err[kind], compare(got, want, dtype, f"{engine.cfg.kv_cache_dtype}-cache {kind} read"))
        reads[kind] += 1
        if kind == "decode" and controlled:
            fwd(plain, x, shifted, block_table, offsets, cache_len)
            miss = float((got - seen.pop()).abs().max())
            if not miss > TOL[torch.float32]["atol"]:
                raise AssertionError(f"the next-position scale control reads {miss}: within the bar")
            control.append(miss)
        return out

    for blk in blocks:
        plain = copy.copy(blk.attn)
        plain.cfg = dataclasses.replace(blk.attn.cfg, attention_impl="xla")
        blk.attn.forward_paged = functools.partial(checked, attn=blk.attn, plain=plain)
    try:
        logits, _ = forced_logits(engine, prompts, table, forced)
    finally:
        for blk in blocks:
            del blk.attn.forward_paged
        for h in hooks:
            h.remove()
    readings = {"read_max_abs_err": err, "read_dtype": str(dtype), "reads": reads}
    if controlled:
        readings["next_position_scale_control_min"] = min(control)
    return logits, readings


def greedy_ties(kernel, plain, atol: float) -> dict:
    """Greedy tokens of two float32 paths over the same forced steps: every
    row's argmax must agree unless the plain path's top two logits lie
    within 2 * ``atol`` (a tie the bar cannot order). Returns the counts."""
    same = ties = 0
    for k, x in zip(kernel, plain):
        top2 = torch.topk(x, 2, dim=-1).values
        differ = k.argmax(-1) != x.argmax(-1)
        if bool((differ & (top2[:, 0] - top2[:, 1] > 2 * atol)).any()):
            raise AssertionError(f"float32 greedy tokens differ outside a tie: {k.argmax(-1)} vs {x.argmax(-1)}")
        same += int((~differ).sum())
        ties += int(differ.sum())
    return {"equal": same, "ties": ties}


def parity_phase(kernel_tokens, int8: bool = False, name: str = "125m", cache_len: int = CACHE,
                 label: str = "parity", deep: bool = False, layers=None):
    """The kernels against the plain path (``attention_impl="xla"``): logits
    of a prefill (last position) and four decode steps at the serving
    shapes, every run fed the same tokens, then greedy token agreement of a
    whole plain-path engine run with the serving phase. ``int8``: int8
    weights and an int8 KV cache on both paths.

    float32 with ``int8``: the cache rounds each K/V element to a step of
    max|row| / 127, so a last-bit difference in a layer's input moves an
    element that sits near a rounding edge by a whole step, and the logits
    by ~1e-3 after 12 layers, whichever path computed the difference: two
    paths that each write their own cache drift apart without either being
    wrong. So the 1e-4 bar holds on the logits of int8 weights over a
    float32 cache, where nothing rounds to int8 at run time, and on every
    attention read over the int8 cache where both paths read the same pools
    (``checked_reads``); the whole-model logits over two int8 caches are
    reported without a bar.

    float32: kernel path vs plain path within atol 1e-4 (fatal). bfloat16:
    every layer rounds the residual stream to bf16, so after 12 layers both
    bf16 paths sit a few bf16 ulps of the logits away from the float32
    plain path; the bar (fatal) is that the kernel path is no farther from
    it than the bf16 plain path plus the bf16 tolerance 2e-2. The float32
    paths' greedy tokens agree on every forced step (``greedy_ties``).
    ``name`` at ``cache_len``: the model (125m, cache 1024).

    ``deep`` (llama3_8b, 32 layers at d 4096): both bf16 paths land
    0.40-0.48 of the logits from float32 (H100 readings, a range of 5.7),
    so which of the two is nearer at one step is noise of that size. There
    the bf16 kernel path's every attention read is held against the plain
    read of the same pools at the bf16 bar (``checked_reads``), and the
    whole-model bar compares each path's worst step.

    ``layers``: every model at that depth (full width), and the whole
    engine run compared with the kernel path's own engine run on the same
    requests (``kernel_tokens`` None) instead of the serving phase's."""
    lens = (65, 300, 900)
    n_blocks = cache_len // PAGE
    table = torch.stack([
        torch.arange(1 + b * n_blocks, 1 + (b + 1) * n_blocks, dtype=torch.int32) for b in range(len(lens))
    ]).to("cuda")
    prompts = [[ord(c) for c in prompt_text(n, 50 + b)] for b, n in enumerate(lens)]
    model_of = dict(name=name, cache_len=cache_len, **({"n_layers": layers} if layers else {}))
    quant = dict(INT8 if int8 else {}, **model_of)
    ref, forced = forced_logits(build_engine("xla", torch.float32, **quant), prompts, table)
    int8_cache = {}
    if int8:
        f32_k, int8_cache = checked_reads(build_engine("auto", torch.float32, **quant), prompts, table, forced)
        w_x, _ = forced_logits(build_engine("xla", torch.float32, weights="int8", **model_of), prompts, table, forced)
        w_k, _ = forced_logits(build_engine("auto", torch.float32, weights="int8", **model_of), prompts, table,
                               forced)
        f32_err = max(compare(k, r, torch.float32, f"float32 logits, int8 weights, step {i}")
                      for i, (k, r) in enumerate(zip(w_k, w_x)))
        greedy = greedy_ties(w_k, w_x, TOL[torch.float32]["atol"])
        kernel = [float((k - r).abs().max()) for k, r in zip(f32_k, ref)]
        if not all(math.isfinite(e) for e in kernel):
            raise AssertionError(f"float32 logits over the int8 cache are not finite: {kernel}")
        int8_cache["whole_model_kernel_vs_plain_per_step"] = kernel
    else:
        f32_k, _ = forced_logits(build_engine("auto", torch.float32, **model_of), prompts, table, forced)
        f32_err = max(compare(k, r, torch.float32, f"float32 logits, step {i}")
                      for i, (k, r) in enumerate(zip(f32_k, ref)))
        greedy = greedy_ties(f32_k, ref, TOL[torch.float32]["atol"])
    bf_x, _ = forced_logits(build_engine("xla", **quant), prompts, table, forced)
    bf16_reads = None
    if deep:
        bf_k, bf16_reads = checked_reads(build_engine("auto", **quant), prompts, table, forced, torch.bfloat16)
    else:
        bf_k, _ = forced_logits(build_engine("auto", **quant), prompts, table, forced)
    worst = {"kernel_vs_f32": 0.0, "plain_vs_f32": 0.0, "kernel_vs_plain": 0.0}
    agree, steps, missed = 0, [], []
    for i, (k, x, r) in enumerate(zip(bf_k, bf_x, ref)):
        e_k, e_x = float((k - r).abs().max()), float((x - r).abs().max())
        steps.append([e_k, e_x])
        if not math.isfinite(e_k) or (not deep and e_k > e_x + TOL[torch.bfloat16]["atol"]):
            missed.append(f"bf16 logits step {i}: kernel path {e_k} from float32 vs plain {e_x}")
        worst["kernel_vs_f32"] = max(worst["kernel_vs_f32"], e_k)
        worst["plain_vs_f32"] = max(worst["plain_vs_f32"], e_x)
        worst["kernel_vs_plain"] = max(worst["kernel_vs_plain"], float((k - x).abs().max()))
        agree += int((k.argmax(-1) == x.argmax(-1)).sum())
    # a whole plain-path engine run on the serving phase's requests
    if kernel_tokens is None:
        eng_k = build_engine("auto", **quant)
        hk = [eng_k.submit(list(prompt_text(n, i).encode()), max_new_tokens=MAX_NEW, seed=i)
              for i, n in enumerate(PROMPT_LENS)]
        eng_k.run_until_idle()
        kernel_tokens = [h.tokens for h in hk]
        del eng_k
    eng_x = build_engine("xla", **quant)
    handles = [eng_x.submit(list(prompt_text(n, i).encode()), max_new_tokens=MAX_NEW, seed=i)
               for i, n in enumerate(PROMPT_LENS)]
    eng_x.run_until_idle()
    same = sum(int(a == b) for h, ref_toks in zip(handles, kernel_tokens) for a, b in zip(h.tokens, ref_toks))
    prefix = [next((j for j, (a, b) in enumerate(zip(h.tokens, ref_toks)) if a != b), len(ref_toks))
              for h, ref_toks in zip(handles, kernel_tokens)]
    log({f"int8_{label}" if int8 else label: {
        "float32_logits_max_abs_err": f32_err, "float32_tol": TOL[torch.float32],
        "float32_greedy_kernel_vs_plain": greedy,
        **({"bf16_checked_reads": bf16_reads} if bf16_reads else {}),
        **({"float32_int8_cache": int8_cache} if int8 else {}),
        "bf16_logits_max_abs_err": worst, "logit_range": float(ref[0].abs().max()),
        "bf16_per_step_kernel_plain_vs_f32": steps,
        "bf16_argmax_agree": f"{agree}/{len(lens) * len(bf_k)}",
        "engine_tokens_agree": f"{same}/{MAX_NEW * len(PROMPT_LENS)}",
        "engine_identical_prefix": prefix,
    }})
    if deep and not max(k for k, _ in steps) <= max(x for _, x in steps) + TOL[torch.bfloat16]["atol"]:
        missed.append(f"bf16 logits: the kernel path's worst step {max(k for k, _ in steps)} from float32 "
                      f"vs the plain path's {max(x for _, x in steps)}")
    if missed:  # after the readings are printed
        raise AssertionError("; ".join(missed))


# --------------------------------------------------------- training kernels

# (label, B, T, H, KVH, D, dtype, causal, alibi); "main" is the training shape
TRAIN_CASES = [
    ("main", 8, 1024, 12, 12, 64, torch.bfloat16, True, True),
    ("f32", 2, 1024, 12, 12, 64, torch.float32, True, True),
    ("gqa", 2, 256, 8, 2, 64, torch.bfloat16, True, True),
    ("gqa_f32", 2, 256, 8, 2, 64, torch.float32, True, True),
    ("no_alibi_f32", 2, 192, 4, 4, 64, torch.float32, True, False),
    ("non_causal", 2, 320, 4, 4, 64, torch.bfloat16, False, True),
    ("non_causal_f32", 2, 320, 4, 4, 64, torch.float32, False, True),
    ("ragged_T", 2, 1000, 12, 12, 64, torch.bfloat16, True, True),
    ("ragged_T_f32", 1, 1000, 4, 4, 64, torch.float32, True, True),
    ("d128_gqa_f32", 1, 200, 4, 2, 128, torch.float32, True, True),
    ("d128_gqa", 1, 200, 4, 2, 128, torch.bfloat16, True, True),
    # 580m's one-card step at D 128: B 1, T 8192, 12 heads of 128
    ("d128_580m", 1, 8192, 12, 12, 128, torch.bfloat16, True, True),
    ("d128_ragged_T", 2, 1000, 4, 4, 128, torch.bfloat16, True, True),
    ("d128_non_causal", 2, 320, 4, 4, 128, torch.bfloat16, False, True),
]
# the timed cases and the suffix of their kernel-table rows: 125m's training
# shape (D 64) and 580m's one-card shape (D 128)
TIMED_TRAIN_CASES = {"main": "", "d128_580m": "_d128"}
# bf16 K2/K3 outputs against the float32 reference on the same o and lse:
# one bf16 ulp of the reference (the output's own rounding) plus GRAD_ATOL of
# the tensor's largest |grad|: the tensor-core path rounds p and ds to bf16
# for its second products. Set from readings on an H100: the worst output
# is 0.29-0.45 % of the largest |grad| (0.2-0.3 of a 1e-2 bar), while a
# causal limit one key off lands at 57-91x that bar.
GRAD_ATOL = 6e-3
# the emulation's float64 scores of at most this many query heads at a time
# (580m's 12 at T 8192: 6.4 GB)
EMU_HEADS = 12


def causal_pairs(T: int, causal: bool) -> int:
    """(query, key) pairs a head computes: T(T+1)/2 causal, T^2 otherwise."""
    return T * (T + 1) // 2 if causal else T * T


def train_bounds(B, T, H, KVH, D, dtype, causal, ids_bytes=0):
    """Least times (ms, bound_by) of K1 with lse, K2 and K3 on these inputs:
    bytes (each input read once, each output written once; ``ids_bytes`` of
    document ids) over HBM, or the products' flops over the (query, key)
    pairs the kernels visit, over the dtype's peak, whichever is larger."""
    el = torch.finfo(dtype).bits // 8
    qb, kb, row = B * T * H * D * el, B * T * KVH * D * el, B * H * T * 4
    pairs = B * H * causal_pairs(T, causal)
    work = {  # name: (bytes, flops)
        "flash_train_fwd": (2 * qb + 2 * kb + row + ids_bytes, 2 * 2 * D * pairs),
        "flash_dq": (3 * qb + 2 * kb + 2 * row + ids_bytes, 3 * 2 * D * pairs),
        "flash_dkv": (2 * qb + 4 * kb + 2 * row + ids_bytes, 4 * 2 * D * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        out[name] = (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")
    return out


def shifted_bwd_reference(q, k, v, o, lse, do, alibi, shift):
    """flash_bwd_reference with the causal limit moved by ``shift`` keys
    (ALiBi unchanged): what a kernel one key off would compute."""
    from zero_transformer_tpu_torch.ops.flash import slopes_on
    from zero_transformer_tpu_torch.ops.positions import NEG_INF

    B, T, Hq, Dq = q.shape
    S = k.shape[1]
    G = Hq // k.shape[2]
    scale = 1.0 / Dq**0.5
    qf, dof = q.float(), do.float()
    kf, vf = k.float().repeat_interleave(G, 2), v.float().repeat_interleave(G, 2)
    dist = torch.arange(T, device=q.device)[:, None] - torch.arange(S, device=q.device)
    bias = torch.where(dist + shift >= 0, 0.0, NEG_INF)[None, None]
    if alibi:
        bias = bias - slopes_on(Hq, str(q.device), True)[None, :, None, None] * dist.clamp(min=0).float()
    p = torch.exp(torch.einsum("bthd,bshd->bhts", qf, kf) * scale + bias - lse[..., None])
    ds = p * (torch.einsum("bthd,bshd->bhts", dof, vf) - (dof * o.float()).sum(-1).transpose(1, 2)[..., None])
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = (scale * torch.einsum("bhts,bthd->bshd", ds, qf)).reshape(B, S, -1, G, Dq).sum(3)
    dv = torch.einsum("bhts,bthd->bshd", p, dof).reshape(B, S, -1, G, Dq).sum(3)
    return dq, dk, dv


def grad_miss(got, ref32) -> float:
    """max |got - ref| over its bar (one bf16 ulp of ref + GRAD_ATOL * max|ref|)."""
    err = (got.float() - ref32).abs()
    return float((err / (bf16_ulp(ref32) + GRAD_ATOL * float(ref32.abs().max()))).max())


def train_kernel_phase(cases=TRAIN_CASES, timed=TIMED_TRAIN_CASES):
    """K1 (training entry, with lse), K2 and K3 against their plain versions
    on ``cases``; the ``timed`` ones (label: row suffix) are also timed and
    give the kernel table's rows."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    for label, B, T, Hq, KVH, Dq, dtype, causal, alibi in cases:
        g = torch.Generator(device="cuda").manual_seed(len(label) + 100)
        q, k, v = (torch.randn(B, T, h, Dq, generator=g, device="cuda").to(dtype).requires_grad_()
                   for h in (Hq, KVH, KVH))
        do = torch.randn(B, T, Hq, Dq, generator=g, device="cuda").to(dtype)
        # the Function, forward and backward through autograd
        out = flash.flash_attention(q, k, v, causal=causal, alibi=alibi)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        q, k, v = q.detach(), k.detach(), v.detach()
        # K1 with lse vs its plain version
        o_k, lse_k = flash._launch_fwd(q, k, v, causal=causal, alibi=alibi, q_offset=0,
                                       segment_ids=None, scale=1.0 / Dq**0.5, want_lse=True,
                                       counter=flash.TRAIN_KERNEL)
        torch.cuda.synchronize()
        if not torch.equal(o_k, out):
            raise AssertionError(f"train {label}: the Function's output differs from K1's")
        ref_o, ref_lse = flash.flash_reference(q, k, v, causal=causal, alibi=alibi)
        fwd_err = compare(out, ref_o, dtype, f"train fwd {label}")
        compare(lse_k, ref_lse, torch.float32 if dtype == torch.float32 else dtype, f"train lse {label}")
        mma = None
        if dtype == torch.bfloat16:
            # K1 held to its own rounding, with the packed phase's one-flip
            # allowance (6.3M-12.6M outputs a case at the timed shapes); the
            # causal-limit and validity controls must miss at the timed ones
            # the emulation holds float64 scores [B, heads, T, T]: above
            # EMU_HEADS query heads it checks the first kv heads' groups
            # (without ALiBi a head's slope does not depend on the head count).
            # Without ALiBi it sums as the tensor cores do, and a long row
            # cannot tell its last key masked (1/8192 of its weight): the
            # causal-limit control stands alone
            G = Hq // KVH
            nk = KVH if alibi or Hq <= EMU_HEADS else max(1, EMU_HEADS // G)
            mma = check_mma(o_k[:, :, :nk * G], lse_k[:, :nk * G], q[:, :, :nk * G], k[:, :, :nk], v[:, :, :nk],
                            torch.zeros(B, dtype=torch.int32, device="cuda"),
                            torch.ones(B, T, dtype=torch.int32, device="cuda"), f"train {label}",
                            shifted=causal and label in timed, flip=True, causal=causal, alibi=alibi,
                            tensor_core=None if alibi else TC_BITS,
                            controls=("causal_limit_plus_1", "validity_minus_1") if alibi else ("causal_limit_plus_1",))
            mma["query_heads_checked"] = nk * G
            torch.cuda.empty_cache()
        # K2/K3 on the kernel's own o and lse vs the plain backward on the same
        got = flash.flash_bwd(q, k, v, o_k, lse_k, do, causal=causal, alibi=alibi)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, (dq, dk, dv))):
            raise AssertionError(f"train {label}: autograd grads differ from flash_bwd's")
        line = {"kernel": "flash_train", "case": label, "dtype": str(dtype), "fwd_max_err": fwd_err}
        if mma is not None:
            line["mma"] = mma
        if dtype == torch.float32:
            ref = flash.flash_bwd_reference(q, k, v, o_k, lse_k, do, causal=causal, alibi=alibi)
            errs = [compare(a, b, dtype, f"train {n} {label}") for n, a, b in zip(("dq", "dk", "dv"), got, ref)]
        else:
            ref = flash.flash_bwd_reference(q.float(), k.float(), v.float(), o_k.float(), lse_k,
                                            do.float(), causal=causal, alibi=alibi)
            misses = [grad_miss(a, b) for a, b in zip(got, ref)]
            if max(misses) > 1.0:
                raise AssertionError(f"train {label}: bf16 dq/dk/dv at {misses} of their bars")
            line["bf16_over_bar"] = misses
            line["bf16_err_over_max"] = [float((a.float() - b).abs().max() / b.abs().max())
                                         for a, b in zip(got, ref)]
            errs = [float((a.float() - b).abs().max()) for a, b in zip(got, ref)]
            if causal and label in timed:
                for shift in (1, -1):
                    off = shifted_bwd_reference(q, k, v, o_k, lse_k, do, alibi, shift)
                    s_miss = [grad_miss(a, b) for a, b in zip(got, off)]
                    if max(s_miss) <= 1.0:
                        raise AssertionError(f"train {label}: the causal-limit {shift:+d} reference passes "
                                             f"the bar ({s_miss}); the check cannot tell them apart")
                    line[f"causal_limit_{shift:+d}_over_bar"] = s_miss
        line.update(dq_max_err=errs[0], dk_max_err=errs[1], dv_max_err=errs[2])
        # the end-to-end Function against the whole plain path (its own o, lse)
        full = flash.flash_bwd_reference(q, k, v, ref_o, ref_lse, do, causal=causal, alibi=alibi)
        line["vs_plain_path_max_err"] = [compare(a, b, dtype, f"train e2e {n} {label}")
                                         for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), full)]
        log(line)
        if label not in timed:
            del full, ref
            continue
        suffix = timed[label]
        lse = lse_k.contiguous()
        delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
        scale = 1.0 / Dq**0.5
        check_deterministic(q, k, v, do, lse, delta, dict(causal=causal, alibi=alibi, scale=scale),
                            f"train {label}")
        check_deterministic_fwd(lambda: flash._launch_fwd(
            q, k, v, causal=causal, alibi=alibi, q_offset=0, segment_ids=None, scale=scale, want_lse=True,
            counter=flash.TRAIN_KERNEL), f"train {label}")
        kern = {
            "flash_train_fwd": lambda: flash._launch_fwd(
                q, k, v, causal=causal, alibi=alibi, q_offset=0, segment_ids=None, scale=scale,
                want_lse=True, counter=flash.TRAIN_KERNEL),
            "flash_dq": lambda: flash.launch_dq(q, k, v, do, lse, delta, causal=causal, alibi=alibi, scale=scale),
            "flash_dkv": lambda: flash.launch_dkv(q, k, v, do, lse, delta, causal=causal, alibi=alibi, scale=scale),
        }
        kern_ms = {n: time_ms(fn, iters=10) for n, fn in kern.items()}
        kern_dev = {n: device_ms(fn, iters=10) for n, fn in kern.items()}
        plain_fwd = time_ms(lambda: flash.flash_reference(q, k, v, causal=causal, alibi=alibi), iters=3)
        # the plain backward computes dq, dk and dv together: one time for K2 and K3
        plain_bwd = time_ms(lambda: flash.flash_bwd_reference(q, k, v, o_k, lse_k, do, causal=causal,
                                                              alibi=alibi), iters=3)
        qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (q, k, v))
        if alibi:
            bias = sdpa_bias(B, T, T, [0] * B, torch.ones(B, T, device="cuda", dtype=torch.int32), dtype, Hq)
            lib_kw = dict(attn_mask=bias)
        else:  # causal, no bias, the kv heads shared by their query groups
            bias, lib_kw = None, dict(is_causal=causal, enable_gqa=Hq != KVH)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw), iters=10)
        # the library backward computes dq, dk and dv together: one time for K2 and K3
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), do.transpose(1, 2),
                                                      retain_graph=True), iters=10)
        bounds = train_bounds(B, T, Hq, KVH, Dq, dtype, causal)
        for name in kern:
            err = fwd_err if name == "flash_train_fwd" else (errs[0] if name == "flash_dq" else max(errs[1:]))
            bound, by = bounds[name]
            rows[name + suffix] = dict(max_abs_err=err, ms=kern_ms[name], device_ms=kern_dev[name],
                                       plain_ms=plain_fwd if name == "flash_train_fwd" else plain_bwd,
                                       library_ms=lib_fwd if name == "flash_train_fwd" else lib_bwd,
                                       bound_ms=bound, bound_by=by)
            log({"kernel": name + suffix, "shape": [B, T, Hq, KVH, Dq], **rows[name + suffix]})
        del lib_out, qt, kt, vt, bias, full, ref
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    return rows


def check_deterministic(q, k, v, do, lse, delta, kw, what: str) -> None:
    """K2 and K3 twice on the same inputs must write the same bits: each
    output tile is written once by one CTA, with no atomics (a resumed run
    is bit-equal only so)."""
    from zero_transformer_tpu_torch.ops import flash

    first = (flash.launch_dq(q, k, v, do, lse, delta, **kw),) + flash.launch_dkv(q, k, v, do, lse, delta, **kw)
    again = (flash.launch_dq(q, k, v, do, lse, delta, **kw),) + flash.launch_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
    log({"deterministic": what, "dq_dk_dv_bit_equal": same})
    if not all(same):
        raise AssertionError(f"{what}: two K2/K3 runs on the same inputs differ ({same})")


def check_deterministic_fwd(call, what: str, kernel: str = "k1_o_lse") -> None:
    """A forward kernel twice on the same inputs (``call`` returns its
    outputs: K1's o and lse, K4's o) must write the same bits: each output
    element is written once, in a fixed order of sums, with no atomics."""
    first, again = call(), call()
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(first, again)]
    log({"deterministic": what, f"{kernel}_bit_equal": same})
    if not all(same):
        raise AssertionError(f"{what}: two runs on the same inputs differ ({same})")


# ------------------------------------------------------------------ training

TRAIN_B, TRAIN_ACCUM, TRAIN_T = 8, 4, 1024
# set from readings on an H100 (see PERF.md): the kernel path's loss may be
# no farther from the float32 plain path than the bf16 plain path plus
# LOSS_MARGIN (read: 7.4e-5 vs 7.6e-6); every grad tensor's cosine to the
# float32 plain path at least COS_BAR (read: 0.99967 at the worst tensor,
# the bf16 plain path 0.99970); the loss over FALL_STEPS steps on one batch
# must fall by at least FALL_MARGIN (read: 3.6)
LOSS_MARGIN = 5e-4
COS_BAR = 0.999
# the repeated batch draws from the first FALL_VOCAB ids, so the loss can
# fall within a few steps (uniform ids over 50304 would leave ~0.4 nats)
FALL_STEPS, FALL_LR, FALL_MARGIN, FALL_VOCAB = 20, 1e-3, 2.0, 1024


def train_model(impl: str, dtype, state=None, name="125m", **over):
    from zero_transformer_tpu_torch.models import model_getter

    model = model_getter(name, dtype=dtype, device="cuda", seed=None if state else SEED,
                         trainable=True, attention_impl=impl, **over)
    if state is not None:
        model.load_state_dict(state)
    return model


def loss_and_grads(model, tokens):
    _, loss = model(tokens, labels=tokens, train=True)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return float(loss), dict(zip(names, grads))


def train_parity(name: str, tokens, cos_to: str = "plain_f32", **over) -> dict:
    """One micro-batch of ``name`` (seed-0 weights) through the kernels in
    bf16 and through the plain path (``attention_impl="xla"``) in bf16 and
    float32: fails unless the kernel loss is within LOSS_MARGIN of the bf16
    plain path's distance to float32 and every grad's cosine to the float32
    plain path is at least COS_BAR. ``cos_to="plain_bf16"``: the cosines are
    held to the bf16 plain path instead, and the loss within LOSS_MARGIN of
    it as well (the bf16 plain path's own grads then sit below COS_BAR of
    float32, see ``llama_parity``). Returns the readings and, under
    ``"state"``, the weights. ``over``: model config overrides."""
    kmodel = train_model("auto", torch.bfloat16, name=name, **over)
    state = {k: v.detach().clone() for k, v in kmodel.state_dict().items()}
    loss_k, grads_k = loss_and_grads(kmodel, tokens)
    del kmodel
    loss_x, grads_x = loss_and_grads(train_model("xla", torch.bfloat16, state, name, **over), tokens)
    loss_f, grads_f = loss_and_grads(train_model("xla", torch.float32, state, name, **over), tokens)
    torch.cuda.empty_cache()

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0))

    cos_k = {n: cos(grads_k[n], grads_f[n]) for n in grads_f}
    cos_x = {n: cos(grads_x[n], grads_f[n]) for n in grads_f}
    cos_kx = {n: cos(grads_k[n], grads_x[n]) for n in grads_f}
    del grads_k, grads_x, grads_f
    held = cos_kx if cos_to == "plain_bf16" else cos_k
    parity = {"model": name, "loss_kernel": loss_k, "loss_plain_bf16": loss_x, "loss_plain_f32": loss_f,
              "kernel_vs_f32": abs(loss_k - loss_f), "plain_bf16_vs_f32": abs(loss_x - loss_f),
              "kernel_vs_plain_bf16": abs(loss_k - loss_x), "loss_margin": LOSS_MARGIN, "cos_bar": COS_BAR,
              "cos_held_to": cos_to, "grad_cos_kernel_min": min(cos_k.values()),
              "grad_cos_plain_bf16_min": min(cos_x.values()),
              "grad_cos_kernel_vs_plain_bf16_min": min(cos_kx.values()),
              "grad_cos_kernel_min_tensor": min(cos_k, key=cos_k.get), "grad_cos_held_min_tensor": min(held, key=held.get)}
    if not (math.isfinite(loss_k) and abs(loss_k - loss_f) <= abs(loss_x - loss_f) + LOSS_MARGIN):
        raise AssertionError(f"{name} parity: kernel loss {loss_k} vs f32 {loss_f}, bf16 plain {loss_x}")
    if cos_to == "plain_bf16" and not abs(loss_k - loss_x) <= LOSS_MARGIN:
        raise AssertionError(f"{name} parity: kernel loss {loss_k} vs bf16 plain {loss_x}")
    if min(held.values()) < COS_BAR:
        raise AssertionError(f"{name} parity: grad cosines to the {cos_to} path below {COS_BAR}: "
                             f"{ {n: c for n, c in held.items() if c < COS_BAR} } ({parity})")
    return {**parity, "state": state}


def train_profile(step, st, batch, steps: int = 2, label: str = "training_profile"):
    """Where an optimizer step's time goes: ``steps`` steps under
    ``torch.profiler``; device busy time (sum of kernel self time) against
    the steps' wall time, and the largest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(st, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_times(prof)
    busy_ms = sum(ms for ms, _ in kernels.values())
    log({label: {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps if kernels else "not measured",
        "device_busy_share": busy_ms / wall_ms if kernels else "not measured",
        "device_launches_per_step": sum(c for _, c in kernels.values()) / steps,
        "top_kernels_ms_per_step": top_kernels(kernels, 12, steps, 70),
    }})


def training_phase():
    """125m training through the kernels: parity with the plain path, the
    launch counts of one optimizer step, a falling loss, the trainer CLI."""
    import os

    from zero_transformer_tpu_torch.config import OptimizerConfig, model_config
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(7)
    batch = torch.randint(0, 50304, (TRAIN_ACCUM, TRAIN_B, TRAIN_T), generator=g, device="cuda",
                          dtype=torch.int32)

    # (a) one micro-batch: kernels (bf16) vs the plain path in bf16 and float32
    parity = train_parity("125m", batch[0])
    state = parity.pop("state")
    log({"training_parity": parity})

    # (b) one optimizer step of B 8 x accum 4 x T 1024: launch counts
    batch = batch % FALL_VOCAB
    model = train_model("auto", torch.bfloat16, state)
    opt_cfg = OptimizerConfig(schedule="constant", peak_learning_rate=FALL_LR)
    schedule = make_schedule(opt_cfg)
    st = init_train_state(model, opt_cfg, schedule)
    step = make_train_step(1, schedule)
    step(st, batch)  # warm-up: cuBLAS handles, the allocator
    torch.cuda.synchronize()
    _build.reset_launches()
    metrics = step(st, batch)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = 12 * TRAIN_ACCUM
    if any(launches[n] != want for n in ("flash_train_fwd", "flash_dq", "flash_dkv")):
        raise AssertionError(f"launches per optimizer step {launches}, want {want} each for the training kernels")

    # (c) the loss on one repeated batch at a constant lr must fall
    losses = [float(metrics["loss"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FALL_STEPS - 2):
        losses.append(float(step(st, batch)["loss"]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (FALL_STEPS - 2)
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    log({"training_steps": {"losses": losses, "step_ms": step_ms, "lr": FALL_LR,
                            "tokens_per_step": TRAIN_ACCUM * TRAIN_B * TRAIN_T,
                            "peak_memory_gib": peak_mem, "launches_per_step": launches}})
    if not all(math.isfinite(x) for x in losses) or losses[-1] > losses[0] - FALL_MARGIN:
        raise AssertionError(f"loss did not fall by {FALL_MARGIN} over {FALL_STEPS} steps: {losses}")
    train_profile(step, st, batch)
    del st, model, step
    torch.cuda.empty_cache()

    # (d) the trainer CLI
    run_dir = os.path.join("build", "train_125m")  # its checkpoint is too large to bring back
    if os.path.exists(os.path.join(run_dir, "metrics.jsonl")):
        os.remove(os.path.join(run_dir, "metrics.jsonl"))
    cmd = [sys.executable, "-m", "zero_transformer_tpu_torch.train", "--cfg", "configs/train_125m.yaml",
           "--max-steps", "12", "--set", "data.source=synthetic", f"training.batch_size={TRAIN_B}",
           f"training.gradient_accumulation_steps={TRAIN_ACCUM}", "training.log_frequency=4",
           "training.evaluation_frequency=12", "training.maximum_evaluation_steps=2",
           f"checkpoint.directory={run_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"trainer CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train_recs = [r for r in records if "loss" in r]
    val = [r for r in records if "validation/loss" in r]
    if not train_recs or not val or not all(math.isfinite(r["loss"]) for r in train_recs):
        raise AssertionError(f"trainer CLI metrics incomplete or non-finite: {records}")
    last = train_recs[-1]
    n_params = model_config("125m").num_params
    log({"trainer_cli": {
        "wall_s": wall, "steps": last["step"], "loss": last["loss"],
        "validation_loss": val[-1]["validation/loss"],
        "tokens_per_sec": last["tokens_per_sec"], "step_time_ms": last["step_time_ms"],
        "model_flops_share": last.get("model_flops_share"),
        "model_flops_formula": f"tokens/s * 3 * (2 * N + 4 * L * d * T) / 989e12, N = {n_params}, "
                               "L = 12, d = 768, T = 1024",
    }})
    if last.get("model_flops_share") is None:
        raise AssertionError("the trainer CLI reported no model-FLOPs share on the card")
    return launches


# ------------------------------------------------------- training resilience

RES_DIR = Path("build") / "resilience"  # its checkpoints are too large to bring back
RES_B, RES_STEPS = 8, 8  # B 8 x accum 1 x T 1024 a step
RES_BLOCKS, RES_BLOCK = 4, 5  # (a): off, on, off, on blocks of 5 non-log steps each, after 2 warm-up steps
RES_WATCHDOG_S = 10.0  # above a step, a log point and a save (the hook's force-save joins within it)
RES_CUTS = {"data.source": "memmap -> synthetic", "training.batch_size": "256 -> 8",
            "training.total_steps": "143,000 -> 8-22 a case", "training.evaluation_frequency": "1000 -> 0",
            "checkpoint.save_frequency": "1000 -> none in the run (saves at a preemption, a hang and the end)",
            "resilience.snapshot_frequency": "500 -> 4",
            "resilience.watchdog_timeout_s": f"600 -> {RES_WATCHDOG_S} in (d), off elsewhere"}


def res_config(name: str, **sets):
    """configs/train_125m.yaml (its resilience block) at B 8 x T 1024 on
    synthetic tokens, a fresh run directory under ``RES_DIR``; ``sets``
    override dotted fields."""
    from zero_transformer_tpu_torch.config import apply_dotted_overrides, load_config

    run_dir = RES_DIR / name
    shutil.rmtree(run_dir, ignore_errors=True)
    return apply_dotted_overrides(load_config("configs/train_125m.yaml"), {
        "data.source": "synthetic", "training.batch_size": RES_B, "training.gradient_accumulation_steps": 1,
        "training.evaluation_frequency": 0, "training.log_frequency": 4, "checkpoint.directory": str(run_dir),
        "checkpoint.save_frequency": 1000, "resilience.snapshot_frequency": 4,
        "resilience.watchdog_timeout_s": 0.0, **sets})


def res_trainer(name: str, chaos=None, save: bool = True, **sets):
    """The trainer on ``res_config``. ``save`` False drops its saves (the
    cases that check no checkpoint stay within the machine's disk budget)."""
    from zero_transformer_tpu_torch.training.trainer import Trainer

    trainer = Trainer(res_config(name, **sets), device="cuda", chaos=chaos)
    if not save:
        trainer.save = lambda force=False: False
    return trainer


def res_steps(trainer, it, n: int, skip=()) -> None:
    """``n`` batches of ``trainer``'s loader through its train step (no log
    point, no save); the batches at the indices in ``skip`` are read and
    dropped."""
    from zero_transformer_tpu_torch.data import to_device

    for i in range(n):
        batch = next(it)
        if i not in skip:
            trainer.train_step(trainer.state, to_device(batch, trainer.device))


def res_state(trainer) -> dict:
    return {k: v.clone() for k, v in trainer.state.shards.state_leaves().items()}


def res_bit_equal(a: dict, b: dict, what: str) -> None:
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    if set(a) != set(b) or bad:
        raise AssertionError(f"{what}: not bit-equal ({len(bad)} tensors differ, e.g. {bad[:3]})")


def res_close(*trainers) -> None:
    for t in trainers:
        t.close()
    gc.collect()
    torch.cuda.empty_cache()


def res_count_syncs(fn) -> list:
    """The synchronising CUDA calls ``fn`` makes, as ``set_sync_debug_mode``
    warns of them ("called a synchronizing CUDA operation"; not the mode's
    once-a-process notice that it is a prototype): the Python line of each."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def res_optimizer_ms(state, reps: int = 5) -> dict:
    """The optimizer step alone with and without the gate, CUDA events,
    interleaved (off, on, off, on) on the same state: what the gate adds."""
    shard = state.shards.shard
    grads = torch.randn(shard.shape, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda") * 1e-3
    parts = state.shards.split(grads)
    norm = torch.linalg.vector_norm(grads)
    keep = torch.ones((), dtype=torch.bool, device="cuda")
    out = {"off": [], "on": []}
    for arm in ("off", "on", "off", "on"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            state.optimizer.step(parts, norm, keep if arm == "on" else None)
        end.record()
        torch.cuda.synchronize()
        out[arm].append(start.elapsed_time(end) / reps)
    return {f"optimizer_ms_{arm}": v for arm, v in out.items()}


def resilience_phase() -> dict:
    """``configs/train_125m.yaml``'s resilience block on 125m at full width
    and depth through the port's Trainer (K1-K3 in the guarded step):
    (a) guard on vs off, (b) skip, (c) rollback, (d) a hang and a SIGTERM
    under the supervisor, (e) the guarded step's K1-K3 launches, (f) every
    step directory deleted."""
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.resilience.anomaly import HostSnapshot
    from zero_transformer_tpu_torch.resilience.chaos import ChaosMonkey, Fault
    from zero_transformer_tpu_torch.resilience.detect import leaf_checksum
    from zero_transformer_tpu_torch.resilience.supervisor import Supervisor

    log({"resilience_cuts": RES_CUTS})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}

    # (a) guard off and on, the same batches, interleaved blocks of non-log steps
    off = res_trainer("a_off", save=False, **{"resilience.anomaly_detection": False})
    on = res_trainer("a_on", save=False)
    its = {"off": iter(off.train_loader), "on": iter(on.train_loader)}
    arms = {"off": off, "on": on}
    warm_syncs = {}
    for arm, t in arms.items():
        res_steps(t, its[arm], 1)  # warm-up: cuBLAS handles, the allocator
        # a step's first pass under the sync check: one-time allocations
        # (the pinned host allocator's first blocks) are read, not compared
        warm_syncs[arm] = res_count_syncs(lambda t=t, arm=arm: res_steps(t, its[arm], 1))
    ms, syncs, launches, where = {"off": [], "on": []}, {"off": [], "on": []}, {}, set()
    for _ in range(RES_BLOCKS // 2):
        for arm, t in arms.items():
            _build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res_steps(t, its[arm], RES_BLOCK)
            torch.cuda.synchronize()
            ms[arm].append((time.perf_counter() - t0) * 1e3 / RES_BLOCK)
            launches[arm] = {n: _build.LAUNCHES[n] for n in ("flash_train_fwd", "flash_dq", "flash_dkv")}
            hits = res_count_syncs(lambda t=t, arm=arm: res_steps(t, its[arm], 1))
            syncs[arm].append(len(hits))
            where.update(hits)
    for it in its.values():
        it.close()
    res_bit_equal(res_state(off), res_state(on), "(a) guard on vs off after the same 14 steps")
    if int(off.state.optimizer.count) != int(on.state.optimizer.count) or on.guard.read().count:
        raise AssertionError("(a) the optimizer counts differ, or the guard flagged a clean step")
    if syncs["on"] != syncs["off"]:
        raise AssertionError(f"(a) the guard adds host syncs to a non-log step: {syncs}")
    # (e) the guarded step's K1-K3 launches, counted as the training phase counts them
    want = 12 * RES_BLOCK
    if any(c != want for c in launches["on"].values()) or launches["on"] != launches["off"]:
        raise AssertionError(f"(e) K1-K3 launches in {RES_BLOCK} guarded steps {launches}, want {want} each")
    out["guard"] = {"step_ms_off": ms["off"], "step_ms_on": ms["on"], "syncs_per_non_log_step": syncs,
                    "syncs_where": sorted(where), "first_step_syncs": warm_syncs,
                    "k1_k3_launches_per_step": {n: c // RES_BLOCK for n, c in launches["on"].items()},
                    **res_optimizer_ms(on.state)}
    res_close(off, on)
    del off, on, arms

    # (b) skip: NaN at the non-log steps 4 and 5 (state.step 3 and 4) under skip_batch
    skip = res_trainer("b_skip", chaos=ChaosMonkey([Fault("nan_step", 3, 2)]), save=False,
                       **{"resilience.anomaly_response": "skip_batch", "training.log_frequency": 6})
    skip.train(max_steps=RES_STEPS)
    stats = skip.guard.read()
    ref = res_trainer("b_ref", save=False, **{"resilience.anomaly_detection": False})
    it = iter(ref.train_loader)
    res_steps(ref, it, RES_STEPS, skip=(3, 4))
    it.close()
    if skip.state.step != RES_STEPS or stats.count != 2 or int(skip.state.optimizer.count) != RES_STEPS - 2:
        raise AssertionError(f"(b) step {skip.state.step}, carry count {stats.count}, "
                             f"optimizer count {int(skip.state.optimizer.count)}")
    finite = all(bool(torch.isfinite(v).all()) for v in skip.state.shards.state_leaves().values())
    res_bit_equal(res_state(skip), res_state(ref), "(b) skip vs guard off without the two batches")
    out["skip"] = {"steps": skip.state.step, "carry_count": stats.count, "finite": finite,
                   "optimizer_count": int(skip.state.optimizer.count)}
    res_close(skip, ref)
    del skip, ref

    # (c) rollback with the block's own rollback_after 3 and spike factors:
    # NaN at state.step 5-7, the log point of step 8 rolls back to step 4
    roll = res_trainer("c_rollback", chaos=ChaosMonkey([Fault("nan_step", 5, 3)]), save=False)
    snap, at_capture, checked = HostSnapshot(), {}, []
    capture, rollback = snap.capture, roll._rollback

    def recorded_capture(state):
        capture(state)
        at_capture[state.step] = [leaf_checksum(t) for t in snap.device_tensors(state)]

    def checked_rollback(snapshot):
        rollback(snapshot)
        checked.append((snapshot.step, [leaf_checksum(t) for t in snapshot.device_tensors(roll.state)]
                        == at_capture[snapshot.step]))

    snap.capture, roll.snapshot, roll._rollback = recorded_capture, snap, checked_rollback
    roll.train(max_steps=12)
    events = [json.loads(x) for x in (RES_DIR / "c_rollback" / "metrics.jsonl").open()]
    rolled = [e for e in events if e.get("event") == "anomaly_rollback"]
    if roll.state.step != 12 or checked != [(4, True)] or len(rolled) != 1 or roll.resilience_report["rollbacks"] != 1:
        raise AssertionError(f"(c) step {roll.state.step}, rollbacks {checked}, events {rolled}")
    out["rollback"] = {"to_step": checked[0][0], "at_step": rolled[0]["step"], "digests_equal": True,
                       "snapshot_bytes": snap.bytes, "snapshot_capture_ms": snap.capture_ms,
                       "anomalies": roll.resilience_report["anomalies"]}
    res_close(roll)
    del roll, snap

    # (d) a hang, then a SIGTERM, each under the supervisor, against an uninterrupted run
    clean = res_trainer("d_clean", save=False)
    it = iter(clean.train_loader)
    res_steps(clean, it, RES_STEPS)
    it.close()
    want_state = res_state(clean)
    res_close(clean)
    del clean
    for kind, fault in (("hang", Fault("hang", 3, duration=120.0)), ("sigterm", Fault("sigterm", 4))):
        chaos, built, ended = ChaosMonkey([fault]), [], []

        def factory(c, chaos=chaos, built=built, ended=ended):
            from zero_transformer_tpu_torch.training.trainer import Trainer

            t0 = time.perf_counter()
            t = Trainer(c, device="cuda", chaos=chaos)
            built.append((t0, time.perf_counter(), t))
            train = t.train

            def timed(max_steps=None):
                try:
                    return train(max_steps)
                finally:
                    ended.append(time.perf_counter())

            t.train = timed
            return t

        cfg = res_config(f"d_{kind}", **{"resilience.watchdog_timeout_s": RES_WATCHDOG_S})
        t0 = time.perf_counter()
        sup = Supervisor(cfg, trainer_factory=factory)
        state = sup.run(max_steps=RES_STEPS)
        wall = time.perf_counter() - t0
        final = {k: v.clone() for k, v in state.shards.state_leaves().items()}
        if state.step != RES_STEPS or len(sup.history) != 1 or sup.history[0].step != fault.step:
            raise AssertionError(f"(d) {kind}: step {state.step}, restarts {sup.history}")
        res_bit_equal(final, want_state, f"(d) {kind} under the supervisor vs the uninterrupted run")
        first = built[0][2]
        reading = {"restarts": len(sup.history), "reason": sup.history[0].reason, "resumed_at": sup.history[0].step,
                   "backoff_s": sup.history[0].backoff_s, "wall_s": wall,
                   "restart_ms": (built[1][1] - ended[0]) * 1e3, "rebuild_and_restore_ms":
                   (built[1][1] - built[1][0]) * 1e3}
        if kind == "hang":
            wd = first.watchdog
            if not (wd.fired and first.resilience_report["watchdog_fired"]):
                raise AssertionError("(d) the watchdog did not fire on the hang")
            reading.update({"watchdog_timeout_s": wd.timeout_s, "detected_after_s": wd.fired_after_s,
                            "detection_latency_past_deadline_s": wd.fired_after_s - wd.timeout_s})
        else:
            reading["preempted"] = first.preempted
        out[f"supervised_{kind}"] = reading
        del state, final, built, first, sup
        gc.collect()
        torch.cuda.empty_cache()
    del want_state

    # (f) no step directory outlives the phase
    shutil.rmtree(RES_DIR, ignore_errors=True)
    if RES_DIR.exists():
        raise AssertionError(f"(f) {RES_DIR} was not deleted")
    log({"resilience": out})
    return out["guard"]["k1_k3_launches_per_step"]


# ------------------------------------------------------- 1.3B on one card

T13_MODEL, T13_B, T13_ACCUM, T13_T, T13_CHUNK = "1_3b", 4, 16, 1024, 256  # configs/train_1_3b_1chip.yaml
T13_N = 1_311_082_496  # 1_3b's params (the tied embedding once)
# K1-K3 at 1_3b's shape: B 4, T = S = 1024, 16 heads of 128, causal ALiBi
T13_CASES = [
    ("1_3b", T13_B, T13_T, 16, 16, 128, torch.bfloat16, True, True),
    ("1_3b_f32", T13_B, T13_T, 16, 16, 128, torch.float32, True, True),
]
T13_TIMED = {"1_3b": "_1_3b"}
# Adafactor on one repeated batch at a constant learning rate: the loss over
# FALL_STEPS steps must fall by at least AF_FALL_MARGIN
AF_LR, AF_FALL_MARGIN = 1e-2, 0.5
DROP_P, DROP_SIGMAS = 0.1, 5.0


def jax_adafactor_statistics(d: int, f: int, vocab: int, layers: int) -> int:
    """Elements of the second-moment statistics JAX's ``optax.adafactor``
    keeps for the GPT-2 leaves of a model (scan-stacked blocks), by its own
    rule on JAX's shapes (``_factored_dims``: the two largest dims when the
    second is at least 128, ties as ``np.argsort`` orders them; ``v_row``
    drops the largest, ``v_col`` the second): factored leaves keep both,
    the others a ``v`` of their own size. The one-element placeholders
    optax keeps for the unused statistics are not counted."""
    leaves = [(vocab, d), (d,), (layers, d), (layers, d)]  # wte, ln_f, ln_attn, ln_mlp
    leaves += [(layers, d, d)] * 4 + [(layers, d, f), (layers, f, d)]  # query, key, value, out, wi, wo
    total = 0
    for shape in leaves:
        order = np.argsort(shape)
        if len(shape) < 2 or shape[order[-2]] < 128:
            total += math.prod(shape)
            continue
        d1, d0 = int(order[-2]), int(order[-1])
        total += math.prod(shape) // shape[d0] + math.prod(shape) // shape[d1]
    return total


def t13_model(impl: str = "auto", chunk=T13_CHUNK, dtype=torch.bfloat16):
    """1_3b with the recipe's model settings: ``dtype`` (bf16) over float32
    master params, remat, ``loss_chunk`` (None: the full logits), dropout 0,
    seed-0 weights (the same on every call)."""
    from zero_transformer_tpu_torch.models import model_getter

    return model_getter(T13_MODEL, dtype=dtype, device="cuda", seed=SEED, trainable=True,
                        attention_impl=impl, remat=True, loss_chunk=chunk, dropout=0.0)


def t13_parity(tokens) -> dict:
    """(b) one micro-batch four ways: the plain path (``attention_impl=
    "xla"``, the full logits) in float32 and in bf16, the recipe (kernels,
    the chunked loss) and the kernels with the full logits. Fails unless
    the recipe's loss is within LOSS_MARGIN of the full logits' and of the
    bf16 plain path's, and no farther from the float32 plain path than the
    bf16 plain path plus LOSS_MARGIN, and every grad's cosine to each of
    the three is at least COS_BAR. Each run's peak memory above its start
    through the forward (the logits, or one tile, live then); a whole
    step's peak with and without the chunk comes from the trainer CLI in
    processes of their own (``t13_cli``)."""
    runs = {"plain_f32": ("xla", None, torch.float32), "plain_bf16": ("xla", None, torch.bfloat16),
            "kernels_chunk": ("auto", T13_CHUNK, torch.bfloat16),
            "kernels_full_logits": ("auto", None, torch.bfloat16)}
    out, grads_of, loss_of = {}, {}, {}

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0))

    for label, (impl, chunk, dtype) in runs.items():
        gc.collect()
        model = t13_model(impl, chunk, dtype)
        names = [n for n, _ in model.named_parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        _, loss = model(tokens, labels=tokens, train=True)
        torch.cuda.synchronize()
        fwd_peak = torch.cuda.max_memory_allocated() - start
        grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
        torch.cuda.synchronize()
        loss_of[label] = float(loss)
        out[label] = {"loss": loss_of[label], "forward_peak_above_start_gib": fwd_peak / 2**30}
        del model, loss
        for other in grads_of:  # this run against each earlier one
            cosines = {n: cos(g, grads_of[other][n]) for n, g in grads.items()}
            out[label][f"vs_{other}"] = {"loss_gap": abs(loss_of[label] - loss_of[other]),
                                         "grad_cos_min": min(cosines.values()),
                                         "grad_cos_min_tensor": min(cosines, key=cosines.get)}
        if label != "kernels_full_logits":
            grads_of[label] = grads
        del grads
        torch.cuda.empty_cache()
    grads_of.clear()
    recipe, full = out["kernels_chunk"], out["kernels_full_logits"]
    checks = [recipe["vs_plain_f32"], recipe["vs_plain_bf16"], full["vs_kernels_chunk"]]
    if not all(math.isfinite(x) for x in loss_of.values()) or \
            recipe["vs_plain_f32"]["loss_gap"] > out["plain_bf16"]["vs_plain_f32"]["loss_gap"] + LOSS_MARGIN or \
            any(c["loss_gap"] > LOSS_MARGIN for c in checks[1:]):
        raise AssertionError(f"1_3b parity: losses {loss_of}")
    if any(c["grad_cos_min"] < COS_BAR for c in checks):
        raise AssertionError(f"1_3b parity: a grad cosine below {COS_BAR}: {out}")
    out["chunk_saves_forward_gib"] = full["forward_peak_above_start_gib"] - recipe["forward_peak_above_start_gib"]
    return out


def t13_cli(steps: int = 3, *sets: str) -> dict:
    """(e) the trainer CLI on configs/train_1_3b_1chip.yaml (``sets`` more
    overrides) for ``steps`` steps, in a process of its own that reports its
    peak memory. Cuts: synthetic data (data/train.bin is not in the repo),
    ``steps`` of 163,000 steps, no eval, the checkpoint (its save at the
    end, 5.2 GB) into a directory this phase deletes."""
    run_dir = Path("build") / "train_1_3b"
    shutil.rmtree(run_dir, ignore_errors=True)
    code = ("import json, sys, torch; from zero_transformer_tpu_torch import train; train.main(sys.argv[1:]); "
            "print(json.dumps({'cli_peak_memory_gib': torch.cuda.max_memory_allocated() / 2**30}))")
    cmd = [sys.executable, "-c", code, "--cfg", "configs/train_1_3b_1chip.yaml", "--max-steps", str(steps), "--set",
           "data.source=synthetic", "training.log_frequency=1", "training.evaluation_frequency=0",
           f"checkpoint.directory={run_dir}", *sets]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"1_3b trainer CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        saved = sorted(p.name for p in run_dir.iterdir() if p.is_dir())
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    train = [r for r in records if "loss" in r]
    if len(train) != steps or not all(math.isfinite(r["loss"]) for r in train) or saved != [str(steps)]:
        raise AssertionError(f"1_3b trainer CLI metrics incomplete or non-finite: {records}, saved {saved}")
    info = next(json.loads(line)["trainer"] for line in proc.stdout.splitlines() if line.startswith('{"trainer"'))
    peak = next(json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"cli_peak'))
    last = train[-1]
    if last.get("model_flops_share") is None:
        raise AssertionError("the 1_3b trainer CLI reported no model-FLOPs share on the card")
    return {"wall_s": wall, "losses": [r["loss"] for r in train], "step_time_ms": last["step_time_ms"],
            "tokens_per_sec": last["tokens_per_sec"], "model_flops_share": last["model_flops_share"],
            "model_flops_formula": f"tokens/s * 3 * (2 * N + 4 * L * d * T) / 989e12, N = {T13_N}, L = 24, "
                                   "d = 2048, T = 1024",
            "persistent_state_bytes": info["persistent_state_bytes"], **peak}


def t13_dropout() -> dict:
    """(f) 125m at dropout 0.1, one micro-batch on the card: remat on and off
    give bit-equal loss and grads; every site's kept share within
    DROP_SIGMAS sigma of 1 - p; the same (seed, step, rank, micro) gives the
    same bits twice, another micro-step other bits."""
    from zero_transformer_tpu_torch.models import gpt, model_getter

    g = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, 50304, (TRAIN_B, TRAIN_T), generator=g, device="cuda", dtype=torch.int32)
    shares, original = [], gpt.dropout

    def record(x, rate, seed):  # every mask's kept share (an input exactly 0 reads as dropped)
        out = original(x, rate, seed)
        if seed is not None:
            shares.append(((out != 0).float().mean().item(), out.numel()))
        return out

    def run(remat: bool, key):
        model = model_getter("125m", dtype=torch.bfloat16, device="cuda", seed=SEED, trainable=True,
                             dropout=DROP_P, remat=remat)
        _, loss = model(tokens, labels=tokens, train=True, dropout_key=key)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.detach(), grads

    gpt.dropout = record
    try:
        loss, grads = run(False, (0, 3, 0, 1))
        sites = list(shares)
        r_loss, r_grads = run(True, (0, 3, 0, 1))
    finally:
        gpt.dropout = original
    again, again_grads = run(False, (0, 3, 0, 1))
    other, _ = run(False, (0, 3, 0, 2))
    torch.cuda.synchronize()
    remat_equal = bool(torch.equal(loss, r_loss)) and all(torch.equal(a, b) for a, b in zip(grads, r_grads))
    repeat_equal = bool(torch.equal(loss, again)) and all(torch.equal(a, b) for a, b in zip(grads, again_grads))
    bad = [s for s, n in sites if abs(s - (1 - DROP_P)) > DROP_SIGMAS * math.sqrt(DROP_P * (1 - DROP_P) / n)]
    out = {"sites": len(sites), "kept_share_min": min(s for s, _ in sites), "kept_share_max": max(s for s, _ in sites),
           "remat_bit_equal": remat_equal, "same_key_bit_equal": repeat_equal, "loss": float(loss),
           "other_micro_loss": float(other)}
    if len(sites) != 1 + 2 * 12 or bad or not remat_equal or not repeat_equal or torch.equal(loss, other):
        raise AssertionError(f"125m dropout on the card: {out}, shares beyond the bar {bad}")
    return out


def t13_guard_cost(st, step, schedule, batch, reps: int = 2) -> dict:
    """What the anomaly guard costs at 1.3B (the trainer runs it by
    default): steps of one micro-batch with and without it, interleaved
    (off, on, off, on) on the same state, and the Adafactor step alone with
    and without its gate (``res_optimizer_ms``)."""
    from zero_transformer_tpu_torch.config import ResilienceConfig
    from zero_transformer_tpu_torch.parallel.zero import make_train_step
    from zero_transformer_tpu_torch.resilience.anomaly import AnomalyGuard

    guarded = make_train_step(1, schedule, "bfloat16", guard=AnomalyGuard(ResilienceConfig(), "cuda"))
    ms = {"off": [], "on": []}
    for arm in ("off", "on", "off", "on"):
        fn = guarded if arm == "on" else step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(st, batch)
        torch.cuda.synchronize()
        ms[arm].append((time.perf_counter() - t0) * 1e3 / reps)
    return {"step_ms_off": ms["off"], "step_ms_on": ms["on"], **res_optimizer_ms(st)}


def train_1_3b_phase():
    """configs/train_1_3b_1chip.yaml's path on the card: K1-K3 at its shape,
    the chunked loss against the full logits and the plain path, the launch
    counts of one optimizer step, Adafactor's state and a falling loss, the
    trainer CLI; then dropout at 125m."""
    from zero_transformer_tpu_torch.config import OptimizerConfig
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    # (a) K1-K3 at the 1.3B shape, with train_kernel_phase's bars and timings
    rows = train_kernel_phase(T13_CASES, T13_TIMED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(13)
    batch = torch.randint(0, 50304, (T13_ACCUM, T13_B, T13_T), generator=g, device="cuda", dtype=torch.int32)

    # (b) one micro-batch: chunked loss vs full logits vs the plain path
    log({"train_1_3b_parity": t13_parity(batch[0])})

    # (c) one optimizer step of B 4 x accum 16, remat: launch counts
    model = t13_model()
    opt_cfg = OptimizerConfig(optimizer="adafactor", schedule="constant", peak_learning_rate=AF_LR)
    schedule = make_schedule(opt_cfg)
    st = init_train_state(model, opt_cfg, schedule)
    step = make_train_step(1, schedule, "bfloat16")
    step(st, batch)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    step(st, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    L = model.cfg.n_layers
    want = {"flash_train_fwd": L * T13_ACCUM * 2, "flash_dq": L * T13_ACCUM, "flash_dkv": L * T13_ACCUM}
    if any(launches[n] != c for n, c in want.items()):
        raise AssertionError(f"1_3b launches per optimizer step {launches}, want {want}")

    # (d) Adafactor: its persistent bytes, and the loss on one repeated batch
    stats = jax_adafactor_statistics(2048, 4 * 2048, 50304, L)
    persistent = st.shards.persistent_bytes()
    if model.cfg.num_params != T13_N or persistent != 4 * T13_N + 4 * stats:
        raise AssertionError(f"1_3b Adafactor holds {persistent} bytes, want 4 * {T13_N} + 4 * {stats}")
    one = (batch[:1] % FALL_VOCAB).contiguous()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FALL_STEPS):
        losses.append(float(step(st, one)["loss"]))
    af_step_ms = (time.perf_counter() - t0) * 1e3 / FALL_STEPS
    log({"train_1_3b_steps": {
        "step_s_accum16": step_s, "tokens_per_step": T13_ACCUM * T13_B * T13_T,
        "launches_per_step": {n: launches[n] for n in want}, "persistent_bytes": persistent,
        "adamw_would_hold": 12 * T13_N, "adafactor_statistics": stats, "losses": losses, "lr": AF_LR,
        "step_ms_accum1": af_step_ms, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}})
    if not all(math.isfinite(x) for x in losses) or losses[-1] > losses[0] - AF_FALL_MARGIN:
        raise AssertionError(f"Adafactor: the loss did not fall by {AF_FALL_MARGIN} over {FALL_STEPS} steps: {losses}")
    log({"train_1_3b_guard": t13_guard_cost(st, step, schedule, one)})
    train_profile(step, st, one, steps=1, label="train_1_3b_profile")  # one micro-step and the optimizer
    del st, model, step
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the trainer CLI on the recipe, and a step's peak memory without the chunk
    cli = t13_cli()
    full = t13_cli(1, "model.loss_chunk=None")
    cli["cli_peak_memory_gib_full_logits"] = full["cli_peak_memory_gib"]
    log({"train_1_3b_trainer_cli": cli})
    # (f) dropout on the card
    log({"dropout_125m": t13_dropout()})
    torch.cuda.empty_cache()
    return rows, {n + "_1_3b": launches[n] for n in want}


# ------------------------------------------------------- packed documents

SEP = 0  # byte_25m's doc_sep_token
CTX = 512  # byte_25m's max_seq_len and train_e2e_bytes.yaml's context
HELDOUT_FRAC = 0.05  # scripts/e2e_quality.py's split
# (label, B, H, KVH, D, dtype); "main" is byte_25m's training shape
# (B 32, T = S 512, 8 heads of 64)
PACKED_CASES = [
    ("main", 32, 8, 8, 64, torch.bfloat16),
    ("f32", 32, 8, 8, 64, torch.float32),
    ("gqa", 10, 8, 2, 64, torch.bfloat16),
    ("gqa_f32", 10, 8, 2, 64, torch.float32),
    ("d128_f32", 10, 4, 4, 128, torch.float32),
    ("d128", 10, 4, 4, 128, torch.bfloat16),
]


@functools.lru_cache(maxsize=None)
def corpus():
    """The repo's own text, read from the tree (no ``.git`` needed):
    ``*.md``, ``docs/*.md``, then every ``.py``, as scripts/e2e_quality.py
    gathers text (:73-105): documents under 512 characters or holding a NUL
    are dropped, duplicates too, and a document goes to the held-out split
    when its hash says so. Returns ``(train, heldout)`` lists of str."""
    root = Path(__file__).resolve().parent
    skip = {"build", "runs"}  # build outputs and run directories (.gitignore)
    paths = sorted(root.glob("*.md")) + sorted(root.glob("docs/*.md")) + sorted(
        p for p in root.rglob("*.py")
        if not any(part in skip or part.startswith(".") for part in p.relative_to(root).parts[:-1])
    )
    seen, train, heldout = set(), [], []
    for p in paths:
        try:
            text = p.read_bytes().decode("utf-8")
        except UnicodeDecodeError:
            continue
        if len(text) < 512 or "\x00" in text:
            continue
        h = hashlib.sha256(text.encode()).hexdigest()
        if h in seen:
            continue
        seen.add(h)
        (heldout if int(h[:8], 16) / 0xFFFFFFFF < HELDOUT_FRAC else train).append(text)
    return train, heldout


def packed_rows(n: int):
    """``n`` [CTX] int32 rows of the packed train stream that hold a
    separator (a row holds at most one: every document has 512 bytes or more)."""
    from zero_transformer_tpu_torch.data.prepare import pack_rows
    from zero_transformer_tpu_torch.serve import ByteTokenizer

    rows = []
    for row in pack_rows(corpus()[0], ByteTokenizer(), CTX, SEP):
        if (row == SEP).any():
            rows.append(torch.from_numpy(row))
        if len(rows) == n:
            return torch.stack(rows)
    raise AssertionError(f"the corpus packs fewer than {n} rows with a separator")


def layout_rows():
    """[8, CTX] token rows whose separators make the document layouts the
    kernels must get right: a document starting at key 63, 64 or 65 (each
    side of the 64-key tile edge) and all three at once, separators at 0 and
    CTX - 1, twelve one-token documents, no separator, and many short
    documents of random lengths."""
    def row(seps):
        r = torch.full((CTX,), ord("a"), dtype=torch.int32)
        r[list(seps)] = SEP
        return r

    cuts = np.cumsum(np.random.default_rng(11).integers(1, 80, 64))
    return torch.stack([row([62]), row([63]), row([64]), row([62, 63, 64]), row([0, CTX - 1]),
                        row(range(200, 212)), row([]), row(cuts[cuts < CTX].tolist())])


def packed_sdpa_bias(docs, Hq, dtype):
    """[B, H, T, T] float bias: ALiBi + causal + the document mask."""
    from zero_transformer_tpu_torch.ops.positions import NEG_INF, alibi_slopes

    T = docs.shape[1]
    dist = torch.arange(T, device="cuda")[:, None] - torch.arange(T, device="cuda")
    bias = -alibi_slopes(Hq, "cuda")[None, :, None, None] * dist.clamp(min=0).float()
    bias = bias + torch.where(dist >= 0, 0.0, NEG_INF)
    bias = bias + torch.where(docs[:, :, None] == docs[:, None, :], 0.0, NEG_INF)[:, None]
    return bias.to(dtype)


def packed_kernel_phase():
    """K1 (with lse), K2 and K3 with the packed-document mask against their
    plain versions, on the layouts of ``layout_rows`` plus real packed rows
    of the corpus; the bars of the training-kernel phase, and a control:
    plain versions given inclusive-cumsum ids (each separator moved into
    the next document) must miss the bf16 bars."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.models.gpt import doc_ids_from_tokens
    from zero_transformer_tpu_torch.ops import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    synthetic = layout_rows()
    real = packed_rows(max(c[1] for c in PACKED_CASES) - len(synthetic))
    rows = {}
    for label, B, Hq, KVH, Dq, dtype in PACKED_CASES:
        tokens = torch.cat([synthetic, real[: B - len(synthetic)]]).cuda()
        docs = doc_ids_from_tokens(tokens, SEP)
        inclusive = torch.cumsum((tokens == SEP).int(), 1, dtype=torch.int32)
        g = torch.Generator(device="cuda").manual_seed(len(label) + 300)
        q, k, v = (torch.randn(B, CTX, h, Dq, generator=g, device="cuda").to(dtype).requires_grad_()
                   for h in (Hq, KVH, KVH))
        do = torch.randn(B, CTX, Hq, Dq, generator=g, device="cuda").to(dtype)
        out = flash.flash_attention(q, k, v, causal=True, alibi=True, doc_ids=docs)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        q, k, v, out = q.detach(), k.detach(), v.detach(), out.detach()
        scale = 1.0 / Dq**0.5
        o_k, lse_k = flash._launch_fwd(q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None,
                                       scale=scale, want_lse=True, counter=flash.TRAIN_KERNEL, doc_ids=docs)
        torch.cuda.synchronize()
        if not torch.equal(o_k, out):
            raise AssertionError(f"docs {label}: the Function's output differs from K1's")
        ref_o, ref_lse = flash.flash_reference(q, k, v, causal=True, alibi=True, doc_ids=docs)
        fwd_err = compare(out, ref_o, dtype, f"docs fwd {label}")
        compare(lse_k, ref_lse, torch.float32 if dtype == torch.float32 else dtype, f"docs lse {label}")
        line = {"kernel": "flash_train_docs", "case": label, "dtype": str(dtype),
                "shape": [B, CTX, Hq, KVH, Dq], "fwd_max_err": fwd_err}
        if dtype == torch.bfloat16:
            zeros = torch.zeros(B, dtype=torch.int32, device="cuda")
            ones = torch.ones(B, CTX, dtype=torch.int32, device="cuda")
            line["mma"] = check_mma(out, lse_k, q, k, v, zeros, ones, f"docs {label}", shifted=False,
                                    docs=docs, doc_control=inclusive, flip=True)
            # the same inputs without document ids miss the bar without the allowance too
            o_free, _ = flash._launch_fwd(q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None,
                                          scale=scale, want_lse=True, counter=flash.TRAIN_KERNEL)
            line["mma"]["no_docs_over_without_flip"] = mma_miss(
                o_free, flash_mma_emulation(q, k, v, zeros, ones)[0])[0]
            del o_free
        got = flash.flash_bwd(q, k, v, o_k, lse_k, do, causal=True, alibi=True, doc_ids=docs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, (dq, dk, dv))):
            raise AssertionError(f"docs {label}: autograd grads differ from flash_bwd's")
        if dtype == torch.float32:
            ref = flash.flash_bwd_reference(q, k, v, o_k, lse_k, do, causal=True, alibi=True, doc_ids=docs)
            errs = [compare(a, b, dtype, f"docs {n} {label}") for n, a, b in zip(("dq", "dk", "dv"), got, ref)]
        else:
            f32 = (q.float(), k.float(), v.float(), o_k.float(), lse_k, do.float())
            ref = flash.flash_bwd_reference(*f32, causal=True, alibi=True, doc_ids=docs)
            misses = [grad_miss(a, b) for a, b in zip(got, ref)]
            if max(misses) > 1.0:
                raise AssertionError(f"docs {label}: bf16 dq/dk/dv at {misses} of their bars")
            control = flash.flash_bwd_reference(*f32, causal=True, alibi=True, doc_ids=inclusive)
            c_miss = [grad_miss(a, b) for a, b in zip(got, control)]
            if max(c_miss) <= 1.0:
                raise AssertionError(f"docs {label}: the inclusive-id reference passes the bar ({c_miss}); "
                                     "the check cannot tell them apart")
            line.update(bf16_over_bar=misses, inclusive_doc_ids_over_bar=c_miss)
            errs = [float((a.float() - b).abs().max()) for a, b in zip(got, ref)]
            del control, f32
        line.update(dq_max_err=errs[0], dk_max_err=errs[1], dv_max_err=errs[2])
        full = flash.flash_bwd_reference(q, k, v, ref_o, ref_lse, do, causal=True, alibi=True, doc_ids=docs)
        line["vs_plain_path_max_err"] = [compare(a, b, dtype, f"docs e2e {n} {label}")
                                         for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), full)]
        causal_pairs_all = B * causal_pairs(CTX, True)
        causal = torch.ones(CTX, CTX, dtype=torch.bool, device="cuda").tril()
        same = (docs[:, :, None] == docs[:, None, :]) & causal
        line["doc_visible_pair_share"] = float(same.sum()) / causal_pairs_all
        log(line)
        del full, ref
        if label != "main":
            continue
        lse = lse_k.contiguous()
        delta = (do.float() * o_k.float()).sum(-1).transpose(1, 2).contiguous()
        kern = {
            "flash_train_fwd_docs": lambda: flash._launch_fwd(
                q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None, scale=scale,
                want_lse=True, counter=flash.TRAIN_KERNEL, doc_ids=docs),
            "flash_dq_docs": lambda: flash.launch_dq(q, k, v, do, lse, delta, causal=True, alibi=True,
                                                     scale=scale, doc_ids=docs),
            "flash_dkv_docs": lambda: flash.launch_dkv(q, k, v, do, lse, delta, causal=True, alibi=True,
                                                       scale=scale, doc_ids=docs),
        }
        kern_ms = {n: time_ms(fn, iters=10) for n, fn in kern.items()}
        kern_dev = {n: device_ms(fn, iters=10) for n, fn in kern.items()}
        # the same kernels on the same inputs without the mask: what the mask costs
        free_ms = {
            "flash_train_fwd_docs": time_ms(lambda: flash._launch_fwd(
                q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None, scale=scale,
                want_lse=True, counter=flash.TRAIN_KERNEL), iters=10),
            "flash_dq_docs": time_ms(lambda: flash.launch_dq(q, k, v, do, lse, delta, causal=True, alibi=True,
                                                             scale=scale), iters=10),
            "flash_dkv_docs": time_ms(lambda: flash.launch_dkv(q, k, v, do, lse, delta, causal=True, alibi=True,
                                                               scale=scale), iters=10),
        }
        plain_fwd = time_ms(lambda: flash.flash_reference(q, k, v, causal=True, alibi=True, doc_ids=docs),
                            iters=3)
        # the plain backward computes dq, dk and dv together: one time for K2 and K3
        plain_bwd = time_ms(lambda: flash.flash_bwd_reference(q, k, v, o_k, lse_k, do, causal=True, alibi=True,
                                                              doc_ids=docs), iters=3)
        bias = packed_sdpa_bias(docs, Hq, dtype)
        qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), iters=10)
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), do.transpose(1, 2),
                                                      retain_graph=True), iters=10)
        bounds = train_bounds(B, CTX, Hq, KVH, Dq, dtype, True, ids_bytes=4 * B * CTX)
        for name in kern:
            err = fwd_err if name == "flash_train_fwd_docs" else (errs[0] if name == "flash_dq_docs"
                                                                  else max(errs[1:]))
            bound, by = bounds[name.removesuffix("_docs")]
            rows[name] = dict(max_abs_err=err, ms=kern_ms[name], device_ms=kern_dev[name],
                              plain_ms=plain_fwd if name == "flash_train_fwd_docs" else plain_bwd,
                              library_ms=lib_fwd if name == "flash_train_fwd_docs" else lib_bwd,
                              bound_ms=bound, bound_by=by)
            log({"kernel": name, "shape": [B, CTX, Hq, KVH, Dq], "ms_without_docs": free_ms[name],
                 "doc_visible_pair_share": line["doc_visible_pair_share"], **rows[name]})
        del lib_out, qt, kt, vt, bias
    torch.cuda.empty_cache()
    return rows


def heldout_tasks(heldout, max_lambada: int = 400):
    """The last-word and choice examples of scripts/e2e_quality.py
    (``build_eval_files``, :116-199) at context 512, as token lists. The
    held-out documents follow from file hashes, so a task may come out
    empty (fewer than four paragraphs give no choice examples); its
    accuracy is then reported over 0 examples and nothing is scored."""
    lastword = []
    for doc in heldout:
        for para in doc.split("\n\n"):
            para = para.strip()
            words = para.split()
            if not (12 <= len(words) <= 80) or len(para) > 1200:
                continue
            last = words[-1]
            if not re.fullmatch(r"[A-Za-z][A-Za-z'\-]{2,}[.:,;]?", last):
                continue
            lastword.append((list(para[: len(para) - len(last) - 1].encode()), list((" " + last).encode())))
            if len(lastword) >= max_lambada:
                break
        if len(lastword) >= max_lambada:
            break
    paras = [p.strip() for doc in heldout for p in doc.split("\n\n") if 200 <= len(p.strip()) <= 900]
    if len(paras) < 4:
        return lastword, []
    cap = max(32, CTX // 2 - 8)

    def second_half(s):
        cut = s.find(" ", len(s) // 2)
        cut = cut if cut != -1 else len(s) // 2
        return s[:cut], s[cut:]

    def cap_b(s):
        return s.encode()[:cap].decode("utf-8", errors="ignore")

    choice = []
    for i, para in enumerate(paras[: 20 if len(paras) < 100 else 200]):
        context, true_cont = second_half(para)
        cands = [cap_b(true_cont), cap_b(second_half(paras[(i + 1) % len(paras)])[1]),
                 cap_b(second_half(paras[(i + 2) % len(paras)])[1])]
        gold = i % 3
        cands[0], cands[gold] = cands[gold], cands[0]
        choice.append((list(context.encode()), [list(c.encode()) for c in cands], gold,
                       [len(c.encode()) for c in cands]))
    return lastword, choice


def unigram_entropy_nats(data: bytes) -> float:
    counts = np.bincount(np.frombuffer(data, np.uint8), minlength=256).astype(np.float64)
    p = counts[counts > 0] / counts.sum()
    return float(-(p * np.log(p)).sum())


# the packed run: configs/train_e2e_bytes.yaml with these changes only
PACKED_STEPS, PACKED_WARMUP, PACKED_EVAL_EVERY, EVAL_BATCH = 300, 30, 300, 32
BPB_GAP = 0.01  # kernel-path bits per byte within this of the plain path's


def packed_phase():
    """byte_25m at full width and depth on the repo's own text: the port's
    prepare writes tar shards, the kernel path meets the plain path on one
    packed batch, the trainer runs train_e2e_bytes.yaml, the eval harness
    scores the trained model, and the trainer CLI takes a few steps."""
    import shutil

    from zero_transformer_tpu_torch.config import apply_dotted_overrides, load_config, model_config
    from zero_transformer_tpu_torch.data import make_loader, prepare
    from zero_transformer_tpu_torch.evalharness import choice_accuracy, lambada, perplexity
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(__file__).resolve().parent
    yaml_path = root / "configs" / "train_e2e_bytes.yaml"
    out = root / "build" / "packed"
    shutil.rmtree(out, ignore_errors=True)
    data = out / "data"
    data.mkdir(parents=True)

    # 1. corpus -> the port's prepare CLI -> tar shards
    t0 = time.perf_counter()
    train_docs, heldout = corpus()
    for name, docs in (("train", train_docs), ("heldout", heldout)):
        with open(data / f"{name}.jsonl", "w") as f:
            f.writelines(json.dumps({"text": d}) + "\n" for d in docs)
    for split, src in (("train", "train.jsonl"), ("val", "heldout.jsonl")):
        prepare.main(["--input", str(data / src), "--tokenizer", "bytes", "--max-context", str(CTX),
                      "--format", "tar", "--doc-sep", str(SEP), "--rows-per-shard", "512",
                      "--out", str(data / split)])
    stream = "\n\n".join(heldout)[:400_000].encode()
    entropy = unigram_entropy_nats(stream)
    log({"packed_corpus": {
        "train_docs": len(train_docs), "heldout_docs": len(heldout),
        "train_bytes": sum(len(d.encode()) for d in train_docs), "heldout_stream_bytes": len(stream),
        "heldout_unigram_entropy_nats": entropy, "heldout_unigram_entropy_bits": entropy / math.log(2),
        "prepare_s": time.perf_counter() - t0}})

    overrides = {
        "data.train_path": str(data / "train.index"), "data.validation_path": str(data / "val.index"),
        "training.total_steps": PACKED_STEPS, "optimizer.warmup_steps": PACKED_WARMUP,
        "training.evaluation_frequency": PACKED_EVAL_EVERY, "checkpoint.directory": str(out / "run"),
    }
    cfg = apply_dotted_overrides(load_config(yaml_path), overrides)

    # 2. parity on one packed micro-batch
    it = iter(make_loader(cfg))
    batch = torch.from_numpy(next(it)[0]).cuda()
    it.close()
    parity = train_parity("byte_25m", batch)
    del parity["state"]
    log({"packed_parity": parity})

    # 3. training; the launch counts are zeroed just before and read just after
    trainer = Trainer(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        trainer.close()
    eval_batches = PACKED_STEPS // PACKED_EVAL_EVERY * cfg.training.maximum_evaluation_steps
    want = {"flash_train_fwd_docs": 8 * (PACKED_STEPS + eval_batches), "flash_dq_docs": 8 * PACKED_STEPS,
            "flash_dkv_docs": 8 * PACKED_STEPS, "flash_train_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    if any(launches[n] != c for n, c in want.items()):
        raise AssertionError(f"packed launches {launches}, want {want} (8 per step and per eval batch)")
    with open(out / "run" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    train_recs = [r for r in records if "loss" in r]
    val = [r for r in records if "validation/loss" in r]
    last = train_recs[-1]
    n_params = model_config("byte_25m").num_params
    log({"packed_training": {
        "overrides": overrides, "steps": last["step"], "wall_s": train_wall,
        "tokens_per_step": cfg.training.batch_size * cfg.training.train_context,
        "losses": [(r["step"], r["loss"]) for r in train_recs],
        "validation_loss": val[-1]["validation/loss"], "heldout_unigram_entropy_nats": entropy,
        "step_time_ms": last["step_time_ms"], "tokens_per_sec": last["tokens_per_sec"],
        "model_flops_share": last.get("model_flops_share"),
        "model_flops_formula": f"tokens/s * 3 * (2 * N + 4 * L * d * T) / 989e12, N = {n_params}, "
                               "L = 8, d = 512, T = 512",
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "want": want, "eval_batches": eval_batches,
    }})
    if not all(math.isfinite(r["loss"]) for r in train_recs) or not val[-1]["validation/loss"] < entropy:
        raise AssertionError(f"validation loss {val[-1]['validation/loss']} not below the held-out unigram "
                             f"entropy {entropy} nats")

    # 4. the eval harness on the trained model, and bpb through the plain path
    model = trainer.state.model
    lastword, choice = heldout_tasks(heldout)
    tokens = list(stream)
    t0 = time.perf_counter()
    bpb = perplexity(model, tokens, CTX, EVAL_BATCH, num_bytes=len(tokens))
    lam = lambada(model, lastword, CTX, EVAL_BATCH)
    cho = choice_accuracy(model, choice, CTX, EVAL_BATCH) if choice else {"examples": 0}
    eval_s = time.perf_counter() - t0
    plain = train_model("xla", torch.bfloat16, {k: v.detach() for k, v in model.state_dict().items()},
                        "byte_25m")
    bpb_plain = perplexity(plain, tokens, CTX, EVAL_BATCH, num_bytes=len(tokens))
    del plain
    entropy_bits = entropy / math.log(2)
    log({"packed_eval": {
        "bits_per_byte": bpb["bits_per_byte"], "bits_per_byte_plain": bpb_plain["bits_per_byte"],
        "unigram_entropy_bits": entropy_bits, "byte_ppl": bpb["ppl"], "scored_bytes": bpb["tokens"],
        "lastword": lam, "choice": cho, "eval_s": eval_s}})
    if not bpb["bits_per_byte"] < entropy_bits:
        raise AssertionError(f"bits per byte {bpb['bits_per_byte']} not below the unigram entropy {entropy_bits}")
    if abs(bpb["bits_per_byte"] - bpb_plain["bits_per_byte"]) > BPB_GAP:
        raise AssertionError(f"kernel-path bpb {bpb['bits_per_byte']} vs plain {bpb_plain['bits_per_byte']}")
    # the handoff: the eval CLI scores the trainer's saved step directory
    step_dir = out / "run" / str(PACKED_STEPS)
    ppl_data = out / "heldout_ppl.json"
    ppl_data.write_text(json.dumps({"tokens": tokens, "num_bytes": len(tokens)}))
    cmd = [sys.executable, "-m", "zero_transformer_tpu_torch.evalharness", "--model", "byte_25m", "--params",
           str(step_dir), "--task", "bpb", "--data", str(ppl_data), "--seq-len", str(CTX), "--batch-size",
           str(EVAL_BATCH)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=root)
    if proc.returncode != 0:
        raise AssertionError(f"eval CLI on {step_dir} exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    handoff = json.loads(proc.stdout.strip().splitlines()[-1])
    log({"packed_handoff": {"params": str(step_dir.relative_to(out)), "eval_cli_bits_per_byte":
                            handoff["bits_per_byte"], "in_process": bpb["bits_per_byte"],
                            "atol": HANDOFF_BPB_ATOL}})
    if not handoff["device"].startswith("cuda") or abs(handoff["bits_per_byte"] - bpb["bits_per_byte"]) > \
            HANDOFF_BPB_ATOL:
        raise AssertionError(f"eval CLI --params {step_dir}: {handoff} vs in-process {bpb['bits_per_byte']}")
    packed_int8(model, heldout, tokens, bpb["bits_per_byte"], out)
    # two more steps under the profiler, after the eval has scored the run
    train_profile(trainer.train_step, trainer.state, batch[None], label="packed_training_profile")
    del trainer, model
    torch.cuda.empty_cache()

    # 5. the trainer CLI on the same shards
    cli_dir = out / "cli"
    cmd = [sys.executable, "-m", "zero_transformer_tpu_torch.train", "--cfg", str(yaml_path), "--max-steps", "20",
           "--set", f"data.train_path={data / 'train.index'}", f"data.validation_path={data / 'val.index'}",
           f"checkpoint.directory={cli_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"trainer CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(cli_dir / "metrics.jsonl") as f:
        cli_recs = [r for r in map(json.loads, f) if "loss" in r]
    if not cli_recs or not all(math.isfinite(r["loss"]) for r in cli_recs):
        raise AssertionError(f"packed trainer CLI metrics incomplete or non-finite: {cli_recs}")
    log({"packed_trainer_cli": {"wall_s": wall, "steps": cli_recs[-1]["step"], "loss": cli_recs[-1]["loss"],
                                "tokens_per_sec": cli_recs[-1]["tokens_per_sec"],
                                "step_time_ms": cli_recs[-1]["step_time_ms"],
                                "model_flops_share": cli_recs[-1].get("model_flops_share")}})
    return launches


# the eval CLI on the trainer's step directory against the in-process eval of
# the same weights: equal but for the order in which cuBLAS sums in another
# process
HANDOFF_BPB_ATOL = 1e-4

# JAX's budget for weight-only int8 (tests/test_quant.py::test_quant_perplexity_budget):
# perplexity within 2 %, so bits per byte within log2(1.02)
INT8_BPB_BUDGET = math.log2(1.02)


def packed_int8(model, heldout, tokens, bpb_bf16: float, out: Path) -> None:
    """The trained byte_25m with weight-only int8: bits per byte on the
    held-out stream within INT8_BPB_BUDGET of the bf16 value; then eight
    held-out prompts served in-process by the engine twice, in bf16 and
    with int8 KV plus int8 weights, greedy, 32 tokens each: the share of
    tokens before each stream's first divergence (no bar). Then the CLIs a
    user runs, on an ``.npz`` of the same weights: the eval harness with
    ``--quantize int8`` must give the same bits per byte, and the server
    with ``--kv-cache-dtype int8 --quantize int8`` must answer a request
    through K4's int8 branch."""
    from zero_transformer_tpu_torch.convert import params_to_jax
    from zero_transformer_tpu_torch.evalharness import perplexity
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.models.quant import quantize_model

    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    qmodel = model_getter("byte_25m", dtype=torch.bfloat16, device="cuda")
    qmodel.load_state_dict(state)
    qmodel = quantize_model(qmodel)
    bpb_q = perplexity(qmodel, tokens, CTX, EVAL_BATCH, num_bytes=len(tokens))["bits_per_byte"]
    del qmodel
    paras = [p.strip() for doc in heldout for p in doc.split("\n\n") if 120 <= len(p.strip().encode()) <= 400]
    if len(paras) < 8:
        raise AssertionError(f"the held-out text gives {len(paras)} prompts of 120-400 bytes, want 8")
    prompts = [list(p.encode()) for p in paras[:8]]
    streams = {}
    for label, int8 in (("bf16", False), ("int8", True)):
        engine = build_engine("auto", name="byte_25m", state=state, cache_len=CTX, **(INT8 if int8 else {}))
        handles = [engine.submit(p, max_new_tokens=MAX_NEW, seed=i) for i, p in enumerate(prompts)]
        engine.run_until_idle()
        if any(h.status != "done" or len(h.tokens) != MAX_NEW for h in handles):
            raise AssertionError(f"byte_25m {label} serving: {[(h.status, len(h.tokens)) for h in handles]}")
        streams[label] = [h.tokens for h in handles]
        del engine
    prefix = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), MAX_NEW)
              for x, y in zip(streams["bf16"], streams["int8"])]
    log({"packed_int8": {
        "bits_per_byte_bf16": bpb_bf16, "bits_per_byte_int8_weights": bpb_q, "gap": bpb_q - bpb_bf16,
        "budget": INT8_BPB_BUDGET, "served_prompts": len(prompts), "prompt_bytes": [len(p) for p in prompts],
        "agree_before_first_divergence": sum(prefix) / (MAX_NEW * len(prompts)),
        "identical_prefix_per_prompt": prefix}})
    if not bpb_q <= bpb_bf16 + INT8_BPB_BUDGET:
        raise AssertionError(f"int8-weight bits per byte {bpb_q} beyond bf16 {bpb_bf16} + {INT8_BPB_BUDGET}")
    torch.cuda.empty_cache()

    # the CLIs, each quantizing the .npz's float32 tree on the host
    npz = out / "byte_25m.npz"
    np.savez(npz, **params_to_jax(state))
    data = out / "heldout_ppl.json"
    data.write_text(json.dumps({"tokens": tokens, "num_bytes": len(tokens)}))
    cmd = [sys.executable, "-m", "zero_transformer_tpu_torch.evalharness", "--model", "byte_25m", "--params",
           str(npz), "--task", "bpb", "--data", str(data), "--seq-len", str(CTX), "--batch-size", str(EVAL_BATCH),
           "--quantize", "int8"]
    # the eval CLI runs while the serve CLI starts and answers (neither is timed)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=Path(__file__).resolve().parent)
    try:
        served = serve_cli(npz, paras[0])
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"eval CLI exit {proc.returncode}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
    cli = json.loads(stdout.strip().splitlines()[-1])
    if not cli["device"].startswith("cuda") or abs(cli["bits_per_byte"] - bpb_q) > CLI_BPB_ATOL:
        raise AssertionError(f"eval CLI --quantize int8: {cli} vs in-process {bpb_q}")
    log({"packed_int8_clis": {"eval_bits_per_byte": cli["bits_per_byte"], "in_process": bpb_q,
                              "serve": served, "serve_tokens_agree_with_engine": sum(
                                  int(a == b) for a, b in zip(served["tokens"], streams["int8"][0]))}})


# the eval CLI's bits per byte on the .npz against the in-process model's:
# the same int8 weights and the same batches, so equal but for the order in
# which cuBLAS may sum in another process
CLI_BPB_ATOL = 1e-5


def serve_cli(npz: Path, prompt: str) -> dict:
    """``python -m zero_transformer_tpu_torch.serve --server --kv-cache-dtype
    int8 --quantize int8`` on byte_25m's ``.npz``, in a process of its own on
    a free port: one greedy request of 32 tokens, then ``/metrics``; the
    server is stopped with SIGINT (and killed if it does not stop)."""
    import queue
    import signal

    cmd = [sys.executable, "-m", "zero_transformer_tpu_torch.serve", "--model", "byte_25m", "--params", str(npz),
           "--server", "--port", "0", "--cache-len", str(CTX), "--kv-cache-dtype", "int8", "--quantize", "int8",
           "--greedy", "--temperature", "1.0", "--top-p", "0.0", "--repetition-penalty", "1.0"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=Path(__file__).resolve().parent)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    try:
        base, seen, deadline = None, [], time.monotonic() + 300
        while base is None:
            try:
                line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"serve CLI printed no address within 300 s: {seen[-20:]}") from None
            seen.append(line)
            found = re.search(r"serving on (http://[0-9.]+:[0-9]+)", line)
            base = found.group(1) if found else None
            if proc.poll() is not None and base is None and lines.empty():
                raise AssertionError(f"serve CLI exit {proc.returncode}: {seen[-20:]}")
        for _ in range(600):
            try:
                if http("GET", base + "/healthz", timeout=10)[0] == 200:
                    break
            except urllib.error.HTTPError:
                time.sleep(0.05)
        code, text = http("POST", base + "/generate", {"prompt": prompt, "max_new_tokens": MAX_NEW,
                                                      "stream": False})
        doc = json.loads(text)
        metrics = json.loads(http("GET", base + "/metrics")[1])
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    launches = metrics["kernel_launches"]
    if code != 200 or doc["status"] != "done" or len(doc["tokens"]) != MAX_NEW:
        raise AssertionError(f"serve CLI request: HTTP {code}, {doc}")
    if (metrics["kv_cache_dtype"], metrics["param_quant"]) != ("int8", "int8") or not (
            launches["paged_attention_int8"] > 0 and launches["flash_serving_fwd"] > 0
            and launches["paged_attention"] == 0) or not metrics["device"].startswith("cuda"):
        raise AssertionError(f"serve CLI did not serve int8 through the kernels: {metrics}")
    return {"tokens": doc["tokens"], "device": metrics["device"], "kv_pool_bytes": metrics["kv_pool_bytes"],
            "weight_bytes": metrics["weight_bytes"], "launches": {k: v for k, v in launches.items() if v},
            "exit": proc.returncode}


# ------------------------------------------------- sequence-parallel kernels

SP_T = 2048  # 580m's shard: T 8192 over 4 ranks
# (label, B, t, H, KVH, D, dtype, docs); "main" is 580m's ring shape
SP_CASES = [
    ("main", 1, SP_T, 12, 12, 128, torch.bfloat16, False),
    ("main_docs", 1, SP_T, 12, 12, 128, torch.bfloat16, True),
    ("main_f32", 1, SP_T, 12, 12, 128, torch.float32, True),
    ("gqa", 2, 256, 8, 2, 128, torch.bfloat16, True),
    ("gqa_f32", 2, 256, 8, 2, 128, torch.float32, True),
    ("d64", 2, 256, 4, 4, 64, torch.bfloat16, True),
    ("d64_f32", 2, 256, 4, 4, 64, torch.float32, False),
]
# the timed cases' past shards and the suffix of their kernel-table rows
SP_TIMED = {"main": "", "main_docs": "_docs"}
# (query shard, key shard) of a 3-shard sequence
SP_PAIRS = {"diagonal": (1, 1), "past": (2, 1), "future": (0, 2)}
MASKED_LSE = -1e9  # a row with no visible key of its document has lse ~ -1e10 or -1e30


def sp_doc_ids(B: int, T: int) -> torch.Tensor:
    """[B, T] exclusive-cumsum document ids whose documents span both shard
    boundaries of a 3-shard row, and some that start inside a shard."""
    sep = torch.zeros(B, T, dtype=torch.int32)
    for b in range(B):
        for f in (0.05, 0.3, 0.45, 0.6, 0.62, 0.9):
            sep[b, int(f * T) + 7 * b] = 1
    return (torch.cumsum(sep, 1) - sep).to(torch.int32).cuda()


def partial_bounds(B, t, H, KVH, D, dtype, pairs, ids_bytes):
    """Least times (ms, bound_by) of flash_partial's K1 (f32 out + lse) and
    flash_grads' K2 and K3 (f32 grads) on one shard pair: bytes (inputs read
    once, outputs written once) over HBM, or the products' flops over the
    (query, key) pairs the causal limit admits, over the input dtype's peak."""
    el = torch.finfo(dtype).bits // 8
    qb, kb, row = B * t * H * D * el, B * t * KVH * D * el, B * H * t * 4
    q32, k32 = B * t * H * D * 4, B * t * KVH * D * 4
    work = {  # name: (bytes, flops)
        "flash_partial_fwd": (qb + 2 * kb + q32 + row + ids_bytes, 2 * 2 * D * B * H * pairs),
        "flash_partial_dq": (2 * qb + 2 * kb + 2 * row + q32 + ids_bytes, 3 * 2 * D * B * H * pairs),
        "flash_partial_dkv": (2 * qb + 2 * kb + 2 * row + 2 * k32 + ids_bytes, 4 * 2 * D * B * H * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        out[name] = (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")
    return out


def sp_sdpa_bias(q_off, kv_off, t, Hq, q_ids, k_ids, dtype, alibi=True):
    from zero_transformer_tpu_torch.ops.positions import NEG_INF, alibi_slopes

    dist = (q_off + torch.arange(t, device="cuda"))[:, None] - (kv_off + torch.arange(t, device="cuda"))
    slopes = alibi_slopes(Hq, "cuda") if alibi else torch.zeros(1, device="cuda")
    bias = -slopes[:, None, None] * dist.clamp(min=0).float()
    bias = (bias + torch.where(dist >= 0, 0.0, NEG_INF))[None]
    if q_ids is not None:
        bias = bias + torch.where(q_ids[:, :, None] == k_ids[:, None, :], 0.0, NEG_INF)[:, None]
    return bias.to(dtype)


def sp_kernel_phase(cases=SP_CASES, timed=SP_TIMED, alibi=True):
    """flash_partial (K1 at global offsets, f32 out) and flash_grads (K2/K3
    at global offsets given the global lse and delta, f32 grads) against
    their plain versions, on the diagonal, a past and a future shard of a
    3-shard sequence, with and without separate query and key document ids;
    f32 within atol 1e-4; bf16 forward within MMA_ATOL plus one p-rounding
    flip of the f32-output emulation of its rounding and its lse within
    MMA_LSE_ATOL, bf16 grads within one
    bf16 ulp + GRAD_ATOL of the largest |grad| (the training bars), each bf16
    bar rejecting a plain version one key off in kv_offset and (past shard,
    ids) one that reads the query ids as key ids; a future shard writes
    o = 0, lse = -1e30 and zero grads exactly. Rows that see no key of their
    own document in a shard (lse near -1e10) carry weight exp(lse - m) = 0
    in the ring's merge: their lse must be masked in both, their o is not
    compared (its value, a mean over keys whose scores round to the same
    multiple of 1024 near -1e10, is not part of the function). ``alibi``
    False: every call without ALiBi, and the kv-offset control on the
    diagonal shard only (a past shard sees all its keys either way). The
    ``timed`` cases' past shards give rows (label: row suffix)."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    for label, B, t, Hq, KVH, Dq, dtype, docs in cases:
        g = torch.Generator(device="cuda").manual_seed(len(label) + 500)
        T = 3 * t
        q, k, v, do = (torch.randn(B, T, h, Dq, generator=g, device="cuda").to(dtype)
                       for h in (Hq, KVH, KVH, Hq))
        ids = sp_doc_ids(B, T) if docs else None
        scale = 1.0 / Dq**0.5
        # the global out and lse of the whole sequence, as the ring hands them to flash_grads
        o_all, lse_all = flash._launch_fwd(q, k, v, causal=True, alibi=alibi, q_offset=0, segment_ids=None,
                                           scale=scale, want_lse=True, counter=flash.TRAIN_KERNEL, doc_ids=ids)

        def cut(x, i, dim=1):
            return None if x is None else x.narrow(dim, i * t, t).contiguous()

        for pair, (qi, ki) in SP_PAIRS.items():
            qs, ks, vs, dos = cut(q, qi), cut(k, ki), cut(v, ki), cut(do, qi)
            q_ids, k_ids = cut(ids, qi), cut(ids, ki)
            at = dict(causal=True, alibi=alibi, softmax_scale=scale, q_offset=qi * t, kv_offset=ki * t)
            o_k, lse_k = flash.flash_partial(qs, ks, vs, **at, q_ids=q_ids, k_ids=k_ids)
            ref_o, ref_lse = flash.flash_partial_reference(qs, ks, vs, **at, q_ids=q_ids, k_ids=k_ids)
            torch.cuda.synchronize()
            if o_k.dtype != torch.float32 or lse_k.dtype != torch.float32:
                raise AssertionError(f"sp {label} {pair}: flash_partial wrote {o_k.dtype}/{lse_k.dtype}")
            live = ref_lse > MASKED_LSE  # [B, H, t]
            if not torch.equal(lse_k > MASKED_LSE, live):
                raise AssertionError(f"sp {label} {pair}: the kernel masks other rows than the plain version")
            live_o = live.transpose(1, 2)[..., None].expand_as(o_k)
            line = {"kernel": "flash_partial", "case": label, "pair": pair, "dtype": str(dtype),
                    "shape": [B, t, Hq, KVH, Dq], "live_row_share": float(live.float().mean())}
            line["fwd_max_err"] = compare(o_k[live_o], ref_o[live_o], torch.float32 if dtype == torch.float32
                                          else dtype, f"sp fwd {label} {pair}")
            compare(lse_k[live], ref_lse[live], torch.float32 if dtype == torch.float32 else dtype,
                    f"sp lse {label} {pair}")
            if pair == "future" and not (bool((o_k == 0).all()) and bool((lse_k == flash.INIT_M).all())):
                raise AssertionError(f"sp {label}: a future shard must write o = 0 and lse = -1e30")
            if dtype == torch.bfloat16:
                emu, emu_lse, flip = flash_mma_emulation(qs, ks, vs, qi * t, torch.ones(B, t, device="cuda"),
                                                         q_ids, with_flip=True, kv_offsets=ki * t,
                                                         k_docs=k_ids, round_out=False, alibi=alibi)

                def over(e):
                    return float(((o_k - e).abs() / (MMA_ATOL + flip))[live_o].max()) if bool(live.any()) else 0.0

                miss, lse_err = over(emu), float((lse_k - emu_lse)[live].abs().max()) if bool(live.any()) else 0.0
                if miss > 1.0 or lse_err > MMA_LSE_ATOL:
                    raise AssertionError(f"sp {label} {pair}: {miss} of the emulation bar, lse {lse_err}")
                line["mma"] = {"max_err_over_bar": miss, "lse_max_abs_err": lse_err}
                controls = {}
                if pair == "diagonal" or (alibi and pair != "future"):
                    controls["kv_offset_plus_1"] = dict(kv_offsets=ki * t + 1, k_docs=k_ids)
                if pair == "past" and docs:
                    controls["q_ids_as_k_ids"] = dict(kv_offsets=ki * t, k_docs=q_ids)
                for what, kw in controls.items():
                    # a past shard's keys all lie behind its queries: one key
                    # off moves every ALiBi bias of a row alike, so o cannot
                    # tell, but the lse the ring merges by does
                    c_o, c_lse = flash_mma_emulation(qs, ks, vs, qi * t, torch.ones(B, t, device="cuda"), q_ids,
                                                     round_out=False, alibi=alibi, **kw)
                    c_miss, c_lse_err = over(c_o), float((lse_k - c_lse)[live].abs().max())
                    if c_miss <= 1.0 and c_lse_err <= MMA_LSE_ATOL:
                        raise AssertionError(f"sp {label} {pair}: the {what} control passes the bars "
                                             f"({c_miss}, lse {c_lse_err})")
                    line["mma"][what] = {"max_err_over_bar": c_miss, "lse_max_abs_err": c_lse_err}
                del emu, flip

            # backward against the global o and lse, delta from the caller
            o_g, lse_g = cut(o_all, qi), cut(lse_all, qi, dim=2)
            delta = (dos.float() * o_g.float()).sum(-1).transpose(1, 2).contiguous()
            got = flash.flash_grads(qs, ks, vs, o_g, lse_g, dos, **at, delta=delta, q_ids=q_ids, k_ids=k_ids)
            f32_in = [x.float() for x in (qs, ks, vs, o_g)] + [lse_g, dos.float()]
            ref = flash.flash_grads_reference(*f32_in, **at, delta=delta, q_ids=q_ids, k_ids=k_ids)
            torch.cuda.synchronize()
            if any(x.dtype != torch.float32 for x in got):
                raise AssertionError(f"sp {label} {pair}: flash_grads wrote {[x.dtype for x in got]}")
            if pair == "future" and any(bool(x.any()) for x in got):
                raise AssertionError(f"sp {label}: a future shard's grads must be exactly 0")
            if dtype == torch.float32:
                errs = [compare(a, b, dtype, f"sp {n} {label} {pair}") for n, a, b in zip(("dq", "dk", "dv"), got, ref)]
            else:
                misses = [grad_miss(a, b) for a, b in zip(got, ref)]
                if max(misses) > 1.0:
                    raise AssertionError(f"sp {label} {pair}: bf16 dq/dk/dv at {misses} of their bars")
                line["bf16_grads_over_bar"] = misses
                errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
                controls = {}
                if pair == "diagonal" or (alibi and pair != "future"):
                    controls["kv_offset_plus_1"] = dict(at, kv_offset=ki * t + 1, q_ids=q_ids, k_ids=k_ids)
                if pair == "past" and docs:
                    controls["q_ids_as_k_ids"] = dict(at, q_ids=q_ids, k_ids=q_ids)
                for what, kw in controls.items():
                    off = flash.flash_grads_reference(*f32_in, **kw, delta=delta)
                    c_miss = [grad_miss(a, b) for a, b in zip(got, off)]
                    if max(c_miss) <= 1.0:
                        raise AssertionError(f"sp {label} {pair}: the {what} control passes the bars ({c_miss})")
                    line[f"grads_{what}_over_bar"] = c_miss
                    del off
            line.update(dq_max_err=errs[0], dk_max_err=errs[1], dv_max_err=errs[2])
            log(line)
            del ref
            if not (label in timed and pair == "past"):
                continue
            suffix = timed[label]
            check_deterministic(qs, ks, vs, dos, lse_g, delta,
                                dict(causal=True, alibi=alibi, scale=scale, q_offset=qi * t, kv_offset=ki * t,
                                     q_ids=q_ids, k_ids=k_ids, out_dtype=torch.float32), f"sp {label} {pair}")
            check_deterministic_fwd(lambda: flash.flash_partial(qs, ks, vs, **at, q_ids=q_ids, k_ids=k_ids),
                                    f"sp {label} {pair}")
            kern = {
                "flash_partial_fwd": lambda: flash.flash_partial(qs, ks, vs, **at, q_ids=q_ids, k_ids=k_ids),
                "flash_partial_dq": lambda: flash.launch_dq(
                    qs, ks, vs, dos, lse_g, delta, causal=True, alibi=alibi, scale=scale, q_offset=qi * t,
                    kv_offset=ki * t, q_ids=q_ids, k_ids=k_ids, out_dtype=torch.float32, counter="flash_partial_dq"),
                "flash_partial_dkv": lambda: flash.launch_dkv(
                    qs, ks, vs, dos, lse_g, delta, causal=True, alibi=alibi, scale=scale, q_offset=qi * t,
                    kv_offset=ki * t, q_ids=q_ids, k_ids=k_ids, out_dtype=torch.float32, counter="flash_partial_dkv"),
            }
            kern_ms = {n: time_ms(fn, iters=10) for n, fn in kern.items()}
            kern_dev = {n: device_ms(fn, iters=10) for n, fn in kern.items()}
            plain_fwd = time_ms(lambda: flash.flash_partial_reference(qs, ks, vs, **at, q_ids=q_ids, k_ids=k_ids),
                                iters=3)
            # the plain backward computes dq, dk and dv together: one time for K2 and K3
            plain_bwd = time_ms(lambda: flash.flash_grads_reference(qs, ks, vs, o_g, lse_g, dos, **at, delta=delta,
                                                                    q_ids=q_ids, k_ids=k_ids), iters=3)
            bias = sp_sdpa_bias(qi * t, ki * t, t, Hq, q_ids, k_ids, dtype, alibi)
            qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (qs, ks, vs))
            lib_kw = dict(attn_mask=bias, enable_gqa=Hq != KVH)
            lib_out = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw), iters=10)
            lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dos.transpose(1, 2),
                                                          retain_graph=True), iters=10)
            pairs = t * t if qi > ki else causal_pairs(t, True)
            bounds = partial_bounds(B, t, Hq, KVH, Dq, dtype, pairs, 8 * B * t if docs else 0)
            for name in kern:
                err = line["fwd_max_err"] if name == "flash_partial_fwd" else (
                    errs[0] if name == "flash_partial_dq" else max(errs[1:]))
                bound, by = bounds[name]
                rows[name + suffix] = dict(max_abs_err=err, ms=kern_ms[name], device_ms=kern_dev[name],
                                           plain_ms=plain_fwd if name == "flash_partial_fwd" else plain_bwd,
                                           library_ms=lib_fwd if name == "flash_partial_fwd" else lib_bwd,
                                           bound_ms=bound, bound_by=by)
                log({"kernel": name + suffix, "shape": [B, t, Hq, KVH, Dq], "pair": pair, **rows[name + suffix]})
            del lib_out, qt, kt, vt, bias
        del q, k, v, do, o_all, lse_all
        torch.cuda.empty_cache()
    return rows


# -------------------------------------------------------- sequence parallel

SP_RANKS, SP_SEQ, SP_MODEL, SP_LR = 4, 8192, "580m", 1e-4
# 580m at full width with its depth cut 18 -> 4 in the step parity and the
# trainer CLIs: their gloo transfers through the host scale with the layers
# (the op-level ring runs one layer's shape either way)
SP_LAYERS = 4
SP_CLI_LAYERS = 2  # the trainer CLIs' depth: each saves its state at the end
SP_SEPARATORS = (1000, 2047, 2048, 3000, 6100, 8191)  # packed case: across and on shard edges
SP_STEP_CASES = {"plain": {}, "packed": {"doc_sep_token": 0}}  # 580m overrides
# the same steps through Ulysses (cp_impl: ulysses), held to the same one-card references
SP_ULYSSES_CASES = {"ulysses_plain": {"cp_impl": "ulysses"},
                    "ulysses_packed": {"doc_sep_token": 0, "cp_impl": "ulysses"}}


def sp_layer_inputs(docs: bool):
    """580m's attention at T 8192 (one row, 12 heads of 128, bf16), made on
    the CPU from seed 21 so every rank and the one-card run see the same
    tensors: q, k, v, the output grad g, and document ids (or None)."""
    g = torch.Generator().manual_seed(21)
    q, k, v, do = (torch.randn(1, SP_SEQ, 12, 128, generator=g).bfloat16() for _ in range(4))
    return q, k, v, do, (sp_doc_ids(1, SP_SEQ).cpu() if docs else None)


def sp_batch(packed: bool) -> torch.Tensor:
    """One micro-batch [1, 1, T 8192] of token ids from seed 23 (the packed
    case with separators across and on the shard edges)."""
    tokens = torch.randint(1, 50304, (1, 1, SP_SEQ), generator=torch.Generator().manual_seed(23), dtype=torch.int32)
    if packed:
        tokens[..., list(SP_SEPARATORS)] = 0
    return tokens


def sp_model(overrides: dict, device, dtype=torch.bfloat16):
    from zero_transformer_tpu_torch.models import model_getter

    return model_getter(SP_MODEL, dtype=dtype, device=device, seed=SEED, trainable=True, dropout=0.0,
                        remat=True, n_layers=SP_LAYERS, **overrides)


def param_checksum(model) -> int:
    """The sum of every float32 param's bits read as int32: equal only if
    the params are (up to a collision) bit-equal."""
    return sum(int(p.detach().view(torch.int32).sum(dtype=torch.int64)) for p in model.parameters())


def _sp_rank(rank: int, world: int, backend: str, init_file: str, out_dir: str, dtype_name: str,
             tensor_training: bool = False) -> None:
    """One rank of the sequence-parallel phase: the op-level ring at 580m's
    layer shape, then one ring train step of 580m per case (launch counts,
    grad cosines against the one-card grads on rank 0, the param checksum,
    peak memory), and a second step under the profiler on rank 0; with
    ``tensor_training``, the tensor_training phase's part (b) after them
    (``tt_sp_step``)."""
    from torch.profiler import ProfilerActivity, profile

    from zero_transformer_tpu_torch.config import OptimizerConfig
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.ops.ring_attention import ring_attention
    from zero_transformer_tpu_torch.parallel.mesh import destroy, init_distributed
    from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    out = Path(out_dir)
    mesh = init_distributed(world, backend, "cuda", rank=rank, world_size=world,
                            init_method=f"file://{init_file}", local_rank=rank)
    group = mesh.sequence
    dev = group.device
    result = {"rank": rank, **mesh.describe()}
    t = SP_SEQ // world
    sl = slice(rank * t, (rank + 1) * t)
    for docs in (False, True):
        q, k, v, do, ids = sp_layer_inputs(docs)
        qs, ks, vs = (x[:, sl].to(dev).requires_grad_() for x in (q, k, v))
        o = ring_attention(qs, ks, vs, group, causal=True, alibi=True,
                           doc_ids=None if ids is None else ids[:, sl].to(dev))
        grads = torch.autograd.grad(o, (qs, ks, vs), do[:, sl].to(dev))
        torch.save([x.detach().cpu() for x in (o, *grads)], out / f"op_{int(docs)}_{rank}.pt")
        del q, k, v, do, qs, ks, vs, o, grads
    for case, overrides in {**SP_STEP_CASES, **SP_ULYSSES_CASES}.items():
        model = sp_model(overrides, dev, dtype).set_sequence_group(group)
        init_checksum = param_checksum(model)
        opt_cfg = OptimizerConfig(schedule="constant", peak_learning_rate=SP_LR)
        schedule = make_schedule(opt_cfg)
        st = init_train_state(model, opt_cfg, schedule)
        captured, adamw_step = {}, st.optimizer.step

        def capture(grads, norm=None, keep=None, _step=adamw_step):  # the grads the step hands to AdamW, by name
            captured["grads"] = st.shards.layout.views(torch.cat([g.reshape(-1) for g in grads]))
            return _step(grads, norm, keep)

        st.optimizer.step = capture
        step = make_train_step(1, schedule, seq_group=group)
        batch = sp_batch(case.endswith("packed")).to(dev)
        torch.cuda.synchronize(dev)
        group.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        metrics = step(st, batch)
        torch.cuda.synchronize(dev)
        step_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        line = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "step_s": step_s,
                "launches": {n: c for n, c in launches.items() if c}, "init_checksum": init_checksum,
                "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        if rank == 0:
            ref = torch.load(out / f"ref_{case.removeprefix('ulysses_')}.pt", mmap=True, weights_only=True)
            cos = {n: float(torch.nn.functional.cosine_similarity(
                g.flatten().double(), ref["grads"][n].to(dev).flatten().double(), dim=0))
                for n, g in captured["grads"].items()}
            line.update(grad_cos_min=min(cos.values()), grad_cos_min_tensor=min(cos, key=cos.get),
                        grad_cos_below_bar={n: c for n, c in cos.items() if c < COS_BAR}, ref_loss=ref["loss"])
            del ref
        captured.clear()
        line["checksum_after_update"] = param_checksum(model)
        # a second step, under the profiler on rank 0: where the ring step's time goes
        group.barrier()
        if rank == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(st, batch)
                torch.cuda.synchronize(dev)
                wall_ms = (time.perf_counter() - t0) * 1e3
            spans = {ev.key: ev.cpu_time_total / 1e3 for ev in prof.key_averages()
                     if ev.key.startswith("sequence_group.") and str(ev.device_type).endswith("CPU")}
            kernels = kernel_times(prof)
            busy = sum(ms for ms, _ in kernels.values())
            flash_ms = sum(ms for name, (ms, _) in kernels.items() if "flash" in name)
            line["profile"] = {
                "wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
                "flash_kernels_ms": flash_ms, "all_reduce_ms": spans.get("sequence_group.all_reduce", 0.0),
                "all_reduce_share": spans.get("sequence_group.all_reduce", 0.0) / wall_ms,
                "rotate_ms": spans.get("sequence_group.rotate", 0.0),
                "rotate_share": spans.get("sequence_group.rotate", 0.0) / wall_ms,
                "all_to_all_ms": spans.get("sequence_group.all_to_all", 0.0),
                "all_to_all_share": spans.get("sequence_group.all_to_all", 0.0) / wall_ms,
                "all_gather_ms": spans.get("sequence_group.all_gather", 0.0),
                "top_kernels_ms": top_kernels(kernels, 10, 1, 60)}
        else:
            step(st, batch)
            torch.cuda.synchronize(dev)
        result[case] = line
        del st, model, step, batch, metrics, capture, adamw_step
        gc.collect()  # the AdamW step wrapper made a cycle through the optimizer
        torch.cuda.empty_cache()
    if tensor_training:
        result["tensor_training"] = tt_sp_step(mesh, backend, out, dtype)
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    group.barrier()
    destroy(mesh)


def sequence_parallel_phase(dtype=torch.bfloat16, tensor_training: bool = False) -> dict:
    """580m at full width, its depth cut to ``SP_LAYERS``, at T 8192 over 4
    ranks: NCCL with a card per rank when the machine has 4, else 4 ranks
    sharing card 0 over gloo (each rank's
    kernels run on the card; the transfers stage through pinned host
    memory). Before the ranks start, the one-card reference: one 580m step's
    loss and grads (remat, the same seeded weights and batch) per case,
    saved for rank 0. Then the ranks run the ring at the layer shape and
    the ring train step (``_sp_rank``). Fails unless: the ring's output is
    within the bf16 bar (atol/rtol 2e-2) of the one-card ``flash_attention``
    on the gathered tensors and its grads within K2/K3's bar (one bf16 ulp +
    GRAD_ATOL of the largest |grad|), with and without document ids; the
    ring step's loss is within LOSS_MARGIN of the one-card loss, every
    grad's cosine at least COS_BAR; the seeded weights and the params after
    the update are bit-equal across the ranks (checksums); the launches per
    rank per micro-step are exact: flash_partial_fwd = L x n x 2 (the
    forward, and its recompute under remat), flash_partial_dq =
    flash_partial_dkv = L x n, for L layers and n ranks (the ``_docs``
    counters in the packed case). Then the trainer CLI under
    ``torch.distributed.run`` for 3 steps of configs/train_580m_8k.yaml at
    ``SP_CLI_LAYERS`` layers and, beside it on the same card, the same CLI on one card (their step
    readings ``contended_*``: neither run had the card alone). Returns the ring's launch counts and, as
    the ``_d128`` rows of the kernel table, the one-card reference's
    (the training entry at D 128: ``flash_train_fwd_d128``,
    ``flash_dq_d128``, ``flash_dkv_d128``, plain case).

    With ``dtype`` float32 (the ``sequence_parallel_f32`` phase) every
    kernel of both sides takes its f32 path: the same bars and readings
    under ``_f32`` names, without the trainer CLIs. ``tensor_training``:
    the ranks run the tensor_training phase's part (b) as well, checked
    here against the same one-card reference (``check_tt_sp``)."""
    from zero_transformer_tpu_torch.config import model_config
    from zero_transformer_tpu_torch.ops import _build, flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = "" if dtype == torch.bfloat16 else "_" + str(dtype).removeprefix("torch.")
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= SP_RANKS else "gloo"
    topology = {"ranks": SP_RANKS, "cards": min(cards, SP_RANKS), "backend": backend,
                "transfers": "NCCL, card to card" if backend == "nccl" else "gloo through pinned host memory"}
    log({f"sequence_parallel{tag}_topology": topology})
    out = Path("build") / "sp"
    out.mkdir(parents=True, exist_ok=True)
    L = SP_LAYERS

    # the one-card reference, before the ranks take the card's memory
    ref_loss, one_card_launches = {}, {}
    for case, overrides in SP_STEP_CASES.items():
        model = sp_model(overrides, "cuda", dtype)
        init_checksum = param_checksum(model)
        batch = sp_batch(case == "packed")[0].cuda()
        loss_and_grads(model, batch)  # warm-up: cuBLAS's and the allocator's first calls
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(model, batch)
        torch.cuda.synchronize()
        ref_loss[case] = (loss, init_checksum, time.perf_counter() - t0)
        one_card_launches[case] = {n: c for n, c in _build.LAUNCHES.items() if c}
        torch.save({"loss": loss, "grads": {n: g.cpu() for n, g in grads.items()}}, out / f"ref_{case}.pt")
        del model, grads, batch
        torch.cuda.empty_cache()
    log({f"sequence_parallel{tag}_one_card_reference": {
        c: {"loss": l, "step_s": s, "launches": one_card_launches[c]} for c, (l, _, s) in ref_loss.items()}})

    t0 = time.perf_counter()
    results = run_ranks(_sp_rank, SP_RANKS, backend, out, str(dtype).removeprefix("torch."), tensor_training,
                        what="sequence-parallel")
    ranks_s = time.perf_counter() - t0
    if tensor_training:
        TT_STASH["b"] = check_tt_sp(results, ref_loss["plain"][0])

    # the op-level ring against the one-card flash_attention on the gathered tensors
    op = {}
    for docs in (False, True):
        q, k, v, do, ids = sp_layer_inputs(docs)
        q, k, v = (x.cuda().requires_grad_() for x in (q, k, v))
        one = flash.flash_attention(q, k, v, causal=True, alibi=True, doc_ids=None if ids is None else ids.cuda())
        one_grads = torch.autograd.grad(one, (q, k, v), do.cuda())
        shards = [torch.load(out / f"op_{int(docs)}_{r}.pt") for r in range(SP_RANKS)]
        ring = [torch.cat([s[i] for s in shards], dim=1).cuda() for i in range(4)]
        line = {"out_max_err": compare(ring[0], one.detach(), torch.bfloat16, f"ring out docs={docs}")}
        misses = [grad_miss(a, b.float()) for a, b in zip(ring[1:], one_grads)]
        if max(misses) > 1.0:
            raise AssertionError(f"ring grads docs={docs}: {misses} of K2/K3's bars against the one-card grads")
        line["grads_over_bar"] = misses
        line["grads_max_err"] = [float((a.float() - b.float()).abs().max()) for a, b in zip(ring[1:], one_grads)]
        op["docs" if docs else "no_docs"] = line
        del q, k, v, one, one_grads, ring, shards
    torch.cuda.empty_cache()
    log({f"sequence_parallel{tag}_op": op})

    launches = {}
    for case in {**SP_STEP_CASES, **SP_ULYSSES_CASES}:
        lines = [r[case] for r in results]
        loss_ref, ref_init, _ = ref_loss[case.removeprefix("ulysses_")]
        first = lines[0]
        summary = {"loss_ring": first["loss"], "loss_one_card": loss_ref, "loss_margin": LOSS_MARGIN,
                   "grad_cos_min": first["grad_cos_min"], "grad_cos_min_tensor": first["grad_cos_min_tensor"],
                   "step_s_per_rank": [x["step_s"] for x in lines],
                   "peak_memory_gib_per_rank": [x["peak_memory_gib"] for x in lines],
                   "checksums_after_update": [x["checksum_after_update"] for x in lines],
                   "launches_rank0": first["launches"], "profile_rank0": first["profile"]}
        log({f"sequence_parallel{tag}_step_{case}": summary})
        if not abs(first["loss"] - loss_ref) <= LOSS_MARGIN:
            raise AssertionError(f"{case}: ring loss {first['loss']} vs one-card {loss_ref}")
        if first["grad_cos_below_bar"]:
            raise AssertionError(f"{case}: grad cosines below {COS_BAR}: {first['grad_cos_below_bar']}")
        if any(x["init_checksum"] != ref_init for x in lines):
            raise AssertionError(f"{case}: the ranks' seeded weights differ from the one-card model's")
        if len({x["checksum_after_update"] for x in lines}) != 1:
            raise AssertionError(f"{case}: params differ across the ranks after the update")
        sfx = flash.DOCS if case.endswith("packed") else ""
        want = {"flash_partial_fwd" + sfx: L * SP_RANKS * 2, "flash_partial_dq" + sfx: L * SP_RANKS,
                "flash_partial_dkv" + sfx: L * SP_RANKS}
        if case in SP_ULYSSES_CASES:  # one call over the whole row a layer: the forward and its recompute
            want = {"flash_train_fwd" + sfx: L * 2, "flash_dq" + sfx: L, "flash_dkv" + sfx: L}
        for x in lines:
            if x["launches"] != want:
                raise AssertionError(f"{case} rank launches {x['launches']}, want exactly {want}")
        if case in SP_ULYSSES_CASES:
            launches.update({n.removesuffix(sfx) + ("_ulysses" if not sfx else "_ulysses_docs"): c
                             for n, c in first["launches"].items()})
        else:
            launches.update(first["launches"])
    # the training entry at D 128: the one-card reference's launches
    launches.update({n + "_d128": one_card_launches["plain"].get(n, 0)
                     for n in ("flash_train_fwd", "flash_dq", "flash_dkv")})
    sp_rows = ulysses_kernel_rows() if dtype == torch.bfloat16 else {}
    if dtype != torch.bfloat16:
        for f in out.glob("*.pt"):
            f.unlink()
        return launches, sp_rows

    # the trainer CLI under torch.distributed.run and, beside it, on one card
    # (the two share the card: their step times are not the ring's or one
    # card's alone); 580m at its own dropout 0.1, its depth cut to SP_CLI_LAYERS
    L = SP_CLI_LAYERS
    sets = ["training.gradient_accumulation_steps=1", "training.log_frequency=1", f"model.n_layers={L}"]
    flops = (f"tokens/s * 3 * (2 * N + 4 * L * d * T) / (989e12 * cards), "
             f"N = {model_config(SP_MODEL, n_layers=L).num_params}, L = {L}, d = 1536, T = {SP_SEQ}")
    one_card = {}
    beside = threading.Thread(target=lambda: one_card.update(result=trainer_cli_580m(
        ["-m", "zero_transformer_tpu_torch.train"], sets, Path("build") / "train_580m_8k_one_card")))
    beside.start()
    try:
        ring_cli, proc = trainer_cli_580m(
            ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(SP_RANKS), "-m",
             "zero_transformer_tpu_torch.train", "--dist-backend", backend], [f"mesh.sequence={SP_RANKS}", *sets],
            Path("build") / "train_580m_8k_sp")
    finally:
        beside.join()
    topo = next((json.loads(line)["distributed"] for line in proc.stdout.splitlines()
                 if line.startswith('{"distributed"')), None)
    log({"sequence_parallel_trainer_cli": {**ring_cli, "ranks_phase_s": ranks_s, "topology": topo,
                                           "model_flops_formula": flops, "beside": "the one-card CLI"}})
    if topo is None or topo["backend"] != backend or ring_cli["contended_model_flops_share"] is None:
        raise AssertionError(f"the trainer CLI printed no topology or no model-FLOPs share: {topo}, {ring_cli}")
    if "result" not in one_card:
        raise AssertionError("the one-card 580m trainer CLI beside the ring's failed (its error is above)")
    one_cli, _ = one_card["result"]
    log({"one_card_trainer_cli_580m": {**one_cli, "model_flops_formula": flops, "beside": "the ring's CLI"}})
    for f in out.glob("*.pt"):
        f.unlink()
    return launches, sp_rows


def ulysses_kernel_rows() -> dict:
    """K1-K3 at a Ulysses rank's shape (580m at T 8192 over 4 ranks: one
    row of the whole T at 3 heads of 128, bf16) with the slopes of heads
    3-5 (rank 1's): the kernel table's ``_ulysses`` rows
    (``shard_kernel_rows``)."""
    Hq = 12 // SP_RANKS
    return shard_kernel_rows("_ulysses", 1, SP_SEQ, Hq, Hq, 128, (Hq, 12), seed=77)


def shard_kernel_rows(suffix: str, B: int, T: int, Hq: int, KVH: int, Dq: int, heads, seed: int,
                      label: str = "", timed: bool = True) -> dict:
    """K1 (training entry, with lse), K2 and K3 at a shard's shape (B, the
    whole T, ``Hq`` query heads on ``KVH`` kv heads of ``Dq``, bf16) with
    the ALiBi slopes of the model's heads ``heads`` = (lo, total), against
    their plain versions with the same slopes (K1 within the bf16 bar, K2/K3
    within one bf16 ulp + GRAD_ATOL); the plain versions handed the slopes
    of heads 0 .. Hq - 1 (the offset dropped) must miss the bars. With
    ``timed``, timed with SDPA as the yardstick: the kernel table's rows
    ``<kernel><suffix>`` (else no rows)."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import flash

    dtype = torch.bfloat16
    slopes, wrong = shard_slopes(heads, Hq, True)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, h, Dq, generator=g, device="cuda").to(dtype) for h in (Hq, KVH, KVH, Hq))
    scale = 1.0 / Dq**0.5
    kw = dict(causal=True, alibi=True, scale=scale, slopes=slopes)
    tag = label or suffix.strip("_")

    def fwd():
        return flash._launch_fwd(q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None, scale=scale,
                                 want_lse=True, counter=flash.TRAIN_KERNEL, slopes=slopes)

    o, lse = fwd()
    ref_o, _ = flash.flash_reference(q, k, v, causal=True, alibi=True, slopes=slopes)
    fwd_err = compare(o, ref_o, dtype, f"{tag} K1")
    del ref_o
    fwd_control = reject_unsliced(o, lambda sl: flash.flash_reference(q, k, v, causal=True, alibi=True,
                                                                      slopes=sl)[0], wrong, f"{tag} K1")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = (flash.launch_dq(q, k, v, do, lse, delta, **kw), *flash.launch_dkv(q, k, v, do, lse, delta, **kw))
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    ref = flash.flash_bwd_reference(qf, kf, vf, of, lse, dof, causal=True, alibi=True, slopes=slopes)
    misses = [grad_miss(a, b) for a, b in zip(got, ref)]
    if max(misses) > 1.0:
        raise AssertionError(f"{tag} K2/K3: dq/dk/dv at {misses} of their bars")
    errs = [float((a.float() - b).abs().max()) for a, b in zip(got, ref)]
    del ref
    off = flash.flash_bwd_reference(qf, kf, vf, of, lse, dof, causal=True, alibi=True, slopes=wrong)
    wrong_misses = [grad_miss(a, b) for a, b in zip(got, off)]
    if max(wrong_misses) <= 1.0:
        raise AssertionError(f"{tag} K2/K3: the slopes of heads 0-{Hq - 1} pass the bars ({wrong_misses})")
    del off, qf, kf, vf, of, dof
    torch.cuda.empty_cache()
    if not timed:
        log({f"{tag}_unsliced_slopes": {"k1_err": fwd_control, "k2_k3_over_bar": wrong_misses, "bars": misses,
                                         "k1_max_err": fwd_err, "grads_max_err": errs}})
        return {}
    kern = {"flash_train_fwd": fwd,
            "flash_dq": lambda: flash.launch_dq(q, k, v, do, lse, delta, **kw),
            "flash_dkv": lambda: flash.launch_dkv(q, k, v, do, lse, delta, **kw)}
    plain_fwd = time_ms(lambda: flash.flash_reference(q, k, v, causal=True, alibi=True, slopes=slopes), iters=3)
    plain_bwd = time_ms(lambda: flash.flash_bwd_reference(q, k, v, o, lse, do, causal=True, alibi=True,
                                                          slopes=slopes), iters=3)
    bias = sdpa_bias(B, T, T, [0] * B, torch.ones(B, T, dtype=torch.int32, device="cuda"), dtype, Hq, slopes=slopes)
    qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (q, k, v))
    lib_kw = dict(attn_mask=bias, enable_gqa=Hq != KVH)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw), iters=10)
    # the library backward computes dq, dk and dv together: one time for K2 and K3
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
                      iters=10)
    bounds = train_bounds(B, T, Hq, KVH, Dq, dtype, True)
    rows = {}
    for name, fn in kern.items():
        err = fwd_err if name == "flash_train_fwd" else (errs[0] if name == "flash_dq" else max(errs[1:]))
        bound, by = bounds[name]
        rows[name + suffix] = dict(max_abs_err=err, ms=time_ms(fn, iters=10), device_ms=device_ms(fn, iters=10),
                                   plain_ms=plain_fwd if name == "flash_train_fwd" else plain_bwd,
                                   library_ms=lib_fwd if name == "flash_train_fwd" else lib_bwd,
                                   bound_ms=bound, bound_by=by)
        log({"kernel": name + suffix, "shape": [B, T, Hq, KVH, Dq], "heads": list(heads), **rows[name + suffix]})
    log({f"{tag}_unsliced_slopes": {"k1_err": fwd_control, "k2_k3_over_bar": wrong_misses, "bars": misses}})
    del lib_out, qt, kt, vt, bias
    torch.cuda.empty_cache()
    return rows


def trainer_cli_580m(launcher: list, sets: list, run_dir: Path):
    """3 steps of configs/train_580m_8k.yaml through the trainer CLI
    (``launcher`` the interpreter arguments before ``--cfg``); fails unless
    it exits 0 and logs 3 finite losses. Returns its last step's readings
    and the finished process. The two calls run at once on one card, so
    the step readings are named ``contended_*``: they are neither the
    ring's nor one card's own step time, tokens/s or model-FLOPs share."""
    import os

    if (run_dir / "metrics.jsonl").exists():
        (run_dir / "metrics.jsonl").unlink()
    cmd = [sys.executable, *launcher, "--cfg", "configs/train_580m_8k.yaml", "--max-steps", "3", "--set", *sets,
           f"checkpoint.directory={run_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"trainer CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "loss" in r]
    if len(train) != 3 or not all(math.isfinite(r["loss"]) for r in train):
        raise AssertionError(f"trainer CLI metrics incomplete or non-finite: {records}")
    last = train[-1]
    return {"wall_s": wall, "losses": [r["loss"] for r in train], "contended_step_time_ms": last["step_time_ms"],
            "contended_tokens_per_sec": last["tokens_per_sec"],
            "contended_model_flops_share": last.get("model_flops_share")}, proc


# ------------------------------------------------------- data parallelism

DP_RANKS, DP_B, DP_STEPS = 4, 8, 3  # 4 ranks x B 8 x T 1024: a global batch of 32 rows
DP_LR = 6e-4  # configs/train_125m.yaml's peak learning rate, held constant
GRAD_NORM_RTOL = 1e-3
DP_TIMED_STEPS = 3  # steps timed after the parity steps (data_parallel_nccl only)
# 125m at full width with its depth cut 12 -> 2: the phase checks the ZeRO
# stages, checkpoints and the CLI, none of which depends on the depth
DP_LAYERS = 2
N_DP = 52_793_088  # 125m's params at DP_LAYERS layers


def dp_overrides(run_dir: Path, stage: int, accum: int = 1, **more) -> dict:
    """configs/train_125m.yaml cut for the phase: ``DP_LAYERS`` layers, a
    global batch of 32 rows a step (B 8 a rank at accum 1, B 4 at accum 2),
    synthetic tokens, a constant learning rate, a log line each step, saves
    at step 2 (keep 2) and at the end."""
    return {"model.n_layers": DP_LAYERS, "data.source": "synthetic", "training.batch_size": DP_RANKS * DP_B // accum,
            "training.gradient_accumulation_steps": accum, "training.log_frequency": 1,
            "training.evaluation_frequency": 0, "optimizer.schedule": "constant",
            "optimizer.peak_learning_rate": DP_LR, "mesh.zero_stage": stage,
            "checkpoint.directory": str(run_dir), "checkpoint.save_frequency": 2, "checkpoint.keep": 2, **more}


def dp_trainer(overrides: dict, mesh=None):
    from zero_transformer_tpu_torch.config import apply_dotted_overrides, load_config
    from zero_transformer_tpu_torch.training.trainer import Trainer

    cfg = apply_dotted_overrides(load_config("configs/train_125m.yaml"), overrides)
    return Trainer(cfg, device="cuda", mesh=mesh)


def dp_drive(trainer, steps: int, save: bool) -> dict:
    """``steps`` optimizer steps with the launch counts zeroed just before and
    read just after: with ``save`` through ``trainer.train`` (its saves on
    the cadence and at the end; rank 0 reads the losses and grad norms it
    logged), else through the trainer's own step on its loader's batches,
    which writes no checkpoint (the phase stays within the machine's disk
    budget). Per-step readings are keyed by the step as a string (the
    ranks send JSON)."""
    from zero_transformer_tpu_torch.data import to_device
    from zero_transformer_tpu_torch.ops import _build

    start = trainer.state.step
    losses, norms = {}, {}
    _build.reset_launches()
    if save:
        trainer.train(max_steps=steps)
    else:
        it = iter(trainer.train_loader)
        try:
            for _ in range(steps):
                metrics = trainer.train_step(trainer.state, to_device(next(it), trainer.device))
                losses[str(trainer.state.step)] = float(metrics["loss"])
                norms[str(trainer.state.step)] = float(metrics["grad_norm"])
        finally:
            it.close()
    torch.cuda.synchronize(trainer.device)
    launches = {n: c for n, c in _build.LAUNCHES.items() if c}
    if save and trainer.mesh.rank == 0:
        records = [json.loads(x) for x in (Path(trainer.cfg.checkpoint.directory) / "metrics.jsonl").open()]
        train = {str(r["step"]): r for r in records if "loss" in r}
        losses = {k: r["loss"] for k, r in train.items()}
        norms = {k: r["grad_norm"] for k, r in train.items()}
    return {"start_step": start, "end_step": trainer.state.step, "launches": launches, "losses": losses,
            "grad_norms": norms}


def dp_readings(trainer, timed: int, profiled: bool = True) -> dict:
    """After the steps: the persistent state bytes, the whole params' digest
    (a collective at stage 3), the digest of the rank's replicated params
    (under a tensor group: the leaves no tensor rank splits), the replica
    audit, the latest save's times; then ``timed`` steps timed and, with
    ``profiled``, one step under the profiler (rank 0: the data and tensor
    groups' spans)."""
    from torch.profiler import ProfilerActivity, profile

    from zero_transformer_tpu_torch.data import to_device
    from zero_transformer_tpu_torch.parallel.zero import make_replica_audit
    from zero_transformer_tpu_torch.resilience.detect import leaf_checksum

    mesh, shards = trainer.mesh, trainer.state.shards
    dev = trainer.device
    out = {"rank": mesh.rank, "persistent_bytes": shards.persistent_bytes(),
           "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "save_ms": trainer.last_save_ms, "digest_ms": trainer.ckpt.last_digest_ms}
    leaves = shards.state_leaves()
    out["params_digest"] = sum(leaf_checksum(v) for k, v in leaves.items() if k.startswith("params/")) % 2**32
    del leaves
    with shards.gathered():
        out["replicated_digest"] = sum(leaf_checksum(p.detach()) for n, p in trainer.state.model.named_parameters()
                                       if shards.split_dim.get(n) is None) % 2**32
    audit = make_replica_audit(shards)  # whatever resilience.audit_frequency says
    out["audit_diverged"] = audit() if audit is not None else None
    it = iter(trainer.train_loader)
    try:
        if timed:
            mesh.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(timed):
                trainer.train_step(trainer.state, to_device(next(it), dev))
            torch.cuda.synchronize(dev)
            mesh.barrier()
            out["timed_step_ms"] = (time.perf_counter() - t0) * 1e3 / timed
            out["tokens_per_sec"] = trainer.tokens_per_step * timed / (time.perf_counter() - t0)
        if not profiled:
            return out
        batch = to_device(next(it), dev)
        mesh.barrier()
        if mesh.rank == 0:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.train_step(trainer.state, batch)
                torch.cuda.synchronize(dev)
                wall_ms = (time.perf_counter() - t0) * 1e3
            spans = {ev.key: ev.cpu_time_total / 1e3 for ev in prof.key_averages()
                     if ev.key.startswith(("data_group.", "tensor_group.")) and str(ev.device_type).endswith("CPU")}
            kernels = kernel_times(prof)
            busy = sum(ms for ms, _ in kernels.values())
            nccl_ms = sum(ms for name, (ms, _) in kernels.items() if "nccl" in name.lower())
            out["profile"] = {"wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
                              "nccl_kernels_ms": nccl_ms, **{f"{k}_ms": v for k, v in spans.items()},
                              **{f"{k}_share": v / wall_ms for k, v in spans.items()}}
        else:
            trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize(dev)
    finally:
        it.close()
    return out


def _dp_rank(rank: int, world: int, backend: str, init_file: str, out_dir: str, jobs: list) -> None:
    """One rank of a data-parallel world: for each job, the trainer on the
    world's mesh, or on the ``data x tensor x sequence`` mesh ``jobs[i]["mesh"]``
    made in the same world (``jobs[i]["overrides"]``; rank 0 first links the
    step directories a resume starts from), ``dp_drive``, then
    ``dp_readings``."""
    from zero_transformer_tpu_torch.parallel.mesh import destroy, init_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = init_distributed(1, backend, "cuda", data=world, rank=rank, world_size=world,
                            init_method=f"file://{init_file}", local_rank=rank)
    results = {}
    for job in jobs:
        if rank == 0:
            for src, dst in job.get("copy", ()):
                shutil.rmtree(dst, ignore_errors=True)
                Path(dst).mkdir(parents=True)
                shutil.copytree(src, Path(dst) / Path(src).name, copy_function=os.link)
        mesh.barrier()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        trainer = dp_trainer(job["overrides"], make_mesh(*job["mesh"], backend, mesh.device) if "mesh" in job
                             else mesh)
        try:
            line = dp_drive(trainer, job["steps"], job.get("save", False))
            line.update(dp_readings(trainer, job.get("timed", 0), job.get("profiled", True)))  # takes more steps
            if trainer._restore_report is not None:
                line["restore_verify_ms"] = trainer._restore_report.verify_ms
        finally:
            trainer.close()
        results[job["name"]] = line
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(results))
    mesh.barrier()
    destroy(mesh)


def run_ranks(fn, world: int, backend: str, out: Path, *args, what: str) -> list:
    """``fn(rank, world, backend, init_file, out, *args)`` on ``world``
    spawned ranks, each writing ``out/rank<r>.json``; joined under a 900 s
    deadline (a rank that fails or hangs fails the phase, and no rank
    outlives it). Returns each rank's results."""
    import torch.multiprocessing as mp

    init_file = out / f"rendezvous{world}"
    if init_file.exists():
        init_file.unlink()
    ctx = mp.start_processes(fn, args=(world, backend, str(init_file.resolve()), str(out), *args),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + 900
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):  # one rank at a time
            if time.monotonic() >= end:
                raise AssertionError(f"the {world} {what} ranks did not finish within 900 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def dp_world(world: int, backend: str, out: Path, jobs: list) -> list:
    """Run ``jobs`` on ``world`` ranks (``_dp_rank``); each rank's results."""
    return run_ranks(_dp_rank, world, backend, out, jobs, what="data-parallel")


def one_card_reference(out: Path, accum: int, timed: int, **more) -> dict:
    """The one-card trainer on the same global batches: 3 steps' losses and
    grad norms (and, with ``timed``, the step time); ``more``: config
    overrides."""
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    trainer = dp_trainer(dp_overrides(out, 2, accum, **more))
    try:
        line = dp_drive(trainer, DP_STEPS, save=False)
        line.update(dp_readings(trainer, timed))
    finally:
        trainer.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return line


def check_dp_stage(name: str, ranks: list, ref: dict, stage: int, accum: int) -> dict:
    """The fatal checks of one stage's run against the one-card run: each
    step's loss within LOSS_MARGIN, the grad norm within GRAD_NORM_RTOL,
    the params bit-equal across the ranks (digests; the replica audit sees
    no divergence), each rank's persistent bytes equal to the formula for
    ``N_DP`` params, exactly ``DP_LAYERS`` x accum launches of each training kernel
    a rank a step."""
    first = ranks[0][name]
    summary = {"losses": first["losses"], "one_card_losses": ref["losses"], "grad_norms": first["grad_norms"],
               "one_card_grad_norms": ref["grad_norms"], "loss_margin": LOSS_MARGIN,
               "persistent_bytes_per_rank": [r[name]["persistent_bytes"] for r in ranks],
               "peak_memory_gib_per_rank": [r[name]["peak_memory_gib"] for r in ranks],
               "save_ms_rank0": first["save_ms"], "digest_ms_rank0": first["digest_ms"],
               "profile_rank0": first.get("profile"), "launches_rank0": first["launches"]}
    for k in ("timed_step_ms", "tokens_per_sec"):
        if k in first:
            summary[k] = first[k]
    for step, loss in first["losses"].items():
        if not abs(loss - ref["losses"][step]) <= LOSS_MARGIN:
            raise AssertionError(f"{name} step {step}: loss {loss} vs one card {ref['losses'][step]}")
        norm, want = first["grad_norms"][step], ref["grad_norms"][step]
        if not abs(norm - want) <= GRAD_NORM_RTOL * abs(want):
            raise AssertionError(f"{name} step {step}: grad norm {norm} vs one card {want}")
    if len({r[name]["params_digest"] for r in ranks}) != 1 or any(r[name]["audit_diverged"] for r in ranks):
        raise AssertionError(f"{name}: params differ across the ranks: "
                             f"{[(r[name]['params_digest'], r[name]['audit_diverged']) for r in ranks]}")
    world = len(ranks)
    params = N_DP if stage < 3 else N_DP // world
    moments = 2 * (N_DP if stage == 0 else N_DP // world)
    want_bytes = 4 * (params + moments)
    if any(r[name]["persistent_bytes"] != want_bytes for r in ranks):
        raise AssertionError(f"{name}: persistent bytes {summary['persistent_bytes_per_rank']}, want {want_bytes}")
    steps = first["end_step"] - first["start_step"]
    want = {n: DP_LAYERS * accum * steps for n in ("flash_train_fwd", "flash_dq", "flash_dkv")}
    for r in ranks:
        if {n: r[name]["launches"].get(n, 0) for n in want} != want:
            raise AssertionError(f"{name} rank {r[name]['rank']} launches {r[name]['launches']}, want {want}")
    summary["persistent_bytes_formula"] = want_bytes
    return summary


def data_parallel_phase(backend: str = "gloo", tensor_training: bool = False) -> dict:
    """125m at full width, its depth cut to ``DP_LAYERS``, over 4
    data-parallel ranks, bf16 over float32 master params, AdamW, T 1024, a
    global batch of 32 rows a step, synthetic tokens, seed-0 weights (configs/train_125m.yaml cut as
    ``dp_overrides`` says). ``gloo``: the 4 ranks share card 0 (a
    correctness rig: the collectives stage through pinned host memory);
    ``nccl`` (the ``data_parallel_nccl`` phase, 4 cards): a card per rank.

    Fatal: for ZeRO stages 0-3 at accum 1, and stage 2 at accum 2, 3 steps
    each through the trainer against the one-card trainer on the same
    global batches (``check_dp_stage``). Printed: the ranks' peak memory
    and the data group's spans in a profiled step. Then, with gloo, the
    checkpoints: the stage-2 run saved at step 2; resumed from it at data 4
    its step 3 ends with the uninterrupted run's param digest (bit-equal);
    resumed at data 2 (stage 3, a world of 2) and on one process its step-3
    loss is within LOSS_MARGIN of the uninterrupted run's; a copy with one
    flipped byte in step 3's ``params.safetensors`` is quarantined and
    restore falls back to step 2; then the trainer CLI under
    ``torch.distributed.run --nproc-per-node 4`` saves after 3 steps and a
    second launch with ``checkpoint.resume=True`` continues from it.
    Returns the one-card and 4-rank launch counts of the stage-2 run.
    ``tensor_training``: the same world runs the tensor_training phase's
    part (a) after the stages (``tt_dp_jobs``), checked here against the
    same one-card runs and an Adafactor one (``check_tt_dp``)."""
    from zero_transformer_tpu_torch.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = backend == "nccl"
    if nccl and torch.cuda.device_count() < DP_RANKS:
        raise AssertionError(f"data_parallel_nccl needs {DP_RANKS} cards, this machine has "
                             f"{torch.cuda.device_count()}")
    tag = "data_parallel_nccl" if nccl else "data_parallel"
    out = (Path("build") / tag).resolve()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    timed = DP_TIMED_STEPS if nccl else 0
    log({f"{tag}_topology": {"ranks": DP_RANKS, "backend": backend,
                             "cards": min(torch.cuda.device_count(), DP_RANKS),
                             "transfers": "NCCL, card to card" if nccl else "gloo through pinned host memory"}})
    t0 = time.perf_counter()
    refs = {accum: one_card_reference(out / f"one_card_accum{accum}", accum, timed) for accum in (1, 2)}
    if tensor_training:
        refs["adafactor"] = one_card_reference(out / "one_card_adafactor", 1, 0,
                                               **{"optimizer.optimizer": "adafactor"})
    log({f"{tag}_one_card": {str(a): {k: r.get(k) for k in ("losses", "grad_norms", "peak_memory_gib",
                                                        "timed_step_ms", "tokens_per_sec", "persistent_bytes")}
                             for a, r in refs.items()}, "one_card_s": time.perf_counter() - t0})

    cases = {f"stage{s}": (s, 1) for s in (0, 1, 2, 3)}
    cases["stage2_accum2"] = (2, 2)
    # with gloo the stage-2 run goes through trainer.train, saving at steps 2 and 3
    jobs = [dict(name=name, steps=DP_STEPS, timed=timed, save=name == "stage2" and not nccl,
                 overrides=dp_overrides(out / name, stage, accum)) for name, (stage, accum) in cases.items()]
    saved = out / "stage2"
    if not nccl:  # resume from the stage-2 run's step 2, at data 4
        jobs.append(dict(name="resume_data4", steps=1, save=True,
                         copy=[(str(saved / "2"), str(out / "resume_data4"))],
                         overrides=dp_overrides(out / "resume_data4", 2, **{"checkpoint.resume": True})))
    if tensor_training:
        jobs += tt_dp_jobs(out)
    t0 = time.perf_counter()
    ranks = dp_world(DP_RANKS, backend, out, jobs)
    ranks_s = time.perf_counter() - t0
    for name, (stage, accum) in cases.items():
        log({f"{tag}_{name}": check_dp_stage(name, ranks, refs[accum], stage, accum)})
    log({f"{tag}_ranks_s": ranks_s})
    if tensor_training:
        TT_STASH["a"] = check_tt_dp(ranks, refs, out, [ranks[0][f"stage{s}"]["persistent_bytes"] for s in range(4)])
        TT_STASH["a"]["backend"] = backend
    launches = {"one_card": {}, "ranks": ranks[0]["stage2"]["launches"]}
    if nccl:
        log({f"{tag}_tokens_per_sec": {name: [ranks[0][name]["tokens_per_sec"], refs[cases[name][1]]["tokens_per_sec"]]
                                       for name in cases}, "order": "4 cards, one card"})
        log({f"{tag}_s": time.perf_counter() - t_phase})
        return launches

    # checkpoints: the stage-2 run saved at steps 2 and 3
    uninterrupted = ranks[0]["stage2"]
    resumed = ranks[0]["resume_data4"]
    ckpt_line = {"uninterrupted_digest": uninterrupted["params_digest"], "resumed_data4_digest":
                 resumed["params_digest"], "resumed_data4_start": resumed["start_step"],
                 "resumed_data4_loss": resumed["losses"].get("3"), "restore_verify_ms_rank0":
                 resumed.get("restore_verify_ms"), "save_ms_rank0": uninterrupted["save_ms"],
                 "digest_ms_rank0": uninterrupted["digest_ms"]}
    if resumed["start_step"] != 2 or resumed["params_digest"] != uninterrupted["params_digest"]:
        raise AssertionError(f"resume at data 4 from step 2 is not bit-equal to the uninterrupted run: {ckpt_line}")
    # data 2 at stage 3: a world of 2
    t0 = time.perf_counter()
    two = dp_world(2, backend, out, [dict(name="resume_data2_stage3", steps=1, save=True,
                                          copy=[(str(saved / "2"), str(out / "resume_data2"))],
                                          overrides=dp_overrides(out / "resume_data2", 3, **{
                                              "checkpoint.resume": True}))])
    want_loss = uninterrupted["losses"]["3"]
    d2 = two[0]["resume_data2_stage3"]
    ckpt_line.update(resumed_data2_loss=d2["losses"].get("3"), resumed_data2_s=time.perf_counter() - t0,
                     uninterrupted_loss=want_loss)
    if not (d2["start_step"] == 2 and abs(d2["losses"]["3"] - want_loss) <= LOSS_MARGIN):
        raise AssertionError(f"resume at data 2 (stage 3): {ckpt_line}")
    # one process
    one_dir = out / "resume_one"
    one_dir.mkdir()
    shutil.copytree(saved / "2", one_dir / "2", copy_function=os.link)
    trainer = dp_trainer(dp_overrides(one_dir, 2, **{"checkpoint.resume": True}))
    try:
        start = trainer.state.step
        trainer.train(max_steps=1)
        records = [json.loads(x) for x in (one_dir / "metrics.jsonl").open()]
        one_loss = next(r["loss"] for r in records if r.get("step") == 3 and "loss" in r)
        ckpt_line.update(resumed_one_process_loss=one_loss,
                         resumed_one_process_verify_ms=trainer._restore_report.verify_ms)
        if not (start == 2 and abs(one_loss - want_loss) <= LOSS_MARGIN):
            raise AssertionError(f"resume on one process: {ckpt_line}")
        # a flipped byte in step 3's params: quarantined, restore falls back to step 2
        bad = out / "bitflip"
        shutil.copytree(saved, bad, copy_function=os.link)
        path = bad / "3" / "params.safetensors"
        data = bytearray(path.read_bytes())
        header = 8 + int.from_bytes(data[:8], "little")
        data[header + (len(data) - header) // 3] ^= 0x01
        path.unlink()  # a link to the saved run's file: write a new one
        path.write_bytes(bytes(data))
        _, _, report = CheckpointManager(bad).restore_verified(trainer.state.shards.target(), device="cuda")
        ckpt_line.update(bitflip_restored_step=report.step, bitflip_quarantined=report.quarantined,
                         bitflip_verify_ms=report.verify_ms)
        if report.step != 2 or report.quarantined != [3] or not (bad / "3.quarantined").is_dir():
            raise AssertionError(f"the flipped step was not quarantined with fallback: {ckpt_line}")
    finally:
        trainer.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log({"data_parallel_checkpoints": ckpt_line})

    # the trainer CLI under torch.distributed.run: 3 steps and a save, then a resumed launch
    cli_dir = out / "cli"
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(DP_RANKS),
              "-m", "zero_transformer_tpu_torch.train", "--cfg", "configs/train_125m.yaml", "--dist-backend",
              backend, "--set", f"mesh.data={DP_RANKS}", f"training.batch_size={DP_RANKS * DP_B}",
              f"model.n_layers={DP_LAYERS}",
              "data.source=synthetic", "training.log_frequency=1", "training.evaluation_frequency=0",
              f"checkpoint.directory={cli_dir}"]
    cli = {}
    for label, extra in (("first", ["--max-steps", "3"]), ("resumed", ["--max-steps", "2", "--set",
                                                                       "checkpoint.resume=True"])):
        t0 = time.perf_counter()
        proc = subprocess.run(launch + extra, capture_output=True, text=True, timeout=600,
                              env={**os.environ, "OMP_NUM_THREADS": "2"})
        if proc.returncode != 0:
            raise AssertionError(f"data-parallel trainer CLI ({label}) exit {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        cli[label] = {"wall_s": time.perf_counter() - t0,
                      "resumed": next((json.loads(x)["resumed"] for x in proc.stdout.splitlines()
                                       if x.startswith('{"resumed"')), None)}
    records = [json.loads(x) for x in (cli_dir / "metrics.jsonl").open()]
    train = [r for r in records if "loss" in r]
    steps = sorted(p.name for p in cli_dir.iterdir() if p.is_dir())
    cli.update(steps_logged=[r["step"] for r in train], step_dirs=steps,
               losses=[r["loss"] for r in train], tokens_per_sec=train[-1]["tokens_per_sec"],
               step_time_ms=train[-1]["step_time_ms"], ckpt_save_ms=train[-1].get("ckpt_save_ms"))
    log({"data_parallel_trainer_cli": cli})
    if (cli["resumed"]["resumed"] is None or cli["resumed"]["resumed"]["step"] != 3
            or cli["steps_logged"] != [1, 2, 3, 4, 5] or steps != ["3", "5"]
            or not all(math.isfinite(x) for x in cli["losses"])):
        raise AssertionError(f"the data-parallel trainer CLI did not save and resume: {cli}")
    log({f"{tag}_s": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------- the Llama block: llama3_8b

LLAMA = "llama3_8b"
# llama3_8b's attention: 32 query heads on 8 kv heads of 128, context 8192
LH, LKVH, LD, LCACHE = 32, 8, 128, 8192
LLAMA_N = 8_030_261_248
LLAMA_TRAIN_LAYERS, LLAMA_TRAIN_N = 4, 1_923_125_248  # the training cut: 32 -> 4 layers
LLAMA_T, LLAMA_CHUNK, LLAMA_PARITY_T = 8192, 1024, 2048
# llama_serving's decode profiles: 5 ticks, not the 125m phase's 20 (their
# trace of ~2,400 kernels a tick took 42 of the phase's 159 s on one card;
# the per-tick readings are those of a whole 32-layer tick either way)
LLAMA_PROFILE_TICKS = 3  # ticks each llama3_8b decode profile traces (few: the run has a time limit)
# llama3_8b's parity against the plain path at full width, depth 32 -> 8:
# its float32 models (32 GB each at full depth, five builds over the two
# parity runs) were most of the phase; the HTTP runs and profiles stay at 32
LLAMA_PARITY_LAYERS = 8
LLAMA_SERVE_OFFSETS = [0, 1000, 4096, 8128]  # K1's 64-token prefill windows across the cache
LLAMA_DECODE_OFFSETS = [3, 1000, 4097, 8191]  # K4's decode positions (at 3 one key is 1/4 of the row)
# (label, B, T, H, KVH, D, dtype, causal, alibi): the training shape and an f32 case
LLAMA_TRAIN_CASES = [
    ("llama_train", 1, LLAMA_T, LH, LKVH, LD, torch.bfloat16, True, False),
    ("llama_train_f32", 1, 1024, LH, LKVH, LD, torch.float32, True, False),
]
LLAMA_TRAIN_TIMED = {"llama_train": "_llama"}
# the ring's shards of T 8192 over 4 ranks (2048 keys), without ALiBi, GQA 4
LLAMA_SP_CASES = [
    ("llama_ring", 1, 2048, LH, LKVH, LD, torch.bfloat16, False),
    ("llama_ring_f32", 1, 512, LH, LKVH, LD, torch.float32, False),
]
LLAMA_SP_TIMED = {"llama_ring": "_llama"}
REMAT_POLICIES = ("none", "dots", "qkv_mlp")


def llama_k4_case(label, dtype, int8, rows):
    """K4 at llama3_8b's decode shape (B 4, T 1, 32 on 8 kv heads of 128,
    page 16, cache 8192), bf16/f32 pools or int8 pools with scales, against
    its plain version; the bf16 bar must reject a plain version that sees
    one key fewer (and, int8, one that reads the next position's or kv
    head's scale). The bf16 cases are timed into ``rows``."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import paged_attention as pa

    B, T, offs_l = SLOTS, 1, LLAMA_DECODE_OFFSETS
    seed = len(label) + 600
    if int8:
        q, kq, vq, ks, vs, table, offs = int8_paged_case(B, T, LH, LKVH, LD, dtype, offs_l, seed, cache=LCACHE)
        pools, scales = (kq, vq, ks, vs), dict(k_scale=ks, v_scale=vs)
    else:
        q, kp, vp, table, offs = paged_case(B, T, LCACHE // PAGE, LKVH, dtype, offs_l, seed, Hq=LH, Dh=LD)
        pools, scales = (kp, vp), {}
    kw = dict(causal=False, alibi=False)

    def call(k_, v_, ks_=None, vs_=None):
        return pa.paged_attention(q, k_, v_, table, offs, k_scale=ks_, v_scale=vs_, **kw)

    got = call(*pools)
    ref = pa.paged_reference(q, *pools[:2], table, offs, **scales, **kw)
    torch.cuda.synchronize()
    name = "paged_attention_int8" if int8 else "paged_attention"
    err = compare(got, ref, dtype, f"paged {label}")
    line = {"kernel": name, "case": label, "dtype": str(dtype), "shape": [B, T, LH, LKVH, LD], "cache": LCACHE,
            "alibi": False, "max_err": err}
    if dtype == torch.bfloat16:
        controls = {"one_key_fewer": pa.paged_reference(q, *pools[:2], table, offs - 1, **scales, **kw)}
        if int8:
            for what in ("next_position", "next_kv_head"):
                controls[f"{what}_scale"] = pa.paged_reference(
                    q, kq, vq, table, offs, k_scale=shift_scales(ks, what), v_scale=shift_scales(vs, what), **kw)
        for what, bad in controls.items():
            if within(got, bad, dtype):
                raise AssertionError(f"paged {label}: the {what} control passes the bar")
            line[f"{what}_control_max_err"] = float((got.float() - bad.float()).nan_to_num().abs().max())
        check_deterministic_fwd(lambda: (call(*pools),), f"K4 {label}", kernel="k4_o")
    log(line)
    if dtype != torch.bfloat16:
        return
    row_bytes = LD + 4 if int8 else 2 * LD
    kern = time_ms(lambda: call(*pools))
    dev = device_ms(lambda: call(*pools))
    cold, copies = cold_device_ms(call, pools, k4_touched_bytes(offs_l, T, LKVH, row_bytes, LCACHE))
    plain = time_ms(lambda: pa.paged_reference(q, *pools[:2], table, offs, **scales, **kw))
    valid = (torch.arange(LCACHE, device="cuda")[None, :] < offs[:, None] + T).int()
    bias = sdpa_bias(B, T, LCACHE, offs_l, valid, dtype, LH, alibi=False)

    def library():  # gather (and dequantize) the pages, then SDPA over the kv heads' groups
        if int8:
            kk = pa.dequantize(pa.gather_pages(kq, table), pa.gather_pages(ks, table), dtype)
            vv = pa.dequantize(pa.gather_pages(vq, table), pa.gather_pages(vs, table), dtype)
        else:
            kk, vv = pa.gather_pages(kp, table), pa.gather_pages(vp, table)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                                              attn_mask=bias, enable_gqa=True)

    lib = time_ms(library)
    if int8:
        bound, by = int8_paged_bound(B, T, offs_l, LH, LKVH, LD, dtype, LCACHE)
    else:
        bound, by = paged_bound(B, T, offs_l, LKVH, dtype, LH, LD, LCACHE)
    rows[name + "_llama"] = dict(max_abs_err=err, ms=kern, device_ms=dev, device_ms_cold=cold, cold_copies=copies,
                                 plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
    log({"kernel": name + "_llama", "shape": [B, T, LH, LKVH, LD], "offsets": offs_l, **rows[name + "_llama"]})


def llama_k1_serving_case(label, dtype, rows):
    """K1's serving entry at llama3_8b's prefill chunk (B 4, T 64 over the
    8192-key cache, 32 on 8 kv heads of 128, ALiBi off) against its plain
    version; bf16 also against the emulation of its rounding, whose causal
    and validity controls must miss, and timed into ``rows``."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import flash

    B, T, S, offs_l = SLOTS, CHUNK, LCACHE, LLAMA_SERVE_OFFSETS
    q, k, v, offs, seg = flash_case(B, T, S, LKVH, dtype, offs_l, [o + T for o in offs_l], seed=len(label) + 700,
                                    Hq=LH, Dh=LD)
    kw = dict(causal=True, alibi=False, q_offset=offs, segment_ids=seg)
    got, lse = flash.flash_serving(q, k, v, return_lse=True, **kw)
    ref, ref_lse = flash.flash_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    err = compare(got, ref, dtype, f"flash {label}")
    compare(lse, ref_lse, torch.float32 if dtype == torch.float32 else dtype, f"flash lse {label}")
    line = {"kernel": "flash_serving_fwd", "case": label, "dtype": str(dtype), "shape": [B, T, S, LH, LKVH, LD],
            "alibi": False, "max_err": err}
    if dtype == torch.bfloat16:
        line["mma"] = check_mma(got, lse, q, k, v, offs, seg, label, shifted=True, alibi=False,
                                tensor_core=TC_BITS)
        check_deterministic_fwd(lambda: flash.flash_serving(q, k, v, return_lse=True, **kw), f"serving {label}")
    log(line)
    if dtype != torch.bfloat16:
        return
    bias = sdpa_bias(B, T, S, offs_l, seg, dtype, LH, alibi=False)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound, by = flash_bound(B, T, offs_l, LKVH, dtype, LH, LD, LCACHE)
    rows["flash_serving_fwd_llama"] = dict(
        max_abs_err=err, ms=time_ms(lambda: flash.flash_serving(q, k, v, **kw)),
        device_ms=device_ms(lambda: flash.flash_serving(q, k, v, **kw)),
        plain_ms=time_ms(lambda: flash.flash_reference(q, k, v, **kw)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias, enable_gqa=True)),
        bound_ms=bound, bound_by=by)
    log({"kernel": "flash_serving_fwd_llama", **rows["flash_serving_fwd_llama"]})


def tc_fit_phase():
    """(Opt-in.) Which model of the tensor cores' adder K1's bf16 output
    follows: the share of llama3_8b's serving-chunk outputs (ALiBi off)
    and of 125m's (ALiBi) that differ from each emulation at all, and the
    largest difference over the bar, for exact sums rounded once and for
    ``tc_accumulate`` at 24-27 bits (TC_BITS is the fit)."""
    from zero_transformer_tpu_torch.ops import flash

    shapes = {"llama3_8b_serving_chunk": (LLAMA_SERVE_OFFSETS, LCACHE, LKVH, LH, LD, False, len("llama_main") + 700),
              "125m_serving_chunk": ([0, 256, 512, 896], CACHE, H, H, D, True, len("main"))}
    out = {}
    for name, (offs_l, S, KVH, Hq, Dh, alibi, seed) in shapes.items():
        q, k, v, offs, seg = flash_case(SLOTS, CHUNK, S, KVH, torch.bfloat16, offs_l, [o + CHUNK for o in offs_l],
                                        seed=seed, Hq=Hq, Dh=Dh)
        got = flash.flash_serving(q, k, v, causal=True, alibi=alibi, q_offset=offs, segment_ids=seg)
        out[name] = {}
        for model in (None, 24, 25, 26, 27):
            emu, _ = flash_mma_emulation(q, k, v, offs, seg, alibi=alibi, tensor_core=model)
            over, share = mma_miss(got, emu)
            out[name]["exact_sums" if model is None else f"tensor_core_{model}_bits"] = {
                "differ_share": share, "max_err_over_bar": over}
            del emu
            torch.cuda.empty_cache()
    log({"tc_fit": out})


def llama_kernel_phase():
    """K1-K4 at llama3_8b's shapes with ALiBi off and 4 query heads on each
    kv head of 128, against their plain versions under the kernel phases'
    bars: the serving chunk (``llama_k1_serving_case``), K4 decode over
    bf16, f32 and int8 pools (``llama_k4_case``), the training shape (B 1,
    T = S 8192, ``train_kernel_phase``'s bars and controls) and the ring's
    shards at T 8192 over 4 ranks (``sp_kernel_phase`` without ALiBi). Each
    call timed as the kernel table times it, with SDPA (``enable_gqa``) as
    the yardstick. Every check runs; the phase fails after them if any
    failed."""
    t_phase = time.perf_counter()
    rows, failed = {}, []
    checks = [(f"k1 {label}", functools.partial(llama_k1_serving_case, label, dtype, rows))
              for label, dtype in (("llama_main", torch.bfloat16), ("llama_f32", torch.float32))]
    checks += [(f"k4 {label}", functools.partial(llama_k4_case, label, dtype, int8, rows))
               for label, dtype, int8 in (("llama_decode", torch.bfloat16, False),
                                          ("llama_decode_f32", torch.float32, False),
                                          ("llama_decode_int8", torch.bfloat16, True),
                                          ("llama_decode_int8_f32", torch.float32, True))]
    checks += [("k1-k3 training", lambda: rows.update(train_kernel_phase(LLAMA_TRAIN_CASES, LLAMA_TRAIN_TIMED))),
               ("ring shards", lambda: rows.update(sp_kernel_phase(LLAMA_SP_CASES, LLAMA_SP_TIMED, alibi=False)))]
    for what, check in checks:
        try:
            check()
        except AssertionError as e:
            failed.append(what)
            log({"llama_kernels_failed": what, "error": str(e)})
        gc.collect()
        torch.cuda.empty_cache()
    log({"llama_kernels_s": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError(f"llama_kernels: {failed} failed")
    return rows


def llama_serving_phase():
    """llama3_8b at full width and depth (32 layers, seed-0 weights, bf16,
    paged KV: page 16, cache 8192, chunk 64, 4 slots) behind the HTTP
    server: the serving phase's six concurrent greedy requests, then its
    parity against the plain path at ``LLAMA_PARITY_LAYERS`` layers
    (``forced_logits``: float32 within atol 1e-4 with equal greedy tokens
    outside ties, every bf16 attention read at the bf16 bar) and a profiled
    decode at full depth; then all of
    it with int8 weights (the untied head and the gate included) and an int8
    cache. After the bf16 HTTP run, on the same model, the serving_policy
    phase's (b): a prefix-cache burst (``llama_policy_burst``). The decode
    profiles trace ``LLAMA_PROFILE_TICKS`` ticks. Returns the launches of
    both HTTP runs and logs each part's seconds."""
    t_phase = time.perf_counter()
    part_s = {}

    def timed(what, fn):
        t0 = time.perf_counter()
        out = fn()
        part_s[what] = time.perf_counter() - t0
        return out

    launches, _, bf16 = timed("serving", lambda: serving_phase(name=LLAMA, cache_len=LCACHE,
                                                                    label="llama_serving", after=llama_policy_burst))
    if bf16["layers"] != 32 or not (launches["flash_serving_fwd"] and launches["paged_attention"]):
        raise AssertionError(f"llama3_8b was not served at full depth through K1 and K4: {bf16}")
    timed("parity", lambda: parity_phase(None, name=LLAMA, cache_len=LCACHE, label="llama_parity", deep=True,
                                         layers=LLAMA_PARITY_LAYERS))
    timed("profile", lambda: profile_phase(LLAMA_PROFILE_TICKS, name=LLAMA, cache_len=LCACHE,
                                           label="llama_profile"))
    int8_launches, _, int8 = timed("int8_serving", lambda: serving_phase(
        int8=True, name=LLAMA, cache_len=LCACHE, label="llama_serving"))
    keys = ("ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50", "itl_ms_p99", "decode_tok_s", "kv_pool_bytes", "weight_bytes")
    log({"llama_int8_vs_bf16_serving": {k: [int8[k], bf16[k]] for k in keys}})
    timed("int8_parity", lambda: parity_phase(None, int8=True, name=LLAMA, cache_len=LCACHE,
                                              label="llama_parity", deep=True, layers=LLAMA_PARITY_LAYERS))
    timed("int8_profile", lambda: profile_phase(LLAMA_PROFILE_TICKS, int8=True, name=LLAMA, cache_len=LCACHE,
                                                label="llama_profile"))
    gc.collect()
    torch.cuda.empty_cache()
    log({"llama_serving_s": time.perf_counter() - t_phase, "llama_serving_part_s": part_s})
    return {"flash_serving_fwd_llama": launches["flash_serving_fwd"],
            "paged_attention_llama": launches["paged_attention"],
            "paged_attention_int8_llama": int8_launches["paged_attention_int8"]}


def llama_model(impl="auto", dtype=torch.bfloat16, policy="none", remat: bool = True, **over):
    """llama3_8b cut to LLAMA_TRAIN_LAYERS layers at full width, trainable,
    remat under ``policy`` (or none), the chunked loss, seed-0 weights."""
    from zero_transformer_tpu_torch.models import model_getter

    return model_getter(LLAMA, dtype=dtype, device="cuda", seed=SEED, trainable=True, attention_impl=impl,
                        n_layers=LLAMA_TRAIN_LAYERS, remat=remat, remat_policy=policy, loss_chunk=LLAMA_CHUNK,
                        **over)


def llama_predicted_peak(policy: str) -> dict:
    """The step's peak memory predicted from the code (bytes): the float32
    params 4N, AdamW's m and v 8N, the grads autograd returns 4N and their
    flat copy 4N (``parallel/zero.py``: the copy is made while the grads
    live; accum 1 has no accumulator), plus what the backward holds: each
    block's bf16 input (remat), the products ``policy`` saves in every
    layer, one block's recompute (its projections, the MLP's three d_ff
    tensors, the weights cast to bf16) and the head's bf16 weight with the
    final hidden states (the chunked loss keeps them)."""
    N, L, T, d, f = LLAMA_TRAIN_N, LLAMA_TRAIN_LAYERS, LLAMA_T, 4096, 14336
    kvd, V = LKVH * LD, 128256
    proj = {"q": T * d, "k": T * kvd, "v": T * kvd, "out": T * d, "wi": T * f, "gate": T * f, "wo": T * d}
    saved = {"none": 0, "dots": sum(proj.values()), "qkv_mlp": sum(proj[n] for n in ("q", "k", "v", "wi", "gate"))}
    block_weights = 2 * (2 * d * d + 2 * d * kvd + 3 * d * f)
    recompute = 2 * (sum(proj.values()) + 2 * T * f + 4 * T * d) + block_weights
    parts = {"state_20N": 20 * N, "block_inputs": 2 * L * T * d, "policy_saved": 2 * L * saved[policy],
             "one_block_recompute": recompute, "head_bf16_and_hidden": 2 * V * d + 2 * T * d}
    return {"bytes": sum(parts.values()), "parts": parts}


def llama_parity(tokens) -> dict:
    """One micro-batch of the 4-layer cut at T LLAMA_PARITY_T through the
    kernels (bf16) against the plain path in bf16 and float32
    (``train_parity``'s bars: the loss within LOSS_MARGIN, grad cosines at
    least COS_BAR), the cosines held to the bf16 plain path: at this shape
    the bf16 plain path's own q and k weight grads sit at 0.99825 of
    float32 (the kernel path's at 0.99827; H100 readings), attention being
    near uniform over 2048 keys. At T 8192 the plain path's float32 scores
    [1, 32, T, T] (8.6 GB a tensor, several kept per layer for the
    backward) would not fit beside the model."""
    over = dict(n_layers=LLAMA_TRAIN_LAYERS, remat=True, loss_chunk=LLAMA_CHUNK)
    parity = train_parity(LLAMA, tokens, cos_to="plain_bf16", **over)
    parity.pop("state")
    return {**parity, "T": tokens.shape[1], "layers": LLAMA_TRAIN_LAYERS}


def llama_cli(steps: int = 3) -> dict:
    """The trainer CLI on configs/train_125m.yaml with ``--set
    model.size=llama3_8b model.n_layers=4`` at B 1 x T 8192, remat and the
    chunked loss, in a process of its own that reports its peak memory.
    Cuts (printed): synthetic data, 143,000 -> ``steps`` steps, batch 256 ->
    1, train_context 1024 -> 8192, no eval, the anomaly response rollback ->
    skip_batch (its pinned host snapshot would be 23 GB), and no checkpoint
    (the process drops the trainer's saves: the save at the end would write
    23 GB)."""
    run_dir = Path("build") / "llama_training"
    shutil.rmtree(run_dir, ignore_errors=True)
    code = ("import json, sys, torch; from zero_transformer_tpu_torch import train; "
            "from zero_transformer_tpu_torch.training.trainer import Trainer; "
            "Trainer.save = lambda self, force=False: False; train.main(sys.argv[1:]); "
            "print(json.dumps({'cli_peak_memory_gib': torch.cuda.max_memory_allocated() / 2**30}))")
    sets = ["model.size=llama3_8b", f"model.n_layers={LLAMA_TRAIN_LAYERS}", "model.remat=True",
            f"model.loss_chunk={LLAMA_CHUNK}", "data.source=synthetic", f"data.max_context={LLAMA_T}",
            "training.batch_size=1", f"training.train_context={LLAMA_T}", "training.log_frequency=1",
            "training.evaluation_frequency=0", "resilience.anomaly_response='skip_batch'",
            f"checkpoint.directory={run_dir}"]
    log({"llama_cli_cuts": {"data.source": "memmap -> synthetic", "steps": f"143000 -> {steps}",
                            "training.batch_size": "256 -> 1", "training.train_context": f"1024 -> {LLAMA_T}",
                            "evaluation": "off", "resilience.anomaly_response": "rollback -> skip_batch",
                            "checkpoint": "no save (23 GB)", "model.n_layers": f"32 -> {LLAMA_TRAIN_LAYERS}"}})
    cmd = [sys.executable, "-c", code, "--cfg", "configs/train_125m.yaml", "--max-steps", str(steps), "--set", *sets]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"llama trainer CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        saved = [p.name for p in run_dir.iterdir() if p.is_dir()]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    train = [r for r in records if "loss" in r]
    if len(train) != steps or not all(math.isfinite(r["loss"]) for r in train) or saved:
        raise AssertionError(f"llama trainer CLI metrics incomplete or non-finite: {records}, saved {saved}")
    info = next(json.loads(line)["trainer"] for line in proc.stdout.splitlines() if line.startswith('{"trainer"'))
    peak = next(json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"cli_peak'))
    last = train[-1]
    if last.get("model_flops_share") is None or info["params"] != LLAMA_TRAIN_N:
        raise AssertionError(f"the llama trainer CLI reported {info['params']} params, share "
                             f"{last.get('model_flops_share')}")
    return {"wall_s": wall, "losses": [r["loss"] for r in train], "step_time_ms": last["step_time_ms"],
            "tokens_per_sec": last["tokens_per_sec"], "model_flops_share": last["model_flops_share"],
            "model_flops_formula": f"tokens/s * 3 * (2 * N + 4 * L * d * T) / 989e12, N = {LLAMA_TRAIN_N}, "
                                   f"L = {LLAMA_TRAIN_LAYERS}, d = 4096, T = {LLAMA_T}",
            "persistent_state_bytes": info["persistent_state_bytes"], **peak,
            "predicted_peak_gib": llama_predicted_peak("none")["bytes"] / 2**30}


def llama_training_phase(record: bool = False):
    """llama3_8b at full width, depth cut 32 -> 4 (1,923,125,248 params),
    bf16 over float32 master params, AdamW, B 1 x T 8192, remat, the
    chunked loss: (a) kernel/plain parity on one micro-batch
    (``llama_parity``); (b) one optimizer step under each remat policy:
    exactly 2L K1, L K2 and L K3 launches (the recompute runs K1 again under
    every policy), step ms and peak memory beside the prediction
    (``llama_predicted_peak``), and one micro-batch's forward and backward
    alone, its peak above the memory held before it (what the policy
    keeps); (c) the trainer CLI (``llama_cli``). Writes no checkpoint.
    Returns the launches of the policy "none" step. ``record``: the steps'
    batches, losses and grad norms, in order, go to ``TT_STASH["llama"]``
    (tensor_training's part (c) replays them over tensor 2)."""
    from zero_transformer_tpu_torch.config import OptimizerConfig
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(12)
    log({"llama_training_parity": llama_parity(torch.randint(0, 128256, (1, LLAMA_PARITY_T), generator=g,
                                                             device="cuda"))})
    gc.collect()
    torch.cuda.empty_cache()
    model = llama_model()
    if model.cfg.num_params != LLAMA_TRAIN_N:
        raise AssertionError(f"llama3_8b at {LLAMA_TRAIN_LAYERS} layers has {model.cfg.num_params} params")
    opt_cfg = OptimizerConfig(schedule="constant", peak_learning_rate=1e-4)
    schedule = make_schedule(opt_cfg)
    st = init_train_state(model, opt_cfg, schedule)
    step = make_train_step(1, schedule)

    steps = {"batches": [], "losses": [], "grad_norms": []}

    def batch():
        return torch.randint(0, 128256, (1, 1, LLAMA_T), generator=g, device="cuda", dtype=torch.int32)

    def run(b) -> float:
        if record:
            steps["batches"].append(b)
        m = step(st, b)
        steps["losses"].append(float(m["loss"]))
        steps["grad_norms"].append(float(m["grad_norm"]))
        return steps["losses"][-1]

    L = LLAMA_TRAIN_LAYERS
    want = {"flash_train_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}
    policies, launches_none = {}, None
    for policy in REMAT_POLICIES:
        model.cfg = dataclasses.replace(model.cfg, remat_policy=policy)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        b = batch()
        _build.reset_launches()
        losses = [run(b)]
        torch.cuda.synchronize()
        launches = {n: _build.LAUNCHES[n] for n in want}
        if launches != want:
            raise AssertionError(f"llama launches per step under remat {policy!r}: {launches}, want {want}")
        b = batch()
        t0 = time.perf_counter()
        losses.append(run(b))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        step_peak = torch.cuda.max_memory_allocated()
        # what the policy keeps through a backward: one micro-batch's forward
        # and grads alone, above the memory held before it
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        tokens = batch()[0].long()
        _, loss = model(tokens, labels=tokens, train=True)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        fwd_bwd = torch.cuda.max_memory_allocated() - start
        del loss, grads
        predicted = llama_predicted_peak(policy)
        policies[policy] = {"launches_per_step": launches, "step_ms": step_ms,
                            "tokens_per_s": LLAMA_T / step_ms * 1e3, "losses": losses,
                            "peak_memory_gib": step_peak / 2**30,
                            "fwd_bwd_peak_above_start_gib": fwd_bwd / 2**30,
                            "predicted_peak_gib": predicted["bytes"] / 2**30,
                            "predicted_parts_gib": {k: v / 2**30 for k, v in predicted["parts"].items()}}
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"llama step under remat {policy!r}: non-finite loss {losses}")
        if launches_none is None:
            launches_none = launches
    persistent = st.shards.persistent_bytes()
    if persistent != 12 * LLAMA_TRAIN_N:
        raise AssertionError(f"llama AdamW holds {persistent} bytes, want 12N = {12 * LLAMA_TRAIN_N}")
    log({"llama_training_steps": {"B": 1, "T": LLAMA_T, "layers": L, "params": LLAMA_TRAIN_N,
                                  "persistent_bytes": persistent, "loss_chunk": LLAMA_CHUNK, "policies": policies,
                                  "grad_norms": steps["grad_norms"]}})
    if record:
        TT_STASH["llama"] = {**steps, "batches": [b.cpu() for b in steps["batches"]]}
    del st, model, step
    gc.collect()
    torch.cuda.empty_cache()
    log({"llama_trainer_cli": llama_cli()})
    log({"llama_training_s": time.perf_counter() - t_phase})
    return {n + "_llama": c for n, c in launches_none.items()}


# ------------------------------------------------------------------ generate

GEN_B, GEN_T, GEN_NEW = 4, 256, 64  # 125m: B 4 x T 256 prompts, 64 new tokens
GEN_LLAMA_T, GEN_LLAMA_NEW = 512, 32  # llama3_8b: B 1 x T 512, 32 new tokens
GEN_LLAMA_F32_LAYERS = 8  # llama3_8b's float32 checks at full width, depth cut 32 -> 8
# llama3_8b's bf16 generate and disagg handoff run at full width, depth cut
# 32 -> 16 for the run's time: their checks are exact (tokens, pages, launch
# counts) or per attention read, none of them depth-dependent (llama_serving
# and tensor_serving, whose bf16 bars were set at 32 layers, keep 32)
LLAMA_CUT_LAYERS = 16
GEN_CLI_NEW = 32
# greedy token ties, as parity_phase's greedy_ties allows them: a path may
# leave the other only where the reference path's top two logits lie within
# twice the logit bar of the precision. float32: 1e-4 (the f32 bar); two
# caches in int8, each written by its own path: 1e-3 (a last-bit difference
# moves an element near a rounding edge by a whole step, ~1e-3 of the logits
# after 12 layers, parity_phase)
TIE_F32, TIE_INT8_F32 = 2 * TOL[torch.float32]["atol"], 2 * 1e-3
GEN_SAMPLED = dict(temperature=0.8, top_p=0.9, repetition_penalty=1.1)  # the serve CLI's defaults


def gen_model(name: str, dtype, impl: str, kv: str = "auto", weights: str = "none", **cfg):
    """``name`` with seed-``SEED`` weights on the card, cast for inference
    (int8 weights quantized where they lie); ``cfg``: more config
    overrides (``n_layers``); earlier models collected first."""
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.models.quant import quantize_model

    gc.collect()
    torch.cuda.empty_cache()
    model = model_getter(name, dtype=dtype, device="cuda", seed=SEED, attention_impl=impl, kv_cache_dtype=kv, **cfg)
    if weights == "int8":
        model = quantize_model(model)
    return model.cast_for_inference()


def gen_prompts(B: int, T: int, salt: int, repetitive: bool = False) -> torch.Tensor:
    """[B, T] byte-token prompts on the host; ``repetitive``: a 37-byte
    phrase over and over (prompt lookup finds drafts in it)."""
    rows = [(prompt_text(37, salt + b) * (T // 37 + 1))[:T] if repetitive else prompt_text(T, salt + b)
            for b in range(B)]
    return torch.tensor([list(r.encode()) for r in rows], dtype=torch.long)


def timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def counted(fn):
    """``fn()`` once: its result, ms (host clock to a device sync), launch
    counts (zeroed just before, read just after) and host syncs
    (``gen_syncs``)."""
    from zero_transformer_tpu_torch.ops import _build

    box = {}
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    where = gen_syncs(lambda: box.setdefault("out", fn()))  # ends in a device sync
    ms = (time.perf_counter() - t0) * 1e3
    return box["out"], ms, {k: c for k, c in _build.LAUNCHES.items() if c}, where


def agree_or_tie(got: torch.Tensor, ref: torch.Tensor, ref_model, prompt: torch.Tensor, margin: float,
                 what: str) -> dict:
    """Greedy tokens of two paths, row by row: equal, or the first token where
    they part comes where ``ref_model``'s top two logits (a full forward over
    the prompt and ``ref``'s tokens before it) lie within ``margin``. The
    tokens after a tie are not compared: the contexts differ."""
    got, ref = got.cpu(), ref.cpu()
    equal, ties = 0, []
    for b in range(ref.shape[0]):
        diff = torch.nonzero(got[b] != ref[b]).flatten()
        if not len(diff):
            equal += 1
            continue
        t = int(diff[0])
        seq = torch.cat([prompt[b], ref[b, :t]])[None].cuda()
        with torch.no_grad():
            top2 = torch.topk(ref_model(seq)[0, -1].float(), 2).values
        gap = float(top2[0] - top2[1])
        ties.append([b, t, gap])
        if not gap <= margin:
            raise AssertionError(f"{what}: row {b} parts at token {t} where the reference's top-2 gap is {gap} "
                                 f"(> {margin}): {got[b, t:t + 4].tolist()} vs {ref[b, t:t + 4].tolist()}")
    return {"rows_equal": equal, "ties": ties}


def gen_syncs(fn) -> list:
    """The host syncs ``fn()`` makes (``res_count_syncs``): [source line, count]."""
    lines = res_count_syncs(fn)
    return [[line, lines.count(line)] for line in sorted(set(lines))]


def gen_spec_run(model, prompt, new: int, K: int, cache_len: int, L: int, paged: str) -> tuple:
    """``generate_speculative`` at ``draft_len`` K as the main path runs it:
    tokens, readings and the launches of the verify windows' kernel (K4 for
    K + 1 <= 8, K1 past it)."""
    from zero_transformer_tpu_torch.inference import generate_speculative
    from zero_transformer_tpu_torch.ops.paged_attention import MAX_DECODE_T

    run = functools.partial(generate_speculative, model, prompt, new, draft_len=K, return_stats=True,
                            cache_len=cache_len)
    (out, stats), ms, counts, where = counted(run)
    fwd = stats["forwards"]
    verify = "flash_serving_fwd" if K + 1 > MAX_DECODE_T else paged
    want = {"flash_serving_fwd": L * (fwd if verify == "flash_serving_fwd" else 1)}
    if verify == paged:
        want[paged] = L * (fwd - 1)
    if counts != want:
        raise AssertionError(f"draft_len {K}: launches {counts}, want {want} ({fwd} forwards)")
    syncs = sum(n for _, n in where)
    if syncs > fwd:
        raise AssertionError(f"draft_len {K}: {syncs} syncs for {fwd} forwards: {where}")
    return out, {"draft_len": K, "verify_kernel": verify, "forwards": fwd, "tokens_per_forward":
                 stats["tokens_per_forward"], "ms": ms, "ms_per_token": ms / new, "syncs": syncs,
                 "syncs_per_forward": syncs / fwd, "sync_lines": where, "launches": counts,
                 "launches_per_token": {k: c / new for k, c in counts.items()}}


def gen_main_path(model, prompt, rep, new: int, cache_len: int, paged: str, sampled: bool) -> tuple:
    """The bf16 kernel path as a user runs it: greedy ``generate`` (launches
    exact: K1 once a layer for the prompt, K4 once a layer for each of the
    new tokens but the last, which is never fed back), its prefill, its
    syncs (none; with an EOS to watch one a step), ``stream_tokens`` equal to
    it, sampled too (one seed), then ``generate_speculative`` at draft_len
    4 and 8 on a repetitive prompt. Returns (readings, the greedy run's
    launches, the speculative runs' readings)."""
    from zero_transformer_tpu_torch.inference import (SamplingConfig, generate, init_cache, prefill,
                                                      stream_tokens)

    L = model.cfg.n_layers
    greedy = SamplingConfig(greedy=True)
    B = prompt.shape[0]
    run = functools.partial(generate, model, prompt, new, sampling=greedy, cache_len=cache_len)
    generate(model, prompt, 4, sampling=greedy, cache_len=cache_len)  # warm-up
    out, ms, counts, where = counted(run)
    want = {"flash_serving_fwd": L, paged: L * (new - 1)}
    if counts != want:
        raise AssertionError(f"generate launches {counts}, want {want}")
    _, prefill_ms = timed_ms(lambda: prefill(model, prompt.cuda(), init_cache(model, B, cache_len)))
    eos = model.cfg.vocab_size  # never sampled: the loop reads `done` every step and runs to the end
    eos_where = gen_syncs(lambda: generate(model, prompt, new, sampling=greedy, eos_token_id=eos,
                                           cache_len=cache_len))
    syncs, eos_syncs = sum(n for _, n in where), sum(n for _, n in eos_where)
    if syncs or eos_syncs > new - 1:
        raise AssertionError(f"generate syncs {where} (want none), with an EOS {eos_where} "
                             f"(want at most {new - 1})")
    streamed = torch.stack(list(stream_tokens(model, prompt, new, sampling=greedy, cache_len=cache_len)), 1)
    if not torch.equal(streamed, out):
        raise AssertionError("stream_tokens differs from generate (greedy)")
    reading = {"batch": B, "prompt": prompt.shape[1], "new_tokens": new, "cache_len": cache_len,
               "generate_ms": ms, "prefill_ms": prefill_ms,
               "decode_ms_per_token": (ms - prefill_ms) / (new - 1), "syncs": syncs,
               "syncs_with_eos": eos_syncs, "syncs_per_forward_with_eos": eos_syncs / new, "launches": counts,
               "launches_per_token": {k: c / new for k, c in counts.items()}}
    if sampled:
        sampling = SamplingConfig(**GEN_SAMPLED)
        gen = lambda: torch.Generator(device="cuda").manual_seed(1)  # noqa: E731
        s_out, s_ms = timed_ms(lambda: generate(model, prompt, new, gen(), sampling, cache_len=cache_len))
        s_stream = torch.stack(list(stream_tokens(model, prompt, new, gen(), sampling, cache_len=cache_len)), 1)
        if not torch.equal(s_stream, s_out):
            raise AssertionError("stream_tokens differs from generate (sampled, one seed)")
        reading["sampled_ms"] = s_ms
    spec, spec_out = [], {}
    greedy_rep = generate(model, rep, new, sampling=greedy, cache_len=cache_len)
    for K in (4, 8):
        spec_out[K], r = gen_spec_run(model, rep, new, K, cache_len, L, paged)
        r["identical_to_greedy_prefix"] = next(
            (i for i, (a, b) in enumerate(zip(spec_out[K][0].tolist(), greedy_rep[0].tolist())) if a != b), new)
        spec.append(r)
    reading["speculative"] = spec
    return reading, counts, spec


def gen_exact(model, rep, new: int, cache_len: int, margin: float, what: str) -> dict:
    """On a float32 model: ``generate_speculative`` at draft_len 4 and 8 equal
    to greedy ``generate`` on the repetitive prompt, outside ties of
    ``margin``."""
    from zero_transformer_tpu_torch.inference import SamplingConfig, generate, generate_speculative

    greedy = generate(model, rep, new, sampling=SamplingConfig(greedy=True), cache_len=cache_len)
    out = {}
    for K in (4, 8):
        spec = generate_speculative(model, rep, new, draft_len=K, cache_len=cache_len)
        out[f"draft_len_{K}_vs_greedy"] = agree_or_tie(spec, greedy, model, rep, margin, f"{what} draft_len {K}")
    return out


def gen_float32(name: str, over: dict, prompt, rep, new: int, cache_len: int, margin: float,
                logits_bar: bool) -> dict:
    """float32 models, one on the card at a time (llama3_8b's are 32 GB):
    the kernel path's speculation against its greedy decoding
    (``gen_exact``), then the kernel path against the plain path: prefill
    logits within the f32 bar (``logits_bar``; else reported) and greedy
    tokens equal outside ties of ``margin``."""
    from zero_transformer_tpu_torch.inference import SamplingConfig, generate, init_cache, prefill

    B, what = prompt.shape[0], f"{name} {over or ''}".strip()
    greedy = SamplingConfig(greedy=True)
    kernel = gen_model(name, torch.float32, "auto", **over)
    out = {"speculative": gen_exact(kernel, rep, new, cache_len, margin, what)}
    lk = prefill(kernel, prompt.cuda(), init_cache(kernel, B, cache_len)).cpu()
    tk = generate(kernel, prompt, new, sampling=greedy, cache_len=cache_len)
    del kernel
    plain = gen_model(name, torch.float32, "xla", **over)
    lp = prefill(plain, prompt.cuda(), init_cache(plain, B, cache_len)).cpu()
    tp = generate(plain, prompt, new, sampling=greedy, cache_len=cache_len)
    out["prefill_logits_max_abs_err"] = (compare(lk, lp, torch.float32, f"{what} float32 prefill logits")
                                         if logits_bar else float((lk - lp).abs().max()))
    out["greedy_kernel_vs_plain"] = agree_or_tie(tk, tp, plain, prompt, margin, f"{what} float32 kernel vs plain")
    del plain
    return out


def generate_125m(int8: bool) -> tuple:
    """Phase (a): 125m at full width and depth, B 4 x T 256, 64 new tokens,
    cache 1024: the bf16 kernel path's main run and readings
    (``gen_main_path``, sampled too in bf16); its prefill logits no farther from the
    float32 plain path than the bf16 plain path's plus 2e-2 (parity_phase's
    bf16 bar); on float32 models speculation against greedy decoding and the
    kernel path against the plain path (``gen_float32``). ``int8``: int8
    weights and an int8 cache on every path (ties of two int8 caches:
    ``TIE_INT8_F32``; the float32 logits over two int8 caches are reported
    without a bar, as in parity_phase). Returns the main run's launches and
    the speculative runs' readings."""
    from zero_transformer_tpu_torch.inference import init_cache, prefill

    over = INT8 if int8 else {}
    paged = "paged_attention_int8" if int8 else "paged_attention"
    prompt, rep = gen_prompts(GEN_B, GEN_T, 0), gen_prompts(1, GEN_T, 5, repetitive=True)
    model = gen_model("125m", torch.bfloat16, "auto", **over)
    reading, counts, spec = gen_main_path(model, prompt, rep, GEN_NEW, CACHE, paged, sampled=not int8)
    bf_k = prefill(model, prompt.cuda(), init_cache(model, GEN_B, CACHE))
    del model
    plain = gen_model("125m", torch.bfloat16, "xla", **over)
    bf_x = prefill(plain, prompt.cuda(), init_cache(plain, GEN_B, CACHE))
    plain = gen_model("125m", torch.float32, "xla", **over)
    ref = prefill(plain, prompt.cuda(), init_cache(plain, GEN_B, CACHE))
    del plain
    e_k, e_x = float((bf_k - ref).abs().max()), float((bf_x - ref).abs().max())
    reading["bf16_prefill_logits_from_f32"] = {"kernel": e_k, "plain": e_x}
    if not e_k <= e_x + TOL[torch.bfloat16]["atol"]:
        raise AssertionError(f"bf16 prefill logits: kernel path {e_k} from float32 vs plain {e_x}")
    reading["float32"] = gen_float32("125m", over, prompt, rep, GEN_NEW, CACHE, TIE_INT8_F32 if int8 else TIE_F32,
                                     logits_bar=not int8)
    log({"generate_125m_int8" if int8 else "generate_125m": reading})
    return counts, spec


def generate_llama() -> tuple:
    """Phase (b): llama3_8b at full width, depth cut to LLAMA_CUT_LAYERS, B 1 x T 512,
    32 new tokens, cache 8192: the bf16 kernel path's main run and readings
    (``gen_main_path``, greedy), then ``gen_float32`` (the bf16 paths lie
    ~0.4 of the logits apart at full depth, parity_phase, so the bars hold
    in float32) on its width at ``GEN_LLAMA_F32_LAYERS`` layers (two 32 GB
    float32 models at full depth cost the run most of this part's
    time)."""
    prompt, rep = gen_prompts(1, GEN_LLAMA_T, 9), gen_prompts(1, GEN_LLAMA_T, 3, repetitive=True)
    model = gen_model(LLAMA, torch.bfloat16, "auto", n_layers=LLAMA_CUT_LAYERS)
    if model.cfg.n_layers != LLAMA_CUT_LAYERS:
        raise AssertionError(f"llama3_8b must run at {LLAMA_CUT_LAYERS} layers")
    reading, counts, spec = gen_main_path(model, prompt, rep, GEN_LLAMA_NEW, LCACHE, "paged_attention",
                                          sampled=False)
    del model
    reading["float32"] = gen_float32(LLAMA, {"n_layers": GEN_LLAMA_F32_LAYERS}, prompt, rep, GEN_LLAMA_NEW, LCACHE,
                                     TIE_F32, logits_bar=True)
    reading["float32"]["layers"] = GEN_LLAMA_F32_LAYERS
    log({"generate_llama3_8b": reading})
    return counts, spec


def generate_cli() -> dict:
    """Phase (c): the serve CLI in processes of their own on an ``.npz`` of
    125m's seed-0 weights, with its default sampling flags and 32 new
    tokens: ``--prompt ... --greedy``, the same with ``--speculative 4``, and
    the REPL on piped stdin, started together; each one's standard output
    must equal what the same ``TextGenerator`` prints in this process, and
    say something (at least half the new tokens' bytes printed). The
    ``.npz`` is deleted."""
    import contextlib
    import io

    from zero_transformer_tpu_torch import serve
    from zero_transformer_tpu_torch.convert import params_to_jax
    from zero_transformer_tpu_torch.models import model_getter

    out = Path("build") / "generate"
    out.mkdir(parents=True, exist_ok=True)
    npz = out / "125m.npz"
    try:
        state = model_getter("125m", device="cuda", seed=SEED).state_dict()
        # the tied table's rows past the 256 byte ids zeroed, so that greedy decoding picks bytes the
        # byte tokenizer prints (with every row random it picks ids above 255, which print nothing)
        state["wte.embedding"][256:] = 0.0
        np.savez(npz, **params_to_jax(state))
        del state
        prompts = [prompt_text(200, 80), prompt_text(120, 81)]
        base = ["--model", "125m", "--params", str(npz), "--max-new-tokens", str(GEN_CLI_NEW), "--greedy"]
        runs = {"one_shot": (base + ["--prompt", prompts[0]], None),
                "speculative_4": (base + ["--prompt", prompts[0], "--speculative", "4"], None),
                "repl": (base, "\n".join(prompts) + "\n\n")}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen([sys.executable, "-m", "zero_transformer_tpu_torch.serve", *argv],
                                     stdin=subprocess.PIPE if stdin else subprocess.DEVNULL, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, cwd=Path(__file__).resolve().parent)
                 for k, (argv, stdin) in runs.items()}
        try:
            args = serve.build_parser().parse_args(base)
            gen = serve.build_generator(args)
            kw = serve._sampling_kwargs(args)
            want = {"one_shot": gen(prompts[0], **kw) + "\n"}
            gen.speculative = 4
            want["speculative_4"] = gen(prompts[0], **kw) + "\n"
            gen.speculative = 0
            stdin, stdout = sys.stdin, io.StringIO()
            try:
                sys.stdin = io.StringIO(runs["repl"][1])
                with contextlib.redirect_stdout(stdout):
                    serve._repl(gen, args)
            finally:
                sys.stdin = stdin
            want["repl"] = stdout.getvalue()
            got = {}
            for k, proc in procs.items():
                text, err = proc.communicate(runs[k][1], timeout=600)
                if proc.returncode:
                    raise AssertionError(f"serve CLI ({k}) exit {proc.returncode}: {err[-3000:]}")
                got[k] = text
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
    finally:
        npz.unlink(missing_ok=True)
    for k in runs:
        if got[k] != want[k]:
            raise AssertionError(f"serve CLI ({k}) printed {got[k]!r}, in process {want[k]!r}")
    if len(got["one_shot"].encode()) < GEN_CLI_NEW // 2:
        raise AssertionError(f"the one-shot completion printed almost nothing: {got['one_shot']!r}")
    reading = {"modes": list(runs), "new_tokens": GEN_CLI_NEW, "wall_s": wall,
               "chars": {k: len(v) for k, v in got.items()}, "repl_turns": got["repl"].count(">>> ")}
    log({"generate_cli": reading})
    return reading


def generate_engine() -> dict:
    """Phase (d): the serving phase's six concurrent greedy requests over HTTP
    on float32 engines (125m) at ``draft_k`` 0 and 4: every stream of
    draft_k 4 equal to draft_k 0's outside float32 ties (``TIE_F32``: the
    verify forward computes a window's logits in other GEMM and attention
    shapes than the one-token tick; in bf16 those roundings part streams at
    gaps no bar of bf16 tells from a wrong token); acceptance and ITL
    beside draft_k 0's."""
    _, plain_tokens, plain = serving_phase(label="serving_f32", dtype=torch.float32)
    launches, tokens, spec = serving_phase(label="spec_serving_f32", draft_k=4, dtype=torch.float32)
    if not (launches["paged_attention"] and spec["spec_ticks"]):
        raise AssertionError(f"draft_k 4 served without verify ticks through K4: {spec}")
    model = gen_model("125m", torch.float32, "auto")
    ties = []
    for i, n in enumerate(PROMPT_LENS):
        prompt = torch.tensor([list(prompt_text(n, i).encode())])
        ties.append(agree_or_tie(torch.tensor([tokens[i]]), torch.tensor([plain_tokens[i]]), model, prompt, TIE_F32,
                                 f"draft_k 4 request {i}"))
    del model
    keys = ("itl_ms_p50", "itl_ms_p99", "ttft_ms_p50", "decode_tok_s", "decode_ticks")
    reading = {"dtype": "float32", "acceptance_rate": spec["acceptance_rate"], "draft_tokens": spec["draft_tokens"],
               "accepted_tokens": spec["accepted_tokens"], "spec_ticks": spec["spec_ticks"],
               "streams_vs_draft_k_0": ties, "draft_k_4_vs_0": {k: [spec[k], plain[k]] for k in keys}}
    log({"generate_engine": reading})
    return reading


def shard_slopes(heads, Hq: int, alibi: bool):
    """``heads`` (lo, total): the ALiBi slopes of a tensor-parallel shard's
    query heads lo .. lo + Hq - 1 of a model with ``total`` heads, and those
    of heads 0 .. Hq - 1 (the unsliced table, which the bar must reject);
    (None, None) for the whole model or without ALiBi."""
    from zero_transformer_tpu_torch.ops.positions import alibi_slopes

    if heads is None or not alibi:
        return None, None
    lo, total = heads
    table = alibi_slopes(total, "cuda")
    return table[lo:lo + Hq].contiguous(), table[:Hq].contiguous()


def reject_unsliced(got, plain, wrong, key: str) -> float:
    """The head-offset control: the plain version handed the unsliced slopes
    (``wrong``, heads 0 .. H/N) must miss the bar the kernel met; returns
    how far it lands."""
    if wrong is None:
        return 0.0
    control = plain(wrong)
    if within(got, control, torch.bfloat16):
        raise AssertionError(f"{key}: the plain version with the slopes of heads 0.. passes the bar; the check "
                             "cannot tell a shard's head range")
    return float((got.float() - control.float()).abs().max())


def gen_k1_row(key: str, B: int, T: int, S: int, Hq: int, KVH: int, Dh: int, offs_l, alibi: bool, rows: dict,
               heads=None):
    """K1 (``flash_serving``) at a generate shape: a window of T queries at
    ``offs_l`` over the slab's S gathered keys and its validity mask, bf16,
    against its plain version; timed with SDPA as the yardstick. ``heads``
    (lo, total): a tensor-parallel shard's query heads, with their slopes
    (``shard_slopes``; the unsliced table must miss the bar)."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import flash

    dtype = torch.bfloat16
    q, k, v, offs, seg = flash_case(B, T, S, KVH, dtype, offs_l, [o + T for o in offs_l], seed=len(key) + 900,
                                    Hq=Hq, Dh=Dh)
    slopes, wrong = shard_slopes(heads, Hq, alibi)
    kw = dict(causal=True, alibi=alibi, q_offset=offs, segment_ids=seg, slopes=slopes)
    got = flash.flash_serving(q, k, v, **kw)
    err = compare(got, flash.flash_reference(q, k, v, **kw)[0], dtype, key)
    control = reject_unsliced(got, lambda sl: flash.flash_reference(q, k, v, **{**kw, "slopes": sl})[0], wrong, key)
    bias = sdpa_bias(B, T, S, offs_l, seg, dtype, Hq, alibi=alibi, slopes=slopes)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound, by = flash_bound(B, T, offs_l, KVH, dtype, Hq, Dh, S)
    rows[key] = dict(
        max_abs_err=err, ms=time_ms(lambda: flash.flash_serving(q, k, v, **kw)),
        device_ms=device_ms(lambda: flash.flash_serving(q, k, v, **kw)),
        plain_ms=time_ms(lambda: flash.flash_reference(q, k, v, **kw)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias,
                                                                  enable_gqa=KVH != Hq)),
        bound_ms=bound, bound_by=by)
    log({"kernel": key, "shape": [B, T, S, Hq, KVH, Dh], "offsets": offs_l, "heads": heads,
         "unsliced_slopes_err": control, **rows[key]})


def gen_k4_row(key: str, B: int, T: int, S: int, Hq: int, KVH: int, Dh: int, offs_l, alibi: bool, rows: dict,
               int8: bool = False, shared_blocks: int = 0, heads=None):
    """K4 (``paged_attention``) at a generate shape: a window of T <= 8
    queries at ``offs_l`` over a slab of S keys seen as pages through the
    identity table (row b owns pages 1 + b * S / page on), bf16 (``int8``:
    int8 pools with float32 scales), against its plain version; timed with
    the page gather + SDPA as the yardstick. ``shared_blocks``: every row
    maps its leading blocks to the same pages (1, 2, ...), as streams behind
    a prefix-cache hit do. ``heads`` as in ``gen_k1_row``."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import paged_attention as pa

    dtype, n_blocks, seed = torch.bfloat16, S // PAGE, len(key) + 950
    if int8:
        q, kq, vq, ks, vs, _, offs = int8_paged_case(B, T, Hq, KVH, Dh, dtype, offs_l, seed, cache=S)
        pools, scales = (kq, vq, ks, vs), dict(k_scale=ks, v_scale=vs)
    else:
        q, kp, vp, _, offs = paged_case(B, T, n_blocks, KVH, dtype, offs_l, seed, Hq=Hq, Dh=Dh)
        pools, scales = (kp, vp), {}
    table = (1 + torch.arange(B * n_blocks, dtype=torch.int32, device="cuda")).view(B, n_blocks)
    table[:, :shared_blocks] = 1 + torch.arange(shared_blocks, dtype=torch.int32, device="cuda")
    slopes, wrong = shard_slopes(heads, Hq, alibi)
    kw = dict(causal=T > 1, alibi=alibi, slopes=slopes)

    def call():
        return pa.paged_attention(q, *pools[:2], table, offs, **scales, **kw)

    got = call()
    err = compare(got, pa.paged_reference(q, *pools[:2], table, offs, **scales, **kw), dtype, key)
    control = reject_unsliced(
        got, lambda sl: pa.paged_reference(q, *pools[:2], table, offs, **scales, **{**kw, "slopes": sl}), wrong, key)
    valid = (torch.arange(S, device="cuda")[None, :] < offs[:, None] + T).int()
    bias = sdpa_bias(B, T, S, offs_l, valid, dtype, Hq, alibi=alibi, slopes=slopes)

    def library():  # gather (and dequantize) the pages, then SDPA
        if int8:
            kk = pa.dequantize(pa.gather_pages(kq, table), pa.gather_pages(ks, table), dtype)
            vv = pa.dequantize(pa.gather_pages(vq, table), pa.gather_pages(vs, table), dtype)
        else:
            kk, vv = pa.gather_pages(kp, table), pa.gather_pages(vp, table)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                                              attn_mask=bias, enable_gqa=KVH != Hq)

    if int8:
        bound, by = int8_paged_bound(B, T, offs_l, Hq, KVH, Dh, dtype, S)
    else:
        bound, by = paged_bound(B, T, offs_l, KVH, dtype, Hq, Dh, S, shared_keys=shared_blocks * PAGE)
    rows[key] = dict(max_abs_err=err, ms=time_ms(call), device_ms=device_ms(call),
                     plain_ms=time_ms(lambda: pa.paged_reference(q, *pools[:2], table, offs, **scales, **kw)),
                     library_ms=time_ms(library), bound_ms=bound, bound_by=by)
    log({"kernel": key, "shape": [B, T, S, Hq, KVH, Dh], "offsets": offs_l, "heads": heads,
         "unsliced_slopes_err": control, **rows[key]})


def generate_phase() -> tuple:
    """(a) 125m (``generate_125m``, bf16 then int8), (b) llama3_8b
    (``generate_llama``), the kernel rows of their shapes (K1: the prompt's
    prefill and a 9-token verify window; K4: a decode step through the
    identity table and a 5-token verify window), (c) the CLI
    (``generate_cli``), (d) the engine's ``--draft-k 4`` over HTTP
    (``generate_engine``). Every part runs; the phase fails after them if
    any failed. Returns the kernel rows and their main-path launches: the
    greedy run's (prefill and decode rows) and the speculative runs' at
    draft_len 8 (K1's verify row) and 4 (K4's)."""
    t_phase = time.perf_counter()
    rows, launches, failed = {}, {}, []

    def main_runs(suffix, run):
        counts, spec = run()
        launches[f"flash_serving_fwd_generate{suffix}"] = counts["flash_serving_fwd"]
        launches[f"paged_attention_generate{suffix}"] = counts["paged_attention"]
        launches[f"flash_serving_fwd_verify{suffix}"] = spec[1]["launches"]["flash_serving_fwd"]
        launches[f"paged_attention_verify{suffix}"] = spec[0]["launches"]["paged_attention"]

    def int8_run():
        counts, _ = generate_125m(True)
        launches["paged_attention_int8_generate"] = counts["paged_attention_int8"]

    def kernel_rows():
        decode_125m = [GEN_T + 15 * b for b in range(GEN_B)]  # positions the 64-token decode passes
        gen_k1_row("flash_serving_fwd_generate", GEN_B, GEN_T, CACHE, H, H, D, [0] * GEN_B, True, rows)
        gen_k1_row("flash_serving_fwd_verify", 1, 9, CACHE, H, H, D, [GEN_T + 40], True, rows)
        gen_k4_row("paged_attention_generate", GEN_B, 1, CACHE, H, H, D, decode_125m, True, rows)
        gen_k4_row("paged_attention_verify", 1, 5, CACHE, H, H, D, [GEN_T + 40], True, rows)
        gen_k4_row("paged_attention_int8_generate", GEN_B, 1, CACHE, H, H, D, decode_125m, True, rows, int8=True)
        gen_k1_row("flash_serving_fwd_generate_llama", 1, GEN_LLAMA_T, LCACHE, LH, LKVH, LD, [0], False, rows)
        gen_k1_row("flash_serving_fwd_verify_llama", 1, 9, LCACHE, LH, LKVH, LD, [GEN_LLAMA_T + 40], False, rows)
        gen_k4_row("paged_attention_generate_llama", 1, 1, LCACHE, LH, LKVH, LD, [GEN_LLAMA_T + 40], False, rows)
        gen_k4_row("paged_attention_verify_llama", 1, 5, LCACHE, LH, LKVH, LD, [GEN_LLAMA_T + 40], False, rows)

    parts = [("125m", lambda: main_runs("", lambda: generate_125m(False))), ("125m int8", int8_run),
             ("llama3_8b", lambda: main_runs("_llama", generate_llama)), ("kernel rows", kernel_rows),
             ("cli", generate_cli), ("engine draft_k", generate_engine)]
    for what, part in parts:
        try:
            part()
        except AssertionError as e:
            failed.append(what)
            log({"generate_failed": what, "error": str(e)})
        gc.collect()
        torch.cuda.empty_cache()
    log({"generate_s": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError(f"generate: {failed} failed")
    return rows, launches


# --------------------------------------------------------- serving policy

# the CLI's .npz files: seed 0's is kept for the disagg phase's CLIs, and the
# directory deleted at the end of the run
POLICY_DIR = Path("build") / "serving_policy"
POLICY_SYSTEM, POLICY_NEW = 512, 32  # a 512-token system prompt (8 chunks of 64), 32 new tokens
POLICY_SUFFIXES = (20, 31, 43, 56, 67, 78, 89, 100)  # each request's own suffix
LLAMA_POLICY_PREFIX, LLAMA_POLICY_NEW = 1024, 16  # llama3_8b: 4 requests on a 1,024-token prefix
LLAMA_POLICY_SUFFIXES = (24, 40, 56, 72)
POLICY_CHUNKS = 256  # the serve CLI's --prefix-cache default (JAX ServingConfig.prefix_cache_chunks)


def policy_prompts(system: int, suffixes, salt: int) -> list:
    """Byte-token prompts sharing a ``system``-token prefix, each with its
    own suffix."""
    head = list(prompt_text(system, salt).encode())
    return [head + list(prompt_text(n, salt + 1 + i).encode()) for i, n in enumerate(suffixes)]


def policy_engine(model, prefix_chunks: int, cache_len: int = CACHE, **kw):
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.serving import ServingEngine

    return ServingEngine(model, n_slots=SLOTS, cache_len=cache_len, sampling=SamplingConfig(greedy=True),
                         prefill_chunk=CHUNK, page_size=PAGE, prefix_cache_chunks=prefix_chunks, device="cuda", **kw)


def policy_burst(engine, prompts, new: int) -> dict:
    """The first request alone until its prefill is done (and banked), then
    the others together, synchronously: the launch counts (zeroed just
    before, read just after), the rows, offsets and block tables of the
    forwards after the first request's prefill (recorded around
    ``forward_paged``), each request's TTFT."""
    from zero_transformer_tpu_torch.ops import _build

    calls = []
    forward = engine.model.forward_paged

    def recording(x, pools, table, offsets, *args, **kw):
        calls.append((x.shape[1], offsets, table))  # read after the run: no sync here
        return forward(x, pools, table, offsets, *args, **kw)

    engine.model.forward_paged = recording
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        first = engine.submit(prompts[0], max_new_tokens=new)
        while first.prefill_done_at is None and first.status in ("queued", "running"):
            engine.step()
        first_calls = len(calls)
        rest = [engine.submit(p, max_new_tokens=new) for p in prompts[1:]]
        engine.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        del engine.model.forward_paged
    handles = [first] + rest
    for h, p in zip(handles, prompts):
        if h.status != "done" or len(h.tokens) != new:
            raise AssertionError(f"a {len(p)}-token request ended {h.status} with {len(h.tokens)} tokens: {h.error}")
    return {"handles": handles, "launches": launches, "wall_s": wall, "snap": engine.metrics_snapshot(),
            "calls": [(T, offs.tolist(), table) for T, offs, table in calls[first_calls:]],
            "ttft_ms": [(h.first_token_at - h.submitted_at) * 1e3 for h in handles]}


def policy_expect(engine, prompts, hit_chunks: int, run: dict, label: str) -> dict:
    """The counts the code predicts for a burst over ``prompts`` whose first
    request banks ``hit_chunks`` shared chunks: hits and misses as
    ``PrefixCache.lookup`` counts them, the chunks saved, one K1 launch a
    layer and prefill tick, one K4 a layer and decode tick, no copy-on-write,
    and after retirement every page in use held once, by the index."""
    snap, launches, L = run["snap"], run["launches"], engine.cfg.n_layers
    # the engine's supervision turns an exception in a tick into a retryable
    # failure: none may have happened
    faults = {k: snap[k] for k in ("prefill_faults", "tick_faults", "poisoned_slots", "preemptions")}
    if any(faults.values()):
        raise AssertionError(f"{label}: the burst met faults {faults}")
    lens = [len(p) for p in prompts]
    want = {"prefix_hits": hit_chunks * (len(prompts) - 1),
            "prefix_misses": (lens[0] - 1) // CHUNK + sum((n - 1) // CHUNK - hit_chunks for n in lens[1:]),
            "prefill_chunks": -(-lens[0] // CHUNK) + sum(-(-(n - hit_chunks * CHUNK) // CHUNK) for n in lens[1:]),
            "flash_serving_fwd": L * snap["prefill_ticks"], "cow_copies": 0}
    paged = "paged_attention_int8" if engine.cfg.kv_cache_dtype == "int8" else "paged_attention"
    want[paged] = L * snap["decode_ticks"]
    got = {k: snap[k] for k in ("prefix_hits", "prefix_misses", "prefill_chunks", "cow_copies")}
    got.update({k: launches[k] for k in ("flash_serving_fwd", paged)})
    if got != want:
        raise AssertionError(f"{label}: counts {got} != predicted {want}")
    other = "paged_attention" if paged.endswith("int8") else "paged_attention_int8"
    if launches[other]:
        raise AssertionError(f"{label}: the {other} kernel launched on a {engine.cfg.kv_cache_dtype} cache")
    index = engine._prefix_cache
    held = [p for pages in index._entries.values() for p in pages]
    pool = engine.slots.pool
    if not (all(pool.refs[p] == 1 for p in held) and pool.in_use == len(held) and pool.reserved == 0):
        raise AssertionError(f"{label}: pages leaked: {pool.in_use} in use, {len(held)} held by the index, "
                             f"refs {sorted(set(pool.refs[p] for p in held))}, {pool.reserved} reserved")
    return {**got, "prefix_stores": snap["prefix_stores"], "index_pages": len(held)}


def policy_prefix(dtype, kv: str = "auto", both: bool = True) -> dict:
    """(a) The 8-request burst on 125m in ``dtype`` with the prefix cache on
    (256 chunks) and, with ``both``, off: exact counts, the streams of the
    two runs (float32: equal but at ties of ``TIE_F32``; bf16: the first
    divergence and its top-2 gap, no bar), the TTFT p50 of the seven hit
    requests and the launches of the cache-on run."""
    model = gen_model("125m", dtype, "auto", kv=kv)
    prompts = policy_prompts(POLICY_SYSTEM, POLICY_SUFFIXES, 90)
    on_engine = policy_engine(model, POLICY_CHUNKS)
    on = policy_burst(on_engine, prompts, POLICY_NEW)
    label = f"serving_policy {str(dtype)[6:]} {kv}-cache prefix"
    counts = policy_expect(on_engine, prompts, POLICY_SYSTEM // CHUNK, on, label)
    del on_engine
    reading = {"dtype": str(dtype)[6:], "kv_cache_dtype": kv, "requests": len(prompts),
               "prompt_lens": [len(p) for p in prompts], "counts": counts,
               "ttft_ms_p50_hits_cache_on": sorted(on["ttft_ms"][1:])[3], "wall_s_cache_on": on["wall_s"],
               "launches_cache_on": {k: c for k, c in on["launches"].items() if c}}
    if both:
        off_engine = policy_engine(model, 0)
        off = policy_burst(off_engine, prompts, POLICY_NEW)
        del off_engine
        saved = off["snap"]["prefill_chunks"] - on["snap"]["prefill_chunks"]
        if saved != 7 * (POLICY_SYSTEM // CHUNK) or off["snap"]["prefix_hits"]:
            raise AssertionError(f"{label}: the cache saved {saved} chunks, predicted {7 * POLICY_SYSTEM // CHUNK}")
        got = torch.tensor([h.tokens for h in on["handles"]])
        ref = torch.tensor([h.tokens for h in off["handles"]])
        rows = [torch.tensor(p) for p in prompts]
        margin = TIE_F32 if dtype == torch.float32 else float("inf")
        reading.update({
            "streams_cache_on_vs_off": agree_or_tie(got, ref, model, rows, margin, f"{label} on vs off"),
            "ttft_ms_p50_hits_cache_off": sorted(off["ttft_ms"][1:])[3], "wall_s_cache_off": off["wall_s"],
            "prefill_chunks_on_off": [on["snap"]["prefill_chunks"], off["snap"]["prefill_chunks"]],
            "prefill_ticks_on_off": [on["snap"]["prefill_ticks"], off["snap"]["prefill_ticks"]],
            "k1_launches_on_off": [on["launches"]["flash_serving_fwd"], off["launches"]["flash_serving_fwd"]],
        })
    del model
    return reading, on


def policy_kernel_rows(on: dict, rows: dict) -> dict:
    """K1 at the chunk after a hit (the first prefill call once the first
    request is decoding: its rows at offset 512, keys 512 + 64 of the
    1024-key window) and K4 at
    a decode tick whose four rows share their 32 leading pages, with the
    offsets of that tick (bf16)."""
    hit = POLICY_SYSTEM
    prefill = next((offs for T, offs, _ in on["calls"] if T > 1 and hit in offs), None)
    decode = next((offs for T, offs, table in on["calls"]
                   if T == 1 and min(offs) > hit and bool((table[:, :hit // PAGE] == table[:1, :hit // PAGE]).all())),
                  None)
    if prefill is None or decode is None:
        raise AssertionError(f"no chunk at the hit or no decode tick over shared pages was recorded")
    offs = [o for o in prefill if o == hit]
    gen_k1_row("flash_serving_fwd_prefix", len(offs), CHUNK, CACHE, H, H, D, offs, True, rows)
    gen_k4_row("paged_attention_prefix", len(decode), 1, CACHE, H, H, D, decode, True, rows,
               shared_blocks=hit // PAGE)
    return {"k1_rows_at_hit": len(offs), "k4_offsets": decode}


def cli_server(args: list):
    """``python -m zero_transformer_tpu_torch.serve`` with ``args`` in a
    process of its own: (process, a queue of its output lines)."""
    return module_proc("zero_transformer_tpu_torch.serve", args)


def cli_base(lines, out: list, label: str) -> str:
    """The base URL the serve CLI prints once it listens."""
    return printed(lines, out, r"serving on (http://[0-9.]+:[0-9]+)", label)


def module_proc(module: str, args: list):
    """``python -m <module> <args>`` in a process of its own: (process, a
    queue of its output lines)."""
    import queue

    proc = subprocess.Popen([sys.executable, "-m", module, *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=Path(__file__).resolve().parent)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    return proc, lines


def printed(lines, out: list, pattern: str, label: str, timeout: float = 300.0) -> str:
    """The first group of ``pattern`` in a line the process prints (each
    line read is kept in ``out``)."""
    import queue

    deadline = time.monotonic() + timeout
    while True:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            raise AssertionError(f"{label} printed no {pattern!r} within {timeout} s: {out[-20:]}") from None
        out.append(line)
        found = re.search(pattern, line)
        if found:
            return found.group(1)


def sse_post(url: str, body: dict) -> list:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return [json.loads(raw[6:]) for raw in r if raw.startswith(b"data: ")]


def policy_cli(tmp: Path) -> dict:
    """(c) ``python -m zero_transformer_tpu_torch.serve --server`` on 125m in
    float32 (an ``.npz`` of seed-0 weights; another of seed 1 to reload):
    the first answered ``/healthz`` is 200 READY; ``POST /admin/reload``
    with a stream in flight answers 200, the stream finishes whole, the
    prefix entries read 0 after the swap, and the next greedy stream equals
    an in-process engine's on the new weights (``agree_or_tie``); a
    truncated file answers 409 and the engine stays READY; SIGTERM with a
    stream in flight: it finishes, ``drain_done`` is printed, exit 0."""
    import queue
    import signal

    from zero_transformer_tpu_torch.convert import params_to_jax
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.models import model_getter

    tmp.mkdir(parents=True, exist_ok=True)
    files = {}
    for seed, name in ((SEED, "a.npz"), (SEED + 1, "b.npz")):
        m = model_getter("125m", dtype=torch.float32, device="cuda", seed=seed)
        np.savez(tmp / name, **params_to_jax(m.state_dict()))
        files[name] = tmp / name
        if seed != SEED:
            new_model = m.cast_for_inference()
        else:
            del m
    bad = tmp / "bad.npz"
    bad.write_bytes(files["b.npz"].read_bytes()[:4096])
    proc, lines = cli_server(["--model", "125m", "--params", str(files["a.npz"]), "--server", "--port", "0",
                              "--dtype", "float32", "--greedy", "--repetition-penalty", "1.0"])
    out_lines = []

    def drain_lines():
        while True:
            try:
                out_lines.append(lines.get_nowait())
            except queue.Empty:
                return

    def stream(body, first_seen: threading.Event, box: dict):
        req = urllib.request.Request(base + "/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            events = []
            for raw in r:
                if raw.startswith(b"data: "):
                    events.append(json.loads(raw[6:]))
                    first_seen.set()
            box["events"] = events

    reading = {}
    try:
        t_start = time.perf_counter()
        base = cli_base(lines, out_lines, "serve CLI")
        answers = []  # every /healthz answer until READY: 503 unless the state is ready
        for _ in range(600):
            try:
                code, text = http("GET", base + "/healthz", timeout=10)
            except urllib.error.HTTPError as e:
                code, text = e.code, e.read().decode()
            answers.append((code, json.loads(text)["state"]))
            if code == 200:
                break
            time.sleep(0.05)
        if answers[-1] != (200, "ready") or any((c == 200) != (s == "ready") for c, s in answers):
            raise AssertionError(f"serve CLI /healthz answers: {answers}")
        reading["healthz_until_ready"] = answers
        reading["startup_s"] = time.perf_counter() - t_start
        # a stream in flight across the reload: still streaming when the swap is done
        seen, box = threading.Event(), {}
        t = threading.Thread(target=stream, args=({"prompt": prompt_text(40, 3), "max_new_tokens": 600}, seen, box))
        t.start()
        seen.wait(120)
        t0 = time.perf_counter()
        code, text = http("POST", base + "/admin/reload", {"params": str(files["b.npz"])})
        reading["reload_ms"] = (time.perf_counter() - t0) * 1e3
        crossed = t.is_alive()
        after = json.loads(http("GET", base + "/metrics")[1])
        t.join(300)
        events = box.get("events") or [{}]
        toks = [e["token"] for e in events if "token" in e]
        reading["stream_crossed_the_swap"] = crossed
        if code != 200 or not json.loads(text)["reloaded"] or events[-1].get("status") != "done" \
                or len(toks) != 600 or not crossed:
            raise AssertionError(f"reload with a stream in flight: HTTP {code} {text}, stream {events[-1]} with "
                                 f"{len(toks)} tokens, crossed the swap: {crossed}")
        if after["prefix_entries"] != 0 or after["reloads"] != 1:
            raise AssertionError(f"after the swap: prefix_entries {after['prefix_entries']}, reloads {after['reloads']}")
        prompt = prompt_text(300, 11)
        code, text = http("POST", base + "/generate", {"prompt": prompt, "max_new_tokens": POLICY_NEW,
                                                      "stream": False})
        got = json.loads(text)["tokens"]
        from zero_transformer_tpu_torch.serving import ServingEngine

        fresh = ServingEngine(new_model, n_slots=SLOTS, cache_len=CACHE, device="cuda",
                              sampling=SamplingConfig(temperature=0.8, top_p=0.9, greedy=True),
                              prefill_chunk=CHUNK, page_size=PAGE)
        h = fresh.submit(list(prompt.encode()), max_new_tokens=POLICY_NEW)
        fresh.run_until_idle()
        reading["after_reload_vs_fresh_engine"] = agree_or_tie(
            torch.tensor([got]), torch.tensor([h.tokens]), new_model, [torch.tensor(list(prompt.encode()))],
            TIE_F32, "the stream after the reload vs a fresh engine on the new weights")
        del fresh
        try:
            code, text = http("POST", base + "/admin/reload", {"params": str(bad)})
        except urllib.error.HTTPError as e:
            code, text = e.code, e.read().decode()
        health = http("GET", base + "/healthz")[0]
        if code != 409 or json.loads(text)["state"] != "ready" or health != 200:
            raise AssertionError(f"truncated reload: HTTP {code} {text}, /healthz {health}")
        # SIGTERM with a stream in flight
        seen, box = threading.Event(), {}
        t = threading.Thread(target=stream, args=({"prompt": prompt_text(60, 5), "max_new_tokens": 200}, seen, box))
        t.start()
        seen.wait(120)
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        t.join(300)
        try:
            proc.wait(120)
        except subprocess.TimeoutExpired:
            raise AssertionError("the serve CLI did not exit within 120 s of SIGTERM") from None
        reading["sigterm_to_exit_s"] = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        time.sleep(0.2)
        drain_lines()
        del new_model
    events = box.get("events") or [{}]
    toks = [e["token"] for e in events if "token" in e]
    drained = [x.strip() for x in out_lines if "EVENT drain_done" in x]
    if proc.returncode != 0 or not drained or events[-1].get("status") != "done" or len(toks) != 200:
        raise AssertionError(f"SIGTERM drain: exit {proc.returncode}, drain_done {drained}, stream {events[-1]} "
                             f"with {len(toks)} tokens; {out_lines[-10:]}")
    reading.update({"exit": proc.returncode, "drain_done": drained[0][-120:], "stream_tokens_through_drain": len(toks)})
    return reading


def policy_faults_and_qos() -> dict:
    """(d) In process, 125m bf16: ``/healthz`` 503 until the scheduler runs;
    one faulted tick fails only the four decoding slots (retryably) and the
    queued fifth request completes; three faulted ticks in a row trip the
    breaker (DEGRADED), each rebuilds the device state, and a clean tick
    closes it (READY); the card's allocated bytes return to their level
    before the faults within one pool's bytes, and a rebuild on an idle
    engine raises their peak by less than one pool's bytes (the old pools go
    before the new ones come); four batch streams fill the slots and a gold
    request preempts exactly one of them and is admitted on the same tick;
    ``/metrics`` as Prometheus text parses and its counters equal
    ``metrics_snapshot()``."""
    from zero_transformer_tpu_torch.serve import ByteTokenizer
    from zero_transformer_tpu_torch.serving import ServeFault, ServingChaosMonkey, ServingServer

    model = gen_model("125m", torch.bfloat16, "auto")
    chaos = ServingChaosMonkey([])
    engine = policy_engine(model, POLICY_CHUNKS, chaos=chaos)
    server = ServingServer(engine, ByteTokenizer(), port=0)
    server.start(start_scheduler=False)
    base = f"http://127.0.0.1:{server.port}"
    try:
        try:
            code = http("GET", base + "/healthz")[0]
        except urllib.error.HTTPError as e:
            code = e.code
        if code != 503:
            raise AssertionError(f"/healthz answered {code} before the scheduler ran")
    finally:
        server.stop()
    # warm-up, then the faulted ticks, synchronously (prompts of one chunk:
    # a request admitted on a tick decodes on it)
    engine.submit(list(prompt_text(40, 1).encode()), max_new_tokens=4)
    engine.run_until_idle()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    victims = [engine.submit(list(prompt_text(40 + i, 2 + i).encode()), max_new_tokens=16) for i in range(SLOTS)]
    queued = engine.submit(list(prompt_text(30, 9).encode()), max_new_tokens=8)
    chaos.faults.append(ServeFault("tick_fault", step=engine._tick + 1, duration=1))
    engine.run_until_idle()
    storm = [engine.submit(list(prompt_text(30 + i, 40 + i).encode()), max_new_tokens=8) for i in range(3 * SLOTS)]
    chaos.faults.append(ServeFault("tick_fault", step=engine._tick, duration=3))
    for _ in range(3):
        engine.step()
    state_at_trip = engine.lifecycle.state
    recovered = engine.submit(list(prompt_text(30, 60).encode()), max_new_tokens=8)
    engine.run_until_idle()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    idle = torch.cuda.memory_allocated()
    engine._rebuild_device_state()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    one_pool = engine.pools[0].k.nbytes
    faults = {"tick_faults": engine.stats["tick_faults"], "breaker_trips": engine.stats["breaker_trips"],
              "state_at_trip": state_at_trip, "state_after": engine.lifecycle.state,
              "one_tick_victims": [v.status for v in victims], "queued": queued.status,
              "storm_failed": sum(h.status == "failed" and h.retryable for h in storm),
              "allocated_before_after": [before, after], "rebuild_peak_over_idle": peak - idle,
              "one_pool_bytes": one_pool, "kv_pool_bytes": engine.kv_pool_bytes}
    if not (faults["tick_faults"] == 4 and faults["breaker_trips"] == 1 and state_at_trip == "degraded"
            and faults["state_after"] == "ready" and all(v.status == "failed" and v.retryable for v in victims)
            and queued.status == "done" and recovered.status == "done" and faults["storm_failed"] == 3 * SLOTS
            and abs(after - before) < one_pool and peak - idle < one_pool):
        raise AssertionError(f"breaker: {faults}")
    # QoS: gold preempts one of four running batch streams, admitted the same tick
    batch = [engine.submit(list(prompt_text(60 + i, 20 + i).encode()), max_new_tokens=64, qos="batch")
             for i in range(SLOTS)]
    while sum(a is not None for a in engine._active) < SLOTS:
        engine.step()
    gold = engine.submit(list(prompt_text(50, 30).encode()), max_new_tokens=8, qos="gold")
    engine.step()
    preempted = [b for b in batch if b.status == "failed"]
    qos = {"gold_after_one_tick": gold.status, "batch_preempted": len(preempted),
           "preempted_for_class": engine.stats["preempted_for_class"]}
    if not (gold.status == "running" and len(preempted) == 1 and preempted[0].retryable
            and engine.stats["preempted_for_class"] == 1):
        raise AssertionError(f"QoS preemption: {qos}")
    engine.run_until_idle()
    # Prometheus text over HTTP against the snapshot
    server = ServingServer(engine, ByteTokenizer(), port=0)
    server.start(start_scheduler=False)
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/metrics", headers={"Accept": "text/plain"})
        with urllib.request.urlopen(req, timeout=60) as r:
            ctype, text = r.headers.get("Content-Type"), r.read().decode()
    finally:
        server.stop()
    snap = engine.metrics_snapshot()
    families = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    samples = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    counters = [n for n, t in families.items() if t == "counter"]
    wrong = {n: (samples.get(n), snap[n[len("serve_"):-len("_total")]]) for n in counters
             if samples.get(n) != snap[n[len("serve_"):-len("_total")]]}
    if not ctype.startswith("text/plain; version=0.0.4") or len(counters) < 38 or wrong:
        raise AssertionError(f"/metrics as Prometheus text: {ctype}, {len(counters)} counters, mismatches {wrong}")
    del engine, model
    return {"breaker": faults, "qos": qos, "prometheus_families": len(families), "prometheus_counters": len(counters)}


def policy_cost(reps: int = 2) -> dict:
    """(e) The policy layer's host cost on 125m bf16: four 300-token streams
    of 48 new tokens, host ms per decode-only tick (the wall time of
    ``step()`` on ticks without prefill work) and ITL p50, with the serve
    CLI's defaults (prefix cache 256, spans on, the inert QoS policy)
    against ``--prefix-cache 0 --no-trace``, alternated ``reps`` times."""
    model = gen_model("125m", torch.bfloat16, "auto")
    arms = {"defaults": dict(prefix_chunks=POLICY_CHUNKS), "prefix_0_no_trace": dict(prefix_chunks=0, trace=False)}
    out = {k: {"host_ms_per_decode_tick": [], "itl_ms_p50": []} for k in arms}
    for _ in range(reps):
        for arm, kw in arms.items():
            engine = policy_engine(model, kw["prefix_chunks"], **{k: v for k, v in kw.items() if k != "prefix_chunks"})
            for i in range(SLOTS):
                engine.submit(list(prompt_text(300, 70 + i).encode()), max_new_tokens=48)
            ticks = []
            while True:
                t0 = time.perf_counter()
                busy = engine.step()
                dt = time.perf_counter() - t0
                if not busy:
                    break
                if not engine._prefill_work and engine.active_count == SLOTS:
                    ticks.append(dt * 1e3)
            out[arm]["host_ms_per_decode_tick"].append(sum(ticks) / len(ticks))
            out[arm]["itl_ms_p50"].append(engine.metrics_snapshot()["itl_ms_p50"])
            del engine
    del model
    return out


def serving_policy_phase() -> tuple:
    """Serving's policy layer on the card (the module doc, phase 20): (a)
    prefix hits on 125m in float32 and bf16 with the cache on and off, and
    over an int8 cache; the kernel rows of K1 after a hit and K4 over
    shared pages; (c) the serve CLI's reload and SIGTERM drain; (d) the
    breaker and QoS in process; (e) the layer's host cost. Every part runs;
    the phase fails after them if any failed. Returns the kernel rows and
    their launches (the bf16 cache-on burst's)."""
    t_phase = time.perf_counter()
    rows, launches, failed, reading = {}, {}, [], {"card": card_line()}

    def bf16_prefix():
        reading["prefix_bf16"], on = policy_prefix(torch.bfloat16)
        launches["flash_serving_fwd_prefix"] = on["launches"]["flash_serving_fwd"]
        launches["paged_attention_prefix"] = on["launches"]["paged_attention"]
        reading["kernel_rows"] = policy_kernel_rows(on, rows)

    parts = [("prefix float32", lambda: reading.__setitem__("prefix_f32", policy_prefix(torch.float32)[0])),
             ("prefix bf16", bf16_prefix),
             ("prefix int8 cache", lambda: reading.__setitem__("prefix_int8_cache",
                                                               policy_prefix(torch.bfloat16, "int8", False)[0])),
             ("cli", lambda: reading.__setitem__("cli", policy_cli(POLICY_DIR))),
             ("faults and qos", lambda: reading.__setitem__("faults_qos", policy_faults_and_qos())),
             ("cost", lambda: reading.__setitem__("cost", policy_cost()))]
    for what, part in parts:
        t0 = time.perf_counter()
        try:
            part()
        except AssertionError as e:
            failed.append(what)
            log({"serving_policy_failed": what, "error": str(e)})
        reading.setdefault("part_s", {})[what] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("b.npz", "bad.npz"):
        (POLICY_DIR / name).unlink(missing_ok=True)
    reading["serving_policy_s"] = time.perf_counter() - t_phase
    log({"serving_policy": reading})
    if failed:
        raise AssertionError(f"serving_policy: {failed} failed")
    return rows, launches


def llama_policy_burst(engine) -> dict:
    """(b) llama3_8b at 32 layers, bf16, on the model the llama_serving phase
    built (a second engine over it, the prefix cache on): four requests on a
    1,024-token prefix, the first alone until banked; exact counts (48 hits)
    and every layer's attention read, kernel against the plain read of the
    same pools, within the bf16 bar (GQA pages shared across streams)."""
    model = engine.model
    burst_engine = policy_engine(model, POLICY_CHUNKS, cache_len=LCACHE)
    prompts = policy_prompts(LLAMA_POLICY_PREFIX, LLAMA_POLICY_SUFFIXES, 40)
    with attention_reads_checked(model, "llama3_8b shared-page") as checked:
        run = policy_burst(burst_engine, prompts, LLAMA_POLICY_NEW)
    counts = policy_expect(burst_engine, prompts, LLAMA_POLICY_PREFIX // CHUNK, run, "llama3_8b prefix")
    reading = {"layers": model.cfg.n_layers, "prompt_lens": [len(p) for p in prompts], "counts": counts,
               "read_max_abs_err": checked["max_abs_err"], "reads": checked["reads"], "read_tol": checked["tol"],
               "ttft_ms": run["ttft_ms"], "wall_s": run["wall_s"],
               "launches": {k: c for k, c in run["launches"].items() if c}}
    log({"serving_policy_llama": reading})
    del burst_engine
    gc.collect()
    torch.cuda.empty_cache()
    return reading


DISAGG_DIR = Path("build") / "disagg"  # the prefill CLI's flight dumps; deleted at the end of the phase
DISAGG_LENS, DISAGG_NEW = (130, 300, 451, 512), 32  # 125m prompts (3-8 chunks of 64), new tokens
DISAGG_LLAMA_T, DISAGG_LLAMA_NEW, DISAGG_LLAMA_CACHE = 512, 16, 1024
# bf16 (and int8-cache) streams may part from a mixed engine's only where its
# top two logits lie closer than this (PR 14's bar for bf16 streams)
TIE_BF16_SERVE = 0.03


def disagg_engine(model, role: str = "mixed", cache_len: int = CACHE, sampling=None, **kw):
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.serving import ServingEngine

    return ServingEngine(model, n_slots=SLOTS, cache_len=cache_len, sampling=sampling or SamplingConfig(greedy=True),
                         prefill_chunk=CHUNK, page_size=PAGE, device="cuda", role=role, **kw)


def span_bytes(payload) -> int:
    """Bytes of a payload's page leaves (the carry aside)."""
    return sum(t.numel() * t.element_size() for k, t in payload["leaves"].items() if not k.startswith("carry/"))


def leaf_bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def link(src, dst, timed: bool = True) -> dict:
    """Join ``src`` to ``dst`` in process through the wire format. With
    ``timed``, time each stream's legs on the host clock: the export (its
    copy to the host waits for the card; a device sync first, so the
    prefill's tail is not counted), the encode, the decode and the import
    (device syncs around it); untimed, the spans move exactly as the
    engines move them (no sync of the harness's own). Returns the record
    the legs append to."""
    from zero_transformer_tpu_torch.serving import page_span_from_wire, page_span_to_wire

    rec = {k: [] for k in ("ready_at", "export_ms", "encode_ms", "decode_ms", "import_ms", "payloads", "wire_bytes",
                           "handles")}
    export, place = src.slots.export_page_span, dst.slots.import_page_span

    def timed_export(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["ready_at"].append(t0)
        out = export(*args, **kw)
        rec["export_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_import(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = place(*args, **kw)
        torch.cuda.synchronize()
        rec["import_ms"].append((time.perf_counter() - t0) * 1e3)
        return ok

    def ship(payload, target, on_done):
        t0 = time.perf_counter()
        blob = page_span_to_wire(payload)
        t1 = time.perf_counter()
        back = page_span_from_wire(blob)
        t2 = time.perf_counter()
        rec["encode_ms"].append((t1 - t0) * 1e3)
        rec["decode_ms"].append((t2 - t1) * 1e3)
        rec["wire_bytes"].append(len(blob))
        rec["payloads"].append(payload)
        handle = dst.import_stream(back)
        rec["handles"].append(handle)
        on_done(None if handle.status in ("queued", "running") else (handle.error or handle.status))

    if timed:
        src.slots.export_page_span, dst.slots.import_page_span = timed_export, timed_import
    src.page_shipper = ship
    return rec


def imported_pages_equal(dst, rec, label: str) -> int:
    """Place the queued imports, then hold every page leaf the receiver now
    maps (scale pools included) and its decode carry to the exported bytes,
    bit for bit. Returns the leaves compared."""
    dst._service_imports()
    by_rid = {p["request_id"]: p for p in rec["payloads"]}
    compared = 0
    for slot, act in enumerate(dst._active):
        if act is None:
            continue
        sent = by_rid[act.handle.rid]
        got = dst.slots.export_page_span(slot, sent["n_tokens"], dst.pools, dst.cfg.scan_layers)["leaves"]
        got["carry/last_logits"] = dst._last_logits[slot].cpu()
        got["carry/gen_mask"] = dst._gen_mask[slot].cpu()
        for key, want in sent["leaves"].items():
            if key in got and leaf_bits(got[key]) != leaf_bits(want):
                raise AssertionError(f"{label}: leaf {key} of stream {act.handle.rid} is not the exported bytes")
            compared += key in got
    pages = [k for k in rec["payloads"][0]["leaves"] if not k.startswith("carry/")]
    if compared != len(rec["payloads"]) * (len(pages) + 2):
        raise AssertionError(f"{label}: compared {compared} leaves of {len(rec['payloads'])} streams")
    return compared


def disagg_handoff(model, prompts, new: int, cache_len: int, label: str) -> dict:
    """A prefill-role and a decode-role engine over ``model``, joined by
    ``link``: each prompt alone on the prefill engine until it has
    shipped (its prefill time: submit to the export's start), then the
    imports placed and their pages checked bit-equal, then the decode
    engine to the end. Launch counts are zeroed before and read after each
    engine's run: K1 one a layer and chunk on the prefill engine and no K4;
    no K1 on the decode engine and K4 one a layer and decode tick."""
    from zero_transformer_tpu_torch.ops import _build

    L = model.cfg.n_layers
    paged = "paged_attention_int8" if model.cfg.kv_cache_dtype == "int8" else "paged_attention"
    pre, dec = disagg_engine(model, "prefill", cache_len), disagg_engine(model, "decode", cache_len)
    rec = link(pre, dec)
    submitted = []
    torch.cuda.synchronize()
    _build.reset_launches()
    for p in prompts:
        t0 = time.perf_counter()
        h = pre.submit(p, max_new_tokens=new, prefill_to="http://decode")
        submitted.append(t0)
        while h.status in ("queued", "running"):
            pre.step()
        if h.status != "migrated":
            raise AssertionError(f"{label}: a {len(p)}-token handoff ended {h.status}: {h.error}")
    torch.cuda.synchronize()
    pre_launches = dict(_build.LAUNCHES)
    chunks = sum(-(-len(p) // CHUNK) for p in prompts)
    want = {"flash_serving_fwd": L * chunks, paged: 0, "prefill_chunks": chunks, "prefill_handoffs": len(prompts),
            "decode_ticks": 0}
    got = {"flash_serving_fwd": pre_launches["flash_serving_fwd"], paged: pre_launches[paged],
           "prefill_chunks": pre.stats["prefill_chunks"], "prefill_handoffs": pre.stats["prefill_handoffs"],
           "decode_ticks": pre.stats["decode_ticks"]}
    if got != want:
        raise AssertionError(f"{label}: prefill engine counts {got} != {want}")
    compared = imported_pages_equal(dec, rec, label)
    torch.cuda.synchronize()
    _build.reset_launches()
    dec.run_until_idle()
    torch.cuda.synchronize()
    dec_launches = dict(_build.LAUNCHES)
    conts = {h.rid: h for h in rec["handles"]}
    for h in conts.values():
        if h.status != "done" or len(h.tokens) != new:
            raise AssertionError(f"{label}: an imported stream ended {h.status} with {len(h.tokens)} tokens: {h.error}")
    want = {"flash_serving_fwd": 0, paged: L * dec.stats["decode_ticks"], "prefill_chunks": 0,
            "import_replayed_tokens": 0, "migrations_in": len(prompts)}
    got = {"flash_serving_fwd": dec_launches["flash_serving_fwd"], paged: dec_launches[paged],
           "prefill_chunks": dec.stats["prefill_chunks"], "import_replayed_tokens": dec.stats["import_replayed_tokens"],
           "migrations_in": dec.stats["migrations_in"]}
    if got != want:
        raise AssertionError(f"{label}: decode engine counts {got} != {want}")
    per_token = [span_bytes(p) / (p["n_blocks"] * PAGE) for p in rec["payloads"]]
    streams = [{"prompt": len(p), "prefill_ms": (r - s) * 1e3, "export_ms": e, "encode_ms": en, "decode_ms": de,
                "import_ms": im, "wire_bytes": w}
               for p, r, s, e, en, de, im, w in zip(prompts, rec["ready_at"], submitted, rec["export_ms"],
                                                    rec["encode_ms"], rec["decode_ms"], rec["import_ms"],
                                                    rec["wire_bytes"])]
    return {"tokens": [conts[h.rid].tokens for h in rec["handles"]], "rids": [h.rid for h in rec["handles"]],
            "bytes_per_token": sorted(set(per_token)), "leaves_bit_equal": compared, "streams": streams,
            "prefill_launches": {k: c for k, c in pre_launches.items() if c},
            "decode_launches": {k: c for k, c in dec_launches.items() if c},
            "decode_ticks": dec.stats["decode_ticks"]}


def mixed_streams(model, prompts, new: int, sampling=None, seeds=None) -> list:
    """A mixed engine's streams for ``prompts``, each prompt alone until its
    prefill is done (the prefill engine's GEMM shapes), the decode ticks
    over every slot as always."""
    eng = disagg_engine(model, sampling=sampling)
    handles = []
    for i, p in enumerate(prompts):
        h = eng.submit(p, max_new_tokens=new, seed=seeds[i] if seeds else 0)
        while h.prefill_done_at is None and h.status in ("queued", "running"):
            eng.step()
        handles.append(h)
    eng.run_until_idle()
    for h in handles:
        if h.status != "done":
            raise AssertionError(f"the mixed engine's stream ended {h.status}: {h.error}")
    return [h.tokens for h in handles]


def disagg_125m(dtype, kv: str, prompts) -> tuple:
    """(a) at one precision: the handoff's readings, its streams against a
    mixed engine's (float32: equal outside ties of ``TIE_F32``; bf16 and
    the int8 cache: of ``TIE_BF16_SERVE``), and the model."""
    model = gen_model("125m", dtype, "auto", kv=kv)
    label = f"disagg 125m {str(dtype)[6:]} {kv}-cache"
    run = disagg_handoff(model, prompts, DISAGG_NEW, CACHE, label)
    ref = mixed_streams(model, prompts, DISAGG_NEW)
    margin = TIE_F32 if dtype == torch.float32 else TIE_BF16_SERVE
    run["vs_mixed"] = agree_or_tie(torch.tensor(run["tokens"]), torch.tensor(ref), model,
                                   [torch.tensor(p) for p in prompts], margin, f"{label} handoff vs mixed")
    run["mixed_tokens"] = ref
    return run, model


def disagg_live(model, prompts, sampled: bool) -> dict:
    """(b) Two mixed engines: stream A migrated mid-decode (4 tokens out)
    and stream B mid-prefill (3 of its chunks done), each continuing equal
    to its unmoved stream (sampled too: the generator's state moves); the
    migration's export makes one device sync a stream and the import none;
    no token is replayed and the receiver prefills only B's remaining
    chunks."""
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig

    sampling = SamplingConfig(temperature=0.8, top_p=0.9) if sampled else SamplingConfig(greedy=True)
    seeds = [7, 8]
    unmoved = [mixed_streams(model, [p], DISAGG_NEW, sampling, [s])[0] for p, s in zip(prompts, seeds)]
    src, dst = disagg_engine(model, sampling=sampling), disagg_engine(model, sampling=sampling)
    rec = link(src, dst, timed=False)
    a = src.submit(prompts[0], max_new_tokens=DISAGG_NEW, seed=seeds[0])
    while a.prefill_done_at is None and a.status in ("queued", "running"):
        src.step()
    b = src.submit(prompts[1], max_new_tokens=DISAGG_NEW, seed=seeds[1])
    for _ in range(3):
        src.step()
    fill = next(j.fill for j in src._prefilling.values() if j.handle is b)
    moved_at = [len(a.tokens), fill]
    if not (a.tokens and 0 < fill < len(prompts[1])):
        raise AssertionError(f"disagg live: not mid-decode and mid-prefill: {moved_at}")
    for h in (a, b):
        if not src.request_migration(h.rid, "http://peer"):
            raise AssertionError("disagg live: request_migration found no stream")
    syncs = gen_syncs(src._service_migrations)
    n_syncs = sum(c for _, c in syncs)
    if [a.status, b.status] != ["migrated", "migrated"] or n_syncs != 2:
        raise AssertionError(f"disagg live: {a.status}/{b.status}, {n_syncs} syncs for two exports: {syncs}")
    import_syncs = gen_syncs(dst._service_imports)
    if import_syncs:
        raise AssertionError(f"disagg live: placing two imports synced: {import_syncs}")
    dst.run_until_idle()
    conts = {h.rid: h for h in rec["handles"]}
    got = [a.tokens + conts[a.rid].tokens, b.tokens + conts[b.rid].tokens]
    chunks_left = -(-len(prompts[1]) // CHUNK) - fill // CHUNK
    if got != unmoved or dst.stats["prefill_chunks"] != chunks_left or dst.stats["import_replayed_tokens"]:
        raise AssertionError(f"disagg live ({'sampled' if sampled else 'greedy'}): moved {got} vs unmoved "
                             f"{unmoved}; receiver prefill chunks {dst.stats['prefill_chunks']} (want "
                             f"{chunks_left})")
    return {"moved_at_tokens_and_fill": moved_at, "export_syncs": syncs, "import_syncs": import_syncs,
            "streams_equal_unmoved": 2, "receiver_prefill_chunks": chunks_left, "encode_ms": rec["encode_ms"],
            "decode_ms": rec["decode_ms"], "wire_bytes": rec["wire_bytes"]}


def disagg_cli_start() -> dict:
    """(c)'s two processes, started when the phase starts (they load while
    (a) runs in this process): the serve CLI as ``--role prefill`` and
    ``--role decode``, 125m in float32 on the serving_policy phase's seed-0
    ``.npz`` (written here when that phase did not run)."""
    from zero_transformer_tpu_torch.convert import params_to_jax

    params = POLICY_DIR / "a.npz"
    if not params.exists():
        POLICY_DIR.mkdir(parents=True, exist_ok=True)
        np.savez(params, **params_to_jax(gen_model("125m", torch.float32, "auto").state_dict()))
    common = ["--model", "125m", "--params", str(params), "--server", "--port", "0", "--dtype", "float32",
              "--greedy", "--repetition-penalty", "1.0"]
    return {"prefill": cli_server(common + ["--role", "prefill", "--obs-dir", str(DISAGG_DIR / "obs")]),
            "decode": cli_server(common + ["--role", "decode"])}


def disagg_cli(procs: dict, prompt: list, expect: list, model) -> dict:
    """(c) The two serve CLI processes (``disagg_cli_start``): ``/healthz``
    names both roles; ``/generate`` with ``prefill_to`` ends its SSE
    ``migrated`` to the decode replica, whose ``/attach`` streams tokens
    equal to the in-process mixed engine's (``expect``, outside ties of
    ``TIE_F32``); a ship to a port nothing listens on ends the stream
    failed and retryable and dumps the flight recorder; SIGTERM stops both
    (exit 0)."""
    import signal
    import socket

    obs = DISAGG_DIR / "obs"
    t0 = time.perf_counter()
    outs = {role: [] for role in procs}
    reading = {}
    try:
        base = {role: cli_base(procs[role][1], outs[role], f"the {role} CLI") for role in procs}
        for role, url in base.items():
            for _ in range(600):
                try:
                    code, text = http("GET", url + "/healthz", timeout=10)
                except urllib.error.HTTPError as e:
                    code, text = e.code, e.read().decode()
                if code == 200:
                    break
                time.sleep(0.05)
            health = json.loads(text)
            if code != 200 or health["role"] != role:
                raise AssertionError(f"the {role} CLI's /healthz: {code} {health}")
            reading[f"healthz_{role}"] = {k: health[k] for k in ("role", "free_pages", "migrations_in_flight")}
        reading["startup_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        events = sse_post(base["prefill"] + "/generate", {"tokens": prompt, "max_new_tokens": DISAGG_NEW,
                                                          "prefill_to": base["decode"], "request_id": "disagg-cli"})
        t2 = time.perf_counter()
        done = events[-1]
        if done.get("status") != "migrated" or done.get("migrated_to") != base["decode"] or len(events) != 1:
            raise AssertionError(f"prefill CLI: {events[-3:]}")
        attached = sse_post(base["decode"] + "/attach", {"request_id": "disagg-cli"})
        t3 = time.perf_counter()
        tokens = [e["token"] for e in attached if "token" in e]
        if attached[-1].get("status") != "done" or len(tokens) != DISAGG_NEW:
            raise AssertionError(f"decode CLI /attach: {attached[-1]} after {len(tokens)} tokens")
        reading["vs_mixed"] = agree_or_tie(torch.tensor([tokens]), torch.tensor([expect]), model,
                                           [torch.tensor(prompt)], TIE_F32, "disagg CLI vs mixed engine")
        reading["handoff_ms"], reading["attach_ms"] = (t2 - t1) * 1e3, (t3 - t2) * 1e3
        with socket.socket() as probe:  # a port nothing listens on
            probe.bind(("127.0.0.1", 0))
            dead = probe.getsockname()[1]
        failed = sse_post(base["prefill"] + "/generate", {"tokens": prompt, "max_new_tokens": 4,
                                                          "prefill_to": f"http://127.0.0.1:{dead}"})[-1]
        dumps = sorted(p.name for p in (obs / "flightrec").glob("*migration_failed*"))
        if failed.get("status") != "failed" or not failed.get("retryable") or not dumps:
            raise AssertionError(f"a ship to a dead port: {failed}, flight dumps {dumps}")
        reading["dead_port"] = {"status": failed["status"], "retryable": failed["retryable"], "dumps": dumps}
        pre_m = json.loads(http("GET", base["prefill"] + "/metrics")[1])
        dec_m = json.loads(http("GET", base["decode"] + "/metrics")[1])
        want = {"prefill_handoffs": 1, "migration_failures": 1, "decode_ticks": 0}
        got = {k: pre_m[k] for k in want}
        got_d = {k: dec_m[k] for k in ("migrations_in", "prefill_chunks", "import_replayed_tokens")}
        if got != want or got_d != {"migrations_in": 1, "prefill_chunks": 0, "import_replayed_tokens": 0}:
            raise AssertionError(f"CLI counters: prefill {got}, decode {got_d}")
        for proc, _ in procs.values():
            proc.send_signal(signal.SIGTERM)
        for proc, _ in procs.values():
            proc.wait(120)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    codes = {role: proc.returncode for role, (proc, _) in procs.items()}
    if codes != {"prefill": 0, "decode": 0}:
        raise AssertionError(f"the CLIs exited {codes}")
    reading["exit"] = codes
    return reading


@contextlib.contextmanager
def attention_reads_checked(model, label: str):
    """Inside the block, every layer's attention read on the kernel path is
    held to the plain read of the same pools (``attention_impl="xla"``,
    which rewrites the same K/V first) at the bf16 bar, at the positions a
    row maps: parked rows (a zeroed table) and a window's tail past the
    prompt write to the trash page, which several rows share, so what they
    read there is whichever write landed last, and the engine drops it. A
    miss is recorded (raised inside the forward, the engine would take it
    for a tick fault) and raised at the end. Yields the largest errors and
    the reads counted, by prefill and decode."""
    import copy

    from zero_transformer_tpu_torch.ops.paged_attention import MAX_DECODE_T

    out = {"max_abs_err": {"prefill": 0.0, "decode": 0.0}, "reads": {"prefill": 0, "decode": 0},
           "tol": TOL[torch.bfloat16]}
    seen, missed = [], []
    hooks = [blk.attn.out.register_forward_pre_hook(lambda _m, args: seen.append(args[0].float()))
             for blk in model.blocks]
    fwd = type(model.blocks[0].attn).forward_paged

    def checked(x, pools, block_table, offsets, cache_len=None, flash=False, *, attn, plain):
        result = fwd(attn, x, pools, block_table, offsets, cache_len, flash)
        got = seen.pop()
        fwd(plain, x, pools, block_table, offsets, cache_len, flash)
        want = seen.pop()
        pos = offsets.long()[:, None] + torch.arange(x.shape[1], device=x.device)
        blocks = torch.clamp(pos // PAGE, max=block_table.shape[1] - 1)
        mapped = torch.gather(block_table.long(), 1, blocks) != 0
        kind = "prefill" if flash or x.shape[1] > MAX_DECODE_T else "decode"
        try:
            out["max_abs_err"][kind] = max(out["max_abs_err"][kind], compare(
                got[mapped], want[mapped], torch.bfloat16, f"{label} {kind} read"))
        except AssertionError as e:
            missed.append(str(e))
        out["reads"][kind] += 1
        return result

    for blk in model.blocks:
        plain = copy.copy(blk.attn)
        plain.cfg = dataclasses.replace(blk.attn.cfg, attention_impl="xla")
        blk.attn.forward_paged = functools.partial(checked, attn=blk.attn, plain=plain)
    try:
        yield out
    finally:
        for blk in model.blocks:
            del blk.attn.forward_paged
        for h in hooks:
            h.remove()
    if missed:
        raise AssertionError(f"{label}: attention reads beyond the bf16 bar: {missed[:3]}")


@contextlib.contextmanager
def kv_cache_dtype(model, kv: str):
    """``model``'s K/V cache in ``kv`` for the block (the same weights): the
    model's and each attention's config swapped, then restored."""
    old = model.cfg
    model.cfg = dataclasses.replace(old, kv_cache_dtype=kv)
    for blk in model.blocks:
        blk.attn.cfg = dataclasses.replace(blk.attn.cfg, kv_cache_dtype=kv)
    try:
        yield model
    finally:
        model.cfg = old
        for blk in model.blocks:
            blk.attn.cfg = dataclasses.replace(blk.attn.cfg, kv_cache_dtype=old.kv_cache_dtype)


def disagg_llama() -> dict:
    """(d) llama3_8b at LLAMA_CUT_LAYERS layers, bf16, then its cache in int8 (the same
    weights, held once): a 512-token prompt handed off between two engines
    over the model (pages bit-equal, exact launches), then again with every
    attention read held to the plain read of the same pools at the bf16
    bar."""
    model = gen_model(LLAMA, torch.bfloat16, "auto", n_layers=LLAMA_CUT_LAYERS)
    prompts = [list(prompt_text(DISAGG_LLAMA_T, 61).encode())]
    reading = {}
    for kv in ("auto", "int8"):
        with kv_cache_dtype(model, kv):
            label = f"disagg llama3_8b {kv}-cache"
            run = disagg_handoff(model, prompts, DISAGG_LLAMA_NEW, DISAGG_LLAMA_CACHE, label)
            with attention_reads_checked(model, label) as reads:
                checked = disagg_handoff(model, prompts, DISAGG_LLAMA_NEW, DISAGG_LLAMA_CACHE, label + " checked")
            run["reads"] = reads
            run["checked_tokens_equal"] = checked["tokens"] == run["tokens"]
            # the second handoff's legs, the pinned buffers of its sizes cached
            run["second_streams"] = checked["streams"]
            reading[kv] = run
    del model
    return reading


def disagg_phase() -> tuple:
    """Disaggregated roles and live stream migration on the card (the
    module doc, phase 21): (a) 125m handoffs in float32, bf16 and over an
    int8 cache; (b) live migration between two mixed engines, greedy and
    sampled; (c) the serve CLI as a prefill and a decode replica; (d)
    llama3_8b handoffs in bf16 and over an int8 cache; the kernel rows of K1
    on the prefill role and K4 over imported pages. Every part runs; the
    phase fails after them if any failed. Returns the rows and their
    launches (bf16 and int8 handoffs of (a))."""
    t_phase = time.perf_counter()
    rows, launches, failed, reading = {}, {}, [], {"card": card_line()}
    prompts = [list(prompt_text(n, 70 + i).encode()) for i, n in enumerate(DISAGG_LENS)]
    f32 = {}
    cli_procs = disagg_cli_start()

    def handoff(dtype, kv, key):
        run, model = disagg_125m(dtype, kv, prompts)
        reading[key] = {k: v for k, v in run.items() if k not in ("tokens", "mixed_tokens", "rids")}
        if dtype == torch.float32:
            f32.update(model=model, expect=run["mixed_tokens"][1])
            return
        if kv == "int8":
            launches["paged_attention_int8_disagg"] = run["decode_launches"]["paged_attention_int8"]
            return
        launches["flash_serving_fwd_disagg"] = run["prefill_launches"]["flash_serving_fwd"]
        launches["paged_attention_disagg"] = run["decode_launches"]["paged_attention"]
        reading["live_greedy"] = disagg_live(model, prompts[1:3], sampled=False)
        reading["live_sampled"] = disagg_live(model, prompts[1:3], sampled=True)

    def kernel_rows():
        gen_k1_row("flash_serving_fwd_disagg", 1, CHUNK, CACHE, H, H, D, [4 * CHUNK], True, rows)
        gen_k4_row("paged_attention_disagg", len(DISAGG_LENS), 1, CACHE, H, H, D, list(DISAGG_LENS), True, rows)
        gen_k4_row("paged_attention_int8_disagg", len(DISAGG_LENS), 1, CACHE, H, H, D, list(DISAGG_LENS), True, rows,
                   int8=True)

    parts = [("handoff float32", lambda: handoff(torch.float32, "auto", "handoff_f32")),
             ("cli", lambda: reading.__setitem__("cli", disagg_cli(cli_procs, prompts[1], f32["expect"],
                                                                  f32["model"]))),
             ("handoff bf16 and live migration", lambda: handoff(torch.bfloat16, "auto", "handoff_bf16")),
             ("handoff int8 cache", lambda: handoff(torch.bfloat16, "int8", "handoff_int8_cache")),
             ("llama3_8b", lambda: reading.__setitem__("llama3_8b", disagg_llama())),
             ("kernel rows", kernel_rows)]
    try:
        for what, part in parts:
            t0 = time.perf_counter()
            try:
                part()
            except (AssertionError, KeyError) as e:
                failed.append(what)
                log({"disagg_failed": what, "error": repr(e)})
            reading.setdefault("part_s", {})[what] = time.perf_counter() - t0
            if what == "cli":
                f32.clear()
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for proc, _ in cli_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    shutil.rmtree(DISAGG_DIR, ignore_errors=True)
    reading["disagg_s"] = time.perf_counter() - t_phase
    log({"disagg": reading})
    if failed:
        raise AssertionError(f"disagg: {failed} failed")
    return rows, launches


# ------------------------------------------------------------ slab serving

SLAB_DIR = Path("build") / "slab_serving"  # the CLI's flight dumps; deleted at the end of the phase
# (b): ten distinct prompt lengths past a cap of two buckets
SLAB_BUCKET_LENS, SLAB_BUCKETS_MAX, SLAB_BUCKET_NEW = (3, 9, 17, 33, 65, 129, 200, 257, 513, 700), 2, 8
SLAB_TICKS = 10  # decode ticks of (a)'s host and device ms and of (d)'s sync count
SLAB_AB_BLOCKS = 4  # (d): blocks of SLAB_TICKS ticks, fused and defused in turns
SLAB_LONE_T = 512  # (a): a lone prompt's TTFT, one-shot against 64-token chunks


def slab_engine(model, chunk: int = 0, **kw):
    """125m's serving engine on the slab layout: 4 slots, cache 1024, greedy
    unless ``sampling`` is given; ``chunk`` 0 is the one-shot prefill."""
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.serving import ServingEngine

    kw.setdefault("sampling", SamplingConfig(greedy=True))
    return ServingEngine(model, n_slots=SLOTS, cache_len=CACHE, kv_layout="slab", prefill_chunk=chunk,
                         device="cuda", **kw)


def host_buckets(lengths, cap: int, max_buckets: int) -> tuple:
    """The one-shot bucket rule written out from its statement: the smallest
    power of two >= the length, floor 8, at most ``cap``; past
    ``max_buckets`` distinct buckets a new one rounds up to the smallest
    bucket already used that fits, else to the cap, and is counted. Returns
    (each length's bucket, the count of capped lengths, distinct buckets)."""
    seen, out, capped = [], [], 0
    for n in lengths:
        b = min(max(8, 1 << (n - 1).bit_length()), cap)
        if b not in seen:
            if len(seen) >= max_buckets:
                capped += 1
                b = min([x for x in seen if x >= n] or [cap])
            if b not in seen:
                seen.append(b)
        out.append(b)
    return out, capped, len(seen)


def record_buckets(engine) -> list:
    """The bucket of each one-shot prefill ``engine`` runs from now on."""
    seen, bucket = [], engine._bucket

    def recording(n):
        seen.append(bucket(n))
        return seen[-1]

    engine._bucket = recording
    return seen


def slab_run(engine, prompts, new: int, seeds=None) -> dict:
    """Every request submitted at once and run to the end synchronously:
    the launch counts (zeroed just before, read just after), each request's
    TTFT and ITL (ms), the wall time and the snapshot; every request must
    end done with ``new`` tokens."""
    from zero_transformer_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=new, seed=seeds[i] if seeds else i) for i, p in enumerate(prompts)]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for h, p in zip(handles, prompts):
        if h.status != "done" or len(h.tokens) != new:
            raise AssertionError(f"a {len(p)}-token request ended {h.status} with {len(h.tokens)} tokens: {h.error}")
    return {"handles": handles, "launches": launches, "wall_s": wall, "snap": engine.metrics_snapshot(),
            "ttft_ms": [(h.first_token_at - h.submitted_at) * 1e3 for h in handles],
            "itl_ms": [(h.finished_at - h.first_token_at) * 1e3 / max(1, len(h.tokens) - 1) for h in handles]}


def lone_ttft_ms(engine, prompt) -> float:
    """TTFT of ``prompt`` alone on an idle engine (the second of two runs:
    the first warms the shapes), host clock to the first token."""
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        h = engine.submit(prompt, max_new_tokens=2)
        while not h.tokens and h.status in ("queued", "running"):
            engine.step()
        out.append((h.first_token_at - h.submitted_at) * 1e3)
        engine.run_until_idle()
    return out[-1]


def decode_tick_ms(engine, prompts, ticks: int = SLAB_TICKS) -> dict:
    """Host ms of ``ticks`` decode ticks with every slot decoding (the tick
    ends in its host sync) and the device's busy ms of as many more under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    for i, p in enumerate(prompts):
        engine.submit(p, max_new_tokens=2 * ticks + 8, seed=i)
    while engine.active_count < len(prompts):
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.step()
    host_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
    kernels = kernel_times(prof)
    engine.run_until_idle()
    busy = sum(ms for ms, _ in kernels.values())
    return {"host_ms_per_tick": host_ms, "device_busy_ms_per_tick": busy / ticks if kernels else "not measured"}


def slab_oneshot(f32_model) -> dict:
    """(a) The serving phase's six requests on the slab engine with the
    one-shot prefill: exact launches (K1 12 a prompt, K4 12 a decode tick,
    no chunk tick); bf16 reads within the bf16 bar (``attention_reads_
    checked``); float32 streams against ``generate()`` of each prompt alone
    (equal outside ties of ``TIE_F32``); buckets, TTFT, ITL, the paged
    engine's TTFT on the same requests, a lone 512-token prompt's TTFT on
    both, the tick's host and device ms. Returns the reading and the bf16
    run (the kernel rows' launches)."""
    from zero_transformer_tpu_torch.inference import SamplingConfig, generate

    prompts = [list(prompt_text(n, i).encode()) for i, n in enumerate(PROMPT_LENS)]
    model = gen_model("125m", torch.bfloat16, "auto")
    engine = slab_engine(model)
    buckets = record_buckets(engine)
    with attention_reads_checked(model, "slab one-shot") as checked:
        run = slab_run(engine, prompts, MAX_NEW)
    L, snap, launches = model.cfg.n_layers, run["snap"], run["launches"]
    want = {"flash_serving_fwd": L * len(prompts), "paged_attention": L * snap["decode_ticks"], "prefill_ticks": 0,
            "prefill_chunks": 0}
    got = {"flash_serving_fwd": launches["flash_serving_fwd"], "paged_attention": launches["paged_attention"],
           "prefill_ticks": snap["prefill_ticks"], "prefill_chunks": snap["prefill_chunks"]}
    if got != want:
        raise AssertionError(f"slab one-shot: counts {got} != predicted {want}")
    want_b = host_buckets([len(p) for p in prompts], CACHE, 8)
    if buckets != want_b[0] or snap["prefill_buckets"] != want_b[2] or snap["prefill_bucket_capped"]:
        raise AssertionError(f"slab one-shot buckets {buckets} ({snap['prefill_buckets']} distinct), host rule "
                             f"{want_b}")
    reading = {"prompt_lens": PROMPT_LENS, "buckets": buckets, "launches": got,
               "read_max_abs_err": checked["max_abs_err"], "reads": checked["reads"], "read_tol": checked["tol"]}
    timed = slab_run(slab_engine(model), prompts, MAX_NEW)  # untraced: the latency readings
    paged = slab_run(policy_engine(model, 0), prompts, MAX_NEW)
    reading.update(ttft_ms=timed["ttft_ms"], itl_ms=timed["itl_ms"], paged_ttft_ms=paged["ttft_ms"],
                   paged_itl_ms=paged["itl_ms"], wall_s=[timed["wall_s"], paged["wall_s"]])
    lone = list(prompt_text(SLAB_LONE_T, 33).encode())
    reading["lone_512_ttft_ms"] = {"oneshot": lone_ttft_ms(slab_engine(model), lone),
                                   "chunked_paged": lone_ttft_ms(policy_engine(model, 0), lone)}
    reading["tick"] = decode_tick_ms(slab_engine(model), [list(prompt_text(300, 70 + i).encode())
                                                          for i in range(SLOTS)])
    del engine, model
    gc.collect()
    # float32: each stream against generate() of its prompt alone
    f32 = slab_run(slab_engine(f32_model), prompts, MAX_NEW)
    greedy = SamplingConfig(greedy=True)
    ref = [generate(f32_model, torch.tensor([p]), MAX_NEW, sampling=greedy, cache_len=CACHE)[0].tolist()
           for p in prompts]
    ties = [agree_or_tie(torch.tensor([h.tokens]), torch.tensor([r]), f32_model, [torch.tensor(p)], TIE_F32,
                         f"slab one-shot float32, {len(p)} tokens") for h, r, p in zip(f32["handles"], ref, prompts)]
    reading["float32_vs_generate"] = {"rows_equal": sum(t["rows_equal"] for t in ties),
                                      "ties": [t["ties"] for t in ties if t["ties"]]}
    return reading, run


def slab_bucket_cap(f32_model) -> dict:
    """(b) Ten distinct lengths through a slab engine capped at two buckets:
    each prompt's bucket, ``prefill_bucket_capped`` and ``prefill_buckets``
    equal the host rule's, and each stream equals ``generate()`` of its
    prompt alone outside ties of ``TIE_F32``."""
    from zero_transformer_tpu_torch.inference import SamplingConfig, generate

    prompts = [list(prompt_text(n, 40 + i).encode()) for i, n in enumerate(SLAB_BUCKET_LENS)]
    engine = slab_engine(f32_model, max_prefill_buckets=SLAB_BUCKETS_MAX)
    buckets = record_buckets(engine)
    run = slab_run(engine, prompts, SLAB_BUCKET_NEW)
    want, capped, distinct = host_buckets(SLAB_BUCKET_LENS, CACHE, SLAB_BUCKETS_MAX)
    got = (buckets, run["snap"]["prefill_bucket_capped"], run["snap"]["prefill_buckets"])
    if got != (want, capped, distinct):
        raise AssertionError(f"bucket cap: engine {got}, host rule {(want, capped, distinct)}")
    greedy = SamplingConfig(greedy=True)
    ties = []
    for h, p in zip(run["handles"], prompts):
        ref = generate(f32_model, torch.tensor([p]), SLAB_BUCKET_NEW, sampling=greedy, cache_len=CACHE)
        ties.append(agree_or_tie(torch.tensor([h.tokens]), ref, f32_model, [torch.tensor(p)], TIE_F32,
                                 f"bucket cap, {len(p)} tokens"))
    return {"lens": SLAB_BUCKET_LENS, "buckets": buckets, "capped": got[1], "distinct": got[2],
            "rows_equal": sum(t["rows_equal"] for t in ties), "ties": [t["ties"] for t in ties if t["ties"]]}


def slab_prefix() -> dict:
    """(c) The serving_policy phase's burst (a 512-token system prompt, eight
    suffixes, the first alone until banked) on the chunked slab with the
    prefix cache (256 chunks: span copies) and on the paged engine (page
    sharing), bf16: hits, misses and chunks saved equal; streams equal
    outside ties of ``TIE_BF16_SERVE``; the bytes a hit copies, and the ms
    of one hit's copy (CUDA events) with its bound."""
    model = gen_model("125m", torch.bfloat16, "auto")
    prompts = policy_prompts(POLICY_SYSTEM, POLICY_SUFFIXES, 90)
    slab = slab_engine(model, CHUNK, prefix_cache_chunks=POLICY_CHUNKS)
    s = policy_burst(slab, prompts, POLICY_NEW)
    paged = policy_engine(model, POLICY_CHUNKS)
    p = policy_burst(paged, prompts, POLICY_NEW)
    no_cache = sum(-(-len(x) // CHUNK) for x in prompts)
    keys = ("prefix_hits", "prefix_misses")
    got = {**{k: s["snap"][k] for k in keys}, "chunks_saved": no_cache - s["snap"]["prefill_chunks"]}
    want = {**{k: p["snap"][k] for k in keys}, "chunks_saved": no_cache - p["snap"]["prefill_chunks"]}
    if got != want or got["chunks_saved"] != 7 * (POLICY_SYSTEM // CHUNK):
        raise AssertionError(f"slab prefix counts {got} != paged {want}")
    L = model.cfg.n_layers
    if s["launches"]["flash_serving_fwd"] != L * s["snap"]["prefill_ticks"] or \
            s["launches"]["paged_attention"] != L * s["snap"]["decode_ticks"]:
        raise AssertionError(f"slab prefix launches {s['launches']} vs ticks {s['snap']}")
    vs = agree_or_tie(torch.tensor([h.tokens for h in s["handles"]]), torch.tensor([h.tokens for h in p["handles"]]),
                      model, [torch.tensor(x) for x in prompts], TIE_BF16_SERVE, "slab prefix vs paged")
    # one hit's copy: the banked spans of the shared prefix into a free slot
    _, hits = slab._prefix_cache.walk(prompts[1])
    span_bytes_chunk = sum(t.numel() * t.element_size() for t in hits[0].values())
    slot = slab.slots.acquire()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    slab.slots.write_spans(hits, slot, slab.pools)
    start.record()
    for _ in range(10):
        slab.slots.write_spans(hits, slot, slab.pools)
    end.record()
    torch.cuda.synchronize()
    slab.slots.release([slot])
    copy_bytes = span_bytes_chunk * len(hits)
    reading = {**got, "rows_equal": vs["rows_equal"], "ties": vs["ties"], "span_bytes_per_chunk": span_bytes_chunk,
               "hit_chunks": len(hits), "hit_copy_ms": start.elapsed_time(end) / 10,
               "hit_copy_bound_ms": 2 * copy_bytes / HBM_BYTES_PER_S * 1e3,
               "ttft_ms_p50_hits": [sorted(s["ttft_ms"][1:])[3], sorted(p["ttft_ms"][1:])[3]],
               "order": "slab, paged"}
    want_bytes = CHUNK * L * model.cfg.d_model * 2 * 2
    if span_bytes_chunk != want_bytes:
        raise AssertionError(f"a chunk's span holds {span_bytes_chunk} bytes, predicted {want_bytes}")
    return reading


def slab_defused() -> dict:
    """(d) ``fused_tail=False`` against the fused tick on the one-shot slab,
    bf16, greedy and sampled (the serve CLI's sampling defaults): streams
    byte-identical; over ``SLAB_TICKS`` decode ticks of four streams, one
    host sync a tick more (``set_sync_debug_mode``). The host ms a tick of
    each: one engine's four streams, the setting switched every
    ``SLAB_TICKS`` ticks over ``SLAB_AB_BLOCKS`` blocks of each (host ticks
    spread 1.5-2x, so a comparison needs turns), the medians of the blocks."""
    from zero_transformer_tpu_torch.inference import SamplingConfig

    model = gen_model("125m", torch.bfloat16, "auto")
    prompts = [list(prompt_text(n, 60 + i).encode()) for i, n in enumerate((100, 200, 300, 400))]
    reading = {}
    for label, sampling in (("greedy", SamplingConfig(greedy=True)), ("sampled", SamplingConfig(**GEN_SAMPLED))):
        streams, syncs = {}, {}
        for fused in (True, False):
            engine = slab_engine(model, sampling=sampling, fused_tail=fused)
            handles = [engine.submit(p, max_new_tokens=3 * SLAB_TICKS + 4, seed=i) for i, p in enumerate(prompts)]
            while engine.active_count < len(prompts):
                engine.step()
            engine.step()
            syncs[fused] = len(res_count_syncs(lambda: [engine.step() for _ in range(SLAB_TICKS)])) / SLAB_TICKS
            engine.run_until_idle()
            streams[fused] = [h.tokens for h in handles]
            if any(h.status != "done" for h in handles):
                raise AssertionError(f"fused_tail={fused} {label}: {[h.status for h in handles]}")
        if streams[True] != streams[False]:
            raise AssertionError(f"fused_tail=False {label} streams differ from the fused tick's")
        if syncs[False] != syncs[True] + 1:
            raise AssertionError(f"{label}: host syncs a tick fused {syncs[True]}, defused {syncs[False]}")
        reading[label] = {"syncs_per_tick": [syncs[True], syncs[False]], "order": "fused, defused"}
    engine = slab_engine(model)
    for i, p in enumerate(prompts):
        engine.submit(p, max_new_tokens=2 * SLAB_AB_BLOCKS * SLAB_TICKS + 8, seed=i)
    while engine.active_count < len(prompts):
        engine.step()
    blocks = {True: [], False: []}
    for b in range(2 * SLAB_AB_BLOCKS):
        engine.fused_tail = b % 2 == 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SLAB_TICKS):
            engine.step()
        blocks[engine.fused_tail].append((time.perf_counter() - t0) * 1e3 / SLAB_TICKS)
    engine.run_until_idle()
    reading["host_ms_per_tick_blocks"] = {"fused": blocks[True], "defused": blocks[False]}
    reading["host_ms_per_tick_median"] = [sorted(blocks[f])[SLAB_AB_BLOCKS // 2] for f in (True, False)]
    return reading


def slab_cli_start(f32_model):
    """(e)'s process, started when the phase starts (it loads while (a)-(d)
    run in this process): ``python -m zero_transformer_tpu_torch.serve
    --server --prefill-chunk 0`` on 125m in float32, the kept seed-0
    ``.npz``."""
    from zero_transformer_tpu_torch.convert import params_to_jax

    params = POLICY_DIR / "a.npz"
    if not params.exists():  # the serving_policy phase did not run
        POLICY_DIR.mkdir(parents=True, exist_ok=True)
        np.savez(params, **params_to_jax(f32_model.state_dict()))
    return cli_server(["--model", "125m", "--params", str(params), "--server", "--port", "0", "--dtype", "float32",
                       "--greedy", "--repetition-penalty", "1.0", "--prefill-chunk", "0", "--obs-dir",
                       str(SLAB_DIR / "obs")])


def slab_cli(f32_model, proc, lines) -> dict:
    """(e) The serve CLI with ``--prefill-chunk 0`` (``slab_cli_start``):
    JAX's fallback message, ``/healthz`` on the slab layout, one request
    answered equal to an in-process slab engine outside ties of
    ``TIE_F32``, SIGTERM exits 0."""
    import signal

    out, reading = [], {}
    try:
        base = cli_base(lines, out, "the slab CLI")
        message = ("serve: --prefill-chunk 0 (legacy one-shot prefill) has no block-table path; falling back to "
                   "--kv-layout slab")
        if not any(message in line for line in out):
            raise AssertionError(f"the slab CLI did not print JAX's fallback message: {out[-10:]}")
        health = wait_ready(base)
        if health["kv_layout"] != "slab":
            raise AssertionError(f"the slab CLI's /healthz: {health}")
        prompt = list(prompt_text(300, 11).encode())
        events = sse_post(base + "/generate", {"tokens": prompt, "max_new_tokens": MAX_NEW})
        tokens = [e["token"] for e in events if "token" in e]
        if events[-1].get("status") != "done" or len(tokens) != MAX_NEW:
            raise AssertionError(f"the slab CLI's stream: {events[-1]} after {len(tokens)} tokens")
        engine = slab_engine(f32_model)
        h = engine.submit(prompt, max_new_tokens=MAX_NEW)
        engine.run_until_idle()
        reading["vs_engine"] = agree_or_tie(torch.tensor([tokens]), torch.tensor([h.tokens]), f32_model,
                                            [torch.tensor(prompt)], TIE_F32, "slab CLI vs in-process engine")
        snap = json.loads(http("GET", base + "/metrics")[1])
        reading["metrics"] = {k: snap[k] for k in ("kv_layout", "prefill_buckets", "prefill_ticks", "fused_tail")}
        if reading["metrics"] != {"kv_layout": "slab", "prefill_buckets": 1, "prefill_ticks": 0, "fused_tail": 1}:
            raise AssertionError(f"the slab CLI's metrics: {reading['metrics']}")
        proc.send_signal(signal.SIGTERM)
        proc.wait(120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"the slab CLI exited {proc.returncode}: {out[-10:]}")
    reading["exit"] = proc.returncode
    return reading


def wait_ready(base: str, timeout: float = 300.0) -> dict:
    """Poll ``base``'s ``/healthz`` until it answers 200; its body."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            code, text = http("GET", base + "/healthz", timeout=10)
        except (urllib.error.HTTPError, urllib.error.URLError, OSError):
            code, text = 0, "{}"
        if code == 200:
            return json.loads(text)
        if time.monotonic() > deadline:
            raise AssertionError(f"{base}/healthz never answered 200")
        time.sleep(0.05)


def slab_serving_phase() -> tuple:
    """The slab layout on the card (the module doc, phase 22): (a) the
    one-shot prefill, (b) the bucket cap, (c) the chunked slab with the
    prefix cache against the paged engine, (d) the fused-tail control, (e)
    the serve CLI's ``--prefill-chunk 0``; the kernel rows of K1 on a
    512-token bucket over 1,024 keys and K4 on the slab's decode. Every part
    runs; the phase fails after them if any failed. Returns the rows and
    their launches ((a)'s bf16 run)."""
    t_phase = time.perf_counter()
    rows, launches, failed, reading = {}, {}, [], {"card": card_line()}
    f32 = {"model": gen_model("125m", torch.float32, "auto")}
    cli = slab_cli_start(f32["model"])

    def oneshot():
        reading["oneshot"], run = slab_oneshot(f32["model"])
        launches["flash_serving_fwd_oneshot"] = run["launches"]["flash_serving_fwd"]
        launches["paged_attention_slab"] = run["launches"]["paged_attention"]

    def kernel_rows():
        gen_k1_row("flash_serving_fwd_oneshot", 1, SLAB_LONE_T, CACHE, H, H, D, [0], True, rows)
        gen_k4_row("paged_attention_slab", SLOTS, 1, CACHE, H, H, D, [n + MAX_NEW // 2 for n in PROMPT_LENS[:SLOTS]],
                   True, rows)

    # the untimed bucket-cap check first, while the CLI process loads
    parts = [("bucket cap", lambda: reading.__setitem__("bucket_cap", slab_bucket_cap(f32["model"]))),
             ("one-shot", oneshot),
             ("prefix", lambda: reading.__setitem__("prefix", slab_prefix())),
             ("fused tail", lambda: reading.__setitem__("fused_tail", slab_defused())),
             ("cli", lambda: reading.__setitem__("cli", slab_cli(f32["model"], *cli))),
             ("kernel rows", kernel_rows)]
    try:
        for what, part in parts:
            t0 = time.perf_counter()
            try:
                part()
            except (AssertionError, KeyError) as e:
                failed.append(what)
                log({"slab_serving_failed": what, "error": repr(e)})
            reading.setdefault("part_s", {})[what] = time.perf_counter() - t0
            if what == "cli":
                f32.clear()
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if cli[0].poll() is None:
            cli[0].kill()
            cli[0].wait()
    shutil.rmtree(SLAB_DIR, ignore_errors=True)
    reading["slab_serving_s"] = time.perf_counter() - t_phase
    log({"slab_serving": reading})
    if failed:
        raise AssertionError(f"slab_serving: {failed} failed")
    return rows, launches


# ------------------------------------------------------------------ router

ROUTER_DIR = Path("build") / "router"  # the router's obs directory; deleted at the end of the phase
ROUTER_SHARED, ROUTER_NEW = 256, 32  # (a): a 256-token shared prompt (4 chunks of 64), 32 new tokens
ROUTER_KILL_AFTER, ROUTER_LONG_NEW = 8, 96  # (c): SIGKILL after 8 tokens of a 96-token stream
ROUTER_AB = 3  # routed and direct requests in turns, for the router's added TTFT and ITL
ROUTER_RELOAD_NEW = 300  # (b): streams long enough to be live through both replicas' reloads


def sse_timed(url: str, body: dict, on_token=None) -> tuple:
    """POST an SSE request and read it event by event: (events, the host
    time of each). ``on_token(n)`` runs after the n-th token arrives."""
    import http.client
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=300)
    events, times = [], []
    try:
        conn.request("POST", parts.path, json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"{url}: HTTP {resp.status} {resp.read()[:300]}")
        while True:
            line = resp.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            events.append(json.loads(line[6:]))
            times.append(time.perf_counter())
            if "token" in events[-1] and on_token is not None:
                on_token(sum(1 for e in events if "token" in e))
            if events[-1].get("done"):
                break
    finally:
        conn.close()
    return events, times


def sse_tokens(events) -> list:
    return [e["token"] for e in events if "token" in e]


def router_metrics(base: str) -> dict:
    return json.loads(http("GET", base + "/metrics")[1])


def router_phase() -> dict:
    """The fleet router on the card (the module doc, phase 23): 125m in bf16
    on the kept seed-0 ``.npz``. Processes: two mixed replicas (the serve
    CLI and ``serve_router --replica-worker`` on the same seed's weights),
    a ``--role prefill`` and a ``--role decode`` serve CLI, and a router in
    front of each pair (``python -m zero_transformer_tpu_torch.serve_router``).
    (a) requests on one shared prompt go where ``PrefixAffinity`` sends them,
    the SSE ids equal a direct request's, both replicas report
    ``kernel_paged_attention`` 1 on ``/healthz`` and ``/metrics``; (e) the
    router's Prometheus ``/metrics`` parses with ``parse_exposition``,
    ``/slo`` answers with every default objective, ``/admin/trace`` passes
    ``verify_stitched``; (b) a rolling ``POST /admin/reload`` with two live
    streams drops none; (c) SIGKILL of the replica serving a live stream
    after 8 tokens: the stream resumes on the survivor and equals the
    unkilled stream outside ties of ``TIE_BF16_SERVE``, one failover, the
    replayed tokens the tokens the dead replica relayed; (d) one
    disaggregated dispatch, none replayed, the stream equal to the mixed
    one. Every child exits 0 on SIGTERM but the killed one. Prints each
    part's seconds."""
    import signal

    from zero_transformer_tpu_torch.convert import params_to_jax
    from zero_transformer_tpu_torch.obs import parse_exposition, verify_stitched
    from zero_transformer_tpu_torch.obs.slo import default_objectives
    from zero_transformer_tpu_torch.serving.router import PrefixAffinity

    t_phase = time.perf_counter()
    reading, failed = {"card": card_line()}, []
    model = gen_model("125m", torch.bfloat16, "auto")  # the tie gaps' reference
    params = POLICY_DIR / "a.npz"
    if not params.exists():  # the serving_policy phase did not run
        POLICY_DIR.mkdir(parents=True, exist_ok=True)
        f32 = gen_model("125m", torch.float32, "auto")
        np.savez(params, **params_to_jax(f32.state_dict()))
        del f32
    serve = ["--model", "125m", "--params", str(params), "--server", "--port", "0", "--greedy",
             "--repetition-penalty", "1.0"]
    procs = {
        "cli": cli_server(serve),
        "worker": module_proc("zero_transformer_tpu_torch.serve_router", [
            "--replica-worker", "--model", "125m", "--init-seed", str(SEED), "--dtype", "bfloat16", "--port", "0",
            "--greedy", "--slots", str(SLOTS), "--cache-len", str(CACHE), "--prefill-chunk", str(CHUNK),
            "--page-size", str(PAGE), "--prefix-cache", str(POLICY_CHUNKS)]),
        "prefill": cli_server(serve + ["--role", "prefill"]),
        "decode": cli_server(serve + ["--role", "decode"]),
    }
    outs = {k: [] for k in procs}
    killed = set()
    part_s = reading.setdefault("part_s", {})
    try:
        t0 = time.perf_counter()
        base = {k: cli_base(procs[k][1], outs[k], f"the {k} CLI") for k in ("cli", "prefill", "decode")}
        base["worker"] = "http://127.0.0.1:" + printed(procs["worker"][1], outs["worker"], r"REPLICA_PORT=(\d+)",
                                                       "the replica worker")
        health = {k: wait_ready(url) for k, url in base.items()}
        router_args = ["--port", "0", "--chunk-tokens", str(CHUNK), "--probe-interval", "0.1", "--stream-timeout",
                       "120", "--metrics-scrape-interval", "0.25", "--obs-dir", str(ROUTER_DIR / "obs")]
        routers = (("router", ("cli", "worker")), ("router_pd", ("prefill", "decode")))
        for name, pair in routers:  # both start at once
            procs[name] = module_proc("zero_transformer_tpu_torch.serve_router",
                                      [a for k in pair for a in ("--replica", base[k])] + router_args)
            outs[name] = []
        for name, _ in routers:
            base[name] = printed(procs[name][1], outs[name], r"routing on (http://[0-9.]+:[0-9]+)", name)
            wait_ready(base[name])
        part_s["startup"] = time.perf_counter() - t0
        mixed = {k: f"{base[k].split('//')[1]}" for k in ("cli", "worker")}  # the router's replica ids

        def part(what, fn):
            t1 = time.perf_counter()
            try:
                reading[what] = fn()
            except (AssertionError, KeyError) as e:
                failed.append(what)
                log({"router_failed": what, "error": repr(e)})
            part_s[what] = time.perf_counter() - t1

        head = list(prompt_text(ROUTER_SHARED, 21).encode())
        prompts = [head + list(prompt_text(n, 22 + i).encode()) for i, n in enumerate((10, 30, 50, 70))]

        def affinity():
            got = {}
            for k in ("cli", "worker"):
                if health[k].get("kv_layout") != "paged" or health[k].get("kernel_paged_attention") != 1:
                    raise AssertionError(f"{k}'s /healthz: {health[k]}")
                prom = parse_exposition(urllib.request.urlopen(urllib.request.Request(
                    base[k] + "/metrics", headers={"Accept": "text/plain"}), timeout=30).read().decode())
                flag = json.loads(http("GET", base[k] + "/metrics")[1])["kernel_paged_attention"]
                got[k] = {"healthz_kernel_paged_attention": health[k]["kernel_paged_attention"],
                          "metrics_kernel_paged_attention": flag, "prometheus_families": len(prom)}
                if flag != 1:
                    raise AssertionError(f"{k} does not run K4: {flag}")
            host = PrefixAffinity(chunk_tokens=CHUNK)
            routed, direct = [], {}
            for i, p in enumerate(prompts):
                doc = json.loads(http("POST", base["router"] + "/generate", {
                    "tokens": p, "max_new_tokens": ROUTER_NEW, "stream": False, "request_id": f"aff-{i}"})[1])
                want = host.lookup(p)
                if doc.get("status") != "done" or (want is not None and doc["replica"] != want):
                    raise AssertionError(f"request {i} went to {doc.get('replica')}, the host rule says {want}: "
                                         f"{doc.get('status')}")
                host.record(p, doc["replica"])
                routed.append(doc["replica"])
            events, _ = sse_timed(base["router"] + "/generate", {"tokens": prompts[0], "max_new_tokens": ROUTER_NEW,
                                                                 "request_id": "trace-me"})
            for k in ("cli", "worker"):
                direct[k] = sse_tokens(sse_post(base[k] + "/generate", {"tokens": prompts[0],
                                                                         "max_new_tokens": ROUTER_NEW}))
            if events[-1].get("status") != "done" or not (sse_tokens(events) == direct["cli"] == direct["worker"]):
                raise AssertionError(f"routed SSE ids differ from a direct request's: {events[-1]}")
            got.update(routed=routed, host_rule=[host.lookup(p) for p in prompts],
                       affinity_hits=router_metrics(base["router"])["affinity_hits"])
            reading["_direct"] = direct["cli"]
            return got

        def fleet_views():
            text = urllib.request.urlopen(urllib.request.Request(base["router"] + "/metrics", headers={
                "Accept": "text/plain"}), timeout=30).read().decode()
            fams = parse_exposition(text)
            if not any(k.startswith("fleet_") for k in fams) or "router_requests_total" not in fams:
                raise AssertionError(f"the router's Prometheus text lacks the fleet families: {sorted(fams)[:20]}")
            slo = json.loads(http("GET", base["router"] + "/slo")[1])
            names = {o.name for o in default_objectives()}
            if not names <= set(slo.get("objectives", {})):
                raise AssertionError(f"/slo objectives {sorted(slo.get('objectives', {}))}, defaults {sorted(names)}")
            doc = json.loads(http("GET", base["router"] + "/admin/trace?request_id=trace-me")[1])
            verdict = verify_stitched(doc, "trace-me", slack_s=0.25)
            if verdict["orphans"] or verdict["coverage"] < 0.95:
                raise AssertionError(f"the stitched trace: {verdict}")
            return {"families": len(fams), "slo_verdict": slo.get("verdict"), "objectives": sorted(slo["objectives"]),
                    "trace": {k: verdict[k] for k in ("coverage", "orphans", "hops_ordered", "spans")}}

        def rolling_reload():
            results = {}

            def client(i):
                results[i] = sse_timed(base["router"] + "/generate", {"tokens": prompts[1 + i],
                                                                      "max_new_tokens": ROUTER_RELOAD_NEW})[0]

            threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            time.sleep(0.3)
            code, text = http("POST", base["router"] + "/admin/reload", {"params": str(params),
                                                                          "drain_timeout": 120,
                                                                          "ready_timeout": 120})
            doc = json.loads(text)
            for t in threads:
                t.join(300)
            done = [results.get(i, [{}])[-1].get("status") for i in range(2)]
            lens = [len(sse_tokens(results.get(i, []))) for i in range(2)]
            if code != 200 or not doc.get("reloaded") or doc.get("dropped_streams") != 0 or \
                    done != ["done", "done"] or lens != [ROUTER_RELOAD_NEW] * 2:
                raise AssertionError(f"rolling reload: HTTP {code} {doc}, streams {done} {lens}")
            return {"dropped_streams": doc["dropped_streams"], "replicas": doc.get("replicas"), "stream_s": [
                        results[i][-1].get("ledger", {}).get("relay_ms") for i in range(2)],
                    "migration_resumes": router_metrics(base["router"]).get("migration_resumes")}

        def failover():
            before = router_metrics(base["router"])
            victim = {}
            prompt = prompts[3]

            def on_token(n):
                if n == ROUTER_KILL_AFTER and not victim:
                    reps = router_metrics(base["router"])["replicas"]
                    rid = next(r for r, v in reps.items() if v.get("active_relays"))
                    name = next(k for k, v in mixed.items() if v == rid)
                    procs[name][0].send_signal(signal.SIGKILL)
                    killed.add(name)
                    victim.update(name=name, rid=rid, t=time.perf_counter())

            events, times = sse_timed(base["router"] + "/generate", {"tokens": prompt,
                                                                     "max_new_tokens": ROUTER_LONG_NEW,
                                                                     "request_id": "failover"}, on_token)
            done = events[-1]
            tokens = sse_tokens(events)
            if done.get("status") != "done" or done.get("failovers") != 1 or len(tokens) != ROUTER_LONG_NEW:
                raise AssertionError(f"failover: {done} after {len(tokens)} tokens")
            after = router_metrics(base["router"])
            relayed = after["replicas"][victim["rid"]]["tokens_relayed"] - before["replicas"][victim["rid"]][
                "tokens_relayed"]
            replayed = done["ledger"]["resume_replayed_tokens"]
            if after["failovers"] - before["failovers"] != 1 or replayed != relayed or not \
                    ROUTER_KILL_AFTER <= replayed < ROUTER_LONG_NEW:
                raise AssertionError(f"failover counts: {after['failovers'] - before['failovers']} failovers, "
                                     f"{replayed} replayed, {relayed} relayed by the dead replica")
            survivor = next(k for k in mixed if k != victim["name"])
            ref = sse_tokens(sse_post(base[survivor] + "/generate", {"tokens": prompt,
                                                                      "max_new_tokens": ROUTER_LONG_NEW}))
            vs = agree_or_tie(torch.tensor([tokens]), torch.tensor([ref]), model, [torch.tensor(prompt)],
                              TIE_BF16_SERVE, "failover vs the unkilled stream")
            gaps = [b - a for a, b in zip(times, times[1:])]
            return {"victim": victim["name"], "replayed_tokens": replayed, "failovers": 1,
                    "gap_ms": max(gaps) * 1e3, "itl_ms_p50": sorted(gaps)[len(gaps) // 2] * 1e3, **vs}

        def split():
            before = router_metrics(base["router_pd"])
            events, times = sse_timed(base["router_pd"] + "/generate", {"tokens": prompts[0],
                                                                        "max_new_tokens": ROUTER_NEW})
            after = router_metrics(base["router_pd"])
            tokens = sse_tokens(events)
            d = {k: after[k] - before.get(k, 0) for k in ("disagg_dispatches", "resume_replayed_tokens")}
            if events[-1].get("status") != "done" or d != {"disagg_dispatches": 1, "resume_replayed_tokens": 0}:
                raise AssertionError(f"prefill/decode split: {events[-1]}, {d}")
            vs = agree_or_tie(torch.tensor([tokens]), torch.tensor([reading["_direct"]]), model,
                              [torch.tensor(prompts[0])], TIE_BF16_SERVE, "split vs mixed")
            return {**d, **vs}

        def overhead():
            """TTFT and ITL p50 of one request routed and sent straight to
            the replica that serves it, in turns (routed, direct, direct,
            routed, ...): the medians of ``ROUTER_AB`` of each."""
            p = prompts[2]
            runs = {"routed": [], "direct": []}
            target = None
            for i in range(2 * ROUTER_AB):
                label = ("routed", "direct")[(i + i // 2) % 2]
                if label == "direct" and target is None:
                    continue
                url = base["router"] if label == "routed" else "http://" + target
                t0 = time.perf_counter()
                _, times = sse_timed(url + "/generate", {"tokens": p, "max_new_tokens": ROUTER_NEW})
                gaps = sorted(b - a for a, b in zip(times[:-1], times[1:-1]))
                runs[label].append(((times[0] - t0) * 1e3, gaps[len(gaps) // 2] * 1e3))
                if target is None:
                    reps = router_metrics(base["router"])["replicas"]
                    target = max(reps, key=lambda r: reps[r]["tokens_relayed"])
            return {label: {"ttft_ms_median": sorted(t for t, _ in r)[len(r) // 2],
                            "itl_ms_p50_median": sorted(g for _, g in r)[len(r) // 2], "runs": len(r)}
                    for label, r in runs.items()}

        part("affinity", affinity)
        part("fleet_views", fleet_views)
        part("overhead", overhead)
        part("rolling_reload", rolling_reload)
        part("failover", failover)
        part("split", split)
        reading.pop("_direct", None)
        for name, (proc, _) in procs.items():
            if name not in killed:
                proc.send_signal(signal.SIGTERM)
        for name, (proc, _) in procs.items():
            proc.wait(120)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    codes = {name: proc.returncode for name, (proc, _) in procs.items() if name not in killed}
    reading["exit"] = codes
    if any(codes.values()):
        failed.append("exit codes")
        log({"router_failed": "exit codes", "codes": codes, "tail": {k: outs[k][-5:] for k in codes if codes[k]}})
    if len(killed) != 1:
        failed.append("kill")
    del model
    shutil.rmtree(ROUTER_DIR, ignore_errors=True)
    reading["router_s"] = time.perf_counter() - t_phase
    log({"router": reading})
    if failed:
        raise AssertionError(f"router: {failed} failed")
    return reading


# ------------------------------------------ tensor-parallel serving (TP 2)

TP_RANKS = 2
TP_DIR = Path("build") / "tensor_serving"  # the ranks' results and the references; deleted after the phase
TP_LLAMA_LENS, TP_LLAMA_NEW, TP_LLAMA_CACHE = (40, 300, 600), 16, 2048  # (c): llama3_8b's requests
TP_B_LENS, TP_B_NEW = PROMPT_LENS[:4], 16  # (b): the serving requests' first four, cut for the run's time
TP_PROFILE_LEN = 128  # (a)'s profiled tick: four streams of two prefill chunks each
TP_PROFILE_TICKS = 3
TP_FORCED = 4  # (a): rows of the forced prefill + decode step whose logits are held at 2e-4


def tp_prompts(lens, salt: int = 0) -> list:
    return [list(prompt_text(n, salt + i).encode()) for i, n in enumerate(lens)]


def tp_engine(model, cache_len: int = CACHE, **kw):
    """The serving engine the phase runs on one card and on each rank: the
    serving phase's geometry, greedy."""
    from zero_transformer_tpu_torch.inference.sampling import SamplingConfig
    from zero_transformer_tpu_torch.serving import ServingEngine

    return ServingEngine(model, n_slots=SLOTS, cache_len=cache_len, sampling=SamplingConfig(greedy=True),
                         prefill_chunk=CHUNK, page_size=PAGE, device=next(model.parameters()).device, **kw)


def tp_streams(engine, prompts, new: int) -> list:
    """Every prompt submitted at once, the engine run to idle: the greedy
    streams, in order."""
    handles = [engine.submit(p, max_new_tokens=new) for p in prompts]
    engine.run_until_idle()
    return [h.tokens for h in handles]


def tp_forced(engine, prompts) -> list:
    """The engine's own device program on an idle engine: each prompt
    prefilled in one window through K1 (rows on pages 1 + b * n_blocks on),
    then one decode step of its greedy token through K4. Returns the last
    prefill logits and the step's logits [B, V] on the host."""
    B, dev = len(prompts), engine.device
    n_blocks = engine.cache_len // PAGE
    table = (1 + torch.arange(B * n_blocks, dtype=torch.int32, device=dev)).view(B, n_blocks)
    T = max(len(p) for p in prompts)
    tokens = torch.tensor([p + [0] * (T - len(p)) for p in prompts], device=dev)
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    with torch.no_grad():
        first = engine.forward_logits(tokens, table, torch.zeros(B, dtype=torch.int32, device=dev), flash=True,
                                      pick=lens - 1)
        step = engine.forward_logits(first.argmax(-1)[:, None], table, lens.int(),
                                     pick=torch.zeros(B, dtype=torch.long, device=dev))
    return [first.cpu(), step.cpu()]


def tp_gaps(model, prompts, streams) -> list:
    """Per stream, the one-card model's top-2 logit gap before each of its
    greedy tokens (one full forward over the prompt and the stream). The
    head runs in float32 on the final hidden states: bf16 logits near the
    top (|x| 4-8 here) are quantized to 0.03125, coarser than the 0.03 bar
    itself, so a gap read off them is 0, 0.03125 or 0.0625 whatever the
    product's own gap."""
    gaps = []
    with torch.no_grad():
        for p, s in zip(prompts, streams):
            tokens = torch.tensor([p + s], device="cuda")
            h = model._blocks(model._embed(tokens, None, torch.arange(tokens.shape[1], device="cuda")), None)
            h = model.ln_f(h)[0, len(p) - 1:len(p) - 1 + len(s)]
            logits = h.float() @ model.head_weight().float()
            top2 = torch.topk(logits, 2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().tolist())
    return gaps


def tp_one_card_references(out: Path) -> dict:
    """(a) and (c) on one card, before the ranks take it: 125m float32's
    streams, launches and forced logits; llama3_8b bf16's streams, forced
    logits, the top-2 gaps along the streams and its bytes; in float32 at
    32 layers its forced logits (the bf16 bar: one card's own bf16-to-
    float32 spread), and at ``GEN_LLAMA_F32_LAYERS`` its streams and gaps.
    Saved for the checks after the ranks; the models freed."""
    from zero_transformer_tpu_torch.ops import _build

    ref = {}
    model = gen_model("125m", torch.float32, "auto")
    engine = tp_engine(model)
    ref["f32_forced"] = tp_forced(engine, tp_prompts(PROMPT_LENS[:TP_FORCED], 50))  # also the warm-up
    _build.reset_launches()
    ref["f32_streams"] = tp_streams(engine, tp_prompts(PROMPT_LENS), MAX_NEW)
    ref["f32_launches"] = {k: c for k, c in _build.LAUNCHES.items() if c}
    ref["f32_bytes"] = {"weight_bytes": engine.weight_bytes, "kv_pool_bytes": engine.kv_pool_bytes}
    del engine, model
    model = gen_model(LLAMA, torch.bfloat16, "auto")
    engine = tp_engine(model, TP_LLAMA_CACHE)
    prompts = tp_prompts(TP_LLAMA_LENS, 70)
    _build.reset_launches()
    ref["llama_streams"] = tp_streams(engine, prompts, TP_LLAMA_NEW)
    ref["llama_launches"] = {k: c for k, c in _build.LAUNCHES.items() if c}
    ref["llama_bytes"] = {"weight_bytes": engine.weight_bytes, "kv_pool_bytes": engine.kv_pool_bytes}
    ref["llama_forced"] = tp_forced(engine, prompts)
    ref["llama_gaps"] = tp_gaps(model, prompts, ref["llama_streams"])
    del engine, model
    model = gen_model(LLAMA, torch.float32, "auto")
    ref["llama_f32_forced"] = tp_forced(tp_engine(model, TP_LLAMA_CACHE), prompts)
    del model
    model = gen_model(LLAMA, torch.float32, "auto", n_layers=GEN_LLAMA_F32_LAYERS)
    engine = tp_engine(model, TP_LLAMA_CACHE)
    ref["llama_f32_streams"] = tp_streams(engine, prompts, TP_LLAMA_NEW)
    ref["llama_f32_gaps"] = tp_gaps(model, prompts, ref["llama_f32_streams"])
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(ref, out / "one_card.pt")
    return ref


def tp_session(engine, group, lead):
    """One run of ``engine`` over the group whose launch counts every rank
    reads: the counts zeroed on every rank, then rank 0 runs ``lead()``
    while the others follow its plans; the counts read just after.
    Returns (``lead()``'s result on rank 0, this rank's launches)."""
    from zero_transformer_tpu_torch.ops import _build

    torch.cuda.synchronize(group.device)
    _build.reset_launches()
    group.barrier()
    result = None
    if group.rank == 0:
        engine._workers_stopped = False  # the others are back in serve_worker: plans may go out again
        result = lead()
        engine.shutdown_workers()
    else:
        engine.serve_worker()
    torch.cuda.synchronize(group.device)
    return result, {k: c for k, c in _build.LAUNCHES.items() if c}


def tp_model(name: str, dtype, group, weights: str = "none", kv: str = "auto", **cfg):
    """``name`` with seed-``SEED`` weights split over ``group``: drawn whole
    one tensor at a time on the rank's card, the rank's slices kept
    (``Transformer.init_weights``). int8 weights: the whole float32 model
    quantized, then cut (a row split keeps its scale whole). ``cfg``: more
    config overrides (``n_layers``)."""
    from zero_transformer_tpu_torch.inference import shard_for_inference
    from zero_transformer_tpu_torch.models import model_getter
    from zero_transformer_tpu_torch.models.quant import quantize_model

    gc.collect()
    torch.cuda.empty_cache()
    if weights != "int8":
        return model_getter(name, dtype=dtype, device=group.device, seed=SEED, kv_cache_dtype=kv,
                            tensor_group=group, **cfg).cast_for_inference()
    whole = quantize_model(model_getter(name, dtype=dtype, device=group.device, seed=SEED, kv_cache_dtype=kv))
    model = model_getter(name, dtype=dtype, device=group.device, kv_cache_dtype=kv, param_quant="int8",
                         tensor_group=group)
    model.load_state_dict(shard_for_inference(model, whole.state_dict(), group))
    del whole
    return model.cast_for_inference()


def tp_profile(engine, group) -> dict:
    """Rank 0: ``TP_PROFILE_TICKS`` decode ticks of four ``TP_PROFILE_LEN``-token
    streams under the profiler: the tick's wall time and the ``tensor_group.*``
    spans' share of it (host time, the gloo staging included)."""
    from torch.profiler import ProfilerActivity, profile

    def lead():
        handles = [engine.submit(p, max_new_tokens=TP_PROFILE_TICKS + 4)
                   for p in tp_prompts([TP_PROFILE_LEN] * SLOTS, 80)]
        while engine._prefilling or engine.active_count < SLOTS:
            engine.step()
        engine.step()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TP_PROFILE_TICKS):
                engine.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / TP_PROFILE_TICKS
        engine.run_until_idle()
        spans = {ev.key: ev.cpu_time_total / 1e3 / TP_PROFILE_TICKS for ev in prof.key_averages()
                 if ev.key.startswith("tensor_group.") and str(ev.device_type).endswith("CPU")}
        kernels = kernel_times(prof)
        busy = sum(ms for ms, _ in kernels.values()) / TP_PROFILE_TICKS
        del handles
        return {"tick_ms": wall, "device_busy_ms": busy, "device_busy_share": busy / wall, "spans_ms": spans,
                "tensor_group_share": sum(spans.values()) / wall}

    return tp_session(engine, group, lead)[0]


def _tp_rank(rank: int, world: int, backend: str, init_file: str, out_dir: str) -> None:
    """One rank of the tensor_serving phase, one world for (a)-(c): (a) 125m
    float32 (streams, forced logits, launches, bytes, the tick's profile on
    rank 0), (b) 125m bf16 and int8 weights + int8 KV with every attention
    read of every rank held to its plain read, (c) llama3_8b at 32 layers:
    bf16 (streams, launches, bytes, peak, forced logits, every read held to
    its plain read), then float32 at ``GEN_LLAMA_F32_LAYERS`` (streams)."""
    from zero_transformer_tpu_torch.parallel.mesh import init_tensor_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out_dir)
    group = init_tensor_group(world, rank, f"file://{init_file}", "cuda", backend)
    dev = group.device
    result = {"rank": rank, **group.describe(), "parts_s": {}}
    t_part = time.perf_counter()
    # (a) 125m float32
    engine = tp_engine(tp_model("125m", torch.float32, group))
    # the forced logits first: their session warms the engine up for the streams' run
    logits, _ = tp_session(engine, group, lambda: tp_forced(engine, tp_prompts(PROMPT_LENS[:TP_FORCED], 50)))
    torch.cuda.reset_peak_memory_stats(dev)
    streams, launches = tp_session(engine, group, lambda: tp_streams(engine, tp_prompts(PROMPT_LENS), MAX_NEW))
    result["f32"] = {"launches": launches, "weight_bytes": engine.weight_bytes, "kv_pool_bytes": engine.kv_pool_bytes,
                     "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    if rank == 0:
        result["f32"].update(streams=streams, decode_tick_ms=engine._decode_s / engine.stats["decode_ticks"] * 1e3)
        torch.save(logits, out / "tp_forced.pt")
    result["f32"]["profile"] = tp_profile(engine, group)
    del engine
    result["parts_s"]["a"], t_part = time.perf_counter() - t_part, time.perf_counter()
    # (b) 125m bf16, then int8 weights and the int8 KV cache: every read held to the plain read
    for label, weights, kv in (("bf16", "none", "auto"), ("int8", "int8", "int8")):
        model = tp_model("125m", torch.bfloat16, group, weights, kv)
        engine = tp_engine(model)
        with attention_reads_checked(model, f"tensor_serving {label} rank {rank}") as reads:
            streams, launches = tp_session(engine, group,
                                           lambda: tp_streams(engine, tp_prompts(TP_B_LENS), TP_B_NEW))
        result[label] = {"reads": reads, "launches": launches, "streams": streams,
                         "weight_bytes": engine.weight_bytes, "kv_pool_bytes": engine.kv_pool_bytes}
        del engine, model
    result["parts_s"]["b"], t_part = time.perf_counter() - t_part, time.perf_counter()
    # (c) llama3_8b bf16, 32 layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = tp_model(LLAMA, torch.bfloat16, group)
    engine = tp_engine(model, TP_LLAMA_CACHE)
    build_s = time.perf_counter() - t0
    prompts = tp_prompts(TP_LLAMA_LENS, 70)
    # the plain reads run the plain path (attention_impl "xla"): the kernels' launches stay the engine's
    with attention_reads_checked(model, f"tensor_serving llama3_8b rank {rank}") as reads:
        streams, launches = tp_session(engine, group, lambda: tp_streams(engine, prompts, TP_LLAMA_NEW))
    result["llama"] = {"launches": launches, "streams": streams, "weight_bytes": engine.weight_bytes,
                       "kv_pool_bytes": engine.kv_pool_bytes, "build_s": build_s, "layers": engine.cfg.n_layers,
                       "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "reads": reads}
    forced, _ = tp_session(engine, group, lambda: tp_forced(engine, prompts))
    if rank == 0:
        torch.save(forced, out / "tp_forced_llama.pt")
    del engine, model
    # the streams' exactness in float32 at GEN_LLAMA_F32_LAYERS layers (in bf16 two orders of summation
    # part streams at near ties)
    gc.collect()
    torch.cuda.empty_cache()
    engine = tp_engine(tp_model(LLAMA, torch.float32, group, n_layers=GEN_LLAMA_F32_LAYERS), TP_LLAMA_CACHE)
    streams, _ = tp_session(engine, group, lambda: tp_streams(engine, prompts, TP_LLAMA_NEW))
    result["llama_f32"] = {"streams": streams, "layers": engine.cfg.n_layers}
    del engine
    result["parts_s"]["c"] = time.perf_counter() - t_part
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    group.barrier()
    torch.distributed.destroy_process_group()


def tp_gemm_orders() -> dict:
    """Why bf16 TP streams part from one card's at near ties: at
    llama3_8b's layer shapes (M 4, a decode tick; M 192, a prefill chunk of
    3 rows), the share of a GEMM's bf16 outputs that differ from one
    card's: column-parallel (the shard's N / 2 columns by their own GEMM)
    and row-parallel (two K / 2 halves summed in float32 and rounded once,
    as the model does; summed in bf16, as it would with bf16 partials)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for M in (4, 192):
        for name, N in (("q", LH * LD), ("kv", LKVH * LD), ("wi", 14336), ("head", 128256)):
            x = torch.randn(M, 4096, generator=g, device="cuda").bfloat16()
            w = (torch.randn(N, 4096, generator=g, device="cuda") * 0.02).bfloat16()
            halves = torch.cat([F.linear(x, w[:N // 2]), F.linear(x, w[N // 2:])], dim=-1)
            out[f"column_{name}_M{M}"] = float((F.linear(x, w) != halves).float().mean())
        for name, K in (("out", LH * LD), ("wo", 14336)):
            x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
            w = (torch.randn(4096, K, generator=g, device="cuda") * 0.02).bfloat16()
            one, h = F.linear(x, w), K // 2
            f32 = (torch.mm(x[:, :h], w[:, :h].T, out_dtype=torch.float32)
                   + torch.mm(x[:, h:], w[:, h:].T, out_dtype=torch.float32)).bfloat16()
            bf16 = F.linear(x[:, :h], w[:, :h]) + F.linear(x[:, h:], w[:, h:])
            out[f"row_{name}_M{M}_f32_sums"] = float((one != f32).float().mean())
            out[f"row_{name}_M{M}_bf16_sums"] = float((one != bf16).float().mean())
    return out


def tp_cli_start(params: Path, prompt: str) -> dict:
    """(d)'s two processes, started when the phase starts (they load while
    the one-card references and the rank world run): ``serve --server
    --tensor 2`` and ``serve --prompt ... --tensor 2``, 125m in float32."""
    common = ["--model", "125m", "--params", str(params), "--dtype", "float32", "--greedy", "--tensor",
              str(TP_RANKS), "--max-new-tokens", str(MAX_NEW), "--repetition-penalty", "1.0"]
    server, lines = cli_server([*common, "--server", "--port", "0", "--prefix-cache", "0", "--obs-dir",
                                str(TP_DIR / "obs")])
    one = subprocess.Popen([sys.executable, "-m", "zero_transformer_tpu_torch.serve", *common, "--prompt", prompt],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           cwd=Path(__file__).resolve().parent)
    return {"server": server, "lines": lines, "one": one, "t0": time.perf_counter()}


def tp_cli(procs: dict, prompt: str, expect: list) -> dict:
    """(d) the server answers one request over HTTP with the one-card
    engine's stream and drains on SIGTERM; the one-shot prints one answer;
    both print their backend and exit 0."""
    import signal

    from zero_transformer_tpu_torch.serve import ByteTokenizer

    reading, out = {}, []
    proc, lines, one = procs["server"], procs["lines"], procs["one"]
    try:
        base = cli_base(lines, out, "the tensor-parallel serve CLI")
        reading["ready_s_from_phase_start"] = time.perf_counter() - procs["t0"]
        code, text = http("POST", base + "/generate", {"prompt": prompt, "max_new_tokens": MAX_NEW,
                                                        "stream": False})
        tokens = json.loads(text)["tokens"]
        if code != 200 or tokens != expect:
            raise AssertionError(f"the --tensor 2 server: HTTP {code}, {tokens} vs the one-card engine's {expect}")
        proc.send_signal(signal.SIGTERM)
        proc.wait(120)
        stdout, stderr = one.communicate(timeout=600)
    finally:
        for p in (proc, one):
            if p.poll() is None:
                p.kill()
                p.wait()
    while not lines.empty():
        out.append(lines.get())
    if proc.returncode != 0:
        raise AssertionError(f"the --tensor 2 server exited {proc.returncode}: {out[-10:]}")
    reading["server_topology"] = next((json.loads(x) for x in out if x.startswith('{"tensor_ranks"')), None)
    # the answer: what is printed after the topology lines (it may hold newlines of its own)
    text = "".join(x for x in stdout.splitlines(keepends=True) if not x.startswith('{"tensor_'))[:-1]
    if one.returncode != 0 or not text:
        raise AssertionError(f"the --tensor 2 one-shot exited {one.returncode}: {stdout[-500:]} {stderr[-500:]}")
    reading["one_shot_equals_engine_text"] = text == ByteTokenizer().decode(expect)
    reading["one_shot_topology"] = next((json.loads(x) for x in stdout.splitlines()
                                         if x.startswith('{"tensor_ranks"')), None)
    # each rank's host peak: rank 0 read the weights and sent them a tensor at a time
    for key, lines_of in (("server", out), ("one_shot", stdout.splitlines())):
        reading[f"{key}_host_peak_gib_per_rank"] = next(
            (json.loads(x)["tensor_host_peak_gib"] for x in lines_of if x.startswith('{"tensor_host_peak_gib"')),
            None)
    if None in (reading["server_topology"], reading["one_shot_topology"], reading["server_host_peak_gib_per_rank"],
                reading["one_shot_host_peak_gib_per_rank"]):
        raise AssertionError(f"a --tensor 2 CLI printed no topology or host peaks: {reading}")
    return reading


def tensor_serving_phase() -> tuple:
    """Tensor-parallel serving on the card (the module doc, phase 24): the
    one-card references, then one world of ``TP_RANKS`` ranks for (a)-(c)
    (``_tp_rank``), the checks, (d) the CLI, and the kernel rows of K1 and
    K4 at TP 2's local heads (125m: rank 1's heads 6-11 with their slopes;
    llama3_8b: 16 query and 4 kv heads). Returns the rows and rank 0's
    launches of (a) and (c)."""
    from zero_transformer_tpu_torch.convert import params_to_jax

    t_phase = time.perf_counter()
    TP_DIR.mkdir(parents=True, exist_ok=True)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= TP_RANKS else "gloo"
    topology = {"ranks": TP_RANKS, "cards": min(cards, TP_RANKS), "backend": backend,
                "transfers": "NCCL, card to card" if backend == "nccl" else "gloo through pinned host memory"}
    log({"tensor_serving_topology": topology, "card": card_line()})
    params = POLICY_DIR / "a.npz"
    if not params.exists():  # the serving_policy phase did not run
        POLICY_DIR.mkdir(parents=True, exist_ok=True)
        np.savez(params, **params_to_jax(gen_model("125m", torch.float32, "auto").state_dict()))
        gc.collect()
    cli = tp_cli_start(params, prompt_text(PROMPT_LENS[0], 0))
    try:
        t0 = time.perf_counter()
        ref = tp_one_card_references(TP_DIR)
        refs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = run_ranks(_tp_rank, TP_RANKS, backend, TP_DIR, what="tensor-serving")
        ranks_s = time.perf_counter() - t0
    except BaseException:
        for proc in (cli["server"], cli["one"]):  # no process outlives the phase
            proc.kill()
            proc.wait()
        raise
    r0 = ranks[0]
    failed = []  # every reading is logged first, then the phase fails on any miss
    # (a) 125m float32: streams, logits, launches per rank, bytes
    if r0["f32"]["streams"] != ref["f32_streams"]:
        failed.append(f"(a) TP 2 streams differ from the one-card engine's: {r0['f32']['streams']} vs "
                      f"{ref['f32_streams']}")
    got = torch.load(TP_DIR / "tp_forced.pt")
    logit_err = [float((a - b).abs().max()) for a, b in zip(got, ref["f32_forced"])]
    if max(logit_err) > 2e-4:
        failed.append(f"(a) TP 2 logits (prefill, decode step) beyond 2e-4 of one card's: {logit_err}")
    for r in ranks:
        for k in ("flash_serving_fwd", "paged_attention"):
            if r["f32"]["launches"].get(k, 0) != ref["f32_launches"][k]:
                failed.append(f"(a) rank {r['rank']} launched {k} {r['f32']['launches'].get(k, 0)} times, one "
                              f"card {ref['f32_launches'][k]}")
    # (b) every read within the bf16 bar (checked inside the ranks); the int8 path through K4's int8 branch
    for r in ranks:
        if r["int8"]["launches"].get("paged_attention", 0) or not r["int8"]["launches"].get("paged_attention_int8"):
            failed.append(f"(b) rank {r['rank']}'s int8 launches: {r['int8']['launches']}")
    # (c) llama3_8b. In float32 (GEN_LLAMA_F32_LAYERS layers) greedy tokens equal one card's up to a near
    # tie (0.03). In bf16 at 32 layers the row-parallel sums' order moves the logits (~0.3): the forced
    # logits must stay within one card's own bf16-to-float32 spread at 32 layers, and a stream may part
    # only where one card's top-2 gap is within twice that bar (two logits each moved by it can swap there)
    forced = torch.load(TP_DIR / "tp_forced_llama.pt")
    one, f32 = ref["llama_forced"], ref["llama_f32_forced"]
    # the decode step's logits only on rows whose three prefills agree on the token they fed
    agree = (forced[0].argmax(-1) == one[0].argmax(-1)) & (one[0].argmax(-1) == f32[0].argmax(-1))
    llama_logit_err = [float((forced[0] - one[0]).abs().max()),
                       float((forced[1] - one[1])[agree].abs().max()) if bool(agree.any()) else None]
    llama_bf16_spread = [float((one[0] - f32[0]).abs().max()),
                         float((one[1] - f32[1])[agree].abs().max()) if bool(agree.any()) else None]
    for what, err, bar in zip(("prefill", "decode step"), llama_logit_err, llama_bf16_spread):
        if err is not None and not err <= bar:
            failed.append(f"(c) llama3_8b bf16 {what} logits {err} from one card's, beyond one card's own bf16 "
                          f"to float32 spread {bar}")
    tie_bf16 = 2 * max(x for x in llama_bf16_spread if x is not None)
    ties = {}
    for label, got, want_all, gaps_all in (
            ("f32", r0["llama_f32"]["streams"], ref["llama_f32_streams"], ref["llama_f32_gaps"]),
            ("bf16", r0["llama"]["streams"], ref["llama_streams"], ref["llama_gaps"])):
        ties[label] = []
        for b, (g, want, gaps) in enumerate(zip(got, want_all, gaps_all)):
            diff = [t for t, (x, y) in enumerate(zip(g, want)) if x != y]
            if diff:
                t = diff[0]
                ties[label].append([b, t, gaps[t], g[t:t + 4], want[t:t + 4]])
                bar = TIE_BF16_SERVE if label == "f32" else tie_bf16
                if not gaps[t] <= bar:
                    failed.append(f"(c) llama3_8b {label} row {b} parts at token {t} where one card's top-2 gap "
                                  f"is {gaps[t]} (> {bar})")
    for r in ranks:
        for k in ("flash_serving_fwd", "paged_attention"):
            if r["llama"]["launches"].get(k, 0) != ref["llama_launches"][k]:
                failed.append(f"(c) rank {r['rank']} launched {k} {r['llama']['launches'].get(k, 0)} times, one "
                              f"card {ref['llama_launches'][k]}")
    llama_argmax_equal = int(agree.sum())
    if r0["llama"]["layers"] != 32 or r0["llama_f32"]["layers"] != GEN_LLAMA_F32_LAYERS:
        failed.append(f"(c) llama3_8b was not served at 32 layers in bf16 and {GEN_LLAMA_F32_LAYERS} in float32")
    shares = {}
    for label, one, key in (("125m_f32", ref["f32_bytes"], "f32"), ("llama3_8b", ref["llama_bytes"], "llama")):
        for r in ranks:
            for b in ("weight_bytes", "kv_pool_bytes"):
                share = r[key][b] / one[b]
                shares[f"{label}_{b}_rank{r['rank']}"] = share
                if not 0.49 <= share <= 0.51:
                    failed.append(f"{label} rank {r['rank']} holds {share:.4f} of one card's {b}")
    log({"tensor_serving": {
        "one_card_s": refs_s, "ranks_s": ranks_s, "topology": {k: r0[k] for k in ("backend", "device", "cards",
                                                                                   "staged_through_host")},
        "f32": {"logit_max_err": logit_err, "streams_equal": r0["f32"]["streams"] == ref["f32_streams"],
                "launches_per_rank": [r["f32"]["launches"] for r in ranks], "one_card_launches": ref["f32_launches"],
                "decode_tick_ms": r0["f32"]["decode_tick_ms"],
                "peak_memory_gib_per_rank": [r["f32"]["peak_memory_gib"] for r in ranks],
                "profile_rank0": r0["f32"]["profile"]},
        "bf16_reads": [r["bf16"]["reads"] for r in ranks], "int8_reads": [r["int8"]["reads"] for r in ranks],
        "bf16_streams_equal_f32": sum(a == b[:TP_B_NEW] for a, b in zip(r0["bf16"]["streams"], ref["f32_streams"])),
        "int8_streams_equal_f32": sum(a == b[:TP_B_NEW] for a, b in zip(r0["int8"]["streams"], ref["f32_streams"])),
        "llama": {"ties": ties, "rows_equal": {k: len(TP_LLAMA_LENS) - len(v) for k, v in ties.items()},
                  "one_card_gaps": ref["llama_gaps"], "one_card_f32_gaps": ref["llama_f32_gaps"],
                  "reads": [r["llama"]["reads"] for r in ranks],
                  "forced_logit_max_err": llama_logit_err, "forced_argmax_equal_rows": llama_argmax_equal,
                  "bf16_bar_one_card_bf16_to_f32": llama_bf16_spread, "bf16_tie_bar": tie_bf16,
                  "build_s_per_rank": [r["llama"]["build_s"]
                                                                                       for r in ranks],
                  "peak_memory_gib_per_rank": [r["llama"]["peak_memory_gib"] for r in ranks],
                  "launches_rank0": r0["llama"]["launches"], "one_card_launches": ref["llama_launches"]},
        "parts_s_rank0": r0["parts_s"],
        "bytes_share_of_one_card": shares}})
    log({"tensor_serving_gemm_outputs_differing_from_one_card": tp_gemm_orders()})
    # (d) the CLI, started with the phase
    try:
        log({"tensor_serving_cli": tp_cli(cli, prompt_text(PROMPT_LENS[0], 0), ref["f32_streams"][0])})
    except AssertionError as e:
        failed.append(str(e))
    # the kernel rows at TP 2's local heads
    rows = {}
    gen_k1_row("flash_serving_fwd_tp", SLOTS, CHUNK, CACHE, H // 2, H // 2, D, [0, 256, 512, 896], True, rows,
               heads=(H // 2, H))
    gen_k4_row("paged_attention_tp", SLOTS, 1, CACHE, H // 2, H // 2, D, [n + MAX_NEW // 2 for n in
                                                                       PROMPT_LENS[:SLOTS]], True, rows,
               heads=(H // 2, H))
    gen_k1_row("flash_serving_fwd_tp_llama", SLOTS, CHUNK, TP_LLAMA_CACHE, LH // 2, LKVH // 2, LD,
               [0, 256, 1024, 1984], False, rows)
    gen_k4_row("paged_attention_tp_llama", SLOTS, 1, TP_LLAMA_CACHE, LH // 2, LKVH // 2, LD, [40, 300, 600, 2000],
               False, rows)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    log({"tensor_serving_s": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError(f"tensor_serving: {failed}")
    launches = {"flash_serving_fwd_tp": r0["f32"]["launches"]["flash_serving_fwd"],
                "paged_attention_tp": r0["f32"]["launches"]["paged_attention"],
                "flash_serving_fwd_tp_llama": r0["llama"]["launches"]["flash_serving_fwd"],
                "paged_attention_tp_llama": r0["llama"]["launches"]["paged_attention"]}
    return rows, launches


# ------------------------------------------------- tensor-parallel training

TT_DATA, TT_TENSOR = 2, 2  # (a): 125m over data 2 x tensor 2, four ranks
TT_DIR = Path("build") / "tensor_training"  # (c)'s one-card records, (d)'s run; deleted after the phase
TT_SEQ = 2  # (b): 580m over tensor 2 x sequence 2 at T 8192
TT_LLAMA_STEPS = 3  # (c): llama3_8b over tensor 2, the first steps of llama_training's one-card run
# (a)-(d)'s results, from the phases whose rank worlds run them
TT_STASH: dict = {}
TT_NEEDS = ("sequence_parallel", "data_parallel", "llama_training")  # the phases that fill TT_STASH


def tt_sets(stage: int) -> dict:
    return {"mesh.data": TT_DATA, "mesh.tensor": TT_TENSOR, "mesh.zero_stage": stage}


def tt_dp_jobs(out: Path) -> list:
    """(a)'s jobs in a data-parallel world of 4 ranks: ZeRO 0-3 with AdamW
    (stage 3 with the chunked loss) and Adafactor at stage 1 over data 2 x
    tensor 2, 3 steps each (the stage-2 run through ``trainer.train``,
    saving at steps 2 and 3, and profiled once), then the world's own mesh
    (data 4 x tensor 1) resuming its step 2."""
    mesh = (TT_DATA, TT_TENSOR, 1)
    chunk = {3: {"model.loss_chunk": 256}}
    jobs = [dict(name=f"tp_stage{s}", steps=DP_STEPS, save=s == 2, profiled=s == 2, mesh=mesh,
                 overrides=dp_overrides(out / f"tp_stage{s}", s, **tt_sets(s), **chunk.get(s, {})))
            for s in (0, 1, 2, 3)]
    jobs.append(dict(name="tp_adafactor", steps=DP_STEPS, profiled=False, mesh=mesh,
                     overrides=dp_overrides(out / "tp_adafactor", 1, **tt_sets(1),
                                            **{"optimizer.optimizer": "adafactor"})))
    jobs.append(dict(name="tp_resume_data4", steps=1, save=True, profiled=False,
                     copy=[(str(out / "tp_stage2" / "2"), str(out / "tp_resume_data4"))],
                     overrides=dp_overrides(out / "tp_resume_data4", 2, **{"checkpoint.resume": True})))
    return jobs


def tt_local_numel() -> tuple:
    """(whole params, one tensor rank's params) of 125m at DP_LAYERS layers."""
    from zero_transformer_tpu_torch.config import model_config
    from zero_transformer_tpu_torch.models.gpt import Transformer, tp_split_dim

    model = Transformer(model_config("125m", n_layers=DP_LAYERS), device="meta")
    whole = sum(p.numel() for p in model.parameters())
    split = sum(p.numel() for n, p in model.named_parameters() if tp_split_dim(n) is not None)
    return whole, whole - split + split // TT_TENSOR


def tt_one_card_tree() -> dict:
    """What a one-card checkpoint of (a)'s configuration holds: name ->
    (shape, dtype), from a one-process ZeRO state of 125m at DP_LAYERS
    layers with AdamW, built on the host (the values are not needed)."""
    from zero_transformer_tpu_torch.config import OptimizerConfig, model_config
    from zero_transformer_tpu_torch.models.gpt import Transformer
    from zero_transformer_tpu_torch.parallel.zero import init_train_state
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    model = Transformer(model_config("125m", n_layers=DP_LAYERS), device="cpu").requires_grad_(True)
    opt = OptimizerConfig()
    return init_train_state(model, opt, make_schedule(opt)).shards.target()


def check_tt_dp(ranks: list, refs: dict, out: Path, dp_bytes: list) -> dict:
    """(a)'s fatal checks: each job's losses within LOSS_MARGIN and grad norms
    within GRAD_NORM_RTOL of the one-card run on the same global batches
    (AdamW's for the stages and the chunked loss, Adafactor's); the whole
    params' digest equal on all four ranks and the replicated leaves' on
    all four (bit-equal across tensor ranks); the replica audit clean; the
    AdamW stages' bytes a rank equal to the ZeRO formula over one tensor
    rank's params; DP_LAYERS launches of K1-K3 a rank a step. Then the
    stage-2 run's step-2 save holds the one-card tree (names, shapes) with
    a manifest whose digests are those of the whole tensors it holds, and
    the data-4 resume from it continues: its step-3 loss within the bars of
    the tensor-parallel run's."""
    from zero_transformer_tpu_torch.checkpoint import CheckpointManager, tree_digests

    whole, local = tt_local_numel()
    summary = {"params_whole": whole, "params_a_rank": local, "split_share_a_rank": local / whole}
    for name in ("tp_stage0", "tp_stage1", "tp_stage2", "tp_stage3", "tp_adafactor"):
        ref = refs["adafactor"] if name == "tp_adafactor" else refs[1]
        first = ranks[0][name]
        line = {"losses": first["losses"], "one_card_losses": ref["losses"], "grad_norms": first["grad_norms"],
                "one_card_grad_norms": ref["grad_norms"],
                "persistent_bytes_per_rank": [r[name]["persistent_bytes"] for r in ranks],
                "peak_memory_gib_per_rank": [r[name]["peak_memory_gib"] for r in ranks],
                "launches_rank0": first["launches"], "profile_rank0": first.get("profile")}
        for step, loss in first["losses"].items():
            if not abs(loss - ref["losses"][step]) <= LOSS_MARGIN:
                raise AssertionError(f"tensor_training (a) {name} step {step}: loss {loss} vs one card "
                                     f"{ref['losses'][step]}")
            norm, want = first["grad_norms"][step], ref["grad_norms"][step]
            if not abs(norm - want) <= GRAD_NORM_RTOL * abs(want):
                raise AssertionError(f"tensor_training (a) {name} step {step}: grad norm {norm} vs one card {want}")
        for key in ("params_digest", "replicated_digest"):
            if len({r[name][key] for r in ranks}) != 1:
                raise AssertionError(f"tensor_training (a) {name}: {key} differs across the ranks: "
                                     f"{[r[name][key] for r in ranks]}")
        if any(r[name]["audit_diverged"] for r in ranks):
            raise AssertionError(f"tensor_training (a) {name}: the replica audit saw a divergence")
        stage = int(name[-1]) if name.startswith("tp_stage") else None
        if stage is not None:
            padded = -(-local // TT_DATA) * TT_DATA
            params = padded if stage < 3 else padded // TT_DATA
            want_bytes = 4 * (params + 2 * (padded if stage == 0 else padded // TT_DATA))
            if any(r[name]["persistent_bytes"] != want_bytes for r in ranks):
                raise AssertionError(f"tensor_training (a) {name}: bytes {line['persistent_bytes_per_rank']}, "
                                     f"want {want_bytes}")
            line["persistent_bytes_formula"] = want_bytes
            line["data4_bytes_per_rank"] = dp_bytes[stage] if dp_bytes else None
        steps = first["end_step"] - first["start_step"]
        want = {n: DP_LAYERS * steps for n in ("flash_train_fwd", "flash_dq", "flash_dkv")}
        for r in ranks:
            if {n: r[name]["launches"].get(n, 0) for n in want} != want:
                raise AssertionError(f"tensor_training (a) {name} rank {r[name]['rank']}: launches "
                                     f"{r[name]['launches']}, want {want}")
        summary[name] = line
    # the save at data 2 x tensor 2 and the resume at data 4 x tensor 1
    leaves, meta = CheckpointManager(out / "tp_stage2").restore(2, device="cuda")
    tree = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in leaves.items()}
    target = tt_one_card_tree()
    digests = tree_digests(leaves)
    bad = [k for k, d in digests.items() if meta["manifest"]["leaves"][k]["sum"] != d]
    del leaves
    if tree != target or bad or meta["topology"]["mesh"]["tensor"] != TT_TENSOR:
        raise AssertionError(f"tensor_training (a): the tensor-parallel save is not the one-card tree "
                             f"(same names and shapes: {tree == target}; digests off: {bad[:3]}; "
                             f"topology {meta['topology']})")
    resumed, uninterrupted = ranks[0]["tp_resume_data4"], ranks[0]["tp_stage2"]
    ckpt = {"leaves": len(tree), "digests_sum": sum(digests.values()) % 2**32, "resumed_start": resumed["start_step"],
            "resumed_loss": resumed["losses"].get("3"), "uninterrupted_loss": uninterrupted["losses"].get("3"),
            "resumed_grad_norm": resumed["grad_norms"].get("3"),
            "uninterrupted_grad_norm": uninterrupted["grad_norms"].get("3"),
            "restore_verify_ms_rank0": resumed.get("restore_verify_ms"), "save_ms_rank0": uninterrupted["save_ms"]}
    if not (resumed["start_step"] == 2 and abs(ckpt["resumed_loss"] - ckpt["uninterrupted_loss"]) <= LOSS_MARGIN
            and abs(ckpt["resumed_grad_norm"] - ckpt["uninterrupted_grad_norm"])
            <= GRAD_NORM_RTOL * abs(ckpt["uninterrupted_grad_norm"])):
        raise AssertionError(f"tensor_training (a): the data-4 resume of the tensor-parallel save: {ckpt}")
    summary["checkpoint"] = ckpt
    return summary


# (b): the 580m steps over tensor 2 x sequence 2 in the sequence-parallel world
TT_SP_CASES = {"tp_ring": {}, "tp_ulysses": {"cp_impl": "ulysses"}}


def tt_sp_step(mesh_world, backend: str, out: Path, dtype) -> dict:
    """(b) on one rank of the sequence-parallel world: the world's ranks as
    tensor 2 x sequence 2, one 580m step per case (the ring, Ulysses) from
    the one-card seeded weights on the one-card batch; rank 0 holds its
    slices of the grads against the one-card reference's (its
    ``tensor_shard``). Returns per case the loss, the grad norm, the
    launches, the step's seconds, peak memory, the grad cosines (rank 0),
    and checksums of the replicated and of the local params after the
    update."""
    from zero_transformer_tpu_torch.config import OptimizerConfig
    from zero_transformer_tpu_torch.convert import tensor_shard
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.parallel.mesh import make_mesh
    from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    mesh = make_mesh(1, TT_TENSOR, TT_SEQ, backend, mesh_world.device)
    dev = mesh.device
    res = {"tensor_rank": mesh.tensor.rank, "sequence_rank": mesh.sequence.rank}
    for case, overrides in TT_SP_CASES.items():
        from zero_transformer_tpu_torch.models import model_getter

        model = model_getter(SP_MODEL, dtype=dtype, device=dev, seed=SEED, trainable=True, dropout=0.0, remat=True,
                             n_layers=SP_LAYERS, tensor_group=mesh.tensor, **overrides)
        model.set_sequence_group(mesh.sequence)
        opt_cfg = OptimizerConfig(schedule="constant", peak_learning_rate=SP_LR)
        schedule = make_schedule(opt_cfg)
        st = init_train_state(model, opt_cfg, schedule)
        captured, adamw_step = {}, st.optimizer.step

        def capture(grads, norm=None, keep=None, _step=adamw_step):
            captured["grads"] = st.shards.layout.views(torch.cat([g.reshape(-1) for g in grads]))
            return _step(grads, norm, keep)

        st.optimizer.step = capture
        step = make_train_step(1, schedule, seq_group=mesh.sequence)
        batch = sp_batch(False).to(dev)
        torch.cuda.synchronize(dev)
        mesh_world.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        metrics = step(st, batch)
        torch.cuda.synchronize(dev)
        line = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                "step_s": time.perf_counter() - t0,
                "launches": {n: c for n, c in _build.LAUNCHES.items() if c},
                "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        if mesh.sequence.rank == 0:  # one rank of each tensor slice holds its grads against the reference's
            ref = torch.load(out / "ref_plain.pt", mmap=True, weights_only=True)
            want = tensor_shard(ref["grads"], mesh.tensor.rank, mesh.tensor.size)
            cos = {n: float(torch.nn.functional.cosine_similarity(
                g.flatten().double(), want[n].to(dev).flatten().double(), dim=0))
                for n, g in captured["grads"].items()}
            line.update(grad_cos_min=min(cos.values()), grad_cos_min_tensor=min(cos, key=cos.get),
                        grad_cos_below_bar={n: c for n, c in cos.items() if c < COS_BAR}, ref_loss=ref["loss"])
            del ref, want
        captured.clear()
        split = st.shards.split_dim
        line["replicated_checksum"] = sum(int(p.detach().view(torch.int32).sum(dtype=torch.int64))
                                          for n, p in model.named_parameters() if split[n] is None)
        line["local_checksum"] = param_checksum(model)
        res[case] = line
        del st, model, step, batch, metrics, capture, adamw_step
        gc.collect()
        torch.cuda.empty_cache()
    return res


def check_tt_sp(results: list, ref_loss: float) -> dict:
    """(b)'s fatal checks: each case's loss within LOSS_MARGIN of the
    one-card step's and every grad's cosine (each tensor slice's, against
    the one-card grads' slice) at least COS_BAR; the replicated params
    bit-equal on all four ranks after the update and the split ones across
    the sequence ranks of each tensor rank; the launches a rank exact:
    the ring's L x 2 x 2 flash_partial_fwd (its 2 folds, the forward and
    the recompute) and L x 2 dq/dkv; Ulysses' 2L / L / L over the whole
    row."""
    L = SP_LAYERS
    summary = {}
    for case in TT_SP_CASES:
        lines = [r["tensor_training"][case] for r in results]
        first = lines[0]
        cos = [x for x in lines if "grad_cos_min" in x]
        line = {"loss": first["loss"], "loss_one_card": ref_loss, "loss_margin": LOSS_MARGIN,
                "grad_cos_min": min(x["grad_cos_min"] for x in cos), "grad_norm": first["grad_norm"],
                "step_s_per_rank": [x["step_s"] for x in lines],
                "peak_memory_gib_per_rank": [x["peak_memory_gib"] for x in lines],
                "launches_rank0": first["launches"]}
        summary[case] = line
        if not abs(first["loss"] - ref_loss) <= LOSS_MARGIN:
            raise AssertionError(f"tensor_training (b) {case}: loss {first['loss']} vs one card {ref_loss}")
        below = {n: c for x in cos for n, c in x["grad_cos_below_bar"].items()}
        if len(cos) != TT_TENSOR or below:
            raise AssertionError(f"tensor_training (b) {case}: grad cosines below {COS_BAR}: {below}")
        if len({x["replicated_checksum"] for x in lines}) != 1:
            raise AssertionError(f"tensor_training (b) {case}: replicated params differ across the ranks")
        for t in range(TT_TENSOR):
            if len({x["local_checksum"] for x, r in zip(lines, results) if r["tensor_training"]["tensor_rank"] == t}) != 1:
                raise AssertionError(f"tensor_training (b) {case}: tensor rank {t}'s params differ across "
                                     "its sequence ranks")
        want = ({"flash_train_fwd": 2 * L, "flash_dq": L, "flash_dkv": L} if case == "tp_ulysses" else
                {"flash_partial_fwd": 2 * L * TT_SEQ, "flash_partial_dq": L * TT_SEQ,
                 "flash_partial_dkv": L * TT_SEQ})
        for x in lines:
            if x["launches"] != want:
                raise AssertionError(f"tensor_training (b) {case}: launches {x['launches']}, want {want}")
    return summary


def tt_ring_rows() -> dict:
    """K1 via flash_partial and K2/K3 via flash_grads at a ring x tensor
    rank's shard (580m at T 8192 over sequence 2: a 4096-token shard at 6
    heads of 128, bf16), each tensor rank's slopes (heads 0-5, 6-11): the
    diagonal and the past shard against the plain versions (the bf16 bar
    on o and lse, K2/K3 within one bf16 ulp + GRAD_ATOL); tensor rank 1's
    past shard handed the slopes of heads 0-5 (the tensor offset dropped)
    must miss them. Tensor rank 1's past shard is timed: the
    ``_tp_ring`` rows."""
    import torch.nn.functional as F

    from zero_transformer_tpu_torch.ops import flash

    B, t, Hq, Dq, dtype = 1, SP_SEQ // TT_SEQ, 12 // TT_TENSOR, 128, torch.bfloat16
    T, scale = 2 * t, 1.0 / Dq**0.5
    g = torch.Generator(device="cuda").manual_seed(78)
    q, k, v, do = (torch.randn(B, T, Hq, Dq, generator=g, device="cuda").to(dtype) for _ in range(4))
    rows, checks = {}, {}
    for trank in range(TT_TENSOR):
        slopes, wrong = shard_slopes((trank * Hq, 12), Hq, True)
        o_all, lse_all = flash._launch_fwd(q, k, v, causal=True, alibi=True, q_offset=0, segment_ids=None,
                                           scale=scale, want_lse=True, counter=flash.TRAIN_KERNEL, slopes=slopes)
        for pair, (qi, ki) in (("diagonal", (1, 1)), ("past", (1, 0))):
            qs, ks, vs, dos = (x.narrow(1, i * t, t).contiguous() for x, i in ((q, qi), (k, ki), (v, ki), (do, qi)))
            at = dict(causal=True, alibi=True, softmax_scale=scale, q_offset=qi * t, kv_offset=ki * t)
            o_k, lse_k = flash.flash_partial(qs, ks, vs, **at, slopes=slopes)
            ref_o, ref_lse = flash.flash_partial_reference(qs, ks, vs, **at, slopes=slopes)
            errs = [compare(o_k, ref_o, dtype, f"tp ring K1 t{trank} {pair}"),
                    compare(lse_k, ref_lse, dtype, f"tp ring lse t{trank} {pair}")]
            o_g, lse_g = o_all.narrow(1, qi * t, t), lse_all.narrow(2, qi * t, t).contiguous()
            delta = (dos.float() * o_g.float()).sum(-1).transpose(1, 2).contiguous()
            got = flash.flash_grads(qs, ks, vs, o_g, lse_g, dos, **at, delta=delta, slopes=slopes)
            f32_in = [x.float() for x in (qs, ks, vs, o_g)] + [lse_g, dos.float()]
            ref = flash.flash_grads_reference(*f32_in, **at, delta=delta, slopes=slopes)
            misses = [grad_miss(a, b) for a, b in zip(got, ref)]
            if max(misses) > 1.0:
                raise AssertionError(f"tp ring t{trank} {pair}: dq/dk/dv at {misses} of their bars")
            line = {"o_lse_max_err": errs, "grads_over_bar": misses,
                    "grads_max_err": [float((a - b).abs().max()) for a, b in zip(got, ref)]}
            del ref
            if trank > 0 and pair == "past":  # the tensor offset dropped: heads 0-5's slopes
                line["offset_dropped_k1_err"] = reject_unsliced(
                    o_k, lambda sl: flash.flash_partial_reference(qs, ks, vs, **at, slopes=sl)[0], wrong,
                    f"tp ring t{trank}")
                off = flash.flash_grads_reference(*f32_in, **at, delta=delta, slopes=wrong)
                line["offset_dropped_grads_over_bar"] = c_miss = [grad_miss(a, b) for a, b in zip(got, off)]
                if max(c_miss) <= 1.0:
                    raise AssertionError(f"tp ring t{trank}: the slopes of heads 0-5 pass K2/K3's bars ({c_miss})")
                del off
            checks[f"t{trank}_{pair}"] = line
            if trank == TT_TENSOR - 1 and pair == "past":
                kw = dict(causal=True, alibi=True, scale=scale, q_offset=qi * t, kv_offset=ki * t,
                          out_dtype=torch.float32, slopes=slopes)
                kern = {"flash_partial_fwd": lambda: flash.flash_partial(qs, ks, vs, **at, slopes=slopes),
                        "flash_partial_dq": lambda: flash.launch_dq(qs, ks, vs, dos, lse_g, delta, **kw,
                                                                    counter="flash_partial_dq"),
                        "flash_partial_dkv": lambda: flash.launch_dkv(qs, ks, vs, dos, lse_g, delta, **kw,
                                                                      counter="flash_partial_dkv")}
                plain_fwd = time_ms(lambda: flash.flash_partial_reference(qs, ks, vs, **at, slopes=slopes), iters=3)
                plain_bwd = time_ms(lambda: flash.flash_grads_reference(qs, ks, vs, o_g, lse_g, dos, **at,
                                                                        delta=delta, slopes=slopes), iters=3)
                dist = (qi * t + torch.arange(t, device="cuda"))[:, None] - (ki * t + torch.arange(t, device="cuda"))
                bias = (-slopes[:, None, None] * dist.clamp(min=0).float())[None].to(dtype)
                qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (qs, ks, vs))
                lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)
                lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias), iters=10)
                lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dos.transpose(1, 2),
                                                              retain_graph=True), iters=10)
                bounds = partial_bounds(B, t, Hq, Hq, Dq, dtype, t * t, 0)
                for name, fn in kern.items():
                    bound, by = bounds[name]
                    err = errs[0] if name == "flash_partial_fwd" else (
                        line["grads_max_err"][0] if name == "flash_partial_dq" else max(line["grads_max_err"][1:]))
                    rows[name + "_tp_ring"] = dict(
                        max_abs_err=err, ms=time_ms(fn, iters=10), device_ms=device_ms(fn, iters=10),
                        plain_ms=plain_fwd if name == "flash_partial_fwd" else plain_bwd,
                        library_ms=lib_fwd if name == "flash_partial_fwd" else lib_bwd, bound_ms=bound, bound_by=by)
                    log({"kernel": name + "_tp_ring", "shape": [B, t, Hq, Hq, Dq], "heads": [trank * Hq, 12],
                         "pair": pair, **rows[name + "_tp_ring"]})
                del lib_out, qt, kt, vt, bias
        del o_all, lse_all
        torch.cuda.empty_cache()
    log({"tensor_training_ring_kernels": checks})
    return rows


def tt_kernel_rows() -> dict:
    """K1-K3 at every new shard shape of the phase, each rank's slopes
    against the plain versions: 125m over tensor 2 (B 16 rows of a data
    rank, T 1024, 6 heads of 64, heads 6-11: ``_tp``); the ring's shards
    over tensor 2 x sequence 2 (``tt_ring_rows``: ``_tp_ring``); Ulysses
    over tensor 2 x sequence 2 (T 8192 at 3 heads of 128: tensor rank 1's
    head ranges checked, 6-8 and 9-11, the latter timed: ``_tp_ulysses``); llama3_8b over
    tensor 2 (T 8192, 16 query on 4 kv heads, ALiBi off:
    ``train_kernel_phase``'s bars and controls: ``_tp_llama``)."""
    rows = {}
    rows.update(shard_kernel_rows("_tp", DP_RANKS * DP_B // TT_DATA, 1024, 12 // TT_TENSOR, 12 // TT_TENSOR, 64,
                                  (12 // TT_TENSOR, 12), seed=79, label="tp_125m"))
    gc.collect()
    torch.cuda.empty_cache()
    rows.update(tt_ring_rows())
    h = 12 // TT_TENSOR // TT_SEQ
    for trank in range(TT_TENSOR):
        for srank in range(TT_SEQ):
            lo = trank * (12 // TT_TENSOR) + srank * h
            if trank == 0:
                continue  # tensor rank 0: dropping the tensor offset changes nothing
            last = (trank, srank) == (TT_TENSOR - 1, TT_SEQ - 1)
            rows.update(shard_kernel_rows("_tp_ulysses", 1, SP_SEQ, h, h, 128, (lo, 12), seed=80 + lo,
                                          label=f"tp_ulysses_heads_{lo}", timed=last))
            gc.collect()
            torch.cuda.empty_cache()
    rows.update(train_kernel_phase([("llama_tp", 1, LLAMA_T, LH // TT_TENSOR, LKVH // TT_TENSOR, LD, torch.bfloat16,
                                     True, False)], {"llama_tp": "_tp_llama"}))
    return rows


def _tt_llama_rank(rank: int, world: int, backend: str, init_file: str, out_dir: str) -> None:
    """(c) on one rank of a tensor-parallel world of 2: llama3_8b at full
    width cut to LLAMA_TRAIN_LAYERS layers over tensor 2 (the one-card
    seeded weights, each rank's slices), bf16, AdamW at a constant 1e-4,
    the chunked loss, no remat (its recompute, with its collectives, would
    only repeat the forward's numbers): the first TT_LLAMA_STEPS batches of
    llama_training's one-card run, with the launches counted over them."""
    from zero_transformer_tpu_torch.config import OptimizerConfig
    from zero_transformer_tpu_torch.ops import _build
    from zero_transformer_tpu_torch.parallel.mesh import destroy, init_distributed
    from zero_transformer_tpu_torch.parallel.zero import init_train_state, make_train_step
    from zero_transformer_tpu_torch.training.optimizer import make_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = init_distributed(1, backend, "cuda", data=1, tensor=world, rank=rank, world_size=world,
                            init_method=f"file://{init_file}", local_rank=rank)
    dev = mesh.device
    model = llama_model(remat=False, tensor_group=mesh.tensor)
    opt_cfg = OptimizerConfig(schedule="constant", peak_learning_rate=1e-4)
    schedule = make_schedule(opt_cfg)
    st = init_train_state(model, opt_cfg, schedule)
    step = make_train_step(1, schedule)
    ref = torch.load(Path(out_dir) / "llama_one_card.pt", weights_only=True)
    torch.cuda.synchronize(dev)
    mesh.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    losses, norms = [], []
    t0 = time.perf_counter()
    for batch in ref["batches"][:TT_LLAMA_STEPS]:
        m = step(st, batch.to(dev))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    split = st.shards.split_dim
    line = {"rank": rank, **mesh.describe(), "losses": losses, "grad_norms": norms, "steps_s": wall,
            "launches": {n: c for n, c in _build.LAUNCHES.items() if c},
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "persistent_bytes": st.shards.persistent_bytes(), "params_a_rank": st.shards.layout.numel,
            "replicated_checksum": sum(int(p.detach().view(torch.int32).sum(dtype=torch.int64))
                                       for n, p in model.named_parameters() if split[n] is None)}
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(line))
    mesh.barrier()
    destroy(mesh)


def tt_llama(out: Path) -> dict:
    """(c): llama3_8b over tensor 2 on 2 spawned ranks (gloo on card 0, or
    NCCL with a card each), held against llama_training's one-card steps on
    the same batches from the same seeded weights: losses within
    LOSS_MARGIN, grad norms within GRAD_NORM_RTOL; the replicated params
    bit-equal on both ranks; exactly L launches of each of K1, K2 and K3 a
    rank a step (no remat). No checkpoint (the whole state is ~31 GB)."""
    ref = TT_STASH["llama"]  # llama_training's one-card steps
    torch.save(ref, out / "llama_one_card.pt")
    backend = "nccl" if torch.cuda.device_count() >= TT_TENSOR else "gloo"
    t0 = time.perf_counter()
    ranks = run_ranks(_tt_llama_rank, TT_TENSOR, backend, out, what="llama tensor-parallel")
    first = ranks[0]
    L = LLAMA_TRAIN_LAYERS
    want = {n: L * TT_LLAMA_STEPS for n in ("flash_train_fwd", "flash_dq", "flash_dkv")}
    line = {"backend": backend, "losses": first["losses"], "one_card_losses": ref["losses"][:TT_LLAMA_STEPS],
            "grad_norms": first["grad_norms"], "one_card_grad_norms": ref["grad_norms"][:TT_LLAMA_STEPS],
            "steps_s_per_rank": [r["steps_s"] for r in ranks],
            "peak_memory_gib_per_rank": [r["peak_memory_gib"] for r in ranks],
            "persistent_bytes_per_rank": [r["persistent_bytes"] for r in ranks],
            "params_a_rank": first["params_a_rank"], "params_whole": LLAMA_TRAIN_N,
            "launches_rank0": first["launches"], "ranks_s": time.perf_counter() - t0}
    for i, (loss, norm) in enumerate(zip(first["losses"], first["grad_norms"])):
        if not abs(loss - ref["losses"][i]) <= LOSS_MARGIN:
            raise AssertionError(f"tensor_training (c) step {i + 1}: loss {loss} vs one card {ref['losses'][i]}")
        if not abs(norm - ref["grad_norms"][i]) <= GRAD_NORM_RTOL * abs(ref["grad_norms"][i]):
            raise AssertionError(f"tensor_training (c) step {i + 1}: grad norm {norm} vs {ref['grad_norms'][i]}")
    if len({r["replicated_checksum"] for r in ranks}) != 1:
        raise AssertionError("tensor_training (c): the replicated params differ across the tensor ranks")
    for r in ranks:
        if r["launches"] != want:
            raise AssertionError(f"tensor_training (c) rank {r['rank']}: launches {r['launches']}, want {want}")
    return line


def tt_cli_start(run_dir: Path):
    """(d): the trainer CLI under torch.distributed.run, 125m at DP_LAYERS
    layers over data 2 x tensor 2, synthetic tokens, 3 steps; started in the
    background."""
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
              str(TT_DATA * TT_TENSOR), "-m", "zero_transformer_tpu_torch.train", "--cfg", "configs/train_125m.yaml",
              "--max-steps", "3", "--set", f"mesh.data={TT_DATA}", "--set", f"mesh.tensor={TT_TENSOR}", "--set",
              "data.source=synthetic", f"training.batch_size={DP_RANKS * DP_B}", f"model.n_layers={DP_LAYERS}",
              "training.log_frequency=1", "training.evaluation_frequency=0", f"checkpoint.directory={run_dir}"]
    return subprocess.Popen(launch, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "2"}), time.perf_counter()


def tt_cli_check(proc, t0: float, run_dir: Path) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("tensor_training (d): the trainer CLI did not finish within 600 s")
    if proc.returncode != 0:
        raise AssertionError(f"tensor_training (d): trainer CLI exit {proc.returncode}:\n{stdout[-3000:]}\n"
                             f"{stderr[-3000:]}")
    topo = next((json.loads(x)["distributed"] for x in stdout.splitlines() if x.startswith('{"distributed"')), None)
    records = [json.loads(x) for x in (run_dir / "metrics.jsonl").open()]
    train = [r for r in records if "loss" in r]
    steps = sorted(p.name for p in run_dir.iterdir() if p.is_dir())
    line = {"wall_s": time.perf_counter() - t0, "topology": topo, "steps_logged": [r["step"] for r in train],
            "losses": [r["loss"] for r in train], "step_dirs": steps,
            "tokens_per_sec": train[-1]["tokens_per_sec"] if train else None,
            "step_time_ms": train[-1]["step_time_ms"] if train else None}
    if (topo is None or topo["tensor"] != TT_TENSOR or topo["data"] != TT_DATA
            or line["steps_logged"] != [1, 2, 3] or steps != ["3"]
            or not all(math.isfinite(x) for x in line["losses"])):
        raise AssertionError(f"tensor_training (d): the trainer CLI over data 2 x tensor 2: {line}")
    return line


def tensor_training_phase() -> tuple:
    """Tensor-parallel training (``mesh.tensor``), four parts:

    (a) 125m at full width, depth DP_LAYERS, data 2 x tensor 2: ZeRO 0-3
    with AdamW (stage 3 with the chunked loss) and Adafactor, 3 steps each
    against the one-card trainer; the save and a data-4 resume
    (``check_tt_dp``), run inside data_parallel's world;
    (b) 580m at T 8192, SP_LAYERS layers, tensor 2 x sequence 2 through the
    ring and Ulysses against the one-card step (``check_tt_sp``), inside
    sequence_parallel's world (beside that phase's one-card reference);
    (c) llama3_8b over tensor 2 against llama_training's one-card steps
    (``tt_llama``), beside (d) the trainer CLI under torch.distributed.run
    over data 2 x tensor 2;
    then every new K1-K3 shape against its plain version with each rank's
    slopes (``tt_kernel_rows``). Returns the kernel rows and the launches
    of the main path's runs."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    TT_DIR.mkdir(parents=True, exist_ok=True)
    out = TT_DIR.resolve()
    launches, part_s = {}, {}
    a, b = TT_STASH["a"], TT_STASH["b"]  # main() runs data_parallel and sequence_parallel with this phase
    log({"tensor_training_a": a})
    launches.update({n + "_tp": a["tp_stage2"]["launches_rank0"][n] for n in ("flash_train_fwd", "flash_dq",
                                                                             "flash_dkv")})
    log({"tensor_training_b": b})
    launches.update({n + "_tp_ring": c for n, c in b["tp_ring"]["launches_rank0"].items()})
    launches.update({n + "_tp_ulysses": c for n, c in b["tp_ulysses"]["launches_rank0"].items()})
    cli_dir = out / "cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    proc, t_cli = tt_cli_start(cli_dir)
    try:
        t0 = time.perf_counter()
        c = tt_llama(out)
        part_s["c"] = time.perf_counter() - t0
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    log({"tensor_training_c": c})
    launches.update({n + "_tp_llama": cnt for n, cnt in c["launches_rank0"].items()})
    d = tt_cli_check(proc, t_cli, cli_dir)
    part_s["d_beside_c"] = d["wall_s"]
    log({"tensor_training_d": d})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = tt_kernel_rows()
    part_s["kernels"] = time.perf_counter() - t0
    log({"tensor_training_s": time.perf_counter() - t_phase, "tensor_training_part_s": part_s})
    return rows, launches


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


PHASES = ("kernels", "serving", "parity", "profile", "int8_kernels", "int8_serving", "train_kernels", "training",
          "resilience", "train_1_3b", "packed_kernels", "packed", "sp_kernels", "sequence_parallel", "data_parallel",
          "llama_kernels", "llama_serving", "llama_training", "generate", "serving_policy", "disagg", "slab_serving",
          "router", "tensor_serving", "tensor_training")
# what the phases write under build/ (the kernels' libraries and POLICY_DIR aside)
PHASE_DIRS = ("resilience", "train_1_3b", "packed", "sp", "train_580m_8k_sp", "train_580m_8k_one_card", "data_parallel",
              "data_parallel_nccl", "llama_training", "generate", "disagg", "slab_serving", "router", "tensor_serving",
              "tensor_training")
# named with --phases only: the ring's parity with every kernel on its f32 path, K4's
# anatomy, data parallelism over NCCL with a card per rank (4 cards), and the
# fit of the tensor cores' adder that the ALiBi-off K1 emulation uses
EXTRA_PHASES = ("sequence_parallel_f32", "k4_anatomy", "data_parallel_nccl", "tc_fit")
SOURCES = {
    "flash_serving_fwd": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                          "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "paged_attention": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                        "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    # the same kernel's int8 branch (paged_attention.py:121-135)
    "paged_attention_int8": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                             "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    "flash_train_fwd": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                        "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_dq": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                 "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_dkv": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                  "zero_transformer_tpu/ops/pallas/flash.py:214"),
    # the same kernels' packed-document branch (flash.py:108-110, `_scores`)
    "flash_train_fwd_docs": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                             "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_dq_docs": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                      "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_dkv_docs": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                       "zero_transformer_tpu/ops/pallas/flash.py:214"),
    # the same kernels at global offsets with f32 outputs: flash_partial
    # (flash.py:551) and flash_grads (:577), with and without document ids
    "flash_partial_fwd": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                          "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_partial_dq": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                         "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_partial_dkv": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                          "zero_transformer_tpu/ops/pallas/flash.py:214"),
    "flash_partial_fwd_docs": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                               "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_partial_dq_docs": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                              "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_partial_dkv_docs": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                               "zero_transformer_tpu/ops/pallas/flash.py:214"),
    # the training entry at D 128: 580m's one-card step (B 1, T 8192)
    "flash_train_fwd_d128": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                             "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_dq_d128": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                      "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_dkv_d128": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                       "zero_transformer_tpu/ops/pallas/flash.py:214"),
    # the training entry at 1_3b's shape (B 4, T 1024, 16 heads of 128)
    "flash_train_fwd_1_3b": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                             "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_dq_1_3b": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                      "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_dkv_1_3b": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                       "zero_transformer_tpu/ops/pallas/flash.py:214"),
    # llama3_8b's shapes, ALiBi off, 32 query heads on 8 kv heads of 128:
    # the serving chunk and decode (bf16 and int8 pools), and the training
    # entry at B 1, T 8192 (its depth cut to 4 layers)
    "flash_serving_fwd_llama": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                                "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "paged_attention_llama": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                              "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    "paged_attention_int8_llama": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                                   "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    "flash_train_fwd_llama": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                              "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_dq_llama": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                       "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_dkv_llama": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                        "zero_transformer_tpu/ops/pallas/flash.py:214"),
    # generate() over the slab cache (125m and llama3_8b): K1 on the prompt's
    # prefill and on a 9-token verify window of generate_speculative, K4 on a
    # decode step through the identity table (bf16 and int8) and on a 5-token
    # verify window
    **{f"{kernel}_{what}{model}": (src, tpu)
       for kernel, src, tpu in (("flash_serving_fwd", "zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                                 "zero_transformer_tpu/ops/pallas/flash.py:127"),
                                ("paged_attention", "zero_transformer_tpu_torch/csrc/paged_attention.cu",
                                 "zero_transformer_tpu/ops/pallas/paged_attention.py:100"))
       for what in ("generate", "verify") for model in ("", "_llama")},
    "paged_attention_int8_generate": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                                      "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    # the serving policy layer's prefix cache (125m, bf16): K1 on the chunk
    # after a hit (its rows at offset 512 read keys another request wrote into
    # now-shared pages) and K4 decoding rows whose 32 leading pages are shared
    "flash_serving_fwd_prefix": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                                 "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "paged_attention_prefix": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                               "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    # disaggregated serving (125m): K1 on a prefill-role replica's chunk, K4
    # decoding a decode-role replica's imported pages (bf16 and int8)
    "flash_serving_fwd_disagg": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                                 "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "paged_attention_disagg": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                               "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    "paged_attention_int8_disagg": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                                    "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    # the slab layout (125m, bf16): K1 on a one-shot prefill (B 1, a
    # 512-token bucket over the row's 1,024 keys) and K4 on the slab
    # engine's decode tick (B 4, through the fixed identity table)
    "flash_serving_fwd_oneshot": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                                  "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "paged_attention_slab": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                             "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    # tensor-parallel serving at TP 2: K1 on a prefill chunk and K4 on the
    # decode tick at a rank's local heads (125m: 6 query heads with the
    # slopes of heads 6-11; llama3_8b: 16 query on 4 kv heads)
    "flash_serving_fwd_tp": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                             "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "paged_attention_tp": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                           "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    "flash_serving_fwd_tp_llama": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                                   "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "paged_attention_tp_llama": ("zero_transformer_tpu_torch/csrc/paged_attention.cu",
                                 "zero_transformer_tpu/ops/pallas/paged_attention.py:100"),
    # Ulysses (580m, T 8192 over 4 ranks): the training entry over the whole
    # row at a rank's 3 heads, with the slopes of heads 3-5
    "flash_train_fwd_ulysses": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                                "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_dq_ulysses": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                         "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_dkv_ulysses": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                          "zero_transformer_tpu/ops/pallas/flash.py:214"),
    # tensor-parallel training: a tensor rank's heads with their slopes --
    # 125m over tensor 2 (6 heads of 64, heads 6-11), the ring's shards over
    # tensor 2 x sequence 2 (580m, 6 heads of 128), Ulysses over tensor 2 x
    # sequence 2 (3 heads of 128, heads 9-11), llama3_8b over tensor 2 (16
    # query on 4 kv heads, ALiBi off)
    **{f"{kernel}{sfx}": (src, tpu)
       for sfx in ("_tp", "_tp_ulysses", "_tp_llama")
       for kernel, src, tpu in (("flash_train_fwd", "zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                                 "zero_transformer_tpu/ops/pallas/flash.py:127"),
                                ("flash_dq", "zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                                 "zero_transformer_tpu/ops/pallas/flash.py:176"),
                                ("flash_dkv", "zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                                 "zero_transformer_tpu/ops/pallas/flash.py:214"))},
    "flash_partial_fwd_tp_ring": ("zero_transformer_tpu_torch/csrc/flash_fwd.cu",
                                  "zero_transformer_tpu/ops/pallas/flash.py:127"),
    "flash_partial_dq_tp_ring": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                                 "zero_transformer_tpu/ops/pallas/flash.py:176"),
    "flash_partial_dkv_tp_ring": ("zero_transformer_tpu_torch/csrc/flash_bwd.cu",
                                  "zero_transformer_tpu/ops/pallas/flash.py:214"),
}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only", file=sys.stderr)
        return 2
    phases = PHASES
    if argv[:1] == ["--phases"] and len(argv) == 2:
        phases = tuple(argv[1].split(","))
    elif argv:
        print(f"usage: chip_smoke.py [--phases {','.join(PHASES + EXTRA_PHASES)}]", file=sys.stderr)
        return 2
    if set(phases) - set(PHASES + EXTRA_PHASES):
        print(f"chip_smoke: unknown phases {sorted(set(phases) - set(PHASES + EXTRA_PHASES))}", file=sys.stderr)
        return 2
    if "tensor_training" in phases:  # its parts run in these phases' worlds and on their records
        phases = tuple(p for p in PHASES + EXTRA_PHASES if p in phases or p in TT_NEEDS)
    from zero_transformer_tpu_torch.ops import _build

    log(card_line())
    t_start = t0 = time.perf_counter()
    fresh = _build.build_all()
    log({"build_s": time.perf_counter() - t0, "per_source_s": fresh})
    for name, report in _build.ptxas_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Performance" in line:
                log(f"ptxas {name}: {line.strip()}")
    rows, launches = {}, {}
    phase_s = {}

    @contextlib.contextmanager
    def timed(name):
        """A phase's seconds, then its step, checkpoint and build
        directories deleted (the machine's disk is ~45 GiB; serving_policy's
        ``.npz`` stays for the later phases' CLIs until the end of the run)
        and the disk it leaves."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            phase_s[name] = time.perf_counter() - t0
            for sub in PHASE_DIRS:
                shutil.rmtree(Path("build") / sub, ignore_errors=True)
            usage = shutil.disk_usage(".")
            log({"phase_s": {name: phase_s[name]}, "disk_used_gb": usage.used / 1e9, "disk_free_gb": usage.free / 1e9,
                 "build_gb": sum(f.stat().st_size for f in Path("build").rglob("*") if f.is_file()) / 1e9})

    if "kernels" in phases:
        with timed("kernels"):
            rows.update(kernel_phase())
    bf16_serving = None
    if "serving" in phases:
        with timed("serving"):
            serving_launches, kernel_tokens, bf16_serving = serving_phase()
            launches.update({k: serving_launches[k] for k in ("flash_serving_fwd", "paged_attention")})
        if "parity" in phases:
            with timed("parity"):
                parity_phase(kernel_tokens)
    if "profile" in phases:
        with timed("profile"):
            profile_phase()
    if "int8_kernels" in phases:
        with timed("int8_kernels"):
            rows.update(int8_kernel_phase())
    if "int8_serving" in phases:
        with timed("int8_serving"):
            int8_launches, int8_tokens, int8_serving = serving_phase(int8=True)
            launches["paged_attention_int8"] = int8_launches["paged_attention_int8"]
            if bf16_serving is not None:
                keys = ("ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50", "itl_ms_p99", "decode_tok_s", "kv_pool_bytes",
                        "weight_bytes")
                log({"int8_vs_bf16_serving": {k: [int8_serving[k], bf16_serving[k]] for k in keys}})
            parity_phase(int8_tokens, int8=True)
            profile_phase(int8=True)
    if "train_kernels" in phases:
        with timed("train_kernels"):
            rows.update(train_kernel_phase())
    if "training" in phases:
        with timed("training"):
            train_launches = training_phase()
            launches.update({k: train_launches[k] for k in ("flash_train_fwd", "flash_dq", "flash_dkv")})
    if "resilience" in phases:
        with timed("resilience"):
            resilience_phase()
    if "train_1_3b" in phases:
        with timed("train_1_3b"):
            t13_rows, t13_launches = train_1_3b_phase()
            rows.update(t13_rows)
            launches.update(t13_launches)
    if "packed_kernels" in phases:
        with timed("packed_kernels"):
            rows.update(packed_kernel_phase())
    if "packed" in phases:
        with timed("packed"):
            packed_launches = packed_phase()
            launches.update({k: packed_launches[k] for k in ("flash_train_fwd_docs", "flash_dq_docs",
                                                             "flash_dkv_docs")})
    if "sp_kernels" in phases:
        with timed("sp_kernels"):
            rows.update(sp_kernel_phase())
    tensor_training = "tensor_training" in phases
    if "sequence_parallel" in phases:
        with timed("sequence_parallel"):
            sp_launches, sp_rows = sequence_parallel_phase(tensor_training=tensor_training)
            launches.update(sp_launches)
            rows.update(sp_rows)
    if "data_parallel" in phases:
        with timed("data_parallel"):
            data_parallel_phase(tensor_training=tensor_training)
    if "data_parallel_nccl" in phases:
        with timed("data_parallel_nccl"):
            data_parallel_phase("nccl")
    if "k4_anatomy" in phases:
        with timed("k4_anatomy"):
            k4_anatomy_phase()
    if "sequence_parallel_f32" in phases:
        with timed("sequence_parallel_f32"):
            sequence_parallel_phase(torch.float32)
    if "tc_fit" in phases:
        with timed("tc_fit"):
            tc_fit_phase()
    if "llama_kernels" in phases:
        with timed("llama_kernels"):
            rows.update(llama_kernel_phase())
    if "llama_serving" in phases:
        with timed("llama_serving"):
            launches.update(llama_serving_phase())
    if "llama_training" in phases:
        with timed("llama_training"):
            launches.update(llama_training_phase(record=tensor_training))
    for name, fn in (("generate", generate_phase), ("serving_policy", serving_policy_phase),
                     ("disagg", disagg_phase), ("slab_serving", slab_serving_phase)):
        if name in phases:
            with timed(name):
                phase_rows, phase_launches = fn()
                rows.update(phase_rows)
                launches.update(phase_launches)
    if "router" in phases:
        with timed("router"):
            router_phase()
    if "tensor_serving" in phases:
        with timed("tensor_serving"):
            tp_rows, tp_launches = tensor_serving_phase()
            rows.update(tp_rows)
            launches.update(tp_launches)
    if tensor_training:
        with timed("tensor_training"):
            tt_rows, tt_launches = tensor_training_phase()
            rows.update(tt_rows)
            launches.update(tt_launches)
    log({"phase_s": phase_s, "total_s": time.perf_counter() - t_start})
    shutil.rmtree(POLICY_DIR, ignore_errors=True)
    table = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu, "launches": launches[name],
         **rows[name]}
        for name, (src, tpu) in SOURCES.items() if name in rows and name in launches
    ]
    log({"kernels": table})
    if phases != PHASES:
        return 0
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
