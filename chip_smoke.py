#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--layers N]
                          [--only {train,swa,engine,mqa,ssm,encdec,moe,mla,
                                   vlm,hybrid,prefix,quant,tune,
                                   family_train,tp}]

Phases (any failure exits non-zero; nothing is caught):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, TF32 switches, and the build of every kernel from
   ``src/repro_torch/csrc`` (nvcc, one process per source, in parallel);
2. kernels: each CUDA kernel held against its plain PyTorch version on the
   card at the serving path's shapes (softmax under all three of the
   paper's algorithms, cross-entropy at the LM head's shape, decode
   attention), with its time, its plain version's time, one PyTorch
   library call's time where one computes the same function, and its
   bound (bytes over 3.35 TB/s or operations over the peak of the unit
   that does them, float32 or bf16 tensor cores, whichever is larger); the
   softmax rows are timed by CUDA-graph replay, eager beside, and each
   check names the layout a kernel took (rows of at most 8192 columns in
   registers, longer ones split over the fold's 32 slots); the softmax
   kernels' bits do not change when a row is padded with -inf columns,
   also across that boundary, the two-pass kernels' bits equal those
   recorded before their fold moved into ``rowfold.cuh``, the reload
   kernels' those of the one-block-a-row kernel before its two layouts, and
   ``xent_fwd_2d``'s those recorded before the max-first lane fold; the
   decode kernels' general tile body gives the bits recorded before the
   split-KV grid, and they are also timed at one slot of 16,384 positions;
   the paper's comparison times the three softmax algorithms side by side,
   also at a shape whose rows in flight exceed the 50 MB L2; the fused
   LM-head cross-entropy kernels (forward, dh, dw) at one loss chunk of the
   train phase and at a ragged shape, within float32 accumulation limits
   derived from the shapes, with the same bits on a second run, and at the
   train chunk the forward's bits and dh / dw's (from the plain forward's
   stats) as pinned; the
   flash-attention kernels (forward, and the dq and dk/dv backward) at the
   train phase's attention shape, a ragged causal float32 call with rows
   that see no key (exact zeros), a window, head dims 120, 160 and 256
   and stablelm-12b's train shape, within float32 accumulation limits
   derived from the inputs plus one bf16 step, with the same bits on a
   second run (bf16 with D and Dv multiples of 8 takes the mma.sync
   kernels, float32 the wmma / FFMA ones; each ``kernel_check`` line
   names its ``design``); at qwen2.5-14b's and granite-moe's train shapes
   the mma kernels' sha256 equals ``FLASH_MMA_DIGEST``, and no mma
   instantiation spills (``ptxas -v``);
3. engine: qwen2.5-14b at full width (d_model 5120, 40/8 heads, d_ff
   13824, vocab 152064, bf16, seeded random weights; depth cut to 16 of
   its 48 layers unless ``--layers`` says otherwise, so that the whole
   script stays inside its time limit) serving 12 requests
   through ``ContinuousBatchingEngine(paged=True, use_kernels=True,
   temperature=0)`` on 8 slots, the decode step captured in a CUDA graph
   when the engine is built and replayed (the main path); launch counts
   are zeroed just before the run and read just after; each pool is served
   again with the eager step (``fused=False``): the same tokens and the
   same launches, the graph's launches a replay, decode ms a step, tok/s,
   peak memory, the capture's seconds and its graph pool side by side
   (``engine_fused``), the device's idle share of a short traced run each
   way (``idle_share``) and of one decode burst alone, with the device's
   time a step by kernel group (``decode_trace``);
4. parity: the strip pool (``paged=False``) gives the same tokens; the
   plain forms (``use_kernels=False``) give prefill logits within a stated
   bf16 tolerance; a short ``temperature=0.8`` run drives the sampler's
   softmax kernel in every replay of the graph, as many launches as the
   eager step's;
5. three-pass baselines: the same 12 requests under
   ``softmax_algorithm="three_pass_recompute"`` and ``"three_pass_reload"``
   launch their own kernel for every prefill layer and no two-pass one;
   the strip pool gives the paged tokens under one of them; prefill logits
   are held against the two-pass run's; a ``temperature=0.8`` run under
   each launches its kernel for the sampler;
6. cross-entropy: the per-token loss of a prompt under the served model
   through ``SoftmaxPolicy.cross_entropy`` with kernels, and its gradient,
   against the plain route (the prompt's forward takes the flash route);
7. swa: the sliding-window ring cache and head dims 120 / 160 at full
   width.  The decode kernels at G 4 with D 120 under the 4096 window and
   D 160 without one, and the two-pass softmax on partly written ring
   rows [4096, 4096], against their plain versions; h2o-danube-3-4b (24
   layers, window 4096) serving 8 requests of 4,500-7,000 prompt tokens
   and stablelm-12b (40 layers, head dim 160, vocab 100352) serving 4 of
   300-1,500, each through ``Model.serving_engine`` paged (the main path,
   the decode step a CUDA graph), paged with the eager step (the same
   tokens and launches), strip (the same tokens) and at
   ``temperature=0.8`` (the sampler's
   kernel on rows past 8192 columns); h2o's ring (``Model.init_cache``,
   ``Model.decode_step``) stepped 4,160 times from position 0 at 2 of its
   24 layers against a position-addressed cache prefilled with the first
   4,096 tokens, greedy tokens equal over the 64 steps past the wrap; and
   the ring at the decode_32k cell's shape (batch 128, 32,768 positions,
   ~48.3 GB where ``ring=False`` would need ~386.5 GB) stepped 8 times,
   with its peak memory;
8. mqa: granite-20b (52 layers, d_model 6144, 48 query heads over one
   KV head of 128, d_ff 24576, vocab 49152, 56.3 GB of bf16 weights, the
   earlier phases' models freed first).  The decode kernels at the served
   shape [8, 1, 48, 128] (G 48) against their plain versions, timed beside
   ``scaled_dot_product_attention``; then, as the swa phase serves its
   models, 8 requests of 200-1,500 prompt tokens + 32 new on 8 slots
   (``max_len`` 1664): paged with the decode step a CUDA graph (the main
   path), paged eager (the same tokens and launches), strip (the same
   tokens), ``temperature=0.8``, the two-pass kernel on its prefill score
   rows [48 S, S] and sampler rows, prefill logits against
   ``use_kernels=False``, and ms a step beside the weights' read time;
9. ssm: rwkv6-1.6b (24 layers, d_model 2048, 32 heads of 64, d_ff 7168,
   vocab 65536, bf16 weights, 12.6 MB of recurrent state a slot) on the
   strip pool at 4 of its 24 layers (the whole script's time limit),
   32 slots: 48 requests of 200-4,000 prompt tokens + 64 new,
   greedy, the decode step a CUDA graph (the main path) and eager (the
   same tokens and launches, the state after the run bit-equal), with
   ``use_kernels=False`` (the same tokens), then ``temperature=0.8``
   under each softmax algorithm, one request a slot (its kernel once a
   replay; two-pass also eager, as many launches), each kernel held
   against its plain version on
   the sampler rows [32, 65536]; a decode burst under the profiler, graph
   and eager; and, at all 24 layers, the chunked scan's scan branch, one
   prompt of 16,384
   tokens (64 chunks of 256) against 16,128 prefilled + 256 decode steps,
   bf16 and float32, logits and state within a stated share of the
   largest value, the next 32 greedy tokens equal in float32;
10. encdec: whisper-base at full width and depth (6 encoder and 6 decoder
   layers, d_model 512, 8 heads of 64 over 8 KV heads, d_ff 2048, GELU,
   vocab 51865, bf16 weights).  The flash forward non-causal at D 64 over
   one 30-s window [1, 8, 1500, 64] (the encoder), a prefill bucket's
   queries against it [1, 8, 128, 1500] (the cross-attention at prefill)
   and one query a slot [32, 8, 1, 1500] (the lockstep cross read), the
   paged decode at G 1, D 64 over cross lengths 600-1,500 and self lengths
   up to 448, and the two-pass softmax on the decoder prefill's score rows
   and the sampler's rows, each against its plain version and timed beside
   its bound and ``scaled_dot_product_attention``; then 64 greedy
   requests (48 of 1,500 frames, 16 of 600-1,499; decoder prompts of
   4-64 tokens; 32-192 new tokens) on 32 slots, paged, ``max_cross_len``
   1,500: the decode step a CUDA graph (the main path) and eager (the
   same tokens, launches and arena pages), ``temperature=0.8`` under each
   softmax algorithm, chunked admission (``enc_chunk`` 500, graph ==
   eager), prefill logits against ``use_kernels=False``, the served bf16
   tokens fed back through the engine's step and the lockstep one (``==``
   where the top-2 margin exceeds twice their logit difference), a decode
   burst under the profiler, graph and eager, and a 2-layer float32 cut
   whose served tokens ``==`` the batch-1 lockstep ``Model.generate``;
11. moe: granite-moe-3b-a800m at full width, depth cut to 16 of its 32
   layers so that the whole script stays inside its time limit (d_model
   1536, 24 query heads over 8 KV heads of 64, 40 experts top 8 of
   d_expert 512, no shared expert, vocab 49155, bf16 weights with the
   router in float32).  The two-pass softmax and the three-pass kernels
   on the router's float32 rows [2048, 40] and [32, 40] and on the
   sampler's rows [32, 49155], and the decode kernels at G 3, D 64 over
   32 slots of up to 4,160 positions, bf16 and float32, each against its
   plain version, timed beside its library call and bound; then 50
   greedy requests (48 of 200-2,048 prompt tokens, one of 4,096 -- two
   capacity groups of 2,048 -- and one of 3,000, capacity 750; 64 new
   tokens each) on 32 slots, ``max_len`` 4,160, ``moe_impl="dispatch"``:
   paged with the decode step a CUDA graph (the main path: the router's
   softmax and the decode read once a layer a replay), paged eager (the
   same tokens, launches and arena pages), strip (the same tokens) and
   under ``moe_impl="gather"`` (the dispatch tokens wherever the top-2
   margin exceeds twice the impls' logit difference, from both fed the
   served tokens), ``temperature=0.8`` under each softmax algorithm (the
   router and the sampler through its kernel), prefill logits against
   ``use_kernels=False``, the 16 layers' MoE of one step alone beside the
   time to read every expert once, a decode burst under the profiler,
   graph and eager (the MoE's kernels a group of their own), and a
   2-layer float32 cut whose served tokens ``==`` the batch-1 lockstep
   ``Model.generate``;
12. multi-head latent attention: deepseek-v2-lite-16b at full width,
   depth cut to 7 of its 27 layers so that the whole script stays
   inside its time limit (16 heads of 128 nope + 64 rope query / key columns and
   128 value columns, a 512-wide latent cache, 64 experts top 6 plus 2
   shared; bf16 weights, the router float32).  Kernels 12-13
   with v's head dim apart from q's (D 192 / Dv 128 at a 2,048-token
   prompt, D 24 / Dv 16 reduced, bf16 and float32) within
   ``flash_limits``, kernel 4 at G 1, D 192 / Dv 128 over 16 slots of up
   to 4,160 positions, kernels 1, 5, 6 on its router and sampler rows,
   each timed beside its bound and library call; then 40 requests of
   200-2,048 tokens and one of 4,096, 64 new tokens each, on 16 slots
   (``max_len`` 4,160, pages of 64) through the moe phase's runs (graph
   ``==`` eager tokens, launches and latent pages; strip ``==`` paged;
   ``temperature=0.8`` under each algorithm), the no-cache forward's
   logits (kernel 12 in every layer) against ``use_kernels=False``, a
   graph and an eager decode trace (the eager one's up-projection and
   expansion and its experts grouped by host range) and a 2-layer
   float32 cut ``==`` ``Model.generate``;
13. vlm: qwen2-vl-7b at full width and depth (28 layers, d_model 3584,
   28 query heads over 4 KV heads of 128, d_ff 18944, vocab 152064,
   M-RoPE sections (16, 24, 24), 256 stub patches; 15.2 GB of bf16
   weights).  The decode kernels at G 7, D 128 over 16 slots of up to
   2,176 positions, bf16 and float32, kernel 12 at the patch forward's
   [1, 28, 768, 128] causal, and kernel 1 on the prefill score rows
   [28 S, S] of the longest prompt and the sampler's rows, each against
   its plain version and timed beside its bound and library call; then 40
   text requests of 100-2,000 tokens (both sides of the 256-token vision
   grid), 64 new tokens each, on 16 slots, ``max_len`` 2,176, through the
   moe phase's runs (graph ``==`` eager tokens, launches and pages; strip
   ``==`` paged; ``temperature=0.8`` under each algorithm), prefill logits
   against ``use_kernels=False``, a graph and an eager decode trace; the
   serving CLI's lockstep path with patches (batch 8, 256 patches + 512
   text tokens, 32 steps through ``Model.generate``, the prefill logits
   with patches against ``use_kernels=False``, the no-cache forward with
   patches, kernel 12 in every layer, against the plain route); a 2-layer
   float32 cut (engine ``==`` lockstep; with patches ``generate`` kernels
   ``==`` plain, the forward within 1e-4); and
   ``python -m repro_torch.launch.serve --arch qwen2-vl-7b --kernels``;
14. hybrid: hymba-1.5b at full width, 8 of its 32 layers (the script's
   time limit; the CLI at all 32) (d_model 1600,
   25 query heads over 5 KV heads of 64 under a 1,024 window, 25 mamba
   heads of 64 with state 16 in every block, d_ff 5504, vocab 32001;
   3.28 MB of float32 ssm state a slot, slot-major beside the paged
   attention arenas).  The decode kernels at G 5, D 64, window 1024 over
   32 slots of up to 3,136 positions, bf16 and float32, and kernel 1 on
   the windowed prefill score rows [25 S, S] and the sampler's rows; then
   48 requests of 200-3,000 tokens, 64 new tokens each, on 32 slots,
   ``max_len`` 3,136 in pages of 64, through the same runs (graph ``==``
   eager tokens, launches, pages and the ssm state bit for bit), prefill
   logits against ``use_kernels=False``, ``Model.decode_step`` on the
   ring (``init_cache(ring=True)``) past its wrap at 2 of the 32 layers
   against a prefilled position-addressed cache, as h2o's, a decode trace
   of the graph step, a 2-layer float32 cut ``==`` the lockstep, and
   ``python -m repro_torch.launch.serve --arch hymba-1.5b --kernels``;
15. training: qwen2.5-14b at full width, depth cut to 4 layers (float32
   parameters, bf16 activations, remat), batch 1 x 4096 from SyntheticLM,
   with the model's own ``use_kernels``: from one state the kernel route
   (flash attention, fused LM-head CE) and the plain route (tensor forms,
   materialised logits) give the loss and four parameters' gradients
   within stated limits, then three steps through ``Trainer.run`` launch
   the flash forward 8 times a step (4 layers, again under remat), its
   backward 4 times and each LM-head kernel 8 times (one per loss chunk),
   a fourth under the profiler shows where the step's device time goes,
   and the same three steps on the plain route from the same initial
   weights give the comparison;
16. the serving CLI, ``python -m repro_torch.launch.serve ... --softmax
   three_pass_reload --kernels``, at full width, as a subprocess;
17. the training CLI, ``python -m repro_torch.launch.train --arch
   qwen2.5-14b --reduced --kernels`` with a checkpoint directory under
   ``build/``: 6 steps straight, then 3 and a resume to 6, whose final
   losses agree;
18. prefix sharing and streaming: the engine phase's qwen2.5-14b (full
   width, ``--layers`` deep, bf16, paged, 8 slots, ``max_len`` 1,664,
   pages of 128) serving 20 greedy requests that share a head (16 of its
   1,000 tokens and tails of 24-400, 4 that leave it mid-page at token
   900; 32 new tokens each): the prefix cache on (``"auto"``) with the
   graph step, driven through ``stream()`` (its deltas ``==`` the
   tokens), on with the eager step (the same tokens, launches and
   counters) and off; at least 19 hits, copy-on-write copies, kernel 1 in
   every layer of each hit's tail prefill, kernel 3 over pages that two
   slots' rows name, free + cached pages == usable when the run ends;
   prefill seconds, tok/s, tokens reused and peak pages on and off; a run
   on a 48-page arena that evicts cached pages, and each hit's
   first-token logits against a whole prefill within the engine phase's
   bf16 limit.  Tokens on, off and evicted are held ``==``; where they
   differ, each request's first differing position and the off run's
   top-2 margin there are reported.  The mla phase serves 8 requests
   sharing a 1,024-token head under ``moe_impl="dense"`` and the vlm
   phase 8 text requests sharing a 400-token head (across the 256
   positions of the vision grid) the same way, on and off;
19. int8 pages and the host-RAM swap tier: the engine phase's
   qwen2.5-14b (full width, ``--layers`` deep, bf16, 8 slots, ``max_len``
   1,664, pages of 128) serving 12 greedy requests of 200-1,500 prompt
   tokens + 32 new from bf16 pages, int8 "page" and int8 "page_head"
   pages, each through the graph step (the main path) and the eager step:
   tokens, launches and the arenas' codes and scales equal; kernel 3 at
   that shape (q [8, 8, 5, 128] bf16) over bf16 pages (its bf16 body)
   and int8 pages at both granularities (its general body, the scales
   fused) against its plain version, timed beside its bound; the pools'
   pages at one budget (int8 >= 1.8x the bf16 page tokens); int8 against
   bf16 tokens reported with the top-2 margin at each first difference;
   the swap tier on an arena that holds the first 8 prompts and no more
   page (57 of 105 pages), the prefix cache off: demotions == promotions
   > 0, nothing preempted, each promotion's bytes equal to its
   demotion's, each one's ms and MB, on bf16 and int8 pages; and a
   2-layer float32 cut (int8 kernels == the plain route over the same
   pools, logits within 1e-4; the swap run == the unpressured run).
   The ``kernels`` line counts kernel 3's launches over int8 arenas apart
   (``decode_attention_paged_int8``, from the int8 "page" graph run);
20. the block-shape autotuner (``repro_torch.kernels.autotune``): into a
   cache file under ``build/``, the reference's sweep rows that reach a
   CUDA kernel (kernels 3 and 4 at 8 slots x 4,096 positions, bf16 and
   float32; int8 page layouts at 2 KV heads x 4,096; the LM-head forward
   and backward at 128 x 4,096), qwen2.5-14b's served buckets (kernels 3
   and 4 at 8 x 1,664 bf16, its page size, its int8 layout at 8 KV
   heads) and the LM-head at the train chunk (512 x 152,064 bf16), each
   with its timing table, best, default and speedup; each tuned block held
   against its plain version (the decode sweeps at their inputs, kernels
   3 and 4 at the served shape under the tuned and the heuristic's blocks,
   over the tuned int8 layout and over 512-token pages, the LM-head at the
   train chunk at the best ``block_v`` within ``lmhead_limits``); then
   the engine phase's qwen2.5-14b (``--layers`` deep) serving 12 requests
   from the tuned cache (``softmax_autotune=True``: page size, pages a
   tile and the strip tile resolved before the graph's capture) through
   the graph step (the main path), the eager step (tokens and launches
   ``==``), the strip pool (``==`` paged where the tiles coincide, else
   the margin rule) and int8 pages (page size and granularity from the
   cache), and with the heuristic's blocks (``==`` where page and tile
   coincide, else tokens where the top-2 margin exceeds twice the logit
   difference, both fed the same tokens);
21. training every family but dense (phase 15): kernels 12-13 at the
   shapes their train steps give them (whisper-base's encoder [1, 8,
   1500, 64] and cross-attention [1, 8, 447 | 1500, 64], non-causal, and
   its decoder [1, 8, 447, 64] causal; qwen2-vl-7b's [1, 28 | 4, 4095,
   128] causal, G 7; hymba-1.5b's [1, 25 | 5, 4095, 64] causal under its
   1,024 window, G 5; granite-moe-3b-a800m's [1, 24 | 8, 4095, 64]
   causal, G 3; deepseek-v2-lite-16b's [1, 16, 4095, 192] causal, Dv
   128), kernel 1 on the routers' float32 rows of one train group
   ([4095, 40], [4095, 64]) and kernels 9-11 at each family's loss chunk
   (d 512 / 2048 / 3584 / 1600 / 1536 / 2048 over its padded vocabulary,
   and the configs' own 51,865 and 32,001, whose bf16 rows take the
   cp.async loads), each within the derived limits of the kernel phase
   and timed beside its bound, plain version and library call; then
   whisper-base (8 x (1,500 frames, 448 decoder tokens)), rwkv6-1.6b (1
   x 4,096, 4 of its 24 layers), qwen2-vl-7b (1 x (256 patches + 3,840
   tokens), 4 of its 28 layers), hymba-1.5b (1 x 4,096, 16 of its 32),
   granite-moe-3b-a800m (1 x 4,096, 8 of its 32 layers; the depths cut
   for the script's time limit) and deepseek-v2-lite-16b (1 x 4,096, 4
   of its 27
   layers; both moe_impl "dispatch", one group of 4,095 tokens) at full
   width, float32 parameters, bf16 activations, remat: from one state the
   kernel route against the plain route (the loss and four or five
   gradients within limits derived from both routes' logits,
   ``family_parity_limits``, with a block's bf16 ops counted by
   ``block_roundings``), the launches of kernels 1 and 9-13 against the
   count the shapes imply, three AdamW steps through ``Trainer.run``
   (finite losses, the first within 1.5 of ln V; ms, tokens/s, peak
   bytes), a traced fourth step (``train_trace``: device time by group,
   a moe model's router, experts, shared experts and dispatch / combine
   apart, idle share), and ``python -m repro_torch.launch.train
   --reduced --kernels`` for each family;
21. tp: tensor-parallel serving (ROADMAP item 22, its serving half) over
   a ``('data', 'model')`` mesh of rank processes that the script spawns
   on the one card, backend ``gloo`` (NCCL takes one rank a card), eager
   (gloo's collectives cannot be captured in a CUDA graph): full-width
   qwen2.5-14b with seeded bf16 weights at tp 2 (mesh 1x2, 20 / 4 heads
   and 76,032 vocabulary columns a rank, the grouped layout; 8 of 48
   layers, 8 slots, 12 requests of 200-1,500 + 32 tokens) and tp 3 (mesh
   1x3, 40 heads padded to 42, KV replicated, each rank's 14 q-heads
   regrouped over a view of its run of KV heads in decode; 4 layers, 4
   requests).  Greedy tokens held against the single-process
   engine on the same weights: ``==`` wherever the single process's top-2
   margin exceeds twice the largest logit difference between the two
   (each token's logits recorded as it is drawn, the recorder's own
   time left out of the step's; the row-parallel ``all_reduce`` sums in
   another order), the logit difference itself within LOGIT_TOL of the
   largest logit and the rule deciding at least a quarter of the
   contexts; kernels 1, 2 (the
   sampler's local pass 1, at temperature 0.8) and 3 at the ranks' local
   shapes against their plain versions, and the ranks' launches of them
   in the main path's runs; the backend, ms a decode step and the ms the
   collectives take a step (a card shared by the ranks and gloo's host
   copies: no statement about a link between cards).
22. tp_train: training over a ``('data', 'model')`` mesh (ROADMAP item 22,
   its training half), ranks spawned on the one card over gloo:
   qwen2.5-14b at full width (4 of its 48 layers, as the train phase;
   float32 parameters, bf16 activations, remat, kernels on) through
   ``Trainer.run`` over mesh 1x2 (tensor parallel: 20 / 4 heads a rank,
   the vocabulary 76,032 columns a rank; 1 x 4,096 tokens, 3 steps) and
   mesh 2x1 (FSDP over data; a global batch of 2 x 4,096, 2 steps, at 2
   layers: gloo's host copies of the FSDP traffic),
   each held against the single process on the same weights and batches
   (2x1 against ``microbatches=2``): 1x2's loss at every step within
   the train-parity bound (2^-8 of the largest logit + 1e-4) and its grad
   norm within 2^-5, 2x1's loss and grad norm at every step equal; each
   rank's
   peak bytes, ms a step, the collectives' share of it and its launches
   of kernels 9-13.  Kernels 9-11 at a rank's columns (bf16 [512, 5120]
   x [5120, 76,032]): every label outside the shard (a label logit of
   exactly 0), the backward fed the fold of both ranks' stats, and the
   ranks' folded loss against kernel 9 over all 152,064 columns; kernels
   12-13 at a rank's heads ([1, 20 / 4, 4096, 128] bf16); times beside
   bounds.  The training CLI under torchrun, reduced: ``--mesh 1x2``
   saves, ``--mesh 2x1`` and then no mesh resume.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import importlib
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_S = 989e12        # H100 SXM dense bf16 on the tensor cores
# Float instructions an element, counted in the kernels' SASS
# (scripts/softmax_probe.py): twopass_regs_kernel<float, 4> 1354 and
# recompute_regs_kernel<float, 4> 1615 for 32 elements a lane.
SOFTMAX_OPS = 42           # both passes, ExtExp once
STATS_OPS = 46             # float ops per element, pass 1 (with its folds)
RECOMPUTE_OPS = 50         # Alg 1: max, sum and scale, ExtExp twice
RELOAD_OPS = 32            # Alg 2: max 1, exp + store + sum 30, scale 1
XENT_BWD_OPS = 31          # pass 2 (28) + the one-hot, subtract, scale
# sha256 of the two-pass kernels' outputs on twopass_digest's inputs, as
# the kernels gave them before their fold moved into rowfold.cuh (commit
# 74bac5d); the move must change no bit.
TWOPASS_DIGEST = ("a70341be27101df64373f32d0bd805d7"
                  "cfedd171cb181f04eb8442d31de3af6e")
# sha256 of the reload kernel's outputs on reload_digest's inputs, as the
# one-block-a-row kernel gave them (commit 92a27cb, on an H100): its
# register and split layouts must change no bit.
RELOAD_DIGEST = ("b7eb6c7578f75f46d06721cd42dc6ba6"
                 "dd498a2b91079ebe7f9c7053c602e98a")
# sha256 of xent_fwd_2d's outputs on xent_digest's inputs, as the kernel gave
# them before the max-first lane fold and the conversion-free exp2_int
# (commit 44094ad): neither may change a bit.
XENT_DIGEST = ("50efecde4bf1d747a37544f31fa8de5f"
               "18184cdc9762ceca49f2e51cbc545f76")
# sha256 of the decode kernels' outputs through the general tile body on
# decode_digest's inputs, as the one-block-per-slot kernels gave them
# before the split-KV grid (commit 5b92b8c): the split must change no bit.
DECODE_DIGEST = ("f8030f5dd4e4c81d538c1e1a32c501bd"
                 "903d4cf5315f7a115aa8a04772986fb1")
# sha256 of lmhead_xent_dh_2d's and lmhead_xent_dw_2d's outputs on
# lmhead_digest's inputs (the stats from the plain forward), as the wgmma
# kernels of commit 86aca79 give them on an H100: a change to the forward
# kernel must not move it.  (With the forward kernel's stats those kernels
# gave b31d42bf...f2f9ba; the wmma kernels before them 116c7416...f20b76.)
LMHEAD_DIGEST = ("01b9d3e64bead230971d09416538e945"
                 "e7c436ffcc9fd2c68fad40dfd078a058")
# sha256 of lmhead_xent_fwd_2d's outputs on lmhead_fwd_digest's inputs, as
# the wgmma forward gives them on an H100 (commit 83938bf gave the same
# with its w multicast over clusters of 1, 2 and 4 token tiles).  The
# wmma forward before it gave e1800cf1...73640f (commit a03f3e2): each
# logit now sums its 16-deep k steps in the backward's order, and the fold
# takes 256-column tiles.
LMHEAD_FWD_DIGEST = ("d7c2045d23f88365945da27bc91db8d7"
                     "d9f054744b3c2941c0e55c75de108001")
# sha256 of the flash kernels' (o, m_sum, n_sum, dq, dk, dv) at flash_check's
# inputs, the backward from the kernel forward's residuals, as the mma
# kernels of commit 2919eec (before they took DP and DVP apart) give them
# on an H100 (scripts/flash_probe.py --digest): the templated kernels must
# change no bit at D <= 128.
FLASH_MMA_DIGEST = {
    "train_bf16": ("85c47c8018aaa084f00639987eb3f01c"
                   "78ffba51e91002b3120753bf50febae8"),
    "granite_moe_g3": ("d521a030bcea9ede8b0c0b1709a7e5e5"
                       "c83a9c76b4f44cf267ed9ef28fcf9f22")}
ARCH = "qwen2.5-14b"
MAX_LEN = 1664             # 13 pages of 128: prompts up to 1500 + 32 new
N_SLOTS = 8
N_REQ = 12
NEW_TOKENS = 32


def say(tag: str, **kw) -> None:
    print(json.dumps({"phase": tag, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ---------------------------------------------------------------------------
# Timing.
# ---------------------------------------------------------------------------
def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn``, each after an L2
    flush (the serving path meets every layer's data cold)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Median device time of ``fn`` captured once in a CUDA graph and
    replayed ``iters`` times, each after an L2 flush as in :func:`cuda_ms`.
    The host's cost of the call (checks, ctypes, allocation) is left out:
    the decode kernels run in less time than their wrapper takes on the
    host, so :func:`cuda_ms` would time the host."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del graph
    return statistics.median(times)


def bound(nbytes: float, ops: float,
          bf16_ops: float = 0.0) -> tuple[float, str]:
    """Least time: bytes over the memory rate, float32 operations over the
    FFMA peak, bf16 tensor-core operations over their peak (the units run
    side by side, so the largest of the three)."""
    tb = nbytes / HBM_BYTES_S * 1e3
    to = max(ops / F32_OPS_S, bf16_ops / BF16_OPS_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------
def err(got, want):
    """(max abs error, max relative error) of ``got`` against ``want``."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return (float(d.max()),
            float((d / w.abs().clamp(min=1e-30)).max()))


def held(got, want, tol, what):
    """Fail unless |got - want| <= atol + rtol |want| everywhere."""
    a, rel = err(got, want)
    excess = float(((got.float() - want.float()).abs()
                    / (tol["atol"] + tol["rtol"] * want.float().abs()))
                   .max())
    check(excess <= 1.0, f"{what}: max abs err {a} beyond {tol}")
    return dict(max_abs_err=a, max_rel_err=rel, tol=tol,
                worst_err_over_limit=excess)


def timed(torch, fn, plain, library):
    """The softmax rows' times: device time by graph replay (the register
    kernels take less than their wrapper's host time), eager beside; the
    plain version eager."""
    return dict(ms=graph_ms(torch, fn), eager_ms=cuda_ms(torch, fn),
                plain_ms=cuda_ms(torch, plain, 5),
                library_ms=graph_ms(torch, library),
                library_eager_ms=cuda_ms(torch, library))


# softmax rows on the serving path: prefill score buckets (40 heads x
# bucket rows, causal), a ragged row count, the sampler over the vocab
SOFTMAX_SHAPES = [("prefill_bucket_1024", 40 * 1024, 1024),
                  ("prefill_bucket_1664", 40 * 1664, 1664),
                  ("ragged", 40 * 37, 1000), ("sampler", 8, 152064)]
LM_HEAD = (2048, 152064)        # tokens x vocab of the cross-entropy
SOFTMAX_KERNELS = ("twopass_softmax_2d", "twopass_stats_2d",
                   "threepass_recompute_2d", "threepass_reload_2d")


def score_rows(torch, rng, name: str, r: int, c: int):
    """Seeded float32 scores [r, c] on the card; prefill rows are causal:
    columns past the query are -inf, as on the path."""
    x = torch.from_numpy(rng.standard_normal((r, c), dtype="float32")
                         * 8).to("cuda")
    if name.startswith("prefill"):
        x = torch.where(torch.arange(c, device="cuda")[None, :]
                        > torch.arange(r, device="cuda")[:, None] % c,
                        -torch.inf, x)
    return x


def twopass_digest(torch, tp) -> str:
    """sha256 of the two-pass softmax and stats kernels' outputs on seeded
    inputs: causal prefill rows and ragged rows in float32 and bfloat16,
    and the sampler's row width."""
    h = hashlib.sha256()
    rng = np.random.default_rng(1234)
    for name, r, c, dt in (("prefill", 4096, 1024, torch.float32),
                           ("ragged", 40 * 37, 1000, torch.float32),
                           ("ragged", 40 * 37, 1000, torch.bfloat16),
                           ("sampler", 8, 152064, torch.float32)):
        x = score_rows(torch, rng, name, r, c).to(dt)
        for t in (tp.twopass_softmax_2d(x), *tp.twopass_stats_2d(x)):
            h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()


def reload_digest(torch, tp3) -> str:
    """sha256 of the reload (Alg 2) kernel's outputs on twopass_digest's
    seeded inputs."""
    h = hashlib.sha256()
    rng = np.random.default_rng(1234)
    for name, r, c, dt in (("prefill", 4096, 1024, torch.float32),
                           ("ragged", 40 * 37, 1000, torch.float32),
                           ("ragged", 40 * 37, 1000, torch.bfloat16),
                           ("sampler", 8, 152064, torch.float32)):
        x = score_rows(torch, rng, name, r, c).to(dt)
        h.update(tp3.threepass_reload_2d(x).float().cpu().numpy().tobytes())
    return h.hexdigest()


def xent_digest(torch, xe) -> str:
    """sha256 of ``xent_fwd_2d``'s outputs (loss, m_sum, n_sum) on seeded
    logits: float32 and bfloat16 rows of 1000 columns and float32 rows of
    the vocabulary, with labels inside and outside [0, V)."""
    h = hashlib.sha256()
    rng = np.random.default_rng(2468)
    for r, c, dt in ((300, 1000, torch.float32), (300, 1000, torch.bfloat16),
                     (16, 152064, torch.float32)):
        x = torch.from_numpy(rng.standard_normal((r, c), dtype="float32")
                             * 4).to("cuda").to(dt)
        lab = torch.from_numpy(rng.integers(-1, c + 1, r)).to("cuda")
        for t in xe.xent_fwd_2d(x, lab):
            h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()


def lmhead_inputs(torch, shape, dt):
    """Seeded ``(h, w, labels, dloss)`` on the card for the LM-head CE
    kernels at ``shape`` = (T, D, V); labels[0] = V lies outside [0, V)."""
    t, d, v = shape
    g = torch.Generator(device="cuda").manual_seed(13)
    h = torch.randn(t, d, device="cuda", generator=g).to(dt)
    w = (torch.randn(d, v, device="cuda", generator=g) * d ** -0.5).to(dt)
    lab = torch.randint(0, v, (t,), device="cuda", generator=g)
    lab[0] = v                                       # outside: gathers 0
    dl = torch.randn(t, device="cuda", generator=g) / t
    return h, w, lab, dl


def lmhead_digest(torch, xe) -> str:
    """sha256 of ``lmhead_xent_dh_2d``'s and ``lmhead_xent_dw_2d``'s
    outputs at one loss chunk of the train phase (bf16, ``block_v`` 8192)
    on :func:`lmhead_inputs`.  The stats they take come from the plain
    forward on the card (cuBLAS float32, TF32 off: one result a card and
    library), so that the pin moves with the backward kernels alone and
    not with the forward kernel's sum order."""
    h, w, lab, dl = lmhead_inputs(torch, LMHEAD_TRAIN, torch.bfloat16)
    _, m, n = xe.lmhead_xent_fwd_2d_plain(
        h, w, lab, xe.lmhead_v_chunks(w.shape[1], LMHEAD_BLOCK_V))
    out = hashlib.sha256()
    for fn in (xe.lmhead_xent_dh_2d, xe.lmhead_xent_dw_2d):
        x = fn(h, w, lab, m, n, dl, block_v=LMHEAD_BLOCK_V)
        out.update(x.cpu().numpy().tobytes())
        del x
    return out.hexdigest()


def lmhead_fwd_digest(torch, xe) -> str:
    """sha256 of ``lmhead_xent_fwd_2d``'s outputs (loss, m_sum, n_sum) at
    one loss chunk of the train phase (bf16) on :func:`lmhead_inputs`."""
    h, w, lab, _ = lmhead_inputs(torch, LMHEAD_TRAIN, torch.bfloat16)
    out = hashlib.sha256()
    for t in xe.lmhead_xent_fwd_2d(h, w, lab, block_v=LMHEAD_BLOCK_V):
        out.update(t.cpu().numpy().tobytes())
    return out.hexdigest()


def decode_digest(torch, da) -> str:
    """sha256 of the decode kernels' outputs on seeded inputs, every launch
    through the general tile body: bf16 and float32 q / K / V with and
    without a window, strip and paged, and int8 pages at both scale
    granularities under both q dtypes.  Lengths 0, 1, 128 (one tile), 129
    and 700 (six tiles; window 300 starts at the fourth).  Runs against a
    tree whose wrapper has no ``kernel_body`` as well: there every launch
    takes the one kernel it has."""
    h = hashlib.sha256()
    rng = np.random.default_rng(4321)
    s, hkv, g, d, ps, pmax = 5, 2, 5, 128, 64, 12
    n_pages = 1 + s * pmax

    def card(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to("cuda")

    tab = card(rng.permutation(np.arange(1, n_pages)).reshape(s, pmax)
               .astype(np.int32))
    lens = card(np.array([0, 1, 128, 129, 700], np.int32))
    q = card(rng.standard_normal((s, hkv, g, d), dtype=np.float32))
    kp, vp = (card(rng.standard_normal((n_pages, ps, hkv, d),
                                       dtype=np.float32)) for _ in "kv")
    k8, v8 = (card(rng.integers(-127, 128, (n_pages, ps, hkv, d))
                   .astype(np.int8)) for _ in "kv")
    scales = {"page": [card(rng.uniform(0.001, 0.02, (n_pages, ps))
                            .astype(np.float32)) for _ in "kv"],
              "page_head": [card(rng.uniform(0.001, 0.02, (n_pages, ps, hkv))
                                 .astype(np.float32)) for _ in "kv"]}
    sc = d ** -0.5
    outs = []
    chooser = getattr(da, "kernel_body", None)
    if chooser is not None:
        da.kernel_body = lambda *a: "general"
    try:
        for dt in (torch.bfloat16, torch.float32):
            qq, kk, vv = q.to(dt), kp.to(dt), vp.to(dt)
            ks = kk[tab.long()].reshape(s, pmax * ps, hkv, d)
            vs = vv[tab.long()].reshape(s, pmax * ps, hkv, d)
            for window in (None, 300):
                outs.append(da.decode_attention_paged(
                    qq, kk, vv, tab, lens, scale=sc, window=window,
                    pages_per_tile=2))
                outs.append(da.decode_attention(
                    qq, ks.transpose(1, 2), vs.transpose(1, 2), lens,
                    scale=sc, window=window, block_t=128))
        for ksc, vsc in scales.values():
            for dt in (torch.bfloat16, torch.float32):
                outs.append(da.decode_attention_paged(
                    q.to(dt), k8, v8, tab, lens, ksc, vsc, scale=sc,
                    pages_per_tile=2))
    finally:
        if chooser is not None:
            da.kernel_body = chooser
    for t in outs:
        h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()


def xent_phase(torch, held, softmax_tol, rows) -> None:
    """Cross-entropy kernels against their plain versions at the LM head's
    shape, float32 and bfloat16: the loss at rtol 1e-5 (sum order), n_sum
    bit-equal (a max), dlogits at the softmax limits."""
    import torch.nn.functional as F

    from repro_torch.kernels import twopass_xent as xe

    rng = np.random.default_rng(7)
    t, v = LM_HEAD
    x32 = torch.from_numpy(rng.standard_normal((t, v), dtype="float32")
                           * 4).to("cuda")
    lab = torch.from_numpy(rng.integers(0, v, t)).to("cuda")
    dl = torch.from_numpy(rng.standard_normal(t, dtype="float32")).to("cuda")
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        loss, m, n = xe.xent_fwd_2d(x, lab)
        torch.cuda.synchronize()
        pl, pm, pn = xe.xent_fwd_2d_plain(x, lab)
        check(torch.equal(n, pn), f"xent_fwd_2d {dt}: n_sum not bit-equal")
        r_m = held(m, pm, dict(atol=0.0, rtol=1e-5), f"xent_fwd_2d {dt} m")
        r_l = held(loss, pl, dict(atol=0.0, rtol=1e-5),
                   f"xent_fwd_2d {dt} loss")
        say("kernel_check", kernel="xent_fwd_2d", shape=[t, v],
            dtype=str(dt), loss=r_l, m_sum=r_m, n_equal=True)
        dx = xe.xent_bwd_2d(x, lab, m, n, dl)
        torch.cuda.synchronize()
        check(dx.dtype == dt, "xent_bwd_2d: output dtype")
        r_d = held(dx, xe.xent_bwd_2d_plain(x, lab, m, n, dl),
                   softmax_tol[dt], f"xent_bwd_2d {dt}")
        say("kernel_check", kernel="xent_bwd_2d", shape=[t, v],
            dtype=str(dt), **r_d)
        case = "lm_head_f32" if dt == torch.float32 else "lm_head_bf16"
        nb = t * v * x.element_size()
        xr = x.detach().clone().requires_grad_(True)
        lib_fwd = cuda_ms(torch, lambda: F.cross_entropy(
            x, lab, reduction="none"))
        # F.cross_entropy's backward, timed as its forward + backward less
        # its forward (as the flash backward's library time)
        dlr = dl.to(dt)
        lib_both = cuda_ms(torch, lambda: torch.autograd.grad(
            F.cross_entropy(xr, lab, reduction="none"), xr, dlr))
        rows.setdefault("xent_fwd_2d", {})[case] = dict(
            ms=cuda_ms(torch, lambda: xe.xent_fwd_2d(x, lab)),
            plain_ms=cuda_ms(torch, lambda: xe.xent_fwd_2d_plain(x, lab), 5),
            library_ms=lib_fwd,
            **dict(zip(("bound_ms", "bound_by"),
                       bound(nb + 4 * t + 12 * t, STATS_OPS * t * v))),
            max_abs_err=r_l["max_abs_err"], shape=[t, v])
        rows.setdefault("xent_bwd_2d", {})[case] = dict(
            ms=cuda_ms(torch, lambda: xe.xent_bwd_2d(x, lab, m, n, dl)),
            plain_ms=cuda_ms(torch, lambda: xe.xent_bwd_2d_plain(
                x, lab, m, n, dl), 5),
            library_ms=lib_both - lib_fwd,
            **dict(zip(("bound_ms", "bound_by"),
                       bound(2 * nb + 16 * t, XENT_BWD_OPS * t * v))),
            max_abs_err=r_d["max_abs_err"], shape=[t, v])
        del x, xr, loss, m, n, pl, pm, pn, dx


# ---------------------------------------------------------------------------
# The fused LM-head CE kernels (9-11) against their plain versions.
# ---------------------------------------------------------------------------
LMHEAD_TRAIN = (512, 5120, 152064)   # one loss chunk of the train phase
LMHEAD_RAGGED = (77, 1000, 50257)
LMHEAD_BLOCK_V = 8192                # the registry's vocab slab at full width
LMHEAD = ("lmhead_xent_fwd_2d", "lmhead_xent_dh_2d", "lmhead_xent_dw_2d")
ROUND_LAMBDA = 8.0


def lmhead_limits(torch, h, w, lab, dl, m_sum, n_sum, loss):
    """Per-element limits for kernel vs plain, from float32 accumulation.

    Both sides form the same products (bf16 x bf16 is exact in float32;
    float32 inputs take FFMA on both) and sum them in other orders.  A
    float32 sum of K terms in any order is within lambda sqrt(K) 2^-24
    sum|terms| of the exact sum, except with probability 2 exp(-lambda^2
    / 2) per element (Higham and Mary's probabilistic bound; lambda = 8,
    5e-14): twice that between the two sides.  So a logit is within
    ex_t = 2 lambda sqrt(D) u max_v (|h| @ |w|)_tv of its twin, the (m, n)
    fold of V terms moves lse by es = 2 lambda sqrt(V) u, and the loss by
    2 ex_t + es (lse and the label logit).  dlogits then move by at most
    c_t p_tv, c_t = |dl_t| (2 ex_t + es), which the products carry into
    dh as c (p @ |w|^T) and into dw as |h|^T @ (c p); their own sums over
    V and T add 2 lambda sqrt(K) u (|dlog| @ |w|^T) and (|h|^T @ |dlog|).
    The final roundings add 4 u |value|."""
    from repro_torch.kernels import twopass_xent as xe

    u = 2.0 ** -24
    t, d = h.shape
    v = w.shape[1]
    ha, wa = h.float().abs(), w.float().abs()
    ex = 2 * ROUND_LAMBDA * d ** 0.5 * u * (ha @ wa).amax(dim=1)
    es = 2 * ROUND_LAMBDA * v ** 0.5 * u
    dl1 = torch.ones_like(dl)
    dlog1 = torch.cat([x for _, _, x in xe._lmhead_dlogits_plain(
        h, w, lab, m_sum, n_sum, dl1, 16)], dim=1)      # p - onehot
    hot = (torch.arange(v, device=h.device)[None, :]
           == lab.long()[:, None])
    p = dlog1 + hot.float()
    adlog = dlog1.abs() * dl.abs()[:, None]
    del dlog1, hot
    c = (dl.abs() * (2 * ex + es))[:, None]
    lse = torch.log(m_sum[:, 0]) + n_sum[:, 0] * xe.LN2
    lim = dict(
        loss=2 * ex + es + 4 * u * loss.abs(),
        lse=ex + es + 4 * u * lse.abs(),
        dh=(2 * ROUND_LAMBDA * v ** 0.5 * u * (adlog @ wa.T)
            + c * (p @ wa.T)),
        dw=(2 * ROUND_LAMBDA * t ** 0.5 * u * (ha.T @ adlog)
            + ha.T @ (c * p)))
    return {k: x.clamp(min=1e-30) for k, x in lim.items()}


def lmhead_backward_launches(torch, h, w, lab, block_v) -> dict[str, int]:
    """Launches of each LM-head kernel in one backward of the CE op through
    the kernels, from the profiler (the forward runs before it).  A session
    that comes back with no kernel record (seen in some profiler sessions
    on an H100) is taken again, up to 5 times."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    hg, wg = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    loss = ops.lmhead_cross_entropy(hg, wg, lab, block_v=block_v,
                                    impl="cuda").sum()
    out: dict[str, int] = {}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loss.backward(retain_graph=True)
            torch.cuda.synchronize()
        out = {e.key: e.count for e in prof.key_averages()
               if "lmhead" in e.key}
        if out:
            break
    return out


def lmhead_phase(torch, rows) -> None:
    """Kernels 9-11 against their plain versions at one loss chunk of the
    train phase (bf16) and at a ragged shape (float32 and bf16), each
    within the accumulation limits of :func:`lmhead_limits`; the same bits
    on a second run; the fused backward (each slab's dlogits once for dh
    and dw) equal to the two entry points; dh and dw at the train chunk
    equal to ``LMHEAD_DIGEST``; the op's backward launching one dlogits
    kernel a slab; times at the train shape, cuBLAS's for the same
    products beside them."""
    from repro_torch.kernels import twopass_xent as xe

    digest = lmhead_digest(torch, xe)
    check(digest == LMHEAD_DIGEST,
          f"lmhead dh / dw bits changed: {digest} != {LMHEAD_DIGEST}")
    say("kernel_check", kernel="lmhead_xent_dh_2d + lmhead_xent_dw_2d",
        case="train_chunk_bf16 bits as pinned (plain forward's stats)",
        sha256=digest, equal=True)
    torch.cuda.empty_cache()
    fwd = lmhead_fwd_digest(torch, xe)
    check(fwd == LMHEAD_FWD_DIGEST,
          f"lmhead forward bits changed: {fwd} != {LMHEAD_FWD_DIGEST}")
    say("kernel_check", kernel="lmhead_xent_fwd_2d",
        case="train_chunk_bf16 bits as pinned", sha256=fwd, equal=True)
    torch.cuda.empty_cache()
    for case, shape, dt in (
            ("train_chunk_bf16", LMHEAD_TRAIN, torch.bfloat16),
            ("ragged_f32", LMHEAD_RAGGED, torch.float32),
            ("ragged_bf16", LMHEAD_RAGGED, torch.bfloat16)):
        c = lmhead_check(torch, case, shape, dt)
        if case == "train_chunk_bf16":
            lmhead_times(torch, rows, case, c)
            h, w, lab, args, bv = (c[x] for x in ("h", "w", "lab", "args",
                                                  "bv"))
            t, d, v = shape
            mm = 2 * t * d * v
            say("kernel_time", kernel="lmhead_xent_bwd_2d",
                case="train_chunk_bf16 (dh and dw, one dlogits pass a slab)",
                ms=cuda_ms(torch, lambda: xe.lmhead_xent_bwd_2d(
                    *args, block_v=bv)),
                bound_ms=bound(t * d * 2 + d * v * 2 + 16 * t + t * d * 4
                               + d * v * 4, XENT_BWD_OPS * t * v, 3 * mm)[0],
                split_bound_ms=bound(0, 0, 7 * mm)[0], shape=[t, d, v])
            dlog = torch.randn(t, bv, device="cuda").to(dt)
            ws = w[:, :bv].contiguous()
            for what, fn, ops in (
                    ("torch.matmul(h, w), the logits of one chunk",
                     lambda: torch.matmul(h, w), mm),
                    ("torch.matmul(dlog_slab, w_slab.T), dh's product of "
                     "one slab", lambda: torch.matmul(dlog, ws.T),
                     2 * t * d * bv),
                    ("torch.matmul(h.T, dlog_slab), dw's product of one "
                     "slab", lambda: torch.matmul(h.T, dlog),
                     2 * t * d * bv)):
                ms = cuda_ms(torch, fn)
                say("context", what=what + ", bf16", shape=[t, d, v],
                    block_v=bv, ms=ms, bound_ms=bound(0, 0, ops)[0],
                    tflops=ops / ms / 1e9)
            del dlog, ws
            launched = lmhead_backward_launches(torch, h, w, lab, bv)

            def count(name):
                return sum(c for k, c in launched.items() if name in k)
            slabs = -(-v // bv)
            check(count("lmhead_dlogits") == slabs,
                  f"the op's backward launched {count('lmhead_dlogits')} "
                  f"dlogits kernels for {slabs} slabs: {launched}")
            say("kernel_check", kernel="lmhead_cross_entropy backward",
                case="one dlogits kernel a slab", slabs=slabs,
                dlogits_launches=count("lmhead_dlogits"),
                dh_slab_launches=count("lmhead_dh_slab"),
                dw_slab_launches=count("lmhead_dw_slab"))
            del h, w, lab, args
        del c
        torch.cuda.empty_cache()


def lmhead_check(torch, case, shape, dt, bv: int = LMHEAD_BLOCK_V) -> dict:
    """Kernels 9-11 at ``shape`` = (T, D, V) against their plain versions
    within the accumulation limits of :func:`lmhead_limits`; the same bits
    on a second run; the fused backward equal to the two entry points.
    Prints its ``kernel_check`` lines; returns the inputs and the errors
    for a timing."""
    from repro_torch.kernels import twopass_xent as xe

    def worst(got, want, lim):
        d = (got.float() - want.float()).abs()
        return float(d.max()), float((d / lim).max())

    t, d, v = shape
    h, w, lab, dl = lmhead_inputs(torch, shape, dt)
    nch = xe.lmhead_v_chunks(v, bv)
    loss, m, n = xe.lmhead_xent_fwd_2d(h, w, lab, block_v=bv)
    torch.cuda.synchronize()
    pl, pm, pn = xe.lmhead_xent_fwd_2d_plain(h, w, lab, nch)
    args = (h, w, lab, pm, pn, dl)
    lim = lmhead_limits(torch, h, w, lab, dl, pm, pn, pl)
    res = {}
    res["loss"] = worst(loss, pl, lim["loss"])
    res["lse"] = worst(torch.log(m) + n * xe.LN2,
                       torch.log(pm) + pn * xe.LN2, lim["lse"][:, None])
    dh = xe.lmhead_xent_dh_2d(*args, block_v=bv)
    torch.cuda.synchronize()
    pdh, pdw = xe.lmhead_xent_bwd_2d_plain(*args, nch)
    res["dh"] = worst(dh, pdh, lim["dh"])
    del pdh
    dw = xe.lmhead_xent_dw_2d(*args, block_v=bv)
    torch.cuda.synchronize()
    res["dw"] = worst(dw, pdw, lim["dw"])
    del lim, pdw
    same = (torch.equal(xe.lmhead_xent_fwd_2d(h, w, lab, block_v=bv)[0],
                        loss)
            and torch.equal(xe.lmhead_xent_dh_2d(*args, block_v=bv), dh)
            and torch.equal(xe.lmhead_xent_dw_2d(*args, block_v=bv), dw))
    fdh, fdw = xe.lmhead_xent_bwd_2d(*args, block_v=bv)
    fused = torch.equal(fdh, dh) and torch.equal(fdw, dw)
    del dh, dw, fdh, fdw, loss, m, n, pl
    for what, (a, over) in res.items():
        check(over <= 1.0, f"lmhead {case} {what}: max abs err {a} is "
              f"{over} of its limit")
    check(same, f"lmhead {case}: bits differ between two runs")
    check(fused, f"lmhead {case}: lmhead_xent_bwd_2d differs from the "
          "separate dh and dw")
    # bf16 rows of w that are not 16-byte aligned take the cp.async loads
    aligned = (v * w.element_size()) % 16 == 0
    for k, what in zip(LMHEAD, (("loss", "lse"), ("dh",), ("dw",))):
        say("kernel_check", kernel=k, case=case, shape=[t, d, v],
            dtype=str(dt), block_v=bv, same_bits_twice=True,
            fused_backward_equal=fused, w_rows_16_byte_aligned=aligned,
            **{f"{x}_max_abs_err": res[x][0] for x in what},
            **{f"{x}_worst_err_over_limit": res[x][1] for x in what},
            tol="float32 accumulation limits (lmhead_limits: "
                "lambda 8 sqrt(K) 2^-24 sum|terms|, K = D for the "
                "logits, V for dh, T for dw)")
    return dict(h=h, w=w, lab=lab, dl=dl, args=args, nch=nch, bv=bv,
                res=res, shape=[t, d, v])


def lmhead_times(torch, rows, case, c) -> None:
    """Times of kernels 9-11 on :func:`lmhead_check`'s case ``c`` into
    ``rows[kernel][case]``, beside their bound, the plain versions and
    ``h @ w`` alone (no one PyTorch call fuses the product with the CE:
    ``library_ms`` is null).  The bound counts the function's own products
    (the logits; dh and dw also the dlogits product) on the bf16 tensor
    cores; the kernels run the dlogits product as three bf16 products of
    the split float32 dlogits (``split_bound_ms``)."""
    from repro_torch.kernels import twopass_xent as xe

    h, w, lab, args, nch, bv, res = (c[x] for x in (
        "h", "w", "lab", "args", "nch", "bv", "res"))
    t, d, v = c["shape"]
    es = h.element_size()
    ins = t * d * es + d * v * es + 16 * t
    mm = 2 * t * d * v
    matmul_ms = cuda_ms(torch, lambda: torch.matmul(h, w))
    rows.setdefault("lmhead_xent_fwd_2d", {})[case] = dict(
        ms=cuda_ms(torch, lambda: xe.lmhead_xent_fwd_2d(h, w, lab,
                                                        block_v=bv)),
        plain_ms=cuda_ms(torch, lambda: xe.lmhead_xent_fwd_2d_plain(
            h, w, lab, nch), 5),
        library_ms=None, matmul_ms=matmul_ms,
        **dict(zip(("bound_ms", "bound_by"),
                   bound(ins + 12 * t, STATS_OPS * t * v, mm))),
        max_abs_err=res["loss"][0], shape=[t, d, v])
    for k, which, out in (("lmhead_xent_dh_2d", "dh", t * d * 4),
                          ("lmhead_xent_dw_2d", "dw", d * v * 4)):
        fn = getattr(xe, k)
        plain = getattr(xe, k + "_plain")
        rows.setdefault(k, {})[case] = dict(
            ms=cuda_ms(torch, lambda: fn(*args, block_v=bv)),
            plain_ms=cuda_ms(torch, lambda: plain(*args, nch), 5),
            library_ms=None, matmul_ms=matmul_ms,
            **dict(zip(("bound_ms", "bound_by"), bound(
                ins + out, XENT_BWD_OPS * t * v, 2 * mm))),
            split_bound_ms=bound(ins + out, XENT_BWD_OPS * t * v,
                                 4 * mm)[0],
            max_abs_err=res[which][0], shape=[t, d, v])
    for k in LMHEAD:
        r = rows[k][case]
        say("kernel_time", kernel=k, case=case,
            bound_us=r["bound_ms"] * 1e3, **r)


# ---------------------------------------------------------------------------
# The flash-attention kernels (12-13) against their plain versions.
# ---------------------------------------------------------------------------
# (B, H, Hkv, Sq, Skv, D, causal, window, dtype): the train phase's shape
# (qwen2.5-14b, 1 x 4096), a ragged causal call with Sq > Skv (rows that
# see no key) in float32, a window, the dense family's head dims 120
# (h2o-danube-3-4b) and 160 (stablelm-12b, also at its train shape, 32
# heads over 8, 1 x 4096; timed), and 256 (the split forward and the
# single set of parts planes of the mma dk/dv kernel, a ragged edge)
FLASH_TRAIN = (1, 40, 8, 4096, 4096, 128, True, None, "bfloat16")
FLASH_CASES = {"train_bf16": FLASH_TRAIN,
               "ragged_empty_rows_f32": (1, 8, 2, 700, 300, 128, True, None,
                                         "float32"),
               "window_bf16": (1, 8, 2, 2048, 2048, 128, True, 300,
                               "bfloat16"),
               "d120_bf16": (1, 4, 1, 500, 500, 120, True, None, "bfloat16"),
               "d160_f32": (1, 4, 2, 333, 333, 160, False, None, "float32"),
               "d160_bf16": (1, 4, 2, 333, 333, 160, True, None,
                             "bfloat16"),
               "d256_bf16": (1, 4, 2, 333, 333, 256, True, None,
                             "bfloat16"),
               "stablelm_train_d160": (1, 32, 8, 4096, 4096, 160, True,
                                       None, "bfloat16"),
               # past 256 the wmma kernels walk the head dim in chunks
               "d320_bf16": (1, 4, 2, 333, 333, 320, True, None,
                             "bfloat16"),
               "d320_f32": (1, 4, 2, 333, 333, 320, True, None, "float32"),
               "d384_dv272_bf16": (1, 4, 2, 333, 333, 384, True, None,
                                   "bfloat16", 272),
               "d384_dv272_f32": (1, 4, 2, 333, 333, 384, True, None,
                                  "float32", 272)}
FLASH_TIMED = ("train_bf16", "stablelm_train_d160", "d320_bf16", "d320_f32",
               "d384_dv272_bf16", "d384_dv272_f32")  # with dq, dk/dv apart
FLASH = ("flash_attention_fwd_gqa", "flash_attention_bwd_gqa")
FLASH_EXTEXP_OPS = 25      # ExtExp, the max, rescale and sum per score
FLASH_BWD_EW_OPS = 33      # ExtExp, p and ds per score


def flash_visible(torch, sq, skv, causal, window) -> int:
    """Scores the mask keeps (the work these inputs need)."""
    qpos = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
    kpos = torch.arange(skv, device="cuda")[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device="cuda")
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return int(keep.sum())


def flash_limits(torch, q, k, v, do, o, m_sum, n_sum, causal, window, scale):
    """Per-element limits for kernel vs plain, from float32 accumulation.

    Both sides form the same products (bf16 x bf16 is exact in float32; w,
    p and ds enter the kernels' tensor-core products as exact bf16 parts;
    float32 inputs take FFMA on both sides) and sum them in other orders:
    a float32 sum of K terms is within lambda sqrt(K) u sum|terms| of the
    exact sum except with probability 2 exp(-lambda^2 / 2) (Higham and
    Mary; lambda 8, u = 2^-24), twice that between the sides.  So a score
    moves by es = 2 lambda sqrt(D) u scale (|q| @ |k|^T), dp by
    edp = 2 lambda sqrt(D) u (|do| @ |v|^T); p (and the forward's weights)
    relatively by es + 8 u; ds by scale (dp_p |dp - delta| + p edp).  These
    carry through the products into o (and lse), dq, dk and dv, each of
    whose own sums over K keys or rows adds 2 lambda sqrt(K) u times the
    sum of its |terms|.  Final roundings add 4 u |value|, and a bf16 output
    one bf16 step, 2^-7 |value|.  The probabilities are materialised here a
    chunk of 512 rows at a time from the plain version's stats.  v, o and
    do may carry a head dim Dv of their own: dp's sums run over Dv."""
    from repro_torch.kernels import twopass_xent as xe

    u, lam = 2.0 ** -24, ROUND_LAMBDA
    b, h, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    c_d = 2 * lam * d ** 0.5 * u
    c_dv = 2 * lam * dv ** 0.5 * u
    f = [t.float() for t in (q, k, v, do, o)]
    qf, kf, vf, dof, of = f
    qg = qf.reshape(b, hkv, g, sq, d)
    dog = dof.reshape(b, hkv, g, sq, dv)
    og = of.reshape(b, hkv, g, sq, dv)
    lse = (torch.log(m_sum) + n_sum * xe.LN2).reshape(b, hkv, g, sq, 1)
    delta = (dof * of).sum(-1, keepdim=True).reshape(b, hkv, g, sq, 1)
    ka, va = kf.abs(), vf.abs()
    lim = {x: torch.zeros_like(t) for x, t in (
        ("o", og), ("dq", qg), ("dk", kf), ("dv", vf))}
    lim["lse"] = torch.zeros_like(lse)
    c_k = 2 * lam * skv ** 0.5 * u              # sums over keys
    c_q = 2 * lam * (g * sq) ** 0.5 * u          # sums over a group's rows
    kpos = torch.arange(skv, device="cuda")[None, :]
    for lo in range(0, sq, 512):
        hi = min(sq, lo + 512)
        qc, qa = qg[..., lo:hi, :], qg[..., lo:hi, :].abs()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kf) * scale
        qpos = torch.arange(lo, hi, device="cuda")[:, None] + (skv - sq)
        keep = torch.ones((hi - lo, skv), dtype=torch.bool, device="cuda")
        if causal:
            keep &= kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        p = torch.where(keep, torch.exp(s - lse[..., lo:hi, :]), 0.0)
        del s
        es = c_d * scale * torch.einsum("bhgqd,bhkd->bhgqk", qa, ka)
        dpe = (es + 8 * u) * p                   # |dp_| of p
        # forward: o = sum p v, lse
        lim["o"][..., lo:hi, :] = (
            torch.einsum("bhgqk,bhkd->bhgqd", dpe, va)
            + og[..., lo:hi, :].abs() * dpe.sum(-1, keepdim=True)
            + c_k * (torch.einsum("bhgqk,bhkd->bhgqd", p, va)
                     + og[..., lo:hi, :].abs())
            + 4 * u * og[..., lo:hi, :].abs())
        lim["lse"][..., lo:hi, :] = ((p * es).sum(-1, keepdim=True) + c_k
                                     + 4 * u * lse[..., lo:hi, :].abs())
        del es
        doc = dog[..., lo:hi, :]
        dp = torch.einsum("bhgqd,bhkd->bhgqk", doc, vf)
        edp = c_dv * torch.einsum("bhgqd,bhkd->bhgqk", doc.abs(), va)
        resid = (dp - delta[..., lo:hi, :]).abs()
        del dp
        ds_a = scale * p * resid                 # |ds|
        dds = scale * (dpe * resid + p * edp) + 4 * u * ds_a
        del resid, edp
        lim["dq"][..., lo:hi, :] = (
            torch.einsum("bhgqk,bhkd->bhgqd", dds, ka)
            + c_k * torch.einsum("bhgqk,bhkd->bhgqd", ds_a, ka))
        lim["dk"] += (torch.einsum("bhgqk,bhgqd->bhkd", dds, qa)
                      + c_q * torch.einsum("bhgqk,bhgqd->bhkd", ds_a, qa))
        lim["dv"] += (torch.einsum("bhgqk,bhgqd->bhkd", dpe, doc.abs())
                      + c_q * torch.einsum("bhgqk,bhgqd->bhkd", p,
                                           doc.abs()))
        del p, dpe, ds_a, dds
    return {x: t.reshape(-1) for x, t in lim.items()}


def flash_check(torch, case, shape) -> dict:
    """Kernels 12-13 at one ``shape`` (FLASH_CASES' tuple, with v's head
    dim Dv as an optional tenth entry) against their plain versions,
    within the limits of :func:`flash_limits` (plus one bf16 step for a
    bf16 output); exact zeros on rows that see no key; the same bits on a
    second run; at a case of :data:`FLASH_MMA_DIGEST`, the pinned bits.
    Prints its ``kernel_check`` lines (``design``: the kernels the call
    took, ``mma`` or ``wmma``) and returns the inputs, the plain forward's
    residuals and the errors for a timing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import twopass_xent as xe

    b, h, hkv, sq, skv, d, causal, window, dts, *rest = shape
    dv = rest[0] if rest else d
    dt = getattr(torch, dts)
    gen = torch.Generator(device="cuda").manual_seed(sq + d)
    q, do = (torch.randn(b, h, sq, e, device="cuda", generator=gen).to(dt)
             for e in (d, dv))
    k, v = (torch.randn(b, hkv, skv, e, device="cuda", generator=gen)
            .to(dt) for e in (d, dv))
    scale = d ** -0.5
    kw = dict(causal=causal, scale=scale, window=window)
    nq, nkv = fa.chunk_counts(sq, skv, 64, 64)
    pkw = dict(kw, n_q_chunks=nq, n_kv_chunks=nkv)
    o, m, n = fa.flash_attention_fwd_gqa(q, k, v, **kw)
    torch.cuda.synchronize()
    po, pm, pn = fa.flash_attention_fwd_gqa_plain(q, k, v, **pkw)
    # the backward of both sides from the plain forward's residuals
    args = (q, k, v, po, pm, pn, do)
    grads = fa.flash_attention_bwd_gqa(*args, **kw)
    torch.cuda.synchronize()
    pgrads = fa.flash_attention_bwd_gqa_plain(*args, **pkw)
    lim = flash_limits(torch, q, k, v, do, po, pm, pn, causal, window,
                       scale)
    live = pm.reshape(-1) > 0
    res = {}

    def held(name, got, want):
        got, want = got.float().reshape(-1), want.float().reshape(-1)
        li = lim[name] + (2.0 ** -7 * want.abs()
                          if dt == torch.bfloat16 and name != "lse"
                          else 0.0)
        err = (got - want).abs()
        res[name] = (float(err.max()),
                     float((err / li.clamp(min=1e-30)).max()))

    check(o.shape == po.shape == (b, h, sq, dv),
          f"flash {case} o: {tuple(o.shape)}")
    held("o", o, po)
    lse = (torch.log(m) + n * xe.LN2).reshape(-1)
    plse = (torch.log(pm) + pn * xe.LN2).reshape(-1)
    err = (lse[live] - plse[live]).abs()
    res["lse"] = (float(err.max()),
                  float((err / lim["lse"][live]).max()))
    for name, a, w in zip(("dq", "dk", "dv"), grads, pgrads):
        check(a.dtype == dt and a.shape == w.shape, f"flash {case} "
              f"{name}: {a.dtype} {tuple(a.shape)}")
        held(name, a, w)
    empty = 0
    if causal and sq > skv:
        empty = sq - skv
        check(not o[:, :, :empty].any() and not m[:, :, :empty].any()
              and not grads[0][:, :, :empty].any(),
              f"flash {case}: rows that see no key are not exact zeros")
    check(torch.equal(n.reshape(-1)[~live], pn.reshape(-1)[~live])
          and torch.equal(m.reshape(-1)[~live], pm.reshape(-1)[~live]),
          f"flash {case}: the stats of empty rows differ")
    same = (all(torch.equal(x, y) for x, y in zip(
        fa.flash_attention_fwd_gqa(q, k, v, **kw), (o, m, n)))
        and all(torch.equal(x, y) for x, y in zip(
            fa.flash_attention_bwd_gqa(*args, **kw), grads)))
    pin = {}
    if case in FLASH_MMA_DIGEST:
        digest = hashlib.sha256()
        for t in (o, m, n, *fa.flash_attention_bwd_gqa(q, k, v, o, m, n, do,
                                                       **kw)):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        pin = dict(sha256=digest.hexdigest(),
                   sha256_pinned=FLASH_MMA_DIGEST[case])
        check(pin["sha256"] == pin["sha256_pinned"],
              f"flash {case}: the mma kernels' bits moved: {pin}")
    design = fa.design(dt, d, dv)
    del lim, o, m, n, grads, pgrads
    for what, (a, over) in res.items():
        check(over <= 1.0, f"flash {case} {what}: max abs err {a} is "
              f"{over} of its limit")
    check(same, f"flash {case}: bits differ between two runs")
    for kname, what in zip(FLASH, (("o", "lse"), ("dq", "dk", "dv"))):
        say("kernel_check", kernel=kname, case=case,
            shape=dict(b=b, h=h, hkv=hkv, sq=sq, skv=skv, d=d, dv=dv),
            causal=causal, window=window, dtype=dts, design=design, **pin,
            empty_rows_exact_zero=empty, same_bits_twice=True,
            **{f"{x}_max_abs_err": res[x][0] for x in what},
            **{f"{x}_worst_err_over_limit": res[x][1] for x in what},
            tol="float32 accumulation limits (flash_limits: lambda 8 "
                "sqrt(K) 2^-24 sum|terms| carried through the scores, "
                "p, ds and the products) plus one bf16 step "
                "(2^-7 |value|) for a bf16 output; lse through "
                "ln m_sum + n_sum ln 2 on rows that see a key")
    return dict(q=q, k=k, v=v, do=do, kw=kw, pkw=pkw, args=args, res=res,
                shape=dict(b=b, h=h, hkv=hkv, s=sq, skv=skv, d=d, dv=dv,
                           causal=causal))


def flash_times(torch, rows, case, c, *, dq_dkv: bool = False) -> None:
    """Times of kernels 12-13 on :func:`flash_check`'s case ``c`` into
    ``rows[kernel][case]``: the forward and the backward beside their
    bound, the plain versions and ``scaled_dot_product_attention`` (its
    backward: forward + backward - forward); with ``dq_dkv`` also the
    backward's dq and dk/dv kernels alone.  The bound counts the visible
    scores' products: 2 forward (q k^T over D, w v over Dv), 5 backward
    (three over D, two over Dv), on the bf16 tensor cores for bf16 inputs
    and FFMA for float32."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q, k, v, do, kw, pkw = (c[x] for x in ("q", "k", "v", "do", "kw",
                                           "pkw"))
    args = c["args"]
    b, h, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    vis = b * h * flash_visible(torch, sq, skv, kw["causal"], kw["window"])
    es = q.element_size()
    rows_q, rows_k = b * h * sq, b * hkv * skv
    bf = q.dtype == torch.bfloat16
    fwd_mm, bwd_mm = 2 * vis * (d + dv), 2 * vis * (3 * d + 2 * dv)

    def ops(ew, mm):                    # (float32 ops, bf16 tensor ops)
        return (ew * vis, mm) if bf else (ew * vis + mm, 0.0)

    fwd_b = bound(es * (rows_q * (d + dv) + rows_k * (d + dv))
                  + 8 * rows_q, *ops(FLASH_EXTEXP_OPS, fwd_mm))
    bwd_b = bound(es * (rows_q * (2 * d + 2 * dv) + rows_k * (2 * d + 2 * dv))
                  + 12 * rows_q, *ops(FLASH_BWD_EW_OPS, bwd_mm))
    qr, kr, vr = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    mask = None
    if kw["window"] is not None:        # the same function: the window's mask
        qpos = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
        kpos = torch.arange(skv, device="cuda")[None, :]
        mask = (kpos > qpos - kw["window"]) & (
            kpos <= qpos if kw["causal"] else True)

    def sdpa():
        return F.scaled_dot_product_attention(
            qr, kr, vr, attn_mask=mask,
            is_causal=kw["causal"] and mask is None, enable_gqa=True)

    lib_fwd = cuda_ms(torch, sdpa)
    lib_both = cuda_ms(torch, lambda: torch.autograd.grad(
        sdpa(), (qr, kr, vr), do))
    extra = {}
    if dq_dkv:
        delta = fa.attention_delta(args[3], do).contiguous()
        outs = [torch.empty_like(t) for t in (q, k, v)]

        def one(which):                # one of the two kernels alone
            return cuda_ms(torch, lambda: fa.bwd_kernel(
                which, q, k, v, do, args[4], args[5], delta, *outs, **kw))

        extra = dict(dq_ms=one(0), dkv_ms=one(1))
    res = c["res"]
    rows.setdefault("flash_attention_fwd_gqa", {})[case] = dict(
        ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_gqa(q, k, v, **kw)),
        plain_ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_gqa_plain(
            q, k, v, **pkw), 5),
        library_ms=lib_fwd,
        **dict(zip(("bound_ms", "bound_by"), fwd_b)),
        split_bound_ms=bound(0, 0, 2 * fwd_mm)[0],
        max_abs_err=res["o"][0], shape=c["shape"])
    rows.setdefault("flash_attention_bwd_gqa", {})[case] = dict(
        ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_gqa(*args, **kw)),
        **extra,
        plain_ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_gqa_plain(
            *args, **pkw), 5),
        library_ms=lib_both - lib_fwd,
        **dict(zip(("bound_ms", "bound_by"), bwd_b)),
        split_bound_ms=bound(0, 0, 13 * vis * (d + dv))[0],
        max_abs_err=max(res[x][0] for x in ("dq", "dk", "dv")),
        shape=c["shape"])
    for kname in FLASH:
        r = rows[kname][case]
        say("kernel_time", kernel=kname, case=case,
            bound_us=r["bound_ms"] * 1e3,
            split_products_note="split_bound_ms: the products the bf16 "
            "kernels run (forward 1 + 3, backward 2 + 3 + 2 + 3 + 3) at "
            "the bf16 peak", **r)


def flash_phase(torch, rows) -> None:
    """Kernels 12-13 against their plain versions at the train phase's
    shape and seven other cases (:func:`flash_check`); times at the train
    shapes of qwen2.5-14b and stablelm-12b (:func:`flash_times`, with the
    backward's dq and dk/dv kernels alone: ``dq_ms``, ``dkv_ms``)."""
    for case, shape in FLASH_CASES.items():
        c = flash_check(torch, case, shape)
        if case in FLASH_TIMED:
            flash_times(torch, rows, case, c, dq_dkv=True)
        del c
        torch.cuda.empty_cache()


def paper_comparison(torch, rows) -> None:
    """The paper's comparison: the three softmax kernels side by side in
    one call, each beside the 2N floor (read once, write once) and its own
    traffic in the paper's count (3N, 4N, 5N).  The serving shapes take the
    kernel phase's times; only rows whose re-reads miss the 50 MB L2 --
    [512, 524288]: 2 MiB rows, over a hundred in flight -- can show that
    traffic, and they are timed here, by graph replay with eager beside,
    and ``torch.softmax`` with them."""
    from repro_torch.kernels import threepass_softmax as tp3
    from repro_torch.kernels import twopass_softmax as tp

    algos = (("two_pass", "twopass_softmax_2d", tp.twopass_softmax_2d, 3),
             ("three_pass_recompute", "threepass_recompute_2d",
              tp3.threepass_recompute_2d, 4),
             ("three_pass_reload", "threepass_reload_2d",
              tp3.threepass_reload_2d, 5))
    r, c = 512, 524288
    x = score_rows(torch, np.random.default_rng(11), "beyond_l2", r, c)
    times = {kname: dict(ms=graph_ms(torch, lambda: fn(x)),
                         eager_ms=cuda_ms(torch, lambda: fn(x)))
             for _, kname, fn, _ in algos}
    times["library"] = dict(ms=graph_ms(torch, lambda: torch.softmax(x, -1)),
                            eager_ms=cuda_ms(torch,
                                             lambda: torch.softmax(x, -1)))
    del x
    for case in ("prefill_bucket_1024", "sampler", "beyond_l2"):
        for algo, kname, _, passes in algos:
            t = times[kname] if case == "beyond_l2" else rows[kname][case]
            shape = [r, c] if case == "beyond_l2" else t["shape"]
            nb = shape[0] * shape[1] * 4
            say("paper_comparison", case=case, shape=shape, algorithm=algo,
                path=tp.path_for(shape[1]),
                ms=t["ms"], eager_ms=t["eager_ms"],
                floor_2n_ms=2 * nb / HBM_BYTES_S * 1e3,
                paper_traffic=f"{passes}N",
                paper_ms=passes * nb / HBM_BYTES_S * 1e3)
    say("paper_comparison", case="beyond_l2", shape=[r, c],
        algorithm="torch.softmax", **times["library"])


def kernel_phase(torch, rng):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import threepass_softmax as tp3
    from repro_torch.kernels import twopass_softmax as tp

    dev = "cuda"
    rows = {}

    # -- softmax under the paper's three algorithms, and the stats: prefill
    # scores and the sampler.  Two-pass: the same ExtExp bits, only the
    # order of the (m, n) sum differs.  Three-pass: the same Alg-4 bits,
    # only the order of sigma's sum differs; in bfloat16 two float32
    # results that close round at most one bfloat16 step apart.
    softmax_tol = {torch.float32: dict(atol=5e-6, rtol=1e-5),
                   torch.bfloat16: dict(atol=1e-37, rtol=2.0 ** -7)}
    three = {"threepass_recompute_2d": (tp3.threepass_recompute_2d,
                                        tp3.threepass_recompute_2d_plain,
                                        RECOMPUTE_OPS),
             "threepass_reload_2d": (tp3.threepass_reload_2d,
                                     tp3.threepass_reload_2d_plain,
                                     RELOAD_OPS)}
    for name, r, c in SOFTMAX_SHAPES:
        x = score_rows(torch, rng, name, r, c)
        y = tp.twopass_softmax_2d(x)
        torch.cuda.synchronize()
        a, rel = err(y, tp.twopass_softmax_2d_plain(x))
        ok = torch.allclose(y, tp.twopass_softmax_2d_plain(x), atol=5e-6,
                            rtol=1e-5)
        check(ok, f"twopass_softmax_2d {name}: max abs err {a}")
        m, n = tp.twopass_stats_2d(x)
        mp, np_ = tp.twopass_stats_2d_plain(x)
        sa, _ = err(m, mp)
        check(torch.equal(n, np_) and torch.allclose(m, mp, rtol=1e-5,
                                                     atol=0),
              f"twopass_stats_2d {name}: m err {sa}")
        say("kernel_check", kernel="twopass_softmax_2d", shape=[r, c],
            case=name, path=tp.path_for(c), max_abs_err=a, max_rel_err=rel,
            tol="atol 5e-6 rtol 1e-5: the same ExtExp bits, only the "
                "order of the (m, n) sum differs")
        say("kernel_check", kernel="twopass_stats_2d", shape=[r, c],
            case=name, m_max_abs_err=sa, n_equal=True,
            tol="n_sum exact (a max); m_sum rtol 1e-5 (sum order)")
        nb = r * c * 4
        if name in ("prefill_bucket_1024", "sampler"):
            b_ms, b_by = bound(2 * nb, SOFTMAX_OPS * r * c)
            rows.setdefault("twopass_softmax_2d", {})[name] = dict(
                **timed(torch, lambda: tp.twopass_softmax_2d(x),
                        lambda: tp.twopass_softmax_2d_plain(x),
                        lambda: torch.softmax(x, -1)),
                bound_ms=b_ms, bound_by=b_by,
                paper_3n_ms=3 * nb / HBM_BYTES_S * 1e3, max_abs_err=a,
                shape=[r, c], path=tp.path_for(c))
            b_ms, b_by = bound(nb + 8 * r, STATS_OPS * r * c)
            rows.setdefault("twopass_stats_2d", {})[name] = dict(
                **timed(torch, lambda: tp.twopass_stats_2d(x),
                        lambda: tp.twopass_stats_2d_plain(x),
                        lambda: torch.logsumexp(x, -1)),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=sa, shape=[r, c])
        del y, m, n, mp, np_
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            for kname, (fn, plain, ops) in three.items():
                got = fn(xd)
                torch.cuda.synchronize()
                check(got.dtype == dt, f"{kname}: output dtype")
                res = held(got, plain(xd), softmax_tol[dt],
                           f"{kname} {name} {dt}")
                path = tp.path_for(c)
                say("kernel_check", kernel=kname, shape=[r, c], case=name,
                    dtype=str(dt), path=path, **res)
                if dt == torch.float32 and name in ("prefill_bucket_1024",
                                                    "sampler"):
                    rows.setdefault(kname, {})[name] = dict(
                        **timed(torch, lambda: fn(x), lambda: plain(x),
                                lambda: torch.softmax(x, -1)),
                        **dict(zip(("bound_ms", "bound_by"),
                                   bound(2 * nb, ops * r * c))),
                        max_abs_err=res["max_abs_err"], shape=[r, c],
                        path=path)
                del got
            del xd
        del x

    # -inf padding changes no bit, though it changes the warps per row
    # and, past 8192 columns, the layout (registers -> split)
    softmax_fns = (tp.twopass_softmax_2d, tp3.threepass_recompute_2d,
                   tp3.threepass_reload_2d)
    for r, c, c2 in ((40 * 37, 1000, 1664), (40 * 37, 1000, 8193),
                     (40, 8192, 16384), (8, 1000, 152064)):
        x = torch.from_numpy(rng.standard_normal((r, c), dtype="float32")
                             * 8).to(dev)
        xp = torch.full((r, c2), -torch.inf, device=dev)
        xp[:, :c] = x
        for fn in softmax_fns:
            y, yp = fn(x), fn(xp)
            check(torch.equal(y, yp[:, :c]) and not bool(yp[:, c:].any()),
                  f"{fn.__name__} bits change under -inf padding "
                  f"{c} -> {c2}")
        st, stp = tp.twopass_stats_2d(x), tp.twopass_stats_2d(xp)
        check(all(torch.equal(a, b) for a, b in zip(st, stp)),
              f"stats bits change under -inf padding {c} -> {c2}")
        say("kernel_check",
            kernel="+".join(f.__name__ for f in softmax_fns)
            + "+twopass_stats_2d",
            case=f"-inf padding {c} -> {c2} columns",
            paths=[tp.path_for(c), tp.path_for(c2)], bitwise_equal=True)
    del x, xp, y, yp, st, stp

    # all -inf row: NaN, as the reference kernels give (m_sum = 0 for the
    # two-pass kernel, sigma = 0 for the three-pass ones)
    x = torch.full((2, 300), -torch.inf, device=dev)
    x[1, 7] = 1.0
    for fn in softmax_fns:
        y = fn(x)
        check(bool(torch.isnan(y[0]).all())
              and abs(float(y[1, 7]) - 1) < 1e-6, f"{fn.__name__}: all "
              "-inf row")
        say("kernel_check", kernel=fn.__name__, case="all -inf row",
            result="NaN row, as the reference kernel")

    # the two-pass kernels' bits are those of the kernels before the move
    digest = twopass_digest(torch, tp)
    check(digest == TWOPASS_DIGEST,
          f"two-pass bits changed: {digest} != {TWOPASS_DIGEST}")
    say("kernel_check", kernel="twopass_softmax_2d+twopass_stats_2d",
        case="bits as before the fold moved into rowfold.cuh",
        sha256=digest, equal=True)
    digest = reload_digest(torch, tp3)
    check(digest == RELOAD_DIGEST,
          f"reload bits changed: {digest} != {RELOAD_DIGEST}")
    say("kernel_check", kernel="threepass_reload_2d",
        case="bits as the one-block-a-row kernel gave them", sha256=digest,
        equal=True)
    from repro_torch.kernels import twopass_xent as xe
    digest = xent_digest(torch, xe)
    check(digest == XENT_DIGEST,
          f"xent_fwd_2d bits changed: {digest} != {XENT_DIGEST}")
    say("kernel_check", kernel="xent_fwd_2d",
        case="bits as before the max-first lane fold", sha256=digest,
        equal=True)

    xent_phase(torch, held, softmax_tol, rows)

    # -- decode attention at the serving shapes --------------------------
    s, hkv, g, d, ps = N_SLOTS, 8, 5, 128, 128
    pmax = MAX_LEN // ps
    lengths = rng.integers(200, 1500, s) + 16
    lengths[3] = 0                                      # a free slot
    n_pages = 1 + s * pmax
    table = rng.permutation(np.arange(1, n_pages))[:s * pmax]
    table = table.reshape(s, pmax).astype(np.int32)
    table[3] = 0                                        # free: trash row
    table[5, -2:] = table[6, :2]                        # aliased past len
    lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    tab = torch.from_numpy(table).to(dev)
    bf = torch.bfloat16
    q = torch.randn((s, hkv, g, d), device=dev).to(bf)
    kp = torch.randn((n_pages, ps, hkv, d), device=dev).to(bf)
    vp = torch.randn((n_pages, ps, hkv, d), device=dev).to(bf)
    # the same cache as a strip pool [S, T, Hkv, D], read transposed
    ks = kp[tab.long()].reshape(s, pmax * ps, hkv, d)
    vs = vp[tab.long()].reshape(s, pmax * ps, hkv, d)
    sc = d ** -0.5
    kv_bytes = int(lengths.sum()) * hkv * 2 * d * 2
    io_bytes = 2 * q.numel() * 2 + s * pmax * 4 + s * 4
    dec_ops = int(lengths.sum()) * hkv * g * (4 * d + 20)

    def paged(qq=q, kk=kp, vv=vp, k_scale=None, v_scale=None, window=None):
        return da.decode_attention_paged(qq, kk, vv, tab, lens, k_scale,
                                         v_scale, scale=sc, window=window,
                                         pages_per_tile=1)

    def paged_plain(qq=q, kk=kp, vv=vp, k_scale=None, v_scale=None,
                    window=None):
        return da.decode_attention_paged_plain(
            qq, kk, vv, tab, lens, k_scale, v_scale, scale=sc, window=window,
            n_t_chunks=pmax)

    def contig(qq=q, kk=ks, vv=vs, window=None):
        return da.decode_attention(qq, kk.transpose(1, 2), vv.transpose(1, 2),
                                   lens, scale=sc, window=window,
                                   block_t=ps)

    def contig_plain(qq=q, kk=ks, vv=vs, window=None):
        return da.decode_attention_plain(
            qq, kk.transpose(1, 2), vv.transpose(1, 2), lens, scale=sc,
            window=window, n_t_chunks=pmax)

    # Tolerances.  float32 output: the reference decode tests' atol 1e-5
    # (only the order of f32 sums differs).  bfloat16 output: the f32
    # results differ by that much, then each rounds to bfloat16, so they
    # may land one bf16 step (2^-7 of the value) apart: |err| <= 1e-5 +
    # 1e-2 |want|.  A window one key off moves an output by ~1 / N_eff
    # (~3e-3 at a window of 300), ~6x the bf16 limit on values of ~5e-2.
    f32_tol = dict(atol=1e-5, rtol=0.0)
    bf16_tol = dict(atol=1e-5, rtol=1e-2)
    qf, kf, vf = q.float(), kp.float(), vp.float()
    cases = [("bf16", {}, bf16_tol),
             ("window_300_bf16", dict(window=300), bf16_tol),
             ("f32", dict(qq=qf, kk=kf, vv=vf), f32_tol),
             ("window_300_f32", dict(qq=qf, kk=kf, vv=vf, window=300),
              f32_tol)]
    for gran in ("page", "page_head"):
        shp = (n_pages, ps) if gran == "page" else (n_pages, ps, hkv)
        k8 = torch.randint(-127, 128, (n_pages, ps, hkv, d), device=dev,
                           dtype=torch.int8)
        v8 = torch.randint(-127, 128, (n_pages, ps, hkv, d), device=dev,
                           dtype=torch.int8)
        ksc = torch.rand(shp, device=dev) * 0.02
        vsc = torch.rand(shp, device=dev) * 0.02
        kw = dict(kk=k8, vv=v8, k_scale=ksc, v_scale=vsc)
        cases += [(f"int8_{gran}_bf16q", kw, bf16_tol),
                  (f"int8_{gran}_f32q", dict(kw, qq=qf), f32_tol)]

    def body(kw, strip=False):
        """The tile body the wrapper's kernel_body picks for a case."""
        kk, vv = kw.get("kk", kp), kw.get("vv", vp)
        if strip:
            kk, vv = kk.transpose(1, 2), vv.transpose(1, 2)
        return da.kernel_body(kw.get("qq", q).dtype, kk.dtype, d, d,
                              da._row_bytes(kk, vv))

    for name, kw, tol in cases:
        got = paged(**kw)
        torch.cuda.synchronize()
        r = held(got, paged_plain(**kw), tol, f"decode_attention_paged {name}")
        check(bool((got[3] == 0).all()), f"paged {name}: free slot not 0")
        say("kernel_check", kernel="decode_attention_paged", case=name,
            body=body(kw), **r)
    ksf, vsf = ks.float(), vs.float()
    for name, kw, tol in cases[:4]:
        ckw = dict(kw, kk=ksf, vv=vsf) if "kk" in kw else kw
        got = contig(**ckw)
        torch.cuda.synchronize()
        r = held(got, contig_plain(**ckw), tol, f"decode_attention {name}")
        check(torch.equal(got, paged(**kw)),
              f"decode_attention {name}: strip != paged bits")
        say("kernel_check", kernel="decode_attention", case=name,
            body=body(ckw, strip=True), **r, strip_equals_paged_bitwise=True)
    del qf, kf, vf, ksf, vsf

    # the general body (float32, int8, and bf16 when asked) keeps the bits
    # of the kernels before the split-KV grid
    digest = decode_digest(torch, da)
    check(digest == DECODE_DIGEST,
          f"decode bits changed: {digest} != {DECODE_DIGEST}")
    say("kernel_check", kernel="decode_attention_paged+decode_attention",
        case="general body: bits as before the split-KV grid",
        sha256=digest, equal=True)

    a_p, _ = err(paged(), paged_plain())
    a_c, _ = err(contig(), contig_plain())
    mask = (torch.arange(pmax * ps, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    q_l = q.reshape(s, hkv * g, 1, d)
    k_l, v_l = ks.transpose(1, 2), vs.transpose(1, 2)
    b_ms, b_by = bound(kv_bytes + io_bytes, dec_ops)

    def sdpa():
        return F.scaled_dot_product_attention(q_l, k_l, v_l, attn_mask=mask,
                                              enable_gqa=True)

    # ms / library_ms: device time (CUDA-graph replay); eager_ms: a launch
    # timed as every other kernel is, host included
    rows["decode_attention_paged"] = {"main": dict(
        ms=graph_ms(torch, paged), eager_ms=cuda_ms(torch, paged),
        plain_ms=cuda_ms(torch, paged_plain, 5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=a_p,
        shape=dict(q=list(q.shape), pages=list(kp.shape), pmax=pmax,
                   lengths=lengths.tolist()))}
    rows["decode_attention"] = {"main": dict(
        ms=graph_ms(torch, contig), eager_ms=cuda_ms(torch, contig),
        plain_ms=cuda_ms(torch, contig_plain, 5),
        library_ms=graph_ms(torch, sdpa),
        library_eager_ms=cuda_ms(torch, sdpa),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=a_c,
        shape=dict(q=list(q.shape), k=list(k_l.shape),
                   lengths=lengths.tolist()))}
    del q_l, k_l, v_l, mask, ks, vs

    # one slot of 16,384 positions: 128 tiles, the split axis alone
    tl = 16384
    pl = tl // ps
    q1 = torch.randn((1, hkv, g, d), device=dev).to(bf)
    kp1, vp1 = (torch.randn((1 + pl, ps, hkv, d), device=dev).to(bf)
                for _ in "kv")
    tab1 = torch.arange(1, 1 + pl, dtype=torch.int32, device=dev)[None]
    len1 = torch.tensor([tl], dtype=torch.int32, device=dev)
    k1, v1 = (x[tab1.long()].reshape(1, tl, hkv, d).transpose(1, 2)
              for x in (kp1, vp1))
    b1 = bound(tl * hkv * 2 * d * 2 + 2 * q1.numel() * 2 + pl * 4 + 4,
               tl * hkv * g * (4 * d + 20))
    for name, fn, plain in (
            ("decode_attention_paged",
             lambda: da.decode_attention_paged(q1, kp1, vp1, tab1, len1,
                                               scale=sc),
             lambda: da.decode_attention_paged_plain(
                 q1, kp1, vp1, tab1, len1, scale=sc, n_t_chunks=pl)),
            ("decode_attention",
             lambda: da.decode_attention(q1, k1, v1, len1, scale=sc,
                                         block_t=ps),
             lambda: da.decode_attention_plain(q1, k1, v1, len1, scale=sc,
                                               n_t_chunks=pl))):
        got = fn()
        torch.cuda.synchronize()
        r = held(got, plain(), bf16_tol, f"{name} long slot")
        say("kernel_check", kernel=name, case="long_slot_16384",
            body=da.kernel_body(bf, bf, d, d, da._row_bytes(kp1, vp1)), **r)
        rows[name]["long_slot_16384"] = dict(
            ms=graph_ms(torch, fn), eager_ms=cuda_ms(torch, fn),
            plain_ms=cuda_ms(torch, plain, 5),
            library_ms=graph_ms(torch, lambda: F.scaled_dot_product_attention(
                q1.reshape(1, hkv * g, 1, d), k1, v1, enable_gqa=True)),
            bound_ms=b1[0], bound_by=b1[1], max_abs_err=r["max_abs_err"],
            shape=dict(q=list(q1.shape), pages=list(kp1.shape),
                       lengths=[tl]))
    del q1, kp1, vp1, k1, v1
    for name, by_case in rows.items():
        for case, r in by_case.items():
            say("kernel_time", kernel=name, case=case,
                bound_us=r["bound_ms"] * 1e3, **r)
    return rows


# ---------------------------------------------------------------------------
# Phases 3-4: the engine at full width.
# ---------------------------------------------------------------------------
def serve_requests(torch, model, params, reqs, state=None, hook=None,
                   stream=False, **kw):
    """Serve ``reqs`` through ``model.serving_engine(params, **kw)``, with
    the launch counts zeroed just before the run (after the engine, and so
    its graph's warm-up and capture, is built) and read just after.
    Returns (tokens a request, the engine's throughput with the wall time,
    launches, the number of prefill buckets (0: exact lengths), ms a
    decode step, the capture's seconds, graph pool bytes and
    launches a replay when fused, the bytes allocated before the engine
    was built, and the peak bytes allocated and reserved since).  A dict ``state`` gets a
    copy of the pool's cache leaves after the run, by path (a hybrid
    pool's ``"attn/k"``, ``"attn/v"``), and the slots that served a
    request (``"slots"``).  A hybrid pool's ssm state is kept instead as
    each request left its slot (``"ssm"``: (request id, the slot's state)
    at every release, in order): after that the free slot goes on
    stepping dead state whose attention half reads the trash page, which
    every free slot writes at once, in no fixed order.  ``hook(eng)``
    runs before the counts are zeroed; with ``stream`` the requests go
    through ``eng.stream()`` and the throughput gets its deltas joined
    by request (``streamed``) and their number (``deltas``)."""
    import repro_torch.kernels as K

    gc.collect()
    torch.cuda.empty_cache()             # peaks from this run's state alone
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eng = model.serving_engine(params, **kw)
    released = []
    if state is not None and "ssm" in eng.pool["kv"]:
        release, ssm = eng._release_slot, eng.pool["kv"]["ssm"]

        def keep(slot):
            released.append((eng.slot_owner[slot].rid,
                             ssm[:, slot].clone()))
            release(slot)

        eng._release_slot = keep
    if hook is not None:
        hook(eng)
    streamed, deltas = {}, 0
    K.reset_launch_counts()
    t = time.perf_counter()
    if stream:
        for rid, new in eng.stream(reqs):
            streamed.setdefault(rid, []).extend(new)
            deltas += 1
        comps = eng.completions
    else:
        comps = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = K.launch_counts()
    toks = [list(c.tokens) for c in comps]
    out = dict(eng.throughput(), wall_s=wall, launches=counts,
               bucketed=len(eng.buckets or ()), buckets=eng.buckets,
               decode_ms_per_step=(eng.stats["decode_s"]
                                   / max(1, eng.stats["steps"]) * 1e3),
               base_bytes=base,
               peak_bytes=torch.cuda.max_memory_allocated(),
               peak_reserved_bytes=torch.cuda.max_memory_reserved())
    if stream:
        out.update(streamed=[streamed.get(c.rid, []) for c in comps],
                   deltas=deltas)
    out.update(prefill_s=eng.stats["prefill_s"])
    if eng.paged:
        out.update(free_pages=eng.allocator.free_pages)
    if state is not None:
        state.update({k: v.clone() for k, v in _paths(eng.pool["kv"])
                      if k != "ssm"}, slots={c.slot for c in comps})
        if released:
            state["ssm"] = released
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return toks, out


def engine_phase(torch, rng, n_layers: int):
    import repro_torch.kernels as K
    from repro_torch.models import build_model
    from repro_torch.serving import engine
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    from repro_torch.serving.scheduler import Request

    m = build_model(ARCH, n_layers=n_layers, use_kernels=True)
    cfg = m.cfg
    say("engine_config", arch=ARCH, n_layers=cfg.n_layers,
        full_depth=48, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab,
        weights="bfloat16, seeded torch.Generator on the card")
    t0 = time.perf_counter()
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    say("weights", seconds=time.perf_counter() - t0,
        bytes=sum(t.numel() * 2 for t in _leaves(params)))
    plens = rng.integers(200, 1501, N_REQ)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, n))
               for n in plens]

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(prompts)]

    def serve(model, **kw):
        return serve_requests(torch, model, params, reqs(), slots=N_SLOTS,
                              max_len=MAX_LEN, seed=3, **kw)

    # main path: paged pool, kernels on, greedy, the decode step captured
    # in a CUDA graph; each pool again with the eager step (fused=False),
    # the graph's oracle: the same tokens and the same launches
    runs = {}
    for pool, paged, kname in (("paged", True, "decode_attention_paged"),
                               ("strip", False, "decode_attention")):
        for fused in (True, False):
            step = "graph" if fused else "eager"
            toks, st = serve(m, paged=paged, temperature=0.0, fused=fused)
            say("engine", path=f"{pool}, use_kernels=True, temperature=0, "
                f"{step} step", prompt_lens=plens.tolist(), **st)
            check(st["fused"] is fused, f"{pool}: fused is {st['fused']}")
            check(all(len(t) == NEW_TOKENS for t in toks),
                  f"{pool}, {step}: token counts")
            check(st["launches"]["twopass_softmax_2d"] > 0
                  and st["launches"][kname] > 0,
                  f"{pool}, {step}: kernels not launched: {st['launches']}")
            check(st["admitted"] == N_REQ and N_REQ > N_SLOTS, "backfill")
            runs[pool, step] = toks, st
        (tg, sg), (te, se) = runs[pool, "graph"], runs[pool, "eager"]
        per = sg["launches_per_replay"]
        check(tg == te, f"{pool}: graph tokens != eager tokens")
        check(per.get(kname) == cfg.n_layers and sg["replays"] == sg["steps"]
              and sg["launches"] == se["launches"],
              f"{pool}: graph launches {sg['launches']} ({per} a replay, "
              f"{sg['replays']} replays) != eager {se['launches']}")
        say("parity", check=f"{pool}: graph == eager tokens and launches",
            equal=True, launches_per_replay=per, replays=sg["replays"])
    toks_paged, st = runs["paged", "graph"]
    toks_strip, st2 = runs["strip", "graph"]
    check(toks_strip == toks_paged, "strip tokens != paged tokens")
    say("parity", check="strip == paged tokens", equal=True)
    launches = dict(st["launches"])
    launches["decode_attention"] = st2["launches"]["decode_attention"]
    keys = ("decode_ms_per_step", "decode_tok_s", "prefill_tok_s",
            "peak_bytes", "peak_reserved_bytes", "steps")
    say("engine_fused", n_layers=cfg.n_layers, **{
        pool: dict(graph={k: runs[pool, "graph"][1][k] for k in keys},
                   eager={k: runs[pool, "eager"][1][k] for k in keys},
                   capture_s=runs[pool, "graph"][1]["capture_s"],
                   graph_pool_bytes=runs[pool, "graph"][1][
                       "graph_pool_bytes"],
                   eager_over_graph_ms=(
                       runs[pool, "eager"][1]["decode_ms_per_step"]
                       / runs[pool, "graph"][1]["decode_ms_per_step"]))
        for pool in ("paged", "strip")})

    def prefill_logits(c):
        out = []
        for p in prompts[:3]:
            lg, _ = engine.prefill(params, torch.tensor([p], device="cuda"),
                                   cfg=c, max_len=MAX_LEN)
            out.append(lg.float())
        return out

    def worst_rel(got, want):
        return max(float((g - w).abs().max() / w.abs().max())
                   for g, w in zip(got, want))

    # plain forms: prefill logits of each request, and token agreement
    base_logits = prefill_logits(cfg)
    m_plain = build_model(ARCH, n_layers=n_layers, use_kernels=False)
    worst = worst_rel(base_logits, prefill_logits(m_plain.cfg))
    check(worst <= 5e-2, f"prefill logits kernels vs plain: {worst}")
    toks_plain, st3 = serve(m_plain, paged=True, temperature=0.0)
    agree = sum(a == b for x, y in zip(toks_plain, toks_paged)
                for a, b in zip(x, y)) / (N_REQ * NEW_TOKENS)
    say("parity", check="use_kernels=False vs True",
        prefill_logits_max_err_over_max_logit=worst,
        tol="5e-2 of the largest logit: bf16 activations through "
            f"{cfg.n_layers} layers round differently once the softmax "
            "sums differ in order", token_agreement=agree,
        launches=st3["launches"])
    check(sum(st3["launches"].values()) == 0,
          "use_kernels=False launched a kernel")

    def sampled(model, kname):
        """temperature 0.8 drives the algorithm's kernel over the vocab:
        more launches than the prefills' and no other softmax kernel's,
        one in every replay of the graph, as many as the eager step's."""
        counts = {}
        for fused in (True, False):
            eng = ContinuousBatchingEngine(model, params, slots=N_SLOTS,
                                           max_len=MAX_LEN, temperature=0.8,
                                           seed=5, fused=fused)
            K.reset_launch_counts()
            comps = eng.run([Request(rid=i, prompt=prompts[i][:200],
                                     max_new_tokens=4)
                             for i in range(N_SLOTS)])
            torch.cuda.synchronize()
            c = counts[fused] = K.launch_counts()
            check(all(len(x.tokens) == 4 for x in comps),
                  "sampled token counts")
            check(all(0 <= t < cfg.vocab for x in comps for t in x.tokens),
                  "sampled token range")
            check(c[kname] > N_SLOTS * cfg.n_layers
                  and all(c[k] == 0 for k in SOFTMAX_KERNELS if k != kname),
                  f"{kname}: sampler softmax kernel not launched: {c}")
            info = eng.throughput()
            per = info.get("launches_per_replay")
            check(not fused or (per.get(kname) == 1
                                and info["replays"] == info["steps"]),
                  f"{kname}: not in every replay: {per}")
            say("engine", path=f"paged, {model.cfg.softmax_algorithm}, "
                f"use_kernels=True, temperature=0.8, "
                f"{'graph' if fused else 'eager'} step", launches=c,
                launches_per_replay=per, steps=info["steps"])
            del eng
        check(counts[True] == counts[False],
              f"{kname}: graph launches {counts[True]} != eager "
              f"{counts[False]}")

    sampled(m, "twopass_softmax_2d")

    # the paper's three-pass baselines through the same engine: each run
    # launches its own kernel for every prefill layer and no two-pass one
    for algo, kname, strip in (
            ("three_pass_recompute", "threepass_recompute_2d", False),
            ("three_pass_reload", "threepass_reload_2d", True)):
        m3 = build_model(ARCH, n_layers=n_layers, use_kernels=True,
                         softmax_algorithm=algo)
        toks3, st3 = serve(m3, paged=True, temperature=0.0)
        c = st3["launches"]
        check(st3["admitted"] >= N_REQ
              and c[kname] == st3["admitted"] * cfg.n_layers,
              f"{algo}: {c[kname]} launches of {kname}")
        check(all(c[k] == 0 for k in SOFTMAX_KERNELS if k != kname)
              and c["decode_attention_paged"] > 0,
              f"{algo}: another softmax kernel ran: {c}")
        worst3 = worst_rel(prefill_logits(m3.cfg), base_logits)
        check(worst3 <= 5e-2, f"{algo} prefill logits vs two-pass: {worst3}")
        agree3 = sum(a == b for x, y in zip(toks3, toks_paged)
                     for a, b in zip(x, y)) / (N_REQ * NEW_TOKENS)
        say("engine", path=f"paged, {algo}, use_kernels=True, "
            "temperature=0", **st3)
        say("parity", check=f"{algo} vs two_pass",
            prefill_logits_max_err_over_max_logit=worst3,
            tol="5e-2 of the largest logit, as kernels vs plain",
            token_agreement=agree3)
        launches[kname] = c[kname]
        if strip:
            toks3s, st3s = serve(m3, paged=False, temperature=0.0)
            check(toks3s == toks3, f"{algo}: strip tokens != paged tokens")
            check(st3s["launches"][kname] > 0, f"{algo} strip: no launch")
            say("parity", check=f"{algo}: strip == paged tokens",
                equal=True, launches=st3s["launches"])
        sampled(m3, kname)
        del m3

    idle = {step: idle_share(torch, m, params, prompts, fused=fused)
            for step, fused in (("graph", True), ("eager", False))}
    say("idle_share", **{k: v or "not measured" for k, v in idle.items()})
    for fused in (True, False):
        decode_trace(torch, m, params, prompts, fused=fused)
    launches.update(xent_path(torch, m, params, prompts[0]))
    return launches, idle


def xent_path(torch, m, params, prompt) -> dict:
    """Phase 6: teacher-forced per-token loss of one prompt under the served
    model through ``SoftmaxPolicy.cross_entropy`` with kernels, and its
    gradient in the logits, against the plain route; returns the launches
    of that run."""
    import repro_torch.kernels as K
    from repro_torch.core.policy import SoftmaxPolicy
    from repro_torch.models import transformer

    cfg = m.cfg
    tok = torch.tensor([prompt], device="cuda")
    with torch.no_grad():
        h = transformer.forward(params, tok, cfg=cfg)     # the flash route
        logits = transformer.lm_logits(params, h, cfg=cfg)[0, :-1,
                                                           :cfg.vocab]
    logits = logits.contiguous().requires_grad_(True)
    labels = tok[0, 1:]
    K.reset_launch_counts()
    loss = cfg.softmax_policy().cross_entropy(logits, labels)
    loss.sum().backward()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    loss = loss.detach()
    plain = SoftmaxPolicy(algorithm=cfg.softmax_algorithm).cross_entropy(
        logits.detach(), labels)
    err = float(((loss - plain).abs() / plain.abs()).max())
    grad_rows = logits.grad.float().sum(-1).abs().max()
    check(loss.shape == plain.shape and bool(torch.isfinite(loss).all())
          and err <= 1e-5, f"cross_entropy kernels vs plain: {err}")
    check(launches["xent_fwd_2d"] == 1 and launches["xent_bwd_2d"] == 1,
          f"cross_entropy kernels not launched: {launches}")
    say("xent", path="SoftmaxPolicy.cross_entropy, use_kernels=True, "
        "backward", shape=list(logits.shape), dtype=str(logits.dtype),
        mean_loss=float(loss.mean()), max_rel_err_vs_plain=err,
        tol="rtol 1e-5 (sum order)", dlogits_max_row_sum=float(grad_rows),
        launches=launches)
    return {k: launches[k] for k in ("xent_fwd_2d", "xent_bwd_2d")}


# ---------------------------------------------------------------------------
# Phase 7: the SWA ring cache and head dim 160 at full width.
# ---------------------------------------------------------------------------
SWA_ARCH = "h2o-danube-3-4b"    # 24 layers, 32 / 8 heads of 120, window 4096
D160_ARCH = "stablelm-12b"      # 40 layers, 32 / 8 heads of 160, vocab 100352
SWA_SEED = 24
SWA_MAX_LEN = 8192
SWA_PROMPTS = (8, 4500, 7001)   # requests, prompt lengths in [lo, hi)
D160_PROMPTS = (4, 300, 1501)
WRAP_LAYERS = 2                 # depth cut (4 until PR 34, the script's
                                # time limit): 4,160 eager steps
WRAP_BATCH = 2
WRAP_STEPS = 64                 # steps past the wrap
DECODE_32K = (128, 32768, 8)    # the decode_32k cell: batch, positions, steps
LOGIT_TOL = 5e-2                # of the largest logit, as in the engine phase
F32_LOGIT_TOL = 1e-4            # the same in float32 activations
SWA_KERNELS = ("twopass_softmax_2d", "decode_attention_paged",
               "decode_attention")


def softmax_rows_check(torch, rows, key, x, case, **info) -> None:
    """Kernel 1 on the score rows ``x`` [r, c] (float32, -inf where the
    path masks) against its plain version, at the kernel phase's
    tolerance, with -inf columns exactly 0; timed into
    ``rows["twopass_softmax_2d"][key]``."""
    from repro_torch.kernels import twopass_softmax as tp

    r, c = x.shape
    y = tp.twopass_softmax_2d(x)
    torch.cuda.synchronize()
    plain = tp.twopass_softmax_2d_plain(x)
    a, rel = err(y, plain)
    check(torch.allclose(y, plain, atol=5e-6, rtol=1e-5),
          f"twopass_softmax_2d {case}: max abs err {a}")
    one = torch.isfinite(x).sum(1) == 1
    # a row of one finite column is m RN(1/m), as the reference's Pallas
    # kernel computes it (lam = 1 / m_sum): 1, or 1 - 2^-24 for about one
    # m in seven; the plain version's bits
    check(not bool(y.masked_select(torch.isinf(x)).any())
          and torch.equal(y[one], plain[one])
          and bool((y[one].amax(1) >= 1 - 2.0 ** -24).all()),
          f"twopass_softmax_2d {case}: -inf columns not exact 0, or a row "
          "of one finite column not its plain version's m RN(1/m)")
    say("kernel_check", kernel="twopass_softmax_2d", shape=[r, c],
        case=case, path=tp.path_for(c), max_abs_err=a, max_rel_err=rel,
        tol="atol 5e-6 rtol 1e-5, as the kernel phase; -inf columns "
            "exact 0; a row of one finite column the plain version's bits",
        rows_of_one_column=int(one.sum()),
        rows_of_one_column_below_1=int((y[one].amax(1) < 1).sum()), **info)
    del y, plain, one
    row = rows["twopass_softmax_2d"][key] = dict(
        **timed(torch, lambda: tp.twopass_softmax_2d(x),
                lambda: tp.twopass_softmax_2d_plain(x),
                lambda: torch.softmax(x, -1)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(2 * r * c * 4, SOFTMAX_OPS * r * c))),
        max_abs_err=a, shape=[r, c], path=tp.path_for(c))
    say("kernel_time", kernel="twopass_softmax_2d", case=key,
        bound_us=row["bound_ms"] * 1e3, **row)


def decode_case(torch, rows, gen, case, *, lengths, tab, hkv, g, d,
                window=None, ps=128, dtype=None, kv_view=None) -> None:
    """Kernels 3 and 4 on q [S, hkv, g, d] (bf16 unless ``dtype``) and a
    seeded arena read through ``tab`` (the strip pool is the same pages
    laid end to end) at ``lengths``; with ``kv_view`` (first, count of
    the arena's KV heads) the arena holds ``count`` heads and the kernels
    read the ``hkv`` from ``first`` on through a view, as the ungrouped
    layout's decode does.  Each against its plain version (the
    kernel phase's tolerance for the dtype), strip bit-equal to paged;
    timed by graph replay into ``rows[kernel][case]`` beside
    ``scaled_dot_product_attention`` over the strip, with the bound of the
    visible positions' bytes."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da

    dev, bf = "cuda", dtype or torch.bfloat16
    s, pmax = tab.shape
    n_pages = 1 + s * pmax
    lens = torch.from_numpy(lengths).to(dev)
    # as in the kernel phase: bf16 may round one step apart, float32 differs
    # by the sum order
    tol = (dict(atol=1e-5, rtol=1e-2) if bf == torch.bfloat16
           else dict(atol=1e-5, rtol=0.0))
    size = torch.finfo(bf).bits // 8
    q = torch.randn((s, hkv, g, d), device=dev, generator=gen).to(bf)
    kv0, heads = kv_view or (0, hkv)
    kp, vp = (torch.randn((n_pages, ps, heads, d), device=dev,
                          generator=gen).to(bf).narrow(2, kv0, hkv)
              for _ in "kv")
    ks, vs = (x[tab.long()].reshape(s, pmax * ps, hkv, d).transpose(1, 2)
              for x in (kp, vp))
    sc = d ** -0.5
    fns = {
        "decode_attention_paged": (
            lambda: da.decode_attention_paged(
                q, kp, vp, tab, lens, scale=sc, window=window,
                pages_per_tile=1),
            lambda: da.decode_attention_paged_plain(
                q, kp, vp, tab, lens, scale=sc, window=window,
                n_t_chunks=pmax)),
        "decode_attention": (
            lambda: da.decode_attention(q, ks, vs, lens, scale=sc,
                                        window=window, block_t=ps),
            lambda: da.decode_attention_plain(
                q, ks, vs, lens, scale=sc, window=window,
                n_t_chunks=pmax))}
    pos = torch.arange(pmax * ps, device=dev)[None, :]
    mask = pos < lens[:, None]
    if window is not None:
        mask &= pos > lens[:, None] - 1 - window
    visible = int(mask.sum())
    q_l = q.reshape(s, hkv * g, 1, d)
    b_ms, b_by = bound(visible * hkv * 2 * d * size + 2 * q.numel() * size
                       + s * pmax * 4 + s * 4,
                       visible * hkv * g * (4 * d + 20))
    paged_out = None
    for name, (fn, plain) in fns.items():
        got = fn()
        torch.cuda.synchronize()
        r = held(got, plain(), tol, f"{name} {case}")
        if paged_out is None:
            paged_out = got
        else:
            check(torch.equal(got, paged_out),
                  f"decode_attention {case}: strip != paged bits")
        body = da.kernel_body(bf, bf, d, d, da._row_bytes(kp, vp))
        say("kernel_check", kernel=name, case=case, body=body, **r)
        rows.setdefault(name, {})[case] = dict(
            ms=graph_ms(torch, fn), eager_ms=cuda_ms(torch, fn),
            plain_ms=cuda_ms(torch, plain, 5),
            library_ms=graph_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q_l, ks, vs, attn_mask=mask[:, None, None, :],
                    enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=r["max_abs_err"],
            shape=dict(q=list(q.shape), pages=list(kp.shape),
                       window=window, lengths=lengths.tolist()))
        say("kernel_time", kernel=name, case=case,
            bound_us=b_ms * 1e3, **rows[name][case])


def swa_kernel_checks(torch, rng, rows) -> None:
    """Kernels 1, 3 and 4 at this phase's shapes: decode at G 4 with D 120
    under the 4096 window and D 160 without one (8 slots, 1,000-7,000
    positions), and the two-pass softmax on ring score rows whose tails
    are not written yet (-inf), the first row with one valid slot."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SWA_SEED)
    s, ps = N_SLOTS, 128
    pmax = SWA_MAX_LEN // ps
    lengths = rng.integers(1000, 7001, s).astype(np.int32)
    n_pages = 1 + s * pmax
    tab = torch.from_numpy(rng.permutation(np.arange(1, n_pages)).reshape(
        s, pmax).astype(np.int32)).to(dev)
    for d, window in ((120, 4096), (160, None)):
        case = f"g4_d{d}_" + (f"window_{window}" if window else "no_window")
        decode_case(torch, rows, gen, case, lengths=lengths, tab=tab,
                    hkv=8, g=4, d=d, window=window, ps=ps)

    # ring score rows: slot order, -inf past each row's written slots
    r = c = 4096
    x = torch.randn((r, c), device=dev, generator=gen) * 8
    valid = torch.from_numpy(rng.integers(1, c + 1, r)).to(dev)
    valid[0], valid[-1] = 1, c
    x.masked_fill_(torch.arange(c, device=dev)[None, :] >= valid[:, None],
                   -torch.inf)
    softmax_rows_check(torch, rows, "ring_rows_4096", x,
                       "ring_rows_partly_filled",
                       valid_min=int(valid.min()))


def serve_model(torch, rows, arch, rng, n_req, lo, hi, max_len,
                tag: str = "swa"):
    """One model at full width and depth with seeded bf16 weights, through
    ``serving_engine``: greedy on the paged pool (the main path, the decode
    step a CUDA graph), the same with the eager step (the same tokens and
    launches), the strip pool (the same tokens) and a ``temperature=0.8``
    run whose sampler launches the two-pass kernel.  Kernel 1 is held
    against its plain version on the rows this model gives it
    (:func:`swa_softmax_rows`), and the prefill logits of its shortest,
    median and longest prompts with kernels against those without
    (:func:`swa_prefill_parity`).  Returns
    the model, its weights and the main path's launches (the strip run's
    for kernel 4).  ``tag`` names the phase in the config line."""
    from repro_torch.kernels import twopass_softmax as tp
    from repro_torch.models import build_model
    from repro_torch.serving.scheduler import Request

    m = build_model(arch, use_kernels=True)
    cfg = m.cfg
    t0 = time.perf_counter()
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weights_bytes = sum(t.numel() * 2 for t in _leaves(params))
    say(f"{tag}_config", arch=arch, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim(), d_ff=cfg.d_ff, vocab=cfg.vocab,
        swa_window=cfg.swa_window, weights_s=time.perf_counter() - t0,
        weights_bytes=weights_bytes, param_count=cfg.param_count())
    plens = rng.integers(lo, hi, n_req)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, n))
               for n in plens]

    swa_softmax_rows(torch, rows, cfg, int(plens.max()), n_req)

    def reqs(new=NEW_TOKENS, cut=None):
        return [Request(rid=i, prompt=p[:cut], max_new_tokens=new)
                for i, p in enumerate(prompts)]

    kw = dict(slots=n_req, max_len=max_len, seed=3)
    toks, st = serve_requests(torch, m, params, reqs(), paged=True,
                              temperature=0.0, **kw)
    say("engine", arch=arch, path="paged, use_kernels=True, temperature=0",
        prompt_lens=plens.tolist(), **st)
    c = st["launches"]
    check(all(len(t) == NEW_TOKENS for t in toks), f"{arch}: token counts")
    check(c["twopass_softmax_2d"] == n_req * cfg.n_layers
          and c["decode_attention_paged"] > 0,
          f"{arch}: kernels not launched on the main path: {c}")
    launches = {k: c[k] for k in SWA_KERNELS}
    toks_eager, st_e = serve_requests(torch, m, params, reqs(), paged=True,
                                      temperature=0.0, fused=False, **kw)
    say("engine", arch=arch, path="paged, use_kernels=True, temperature=0, "
        "eager step", **st_e)
    check(st["fused"] and not st_e["fused"], f"{arch}: fused flags")
    check(toks_eager == toks and st_e["launches"] == st["launches"],
          f"{arch}: graph tokens or launches != the eager step's")
    say("parity", arch=arch, check="paged: graph == eager tokens and "
        "launches", equal=True, launches_per_replay=st["launches_per_replay"],
        graph_ms_per_step=st["decode_ms_per_step"],
        eager_ms_per_step=st_e["decode_ms_per_step"],
        weights_read_ms=weights_bytes / HBM_BYTES_S * 1e3)
    toks_strip, st2 = serve_requests(torch, m, params, reqs(), paged=False,
                                     temperature=0.0, **kw)
    say("engine", arch=arch, path="strip, use_kernels=True, temperature=0",
        **st2)
    check(toks_strip == toks, f"{arch}: strip tokens != paged tokens")
    check(st2["launches"]["decode_attention"] > 0,
          f"{arch}: strip decode kernel not launched")
    launches["decode_attention"] = st2["launches"]["decode_attention"]
    say("parity", arch=arch, check="strip == paged tokens", equal=True)
    toks_t, st3 = serve_requests(torch, m, params, reqs(4, 512), paged=True,
                                 temperature=0.8, **kw)
    c = st3["launches"]
    check(c["twopass_softmax_2d"] > n_req * cfg.n_layers
          and all(0 <= t < cfg.vocab for x in toks_t for t in x),
          f"{arch}: sampler softmax kernel not launched: {c}")
    say("engine", arch=arch, path="paged, use_kernels=True, "
        "temperature=0.8", sampler_path=tp.path_for(cfg.vocab), **st3)
    order = np.argsort(plens, kind="stable")
    swa_prefill_parity(torch, m, params, [
        prompts[i] for i in (order[0], order[len(order) // 2], order[-1])],
        max_len)
    return m, params, launches


def swa_softmax_rows(torch, rows, cfg, s_max, n_req,
                     heads: int | None = None) -> None:
    """Kernel 1 on the two kinds of rows a served model gives it, at its
    own shapes: the prefill scores of its longest prompt, [heads * S, S]
    (``heads`` defaults to one KV head's G query heads; all of them is
    the one launch a layer makes), with the path's causal mask and window;
    and the sampler's [n_req, vocab] rows at temperature 0.8."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SWA_SEED)
    g, w = heads or cfg.n_heads // cfg.n_kv_heads, cfg.swa_window
    pos = torch.arange(s_max, device=dev)
    dead = pos[None, :] > pos[:, None]
    if w is not None:
        dead |= pos[None, :] <= pos[:, None] - w
    x = (torch.randn((g, s_max, s_max), device=dev, generator=gen) * 8
         ).masked_fill_(dead, -torch.inf).reshape(g * s_max, s_max)
    del dead
    softmax_rows_check(torch, rows, f"swa_{cfg.name}_prefill_rows", x,
                       f"{cfg.name} prefill score rows, causal, window {w}",
                       prompt_len=s_max, heads=g)
    del x
    x = torch.randn((n_req, cfg.vocab), device=dev, generator=gen) * 8 / 0.8
    softmax_rows_check(torch, rows, f"swa_{cfg.name}_sampler_rows", x,
                       f"{cfg.name} sampler rows, temperature 0.8")
    del x
    torch.cuda.empty_cache()


def swa_prefill_parity(torch, m, params, prompts, max_len) -> None:
    """``Model.prefill`` logits of ``prompts`` with kernels against the same
    model built with ``use_kernels=False``, within LOGIT_TOL of the largest
    logit, as the engine phase holds them; the plain run launches
    nothing."""
    import repro_torch.kernels as K
    from repro_torch.models import Model

    v = m.cfg.vocab

    def logits(model):
        out = []
        for p in prompts:
            lg, cache = model.prefill(
                params, torch.tensor([p], device="cuda"), max_len=max_len)
            out.append(lg[:, :v].float())
            del cache
            torch.cuda.empty_cache()
        return torch.cat(out)

    got = logits(m)
    plain = Model(dataclasses.replace(m.cfg, use_kernels=False), m.device)
    K.reset_launch_counts()
    want = logits(plain)
    check(sum(K.launch_counts().values()) == 0,
          f"{m.cfg.name}: use_kernels=False launched a kernel")
    worst = float(((got - want).abs().amax(1)
                   / want.abs().amax(1)).max())
    check(worst <= LOGIT_TOL,
          f"{m.cfg.name}: prefill logits kernels vs plain: {worst}")
    say("parity", arch=m.cfg.name, check="prefill logits, use_kernels="
        "True vs False", prompt_lens=[len(p) for p in prompts],
        prefill_logits_max_err_over_max_logit=worst,
        argmax_equal=int((got.argmax(1) == want.argmax(1)).sum()),
        tol=f"{LOGIT_TOL} of the largest logit, as the engine phase")


def _keys(cache):
    """A lockstep cache's K leaf (a hybrid cache's attention half's)."""
    return cache["attn"]["k"] if "attn" in cache else cache["k"]


def ring_vs_full(torch, model, params, toks):
    """A ring stepped from position 0 over all of ``toks`` [B, window +
    WRAP_STEPS], and a position-addressed cache prefilled with the first
    window of them and stepped on: each side's logits [WRAP_STEPS, B, V]
    past the wrap, and the ring steps' two-pass launches and seconds."""
    import repro_torch.kernels as K

    w, v = model.cfg.swa_window, model.cfg.vocab
    n = toks.shape[1]
    ring = model.init_cache(toks.shape[0], n)
    check(_keys(ring).shape[2] == w, "ring not sized at the window")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = []
    for t in range(n):
        lg, ring = model.decode_step(params, ring, toks[:, t], t)
        if t >= w:
            got.append(lg[:, :v].float())
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    launched = K.launch_counts()["twopass_softmax_2d"]
    check(launched == n * model.cfg.n_layers,
          f"ring: {launched} two-pass launches for {n} steps")
    _, full = model.prefill(params, toks[:, :w], max_len=n)
    check(_keys(full).shape[2] == n, "full cache not position-addressed")
    want = []
    for t in range(w, n):
        lg, full = model.decode_step(params, full, toks[:, t], t)
        want.append(lg[:, :v].float())
    return torch.stack(got), torch.stack(want), launched, ring_s


def ring_wrap_check(torch, m, params, rng) -> int:
    """The ring past its wrap at full width, depth cut to WRAP_LAYERS, with
    the model's bf16 activations and again with float32 ones (the same
    weights, widened): ``ring_vs_full`` over WRAP_STEPS steps past the
    wrap.  The ring's scores come in slot order, so its logits are only
    close: within LOGIT_TOL of the largest in bf16, F32_LOGIT_TOL in
    float32.  Greedy tokens are ``==`` at every compared step in float32.
    In bf16 they are ``==`` at every step whose full-cache top-2 margin
    exceeds twice the largest logit error measured in that run (the steps
    where that error could swap the two are counted and their margins
    printed), and the count that agrees over all steps is reported.
    Returns the ring steps' two-pass launches.  Float32 weights (a hybrid
    model's ``a_log`` and ``dt_bias``) stay float32."""
    from repro_torch.models import Model
    from repro_torch.models.transformer import torch_dtype

    def first_layers(tree, dt):
        if isinstance(tree, dict):
            return {k: first_layers(v, dt) for k, v in tree.items()}
        return tree[:WRAP_LAYERS].to(
            torch.float32 if tree.dtype == torch.float32 else dt)

    cfg = dataclasses.replace(m.cfg, n_layers=WRAP_LAYERS)
    n = cfg.swa_window + WRAP_STEPS
    toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                         (WRAP_BATCH, n))).cuda()
    launched = 0
    for dtype, tol in (("bfloat16", LOGIT_TOL), ("float32", F32_LOGIT_TOL)):
        dt = torch_dtype(dtype)
        p4 = {k: first_layers(v, dt) if k == "blocks" else
              {n_: t.to(dt) for n_, t in v.items()}
              for k, v in params.items()}
        model = Model(dataclasses.replace(cfg, dtype=dtype), m.device)
        got, want, n_l, ring_s = ring_vs_full(torch, model, p4, toks)
        launched += n_l
        abs_err = float((got - want).abs().max())
        worst = abs_err / float(want.abs().max())
        same = got.argmax(-1) == want.argmax(-1)
        top2 = want.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]             # [steps, batch]
        decided = margin > 2 * abs_err
        say("swa_ring_wrap", arch=cfg.name, dtype=dtype,
            n_layers=WRAP_LAYERS, full_depth=m.cfg.n_layers,
            batch=WRAP_BATCH, ring_slots=cfg.swa_window, steps=n,
            steps_compared=WRAP_STEPS, ring_ms_per_step=ring_s / n * 1e3,
            twopass_launches=n_l, tokens_equal=int(same.sum()),
            tokens_compared=same.numel(),
            logits_max_err_over_max_logit=worst, logits_max_abs_err=abs_err,
            tol=f"{tol} of the largest logit: the ring's sums in slot "
                "order, the full cache's prompt prefilled in one pass",
            top2_margin=margin.tolist(),
            tokens_decided=int(decided.sum()),
            tokens_left_out=int((~decided).sum()),
            margins_left_out=margin[~decided].tolist(),
            margins_of_unequal=margin[~same].tolist())
        check(worst <= tol, f"ring logits vs full cache, {dtype}: {worst}")
        check(bool(same[decided].all()), f"ring greedy tokens != full-cache "
              f"tokens, {dtype}, at a top-2 margin above 2 x {abs_err}")
        del got, want, p4
    check(bool(same.all()), "float32 ring greedy tokens != full-cache "
          "tokens")
    return launched


def ring_decode_32k(torch, m, params, rng) -> int:
    """``Model.init_cache`` at the decode_32k cell's shape with the ring on,
    stepped DECODE_32K[2] times at the last positions: a memory and time
    line (the ring holds zeros; ring_wrap_check holds correctness).
    Returns the steps' two-pass launches."""
    import repro_torch.kernels as K
    from repro_torch.serving import kv_cache

    b, t_max, steps = DECODE_32K
    cfg = m.cfg
    ring_b = kv_cache.cache_bytes(cfg, b, t_max)
    full_b = kv_cache.cache_bytes(cfg, b, t_max, ring=False)
    torch.cuda.reset_peak_memory_stats()
    cache = m.init_cache(b, t_max)
    check(sum(x.numel() * x.element_size() for x in cache.values())
          == ring_b, "ring cache bytes != cache_bytes")
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, b)).cuda()
    K.reset_launch_counts()
    ms = []
    for pos in range(t_max - steps, t_max):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = m.decode_step(params, cache, tok, pos)
        tok = lg[:, :cfg.vocab].argmax(-1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launched = K.launch_counts()["twopass_softmax_2d"]
    check(lg.shape == (b, cfg.padded_vocab())
          and bool(torch.isfinite(lg).all()), "decode_32k ring logits")
    check(launched == steps * cfg.n_layers,
          f"decode_32k ring: {launched} two-pass launches")
    say("swa_ring_decode_32k", arch=cfg.name, n_layers=cfg.n_layers,
        batch=b, positions=t_max, ring_slots=cache["k"].shape[2],
        cache_bytes=ring_b, cache_bytes_ring_false=full_b,
        peak_bytes=torch.cuda.max_memory_allocated(), step_ms=ms,
        median_step_ms=statistics.median(ms),
        tok_s=b / statistics.median(ms) * 1e3, twopass_launches=launched)
    return launched


def swa_phase(torch, rows) -> dict:
    """Phase 7; returns its main paths' launches of kernels 1, 3 and 4."""
    rng = np.random.default_rng(SWA_SEED)
    swa_kernel_checks(torch, rng, rows)
    m, params, launches = serve_model(torch, rows, SWA_ARCH, rng,
                                      *SWA_PROMPTS, SWA_MAX_LEN)
    launches["twopass_softmax_2d"] += ring_wrap_check(torch, m, params, rng)
    gc.collect()
    torch.cuda.empty_cache()
    launches["twopass_softmax_2d"] += ring_decode_32k(torch, m, params, rng)
    del m, params
    gc.collect()
    torch.cuda.empty_cache()
    m, params, more = serve_model(torch, rows, D160_ARCH, rng,
                                  *D160_PROMPTS, MAX_LEN)
    del m, params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] + more[k] for k in SWA_KERNELS}


# ---------------------------------------------------------------------------
# Phase 8: granite-20b's multi-query attention at full width and depth.
# ---------------------------------------------------------------------------
MQA_ARCH = "granite-20b"     # 52 layers, 48 query heads over 1 KV head of 128
MQA_SEED = 20
MQA_PROMPTS = (N_SLOTS, 200, 1501)     # requests, prompt lengths [lo, hi)


def mqa_phase(torch, rows) -> dict:
    """Phase 8: kernels 3 and 4 at the served decode shape [8, 1, 48, 128]
    (the bf16 body's G 48: six blocks of eight query heads a KV head),
    then granite-20b served through :func:`serve_model` (which also holds
    kernel 1 on its prefill score rows [48 * S, S] and sampler rows).
    Its 56.3 GB of bf16 weights leave no room for a second model: the
    caller frees every earlier phase's first.  Returns the main paths'
    launches of kernels 1, 3 and 4."""
    rng = np.random.default_rng(MQA_SEED)
    gen = torch.Generator(device="cuda").manual_seed(MQA_SEED)
    ps = 128
    pmax = MAX_LEN // ps
    n_pages = 1 + N_SLOTS * pmax
    lengths = rng.integers(200, 1501 + NEW_TOKENS, N_SLOTS).astype(np.int32)
    tab = torch.from_numpy(rng.permutation(np.arange(1, n_pages)).reshape(
        N_SLOTS, pmax).astype(np.int32)).cuda()
    decode_case(torch, rows, gen, "mqa_g48_d128", lengths=lengths, tab=tab,
                hkv=1, g=48, d=128, ps=ps)
    gc.collect()
    torch.cuda.empty_cache()
    m, params, launches = serve_model(torch, rows, MQA_ARCH, rng,
                                      *MQA_PROMPTS, MAX_LEN, tag="mqa")
    del m, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the ssm family, rwkv6-1.6b, at full width and depth.
# ---------------------------------------------------------------------------
SSM_ARCH = "rwkv6-1.6b"      # 24 layers, d 2048, 32 heads of 64, vocab 65536
SSM_SERVE_LAYERS = 4         # the serving path's depth: the first 4 layers'
                             # weights (8 until PR 34), so that the whole
                             # script keeps inside its time limit; the scan
                             # check runs all 24
SSM_SEED = 16
SSM_SLOTS = 32
SSM_PROMPTS = (48, 200, 4001)          # requests, prompt lengths [lo, hi)
SSM_NEW = 64
SSM_MAX_LEN = 4000 + SSM_NEW
SSM_SAMPLED = (128, 8)       # temperature 0.8: one request a slot, prompt
                             # cut, new tokens
SCAN_LEN = 16384             # 64 chunks of 256: the chunked scan's scan branch
SCAN_SPLIT = 16128           # 63 chunks of 256 prefilled, then 256 steps
SCAN_TOKENS = 32             # greedy tokens held == after both, float32
# the prefill of SCAN_LEN against SCAN_SPLIT + steps, as a share of the
# largest value (logits, and each state leaf).  float32: set from the
# float32 chunk's summation order (tests/test_torch_ssm.py: 1e-6 sqrt(256)
# of the largest output of one scan), with room for 24 layers.  bf16: the
# two paths round different values to bf16, so each is held against the
# float32 prefill on the same weights: the step path's distance from it
# within (1 + SCAN_BF16_MARGIN) times the bf16 prefill's own.  Measured on
# the H100 (chip_smoke.py --only ssm) the ratio is 0.99 for the logits and
# 0.70-0.87 for the state leaves; the margin leaves a quarter above that.
# The bf16 step-vs-prefill distance is reported, not held.
SCAN_F32_TOL = 1e-3
SCAN_BF16_MARGIN = 0.25
SSM_SOFTMAX = (("two_pass", "twopass_softmax_2d"),
               ("three_pass_recompute", "threepass_recompute_2d"),
               ("three_pass_reload", "threepass_reload_2d"))


def sampler_rows_check(torch, rows, kname, x, key) -> None:
    """``kname`` (a softmax kernel) on sampler rows ``x`` [r, vocab]
    against its plain version at the kernel phase's float32 tolerance;
    timed into ``rows[kname][key]``."""
    from repro_torch.kernels import threepass_softmax as tp3
    from repro_torch.kernels import twopass_softmax as tp

    fn, plain, ops = {
        "twopass_softmax_2d": (tp.twopass_softmax_2d,
                               tp.twopass_softmax_2d_plain, SOFTMAX_OPS),
        "threepass_recompute_2d": (tp3.threepass_recompute_2d,
                                   tp3.threepass_recompute_2d_plain,
                                   RECOMPUTE_OPS),
        "threepass_reload_2d": (tp3.threepass_reload_2d,
                                tp3.threepass_reload_2d_plain,
                                RELOAD_OPS)}[kname]
    r, c = x.shape
    got = fn(x)
    torch.cuda.synchronize()
    h = held(got, plain(x), dict(atol=5e-6, rtol=1e-5), f"{kname} {key}")
    say("kernel_check", kernel=kname, case=key, shape=[r, c],
        path=tp.path_for(c), **h)
    row = rows.setdefault(kname, {})[key] = dict(
        **timed(torch, lambda: fn(x), lambda: plain(x),
                lambda: torch.softmax(x, -1)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(2 * r * c * 4, ops * r * c))),
        max_abs_err=h["max_abs_err"], shape=[r, c], path=tp.path_for(c))
    say("kernel_time", kernel=kname, case=key,
        bound_us=row["bound_ms"] * 1e3, **row)


def ssm_serving(torch, m, params, prompts) -> dict:
    """The served traffic through ``Model.serving_engine`` (the strip pool,
    32 slots): greedy with the decode step a CUDA graph (the main path),
    again eager (the same tokens and launches, the state after the run
    bit-equal), with ``use_kernels=False`` (the same tokens: greedy runs
    no kernel); then ``temperature=0.8`` under each softmax algorithm,
    its kernel once a replay (two-pass also eager: as many launches).
    Returns the sampled runs' launches."""
    from repro_torch.models import Model
    from repro_torch.serving.scheduler import Request

    cfg = m.cfg

    def reqs(cut=None, new=SSM_NEW, n=None):
        return [Request(rid=i, prompt=p[:cut], max_new_tokens=new)
                for i, p in enumerate(prompts[:n])]

    kw = dict(slots=SSM_SLOTS, max_len=SSM_MAX_LEN, seed=3)
    runs, states = {}, {}
    for step, fused in (("graph", True), ("eager", False)):
        states[step] = {}
        toks, st = serve_requests(torch, m, params, reqs(),
                                  state=states[step], temperature=0.0,
                                  fused=fused, **kw)
        say("engine", arch=cfg.name, path=f"strip, use_kernels=True, "
            f"temperature=0, {step} step",
            prompt_lens=[len(p) for p in prompts], **st)
        check(st["fused"] is fused and not st["paged"],
              f"{cfg.name} {step}: fused {st['fused']}, paged {st['paged']}")
        check(all(len(t) == SSM_NEW for t in toks),
              f"{cfg.name} {step}: token counts")
        check(st["admitted"] == len(prompts) > SSM_SLOTS
              and st["prefill_shapes"] == len(set(map(len, prompts))),
              f"{cfg.name} {step}: backfill, or a prompt was padded")
        runs[step] = toks, st
    (tg, sg), (te, se) = runs["graph"], runs["eager"]
    check(tg == te and sg["launches"] == se["launches"],
          f"{cfg.name}: graph tokens or launches != eager")
    check(sg["launches_per_replay"] == {}
          and sg["replays"] == sg["steps"] == se["steps"],
          f"{cfg.name}: greedy graph launches {sg['launches_per_replay']}")
    check(states["graph"].pop("slots") == set(range(SSM_SLOTS))
          == states["eager"].pop("slots"), "not every slot was adopted")
    same = {k: bool(torch.equal(v, states["eager"][k]))
            for k, v in states["graph"].items()}
    check(all(same.values()), f"{cfg.name}: graph state != eager: {same}")
    weights_bytes = sum(t.numel() * t.element_size()
                        for t in _leaves(params))
    keys = ("decode_ms_per_step", "decode_tok_s", "prefill_tok_s",
            "peak_bytes", "peak_reserved_bytes", "steps", "capture_s",
            "graph_pool_bytes")
    say("parity", arch=cfg.name, check="strip: graph == eager tokens and "
        "launches, the state after the run bit-equal", equal=True,
        state_equal=same, graph={k: sg.get(k) for k in keys},
        eager={k: se.get(k) for k in keys},
        eager_over_graph_ms=se["decode_ms_per_step"]
        / sg["decode_ms_per_step"],
        weights_bytes=weights_bytes,
        weights_read_ms=weights_bytes / HBM_BYTES_S * 1e3)
    del states
    plain = Model(dataclasses.replace(cfg, use_kernels=False), m.device)
    toks_p, st_p = serve_requests(torch, plain, params, reqs(),
                                  temperature=0.0, **kw)
    check(toks_p == tg and sum(st_p["launches"].values()) == 0,
          f"{cfg.name}: use_kernels=False tokens != kernels', or launched")
    say("parity", arch=cfg.name, check="use_kernels=False == True tokens "
        "(greedy launches no kernel)", equal=True,
        decode_ms_per_step=st_p["decode_ms_per_step"])

    launches = {}
    cut, new = SSM_SAMPLED
    for algo, kname in SSM_SOFTMAX:
        model = Model(dataclasses.replace(cfg, softmax_algorithm=algo),
                      m.device)
        counts = {}
        for fused in (True, False) if algo == "two_pass" else (True,):
            toks, st = serve_requests(torch, model, params,
                                      reqs(cut, new, SSM_SLOTS),
                                      temperature=0.8, fused=fused, **kw)
            c = counts[fused] = st["launches"]
            check(all(len(t) == new and all(0 <= x < cfg.vocab for x in t)
                      for t in toks), f"{algo}: sampled tokens")
            check(c[kname] == st["admitted"] + st["steps"]
                  and all(c[k] == 0 for k in SOFTMAX_KERNELS if k != kname),
                  f"{algo}: sampler kernel launches {c}")
            check(not fused or (st["launches_per_replay"] == {kname: 1}
                                and st["replays"] == st["steps"]),
                  f"{algo}: not once a replay: {st.get('launches_per_replay')}")
            say("engine", arch=cfg.name, path=f"strip, {algo}, use_kernels="
                f"True, temperature=0.8, {'graph' if fused else 'eager'} "
                "step", **st)
        check(counts[True] == counts.get(False, counts[True]),
              f"{algo}: graph launches != eager: {counts}")
        launches[kname] = counts[True][kname]
    return launches


def ssm_scan_check(torch, m, params, rng) -> None:
    """The chunked scan's scan branch at full width: one prompt of
    SCAN_LEN tokens (64 chunks of 256) prefilled, against the first
    SCAN_SPLIT (63 chunks of 256, the scan branch too: the reference's
    needs a multiple of the chunk) prefilled and SCAN_LEN - SCAN_SPLIT
    steps of ``Model.decode_step``, in float32 activations (the same
    weights, widened: the last logits and every state leaf within
    SCAN_F32_TOL of the largest value, the next SCAN_TOKENS greedy tokens
    ``==``) and in bf16 (the step path's distance from the float32
    prefill within 1 + SCAN_BF16_MARGIN times the bf16 prefill's own)."""
    from repro_torch.models import Model, ssm
    from repro_torch.models.transformer import torch_dtype

    cfg = m.cfg
    for s, n in ((SCAN_LEN, 64), (SCAN_SPLIT, 63)):
        check(ssm.chunk_plan("rwkv6", s, cfg.ssm.chunk_size) == (256, n, True),
              f"{s} tokens: not the scan branch's 256 x {n}")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, SCAN_LEN))).cuda()
    v = cfg.vocab

    def greedy(model, p, logits, state, pos):
        out = []
        for t in range(SCAN_TOKENS):
            tok = logits[:, :v].argmax(-1)
            out.append(int(tok))
            logits, state = model.decode_step(p, state, tok, pos + t)
        return out

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    def errs(lg, st, lg_ref, st_ref):
        return dict(logits=rel(lg[:, :v], lg_ref[:, :v]),
                    **{k: rel(st[k], st_ref[k]) for k in st_ref})

    f32 = None
    for dtype in ("float32", "bfloat16"):
        dt = torch_dtype(dtype)
        p = _cast_tree(params, dt)
        model = Model(dataclasses.replace(cfg, dtype=dtype), m.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lg_a, st_a = model.prefill(p, toks)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        lg_b, st_b = model.prefill(p, toks[:, :SCAN_SPLIT])
        t0 = time.perf_counter()
        for t in range(SCAN_SPLIT, SCAN_LEN):
            lg_b, st_b = model.decode_step(p, st_b, toks[:, t], t)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (SCAN_LEN - SCAN_SPLIT) * 1e3
        check(all(torch.isfinite(x).all() for x in (lg_a, *st_a.values())),
              f"scan branch {dtype}: non-finite")
        paths = errs(lg_b, st_b, lg_a, st_a)
        info, tokens = {}, {}
        if f32 is None:
            held, limit = paths, dict.fromkeys(paths, SCAN_F32_TOL)
            f32 = (lg_a.float().clone(),
                   {k: t.float().clone() for k, t in st_a.items()})
            tokens = dict(prefill=greedy(model, p, lg_a, st_a, SCAN_LEN),
                          steps=greedy(model, p, lg_b, st_b, SCAN_LEN))
        else:
            own = errs(lg_a, st_a, *f32)
            held = errs(lg_b, st_b, *f32)
            limit = {k: (1 + SCAN_BF16_MARGIN) * e for k, e in own.items()}
            info = dict(prefill_vs_float32=own, steps_vs_float32=held,
                        steps_over_prefill={k: held[k] / own[k]
                                            for k in own})
        say("ssm_scan_branch", arch=cfg.name, dtype=dtype,
            prompt=SCAN_LEN, chunks="64 x 256", split=SCAN_SPLIT,
            steps=SCAN_LEN - SCAN_SPLIT, max_err_over_max=paths,
            held="steps_vs_prefill" if held is paths else
            "steps_vs_float32", limit=limit, **info, prefill_s=prefill_s,
            prefill_tok_s=SCAN_LEN / prefill_s, prefill_peak_bytes=peak,
            step_ms=step_ms, argmax_equal=bool(
                lg_a[:, :v].argmax() == lg_b[:, :v].argmax()),
            greedy_tokens=tokens)
        check(all(held[k] <= limit[k] for k in held),
              f"scan branch {dtype}: {held} beyond {limit}")
        check(tokens.get("prefill") == tokens.get("steps"),
              f"scan branch {dtype}: greedy tokens {tokens}")
        del p, lg_a, st_a, lg_b, st_b, model
        gc.collect()
        torch.cuda.empty_cache()


def _cast_tree(tree, dt):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dt) for k, v in tree.items()}
    return tree.to(dt)


def ssm_phase(torch, rows) -> dict:
    """Phase 9; returns the sampled runs' launches of kernels 1, 5, 6.
    The serving path runs SSM_SERVE_LAYERS of the 24 layers, the scan
    check all of them."""
    from repro_torch.models import Model, build_model
    from repro_torch.models.transformer import layer

    rng = np.random.default_rng(SSM_SEED)
    m = build_model(SSM_ARCH, use_kernels=True)
    cfg = m.cfg
    t0 = time.perf_counter()
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    state = sum(x.numel() * x.element_size()
                for x in m.init_cache(1, 1).values())
    say("ssm_config", arch=SSM_ARCH, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        head_dim=cfg.ssm.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab,
        chunk_size=cfg.ssm.chunk_size, weights_s=time.perf_counter() - t0,
        weights_bytes=sum(t.numel() * 2 for t in _leaves(params)),
        param_count=cfg.param_count(), state_bytes_a_slot=state,
        serving_layers=SSM_SERVE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SSM_SEED)
    x = torch.randn((SSM_SLOTS, cfg.vocab), device="cuda",
                    generator=gen) * 8 / 0.8
    for _, kname in SSM_SOFTMAX:
        sampler_rows_check(torch, rows, kname, x, "ssm_sampler_rows")
    del x
    n_req, lo, hi = SSM_PROMPTS
    plens = rng.integers(lo, hi, n_req)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, n))
               for n in plens]
    served = Model(dataclasses.replace(cfg, n_layers=SSM_SERVE_LAYERS),
                   m.device)
    sp = dict(params, blocks=layer(params["blocks"],
                                   slice(0, SSM_SERVE_LAYERS)))
    launches = ssm_serving(torch, served, sp, prompts)
    # a decode burst alone: the state's size does not depend on the
    # prompt, so the trace's prefills are cut to 256 tokens
    for fused in (True, False):
        decode_trace(torch, served, sp, [p[:256] for p in prompts],
                     fused=fused, slots=SSM_SLOTS, max_len=SSM_MAX_LEN,
                     new=SSM_NEW)
    del sp
    ssm_scan_check(torch, m, params, rng)
    del m, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the encdec family, whisper-base, at full width and depth.
# ---------------------------------------------------------------------------
ENC_ARCH = "whisper-base"    # 6 + 6 layers, d 512, 8 heads of 64, vocab 51865
ENC_SEED = 27
ENC_SLOTS = 32
ENC_MAX_LEN = 448            # the config's dec_len
ENC_FRAMES = 1500            # one 30-s window at 50 frames a second
ENC_REQS = (48, 16)          # requests of 1,500 frames, of 600-1,499
ENC_PROMPTS = (4, 65)        # decoder prompt lengths [lo, hi)
ENC_NEW = (32, 193)          # new tokens [lo, hi)
ENC_SAMPLED = (32, 8)        # temperature 0.8: requests, new tokens
ENC_CHUNK = 500              # chunked admission: three windows of 1,500
ENC_CHUNKED = (16, 32)       # chunked admission: requests, new tokens
ENC_F32 = (2, 8, 16)         # the float32 cut: layers, requests, new tokens
ENC_LOCKSTEP = (4, 32)       # the bf16 lockstep check: requests, steps
# whisper's <|startofprev|>, then the previous text, then
# <|startoftranscript|> <|en|> <|transcribe|>
SOT_PREV, SOT = 50361, (50258, 50259, 50359)
ENC_FLASH = {"encdec_encoder": (1, 1500, 1500),
             "encdec_cross_prefill": (1, 128, 1500),
             "encdec_cross_lockstep": (ENC_SLOTS, 1, 1500)}
ENC_SOFTMAX = ("twopass_softmax_2d", "threepass_recompute_2d",
               "threepass_reload_2d")


def encdec_requests(rng, cfg, new=None):
    """ENC_REQS requests in a seeded order: frames (seeded float32 frame
    embeddings, the audio front end not modelled), a decoder prompt of
    ENC_PROMPTS tokens (a previous-text prompt and the start-of-transcript
    tokens) and ENC_NEW new tokens."""
    from repro_torch.serving.scheduler import Request

    full, ragged = ENC_REQS
    lens = np.concatenate([np.full(full, ENC_FRAMES),
                           rng.integers(600, ENC_FRAMES, ragged)])
    lens = lens[rng.permutation(full + ragged)]
    out = []
    for i, t in enumerate(lens):
        n = int(rng.integers(*ENC_PROMPTS))
        prev = tuple(int(x) for x in rng.integers(0, 50257, n - 4))
        out.append(Request(
            rid=i, prompt=(SOT_PREV,) + prev + SOT,
            max_new_tokens=new or int(rng.integers(*ENC_NEW)),
            frames=rng.standard_normal((int(t), cfg.d_model)).astype(
                np.float32)))
    return out


def _reqs(reqs, n=None, new=None):
    """Fresh copies of the first ``n`` requests, ``new`` tokens each."""
    return [dataclasses.replace(r, max_new_tokens=new or r.max_new_tokens)
            for r in reqs[:n]]


def encdec_flash_case(torch, rows, case, b, sq, skv) -> None:
    """Kernel 12 non-causal at D 64, 8 heads over 8 KV heads (bf16):
    against its plain version within :func:`flash_limits` (o and lse),
    the same bits twice; timed by graph replay (eager beside) next to the
    bound and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import twopass_xent as xe

    h, d = 8, 64
    gen = torch.Generator(device="cuda").manual_seed(sq + skv)
    q, do = (torch.randn(b, h, sq, d, device="cuda", generator=gen)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, h, skv, d, device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=False, scale=d ** -0.5, window=None)
    nq, nkv = fa.chunk_counts(sq, skv, 64, 64)
    pkw = dict(kw, n_q_chunks=nq, n_kv_chunks=nkv)
    o, m, n = fa.flash_attention_fwd_gqa(q, k, v, **kw)
    torch.cuda.synchronize()
    po, pm, pn = fa.flash_attention_fwd_gqa_plain(q, k, v, **pkw)
    lim = flash_limits(torch, q, k, v, do, po, pm, pn, False, None,
                       kw["scale"])
    err_o = (o.float() - po.float()).abs().reshape(-1)
    over_o = float((err_o / (lim["o"] + 2.0 ** -7 * po.float().abs()
                             .reshape(-1)).clamp(min=1e-30)).max())
    lse = (torch.log(m) + n * xe.LN2).reshape(-1)
    err_l = (lse - (torch.log(pm) + pn * xe.LN2).reshape(-1)).abs()
    over_l = float((err_l / lim["lse"].clamp(min=1e-30)).max())
    same = all(torch.equal(x, y) for x, y in zip(
        fa.flash_attention_fwd_gqa(q, k, v, **kw), (o, m, n)))
    del lim, do
    check(over_o <= 1.0 and over_l <= 1.0 and same,
          f"flash {case}: o {over_o}, lse {over_l} of their limits, same "
          f"bits twice {same}")
    say("kernel_check", kernel="flash_attention_fwd_gqa", case=case,
        shape=dict(b=b, h=h, hkv=h, sq=sq, skv=skv, d=d), causal=False,
        dtype="bfloat16", design=fa.design(torch.bfloat16, d),
        same_bits_twice=True,
        o_max_abs_err=float(err_o.max()), o_worst_err_over_limit=over_o,
        lse_max_abs_err=float(err_l.max()), lse_worst_err_over_limit=over_l,
        tol="flash_limits (float32 accumulation) plus one bf16 step")
    vis = b * h * sq * skv
    mm = 2 * vis * d
    qb, kb = q.numel() * 2, k.numel() * 2

    def fn():
        return fa.flash_attention_fwd_gqa(q, k, v, **kw)

    row = rows.setdefault("flash_attention_fwd_gqa", {})[case] = dict(
        ms=graph_ms(torch, fn), eager_ms=cuda_ms(torch, fn),
        plain_ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_gqa_plain(
            q, k, v, **pkw), 5),
        library_ms=graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v)),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(2 * qb + 2 * kb + 8 * b * h * sq,
                         FLASH_EXTEXP_OPS * vis, 2 * mm))),
        split_bound_ms=bound(0, 0, 4 * mm)[0],
        max_abs_err=float(err_o.max()),
        shape=dict(b=b, h=h, hkv=h, sq=sq, skv=skv, d=d, causal=False))
    say("kernel_time", kernel="flash_attention_fwd_gqa", case=case,
        bound_us=row["bound_ms"] * 1e3, **row)
    del q, k, v, o, m, n, po, pm, pn
    torch.cuda.empty_cache()


def encdec_kernel_checks(torch, rows, rng, cfg) -> None:
    """Kernels 12, 3 and 1 at the shapes whisper-base's serving gives
    them: the flash forward over one 30-s window (the encoder), a prefill
    bucket's queries against it (the cross-attention at prefill) and one
    query a slot (the lockstep cross read); the paged decode at G 1, D 64
    over cross lengths of 600-1,500 frames and self lengths up to 448; the
    two-pass softmax on the decoder prefill's causal score rows [8 x 128,
    128] and the sampler's rows [32, 51865] at temperature 0.8."""
    for case, (b, sq, skv) in ENC_FLASH.items():
        encdec_flash_case(torch, rows, case, b, sq, skv)
    gen = torch.Generator(device="cuda").manual_seed(ENC_SEED)
    ps = 128
    for case, hi, span in (("encdec_cross_g1_d64", ENC_FRAMES, 600),
                           ("encdec_self_g1_d64", ENC_MAX_LEN, 4)):
        pmax = -(-hi // ps)
        lengths = rng.integers(span, hi + 1, ENC_SLOTS).astype(np.int32)
        lengths[0] = hi
        n_pages = 1 + ENC_SLOTS * pmax
        tab = torch.from_numpy(rng.permutation(np.arange(1, n_pages))
                               .reshape(ENC_SLOTS, pmax).astype(np.int32)
                               ).cuda()
        decode_case(torch, rows, gen, case, lengths=lengths, tab=tab,
                    hkv=cfg.n_kv_heads, g=1, d=cfg.resolved_head_dim(),
                    ps=ps)
    s = 128
    pos = torch.arange(s, device="cuda")
    x = (torch.randn((cfg.n_heads, s, s), device="cuda", generator=gen) * 8
         ).masked_fill_(pos[None, :] > pos[:, None], -torch.inf)
    softmax_rows_check(torch, rows, "encdec_prefill_rows",
                       x.reshape(cfg.n_heads * s, s),
                       "whisper-base decoder prefill score rows, causal, "
                       "bucket 128", heads=cfg.n_heads)
    x = torch.randn((ENC_SLOTS, cfg.vocab), device="cuda",
                    generator=gen) * 8 / 0.8
    softmax_rows_check(torch, rows, "encdec_sampler_rows", x,
                       "whisper-base sampler rows, temperature 0.8")
    del x
    torch.cuda.empty_cache()


def encdec_launches(cfg, st, windows: int | None = None) -> dict:
    """The launches a greedy two-pass run must make: the flash forward
    for every encoder window's layers and every prefill's cross layers,
    the two-pass softmax for every prefill's self layers, two paged
    decode launches a decoder layer a step (self and cross)."""
    windows = st["admitted"] if windows is None else windows
    return {"flash_attention_fwd_gqa": cfg.n_enc_layers * windows
            + cfg.n_layers * st["admitted"],
            "twopass_softmax_2d": cfg.n_layers * st["admitted"],
            "decode_attention_paged": 2 * cfg.n_layers * st["steps"]}


def encdec_serving(torch, m, params, reqs) -> dict:
    """The served traffic through ``Model.serving_engine`` (paged, 32
    slots, ``max_cross_len`` 1,500): greedy with the decode step a CUDA
    graph (the main path) and eager (the same tokens, launches and arena
    bits); ``temperature=0.8`` under each softmax algorithm; chunked
    admission (``enc_chunk`` 500) graph against eager.  Returns (the main
    path's tokens, its launches of kernels 1, 3 and 12, and the sampled
    runs' of kernels 1, 5 and 6)."""
    from repro_torch.models import Model

    cfg = m.cfg
    kw = dict(slots=ENC_SLOTS, max_len=ENC_MAX_LEN,
              max_cross_len=ENC_FRAMES, seed=3)
    frames = [r.frames.shape[0] for r in reqs]
    runs, states = {}, {}
    for step, fused in (("graph", True), ("eager", False)):
        states[step] = {}
        toks, st = serve_requests(torch, m, params, _reqs(reqs),
                                  state=states[step], temperature=0.0,
                                  fused=fused, **kw)
        say("engine", arch=cfg.name, path=f"paged, use_kernels=True, "
            f"temperature=0, {step} step", frames=frames,
            prompt_lens=[len(r.prompt) for r in reqs], **st)
        check(st["fused"] is fused and st["paged"],
              f"{cfg.name} {step}: fused {st['fused']}, paged {st['paged']}")
        check([len(t) for t in toks] == [r.max_new_tokens for r in reqs],
              f"{cfg.name} {step}: token counts")
        check(st["admitted"] == len(reqs) > ENC_SLOTS
              and st["encode_frames"] == sum(frames),
              f"{cfg.name} {step}: admissions or frames")
        want = encdec_launches(cfg, st)
        check(all(st["launches"][k] == n for k, n in want.items()),
              f"{cfg.name} {step}: launches {st['launches']}, want {want}")
        runs[step] = toks, st
    (tg, sg), (te, se) = runs["graph"], runs["eager"]
    check(tg == te and sg["launches"] == se["launches"],
          f"{cfg.name}: graph tokens or launches != eager")
    check(sg["launches_per_replay"] == {
        "decode_attention_paged": 2 * cfg.n_layers}
        and sg["replays"] == sg["steps"] == se["steps"],
        f"{cfg.name}: graph launches {sg['launches_per_replay']}")
    check(states["graph"].pop("slots") == set(range(ENC_SLOTS))
          == states["eager"].pop("slots"), "not every slot was used")
    # page 0 is the trash page: dead writes
    same = {k: bool(torch.equal(v[:, 1:], states["eager"][k][:, 1:]))
            for k, v in states["graph"].items()}
    check(all(same.values()), f"{cfg.name}: graph arenas != eager: {same}")
    del states
    keys = ("decode_ms_per_step", "decode_tok_s", "prefill_tok_s",
            "prompt_tok_s", "encode_frames_s", "encode_s", "peak_bytes",
            "peak_reserved_bytes", "steps", "capture_s", "graph_pool_bytes")
    weights_bytes = sum(t.numel() * t.element_size()
                        for t in _leaves(params))
    say("parity", arch=cfg.name, check="paged: graph == eager tokens, "
        "launches and arena pages", equal=True, pages_equal=same,
        graph={k: sg.get(k) for k in keys},
        eager={k: se.get(k) for k in keys},
        eager_over_graph_ms=se["decode_ms_per_step"]
        / sg["decode_ms_per_step"], weights_bytes=weights_bytes,
        weights_read_ms=weights_bytes / HBM_BYTES_S * 1e3)
    launches = {k: sg["launches"][k] for k in (
        "flash_attention_fwd_gqa", "twopass_softmax_2d",
        "decode_attention_paged")}

    n, new = ENC_SAMPLED
    for algo, kname in SSM_SOFTMAX:
        model = Model(dataclasses.replace(cfg, softmax_algorithm=algo),
                      m.device)
        toks, st = serve_requests(torch, model, params,
                                  _reqs(reqs, n, new), temperature=0.8,
                                  **kw)
        c = st["launches"]
        check(all(len(t) == new and all(0 <= x < cfg.vocab for x in t)
                  for t in toks), f"encdec {algo}: sampled tokens")
        # two-pass: prefill self layers + the sampler (flash elsewhere);
        # three-pass: no flash route, every softmax site takes the kernel
        sites = (cfg.n_layers if algo == "two_pass"
                 else cfg.n_enc_layers + 2 * cfg.n_layers)
        check(c[kname] == st["admitted"] * (sites + 1) + st["steps"]
              and all(c[k] == 0 for k in ENC_SOFTMAX if k != kname)
              and (c["flash_attention_fwd_gqa"] > 0) == (algo == "two_pass"),
              f"encdec {algo}: launches {c}")
        check(st["launches_per_replay"] == {
            "decode_attention_paged": 2 * cfg.n_layers, kname: 1},
            f"encdec {algo}: a replay {st['launches_per_replay']}")
        say("engine", arch=cfg.name, path=f"paged, {algo}, use_kernels="
            "True, temperature=0.8, graph step", **st)
        if algo != "two_pass":
            launches[kname] = c[kname]

    n, new = ENC_CHUNKED
    chunked = {}
    for step, fused in (("graph", True), ("eager", False)):
        toks, st = serve_requests(torch, m, params, _reqs(reqs, n, new),
                                  temperature=0.0, fused=fused,
                                  enc_chunk=ENC_CHUNK, **kw)
        windows = sum(-(-r.frames.shape[0] // ENC_CHUNK) for r in reqs[:n])
        want = encdec_launches(cfg, st, windows)
        check(all(st["launches"][k] == w for k, w in want.items()),
              f"encdec chunked {step}: launches {st['launches']}, "
              f"want {want}")
        say("engine", arch=cfg.name, path=f"paged, enc_chunk={ENC_CHUNK}, "
            f"use_kernels=True, temperature=0, {step} step",
            windows=windows, **st)
        chunked[step] = toks, st
    (tg2, sg2), (te2, se2) = chunked["graph"], chunked["eager"]
    check(tg2 == te2 and sg2["launches"] == se2["launches"],
          "encdec chunked: graph tokens or launches != eager")
    whole = [t[:new] for t in tg[:n]]
    say("parity", arch=cfg.name, check=f"enc_chunk={ENC_CHUNK}: graph == "
        "eager tokens and launches", equal=True,
        tokens_equal_to_whole_encode=sum(a == b for x, y in zip(tg2, whole)
                                         for a, b in zip(x, y)),
        tokens_compared=n * new,
        note="each window is encoded alone from position 0, so the "
             "tokens may differ from a whole encode's")
    return tg, launches


def encdec_prefill_parity(torch, m, params, reqs) -> None:
    """``Model.prefill`` logits with frames, kernels against the same
    model with ``use_kernels=False``, within LOGIT_TOL of the largest
    logit; the plain run launches nothing."""
    import repro_torch.kernels as K
    from repro_torch.models import Model

    v = m.cfg.vocab
    order = sorted(range(len(reqs)), key=lambda i: reqs[i].frames.shape[0])
    pick = [reqs[i] for i in (order[0], order[len(order) // 2], order[-1])]

    def logits(model):
        return torch.cat([model.prefill(
            params, torch.tensor([r.prompt], device="cuda"),
            frames=torch.from_numpy(r.frames)[None].cuda())[0][:, :v]
            .float() for r in pick])

    got = logits(m)
    plain = Model(dataclasses.replace(m.cfg, use_kernels=False), m.device)
    K.reset_launch_counts()
    want = logits(plain)
    check(sum(K.launch_counts().values()) == 0,
          "encdec: use_kernels=False launched a kernel")
    worst = float(((got - want).abs().amax(1) / want.abs().amax(1)).max())
    check(worst <= LOGIT_TOL, f"encdec prefill logits kernels vs plain: "
          f"{worst}")
    say("parity", arch=m.cfg.name, check="prefill logits with frames, "
        "use_kernels=True vs False",
        frames=[r.frames.shape[0] for r in pick],
        prompt_lens=[len(r.prompt) for r in pick],
        prefill_logits_max_err_over_max_logit=worst,
        argmax_equal=int((got.argmax(1) == want.argmax(1)).sum()),
        tol=f"{LOGIT_TOL} of the largest logit, as the engine phase")


def encdec_teacher_forced(torch, m, params, req, toks):
    """Logits [len(toks) + 1, V] of one request fed ``toks`` after its
    prompt, two ways from one prefill: the engine's step
    (``decode_step_ragged`` over a one-slot paged pool: the paged decode
    kernel for the self and cross reads) and the lockstep one
    (``Model.decode_step`` over the ``{"self", "cross"}`` cache: the flash
    forward for the cross read, the two-pass softmax for the self)."""
    from repro_torch.serving import engine, kv_cache

    cfg, v = m.cfg, m.cfg.vocab
    plen, t = len(req.prompt), req.frames.shape[0]
    prompt = torch.tensor([req.prompt], device="cuda")
    frames = torch.from_numpy(req.frames)[None].cuda()
    tok = torch.tensor(toks, device="cuda")[:, None]
    lg0, cache = m.prefill(params, prompt, frames=frames,
                           max_len=plen + len(toks))
    pool = kv_cache.init_paged_pool(cfg, 1, ENC_MAX_LEN, page_size=128,
                                    cross_len=ENC_FRAMES, device="cuda")
    n_self = pool["page_table"].shape[1]
    rows = torch.arange(1, 1 + n_self + pool["cross_table"].shape[1],
                        dtype=torch.int32, device="cuda")
    kv_cache.adopt_slot_encdec(pool, cache, 0, plen, rows[:n_self], t,
                               rows[n_self:])
    paged, lock = [lg0], [lg0]
    for i in range(len(toks)):
        lg, _ = engine.decode_step_ragged(params, pool, tok[i], cfg=cfg)
        paged.append(lg)
        lg, cache = m.decode_step(params, cache, tok[i], plen + i)
        lock.append(lg)
    return (torch.cat(paged)[:, :v].float(), torch.cat(lock)[:, :v].float())


def encdec_lockstep_bf16(torch, m, params, reqs, toks) -> None:
    """Full depth, bf16: the served tokens of ENC_LOCKSTEP requests fed
    back through :func:`encdec_teacher_forced`.  The engine's step and the
    lockstep one sum in other orders, so greedy tokens are held ``==``
    only at steps whose lockstep top-2 margin exceeds twice the largest
    logit difference measured between the two; the served tokens are held
    against the engine step's argmax the same way."""
    n, steps = ENC_LOCKSTEP
    paged, lock, served = [], [], []
    for r, t in zip(reqs[:n], toks[:n]):
        p, q = encdec_teacher_forced(torch, m, params, r, t[:steps])
        paged.append(p)
        lock.append(q)
        served.append(torch.tensor(t[:steps + 1], device="cuda"))
    paged, lock, served = (torch.stack(x) for x in (paged, lock, served))
    abs_err = float((paged - lock).abs().max())
    top2 = lock.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    decided = margin > 2 * abs_err
    same = paged.argmax(-1) == lock.argmax(-1)
    top2p = paged.topk(2, dim=-1).values
    decided_p = top2p[..., 0] - top2p[..., 1] > 2 * abs_err
    served_same = served == paged.argmax(-1)
    say("encdec_lockstep", arch=m.cfg.name, dtype=m.cfg.dtype,
        n_layers=m.cfg.n_layers, requests=n, steps=steps,
        logits_max_abs_err=abs_err,
        logits_max_err_over_max_logit=abs_err / float(lock.abs().max()),
        tokens_equal=int(same.sum()), tokens_compared=same.numel(),
        tokens_decided=int(decided.sum()),
        margins_left_out=margin[~decided].tolist(),
        margins_of_unequal=margin[~same].tolist(),
        served_equal_to_engine_step=int(served_same.sum()),
        rule="== where the lockstep top-2 margin exceeds 2 x the largest "
             "logit difference between the engine's step and the lockstep")
    check(bool(same[decided].all()), "encdec bf16: engine step != lockstep "
          f"at a top-2 margin above 2 x {abs_err}")
    check(bool(served_same[decided_p].all()),
          "encdec bf16: served tokens != the engine step's argmax")


def encdec_f32_cut(torch, m, reqs) -> None:
    """Full width, depth cut to ENC_F32 layers, float32 activations and
    weights: the engine's greedy tokens (graph step) ``==`` the batch-1
    lockstep ``Model.generate`` over the same frames."""
    from repro_torch.models import Model

    layers, n, new = ENC_F32
    cfg = dataclasses.replace(m.cfg, n_layers=layers, n_enc_layers=layers,
                              dtype="float32")
    model = Model(cfg, m.device)
    params = model.init(seed=1, dtype=torch.float32)
    sub = _reqs(reqs, n, new)
    toks, st = serve_requests(torch, model, params, sub, temperature=0.0,
                              slots=ENC_SLOTS, max_len=ENC_MAX_LEN,
                              max_cross_len=ENC_FRAMES, seed=3)
    want = [model.generate(
        params, torch.tensor([r.prompt], device="cuda"), steps=new - 1,
        temperature=0.0, max_len=len(r.prompt) + new,
        frames=torch.from_numpy(r.frames)[None].cuda())[0].tolist()
        for r in sub]
    equal = sum(a == b for x, y in zip(toks, want) for a, b in zip(x, y))
    say("encdec_lockstep", arch=cfg.name, dtype="float32",
        n_layers=layers, requests=n, new_tokens=new, tokens_equal=equal,
        tokens_compared=n * new, rule="==")
    check(toks == want, "encdec float32: engine tokens != lockstep tokens")
    del params


def encdec_phase(torch, rows) -> dict:
    """Phase 10; returns the main path's launches of kernels 1, 3 and 12
    and the sampled runs' of kernels 5 and 6."""
    from repro_torch.models import build_model

    rng = np.random.default_rng(ENC_SEED)
    m = build_model(ENC_ARCH, use_kernels=True)
    cfg = m.cfg
    encdec_kernel_checks(torch, rows, rng, cfg)
    t0 = time.perf_counter()
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    say("encdec_config", arch=ENC_ARCH, n_layers=cfg.n_layers,
        n_enc_layers=cfg.n_enc_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim(), d_ff=cfg.d_ff, vocab=cfg.vocab,
        padded_vocab=cfg.padded_vocab(), act=cfg.act,
        weights_s=time.perf_counter() - t0,
        weights_bytes=sum(t.numel() * 2 for t in _leaves(params)),
        param_count=cfg.param_count(), slots=ENC_SLOTS,
        max_len=ENC_MAX_LEN, max_cross_len=ENC_FRAMES)
    reqs = encdec_requests(rng, cfg)
    toks, launches = encdec_serving(torch, m, params, reqs)
    encdec_prefill_parity(torch, m, params, reqs)
    encdec_lockstep_bf16(torch, m, params, reqs, toks)
    for fused in (True, False):
        decode_trace(torch, m, params, [r.prompt for r in reqs],
                     fused=fused, slots=ENC_SLOTS, max_len=ENC_MAX_LEN,
                     new=ENC_NEW[0], frames=[r.frames for r in reqs],
                     max_cross_len=ENC_FRAMES)
    encdec_f32_cut(torch, m, reqs)
    del m, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the moe family, granite-moe-3b-a800m, at full width.
# ---------------------------------------------------------------------------
MOE_ARCH = "granite-moe-3b-a800m"   # 32 layers, d 1536, 24 / 8 heads of 64,
                                    # 40 experts top 8 of 512, vocab 49155
MOE_SEED = 28
MOE_LAYERS = 16                     # depth cut from 32, so that the whole
                                    # script keeps inside its time limit
MOE_SLOTS = 32
MOE_PROMPTS = (48, 200, 2049)       # requests, prompt lengths [lo, hi)
MOE_LONG = (4096, 3000)             # two groups of 2,048; one group, cap 750
MOE_NEW = 64
MOE_MAX_LEN = MOE_LONG[0] + MOE_NEW
MOE_SAMPLED = (32, 128, 8)          # temperature 0.8: requests, prompt, new
MOE_FORCED = 16                     # requests fed back through both impls
MOE_TRACE = (1024, 32, 8)           # the traces: prompt cut, new tokens
                                    # graph and eager (a burst of 31 / 7)
MOE_F32 = (2, 8, 32)                # float32 cut: layers, requests, new


def router_rows_checks(torch, rows, gen, cfg, slots, tag) -> None:
    """Kernel 1 on a moe router's float32 rows [2048, E] (one prefill
    group) and [slots, E] (a decode step's slots) and on the sampler's
    rows [slots, vocab] at temperature 0.8; kernels 5 and 6 on the same
    rows.  Each against its plain version, timed beside its library call
    and bound, under ``rows[kernel][f"{tag}_..."]``."""
    e = cfg.moe.n_experts
    three = [k for _, k in SSM_SOFTMAX[1:]]
    # router logits: rms-normed activations over a d**-0.5 router, about
    # unit scale
    for r in (2048, slots):
        x = torch.randn((r, e), device="cuda", generator=gen)
        key = f"{tag}_router_rows_{r}"
        softmax_rows_check(torch, rows, key, x,
                           f"{tag} router rows [{r}, {e}]")
        for kname in three:
            sampler_rows_check(torch, rows, kname, x, key)
    x = torch.randn((slots, cfg.vocab), device="cuda",
                    generator=gen) * 8 / 0.8
    softmax_rows_check(torch, rows, f"{tag}_sampler_rows", x,
                       f"{tag} sampler rows, temperature 0.8")
    for kname in three:
        sampler_rows_check(torch, rows, kname, x, f"{tag}_sampler_rows")


def moe_kernel_checks(torch, rows, rng, cfg) -> None:
    """Kernels 1, 5 and 6 on the router's and the sampler's rows
    (:func:`router_rows_checks`); the decode kernels at G 3, D 64 (24
    query heads over 8 KV heads) over 32 slots of the served lengths,
    bf16 and float32, against their plain versions, timed beside their
    library call and bound."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    router_rows_checks(torch, rows, gen, cfg, MOE_SLOTS, "moe")
    s, ps = MOE_SLOTS, 128
    pmax = -(-MOE_MAX_LEN // ps)
    lengths = rng.integers(201, MOE_MAX_LEN + 1, s).astype(np.int32)
    lengths[:3] = (1, MOE_MAX_LEN, MOE_LONG[1] + MOE_NEW)
    tab = torch.from_numpy(rng.permutation(np.arange(1, 1 + s * pmax))
                           .reshape(s, pmax).astype(np.int32)).to(dev)
    for dt in (torch.bfloat16, torch.float32):
        decode_case(torch, rows, gen, f"g3_d64_{str(dt)[6:]}",
                    lengths=lengths, tab=tab, hkv=cfg.n_kv_heads,
                    g=cfg.n_heads // cfg.n_kv_heads,
                    d=cfg.resolved_head_dim(), ps=ps, dtype=dt)
    torch.cuda.empty_cache()


def moe_read(cfg, paged: bool) -> str:
    """The decode kernel a moe step reads its cache with: the paged one on
    a paged pool, except under multi-head latent attention, whose step
    gathers its latent pages and reads the up-projected K/V with the strip
    kernel on both pools."""
    return ("decode_attention_paged" if paged and cfg.mla is None
            else "decode_attention")


def served_launches(cfg, st, sampled: bool = False) -> dict:
    """The kernels a served run launches: a prefill runs each layer's
    score rows through the softmax kernel (and its first token's sampler
    rows when ``sampled``), a step each layer's decode read (and the
    sampler's rows); a moe model's router rows go through the softmax
    kernel too, in each layer of a prefill and of a step."""
    n_l = cfg.n_layers
    router = n_l if cfg.moe is not None else 0
    extra = 1 if sampled else 0
    read = moe_read(cfg, st["paged"])
    return {"softmax": st["admitted"] * (n_l + router + extra)
            + st["steps"] * (router + extra), read: st["steps"] * n_l}


def family_serving(torch, m, params, prompts, *, slots=MOE_SLOTS,
                   max_len=MOE_MAX_LEN, new_tokens=MOE_NEW,
                   sampled=MOE_SAMPLED, gather=True, **engine_kw) -> tuple:
    """The served traffic through ``Model.serving_engine`` (granite-moe:
    32 slots, ``max_len`` 4,160, ``moe_impl="dispatch"``): paged with the
    decode step a CUDA graph (the main path), paged eager (the same
    tokens, launches and arena pages; a hybrid pool's slot-major ssm
    state bit-equal too), strip (the same tokens), with ``gather`` paged
    under ``moe_impl="gather"``; then ``temperature=0.8`` under each
    softmax algorithm (``sampled``: requests, prompt cut, new tokens),
    whose kernel the sampler (and a moe model's router) runs.
    ``engine_kw`` go to every engine (a page size).  A family whose
    prompts are bucketed (vlm) prefills at most as many shapes as there
    are buckets, any other its prompts' lengths.  Returns (the dispatch
    and gather tokens, None without ``gather``; the main path's launches
    of kernel 1 and of its decode read, the strip run's of kernel 4, the
    sampled runs' of kernels 5 and 6)."""
    from repro_torch.models import Model
    from repro_torch.serving.scheduler import Request

    cfg = m.cfg
    n_l = cfg.n_layers
    router = {"twopass_softmax_2d": n_l} if cfg.moe is not None else {}
    impl_fmt = ", moe_impl={}" if cfg.moe is not None else ""

    def reqs(cut=None, new=new_tokens, n=None):
        return [Request(rid=i, prompt=p[:cut], max_new_tokens=new)
                for i, p in enumerate(prompts[:n])]

    kw = dict(slots=slots, max_len=max_len, seed=3, **engine_kw)
    keys = ("decode_ms_per_step", "decode_tok_s", "prefill_tok_s",
            "peak_bytes", "peak_reserved_bytes", "steps", "capture_s",
            "graph_pool_bytes", "wall_s")
    runs, states = {}, {}

    def impl_of(name):
        return impl_fmt.format(name)

    def run(name, paged, fused, impl, keep=False):
        """``keep``: copy the arena after the run into ``states``."""
        if keep:
            states[name] = {}
        toks, st = serve_requests(torch, m, params, reqs(),
                                  state=states.get(name),
                                  temperature=0.0, paged=paged, fused=fused,
                                  moe_impl=impl, **kw)
        say("engine", arch=cfg.name, path=f"{'paged' if paged else 'strip'}"
            f"{impl_of(impl)}, use_kernels=True, temperature=0, "
            f"{'graph' if fused else 'eager'} step",
            prompt_lens=[len(p) for p in prompts], **st)
        check(st["fused"] is fused and st["paged"] is paged,
              f"{cfg.name} {name}: fused {st['fused']}, paged {st['paged']}")
        check(all(len(t) == new_tokens for t in toks),
              f"{cfg.name} {name}: token counts")
        shapes = len(set(map(len, prompts)))
        check(st["admitted"] == len(prompts) > slots
              and (st["prefill_shapes"] == shapes if not st["bucketed"]
                   else st["prefill_shapes"] <= min(shapes,
                                                     st["bucketed"])),
              f"{cfg.name} {name}: backfill, or a prompt was padded")
        want = served_launches(cfg, st)
        read = next(k for k in want if k != "softmax")
        c = dict(st["launches"])
        got = {"softmax": c.pop("twopass_softmax_2d"), read: c.pop(read)}
        check(got == want and not any(c.values()),
              f"{cfg.name} {name}: launches {st['launches']}, want {want}")
        if fused:
            check(st["launches_per_replay"] == {read: n_l, **router}
                  and st["replays"] == st["steps"],
                f"{cfg.name} {name}: a replay {st['launches_per_replay']}")
        runs[name] = toks, st

    run("graph", True, True, "dispatch", keep=True)
    run("eager", True, False, "dispatch", keep=True)
    (tg, sg), (te, se) = runs["graph"], runs["eager"]
    check(tg == te and sg["launches"] == se["launches"],
          f"{cfg.name}: graph tokens or launches != eager")
    check(states["graph"].pop("slots") == set(range(slots))
          == states["eager"].pop("slots"), "not every slot was used")
    # page 0 of an arena is the trash page: dead writes; a hybrid pool's
    # ssm state as each request left its slot
    def equal(k, a, b):
        if k == "ssm":
            return len(a) == len(b) and all(
                ra == rb and torch.equal(x, y) for (ra, x), (rb, y)
                in zip(a, b))
        return torch.equal(a[:, 1:], b[:, 1:])

    same = {k: bool(equal(k, v, states["eager"][k]))
            for k, v in states["graph"].items()}
    check(all(same.values()), f"{cfg.name}: graph arenas != eager: {same}")
    releases = len(states["graph"].get("ssm", ()))
    check("ssm" not in same or releases >= len(prompts),
          f"{cfg.name}: {releases} states kept at release")
    states.clear()
    gc.collect()
    torch.cuda.empty_cache()
    weights_bytes = sum(t.numel() * t.element_size()
                        for t in _leaves(params))
    extra = {}
    if cfg.moe is not None:
        experts_bytes = (n_l * cfg.moe.n_experts * 3 * cfg.d_model
                         * cfg.moe.d_expert * 2)
        extra = dict(experts_bytes=experts_bytes,
                     experts_read_ms=experts_bytes / HBM_BYTES_S * 1e3)
    say("parity", arch=cfg.name, check="paged: graph == eager tokens, "
        "launches and arena pages" + (
            ", the ssm state as each request left its slot bit-equal"
            if "ssm" in same else ""),
        equal=True, pages_equal=same, ssm_releases=releases,
        graph={k: sg.get(k) for k in keys},
        eager={k: se.get(k) for k in keys},
        eager_over_graph_ms=se["decode_ms_per_step"]
        / sg["decode_ms_per_step"], weights_bytes=weights_bytes,
        weights_read_ms=weights_bytes / HBM_BYTES_S * 1e3, **extra)
    run("strip", False, True, "dispatch")
    if gather:
        run("gather", True, True, "gather")
    ts, ss = runs["strip"]
    check(ts == tg, f"{cfg.name}: strip tokens != paged tokens")
    say("parity", arch=cfg.name, check="strip == paged tokens", equal=True,
        strip_ms_per_step=ss["decode_ms_per_step"],
        paged_ms_per_step=sg["decode_ms_per_step"])
    read = moe_read(cfg, True)
    launches = {"twopass_softmax_2d": sg["launches"]["twopass_softmax_2d"],
                read: sg["launches"][read]}
    if read != "decode_attention":
        launches["decode_attention"] = ss["launches"]["decode_attention"]

    n, cut, new = sampled
    for algo, kname in SSM_SOFTMAX:
        model = Model(dataclasses.replace(cfg, softmax_algorithm=algo),
                      m.device)
        toks, st = serve_requests(torch, model, params, reqs(cut, new, n),
                                  temperature=0.8, **kw)
        c = dict(st["launches"])
        want = served_launches(cfg, st, sampled=True)
        check(all(len(t) == new and all(0 <= x < cfg.vocab for x in t)
                  for t in toks), f"{cfg.name} {algo}: sampled tokens")
        check(c.pop(kname) == want["softmax"]
              and c.pop(read) == want[read] and not any(c.values()),
              f"{cfg.name} {algo}: launches {st['launches']}, want {want}")
        check(st["launches_per_replay"] == {
            read: n_l, kname: len(router) * n_l + 1},
            f"{cfg.name} {algo}: a replay {st['launches_per_replay']}")
        say("engine", arch=cfg.name, path=f"paged, {algo}"
            f"{impl_of('dispatch')}, use_kernels=True, temperature=0.8, "
            "graph step", **st)
        if algo != "two_pass":
            launches[kname] = st["launches"][kname]
    return tg, runs["gather"][0] if gather else None, launches


def moe_forced(torch, m, params, prompts, toks, impl):
    """Logits [n, MOE_NEW, V] of each request fed its served tokens, its
    prefill and the steps under ``impl``: batch-1 prefills adopted into a
    strip pool of n slots, then ``decode_step_ragged`` over all of them."""
    from repro_torch.serving import engine, kv_cache

    cfg, v = m.cfg, m.cfg.vocab
    n = len(toks)
    pool = kv_cache.init_slot_pool(cfg, n, MOE_MAX_LEN, device="cuda")
    first = []
    for i in range(n):
        lg, cache = m.prefill(params, torch.tensor([prompts[i]],
                                                   device="cuda"),
                              moe_impl=impl)
        first.append(lg[0, :v].float())
        kv_cache.adopt_slot(pool, cache, i, len(prompts[i]))
        del cache
    out = [torch.stack(first)]
    forced = torch.tensor([t[:MOE_NEW - 1] for t in toks], device="cuda")
    for j in range(MOE_NEW - 1):
        lg, _ = engine.decode_step_ragged(params, pool, forced[:, j],
                                          cfg=cfg, moe_impl=impl)
        out.append(lg[:, :v].float())
    del pool
    torch.cuda.empty_cache()
    return torch.stack(out, 1)


def moe_gather_margin(torch, m, params, prompts, toks_d, toks_g) -> None:
    """``moe_impl="gather"`` against ``"dispatch"``: the same capacity
    and drops, the combine summed in another order.  The first MOE_FORCED
    requests' dispatch tokens are fed back through both impls; the two
    argmaxes must agree at every position whose dispatch top-2 margin
    exceeds twice the largest logit difference measured between them, and
    each request's served gather tokens may leave its dispatch tokens only
    at a position the rule does not decide."""
    n = MOE_FORCED
    ld = moe_forced(torch, m, params, prompts, toks_d[:n], "dispatch")
    lg = moe_forced(torch, m, params, prompts, toks_g[:n], "gather")
    # gather's logits along the dispatch tokens: the same contexts up to
    # each request's first divergence
    same_ctx = torch.tensor([[all(a == b for a, b in zip(x[:j], y[:j]))
                              for j in range(MOE_NEW)]
                             for x, y in zip(toks_d[:n], toks_g[:n])],
                            device="cuda")
    abs_err = float((ld - lg).abs().amax(-1)[same_ctx].max())
    top2 = ld.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    decided = (margin > 2 * abs_err) & same_ctx
    same = ld.argmax(-1) == lg.argmax(-1)
    served_d = torch.tensor(toks_d[:n], device="cuda")
    served_g = torch.tensor(toks_g[:n], device="cuda")
    first_diff = [next((j for j in range(MOE_NEW) if a[j] != b[j]), None)
                  for a, b in zip(toks_d[:n], toks_g[:n])]
    bad = [(i, j) for i, j in enumerate(first_diff)
           if j is not None and bool(decided[i, j])]
    all_equal = sum(a == b for x, y in zip(toks_d, toks_g)
                    for a, b in zip(x, y))
    say("moe_gather_vs_dispatch", arch=m.cfg.name, requests=n,
        positions=n * MOE_NEW, logits_max_abs_err=abs_err,
        logits_max_err_over_max_logit=abs_err / float(ld.abs().max()),
        tokens_decided=int(decided.sum()),
        tokens_compared=int(same_ctx.sum()),
        argmax_equal=int((same & same_ctx).sum()),
        served_dispatch_equal_to_forced=int(
            (served_d == ld.argmax(-1)).sum()),
        served_gather_equal_to_forced=int(
            ((served_g == lg.argmax(-1)) & same_ctx).sum()),
        first_divergence=first_diff,
        margins_left_out=margin[same_ctx & ~decided].tolist()[:64],
        served_tokens_equal=all_equal,
        served_tokens=sum(len(x) for x in toks_d),
        rule="== where the dispatch top-2 margin exceeds 2 x the largest "
             "logit difference between the impls")
    check(bool(same[decided].all()), "moe gather != dispatch at a top-2 "
          f"margin above 2 x {abs_err}")
    check(bool((served_d == ld.argmax(-1))[decided].all()),
          "moe: served dispatch tokens != their forced argmax")
    check(not bad, f"moe: gather left dispatch at decided positions {bad}")
    del ld, lg
    torch.cuda.empty_cache()


def moe_step_alone(torch, m, params) -> None:
    """The MoE layers of one decode step alone (32 slots, the model's layers'
    ``moe_apply`` under each impl), captured in a CUDA graph, against
    the bound of reading every expert's weights once."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer

    cfg = m.cfg
    x = torch.randn((MOE_SLOTS, 1, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).to(torch.bfloat16)
    mlp = [layer(params["blocks"]["mlp"], i) for i in range(cfg.n_layers)]
    experts = sum(t.numel() * t.element_size() for p in mlp
                  for k, t in p.items() if k != "router")
    out = {}
    for impl in ("dispatch", "gather"):
        out[impl] = graph_ms(torch, lambda: [
            moe.moe_apply(p, x, cfg, impl=impl) for p in mlp], iters=10)
    say("moe_step_alone", arch=cfg.name, slots=MOE_SLOTS,
        layers=cfg.n_layers, ms=out, experts_bytes=experts,
        bound_ms=experts / HBM_BYTES_S * 1e3, bound_by="bytes")


def _host_ranges(*targets):
    """While on: each call of ``module.attr`` for every ``(module, attr,
    name)`` of ``targets`` runs inside a profiler range ``name``, so an
    eager trace can group the kernels launched under it (a graph replay's
    kernels have no host range)."""
    from torch.profiler import record_function

    def wrap(fn, name):
        def ranged(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return ranged

    @contextlib.contextmanager
    def on():
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
        for (mod, attr, fn), (_, _, name) in zip(saved, targets):
            setattr(mod, attr, wrap(fn, name))
        try:
            yield
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    return on()



def moe_f32_cut(torch, m, prompts, cut=MOE_F32, slots=MOE_SLOTS,
                max_len=MOE_MAX_LEN, tag="moe", **engine_kw):
    """Full width, depth cut to ``cut``'s layers, float32 activations and
    weights: the engine's greedy tokens (paged, graph step, dispatch) of
    ``cut``'s requests and new tokens ``==`` the batch-1 lockstep
    ``Model.generate``."""
    from repro_torch.models import Model
    from repro_torch.serving.scheduler import Request

    layers, n, new = cut
    cfg = dataclasses.replace(m.cfg, n_layers=layers, dtype="float32")
    model = Model(cfg, m.device)
    params = model.init(seed=1, dtype=torch.float32)
    sub = [Request(rid=i, prompt=p, max_new_tokens=new)
           for i, p in enumerate(prompts[:n])]
    toks, st = serve_requests(torch, model, params, sub, temperature=0.0,
                              slots=slots, max_len=max_len, seed=3,
                              **engine_kw)
    want = [model.generate(
        params, torch.tensor([r.prompt], device="cuda"), steps=new - 1,
        temperature=0.0, max_len=len(r.prompt) + new)[0].tolist()
        for r in sub]
    equal = sum(a == b for x, y in zip(toks, want) for a, b in zip(x, y))
    say(f"{tag}_lockstep", arch=cfg.name, dtype="float32", n_layers=layers,
        requests=n, new_tokens=new, tokens_equal=equal,
        tokens_compared=n * new, fused=st["fused"], rule="==")
    check(toks == want, f"{cfg.name} float32: engine tokens != lockstep "
          "tokens")
    return model, params


def moe_phase(torch, rows) -> dict:
    """Phase 11; returns the main path's launches of kernels 1 and 3, the
    strip run's of kernel 4 and the sampled runs' of kernels 5 and 6."""
    from repro_torch.models import build_model, moe

    rng = np.random.default_rng(MOE_SEED)
    m = build_model(MOE_ARCH, use_kernels=True, n_layers=MOE_LAYERS)
    cfg = m.cfg
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        say("moe_part", part=name, seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()

    moe_kernel_checks(torch, rows, rng, cfg)
    part("kernel checks")
    t0 = time.perf_counter()
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    say("moe_config", arch=MOE_ARCH, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim(), n_experts=cfg.moe.n_experts,
        top_k=cfg.moe.top_k, d_expert=cfg.moe.d_expert,
        n_shared=cfg.moe.n_shared, vocab=cfg.vocab,
        padded_vocab=cfg.padded_vocab(), weights_s=time.perf_counter() - t0,
        weights_bytes=sum(t.numel() * t.element_size()
                          for t in _leaves(params)),
        router_dtype=str(params["blocks"]["mlp"]["router"]["w"].dtype),
        param_count=cfg.param_count(), slots=MOE_SLOTS,
        max_len=MOE_MAX_LEN)
    n, lo, hi = MOE_PROMPTS
    plens = [int(x) for x in rng.integers(lo, hi, n)] + list(MOE_LONG)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, k))
               for k in plens]
    toks_d, toks_g, launches = family_serving(torch, m, params, prompts)
    part("serving")
    moe_gather_margin(torch, m, params, prompts, toks_d, toks_g)
    part("gather vs dispatch")
    order = np.argsort(plens, kind="stable")
    swa_prefill_parity(torch, m, params, [
        prompts[i] for i in (order[0], order[len(order) // 2],
                             plens.index(MOE_LONG[0]))], MOE_MAX_LEN)
    moe_step_alone(torch, m, params)
    part("prefill parity, the MoE alone")
    cut, new_graph, new_eager = MOE_TRACE
    trace = [p[:cut] for p in prompts]
    decode_trace(torch, m, params, trace, fused=True, slots=MOE_SLOTS,
                 max_len=MOE_MAX_LEN, new=new_graph)
    # the eager burst is host-bound and its trace large: fewer steps
    with _host_ranges((moe, "moe_apply", "moe")):
        decode_trace(torch, m, params, trace, fused=False, slots=MOE_SLOTS,
                     max_len=MOE_MAX_LEN, new=new_eager, ranges=("moe",))
    part("decode traces")
    moe_f32_cut(torch, m, prompts)
    part("float32 cut")
    del m, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 12: multi-head latent attention, deepseek-v2-lite-16b at full width.
# ---------------------------------------------------------------------------
MLA_ARCH = "deepseek-v2-lite-16b"   # 27 layers, d 2048, 16 heads: q / k of
                                    # 128 nope + 64 rope, v 128; latent 512;
                                    # 64 experts top 6 + 2 shared of 1,408
MLA_SEED = 29
MLA_LAYERS = 7                      # depth cut from 27, so that the whole
                                    # script keeps inside its time limit
MLA_SLOTS = 16
MLA_PROMPTS = (40, 200, 2049)       # requests, prompt lengths [lo, hi)
MLA_LONG = 4096                     # and one long document
MLA_NEW = 64
MLA_MAX_LEN = MLA_LONG + MLA_NEW    # 4,160
MLA_PAGE = 64                       # 65 pages a slot: a paged slot gathers
                                    # the strip's 4,160 positions exactly
MLA_SAMPLED = (16, 128, 8)          # temperature 0.8: requests, prompt, new
MLA_TRACE = (1024, 16, 6)           # the traces: prompt cut, new tokens
                                    # graph and eager (a burst of 15 / 5)
MLA_F32 = (2, 4, 16)                # float32 cut: layers, requests, new
# (B, H, Hkv, Sq, Skv, D, causal, window, dtype, Dv): kernels 12-13 at the
# no-cache forward's shape of a 2,048-token prompt (16 heads, D 128 + 64,
# Dv 128) and at reduced deepseek's (D 16 + 8, Dv 16; 37 rows, a ragged
# edge), each in both dtypes
MLA_FLASH = {
    f"mla_{name}_{short}": (b, h, h, s, s, d, True, None, dts, dv)
    for name, (b, h, s, d, dv) in (("d192_dv128", (1, 16, 2048, 192, 128)),
                                   ("reduced_d24_dv16", (2, 4, 37, 24, 16)))
    for dts, short in (("bfloat16", "bf16"), ("float32", "f32"))}
MLA_EXPAND = "mla up-projection and expansion"     # the eager trace's ranges
MLA_EXPERTS = "experts (moe)"


def mla_decode_check(torch, rows, rng, cfg) -> None:
    """Kernel 4 at G 1, D 192 / Dv 128 (bf16) as the MLA step calls it:
    each head's key the up-projected nope part and the shared rope key,
    read through transposed views of [16, 4160, 16, 192] and of the value
    half of [16, 4160, 16, 256], over 16 slots of 1-4,160 positions;
    through the op with the config's policy against its plain version
    (the kernel phase's bf16 tolerance), the same bits twice; timed by
    graph replay beside ``scaled_dot_product_attention`` over the same
    views and the bound of the visible positions' bytes."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    m = cfg.mla
    s, t, h, nd = MLA_SLOTS, MLA_MAX_LEN, cfg.n_heads, m.qk_nope_head_dim
    d, dv = nd + m.qk_rope_head_dim, m.v_head_dim
    gen = torch.Generator(device="cuda").manual_seed(MLA_SEED)
    lengths = rng.integers(1, t + 1, s).astype(np.int32)
    lengths[:2] = (1, t)
    lens = torch.from_numpy(lengths).cuda()
    bf = torch.bfloat16
    kf = torch.randn((s, t, h, d), device="cuda", generator=gen).to(bf)
    kv = torch.randn((s, t, h, nd + dv), device="cuda", generator=gen).to(bf)
    q = torch.randn((s, h, 1, d), device="cuda", generator=gen).to(bf)
    k, v = kf.transpose(1, 2), kv[..., nd:].transpose(1, 2)
    kw = dict(scale=d ** -0.5, policy=cfg.softmax_policy())

    def fn():
        return ops.decode_attention(q, k, v, lens, **kw)

    def plain():
        return ops.decode_attention(q, k, v, lens, use_kernel=False, **kw)

    got = fn()
    torch.cuda.synchronize()
    r = held(got, plain(), dict(atol=1e-5, rtol=1e-2),
             "decode_attention mla_g1_d192_dv128")
    check(got.shape == (s, h, 1, dv) and torch.equal(fn(), got),
          "decode_attention mla: shape, or bits differ between two runs")
    say("kernel_check", kernel="decode_attention", case="mla_g1_d192_dv128",
        same_bits_twice=True, **r)
    mask = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    visible = int(lengths.sum())
    b_ms, b_by = bound(visible * h * (d + dv) * 2 + s * h * (d + dv) * 2
                       + s * 4, visible * h * (2 * d + 2 * dv + 20))
    row = rows.setdefault("decode_attention", {})["mla_g1_d192_dv128"] = \
        dict(ms=graph_ms(torch, fn), eager_ms=cuda_ms(torch, fn),
             plain_ms=cuda_ms(torch, plain, 5),
             library_ms=graph_ms(
                 torch, lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=mask[:, None, None, :],
                     scale=kw["scale"])),
             bound_ms=b_ms, bound_by=b_by, max_abs_err=r["max_abs_err"],
             shape=dict(q=list(q.shape), k=list(k.shape), v=list(v.shape),
                        lengths=lengths.tolist()))
    say("kernel_time", kernel="decode_attention", case="mla_g1_d192_dv128",
        bound_us=b_ms * 1e3, **row)
    del kf, kv, q, k, v, got
    torch.cuda.empty_cache()


def mla_kernel_checks(torch, rows, rng, cfg) -> None:
    """Kernels 12-13 at Dv != D (:data:`MLA_FLASH`: checked and timed),
    kernel 4 at G 1, D 192 / Dv 128 (:func:`mla_decode_check`), kernels
    1, 5 and 6 on the router's rows [2048, 64] / [16, 64] and the
    sampler's [16, 102400] (:func:`router_rows_checks`)."""
    for case, shape in MLA_FLASH.items():
        c = flash_check(torch, case, shape)
        flash_times(torch, rows, case, c,
                    dq_dkv=shape[5] == 192 and shape[8] == "bfloat16")
        del c
        torch.cuda.empty_cache()
    mla_decode_check(torch, rows, rng, cfg)
    gen = torch.Generator(device="cuda").manual_seed(MLA_SEED)
    router_rows_checks(torch, rows, gen, cfg, MLA_SLOTS, "mla")
    torch.cuda.empty_cache()


def mla_forward_parity(torch, m, params, prompts) -> int:
    """The no-cache forward (``Model.forward``, the flash route: kernel 12
    at D 192, Dv 128 in every layer) with kernels against the model built
    with ``use_kernels=False``, bf16, at each prompt's last position.  Any
    rounding difference can flip one of a token's top-6 experts in some
    layer, so the logits are held by the margin rule of the bf16 ring and
    the gather impl: the argmax ``==`` wherever the plain top-2 margin
    exceeds twice the largest logit difference.  The distance is printed
    beside those of two routes that differ from the plain forward in
    rounding only: the plain prefill (``full_attention``; the chunked
    form at 4,096 tokens) and the served prefill with kernels (kernel 1).
    Kernel 12's own agreement is held without bf16 by
    :func:`mla_f32_forward` and on these activations by
    :func:`mla_layer_parity`.  Returns kernel 12's launches (one a layer a
    prompt); the plain runs launch nothing."""
    import repro_torch.kernels as K
    from repro_torch.models import Model, transformer

    cfg, v = m.cfg, m.cfg.vocab
    plain = Model(dataclasses.replace(cfg, use_kernels=False), m.device)

    def logits(model, route):
        out = []
        for p in prompts:
            tok = torch.tensor([p], device="cuda")
            if route == "forward":
                h = model.forward(params, tok)
                lg = transformer.lm_logits(params, h[:, -1], cfg=cfg)
            else:
                lg, _ = model.prefill(params, tok)
            out.append(lg[:, :v].float())
            del tok, lg
            torch.cuda.empty_cache()
        return torch.cat(out)

    K.reset_launch_counts()
    got = logits(m, "forward")
    flash = K.launch_counts()["flash_attention_fwd_gqa"]
    check(flash == len(prompts) * cfg.n_layers,
          f"{cfg.name}: the forward launched kernel 12 {flash} times")
    K.reset_launch_counts()
    want = logits(plain, "forward")
    plain_prefill = logits(plain, "prefill")
    check(sum(K.launch_counts().values()) == 0,
          f"{cfg.name}: use_kernels=False launched a kernel")
    served = logits(m, "prefill")

    def over(a):
        return ((a - want).abs().amax(1) / want.abs().amax(1)).tolist()

    err = (got - want).abs().amax(1)
    top2 = want.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * err
    same = got.argmax(1) == want.argmax(1)
    say("parity", arch=cfg.name, check="bf16 no-cache forward logits at the "
        "last position, use_kernels=True (flash, D 192 / Dv 128) vs False",
        prompt_lens=[len(p) for p in prompts], flash_launches=flash,
        max_err_over_max_logit=over(got),
        served_prefill_kernels_vs_plain_forward=over(served),
        plain_prefill_vs_plain_forward=over(plain_prefill),
        top2_margin=(top2[:, 0] - top2[:, 1]).tolist(),
        max_abs_err=err.tolist(), decided=decided.tolist(),
        argmax_equal=same.tolist(),
        rule="argmax == where the plain top-2 margin exceeds 2 x the "
             "largest logit difference")
    check(bool(same[decided].all()),
          f"{cfg.name}: forward argmax kernels vs plain at a decided prompt")
    return flash


def mla_layer_parity(torch, m, params, prompts) -> None:
    """Kernel 12 on the model's own bf16 activations, without the drift
    the layers add: the plain forward's input to each of the model's layers
    goes through both attentions (``mla_attention`` with kernels, the
    flash route; without, ``attention_core``'s plain route), and the
    attention outputs before ``wo`` are held within one bf16 step of the
    value (rtol 2^-7: both round a float32 result once) plus 1e-4 of the
    layer's largest value (the float32 sums in another order)."""
    from repro_torch.models import attention, layers, transformer

    cfg = m.cfg
    plain_cfg = dataclasses.replace(cfg, use_kernels=False)
    core, outs = attention.attention_core, []

    def keep(*a, **kw):
        outs.append(core(*a, **kw))
        return outs[-1]

    worst, layers_held = 0.0, 0
    attention.attention_core = keep
    try:
        for p in prompts:
            tok = torch.tensor([p], device="cuda")
            x = layers.embed(params["embed"], tok,
                             transformer.torch_dtype(cfg.dtype))
            cos, sin = transformer._cos_sin(
                cfg, torch.arange(len(p), device="cuda"))
            for i in range(cfg.n_layers):
                lp = transformer.layer(params["blocks"], i)
                h = layers.rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
                outs.clear()
                for c in (cfg, plain_cfg):
                    attention.mla_attention(lp["attn"], h, cos, sin, cfg=c)
                got, want = outs
                r = held(got, want, dict(
                    atol=1e-4 * float(want.abs().max()), rtol=2.0 ** -7),
                    f"{cfg.name} layer {i} attention, kernels vs plain")
                worst = max(worst, r["worst_err_over_limit"])
                layers_held += 1
                x, _ = transformer.block_apply(lp, x, cos, sin,
                                               cfg=plain_cfg)
            del tok, x, h
            outs.clear()
            torch.cuda.empty_cache()
    finally:
        attention.attention_core = core
    say("parity", arch=cfg.name, check="bf16 attention outputs a layer on "
        "the plain forward's activations, flash (D 192 / Dv 128) vs plain",
        prompt_lens=[len(p) for p in prompts], layers_held=layers_held,
        worst_err_over_limit=worst,
        tol="rtol 2^-7 (one bf16 step) + atol 1e-4 of the layer's largest "
            "value")


MLA_F32_TOL = 1e-4       # float32 forward, kernels vs plain: sum orders


def mla_f32_forward(torch, m, prompts) -> None:
    """Kernel 12 in the model without bf16 roundings: full width, depth
    cut to MLA_F32's layers, float32 weights and activations; the
    no-cache forward's last-position logits with kernels (the FFMA flash
    kernels at D 192 / Dv 128) against ``use_kernels=False`` within
    MLA_F32_TOL of the largest logit (the two differ in sum order
    only)."""
    from repro_torch.models import Model, transformer

    cfg = dataclasses.replace(m.cfg, n_layers=MLA_F32[0], dtype="float32")
    model = Model(cfg, m.device)
    params = model.init(seed=1, dtype=torch.float32)
    plain = Model(dataclasses.replace(cfg, use_kernels=False), m.device)
    out = []
    for mod in (model, plain):
        lg = [transformer.lm_logits(
            params, mod.forward(params, torch.tensor([p], device="cuda"))
            [:, -1], cfg=cfg)[:, :cfg.vocab] for p in prompts]
        out.append(torch.cat(lg))
    got, want = out
    errs = ((got - want).abs().amax(1) / want.abs().amax(1)).tolist()
    say("parity", arch=cfg.name, check="float32 no-cache forward logits, "
        "use_kernels=True vs False", n_layers=cfg.n_layers,
        prompt_lens=[len(p) for p in prompts], per_prompt=errs,
        argmax_equal=int((got.argmax(1) == want.argmax(1)).sum()),
        tol=f"{MLA_F32_TOL} of the largest logit")
    check(max(errs) <= MLA_F32_TOL,
          f"{cfg.name} float32 forward kernels vs plain: {errs}")
    del params, out, got, want
    torch.cuda.empty_cache()


def mla_phase(torch, rows) -> dict:
    """Phase 12: deepseek-v2-lite-16b at full width, MLA_LAYERS deep, bf16
    weights seeded on the card (router float32): the kernel checks, the
    served traffic through :func:`family_serving` (16 slots, ``max_len``
    4,160 in pages of 64, 40 requests of 200-2,048 tokens and one of
    4,096, 64 new tokens each, no gather run), the no-cache forward's
    logits with kernels against without, a graph and an eager decode
    trace (the eager one grouping the up-projection and expansion and the
    experts by host range) and a 2-layer float32 cut.  Returns the main
    path's launches of kernels 1 and 4, the sampled runs' of 5 and 6 and
    the forward's of 12."""
    from repro_torch.models import attention, build_model, moe
    from repro_torch.serving import kv_cache

    rng = np.random.default_rng(MLA_SEED)
    m = build_model(MLA_ARCH, use_kernels=True, n_layers=MLA_LAYERS)
    cfg = m.cfg
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        say("mla_part", part=name, seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()

    mla_kernel_checks(torch, rows, rng, cfg)
    part("kernel checks")
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    mc = cfg.mla
    say("mla_config", arch=MLA_ARCH, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        kv_lora_rank=mc.kv_lora_rank, qk_nope_head_dim=mc.qk_nope_head_dim,
        qk_rope_head_dim=mc.qk_rope_head_dim, v_head_dim=mc.v_head_dim,
        n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        d_expert=cfg.moe.d_expert, n_shared=cfg.moe.n_shared,
        vocab=cfg.vocab, padded_vocab=cfg.padded_vocab(),
        weights_s=time.perf_counter() - t0,
        weights_bytes=sum(t.numel() * t.element_size()
                          for t in _leaves(params)),
        router_dtype=str(params["blocks"]["mlp"]["router"]["w"].dtype),
        param_count=cfg.param_count(), slots=MLA_SLOTS,
        max_len=MLA_MAX_LEN, page_size=MLA_PAGE,
        latent_bytes_a_token=kv_cache.cache_bytes(cfg, 1, 1),
        paged_pool_bytes=kv_cache.paged_pool_bytes(
            cfg, MLA_SLOTS, MLA_MAX_LEN, page_size=MLA_PAGE))
    part("weights")
    n, lo, hi = MLA_PROMPTS
    plens = [int(x) for x in rng.integers(lo, hi, n)] + [MLA_LONG]
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, k))
               for k in plens]
    _, _, launches = family_serving(
        torch, m, params, prompts, slots=MLA_SLOTS, max_len=MLA_MAX_LEN,
        new_tokens=MLA_NEW, sampled=MLA_SAMPLED, gather=False,
        page_size=MLA_PAGE)
    part("serving")
    n, head, lo, hi, new = MLA_PREFIX
    pre = prefix_serving(
        torch, m, params, shared_prompts(np.random.default_rng(MLA_SEED + 100),
                                         cfg.vocab, head, n, lo, hi),
        slots=MLA_SLOTS, max_len=MLA_MAX_LEN, new=new,
        read=moe_read(cfg, True), tag="mla prefix", page_size=MLA_PAGE,
        moe_impl="dense")
    for k, v in pre["launches"].items():
        launches[k] += v
    part("prefix sharing")
    order = np.argsort(plens, kind="stable")
    three = [prompts[i] for i in (order[0], order[len(order) // 2],
                                  plens.index(MLA_LONG))]
    mla_f32_forward(torch, m, three)
    mla_layer_parity(torch, m, params, three)
    launches["flash_attention_fwd_gqa"] = mla_forward_parity(
        torch, m, params, three)
    part("forward parity")
    cut, new_graph, new_eager = MLA_TRACE
    trace = [p[:cut] for p in prompts]
    kw = dict(slots=MLA_SLOTS, max_len=MLA_MAX_LEN, page_size=MLA_PAGE)
    decode_trace(torch, m, params, trace, fused=True, new=new_graph, **kw)
    # the eager burst is host-bound and its trace large: fewer steps
    with _host_ranges((attention, "_expand_latent", MLA_EXPAND),
                      (moe, "moe_apply", MLA_EXPERTS)):
        decode_trace(torch, m, params, trace, fused=False, new=new_eager,
                     ranges=(MLA_EXPAND, MLA_EXPERTS), **kw)
    part("decode traces")
    moe_f32_cut(torch, m, prompts, cut=MLA_F32, slots=MLA_SLOTS,
                max_len=MLA_MAX_LEN, page_size=MLA_PAGE)
    part("float32 cut")
    del m, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the vlm family, qwen2-vl-7b, at full width and depth.
# ---------------------------------------------------------------------------
VLM_ARCH = "qwen2-vl-7b"     # 28 layers, d 3584, 28 query heads over 4 KV
                             # heads of 128 (G 7), d_ff 18944, vocab 152064,
                             # M-RoPE sections (16, 24, 24), 256 patches
VLM_SEED = 30
VLM_SLOTS = 16
VLM_PROMPTS = (40, 100, 2001)       # requests, prompt lengths [lo, hi):
                                    # both sides of the 256-token grid
VLM_NEW = 64
VLM_MAX_LEN = 2176                  # 17 pages of 128
VLM_SAMPLED = (16, 128, 8)          # temperature 0.8: requests, prompt, new
VLM_TRACE = (1024, 16, 6)           # the traces: prompt cut, new tokens
VLM_F32 = (2, 4, 16)                # float32 cut: layers, requests, new
VLM_LOCKSTEP = (8, 512, 32)         # the CLI's path: batch, text tokens
                                    # after the 256 patches, steps
# kernel 12 at the lockstep batch's no-cache forward (256 + 512 positions)
VLM_FLASH = {"vlm_patches_768_bf16": (1, 28, 4, 768, 768, 128, True, None,
                                      "bfloat16")}


def decode_family_checks(torch, rows, rng, tag, *, slots, max_len, hkv, g,
                         d, window=None, ps=128) -> None:
    """Kernels 3 and 4 at a served family's decode shape, bf16 and
    float32 (:func:`decode_case`), over ``slots`` slots of 1 to
    ``max_len`` positions (the first one, the second ``max_len``)."""
    gen = torch.Generator(device="cuda").manual_seed(max_len + g)
    pmax = -(-max_len // ps)
    lengths = rng.integers(1, max_len + 1, slots).astype(np.int32)
    lengths[:2] = (1, max_len)
    tab = torch.from_numpy(rng.permutation(np.arange(
        1, 1 + slots * pmax)).reshape(slots, pmax).astype(np.int32)).cuda()
    for dt, short in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        decode_case(torch, rows, gen, f"{tag}_{short}", lengths=lengths,
                    tab=tab, hkv=hkv, g=g, d=d, window=window, ps=ps,
                    dtype=dt)
    torch.cuda.empty_cache()


def three_pass_sampler_rows(torch, rows, cfg, slots, tag) -> None:
    """Kernels 5 and 6 on a served model's sampler rows [slots, vocab] at
    temperature 0.8 (:func:`sampler_rows_check`)."""
    gen = torch.Generator(device="cuda").manual_seed(cfg.vocab)
    x = torch.randn((slots, cfg.vocab), device="cuda", generator=gen) * 8
    for _, kname in SSM_SOFTMAX[1:]:
        sampler_rows_check(torch, rows, kname, x / 0.8,
                           f"{tag}_sampler_{slots}x{cfg.vocab}")


def vlm_lockstep(torch, m, params, rng) -> int:
    """The CLI's vlm path at full width: a lockstep batch of
    VLM_LOCKSTEP's prompts, each its 256 seeded patches then its text,
    through ``Model.generate`` (its phase times from
    ``engine.generate_timed``); the prefill logits with patches against
    ``use_kernels=False`` (within LOGIT_TOL of the largest logit); and the
    no-cache ``Model.forward`` with patches, kernel 12 in every layer,
    against the plain route by the margin rule (argmax ``==`` where the
    plain top-2 margin exceeds twice the largest logit difference; kernel
    12's own agreement is held in float32 by :func:`vlm_f32_cut`).
    Returns kernel 12's launches."""
    import repro_torch.kernels as K
    from repro_torch.models import Model, transformer
    from repro_torch.serving import engine

    cfg, v = m.cfg, m.cfg.vocab
    b, s, steps = VLM_LOCKSTEP
    prompt = torch.from_numpy(rng.integers(0, v, (b, s))).cuda()
    gen = torch.Generator(device="cuda").manual_seed(VLM_SEED)
    patches = torch.randn((b, cfg.n_patches, cfg.d_model), device="cuda",
                          generator=gen)
    K.reset_launch_counts()
    toks, st = engine.generate_timed(params, prompt, cfg=cfg, steps=steps,
                                     temperature=0.0, patches=patches)
    torch.cuda.synchronize()
    c = K.launch_counts()
    check(tuple(toks.shape) == (b, steps + 1)
          and bool(((toks >= 0) & (toks < v)).all()),
          f"{cfg.name} lockstep with patches: tokens")
    # a prefill layer's scores and a step layer's over the lockstep cache
    check(c["twopass_softmax_2d"] == cfg.n_layers * (1 + steps)
          and sum(c.values()) == c["twopass_softmax_2d"],
          f"{cfg.name} lockstep with patches: launches {c}")
    again = m.generate(params, prompt, steps=steps, temperature=0.0,
                       patches=patches)
    check(torch.equal(again, toks), f"{cfg.name}: Model.generate != "
          "generate_timed")
    say("vlm_lockstep", arch=cfg.name, batch=b, patches=cfg.n_patches,
        text_tokens=s, steps=steps, launches=c,
        prefill_ms=st["prefill_s"] * 1e3,
        decode_ms_per_step=st["decode_s"] / steps * 1e3,
        decode_tok_s=st["decode_tokens"] / st["decode_s"],
        first_token=toks[:, 0].tolist())
    del again
    plain = Model(dataclasses.replace(cfg, use_kernels=False), m.device)
    got, _ = m.prefill(params, prompt, patches=patches)
    want, _ = plain.prefill(params, prompt, patches=patches)
    got, want = got[:, :v].float(), want[:, :v].float()
    worst = float(((got - want).abs().amax(1) / want.abs().amax(1)).max())
    check(worst <= LOGIT_TOL,
          f"{cfg.name}: prefill logits with patches, kernels vs plain: "
          f"{worst}")
    say("parity", arch=cfg.name, check="prefill logits with patches, "
        "use_kernels=True vs False", batch=b, positions=cfg.n_patches + s,
        prefill_logits_max_err_over_max_logit=worst,
        argmax_equal=int((got.argmax(1) == want.argmax(1)).sum()),
        tol=f"{LOGIT_TOL} of the largest logit, as the engine phase")
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    out = []
    for model in (m, plain):
        h = model.forward(params, prompt, patches=patches)
        out.append(transformer.lm_logits(params, h[:, -1], cfg=cfg)
                   [:, :v].float())
        del h
        torch.cuda.empty_cache()
    flash = K.launch_counts()["flash_attention_fwd_gqa"]
    check(flash == cfg.n_layers and sum(K.launch_counts().values())
          == flash, f"{cfg.name}: the forward launched kernel 12 {flash} "
          "times")
    got, want = out
    err = (got - want).abs().amax(1)
    top2 = want.topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * err
    same = got.argmax(1) == want.argmax(1)
    say("parity", arch=cfg.name, check="bf16 no-cache forward logits with "
        "patches at the last position, use_kernels=True (flash) vs False",
        batch=b, positions=cfg.n_patches + s, flash_launches=flash,
        max_err_over_max_logit=(err / want.abs().amax(1)).tolist(),
        top2_margin=(top2[:, 0] - top2[:, 1]).tolist(),
        decided=decided.tolist(), argmax_equal=same.tolist(),
        rule="argmax == where the plain top-2 margin exceeds 2 x the "
             "largest logit difference")
    check(bool(same[decided].all()),
          f"{cfg.name}: forward argmax kernels vs plain at a decided row")
    return flash


def vlm_f32_cut(torch, m, prompts, rng) -> int:
    """Full width, depth cut to VLM_F32's layers, float32: the engine's
    greedy tokens ``==`` the batch-1 lockstep (:func:`moe_f32_cut`); then
    with patches, ``Model.generate`` with kernels ``==`` without, and the
    no-cache forward's logits with kernel 12 within 1e-4 of the largest
    of the plain route's (sum order only).  Returns kernel 12's
    launches."""
    import repro_torch.kernels as K
    from repro_torch.models import Model, transformer

    model, params = moe_f32_cut(torch, m, prompts, cut=VLM_F32,
                                slots=VLM_SLOTS, max_len=VLM_MAX_LEN,
                                tag="vlm")
    cfg = model.cfg
    plain = Model(dataclasses.replace(cfg, use_kernels=False), m.device)
    b, s = 2, 300
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).cuda()
    gen = torch.Generator(device="cuda").manual_seed(VLM_SEED + 1)
    patches = torch.randn((b, cfg.n_patches, cfg.d_model), device="cuda",
                          generator=gen)
    toks = [mod.generate(params, prompt, steps=16, temperature=0.0,
                         patches=patches) for mod in (model, plain)]
    K.reset_launch_counts()
    lg = [transformer.lm_logits(params, mod.forward(
        params, prompt, patches=patches)[:, -1], cfg=cfg)[:, :cfg.vocab]
        for mod in (model, plain)]
    flash = K.launch_counts()["flash_attention_fwd_gqa"]
    worst = float(((lg[0] - lg[1]).abs().amax(1)
                   / lg[1].abs().amax(1)).max())
    say("vlm_lockstep", arch=cfg.name, dtype="float32", n_layers=VLM_F32[0],
        check="with patches: generate kernels == plain; forward logits "
        "kernel 12 vs plain", batch=b, positions=cfg.n_patches + s,
        tokens_equal=bool(torch.equal(*toks)), flash_launches=flash,
        forward_max_err_over_max_logit=worst, tol=MLA_F32_TOL)
    check(torch.equal(*toks), f"{cfg.name} float32: generate with patches "
          "kernels != plain")
    check(flash == VLM_F32[0] and worst <= MLA_F32_TOL,
          f"{cfg.name} float32 forward with patches: {flash} launches, "
          f"{worst}")
    del model, params, lg, toks
    torch.cuda.empty_cache()
    return flash


def vlm_phase(torch, rows) -> dict:
    """Phase 13: qwen2-vl-7b at full width and depth, bf16 weights seeded
    on the card.  Kernels 3-4 at G 7, D 128, kernel 12 at the patch
    forward's shape, kernel 1 on its prefill score rows [28 S, S] and
    sampler rows and kernels 5-6 on the sampler rows; then text requests
    through :func:`family_serving` (16 slots, ``max_len`` 2,176, 40
    requests of 100-2,000 tokens, 64 new),
    prefill logits against ``use_kernels=False``, a graph and an eager
    decode trace, the CLI's lockstep path with patches
    (:func:`vlm_lockstep`), a 2-layer float32 cut (:func:`vlm_f32_cut`)
    and the serving CLI.  Returns the main path's launches of kernels 1,
    3 and 4, the sampled runs' of 5 and 6 and the forwards' of 12."""
    from repro_torch.models import build_model
    from repro_torch.serving import kv_cache

    rng = np.random.default_rng(VLM_SEED)
    m = build_model(VLM_ARCH, use_kernels=True)
    cfg = m.cfg
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        say("vlm_part", part=name, seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()

    n, lo, hi = VLM_PROMPTS
    plens = [int(x) for x in rng.integers(lo, hi, n)]
    for case, shape in VLM_FLASH.items():
        c = flash_check(torch, case, shape)
        flash_times(torch, rows, case, c)
        del c
        torch.cuda.empty_cache()
    decode_family_checks(torch, rows, rng, "vlm_g7_d128", slots=VLM_SLOTS,
                         max_len=VLM_MAX_LEN, hkv=cfg.n_kv_heads,
                         g=cfg.n_heads // cfg.n_kv_heads,
                         d=cfg.resolved_head_dim())
    swa_softmax_rows(torch, rows, cfg, max(plens), VLM_SLOTS,
                     heads=cfg.n_heads)
    three_pass_sampler_rows(torch, rows, cfg, VLM_SLOTS, "vlm")
    part("kernel checks")
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    say("vlm_config", arch=VLM_ARCH, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim(), d_ff=cfg.d_ff, vocab=cfg.vocab,
        padded_vocab=cfg.padded_vocab(), mrope_sections=cfg.mrope_sections,
        n_patches=cfg.n_patches, weights_s=time.perf_counter() - t0,
        weights_bytes=sum(t.numel() * t.element_size()
                          for t in _leaves(params)),
        param_count=cfg.param_count(), slots=VLM_SLOTS,
        max_len=VLM_MAX_LEN,
        kv_bytes_a_token=kv_cache.cache_bytes(cfg, 1, 2, ring=False)
        - kv_cache.cache_bytes(cfg, 1, 1, ring=False),
        paged_pool_bytes=kv_cache.paged_pool_bytes(cfg, VLM_SLOTS,
                                                   VLM_MAX_LEN))
    part("weights")
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, k))
               for k in plens]
    _, _, launches = family_serving(
        torch, m, params, prompts, slots=VLM_SLOTS, max_len=VLM_MAX_LEN,
        new_tokens=VLM_NEW, sampled=VLM_SAMPLED, gather=False)
    part("serving")
    n, head, lo, hi, new = VLM_PREFIX
    pre = prefix_serving(
        torch, m, params, shared_prompts(np.random.default_rng(VLM_SEED + 100),
                                         cfg.vocab, head, n, lo, hi),
        slots=VLM_SLOTS, max_len=VLM_MAX_LEN, new=new,
        read="decode_attention_paged", tag="vlm prefix")
    for k, v in pre["launches"].items():
        launches[k] += v
    part("prefix sharing")
    order = np.argsort(plens, kind="stable")
    swa_prefill_parity(torch, m, params, [
        prompts[i] for i in (order[0], order[len(order) // 2], order[-1])],
        VLM_MAX_LEN)
    part("prefill parity")
    cut, new_graph, new_eager = VLM_TRACE
    trace = [p[:cut] for p in prompts]
    kw = dict(slots=VLM_SLOTS, max_len=VLM_MAX_LEN)
    decode_trace(torch, m, params, trace, fused=True, new=new_graph, **kw)
    decode_trace(torch, m, params, trace, fused=False, new=new_eager, **kw)
    part("decode traces")
    flash = vlm_lockstep(torch, m, params, rng)
    part("lockstep with patches")
    flash += vlm_f32_cut(torch, m, prompts, rng)
    part("float32 cut")
    launches["flash_attention_fwd_gqa"] = flash
    del m, params
    gc.collect()
    torch.cuda.empty_cache()
    run_cli(torch, VLM_ARCH, ("qwen2-vl-7b: lockstep batch=4", "prefill:",
                              "decode:", "kernel launches:"))
    part("cli")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the hybrid family, hymba-1.5b, at full width (HYB_LAYERS).
# ---------------------------------------------------------------------------
HYB_ARCH = "hymba-1.5b"      # 32 layers, d 1600, 25 query heads over 5 KV
                             # heads of 64 (G 5), SWA 1024, 25 mamba heads of
                             # 64 (state 16) a block, d_ff 5504, vocab 32001
HYB_SEED = 31
HYB_LAYERS = 8                      # depth cut from 32, so that the
                                    # whole script keeps inside its limit
HYB_SLOTS = 32
HYB_PROMPTS = (48, 200, 3001)       # requests, prompt lengths [lo, hi):
                                    # past the window
HYB_NEW = 64
HYB_MAX_LEN = 3136                  # 49 pages of 64
HYB_PAGE = 64
HYB_SAMPLED = (32, 128, 8)          # temperature 0.8: requests, prompt, new
HYB_TRACE = (1024, 16)              # the graph trace: prompt cut, new tokens
HYB_F32 = (2, 4, 16)                # float32 cut: layers, requests, new


def hybrid_phase(torch, rows) -> dict:
    """Phase 14: hymba-1.5b at full width, HYB_LAYERS of its 32 layers
    (the serving CLI at all 32), bf16 weights seeded on the card (``a_log`` and ``dt_bias`` float32).  Kernels 3-4 at G 5,
    D 64 under the 1,024 window, kernel 1 on its windowed prefill score
    rows [25 S, S] and sampler rows and kernels 5-6 on the sampler rows;
    then requests through :func:`family_serving` (32 slots, ``max_len``
    3,136 in pages of 64, 48 requests of 200-3,000 tokens, 64 new; the
    ssm state as each request leaves its slot bit-equal graph vs eager),
    prefill logits against ``use_kernels=False``, the ring past its wrap
    at 4 layers against a position-addressed cache
    (:func:`ring_wrap_check`), a decode trace of the graph step, a
    2-layer float32 cut and the serving CLI.  Returns the main path's
    launches of kernels 1, 3 and 4 and the sampled runs' of 5 and 6."""
    from repro_torch.models import build_model
    from repro_torch.serving import kv_cache

    rng = np.random.default_rng(HYB_SEED)
    m = build_model(HYB_ARCH, use_kernels=True, n_layers=HYB_LAYERS)
    cfg = m.cfg
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        say("hybrid_part", part=name, seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()

    n, lo, hi = HYB_PROMPTS
    plens = [int(x) for x in rng.integers(lo, hi, n)]
    decode_family_checks(torch, rows, rng, "hybrid_g5_d64_w1024",
                         slots=HYB_SLOTS, max_len=HYB_MAX_LEN,
                         hkv=cfg.n_kv_heads,
                         g=cfg.n_heads // cfg.n_kv_heads,
                         d=cfg.resolved_head_dim(), window=cfg.swa_window,
                         ps=HYB_PAGE)
    swa_softmax_rows(torch, rows, cfg, max(plens), HYB_SLOTS,
                     heads=cfg.n_heads)
    three_pass_sampler_rows(torch, rows, cfg, HYB_SLOTS, "hybrid")
    part("kernel checks")
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    state = kv_cache.init_cache(cfg, 1, 1, device="meta")["ssm"]
    say("hybrid_config", arch=HYB_ARCH, n_layers=cfg.n_layers,
        full_depth=32,
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim(), swa_window=cfg.swa_window,
        mamba_heads=cfg.d_model // cfg.ssm.head_dim,
        state_size=cfg.ssm.state_size, d_ff=cfg.d_ff, vocab=cfg.vocab,
        weights_s=time.perf_counter() - t0,
        weights_bytes=sum(t.numel() * t.element_size()
                          for t in _leaves(params)),
        a_log_dtype=str(params["blocks"]["mamba"]["a_log"].dtype),
        param_count=cfg.param_count(), slots=HYB_SLOTS,
        max_len=HYB_MAX_LEN, page_size=HYB_PAGE,
        kv_bytes_a_token=kv_cache.cache_bytes(cfg, 1, 2, ring=False)
        - kv_cache.cache_bytes(cfg, 1, 1, ring=False),
        ssm_state_bytes_a_slot=state.numel() * state.element_size(),
        paged_pool_bytes=kv_cache.paged_pool_bytes(
            cfg, HYB_SLOTS, HYB_MAX_LEN, page_size=HYB_PAGE))
    part("weights")
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, k))
               for k in plens]
    _, _, launches = family_serving(
        torch, m, params, prompts, slots=HYB_SLOTS, max_len=HYB_MAX_LEN,
        new_tokens=HYB_NEW, sampled=HYB_SAMPLED, gather=False,
        page_size=HYB_PAGE)
    part("serving")
    order = np.argsort(plens, kind="stable")
    swa_prefill_parity(torch, m, params, [
        prompts[i] for i in (order[0], order[len(order) // 2], order[-1])],
        HYB_MAX_LEN)
    part("prefill parity")
    launches["twopass_softmax_2d"] += ring_wrap_check(torch, m, params, rng)
    gc.collect()
    torch.cuda.empty_cache()
    part("ring")
    # the graph step's trace only: each trace admits 32 prompts of a full
    # window first, ~15 s of prefill
    cut, new = HYB_TRACE
    decode_trace(torch, m, params, [p[:cut] for p in prompts], fused=True,
                 new=new, slots=HYB_SLOTS, max_len=HYB_MAX_LEN,
                 page_size=HYB_PAGE)
    part("decode trace")
    moe_f32_cut(torch, m, prompts, cut=HYB_F32, slots=HYB_SLOTS,
                max_len=HYB_MAX_LEN, page_size=HYB_PAGE, tag="hybrid")
    part("float32 cut")
    del m, params
    gc.collect()
    torch.cuda.empty_cache()
    run_cli(torch, HYB_ARCH, ("hymba-1.5b: served 8 requests over 4 slots "
                              "/ paged pool", "prefill:", "decode:",
                              "kernel launches:"))
    part("cli")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: training qwen2.5-14b at full width through Trainer.
# ---------------------------------------------------------------------------
TRAIN_LAYERS = 4            # depth cut from 48 (memory: 16 bytes a param)
TRAIN_SEQ = 4096            # the config's train_4k length, batch 1
TRAIN_STEPS = 3
GRADS_HELD = {"lm_head.w": ("lm_head", "w"),
              "embed.table": ("embed", "table"),
              "blocks.mlp.down.w": ("blocks", "mlp", "down", "w"),
              "blocks.attn.wq.w": ("blocks", "attn", "wq", "w")}
TRAIN_KERNELS = FLASH + LMHEAD


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def train_phase(torch) -> dict:
    """Three AdamW steps of qwen2.5-14b (full width, 4 layers, float32
    parameters, bf16 activations, remat) on SyntheticLM batches of 1 x 4096
    through ``Trainer.run`` with the model's own ``use_kernels``: attention
    through the flash-attention kernels, the loss through the fused LM-head
    CE kernels.  First, from the same state and batch, that kernel route
    against the plain route (the model's kernels off: attention in the
    (m, n) tensor forms, materialised logits).  Returns the launches of
    kernels 9-13 over the three steps."""
    import repro_torch.kernels as K
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model, transformer
    from repro_torch.optim import adamw
    from repro_torch.training import step_fn
    from repro_torch.training.trainer import Trainer, TrainerConfig

    mk = build_model(ARCH, n_layers=TRAIN_LAYERS, use_kernels=True)
    mp = build_model(ARCH, n_layers=TRAIN_LAYERS)
    cfg = mk.cfg
    check(cfg.use_kernels and cfg.remat and cfg.param_dtype == "float32"
          and cfg.dtype == "bfloat16" and not mp.cfg.use_kernels,
          f"train config: {cfg}")
    t0 = time.perf_counter()
    params = mk.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in adamw.leaves(params))
    cell = ShapeCell("train_4k_b1", TRAIN_SEQ, 1, "train")
    ds = SyntheticLM(cfg, cell, seed=0)
    tokens = TRAIN_SEQ - 1              # label positions of a batch
    chunks = min(8, tokens)
    # a flash forward per layer, again in each layer's remat backward, and
    # one backward per layer; one LM-head launch of each per loss chunk
    want = {"flash_attention_fwd_gqa": 2 * TRAIN_LAYERS,
            "flash_attention_bwd_gqa": TRAIN_LAYERS,
            **dict.fromkeys(LMHEAD, chunks)}
    tcfg = TrainerConfig(steps=TRAIN_STEPS, peak_lr=3e-4, warmup=100,
                         log_every=1)
    say("train_config", arch=ARCH, n_layers=cfg.n_layers, full_depth=48,
        reduced=["n_layers 48 -> 4"], d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        vocab=cfg.vocab, param_dtype=cfg.param_dtype, dtype=cfg.dtype,
        remat=cfg.remat, params=n_params, batch=[1, TRAIN_SEQ],
        loss_chunks=chunks, data="SyntheticLM seed 0",
        entry="Trainer.run", trainer=dataclasses.asdict(tcfg),
        lr="warmup_cosine, peak 3e-4, 100 warm-up steps",
        init_s=time.perf_counter() - t0,
        kernel_route="model use_kernels=True: flash attention + fused "
                     "LM-head CE", plain_route="use_kernels=False",
        launches_per_step=want)

    # -- the kernel route against the plain route, same state and batch
    batch = {"tokens": torch.from_numpy(ds.batch_at(0)["tokens"]).cuda()}
    K.reset_launch_counts()
    lk, gk = step_fn.loss_and_grads(mk, params, batch)
    torch.cuda.synchronize()
    ck = K.launch_counts()
    held_k = {n: _at(gk, pth) for n, pth in GRADS_HELD.items()}
    del gk
    K.reset_launch_counts()
    t = time.perf_counter()
    lp, gp = step_fn.loss_and_grads(mp, params, batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cp = K.launch_counts()
    held_p = {n: _at(gp, pth) for n, pth in GRADS_HELD.items()}
    del gp
    check(all(ck[k] == want[k] for k in TRAIN_KERNELS),
          f"kernel route: launches {want} expected, got {ck}")
    check(sum(cp.values()) == 0, f"plain route launched a kernel: {cp}")
    with torch.no_grad():
        h = transformer.forward(params, batch["tokens"][:, :-1], cfg=mp.cfg)
        w = transformer._head_w(params, cfg).to(h.dtype)
        xmax = max(float((hc @ w).abs().amax())
                   for hc in h[0].split(-(-tokens // chunks)))
        del h, w
    # the plain route rounds its logits to bf16 (h @ w in bf16): each
    # within 2^-9 of its value, so lse and the label logit each move by
    # 2^-9 max|x| at most; 1e-4 more for float32 sums
    loss_lim = 2.0 ** -8 * xmax + 1e-4
    check(abs(float(lk) - float(lp)) <= loss_lim,
          f"loss kernels {float(lk)} vs plain {float(lp)} beyond {loss_lim}")
    grads = {}
    for name in GRADS_HELD:
        a, b = held_k[name].float(), held_p[name].float()
        rel = float((a - b).norm() / b.norm())
        # lm_head.w: dlogits rounded to bf16 on the plain side and each
        # route's bf16 chunk sums, a few 2^-9; the others: the backward
        # through 4 layers of bf16 activations, each route rounding its own
        lim = 2.0 ** -5 if name == "lm_head.w" else 2.0 ** -4
        check(rel <= lim and bool(torch.isfinite(a).all()),
              f"grad {name}: relative norm difference {rel} beyond {lim}")
        grads[name] = dict(rel_norm_diff=rel, limit=lim,
                           max_abs_err=float((a - b).abs().max()),
                           max_abs=float(b.abs().max()))
    del held_k, held_p
    gc.collect()
    torch.cuda.empty_cache()
    # loss and gradients alone (no optimizer), each route timed after its
    # first run
    t = time.perf_counter()
    step_fn.loss_and_grads(mk, params, batch)
    torch.cuda.synchronize()
    kern_ms = (time.perf_counter() - t) * 1e3
    say("train_parity", check="kernel route vs plain route, same state "
        "and batch", loss_kernels=float(lk),
        loss_plain=float(lp), loss_abs_diff=abs(float(lk) - float(lp)),
        loss_limit=loss_lim, max_abs_logit=xmax, grads=grads,
        launches_kernel_route={k: ck[k] for k in TRAIN_KERNELS},
        launches_plain_route=sum(cp.values()),
        loss_and_grads_ms={"kernel_route": kern_ms, "plain_route": plain_ms})
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- the train steps through Trainer.run: the main path (the kernel
    # route), then the plain route from the same initial weights
    def run(model, route):
        trainer = Trainer(model, cell, tcfg)
        step = trainer.step
        counts = dict.fromkeys(TRAIN_KERNELS, 0)
        peaks = []

        def counted(state, batch):
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            out = step(state, batch)
            torch.cuda.synchronize()
            c = K.launch_counts()
            i = len(peaks)
            w = want if route == "kernel" else dict.fromkeys(want, 0)
            check(all(c[k] == w[k] for k in TRAIN_KERNELS),
                  f"{route} step {i}: launches {w} expected, got {c}")
            for k in TRAIN_KERNELS:
                counts[k] += c[k]
            peaks.append(torch.cuda.max_memory_allocated())
            return out

        trainer.step = counted
        state = trainer.run()
        check(int(state.opt.step) == TRAIN_STEPS, "optimizer step count")
        hist = trainer.metrics_history
        check([r["step"] for r in hist] == list(range(TRAIN_STEPS)),
              f"{route}: steps run {hist}")
        for r, peak in zip(hist, peaks):
            check(math.isfinite(r["loss"]), f"{route} step {r['step']}: "
                  f"loss {r['loss']}")
            say("train_step", route=route, entry="Trainer.run",
                step=r["step"], loss=r["loss"], ms=r["time_s"] * 1e3,
                tokens_per_s=tokens / r["time_s"], peak_bytes=peak)
        if route == "kernel":
            train_trace(torch, step, state, ds.batch_at(TRAIN_STEPS),
                        untraced_ms=min(r["time_s"] for r in hist) * 1e3)
        del state, trainer
        gc.collect()
        torch.cuda.empty_cache()
        return (counts, [r["loss"] for r in hist],
                [r["time_s"] * 1e3 for r in hist], peaks)

    launches, losses, times, peaks = run(mk, "kernel")
    check(abs(losses[0] - math.log(cfg.vocab)) < 1.5,
          f"first loss {losses[0]} not near ln V = {math.log(cfg.vocab)}")
    _, plain_losses, plain_times, plain_peaks = run(mp, "plain")
    say("train", losses=losses, plain_route_losses=plain_losses,
        step_ms=times, plain_route_step_ms=plain_times,
        peak_bytes=peaks, plain_route_peak_bytes=plain_peaks,
        first_loss_minus_ln_v=losses[0] - math.log(cfg.vocab),
        first_loss_equals_parity_loss=losses[0] == float(lk),
        launches=launches)
    return launches


def _moe_range_times(prof) -> dict:
    """Device ms by ``MOE_GROUPS`` range and kernel name.  A kernel's op
    belongs to its innermost range; an op of the backward (under an
    autograd node, scope 1) to the node's forward op, the last op of the
    forward that took the node's sequence number on its thread (as
    ``torch.profiler`` pairs them for stacks).  ``MOE_BLOCK``, around
    every block, keeps a remat recompute's ops (run inside a node's
    backward) from taking that node's range.  Kernels in no range are
    left out."""
    names = {g for _, _, g in MOE_GROUPS}

    def walk(e, fwd):
        # (an op of the backward, its group)
        while e is not None:
            if e.name in names:
                return False, e.name
            if e.name == MOE_BLOCK:
                return False, None
            if e.scope == 1:
                return True, fwd.get((e.sequence_nr, e.fwd_thread))
            e = e.cpu_parent
        return False, None

    events = [e for e in prof.events() if str(e.device_type).endswith("CPU")]
    fwd, last = {}, {}
    for e in events:
        key = (e.sequence_nr, e.thread)
        if e.sequence_nr < 0 or e.name.startswith("autograd::engine::"):
            continue
        backward, g = walk(e, {})
        if not backward and e.time_range.start >= last.get(key, -1):
            last[key], fwd[key] = e.time_range.start, g
    out = {}
    for e in events:
        g = walk(e, fwd)[1] if e.kernels else None
        if g is not None:
            by_kernel = out.setdefault(g, {})
            for k in e.kernels:
                if k.name not in MOE_RANGES:
                    by_kernel[k.name] = by_kernel.get(k.name, 0.0) \
                        + k.duration / 1e3
    return out


def train_trace(torch, step, state, batch, *, arch: str = ARCH,
                untraced_ms: float, moe: bool = False) -> None:
    """Where a step's device time goes: one more step under
    ``torch.profiler`` (CUDA activity only: tracing the CPU's ops too
    slowed the host and took minutes to fold at rwkv6's ~10^5 kernels a
    step), its kernels' device time summed by group, the ten largest by
    name, and every flash kernel by name (which of the backward's kernels
    ran).  With ``moe`` the CPU's ops are traced too, each function of
    ``MOE_GROUPS`` inside a host range, and its kernels' time (forward,
    remat recompute and backward, :func:`_moe_range_times`) moves from
    the name groups to a group of its own.  Not one of the counted steps.
    ``untraced_ms``, an untraced step's wall time, gives the host's share
    without the profiler's cost: 1 - device busy / that step."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if moe else [])
    ranges = _host_ranges(*[
        (importlib.import_module(f"repro_torch.models.{mod}"), f, g)
        for mod, f, g in (*MOE_GROUPS, ("transformer", "block_apply",
                                        MOE_BLOCK))]) \
        if moe else contextlib.nullcontext()
    with ranges, profile(activities=acts) as prof:
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_name = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.key not in MOE_RANGES:
            by_name[e.key] = getattr(e, "self_device_time_total", 0) / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        say("train_trace", arch=arch,
            device_time="not measured (no CUDA events)")
        return

    def group(name):
        if name.startswith("lmhead_") or "lmhead_" in name:
            return "lmhead_xent kernels"
        if "flash_fwd" in name or "flash_dq" in name or "flash_dkv" in name:
            return "flash_attention kernels"
        if any(k in name for k in ("gemm", "cutlass", "xmma", "sm90",
                                   "nvjet", "cublas")):
            return "cuBLAS products"
        return "other (elementwise, reductions, copies)"

    groups = {}
    for name, ms in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    # a moe range's kernels leave the group their name gives
    for g, kernels in (_moe_range_times(prof) if moe else {}).items():
        for kname, ms in kernels.items():
            groups[group(kname)] -= ms
        groups[g] = sum(kernels.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    flash = {k[:120]: v for k, v in by_name.items()
             if group(k) == "flash_attention kernels"}
    say("train_trace", arch=arch, wall_ms=wall * 1e3,
        trace_s=time.perf_counter() - t, device_busy_ms=busy,
        idle_share=max(0.0, 1 - busy / (wall * 1e3)),
        untraced_step_ms=untraced_ms,
        idle_share_untraced=max(0.0, 1 - busy / untraced_ms),
        groups_ms=groups,
        top_kernels_ms=[[k[:120], v] for k, v in top],
        flash_kernels_ms=flash)


def run_cli(torch, arch, expect, *flags, timeout=600) -> None:
    """``python -m repro_torch.launch.serve --arch arch ... --kernels`` at
    full width as a user runs it; each of ``expect`` must be in a line of
    its output."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
           *flags, "--kernels"]
    t = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    lines = out.stdout.splitlines()
    say("cli", cmd=" ".join(cmd[1:]), rc=out.returncode,
        seconds=time.perf_counter() - t, stdout=lines,
        stderr_tail=out.stderr.splitlines()[-5:])
    check(out.returncode == 0, f"{arch} serving CLI exited {out.returncode}")
    check(all(any(e in ln for ln in lines) for e in expect),
          f"{arch} serving CLI: a line with one of {expect} is missing")


def cli_phase(torch) -> None:
    """Phase 16: the serving CLI at full width as a user runs it."""
    run_cli(torch, ARCH, ("prefill: 2048 tok", "decode:",
                          "threepass_reload_2d"),
            "--slots", "8", "--requests", "8", "--prompt-len", "256",
            "--steps", "8", "--softmax", "three_pass_reload")


CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"


def train_cli_phase(torch) -> None:
    """Phase 17: the training CLI as a user runs it, reduced qwen2.5-14b
    with ``--kernels`` and a checkpoint directory: 6 steps straight, then 3
    (the crash) and a resume to 6 from the same directory; the final losses
    agree, and the flash and LM-head kernels ran."""
    import ast
    import shutil

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
            "--reduced", "--kernels", "--checkpoint-every", "3"]
    finals = {}
    for name, steps, ck in (("straight", 6, "a"), ("crash", 3, "b"),
                            ("resume", 6, "b")):
        cmd = base + ["--steps", str(steps), "--checkpoint-dir",
                      str(CKPT_DIR / ck)]
        t = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300, cwd=ROOT,
                             env=dict(os.environ,
                                      PYTHONPATH=str(ROOT / "src")))
        lines = out.stdout.splitlines()
        say("train_cli", run=name, cmd=" ".join(cmd[1:]), rc=out.returncode,
            seconds=time.perf_counter() - t, stdout=lines,
            stderr_tail=out.stderr.splitlines()[-4:])
        check(out.returncode == 0, f"train CLI {name} exited "
              f"{out.returncode}")
        final = [ln for ln in lines if ln.startswith("final: ")]
        launch = [ln for ln in lines if ln.startswith("kernel launches: ")]
        check(len(final) == 1 and len(launch) == 1,
              f"train CLI {name}: no final / launches line")
        finals[name] = ast.literal_eval(final[0][len("final: "):])
        counts = ast.literal_eval(launch[0][len("kernel launches: "):])
        check(all(counts.get(k, 0) > 0 for k in TRAIN_KERNELS),
              f"train CLI {name}: kernels not launched: {counts}")
    a, b = finals["straight"], finals["resume"]
    check(a["step"] == b["step"] == 5 and finals["crash"]["step"] == 2,
          f"train CLI steps: {finals}")
    rel = abs(a["loss"] - b["loss"]) / abs(a["loss"])
    check(rel <= 1e-5, f"train CLI: resumed loss {b['loss']} vs straight "
          f"{a['loss']}")
    say("train_cli_resume", straight=a, resumed=b, rel_diff=rel,
        tol="rtol 1e-5")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 18: prefix sharing and streaming, qwen2.5-14b at full width.
# ---------------------------------------------------------------------------
PREFIX_SEED = 31
PREFIX_HEAD = 1000           # 7 whole pages of 128 and 104 tokens of an 8th
PREFIX_TAILS = (16, 24, 401)  # requests after the whole head, tails [lo, hi)
PREFIX_MID = (4, 900)        # requests that leave the head mid-page at 900
PREFIX_NEW = 32
PREFIX_EVICT_PAGES = 49      # 48 usable: the index must give pages back
MLA_PREFIX = (8, 1024, 40, 301, 32)     # requests, head, tails [lo, hi), new
VLM_PREFIX = (8, 400, 40, 301, 32)      # the head crosses the 256-position grid


def shared_prompts(rng, vocab, head_len, n, lo, hi, mid=None):
    """``n`` prompts of one random head of ``head_len`` tokens and distinct
    tails of ``lo``..``hi - 1`` tokens, then ``mid`` = (requests, cut)
    prompts that leave the head after ``cut`` tokens."""
    head = tuple(int(t) for t in rng.integers(0, vocab, head_len))

    def tail(k):
        return tuple(int(t) for t in rng.integers(0, vocab, k))

    out = [head + tail(int(k)) for k in rng.integers(lo, hi, n)]
    if mid is not None:
        out += [head[:mid[1]] + tail(int(k))
                for k in rng.integers(lo, hi, mid[0])]
    return out


def watch_admissions(admits: list):
    """A ``serve_requests`` hook: each admission records its prompt's
    length and its wall ms, from the call to its first token on the host
    (an admission ends by reading that token, and the decode burst before
    it by reading its tokens); a prefix hit also its matched tokens, its
    tail bucket, the kernel launches of its tail prefill and how many
    arena pages two or more slots' rows then name (the decode bursts that
    follow read them)."""
    import repro_torch.kernels as K

    def hook(eng):
        admit, prefill_hit = eng._admit, eng._prefill_hit
        current = {}

        def hit(req, slot, match, m_tok, tail_bucket, page_ids):
            before = K.launch_counts()
            out = prefill_hit(req, slot, match, m_tok, tail_bucket,
                              page_ids)
            after = K.launch_counts()
            rows = [p for pages in eng.slot_pages for p in pages]
            current.update(
                hit=True, matched=m_tok, tail_bucket=tail_bucket,
                launches={k: after[k] - before[k] for k in after
                          if after[k] != before[k]},
                aliased_pages=len({p for p in rows if rows.count(p) > 1}))
            return out

        def timed(req, slot, now):
            current.clear()
            t = time.perf_counter()
            ok = admit(req, slot, now)
            if ok:
                admits.append({"hit": False, "plen": len(req.prompt),
                               "ms": (time.perf_counter() - t) * 1e3,
                               **current})
            return ok

        eng._admit, eng._prefill_hit = timed, hit
    return hook


def _ms_summary(xs) -> dict:
    xs = sorted(xs)
    return dict(n=len(xs), median=statistics.median(xs), min=xs[0],
                max=xs[-1]) if xs else dict(n=0)


def hit_logits_limit(torch, m, params, n: int):
    """A ``serve_requests`` hook that holds the first ``n`` prefix hits'
    first-token logits (the tail prefilled after gathered pages) against
    a whole prefill of the same prompt: their largest difference over the
    largest logit goes into ``hook.errs``, and (the largest difference,
    the whole prefill's top-2 margin, whether the argmaxes agree) into
    ``hook.margins``.  ``hook.restore()`` takes the wrapper of
    ``engine.prefill_extend`` out again."""
    from repro_torch.serving import engine

    errs, margins = [], []
    extend = engine.prefill_extend

    def hook(eng):
        admit = eng._prefill_hit
        current = {}

        def hit(req, *args, **kw):
            current["prompt"] = req.prompt
            return admit(req, *args, **kw)

        def ext(*args, **kw):
            logits, cache = extend(*args, **kw)
            if len(errs) < n:
                # the whole prompt prefilled as a miss is: padded to its
                # bucket, read at its last token
                p = current["prompt"]
                padded = torch.zeros((1, eng._bucket_for(len(p))),
                                     dtype=torch.int64)
                padded[0, :len(p)] = torch.tensor(p)
                want, _ = engine.prefill(
                    params, padded.to(eng.device), cfg=m.cfg,
                    max_len=padded.shape[1], last_pos=len(p) - 1,
                    moe_impl=eng.moe_impl)
                want = want[:, :m.cfg.vocab].float()
                got = logits[:, :m.cfg.vocab].float()
                diff = float((got - want).abs().max())
                top2 = want[0].topk(2).values
                errs.append(diff / float(want.abs().max()))
                margins.append((diff, float(top2[0] - top2[1]),
                                bool(got.argmax() == want.argmax())))
            return logits, cache

        eng._prefill_hit = hit
        engine.prefill_extend = ext

    hook.errs, hook.margins = errs, margins
    hook.restore = lambda: setattr(engine, "prefill_extend", extend)
    return hook


def hold_tokens(torch, m, params, prompts, got, want, what: str,
                moe_impl: str = "dispatch",
                tag: str = "prefix_mismatch") -> bool:
    """``got`` == ``want`` (greedy tokens a request), or a report under
    ``tag``: each request that differs, the first position where it does
    and the top-2 logit margin of ``want``'s run there (its prompt and
    tokens before that position prefilled whole).  Returns whether they
    were equal."""
    from repro_torch.serving import engine

    if got == want:
        say("parity", arch=m.cfg.name, check=what, equal=True)
        return True
    diffs = []
    for i, (a, b) in enumerate(zip(got, want)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ctx = list(prompts[i]) + list(b[:j])
        lg, _ = engine.prefill(params, torch.tensor([ctx], device=m.device),
                               cfg=m.cfg, max_len=len(ctx),
                               moe_impl=moe_impl)
        top2 = lg[0, :m.cfg.vocab].float().topk(2).values
        diffs.append(dict(request=i, position=j, got=a[j], want=b[j],
                          want_top2_margin=float(top2[0] - top2[1]),
                          largest_logit=float(lg.float().abs().max())))
    say(tag, arch=m.cfg.name, check=what, requests=len(got),
        differ=len(diffs), first_differences=diffs)
    return False


def admission_trace(torch, m, params, prompts, tag, **kw) -> None:
    """One miss (``prompts[0]``) and then one hit (``prompts[1]``)
    admitted alone under the profiler: each admission's wall ms beside
    the device's busy ms and kernel count, so a host-bound admission
    shows.  ``kw`` go to the engine (its prefix cache on)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.scheduler import Request

    eng = m.serving_engine(params, temperature=0.0, **kw)
    out = {}
    for slot, name in ((0, "miss"), (1, "hit")):
        req = Request(rid=slot, prompt=prompts[slot], max_new_tokens=2)
        hits = eng.stats["prefix_hits"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            eng._admit(req, slot, 0.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        dev = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
        out[name] = dict(
            plen=len(req.prompt), hit=eng.stats["prefix_hits"] > hits,
            wall_ms=wall * 1e3,
            device_busy_ms=sum(getattr(e, "self_device_time_total", 0)
                               for e in dev) / 1e3,
            kernels=sum(e.count for e in dev))
    say("prefix_admission_trace", arch=m.cfg.name, run=tag, **out)
    check(out["hit"]["hit"] and not out["miss"]["hit"],
          f"{tag}: the traced admissions did not miss, then hit")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def hold_hit_logits(torch, m, params, reqs, tag, tol=LOGIT_TOL,
                    **kw) -> None:
    """Serve ``reqs`` again with the prefix cache on, every hit's
    first-token logits held against the whole prompt's prefill: the
    argmaxes agree wherever the whole prefill's top-2 margin exceeds
    twice their largest difference (the bf16 rule of the swa, moe and mla
    phases), and, unless ``tol`` is None, the difference is within
    ``tol`` of the largest logit (the engine phase's bf16 limit).  A
    multi-head latent attention model is held by the margin rule alone,
    as its forward is (:func:`mla_forward_parity`: its bf16 logits miss
    5e-2 between two plain routes' rounding)."""
    limit = hit_logits_limit(torch, m, params, len(reqs))
    try:
        serve_requests(torch, m, params, reqs, hook=limit, **kw)
    finally:
        limit.restore()
    worst = max(limit.errs)
    decided = [(d, mg, eq) for d, mg, eq in limit.margins if mg > 2 * d]
    if m.cfg.mla is not None:
        tol = None
    say("parity", arch=m.cfg.name, check=f"{tag}: each hit's first-token "
        "logits vs the whole prompt's bucketed prefill", hits=len(limit.errs),
        max_err_over_max_logit=worst, errs=limit.errs,
        bit_equal=sum(e == 0 for e in limit.errs),
        max_abs_err=[d for d, _, _ in limit.margins],
        top2_margin=[mg for _, mg, _ in limit.margins],
        argmax_equal=[eq for _, _, eq in limit.margins],
        decided=len(decided),
        rule="argmax == where the whole prefill's top-2 margin exceeds 2 x "
             "the largest logit difference" + (
                 "" if tol is None else
                 f"; within {tol} of the largest logit, as the engine phase"))
    check(all(eq for _, _, eq in decided),
          f"{tag}: a hit's argmax != the whole prefill's at a decided margin")
    check(tol is None or worst <= tol,
          f"{tag}: hit logits vs whole prefill {worst}")


def prefix_f32_cut(torch, m, prompts, tag, *, new, **kw) -> None:
    """Full width, depth cut to 2 layers, float32 weights and activations:
    the prefix cache on (graph step) and off give the same greedy tokens,
    and each hit's first-token logits lie within F32_LOGIT_TOL of the
    largest logit of its whole prefill's (the tail's rows only round
    otherwise)."""
    from repro_torch.models import Model
    from repro_torch.serving.scheduler import Request

    cfg = dataclasses.replace(m.cfg, n_layers=2, dtype="float32")
    model = Model(cfg, m.device)
    params = model.init(seed=1, dtype=torch.float32)

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]

    kw = dict(kw, temperature=0.0, seed=3)
    limit = hit_logits_limit(torch, model, params, len(prompts))
    try:
        on, st = serve_requests(torch, model, params, reqs(), hook=limit,
                                **kw)
    finally:
        limit.restore()
    off, _ = serve_requests(torch, model, params, reqs(), prefix_cache=False,
                            **kw)
    worst = max(limit.errs)
    equal = sum(a == b for x, y in zip(on, off) for a, b in zip(x, y))
    say("parity", arch=cfg.name, check=f"{tag}: float32, 2 layers: prefix "
        "cache on == off tokens; each hit's first-token logits vs its whole "
        "prefill", dtype="float32", n_layers=2, hits=st["prefix_hits"],
        tokens_equal=equal, tokens_compared=sum(map(len, off)),
        max_err_over_max_logit=worst, tol=F32_LOGIT_TOL)
    check(on == off, f"{tag}: float32 tokens, prefix cache on != off")
    check(st["prefix_hits"] == len(limit.errs) > 0 and worst <= F32_LOGIT_TOL,
          f"{tag}: float32 hit logits vs whole prefill {worst}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def prefix_serving(torch, m, params, prompts, *, slots, max_len, new,
                   read, tag, check_logits=True, **engine_kw) -> dict:
    """The shared-head traffic with the prefix cache on (the graph step,
    through ``stream()``) and off (the graph step, through ``run()``):
    tokens ``==``, or reported by :func:`hold_tokens` and then, with
    ``check_logits``, each hit's first-token logits held by
    :func:`hold_hit_logits`; prefill seconds, tok/s, reused tokens, peak
    pages and the admissions' wall ms of each; every hit's admission
    launches kernel 1 once a layer and no decode read, and slots' rows
    alias arena pages.  Returns the on run's launches of kernel 1 and of
    the decode read, and its tokens, the off run's and the throughputs."""
    from repro_torch.serving.scheduler import Request

    cfg = m.cfg
    n_l = cfg.n_layers
    router = n_l if cfg.moe is not None else 0

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]

    kw = dict(slots=slots, max_len=max_len, seed=3, temperature=0.0,
              **engine_kw)
    # off first: the first prefill after a model is built pays for its
    # warm-up, which the on run's one miss would otherwise carry
    admits, admits_off = [], []
    off, st_off = serve_requests(torch, m, params, reqs(),
                                 hook=watch_admissions(admits_off),
                                 prefix_cache=False, **kw)
    on, st_on = serve_requests(torch, m, params, reqs(),
                               hook=watch_admissions(admits), stream=True,
                               **kw)
    hits = [a for a in admits if a["hit"]]
    streamed = st_on.pop("streamed")
    keys = ("prefill_s", "prefill_tok_s", "prefill_tokens", "decode_tok_s",
            "decode_ms_per_step", "peak_pages", "steps", "wall_s")
    for name, st in (("on", st_on), ("off", st_off)):
        say("prefix_run", arch=cfg.name, run=tag, cache=name,
            prompt_lens=[len(p) for p in prompts],
            prefix_tokens_reused=st.get("prefix_tokens_reused", 0),
            **{k: st[k] for k in keys},
            **{k: st[k] for k in ("prefix_hits", "cow_copies",
                                  "prefix_evictions", "cached_pages")
               if k in st}, launches=st["launches"])
    check(streamed == on, f"{tag}: stream deltas != the run's tokens")
    check(st_on["prefix_cache"] and not st_off["prefix_cache"],
          f"{tag}: the cache's switch")
    check(st_on["prefix_hits"] >= len(prompts) - 1
          and len(hits) == st_on["prefix_hits"],
          f"{tag}: {st_on['prefix_hits']} hits of {len(prompts)}")
    check(st_on["free_pages"] + st_on["cached_pages"] == st_on["pages"],
          f"{tag}: free {st_on['free_pages']} + cached "
          f"{st_on['cached_pages']} != usable {st_on['pages']}")
    # a hit's tail prefill: the score rows (and a moe model's router rows)
    # through kernel 1 in every layer, no decode read
    want = {"twopass_softmax_2d": n_l + router}
    check(all(h["launches"] == want for h in hits),
          f"{tag}: a hit's launches {[h['launches'] for h in hits]}")
    check(max((h["aliased_pages"] for h in hits), default=0) > 0,
          f"{tag}: no two slots' rows named one page")
    per = {read: n_l, **({"twopass_softmax_2d": router} if router else {})}
    check(st_on["launches"][read] > 0
          and st_on["launches_per_replay"] == per, f"{tag}: decode reads "
          f"{st_on['launches']}, {st_on['launches_per_replay']} a replay")
    say("prefix_hits", arch=cfg.name, run=tag, hits=len(hits),
        launches_a_hit=want, max_aliased_pages=max(
            (h["aliased_pages"] for h in hits), default=0),
        aliased_pages=[h["aliased_pages"] for h in hits],
        tail_buckets=[h["tail_bucket"] for h in hits],
        matched=[h["matched"] for h in hits],
        stream_deltas=st_on["deltas"], stream_equal=True)
    say("prefix_admissions", arch=cfg.name, run=tag,
        hit_ms=_ms_summary([a["ms"] for a in hits]),
        miss_ms=_ms_summary([a["ms"] for a in admits if not a["hit"]]),
        off_ms=_ms_summary([a["ms"] for a in admits_off]),
        hits=[(a["plen"], a["tail_bucket"], a["ms"]) for a in hits],
        off=[(a["plen"], a["ms"]) for a in admits_off])
    equal = hold_tokens(torch, m, params, prompts, on, off,
                        f"{tag}: prefix cache on == off tokens",
                        engine_kw.get("moe_impl", "dispatch"))
    if not equal and check_logits:
        hold_hit_logits(torch, m, params, reqs(), tag, **kw)
    admission_trace(torch, m, params, prompts, tag, slots=slots,
                    max_len=max_len, **engine_kw)
    prefix_f32_cut(torch, m, prompts, tag, new=new, slots=slots,
                   max_len=max_len, **engine_kw)
    return dict(launches={k: st_on["launches"][k]
                          for k in ("twopass_softmax_2d", read)},
                on=on, off=off, st_on=st_on, st_off=st_off, equal=equal)


def prefix_phase(torch, n_layers: int) -> dict:
    """Phase 18: the engine phase's qwen2.5-14b (full width, ``n_layers``
    deep, bf16, paged, 8 slots, ``max_len`` 1,664, pages of 128) serving
    20 greedy requests that share a head: 16 of its 1,000 tokens and
    tails of 24-400, 4 that leave it mid-page at token 900, 32 new tokens
    each.  The prefix cache on with the graph step (through ``stream()``,
    its deltas ``==`` the tokens), on with the eager step (the same tokens
    and launches) and off; hits, copy-on-write copies, kernel 1 in each
    hit's tail prefill, kernel 3 over pages two slots' rows name, free +
    cached == usable when the run ends; an eviction run on a 48-page
    arena; each hit's first-token logits against a whole prefill.
    Returns the on run's launches of kernels 1 and 3."""
    from repro_torch.models import build_model

    rng = np.random.default_rng(PREFIX_SEED)
    m = build_model(ARCH, n_layers=n_layers, use_kernels=True)
    cfg = m.cfg
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n, lo, hi = PREFIX_TAILS
    prompts = shared_prompts(rng, cfg.vocab, PREFIX_HEAD, n, lo, hi,
                             mid=PREFIX_MID)
    say("prefix_config", arch=ARCH, n_layers=cfg.n_layers, slots=N_SLOTS,
        max_len=MAX_LEN, head=PREFIX_HEAD, requests=len(prompts),
        mid_cut=PREFIX_MID[1], new_tokens=PREFIX_NEW,
        prompt_lens=[len(p) for p in prompts])
    kw = dict(slots=N_SLOTS, max_len=MAX_LEN)
    out = prefix_serving(torch, m, params, prompts, new=PREFIX_NEW,
                         read="decode_attention_paged", tag="prefix",
                         check_logits=False, **kw)
    st_on = out["st_on"]
    check(st_on["cow_copies"] > 0, "prefix: no copy-on-write copy")
    from repro_torch.serving.scheduler import Request

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=PREFIX_NEW)
                for i, p in enumerate(prompts)]

    # the graph's oracle: the eager step gives the same tokens, launches
    # and counters
    eager, st_e = serve_requests(torch, m, params, reqs(), temperature=0.0,
                                 fused=False, seed=3, **kw)
    same = ("prefix_hits", "prefix_tokens_reused", "cow_copies",
            "prefix_evictions", "peak_pages", "cached_pages")
    check(eager == out["on"] and st_e["launches"] == st_on["launches"]
          and all(st_e[k] == st_on[k] for k in same),
          f"prefix: eager {st_e['launches']} != graph {st_on['launches']}")
    say("parity", arch=ARCH, check="prefix cache on: graph == eager tokens, "
        "launches and counters; stream() deltas == run() tokens",
        equal=out["on"] == eager, eager_decode_ms_per_step=st_e[
            "decode_ms_per_step"],
        graph_decode_ms_per_step=st_on["decode_ms_per_step"])
    # a 48-page arena: admissions and growth evict cold cached pages;
    # every hit's first-token logits against its whole prefill
    limit = hit_logits_limit(torch, m, params, len(prompts))
    try:
        evict, st_x = serve_requests(
            torch, m, params, reqs(), temperature=0.0, seed=3,
            pages=PREFIX_EVICT_PAGES, hook=limit, **kw)
    finally:
        limit.restore()
    say("prefix_run", arch=ARCH, run="prefix", cache="on, 48 pages "
        "(prefill times include the logits check's whole prefills)",
        **{k: st_x[k] for k in ("prefix_hits", "prefix_tokens_reused",
                                "cow_copies", "prefix_evictions",
                                "cached_pages", "peak_pages", "preempted")})
    check(st_x["prefix_evictions"] > 0, "prefix: nothing evicted")
    check(st_x["free_pages"] + st_x["cached_pages"] == st_x["pages"],
          "prefix: the 48-page arena did not drain")
    hold_tokens(torch, m, params, prompts, evict, out["off"],
                "prefix: 48-page arena == cache off tokens")
    worst = max(limit.errs)
    say("parity", arch=ARCH, check="prefix: each hit's first-token logits "
        "vs the whole prompt's bucketed prefill", hits=len(limit.errs),
        max_err_over_max_logit=worst, errs=limit.errs,
        bit_equal=sum(e == 0 for e in limit.errs),
        top2_margin=[mg for _, mg, _ in limit.margins],
        argmax_equal=[eq for _, _, eq in limit.margins],
        tol=f"{LOGIT_TOL} of the largest logit, as the engine phase")
    check(worst <= LOGIT_TOL, f"prefix: hit logits vs whole prefill {worst}")
    del m, params
    gc.collect()
    torch.cuda.empty_cache()
    return out["launches"]


# ---------------------------------------------------------------------------
# Phase 19: int8 KV pages and the host-RAM swap tier.
# ---------------------------------------------------------------------------
QUANT_SEED = 32              # its first 8 prompts fill 56 pages of 128, and
#                              two of them grow into a new page within their
#                              32 new tokens
QUANT_POOLS = (("bf16", None, None), ("int8_page", "int8", "page"),
               ("int8_page_head", "int8", "page_head"))
QUANT_PAGE = 128             # the registry's page size at max_len 1,664
QUANT_LAYERS_F32 = 2         # the float32 cut's depth
SWAP_BYTES = 8 << 30         # host RAM for demoted slots: never the limit
DECODE_BF16_TOL = dict(atol=1e-5, rtol=1e-2)    # kernel_phase's bf16 limit


def quant_kernel_checks(torch, rows, lengths) -> None:
    """Kernel 3 at the quant phase's served shape: q [8, 8, 5, 128] bf16,
    pages of 128, a shuffled table of 13 pages a slot, ``lengths`` the
    served slots' lengths.  The bf16 arenas (the bf16 body) and the same
    values quantized a page at a time as adoption does, int8 at both
    granularities (the general body, scales fused), each against its
    plain version at the decode limits, timed by graph replay beside its
    bound: each valid position's codes, scales and q read once, o written
    once, over 3.35 TB/s.  No single library call reads int8 pages with
    their scales (``library_ms`` null); ``sdpa_dequantized_ms`` times
    ``scaled_dot_product_attention`` over the dequantized cache laid out
    as a strip, for context."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.serving import kv_cache

    gen = torch.Generator(device="cuda").manual_seed(QUANT_SEED)
    s, hkv, g, d, ps = N_SLOTS, 8, 5, 128, QUANT_PAGE
    pmax = MAX_LEN // ps
    n_pages = 1 + s * pmax
    tab = (torch.randperm(n_pages - 1, device="cuda", generator=gen) + 1
           ).reshape(s, pmax).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((s, hkv, g, d), device="cuda", generator=gen).to(
        torch.bfloat16)
    kb, vb = (torch.randn((n_pages, ps, hkv, d), device="cuda",
                          generator=gen).to(torch.bfloat16) for _ in "kv")
    sc = d ** -0.5
    n_pos = int(lens.sum())
    mask = (torch.arange(pmax * ps, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    q_l = q.reshape(s, hkv * g, 1, d)
    rows["decode_attention_paged_int8"] = {}
    for name, gran in (("bf16", None), ("int8_page", "page"),
                       ("int8_page_head", "page_head")):
        if gran is None:
            k, v, ksc, vsc = kb, vb, None, None
            kv_bytes = n_pos * hkv * d * 2 * 2
        else:
            axes = (1, 2, 3) if gran == "page" else (1, 3)
            sshape = (n_pages, ps) if gran == "page" else (n_pages, ps, hkv)
            (k, ksc), (v, vsc) = (kv_cache.quantize_symmetric(x, axes)
                                  for x in (kb, vb))
            ksc, vsc = (x.expand(-1, ps, hkv if gran == "page_head" else 1, 1)
                        .reshape(sshape).contiguous() for x in (ksc, vsc))
            kv_bytes = n_pos * (hkv * d * 2 + 4 * 2 * (
                hkv if gran == "page_head" else 1))

        def fn(k=k, v=v, ksc=ksc, vsc=vsc):
            return da.decode_attention_paged(q, k, v, tab, lens, ksc, vsc,
                                             scale=sc, pages_per_tile=1)

        def plain(k=k, v=v, ksc=ksc, vsc=vsc):
            return da.decode_attention_paged_plain(
                q, k, v, tab, lens, ksc, vsc, scale=sc, n_t_chunks=pmax)

        got = fn()
        torch.cuda.synchronize()
        r = held(got, plain(), DECODE_BF16_TOL,
                 f"decode_attention_paged {name} at the quant shape")
        check(bool((got[lens == 0] == 0).all()), f"{name}: free slot not 0")
        body = da.kernel_body(q.dtype, k.dtype, d, d, da._row_bytes(k, v))
        check(body == ("bf16" if gran is None else "general"),
              f"{name}: took the {body} body")
        if gran is None:
            kd, vd = kb, vb
        else:
            kd, vd = (kv_cache.dequantize_pages(
                {"k": k, "v": v, "k_scale": ksc, "v_scale": vsc},
                torch.bfloat16)[n] for n in ("k", "v"))
        k_l, v_l = (x[tab.long()].reshape(s, pmax * ps, hkv, d).transpose(1, 2)
                    for x in (kd, vd))
        io_bytes = 2 * q.numel() * 2 + s * pmax * 4 + s * 4
        ops = n_pos * hkv * g * (4 * d + 20 + (2 if gran else 0))
        b_ms, b_by = bound(kv_bytes + io_bytes, ops)
        row = dict(
            ms=graph_ms(torch, fn), eager_ms=cuda_ms(torch, fn),
            plain_ms=cuda_ms(torch, plain, 5), library_ms=None,
            sdpa_dequantized_ms=graph_ms(torch, lambda: (
                F.scaled_dot_product_attention(q_l, k_l, v_l, attn_mask=mask,
                                               enable_gqa=True))),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=r["max_abs_err"],
            body=body, shape=dict(q=list(q.shape), pages=list(k.shape),
                                  scales=None if ksc is None
                                  else list(ksc.shape), pmax=pmax,
                                  lengths=list(lengths)))
        row["bound_share"] = b_ms / row["ms"]
        say("kernel_check", kernel="decode_attention_paged", case=name,
            phase="quant", body=body, **r)
        case = {"bf16": "bf16_body", "int8_page": "main",
                "int8_page_head": "page_head"}[name]
        rows["decode_attention_paged_int8"][case] = row
        say("kernel_time", kernel="decode_attention_paged", case=name,
            phase="quant", bound_us=b_ms * 1e3, **row)
        del k_l, v_l, kd, vd
    del kb, vb


def swap_watch(torch):
    """A ``serve_requests`` hook that times each demotion and promotion
    (the card synchronised before and after) and, after each promotion,
    gathers the slot's restored pages and holds them against the bytes
    its demotion captured (the blob the host store kept).  The events go
    into ``hook.events``: ``(kind, ms, bytes)``, a promotion's with
    whether the bytes were equal."""
    from repro_torch.serving import kv_cache

    events = []

    def hook(eng):
        demote, promote, put = (eng._demote, eng._promote_swapped,
                                eng.host_swap.put)
        blobs = {}

        def put_(rid, blob):
            ok = put(rid, blob)
            if ok:
                blobs[rid] = blob
            return ok

        def demote_(slot):
            rid = eng.slot_owner[slot].rid
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = demote(slot)
            torch.cuda.synchronize()
            if ok:
                events.append(("demote", (time.perf_counter() - t) * 1e3,
                               kv_cache.HostSwapStore.blob_bytes(
                                   blobs[rid])))
            return ok

        def promote_(slot):
            rid = next(iter(eng._swapped))
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = promote(slot)
            torch.cuda.synchronize()
            if ok:
                ms = (time.perf_counter() - t) * 1e3
                n = eng._pages_for(int(eng.pool["lengths"][slot]))
                blob = blobs.pop(rid)
                got = kv_cache.gather_slot(eng.pool,
                                           eng._row(eng._page_row(slot)))
                equal = all(torch.equal(got[k][:, :n].cpu(), blob[k][:, :n])
                            for k in blob)
                events.append(("promote", ms,
                               kv_cache.HostSwapStore.blob_bytes(blob),
                               equal))
            return ok

        eng.host_swap.put = put_
        eng._demote = demote_
        eng._promote_swapped = promote_

    hook.events = events
    return hook


def quant_serving(torch, m, params, prompts) -> tuple[dict, dict]:
    """The three pools (bf16 pages, int8 "page", int8 "page_head"), each
    with the graph step (the main path) and the eager step: tokens,
    launches and every arena leaf (codes and scales; the trash page
    aside) equal; decode ms a step, prefill tok/s, peak GB; int8 against
    bf16 tokens reported (the share of positions that agree, the top-2
    margin at each first difference), not held.  Returns the graph runs
    (tokens, throughput) by pool and the int8 "page" run's launches."""
    from repro_torch.serving.scheduler import Request

    cfg = m.cfg

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(prompts)]

    runs = {}
    for name, pd, gran in QUANT_POOLS:
        kname = "decode_attention_paged" + ("_int8" if pd else "")
        out = {}
        for fused in (True, False):
            state = {}
            toks, st = serve_requests(
                torch, m, params, reqs(), state=state, slots=N_SLOTS,
                max_len=MAX_LEN, seed=3, temperature=0.0, fused=fused,
                page_dtype=pd, scale_granularity=gran)
            check(all(len(t) == NEW_TOKENS for t in toks),
                  f"quant {name}: token counts")
            check(st["launches"][kname] == cfg.n_layers * st["steps"]
                  and st["launches"]["twopass_softmax_2d"] > 0,
                  f"quant {name}: launches {st['launches']}")
            check(pd is None or st["launches"]["decode_attention_paged"] == 0,
                  f"quant {name}: a bf16 launch of kernel 3")
            out[fused] = toks, st, state
        (tg, sg, kg), (te, se, ke) = out[True], out[False]
        check(tg == te, f"quant {name}: graph tokens != eager tokens")
        check(sg["launches"] == se["launches"]
              and sg["launches_per_replay"] == {kname: cfg.n_layers},
              f"quant {name}: graph launches {sg['launches']} "
              f"({sg['launches_per_replay']} a replay) != eager "
              f"{se['launches']}")
        leaves = [k for k in kg if k != "slots"]
        for k in leaves:
            check(torch.equal(kg[k][:, 1:], ke[k][:, 1:]),
                  f"quant {name}: graph {k} != eager")
        say("parity", arch=ARCH, check=f"quant {name}: graph == eager "
            "tokens, launches and arena leaves (trash page aside)",
            equal=True, leaves=leaves,
            launches_per_replay=sg["launches_per_replay"])
        keys = ("decode_ms_per_step", "decode_tok_s", "prefill_tok_s",
                "peak_bytes", "peak_reserved_bytes", "steps", "pages",
                "peak_pages")
        say("quant_serving", arch=ARCH, n_layers=cfg.n_layers, pool=name,
            page_dtype=pd or "bfloat16", scale_granularity=gran,
            graph={k: sg[k] for k in keys}, eager={k: se[k] for k in keys},
            peak_gb=sg["peak_bytes"] / 1e9, capture_s=sg["capture_s"],
            launches=sg["launches"])
        runs[name] = tg, sg
        del out, kg, ke
        gc.collect()
        torch.cuda.empty_cache()
    bf = runs["bf16"][0]
    for name in ("int8_page", "int8_page_head"):
        q8 = runs[name][0]
        agree = sum(a == b for x, y in zip(q8, bf) for a, b in zip(x, y))
        say("parity", arch=ARCH, check=f"quant {name} vs bf16 pages tokens "
            "(reported, not held: bf16 near-ties flip)",
            token_agreement=agree / sum(map(len, bf)),
            requests_equal=sum(x == y for x, y in zip(q8, bf)))
        hold_tokens(torch, m, params, prompts, q8, bf,
                    f"quant {name} vs bf16 pages", tag="quant_mismatch")
    return runs, runs["int8_page"][1]["launches"]


def quant_budget(cfg) -> None:
    """The pool's bytes and pages at one budget (the bf16 pool at full
    provisioning: 8 slots x 13 pages + the trash page): the int8 "page"
    pool holds >= 1.8x its page tokens."""
    from repro_torch.serving import kv_cache

    ps = QUANT_PAGE
    budget = kv_cache.paged_pool_bytes(cfg, N_SLOTS, MAX_LEN, page_size=ps)
    out = {}
    for name, pd, gran in QUANT_POOLS:
        kw = dict(page_size=ps, page_dtype=pd, scale_granularity=gran)
        pages = kv_cache.max_pages_in_budget(cfg, N_SLOTS, MAX_LEN, budget,
                                             **kw)
        out[name] = dict(pages=pages, page_tokens=(pages - 1) * ps,
                         bytes=kv_cache.paged_pool_bytes(
                             cfg, N_SLOTS, MAX_LEN, pages=pages, **kw))
    ratio = out["int8_page"]["page_tokens"] / out["bf16"]["page_tokens"]
    say("quant_budget", arch=ARCH, n_layers=cfg.n_layers, budget=budget,
        ratio_page=ratio, ratio_page_head=(out["int8_page_head"][
            "page_tokens"] / out["bf16"]["page_tokens"]), **out)
    check(ratio >= 1.8, f"quant: int8 pages hold {ratio}x the bf16 tokens")


def quant_swap(torch, m, params, prompts, unpressured) -> None:
    """The same model on an arena that holds the first 8 prompts and not a
    page more (57 of the 105 pages of full provisioning), the prefix cache
    off and the swap tier on: growth must demote.  On bf16 and on int8
    "page" pages, through the graph step: demoted == prefetched > 0,
    nothing preempted, the store empty and every page free at the end,
    each promotion's restored bytes equal to its demotion's captured
    bytes; each demotion's and promotion's ms and MB; tokens against the
    unpressured run reported."""
    from repro_torch.serving.scheduler import Request

    ps = QUANT_PAGE
    pages = 1 + sum(-(-len(p) // ps) for p in prompts[:N_SLOTS])
    grows = sum(-(-(len(p) + NEW_TOKENS - 1) // ps) > -(-len(p) // ps)
                for p in prompts[:N_SLOTS])
    check(grows > 0, "quant swap: no admitted prompt grows a page")
    for name, pd, gran in QUANT_POOLS[:2]:
        watch = swap_watch(torch)
        toks, st = serve_requests(
            torch, m, params, [Request(rid=i, prompt=p,
                                       max_new_tokens=NEW_TOKENS)
                               for i, p in enumerate(prompts)],
            hook=watch, slots=N_SLOTS, max_len=MAX_LEN, seed=3,
            temperature=0.0, pages=pages, prefix_cache=False,
            host_swap_bytes=SWAP_BYTES, page_dtype=pd,
            scale_granularity=gran)
        ev = watch.events
        dem = [e for e in ev if e[0] == "demote"]
        pro = [e for e in ev if e[0] == "promote"]
        want = unpressured[name][0]
        agree = sum(a == b for x, y in zip(toks, want) for a, b in zip(x, y))
        say("quant_swap", arch=ARCH, pool=name, pages=pages,
            full_pages=1 + N_SLOTS * (MAX_LEN // ps), growing_prompts=grows,
            **{k: st[k] for k in ("demoted", "prefetched", "preempted",
                                  "swap_bytes_used", "free_pages",
                                  "decode_ms_per_step", "prefill_tok_s",
                                  "peak_pages")},
            demote_ms=[e[1] for e in dem], demote_mb=[e[2] / 1e6 for e in dem],
            promote_ms=[e[1] for e in pro],
            promote_mb=[e[2] / 1e6 for e in pro],
            restored_equal=[e[3] for e in pro],
            token_agreement_vs_unpressured=agree / sum(map(len, want)),
            requests_equal=sum(x == y for x, y in zip(toks, want)))
        check(st["demoted"] == st["prefetched"] == len(dem) == len(pro) > 0,
              f"quant swap {name}: demoted {st['demoted']}, prefetched "
              f"{st['prefetched']}")
        check(st["preempted"] == 0 and st["swap_bytes_used"] == 0
              and st["free_pages"] == st["pages"],
              f"quant swap {name}: {st}")
        check(all(e[3] for e in pro),
              f"quant swap {name}: restored bytes != captured bytes")
        check(st["launches"]["decode_attention_paged"
                             + ("_int8" if pd else "")] > 0,
              f"quant swap {name}: kernel 3 not launched")


def quant_f32_cut(torch, m, prompts) -> None:
    """Full width, depth cut to 2 layers, float32: over int8 pools at both
    granularities the kernels (eager step) and the plain route give ``==``
    greedy tokens, and every sampled row's logits up to the first decode
    step (the prefills' first tokens, then one step over the int8 pages)
    lie within 1e-4 of the largest logit; and on the swap run's arena
    (float32 and int8 "page" pages) the tokens equal the unpressured
    run's."""
    from repro_torch.models import Model
    from repro_torch.serving.scheduler import Request

    cfg = dataclasses.replace(m.cfg, n_layers=QUANT_LAYERS_F32,
                              dtype="float32")
    model = Model(cfg, m.device)
    plain = Model(dataclasses.replace(cfg, use_kernels=False), m.device)
    params = model.init(seed=1, dtype=torch.float32)

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(prompts)]

    def recorder(store):
        def hook(eng):
            sample = eng._sample

            def rec(logits):
                if len(store) <= N_SLOTS:     # the prefills, then a step
                    store.append(logits[:, :cfg.vocab].float().clone())
                return sample(logits)

            eng._sample = rec
        return hook

    kw = dict(slots=N_SLOTS, max_len=MAX_LEN, seed=3, temperature=0.0,
              fused=False)
    for gran in ("page", "page_head"):
        got, want = [], []
        on, st_on = serve_requests(torch, model, params, reqs(),
                                   hook=recorder(got), page_dtype="int8",
                                   scale_granularity=gran, **kw)
        off, st_off = serve_requests(torch, plain, params, reqs(),
                                     hook=recorder(want), page_dtype="int8",
                                     scale_granularity=gran, **kw)
        worst = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(got, want))
        say("parity", arch=cfg.name, check=f"quant int8 {gran}, float32, "
            f"{QUANT_LAYERS_F32} layers: kernels == plain route tokens; "
            "logits of the prefills and the first decode step",
            tokens_equal=on == off, logits_compared=len(got),
            max_err_over_max_logit=worst, tol=F32_LOGIT_TOL,
            launches=st_on["launches"])
        check(on == off, f"quant f32 {gran}: kernel tokens != plain tokens")
        check(len(got) == len(want) == N_SLOTS + 1 and worst <= F32_LOGIT_TOL,
              f"quant f32 {gran}: logits {worst}")
        check(st_on["launches"]["decode_attention_paged_int8"] > 0
              and sum(st_off["launches"].values()) == 0,
              f"quant f32 {gran}: launches {st_on['launches']} / "
              f"{st_off['launches']}")
    pages = 1 + sum(-(-len(p) // QUANT_PAGE) for p in prompts[:N_SLOTS])
    for pd in (None, "int8"):
        kw = dict(slots=N_SLOTS, max_len=MAX_LEN, seed=3, temperature=0.0,
                  prefix_cache=False, page_dtype=pd)
        roomy, _ = serve_requests(torch, model, params, reqs(), **kw)
        tight, st = serve_requests(torch, model, params, reqs(), pages=pages,
                                   host_swap_bytes=SWAP_BYTES, **kw)
        say("parity", arch=cfg.name, check=f"quant swap, float32 "
            f"{pd or 'float32'} pages, {QUANT_LAYERS_F32} layers: {pages} "
            "pages == full provisioning tokens", equal=tight == roomy,
            demoted=st["demoted"], prefetched=st["prefetched"],
            preempted=st["preempted"])
        check(tight == roomy, f"quant swap f32 {pd}: tokens != unpressured")
        check(st["demoted"] == st["prefetched"] > 0 and st["preempted"] == 0,
              f"quant swap f32 {pd}: {st}")
    del model, plain, params
    gc.collect()
    torch.cuda.empty_cache()


def quant_phase(torch, rows, n_layers: int) -> dict:
    """Phase 19: qwen2.5-14b at full width, ``n_layers`` deep, served from
    int8 pages at both granularities through the CUDA-graph step, and
    under page pressure with the host-RAM swap tier (see the module's
    docstring).  Returns the main path's launches of kernel 3 over int8
    arenas (the int8 "page" graph run)."""
    from repro_torch.models import build_model

    rng = np.random.default_rng(QUANT_SEED)
    m = build_model(ARCH, n_layers=n_layers, use_kernels=True)
    cfg = m.cfg
    params = m.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    plens = rng.integers(200, 1501, N_REQ)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab, n))
               for n in plens]
    say("quant_config", arch=ARCH, n_layers=cfg.n_layers, slots=N_SLOTS,
        max_len=MAX_LEN, requests=N_REQ, new_tokens=NEW_TOKENS,
        prompt_lens=plens.tolist())
    quant_kernel_checks(torch, rows,
                        [int(p) + NEW_TOKENS - 1 for p in plens[:N_SLOTS]])
    quant_budget(cfg)
    runs, launches = quant_serving(torch, m, params, prompts)
    quant_swap(torch, m, params, prompts, runs)
    del m, params, runs
    gc.collect()
    torch.cuda.empty_cache()
    quant_f32_cut(torch, build_model(ARCH, n_layers=QUANT_LAYERS_F32,
                                     use_kernels=True), prompts)
    return {"decode_attention_paged_int8":
            launches["decode_attention_paged_int8"]}


# ---------------------------------------------------------------------------
# Phase 20: the block-shape autotuner.
# ---------------------------------------------------------------------------
TUNE_SEED = 33
TUNE_CACHE = ROOT / "build" / "chip_smoke_autotune.json"
# (op, rows, cols, dtype): the reference's DEFAULT_SWEEP rows that reach a
# CUDA kernel, the served buckets (qwen2.5-14b's 8 slots x 1,664
# positions, its 8 KV heads) and the LM-head at the train phase's loss
# chunk
TUNE_SWEEP = (
    ("decode_attention", 8, 4096, "bfloat16"),
    ("decode_attention", 8, 4096, "float32"),
    ("decode_attention_paged", 8, 4096, "bfloat16"),
    ("decode_attention_paged", 8, 4096, "float32"),
    ("kv_page_quant", 2, 4096, "int8"),
    ("lmhead_xent", 128, 4096, "float32"),
    ("decode_attention", N_SLOTS, MAX_LEN, "bfloat16"),
    ("decode_attention_paged", N_SLOTS, MAX_LEN, "bfloat16"),
    ("kv_page", 1, MAX_LEN, "bfloat16"),
    ("kv_page_quant", N_SLOTS, MAX_LEN, "int8"),
    ("lmhead_xent", LMHEAD_TRAIN[0], LMHEAD_TRAIN[2], "bfloat16"),
)
TUNE_PAGE_MAX = 512          # the kv_page envelope: pages longer than a tile


def tune_sweeps(torch, smi) -> dict:
    """Each row of ``TUNE_SWEEP`` swept by ``autotune.autotune_op`` on the
    card into ``TUNE_CACHE`` (emptied first): its timing table (µs a call,
    each call ending in a synchronize, the reference's protocol), the
    candidates refused before any launch, the best, the heuristic's block
    and the speedup, beside the card's name and power limit."""
    from repro_torch.kernels import autotune

    TUNE_CACHE.parent.mkdir(parents=True, exist_ok=True)
    TUNE_CACHE.unlink(missing_ok=True)
    out = {}
    for op, rows, cols, dt in TUNE_SWEEP:
        t = time.perf_counter()
        r = autotune.autotune_op(op, rows, cols, getattr(torch, dt),
                                 cache_file=str(TUNE_CACHE))
        out[op, rows, cols, dt] = r
        say("tune_sweep", op=op, rows=rows, cols=cols, dtype=r.dtype,
            key=r.cache_key,
            timings_us={f"{br}x{bc}": s * 1e6
                        for (br, bc), s in sorted(r.timings.items())},
            refused={f"{br}x{bc}": why
                     for (br, bc), why in r.refused.items()},
            best=list(r.best), best_us=r.best_s * 1e6,
            default=list(r.default), default_us=r.default_s * 1e6,
            speedup=r.speedup, seconds=time.perf_counter() - t, card=smi)
    return out


def tuned_blocks(torch, cfg, *, page_dtype=None) -> dict:
    """What the served engine resolves under ``cfg``'s policy at qwen's
    bucket (8 slots, ``MAX_LEN``, bf16 q): page size (and granularity for
    int8 pages), the paged kernel's pages a tile and tile, the strip
    kernel's tile."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.serving import kv_cache

    gran = None
    if page_dtype is None:
        ps = kv_cache.resolve_page_size(cfg, MAX_LEN, device="cuda")
    else:
        ps, gran = kv_cache.resolve_page_quant(cfg, MAX_LEN, device="cuda")
    pol = cfg.softmax_policy()
    pmax = -(-MAX_LEN // ps)
    _, bt = pol.resolve_blocks("decode_attention_paged", N_SLOTS, pmax * ps,
                               torch.bfloat16, backend="gpu")
    _, bs = pol.resolve_blocks("decode_attention", N_SLOTS, MAX_LEN,
                               torch.bfloat16, backend="gpu")
    ppt = min(max(1, bt // ps), pmax, da.MAX_PAGES_PER_TILE)
    return dict(page_size=ps, scale_granularity=gran, pages_per_tile=ppt,
                paged_tile=min(ppt * ps, da.MAX_TILE),
                strip_tile=min(bs, da.MAX_TILE))


def served_decode_case(torch, case, lengths, *, ps, ppt, strip_tile=None,
                       gran=None, seed=TUNE_SEED) -> dict:
    """Kernel 3 at the served shape (q [8, 8, 5, 128] bf16) over seeded
    pages of ``ps`` tokens behind a shuffled table, ``ppt`` pages a tile
    (bf16 pages, or int8 at ``gran`` with the scales fused), and, with
    ``strip_tile``, kernel 4 over the same cache laid out as a strip:
    each against its plain version at the decode limits, strip bit-equal
    to paged where the two tiles coincide; each timed by graph replay
    beside its bound."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.serving import kv_cache

    gen = torch.Generator(device="cuda").manual_seed(seed)
    s, hkv, g, d = N_SLOTS, 8, 5, 128
    pmax = -(-MAX_LEN // ps)
    n_pages = 1 + s * pmax
    tab = (torch.randperm(n_pages - 1, device="cuda", generator=gen) + 1
           ).reshape(s, pmax).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((s, hkv, g, d), device="cuda", generator=gen).to(
        torch.bfloat16)
    kb, vb = (torch.randn((n_pages, ps, hkv, d), device="cuda",
                          generator=gen).to(torch.bfloat16) for _ in "kv")
    k, v, ksc, vsc = kb, vb, None, None
    if gran is not None:
        axes = (1, 2, 3) if gran == "page" else (1, 3)
        (k, ksc), (v, vsc) = (kv_cache.quantize_symmetric(x, axes)
                              for x in (kb, vb))
        ksc, vsc = (x.expand(-1, ps, hkv if gran == "page_head" else 1, 1)
                    .reshape((n_pages, ps, hkv) if gran == "page_head"
                             else (n_pages, ps)).contiguous()
                    for x in (ksc, vsc))
    sc = d ** -0.5
    n_pos = int(lens.sum())
    kv_bytes = n_pos * hkv * d * 2 * (1 if gran else 2) + (
        n_pos * 4 * 2 * (hkv if gran == "page_head" else 1) if gran else 0)
    b_ms, b_by = bound(kv_bytes + 2 * q.numel() * 2 + s * pmax * 4 + s * 4,
                       n_pos * hkv * g * (4 * d + 20 + (2 if gran else 0)))

    def paged():
        return da.decode_attention_paged(q, k, v, tab, lens, ksc, vsc,
                                         scale=sc, pages_per_tile=ppt)

    got = paged()
    torch.cuda.synchronize()
    tile = min(ppt * ps, da.MAX_TILE)
    r = held(got, da.decode_attention_paged_plain(
        q, k, v, tab, lens, ksc, vsc, scale=sc,
        n_t_chunks=-(-pmax // ppt)), DECODE_BF16_TOL,
        f"decode_attention_paged {case}")
    out = dict(page_size=ps, pages_per_tile=ppt, tile=tile,
               scale_granularity=gran, paged_ms=graph_ms(torch, paged),
               bound_ms=b_ms, bound_by=b_by, paged=r)
    if strip_tile is not None:
        ks, vs = (x[tab.long()].reshape(s, pmax * ps, hkv, d).transpose(1, 2)
                  for x in (kb, vb))

        def strip():
            return da.decode_attention(q, ks, vs, lens, scale=sc,
                                       block_t=strip_tile)

        st = strip()
        torch.cuda.synchronize()
        out["strip"] = held(st, da.decode_attention_plain(
            q, ks, vs, lens, scale=sc,
            n_t_chunks=-(-pmax * ps // strip_tile)), DECODE_BF16_TOL,
            f"decode_attention {case}")
        out.update(strip_tile=strip_tile, strip_ms=graph_ms(torch, strip))
        if strip_tile == tile:
            check(torch.equal(st, got), f"{case}: strip != paged bits at "
                  f"one tile of {tile}")
            out["strip_equals_paged"] = True
    say("tune_kernel_check", case=case, **out)
    return out


def tune_kernel_checks(torch, sweeps, blocks, lengths) -> None:
    """Each tuned block held against its plain version: the decode sweeps'
    best at their own inputs; kernels 3 and 4 at the served shape under
    the tuned blocks and the heuristic's (times side by side), over int8
    pages at the tuned layout, and over 512-token pages (bf16 and int8);
    the LM-head forward and backward at the train chunk at the best
    ``block_v`` within ``lmhead_limits``, the backward timed at it and at
    ``LMHEAD_BLOCK_V``."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import twopass_xent as xe

    dev = torch.device("cuda")
    for (op, rows, cols, dt), res in sweeps.items():
        if op not in autotune.DECODE_OPS:
            continue
        x = autotune._inputs_for(op, rows, cols, getattr(torch, dt), dev)
        got = autotune._runner_for(op)(x, *res.best)
        torch.cuda.synchronize()
        q = x[0]
        if op == "decode_attention":
            tile = min(res.best[1], da.MAX_TILE)
            want = da.decode_attention_plain(
                *x, scale=q.shape[-1] ** -0.5,
                n_t_chunks=-(-x[1].shape[2] // tile))
        else:
            pmax = x[3].shape[1]
            ppt = min(max(1, res.best[1] // x[1].shape[1]), pmax,
                      da.MAX_PAGES_PER_TILE)
            want = da.decode_attention_paged_plain(
                *x, scale=q.shape[-1] ** -0.5, n_t_chunks=-(-pmax // ppt))
        tol = (DECODE_BF16_TOL if dt == "bfloat16"
               else dict(atol=1e-5, rtol=0.0))
        r = held(got, want, tol, f"{op} {rows}x{cols} {dt} at {res.best}")
        say("tune_kernel_check", case=f"{op} {rows}x{cols} {dt}",
            block=list(res.best), **r)
    t, u, q8 = blocks["tuned"], blocks["untuned"], blocks["tuned_int8"]
    tuned = served_decode_case(torch, "served, tuned blocks", lengths,
                               ps=t["page_size"], ppt=t["pages_per_tile"],
                               strip_tile=t["strip_tile"])
    base = served_decode_case(torch, "served, heuristic blocks", lengths,
                              ps=u["page_size"], ppt=u["pages_per_tile"],
                              strip_tile=u["strip_tile"])
    say("tune_kernel_time", case="served q [8, 8, 5, 128] bf16",
        paged_ms=dict(tuned=tuned["paged_ms"], heuristic=base["paged_ms"]),
        strip_ms=dict(tuned=tuned["strip_ms"], heuristic=base["strip_ms"]),
        bound_ms=dict(tuned=tuned["bound_ms"], heuristic=base["bound_ms"]))
    served_decode_case(torch, "served, tuned int8 layout", lengths,
                       ps=q8["page_size"], ppt=q8["pages_per_tile"],
                       gran=q8["scale_granularity"])
    for gran in (None, "page"):
        served_decode_case(torch, f"served, {TUNE_PAGE_MAX}-token pages, "
                           f"{gran or 'bf16'}", lengths, ps=TUNE_PAGE_MAX,
                           ppt=1, gran=gran,
                           strip_tile=None if gran else da.MAX_TILE)

    bv = sweeps["lmhead_xent", LMHEAD_TRAIN[0], LMHEAD_TRAIN[2],
                "bfloat16"].best[1]
    h, w, lab, dl = lmhead_inputs(torch, LMHEAD_TRAIN, torch.bfloat16)
    nch = xe.lmhead_v_chunks(w.shape[1], bv)
    loss, m, n = xe.lmhead_xent_fwd_2d(h, w, lab, block_v=bv)
    torch.cuda.synchronize()
    pl, pm, pn = xe.lmhead_xent_fwd_2d_plain(h, w, lab, nch)
    args = (h, w, lab, pm, pn, dl)
    lim = lmhead_limits(torch, h, w, lab, dl, pm, pn, pl)
    dh, dw = xe.lmhead_xent_bwd_2d(*args, block_v=bv)
    torch.cuda.synchronize()
    pdh, pdw = xe.lmhead_xent_bwd_2d_plain(*args, nch)
    res = {}
    for what, got, want in (("loss", loss, pl), ("dh", dh, pdh),
                            ("dw", dw, pdw)):
        d = (got.float() - want.float()).abs()
        res[what] = dict(max_abs_err=float(d.max()),
                         worst_err_over_limit=float((d / lim[what]).max()))
        check(res[what]["worst_err_over_limit"] <= 1.0,
              f"lmhead at block_v {bv} {what}: {res[what]}")
    del lim, pdh, pdw, dh, dw
    times = {b: cuda_ms(torch, lambda b=b: xe.lmhead_xent_bwd_2d(
        *args, block_v=b), 10) for b in sorted({bv, LMHEAD_BLOCK_V})}
    say("tune_kernel_check", case="lmhead_xent train chunk bf16, tuned "
        "block_v", shape=list(LMHEAD_TRAIN), block_v=bv,
        slabs=-(-w.shape[1] // bv), tol="lmhead_limits", **res,
        fused_backward_ms={str(b): ms for b, ms in times.items()})
    del h, w, args, pm, pn, pl
    torch.cuda.empty_cache()


def forced_logits(torch, m, params, prompts, toks, *, buckets, tile):
    """Logits [n, NEW_TOKENS, V] of each request fed its tokens ``toks``:
    the prefill padded to its bucket in ``buckets`` (as the engine pads
    it), adopted into a strip pool of ``N_SLOTS`` slots (groups of 8
    requests, as the engine's steps), then the decode steps with the strip
    kernel at ``tile``, which folds as the paged kernel at that tile."""
    from repro_torch.serving import engine, kv_cache

    cfg = dataclasses.replace(m.cfg, attn_block_k=tile)
    v = cfg.vocab
    out = []
    for g0 in range(0, len(toks), N_SLOTS):
        idx = range(g0, min(len(toks), g0 + N_SLOTS))
        pool = kv_cache.init_slot_pool(cfg, N_SLOTS, MAX_LEN, device="cuda")
        first = []
        for s, i in enumerate(idx):
            p = prompts[i]
            b = next(x for x in buckets if x >= len(p))
            padded = torch.zeros((1, b), dtype=torch.int64)
            padded[0, :len(p)] = torch.tensor(p)
            lg, cache = engine.prefill(params, padded.to("cuda"), cfg=m.cfg,
                                       max_len=b, last_pos=len(p) - 1)
            first.append(lg[0, :v].float())
            kv_cache.adopt_slot(pool, cache, s, len(p))
            del cache
        rows = [torch.stack(first)]
        forced = torch.zeros((N_SLOTS, NEW_TOKENS), dtype=torch.int64,
                             device="cuda")
        forced[:len(idx)] = torch.tensor([toks[i] for i in idx])
        for j in range(NEW_TOKENS - 1):
            lg, _ = engine.decode_step_ragged(params, pool, forced[:, j],
                                              cfg=cfg)
            rows.append(lg[:len(idx), :v].float())
        out.append(torch.stack(rows, 1))
        del pool
    torch.cuda.empty_cache()
    return torch.cat(out)


def hold_by_margin(torch, what, want, got) -> dict:
    """``got`` against ``want`` (two served runs, each a (model, params,
    prompts, tokens, buckets, tile)) by the margin rule of the swa and moe
    phases: both fed ``want``'s tokens (:func:`forced_logits`), their
    argmaxes agree wherever ``want``'s top-2 margin exceeds twice the
    largest logit difference between them, and ``got``'s tokens leave
    ``want``'s only at a position the rule does not decide."""
    (mw, pw, prompts, tw, bw, tl_w), (mg, _, _, tg, bg, tl_g) = want, got
    lw = forced_logits(torch, mw, pw, prompts, tw, buckets=bw, tile=tl_w)
    lg = forced_logits(torch, mg, pw, prompts, tw, buckets=bg, tile=tl_g)
    abs_err = float((lw - lg).abs().max())
    top2 = lw.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    decided = margin > 2 * abs_err
    same = lw.argmax(-1) == lg.argmax(-1)
    first = [next((j for j in range(NEW_TOKENS) if a[j] != b[j]), None)
             for a, b in zip(tw, tg)]
    bad = [(i, j) for i, j in enumerate(first)
           if j is not None and bool(decided[i, j])]
    out = dict(logits_max_abs_err=abs_err,
               logits_max_err_over_max_logit=abs_err / float(
                   lw.abs().max()),
               positions=int(decided.numel()),
               decided=int(decided.sum()),
               argmax_equal_where_decided=bool(same[decided].all()),
               first_divergence=first,
               margins_at_divergence=[
                   None if j is None else float(margin[i, j])
                   for i, j in enumerate(first)],
               served_tokens_equal=sum(a == b for x, y in zip(tw, tg)
                                       for a, b in zip(x, y)),
               served_tokens=sum(map(len, tw)),
               rule="== where the top-2 margin exceeds 2 x the largest "
                    "logit difference, both fed the same tokens")
    say("tune_margin", check=what, **out)
    check(out["argmax_equal_where_decided"],
          f"{what}: argmax differs at a top-2 margin above 2 x {abs_err}")
    check(not bad, f"{what}: tokens differ at decided positions {bad}")
    del lw, lg
    torch.cuda.empty_cache()
    return out


def tune_serving(torch, mt, mu, params, prompts, smi) -> dict:
    """qwen2.5-14b through ``ContinuousBatchingEngine(paged=True,
    use_kernels=True)``: from the tuned cache (``softmax_autotune=True``)
    with the graph step (the main path) and the eager step, the strip pool
    and int8 pages (page size and granularity from the cache); and with
    the heuristic's blocks.  Held: tuned graph == eager (tokens and
    launches); strip == paged where their tiles coincide, tuned ==
    untuned where tile and page coincide, else the margin rule.  Returns
    the main path's launches."""
    from repro_torch.serving.scheduler import Request

    cfg = mt.cfg

    def reqs():
        return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(prompts)]

    runs = {}
    plan = (("tuned paged graph", mt, dict(fused=True)),
            ("tuned paged eager", mt, dict(fused=False)),
            ("tuned strip graph", mt, dict(paged=False)),
            ("untuned paged graph", mu, dict(fused=True)),
            ("tuned int8 graph", mt, dict(page_dtype="int8")))
    for name, model, kw in plan:
        kw = dict(dict(paged=True, fused=True), **kw)
        toks, st = serve_requests(torch, model, params, reqs(),
                                  slots=N_SLOTS, max_len=MAX_LEN, seed=3,
                                  temperature=0.0, **kw)
        blocks = tuned_blocks(torch, model.cfg,
                              page_dtype=kw.get("page_dtype"))
        kname = ("decode_attention" if not kw["paged"] else
                 "decode_attention_paged" + ("_int8" if "page_dtype" in kw
                                             else ""))
        check(all(len(x) == NEW_TOKENS for x in toks),
              f"tune {name}: token counts")
        check(st["launches"][kname] == cfg.n_layers * st["steps"]
              and st["launches"]["twopass_softmax_2d"] > 0,
              f"tune {name}: launches {st['launches']}")
        if kw["paged"]:
            check(st["page_size"] == blocks["page_size"],
                  f"tune {name}: page size {st['page_size']} != "
                  f"{blocks['page_size']}")
        keys = ("decode_ms_per_step", "decode_tok_s", "prefill_tok_s",
                "peak_bytes", "steps", "bucketed")
        say("tune_serving", run=name, arch=ARCH, n_layers=cfg.n_layers,
            autotune=model.cfg.softmax_autotune, **blocks,
            **{k: st.get(k) for k in keys}, launches=st["launches"],
            launches_per_replay=st.get("launches_per_replay"), card=smi)
        runs[name] = toks, st, blocks
    (tg, sg, bt), (te, se, _) = (runs["tuned paged graph"],
                                 runs["tuned paged eager"])
    check(tg == te, "tune: graph tokens != eager tokens under tuned blocks")
    check(sg["launches"] == se["launches"] and sg["launches_per_replay"]
          == {"decode_attention_paged": cfg.n_layers},
          f"tune: graph launches {sg['launches']} != eager "
          f"{se['launches']}")
    say("parity", arch=ARCH, check="tune: tuned graph == eager tokens and "
        "launches", equal=True)

    ts = runs["tuned strip graph"][0]
    if bt["strip_tile"] == bt["paged_tile"]:
        check(ts == tg, "tune: strip != paged tokens at one tile")
        say("parity", arch=ARCH, check="tune: strip == paged tokens (tiles "
            f"coincide at {bt['paged_tile']})", equal=True)
    else:
        hold_by_margin(torch, "tune: strip vs paged, tiles "
                       f"{bt['strip_tile']} / {bt['paged_tile']}",
                       (mt, params, prompts, tg, sg["buckets"],
                        bt["paged_tile"]),
                       (mt, params, prompts, ts, sg["buckets"],
                        bt["strip_tile"]))
    tu, su, bu = runs["untuned paged graph"]
    # the margin rule always runs here: where page and tile coincide the
    # two forced runs must give equal logits and the served tokens ==
    same = (bu["page_size"], bu["paged_tile"]) == (bt["page_size"],
                                                   bt["paged_tile"])
    rule = hold_by_margin(
        torch, f"tune: tuned (page {bt['page_size']}, tile "
        f"{bt['paged_tile']}) vs untuned (page {bu['page_size']}, tile "
        f"{bu['paged_tile']})",
        (mu, params, prompts, tu, su["buckets"], bu["paged_tile"]),
        (mt, params, prompts, tg, sg["buckets"], bt["paged_tile"]))
    if same:
        check(tu == tg and rule["logits_max_abs_err"] == 0.0,
              "tune: tuned != untuned at one page and tile")
        say("parity", arch=ARCH, check="tune: tuned == untuned tokens "
            "(page and tile coincide)", equal=True)
    t8, s8, b8 = runs["tuned int8 graph"]
    agree = sum(a == b for x, y in zip(t8, tg) for a, b in zip(x, y))
    say("parity", arch=ARCH, check="tune: int8 pages (tuned layout) vs "
        "bf16 pages tokens (reported, not held, as the quant phase does)",
        token_agreement=agree / sum(map(len, tg)),
        page_size=s8["page_size"], scale_granularity=s8.get(
            "scale_granularity"))
    check(s8.get("scale_granularity") == b8["scale_granularity"],
          f"tune: int8 granularity {s8.get('scale_granularity')}")
    launches = dict(sg["launches"])
    launches["decode_attention"] = runs["tuned strip graph"][1][
        "launches"]["decode_attention"]
    launches["decode_attention_paged_int8"] = s8["launches"][
        "decode_attention_paged_int8"]
    return launches


def tune_phase(torch, n_layers: int, smi: str) -> dict:
    """Phase 20: the block-shape autotuner on the card.  (a) The sweeps of
    ``TUNE_SWEEP`` into ``TUNE_CACHE``; (b) each tuned block held against
    its plain version; (c) qwen2.5-14b at full width, ``n_layers`` deep,
    served from the tuned cache and with the heuristic's blocks (see
    :func:`tune_serving`).  Every other phase keeps ``softmax_autotune``
    off.  Returns the main path's launches (the tuned graph run, its strip
    and int8 runs)."""
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    sweeps = tune_sweeps(torch, smi)
    say("tune_sweeps_done", seconds=time.perf_counter() - t0)
    mt = build_model(ARCH, n_layers=n_layers, use_kernels=True,
                     softmax_autotune=True,
                     softmax_autotune_cache=str(TUNE_CACHE))
    mu = build_model(ARCH, n_layers=n_layers, use_kernels=True)
    blocks = {"tuned": tuned_blocks(torch, mt.cfg),
              "untuned": tuned_blocks(torch, mu.cfg),
              "tuned_int8": tuned_blocks(torch, mt.cfg, page_dtype="int8")}
    say("tune_blocks", arch=ARCH, n_layers=n_layers, **blocks)
    rng = np.random.default_rng(TUNE_SEED)
    plens = rng.integers(200, 1501, N_REQ)
    prompts = [tuple(int(t) for t in rng.integers(0, mt.cfg.vocab, n))
               for n in plens]
    tune_kernel_checks(torch, sweeps, blocks,
                       [int(p) + NEW_TOKENS - 1 for p in plens[:N_SLOTS]])
    say("tune_kernels_done", seconds=time.perf_counter() - t0)
    params = mt.init(seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = tune_serving(torch, mt, mu, params, prompts, smi)
    del params, mt, mu
    gc.collect()
    torch.cuda.empty_cache()
    say("tune_phase", seconds=time.perf_counter() - t0, card=smi)
    return launches


# ---------------------------------------------------------------------------
# Phase 21: training every family but dense at full width.
# ---------------------------------------------------------------------------
# arch: (depth cut or None, batch, SyntheticLM seq_len)
FAM_TRAIN = {
    # 8 x (1,500 frames, 448 decoder tokens): 6 + 6 layers
    "whisper-base": (None, 8, 1500),
    # 1 x 4,096: 4,095 positions in 32 WKV6 chunks of 128 (the reference's
    # plan: at least 4,095 / 32 a chunk), 4 of its 24 layers: at 24 a
    # step takes 4.7 s and the phase 158 s of the script's time limit
    "rwkv6-1.6b": (4, 1, 4096),
    # 1 x (256 patches + 3,840 tokens), 4 of its 28 layers: 7.6 G float32
    # parameters at 16 bytes each (parameter, gradient, two moments) are
    # 122 GB, past the card's 80
    "qwen2-vl-7b": (4, 1, 4096),
    # 1 x 4,096: 4x the window of 1,024, 16 of its 32 layers (the
    # script's time limit)
    "hymba-1.5b": (16, 1, 4096),
    # 1 x 4,096: one dispatch group of 4,095 tokens (no multiple of
    # 2,048), capacity int(4095 * 8 * 1.25 / 40) = 1,023; 8 of its 32
    # layers (the script's time limit; 1.76 G float32 parameters and 28.2
    # GB of state at 16, 54.0 GB at all 32, before activations)
    "granite-moe-3b-a800m": (8, 1, 4096),
    # 1 x 4,096, capacity int(4095 * 6 * 1.25 / 64) = 479; 4 of its 27
    # layers: 2.76 G parameters, 44.1 GB of state, and the parity step's
    # second gradient set (all 27 would need 259 GB)
    "deepseek-v2-lite-16b": (4, 1, 4096),
}
FAM_STEPS = 3
# the kernels a family's train step launches: flash, the LM-head CE and
# (a moe router) the two-pass softmax
FAM_KERNELS = TRAIN_KERNELS + ("twopass_softmax_2d",)
# a moe step's traced groups: (module of repro_torch.models, function,
# group); each function runs inside a host range named after its group,
# the innermost range names a kernel's group, and a backward kernel
# takes its forward op's.  moe_apply's own ops are the impl's queue and
# its dispatch and combine products; layers.mlp is only the shared
# expert in a moe model.
MOE_GROUPS = (("moe", "moe_apply", "moe dispatch and combine (queue, "
                                   "one-hot products)"),
              ("moe", "_router", "moe router (float32 logits, softmax, "
                                 "top k)"),
              ("moe", "_experts", "moe experts (batched SwiGLU products)"),
              ("layers", "mlp", "moe shared experts (SwiGLU MLP)"))
MOE_BLOCK = "transformer block"     # a range around transformer.block_apply
# the ranges' own spans on the device timeline (a trace of the CPU too
# gives each host range a device annotation): not kernels
MOE_RANGES = {g for _, _, g in MOE_GROUPS} | {MOE_BLOCK}
# bf16 ops a block's backward rounds the gradient in: two norms, the
# attention's or mixer's four products and the MLP's three, their
# elementwise neighbours (activation, gates, softmax or scan) and the two
# residual adds (a moe block's count: block_roundings)
BLOCK_ROUNDINGS = 16
# per family: the leaves whose gradients are held, kernel route vs plain
FAM_GRADS = {
    "whisper-base": {"lm_head.w": ("lm_head", "w"),
                     "embed.table": ("embed", "table"),
                     "blocks.xattn.wq.w": ("blocks", "xattn", "wq", "w"),
                     "enc_blocks.attn.wq.w": ("enc_blocks", "attn", "wq",
                                              "w")},
    "rwkv6-1.6b": {"lm_head.w": ("lm_head", "w"),
                   "embed.table": ("embed", "table"),
                   "blocks.w0 (time-mix decay)": ("blocks", "w0"),
                   "blocks.wk.w": ("blocks", "wk", "w")},
    "qwen2-vl-7b": {"lm_head.w": ("lm_head", "w"),
                    "embed.table": ("embed", "table"),
                    "blocks.attn.wq.w": ("blocks", "attn", "wq", "w"),
                    "patch_proj.w": ("patch_proj", "w")},
    "hymba-1.5b": {"lm_head.w": ("lm_head", "w"),
                   "embed.table": ("embed", "table"),
                   "blocks.attn.wq.w": ("blocks", "attn", "wq", "w"),
                   "blocks.mamba.a_log": ("blocks", "mamba", "a_log")},
    "granite-moe-3b-a800m": {
        "lm_head.w": ("lm_head", "w"),
        "embed.table": ("embed", "table"),
        "blocks.attn.wq.w": ("blocks", "attn", "wq", "w"),
        "blocks.mlp.router.w (float32)": ("blocks", "mlp", "router", "w"),
        "blocks.mlp.wg (experts)": ("blocks", "mlp", "wg")},
    "deepseek-v2-lite-16b": {
        "lm_head.w": ("lm_head", "w"),
        "embed.table": ("embed", "table"),
        "blocks.attn.wkv_b.w (latent up-projection)": ("blocks", "attn",
                                                       "wkv_b", "w"),
        "blocks.mlp.router.w (float32)": ("blocks", "mlp", "router", "w"),
        "blocks.mlp.wg (experts)": ("blocks", "mlp", "wg")},
}
# kernels 12-13 at the shapes the families' train steps give them,
# depth-free (batch 1): bf16, so the mma.sync kernels, timed (deepseek's
# with dq and dk/dv apart); whisper's two non-causal shapes also in
# float32 (the wmma / FFMA kernels), held only.  The decoder's 447 and the
# others' 4,095 positions are the label positions (the last token has
# none); 4,095 = 256 patches + 3,839 for qwen2-vl.
FAM_FLASH = {
    "whisper_encoder": (1, 8, 8, 1500, 1500, 64, False, None, "bfloat16"),
    "whisper_cross": (1, 8, 8, 447, 1500, 64, False, None, "bfloat16"),
    "whisper_encoder_f32": (1, 8, 8, 1500, 1500, 64, False, None,
                            "float32"),
    "whisper_cross_f32": (1, 8, 8, 447, 1500, 64, False, None, "float32"),
    "whisper_decoder": (1, 8, 8, 447, 447, 64, True, None, "bfloat16"),
    "qwen2vl_g7": (1, 28, 4, 4095, 4095, 128, True, None, "bfloat16"),
    "hymba_g5_window": (1, 25, 5, 4095, 4095, 64, True, 1024, "bfloat16"),
    # granite-moe: 24 heads over 8; deepseek's MLA: 16 heads of D 128 + 64,
    # Dv 128 (the (192, 128) mma kernels, the backward split)
    "granite_moe_g3": (1, 24, 8, 4095, 4095, 64, True, None, "bfloat16"),
    "deepseek_d192_dv128": (1, 16, 16, 4095, 4095, 192, True, None,
                            "bfloat16", 128),
}
# kernel 1 on the router's float32 rows of one train group: [4095, E]
FAM_ROUTER = {"granite_moe_router_rows_4095": (4095, 40),
              "deepseek_router_rows_4095": (4095, 64)}
# kernels 9-11 at one loss chunk of each step: (T, d, padded vocab); the
# model pads its vocab to a multiple of 128, so the train path's w rows
# are 16-byte aligned (TMA); the configs' own vocabularies 51,865 and
# 32,001 take the kernels' cp.async loads
FAM_LMHEAD = {
    "whisper_chunk": (448, 512, 51968),       # 8 x 56 of 447 positions
    "rwkv6_chunk": (512, 2048, 65536),
    "qwen2vl_chunk": (480, 3584, 152064),     # 480 of the 3,839 text labels
    "hymba_chunk": (512, 1600, 32128),
    "granite_moe_chunk": (512, 1536, 49280),
    "deepseek_chunk": (512, 2048, 102400),
    "whisper_v51865_cp_async": (448, 512, 51865),
    "hymba_v32001_cp_async": (512, 1600, 32001),
}


def attention_calls(cfg) -> int:
    """Attention calls in one forward of the family's loss: the flash
    route's forwards (each again in its layer's remat backward) and
    backwards a step."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":            # encoder, decoder self, cross
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def block_roundings(cfg) -> int:
    """The bf16 ops of one block's backward, by the block's code
    (``transformer.block_apply``).  A block with an MLP has
    ``BLOCK_ROUNDINGS``.  A moe block (``moe.moe_dispatch``, the
    train path's impl) trades the MLP's three products, activation and
    gate (5) for 9: the top-k weights' cast to bf16, the dispatch product
    ``xe``, the experts' three batched products with their activation and
    gate, the combine weights ``comb`` and the combine product.  The
    router's logits and softmax are float32.  A shared expert adds its
    MLP (5) and its add (1).  MLA's attention adds the latent's norm
    ``kv_norm`` (1) to the four products (wq, wkv_a, wkv_b, wo).  So
    granite-moe counts 20 a block and deepseek 27."""
    n = BLOCK_ROUNDINGS
    if cfg.moe is not None:
        n += 9 - 5 + (6 if cfg.moe.n_shared else 0)
    if cfg.mla is not None:
        n += 1
    return n


def family_parity_limits(torch, mk, mp, params, batch, layers_crossed):
    """Limits for the kernel route against the plain route from one state,
    derived from the logits both routes' hidden states give (x_k, x_p,
    float32, their difference dx):

    * the loss: a token's CE = lse(x) - x_label moves by at most twice
      max_v |dx| (lse and the label logit each by max |dx|), so the mean
      by at most 2 mean_t max_v |dx_tv|; the plain route rounds its
      logits to bf16 (lse and the label logit each within 2^-9 max|x|);
      the kernels' float32 sums over d differ from these logits' by at
      most 2 lambda sqrt(d) u (|h| @ |w|) a logit (lmhead_limits); 1e-4
      for the float32 sums over tokens;
    * lm_head.w's gradient, sum_t h_t (p_t - onehot_t) dl: the relative
      norm differences of its two factors add, r_h for the hidden states
      (measured) and r_D for dlogits, plus each route's bf16 rounding of
      the product, 2^-8.  A token's probabilities move relatively by at
      most e^(2 m_t) - 1, m_t = max_v |dx_tv| + 2^-9 max_v |x_tv| (softmax
      moves p_v by e^(+-2 max |dx|); the plain route's bf16 logits), so
      r_D = sqrt(sum_t ((e^(2 m_t) - 1) |p_t|)^2 / sum_t |p_t - onehot_t|^2);
    * every other held leaf: lm_head's limit, plus the bf16 rounding
      noise of the backward through the L blocks it crosses (and the
      head): once the two routes' gradients differ at all, each rounds
      its own, so each of a block's k bf16 ops (:func:`block_roundings`)
      adds an independent relative error of RMS 2^-9 sqrt(2/3) between
      them (two uniform roundings of half a step); in quadrature over
      k (L + 1) ops, times lambda: lambda 2^-9 sqrt(2 k (L + 1) / 3).
    Returns (limits, measurements)."""
    from repro_torch.models import transformer

    u, lam = 2.0 ** -24, ROUND_LAMBDA
    with torch.no_grad():
        hk, lab = transformer.train_hidden(params, batch, cfg=mk.cfg)
        hp, _ = transformer.train_hidden(params, batch, cfg=mp.cfg)
        d = hk.shape[-1]
        hk, hp, lab = hk.reshape(-1, d), hp.reshape(-1, d), lab.reshape(-1)
        w = transformer._head_w(params, mk.cfg).to(hk.dtype).float()
        wa = w.abs()
        r_h = float((hk.float() - hp.float()).norm() / hp.float().norm())
        dmax, ex, dp2, dn2, xmax = [], [], 0.0, 0.0, 0.0
        for lo in range(0, hk.shape[0], 512):
            a, b = hk[lo:lo + 512].float(), hp[lo:lo + 512].float()
            xk, xp = a @ w, b @ w
            dm = (xk - xp).abs().amax(dim=1)
            m_t = dm + 2.0 ** -9 * xp.abs().amax(dim=1)
            p = torch.softmax(xp, dim=1)
            dp2 += float(((torch.expm1(2 * m_t) * p.norm(dim=1)) ** 2).sum())
            p[torch.arange(p.shape[0], device=p.device),
              lab[lo:lo + 512].long()] -= 1.0
            dn2 += float((p.norm(dim=1) ** 2).sum())
            dmax.append(dm)
            xmax = max(xmax, float(xk.abs().max()), float(xp.abs().max()))
            ex.append(2 * lam * d ** 0.5 * u * (a.abs() @ wa).amax(dim=1))
            del xk, xp, p
        dmax, ex = torch.cat(dmax), torch.cat(ex)
        del hk, hp, w, wa
    r_d = math.sqrt(dp2 / dn2)
    loss_lim = (2 * float(dmax.mean()) + 2.0 ** -8 * xmax
                + 2 * float(ex.mean()) + 1e-4)
    lm_lim = r_h + r_d + 2.0 ** -8
    noise = lam * 2.0 ** -9 * math.sqrt(
        2 * block_roundings(mk.cfg) * (layers_crossed + 1) / 3)
    return (dict(loss=loss_lim, lm_head=lm_lim, inner=lm_lim + noise),
            dict(hidden_rel_norm_diff=r_h, dlogits_rel_norm_bound=r_d,
                 max_logit_diff=float(dmax.max()),
                 mean_max_logit_diff=float(dmax.mean()), max_abs_logit=xmax))


def family_train(torch, arch) -> dict:
    """One family's train step at full width (float32 parameters, bf16
    activations, remat): the kernel route (``use_kernels=True``: flash
    attention, fused LM-head CE, a moe router's softmax) against the
    plain route from one state and batch, then three AdamW steps through
    ``Trainer.run`` on the kernel route (a moe model's experts by
    ``dispatch``, the Trainer's impl), each step's launches of kernels 1
    and 9-13 counted, and a traced fourth step.  Returns the launches
    over the three steps."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.training import step_fn
    from repro_torch.training.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    depth, batch, seq = FAM_TRAIN[arch]
    over = {} if depth is None else {"n_layers": depth}
    mk = build_model(arch, use_kernels=True, **over)
    mp = build_model(arch, **over)
    cfg = mk.cfg
    full = get_config(arch)
    check(cfg.use_kernels and cfg.remat and cfg.param_dtype == "float32"
          and cfg.dtype == "bfloat16" and not mp.cfg.use_kernels,
          f"{arch} train config: {cfg}")
    params = mk.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in adamw.leaves(params))
    cell = ShapeCell(f"train_{arch}", seq, batch, "train")
    ds = SyntheticLM(cfg, cell, seed=0)
    batch0 = {k: torch.from_numpy(v).cuda()
              for k, v in ds.batch_at(0).items()}
    # label positions a row: the decoder's, or the text's after the patches
    s_lab = (cfg.dec_len if cfg.family == "encdec"
             else seq - cfg.n_patches) - 1
    labels = batch * s_lab
    chunks = min(8, s_lab)
    att = attention_calls(cfg)
    # a flash forward per attention call, again in its layer's remat
    # backward, one backward per call; one LM-head launch of each kernel
    # per loss chunk; a moe router's softmax once a layer, again in its
    # remat backward (the op's backward launches nothing)
    want = {"flash_attention_fwd_gqa": 2 * att,
            "flash_attention_bwd_gqa": att,
            **dict.fromkeys(LMHEAD, chunks),
            "twopass_softmax_2d": 2 * cfg.n_layers if cfg.moe else 0}
    blocks = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec"
                             else 0)
    reduced = ([] if depth is None else
               [f"n_layers {full.n_layers} -> {depth}"])
    say("family_train_config", arch=arch, family=cfg.family,
        n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers,
        full_depth=full.n_layers, reduced=reduced, d_model=cfg.d_model,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        vocab=cfg.vocab, padded_vocab=cfg.padded_vocab(),
        param_dtype=cfg.param_dtype, dtype=cfg.dtype, remat=cfg.remat,
        params=n_params, state_bytes=16 * n_params,
        batch={k: list(v.shape) for k, v in batch0.items()},
        label_positions=labels, loss_chunks=chunks,
        data="SyntheticLM seed 0", entry="Trainer.run",
        attention_calls=att,
        launches_per_step=want,
        launches_formula="flash fwd 2 x attention calls (remat), bwd 1 x; "
                         "each LM-head kernel once a loss chunk (8); "
                         "two-pass softmax 2 x a moe model's layers "
                         "(router, remat)",
        moe=(None if cfg.moe is None else dict(
            impl="dispatch", experts=cfg.moe.n_experts,
            top_k=cfg.moe.top_k, shared=cfg.moe.n_shared,
            d_expert=cfg.moe.d_expert, group_tokens=s_lab,
            capacity=int(s_lab * cfg.moe.top_k * 1.25
                         / cfg.moe.n_experts))),
        block_roundings=block_roundings(cfg),
        init_s=time.perf_counter() - t0)

    # -- the kernel route against the plain route, same state and batch
    held_paths = FAM_GRADS[arch]
    K.reset_launch_counts()
    t = time.perf_counter()
    lk, gk = step_fn.loss_and_grads(mk, params, batch0)
    torch.cuda.synchronize()
    kern_first_ms = (time.perf_counter() - t) * 1e3
    ck = K.launch_counts()
    held_k = {n: _at(gk, pth) for n, pth in held_paths.items()}
    del gk
    K.reset_launch_counts()
    t = time.perf_counter()
    lp, gp = step_fn.loss_and_grads(mp, params, batch0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cp = K.launch_counts()
    held_p = {n: _at(gp, pth) for n, pth in held_paths.items()}
    del gp
    check(all(ck[k] == want[k] for k in FAM_KERNELS),
          f"{arch} kernel route: launches {want} expected, got "
          f"{ {k: ck[k] for k in FAM_KERNELS} }")
    check(sum(cp.values()) == 0, f"{arch} plain route launched a kernel: "
          f"{ {k: v for k, v in cp.items() if v} }")
    lim, meas = family_parity_limits(torch, mk, mp, params, batch0, blocks)
    check(abs(float(lk) - float(lp)) <= lim["loss"],
          f"{arch} loss kernels {float(lk)} vs plain {float(lp)} beyond "
          f"{lim['loss']}")
    grads = {}
    for name in held_paths:
        a, b = held_k[name], held_p[name]
        check(a.dtype == b.dtype == _at(params, held_paths[name]).dtype,
              f"{arch} grad {name}: dtypes {a.dtype} / {b.dtype}")
        a, b = a.float(), b.float()
        rel = float((a - b).norm() / b.norm())
        li = lim["lm_head"] if name == "lm_head.w" else lim["inner"]
        check(rel <= li and bool(torch.isfinite(a).all()),
              f"{arch} grad {name}: relative norm difference {rel} beyond "
              f"{li}")
        grads[name] = dict(rel_norm_diff=rel, limit=li,
                           dtype=str(held_k[name].dtype),
                           max_abs_err=float((a - b).abs().max()),
                           max_abs=float(b.abs().max()))
    del held_k, held_p
    gc.collect()
    torch.cuda.empty_cache()
    say("family_train_parity", arch=arch,
        check="kernel route vs plain route, same state and batch",
        loss_kernels=float(lk), loss_plain=float(lp),
        loss_abs_diff=abs(float(lk) - float(lp)), loss_limit=lim["loss"],
        grads=grads, limits=lim, **meas,
        limits_note="family_parity_limits: CE's Lipschitz bound in the "
                    "logits, bf16 and float32 roundings; lm_head.w: the "
                    "factors' relative differences; other leaves: plus "
                    "the backward's bf16 rounding noise over the blocks",
        launches_kernel_route={k: ck[k] for k in FAM_KERNELS},
        launches_plain_route=sum(cp.values()),
        loss_and_grads_first_ms={"kernel_route": kern_first_ms,
                                 "plain_route": plain_ms})
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- three steps through Trainer.run on the kernel route (the main
    # path), each step's launches counted
    tcfg = TrainerConfig(steps=FAM_STEPS, peak_lr=3e-4, warmup=100,
                         log_every=1)
    trainer = Trainer(mk, cell, tcfg)
    step = trainer.step
    counts = dict.fromkeys(FAM_KERNELS, 0)
    peaks = []

    def counted(state, b):
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        out = step(state, b)
        torch.cuda.synchronize()
        c = K.launch_counts()
        check(all(c[k] == want[k] for k in FAM_KERNELS),
              f"{arch} step {len(peaks)}: launches {want} expected, got "
              f"{ {k: c[k] for k in FAM_KERNELS} }")
        for k in FAM_KERNELS:
            counts[k] += c[k]
        peaks.append(torch.cuda.max_memory_allocated())
        return out

    trainer.step = counted
    state = trainer.run()
    check(int(state.opt.step) == FAM_STEPS, f"{arch}: optimizer steps")
    hist = trainer.metrics_history
    check([r["step"] for r in hist] == list(range(FAM_STEPS)),
          f"{arch}: steps run {hist}")
    for r, peak in zip(hist, peaks):
        check(math.isfinite(r["loss"]),
              f"{arch} step {r['step']}: loss {r['loss']}")
        say("family_train_step", arch=arch, entry="Trainer.run",
            step=r["step"], loss=r["loss"], ms=r["time_s"] * 1e3,
            tokens_per_s=labels / r["time_s"], peak_bytes=peak)
    first = hist[0]["loss"]
    check(abs(first - math.log(cfg.vocab)) < 1.5,
          f"{arch}: first loss {first} not near ln V = "
          f"{math.log(cfg.vocab)}")
    step_ms = min(r["time_s"] for r in hist[1:]) * 1e3
    train_trace(torch, step, state, ds.batch_at(FAM_STEPS), arch=arch,
                untraced_ms=step_ms, moe=cfg.moe is not None)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    say("family_train", arch=arch, losses=[r["loss"] for r in hist],
        first_loss_minus_ln_v=first - math.log(cfg.vocab),
        first_loss_equals_parity_loss=first == float(lk),
        step_ms=[r["time_s"] * 1e3 for r in hist], peak_bytes=peaks,
        launches=counts, seconds=time.perf_counter() - t0)
    return counts


def family_train_cli() -> None:
    """``python -m repro_torch.launch.train --arch A --reduced --kernels``
    for each family of ``FAM_TRAIN``, all processes at once: each exits 0
    with its final loss, and the attention families launch the flash
    kernels, the moe ones kernel 1 (the router), every family the LM-head
    kernels."""
    import ast

    from repro_torch.configs import get_config

    t = time.perf_counter()
    procs = {a: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", a,
         "--reduced", "--kernels", "--steps", "3"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        for a in FAM_TRAIN}
    for arch, proc in procs.items():
        out, errs = proc.communicate(timeout=300)
        lines = out.splitlines()
        final = [ln for ln in lines if ln.startswith("final: ")]
        launch = [ln for ln in lines if ln.startswith("kernel launches: ")]
        say("family_train_cli", arch=arch, rc=proc.returncode,
            stdout=lines, stderr_tail=errs.splitlines()[-4:])
        check(proc.returncode == 0 and len(final) == len(launch) == 1,
              f"train CLI {arch} exited {proc.returncode}")
        counts = ast.literal_eval(launch[0][len("kernel launches: "):])
        loss = ast.literal_eval(final[0][len("final: "):])["loss"]
        need = LMHEAD + (() if arch == "rwkv6-1.6b" else FLASH) + (
            ("twopass_softmax_2d",) if get_config(arch).moe else ())
        check(all(counts.get(k, 0) > 0 for k in need) and
              math.isfinite(loss),
              f"train CLI {arch}: loss {loss}, launches {counts}")
    say("family_train_cli_done", seconds=time.perf_counter() - t)


def family_train_phase(torch, rows) -> dict:
    """Phase 21: kernels 12-13 at the seven attention shapes the families'
    train steps give them (whisper's non-causal two also in float32),
    kernel 1 on the moe routers' rows of one train group and kernels 9-11
    at each family's loss chunk (and at the configs' unpadded
    vocabularies, the cp.async loads), each against its plain version and
    timed beside its bound; then each family's train step
    (:func:`family_train`) and the train CLI for each.  Returns the
    launches of kernels 1 and 9-13 over the families' steps."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows.setdefault("twopass_softmax_2d", {})
    for key, (r, e) in FAM_ROUTER.items():
        # rms-normed activations over a d**-0.5 router: about unit scale
        x = torch.randn((r, e), device="cuda", generator=gen)
        softmax_rows_check(torch, rows, key, x,
                           f"train router rows [{r}, {e}]")
        del x
    for case, shape in FAM_FLASH.items():
        c = flash_check(torch, case, shape)
        if shape[8] == "bfloat16":
            flash_times(torch, rows, case, c,
                        dq_dkv=case == "deepseek_d192_dv128")
        del c
        torch.cuda.empty_cache()
    for case, shape in FAM_LMHEAD.items():
        c = lmhead_check(torch, case, shape, torch.bfloat16)
        lmhead_times(torch, rows, case, c)
        del c
        torch.cuda.empty_cache()
    say("family_kernels_done", seconds=time.perf_counter() - t0)
    launches = dict.fromkeys(FAM_KERNELS, 0)
    for arch in FAM_TRAIN:
        for k, n in family_train(torch, arch).items():
            launches[k] += n
    family_train_cli()
    return launches


def idle_share(torch, m, params, prompts, *, fused: bool):
    """Device busy time over wall time for a short traced serving run, the
    decode step a CUDA graph or eager (its capture before the trace)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    from repro_torch.serving.scheduler import Request

    eng = ContinuousBatchingEngine(m, params, slots=N_SLOTS,
                                   max_len=MAX_LEN, temperature=0.0,
                                   fused=fused)
    reqs = [Request(rid=i, prompt=prompts[i][:256], max_new_tokens=8)
            for i in range(N_SLOTS)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e6
    if busy <= 0:
        return None
    return dict(wall_s=wall, device_busy_s=busy,
                idle_share=max(0.0, 1 - busy / wall),
                decode_ms_per_step=(eng.stats["decode_s"]
                                    / max(1, eng.stats["steps"]) * 1e3))


KERNEL_GROUPS = (("decode attention", ("decode_tile", "decode_combine")),
                 ("sort and scan (moe routing)", ("sort", "scan")),
                 ("softmax", ("regs_kernel", "slots_kernel",
                              "scale_kernel")),
                 ("matmul", ("gemm", "gemv", "xmma", "cutlass", "cublas",
                             "nvjet")))


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise and other"


def decode_trace(torch, m, params, prompts, *, fused: bool,
                 slots: int = N_SLOTS, max_len: int = MAX_LEN,
                 new: int = NEW_TOKENS, frames=None, ranges=(),
                 **engine_kw) -> None:
    """One decode burst alone under the profiler: ``slots`` slots admitted
    first (their prefills outside the trace), then ``new - 1`` steps in
    one burst.  Prints wall and device ms a step, the device's idle share
    and its time by kernel group (what paces the step).  ``frames`` (an
    encdec model's) go with the prompts; ``engine_kw`` to the engine.
    Each host range named in ``ranges`` (an eager step's) becomes a group
    of its own: the kernels launched under it, taken out of the groups
    their names give."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    from repro_torch.serving.scheduler import Request

    eng = ContinuousBatchingEngine(m, params, slots=slots, max_len=max_len,
                                   temperature=0.0, fused=fused, **engine_kw)
    for i in range(slots):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=new,
                           frames=None if frames is None else frames[i]))
    eng._run_start = 0.0
    eng._admit_arrived(0.0)
    check(len(eng.active_slots()) == slots, "decode trace: admission")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    steps = eng.stats["steps"]
    groups: dict[str, float] = {}
    names: dict[str, float] = {}
    for e in prof.key_averages():
        # a host range may also show as a device-side annotation: not a
        # kernel
        if str(e.device_type).endswith("CUDA") and e.key not in ranges:
            ms = e.self_device_time_total / 1e3
            g = kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + ms
            names[e.key[:80]] = names.get(e.key[:80], 0.0) + ms
    busy = sum(groups.values())
    in_range = _range_kernels(prof, ranges)
    for name, kernels in in_range.items():
        for k, ms in kernels:
            g = kernel_group(k)
            groups[g] -= ms
            groups[name] = groups.get(name, 0.0) + ms
    extra = {}
    if ranges:
        extra["kernels_under_range"] = {k: len(v)
                                        for k, v in in_range.items()}
    say("decode_trace", arch=m.cfg.name, step="graph" if fused else "eager",
        **extra,
        steps=steps, slot_lengths=[len(p) for p in prompts[:slots]],
        wall_ms_per_step=wall * 1e3 / steps,
        device_ms_per_step=busy / steps,
        idle_share=max(0.0, 1 - busy / (wall * 1e3)) if busy else
        "not measured",
        device_ms_per_step_by_group={k: v / steps for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])},
        top_kernels_ms_per_step={k: v / steps for k, v in sorted(
            names.items(), key=lambda kv: -kv[1])[:10]})
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def _range_kernels(prof, names) -> dict:
    """For each host range in ``names``: (name, device ms) of every kernel
    launched under it, found through the launching call's host parents."""
    out = {n: [] for n in names}
    if not names:
        return out
    for e in prof.events():
        kernels = getattr(e, "kernels", None)
        if not kernels:
            continue
        p = e
        while p is not None and p.name not in out:
            p = p.cpu_parent
        if p is not None:
            out[p.name] += [(k.name, k.duration / 1e3) for k in kernels]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _paths(tree, prefix: str = ""):
    """(path, leaf) of every tensor in a nested dict, paths joined by
    ``/``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# Phase 21: tensor-parallel serving over a mesh of ranks on the one card.
# ---------------------------------------------------------------------------
# tp 2 at 8 of 48 layers: the script's time limit
TP_RUNS = {2: dict(layers=8, requests=12), 3: dict(layers=4, requests=4)}
TP_SEED = 37
TP_KERNELS = ("twopass_softmax_2d", "twopass_stats_2d",
              "decode_attention_paged")
TP_SAMPLED = 4                  # requests of the temperature-0.8 run
TP_DECIDED_SHARE = 4            # the margin rule decides >= 1/4 of contexts


def tp_requests(cfg, n: int, seed: int):
    """``n`` seeded prompts of 200-1,500 tokens, 32 new tokens each."""
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=tuple(rng.integers(
        0, cfg.vocab, int(rng.integers(200, 1501))).tolist()),
        max_new_tokens=NEW_TOKENS) for i in range(n)]


class TpRecorder:
    """Records the logits each served token was drawn from, keyed (rid,
    token index), over the whole vocabulary (gathered across the model
    axis under a mesh), on the host in float32.  It wraps the engine's
    ``_admit``, ``step`` and ``_sample``.  Its own time inside the decode
    steps (a synchronisation, the gather, a host copy) is ``decode_s``,
    so that a step's time can be given without it; ``recording`` is set
    while it gathers, so that its collective is not counted as the
    model's.  It launches no kernel of the port."""

    def __init__(self, eng):
        import torch

        from repro_torch.distributed import collectives

        self.rows, self._rid, self._burst = {}, None, 0
        self.decode_s, self.recording = 0.0, False
        admit, step, sample = eng._admit, eng.step, eng._sample
        vocab = eng.cfg.vocab

        def rec_admit(req, slot, now):
            self._rid = req.rid
            try:
                return admit(req, slot, now)
            finally:
                self._rid = None

        def rec_step(now=None):
            self._burst = 0
            return step(now)

        def rec_sample(logits):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.recording = True
            full = collectives.all_gather_columns(
                logits, eng.cfg.padded_vocab())[:, :vocab].float().cpu()
            self.recording = False
            if self._rid is not None:          # a prefill's first token
                self.rows[(self._rid, 0)] = full[0]
            else:
                active = eng._active.cpu()
                for slot in range(eng.n_slots):
                    if active[slot]:
                        c = eng.slot_owner[slot]
                        self.rows[(c.rid, len(c.tokens) + self._burst)] = \
                            full[slot]
                self._burst += 1
                self.decode_s += time.perf_counter() - t0
            return sample(logits)

        eng._admit, eng.step, eng._sample = rec_admit, rec_step, rec_sample


def tp_model(tp: int, **kw):
    from repro_torch.models import build_model

    return build_model(ARCH, use_kernels=True, tp=tp,
                       n_layers=TP_RUNS[tp]["layers"], **kw)


def tp_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the tp phase: the mesh engine's main-path runs (greedy
    over the phase's requests, each token's logits recorded for the
    parity check, then TP_SAMPLED requests at temperature 0.8), counted
    and timed.  Each rank writes its results to ``out_dir``, rank 0 the
    recorded logits too."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.launch.mesh import make_serving_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    mesh = make_serving_mesh((1, world), backend="gloo")
    m = tp_model(world)
    full = m.init(seed=TP_SEED, dtype=torch.bfloat16)
    kw = dict(mesh=mesh, fused=False, slots=N_SLOTS, max_len=MAX_LEN,
              seed=2)
    eng = m.serving_engine(full, temperature=0.0, **kw)
    eng_s = m.serving_engine(full, temperature=0.8, **kw)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    rec = TpRecorder(eng)

    # the collectives' time: each all_reduce between two synchronisations,
    # the decode steps' apart (the step is eager, so the host waits on
    # every collective anyway); the recorder's gather is not counted
    real = dist.all_reduce
    spent = {"decode": 0.0, "other": 0.0, "calls": 0}
    where = {"in": "other"}

    def timed_all_reduce(*a, **k):
        if rec.recording:
            return real(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spent[where["in"]] += time.perf_counter() - t0
        spent["calls"] += 1
        return out

    dist.all_reduce = timed_all_reduce
    decode = eng._decode

    def decode_timed():
        where["in"] = "decode"
        try:
            decode()
        finally:
            where["in"] = "other"

    eng._decode = decode_timed
    reqs = tp_requests(m.cfg, TP_RUNS[world]["requests"], TP_SEED)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    greedy = [tuple(c.tokens) for c in eng.run(reqs)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    th = eng.throughput()
    steps = max(1, th["steps"])
    sampled = [tuple(c.tokens) for c in eng_s.run(
        [dataclasses.replace(r) for r in reqs[:TP_SAMPLED]])]
    launches = K.launch_counts()
    dist.all_reduce = real
    out = dict(greedy=greedy, sampled=sampled, launches=launches,
               wall_s=wall, throughput=th,
               ms_per_step=(eng.stats["decode_s"] - rec.decode_s) / steps
               * 1e3,
               recorder_ms_per_step=rec.decode_s / steps * 1e3,
               collective_ms_per_step=spent["decode"] / steps * 1e3,
               collective_s_prefill=spent["other"],
               collective_calls=spent["calls"],
               peak_bytes=torch.cuda.max_memory_allocated(),
               arena=list(eng.pool["kv"]["k"].shape),
               wq=list(eng.params["blocks"]["attn"]["wq"]["w"].shape),
               embed=list(eng.params["embed"]["table"].shape))
    if rank == 0:
        out["rows"] = rec.rows
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def tp_single(torch, tp: int) -> dict:
    """The single-process engine on the tp-padded weights (the mesh ranks
    make the same ones from the same seed): greedy tokens and each one's
    logits."""
    m = tp_model(tp, device="cuda")
    params = m.init(seed=TP_SEED, dtype=torch.bfloat16)
    eng = m.serving_engine(params, fused=False, slots=N_SLOTS,
                           max_len=MAX_LEN, temperature=0.0, seed=2)
    rec = TpRecorder(eng)
    toks = [tuple(c.tokens) for c in eng.run(
        tp_requests(m.cfg, TP_RUNS[tp]["requests"], TP_SEED))]
    steps = max(1, eng.stats["steps"])
    ms_per_step = (eng.stats["decode_s"] - rec.decode_s) / steps * 1e3
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(tokens=toks, rows=rec.rows, ms_per_step=ms_per_step)


def tp_margin(torch, tp: int, single: dict, mesh: dict) -> None:
    """The mesh's greedy tokens against the single process's, by the
    margin rule of the encdec and moe phases: at every token whose context
    the two share (up to a request's first difference), ``==`` wherever
    the single process's top-2 margin exceeds twice the largest logit
    difference measured between the two at those contexts.  That
    difference is bounded itself (LOGIT_TOL of the largest logit, as the
    engine phase), and the rule must decide at least one context a
    request and a TP_DECIDED_SHARE-th of them: a mesh whose logits went
    wrong fails the bound, or leaves nothing decided, and fails."""
    keys, firsts = [], []
    for rid, (a, b) in enumerate(zip(single["tokens"], mesh["greedy"])):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 len(a))
        firsts.append(j)
        keys += [(rid, i) for i in range(min(j + 1, len(a)))]
    sp = torch.stack([single["rows"][k] for k in keys])
    ms = torch.stack([mesh["rows"][k] for k in keys])
    abs_err = float((sp - ms).abs().max())
    top2 = sp.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * abs_err
    same = sp.argmax(-1) == ms.argmax(-1)
    tok_same = torch.tensor([single["tokens"][r][i] == mesh["greedy"][r][i]
                             for r, i in keys])
    n_tok = sum(len(t) for t in single["tokens"])
    say("tp_tokens", tp=tp, requests=len(firsts),
        tokens=n_tok, tokens_equal=sum(
            x == y for a, b in zip(single["tokens"], mesh["greedy"])
            for x, y in zip(a, b)),
        requests_equal=sum(j == len(t) for j, t in
                           zip(firsts, single["tokens"])),
        first_difference=firsts, contexts_compared=len(keys),
        logits_max_abs_err=abs_err,
        logits_max_err_over_max_logit=abs_err / float(sp.abs().max()),
        logits_tol=f"{LOGIT_TOL} of the largest logit, as the engine phase",
        decided=int(decided.sum()),
        decided_floor=max(len(firsts), len(keys) // TP_DECIDED_SHARE),
        margins_left_out=margin[~decided].tolist()[:64],
        margins_of_unequal=margin[~tok_same].tolist(),
        rule="== where the single process's top-2 margin exceeds 2 x the "
             "largest logit difference between it and the mesh at the "
             "contexts they share")
    worst = abs_err / float(sp.abs().max())
    floor = max(len(firsts), len(keys) // TP_DECIDED_SHARE)
    check(worst <= LOGIT_TOL,
          f"tp {tp}: mesh logits vs the single process's: {worst} of the "
          f"largest logit, over {LOGIT_TOL}")
    check(int(decided.sum()) >= floor,
          f"tp {tp}: {int(decided.sum())} of {len(keys)} contexts decided "
          f"by the margin rule, under {floor}")
    check(bool(same[decided].all()) and bool(tok_same[decided].all()),
          f"tp {tp}: mesh tokens != the single process's at a top-2 "
          f"margin above 2 x {abs_err}")


def tp_kernel_checks(torch, rows, tp: int) -> None:
    """Kernels 1, 2 and 3 at a rank's shapes, against their plain
    versions: kernel 1 on one prefill bucket's score rows (the rank's
    q-heads x 1,024), kernel 2 on the sampler's local columns at 0.8,
    kernel 3 on each rank's decode operands (tp 2: 4 KV heads of G 5;
    tp 3: each rank's run of the 8 replicated KV heads, read through a
    view of the arena, with its 14 q-heads regrouped into G rows a KV
    head, ``attention.local_layout``), 8 slots of 200-1,532 positions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import twopass_softmax as tp_k
    from repro_torch.models import attention

    rng = np.random.default_rng(TP_SEED + tp)
    hq = -(-40 // tp) * tp // tp
    x = score_rows(torch, rng, "prefill_tp", hq * 1024, 1024)
    softmax_rows_check(torch, rows, f"tp{tp}_prefill_1024", x,
                       f"tp{tp}_prefill_bucket_1024", heads=hq)
    del x
    v = 152064 // tp
    x = torch.from_numpy(rng.standard_normal((N_SLOTS, v),
                                             dtype="float32") * 8 / 0.8)
    x = x.to("cuda")
    m, n = tp_k.twopass_stats_2d(x)
    mp, np_ = tp_k.twopass_stats_2d_plain(x)
    sa, _ = err(m, mp)
    check(torch.equal(n, np_) and torch.allclose(m, mp, rtol=1e-5, atol=0),
          f"twopass_stats_2d tp{tp} sampler: m err {sa}")
    say("kernel_check", kernel="twopass_stats_2d", shape=[N_SLOTS, v],
        case=f"tp{tp}_sampler_local", m_max_abs_err=sa, n_equal=True,
        tol="n_sum exact (a max); m_sum rtol 1e-5 (sum order)")
    nb = N_SLOTS * v * 4
    b_ms, b_by = bound(nb + 8 * N_SLOTS, STATS_OPS * N_SLOTS * v)
    rows.setdefault("twopass_stats_2d", {})[f"tp{tp}_sampler_local"] = dict(
        **timed(torch, lambda: tp_k.twopass_stats_2d(x),
                lambda: tp_k.twopass_stats_2d_plain(x),
                lambda: torch.logsumexp(x, -1)),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=sa, shape=[N_SLOTS, v])
    say("kernel_time", kernel="twopass_stats_2d",
        case=f"tp{tp}_sampler_local", **rows["twopass_stats_2d"][
            f"tp{tp}_sampler_local"])
    del x, m, n, mp, np_
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED + tp)
    pmax = MAX_LEN // 128
    lengths = rng.integers(200, 1533, N_SLOTS).astype(np.int32)
    tab = torch.from_numpy(rng.permutation(np.arange(
        1, 1 + N_SLOTS * pmax)).reshape(N_SLOTS, pmax).astype(
            np.int32)).to("cuda")
    shapes = []
    for r in range(tp):
        lay = attention._local_layout(get_config(ARCH), tp, tp, r,
                                      torch.device("cuda"))
        shape = (lay.kv0, lay.nkv, lay.g, lay.hkv)
        if shape not in shapes:
            shapes.append(shape)
    for kv0, nkv, g, heads in shapes:
        case = (f"tp{tp}_local" if len(shapes) == 1
                else f"tp{tp}_local_kv{kv0}_{nkv}x{g}")
        decode_case(torch, rows, gen, case, lengths=lengths, tab=tab,
                    hkv=nkv, g=g, d=128, kv_view=(kv0, heads))


def tp_phase(torch, rows) -> dict:
    """Phase 21 (see the module's docstring).  Returns the ranks' launches
    of kernels 1, 2 and 3 in the main path's runs, summed over ranks."""
    import pickle
    import shutil

    import torch.multiprocessing as mp

    launches = dict.fromkeys(TP_KERNELS, 0)
    for tp in sorted(TP_RUNS):
        t0 = time.perf_counter()
        tp_kernel_checks(torch, rows, tp)
        single = tp_single(torch, tp)
        out = ROOT / "build" / f"chip_smoke_tp{tp}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        gc.collect()
        torch.cuda.empty_cache()
        mp.start_processes(tp_rank, args=(tp, str(out / "store"), str(out)),
                           nprocs=tp, join=True, start_method="spawn")
        ranks = []
        for r in range(tp):
            with open(out / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        for r, res in enumerate(ranks):
            check(res["greedy"] == ranks[0]["greedy"]
                  and res["sampled"] == ranks[0]["sampled"],
                  f"tp {tp}: rank {r}'s tokens differ from rank 0's")
            for name in TP_KERNELS:
                launches[name] += res["launches"][name]
        mesh = ranks[0]
        tp_margin(torch, tp, single, mesh)
        for name in TP_KERNELS:
            check(all(r["launches"][name] > 0 for r in ranks),
                  f"tp {tp}: {name} not launched by every rank")
        th = mesh["throughput"]
        say("tp_serving", tp=tp, mesh=th["mesh_axes"], backend=th["backend"],
            fused=th["fused"], kv_shards=th["kv_shards"],
            n_layers=TP_RUNS[tp]["layers"], requests=len(mesh["greedy"]),
            steps=th["steps"], ms_per_step=mesh["ms_per_step"],
            recorder_ms_per_step_left_out=mesh["recorder_ms_per_step"],
            single_process_ms_per_step=single["ms_per_step"],
            collective_ms_per_step=mesh["collective_ms_per_step"],
            collective_s_outside_decode=mesh["collective_s_prefill"],
            collective_calls=mesh["collective_calls"],
            prefill_tok_s=th["prefill_tok_s"],
            decode_tok_s=th["decode_tok_s"], wall_s=mesh["wall_s"],
            rank_arena=mesh["arena"], rank_wq=mesh["wq"],
            rank_embed=mesh["embed"], rank_peak_bytes=[
                r["peak_bytes"] for r in ranks],
            launches={n: [r["launches"][n] for r in ranks]
                      for n in TP_KERNELS},
            sampled_tokens=sum(len(t) for t in mesh["sampled"]),
            seconds=time.perf_counter() - t0,
            note="ranks share one card and gloo passes through host "
                 "memory: no statement about a link between cards")
        shutil.rmtree(out, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 22: training over a mesh of ranks on the one card.
# ---------------------------------------------------------------------------
# 2x1 at 2 layers: gloo takes each step's FSDP traffic (the layers'
# gathers and float32 gradients, the LM head's) through host memory, 13.7
# GB and ~20 s a step at 4 layers on an H100's host; 2 layers keep the
# phase near its 150 s.  2x1 runs each microbatch of the single process
# on a rank, through the same kernels, and sums the two halves as it does:
# every step's loss and grad norm are held equal (``exact``); 1x2 splits
# the products' sums, every step is held within the train-parity bounds
TPT_RUNS = {"1x2": dict(shape=(1, 2), batch=1, steps=3,
                        layers=TRAIN_LAYERS, exact=False),
            "2x1": dict(shape=(2, 1), batch=2, steps=2, layers=2,
                        exact=True)}
TPT_SEED = 38
TPT_LR = dict(peak_lr=3e-4, warmup=100)       # the train phase's rates
TPT_KERNELS = TRAIN_KERNELS
TPT_TP2_CHUNK = (512, 5120, 152064 // 2)      # a rank's loss chunk at tp 2
TPT_TP2_FLASH = (1, 20, 4, 4096, 4096, 128, True, None, "bfloat16")


def tpt_model(run: dict, tp: int, device="cuda"):
    from repro_torch.models import build_model

    return build_model(ARCH, n_layers=run["layers"], use_kernels=True,
                       tp=tp, device=device)


def tpt_trainer(m, run: dict, mesh=None, microbatches: int = 1):
    from repro_torch.configs.base import ShapeCell
    from repro_torch.training.trainer import Trainer, TrainerConfig

    return Trainer(m, ShapeCell("tp_train", TRAIN_SEQ, run["batch"],
                                "train"),
                   TrainerConfig(steps=run["steps"], seed=TPT_SEED,
                                 log_every=1, microbatches=microbatches,
                                 **TPT_LR), mesh=mesh)


def tpt_steps(torch, trainer, on_step=None, state=None) -> list[dict]:
    """``trainer.run(state)`` with each step's loss, grad norm, ms and
    peak bytes recorded (``on_step`` is called around the step)."""
    step, out = trainer.step, []

    def recorded(state, batch):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if on_step is not None:
            on_step("start")
        state, met = step(state, batch)
        norm = float(met["grad_norm"])
        torch.cuda.synchronize()
        out.append(dict(loss=float(met["loss"]), grad_norm=norm,
                        ms=(time.perf_counter() - t0) * 1e3,
                        peak_bytes=torch.cuda.max_memory_allocated()))
        if on_step is not None:
            on_step("end")
        return state, met

    trainer.step = recorded
    trainer.run(state, None if state is None else 0)
    return out


def tpt_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the tp_train phase: for each mesh of ``TPT_RUNS`` in
    turn (both of 2 ranks: one spawn), ``Trainer.run`` over it, each
    step's numbers, the collectives' time (each ``all_reduce`` between two
    synchronisations) and the launches of kernels 9-13, written to
    ``out_dir``."""
    import pickle

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    out = {}
    for name in TPT_RUNS:
        out[name] = tpt_rank_run(torch, name)
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def tpt_rank_run(torch, name: str) -> dict:
    """:func:`tpt_rank`'s run over the mesh of ``TPT_RUNS[name]``."""
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.launch.mesh import make_mesh

    run = TPT_RUNS[name]
    mesh = make_mesh(run["shape"], ("data", "model"), backend="gloo")
    trainer = tpt_trainer(tpt_model(run, run["shape"][1]), run, mesh)
    real = dist.all_reduce
    spent = {"s": 0.0, "calls": 0, "bytes": 0, "step": []}

    def timed_all_reduce(x, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(x, *a, **k)
        torch.cuda.synchronize()
        spent["s"] += time.perf_counter() - t0
        spent["calls"] += 1
        spent["bytes"] += x.numel() * x.element_size()
        return res

    def on_step(when):
        if when == "start":
            spent.update(s=0.0, calls=0, bytes=0)
        else:
            spent["step"].append((spent["s"] * 1e3, spent["calls"],
                                  spent["bytes"]))

    dist.all_reduce = timed_all_reduce
    try:
        K.reset_launch_counts()
        steps = tpt_steps(torch, trainer, on_step)
        launches = K.launch_counts()
    finally:
        dist.all_reduce = real
    return dict(steps=steps, launches={k: launches[k] for k in TPT_KERNELS},
                collectives=spent["step"],
                coords=[mesh.local_rank(a) for a in mesh.axis_names])


def tpt_single(torch, name: str) -> dict:
    """The single process on the same weights and global batches (2x1's
    through ``microbatches=2``), and the largest |logit| of its first
    batch (the parity bound's scale)."""
    from repro_torch.models import transformer
    from repro_torch.training import train_state

    run = TPT_RUNS[name]
    m = tpt_model(run, 1)
    trainer = tpt_trainer(m, run, microbatches=run["batch"])
    params = m.init(seed=TPT_SEED)
    tokens = torch.from_numpy(trainer.data.batch_at(0)["tokens"]).cuda()
    xmax = 0.0
    with torch.no_grad():
        w = transformer._head_w(params, m.cfg,
                                transformer.torch_dtype(m.cfg.dtype))
        for row in tokens:
            h = transformer.forward(params, row[None, :-1], cfg=m.cfg)
            xmax = max([xmax] + [float((hc @ w).abs().amax())
                                 for hc in h[0].split(TRAIN_SEQ // 8)])
        del h, w
    steps = tpt_steps(torch, trainer, state=train_state.init_state(params))
    del trainer, m, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, xmax=xmax)


def tpt_kernel_checks(torch, rows) -> None:
    """Kernels 9-13 at a tp-2 rank's shapes: kernels 9-11 on a rank's
    columns against their plain versions (:func:`lmhead_check`, timed),
    kernel 9 with every label outside the shard, kernels 10-11 from the
    fold of both ranks' stats, the folded loss against kernel 9 over all
    columns; kernels 12-13 at a rank's heads (:func:`flash_check`,
    timed)."""
    from repro_torch.core import numerics
    from repro_torch.kernels import twopass_xent as xe

    case = "tp2_rank_chunk_bf16"
    c = lmhead_check(torch, case, TPT_TP2_CHUNK, torch.bfloat16)
    lmhead_times(torch, rows, case, c)
    del c
    torch.cuda.empty_cache()
    t, d, v = LMHEAD_TRAIN
    half = v // 2
    h, w, lab, dl = lmhead_inputs(torch, LMHEAD_TRAIN, torch.bfloat16)
    bv = LMHEAD_BLOCK_V
    cols = [w[:, :half].contiguous(), w[:, half:].contiguous()]
    # every label outside rank 1's columns: the label logit is exactly 0,
    # so the loss is the shard's own lse
    out_lab = torch.remainder(lab, half)                # all in [0, half)
    loss1, m1, n1 = xe.lmhead_xent_fwd_2d(h, cols[1], out_lab - half,
                                          block_v=bv)
    lse1 = torch.log(torch.clamp(m1[:, 0], min=1e-37)) + n1[:, 0] * xe.LN2
    pl, pm, pn = xe.lmhead_xent_fwd_2d_plain(
        h, cols[1], out_lab - half, xe.lmhead_v_chunks(half, bv))
    lim = lmhead_limits(torch, h, cols[1], out_lab - half, dl, pm, pn, pl)
    gap = float((lse1 - loss1).abs().max())
    err_out = float(((loss1 - pl).abs() / lim["loss"]).max())
    check(gap == 0.0 and err_out <= 1.0,
          f"kernel 9, labels outside the shard: lse - loss {gap}, "
          f"{err_out} of the limit")
    say("kernel_check", kernel="lmhead_xent_fwd_2d",
        case="tp2_rank_labels_outside", shape=[t, d, half],
        label_logit_max_abs=gap, loss_worst_err_over_limit=err_out,
        tol="label logit exactly 0; loss within lmhead_limits")
    del pl, pm, pn, lim, loss1, m1, n1, lse1
    # each rank's (m, n) and label logit, folded as the loss folds them
    parts = []
    for r, wr in enumerate(cols):
        lr = lab.long() - r * half
        loss_r, m_r, n_r = xe.lmhead_xent_fwd_2d(h, wr, lr, block_v=bv)
        lse_r = torch.log(torch.clamp(m_r[:, 0], min=1e-37)) \
            + n_r[:, 0] * xe.LN2
        mine = (lr >= 0) & (lr < half)
        parts.append((m_r, n_r, torch.where(mine, lse_r - loss_r, 0.0)))
    s = numerics.ext_sum(numerics.ExtFloat(
        torch.stack([p[0] for p in parts]),
        torch.stack([p[1] for p in parts])), axis=0)
    folded = (torch.log(torch.clamp(s.mantissa[:, 0], min=1e-37))
              + s.exponent[:, 0] * xe.LN2 - parts[0][2] - parts[1][2])
    full, fm, fn_ = xe.lmhead_xent_fwd_2d(h, w, lab, block_v=bv)
    pl, pm, pn = xe.lmhead_xent_fwd_2d_plain(h, w, lab,
                                             xe.lmhead_v_chunks(v, bv))
    lim = lmhead_limits(torch, h, w, lab, dl, pm, pn, pl)
    fold_err = float(((folded - full).abs() / lim["loss"]).max())
    check(fold_err <= 1.0, f"two ranks' folded loss vs kernel 9 over all "
          f"columns: {fold_err} of the limit")
    say("kernel_check", kernel="lmhead_xent_fwd_2d",
        case="tp2_folded_vs_full_vocab", shape=[t, d, v],
        max_abs_err=float((folded - full).abs().max()),
        worst_err_over_limit=fold_err,
        tol="lmhead_limits over all 152,064 columns")
    del pl, pm, pn, lim
    # kernels 10-11 on rank 0's columns from the global (folded) stats
    lr = lab.long()
    args = (h, cols[0], lr, s.mantissa, s.exponent, dl)
    dh, dw = xe.lmhead_xent_bwd_2d(*args, block_v=bv)
    pdh, pdw = xe.lmhead_xent_bwd_2d_plain(*args, xe.lmhead_v_chunks(
        half, bv))
    lim = lmhead_limits(torch, h, cols[0], lr, dl, s.mantissa, s.exponent,
                        folded)
    e_dh = float(((dh - pdh).abs() / lim["dh"]).max())
    e_dw = float(((dw - pdw).abs() / lim["dw"]).max())
    check(e_dh <= 1.0 and e_dw <= 1.0, f"kernels 10-11 from the folded "
          f"stats: dh {e_dh}, dw {e_dw} of the limit")
    for k, e, a in (("lmhead_xent_dh_2d", e_dh, dh - pdh),
                    ("lmhead_xent_dw_2d", e_dw, dw - pdw)):
        say("kernel_check", kernel=k, case="tp2_rank_global_stats",
            shape=[t, d, half], max_abs_err=float(a.abs().max()),
            worst_err_over_limit=e, tol="lmhead_limits, the global stats")
    del h, w, lab, dl, cols, dh, dw, pdh, pdw, lim, parts, full, fm, fn_
    torch.cuda.empty_cache()
    case = "tp2_rank_train_bf16"
    c = flash_check(torch, case, TPT_TP2_FLASH)
    flash_times(torch, rows, case, c)
    del c
    torch.cuda.empty_cache()


def tpt_cli(torch) -> None:
    """The training CLI under torchrun, reduced: ``--mesh 1x2`` for 3
    steps saving, then ``--mesh 2x1`` to 5, resuming, and with no mesh to
    6 (``launch.train.main`` in this process: the CLI's code without a
    process of its own to start), resuming again; the checkpoint holds
    the global arrays."""
    import io
    import shutil

    from repro_torch.launch import train

    ck = ROOT / "build" / "chip_smoke_tp_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = ["-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced",
            "--kernels", "--checkpoint-dir", str(ck)]
    for mesh, steps in (("1x2", 3), ("2x1", 5), (None, 6)):
        # --standalone: a rendezvous on a free local port, so that two
        # checkouts running this phase at once do not meet
        cmd = ([sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "2"]
               if mesh else [sys.executable])
        cmd += base + ["--steps", str(steps)]
        if mesh:
            cmd += ["--mesh", mesh, "--backend", "gloo"]
        t0 = time.perf_counter()
        if mesh:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 env=env, cwd=ROOT, timeout=300)
            check(res.returncode == 0, f"train CLI --mesh {mesh}: "
                  f"{res.stderr[-3000:]}")
            stdout = res.stdout
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                train.main(cmd[3:])
            stdout = buf.getvalue()
        final = [ln for ln in stdout.splitlines()
                 if ln.startswith("final:")]
        check(len(final) == 1 and f"'step': {steps - 1}," in final[0],
              f"train CLI --mesh {mesh}: {stdout[-2000:]}")
        launched = [ln for ln in stdout.splitlines()
                    if ln.startswith("kernel launches:")]
        check(len(launched) == 1 and all(k in launched[0]
                                         for k in TPT_KERNELS),
              f"train CLI --mesh {mesh}: kernels not launched: {launched}")
        say("tp_train_cli", mesh=mesh, steps=steps, final=final[0],
            launches=launched[0], seconds=time.perf_counter() - t0)
    shutil.rmtree(ck, ignore_errors=True)


def tp_train_phase(torch, rows) -> dict:
    """Phase 22 (see the module's docstring).  Returns the ranks' launches
    of kernels 9-13 in the main path's runs, summed over ranks."""
    import pickle
    import shutil

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    tpt_kernel_checks(torch, rows)
    say("tp_train_part", part="kernel checks",
        seconds=time.perf_counter() - t_phase)
    launches = dict.fromkeys(TPT_KERNELS, 0)
    t0 = time.perf_counter()
    singles = {}
    for name in TPT_RUNS:
        singles[name] = tpt_single(torch, name)
        gc.collect()
        torch.cuda.empty_cache()
    say("tp_train_part", part="single process",
        seconds=time.perf_counter() - t0)
    out = ROOT / "build" / "chip_smoke_tpt"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    world = 2
    check(all(r["shape"][0] * r["shape"][1] == world
              for r in TPT_RUNS.values()), "tp_train meshes of 2 ranks")
    t0 = time.perf_counter()
    mp.start_processes(tpt_rank, args=(world, str(out / "store"), str(out)),
                       nprocs=world, join=True, start_method="spawn")
    say("tp_train_part", part="ranks", seconds=time.perf_counter() - t0)
    by_rank = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            by_rank.append(pickle.load(f))
    shutil.rmtree(out, ignore_errors=True)
    for name, run in TPT_RUNS.items():
        single, ranks = singles[name], [res[name] for res in by_rank]
        xmax = single["xmax"]
        lim = 2.0 ** -8 * xmax + 1e-4
        s0 = single["steps"]
        for res in ranks:
            m0 = res["steps"]
            check(len(m0) == run["steps"], f"{name}: {len(m0)} steps")
            check(all(math.isfinite(x["loss"]) for x in m0),
                  f"{name}: loss {[x['loss'] for x in m0]}")
            for i, (x, y) in enumerate(zip(m0, s0), 1):
                rel = abs(x["grad_norm"] / y["grad_norm"] - 1)
                if run["exact"]:
                    ok = x["loss"] == y["loss"] and rel == 0
                else:
                    ok = abs(x["loss"] - y["loss"]) <= lim and rel <= 2.0**-5
                check(ok, f"{name}: step {i} loss {x['loss']}, grad norm "
                      f"{x['grad_norm']} vs the single process's "
                      f"{y['loss']}, {y['grad_norm']} ("
                      + ("equal" if run["exact"] else
                         f"loss within {lim}, norm within 2^-5") + ")")
            for k in TPT_KERNELS:
                check(res["launches"][k] > 0,
                      f"{name}: {k} not launched by rank {res['coords']}")
                launches[k] += res["launches"][k]
        for res in ranks:
            ms = [x["ms"] for x in res["steps"]]
            coll = [c[0] for c in res["collectives"]]
            say("tp_train", mesh=name, rank=res["coords"],
                n_layers=run["layers"], full_depth=48,
                batch=[run["batch"], TRAIN_SEQ],
                steps=run["steps"],
                losses=[x["loss"] for x in res["steps"]],
                single_process_losses=[x["loss"] for x in s0],
                loss_diffs=[x["loss"] - y["loss"]
                            for x, y in zip(res["steps"], s0)],
                loss_limit=0.0 if run["exact"] else lim,
                max_abs_logit=xmax,
                grad_norms=[x["grad_norm"] for x in res["steps"]],
                single_process_grad_norms=[x["grad_norm"] for x in s0],
                grad_norm_rel_diffs=[abs(x["grad_norm"] / y["grad_norm"] - 1)
                                     for x, y in zip(res["steps"], s0)],
                grad_norm_limit=0.0 if run["exact"] else 2.0 ** -5,
                ms_per_step=ms, single_process_ms_per_step=[
                    x["ms"] for x in s0],
                collective_ms_per_step=coll,
                collective_share=[c / t for c, t in zip(coll, ms)],
                collective_calls_per_step=[c[1] for c in res["collectives"]],
                collective_bytes_per_step=[c[2] for c in res["collectives"]],
                peak_gb=[x["peak_bytes"] / 1e9 for x in res["steps"]],
                single_process_peak_gb=[x["peak_bytes"] / 1e9 for x in s0],
                launches=res["launches"],
                note="ranks share one card and gloo passes through host "
                     "memory: no statement about a link between cards")
    t0 = time.perf_counter()
    tpt_cli(torch)
    say("tp_train_part", part="cli", seconds=time.perf_counter() - t0)
    say("tp_train_done_in", seconds=time.perf_counter() - t_phase)
    return launches


REPLACES = {
    "twopass_softmax_2d": "src/repro/kernels/twopass_softmax.py:76",
    "twopass_stats_2d": "src/repro/kernels/twopass_softmax.py:115",
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:239",
    "decode_attention_paged_int8":
        "src/repro/kernels/decode_attention.py:239",
    "decode_attention": "src/repro/kernels/decode_attention.py:151",
    "threepass_recompute_2d": "src/repro/kernels/threepass_softmax.py:116",
    "threepass_reload_2d": "src/repro/kernels/threepass_softmax.py:148",
    "xent_fwd_2d": "src/repro/kernels/twopass_xent.py:79",
    "xent_bwd_2d": "src/repro/kernels/twopass_xent.py:110",
    "lmhead_xent_fwd_2d": "src/repro/kernels/twopass_xent.py:237",
    "lmhead_xent_dh_2d": "src/repro/kernels/twopass_xent.py:275",
    "lmhead_xent_dw_2d": "src/repro/kernels/twopass_xent.py:304",
    "flash_attention_fwd_gqa": "src/repro/kernels/flash_attention.py:105",
    "flash_attention_bwd_gqa": "src/repro/kernels/flash_attention.py:287",
}
SOURCES = {
    "twopass_softmax_2d": "src/repro_torch/csrc/twopass_softmax.cu",
    "twopass_stats_2d": "src/repro_torch/csrc/twopass_softmax.cu",
    "decode_attention_paged": "src/repro_torch/csrc/decode_attention.cu",
    "decode_attention_paged_int8": "src/repro_torch/csrc/decode_attention.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "threepass_recompute_2d": "src/repro_torch/csrc/threepass_softmax.cu",
    "threepass_reload_2d": "src/repro_torch/csrc/threepass_softmax.cu",
    "xent_fwd_2d": "src/repro_torch/csrc/twopass_xent.cu",
    "xent_bwd_2d": "src/repro_torch/csrc/twopass_xent.cu",
    "lmhead_xent_fwd_2d": "src/repro_torch/csrc/lmhead_xent.cu",
    "lmhead_xent_dh_2d": "src/repro_torch/csrc/lmhead_xent.cu",
    "lmhead_xent_dw_2d": "src/repro_torch/csrc/lmhead_xent.cu",
    "flash_attention_fwd_gqa": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_gqa": "src/repro_torch/csrc/flash_attention.cu",
}
MAIN_CASE = {"twopass_softmax_2d": "prefill_bucket_1024",
             "twopass_stats_2d": "prefill_bucket_1024",
             "decode_attention_paged": "main", "decode_attention": "main",
             "decode_attention_paged_int8": "main",
             "threepass_recompute_2d": "prefill_bucket_1024",
             "threepass_reload_2d": "prefill_bucket_1024",
             "xent_fwd_2d": "lm_head_f32", "xent_bwd_2d": "lm_head_f32",
             **dict.fromkeys(LMHEAD, "train_chunk_bf16"),
             **dict.fromkeys(FLASH, "train_bf16")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=16,
                    help="decoder depth of the engine phase and of the "
                    "prefix, quant and tune phases (full: 48; 16 keeps "
                    "the whole script inside its time limit)")
    ap.add_argument("--only", choices=("train", "swa", "engine", "mqa",
                                       "ssm", "encdec", "moe", "mla", "vlm",
                                       "hybrid", "prefix", "quant",
                                       "tune", "family_train", "tp",
                                       "tp_train"),
                    help="run one phase alone (train: to compare the train "
                    "step of two trees on one card); no kernels or ok line")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    say("env", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
        build_s=_build.build_seconds)
    ptxas = _build.ptxas_report()
    print(ptxas, flush=True)
    mma = [ln for ln in ptxas.splitlines() if "_mma<" in ln]
    check(len(mma) == 18 and all("0 bytes spill stores" in ln for ln in mma),
          "flash mma kernels: not 18 instantiations, or one spills")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul on")

    if args.only:
        if args.only == "train":
            train_phase(torch)
        elif args.only == "engine":
            say("engine_done", launches=engine_phase(
                torch, np.random.default_rng(0), args.layers)[0])
        elif args.only == "prefix":
            t0 = time.perf_counter()
            say("prefix_done", launches=prefix_phase(torch, args.layers),
                seconds=time.perf_counter() - t0)
        elif args.only == "quant":
            t0 = time.perf_counter()
            say("quant_done", launches=quant_phase(torch, {}, args.layers),
                seconds=time.perf_counter() - t0)
        elif args.only == "family_train":
            t0 = time.perf_counter()
            say("family_train_done",
                launches=family_train_phase(torch, {}),
                seconds=time.perf_counter() - t0)
        elif args.only == "tp":
            t0 = time.perf_counter()
            say("tp_done", launches=tp_phase(
                torch, {"twopass_softmax_2d": {}}),
                seconds=time.perf_counter() - t0)
        elif args.only == "tp_train":
            t0 = time.perf_counter()
            say("tp_train_done", launches=tp_train_phase(torch, {}),
                seconds=time.perf_counter() - t0)
        elif args.only == "tune":
            t0 = time.perf_counter()
            say("tune_done", launches=tune_phase(torch, args.layers, smi),
                seconds=time.perf_counter() - t0)
        elif args.only in ("mqa", "ssm", "encdec", "moe", "mla", "vlm",
                           "hybrid"):
            phase = {"mqa": mqa_phase, "ssm": ssm_phase,
                     "encdec": encdec_phase, "moe": moe_phase,
                     "mla": mla_phase, "vlm": vlm_phase,
                     "hybrid": hybrid_phase}[args.only]
            t0 = time.perf_counter()
            say(f"{args.only}_done", launches=phase(
                torch, {"twopass_softmax_2d": {}}),
                seconds=time.perf_counter() - t0)
        else:
            swa_phase(torch, {"twopass_softmax_2d": {}})
        print(smi, flush=True)
        return 0
    rng = np.random.default_rng(0)
    torch.manual_seed(0)                 # the card's own random inputs
    t0 = time.perf_counter()
    rows = kernel_phase(torch, rng)
    paper_comparison(torch, rows)
    lmhead_phase(torch, rows)
    torch.cuda.empty_cache()
    flash_phase(torch, rows)
    torch.cuda.empty_cache()
    say("kernels_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches, idle = engine_phase(torch, rng, args.layers)
    gc.collect()
    torch.cuda.empty_cache()             # the CLI's process needs the card
    say("engine_done", seconds=time.perf_counter() - t0,
        idle={k: v or "not measured" for k, v in idle.items()})
    t0 = time.perf_counter()
    for name, n in swa_phase(torch, rows).items():
        launches[name] += n
    say("swa_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for name, n in mqa_phase(torch, rows).items():
        launches[name] += n
    say("mqa_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for name, n in ssm_phase(torch, rows).items():
        launches[name] += n
    say("ssm_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    enc_launches = encdec_phase(torch, rows)
    say("encdec_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for name, n in moe_phase(torch, rows).items():
        launches[name] += n
    say("moe_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    mla_launches = mla_phase(torch, rows)
    say("mla_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    vlm_launches = vlm_phase(torch, rows)
    say("vlm_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for name, n in hybrid_phase(torch, rows).items():
        launches[name] += n
    say("hybrid_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches.update(train_phase(torch))
    # after the train phase's counts: the flash forward's too
    for name, n in (*enc_launches.items(), *mla_launches.items(),
                    *vlm_launches.items()):
        launches[name] += n
    say("train_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cli_phase(torch)
    say("cli_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    train_cli_phase(torch)
    say("train_cli_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for name, n in prefix_phase(torch, args.layers).items():
        launches[name] += n
    say("prefix_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches.update(quant_phase(torch, rows, args.layers))
    say("quant_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for name, n in tune_phase(torch, args.layers, smi).items():
        launches[name] += n
    say("tune_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for name, n in family_train_phase(torch, rows).items():
        launches[name] += n
    say("family_train_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for name, n in tp_phase(torch, rows).items():
        launches[name] += n
    say("tp_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for name, n in tp_train_phase(torch, rows).items():
        launches[name] += n
    say("tp_train_done", seconds=time.perf_counter() - t0)
    kernels = []
    for name in REPLACES:
        r = rows[name][MAIN_CASE[name]]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
